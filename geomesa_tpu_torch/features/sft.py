"""SimpleFeatureType: schema model + GeoMesa spec-string parser.

Copy of ``geomesa_tpu/features/sft.py``, trimmed to what the port uses
(spec parsing and re-serialization, ``spec``, descriptors,
``geom_field``/``dtg_field``, ``z3_interval``, ``xz_precision``). Grammar follows GeoMesa's
SimpleFeatureTypes.createType:

    "name:String,age:Int,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval=week"

- comma-separated attribute entries ``[*]name[:Type][:opt=val]*`` where
  ``*`` marks the default geometry
- after an optional ``;``, comma-separated ``key=value`` schema user-data
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _escape(v: str) -> str:
    """Escape user-data values for the comma-delimited spec string."""
    return v.replace("\\", "\\\\").replace(",", "\\,")


def _unescape(v: str) -> str:
    out = []
    it = iter(v)
    for c in it:
        if c == "\\":
            out.append(next(it, "\\"))
        else:
            out.append(c)
    return "".join(out)


def _split_escaped(s: str) -> list:
    """Split on commas, honoring backslash escapes."""
    out, cur, esc = [], [], False
    for c in s:
        if esc:
            cur.append("\\")
            cur.append(c)
            esc = False
        elif c == "\\":
            esc = True
        elif c == ",":
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if esc:
        cur.append("\\")
    out.append("".join(cur))
    return out


GEOM_TYPES = {
    "Point",
    "LineString",
    "Polygon",
    "MultiPoint",
    "MultiLineString",
    "MultiPolygon",
    "GeometryCollection",
    "Geometry",
}

_TYPE_ALIASES = {
    "string": "String",
    "int": "Integer",
    "integer": "Integer",
    "long": "Long",
    "float": "Float",
    "double": "Double",
    "boolean": "Boolean",
    "bool": "Boolean",
    "date": "Date",
    "timestamp": "Date",
    "uuid": "UUID",
    "bytes": "Bytes",
    **{t.lower(): t for t in GEOM_TYPES},
}

# columnar dtype for each attribute type; None = host-only object column
COLUMN_DTYPES = {
    "String": None,
    "Integer": np.int32,
    "Long": np.int64,
    "Float": np.float32,
    "Double": np.float64,
    "Boolean": np.bool_,
    "Date": np.int64,  # epoch millis
    "UUID": None,
    "Bytes": None,
}


@dataclass(frozen=True)
class AttributeDescriptor:
    name: str
    type_name: str  # canonical: String/Integer/.../Point/...
    options: dict = field(default_factory=dict)
    default_geom: bool = False

    @property
    def is_geometry(self) -> bool:
        return self.type_name in GEOM_TYPES

    @property
    def is_point(self) -> bool:
        return self.type_name == "Point"

    @property
    def indexed(self) -> bool:
        return str(self.options.get("index", "false")).lower() == "true"

    @property
    def column_dtype(self):
        """numpy dtype for the device column, or None for host-only."""
        return COLUMN_DTYPES.get(self.type_name)


@dataclass(frozen=True)
class SimpleFeatureType:
    type_name: str
    attributes: tuple
    user_data: dict = field(default_factory=dict)

    def __post_init__(self):
        names = [a.name for a in self.attributes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate attribute names in {names}")

    @property
    def attribute_names(self) -> list[str]:
        return [a.name for a in self.attributes]

    def descriptor(self, name: str) -> AttributeDescriptor:
        for a in self.attributes:
            if a.name == name:
                return a
        raise KeyError(name)

    @property
    def geom_field(self) -> str | None:
        """Default geometry attribute (the ``*``-marked one, else the first
        geometry-typed one)."""
        for a in self.attributes:
            if a.default_geom:
                return a.name
        for a in self.attributes:
            if a.is_geometry:
                return a.name
        return None

    @property
    def dtg_field(self) -> str | None:
        """Default date attribute (``geomesa.index.dtg`` user data, else the
        first Date attribute)."""
        dtg = self.user_data.get("geomesa.index.dtg")
        if dtg:
            return dtg
        for a in self.attributes:
            if a.type_name == "Date":
                return a.name
        return None

    @property
    def z3_interval(self) -> str:
        return self.user_data.get("geomesa.z3.interval", "week")

    @property
    def xz_precision(self) -> int:
        """XZ curve resolution of non-point schemas (``geomesa.xz.precision``
        user data, default 12)."""
        return int(self.user_data.get("geomesa.xz.precision", 12))

    @staticmethod
    def create(type_name: str, spec: str) -> "SimpleFeatureType":
        """Parse a GeoMesa spec string (SimpleFeatureTypes.createType)."""
        spec = spec.strip()
        user_data: dict = {}
        if ";" in spec:
            spec, ud = spec.split(";", 1)
            for kv in _split_escaped(ud):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(f"bad user-data entry {kv!r}")
                k, v = kv.split("=", 1)
                user_data[k.strip()] = _unescape(v.strip())
        attrs = []
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            default_geom = entry.startswith("*")
            if default_geom:
                entry = entry[1:]
            parts = entry.split(":")
            name = parts[0].strip()
            if not name:
                raise ValueError(f"attribute with empty name in {entry!r}")
            attr_type = parts[1].strip() if len(parts) > 1 else "String"
            canonical = _TYPE_ALIASES.get(attr_type.lower())
            if canonical is None:
                raise ValueError(f"unknown attribute type {attr_type!r}")
            options = {}
            for opt in parts[2:]:
                if "=" not in opt:
                    raise ValueError(f"bad attribute option {opt!r}")
                k, v = opt.split("=", 1)
                options[k.strip()] = v.strip()
            attrs.append(
                AttributeDescriptor(name, canonical, options, default_geom)
            )
        return SimpleFeatureType(type_name, tuple(attrs), user_data)

    @property
    def spec(self) -> str:
        """Re-serialize to a spec string (round-trips create())."""
        parts = []
        for a in self.attributes:
            s = ("*" if a.default_geom else "") + f"{a.name}:{a.type_name}"
            for k, v in a.options.items():
                s += f":{k}={v}"
            parts.append(s)
        out = ",".join(parts)
        if self.user_data:
            out += ";" + ",".join(f"{k}={_escape(str(v))}" for k, v in self.user_data.items())
        return out
