"""Device-resident index: a type's scan planes pinned in GPU memory,
serving bbox+during count and query through the dim-scan and filter-scan
kernels.

Counterpart of ``DeviceIndex`` in ``geomesa_tpu/device_cache.py``, trimmed
to this slice: full staging (attribute planes plus the de-interleaved
key planes ``__znx/__zny/__zbt`` of z3/z2 point schemas), the loose
key-only count and mask, the exact fused count and mask, and the host
take. Uploads are plain per-plane copies (the counterpart's packed
transfer and thin-transfer tricks exist for its remote link).

Not in this slice; each raises ``NotImplementedError`` naming its ROADMAP
item: visibility/auths staging (labeled rows are refused, never served
unlabeled), the interleaved masked-compare layout (``dim_planes=False``,
or a z3 bin span too wide to pack), the xz kinds, the Q-batched fused
loose paths, streaming and sharded indexes, density, knn, stats and joins.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.curves.binnedtime import (
    bin_to_millis,
    max_offset,
    offset_to_millis,
)
from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.keyplanes import encode_inputs, schema_kind
from geomesa_tpu_torch.ops import zscan
from geomesa_tpu_torch.ops.scan import stage_columns_host, to_tensor
from geomesa_tpu_torch.store.direct import has_labels

# reserved names of the de-interleaved key planes (a leading underscore
# cannot clash with attribute planes "<attr>" / "<attr>__suffix")
Z_NX, Z_NY, Z_BT = "__znx", "__zny", "__zbt"


def _later(item: str) -> str:
    return f"not in the port yet: ROADMAP, port queue: {item}"


def _stageable_planes(sft: SimpleFeatureType) -> list:
    """Device plane names for every attribute the scan kernels can read."""
    planes: list = []
    for a in sft.attributes:
        if a.is_geometry:
            if a.is_point:
                planes += [f"{a.name}__x", f"{a.name}__y"]
            continue
        dtype = a.column_dtype
        if dtype == np.int64:
            planes += [f"{a.name}__hi", f"{a.name}__lo"]
        elif dtype in (np.float32, np.float64, np.int32):
            planes.append(a.name)
    return planes


class DeviceIndex:
    """Resident scan cache over one store type.

    >>> di = DeviceIndex(BatchStore(batch), "gdelt")
    >>> di.count("BBOX(geom, -10, 35, 30, 60) AND dtg DURING ...")
    >>> di.count(..., loose=True)   # key planes only, cell granularity
    >>> batch = di.query(...)        # mask on device, take on host

    ``loose=True`` answers bbox(+during) filters from the key planes at
    cell granularity: a superset of the exact answer (GeoMesa's loose-bbox
    mode). Runs on ``cuda:0`` unless ``device`` says otherwise;
    ``device="cpu"`` runs the kernels' plain versions on the host.
    """

    def __init__(
        self,
        store,
        type_name: str,
        z_planes: bool = True,
        dim_planes: "bool | None" = None,
        device=None,
    ):
        if dim_planes is False:
            raise NotImplementedError(
                _later("interleaved-layout and xz scans")
                + " (dim_planes=False, the masked-compare layout)"
            )
        self.device = resolve_device(device)
        self.store = store
        self.type_name = type_name
        self.sft = store.get_schema(type_name)
        self._planes = _stageable_planes(self.sft)
        self._want_z = z_planes
        self._dim_pref = dim_planes
        self._reset()
        self.refresh()

    def _reset(self) -> None:
        self._z_kind = None
        self._bin_range = None  # (min, max) period bins staged
        self._bt_base = None  # bin_base the bt plane is packed around
        self._host_batch = None
        self._cols: dict = {}
        self._compiled: dict = {}  # repr(filter) -> CompiledFilter
        self._loose_cache: dict = {}  # repr(filter) -> (qarr, R) | None

    @classmethod
    def from_planes(
        cls,
        sft: SimpleFeatureType,
        host_batch,
        planes: dict,
        bt_base: "int | None",
        bin_range: "tuple | None",
        device=None,
    ) -> "DeviceIndex":
        """Serve from planes staged elsewhere (``convert.planes_from_numpy``
        of the counterpart's ``_cols``): the same resident state, so the
        same answers. ``host_batch`` is the row-aligned host mirror."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.store = None
        self.type_name = sft.type_name
        self.sft = sft
        self._planes = _stageable_planes(sft)
        self._want_z = Z_NX in planes
        self._dim_pref = None
        self._reset()
        n = len(host_batch)
        for k, t in planes.items():
            if t.device != self.device or t.dim() != 1 or t.shape[0] != n:
                raise ValueError(
                    f"plane {k}: expected 1-D of {n} rows on {self.device}"
                )
        missing = [p for p in self._planes if p not in planes]
        if missing:
            raise ValueError(f"planes {missing} missing")
        self._host_batch = host_batch
        self._cols = dict(planes)
        if self._want_z:
            kind, _ = schema_kind(sft)
            want = (Z_NX, Z_NY, Z_BT) if kind == "z3" else (Z_NX, Z_NY)
            if kind is None or any(p not in planes for p in want):
                raise ValueError(f"key planes {want} missing for a {kind} schema")
            self._z_kind = kind
            self._bt_base = None if bt_base is None else int(bt_base)
            self._bin_range = None if bin_range is None else tuple(int(b) for b in bin_range)
        return self

    # -- staging -----------------------------------------------------------

    def refresh(self) -> None:
        """Re-stage from the backing store (after writes)."""
        if self.store is None:
            raise RuntimeError("an index built from planes has no store")
        res = self.store.query(self.type_name, ast.Include, raw_visibility=True)
        self._reset()
        self._host_batch = res.batch
        self._cols = self._stage_batch(res.batch)

    def _stage_batch(self, batch) -> dict:
        """Attribute planes + (optionally) key planes for a batch."""
        if has_labels(batch):
            raise NotImplementedError(
                _later("visibility/auths and _fused_agg")
                + "; labeled rows are never served unlabeled"
            )
        host = stage_columns_host(batch, self._planes)
        cols = {k: to_tensor(v, self.device) for k, v in host.items()}
        if not self._want_z:
            return cols
        kind, sfc = schema_kind(self.sft)
        if kind is None:
            return cols
        coords, bins = encode_inputs(
            batch, kind, sfc, self.sft.geom_field, self.sft.dtg_field
        )
        if not self._dim_usable(kind, sfc, bins):
            raise NotImplementedError(
                _later("interleaved-layout and xz scans")
                + " (z3 data whose bin span does not pack into the bt word)"
            )
        self._z_kind = kind
        if kind == "z2":
            cols.update(self._dim_planes_z2(sfc, coords))
        else:
            cols.update(self._dim_planes_for(sfc, coords, bins))
            if len(batch):
                self._bin_range = (int(bins.min()), int(bins.max()))
        return cols

    def _dim_usable(self, kind, sfc, bins) -> bool:
        """Whether the dim-plane layout packs: z2 always; z3 with 21-bit
        time precision and a bin span inside the packable window (top bin
        reserved for the out-of-range sentinel)."""
        if kind == "z2":
            return True
        if sfc.precision != zscan.BT_TIME_BITS:
            if self._dim_pref is True:
                raise ValueError(
                    f"dim_planes=True requires time precision "
                    f"{zscan.BT_TIME_BITS} (got {sfc.precision})"
                )
            return False
        if bins is None or len(bins) == 0:
            return True
        span_ok = int(bins.max()) - int(bins.min()) < zscan.BT_BIN_SPAN - 1
        if not span_ok and self._dim_pref is True:
            raise ValueError(
                f"dim_planes=True but the data spans >= {zscan.BT_BIN_SPAN - 1} "
                "period bins; the bt word cannot pack them"
            )
        return span_ok

    def _quantize(self, dim, values: np.ndarray) -> torch.Tensor:
        # float64 on the device: the counterpart quantizes under scoped x64
        return dim.normalize_t(torch.from_numpy(values).to(self.device))

    def _dim_planes_z2(self, sfc, coords) -> dict:
        x, y = coords
        return {
            Z_NX: zscan._u32(self._quantize(sfc.lon, x)),
            Z_NY: zscan._u32(self._quantize(sfc.lat, y)),
        }

    def _dim_planes_for(self, sfc, coords, bins) -> dict:
        if bins is None or len(bins) == 0:
            e = torch.empty(0, dtype=torch.uint32, device=self.device)
            return {Z_NX: e, Z_NY: e.clone(), Z_BT: e.clone()}
        self._bt_base = int(bins.min())
        x, y, off = coords
        nx, ny, bt = zscan.z3_dim_planes(
            sfc,
            self._quantize(sfc.lon, x),
            self._quantize(sfc.lat, y),
            self._quantize(sfc.time, off),
            torch.from_numpy(np.asarray(bins, np.int64)).to(self.device),
            self._bt_base,
        )
        return {Z_NX: nx, Z_NY: ny, Z_BT: bt}

    def __len__(self) -> int:
        return len(self._host_batch)

    @property
    def nbytes(self) -> int:
        """Resident device bytes."""
        return int(sum(t.numel() * t.element_size() for t in self._cols.values()))

    # -- loose (key-only) scans --------------------------------------------

    def _bbox_during_parts(self, f):
        """(envelope, window) when the filter is EXACTLY a bbox on the
        default geometry, a during on the default date, or both ANDed --
        the only shapes the key planes answer; else None."""
        geom, dtg = self.sft.geom_field, self.sft.dtg_field
        parts = f.children if isinstance(f, ast.And) else (f,)
        env = window = None
        for p in parts:
            if isinstance(p, ast.BBox) and p.attr == geom and env is None:
                env = (p.xmin, p.ymin, p.xmax, p.ymax)
            elif isinstance(p, ast.During) and p.attr == dtg and window is None:
                window = (int(p.t0), int(p.t1))
            else:
                return None
        return env, window

    def _loose_bounds(self, f):
        """(qarr, R) for the dim scan (R = 0: the 2-plane z2 scan), or None
        when the key planes cannot answer the filter. Cached per filter."""
        key = repr(f)
        if key not in self._loose_cache:
            self._loose_cache[key] = self._loose_bounds_uncached(f)
        return self._loose_cache[key]

    def _loose_bounds_uncached(self, f):
        if self._z_kind is None:
            return None
        parts = self._bbox_during_parts(f)
        if parts is None:
            return None
        env, window = parts
        if env is None and window is None:
            return None  # INCLUDE: nothing to prune, use the normal path
        _, sfc = schema_kind(self.sft)
        if self._z_kind == "z2":
            if window is not None:
                return None  # no time in the key
            return zscan.z2_dim_plane_qarr(sfc, env), 0
        if env is None:
            env = (-180.0, -90.0, 180.0, 90.0)
        if window is None:
            if self._bin_range is None:
                return None  # empty index; the normal path returns empty too
            p = sfc.period
            window = (
                int(bin_to_millis(self._bin_range[0], p)),
                int(bin_to_millis(self._bin_range[1], p))
                + int(offset_to_millis(max_offset(p), p)),
            )
        if self._bt_base is None:
            return None  # nothing staged; the normal path returns empty too
        return zscan.z3_dim_plane_qarr(
            sfc, env, window, self._bt_base, self._bin_range
        )

    def _dim_operands(self, r: int) -> tuple:
        if r == 0:
            return self._cols[Z_NX], self._cols[Z_NY]
        return self._cols[Z_NX], self._cols[Z_NY], self._cols[Z_BT]

    def _resolve_loose(self, loose: "bool | None") -> bool:
        # None: the counterpart's query.loose.bbox default (off)
        return bool(loose) and self._z_kind is not None

    # -- queries -----------------------------------------------------------

    def _parse(self, query) -> ast.Filter:
        from geomesa_tpu_torch.filter.ecql import parse_ecql

        if isinstance(query, str):
            return parse_ecql(query)
        if isinstance(query, ast.Filter):
            return query
        raise TypeError("DeviceIndex takes a CQL string or filter AST")

    def _compiled_for(self, f):
        from geomesa_tpu_torch.filter.compile import compile_filter

        key = repr(f)
        if key not in self._compiled:
            self._compiled[key] = compile_filter(f, self.sft)
        return self._compiled[key]

    def _resident_subset(self, compiled) -> dict:
        return {c: self._cols[c] for c in compiled.device_cols}

    def count(self, query, loose: "bool | None" = None) -> int:
        """Fused device count; exact when the filter is fully on device,
        else it falls through to query(). With loose=True bbox(+during)
        filters are answered at cell granularity from the key planes."""
        f = self._parse(query)
        if self._resolve_loose(loose):
            lb = self._loose_bounds(f)
            if lb is not None:
                qarr, r = lb
                return int(zscan.dimscan_count(qarr, *self._dim_operands(r)))
        compiled = self._compiled_for(f)
        if not compiled.device_cols:
            return int(compiled.host_mask(self._host_batch).sum())
        if not compiled.fully_on_device:
            return len(self.query(f))
        return int(compiled.count(self._resident_subset(compiled)))

    def mask(self, query, loose: "bool | None" = None) -> np.ndarray:
        """Boolean hit mask over the staged rows (host array)."""
        f = self._parse(query)
        if self._resolve_loose(loose):
            lb = self._loose_bounds(f)
            if lb is not None:
                qarr, r = lb
                return zscan.dimscan_mask(qarr, *self._dim_operands(r)).cpu().numpy()
        compiled = self._compiled_for(f)
        if not compiled.device_cols:
            return compiled.host_mask(self._host_batch)
        m = compiled.mask(self._resident_subset(compiled)).cpu().numpy()
        if not compiled.fully_on_device:
            idx = np.nonzero(m)[0]
            out = np.zeros(len(m), dtype=bool)
            if len(idx):
                keep = compiled.residual_mask(self._host_batch.take(idx))
                out[idx[keep]] = True
            m = out
        return m

    def query(self, query, loose: "bool | None" = None):
        """FeatureBatch of hits (host-side take over the device mask)."""
        return self._host_batch.take(np.nonzero(self.mask(query, loose=loose))[0])

    # -- later slices --------------------------------------------------------

    def fused_loose_counts(self, queries, loose=None):
        raise NotImplementedError(_later("Q-batched fused loose paths"))

    def fused_loose_query(self, queries, loose=None):
        raise NotImplementedError(_later("Q-batched fused loose paths"))

    def refresh_delta(self, batch):
        raise NotImplementedError(_later("StreamingDeviceIndex"))

    def density(self, *args, **kwargs):
        raise NotImplementedError(_later("density (build_density_pallas)"))

    def knn(self, *args, **kwargs):
        raise NotImplementedError(_later("stats/knn/joins"))

    def stats(self, *args, **kwargs):
        raise NotImplementedError(_later("stats/knn/joins"))
