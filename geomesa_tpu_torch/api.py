"""GeoTools-shaped discovery and access API.

Copy of ``geomesa_tpu/api.py`` (ref: the GeoTools SPI surface every
reference store implements: ``DataStoreFinder.getDataStore(params)``,
``DataStoreFactorySpi``, ``DataStore.getFeatureSource`` and
``SimpleFeatureSource.getFeatures/getCount/getBounds``). A reference
user's parameter map flows unchanged:

>>> from geomesa_tpu_torch.api import DataStoreFinder
>>> ds = DataStoreFinder.get_data_store({"memory": "true"})
>>> ds.create_schema("gdelt", "count:Int,dtg:Date,*geom:Point:srid=4326")
>>> source = ds.get_feature_source("gdelt")
>>> source.get_count("BBOX(geom, -10, 35, 30, 60)")
>>> with ds.get_feature_writer_append("gdelt") as w:
...     w.write({"count": 1, "dtg": 0, "geom": "POINT (1 2)"})
>>> ds.dispose()

The memory and file-system (``fs.path``, with ``fs.encoding``) factories
take an optional ``device`` parameter (``"cpu"`` to scan on the host;
default ``cuda:0``). The file-system store writes the port's own
partition files (``fs.encoding`` ``gmcol``, the default; the
counterpart's ``parquet`` and ``orc`` raise, ROADMAP section 3). The
key-value (``kv.catalog``/``kv.sqlite``) and lambda
(``lambda.persistent``) factories are claimed as in the counterpart but
raise ``NotImplementedError`` naming their ROADMAP item: those stores are
not in the port yet.
"""

from __future__ import annotations

from geomesa_tpu_torch.geom import Envelope


class _FactoryRegistry:
    """DataStoreFactorySpi analog: factories claim parameter maps."""

    def __init__(self):
        self._factories: list = []

    def register(self, can_process, create) -> None:
        self._factories.append((can_process, create))

    def create(self, params: dict):
        for can_process, create in self._factories:
            if can_process(params):
                return create(params)
        raise ValueError(
            f"no data store factory accepts params {sorted(params)} "
            "(known keys: fs.path, kv.catalog/kv.sqlite, memory, "
            "lambda.persistent)"
        )


_REGISTRY = _FactoryRegistry()


def register_factory(can_process, create) -> None:
    """SPI hook: third-party stores plug in exactly like the reference's
    META-INF/services registration."""
    _REGISTRY.register(can_process, create)


def _later(store: str):
    def create(params: dict):
        raise NotImplementedError(
            f"the {store} is not in the port yet: ROADMAP, port queue item 5, "
            f"the store path: the {store}"
        )

    return create


def _fs_factory(params: dict):
    from geomesa_tpu_torch.store.fs import FileSystemDataStore
    from geomesa_tpu_torch.store.partfile import ENCODING

    return FileSystemDataStore(
        params["fs.path"],
        encoding=params.get("fs.encoding", ENCODING),
        device=params.get("device"),
    )


def _memory_factory(params: dict):
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    return MemoryDataStore(device=params.get("device"))


def _truthy(v) -> bool:
    """Map<String,String> safe: 'false'/'0'/'no' strings mean False."""
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return bool(v)


_REGISTRY.register(lambda p: "fs.path" in p, _fs_factory)
_REGISTRY.register(
    lambda p: "kv.catalog" in p or "kv.sqlite" in p, _later("key-value store")
)
_REGISTRY.register(lambda p: _truthy(p.get("memory")), _memory_factory)
_REGISTRY.register(
    lambda p: "lambda.persistent" in p and "lambda.type" in p,
    _later("lambda store"),
)


class DataStoreFinder:
    """``DataStoreFinder.getDataStore(Map params)`` analog."""

    @staticmethod
    def get_data_store(params: dict):
        """Create (or open) the store the parameter map describes; the
        returned object is wrapped so ``get_feature_source`` exists
        alongside the store's native API."""
        store = _REGISTRY.create(dict(params))
        return DataStoreAdapter(store)


class SimpleFeature:
    """Row view handed out by feature iteration (getAttribute analog)."""

    __slots__ = ("fid", "_batch", "_row")

    def __init__(self, fid, batch, row: int):
        self.fid = fid
        self._batch = batch
        self._row = row

    def __getitem__(self, attr: str):
        v = self._batch.columns[attr][self._row]
        return v

    def get_attribute(self, attr: str):
        return self[attr]

    @property
    def attributes(self) -> dict:
        return {
            a.name: self[a.name] for a in self._batch.sft.attributes
        }


class FeatureCollection:
    """SimpleFeatureCollection analog over one query result batch."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self) -> int:
        return len(self.batch)

    size = __len__

    def __iter__(self):
        fids = self.batch.fids
        for i in range(len(self.batch)):
            yield SimpleFeature(fids[i], self.batch, i)

    def bounds(self) -> "Envelope | None":
        """ReferencedEnvelope analog over the default geometry."""
        if len(self.batch) == 0:
            return None
        bb = self.batch.bboxes()
        return Envelope(
            float(bb[:, 0].min()), float(bb[:, 1].min()),
            float(bb[:, 2].max()), float(bb[:, 3].max()),
        )


class SimpleFeatureSource:
    """getFeatures / getCount / getBounds over one schema."""

    def __init__(self, store, type_name: str):
        self._store = store
        self.type_name = type_name

    def get_schema(self):
        return self._store.get_schema(self.type_name)

    def get_features(self, query="INCLUDE") -> FeatureCollection:
        return FeatureCollection(
            self._store.query(self.type_name, query).batch
        )

    def get_count(self, query="INCLUDE") -> int:
        return len(self._store.query(self.type_name, query))

    def get_bounds(self, query="INCLUDE") -> "Envelope | None":
        return self.get_features(query).bounds()


class FeatureWriter:
    """FeatureWriterAppend analog (reference ``geomesa_tpu/api.py:248``):
    rows buffer on the host and go to the store in one write, and one
    flush where the store has one, on :meth:`close`."""

    def __init__(self, store, type_name: str):
        self._store = store
        self.type_name = type_name
        self.sft = store.get_schema(type_name)
        self._rows: list = []
        self._fids: list = []

    def write(self, attributes: dict, fid=None) -> None:
        if fid is None:
            # unique across writer sessions, as the reference's generated
            # feature ids are: a positional default would collide with (and
            # upsert over) the rows of an earlier session
            import uuid

            fid = f"{self.type_name}.{uuid.uuid4().hex[:16]}"
        self._rows.append(attributes)
        self._fids.append(fid)

    def close(self) -> None:
        if not self._rows:
            return
        import numpy as np

        # FeatureBatch.from_columns coerces a geometry column that mixes
        # WKT strings, Point objects and (x, y) pairs row by row
        cols = {a.name: [r[a.name] for r in self._rows] for a in self.sft.attributes}
        self._store.write(self.type_name, cols, fids=np.asarray(self._fids, dtype=object))
        if hasattr(self._store, "flush"):
            self._store.flush(self.type_name)
        self._rows, self._fids = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DataStoreAdapter:
    """Wraps any store of the port with the GeoTools-shaped methods while
    delegating everything else to the native API."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        return getattr(self._store, name)

    def get_type_names(self) -> list:
        return list(self._store.type_names)

    def get_feature_source(self, type_name: str) -> SimpleFeatureSource:
        if type_name not in self._store.type_names:
            raise KeyError(type_name)
        return SimpleFeatureSource(self._store, type_name)

    def get_feature_writer_append(self, type_name: str) -> FeatureWriter:
        return FeatureWriter(self._store, type_name)

    def create_schema(self, *a, **kw):
        return self._store.create_schema(*a, **kw)

    def dispose(self) -> None:
        close = getattr(self._store, "close", None)
        if close is not None:
            close()
