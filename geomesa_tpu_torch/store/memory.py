"""In-memory columnar DataStore.

Copy of ``geomesa_tpu/store/memory.py`` (ref: geomesa-index-api's
TestGeoMesaDataStore): a full schema -> write -> index-build -> plan ->
device-scan path with no external storage. The data and its sorted
indexes stay on the host; a query stages only the runs it scans onto
``device`` (``cuda:0`` unless the caller passes ``"cpu"``, resolved at
the first scan), where the filter-scan kernel masks them.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from geomesa_tpu_torch.audit import observe_query
from geomesa_tpu_torch.features.batch import FeatureBatch, fids_in
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.api import BuiltIndex
from geomesa_tpu_torch.index.build import DEFAULT_PARTITION_SIZE, build_index
from geomesa_tpu_torch.index.keyspaces import default_indices, keyspace_for
from geomesa_tpu_torch.query.plan import Query, QueryPlan, as_query, plan_query
from geomesa_tpu_torch.query.runner import QueryResult, run_query


@dataclass
class _TypeState:
    sft: SimpleFeatureType
    pending: "list[FeatureBatch]" = field(default_factory=list)
    data: "FeatureBatch | None" = None
    indices: "dict[str, BuiltIndex]" = field(default_factory=dict)
    data_interval: "tuple[int, int] | None" = None
    stats: object = None  # SeqStat maintained at flush (GeoMesaStats analog)


class MemoryDataStore:
    """create_schema / write / query / explain over in-memory partitions."""

    def __init__(
        self,
        partition_size: int = DEFAULT_PARTITION_SIZE,
        audit_writer=None,
        device=None,
    ):
        self._types: dict[str, _TypeState] = {}
        self.partition_size = partition_size
        self.audit_writer = audit_writer  # audit.AuditWriter
        self.device = device  # where scans run; resolved at the first scan

    # -- schema ------------------------------------------------------------

    def create_schema(self, sft: "SimpleFeatureType | str", spec: "str | None" = None):
        if isinstance(sft, str):
            sft = SimpleFeatureType.create(sft, spec)
        if sft.type_name in self._types:
            raise ValueError(f"schema {sft.type_name!r} exists")
        self._types[sft.type_name] = _TypeState(sft)
        return sft

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._state(type_name).sft

    @property
    def type_names(self) -> list:
        return list(self._types)

    def remove_schema(self, type_name: str) -> None:
        del self._types[type_name]

    def _state(self, type_name: str) -> _TypeState:
        if type_name not in self._types:
            raise KeyError(f"no schema {type_name!r}; call create_schema first")
        return self._types[type_name]

    # -- writes ------------------------------------------------------------

    def write(self, type_name: str, columns_or_batch, fids=None) -> int:
        """Append a batch (dict of columns or FeatureBatch); indices are
        rebuilt lazily at the next query (the BatchWriter flush analog)."""
        st = self._state(type_name)
        if isinstance(columns_or_batch, FeatureBatch):
            batch = columns_or_batch
        else:
            batch = FeatureBatch.from_columns(st.sft, columns_or_batch, fids)
        if st.pending or st.data is None:
            st.pending.append(batch)
        else:
            st.pending = [st.data, batch]
            st.data = None
        st.indices = {}
        return len(batch)

    def delete(self, type_name: str, fids) -> int:
        st = self._state(type_name)
        self._flush(st)
        if st.data is None:
            return 0
        # a mixed int/str id list must not collapse to all-str
        keep = ~fids_in(st.data.fids, fids)
        removed = int((~keep).sum())
        st.pending = [st.data.take(np.nonzero(keep)[0])]
        st.data = None
        st.indices = {}
        return removed

    def age_off(self, type_name: str, before_ms: int) -> int:
        from geomesa_tpu_torch.store.ageoff import age_off

        return age_off(self, type_name, self._state(type_name).sft, before_ms)

    def _flush(self, st: _TypeState) -> None:
        if st.pending:
            batches = ([st.data] if st.data is not None else []) + st.pending
            st.data = (
                batches[0] if len(batches) == 1 else FeatureBatch.concat(batches)
            )
            st.pending = []
            st.indices = {}
        if st.data is not None and not st.indices:
            # the indexes are independent: build them side by side (each
            # also runs its row ranges on the host build's workers)
            names = default_indices(st.sft)
            with ThreadPoolExecutor(len(names)) as ex:
                st.indices = dict(zip(names, ex.map(
                    lambda name: build_index(
                        keyspace_for(st.sft, name), st.data, self.partition_size
                    ),
                    names,
                )))
            dtg = st.sft.dtg_field
            if dtg is not None and len(st.data):
                d = st.data.column(dtg)
                st.data_interval = (int(d.min()), int(d.max()))
            st.stats = self._build_stats(st)

    def _build_stats(self, st: _TypeState):
        # the z3 index already encoded every row: its (bin, z) keys feed the
        # Z3 histogram, whose counts do not depend on the rows' order
        z3 = st.indices.get("z3")
        keys = None if z3 is None else (z3.keys["bin"], z3.keys["z"])
        return build_default_stats(st.sft, st.data, keys)

    def stats(self, type_name: str):
        """The maintained SeqStat for a type (ref GeoMesaStats.getStats).
        Always returns a SeqStat (zero-observation sketches before any
        write)."""
        st = self._state(type_name)
        self._flush(st)
        if st.stats is None:
            st.stats = self._build_stats(st)
        return st.stats

    # -- queries -----------------------------------------------------------

    def plan(self, type_name: str, query: "Query | str | ast.Filter") -> QueryPlan:
        """Plan a query; on an empty type plans against the schema's default
        key spaces so filter errors surface and explain() works uniformly."""
        st = self._state(type_name)
        self._flush(st)
        q = as_query(query)
        indices = st.indices or {
            name: keyspace_for(st.sft, name) for name in default_indices(st.sft)
        }
        return plan_query(
            st.sft,
            indices,
            q,
            data_interval=st.data_interval,
            stats=self.stats(type_name),
        )

    def query(self, type_name: str, query: "Query | str | ast.Filter" = ast.Include) -> QueryResult:
        import time as _time

        t0 = _time.perf_counter()
        plan = self.plan(type_name, query)  # flushes
        t1 = _time.perf_counter()
        st = self._state(type_name)
        if st.data is None or len(st.data) == 0:
            from geomesa_tpu_torch.query.runner import _post_process

            empty = (
                st.data
                if st.data is not None
                else FeatureBatch.from_columns(
                    st.sft, {a.name: [] for a in st.sft.attributes}
                )
            )
            result = QueryResult(_post_process(empty, plan), plan, 0, 0)
        else:
            from geomesa_tpu_torch.device import resolve_device

            result = run_query(
                st.indices[plan.index_name], plan, resolve_device(self.device)
            )
        observe_query(
            "memory", type_name, plan, t0, t1, _time.perf_counter(), result,
            self.audit_writer,
        )
        return result

    def explain(self, type_name: str, query: "Query | str | ast.Filter") -> str:
        return self.plan(type_name, query).explain()

    def get_by_ids(self, type_name: str, fids) -> FeatureBatch:
        """Direct id-index lookup (the Id-filter fast path)."""
        st = self._state(type_name)
        self._flush(st)
        built = st.indices.get("id")
        want = np.asarray(fids)
        if built is None or built.n == 0:
            empty = np.array([], dtype=np.int64)
            if built is not None:
                return built.batch.take(empty)
            raise ValueError(f"no data written to {type_name!r}")
        sorted_fids = built.keys["fid"]
        pos = np.clip(np.searchsorted(sorted_fids, want), 0, built.n - 1)
        hit = sorted_fids[pos] == want
        return built.batch.take(pos[hit])

    def count(self, type_name: str, query: "Query | str | ast.Filter" = ast.Include) -> int:
        return len(self.query(type_name, query))


def build_default_stats(
    sft: SimpleFeatureType,
    data: "FeatureBatch | None",
    z3_keys: "tuple | None" = None,
):
    """Write-time stats (ref MetadataBackedStats/StatUpdater): count,
    MinMax per numeric/date attribute, Z3Histogram for point+time
    schemas. Used by the stats API/CLI and selectivity estimates.

    ``z3_keys=(bin, z)`` feeds pre-encoded keys to the Z3 histogram (only
    valid when the keys were computed with the schema's own interval)."""
    from geomesa_tpu_torch.stats import SeqStat
    from geomesa_tpu_torch.stats.sketches import (
        Cardinality,
        CountStat,
        MinMax,
        Z3HistogramStat,
    )

    stats: list = [CountStat()]
    for a in sft.attributes:
        if a.column_dtype is not None and a.column_dtype != np.bool_:
            stats.append(MinMax(a.name))
        if a.indexed and not a.is_geometry:
            # equality-selectivity input for the stat-based planner
            stats.append(Cardinality(a.name))
    z3_hist = None
    geom, dtg = sft.geom_field, sft.dtg_field
    if geom and dtg and sft.descriptor(geom).is_point:
        z3_hist = Z3HistogramStat(geom, dtg, sft.z3_interval)
        stats.append(z3_hist)
    seq = SeqStat(stats)
    if data is not None and len(data):
        if z3_hist is not None and z3_keys is not None:
            seq = SeqStat([s for s in seq.stats if s is not z3_hist])
            seq.observe_batch(data)
            z3_hist.observe_binned(*z3_keys)
            seq = SeqStat(seq.stats + [z3_hist])
        else:
            seq.observe_batch(data)
    return seq
