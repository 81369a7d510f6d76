"""SpatialFrame: the DataFrame-shaped lazy view over a store type.

Copy of ``geomesa_tpu/sql/frame.py`` (``:25``; ref: geomesa-spark
GeoMesaRelation + the SpatialFilterPushdown rule).
``frame.where("st_contains(...)  AND dtg > ...")`` composes ECQL filters
lazily; ``collect()`` pushes the whole conjunction into the store's query
planner (index choice, z-range prune, one filter-scan mask per run or
partition on the store's device), as the reference rebuilds GeoTools CQL
from Spark SQL predicates. Post-relational ops (select/limit/sort) ride
the same Query so the planner applies them server-side. It works over
any store with ``query`` / ``explain`` / ``get_schema``: the memory
store, the file-system store and the live layer's ``StreamingStore``.

Where it differs from the counterpart:
- ``to_arrow`` raises: the card's host has no ``pyarrow``, and the port
  answers no Arrow until its hand-written IPC writer lands (ROADMAP §3,
  "Arrow responses"; §1, the Arrow IPC writer).
- ``map_partitions`` runs on the port's ``spawn.ContextPool`` with no
  ``pyarrow`` preload.
- A failed launch on the card raises out of ``store.query``; nothing here
  catches it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.query.plan import Query

_NO_ARROW = (
    "SpatialFrame.to_arrow: the port writes no Arrow yet (ROADMAP §3, 'Arrow "
    "responses'; §1, the hand-written Arrow IPC writer); use collect() or to_pandas()"
)


@dataclass(frozen=True)
class SpatialFrame:
    store: object
    type_name: str
    _filter: ast.Filter = ast.Include
    _properties: "tuple[str, ...] | None" = None
    _limit: "int | None" = None
    _sort: "tuple[str, bool] | None" = None  # (attr, descending)
    _hints: dict = field(default_factory=dict)

    # -- composition -------------------------------------------------------

    def where(self, cql: "str | ast.Filter") -> "SpatialFrame":
        f = parse_ecql(cql) if isinstance(cql, str) else cql
        merged = f if self._filter is ast.Include else ast.And((self._filter, f))
        return replace(self, _filter=merged)

    filter = where  # pyspark-style alias

    def select(self, *properties: str) -> "SpatialFrame":
        return replace(self, _properties=tuple(properties))

    def limit(self, n: int) -> "SpatialFrame":
        return replace(self, _limit=int(n))

    def sort(self, attr: str, descending: bool = False) -> "SpatialFrame":
        return replace(self, _sort=(attr, descending))

    orderBy = sort

    def with_auths(self, *auths: str) -> "SpatialFrame":
        h = dict(self._hints)
        h["auths"] = tuple(auths)
        return replace(self, _hints=h)

    # -- execution ---------------------------------------------------------

    def _query(self) -> Query:
        return Query(
            filter=self._filter,
            properties=list(self._properties) if self._properties else None,
            max_features=self._limit,
            sort_by=self._sort[0] if self._sort else None,
            sort_desc=self._sort[1] if self._sort else False,
            hints=dict(self._hints),
        )

    def collect(self):
        """Execute the pushed-down query -> FeatureBatch."""
        return self.store.query(self.type_name, self._query()).batch

    def count(self) -> int:
        return len(self.store.query(self.type_name, self._query()))

    def explain(self) -> str:
        return self.store.explain(self.type_name, self._query())

    def to_arrow(self):
        raise NotImplementedError(_NO_ARROW)

    def to_pandas(self):
        """Collect as a pandas DataFrame (fid index; geometries as WKT
        objects, points too, like the reference's DataFrame view)."""
        import pandas as pd

        from geomesa_tpu_torch.geom import Point, to_wkt

        batch = self.collect()
        data = {}
        for name in batch.sft.attribute_names:
            c = batch.columns[name]
            desc = batch.sft.descriptor(name)
            if desc.is_point and c.dtype != object:
                data[name] = [to_wkt(Point(float(x), float(y))) for x, y in c]
            elif desc.is_geometry:
                data[name] = [to_wkt(g) for g in c]
            elif desc.type_name == "Date":
                data[name] = np.array(c, dtype="datetime64[ms]")
            else:
                data[name] = c
        return pd.DataFrame(data, index=pd.Index(batch.fids, name="fid"))

    def column(self, name: str) -> np.ndarray:
        return self.collect().column(name)

    def __len__(self) -> int:
        return self.count()

    # -- partitioned execution (ref SpatialRDDProvider: one Spark partition
    # -- per range group; callers parallelize over the yielded batches) ----

    def partitions(self):
        """Yield per-storage-partition filtered FeatureBatches when the
        store supports partitioned scans (the fs store's
        ``query_partitions``), else one batch."""
        qp = getattr(self.store, "query_partitions", None)
        if qp is not None:
            yield from qp(self.type_name, self._query())
        else:
            b = self.collect()
            if len(b):
                yield b

    def map_partitions(self, fn, parallelism: "int | None" = None) -> list:
        """Apply ``fn`` to each partition batch, on a thread pool when
        ``parallelism`` > 1 (the executor-side compute analog)."""
        parts = list(self.partitions())
        if not parts:
            return []
        if parallelism is None or parallelism <= 1 or len(parts) == 1:
            return [fn(p) for p in parts]
        from geomesa_tpu_torch.spawn import ContextPool

        with ContextPool(parallelism, thread_name_prefix="sql-part") as pool:
            return list(pool.map(fn, parts))

    # -- grouped aggregation ----------------------------------------------

    def value_counts(self, attr: str) -> dict:
        """Distinct values of ``attr`` -> feature count."""
        vals, counts = np.unique(self.column(attr), return_counts=True)
        return {v: int(c) for v, c in zip(vals.tolist(), counts.tolist())}

    def group_by(self, attr: str, agg_attr: str, agg: str = "count") -> dict:
        """Group rows by ``attr`` and aggregate ``agg_attr`` with one of
        count|sum|min|max|mean."""
        batch = self.collect()
        keys = batch.column(attr)
        vals = batch.column(agg_attr)
        fns = {
            "count": len,
            "sum": lambda v: float(np.sum(v)),
            "min": lambda v: float(np.min(v)),
            "max": lambda v: float(np.max(v)),
            "mean": lambda v: float(np.mean(v)),
        }
        if agg not in fns:
            raise ValueError(f"unknown aggregation {agg!r}")
        return {k: fns[agg](vals[keys == k]) for k in np.unique(keys).tolist()}

    # -- spatial join ------------------------------------------------------

    def spatial_join(self, other, on: str = "intersects", distance: "float | None" = None,
                     device_index=None, sched=None, mesh=None):
        """Join this frame's features against ``other``'s on a spatial
        predicate (``intersects`` | ``contains`` | ``within`` | ``dwithin``
        with ``distance``). Returns (left_batch, right_batch, pairs) where
        pairs is an (m, 2) index array into the two batches.

        Default path (also the parity oracle of the engine path): the
        right side's collected envelope, padded by ``distance``, is pushed
        down into the left side's scan as a BBOX pre-filter (the
        reference's relation pushdown: one more conjunct of the store
        query, so the runner's filter scan applies it), then each right
        row's candidates come from a sorted-coordinate interval prefilter
        and only they run the exact vectorized predicate.

        With a resident ``device_index`` over this frame's type, the join
        routes through the join engine (``join/``): Z-range candidate
        planning, batched count -> compact refinement on the index's
        device, this frame's filter and the index's visibility verdict as
        a row gate (``filter_gate``, the resident mask kernels), and the
        exact predicate over each window's few candidates. ``sched``
        rides the refinement batches through the query scheduler; a
        ``mesh`` raises (ROADMAP item 7). On the engine path ``left`` is
        compacted to exactly the rows ``pairs`` references; on the
        default path it is the bbox-pushed, filtered scan result, which
        may hold rows no pair references. Address left rows through
        ``pairs`` for path-independent results.
        """
        from geomesa_tpu_torch.sql import functions as F

        right = other.collect()
        geom_r = right.sft.geom_field
        rcol = right.columns[geom_r]
        preds = {"intersects": F.st_intersects, "contains": F.st_contains,
                 "within": F.st_within}
        if on == "dwithin" and distance is None:
            raise ValueError("dwithin join needs distance=")
        if on not in preds and on != "dwithin":
            raise ValueError(f"unknown join predicate {on!r}")

        if device_index is not None and len(right):
            got = self._engine_join(device_index, right, geom_r, rcol, on, distance, preds,
                                    sched, mesh)
            if got is not None:
                return got

        # bbox pushdown from the right side's extent
        env = _extent(rcol)
        left_frame = self
        if env is not None:
            pad = distance or 0.0
            left_frame = self.where(ast.BBox(_geom_field_of(self), env[0] - pad, env[1] - pad,
                                             env[2] + pad, env[3] + pad))
        left = left_frame.collect()
        lcol = left.columns[left.sft.geom_field]
        pairs = _reference_pairs(lcol, rcol, on, distance, preds)
        return left, right, pairs

    def _engine_join(self, di, right, geom_r, rcol, on, distance, preds, sched, mesh=None):
        """Join-engine coarse pass (planned, batched) + per-window exact
        refinement; None when the index cannot serve it (a schema with no
        geometry: ``prepare`` raises ``ValueError``/``AttributeError``),
        and the caller then takes the pushdown path. Any other error, a
        failed launch on the card among them, propagates."""
        from geomesa_tpu_torch.join import JoinEngine
        from geomesa_tpu_torch.join.engine import filter_gate

        eng = JoinEngine(di, sched=sched, mesh=mesh)
        try:
            eng.prepare()
        except (ValueError, AttributeError):
            return None
        pad = distance or 0.0
        envs = right.bboxes(geom_r).astype(np.float64)
        if pad:
            envs = envs + np.array([-pad, -pad, pad, pad])
        # the frame filter (any shape: a filter the card declines is
        # evaluated on the host), validity and the fail-closed visibility
        # verdict, as one row gate
        gate = None if self._filter is ast.Include else filter_gate(di, self._filter)
        res = eng.join(envs, gate=gate)
        left = di._host_rows()
        lcol = left.columns[left.sft.geom_field]
        rows, wins = _exact_residual(lcol, rcol, res.rows, res.wins, len(right), on, distance,
                                     preds)
        pairs = np.stack([rows, wins], axis=1) if len(rows) else np.empty((0, 2), np.int64)
        # the returned left batch holds exactly the rows the pairs
        # reference (pair indices remapped), never the whole resident mirror
        if len(pairs):
            uniq, inv = np.unique(pairs[:, 0], return_inverse=True)
            left = left.take(uniq)
            pairs = np.stack([inv.reshape(-1).astype(np.int64), pairs[:, 1]], axis=1)
        else:
            left = left.take(np.empty(0, np.int64))
        return left, right, pairs


def _candidate_hits(sub, g, on, distance, preds):
    from geomesa_tpu_torch.sql import functions as F

    if on == "dwithin":
        return np.asarray(F.st_dwithin(sub, g, distance))
    return np.asarray(preds[on](sub, g))


def _reference_pairs(lcol, rcol, on, distance, preds) -> np.ndarray:
    """The numpy host join (the engine path's parity oracle): per right
    row, a sorted-coordinate / envelope interval prefilter narrows the left
    side to candidates, then the same vectorized exact predicate the
    full-column scan would run decides. Pairs sorted (right, left)."""
    n, m = len(lcol), len(rcol)
    if n == 0 or m == 0:
        return np.empty((0, 2), np.int64)
    pad = distance or 0.0
    out_l: list = []
    out_r: list = []
    if lcol.dtype != object:
        # point left side: one stable argsort of x, then each window is a
        # searchsorted interval (a superset: the exact predicate implies
        # the point lies inside the padded envelope's x-range)
        xv = np.asarray(lcol[:, 0], np.float64)
        xo = np.argsort(xv, kind="stable")
        xs = xv[xo]
        for j in range(m):
            g = _row_geom_of(rcol, j)
            e = g.envelope
            lo = np.searchsorted(xs, e.xmin - pad, side="left")
            hi = np.searchsorted(xs, e.xmax + pad, side="right")
            if hi <= lo:
                continue
            cand = xo[lo:hi]
            ids = cand[_candidate_hits(lcol[cand], g, on, distance, preds)]
            if len(ids):
                out_l.append(np.sort(ids))
                out_r.append(np.full(len(ids), j, np.int64))
    else:
        # non-point left side: per-row envelopes once, then each window
        # prefilters by envelope overlap
        envs_l = np.empty((n, 4), np.float64)
        for i in range(n):
            e = lcol[i].envelope
            envs_l[i] = (e.xmin, e.ymin, e.xmax, e.ymax)
        for j in range(m):
            g = _row_geom_of(rcol, j)
            e = g.envelope
            cand = np.nonzero((envs_l[:, 2] >= e.xmin - pad) & (envs_l[:, 0] <= e.xmax + pad)
                              & (envs_l[:, 3] >= e.ymin - pad) & (envs_l[:, 1] <= e.ymax + pad))[0]
            if not len(cand):
                continue
            ids = cand[_candidate_hits(lcol[cand], g, on, distance, preds)]  # ascending
            if len(ids):
                out_l.append(ids)
                out_r.append(np.full(len(ids), j, np.int64))
    if not out_l:
        return np.empty((0, 2), np.int64)
    return np.stack([np.concatenate(out_l).astype(np.int64), np.concatenate(out_r)], axis=1)


def _exact_residual(lcol, rcol, rows, wins, m, on, distance, preds):
    """Exact-predicate refinement of the engine's envelope pairs, window
    by window (pairs arrive window-sorted): the vectorized predicate over
    each window's few candidates instead of the whole column."""
    if len(rows) == 0:
        return rows, wins
    starts = np.searchsorted(wins, np.arange(m))
    ends = np.searchsorted(wins, np.arange(m), side="right")
    keep = np.zeros(len(rows), bool)
    for j in range(m):
        s, e = starts[j], ends[j]
        if s == e:
            continue
        cand = rows[s:e]
        sub = lcol[cand] if lcol.dtype == object else lcol[cand, :]
        keep[s:e] = _candidate_hits(sub, _row_geom_of(rcol, j), on, distance, preds)
    return rows[keep], wins[keep]


def _geom_field_of(frame: SpatialFrame) -> str:
    return frame.store.get_schema(frame.type_name).geom_field


def _extent(col):
    if len(col) == 0:
        return None
    if col.dtype != object:
        return (float(col[:, 0].min()), float(col[:, 1].min()),
                float(col[:, 0].max()), float(col[:, 1].max()))
    e = col[0].envelope
    for g in col[1:]:
        e = e.expand(g.envelope)
    return (e.xmin, e.ymin, e.xmax, e.ymax)


def _row_geom_of(col, i):
    from geomesa_tpu_torch.sql.functions import _row_geom

    return _row_geom(col, i)
