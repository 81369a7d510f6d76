"""Fusable-query descriptors for the device query scheduler.

Counterpart of ``geomesa_tpu/sched/fusion.py``. A FusableQuery names ONE
resident-index query (count or features) that the micro-batcher may answer
as part of a shared launch. Compatibility is decided in two stages: the
cheap queue-level key (same index object, same operation, same
loose/auths signature) groups candidates, and the index's fused launch
(``DeviceIndex.fused_loose_*``) makes the final call -- it returns None for
a group that cannot share a kernel (mixed engines, a filter the key planes
cannot answer), and the scheduler then runs the queries one by one, which
is always available and always exact.
"""

from __future__ import annotations


class FusableQuery:
    """One scheduler-visible resident query.

    ``op`` is "count" (fused result: int) or "query" (fused result:
    FeatureBatch). ``fusable`` is False when the loose key-plane engine
    cannot answer (loose off for the request, or no key planes): the
    scheduler then skips the fusion window and runs the serial callable
    under admission control only.
    """

    __slots__ = ("di", "query", "op", "loose", "auths", "fusable")

    def __init__(self, di, query, op: str, loose=None, auths=None):
        if op not in ("count", "query"):
            raise ValueError(f"unknown fusable op {op!r}")
        self.di = di
        self.query = query
        self.op = op
        self.loose = loose
        self.auths = tuple(sorted(str(a) for a in (auths or ())))
        self.fusable = bool(di is not None and di._resolve_loose(loose))

    @property
    def key(self):
        """Queue-level compatibility: requests sharing a key MAY ride one
        launch (the index makes the final call)."""
        return (id(self.di), self.op, bool(self.loose), self.auths)

    @property
    def mesh_shards(self) -> int:
        """Shards the index's launches span (0: a single-device index, the
        only kind the port has yet); rides the scheduler's launch spans."""
        return int(getattr(self.di, "mesh_shards", 0) or 0)

    def run_serial(self):
        """The unfused (exact) execution of this one query."""
        if self.op == "count":
            return self.di.count(self.query, loose=self.loose, auths=self.auths)
        return self.di.query(self.query, loose=self.loose, auths=self.auths)


def execute_group(specs: "list[FusableQuery]"):
    """Run a compatible group as ONE batched launch. Returns the per-query
    results aligned with ``specs``, or None when the index declines to fuse
    (the caller runs them serially)."""
    from geomesa_tpu_torch.tracing import span

    di = specs[0].di
    queries = [s.query for s in specs]
    with span("fusion.launch", op=specs[0].op, queries=len(queries),
              shards=specs[0].mesh_shards):
        if specs[0].op == "count":
            return di.fused_loose_counts(queries, loose=specs[0].loose)
        return di.fused_loose_query(queries, loose=specs[0].loose)
