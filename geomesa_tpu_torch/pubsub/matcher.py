"""Fused batch x subscriptions matching on the ingest path.

Copy of ``geomesa_tpu/pubsub/matcher.py``. The subscription side is
encoded once per registry generation: every subscription's coarse
predicate envelope is XZ-encoded into a join layout
(:func:`geomesa_tpu_torch.join.build_envelope_layout`) on the stream
store's device, so on the card the layout's planes live there and
``JoinEngine(jidx=...)`` runs its device engine (``ops/join.py``) there.
Each acked append batch then runs as one fused spatial join against that
layout, one join whatever the number of subscriptions (never a loop over
subscriptions), and the coarse pairs are refined by the exact predicates
on the host, as in the counterpart:

- bbox: the coarse envelope is the (intersected) bbox, and envelope
  overlap is the exact BBOX semantics, so no residual is needed;
- dwithin: the exact centre-to-envelope distance;
- ECQL: :func:`geomesa_tpu_torch.filter.compile.evaluate_host`;
- visibility: :func:`geomesa_tpu_torch.security.filter_by_visibility`
  with the subscription's auths, fail closed as reads are.

Where the port differs: the join runs in line on the caller's thread, so
it shares the slot of whatever called it (an append on a scheduler
worker, a resume's replay on its handler thread). The counterpart submits
the join to the scheduler's ingest lane and waits, holding the append's
worker or, in a replay, the hub's match lock that the appends' workers
wait on: with every worker so held the match waits out the default
deadline (30 s), the appends answer 504 and faults are counted (ROADMAP
section 3). ``launches`` counts the fused joins.
"""

from __future__ import annotations

import time

import numpy as np

from geomesa_tpu_torch import metrics
from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.failpoints import fail_point
from geomesa_tpu_torch.filter.compile import evaluate_host
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.join import JoinEngine, build_envelope_layout
from geomesa_tpu_torch.security import filter_by_visibility


class SubscriptionMatcher:
    """Encode-once layout cache and the fused match over it.

    Not internally locked: the hub serializes calls per type (records are
    processed in seq order under its reorder buffer), and the layout cache
    is a per-generation swap (a stale read just rebuilds). ``device`` is
    where the layout lives and the join runs: ``cuda:0`` by default, which
    raises without CUDA unless the caller passes ``device="cpu"``."""

    def __init__(self, registry, device=None) -> None:
        self.registry = registry
        self.device = resolve_device(device)
        self._layouts: dict = {}  # type -> (gen, jidx | None, subs, empty mask)
        self._filters: dict = {}  # cql text -> parsed AST (bounded by the subs)
        self.launches = 0  # fused joins, one an acked batch

    # -- layout ------------------------------------------------------------

    def _layout(self, type_name: str, precision: int):
        gen = self.registry.gen
        cached = self._layouts.get(type_name)
        if cached is not None and cached[0] == gen:
            return cached[1], cached[2], cached[3]
        subs = self.registry.for_type(type_name)
        if not subs:
            entry = (gen, None, (), None)
        else:
            envs = np.stack([s.envelope() for s in subs])
            # provably empty predicates stay in the layout as degenerate
            # boxes so that row ids keep aligning with ``subs``; the empty
            # mask drops their pairs after the join
            empty = ~np.isfinite(envs).all(axis=1)
            if empty.any():
                envs = envs.copy()
                envs[empty] = (0.0, 0.0, 0.0, 0.0)
            jidx = build_envelope_layout(envs, precision=precision, gen=gen, device=self.device)
            entry = (gen, jidx, subs, empty if empty.any() else None)
        self._layouts[type_name] = entry
        metrics.pubsub_subscriptions.set(float(self.registry.count()))
        return entry[1], entry[2], entry[3]

    def layout_device(self, type_name: str):
        """The device of the type's cached layout, or None before one."""
        cached = self._layouts.get(type_name)
        return None if cached is None or cached[1] is None else cached[1].device

    def _filter(self, cql: str):
        f = self._filters.get(cql)
        if f is None:
            f = parse_ecql(cql)
            if len(self._filters) > 4 * max(1, self.registry.count()):
                self._filters.clear()  # bounded by the live subscription count
            self._filters[cql] = f
        return f

    # -- match -------------------------------------------------------------

    def match(self, type_name: str, batch, sft) -> list:
        """Match one acked batch against every standing subscription of its
        type in a single fused join. Returns ``[(sub, rows), ...]`` in
        registration order, ``rows`` the matched batch row indices
        (ascending), for the subscriptions with at least one match."""
        fail_point("fail.sub.match")
        jidx, subs, empty = self._layout(type_name, sft.xz_precision)
        if jidx is None or not len(batch):
            return []
        t0 = time.perf_counter()
        geom = sft.geom_field
        if geom is not None and sft.descriptor(geom).is_point:
            x, y = batch.point_coords(geom)
            fenvs = np.stack([x, y, x, y], axis=1)
        elif geom is not None:
            fenvs = np.asarray(batch.bboxes(geom), dtype=np.float64)
        else:
            return []
        res = JoinEngine(jidx=jidx, sched=None).join(fenvs)
        self.launches += 1
        out = []
        if len(res.rows):
            order = np.argsort(res.rows, kind="stable")
            srows = np.asarray(res.rows)[order]
            swins = np.asarray(res.wins)[order]
            starts = np.concatenate(([0], np.flatnonzero(np.diff(srows)) + 1))
            bounds = np.append(starts[1:], len(srows))
            for lo, hi in zip(starts, bounds):
                si = int(srows[lo])
                if empty is not None and empty[si]:
                    continue
                sub = subs[si]
                rows = np.sort(swins[lo:hi].astype(np.int64))
                rows = self._refine(sub, batch, rows, fenvs)
                if len(rows):
                    out.append((sub, rows))
        metrics.pubsub_match_batches.inc()
        metrics.pubsub_match_pairs.inc(float(sum(len(r) for _s, r in out)))
        metrics.pubsub_match_seconds.observe(time.perf_counter() - t0)
        return out

    def _refine(self, sub, batch, rows: np.ndarray, fenvs: np.ndarray):
        """The exact residuals over one subscription's coarse pairs."""
        keep = np.ones(len(rows), dtype=bool)
        # visibility, fail closed: a feature without clearance never reaches
        # a subscriber, exactly as on the read path
        vmask = filter_by_visibility(batch, sub.auths)
        if vmask is not None:
            keep &= np.asarray(vmask, dtype=bool)[rows]
        if sub.dwithin is not None and keep.any():
            cx, cy, dist = sub.dwithin
            fe = fenvs[rows]
            dx = np.maximum(np.maximum(fe[:, 0] - cx, cx - fe[:, 2]), 0.0)
            dy = np.maximum(np.maximum(fe[:, 1] - cy, cy - fe[:, 3]), 0.0)
            keep &= np.hypot(dx, dy) <= dist
        if sub.cql and keep.any():
            mask = evaluate_host(self._filter(sub.cql), batch)
            keep &= np.asarray(mask, dtype=bool)[rows]
        return rows[keep]
