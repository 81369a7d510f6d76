"""Query execution: partition prune -> staged device mask scan -> host
residual -> local post-processing.

Copy of ``geomesa_tpu/query/runner.py`` (ref: the scan side of GeoMesa's
BatchScanPlan and LocalQueryRunner). The surviving partitions merge into
contiguous runs of at most ``MAX_RUN_PARTS``; each run's device columns
are staged onto the card (``ops/scan.py`` ``stage_columns``) and scanned
by one ``CompiledFilter.mask`` call, which launches the filter-scan kernel
(``csrc/filter_scan.cu``) for a program its encoder accepts and the plain
``device_fn`` otherwise; one copy brings the mask back. Non-device
predicates run as an exact numpy residual over the surviving candidates.
A scan runs under the ``query.scan`` span and profile (``profiling.py``);
with ``trace.device.dir`` set, a sampled request's run launches are also
recorded by ``torch.profiler`` into Chrome traces there
(``_device_trace_ctx``).

OOM recovery by halving a run is the counterpart's. Its host-degrade
rung is the counterpart's for a store on the CPU only: there a launch that
fails (or an OOM too small to split) under ``resilience.degrade``
evaluates the same predicate on the host rows and notes
``device-launch-failed`` (or ``device-oom``) for the server's degradation
collector. On the card the same faults raise, so no answer of a store on
the card is computed on the host; the server's ladder falls from the
resident rung to this, the store rung, which scans on the card. With the
switch off, or on a FATAL fault, it raises on either device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.index.api import BuiltIndex
from geomesa_tpu_torch.ops.scan import stage_columns
from geomesa_tpu_torch.query.plan import QueryPlan


@dataclass
class QueryResult:
    batch: FeatureBatch
    plan: "QueryPlan | None"
    scanned: int  # rows device-scanned after pruning
    total: int  # rows in the index

    def __len__(self) -> int:
        return len(self.batch)


MAX_RUN_PARTS = 8


def _contiguous_runs(parts) -> "list[tuple[int, int]]":
    """Merge adjacent surviving partitions into [start, stop) runs: the
    predicate is elementwise, so one staging + one kernel launch per run
    instead of per partition (a BatchScanner coalescing its ranges).
    Runs cap at MAX_RUN_PARTS partitions, which bounds what one run
    stages on the card."""
    runs: list = []
    counts: list = []
    for p in parts:
        if runs and runs[-1][1] == p.start and counts[-1] < MAX_RUN_PARTS:
            runs[-1][1] = p.stop
            counts[-1] += 1
        else:
            runs.append([p.start, p.stop])
            counts.append(1)
    return [(a, b) for a, b in runs]


def run_query(built: BuiltIndex, plan: QueryPlan, device,
              defer_visibility: bool = False) -> QueryResult:
    """Scan ``built`` for ``plan``, staging each run onto ``device``.
    ``defer_visibility`` leaves the visibility filter to the caller: the
    file-system store's per-partition scans set it and apply the query's
    auths once, after the merge. It is an argument, never a query hint,
    so no caller-supplied query can switch visibility off."""
    from geomesa_tpu_torch.profiling import profile
    from geomesa_tpu_torch.tracing import span

    with profile("query.scan"), span("query.scan") as sp:
        res = _run_query(built, plan, device, defer_visibility)
        sp.set(scanned=res.scanned, hits=len(res))
        return res


def _device_trace_ctx():
    """The ``trace.device.dir`` hook: a sampled request's store-run launch
    is also recorded by ``torch.profiler`` into a Chrome trace in that
    directory, named by the request's trace id, when the key names one.
    The host-side trace says which launch was slow; the profiler's says
    why (kernel times, copies)."""
    from contextlib import nullcontext

    from geomesa_tpu_torch.conf import sys_prop
    from geomesa_tpu_torch.tracing import current_trace

    log_dir = str(sys_prop("trace.device.dir") or "")
    if not log_dir:
        return nullcontext()
    t = current_trace()
    if t is None or not t.sampled:
        return nullcontext()
    from geomesa_tpu_torch.profiling import device_trace

    return device_trace(log_dir, name=t.trace_id)


#: OOM-recovery recursion bound: halving a run more times than this
#: means the device cannot hold even a sliver; give up loudly
_MAX_OOM_SPLITS = 8


def _on_host(device) -> bool:
    """Does ``device`` name the CPU? Only there may a failed run take the
    host rung: on the card it raises."""
    import torch

    return torch.device(device).type == "cpu"


def _scan_run(built, compiled, device, start: int, stop: int,
              depth: int = 0) -> np.ndarray:
    """One staged device launch over rows [start, stop) returning the
    fetched mask. A staging/device OOM (or the ``fail.stage.oom``
    injection) recovers by HALVING the run and retrying each half; on a
    CPU ``device`` a failure that is not FATAL (``fail.device.launch``
    among them) falls to the host rung under ``resilience.degrade``; the
    rest raises, and on the card every failure that halving cannot
    recover raises."""
    from geomesa_tpu_torch import ledger, resilience
    from geomesa_tpu_torch.failpoints import FailpointError, fail_point
    from geomesa_tpu_torch.tracing import span

    try:
        t_stage = time.perf_counter()
        with span("device.launch", rows=int(stop - start)), _device_trace_ctx():
            fail_point("fail.device.launch")
            fail_point("fail.stage.oom")
            cols = stage_columns(built.batch, compiled.device_cols, device, start, stop)
            t_launch = time.perf_counter()
            # the mask's copy back is the launch's one sync point per run
            out = compiled.mask(cols).cpu().numpy()
        # store-path launches never pass through the scheduler's device
        # accounting: charge the requesting ledger here; column staging
        # counts as stage time, the launch and the mask fetch as device time
        done = time.perf_counter()
        ledger.charge("stage_seconds", t_launch - t_stage)
        ledger.charge("device_launches", 1)
        ledger.charge("device_seconds", done - t_launch)
        return out
    except Exception as e:
        # fail.stage.oom's FailpointError simulates an OOM at this site;
        # fail.device.launch raises the same type and must not halve
        oom = resilience.is_oom(e) or (
            isinstance(e, FailpointError)
            and getattr(e, "name", None) == "fail.stage.oom"
        )
        if oom and resilience.enabled() and stop - start > 1 \
                and depth < _MAX_OOM_SPLITS:
            from geomesa_tpu_torch import metrics

            metrics.resilience_oom_recoveries.inc()
            mid = (start + stop) // 2
            return np.concatenate([
                _scan_run(built, compiled, device, start, mid, depth + 1),
                _scan_run(built, compiled, device, mid, stop, depth + 1),
            ])
        if _on_host(device) and resilience.degrade_allowed() \
                and resilience.classify(e) != resilience.FATAL:
            # the device rung is unavailable: evaluate the same predicate
            # on the host rows (exact, slower); the residual re-applies
            # downstream and is a subset of it, so applying both is safe
            resilience.note_degraded("device-oom" if oom else "device-launch-failed")
            rows = built.batch.take(np.arange(start, stop))
            return np.asarray(compiled.host_mask(rows), dtype=bool)
        raise


def _run_query(built: BuiltIndex, plan: QueryPlan, device,
               defer_visibility: bool) -> QueryResult:
    parts = built.prune(plan.ranges)
    compiled = plan.compiled
    n_scanned = sum(p.count for p in parts)

    hit_chunks: list[np.ndarray] = []
    if parts:
        use_device = bool(compiled.device_cols)
        for start, stop in _contiguous_runs(parts):
            if use_device:
                mask = _scan_run(built, compiled, device, start, stop)
            else:
                mask = np.ones(stop - start, dtype=bool)
            idx = np.nonzero(mask)[0]
            if len(idx) and not compiled.fully_on_device:
                cand = built.batch.take(idx + start)
                idx = idx[compiled.residual_mask(cand)]
            if len(idx):
                hit_chunks.append(idx + start)

    if hit_chunks:
        rows = np.concatenate(hit_chunks)
    else:
        rows = np.array([], dtype=np.int64)
    result = _post_process(built.batch.take(rows), plan, defer_visibility)
    return QueryResult(result, plan, n_scanned, built.n)


def _post_process(batch: FeatureBatch, plan: QueryPlan,
                  defer_visibility: bool = False) -> FeatureBatch:
    """visibility / sort / max-features / projection (ref
    LocalQueryRunner + Accumulo cell-visibility filtering)."""
    q = plan.query
    # a labeled feature is hidden unless the query's auths satisfy it,
    # including when no auths were supplied at all. Per-partition scans
    # (the fs store) defer this to the outer, global post-process, so the
    # real auths are the ones applied. raw_visibility is the
    # resident index's staging escape hatch: it stages every row with a
    # label-id plane and enforces visibility per request itself; it must
    # never be set on a user-facing query.
    if not defer_visibility and not q.hints.get("raw_visibility"):
        from geomesa_tpu_torch.security import filter_by_visibility

        m = filter_by_visibility(batch, q.hints.get("auths", ()))
        if m is not None:
            batch = batch.take(np.nonzero(m)[0])
    if q.sort_by:
        order = np.argsort(batch.column(q.sort_by), kind="stable")
        if q.sort_desc:
            order = order[::-1]
        batch = batch.take(order)
    if q.max_features is not None and len(batch) > q.max_features:
        batch = batch.take(np.arange(q.max_features))
    if q.properties:
        from geomesa_tpu_torch.features.sft import SimpleFeatureType

        attrs = tuple(batch.sft.descriptor(p) for p in q.properties)
        sub_sft = SimpleFeatureType(batch.sft.type_name, attrs, batch.sft.user_data)
        batch = FeatureBatch(
            sub_sft, batch.fids, {p: batch.columns[p] for p in q.properties}
        )
    return batch
