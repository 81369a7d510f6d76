"""The resident warmup: run every kernel family of the resident indexes
once, before ``/readyz`` lets traffic in.

Copy of ``geomesa_tpu/warmup.py``. On the card there is no jit cache to
fill; a cold process pays other first-use costs instead, and a warmup
pass moves them off the first requests:

- the CUDA context;
- the first build (an ``nvcc`` run) or load of each kernel library
  (``kernels/_build.py``; the only compiles the compile ledger counts);
- the caching allocator's first growth at the staged shapes;
- the filter scan's launch records of each plane set
  (``ops/filter_scan.py``);
- the batched scans' first packing.

The pass:

- **Plan.** Each resident :class:`~geomesa_tpu_torch.device_cache.DeviceIndex`
  lists its ``warmup_plan``: (signature, thunk) legs covering the scan and
  aggregation families, the kNN ``k`` ladder up to
  ``compile.warmup.knn.kmax`` and the fused width ladder up to the
  scheduler's ``sched.max.fusion``.
- **Execute.** Legs run in a bounded pool (``compile.warmup.threads``)
  without blocking the accept loop. Every leg runs under the ledger's
  ``_system`` tenant (its own :func:`ledger.collect_cost` collector on the
  pool thread; the pool carries no caller context), so a kernel build
  that finishes while a request is in flight is never charged to that
  request. A leg counts as ``compiled`` when its cost row saw a kernel
  build (the build listener that :func:`ledger.install` registers charges
  ``compiles``), else as ``from_cache``; a leg that raises counts as
  ``failed`` and the pass goes on: a warmup never takes a server down.
  An index whose ``warmup_plan`` raises counts as one ``failed`` leg, and
  the pass ends in ``warm`` whatever raised, so the gate never stays shut
  (the counterpart plans before its ``try`` and stays ``warming``:
  ROADMAP section 3).
- **Gate.** ``/readyz`` consults :func:`warming` per
  ``compile.warmup.gate``: ``ready`` holds readiness at 503 until the pass
  ends, ``stamp`` serves at once but stamps ``warming`` into the readiness
  document, ``off`` hides the warmup from readiness. Progress
  (``signatures_total`` / ``done`` / ``compiled`` / ``from_cache`` /
  ``failed`` / ``seconds``) is on ``/stats``, the
  ``geomesa_warmup_signatures`` gauge and the CLI's ``warmup`` command.
"""

from __future__ import annotations

import threading
import time
import warnings

from geomesa_tpu_torch.locking import checked_lock

__all__ = ["plan", "progress", "reset", "run", "start", "warming"]

_lock = checked_lock("warmup.state")
#: the process-wide progress document (one warmup pass per process: the
#: scope of the compile ledger it feeds)
_state: dict = {
    "state": "idle",  # idle | warming | warm
    "signatures_total": 0,
    "done": 0,
    "compiled": 0,
    "from_cache": 0,
    "failed": 0,
    "seconds": 0.0,
}


def progress() -> dict:
    """Snapshot of the progress document (the ``/stats`` form)."""
    with _lock:
        return dict(_state)


def warming() -> bool:
    """True while a warmup pass runs (the readiness gate's input)."""
    with _lock:
        return _state["state"] == "warming"


def reset() -> None:
    """Reset the progress document (tests; a fresh process starts idle)."""
    with _lock:
        _state.update(
            state="idle", signatures_total=0, done=0, compiled=0,
            from_cache=0, failed=0, seconds=0.0,
        )


def _gauge() -> None:
    from geomesa_tpu_torch import metrics

    with _lock:
        st = dict(_state)
    metrics.warmup_signatures.set(st["signatures_total"], state="total")
    metrics.warmup_signatures.set(st["compiled"], state="compiled")
    metrics.warmup_signatures.set(st["from_cache"], state="from_cache")
    metrics.warmup_signatures.set(st["failed"], state="failed")


def plan(indexes: dict, knn_kmax: "int | None" = None,
         fusion_max: "int | None" = None) -> "list[tuple[str, object]]":
    """The full plan over ``{type_name: DeviceIndex}``: every index's
    ``warmup_plan`` legs with type-qualified signatures, the kNN k ladder
    and the fused width ladder included. The bounds default from conf:
    ``compile.warmup.knn.kmax`` and ``sched.max.fusion`` snapped to the
    bucket ladder, the widths the scheduler serves."""
    from geomesa_tpu_torch.bucketing import bucket_cap
    from geomesa_tpu_torch.conf import sys_prop

    if knn_kmax is None:
        knn_kmax = int(sys_prop("compile.warmup.knn.kmax"))
    if fusion_max is None:
        fusion_max = bucket_cap(int(sys_prop("sched.max.fusion")))
    legs: list = []
    for tn, di in sorted(indexes.items()):
        for sig, fn in di.warmup_plan(knn_kmax=knn_kmax, fusion_max=fusion_max):
            legs.append((f"{tn}:{sig}", fn))
    return legs


def _run_leg(sig: str, fn) -> None:
    """One leg, charged to the ``_system`` tenant: the collector is
    installed on this pool thread's context, so a kernel build the leg
    waits on is charged here and never to a request in flight."""
    from geomesa_tpu_torch import ledger

    t0 = time.perf_counter()
    with ledger.collect_cost(tenant="_system", endpoint="warmup", lane="batch", shape=sig) as cost:
        try:
            fn()
            cost.status = 200
        except Exception:  # warmup must never break serving: the 500 on the _system row records it
            cost.status = 500
    cost.dur_s = time.perf_counter() - t0
    if ledger.enabled():
        ledger.LEDGER.record(cost)
    fields = cost.snapshot_fields()
    with _lock:
        _state["done"] += 1
        if cost.status >= 500:
            _state["failed"] += 1
        elif fields.get("compiles", 0):
            _state["compiled"] += 1
        else:
            # no kernel build seen: every library the leg used was built
            _state["from_cache"] += 1


def run(indexes: dict, threads: "int | None" = None,
        knn_kmax: "int | None" = None,
        fusion_max: "int | None" = None) -> dict:
    """Run the full plan in a bounded thread pool; returns the final
    progress document. Synchronous: the server runs it on a background
    thread through :func:`start`; the CLI calls it directly."""
    from geomesa_tpu_torch import ledger
    from geomesa_tpu_torch.conf import sys_prop
    from geomesa_tpu_torch.spawn import ContextPool

    t0 = time.perf_counter()
    try:
        if threads is None:
            threads = int(sys_prop("compile.warmup.threads"))
        ledger.install()  # a kernel build in a leg charges its cost row's compiles
        # planning runs on the caller's thread (it reads the staged planes):
        # charge it to _system too, never to a collector the caller installed.
        # An index that cannot plan (a CUDA error, an OOM reading its planes)
        # counts as one failed leg and the pass goes on without it.
        legs, unplanned = [], []
        with ledger.collect_cost(tenant="_system", endpoint="warmup", lane="batch",
                                 shape="plan") as pcost:
            for tn in sorted(indexes):
                try:
                    legs += plan({tn: indexes[tn]}, knn_kmax=knn_kmax, fusion_max=fusion_max)
                except Exception as e:  # warmup must never break serving
                    warnings.warn(f"warmup plan of {tn!r} failed: {e!r}")
                    unplanned.append(tn)
            if unplanned:
                pcost.status = 500
        pcost.dur_s = time.perf_counter() - t0
        if ledger.enabled() and (unplanned or pcost.snapshot_fields()):
            ledger.LEDGER.record(pcost)
        with _lock:
            _state.update(
                state="warming", signatures_total=len(legs) + len(unplanned),
                done=len(unplanned), compiled=0, from_cache=0, failed=len(unplanned),
                seconds=0.0,
            )
        _gauge()
        # context=False: each leg installs its own _system collector; a
        # caller's request context never reaches a warmup leg
        with ContextPool(max(int(threads), 1), thread_name_prefix="geomesa-warmup",
                         context=False) as pool:
            for f in [pool.submit(_run_leg, sig, fn) for sig, fn in legs]:
                f.result()
    finally:
        # whatever raised, the pass is over: the readiness gate never stays shut
        with _lock:
            _state["state"] = "warm"
            _state["seconds"] = round(time.perf_counter() - t0, 3)
        _gauge()
    return progress()


def start(indexes: dict, threads: "int | None" = None,
          knn_kmax: "int | None" = None,
          fusion_max: "int | None" = None) -> threading.Thread:
    """Run :func:`run` on a daemon thread. The ``warming`` state is set
    before this returns, so a ``/readyz`` probe racing the thread's start
    still sees the gate closed: no ready-but-cold window."""
    from geomesa_tpu_torch.spawn import spawn_thread

    with _lock:
        _state["state"] = "warming"
    t = spawn_thread(
        run, name="geomesa-warmup", args=(indexes,),
        kwargs=dict(threads=threads, knn_kmax=knn_kmax, fusion_max=fusion_max),
        context=False,  # the warmup charges _system, never the caller's request
    )
    t.start()
    return t
