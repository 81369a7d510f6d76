"""Admission control + micro-batch fusion for the device serving path.

Counterpart of ``geomesa_tpu/sched/scheduler.py``, ported line for line in
behaviour. Architecture (the tablet-server scan-executor pool, re-shaped
for an accelerator):

- **Admission controller.** Requests enter a bounded queue; when it is
  full they are rejected at once (a server maps this to HTTP 429 +
  ``Retry-After``) instead of piling up one thread per request. A fixed
  pool of ``max_inflight`` workers is the device concurrency cap.

- **Micro-batcher.** When a worker dequeues a fusable request (a resident
  loose count/features query) it drains every queued compatible request
  and holds a short fusion window for late arrivals, then answers the
  whole group in ONE stacked launch (``DeviceIndex.fused_loose_*``: the
  queries' bounds stack along a leading query axis and one pass of the
  batched dim-scan or interleaved-scan kernel answers all of them): K
  compatible queries cost one pass over the key planes, not K.

- **Priority lanes + tenant fairness.** Lanes run ingest, then
  interactive, then batch; within a lane, tenants are drained round-robin
  so one noisy client cannot starve the rest. Fusion groups may span
  tenants: a shared launch makes everyone in it faster.

- **Deadlines.** Every request carries an absolute deadline; requests
  that expire while queued complete with :class:`DeadlineExpired` (never
  executed), and submitters stop waiting at their deadline. A request
  already executing runs to completion: launches are not cancellable.

- **Failure domains (resilience.py).** Every claimed group is tracked in
  flight; a watchdog thread fails device groups stuck past
  ``resilience.launch.timeout.s`` with :class:`LaunchStuckError` (a
  device-breaker failure) and REPLACES the wedged worker. A worker-level
  crash (``fail.sched.worker``) fails its group's unfinished requests
  typed and the worker keeps serving. Completion is idempotent: every
  request gets EXACTLY one response.

- **Adaptive Retry-After.** Rejections carry a Retry-After derived from
  the live queue depth and an EWMA of per-request service time (depth x
  service / workers), jittered 0.75-1.25x so a synchronized client fleet
  de-correlates; the static ``sched.retry.after.s`` is the no-data
  fallback.

Observability: queue depth, wait time, launches, fusion factor (queries /
launches), rejections and expirations, in :mod:`geomesa_tpu_torch.metrics`
and :meth:`QueryScheduler.snapshot`; the snapshot also counts the fusion
fallbacks (groups the fused path did not answer, run serially), which the
reference swallows without a trace.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

from geomesa_tpu_torch.spawn import spawn_thread

_retry_rng = random.Random()  # Retry-After jitter (de-correlates clients)

LANE_INTERACTIVE = "interactive"
LANE_BATCH = "batch"
#: streaming appends: highest priority BY DESIGN — an append is a
#: sub-millisecond host-side unit (WAL write + memtable insert; its
#: own 429 bound is the wal.max.generations backpressure), and queueing
#: acks behind multi-second device scans would put a flush back on the
#: ack path. Admission/deadline/fairness apply like any lane.
LANE_INGEST = "ingest"
_LANES = (LANE_INGEST, LANE_INTERACTIVE, LANE_BATCH)


class RejectedError(RuntimeError):
    """Admission queue full: shed the request now (HTTP 429)."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"scheduler queue full; retry after {retry_after_s:g}s"
        )
        self.retry_after_s = retry_after_s


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it could execute."""


@dataclass
class SchedConfig:
    """Tuning knobs for :class:`QueryScheduler`.

    ``max_queue`` bounds admitted-but-waiting requests (the backpressure
    point); ``max_inflight`` is the worker count (device concurrency
    cap); ``fusion_window_ms`` is how long a worker holds a fusable
    request for compatible late arrivals (0 fuses only already-queued
    requests); ``max_fusion`` caps queries per device launch;
    ``default_deadline_ms`` applies when a request carries none (None =
    unbounded); ``retry_after_s`` rides the 429 Retry-After header."""

    max_queue: int = 128
    max_inflight: int = 2
    fusion_window_ms: float = 2.0
    max_fusion: int = 64
    default_deadline_ms: "float | None" = 30_000.0
    retry_after_s: float = 1.0

    @staticmethod
    def from_props() -> "SchedConfig":
        """Defaults from the ``sched.*`` system properties (conf.py key
        registry) -- what ``QueryScheduler()`` with no explicit config
        uses, so a deployment can tune admission/fusion via environment
        (``GEOMESA_TPU_SCHED_MAX_QUEUE=...``) without code changes. A
        non-positive ``sched.default.deadline.ms`` means no deadline.

        ``max_fusion`` snaps UP onto the capacity ladder
        (:mod:`geomesa_tpu_torch.bucketing`), as in the counterpart, where
        the fusion width becomes a jit batch capacity; the fused paths pad
        a group onto the same ladder."""
        from geomesa_tpu_torch.bucketing import bucket_cap
        from geomesa_tpu_torch.conf import sys_prop

        deadline = float(sys_prop("sched.default.deadline.ms"))
        return SchedConfig(
            max_queue=int(sys_prop("sched.max.queue")),
            max_inflight=int(sys_prop("sched.max.inflight")),
            fusion_window_ms=float(sys_prop("sched.fusion.window.ms")),
            max_fusion=bucket_cap(int(sys_prop("sched.max.fusion"))),
            default_deadline_ms=deadline if deadline > 0 else None,
            retry_after_s=float(sys_prop("sched.retry.after.s")),
        )


_USE_DEFAULT = object()  # submit(): "no deadline_ms given, apply config"


class _Request:
    __slots__ = (
        "fn", "fuse", "lane", "tenant", "deadline", "enqueued",
        "event", "result", "error", "state", "ctx", "t0_perf",
        "degraded", "device", "cost", "t_done",
    )

    def __init__(self, fn, fuse, lane, tenant, deadline, device=False):
        from geomesa_tpu_torch import ledger, resilience, tracing

        self.fn = fn
        self.fuse = fuse
        self.device = device
        self.lane = lane
        self.tenant = tenant
        self.deadline = deadline
        self.enqueued = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.state = "queued"  # -> running -> done
        # the submitter's span, captured EXPLICITLY: the worker that
        # executes this request attaches it so plan/launch/store spans
        # land in the submitting request's trace, and the queue-wait +
        # execute spans fan out to every rider of a fused launch
        self.ctx = tracing.capture()
        # the submitter's degradation collector rides the same way, so
        # a degraded note from work on a scheduler thread lands in the
        # submitting request's X-Degraded header / audit event
        self.degraded = resilience.capture_degraded()
        # ...and so does the cost ledger: device seconds burned on a
        # worker thread are charged to the request that asked for them
        self.cost = ledger.capture_cost()
        self.t0_perf = time.perf_counter()
        self.t_done = None  # perf_counter when _finish completed it


class QueryScheduler:
    """Bounded-queue device query scheduler (see module docstring).

    >>> sched = QueryScheduler(SchedConfig(max_inflight=1))
    >>> sched.run(fn=lambda: 42)
    42
    >>> sched.run(fuse=FusableQuery(di, cql, "count", loose=True))
    """

    def __init__(self, config: "SchedConfig | None" = None):
        self.config = config or SchedConfig.from_props()
        self._cv = threading.Condition()
        # lane -> tenant -> deque of queued requests (RR over tenants)
        self._queues: dict = {lane: OrderedDict() for lane in _LANES}
        self._queued = 0
        self._running = 0  # claimed but not yet finished (close() drains)
        self._stop = False
        # counters for snapshot(); the process-global metrics mirror them
        self.queries = 0
        self.launches = 0
        self.fused_queries = 0
        # groups of two or more fusable requests that the fused path did
        # not answer (it raised, or the index declined) and that ran
        # serially; their sched.execute spans carry fallback=<why>
        self.fusion_fallbacks = 0
        self.rejected = 0
        self.expired = 0
        self.worker_failures = 0  # crashes survived (group failed typed)
        self.watchdog_timeouts = 0  # stuck launches failed + replaced
        self._wait_sum = 0.0
        self._svc_ewma = None  # EWMA per-request service seconds
        self._launch_seq = 0  # device-launch ids for trace tagging
        # in-flight groups for the launch watchdog: token ->
        # [group, started_monotonic, abandoned]; abandoned entries were
        # failed by the watchdog — their (wedged) worker must neither
        # finish the requests again nor retire the running count twice
        self._inflight: dict = {}
        self._inflight_seq = 0
        # service threads: the worker loop attaches each rider's captured
        # context per launch itself (see _execute) — inheriting the
        # CONSTRUCTING thread's context would pin it forever
        self._workers = [
            spawn_thread(
                self._worker, name=f"sched-worker-{i}", context=False
            )
            for i in range(max(1, self.config.max_inflight))
        ]
        for w in self._workers:
            w.start()
        self._watchdog = spawn_thread(
            self._watchdog_loop, name="sched-watchdog", context=False
        )
        self._watchdog.start()

    # -- submission --------------------------------------------------------

    def submit(
        self,
        fn=None,
        fuse=None,
        lane: str = LANE_INTERACTIVE,
        tenant: str = "",
        deadline_ms=_USE_DEFAULT,
        device=None,
    ) -> _Request:
        """Admit one request (non-blocking). ``fn`` is the zero-arg
        serial execution; ``fuse`` an optional FusableQuery the
        micro-batcher may fold into a shared launch (``fn`` defaults to
        its serial form). ``deadline_ms`` unset applies the config
        default; an explicit None means no deadline (bulk producers).
        ``device`` marks the work a device launch — the stuck-launch
        watchdog only arms for device groups (a long host/store scan is
        slow, not stuck, and must not charge the device breaker); unset,
        it is inferred from ``fuse`` (fused queries are launches by
        construction). Raises :class:`RejectedError` when the queue is
        full. Wait for the result with :meth:`wait`."""
        if device is None:
            device = fuse is not None
        if fuse is not None and not fuse.fusable:
            if fn is None:
                fn = fuse.run_serial
            fuse = None
        if fn is None:
            if fuse is None:
                raise ValueError("submit needs fn or fuse")
            fn = fuse.run_serial
        if lane not in _LANES:
            raise ValueError(f"unknown lane {lane!r}")
        if deadline_ms is _USE_DEFAULT:
            deadline_ms = self.config.default_deadline_ms
        deadline = (
            time.monotonic() + deadline_ms / 1e3
            if deadline_ms is not None
            else None
        )
        req = _Request(
            fn, fuse, lane, str(tenant or ""), deadline, device=bool(device)
        )
        from geomesa_tpu_torch import metrics

        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is shut down")
            if self._queued >= self.config.max_queue:
                self.rejected += 1
                metrics.sched_rejected.inc()
                raise RejectedError(self._retry_after_locked())
            self._queues[req.lane].setdefault(
                req.tenant, deque()
            ).append(req)
            self._queued += 1
            metrics.sched_queue_depth.set(self._queued)
            # notify_all: a single notify can land on a worker holding a
            # fusion window (which re-waits on this cv) while an idle
            # worker sleeps its poll out — a needless latency spike
            self._cv.notify_all()
        return req

    def wait(self, req: _Request):
        """Block until ``req`` completes; raises its error (including
        :class:`DeadlineExpired` when it expired waiting). A request
        already executing at its deadline runs to completion — device
        launches are not cancellable mid-flight."""
        if req.deadline is not None and not req.event.wait(
            timeout=max(req.deadline - time.monotonic(), 0.0)
        ):
            with self._cv:
                if req.state == "queued":  # expired without being claimed
                    from geomesa_tpu_torch import metrics

                    req.state = "done"
                    req.error = DeadlineExpired(
                        "request expired in the scheduler queue"
                    )
                    self._queued -= 1
                    metrics.sched_queue_depth.set(self._queued)
                    self.expired += 1
                    self._observe_expired()
                    req.event.set()
                    self._cv.notify_all()  # close() waits on drain
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def run(
        self,
        fn=None,
        fuse=None,
        lane: str = LANE_INTERACTIVE,
        tenant: str = "",
        deadline_ms=_USE_DEFAULT,
        device=None,
    ):
        """submit() + wait() in one call — the serving entry point."""
        return self.wait(
            self.submit(
                fn=fn, fuse=fuse, lane=lane, tenant=tenant,
                deadline_ms=deadline_ms, device=device,
            )
        )

    def _retry_after_locked(self) -> float:
        """Retry-After for a 429, from ACTUAL queue pressure: estimated
        drain time of the current queue (depth x EWMA service time /
        workers), jittered 0.75-1.25x so synchronized clients that all
        got shed together do not all come back together. Falls back to
        the static ``sched.retry.after.s`` before any request has been
        measured; clamped to [0.05s, 30s]."""
        base = self.config.retry_after_s
        svc = self._svc_ewma
        if svc is not None and svc > 0:
            est = self._queued * svc / max(self.config.max_inflight, 1)
            est = max(est, base * 0.25)  # never promise a near-0 comeback
        else:
            est = base
        est *= 0.75 + 0.5 * _retry_rng.random()
        return min(max(est, 0.05), 30.0)

    def queue_pressure(self) -> "tuple[int, int]":
        """(queued, max_queue) — what the brownout ladder consults."""
        with self._cv:
            return (self._queued, self.config.max_queue)

    # -- queue internals (call under self._cv) -----------------------------

    def _pop_locked(self) -> "_Request | None":
        """Next request: interactive lane first, round-robin across
        tenants within a lane. Claims the request (state -> running)."""
        from geomesa_tpu_torch import metrics

        for lane in _LANES:
            tenants = self._queues[lane]
            for tenant in list(tenants):
                dq = tenants[tenant]
                req = None
                while dq:
                    r = dq.popleft()
                    if r.state == "queued":
                        req = r
                        break
                    # cancelled while queued: already accounted for
                if dq:
                    tenants.move_to_end(tenant)  # fairness rotation
                else:
                    del tenants[tenant]
                if req is not None:
                    req.state = "running"
                    self._queued -= 1
                    self._running += 1
                    metrics.sched_queue_depth.set(self._queued)
                    return req
        return None

    def _drain_locked(self, key, limit: int) -> "list[_Request]":
        """Claim up to ``limit`` queued requests whose fuse key matches
        (any lane, any tenant — a shared launch helps everyone in it)."""
        from geomesa_tpu_torch import metrics

        got: list = []
        if limit <= 0:
            return got
        for lane in _LANES:
            tenants = self._queues[lane]
            for tenant in list(tenants):
                dq = tenants[tenant]
                keep: deque = deque()
                while dq:
                    r = dq.popleft()
                    if (
                        len(got) < limit
                        and r.state == "queued"
                        and r.fuse is not None
                        and r.fuse.key == key
                    ):
                        r.state = "running"
                        got.append(r)
                    elif r.state == "queued":
                        keep.append(r)
                if keep:
                    tenants[tenant] = keep
                else:
                    del tenants[tenant]
        if got:
            self._queued -= len(got)
            self._running += len(got)
            metrics.sched_queue_depth.set(self._queued)
        return got

    # -- execution ---------------------------------------------------------

    def _worker(self) -> None:
        cfg = self.config
        while True:
            with self._cv:
                req = self._pop_locked()
                while req is None and not self._stop:
                    self._cv.wait(timeout=0.25)
                    req = self._pop_locked()
                if req is None:
                    return  # shut down
                group = [req]
                if req.fuse is not None:
                    group += self._drain_locked(
                        req.fuse.key, cfg.max_fusion - len(group)
                    )
            if (
                req.fuse is not None
                and cfg.fusion_window_ms > 0
                and len(group) < cfg.max_fusion
            ):
                # hold the fusion window for compatible late arrivals
                stop_at = time.monotonic() + cfg.fusion_window_ms / 1e3
                while len(group) < cfg.max_fusion:
                    rem = stop_at - time.monotonic()
                    if rem <= 0:
                        break
                    with self._cv:
                        more = self._drain_locked(
                            req.fuse.key, cfg.max_fusion - len(group)
                        )
                        if not more:
                            self._cv.wait(timeout=rem)
                            more = self._drain_locked(
                                req.fuse.key, cfg.max_fusion - len(group)
                            )
                        group += more
            token = self._track_start(group)
            try:
                from geomesa_tpu_torch.failpoints import fail_point

                fail_point("fail.sched.worker")
                self._execute(group)
            except Exception as e:
                # worker-level crash (a bug outside the per-request
                # try, or the fail.sched.worker injection): the group
                # must neither hang nor vanish — fail every unfinished
                # request typed, count it, and KEEP this worker serving
                from geomesa_tpu_torch import metrics

                with self._cv:
                    self.worker_failures += 1
                metrics.sched_worker_failures.inc()
                for r in group:
                    self._finish(r, error=e)
            finally:
                # the whole group was claimed (queued -> running) above;
                # retire it and wake close(), which drains on this count
                # — unless the watchdog already abandoned this worker
                # (it retired the count and failed the requests); then
                # a replacement is serving and this thread exits
                if self._track_end(token, group):
                    return

    def _track_start(self, group) -> int:
        with self._cv:
            self._inflight_seq += 1
            token = self._inflight_seq
            # [group, last-progress time, done-rider count]: the
            # watchdog restarts the stall clock whenever another rider
            # completes, so it measures the CURRENT launch's stall, not
            # the group's cumulative wall-clock (a serially executed
            # fusion-declined group is slow, not stuck)
            self._inflight[token] = [group, time.monotonic(), 0]
        return token

    def _track_end(self, token: int, group) -> bool:
        """Retire a tracked group; True when the watchdog abandoned it
        — it popped the entry when it failed the group, so a missing
        entry tells the wedged thread to exit instead of
        double-retiring."""
        with self._cv:
            entry = self._inflight.pop(token, None)
            abandoned = entry is None
            if not abandoned:
                self._running -= len(group)
            self._cv.notify_all()
        return abandoned

    def _launch_timeout_s(self) -> float:
        from geomesa_tpu_torch import resilience
        from geomesa_tpu_torch.conf import sys_prop

        if not resilience.enabled():
            return 0.0
        return float(sys_prop("resilience.launch.timeout.s"))

    def _watchdog_loop(self) -> None:
        """Fail DEVICE groups whose CURRENT launch is stuck past the
        launch-timeout budget and replace their (wedged, uncancellable)
        workers, so a hung device launch costs one abandoned thread
        instead of a scheduler lane. The stall clock restarts whenever
        a rider of the group completes — a fusion-declined group run
        serially makes progress launch by launch and is slow, not
        stuck. Host/store groups are exempt: a legitimately long scan
        (a large export) would be falsely failed by any launch-scale
        timeout and would charge the DEVICE breaker for work that never
        touched the device — a genuinely wedged host scan instead costs
        its worker, the pre-watchdog status quo. Runs until shutdown."""
        from geomesa_tpu_torch import metrics, resilience

        while True:
            stuck: list = []
            with self._cv:
                if self._stop:
                    return
                timeout = self._launch_timeout_s()
                if timeout > 0:
                    now = time.monotonic()
                    for token, entry in list(self._inflight.items()):
                        group, started, done0 = entry
                        done = sum(
                            1 for r in group if r.state == "done"
                        )
                        if done != done0:  # progress: restart the clock
                            entry[2] = done
                            entry[1] = started = now
                        if (
                            now - started > timeout
                            and any(r.device for r in group)
                        ):
                            # pop NOW: the wedged worker may never
                            # return to retire the entry via _track_end,
                            # and a leaked entry would pin the group's
                            # closures/results for the process lifetime
                            del self._inflight[token]
                            self._running -= len(group)
                            self.watchdog_timeouts += 1
                            stuck.append(group)
                    if stuck:
                        self._cv.notify_all()  # close() drains on running
                self._cv.wait(timeout=0.25)
            for group in stuck:
                metrics.resilience_watchdog_timeouts.inc()
                resilience.device_breaker().record_failure()
                for r in group:
                    self._finish(r, error=resilience.LaunchStuckError(
                        "device launch exceeded "
                        f"resilience.launch.timeout.s ({timeout:g}s); "
                        "worker abandoned and replaced"
                    ))
            if stuck:
                replacements = [
                    spawn_thread(
                        self._worker, name="sched-worker-replacement",
                        context=False,
                    )
                    for _ in stuck
                ]
                with self._cv:
                    # prune dead threads while adding replacements: the
                    # list must not grow without bound over a long-lived
                    # server's lifetime of watchdog interventions
                    self._workers = [
                        w for w in self._workers if w.is_alive()
                    ] + replacements
                for w in replacements:
                    w.start()

    def _observe_service_locked(self, dur_s: float, n: int) -> None:
        """Fold one execution's per-request service time into the EWMA
        the adaptive Retry-After estimate drains the queue with."""
        if n <= 0 or dur_s < 0:
            return
        per = dur_s / n
        self._svc_ewma = (
            per
            if self._svc_ewma is None
            else 0.8 * self._svc_ewma + 0.2 * per
        )

    def _execute(self, group: "list[_Request]") -> None:
        from geomesa_tpu_torch import ledger, metrics, resilience, tracing
        from geomesa_tpu_torch.sched.fusion import execute_group

        now = time.monotonic()
        now_perf = time.perf_counter()
        live: list = []
        dead: list = []
        with self._cv:  # counters race sibling workers otherwise
            for r in group:
                if r.deadline is not None and now > r.deadline:
                    self.expired += 1
                    dead.append(r)
                else:
                    self._wait_sum += now - r.enqueued
                    live.append(r)
        for r in dead:
            self._observe_expired()
            self._finish(r, error=DeadlineExpired(
                "request expired before execution"
            ))
        for r in live:
            metrics.sched_wait_seconds.observe(now - r.enqueued)
            # queue wait (admission -> claimed, incl. the fusion window),
            # timed here and attached retroactively to the rider's trace
            tracing.record_span(
                r.ctx, "sched.wait", r.t0_perf, now_perf - r.t0_perf,
                lane=r.lane, tenant=r.tenant,
            )
        if not live:
            return
        fused = None
        fallback = None
        if len(live) > 1 and live[0].fuse is not None:
            fallback = "declined"
            try:
                # detail spans from inside the shared launch can only
                # belong to one trace: the head rider's. Every rider
                # still gets the flat sched.execute span below, tagged
                # with the shared launch id.
                with tracing.attach(live[0].ctx), \
                        resilience.attach_degraded(live[0].degraded), \
                        ledger.attach_cost(live[0].cost):
                    fused = execute_group([r.fuse for r in live])
            except Exception:  # fusion is an optimization: serial classifies per request
                fused = None  # any fusion failure: serial is always exact
                fallback = "raised"
        with self._cv:
            if fused is None and fallback is not None:
                self.fusion_fallbacks += 1
            if fused is not None:
                self._launch_seq += 1
                launch_id = self._launch_seq
                self.launches += 1
                self.queries += len(live)
                self.fused_queries += len(live)
            else:
                self.launches += len(live)
                self.queries += len(live)
        if fused is not None:
            metrics.sched_launches.inc()
            metrics.sched_queries.inc(len(live))
            metrics.sched_fused.inc(len(live))
            dur = time.perf_counter() - now_perf
            with self._cv:
                self._observe_service_locked(dur, len(live))
            shards = live[0].fuse.mesh_shards
            for r, v in zip(live, fused):
                tracing.record_span(
                    r.ctx, "sched.execute", now_perf, dur,
                    launch=launch_id, fused=len(live), lane=r.lane,
                    shards=shards,
                )
                if r.cost is not None:
                    # fair-share cost split: summing the ledger over
                    # the riders reproduces the launch's actual device
                    # time instead of multiplying it by the width
                    r.cost.charge("device_launches", 1)
                    r.cost.charge("device_seconds", dur / len(live))
                    r.cost.charge("fusion_width", len(live))
                self._finish(r, result=v)
            return
        metrics.sched_launches.inc(len(live))
        metrics.sched_queries.inc(len(live))
        for r in live:
            with self._cv:
                self._launch_seq += 1
                launch_id = self._launch_seq
            t_run = time.perf_counter()
            try:
                # attach the rider's context so the work's own spans
                # (plan / device.launch / store reads) nest in its
                # trace, its degradation collector so degraded notes
                # reach its response/audit stamping, and its cost
                # collector so device time is charged to it
                with tracing.attach(r.ctx), \
                        resilience.attach_degraded(r.degraded), \
                        ledger.attach_cost(r.cost), \
                        tracing.span(
                            "sched.execute", launch=launch_id, fused=1,
                            lane=r.lane,
                            **({"fallback": fallback} if fallback else {}),
                        ):
                    res = r.fn()
            except Exception as e:  # the submitter re-raises it
                dur_run = time.perf_counter() - t_run
                self._charge_serial(r, dur_run)
                with self._cv:
                    self._observe_service_locked(dur_run, 1)
                self._finish(r, error=e)
                continue
            dur_run = time.perf_counter() - t_run
            self._charge_serial(r, dur_run)
            with self._cv:
                self._observe_service_locked(dur_run, 1)
            self._finish(r, result=res)

    @staticmethod
    def _charge_serial(r: _Request, dur_s: float) -> None:
        """Ledger one serially-executed request: device work charges a
        launch; host/store work (device=False) charges nothing here —
        its read/decode/stage time is charged at the store layer."""
        if r.cost is None or not r.device:
            return
        r.cost.charge("device_launches", 1)
        r.cost.charge("device_seconds", dur_s)
        r.cost.charge("fusion_width", 1)

    def _finish(self, req: _Request, result=None, error=None) -> None:
        """Complete a request EXACTLY ONCE: between normal execution,
        the worker crash handler, the watchdog and queue-expiry, the
        first completion wins and every later one is a no-op — a
        submitter can never observe two results (or a result mutating
        under it after the event fired)."""
        with self._cv:
            if req.state == "done":
                return
            req.result = result
            req.error = error
            req.state = "done"
            req.t_done = time.perf_counter()
        req.event.set()

    def _observe_expired(self) -> None:
        from geomesa_tpu_torch import metrics

        metrics.sched_expired.inc()

    # -- observability / lifecycle -----------------------------------------

    def snapshot(self) -> dict:
        """The ``/stats/sched`` document: queue pressure, execution
        counters and the fusion factor (queries per device launch)."""
        with self._cv:
            queries, launches = self.queries, self.launches
            return {
                "queue_depth": self._queued,
                "running": self._running,
                "max_queue": self.config.max_queue,
                "inflight_cap": self.config.max_inflight,
                "fusion_window_ms": self.config.fusion_window_ms,
                "max_fusion": self.config.max_fusion,
                "queries": queries,
                "launches": launches,
                "fused_queries": self.fused_queries,
                "fusion_fallbacks": self.fusion_fallbacks,
                "fusion_factor": (
                    round(queries / launches, 3) if launches else None
                ),
                "rejected": self.rejected,
                "expired": self.expired,
                "worker_failures": self.worker_failures,
                "watchdog_timeouts": self.watchdog_timeouts,
                "retry_after_estimate_s": round(
                    self._retry_after_locked(), 4
                ),
                "avg_wait_ms": (
                    round(self._wait_sum / queries * 1e3, 3)
                    if queries
                    else None
                ),
            }

    def close(self, timeout: float = 5.0) -> None:
        """Drain-then-stop: wait (bounded, monotonic) for every queued
        AND in-flight request to finish, then stop and JOIN the workers.
        The graceful sibling of :meth:`shutdown` -- a CLI or test
        process must not exit mid-device-launch with work half-executed;
        ``make_server``'s shutdown calls this. Idempotent; requests
        still unfinished at the timeout are failed by the shutdown."""
        deadline = time.monotonic() + timeout
        drained = False
        with self._cv:
            while (self._queued or self._running) and not self._stop:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cv.wait(timeout=min(rem, 0.25))
            drained = not (self._queued or self._running)
        if drained:
            from geomesa_tpu_torch import metrics

            metrics.sched_drains.inc()
        self.shutdown(timeout=max(deadline - time.monotonic(), 0.1))

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the workers; queued requests complete with errors."""
        with self._cv:
            self._stop = True
            pending: list = []
            for lane in _LANES:
                for dq in self._queues[lane].values():
                    pending += [r for r in dq if r.state == "queued"]
                self._queues[lane].clear()
            self._queued = 0
            self._cv.notify_all()
        for r in pending:
            self._finish(
                r, error=RuntimeError("scheduler shut down")
            )
        # one SHARED deadline for all joins: a watchdog-abandoned
        # (wedged) worker never exits, and paying the full timeout per
        # wedged thread would stretch shutdown by N x timeout
        join_deadline = time.monotonic() + timeout
        with self._cv:
            workers = list(self._workers)
        for w in workers:
            w.join(timeout=max(join_deadline - time.monotonic(), 0.0))
        self._watchdog.join(
            timeout=max(join_deadline - time.monotonic(), 0.1)
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
