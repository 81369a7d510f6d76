"""Runtime system properties the port reads.

Counterpart of ``geomesa_tpu/conf.py``, trimmed to the keys of the device
query scheduler (``sched.*``), the launch watchdog and circuit breaker
(``resilience.*``), the loose-bbox default of the resident index
(``query.loose.bbox``), the store planner's range budget, feature cap,
full-table guard and wall-clock budget (``scan.ranges.target``,
``query.max.features``, ``query.block.full.table``, ``query.timeout``,
with :class:`QueryTimeout`), the file-system store's durability and
chunk-format keys (``store.*``, reference lines 14-66 and 410-449), its
host-I/O pipeline (``io.*``) and snapshot-pin lifetime
(``snapshot.pin.ttl.s``), the streaming live layer's keys (``wal.*`` and
``stream.*``, reference lines 514-525), the serving
retries, degrade switch and brownout fraction (``resilience.*``), the
spatial join engine's
keys (``join.*``, reference lines 201-241, 351-385 and 526-541) and the
BIN encoder's engine (``results.bin.engine``) and the server's keys
(``trace.*`` with ``trace.device.dir``, ``slo.*``, ``ledger.*``,
``admin.token``, ``http.keepalive.s``, ``mesh.*``, reference lines
433-566), the push tier's (``sub.*``, lines 566-574) and the resident
warmup's (``compile.warmup.*``, lines 120-133, 392 and 483-486). The
reference's ``compile.bucket.*`` keys are left out: the port's
``bucketing.py`` keeps the fixed power-of-two ladder, which is what those
keys give under their defaults, so the warmup's kNN and fusion ladders are
the reference's. Each key has a
default, an environment override (``GEOMESA_TPU_<NAME>`` with dots as
underscores) and a programmatic override for tests (``set_prop`` /
``clear_prop`` or the ``prop_override`` context manager); the override wins
over the environment, the environment over the default.
"""

from __future__ import annotations

import os
from contextlib import contextmanager


def _parse_bool(v) -> bool:
    return str(v).strip().lower() in ("true", "1", "t", "yes", "on")


def _parse_verify(v) -> str:
    s = str(v).strip().lower()
    if s not in ("off", "open", "always"):
        raise ValueError(f"store.verify must be off, open or always, not {v!r}")
    return s


def _parse_format(v) -> int:
    n = int(v)
    if n not in (1, 2):
        raise ValueError(f"store.format.version must be 1 or 2, not {v!r}")
    return n


def _parse_choice(key: str, choices: tuple):
    """A parser that accepts one of ``choices`` (case and spaces aside)."""

    def parse(v) -> str:
        s = str(v).strip().lower()
        if s not in choices:
            raise ValueError(f"{key} must be {', '.join(choices[:-1])} or {choices[-1]}, not {v!r}")
        return s

    return parse


# name -> (default, parser)
_DEFS = {
    # device query scheduler (sched/scheduler.py): admission bound, worker
    # count, fusion window and width, default deadline, the static
    # Retry-After fallback
    "sched.max.queue": (128, int),
    "sched.max.inflight": (2, int),
    "sched.fusion.window.ms": (2.0, float),
    "sched.max.fusion": (64, int),
    "sched.default.deadline.ms": (30_000.0, float),
    "sched.retry.after.s": (1.0, float),
    # fault-tolerant serving (resilience.py): the master switch, degraded
    # answers, the retries of retryable faults with their doubling backoff
    # and its cumulative cap, the breaker's failure threshold and
    # cooldown, the launch watchdog budget, and the scheduler-queue fill
    # fraction past which the live layer's compactor yields
    "resilience.enabled": (True, _parse_bool),
    "resilience.degrade": (True, _parse_bool),
    "resilience.retries": (2, int),
    "resilience.backoff.ms": (25.0, float),
    "resilience.backoff.cap.ms": (2000.0, float),
    "resilience.breaker.failures": (5, int),
    "resilience.breaker.cooldown.s": (5.0, float),
    "resilience.launch.timeout.s": (30.0, float),
    "resilience.brownout.queue.frac": (0.8, float),
    # the store planner (query/plan.py, query/interceptor.py): max z-ranges
    # per query plan (ref geomesa.scan.ranges.target), a global cap on
    # returned features (0 = off), raise instead of a full-table scan
    "scan.ranges.target": (2000, int),
    "query.max.features": (0, int),
    "query.block.full.table": (False, _parse_bool),
    "query.timeout": (0, int),  # ms a query may take; 0 = unlimited
    # host-I/O prefetch pipeline (store/prefetch.py): decode threads (0 =
    # serial), items in flight (0 = 2 x workers), the decoded queue's byte
    # budget (0 = off), and the transient-read retries with their doubling
    # backoff and its cumulative cap
    "io.workers": (4, int),
    "io.readahead": (0, int),
    "io.queue.bytes": (256 << 20, int),
    "io.retries": (2, int),
    "io.backoff.ms": (25.0, float),
    "io.backoff.cap.ms": (1000.0, float),
    # the file-system store (store/fs.py): checksum verification (off,
    # open: every file at open, always: every read), fsync of what a flush
    # publishes, the manifest format a flush writes (2: chunks with
    # statistics), rows per chunk, the chunks' coarse density grid and the
    # aggregation pushdown
    "store.verify": ("off", _parse_verify),
    "store.fsync": (True, _parse_bool),
    "store.format.version": (2, _parse_format),
    "store.chunk.rows": (1 << 16, int),
    "store.chunk.grid": (64, int),
    "store.chunk.pushdown": (True, _parse_bool),
    # how long an untouched snapshot pin keeps its generation from the
    # file-system store's garbage collection
    "snapshot.pin.ttl.s": (300.0, float),
    # answer bbox(+during) queries straight from the index key at cell
    # granularity when a call passes loose=None (ref geomesa.loose.bbox)
    "query.loose.bbox": (False, _parse_bool),
    # the streaming live layer (store/stream.py, store/wal.py): WAL
    # segment rotation, the read-amplification bound (appends shed past
    # it), the memtable rows that trigger compaction (a resident streaming
    # index takes them as headroom in its capacity hint), rows per
    # Z-sorted run, and the compactor's yield step and stall bound
    "wal.segment.bytes": (4 << 20, int),
    "wal.max.generations": (8, int),
    "stream.memtable.rows": (1 << 15, int),
    "stream.run.rows": (8192, int),
    "stream.compact.yield.ms": (50.0, float),
    "stream.stall.s": (30.0, float),
    # the spatial join engine (join/): the refinement engine (auto: the
    # device's for an index on the card, the numpy twin for one on the
    # CPU), the planner's strategy, the broadcast threshold, the skew-split
    # bound, the candidates of one refinement batch, the statistics grid's
    # bits and the xz ranges per window of a non-point left side
    "join.engine": ("auto", _parse_choice("join.engine", ("auto", "device", "host"))),
    "join.strategy": ("auto", _parse_choice(
        "join.strategy", ("auto", "broadcast", "grouped", "zmerge"))),
    "join.broadcast.windows": (64, int),
    "join.split.rows": (1 << 16, int),
    "join.batch.candidates": (1 << 20, int),
    "join.hist.bits": (8, int),
    "join.xz.ranges": (32, int),
    # the server (server.py): request tracing's head-sampling probability
    # and slow-capture threshold (tracing.py), the SLOs per lane with the
    # fast burn window and the flight recorder's trigger, retention and
    # rate limit (slo.py), the cost ledger's switch and top-K (ledger.py),
    # the operator plane's shared secret, the idle keep-alive bound, the
    # live layer's switch and append body bound, and the mesh switch
    "trace.sample": (1.0, float),
    "trace.slow_ms": (500.0, float),
    # a directory: each sampled request's store-run launch is also
    # recorded by torch.profiler into a Chrome trace there
    # (profiling.device_trace); "" = off
    "trace.device.dir": ("", str),
    "slo.enabled": (True, _parse_bool),
    "slo.interactive.objective": (0.999, float),
    "slo.interactive.threshold.ms": (500.0, float),
    "slo.interactive.window.s": (3600.0, float),
    "slo.batch.objective": (0.99, float),
    "slo.batch.threshold.ms": (5000.0, float),
    "slo.batch.window.s": (3600.0, float),
    "slo.ingest.objective": (0.999, float),
    "slo.ingest.threshold.ms": (100.0, float),
    "slo.ingest.window.s": (3600.0, float),
    "slo.burn.fast.s": (300.0, float),
    "slo.flightrec.burn": (8.0, float),
    "slo.flightrec.keep": (8, int),
    "slo.flightrec.interval.s": (60.0, float),
    "ledger.enabled": (True, _parse_bool),
    "ledger.topk": (10, int),
    "admin.token": ("", str),
    "http.keepalive.s": (60.0, float),
    "stream.enabled": (False, _parse_bool),
    "stream.append.max.bytes": (32 << 20, int),
    "mesh.enabled": (False, _parse_bool),
    "mesh.devices": (0, int),
    # the BIN track-record encoder (results/binrider.py): auto (the device
    # pack for an index on the card, the numpy twin for one on the CPU),
    # device or host
    "results.bin.engine": ("auto", _parse_choice(
        "results.bin.engine", ("auto", "device", "host"))),
    # the continuous-query push tier (pubsub/): the SSE heartbeat cadence
    # of an idle push stream, a connection's live event-queue bound (an
    # overflow tears the stream down; the client resumes from its cursor),
    # how long a disconnected subscriber's cursor keeps pinning the WAL,
    # and the registry's bound per type
    "sub.heartbeat.s": (15.0, float),
    "sub.queue.events": (1024, int),
    "sub.retain.s": (600.0, float),
    "sub.max.per.type": (4096, int),
    # the resident warmup (warmup.py): the master switch of the background
    # pass that ``serve --resident --warm`` starts, /readyz while it runs
    # ("ready" holds 503, "stamp" serves but stamps warming, "off" hides
    # it), the legs run at once, and the kNN k-ladder's bound
    "compile.warmup.enabled": (True, _parse_bool),
    "compile.warmup.gate": ("ready", _parse_choice("compile.warmup.gate", ("ready", "stamp", "off"))),
    "compile.warmup.threads": (2, int),
    "compile.warmup.knn.kmax": (64, int),
}

_overrides: dict = {}


def _env_key(name: str) -> str:
    return "GEOMESA_TPU_" + name.upper().replace(".", "_")


def sys_prop(name: str):
    """Resolve a property: programmatic override > environment > default."""
    if name not in _DEFS:
        raise KeyError(f"unknown system property {name!r}")
    default, parse = _DEFS[name]
    if name in _overrides:
        return _overrides[name]
    env = os.environ.get(_env_key(name))
    if env is not None:
        return parse(env)
    return default


def set_prop(name: str, value) -> None:
    if name not in _DEFS:
        raise KeyError(f"unknown system property {name!r}")
    _overrides[name] = _DEFS[name][1](value)


def clear_prop(name: str) -> None:
    _overrides.pop(name, None)


_MISSING = object()


@contextmanager
def prop_override(name: str, value):
    prev = _overrides.get(name, _MISSING)
    set_prop(name, value)
    try:
        yield
    finally:
        if prev is _MISSING:
            clear_prop(name)
        else:
            _overrides[name] = prev


class QueryTimeout(RuntimeError):
    """Raised when a query exceeds the ``query.timeout`` budget."""
