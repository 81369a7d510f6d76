"""HTTP serving bridge: WFS-shaped JSON and BIN endpoints over the port's
stores, resident indexes and device query scheduler.

Counterpart of ``geomesa_tpu/server.py`` (ref role: geomesa-gs-plugin, the
GeoServer packaging that exposes stores over OGC protocols, plus the WPS
process endpoints of geomesa-process): a thin stdlib
``ThreadingHTTPServer`` over any store object, with all planning and scan
work done by the store, the resident index and the scheduler.

Endpoints (GET):

- ``/capabilities``                 -- type names + schemas
- ``/features/<type>?cql=&maxFeatures=&properties=&f=geojson|bin``
- ``/count/<type>?cql=&loose=``     -- hit count
- ``/explain/<type>?cql=``          -- query plan text
- ``/density/<type>?cql=&bbox=&width=&height=`` -- heatmap grid
- ``/stats/<type>?cql=&stats=<Stat-DSL spec>&loose=`` -- aggregation
- ``/knn/<type>?x=&y=&k=&cql=&maxRadius=`` -- k nearest features
- ``/tube/<type>?track=x,y,t;...&buffer=&maxDt=&cql=`` -- corridor search
- ``/proximity/<type>?points=x,y;...&distance=&cql=`` -- features near
  any input point, with distances
- ``/refresh/<type>``               -- restage a resident type
- ``/metrics``                      -- Prometheus (or OpenMetrics) text
- ``/healthz``, ``/readyz``         -- liveness; readiness with breaker
  states, scheduler pressure, degraded domains and burning SLOs (503
  while draining)
- ``/stats``, ``/stats/sched``, ``/stats/store``, ``/stats/mesh``,
  ``/stats/slo``, ``/stats/ledger``, ``/stats/stream``,
  ``/stats/replica``, ``/stats/pubsub``
- ``/debug/traces[/<id>][?format=perfetto]`` -- retained request traces

POST ``/append/<type>`` ingests into the streaming live layer (the WAL is
the ack point; 413 past ``stream.append.max.bytes``, 429 + Retry-After at
``wal.max.generations``), and POST ``/admin/shutdown`` drains the server.

The continuous-query push tier (``pubsub/``, whenever the live layer is
on): POST ``/subscribe/<type>`` registers a standing query (bbox, cql,
dwithin, auths), GET ``/subscribe/<type>?id=&from=&f=`` holds its push
stream open (SSE or BIN; ``from=`` or ``Last-Event-ID`` resumes exactly
once above an acked seq, 410 once the cursor's records compacted away),
DELETE ``/subscribe/<type>?id=`` cancels it, ``/stats/pubsub`` reports
the registry and the connections, and ``GET /wal/_pubsub?from=`` ships
the registry's WAL.

Every query request runs under a root trace (an inbound ``X-Request-Id``
becomes the trace id and is echoed), a degradation collector (reasons go
out in ``X-Degraded``) and a cost collector folded into the ledger and the
SLO engine when the trace finishes. Device-rung work runs behind the
``device`` circuit breaker with retries of transient faults, and falls to
the store path (``device-launch-failed``, ``device-breaker-open``) rather
than failing. Resident mode stages a ``StreamingDeviceIndex`` per type on
first touch behind the ``cache`` breaker, on the store's device: a store
opened with ``device="cpu"`` serves on the host, any other on ``cuda:0``
(``device.resolve_device``).

Where the port differs, each answer named in ROADMAP.md:

- ``f=arrow`` (or an ``Accept`` that picks Arrow) answers 406: the card's
  host has no ``pyarrow`` (ROADMAP section 3). No body goes out under
  Arrow's content type.
- ``replica=`` raises ``NotImplementedError``, and ``/wal/<type>`` of a
  data type and ``/snapshot/<type>`` answer 501 (the replication item);
  ``/stats/replica`` answers ``{"enabled": false}``.
- ``f=arrow`` on the push plane answers 406 as on every other endpoint.
- The mesh switch counts ``torch.cuda.device_count()``: with one card,
  ``mesh=True`` serves single-card, as the counterpart does with one
  device; more than one card raises (``ShardedDeviceIndex``, item 7).
- The counterpart's ``compilecheck`` bracket (its JAX analysis tooling)
  has no counterpart.
- The listen backlog is 128, not the stdlib's 5 that the counterpart
  keeps: under a burst of concurrent clients the short queue drops
  connections, and their SYN retransmits become the latency tail.
  ``tools/serve_backlog_probe.py`` read, on an NVIDIA H100 80GB HBM3 at
  700 W, p99 3,042.8 and 3,058.8 ms at 5 against 256.2 and 427.7 ms at
  128; p50 went from 50.4 and 57.3 ms to 224.7 and 291.1 ms, as the
  connections wait in the queue instead of dropping.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from geomesa_tpu_torch.spawn import spawn_thread


class _NotAcceptable(Exception):
    """A negotiated format the port cannot serve: 406."""


_ARROW_406 = (
    "Arrow IPC responses need pyarrow, which the port does not use "
    "(ROADMAP.md section 3): ask for f=geojson or f=bin"
)
_REPLICA_LATER = "replication, /wal and /snapshot (ROADMAP item 5, the replication tier)"
_MESH_LATER = "mesh serving over more than one card (ROADMAP item 7, ShardedDeviceIndex)"


class _GeomesaHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``shutdown`` is a DRAINING shutdown:
    admission stops first (the ``draining`` event flips query endpoints
    to 503 + Retry-After and ``/readyz`` to 503; ``/healthz`` liveness
    stays 200 so the orchestrator de-routes, not kills), in-flight
    scheduler work finishes (``QueryScheduler.close`` — bounded, joins
    the workers; leaving workers mid-device-launch lets a CLI/test
    process exit with work half-executed), the audit and slow-query
    logs flush, and only then does the accept loop stop."""

    scheduler = None
    store = None  # wired by make_server (audit flush at drain)
    stream_layer = None  # StreamingStore, when the live layer is on
    pubsub = None  # PubSubHub, when the push tier is on
    # the listen backlog: the stdlib's 5 drops connections under a burst of
    # concurrent clients, and their SYN retransmits (1 s, then 3 s) become
    # the latency tail; admission is the scheduler's job (429 +
    # Retry-After), at the default sched.max.queue
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        self.draining = threading.Event()
        super().__init__(*args, **kwargs)

    def shutdown(self):
        self.draining.set()  # stop admission BEFORE finishing in-flight
        if self.scheduler is not None:
            self.scheduler.close(timeout=5.0)
        if self.pubsub is not None:
            # detach the matcher from the stream and wake every push
            # connection before the live layer seals its WAL
            try:
                self.pubsub.close()
            except Exception:  # a failing close must not stop the drain
                pass
        if self.stream_layer is not None:
            # stop the compactor and seal the WAL; acked-but-uncompacted
            # rows stay durable in the log and replay on the next open
            try:
                self.stream_layer.close()
            except Exception:  # a failing close must not stop the drain
                pass
        aw = getattr(self.store, "audit_writer", None)
        if aw is not None:
            try:
                aw.flush()
            except Exception:  # a failing audit flush must not stop the drain
                pass
        super().shutdown()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: chunked transfer encoding for the streamed result
    # plane (first record batch flushes while later batches are still
    # assembling); every buffered response carries Content-Length so
    # keep-alive semantics hold. The socket timeout bounds how long an
    # IDLE keep-alive connection may pin a handler thread (the stdlib
    # turns the timeout into close_connection) — without it every
    # half-open client would hold a ThreadingHTTPServer thread forever.
    # make_server resolves the declared ``http.keepalive.s`` conf key
    # over this class default (router→backend persistent connections
    # share the same knob)
    protocol_version = "HTTP/1.1"
    timeout = 60

    store = None  # injected by make_server
    resident = False  # serve from device-pinned DeviceIndex caches
    scheduler = None  # QueryScheduler (admission + micro-batch fusion)
    stream = None  # StreamingStore live layer (None = batch-only)
    pubsub = None  # PubSubHub continuous-query tier (needs the stream)
    _resident_cache: dict = {}  # per-server-class: type -> DeviceIndex
    _resident_lock = None  # per-server-class construction lock

    def _di(self, type_name: str):
        """Resident index for a type (resident mode only). Streaming
        flavor: its internal lock serializes refresh against concurrent
        handler-thread scans. The dict read is the GIL-safe fast path;
        the construction lock only guards first-touch builds (a duplicate
        build would stage the whole dataset into device memory twice).

        First-touch builds run behind the ``cache`` circuit breaker
        (resilience.py): a staging failure (device OOM, store fault)
        degrades the request to the store path — returns None, stamped
        — instead of 500ing, and repeated failures open the breaker so
        requests stop paying the staging attempt until its half-open
        probe. A breaker-gated failure never evicts an ALREADY-staged
        healthy index (the dict hit above short-circuits)."""
        if not self.resident:
            return None
        di = self._resident_cache.get(type_name)
        if di is not None:
            return di
        from geomesa_tpu_torch import resilience

        if not resilience.degrade_allowed():
            return self._build_locked(type_name)[0]
        br = resilience.cache_breaker()
        if not br.allow():
            resilience.note_degraded("cache-breaker-open")
            return None
        try:
            di = self._build_locked(type_name)[0]
        except Exception as e:
            if resilience.classify(e) == resilience.FATAL:
                # unknown type / bad request: surface, not degrade —
                # and free a held half-open probe slot (no health
                # signal either way)
                br.release_probe()
                raise
            br.record_failure()
            resilience.note_degraded("resident-unavailable")
            return None
        br.record_success()
        return di

    @staticmethod
    def _loose(q: dict) -> "bool | None":
        v = q.get("loose")
        return None if v is None else v.lower() in ("1", "true", "yes")

    @staticmethod
    def _auths(q: dict) -> tuple:
        """Request authorizations (``auths=A,B``); absent = none — labeled
        features hide, fail closed, on both serving paths."""
        v = q.get("auths")
        if not v:
            return ()
        return tuple(a for a in (s.strip() for s in v.split(",")) if a)

    @staticmethod
    def _cap(q: dict) -> "int | None":
        """Result cap with interceptor parity, shared by every resident
        endpoint: an EXPLICIT maxFeatures (including 0) overrides the
        global query.max.features, which applies only when the request is
        unbounded (MaxFeaturesInterceptor semantics). None = uncapped."""
        mf = q.get("maxFeatures")
        if mf is not None:
            return max(0, int(mf))  # negatives behave like 0 (plain path)
        from geomesa_tpu_torch.conf import sys_prop

        g = int(sys_prop("query.max.features") or 0)
        return g if g > 0 else None

    def _build_locked(self, type_name: str):
        """First-touch resident build under the construction lock;
        returns (index, built_now)."""
        cache = self._resident_cache
        with self._resident_lock:
            if type_name in cache:
                return cache[type_name], False
            di = _make_resident_index(
                self.store, type_name,
                streaming=self.stream is not None,
            )
            cache[type_name] = di
            return di, True

    def _observe_resident(self, type_name: str, cql: str, t0, t1, hits):
        """Metrics + audit parity with the store query pipeline (resident
        scans bypass store.query, which would otherwise record these)."""
        try:
            from geomesa_tpu_torch.audit import AuditedEvent
            from geomesa_tpu_torch.metrics import queries_run, query_seconds
            from geomesa_tpu_torch.resilience import current_degraded
            from geomesa_tpu_torch.tracing import current_trace_id

            queries_run.inc(store="resident", type=type_name)
            query_seconds.observe(t1 - t0)
            if self.scheduler is None:
                # unscheduled resident serving: the scheduler would have
                # charged the ledger for this launch — do it here instead
                from geomesa_tpu_torch import ledger

                ledger.charge("device_launches", 1)
                ledger.charge("device_seconds", t1 - t0)
                ledger.charge("fusion_width", 1)
            aw = getattr(self.store, "audit_writer", None)
            if aw is not None:
                aw.write(AuditedEvent(
                    store="resident", type_name=type_name, filter=cql,
                    planning_ms=0.0, scanning_ms=(t1 - t0) * 1e3, hits=hits,
                    trace_id=current_trace_id(),
                    degraded=",".join(current_degraded()),
                ))
        except Exception:  # pragma: no cover - observability must not break
            pass

    # quiet default request logging; hook point for real deployments
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _stamp_response_headers(self, code: int, headers=()) -> None:
        """The shared response stamping between ``send_response`` and
        ``end_headers``: ledger status, request-id echo, degradation
        header — identical for buffered and streamed responses."""
        cost = getattr(self, "_cost", None)
        if cost is not None:
            # the ledger/SLO layer classifies good vs bad by this code
            cost.status = code
        tr = getattr(self, "_trace", None)
        if tr is not None:
            # the trace id rides the response whether or not the trace
            # was retained — clients correlate logs by it either way
            self.send_header("X-Request-Id", tr.trace_id)
            tr.root.set(status=code)
        else:
            # untraced paths (parse errors, monitoring endpoints) still
            # echo a sanitized inbound id: a client correlating a 400/
            # 429/5xx against its own logs needs it most on errors
            from geomesa_tpu_torch.tracing import _clean_id

            rid = _clean_id(self.headers.get("X-Request-Id"))
            if rid:
                self.send_header("X-Request-Id", rid)
        reasons = getattr(self, "_degraded", None)
        if reasons:
            # the degradation contract: an approximate or partial answer
            # is never silent — the client can see (and log) the rung
            self.send_header("X-Degraded", ",".join(reasons))
            if tr is not None:
                tr.root.set(degraded=",".join(reasons))
        for name, value in headers:
            self.send_header(name, value)

    def _send(self, code: int, body: bytes, ctype: str, headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self._stamp_response_headers(code, headers)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, doc) -> None:
        self._send(code, json.dumps(doc).encode("utf-8"), "application/json")

    def _observe_encode(self, fmt: str, enc_s: float, write_s: float,
                        total: int, rows, batches: int) -> None:
        """Fold one response's serialization cost into the ledger
        (its encode and response-byte fields), the results metrics, and two SIBLING spans —
        ``http.encode`` (serialization only) and ``http.write`` (socket
        only), split so a slow client can no longer pollute encode
        attribution in the slow-query log or ``/stats/ledger``."""
        import time as _time

        from geomesa_tpu_torch import ledger, metrics
        from geomesa_tpu_torch.tracing import capture, record_span

        now = _time.perf_counter()
        parent = capture()
        record_span(
            parent, "http.encode", now - enc_s - write_s, enc_s,
            fmt=fmt, rows=rows, batches=batches, bytes=total,
        )
        record_span(parent, "http.write", now - write_s, write_s,
                    bytes=total)
        ledger.charge("encode_seconds", enc_s)
        ledger.charge("response_bytes", total)
        metrics.results_encode_seconds.observe(enc_s)
        metrics.results_write_seconds.observe(write_s)
        metrics.results_batches.inc(batches, fmt=fmt)
        metrics.results_bytes.inc(total, fmt=fmt)

    def _send_encoded(self, code: int, body: bytes, ctype: str, fmt: str,
                      enc_s: float, rows=None, headers=()) -> None:
        """Buffered response whose serialization the caller already
        timed (``enc_s``); the socket write is measured here."""
        import time as _time

        t0 = _time.perf_counter()
        self._send(code, body, ctype, headers=headers)
        self._observe_encode(
            fmt, enc_s, _time.perf_counter() - t0, len(body), rows, 1
        )

    @staticmethod
    def _timed_batches(batches, cell: list):
        """Wrap a batch iterator, accumulating time spent PRODUCING
        batches (store partition read/decode on the streamed store
        rung) into ``cell[0]`` — _send_stream subtracts it so
        encode_seconds stays pure serialization time (the store's own
        instrumentation already charges read/decode fields; counting
        those seconds as encode would re-pollute the very attribution
        the encode/write split exists to clean up)."""
        import time as _time

        it = iter(batches)
        try:
            while True:
                t0 = _time.perf_counter()
                b = next(it, None)
                cell[0] += _time.perf_counter() - t0
                if b is None:
                    return
                yield b
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _send_stream(self, code: int, ctype: str, chunks, fmt: str,
                     rows=None, headers=(), upstream: "list | None" = None,
                     ) -> None:
        """Chunked streaming response: the FIRST chunk is produced
        before the status line goes out (late planning/encode errors
        still surface as clean HTTP errors), every later chunk flushes
        to the socket while the next is still assembling. Serialization
        time (pulling the generator) and socket-write time accumulate
        separately for the encode/write span split. A mid-stream
        failure AFTER headers cannot become an error response — the
        chunked stream ends WITHOUT its terminating 0-chunk and the
        connection drops, so clients detect truncation instead of
        parsing a partial result as complete."""
        import time as _time

        it = iter(chunks)
        t0 = _time.perf_counter()
        first = next(it, b"")
        enc = _time.perf_counter() - t0
        if self.request_version < "HTTP/1.1":
            # RFC 9112: never send chunked framing to a 1.0 peer — it
            # would read the hex chunk sizes as body bytes. Buffer the
            # whole stream (the pre-streaming behavior) and close.
            t1 = _time.perf_counter()
            body = first + b"".join(it)
            enc += _time.perf_counter() - t1
            if upstream is not None:
                enc = max(enc - upstream[0], 0.0)
            self.close_connection = True
            return self._send_encoded(
                code, body, ctype, fmt, enc, rows=rows, headers=headers
            )
        write_s = 0.0
        total = 0
        nchunks = 0
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self._stamp_response_headers(code, headers)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        clean = False
        try:
            piece = first
            while True:
                if piece:
                    nchunks += 1
                    t1 = _time.perf_counter()
                    self.wfile.write(b"%x\r\n" % len(piece))
                    self.wfile.write(piece)
                    self.wfile.write(b"\r\n")
                    write_s += _time.perf_counter() - t1
                    total += len(piece)
                t1 = _time.perf_counter()
                piece = next(it, None)
                enc += _time.perf_counter() - t1
                if piece is None:
                    clean = True
                    break
        except BrokenPipeError:
            self.close_connection = True
        except Exception as e:
            # headers are gone: signal truncation, never a fake success
            self.close_connection = True
            tr = getattr(self, "_trace", None)
            if tr is not None:
                tr.root.set(stream_error=f"{type(e).__name__}: {e}")
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                # deterministic teardown on abandonment: the encoder's
                # finally closes its writer and the partition stream
                # joins its prefetch workers NOW, not at GC time
                close()
        if clean:
            try:
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                self.close_connection = True
        if upstream is not None:
            # generator pulls included upstream batch PRODUCTION time
            # (partition read/decode); encode keeps serialization only
            enc = max(enc - upstream[0], 0.0)
        self._observe_encode(fmt, enc, write_s, total, rows, nchunks)

    def _sched_run(self, q: dict, fn=None, fuse=None, device=None):
        """Route one unit of query work through the device query
        scheduler when one is configured (admission control, deadlines,
        micro-batch fusion for compatible resident queries); direct
        execution otherwise. Request knobs: ``lane=interactive|batch``,
        ``tenant=`` (defaults to the client address, the per-tenant
        fairness key), ``deadlineMs=``."""
        sched = self.scheduler
        if sched is None:
            if fn is not None:
                return fn()
            return fuse.run_serial()
        dl = q.get("deadlineMs")
        tenant = q.get("tenant")
        if not tenant and self.client_address:
            tenant = str(self.client_address[0])
        kw = {}
        if dl:  # absent: the scheduler's configured default applies
            kw["deadline_ms"] = float(dl)
        return sched.run(
            fn=fn,
            fuse=fuse,
            lane=q.get("lane", "interactive"),
            tenant=tenant or "",
            device=device,
            **kw,
        )

    def _degradable(self, q: dict, reason: str, fallback, fn=None,
                    fuse=None):
        """Run device-rung work with the full fault discipline: the
        ``device`` circuit breaker gates entry (open -> straight to the
        fallback rung, stamped — nobody queues behind a dead device),
        transient faults retry with jittered backoff
        (``resilience.retries``), and a non-retryable / still-failing
        launch falls to ``fallback`` with ``reason`` noted. Flow-control
        signals (429/504) and FATAL faults (bad requests) always
        propagate — backpressure and errors are part of the client
        contract, not something to degrade away. The fallback runs
        OUTSIDE the scheduler by design: it is the emergency rung, and
        the scheduler meters the device it no longer touches."""
        from geomesa_tpu_torch import resilience
        from geomesa_tpu_torch.sched import DeadlineExpired, RejectedError

        if not resilience.enabled():
            return self._sched_run(q, fn=fn, fuse=fuse, device=True)
        br = resilience.device_breaker()
        can_fall = fallback is not None and resilience.degrade_allowed()
        if can_fall and not br.allow():
            resilience.note_degraded("device-breaker-open")
            return fallback()
        try:
            res = resilience.retry_call(
                lambda: self._sched_run(q, fn=fn, fuse=fuse, device=True),
                domain="device",
            )
        except (RejectedError, DeadlineExpired):
            # a shed/expired half-open probe carried no health signal:
            # free the slot so the next caller probes immediately, or a
            # saturated queue would pin the breaker half-open (and all
            # traffic on the degraded rung) one full cooldown per shed
            if can_fall:
                br.release_probe()
            raise
        except Exception as e:
            if resilience.classify(e) == resilience.FATAL:
                # a bad REQUEST says nothing about device health: free
                # a held half-open probe slot instead of pinning the
                # breaker (and all traffic on the degraded rung) for
                # another cooldown
                if can_fall:
                    br.release_probe()
                raise
            stuck = isinstance(e, resilience.LaunchStuckError)
            if not stuck:
                # the watchdog already charged the stuck launch to the
                # breaker — once per FAULT; re-recording here would add
                # one count per fused rider and open the breaker after
                # a single wedged group
                br.record_failure()
            if not can_fall:
                raise
            resilience.note_degraded("launch-stuck" if stuck else reason)
            return fallback()
        br.record_success()
        return res

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
        except Exception as e:
            # clear ALL per-request state: on a keep-alive connection
            # this handler instance served the previous request, and a
            # stale cost/degraded carry-over would mis-stamp this 400
            self._trace = None
            self._degraded = None
            self._cost = None
            return self._json(400, {"error": str(e)})
        # observability endpoints are not themselves traced — scrapes,
        # trace reads and the stats snapshots must not churn the trace
        # ring (a monitoring poll would evict real query traces).
        # /stats/<type> with a real type name IS a query and stays
        # traced; the same disambiguation _dispatch routes by.
        untraced = (
            parts and parts[0] in ("metrics", "debug", "healthz", "readyz")
        ) or (
            parts == ["stats", "sched"] and self.scheduler is not None
        ) or (
            parts == ["stats", "store"]
            and hasattr(self.store, "store_stats")
        ) or parts == ["stats", "mesh"] or parts == ["stats", "slo"] \
            or parts == ["stats", "ledger"] or parts == ["stats", "stream"] \
            or parts == ["stats", "replica"] or parts[:1] == ["wal"] \
            or parts[:1] == ["snapshot"] or parts == ["stats"] \
            or parts == ["stats", "pubsub"] or parts[:1] == ["subscribe"]
        if untraced:
            self._trace = None
            self._degraded = None
            self._cost = None
            return self._dispatch_safe(url, parts, q)
        from geomesa_tpu_torch import ledger, resilience
        from geomesa_tpu_torch.tracing import TRACER

        tenant = q.get("tenant") or (
            str(self.client_address[0]) if self.client_address else ""
        )
        # error handling lives INSIDE the trace: the error response is
        # sent (status attr stamped, its time counted) before the trace
        # finishes and retention / the slow-query log fire. The
        # degradation collector wraps the same scope: any layer that
        # answers below the requested rung notes a reason here, and the
        # response/audit stamping reads it back. The cost collector
        # rides along too — it is finalized AFTER the trace completes
        # (the span tree is whole at that point) and folded into the
        # process ledger + the SLO engine's latency windows.
        with TRACER.trace(
            f"GET {url.path}",
            trace_id=self.headers.get("X-Request-Id"),
            attrs={"path": url.path, "query": url.query[:512]},
        ) as tr, resilience.collect_degraded() as reasons, \
                ledger.collect_cost(
                    tenant=tenant,
                    endpoint=_cost_endpoint(parts),
                    lane=q.get("lane", "interactive"),
                    shape=_query_shape(parts, q),
                ) as cost:
            self._trace = tr
            self._degraded = reasons
            self._cost = cost
            if cost is not None:
                # stamped NOW (not at finish) so a mid-request compile
                # ledger entry can name the trace that blocked on it
                cost.trace_id = tr.trace_id
            self._dispatch_safe(url, parts, q)
        ledger.finish_request(cost, tr)

    def _admin_authorized(self) -> bool:
        """Gate for operator-plane endpoints (``/admin/*``). With
        ``admin.token`` set, the caller must present the exact shared
        secret in ``X-Admin-Token`` (compared constant-time). With no
        token configured the plane stays usable for local tooling but
        only from loopback peers — a reachable serving port must not
        expose an unauthenticated kill switch."""
        import hmac

        from geomesa_tpu_torch.conf import sys_prop

        token = str(sys_prop("admin.token"))
        if token:
            offered = self.headers.get("X-Admin-Token") or ""
            return hmac.compare_digest(offered, token)
        peer = str(self.client_address[0]) if self.client_address else ""
        return peer in ("127.0.0.1", "::1", "::ffff:127.0.0.1")

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        """POST ``/append/<type>``: the streaming-ingest endpoint. Body
        ``{"columns": {...}, "fids": [...], "visibilities": [...]}``;
        the response acks rows that are WAL-durable and queryable NOW
        (no flush/restage on this path). Backpressure surfaces as 429 +
        Retry-After — from the scheduler's admission bound or the live
        layer's ``wal.max.generations`` read-amplification bound."""
        from geomesa_tpu_torch.conf import sys_prop

        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            length = int(self.headers.get("Content-Length") or 0)
            cap = int(sys_prop("stream.append.max.bytes"))
            if cap and length > cap:
                # bounded-everything discipline: one append becomes one
                # WAL record and one memtable run — refuse BEFORE
                # buffering (nothing is read, nothing is acked)
                self._trace = None
                self._degraded = None
                self._cost = None
                return self._json(413, {
                    "error": f"append body {length} bytes exceeds "
                             f"stream.append.max.bytes={cap}"
                })
            body = self.rfile.read(length) if length else b""
        except Exception as e:
            self._trace = None
            self._degraded = None
            self._cost = None
            return self._json(400, {"error": str(e)})
        if parts == ["admin", "shutdown"]:
            # the fleet-restart drain trigger: respond FIRST (the
            # orchestrator needs the ack), then run the draining
            # shutdown off-thread — shutdown() joins in-flight work
            # and would deadlock the handler thread serving this very
            # request
            self._trace = None
            self._degraded = None
            self._cost = None
            if not self._admin_authorized():
                return self._json(403, {
                    "error": "admin endpoint refused: present the "
                             "X-Admin-Token header (admin.token), or "
                             "call from loopback when no token is "
                             "configured"
                })
            self._json(200, {"draining": True})
            spawn_thread(
                self.server.shutdown, name="admin-shutdown", context=False
            ).start()
            return
        if len(parts) == 2 and parts[0] == "subscribe":
            # subscription CRUD is control-plane traffic: untraced, like
            # the ship endpoints
            self._trace = None
            self._degraded = None
            self._cost = None
            return self._run_safe(
                lambda: self._subscribe_post(parts, q, body), parts, q
            )
        if len(parts) != 2 or parts[0] != "append":
            self._trace = None
            self._degraded = None
            self._cost = None
            return self._json(
                404, {"error": f"no such POST endpoint {url.path!r}"}
            )
        # appends default to the dedicated ingest lane (top priority:
        # sub-ms host work must not queue behind device scans)
        q.setdefault("lane", "ingest")
        from geomesa_tpu_torch import ledger, resilience
        from geomesa_tpu_torch.tracing import TRACER

        tenant = q.get("tenant") or (
            str(self.client_address[0]) if self.client_address else ""
        )
        with TRACER.trace(
            f"POST {url.path}",
            trace_id=self.headers.get("X-Request-Id"),
            attrs={"path": url.path, "bytes": len(body)},
        ) as tr, resilience.collect_degraded() as reasons, \
                ledger.collect_cost(
                    tenant=tenant,
                    endpoint="append",
                    lane=q["lane"],
                    shape="append",
                ) as cost:
            self._trace = tr
            self._degraded = reasons
            self._cost = cost
            if cost is not None:
                cost.trace_id = tr.trace_id
            self._run_safe(
                lambda: self._append_post(parts, q, body), parts, q
            )
        ledger.finish_request(cost, tr)

    def _append_post(self, parts: list, q: dict, body: bytes) -> None:
        from geomesa_tpu_torch.features.batch import FeatureBatch

        type_name = unquote(parts[1])
        if self._draining():
            return self._send(
                503,
                json.dumps(
                    {"error": "server is draining"}
                ).encode("utf-8"),
                "application/json",
                headers=(("Retry-After", "1"),),
            )
        stream = self.stream
        if stream is None:
            return self._json(
                400,
                {"error": "server is not running with the streaming "
                          "live layer (stream.enabled / serve --stream)"},
            )
        doc = json.loads(body.decode("utf-8")) if body else {}
        cols = doc.get("columns")
        if not isinstance(cols, dict) or not cols:
            raise ValueError(
                'append body needs {"columns": {...}, "fids": [...]}'
            )
        sft = self.store.get_schema(type_name)  # KeyError -> 404
        batch = FeatureBatch.from_columns(sft, cols, doc.get("fids"))
        vis = doc.get("visibilities")
        if vis is not None:
            batch = batch.with_visibility(vis)
        res = self._sched_run(
            q, fn=lambda: stream.append(type_name, batch)
        )
        doc = {"acked": int(res["rows"]), "seq": int(res["seq"])}
        self._json(200, doc)

    # -- continuous queries (the pubsub push tier) -------------------------

    def _pubsub_hub(self):
        if self.pubsub is None:
            raise ValueError(
                "server is not running the continuous-query push tier "
                "(needs the streaming live layer: stream.enabled / "
                "serve --stream)"
            )
        return self.pubsub

    def _subscribe_post(self, parts: list, q: dict, body: bytes) -> None:
        """POST ``/subscribe/<type>``: register a standing continuous
        query. Body: any of ``{"bbox": [...], "cql": "...", "dwithin":
        {"x","y","distance"}, "auths": [...]}``. The response carries the
        subscription id and its initial cursor (the data-WAL seq it is
        armed from)."""
        hub = self._pubsub_hub()
        if self._draining():
            return self._send(
                503,
                json.dumps({"error": "server is draining"}).encode("utf-8"),
                "application/json",
                headers=(("Retry-After", "1"),),
            )
        type_name = unquote(parts[1])
        doc = json.loads(body.decode("utf-8")) if body else {}
        tenant = q.get("tenant") or (
            str(self.client_address[0]) if self.client_address else ""
        )
        auths = doc.get("auths")
        if auths is None:
            auths = self._auths(q)
        self._json(200, hub.subscribe(type_name, doc, tenant=tenant, auths=auths))

    def do_DELETE(self) -> None:  # noqa: N802 (stdlib API)
        """DELETE ``/subscribe/<type>?id=<sub>``: cancel a standing
        subscription."""
        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
        except Exception as e:
            self._trace = None
            self._degraded = None
            self._cost = None
            return self._json(400, {"error": str(e)})
        self._trace = None
        self._degraded = None
        self._cost = None
        if len(parts) != 2 or parts[0] != "subscribe":
            return self._json(
                404, {"error": f"no such DELETE endpoint {url.path!r}"}
            )
        return self._run_safe(
            lambda: self._subscribe_delete(parts, q), parts, q
        )

    def _subscribe_delete(self, parts: list, q: dict) -> None:
        hub = self._pubsub_hub()
        sub_id = q.get("id")
        if not sub_id:
            raise ValueError("DELETE /subscribe/<type> needs ?id=<sub>")
        if not hub.cancel(sub_id):
            raise KeyError(sub_id)
        self._json(200, {"cancelled": sub_id})

    def _subscribe_stream(self, type_name: str, q: dict) -> None:
        """GET ``/subscribe/<type>?id=&from=&f=``: the long-lived push
        stream. ``from`` (or the SSE ``Last-Event-ID`` header) is the
        subscriber's acked seq watermark: delivery resumes exactly once
        above it; omitted, it is the subscription's creation cursor.
        geojson = SSE ``match`` events with ``:keepalive`` heartbeats, bin
        = track records (resume with an explicit ``from=``); arrow answers
        406 (ROADMAP section 3)."""
        from geomesa_tpu_torch.conf import sys_prop
        from geomesa_tpu_torch.pubsub import CursorGoneError
        from geomesa_tpu_torch.pubsub.delivery import bin_push_chunks, sse_chunks
        from geomesa_tpu_torch.results import PUSH_CONTENT_TYPES, negotiate_format

        hub = self._pubsub_hub()
        if self._draining():
            return self._send(
                503,
                json.dumps({"error": "server is draining"}).encode("utf-8"),
                "application/json",
                headers=(("Retry-After", "1"),),
            )
        sub_id = q.get("id")
        if not sub_id:
            raise ValueError("GET /subscribe/<type> needs ?id=<sub>")
        sub = hub.registry.get(sub_id)
        if sub is None or sub.type_name != type_name:
            raise KeyError(sub_id)
        fmt = negotiate_format(q, self.headers.get("Accept"))
        if fmt == "arrow":
            raise _NotAcceptable(_ARROW_406)
        frm = q.get("from")
        if frm is None:
            frm = self.headers.get("Last-Event-ID")
        from_seq = int(frm) if frm is not None else int(sub.created_seq)
        sft = self.store.get_schema(type_name)
        try:
            events = hub.events(
                type_name, sub_id, from_seq,
                float(sys_prop("sub.heartbeat.s")),
            )
        except CursorGoneError as e:
            return self._json(410, {"error": str(e)})
        # a push connection is idle on purpose between matches: exempt it
        # from the keep-alive reap (heartbeats bound the detection of a
        # dead peer instead) and never reuse the socket afterwards
        self.connection.settimeout(None)
        self.close_connection = True
        if fmt == "bin":
            track = q.get("track") or sft.attribute_names[0]
            chunks = bin_push_chunks(events, track)
        else:
            chunks = sse_chunks(events, type_name, sub_id)
        self._send_stream(
            200, PUSH_CONTENT_TYPES[fmt], self._deliver_guard(chunks, sub), fmt,
            headers=(("Cache-Control", "no-cache"),),
        )

    def _deliver_guard(self, chunks, sub):
        """Per-chunk delivery wrapper: the ``fail.sub.deliver`` fault hook
        and the byte accounting charged to the subscriber's tenant."""
        from geomesa_tpu_torch import ledger, metrics
        from geomesa_tpu_torch.failpoints import fail_point

        sent = 0
        try:
            for piece in chunks:
                fail_point("fail.sub.deliver")
                sent += len(piece)
                yield piece
        finally:
            if sent:
                metrics.pubsub_deliver_bytes.inc(float(sent))
                if ledger.enabled():
                    cost = ledger.RequestCost(
                        tenant=sub.tenant,
                        endpoint="subscribe",
                        lane="interactive",
                        shape="push-stream",
                    )
                    cost.status = 200
                    cost.charge("sub_deliver_bytes", float(sent))
                    ledger.LEDGER.record(cost)

    def _registry_ship(self, q: dict) -> None:
        """``GET /wal/_pubsub?from=``: ship the subscription registry's WAL
        in the segment framing (``store/wal.py`` ``pack_record``). The
        registry log is never truncated, so there is no watermark and no
        410: a reader can always catch up from any position."""
        from geomesa_tpu_torch.store.wal import pack_record

        hub = self._pubsub_hub()
        wal = hub.registry.wal
        frm = max(int(q.get("from", 0)), 0)
        nxt = int(wal.next_seq)

        def chunks():
            buf = bytearray()
            for seq, payload in wal.read_from(frm - 1):
                if seq >= nxt:
                    break
                buf += pack_record(seq, payload)
                if len(buf) >= (512 << 10):
                    yield bytes(buf)
                    buf.clear()
            if buf:
                yield bytes(buf)

        self._send_stream(
            200, "application/x-geomesa-wal", chunks(), "wal",
            headers=(
                ("X-Wal-Next-Seq", str(nxt)),
                ("X-Wal-Watermark", "-1"),
                ("X-Replica-Role", "leader"),
                ("X-Replica-Epoch", "0"),
            ),
        )

    def _not_yet(self, what: str) -> None:
        """501 for a surface the port does not serve yet, naming the
        ROADMAP item that brings it."""
        self._json(501, {"error": f"not in the port yet: {what}"})

    def _audit_outcome(self, parts: list, q: dict, outcome: str) -> None:
        """Stamp a shed (429) or deadline-expired (504) request into the
        audit log — operators sizing admission need the requests that
        did NOT run, not just the ones that did. Best-effort: auditing
        must never break the error response it annotates."""
        try:
            aw = getattr(self.store, "audit_writer", None)
            if aw is None:
                return
            from geomesa_tpu_torch.audit import AuditedEvent
            from geomesa_tpu_torch.resilience import current_degraded
            from geomesa_tpu_torch.tracing import current_trace_id

            aw.write(AuditedEvent(
                store="server",
                type_name=parts[1] if len(parts) > 1 else "",
                filter=q.get("cql", ""),
                hits=0,
                trace_id=current_trace_id(),
                outcome=outcome,
                degraded=",".join(current_degraded()),
            ))
        except Exception:  # pragma: no cover - observability must not break
            pass

    def _dispatch_safe(self, url, parts: list, q: dict) -> None:
        return self._run_safe(
            lambda: self._dispatch(url, parts, q), parts, q
        )

    def _run_safe(self, fn, parts: list, q: dict) -> None:
        try:
            return fn()
        except _NotAcceptable as e:
            self._json(406, {"error": str(e)})
        except KeyError as e:
            self._json(404, {"error": f"unknown schema or attribute {e}"})
        except ValueError as e:
            self._json(400, {"error": str(e)})
        except BrokenPipeError:
            pass
        except Exception as e:
            from geomesa_tpu_torch.sched import DeadlineExpired, RejectedError
            from geomesa_tpu_torch.store.stream import WalUnavailableError

            if isinstance(e, WalUnavailableError):
                # the wal breaker is open: appends fail fast until its
                # half-open probe — 503 says "not you, come back"
                return self._send(
                    503,
                    json.dumps({"error": str(e)}).encode("utf-8"),
                    "application/json",
                    headers=(("Retry-After", "1"),),
                )
            if isinstance(e, RejectedError):
                # backpressure: shed load explicitly instead of queueing
                # unboundedly; clients should honor Retry-After (derived
                # from live queue depth + drain rate, jittered — see
                # QueryScheduler._retry_after_locked)
                self._audit_outcome(parts, q, "shed")
                return self._send(
                    429,
                    json.dumps({"error": str(e)}).encode("utf-8"),
                    "application/json",
                    # RFC 9110 delta-seconds is integral: standard client
                    # retry machinery (urllib3 et al.) rejects fractions.
                    # Ceil keeps the estimate an upper bound; the jitter
                    # survives rounding at multi-second queue depths
                    headers=(
                        ("Retry-After", str(math.ceil(e.retry_after_s))),
                    ),
                )
            if isinstance(e, DeadlineExpired):
                self._audit_outcome(parts, q, "deadline-expired")
                return self._json(504, {"error": str(e)})
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def _draining(self) -> bool:
        ev = getattr(self.server, "draining", None)
        return ev is not None and ev.is_set()

    def _healthz(self) -> None:
        """Liveness: 200 for as long as the process is up — INCLUDING
        while draining. Failing liveness makes an orchestrator KILL the
        instance (restart, not de-route), which would lose exactly the
        in-flight work the draining shutdown exists to finish; traffic
        removal is ``/readyz``'s job, and it flips 503 the moment
        draining starts."""
        self._json(
            200, {"status": "draining" if self._draining() else "ok"}
        )

    def _readyz(self) -> None:
        """Readiness, driven by breaker state: the body reports every
        failure domain's breaker, the open (unhealthy) domains,
        scheduler queue pressure and any BURNING SLOs. A DEGRADED or
        burning instance is still READY (200) — it serves, just
        lower-rung or over budget, and says so; only draining and (with
        ``compile.warmup.gate=ready``) a warmup pass still running flip 503
        (nothing new should be routed here)."""
        from geomesa_tpu_torch import resilience, slo

        breakers = resilience.snapshot()
        degraded = sorted(
            d for d, s in breakers.items()
            if isinstance(s, dict) and s.get("state") != "closed"
        )
        if breakers.get("partition_open"):
            degraded.append("partition")
        # burning SLOs are degraded DETAIL, never unready: pulling a
        # burning instance from rotation would shift its load onto the
        # others and burn THEIR budgets faster
        burning = slo.ENGINE.burning() if slo.enabled() else []
        doc = {
            "ready": not self._draining(),
            "draining": self._draining(),
            "degraded_domains": degraded,
            "slo_burning": burning,
            "breakers": breakers,
        }
        if self.scheduler is not None:
            queued, max_queue = self.scheduler.queue_pressure()
            doc["sched"] = {"queued": queued, "max_queue": max_queue}
        if getattr(self, "_warmup_started", False):
            from geomesa_tpu_torch import warmup
            from geomesa_tpu_torch.conf import sys_prop

            gate = str(sys_prop("compile.warmup.gate"))
            if gate != "off" and warmup.warming():
                # the warmup pass over the kernel families still runs:
                # gate="ready" holds readiness so a rolling restart never
                # routes traffic at a cold process; gate="stamp" serves
                # at once but says so
                doc["warming"] = True
                if gate == "ready":
                    doc["ready"] = False
        self._json(200 if doc["ready"] else 503, doc)

    def _dispatch(self, url, parts: list, q: dict) -> None:
        if parts == ["capabilities"]:
            return self._capabilities()
        if parts == ["healthz"]:
            return self._healthz()
        if parts == ["readyz"]:
            return self._readyz()
        if parts == ["metrics"]:
            from geomesa_tpu_torch.metrics import REGISTRY

            # content negotiation: exemplars (trace-id suffixes) are
            # only valid in the OpenMetrics format — the classic 0.0.4
            # parser would fail the WHOLE scrape on one suffixed line
            om = "application/openmetrics-text" in (
                self.headers.get("Accept") or ""
            )
            return self._send(
                200,
                REGISTRY.prometheus_text(openmetrics=om).encode("utf-8"),
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8" if om else "text/plain; version=0.0.4",
            )
        if parts[:2] == ["debug", "traces"]:
            return self._debug_traces(parts, q)
        if parts == ["stats", "sched"] and self.scheduler is not None:
            return self._json(200, self.scheduler.snapshot())
        if parts == ["stats", "store"] and hasattr(
            self.store, "store_stats"
        ):
            return self._json(200, self.store.store_stats())
        if parts == ["stats", "mesh"]:
            return self._json(200, self._mesh_stats())
        if parts == ["stats", "slo"]:
            from geomesa_tpu_torch import slo

            return self._json(200, slo.ENGINE.snapshot())
        if parts == ["stats", "ledger"]:
            from geomesa_tpu_torch.ledger import LEDGER

            return self._json(200, LEDGER.snapshot())
        if parts == ["stats", "stream"]:
            return self._json(
                200,
                self.stream.stream_stats()
                if self.stream is not None
                else {"enabled": False},
            )
        if parts == ["stats", "replica"]:
            return self._json(200, {"enabled": False})
        if parts == ["stats", "pubsub"]:
            return self._json(
                200,
                self.pubsub.stats()
                if self.pubsub is not None
                else {"enabled": False},
            )
        if len(parts) == 2 and parts[0] == "subscribe":
            # the long-lived push stream (SSE / BIN)
            return self._subscribe_stream(unquote(parts[1]), q)
        if parts == ["stats"]:
            return self._json(200, self._stats_index())
        if parts[:1] == ["wal"] and len(parts) == 2:
            from geomesa_tpu_torch.pubsub import REGISTRY_SHIP_NAME

            if unquote(parts[1]) == REGISTRY_SHIP_NAME:
                if self.stream is None:
                    return self._json(
                        400,
                        {"error": "server is not running with the streaming "
                                  "live layer (stream.enabled / serve --stream)"},
                    )
                # the subscription registry ships through the data ship's
                # endpoint as a reserved pseudo-type (no schema, never
                # truncated)
                return self._registry_ship(q)
        if len(parts) == 2 and parts[0] in ("wal", "snapshot"):
            return self._not_yet(_REPLICA_LATER)
        if len(parts) == 2 and parts[0] in (
            "features", "count", "explain", "density", "stats",
            "refresh", "knn", "tube", "proximity",
        ):
            if self._draining():
                # admission is closed: a draining instance finishes
                # what it has, it does not take on more
                return self._send(
                    503,
                    json.dumps(
                        {"error": "server is draining"}
                    ).encode("utf-8"),
                    "application/json",
                    headers=(("Retry-After", "1"),),
                )
            handler = getattr(self, f"_{parts[0]}")
            return handler(unquote(parts[1]), q)
        self._json(404, {"error": f"no such endpoint {url.path!r}"})

    def _mesh_stats(self) -> dict:
        """``/stats/mesh``: the reference's document of a server that
        serves single-card (no type is mesh-resident)."""
        return {"enabled": False, "devices_visible": _devices_visible(), "types": {}}

    def _stats_index(self) -> dict:
        """``/stats``: one roll-up document — scheduler, store, mesh,
        SLO engine, cost ledger, the persistent compile cache
        (its kernel builds: hit/miss) and the warmup's progress in a single
        scrape."""
        from geomesa_tpu_torch import slo, warmup
        from geomesa_tpu_torch.kernels._build import compile_cache_stats
        from geomesa_tpu_torch.ledger import LEDGER

        doc: dict = {
            "compile_cache": compile_cache_stats(),
            "warmup": warmup.progress(),
        }
        if self.scheduler is not None:
            doc["sched"] = self.scheduler.snapshot()
        if hasattr(self.store, "store_stats"):
            doc["store"] = self.store.store_stats()
        doc["mesh"] = self._mesh_stats()
        doc["slo"] = slo.ENGINE.snapshot()
        doc["ledger"] = LEDGER.snapshot()
        if self.stream is not None:
            doc["stream"] = self.stream.stream_stats()
        if self.pubsub is not None:
            doc["pubsub"] = self.pubsub.stats()
        return doc

    def _debug_traces(self, parts: list, q: dict) -> None:
        """``/debug/traces`` (recent summaries) and
        ``/debug/traces/<id>`` (full span tree; ``?format=perfetto``)."""
        from geomesa_tpu_torch.tracing import TRACER

        if len(parts) == 2:
            limit = int(q.get("limit", 50))
            return self._json(200, {"traces": TRACER.recent(limit)})
        if len(parts) != 3:
            return self._json(404, {"error": "use /debug/traces[/<id>]"})
        t = TRACER.get(unquote(parts[2]))
        if t is None:
            return self._json(
                404,
                {"error": f"no trace {parts[2]!r} (evicted, or neither "
                          "sampled nor slow — see trace.sample / "
                          "trace.slow_ms)"},
            )
        if q.get("format") == "perfetto":
            return self._json(200, t.to_perfetto())
        return self._json(200, t.to_dict())

    # -- endpoints ---------------------------------------------------------

    def _capabilities(self) -> None:
        doc = {"types": {}}
        for name in self.store.type_names:
            sft = self.store.get_schema(name)
            doc["types"][name] = {
                "spec": sft.spec,
                "geometry": sft.geom_field,
                "dtg": sft.dtg_field,
                "attributes": [
                    {"name": a.name, "type": a.type_name}
                    for a in sft.attributes
                ],
            }
        self._json(200, doc)

    def _query(self, type_name: str, q: dict):
        from geomesa_tpu_torch.query.plan import Query

        max_features = q.get("maxFeatures")
        props = q.get("properties")
        return self.store.query(
            type_name,
            Query(
                filter=q.get("cql", "INCLUDE"),
                max_features=int(max_features) if max_features else None,
                properties=props.split(",") if props else None,
                hints={"auths": self._auths(q)},
            ),
        )

    def _features(self, type_name: str, q: dict) -> None:
        from geomesa_tpu_torch import results

        fmt = results.negotiate_format(q, self.headers.get("Accept"))
        if fmt == "arrow":
            raise _NotAcceptable(_ARROW_406)
        di = self._di(type_name)
        if fmt == "bin":
            return self._features_bin(type_name, q, di)
        if di is not None and not q.get("properties"):
            import time as _time

            import numpy as np

            from geomesa_tpu_torch.sched import FusableQuery

            t0 = _time.perf_counter()
            cql = q.get("cql", "INCLUDE")
            fell: list = []

            def fallback():
                # store rung: exact, audited by the store path itself
                fell.append(True)
                return self._query(type_name, q).batch

            batch = self._degradable(
                q, "device-launch-failed", fallback,
                fuse=FusableQuery(
                    di, cql, "query",
                    loose=self._loose(q), auths=self._auths(q),
                ),
            )
            cap = self._cap(q)
            if cap is not None and len(batch) > cap:
                batch = batch.take(np.arange(cap))
            if not fell:
                self._observe_resident(
                    type_name, cql, t0, _time.perf_counter(), len(batch)
                )
        else:
            batch = self._sched_run(
                q, fn=lambda: self._query(type_name, q).batch
            )
        self._emit_geojson(batch)

    def _store_batches(self, type_name: str, q: dict):
        """Store-rung result batches as an ITERATOR for the streamed
        encoders. FS stores without the live layer stream one filtered
        batch per surviving partition through the prefetch pipeline
        (bounded read-ahead; visibility applied per partition, the cap
        trimmed across the stream). The streaming live layer and plain
        memory stores materialize the merged view — correctness first:
        a partition iterator would miss memtable rows."""
        from geomesa_tpu_torch import results
        from geomesa_tpu_torch.query.plan import Query

        qp = getattr(self.store, "query_partitions", None)
        if (
            qp is not None
            and self.stream is None
            and not q.get("properties")
        ):
            query = Query(
                filter=q.get("cql", "INCLUDE"),
                hints={"auths": self._auths(q)},
            )
            return results.capped_batches(
                qp(type_name, query), self._cap(q)
            )
        return iter(
            [self._sched_run(q, fn=lambda: self._query(type_name, q).batch)]
        )

    def _features_bin(self, type_name: str, q: dict, di) -> None:
        """``f=bin``: the 16/24-byte track records. Resident indexes
        pack on device (``results.bin.engine``; the fused
        count→cap→compact rider) with the numpy twin as fallback rung;
        the store rung streams per-batch records. ``track=`` names the
        track-id attribute (required), ``label=`` widens to 24-byte
        records, ``sortBin=1`` orders by dtg seconds."""
        import time as _time

        from geomesa_tpu_torch import results

        track = q.get("track")
        if not track:
            raise ValueError("f=bin needs track=<attribute>")
        label = q.get("label") or None
        sort = (q.get("sortBin") or "").lower() in ("1", "true", "yes")
        ctype = results.CONTENT_TYPES["bin"]
        rec = 24 if label else 16
        if di is not None and self._cap(q) is None \
                and not q.get("properties"):
            cql = q.get("cql", "INCLUDE")
            fell: list = []

            def fallback():
                fell.append(True)
                return None

            t0 = _time.perf_counter()

            def device_work():
                return results.resident_bin(
                    di, cql, track, dtg_attr=q.get("dtg"),
                    label_attr=label, sort=sort,
                    loose=self._loose(q), auths=self._auths(q),
                )

            data = self._degradable(
                q, "device-launch-failed", fallback, fn=device_work
            )
            t1 = _time.perf_counter()
            if data is not None:
                if not fell:
                    self._observe_resident(
                        type_name, cql, t0, t1, len(data) // rec
                    )
                return self._send_encoded(
                    200, data, ctype, "bin", t1 - t0,
                    rows=len(data) // rec,
                )
        fetch = [0.0]
        batches = self._timed_batches(
            self._store_batches(type_name, q), fetch
        )
        self._send_stream(
            200, ctype,
            results.bin_stream_chunks(
                batches, track, dtg_attr=q.get("dtg"),
                label_attr=label, sort=sort,
            ),
            "bin",
            upstream=fetch,
        )

    def _emit_geojson(self, batch) -> None:
        """GeoJSON feature collection with the encode/write split."""
        import time as _time

        from geomesa_tpu_torch.export import feature_collection

        t0 = _time.perf_counter()
        body = json.dumps(feature_collection(batch)).encode("utf-8")
        self._send_encoded(
            200, body, "application/json", "geojson",
            _time.perf_counter() - t0, rows=len(batch),
        )

    def _emit_features(self, batch, q: dict, extra=None) -> None:
        """Emit a process result batch in the NEGOTIATED format —
        ``/knn``/``/tube``/``/proximity`` honor ``f=arrow``/``f=bin``
        through the result plane (``f=bin``; Arrow answers 406). Extra
        per-feature outputs (kNN distances …) become real typed columns via
        an extended SFT, not a per-feature zip."""
        from geomesa_tpu_torch import results

        fmt = results.negotiate_format(q, self.headers.get("Accept"))
        if fmt == "arrow":
            raise _NotAcceptable(_ARROW_406)
        if extra:
            batch = results.with_extra_columns(batch, extra)
        if fmt == "bin":
            track = q.get("track")
            if not track:
                raise ValueError("f=bin needs track=<attribute>")
            sort = (q.get("sortBin") or "").lower() in (
                "1", "true", "yes"
            )
            return self._send_stream(
                200, results.CONTENT_TYPES["bin"],
                results.bin_stream_chunks(
                    [batch], track, dtg_attr=q.get("dtg"),
                    label_attr=q.get("label") or None, sort=sort,
                ),
                "bin", rows=len(batch),
            )
        self._emit_geojson(batch)

    # -- WPS process endpoints (knn / tube select / proximity search) ------

    def _knn(self, type_name: str, q: dict) -> None:
        """``/knn/<type>?x=&y=&k=&cql=&maxRadius=`` — k nearest features
        (KNearestNeighborSearchProcess analog). In resident mode this is
        ONE fused distance+top_k dispatch on the pinned columns."""
        from geomesa_tpu_torch.process.knn import knn

        px, py = float(q["x"]), float(q["y"])
        k = int(q.get("k", 10))
        kwargs = {}
        if q.get("maxRadius"):
            kwargs["max_radius_deg"] = float(q["maxRadius"])
        batch, dists = self._sched_run(
            q,
            fn=lambda: knn(
                self.store, type_name, px, py, k,
                base_filter=q.get("cql"),
                device_index=self._di(type_name),
                auths=self._auths(q),
                **kwargs,
            ),
        )
        import numpy as np

        self._emit_features(
            batch, q,
            extra={"knn_distance_deg": np.asarray(dists, np.float64)},
        )

    def _tube(self, type_name: str, q: dict) -> None:
        """``/tube/<type>?track=x,y,t;x,y,t;...&buffer=&maxDt=&cql=`` —
        corridor search around a track (TubeSelectProcess analog; one
        union-of-windows dispatch in resident mode)."""
        import numpy as np

        pts = [p for p in q["track"].split(";") if p]
        trk = np.array([[float(v) for v in p.split(",")] for p in pts])
        if trk.ndim != 2 or trk.shape[1] != 3 or len(trk) < 2:
            raise ValueError(
                "track must be 'x,y,t_ms;x,y,t_ms;...' with >= 2 points"
            )
        from geomesa_tpu_torch.process.tube import tube_select

        batch = tube_select(
            self.store, type_name, trk[:, :2], trk[:, 2].astype(np.int64),
            buffer_deg=float(q.get("buffer", 0.1)),
            max_dt_ms=int(q.get("maxDt", 3_600_000)),
            base_filter=q.get("cql"),
            device_index=self._di(type_name),
            auths=self._auths(q),
        )
        self._emit_features(batch, q)

    def _proximity(self, type_name: str, q: dict) -> None:
        """``/proximity/<type>?points=x,y;x,y&distance=&cql=`` — features
        within a distance of any input point (ProximitySearchProcess
        analog; one union-of-windows dispatch in resident mode)."""
        from geomesa_tpu_torch.geom.base import Point
        from geomesa_tpu_torch.process.proximity import proximity_search

        pts = [p for p in q["points"].split(";") if p]
        geoms = [
            Point(*(float(v) for v in p.split(","))) for p in pts
        ]
        batch, dists = proximity_search(
            self.store, type_name, geoms,
            distance_deg=float(q.get("distance", 0.1)),
            base_filter=q.get("cql"),
            device_index=self._di(type_name),
            auths=self._auths(q),
        )
        import numpy as np

        self._emit_features(
            batch, q,
            extra={"proximity_distance_deg": np.asarray(dists, np.float64)},
        )

    def _agg_shaped(self, type_name: str, cql: str) -> bool:
        """Pre-screen for the brownout rung: True when the filter is a
        shape the chunk pre-aggregates can answer (bbox+time
        conjunctions — `is_aggregate_shape`) AND the store actually has
        chunk statistics for the type. Anything else would row-scan
        inside store.count/density, and brownout runs on the HANDLER
        thread outside scheduler admission precisely because it is
        supposed to be near-free: an unmetered full scan there would
        amplify the overload it exists to relieve."""
        from geomesa_tpu_torch.query.plan import Query, is_aggregate_shape

        has_stats = getattr(self.store, "has_chunk_stats", None)
        if has_stats is None or not has_stats(type_name):
            return False  # v1/legacy/memory store: no pre-aggregates
        try:
            return bool(is_aggregate_shape(
                Query(filter=cql).parsed(),
                self.store.get_schema(type_name),
            ))
        except Exception:
            return False

    def _pushdown_eligible(self, q: dict) -> bool:
        """May a count answer from ``store.count`` (chunk pre-aggregates
        + internal row-scan fallback)? Caps and auths force the full
        query path — the ONE eligibility rule for the store-rung
        fallback, the brownout rung, and the non-resident route."""
        return (
            self._cap(q) is None
            and not self._auths(q)
            and hasattr(self.store, "count")
        )

    def _count_fallback(self, type_name: str, q: dict) -> int:
        """Store-rung count: the chunk-pushdown path when eligible
        (audited there), the full query path otherwise — exact either
        way, just not device-resident."""
        if self._pushdown_eligible(q):
            return int(
                self.store.count(type_name, q.get("cql", "INCLUDE"))
            )
        return len(self._query(type_name, q))

    def _count(self, type_name: str, q: dict) -> None:
        di = self._di(type_name)
        if di is not None:
            import time as _time

            from geomesa_tpu_torch import resilience
            from geomesa_tpu_torch.sched import FusableQuery

            t0 = _time.perf_counter()
            cql = q.get("cql", "INCLUDE")
            if resilience.brownout(self.scheduler) and \
                    self._pushdown_eligible(q) and \
                    self._agg_shaped(type_name, cql):
                # brownout rung: the admission queue is near its 429
                # cliff — answer from the store's chunk pre-aggregates
                # (exact; interior chunks never read) WITHOUT queueing
                # another device launch behind the saturated scheduler
                resilience.note_degraded("brownout-pushdown")
                n = int(self.store.count(type_name, cql))
                return self._json(200, {"count": n})
            fell: list = []

            def fallback():
                fell.append(True)
                return self._count_fallback(type_name, q)

            n = self._degradable(
                q, "device-launch-failed", fallback,
                fuse=FusableQuery(
                    di, cql, "count",
                    loose=self._loose(q), auths=self._auths(q),
                ),
            )
            cap = self._cap(q)
            if cap is not None:
                n = min(n, cap)  # the plain path counts the capped result
            if not fell:
                self._observe_resident(
                    type_name, cql, t0, _time.perf_counter(), n
                )
            return self._json(200, {"count": n})
        if self._pushdown_eligible(q):
            # store.count answers bbox+time counts from the v2 chunk
            # pre-aggregates (interior chunks never read) and falls back
            # to the row scan internally for anything else
            n = self._sched_run(
                q,
                fn=lambda: self.store.count(
                    type_name, q.get("cql", "INCLUDE")
                ),
            )
            return self._json(200, {"count": int(n)})
        res = self._sched_run(q, fn=lambda: self._query(type_name, q))
        self._json(200, {"count": len(res)})

    def _refresh(self, type_name: str, q: dict) -> None:
        """Restage a type's resident planes from the backing store (call
        after writes — the resident copy is a snapshot by design)."""
        if not self.resident:
            return self._json(
                400, {"error": "server is not running in resident mode"}
            )
        # freshness is decided under the construction lock (inside
        # _build_locked): a build that STARTED before the caller's writes
        # may finish after them, and skipping refresh on that stale
        # snapshot would lose the writes this endpoint exists to surface
        di, built_now = self._build_locked(type_name)
        if not built_now:  # a fresh build already staged post-write state
            di.refresh()
        self._json(200, {"refreshed": type_name, "rows": len(di)})

    def _stats(self, type_name: str, q: dict) -> None:
        spec = q.get("stats")
        if not spec:
            raise ValueError("stats endpoint needs stats=<Stat-DSL spec>")

        def store_work():
            # store rung: run_stats consults the chunk-stat pushdown
            # internally and row-scans what it cannot pre-answer
            from geomesa_tpu_torch.process.statsproc import run_stats
            from geomesa_tpu_torch.query.plan import Query

            return run_stats(
                self.store,
                type_name,
                Query(
                    filter=q.get("cql", "INCLUDE"),
                    hints={"auths": self._auths(q)},
                ),
                spec,
            )

        di = self._di(type_name)
        if di is not None:
            import time as _time

            def device_work():
                t0 = _time.perf_counter()
                cql = q.get("cql", "INCLUDE")
                seq = di.stats(
                    cql, spec, loose=self._loose(q), auths=self._auths(q)
                )
                self._observe_resident(
                    type_name, cql, t0, _time.perf_counter(), 0
                )
                return seq

            seq = self._degradable(
                q, "device-launch-failed", store_work, fn=device_work
            )
        else:
            seq = self._sched_run(q, fn=store_work)
        self._json(200, seq.to_json())

    def _explain(self, type_name: str, q: dict) -> None:
        text = self.store.explain(type_name, q.get("cql", "INCLUDE"))
        self._send(200, text.encode("utf-8"), "text/plain")

    def _density(self, type_name: str, q: dict) -> None:
        from geomesa_tpu_torch.process.density import density

        if "bbox" not in q:
            raise ValueError("density needs bbox=xmin,ymin,xmax,ymax")
        bbox = tuple(float(v) for v in q["bbox"].split(","))
        if len(bbox) != 4:
            raise ValueError("bbox must be xmin,ymin,xmax,ymax")
        width = int(q.get("width", 256))
        height = int(q.get("height", 256))
        from geomesa_tpu_torch.geom import Envelope

        cql = q.get("cql", "INCLUDE")
        env = Envelope(*bbox)

        def store_work():
            # store rung: process.density consults the chunk-histogram
            # pushdown internally (mass-exact, cell placement
            # within coarse-cell tolerance on aligned rasters), records
            # its own metrics (observe_query) and honors the SAME auths
            # the resident path would have
            return density(
                self.store, type_name, cql, env, width, height,
                auths=self._auths(q), device=getattr(self.store, "device", None),
            )

        di = self._di(type_name)
        if di is not None:
            from geomesa_tpu_torch import resilience

            if resilience.brownout(self.scheduler) and \
                    self._agg_shaped(type_name, cql):
                # brownout rung: heatmaps are the classic overload
                # amplifier — answer from the chunk pre-aggregates
                # (mass-exact, placed within the coarse cells) without queueing
                # another device launch behind the saturated scheduler
                resilience.note_degraded("brownout-pushdown")
                grid = store_work()
            else:
                import time as _time

                def device_work():
                    t0 = _time.perf_counter()
                    grid = di.density(
                        cql, env, width, height,
                        loose=self._loose(q), auths=self._auths(q),
                    )
                    if grid is None:
                        # filter/planes not device-expressible: a normal
                        # routing outcome, not a fault — resolved OUTSIDE
                        # _degradable so store-path errors are never
                        # retried/recorded under the DEVICE domain
                        return None
                    # unweighted: the grid mass IS the in-window count
                    self._observe_resident(
                        type_name, cql, t0, _time.perf_counter(),
                        int(round(float(grid.sum()))),
                    )
                    return grid

                grid = self._degradable(
                    q, "device-launch-failed", store_work, fn=device_work
                )
                if grid is None:
                    # the store resolution of a not-device-expressible
                    # filter is NORMAL routing, not an emergency rung:
                    # it goes back through the scheduler's admission
                    # control and deadline like any other unit of work
                    grid = self._sched_run(q, fn=store_work)
        else:
            grid = self._sched_run(q, fn=store_work)
        self._json(
            200,
            {
                "bbox": list(bbox),
                "width": width,
                "height": height,
                "counts": grid.tolist(),
            },
        )


#: the query endpoints the ledger/SLO layer labels by — anything else
#: (typo'd paths that 404, novel routes) collapses into "other" so a
#: URL scanner cannot mint unbounded metric series or ring keys
_KNOWN_ENDPOINTS = frozenset({
    "features", "count", "explain", "density", "stats", "refresh",
    "knn", "tube", "proximity", "capabilities", "append", "wal",
    "subscribe",
})


def _cost_endpoint(parts: list) -> str:
    ep = parts[0] if parts else "-"
    return ep if ep in _KNOWN_ENDPOINTS else "other"


def _query_shape(parts: list, q: dict) -> str:
    """The ledger's query-shape key: endpoint + the filter's leading
    predicate + the loose flag — coarse on purpose (per-tenant detail
    lives in the trace; the shape key exists to group compile/cost
    attribution by KERNEL family, the measurement substrate the
    shape-bucketing work needs). The ledger bounds the key space, so an
    adversarial filter cannot mint unbounded aggregates."""
    endpoint = _cost_endpoint(parts)
    cql = (q.get("cql") or "INCLUDE").strip()
    words = cql.split("(", 1)[0].split()
    head = (words[0].upper()[:16] if words else "INCLUDE") or "INCLUDE"
    if not head.replace("_", "").isalnum():
        head = "EXPR"
    shape = f"{endpoint}:{head}"
    if q.get("loose"):
        shape += ":loose"
    return shape


def _devices_visible() -> int:
    import torch

    return int(torch.cuda.device_count())


def _mesh_serving_enabled(mesh) -> bool:
    """Resolve the mesh-serving switch: an explicit ``make_server``
    argument wins, else the ``mesh.enabled`` conf key; either way the
    mesh path needs more than one visible card (a one-card mesh is
    single-card serving)."""
    from geomesa_tpu_torch.conf import sys_prop

    if mesh is None:
        mesh = bool(sys_prop("mesh.enabled"))
    if not mesh:
        return False
    visible = _devices_visible()
    n = int(sys_prop("mesh.devices")) or visible
    return min(n, visible) > 1


def _make_resident_index(store, type_name: str, streaming: bool = False):
    """One resident index on the store's device (``device="cpu"`` serves
    on the host; anything else resolves to ``cuda:0`` and raises without
    CUDA). With the streaming live layer attached, the buffers are
    pre-sized to the manifest's rows plus ``stream.memtable.rows``, so the
    first streamed appends land as in-place deltas instead of a growth
    restage."""
    from geomesa_tpu_torch.device_cache import StreamingDeviceIndex

    capacity = None
    if streaming:
        from geomesa_tpu_torch.conf import sys_prop

        rows = getattr(store, "manifest_rows", None)
        capacity = int(sys_prop("stream.memtable.rows")) + (
            int(rows(type_name)) if rows else 0
        )
    return StreamingDeviceIndex(
        store, type_name, z_planes=True, capacity=capacity,
        device=getattr(store, "device", None),
    )


def make_server(
    store, host: str = "127.0.0.1", port: int = 0, resident: bool = False,
    warm: bool = False, sched=None, io=None, mesh: "bool | None" = None,
    stream: "bool | None" = None, replica=None,
):
    """Build a ThreadingHTTPServer bound to (host, port); port 0 picks an
    ephemeral port (see ``server.server_address``). ``resident=True``
    serves count/features/stats/density/kNN from device-resident
    ``StreamingDeviceIndex`` caches, staged lazily per type on first
    access on the store's device. ``warm=True`` (resident only) stages
    every type before the server is returned, then runs the warmup over
    them (:mod:`geomesa_tpu_torch.warmup`): in the background under
    ``compile.warmup.enabled``, with ``/readyz`` gated or stamped per
    ``compile.warmup.gate``, else each index's ``warmup()`` inline. A type
    that fails to stage is warned about and served lazily.

    ``sched`` enables the device query scheduler (admission control,
    micro-batch scan fusion, per-tenant fairness): ``True`` for the
    default :class:`~geomesa_tpu_torch.sched.SchedConfig` (the ``sched.*``
    conf keys) or a config instance. Queue-full requests get 429 +
    ``Retry-After``; expired deadlines (``deadlineMs=``) 504.

    ``io`` overrides the store's host-I/O pipeline for partition scans (a
    ``PrefetchConfig`` or a worker count). ``stream`` (or
    ``stream.enabled``) wraps a file-system store in the streaming live
    layer: every serving path reads the merged view, POST ``/append``
    acks at the WAL, and each acked batch folds into staged resident
    indexes as a delta. ``mesh`` serves single-card with one card (see
    ``_mesh_serving_enabled``). With the live layer on, the continuous-query
    push tier (``pubsub.PubSubHub``) rides it: the WAL seq is the delivery
    cursor. ``replica`` raises ``NotImplementedError`` (the replication
    item of ROADMAP)."""
    import os as _os

    from geomesa_tpu_torch import ledger as _ledger
    from geomesa_tpu_torch import slo as _slo
    from geomesa_tpu_torch.tracing import TRACER

    if replica is not None:
        raise NotImplementedError(_REPLICA_LATER)
    _ledger.install()  # compile attribution: the kernel builds
    if resident and _mesh_serving_enabled(mesh):
        raise NotImplementedError(_MESH_LATER)
    if io is not None and hasattr(store, "io"):
        store.io = io
    # the slow-query log lives next to the store's audit log
    # (<root>/_slow_queries.jsonl); memory stores keep traces ring-only
    root_dir = getattr(store, "root", None)
    if root_dir:
        TRACER.slow_log_path = _os.path.join(str(root_dir), "_slow_queries.jsonl")
    scheduler = None
    if sched:
        from geomesa_tpu_torch.sched import QueryScheduler, SchedConfig

        # sched=True defers to SchedConfig.from_props(): the sched.* keys
        scheduler = QueryScheduler(sched if isinstance(sched, SchedConfig) else None)
    # streaming live layer: wrap the store so every serving path — the
    # endpoints AND resident staging — reads the merged view; POST /append
    # goes WAL-first and serves at once. Needs a file-system store (the
    # WAL and the compaction live under its root).
    stream_layer = None
    from geomesa_tpu_torch.store.stream import StreamingStore, streaming_enabled

    stream_on = streaming_enabled() if stream is None else bool(stream)
    if stream_on:
        if not (root_dir and hasattr(store, "_exclusive")):
            import warnings

            warnings.warn(
                "streaming live layer needs a FileSystemDataStore "
                "(a WAL directory under the store root); stream.enabled "
                "ignored for this store"
            )
        else:
            stream_layer = StreamingStore(store, scheduler=scheduler)
            store = stream_layer
    # the continuous-query push tier rides the live layer (the data WAL
    # seq is the delivery cursor); the hub installs its own seq listener
    # and retention floor into the stream
    pubsub_hub = None
    if stream_layer is not None:
        from geomesa_tpu_torch.pubsub import PubSubHub

        pubsub_hub = PubSubHub(stream_layer)
    from geomesa_tpu_torch.conf import sys_prop as _sys_prop
    from geomesa_tpu_torch.locking import checked_lock

    handler = type(
        "BoundHandler",
        (_Handler,),
        {
            "store": store,
            "resident": resident,
            "scheduler": scheduler,
            "stream": stream_layer,
            "pubsub": pubsub_hub,
            "timeout": float(_sys_prop("http.keepalive.s")),
            "_resident_cache": {},
            # first-touch resident builds hold it across store reads and
            # staging by design (a duplicate build would stage twice)
            "_resident_lock": checked_lock("server.resident", blocking_ok=True),
        },
    )
    if resident and warm:
        import warnings

        for tn in store.type_names:
            # a type that fails to stage (a device OOM) must not keep the
            # other types from serving: that type stages on first touch
            try:
                di = _make_resident_index(store, tn, streaming=stream_layer is not None)
            except Exception as e:
                warnings.warn(f"warm staging failed for {tn!r}: {e!r}")
                continue
            handler._resident_cache[tn] = di
        # staging is synchronous (the resident cache is full when
        # make_server returns); the warmup pass runs in a bounded
        # background pool charged to the _system ledger tenant, with
        # /readyz gating or stamping `warming` per compile.warmup.gate
        if handler._resident_cache:
            if bool(_sys_prop("compile.warmup.enabled")):
                from geomesa_tpu_torch import warmup as _warmup

                handler._warmup_started = True
                _warmup.start(dict(handler._resident_cache))
            else:
                # the base legs run inline before traffic is accepted
                for tn, di in handler._resident_cache.items():
                    try:
                        di.warmup()
                    except Exception as e:  # pragma: no cover - warmup() catches its legs
                        warnings.warn(f"warmup failed for {tn!r}: {e!r}")
    # flight recorder: bundles land next to the store's data (memory
    # stores have no root — the recorder keeps a directory a caller set);
    # sched/store/mesh/stream snapshots register as bundle providers
    providers: dict = {}
    if scheduler is not None:
        providers["sched"] = scheduler.snapshot
    if hasattr(store, "store_stats"):
        providers["store"] = store.store_stats

    providers["mesh"] = lambda: {"enabled": False, "types": {}}
    if pubsub_hub is not None:
        providers["pubsub"] = pubsub_hub.stats
    if stream_layer is not None:
        providers["stream"] = stream_layer.stream_stats

        def _stream_delta(tname, batch, h=handler):
            """Per-append incremental resident refresh: fold the acked
            batch into an already-staged index (no restage on the ack
            path). The cache probe happens under the construction lock:
            an append acked between a first-touch build's staging and its
            publication waits for the build, then delivers (refresh_delta
            is re-delivery-safe). A failure evicts the index so the next
            query restages a correct copy; the live layer stamps
            ``ingest-degraded`` and the rows keep serving from the merged
            store path either way."""
            with h._resident_lock:
                di = h._resident_cache.get(tname)
            if di is None:
                return  # the first query stages the merged view lazily
            try:
                di.refresh_delta(batch)
            except Exception:
                h._resident_cache.pop(tname, None)
                raise

        stream_layer.add_delta_listener(_stream_delta)
    _slo.FLIGHTREC.configure(
        _os.path.join(str(root_dir), "_flightrec") if root_dir else _slo.FLIGHTREC.dir,
        providers=providers,
    )
    server = _GeomesaHTTPServer((host, port), handler)
    server.scheduler = scheduler  # callers may inspect / shut down
    server.store = store  # the draining shutdown flushes its audit log
    server.stream_layer = stream_layer  # closed by the draining shutdown
    server.pubsub = pubsub_hub  # closed (before the stream) at drain
    return server


def serve_background(
    store, host: str = "127.0.0.1", port: int = 0, resident: bool = False,
    warm: bool = False, sched=None, io=None, mesh: "bool | None" = None,
    stream: "bool | None" = None, replica=None,
):
    """Start serving on a daemon thread; returns (server, thread). Stop
    with ``server.shutdown()``."""
    server = make_server(
        store, host, port, resident=resident, warm=warm, sched=sched,
        io=io, mesh=mesh, stream=stream, replica=replica,
    )
    thread = spawn_thread(server.serve_forever, name="geomesa-serve", context=False)
    thread.start()
    return server, thread
