"""SLO engine and flight recorder: windowed latency objectives per
scheduler lane, error-budget burn rates, and postmortem bundles.

Counterpart of ``geomesa_tpu/slo.py``:

- **SLOs.** One per lane (:data:`SLO_NAMES`): ``objective`` fraction of
  requests under ``threshold_ms`` over ``window_s`` (``slo.<lane>.*``
  conf keys). A request is bad when it failed (5xx) or ran past its
  lane's threshold.
- **Windows.** :class:`WindowedHistogram` is a time-rotated ring of
  histogram slots, so percentiles and burn rates cover the last window,
  not the process lifetime. Burn rate over a window = bad fraction /
  error budget; the engine computes the fast (``slo.burn.fast.s``) and
  slow (the SLO's window) pair, and ``burning`` means both exceed 1.
- **Exposure.** ``/stats/slo`` (:meth:`SloEngine.snapshot`), ``/readyz``
  (burning SLOs are degraded detail, never unready) and the
  ``geomesa_slo_*`` metrics, whose latency buckets carry trace-id
  exemplars.
- **Flight recorder.** When the fast burn crosses ``slo.flightrec.burn``,
  a circuit breaker opens or the live layer stalls, the
  :class:`FlightRecorder` writes a bundle (recent traces, the metrics
  exposition, the SLO, ledger and breaker state, the registered
  providers' snapshots) atomically into ``<root>/_flightrec/`` with
  bounded retention (``slo.flightrec.keep``) and per-reason rate limits
  (``slo.flightrec.interval.s``).

Everything is gated by ``slo.enabled``.
"""

from __future__ import annotations

import json
import os
import time
from bisect import bisect_left
from contextlib import contextmanager
from dataclasses import dataclass

from geomesa_tpu_torch.locking import checked_lock

__all__ = [
    "SLO_NAMES",
    "FLIGHT_REASONS",
    "SloDef",
    "SloEngine",
    "WindowedHistogram",
    "FlightRecorder",
    "ENGINE",
    "FLIGHTREC",
    "enabled",
    "on_breaker_open",
    "slo_def",
    "slo_for_lane",
]

#: the SLO name registry: one SLO per scheduler priority lane.
#: Adding an SLO = a name here + its three conf keys in conf._DEFS.
#: ``ingest`` (the streaming-append lane) gets its own budget: sub-ms
#: appends at volume would otherwise dilute the interactive good-ratio
#: and mask a real latency breach from the burn-rate alerts.
SLO_NAMES = ("interactive", "batch", "ingest")

#: the flight-recorder reason registry: bundle directory names
#: and the geomesa_flightrec_bundles_total metric label both come from
#: here, so reasons stay a bounded, greppable enum
FLIGHT_REASONS = (
    "burn-rate", "breaker-open", "manual", "ingest-stall",
    "replica-failover", "replica-demote", "replica-reprovision",
    "pubsub-rearm",
)

#: windowed-histogram bucket bounds (seconds) — finer than the metrics
#: default so p999 at serving latencies is meaningful
WINDOW_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.75,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: ring geometry: the slow window divides into this many slots (60 =>
#: 60s slots for the default 1h window; the 5m fast window then spans
#: an exact 5 slots)
_SLOTS = 60

#: bounded endpoint/lane key space for the windowed histograms
_MAX_SERIES = 32


def enabled() -> bool:
    from geomesa_tpu_torch.conf import sys_prop

    return bool(sys_prop("slo.enabled"))


@dataclass(frozen=True)
class SloDef:
    """One SLO: ``objective`` fraction of requests under
    ``threshold_ms`` over ``window_s`` (the slow burn window)."""

    name: str
    objective: float
    threshold_ms: float
    window_s: float

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


#: name -> its conf keys
_SLO_KEYS = {
    "interactive": (
        "slo.interactive.objective",
        "slo.interactive.threshold.ms",
        "slo.interactive.window.s",
    ),
    "batch": (
        "slo.batch.objective",
        "slo.batch.threshold.ms",
        "slo.batch.window.s",
    ),
    "ingest": (
        "slo.ingest.objective",
        "slo.ingest.threshold.ms",
        "slo.ingest.window.s",
    ),
}


def slo_def(name: str) -> SloDef:
    """Resolve one registered SLO (a :data:`SLO_NAMES` name) from conf."""
    from geomesa_tpu_torch.conf import sys_prop

    keys = _SLO_KEYS[name]
    return SloDef(
        name=name,
        objective=float(sys_prop(keys[0])),
        threshold_ms=float(sys_prop(keys[1])),
        window_s=float(sys_prop(keys[2])),
    )


def slo_for_lane(lane: str) -> SloDef:
    """The SLO governing a scheduler lane (unknown/empty lanes are held
    to the interactive objective — the strict default)."""
    return slo_def(lane if lane in SLO_NAMES else "interactive")


class WindowedHistogram:
    """Time-rotated ring of histogram slots: each slot covers
    ``slot_s`` seconds and holds bucket counts, sum, n and the good/bad
    split. Reading merges the slots inside the asked-for window, so
    percentiles and burn rates reflect the LAST window, not process
    lifetime. ``clock`` is injectable (monotonic seconds) for tests."""

    def __init__(
        self, window_s: float, buckets=WINDOW_BUCKETS,
        slots: int = _SLOTS, clock=time.monotonic,
    ):
        self.window_s = max(float(window_s), 1.0)
        self.slot_s = self.window_s / max(int(slots), 1)
        self.buckets = tuple(buckets)
        self.clock = clock
        n = max(int(slots), 1)
        self._n_slots = n
        # parallel arrays, one entry per ring position
        self._idx = [-1] * n  # absolute slot index occupying the pos
        self._counts = [[0] * (len(self.buckets) + 1) for _ in range(n)]
        self._sum = [0.0] * n
        self._n = [0] * n
        self._bad = [0] * n

    def _pos(self, idx: int) -> int:
        return idx % self._n_slots

    def _slot(self, now: float) -> int:
        return int(now / self.slot_s)

    def observe(self, v: float, bad: bool = False) -> None:
        idx = self._slot(self.clock())
        pos = self._pos(idx)
        if self._idx[pos] != idx:  # ring wrapped: this slot is stale
            self._idx[pos] = idx
            self._counts[pos] = [0] * (len(self.buckets) + 1)
            self._sum[pos] = 0.0
            self._n[pos] = 0
            self._bad[pos] = 0
        self._counts[pos][bisect_left(self.buckets, v)] += 1
        self._sum[pos] += v
        self._n[pos] += 1
        if bad:
            self._bad[pos] += 1

    def merged(self, window_s: "float | None" = None) -> dict:
        """Counts/sum/n/bad merged over the slots inside ``window_s``
        (default: the full ring window), stale slots excluded."""
        w = self.window_s if window_s is None else float(window_s)
        now_idx = self._slot(self.clock())
        k = max(int(round(w / self.slot_s)), 1)
        lo = now_idx - k  # slots (lo, now_idx] are inside the window
        counts = [0] * (len(self.buckets) + 1)
        total = 0.0
        n = 0
        bad = 0
        for pos in range(self._n_slots):
            idx = self._idx[pos]
            if idx <= lo or idx > now_idx:
                continue
            c = self._counts[pos]
            for i in range(len(counts)):
                counts[i] += c[i]
            total += self._sum[pos]
            n += self._n[pos]
            bad += self._bad[pos]
        return {"counts": counts, "sum": total, "n": n, "bad": bad}

    def quantile_ms(
        self, q: float, window_s: "float | None" = None
    ) -> "float | None":
        """Bucket-upper-bound quantile over the window (same estimator
        as a Prometheus ``histogram_quantile``), or None with no data."""
        m = self.merged(window_s)
        n = m["n"]
        if n <= 0:
            return None
        rank = q * n
        cum = 0
        for i, c in enumerate(m["counts"]):
            cum += c
            if cum >= rank and c:
                bound = (
                    self.buckets[i]
                    if i < len(self.buckets)
                    else max(self.buckets[-1], m["sum"] / n)
                )
                return round(bound * 1e3, 3)
        return round(self.buckets[-1] * 1e3, 3)


class SloEngine:
    """Process-wide SLO tracker: per-endpoint/lane windowed latency
    histograms, per-SLO good/bad rings, multi-window burn rates, and
    the burn-triggered flight-recorder hook. The module global
    :data:`ENGINE` is the serving one; tests build their own with a
    fake clock."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._lock = checked_lock("slo.engine")
        self._series: dict = {}  # (endpoint, lane) -> WindowedHistogram
        self._lanes: dict = {}  # slo name -> WindowedHistogram

    def _series_for(self, endpoint: str, lane: str, window_s: float):
        key = (endpoint, lane)
        h = self._series.get(key)
        if h is None:
            if len(self._series) >= _MAX_SERIES:
                key = ("other", lane)
                h = self._series.get(key)
            if h is None:
                h = self._series[key] = WindowedHistogram(
                    window_s, clock=self.clock
                )
        return h

    def _lane_for(self, d: SloDef):
        h = self._lanes.get(d.name)
        if h is None:
            h = self._lanes[d.name] = WindowedHistogram(
                d.window_s, clock=self.clock
            )
        return h

    def fast_window_s(self, d: SloDef) -> float:
        from geomesa_tpu_torch.conf import sys_prop

        return min(float(sys_prop("slo.burn.fast.s")), d.window_s)

    def observe(
        self, endpoint: str, lane: str, dur_s: float,
        error: bool = False, trace_id: str = "",
    ) -> None:
        """Record one finished request against its lane's SLO. Updates
        the windowed rings, the exemplar-carrying metrics, and — when
        the fast-window burn crosses ``slo.flightrec.burn`` — triggers
        the flight recorder (rate-limited inside)."""
        if not enabled():
            return
        d = slo_for_lane(lane)
        # label discipline: the lane label is the RESOLVED SLO name
        # (bounded by SLO_NAMES — a client-supplied ?lane= novelty must
        # not mint metric series or ring keys), and the endpoint is
        # clamped by the server to its known endpoint set
        lane = d.name
        bad = bool(error) or dur_s * 1e3 > d.threshold_ms
        with self._lock:
            self._series_for(endpoint, lane, d.window_s).observe(
                dur_s, bad
            )
            self._lane_for(d).observe(dur_s, bad)
        from geomesa_tpu_torch import metrics

        metrics.slo_latency.observe(
            dur_s,
            exemplar={"trace_id": trace_id} if trace_id else None,
            endpoint=endpoint, lane=lane,
        )
        metrics.slo_requests.inc(slo=d.name)
        if bad:
            metrics.slo_bad.inc(slo=d.name)
        burn_fast = self.burn(d, self.fast_window_s(d))
        metrics.slo_burn.set(burn_fast, slo=d.name, window="fast")
        from geomesa_tpu_torch.conf import sys_prop

        trip = float(sys_prop("slo.flightrec.burn"))
        if trip > 0 and burn_fast >= trip:
            FLIGHTREC.trigger(
                "burn-rate",
                detail={
                    "slo": d.name,
                    "burn_fast": round(burn_fast, 3),
                    "threshold": trip,
                    "objective": d.objective,
                    "threshold_ms": d.threshold_ms,
                },
            )

    def burn(self, d: SloDef, window_s: float) -> float:
        """Burn rate over ``window_s``: observed bad fraction over the
        error budget. 0 with no traffic (no news is good news)."""
        with self._lock:
            h = self._lanes.get(d.name)
            m = h.merged(window_s) if h is not None else None
        if not m or m["n"] <= 0:
            return 0.0
        return (m["bad"] / m["n"]) / d.budget

    def burning(self) -> "list[str]":
        """SLO names burning on BOTH windows (the /readyz detail)."""
        out = []
        for name in SLO_NAMES:
            d = slo_def(name)
            if (
                self.burn(d, self.fast_window_s(d)) > 1.0
                and self.burn(d, d.window_s) > 1.0
            ):
                out.append(name)
        return out

    def snapshot(self) -> dict:
        """The ``/stats/slo`` document."""
        doc: dict = {"enabled": enabled(), "slos": {}, "series": {}}
        if not enabled():
            return doc
        from geomesa_tpu_torch import metrics

        for name in SLO_NAMES:
            d = slo_def(name)
            fast_s = self.fast_window_s(d)
            burn_fast = self.burn(d, fast_s)
            burn_slow = self.burn(d, d.window_s)
            metrics.slo_burn.set(burn_fast, slo=name, window="fast")
            metrics.slo_burn.set(burn_slow, slo=name, window="slow")
            with self._lock:
                h = self._lanes.get(name)
                m = h.merged(d.window_s) if h is not None else None
            doc["slos"][name] = {
                "objective": d.objective,
                "threshold_ms": d.threshold_ms,
                "window_s": d.window_s,
                "requests": m["n"] if m else 0,
                "bad": m["bad"] if m else 0,
                "burn": {
                    "fast": {"window_s": fast_s, "rate": round(burn_fast, 4)},
                    "slow": {
                        "window_s": d.window_s, "rate": round(burn_slow, 4)
                    },
                },
                "burning": burn_fast > 1.0 and burn_slow > 1.0,
            }
        # ring reads happen UNDER the engine lock: observe() mutates
        # the same slot arrays concurrently and a torn read could pair
        # one slot's counts with another's totals
        with self._lock:
            for (endpoint, lane), h in sorted(self._series.items()):
                m = h.merged()
                doc["series"][f"{endpoint}|{lane}"] = {
                    "requests": m["n"],
                    "bad": m["bad"],
                    "p50_ms": h.quantile_ms(0.5),
                    "p99_ms": h.quantile_ms(0.99),
                    "p999_ms": h.quantile_ms(0.999),
                }
        return doc

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._lanes.clear()


# -- flight recorder --------------------------------------------------------


class FlightRecorder:
    """Postmortem bundle writer. Disabled until :meth:`configure` gives
    it a directory (make_server wires ``<store root>/_flightrec``);
    ``providers`` maps bundle file stems to zero-arg snapshot callables
    the server registers (sched/store/mesh stats)."""

    def __init__(self):
        self._lock = checked_lock("slo.flightrec")
        self.dir: "str | None" = None
        self.providers: dict = {}
        self._last: dict = {}  # reason -> last trigger monotonic
        self._seq = 0
        self.bundles = 0  # lifetime bundles written (tests/stats)

    def configure(self, directory: "str | None", providers=None) -> None:
        with self._lock:
            self.dir = directory
            if providers:
                self.providers.update(providers)

    def _interval_s(self) -> float:
        from geomesa_tpu_torch.conf import sys_prop

        return float(sys_prop("slo.flightrec.interval.s"))

    def _keep(self) -> int:
        from geomesa_tpu_torch.conf import sys_prop

        return max(int(sys_prop("slo.flightrec.keep")), 1)

    def trigger(self, reason: str, detail=None) -> "str | None":
        """Snapshot a bundle for ``reason`` (a :data:`FLIGHT_REASONS`
        name; unknown reasons are
        recorded as ``manual``). Returns the bundle path, or None when
        disabled / rate-limited. Never raises: the recorder must not
        break the serving path it observes."""
        if reason not in FLIGHT_REASONS:
            detail = {"requested_reason": reason, "detail": detail}
            reason = "manual"
        with self._lock:
            if self.dir is None or not enabled():
                return None
            now = time.monotonic()
            last = self._last.get(reason)
            if last is not None and now - last < self._interval_s():
                return None
            self._last[reason] = now
            self._seq += 1
            seq = self._seq
            directory = self.dir
            providers = dict(self.providers)
        try:
            return self._write_bundle(directory, reason, detail, seq,
                                      providers)
        except Exception:  # pragma: no cover - never break serving
            return None

    def _write_bundle(
        self, directory: str, reason: str, detail, seq: int, providers
    ) -> str:
        from geomesa_tpu_torch import metrics, resilience
        from geomesa_tpu_torch.ledger import LEDGER
        from geomesa_tpu_torch.metrics import REGISTRY
        from geomesa_tpu_torch.tracing import TRACER

        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        name = f"{stamp}-{seq:04d}-{reason}"
        tmp = os.path.join(directory, f".tmp-{os.getpid()}-{seq}")
        final = os.path.join(directory, name)
        os.makedirs(tmp, exist_ok=True)

        def dump(stem: str, doc) -> None:
            with open(os.path.join(tmp, stem), "w") as fh:
                if isinstance(doc, str):
                    fh.write(doc)
                else:
                    json.dump(doc, fh, indent=1, default=str)

        dump("reason.json", {
            "reason": reason,
            "detail": detail,
          
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
        })
        recent = TRACER.recent(50)
        full = [
            t.to_dict()
            for t in (TRACER.get(s["trace_id"]) for s in recent[:10])
            if t is not None
        ]
        dump("traces.json", {"recent": recent, "full": full})
        dump("metrics.prom", REGISTRY.prometheus_text())
        dump("slo.json", ENGINE.snapshot())
        dump("ledger.json", LEDGER.snapshot())
        dump("breakers.json", resilience.snapshot())
        for stem, fn in providers.items():
            try:
                dump(f"{stem}.json", fn())
            except Exception:  # a dead provider must not kill the bundle
                dump(f"{stem}.json", {"error": "provider failed"})
        os.rename(tmp, final)  # atomic publish: readers never see a half-bundle
        with self._lock:
            self.bundles += 1
        metrics.flightrec_bundles.inc(reason=reason)
        self._prune(directory)
        return final

    def _prune(self, directory: str) -> None:
        """Bounded retention: keep the newest ``slo.flightrec.keep``
        bundles (name-sorted — stamps make names chronological)."""
        import shutil

        keep = self._keep()
        try:
            entries = sorted(
                e for e in os.listdir(directory)
                if not e.startswith(".tmp-")
                and os.path.isdir(os.path.join(directory, e))
            )
        except OSError:
            return
        for stale in entries[:-keep] if len(entries) > keep else []:
            shutil.rmtree(os.path.join(directory, stale),
                          ignore_errors=True)

    def bundle_names(self) -> "list[str]":
        with self._lock:
            directory = self.dir
        if not directory:
            return []
        try:
            return sorted(
                e for e in os.listdir(directory)
                if not e.startswith(".tmp-")
            )
        except OSError:
            return []

    def reset(self) -> None:
        with self._lock:
            self.dir = None
            self.providers.clear()
            self._last.clear()
            self._seq = 0
            self.bundles = 0


ENGINE = SloEngine()
FLIGHTREC = FlightRecorder()


def on_breaker_open(domain: str) -> None:
    """Resilience hook: a circuit breaker opened — snapshot a bundle
    naming the domain (called OUTSIDE the breaker lock; rate limiting
    and the enabled/dir gates live in :meth:`FlightRecorder.trigger`)."""
    FLIGHTREC.trigger("breaker-open", detail={"domain": domain})


@contextmanager
def fresh_engine(clock=time.monotonic):
    """Swap a fresh :class:`SloEngine` in as the module global for the
    with-body (tests: fake clocks without touching serving state)."""
    global ENGINE
    prev = ENGINE
    ENGINE = SloEngine(clock=clock)
    try:
        yield ENGINE
    finally:
        ENGINE = prev
