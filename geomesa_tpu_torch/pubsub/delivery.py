"""The push hub: live fan-out, WAL-cursor replay, exactly-once resume.

Copy of ``geomesa_tpu/pubsub/delivery.py``. The delivery protocol:

- Every alert carries the WAL seq of the append batch that produced it:
  the seq is the delivery cursor.
- A connecting subscriber names its acked watermark (``from=<seq>``, or
  SSE ``Last-Event-ID``). The hub registers the live queue first, then
  replays every WAL record above the watermark (``WriteAheadLog.
  read_from``) through the same fused matcher, then switches to the live
  queue, skipping any queued event at or below the replay's high-water
  mark. Because the queue was armed before the replay scan started, a
  record is either seen by the scan (and deduped out of the queue) or
  enqueued live: never missed, never doubled.
- The live queue is bounded (``sub.queue.events``); a subscriber that
  cannot keep up is torn down (``end: overflow``) and resumes from its
  cursor, so exactly-once survives with the cursor.
- Disconnected cursors pin the data WAL through compactions (the live
  layer's retention floor) for at most ``sub.retain.s``; past that the
  records may compact away and a stale cursor gets ``410`` /
  :class:`CursorGoneError`, the one documented way to lose alerts.

The commit gate: with a ``commit_gate`` set (``callable(type_name) -> int
| None``, the highest seq some follower has applied) the hub holds matched
events (``_pending``) until their seq is at or below that floor, and
:meth:`PubSubHub.commit_advanced` flushes them in seq order; replay stops
below the lowest pending seq. It stays ``None`` until the replication
tier (ROADMAP item 7) arms it; the hub code and its tests are here.

Where the port differs: the push plane serves SSE (GeoJSON) and BIN;
``f=arrow`` answers 406 (ROADMAP section 3, Arrow responses), so the
counterpart's ``arrow_push_chunks`` is left out.
"""

from __future__ import annotations

import json
import logging
import queue
import time
from collections import deque as _deque

from geomesa_tpu_torch import ledger, metrics
from geomesa_tpu_torch.conf import sys_prop
from geomesa_tpu_torch.export import feature_collection
from geomesa_tpu_torch.locking import checked_lock
from geomesa_tpu_torch.pubsub.matcher import SubscriptionMatcher
from geomesa_tpu_torch.pubsub.registry import Subscription, SubscriptionRegistry
from geomesa_tpu_torch.results.stream import bin_stream_chunks

log = logging.getLogger("geomesa_tpu_torch.pubsub")


class CursorGoneError(Exception):
    """The resume cursor points below the compacted tail of the data WAL
    (the subscriber stayed away longer than ``sub.retain.s``). HTTP 410:
    the client re-reads and re-subscribes."""


class _SubConn:
    """One live push connection: a bounded event queue and the delivered
    watermark the retention floor reads."""

    __slots__ = ("q", "dead", "watermark")

    def __init__(self, capacity: int, watermark: int) -> None:
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, capacity))
        self.dead = False
        self.watermark = int(watermark)

    def offer(self, event) -> None:
        if self.dead:
            return
        try:
            self.q.put_nowait(event)
        except queue.Full:
            # a slow consumer: tear down rather than block the ingest path
            # or grow without bound; the cursor makes this safe
            self.dead = True
            metrics.pubsub_stream_overflows.inc()

    def poison(self) -> None:
        try:
            self.q.put_nowait(None)
        except queue.Full:
            pass  # a full queue wakes the consumer anyway


class PubSubHub:
    """Registry, matcher and delivery, wired into one StreamingStore.

    Locking: ``pubsub.hub`` guards the connection and cursor tables (never
    held across blocking work); ``pubsub.match`` is an ordering lock: it
    serializes matching so that events enqueue in seq order per type, which
    the watermark dedupe depends on (order: match, then hub, then
    registry; nothing takes match inside either)."""

    def __init__(self, stream) -> None:
        self.stream = stream
        self.registry = SubscriptionRegistry(stream.store.root)
        # the layout lives where the store scans: cuda:0, or the CPU a store
        # opened with device="cpu" names
        self.matcher = SubscriptionMatcher(self.registry, device=getattr(stream.store, "device", None))
        self._lock = checked_lock("pubsub.hub")
        self._match_lock = checked_lock("pubsub.match", blocking_ok=True)
        self._conns: dict = {}  # sub_id -> [_SubConn, ...]
        self._cursors: dict = {}  # sub_id -> (watermark seq, monotonic t)
        self._stash: dict = {}  # type -> {seq: batch} reorder buffer
        self._last: dict = {}  # type -> highest contiguously matched seq
        self._closed = False
        self.matched_records = 0
        self.match_faults = 0
        self.rearms = 0
        #: the commit gate: ``callable(type_name) -> int | None``; None
        #: delivers at once
        self.commit_gate = None
        self._pending: dict = {}  # type -> deque[(seq, batch, matches)]
        self.commit_drops = 0
        # subscriptions recovered from the registry WAL pin the WAL at their
        # creation seq until sub.retain.s ages them out
        now = time.monotonic()
        for doc in self.registry.list():
            self._cursors[doc["id"]] = (int(doc["createdSeq"]), now)
        stream.add_seq_listener(self.on_record)
        stream.add_retention_floor(self.retention_floor)

    # -- subscription CRUD -------------------------------------------------

    def subscribe(self, type_name: str, doc: dict, *, tenant, auths) -> dict:
        sft = self.stream.store.get_schema(type_name)  # KeyError -> 404
        wal = self.stream._ts(type_name).wal
        sub = Subscription.parse(type_name, doc, sft, tenant=tenant, auths=auths,
                                 created_seq=wal.next_seq - 1)
        seq = self.registry.subscribe(sub)
        with self._lock:
            self._cursors[sub.sub_id] = (sub.created_seq, time.monotonic())
        return {"id": sub.sub_id, "type": type_name, "cursor": sub.created_seq,
                "registrySeq": seq}

    def cancel(self, sub_id: str) -> bool:
        ok = self.registry.unsubscribe(sub_id)
        with self._lock:
            self._cursors.pop(sub_id, None)
            conns = list(self._conns.get(sub_id, ()))
        for c in conns:
            c.poison()  # their loops see the registry miss and end
        return ok

    # -- ingest-side matching (the stream's seq listener) -------------------

    def on_record(self, type_name: str, batch, seq: int) -> None:
        if self._closed:
            return
        with self._match_lock:
            ready = self._drain_in_order(type_name, batch, seq)
            for s, b in ready:
                try:
                    self._match_record(type_name, b, s)
                except Exception:
                    # a match fault never un-acks the append: it is counted
                    # and logged, and the cursor replay re-derives the
                    # alerts; nothing is answered from anywhere else
                    self.match_faults += 1
                    log.warning("pubsub match fault on %s seq=%d", type_name, s, exc_info=True)

    def _drain_in_order(self, type_name: str, batch, seq: int) -> list:
        """The contiguity reorder buffer: the seq listener fires outside the
        memtable lock, so two appends can notify swapped; a record waits for
        its predecessor so that queues fill in seq order per type."""
        last = self._last.get(type_name)
        if last is None:
            # the first record this process sees is trusted as the tail
            self._last[type_name] = seq - 1
            last = seq - 1
        if seq <= last:
            return [(seq, batch)]
        stash = self._stash.setdefault(type_name, {})
        stash[seq] = batch
        ready = []
        while last + 1 in stash:
            last += 1
            ready.append((last, stash.pop(last)))
        self._last[type_name] = last
        if len(stash) > 64:
            # a hole that never fills (a listener fault upstream) must not
            # pin batches forever: flush out of order and move the tail
            for s in sorted(stash):
                ready.append((s, stash.pop(s)))
            self._last[type_name] = max(last, ready[-1][0])
        return ready

    def _match_record(self, type_name: str, batch, seq: int) -> None:
        sft = self.stream.store.get_schema(type_name)
        matches = self.matcher.match(type_name, batch, sft)
        self.matched_records += 1
        if matches and ledger.enabled():
            for sub, rows in matches:
                cost = ledger.RequestCost(tenant=sub.tenant, endpoint="subscribe", lane="ingest",
                                          shape="push-match")
                cost.status = 200
                cost.charge("sub_matches", float(len(rows)))
                ledger.LEDGER.record(cost)
        if not matches:
            return
        gate = self.commit_gate
        if gate is not None:
            floor = gate(type_name)
            with self._lock:
                dq = self._pending.get(type_name)
                if dq or (floor is not None and seq > floor):
                    # not yet replication-durable (or FIFO behind one that is
                    # not): held until the commit floor advances
                    if dq is None:
                        dq = self._pending.setdefault(type_name, _deque())
                    dq.append((seq, batch, matches))
                    cap = 4 * int(sys_prop("sub.queue.events"))
                    while len(dq) > cap:
                        # the quorum is gone and ingest runs on: shed the
                        # oldest, which the cursor replay brings back
                        dq.popleft()
                        self.commit_drops += 1
                    return
        self._deliver(seq, batch, matches)

    def _deliver(self, seq: int, batch, matches) -> None:
        with self._lock:
            for sub, rows in matches:
                for conn in self._conns.get(sub.sub_id, ()):
                    conn.offer((seq, batch, rows))

    def commit_advanced(self, type_name: "str | None" = None) -> None:
        """The replication commit's kick: flush the held events now at or
        below the commit floor, in seq order, under the match lock (a flush
        and a fresh append never interleave their enqueues)."""
        gate = self.commit_gate
        if gate is None or self._closed:
            return
        with self._match_lock:
            with self._lock:
                types = [type_name] if type_name is not None else list(self._pending)
            for t in types:
                floor = gate(t)
                while True:
                    with self._lock:
                        dq = self._pending.get(t)
                        if not dq or (floor is not None and dq[0][0] > floor):
                            break
                        seq, batch, matches = dq.popleft()
                        if not dq:
                            self._pending.pop(t, None)
                    self._deliver(seq, batch, matches)

    # -- delivery ----------------------------------------------------------

    def cursor_gone(self, type_name: str, from_seq: int) -> bool:
        """True when records above ``from_seq`` have been compacted out of
        the data WAL: the resume would skip them."""
        wal = self.stream._ts(type_name).wal
        first = wal.first_seq()
        if first >= 0:
            return from_seq + 1 < first
        return from_seq < wal.next_seq - 1

    def events(self, type_name: str, sub_id: str, from_seq: int, heartbeat_s: float):
        """A generator of ``("match", seq, matched_batch, rows)`` /
        ``("heartbeat", watermark)`` / ``("end", reason)`` events,
        exactly once above ``from_seq``. Validation is eager: KeyError (an
        unknown subscription) and :class:`CursorGoneError` raise here, at
        the call, so the HTTP layer answers 404/410 before any stream byte
        goes out."""
        sub = self.registry.get(sub_id)
        if sub is None or sub.type_name != type_name:
            raise KeyError("unknown subscription %r for %r" % (sub_id, type_name))
        sft = self.stream.store.get_schema(type_name)
        wal = self.stream._ts(type_name).wal
        if self.cursor_gone(type_name, from_seq):
            raise CursorGoneError(
                "cursor %d predates the compacted WAL tail of %r "
                "(retained at most sub.retain.s after disconnect)" % (from_seq, type_name))
        return self._event_stream(type_name, sub_id, from_seq, heartbeat_s, sub, sft, wal)

    def _event_stream(self, type_name: str, sub_id: str, from_seq: int, heartbeat_s: float,
                      sub, sft, wal):
        """The generator half of :meth:`events`: owns the connection's
        lifecycle (the queue armed before the replay scan, the cursor
        stamped on the way out)."""
        watermark = int(from_seq)
        conn = _SubConn(int(sys_prop("sub.queue.events")), watermark)
        with self._lock:
            self._conns.setdefault(sub_id, []).append(conn)
            self._cursors[sub_id] = (watermark, time.monotonic())
            # the replay stops below the lowest commit-pending seq: records
            # at or above it reach this (armed) queue by the commit flush
            dq = self._pending.get(type_name)
            bound = (int(dq[0][0]) - 1) if dq else None
        try:
            # the replay below the live tail (the queue is armed, so a
            # record lands in exactly one of the two paths; dups dedupe on
            # the seq)
            for seq, payload in wal.read_from(watermark):
                if bound is not None and seq > bound:
                    break
                batch = self.stream._decode(type_name, payload)
                metrics.pubsub_replay_records.inc()
                rows = self._replay_match(sub, type_name, batch, sft)
                watermark = seq
                self._note_progress(sub_id, conn, watermark)
                if rows is not None and len(rows):
                    yield ("match", seq, batch.take(rows), rows)
            # the live tail
            while True:
                if conn.dead:
                    yield ("end", "overflow")
                    return
                if self._closed:
                    yield ("end", "shutdown")
                    return
                if self.registry.get(sub_id) is None:
                    yield ("end", "cancelled")
                    return
                try:
                    ev = conn.q.get(timeout=max(0.05, heartbeat_s))
                except queue.Empty:
                    yield ("heartbeat", watermark)
                    continue
                if ev is None:
                    continue  # poison: re-check closed / cancelled above
                seq, batch, rows = ev
                if seq <= watermark:
                    continue  # the replay pass covered this seq
                watermark = seq
                self._note_progress(sub_id, conn, watermark)
                yield ("match", seq, batch.take(rows), rows)
        finally:
            with self._lock:
                lst = self._conns.get(sub_id)
                if lst is not None and conn in lst:
                    lst.remove(conn)
                    if not lst:
                        self._conns.pop(sub_id, None)
                # the disconnect stamp starts the sub.retain.s clock
                self._cursors[sub_id] = (watermark, time.monotonic())

    def _replay_match(self, sub, type_name, batch, sft):
        """The replay's match is the same fused join (the full layout, one
        join a replayed batch), filtered to the resuming subscription."""
        with self._match_lock:
            matches = self.matcher.match(type_name, batch, sft)
        for s, rows in matches:
            if s.sub_id == sub.sub_id:
                return rows
        return None

    def _note_progress(self, sub_id, conn, watermark: int) -> None:
        conn.watermark = watermark
        with self._lock:
            self._cursors[sub_id] = (watermark, time.monotonic())

    # -- retention ---------------------------------------------------------

    def retention_floor(self, type_name: str):
        """The lowest delivery cursor of this type's subscribers: live
        connections pin at their delivered watermark, disconnected ones
        for at most ``sub.retain.s`` after their last progress."""
        retain_s = float(sys_prop("sub.retain.s"))
        now = time.monotonic()
        with self._lock:
            cursors = dict(self._cursors)
            conns = {sid: list(cs) for sid, cs in self._conns.items()}
        floor = None
        for sid, (seq, t) in cursors.items():
            sub = self.registry.get(sid)
            if sub is None or sub.type_name != type_name:
                continue
            live = conns.get(sid)
            if live:
                seq = min(c.watermark for c in live)
            elif now - t > retain_s:
                continue  # aged out: no longer pins the WAL
            floor = seq if floor is None else min(floor, seq)
        return floor

    # -- observability and lifecycle ---------------------------------------

    def stats(self) -> dict:
        """The ``/stats/pubsub`` document."""
        with self._lock:
            conns = {sid: list(cs) for sid, cs in self._conns.items()}
            cursors = dict(self._cursors)
            pending = sum(len(dq) for dq in self._pending.values())
        subs = []
        for doc in self.registry.list():
            sid = doc["id"]
            try:
                nxt = self.stream._ts(doc["type"]).wal.next_seq
            except KeyError:
                nxt = 0
            live = conns.get(sid, ())
            cur = cursors.get(sid, (doc["createdSeq"],))[0]
            if live:
                cur = min(c.watermark for c in live)
            subs.append({**doc, "connected": len(live), "cursor": int(cur),
                         "lag": max(0, nxt - 1 - int(cur))})
        return {
            "enabled": True,
            "registry": self.registry.stats(),
            "subscriptions": subs,
            "connections": sum(len(v) for v in conns.values()),
            "matched_records": self.matched_records,
            "match_faults": self.match_faults,
            "fused_launches": self.matcher.launches,
            "rearms": self.rearms,
            "commit_gated": self.commit_gate is not None,
            "commit_pending": pending,
            "commit_drops": self.commit_drops,
        }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = [c for lst in self._conns.values() for c in lst]
        for c in conns:
            c.poison()
        self.stream.remove_seq_listener(self.on_record)
        self.stream.remove_retention_floor(self.retention_floor)
        self.registry.close()


# -- wire encodings (the negotiated result formats, push-shaped) ---------------

def sse_chunks(events, type_name: str, sub_id: str):
    """GeoJSON push encoding: one SSE ``match`` event per matched batch
    (``id:`` the WAL-seq cursor, ``data:`` a FeatureCollection with the
    cursor's fields), ``:keepalive`` comments on idle heartbeats. The
    preamble comment flushes the headers before any match exists."""
    yield (":subscribed %s %s\nretry: 1000\n\n" % (type_name, sub_id)).encode()
    for ev in events:
        kind = ev[0]
        if kind == "heartbeat":
            metrics.pubsub_heartbeats.inc()
            yield b":keepalive\n\n"
        elif kind == "match":
            _kind, seq, batch, _rows = ev
            doc = feature_collection(batch)
            doc["seq"] = int(seq)
            doc["subscription"] = sub_id
            doc["featureType"] = type_name
            metrics.pubsub_events_delivered.inc()
            yield ("id: %d\nevent: match\ndata: %s\n\n"
                   % (int(seq), json.dumps(doc, separators=(",", ":")))).encode()
        else:  # ("end", reason)
            yield ("event: end\ndata: %s\n\n" % json.dumps({"reason": ev[1]})).encode()
            return


def bin_push_chunks(events, track_attr: str):
    """BIN push encoding: matched batches as track records. The seq cursor
    has no slot in the 16/24-byte records: a resuming BIN subscriber
    reconnects from its last acked seq with ``from=``."""

    def _batches():
        for ev in events:
            if ev[0] != "match":
                continue
            metrics.pubsub_events_delivered.inc()
            yield ev[2]

    return bin_stream_chunks(_batches(), track_attr)
