"""Standing-subscription registry with its own WAL.

Copy of ``geomesa_tpu/pubsub/registry.py``. A subscription is a (type,
predicate, tenant) triple: the predicate is any combination of a bbox, an
ECQL attribute filter and a dwithin proximity circle. The registry
persists every mutation as a JSON op record (the counterpart's records,
byte for byte, so a registry root written by either package recovers in
the other) in a dedicated :class:`~geomesa_tpu_torch.store.wal.WriteAheadLog`
under ``<store.root>/_pubsub/wal``, the durability primitive of the data
path, and that WAL ships through ``GET /wal/_pubsub`` (the server's
registry ship).

The registry WAL is never truncated: its volume follows subscription
churn (small JSON records), not data traffic, and keeping every op means
a reader that fell arbitrarily far behind can always catch up from
``from=next_seq``.

Left out: the follower's apply (``apply_replicated`` raises), which needs
the WAL's ``append_at`` of the replication tier (ROADMAP item 7).
"""

from __future__ import annotations

import json
import logging
import os
import uuid
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.conf import sys_prop
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.filter.extract import extract_geometries
from geomesa_tpu_torch.locking import checked_lock
from geomesa_tpu_torch.store.wal import WriteAheadLog

log = logging.getLogger("geomesa_tpu_torch.pubsub")

#: reserved type name the registry WAL ships under on ``GET /wal/<type>``
#: (stores reject feature type names that are not identifiers)
REGISTRY_SHIP_NAME = "_pubsub"

_WORLD = (-180.0, -90.0, 180.0, 90.0)


@dataclass(frozen=True)
class Subscription:
    """One standing continuous query against a feature type."""

    sub_id: str
    type_name: str
    tenant: str = "anonymous"
    bbox: "tuple | None" = None  # (xmin, ymin, xmax, ymax) degrees
    cql: str = ""  # ECQL attribute/spatial residual ("" = none)
    dwithin: "tuple | None" = None  # (x, y, distance) planar degrees
    auths: tuple = ()  # visibility authorizations (fail closed)
    created_seq: int = -1  # data-WAL watermark when armed

    # -- predicate envelope ------------------------------------------------

    def envelope(self) -> np.ndarray:
        """The coarse (4,) search envelope: the intersection of every
        bounded predicate component. This is what the join layout encodes;
        the exact predicates re-run as residuals."""
        x0, y0, x1, y1 = _WORLD
        if self.bbox is not None:
            bx0, by0, bx1, by1 = self.bbox
            x0, y0 = max(x0, bx0), max(y0, by0)
            x1, y1 = min(x1, bx1), min(y1, by1)
        if self.dwithin is not None:
            cx, cy, dist = self.dwithin
            x0, y0 = max(x0, cx - dist), max(y0, cy - dist)
            x1, y1 = min(x1, cx + dist), min(y1, cy + dist)
        if self.cql:
            env = _cql_envelope(self.cql)
            if env is not None:
                x0, y0 = max(x0, env[0]), max(y0, env[1])
                x1, y1 = min(x1, env[2]), min(y1, env[3])
        if x1 < x0 or y1 < y0:  # provably empty predicate
            x0 = y0 = x1 = y1 = float("nan")
        return np.asarray((x0, y0, x1, y1), dtype=np.float64)

    # -- wire form ---------------------------------------------------------

    def to_doc(self) -> dict:
        doc = {
            "id": self.sub_id,
            "type": self.type_name,
            "tenant": self.tenant,
            "auths": list(self.auths),
            "createdSeq": int(self.created_seq),
        }
        if self.bbox is not None:
            doc["bbox"] = list(self.bbox)
        if self.cql:
            doc["cql"] = self.cql
        if self.dwithin is not None:
            doc["dwithin"] = {"x": self.dwithin[0], "y": self.dwithin[1],
                              "distance": self.dwithin[2]}
        return doc

    @staticmethod
    def from_doc(doc: dict) -> "Subscription":
        dw = doc.get("dwithin")
        return Subscription(
            sub_id=str(doc["id"]),
            type_name=str(doc["type"]),
            tenant=str(doc.get("tenant") or "anonymous"),
            bbox=tuple(float(v) for v in doc["bbox"]) if doc.get("bbox") else None,
            cql=str(doc.get("cql") or ""),
            dwithin=(float(dw["x"]), float(dw["y"]), float(dw["distance"])) if dw else None,
            auths=tuple(str(a) for a in doc.get("auths") or ()),
            created_seq=int(doc.get("createdSeq", -1)),
        )

    @staticmethod
    def parse(type_name: str, doc: dict, sft: SimpleFeatureType, *, tenant, auths,
              created_seq: int) -> "Subscription":
        """Validate a client subscription request body into a Subscription.
        Raises ValueError (400) on a malformed or empty predicate."""
        if not isinstance(doc, dict):
            raise ValueError("subscription body must be a JSON object")
        bbox = doc.get("bbox")
        if bbox is not None:
            try:
                bbox = tuple(float(v) for v in bbox)
            except (TypeError, ValueError):
                raise ValueError("bbox must be [xmin, ymin, xmax, ymax]")
            if len(bbox) != 4 or bbox[0] > bbox[2] or bbox[1] > bbox[3]:
                raise ValueError("bbox must be [xmin, ymin, xmax, ymax]")
        cql = str(doc.get("cql") or doc.get("filter") or "")
        if cql:
            parse_ecql(cql)  # validate now; the matcher parses from its cache
        dw = doc.get("dwithin")
        if dw is not None:
            try:
                dw = (float(dw["x"]), float(dw["y"]), float(dw["distance"]))
            except (TypeError, KeyError, ValueError):
                raise ValueError("dwithin must be {x, y, distance}")
            if dw[2] < 0:
                raise ValueError("dwithin distance must be >= 0")
        if bbox is None and not cql and dw is None:
            raise ValueError("subscription needs at least one predicate: bbox, cql or dwithin")
        return Subscription(
            sub_id=uuid.uuid4().hex[:12],
            type_name=type_name,
            tenant=str(tenant or "anonymous"),
            bbox=bbox,
            cql=cql,
            dwithin=dw,
            auths=tuple(auths) if auths is not None else (),
            created_seq=int(created_seq),
        )


def _cql_envelope(cql: str) -> "tuple | None":
    """Union envelope of the filter's spatial bounds, or None when the
    filter does not constrain geometry (attribute-only predicates)."""
    try:
        f = parse_ecql(cql)
    except ValueError:
        return None
    env = None
    for attr in _spatial_attrs(f):
        bounds = extract_geometries(f, attr)
        if bounds.unbounded or not bounds.values:
            continue
        for e, _geom in bounds.values:
            box = (e.xmin, e.ymin, e.xmax, e.ymax)
            if env is None:
                env = box
            else:  # the union across disjuncts and attributes stays conservative
                env = (min(env[0], box[0]), min(env[1], box[1]),
                       max(env[2], box[2]), max(env[3], box[3]))
    return env


def _spatial_attrs(f) -> set:
    out = set()
    if isinstance(f, (ast.BBox, ast.Intersects, ast.DWithin)):
        out.add(f.attr)
    for child in getattr(f, "children", ()) or ():
        out |= _spatial_attrs(child)
    inner = getattr(f, "child", None)
    if inner is not None:
        out |= _spatial_attrs(inner)
    return out


class SubscriptionRegistry:
    """Durable registry of standing subscriptions.

    Mutations append a JSON op record to the registry WAL before the
    in-memory tables change (the data path's ack discipline). ``gen`` bumps
    on every mutation: the matcher keys its encode-once join layout on it.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        self._dir = os.path.join(root, REGISTRY_SHIP_NAME, "wal")
        self._wal = WriteAheadLog(self._dir)
        # ordering the registry WAL's appends is this lock's purpose
        self._lock = checked_lock("pubsub.registry", blocking_ok=True)
        self._subs: dict = {}  # sub_id -> Subscription
        self._by_type: dict = {}  # type_name -> {sub_id: Subscription}
        self._gen = 0
        self._recover()

    # -- durability --------------------------------------------------------

    def _recover(self) -> None:
        n = 0
        for _seq, payload in self._wal.replay():
            self._apply_op(payload)
            n += 1
        if n:
            log.info("pubsub registry recovered %d ops -> %d subscriptions", n, len(self._subs))

    def _apply_op(self, payload: bytes) -> None:
        try:
            op = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            log.warning("pubsub registry skipping undecodable op record")
            return
        kind = op.get("op")
        if kind == "subscribe":
            sub = Subscription.from_doc(op["sub"])
            self._subs[sub.sub_id] = sub
            self._by_type.setdefault(sub.type_name, {})[sub.sub_id] = sub
            self._gen += 1
        elif kind == "unsubscribe":
            sub = self._subs.pop(str(op.get("id")), None)
            if sub is not None:
                self._by_type.get(sub.type_name, {}).pop(sub.sub_id, None)
                self._gen += 1

    # -- mutations ---------------------------------------------------------

    def subscribe(self, sub: Subscription) -> int:
        """Durably register ``sub``; returns the registry WAL seq."""
        payload = json.dumps({"op": "subscribe", "sub": sub.to_doc()}).encode()
        with self._lock:
            cap = int(sys_prop("sub.max.per.type"))
            if len(self._by_type.get(sub.type_name, ())) >= cap:
                raise ValueError("subscription cap reached for %r (sub.max.per.type=%d)"
                                 % (sub.type_name, cap))
            seq = self._wal.append(payload)
            self._apply_op(payload)
        return seq

    def unsubscribe(self, sub_id: str) -> bool:
        with self._lock:
            if sub_id not in self._subs:
                return False
            payload = json.dumps({"op": "unsubscribe", "id": sub_id}).encode()
            self._wal.append(payload)
            self._apply_op(payload)
        return True

    def apply_replicated(self, seq: int, payload: bytes) -> bool:
        """The follower's apply of one shipped op record: it writes the
        record at the leader's seq (``WriteAheadLog.append_at``), which
        comes with the replication tier."""
        raise NotImplementedError(
            "SubscriptionRegistry.apply_replicated needs the WAL's append_at: "
            "ROADMAP item 7, the replication tier")

    # -- reads -------------------------------------------------------------

    @property
    def gen(self) -> int:
        with self._lock:
            return self._gen

    @property
    def next_seq(self) -> int:
        return self._wal.next_seq

    @property
    def wal(self) -> WriteAheadLog:
        return self._wal

    def get(self, sub_id: str):
        with self._lock:
            return self._subs.get(sub_id)

    def for_type(self, type_name: str) -> tuple:
        """Stable-ordered snapshot (registration order): the matcher pairs
        layout row ids with this tuple, so the order is fixed for a given
        generation."""
        with self._lock:
            return tuple(self._by_type.get(type_name, {}).values())

    def list(self, type_name: "str | None" = None) -> list:
        with self._lock:
            return [s.to_doc() for s in self._subs.values()
                    if type_name is None or s.type_name == type_name]

    def count(self, type_name: "str | None" = None) -> int:
        with self._lock:
            if type_name is None:
                return len(self._subs)
            return len(self._by_type.get(type_name, ()))

    def stats(self) -> dict:
        with self._lock:
            by_type = {t: len(m) for t, m in self._by_type.items() if m}
            return {"subscriptions": len(self._subs), "by_type": by_type, "gen": self._gen,
                    "wal": self._wal.stats()}

    def close(self) -> None:
        self._wal.close()
