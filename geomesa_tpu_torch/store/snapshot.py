"""Snapshot pins: the file-system store's garbage-collection keep-set.

Copy of the reader half of ``geomesa_tpu/store/snapshot.py``:
``pinned_paths`` (reference line 211) and the pin-file layout it reads. A
pin is ``<root>/<type>/_pins/<snapshot id>.json``, a snapshot document
whose ``files`` list names, relative to the type directory, every file of
the generation it captured; until the pin is released or ages past
``snapshot.pin.ttl.s`` untouched, the store's sweep keeps those files even
after a newer manifest supersedes them. Pin capture, the snapshot
stream, a process's own active pins (which the TTL spares) and the
download stages of a reprovision come with the replication tier and its
``/snapshot`` endpoint (ROADMAP item 5).
"""

from __future__ import annotations

import json
import logging
import os
import time


class SnapshotFormatError(ValueError):
    """A pin names a path outside its type directory."""


def _safe_rel(rel: str) -> str:
    """Reject path traversal in a pinned file record."""
    if not rel or os.path.isabs(rel):
        raise SnapshotFormatError(f"unsafe snapshot path {rel!r}")
    parts = rel.replace("\\", "/").split("/")
    if any(p in ("", ".", "..") for p in parts):
        raise SnapshotFormatError(f"unsafe snapshot path {rel!r}")
    return os.path.join(*parts)


def _pins_dir(store, type_name: str) -> str:
    return os.path.join(store._dir(type_name), "_pins")


def load_pin(store, type_name: str, snapshot_id: str) -> "dict | None":
    """The pin doc of a snapshot, or None when released or unreadable."""
    path = os.path.join(_pins_dir(store, type_name), snapshot_id + ".json")
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def pinned_paths(store, type_name: str) -> "set[str]":
    """Abspaths of every file a live pin protects (``_gc_stale_parts``
    unions this into its manifest keep-set). Doubles as the pin sweeper:
    pins untouched for ``snapshot.pin.ttl.s`` (their stream is dead) are
    reclaimed, so a SIGKILLed stream delays collection boundedly."""
    from geomesa_tpu_torch.conf import sys_prop

    d = store._dir(type_name)
    pdir = _pins_dir(store, type_name)
    ttl = float(sys_prop("snapshot.pin.ttl.s"))
    now = time.time()  # ages are measured against file mtimes (wall clock)
    out: "set[str]" = set()
    try:
        names = sorted(os.listdir(pdir))
    except OSError:
        names = []
    for f in names:
        if not f.endswith(".json"):
            continue
        sid = f[: -len(".json")]
        path = os.path.join(pdir, f)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue
        if age > ttl:
            try:
                os.unlink(path)
            except OSError:
                continue
            logging.getLogger(__name__).warning(
                "dataset %r: reclaimed orphaned snapshot pin %s (untouched %.1fs > "
                "snapshot.pin.ttl.s=%.1fs)", type_name, sid, age, ttl)
            continue
        doc = load_pin(store, type_name, sid)
        if not doc:
            continue  # unreadable pin: pins nothing, the TTL reclaims it
        for rec in doc.get("files", ()):
            try:
                rel = _safe_rel(str(rec.get("rel", "")))
            except SnapshotFormatError:
                continue
            out.add(os.path.abspath(os.path.join(d, rel)))
    return out
