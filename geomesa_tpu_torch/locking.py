"""Inter-process locking for shared storage roots.

Copy of ``geomesa_tpu/locking.py`` (ref: geomesa-utils
``DistributedLocking``): the coordination scope is a shared POSIX
filesystem, so the lock is ``flock(2)`` on a sentinel file in the store
root, exclusive for rewrites of partition files and shared for readers
that must not observe a half-rewritten directory.

flock is advisory and per open-file-description: every acquisition opens
its own fd, so it works across processes and across threads of one
process. The counterpart's lock-order checker (``analysis/lockcheck``)
is not in the port: ``checked_lock`` / ``checked_rlock`` are the plain
``threading`` locks it returns when that checker is off.
"""

from __future__ import annotations

import fcntl
import os
import random
import threading
import time
from contextlib import contextmanager


class LockTimeout(TimeoutError):
    pass


def checked_lock(name: str, *, blocking_ok: bool = False):
    """The port's in-process mutex factory (``name`` and ``blocking_ok``
    document the lock; no checker reads them)."""
    return threading.Lock()


def checked_rlock(name: str, *, blocking_ok: bool = False):
    """Re-entrant flavor of :func:`checked_lock`."""
    return threading.RLock()


@contextmanager
def file_lock(path: str, *, shared: bool = False, timeout_s: float = 60.0,
              poll_s: float = 0.02):
    """Hold ``path`` flock'd (exclusive by default) for the with-body.
    Raises :class:`LockTimeout` when another holder keeps it past
    ``timeout_s``. Exclusive holders record their pid in the sentinel so a
    timeout can name the last writer; the poll sleeps with jitter."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    flags = (fcntl.LOCK_SH if shared else fcntl.LOCK_EX) | fcntl.LOCK_NB
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            try:
                fcntl.flock(fd, flags)
                break
            except (BlockingIOError, InterruptedError):
                if time.monotonic() >= deadline:
                    holder = ""
                    try:
                        with open(path) as fh:
                            holder = fh.read(64).strip()
                    except OSError:
                        pass
                    held = f" (last exclusive holder: pid {holder})" if holder else ""
                    raise LockTimeout(
                        f"lock {path!r} not acquired within {timeout_s}s{held}"
                    ) from None
                time.sleep(poll_s * (1.0 + random.random()))
        if not shared:
            # debuggability only: the pid persists after release as the
            # "last holder"; never let it fail an acquisition
            try:
                os.ftruncate(fd, 0)
                os.pwrite(fd, str(os.getpid()).encode(), 0)
            except OSError:
                pass
        yield
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
