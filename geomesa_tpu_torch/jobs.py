"""Bulk jobs over the serving path.

Counterpart of ``geomesa_tpu/jobs.py``, trimmed to
:func:`scheduled_queries`, the batch-lane bulk producer (reference lines
153-195). The ingest, export and re-index jobs wait for the converters
and the KV store (ROADMAP item 5f).
"""

from __future__ import annotations


def scheduled_queries(
    device_index,
    queries,
    scheduler=None,
    op: str = "count",
    loose=None,
    auths=None,
    tenant: str = "jobs",
    deadline_ms=None,
):
    """Run many resident queries as a BULK batch-lane producer: every
    query is submitted before any is awaited, so the scheduler's
    micro-batcher can fold compatible ones into shared device launches,
    and interactive requests keep priority over the whole sweep. Results
    align with ``queries`` and equal the serial per-query execution
    exactly. Without a scheduler the queries run serially in-line.

    Bulk work carries no deadline by default (a sweep queued behind
    sustained interactive traffic must finish, not expire); pass
    ``deadline_ms`` to opt in, and expiry raises ``DeadlineExpired`` from
    the first expired request. Queue-full rejections are retried with a
    short in-process poll."""
    import time

    from geomesa_tpu_torch.sched import LANE_BATCH, FusableQuery, RejectedError

    specs = [FusableQuery(device_index, q, op, loose=loose, auths=auths) for q in queries]
    if scheduler is None:
        return [s.run_serial() for s in specs]
    reqs = []
    for s in specs:
        while True:
            try:
                reqs.append(scheduler.submit(
                    fuse=s, lane=LANE_BATCH, tenant=tenant, deadline_ms=deadline_ms,
                ))
                break
            except RejectedError:
                time.sleep(0.005)  # backpressure: let the queue drain
    return [scheduler.wait(r) for r in reqs]
