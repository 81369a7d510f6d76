"""Stat-DSL aggregation over query results.

Counterpart of ``geomesa_tpu/process/statsproc.py`` (ref: geomesa-process
StatsProcess and the StatsIterator). On a store with chunk pre-aggregates
(the file-system store's partition format v2), Count/MinMax specs with
bbox+time filters and no auths merge the manifest's per-chunk partials
(``store.stats_pushdown``; exact, boundary chunks refined through the
filter scan) instead of materializing the matched rows.
"""

from __future__ import annotations

from geomesa_tpu_torch.stats import SeqStat, parse_stat


def run_stats(
    store, type_name: str, query, stat_spec: str, device_index=None,
    auths=None,
) -> SeqStat:
    """Evaluate a Stat-DSL spec over the features matching the query.

    With a resident ``device_index`` the aggregation fuses into the
    device scan (``DeviceIndex.stats``: stats computed next to the data,
    features never shipped); otherwise the store query materializes the
    matched batch and observes it on the host. ``query`` may be a full
    Query (its auths hint wins) or a bare CQL string / filter AST
    combined with ``auths``."""
    if device_index is not None:
        from geomesa_tpu_torch.process.density import _split_query

        filt, auths = _split_query(query, auths)
        return device_index.stats(filt, stat_spec, auths=auths)
    pushed = getattr(store, "stats_pushdown", None)
    if pushed is not None and not auths:
        from geomesa_tpu_torch.process.density import _split_query
        from geomesa_tpu_torch.query.plan import Query

        filt, q_auths = _split_query(query, auths)
        if not q_auths:
            pd_query = query if isinstance(query, Query) else Query(filter=filt)
            seq = pushed(type_name, pd_query, stat_spec)
            if seq is not None:
                return seq
    seq = parse_stat(stat_spec)
    res = store.query(type_name, query)
    seq.observe_batch(res.batch)
    return seq
