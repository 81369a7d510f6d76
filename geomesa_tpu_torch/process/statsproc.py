"""Stat-DSL aggregation over query results.

Counterpart of ``geomesa_tpu/process/statsproc.py`` (ref: geomesa-process
StatsProcess and the StatsIterator). The file-system store's chunk
pre-aggregate pushdown (``store.stats_pushdown``) is not in the port.
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
    seq = parse_stat(stat_spec)
    res = store.query(type_name, query)
    seq.observe_batch(res.batch)
    return seq
