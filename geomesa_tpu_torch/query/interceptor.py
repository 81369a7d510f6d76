"""Query interceptors and planner guard rails.

Copy of ``geomesa_tpu/query/interceptor.py`` (ref: geomesa-index-api
QueryInterceptor): per-schema hooks that rewrite queries before
planning and/or veto plans after (the reference's guard example is the
full-table-scan block). Interceptors are declared in SFT user data as
dotted class paths::

    geomesa.query.interceptors = "my.module.MyInterceptor:other.Hook"

(``:`` separates multiple interceptors so the declaration survives the
comma-delimited SFT spec string round-trip; ``,`` also works when the
user data is built programmatically). Instances are created once per
declaration and cached, so stateful interceptors keep state across
queries. The built-in ``FullTableScanGuard`` activates via the
``query.block.full.table`` system property or the
``geomesa.block.full.table`` SFT user-data flag.
"""

from __future__ import annotations

import importlib

from geomesa_tpu_torch.conf import sys_prop

USER_DATA_KEY = "geomesa.query.interceptors"
BLOCK_SCAN_KEY = "geomesa.block.full.table"


class QueryInterceptor:
    """Subclass hooks; either may be a no-op."""

    def rewrite(self, query, sft):
        """Return a (possibly modified) Query before planning."""
        return query

    def guard(self, plan) -> None:
        """Raise to veto a finished plan."""


class FullTableScanGuard(QueryInterceptor):
    """Vetoes plans that would scan every row (ref the reference's
    block-full-table guard)."""

    def guard(self, plan) -> None:
        # internal/maintenance scans (age-off sweeps, process fallbacks)
        # are exempt, same as MaxFeaturesInterceptor
        if plan.ranges is None and not plan.query.hints.get("internal"):
            raise ValueError(
                f"full-table scan of {plan.sft.type_name!r} blocked "
                f"(filter {plan.filter!r} prunes nothing; disable via the "
                f"query.block.full.table property)"
            )


class MaxFeaturesInterceptor(QueryInterceptor):
    """Applies the global ``query.max.features`` cap to unbounded
    user-facing queries. Internal/maintenance queries (age-off sweeps,
    process candidate scans) opt out via the ``internal`` query hint --
    truncating those would silently corrupt their results."""

    def rewrite(self, query, sft):
        cap = sys_prop("query.max.features")
        if cap and query.max_features is None and not query.hints.get("internal"):
            import dataclasses

            return dataclasses.replace(query, max_features=cap)
        return query


def _load_dotted(path: str):
    mod, _, name = path.strip().rpartition(".")
    if not mod:
        raise ValueError(f"bad interceptor path {path!r}")
    return getattr(importlib.import_module(mod), name)


# instances cached per declaration string (NOT in sft.user_data: anything
# placed there would be serialized with the schema)
_DECLARED_CACHE: dict = {}


def _declared_instances(declared: str) -> list:
    cached = _DECLARED_CACHE.get(declared)
    if cached is None:
        cached = []
        for path in declared.replace(",", ":").split(":"):
            if not path.strip():
                continue
            cls = _load_dotted(path)
            cached.append(cls() if isinstance(cls, type) else cls)
        _DECLARED_CACHE[declared] = cached
    return cached


def interceptors_for(sft) -> list:
    """The interceptor chain for a schema: built-ins (re-evaluated each
    call, so property flips take effect) + user-data-declared classes."""
    chain: list = [MaxFeaturesInterceptor()]
    ud = getattr(sft, "user_data", None)
    if ud is None:
        ud = {}
    if sys_prop("query.block.full.table") or _truthy(ud.get(BLOCK_SCAN_KEY)):
        chain.append(FullTableScanGuard())
    declared = ud.get(USER_DATA_KEY)
    if declared:
        chain.extend(_declared_instances(str(declared)))
    return chain


def _truthy(v) -> bool:
    return v is not None and str(v).strip().lower() in (
        "true", "1", "t", "yes", "on",
    )


def apply_interceptors(chain: list, query, sft):
    for ic in chain:
        query = ic.rewrite(query, sft)
    return query


def guard_plan(chain: list, plan) -> None:
    for ic in chain:
        ic.guard(plan)
