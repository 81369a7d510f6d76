"""BatchStore: a minimal store over one in-memory FeatureBatch.

Counterpart of ``geomesa_tpu/store/direct.py`` (``BatchStore``): it holds
only the batch and the schema, so ``DeviceIndex(BatchStore(batch), name)``
stages directly with no host index build. Only full scans (Include) are
served, as in the counterpart; filtered queries belong to the DeviceIndex
staged on top or to a ``MemoryDataStore``. ``query`` takes a ``Query``,
an ECQL string or a filter AST and reads the ``auths`` and
``raw_visibility`` hints. ``write`` appends rows, as
``MemoryDataStore.write`` does for one type: a streaming index's restage
reads them back.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.query.plan import as_query
from geomesa_tpu_torch.query.runner import QueryResult


class BatchStore:
    """Single-type store over a FeatureBatch (no host indexes)."""

    def __init__(self, batch: FeatureBatch, type_name: "str | None" = None):
        self.batch = batch
        self.sft: SimpleFeatureType = batch.sft
        self.type_name = type_name or self.sft.type_name

    def write(self, type_name: str, columns_or_batch, fids=None) -> int:
        """Append rows (a dict of columns, or a FeatureBatch) after the
        batch's; a duplicate fid stays a second row. Returns the rows
        written."""
        if type_name != self.type_name:
            raise KeyError(type_name)
        batch = columns_or_batch
        if not isinstance(batch, FeatureBatch):
            batch = FeatureBatch.from_columns(self.sft, columns_or_batch, fids)
        self.batch = FeatureBatch.concat([self.batch, batch])
        return len(batch)

    @property
    def type_names(self) -> list:
        return [self.type_name]

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        if type_name != self.type_name:
            raise KeyError(type_name)
        return self.sft

    def query(self, type_name: str, query=ast.Include) -> QueryResult:
        """Full scan. Rows whose visibility label the ``auths`` hint cannot
        see are dropped (absent or ``()``: labeled rows hide, fail closed)
        unless the ``raw_visibility`` hint is set -- the resident index's
        staging scan, which enforces visibility per request itself."""
        if type_name != self.type_name:
            raise KeyError(type_name)
        q = as_query(query)
        f = q.filter if q.filter is not None else ast.Include
        if f is not ast.Include:
            raise NotImplementedError(
                "BatchStore serves full scans only; stage a DeviceIndex on "
                "top (or use a real store) for filtered queries"
            )
        batch = self.batch
        if not q.hints.get("raw_visibility"):
            from geomesa_tpu_torch.security import filter_by_visibility

            keep = filter_by_visibility(batch, q.hints.get("auths"))
            if keep is not None:
                batch = batch.take(np.nonzero(keep)[0])
        # no planner ran: there is nothing to explain on a full scan
        return QueryResult(batch=batch, plan=None, scanned=len(batch), total=len(self.batch))
