"""BatchStore: a minimal store over one in-memory FeatureBatch.

Counterpart of ``geomesa_tpu/store/direct.py`` (``BatchStore``): it holds
only the batch and the schema, so ``DeviceIndex(BatchStore(batch), name)``
stages directly with no host index build. Only full scans (Include) are
served; filtered queries belong to the DeviceIndex staged on top.
``write`` appends rows, as ``MemoryDataStore.write`` of the counterpart
does for one type: a streaming index's restage reads them back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast


@dataclass
class QueryResult:
    batch: FeatureBatch
    scanned: int
    total: int


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

    def query(
        self, type_name: str, f: ast.Filter = ast.Include, auths=None,
        raw_visibility: bool = False,
    ) -> QueryResult:
        """Full scan. Rows whose visibility label ``auths`` cannot see are
        dropped (``None``/``()``: labeled rows hide, fail closed) unless
        ``raw_visibility=True`` -- the resident cache's staging scan, which
        enforces visibility per request itself."""
        if type_name != self.type_name:
            raise KeyError(type_name)
        if f is not ast.Include:
            raise NotImplementedError(
                "BatchStore serves full scans only; stage a DeviceIndex on "
                "top for filtered queries. The filtered store path is not in "
                "the port yet: ROADMAP, port queue item 5, the store-path scan "
                "(query/plan.py, query/runner.py)"
            )
        batch = self.batch
        if not raw_visibility:
            from geomesa_tpu_torch.security import filter_by_visibility

            keep = filter_by_visibility(batch, auths)
            if keep is not None:
                batch = batch.take(np.nonzero(keep)[0])
        return QueryResult(batch=batch, scanned=len(batch), total=len(self.batch))
