"""BatchStore: a minimal read-only store over one in-memory FeatureBatch.

Counterpart of ``geomesa_tpu/store/direct.py`` (``BatchStore``): it holds
only the batch and the schema, so ``DeviceIndex(BatchStore(batch), name)``
stages directly with no host index build. Only full scans (Include) are
served; filtered queries belong to the DeviceIndex staged on top.
"""

from __future__ import annotations

from dataclasses import dataclass

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast


@dataclass
class QueryResult:
    batch: FeatureBatch
    scanned: int
    total: int


def has_labels(batch: FeatureBatch) -> bool:
    """Whether any row carries a non-empty visibility label."""
    vis = batch.visibilities
    return vis is not None and any(v is not None and str(v) != "" for v in vis)


class BatchStore:
    """Read-only single-type store over a FeatureBatch (no host indexes)."""

    def __init__(self, batch: FeatureBatch, type_name: "str | None" = None):
        self.batch = batch
        self.sft: SimpleFeatureType = batch.sft
        self.type_name = type_name or self.sft.type_name

    @property
    def type_names(self) -> list:
        return [self.type_name]

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        if type_name != self.type_name:
            raise KeyError(type_name)
        return self.sft

    def query(
        self, type_name: str, f: ast.Filter = ast.Include,
        raw_visibility: bool = False,
    ) -> QueryResult:
        """Full scan. Labeled rows are returned only with
        ``raw_visibility=True`` (the resident cache's staging scan, which
        enforces visibility itself); per-auth filtering is a later slice."""
        if type_name != self.type_name:
            raise KeyError(type_name)
        if f is not ast.Include:
            raise NotImplementedError(
                "BatchStore serves full scans only; stage a DeviceIndex on "
                "top for filtered queries"
            )
        if not raw_visibility and has_labels(self.batch):
            raise NotImplementedError(
                "visibility-labeled rows need per-auth filtering, a later "
                "port slice (ROADMAP, port queue: visibility/auths)"
            )
        n = len(self.batch)
        return QueryResult(batch=self.batch, scanned=n, total=n)

