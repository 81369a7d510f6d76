"""Index API: key ranges, partitions, built indexes.

Copy of ``geomesa_tpu/index/api.py`` (ref: geomesa-index-api
GeoMesaFeatureIndex and IndexKeySpace), trimmed to what the memory
stores' planner and runner read: ``KeyRange``, ``PartitionMeta`` (with the
file-system store's leaf, checksum, chunk statistics and generation) and
``BuiltIndex`` with ``prune``. The mesh's ``ShardMeta`` is left out.
"""

from __future__ import annotations

from dataclasses import dataclass

from geomesa_tpu_torch.features.batch import FeatureBatch


@dataclass(frozen=True)
class KeyRange:
    """Inclusive lexicographic range over sort-key tuples."""

    lo: tuple
    hi: tuple
    contained: bool = False  # True: every key in range satisfies the primary


@dataclass
class PartitionMeta:
    """One sorted partition of a built index (the tablet-split analog)."""

    pid: int
    start: int  # row offset in the sorted index
    stop: int
    key_lo: tuple
    key_hi: tuple
    count: int
    bbox: "tuple[float, float, float, float] | None" = None
    time_range: "tuple[int, int] | None" = None
    leaf: "str | None" = None  # fs partition-scheme directory leaf
    #: the partition FILE's integrity record (fs stores only): {"algo",
    #: "value", "length"}, written at flush, verified per store.verify
    checksum: "dict | None" = None
    #: format v2 chunk statistics (store/chunkstats.ChunkSet; fs stores
    #: only); None = a v1 partition
    chunks: "object | None" = None
    #: the file generation that wrote this partition (fs stores only):
    #: a scan over a pre-flush snapshot reads ITS generation's file
    gen: "str | None" = None

    def overlaps(self, r: KeyRange) -> bool:
        return not (r.hi < self.key_lo or r.lo > self.key_hi)


@dataclass
class BuiltIndex:
    """A fully built (sorted + partitioned) index over a feature set."""

    keyspace: object
    batch: FeatureBatch  # sorted by key columns
    keys: dict  # {key_column: sorted np.ndarray}
    partitions: "list[PartitionMeta]"

    @property
    def n(self) -> int:
        return len(self.batch)

    def prune(self, ranges: "list[KeyRange] | None") -> "list[PartitionMeta]":
        """Partitions whose key span overlaps any range (all if None)."""
        if ranges is None:
            return list(self.partitions)
        out = []
        for p in self.partitions:
            for r in ranges:
                if p.overlaps(r):
                    out.append(p)
                    break
        return out
