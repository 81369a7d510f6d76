"""File-system DataStore: partition files plus a JSON manifest.

Copy of ``geomesa_tpu/store/fs.py`` (ref: geomesa-fs FileSystemDataStore,
storage/api/PartitionScheme and its Parquet/ORC storages): data lives as
sorted partition files plus a manifest; queries prune partitions by the
partition scheme and the manifest's key bounds, and scan each surviving
file on ``device`` (``cuda:0`` unless the caller passes ``"cpu"``) through
the runner, one filter-scan mask launch per partition.

Layout under ``root/<type_name>/``:

- ``schema.json``     -- SFT spec + primary index + partition metadata
- ``schema.json.gen`` -- tiny staleness sidecar (the manifest generation)
- ``part-<gen>-NNNNN.gmcol`` -- sorted partition files, generation-scoped
  (un-scoped ``part-NNNNN.*`` names of older manifests still read)

The files are the port's own columnar format (``store/partfile.py``): the
port's hosts have no ``pyarrow``, so the port neither reads nor writes the
counterpart's Parquet or ORC. The manifest (its fields as ``_save_meta``
writes them) and the generation, checksum, quarantine and recovery
protocol are the counterpart's (ROADMAP section 3).

Crash consistency (write-new-then-publish): every flush writes a NEW
generation of partition files next to the old one, fsyncs file contents
and directories, atomically publishes the manifest (itself fsynced), and
only then collects the previous generation -- a ``kill -9`` at any instant
leaves a store that reopens to exactly the old or the new state.
Interrupted-flush leftovers are reclaimed by the recovery sweep at open
(:meth:`FileSystemDataStore.recover`). Each partition file carries a
checksum and byte length in the manifest, verified per ``store.verify``
(``off``/``open``/``always``); a corrupt file quarantines ONLY that
partition (:class:`PartitionCorruptError`) while the rest keep serving.
The ``fail.flush.*``/``fail.read.*`` failpoints are evaluated at the
counterpart's steps.

A partition whose read fails (retries spent, checksum bad, or its keyed
circuit breaker open) is skipped by ``query`` when a request's
degradation collector is installed, and the answer is stamped
``partition-unavailable``; without a collector (a library or CLI caller),
and in ``query_partitions``, it raises the typed, partition-scoped
``resilience.PartitionUnavailableError``, as the counterpart does.

Where the port differs: the ``mesh`` argument raises (the device build is
ROADMAP item 7); the out-of-core reader ``_read_partition_prefetch`` comes
with item 6.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.api import BuiltIndex, PartitionMeta
from geomesa_tpu_torch.index.build import DEFAULT_PARTITION_SIZE, build_index
from geomesa_tpu_torch.index.keyspaces import default_indices, keyspace_for
from geomesa_tpu_torch.query.plan import Query, QueryPlan, as_query, plan_query
from geomesa_tpu_torch.query.runner import QueryResult, run_query
from geomesa_tpu_torch.store import partfile
from geomesa_tpu_torch.store.partfile import checksum_bytes, verify_bytes

_log = logging.getLogger(__name__)

#: the counterpart's encodings, which the port can neither read nor write
_FOREIGN = ("parquet", "orc")


def _foreign_encoding(encoding: str, where: str) -> ValueError:
    return ValueError(
        f"{where}: encoding {encoding!r} is the JAX package's pyarrow format; "
        f"the port's file-system store reads and writes only "
        f"{partfile.ENCODING!r} (ROADMAP section 3, the file format)"
    )


@dataclass
class _FsTypeState:
    sft: SimpleFeatureType
    primary: str
    partitions: "list[PartitionMeta]" = field(default_factory=list)
    pending: "list[FeatureBatch]" = field(default_factory=list)
    data_interval: "tuple[int, int] | None" = None
    #: decoded partitions pinned by reads, keyed (generation, pid)
    cache: dict = field(default_factory=dict)
    encoding: str = partfile.ENCODING
    scheme: "object | None" = None  # PartitionScheme, from SFT user data
    stats: "object | None" = None  # SeqStat rebuilt at flush, persisted
    generation: "str | None" = None  # manifest token last read/written
    #: generation token in the partition FILE names (part-<gen>-NNNNN.*);
    #: None = un-scoped names
    file_gen: "str | None" = None
    #: manifest format version (chunkstats.FORMAT_V1/V2): v2 partitions
    #: carry per-chunk statistics and chunk blocks aligned to them; any
    #: rewrite re-publishes at ``store.format.version``
    format_version: int = 1
    #: pre-generation manifests only: a flush failed AFTER unlinking its
    #: files, so the rows exist only in that writer's memory; readers of
    #: such a manifest fail loudly. New flushes never set this.
    dirty: bool = False
    #: process-local per-partition quarantine: pid -> checksum error
    quarantined: "dict[int, str]" = field(default_factory=dict)
    #: highest WAL sequence folded into the published generation (the
    #: streaming layer's watermark, persisted atomically with the manifest)
    wal_watermark: int = -1


class PartitionCorruptError(RuntimeError):
    """A partition file failed checksum verification (or was already
    quarantined). Scoped to ONE partition: queries pruned away from it keep
    serving; queries touching it fail loudly instead of dropping rows."""


def _write_file(path: str, data, fsync: bool) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # os.write may land fewer bytes than asked: loop
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(d: str) -> None:
    """Durably record a directory's entries. Best effort: some filesystems
    refuse directory fsync; the file-content fsyncs still stand."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_part_file(batch, start: int, stop: int, path: str, fsync: bool,
                     chunk_rows=None) -> "tuple[dict, list | None]":
    """Write rows [start, stop) of a sorted batch as one partition file,
    durably: encode, checksum, one write (+fsync). Returns the checksum
    record and, with ``chunk_rows`` (v2), each chunk block's byte size."""
    data, blocks = partfile.encode_rows(batch, start, stop, chunk_rows)
    algo, value = checksum_bytes(data)
    _write_file(path, data, fsync)
    return {"algo": algo, "value": value, "length": len(data)}, (blocks if chunk_rows else None)


class _Sized:
    """Audit shim for pushdown-served aggregates: observe_query only needs
    ``len(result)``."""

    def __init__(self, n: int):
        self._n = int(n)

    def __len__(self) -> int:
        return self._n


class _PartFailure:
    """What a guarded partition read returns instead of raising, so the
    prefetch pipeline keeps flowing; the consumer raises the typed,
    partition-scoped error at the partition's place."""

    __slots__ = ("p", "error")

    def __init__(self, p, error):
        self.p = p
        self.error = error


def _unavailable(type_name: str, failure: _PartFailure):
    from geomesa_tpu_torch import resilience

    return resilience.PartitionUnavailableError(type_name, failure.p.pid, str(failure.error))


class _PresizedSink:
    """Streaming assembly of a FULL-scan result into buffers pre-sized from
    the manifest's row counts: each partition batch is copied into its
    slice as it arrives and dropped, so the peak is one dataset copy plus
    the in-flight prefetch items (not two, as collect-then-concatenate).
    Buffers grow (manifest drift) and trim defensively."""

    def __init__(self, sft, total: int):
        self.sft = sft
        self.cap = int(total)
        self.filled = 0
        self._cols: "dict | None" = None
        self._fids = None

    def _alloc(self, like: np.ndarray, fill=None) -> np.ndarray:
        buf = np.empty((self.cap,) + like.shape[1:], dtype=like.dtype)
        if fill is not None:
            buf[: self.filled] = fill
        return buf

    def _grow(self, need: int) -> None:
        self.cap = max(self.cap * 2, need)
        for k, v in self._cols.items():
            nb = np.empty((self.cap,) + v.shape[1:], dtype=v.dtype)
            nb[: self.filled] = v[: self.filled]
            self._cols[k] = nb
        nf = np.empty(self.cap, dtype=self._fids.dtype)
        nf[: self.filled] = self._fids[: self.filled]
        self._fids = nf

    def add(self, batch: FeatureBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        if self._cols is None:
            self.cap = max(self.cap, n)
            self._cols = {k: self._alloc(v) for k, v in batch.columns.items()}
            self._fids = self._alloc(batch.fids)
        if self.filled + n > self.cap:
            self._grow(self.filled + n)
        a, b = self.filled, self.filled + n
        for k, buf in self._cols.items():
            v = batch.columns.get(k)
            if v is None:
                if k != VIS_COLUMN:
                    raise KeyError(f"column {k!r} missing from a partition")
                v = np.array([""] * n, dtype=object)
            if not np.can_cast(v.dtype, buf.dtype, casting="same_kind"):
                # keep trailing dims (the (n, 2) point columns)
                promoted = self._alloc(
                    np.empty((0,) + buf.shape[1:], np.promote_types(buf.dtype, v.dtype)))
                promoted[:a] = buf[:a]
                self._cols[k] = buf = promoted
            buf[a:b] = v
        for k in batch.columns:
            if k not in self._cols:
                # a later partition introduces visibility labels: earlier
                # rows are public (""), as concat() has it
                self._cols[k] = self._alloc(batch.columns[k], fill="")
                self._cols[k][a:b] = batch.columns[k]
        if not np.can_cast(batch.fids.dtype, self._fids.dtype, casting="same_kind"):
            nf = np.empty(self.cap, np.promote_types(self._fids.dtype, batch.fids.dtype))
            nf[:a] = self._fids[:a]
            self._fids = nf
        self._fids[a:b] = batch.fids
        self.filled = b

    def finish(self) -> "FeatureBatch | None":
        if self._cols is None:
            return None
        n = self.filled
        return FeatureBatch(self.sft, self._fids[:n], {k: v[:n] for k, v in self._cols.items()})


class FileSystemDataStore:
    def __init__(
        self,
        root: str,
        partition_size: int = DEFAULT_PARTITION_SIZE,
        audit: bool = False,
        encoding: str = partfile.ENCODING,
        mesh=None,
        io=None,
        device=None,
    ):
        """``io``: host-I/O pipeline config for multi-partition reads (a
        PrefetchConfig, an int worker count, or None for the ``io.*``
        system properties; 0 = serial reads). ``device``: where scans run
        (``cuda:0`` unless ``"cpu"``), resolved at the first scan.
        ``mesh`` must be None: the device index build and the mesh are
        ROADMAP item 7."""
        from geomesa_tpu_torch.locking import checked_rlock

        if mesh is not None:
            raise NotImplementedError(
                "FileSystemDataStore(mesh=...): the device index build and the mesh "
                "are not in the port yet (ROADMAP, port queue item 7)")
        if encoding in _FOREIGN:
            raise _foreign_encoding(encoding, "FileSystemDataStore")
        if encoding != partfile.ENCODING:
            raise ValueError(f"unsupported encoding {encoding!r}")
        self.root = root
        self.partition_size = partition_size
        self.io = io
        self.device = device
        self.encoding = encoding
        self._types: dict[str, _FsTypeState] = {}
        os.makedirs(root, exist_ok=True)
        # one flock sentinel per store root: exclusive for rewrites, shared
        # for file reads, so a reader never sees a half-rewritten directory
        self._lock_path = os.path.join(root, ".lock")
        self._lock_tl = threading.local()
        # flock serializes PROCESSES; this RLock serializes this process's
        # THREADS (_refresh_from_disk mutates shared state in place).
        # Maintenance holds it across partition file I/O by design.
        self._mem_lock = checked_rlock("store.fs.mem", blocking_ok=True)
        self.audit_writer = None
        #: what the open-time recovery sweep reclaimed, per type, folded
        #: into the next explicit recover()
        self._open_recovery: dict = {}
        if audit:  # the <catalog>_queries table analog
            from geomesa_tpu_torch.audit import FileAuditWriter

            self.audit_writer = FileAuditWriter(os.path.join(root, "_queries.jsonl"))
        for name in sorted(os.listdir(root)):
            if os.path.exists(os.path.join(root, name, "schema.json")):
                self._load_type(name)
        self._recover_on_open()

    def _recover_on_open(self) -> None:
        """Crash recovery at open: under the exclusive lock, reclaim
        interrupted-flush leftovers and repair a lagging generation
        sidecar; ``store.verify=open`` also checksums every partition file,
        quarantining failures. A lock held elsewhere skips the sweep with a
        warning (the next open or recover() runs it)."""
        if not self._types:
            return
        from geomesa_tpu_torch.conf import sys_prop
        from geomesa_tpu_torch.locking import LockTimeout

        verify_open = sys_prop("store.verify") == "open"
        for name in list(self._types):
            try:
                with self._exclusive():
                    self._refresh_from_disk(name)
                    self._open_recovery[name] = self._recover_locked(name)
                    if verify_open:
                        self._verify_type(name)
            except LockTimeout as e:
                _log.warning("dataset %r: recovery sweep skipped at open (%s)", name, e)

    # -- inter-process locking ---------------------------------------------

    @contextmanager
    def _exclusive(self):
        """Exclusive store lock, re-entrant per thread (a locked rewrite
        reads existing files through _read_partition)."""
        from geomesa_tpu_torch.locking import file_lock

        depth = getattr(self._lock_tl, "depth", 0)
        if depth > 0:
            self._lock_tl.depth = depth + 1
            try:
                yield
            finally:
                self._lock_tl.depth -= 1
            return
        with self._mem_lock, file_lock(self._lock_path):
            self._lock_tl.depth = 1
            try:
                yield
            finally:
                self._lock_tl.depth = 0

    @contextmanager
    def _shared(self):
        from geomesa_tpu_torch.locking import file_lock

        if getattr(self._lock_tl, "depth", 0) > 0:
            yield  # already under this thread's exclusive lock
            return
        with self._mem_lock, file_lock(self._lock_path, shared=True):
            yield

    # -- schema / persistence ---------------------------------------------

    def _dir(self, type_name: str) -> str:
        return os.path.join(self.root, type_name)

    def _load_type(self, name: str) -> None:
        self._types[name] = self._read_state(name)

    def _read_state(self, name: str) -> "_FsTypeState":
        from geomesa_tpu_torch.store.chunkstats import FORMAT_V1, chunkset_from_json

        # shared lock: never read the manifest mid-rewrite
        with self._shared():
            with open(os.path.join(self._dir(name), "schema.json")) as fh:
                meta = json.load(fh)
        encoding = meta.get("encoding", "parquet")
        if encoding != partfile.ENCODING:
            # never misread another format's files
            raise _foreign_encoding(encoding, f"dataset {name!r} at {self._dir(name)}")
        sft = SimpleFeatureType.create(name, meta["spec"])
        parts = [
            PartitionMeta(
                pid=p["pid"],
                start=p["start"],
                stop=p["stop"],
                key_lo=tuple(p["key_lo"]),
                key_hi=tuple(p["key_hi"]),
                count=p["count"],
                bbox=tuple(p["bbox"]) if p.get("bbox") else None,
                time_range=tuple(p["time_range"]) if p.get("time_range") else None,
                leaf=p.get("leaf"),
                checksum=p.get("checksum"),
                chunks=self._load_chunks(chunkset_from_json, p.get("chunks")),
                gen=meta.get("file_gen"),
            )
            for p in meta["partitions"]
        ]
        return _FsTypeState(
            sft,
            meta["primary"],
            parts,
            data_interval=tuple(meta["data_interval"]) if meta.get("data_interval") else None,
            encoding=encoding,
            scheme=self._scheme_of(sft, strict=False),
            stats=self._load_stats(meta.get("stats")),
            generation=meta.get("generation"),
            file_gen=meta.get("file_gen"),
            format_version=int(meta.get("format", FORMAT_V1)),
            dirty=bool(meta.get("dirty", False)),
            wal_watermark=int(meta.get("wal_watermark", -1)),
        )

    @staticmethod
    def _load_chunks(parse, raw):
        if not raw:
            return None
        try:
            return parse(raw)
        except Exception:  # chunk stats are advisory: a full scan, never a failed open
            return None

    @staticmethod
    def _load_stats(raw):
        if not raw:
            return None
        from geomesa_tpu_torch.stats.sketches import seq_from_json

        try:
            return seq_from_json(raw)
        except Exception:  # stats are advisory: worse estimates, never a failed open
            return None

    @staticmethod
    def _scheme_of(sft: SimpleFeatureType, strict: bool = True):
        from geomesa_tpu_torch.store.partitions import USER_DATA_KEY, scheme_for

        spec = sft.user_data.get(USER_DATA_KEY)
        if not spec:
            return None
        try:
            scheme = scheme_for(str(spec))
            scheme.validate(sft)
        except ValueError:
            if strict:  # create_schema: fail fast, before any writes
                raise
            # loading persisted state: files stay readable via their
            # recorded leaf paths; only leaf pruning is lost
            _log.warning("type %r: invalid partition scheme %r ignored on load",
                         sft.type_name, spec)
            return None
        return scheme

    def _save_meta(self, name: str) -> None:
        from geomesa_tpu_torch.store.chunkstats import chunkset_to_json

        st = self._types[name]
        st.generation = uuid.uuid4().hex  # new manifest token
        meta = {
            "generation": st.generation,
            "file_gen": st.file_gen,
            "format": st.format_version,
            "dirty": st.dirty,
            "wal_watermark": st.wal_watermark,
            "spec": st.sft.spec,
            "primary": st.primary,
            "encoding": st.encoding,
            "data_interval": st.data_interval,
            "stats": st.stats.to_json() if st.stats is not None else None,
            "partitions": [
                {
                    "pid": p.pid,
                    "start": p.start,
                    "stop": p.stop,
                    "key_lo": list(p.key_lo),
                    "key_hi": list(p.key_hi),
                    "count": p.count,
                    "bbox": list(p.bbox) if p.bbox else None,
                    "time_range": list(p.time_range) if p.time_range else None,
                    "leaf": p.leaf,
                    "checksum": p.checksum,
                    "chunks": chunkset_to_json(p.chunks),
                }
                for p in st.partitions
            ],
        }
        self._publish_manifest(
            os.path.join(self._dir(name), "schema.json"), json.dumps(meta), st.generation)

    @staticmethod
    def _publish_manifest(path: str, body: str, generation: str) -> None:
        """Atomically publish ``schema.json`` and its ``.gen`` staleness
        sidecar, fsyncing contents and the directory: a crash leaves either
        the old or the new manifest. A crash between the two replaces
        leaves the sidecar one generation behind, which the recovery sweep
        repairs from the manifest."""
        from geomesa_tpu_torch.conf import sys_prop

        fsync = bool(sys_prop("store.fsync"))
        tmp = path + ".tmp"
        _write_file(tmp, body.encode("utf-8"), fsync)
        os.replace(tmp, path)
        gen_tmp = path + ".gen.tmp"
        _write_file(gen_tmp, generation.encode("utf-8"), fsync)
        os.replace(gen_tmp, path + ".gen")
        if fsync:
            _fsync_dir(os.path.dirname(path))

    def create_schema(self, sft: "SimpleFeatureType | str", spec: "str | None" = None):
        if isinstance(sft, str):
            sft = SimpleFeatureType.create(sft, spec)
        if sft.type_name in self._types:
            raise ValueError(f"schema {sft.type_name!r} exists")
        primary = default_indices(sft)[0]
        os.makedirs(self._dir(sft.type_name), exist_ok=True)
        self._types[sft.type_name] = _FsTypeState(
            sft, primary, encoding=self.encoding, scheme=self._scheme_of(sft))
        self._save_meta(sft.type_name)
        return sft

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self._types[type_name].sft

    @property
    def type_names(self) -> list:
        return list(self._types)

    # -- writes ------------------------------------------------------------

    def write(self, type_name: str, columns_or_batch, fids=None) -> int:
        st = self._types[type_name]
        if isinstance(columns_or_batch, FeatureBatch):
            batch = columns_or_batch
        else:
            batch = FeatureBatch.from_columns(st.sft, columns_or_batch, fids)
        st.pending.append(batch)
        return len(batch)

    def flush(self, type_name: str) -> None:
        """Merge pending + existing rows into freshly sorted partition files
        (the compaction step; ref geomesa-fs CompactCommand semantics)."""
        st = self._types[type_name]
        if not st.pending:  # checked before locking: queries flush eagerly
            return
        with self._exclusive():
            self._refresh_from_disk(type_name)
            self._flush_locked(type_name)

    def _refresh_from_disk(self, type_name: str):
        """Re-read the on-disk manifest under the held lock when another
        store object or process published since this one last read or
        wrote it (compared through the ``.gen`` sidecar alone). Buffered
        pending rows survive; the disk wins on everything else."""
        meta_path = os.path.join(self._dir(type_name), "schema.json")
        if not os.path.exists(meta_path):
            return None
        st = self._types.get(type_name)
        try:
            gen_path = meta_path + ".gen"
            if os.path.exists(gen_path):
                with open(gen_path) as fh:
                    disk_gen = fh.read().strip() or None
            else:  # pre-sidecar manifest: full parse fallback
                with open(meta_path) as fh:
                    disk_gen = json.load(fh).get("generation")
        except (OSError, json.JSONDecodeError):
            return None  # unreadable manifest: keep our view
        if st is not None and disk_gen == st.generation:
            # nobody else wrote since: our in-memory state may be ahead of
            # the disk deliberately, and wins
            return None
        new = self._read_state(type_name)
        if st is None:
            self._types[type_name] = new
            return None
        # in place: callers hold references to the state object
        st.sft = new.sft
        st.primary = new.primary
        st.partitions = new.partitions
        st.data_interval = new.data_interval
        st.encoding = new.encoding
        st.scheme = new.scheme
        st.stats = new.stats
        st.generation = new.generation
        st.file_gen = new.file_gen
        st.format_version = new.format_version
        st.dirty = new.dirty
        st.wal_watermark = new.wal_watermark
        st.cache = {}
        # new files: stale quarantines must not outlive what they indicted
        self._clear_quarantine(st)
        if getattr(self._lock_tl, "depth", 0) > 0:
            # under the exclusive lock: reclaim what a crashed writer left
            return self._recover_locked(type_name)
        return None

    def _flush_locked(self, type_name: str) -> None:
        st = self._types[type_name]
        if st.dirty:
            raise RuntimeError(
                f"dataset {type_name!r} is quarantined: a flush failed mid-rewrite in "
                "another process; retry there or restore the files")
        if not st.pending:
            return
        orig_pending = list(st.pending)
        batches = orig_pending
        if st.partitions:
            batches = [self._read_all(type_name)] + batches
        data = batches[0] if len(batches) == 1 else FeatureBatch.concat(batches)
        # resolve the keyspace BEFORE clearing pending: a bad primary must
        # not drop the buffered writes
        ks = keyspace_for(st.sft, st.primary)
        st.pending = []
        gen0 = st.generation
        try:
            self._write_sorted(type_name, st, ks, data)
        except BaseException:
            # the previous generation is still published: restore the
            # buffered batches so a retry merges the same rows -- unless
            # the manifest advanced (a post-publish failure), where a
            # restore would duplicate them
            if st.generation == gen0:
                st.pending = orig_pending + st.pending
            raise

    def _write_sorted(self, type_name, st, ks, data) -> None:
        """Crash-consistent rewrite: the new generation's ``part-<gen>-*``
        files land next to the previous generation on two writer threads,
        which join (every failure surfacing) before anything publishes;
        they are fsynced (contents, then directories), the manifest flips
        atomically, and the old generation is collected. The
        ``fail.flush.*`` failpoints bracket each step."""
        from geomesa_tpu_torch.conf import sys_prop
        from geomesa_tpu_torch.failpoints import fail_point
        from geomesa_tpu_torch.spawn import ContextPool
        from geomesa_tpu_torch.store.chunkstats import FORMAT_V2, build_chunk_set
        from geomesa_tpu_torch.store.memory import build_default_stats

        d = self._dir(type_name)
        fsync = bool(sys_prop("store.fsync"))
        new_gen = uuid.uuid4().hex[:8]
        fmt = int(sys_prop("store.format.version"))
        chunk_rows = max(int(sys_prop("store.chunk.rows")), 1)
        chunk_grid = max(int(sys_prop("store.chunk.grid")), 1)
        v2 = fmt == FORMAT_V2
        prev = (st.partitions, st.file_gen, st.stats, st.data_interval,
                st.generation, st.dirty, st.format_version)
        writes: "list[tuple]" = []  # (PartitionMeta, Future[checksum])
        dirs = {d}  # every directory holding a new file gets fsynced
        publishing = False
        ex = ContextPool(2, thread_name_prefix="fs-flush")

        def submit(built, p, part):
            writes.append((part, ex.submit(
                _write_part_file, built.batch, p.start, p.stop,
                self._part_path(type_name, part, gen=new_gen), fsync,
                chunk_rows if v2 else None)))

        def chunks_of(built, p):
            return build_chunk_set(ks, built.batch, built.keys, p.start, p.stop,
                                   chunk_rows, chunk_grid) if v2 else None

        try:
            if st.scheme is not None and len(data):
                # group rows by directory leaf; each leaf is sorted and
                # manifested independently (the partition-scheme layout)
                pid = 0
                leaf_keys = []
                for leaf, rows in st.scheme.leaf_groups(data):
                    built = self._build(ks, data.take(rows))
                    if getattr(ks, "name", None) == "z3":
                        leaf_keys.append((built.keys["bin"], built.keys["z"]))
                    leaf_dir = d
                    for seg in leaf.split("/"):
                        leaf_dir = os.path.join(leaf_dir, seg)
                        dirs.add(leaf_dir)
                    os.makedirs(leaf_dir, exist_ok=True)
                    for p in built.partitions:
                        part = dataclasses.replace(p, pid=pid, leaf=leaf, chunks=chunks_of(built, p))
                        submit(built, p, part)
                        pid += 1
                full = data
                # the leaf builds encoded every row's (bin, z): the Z3
                # histogram's counts do not depend on the rows' order
                z3_keys = (
                    (np.concatenate([b for b, _ in leaf_keys]), np.concatenate([z for _, z in leaf_keys]))
                    if leaf_keys else None
                )
            else:
                built = self._build(ks, data)
                for p in built.partitions:
                    submit(built, p, dataclasses.replace(p, chunks=chunks_of(built, p)))
                full = built.batch
                # the build already encoded every row's (bin, z): reuse them
                # for the Z3 histogram instead of a second encode
                z3_keys = (
                    (built.keys["bin"], built.keys["z"])
                    if getattr(ks, "name", None) == "z3" else None
                )
            dtg = st.sft.dtg_field
            interval = st.data_interval
            if dtg is not None and len(full):
                col = full.column(dtg)
                interval = (int(col.min()), int(col.max()))
            stats = build_default_stats(st.sft, full, z3_keys=z3_keys)
            # join: a failed write fails the flush loudly BEFORE anything
            # publishes; the checksums and block sizes ride back
            parts = []
            for p, w in writes:
                checksum, blocks = w.result()
                if p.chunks is not None and blocks is not None and len(blocks) == len(p.chunks):
                    p.chunks.nbytes = np.asarray(blocks, dtype=np.int64)
                parts.append(dataclasses.replace(p, checksum=checksum, gen=new_gen))
            fail_point("fail.flush.after_write")
            if fsync:
                for dd in sorted(dirs):
                    _fsync_dir(dd)
            st.partitions = parts
            st.file_gen = new_gen
            st.format_version = fmt
            st.data_interval = interval
            st.stats = stats
            st.cache = {}
            self._clear_quarantine(st)
            st.dirty = False
            fail_point("fail.flush.before_publish")
            publishing = True
            self._save_meta(type_name)
        except BaseException:
            # abort: the previous generation is still the published one.
            # Restore the in-memory view and remove our partial files --
            # unless the manifest write itself was interrupted (it may have
            # flipped); then the disk decides and the sweep reconciles.
            ex.shutdown(wait=True, cancel_futures=True)
            published_gen = st.generation if publishing else None
            (st.partitions, st.file_gen, st.stats, st.data_interval,
             st.generation, st.dirty, st.format_version) = prev
            st.cache = {}
            if publishing:
                try:
                    with open(os.path.join(d, "schema.json")) as fh:
                        disk_gen = json.load(fh).get("generation")
                except (OSError, json.JSONDecodeError):
                    disk_gen = None
                if disk_gen == published_gen:
                    st.partitions, st.file_gen = parts, new_gen
                    st.data_interval, st.stats = interval, stats
                    st.generation = published_gen
                    st.format_version = fmt
                    st.dirty = False
            else:
                for p, _ in writes:
                    path = self._part_path(type_name, p, gen=new_gen)
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
                    except OSError as e:
                        _log.warning("dataset %r: could not remove aborted flush file %r: %s",
                                     type_name, path, e)
            raise
        finally:
            ex.shutdown(wait=True)
        from geomesa_tpu_torch import metrics

        metrics.store_generations.inc()
        fail_point("fail.flush.after_publish")
        # the new generation is durable and published: collect the old one
        self._gc_stale_parts(type_name)

    def _build(self, ks, data) -> BuiltIndex:
        """The flush's sorted-index build: the port's parallel host build
        (the device build is ROADMAP item 7)."""
        return build_index(ks, data, self.partition_size)

    #: sentinel: "use the partition's own file generation"
    _GEN_CURRENT = object()

    def _part_path(self, type_name: str, p: PartitionMeta, gen=_GEN_CURRENT) -> str:
        """Path of a partition file. ``gen`` defaults to the generation
        stamped on the meta (else the type's published one); a flush
        mid-rewrite passes its new generation explicitly. A scan over a
        pre-flush partition snapshot thus stays on ITS generation's files."""
        from geomesa_tpu_torch.store.partitions import part_file_name

        st = self._types[type_name]
        d = self._dir(type_name)
        if p.leaf:
            d = os.path.join(d, p.leaf)
        if gen is self._GEN_CURRENT:
            gen = p.gen if p.gen is not None else st.file_gen
        return os.path.join(d, part_file_name(p.pid, st.encoding, gen))

    # -- crash recovery / integrity ----------------------------------------

    @staticmethod
    def _clear_quarantine(st: "_FsTypeState") -> None:
        if st.quarantined:
            from geomesa_tpu_torch import metrics

            metrics.store_quarantined.dec(len(st.quarantined))
            st.quarantined = {}

    def _quarantine(self, type_name: str, st, p, path: str, err: str) -> None:
        """Quarantine ONE partition after a checksum failure: a loud
        per-partition error; the rest of the dataset keeps serving."""
        from geomesa_tpu_torch import metrics

        if p.pid not in st.quarantined:
            st.quarantined[p.pid] = err
            metrics.store_checksum_failures.inc()
            metrics.store_quarantined.inc()
            _log.error("dataset %r partition %d (%s): checksum verification failed (%s) -- "
                       "partition quarantined; queries not touching it keep serving",
                       type_name, p.pid, path, err)

    def recover(self, type_name: str) -> dict:
        """Recovery sweep: under the exclusive lock, re-sync with the
        on-disk manifest, repair a lagging ``.gen`` sidecar and reclaim
        files of interrupted flushes (unpublished generations, ``*.tmp``).
        Idempotent; runs at store open. Returns ``{"files": n, "bytes": b,
        "gen_repaired": bool}``, the open-time sweep's work folded in."""
        with self._exclusive():
            pre = self._refresh_from_disk(type_name)
            rep = self._recover_locked(type_name)
            for extra in (pre, self._open_recovery.pop(type_name, None)):
                if extra:
                    rep = {
                        "files": rep["files"] + extra["files"],
                        "bytes": rep["bytes"] + extra["bytes"],
                        "gen_repaired": rep["gen_repaired"] or extra["gen_repaired"],
                    }
            return rep

    def _recover_locked(self, type_name: str) -> dict:
        from geomesa_tpu_torch import metrics

        repaired = self._repair_gen_sidecar(type_name)
        files, nbytes = self._gc_stale_parts(type_name)
        if files:
            metrics.store_orphan_files.inc(files)
            metrics.store_orphan_bytes.inc(nbytes)
            _log.warning("dataset %r: recovery sweep reclaimed %d orphan file(s), %d bytes, "
                         "from an interrupted flush", type_name, files, nbytes)
        return {"files": files, "bytes": nbytes, "gen_repaired": repaired}

    def _repair_gen_sidecar(self, type_name: str) -> bool:
        """Republish a ``.gen`` sidecar left one generation behind
        ``schema.json`` (whose value is the truth)."""
        from geomesa_tpu_torch.conf import sys_prop

        st = self._types[type_name]
        if not st.generation:
            return False
        gen_path = os.path.join(self._dir(type_name), "schema.json.gen")
        disk = None
        try:
            with open(gen_path) as fh:
                disk = fh.read().strip() or None
        except OSError:
            pass
        if disk == st.generation:
            return False
        _write_file(gen_path + ".tmp", st.generation.encode("utf-8"), bool(sys_prop("store.fsync")))
        os.replace(gen_path + ".tmp", gen_path)
        return True

    def _gc_stale_parts(self, type_name: str) -> "tuple[int, int]":
        """Remove part/tmp files the current manifest does not reference
        (the previous generation right after a publish; interrupted-flush
        leftovers in a sweep). Snapshot pins (``store/snapshot.py``) extend
        the keep-set. Underscore directories (``_wal``, ``_pins``,
        ``_snapstage``) are never descended into. Caller holds the
        exclusive lock. Returns (files, bytes) removed."""
        from geomesa_tpu_torch.store import snapshot

        st = self._types[type_name]
        expected = {os.path.abspath(self._part_path(type_name, p)) for p in st.partitions}
        expected |= snapshot.pinned_paths(self, type_name)
        files = nbytes = 0
        for dirpath, dirnames, names in os.walk(self._dir(type_name)):
            dirnames[:] = [d for d in dirnames if not d.startswith("_")]
            for f in names:
                if not (f.startswith("part-") or f.endswith(".tmp")):
                    continue
                path = os.path.join(dirpath, f)
                if os.path.abspath(path) in expected:
                    continue
                try:
                    sz = os.path.getsize(path)
                    os.unlink(path)
                except FileNotFoundError:
                    continue
                except OSError as e:
                    _log.warning("dataset %r: could not reclaim %r: %s", type_name, path, e)
                    continue
                files += 1
                nbytes += sz
        return files, nbytes

    def verify_partitions(self, type_name: str) -> "list[tuple]":
        """Full checksum verification of every partition file (what
        ``store.verify=open`` runs at open): ``[(pid, path, error)]`` for
        the failures, each of which is quarantined."""
        with self._shared():
            self._refresh_from_disk(type_name)
            return self._verify_type(type_name)

    def _verify_type(self, type_name: str) -> "list[tuple]":
        st = self._types[type_name]
        errors = []
        for p in st.partitions:
            path = self._part_path(type_name, p)
            err = None
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError as e:
                err = f"unreadable: {e}"
            else:
                if p.checksum is not None:
                    err = verify_bytes(data, p.checksum)
            if err:
                self._quarantine(type_name, st, p, path, err)
                errors.append((p.pid, path, err))
        return errors

    def store_stats(self) -> dict:
        """Durability/integrity snapshot: per-type generations, partition
        and quarantine state, plus the process-wide store counters."""
        from geomesa_tpu_torch import metrics
        from geomesa_tpu_torch.conf import sys_prop

        types = {}
        for name, st in self._types.items():
            chunked = [p for p in st.partitions if p.chunks is not None]
            types[name] = {
                "generation": st.generation,
                "file_generation": st.file_gen,
                "encoding": st.encoding,
                "format": int(st.format_version),
                "partitions": len(st.partitions),
                "rows": int(sum(p.count for p in st.partitions)),
                "dirty": bool(st.dirty),
                "wal_watermark": int(st.wal_watermark),
                "chunked_partitions": len(chunked),
                "chunks": int(sum(len(p.chunks) for p in chunked)),
                "chunk_rows_covered": int(sum(p.count for p in chunked)),
                "quarantined": {int(pid): err for pid, err in st.quarantined.items()},
            }
        kinds = ("count", "density", "stats")
        return {
            "root": self.root,
            "verify": sys_prop("store.verify"),
            "types": types,
            "counters": {
                "generations_published": metrics.store_generations.value(),
                "orphan_files_reclaimed": metrics.store_orphan_files.value(),
                "orphan_bytes_reclaimed": metrics.store_orphan_bytes.value(),
                "checksum_failures": metrics.store_checksum_failures.value(),
                "partitions_quarantined": metrics.store_quarantined.value(),
                "read_retries": metrics.store_read_retries.value(),
                "chunks_read": metrics.store_chunks_read.value(),
                "chunks_skipped": metrics.store_chunks_skipped.value(),
                "chunk_bytes_skipped": metrics.store_chunk_bytes_skipped.value(),
                "chunk_stat_drift": metrics.store_chunk_stat_drift.value(),
                "pushdown_queries": {k: metrics.agg_pushdown_queries.value(kind=k) for k in kinds},
                "pushdown_fallbacks": {k: metrics.agg_pushdown_fallbacks.value(kind=k) for k in kinds},
                "pushdown_rows_preaggregated": metrics.agg_pushdown_rows.value(),
            },
        }

    def delete(self, type_name: str, fids) -> int:
        """Drop features by id and compact the partition files, in one
        exclusive section (a writer slipping between the read and the
        rewrite would have its rows resurrected or duplicated)."""
        with self._exclusive():
            self._refresh_from_disk(type_name)
            st = self._types[type_name]
            self._flush_locked(type_name)
            if not st.partitions:
                return 0
            data = self._read_all(type_name)
            # object dtype: a mixed int/str id list must not collapse to str
            keep = ~np.isin(data.fids, np.asarray(list(fids), dtype=object))
            removed = int((~keep).sum())
            if removed:
                st.pending = [data.take(np.nonzero(keep)[0])]
                st.partitions = []
                self._flush_locked(type_name)
            return removed

    def age_off(self, type_name: str, before_ms: int) -> int:
        from geomesa_tpu_torch.store.ageoff import age_off

        return age_off(self, type_name, self._types[type_name].sft, before_ms)

    def update_user_data(self, type_name: str, updates: dict) -> None:
        """Set (or, with None values, remove) schema user-data entries and
        persist the manifest (ref UpdateSftCommand / KeywordsCommand)."""
        with self._exclusive():
            self._refresh_from_disk(type_name)
            st = self._types[type_name]
            for k, v in updates.items():
                if v is None:
                    st.sft.user_data.pop(k, None)
                else:
                    st.sft.user_data[k] = v
            self._save_meta(type_name)

    def compact(self, type_name: str) -> None:
        """Rewrite all partition files merged and freshly sorted (ref
        geomesa-fs CompactCommand)."""
        self._rebuild_files(type_name)

    # -- maintenance jobs (ref geomesa-jobs index back-population) ---------

    def _rebuild_files(self, type_name: str) -> None:
        with self._exclusive():
            self._refresh_from_disk(type_name)
            self._rebuild_locked(type_name)

    def _rebuild_locked(self, type_name: str) -> None:
        st = self._types[type_name]
        if st.partitions:
            st.pending = [self._read_all(type_name)] + st.pending
            st.partitions = []
        self._flush_locked(type_name)
        self._save_meta(type_name)  # persists primary/scheme even when empty

    def reindex(self, type_name: str, primary: str) -> None:
        """Switch the primary index and rebuild the sorted files (the sort
        order IS the index, so re-indexing is a rewrite)."""
        with self._exclusive():
            self._refresh_from_disk(type_name)  # BEFORE the mutation
            st = self._types[type_name]
            keyspace_for(st.sft, primary)  # validate against the schema
            st.primary = primary
            self._rebuild_locked(type_name)

    def repartition(self, type_name: str, scheme_spec: "str | None") -> None:
        """Change (or drop) the directory partition scheme and rewrite."""
        from geomesa_tpu_torch.store.partitions import USER_DATA_KEY, scheme_for

        with self._exclusive():
            self._refresh_from_disk(type_name)  # BEFORE the mutation
            st = self._types[type_name]
            if scheme_spec:
                scheme = scheme_for(scheme_spec)
                scheme.validate(st.sft)
                st.sft.user_data[USER_DATA_KEY] = scheme.spec
            else:
                scheme = None
                st.sft.user_data.pop(USER_DATA_KEY, None)
            st.scheme = scheme
            self._rebuild_locked(type_name)

    # -- partition reads ---------------------------------------------------

    def _cache_slice(self, st, p: PartitionMeta, chunk_sel) -> "FeatureBatch | None":
        """Serve a chunk-selective read from a cached FULL partition batch,
        or None on a miss. Chunk-selective results are never pinned (a
        partial batch in the cache would truncate later full reads); keys
        are (generation, pid)."""
        full = st.cache.get((p.gen, p.pid))
        if full is None:
            return None
        return full.take(self._chunk_rows(p.chunks, chunk_sel))

    @staticmethod
    def _chunk_rows(cs, chunk_sel) -> np.ndarray:
        if not len(chunk_sel):
            return np.array([], dtype=np.int64)
        return np.concatenate([
            np.arange(int(cs.starts[i]), int(cs.stops[i]), dtype=np.int64) for i in chunk_sel])

    def _read_partition(self, type_name: str, p: PartitionMeta, cache: bool = True,
                        chunk_sel=None) -> FeatureBatch:
        """Read one partition under the shared lock (decode outside it).
        ``chunk_sel`` reads only those chunks of a v2 partition (never
        cached)."""
        st = self._types[type_name]
        if chunk_sel is not None:
            hit = self._cache_slice(st, p, chunk_sel)
            if hit is not None:
                return hit
        elif (p.gen, p.pid) in st.cache:
            return st.cache[(p.gen, p.pid)]
        with self._shared():  # never read a half-rewritten directory
            t = self._read_part_table(type_name, p, chunk_sel=chunk_sel)
        # decode OUTSIDE the lock: concurrent readers overlap it
        return self._decode_part_table(type_name, p, t, cache and chunk_sel is None)

    def _read_partition_unlocked(self, type_name: str, p: PartitionMeta, cache: bool = False,
                                 chunk_sel=None) -> FeatureBatch:
        """Read and decode one partition with NO locking: the caller holds
        the store lock for the whole enclosing scan. This is the prefetch
        worker's read under a consumer-held lock (_query_locked,
        _read_all, the pushdown): a worker must never take the lock its
        consumer holds, or the pipeline deadlocks."""
        st = self._types[type_name]
        if chunk_sel is not None:
            hit = self._cache_slice(st, p, chunk_sel)
            if hit is not None:
                return hit
        elif (p.gen, p.pid) in st.cache:
            return st.cache[(p.gen, p.pid)]
        t = self._read_part_table(type_name, p, chunk_sel=chunk_sel)
        return self._decode_part_table(type_name, p, t, cache and chunk_sel is None)

    def _read_partition_guarded(self, type_name: str, p: PartitionMeta, cache: bool = False,
                                locked: bool = False):
        """The scan paths' partition read (the counterpart's
        ``_read_partition_degradable``): transient errors retry on the
        worker (``io.*`` backoff); a read whose retries are spent, or a
        corrupt or quarantined partition, records a failure on THIS
        partition's circuit breaker and returns a :class:`_PartFailure`
        (partition-scoped: siblings and the pipeline are untouched); an
        open breaker short-circuits the read until its half-open probe.
        ``locked`` takes the per-read lock (query_partitions holds none
        across its yields). The breakers apply under
        ``resilience.degrade``."""
        from geomesa_tpu_torch import resilience
        from geomesa_tpu_torch.store.prefetch import _with_retries

        plain = self._read_partition if locked else self._read_partition_unlocked
        br = None
        if resilience.degrade_allowed():
            # the breaker's key holds the root: two stores with one type
            # name must not share failure state
            br = resilience.partition_breaker(f"{self.root}:{type_name}", p.pid)
            if not br.allow():
                return _PartFailure(p, resilience.PartitionUnavailableError(
                    type_name, p.pid, "circuit breaker open"))
        read = _with_retries(lambda pp: plain(type_name, pp, cache=cache))
        try:
            batch = read(p)
        except FileNotFoundError:
            raise  # a real state (a collected generation): refresh, not degrade
        except (OSError, PartitionCorruptError) as e:
            if br is not None:
                br.record_failure()
            return _PartFailure(p, e)
        if br is not None:
            br.record_success()
        return batch

    @staticmethod
    def _skip_part_failure(type_name: str, failure: _PartFailure) -> None:
        """The serving branch of a failed partition read: note the
        degradation (header and audit stamping, metric) and log the
        skipped partition; the caller continues past it."""
        from geomesa_tpu_torch import resilience

        resilience.note_degraded("partition-unavailable")
        _log.warning(
            "dataset %r partition %d unavailable (%s) -- serving DEGRADED result without it",
            type_name, failure.p.pid, failure.error)

    def scan_lock_held(self) -> bool:
        """True when THIS thread holds the store's exclusive lock: prefetch
        consumers must then read in-line (a worker's shared flock on a
        fresh fd conflicts with the held exclusive one)."""
        return getattr(self._lock_tl, "depth", 0) > 0

    @staticmethod
    def _blocks_for(p: PartitionMeta, chunk_sel):
        """Chunk indices a chunk-selective read takes as file blocks, or
        None when the file cannot serve one (v1, or chunk stats without
        the write-time block record): then the whole file is read and the
        chunks' rows sliced after decode."""
        cs = p.chunks
        if chunk_sel is None or cs is None or cs.nbytes is None or len(cs.nbytes) != len(cs):
            return None
        return [int(i) for i in chunk_sel]

    def _read_part_table(self, type_name: str, p: PartitionMeta, chunk_sel=None):
        """File -> raw blocks (timed; the prefetch pipeline's 'read'
        stage). Locking is the CALLER's concern. Honors the ``fail.read.*``
        failpoints; under ``store.verify=always`` the whole file's bytes
        are checksummed before parsing, and a mismatch quarantines this
        one partition and raises :class:`PartitionCorruptError`. With
        ``chunk_sel`` only the selected chunk blocks are read (verification
        still reads the whole file; only those blocks decode). Returns
        ``(raw table, row selection to apply after decode or None)``."""
        from geomesa_tpu_torch import ledger, metrics
        from geomesa_tpu_torch.conf import sys_prop
        from geomesa_tpu_torch.failpoints import fail_hit, fail_point
        from geomesa_tpu_torch.tracing import span

        st = self._types[type_name]
        if p.pid in st.quarantined:
            raise PartitionCorruptError(
                f"dataset {type_name!r} partition {p.pid} is quarantined: {st.quarantined[p.pid]}")
        path = self._part_path(type_name, p)
        fail_point("fail.read.io")  # transient: the prefetch retry path
        injected = fail_hit("fail.read.corrupt")
        verify = injected or sys_prop("store.verify") == "always"
        blocks = self._blocks_for(p, chunk_sel)
        rows_after = None
        if chunk_sel is not None and blocks is None:
            rows_after = self._chunk_rows(p.chunks, chunk_sel)
        t_read = time.perf_counter()
        with span("store.read", pid=p.pid, rows=int(p.count)) as sp:
            if not verify:
                t = partfile.read_table(path, blocks)
            else:
                with open(path, "rb") as fh:
                    data = partfile.read_all(fh)
                err = (
                    "injected corruption (failpoint fail.read.corrupt)" if injected
                    else verify_bytes(data, p.checksum) if p.checksum is not None
                    else None
                )
                if err:
                    self._quarantine(type_name, st, p, path, err)
                    raise PartitionCorruptError(
                        f"dataset {type_name!r} partition {p.pid} ({path}): {err}")
                t = partfile.parse_table(data, blocks)
        elapsed = time.perf_counter() - t_read
        metrics.io_read_seconds.observe(elapsed)
        ledger.charge("read_seconds", elapsed)
        if blocks is not None and not verify:
            # a pruned read: the selected blocks' manifest-recorded sizes;
            # the skipped remainder is the pruning's win
            size = int(p.chunks.nbytes[blocks].sum())
        else:
            size = t.nbytes
        metrics.io_bytes_read.inc(size)
        ledger.charge("read_bytes", size)
        sp.set(bytes=int(size))
        if chunk_sel is not None:
            sp.set(chunks=len(chunk_sel), chunk_total=len(p.chunks))
            ledger.charge("chunks_read", len(chunk_sel))
            ledger.charge("chunks_pruned", len(p.chunks) - len(chunk_sel))
            metrics.store_chunks_read.inc(len(chunk_sel))
            metrics.store_chunks_skipped.inc(len(p.chunks) - len(chunk_sel))
            if blocks is not None:
                metrics.store_chunk_bytes_skipped.inc(
                    int(p.chunks.nbytes.sum()) - int(p.chunks.nbytes[blocks].sum()))
        return t, rows_after

    def _decode_part_table(self, type_name: str, p: PartitionMeta, t, cache: bool) -> FeatureBatch:
        """Raw blocks -> FeatureBatch (timed; the pipeline's 'decode'
        stage), optionally pinning the partition cache."""
        from geomesa_tpu_torch import ledger, metrics
        from geomesa_tpu_torch.tracing import span

        st = self._types[type_name]
        raw, rows_after = t
        t_dec = time.perf_counter()
        with span("store.decode", pid=p.pid) as sp:
            batch = partfile.decode_table(raw, st.sft)
            if rows_after is not None:
                batch = batch.take(rows_after)
        elapsed = time.perf_counter() - t_dec
        metrics.io_decode_seconds.observe(elapsed)
        ledger.charge("decode_seconds", elapsed)
        sp.set(rows=len(batch))
        if cache:
            st.cache[(p.gen, p.pid)] = batch
        return batch

    def _read_all(self, type_name: str) -> FeatureBatch:
        """Merge-read every partition through the prefetch pipeline (reads
        and decode on worker threads, concatenated in partition order).
        Callers hold the exclusive lock, so the lock-free worker reads are
        safe."""
        from geomesa_tpu_torch.store.prefetch import batch_nbytes, prefetch_map

        st = self._types[type_name]
        return FeatureBatch.concat(list(prefetch_map(
            lambda p: self._read_partition_unlocked(type_name, p),
            st.partitions, self.io, size_of=batch_nbytes)))

    # -- queries -----------------------------------------------------------

    def plan(self, type_name: str, query: "Query | str | ast.Filter") -> QueryPlan:
        self.flush(type_name)
        with self._shared():
            self._refresh_from_disk(type_name)  # another process may have written
            return self._plan_locked(type_name, query)

    def _plan_locked(self, type_name: str, query) -> QueryPlan:
        st = self._types[type_name]
        if st.dirty and not st.pending:
            raise RuntimeError(
                f"dataset {type_name!r} is quarantined: a flush failed mid-rewrite in "
                "another process; retry there or restore the files")
        ks = keyspace_for(st.sft, st.primary)
        return plan_query(st.sft, {st.primary: ks}, as_query(query),
                          data_interval=st.data_interval, stats=st.stats)

    def _pruned_parts(self, type_name: str, plan: QueryPlan) -> list:
        """Partition-scheme leaf prune, then the manifest key-range prune."""
        st = self._types[type_name]
        parts = st.partitions
        if st.scheme is not None:
            from geomesa_tpu_torch.store.partitions import scheme_matches

            parts = [p for p in parts if p.leaf is None or scheme_matches(st.scheme, p.leaf, plan)]
        if plan.ranges is not None:
            parts = [p for p in parts if any(p.overlaps(r) for r in plan.ranges)]
        return parts

    @staticmethod
    def _local_index(ks, batch, p) -> BuiltIndex:
        """One partition's rows as a single-partition BuiltIndex, the unit
        the runner scans (one mask launch)."""
        return BuiltIndex(ks, batch, {}, [
            PartitionMeta(0, 0, len(batch), p.key_lo, p.key_hi, len(batch))])

    def query_partitions(self, type_name: str, query=ast.Include):
        """Yield one filtered FeatureBatch per surviving partition (the
        Spark SpatialRDDProvider analog). Visibility and projection apply
        per partition; global sort and max-features do not."""
        from geomesa_tpu_torch.device import resolve_device
        from geomesa_tpu_torch.query.runner import _post_process
        from geomesa_tpu_torch.store.prefetch import batch_nbytes, prefetch_map

        st = self._types[type_name]
        plan = self.plan(type_name, query)
        ks = keyspace_for(st.sft, st.primary)
        device = resolve_device(self.device)
        inner_plan = dataclasses.replace(plan, query=Query(filter=plan.filter))
        outer_plan = dataclasses.replace(
            plan, query=dataclasses.replace(plan.query, sort_by=None, max_features=None))
        parts = self._pruned_parts(type_name, plan)
        # read-ahead while the caller processes each batch; no lock is held
        # across the yields, so workers take the locked per-read path (in
        # line when this thread holds the exclusive lock)
        batches = prefetch_map(
            lambda p: self._read_partition_guarded(type_name, p, cache=True, locked=True),
            parts, 0 if self.scan_lock_held() else self.io, size_of=batch_nbytes)
        try:
            for p, batch in zip(parts, batches):
                if isinstance(batch, _PartFailure):
                    raise _unavailable(type_name, batch) from batch.error
                sub = run_query(self._local_index(ks, batch, p), inner_plan, device,
                                defer_visibility=True)
                if len(sub.batch):
                    out = _post_process(sub.batch, outer_plan)
                    if len(out):
                        yield out
        finally:
            batches.close()

    def query(self, type_name: str, query: "Query | str | ast.Filter" = ast.Include) -> QueryResult:
        """Partition-pruned scan over the partition files. The SHARED lock
        is held across plan and every partition read, so a concurrent
        rewrite can neither unlink files mid-scan nor mix generations."""
        from geomesa_tpu_torch.tracing import span

        t0 = time.perf_counter()
        with span("store.query", store="fs", type=type_name) as sp:
            self.flush(type_name)  # BEFORE the shared lock: exclusive if pending
            with self._shared():
                res = self._query_locked(type_name, query, t0)
            sp.set(hits=len(res), scanned=res.scanned)
            return res

    def _query_locked(self, type_name: str, query, t0) -> QueryResult:
        from geomesa_tpu_torch.audit import observe_query
        from geomesa_tpu_torch.conf import QueryTimeout, sys_prop
        from geomesa_tpu_torch.device import resolve_device
        from geomesa_tpu_torch.query.runner import _post_process
        from geomesa_tpu_torch.store.prefetch import batch_nbytes, prefetch_map

        self._refresh_from_disk(type_name)
        st = self._types[type_name]
        plan = self._plan_locked(type_name, query)
        t1 = time.perf_counter()
        parts = self._pruned_parts(type_name, plan)
        ks = keyspace_for(st.sft, st.primary)
        device = resolve_device(self.device) if parts else None
        chunks = []
        scanned = 0
        # per-partition scans apply no projection/sort/limit: that happens
        # once, globally, after the merge
        inner_plan = dataclasses.replace(plan, query=Query(filter=plan.filter))
        timeout_ms = sys_prop("query.timeout")
        deadline = t0 + timeout_ms / 1000.0 if timeout_ms else None
        # reads and decode run ahead on the prefetch pipeline (under the
        # held shared lock, so the workers' lock-free reads are safe)
        batches = prefetch_map(
            lambda p: self._read_partition_guarded(type_name, p, cache=True),
            parts, self.io, size_of=batch_nbytes)
        # FULL scans stream into buffers pre-sized from the manifest
        sink = (
            _PresizedSink(st.sft, sum(int(q.count) for q in parts))
            if plan.filter is ast.Include and plan.ranges is None and len(parts) > 1
            else None
        )
        try:
            for p, batch in zip(parts, batches):
                if deadline and time.perf_counter() > deadline:
                    raise QueryTimeout(f"query on {type_name!r} exceeded {timeout_ms}ms")
                if isinstance(batch, _PartFailure):
                    from geomesa_tpu_torch import resilience

                    if resilience.capture_degraded() is None:
                        # no request collector to stamp: a library or CLI
                        # caller gets the typed error, never a silent partial
                        raise _unavailable(type_name, batch) from batch.error
                    self._skip_part_failure(type_name, batch)
                    continue
                scanned += len(batch)
                sub = run_query(self._local_index(ks, batch, p), inner_plan, device,
                                defer_visibility=True)
                if len(sub.batch):
                    if sink is not None:
                        sink.add(sub.batch)  # copies; the batch drops now
                    else:
                        chunks.append(sub.batch)
        finally:
            batches.close()
        total = sum(p.count for p in st.partitions)
        if sink is not None and sink.filled:
            out = sink.finish()
        elif chunks:
            out = chunks[0] if len(chunks) == 1 else FeatureBatch.concat(chunks)
        elif st.partitions:
            out = self._read_partition(type_name, st.partitions[0]).take(np.array([], dtype=np.int64))
        else:
            out = FeatureBatch.from_columns(st.sft, {a.name: [] for a in st.sft.attributes})
        out = _post_process(out, plan)
        result = QueryResult(out, plan, scanned, total)
        observe_query("fs", type_name, plan, t0, t1, time.perf_counter(), result, self.audit_writer)
        return result

    def explain(self, type_name: str, query) -> str:
        return self.plan(type_name, query).explain()

    # -- aggregation pushdown (partition format v2) ------------------------

    def manifest_rows(self, type_name: str) -> int:
        """Rows the manifest records (equal to the files' rows): the
        pre-size hint of resident staging, read without opening a file."""
        return int(sum(p.count for p in self._types[type_name].partitions))

    def has_chunk_stats(self, type_name: str) -> bool:
        """True when every partition of ``type_name`` carries v2 chunk
        statistics, so the pushdown answers bbox+time shapes without row
        scans (the server's brownout rung consults it)."""
        st = self._types.get(type_name)
        if st is None:
            return False
        return all(p.chunks is not None for p in list(st.partitions))

    def count(self, type_name: str, query=ast.Include) -> int:
        """Filtered count; bbox+time filters on a v2 store are answered
        from chunk pre-aggregates (interior chunks from the manifest,
        boundary chunks refined through the runner, equal to the row scan);
        anything else falls back to the query path. Audited either way."""
        from geomesa_tpu_torch.audit import observe_query
        from geomesa_tpu_torch.store.pushdown import count_pushdown

        t0 = time.perf_counter()
        self.flush(type_name)
        with self._shared():
            self._refresh_from_disk(type_name)
            t1 = time.perf_counter()
            out = count_pushdown(self, type_name, query)
        if out is not None:
            n, plan = out
            observe_query("fs", type_name, plan, t0, t1, time.perf_counter(), _Sized(n),
                          self.audit_writer)
            return n
        return len(self.query(type_name, query))

    def density_pushdown(self, type_name: str, query, envelope, width: int, height: int):
        """Chunk-granular density grid (store/pushdown.py), or None when
        the query needs the row scan: total mass equal to the row scan's,
        placement within the coarse-cell tolerance."""
        from geomesa_tpu_torch.store.pushdown import density_pushdown

        self.flush(type_name)
        with self._shared():
            self._refresh_from_disk(type_name)
            return density_pushdown(self, type_name, query, envelope, width, height)

    def stats_pushdown(self, type_name: str, query, stat_spec: str):
        """Stat-DSL aggregation from chunk partials (Count/MinMax specs
        with bbox+time filters; exact), or None for the row scan."""
        from geomesa_tpu_torch.store.pushdown import stats_pushdown

        self.flush(type_name)
        with self._shared():
            self._refresh_from_disk(type_name)
            return stats_pushdown(self, type_name, query, stat_spec)

    def verify_chunk_stats(self, type_name: str) -> "list[tuple]":
        """Cross-check every v2 partition's chunk statistics (and the
        alignment of its file's chunk blocks) against its decoded rows:
        ``[(pid, chunk, error)]`` for every drifted record."""
        from geomesa_tpu_torch.store.pushdown import verify_chunk_stats

        with self._shared():
            self._refresh_from_disk(type_name)
            return verify_chunk_stats(self, type_name)
