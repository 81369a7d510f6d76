"""The file-system store's partition-file codec (``.gmcol``).

Counterpart of ``geomesa_tpu/store/fs.py`` lines 115-272 (``_write_table``,
``_read_table``, ``_encode_table``, ``_parse_table``, ``_row_group_nbytes``,
``checksum_bytes``, ``verify_bytes``) and of ``geomesa_tpu/features/
batch.py`` ``to_arrow``/``from_arrow``. The counterpart writes Parquet (or
ORC) through ``pyarrow``; the port's hosts have no ``pyarrow``, so the port
writes a columnar format of its own, under the counterpart's manifest,
generation, checksum and quarantine protocol (ROADMAP section 3):

- one file per partition (``part-<gen>-NNNNN.gmcol``), so checksums,
  lengths, quarantines and garbage collection stay one-to-one with files;
- an 8-byte magic, the header's length (uint64 little-endian) and a JSON
  header naming the columns and every chunk block's offset, length and
  buffers; then the chunk blocks, chunk-major, each 64-byte aligned;
- columns as ``to_arrow`` lays them out: ``__fid__``, the visibility
  labels (``__vis__``) when present, points as the ``<name>_x`` /
  ``<name>_y`` float64 pair, other geometries as WKT, dates as int64 ms,
  numbers and booleans as raw little-endian arrays of the column's dtype,
  strings (and bytes) as a validity byte per row, int64 offsets and the
  UTF-8 data (a null string is invalid);
- a v2 partition's chunk blocks align 1:1 with its manifest chunks
  (``store.chunk.rows``): the blocks' byte sizes ride into the manifest
  (the role of ``_row_group_nbytes``) and a read with ``chunk_sel`` reads
  only those blocks' byte ranges; a v1 partition is one block;
- decode is ``np.frombuffer`` views over the bytes read, where a column is
  one block and its dtype allows; several blocks concatenate;
- ``checksum_bytes`` / ``verify_bytes`` keep the counterpart's ``crc32``
  record (``zlib``); its optional ``crc32c`` accelerator stays optional.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch

ENCODING = "gmcol"
MAGIC = b"GMCOL\x00\x01\x00"
_ALIGN = 64
_LEN = struct.Struct("<Q")

# resolved once: a failed import is not cached by Python
try:
    from crc32c import crc32c as _crc32c  # optional accelerator
except ImportError:
    _crc32c = None


def checksum_bytes(data) -> "tuple[str, int]":
    """``(algo, value)`` content checksum: hardware crc32c when the
    optional module is present, zlib crc32 otherwise; the algo name
    persists in the manifest."""
    if _crc32c is not None:
        return "crc32c", int(_crc32c(data))
    return "crc32", int(zlib.crc32(data) & 0xFFFFFFFF)


def verify_bytes(data, checksum: dict) -> "str | None":
    """None when ``data`` matches the manifest checksum record, an error
    description otherwise. Unknown or unavailable algos fall back to the
    (always checked) byte length."""
    length = checksum.get("length")
    if length is not None and len(data) != int(length):
        return f"length {len(data)} != manifest {int(length)}"
    algo = checksum.get("algo")
    if algo == "crc32":
        got = int(zlib.crc32(data) & 0xFFFFFFFF)
    elif algo == "crc32c":
        if _crc32c is None:
            return None  # length already checked above
        got = int(_crc32c(data))
    else:
        return None
    want = int(checksum.get("value", -1))
    if got != want:
        return f"{algo} {got:#010x} != manifest {want:#010x}"
    return None


def _pad(n: int) -> int:
    return -n % _ALIGN


# -- encode ------------------------------------------------------------------


def _text_buffers(values, kind: str) -> list:
    """validity bytes, int64 offsets, data bytes of a str/bytes column."""
    n = len(values)
    valid = np.zeros(n, dtype=np.uint8)
    parts = []
    lens = np.zeros(n, dtype=np.int64)
    for i, v in enumerate(values):
        if v is None:
            continue
        b = v.encode("utf-8") if kind == "str" else bytes(v)
        valid[i] = 1
        lens[i] = len(b)
        parts.append(b)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return [valid, offsets, b"".join(parts)]


def _text_kind(values) -> str:
    kinds = {type(v) for v in values if v is not None}
    if kinds <= {str}:
        return "str"
    if kinds <= {bytes}:
        return "bin"
    raise TypeError(f"cannot store a column of {sorted(k.__name__ for k in kinds)} values")


def _columns(batch: FeatureBatch) -> "list[tuple[str, str, object]]":
    """(file column, kind, row-sliceable source) in ``to_arrow`` order;
    kind is a numpy dtype string, ``str``, ``bin`` or ``wkt``."""
    out = []
    fids = batch.fids
    if fids.dtype.kind in "iufb":
        out.append(("__fid__", fids.dtype.str, fids))
    elif fids.dtype.kind in "US":
        out.append(("__fid__", "str", fids.astype(object)))
    else:
        ints = fids.dtype == object and all(isinstance(v, (int, np.integer)) for v in fids)
        if ints:
            out.append(("__fid__", "<i8", fids.astype(np.int64)))
        else:
            out.append(("__fid__", _text_kind(fids), fids))
    if VIS_COLUMN in batch.columns:
        vis = batch.columns[VIS_COLUMN]
        out.append((VIS_COLUMN, "str", np.array([str(v) for v in vis], dtype=object)))
    for attr in batch.sft.attributes:
        col = batch.columns[attr.name]
        if attr.is_geometry:
            if col.dtype != object:
                out.append((f"{attr.name}_x", "<f8", col[:, 0]))
                out.append((f"{attr.name}_y", "<f8", col[:, 1]))
            else:
                out.append((attr.name, "wkt", col))
        elif col.dtype.kind in "iufb":
            out.append((attr.name, col.dtype.str, col))
        else:
            out.append((attr.name, _text_kind(col), col))
    return out


def encode_rows(batch: FeatureBatch, start: int = 0, stop: "int | None" = None,
                chunk_rows: "int | None" = None) -> "tuple[bytearray, list[int]]":
    """Rows ``[start, stop)`` of ``batch`` -> file bytes and each chunk
    block's byte size. ``chunk_rows`` cuts blocks at the v2 chunk
    boundaries (partition-relative, as ``build_chunk_set`` cuts them);
    None writes one block."""
    from geomesa_tpu_torch.geom import to_wkt

    stop = len(batch) if stop is None else stop
    n = stop - start
    step = max(int(chunk_rows), 1) if chunk_rows else max(n, 1)
    starts = [s for s in range(0, max(n, 1), step)] if n else [0]
    cols = _columns(batch)
    blocks = []  # per chunk: (rows, [buffers])
    for s in starts:
        e = min(s + step, n)
        a, b = start + s, start + e
        bufs = []
        for _, kind, src in cols:
            if kind == "wkt":
                bufs.append(_text_buffers([to_wkt(g) for g in src[a:b]], "str"))
            elif kind in ("str", "bin"):
                bufs.append(_text_buffers(src[a:b], kind))
            else:
                bufs.append([src[a:b]])
        blocks.append((e - s, bufs))
    # layout: header, then the blocks at aligned offsets
    chunks = []
    rel_total = []
    for rows, bufs in blocks:
        off = 0
        layout = []
        for col_bufs in bufs:
            spans = []
            for buf in col_bufs:
                size = buf.nbytes if isinstance(buf, np.ndarray) else len(buf)
                spans.append([off, size])
                off += size + _pad(size)
            layout.append(spans)
        chunks.append({"rows": int(rows), "buffers": layout})
        rel_total.append(off)
    header = {
        "rows": int(n),
        "columns": [[name, kind] for name, kind, _ in cols],
        "chunks": chunks,
    }
    # the blocks' offsets depend on the header's length, which depends on
    # the offsets' digits: grow the data start until the header fits
    data_start = 0
    while True:
        off = data_start
        for c, size in zip(chunks, rel_total):
            c["offset"], c["length"] = off, size
            off += size
        body = json.dumps(header, separators=(",", ":")).encode("utf-8")
        head = len(MAGIC) + _LEN.size + len(body)
        if head + _pad(head) <= data_start:
            break
        data_start = head + _pad(head)
    out = bytearray(off)
    out[: len(MAGIC)] = MAGIC
    out[len(MAGIC): len(MAGIC) + _LEN.size] = _LEN.pack(len(body))
    out[len(MAGIC) + _LEN.size: len(MAGIC) + _LEN.size + len(body)] = body
    for c, (_, bufs) in zip(chunks, blocks):
        base = c["offset"]
        for spans, col_bufs in zip(c["buffers"], bufs):
            for (o, size), buf in zip(spans, col_bufs):
                if not size:
                    continue
                if isinstance(buf, np.ndarray):
                    np.frombuffer(out, dtype=buf.dtype, count=len(buf), offset=base + o)[...] = buf
                else:
                    out[base + o: base + o + size] = buf
    return out, [int(c["length"]) for c in chunks]


# -- decode ------------------------------------------------------------------


def parse_header(data) -> "tuple[dict, int]":
    """(header, header end) of a file's leading bytes."""
    if bytes(data[: len(MAGIC)]) != MAGIC:
        raise ValueError("not a .gmcol partition file (bad magic)")
    (hlen,) = _LEN.unpack_from(data, len(MAGIC))
    at = len(MAGIC) + _LEN.size
    return json.loads(bytes(data[at: at + hlen])), at + hlen


def _text_values(buf, spans, base: int, rows: int, kind: str) -> np.ndarray:
    if not rows:
        return np.empty(0, dtype=object)
    (vo, _), (oo, _), (do, dl) = spans
    valid = np.frombuffer(buf, dtype=np.uint8, count=rows, offset=base + vo)
    offs = np.frombuffer(buf, dtype=np.int64, count=rows + 1, offset=base + oo)
    raw = bytes(buf[base + do: base + do + dl])
    out = np.empty(rows, dtype=object)
    if kind == "str":
        text = raw.decode("utf-8")
        if len(text) == len(raw):  # ASCII: byte offsets are char offsets
            raw = text
        else:
            raw = None
    bounds = offs.tolist()
    for i in range(rows):
        if not valid[i]:
            out[i] = None
        elif raw is not None:
            out[i] = raw[bounds[i]: bounds[i + 1]]
        else:
            out[i] = bytes(buf[base + do + bounds[i]: base + do + bounds[i + 1]]).decode("utf-8")
    return out


def _decode_block(buf, base: int, chunk: dict, columns) -> dict:
    rows = int(chunk["rows"])
    out = {}
    for (name, kind), spans in zip(columns, chunk["buffers"]):
        if kind in ("str", "bin", "wkt"):
            out[name] = _text_values(buf, spans, base, rows, "bin" if kind == "bin" else "str")
        else:
            (o, _), = spans
            out[name] = np.frombuffer(buf, dtype=np.dtype(kind), count=rows, offset=base + o)
    return out


def _assemble(parts: "list[dict]", columns, sft) -> FeatureBatch:
    from geomesa_tpu_torch.geom import parse_wkt

    kinds = dict(columns)

    def col(name):
        arrs = [p[name] for p in parts]
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)

    cols = {}
    for attr in sft.attributes:
        if attr.is_geometry and f"{attr.name}_x" in kinds:
            x, y = col(f"{attr.name}_x"), col(f"{attr.name}_y")
            xy = np.empty((len(x), 2), dtype=np.float64)
            xy[:, 0], xy[:, 1] = x, y
            cols[attr.name] = xy
        elif attr.is_geometry:
            g = np.empty(len(col(attr.name)), dtype=object)
            g[:] = [parse_wkt(w) for w in col(attr.name)]
            cols[attr.name] = g
        elif attr.column_dtype is not None:
            v = col(attr.name)
            cols[attr.name] = v if v.dtype == attr.column_dtype else v.astype(attr.column_dtype)
        else:
            cols[attr.name] = col(attr.name)
    if VIS_COLUMN in kinds:
        cols[VIS_COLUMN] = col(VIS_COLUMN)
    fids = col("__fid__")
    n = len(fids)
    for name, v in cols.items():
        if len(v) != n:
            raise ValueError(f"column {name!r} has {len(v)} rows, the fids {n}")
    return FeatureBatch(sft, fids, cols)


def _select(header: dict, chunk_sel) -> list:
    chunks = header["chunks"]
    if chunk_sel is None:
        return list(range(len(chunks)))
    sel = [int(i) for i in chunk_sel]
    if any(i < 0 or i >= len(chunks) for i in sel):
        raise ValueError(f"chunk selection {sel} outside the file's {len(chunks)} chunk blocks")
    return sel


def _empty_part(columns) -> dict:
    return {
        name: np.empty(0, dtype=object) if kind in ("str", "bin", "wkt") else np.zeros(0, np.dtype(kind))
        for name, kind in columns
    }


def read_all(fh) -> bytearray:
    """A file's bytes, read once into a writable buffer (decoded columns
    are views of it)."""
    buf = bytearray(os.fstat(fh.fileno()).st_size)
    view = memoryview(buf)
    got = 0
    while got < len(buf):
        n = fh.readinto(view[got:])
        if not n:
            raise ValueError(f"{fh.name}: truncated ({got} of {len(buf)} bytes)")
        got += n
    return buf


class RawTable:
    """A partition file's header and the bytes of the chunk blocks a read
    selected, not yet decoded (the read stage's output; the counterpart's
    Arrow table)."""

    __slots__ = ("header", "columns", "blocks", "nbytes")

    def __init__(self, header: dict, blocks: list, nbytes: int):
        self.header = header
        self.columns = [tuple(c) for c in header["columns"]]
        self.blocks = blocks  # [(buffer, block offset in it, chunk record)]
        self.nbytes = nbytes  # bytes read from the file


def parse_table(data, chunk_sel=None) -> RawTable:
    """Bytes of a whole file (already read, e.g. for its checksum) -> its
    blocks, or the ``chunk_sel`` chunks' blocks."""
    header, _ = parse_header(data)
    chunks = header["chunks"]
    blocks = [(data, int(chunks[i]["offset"]), chunks[i]) for i in _select(header, chunk_sel)]
    return RawTable(header, blocks, len(data))


def _read_header(fh) -> "tuple[dict, int]":
    lead = fh.read(len(MAGIC) + _LEN.size)
    if lead[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{fh.name}: not a .gmcol partition file (bad magic)")
    (hlen,) = _LEN.unpack_from(lead, len(MAGIC))
    return json.loads(fh.read(hlen)), len(lead) + hlen


def read_header(path: str) -> dict:
    """A partition file's header alone (columns, chunk blocks)."""
    with open(path, "rb") as fh:
        return _read_header(fh)[0]


def read_table(path: str, chunk_sel=None) -> RawTable:
    """Read a partition file. ``chunk_sel`` reads only the header and those
    chunks' byte ranges."""
    with open(path, "rb") as fh:
        if chunk_sel is None:
            return parse_table(read_all(fh))
        header, nread = _read_header(fh)
        blocks = []
        for i in _select(header, chunk_sel):
            c = header["chunks"][i]
            fh.seek(int(c["offset"]))
            buf = bytearray(int(c["length"]))
            got = fh.readinto(buf)
            if got != len(buf):
                raise ValueError(f"{path}: chunk {i} truncated ({got} of {len(buf)} bytes)")
            nread += len(buf)
            blocks.append((buf, 0, c))
    return RawTable(header, blocks, nread)


def decode_table(raw: RawTable, sft) -> FeatureBatch:
    """Blocks -> FeatureBatch (the counterpart's ``from_arrow``)."""
    parts = [_decode_block(buf, base, c, raw.columns) for buf, base, c in raw.blocks]
    return _assemble(parts or [_empty_part(raw.columns)], raw.columns, sft)
