"""BIN format: compact binary track records.

Copy of ``geomesa_tpu/process/binexport.py`` (lines 1-95; ref geomesa-utils
BinaryOutputEncoder). Record layout, little-endian:

- 16 bytes: track_id hash (int32) | dtg seconds (int32) | lat f32 | lon f32
- 24 bytes: + label packed as int64 (first 8 bytes of the string)

One change: the counterpart hashes track strings and packs labels in a
Python loop over every row, minutes at tens of millions of rows. Here
each distinct value is hashed or packed once (``np.unique`` with
``return_inverse``) and gathered back, with the same bytes.
"""

from __future__ import annotations

import numpy as np

DTYPE_16 = np.dtype(
    [("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4")]
)
DTYPE_24 = np.dtype(
    [("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4"), ("label", "<i8")]
)


def _distinct(values: np.ndarray):
    """(one original value per distinct value, inverse index): values that
    print alike under ``str`` share an entry. Numeric columns are told
    apart by their bytes (so 0.0 and -0.0, which print differently, stay
    apart); object columns by ``str`` of each value."""
    if values.dtype == object:
        keys = np.array([str(v) for v in values], dtype=str)
        uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    elif values.dtype.kind in "US":
        uniq, first, inv = np.unique(values, return_index=True, return_inverse=True)
    else:
        raw = np.ascontiguousarray(values).view(np.dtype((np.void, values.dtype.itemsize)))
        _, first, inv = np.unique(raw, return_index=True, return_inverse=True)
    # iterating the result yields numpy scalars, whose str is the one the
    # counterpart's row loop sees (a Python float prints more digits)
    return values[first], inv.reshape(-1)


def _hash_str(s: str) -> int:
    """Java ``String.hashCode`` over code points, as an int32."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    return int(np.uint32(h).astype(np.int32))


def _track_hash(values: np.ndarray) -> np.ndarray:
    """Stable int32 hash of track-id values (String.hashCode of the value's
    string; integer ids pass through truncated)."""
    if values.dtype.kind in "iu":
        return values.astype(np.int64).astype(np.int32)
    if len(values) == 0:
        return np.empty(0, np.int32)
    uniq, inv = _distinct(values)
    table = np.array([_hash_str(str(v)) for v in uniq], np.int32)
    return table[inv]


def _label_pack(values: np.ndarray) -> np.ndarray:
    """int64 of the first 8 bytes of each value's UTF-8 string, zero-padded."""
    if len(values) == 0:
        return np.zeros(0, np.int64)
    uniq, inv = _distinct(values)
    table = np.array(
        [np.frombuffer(str(v).encode()[:8].ljust(8, b"\0"), dtype="<i8")[0]
         for v in uniq],
        np.int64,
    )
    return table[inv]


def encode_bin_arrays(
    track_vals: np.ndarray,
    dtg_ms: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    label_vals: "np.ndarray | None" = None,
    sort: bool = False,
) -> bytes:
    """Column arrays -> BIN bytes (16B or 24B records). The column-level
    entry point lets callers holding a hit mask encode without
    materializing a feature batch (``DeviceIndex.bin_export``)."""
    n = len(track_vals)
    dt = DTYPE_24 if label_vals is not None else DTYPE_16
    rec = np.empty(n, dtype=dt)
    rec["track"] = _track_hash(np.asarray(track_vals))
    rec["dtg"] = (np.asarray(dtg_ms) // 1000).astype(np.int32)
    rec["lat"] = np.asarray(y).astype(np.float32)
    rec["lon"] = np.asarray(x).astype(np.float32)
    if label_vals is not None:
        rec["label"] = _label_pack(np.asarray(label_vals))
    if sort:
        rec = rec[np.argsort(rec["dtg"], kind="stable")]
    return rec.tobytes()


def encode_bin(
    batch,
    track_attr: str,
    dtg_attr: "str | None" = None,
    geom_attr: "str | None" = None,
    label_attr: "str | None" = None,
    sort: bool = False,
) -> bytes:
    """FeatureBatch -> BIN bytes (16B or 24B records)."""
    dtg_attr = dtg_attr or batch.sft.dtg_field
    x, y = batch.point_coords(geom_attr)
    return encode_bin_arrays(
        batch.column(track_attr),
        batch.column(dtg_attr),
        x,
        y,
        batch.column(label_attr) if label_attr else None,
        sort=sort,
    )


def decode_bin(data: bytes, labels: bool = False) -> np.ndarray:
    """BIN bytes -> structured array."""
    return np.frombuffer(data, dtype=DTYPE_24 if labels else DTYPE_16)
