"""Carry resident state across from the JAX package's index.

``planes_from_numpy`` turns the staged planes of the counterpart's
``DeviceIndex`` (``{k: np.asarray(v) for k, v in di._cols.items()}``) into
the port's resident planes, bit for bit, so that
``DeviceIndex.from_planes`` serves from exactly the same state. 32-bit
planes keep their bits and dtype. A float64 plane (the counterpart stages
float64 off a TPU) becomes float32 only when every value survives the
round trip; otherwise it raises, since the port's kernels read float32
lanes and a rounded plane would change answers. The visibility label-id
plane ``__visid`` is an int32 plane like any other; pass the counterpart's
``_vis_vocab`` to ``from_planes`` with it. So are the key planes of either
layout: ``__znx/__zny/__zbt`` (uint32) and the interleaved ``__zbin``
(int32), ``__zhi/__zlo`` (uint32), which hold the xz code for xz2/xz3
schemas, whose float32 envelope planes ``<geom>__x0/__y0/__x1/__y1``
carry across like any other float plane.

``join_index_from_numpy`` carries the counterpart's join layout
(``geomesa_tpu/join/engine.py`` ``JoinIndex``: its keys, permutation,
planes and histogram prefix sums, as numpy) into the port's, so that both
join engines can run on one layout.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.scan import to_tensor


def planes_from_numpy(cols: "dict[str, np.ndarray]", device) -> "dict[str, torch.Tensor]":
    out = {}
    for k, v in cols.items():
        a = np.asarray(v)
        if a.dtype == np.float64:
            f32 = a.astype(np.float32)
            if not np.array_equal(f32.astype(np.float64), a, equal_nan=True):
                raise ValueError(
                    f"plane {k}: float64 values do not survive float32 lanes"
                )
            a = f32
        if a.dtype not in (np.float32, np.int32, np.uint32) or a.ndim != 1:
            raise TypeError(f"plane {k}: {a.dtype} {a.shape} is not a 32-bit lane plane")
        out[k] = to_tensor(a, device)
    return out


def join_index_from_numpy(kind: str, keys, perm, planes: dict, hist_prefix, hist_bits: int,
                          gen: int = 0, xz_precision: int = 12, device=None):
    """The port's ``JoinIndex`` over the counterpart's layout arrays: ``kind``
    "z2" or "xz2", ``keys`` the sorted uint64 codes, ``perm`` the sorted ->
    original row map (None: identity), ``planes`` the sorted float64 planes
    (x, y or x0, y0, x1, y1), ``hist_prefix`` the (2^h + 1)^2 prefix sums or
    None. ``device`` None keeps it on the host; else the planes (and the
    permutation) are staged there too."""
    from geomesa_tpu_torch.curves.normalize import NormalizedLat, NormalizedLon
    from geomesa_tpu_torch.curves.xz2 import XZ2SFC
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.join import planner as jp
    from geomesa_tpu_torch.join.engine import JoinIndex

    if kind == "z2":
        sfc = Z2SFC()
        lon, lat = sfc.lon, sfc.lat
    elif kind == "xz2":
        sfc = XZ2SFC(xz_precision)
        lon, lat = NormalizedLon(jp._BITS), NormalizedLat(jp._BITS)
    else:
        raise ValueError(f"join layout kind {kind!r} is not z2 or xz2")
    keys = np.ascontiguousarray(keys, np.uint64)
    perm = None if perm is None else np.ascontiguousarray(perm, np.int64)
    planes = {k: np.ascontiguousarray(v, np.float64) for k, v in planes.items()}
    hist = None if hist_prefix is None else np.ascontiguousarray(hist_prefix, np.int64)
    return JoinIndex(kind, sfc, keys, perm, planes, lon, lat, hist, int(hist_bits), gen=gen,
                     device=torch.device("cpu") if device is None else torch.device(device))
