"""Hand-written CUDA kernels of the port and their launch counts.

``LAUNCHES`` counts, per kernel variant, the launches its wrapper made
(the wrappers in ``ops/zscan.py``, ``ops/filter_scan.py`` and
``ops/density.py`` call :func:`count_launch` where they launch, and
nowhere else): ``dimscan_*`` and ``dimscan_batched_*``
(``csrc/dimscan.cu``), ``dimscan_baked_*`` (``csrc/dimscan_baked.cu``),
``zscan_*`` and ``zscan_batched_*`` (``csrc/zscan.cu``),
``filter_scan_*`` (``csrc/filter_scan.cu``), ``density_*``
(``csrc/density.cu``). ``VALID_LAUNCHES`` counts, under the same names,
the launches that read a validity plane (a streaming index's live rows:
the scans take ``valid=``). The scheduler's workers launch from several
threads at once, so counts change only under a lock.
``DEVICE_FN_CALLS`` counts exact scans that went to the plain
``device_fn`` because the filter-scan encoder refused the filter (the
counterpart's ``PallasUnsupported`` route).
"""

from __future__ import annotations

import threading

import torch

KERNEL_NAMES = (
    "dimscan_z3_count",
    "dimscan_z3_mask",
    "dimscan_z2_count",
    "dimscan_z2_mask",
    "dimscan_baked_count",
    "dimscan_baked_mask",
    "zscan_z3_count",
    "zscan_z3_mask",
    "zscan_z2_count",
    "zscan_z2_mask",
    "filter_scan_count",
    "filter_scan_mask",
    "density_count",
    "density_weighted",
    "dimscan_batched_z3_count",
    "dimscan_batched_z3_mask",
    "dimscan_batched_z2_count",
    "dimscan_batched_z2_mask",
    "zscan_batched_z3_count",
    "zscan_batched_z3_mask",
    "zscan_batched_z2_count",
    "zscan_batched_z2_mask",
)

LAUNCHES: dict = {k: 0 for k in KERNEL_NAMES}
VALID_LAUNCHES: dict = {k: 0 for k in KERNEL_NAMES}
BATCH_WIDTHS: dict = {k: {} for k in KERNEL_NAMES if "_batched_" in k}
DEVICE_FN_CALLS: dict = {"count": 0, "mask": 0}
_counts_lock = threading.Lock()


def count_launch(name: str, q: "int | None" = None, valid: bool = False) -> None:
    """One launch of kernel ``name``, counted under the lock; a batched
    kernel's launch also gives its number of queries ``q``, and a launch
    that read a validity plane says so with ``valid``."""
    with _counts_lock:
        LAUNCHES[name] += 1
        if valid:
            VALID_LAUNCHES[name] += 1
        if q is not None:
            BATCH_WIDTHS[name][q] = BATCH_WIDTHS[name].get(q, 0) + 1


def count_device_fn(kind: str) -> None:
    """One exact scan served by the plain ``device_fn``."""
    with _counts_lock:
        DEVICE_FN_CALLS[kind] += 1


def reset_counts() -> None:
    with _counts_lock:
        for d in (LAUNCHES, VALID_LAUNCHES, DEVICE_FN_CALLS):
            for k in d:
                d[k] = 0
        for w in BATCH_WIDTHS.values():
            w.clear()


def on_cuda(t) -> bool:
    """Routing of a kernel wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (the plain version); raises otherwise."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type == "cuda"


class KernelLaunchError(RuntimeError):
    """A C entry point reported a CUDA error at launch (the counterpart's
    ``XlaRuntimeError``: the serving path retries it, then degrades)."""


def check_status(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its return value
    is cudaGetLastError() after the launch)."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc} at launch")


def and_valid(m: torch.Tensor, valid) -> torch.Tensor:
    """A plain version's hits ANDed with the validity operand (None: every
    row live; else a bool plane over the last axis)."""
    return m if valid is None else m & valid


def check_valid(valid, n: int, dev) -> None:
    """A validity operand (None: every row live) is a contiguous 1-D bool
    tensor of the scan's ``n`` rows on its device."""
    if valid is None:
        return
    if valid.dtype != torch.bool or valid.dim() != 1 or valid.shape[0] != n:
        raise ValueError(f"valid must be a 1-D bool tensor of {n} rows")
    if valid.device != dev or not valid.is_contiguous():
        raise ValueError(f"valid must be contiguous on {dev}")


def valid_ptr(valid):
    """The kernels' validity pointer: None (null: every row live) or the
    plane's address, which must be 4-byte aligned (4 rows a word)."""
    if valid is None:
        return None
    if valid.data_ptr() % 4:
        raise ValueError("the validity plane must be 4-byte aligned")
    return valid.data_ptr()
