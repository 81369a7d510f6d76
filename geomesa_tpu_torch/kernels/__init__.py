"""Hand-written CUDA kernels of the port and their launch counts.

``LAUNCHES`` counts, per kernel variant, the launches its wrapper made
(the wrappers in ``ops/zscan.py``, ``ops/filter_scan.py`` and
``ops/density.py`` add one where they launch, and nowhere else):
``dimscan_*`` (``csrc/dimscan.cu``), ``dimscan_baked_*``
(``csrc/dimscan_baked.cu``), ``zscan_*`` (``csrc/zscan.cu``),
``filter_scan_*`` (``csrc/filter_scan.cu``), ``density_*``
(``csrc/density.cu``).
``DEVICE_FN_CALLS`` counts exact scans that went to the plain
``device_fn`` because the filter-scan encoder refused the filter (the
counterpart's ``PallasUnsupported`` route).
"""

from __future__ import annotations

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
)

LAUNCHES: dict = {k: 0 for k in KERNEL_NAMES}
DEVICE_FN_CALLS: dict = {"count": 0, "mask": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, DEVICE_FN_CALLS):
        for k in d:
            d[k] = 0


def on_cuda(t) -> bool:
    """Routing of a kernel wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (the plain version); raises otherwise."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type == "cuda"


def check_status(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its return value
    is cudaGetLastError() after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
