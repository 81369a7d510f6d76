"""Device choice for the port (counterpart: ``geomesa_tpu/jaxconf.py``,
device selection only).

Entry points run on the card. The CPU is used only when the caller asks
for it by name (``device="cpu"``), as the CPU tests do; with no CUDA
device and no explicit CPU request, :func:`resolve_device` raises rather
than quietly running the plain versions on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; raises when CUDA is absent unless the CPU was
    asked for explicitly."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use a CUDA device or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the host"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
