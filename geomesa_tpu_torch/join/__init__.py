"""The spatial join engine.

Counterpart of ``geomesa_tpu/join/``: Z-range candidate planning with
adaptive strategy selection (``planner``: broadcast, grouped scans, a
sorted Z-interval merge with a skew-splitting escape) and batched
count -> compact refinement (``engine`` and ``ops/join.py``), the device
pass as torch ops on the layout's device and the numpy twin it must equal
bit for bit. ``process/join.py`` routes through here.
"""

from geomesa_tpu_torch.join.engine import (
    JoinEngine,
    JoinIndex,
    JoinResult,
    build_envelope_layout,
    build_join_index,
)
from geomesa_tpu_torch.join.planner import JoinPlan, JoinStats, plan_join

__all__ = [
    "JoinEngine",
    "JoinIndex",
    "JoinResult",
    "JoinPlan",
    "JoinStats",
    "build_envelope_layout",
    "build_join_index",
    "plan_join",
]
