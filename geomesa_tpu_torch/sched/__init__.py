"""Device query scheduler: admission control, micro-batch scan fusion and
backpressure for the serving path.

Counterpart of ``geomesa_tpu/sched/``: a bounded queue and a fixed pool of
workers in front of the card, where N compatible small queries cost less
as ONE stacked launch than as N. See :mod:`geomesa_tpu_torch.sched.scheduler`
for the architecture.
"""

from geomesa_tpu_torch.sched.fusion import FusableQuery, execute_group
from geomesa_tpu_torch.sched.scheduler import (
    LANE_BATCH,
    LANE_INGEST,
    LANE_INTERACTIVE,
    DeadlineExpired,
    QueryScheduler,
    RejectedError,
    SchedConfig,
)

__all__ = [
    "DeadlineExpired",
    "FusableQuery",
    "LANE_BATCH",
    "LANE_INGEST",
    "LANE_INTERACTIVE",
    "QueryScheduler",
    "RejectedError",
    "SchedConfig",
    "execute_group",
]
