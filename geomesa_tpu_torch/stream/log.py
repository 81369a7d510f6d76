"""Feature-change messages of a live layer: Put, Remove and Clear.

Own copies of the message types of ``geomesa_tpu/stream/log.py``, trimmed
to their fields: the log, its partitions and its replay are not in the
port. ``StreamingDeviceIndex.attach_live`` applies them: a Put upserts its
rows, a Remove evicts its fids, anything else restages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Put:
    """Upsert a batch of features (columns keyed by attribute). ``seq``
    orders messages across a log's partitions."""

    columns: dict
    fids: np.ndarray
    seq: "int | None" = None


@dataclass(frozen=True)
class Remove:
    fids: np.ndarray
    seq: "int | None" = None


@dataclass(frozen=True)
class Clear:
    seq: "int | None" = None
