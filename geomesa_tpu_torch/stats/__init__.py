"""Streaming stats sketches + the Stat DSL (counterpart: ``geomesa_tpu/stats``).

Sketches summarize written data; the planner uses them for
selectivity-based strategy costing. All sketches are mergeable (distributed ingest folds partial
sketches) and serializable to JSON for store metadata.
"""

from geomesa_tpu_torch.stats.sketches import (
    Cardinality,
    CountStat,
    Frequency,
    Histogram,
    MinMax,
    TopK,
    Z3HistogramStat,
)
from geomesa_tpu_torch.stats.dsl import parse_stat, SeqStat

__all__ = [
    "MinMax",
    "CountStat",
    "Cardinality",
    "TopK",
    "Frequency",
    "Histogram",
    "Z3HistogramStat",
    "parse_stat",
    "SeqStat",
]
