"""Stat sketches and the stat DSL (counterpart: ``geomesa_tpu/stats``)."""

from geomesa_tpu_torch.stats.dsl import SeqStat, parse_stat

__all__ = ["SeqStat", "parse_stat"]
