"""The result plane (counterpart: ``geomesa_tpu/results/``), trimmed to
the BIN engine selector :mod:`~geomesa_tpu_torch.results.binrider`."""

from geomesa_tpu_torch.results.binrider import bin_engine, resident_bin

__all__ = ["bin_engine", "resident_bin"]
