"""The result plane (counterpart: ``geomesa_tpu/results/``): the content
negotiation table (:mod:`~geomesa_tpu_torch.results.negotiate`), the BIN
stream encoder (:mod:`~geomesa_tpu_torch.results.stream`), the columnar
helpers (:mod:`~geomesa_tpu_torch.results.columnar`) and the BIN engine
selector (:mod:`~geomesa_tpu_torch.results.binrider`). The Arrow IPC
encoder is not in the port (ROADMAP section 3)."""

from geomesa_tpu_torch.results.binrider import bin_engine, resident_bin
from geomesa_tpu_torch.results.columnar import capped_batches, with_extra_columns
from geomesa_tpu_torch.results.negotiate import (
    CONTENT_TYPES,
    FORMATS,
    PUSH_CONTENT_TYPES,
    negotiate_format,
)
from geomesa_tpu_torch.results.stream import bin_stream_chunks

__all__ = [
    "CONTENT_TYPES",
    "FORMATS",
    "PUSH_CONTENT_TYPES",
    "bin_engine",
    "bin_stream_chunks",
    "capped_batches",
    "negotiate_format",
    "resident_bin",
    "with_extra_columns",
]
