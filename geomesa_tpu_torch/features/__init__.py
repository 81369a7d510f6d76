"""Schema model and columnar batches (counterpart: ``geomesa_tpu/features``)."""
