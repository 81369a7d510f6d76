"""Schema -> key-space plumbing (counterpart: ``geomesa_tpu/index``)."""
