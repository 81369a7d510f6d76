"""ECQL parsing and filter compilation (counterpart: ``geomesa_tpu/filter``)."""
