"""Scan planes, filter programs and the kernel wrappers (counterpart: ``geomesa_tpu/ops``)."""
