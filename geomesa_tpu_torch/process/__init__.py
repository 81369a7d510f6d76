"""Analytic processes (counterpart: ``geomesa_tpu/process``)."""
