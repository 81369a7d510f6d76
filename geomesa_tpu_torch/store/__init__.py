"""The stores a resident index stages from (counterpart: ``geomesa_tpu/store``)."""
