"""The store path's planner, interceptors and runner (counterpart: ``geomesa_tpu/query``)."""
