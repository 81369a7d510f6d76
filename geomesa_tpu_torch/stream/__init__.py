"""Live-layer messages a streaming index applies (counterpart: ``geomesa_tpu/stream``)."""
