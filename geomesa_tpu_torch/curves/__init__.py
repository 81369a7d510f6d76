"""Time binning and dimension quantization for the Z3/Z2 keys (counterpart: ``geomesa_tpu/curves``)."""
