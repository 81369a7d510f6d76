"""The port's command line (``python -m geomesa_tpu_torch.tools``: ``serve``,
``load-driver``) and the measurement tools for its kernels (run on a
machine with a card)."""
