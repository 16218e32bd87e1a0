"""Examples on the port's API, counterparts of the repository's
``examples/`` (``python -m sliceslice_tpu_torch.examples.<name>``)."""
