"""Measurement scripts of the port, run as ``python -m
sliceslice_tpu_torch.scripts.<name>``."""
