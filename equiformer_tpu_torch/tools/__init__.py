"""Measurement tools of the port, run as ``python -m equiformer_tpu_torch.tools.<name>``."""
