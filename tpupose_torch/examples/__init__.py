"""Runnable examples of the port (``python -m tpupose_torch.examples.<name>``)."""
