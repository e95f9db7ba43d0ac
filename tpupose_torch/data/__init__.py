from tpupose_torch.data import pipeline  # noqa: F401
