"""Pure-NumPy/SciPy twin of the decode: the golden oracle the tensor
implementations are held against. Not on any production path."""

from tpupose_torch.reference_impl import decode_np  # noqa: F401
