"""Pure-NumPy/SciPy oracles of the port, sharing no code with it: the
decode (``decode_np``), the label rasterisation and augmentation warp
(``gt_np``) and the network forward (``model_np``). The tensor
implementations are held against them. Not on any production path."""

from tpupose_torch.reference_impl import decode_np, gt_np  # noqa: F401
