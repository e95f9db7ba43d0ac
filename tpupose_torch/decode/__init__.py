"""The multi-person decode: peaks -> PAF pair scores -> association.

Entry points live in ``tpupose_torch.decode.api`` (``decode_impl_batch``,
``to_people``).
"""
