"""The multi-person decode: peaks -> PAF pair scores -> association.

Entry points live in ``tpupose_torch.decode.api`` and are re-exported
here as the reference does: ``decode_maps`` (one image),
``decode_maps_batch`` and ``to_people``.
"""

from tpupose_torch.decode.api import decode_maps, decode_maps_batch, to_people  # noqa: F401
