from tpupose_torch.models import weights  # noqa: F401
from tpupose_torch.models.openpose import OpenPose  # noqa: F401
