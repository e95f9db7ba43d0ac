from tpupose_torch.gt import augment, rasterize  # noqa: F401
from tpupose_torch.gt.augment import augment_batch  # noqa: F401
from tpupose_torch.gt.rasterize import create_labels, labels_for_config  # noqa: F401
