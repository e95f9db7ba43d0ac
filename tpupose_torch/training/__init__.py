from tpupose_torch.training.loss import eucl_loss, stagewise_losses  # noqa: F401
from tpupose_torch.training.optimizer import make_optimizer, param_labels  # noqa: F401
from tpupose_torch.training.train import (  # noqa: F401
    TrainState,
    create_state,
    make_eval_step,
    make_preprocessed_step,
    make_train_step,
)
from tpupose_torch.training import checkpoint  # noqa: F401
