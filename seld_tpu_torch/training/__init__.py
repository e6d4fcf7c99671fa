"""Training: loss, StepLR schedule, train / eval / infer steps, checkpoints;
the ``Trainer`` is ``seld_tpu_torch.training.trainer``."""

from seld_tpu_torch.training.checkpoint import (  # noqa: F401
    ROLES, archive_checkpoints, load_checkpoint, save_checkpoint,
)
from seld_tpu_torch.training.loss import bce_loss, mse_loss, seld_loss  # noqa: F401
from seld_tpu_torch.training.schedule import StepLRState, schedule_from_config  # noqa: F401
from seld_tpu_torch.training.steps import (  # noqa: F401
    TrainState, create_train_state, make_eval_step, make_infer_step, make_optimizer,
    make_train_step, set_learning_rate,
)
