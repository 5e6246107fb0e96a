"""Training of the port: the AdamW chain and LR schedule of the JAX package
(``optim.py``) and the train step (``trainer.py``)."""

from x2vlm_tpu_torch.train.optim import (
    AdamW, create_optimizer, is_no_decay, lr_schedule, param_labels,
)
from x2vlm_tpu_torch.train.trainer import make_train_step

__all__ = ["AdamW", "create_optimizer", "is_no_decay", "lr_schedule", "make_train_step",
           "param_labels"]
