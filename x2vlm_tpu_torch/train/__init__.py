"""Training of the port: the AdamW chain and LR schedule of the JAX package
(``optim.py``), the train steps (``trainer.py``), metric logging
(``metrics.py``) and checkpoints (``checkpoint.py``)."""

from x2vlm_tpu_torch.train.optim import (
    AdamW, create_optimizer, is_no_decay, lr_schedule, param_labels,
)
from x2vlm_tpu_torch.train.trainer import make_apply_grads, make_grad_fn, make_train_step

__all__ = ["AdamW", "create_optimizer", "is_no_decay", "lr_schedule", "make_apply_grads",
           "make_grad_fn", "make_train_step", "param_labels"]
