"""LM training of the port (``repro.train``): the optimizers, the LR
schedule and the restart-exact loop."""

from repro_torch.train.loop import fit, lm_batch_fn, make_train_step
from repro_torch.train.optimizer import Optimizer, adafactor, adamw, get_optimizer
from repro_torch.train.schedule import warmup_cosine

__all__ = ["Optimizer", "adafactor", "adamw", "fit", "get_optimizer", "lm_batch_fn",
           "make_train_step", "warmup_cosine"]
