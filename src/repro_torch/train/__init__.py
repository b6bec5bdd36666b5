"""Training: the step with acc-planned microbatching, and the acc plan
(``TrainPlan``, ``choose_plan``) beside the serve profiles.  The int8
compressed data-parallel step (``grad_compress``) waits for multi-GPU
(ROADMAP.md A.6)."""
from .autotune import (TrainPlan, choose_plan, make_kernel_tuner,
                       token_profile)
from .train_loop import make_eval_step, make_loss_fn, make_train_step

__all__ = ["make_train_step", "make_eval_step", "make_loss_fn",
           "choose_plan", "TrainPlan", "token_profile", "make_kernel_tuner"]
