"""Training: the step with acc-planned microbatching, the acc plan
(``TrainPlan``, ``choose_plan``) beside the serve profiles, and the int8
compressed data-parallel step with error feedback (``grad_compress``),
and the FSDP × TP step on a mesh (``sharded``), over
``torch.distributed``."""
from .autotune import (TrainPlan, choose_plan, make_kernel_tuner,
                       token_profile)
from .grad_compress import init_error_feedback, make_compressed_dp_train_step
from .sharded import make_sharded_train_step, shard_batch, shard_train_state
from .train_loop import make_eval_step, make_loss_fn, make_train_step

__all__ = ["make_train_step", "make_eval_step", "make_loss_fn",
           "choose_plan", "TrainPlan", "token_profile", "make_kernel_tuner",
           "make_compressed_dp_train_step", "init_error_feedback",
           "make_sharded_train_step", "shard_train_state", "shard_batch"]
