"""Training engine of the port: the LM plain-DP steps and the runner."""
from .runner import Runner
from .sp_steps import LMTrainStep, build_lm_eval_step, build_lm_train_step, lm_loss_local

__all__ = ["LMTrainStep", "Runner", "build_lm_eval_step", "build_lm_train_step",
           "lm_loss_local"]
