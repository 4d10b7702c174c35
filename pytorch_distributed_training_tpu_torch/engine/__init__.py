"""Training engine of the port: the LM and image data-parallel steps and
the runner."""
from .runner import Runner
from .sp_steps import LMTrainStep, build_lm_eval_step, build_lm_train_step, lm_loss_local
from .steps import ImageTrainStep, build_eval_step, build_eval_step_exact, build_train_step

__all__ = ["ImageTrainStep", "LMTrainStep", "Runner", "build_eval_step", "build_eval_step_exact",
           "build_lm_eval_step", "build_lm_train_step", "build_train_step", "lm_loss_local"]
