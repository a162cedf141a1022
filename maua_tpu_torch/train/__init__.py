"""StyleGAN2 training: losses, EMA, lookahead-minimax, the train step and its
phases, checkpoints and the CLI (`python -m maua_tpu_torch.train.cli`).
ADA, bCR and the contrastive regularizer are not ported yet."""

from .checkpoint import latest_checkpoint, load_torch_training_checkpoint, restore_checkpoint, save_checkpoint
from .ema import EMA_DECAY_DEFAULT, ema_update
from .lookahead import LookaheadState, lookahead_minimax_init, lookahead_minimax_step
from .losses import d_logistic_loss, d_r1_penalty, g_nonsaturating_loss, g_path_length_regularization
from .step import (
    MixDraw,
    PathDraw,
    StepDraws,
    TrainConfig,
    TrainState,
    draw_step,
    init_train_state,
    make_train_config,
    make_train_phases,
    make_train_step,
    reg_adjusted_adam,
)

__all__ = [
    "EMA_DECAY_DEFAULT",
    "LookaheadState",
    "MixDraw",
    "PathDraw",
    "StepDraws",
    "TrainConfig",
    "TrainState",
    "d_logistic_loss",
    "d_r1_penalty",
    "draw_step",
    "ema_update",
    "g_nonsaturating_loss",
    "g_path_length_regularization",
    "init_train_state",
    "latest_checkpoint",
    "load_torch_training_checkpoint",
    "lookahead_minimax_init",
    "lookahead_minimax_step",
    "make_train_config",
    "make_train_phases",
    "make_train_step",
    "reg_adjusted_adam",
    "restore_checkpoint",
    "save_checkpoint",
]
