"""Training substrate of the port: optimizers (``optimizer``), the train
step (``train_step``), checkpoints (``checkpoint``) and elasticity
(``elastic``), each a PyTorch port of ``repro.train``'s module."""
from .optimizer import AdamW, Adafactor, OptConfig, pick_optimizer
from .train_step import make_train_step

__all__ = [
    "AdamW", "Adafactor", "OptConfig", "pick_optimizer", "make_train_step",
]
