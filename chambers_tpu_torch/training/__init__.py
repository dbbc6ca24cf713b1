"""Training harness of the port (``chambers_tpu/training``): the
:class:`Trainer`, checkpoints (``checkpoint``) and LoRA (``lora``)."""

from chambers_tpu_torch.training import checkpoint, lora
from chambers_tpu_torch.training.trainer import TrainState, Trainer

__all__ = ["Trainer", "TrainState", "checkpoint", "lora"]
