"""Training: the two-phase quantizer trainer."""

from .trainer import QuantizerTrainer

__all__ = ["QuantizerTrainer"]
