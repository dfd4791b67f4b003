"""Training: the two-phase quantizer trainer, and the trainers of the
auxiliary models (imported when first used, as in the JAX package)."""

from .trainer import QuantizerTrainer, make_optimizer, total_loss

__all__ = [
    "QuantizerTrainer",
    "make_optimizer",
    "total_loss",
    "PredictorTrainer",
    "MultiKmeansTrainer",
]


def __getattr__(name):
    if name == "PredictorTrainer":
        from .predictor_trainer import PredictorTrainer

        return PredictorTrainer
    if name == "MultiKmeansTrainer":
        from .multi_kmeans_trainer import MultiKmeansTrainer

        return MultiKmeansTrainer
    raise AttributeError(name)
