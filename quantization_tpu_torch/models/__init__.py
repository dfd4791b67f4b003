from .quantizer import Quantizer

__all__ = ["Quantizer"]
