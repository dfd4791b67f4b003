from .serialization import load_quantizer, save_quantizer

__all__ = ["load_quantizer", "save_quantizer"]
