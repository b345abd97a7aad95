from . import convnet
from .transformer import Model

__all__ = ["Model", "convnet"]
