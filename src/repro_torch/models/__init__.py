from .transformer import Model

__all__ = ["Model"]
