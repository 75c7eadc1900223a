from .io import load, save

__all__ = ["load", "save"]
