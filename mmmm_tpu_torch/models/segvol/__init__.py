from .config import SamConfig

__all__ = ["SamConfig"]
