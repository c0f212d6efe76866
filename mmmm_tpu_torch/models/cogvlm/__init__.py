from .config import CogVLMConfig, VisionConfig

__all__ = ["CogVLMConfig", "VisionConfig"]
