from .tokenizer import SPECIAL_TOKENS, MMMMTokenizer

__all__ = ["SPECIAL_TOKENS", "MMMMTokenizer"]
