"""The port's data layer, its own copies of ``mmmm_tpu/data``: the
tokenizer, the conversation -> input builder, the dataset transforms (local,
vision-language, grounded report, stage-0 patches), the sampler, the
bucketing batcher and ``MultiDataset``. Host code over numpy; ``.pt.zst``
files need ``zstandard`` and PNG or JPEG images ``PIL``, each imported where
such a file is read."""
from .defs import CE_IGNORE_INDEX, LANGUAGE_TOKEN_TYPE, VISION_TOKEN_TYPE, ConvTurn
from .input_builder import prepare_vlm_inputs
from .tokenizer import SPECIAL_TOKENS, MMMMTokenizer

__all__ = ["CE_IGNORE_INDEX", "LANGUAGE_TOKEN_TYPE", "SPECIAL_TOKENS", "VISION_TOKEN_TYPE",
           "ConvTurn", "MMMMTokenizer", "prepare_vlm_inputs"]
