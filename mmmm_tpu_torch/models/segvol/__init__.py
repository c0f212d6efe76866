from .config import SamConfig
from .decoder import encode_box_prompt, encode_mask_prompt, encode_point_prompt, encode_prompts
from .sam import sam_forward_prompted

__all__ = ["SamConfig", "encode_box_prompt", "encode_mask_prompt", "encode_point_prompt",
           "encode_prompts", "sam_forward_prompted"]
