"""Imports every per-arch config module so registration side-effects run."""
from . import (qwen3_4b, qwen15_4b, llama3_405b, nemotron4_340b,  # noqa: F401
               llama32_vision_11b, jamba15_large_398b, deepseek_v3_671b,
               deepseek_moe_16b, whisper_base, xlstm_1p3b)
