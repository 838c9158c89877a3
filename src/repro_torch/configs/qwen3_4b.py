"""Qwen3-4B [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm (per-head RMSNorm on q/k), GQA, tied embeddings, RoPE theta 1e6.
[hf:Qwen/Qwen3-8B family; hf-verified tier]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,

    # the reference's pod setting (a 4B dense model is over-TP'd on a
    # 256-chip pod, so the model axis serves as extra FSDP); kept as a
    # field for the LM sharding slice, unused on one card
    parallelism="fsdp_only", force_microbatches=1,
))
