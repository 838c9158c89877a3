"""Qwen1.5-4B [dense]: 40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936.

QKV bias (Qwen1/1.5 signature), full MHA. [hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0,

    # the reference's pod setting (a 4B dense model is over-TP'd on a
    # 256-chip pod, so the model axis serves as extra FSDP); kept as a
    # field for the LM sharding slice, unused on one card
    parallelism="fsdp_only", force_microbatches=1,
))
