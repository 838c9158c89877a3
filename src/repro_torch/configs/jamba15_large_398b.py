"""Jamba-1.5-Large-398B [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every other
layer. No RoPE (Mamba carries position). [arXiv:2403.19887; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    use_rope=False, attn_period=8,
    n_routed_experts=16, moe_top_k=2, d_expert=24576, moe_period=2,
    sub_quadratic=True,
))
