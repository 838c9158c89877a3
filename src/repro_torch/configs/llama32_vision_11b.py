"""Llama-3.2-11B-Vision [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — gated cross-attn image layers every 5th layer; vision frontend
stubbed (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0, cross_attn_period=5, n_vision_tokens=1024,
))
