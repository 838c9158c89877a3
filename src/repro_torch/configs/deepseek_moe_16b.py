"""DeepSeekMoE-16B [moe]: 28L d_model=2048 16H (MHA kv=16) d_expert=1408
vocab=102400 — 2 shared + 64 routed top-6 fine-grained experts, first layer
dense (d_ff=10944). [arXiv:2401.06066; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    n_routed_experts=64, n_shared_experts=2, moe_top_k=6, d_expert=1408,
    first_k_dense=1, dense_d_ff=10944,
))
