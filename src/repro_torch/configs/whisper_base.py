"""Whisper-base [audio enc-dec]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — conv frontend STUBBED (input_specs provides post-conv frame
embeddings, 1500 frames), learned positions, LayerNorm + GELU.
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865,
    act="gelu", norm="layernorm", mlp_kind="mlp",
    use_rope=False, learned_pos=True, max_position_embeddings=32768,
    n_audio_frames=1500,
))
