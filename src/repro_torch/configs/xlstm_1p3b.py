"""xLSTM-1.3B [ssm]: 48 blocks d_model=2048 4H vocab=50304 — mLSTM (matrix
memory) blocks with one sLSTM block per 8 (7:1 ratio). No FFN (d_ff=0);
blocks carry their own up/down projections. [arXiv:2405.04517; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    use_rope=False, slstm_period=8, mlstm_proj_factor=2.0,
    sub_quadratic=True,
    rnn_chunk=256,   # the reference's chunkwise-mLSTM setting
))
