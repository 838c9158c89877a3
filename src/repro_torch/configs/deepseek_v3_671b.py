"""DeepSeek-V3-671B [moe]: 61L d_model=7168 128H MLA d_expert=2048
vocab=129280, MoE 1 shared + 256 routed top-8, first 3 layers dense
(d_ff=18432). MLA: q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128.
MTP head available via ``mtp=True`` override (off for dry-run cells).
[arXiv:2412.19437; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab_size=129280,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_routed_experts=256, n_shared_experts=1, moe_top_k=8, d_expert=2048,
    first_k_dense=3, dense_d_ff=18432,
    # 2-D expert parallelism: 256 experts over data x model = 1/device
    # (16/device over model alone = 81 GB of expert weights resident)
    moe_expert_axes="data_model",
))
