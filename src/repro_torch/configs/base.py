"""ArchConfig: one declarative description drives init/forward/decode
(counterpart of ``repro/configs/base.py``; every field, default, shape
cell and ``reduced`` rule is the reference's, the training knobs
included, and ``ArchConfig.dtype`` returns a torch dtype).

A config expands into a *layer plan*: an optional unrolled prologue plus a
repeating *pattern* of layers whose parameters are stacked ``n_groups``
deep (the reference scans over them; ``repro_torch/models/lm.py`` loops
over views of the stacked leaves). Every assigned architecture is
expressible as (prologue, pattern).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import torch


@dataclass(frozen=True)
class LayerSpec:
    kind: str          # attn | mla | xattn | mamba | mlstm | slstm
    ffn: str = "gated_mlp"  # gated_mlp | mlp | moe | none


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "silu"
    norm: str = "rmsnorm"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    mlp_kind: str = "gated_mlp"      # gated_mlp | mlp (nemotron/whisper)
    tie_embeddings: bool = False
    sub_quadratic: bool = False      # eligible for long_500k
    # --- MoE ---
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    dense_d_ff: int = 0              # d_ff of non-MoE (prologue) layers
    first_k_dense: int = 0
    moe_period: int = 1              # within pattern: MoE on i % period == period-1
    capacity_factor: float = 1.25
    moe_impl: str = "ep"            # ep (shard_map expert-parallel) | gspmd
    moe_expert_axes: str = "model"  # model | data_model (2-D EP, huge E)
    lb_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- hybrid (jamba): 1 attn layer leading each group of attn_period ---
    attn_period: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    # --- ssm (xlstm): 1 sLSTM closing each group of slstm_period ---
    slstm_period: int = 0
    mlstm_proj_factor: float = 2.0
    # --- vlm: 1 gated cross-attn layer leading each group ---
    cross_attn_period: int = 0
    n_vision_tokens: int = 0
    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 0
    learned_pos: bool = False
    max_position_embeddings: int = 0
    # --- runtime knobs (hillclimb levers; overridable per cell) ---
    parallelism: str = "tp"          # tp | fsdp_only (model axis as extra
    #                                  FSDP/DP — right for <=8B dense archs)
    force_microbatches: int = 0      # 0 = use the shape cell default
    remat: str = "full"              # none | full | dots | names
    scan_layers: bool = True
    param_dtype: str = "bfloat16"
    mamba_chunk: int = 128
    rnn_chunk: int = 64
    attn_q_chunk: int = 1024
    attn_k_chunk: int = 1024

    # ------------------------------------------------------------------
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def dtype(self):
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.param_dtype]

    def layer_plan(self) -> Tuple[List[LayerSpec], List[LayerSpec], int]:
        """-> (prologue, pattern, n_groups); decoder stack only."""
        moe = self.n_routed_experts > 0
        if self.family in ("dense", "encdec"):
            return [], [LayerSpec("attn", self.mlp_kind)], self.n_layers
        if self.family == "vlm":
            per = self.cross_attn_period
            pattern = [LayerSpec("xattn", self.mlp_kind)] + \
                [LayerSpec("attn", self.mlp_kind)] * (per - 1)
            return [], pattern, self.n_layers // per
        if self.family == "moe":
            kind = "mla" if self.use_mla else "attn"
            pro = [LayerSpec(kind, "dense_mlp")] * self.first_k_dense
            n_moe = self.n_layers - self.first_k_dense
            pattern = [LayerSpec(kind, "moe")]
            return pro, pattern, n_moe
        if self.family == "hybrid":
            per = self.attn_period
            pattern = []
            for i in range(per):
                kind = "attn" if i == 0 else "mamba"
                ffn = "moe" if (moe and i % self.moe_period == self.moe_period - 1) \
                    else self.mlp_kind
                pattern.append(LayerSpec(kind, ffn))
            return [], pattern, self.n_layers // per
        if self.family == "ssm":
            per = self.slstm_period
            pattern = [LayerSpec("mlstm", "none")] * (per - 1) + \
                      [LayerSpec("slstm", "none")]
            return [], pattern, self.n_layers // per
        raise ValueError(self.family)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape cells (assigned input-shape set for the LM family)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
    n_microbatches: int = 1


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train", n_microbatches=8),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip(full-attn)"
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (one pattern group)."""
    _, pattern, _ = cfg.layer_plan()
    kw = dict(
        n_layers=len(pattern) + min(cfg.first_k_dense, 1),
        d_model=64, n_heads=4,
        n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        first_k_dense=min(cfg.first_k_dense, 1),
        param_dtype="float32",
        mamba_chunk=8, rnn_chunk=8, attn_q_chunk=16, attn_k_chunk=16,
    )
    if cfg.n_routed_experts:
        kw.update(n_routed_experts=8, moe_top_k=min(cfg.moe_top_k, 2),
                  d_expert=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  dense_d_ff=128 if cfg.dense_d_ff else 0)
    if cfg.use_mla:
        kw.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    if cfg.family == "vlm":
        kw.update(n_vision_tokens=8)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=1, n_audio_frames=8,
                  max_position_embeddings=128)
    if cfg.family == "ssm":
        kw.update(n_heads=2, n_kv_heads=2)
    return cfg.with_overrides(name=cfg.name + "-reduced", **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import archs  # noqa: F401  (registers everything)
