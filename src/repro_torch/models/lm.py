"""Unified LM: one model assembled from ArchConfig (counterpart of
``repro/models/lm.py``).

Covers every family of ``repro_torch/configs`` — dense / MoE(+MLA) /
hybrid(attn+mamba+MoE) / SSM(xLSTM) / enc-dec(whisper) / VLM(gated
cross-attn) — with the reference's entry points:

- ``forward(params, cfg, inputs, want_cache)`` — training and prefill;
  the repeating layer pattern runs as a Python loop over the groups of
  the stacked parameters, where the reference scans, each group body
  rematerialised as ``cfg.remat`` says (below).
- ``decode_step(params, cfg, cache, token, pos)`` — one serving step
  against a KV/state cache whose layout mirrors the stacked parameters.
  It writes the new token's K/V and the new recurrent states into
  ``cache`` IN PLACE and returns that same tree (the reference returns a
  new one): a cache that has been decoded into holds the new step.
- ``prefill`` — ``forward`` with caches padded to ``max_len`` and the last
  position's logits; ``init_cache`` — an empty cache.
- ``param_shapes`` / ``count_params`` — init on the meta device, the
  counterpart of ``jax.eval_shape``: nothing is allocated.

Parameters are the reference's pytree: nested dicts of tensors, dense
``w`` (in, out), the block stack with a leading ``n_groups`` axis, so
``repro_torch/convert.py`` carries JAX weights across as they are.
Modality frontends (whisper conv / vision encoder) are stubs, as in the
reference: ``inputs`` carries precomputed frame/patch embeddings.

Under a mesh (``distributed/act_sharding.py::use_mesh``) the parameters
and inputs are ``DTensor``s and the reference's ``constrain`` calls
redistribute the activations at the same places; without one they return
their input, and nothing changes. Where the reference leaves a
cross-device reduction to XLA, the port writes it: the vocab-sharded
logits of the loss are gathered on the vocab dim (``_vocab_whole``), and
a sequence-parallel decode cache is written and read block by block
(``attention.write_slot``, ``attention.decode_attention``'s split
over the sequence).

The stack is unbound once per forward (``_unstack``): group g's leaves
are views of it, and autograd's backward of the unbind is one ``stack``
of the groups' gradients. Indexing the stack group by group would make
each group's backward write a zero tensor of the whole stack's size.

``cfg.remat`` (training: autograd on, no cache), the reference's
``jax.checkpoint`` policies as non-reentrant ``torch.utils.checkpoint``
around each group body:

- ``none``: every activation kept;
- ``full``: only the group's inputs kept, the body recomputed in the
  backward;
- ``dots``: selective checkpointing that keeps the outputs of
  ``aten.mm`` / ``aten.addmm`` (the products without batch dims, as
  ``dots_with_no_batch_dims_saveable``) and recomputes the rest,
  ``bmm`` included;
- ``names``: keeps only the self-attention outputs, which pass through
  the identity op ``repro_torch::checkpoint_name`` (the reference's
  ``checkpoint_name(o, "attn_out")``) that the policy must save.

Recomputation runs the same ops on the same values: every mode gives the
same loss and gradients, bitwise on the CPU.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.distributed.act_sharding import (constrain, current_mesh,
                                                  gather_weights, mixer)
from repro_torch.nn import attention as att
from repro_torch.nn import module as nn
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import moe_ep as moe_ep_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, Any]
CACHE_KEYS = ("k", "v", "ckv", "krope")   # padded to max_len by prefill


def _zero_aux(device):
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero, "drop_frac": zero}


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def _group(tree, g: int):
    """Group ``g`` of a stacked tree: views, so writes land in the stack."""
    return tree_map(lambda x: x[g], tree)


def _unstack(tree, n: int):
    """The ``n`` groups of a stacked tree, each leaf unbound once: views
    of the stack whose backward is one ``stack``."""
    leaves = [torch.unbind(x) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [x[g] for x in leaves]) for g in range(n)]


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


# ===========================================================================
# Remat
# ===========================================================================

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity (a copy) that the ``names`` policy saves: the reference's
    ``jax.ad_checkpoint.checkpoint_name``."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_names(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.checkpoint_name.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"dots": _save_dots, "names": _save_names}


def _rematted(remat: str, body):
    """``body`` checkpointed as ``remat`` says (``none``: as it is)."""
    if remat == "none":
        return body
    if remat not in ("full",) + tuple(_POLICIES):
        raise ValueError(f"remat {remat!r}: none | full | dots | names")
    kw = {}
    if remat in _POLICIES:
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _POLICIES[remat])
    return lambda *args: checkpoint(body, *args, use_reentrant=False, **kw)


# ===========================================================================
# Per-layer init
# ===========================================================================

def _attn_init(g, cfg: ArchConfig, dev) -> Params:
    d, hd = cfg.d_model, cfg.hd()
    H, KH = cfg.n_heads, cfg.n_kv_heads
    kw = dict(dtype=cfg.dtype(), device=dev)
    p = {
        "wq": nn.dense_init(g, d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": nn.dense_init(g, d, KH * hd, bias=cfg.qkv_bias, **kw),
        "wv": nn.dense_init(g, d, KH * hd, bias=cfg.qkv_bias, **kw),
        "wo": nn.dense_init(g, H * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = nn.rmsnorm_init(hd, **kw)
        p["k_norm"] = nn.rmsnorm_init(hd, **kw)
    return p


def _mla_init(g, cfg: ArchConfig, dev) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    kw = dict(dtype=cfg.dtype(), device=dev)
    return {
        "wq_a": nn.dense_init(g, d, qr, **kw),
        "q_norm": nn.rmsnorm_init(qr, **kw),
        "wq_b": nn.dense_init(g, qr, H * (dn + dr), **kw),
        "wkv_a": nn.dense_init(g, d, kr + dr, **kw),
        "kv_norm": nn.rmsnorm_init(kr, **kw),
        "wkv_b": nn.dense_init(g, kr, H * (dn + dv), **kw),
        "wo": nn.dense_init(g, H * dv, d, **kw),
    }


def _ffn_init(g, cfg: ArchConfig, ffn: str, dev) -> Params:
    d = cfg.d_model
    kw = dict(dtype=cfg.dtype(), device=dev)
    if ffn == "gated_mlp":
        return moe_lib.gated_mlp_init(g, d, cfg.d_ff, **kw)
    if ffn == "mlp":
        return moe_lib.mlp_init(g, d, cfg.d_ff, **kw)
    if ffn == "dense_mlp":  # deepseek prologue: gated MLP at dense_d_ff
        return moe_lib.gated_mlp_init(g, d, cfg.dense_d_ff, **kw)
    if ffn == "moe":
        return moe_lib.moe_init(g, d, cfg.d_expert, cfg.n_routed_experts,
                                cfg.n_shared_experts, **kw)
    raise ValueError(ffn)


def _layer_init(g, cfg: ArchConfig, spec: LayerSpec, dev) -> Params:
    norm_init, _ = nn.make_norm(cfg.norm)
    d, dt = cfg.d_model, cfg.dtype()
    kw = dict(dtype=dt, device=dev)
    p: Params = {"norm1": norm_init(d, **kw)}
    if spec.kind == "attn":
        p["mix"] = _attn_init(g, cfg, dev)
    elif spec.kind == "xattn":
        p["mix"] = _attn_init(g, cfg, dev)
        p["gate_attn"] = torch.zeros((), **kw)
        p["gate_ffn"] = torch.zeros((), **kw)
    elif spec.kind == "dec_attn":
        p["mix"] = {"self": _attn_init(g, cfg, dev),
                    "cross": _attn_init(g, cfg, dev)}
        p["norm_cross"] = norm_init(d, **kw)
    elif spec.kind == "mla":
        p["mix"] = _mla_init(g, cfg, dev)
    elif spec.kind == "mamba":
        p["mix"] = ssm_lib.mamba_init(
            g, d, expand=cfg.mamba_expand, d_state=cfg.mamba_d_state,
            d_conv=cfg.mamba_d_conv, **kw)
    elif spec.kind == "mlstm":
        p["mix"] = ssm_lib.mlstm_init(
            g, d, cfg.n_heads, proj_factor=cfg.mlstm_proj_factor,
            d_conv=cfg.mamba_d_conv, **kw)
    elif spec.kind == "slstm":
        p["mix"] = ssm_lib.slstm_init(g, d, cfg.n_heads, **kw)
    else:
        raise ValueError(spec.kind)
    if spec.ffn != "none":
        p["norm2"] = norm_init(d, **kw)
        p["ffn"] = _ffn_init(g, cfg, spec.ffn, dev)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device=None) -> Params:
    """Random weights drawn from ``generator`` on ``device`` (default: the
    generator's). Every stacked leaf is filled group by group
    (``nn.stack_init``) and every leaf drawn in float32 and cast on its
    own, so the peak stays near the model's own bytes."""
    dev = nn.init_device(generator, device)
    dt = cfg.dtype()
    prologue, pattern, n_groups = _pattern(cfg)
    norm_init, _ = nn.make_norm(cfg.norm)
    g = generator
    p: Params = {"embed": nn.embedding_init(g, cfg.vocab_size, cfg.d_model,
                                            dtype=dt, device=dev)}
    if cfg.learned_pos:
        p["pos_emb"] = nn.embedding_init(
            g, cfg.max_position_embeddings, cfg.d_model, dtype=dt,
            device=dev)

    if cfg.family == "encdec":
        enc_spec = LayerSpec("attn", cfg.mlp_kind)
        p["enc"] = {
            "pos": nn.embedding_init(g, cfg.n_audio_frames, cfg.d_model,
                                     dtype=dt, device=dev),
            "blocks": nn.stack_init(
                lambda k: _layer_init(k, cfg, enc_spec, dev), g,
                cfg.n_encoder_layers),
            "norm": norm_init(cfg.d_model, dtype=dt, device=dev),
        }

    if prologue:
        p["prologue"] = {str(i): _layer_init(g, cfg, spec, dev)
                         for i, spec in enumerate(prologue)}

    def group_init(k):
        return {str(i): _layer_init(k, cfg, spec, dev)
                for i, spec in enumerate(pattern)}

    p["blocks"] = nn.stack_init(group_init, g, n_groups)
    p["final_norm"] = norm_init(cfg.d_model, dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(g, cfg.d_model, cfg.vocab_size,
                                     dtype=dt, device=dev)
    return p


def _pattern(cfg: ArchConfig):
    prologue, pattern, n_groups = cfg.layer_plan()
    if cfg.family == "encdec":
        pattern = [LayerSpec("dec_attn", cfg.mlp_kind)]
    return prologue, pattern, n_groups


# ===========================================================================
# Per-layer forward (full sequence)
# ===========================================================================

def _split_last(t: torch.Tensor, *sizes) -> torch.Tensor:
    """(..., prod(sizes)) -> (..., *sizes). A ``DTensor`` sharded on its
    last dim over more blocks than ``sizes[0]`` (the heads) divides into
    is gathered on that dim first: DTensor cannot split a block across a
    head (the reference's GSPMD reshards there too)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        last = t.dim() - 1
        mesh = t.device_mesh
        k = 1
        for i, pl in enumerate(t.placements):
            if pl.is_shard(last):
                k *= mesh.size(i)
        if k > 1 and sizes[0] % k:
            t = t.redistribute(mesh, [Replicate() if pl.is_shard(last)
                                      else pl for pl in t.placements])
    return t.reshape(*t.shape[:-1], *sizes)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """A (batch, ..., heads, head_dim) activation pinned to the batch
    axes and "model" on its heads (under a mesh, as ``moe._ff``)."""
    return constrain(t, "dp", *([None] * (t.dim() - 3)), "tp", None)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, T, H, d) -> (B, T, H * d). Under a mesh the merged dim is
    sharded on "model" only where the heads are: a split of a merged dim
    whose shards cut a head (the backward of this reshape) is refused by
    DTensor (torch 2.11), so such a gradient is gathered here first."""
    B, T = o.shape[:2]
    merged = o.reshape(B, T, -1)
    from torch.distributed.tensor import DTensor
    if isinstance(o, DTensor):
        tp = "tp" if any(p.is_shard(2) for p in o.placements) else None
        merged = constrain(merged, "dp", None, tp)
    return merged


def _local_name(o: torch.Tensor, name: str) -> torch.Tensor:
    """``checkpoint_name``; on a ``DTensor``, on its local block (a custom
    op has no sharding rule)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(o, DTensor):
        return checkpoint_name(o, name)
    return DTensor.from_local(checkpoint_name(o.to_local(), name),
                              o.device_mesh, o.placements, run_check=False)


def _flash(q, k, v, **kw):
    """``att.flash_attention``; on ``DTensor``s, run on each rank's local
    blocks (attention never mixes batch rows or heads): q, k and v are
    laid out batch-sharded as q is, heads sharded where q's are and the
    KV heads divide as well, everything else whole, and the output keeps
    that layout. DTensor's own choice for the ops of the chunked loop may
    shard the sequence, which its backward cannot always follow."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return att.flash_attention(q, k, v, **kw)
    mesh = q.device_mesh
    heads = 1
    for i, pl in enumerate(q.placements):
        if pl.is_shard(2):
            heads *= mesh.size(i)
    split = heads > 1 and k.shape[2] % heads == 0
    pl = [Shard(0) if p.is_shard(0) else
          (Shard(2) if p.is_shard(2) and split else Replicate())
          for p in q.placements]
    q, k, v = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
    o = att.flash_attention(q, k, v, **kw)
    return DTensor.from_local(o, mesh, pl, run_check=False)


def _qkv(p, cfg: ArchConfig, x, memory=None):
    """q from x; k, v from ``memory`` (cross) or x; per-head RMSNorm."""
    B, T, _ = x.shape
    hd, H, KH = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    src = x if memory is None else memory
    q = _heads(_split_last(nn.dense(p["wq"], x), H, hd))
    k = _heads(_split_last(nn.dense(p["wk"], src), KH, hd))
    v = _heads(_split_last(nn.dense(p["wv"], src), KH, hd))
    if cfg.qk_norm:
        q = nn.rmsnorm(p["q_norm"], q)
        k = nn.rmsnorm(p["k_norm"], k)
    return q, k, v


def _self_attention(p, cfg: ArchConfig, x, positions, *, causal=True,
                    want_cache=False, name_attn=False):
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        q = att.apply_rope(q, positions, cfg.rope_theta)
        k = att.apply_rope(k, positions, cfg.rope_theta)
    o = _flash(q, k, v, causal=causal,
               q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    if name_attn:
        o = _local_name(o, "attn_out")
    out = moe_lib.rows(nn.dense(p["wo"], _merge_heads(_heads(o))))
    return out, ({"k": k, "v": v} if want_cache else None)


def _cross_attention(p, cfg: ArchConfig, x, memory, *, want_cache=False):
    q, k, v = _qkv(p, cfg, x, memory)
    o = _flash(q, k, v, causal=False,
               q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    out = moe_lib.rows(nn.dense(p["wo"], _merge_heads(_heads(o))))
    return out, ({"mk": k, "mv": v} if want_cache else None)


def _mla_attention(p, cfg: ArchConfig, x, positions, *, want_cache=False):
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    # the low-rank activations pinned whole on "model" (their gradients
    # are summed there, not reduce-scattered over the tokens)
    q_a = constrain(nn.dense(p["wq_a"], x), "dp", None, None)
    q = nn.dense(p["wq_b"], nn.rmsnorm(p["q_norm"], q_a))
    q = _split_last(q, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = att.apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = constrain(nn.dense(p["wkv_a"], x), "dp", None, None)
    ckv = nn.rmsnorm(p["kv_norm"], kv_a[..., :kr])           # (B,T,R)
    krope = att.apply_rope(kv_a[..., kr:].reshape(B, T, 1, dr), positions,
                           cfg.rope_theta)                   # (B,T,1,dr)
    kv = _split_last(nn.dense(p["wkv_b"], ckv), H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, krope.expand(B, T, H, dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    o = _flash(qf, k, v, causal=True, scale=(dn + dr) ** -0.5,
               q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    out = moe_lib.rows(nn.dense(p["wo"], _merge_heads(o)))
    cache = {"ckv": ckv, "krope": krope[:, :, 0]} if want_cache else None
    return out, cache


# each recurrent mixer's (sequence, decode step) functions
MIXERS = {"mamba": (ssm_lib.mamba_apply, ssm_lib.mamba_step),
           "mlstm": (ssm_lib.mlstm_apply, ssm_lib.mlstm_step),
           "slstm": (ssm_lib.slstm_apply, ssm_lib.slstm_step)}


def _mixer(cfg: ArchConfig, kind: str, x, p, *state, **kw):
    """A recurrent mixer of ``nn/ssm.py`` over the sequence (with a decode
    ``state``: one step) through ``act_sharding.mixer``: on "model" under
    a mesh's "tp" profile."""
    fn = MIXERS[kind][1 if state else 0]
    if kind == "mamba":
        kw["d_state"] = cfg.mamba_d_state
    else:
        kw["n_heads"] = cfg.n_heads
    return mixer(fn, lambda n: ssm_lib.tp_layout(kind, p, cfg.n_heads, n), x,
                 p, *state, **kw)


def _ffn_apply(p, cfg: ArchConfig, x, ffn: str, *, full_capacity=False):
    if ffn in ("gated_mlp", "dense_mlp"):
        return moe_lib.gated_mlp(p, x, cfg.act), _zero_aux(x.device)
    if ffn == "mlp":
        return moe_lib.mlp(p, x, cfg.act), _zero_aux(x.device)
    if ffn == "moe":
        cf = cfg.capacity_factor
        if full_capacity:  # decode is dropless: capacity == token count
            cf = cfg.n_routed_experts / cfg.moe_top_k
        if cfg.moe_impl == "ep":
            return moe_ep_lib.moe_apply_ep(
                p, x, top_k=cfg.moe_top_k, act=cfg.act, capacity_factor=cf,
                expert_axes=cfg.moe_expert_axes, mesh=current_mesh())
        return moe_lib.moe_apply(p, x, top_k=cfg.moe_top_k, act=cfg.act,
                                 capacity_factor=cf)
    raise ValueError(ffn)


def _layer_apply(p, cfg: ArchConfig, spec: LayerSpec, h, ctx, *,
                 want_cache=False):
    """-> (h, aux, cache)."""
    _, norm = nn.make_norm(cfg.norm)
    p = gather_weights(p)
    x = norm(p["norm1"], h)
    cache: Dict[str, Any] = {}
    aux = _zero_aux(h.device)

    if spec.kind == "attn":
        out, cache["self"] = _self_attention(
            p["mix"], cfg, x, ctx["positions"],
            causal=ctx.get("causal", True), want_cache=want_cache,
            name_attn=ctx.get("name_attn", False))
        h = h + out
    elif spec.kind == "mla":
        out, cache["self"] = _mla_attention(p["mix"], cfg, x,
                                            ctx["positions"],
                                            want_cache=want_cache)
        h = h + out
    elif spec.kind == "xattn":
        out, cache["cross"] = _cross_attention(p["mix"], cfg, x,
                                               ctx["memory"],
                                               want_cache=want_cache)
        h = h + torch.tanh(p["gate_attn"]) * out
        if spec.ffn != "none":
            f, aux = _ffn_apply(p["ffn"], cfg, norm(p["norm2"], h), spec.ffn)
            h = h + torch.tanh(p["gate_ffn"]) * f
        return h, aux, (cache if want_cache else None)
    elif spec.kind == "dec_attn":
        out, cache["self"] = _self_attention(
            p["mix"]["self"], cfg, x, ctx["positions"], causal=True,
            want_cache=want_cache, name_attn=ctx.get("name_attn", False))
        h = h + out
        xc = norm(p["norm_cross"], h)
        out2, cache["cross"] = _cross_attention(
            p["mix"]["cross"], cfg, xc, ctx["memory"], want_cache=want_cache)
        h = h + out2
    elif spec.kind in MIXERS:
        res = _mixer(cfg, spec.kind, x, p["mix"], return_state=want_cache,
                     chunk=(cfg.mamba_chunk if spec.kind == "mamba"
                            else cfg.rnn_chunk))
        out, cache["state"] = res if want_cache else (res, None)
        h = h + out
    else:
        raise ValueError(spec.kind)

    if spec.ffn != "none":
        f, aux = _ffn_apply(p["ffn"], cfg, norm(p["norm2"], h), spec.ffn)
        h = h + f
    return h, aux, (cache if want_cache else None)


# ===========================================================================
# Encoder (whisper)
# ===========================================================================

def _gather_top(params: Params) -> Params:
    """The weights outside the layer stacks gathered
    (``act_sharding.gather_weights``; each layer gathers its own)."""
    out = dict(params)
    for k, v in params.items():
        if k not in ("blocks", "prologue", "enc"):
            out[k] = gather_weights(v)
    if "enc" in params:
        out["enc"] = dict(params["enc"], pos=gather_weights(
            params["enc"]["pos"]), norm=gather_weights(params["enc"]["norm"]))
    return out


def encode(params: Params, cfg: ArchConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d_model) post-conv stub embeddings -> (B, F, d)."""
    _, norm = nn.make_norm(cfg.norm)
    enc = params["enc"]
    F_ = frames.shape[1]
    # the table's rows may be sharded on "model": the sum is pinned to the
    # batch axes (as the decoder's learned positions are), else the frames
    # keep the rows' shards and the layers' products meet a strided shard
    # of the flattened (batch, frames) rows that DTensor cannot propagate
    h = constrain(frames + enc["pos"]["table"][None, :F_], "dp", None, None)
    spec = LayerSpec("attn", cfg.mlp_kind)
    ctx = {"positions": torch.arange(F_, device=frames.device),
           "causal": False}
    for lp in _unstack(enc["blocks"], cfg.n_encoder_layers):
        h, _, _ = _layer_apply(lp, cfg, spec, h, ctx)
        h = constrain(h, "dp", None, None)
    return norm(enc["norm"], h)


# ===========================================================================
# Forward (train / prefill)
# ===========================================================================

def _group_body(gp, cfg: ArchConfig, pattern, h, aux, ctx, want_cache):
    """One group of the repeating pattern -> (h, aux, caches|None)."""
    caches = {}
    for i, spec in enumerate(pattern):
        h, a, c = _layer_apply(gp[str(i)], cfg, spec, h, ctx,
                               want_cache=want_cache)
        h = constrain(h, "dp", None, None)
        aux = _add_aux(aux, a)
        if want_cache:
            caches[str(i)] = c
    return h, aux, (caches if want_cache else None)


def forward(params: Params, cfg: ArchConfig, inputs: Dict[str, Any], *,
            want_cache: bool = False):
    """inputs: {tokens (B,T)[, vision (B,Nv,d) | frames (B,F,d)]}.

    -> (h_final (B,T,d), aux, cache|None). Apply ``logits``/``loss`` on top.
    Under autograd and without a cache, each group body is
    rematerialised as ``cfg.remat`` says.
    """
    prologue, pattern, n_groups = _pattern(cfg)
    _, norm = nn.make_norm(cfg.norm)
    params = _gather_top(params)
    tokens = inputs["tokens"]
    T = tokens.shape[1]
    h = nn.embedding(params["embed"], tokens)
    h = constrain(h, "dp", None, None)
    positions = torch.arange(T, device=tokens.device)
    if cfg.learned_pos:
        # the table's rows may be sharded on "model": the sum is pinned
        # back to the batch axes (a full-length slice keeps the rows'
        # shards on the tokens)
        h = constrain(h + params["pos_emb"]["table"][None, :T],
                      "dp", None, None)

    memory = None
    if cfg.family == "encdec":
        memory = encode(params, cfg, inputs["frames"])
    elif cfg.family == "vlm":
        memory = inputs["vision"]
    remat = (cfg.remat if torch.is_grad_enabled() and not want_cache
             else "none")
    ctx = {"positions": positions, "memory": memory, "causal": True,
           "name_attn": remat == "names"}

    aux = _zero_aux(h.device)
    pro_caches = {}
    for i, spec in enumerate(prologue):
        h, a, c = _layer_apply(params["prologue"][str(i)], cfg, spec, h, ctx,
                               want_cache=want_cache)
        aux = _add_aux(aux, a)
        if want_cache:
            pro_caches[str(i)] = c

    body = _rematted(remat, _group_body)
    blk_caches = []
    for gp in _unstack(params["blocks"], n_groups):
        h, aux, caches = body(gp, cfg, pattern, h, aux, ctx, want_cache)
        blk_caches.append(caches)
    h = norm(params["final_norm"], h)

    cache = None
    if want_cache:
        cache = {"prologue": pro_caches, "blocks": _stack(blk_caches),
                 "memory": memory}
    return h, aux, cache


def logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:   # the embedding table, transposed
        return h @ params["embed"]["table"].transpose(0, 1)
    return nn.dense(params["lm_head"], h)


def _vocab_whole(lg: torch.Tensor) -> torch.Tensor:
    """A logits chunk with its vocab dim whole on every rank: a
    vocab-sharded ``DTensor`` (a "tp" profile's head) is gathered on that
    dim, a (B, ck, V) all-gather, so ``logsumexp`` and the label's
    ``gather`` run on local rows; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(lg, DTensor):
        return lg
    last = lg.dim() - 1
    if not any(isinstance(p, Shard) and p.dim == last
               for p in lg.placements):
        return lg
    return lg.redistribute(lg.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == last else p
        for p in lg.placements])


def loss_fn(params: Params, cfg: ArchConfig, inputs: Dict[str, Any], *,
            loss_chunk: int = 512):
    """Next-token CE, chunked over T so (B,T,V) logits are never resident.
    Labels < 0 are masked out."""
    h, aux, _ = forward(params, cfg, inputs)
    params = _gather_top(params)
    labels = inputs["labels"]
    T = h.shape[1]
    ck = min(loss_chunk, T)
    while T % ck:
        ck //= 2

    if cfg.tie_embeddings:
        head = params["embed"]["table"].transpose(0, 1)     # (d, V)
    else:
        head = params["lm_head"]["w"]                       # (d, V)

    ce_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=h.device)
    for t0 in range(0, T, ck):
        lg = _vocab_whole(constrain((h[:, t0:t0 + ck] @ head).float(),
                                    "dp", None, "tp"))
        ls = labels[:, t0:t0 + ck]
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, ls.clamp(min=0)[..., None])[..., 0]
        valid = (ls >= 0).float()
        ce_sum = ce_sum + torch.sum((lse - ll) * valid)
        n_tok = n_tok + torch.sum(valid)
    ce = ce_sum / torch.clamp(n_tok, min=1.0)
    total = ce + cfg.lb_loss_weight * aux["lb_loss"] \
        + cfg.z_loss_weight * aux["z_loss"]
    metrics = {"ce": ce, "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"],
               "drop_frac": aux["drop_frac"]}
    return total, metrics


# ===========================================================================
# Cache + decode
# ===========================================================================

def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                 device):
    kw = dict(dtype=cfg.dtype(), device=device)
    hd, KH = cfg.hd(), cfg.n_kv_heads
    d = cfg.d_model

    def kv(S):
        return torch.zeros((batch, S, KH, hd), **kw)

    if spec.kind == "attn":
        return {"self": {"k": kv(max_len), "v": kv(max_len)}}
    if spec.kind == "mla":
        return {"self": {
            "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **kw),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                 **kw)}}
    if spec.kind == "xattn":
        nv = cfg.n_vision_tokens
        return {"cross": {"mk": kv(nv), "mv": kv(nv)}}
    if spec.kind == "dec_attn":
        nf = cfg.n_audio_frames
        return {"self": {"k": kv(max_len), "v": kv(max_len)},
                "cross": {"mk": kv(nf), "mv": kv(nf)}}
    if spec.kind == "mamba":
        return {"state": ssm_lib.mamba_init_state(
            batch, cfg.mamba_expand * d, cfg.mamba_d_conv, cfg.mamba_d_state,
            **kw)}
    if spec.kind == "mlstm":
        return {"state": ssm_lib.mlstm_init_state(
            batch, int(cfg.mlstm_proj_factor * d), cfg.n_heads,
            cfg.mamba_d_conv, **kw)}
    if spec.kind == "slstm":
        return {"state": ssm_lib.slstm_init_state(
            batch, cfg.n_heads, d // cfg.n_heads, device=device)}
    raise ValueError(spec.kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    """An empty cache: per layer K/V (or MLA latent) slots for ``max_len``
    positions, cross-attention memory K/V, recurrent states; the block
    stack's leaves lead with ``n_groups``."""
    prologue, pattern, n_groups = _pattern(cfg)
    group = {str(i): _layer_cache(cfg, spec, batch, max_len, device)
             for i, spec in enumerate(pattern)}
    blocks = tree_map(lambda x: x[None].repeat(
        (n_groups,) + (1,) * x.dim()), group)
    pro = {str(i): _layer_cache(cfg, spec, batch, max_len, device)
           for i, spec in enumerate(prologue)}
    return {"prologue": pro, "blocks": blocks}


def _attn_decode(p, cfg: ArchConfig, x, c, pos: int):
    """x: (B, d); c: {"k","v"} caches; write at ``pos`` then attend."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x[:, None])
    if cfg.use_rope:
        pp = torch.full((1,), pos, device=x.device)
        q = att.apply_rope(q, pp, cfg.rope_theta)
        k = att.apply_rope(k, pp, cfg.rope_theta)
    att.write_slot(c["k"], pos, k[:, 0])
    att.write_slot(c["v"], pos, v[:, 0])
    o = att.decode_attention(q[:, 0], c["k"], c["v"], pos)
    return nn.dense(p["wo"], o.reshape(B, -1))


def _cross_decode(p, cfg: ArchConfig, x, c):
    B = x.shape[0]
    hd, H = cfg.hd(), cfg.n_heads
    q = _split_last(nn.dense(p["wq"], x), H, hd)[:, None]
    if cfg.qk_norm:
        q = nn.rmsnorm(p["q_norm"], q)
    S = c["mk"].shape[1]
    o = att.decode_attention(q[:, 0], c["mk"], c["mv"], S - 1)
    return nn.dense(p["wo"], o.reshape(B, H * hd))


def _mla_decode(p, cfg: ArchConfig, x, c, pos: int):
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    q = nn.dense(p["wq_b"], nn.rmsnorm(p["q_norm"], nn.dense(p["wq_a"], x)))
    q = _split_last(q, H, dn + dr)[:, None]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pp = torch.full((1,), pos, device=x.device)
    q_rope = att.apply_rope(q_rope, pp, cfg.rope_theta)

    kv_a = nn.dense(p["wkv_a"], x)
    ckv_new = nn.rmsnorm(p["kv_norm"], kv_a[..., :kr])
    krope_new = att.apply_rope(kv_a[..., kr:].reshape(B, 1, 1, dr), pp,
                               cfg.rope_theta)[:, 0, 0]
    att.write_slot(c["ckv"], pos, ckv_new)
    att.write_slot(c["krope"], pos, krope_new)

    wkv_b = _split_last(p["wkv_b"]["w"], H, dn + dv)
    w_kb_k = wkv_b[..., :dn].permute(1, 0, 2)     # (H, R, dn)
    w_kb_v = wkv_b[..., dn:].permute(1, 0, 2)     # (H, R, dv)
    o = att.mla_decode_attention(q_nope[:, 0], q_rope[:, 0], c["ckv"],
                                 c["krope"], w_kb_k, w_kb_v, pos,
                                 scale=(dn + dr) ** -0.5)
    return nn.dense(p["wo"], o.reshape(B, H * dv))


def _write_state(dst, src):
    for d_leaf, s_leaf in zip(dst, src):
        d_leaf.copy_(s_leaf)


def _layer_decode(p, cfg: ArchConfig, spec: LayerSpec, h, c, pos: int):
    """h: (B, d) -> h; writes this layer's new cache entries into ``c``."""
    _, norm = nn.make_norm(cfg.norm)
    p = gather_weights(p)
    x = norm(p["norm1"], h)
    if spec.kind == "attn":
        h = h + _attn_decode(p["mix"], cfg, x, c["self"], pos)
    elif spec.kind == "mla":
        h = h + _mla_decode(p["mix"], cfg, x, c["self"], pos)
    elif spec.kind == "xattn":
        out = _cross_decode(p["mix"], cfg, x, c["cross"])
        h = h + torch.tanh(p["gate_attn"]) * out
        if spec.ffn != "none":
            f, _ = _ffn_apply(p["ffn"], cfg, norm(p["norm2"], h)[:, None],
                              spec.ffn, full_capacity=True)
            h = h + torch.tanh(p["gate_ffn"]) * f[:, 0]
        return h
    elif spec.kind == "dec_attn":
        h = h + _attn_decode(p["mix"]["self"], cfg, x, c["self"], pos)
        xc = norm(p["norm_cross"], h)
        h = h + _cross_decode(p["mix"]["cross"], cfg, xc, c["cross"])
    elif spec.kind in MIXERS:
        out, st = _mixer(cfg, spec.kind, x, p["mix"], c["state"])
        _write_state(c["state"], st)
        h = h + out
    else:
        raise ValueError(spec.kind)

    if spec.ffn != "none":
        f, _ = _ffn_apply(p["ffn"], cfg, norm(p["norm2"], h)[:, None],
                          spec.ffn, full_capacity=True)
        h = h + f[:, 0]
    return h


def decode_step(params: Params, cfg: ArchConfig, cache, token: torch.Tensor,
                pos: int):
    """token: (B,) int; pos: the slot the new token is written at (the
    current length). -> (logits (B, V), cache), ``cache`` updated in
    place."""
    pos = int(pos)
    prologue, pattern, n_groups = _pattern(cfg)
    _, norm = nn.make_norm(cfg.norm)
    params = _gather_top(params)
    h = nn.embedding(params["embed"], token)
    if cfg.learned_pos:
        h = h + params["pos_emb"]["table"][pos]

    for i, spec in enumerate(prologue):
        h = _layer_decode(params["prologue"][str(i)], cfg, spec, h,
                          cache["prologue"][str(i)], pos)
    for g in range(n_groups):
        gp = _group(params["blocks"], g)
        gc = _group(cache["blocks"], g)
        for i, spec in enumerate(pattern):
            h = _layer_decode(gp[str(i)], cfg, spec, h, gc[str(i)], pos)
    h = norm(params["final_norm"], h)
    return logits(params, cfg, h), cache


def _pad_caches(tree, axis: int, max_len: int):
    """K/V and MLA latent caches zero-padded on ``axis`` to ``max_len``;
    cross-attention memory K/V and recurrent states as they are."""
    if isinstance(tree, dict):
        return {k: (_pad_to(v, axis, max_len) if k in CACHE_KEYS
                    else _pad_caches(v, axis, max_len))
                for k, v in tree.items()}
    return tree


def _pad_to(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    out = x.new_zeros(x.shape[:axis] + (n,) + x.shape[axis + 1:])
    out.narrow(axis, 0, x.shape[axis]).copy_(x)
    return out


def prefill(params: Params, cfg: ArchConfig, inputs: Dict[str, Any],
            max_len: int):
    """Run the full prompt, return (last_logits (B,V), decode-ready cache).

    Attention K/V (and MLA latent) caches are padded from prompt length T
    to ``max_len`` capacity (axis 2 under the stacked ``blocks``, axis 1
    under ``prologue``); recurrent states transfer as-is.
    """
    h, _, cache = forward(params, cfg, inputs, want_cache=True)
    lg = logits(params, cfg, h[:, -1])
    return lg, {"prologue": _pad_caches(cache["prologue"], 1, max_len),
                "blocks": _pad_caches(cache["blocks"], 2, max_len)}


# ===========================================================================
# Parameter accounting (allocation-free: the meta device)
# ===========================================================================

def param_shapes(cfg: ArchConfig):
    """The parameter tree on the meta device: shapes and dtypes only."""
    return init_params(cfg, torch.Generator(), device="meta")


def _leaves_with_keys(tree, keys=()):
    if isinstance(tree, dict):   # sorted, as jax.tree_util visits dicts
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], keys + (k,))
    else:
        yield keys, tree


def count_params(cfg: ArchConfig) -> Dict[str, float]:
    """-> {total, active, embed} parameter counts (MoE-aware)."""
    total = active = embed = 0
    for keys, leaf in _leaves_with_keys(param_shapes(cfg)):
        n = leaf.numel()
        total += n
        if "embed" in keys or "pos_emb" in keys or "lm_head" in keys:
            embed += n
            active += n
        elif "experts" in keys:
            active += n * cfg.moe_top_k / max(cfg.n_routed_experts, 1)
        else:
            active += n
    return {"total": float(total), "active": float(active),
            "embed": float(embed)}
