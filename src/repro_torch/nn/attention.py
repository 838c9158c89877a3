"""Attention: RoPE, chunked flash-style softmax attention (GQA) and the
decode paths (counterpart of ``repro/nn/attention.py``).

``flash_attention`` is the XLA path of the reference, written out: an
online softmax over (q_chunk, k_chunk) tiles, float32 statistics and
accumulator, KV heads grouped, never the whole (T, S) score matrix.
``repro_torch.kernels.ops.flash_attention_mha`` is the fused CUDA kernel
of the same math; the LM (``repro_torch/models/lm.py``) calls this
function, as the reference's calls its XLA path, not the kernel.

``decode_attention`` and ``mla_decode_attention`` attend one new token
against a cache. Their scores and P.V sums come out in float32, as the
reference's ``preferred_element_type`` makes them: a product of two
bfloat16 values is exact in float32, so the port upcasts the operands
(the valid prefix of the cache, slots 0..pos) and multiplies in float32,
which differs from the reference only in the order of the sum. That
upcast is a float32 copy of the prefix, per layer and step; the
reference makes none.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.act_sharding import is_dtensor

BIG_NEG = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions: (...,) int -> cos/sin of shape (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               rot_dim: int | None = None) -> torch.Tensor:
    """x: (B, T, H, D); positions: (T,) or (B, T). Rotates the first
    rot_dim dims in float32, then casts back to x's dtype."""
    D = x.shape[-1]
    rot_dim = D if rot_dim is None else rot_dim
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    cos, sin = rope_angles(positions, rot_dim, theta)  # (..., rot_dim//2)
    if cos.dim() == 2:      # (T, rd//2) -> (1, T, 1, rd//2)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == 3:    # (B, T, rd//2) -> (B, T, 1, rd//2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def _pick_chunk(n: int, want: int) -> int:
    """Largest divisor of n that is <= want (n=1500, want=1024 -> 750)."""
    if n <= want:
        return n
    k = -(-n // want)  # ceil
    while n % k:
        k += 1
    return n // k


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_chunk: int = 1024, k_chunk: int = 1024,
                    q_offset: int = 0, p_bf16: bool = True) -> torch.Tensor:
    """Online-softmax attention with GQA grouping.

    q: (B, T, H, D); k, v: (B, S, KH, Dk/Dv) with H % KH == 0 -> (B, T, H,
    Dv) in q's dtype. ``q_offset``: absolute position of q[0] for causal
    masking; q position i attends to k positions <= q_offset + i.
    ``p_bf16`` (bfloat16 inputs only): the probability tile is rounded to
    bfloat16 before the product with v, as the reference does; the
    product is then taken in float32, where the reference multiplies two
    bfloat16 operands into a float32 sum: products of bfloat16 values are
    exact in float32, so the two differ only in the order of the sum.
    """
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    scale = (D ** -0.5) if scale is None else scale
    p_bf16 = p_bf16 and q.dtype == torch.bfloat16
    qc = _pick_chunk(T, q_chunk)
    kc = _pick_chunk(S, k_chunk)
    nq, nk = T // qc, S // kc
    dev = q.device

    qg = q.reshape(B, nq, qc, KH, G, D).float() * scale
    kf = k.float()
    vf = v.float()
    outs = []
    for i in range(nq):
        qi = qg[:, i]                                    # (B, qc, KH, G, D)
        q_pos = q_offset + i * qc + torch.arange(qc, device=dev)
        m = torch.full((B, KH, G, qc), BIG_NEG, device=dev)
        l = torch.zeros((B, KH, G, qc), device=dev)
        acc = torch.zeros((B, KH, G, qc, Dv), device=dev)
        for j in range(nk):
            kj = kf[:, j * kc:(j + 1) * kc]
            vj = vf[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
            if causal:
                k_pos = j * kc + torch.arange(kc, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]   # (qc, kc)
                s = s.masked_fill(~mask, BIG_NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = p.masked_fill(s <= BIG_NEG / 2, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = p.to(torch.bfloat16).float() if p_bf16 else p
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pv, vj)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]   # (B,KH,G,qc,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,qc,KH,G,Dv)
    return torch.cat(outs, dim=1).reshape(B, T, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (one new token vs a KV cache)
# ---------------------------------------------------------------------------

# a decode cache whose sequence dim is sharded over mesh axes (the
# sequence-parallel cache of ``distributed/sharding.py::cache_pspec``) is
# written and read block by block: each rank attends over its own slots,
# and the blocks' softmax sums combine with all-reduces (max, then sum)

def _seq_dims(cache) -> list:
    """The mesh dims a ``DTensor`` cache's sequence dim (1) is sharded
    over, in mesh order; [] for anything else."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(cache, DTensor):
        return []
    return [i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]


def _seq_block(cache, dims) -> tuple:
    """-> (first slot, slots) of this rank's block of the sequence."""
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    n = cache.to_local().shape[1]
    return idx * n, n


def _without_seq(cache, ndim: int, head_dim: int | None):
    """Placements for a tensor laid out as ``cache`` without its sequence
    dim: the batch (dim 0) as the cache's, dim ``head_dim`` as the
    cache's heads (dim 2), everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in cache.placements:
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and head_dim is not None:
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return out


def write_slot(cache: torch.Tensor, pos: int, value: torch.Tensor):
    """``cache[:, pos] = value`` (in place); on a sequence-sharded cache
    only the rank whose block holds ``pos`` writes."""
    dims = _seq_dims(cache)
    if not dims:
        cache[:, pos] = value.to(cache.dtype)
        return
    local = value.redistribute(cache.device_mesh, _without_seq(
        cache, value.dim(), 1)).to_local()
    start, n = _seq_block(cache, dims)
    if start <= pos < start + n:
        cache.to_local()[:, pos - start] = local.to(cache.dtype)


def _combine_blocks(s, pv, mesh, dims):
    """Softmax attention over the whole sequence from this rank's block:
    ``s`` the block's float32 scores (..., S_loc) with slots past ``pos``
    at ``BIG_NEG``; ``pv(p)`` the block's weighted values for weights
    ``p``. The blocks' max, weight sums and weighted values are combined
    over the sequence's mesh dims."""
    import torch.distributed._functional_collectives as funcol
    groups = [mesh.get_group(i) for i in dims]
    m = s.amax(-1, keepdim=True)
    for g in groups:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
    p = torch.exp(s - m).masked_fill(s <= BIG_NEG / 2, 0.0)
    lsum = p.sum(-1, keepdim=True)
    o = pv(p)
    for g in groups:
        lsum = funcol.wait_tensor(funcol.all_reduce(lsum, "sum", g))
        o = funcol.wait_tensor(funcol.all_reduce(o, "sum", g))
    return o / lsum


def _masked_scores(s, start: int, pos: int):
    """Scores of a block starting at slot ``start``, slots past ``pos`` at
    ``BIG_NEG``."""
    slots = start + torch.arange(s.shape[-1], device=s.device)
    return s.masked_fill(slots > pos, BIG_NEG)


def _decode_attention_local(q, k_cache, v_cache, pos, scale):
    """``decode_attention`` on ``DTensor``s, on each rank's local blocks:
    q laid out as the cache (batch, heads), whole elsewhere; a
    sequence-sharded cache combined block by block."""
    from torch.distributed.tensor import DTensor
    mesh = k_cache.device_mesh
    B, H, D = q.shape
    qpl = _without_seq(k_cache, 3, 1)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    dims = _seq_dims(k_cache)
    if not dims:
        o = decode_attention(q.redistribute(mesh, qpl).to_local(), kl, vl,
                             pos, scale=scale)
    else:
        ql = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)
              ).redistribute(mesh, qpl).to_local()
        G = H // k_cache.shape[2]
        start, _ = _seq_block(k_cache, dims)
        qg = ql.reshape(ql.shape[0], kl.shape[2], G, D)
        s = _masked_scores(torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                                        kl.float()), start, pos)
        o = _combine_blocks(s, lambda p: torch.einsum(
            "bhgk,bkhd->bhgd", p.to(vl.dtype).float(), vl.float()), mesh,
            dims)
        o = o.reshape(o.shape[0], -1, vl.shape[-1]).to(q.dtype)
    return DTensor.from_local(o.contiguous(), mesh, qpl, run_check=False,
                              shape=(B, H, v_cache.shape[-1]),
                              stride=(H * v_cache.shape[-1],
                                      v_cache.shape[-1], 1))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, H, D); caches: (B, S, KH, D[v]); pos: the new token's slot.

    Attends over cache slots <= pos (the new token's K/V must already be
    written at ``pos``). The reference masks slots past ``pos`` to
    ``BIG_NEG``, whose softmax weight is exactly 0; the port leaves them
    out, the same sums but for the order.
    """
    B, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    scale = (D ** -0.5) if scale is None else scale
    if is_dtensor(k_cache):
        return _decode_attention_local(q, k_cache, v_cache, int(pos), scale)
    n = int(pos) + 1
    # the scale is rounded to q's dtype first, as the reference does
    qg = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)
          ).reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache[:, :n].float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache[:, :n].float())
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


def mla_decode_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         w_kb_k: torch.Tensor, w_kb_v: torch.Tensor,
                         pos: int, *, scale: float) -> torch.Tensor:
    """Absorbed MLA decode (DeepSeek-V2/V3).

    q_nope: (B, H, Dn); q_rope: (B, H, Dr); ckv_cache: (B, S, R);
    krope_cache: (B, S, Dr); w_kb_k: (H, R, Dn) latent->k_nope per head;
    w_kb_v: (H, R, Dv) latent->v per head. Attention runs in the
    compressed latent space: scores and values touch only the (B, S, R)
    cache. Each product's operands are rounded to the dtype the
    reference hands its einsum, and the sum is float32.
    """
    if is_dtensor(ckv_cache):
        return _mla_decode_local(q_nope, q_rope, ckv_cache, krope_cache,
                                 w_kb_k, w_kb_v, int(pos), scale)
    n = int(pos) + 1
    cdt = ckv_cache.dtype
    q_lat = torch.einsum("bhd,hrd->bhr", q_nope.float(), w_kb_k.float())
    ckv = ckv_cache[:, :n].float()
    s = torch.einsum("bhr,bsr->bhs", q_lat.to(cdt).float(), ckv)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                         krope_cache[:, :n].float())
    s = s * scale
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p.to(cdt).float(), ckv)
    out = torch.einsum("bhr,hrd->bhd", o_lat.to(w_kb_v.dtype).float(),
                       w_kb_v.float())
    return out.to(q_nope.dtype)


def _mla_decode_local(q_nope, q_rope, ckv_cache, krope_cache, w_kb_k,
                      w_kb_v, pos, scale):
    """``mla_decode_attention`` on ``DTensor``s, on each rank's local
    blocks: the queries batch-sharded as the latent cache, whole
    elsewhere, the absorbed weights whole; a sequence-sharded cache
    combined block by block."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ckv_cache.device_mesh
    B, H, _ = q_nope.shape
    pl = _without_seq(ckv_cache, 3, None)
    whole = [Replicate()] * mesh.ndim
    qn, qr = (t.redistribute(mesh, pl).to_local() for t in (q_nope, q_rope))
    wk, wv = (w.contiguous().redistribute(mesh, whole).to_local()
              for w in (w_kb_k, w_kb_v))
    ckv_l, krope_l = ckv_cache.to_local(), krope_cache.to_local()
    dims = _seq_dims(ckv_cache)
    if not dims:
        out = mla_decode_attention(qn, qr, ckv_l, krope_l, wk, wv, pos,
                                   scale=scale)
    else:
        cdt = ckv_cache.dtype
        q_lat = torch.einsum("bhd,hrd->bhr", qn.float(), wk.float())
        ckv = ckv_l.float()
        start, _ = _seq_block(ckv_cache, dims)
        s = torch.einsum("bhr,bsr->bhs", q_lat.to(cdt).float(), ckv)
        s = s + torch.einsum("bhd,bsd->bhs", qr.float(), krope_l.float())
        s = _masked_scores(s * scale, start, pos)
        o_lat = _combine_blocks(s, lambda p: torch.einsum(
            "bhs,bsr->bhr", p.to(cdt).float(), ckv), mesh, dims)
        out = torch.einsum("bhr,hrd->bhd", o_lat.to(wv.dtype).float(),
                           wv.float()).to(q_nope.dtype)
    Dv = w_kb_v.shape[-1]
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False,
                              shape=(B, H, Dv), stride=(H * Dv, Dv, 1))
