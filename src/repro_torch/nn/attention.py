"""Chunked flash-style softmax attention with GQA (counterpart of
``repro/nn/attention.py``'s ``_pick_chunk`` / ``flash_attention``).

The XLA path of the reference, written out: an online softmax over
(q_chunk, k_chunk) tiles, float32 statistics and accumulator, KV heads
grouped, never the whole (T, S) score matrix. ``repro_torch.kernels.ops.
flash_attention_mha`` is the fused CUDA kernel of the same math. RoPE,
``decode_attention`` and ``mla_decode_attention`` belong to the LM stack
and are not ported yet.
"""
from __future__ import annotations

import torch

BIG_NEG = -1e30


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
