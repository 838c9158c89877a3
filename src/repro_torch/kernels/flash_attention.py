"""The CUDA route of the flash-attention forward (counterpart of
``repro/kernels/flash_attention.py``, whose Pallas TPU kernel
``flash_attention`` this replaces), in two kernels built and loaded by
``aip_step.library()``:

- ``layer_flash_attention_tc`` (``csrc/flash_wgmma.cu``), for bf16: the
  tensor cores. Both products are ``wgmma`` on bf16 operands into f32
  registers, with K and V tiles brought by TMA (one producer thread)
  through a ring in shared memory to two consumer warpgroups, each
  running one tile's softmax while the previous tile's P V is on the
  tensor cores; p is split into two bf16 halves (hi and lo) so that P V
  keeps the f32 p's precision. What bounds it: the bf16
  tensor-core rate, and beside it the softmax's f32 work (``expf``).
- ``layer_flash_attention`` (``csrc/layer_kernels.cu``), for float32 and
  for widths the tensor-core kernel does not take: one block per
  (batch*head, 64-row query tile) walks 64-key tiles in float32 on the
  CUDA cores. What bounds it: the fp32 CUDA-core rate.

``tensor_core_route`` picks the kernel from dtype and widths alone; a
refused launch raises, nothing falls back. Both keep the reference's
semantics (causal mask ``q_idx >= k_idx``, masked scores -1e30 and p = 0
under them, ``acc / max(l, 1e-20)`` rounded once to q's dtype; the
tensor-core kernel scales after ``q k^T``, as the plain version does, the
CUDA-core kernel before it, as the Pallas kernel does). The kernels'
tiles are their own; the Pallas block sizes ``bq``/``bk`` are still
checked for divisibility as the JAX function checks them
(``check_blocks``), and the result does not depend on them. Both read q,
k, v through strides over (batch, head, row) and a KV-group factor, so
``flash_attention_mha`` hands them the (B, T, H, D) and (B, S, KH, D)
tensors in place: one launch, no repeated KV heads. CUDA tensors only:
``ops.py`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import aip_step as _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_WIDTH_STEP = 16     # the tensor-core kernel takes widths in these steps
_P = ctypes.c_void_p
_I = ctypes.c_longlong


class FlashArgs(ctypes.Structure):
    """Mirror of ``FlashArgs`` in ``csrc/flash_args.cuh`` (every field 8
    bytes): q, k, v, o pointers; batch*heads, heads, KV group, T, S, D,
    Dv, causal; element strides over (batch, head, row) of q, k, v, o;
    the score scale. ``aip_step.library()`` checks its size against the
    source's."""
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "o")]
                + [(n, _I) for n in ("nbh", "nh", "group", "T", "S", "D",
                                     "Dv", "causal", "q_sb", "q_sh", "q_st",
                                     "k_sb", "k_sh", "k_ss", "v_sb", "v_sh",
                                     "v_ss", "o_sb", "o_sh", "o_st")]
                + [("scale", ctypes.c_double)])


def check_blocks(T: int, S: int, bq: int, bk: int):
    """The Pallas kernel's block rule: after ``min(bq, T)`` and ``min(bk,
    S)``, T and S must be multiples of them; raises ValueError."""
    bq, bk = min(bq, T), min(bk, S)
    if bq < 1 or bk < 1 or T % bq or S % bk:
        raise ValueError(f"flash_attention: T={T} and S={S} must be "
                         f"multiples of the blocks bq={bq}, bk={bk}")


def tensor_core_route(dtype, D: int, Dv: int) -> bool:
    """True where the tensor-core kernel (``csrc/flash_wgmma.cu``) takes
    the call: bf16 with D and Dv multiples of 16 up to 256. Everything
    else (float32, other widths) takes the CUDA-core kernel."""
    return (dtype == torch.bfloat16
            and all(w % TC_WIDTH_STEP == 0 and 0 < w <= MAX_HEAD_DIM
                    for w in (D, Dv)))


def _aligned(t):
    """TMA reads from 16-byte aligned bases: a view that starts elsewhere
    is copied (the route does not depend on it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, o, *, dims, nbh, nh, group, q_s, k_s, v_s, o_s,
            causal, scale):
    """dims: (T, S, D, Dv); q_s .. o_s: element strides over (batch,
    head, row)."""
    T, S, D, Dv = dims
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head widths D={D}, Dv={Dv} "
                         f"above {MAX_HEAD_DIM} are not supported")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v differ in dtype "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if tensor_core_route(q.dtype, D, Dv):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    a = FlashArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        nbh=nbh, nh=nh, group=group, T=T, S=S, D=D, Dv=Dv,
        causal=int(causal),
        q_sb=q_s[0], q_sh=q_s[1], q_st=q_s[2], k_sb=k_s[0], k_sh=k_s[1],
        k_ss=k_s[2], v_sb=v_s[0], v_sh=v_s[1], v_ss=v_s[2], o_sb=o_s[0],
        o_sh=o_s[1], o_st=o_s[2],
        scale=(D ** -0.5) if scale is None else float(scale))
    if tensor_core_route(q.dtype, D, Dv):
        _build.launch("layer_flash_attention_tc",
                      ("flash_attention", "flash_attention[wgmma]"),
                      q.device, ctypes.byref(a))
    else:
        _build.launch("layer_flash_attention",
                      ("flash_attention", "flash_attention[f32]"), q.device,
                      ctypes.byref(a), int(q.dtype == torch.bfloat16))
    return o


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    bq: int = 128, bk: int = 128):
    """q (BH, T, D); k (BH, S, D); v (BH, S, Dv), float32 or bfloat16 ->
    (BH, T, Dv) in q's dtype, ONE launch. Heads pre-flattened into the
    batch, as the Pallas kernel takes them."""
    BH, T, D = q.shape
    S, Dv = k.shape[1], v.shape[2]
    check_blocks(T, S, bq, bk)
    q = _build.check(q, "q", DTYPES, (BH, T, D))
    k = _build.check(k, "k", DTYPES, (BH, S, D))
    v = _build.check(v, "v", DTYPES, (BH, S, Dv))
    o = torch.empty((BH, T, Dv), dtype=q.dtype, device=q.device)
    return _launch(q, k, v, o, dims=(T, S, D, Dv), nbh=BH, nh=1, group=1,
                   q_s=(T * D, 0, D),
                   k_s=(S * D, 0, D), v_s=(S * Dv, 0, Dv),
                   o_s=(T * Dv, 0, Dv), causal=causal, scale=scale)


def flash_attention_mha(q, k, v, *, causal: bool = True, scale=None,
                        bq: int = 128, bk: int = 128):
    """q (B, T, H, D); k, v (B, S, KH, D[v]) with H % KH == 0 -> (B, T, H,
    Dv), ONE launch: query head h reads KV head h // (H // KH) in place."""
    B, T, H, D = q.shape
    S, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if KH < 1 or H % KH:
        raise ValueError(f"flash_attention_mha: {H} query heads are not a "
                         f"multiple of {KH} KV heads")
    check_blocks(T, S, bq, bk)
    q = _build.check(q, "q", DTYPES, (B, T, H, D))
    k = _build.check(k, "k", DTYPES, (B, S, KH, D))
    v = _build.check(v, "v", DTYPES, (B, S, KH, Dv))
    o = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    return _launch(q, k, v, o, dims=(T, S, D, Dv), nbh=B * H, nh=H,
                   group=H // KH,
                   q_s=(T * H * D, D, H * D), k_s=(S * KH * D, D, KH * D),
                   v_s=(S * KH * Dv, Dv, KH * Dv),
                   o_s=(T * H * Dv, Dv, H * Dv), causal=causal, scale=scale)
