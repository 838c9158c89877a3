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
- ``layer_flash_attention`` (``csrc/flash_f32.cu``), for float32 and for
  widths the tensor-core kernel does not take: one block per (batch*head,
  128-row query tile; 64 rows above D or Dv = 128) walks key tiles in
  float32 on the CUDA cores, each warp owning its rows, a lane an 8 x 4
  register tile of scores fed by 16-byte shared loads, K and V tiles
  through a ring of cp.async stages; launched by the plan of ``f32_plan``.
  What bounds it: the fp32 CUDA-core rate.

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
import dataclasses

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
    the score scale; the CUDA-core kernel's plan (``f32_plan``) and the
    timeline build's clock64 buffer. ``aip_step.library()`` checks its
    size against the source's."""
    _fields_ = ([(n, _P) for n in ("q", "k", "v", "o")]
                + [(n, _I) for n in ("nbh", "nh", "group", "T", "S", "D",
                                     "Dv", "causal", "q_sb", "q_sh", "q_st",
                                     "k_sb", "k_sh", "k_ss", "v_sb", "v_sh",
                                     "v_ss", "o_sb", "o_sh", "o_st")]
                + [("scale", ctypes.c_double)]
                + [(n, _I) for n in ("f32_rows", "f32_keys", "f32_threads",
                                     "f32_stages", "f32_smem")]
                + [("marks", _P)])


# the CUDA-core kernel's launch plan (csrc/flash_f32.cu reads it from
# FlashArgs and refuses one it cannot run)
F32_SMEM_MAX = 232_448      # dynamic shared bytes a block may use (H100)
F32_SM_SMEM = 233_472       # shared bytes an SM holds (228 KB), 1 KB of it
F32_CTA_RESERVED = 1_024    # reserved for each resident block
F32_SM_THREADS = 2_048
F32_SM_REGS = 65_536
F32_CHUNK = 32              # keys of the p chunk a warp writes at once
# (rows, keys, threads) the kernel is built for -> the blocks an SM its
# __launch_bounds__ asks for (so the registers a thread may take)
F32_CONFIGS = {(128, 64, 256): 1, (64, 32, 256): 2}
F32_WIDE = 128              # above this D or Dv: 64-row blocks
F32_SMS = 132               # SMs: fewer 128-row blocks -> 64-row blocks


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """How one CUDA-core flash launch covers (T, S, D, Dv) (``f32_plan``):
    a block of ``rows`` query rows of one (batch, head) walks key tiles of
    ``keys`` through a ring of ``stages`` (K, V) stages with ``threads``
    threads (warps of rows / (threads / 32) rows each)."""
    T: int
    S: int
    D: int
    Dv: int
    rows: int
    keys: int
    threads: int
    stages: int
    smem: int             # dynamic shared bytes
    blocks_per_sm: int    # resident blocks an SM holds

    @property
    def warps_per_sm(self):
        return self.blocks_per_sm * self.threads // 32

    @property
    def q_tiles(self):
        return -(-self.T // self.rows)


def qk_stride(D: int) -> int:
    """Row stride (floats) of the q and k tiles: D in whole 16-byte
    vectors, made an odd number of them, so that the rows one vector load
    touches fall on distinct banks (``flash_f32.cu::qk_stride``)."""
    s = -(-D // 4) * 4
    return s if (s // 4) % 2 else s + 4


def f32_smem(rows: int, keys: int, D: int, Dv: int, stages: int) -> int:
    """Dynamic shared bytes of ``flash_f32.cu::f32_smem_bytes``: the
    scaled q tile, ``stages`` x (K tile, V tile with Dv padded to 64) and
    the p chunk, all float32."""
    ld, dvp = qk_stride(D), 64 * -(-Dv // 64)
    return 4 * (rows * ld + stages * (keys * ld + keys * dvp)
                + F32_CHUNK * (rows + 4))


def _resident(threads: int, smem: int, min_blocks: int) -> int:
    regs = min(255, F32_SM_REGS // (threads * min_blocks))
    return min(F32_SM_SMEM // (smem + F32_CTA_RESERVED),
               F32_SM_THREADS // threads, F32_SM_REGS // (threads * regs))


def f32_plan(T: int, S: int, D: int, Dv: int, dtype=torch.float32, *,
             heads: int | None = None, rows: int | None = None,
             stages: int | None = None) -> F32Plan:
    """The launch plan of the CUDA-core flash kernel at (T, S, D, Dv),
    float32 or bf16 (either is staged as float32), over ``heads``
    (batch x heads) blocks of query rows: 128 query rows a block, 64-key
    tiles and 256 threads (8 x 4 score tiles a lane) up to D = Dv = 128
    where the 128-row blocks fill the card's SMs (``heads`` None: assume
    they do), else 64 rows, 32-key tiles and 256 threads (two blocks an
    SM where they fit); the ring as deep as shared memory holds (3 stages
    at most) without losing a resident block. ``rows`` and ``stages``
    override (tools/flash_f32_ablation.py). Raises ValueError for a plan
    the kernel cannot run."""
    if dtype not in DTYPES:
        raise TypeError(f"f32_plan: dtype {dtype}")
    if min(T, S, D, Dv) < 1 or max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"f32_plan: T={T}, S={S}, D={D}, Dv={Dv}")
    if rows is None:
        fills = heads is None or heads * -(-T // 128) >= F32_SMS
        rows = 128 if max(D, Dv) <= F32_WIDE and fills else 64
    keys, threads = (64 if rows == 128 else 32), 256
    if (rows, keys, threads) not in F32_CONFIGS:
        raise ValueError(f"f32_plan: no kernel for {rows} rows, {keys} "
                         f"keys, {threads} threads")
    if rows == 128 and Dv > F32_WIDE:
        raise ValueError(f"f32_plan: 128-row blocks hold Dv <= {F32_WIDE}")
    min_blocks = F32_CONFIGS[rows, keys, threads]
    if stages is None:
        # the deepest ring that fits and keeps the blocks the launch bound
        # asks for resident; else the deepest that fits
        fits = [n for n in (3, 2)
                if f32_smem(rows, keys, D, Dv, n) <= F32_SMEM_MAX]
        full = [n for n in fits if _resident(
            threads, f32_smem(rows, keys, D, Dv, n), min_blocks)
            >= min_blocks]
        stages = (full or fits or [2])[0]
    if stages not in (2, 3):
        raise ValueError(f"f32_plan: stages = {stages}")
    smem = f32_smem(rows, keys, D, Dv, stages)
    if smem > F32_SMEM_MAX:
        raise ValueError(f"f32_plan: {smem} shared bytes at D={D}, Dv={Dv}"
                         f", {rows} rows, {stages} stages (at most "
                         f"{F32_SMEM_MAX})")
    return F32Plan(T=T, S=S, D=D, Dv=Dv, rows=rows, keys=keys,
                   threads=threads, stages=stages, smem=smem,
                   blocks_per_sm=_resident(threads, smem, min_blocks))


def f32_tiles(plan: F32Plan, causal: bool):
    """The key tiles each query block walks, in order, as the kernel
    walks them -> [(query block, key tile, mask test)]: tiles wholly
    above the diagonal are skipped, and the mask test runs on a tile that
    crosses the diagonal or S."""
    out = []
    for qb in range(plan.q_tiles):
        q0 = qb * plan.rows
        kend = min(plan.S, q0 + plan.rows) if causal else plan.S
        for kt in range(-(-kend // plan.keys)):
            k0 = kt * plan.keys
            out.append((qb, kt, (causal and k0 + plan.keys - 1 > q0)
                        or k0 + plan.keys > plan.S))
    return out


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
        set_f32_plan(a, f32_plan(T, S, D, Dv, q.dtype, heads=nbh))
        _build.launch("layer_flash_attention",
                      ("flash_attention", "flash_attention[f32]"), q.device,
                      ctypes.byref(a), int(q.dtype == torch.bfloat16))
    return o


def set_f32_plan(a: FlashArgs, plan: F32Plan):
    a.f32_rows, a.f32_keys, a.f32_threads = plan.rows, plan.keys, \
        plan.threads
    a.f32_stages, a.f32_smem = plan.stages, plan.smem


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
