"""The CUDA route of the fused GRU sequence (counterpart of
``repro/kernels/gru.py``, whose Pallas TPU kernel ``gru_sequence`` this
replaces): ``gru_sequence_run`` in ``csrc/gru_kernels.cu``, built and
loaded by ``aip_step.library()``.

One launch runs the whole sequence by the plan of ``gru_plan``: a block
owns a tile of ``rows`` batch rows, T is a loop inside it, and h stays in
shared memory in float32; a thread owns the r, z and n columns of one
hidden unit (on the route "registers" it holds their weights in
registers) over one K-part of both products, the parts are summed across
lanes in a fixed order, and x @ wx + b of the next tick is computed off
the recurrence (the design note is in the source). Weights are
gate-major ``[r|z|n]`` as in ``repro_torch/nn/rnn.py``;
``ref.gru_sequence_ref`` is the plain version. CUDA tensors only:
``ops.py`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import aip_step as _build

DTYPES = (torch.float32, torch.bfloat16)

# the launch plan (csrc/gru_kernels.cu reads it from GruArgs and refuses
# one it cannot run)
GRU_SMS = 132               # SMs: one block an SM (the weights' registers)
GRU_SMEM_MAX = 232_448      # dynamic shared bytes a block may use (H100)
GRU_ROWS = (1, 2, 4, 8)     # rows a tile
GRU_PARTS = (1, 2, 4, 8)    # K-parts of each product (lanes a unit group)
ROUTES = ("registers", "l2")
REG_WIDTH = 64              # route "registers": H and D at most,
REG_PARTS = 8               #   parts (REG_WIDTH / parts k-steps each),
REG_UNITS = 1               #   units a thread (tools/gru_ablation.py: one
#                             unit on 512 threads beat two on 256, and 8
#                             parts beat 4)
L2_TARGET_THREADS = 512     # route "l2": the most parts with H x parts
#                             <= this


def max_threads(route: str, units_per_thread: int, parts: int) -> int:
    """A block's threads at most (the kernel's ``__launch_bounds__``)."""
    return 256 if route == "registers" and (units_per_thread == 2
                                            or parts < 8) else 512


def part_stride(kl: int, rows: int) -> int:
    """Floats from one K-part's first k-row of h^T or x^T to the next
    part's: kl k-rows of ``rows`` floats rounded up to 32 words, plus one
    vector, so that the parts' loads of a k-step fall on distinct banks
    (``gru_kernels.cu::part_stride``)."""
    return -(-kl * rows // 32) * 32 + min(rows, 4)


def gru_smem(rows: int, parts: int, D: int, H: int, route: str) -> int:
    """Dynamic shared bytes of a block (``gru_kernels.cu::
    gru_smem_floats``): h^T twice, its parts of ceil(H / parts) k-rows
    (REG_WIDTH / parts on route "registers", whose unrolled loop walks
    them all); x^T three times, parts of ceil(D / parts) k-rows."""
    hk = REG_WIDTH // parts if route == "registers" else -(-H // parts)
    return 4 * (2 * parts * part_stride(hk, rows)
                + 3 * parts * part_stride(-(-D // parts), rows))


@dataclasses.dataclass(frozen=True)
class GruPlan:
    """How one ``gru_sequence`` launch covers B rows (``gru_plan``)."""
    B: int
    T: int
    D: int
    H: int
    rows: int              # batch rows a tile (one block)
    parts: int             # K-parts of each product: lanes of a unit group
    units_per_thread: int  # hidden units a thread multiplies for
    units: int             # hidden units a pass of the block (H on
    #                        "registers")
    threads: int
    route: str             # "registers" (weights held by the threads) or
    #                        "l2"
    smem: int              # dynamic shared bytes

    @property
    def grid(self):
        return -(-self.B // self.rows)

    @property
    def passes(self):
        return -(-self.H // self.units)


def gru_plan(B: int, T: int, D: int, H: int, dtype=torch.float32, *,
             rows: int | None = None, parts: int | None = None,
             route: str | None = None,
             units_per_thread: int | None = None) -> GruPlan:
    """The launch plan of ``gru_sequence`` for x (B, T, D) of ``dtype``
    and hidden width H. Route "registers" where H and D are at most
    REG_WIDTH: REG_PARTS parts, REG_UNITS units a thread, the weights held
    in registers; else "l2": one unit a thread, the most
    parts (up to 8) with H x parts <= L2_TARGET_THREADS, weights read
    through the cache, units in passes of 512 / parts. ``rows`` the
    fewest whose grid fits one wave of the GRU_SMS SMs (8 past 1,056
    rows), halved while shared memory does not hold the tile. ``rows``,
    ``parts``, ``route`` and ``units_per_thread`` override (the library
    runs the route "registers" only at REG_PARTS and REG_UNITS; the
    ablation tool builds 4 parts and 2 units). Raises ValueError for a
    plan that cannot run."""
    if dtype not in DTYPES:
        raise ValueError(f"gru_plan: dtype {dtype} (float32 or bfloat16)")
    if min(B, T, D, H) < 1:
        raise ValueError(f"gru_plan: B, T, D, H = {B}, {T}, {D}, {H}")
    fits = max(H, D) <= REG_WIDTH
    if route is None:
        route = "registers" if fits else "l2"
    if route not in ROUTES:
        raise ValueError(f"gru_plan: route {route!r} not in {ROUTES}")
    if route == "registers":
        if not fits:
            raise ValueError(f"gru_plan: D = {D}, H = {H} over "
                             f"{REG_WIDTH} do not fit in registers")
        parts = REG_PARTS if parts is None else parts
        upt = REG_UNITS if units_per_thread is None else units_per_thread
        if parts not in (4, 8) or upt not in (1, 2) or (parts, upt) == (
                4, 2):
            raise ValueError(f"gru_plan: route registers takes 8 parts "
                             f"and 1 or 2 units a thread, or 4 parts and "
                             f"1, got {parts}, {upt}")
        units = H
    else:
        if parts is None:
            parts = 1
            while (parts < GRU_PARTS[-1]
                   and H * parts * 2 <= L2_TARGET_THREADS):
                parts *= 2
        upt = 1 if units_per_thread is None else units_per_thread
        if parts not in GRU_PARTS or upt != 1:
            raise ValueError(f"gru_plan: route l2 takes parts in "
                             f"{GRU_PARTS} and one unit a thread, got "
                             f"{parts}, {upt}")
        units = min(H, max_threads(route, upt, parts) // parts)
    threads = 32 * -(-(-(-units // upt) * parts) // 32)
    if rows is None:
        rows = next((r for r in GRU_ROWS if -(-B // r) <= GRU_SMS),
                    GRU_ROWS[-1])
        while rows > 1 and gru_smem(rows, parts, D, H,
                                    route) > GRU_SMEM_MAX:
            rows //= 2
    if rows not in GRU_ROWS:
        raise ValueError(f"gru_plan: rows = {rows} not in {GRU_ROWS}")
    smem = gru_smem(rows, parts, D, H, route)
    if smem > GRU_SMEM_MAX:
        raise ValueError(f"gru_plan: D = {D}, H = {H} at {rows} rows and "
                         f"{parts} parts needs {smem} shared bytes (at most "
                         f"{GRU_SMEM_MAX})")
    return GruPlan(B=B, T=T, D=D, H=H, rows=rows, parts=parts,
                   units_per_thread=upt, units=units, threads=threads,
                   route=route, smem=smem)


def _lanes(plan: GruPlan):
    """(thread, part, [units of each pass]) as ``gru_kernels.cu`` hands
    them out: part tid % parts, units U (tid // parts) + u of each pass,
    those below H."""
    P, U = plan.parts, plan.units_per_thread
    for tid in range(plan.threads):
        p, ju = tid % P, tid // P
        js = [ps * plan.units + U * ju + u for ps in range(plan.passes)
              for u in range(U) if U * ju + u < plan.units]
        yield tid, p, [j for j in js if j < plan.H]


def gru_items(plan: GruPlan, product: str):
    """The work each thread does in one tick: the three columns j, H + j,
    2H + j of each of its units over its part's k-steps of ``product``
    ("x": x @ wx, K = D; "h": h @ wh, K = H), for every row of the tile.
    -> {thread: [(rows, column, (k0, k1))]}"""
    K = {"x": plan.D, "h": plan.H}[product]
    kl = -(-K // plan.parts)
    out = {}
    for tid, p, js in _lanes(plan):
        k0, k1 = min(K, p * kl), min(K, (p + 1) * kl)
        for j in js:
            for g in range(3):
                out.setdefault(tid, []).append(
                    (tuple(range(plan.rows)), g * plan.H + j, (k0, k1)))
    return out


def gru_owners(plan: GruPlan):
    """Which thread updates each (row, unit) of the tile after the parts
    are summed (the reduce-scatter of ``gru_kernels.cu::Reduce``): lane p
    keeps rows [p * rows / parts, ...) when parts <= rows, else row p //
    (parts / rows), and only the first of the lanes that share a row
    writes. -> {(row, unit): thread}"""
    P, R = plan.parts, plan.rows
    nr, dup = (R // P, 1) if R >= P else (1, P // R)
    out = {}
    for tid, p, js in _lanes(plan):
        if p % dup:
            continue
        for j in js:
            for i in range(nr):
                key = ((p // dup) * nr + i, j)
                assert key not in out, key
                out[key] = tid
    return out


class GruArgs(ctypes.Structure):
    """Mirror of ``GruArgs`` in ``csrc/gru_kernels.cu`` (every field 8
    bytes)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "wx", "wh", "b", "h0",
                                                "hs")]
                + [(n, ctypes.c_longlong) for n in (
                    "B", "T", "D", "H", "bf16", "rows", "parts",
                    "units_per_thread", "units", "threads", "route",
                    "smem")])


def gru_args(x, wx, wh, b, h0, **plan_kw):
    """Check ``gru_sequence``'s inputs, allocate hs and fill its GruArgs
    with the plan of ``gru_plan`` (``plan_kw`` override it) -> (args, hs,
    plan, inputs kept alive)."""
    B, T, D = x.shape
    H = wh.shape[0]
    if B < 1 or T < 1:
        raise ValueError(f"gru_sequence needs B, T >= 1, got x "
                         f"{tuple(x.shape)}")
    x = _build.check(x, "x", DTYPES, (B, T, D))
    ws = [_build.check(w, n, DTYPES, s).float().contiguous()
          for w, n, s in ((wx, "wx", (D, 3 * H)), (wh, "wh", (H, 3 * H)),
                          (b, "b", (3 * H,)), (h0, "h0", (B, H)))]
    plan = gru_plan(B, T, D, H, x.dtype, **plan_kw)
    hs = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    args = GruArgs(B=B, T=T, D=D, H=H, bf16=int(x.dtype == torch.bfloat16),
                   rows=plan.rows, parts=plan.parts,
                   units_per_thread=plan.units_per_thread, units=plan.units,
                   threads=plan.threads, route=ROUTES.index(plan.route),
                   smem=plan.smem)
    args.x, args.hs = x.data_ptr(), hs.data_ptr()
    args.wx, args.wh, args.b, args.h0 = (w.data_ptr() for w in ws)
    return args, hs, plan, (x, ws)


def gru_sequence(x, wx, wh, b, h0):
    """x (B, T, D) float32 or bfloat16; wx (D, 3H), wh (H, 3H), b (3H,),
    h0 (B, H), each float32 or bfloat16 and taken in float32 -> (hs
    (B, T, H) in x's dtype, h_T = hs[:, -1]), ONE launch. For bfloat16 x,
    hs is rounded to bfloat16 while the state carries on in float32, so
    h_T is the rounded last row, not the float32 state."""
    args, hs, _, keep = gru_args(x, wx, wh, b, h0)
    _build.launch("gru_sequence_run", "gru_sequence", keep[0].device,
                  ctypes.byref(args))
    return hs, hs[:, -1]
