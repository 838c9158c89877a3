"""The CUDA route of the IALS kernels: build, bind and launch (counterpart
of ``repro/kernels/aip_step.py``, whose Pallas TPU kernels these
replace).

``csrc/ials_kernels.cu`` holds five entry points (one GRU AIP tick, the
GRU and FNN whole-horizon rollouts, the actor-in-the-loop rollout for
each cell; all launched by the plan of ``rollout_plan``, the tick by
``step_plan``'s, the GRU horizon's); ``csrc/serve_kernels.cu`` the
serving tier's masked slot forward for one policy and for N, launched by
the plan of ``serve_plan``; ``csrc/layer_kernels.cu`` ``rmsnorm``,
``csrc/flash_f32.cu`` ``flash_attention`` on the CUDA cores (launched by
the plan of ``flash_attention.f32_plan``) and ``csrc/gru_kernels.cu``
``gru_sequence`` (launched by the plan of ``gru.gru_plan``), bound in the
modules of those names; ``csrc/flash_wgmma.cu`` the tensor-core
``flash_attention`` for bf16 (``wgmma`` fed by TMA). The first two share
``csrc/ials_args.cuh``; they and ``gru_kernels.cu`` include
``csrc/smem.cuh`` (mbarriers, bulk copies, vector loads) and
``csrc/gates.cuh``; the attention sources ``csrc/flash_args.cuh``. At
first use each source is compiled
with ``nvcc`` for ``sm_90a`` (all at once, one process each) and the
objects are linked into ONE shared library with a plain C interface,
keyed by a hash of the sources, header and flags, under
``build/kernels/`` at the repo root, and loaded with ``ctypes``. Nothing
here is imported or built when the module is imported: the first launch
builds. This module also holds the launch counters of every kernel.

Each wrapper takes CUDA tensors only (``ops.py`` sends CPU tensors to the
plain versions in ``ref.py``), checks dtypes and shapes, allocates its
outputs, launches on PyTorch's current stream, raises if the launch
returned a CUDA error, and adds one to its entry of ``LAUNCHES``. Random
bits are int32-stored uint32 values; LS leaves are kernel-encoded int32
(``envs.api.kernel_codec``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("ials_kernels.cu", "serve_kernels.cu", "layer_kernels.cu",
            "gru_kernels.cu", "flash_wgmma.cu", "flash_f32.cu")
_HEADERS = ("gates.cuh", "ials_args.cuh", "flash_args.cuh", "wgmma.cuh",
            "smem.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# launches per entry point since the last ``reset_launches()``;
# "flash_attention" counts every flash launch, "flash_attention[wgmma]" and
# "flash_attention[f32]" the tensor-core and the CUDA-core kernel's; a
# horizon kernel's "name[domain]" its launches with that LS functor
_HORIZON_COUNTERS = ("aip_rollout_multi", "aip_rollout", "fnn_rollout",
                     "policy_rollout_fnn", "policy_rollout_gru")
LAUNCHES = {"aip_step": 0, **{k: 0 for k in _HORIZON_COUNTERS},
            **{f"{k}[{d}]": 0 for k in _HORIZON_COUNTERS
               for d in ("traffic", "warehouse")},
            "serve_forward": 0, "serve_forward_multi": 0,
            "gru_sequence": 0, "rmsnorm": 0, "flash_attention": 0,
            "flash_attention[wgmma]": 0, "flash_attention[f32]": 0}


_launches_lock = threading.Lock()


def reset_launches():
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_longlong
_INT_FIELDS = ("T", "A", "B", "D", "H", "M", "stack", "S", "obs_dim", "Hp",
               "n_act", "domain", "lane_len", "ext_influence", "region",
               "max_age", "vanish_after", "fast_gates", "n_pol",
               "serve_lanes", "serve_rows_per_thread",
               "serve_cols_per_thread", "serve_chunk_rows", "serve_stages",
               "serve_threads", "serve_smem", "serve_policy_blocks",
               "serve_flags", "roll_lanes", "roll_rows_per_thread",
               "roll_cluster", "roll_threads", "roll_smem")


class IalsArgs(ctypes.Structure):
    """Mirror of ``IalsArgs`` in ``csrc/ials_args.cuh`` (every field 8
    bytes, so the two layouts cannot disagree on padding)."""
    _fields_ = ([("ls_in", _P * 4), ("ls_out", _P * 4),
                 ("reset_ls", _P * 4), ("noise", _P * 4),
                 ("s0", _P), ("s_out", _P), ("frames0", _P),
                 ("frames_out", _P), ("aw", _P * 6), ("pw", _P * 6),
                 ("actions", _P), ("bits", _P), ("gumbel", _P),
                 ("done", _P), ("x_out", _P), ("a_out", _P),
                 ("logits_out", _P), ("v_out", _P), ("rew_out", _P),
                 ("d", _P), ("h", _P), ("h2", _P), ("logits", _P),
                 ("u", _P), ("mask", _P), ("pidx", _P)]
                + [(n, _I) for n in _INT_FIELDS]
                + [("roll_split", _I * 6)])


# the LS device functors of csrc/ials_kernels.cu (IalsArgs::domain)
_DOMAINS = {"traffic": 0, "warehouse": 1}
_ENTRIES = ("ials_aip_step", "ials_aip_rollout_multi", "ials_fnn_rollout",
            "ials_policy_rollout_gru", "ials_policy_rollout_fnn",
            "ials_serve_forward", "ials_serve_forward_multi",
            "gru_sequence_run")
_C_INT = ctypes.c_int
_LAYER_ENTRIES = {
    # x, g, out, N, d, eps, bf16, stream
    "layer_rmsnorm": [_P, _P, _P, _I, _I, ctypes.c_float, _C_INT, _P],
    # args, bf16, stream
    "layer_flash_attention": [_P, _C_INT, _P],
    # args, stream
    "layer_flash_attention_tc": [_P, _P],
}
_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = {"seconds": None, "path": None, "ptxas": ""}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin): the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; raise if any fails -> their
    stderr, joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{so}\n{se}")
    return "".join(se for _, se in outs)


def build() -> Path:
    """Compile the kernels once per source hash: one nvcc per source, all
    started together, then one link; returns the library. One nvcc over
    every source would compile them one after another, and the build
    counts against ``chip_smoke.py``'s time limit."""
    out = BUILD_DIR / f"libials_kernels_{source_hash()}.so"
    if out.exists():
        BUILD_LOG["path"] = str(out)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.tmp"
    objs = [BUILD_DIR / (s + tag + ".o") for s in _SOURCES]
    tmp = out.with_name(out.name + tag)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        ptxas = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                           str(o), str(_CSRC / s)]
                          for s, o in zip(_SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, path=str(out),
                     ptxas=ptxas)
    return out


def library():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from repro_torch.kernels.flash_attention import FlashArgs
            from repro_torch.kernels.gru import GruArgs
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for name, argtypes in _LAYER_ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for fn, mirror in ((lib.ials_args_size, IalsArgs),
                               (lib.layer_flash_args_size, FlashArgs),
                               (lib.gru_args_size, GruArgs)):
                fn.argtypes = []
                fn.restype = ctypes.c_int
                if fn() != ctypes.sizeof(mirror):
                    raise RuntimeError(f"{mirror.__name__} layout differs "
                                       f"between the CUDA source and its "
                                       f"ctypes mirror")
            _lib = lib
        return _lib


def _f32(t, name, shape):
    return check(t, name, torch.float32, shape)


def _i32(t, name, shape):
    return check(t, name, torch.int32, shape)


def check(t, name, dtype, shape):
    """A CUDA tensor of ``dtype`` (one dtype or a tuple of them) and
    ``shape`` -> it, contiguous; raises on anything else."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def launch(entry: str, counters, device, *args):
    """Call ``entry(*args, stream)`` on the current stream of ``device``
    (entering ``device`` only when it is not the current one) and count
    the launch in ``counters`` (a name or a tuple of names); raises if it
    returned a CUDA error. The
    wrapper's locals keep every buffer alive until the (asynchronous)
    launch has been enqueued, and the caching allocator orders later
    reuse on the same stream."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = getattr(lib, entry)(*args, stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err}")
    with _launches_lock:    # the async fleet's worker threads launch too
        for name in (counters,) if isinstance(counters, str) else counters:
            LAUNCHES[name] += 1


@dataclasses.dataclass(frozen=True)
class DomainLayout:
    """What the horizon kernels take for an LS domain: the d-set width D,
    the observation width, the ints a lane's state holds in shared memory
    (its functor's ``kStateInts``), and the (name, trailing shape) of each
    LS leaf and each noise leaf, in ``tree_leaves`` order."""
    D: int
    obs_dim: int
    state_ints: int
    leaves: tuple
    noise: tuple


def domain_layout(domain) -> DomainLayout:
    """The ``DomainLayout`` of a ``KernelDomain``; raises
    NotImplementedError for a domain the kernels carry no functor for."""
    if domain is None or domain.name not in _DOMAINS:
        raise NotImplementedError(
            f"no CUDA device functor for LS domain {domain!r} (the kernels "
            f"carry {sorted(_DOMAINS)})")
    if domain.name == "traffic":
        n = domain.lane_len
        return DomainLayout(D=4 * n, obs_dim=4 * n + 1,
                            state_ints=TRAFFIC_STATE_INTS,
                            leaves=(("lanes", (4, n)), ("phase", ())),
                            noise=())
    side = domain.region
    return DomainLayout(D=24, obs_dim=side * side + 12,
                        state_ints=WAREHOUSE_STATE_INTS,
                        leaves=(("pos", (2,)), ("items", (12,))),
                        noise=(("spawn", (12,)),))


def _leaves(vals, names, lead, what):
    """Check a domain's int32 leaves ((name, trailing shape) each) with
    the leading axes ``lead`` -> the contiguous leaves."""
    vals = tuple(vals)
    if len(vals) != len(names):
        raise ValueError(f"{what}: expected {len(names)} leaves "
                         f"{[n for n, _ in names]}, got {len(vals)}")
    return tuple(_i32(v, f"{what}.{n}", lead + tuple(shape))
                 for v, (n, shape) in zip(vals, names))


def _set_leaves(field, vals):
    for i, v in enumerate(vals):
        field[i] = v.data_ptr()


def _base_args(A, B, D, H, M, domain, **kw):
    return IalsArgs(A=A, B=B, D=D, H=H, M=M, domain=_DOMAINS[domain.name],
                    lane_len=domain.lane_len,
                    ext_influence=int(domain.ext_influence),
                    region=domain.region, max_age=domain.max_age,
                    vanish_after=domain.vanish_after, **kw)


def _counters(counter, domain):
    return counter, f"{counter}[{domain.name}]"


def step_plan(A: int, B: int, D: int, H: int, M: int, *,
              lanes: int | None = None) -> "RolloutPlan":
    """The launch plan of ``aip_step_multi``: the GRU horizon's without
    the policy (``rollout_plan(A, B, widths, "gru", False)``) with at most
    STEP_MAX_LANES lanes a tile, and always its K-parts, so a step and a
    one-tick ``aip_rollout_multi`` sum in the same order (the K-parts set
    the order; lanes and threads do not). ``lanes`` overrides (the
    ablation)."""
    w = RolloutWidths(D=D, H=H, M=M)
    roll = rollout_plan(A, B, w, "gru", False)
    return rollout_plan(A, B, w, "gru", False,
                        lanes=lanes or min(roll.lanes, STEP_MAX_LANES),
                        splits=roll.splits)


def step_args(d, h, wx, wh, b, hw, hb, bits, *, lanes=None):
    """Check one GRU tick's inputs, allocate its outputs and fill its
    IalsArgs with the plan of ``step_plan`` (``lanes`` overrides) ->
    (args, (h2, logits, u), inputs kept alive)."""
    B, A, D = d.shape
    H = wh.shape[1]
    M = hw.shape[2]
    d = _f32(d, "d", (B, A, D))
    h = _f32(h, "h", (B, A, H))
    ws = [_f32(wx, "wx", (A, D, 3 * H)), _f32(wh, "wh", (A, H, 3 * H)),
          _f32(b, "b", (A, 3 * H)), _f32(hw, "hw", (A, H, M)),
          _f32(hb, "hb", (A, M))]
    bits = _i32(bits, "bits", (B, A, M))
    h2 = torch.empty_like(h)
    logits = torch.empty((B, A, M), dtype=torch.float32, device=d.device)
    u = torch.empty_like(logits)
    args = IalsArgs(A=A, B=B, D=D, H=H, M=M)
    _set_plan(args, step_plan(A, B, D, H, M, lanes=lanes))
    args.d, args.h, args.bits = d.data_ptr(), h.data_ptr(), bits.data_ptr()
    for i, w in enumerate(ws):
        args.aw[i] = w.data_ptr()
    args.h2, args.logits, args.u = (h2.data_ptr(), logits.data_ptr(),
                                    u.data_ptr())
    return args, (h2, logits, u), (d, h, ws, bits)


def aip_step_multi(d, h, wx, wh, b, hw, hb, bits):
    """d (B, A, D), h (B, A, H), stacked (A, ...) GRU weights, bits
    (B, A, M) int32 -> (h2, logits, u): one launch of the horizon
    kernel's GRU role for one tick, by the plan of ``step_plan``."""
    args, out, keep = step_args(d, h, wx, wh, b, hw, hb, bits)
    launch("ials_aip_step", "aip_step", keep[0].device, ctypes.byref(args))
    return out


def aip_step(d, h, wx, wh, b, hw, hb, bits):
    """One GRU AIP tick with 2-D weights: d (B, D), h (B, H), bits (B, M)
    -> (h2 (B, H), logits (B, M), u (B, M))."""
    out = aip_step_multi(d[:, None], h[:, None], wx[None], wh[None],
                         b[None], hw[None], hb[None], bits[:, None])
    return tuple(o[:, 0] for o in out)


def shard_plan(A: int, B: int, widths: "RolloutWidths", cell: str,
               with_policy: bool, plan_for=None, **kw) -> "RolloutPlan":
    """The launch plan of an A x B block of a larger launch: its own lanes,
    threads and shared bytes, and the K-parts (``splits``) of the plan
    for ``plan_for`` = the global (A, B), so each lane of the block sums
    in the order the one-process launch sums it (the K-parts set the
    order; lanes and threads do not). ``plan_for=None`` is
    ``rollout_plan`` of the block itself; ``kw`` overrides as there."""
    if plan_for is not None and "splits" not in kw:
        kw["splits"] = rollout_plan(*plan_for, widths, cell,
                                    with_policy).splits
    return rollout_plan(A, B, widths, cell, with_policy, **kw)


def rollout_args(ls, s0, weights, actions, bits, noise, *, n_agents,
                 domain, D, H, M, stack, cell, lanes=None,
                 threads=None, plan_for=None):
    """Check a whole-horizon rollout's inputs (actions streamed, no
    policy), allocate its outputs and fill its IalsArgs with the launch
    plan of ``shard_plan`` for AIP ``cell`` ("gru" or "fnn"; ``lanes``
    / ``threads`` override the plan; ``plan_for`` the global (A, B) of a
    sharded launch) -> (args, outputs, inputs kept alive)."""
    lay = domain_layout(domain)
    if D != lay.D:
        raise ValueError(f"the AIP reads a d-set of {D}; the {domain.name} "
                         f"LS gives {lay.D}")
    L, SD = s0.shape
    A = n_agents
    if L % A:
        raise ValueError(f"lane count {L} not divisible by n_agents={A}")
    T = actions.shape[0]
    ls_in = _leaves(ls, lay.leaves, (L,), "ls")
    nz = _leaves(noise, lay.noise, (T, L), "noise")
    s0 = _f32(s0, "s0", (L, SD))
    actions = _i32(actions, "actions", (T, L))
    bits = _i32(bits, "bits", (T, L, M))
    ls_out = tuple(torch.empty_like(l) for l in ls_in)
    s_out = torch.empty_like(s0)
    rew = torch.empty((T, L), dtype=torch.float32, device=s0.device)
    args = _base_args(A, L // A, D, H, M, domain, T=T, stack=stack)
    _set_plan(args, shard_plan(
        A, L // A, RolloutWidths(D=D, H=H, M=M, stack=stack,
                                 state_ints=lay.state_ints), cell, False,
        plan_for, lanes=lanes, threads=threads))
    _set_leaves(args.ls_in, ls_in)
    _set_leaves(args.ls_out, ls_out)
    _set_leaves(args.noise, nz)
    args.s0, args.s_out = s0.data_ptr(), s_out.data_ptr()
    for i, w in enumerate(weights):
        args.aw[i] = w.data_ptr()
    args.actions, args.bits = actions.data_ptr(), bits.data_ptr()
    args.rew_out = rew.data_ptr()
    return (args, (ls_out, s_out, rew),
            (ls_in, nz, s0, actions, bits, weights))


def _gru_rollout(counter, ls, h0, wx, wh, b, hw, hb, actions, bits, noise,
                 *, n_agents: int, domain, plan_for=None):
    A, D, G3 = wx.shape
    H = G3 // 3
    M = hw.shape[2]
    ws = [_f32(wx, "wx", (A, D, 3 * H)), _f32(wh, "wh", (A, H, 3 * H)),
          _f32(b, "b", (A, 3 * H)), _f32(hw, "hw", (A, H, M)),
          _f32(hb, "hb", (A, M))]
    args, out, keep = rollout_args(ls, h0, ws, actions, bits, noise,
                                   n_agents=n_agents, domain=domain, D=D,
                                   H=H, M=M, stack=1, cell="gru",
                                   plan_for=plan_for)
    launch("ials_aip_rollout_multi", _counters(counter, domain),
           keep[2].device, ctypes.byref(args))
    return out


def aip_rollout_multi(ls, h0, wx, wh, b, hw, hb, actions, bits, noise, *,
                      n_agents: int, domain, plan_for=None):
    """Whole-horizon IALS rollout, GRU backbone, ONE launch by the plan
    of ``rollout_plan``: ls the domain's int32 leaves ((L, ...) each;
    traffic lanes (L, 4, lane_len) and phase (L,), the warehouse pos (L, 2)
    and items (L, 12)), h0 (L, H), stacked weights, actions (T, L), bits
    (T, L, M), noise the domain's int32 (T, L, ...) leaves (the
    warehouse's spawns; none for traffic) -> (final ls, h_T, rewards
    (T, L)). ``plan_for``: the global (A, B) of a sharded launch
    (``shard_plan``)."""
    return _gru_rollout("aip_rollout_multi", ls, h0, wx, wh, b, hw, hb,
                        actions, bits, noise, n_agents=n_agents,
                        domain=domain, plan_for=plan_for)


def aip_rollout(ls, h0, wx, wh, b, hw, hb, actions, bits, noise, *,
                domain):
    """The single-agent GRU horizon (the reference's ``aip_rollout``, the
    A = 1 squeeze of ``aip_rollout_multi``): unstacked 2-D weights, lifted
    to one agent, on the same kernel; counted as ``aip_rollout``."""
    return _gru_rollout("aip_rollout", ls, h0, wx[None], wh[None], b[None],
                        hw[None], hb[None], actions, bits, noise,
                        n_agents=1, domain=domain)


def fnn_rollout(ls, buf0, w1, b1, w2, b2, hw, hb, actions, bits, noise, *,
                n_agents: int, domain, plan_for=None):
    """Whole-horizon IALS rollout, FNN backbone, ONE launch by the plan of
    ``rollout_plan``: buf0 (L, stack*d_in) flat frame buffers; otherwise
    as ``aip_rollout_multi``."""
    A, SD, K = w1.shape
    M = hw.shape[2]
    D = domain_layout(domain).D
    if SD % D:
        raise ValueError(f"frame buffer width {SD} is not a multiple of "
                         f"the d-set width {D}")
    ws = [_f32(w1, "w1", (A, SD, K)), _f32(b1, "b1", (A, K)),
          _f32(w2, "w2", (A, K, K)), _f32(b2, "b2", (A, K)),
          _f32(hw, "hw", (A, K, M)), _f32(hb, "hb", (A, M))]
    args, out, keep = rollout_args(ls, buf0, ws, actions, bits, noise,
                                   n_agents=n_agents, domain=domain, D=D,
                                   H=K, M=M, stack=SD // D, cell="fnn",
                                   plan_for=plan_for)
    launch("ials_fnn_rollout", _counters("fnn_rollout", domain),
           keep[2].device, ctypes.byref(args))
    return out


def policy_rollout_args(ls, s0, frames0, aip_w, pol_w, gumbel, bits, done,
                        noise, reset_ls, *, kind: str, n_agents: int,
                        fast_gates: bool, domain, lanes=None, cluster=None,
                        threads=None, plan_for=None):
    """Check ``policy_rollout``'s inputs, allocate its outputs and fill
    its IalsArgs with the launch plan of ``shard_plan`` (``lanes``,
    ``cluster``, ``threads`` override it; ``plan_for`` the global (A, B)
    of a sharded launch) -> (entry, counters, args, outputs, plan, inputs
    kept alive)."""
    lay = domain_layout(domain)
    L, SD = s0.shape
    A = n_agents
    if L % A:
        raise ValueError(f"lane count {L} not divisible by n_agents={A}")
    T, _, NA = gumbel.shape
    S = frames0.shape[1]
    ls_in = _leaves(ls, lay.leaves, (L,), "ls")
    r_ls = _leaves(reset_ls, lay.leaves, (T, L), "reset_ls")
    nz = _leaves(noise, lay.noise, (T, L), "noise")
    D, obs_dim = lay.D, lay.obs_dim
    if kind == "gru":
        G3 = aip_w[0].shape[2]
        H, M, stack = G3 // 3, aip_w[3].shape[2], 1
        shapes = [(A, D, 3 * H), (A, H, 3 * H), (A, 3 * H), (A, H, M),
                  (A, M)]
        entry, counter = "ials_policy_rollout_gru", "policy_rollout_gru"
    elif kind == "fnn":
        H = aip_w[0].shape[2]
        M, stack = aip_w[4].shape[2], SD // D
        shapes = [(A, SD, H), (A, H), (A, H, H), (A, H), (A, H, M), (A, M)]
        entry, counter = "ials_policy_rollout_fnn", "policy_rollout_fnn"
    else:
        raise ValueError(f"unknown AIP kind {kind!r}")
    aw = [_f32(w, f"aip_w[{i}]", s)
          for i, (w, s) in enumerate(zip(aip_w, shapes))]
    w1, b1, w2, b2, piw, pib, vw, vb = pol_w
    Hp = w1.shape[1]
    pw = [_f32(w1, "w1", (S, Hp)), _f32(b1, "b1", (Hp,)),
          _f32(w2, "w2", (Hp, Hp)), _f32(b2, "b2", (Hp,)),
          _f32(torch.cat([piw, vw], dim=1), "pi|v w", (Hp, NA + 1)),
          _f32(torch.cat([pib, vb], dim=0), "pi|v b", (NA + 1,))]
    s0 = _f32(s0, "s0", (L, SD))
    frames0 = _f32(frames0, "frames0", (L, S))
    gumbel = _f32(gumbel, "gumbel", (T, L, NA))
    bits = _i32(bits, "bits", (T, L, M))
    done = _i32(done, "done", (T, L))
    dev = s0.device
    plan = shard_plan(A, L // A, RolloutWidths(
        D=D, H=H, M=M, stack=stack, S=S, obs_dim=obs_dim, Hp=Hp, n_act=NA,
        state_ints=lay.state_ints),
        kind, True, plan_for, lanes=lanes, cluster=cluster, threads=threads)
    ls_out = tuple(torch.empty_like(l) for l in ls_in)
    s_out, f_out = torch.empty_like(s0), torch.empty_like(frames0)
    x = torch.empty((T, L, S), dtype=torch.float32, device=dev)
    a = torch.empty((T, L), dtype=torch.int32, device=dev)
    logits = torch.empty((T, L, NA), dtype=torch.float32, device=dev)
    v = torch.empty((T, L), dtype=torch.float32, device=dev)
    r = torch.empty((T, L), dtype=torch.float32, device=dev)
    args = _base_args(A, L // A, D, H, M, domain, T=T, stack=stack, S=S,
                      obs_dim=obs_dim, Hp=Hp, n_act=NA,
                      fast_gates=int(fast_gates))
    _set_plan(args, plan)
    _set_leaves(args.ls_in, ls_in)
    _set_leaves(args.ls_out, ls_out)
    _set_leaves(args.reset_ls, r_ls)
    _set_leaves(args.noise, nz)
    args.s0, args.s_out = s0.data_ptr(), s_out.data_ptr()
    args.frames0, args.frames_out = frames0.data_ptr(), f_out.data_ptr()
    for i, w in enumerate(aw):
        args.aw[i] = w.data_ptr()
    for i, w in enumerate(pw):
        args.pw[i] = w.data_ptr()
    args.gumbel, args.bits, args.done = (gumbel.data_ptr(),
                                         bits.data_ptr(), done.data_ptr())
    args.x_out, args.a_out, args.logits_out = (x.data_ptr(), a.data_ptr(),
                                               logits.data_ptr())
    args.v_out, args.rew_out = v.data_ptr(), r.data_ptr()
    out = (ls_out, s_out, f_out, x, a, logits, v, r)
    keep = (ls_in, r_ls, nz, s0, frames0, aw, pw, gumbel, bits, done)
    return entry, _counters(counter, domain), args, out, plan, keep


def policy_rollout(ls, s0, frames0, aip_w, pol_w, gumbel, bits, done,
                   noise, reset_ls, *, kind: str, n_agents: int,
                   fast_gates: bool, domain, plan_for=None):
    """A whole PPO acting horizon in ONE launch (policy forward,
    Gumbel-argmax, AIP cell ``kind`` and draw, LS tick, frame refill,
    streamed resets), by the plan of ``rollout_plan``. Layout as
    ``ref.policy_rollout_ref`` -> (final ls, s_T, frames_T, x (T, L, S),
    a (T, L) int32, logits (T, L, NA), v (T, L), r (T, L))."""
    entry, counters, args, out, _, keep = policy_rollout_args(
        ls, s0, frames0, aip_w, pol_w, gumbel, bits, done, noise, reset_ls,
        kind=kind, n_agents=n_agents, fast_gates=fast_gates, domain=domain,
        plan_for=plan_for)
    launch(entry, counters, keep[3].device, ctypes.byref(args))
    return out


# the rollout kernels' launch plan (csrc/ials_kernels.cu reads it from
# IalsArgs and refuses one it cannot run)
ROLL_SMEM_MAX = 232_448     # dynamic shared bytes a block may use (H100)
ROLL_SMS = 132              # SMs: the plan widens tiles to stay one wave
ROLL_SM_SMEM = 233_472      # shared bytes an SM holds (228 KB), 1 KB of it
ROLL_CTA_RESERVED = 1_024   # reserved for each resident CTA
ROLL_SM_THREADS = 2_048
ROLL_SM_REGS = 65_536       # registers an SM holds; the kernel may take
ROLL_THREAD_REGS = 128      # 65,536 / ROLL_MAX_THREADS a thread
ROLL_LANES = (1, 2, 4, 8, 16, 32)
ROLL_THREADS = 256          # threads a CTA for tiles of up to 16 lanes,
ROLL_THREADS_WIDE = 512     # and of 32 (tools/rollout_ablation.py: 256
#                             beat 512 by 5-13 % at 4-16 lanes a tile and
#                             lost by 5-12 % at 32)
ROLL_MAX_THREADS = 512      # the kernel's __launch_bounds__
ROLL_SHARE_LANES = 8        # without the policy, CTAs share an SM from
#                             this many lanes a tile (tools/
#                             rollout_ablation.py, aip_rollout_multi: 2 x 8
#                             lanes an SM beat 1 x 16 by 18 % at 25 x 64;
#                             2 x 2 lost 10 % to 1 x 4 at 25 x 16)
STEP_MAX_LANES = 8          # aip_step's tile at most (one tick: beyond
#                             one wave 8 lanes a tile, two CTAs an SM, beat
#                             the rollout's 32 by 24 % at A = 25, B = 512,
#                             tools/rollout_ablation.py aip_step)
ROLL_MAX_SPLIT = 16         # K-parts of one product at most
ROLL_MIN_CHAIN = 8          # k-steps a part at least
TRAFFIC_STATE_INTS = 5      # TrafficDomain::kStateInts
WAREHOUSE_STATE_INTS = 14   # WarehouseDomain::kStateInts


@dataclasses.dataclass(frozen=True)
class RolloutWidths:
    """The widths a rollout launch runs at: the AIP's d-set D, hidden H
    and influence sources M, the FNN's stack; with the policy its frame
    width S, the observation obs_dim, hidden Hp and actions n_act; the
    ints of a lane's LS state (``DomainLayout.state_ints``; the step,
    which has no LS, keeps traffic's)."""
    D: int
    H: int
    M: int
    stack: int = 1
    S: int = 0
    obs_dim: int = 0
    Hp: int = 0
    n_act: int = 0
    state_ints: int = TRAFFIC_STATE_INTS


@dataclasses.dataclass(frozen=True)
class RolloutPlan:
    """How one ``aip_rollout_multi`` / ``fnn_rollout`` /
    ``policy_rollout`` launch covers A x B lanes (``rollout_plan``)."""
    A: int
    B: int
    cell: str
    with_policy: bool
    lanes: int            # lanes a tile (one agent's)
    rows_per_thread: int  # rows of a thread's register tile
    cluster: int          # CTAs a tile: 1 (one CTA runs it all) or 2
    #                       (rank 0 the policy, rank 1 the AIP and LS)
    threads: int
    splits: tuple         # K-parts of the six products (policy l1, l2,
    #                       head; AIP l1 / gx, l2 / gh, head)
    layers: tuple         # their (K, N); (0, 0) where a product is absent
    smem_roles: tuple     # dynamic shared bytes of (policy, AIP) roles
    smem: int             # dynamic shared bytes of the launch

    @property
    def tiles(self):
        return self.A * -(-self.B // self.lanes)

    @property
    def grid(self):
        return self.tiles * self.cluster


def _layers(w: RolloutWidths, cell: str, with_policy: bool):
    pol = ((w.S, w.Hp), (w.Hp, w.Hp), (w.Hp, w.n_act + 1)) if with_policy \
        else ((0, 0),) * 3
    if cell == "fnn":
        aip = ((w.stack * w.D, w.H), (w.H, w.H), (w.H, w.M))
    else:
        aip = ((w.D, 3 * w.H), (w.H, 3 * w.H), (w.H, w.M))
    return pol + aip


def _split(K, N, G, threads):
    """K-parts of one product: the most (a power of two up to
    ROLL_MAX_SPLIT) whose items (row groups x columns x parts) still fit
    the block in one pass, each part at least ROLL_MIN_CHAIN k-steps."""
    ks = 1
    while (ks * 2 <= ROLL_MAX_SPLIT and G * N * ks * 2 <= threads
           and K // (ks * 2) >= ROLL_MIN_CHAIN):
        ks *= 2
    return ks


def _r16(n_bytes):
    return (n_bytes + 15) // 16 * 16


def roll_smem(w: RolloutWidths, cell: str, R: int, splits, layers):
    """Dynamic shared bytes of (the policy role, the AIP role): the order
    and sizes of ``ials_kernels.cu::roll_layout`` (each region rounded up
    to 16 bytes; the barrier's 16 bytes counted in each role). The
    policy's bytes are 0 without it."""
    f = 4

    def part(idx):
        return [splits[i] * layers[i][1] * R if splits[i] > 1 else 0
                for i in idx]
    pol = 0
    if layers[0][0]:
        NH = w.n_act + 1
        pol = (16 + sum(_r16(f * n) for n in (
            w.S * w.Hp, w.Hp, w.Hp * w.Hp, w.Hp, w.Hp * NH, NH))
            + sum(_r16(f * n) for n in (
                2 * w.S * R, w.Hp * R, w.Hp * R, NH * R, w.obs_dim * R,
                R * w.n_act, R, max(part((0, 1, 2))))))
    if cell == "fnn":
        SD = w.stack * w.D
        pieces = (SD * w.H, w.H, w.H * w.H, w.H, w.H * w.M, w.M)
        state = (SD * R, 0, w.H * R, w.H * R)
        p3, p4, p5 = part((3, 4, 5))
        scratch = max(p3, p4, p5)
    else:
        G3 = 3 * w.H
        pieces = (w.D * G3, w.H * G3, G3, w.H * w.M, w.M)
        state = (w.H * R, w.D * R, G3 * R, G3 * R)
        p3, p4, p5 = part((3, 4, 5))
        scratch = max(p3 + p4, p5)
    aip = (16 + sum(_r16(f * n) for n in pieces)
           + sum(_r16(f * n) for n in state + (
               w.M * R, R * w.M, R * w.state_ints, R, R, scratch)))
    return pol, aip


def roll_resident(cluster: int, threads: int, smem: int,
                  lanes: int = 1) -> int:
    """CTAs of a horizon launch the card holds at once: one an SM; with
    the policy (a cluster of two), two clusters share an SM where both fit
    (each role waits on the other once a tick, and the other cluster's CTA
    fills that wait); without it, two CTAs share an SM where both fit and
    a tile has at least ROLL_SHARE_LANES lanes."""
    if cluster == 1 and lanes < ROLL_SHARE_LANES:
        return ROLL_SMS
    per_sm = min(ROLL_SM_THREADS // threads,
                 ROLL_SM_REGS // (ROLL_THREAD_REGS * threads),
                 ROLL_SM_SMEM // (smem + ROLL_CTA_RESERVED), 2)
    return ROLL_SMS * max(per_sm, 1)


def rollout_plan(A: int, B: int, widths: RolloutWidths, cell: str,
                 with_policy: bool, *, lanes: int | None = None,
                 cluster: int | None = None, threads: int | None = None,
                 splits: tuple | None = None) -> RolloutPlan:
    """The launch plan of ``aip_rollout_multi`` (``with_policy`` False,
    cell "gru"), ``fnn_rollout`` (``with_policy`` False, cell "fnn") and
    ``policy_rollout`` (either cell) over A agents x B lanes:
    a tile of lanes of one agent per CTA, or per cluster of two CTAs with
    the policy; lanes a tile the fewest whose grid the card holds at once
    (``roll_resident``: two clusters an SM where they fit; without the
    policy two CTAs from ROLL_SHARE_LANES lanes; fewer lanes a tile,
    shorter ticks:
    tools/rollout_ablation.py), halved
    while the weights and state do not fit shared memory; ROLL_THREADS
    threads a CTA (ROLL_THREADS_WIDE at 32 lanes); the K-parts of each
    product from ``_split``. ``lanes``, ``cluster``, ``threads`` and
    ``splits`` override. Raises ValueError for a plan that cannot fit."""
    w = widths
    if cell not in ("fnn", "gru"):
        raise ValueError(f"rollout_plan: unknown cell {cell!r}")
    for name in ("D", "H", "M", "stack") + (
            ("S", "obs_dim", "Hp", "n_act") if with_policy else ()):
        if getattr(w, name) < 1:
            raise ValueError(f"rollout_plan: {name} = {getattr(w, name)}")
    if A < 1 or B < 1:
        raise ValueError(f"rollout_plan: A = {A}, B = {B}")
    if with_policy and (w.n_act < 2 or w.obs_dim > w.S):
        raise ValueError("rollout_plan: the policy needs two actions and "
                         "a frame of at least one observation")
    if cluster is None:
        cluster = 2 if with_policy else 1
    if cluster not in ((1, 2) if with_policy else (1,)):
        raise ValueError(f"rollout_plan: cluster = {cluster} (1, or 2 with "
                         f"the policy)")
    if threads is not None and (threads % 32 or
                                not 32 <= threads <= ROLL_MAX_THREADS):
        raise ValueError(f"rollout_plan: threads = {threads}")
    if lanes is not None and lanes not in ROLL_LANES:
        raise ValueError(f"rollout_plan: lanes = {lanes} not in "
                         f"{ROLL_LANES}")
    if splits is not None and (len(splits) != 6 or not all(
            1 <= k <= ROLL_MAX_SPLIT for k in splits)):
        raise ValueError(f"rollout_plan: splits = {splits}")
    layers = _layers(w, cell, with_policy)

    def attempt(R):
        nt = threads or (ROLL_THREADS_WIDE if R > 16 else ROLL_THREADS)
        RP = min(R, 4)
        G = R // RP
        sp = splits or tuple(_split(K, N, G, nt) if K else 1
                             for K, N in layers)
        pol, aip = roll_smem(w, cell, R, sp, layers)
        smem = max(pol, aip) if cluster == 2 else pol + aip
        return nt, RP, sp, (pol, aip), smem

    if lanes is None:
        R = 1
        while R < ROLL_LANES[-1]:
            nt, _, _, _, smem = attempt(R)
            if A * -(-B // R) * cluster <= roll_resident(cluster, nt,
                                                         smem, R):
                break
            R *= 2
        while R > 1 and attempt(R)[4] > ROLL_SMEM_MAX:
            R //= 2
    else:
        R = lanes
    nt, RP, sp, roles, smem = attempt(R)
    need = max(R * w.M, R * (w.n_act if with_policy else 0), R)
    if smem > ROLL_SMEM_MAX or nt < need:
        raise ValueError(
            f"rollout_plan: cell {cell} at widths {w} with{'' if with_policy else 'out'} "
            f"the policy, {R} lanes a tile, cluster {cluster}, {nt} threads "
            f"needs {smem} shared bytes (at most {ROLL_SMEM_MAX}) and "
            f"{need} threads")
    return RolloutPlan(A=A, B=B, cell=cell, with_policy=with_policy,
                       lanes=R, rows_per_thread=RP, cluster=cluster,
                       threads=nt, splits=sp, layers=layers,
                       smem_roles=roles, smem=smem)


def rollout_items(plan: RolloutPlan, layer: int):
    """The (row, column, part) items product ``layer`` hands to the
    threads, as ``ials_kernels.cu::gemm_items`` enumerates them: item i
    -> column i % N, row group (i / N) % G, part i / (N G); a part covers
    k in [part * ceil(K / KS), ...). -> {thread: [(rows, n, (k0, k1))]}"""
    K, N = plan.layers[layer]
    R, RP, KS = plan.lanes, plan.rows_per_thread, plan.splits[layer]
    G = R // RP
    kl = -(-K // KS)
    out = {}
    for i in range(G * N * KS):
        n, g, part = i % N, (i // N) % G, i // (N * G)
        out.setdefault(i % plan.threads, []).append(
            (tuple(range(g * RP, (g + 1) * RP)), n,
             (min(K, part * kl), min(K, (part + 1) * kl))))
    return out


def _set_plan(args, plan: RolloutPlan):
    args.roll_lanes, args.roll_rows_per_thread = (plan.lanes,
                                                  plan.rows_per_thread)
    args.roll_cluster, args.roll_threads = plan.cluster, plan.threads
    args.roll_smem = plan.smem
    args.roll_split[:] = plan.splits


# the serving kernels' launch plan (csrc/serve_kernels.cu reads it from
# IalsArgs and refuses one it cannot run)
SERVE_SMEM_MAX = 232_448    # dynamic shared bytes a block may use (H100)
SERVE_MAX_LANES = 32        # lanes per tile: one warp's ballot compacts them
SERVE_MIN_LANES = 2
SERVE_MAX_THREADS = 512
SERVE_TARGET_TILES = 64     # tiles a slot aims for: lanes ~ S / this
SERVE_CHUNK_BYTES = 32_768  # a K-chunk of [w1; w2]: whole rows, at most
SERVE_MAX_STAGES = 64
SERVE_MAX_POLICY_BLOCKS = 65_535   # the grid's y limit
SERVE_WAVE_BLOCKS = 264     # about the blocks the card holds at once:
#                             a policy axis past it costs a second wave


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """How one serving launch covers a slot of S lanes at widths (D, Hp,
    NH) over N policies (``serve_plan``)."""
    S: int
    D: int
    Hp: int
    NH: int
    N: int
    lanes: int            # lanes per tile (grid x = ceil(S / lanes))
    rows_per_thread: int  # rows of a thread's register tile
    cols_per_thread: int  # columns of it (RP x CP independent chains)
    chunk_rows: int       # rows of [w1; w2] per K-chunk
    chunks: int           # K-chunks of one policy
    stages: int           # ring buffers (== chunks when every chunk fits)
    threads: int
    policy_blocks: int    # grid y: blocks on the policy axis
    smem: int             # dynamic shared bytes
    ring_bulk: bool       # [w1; w2] by bulk copies (rows of 16-byte multiples)
    head_bulk: bool       # the head by one bulk copy

    @property
    def grid(self):
        return (-(-self.S // self.lanes), self.policy_blocks)


def _serve_smem(R, D, Hp, NH, kc, ns):
    """Dynamic shared bytes of ``serve_kernels.cu::serve_smem``: barriers,
    compacted lanes, the ring, the head, the tile's frames (rows padded
    to an odd stride) and the routed lanes' (k-major), h1^T and h2^T,
    each region rounded up to 16 bytes."""
    return (_round16(8 * (ns + 1)) + _round16(4 * (R + 1))
            + _round16(4 * ns * kc * Hp) + _round16(4 * Hp * NH)
            + _round16(4 * (D | 1) * R) + _round16(4 * D * R)
            + 2 * _round16(4 * Hp * R))


def _threads(R, RP, CP, Hp, NH):
    """Threads of a block: a register tile of CP columns of each hidden
    layer (Hp / CP tiles), and one column of the head (NH), for each of
    the R / RP row groups, in whole warps."""
    return -(-max(Hp // CP, NH) * (R // RP) // 32) * 32


def _tile(R, Hp, NH):
    """(rows, columns, threads) of a thread's register tile: all R rows
    up to 8, and the fewest columns (1, 2 or 4, dividing Hp) whose block
    fits SERVE_MAX_THREADS -> None if none does. More warps hide more
    latency: on the card a tile of one column beat 4 at 32 lanes."""
    RP = min(R, 8)
    for CP in (1, 2, 4):
        T = _threads(R, RP, CP, Hp, NH)
        if Hp % CP == 0 and T <= SERVE_MAX_THREADS:
            return RP, CP, T
    return None


def serve_plan(S: int, D: int, Hp: int, NH: int, N: int, *,
               lanes: int | None = None,
               policy_axis: bool | None = None) -> ServePlan:
    """The launch plan of ``serve_forward`` (N = 1) and
    ``serve_forward_multi`` for a slot of S lanes, frame width D, policy
    hidden Hp, head width NH = n_act + 1: lanes per tile from the slot
    (about ``SERVE_TARGET_TILES`` tiles, each with N blocks; ``lanes``
    overrides), a thread's register tile (``_tile``) and the threads, the
    K-chunk ring as deep as shared memory holds beside the lane tile
    (every chunk resident when it fits), and one block per (tile, policy)
    while that grid fits one wave of the card (``SERVE_WAVE_BLOCKS``),
    else one block per tile that walks the policies (``policy_axis``
    overrides). Raises ValueError for widths it cannot hold."""
    for name, v in (("S", S), ("D", D), ("Hp", Hp), ("NH", NH), ("N", N)):
        if v < 1:
            raise ValueError(f"serve_plan: {name} = {v} < 1")
    if NH < 2:
        raise ValueError("serve_plan: the head needs an action and v")
    if lanes is None:
        R = SERVE_MIN_LANES
        while R < SERVE_MAX_LANES and R * SERVE_TARGET_TILES < S:
            R *= 2
    elif lanes in (1, 2, 4, 8, 16, 32):
        R = lanes
    else:
        raise ValueError(f"serve_plan: lanes = {lanes} is not a power of "
                         f"two up to {SERVE_MAX_LANES}")
    rows = D + Hp
    chunks = -(-rows // max(1, SERVE_CHUNK_BYTES // (4 * Hp)))
    kc = -(-rows // chunks)
    while True:
        tile = _tile(R, Hp, NH)
        ns = min(chunks, SERVE_MAX_STAGES)
        while ns >= 1 and _serve_smem(R, D, Hp, NH, kc, ns) > SERVE_SMEM_MAX:
            ns -= 1
        if tile is not None and ns >= 1:
            break
        if lanes is not None or R == 1:
            raise ValueError(
                f"serve_plan: widths D={D}, Hp={Hp}, NH={NH} at {R} lanes "
                f"a tile do not fit one block ({SERVE_MAX_THREADS} threads,"
                f" {SERVE_SMEM_MAX} shared bytes)")
        R //= 2
    RP, CP, T = tile
    if policy_axis is None:
        policy_axis = -(-S // R) * N <= SERVE_WAVE_BLOCKS
    return ServePlan(
        S=S, D=D, Hp=Hp, NH=NH, N=N, lanes=R, rows_per_thread=RP,
        cols_per_thread=CP, chunk_rows=kc, chunks=chunks, stages=ns,
        threads=T,
        policy_blocks=min(N, SERVE_MAX_POLICY_BLOCKS) if policy_axis else 1,
        smem=_serve_smem(R, D, Hp, NH, kc, ns),
        ring_bulk=(4 * Hp) % 16 == 0, head_bulk=(4 * Hp * NH) % 16 == 0)


def serve_pieces(plan: ServePlan):
    """The bulk copies one block makes for policy n, for every n: (tensor,
    byte offset into the stacked tensor, bytes), in the kernel's order
    (``serve_kernels.cu::stage_bulk`` for each chunk, then the head).
    Empty where the plan stages a piece by plain loads."""
    D, Hp, NH, kc = plan.D, plan.Hp, plan.NH, plan.chunk_rows
    row = 4 * Hp
    out = []
    for n in range(plan.N):
        if plan.ring_bulk:
            for j in range(plan.chunks):
                a, b = j * kc, min((j + 1) * kc, D + Hp)
                if a < D:
                    out.append(("w1", 4 * n * D * Hp + a * row,
                                (min(b, D) - a) * row))
                a2 = max(a, D)
                if a2 < b:
                    out.append(("w2", 4 * n * Hp * Hp + (a2 - D) * row,
                                (b - a2) * row))
        if plan.head_bulk:
            out.append(("head", 4 * n * Hp * NH, 4 * Hp * NH))
    return out


@functools.lru_cache(maxsize=512)
def _serve_template(S, D, Hp, NH, N, fast_gates, lanes, policy_axis):
    """The plan and an IalsArgs with every integer field of one slot
    shape set, copied and filled per call."""
    plan = serve_plan(S, D, Hp, NH, N, lanes=lanes, policy_axis=policy_axis)
    args = IalsArgs(
        B=S, S=D, Hp=Hp, n_act=NH - 1, fast_gates=int(fast_gates), n_pol=N,
        serve_lanes=plan.lanes, serve_rows_per_thread=plan.rows_per_thread,
        serve_cols_per_thread=plan.cols_per_thread,
        serve_chunk_rows=plan.chunk_rows, serve_stages=plan.stages,
        serve_threads=plan.threads, serve_smem=plan.smem,
        serve_policy_blocks=plan.policy_blocks,
        serve_flags=int(plan.ring_bulk) | 2 * int(plan.head_bulk))
    return plan, args


def serve_args(frames, mask, pidx, pol_w, *, fast_gates, lead, lanes=None,
               policy_axis=None):
    """Check the serving inputs, allocate the outputs and fill the
    launch's IalsArgs -> (args, logits, v, plan, inputs kept alive). A
    weight piece whose base is not 16-byte aligned is staged by plain
    loads."""
    S, D = frames.shape
    if S < 1:
        raise ValueError("an empty slot has no lanes to serve")
    w1, b1, w2, b2, hw, hb = pol_w
    Hp, NH = w1.shape[-1], hw.shape[-1]
    frames = _f32(frames, "frames", (S, D))
    mask = _i32(mask, "mask", (S,))
    ws = (_f32(w1, "w1", lead + (D, Hp)), _f32(b1, "b1", lead + (Hp,)),
          _f32(w2, "w2", lead + (Hp, Hp)), _f32(b2, "b2", lead + (Hp,)),
          _f32(hw, "[pi|v] w", lead + (Hp, NH)),
          _f32(hb, "[pi|v] b", lead + (NH,)))
    plan, tmpl = _serve_template(S, D, Hp, NH, lead[0] if lead else 1,
                                 bool(fast_gates), lanes, policy_axis)
    logits = torch.empty((S, NH - 1), dtype=torch.float32,
                         device=frames.device)
    v = torch.empty((S,), dtype=torch.float32, device=frames.device)
    args = IalsArgs.from_buffer_copy(tmpl)
    ptrs = [w.data_ptr() for w in ws]
    if (ptrs[0] | ptrs[2]) % 16:
        args.serve_flags &= ~1
    if ptrs[4] % 16:
        args.serve_flags &= ~2
    args.pw[:] = ptrs
    args.frames0, args.mask = frames.data_ptr(), mask.data_ptr()
    if pidx is not None:
        pidx = _i32(pidx, "pidx", (S,))
        args.pidx = pidx.data_ptr()
    args.logits_out, args.v_out = logits.data_ptr(), v.data_ptr()
    # the last item keeps every input (or its contiguous copy) alive
    # until the caller has enqueued the launch
    return args, logits, v, plan, (frames, mask, pidx, ws)


def _serve(entry, counter, frames, mask, pidx, pol_w, *, fast_gates, lead):
    args, logits, v, _, keep = serve_args(frames, mask, pidx, pol_w,
                                          fast_gates=fast_gates, lead=lead)
    launch(entry, counter, keep[0].device, ctypes.byref(args))
    return logits, v


def serve_forward(frames, mask, pol_w, *, fast_gates: bool):
    """Masked fixed-slot policy forward, ONE launch: frames (S, D) f32,
    mask (S,) int32, ``pol_w`` the fused (w1, b1, w2, b2, [pi|v] w,
    [pi|v] b) tuple (``ref.fuse_head``) -> (logits (S, n_act), v (S,)),
    masked-off lanes exactly 0.0."""
    return _serve("ials_serve_forward", "serve_forward", frames, mask, None,
                  pol_w, fast_gates=fast_gates, lead=())


def serve_forward_multi(frames, mask, pidx, pol_ws, *, fast_gates: bool):
    """``serve_forward`` over N policies stacked on a leading axis, pidx
    (S,) int32 routing each lane, ONE launch; lanes whose pidx is outside
    [0, N) are zero like the pad lanes."""
    return _serve("ials_serve_forward_multi", "serve_forward_multi", frames,
                  mask, pidx, pol_ws, fast_gates=fast_gates,
                  lead=(pol_ws[0].shape[0],))
