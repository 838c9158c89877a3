#!/usr/bin/env python3
"""Where the serving kernels' time goes, on the card, and how the
redesigned kernels compare with the first version.

    python3 tools/serve_ablation.py      # one CUDA card and nvcc

Builds, each into a library of its own under ``build/serve_ablation/``
(one nvcc each, side by side):
  - "first version": a copy, kept in this file (``FIRST_VERSION``), of the
    first CUDA serving body (one block per 16 lanes, 128 threads, weights
    read with ``__ldg`` inside each fmaf chain, the policies of a tile run
    one after another in the block), with its own argument struct;
  - "kernel": ``src/repro_torch/kernels/csrc/serve_kernels.cu`` as it is;
  - "weights from L2": the same source with w1 and w2 neither staged nor
    waited for, the products reading them from global memory (the head
    stays staged);
  - "plain staging": every weight staged by plain loads of all threads
    (the path of widths that are not 16-byte aligned);
  - "timeline": the kernel writing clock64() at seven points of each
    block (lanes in, frames gathered, layer 1, layer 2, head landed, head
    done, end) into a buffer the tool reads back and prints;
  - timing only, their outputs wrong: "no products" (the three products
    taken out), "no staging" (the products read whatever shared memory
    holds), "staging only" (the copies issued and waited for, nothing
    else) and "empty kernel" (returns at once: launch and scheduling).
Then at S = 128 and 4096 lanes, both serving widths (traffic D = 41,
warehouse D = 296; hidden 128) and N = 1 and 4 policies, it times each
build, and the kernel under other launch plans (lanes per tile 1-32, a
register tile of four columns a thread (a quarter of the threads, each
loading the broadcast activations for four times the FMAs), and for N =
4 the other side of the plan's policy-axis rule: one block per (tile,
policy), or one block per tile walking the policies), as device
ms (``torch.profiler``, 50 launches), twice, in turns (forward, then
backward over the list). Every output must be bitwise equal to the first
version's, except the timing-only copies'. Last, the event ms of one
call through each wrapper as a caller sees it (the first version's
Python wrapper, kept here, rebuilt the argument struct, entered the
device and set the shared-memory attribute on every call) beside its
device ms, at traffic S = 128. The card's name and power limit come
first.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "serve_ablation"
SLOTS = (128, 4096)
POLICIES = (1, 4)
LANES = (1, 2, 4, 8, 16, 32)
REPS = 50

RING_BULK = "  const bool ring_bulk = (p.serve_flags & kRingBulk) != 0;\n"
STAGE_PLAIN = ("__device__ __forceinline__ void stage_plain(const Ring& rg, "
               "int j) {\n")
HEAD_BULK = "  const bool head_bulk = (p.serve_flags & kHeadBulk) != 0;\n"
MEANWHILE = "  // meanwhile: warp 0 reads the tile's mask"
STAGING_ONLY = (
    "  __syncthreads();\n"
    "  if (!early) stage_first(blockIdx.y);\n"
    "  for (int j = 0; j < first; ++j) mbar_wait(&sm.bar[j], 0);\n"
    "  mbar_wait(&sm.bar[ns], 0);\n"
    "  if (p.B > 0) return;\n")
STAGED_W = ("    const float* w = rg.stage0 + ((int)s * rg.kc + off) * "
            "rg.Hp + c0;\n")
GLOBAL_W = ("    const float* w = (vr < rg.D ? rg.w1 + (size_t)vr * rg.Hp\n"
            "                     : rg.w2 + (size_t)(vr - rg.D) * rg.Hp) "
            "+ c0;\n")
KERNEL_TOP = ("  extern __shared__ __align__(16) unsigned char "
              "smem_raw[];\n")
LAYER_CHAIN = ("    if (on) chain<RP, CP>(acc, w, rg.Hp, act + k * R + g * "
               "RP, R, len);\n")
HEAD_CHAIN = ("      chain<RP, 1>(hacc, sm.head + ch, NH, sm.h2T + gh * RP, "
              "R, Hp);\n")

# the "timeline" copy: block (x, y) writes clock64() since its start at
# eight points into marks[(y * gridDim.x + x) * 8 + i] (the serving launch
# leaves rew_out unused; the tool points it at an int64 buffer)
MARK = ("  auto mark = [&](int i) {\n"
        "    if (threadIdx.x == 0)\n"
        "      reinterpret_cast<long long*>(p.rew_out)[(blockIdx.y * "
        "gridDim.x + blockIdx.x) * 8 + i] = clock64() - t_start;\n"
        "  };\n")
MARKS = [
    (KERNEL_TOP, KERNEL_TOP + "  const long long t_start = clock64();\n"
     + MARK),
    ("    __syncthreads();     // lanes and frames are in\n",
     "    __syncthreads();     // lanes and frames are in\n    mark(1);\n"),
    ("      sm.xT[i] = r < m ? sm.xraw[sm.lane[r] * Dx + k] : 0.0f;\n"
     "    }\n    __syncthreads();\n",
     "      sm.xT[i] = r < m ? sm.xraw[sm.lane[r] * Dx + k] : 0.0f;\n"
     "    }\n    __syncthreads();\n    mark(2);\n"),
    ("    if (on) store_layer<RP, CP>(sm.h1T, R, c0, g, acc, b1, gate);\n"
     "    __syncthreads();\n",
     "    if (on) store_layer<RP, CP>(sm.h1T, R, c0, g, acc, b1, gate);\n"
     "    __syncthreads();\n    mark(3);\n"),
    ("    if (on) store_layer<RP, CP>(sm.h2T, R, c0, g, acc, b2, gate);\n"
     "    __syncthreads();\n",
     "    if (on) store_layer<RP, CP>(sm.h2T, R, c0, g, acc, b2, gate);\n"
     "    __syncthreads();\n    mark(4);\n"),
    ("    if (head_bulk) mbar_wait(&sm.bar[ns], head_uses & 1);\n",
     "    if (head_bulk) mbar_wait(&sm.bar[ns], head_uses & 1);\n"
     "    mark(5);\n"),
    ("    q0 += nchunks;\n", "    mark(6);\n    q0 += nchunks;\n"),
    ("    ++head_uses;\n  }\n}\n", "    ++head_uses;\n  }\n  mark(7);\n}\n"),
]
MARK_NAMES = ("lanes in", "frames gathered", "layer 1", "layer 2",
              "head landed", "head done", "end")
# name -> [(text in serve_kernels.cu, its replacement)]
VARIANTS = {
    "kernel": [],
    # [w1; w2] neither staged nor waited for: the products read them from
    # global memory (L2) inside each chain
    "weights from L2": [(RING_BULK, "  const bool ring_bulk = false;\n"),
                        (STAGE_PLAIN, STAGE_PLAIN + "  return;\n"),
                        (STAGED_W, GLOBAL_W)],
    # every weight staged by plain 4-byte loads of all threads
    "plain staging": [(RING_BULK, "  const bool ring_bulk = false;\n"),
                      (HEAD_BULK, "  const bool head_bulk = false;\n")],
    # timing only (their outputs are wrong): the kernel without its three
    # products; without staging (the products read whatever shared memory
    # holds); the staging alone (copies issued and waited for, nothing
    # else); a kernel that returns at once (launch and scheduling)
    "no products": [(LAYER_CHAIN, ""), (HEAD_CHAIN, "")],
    "no staging": [(RING_BULK, "  const bool ring_bulk = false;\n"),
                   (HEAD_BULK, "  const bool head_bulk = false;\n"),
                   (STAGE_PLAIN, STAGE_PLAIN + "  return;\n")],
    "staging only": [(MEANWHILE, STAGING_ONLY + MEANWHILE)],
    "empty kernel": [(KERNEL_TOP, KERNEL_TOP + "  if (p.B > 0) return;\n")],
    "timeline": MARKS,
}
TIMING_ONLY = ("no products", "no staging", "staging only", "empty kernel")

# The first CUDA serving body, as it stood before the redesign, with the
# parts of its source file it used (gates.cuh's fast_tanh, activate,
# gemm_rows, gemm) and an argument struct of its own.
FIRST_VERSION = r"""
#include <cuda_runtime.h>
#include <stdint.h>

struct FirstArgs {
  const float* frames0;
  const int* mask;
  const int* pidx;
  const float* pw[6];
  float* logits_out;
  float* v_out;
  long long B, S, Hp, n_act, fast_gates, n_pol;
};

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;

__device__ __forceinline__ float fast_tanh(float x) {
  const float c = 4.97178686f;
  x = fminf(fmaxf(x, -c), c);
  const float x2 = __fmul_rn(x, x);
  const float num = __fmul_rn(
      x, __fadd_rn(135135.0f,
                   __fmul_rn(x2, __fadd_rn(17325.0f,
                                           __fmul_rn(x2, __fadd_rn(378.0f,
                                                                   x2))))));
  const float den = __fadd_rn(
      135135.0f,
      __fmul_rn(x2, __fadd_rn(62370.0f,
                              __fmul_rn(x2, __fadd_rn(3150.0f,
                                                      __fmul_rn(x2,
                                                                28.0f))))));
  return __fdiv_rn(num, den);
}

enum Act { kNone = 0, kRelu = 1, kFastTanh = 2, kTanh = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kFastTanh: return fast_tanh(v);
    case kTanh: return tanhf(v);
    default: return v;
  }
}

template <int R>
__device__ void gemm_rows(const float* x, int ldx, const float* __restrict__ W,
                          const float* __restrict__ bias, int K, int N,
                          float* y, int ldy, int act) {
  constexpr int G = kRows / R;
  for (int item = threadIdx.x; item < N * G; item += blockDim.x) {
    const int c = item % N;
    const int g = item / N;
    const float* xr = x + g * R * ldx;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (size_t)k * N + c);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(xr[r * ldx + k], w, acc[r]);
    }
    const float bb = bias != nullptr ? __ldg(bias + c) : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = bias != nullptr ? __fadd_rn(acc[r], bb) : acc[r];
      y[(g * R + r) * ldy + c] = activate(v, act);
    }
  }
}

__device__ void gemm(const float* x, int ldx, const float* W,
                     const float* bias, int K, int N, float* y, int ldy,
                     int act) {
  const int groups = kThreads / N;
  if (groups >= 16) gemm_rows<1>(x, ldx, W, bias, K, N, y, ldy, act);
  else if (groups >= 8) gemm_rows<2>(x, ldx, W, bias, K, N, y, ldy, act);
  else if (groups >= 4) gemm_rows<4>(x, ldx, W, bias, K, N, y, ldy, act);
  else if (groups >= 2) gemm_rows<8>(x, ldx, W, bias, K, N, y, ldy, act);
  else gemm_rows<16>(x, ldx, W, bias, K, N, y, ldy, act);
}

struct ServeLayout {
  int x, h1, h2, out;
  int total_bytes;
};

ServeLayout make_serve_layout(const FirstArgs& p) {
  ServeLayout l{};
  int off = 0;
  auto take = [&](int n) { int o = off; off += n; return o; };
  l.x = take(kRows * (int)p.S);
  l.h1 = take(kRows * (int)p.Hp);
  l.h2 = take(kRows * (int)p.Hp);
  l.out = take(kRows * (int)(p.n_act + 1));
  l.total_bytes = off * (int)sizeof(float);
  return l;
}

__global__ void __launch_bounds__(kThreads)
serve_forward_kernel(FirstArgs p, ServeLayout lay) {
  extern __shared__ float smem[];
  __shared__ int pol[kRows];
  const int D = (int)p.S, Hp = (int)p.Hp, NA = (int)p.n_act, NH = NA + 1;
  const int N = (int)p.n_pol;
  const int gate = p.fast_gates ? kFastTanh : kTanh;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long left = p.B - row0;
  const int nvalid = left < kRows ? (int)left : kRows;
  float* x = smem + lay.x;
  float* h1 = smem + lay.h1;
  float* h2 = smem + lay.h2;
  float* out = smem + lay.out;
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int r = i / D;
    x[i] = r < nvalid ? p.frames0[(row0 + r) * D + i % D] : 0.0f;
  }
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    int n = -1;
    if (r < nvalid && p.mask[row0 + r] != 0) {
      n = p.pidx != nullptr ? p.pidx[row0 + r] : 0;
      if (n < 0 || n >= N) n = -1;
    }
    pol[r] = n;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nvalid * NH; i += blockDim.x) {
    const int r = i / NH, j = i % NH;
    if (pol[r] >= 0) continue;
    if (j < NA) p.logits_out[(row0 + r) * NA + j] = 0.0f;
    else p.v_out[row0 + r] = 0.0f;
  }
  for (int n = 0; n < N; ++n) {
    if (!__syncthreads_or(threadIdx.x < kRows && pol[threadIdx.x] == n))
      continue;
    const float* w1 = p.pw[0] + (size_t)n * D * Hp;
    const float* b1 = p.pw[1] + (size_t)n * Hp;
    const float* w2 = p.pw[2] + (size_t)n * Hp * Hp;
    const float* b2 = p.pw[3] + (size_t)n * Hp;
    const float* hw = p.pw[4] + (size_t)n * Hp * NH;
    const float* hb = p.pw[5] + (size_t)n * NH;
    gemm(x, D, w1, b1, D, Hp, h1, Hp, gate);
    __syncthreads();
    gemm(h1, Hp, w2, b2, Hp, Hp, h2, Hp, gate);
    __syncthreads();
    gemm(h2, Hp, hw, hb, Hp, NH, out, NH, kNone);
    __syncthreads();
    for (int i = threadIdx.x; i < nvalid * NH; i += blockDim.x) {
      const int r = i / NH, j = i % NH;
      if (pol[r] != n) continue;
      if (j < NA) p.logits_out[(row0 + r) * NA + j] = out[i];
      else p.v_out[row0 + r] = out[i];
    }
    __syncthreads();
  }
}

int launch_serve(const FirstArgs* args, void* stream) {
  if (args->B < 1 || args->n_pol < 1) return (int)cudaErrorInvalidValue;
  const ServeLayout lay = make_serve_layout(*args);
  cudaError_t e = cudaFuncSetAttribute(
      serve_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total_bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((args->B + kRows - 1) / kRows);
  serve_forward_kernel<<<grid, kThreads, lay.total_bytes,
                         (cudaStream_t)stream>>>(*args, lay);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ials_serve_forward(const FirstArgs* args, void* stream) {
  if (args->n_pol != 1 || args->pidx != nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_serve(args, stream);
}

int ials_serve_forward_multi(const FirstArgs* args, void* stream) {
  if (args->pidx == nullptr) return (int)cudaErrorInvalidValue;
  return launch_serve(args, stream);
}

}  // extern "C"
"""


class FirstArgs(ctypes.Structure):
    _fields_ = ([("frames0", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                 ("pidx", ctypes.c_void_p), ("pw", ctypes.c_void_p * 6),
                 ("logits_out", ctypes.c_void_p), ("v_out", ctypes.c_void_p)]
                + [(n, ctypes.c_longlong) for n in
                   ("B", "S", "Hp", "n_act", "fast_gates", "n_pol")])


def nvcc() -> str:
    exe = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found")
    return exe


def build_all():
    """Write and compile the first version and every variant of the
    kernel, side by side -> {name: (library, ptxas lines)}."""
    from chip_smoke import ptxas_lines
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    base = (CSRC / "serve_kernels.cu").read_text()
    sources = {"first version": FIRST_VERSION}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: text not found: {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        src.write_text(text)
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(CSRC),
               "-Xptxas", "-v", "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    built = {}
    for name, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-3000:]}")
        lines = [f"{k}: {ln}" for k, ln in ptxas_lines(err)
                 if "serve" in k]
        built[name] = (lib, lines)
    return built


def sass_ops(lib, ops=("LDS", "LDG", "LD", "FFMA", "IMAD", "UBLKCP",
                       "SYNCS")):
    """Instructions of each serving kernel's SASS (``cuobjdump -sass``)
    by opcode -> {kernel: {opcode: count}}: shared loads (LDS) against
    generic ones (LD), FMAs against integer multiply-adds, the bulk
    copies (UBLKCP), the barrier ops."""
    import re
    from chip_smoke import short_kernel_name
    exe = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = short_kernel_name(m.group(1))
            counts[fn] = dict.fromkeys(ops, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if fn and m and m.group(1) in counts[fn]:
            counts[fn][m.group(1)] += 1
    return counts


class ClockSampler:
    """``nvidia-smi`` sampling the SM clock every 100 ms while it runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [ln.split(",") for ln in out.splitlines() if "," in ln]
        sm = sorted(int(r[0]) for r in rows if r[0].strip().isdigit())
        self.line = (f"SM clock over {len(sm)} samples: min {sm[0]}, median "
                     f"{sm[len(sm) // 2]}, max {sm[-1]} MHz (max "
                     f"{rows[0][1].strip()} MHz)" if sm else
                     "SM clock: no samples")
        return False


def entry(lib, multi):
    fn = getattr(ctypes.CDLL(str(lib)),
                 "ials_serve_forward_multi" if multi
                 else "ials_serve_forward")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def first_args(case, multi):
    """The first version's struct for ``case`` -> (args, logits, v)."""
    import torch
    w = case.stacked if multi else case.single[0]
    logits = torch.empty((case.S, case.NA), device=case.frames.device)
    v = torch.empty((case.S,), device=case.frames.device)
    a = FirstArgs(B=case.S, S=case.D, Hp=case.hp, n_act=case.NA,
                  fast_gates=1, n_pol=case.N if multi else 1)
    a.frames0, a.mask = case.frames.data_ptr(), case.mask.data_ptr()
    if multi:
        a.pidx = case.pidx.data_ptr()
    for i, t in enumerate(w):
        a.pw[i] = t.data_ptr()
    a.logits_out, a.v_out = logits.data_ptr(), v.data_ptr()
    return a, logits, v


def first_wrapper(fn, case, multi):
    """The first version's Python wrapper, as it was: the inputs checked,
    outputs allocated and the whole struct built anew, the device
    entered, one launch of ``fn``."""
    import torch
    from repro_torch.kernels.aip_step import _f32, _i32
    lead = (case.N,) if multi else ()
    D, Hp, NH = case.D, case.hp, case.NA + 1
    shapes = ((D, Hp), (Hp,), (Hp, Hp), (Hp,), (Hp, NH), (NH,))
    for t, shape in zip(case.stacked if multi else case.single[0], shapes):
        _f32(t, "w", lead + shape)
    _f32(case.frames, "frames", (case.S, D))
    _i32(case.mask, "mask", (case.S,))
    if multi:
        _i32(case.pidx, "pidx", (case.S,))
    a, logits, v = first_args(case, multi)
    stream = torch.cuda.current_stream(case.frames.device).cuda_stream
    with torch.cuda.device(case.frames.device):
        if fn(ctypes.byref(a), stream) != 0:
            raise RuntimeError("first version: launch refused")
    return logits, v


def runner(lib, case, multi, **plan):
    """A no-argument call of one build under one plan -> (call, logits,
    v); the call raises if the launch is refused."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    fn = entry(lib, multi)
    stream = torch.cuda.current_stream().cuda_stream
    if plan.get("first"):
        a, logits, v = first_args(case, multi)
    else:
        a, logits, v, _, _ = cuda.serve_args(
            case.frames, case.mask, case.pidx if multi else None,
            case.stacked if multi else case.single[0], fast_gates=True,
            lead=(case.N,) if multi else (), lanes=plan.get("lanes"),
            policy_axis=plan.get("policy_axis"))
        if plan.get("cols"):   # the plan's row groups, a wider tile
            g = a.serve_lanes // a.serve_rows_per_thread
            a.serve_cols_per_thread = plan["cols"]
            a.serve_threads = -(-a.Hp // plan["cols"] * g // 32) * 32

    def call():
        if fn(ctypes.byref(a), stream) != 0:
            raise RuntimeError(f"{lib.name} {plan}: launch refused")
    return call, logits, v, a


def kernel_plan(case):
    from repro_torch.kernels.aip_step import serve_plan
    return serve_plan(case.S, case.D, case.hp, case.NA + 1, case.N)


def print_timeline(label, marks, mhz=1980.0):
    """The timeline copy's marks: block (0, 0)'s points in us (clock64 at
    ``mhz``), and over the blocks that computed, the median and the
    largest end."""
    m = marks.view(-1, 8).cpu()
    ran = m[m[:, 7] > 0]
    b0 = ", ".join(f"{n} {float(t) / mhz:.2f}"
                   for n, t in zip(MARK_NAMES, m[0, 1:]))
    ends = ran[:, 7].double() / mhz
    print(f"[timeline] {label}: block 0 (us since its start): {b0}; end "
          f"over {len(ran)} blocks: median {float(ends.median()):.2f}, max "
          f"{float(ends.max()):.2f} us", flush=True)


def main():
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    built = build_all()
    for name, (_, lines) in built.items():
        for ln in lines:
            print(f"[ptxas] {name}: {ln}", flush=True)
    for fn, ops in sass_ops(built["kernel"][0]).items():
        print(f"[sass] {fn}: {ops}", flush=True)
    sampler = ClockSampler().__enter__()
    dev = torch.device("cuda", 0)
    first, kernel = built["first version"][0], built["kernel"][0]
    seed = 500
    for domain in chip_smoke.SERVE_WIDTHS:
        for S in SLOTS:
            for N in POLICIES:
                seed += 1
                case = chip_smoke.ServeCase(domain, S, N, seed, dev)
                multi = N > 1
                runs = {"first version": dict(lib=first, first=True),
                        "kernel": dict(lib=kernel)}
                for name in list(VARIANTS)[1:]:
                    runs[name] = dict(lib=built[name][0])
                for R in LANES:
                    runs[f"lanes {R}"] = dict(lib=kernel, lanes=R)
                runs["four columns a thread"] = dict(lib=kernel, cols=4)
                if multi:   # the other side of the plan's rule
                    axis = kernel_plan(case).policy_blocks == 1
                    runs["policy axis" if axis else "no policy axis"] = \
                        dict(lib=kernel, policy_axis=axis)
                calls, marks = {}, None
                for name, r in runs.items():
                    call, lg, v, a = runner(r.pop("lib"), case, multi, **r)
                    if name == "timeline":
                        marks = torch.zeros(
                            (65536 * 8,), dtype=torch.int64, device=dev)
                        a.rew_out = marks.data_ptr()
                    call()
                    calls[name] = (call, lg, v)
                torch.cuda.synchronize()
                ref_lg, ref_v = calls["first version"][1:]
                for name, (_, lg, v) in calls.items():
                    if name in TIMING_ONLY:
                        continue
                    if not (torch.equal(lg, ref_lg)
                            and torch.equal(v, ref_v)):
                        raise AssertionError(
                            f"{name} {domain} S={S} N={N}: not bitwise "
                            f"equal to the first version")
                order = list(calls) + list(reversed(calls))
                times = {name: [] for name in calls}
                for name in order:
                    times[name].append(chip_smoke.device_ms(
                        calls[name][0], reps=REPS, warmup=5))
                calls["timeline"][0]()
                torch.cuda.synchronize()
                print_timeline(f"{domain} S={S} N={N}", marks)
                for name, ts in times.items():
                    shown = ", ".join(f"{t:.5f}" if isinstance(t, float)
                                      else str(t) for t in ts)
                    note = ("timing only" if name in TIMING_ONLY else
                            "bitwise equal to the first version")
                    print(f"[ablation] {domain} S={S} N={N} {name}: device"
                          f" ms {shown} ({note})", flush=True)
    # one call as a caller sees it: event ms beside device ms
    from repro_torch.kernels import aip_step as cuda
    for N in POLICIES:
        seed += 1
        case = chip_smoke.ServeCase("traffic", 128, N, seed, dev)
        multi = N > 1
        if multi:
            new = (lambda: cuda.serve_forward_multi(
                case.frames, case.mask, case.pidx, case.stacked,
                fast_gates=True))
        else:
            new = (lambda: cuda.serve_forward(case.frames, case.mask,
                                              case.single[0],
                                              fast_gates=True))
        first_fn = entry(first, multi)
        old = (lambda: first_wrapper(first_fn, case, multi))
        res = {}
        for name, fn in (("first version", old), ("kernel", new),
                         ("kernel", new), ("first version", old)):
            res.setdefault(name, []).append(
                (chip_smoke.time_cuda(fn, reps=50, warmup=5),
                 chip_smoke.device_ms(fn, reps=50, warmup=5)))
        for name, ts in res.items():
            shown = "; ".join(f"event {e:.4f}, device {d}" for e, d in ts)
            print(f"[wrapper] traffic S=128 N={N} {name}: {shown}",
                  flush=True)
    sampler.__exit__(None, None, None)
    print(f"[clock] {sampler.line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
