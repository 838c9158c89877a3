#!/usr/bin/env python3
"""Where the CUDA-core flash-attention kernel's time goes, on the card,
and how it compares with the first version.

    python3 tools/flash_f32_ablation.py      # one CUDA card and nvcc

Builds, each into a library of its own under ``build/flash_f32_ablation/``
(one nvcc each, side by side):
  - "first version": ``tools/flash_f32_first_version.cu``, the first CUDA
    body (64-row blocks, scalar synchronous tile loads, three barriers a
    tile, the mask test on every score);
  - "kernel": ``src/repro_torch/kernels/csrc/flash_f32.cu`` as it is;
  - "scalar shared loads" (``FLASH_F32_SCALAR_LOADS``): the tiles read by
    four scalar shared loads in place of each 16-byte one;
  - "synchronous loads" (``FLASH_F32_SYNC_LOADS``): every tile staged by
    plain loads, so a copy no longer runs under the products;
  - "mask on every tile" (``FLASH_F32_MASK_ALWAYS``);
  - "expf" (``FLASH_F32_EXPF``): the correctly rounded exponential in
    place of the kernel's ``__expf``;
  - "timeline" (``FLASH_F32_TIMELINE``): warp 0 of each block sums
    clock64() cycles per phase (wait and barrier, copy issue, q k^T,
    softmax, p v), printed per key tile;
  - "16 warps" (``FLASH_F32_WARPS16``, run on the 128-row plan with 512
    threads: a lane 4 x 4 scores; the port's library has no such build);
  - timing only, its output wrong: "no products"
    (``FLASH_F32_NO_PRODUCTS``: the copies, barriers, softmax and p
    stores alone, the floor).
Then the kernel under other plans (``flash_attention.f32_plan``'s
overrides): the other block height (64 rows, 32-key tiles, two blocks an
SM; or 128 rows, 64-key tiles) and the other ring depth; and the port's
own library (``aip_step.build()``, the kernel linked with the other
sources), to tell a difference of build from one of the run. Each is
timed at the ``qwen3_4b`` f32
shape (B 1, T = S 4096, 32 query and 8 KV heads, D 128), causal and not,
and at ``benchmarks/kernel_bench.py``'s (B 2, T = S 512, 8 / 4 heads, D
64, causal), as device ms (``torch.profiler``), twice, in turns (forward,
then backward over the list). The builds that sum in the kernel's order
must be bitwise equal to it; every other one but the timing-only build is
held to ``chip_smoke.py``'s tolerance (2e-5) against the plain version.
The kernel (``__expf``) is also held at every float32 case of
``chip_smoke.FLASH_CASES``: the condition on which it may use ``__expf``
in place of expf.
The card's name and power limit come first, the SM clock over the run
last.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_f32_ablation"
# (B, T, H, KH, D, causal)
SHAPES = {"qwen3_4b f32 causal": (1, 4096, 32, 8, 128, True),
          "qwen3_4b f32 non-causal": (1, 4096, 32, 8, 128, False),
          "bench (f32, D 64)": (2, 512, 8, 4, 64, True)}
BUILDS = {"kernel": [], "scalar shared loads": ["-DFLASH_F32_SCALAR_LOADS"],
          "synchronous loads": ["-DFLASH_F32_SYNC_LOADS"],
          "mask on every tile": ["-DFLASH_F32_MASK_ALWAYS"],
          "expf": ["-DFLASH_F32_EXPF"],
          "timeline": ["-DFLASH_F32_TIMELINE"],
          "16 warps": ["-DFLASH_F32_WARPS16"],
          "no products": ["-DFLASH_F32_NO_PRODUCTS"]}
# the plan a build runs on, where it is not f32_plan's
BUILD_PLANS = {"16 warps": dict(rows=128, threads=512)}
SAME_SUMS = ("scalar shared loads", "synchronous loads",
             "mask on every tile", "timeline", "port library")
TIMING_ONLY = ("no products",)
PHASES = ("wait + barrier", "copy issue", "q k^T", "softmax", "p v",
          "epilogue", "", "prologue")
TOL = 2e-5
REPS = 10


def build_all():
    """Compile the first version and every build of the kernel, side by
    side -> {name: library}; prints ptxas's lines of the kernels."""
    from chip_smoke import ptxas_lines
    from repro_torch.kernels.aip_step import NVCC_FLAGS, _nvcc
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    srcs = {"first version": (ROOT / "tools" / "flash_f32_first_version.cu",
                              [])}
    for name, flags in BUILDS.items():
        srcs[name] = (CSRC / "flash_f32.cu", flags)
    procs = {}
    for i, (name, (src, flags)) in enumerate(srcs.items()):
        lib = OUT / f"libv{i}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC), "-Xptxas",
               "-v", "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    built = {}
    for name, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-3000:]}")
        lines = [ln for _, ln in ptxas_lines(err)]
        spills = sorted({ln for ln in lines if "spill" in ln})
        print(f"[ptxas] {name}: {'; '.join(spills)}", flush=True)
        built[name] = lib
    return built


def entry(lib):
    fn = ctypes.CDLL(str(lib)).layer_flash_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mha_args(q, k, v, o, causal, plan, marks=None):
    """FlashArgs of a (B, T, H, D) call, as ``flash_attention_mha`` fills
    them, with ``plan``."""
    from repro_torch.kernels import flash_attention as fa
    B, T, H, D = q.shape
    S, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    a = fa.FlashArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        nbh=B * H, nh=H, group=H // KH, T=T, S=S, D=D, Dv=Dv,
        causal=int(causal), q_sb=T * H * D, q_sh=D, q_st=H * D,
        k_sb=S * KH * D, k_sh=D, k_ss=KH * D, v_sb=S * KH * Dv, v_sh=Dv,
        v_ss=KH * Dv, o_sb=T * H * Dv, o_sh=Dv, o_st=H * Dv,
        scale=D ** -0.5)
    fa.set_f32_plan(a, plan)
    if marks is not None:
        a.marks = marks.data_ptr()
    return a


def runner(lib, q, k, v, causal, timeline=False, threads=None, **plan_kw):
    """A no-argument call of one build under one plan (``f32_plan``'s for
    the call, with ``plan_kw`` overriding, and ``threads`` in place of
    its 256 for the FLASH_F32_WARPS16 build) -> (call, output, plan,
    marks)."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, T, H, D = q.shape
    plan = fa.f32_plan(T, k.shape[1], D, v.shape[3], q.dtype, heads=B * H,
                       **plan_kw)
    if threads is not None:
        plan = dataclasses.replace(plan, threads=threads)
    o = torch.empty((B, T, H, v.shape[3]), dtype=q.dtype, device=q.device)
    marks = None
    if timeline:
        marks = torch.zeros((B * H * plan.q_tiles * 8,), dtype=torch.int64,
                            device=q.device)
    a = mha_args(q, k, v, o, causal, plan, marks)
    fn = entry(lib)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(q.dtype == torch.bfloat16)

    def call():
        if fn(ctypes.byref(a), bf16, stream) != 0:
            raise RuntimeError(f"{lib.name} {plan_kw}: launch refused")
    return call, o, plan, (a, marks)


def print_timeline(label, marks, plan, causal, mhz):
    """Warp 0's phase cycles summed over every block, per key tile it
    walked, in cycles and us at ``mhz``."""
    from repro_torch.kernels import flash_attention as fa
    m = marks.view(-1, 8).double().sum(0).cpu()
    heads = marks.numel() // 8 // plan.q_tiles
    tiles = len(fa.f32_tiles(plan, causal)) * heads
    parts = [f"{name} {float(m[i]) / tiles:.0f}"
             for i, name in enumerate(PHASES) if name and i < 5]
    total = float(m[:5].sum()) / tiles
    print(f"[timeline] {label}: cycles a key tile (warp 0): "
          f"{', '.join(parts)}; total {total:.0f} ({total / mhz:.3f} us); "
          f"prologue a block {float(m[7]) / marks.numel() * 8:.0f}",
          flush=True)


def expf_at_every_case(lib):
    """A build (the kernel: __expf) at every float32 case of
    chip_smoke.FLASH_CASES against the plain version -> {label: max
    error}."""
    import torch
    import chip_smoke
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    out = {}
    for label, dims in chip_smoke.FLASH_CASES.items():
        if dims[8] != "float32":
            continue
        B, T, S, H, KH, D, Dv, causal = dims[:8]
        g = torch.Generator(device=dev)
        g.manual_seed(len(label))
        q = torch.randn((B, T, H, D), generator=g, device=dev)
        k = torch.randn((B, S, KH, D), generator=g, device=dev)
        v = torch.randn((B, S, KH, Dv), generator=g, device=dev)
        call, o, _, _ = runner(lib, q, k, v, causal)
        call()
        torch.cuda.synchronize()
        want = ref.flash_attention_mha_ref(q, k, v, causal=causal)
        out[label] = float((o - want).abs().max())
    return out


def main():
    import torch
    import chip_smoke
    from tools.serve_ablation import ClockSampler
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    from repro_torch.kernels.aip_step import build
    built = build_all()
    port_lib = build()
    sampler = ClockSampler().__enter__()
    dev = torch.device("cuda", 0)
    for label, (B, T, H, KH, D, causal) in SHAPES.items():
        g = torch.Generator(device=dev)
        g.manual_seed(sum(map(ord, label)))
        q, k, v = (torch.randn((B, T, h, D), generator=g, device=dev)
                   for h in (H, KH, KH))
        runs = {"first version": dict(lib=built["first version"]),
                "kernel": dict(lib=built["kernel"])}
        for name in BUILDS:
            if name != "kernel":
                runs[name] = dict(lib=built[name],
                                  timeline=name == "timeline",
                                  **BUILD_PLANS.get(name, {}))
        runs["port library"] = dict(lib=port_lib)
        default = runner(built["kernel"], q, k, v, causal)[2]
        rows = 192 - default.rows
        runs[f"{rows}-row blocks"] = dict(lib=built["kernel"], rows=rows)
        other = 5 - default.stages
        runs[f"{other} stages"] = dict(lib=built["kernel"], stages=other)
        calls = {}
        for name, r in runs.items():
            try:
                calls[name] = runner(r.pop("lib"), q, k, v, causal, **r)
                calls[name][0]()
            except (ValueError, RuntimeError) as e:
                print(f"[ablation] {label} {name}: not run ({e})",
                      flush=True)
                calls.pop(name, None)
        torch.cuda.synchronize()
        plain = ref.flash_attention_mha_ref(q, k, v, causal=causal)
        kernel_out = calls["kernel"][1]
        checks = {}
        for name, (_, o, _, _) in calls.items():
            err = float((o - plain).abs().max())
            if name in TIMING_ONLY:
                checks[name] = "timing only"
            elif name in SAME_SUMS:
                if not torch.equal(o, kernel_out):
                    raise AssertionError(f"{label} {name}: not bitwise "
                                         f"equal to the kernel")
                checks[name] = "bitwise equal to the kernel"
            else:
                if err > TOL:
                    raise AssertionError(f"{label} {name}: max error "
                                         f"{err:.3g} above {TOL}")
                same = torch.equal(o, kernel_out)
                checks[name] = (f"max err {err:.3g}"
                                + (", bitwise equal to the kernel"
                                   if same else ""))
        del plain
        torch.cuda.empty_cache()
        order = list(calls) + list(reversed(calls))
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(chip_smoke.device_ms(calls[name][0],
                                                    reps=REPS, warmup=2))
        call, _, plan, (_, marks) = calls["timeline"]
        marks.zero_()
        call()
        torch.cuda.synchronize()
        print_timeline(f"{label}", marks, plan, causal, 1980.0)
        for name, ts in times.items():
            p = calls[name][2]
            shown = ", ".join(f"{t:.4f}" if isinstance(t, float) else str(t)
                              for t in ts)
            desc = ("64 rows, 64-key tiles, 256 threads, expf"
                    if name == "first version" else
                    f"{p.rows} rows, {p.keys} keys, {p.threads} threads, "
                    f"{p.stages} stages, smem {p.smem}")
            print(f"[ablation] {label} {name}: device ms {shown} "
                  f"({checks[name]}; {desc})", flush=True)
        del calls, q, k, v
        torch.cuda.empty_cache()
    errs = expf_at_every_case(built["kernel"])
    worst = max(errs.values())
    print(f"[expf] the kernel (__expf) against the plain version at every "
          f"float32 case:"
          f" worst {worst:.3g} ({'holds' if worst <= TOL else 'misses'} "
          f"{TOL}); " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()),
          flush=True)
    sampler.__exit__(None, None, None)
    print(f"[clock] {sampler.line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
