#!/usr/bin/env python3
"""Where a tick of the ``gru_sequence`` kernel spends its time, on the
card, and how the redesigned kernel compares with the first version.

    python3 tools/gru_ablation.py      # one CUDA card and nvcc

Builds, each into a library of its own under ``build/gru_ablation/``
(one nvcc each, side by side):
  - "first version": ``tools/gru_first_version.cu``, the first CUDA body
    (8 rows a block, a thread one gate column, x_t @ wx and h @ wh in one
    chain, three barriers a tick);
  - "kernel": ``src/repro_torch/kernels/csrc/gru_kernels.cu`` as it is;
  - "x @ wx in the chain": with ``GRU_X_IN_CHAIN``: gx of tick t
    computed in tick t, before h @ wh (the kernel computes gx of tick
    t + 1 at the end of tick t, after the gates, off the recurrence);
  - "scalar reads": with ``GRU_SCALAR_READS``: the activations read one
    float at a time instead of 16-byte vectors;
  - "x steps padded": with ``GRU_X_PADDED``: x @ wx walks as many k-steps
    as h @ wh (8; 5 are the part's at D = 40), the extra ones against zero
    weights;
  - "two units a thread": with ``GRU_UNITS=2`` and the plan's
    ``units_per_thread=2``: 256 threads of two units (half the shared
    loads an FMA) instead of 512 of one;
  - "4 parts": with ``GRU_REG_PARTS=4``, ``GRU_REG_STEPS=16`` and the
    plan's ``parts=4``: the weights over 4 parts of 16 k-steps, 256
    threads (fewer shuffles, longer chains);
  - "timeline": with ``GRU_TIMELINE``: thread 0 of block 0 sums clock64()
    cycles per phase of a tick (x prefetch issue, h @ wh, its sum over
    the parts, gates and stores, x @ wx of the next tick with its sum, x
    store, barrier);
  - timing only, its output wrong: "no products" (``GRU_NO_PRODUCTS``:
    the sums, gates, stores and barrier alone, the floor of a tick).
Then at the traffic AIP's main shape (B = 1024, T = 128, D = 40, H = 64),
at it in bf16 and at ``benchmarks/kernel_bench.py``'s shape (B = 8, T =
64) it times each build and the kernel under other launch plans (rows a
tile; the "l2" route, weights read through the cache, at the kernel's 8
parts and at 4), as device ms (``torch.profiler``), twice, in turns
(forward, then backward over the list). The builds and plans with the
kernel's K-parts must be bitwise equal to the kernel (the same sums in
the same order); the first version and other K-parts are held to
``chip_smoke.py``'s tolerance against the plain version. The card's name
and power limit come first, the SM clock over the run last.
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
OUT = ROOT / "build" / "gru_ablation"
# (label, B, T, D, H, dtype): the main shape first
SHAPES = [("main", 1024, 128, 40, 64, "float32"),
          ("bf16", 1024, 128, 40, 64, "bfloat16"),
          ("bench", 8, 64, 40, 64, "float32")]
# name -> (nvcc flags, plan overrides)
BUILDS = {"kernel": ([], {}),
          "x @ wx in the chain": (["-DGRU_X_IN_CHAIN"], {}),
          "scalar reads": (["-DGRU_SCALAR_READS"], {}),
          "x steps padded": (["-DGRU_X_PADDED"], {}),
          "two units a thread": (["-DGRU_UNITS=2"], {"units_per_thread": 2}),
          "4 parts": (["-DGRU_REG_PARTS=4", "-DGRU_REG_STEPS=16"],
                      {"parts": 4}),
          "timeline": (["-DGRU_TIMELINE"], {}),
          "no products": (["-DGRU_NO_PRODUCTS"], {})}
TIMING_ONLY = ("no products",)
SAME_SUMS = ("x @ wx in the chain", "scalar reads", "x steps padded",
             "two units a thread", "timeline")
# the timeline's marks (gru_kernels.cu GRU_MARK), in a tick's order
PHASES = {1: "x prefetch issue", 5: "x @ wx in the tick + sum", 2: "h @ wh",
          3: "sum over parts (h)", 6: "gates + stores",
          4: "x @ wx of the next tick + sum", 7: "x store", 8: "barrier"}
REPS = 10


def build_all():
    """Compile the first version and every build of the kernel, side by
    side -> {name: library}; prints ptxas's lines of the GRU kernels."""
    from chip_smoke import ptxas_lines
    from repro_torch.kernels.aip_step import NVCC_FLAGS, _nvcc
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    srcs = {"first version": (ROOT / "tools" / "gru_first_version.cu", [])}
    for name, (flags, _) in BUILDS.items():
        srcs[name] = (CSRC / "gru_kernels.cu", flags)
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
        # the main shape's instantiation (8 rows, x @ wx in 5 steps over 8
        # parts, 10 over 4) and the first version's kernel
        for k, ln in ptxas_lines(err):
            if ((k.startswith("gru_seq_kernel<8,") and k.endswith(
                    (",5>", ",10>"))) or k.startswith("gru_sequence")):
                print(f"[ptxas] {name}: {k}: {ln}", flush=True)
        built[name] = ctypes.CDLL(str(lib))
    return built


def inputs(B, T, D, H, dtype, seed, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn((B, T, D), generator=g, device=dev).to(dt)
    wx = (0.2 * torch.randn((D, 3 * H), generator=g, device=dev)).to(dt)
    wh = (0.2 * torch.randn((H, 3 * H), generator=g, device=dev)).to(dt)
    b = (0.1 * torch.randn((3 * H,), generator=g, device=dev)).to(dt)
    h0 = (0.5 * torch.randn((B, H), generator=g, device=dev)).to(dt)
    return x, wx, wh, b, h0


def kernel_runner(lib, xs, **plan):
    """A no-argument call of one build of the kernel under one plan ->
    (call, hs, args)."""
    import torch
    from repro_torch.kernels import gru
    args, hs, _, keep = gru.gru_args(*xs, **plan)
    fn = lib.gru_sequence_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(ctypes.byref(args), stream) != 0:
            raise RuntimeError(f"gru_sequence_run {plan}: launch refused")
    return call, hs, (args, keep)


def first_runner(lib, xs):
    """The first version's entry point on the same inputs."""
    import torch
    x, wx, wh, b, h0 = xs
    B, T, D = x.shape
    H = wh.shape[0]
    ws = [w.float().contiguous() for w in (wx, wh, b, h0)]
    hs = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    fn = lib.layer_gru_sequence
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(x.data_ptr(), *(w.data_ptr() for w in ws), hs.data_ptr(), B,
              T, D, H, int(x.dtype == torch.bfloat16), stream) != 0:
            raise RuntimeError("first version: launch refused")
    return call, hs, (ws,)


def main():
    import torch
    import chip_smoke
    from repro_torch.kernels import gru, ref
    from tools.serve_ablation import ClockSampler
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    built = build_all()
    sampler = ClockSampler().__enter__()
    dev = torch.device("cuda", 0)
    tol = chip_smoke.LAYER_TOL["gru_sequence"]
    for i, (label, B, T, D, H, dtype) in enumerate(SHAPES):
        xs = inputs(B, T, D, H, dtype, 900 + i, dev)
        plan = gru.gru_plan(B, T, D, H, getattr(torch, dtype))
        runs = {"first version": first_runner(built["first version"], xs)}
        for name, (_, kw) in BUILDS.items():
            runs[name] = kernel_runner(built[name], xs, **kw)
        for rows in gru.GRU_ROWS:
            if rows != plan.rows:
                runs[f"rows {rows}"] = kernel_runner(built["kernel"], xs,
                                                     rows=rows)
        runs["route l2"] = kernel_runner(built["kernel"], xs, route="l2",
                                         parts=plan.parts)
        runs["route l2, 4 parts"] = kernel_runner(built["kernel"], xs,
                                                  route="l2", parts=4)
        for call, _, _ in runs.values():
            call()
        torch.cuda.synchronize()
        plain, _ = ref.gru_sequence_ref(*xs)
        want = runs["kernel"][1]
        checks = {}
        for name, (_, hs, extra) in runs.items():
            same = name in SAME_SUMS or name.startswith("rows") or \
                name == "route l2"
            if name in TIMING_ONLY:
                checks[name] = "timing only"
            elif same:
                if not torch.equal(hs, want):
                    raise AssertionError(f"{label} {name}: not bitwise "
                                         f"equal to the kernel")
                checks[name] = "bitwise equal to the kernel"
            else:
                err = chip_smoke._near(hs, plain, tol, f"{label} {name}")
                checks[name] = f"within tolerance, max err {err:.3g}"
        names = list(runs)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(chip_smoke.device_ms(runs[name][0],
                                                    reps=REPS, warmup=2))
        # the phases of a tick, from the timeline build
        marks = (ctypes.c_longlong * 16)()
        runs["timeline"][0]()
        torch.cuda.synchronize()
        if built["timeline"].gru_timeline_read(marks) != 0:
            raise RuntimeError("gru_timeline_read failed")
        cyc = [int(m) for m in marks]
        parts = ", ".join(f"{n} {cyc[k] / T:.0f}"
                          for k, n in PHASES.items() if cyc[k])
        print(f"[timeline] {label}: cycles a tick: {parts}; tick total "
              f"{sum(cyc[k] for k in PHASES) / T:.0f} (prologue {cyc[0]})",
              flush=True)
        for name, ts in times.items():
            shown = ", ".join(f"{t:.4f}" if isinstance(t, float) else str(t)
                              for t in ts)
            if name == "first version":
                desc = "8 rows, 256 threads"
            else:
                a = runs[name][2][0]
                desc = (f"rows {a.rows}, parts {a.parts}, units a thread "
                        f"{a.units_per_thread}, threads {a.threads}, route "
                        f"{gru.ROUTES[a.route]}")
            print(f"[ablation] {label} (B={B}, T={T}, D={D}, H={H}, "
                  f"{dtype}) {name}: device ms {shown} ({checks[name]}; "
                  f"{desc})", flush=True)
        del runs
        torch.cuda.empty_cache()
    sampler.__exit__(None, None, None)
    print(f"[clock] {sampler.line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
