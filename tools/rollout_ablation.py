#!/usr/bin/env python3
"""Where a tick of the horizon kernels (``policy_rollout`` with either
AIP cell, ``fnn_rollout``, ``aip_rollout_multi``) spends its time, on the
card, and how the redesigned kernels compare with the first version.

    python3 tools/rollout_ablation.py [KERNEL ...]   # one CUDA card, nvcc

(KERNEL: policy_rollout[fnn], policy_rollout[gru], fnn_rollout,
aip_rollout_multi, aip_step, and the first four with the warehouse
functor, e.g. policy_rollout[gru][warehouse]; all without arguments.)

Builds, each into a library of its own under ``build/rollout_ablation/``
(one nvcc each, side by side):
  - "first version": ``tools/rollout_first_version.cu``, the first CUDA
    body (one block of 128 threads per 16 lanes, weights read with
    ``__ldg`` inside each product);
  - "kernel": ``src/repro_torch/kernels/csrc/ials_kernels.cu`` as it is;
  - "weights from L2": the same source with ``IALS_ROLL_WEIGHTS_FROM_L2``:
    the weights are still staged, but the products read them from global
    memory on every tick;
  - "integer division": with ``IALS_ROLL_PLAIN_DIV``: the products'
    item coordinates by integer division instead of the float-reciprocal
    divider;
  - "timeline": with ``IALS_ROLL_TIMELINE``: thread 0 of each CTA sums
    clock64() cycles per phase of a tick (policy layers, argmax, dset,
    AIP products, draw, the two cross-role barriers, LS tick and resets,
    observation, frames), printed per tick for the two CTAs of tile 0;
  - timing only, their outputs wrong: "no products"
    (``IALS_ROLL_NO_PRODUCTS``: the barriers, argmax, dset, LS tick and
    frame refill alone, the floor that a tick's dependencies set) and
    its timeline;
  - for ``aip_step`` (one GRU tick on the horizon kernel's GRU role,
    ``step_kernel``): "aip_step first version"
    (``tools/aip_step_first_version.cu``, one block of 128 threads per 16
    lanes, every weight read with ``__ldg`` inside its K loop) and
    "weights from global" (``IALS_STEP_FROM_GLOBAL``: the products read
    the weights from global memory, each chain's loads in flight
    together, against the kernel's staging by bulk copies).
Then for each kernel at the main path's shape (FNN A = 1, B = 16; GRU
A = 25, B = 16: ``aip_rollout_multi`` is the GRU horizon without the
policy, actions streamed) and at A = 1, B = 512 and A = 25, B = 64 (T =
128), and with the warehouse functor at A = 36 and 1, B = 16 (no first
version: its body carries traffic only), it
times each build and the kernel under other launch plans: lanes a tile
1-32, one CTA a tile instead of two (``policy_rollout``, where it fits),
256 and 128 threads (fewer K-parts), and no K-split at all, as device ms
(``torch.profiler``), twice, in turns (forward, then backward over the
list). ``aip_step`` is timed at A = 25, B = 16 (the main path), A = 1,
B = 512 and A = 25, B = 512: the first version, the kernel, weights
from global, no products, a timeline (clock64 per phase of a CTA) and
the kernel at other lanes a tile where the K-parts stay the same (bitwise
equal to the kernel). The builds of the kernel's own plan must be
bitwise equal to the kernel; every other variant but the timing-only ones is held to
``chip_smoke.py``'s lane and flip rule against the plain version (a
different K-split sums in another order). The card's name and power
limit come first, the SM clock over the run last.
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
OUT = ROOT / "build" / "rollout_ablation"
T = 128
# (kernel, cell, A, B, domain): the main path's shapes first
KERNELS = (("policy_rollout[fnn]", "fnn"), ("policy_rollout[gru]", "gru"),
           ("fnn_rollout", "fnn"), ("aip_rollout_multi", "gru"))
SHAPES = ([(kernel, cell, A, B, "traffic") for kernel, cell in KERNELS
           for A, B in (((1, 16) if cell == "fnn" else (25, 16)),
                        (1, 512), (25, 64))]
          + [(kernel, cell, A, B, "warehouse") for kernel, cell in KERNELS
             for A, B in ((36, 16), (1, 16))])
BUILDS = {"kernel": [], "weights from L2": ["-DIALS_ROLL_WEIGHTS_FROM_L2"],
          "timeline": ["-DIALS_ROLL_TIMELINE"],
          "no products": ["-DIALS_ROLL_NO_PRODUCTS"],
          "no products, timeline": ["-DIALS_ROLL_NO_PRODUCTS",
                                    "-DIALS_ROLL_TIMELINE"],
          "integer division": ["-DIALS_ROLL_PLAIN_DIV"],
          "weights from global": ["-DIALS_STEP_FROM_GLOBAL"]}
STEP_SHAPES = ((25, 16), (1, 512), (25, 512))
TIMING_ONLY = ("no products", "no products, timeline")
TIMELINES = ("timeline", "no products, timeline")
# bitwise equal to the kernel
SAME_PLAN = ("weights from L2", "timeline", "integer division")
PHASES = ("prologue", "policy l1", "policy l2", "policy head",
          "argmax + outputs", "dset", "AIP products", "draw",
          "barrier 1 (action)", "LS tick + resets", "state zero + obs",
          "barrier 2 (obs)", "frames", "action to the d-set")
REPS = 10


def build_all():
    """Compile the first version and every build of the kernel, side by
    side -> {name: library}; prints ptxas's lines of the horizon kernels."""
    from chip_smoke import ptxas_lines
    from repro_torch.kernels.aip_step import NVCC_FLAGS, _nvcc
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    srcs = {"first version": (ROOT / "tools" / "rollout_first_version.cu",
                              []),
            "aip_step first version": (
                ROOT / "tools" / "aip_step_first_version.cu", [])}
    for name, flags in BUILDS.items():
        srcs[name] = (CSRC / "ials_kernels.cu", flags)
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
        for k, ln in ptxas_lines(err):
            if "horizon" in k or "rollout" in k or "step" in k:
                print(f"[ptxas] {name}: {k}: {ln}", flush=True)
        built[name] = lib
    return built


def entry(lib, name):
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def runner(lib, case, policy, no_split=False, timeline=False, **plan):
    """A no-argument call of one build under one plan -> (call, outputs,
    args); the call raises if the launch is refused."""
    import torch
    from repro_torch.kernels import aip_step as cuda
    dom = case.ls_env.kernel_domain
    if policy:
        name, _, args, out, _, keep = cuda.policy_rollout_args(
            case.io.ls, case.s0, case.frames0, case.aw, case.pw,
            case.gumbel, case.bits, case.done, case.io.noise, case.reset_ls,
            kind=case.kind, n_agents=case.A, fast_gates=True, domain=dom,
            **plan)
    else:
        fnn = case.kind == "fnn"
        name = "ials_fnn_rollout" if fnn else "ials_aip_rollout_multi"
        D = cuda.domain_layout(dom).D
        args, out, keep = cuda.rollout_args(
            case.io.ls, case.s0, case.aw, case.actions, case.bits,
            case.io.noise, n_agents=case.A, domain=dom, D=D, H=64,
            M=case.acfg.n_out,
            stack=case.s0.shape[1] // D if fnn else 1, cell=case.kind,
            **plan)
    if no_split:
        args.roll_split[:] = (1,) * 6
    marks = None
    if timeline:
        grid = case.A * -(-case.B // args.roll_lanes) * args.roll_cluster
        marks = torch.zeros((grid * 16,), dtype=torch.int64,
                            device=case.s0.device)
        args.h2 = marks.data_ptr()
    fn = entry(lib, name)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(ctypes.byref(args), stream) != 0:
            raise RuntimeError(f"{lib.name} {plan}: launch refused")
    return call, out, args, (keep, marks)


def flat(out):
    for o in out:
        if isinstance(o, (tuple, list)):
            yield from flat(o)
        else:
            yield o


def held_to_plain(case, policy, out, plain, margins, label):
    """The lane and flip rule of ``chip_smoke.py`` -> (flips, max err)."""
    from chip_smoke import compare_lanes
    L = case.A * case.B
    if policy:
        (kl, ks, kf, kx, ka, klg, kv, kr) = out
        (pl, ps, pf, px, pa, plg, pv, pr) = plain
        return compare_lanes(
            label, [(kx, px, False), (ka, pa, True), (klg, plg, False),
                    (kv, pv, False), (kr, pr, False)],
            [(k, p, True) for k, p in zip(kl, pl)]
            + [(ks, ps, False), (kf, pf, False)], margins, case.T, L)
    k_ls, k_s, k_r = out
    p_ls, p_s, p_r = plain
    return compare_lanes(label, [(k_r, p_r, False)],
                         [(k, p, True) for k, p in zip(k_ls, p_ls)]
                         + [(k_s, p_s, False)], margins, case.T, L)


def print_timeline(label, marks, args, mhz):
    """Tile 0's phase sums, per tick, in us at ``mhz`` (CTA 0 is the
    policy role in a cluster of two)."""
    m = marks.view(-1, 16).cpu().double()
    for cta in range(int(args.roll_cluster)):
        parts = [f"{name} {float(m[cta, i]) / mhz / T:.3f}"
                 for i, name in enumerate(PHASES) if m[cta, i] > 0]
        total = float(m[cta, 1:len(PHASES)].sum()) / mhz / T
        print(f"[timeline] {label} CTA {cta}: us a tick: {', '.join(parts)};"
              f" tick total {total:.3f} (prologue counted once: "
              f"{float(m[cta, 0]) / mhz:.2f} us)", flush=True)


def ablate_aip_step(built, seed=900):
    """``aip_step`` at STEP_SHAPES: the first version, the kernel, weights
    from global and no products, timed in turns; weights from global
    bitwise equal to the kernel, the kernel and the first version within ATOL of
    the plain version with every flipped draw within FLIP_EPS of its
    threshold."""
    import torch
    import chip_smoke
    from repro_torch.kernels import aip_step as cuda
    from repro_torch.kernels import ref
    from repro_torch.nn.act import fast_sigmoid, random_bits, \
        uniform_from_bits
    dev = torch.device("cuda", 0)
    builds = {"first version": ("aip_step first version", None),
              "kernel": ("kernel", None),
              "weights from global": ("weights from global", None),
              "no products": ("no products", None),
              "timeline": ("timeline", None)}
    for R in (4, 8, 16, 32):     # other lanes a tile, the same K-parts
        builds[f"lanes {R}"] = ("kernel", R)
    for A, B in STEP_SHAPES:
        seed += 1
        label = f"aip_step A={A} B={B}"
        case = chip_smoke.Case("gru", A, B, 1, seed, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        d = (torch.rand((B, A, 40), generator=g, device=dev) < 0.3).float()
        h = 0.5 * torch.randn((B, A, 64), generator=g, device=dev)
        bits = random_bits((B, A, 4), g)
        ins = (d, h, *case.aw, bits)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for name, (build, lanes) in builds.items():
            plan = cuda.step_plan(A, B, 40, 64, 4, lanes=lanes)
            if lanes is not None and (lanes == cuda.step_plan(
                    A, B, 40, 64, 4).lanes or plan.splits != cuda.step_plan(
                    A, B, 40, 64, 4).splits):
                continue
            args, out, keep = cuda.step_args(*ins, lanes=lanes)
            if name == "timeline":
                marks = torch.zeros((cuda.step_plan(A, B, 40, 64, 4).grid
                                     * 16,), dtype=torch.int64, device=dev)
                args.frames_out = marks.data_ptr()
            fn = entry(built[build], "ials_aip_step")

            def call(fn=fn, args=args, name=name):
                if fn(ctypes.byref(args), stream) != 0:
                    raise RuntimeError(f"{label} {name}: launch refused")
            call()
            calls[name] = (call, out, keep)
        torch.cuda.synchronize()
        ph, plg, pu = ref.aip_step_multi_ref(*ins)
        margin = (uniform_from_bits(bits) - fast_sigmoid(plg)).abs()
        checks = {"no products": "timing only",
                  "timeline": "timing only (clock64 marks)"}
        for name in calls:
            if name.startswith("lanes"):
                if not all(torch.equal(a, b) for a, b in zip(
                        calls[name][1], calls["kernel"][1])):
                    raise AssertionError(f"{label} {name}: not bitwise "
                                         f"equal to the kernel")
                checks[name] = "bitwise equal to the kernel"
        for name in ("first version", "kernel"):
            kh, klg, ku = calls[name][1]
            err = max(float((kh - ph).abs().max()),
                      float((klg - plg).abs().max()))
            diff = ku != pu
            if err > chip_smoke.ATOL or bool((diff & (
                    margin >= chip_smoke.FLIP_EPS)).any()):
                raise AssertionError(f"{label} {name}: max error {err:.3g}"
                                     f" or a draw flipped off its threshold")
            checks[name] = (f"max err {err:.3g}, flips "
                            f"{int(diff.any(-1).sum())}")
        if not all(torch.equal(a, b) for a, b in zip(
                calls["weights from global"][1], calls["kernel"][1])):
            raise AssertionError(f"{label} weights from global: not "
                                 f"bitwise equal to the kernel")
        checks["weights from global"] = "bitwise equal to the kernel"
        order = list(calls) + list(reversed(calls))
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(chip_smoke.device_ms(calls[name][0],
                                                    reps=REPS, warmup=2))
        marks.zero_()
        calls["timeline"][0]()
        torch.cuda.synchronize()
        m = marks.view(-1, 16).double().mean(0).cpu() / 1980.0
        print(f"[timeline] {label}: us a CTA (mean): loads issued "
              f"{float(m[0]):.3f}, staging wait + barrier {float(m[1]):.3f},"
              f" cell {float(m[2]):.3f}, outputs {float(m[3]):.3f}",
              flush=True)
        for name, ts in times.items():
            p = cuda.step_plan(A, B, 40, 64, 4, lanes=builds[name][1])
            shown = ", ".join(f"{t:.5f}" if isinstance(t, float) else str(t)
                              for t in ts)
            plan = ("16 lanes, 128 threads" if name == "first version" else
                    f"lanes {p.lanes}, threads {p.threads}, splits "
                    f"{p.splits}, smem {p.smem}")
            print(f"[ablation] {label} {name}: device ms {shown} "
                  f"({checks[name]}; {plan})", flush=True)
        del case, calls
        torch.cuda.empty_cache()


def main():
    import torch
    import chip_smoke
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
    seed = 800
    only = set(sys.argv[1:])
    for kernel, cell, A, B, domain in SHAPES:
        seed += 1
        if domain != "traffic":
            kernel = f"{kernel}[{domain}]"
        if only and kernel not in only:
            continue
        policy = kernel.startswith("policy")
        case = chip_smoke.Case(cell, A, B, T, seed, dev, domain)
        label = f"{kernel} A={A} B={B}"
        runs = {"kernel": dict(lib=built["kernel"])}
        if domain == "traffic":
            runs["first version"] = dict(lib=built["first version"])
        for name in SAME_PLAN + TIMING_ONLY:
            runs[name] = dict(lib=built[name], timeline=name in TIMELINES)
        for R in (1, 2, 4, 8, 16, 32):
            runs[f"lanes {R}"] = dict(lib=built["kernel"], lanes=R)
        if policy:
            runs["one CTA a tile"] = dict(lib=built["kernel"], cluster=1)
        for nt in (256, 128):
            runs[f"threads {nt}"] = dict(lib=built["kernel"], threads=nt)
        runs["no K-split"] = dict(lib=built["kernel"], no_split=True)
        calls = {}
        for name, r in runs.items():
            try:
                calls[name] = runner(r.pop("lib"), case, policy, **r)
                calls[name][0]()
            except ValueError as e:   # a plan that does not fit
                print(f"[ablation] {label} {name}: no plan ({e})",
                      flush=True)
                calls.pop(name, None)
        torch.cuda.synchronize()
        trace = {}
        plain = (case.policy_call(plain=True, trace=trace) if policy
                 else case.rollout_call(plain=True, trace=trace))
        margins = (torch.minimum(torch.stack(trace["aip"]),
                                 torch.stack(trace["policy"])) if policy
                   else torch.stack(trace["aip"]))
        ref = list(flat(calls["kernel"][1]))
        checks = {}
        for name, (_, out, args, _) in calls.items():
            if name in TIMING_ONLY:
                checks[name] = "timing only"
            elif name in SAME_PLAN:
                if not all(torch.equal(a, b)
                           for a, b in zip(flat(out), ref)):
                    raise AssertionError(f"{label} {name}: not bitwise "
                                         f"equal to the kernel")
                checks[name] = "bitwise equal to the kernel"
            else:
                flips, err = held_to_plain(case, policy, out, plain, margins,
                                           f"{label} {name}")
                checks[name] = (f"lane rule held: flips {flips}, max err "
                                f"{err:.3g}")
        order = list(calls) + list(reversed(calls))
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(chip_smoke.device_ms(calls[name][0],
                                                    reps=REPS, warmup=2))
        for name in TIMELINES:
            call, _, args, (_, marks) = calls[name]
            marks.zero_()
            call()
            torch.cuda.synchronize()
            print_timeline(f"{label} {name}", marks, args, 1980.0)
        for name, ts in times.items():
            a = calls[name][2]
            plan = (f"lanes {a.roll_lanes}, cluster {a.roll_cluster}, "
                    f"threads {a.roll_threads}, splits "
                    f"{tuple(a.roll_split)}, smem {a.roll_smem}"
                    if name != "first version" else "16 lanes, 128 threads")
            shown = ", ".join(f"{t:.4f}" if isinstance(t, float) else str(t)
                              for t in ts)
            print(f"[ablation] {label} {name}: device ms {shown} "
                  f"({checks[name]}; {plan})", flush=True)
        del case, calls
        torch.cuda.empty_cache()
    if not only or "aip_step" in only:
        ablate_aip_step(built)
    sampler.__exit__(None, None, None)
    print(f"[clock] {sampler.line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
