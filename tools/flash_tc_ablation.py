#!/usr/bin/env python3
"""Where the tensor-core flash-attention kernel's time goes, on the card.

    python3 tools/flash_tc_ablation.py      # one CUDA card and nvcc

Builds copies of ``src/repro_torch/kernels/csrc/flash_wgmma.cu`` with one
part changed or taken out (text replacements listed in ``VARIANTS``),
each a library of its own under ``build/flash_tc_ablation/`` with only
the D = Dv = 128 instantiation, and times each at the ``qwen3_4b`` shape
(B 1, T = S 4096, 32 query and 8 KV heads, bf16), causal and not: the
mean of 20 launches back to back, between two CUDA events. Prints, for
each copy, ptxas's spill line, the highest register its SASS names and
the two times. A copy that drops work computes a wrong result: these
are times, not kernels. The card's name and power limit come first.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_tc_ablation"
SHAPE = dict(B=1, T=4096, H=32, KH=8, D=128)

EXP = ("expf(sc[4 * c + r] - mn[r / 2])", "__expf(sc[4 * c + r] - mn[r / 2])")
EXP_MASKED = ("expf(x - mn[r / 2])", "__expf(x - mn[r / 2])")
STAGES = ("  static constexpr int kStages = kFree / kStage < 4 ? "
          "kFree / kStage : 4;")
KEYS = "  constexpr int BK = DVP <= 128 ? 64 : 32;"
BRANCH = ("  if (__all_sync(0xffffffffu, mn[0] > kNegInf / 4 && "
          "mn[1] > kNegInf / 4)) {")
PV_HI = "    mma_pv<DVP>(o, phi[kk], db);\n"
PV_LO = "    mma_pv<DVP>(o, plo[kk], db);\n"

# name -> [(text in flash_wgmma.cu, its replacement)]
VARIANTS = {
    "kernel": [],
    "__expf for expf": [EXP, EXP_MASKED],
    "2-stage ring": [(STAGES, "  static constexpr int kStages = 2;")],
    "96-key tiles": [(KEYS, "  constexpr int BK = 96;")],
    "128-key tiles": [(KEYS, "  constexpr int BK = 128;")],
    "mask test always": [(BRANCH, "  if (false) {")],
    "P V once (hi only)": [(PV_LO, "")],
    "no P V": [(PV_HI, ""), (PV_LO, "")],
}


def nvcc() -> str:
    exe = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found")
    return exe


def only_d128(src: str) -> str:
    """Keep the launch of the (D, Dv) = (128, 128) instantiation alone."""
    lines = src.splitlines(keepends=True)
    out = [ln for ln in lines if not ln.startswith("  FLASH_TC_WIDTHS(")]
    i = next(i for i, ln in enumerate(out)
             if ln.startswith("#undef FLASH_TC_WIDTHS"))
    out.insert(i, "  FLASH_TC_WIDTHS(128, 128)\n")
    return "".join(out)


def build_all():
    """Write and compile every copy, side by side -> {name: (lib, ptxas
    spill line, highest register)}."""
    from chip_smoke import ptxas_lines
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    base = only_d128((CSRC / "flash_wgmma.cu").read_text())
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: text not found: {old!r}")
            text = text.replace(old, new)
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
        spill = next((ln for n, ln in ptxas_lines(err)
                      if "flash_tc_kernel" in n and "spill" in ln), "?")
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc()), "cuobjdump"), "-sass",
             str(lib)], capture_output=True, text=True, check=True).stdout
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", sass)]
        built[name] = (lib, spill, max(regs) if regs else None)
    return built


def time_variant(lib, args, reps=20):
    import torch
    fn = ctypes.CDLL(str(lib)).layer_flash_attention_tc
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(ctypes.byref(args), stream) != 0:
            raise RuntimeError(f"{lib.name}: launch refused")
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from repro_torch.kernels.flash_attention import FlashArgs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    built = build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    B, T, H, KH, D = (SHAPE[k] for k in ("B", "T", "H", "KH", "D"))
    q, k, v = (torch.randn((B, T, h, D), generator=g, device=dev).bfloat16()
               for h in (H, KH, KH))
    o = torch.empty_like(q)
    times = {}
    for causal in (True, False):
        args = FlashArgs(
            q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
            nbh=B * H, nh=H, group=H // KH, T=T, S=T, D=D, Dv=D,
            causal=int(causal), q_sb=T * H * D, q_sh=D, q_st=H * D,
            k_sb=T * KH * D, k_sh=D, k_ss=KH * D, v_sb=T * KH * D, v_sh=D,
            v_ss=KH * D, o_sb=T * H * D, o_sh=D, o_st=H * D,
            scale=D ** -0.5)
        for name, (lib, _, _) in built.items():
            times[name, causal] = time_variant(lib, args)
    for name, (_, spill, reg) in built.items():
        print(f"[ablation] {name}: causal {times[name, True]:.4f} ms, "
              f"non-causal {times[name, False]:.4f} ms; highest register "
              f"R{reg}; {spill}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
