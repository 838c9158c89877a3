"""Batched LM serving demo on the PyTorch/CUDA port: prefill once, decode
with a KV cache (counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Runs the reduced deepseek-moe config (MoE with capacity drops in the
prefill, dropless decode) through ``launch/steps.py``'s prefill step and
serve step, the functions ``python -m repro_torch.launch.serve`` drives.
The device defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device, stream  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("deepseek-moe-16b"))
    B, T_prompt, T_gen, MAX = 4, 24, 16, 48
    with torch.inference_mode():
        params = lm.init_params(cfg, stream(dev, 0, 0))
        prompt = torch.randint(0, cfg.vocab_size, (B, T_prompt),
                               generator=stream(dev, 0, 1), device=dev)
        prefill = steps_lib.make_prefill_step(cfg, MAX)
        serve = steps_lib.make_serve_step(cfg)

        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits, -1)
        outs = [tok]
        for i in range(T_gen):
            logits, cache = serve(params, cache, tok, T_prompt + i)
            tok = torch.argmax(logits, -1)
            outs.append(tok)
        gen = torch.stack(outs, 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    print(f"prompt {tuple(prompt.shape)} -> generated {tuple(gen.shape)} "
          f"in {dt:.2f}s on {dev}")
    print("generated token ids (batch 0):", [int(x) for x in gen[0]])
    return gen


if __name__ == "__main__":
    main()
