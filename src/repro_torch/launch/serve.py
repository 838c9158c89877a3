"""Batched LM serving driver: prefill + decode with a KV/state cache
(counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --prompt-len 128 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-moe-16b --reduced --batch 4 --prompt-len 24 --gen 32

Static-batch serving: one prefill fills the cache, then greedy
(``--temperature 0``) or temperature decode steps. Weights are random
from ``--seed``; the prompt and the sampling noise come from
``repro_torch.stream`` generators. It runs eagerly under
``torch.inference_mode()`` (no CUDA graphs, no compilation), and every
clock reads after ``torch.cuda.synchronize()``. Prints one JSON line of
stats: arch, batch, prefill seconds, decode tokens/s, generated shape.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device, stream
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm

# stream tags (repro_torch.stream): weights, prompt, sampling noise
TAG_PARAMS, TAG_PROMPT, TAG_SAMPLE = 0, 1, 2


def make_inputs(cfg, prompt: torch.Tensor) -> dict:
    """The prompt plus the stubbed modality inputs (zeros), as the
    reference's driver builds them."""
    B, dev = prompt.shape[0], prompt.device
    inputs = {"tokens": prompt}
    if cfg.family == "vlm":
        inputs["vision"] = torch.zeros(
            (B, cfg.n_vision_tokens, cfg.d_model), dtype=cfg.dtype(),
            device=dev)
    if cfg.family == "encdec":
        inputs["frames"] = torch.zeros(
            (B, cfg.n_audio_frames, cfg.d_model), dtype=cfg.dtype(),
            device=dev)
    return inputs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    max_len = args.prompt_len + args.gen

    with torch.inference_mode():
        params = lm.init_params(cfg, stream(dev, args.seed, TAG_PARAMS))
        prompt = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=stream(dev, args.seed, TAG_PROMPT),
                               device=dev)
        inputs = make_inputs(cfg, prompt)
        prefill = steps_lib.make_prefill_step(cfg, max_len)
        serve = steps_lib.make_serve_step(cfg)

        def sample(i, lg):
            if args.temperature <= 0:
                return torch.argmax(lg, -1)
            # categorical draw as Gumbel-argmax, noise from step i's stream
            u = torch.rand(lg.shape, generator=stream(dev, args.seed,
                                                      TAG_SAMPLE, i),
                           device=dev).clamp_(min=torch.finfo(
                               torch.float32).tiny)
            return torch.argmax(lg.float() / args.temperature
                                - torch.log(-torch.log(u)), -1)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, inputs)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = sample(0, logits)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen):
            logits, cache = serve(params, cache, tok, args.prompt_len + i)
            tok = sample(i + 1, logits)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    gen = torch.stack(out, 1)
    stats = {
        "arch": cfg.name, "batch": args.batch,
        "prefill_s": round(t_prefill, 3),
        "decode_tokens_per_s": round(args.batch * args.gen
                                     / max(t_decode, 1e-9), 1),
        "generated_shape": list(gen.shape),
    }
    print(json.dumps(stats))
    return gen, stats


if __name__ == "__main__":
    main()
