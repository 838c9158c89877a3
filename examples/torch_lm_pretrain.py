"""Train a small qwen3-family LM end to end with the port's production
driver: data pipeline -> gradient-accumulated train step -> AdamW ->
checkpoints (counterpart of ``examples/lm_pretrain.py``).

    PYTHONPATH=src python examples/torch_lm_pretrain.py [--steps 200] \
        [--device cpu]

Uses the reduced qwen3-4b config; on the card the same driver
(``python -m repro_torch.launch.train``) takes ``--arch qwen3-4b`` at full
width. The checkpoints and the history rows go under ``results/tmp/``
unless ``--ckpt-dir`` / ``--metrics-out`` say otherwise; a second run
with the same directory resumes from its latest checkpoint. The device
defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "results/tmp/torch_lm_pretrain_ckpt"))
    ap.add_argument("--metrics-out",
                    default=str(ROOT / "results/tmp/torch_lm_pretrain.json"))
    args = ap.parse_args(argv)
    Path(args.metrics_out).parent.mkdir(parents=True, exist_ok=True)
    return train.main(["--arch", "qwen3-4b", "--reduced", "--device",
                       args.device, "--steps", str(args.steps), "--batch",
                       "8", "--seq", "128", "--microbatches", "2",
                       "--ckpt-dir", args.ckpt_dir, "--log-every", "20",
                       "--metrics-out", args.metrics_out])


if __name__ == "__main__":
    main()
