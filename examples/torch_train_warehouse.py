"""Paper Fig. 5 experiment on the PyTorch/CUDA port: warehouse
commissioning, GS vs IALS variants (the counterpart of ``examples/
train_warehouse.py``), the F-IALS (empirical marginal, App. E) included.

    PYTHONPATH=src python examples/torch_train_warehouse.py [--iterations N]
        [--device cpu] [rl_train flags, e.g. --n-envs 4]

Thin wrapper over ``repro_torch.launch.rl_train``; writes learning-curve
JSONs to ``results/``. Flags it does not know pass through to
``rl_train``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import rl_train  # noqa: E402

SIMULATORS = ("ials", "untrained-ials", "f-ials", "gs")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    for sim in SIMULATORS:
        print(f"\n=== simulator: {sim} ===")
        rl_train.main(["--domain", "warehouse", "--simulator", sim,
                       "--iterations", str(args.iterations),
                       "--device", args.device,
                       "--out", f"results/torch_warehouse_{sim}.json"] + rest)


if __name__ == "__main__":
    main()
