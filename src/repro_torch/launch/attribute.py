"""Where a dry-run cell's roofline goes (counterpart of
``repro/launch/attribute.py``):

    PYTHONPATH=src python -m repro_torch.launch.attribute --arch X \
        --shape Y [--mesh pod1] [--overrides JSON] [--top 15] \
        [--what mem|coll|flops]

Counts the cell as ``launch/dryrun.py::run_cell`` does (rank 0 of the
pods' layout in a fake process group, fake tensors) with the counter
keeping every op's HBM bytes, FLOPs and collective bytes by (op, operand
shapes), then ranks them grouped by op kind and the first operand's shape:
by HBM bytes (``mem``), collective bytes (``coll``) or FLOPs (``flops``),
and prints the top rows with their shares of the total. The reference
ranks the lowered HLO's ops; eager PyTorch has no program text, so the
rank's aten ops and functional collectives are the profile (an unfused
program's traffic: ``distributed/op_analysis.py``).
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

WHAT = {"mem": 2, "flops": 3, "coll": 4}   # column of a counter row


def attribute(arch, shape_name, mesh_name="pod1", overrides=None, top=15,
              what="mem"):
    """-> the ranked rows [(value, op, shape, share)], printed."""
    from repro_torch.launch.dryrun import run_cell
    if what not in WHAT:
        raise ValueError(f"--what {what!r}: one of {sorted(WHAT)}")
    cell, rows = run_cell(arch, shape_name, mesh_name, overrides,
                          record=True)
    if cell.get("status") != "ok":
        print(f"{arch} {shape_name} {mesh_name}: {cell.get('status')}")
        return []
    col = WHAT[what]
    agg = defaultdict(float)
    for row in rows:
        if row[col]:
            shape = row[1][0] if row[1] else ()
            agg[(row[0], shape)] += row[col]
    total = sum(agg.values())
    unit = 1e9
    print(f"total {what}: {total / unit:.2f} G ({arch} {shape_name} "
          f"{mesh_name} overrides={overrides})")
    ranked = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    out = []
    for (op, shape), val in ranked:
        share = val / total if total else 0.0
        print(f"  {val / unit:10.2f} G  {share * 100:5.1f}%  {op:28s} "
              f"{list(shape)}")
        out.append((val, op, shape, share))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--overrides", default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--what", default="mem", choices=sorted(WHAT))
    args = ap.parse_args(argv)
    attribute(args.arch, args.shape, args.mesh,
              json.loads(args.overrides) if args.overrides else None,
              args.top, args.what)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
