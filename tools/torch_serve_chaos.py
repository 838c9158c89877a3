"""Serving chaos smoke on the PyTorch/CUDA port (the counterpart of
``tools/ci_serve_chaos.py``, on ``repro_torch.launch.policy_serve``).

    PYTHONPATH=src python3 tools/torch_serve_chaos.py [--device cpu]

Exercises the overload contract (``docs/ARCHITECTURE.md`` §8) end to end
through the port's ``policy_serve`` driver, in-process:

  1. replay a quick virtual-clock trace behind admission control with a
     deterministic chaos plan: a ``SlowDispatch`` stall plus a
     ``CorruptCheckpoint`` poisoning the one scheduled hot-reload attempt
     (``--reload-at``);
  2. require a clean drain (``final_state == "drained"``, every non-shed
     request served);
  3. require the corrupt reload to have been rejected (the policy version
     still 0, the reload log carrying the rejection) while the replay kept
     serving;
  4. require the driver's fault-application snapshot to match the plan's
     event counts (the driver itself runs ``assert_exhausted``);
  5. replay the identical command and require the identical snapshot: the
     chaos run is deterministic on the virtual clock.

Writes only under a temporary directory. The device defaults to ``cuda``
(the serving kernels) and raises without a card; ``--device cpu`` runs
their plain versions.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

PLAN = "slow:2:0.05,corrupt:0:nan"
PLAN_COUNTS = {"SlowDispatch": 1, "CorruptCheckpoint": 1}


def _serve(out_path: Path, device: str) -> dict:
    from repro_torch.launch import policy_serve
    return policy_serve.main([
        "--domain", "traffic", "--slot", "16", "--regions", "8",
        "--rps", "4000", "--duration-s", "0.1",
        "--virtual", "--service-time-s", "0.002",
        "--admission", "--queue-cap", "256",
        "--faults", PLAN, "--reload-at", "1",
        "--out", str(out_path), "--device", device])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="torch_serve_chaos_") as tmp:
        tmp = Path(tmp)
        print(f"serve-chaos: [1/3] chaos replay, plan: {PLAN}")
        res = _serve(tmp / "chaos.json", args.device)

        assert res["final_state"] == "drained", \
            f"server did not drain: {res['final_state']!r}"
        assert res["served"] + res["rejected"] == res["requests"], \
            "served + shed != offered: requests were lost silently"
        assert res["served"] > 0, "nothing served"

        print("serve-chaos: [2/3] corrupt reload must have been rejected")
        assert res["reload_rejected"] == 1 and res["reloads"] == 0, \
            f"reload outcome wrong: {res['reload_rejected']=} " \
            f"{res['reloads']=}"
        assert res["policy_version"] == 0, \
            "corrupt weights swapped in: policy_version advanced"
        tag, reason = res["reload_log"][-1]
        assert tag == "rejected" and "canary" in reason, \
            f"unexpected reload log entry: {(tag, reason)!r}"
        assert res["faults_applied"] == PLAN_COUNTS, \
            f"fault snapshot {res['faults_applied']!r} != plan " \
            f"{PLAN_COUNTS!r}"

        print("serve-chaos: [3/3] identical rerun, expect identical "
              "snapshot (virtual clock)")
        res2 = _serve(tmp / "chaos2.json", args.device)
        assert res2 == res, "chaos replay is not deterministic"

        print(f"serve-chaos: OK — {res['served']} served, "
              f"{res['rejected']} shed ({res['rejected_by_reason']}), "
              f"corrupt reload rejected, plan exhausted, drained")
    return 0


if __name__ == "__main__":
    sys.exit(main())
