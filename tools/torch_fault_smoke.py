"""Kill-and-resume smoke of the port's ``rl_train`` (the counterpart of
``tools/ci_fault_smoke.py``, at its sizes), with a real SIGTERM against a
real process:

  1. run a short uninterrupted ``repro_torch.launch.rl_train --ckpt-dir``
     to the end (the same-seed oracle);
  2. beside it, start the same command on a fresh checkpoint directory,
     SIGTERM it once its first iteration row streams past, and require a
     clean exit (code 0) that printed the "checkpoint flushed" line;
  3. run that command again: it must resume from the flushed checkpoint
     and end with ``final_params_md5`` and the final GS evaluation equal
     to run 1's, bitwise.

    python3 tools/torch_fault_smoke.py [--device cuda|cpu]

The runs write only under a temporary directory. The last line of
standard output is a JSON summary (both digests, both evaluations, the
iteration run 3 resumed from, the seconds each run took, runs 1 and 2
side by side).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# small enough for a CPU, large enough that the kill lands mid-run: the
# SIGTERM follows the first iteration row, and the guard flushes at the
# next iteration boundary (--save-every 1)
BASE_ARGS = [
    "--domain", "traffic", "--simulator", "ials", "--iterations", "4",
    "--eval-every", "100", "--n-envs", "8", "--rollout-len", "8",
    "--episode-len", "16", "--collect-episodes", "2", "--aip-epochs", "1",
    "--seed", "4", "--save-every", "1",
]
TIMEOUT_S = 600


def _cmd(device: str, ckpt_dir: Path, out: Path) -> list:
    return [sys.executable, "-m", "repro_torch.launch.rl_train", *BASE_ARGS,
            "--device", device, "--ckpt-dir", str(ckpt_dir),
            "--out", str(out)]


def _env() -> dict:
    env = dict(os.environ)
    src = str(REPO / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _run_to_completion(cmd: list) -> float:
    t0 = time.perf_counter()
    subprocess.run(cmd, env=_env(), cwd=REPO, check=True,
                   timeout=TIMEOUT_S, stdout=subprocess.DEVNULL)
    return time.perf_counter() - t0


def _run_and_kill(cmd: list) -> float:
    """Start the run, SIGTERM it after its first iteration row, and
    require the clean preemption exit (flush + "exiting cleanly")."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, text=True, bufsize=1)
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if time.perf_counter() - t0 > TIMEOUT_S:
                raise TimeoutError("the killed run exceeded its time")
            if not sent and line.startswith("{") and '"iter"' in line:
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "\n".join(lines)
    assert sent, f"no iteration row ever streamed:\n{text}"
    assert rc == 0, f"the preempted run exited {rc}:\n{text}"
    assert any("checkpoint flushed, exiting cleanly" in ln
               for ln in lines), \
        f"SIGTERM did not produce the clean flush line:\n{text}"
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="torch_fault_smoke_") as tmp:
        tmp = Path(tmp)
        print("fault-smoke: [1/3] uninterrupted same-seed oracle run, "
              "beside [2/3] SIGTERM mid-run, expect a clean flush",
              flush=True)
        with ThreadPoolExecutor(1) as pool:
            oracle = pool.submit(_run_to_completion, _cmd(
                args.device, tmp / "ref_ckpt", tmp / "ref.json"))
            s2 = _run_and_kill(_cmd(args.device, tmp / "kill_ckpt",
                                    tmp / "kill.json"))
            s1 = oracle.result()
        ref = json.loads((tmp / "ref.json").read_text())
        assert not ref["preempted"]
        killed = json.loads((tmp / "kill.json").read_text())
        assert killed["preempted"], "the killed run recorded no preemption"

        print("fault-smoke: [3/3] the same command again, expect a resume",
              flush=True)
        s3 = _run_to_completion(_cmd(args.device, tmp / "kill_ckpt",
                                     tmp / "res.json"))
        res = json.loads((tmp / "res.json").read_text())
        assert res["resumed_from"] > 0, "the rerun restored no checkpoint"

        ref_eval = ref["history"][-1]["gs_eval_reward"]
        res_eval = res["history"][-1]["gs_eval_reward"]
        print(f"fault-smoke: oracle md5 {ref['final_params_md5']}  "
              f"resumed md5 {res['final_params_md5']}")
        print(f"fault-smoke: oracle eval {ref_eval}  resumed eval "
              f"{res_eval}")
        assert res["final_params_md5"] == ref["final_params_md5"], \
            "the resumed params differ from the uninterrupted run's"
        assert res_eval == ref_eval, "the final GS evaluation drifted"
        print("fault-smoke: BITWISE RESUME OK")
        print(json.dumps({
            "device": res["device"], "resumed_from": res["resumed_from"],
            "killed_after": len(killed["history"]),
            "oracle_md5": ref["final_params_md5"],
            "resumed_md5": res["final_params_md5"],
            "oracle_eval": ref_eval, "resumed_eval": res_eval,
            "seconds": [s1, s2, s3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
