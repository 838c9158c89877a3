"""The IALS dry-run on the H100 (``launch/dryrun.py``), the pods' layouts
(``launch/mesh.py``) and the bound of the kernel table, on the CPU:

- against the reference's ``run_ials_cell`` (one subprocess, one forced
  host device) on three small cells (B = 4, T = 8): ``params_total`` and
  ``model_flops_total`` equal; ``flops_dot`` equal but for the products
  named in ``EXTRA_DOTS``, which eager PyTorch runs and XLA's optimized
  HLO does not;
- every committed ``results/dryrun/ials_*.json``: the port's analytic
  model FLOPs, ``params_total`` and ``n_chips`` equal the reference
  cell's (read from the files; no JAX);
- the sweep on its own meshes: the eight rows whose lanes the reference
  replicates over "model" (25 or 36 agents do not divide it) carry
  ``ranks_refuse``, the four others not; on ``host`` none does; every
  cell ``ok``;
- on 2 gloo ranks: each rank's count of the real sharded ``ppo.rollout``
  equals the dry-run's count of its block plus its gathers;
- the CLI writes a cell with the reference's keys (``ops`` for ``hlo``,
  ``count_s`` for the compile times), refuses the LM flags, and without
  CUDA refuses its default device;
- ``chip_smoke.bound`` of PERF.md's kernel rows, now read through
  ``op_analysis`` and ``_ials_model_flops``, prints the table's digits;
- ``chip_smoke.hold_program`` (phase 4c's check of the card's run, here
  a second CPU run stands in for it): a program built twice takes the
  same inputs and passes; a reward off in one env's lanes away from any
  decision threshold fails, and so does a learner's weight off by 1e-3.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread)

from repro_torch.distributed import op_analysis, sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SMALL = [("policy_rollout", "traffic", "fnn", 1, 4, 8),
         ("aip_rollout_multi", "warehouse", "gru", 4, 4, 8),
         ("train_iteration", "traffic", "fnn", 1, 4, 8)]
HP, N_ACT, MB = 128, 2, 8          # traffic policy width, actions; the
#                                    learner's minibatch (32 samples / 4)
# the products the port's eager count has and XLA's optimized HLO lacks
EXTRA_DOTS = {
    # the bootstrap forward's pi head on the 4 lanes, 2*4*128*2: only v
    # is read, so XLA drops the head as dead code; eager runs it
    "policy_rollout": 2 * 4 * HP * N_ACT,
    "aip_rollout_multi": 0,
    # that head again, and in each of the 4 x 4 minibatch backwards the
    # input gradient through the width-1 v head, (8, 1) @ (1, 128):
    # autograd runs it as a product, XLA as a broadcast multiply
    "train_iteration": 2 * 4 * HP * N_ACT + 16 * 2 * MB * HP * 1,
}


@pytest.fixture(scope="module")
def reference_cells():
    """The reference's three small cells, one subprocess (~20 s)."""
    script = textwrap.dedent(f"""
        import json
        from repro.launch import dryrun
        out = {{}}
        for c in {SMALL!r}:
            r = dryrun.run_ials_cell(*c, "host")
            out["|".join(map(str, c))] = {{
                "flops_dot": r["hlo"]["flops_dot"],
                "model_flops_total": r["roofline"]["model_flops_total"],
                "params_total": r["params_total"], "n_chips": r["n_chips"]}}
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=1")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", SMALL, ids=[c[0] for c in SMALL])
def test_small_cells_against_the_reference(reference_cells, cell):
    ref = reference_cells["|".join(map(str, cell))]
    got = dryrun.count_ials_cell(*cell, "host")
    assert got["params_total"] == ref["params_total"]
    assert got["roofline"]["model_flops_total"] == ref["model_flops_total"]
    assert got["n_chips"] == ref["n_chips"] == 1
    assert got["ops"]["flops_dot"] - ref["flops_dot"] == EXTRA_DOTS[cell[0]]


REF_CELLS = sorted((ROOT / "results" / "dryrun").glob("ials_*.json"))


@pytest.mark.parametrize("path", REF_CELLS, ids=[p.stem for p in REF_CELLS])
def test_committed_reference_cells_have_the_ports_analytic_numbers(path):
    ref = json.loads(path.read_text())
    layout = dryrun._ials_mesh(ref["mesh"])
    prog = dryrun.ials_program(ref["program"], ref["domain"],
                               ref["backbone"], ref["n_agents"],
                               ref["batch"], ref["horizon"], layout, "cpu")
    assert prog.model_flops == ref["roofline"]["model_flops_total"]
    assert prog.n_params == ref["params_total"]
    assert sharding.mesh_size(layout) == ref["n_chips"]


def test_the_sweep_is_the_reference_committed_one():
    assert len(REF_CELLS) == len(dryrun.IALS_SWEEP) == 12
    names = {dryrun._ials_cell_filename(*row) for row in dryrun.IALS_SWEEP}
    assert names == {p.name for p in REF_CELLS}


REFUSED = {row for row in dryrun.IALS_SWEEP if row[3] > 1 and row[4] == 64}
SWEEP_IDS = ["-".join(map(str, r)) for r in dryrun.IALS_SWEEP]


@pytest.mark.parametrize("row", dryrun.IALS_SWEEP, ids=SWEEP_IDS)
@pytest.mark.parametrize("on", ["own mesh", "host"])
def test_the_sweep_counts_every_row_and_names_the_refused_layouts(row, on):
    """Counted at T = 2 (a layout's blocks follow B and A, not T): every
    cell ok; on its own mesh a refused row carries the refusal."""
    program, domain, backbone, A, B, _, mesh = row
    mesh = mesh if on == "own mesh" else "host"
    cell = dryrun.count_ials_cell(program, domain, backbone, A, B, 2, mesh)
    assert cell["status"] == "ok" and cell["counted_on"] == \
        "cpu, plain route"
    assert cell["n_chips"] == {"pod1": 256, "pod2": 512, "host": 1}[mesh]
    refused = on == "own mesh" and row in REFUSED
    assert ("ranks_refuse" in cell) == refused
    if refused:
        assert "does not divide over the" in cell["ranks_refuse"]
    gathers = cell["ops"]["collective_counts"].get("all-gather", 0)
    # a rank's rollout gathers its batch and its final frames (6 + 1
    # leaves), the engine's rollout nothing; one process gathers nothing
    assert gathers == (7 if mesh != "host" and program in (
        "policy_rollout", "train_iteration") else 0)
    assert cell["ops"]["flops_dot"] > 0 and cell["ops"]["n_ops"] > 0


def test_eight_sweep_rows_are_refused():
    assert len(REFUSED) == 8
    assert sum(r[6] == "pod1" for r in REFUSED) == 6


def test_the_production_layouts():
    """Without a process group, the pods' layouts; the rules read them as
    the reference's rules read its meshes."""
    pod1 = mesh_mod.make_production_mesh()
    pod2 = mesh_mod.make_production_mesh(multi_pod=True)
    assert pod1 == mesh_mod.MeshLayout(("data", "model"), (16, 16))
    assert pod2 == mesh_mod.MeshLayout(("pod", "data", "model"),
                                       (2, 16, 16))
    assert (pod1.size, pod2.size) == (256, 512)
    assert sharding.ials_lane_axes(512, 1, pod1) == (("data", "model"),
                                                     None)
    assert sharding.ials_lane_axes(64, 25, pod2) == (("pod", "data"), None)
    assert sharding.ials_lane_axes(64, 32, pod1) == (("data",), "model")
    rank = sharding.LayoutRank(pod2, rank=17)
    assert rank.get_coordinate() == [0, 1, 1]
    assert sharding.mesh_size(rank) == 512


RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.distributed as dist
    from repro_torch import stream
    from repro_torch.core import engine, influence
    from repro_torch.distributed import op_analysis
    from repro_torch.envs.traffic import (TrafficConfig,
                                          make_batched_local_traffic_env)
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.rl import ppo
    torch.set_num_threads(1)
    mesh_mod.init_ranks("gloo", "cpu", init_method=sys.argv[1])
    mesh = mesh_mod.make_host_mesh(1)
    B, T = 8, 8
    bls = make_batched_local_traffic_env(TrafficConfig(), "cpu")
    acfg = influence.AIPConfig(kind="fnn", d_in=bls.spec.dset_dim,
                               n_out=bls.spec.n_influence, hidden=64,
                               stack=8)
    pcfg = ppo.PPOConfig(obs_dim=bls.spec.obs_dim,
                         n_actions=bls.spec.n_actions, n_envs=B,
                         rollout_len=T, episode_len=T)
    gen = stream("cpu", 5, 0)
    env = engine.make_unified_ials(bls, influence.init_aip(acfg, gen),
                                   acfg, mesh=mesh)
    pol = ppo.init_policy(pcfg, gen)
    rs = ppo.init_rollout_state(env, pcfg, gen, mesh)
    streams = ppo.draw_rollout_streams(env, pcfg, gen, mesh)
    real = op_analysis.analyze(ppo.rollout, env, pcfg, pol, rs,
                               streams=streams, mesh=mesh)
    prog = dryrun.ials_program(
        "policy_rollout", "traffic", "fnn", 1, B, T,
        mesh_mod.MeshLayout(("data", "model"), (2, 1)), "cpu")
    counted = op_analysis.analyze(prog.fn, *prog.args)
    print(json.dumps({"rank": dist.get_rank(), "real": real,
                      "counted": counted}))
    dist.destroy_process_group()
""")


def test_a_ranks_count_of_the_sharded_rollout_is_the_dry_runs(tmp_path):
    """2 gloo ranks (data = 2), traffic FNN A = 1, B = 8, T = 8: each
    rank's count of the real sharded ``ppo.rollout`` (its collective a
    ``c10d`` op, not counted; its gather noted) equals the dry-run's count
    of rank 0's block plus its gathers: every aten-op number and the
    gather bytes alike."""
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=SRC)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT,
             f"file://{tmp_path / 'store'}"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        res = json.loads(out.strip().splitlines()[-1])
        real, counted = res["real"], res["counted"]
        assert real == counted, res["rank"]
        assert real["collective_counts"] == {"all-gather": 7}
        assert real["collective_bytes_total"] > 0
        assert real["n_ops"] > 100 and real["flops_dot"] > 0


def _cli_cell(tmp_path, *extra):
    dryrun.main(["--ials", "policy_rollout", "--device", "cpu", "--batch",
                 "4", "--horizon", "8", "--out", str(tmp_path), *extra])
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 1
    return files[0], json.loads(files[0].read_text())


def test_the_cli_writes_a_cell_with_the_reference_keys(tmp_path):
    path, cell = _cli_cell(tmp_path, "--mesh", "host")
    assert path.name == ("ials_policy_rollout__traffic_fnn_A1_B4_T8"
                         "__host.json")
    for key in ("arch", "shape", "mesh", "status", "family", "program",
                "domain", "backbone", "n_agents", "batch", "horizon",
                "n_chips", "params_total", "params_active", "memory",
                "roofline", "ops", "count_s", "counted_on"):
        assert key in cell, key
    for gone in ("hlo", "cost_analysis", "lower_s", "compile_s",
                 "ranks_refuse"):
        assert gone not in cell, gone
    assert cell["status"] == "ok" and cell["mesh"] == "host"
    for key in ("flops", "flops_dot", "flops_elementwise",
                "custom_call_count", "hbm_bytes", "collective_bytes",
                "collective_counts", "collective_bytes_total", "n_ops"):
        assert key in cell["ops"], key
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "step_time_lower_bound_s", "model_flops_total",
                "useful_flops_ratio", "mfu_upper_bound"):
        assert key in cell["roofline"], key
    mem = cell["memory"]
    assert mem["peak_bytes_per_device"] is None and mem["peak_not_measured"]
    assert mem["argument_bytes_per_device"] > 0
    assert mem["output_bytes_per_device"] > 0


def test_the_cli_refuses_the_lm_flags_and_a_missing_program(tmp_path,
                                                            capsys):
    """The LM flags run LM cells (tests/test_torch_lm_dryrun.py); misused
    they are refused: an arch without a shape, a shape alone, LM cells on
    the host mesh, and no program at all."""
    for argv in (["--ials", "policy_rollout", "--arch", "qwen3-4b"],
                 ["--all", "--mesh", "host"], ["--shape", "train_4k"], []):
        with pytest.raises(SystemExit):
            dryrun.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    err = capsys.readouterr().err
    assert "--arch and --shape go together" in err
    assert "LM cells run on --mesh pod1, pod2 or both" in err
    assert "is required" in err
    assert not list(tmp_path.glob("*.json"))


def test_without_cuda_the_default_device_refuses(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--ials", "policy_rollout", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_ials_cell(*SMALL[0], "host")
    assert not list(tmp_path.glob("*.json"))


# PERF.md section 6's bound column (ms, as printed), rows 2-4w at their
# shapes: (domain, AIP, A, B, policy, bound)
KERNEL_ROWS = {
    "2": ("traffic", "gru", 25, 16, False, "0.0309"),
    "2s": ("traffic", "gru", 1, 16, False, "0.00124"),
    "3": ("traffic", "fnn", 1, 16, False, "0.00152"),
    "4 fnn": ("traffic", "fnn", 1, 16, True, "0.00286"),
    "4 gru": ("traffic", "gru", 25, 16, True, "0.0646"),
    "2w": ("warehouse", "gru", 36, 16, False, "0.0389"),
    "3w": ("warehouse", "fnn", 36, 16, False, "0.0377"),
    "4w fnn": ("warehouse", "fnn", 36, 16, True, "0.1589"),
    "4w gru": ("warehouse", "gru", 36, 16, True, "0.1600"),
}


@pytest.mark.parametrize("row", sorted(KERNEL_ROWS))
def test_the_kernel_rows_bound_is_unchanged(row):
    """The operations bound of each row (all are bound by operations) from
    ``Case.flops_per_lane_tick`` (now ``_ials_model_flops`` of one lane
    and tick) and ``bound`` (now ``op_analysis``'s peaks), T = 128."""
    from types import SimpleNamespace
    from repro_torch.core import influence
    from repro_torch.rl import ppo
    domain, kind, A, B, policy, printed = KERNEL_ROWS[row]
    ls, stack = chip_smoke.local_env(domain, torch.device("cpu"))
    case = SimpleNamespace(
        acfg=influence.AIPConfig(kind=kind, d_in=ls.spec.dset_dim,
                                 n_out=ls.spec.n_influence, hidden=64,
                                 stack=8 if kind == "fnn" else 1),
        pcfg=ppo.PPOConfig(obs_dim=ls.spec.obs_dim,
                           n_actions=ls.spec.n_actions, frame_stack=stack))
    flops = chip_smoke.Case.flops_per_lane_tick(case, policy) * A * B * 128
    ms, by = chip_smoke.bound(flops, 0)
    decimals = len(printed.split(".")[1])
    assert by == "operations" and round(ms, decimals) == float(printed)


HOLD_CELLS = [("aip_rollout_multi", "warehouse", "gru", 4, 4, 8),
              ("fnn_rollout", "traffic", "fnn", 1, 8, 8),
              ("policy_rollout", "traffic", "fnn", 3, 4, 8),
              ("train_iteration", "warehouse", "gru", 1, 8, 8)]


@pytest.mark.parametrize("row", HOLD_CELLS, ids=[r[0] for r in HOLD_CELLS])
def test_phase_4c_holds_a_run_against_the_counted_plain_run(row):
    from repro_torch.tree import tree_leaves, tree_map
    program, _, _, A, B, T = row
    host, cpu = dryrun._ials_mesh("host"), torch.device("cpu")
    counted = dryrun.ials_program(*row, host, "cpu")
    with chip_smoke._RecordRollouts() as plain_rolls:
        cell, plain = dryrun.count_ials_program(counted, *row, "host")
    assert cell["status"] == "ok"
    again = dryrun.ials_program(*row, host, "cpu")
    for a, b in zip(tree_leaves(counted.args), tree_leaves(again.args)):
        assert torch.equal(a, b)
    with chip_smoke._RecordRollouts() as rolls:
        out = again.fn(*again.args)

    def hold(out, rolls):
        return chip_smoke.hold_program("x", program, counted, plain,
                                       plain_rolls, out, rolls, T, B, A,
                                       cpu)
    assert hold(out, rolls) == (0, 0.0, program == "train_iteration")
    bad, bad_rolls = tree_map(lambda l: l.clone(), (out, rolls))
    if program in ("aip_rollout_multi", "fnn_rollout"):
        bad[1][3, 1] += 1.0                     # rewards (T, B[, A])
    else:
        bad_rolls[-1][1]["r"][3, 1] += 1.0      # the rollout's batch
    with pytest.raises(AssertionError, match="away from any decision"):
        hold(bad, bad_rolls)
    if program == "train_iteration":
        bad = tree_map(lambda l: l.clone(), out)
        tree_leaves(bad[0])[0].add_(1e-3)       # a learner's weight
        with pytest.raises(AssertionError, match="learner"):
            hold(bad, rolls)
