"""The LM's sharded steps on DTensor (``launch/steps.py`` under
``act_sharding.use_mesh``, the rules of ``distributed/sharding.py``)
against the one-process port, on gloo ranks on the CPU at ``reduced()``
sizes, float32: ``tools/torch_lm_shard_smoke.py`` runs two train steps
(2 microbatches; the loss, metrics and every gradient against the
one-process step from the same state, the in-place AdamW update replayed
on each rank's blocks within 4 ulps, each rank's bytes the global bytes
over its shards), a prefill and one decode step (logits and every cache
leaf). Dense, enc-dec, VLM and xLSTM archs here; the MoE and MLA archs
and the expert-parallel route in ``test_torch_lm_sharded_moe.py``; the
recurrent mixers on "model" in ``test_torch_lm_mixer_tp*.py``.

xLSTM on its own "tp" profile, its mixers tensor-parallel on "model",
runs here in float64 (``tools/torch_lm_mixer_tp_check.py``'s copy of the
port with every float32 cast a float64 one), within the same bounds:
the check that the route's drift from one process is rounding (a single
float32 ulp at each mLSTM output in one process moves the reduced
xlstm's gradients 1.79x the bound, ``PERF.md`` §6); its float32 steps
on "model" are in ``test_torch_lm_mixer_tp_xlstm.py``. xLSTM in float32
also runs under ``fsdp_only``, where "model" is a batch axis and the
mixers run on each rank's batch block (``act_sharding.batch_local``)."""
import importlib.util
import json
from pathlib import Path

import pytest

from test_torch_sharding import spawn

SMOKE = "tools/torch_lm_shard_smoke.py"


def mixer_check():
    """``tools/torch_lm_mixer_tp_check.py`` as a module."""
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_lm_mixer_tp_check.py"
    spec = importlib.util.spec_from_file_location("mixer_tp_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_smoke(tmp_path, world, argv, float64=False):
    """The smoke on ``world`` ranks -> rank 0's summary (every rank must
    exit 0); ``tmp_path`` holds the ranks' store: one a run. ``float64``:
    the smoke of a float64 copy of the port (``mixer_check().as_float64``)
    under ``tmp_path``."""
    out = tmp_path / "summary.json"
    smoke = SMOKE
    if float64:
        mixer_check().as_float64(tmp_path / "f64")
        smoke = str(tmp_path / "f64" / SMOKE)
    res = spawn(world, [smoke, "--device", "cpu", "--reduced",
                        "--init-method", f"file://{tmp_path / 'store'}",
                        "--json", str(out), *argv])
    assert [rc for rc, _ in res] == [0] * world, \
        "\n".join(o[-3000:] for _, o in res)
    summary = json.loads(out.read_text())
    assert summary["ok"] and not summary["failed"], summary["failed"]
    return summary


STEPS = "train,prefill,decode"


@pytest.mark.parametrize("arch,world,model,profile", [
    ("qwen3-4b", 4, 2, None),            # fsdp_only: batch over data x model
    ("llama3-405b", 4, 2, None),         # tp: heads, FFN, vocab on model
    ("whisper-base", 2, 1, None),        # enc-dec, data parallel
    ("llama-3.2-vision-11b", 4, 2, None),  # gated cross-attention
    ("xlstm-1.3b", 4, 2, None),         # mLSTM / sLSTM on "model", float64
    ("xlstm-1.3b", 4, 2, "fsdp_only"),  # mLSTM / sLSTM on batch blocks
])
def test_sharded_steps_match_the_one_process_port(tmp_path, arch, world,
                                                  model, profile):
    argv = ["--arch", arch, "--model", str(model), "--batch", "8",
            "--seq", "32", "--what", STEPS]
    if profile:
        argv += ["--profile", profile]
    s = run_smoke(tmp_path, world, argv,
                  float64=arch == "xlstm-1.3b" and profile is None)
    assert s["mesh"] == {"data": world // model, "model": model}
    # two steps, each checked: loss, gradients, the update
    for k in (0, 1):
        for what in ("loss", "gradients", "update (ulps / 4)"):
            assert f"step {k} {what}" in s["worst_share"]
    assert len(s["loss"]) == 2
    for what in ("prefill logits", "prefill cache", "decode logits",
                 "decode cache"):
        assert what in s["worst_share"]
    # each rank holds the global bytes over the ranks that shard them
    for r in s["per_rank"]:
        assert r["param_bytes"] == r["param_bytes_expected"]
        assert r["moment_bytes"] == r["moment_bytes_expected"]
    if world > 1 and arch == "qwen3-4b":
        # fsdp_only shards the layers' weights over all four ranks
        assert s["param_bytes"] < s["param_bytes_expected"] * world


def test_the_cards_collective_route_gives_the_same_steps(tmp_path):
    """``launch/mesh.py::gloo_on_card`` (the ranks sharing one card over
    gloo: DTensor's all-gathers, reduce-scatters, all-to-alls and the
    port's all-reduces through the c10d collectives), forced on the
    CPU's tensors: the same checks hold, on the "tp" profile (vocab and
    heads on "model") and on the EP route."""
    (tmp_path / "tp").mkdir()
    (tmp_path / "ep").mkdir()
    s = run_smoke(tmp_path / "tp", 4, ["--arch", "llama3-405b", "--model",
                                       "2", "--batch", "8", "--seq", "32",
                                       "--what", STEPS, "--raw-collectives"])
    assert "decode logits" in s["worst_share"]
    s = run_smoke(tmp_path / "ep", 4, ["--arch", "deepseek-moe-16b",
                                       "--model", "2", "--batch", "4",
                                       "--seq", "16", "--what", "ep",
                                       "--raw-collectives"])
    assert s["ep_fwd_err"] < 1e-5 and s["ep_grad_err"] < 1e-4


ALLTOALL = r"""
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import gloo_on_card, init_ranks, make_host_mesh
init_ranks("gloo", "cpu", init_method=sys.argv[1])
calls = {"all_to_all_single": 0}
a2a = dist.all_to_all_single
def counted(*a, **k):
    calls["all_to_all_single"] += 1
    return a2a(*a, **k)
dist.all_to_all_single = counted
gloo_on_card(force=True)
mesh = make_host_mesh(2, device_type="cpu")
g = torch.Generator().manual_seed(0)
for shape, src, dst in (((8, 6, 4), 0, 1), ((7, 5, 3), 0, 2),
                        ((6, 9), 1, 0), ((5, 3, 2), 2, 0)):
    x = torch.randn(shape, generator=g)
    d = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                           run_check=False)
    d = d.redistribute(mesh, [Shard(src), Shard(src)])
    d = d.redistribute(mesh, [Shard(dst), Shard(src)])
    d = d.redistribute(mesh, [Shard(dst), Shard(dst)])
    assert torch.equal(d.full_tensor(), x), (shape, src, dst)
assert calls["all_to_all_single"] >= 8, calls
# the microbatch split: the batch's row blocks to the microbatches' blocks
from repro_torch.distributed.act_sharding import use_mesh
from repro_torch.launch.steps import _microbatches
for profile, pl, D in (("fsdp_only", [Shard(0), Shard(0)], 4),
                       ("tp", [Shard(0), Replicate()], 2)):
    for B, n in ((8, 2), (16, 2), (16, 4), (8, 4), (32, 8), (24, 3)):
        x = torch.randn((B, 3, 2), generator=g)
        d = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                               run_check=False).redistribute(mesh, pl)
        before = calls["all_to_all_single"]
        with use_mesh(mesh, profile):
            m = _microbatches(d, n)
        assert torch.equal(m.full_tensor(), x.reshape(n, B // n, 3, 2)), \
            (profile, B, n)
        routed = calls["all_to_all_single"] > before
        assert routed == ((B // n) % D == 0), (profile, B, n, routed)
dist.destroy_process_group()
print("ok", calls)
"""


def test_the_cards_all_to_all_moves_each_block_once(tmp_path):
    """``gloo_on_card``'s ``Shard(a)`` -> ``Shard(b)`` is one
    ``all_to_all_single`` on the mesh dim's group (not a gather of the
    whole tensor): even and uneven splits, on both dims of a 2 x 2 mesh,
    give back the global tensor bitwise. So does the microbatch split
    (``launch/steps.py::_microbatches``) of a batch sharded over one and
    over both mesh dims, in all-to-alls wherever the rule shards a
    microbatch's rows over the batch's axes (B / n divisible by them),
    else after a gather."""
    res = spawn(4, ["-c", ALLTOALL, f"file://{tmp_path / 'store'}"])
    assert [rc for rc, _ in res] == [0] * 4, \
        "\n".join(o[-3000:] for _, o in res)


def test_the_mixer_check_makes_every_float32_cast_a_float64_one(tmp_path):
    """``tools/torch_lm_mixer_tp_check.py --float64`` runs a copy of the
    port and the smoke in which no float32 cast is left (``--parity``'s
    also a copy of the reference)."""
    mod = mixer_check()
    src = mod.as_float64(tmp_path, reference=True)
    files = list((src / "repro_torch").rglob("*.py")) + [
        tmp_path / "tools" / mod.SMOKE]
    assert len(files) > 50
    text = "".join(f.read_text() for f in files)
    assert "torch.float32" not in text and ".float()" not in text
    assert "np.float32" not in text
    assert "torch.float64" in text and ".double()" in text
    ref = "".join(f.read_text() for f in (src / "repro").rglob("*.py"))
    assert "np.float32" not in ref and "jnp.float64" in ref
