"""The sharded LM steps on MoE and MLA archs, and the expert-parallel
route (``nn/moe_ep.py`` over a ``DeviceMesh``), on gloo ranks on the CPU
at ``reduced()`` sizes (``tools/torch_lm_shard_smoke.py``; the checks of
``test_torch_lm_sharded_steps.py``). MoE runs dropless. The EP route on a
2 x 2 mesh for both ``expert_axes``: the output within 1e-5 and the
gradients of ``out.sum()`` within 1e-4 of ``moe.moe_apply``, the
reference test's bounds (``tests/test_moe_ep.py``)."""
import pytest

from test_torch_lm_sharded_steps import STEPS, run_smoke


@pytest.mark.parametrize("arch,what,moe_impl", [
    ("deepseek-moe-16b", STEPS, None),       # the EP route in the step
    ("deepseek-moe-16b", "train", "gspmd"),  # routing gathered, plain count
    ("deepseek-v3-671b", "prefill,decode", None),   # MLA, latent cache
    ("jamba-1.5-large-398b", STEPS, None),   # mamba states + MoE
])
def test_sharded_moe_and_mla_steps_match_the_one_process_port(
        tmp_path, arch, what, moe_impl):
    argv = ["--arch", arch, "--model", "2", "--batch", "8", "--seq", "32",
            "--what", what]
    if moe_impl:
        argv += ["--moe-impl", moe_impl]
    s = run_smoke(tmp_path, 4, argv)
    if "decode" in what and arch == "deepseek-v3-671b":
        # the latent cache has no heads: its sequence takes "model"
        assert s["seq_sharded_cache_leaves"] > 0


@pytest.mark.parametrize("axes", ["model", "data_model"])
def test_the_expert_parallel_route_matches_moe_apply(tmp_path, axes):
    s = run_smoke(tmp_path, 4, ["--arch", "deepseek-moe-16b", "--model",
                                "2", "--batch", "4", "--seq", "16",
                                "--what", "ep", "--expert-axes", axes])
    assert s["ep_fwd_err"] < 1e-5 and s["ep_grad_err"] < 1e-4
    assert s["ep_drop_frac"] == 0.0
    assert s["ep_kernel_launches"] == 0
