"""The LM half of the dry-run (``launch/dryrun.py::run_cell``): a cell
counted on rank 0 of the pods' layouts in a fake process group, on fake
tensors. whisper-base's two cells (the reference's own yardstick,
``tests/test_sharding.py::test_multi_device_dryrun_cell``) are ``ok`` with
collective bytes above 0; the model FLOPs are the reference's 6 N D /
2 N D with N from the reference's ``count_params``; a cell's argument
bytes are rank 0's local blocks, the global bytes over the ranks that
shard each leaf."""
import pytest

import test_torch_common  # noqa: F401  (one torch thread)

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget
from repro.models import lm as jlm
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models import lm


def _ok(cell):
    assert cell["status"] == "ok", cell
    ops = cell["ops"]
    assert ops["collective_bytes_total"] > 0
    assert ops["flops_dot"] > 0 and ops["hbm_bytes"] > 0
    assert ops["custom_call_count"] == 0        # no kernel on this path
    r = cell["roofline"]
    assert r["model_flops_total"] > 0 and r["step_time_lower_bound_s"] > 0
    assert 0 < r["model_flops_bound_s"] < r["step_time_lower_bound_s"]
    assert cell["memory"]["peak_bytes_per_device"] is None
    assert "fake" in cell["memory"]["peak_not_measured"]


def test_whisper_train_cell_counts_with_collectives():
    cell = dryrun.run_cell("whisper-base", "train_4k", "pod1")
    _ok(cell)
    assert cell["n_chips"] == 256 and cell["n_microbatches"] == 8
    # the batch's gather, the FSDP gathers and the gradients' reductions
    assert {"all-gather", "all-reduce"} <= set(
        cell["ops"]["collective_bytes"])


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "train_4k"),
                                        ("deepseek-moe-16b", "train_4k"),
                                        ("whisper-base", "decode_32k"),
                                        ("xlstm-1.3b", "long_500k")])
def test_model_flops_are_the_references(arch, shape):
    counts = jlm.count_params(jget(arch))
    js = JSHAPES[shape]
    tokens = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
    want = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[js.kind] * (
        counts["active"] - counts["embed"]) * tokens
    got = dryrun.lm_model_flops(get_config(arch), SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12)


def _local_bytes(meta, spec_tree, layout):
    sizes = dict(zip(layout.axis_names, layout.shape))
    total = []

    def one(keys, leaf):
        spec = shd._lookup(spec_tree, keys)
        n = 1
        for entry in spec:
            n *= shd._block_index(entry, sizes, {a: 0 for a in sizes})[1]
        total.append(leaf.numel() * leaf.element_size() // n)
    shd._map_with_keys(one, meta)
    return sum(total)


def test_whisper_decode_cell_holds_rank0s_blocks():
    cell = dryrun.run_cell("whisper-base", "decode_32k", "pod2")
    _ok(cell)
    assert cell["n_chips"] == 512
    cfg = get_config("whisper-base")
    layout = MeshLayout(("pod", "data", "model"), (2, 16, 16))
    params = lm.param_shapes(cfg)
    inp = specs.decode_input_specs(cfg, SHAPES["decode_32k"], layout)
    want = (_local_bytes(params, shd.param_specs(params, layout,
                                                 cfg.parallelism), layout)
            + _local_bytes(inp.tensors["cache"], inp.specs["cache"], layout)
            + _local_bytes({"t": inp.tensors["token"]},
                           {"t": inp.specs["token"]}, layout))
    mem = cell["memory"]
    assert mem["argument_bytes_per_device"] == want
    assert mem["argument_bytes_per_device"] >= \
        mem["argument_bytes_global_over_chips"]
    # decode writes the cache in place: the returned cache is its input
    assert mem["alias_bytes_per_device"] > 0
