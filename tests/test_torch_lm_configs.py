"""The port's LM configs (``repro_torch/configs``) against the JAX
package's: every registered config and its ``reduced()`` field by field,
layer plans, shape cells and ``cell_applicable``; and ``lm.count_params``
of every full config equal to the reference's, counted on the meta device
(nothing allocated). Exact equality throughout: these are pure Python."""
import dataclasses

import pytest

import test_torch_common  # noqa: F401  (one torch thread)

import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = jbase.list_configs()


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_the_registries_hold_the_same_ten_archs():
    assert tbase.list_configs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_config_equals_the_reference_field_by_field(arch, cut):
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    if cut == "reduced":
        j, t = jbase.reduced(j), tbase.reduced(t)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    assert t.hd() == j.hd()
    assert str(t.dtype()).split(".")[-1] == j.dtype().__name__
    jp, tp = j.layer_plan(), t.layer_plan()
    assert [dataclasses.astuple(s) for s in tp[0]] == \
        [dataclasses.astuple(s) for s in jp[0]]
    assert [dataclasses.astuple(s) for s in tp[1]] == \
        [dataclasses.astuple(s) for s in jp[1]]
    assert tp[2] == jp[2]
    pro, pattern, n_groups = tp
    assert len(pro) + len(pattern) * n_groups == t.n_layers, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_with_overrides_and_dtypes(arch):
    t = tbase.get_config(arch)
    assert t.with_overrides(param_dtype="float32").dtype() == torch.float32
    assert t.with_overrides(param_dtype="bfloat16").dtype() == \
        torch.bfloat16
    assert t.with_overrides(capacity_factor=2.0) == \
        dataclasses.replace(t, capacity_factor=2.0)


def test_shape_cells_and_their_applicability():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        for name in jbase.SHAPES:
            assert tbase.cell_applicable(tbase.get_config(arch),
                                         tbase.SHAPES[name]) == \
                jbase.cell_applicable(jbase.get_config(arch),
                                      jbase.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    want = jlm.count_params(jbase.get_config(arch))
    got = tlm.count_params(tbase.get_config(arch))
    assert got == want


def test_count_params_allocates_nothing():
    """The full deepseek-v3 (671 B parameters) is counted on the meta
    device: every leaf of ``param_shapes`` is a meta tensor."""
    cfg = tbase.get_config("deepseek-v3-671b")
    shapes = tlm.param_shapes(cfg)
    leaves = tree_leaves(shapes)
    assert leaves and all(x.device.type == "meta" for x in leaves)
    c = tlm.count_params(cfg)
    assert 6.5e11 < c["total"] < 7.0e11
    assert 3.4e10 < c["active"] < 4.0e10
