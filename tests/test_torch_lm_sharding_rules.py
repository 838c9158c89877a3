"""The port's LM sharding rules (the LM half of
``repro_torch/distributed/sharding.py``, ``act_sharding.py`` and
``launch/specs.py``) against the reference's, called on the same
duck-typed meshes: the pods' layouts (16 x 16, 2 x 16 x 16) and small
ones, both ``parallelism`` profiles and both ``moe_expert_axes``. The
port's parameter trees come from ``lm.param_shapes`` (meta), the
reference's from its own ``lm.param_shapes``; a port spec is
``tuple(P(...))`` of the reference's, leaf by leaf in tree order. The
reference's ``constrain`` and ``specs`` build ``NamedSharding``s that need
real devices: the test replaces ``NamedSharding`` / ``lax`` / ``_sds`` in
those modules' namespaces (monkeypatch) to read the specs they build."""
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget
from repro.distributed import act_sharding as ref_act
from repro.distributed import sharding as ref_shd
from repro.launch import specs as ref_specs
from repro.models import lm as jlm
from repro.optim.adamw import adamw as jadamw
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.distributed import act_sharding as act
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models import lm
from repro_torch.optim.adamw import adamw

ARCHS = list_configs()
POD1 = (("data", "model"), (16, 16))
POD2 = (("pod", "data", "model"), (2, 16, 16))
SMALL = (("data", "model"), (2, 2))


class _JaxLikeMesh:
    """What the reference's rules read of a ``Mesh``."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _ref_leaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_leaves(specs, like):
    out = []
    shd._map_with_keys(lambda keys, _: out.append(shd._lookup(specs, keys)),
                       like)
    return out


def _shapes(tree):
    return _port_leaves(shd._map_with_keys(lambda k, l: tuple(l.shape),
                                           tree), tree)


@pytest.fixture(autouse=True)
def _expert_axes():
    yield
    shd.set_moe_expert_axes("model")
    ref_shd.set_moe_expert_axes("model")


def test_the_rule_table_is_the_references():
    assert shd._RULES == ref_shd._RULES
    assert shd._AXIS_FOR_ROLE == ref_shd._AXIS_FOR_ROLE
    assert shd._AXIS_FOR_ROLE_FSDP_ONLY == ref_shd._AXIS_FOR_ROLE_FSDP_ONLY


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_the_reference(arch):
    jp_shapes = jlm.param_shapes(jget(arch))
    tp_shapes = lm.param_shapes(get_config(arch))
    jo_shapes = jax.eval_shape(jadamw(1e-4).init, jp_shapes)
    to_shapes = adamw(1e-4).init(tp_shapes)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp_shapes)] \
        == _shapes(tp_shapes)
    for names, sizes in (POD1, POD2, SMALL):
        jm, tm = _JaxLikeMesh(names, sizes), MeshLayout(names, sizes)
        for profile in ("tp", "fsdp_only"):
            for axes in ("model", "data_model"):
                ref_shd.set_moe_expert_axes(axes)
                shd.set_moe_expert_axes(axes)
                jps = ref_shd.param_specs(jp_shapes, jm, profile)
                tps = shd.param_specs(tp_shapes, tm, profile)
                assert _port_leaves(tps, tp_shapes) == _ref_leaves(jps), \
                    (names, profile, axes)
                jos = ref_shd.opt_state_specs(jo_shapes, jm, jps)
                tos = shd.opt_state_specs(to_shapes, tm, tps)
                assert tos.step == tuple(jos.step)
                for part in ("mu", "nu"):
                    assert _port_leaves(getattr(tos, part), tp_shapes) == \
                        _ref_leaves(getattr(jos, part)), (names, profile)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch):
    jc, tc = jget(arch), get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        jcache = jax.eval_shape(lambda: jlm.init_cache(jc, B, S))
        tcache = lm.init_cache(tc, B, S, device="meta")
        assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jcache)] \
            == _shapes(tcache)
        for names, sizes in (POD1, POD2, SMALL):
            jm, tm = _JaxLikeMesh(names, sizes), MeshLayout(names, sizes)
            got = _port_leaves(shd.cache_specs(tcache, tm, B), tcache)
            assert got == _ref_leaves(ref_shd.cache_specs(jcache, jm, B)), \
                (shape, names)


def test_batch_spec_and_dp_axes_match_the_reference():
    for names, sizes in (POD1, POD2, SMALL, (("data",), (4,))):
        jm, tm = _JaxLikeMesh(names, sizes), MeshLayout(names, sizes)
        for profile in ("tp", "fsdp_only"):
            assert shd.dp_axes(tm, profile) == \
                ref_shd.dp_axes(jm, profile)
            for B in (1, 3, 16, 32, 128, 256, 512):
                for extra in (0, 1, 2):
                    assert shd.batch_spec(tm, B, extra, profile) == tuple(
                        ref_shd.batch_spec(jm, B, extra, profile))


ROLES = [("dp", None, None), ("dp", None, "tp"), (None, "dp", None),
         ("tp", None, None), ("dp", None), ("fsdp", "tp"),
         ("dp", None, "tp", None), ("dp", "tp")]
SHAPES_3 = [(256, 4096, 2560), (32, 1500, 512), (8, 512, 151936),
            (64, 7, 48), (1, 16, 8)]


def test_constrain_specs_match_the_reference(monkeypatch):
    """The spec ``constrain`` puts on an activation, for the roles of the
    reference's call sites and shapes that do and do not divide."""
    seen = []
    monkeypatch.setattr(ref_act, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_act, "lax", SimpleNamespace(
        with_sharding_constraint=lambda x, s: seen.append(tuple(s))))
    for names, sizes in (POD1, POD2, SMALL):
        for profile in ("tp", "fsdp_only"):
            with act.use_mesh(MeshLayout(names, sizes), profile):
                ref_act.set_mesh(_JaxLikeMesh(names, sizes), profile)
                for roles in ROLES:
                    for shape in SHAPES_3:
                        shape = (shape + (64,))[:len(roles)]
                        seen.clear()
                        ref_act.constrain(SimpleNamespace(shape=shape),
                                          *roles)
                        assert act.constrain_spec(shape, *roles) == \
                            seen[0], (names, profile, roles, shape)
    ref_act.set_mesh(None)


def test_without_a_mesh_constrain_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert act.current_mesh() is None
    assert act.constrain(x, "dp", None, "tp") is x
    assert act.gather_weights({"w": x})["w"] is x
    with act.use_mesh(MeshLayout(("data", "model"), (2, 2)), "fsdp_only"):
        assert act.current_mesh().shape == (2, 2)
        # a plain tensor under a mesh: checked, the rule must leave it whole
        assert act.constrain(x, None, "tp", None) is x   # fsdp_only: no tp
        with pytest.raises(ValueError, match="plain tensor"):
            act.constrain(x, "dp", None, None)           # B over data
    with act.use_mesh(MeshLayout(("data", "model"), (2, 2))):
        with pytest.raises(ValueError, match="plain tensor"):
            act.constrain(x, None, None, "tp")
    assert act.current_mesh() is None


def test_to_placements_puts_the_major_axis_first():
    from torch.distributed.tensor import Replicate, Shard
    m = MeshLayout(("pod", "data", "model"), (2, 4, 4))
    assert shd.to_placements((None, ("data", "model")), m) == \
        (Replicate(), Shard(1), Shard(1))
    assert shd.to_placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.to_placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        shd.to_placements((("model", "data"),), m)


def _ref_input_specs(monkeypatch):
    monkeypatch.setattr(ref_specs, "_sds",
                        lambda shape, dtype, mesh=None, spec=None:
                        (tuple(shape), jax.numpy.dtype(dtype).name,
                         spec if spec is None else tuple(spec)))


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-base",
                                  "llama-3.2-vision-11b", "xlstm-1.3b",
                                  "deepseek-v3-671b"])
def test_input_specs_match_the_reference(arch, monkeypatch):
    _ref_input_specs(monkeypatch)
    jc, tc = jget(arch), get_config(arch)
    for names, sizes in (POD1, POD2):
        jm, tm = _JaxLikeMesh(names, sizes), MeshLayout(names, sizes)
        for name in ("train_4k", "prefill_32k"):
            fn = ("train_input_specs" if name == "train_4k"
                  else "prefill_input_specs")
            ref = getattr(ref_specs, fn)(jc, JSHAPES[name], jm)
            got = getattr(specs, fn)(tc, SHAPES[name], tm)
            assert sorted(ref) == sorted(got.tensors)
            for k, (shape, dtype, spec) in ref.items():
                t = got.tensors[k]
                assert t.device.type == "meta"
                assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) \
                    == (shape, dtype)
                assert got.specs[k] == spec, (k, names)
        dec = SHAPES["decode_32k"]
        ref = ref_specs.decode_input_specs(jc, JSHAPES["decode_32k"], jm)
        got = specs.decode_input_specs(tc, dec, tm)
        assert got.specs["token"] == ref["token"][2]
        assert tuple(got.tensors["pos"].shape) == tuple(ref["pos"].shape)
        ref_cache = jax.tree_util.tree_leaves(
            ref["cache"], is_leaf=lambda x: isinstance(x, tuple)
            and len(x) == 3 and isinstance(x[1], str))
        got_cache = _port_leaves(got.specs["cache"], got.tensors["cache"])
        assert [r[2] for r in ref_cache] == got_cache
        assert [r[0] for r in ref_cache] == _shapes(got.tensors["cache"])


def test_inputs_without_a_mesh_carry_no_specs():
    cfg = get_config("whisper-base")
    got = specs.train_input_specs(cfg, SHAPES["train_4k"])
    assert got.specs is None and set(got.tensors) == {"tokens", "labels",
                                                      "frames"}
    assert specs.prefill_input_specs(cfg, SHAPES["prefill_32k"]).specs \
        is None
