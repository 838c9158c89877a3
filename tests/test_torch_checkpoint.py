"""The port's checkpoints (``repro_torch/checkpoint``) against the JAX
package's ``repro.checkpoint.ckpt`` on the CPU: the msgpack codec is
byte-equal to ``msgpack.packb`` on checkpoint metadata, leaf paths print
as ``jax.tree_util.keystr``, a checkpoint written by either package is
restored by the other bitwise (whole or ``['policy']`` subtree), and the
COMMITTED contract holds for every torn layout ``torn_save`` builds."""
import collections

import msgpack
import numpy as np
import pytest

from test_torch_common import to_np, to_t

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.distributed import fault_injection as jfi  # noqa: E402
from repro.rl import ppo as jppo  # noqa: E402
from repro_torch.checkpoint import ckpt, mpack  # noqa: E402
from repro_torch.distributed import fault_injection as tfi  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa

NT = collections.namedtuple("NT", "a b")

METAS = [
    {"step": 3, "n_leaves": 0, "paths": [], "dtypes": [], "shapes": [],
     "user": {}},
    {"step": 123456789, "n_leaves": 2, "paths": ["['a']", "['b'][0]"],
     "dtypes": ["float32", "uint32"], "shapes": [[], [4, 5]],
     "user": {"it": 11, "mode": "integrated", "lr": 3e-4, "ok": True,
              "none": None, "neg": [-1, -31, -32, -33, -128, -129, -32768,
                                   -32769, -2 ** 31, -2 ** 31 - 1,
                                   -2 ** 63]}},
    {"step": 0, "n_leaves": 40, "paths": [f"['p'][{i}]" for i in range(40)],
     "dtypes": ["float32"] * 40, "shapes": [[i, 2 ** 20] for i in range(40)],
     "user": {"big": [127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                      2 ** 32, 2 ** 64 - 1], "s" * 40: "x" * 300,
              "long": "y" * 70000, "f": [0.0, -1.5, 1e300, float("inf")],
              "m": {str(i): i for i in range(20)}}},
]


@pytest.mark.parametrize("i", range(len(METAS)))
def test_mpack_is_byte_equal_to_msgpack_and_decodes_it(i):
    meta = METAS[i]
    raw = mpack.packb(meta)
    assert raw == msgpack.packb(meta)
    assert mpack.unpackb(raw) == meta == msgpack.unpackb(raw)
    assert mpack.unpackb(msgpack.packb(meta, use_single_float=True)) == \
        msgpack.unpackb(msgpack.packb(meta, use_single_float=True))
    with pytest.raises(ValueError):
        mpack.unpackb(raw[: len(raw) // 2])
    with pytest.raises(ValueError):
        mpack.unpackb(raw + b"\xc0")
    with pytest.raises(TypeError):
        mpack.packb({"x": b"bytes"})


def test_key_paths_print_as_jax_keystr():
    tree = {"o": NT(np.zeros(1), (np.ones(2), np.ones(3))),
            "a": [np.zeros(2), {"z": np.zeros(1), "y": np.zeros(1)}],
            "n": None, "k": {3: np.zeros(1), 1: np.zeros(1)},
            "opt": AdamWState(step=1, mu={"w": np.zeros(1)}, nu=None)}
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(tree)]
    assert [p for p, _ in tree_leaves_with_path(tree)] == jpaths
    assert "['o'].b[0]" in jpaths and "['opt'].mu['w']" in jpaths
    assert len(tree_leaves(tree)) == len(jpaths)


def _rl_tree(seed=0):
    """An ``rl_train``-layout checkpoint tree: the policy at full width,
    optimizer moments, int32-stored random bits and a step counter."""
    pcfg = jppo.PPOConfig(obs_dim=41, n_actions=2)
    pol = jppo.init_policy(pcfg, jax.random.PRNGKey(seed))
    return {"policy": pol,
            "opt": {"mu": jax.tree_util.tree_map(lambda w: w * 0.5, pol),
                    "nu": jax.tree_util.tree_map(jnp.square, pol)},
            "rs": jnp.arange(8, dtype=jnp.int32) - 3,
            "it": jnp.int32(11)}


def _leaves_equal(port_tree, jax_tree):
    pl, jl = tree_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(pl) == len(jl) > 0
    for p, j in zip(pl, jl):
        j = np.asarray(j)
        p = to_np(p)
        assert p.shape == j.shape and p.dtype == j.dtype
        assert np.array_equal(p.reshape(-1).view(np.uint8),
                              j.reshape(-1).view(np.uint8))


def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path):
    tree = _rl_tree()
    jckpt.save(tmp_path, 7, tree, metadata={"it": 7, "mode": "integrated"})
    target = to_t(tree)
    got, step, user = ckpt.restore(tmp_path, target)
    assert step == 7 and user == {"it": 7, "mode": "integrated"}
    _leaves_equal(got, tree)
    pol, step, _ = ckpt.restore_subtree(tmp_path, to_t(tree["policy"]),
                                        "['policy']")
    _leaves_equal(pol, tree["policy"])
    assert ckpt.read_metadata(tmp_path) == user
    assert ckpt.latest_step(tmp_path) == 7


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    tree = to_t(_rl_tree(1))
    ckpt.save(tmp_path, 9, tree, metadata={"it": 9})
    jtarget = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), to_np(t).dtype),
        tree)
    got, step, user = jckpt.restore(tmp_path, jtarget)
    assert step == 9 and user == {"it": 9}
    _leaves_equal(tree, got)
    pol, _, _ = jckpt.restore_subtree(tmp_path, jtarget["policy"],
                                      "['policy']")
    _leaves_equal(tree["policy"], pol)
    meta = msgpack.unpackb((tmp_path / "step_000000009" /
                            "meta.msgpack").read_bytes())
    assert meta["paths"][0] == "['it']"


def test_roundtrip_keep_n_scalars_and_namedtuples(tmp_path):
    tree = {"w": torch.randn(3, 4), "bits": torch.tensor([-1, 5],
                                                         dtype=torch.int32),
            "flag": torch.tensor([True, False]),
            "opt": AdamWState(step=4, mu={"w": torch.ones(2)}, nu=None)}
    for s in range(5):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.all_steps(tmp_path) == [3, 4]
    got, step, _ = ckpt.restore(tmp_path, tree)
    assert step == 4 and isinstance(got["opt"], AdamWState)
    assert got["opt"].step == 4 and isinstance(got["opt"].step, int)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(tmp_path, {"w": tree["w"]})
    with pytest.raises(ValueError, match="no leaf"):
        ckpt.restore_subtree(tmp_path, {"w": tree["w"]}, "['policy']")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_subtree(tmp_path, {"w": torch.zeros(4, 4)}, "")


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_ml_dtypes_leaves_roundtrip_bitwise_both_ways(tmp_path, dtype):
    """A bf16 or float8 leaf (with a float32 one beside it, 0-d and 2-d)
    goes port -> JAX, JAX -> port and port -> port bitwise, without the
    port importing ml_dtypes."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    g = torch.Generator().manual_seed(5)
    tree = {"w": (4 * torch.randn((3, 5), generator=g)).to(tdt),
            "s": torch.tensor(1.5).to(tdt),
            "f": torch.randn((2,), generator=g)}

    def bits(t):
        return to_np(t.reshape(-1).view(torch.uint8))

    ckpt.save(tmp_path / "p", 1, tree)
    meta = msgpack.unpackb((tmp_path / "p" / "step_000000001" /
                            "meta.msgpack").read_bytes())
    assert meta["dtypes"] == ["float32", dtype, dtype]
    jtarget = {"w": jax.ShapeDtypeStruct((3, 5), jdt),
               "s": jax.ShapeDtypeStruct((), jdt),
               "f": jax.ShapeDtypeStruct((2,), jnp.float32)}
    got, _, _ = jckpt.restore(tmp_path / "p", jtarget)
    for k in tree:
        j = np.asarray(got[k])
        assert j.dtype == jtarget[k].dtype and j.shape == jtarget[k].shape
        assert np.array_equal(j.reshape(-1).view(np.uint8), bits(tree[k]))
    target = {k: torch.zeros_like(v) for k, v in tree.items()}
    jckpt.save(tmp_path / "j", 2, got)
    back, step, _ = ckpt.restore(tmp_path / "j", target)
    own, _, _ = ckpt.restore(tmp_path / "p", target)
    assert step == 2
    for k in tree:
        for t in (back[k], own[k]):
            assert t.dtype == tree[k].dtype and t.shape == tree[k].shape
            assert np.array_equal(bits(t), bits(tree[k]))


def test_dtype_torch_cannot_name_raises(tmp_path):
    import ml_dtypes
    jckpt.save(tmp_path, 0, {"w": np.zeros(2, ml_dtypes.float8_e4m3b11fnuz)})
    with pytest.raises(ValueError, match="float8_e4m3b11fnuz"):
        ckpt.restore(tmp_path, {"w": torch.zeros(2)})


@pytest.mark.parametrize("tear", ["tmp-only", "no-commit", "truncated",
                                  "torn-meta"])
def test_torn_saves_never_loaded_and_swept(tmp_path, tear):
    """The port's ``torn_save`` builds the reference's layouts: the JAX
    and the port's readers both skip or refuse them, restore falls back
    to the previous committed step, and the next save sweeps them."""
    good = to_t(_rl_tree(2))
    ckpt.save(tmp_path, 1, good)
    torn = tfi.torn_save(tmp_path, 2, to_t(_rl_tree(3)), tear=tear)
    assert torn.exists()
    for pkg in (ckpt, jckpt):
        assert pkg.latest_step(tmp_path) == 1
    got, step, _ = ckpt.restore(tmp_path, good)
    assert step == 1
    for a, b in zip(tree_leaves(good), tree_leaves(got)):
        assert torch.equal(a, b)
    if tear != "tmp-only":
        for pkg in (ckpt, jckpt):
            with pytest.raises((FileNotFoundError, ValueError)):
                pkg.read_metadata(tmp_path, step=2)
            with pytest.raises((FileNotFoundError, ValueError)):
                pkg.restore_subtree(tmp_path, good["policy"]
                                    if pkg is ckpt else
                                    jax.tree_util.tree_map(
                                        np.asarray,
                                        _rl_tree(2)["policy"]),
                                    "['policy']", step=2)
    layout = sorted(q.name for q in torn.iterdir())
    j_torn = jfi.torn_save(tmp_path / "j", 2, _rl_tree(3), tear=tear)
    assert torn.name == j_torn.name
    assert layout == sorted(q.name for q in j_torn.iterdir())
    ckpt.save(tmp_path, 3, good)
    assert not torn.exists()


def test_corrupt_committed_metadata_raises(tmp_path):
    ckpt.save(tmp_path, 3, {"w": torch.ones(2)}, metadata={"it": 3})
    mp = tmp_path / "step_000000003" / "meta.msgpack"
    raw = mp.read_bytes()
    mp.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="meta.msgpack"):
        ckpt.read_metadata(tmp_path, step=3)
    mp.write_bytes(b"\xc3")              # valid msgpack, not a meta dict
    with pytest.raises(ValueError, match="meta.msgpack"):
        ckpt.read_metadata(tmp_path, step=3)
    with pytest.raises(FileNotFoundError):
        ckpt.read_metadata(tmp_path / "empty")
