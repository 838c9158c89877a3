"""The LM's layers in the port (``repro_torch/nn``) against the JAX
package's (``repro/nn``) on the CPU: RoPE, both decode attentions, the
norms and activations, the MLPs, ``moe_apply`` with capacity drops and
dropless (with its aux and a count of routing flips), ``moe_apply_ep``
without a mesh (with one it must refuse), and the tree helpers.

Inputs are numpy arrays from a seed; bf16 inputs are rounded by each
framework from the same float32 arrays. Tolerances: float32 ``F32_TOL``
1e-5 absolute (a reduction in another order); for bf16 outputs 2e-2
plus one bf16 ulp of the value (``rtol`` 2**-7), since XLA may keep
float32 between fused elementwise ops where torch rounds after each op.
Routing: a token routes to another expert set in the two packages only
where its k-th and (k+1)-th router probabilities are within ``FLIP_EPS``;
``_routing_flips`` counts the tokens whose sets differ and requires each
to be such a near-tie.
"""
import numpy as np
import pytest

from test_torch_common import FLIP_EPS, to_np

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.nn import attention as jatt  # noqa: E402
from repro.nn import module as jmod  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import module as tmod  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn import moe_ep as tmoe_ep  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2e-2
BF16_RTOL = 2.0 ** -7
DTYPES = ["float32", "bfloat16"]


def _pair(a, dtype="float32"):
    """One float32 numpy array -> (JAX array, CPU tensor) of ``dtype``."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a.copy()).to(getattr(torch, dtype)))


def _close(port, want, dtype="float32", atol=None):
    bf = dtype == "bfloat16"
    tol = atol if atol is not None else (BF16_TOL if bf else F32_TOL)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(to_np(port.float()), want, atol=tol,
                               rtol=BF16_RTOL if bf else 0.0)


def _rand(rs, *shape, scale=1.0):
    return (scale * rs.standard_normal(shape)).astype(np.float32)


def convert_tree(np_tree):
    return convert.to_torch(np_tree, device="cpu")


# ---------------------------------------------------------------------------
# RoPE and the decode attentions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos_kind", ["shared", "per_batch"])
@pytest.mark.parametrize("rot_dim", [None, 8])
def test_apply_rope(dtype, pos_kind, rot_dim):
    rs = np.random.RandomState(0)
    x = _rand(rs, 2, 7, 3, 16)
    pos = np.arange(5, 12) if pos_kind == "shared" else \
        rs.randint(0, 1000, (2, 7))
    jx, tx = _pair(x, dtype)
    want = jatt.apply_rope(jx, jnp.asarray(pos), 1e6, rot_dim)
    got = tatt.apply_rope(tx, torch.from_numpy(pos), 1e6, rot_dim)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    jc, js = jatt.rope_angles(jnp.asarray(pos), 16, 1e4)
    tc, ts = tatt.rope_angles(torch.from_numpy(pos), 16, 1e4)
    _close(tc, jc, atol=1e-5)
    _close(ts, js, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])
@pytest.mark.parametrize("pos", [0, 9, 15])
def test_decode_attention(dtype, H, KH, pos):
    """Slots past ``pos`` hold garbage: the reference masks them, the port
    leaves them out; both must ignore them."""
    rs = np.random.RandomState(1)
    B, S, D = 2, 16, 16
    q, k, v = _rand(rs, B, H, D), _rand(rs, B, S, KH, D), \
        _rand(rs, B, S, KH, D)
    k[:, pos + 1:] = 1e4
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jatt.decode_attention(jq, jk, jv, jnp.int32(pos))
    got = tatt.decode_attention(tq, tk, tv, pos)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [0, 11])
def test_mla_decode_attention(dtype, pos):
    """bf16: the JAX CPU runtime refuses the reference's bf16 x bf16 ->
    f32 products (``DotThunk``), so the port's bf16 run is held against
    the reference run in float32 on the same bf16-rounded inputs, within
    the bf16 tolerance (the reference's bf16 path rounds the latent q, p
    and the latent output to bf16 on top)."""
    rs = np.random.RandomState(2)
    B, H, S, R, Dn, Dr, Dv = 2, 4, 12, 32, 16, 8, 16
    arrs = [_rand(rs, B, H, Dn), _rand(rs, B, H, Dr), _rand(rs, B, S, R),
            _rand(rs, B, S, Dr), _rand(rs, H, R, Dn, scale=0.2),
            _rand(rs, H, R, Dv, scale=0.2)]
    js, ts = zip(*(_pair(a, dtype) for a in arrs))
    js = [j.astype(jnp.float32) for j in js]
    scale = (Dn + Dr) ** -0.5
    want = jatt.mla_decode_attention(*js, jnp.int32(pos), scale=scale)
    got = tatt.mla_decode_attention(*ts, pos, scale=scale)
    assert got.dtype == ts[0].dtype
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# Norms, activations, embedding, MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(dtype, kind):
    rs = np.random.RandomState(3)
    x = _rand(rs, 3, 5, 64, scale=3.0) + 1.0
    p = {"g": 1.0 + _rand(rs, 64, scale=0.1), "b": _rand(rs, 64, scale=0.1)}
    if kind == "rmsnorm":
        del p["b"]
    jx, tx = _pair(x, dtype)
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    _, jnorm = jmod.make_norm(kind)
    tinit, tnorm = tmod.make_norm(kind)
    _close(tnorm(tp, tx), jnorm(jp, jx), dtype)
    jinit, _ = jmod.make_norm(kind)
    for k, v in tinit(8, dtype=getattr(torch, dtype), device="cpu").items():
        np.testing.assert_array_equal(to_np(v.float()), np.asarray(
            jinit(8, dtype=getattr(jnp, dtype))[k].astype(jnp.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", sorted(jmod.ACTIVATIONS))
def test_activations(dtype, act):
    assert sorted(tmod.ACTIVATIONS) == sorted(jmod.ACTIVATIONS)
    x = np.linspace(-6, 6, 257, dtype=np.float32)
    jx, tx = _pair(x, dtype)
    _close(tmod.ACTIVATIONS[act](tx), jmod.ACTIVATIONS[act](jx), dtype,
           atol=1e-6 if dtype == "float32" else None)


def test_embedding_and_dense_bias():
    rs = np.random.RandomState(4)
    table = _rand(rs, 50, 8)
    ids = rs.randint(0, 50, (3, 4)).astype(np.int32)
    got = tmod.embedding({"table": torch.from_numpy(table)},
                         torch.from_numpy(ids).long())
    want = jmod.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    w, b, x = _rand(rs, 8, 6), _rand(rs, 6), _rand(rs, 3, 8)
    _close(tmod.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                      torch.from_numpy(x)),
           jmod.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                      jnp.asarray(x)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,act", [("gated_mlp", "silu"),
                                      ("mlp", "relu2"), ("mlp", "gelu")])
def test_mlps(dtype, kind, act):
    rs = np.random.RandomState(5)
    d, f = 32, 48
    p = {"w_in": _rand(rs, d, f, scale=d ** -0.5),
         "w_out": _rand(rs, f, d, scale=f ** -0.5)}
    if kind == "gated_mlp":
        p["w_gate"] = _rand(rs, d, f, scale=d ** -0.5)
    x = _rand(rs, 2, 5, d)
    jx, tx = _pair(x, dtype)
    jp = {k: _pair(v, dtype)[0] for k, v in p.items()}
    tp = {k: _pair(v, dtype)[1] for k, v in p.items()}
    _close(getattr(tmoe, kind)(tp, tx, act), getattr(jmoe, kind)(jp, jx, act),
           dtype)


def test_init_shapes_and_dtypes():
    """The MLP / MoE inits draw the reference's shapes and dtypes (the
    router stays float32 under bf16 weights)."""
    g = torch.Generator()
    g.manual_seed(0)
    key = jax.random.PRNGKey(0)
    for dt in DTYPES:
        tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
        pairs = [
            (tmoe.gated_mlp_init(g, 16, 24, dtype=tdt),
             jmoe.gated_mlp_init(key, 16, 24, dtype=jdt)),
            (tmoe.mlp_init(g, 16, 24, dtype=tdt),
             jmoe.mlp_init(key, 16, 24, dtype=jdt)),
            (tmoe.moe_init(g, 16, 8, 4, 2, dtype=tdt),
             jmoe.moe_init(key, 16, 8, 4, 2, dtype=jdt))]
        for tp, jp in pairs:
            got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
                   for p, x in tree_leaves_with_path(tp)}
            want = {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype.name)
                    for p, x in jax.tree_util.tree_leaves_with_path(jp)}
            assert got == want


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(rs, d=32, de=16, E=8, n_shared=1):
    p = {"router": _rand(rs, d, E, scale=d ** -0.5),
         "experts": {"w_gate": _rand(rs, E, d, de, scale=d ** -0.5),
                     "w_in": _rand(rs, E, d, de, scale=d ** -0.5),
                     "w_out": _rand(rs, E, de, d, scale=de ** -0.5)}}
    if n_shared:
        p["shared"] = {"w_gate": _rand(rs, d, de, scale=d ** -0.5),
                       "w_in": _rand(rs, d, de, scale=d ** -0.5),
                       "w_out": _rand(rs, de, d, scale=de ** -0.5)}
    return p


def _routing_flips(np_p, x, top_k):
    """Tokens whose top-k expert sets differ between the packages; each
    must be a near-tie of the router."""
    tprobs = torch.softmax(torch.from_numpy(x.reshape(-1, x.shape[-1]).copy())
                           @ torch.from_numpy(np_p["router"]), -1)
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1]))
                            @ jnp.asarray(np_p["router"]), -1)
    ti = torch.sort(tprobs, dim=-1, descending=True, stable=True).indices
    ji = np.asarray(jax.lax.top_k(jprobs, top_k)[1])
    differ = np.array([set(a[:top_k]) != set(b) for a, b in
                       zip(to_np(ti), ji)])
    s = np.sort(to_np(tprobs), -1)[:, ::-1]
    near = (s[:, top_k - 1] - s[:, top_k]) < FLIP_EPS
    assert not (differ & ~near).any(), "a routing flip away from a tie"
    return int(differ.sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity", ["drops", "dropless"])
@pytest.mark.parametrize("top_k,n_shared", [(2, 1), (1, 0)])
def test_moe_apply(dtype, capacity, top_k, n_shared):
    rs = np.random.RandomState(6 + top_k)
    E = 8
    np_p = _moe_params(rs, E=E, n_shared=n_shared)
    x = _rand(rs, 3, 10, 32)
    cf = 1.25 if capacity == "drops" else E / top_k
    jp = jax.tree_util.tree_map(lambda a: _pair(a, dtype)[0], np_p)
    tp = tmod.tree_cast(convert_tree(np_p), getattr(torch, dtype))
    jp["router"], tp["router"] = (jnp.asarray(np_p["router"]),
                                  torch.from_numpy(np_p["router"]))
    jx, tx = _pair(x, dtype)
    want, jaux = jmoe.moe_apply(jp, jx, top_k=top_k, capacity_factor=cf)
    got, taux = tmoe.moe_apply(tp, tx, top_k=top_k, capacity_factor=cf)
    assert _routing_flips(np_p, np.asarray(jx.astype(jnp.float32)),
                          top_k) == 0
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    for k in ("lb_loss", "z_loss", "drop_frac"):
        _close(taux[k], jaux[k], atol=1e-6 if dtype == "float32" else 1e-4)
    if capacity == "drops":
        assert float(taux["drop_frac"]) > 0       # some assignments drop
    else:
        assert float(taux["drop_frac"]) == 0


def test_moe_ties_go_to_the_lower_expert_as_in_lax_top_k():
    """Two experts with identical router columns tie on every token: both
    packages keep the lower index (``torch.topk`` alone would not)."""
    rs = np.random.RandomState(9)
    np_p = _moe_params(rs, n_shared=0)
    np_p["router"][:, 5] = np_p["router"][:, 2]
    np_p["router"][:, 6] = np_p["router"][:, 2]
    x = _rand(rs, 2, 12, 32)
    want, _ = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, np_p),
                             jnp.asarray(x), top_k=2, capacity_factor=4.0)
    got, _ = tmoe.moe_apply(convert_tree(np_p), torch.from_numpy(x),
                            top_k=2, capacity_factor=4.0)
    _close(got, want)


def test_moe_apply_ep_without_a_mesh_is_moe_apply_and_refuses_one():
    rs = np.random.RandomState(10)
    tp = convert_tree(_moe_params(rs))
    x = torch.from_numpy(_rand(rs, 2, 6, 32))
    a, aa = tmoe_ep.moe_apply_ep(tp, x, top_k=2)
    b, ba = tmoe.moe_apply(tp, x, top_k=2)
    assert torch.equal(a, b) and all(torch.equal(aa[k], ba[k]) for k in aa)
    c, _ = tmoe_ep.moe_apply_ep(tp, x, top_k=2,
                                mesh=MeshLayout(("data",), (2,)))
    assert torch.equal(a, c)
    # over a mesh with a "model" axis the route runs on DTensors on a
    # DeviceMesh (its parity: tests/test_torch_lm_sharded_moe.py); a
    # layout without a process group, or plain tensors, are refused
    with pytest.raises(TypeError, match="DTensors on a DeviceMesh"):
        tmoe_ep.moe_apply_ep(tp, x, top_k=2,
                             mesh=MeshLayout(("data", "model"), (1, 2)))


# ---------------------------------------------------------------------------
# Tree helpers
# ---------------------------------------------------------------------------

def test_tree_helpers_match_the_reference():
    rs = np.random.RandomState(11)
    tree = {"a": _rand(rs, 3, 4), "b": {"c": _rand(rs, 5),
                                        "i": np.arange(6, dtype=np.int32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = convert_tree(tree)
    assert tmod.tree_size(tt) == jmod.tree_size(jt)
    assert tmod.tree_bytes(tt) == jmod.tree_bytes(jt)
    jc = jmod.tree_cast(jt, jnp.bfloat16)
    tc = tmod.tree_cast(tt, torch.bfloat16)
    assert tc["b"]["i"].dtype == torch.int32 and tc["a"].dtype == \
        torch.bfloat16
    assert tmod.tree_bytes(tc) == jmod.tree_bytes(jc)
    ab = tmod.abstractify(tt)
    assert ab["a"].device.type == "meta" and tuple(ab["a"].shape) == (3, 4)
    assert ab["b"]["i"].dtype == torch.int32


def test_stack_init_draws_one_layer_after_another():
    """``stack_init`` = the layers drawn in order and stacked; on the meta
    device it allocates nothing."""
    def layer(g):
        return {"w": tmod.dense_init(g, 4, 3, dtype=torch.bfloat16)["w"],
                "n": tmod.rmsnorm_init(3, device="cpu")}
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    st = tmod.stack_init(layer, g1, 3)
    each = [layer(g2) for _ in range(3)]
    assert st["w"].shape == (3, 4, 3) and st["w"].dtype == torch.bfloat16
    for i in range(3):
        assert torch.equal(st["w"][i], each[i]["w"])
    meta = tmod.stack_init(lambda g: {"w": tmod.dense_init(
        g, 4, 3, device="meta")["w"]}, torch.Generator(), 5)
    assert meta["w"].device.type == "meta" and meta["w"].shape == (5, 4, 3)
