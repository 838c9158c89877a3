"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``),
and the tests of the port's own plumbing: the pytree helpers and the
JAX-to-torch conversion (``repro_torch/convert.py``).

Tolerances, stated once for every parity file: integer and bool leaves
exact; one f32 forward ``FWD_ATOL``; after optimizer steps ``OPT_ATOL``.
torch and XLA CPU matmuls differ by up to ~1.1e-5 at some shapes, so
wherever a threshold or an argmax follows a float the tests count the
decisions that flip: every flip must sit within ``FLIP_EPS`` of its
threshold (or of the top-2 logit gap), and the lanes without a flip are
compared exactly on their integer leaves.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa

torch.set_num_threads(1)

FWD_ATOL = 1e-5
OPT_ATOL = 1e-4
FLIP_EPS = 1e-4


def np_tree(tree):
    """A JAX pytree -> the same pytree of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def to_t(tree):
    """A JAX (or numpy) pytree -> the port's pytree of CPU tensors."""
    return convert.to_torch(np_tree(tree), device="cpu")


def to_np(x):
    """A tensor -> numpy; int32-stored bits stay int32."""
    return x.detach().cpu().numpy()


def assert_close(port, ref, atol):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), atol=atol,
                               rtol=0)


def assert_equal(port, ref):
    np.testing.assert_array_equal(to_np(port), np.asarray(ref))


def lane_mismatch(streams, finals, T, L, atol=FWD_ATOL):
    """Per-lane first mismatching tick (T = none). ``streams``: [(port
    (T, L, ...), ref, exact)], ``finals``: [(port (L, ...), ref, exact)];
    a mismatch only in the final state counts at tick T - 1."""
    first = np.full((L,), T)
    for p, r, exact in streams:
        p = to_np(p).reshape(T, L, -1)
        r = np.asarray(r).reshape(T, L, -1)
        bad = ((p != r) if exact
               else (np.abs(p.astype(np.float64) - r) > atol)).any(-1)
        t_bad = np.where(bad, np.arange(T)[:, None], T).min(0)
        first = np.minimum(first, t_bad)
    for p, r, exact in finals:
        p = to_np(p).reshape(L, -1)
        r = np.asarray(r).reshape(L, -1)
        bad = ((p != r) if exact
               else (np.abs(p.astype(np.float64) - r) > atol)).any(-1)
        first = np.where(bad & (first == T), T - 1, first)
    return first


def jax_ls_fns(domain, vanish_after=0):
    """The JAX package's LS functions of ``domain`` on kernel-encoded
    (int32) leaves -> (tick, dset, obs), as the JAX engine hands them to
    its kernels: the traffic lanes and phase decoded to bool and int8,
    the warehouse's spawn leaf to bool."""
    import jax.numpy as jnp
    if domain == "traffic":
        from repro.envs import traffic as jtr
        jls = jtr.make_batched_local_traffic_env(jtr.TrafficConfig())

        def dec(vals):
            return jtr.LocalTrafficState(lanes=vals[0].astype(bool),
                                         phase=vals[1].astype(jnp.int8))

        def tick(vals, a, u, nz):
            st, r = jls.rollout_tick(dec(vals), a, u, None)
            return (st.lanes.astype(jnp.int32),
                    st.phase.astype(jnp.int32)), r
    else:
        from repro.envs import warehouse as jwh
        jls = jwh.make_batched_local_warehouse_env(
            jwh.WarehouseConfig(vanish_after=vanish_after))

        def dec(vals):
            return jwh.LocalWarehouseState(pos=vals[0], items=vals[1])

        def tick(vals, a, u, nz):
            st, r = jls.rollout_tick(dec(vals), a, u, nz[0].astype(bool))
            return (st.pos, st.items), r

    return (tick, lambda vals, a: jls.dset_fn(dec(vals), a),
            lambda vals: jls.obs_fn(dec(vals)))


def assert_lanes_match(streams, finals, margins, T, L, atol=FWD_ATOL,
                       max_flip_share=0.25):
    """The lane and flip rule. ``margins`` (T, L): the port's decision
    distances from their thresholds (``ref.*`` ``trace``). A lane may
    differ only after a decision within FLIP_EPS of its threshold."""
    first = lane_mismatch(streams, finals, T, L, atol)
    if isinstance(margins, (list, tuple)):
        margins = np.stack([to_np(m) for m in margins])
    elif isinstance(margins, torch.Tensor):
        margins = to_np(margins)
    upto = np.arange(T)[:, None] <= first[None]
    near = np.where(upto, margins, np.inf).min(0) < FLIP_EPS
    bad = first < T
    assert not (bad & ~near).any(), (
        f"lanes {np.nonzero(bad & ~near)[0]} differ away from any "
        f"decision threshold (first ticks {first[bad & ~near]})")
    assert bad.sum() <= max_flip_share * L, f"{bad.sum()} of {L} flipped"
    return int(bad.sum())


# ---------------------------------------------------------------------------
# tests of the port's plumbing
# ---------------------------------------------------------------------------

def test_tree_helpers_visit_dicts_in_sorted_order():
    tree = {"b": torch.tensor(2.0), "a": (torch.tensor(1.0), None),
            "c": {"y": torch.tensor(4.0), "x": torch.tensor(3.0)}}
    assert [float(l) for l in tree_leaves(tree)] == [1.0, 2.0, 3.0, 4.0]
    doubled = tree_map(lambda l: l * 2, tree)
    assert [float(l) for l in tree_leaves(doubled)] == [2.0, 4.0, 6.0, 8.0]
    back = tree_unflatten(tree, [torch.tensor(float(i)) for i in range(4)])
    assert float(back["c"]["x"]) == 2.0 and back["a"][1] is None


def test_convert_keeps_layouts_and_dtypes():
    from repro.core import influence as jinf
    from repro.envs.traffic import LocalTrafficState as JLocal
    from repro_torch.envs.traffic import LocalTrafficState
    cfg = jinf.AIPConfig(kind="gru", d_in=6, n_out=2, hidden=4)
    jp = jinf.init_aip(cfg, jax.random.PRNGKey(0))
    tp = to_t(jp)
    assert tp["gru"]["wx"].shape == (6, 12)
    assert tp["gru"]["wx"].dtype == torch.float32
    assert_equal(tp["gru"]["wh"], jp["gru"]["wh"])
    bits = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    tb = convert.to_torch(bits, device="cpu")
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(to_np(tb).view(np.uint32), bits)
    st = JLocal(lanes=np.zeros((2, 4, 3), bool),
                phase=np.ones((2,), np.int8))
    ts = to_t(st)
    assert isinstance(ts, LocalTrafficState)
    assert ts.lanes.dtype == torch.bool and ts.phase.dtype == torch.int8
