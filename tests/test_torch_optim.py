"""The port's optimizer substrate (``repro_torch/optim``) against the JAX
package's (``repro/optim``) on the CPU.

- ``cosine_schedule`` / ``constant_schedule``: float32, the reference's
  order of operations, at every step of warm-up, decay and the floor.
- ``adamw`` with a cosine ``lr`` over 3 steps on a tree of bfloat16 and
  float32 leaves, from the same gradients: the functional ``update`` and
  the in-place ``update_`` against the reference's ``update`` (params,
  ``mu``, ``nu``, ``step``, ``grad_norm``, ``lr``; bfloat16 leaves within
  one bf16 ulp plus 2e-2), and the two forms of
  the port bitwise equal to each other, in slices of the leading axis
  too (``SLICE_ELEMENTS`` made small).
- ``grad_compress``: the int8 values and scales of ``compress`` exactly
  the reference's (both round half to even; the test plants exact
  halves), ``decompress``, ``compress_with_feedback`` and
  ``compression_ratio``; ``compressed_psum`` on 2 gloo ranks against the
  reference's under ``shard_map`` on a forced 2-device CPU mesh (a
  subprocess a rank, as ``tests/test_torch_sharding_ref.py`` builds it).

Tolerances: the schedules and the adamw moments are float32 elementwise
arithmetic in the same order; they agree to ``SCHED_RTOL`` of the value
plus ``SCHED_RTOL`` of the peak (XLA's and torch's ``cos`` may round by an
ulp, which ``1 + cos`` carries near the floor) and ``OPT_ATOL`` after the
update (``global_norm`` sums leaves in another order, and ``sqrt`` may
round by an ulp). Everything of ``grad_compress`` is exact but the
error state under the reference's ``jit`` (see the psum test).
"""
import json
import textwrap

import numpy as np
import pytest

from test_torch_common import OPT_ATOL, to_np, to_t
from test_torch_sharding import spawn

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SCHED_RTOL = 2 ** -22          # two float32 ulps (of cos, scaled)
SCHEDULES = [(3e-4, 20, 100, 0.1), (1e-3, 2, 6, 0.1), (0.5, 0, 10, 0.0),
             (2e-3, 5, 5, 0.3)]


@pytest.mark.parametrize("peak,warmup,total,floor", SCHEDULES)
def test_cosine_schedule_matches_the_reference(peak, warmup, total, floor):
    jf = jadamw.cosine_schedule(peak, warmup, total, floor)
    tf = tadamw.cosine_schedule(peak, warmup, total, floor)
    for s in range(total + 3):
        want = np.asarray(jf(jnp.int32(s)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(to_np(got), want, rtol=SCHED_RTOL,
                                   atol=peak * SCHED_RTOL,
                                   err_msg=f"step {s}")
        assert float(tf(s)) == float(got)        # a Python int step too


def test_constant_schedule():
    got = tadamw.constant_schedule(3e-4)(torch.tensor(7))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(np.asarray(
        jadamw.constant_schedule(3e-4)(jnp.int32(7))))


def _tree(seed):
    """A bf16 + f32 parameter tree (numpy; bf16 via ml_dtypes) and three
    steps of gradients in the parameters' dtypes."""
    rs = np.random.RandomState(seed)
    shapes = {"a": {"w": (3, 40, 7), "b": (7,)}, "embed": (50, 8),
              "norm": (8,)}
    bf16 = {"a": {"w": True, "b": False}, "embed": True, "norm": False}

    def make(shape, is_bf16, scale=1.0):
        x = (scale * rs.standard_normal(shape)).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if is_bf16 else x

    params = jax.tree_util.tree_map(make, shapes, bf16,
                                    is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s, b: make(s, b, scale=3.0), shapes, bf16,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    return params, grads


def _t(tree):
    return to_t(tree)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])     # clipped / not
def test_adamw_cosine_matches_the_reference(clip_norm):
    """3 steps of ``update`` and of ``update_`` against the reference's."""
    params, grads = _tree(0)
    sched = (2e-2, 2, 3)
    jopt = jadamw.adamw(jadamw.cosine_schedule(*sched), clip_norm=clip_norm)
    topt = tadamw.adamw(tadamw.cosine_schedule(*sched), clip_norm=clip_norm)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    fp, fs = _t(params), topt.init(_t(params))
    ip, is_ = _t(params), topt.init(_t(params))
    ip_leaves = tree_leaves(ip)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 js, jp)
        fp, fs, fm = topt.update(_t(g), fs, fp)
        ip, is_, im = topt.update_(_t(g), is_, ip)
        for name, m in (("functional", fm), ("in place", im)):
            assert m["lr"].dtype == torch.float32 and m["lr"].dim() == 0
            assert float(m["lr"]) == float(np.asarray(jm["lr"])), name
            np.testing.assert_allclose(to_np(m["grad_norm"]),
                                       np.asarray(jm["grad_norm"]),
                                       rtol=1e-6, err_msg=name)
    # the in-place form wrote into the trees it was given
    assert all(a is b for a, b in zip(tree_leaves(ip), ip_leaves))
    assert int(fs.step) == int(is_.step) == int(js.step) == 3
    assert is_.step.dtype == torch.int32
    ref = {"params": jp, "mu": js.mu, "nu": js.nu}
    for name, (p, st) in (("functional", (fp, fs)), ("in place", (ip, is_))):
        got = {"params": p, "mu": st.mu, "nu": st.nu}
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            w = np.asarray(w)
            assert str(g.dtype).split(".")[-1] == w.dtype.name, name
            np.testing.assert_allclose(
                g.float().numpy(), w.astype(np.float32),
                atol=OPT_ATOL if g.dtype == torch.float32 else 2e-2,
                rtol=0 if g.dtype == torch.float32 else 2 ** -7,
                err_msg=name)
    # the two forms of the port: bitwise
    for a, b in zip(tree_leaves((fp, fs)), tree_leaves((ip, is_))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("slice_elements", [1 << 26, 64, 1])
def test_update_in_place_equals_functional_bitwise(monkeypatch,
                                                   slice_elements):
    """Whatever the slices of the leading axis, ``update_`` is ``update``
    bit for bit (a weight decay and a clip that bite)."""
    monkeypatch.setattr(tadamw, "SLICE_ELEMENTS", slice_elements)
    params, grads = _tree(1)
    opt = tadamw.adamw(tadamw.cosine_schedule(1e-2, 1, 3),
                       weight_decay=0.3, clip_norm=0.5)
    fp, fs = _t(params), opt.init(_t(params))
    ip, is_ = _t(params), opt.init(_t(params))
    for g in grads:
        fp, fs, fm = opt.update(_t(g), fs, fp)
        ip, is_, im = opt.update_(_t(g), is_, ip)
        assert torch.equal(fm["grad_norm"], im["grad_norm"])
    for a, b in zip(tree_leaves((fp, fs)), tree_leaves((ip, is_))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_float_lr_and_per_agent():
    """A float ``lr`` is a constant schedule; the per-agent form keeps its
    functional update and refuses the in-place one."""
    opt = tadamw.adamw(1e-3, per_agent=True)
    p = {"w": torch.ones((3, 4))}
    st = opt.init(p)
    _, _, m = opt.update({"w": torch.ones((3, 4))}, st, p)
    assert float(m["lr"]) == float(np.float32(1e-3))
    assert tuple(m["grad_norm"].shape) == (3,)
    with pytest.raises(ValueError, match="per-agent"):
        opt.update_({"w": torch.ones((3, 4))}, st, p)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _compress_input(shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(shape).astype(np.float32) * 5
    flat = x.reshape(-1)
    if flat.size >= 8:       # exact halves on the int8 grid: 127 at the
        flat[0] = 127.0      # block max makes the scale 1.0
        flat[1:7] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    return x


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 33), 64),
                                         ((3, 5, 17), 256), ((512,), 128),
                                         ((5,), 8)])
def test_compress_matches_the_reference_exactly(shape, block):
    x = _compress_input(shape, 0)
    x.reshape(-1)[7:block] = np.clip(x.reshape(-1)[7:block], -100, 100)
    jq, js = jgc.compress(jnp.asarray(x), block)
    tq, ts = tgc.compress(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    if block <= x.size:     # the planted halves rounded half to even
        np.testing.assert_array_equal(to_np(tq).reshape(-1)[:7],
                                      [127, 0, 2, 2, 0, -2, -2])
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = tgc.decompress(tq, ts, shape, dtype)
        want = np.asarray(jgc.decompress(jq, js, shape, jdt))
        assert tuple(got.shape) == shape and got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


def test_compress_with_feedback_matches_the_reference():
    x = _compress_input((3, 100), 1)
    err = np.random.RandomState(2).standard_normal((3, 100)).astype(
        np.float32) * 0.01
    jq, js, je = jgc.compress_with_feedback(jnp.asarray(x), jnp.asarray(err),
                                            64)
    tq, ts, te = tgc.compress_with_feedback(torch.from_numpy(x),
                                            torch.from_numpy(err), 64)
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(to_np(te), np.asarray(je))


@pytest.mark.parametrize("shape,block", [((1024, 1024), 256), ((10,), 256),
                                         ((3, 7), 4)])
def test_compression_ratio(shape, block):
    assert tgc.compression_ratio(shape, torch.float32, block) == \
        jgc.compression_ratio(shape, jnp.float32, block)
    assert tgc.compression_ratio(shape, torch.bfloat16, block) == \
        jgc.compression_ratio(shape, jnp.bfloat16, block)


PSUM_RANK = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "tests")
    from functools import partial
    import jax, jax.numpy as jnp
    import numpy as np
    import torch
    import torch.distributed as dist
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim import grad_compress as jgc
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.optim import grad_compress as tgc

    init_ranks("gloo", "cpu", init_method=sys.argv[1])
    rank = dist.get_rank()
    block = int(sys.argv[2])
    rs = np.random.RandomState(5)
    xs = (rs.standard_normal((2, 6, 50)) * 3).astype(np.float32)
    errs = (rs.standard_normal((2, 6, 50)) * 0.01).astype(np.float32)
    # the reference: rank r's shard on device r of a 2-device pod axis
    mesh = Mesh(np.array(jax.devices()), ("pod",))
    fn = shard_map(partial(lambda x, e: jgc.compressed_psum(
        x[0], "pod", e[0], block)), mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P(), P("pod")), check_rep=False)
    ref_out, ref_err = jax.jit(lambda x, e: (lambda o, ne: (o, ne))(
        *fn(x, e)))(jnp.asarray(xs), jnp.asarray(errs))
    ref_out, ref_err = np.asarray(ref_out), np.asarray(ref_err)
    out, new_err = tgc.compressed_psum(torch.from_numpy(xs[rank]), None,
                                       torch.from_numpy(errs[rank]), block)
    report = {
        "rank": rank,
        "out_equal": bool(np.array_equal(out.numpy(), ref_out)),
        "out_err": float(np.abs(out.numpy() - ref_out).max()),
        # in ulps of the compressed target x + err
        "err_ulps": float((np.abs(new_err.numpy() - ref_err.reshape(
            2, 6, 50)[rank]) / np.spacing(np.abs(
                xs[rank] + errs[rank]))).max()),
        "shape": list(out.shape), "dtype": str(out.dtype)}
    print("REPORT " + json.dumps(report))
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("block", [64, 256])
def test_compressed_psum_on_two_ranks_matches_the_reference(tmp_path, block):
    """Each rank's result equals the reference's ``shard_map`` psum
    bitwise, and each rank's error state the reference's shard of it
    within an ulp of ``x + err``: under ``jit`` XLA fuses
    ``target - q * scale`` (one rounding fewer) where eager code, the
    port's and the reference's alike, rounds the product."""
    res = spawn(2, ["-c", PSUM_RANK, f"file://{tmp_path / 'store'}",
                    str(block)])
    assert [rc for rc, _ in res] == [0, 0], res[0][1][-3000:] + \
        res[1][1][-2000:]
    for rank, (_, out) in enumerate(res):
        line = [ln for ln in out.splitlines() if ln.startswith("REPORT ")]
        r = json.loads(line[-1][len("REPORT "):])
        assert r["rank"] == rank and r["shape"] == [6, 50]
        assert r["dtype"] == "torch.float32"
        assert r["out_equal"] and r["err_ulps"] <= 1.0, r
