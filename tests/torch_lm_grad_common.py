"""Shared by ``tests/test_torch_lm_grad_*.py`` (the LM's backward against
the JAX package's): the reference's ``jax.value_and_grad`` of
``repro/models/lm.py::loss_fn``, the port's ``torch.autograd.grad`` of
``repro_torch/models/lm.py::loss_fn`` on the same weights and inputs, and
the per-leaf comparison.

Weights and inputs are ``tests/test_torch_lm.py``'s (the port's init with
every constant leaf perturbed; B = 2, T = 12, a masked label), the same
numpy arrays on both sides, float32 at ``reduced()``.

Tolerances, float32: the loss and its metrics at ``LM_TOL`` (1e-4 + 1e-4
relative, ``tests/test_torch_lm.py``'s). Every gradient leaf at
``GRAD_TOL``: |port - ref| <= 1e-5 + 1e-4 x max|ref leaf| + 1e-3 x |ref|.
The backward sums in another order on each side and a leaf's gradient
sums over every token, so the scale term is the leaf's own: the xLSTM's
embedding gradient reaches ~50 through its exponential gates, and there
the two sides differ by 3.4e-5 of that. bfloat16 (``BF16_GRAD_SHARE``):
within 5% of the leaf's largest gradient; the two sides round to
bfloat16 at different points (measured: 2.7% at worst).

Remat (``check_remat``): the port's loss, metrics and every gradient
under ``full``, ``dots`` and ``names`` bitwise equal to ``none``, and the
group bodies really run again in the backward (one more ``_layer_apply``
call a layer of the stack; ``names`` passes the self-attention outputs
through ``repro_torch::checkpoint_name``).
"""
import numpy as np

from test_torch_lm import LM_TOL, B, T, _NearTies, make_inputs, \
    make_params

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten  # noqa: E402

GRAD_TOL = (1e-5, 1e-4, 1e-3)    # absolute, share of leaf max, relative
BF16_GRAD_SHARE = 5e-2
METRICS = ("ce", "lb_loss", "z_loss", "drop_frac")

REMAT_MODES = ("full", "dots", "names")

__all__ = ["B", "T", "LM_TOL", "GRAD_TOL", "BF16_GRAD_SHARE", "METRICS",
           "REMAT_MODES", "_NearTies", "make_case", "port_grads",
           "check_grads", "check_loss", "check_remat", "saved_bytes"]


def make_case(arch, dtype="float32", seed=0):
    """-> {arch, cfg, params, inputs, ref: {loss, metrics, grads by
    path}}: the reference's value and gradient computed once, jitted."""
    jcfg = jbase.reduced(jbase.get_config(arch)).with_overrides(
        param_dtype=dtype)
    tcfg = tbase.reduced(tbase.get_config(arch)).with_overrides(
        param_dtype=dtype)
    np_params, tparams = make_params(tcfg, seed)
    toks, labels, extra = make_inputs(tcfg, seed)
    if dtype != "float32":
        extra = {k: v.astype(jnp.dtype(dtype)) for k, v in extra.items()}

    def vg(params, toks, labels, extra):
        return jax.value_and_grad(jlm.loss_fn, has_aux=True)(
            params, jcfg, {"tokens": toks[:, :T], "labels": labels, **extra})

    (loss, metrics), grads = jax.jit(vg)(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(toks),
        jnp.asarray(labels), {k: jnp.asarray(v) for k, v in extra.items()})
    ref = {"loss": np.asarray(loss),
           "metrics": {k: np.asarray(v) for k, v in metrics.items()},
           "grads": {jax.tree_util.keystr(p): np.asarray(g).astype(np.float32)
                     for p, g in jax.tree_util.tree_leaves_with_path(grads)}}
    inputs = {"tokens": torch.from_numpy(toks[:, :T]).long(),
              "labels": torch.from_numpy(labels).long()}
    for k, v in extra.items():
        inputs[k] = torch.from_numpy(np.asarray(v, np.float32)).to(
            tcfg.dtype())
    return dict(arch=arch, cfg=tcfg, params=tparams, inputs=inputs, ref=ref)


def port_grads(cfg, params, inputs):
    """-> (loss, metrics, [(path, grad)]) by ``torch.autograd.grad``."""
    live = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss, metrics = tlm.loss_fn(tree_unflatten(params, live), cfg, inputs)
    grads = torch.autograd.grad(loss, live)
    paths = [p for p, _ in tree_leaves_with_path(params)]
    return loss.detach(), {k: metrics[k].detach() for k in METRICS}, \
        list(zip(paths, grads))


def check_loss(loss, metrics, ref, tol=LM_TOL):
    np.testing.assert_allclose(loss.float().numpy(), ref["loss"],
                               atol=tol[0], rtol=tol[1], err_msg="loss")
    for k in METRICS:
        np.testing.assert_allclose(metrics[k].float().numpy(),
                                   ref["metrics"][k], atol=tol[0],
                                   rtol=tol[1], err_msg=k)


def check_grads(grads, ref, bf16=False):
    """Every leaf of the port's gradient against the reference's, by
    path -> the worst share of the bound used."""
    assert [p for p, _ in grads] == list(ref["grads"]), "leaf paths differ"
    worst = 0.0
    for path, g in grads:
        want = ref["grads"][path]
        got = g.float().numpy()
        assert got.shape == want.shape, path
        scale = float(np.abs(want).max()) if want.size else 0.0
        if bf16:
            bound = BF16_GRAD_SHARE * scale + GRAD_TOL[0]
        else:
            bound = GRAD_TOL[0] + GRAD_TOL[1] * scale + \
                GRAD_TOL[2] * np.abs(want)
        share = np.abs(got - want) / bound
        assert np.isfinite(got).all(), path
        assert (share <= 1).all(), (
            f"{path}: max |diff| {np.abs(got - want).max():.3g}, leaf max "
            f"{scale:.3g}")
        worst = max(worst, float(share.max()) if share.size else 0.0)
    return worst


def _counting(monkeypatch):
    """Counts calls of ``lm._layer_apply`` and of the ``checkpoint_name``
    op (by the attention layers' calls into it)."""
    counts = {"layers": 0, "named": 0}
    real_layer, real_name = tlm._layer_apply, tlm.checkpoint_name

    def layer(*a, **kw):
        counts["layers"] += 1
        return real_layer(*a, **kw)

    def name(x, n):
        counts["named"] += 1
        return real_name(x, n)
    monkeypatch.setattr(tlm, "_layer_apply", layer)
    monkeypatch.setattr(tlm, "checkpoint_name", name)
    return counts


def check_remat(case, mode, monkeypatch):
    cfg = case["cfg"]
    counts = _counting(monkeypatch)
    base = port_grads(cfg.with_overrides(remat="none"), case["params"],
                      case["inputs"])
    plain = dict(counts)
    counts.update(layers=0, named=0)
    got = port_grads(cfg.with_overrides(remat=mode), case["params"],
                     case["inputs"])
    assert torch.equal(got[0], base[0]), "loss"
    for k in METRICS:
        assert torch.equal(got[1][k], base[1][k]), k
    for (p, a), (_, b) in zip(got[2], base[2]):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    _, pattern, n_groups = tlm._pattern(cfg)
    assert counts["layers"] == plain["layers"] + n_groups * len(pattern)
    attn = sum(s.kind in ("attn", "dec_attn") for s in pattern)
    assert plain["named"] == 0
    assert counts["named"] >= (attn * n_groups if mode == "names" else 0)
    if mode != "names":
        assert counts["named"] == 0


def saved_bytes(cfg, params, inputs):
    """Bytes autograd saves outside the checkpointed group bodies (inside
    one, the checkpoint's own hooks take the tensors)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    live = [x.detach().requires_grad_() for x in tree_leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tlm.loss_fn(tree_unflatten(params, live), cfg, inputs)
    return total[0]
