"""The port's LM (``repro_torch/models/lm.py``) against the JAX package's
``repro/models/lm.py`` on the CPU, for all ten archs at ``reduced()``,
float32: ``forward`` (h and aux), ``loss_fn``, ``prefill`` (last logits
and every cache leaf) and ``decode_step`` (logits and every cache leaf),
the decode run on the JAX prefill cache carried across by
``convert.to_torch`` (its recurrent states become the port's
``MambaState`` / ``MLSTMState`` / ``SLSTMState``) and on the port's own.
Then the port's own prefill + decode against its forward (the reference's
strongest invariant, ``tests/test_models.py``, at its 2e-3), one bf16
arch, and ``launch/serve.main`` on the CPU.

Weights: the port's ``init_params`` from a seed, with every constant leaf
(zero biases and gates, unit norms, the Mamba skip) perturbed so that
each path carries signal (a zero cross-attention gate would hide the
vision layers); the same numpy arrays go to both packages. The port's
tree is first held to the reference's ``init_params`` layout
(``jax.eval_shape``: paths, shapes, dtypes). The JAX side runs once per
arch, in one jitted call, in a module-scoped fixture.

Tolerances (float32): ``LM_TOL`` = 1e-4 absolute + 1e-4 relative on h,
logits, losses and caches: XLA and torch reduce dot products in another
order, Mamba's state is a sequential loop where the reference runs an
associative scan, and these differences pass through four layers.
MoE routing: a token whose k-th and (k+1)-th router probabilities lie
within ``FLIP_EPS`` of each other could route differently in the two
packages; the port's router calls are recorded and such near-ties
counted. At these seeds there are none, so no flip can have happened and
the comparison is of the same routing.
"""
import numpy as np
import pytest

from test_torch_common import FLIP_EPS, to_np

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

ARCHS = jbase.list_configs()
LM_TOL = (1e-4, 1e-4)          # (atol, rtol), float32
INVARIANT_TOL = 2e-3           # tests/test_models.py's, prefill+decode
BF16_TOL = (6e-2, 2e-2)        # bf16 weights and activations
B, T, ML = 2, 12, 16


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def make_params(cfg, seed=0):
    """-> (numpy tree for JAX, the port's tree): the port's init with every
    constant leaf perturbed, the same arrays on both sides."""
    g = torch.Generator()
    g.manual_seed(seed)
    rs = np.random.RandomState(seed)

    def perturb(t):
        a = t.float().numpy()
        if a.size and (a == a.flat[0]).all() and a.flat[0] in (0.0, 1.0):
            a = a + 0.2 * rs.standard_normal(a.shape).astype(np.float32)
        return _np(torch.from_numpy(np.ascontiguousarray(a)).to(t.dtype))

    np_params = tree_map(perturb, tlm.init_params(cfg, g, device="cpu"))
    return np_params, convert.to_torch(np_params, device="cpu")


def make_inputs(cfg, seed=0):
    rs = np.random.RandomState(seed + 1)
    toks = rs.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels[0, 3] = -1                                   # masked out
    extra = {}
    if cfg.family == "vlm":
        extra["vision"] = rs.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rs.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return toks, labels, extra


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_run(jcfg, np_params, toks, labels, extra):
    def run(params, toks, labels, extra):
        inp = {"tokens": toks[:, :T], **extra}
        h, aux, _ = jlm.forward(params, jcfg, inp)
        loss, metrics = jlm.loss_fn(params, jcfg, {**inp, "labels": labels})
        lg0, cache = jlm.prefill(params, jcfg, inp, ML)
        lg1, cache1 = jlm.decode_step(params, jcfg, cache, toks[:, T],
                                      jnp.int32(T))
        return dict(h=h, aux=aux, loss=loss, metrics=metrics, lg0=lg0,
                    cache=cache, lg1=lg1, cache1=cache1)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = jax.jit(run)(params, jnp.asarray(toks), jnp.asarray(labels),
                       {k: jnp.asarray(v) for k, v in extra.items()})
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg = jbase.reduced(jbase.get_config(arch))
    tcfg = tbase.reduced(tbase.get_config(arch))
    np_params, tparams = make_params(tcfg)
    toks, labels, extra = make_inputs(tcfg)
    ref = _jax_run(jcfg, np_params, toks, labels, extra)
    return dict(arch=arch, jcfg=jcfg, cfg=tcfg, np_params=np_params,
                params=tparams, toks=toks, labels=labels, extra=extra,
                ref=ref)


class _NearTies:
    """Records the port's router calls: tokens whose k-th and (k+1)-th
    router probabilities are within FLIP_EPS (a flip is possible only
    there)."""

    def __init__(self, monkeypatch):
        self.count = 0
        self.calls = 0
        real = tmoe.moe_apply

        def recording(p, x, *, top_k, **kw):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"], -1)
            s = torch.sort(probs, -1, descending=True).values
            self.count += int(((s[:, top_k - 1] - s[:, top_k])
                               < FLIP_EPS).sum())
            self.calls += 1
            return real(p, x, top_k=top_k, **kw)
        monkeypatch.setattr(tmoe, "moe_apply", recording)


def _close(port, want, tol=LM_TOL, what=""):
    np.testing.assert_allclose(to_np(port.float()),
                               np.asarray(want, np.float32),
                               atol=tol[0], rtol=tol[1], err_msg=what)


def _close_trees(port, want, tol=LM_TOL):
    """Every leaf of the port's tree against the JAX tree's, by path (a
    NamedTuple state's leaves by field)."""
    got = tree_leaves_with_path(port)
    ref = dict(tree_leaves_with_path(convert.to_torch(want, device="cpu")))
    assert [p for p, _ in got] == list(ref), "cache paths differ"
    for path, leaf in got:
        assert leaf.dtype == ref[path].dtype, path
        assert tuple(leaf.shape) == tuple(ref[path].shape), path
        _close(leaf, to_np(ref[path].float()), tol, path)


def _tinputs(c, n=T, dtype=None):
    inp = {"tokens": _t(c["toks"][:, :n]).long()}
    for k, v in c["extra"].items():
        inp[k] = _t(v).to(dtype or c["cfg"].dtype())
    return inp


def test_init_matches_the_reference_layout(case):
    """Paths, shapes and dtypes of the port's init equal
    ``jax.eval_shape`` of the reference's."""
    jcfg = case["jcfg"]
    shapes = jax.eval_shape(lambda: jlm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype.name)
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
           for p, x in tree_leaves_with_path(case["params"])}
    assert got == want


def test_forward_and_aux_match(case, monkeypatch):
    ties = _NearTies(monkeypatch)
    with torch.no_grad():
        h, aux, _ = tlm.forward(case["params"], case["cfg"], _tinputs(case))
    _close(h, case["ref"]["h"], what="h")
    for k in ("lb_loss", "z_loss", "drop_frac"):
        _close(aux[k], case["ref"]["aux"][k], what=k)
    assert ties.count == 0, f"{ties.count} router near-ties"
    assert (ties.calls > 0) == (case["cfg"].n_routed_experts > 0)


def test_loss_fn_matches(case):
    inp = dict(_tinputs(case), labels=_t(case["labels"]).long())
    with torch.no_grad():
        loss, metrics = tlm.loss_fn(case["params"], case["cfg"], inp)
    _close(loss, case["ref"]["loss"], what="loss")
    for k, v in case["ref"]["metrics"].items():
        _close(metrics[k], v, what=k)


def test_prefill_matches(case):
    with torch.no_grad():
        lg, cache = tlm.prefill(case["params"], case["cfg"],
                                _tinputs(case), ML)
    _close(lg, case["ref"]["lg0"], what="prefill logits")
    _close_trees(cache, case["ref"]["cache"])


@pytest.mark.parametrize("source", ["reference_cache", "port_cache"])
def test_decode_step_matches(case, source):
    """One decode step on the JAX prefill cache carried across (a fresh
    conversion: decode writes in place) and on the port's own prefill
    cache -> logits and the whole updated cache against the reference's
    decode."""
    with torch.no_grad():
        if source == "reference_cache":
            cache = convert.to_torch(case["ref"]["cache"], device="cpu")
        else:
            _, cache = tlm.prefill(case["params"], case["cfg"],
                                   _tinputs(case), ML)
        tok = _t(case["toks"][:, T]).long()
        lg, new = tlm.decode_step(case["params"], case["cfg"], cache, tok, T)
    assert new is cache                      # written in place
    _close(lg, case["ref"]["lg1"], what="decode logits")
    _close_trees(new, case["ref"]["cache1"])


def test_prefill_decode_equals_forward(case):
    """The port's own invariant at the reference test's 2e-3: prefill of
    T tokens, then one decode step, equals forward over T + 1 (MoE
    dropless everywhere, as there)."""
    cfg = case["cfg"]
    if cfg.n_routed_experts:
        cfg = cfg.with_overrides(
            capacity_factor=cfg.n_routed_experts / cfg.moe_top_k)
    p = case["params"]
    with torch.no_grad():
        lg0, cache = tlm.prefill(p, cfg, _tinputs(case), ML)
        lg1, _ = tlm.decode_step(p, cfg, cache, _t(case["toks"][:, T]).long(),
                                 T)
        h, _, _ = tlm.forward(p, cfg, _tinputs(case, T + 1))
        ref1 = tlm.logits(p, cfg, h[:, -1])
        ref0 = tlm.logits(p, cfg, h[:, T - 1])
    assert float((lg0 - ref0).abs().max()) < INVARIANT_TOL
    assert float((lg1 - ref1).abs().max()) < INVARIANT_TOL


def test_bf16_arch_matches_the_reference():
    """qwen3-4b reduced with bfloat16 weights: forward and one decode step
    on the JAX cache, each within ``BF16_TOL``. XLA may skip a rounding
    to bf16 between fused elementwise ops where torch rounds after each,
    so bf16 results agree to a few bf16 ulps of the values, not to f32
    noise."""
    jcfg = jbase.reduced(jbase.get_config("qwen3-4b")).with_overrides(
        param_dtype="bfloat16")
    tcfg = tbase.reduced(tbase.get_config("qwen3-4b")).with_overrides(
        param_dtype="bfloat16")
    np_params, tparams = make_params(tcfg, seed=3)
    toks, labels, extra = make_inputs(tcfg, seed=3)
    ref = _jax_run(jcfg, np_params, toks, labels, extra)
    c = dict(toks=toks, extra=extra, cfg=tcfg)
    with torch.no_grad():
        h, _, _ = tlm.forward(tparams, tcfg, _tinputs(c))
        assert h.dtype == torch.bfloat16
        _close(h, ref["h"].astype(np.float32), BF16_TOL, "bf16 h")
        cache = convert.to_torch(ref["cache"], device="cpu")
        lg, _ = tlm.decode_step(tparams, tcfg, cache,
                                _t(toks[:, T]).long(), T)
        _close(lg, ref["lg1"].astype(np.float32), BF16_TOL, "bf16 logits")
        loss, _ = tlm.loss_fn(tparams, tcfg, dict(
            _tinputs(c), labels=_t(labels).long()))
        _close(loss, ref["loss"], BF16_TOL, "bf16 loss")


@pytest.mark.parametrize("arch,extra", [
    ("deepseek-moe-16b", []),
    ("xlstm-1.3b", ["--temperature", "0.7"]),
    ("whisper-base", [])])
def test_serve_runs_on_the_cpu(arch, extra, capsys):
    gen, stats = serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                             "--batch", "2", "--prompt-len", "6", "--gen",
                             "4"] + extra)
    assert tuple(gen.shape) == (2, 5)
    assert stats["generated_shape"] == [2, 5]
    assert stats["arch"] == arch + "-reduced"
    assert stats["prefill_s"] >= 0 and stats["decode_tokens_per_s"] > 0
    assert int(gen.min()) >= 0 and int(gen.max()) < 256
    assert '"decode_tokens_per_s"' in capsys.readouterr().out


def test_serve_is_greedy_and_deterministic():
    argv = ["--device", "cpu", "--arch", "qwen3-4b", "--reduced", "--batch",
            "2", "--prompt-len", "5", "--gen", "3"]
    a, _ = serve.main(argv)
    b, _ = serve.main(argv)
    assert torch.equal(a, b)


def test_serve_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-4b", "--reduced"])
