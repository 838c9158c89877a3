"""The recurrent mixers on "model" (``distributed/act_sharding.py::mixer``)
under the "tp" profile: Mamba at jamba ``reduced()`` through
``tools/torch_lm_shard_smoke.py`` against the one-process port, float32,
within the smoke's bounds, on (data 2, model 2) and (data 1, model 4)
(train, prefill and decode; each rank's bytes the global bytes over its
shards, the mixers' weights left on "model"); and each mixer's products
on rank 0 of a fake (data 1, model 4) process group counted against the
batch-local route's (``act_sharding.batch_local``): a quarter of them,
apart from the pieces that stay whole, and the mLSTM's by whole heads on
a fake (data 1, model 2) group: half; and the smoke's ``--what mixers``
(one layer of each mixer, ``chip_smoke.py`` phase 10 (d)'s check) at
``reduced()``. The xLSTM's steps on ranks are in
``test_torch_lm_mixer_tp_xlstm.py``."""
import pytest
import torch

from test_torch_lm_sharded_steps import STEPS, mixer_check, run_smoke


@pytest.mark.parametrize("world,model", [(4, 2), (4, 4)])
def test_mamba_on_model_matches_the_one_process_port(tmp_path, world, model):
    s = run_smoke(tmp_path, world, ["--arch", "jamba-1.5-large-398b",
                                    "--model", str(model), "--batch", "8",
                                    "--seq", "32", "--what", STEPS])
    assert s["mesh"] == {"data": world // model, "model": model}
    for what in ("step 1 gradients", "prefill cache", "decode cache"):
        assert what in s["worst_share"]
    for r in s["per_rank"]:
        assert r["param_bytes"] == r["param_bytes_expected"]


# the sLSTM's FFN width int(4 / 3 * D) = 64: every rank's share even
D, NH, B, T, CHUNK = 48, 2, 4, 16, 8


def _count(kind, route, mesh=(1, 4)):
    """One layer's forward and backward on rank 0 of a fake (data,
    model) = ``mesh`` group (``tools/torch_lm_mixer_tp_check.py::
    count_layer``) -> the counter's result."""
    from repro_torch.nn import ssm
    g = torch.Generator().manual_seed(0)
    if kind == "mamba":
        p, kw = ssm.mamba_init(g, D), dict(d_state=16, chunk=CHUNK)
    elif kind == "mlstm":
        p, kw = ssm.mlstm_init(g, D, NH), dict(n_heads=NH, chunk=CHUNK)
    else:
        p, kw = ssm.slstm_init(g, D, NH), dict(n_heads=NH, chunk=CHUNK)
    return mixer_check().count_layer(p, kind, NH, kw, (B, T, D), mesh,
                                     route)


def _whole_mlstm_products():
    """The mLSTM's products that every rank of "model" computes whole
    (q, k and the normaliser n stay whole: ``nn/ssm.py::tp_layout``):
    the scores q k^T, the intra-chunk n, q . n and the chunk-end n, each
    chunk, forward and backward (the last chunk's end state, which nothing
    reads, forward only), counted as the route runs them."""
    from repro_torch.distributed import op_analysis
    L, DH, chunks = CHUNK, 2 * D // NH, T // CHUNK
    g = torch.Generator().manual_seed(1)

    def t(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()
    with op_analysis.OpCounter() as c:
        for i in range(chunks):
            q, k = t(L, B, NH, DH), t(L, B, NH, DH)
            w_intra, w_c, n = t(L, L, B, NH), t(L, B, NH), t(L, B, NH, DH)
            outs = [torch.einsum("tbhd,ubhd->tubh", q, k),
                    torch.einsum("tubh,ubhd->tbhd", w_intra, k),
                    torch.einsum("tbhd,tbhd->tbh", q, n)]
            if i < chunks - 1:
                outs.append(torch.einsum("tbh,tbhd->bhd", w_c, k))
            else:
                torch.einsum("tbh,tbhd->bhd", w_c.detach(), k.detach())
            sum(o.sum() for o in outs).backward()
    return c.result()["flops_dot"]


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_each_mixers_products_on_rank0_are_a_quarter(kind):
    """Rank 0's dot FLOPs on "model" = 4: a quarter of the batch-local
    route's (where every rank computes the same rows), the whole pieces
    apart: none for Mamba; the mLSTM's q, k and n products (q, k and v
    themselves contract whole over gathered channels, each rank for its
    share of their columns); the sLSTM's recurrence (``h @ r_all`` each
    step) and nothing else. No weight is gathered whole on "model" but
    the sLSTM's ``r_*``: the forward of Mamba and the mLSTM moves its
    weights by all-to-alls, not all-gathers."""
    tp, bl = _count(kind, "tp"), _count(kind, "batch")
    if kind == "mamba":
        whole = 0.0
    elif kind == "mlstm":
        whole = _whole_mlstm_products()
    else:
        DH = D // NH
        # each step forward, the gradients of r_all and of h (none of the
        # zero state at step 0)
        whole = (3 * T - 1) * 2.0 * B * NH * 4 * DH * DH
    assert tp["flops_dot"] == (bl["flops_dot"] - whole) / 4 + whole, \
        (tp["flops_dot"], bl["flops_dot"], whole)
    assert bl["flops_dot"] > 4 * whole
    gathered = tp["collective_counts"].get("all-gather", 0)
    if kind == "slstm":
        # r_z, r_i, r_f, r_o, and the backward's gathers of w_in's output
        assert gathered >= 4
    else:
        # the mLSTM's forward gathers of xc's and xi's channels and of q
        # and k's columns (their backward: reduce-scatters)
        assert gathered == (4 if kind == "mlstm" else 0), \
            tp["collective_counts"]


def test_the_mlstm_by_whole_heads_splits_every_product():
    """Where "model" divides the heads (2 heads on a fake (data 1, model
    2) group) each rank holds whole heads: rank 0's dot FLOPs are half the
    batch-local route's, nothing computed whole, and no weight gathered
    whole (``wq`` / ``wk`` / ``wv`` move from the rules' split of each
    head's rows by all-to-alls): the one all-gather is the backward of the
    gates' reduce-scatter."""
    tp, bl = _count("mlstm", "tp", (1, 2)), _count("mlstm", "batch", (1, 2))
    assert tp["flops_dot"] * 2 == bl["flops_dot"], (tp["flops_dot"],
                                                    bl["flops_dot"])
    counts = tp["collective_counts"]
    assert counts.get("all-gather", 0) == 1, counts
    assert counts.get("reduce-scatter", 0) == 1, counts
    assert counts.get("all-to-all", 0) >= 3, counts


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_a_width_model_does_not_divide_raises(kind):
    """Under "tp" a mixer whose gathered or scattered width "model" does
    not divide (Mamba's dI 96, the mLSTM's DH 48, the sLSTM's 4 d 192,
    on 5 ranks) raises, rather than running with its weights gathered
    whole."""
    with pytest.raises(ValueError, match="of size 5 does not divide"):
        _count(kind, "tp", (1, 5))


@pytest.mark.parametrize("arch,kinds", [
    ("jamba-1.5-large-398b", ("mamba",)),
    ("xlstm-1.3b", ("mlstm", "slstm")),
])
def test_the_smokes_mixers_mode_holds_one_layer_of_each(tmp_path, arch,
                                                        kinds):
    """``--what mixers`` (``chip_smoke.py`` phase 10 (d) at full width)
    at ``reduced()`` on (data 2, model 2): each mixer's output,
    gradients, prefill state and decode step against one process, float32,
    and each rank's bytes of the layer's weights."""
    s = run_smoke(tmp_path, 4, ["--arch", arch, "--model", "2", "--batch",
                                "4", "--seq", "32", "--what", "mixers"])
    assert sorted(s["mixers"]) == sorted(kinds)
    for kind in kinds:
        for what in ("forward", "gradients", "prefill state", "decode",
                     "decode state"):
            assert f"{kind} {what}" in s["worst_share"]
        for r in s["per_rank"]:
            got, want = r["mixer_bytes"][kind]
            assert got == want > 0
