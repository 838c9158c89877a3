"""The port's serving tier (``repro_torch.serving``,
``repro_torch.launch.policy_serve``) against the JAX package's on the CPU.

Mirrors ``test_serving.py``, ``test_serving_buckets.py`` and
``test_overload.py``:

* the same ``TraceConfig`` gives identical request lists, the schedulers
  pop identical batches, calibration and the admission controller make
  identical decisions;
* the same trace through the JAX ``PolicyServer`` (route ``auto``, its
  plain oracle on the CPU) and the port's, on the virtual clock, gives
  identical ``summary()`` dicts: fixed slot, buckets, four policies and
  the chaos plan (``reload_log`` too);
* ``serve_forward[_multi]``: the port's plain versions against the JAX
  ``ops`` dispatch and the Pallas kernel in interpret mode at both
  domains' full widths, within ``FWD_ATOL`` (one f32 forward), pad and
  unroutable lanes exactly zero, an action may differ only where the
  top-two logits are within ``FLIP_EPS``;
* on the port's CPU route the three bitwise contracts of the serving
  tier (pad contents, lane position, multi vs single policy);
* the reload gates and ``policy_serve --device cpu`` end to end.
"""
import dataclasses
import json

import numpy as np
import pytest

from test_torch_common import FLIP_EPS, FWD_ATOL, to_np, to_t

import jax  # noqa: E402
import torch  # noqa: E402

from repro import serving as jsv  # noqa: E402
from repro.distributed import fault_injection as jfi  # noqa: E402
from repro.envs import api as japi  # noqa: E402
from repro.kernels import aip_step as jaip  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.rl import ppo as jppo  # noqa: E402
from repro_torch import serving as tsv  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.distributed import fault_injection as tfi  # noqa: E402
from repro_torch.envs import api as tapi  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import policy_serve  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

S = 8                                    # the small test slot shape
OBS, ACT = 41, 2                         # traffic widths
WIDTHS = {"traffic": (41, 2), "warehouse": (37 * 8, 5)}   # (D, n_act)
HP = 128                                 # the policy's full hidden width
SVC = 0.002
_cache = {}


def _jparams(seed, hidden=16, obs=OBS, act=ACT):
    key = ("jparams", seed, hidden, obs, act)
    if key not in _cache:
        cfg = jppo.PPOConfig(obs_dim=obs, n_actions=act, hidden=hidden)
        _cache[key] = jppo.init_policy(cfg, jax.random.PRNGKey(seed))
    return _cache[key]


def _servers(params_seeds, slot, **kw):
    """(JAX server, port server) over the same weights; ``params_seeds``
    an int (one policy) or a list (one policy per seed)."""
    if isinstance(params_seeds, int):
        jp = _jparams(params_seeds)
        tp = to_t(jp)
    else:
        jp = [_jparams(s) for s in params_seeds]
        tp = [to_t(p) for p in jp]
    common = dict(obs_dim=OBS, n_actions=ACT, slot=slot, **kw)
    return (jsv.PolicyServer(jp, **common),
            tsv.PolicyServer(tp, device="cpu", **common))


def _trace_cfg(**kw):
    base = dict(n_regions=8, mean_rps=2000.0, horizon_s=0.2,
                frame_dim=OBS, seed=5)
    base.update(kw)
    return base


def _same_requests(a, b):
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert (ra.rid, ra.region, ra.klass, ra.arrival, ra.deadline,
                ra.size, ra.policy) == (rb.rid, rb.region, rb.klass,
                                        rb.arrival, rb.deadline, rb.size,
                                        rb.policy)
        assert ra.frame.dtype == rb.frame.dtype == np.float32
        assert np.array_equal(ra.frame, rb.frame)


# ------------------------------------------------- trace + scheduling

@pytest.mark.parametrize("variant", ["uniform", "bimodal", "policies"])
def test_trace_identical_in_both_packages(variant):
    kw = _trace_cfg()
    if variant == "bimodal":
        kw.update(region_sizes=tsv.BIMODAL_SIZES,
                  region_size_weights=tsv.BIMODAL_WEIGHTS, n_regions=20)
    if variant == "policies":
        kw.update(n_policies=3)
    assert tsv.BIMODAL_SIZES == jsv.BIMODAL_SIZES
    assert tsv.BIMODAL_WEIGHTS == jsv.BIMODAL_WEIGHTS
    a = jsv.synthetic_trace(jsv.TraceConfig(**kw))
    b = tsv.synthetic_trace(tsv.TraceConfig(**kw))
    _same_requests(a, b)
    pool = np.random.default_rng(1).standard_normal((5, OBS)).astype(
        np.float32)
    _same_requests(jsv.synthetic_trace(jsv.TraceConfig(**kw), pool),
                   tsv.synthetic_trace(tsv.TraceConfig(**kw), pool))
    _same_requests(jsv.flood_trace(a, 0.05, 0.05, 3),
                   tsv.flood_trace(b, 0.05, 0.05, 3))


def _drive(pkg, trace, buckets, service_s=0.003):
    """The server's replay loop, scheduler only -> (sched, [(shape,
    rids)])."""
    sched = (pkg.BucketedSlotScheduler(buckets) if len(buckets) > 1
             else pkg.SlotScheduler(buckets[0]))
    pops, now, i = [], 0.0, 0
    while i < len(trace) or sched.pending:
        while i < len(trace) and trace[i].arrival <= now:
            sched.admit(trace[i])
            i += 1
        if not sched.pending:
            now = trace[i].arrival
            continue
        shape, batch = sched.next_dispatch()
        now += service_s
        sched.complete(batch, now)
        pops.append((shape, [r.rid for r in batch]))
    return sched, pops


@pytest.mark.parametrize("buckets", [(1,), (3,), (8,), (2, 4, 8)])
def test_schedulers_pop_identical_batches(buckets):
    kw = _trace_cfg(region_sizes=(1, 2, 4, 8), classes_s=(0.0, 0.004, 0.02))
    js, jpops = _drive(jsv, jsv.synthetic_trace(jsv.TraceConfig(**kw)),
                       buckets)
    ts, tpops = _drive(tsv, tsv.synthetic_trace(tsv.TraceConfig(**kw)),
                       buckets)
    assert tpops == jpops
    assert ts.completions == js.completions
    assert (ts.deadline_misses, ts.misses_by_class, ts.max_queue_depth) == \
        (js.deadline_misses, js.misses_by_class, js.max_queue_depth)
    assert ts.deadline_misses > 0                  # zero-slack class
    served = sorted(r for _, b in tpops for r in b)
    assert served == list(range(ts.admitted))      # no drops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_identical(seed):
    kw = _trace_cfg(n_regions=40, region_sizes=tsv.BIMODAL_SIZES,
                    region_size_weights=tsv.BIMODAL_WEIGHTS, seed=seed)
    jt = jsv.synthetic_trace(jsv.TraceConfig(**kw))
    tt = tsv.synthetic_trace(tsv.TraceConfig(**kw))
    assert tsv.burst_sizes(tt) == jsv.burst_sizes(jt)
    prev = None
    for k in (1, 2, 3, 4):
        b = tsv.calibrate_buckets(tt, max_buckets=k, max_slot=128)
        assert b == jsv.calibrate_buckets(jt, max_buckets=k, max_slot=128)
        w = tsv.expected_padded_waste(tsv.burst_sizes(tt), b, max_slot=128)
        assert w == jsv.expected_padded_waste(jsv.burst_sizes(jt), b,
                                              max_slot=128)
        assert prev is None or w <= prev           # monotone in budget
        prev = w


def test_admission_decisions_identical():
    """One admission controller per package over the same 3x-overload
    trace and dispatch feedback: identical admit/shed decisions, brownout
    levels and coarse toggles; config validation raises alike."""
    kw = _trace_cfg(mean_rps=3 * S / SVC, horizon_s=0.1,
                    region_sizes=(1, 2, 4), classes_s=(0.01, 0.05, 0.25))
    logs = []
    for pkg in (jsv, tsv):
        trace = pkg.synthetic_trace(pkg.TraceConfig(**kw))
        adm = pkg.AdmissionController(pkg.OverloadConfig(
            default_latency_s=SVC, queue_cap=64))
        sched = pkg.BucketedSlotScheduler((2, 4, S))
        stats = pkg.ServeStats()
        log, now = [], 0.0
        for i, req in enumerate(trace):
            now = req.arrival
            log.append((adm.admit(req, now, sched, stats),
                        adm.brownout.level, sched.coarse))
            if i % 16 == 15 and sched.pending:
                shape, batch = sched.next_dispatch()
                sched.complete(batch, now)
                adm.observe_dispatch(shape, SVC * (1 + i % 5), sched)
        logs.append((log, stats.summary(), adm.brownout.entries,
                     adm.brownout.exits))
    assert logs[0] == logs[1]
    assert logs[1][1]["rejected"] > 0 and logs[1][2] > 0
    for bad in (dict(queue_cap=0), dict(ewma_alpha=0.0),
                dict(brownout_enter_s=0.01, brownout_exit_s=0.02),
                dict(brownout_hold=0), dict(max_level=0)):
        with pytest.raises(ValueError):
            tsv.OverloadConfig(**bad)


# ---------------------------------------- virtual replays, both servers

def _replay_pair(jsrv, tsrv, cfg_kw, **serve_kw):
    jt = jsv.synthetic_trace(jsv.TraceConfig(**cfg_kw))
    tt = tsv.synthetic_trace(tsv.TraceConfig(**cfg_kw))
    jk, tk = dict(serve_kw), dict(serve_kw)
    if "admission" in serve_kw:
        jk["admission"] = jsv.AdmissionController(jsv.OverloadConfig(
            default_latency_s=SVC))
        tk["admission"] = tsv.AdmissionController(tsv.OverloadConfig(
            default_latency_s=SVC))
    if "faults" in serve_kw:
        jk["faults"] = jfi.FaultInjector(
            jfi.parse_serve_faults(serve_kw["faults"]))
        tk["faults"] = tfi.FaultInjector(
            tfi.parse_serve_faults(serve_kw["faults"]))
    jrep = jsrv.serve(jt, mode="virtual", service_time_s=SVC, **jk)
    trep = tsrv.serve(tt, mode="virtual", service_time_s=SVC, **tk)
    assert trep.summary() == jrep.summary()
    assert trep.latencies_s == jrep.latencies_s
    return jrep, trep, jk, tk


@pytest.mark.parametrize("case", ["fixed", "buckets", "n_policies_4"])
def test_virtual_replay_summary_identical(case):
    if case == "fixed":
        jsrv, tsrv = _servers(0, S)
        kw = _trace_cfg()
    elif case == "buckets":
        jsrv, tsrv = _servers(0, (2, 8, 32))
        kw = _trace_cfg(n_regions=20, region_sizes=tsv.BIMODAL_SIZES,
                        region_size_weights=tsv.BIMODAL_WEIGHTS)
    else:
        jsrv, tsrv = _servers([0, 1, 2, 3], (4, 16))
        kw = _trace_cfg(n_policies=4)
    jrep, trep, _, _ = _replay_pair(jsrv, tsrv, kw)
    assert trep.served == trep.requests > 0
    assert tsrv.state == jsrv.state == "drained"
    if case == "buckets":
        assert set(trep.stats.dispatches_by_slot) > {32}


def test_chaos_replay_identical_with_reload_log():
    """Admission + slow dispatch + flood + a NaN-poisoned hot reload and
    a clean one: identical summaries, the corrupt reload rejected by the
    canary in both packages, and both plans exhausted."""
    jsrv, tsrv = _servers(0, S)
    jrep, trep, jk, tk = _replay_pair(
        jsrv, tsrv, _trace_cfg(mean_rps=6000.0),
        admission=True, faults="slow:2:0.05,flood:0.02:0.05:3,corrupt:0:nan",
        reload_at=(3, 6))
    jk["faults"].assert_exhausted()
    tk["faults"].assert_exhausted()
    assert tk["faults"].applied_counts() == jk["faults"].applied_counts()
    assert [tuple(e) for e in tsrv.reload_log] == \
        [tuple(e) for e in jsrv.reload_log]
    assert [t for t, _ in tsrv.reload_log] == ["rejected", "ok"]
    assert "canary" in tsrv.reload_log[0][1]
    assert trep.stats.reload_rejected == 1 and trep.stats.reloads == 1
    assert trep.stats.rejected > 0 and tsrv.policy_version == 1


# ------------------------------------ serve_forward plain vs the JAX one

def _flat(rng, D, n_act, N=None):
    """Policy weights at width D, hidden HP, scaled like the init."""
    lead = () if N is None else (N,)

    def w(*s):
        return (rng.standard_normal(lead + s) / np.sqrt(s[0])).astype(
            np.float32)

    def b(n):
        return (0.1 * rng.standard_normal(lead + (n,))).astype(np.float32)

    return (w(D, HP), b(HP), w(HP, HP), b(HP), w(HP, n_act), b(n_act),
            w(HP, 1), b(1))


def _slot(rng, n, D, junk=np.nan, n_valid=None):
    frames = rng.standard_normal((n, D)).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.int32)
    if n_valid is not None:
        mask[:] = 0
        mask[:n_valid] = 1
    frames[mask == 0] = junk
    return frames, mask


def _check_against(port, jax_out, mask):
    (plg, pv), (jlg, jv) = port, jax_out
    plg, pv = to_np(plg), to_np(pv)
    jlg, jv = np.asarray(jlg), np.asarray(jv)
    off = mask == 0
    assert not plg[off].any() and not pv[off].any()
    np.testing.assert_allclose(plg, jlg, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(pv, jv, atol=FWD_ATOL, rtol=0)
    flips = plg.argmax(-1) != jlg.argmax(-1)
    top2 = np.sort(jlg, axis=-1)[:, -2:]
    assert not (flips & (top2[:, 1] - top2[:, 0] >= FLIP_EPS)).any()


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
def test_serve_forward_plain_matches_jax(domain):
    D, n_act = WIDTHS[domain]
    rng = np.random.default_rng(3)
    pw = _flat(rng, D, n_act)
    frames, mask = _slot(rng, 16, D, junk=0.0)
    port = ops.serve_forward(to_t(frames), to_t(mask),
                             ref.fuse_head(tuple(to_t(w) for w in pw)),
                             fast_gates=True)
    _check_against(port, jops.serve_forward(frames, mask, pw,
                                            fast_gates=True), mask)
    _check_against(port, jaip.serve_forward(frames, mask, pw,
                                            fast_gates=True,
                                            interpret=True), mask)
    exact = ref.serve_forward_ref(ref.fuse_head(tuple(to_t(w) for w in pw)),
                                  to_t(frames), to_t(mask), fast_gates=False)
    _check_against(exact, jops.serve_forward(frames, mask, pw,
                                             fast_gates=False), mask)


@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
def test_serve_forward_multi_plain_matches_jax(domain):
    D, n_act = WIDTHS[domain]
    N = 3
    rng = np.random.default_rng(4)
    pws = _flat(rng, D, n_act, N)
    frames, mask = _slot(rng, 16, D, junk=0.0)
    mask[:] = 1
    pidx = rng.integers(0, N, 16).astype(np.int32)
    pidx[[2, 9]] = [N + 2, -1]                     # unroutable lanes
    mask[5] = 0
    port = ops.serve_forward_multi(
        to_t(frames), to_t(mask), to_t(pidx),
        ref.fuse_head(tuple(to_t(w) for w in pws)), fast_gates=True)
    routed = mask * ((pidx >= 0) & (pidx < N))
    _check_against(port, jops.serve_forward_multi(
        frames, mask, pidx, pws, fast_gates=True), routed)
    _check_against(port, jaip.serve_forward_multi(
        frames, mask, pidx, pws, fast_gates=True, interpret=True), routed)


# --------------------------------- the bitwise contracts, CPU route

def _cpu_fwd(frames, mask, pidx, fws):
    if pidx is None:
        return ops.serve_forward(frames, mask, fws, fast_gates=True)
    return ops.serve_forward_multi(frames, mask, pidx, fws,
                                   fast_gates=True)


@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("domain", ["traffic", "warehouse"])
def test_cpu_route_bitwise_contracts(domain, n):
    """Pad contents and lane position never change a real lane's
    outputs, and a lane of the multi-policy forward is the single-policy
    forward of its checkpoint, all bitwise at one slot shape."""
    D, n_act = WIDTHS[domain]
    rng = np.random.default_rng(n)
    N = 4
    pws = ref.fuse_head(tuple(to_t(w) for w in _flat(rng, D, n_act, N)))
    frames, mask = _slot(rng, n, D, junk=0.0)
    pidx = to_t(rng.integers(0, N, n).astype(np.int32))
    f, m = to_t(frames), to_t(mask)
    real = m != 0
    single = tuple(w[1] for w in pws)
    base = _cpu_fwd(f, m, None, single)
    for junk in (1e6, np.nan, -np.inf):
        fj = f.clone()
        fj[~real] = junk
        for a, b in zip(base, _cpu_fwd(fj, m, None, single)):
            assert torch.equal(a[real], b[real])
            assert not b[~real].any()
    perm = torch.from_numpy(rng.permutation(n))
    for a, b in zip(base, _cpu_fwd(f[perm], m[perm], None, single)):
        assert torch.equal(a[perm], b)
    multi = _cpu_fwd(f, m, pidx, pws)
    for k in range(N):
        own = _cpu_fwd(f, m, None, tuple(w[k] for w in pws))
        sel = pidx == k
        for a, b in zip(multi, own):
            assert torch.equal(a[sel], b[sel])


def test_pad_helpers_and_stack_abi_match_jax():
    tree = {"x": np.arange(6.0, dtype=np.float32).reshape(3, 2),
            "y": np.arange(3, dtype=np.int32)}
    for fill in ("edge", "zero"):
        j = japi.pad_lanes(tree, 5, fill=fill)
        t = tapi.pad_lanes(to_t(tree), 5, fill=fill)
        for k in tree:
            assert np.array_equal(to_np(t[k]), np.asarray(j[k]))
            assert t[k].dtype == to_t(tree)[k].dtype
    with pytest.raises(ValueError):
        tapi.pad_lanes(to_t(tree), 2)
    with pytest.raises(ValueError):
        tapi.pad_lanes(to_t(tree), 5, fill="wrap")
    assert np.array_equal(to_np(tapi.pad_mask(3, 5)),
                          np.asarray(japi.pad_mask(3, 5)))
    jps = [_jparams(s) for s in (0, 1)]
    jst = jppo.stack_policy_weights(jps)
    tst = ppo.stack_policy_weights([to_t(p) for p in jps])
    assert len(tst) == len(jst) == 8
    for a, b in zip(tst, jst):
        assert np.array_equal(to_np(a), np.asarray(b))


# ------------------------------------------------------- the server

def _tserver(seed=0, slot=S, hidden=16, **kw):
    return tsv.PolicyServer(to_t(_jparams(seed, hidden)), obs_dim=OBS,
                            n_actions=ACT, slot=slot, device="cpu", **kw)


def _probe(srv):
    return srv.forward_slot(srv._probe_frames, srv.slots[0],
                            srv._probe_pidx(srv.slots[0]))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_server_matches_jax_server_and_routes():
    """``forward_slot`` of the port's server against the JAX server's on
    NaN-padded slots (auto and the policy_forward / xla route), pad
    lanes zero; the two port routes agree on logits within FWD_ATOL;
    the interpret route and unknown routes are refused."""
    jsrv, tsrv = _servers(0, S)
    frames, _ = _slot(np.random.default_rng(0), S, OBS)
    for n_valid in (1, 5, S):
        fr = frames.copy()
        fr[n_valid:] = np.nan
        ja, jl, jv = jsrv.forward_slot(fr, n_valid)
        ta, tl, tv = tsrv.forward_slot(fr, n_valid)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=FWD_ATOL)
        np.testing.assert_allclose(to_np(tv), np.asarray(jv), atol=FWD_ATOL)
        assert not tl[n_valid:].any() and not ta[n_valid:].any()
    pf = tsv.PolicyServer(to_t(_jparams(0)), obs_dim=OBS, n_actions=ACT,
                          slot=S, route="policy_forward", device="cpu")
    fr = np.nan_to_num(frames)
    a1, l1, v1 = tsrv.forward_slot(fr, S)
    a2, l2, v2 = pf.forward_slot(fr, S)
    np.testing.assert_allclose(to_np(l1), to_np(l2), atol=FWD_ATOL)
    np.testing.assert_allclose(to_np(v1), to_np(v2), atol=FWD_ATOL)
    for route in ("interpret", "xla"):
        with pytest.raises(ValueError):
            tsv.PolicyServer(to_t(_jparams(0)), obs_dim=OBS, n_actions=ACT,
                             route=route, device="cpu")
    with pytest.raises(ValueError):
        _tserver(slot=(0, 8))


def test_staging_reused_and_multi_server_lanes():
    """One staging buffer per shape, reused, tail never re-padded (and
    harmless); a lane of a multi-policy server equals its checkpoint's
    single server bitwise, unroutable lanes zero."""
    tp = [to_t(_jparams(s)) for s in (0, 1)]
    srv = tsv.PolicyServer(tp, obs_dim=OBS, n_actions=ACT, slot=(4, S),
                           device="cpu")
    frames, _ = _slot(np.random.default_rng(1), S, OBS)
    frames = np.nan_to_num(frames)
    reqs = [tsv.Request(rid=i, region=0, klass=0, arrival=0.0, deadline=1.0,
                        frame=frames[i], policy=i % 2) for i in range(S)]
    f_full, p_full = srv._pack(reqs, S)
    f_again, p_again = srv._pack(reqs[:3], S)
    assert f_again is f_full and p_again is p_full
    assert np.array_equal(to_np(f_full[3:]), frames[3:])
    assert srv._pack(reqs[:2], 4)[0].shape == (4, OBS)
    dirty = srv.forward_slot(f_full, 3, p_full)
    clean = np.zeros_like(frames)
    clean[:3] = frames[:3]
    assert _same(dirty, srv.forward_slot(clean, 3, p_full))
    pidx = np.arange(S, dtype=np.int32) % 2
    multi = srv.forward_slot(frames, S, pidx)
    for k in range(2):
        one = tsv.PolicyServer(tp[k], obs_dim=OBS, n_actions=ACT, slot=S,
                               device="cpu").forward_slot(frames, S)
        sel = torch.from_numpy(pidx == k)
        assert all(torch.equal(a[sel], b[sel]) for a, b in zip(multi, one))
    pidx[1] = 7
    _, lg, v = srv.forward_slot(frames, S, pidx)
    assert not lg[1].any() and v[1] == 0.0
    assert isinstance(srv.make_scheduler(), tsv.BucketedSlotScheduler)
    srv.warmup()
    assert srv._warmed >= {4, S}


def test_reload_gates():
    """Accept (live == fresh server, bitwise), reject ABI mismatches and
    NaN/inf poison, roll back to the old weights every time."""
    srv = _tserver(0)
    before = _probe(srv)
    assert not srv.reload(to_t(_jparams(1, hidden=32)))
    assert not srv.reload([to_t(_jparams(1))])
    assert not srv.reload({"nonsense": torch.zeros(3)})
    for mode in ("nan", "huge"):
        assert not srv.reload(tfi.corrupt_tree(to_t(_jparams(7)), mode))
        assert "canary" in srv.reload_log[-1][1]
    assert srv.reload_rejected == 5 and srv.policy_version == 0
    assert _same(before, _probe(srv))
    assert srv.reload(to_t(_jparams(7)))
    assert _same(_probe(srv), _probe(_tserver(7)))
    assert not _same(before, _probe(srv))
    assert srv.reload_log[-1] == ("ok", "v1")
    with pytest.raises(ValueError):
        tfi.corrupt_tree(to_t(_jparams(0)), mode="bogus")


def test_reload_from_checkpoint_good_and_torn(tmp_path):
    srv = _tserver(0)
    good = tmp_path / "good"
    ckpt.save(good, 3, {"policy": to_t(_jparams(7))})
    assert srv.reload_from_checkpoint(good)
    assert _same(_probe(srv), _probe(_tserver(7)))
    before = _probe(srv)
    for tear in ("tmp-only", "no-commit", "truncated", "torn-meta"):
        torn = tmp_path / f"torn_{tear}"
        tfi.torn_save(torn, 1, {"policy": to_t(_jparams(2))}, tear=tear)
        assert not srv.reload_from_checkpoint(torn), tear
        assert "restore" in srv.reload_log[-1][1]
    assert srv.reload_rejected == 4
    assert _same(before, _probe(srv))
    multi = tsv.PolicyServer([to_t(_jparams(0)), to_t(_jparams(1))],
                             obs_dim=OBS, n_actions=ACT, slot=S,
                             device="cpu")
    with pytest.raises(ValueError):
        multi.reload_from_checkpoint(good)


def test_lifecycle_drain_and_zero_dispatch_edges():
    srv = _tserver(0)
    assert srv.state == "warming"
    sched = tsv.SlotScheduler(S)
    frame = np.zeros(OBS, np.float32)
    for i in range(3 * S):
        sched.admit(tsv.Request(rid=i, region=0, klass=0, arrival=0.0,
                                deadline=1.0, frame=frame))
    stats, done = srv.drain(sched, service_time_s=SVC)
    assert srv.state == "drained" and stats.final_state == "drained"
    assert stats.dispatches == 3 and done == pytest.approx(3 * SVC)
    rep = _tserver(0).serve([], mode="virtual", service_time_s=SVC)
    assert (rep.requests, rep.served, rep.qps) == (0, 0, 0.0)
    assert rep.summary() == jsv.ServeReport(
        0, 0, 0.0, 0.0, 0.0, 0, {}, 0, 0, 0.0,
        stats=dataclasses.replace(jsv.ServeStats(),
                                  final_state="drained")).summary()
    with pytest.raises(ValueError):
        srv.serve([], mode="closed-loop")


# --------------------------------------------------------- entry point

TINY = ["--device", "cpu", "--regions", "4", "--rps", "400",
        "--duration-s", "0.05"]


def test_policy_serve_end_to_end(tmp_path):
    out = tmp_path / "serve.json"
    res = policy_serve.main(TINY + ["--slot", "8", "--out", str(out)])
    assert res["served"] == res["requests"] > 0
    assert res["p99_ms"] >= res["p50_ms"] > 0 and res["device"] == "cpu"
    assert json.loads(out.read_text()) == res
    res2 = policy_serve.main(TINY + ["--slot", "16", "--calibrate", "2",
                                     "--bimodal", "--n-policies", "2",
                                     "--regions", "6"])
    assert res2["served"] == res2["requests"] > 0
    assert res2["calibrated"] and isinstance(res2["slot"], list)
    assert sum(res2["dispatches_by_slot"].values()) == res2["dispatches"]


def test_policy_serve_chaos_and_checkpoint(tmp_path):
    res = policy_serve.main([
        "--device", "cpu", "--slot", "16", "--regions", "8", "--rps",
        "4000", "--duration-s", "0.1", "--virtual", "--service-time-s",
        "0.002", "--admission", "--faults",
        "slow:2:0.05,flood:0.02:0.05:3,corrupt:0:nan", "--reload-at", "1"])
    assert res["final_state"] == "drained"
    assert res["reload_rejected"] == 1 and res["policy_version"] == 0
    assert res["faults_applied"] == {"SlowDispatch": 1, "RequestFlood": 1,
                                     "CorruptCheckpoint": 1}
    assert res["served"] + res["rejected"] == res["requests"]
    with pytest.raises(ValueError):
        policy_serve.main(TINY + ["--faults", "bogus:1"])
    # an rl_train-layout checkpoint written by the JAX package
    from repro.checkpoint import ckpt as jckpt
    pol = _jparams(9, hidden=128)
    jckpt.save(tmp_path / "ck", 5, {"policy": pol, "opt": {
        "m": jax.numpy.zeros((4, 4))}}, metadata={"it": 5})
    args = policy_serve.parse_args(TINY + ["--ckpt-dir",
                                           str(tmp_path / "ck")])
    srv, _, info = policy_serve.build_server_and_trace(args)
    assert info["restored_step"] == 5 and info["ckpt_metadata"] == {"it": 5}
    for a, b in zip(jax.tree_util.tree_leaves(pol),
                    tree_leaves(srv._params)):
        assert np.array_equal(np.asarray(a), to_np(b))
    res3 = policy_serve.main(TINY + ["--ckpt-dir", str(tmp_path / "ck")])
    assert res3["served"] == res3["requests"] > 0


def test_policy_serve_warehouse_and_missing_card():
    """``--domain warehouse`` serves slots of 8 stacked 37-wide frames to
    5 actions; without a card the default device raises, on either
    domain."""
    res = policy_serve.main(TINY + ["--domain", "warehouse", "--slot", "8"])
    assert res["domain"] == "warehouse"
    assert res["served"] == res["requests"] > 0
    srv, trace, _ = policy_serve.build_server_and_trace(
        policy_serve.parse_args(TINY + ["--domain", "warehouse"]))
    assert trace[0].frame.shape[-1] == 296
    assert srv._params["pi"]["w"].shape == (128, 5)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for domain in ("traffic", "warehouse"):
        with pytest.raises(RuntimeError, match="cuda"):
            policy_serve.main(["--domain", domain, "--regions", "2",
                               "--duration-s", "0.01"])
