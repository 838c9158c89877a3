#!/usr/bin/env python3
"""How ``torch.profiler`` sees the port's launches, on the card.

    python3 tools/profile_count.py      # one CUDA card; ~2 min

For kernels at ``chip_smoke.py``'s shapes (the CUDA-core flash kernel at
the bench shape, ``policy_rollout[fnn]`` at A = 1, B = 16, ``fnn_rollout``
at A = 1, B = 16, ``aip_rollout_multi`` at A = 25, B = 16 and the
warehouse's at A = 36, B = 16, all T = 128, ``aip_step`` at A = 25,
B = 16, and ``serve_forward`` at the traffic 128-lane slot):
  - "uncounted_ms": ten calls profiled the way ``chip_smoke.py`` read
    them before it counted events (no call inside the profile before the
    timed ones; the device events' ``self_device_time_total`` summed by
    ``key_averages()`` over ten), with that profile's raw device events
    by name (count, ``is_async`` flags, durations);
  - "counted_ms": ``chip_smoke.device_ms`` (every launch counted,
    ``profile_calls``) and "events_ms": CUDA events around ten
    back-to-back calls;
  - "host_vs_device": timed calls in a ``record_function`` range, their
    device events assigned by their own start within the host's range,
    by the start of the runtime call that launched them (same
    correlation id) and by the span the range draws on the device's
    timeline; how far after the host range's start the first starts, and
    how far after its launch each starts (us);
  - "loss_survey": ten profiles as ``profile_calls`` takes them (one
    untimed call, a sleep, the timed calls), the events each found and
    whether the timed ones make whole calls.
Prints one JSON line per kernel and the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

REPS = 10
MARK = "profile_count.timed"


def uncounted(fn):
    """The reading before events were counted -> (ms per call, the raw
    device events of its profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return us * 1e-3 / REPS, dev


def host_vs_device(fn):
    """One untimed call, then ``REPS`` calls in a ``record_function``
    range -> the timed calls' device events counted three ways (their own
    start in the host's range, their launching runtime call's start in it,
    the range's span on the device's timeline), the launching calls'
    names, the first event's start after the host range's and a few
    events' start after their launch's (us): how the host's clock and the
    profiler's device-side clock line up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    mark = MARK
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
    evs = prof.events()
    host = next(e.time_range for e in evs if e.name == mark
                and e.device_type == DeviceType.CPU)
    spans = [e.time_range for e in evs if e.name == mark
             and e.device_type == DeviceType.CUDA]
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and e.name != mark]
    in_host = [e for e in dev if host.start <= e.time_range.start <= host.end]
    ids = {e.id for e in dev}
    launches = {e.id: e for e in evs if e.device_type == DeviceType.CPU
                and e.id in ids and e.name.startswith("cu")}
    by_launch = [e for e in dev if e.id in launches
                 and host.start <= launches[e.id].time_range.start
                 <= host.end]
    return {"by_host_range": len(in_host), "by_launch": len(by_launch),
            "launch_names": sorted({launches[e.id].name for e in by_launch}),
            "device_start_after_launch_us": [round(
                e.time_range.start - launches[e.id].time_range.start, 1)
                for e in by_launch][:4],
            "by_device_span": (sum(spans[0].start <= e.time_range.start
                                   <= spans[0].end for e in dev)
                               if spans else "no span drawn"),
            "first_event_minus_host_start_us": round(
                min(e.time_range.start for e in in_host) - host.start, 3)}


def loss_survey(fn, profiles=10):
    """``profiles`` profiles of ``fn`` as ``profile_calls`` takes them ->
    for each, the device events found and whether they make whole calls
    (``chip_smoke.timed_events``)."""
    out = []
    for _ in range(profiles):
        events, _ = chip_smoke._profile_once(fn, REPS)
        out.append((len(events),
                    chip_smoke.timed_events(events, REPS) is not None))
    return out


def events_ms(fn):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import aip_step as cuda
    layer = chip_smoke.LayerCase("flash_attention",
                                 chip_smoke.FLASH_CASES["bench"], 701, dev)
    policy = chip_smoke.Case("fnn", 1, 16, 128, 14, dev)
    fnn = chip_smoke.Case("fnn", 1, 16, 128, 13, dev)
    multi = chip_smoke.Case("gru", 25, 16, 128, 12, dev)
    wh = chip_smoke.Case("gru", 36, 16, 128, 15, dev, "warehouse")
    step = chip_smoke.Case("gru", 25, 16, 1, 11, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    d = (torch.rand((16, 25, 40), generator=g, device=dev) < 0.3).float()
    h = 0.5 * torch.randn((16, 25, 64), generator=g, device=dev)
    bits = step.bits[0].reshape(25, 16, 4).transpose(0, 1).contiguous()
    serve = chip_smoke.ServeCase("traffic", 128, 1, 101, dev)
    gru = chip_smoke.LayerCase("gru_sequence",
                               chip_smoke.GRU_CASES["bench"], 701, dev)
    rms = chip_smoke.LayerCase("rmsnorm", chip_smoke.RMS_CASES["bench"],
                               702, dev)
    for name, fn, kernel in (
            ("gru_sequence bench", gru.call, "gru_seq_kernel"),
            ("rmsnorm bench", rms.call, "rmsnorm"),
            ("flash_attention[f32] bench", layer.call, "flash_f32_kernel"),
            ("policy_rollout[fnn] A=1 B=16", policy.policy_call,
             "horizon_kernel"),
            ("fnn_rollout A=1 B=16", fnn.rollout_call, "horizon_kernel"),
            ("aip_rollout_multi A=25 B=16", multi.rollout_call,
             "horizon_kernel"),
            ("aip_rollout_multi[warehouse] A=36 B=16", wh.rollout_call,
             "horizon_kernel"),
            ("aip_step A=25 B=16",
             lambda: cuda.aip_step_multi(d, h, *step.aw, bits),
             "step_kernel"),
            ("serve_forward traffic S=128", lambda: serve.call(False),
             "serve_kernel")):
        old_ms, evs = uncounted(fn)
        names = {}
        for e in evs:
            r = names.setdefault(e.name[:70], {"n": 0, "async": 0,
                                               "us": []})
            r["n"] += 1
            r["async"] += int(e.is_async)
            r["us"].append(round(e.time_range.elapsed_us(), 3))
        try:
            counted = chip_smoke.device_ms(fn, reps=REPS, kernel=kernel)
        except AssertionError as e:   # reported, the survey goes on
            counted = f"failed: {e}"
        print(json.dumps({
            "kernel": name, "uncounted_ms": old_ms, "counted_ms": counted,
            "events_ms": events_ms(fn), "raw_device_events": names,
            "host_vs_device": host_vs_device(fn),
            "loss_survey": loss_survey(fn)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
