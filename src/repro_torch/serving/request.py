"""The serving request model + deterministic synthetic open-loop traffic
(counterpart of ``repro/serving/request.py``: numpy and dataclasses only,
the same draws in the same order, so one ``TraceConfig`` gives the same
trace in both packages).

A ``Request`` is one agent region asking for actions on one frame-stacked
observation before a deadline. Traffic is *open-loop*: arrival times are
fixed by the trace, not by how fast the server answers — the standard way
to measure a serving system honestly (a closed loop self-throttles and
hides queueing collapse).

``synthetic_trace`` models the north-star workload shape: ``n_regions``
heterogeneous agent regions with ragged sizes (a region of size k submits
k requests per episode tick — one per agent lane of its grid) and
staggered episode phases (each region's tick train has its own phase
offset, so bursts interleave instead of beating in sync). Every draw
comes from one seeded ``numpy.random.Generator``, so a trace is a pure
function of its config — the property tests replay exact traces.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One action request: ``frame`` is the (frame_stack * obs_dim,) f32
    observation the policy acts on; ``deadline`` is absolute
    (``arrival + deadline class bound``), which is what makes
    earliest-deadline-first scheduling FIFO within a class.

    ``size`` is the request's *size class* — the lane count of the region
    burst it arrived in (a size-k region submits k requests per tick, all
    sharing ``size=k``). It is what the bucketed scheduler's admission
    rule keys on: the smallest compiled slot shape >= ``size`` is the
    burst's admissible bucket (``scheduler.py::BucketedSlotScheduler``).
    ``policy`` is the region-family checkpoint index for cross-policy
    batched serving (``kernels/ops.py::serve_forward_multi``): one
    server, many checkpoints, one policy per region family."""
    rid: int            # unique, assigned in arrival order
    region: int         # agent-region id (which grid submitted it)
    klass: int          # deadline-class index into TraceConfig.classes_s
    arrival: float      # seconds since trace start (open-loop, fixed)
    deadline: float     # absolute seconds: arrival + classes_s[klass]
    frame: np.ndarray   # (frame_dim,) f32
    size: int = 1       # lanes in this request's region burst (size class)
    policy: int = 0     # region-family checkpoint index (multi-tenant)


@dataclass(frozen=True)
class TraceConfig:
    """Synthetic open-loop traffic shape. ``mean_rps`` is the aggregate
    offered load; each region ticks with a common period ``L / mean_rps``
    (L = total agent lanes) at its own random phase, submitting one
    request per lane per tick, so region size is exactly its traffic
    share and bursts stay staggered.

    ``region_size_weights`` (same length as ``region_sizes``; ``None`` =
    uniform) skews the region-size draw — the bimodal serving workload
    (many tiny regions plus a few large ones) is just a weighted size
    distribution, e.g. ``region_sizes=(1, 2, 4, 64)`` with weights
    ``(0.72, 0.18, 0.06, 0.04)``. ``n_policies`` > 1 assigns each region
    to a checkpoint family (``region % n_policies``) for cross-policy
    batched serving; every request carries its region's ``policy``."""
    n_regions: int = 64
    region_sizes: Tuple[int, ...] = (1, 2, 4, 8)   # ragged grid sizes
    mean_rps: float = 2000.0
    horizon_s: float = 1.0
    classes_s: Tuple[float, ...] = (0.005, 0.025, 0.1)
    class_mix: Tuple[float, ...] = (0.25, 0.5, 0.25)
    frame_dim: int = 41
    seed: int = 0
    region_size_weights: Optional[Tuple[float, ...]] = None
    n_policies: int = 1


#: The bimodal serving workload of the serve bench's bucketed-vs-single
#: rows: mostly tiny regions (1-4 lanes — each tick would ride a mostly
#: padded lane batch at one big compiled slot shape) plus a 4% family of
#: 64-lane regions that carry roughly half the request volume.
BIMODAL_SIZES: Tuple[int, ...] = (1, 2, 4, 64)
BIMODAL_WEIGHTS: Tuple[float, ...] = (0.72, 0.18, 0.06, 0.04)


def flood_trace(trace: List[Request], at_s: float, duration_s: float,
                multiplier: int) -> List[Request]:
    """Deterministic traffic spike: every request arriving in
    ``[at_s, at_s + duration_s)`` is duplicated to ``multiplier`` copies
    (same arrival, class, absolute deadline, frame, burst size — the
    extra copies model more lanes arriving at once), rids reassigned
    dense in arrival order. The trace transform behind the
    ``RequestFlood`` fault event
    (``distributed/fault_injection.py::RequestFlood``): open-loop
    arrivals stay open-loop, just ``multiplier``× denser over the
    window. A pure function of its inputs — two floods of the same
    trace are identical."""
    if multiplier < 1:
        raise ValueError(f"multiplier must be >= 1, got {multiplier}")
    out: List[Request] = []
    for req in trace:
        copies = (multiplier if at_s <= req.arrival < at_s + duration_s
                  else 1)
        out.extend([req] * copies)
    # input is arrival-sorted and copies are adjacent, so order is kept
    return [dataclasses.replace(req, rid=i) for i, req in enumerate(out)]


def synthetic_trace(cfg: TraceConfig,
                    frame_pool: Optional[np.ndarray] = None
                    ) -> List[Request]:
    """-> arrival-sorted requests, rids dense in arrival order.

    ``frame_pool`` (N, frame_dim) supplies real observation frames (e.g.
    engine-rollout states) sampled per request; absent, frames are unit
    normal — the forward cost is data-independent, so latency numbers are
    identical either way."""
    rng = np.random.default_rng(cfg.seed)
    weights = cfg.region_size_weights
    if weights is not None:
        if len(weights) != len(cfg.region_sizes):
            raise ValueError(
                f"region_size_weights has {len(weights)} entries for "
                f"{len(cfg.region_sizes)} region_sizes")
        w = np.asarray(weights, dtype=np.float64)
        weights = w / w.sum()
    sizes = rng.choice(np.asarray(cfg.region_sizes), size=cfg.n_regions,
                       p=weights)
    total_lanes = int(sizes.sum())
    period = total_lanes / cfg.mean_rps
    phases = rng.uniform(0.0, period, size=cfg.n_regions)
    mix = np.asarray(cfg.class_mix, dtype=np.float64)
    mix = mix / mix.sum()

    events = []          # (arrival, region, klass, lanes)
    for region in range(cfg.n_regions):
        t = float(phases[region])
        while t < cfg.horizon_s:
            klass = int(rng.choice(len(cfg.classes_s), p=mix))
            events.append((t, region, klass, int(sizes[region])))
            t += period
    events.sort(key=lambda e: (e[0], e[1]))

    out: List[Request] = []
    for arrival, region, klass, lanes in events:
        for _ in range(lanes):
            if frame_pool is not None:
                frame = np.asarray(
                    frame_pool[rng.integers(0, len(frame_pool))],
                    dtype=np.float32)
            else:
                frame = rng.standard_normal(cfg.frame_dim).astype(
                    np.float32)
            out.append(Request(rid=len(out), region=region, klass=klass,
                               arrival=arrival,
                               deadline=arrival + cfg.classes_s[klass],
                               frame=frame, size=lanes,
                               policy=region % cfg.n_policies))
    return out
