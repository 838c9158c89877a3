"""Serving tier: continuous-batching policy inference under latency bounds
(counterpart of ``repro.serving``, the same exports).

The deployment half of the paper's claim — a trained IALS policy acting
in the real networked system for heavy request traffic. Four pieces
(the serving contract + overload contract, docs/ARCHITECTURE.md §8):

- ``request.py`` — the request model (agent-region id, frame-stacked
  observation, region burst size, per-region checkpoint index, deadline
  class) and a deterministic synthetic open-loop traffic generator:
  thousands of heterogeneous agent regions with ragged grid sizes and
  staggered episode phases, optionally bimodal in burst size;
  ``flood_trace`` densifies a window of it for flood chaos events.
- ``scheduler.py`` — ``SlotScheduler``: packs in-flight requests into
  fixed-shape slots, earliest-deadline-first, FIFO within a deadline
  class, no silent drops, exact deadline-miss accounting.
  ``BucketedSlotScheduler`` right-sizes every dispatch into the
  smallest compiled slot shape that admits it (``set_coarse`` collapses
  it to the largest shape under brownout); ``calibrate_buckets`` picks
  the shape set offline from a trace's burst-size distribution.
- ``overload.py`` — the policy layer the drop-free schedulers refuse to
  be: ``AdmissionController`` (bounded queue + deadline-feasibility
  rejection on an EWMA of measured dispatch latency), and
  ``BrownoutController`` (graceful degradation with hysteresis —
  sheds the loosest deadline classes first, never the tightest).
  Every shed is explicit and counted, never a silent miss.
- ``server.py`` — ``PolicyServer``: drives packed slots through the
  masked slot forward (``kernels/ops.py::serve_forward``, a hand-written
  CUDA kernel on the card, every slot shape warmed before the clock
  starts), optionally batching N checkpoints per dispatch
  (``kernels/ops.py::serve_forward_multi``), replays open-loop traces
  through the warming -> serving -> draining -> drained lifecycle with
  optional admission control and deterministic fault injection, hot
  reloads weights atomically behind an ABI + canary + bitwise-parity
  gate (``reload``; failures roll back), and reports p50/p99 latency +
  sustained QPS + padded-lane waste + shed/reload accounting
  (``ServeStats``).
"""
from repro_torch.serving.overload import (AdmissionController,
                                          BrownoutController,
                                          DispatchLatencyModel,
                                          OverloadConfig)
from repro_torch.serving.request import (BIMODAL_SIZES, BIMODAL_WEIGHTS,
                                         Request, TraceConfig, flood_trace,
                                         synthetic_trace)
from repro_torch.serving.scheduler import (BucketedSlotScheduler,
                                           SlotScheduler, burst_sizes,
                                           calibrate_buckets,
                                           expected_padded_waste)
from repro_torch.serving.server import PolicyServer, ServeReport, ServeStats

__all__ = ["Request", "TraceConfig", "synthetic_trace", "flood_trace",
           "BIMODAL_SIZES", "BIMODAL_WEIGHTS", "SlotScheduler",
           "BucketedSlotScheduler", "burst_sizes", "calibrate_buckets",
           "expected_padded_waste", "OverloadConfig", "AdmissionController",
           "BrownoutController", "DispatchLatencyModel", "PolicyServer",
           "ServeReport", "ServeStats"]
