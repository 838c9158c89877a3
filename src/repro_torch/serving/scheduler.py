"""Continuous-batching slot schedulers: EDF, FIFO-in-class, no drops
(counterpart of ``repro/serving/scheduler.py``, plain Python).

``SlotScheduler`` owns the in-flight request queue between trace replay
and the fixed-slot policy forward; ``BucketedSlotScheduler`` extends it
with a small set of compiled slot *shapes* (buckets) so a lightly
filled batch dispatches in a right-sized program instead of one big
mostly-padded slot, and ``calibrate_buckets`` picks the shape set
offline from a trace's burst-size distribution. Their guarantees (the
serving contract, docs/ARCHITECTURE.md §8 — each is pinned by a
property test in ``tests/test_serving.py`` and held against the port by
``tests/test_torch_serving.py``):

1. **No silent drops.** Every admitted request is dispatched exactly
   once: ``next_batch`` pops at most ``slot`` requests and never
   discards; a missed deadline is *recorded*, never used to shed load.
   (Load shedding would be a policy choice layered on top — the
   scheduler's own accounting must stay exact either way.)
2. **EDF across classes, FIFO within a class.** The queue is a heap on
   ``(deadline, seq)`` with ``seq`` the admission order. Deadlines are
   absolute (``arrival + class bound``), so within one class deadline
   order IS arrival order — earliest-deadline-first gives FIFO per class
   for free, and the ``seq`` tiebreak makes equal-deadline pops
   deterministic and admission-ordered.
3. **No starvation.** A pending request's deadline is fixed while every
   later arrival's deadline grows with its arrival time, so any waiting
   request becomes the queue minimum after boundedly many admissions —
   EDF on absolute deadlines cannot strand it.
4. **Exact miss accounting.** ``complete`` compares each request's
   completion time against its absolute deadline; ``deadline_misses`` /
   ``misses_by_class`` equal a ground-truth recount of the completion
   log on any adversarial trace, by construction and by test.
5. **Smallest admissible bucket** (``BucketedSlotScheduler`` only).
   Admission assigns every request the smallest bucket whose slot shape
   admits its region burst (``bucket_for``), and every dispatch runs in
   the smallest bucket shape that admits its popped batch — so
   per-dispatch padding is bounded by the bucket granularity instead of
   by the one compiled slot shape, while guarantees 1-4 hold unchanged
   (one global EDF heap underneath; the buckets partition *shapes*, not
   the queue order).
"""
from __future__ import annotations

import bisect
import heapq
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.serving.request import Request


class SlotScheduler:
    """Packs in-flight requests into fixed-``slot``-size batches.

    Call pattern (the server's loop): ``admit`` requests in arrival
    order, ``next_batch`` to pop up to ``slot`` of them
    (earliest-deadline-first), run the forward, then ``complete(batch,
    t_done)`` with the batch's shared completion time. ``completions``
    is the full audit log ``(rid, klass, arrival, deadline, t_done)``
    the miss counters are derivable from."""

    def __init__(self, slot: int):
        if slot < 1:
            raise ValueError(f"slot must be >= 1, got {slot}")
        self.slot = slot
        self._heap: List[Tuple[float, int, Request]] = []
        self._seq = 0
        self.admitted = 0
        self.served = 0
        self.deadline_misses = 0
        self.misses_by_class: Dict[int, int] = {}
        self.max_queue_depth = 0
        self.completions: List[Tuple[int, int, float, float, float]] = []

    @property
    def pending(self) -> int:
        return len(self._heap)

    def admit(self, req: Request) -> None:
        """Enqueue one request. Admission order is the FIFO tiebreak, so
        callers must admit in arrival order (trace replay does)."""
        heapq.heappush(self._heap, (req.deadline, self._seq, req))
        self._seq += 1
        self.admitted += 1
        self.max_queue_depth = max(self.max_queue_depth, len(self._heap))

    def next_batch(self) -> List[Request]:
        """Pop up to ``slot`` requests, earliest absolute deadline first
        (admission order among equal deadlines). Never discards: what is
        not popped stays queued for the next batch."""
        n = min(self.slot, len(self._heap))
        return [heapq.heappop(self._heap)[2] for _ in range(n)]

    def next_dispatch(self) -> Tuple[int, List[Request]]:
        """-> (slot shape to dispatch at, popped batch) — the server's
        uniform drain interface. The fixed-slot scheduler always answers
        with its one compiled shape; the bucketed scheduler right-sizes
        it per batch."""
        return self.slot, self.next_batch()

    def complete(self, batch: List[Request], t_done: float) -> None:
        """Record a dispatched batch finishing at ``t_done`` (seconds on
        the trace clock). All requests in one slot share the completion
        time — the whole slot returns from one fused dispatch."""
        for req in batch:
            self.served += 1
            self.completions.append(
                (req.rid, req.klass, req.arrival, req.deadline, t_done))
            if t_done > req.deadline:
                self.deadline_misses += 1
                self.misses_by_class[req.klass] = (
                    self.misses_by_class.get(req.klass, 0) + 1)


class BucketedSlotScheduler(SlotScheduler):
    """``SlotScheduler`` over a small set of compiled slot shapes.

    ``buckets`` is the ascending shape set (e.g. ``(16, 64, 256)``) —
    each is one compiled ``serve_forward`` program the server warms at
    startup, so the bucket count is the compiled-programs budget the
    offline ``calibrate_buckets`` pass optimises under.

    Two rules, both pinned by property tests:

    - **Admission** tags every request with its *admissible bucket*: the
      smallest bucket whose shape covers the request's region burst
      (``bucket_for(req.size)``; a burst larger than the largest bucket
      rides the largest, split across dispatches — the same splitting a
      single-slot server does). ``admitted_by_bucket`` counts them.
    - **Dispatch** (``next_dispatch``) pops the EDF batch exactly as the
      base scheduler would at slot = max bucket, then runs it in the
      smallest bucket shape that admits the popped count — under light
      load a 3-lane batch dispatches in the small shape instead of a
      mostly-padded big one (the padded-lane waste the bimodal bench
      row measures), and under queue pressure the batch grows until it
      right-sizes into the biggest program, so saturated throughput is
      never worse than the single-slot server's.

    Everything else — EDF/FIFO-in-class order, no-drop, exact miss
    accounting — is inherited unchanged: the buckets partition the
    *shape* a batch runs at, never the order requests pop in.
    """

    def __init__(self, buckets: Sequence[int]):
        shapes = sorted(set(int(b) for b in buckets))
        if not shapes or shapes[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets!r}")
        super().__init__(shapes[-1])
        self.buckets: Tuple[int, ...] = tuple(shapes)
        self.coarse = False
        self.admitted_by_bucket: Dict[int, int] = {b: 0 for b in shapes}
        self.dispatches_by_bucket: Dict[int, int] = {b: 0 for b in shapes}

    def set_coarse(self, coarse: bool) -> None:
        """Brownout collapse (the overload contract, ARCHITECTURE §8):
        while ``coarse`` is set every dispatch runs at the largest
        bucket shape — under sustained overload batches are near-full
        anyway, and one big program amortises per-dispatch overhead.
        Pop order, no-drop, and miss accounting are untouched (this
        only coarsens the *shape* a popped batch runs at); the
        admission-side brownout controller toggles it both ways."""
        self.coarse = bool(coarse)

    def bucket_for(self, size: int) -> int:
        """-> the smallest bucket shape >= ``size`` (the burst's
        admissible bucket); the largest bucket when no shape covers it
        (the burst is split across dispatches of that shape)."""
        i = bisect.bisect_left(self.buckets, size)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def admit(self, req: Request) -> None:
        super().admit(req)
        self.admitted_by_bucket[self.bucket_for(req.size)] += 1

    def next_dispatch(self) -> Tuple[int, List[Request]]:
        """Pop the EDF batch (up to max-bucket lanes) and right-size it:
        the dispatch shape is the smallest bucket admitting the batch —
        or the largest bucket while the brownout collapse
        (``set_coarse``) is active."""
        batch = self.next_batch()
        shape = self.slot if self.coarse else self.bucket_for(len(batch))
        self.dispatches_by_bucket[shape] += 1
        return shape, batch


# ---------------------------------------------------------------------
# Offline bucket calibration: shapes from a trace's size distribution
# ---------------------------------------------------------------------

def burst_sizes(trace: Iterable[Request]) -> List[int]:
    """-> one entry per region burst in ``trace`` (a size-k burst is k
    requests sharing one (region, arrival); each contributes its size
    once) — the empirical size distribution ``calibrate_buckets``
    optimises over."""
    seen = set()
    out = []
    for req in trace:
        key = (req.region, req.arrival)
        if key not in seen:
            seen.add(key)
            out.append(max(1, int(req.size)))
    return out


def expected_padded_waste(sizes: Sequence[int], buckets: Sequence[int],
                          *, max_slot: int = 256) -> int:
    """Total padded lanes when each burst dispatches alone in its
    admissible bucket (bursts beyond ``max_slot`` split into full
    chunks first) — the calibration objective, also the tests' ground
    truth for the monotonicity property. A *lower bound* of zero queue
    pressure: co-queued bursts that share a dispatch only reduce waste
    further."""
    shapes = sorted(set(buckets))
    waste = 0
    for s0 in sizes:
        s0 = int(s0)
        chunks = []
        while s0 > max_slot:           # same decomposition as calibration
            chunks.append(max_slot)
            s0 -= max_slot
        if s0:
            chunks.append(s0)
        for s in chunks:
            i = bisect.bisect_left(shapes, s)
            b = shapes[min(i, len(shapes) - 1)]
            # ceil-division split for chunks above the largest bucket
            n_disp = -(-s // b)
            waste += n_disp * b - s
    return waste


def calibrate_buckets(trace: Iterable[Request], max_buckets: int = 3, *,
                      min_slot: int = 16,
                      max_slot: int = 256) -> Tuple[int, ...]:
    """Pick <= ``max_buckets`` slot shapes minimising expected
    padded-lane waste over ``trace``'s burst-size distribution.

    The model: a burst of size s dispatches alone in the smallest chosen
    bucket >= s (bursts above ``max_slot`` split into ``max_slot``
    chunks first), wasting (bucket - s) padded lanes. Candidate shapes
    are the observed burst sizes clamped to [``min_slot``,
    ``max_slot``] — any other value is dominated by rounding down to
    the largest size it covers; ``min_slot`` floors the shapes because
    below it per-dispatch overhead, not padded FLOPs, dominates (the
    same reason the serve bench quotes dispatch rate). The largest
    candidate is always chosen (every burst must be admissible), and
    the optimum is exact by an O(n^2 k) partition DP — so adding a
    bucket to the budget can never increase the optimal waste (the
    property test's monotonicity claim).
    """
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    if min_slot > max_slot:
        raise ValueError(f"min_slot {min_slot} > max_slot {max_slot}")
    sizes = burst_sizes(trace)
    if not sizes:
        return (min_slot,)
    # decompose oversize bursts into full chunks + remainder, then clamp
    eff: List[int] = []
    for s in sizes:
        while s > max_slot:
            eff.append(max_slot)
            s -= max_slot
        if s:
            eff.append(s)
    counts: Dict[int, int] = {}
    for e in eff:
        counts[e] = counts.get(e, 0) + 1
    cands = sorted({min(max(e, min_slot), max_slot) for e in counts})
    sizes_sorted = sorted(counts)
    m = len(cands)
    k = min(max_buckets, m)

    def seg_cost(lo_cand: int, cand: int) -> int:
        """Waste of covering every size in (lo_cand, cand] with
        ``cand`` (lo_cand = 0 for the first chosen bucket)."""
        return sum(counts[e] * (cand - e) for e in sizes_sorted
                   if lo_cand < e <= cand)

    INF = float("inf")
    # best[j][b]: min waste covering sizes <= cands[j] with b buckets,
    # cands[j] chosen; parent pointers reconstruct the shape set
    best = [[INF] * (k + 1) for _ in range(m)]
    parent = [[None] * (k + 1) for _ in range(m)]
    for j in range(m):
        best[j][1] = seg_cost(0, cands[j])
        for b in range(2, k + 1):
            for i in range(j):
                if best[i][b - 1] is INF:
                    continue
                cost = best[i][b - 1] + seg_cost(cands[i], cands[j])
                if cost < best[j][b]:
                    best[j][b] = cost
                    parent[j][b] = i
    b_opt = min(range(1, k + 1), key=lambda b: best[m - 1][b])
    chosen = [cands[m - 1]]
    j, b = m - 1, b_opt
    while parent[j][b] is not None:
        j, b = parent[j][b], b - 1
        chosen.append(cands[j])
    return tuple(sorted(chosen))
