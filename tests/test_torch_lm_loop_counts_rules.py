"""The LM dry-run's loop correction (``launch/dryrun.py``): qwen3-4b's
cells against the count of every iteration (the other archs are in the
other ``test_torch_lm_loop_counts_*.py`` files), the weights that take
the points' counts to the full trip counts, the points chosen for the
pods' cells, and the counts that stay every iteration's."""
from fractions import Fraction

import pytest

import test_torch_common  # noqa: F401  (one torch thread)
from torch_loop_counts_common import LAYOUT, SHAPES, check_arch, config

from repro_torch.configs.base import SHAPES as CELLS
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun


def test_loop_corrected_count_is_every_iterations_qwen3():
    check_arch("qwen3-4b")


def test_the_weights_take_a_multilinear_count_to_the_full_one():
    """f(g, m) = 7 + 3 g + 5 m + 11 g m, counted at the points, comes out
    f(N) exactly, in integers, whatever the two points of each loop."""
    def f(g, m):
        return {"a": 7 + 3 * g + 5 * m + 11 * g * m, "b": {"x": 2.0 * g}}
    for (g0, g1, G), (m0, m1, M) in [((2, 3, 27), (2, 3, 8)),
                                     ((16, 32, 96), (2, 3, 8)),
                                     ((2, 4, 36), (5, 5, 5))]:
        axes = {"groups": [g0, g1], "microbatches":
                [m0, m1] if m0 != m1 else [M]}
        trips = {"groups": G, "microbatches": M}
        points = [{"groups": g, "microbatches": m}
                  for g in axes["groups"] for m in axes["microbatches"]]
        w = [dryrun._weights(axes, trips, p) for p in points]
        assert sum(w) == 1 and all(isinstance(x, Fraction) for x in w)
        got = dryrun._combine([f(p["groups"], p["microbatches"])
                               for p in points], w)
        assert got == f(G, M)
        assert isinstance(got["a"], int) and isinstance(got["b"]["x"],
                                                        float)


@pytest.mark.parametrize("arch,shape,mesh,points", [
    # deepseek-moe-16b: 27 groups and 8 microbatches from 2 x 2 points
    ("deepseek-moe-16b", "train_4k", "pod1",
     {"groups": [2, 3], "microbatches": [2, 3]}),
    # the config's one microbatch is counted as it is
    ("qwen3-4b", "train_4k", "pod1", {"groups": [2, 3],
                                      "microbatches": [1]}),
    # 96 groups divide data = 16, which shards the moments' stacked dim:
    # only group counts that 16 divides shard alike
    ("nemotron-4-340b", "train_4k", "pod1",
     {"groups": [16, 32], "microbatches": [2, 3]}),
    # on pod2 "pod" = 2 takes the stacked dim of an even count
    ("qwen3-4b", "train_4k", "pod2", {"groups": [2, 4],
                                      "microbatches": [1]}),
    # whisper: 6 groups and 6 encoder layers save nothing; the
    # microbatches do
    ("whisper-base", "train_4k", "pod1",
     {"groups": [6], "encoder_layers": [6], "microbatches": [2, 3]}),
    ("whisper-base", "decode_32k", "pod2",
     {"groups": [6], "encoder_layers": [6]}),
    ("jamba-1.5-large-398b", "train_4k", "pod1",
     {"groups": [2, 3], "microbatches": [2, 3]}),
])
def test_the_pod_cells_points(arch, shape, mesh, points):
    cfg = get_config(arch)
    with dryrun.fake_ranks(dryrun._lm_layout(mesh)) as m:
        assert dryrun.trip_points(cfg, CELLS[shape], m) == points
        assert dryrun.trip_points(cfg, CELLS[shape], m, ()) == {
            k: [v] for k, v in dryrun.lm_trips(cfg, CELLS[shape]).items()}


def test_a_recorded_count_is_every_iterations():
    """``record=True`` keeps rows by (op, operand shapes), which do not
    extrapolate: every iteration is counted, and the rows sum to the
    totals."""
    cfg = config("qwen3-4b")
    cell, rows = dryrun.count_cell(cfg, SHAPES[1], LAYOUT, "8x2",
                                   record=True)
    assert cell["counted_by"] == "every iteration"
    assert cell["trips"]["points"][0]["groups"] == 4
    assert sum(r[2] for r in rows) == cell["ops"]["hbm_bytes"]
    assert sum(r[3] for r in rows) == cell["ops"]["flops"]
