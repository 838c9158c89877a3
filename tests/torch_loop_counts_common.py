"""Shared by ``tests/test_torch_lm_loop_counts_*.py``: the LM dry-run's
loop-corrected count (``launch/dryrun.py::count_cell``) against the count
of every iteration, for each ``reduced()`` arch.

Every arch is counted on rank 0 of a fake (data 8, model 2) layout, at
trip counts beyond the points that are fitted ({2, 3} of each loop): 4
layer groups, 4 microbatches of 16 rows (train), 4 encoder layers
(whisper); T = 8 (one chunk of every sequence loop). The points cost more
layers than the full count here, so the test names every loop in
``extrapolate`` (the dry-run's own choice would count every iteration).
The hybrid, vlm and ssm patterns are cut to a period of 2 (one layer of
each kind a group); whisper keeps its 8 audio frames, which "model"
divides: widths and layer kinds are the arch's.

Every reported number must be equal, not close: the counter's FLOPs (dot,
by dtype, elementwise), HBM bytes, collective bytes and counts by kind,
kernel launches and op count, and the step's argument, output and alias
bytes.
"""
from repro_torch.configs.base import ShapeCell, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshLayout

LAYOUT = MeshLayout(("data", "model"), (8, 2))
GROUPS = MICROBATCHES = ENCODER_LAYERS = 4
ROWS, T = 16, 8
PERIOD = {"hybrid": "attn_period", "vlm": "cross_attn_period",
          "ssm": "slstm_period"}
SHAPES = (ShapeCell("train", T, ROWS * MICROBATCHES, "train"),
          ShapeCell("prefill", T, ROWS, "prefill"),
          ShapeCell("decode", T, ROWS, "decode"))


def config(arch: str):
    cfg = reduced(get_config(arch))
    if cfg.family in PERIOD:
        cfg = cfg.with_overrides(**{PERIOD[cfg.family]: 2})
    prologue, pattern, _ = cfg.layer_plan()
    kw = dict(n_layers=len(prologue) + GROUPS * len(pattern),
              force_microbatches=MICROBATCHES)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=ENCODER_LAYERS)
    return cfg.with_overrides(**kw)


def check_arch(arch: str):
    """Each shape: the loop-corrected count equals every iteration's, and
    it extrapolated every loop from {2, 3}."""
    cfg = config(arch)
    for shape in SHAPES:
        loops = tuple(dryrun.lm_trips(cfg, shape))
        got = dryrun.count_cell(cfg, shape, LAYOUT, "8x2",
                                extrapolate=loops)
        want = dryrun.count_cell(cfg, shape, LAYOUT, "8x2", extrapolate=())
        assert got["counted_by"] == "extrapolated", (arch, shape.name)
        assert want["counted_by"] == "every iteration"
        full = {"groups": GROUPS}
        if cfg.family == "encdec":
            full["encoder_layers"] = ENCODER_LAYERS
        if shape.kind == "train":
            full["microbatches"] = MICROBATCHES
        assert dict(got["trips"], points=None) == dict(full, points=None)
        for p in got["trips"]["points"]:
            assert all(p[k] in (2, 3) for k in loops), p
        assert len(got["trips"]["points"]) == 2 ** len(loops)
        assert got["ops"] == want["ops"], (arch, shape.name)
        assert got["memory"] == want["memory"], (arch, shape.name)
        assert got["roofline"] == want["roofline"], (arch, shape.name)
        assert got["n_microbatches"] == want["n_microbatches"]
