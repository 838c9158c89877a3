"""The LM dry-run's loop-corrected count equals the count of every
iteration: the encoder-decoder (the encoder layers a third loop)
(``tests/torch_loop_counts_common.py`` says how)."""
import pytest

import test_torch_common  # noqa: F401  (one torch thread)
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import dryrun
from torch_loop_counts_common import LAYOUT, SHAPES, check_arch


@pytest.mark.parametrize("arch", ['whisper-base'])
def test_loop_corrected_count_is_every_iterations(arch):
    check_arch(arch)


def test_whisper_counts_where_model_divides_six_frames():
    """The encoder's input pinned to the batch axes
    (``models/lm.py::encode``): 6 audio frames, which "model" = 2
    divides, counted on the fake (data 8, model 2) layout, each shape
    ``ok`` (the frames once took the position table's shards on "model",
    a strided shard of the flattened rows DTensor cannot propagate)."""
    cfg = reduced(get_config("whisper-base")).with_overrides(
        n_audio_frames=6, n_encoder_layers=2, force_microbatches=2)
    for shape in SHAPES:
        cell = dryrun.count_cell(cfg, shape, LAYOUT, "8x2")
        assert cell["status"] == "ok", (shape.name, cell["status"])
        assert cell["ops"]["flops_dot"] > 0
