"""The LM dry-run's CLI (``launch/dryrun.py`` ``main``: ``--arch/--shape``,
``--all``'s sweep of one subprocess a cell) and ``launch/attribute.py``,
which ranks a counted cell's ops by HBM bytes, collective bytes or
FLOPs."""
import json
import subprocess

import pytest

import test_torch_common  # noqa: F401  (one torch thread)

from repro_torch.launch import attribute, dryrun

CELL = ("whisper-base", "decode_32k", "pod2")


def test_refused_cells_carry_their_reason():
    cell = dryrun.run_cell("qwen3-4b", "long_500k", "pod1")
    assert cell == {"arch": "qwen3-4b", "shape": "long_500k",
                    "mesh": "pod1", "status": "skip(full-attn)"}
    with pytest.raises(ValueError, match="pod1 or pod2"):
        dryrun.run_cell("qwen3-4b", "decode_32k", "host")


def test_main_writes_the_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", CELL[0], "--shape", CELL[1], "--mesh",
                        CELL[2], "--out", str(tmp_path), "--tag",
                        "_t"]) == 0
    cell = json.loads((tmp_path / "whisper-base__decode_32k__pod2_t.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["n_chips"] == 512
    out = capsys.readouterr().out
    assert '"status": "ok"' in out and "model-FLOP bound=" in out
    # overrides reach the config: float32 weights and cache, twice the
    # bf16 cell's argument bytes
    assert dryrun.main(["--arch", CELL[0], "--shape", CELL[1], "--mesh",
                        CELL[2], "--out", str(tmp_path), "--overrides",
                        json.dumps({"param_dtype": "float32"})]) == 0
    f32 = json.loads((tmp_path / "whisper-base__decode_32k__pod2.json")
                     .read_text())
    arg = lambda c: c["memory"]["argument_bytes_per_device"]  # noqa: E731
    assert 1.9 * arg(cell) < arg(f32) <= 2 * arg(cell)


def test_the_sweep_records_refusals_errors_and_skips(tmp_path,
                                                     monkeypatch):
    """``--all``: a cell ``cell_applicable`` refuses is written with its
    reason, a crashed subprocess as "error" with its stderr, a written cell
    is skipped unless ``--force``; ``--jobs`` runs cells side by side."""
    import repro_torch.configs.base as base
    monkeypatch.setattr(base, "list_configs", lambda: ["qwen3-4b"])
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        shape = cmd[cmd.index("--shape") + 1]
        if shape == "prefill_32k":
            return subprocess.CompletedProcess(cmd, 1, "", "boom")
        (tmp_path / f"qwen3-4b__{shape}__pod1.json").write_text(
            json.dumps({"status": "ok"}))
        return subprocess.CompletedProcess(cmd, 0, "ok", "")
    monkeypatch.setattr(dryrun.subprocess, "run", run)
    dryrun.main(["--all", "--out", str(tmp_path), "--jobs", "2"])
    read = lambda s: json.loads(  # noqa: E731
        (tmp_path / f"qwen3-4b__{s}__pod1.json").read_text())
    assert read("long_500k")["status"] == "skip(full-attn)"
    assert read("prefill_32k")["status"] == "error"
    assert read("prefill_32k")["stderr"] == "boom"
    assert read("train_4k")["status"] == "ok"
    assert len(calls) == 3 and all("repro_torch.launch.dryrun" in c
                                   for c in calls)
    calls.clear()
    dryrun.main(["--all", "--out", str(tmp_path)])
    assert calls == []                       # every cell written: skipped
    dryrun.main(["--all", "--out", str(tmp_path), "--force"])
    assert len(calls) == 3


@pytest.mark.parametrize("what", ["mem", "coll", "flops"])
def test_attribute_ranks_the_counted_ops(what, capsys):
    rows = attribute.attribute(*CELL, top=6, what=what)
    assert 0 < len(rows) <= 6
    vals = [r[0] for r in rows]
    assert vals == sorted(vals, reverse=True) and vals[0] > 0
    assert 0 < sum(r[3] for r in rows) <= 1.0 + 1e-9
    if what == "coll":
        assert all(r[1] in dryrun.op_analysis.FUNCTIONAL_COLLECTIVES
                   for r in rows)
    if what == "flops":
        assert rows[0][1] in ("mm", "bmm", "addmm")
    out = capsys.readouterr().out
    assert f"total {what}:" in out
    assert attribute.main(["--arch", CELL[0], "--shape", CELL[1], "--mesh",
                           CELL[2], "--what", what, "--top", "2"]) == 0
