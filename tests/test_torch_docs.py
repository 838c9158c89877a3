"""The port's docs drift gate (``tools/torch_docs_check.py``) passes on
the tree and detects drift: a dead ``file.py::symbol``, a dropped
required snippet, a missing script, a module without a docstring."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools import torch_docs_check as tdc  # noqa: E402


def test_torch_docs_check_passes_on_the_tree():
    assert tdc.run_checks() == []
    assert tdc.main() == 0


def test_symbol_refs_resolve_into_the_port():
    p = tdc.resolve("kernels/aip_step.py")
    assert p is not None and "repro_torch" in str(p)
    names = tdc.top_level_names(p)
    assert {"aip_rollout", "aip_rollout_multi", "LAUNCHES",
            "rollout_plan"} <= names
    assert tdc.resolve("kernels/no_such_file.py") is None


def _with_doc(tmp_path, monkeypatch, text):
    (tmp_path / "docs").mkdir()
    (tmp_path / tdc.DOC).write_text(text)
    monkeypatch.setattr(tdc, "REPO", tmp_path)
    # symbols still resolve against the real tree
    real = Path(tdc.__file__).resolve().parent.parent
    monkeypatch.setattr(tdc, "resolve", lambda rel: next(
        (p for root in tdc._SYMBOL_ROOTS if (p := real / root / rel)
         .is_file()), None))


def test_a_dead_symbol_or_script_trips_the_gate(tmp_path, monkeypatch):
    _with_doc(tmp_path, monkeypatch,
              "`envs/api.py::no_such_adapter` and `kernels/ops.py::"
              "ials_rollout`; run `python3 tools/no_such_tool.py`\n")
    errs = tdc.stale_symbol_refs()
    assert len(errs) == 1 and "no_such_adapter" in errs[0]
    errs = tdc.stale_script_refs()
    assert len(errs) == 1 and "no_such_tool" in errs[0]


def test_a_dropped_required_snippet_trips_the_gate(tmp_path, monkeypatch):
    real = (Path(tdc.__file__).resolve().parent.parent / tdc.DOC).read_text()
    _with_doc(tmp_path, monkeypatch,
              real.replace("`envs/api.py::batch_env`", "batch_env"))
    errs = tdc.missing_required_snippets()
    assert errs == [f"{tdc.DOC} no longer quotes the required snippet "
                    f"`envs/api.py::batch_env`"]


def test_missing_doc_and_docstring_trip_the_gate(tmp_path, monkeypatch):
    monkeypatch.setattr(tdc, "REPO", tmp_path)
    (tmp_path / tdc.PORT).mkdir(parents=True)
    (tmp_path / tdc.PORT / "bare.py").write_text("x = 1\n")
    assert tdc.missing_docs() == [f"missing doc: {tdc.DOC}"]
    assert tdc.missing_docstrings() == [
        "module docstring missing: src/repro_torch/bare.py"]
    assert tdc.main() == 1
