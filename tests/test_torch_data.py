"""The port's token pipeline (``repro_torch/data/pipeline.py``) against
the JAX package's (``repro/data/pipeline.py``): batches bitwise equal for
the synthetic and the file source over several (step, host_id, n_hosts),
the host shards of one step distinct, the prefetching iterator resuming
at its start step and joining its thread on close, and the file writer
byte-equal to the reference's."""
import threading

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one torch thread, JAX on the CPU)

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

SHARDS = [(0, 0, 1), (3, 0, 1), (3, 1, 2), (11, 1, 4), (11, 3, 4),
          (12345, 2, 8)]


def _pipes(source="synthetic", path=None, seed=0, vocab=1000):
    kw = dict(seq_len=24, global_batch=8, vocab_size=vocab, seed=seed,
              source=source, path=path)
    return (jpipe.TokenPipeline(jpipe.DataConfig(**kw)),
            tpipe.TokenPipeline(tpipe.DataConfig(**kw)))


@pytest.fixture()
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    tokens = np.random.RandomState(0).randint(0, 5000, 4000)
    tpipe.write_token_file(path, tokens)
    ref = tmp_path / "ref.bin"
    jpipe.write_token_file(ref, tokens)
    assert path.read_bytes() == ref.read_bytes()
    return str(path)


@pytest.mark.parametrize("step,host,n_hosts", SHARDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_bitwise(step, host, n_hosts, seed):
    jp, tp = _pipes(seed=seed)
    want, got = jp.get_batch(step, host, n_hosts), tp.get_batch(
        step, host, n_hosts)
    assert sorted(got) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == (8 // n_hosts, 24)
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].max() < 1000 and got["tokens"].min() >= 1


@pytest.mark.parametrize("step,host,n_hosts", SHARDS)
def test_file_batches_bitwise(token_file, step, host, n_hosts):
    jp, tp = _pipes("file", token_file, vocab=3000)
    want, got = jp.get_batch(step, host, n_hosts), tp.get_batch(
        step, host, n_hosts)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # a contiguous stream: labels are the tokens shifted by one
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])
    assert got["tokens"].max() <= 2999


def test_host_shards_differ_and_divide():
    _, tp = _pipes()
    a, b = tp.get_batch(5, 0, 2), tp.get_batch(5, 1, 2)
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert tp.host_batch_size(4) == 2
    with pytest.raises(ValueError, match="divide"):
        tp.host_batch_size(3)
    with pytest.raises(ValueError, match="path"):
        tpipe.TokenPipeline(tpipe.DataConfig(4, 2, 10, source="file"))


@pytest.mark.parametrize("start", [0, 7])
def test_iterator_resumes_at_its_step(start):
    _, tp = _pipes()
    it = tp.iterator(start_step=start, host_id=1, n_hosts=2)
    for s in range(start, start + 3):
        b = next(it)
        np.testing.assert_array_equal(b["tokens"],
                                      tp.get_batch(s, 1, 2)["tokens"])
    it.close()


def test_iterator_joins_its_thread_on_close():
    """Closing the iterator releases the producer even while it waits on
    a full prefetch queue."""
    before = threading.active_count()
    it = _pipes()[1].iterator(prefetch=1)
    next(it)
    it.close()
    assert threading.active_count() == before
