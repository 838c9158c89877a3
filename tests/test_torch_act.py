"""The port's rational gates and bits-to-uniform convention
(``repro_torch/nn/act.py``) against ``repro.nn.act``: uniforms from the
same uint32 bits exactly, gates within 1e-7 (one rounding apart)."""
import numpy as np
import pytest

from test_torch_common import assert_close, assert_equal  # noqa: F401

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.nn import act as jact  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.nn import act  # noqa: E402


def _grid():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.linspace(-12, 12, 4001), rng.normal(0, 3, 2000),
        [0.0, -0.0, 4.97178686, -4.97178686, 1e-8, 40.0, -40.0]]
    ).astype(np.float32)


@pytest.mark.parametrize("name", ["fast_tanh", "fast_sigmoid"])
def test_gates_match_reference(name):
    x = _grid()
    port = getattr(act, name)(torch.from_numpy(x))
    ref = getattr(jact, name)(jnp.asarray(x))
    assert_close(port, ref, 1e-7)


def test_gates_saturate_inside_their_range():
    x = torch.tensor([-1e4, -10.0, 10.0, 1e4])
    t = act.fast_tanh(x).numpy()
    np.testing.assert_allclose(t, [-1.0, -1.0, 1.0, 1.0], atol=1e-7)
    assert np.abs(t).max() <= 1.0
    s = act.fast_sigmoid(x).numpy()
    assert s.min() >= 0.0 and s.max() <= 1.0


def test_uniform_from_bits_is_exact():
    rng = np.random.default_rng(1)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 255, 256, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                 np.uint32)])
    port = act.uniform_from_bits(convert.to_torch(bits, device="cpu"))
    ref = jact.uniform_from_bits(jnp.asarray(bits))
    assert_equal(port, ref)
    assert float(port.max()) < 1.0


def test_random_bits_cover_the_uint32_range():
    g = torch.Generator().manual_seed(0)
    b = act.random_bits((4096,), g)
    assert b.dtype == torch.int32
    u = b.numpy().view(np.uint32)
    assert u.max() > 2 ** 31 and u.min() < 2 ** 31
