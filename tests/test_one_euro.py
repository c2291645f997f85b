import math

import numpy as np
import jax.numpy as jnp

from mhmocap.ops.one_euro import one_euro_filter, one_euro_bidirectional


class _GoldenOneEuro:
    """Stateful numpy One-Euro (standard published algorithm) used as an
    independent golden model for the scan implementation."""

    def __init__(self, t0, x0, min_cutoff, beta, d_cutoff=1.0):
        self.min_cutoff, self.beta, self.d_cutoff = min_cutoff, beta, d_cutoff
        self.x_prev = np.array(x0, np.float64)
        self.dx_prev = np.zeros_like(self.x_prev)
        self.t_prev = np.array(t0, np.float64)

    @staticmethod
    def _alpha(t_e, cutoff):
        r = 2 * math.pi * cutoff * t_e
        return r / (r + 1)

    def __call__(self, t, x, mask=None):
        if mask is None:
            mask = np.ones_like(np.asarray(x, np.float64))
        t_e = t - self.t_prev
        a_d = self._alpha(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = a_d * dx + (1 - a_d) * self.dx_prev
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = self._alpha(t_e, cutoff)
        x_hat = a * x + (1 - a) * self.x_prev
        self.x_prev = (1 - mask) * self.x_prev + mask * x_hat
        self.dx_prev = (1 - mask) * self.dx_prev + mask * dx_hat
        self.t_prev = (1 - mask) * self.t_prev + mask * t
        return (1 - mask) * x + mask * x_hat


def test_matches_golden_ramp_time(rng):
    """The 'ramp' time base: t_i = sum_k k/rate (optimizer-style)."""
    T = 40
    x = np.cumsum(rng.randn(T, 3, 2), axis=0).astype(np.float32)
    rate = 25.0

    golden = np.array(x, np.float64)
    oef = _GoldenOneEuro(np.zeros_like(golden[0]), golden[0],
                         min_cutoff=0.01, beta=0.02)
    t = np.zeros_like(golden[0])
    for i in range(1, T):
        t = t + i / rate
        golden[i] = oef(t, golden[i])

    ours = np.asarray(one_euro_filter(
        jnp.asarray(x), min_cutoff=0.01, beta=0.02, frame_rate=rate,
        dt_mode="ramp"))
    np.testing.assert_allclose(ours, golden, atol=1e-4)


def test_matches_golden_uniform_time(rng):
    T = 30
    x = np.cumsum(rng.randn(T, 5), axis=0).astype(np.float32)
    rate = 25.0
    golden = np.array(x, np.float64)
    oef = _GoldenOneEuro(0.0, golden[0], min_cutoff=0.004, beta=0.7)
    for i in range(1, T):
        golden[i] = oef(i / rate, golden[i])

    ours = np.asarray(one_euro_filter(
        jnp.asarray(x), min_cutoff=0.004, beta=0.7, frame_rate=rate,
        dt_mode="uniform"))
    np.testing.assert_allclose(ours, golden, atol=1e-4)


def test_matches_golden_with_mask(rng):
    T = 25
    x = np.cumsum(rng.randn(T, 4), axis=0).astype(np.float32)
    mask = (rng.rand(T, 4) > 0.3).astype(np.float32)
    rate = 25.0

    golden = np.array(x, np.float64)
    oef = _GoldenOneEuro(np.zeros(4), golden[0], min_cutoff=0.01, beta=25.0)
    t = np.zeros(4)
    for i in range(1, T):
        t = t + i / rate
        golden[i] = oef(t, golden[i].copy(), mask=mask[i])

    ours = np.asarray(one_euro_filter(
        jnp.asarray(x), min_cutoff=0.01, beta=25.0, frame_rate=rate,
        mask=jnp.asarray(mask), dt_mode="ramp"))
    np.testing.assert_allclose(ours, golden, atol=1e-4)


def test_smooths_noise():
    T = 200
    t = np.linspace(0, 4 * np.pi, T)
    clean = np.sin(t)[:, None].astype(np.float32)
    noisy = clean + 0.3 * np.random.RandomState(0).randn(T, 1).astype(
        np.float32)
    filt = np.asarray(one_euro_filter(jnp.asarray(noisy), min_cutoff=0.5,
                                      beta=0.01, dt_mode="uniform"))
    err_raw = np.mean((noisy[20:] - clean[20:]) ** 2)
    err_filt = np.mean((filt[20:] - clean[20:]) ** 2)
    assert err_filt < 0.6 * err_raw


def test_bidirectional_shape_and_endpoint_bias(rng):
    T = 50
    x = np.cumsum(rng.randn(T, 2, 3), axis=0).astype(np.float32)
    out = np.asarray(one_euro_bidirectional(
        jnp.asarray(x), None, min_cutoff=0.01, beta=25.0))
    assert out.shape == x.shape
    # Both endpoints keep half of the raw value exactly
    np.testing.assert_allclose(out[0], 0.5 * (x[0] + np.asarray(
        one_euro_filter(jnp.asarray(x[::-1].copy()), min_cutoff=0.01,
                        beta=25.0, dt_mode="ramp"))[-1]), atol=1e-4)
