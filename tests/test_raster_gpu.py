"""The raster kernel compiled for the GPU (no interpreter) against the
brute reference. Marked `gpu`: skips without a card; run on the card
by `python chip_smoke.py`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.models.smpl import smpl_forward
from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.ops import rasterizer as R
from mhmocap.ops.cameras import intrinsics_from_fov

pytestmark = pytest.mark.gpu


def _bodies():
    model = R.preorder_faces(make_synthetic_smpl(num_vertices=1024,
                                                 seed=1))
    K = jnp.asarray(intrinsics_from_fov((128, 128), 60.0))
    t = jnp.asarray([[0.0, 0.3, 2.4], [0.2, 0.2, 2.8], [-0.2, 0.1, 3.2]])
    rng = np.random.RandomState(0)
    out = smpl_forward(model, jnp.zeros((3, 10)),
                       jnp.asarray(0.1 * rng.randn(3, 72), jnp.float32),
                       transl=t)
    return out["verts"], model, K


@pytest.mark.parametrize("win", [64, 56])
def test_gpu_kernel_forward_matches_brute(gpu, win):
    v, model, K = _bodies()
    st = R.RasterSettings(image_size=(128, 128), window=win,
                          preordered=True)
    o_k = jax.jit(lambda w: R.rasterize_bodies(
        w, model.faces, K, st._replace(backend="pallas")))(v)
    o_b = jax.jit(lambda w: R.rasterize_bodies(
        w, model.faces, K, st._replace(backend="brute")))(v)
    z_k, z_b = np.asarray(o_k["zbuf"]), np.asarray(o_b["zbuf"])
    assert np.isfinite(z_b).sum() > 500
    assert (np.isfinite(z_k) == np.isfinite(z_b)).all()
    both = np.isfinite(z_b)
    np.testing.assert_allclose(z_k[both], z_b[both], atol=1e-5)
    np.testing.assert_allclose(np.asarray(o_k["sil"]),
                               np.asarray(o_b["sil"]), atol=1e-5)


def test_gpu_kernel_gradient_matches_brute(gpu):
    v, model, K = _bodies()
    st = R.RasterSettings(image_size=(128, 128), window=64,
                          preordered=True)
    w = jnp.asarray(np.random.RandomState(1).randn(3, 64, 64),
                    jnp.float32)

    def grad(backend):
        def loss(x):
            o = R.rasterize_bodies(x, model.faces, K,
                                   st._replace(backend=backend))
            zb = jnp.where(jnp.isfinite(o["zbuf"]), o["zbuf"], 0.0)
            return jnp.sum(w * o["sil"]) + 0.1 * jnp.sum(w * zb)
        return np.asarray(jax.jit(jax.grad(loss))(v))

    g_k, g_b = grad("pallas"), grad("brute")
    assert np.isfinite(g_k).all()
    big = np.abs(g_b) > 1e-3 * np.linalg.norm(g_b)
    assert big.sum() > 100
    rel = np.abs(g_k - g_b)[big] / np.abs(g_b)[big]
    assert rel.max() < 2e-3, rel.max()
