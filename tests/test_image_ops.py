import numpy as np
import jax.numpy as jnp
import cv2
import pytest

from mhmocap.ops import image as I
from mhmocap.ops import morphology as Mo
from mhmocap.engine import losses as L


def test_erode_dilate_match_cv2(rng):
    x = (rng.rand(32, 32) > 0.6).astype(np.float32)
    ours_e = np.asarray(Mo.erode(jnp.asarray(x), 3, iterations=2))
    cv_e = cv2.erode(x, np.ones((3, 3)), iterations=2)
    np.testing.assert_array_equal(ours_e, cv_e)
    ours_d = np.asarray(Mo.dilate(jnp.asarray(x), 5, iterations=1))
    cv_d = cv2.dilate(x, np.ones((5, 5)), iterations=1)
    np.testing.assert_array_equal(ours_d, cv_d)


def test_erode_batched_shape(rng):
    x = (rng.rand(2, 3, 16, 16) > 0.5).astype(np.float32)
    y = np.asarray(Mo.erode(jnp.asarray(x), 3))
    assert y.shape == x.shape
    for b in range(2):
        for n in range(3):
            np.testing.assert_array_equal(
                y[b, n], cv2.erode(x[b, n], np.ones((3, 3))))


def test_sobel_matches_cv2(rng):
    x = rng.rand(24, 24).astype(np.float32)
    ours = np.asarray(I.sobel_magnitude(jnp.asarray(x)))
    gx = cv2.Sobel(x, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(x, cv2.CV_32F, 0, 1, ksize=3)
    golden = np.abs(gx) + np.abs(gy)
    # Interior must match exactly; borders differ by padding mode.
    np.testing.assert_allclose(ours[2:-2, 2:-2], golden[2:-2, 2:-2],
                               atol=1e-4)


def test_masked_window_median_golden():
    x = np.arange(25, dtype=np.float32).reshape(5, 5)
    mask = np.ones((5, 5), np.float32)
    mask[2, 2] = 0
    med, ok = I.masked_window_median(jnp.asarray(x), jnp.asarray(mask), 3)
    med = np.asarray(med)
    # window of (2,2): valid neighbors 6,7,8,11,13,16,17,18 -> median 12
    assert med[2, 2] == 12.0
    assert np.asarray(ok).all()


def test_fillin_fills_all_holes(rng):
    x = rng.rand(20, 20).astype(np.float32)
    mask = np.ones((20, 20), np.float32)
    mask[5:12, 6:14] = 0
    xf, mf = I.fillin_masked(jnp.asarray(x), jnp.asarray(mask), 7)
    assert np.asarray(mf).min() == 1.0
    # untouched where mask was valid
    np.testing.assert_allclose(np.asarray(xf)[mask > 0], x[mask > 0])
    filled = np.asarray(xf)[mask == 0]
    assert filled.min() >= x.min() - 1e-5 and filled.max() <= x.max() + 1e-5


def test_bilateral_filter_smooths_but_keeps_edges():
    x = np.zeros((32, 32), np.float32)
    x[:, 16:] = 1.0
    noisy = x + 0.02 * np.random.RandomState(0).randn(32, 32).astype(
        np.float32)
    f = np.asarray(I.bilateral_filter(jnp.asarray(noisy), d=7,
                                      sigma_color=0.1, sigma_space=5.0))
    # noise reduced on flat regions
    assert f[:, :12].std() < noisy[:, :12].std() * 0.7
    # edge magnitude preserved
    assert (f[:, 20:].mean() - f[:, :12].mean()) > 0.9


def test_masked_temporal_median_golden():
    T, H, W = 5, 4, 4
    vals = np.arange(T, dtype=np.float32)[:, None, None] * np.ones(
        (T, H, W), np.float32)
    valid = np.ones((T, H, W), np.float32)
    valid[3:, 0, 0] = 0  # pixel (0,0) only sees frames 0,1,2
    med, ok = I.masked_temporal_median(jnp.asarray(vals),
                                       jnp.asarray(valid))
    med = np.asarray(med)
    assert med[0, 0] == 1.0      # median of 0,1,2
    assert med[1, 1] == 2.0      # median of 0..4
    assert np.asarray(ok).all()


def test_masked_temporal_median_ma_parity(rng):
    vals = rng.rand(7, 6, 6).astype(np.float32)
    valid = (rng.rand(7, 6, 6) > 0.3).astype(np.float32)
    med, ok = I.masked_temporal_median(jnp.asarray(vals),
                                       jnp.asarray(valid))
    ma = np.ma.array(vals, mask=valid == 0)
    golden = np.ma.median(ma, axis=0)
    both = np.asarray(ok) & ~golden.mask
    np.testing.assert_allclose(np.asarray(med)[both], golden.data[both],
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ok), ~golden.mask)


def test_postprocess_dispmap_runs_and_fills(rng):
    disp = np.clip(rng.rand(32, 32), 0.1, 1).astype(np.float32)
    disp[10, 10] = 1.0  # a flying pixel
    out = np.asarray(I.postprocess_dispmap(jnp.asarray(disp)))
    assert out.shape == disp.shape
    assert np.isfinite(out).all()
    assert out.min() >= 1.0 / 20 - 1e-5 and out.max() <= 1.0 + 1e-5


def test_avg_log_depth_loss_golden():
    pred = jnp.asarray(np.full((1, 1, 4, 4), 2.0, np.float32))
    true = jnp.asarray(np.full((1, 1, 4, 4), 4.0, np.float32))
    mask = jnp.ones((1, 1, 4, 4))
    out = float(L.avg_log_depth_loss(pred, true, mask))
    # per-instance means of log: (16*log2)/(16+1) vs (16*log4)/17
    exp = ((16 * np.log(2) - 16 * np.log(4)) / 17.0) ** 2
    np.testing.assert_allclose(out, exp, rtol=1e-5)


def test_masked_mse_loss_golden():
    y1 = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    y2 = jnp.zeros((2, 2))
    mask = jnp.asarray([[1.0, 0.0], [1.0, 1.0]])
    out = float(L.masked_mse_loss(y1, y2, mask))
    np.testing.assert_allclose(out, (1 + 9 + 16) / (3 + 1.0), rtol=1e-6)


@pytest.mark.parametrize("fg_iters, bg_iters", [(1, 1), (3, 9), (0, 5)])
def test_segmentation_erosion_matches_cv2(tmp_path, rng, fg_iters,
                                          bg_iters):
    """load_segmentation_maps' scipy min/max filters reproduce the
    cv2.erode/dilate pipeline of the reference (datautils.py:95-106)
    on random label maps, borders included."""
    from PIL import Image
    from mhmocap.data.ingestion import load_segmentation_maps

    labels = rng.randint(0, 4, (4, 4)).repeat(6, 0).repeat(6, 1)
    labels[rng.rand(*labels.shape) > 0.93] = 0
    labels = labels.astype(np.uint8)
    path = str(tmp_path / "seg.png")
    Image.fromarray(labels).save(path)
    inst, back = load_segmentation_maps([path], (24, 24), fg_iters,
                                        bg_iters)

    k = np.ones((3, 3))
    ref = labels.copy()
    if fg_iters > 0:
        e, d = cv2.erode(ref, k), cv2.dilate(ref, k)
        ref = ((e == d) * ref).astype(np.uint8)
        if fg_iters > 1:
            ref = cv2.erode(ref, k, iterations=fg_iters - 1)
    ref_back = cv2.erode((labels == 0).astype(np.uint8), k,
                         iterations=bg_iters)
    np.testing.assert_array_equal(inst[0], ref)
    np.testing.assert_array_equal(back[0], ref_back)
