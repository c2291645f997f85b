import numpy as np
import jax.numpy as jnp

from mhmocap.ops import cameras as C


def _K():
    return np.array([[500.0, 0, 128], [0, 480.0, 120], [0, 0, 1]],
                    np.float32)


def test_project_unproject_roundtrip(rng):
    pts = rng.randn(10, 3).astype(np.float32)
    pts[:, 2] = 2.0 + np.abs(pts[:, 2])
    uvd = C.project_points(jnp.asarray(pts), jnp.asarray(_K()),
                           return_depth=True)
    back = C.unproject_points(uvd, jnp.asarray(_K()))
    np.testing.assert_allclose(np.asarray(back), pts, atol=1e-4)


def test_project_manual_golden():
    pts = np.array([[0.5, -0.25, 2.0]], np.float32)
    uv = np.asarray(C.project_points(jnp.asarray(pts), jnp.asarray(_K())))
    # u = fx*x/z + cx, v = fy*y/z + cy
    np.testing.assert_allclose(
        uv[0], [500 * 0.25 + 128, 480 * -0.125 + 120], atol=1e-4)


def test_project_with_distortion_matches_numpy(rng):
    pts = rng.randn(16, 3).astype(np.float32)
    pts[:, 2] = 3.0 + np.abs(pts[:, 2])
    kd = np.array([0.1, -0.05, 0.01, 0.02, 0.001], np.float32)
    uv = np.asarray(C.project_points(
        jnp.asarray(pts), jnp.asarray(_K()), dist_coef=jnp.asarray(kd)))

    # Independent numpy evaluation of the same distortion model
    # (asymmetric tangential terms as in the reference formula).
    x = pts[:, 0] / pts[:, 2]
    y = pts[:, 1] / pts[:, 2]
    r = x * x + y * y
    radial = 1 + kd[0] * r + kd[1] * r ** 2 + kd[4] * r ** 3
    xd = x * radial + 2 * kd[2] * x * y + kd[3] * (r + 2 * x * x)
    yd = y * radial + 2 * kd[3] * y * y + kd[2] * (r + 2 * y * y)
    K = _K()
    exp = np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)
    np.testing.assert_allclose(uv, exp, rtol=1e-4, atol=1e-3)


def test_weak_perspective_projection_golden():
    p3d = np.array([[[0.5, -0.5, 1.0]]], np.float32)  # (1,1,3)
    cam = np.array([[2.0, 0.1, -0.2]], np.float32)    # (1,3)
    out = np.asarray(C.weak_perspective_projection(
        jnp.asarray(p3d), jnp.asarray(cam), (640, 480)))
    # p2d = 640 * ((s*xy + t)/2 + (640,480)/(2*640))
    exp_x = 640 * ((2 * 0.5 + 0.1) / 2 + 0.5)
    exp_y = 640 * ((2 * -0.5 - 0.2) / 2 + 480 / 1280)
    np.testing.assert_allclose(out[0, 0], [exp_x, exp_y], atol=1e-3)


def test_fov_focal_roundtrip():
    f = C.focal_from_fov(256, 60.0)
    assert abs(C.fov_from_focal(256, f) - 60.0) < 1e-5


def test_recover_intrinsics(rng):
    K = _K()
    pts3d = rng.randn(50, 3).astype(np.float64)
    pts3d[:, 2] = 3 + np.abs(pts3d[:, 2])
    uv = np.asarray(C.project_points(jnp.asarray(pts3d.astype(np.float32)),
                                     jnp.asarray(K)))
    K_rec = C.recover_intrinsics(pts3d.astype(np.float32), uv)
    np.testing.assert_allclose(K_rec, K, rtol=1e-3, atol=0.5)


def test_ndc_calibration_square_image():
    K = _K()
    P = C.ndc_calibration_matrix(1.0, 100.0, K, (256, 256))
    # s1 = 2*(fx+fy)/(w+h); f1 = zfar/(zfar-znear)
    np.testing.assert_allclose(P[0, 0], 2 * (500 + 480) / 512, rtol=1e-6)
    np.testing.assert_allclose(P[2, 2], 100.0 / 99.0, rtol=1e-6)
    np.testing.assert_allclose(P[2, 3], -100.0 / 99.0, rtol=1e-6)
    assert P[3, 2] == 1.0


def test_softplus_and_inverse(rng):
    x = rng.randn(20).astype(np.float32) * 3
    s = np.asarray(C.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(s, np.log1p(np.exp(x)), rtol=1e-5)
    x_back = np.asarray(C.inverse_softplus(jnp.asarray(s)))
    np.testing.assert_allclose(x_back, x, atol=1e-4)


def test_bounded_splus_exp_in_range(rng):
    x = np.clip(rng.randn(100) * 5, -8, 8).astype(np.float32)
    z = np.asarray(C.bounded_splus_exp(jnp.asarray(x), 0.5, 4.0))
    assert np.all(z > 0.5) and np.all(z < 4.5)
    x_back = np.asarray(C.inverted_bounded_splus_exp(
        jnp.asarray(z), 0.5, 4.0))
    # f32 saturates near the bounds; tolerance reflects that.
    np.testing.assert_allclose(x_back, x, atol=5e-3)
