"""Camera models and bounded reparameterizations (pure JAX + numpy).

Capability parity with the reference `mhmocap/transforms.py`
(perspective projection with optional radial/tangential distortion,
inverse UVD->3D projection, ROMP weak-perspective projection,
intrinsics recovery, NDC calibration matrix, fov<->focal conversions,
softplus/bounded-exp reparameterizations; transforms.py:19-306).

Everything here is shape-polymorphic pure JAX: one function serves the
(N,3) numpy case and the batched (T,N,J,3) jit case via broadcasting,
instead of the reference's separate numpy/torch twins.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def project_points(
    pts3d: jax.Array,            # (..., P, 3) camera-space points
    K: jax.Array,                # (3, 3) or broadcastable (..., 3, 3)
    dist_coef: Optional[jax.Array] = None,  # (5,) [k1,k2,p1,p2,k3]
    return_depth: bool = False,
) -> jax.Array:
    """Pinhole perspective projection (reference transforms.py:19-95).

    Returns (..., P, 2) pixel coords, or (..., P, 3) UVD when
    `return_depth` is set. Distortion follows the OpenCV model with the
    reference's exact formula (including its asymmetric tangential
    terms, transforms.py:37-47).
    """
    z = pts3d[..., 2:3]
    xy = pts3d[..., :2] / z

    if dist_coef is not None:
        k1, k2, p1, p2, k3 = (dist_coef[i] for i in range(5))
        x, y = xy[..., 0], xy[..., 1]
        r = x * x + y * y
        radial = 1 + k1 * r + k2 * r * r + k3 * r * r * r
        xd = x * radial + 2 * p1 * x * y + p2 * (r + 2 * x * x)
        yd = y * radial + 2 * p2 * y * y + p1 * (r + 2 * y * y)
        xy = jnp.stack([xd, yd], axis=-1)

    K = jnp.asarray(K)
    fxy = jnp.stack([K[..., 0, 0], K[..., 1, 1]], axis=-1)
    cxy = K[..., 0:2, 2]
    uv = xy * fxy[..., None, :] + cxy[..., None, :]
    if return_depth:
        return jnp.concatenate([uv, z], axis=-1)
    return uv


def unproject_points(uvd: jax.Array, K: jax.Array) -> jax.Array:
    """UVD (pixels + absolute depth) -> camera-space 3D points.

    (..., P, 3) -> (..., P, 3). Reference transforms.py:98-130.
    """
    K = jnp.asarray(K)
    fxy = jnp.stack([K[..., 0, 0], K[..., 1, 1]], axis=-1)
    cxy = K[..., 0:2, 2]
    z = uvd[..., 2:3]
    xy = z * (uvd[..., :2] - cxy[..., None, :]) / fxy[..., None, :]
    return jnp.concatenate([xy, z], axis=-1)


def weak_perspective_projection(
    p3d: jax.Array,              # (..., P, 3)
    cam: jax.Array,              # (..., 3) = [scale, tx, ty]
    image_size: Tuple[int, int],  # (W, H)
) -> jax.Array:
    """ROMP-style orthographic projection to pixel coordinates.

    Reference `batch_orthographic_projection` (transforms.py:133-150):
    p2d = max(W,H) * ((s*xy + t)/2 + (W,H)/(2*max(W,H))).
    """
    cam = cam[..., None, :]
    p2d = cam[..., 0:1] * p3d[..., :2] + cam[..., 1:]
    wh = jnp.asarray(image_size, dtype=p2d.dtype)
    m = float(max(image_size))
    return m * (p2d / 2.0 + wh / (2.0 * m))


def intrinsics_from_fov(image_size: Tuple[int, int],
                        fov_deg: float) -> np.ndarray:
    """Build K assuming the principal point at the image center and a
    focal length from the FOV over the smaller image side (reference
    datautils.py:605-611)."""
    w, h = image_size
    f = focal_from_fov(min(image_size), fov_deg)
    return np.array([[f, 0, w / 2.0],
                     [0, f, h / 2.0],
                     [0, 0, 1]], np.float32)


def fov_from_focal(side: float, focal: float) -> float:
    """Reference get_fov (transforms.py:258-260)."""
    return float(np.degrees(2.0 * np.arctan(0.5 * side / focal)))


def focal_from_fov(side: float, fov_deg: float) -> float:
    """Reference get_focal (transforms.py:263-265)."""
    return float(0.5 * side / np.tan(np.radians(fov_deg) / 2.0))


def recover_intrinsics(pts3d: np.ndarray, pts2d: np.ndarray) -> np.ndarray:
    """Least-squares recovery of (fx, cx, fy, cy) from 3D<->2D pairs.

    Reference transforms.py:153-182. Host-side numpy (used once per
    sequence at most).
    """
    xn = pts3d[:, 0] / pts3d[:, 2]
    yn = pts3d[:, 1] / pts3d[:, 2]

    def solve(p, q):
        A = np.stack([p, np.ones_like(p)], axis=1)
        coef, *_ = np.linalg.lstsq(A, q, rcond=None)
        return coef[0], coef[1]

    fx, cx = solve(xn, pts2d[:, 0])
    fy, cy = solve(yn, pts2d[:, 1])
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def recover_intrinsics_simplified(pts3d: np.ndarray,
                                  pts2d: np.ndarray,
                                  image_size) -> np.ndarray:
    """Recover a single focal per axis assuming the principal point at
    the image center (reference transforms.py:185-219)."""
    cx, cy = image_size[0] / 2.0, image_size[1] / 2.0
    p3 = pts3d[:, :2] / pts3d[:, 2:3]
    p2 = pts2d - np.array([[cx, cy]], np.float32)

    def solve(a, b):
        return float((a * b).sum() / np.clip((a * a).sum(), 1e-12,
                                             None))

    fx = solve(p3[:, 0], p2[:, 0])
    fy = solve(p3[:, 1], p2[:, 1])
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def ndc_calibration_matrix(znear: float, zfar: float, K: np.ndarray,
                           image_size: Tuple[int, int]) -> np.ndarray:
    """4x4 NDC projection matrix equivalent to the reference's
    PyTorch3D calibration (transforms.py:222-255): the shorter image
    side maps to [-1, 1], principal-point offsets enter the third
    column, and depth maps through f1 = zfar/(zfar-znear),
    f2 = -zfar*znear/(zfar-znear)."""
    w, h = image_size
    if w > h:
        s1 = 2 * K[1, 1] / h
        u = w / h
        w1 = u * (w - 2 * K[0, 2]) / w
        h1 = (h - 2 * K[1, 2]) / h
    elif h > w:
        s1 = 2 * K[0, 0] / w
        u = h / w
        w1 = (w - 2 * K[0, 2]) / w
        h1 = u * (h - 2 * K[1, 2]) / h
    else:
        s1 = 2 * (K[0, 0] + K[1, 1]) / (w + h)
        w1 = (w - 2 * K[0, 2]) / w
        h1 = (h - 2 * K[1, 2]) / h
    f1 = zfar / (zfar - znear)
    f2 = -(zfar * znear) / (zfar - znear)
    return np.array([[s1, 0, w1, 0],
                     [0, s1, h1, 0],
                     [0, 0, f1, f2],
                     [0, 0, 1, 0]], np.float32)


# ---------------------------------------------------------------------------
# Bounded reparameterizations (reference transforms.py:268-306). These keep
# optimized scalars in valid ranges (e.g. scene depth bounds) while the
# optimizer works in an unconstrained domain.
# ---------------------------------------------------------------------------

def softplus(x):
    """log(1 + e^x) — the reference's explicit form (transforms.py:296)."""
    return jnp.logaddexp(x, 0.0)


def inverse_softplus(s):
    """Stable inverse of softplus: log(e^s - 1)."""
    s = jnp.asarray(s)
    return s + jnp.log(-jnp.expm1(-s))


def bounded_splus_exp(x, min_val, max_val):
    """Smooth map R -> (min_val, ~max_val) (transforms.py:272-276)."""
    y = x - jnp.log(max_val - min_val) / 2.0
    s = jnp.log(1.0 / (max_val - min_val) + jnp.exp(y))
    return jnp.exp(-s) + min_val


def inverted_bounded_splus_exp(z, min_val, max_val):
    """Inverse of `bounded_splus_exp` (transforms.py:284-288)."""
    s = -jnp.log(z - min_val)
    y = jnp.log(jnp.exp(s) - 1.0 / (max_val - min_val))
    return y + jnp.log(max_val - min_val) / 2.0


def disparity_from_depth(depth, eps=1e-3):
    return 1.0 / jnp.clip(depth, eps)


def transform_points_rt(pts3d, RT):
    """Apply a (3, 4) [R|t] to (..., 3) points (transforms.py:4-16).
    Full f32: the points feed mm-accuracy metrics, and the GPU's f32
    matmul default is TF32."""
    return jnp.matmul(pts3d, RT[:, :3].T, precision=_HI) + RT[:, 3]
