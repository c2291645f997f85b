"""Frustum Human-Scene Occupancy Grids (FHSOG) and related geometry.

Capability parity with reference `mhmocap/fhsog.py` (C10 in the survey
inventory): median scene aggregation lives in engine/scene.py (the
only part the optimizer uses, fhsog.py:180-202); this module provides
the research-path capabilities:
  * frustum occupancy grid from background depths (fhsog.py:80-135)
  * over-compositing a depth map from fog alphas (fhsog.py:12-24)
  * points-inside-mesh queries (fhsog.py:27-77)
  * fog carving with body meshes (fhsog.py:138-177)
  * Gaussian distance fields via an exact Euclidean distance
    transform (fhsog.py:205-231) — the EDT is a JAX implementation of
    the two-pass Felzenszwalb lower-envelope algorithm instead of
    scipy's C version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.cameras import unproject_points


# ---------------------------------------------------------------------------
# Euclidean distance transform (separable lower-envelope, exact)
# ---------------------------------------------------------------------------

def _edt_1d(f: jax.Array, spacing: float) -> jax.Array:
    """Exact 1-D squared EDT of a sampled function f (Felzenszwalb &
    Huttenlocher), vectorized over leading axes via vmap by the caller.

    f: (n,) squared-distance seed values (0 at features, +inf else).
    Implemented as a double scan (forward/backward relaxation), which
    converges to the exact lower envelope for quadratic distance
    because d[i] <= d[i-1] + (2*k+1)*s^2 propagation is exact on
    grids.
    """
    n = f.shape[0]
    s2 = spacing * spacing

    def fwd(carry, fi):
        # carry = (best distance so far at previous cell, steps since)
        d_prev, k = carry
        cand = d_prev + (2 * k + 1) * s2
        d = jnp.minimum(fi, cand)
        k = jnp.where(d == fi, 0, k + 1)
        return (d, k), d

    (_, _), d1 = lax.scan(fwd, (jnp.inf, jnp.array(0)), f)
    (_, _), d2 = lax.scan(fwd, (jnp.inf, jnp.array(0)), d1[::-1])
    return d2[::-1]


def distance_transform_edt(mask: jax.Array,
                           sampling: Optional[Tuple[float, ...]] = None
                           ) -> jax.Array:
    """Exact Euclidean distance transform of a binary mask.

    Distance from nonzero cells to the nearest ZERO cell (scipy
    semantics). mask: (H, W) or (n,). Returns float distances.
    """
    mask = jnp.asarray(mask)
    if mask.ndim == 1:
        s = sampling[0] if sampling else 1.0
        f = jnp.where(mask == 0, 0.0, jnp.inf)
        return jnp.sqrt(_edt_1d(f, s))
    assert mask.ndim == 2
    H, W = mask.shape
    sy, sx = sampling if sampling else (1.0, 1.0)
    f = jnp.where(mask == 0, 0.0, jnp.inf)
    # pass 1: columns (axis 0)
    d = jax.vmap(lambda c: _edt_1d(c, sy), in_axes=1, out_axes=1)(f)
    # pass 2: rows, with the parabola lower envelope over squared dists
    d = jax.vmap(lambda r: _lower_envelope(r, sx))(d)
    return jnp.sqrt(d)


def _lower_envelope(f: jax.Array, spacing: float) -> jax.Array:
    """Exact 1-D lower envelope of parabolas rooted at f (squared
    distances): d[i] = min_j f[j] + s^2 (i-j)^2, O(n^2) vectorized
    (n is an image side here, <= a few hundred)."""
    n = f.shape[0]
    i = jnp.arange(n, dtype=f.dtype)
    diff = (i[:, None] - i[None, :]) * spacing
    return jnp.min(f[None, :] + diff * diff, axis=1)


def gaussian_distance_field_1d(x, sampling=None, sigma: float = 1.0):
    """(fhsog.py:205-212)."""
    n = x.shape[0]
    s = sampling[0] if sampling else 1.0 / n
    edt = distance_transform_edt(x, (s,))
    return ((1.0 / (sigma * np.sqrt(2 * math.pi)))
            * jnp.exp(-jnp.square(edt) / jnp.square(sigma))
            ).astype(jnp.float32)


def gaussian_distance_field_2d(omap, sampling=None, sigma: float = 1.0):
    """(fhsog.py:215-231): GDF zeroed at the feature cells."""
    H, W = omap.shape
    s = sampling if sampling else (1.0 / H, 1.0 / W)
    edt = distance_transform_edt(omap, s)
    gdf = ((1.0 / (sigma * np.sqrt(2 * math.pi)))
           * jnp.exp(-jnp.square(edt) / jnp.square(sigma)))
    return (gdf * (edt > 0)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Occupancy grids
# ---------------------------------------------------------------------------

def over_composite_from_fog(fog_alpha: jax.Array, near_z: float = 1.0,
                            far_z: float = 100.0) -> jax.Array:
    """Front-to-back over-compositing of log-spaced fog slabs into a
    depth map (fhsog.py:12-24)."""
    D, H, W = fog_alpha.shape
    dval = jnp.linspace(np.log(near_z), np.log(far_z), D)[:, None, None]
    trans = jnp.cumprod(1.0 - fog_alpha, axis=0)
    blend = jnp.concatenate([jnp.ones((1, H, W)), trans[:-1]], axis=0)
    return jnp.exp(jnp.sum(dval * fog_alpha * blend, axis=0))


def build_fhs_occupancy_grid(depths, images, backmasks, min_z, max_z,
                             cam_K=None, num_depth_bins: int = 128):
    """Frustum occupancy grid + background texture from per-frame
    background RGB-D (fhsog.py:80-135).

    depths: (T, H, W) normalized disparity; images: (T, H, W, 3);
    backmasks: (T, H, W); min_z/max_z: (T, 1, 1).
    Returns (fog_alpha (D, H, W), back_mask (H, W), texture (H, W, 3),
    near_z, far_z).
    """
    T, H, W = depths.shape
    D = num_depth_bins
    de = 1.0 / (depths * (1.0 / min_z - 1.0 / max_z) + 1.0 / max_z)
    near_z = 0.999 * jnp.median(min_z)
    far_z = 1.001 * jnp.median(max_z)

    mask = ((backmasks > 0.5) & (de >= near_z) & (de <= far_z))
    vlog = ((jnp.log(jnp.clip(de, near_z, far_z)) - jnp.log(near_z))
            / (jnp.log(far_z) - jnp.log(near_z)))
    idx = jnp.where(mask, 1 + (D * vlog).astype(jnp.int32), 0)
    idx = jnp.clip(idx, 0, D)

    # histogram over depth bins per pixel: one-hot scatter-add
    grid = jnp.zeros((D + 1, H, W), jnp.int32)
    flat = idx.reshape(T, -1)
    pix = jnp.tile(jnp.arange(H * W)[None], (T, 1))
    grid = grid.reshape(D + 1, -1).at[
        flat.reshape(-1), pix.reshape(-1)].add(1).reshape(D + 1, H, W)

    mask_acc = T - grid[0]
    texture = (jnp.sum(images * mask[..., None], axis=0)
               / jnp.clip(mask_acc, 1)[..., None])
    back_mask = (mask_acc > 0)
    texture = jnp.where(back_mask[..., None], texture, 255.0)

    # binarize: occupied from the per-pixel argmax bin onward
    amax = jnp.argmax(grid[1:], axis=0)
    d_idx = jnp.arange(D)[:, None, None]
    fog_alpha = (back_mask[None] & (amax[None] <= d_idx)).astype(
        jnp.float32)
    return fog_alpha, back_mask, texture.astype(jnp.uint8), near_z, far_z


def points_inside_mesh(verts, faces, points, eps: float = 1e-2):
    """Boolean inside-mask for points vs a closed mesh, using the
    closest-face normal test (fhsog.py:27-77 semantics: a point is
    inside when the vector from the closest face center to it opposes
    the outward normal).

    verts: (V, 3); faces: (F, 3); points: (N, 3) -> (N,) bool.
    """
    tri = verts[faces]                       # (F, 3, 3)
    centers = jnp.mean(tri, axis=1)          # (F, 3)
    d2 = jnp.sum(jnp.square(points[:, None] - centers[None]), axis=-1)
    closest = jnp.argmin(d2, axis=1)         # (N,)
    ctri = tri[closest]
    c = centers[closest]
    n = jnp.cross(ctri[:, 1] - ctri[:, 0], ctri[:, 2] - ctri[:, 1])
    n = n / jnp.clip(jnp.linalg.norm(n, axis=1, keepdims=True), 1e-3)
    v = points - c
    v = v / jnp.clip(jnp.linalg.norm(v, axis=1, keepdims=True), eps)
    return jnp.sum(n * v, axis=1) < -eps / 10


def carve_fog_with_meshes(fog, verts, faces, near_z, far_z, cam_K):
    """Indices of solid fog voxels lying inside any of the given body
    meshes (fhsog.py:138-177). Host-friendly; returns a boolean grid
    of carved voxels with the fog's shape.

    verts: (B, V, 3) camera-space bodies.
    """
    D, H, W = fog.shape
    uu = jnp.linspace(0.5, W - 0.5, W)
    vv = jnp.linspace(0.5, H - 0.5, H)
    dd = jnp.exp(jnp.linspace(jnp.log(near_z), jnp.log(far_z), D))
    gu, gv, gd = jnp.meshgrid(uu, vv, dd, indexing="xy")
    uvd = jnp.stack([gu, gv, gd], axis=-1).reshape(-1, 3)
    pts = unproject_points(uvd, cam_K)

    solid = fog.transpose(1, 2, 0).reshape(-1) > 0
    inside_any = jnp.zeros(pts.shape[0], bool)
    for b in range(verts.shape[0]):
        inside_any = inside_any | points_inside_mesh(
            verts[b], faces, pts)
    carved = solid & inside_any
    return carved.reshape(H, W, D).transpose(2, 0, 1)


def build_fhsog_from_smpl(depths_metric, images, backmasks, verts,
                          faces, cam_K, near_z: float, far_z: float,
                          num_depth_bins: int = 128,
                          sigma: float = 0.25,
                          person_sigma: float = 5.0):
    """SMPL-conditioned FHSOG (reference fhsog.py:234-296).

    Accumulates, over frames, a Gaussian-distance-field-weighted
    occupancy along log-spaced depth bins, gated in depth by where the
    rasterized people actually are: each frame renders all N bodies
    (our JAX rasterizer replaces the reference's PyTorch3D loop),
    masks the background to cells that are neither body nor out of
    the frustum, and adds GDF mass at each pixel's depth bin weighted
    by a 1-D GDF around the per-person average depths.

    depths_metric: (T, H, W) metric depth; images: (T, H, W, 3) f32;
    backmasks: (T, H, W); verts: (T, N, V, 3) camera space;
    faces: (F, 3). Returns (fhsog_alpha (D, H, W), texture (H, W, 3),
    outmask (H, W), smpl_masks (T, H, W), gdfs (T, H, W)).

    Reference quirk reproduced: a body with ZERO rasterized pixels
    (out of frame / fully occluded) gets avg depth 0, which the clip
    maps to near_z — its person-depth gate then sits at bin 0 for
    that frame (reference fhsog.py:263-269 does exactly this).
    """
    from ..ops.rasterizer import RasterSettings, rasterize_bodies

    T, N = verts.shape[:2]
    H, W = depths_metric.shape[1:]
    D = num_depth_bins

    # full-image raster: a square window covering the whole (possibly
    # rectangular) frame — window_origin clamps to (0, 0) when the
    # window is at least the image in both axes, and the out-of-frame
    # strip of the square render is cropped right after the kernel
    # (the reference's build_fhsog_from_smpl_2 takes arbitrary HxW,
    # fhsog.py:252-256)
    S = -(-max(H, W) // 8) * 8
    st = RasterSettings(image_size=(W, H), window=S)
    backseg = ((backmasks > 0.5) & (depths_metric > near_z)
               & (depths_metric < far_z))
    log_span = float(np.log(far_z) - np.log(near_z))

    def frame_bins(depth_hw):
        vlog = ((jnp.log(jnp.clip(depth_hw, near_z, far_z))
                 - np.log(near_z)) / log_span)
        return jnp.clip((D * vlog - 0.5).astype(jnp.int32), 0, D - 1)

    def one_frame(carry, inp):
        fhsog_alpha, texture = carry
        v_t, depth_t, img_t, backseg_t = inp
        r = rasterize_bodies(v_t, faces, cam_K, st)
        zb = r["zbuf"][:, :H, :W]                    # (N, H, W)
        zmask = jnp.isfinite(zb) & (zb > 0)
        zb_safe = jnp.where(zmask, zb, 0.0)
        smpl_mask = jnp.any(zmask, axis=0)           # (H, W)
        avg_pd = (jnp.sum(zb_safe, axis=(1, 2))
                  / jnp.clip(jnp.sum(zmask, axis=(1, 2)), 1))
        avg_pd = jnp.clip(avg_pd, near_z, far_z)     # (N,)

        gdf2 = gaussian_distance_field_2d(
            (backseg_t & ~smpl_mask).astype(jnp.float32), sigma=sigma)

        person_bins = jnp.clip(
            (D * (jnp.log(avg_pd) - np.log(near_z)) / log_span - 0.5
             ).astype(jnp.int32), 0, D - 1)
        person_vec = jnp.ones((D,)).at[person_bins].set(0.0)
        person_gdf = gaussian_distance_field_1d(
            person_vec, sigma=person_sigma)          # (D,)

        idx = frame_bins(depth_t)                    # (H, W)
        gval = gdf2 * person_gdf[idx]                # (H, W)
        fhsog_alpha = fhsog_alpha.at[
            idx.reshape(-1),
            jnp.arange(H * W)].add(gval.reshape(-1))
        texture = texture + gval[..., None] * img_t
        return (fhsog_alpha, texture), (smpl_mask, gdf2)

    init = (jnp.zeros((D, H * W), jnp.float32),
            jnp.zeros((H, W, 3), jnp.float32))
    (fhsog_alpha, texture), (smpl_masks, gdfs) = lax.scan(
        one_frame, init,
        (verts, depths_metric, images.astype(jnp.float32), backseg))
    fhsog_alpha = fhsog_alpha.reshape(D, H, W)
    outmask = jnp.sum(fhsog_alpha, axis=0)
    texture = jnp.clip(
        texture / jnp.clip(outmask[..., None], 0.1), 0, 255)
    return fhsog_alpha, texture, outmask, smpl_masks, gdfs
