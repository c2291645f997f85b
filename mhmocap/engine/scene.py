"""Static scene geometry: aggregation, point cloud, contact queries.

Capability parity with the reference's scene handling:
  * masked median RGB-D aggregation over time
    (fhsog.py:180-202 `aggegrate_scene_geometry_median`);
  * depth postprocess + inverse projection to a scene point cloud
    (optimizer.py:579-584, 605-616);
  * 32-NN mean closest scene point for the contact / foot-sliding
    losses (optimizer.py:485-518).

Redesign: the point cloud keeps the static shape (H*W, 3) with a
validity mask instead of boolean compaction (XLA needs static shapes);
invalid points are excluded by +inf distances in the k-NN query.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.cameras import unproject_points
from ..ops.image import masked_temporal_median, postprocess_depthmap


class ScenePointCloud(NamedTuple):
    points: jax.Array        # (M, 3) camera-space
    valid: jax.Array         # (M,) bool
    depth: jax.Array         # (H, W) postprocessed scene depth
    depth_valid: jax.Array   # (H, W) bool (pre-fill-in validity)


def denormalize_disparity(disp, min_z, max_z):
    """Normalized disparity -> metric depth given per-frame bounds
    (optimizer.py:425: target_disp = d*(1/zmin - 1/zmax) + 1/zmax)."""
    inv = disp * (1.0 / min_z - 1.0 / max_z) + 1.0 / max_z
    return 1.0 / inv


def aggregate_scene_depth(disp, backmask, min_z, max_z):
    """Masked median over time of de-normalized background depths.

    disp: (T, H, W) normalized disparity; backmask: (T, H, W);
    min_z/max_z: (T, 1, 1). Returns (median_depth, any_valid).
    """
    depth = denormalize_disparity(disp, min_z, max_z)
    return masked_temporal_median(depth, backmask > 0.5)


def build_scene_pointcloud(scene_depth, scene_valid, cam_K,
                           use_bilateral: bool = True) -> ScenePointCloud:
    """Postprocess the aggregated depth and unproject to a point cloud.

    Mirrors optimizer.py:583-584 + update_scene_pointcloud 605-616:
    bilateral + Sobel-outlier fill-in postprocess, then UVD->3D of
    every pixel center; validity follows the aggregation mask.
    """
    H, W = scene_depth.shape
    post = postprocess_depthmap(scene_depth,
                                scene_valid.astype(scene_depth.dtype),
                                use_bilateral_filter=use_bilateral)
    xs = jnp.arange(W, dtype=post.dtype) + 0.5
    ys = jnp.arange(H, dtype=post.dtype) + 0.5
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
    uvd = jnp.stack([gx, gy, post], axis=-1).reshape(-1, 3)
    pts = unproject_points(uvd, cam_K)
    return ScenePointCloud(points=pts,
                           valid=scene_valid.reshape(-1) > 0.5,
                           depth=post,
                           depth_valid=scene_valid > 0.5)


def lowest_vertex(verts):
    """(..., V, 3) -> (..., 1, 3): the vertex with max y (y points
    down, so this is the lowest body point; optimizer.py:487-489)."""
    idx = jnp.argmax(verts[..., 1], axis=-1)
    return jnp.take_along_axis(
        verts, idx[..., None, None].repeat(3, -1), axis=-2)


def mean_knn_point(query, pcd: ScenePointCloud, k: int = 32):
    """Mean of the k nearest valid scene points for each query point.

    query: (..., 3) -> (..., 3). The reference takes the mean of the 32
    argsort-closest points (optimizer.py:494-500); here the candidate
    set comes from `lax.approx_min_k`. On the GPU (and the CPU) XLA
    compiles it into an exact sort (a CUB radix sort on the H100,
    `script/knn_lowering.py`) plus a slice, so the 32 neighbours are
    exact there; an approximate backend (recall ~0.95) would give a
    mean that is statistically indistinguishable for a 65k-point
    cloud.
    """
    q = query.reshape(-1, 3)
    d2 = jnp.sum(jnp.square(q[:, None] - pcd.points[None]), axis=-1)
    d2 = jnp.where(pcd.valid[None], d2, jnp.inf)
    _, idx = jax.lax.approx_min_k(d2, k)            # (Q, k)
    gathered = pcd.points[idx]                      # (Q, k, 3)
    ok = pcd.valid[idx][..., None]
    mean = jnp.sum(jnp.where(ok, gathered, 0.0), axis=1) \
        / jnp.clip(jnp.sum(ok, axis=1), 1)
    return mean.reshape(query.shape)


def contact_targets(verts_abs, poses_T, pcd: ScenePointCloud,
                    k: int = 32, offset: float = 0.02):
    """Per-body contact statistics for the contact/foot-sliding terms.

    verts_abs: (..., N, V, 3); poses_T: (..., N, 1, 3).
    Returns (low_verts (..., N, 1, 3),
             contact_dist_vertical (..., N, 1, 1),
             target_poses_T (..., N, 1, 3)) where target_poses_T is the
    detached translation target shifted down onto the scene surface
    (optimizer.py:502-506).
    """
    low = lowest_vertex(verts_abs)
    closest = mean_knn_point(low, pcd, k=k)
    contact_dist = (closest - low)[..., 1:2]       # (..., N, 1, 1)
    shift = jnp.concatenate(
        [jnp.zeros_like(contact_dist), contact_dist + offset,
         jnp.zeros_like(contact_dist)], axis=-1)   # y-only shift
    target = jax.lax.stop_gradient(poses_T + shift)
    return low, contact_dist, target
