"""Rasterizer tests against a brute-force numpy golden rasterizer."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mhmocap.ops.rasterizer import (
    RasterSettings, rasterize_body, rasterize_bodies, full_image_raster,
    window_origin)
from mhmocap.ops.cameras import project_points


K64 = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], np.float32)


def _golden_raster(verts, faces, K, size):
    """Brute-force z-buffer + hard coverage in float64 numpy."""
    W = H = size
    uv = (verts[:, :2] / verts[:, 2:3]) @ np.diag([K[0, 0], K[1, 1]])
    uv += np.array([K[0, 2], K[1, 2]])
    z = verts[:, 2]
    zbuf = np.full((H, W), np.inf)
    cov = np.zeros((H, W), bool)
    for f in faces:
        a, b, c = uv[f[0]], uv[f[1]], uv[f[2]]
        za, zb, zc = z[f[0]], z[f[1]], z[f[2]]
        if min(za, zb, zc) <= 1.0:
            continue
        for i in range(H):
            for j in range(W):
                p = np.array([j + 0.5, i + 0.5])
                d = (b - a)[0] * (c - a)[1] - (b - a)[1] * (c - a)[0]
                if abs(d) < 1e-12:
                    continue
                w0 = ((b[0] - p[0]) * (c[1] - p[1])
                      - (b[1] - p[1]) * (c[0] - p[0])) / d
                w1 = ((c[0] - p[0]) * (a[1] - p[1])
                      - (c[1] - p[1]) * (a[0] - p[0])) / d
                w2 = 1 - w0 - w1
                if w0 >= 0 and w1 >= 0 and w2 >= 0:
                    zi = w0 * za + w1 * zb + w2 * zc
                    cov[i, j] = True
                    zbuf[i, j] = min(zbuf[i, j], zi)
    return zbuf, cov


def _tri_mesh():
    """Two triangles at different depths, overlapping in screen space."""
    verts = np.array([
        [-0.2, -0.2, 2.0], [0.3, -0.1, 2.0], [0.0, 0.35, 2.0],   # near
        [-0.1, -0.3, 4.0], [0.5, -0.2, 4.0], [0.1, 0.5, 4.0],    # far
    ], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return verts, faces


def test_zbuf_matches_golden():
    verts, faces = _tri_mesh()
    golden_z, golden_cov = _golden_raster(verts, faces, K64, 64)
    out = full_image_raster(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(K64), (64, 64), face_chunk=2)
    zbuf = np.asarray(out["zbuf"])
    # Coverage must agree except along edges (the golden uses exact
    # arithmetic; allow a 1-px disagreement band).
    inside = np.isfinite(zbuf)
    disagree = inside != golden_cov
    assert disagree.mean() < 0.02
    both = inside & golden_cov
    np.testing.assert_allclose(zbuf[both], golden_z[both], atol=1e-3)


def test_silhouette_is_sharp_and_covers_triangles():
    verts, faces = _tri_mesh()
    _, golden_cov = _golden_raster(verts, faces, K64, 64)
    out = full_image_raster(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(K64), (64, 64), face_chunk=2)
    sil = np.asarray(out["sil"])
    assert sil.min() >= 0 and sil.max() <= 1 + 1e-6
    # interior pixels ~1, far-outside pixels ~0
    interior = golden_cov & ~_edge_band(golden_cov)
    exterior = ~golden_cov & ~_edge_band(golden_cov)
    assert sil[interior].min() > 0.9
    assert sil[exterior].max() < 0.1


def _edge_band(mask):
    from scipy.ndimage import binary_dilation, binary_erosion
    return binary_dilation(mask, iterations=2) & ~binary_erosion(
        mask, iterations=2)


def test_depth_ordering_takes_nearest():
    """Where both triangles overlap, zbuf must be the near one's z."""
    verts, faces = _tri_mesh()
    out = full_image_raster(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(K64), (64, 64), face_chunk=1)
    zbuf = np.asarray(out["zbuf"])
    golden_near, _ = _golden_raster(verts, faces[:1], K64, 64)
    golden_far, _ = _golden_raster(verts, faces[1:], K64, 64)
    overlap = np.isfinite(golden_near) & np.isfinite(golden_far)
    assert overlap.sum() > 10
    np.testing.assert_allclose(zbuf[overlap], golden_near[overlap],
                               atol=1e-3)


def test_behind_camera_faces_are_culled():
    verts = np.array([[-0.2, -0.2, -2.0], [0.3, -0.1, -2.0],
                      [0.0, 0.35, -2.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    out = full_image_raster(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(K64), (64, 64), face_chunk=1)
    assert not np.isfinite(np.asarray(out["zbuf"])).any()
    assert np.asarray(out["sil"]).max() < 1e-3


def test_window_tracks_body():
    """A small body near the image corner gets a window containing it."""
    verts, faces = _tri_mesh()
    verts = verts * 0.3 + np.array([[-0.4, -0.4, 1.0]], np.float32)
    settings = RasterSettings(image_size=(256, 256), window=64,
                              face_chunk=2)
    K = np.array([[256.0, 0, 128], [0, 256.0, 128], [0, 0, 1]],
                 np.float32)
    out = rasterize_body(jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(K), settings)
    origin = np.asarray(out["origin"])
    uv = np.asarray(project_points(jnp.asarray(verts), jnp.asarray(K)))
    assert (uv[:, 0] >= origin[0]).all() and (uv[:, 1] >= origin[1]).all()
    assert (uv[:, 0] <= origin[0] + 64).all()
    assert (uv[:, 1] <= origin[1] + 64).all()
    assert np.isfinite(np.asarray(out["zbuf"])).any()


def test_silhouette_gradient_grows_coverage():
    """d(total silhouette)/d(scale) must be positive: growing the
    triangle increases coverage — the key property the silhouette loss
    relies on."""
    verts, faces = _tri_mesh()

    def total_sil(scale):
        v = jnp.asarray(verts).at[:, :2].multiply(scale)
        out = full_image_raster(v, jnp.asarray(faces), jnp.asarray(K64),
                                (64, 64), face_chunk=2)
        return jnp.sum(out["sil"])

    g = jax.grad(total_sil)(jnp.asarray(1.0))
    assert float(g) > 1.0


def test_zbuf_gradient_wrt_depth():
    """Moving the near triangle back increases covered zbuf values."""
    verts, faces = _tri_mesh()

    def mean_depth(dz):
        v = jnp.asarray(verts).at[:3, 2].add(dz)
        out = full_image_raster(v, jnp.asarray(faces), jnp.asarray(K64),
                                (64, 64), face_chunk=2)
        z = out["zbuf"]
        ok = jnp.isfinite(z)
        return jnp.sum(jnp.where(ok, z, 0.0)) / jnp.sum(ok)

    g = jax.grad(mean_depth)(jnp.asarray(0.0))
    assert 0.1 < float(g) <= 1.5


def test_tiled_backend_matches_brute():
    """The tile-binned backend must agree with the brute scan (both in
    the default edge_lines mode)."""
    verts, faces = _tri_mesh()
    common = dict(image_size=(64, 64), window=64, face_chunk=2,
                  tile=4, faces_per_tile=2)
    o_b = rasterize_body(jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(K64),
                         RasterSettings(backend="brute", **common))
    o_t = rasterize_body(jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(K64),
                         RasterSettings(backend="tiles", **common))
    z_b, z_t = np.asarray(o_b["zbuf"]), np.asarray(o_t["zbuf"])
    assert (np.isfinite(z_b) == np.isfinite(z_t)).all()
    both = np.isfinite(z_b)
    np.testing.assert_allclose(z_t[both], z_b[both], atol=1e-4)
    np.testing.assert_allclose(np.asarray(o_t["sil"]),
                               np.asarray(o_b["sil"]), atol=1e-4)


def test_segment_mode_close_to_edge_lines():
    """The fast edge_lines distance deviates from the exact segment
    distance only in sub-blur corner wedges: silhouettes must agree
    closely everywhere."""
    verts, faces = _tri_mesh()
    o_seg = full_image_raster(jnp.asarray(verts), jnp.asarray(faces),
                              jnp.asarray(K64), (64, 64), face_chunk=2,
                              sil_mode="segment")
    o_lin = full_image_raster(jnp.asarray(verts), jnp.asarray(faces),
                              jnp.asarray(K64), (64, 64), face_chunk=2,
                              sil_mode="edge_lines")
    z_s, z_l = np.asarray(o_seg["zbuf"]), np.asarray(o_lin["zbuf"])
    assert (np.isfinite(z_s) == np.isfinite(z_l)).all()
    both = np.isfinite(z_s)
    np.testing.assert_allclose(z_l[both], z_s[both], atol=1e-4)
    diff = np.abs(np.asarray(o_seg["sil"]) - np.asarray(o_lin["sil"]))
    assert diff.max() < 0.35          # only corner-wedge softness
    assert diff.mean() < 0.002


@pytest.mark.slow
def test_batched_raster_shapes():
    verts, faces = _tri_mesh()
    batch = jnp.stack([jnp.asarray(verts)] * 3)
    settings = RasterSettings(image_size=(64, 64), window=32,
                              face_chunk=2)
    out = rasterize_bodies(batch, jnp.asarray(faces), jnp.asarray(K64),
                           settings)
    assert out["zbuf"].shape == (3, 32, 32)
    assert out["sil"].shape == (3, 32, 32)
    assert out["origin"].shape == (3, 2)
