import numpy as np
import pytest
import jax.numpy as jnp
from scipy.ndimage import distance_transform_edt as scipy_edt

from mhmocap.engine import fhsog as F


def test_edt_matches_scipy_2d(rng):
    mask = (rng.rand(40, 56) > 0.9).astype(np.float32)
    mask[0, 0] = 0  # ensure at least one zero
    ours = np.asarray(F.distance_transform_edt(jnp.asarray(mask)))
    golden = scipy_edt(mask)
    np.testing.assert_allclose(ours, golden, atol=1e-4)


def test_edt_matches_scipy_2d_sampling(rng):
    mask = np.ones((20, 20), np.float32)
    mask[10, 5] = 0
    ours = np.asarray(F.distance_transform_edt(
        jnp.asarray(mask), (0.5, 2.0)))
    golden = scipy_edt(mask, sampling=(0.5, 2.0))
    np.testing.assert_allclose(ours, golden, atol=1e-4)


def test_edt_1d(rng):
    mask = np.ones((30,), np.float32)
    mask[7] = 0
    mask[20] = 0
    ours = np.asarray(F.distance_transform_edt(jnp.asarray(mask)))
    golden = scipy_edt(mask)
    np.testing.assert_allclose(ours, golden, atol=1e-5)


def test_gaussian_distance_fields(rng):
    omap = np.ones((16, 16), np.float32)
    omap[8, 8] = 0
    g = np.asarray(F.gaussian_distance_field_2d(jnp.asarray(omap),
                                                sigma=0.5))
    assert g[8, 8] == 0.0  # zeroed at features
    assert g[8, 9] > g[8, 12]  # decays with distance


def test_over_composite_from_fog():
    D, H, W = 8, 4, 4
    fog = np.zeros((D, H, W), np.float32)
    fog[3] = 1.0  # opaque slab at bin 3
    depth = np.asarray(F.over_composite_from_fog(jnp.asarray(fog),
                                                 near_z=1, far_z=100))
    expected = np.exp(np.linspace(np.log(1), np.log(100), D)[3])
    np.testing.assert_allclose(depth, expected, rtol=1e-5)


def test_points_inside_mesh_sphere(rng):
    # icosphere-ish: sample a sphere via fibonacci lattice + hull
    from scipy.spatial import ConvexHull
    n = 200
    i = np.arange(n)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    pts = np.stack([np.sin(phi) * np.cos(theta),
                    np.sin(phi) * np.sin(theta),
                    np.cos(phi)], axis=1).astype(np.float32)
    hull = ConvexHull(pts)
    faces = hull.simplices.astype(np.int32)
    # fix winding outward
    tri = pts[faces]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.sum(nrm * tri.mean(1), axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]

    queries = np.array([[0, 0, 0], [0.5, 0, 0], [1.5, 0, 0],
                        [0, 0, -2.0]], np.float32)
    inside = np.asarray(F.points_inside_mesh(
        jnp.asarray(pts), jnp.asarray(faces), jnp.asarray(queries)))
    assert inside[0] and inside[1]
    assert not inside[2] and not inside[3]


def test_build_fhs_occupancy_grid_shapes(rng):
    T, H, W, D = 4, 16, 16, 8
    depths = rng.rand(T, H, W).astype(np.float32)
    images = (255 * rng.rand(T, H, W, 3)).astype(np.float32)
    back = np.ones((T, H, W), np.float32)
    min_z = np.full((T, 1, 1), 2.0, np.float32)
    max_z = np.full((T, 1, 1), 8.0, np.float32)
    fog, mask, tex, nz, fz = F.build_fhs_occupancy_grid(
        jnp.asarray(depths), jnp.asarray(images), jnp.asarray(back),
        jnp.asarray(min_z), jnp.asarray(max_z), num_depth_bins=D)
    assert fog.shape == (D, H, W)
    assert mask.shape == (H, W)
    assert tex.shape == (H, W, 3)
    assert float(nz) < float(fz)
    # occupancy is monotone in depth (carved from argmax onward)
    fogn = np.asarray(fog)
    assert (np.diff(fogn, axis=0) >= 0).all()


@pytest.mark.slow
def test_build_fhsog_from_smpl(rng):
    """SMPL-conditioned FHSOG (reference fhsog.py:234-296): mass
    accumulates only in background cells away from the rendered
    people, gated near the people's depth bins."""
    from mhmocap.models.synthetic import make_synthetic_smpl
    from mhmocap.models.smpl import smpl_forward
    from mhmocap.ops.cameras import intrinsics_from_fov

    T, N, side, D = 2, 1, 64, 16
    model = make_synthetic_smpl(num_vertices=512, seed=4)
    K = jnp.asarray(intrinsics_from_fov((side, side), 60.0))
    out = smpl_forward(model, jnp.zeros((T * N, 10)),
                       jnp.zeros((T * N, 72)),
                       transl=jnp.tile(jnp.asarray([[0.0, 0.3, 3.0]]),
                                       (T * N, 1)))
    verts = out["verts"].reshape(T, N, -1, 3)
    depths = np.full((T, side, side), 6.0, np.float32)
    images = (255 * rng.rand(T, side, side, 3)).astype(np.float32)
    back = np.ones((T, side, side), np.float32)

    fog, tex, outmask, smpl_masks, gdfs = F.build_fhsog_from_smpl(
        jnp.asarray(depths), jnp.asarray(images), jnp.asarray(back),
        verts, model.faces, K, near_z=1.0, far_z=16.0,
        num_depth_bins=D)
    assert fog.shape == (D, side, side)
    assert tex.shape == (side, side, 3)
    assert smpl_masks.shape == (T, side, side)
    fogn, masks = np.asarray(fog), np.asarray(smpl_masks)
    assert masks.any(), "people must rasterize"
    # no fog mass on person pixels (GDF zeroed at/inside features)
    person_all = masks.all(axis=0)
    assert fogn[:, person_all].sum() == 0.0
    assert float(jnp.sum(fog)) > 0.0


@pytest.mark.slow
def test_build_fhsog_from_smpl_rectangular(rng):
    """Non-square frames (reference build_fhsog_from_smpl_2 accepts
    arbitrary HxW, fhsog.py:252-256): the square raster window is
    cropped back to the frame."""
    from mhmocap.models.synthetic import make_synthetic_smpl
    from mhmocap.models.smpl import smpl_forward
    from mhmocap.ops.cameras import intrinsics_from_fov

    T, N, H, W, D = 1, 1, 48, 64, 8
    model = make_synthetic_smpl(num_vertices=512, seed=4)
    K = jnp.asarray(intrinsics_from_fov((W, H), 60.0))
    out = smpl_forward(model, jnp.zeros((T * N, 10)),
                       jnp.zeros((T * N, 72)),
                       transl=jnp.tile(jnp.asarray([[0.0, 0.2, 3.0]]),
                                       (T * N, 1)))
    verts = out["verts"].reshape(T, N, -1, 3)
    depths = np.full((T, H, W), 6.0, np.float32)
    images = (255 * rng.rand(T, H, W, 3)).astype(np.float32)
    back = np.ones((T, H, W), np.float32)

    fog, tex, outmask, smpl_masks, gdfs = F.build_fhsog_from_smpl(
        jnp.asarray(depths), jnp.asarray(images), jnp.asarray(back),
        verts, model.faces, K, near_z=1.0, far_z=16.0,
        num_depth_bins=D)
    assert fog.shape == (D, H, W)
    assert tex.shape == (H, W, 3)
    assert smpl_masks.shape == (T, H, W)
    assert np.asarray(smpl_masks).any(), "person must rasterize"
    assert float(jnp.sum(fog)) > 0.0
