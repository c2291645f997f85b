"""Raster kernel (ops/raster_pallas) against the brute reference, in
the Pallas interpreter on CPU, plus its schedule, layout, backend
choice and CUDA lowering (which needs no card)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.ops import rasterizer as R
from mhmocap.ops import raster_pallas as RP
from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.models.smpl import smpl_forward
from mhmocap.ops.cameras import intrinsics_from_fov

K32 = np.array([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]], np.float32)


def _tri_mesh():
    verts = np.array([
        [-0.2, -0.2, 2.0], [0.3, -0.1, 2.0], [0.0, 0.35, 2.0],
        [-0.1, -0.3, 4.0], [0.5, -0.2, 4.0], [0.1, 0.5, 4.0],
    ], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return verts, faces


def _brute_and_kernel(st):
    return (st._replace(backend="brute"),
            st._replace(backend="pallas", interpret=True))


def test_pallas_matches_brute_triangles():
    """Forward on two triangles (one occluding the other)."""
    verts, faces = _tri_mesh()
    st = R.RasterSettings(image_size=(32, 32), window=32, face_chunk=2)
    sb, sk = _brute_and_kernel(st)
    args = (jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(K32))
    o_ref, o_k = R.rasterize_body(*args, sb), R.rasterize_body(*args, sk)
    np.testing.assert_array_equal(np.asarray(o_ref["origin"]),
                                  np.asarray(o_k["origin"]))
    z_r, z_k = np.asarray(o_ref["zbuf"]), np.asarray(o_k["zbuf"])
    assert np.isfinite(z_r).sum() > 20
    assert (np.isfinite(z_r) == np.isfinite(z_k)).all()
    both = np.isfinite(z_r)
    np.testing.assert_allclose(z_k[both], z_r[both], atol=1e-5)
    np.testing.assert_allclose(np.asarray(o_k["sil"]),
                               np.asarray(o_ref["sil"]), atol=1e-5)


def test_pallas_gradients_match_brute():
    """d(loss)/d(verts) of the custom-VJP kernel (face-major backward)
    against JAX AD through the brute reference."""
    verts, faces = _tri_mesh()
    st = R.RasterSettings(image_size=(32, 32), window=32, face_chunk=2)
    sb, sk = _brute_and_kernel(st)
    target = np.zeros((32, 32), np.float32)
    target[10:20, 10:20] = 1.0

    def loss_with(settings, v):
        out = R.rasterize_body(v, jnp.asarray(faces), jnp.asarray(K32),
                               settings)
        sil_l = jnp.sum(jnp.square(out["sil"] - jnp.asarray(target)))
        zb = jnp.where(jnp.isfinite(out["zbuf"]), out["zbuf"], 0.0)
        return sil_l + 0.1 * jnp.sum(zb)

    g_ref = np.asarray(jax.grad(lambda v: loss_with(sb, v))(
        jnp.asarray(verts)))
    g_k = np.asarray(jax.grad(lambda v: loss_with(sk, v))(
        jnp.asarray(verts)))
    assert np.isfinite(g_k).all()
    np.testing.assert_allclose(g_k, g_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(g_ref).max())


@pytest.mark.slow
def test_pallas_matches_brute_body():
    """Full-body forward and gradient over a batch, both face orders,
    at a window that is not a whole number of cells."""
    model = make_synthetic_smpl(num_vertices=384, seed=1)
    K = jnp.asarray(intrinsics_from_fov((48, 48), 60.0))
    out = smpl_forward(model, jnp.zeros((2, 10)), jnp.zeros((2, 72)),
                       transl=jnp.asarray([[0.0, 0.3, 1.6],
                                           [0.1, 0.2, 1.9]]))
    v = out["verts"]
    st = R.RasterSettings(image_size=(48, 48), window=40, face_chunk=64)
    sb, sk = _brute_and_kernel(st)
    mp = R.preorder_faces(model)

    def loss(settings, faces, w):
        o = R.rasterize_bodies(w, faces, K, settings)
        zb = jnp.where(jnp.isfinite(o["zbuf"]), o["zbuf"], 0.0)
        return jnp.sum(o["sil"] ** 2) + 0.01 * jnp.sum(zb), o

    (_, o_ref), g_ref = jax.value_and_grad(
        lambda w: loss(sb, model.faces, w), has_aux=True)(v)
    for faces, s in ((model.faces, sk),
                     (mp.faces, sk._replace(preordered=True))):
        (_, o_k), g_k = jax.value_and_grad(
            lambda w: loss(s, faces, w), has_aux=True)(v)
        z_r, z_k = np.asarray(o_ref["zbuf"]), np.asarray(o_k["zbuf"])
        assert np.isfinite(z_r).sum() > 30
        assert (np.isfinite(z_r) == np.isfinite(z_k)).all()
        both = np.isfinite(z_r)
        np.testing.assert_allclose(z_k[both], z_r[both], atol=1e-5)
        np.testing.assert_allclose(np.asarray(o_k["sil"]),
                                   np.asarray(o_ref["sil"]), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(g_k), np.asarray(g_ref), rtol=1e-3,
            atol=1e-3 * np.abs(np.asarray(g_ref)).max())


@pytest.mark.slow
def test_pallas_gradient_descends_silhouette():
    """One gradient step must reduce a silhouette alignment loss."""
    model = make_synthetic_smpl(num_vertices=512, seed=2)
    K = jnp.asarray(intrinsics_from_fov((64, 64), 60.0))
    st = R.RasterSettings(image_size=(64, 64), window=64,
                          backend="pallas", interpret=True)

    def render_sil(t):
        out = smpl_forward(model, jnp.zeros((1, 10)),
                           jnp.zeros((1, 72)), transl=t)
        r = R.rasterize_body(out["verts"][0], model.faces, K, st)
        # compare in image space: windows of the target and the
        # current render can have different origins
        return R.scatter_window_to_image(r["sil"], r["origin"],
                                         (64, 64))

    target = np.asarray(render_sil(jnp.asarray([[0.1, 0.3, 3.0]])))

    def loss(t):
        return jnp.sum(jnp.square(render_sil(t) - target))

    t0 = jnp.asarray([[0.0, 0.3, 3.0]])
    l0, g = jax.value_and_grad(loss)(t0)
    t1 = t0 - 0.005 * g / (jnp.linalg.norm(g) + 1e-9)
    assert float(loss(t1)) < float(l0)


def test_pallas_preordered_matches_dynamic():
    """The static face order (spatial_face_order + preordered=True)
    is a permutation: identical coverage and z, silhouette to
    summation order, and the same plane gradients after the unsort."""
    verts, faces = _tri_mesh()
    verts = np.concatenate([verts, verts + [0.05, 0.02, 0.5]])
    faces = np.concatenate([faces, faces + 6])
    st = R.RasterSettings(image_size=(32, 32), window=32,
                          backend="pallas", interpret=True)
    order = np.array([2, 0, 3, 1])
    args = (jnp.asarray(K32),)

    def loss(w, f, s):
        o = R.rasterize_body(w, jnp.asarray(f), *args, s)
        zb = jnp.where(jnp.isfinite(o["zbuf"]), o["zbuf"], 0.0)
        return jnp.sum(o["sil"] ** 2) + 0.01 * jnp.sum(zb), o

    v = jnp.asarray(verts)
    (_, o_d), g_d = jax.value_and_grad(loss, has_aux=True)(v, faces, st)
    (_, o_p), g_p = jax.value_and_grad(loss, has_aux=True)(
        v, faces[order], st._replace(preordered=True))
    z_d, z_p = np.asarray(o_d["zbuf"]), np.asarray(o_p["zbuf"])
    assert (np.isfinite(z_d) == np.isfinite(z_p)).all()
    both = np.isfinite(z_d)
    np.testing.assert_array_equal(z_p[both], z_d[both])
    np.testing.assert_allclose(np.asarray(o_p["sil"]),
                               np.asarray(o_d["sil"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_d),
                               rtol=1e-4, atol=1e-6)


def _random_agg(rng, nc, win):
    lo = rng.uniform(-40, win + 20, (nc, 2))
    ext = rng.uniform(1, 50, (nc, 2))
    agg = np.stack([lo[:, 0], lo[:, 0] + ext[:, 0],
                    lo[:, 1], lo[:, 1] + ext[:, 1]], axis=1)
    # a few empty chunks (the BIG/-BIG sentinels _pack_table emits)
    for i in rng.choice(nc, rng.randint(0, nc // 2 + 1), replace=False):
        agg[i] = [RP.BIG, -RP.BIG, RP.BIG, -RP.BIG]
    return agg.astype(np.float32)


@pytest.mark.parametrize("geo", [
    RP.GEOMETRY, RP.KernelGeometry(cell_h=16, cell_w=16),
    RP.KernelGeometry(cell_h=8, cell_w=32)], ids=str)
@pytest.mark.parametrize("win", [64, 40])
def test_strip_chunk_lists_cover_all_overlaps(geo, win):
    """Both kernels visit every overlapping (cell, chunk) pair exactly
    once and no other: the forward through its x-sorted row list
    slice plus bbox test, the face-major backward through its cell
    rectangle. The forward slice is also tight at its start (its
    first entry reaches the cell in x)."""
    rng = np.random.RandomState(7)
    ncy, ncx = RP._grid_cells(win, geo)
    for trial in range(10):
        nc = rng.randint(2, 12)
        agg = _random_agg(rng, nc, win)
        lists, bounds = (np.asarray(x) for x in RP._row_chunk_lists(
            jnp.asarray(agg), win, geo))
        rects = np.asarray(RP._chunk_cell_rects(jnp.asarray(agg), win,
                                                geo))
        bwd = {}
        for c, (cx0, nx, cy0, ny) in enumerate(rects):
            for i in range(nx * ny):
                key = (cy0 + i // nx, cx0 + i % nx, c)
                bwd[key] = bwd.get(key, 0) + 1
        for cy in range(ncy):
            y0, y1 = cy * geo.cell_h, (cy + 1) * geo.cell_h
            for cx in range(ncx):
                x0, x1 = cx * geo.cell_w, (cx + 1) * geo.cell_w
                lo, hi = bounds[cy * ncx + cx]
                sliced = list(lists[cy, lo:hi])
                assert len(set(sliced)) == len(sliced)
                for c in range(nc):
                    hit = (agg[c, 0] < x1 and agg[c, 1] >= x0
                           and agg[c, 2] < y1 and agg[c, 3] >= y0)
                    assert (c in sliced) >= hit, (trial, cy, cx, c)
                    assert bwd.get((cy, cx, c), 0) == int(hit), \
                        (trial, cy, cx, c)
                if lo < hi:
                    assert agg[lists[cy, lo], 1] >= x0


@pytest.mark.parametrize("win", [32, 40, 112])
def test_cell_layout_roundtrip(win):
    """Cell-major layout <-> window, with padding to whole cells."""
    geo = RP.GEOMETRY
    x = jnp.arange(2 * win * win, dtype=jnp.float32).reshape(2, win, win)
    cells = RP._window_to_cells(x, win, geo, -1.0)
    ncy, ncx = RP._grid_cells(win, geo)
    assert cells.shape == (2, ncy * ncx, geo.cell_h * geo.cell_w)
    np.testing.assert_array_equal(RP._cells_to_window(cells, win, geo),
                                  x)
    assert int((cells == -1.0).sum()) == 2 * (
        ncy * ncx * geo.cell_h * geo.cell_w - win * win)


def test_pack_table_folds_validity():
    """Invalid and padding faces become constant planes (no coverage,
    zero silhouette); chunk bboxes cover only valid faces."""
    fc = 4
    planes = jnp.asarray(np.random.RandomState(0).randn(6, 12),
                         jnp.float32)
    bbox = jnp.asarray([[0, 4, 0, 4]] * 6, jnp.float32) + jnp.arange(
        6, dtype=jnp.float32)[:, None]
    ok_sil = jnp.asarray([1, 1, 0, 1, 0, 0], bool)
    ok_depth = jnp.asarray([1, 0, 0, 1, 0, 0], bool)
    tab, agg = (np.asarray(a) for a in RP._pack_table(
        planes, bbox, ok_sil, ok_depth, 1.5, fc))
    assert tab.shape == (RP.TAB_ROWS, 8) and agg.shape == (2, 4)
    for f in (2, 4, 5, 6, 7):                       # invalid / padding
        np.testing.assert_array_equal(tab[:9, f], [0, 0, RP.D_INVALID]
                                      + [0] * 6)
        assert tab[11, f] == -RP.D_INVALID
    assert tab[11, 1] == -RP.D_INVALID and tab[9:12, 0].any()
    np.testing.assert_allclose(agg[0], [-1.5, 8.5, -1.5, 8.5])
    np.testing.assert_allclose(agg[1], [RP.BIG, -RP.BIG, RP.BIG, -RP.BIG])


def test_resolve_backend_single_choice():
    """'auto' picks the kernel on gpu and brute on cpu, raises on any
    other platform; interpret mode is never inferred."""
    st = R.RasterSettings(image_size=(32, 32))
    assert R.resolve_backend(st, "gpu") == "pallas"
    assert R.resolve_backend(st, "cpu") == "brute"
    for platform in ("rocm", "metal", "other"):
        with pytest.raises(ValueError):
            R.resolve_backend(st, platform)
    assert R.resolve_backend(st._replace(backend="tiles"), "gpu") == \
        "tiles"
    assert R.resolve_backend(st) == "brute"         # tests run on cpu
    assert st.interpret is False
    assert R.RasterSettings(image_size=(8, 8),
                            backend="pallas").interpret is False


@pytest.mark.parametrize("win", [160, 128, 112])
def test_kernel_lowers_for_cuda(win):
    """Both kernels lower to Triton for CUDA at the production widths
    (full body, 48 bodies) — on the CPU, without a card."""
    model = R.preorder_faces(make_synthetic_smpl())
    K = jnp.asarray(intrinsics_from_fov((256, 256), 60.0))
    st = R.RasterSettings(image_size=(256, 256), window=win,
                          backend="pallas", preordered=True)
    v = jnp.zeros((48, model.num_vertices, 3)) + jnp.asarray([0, 0, 3.4])

    def loss(w):
        o = R.rasterize_bodies(w, model.faces, K, st)
        return jnp.sum(o["sil"]) + jnp.sum(
            jnp.where(jnp.isfinite(o["zbuf"]), o["zbuf"], 0.0))

    text = jax.jit(jax.grad(loss)).trace(v).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2
