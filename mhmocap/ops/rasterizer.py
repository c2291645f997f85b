"""Differentiable mesh rasterization: z-buffer depth + soft silhouette.

JAX replacement for the capability the reference gets from
PyTorch3D's CUDA rasterizer + SoftSilhouetteShader (reference
optimizer.py:209-232 builds a MeshRasterizer with blur_radius=1e-4 /
faces_per_pixel=8 for depth and blur_radius=2e-5 / faces_per_pixel=4
for silhouettes; optimizer.py:427-448 consumes zbuf in the metric
depth domain).

Design (static shapes):
  * rasterization happens on a fixed-size square crop window per body,
    positioned at the projected-vertex bbox center (people cover a
    small fraction of the frame at the working resolution, reference
    configs resize_factor=0.125) — full-image products are never
    materialized;
  * the brute reference processes faces in chunks with a `lax.scan`
    carrying the running z-min and the running sum of log(1 -
    coverage), so memory is O(window^2 * chunk) regardless of face
    count; the scan is rematerialized under AD. On the GPU the kernel
    in ops/raster_pallas visits only the (pixel cell, face chunk)
    pairs whose bounding boxes overlap, with the same semantics;
  * depth is the hard minimum of screen-space-barycentric interpolated
    camera z over covering faces (same semantics as the reference's
    zbuf[..., 0] with perspective_correct=False);
  * silhouette coverage per face is sigmoid(-d_signed^2 / blur) with
    d^2 the signed squared pixel distance to the triangle (negative
    inside), alpha-composited as 1 - prod(1 - p) over ALL faces in
    log space (the reference composites the 4 nearest; distant faces
    contribute p ~= 0, so the product over all faces is equivalent and
    needs no per-pixel face sorting).

Distances are computed in pixel units; the NDC blur radii of the
reference convert via blur_px^2 = blur_ndc * (min(H, W)/2)^2.

Two distance semantics (RasterSettings.sil_mode):
  * "edge_lines" (default, what the kernel computes): the
    signed distance is max over the face's three unit-normalized edge
    LINE functions — every per-(pixel, face) quantity (the three edge
    distances and interpolated z) is then affine in the pixel coords,
    so a face costs 4 precomputed planes + a handful of FMAs
    instead of three point-segment projections. Exact inside the
    triangle and in the edge Voronoi regions; in the corner wedges
    outside it underestimates the true distance by at most the wedge
    geometry (<= sqrt(2) for right angles), i.e. the soft silhouette
    is marginally wider around vertices — a sub-blur-radius
    (~0.6 px) effect.
  * "segment": exact point-to-triangle (segment) distance, matching
    PyTorch3D's definition; kept as the semantic reference and for
    parity tests.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .cameras import project_points


class RasterSettings(NamedTuple):
    image_size: Tuple[int, int]      # (W, H)
    window: int = 128                # crop window side, pixels
    face_chunk: int = 128            # faces per scan step
    blur_ndc_depth: float = 1e-4     # reference optimizer.py:213
    blur_ndc_sil: float = 2e-5       # reference optimizer.py:223
    znear: float = 1.0
    zfar: float = 100.0
    # Tiled path: bin faces to tile*tile pixel tiles, keeping only the
    # `faces_per_tile` nearest faces whose (blur-expanded) bbox
    # overlaps each tile. ~50x less pair work than brute force at the
    # SMPL face count; exact wherever a tile's overlapping-face count
    # is below the cap (z-nearest faces are kept, so the front surface
    # always survives).
    use_tiles: bool = True
    tile: int = 4
    faces_per_tile: int = 512
    tile_chunk: int = 64             # gathered faces per scan step
    # Cull faces clearly facing away from the camera during binning
    # (outward-normal test with a grazing margin). They can win neither
    # the z-buffer (closed mesh) nor the silhouette soft edge, and
    # culling halves the tile occupancy. Disable for meshes with
    # inconsistent winding.
    backface_cull: bool = False
    grazing_margin: float = 0.5      # keep faces within this cos-angle
    # Backend: "pallas" (the GPU kernel in ops/raster_pallas), "brute"
    # (the plain reference scan), "tiles", or "auto" (see
    # `resolve_backend`).
    backend: str = "auto"
    # Distance semantics: "edge_lines" (affine planes, what the kernel
    # computes; see module docstring) or "segment" (exact
    # point-triangle distance, PyTorch3D parity).
    sil_mode: str = "edge_lines"
    # The caller promises `faces` is already in a spatially coherent
    # static order (see `spatial_face_order`), so the kernel skips its
    # per-call face sort. Output is identical up to silhouette
    # summation order.
    preordered: bool = False
    # Run the kernel in the Pallas interpreter (CPU tests only; it is
    # never inferred from the platform).
    interpret: bool = False

    @property
    def sil_blur_px2(self) -> float:
        s = min(self.image_size) / 2.0
        return float(self.blur_ndc_sil * s * s)

    @property
    def depth_blur_px2(self) -> float:
        s = min(self.image_size) / 2.0
        return float(self.blur_ndc_depth * s * s)


def face_planes(fuv, fz, znear, eps: float = 1e-12):
    """Per-face affine plane coefficients for the pair test.

    fuv: (F, 3, 2) screen-space face vertices; fz: (F, 3) camera z.
    Returns (planes (F, 12) f32, bbox (F, 4) f32 stop-gradient,
    ok_sil (F,) bool, ok_depth (F,) bool): the 12 plane columns are
    three unit-normalized edge line functions (nx, ny, c) oriented
    inside-negative followed by the z interpolation plane (za, zb, zc),
    so that for a pixel p:
        d_i(p)  = nx_i*px + ny_i*py + c_i      (signed edge distance)
        d(p)    = max(max_i d_i(p), bbox_d(p)) (<= 0 inside)
        z(p)    = za*px + zb*py + zc           (barycentric z,
                                                perspective_correct=False)
    bbox = (lox, hix, loy, hiy) clamps the signed distance with the
    Chebyshev distance to the face's bbox — without it, near-degenerate
    slivers leak coverage along the infinite extension of their edge
    LINES (beyond the sliver tip all three line distances stay <= 0).
    ok_sil gates silhouette contributions (all verts in front of the
    camera), ok_depth additionally requires a non-degenerate screen
    area.

    This is plain differentiable JAX; autodiff through it provides the
    plane->vertex chain rule for the Pallas kernel's custom VJP.
    """
    ax, ay = fuv[:, 0, 0], fuv[:, 0, 1]
    bx, by = fuv[:, 1, 0], fuv[:, 1, 1]
    cx, cy = fuv[:, 2, 0], fuv[:, 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    sgn = jnp.where(area < 0, -1.0, 1.0)

    def edge(x0, y0, x1, y1):
        ex, ey = x1 - x0, y1 - y0
        inv_len = jax.lax.rsqrt(jnp.maximum(ex * ex + ey * ey, eps))
        return (sgn * ey * inv_len, -sgn * ex * inv_len,
                sgn * (ex * y0 - ey * x0) * inv_len)

    n0x, n0y, c0 = edge(ax, ay, bx, by)
    n1x, n1y, c1 = edge(bx, by, cx, cy)
    n2x, n2y, c2 = edge(cx, cy, ax, ay)

    ok_area = jnp.abs(area) > 1e-9
    inv_a = jnp.where(ok_area, 1.0, 0.0) / jnp.where(ok_area, area, 1.0)
    z0, z1, z2 = fz[:, 0], fz[:, 1], fz[:, 2]
    za = (z0 * (by - cy) + z1 * (cy - ay) + z2 * (ay - by)) * inv_a
    zb = (z0 * (cx - bx) + z1 * (ax - cx) + z2 * (bx - ax)) * inv_a
    zc = (z0 * (bx * cy - by * cx) + z1 * (cx * ay - cy * ax)
          + z2 * (ax * by - ay * bx)) * inv_a

    planes = jnp.stack([n0x, n0y, c0, n1x, n1y, c1, n2x, n2y, c2,
                        za, zb, zc], axis=-1)
    bbox = jax.lax.stop_gradient(jnp.stack(
        [jnp.min(fuv[..., 0], axis=1), jnp.max(fuv[..., 0], axis=1),
         jnp.min(fuv[..., 1], axis=1), jnp.max(fuv[..., 1], axis=1)],
        axis=-1))
    ok_sil = jnp.all(fz > znear, axis=-1)
    return planes, bbox, ok_sil, ok_sil & ok_area


def spatial_face_order(v_template, faces,
                       band: float = 0.05) -> np.ndarray:
    """Static spatially coherent face ordering from TEMPLATE geometry.

    Boustrophedon sweep over template face centroids: 5 cm y-bands,
    serpentine x within each band. Each run of `face_chunk`
    consecutive faces (raster_pallas.GEOMETRY) becomes one of the
    kernel's chunks; for mostly-upright bodies the template (y, x)
    layout survives articulation well enough that the posed per-chunk
    bboxes stay tight (a 3-D Morton order mixes depth-separated
    surface that the y-band sweep keeps apart). Computing the order
    once per model on the host replaces the kernel's per-call sort of
    the face table. The reference has no analog
    (PyTorch3D re-bins faces on GPU every call,
    reference optimizer.py:209-232).

    Returns an int32 permutation; use `faces[order]` together with
    `RasterSettings.preordered=True`.
    """
    v = np.asarray(v_template, np.float64)
    f = np.asarray(faces)
    c = v[f].mean(axis=1)
    b = np.floor((c[:, 1] - c[:, 1].min()) / band)
    x = np.where(b % 2 == 0, c[:, 0], -c[:, 0])
    return np.lexsort((x, b)).astype(np.int32)


def preorder_faces(model, band: float = 0.05, verts=None):
    """Return a copy of `model` with faces permuted by
    `spatial_face_order`, ready for `RasterSettings.preordered=True`
    (the Predictor, bench, and driver entries all use this).

    `verts` (optional, (V, 3)) orders by a REPRESENTATIVE POSED body
    instead of the T-pose template, for sequences whose people share
    a strongly non-upright pose. Measured on the bench workload this
    is NOT a default win: one body's articulation noise does not
    transfer to the others (+3.4% exact-overlap pairs vs template),
    so the Predictor keeps the template sweep. The order is traced
    DATA (a gather of the face array), so the choice never recompiles
    any program.

    Face ORDER is irrelevant to LBS, the losses, and mesh export, but
    anything holding indices INTO the face array (e.g. landmark
    `lmk_face_idx` tables, which SMPL-H/X ship) refers to the original
    ordering — resolve such tables against the unpermuted model, or
    remap them with the returned permutation's inverse.
    """
    import jax.numpy as jnp
    src = model.v_template if verts is None else verts
    order = spatial_face_order(src, model.faces, band=band)
    return model.replace(
        faces=jnp.asarray(np.asarray(model.faces)[order]))


def eval_planes(px, py, planes, bbox, znear):
    """Evaluate plane-mode pair quantities on broadcastable pixel grids.

    px, py: broadcastable against planes[..., 0]; planes: (..., 12);
    bbox: (..., 4). Returns (d2s signed squared distance, zi,
    inside-geometry): the shared semantics of all three backends in
    "edge_lines" mode. Callers compose coverage as
    inside & ok_depth & (zi > znear).
    """
    d0 = planes[..., 0] * px + planes[..., 1] * py + planes[..., 2]
    d1 = planes[..., 3] * px + planes[..., 4] * py + planes[..., 5]
    d2 = planes[..., 6] * px + planes[..., 7] * py + planes[..., 8]
    zi = planes[..., 9] * px + planes[..., 10] * py + planes[..., 11]
    bb = jnp.maximum(jnp.maximum(bbox[..., 0] - px, px - bbox[..., 1]),
                     jnp.maximum(bbox[..., 2] - py, py - bbox[..., 3]))
    # at exact ties the gradient goes to the FIRST maximal term (d0,
    # d1, d2, then the bbox, which is data), the kernel's rule;
    # jnp.maximum would split it between the tied terms
    m = jax.lax.stop_gradient(
        jnp.maximum(jnp.maximum(d0, jnp.maximum(d1, d2)), bb))
    d = jnp.where(d0 == m, d0, jnp.where(d1 == m, d1,
                                         jnp.where(d2 == m, d2, m)))
    return d * jnp.abs(d), zi, d <= 0


def _point_triangle_signed_d2(px, py, tri):
    """Signed squared distance of pixels to a screen-space triangle.

    px, py: (..., ) pixel center coordinates (broadcast against tri).
    tri: (..., 3, 2) triangle vertices in pixel space.
    Returns (d2_signed, inside): d2 negative inside the triangle.
    """
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]

    def edge(x0, y0, x1, y1):
        # cross((p - v0), (v1 - v0)) and squared distance to segment
        ex, ey = x1 - x0, y1 - y0
        pxr, pyr = px - x0, py - y0
        cross = pxr * ey - pyr * ex
        ee = ex * ex + ey * ey
        t = jnp.clip((pxr * ex + pyr * ey) / jnp.maximum(ee, 1e-12), 0., 1.)
        dx = pxr - t * ex
        dy = pyr - t * ey
        return cross, dx * dx + dy * dy

    c0, d0 = edge(ax, ay, bx, by)
    c1, d1 = edge(bx, by, cx, cy)
    c2, d2 = edge(cx, cy, ax, ay)
    area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    s = jnp.sign(area2)
    # c_i = (p - v0) x (v1 - v0) = -E_i(p); inside <=> s * c_i <= 0
    # for every edge, for either winding.
    inside = ((s * c0 <= 0) & (s * c1 <= 0) & (s * c2 <= 0)
              & (jnp.abs(area2) > 1e-9))
    dmin = jnp.minimum(d0, jnp.minimum(d1, d2))
    return jnp.where(inside, -dmin, dmin), inside


def _barycentric_z(px, py, tri, z):
    """Screen-space barycentric interpolation of per-vertex z.

    tri: (..., 3, 2), z: (..., 3). perspective_correct=False semantics
    (reference optimizer.py:215).
    """
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    inv = 1.0 / jnp.where(jnp.abs(area) > 1e-9, area, 1e-9)
    w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv
    w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv
    w2 = 1.0 - w0 - w1
    return w0 * z[..., 0] + w1 * z[..., 1] + w2 * z[..., 2]


def window_origin(uv, z, settings: RasterSettings):
    """Crop-window origin (x0, y0) for one body from projected verts.

    Centers the window on the bbox of the in-front-of-camera verts,
    clamped to the image. Non-differentiable by construction.
    """
    W, H = settings.image_size
    win = settings.window
    ok = (z > settings.znear)[..., None]
    big = jnp.asarray([W, H], uv.dtype)
    lo = jnp.min(jnp.where(ok, uv, big), axis=0)
    hi = jnp.max(jnp.where(ok, uv, -big), axis=0)
    center = jax.lax.stop_gradient(0.5 * (lo + hi))
    origin = jnp.round(center - win / 2.0).astype(jnp.int32)
    max_xy = jnp.asarray([max(W - win, 0), max(H - win, 0)], jnp.int32)
    return jnp.clip(origin, 0, max_xy)


def _raster_window_planes(fuv, fz, face_ok, origin,
                          settings: RasterSettings):
    """Brute-force raster in "edge_lines" mode (same semantics as the
    Pallas kernel, without the y-sorted strip skipping): all faces
    against all window pixels via the affine planes."""
    win = settings.window
    chunk = settings.face_chunk
    fuv_l = fuv - origin.astype(fuv.dtype)
    planes, bbox, ok_sil, ok_depth = face_planes(fuv_l, fz,
                                                 settings.znear)
    ok_sil = ok_sil & face_ok
    ok_depth = ok_depth & face_ok

    F = fuv.shape[0]
    pad = (-F) % chunk
    if pad:
        planes = jnp.concatenate(
            [planes, jnp.zeros((pad, 12), planes.dtype)])
        bbox = jnp.concatenate([bbox, jnp.zeros((pad, 4), bbox.dtype)])
        ok_sil = jnp.concatenate([ok_sil, jnp.zeros((pad,), bool)])
        ok_depth = jnp.concatenate([ok_depth, jnp.zeros((pad,), bool)])

    xs = jnp.arange(win, dtype=fuv.dtype) + 0.5
    px = xs[None, :, None]
    py = xs[:, None, None]
    inv_blur = 1.0 / settings.sil_blur_px2

    def chunk_step(carry, inp):
        zmin, logkeep = carry
        cpl, cbb, coks, cokd = inp
        d2s, zi, inside = eval_planes(px, py, cpl[None, None],
                                      cbb[None, None], settings.znear)
        covered = inside & cokd[None, None] & (zi > settings.znear)
        zmin = jnp.minimum(
            zmin, jnp.min(jnp.where(covered, zi, jnp.inf), axis=-1))
        ls = jax.nn.log_sigmoid(d2s * inv_blur)
        logkeep = logkeep + jnp.sum(
            jnp.where(coks[None, None], ls, 0.0), axis=-1)
        return (zmin, logkeep), None

    init = (jnp.full((win, win), jnp.inf, fuv.dtype),
            jnp.zeros((win, win), fuv.dtype))
    n_chunks = (F + pad) // chunk
    (zbuf, logkeep), _ = jax.lax.scan(
        jax.checkpoint(chunk_step), init,
        (planes.reshape(n_chunks, chunk, 12),
         bbox.reshape(n_chunks, chunk, 4),
         ok_sil.reshape(n_chunks, chunk),
         ok_depth.reshape(n_chunks, chunk)))
    return zbuf, 1.0 - jnp.exp(logkeep)


def _raster_window(fuv, fz, face_ok, origin, settings: RasterSettings):
    """Rasterize one body's faces onto its crop window.

    fuv: (F, 3, 2) face vertices in pixel coords; fz: (F, 3) camera z;
    face_ok: (F,) bool; origin: (2,) int32.
    Returns (zbuf (win, win), sil (win, win)); zbuf = +inf where empty.
    """
    if settings.sil_mode == "edge_lines":
        return _raster_window_planes(fuv, fz, face_ok, origin, settings)
    win = settings.window
    chunk = settings.face_chunk
    F = fuv.shape[0]
    pad = (-F) % chunk
    if pad:
        fuv = jnp.concatenate([fuv, jnp.zeros((pad, 3, 2), fuv.dtype)])
        fz = jnp.concatenate([fz, jnp.zeros((pad, 3), fz.dtype)])
        face_ok = jnp.concatenate([face_ok, jnp.zeros((pad,), bool)])

    xs = origin[0] + jnp.arange(win, dtype=fuv.dtype) + 0.5
    ys = origin[1] + jnp.arange(win, dtype=fuv.dtype) + 0.5
    px = xs[None, :, None]          # (1, win, 1) broadcast vs faces
    py = ys[:, None, None]          # (win, 1, 1)

    inv_blur = 1.0 / settings.sil_blur_px2

    def chunk_step(carry, inp):
        zmin, logkeep = carry
        cuv, cz, cok = inp          # (chunk,3,2), (chunk,3), (chunk,)
        # Cull faces fully behind the near plane (reference clips at
        # znear=1 through the NDC transform).
        ok = cok & jnp.all(cz > settings.znear, axis=-1)
        tri = cuv[None, None]       # (1, 1, chunk, 3, 2)
        d2s, inside = _point_triangle_signed_d2(px, py, tri)
        zi = _barycentric_z(px, py, tri, cz[None, None])
        covered = inside & ok[None, None] & (zi > settings.znear)
        zmin = jnp.minimum(
            zmin, jnp.min(jnp.where(covered, zi, jnp.inf), axis=-1))
        # log(1 - sigmoid(-d2/blur)) = log_sigmoid(d2/blur)
        ls = jax.nn.log_sigmoid(d2s * inv_blur)
        logkeep = logkeep + jnp.sum(
            jnp.where(ok[None, None], ls, 0.0), axis=-1)
        return (zmin, logkeep), None

    init = (jnp.full((win, win), jnp.inf, fuv.dtype),
            jnp.zeros((win, win), fuv.dtype))
    n_chunks = (F + pad) // chunk
    # Rematerialize each face-chunk step under AD: the backward pass
    # then recomputes one chunk's (win, win, chunk) pair tensors at a
    # time instead of storing them for every scan step (which OOMs at
    # ~bodies * win^2 * F floats).
    (zbuf, logkeep), _ = jax.lax.scan(
        jax.checkpoint(chunk_step), init,
        (fuv.reshape(n_chunks, chunk, 3, 2),
         fz.reshape(n_chunks, chunk, 3),
         face_ok.reshape(n_chunks, chunk)))
    sil = 1.0 - jnp.exp(logkeep)
    return zbuf, sil


def _bin_faces_to_tiles(fuv_local, fz, face_ok,
                        settings: RasterSettings):
    """Per-tile nearest-K overlapping face indices.

    fuv_local: (F, 3, 2) face verts in window-local pixel coords.
    Returns (idx (NT, K) int32, valid (NT, K) bool) with NT =
    (win/tile)^2 tiles in row-major (ty, tx) order. Selection is by
    smallest face z among faces whose bbox (expanded by the soft-blur
    reach) overlaps the tile — the z-buffer front surface and the
    silhouette band are preserved; only saturated interior/backside
    faces can be dropped when a tile exceeds the cap.
    """
    win, tile = settings.window, settings.tile
    nt = win // tile
    K = min(settings.faces_per_tile, fuv_local.shape[0])
    # ~3 sigma of the silhouette soft edge, in pixels
    reach = 3.0 * float(np.sqrt(settings.sil_blur_px2)) + 1.0

    lo = jnp.min(fuv_local, axis=1) - reach       # (F, 2)
    hi = jnp.max(fuv_local, axis=1) + reach
    tx0 = jnp.arange(nt, dtype=fuv_local.dtype) * tile   # tile x starts
    # overlap test per (tile_axis, face): bbox vs [t0, t0 + tile)
    ovx = (lo[None, :, 0] < tx0[:, None] + tile) & \
          (hi[None, :, 0] >= tx0[:, None])        # (nt, F)
    ovy = (lo[None, :, 1] < tx0[:, None] + tile) & \
          (hi[None, :, 1] >= tx0[:, None])        # (nt, F)
    overlap = ovy[:, None, :] & ovx[None, :, :]   # (nty, ntx, F)
    overlap = overlap.reshape(nt * nt, -1) & face_ok[None]

    zmin = jnp.min(fz, axis=-1)                   # (F,)
    priority = jnp.where(overlap, -zmin[None], -jnp.inf)
    # approximate selection: near-tie recall loss only affects which
    # of the overflow faces are dropped.
    neg_key, idx = jax.lax.approx_max_k(priority, K)   # (NT, K)
    valid = jnp.isfinite(neg_key)
    return jax.lax.stop_gradient(idx), valid


def _raster_window_tiled(fuv, fz, face_ok, origin,
                         settings: RasterSettings):
    """Tile-binned rasterization of one body's crop window.

    Same outputs as `_raster_window`, ~50x less pair work: each
    tile*tile pixel block only evaluates its own nearest-K overlapping
    faces, gathered per scan step.
    """
    win, tile = settings.window, settings.tile
    nt = win // tile
    NT = nt * nt
    assert win % tile == 0

    fuv_local = fuv - origin.astype(fuv.dtype)    # window-local coords
    idx, valid = _bin_faces_to_tiles(
        jax.lax.stop_gradient(fuv_local), jax.lax.stop_gradient(fz),
        face_ok, settings)
    K = idx.shape[1]
    kc = min(settings.tile_chunk, K)
    pad = (-K) % kc
    if pad:
        idx = jnp.concatenate(
            [idx, jnp.zeros((NT, pad), idx.dtype)], axis=1)
        valid = jnp.concatenate(
            [valid, jnp.zeros((NT, pad), bool)], axis=1)
        K += pad

    # per-tile pixel centers, window-local: (NT, tile*tile)
    t_idx = jnp.arange(NT)
    ty0 = (t_idx // nt * tile).astype(fuv.dtype)
    tx0 = (t_idx % nt * tile).astype(fuv.dtype)
    off = jnp.arange(tile, dtype=fuv.dtype) + 0.5
    oy, ox = jnp.meshgrid(off, off, indexing="ij")  # [r,c] = off[r|c]
    px = tx0[:, None, None] + ox.reshape(1, tile * tile, 1)
    py = ty0[:, None, None] + oy.reshape(1, tile * tile, 1)

    inv_blur = 1.0 / settings.sil_blur_px2
    use_planes = settings.sil_mode == "edge_lines"
    if use_planes:
        planes, pbbox, ok_sil, ok_depth = face_planes(fuv_local, fz,
                                                      settings.znear)
        ok_sil = ok_sil & face_ok
        ok_depth = ok_depth & face_ok

    def chunk_step(carry, inp):
        zmin_acc, logkeep = carry
        cidx, cok = inp               # (NT, kc), (NT, kc)
        if use_planes:
            cpl = planes[cidx]        # (NT, kc, 12)
            cbb = pbbox[cidx]
            oks = cok & ok_sil[cidx]
            okd = cok & ok_depth[cidx]
            d2s, zi, inside = eval_planes(px, py, cpl[:, None],
                                          cbb[:, None],
                                          settings.znear)
            covered = inside & okd[:, None] & (zi > settings.znear)
            sil_ok = oks[:, None]
        else:
            cuv = fuv_local[cidx]     # (NT, kc, 3, 2)
            cz = fz[cidx]             # (NT, kc, 3)
            ok = cok & jnp.all(cz > settings.znear, axis=-1)
            tri = cuv[:, None]        # (NT, 1, kc, 3, 2)
            d2s, inside = _point_triangle_signed_d2(px, py, tri)
            zi = _barycentric_z(px, py, tri, cz[:, None])
            covered = inside & ok[:, None] & (zi > settings.znear)
            sil_ok = ok[:, None]
        zmin_acc = jnp.minimum(
            zmin_acc, jnp.min(jnp.where(covered, zi, jnp.inf), axis=-1))
        ls = jax.nn.log_sigmoid(d2s * inv_blur)
        logkeep = logkeep + jnp.sum(
            jnp.where(sil_ok, ls, 0.0), axis=-1)
        return (zmin_acc, logkeep), None

    init = (jnp.full((NT, tile * tile), jnp.inf, fuv.dtype),
            jnp.zeros((NT, tile * tile), fuv.dtype))
    n_steps = K // kc
    (zbuf_t, logkeep_t), _ = jax.lax.scan(
        jax.checkpoint(chunk_step), init,
        (idx.reshape(NT, n_steps, kc).transpose(1, 0, 2),
         valid.reshape(NT, n_steps, kc).transpose(1, 0, 2)))

    def untile(x):
        return x.reshape(nt, nt, tile, tile).transpose(
            0, 2, 1, 3).reshape(win, win)

    return untile(zbuf_t), untile(1.0 - jnp.exp(logkeep_t))


def rasterize_body(verts, faces, cam_K, settings: RasterSettings):
    """Depth + silhouette raster of one body on its crop window.

    verts: (V, 3) camera-space; faces: (F, 3) int; cam_K: (3, 3).
    Returns dict(zbuf, sil, origin): zbuf/sil are (win, win), origin is
    the (x0, y0) of the window in image coordinates.
    """
    backend = resolve_backend(settings)
    if backend == "pallas":
        out = rasterize_bodies(verts[None], faces, cam_K, settings)
        return jax.tree_util.tree_map(lambda x: x[0], out)

    uvz = project_points(verts, cam_K, return_depth=True)
    uv, z = uvz[..., :2], uvz[..., 2]
    # Behind-camera verts project to mirrored positions; guard the
    # window/bbox logic and face validity with a z test instead.
    origin = window_origin(uv, z, settings)
    fuv = uv[faces]                  # (F, 3, 2)
    fz = z[faces]                    # (F, 3)
    face_ok = jnp.all(fz > settings.znear, axis=-1)
    if (backend == "tiles" and settings.use_tiles
            and settings.window % settings.tile == 0):
        bin_ok = face_ok
        if settings.backface_cull:
            tri3 = verts[faces]      # (F, 3, 3) camera space
            n = jnp.cross(tri3[:, 1] - tri3[:, 0],
                          tri3[:, 2] - tri3[:, 0])
            c = jnp.mean(tri3, axis=1)
            cosang = (jnp.sum(n * c, axis=-1)
                      / jnp.clip(jnp.linalg.norm(n, axis=-1)
                                 * jnp.linalg.norm(c, axis=-1), 1e-9))
            # outward normals: facing-away faces have cos > 0; keep a
            # grazing band so silhouette-edge faces survive
            bin_ok = bin_ok & (cosang < settings.grazing_margin)
        zbuf, sil = _raster_window_tiled(fuv, fz, bin_ok, origin,
                                         settings)
    else:
        zbuf, sil = _raster_window(fuv, fz, face_ok, origin, settings)
    return {"zbuf": zbuf, "sil": sil, "origin": origin}


def resolve_backend(settings: RasterSettings,
                    platform: str | None = None) -> str:
    """The raster backend `settings` selects on `platform` (default:
    JAX's default backend). "auto" picks the kernel on "gpu" and the
    brute scan on "cpu" (the tiles path's binning compiles and runs
    slower than the dense scan at CPU test sizes); any other platform
    has no tuned path and raises."""
    if settings.backend != "auto":
        return settings.backend
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "brute"
    raise ValueError(f"no raster backend for platform {platform!r}; "
                     f"name one in RasterSettings.backend")


def rasterize_bodies(verts, faces, cam_K, settings: RasterSettings):
    """`rasterize_body` over a leading batch axis.

    verts: (B, V, 3) -> zbuf/sil (B, win, win), origin (B, 2). The
    kernel takes the batch as a grid axis; the other backends vmap.
    """
    if resolve_backend(settings) == "pallas":
        from .raster_pallas import rasterize_bodies_pallas
        return rasterize_bodies_pallas(verts, faces, cam_K, settings)
    return jax.vmap(
        lambda v: rasterize_body(v, faces, cam_K, settings))(verts)


def full_image_raster(verts, faces, cam_K, image_size,
                      face_chunk: int = 256, **kw):
    """Rasterize the full image (window == image). For tests and small
    images; production paths use the crop-window API."""
    W, H = image_size
    assert W == H, "full_image_raster expects a square image"
    settings = RasterSettings(image_size=image_size, window=W,
                              face_chunk=face_chunk, **kw)
    out = rasterize_body(verts, faces, cam_K, settings)
    assert out["zbuf"].shape == (H, W)
    return out


def scatter_window_to_image(window_vals, origin, image_size, fill=0.0):
    """Place a (win, win) window back into a full (H, W) image.

    Utility for visualization/debugging (the optimizer never needs
    full images).
    """
    W, H = image_size
    win = window_vals.shape[-1]
    img = jnp.full(window_vals.shape[:-2] + (H, W), fill,
                   window_vals.dtype)
    return jax.lax.dynamic_update_slice(
        img, window_vals,
        (0,) * (window_vals.ndim - 2) + (origin[1], origin[0])
        if window_vals.ndim > 2 else (origin[1], origin[0]))
