"""Pallas (Triton) GPU kernel for the depth + silhouette rasterizer.

Same semantics as `rasterizer._raster_window_planes` (the brute
reference) in its "edge_lines" mode: hard z-min of plane-interpolated
z, and silhouette = 1 - prod(1 - sigmoid(-d|d|/blur)) accumulated in
log space, d = the bbox-clamped max of the normalized edge-line
distances. The brute path tests every face against every window
pixel; this kernel visits only the (pixel cell, face chunk) pairs
whose blur-expanded bounding boxes overlap.

Layout and schedule (plain JAX, outside the kernels):

  * every per-(pixel, face) quantity is AFFINE in the pixel coords, so
    each face becomes 12 plane coefficients (`rasterizer.face_planes`)
    plus its bbox. Face validity is folded into the coefficients:
    invalid and padding faces get a constant edge distance
    +D_INVALID and z = -D_INVALID, which make their soft coverage and
    its gradient exactly 0 and their depth coverage false, so the
    kernels never test per-face flags;
  * faces are grouped in chunks of `face_chunk` spatially coherent
    faces (a static template order, `rasterizer.spatial_face_order`,
    or a per-call (y-band, x) sort), each with a reach-expanded bbox;
  * the window is cut into cell_h x cell_w pixel cells (padded up to
    whole cells). Each cell row keeps an x-sorted list of the chunks
    that overlap it in y; each cell walks the [lo, hi) slice of that
    list that can reach it in x, and skips the rest of the slice with
    a 4-scalar bbox test.

Forward kernel: one program per (body, cell), grid (B, cells). Each
program loads its own schedule slice from global memory and carries
the per-pixel z-min, winner face id and log-coverage sum as (npx,)
vectors; each chunk is reduced over its faces before it is folded in.

Backward kernel: FACE-MAJOR, one program per (body, face chunk),
grid (B, chunks). A program walks the rectangle of cells its chunk's
bbox reaches (exactly the cells whose forward visited it), forms the
per-pair cotangents, and sums dC = P^T G with P = [px, py, 1] as
exact-f32 weighted column sums. Each program owns its chunk's
d(planes) slice, so the result is deterministic and needs neither
atomics nor any order between programs. Plane gradients are unsorted
outside the kernel and flow to vertices by autodiff through
`face_planes`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .cameras import project_points
from .rasterizer import RasterSettings, face_planes, window_origin


class KernelGeometry(NamedTuple):
    """Block shapes of the kernels (all powers of two). The default
    was chosen by the H100 sweep recorded in PERF.md."""
    cell_h: int = 8          # cell rows (pixels)
    cell_w: int = 16         # cell columns (pixels)
    face_chunk: int = 32     # faces per chunk
    num_warps: int = 4


GEOMETRY = KernelGeometry()

# face-table rows: three edge planes and the z plane (x, y, const
# coefficient each), then the bbox for the Chebyshev clamp
NCOEF = 12
ROW_LOX, ROW_HIX, ROW_LOY, ROW_HIY = 12, 13, 14, 15
TAB_ROWS = 16

BIG = 3.0e38         # finite stand-in for +inf
# Constant edge distance of invalid/padding faces: large enough that
# log_sigmoid(D^2 * inv_blur) is exactly 0.0f and its sigmoid
# gradient exactly 0.0f (needs D^2/blur > ~104; holds for any blur
# < 1e16 px^2), small enough that D^2 stays finite in f32.
D_INVALID = 1.0e9
_NO_FACE = 2 ** 30


def _reach(inv_blur: float) -> float:
    """Pixels beyond a face's bbox where its soft coverage is still
    counted: 3 blur sigmas plus one pixel (log_sigmoid is ~1e-10
    there at the default blur)."""
    return 3.0 / float(np.sqrt(inv_blur)) + 1.0


def _grid_cells(win: int, geo: KernelGeometry):
    """(cell rows, cell columns) covering a win x win window."""
    return -(-win // geo.cell_h), -(-win // geo.cell_w)


# ---------------------------------------------------------------------------
# Face table and schedule (plain JAX, one body; vmapped by the caller)
# ---------------------------------------------------------------------------

def _pack_table(planes, bbox, ok_sil, ok_depth, reach, fc: int):
    """Fold validity into the coefficients and pad to whole chunks.

    Returns (tab (TAB_ROWS, F_pad), agg (nc, 4)): tab[:, f] = the 12
    plane coefficients and bbox of face f; agg[c] = the reach-expanded
    bbox (xlo, xhi, ylo, yhi) of chunk c's silhouette-valid faces
    (BIG/-BIG sentinels for a chunk with none).
    """
    F = planes.shape[0]
    F_pad = -(-F // fc) * fc
    nc = F_pad // fc
    osil = ok_sil[:, None]
    edge = jnp.where(osil, planes[:, :9], 0.0)
    # invalid faces: d0 becomes the constant +D_INVALID
    edge = edge.at[:, 2].set(jnp.where(ok_sil, edge[:, 2], D_INVALID))
    zpl = jnp.where(ok_depth[:, None], planes[:, 9:12],
                    jnp.asarray([0.0, 0.0, -D_INVALID]))
    # invalid faces get a degenerate box that always loses the max
    # against their d0 = +D_INVALID
    bb = jnp.where(osil, bbox, jnp.asarray([-BIG, BIG, -BIG, BIG]))
    rows = jnp.concatenate([edge, zpl, bb], axis=1)           # (F, 16)
    if F_pad > F:
        pad = np.zeros((TAB_ROWS,), np.float32)
        pad[2], pad[11] = D_INVALID, -D_INVALID
        pad[12:] = [-BIG, BIG, -BIG, BIG]
        rows = jnp.concatenate(
            [rows, jnp.broadcast_to(jnp.asarray(pad),
                                    (F_pad - F, TAB_ROWS))])
        ok_sil = jnp.concatenate(
            [ok_sil, jnp.zeros((F_pad - F,), bool)])
        bbox = jnp.concatenate(
            [bbox, jnp.zeros((F_pad - F, 4), bbox.dtype)])
    okc = ok_sil.reshape(nc, fc)

    def side(col, init, red):
        return red(jnp.where(okc, bbox[:, col].reshape(nc, fc), init),
                   axis=1)

    agg = jnp.stack([side(0, BIG, jnp.min) - reach,
                     side(1, -BIG, jnp.max) + reach,
                     side(2, BIG, jnp.min) - reach,
                     side(3, -BIG, jnp.max) + reach], axis=1)
    return rows.T, agg


def _row_chunk_lists(agg, win: int, geo: KernelGeometry):
    """Forward schedule: per cell row, the chunks that overlap it in y
    sorted by x-lo, and per cell the [lo, hi) slice of that list that
    can reach it in x.

    hi is exact: the list is xlo-sorted, so chunks with xlo >= cell_hi
    form a contiguous tail. lo is exact too: a chunk reaches the cell
    iff its xhi >= cell_lo, and the prefix max of xhi over the list is
    non-decreasing, so the first reachable index is a searchsorted on
    it. Chunks inside the slice that still miss the cell are skipped
    by the kernel's bbox test. Returns (lists (ncy, nc) int32, bounds
    (ncy * ncx, 2) int32).
    """
    ncy, ncx = _grid_cells(win, geo)
    ch, cw = geo.cell_h, geo.cell_w
    s = jnp.arange(ncy, dtype=jnp.float32)[:, None]
    active = ((agg[None, :, 2] < (s + 1.0) * ch)
              & (agg[None, :, 3] >= s * ch))
    xlo = jnp.where(active, agg[None, :, 0], BIG)
    order = jnp.argsort(xlo, axis=1)                   # actives first
    xlo_s = jnp.take_along_axis(xlo, order, axis=1)
    xhi_s = jnp.take_along_axis(
        jnp.where(active, agg[None, :, 1], -BIG), order, axis=1)
    pmax = lax.cummax(xhi_s, axis=1)
    cell_lo = jnp.broadcast_to(
        (jnp.arange(ncx, dtype=jnp.float32) * cw)[None, :], (ncy, ncx))
    hi_idx = jax.vmap(jnp.searchsorted)(xlo_s, cell_lo + float(cw))
    lo_idx = jnp.minimum(jax.vmap(jnp.searchsorted)(pmax, cell_lo),
                         hi_idx)
    bounds = jnp.stack([lo_idx, hi_idx], axis=-1).reshape(ncy * ncx, 2)
    return order.astype(jnp.int32), bounds.astype(jnp.int32)


def _chunk_cell_rects(agg, win: int, geo: KernelGeometry):
    """Backward schedule: per chunk, the rectangle of cells its bbox
    overlaps, as (cx0, nx, cy0, ny) int32 — exactly the cells whose
    forward bbox test passes for that chunk (cell widths are powers
    of two, so the divisions are exact)."""
    ncy, ncx = _grid_cells(win, geo)

    def span(lo, hi, size, n):
        c0 = jnp.floor(jnp.clip(lo * (1.0 / size), -1.0, n))
        c1 = jnp.floor(jnp.clip(hi * (1.0 / size), -1.0, n))
        c0 = jnp.maximum(c0, 0.0)
        c1 = jnp.minimum(c1, n - 1.0)
        return c0, jnp.maximum(c1 - c0 + 1.0, 0.0)

    cx0, nx = span(agg[:, 0], agg[:, 1], geo.cell_w, ncx)
    cy0, ny = span(agg[:, 2], agg[:, 3], geo.cell_h, ncy)
    return jnp.stack([cx0, nx, cy0, ny], axis=1).astype(jnp.int32)


def _cells_to_window(x, win: int, geo: KernelGeometry):
    """(B, ncy * ncx, npx) cell-major values -> (B, win, win)."""
    ncy, ncx = _grid_cells(win, geo)
    B = x.shape[0]
    img = x.reshape(B, ncy, ncx, geo.cell_h, geo.cell_w).transpose(
        0, 1, 3, 2, 4).reshape(B, ncy * geo.cell_h, ncx * geo.cell_w)
    return img[:, :win, :win]


def _window_to_cells(x, win: int, geo: KernelGeometry, fill):
    """(B, win, win) -> (B, ncy * ncx, npx), padded with `fill`."""
    ncy, ncx = _grid_cells(win, geo)
    B = x.shape[0]
    x = jnp.pad(x, ((0, 0), (0, ncy * geo.cell_h - win),
                    (0, ncx * geo.cell_w - win)), constant_values=fill)
    return x.reshape(B, ncy, geo.cell_h, ncx, geo.cell_w).transpose(
        0, 1, 3, 2, 4).reshape(B, ncy * ncx, geo.cell_h * geo.cell_w)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _cell_pixels(cy, cx, geo: KernelGeometry):
    """Pixel-centre coordinates (npx,) of cell (cy, cx), row-major."""
    k = lax.iota(jnp.int32, geo.cell_h * geo.cell_w)
    col = lax.rem(k, geo.cell_w)
    row = lax.div(k, geo.cell_w)
    px = (cx * geo.cell_w + col).astype(jnp.float32) + 0.5
    py = (cy * geo.cell_h + row).astype(jnp.float32) + 0.5
    return px, py


def _load_faces(tab_ref, b, base, fc: int, rows):
    """Rows of the face table for faces [base, base + fc), each (1, fc)."""
    return [tab_ref[b, r, pl.ds(base, fc)][None, :] for r in rows]


def _edge_distances(px, py, t):
    """Edge-line distances d0..d2 and the bbox-clamped max d, each
    (npx, fc), from the face-table rows t."""
    px, py = px[:, None], py[:, None]
    d0 = px * t[0] + py * t[1] + t[2]
    d1 = px * t[3] + py * t[4] + t[5]
    d2 = px * t[6] + py * t[7] + t[8]
    bb = jnp.maximum(jnp.maximum(t[ROW_LOX] - px, px - t[ROW_HIX]),
                     jnp.maximum(t[ROW_LOY] - py, py - t[ROW_HIY]))
    d = jnp.maximum(jnp.maximum(d0, jnp.maximum(d1, d2)), bb)
    return d0, d1, d2, d


def _fwd_kernel(lists_ref, bounds_ref, agg_ref, tab_ref,
                zbuf_ref, logkeep_ref, amin_ref, *, ncx, inv_blur,
                znear, geo: KernelGeometry):
    b = pl.program_id(0)
    cell = pl.program_id(1)
    cy = lax.div(cell, ncx)
    cx = lax.rem(cell, ncx)
    fc = geo.face_chunk
    npx = geo.cell_h * geo.cell_w
    px, py = _cell_pixels(cy, cx, geo)
    x_lo = (cx * geo.cell_w).astype(jnp.float32)
    y_lo = (cy * geo.cell_h).astype(jnp.float32)
    x_hi = x_lo + geo.cell_w
    y_hi = y_lo + geo.cell_h
    lane = lax.broadcasted_iota(jnp.int32, (npx, fc), 1)

    def chunk_body(j, carry):
        ch = lists_ref[b, cy, j]

        def visit(carry):
            zmin, gid, logkeep = carry
            base = ch * fc
            t = _load_faces(tab_ref, b, base, fc, range(TAB_ROWS))
            _, _, _, d = _edge_distances(px, py, t)
            zi = px[:, None] * t[9] + py[:, None] * t[10] + t[11]
            # invalid/padding faces carry d = +D_INVALID and
            # z = -D_INVALID: never covered, log_sigmoid exactly 0
            covered = (d <= 0.0) & (zi > znear)
            zcov = jnp.where(covered, zi, BIG)
            zrow = jnp.min(zcov, axis=1)
            first = jnp.min(jnp.where(zcov == zrow[:, None], base + lane,
                                      _NO_FACE), axis=1)
            better = zrow < zmin
            zmin = jnp.where(better, zrow, zmin)
            gid = jnp.where(better, first, gid)
            # log(1 - sigmoid(-d|d|/blur)) = log_sigmoid(d|d|/blur)
            logkeep = logkeep + jnp.sum(
                jax.nn.log_sigmoid((d * jnp.abs(d)) * inv_blur), axis=1)
            return zmin, gid, logkeep

        hit = ((agg_ref[b, ch, 0] < x_hi) & (agg_ref[b, ch, 1] >= x_lo)
               & (agg_ref[b, ch, 2] < y_hi) & (agg_ref[b, ch, 3] >= y_lo))
        return lax.cond(hit, visit, lambda c: c, carry)

    init = (jnp.full((npx,), BIG, jnp.float32),
            jnp.zeros((npx,), jnp.int32),
            jnp.zeros((npx,), jnp.float32))
    zmin, gid, logkeep = lax.fori_loop(
        bounds_ref[b, cell, 0], bounds_ref[b, cell, 1], chunk_body, init)
    zbuf_ref[b, cell, :] = zmin
    logkeep_ref[b, cell, :] = logkeep
    amin_ref[b, cell, :] = jnp.where(zmin >= BIG, -1, gid)


def _bwd_kernel(rects_ref, tab_ref, dz_ref, dlk_ref, amin_ref,
                dtab_ref, *, ncx, inv_blur, geo: KernelGeometry):
    b = pl.program_id(0)
    ch = pl.program_id(1)
    fc = geo.face_chunk
    npx = geo.cell_h * geo.cell_w
    base = ch * fc
    t = _load_faces(tab_ref, b, base, fc, range(TAB_ROWS))
    lane = lax.broadcasted_iota(jnp.int32, (npx, fc), 1)
    cx0 = rects_ref[b, ch, 0]
    nx = rects_ref[b, ch, 1]
    cy0 = rects_ref[b, ch, 2]
    ny = rects_ref[b, ch, 3]

    def cell_body(i, acc):
        cy = cy0 + lax.div(i, nx)
        cx = cx0 + lax.rem(i, nx)
        cell = cy * ncx + cx
        px, py = _cell_pixels(cy, cx, geo)
        dz = dz_ref[b, cell, :][:, None]
        dlk = dlk_ref[b, cell, :][:, None]
        amin = amin_ref[b, cell, :][:, None]
        d0, d1, d2, d = _edge_distances(px, py, t)
        absd = jnp.abs(d)
        # silhouette: d logkeep / dd = sigmoid(-d|d|/blur) * 2|d|/blur
        # (exactly 0 for invalid/padding faces: D_INVALID saturates it)
        sig = jax.nn.sigmoid(-(d * absd) * inv_blur)
        g_d = dlk * (sig * inv_blur) * (2.0 * absd)
        # the gradient goes to the max edge (first match wins); where a
        # bbox side wins the max, d is data and gets no gradient
        use0 = d == d0
        use1 = (~use0) & (d == d1)
        use2 = (~(use0 | use1)) & (d == d2)
        # depth: only the winning face of each pixel
        gz = jnp.where(amin == base + lane, dz, 0.0)
        pxc, pyc = px[:, None], py[:, None]
        out = []
        for g in (jnp.where(use0, g_d, 0.0), jnp.where(use1, g_d, 0.0),
                  jnp.where(use2, g_d, 0.0), gz):
            out += [jnp.sum(g * pxc, axis=0), jnp.sum(g * pyc, axis=0),
                    jnp.sum(g, axis=0)]
        return tuple(a + o for a, o in zip(acc, out))

    init = tuple(jnp.zeros((fc,), jnp.float32) for _ in range(NCOEF))
    acc = lax.fori_loop(0, nx * ny, cell_body, init)
    for r in range(NCOEF):
        dtab_ref[b, r, pl.ds(base, fc)] = acc[r]


def _compiler_params(geo: KernelGeometry):
    return pltriton.CompilerParams(num_warps=geo.num_warps, num_stages=1)


def _run_forward(lists, bounds, agg, tab, win, inv_blur, znear,
                 geo: KernelGeometry, interpret: bool):
    B = tab.shape[0]
    ncy, ncx = _grid_cells(win, geo)
    npx = geo.cell_h * geo.cell_w
    cells = jax.ShapeDtypeStruct((B, ncy * ncx, npx), jnp.float32)
    return pl.pallas_call(
        functools.partial(_fwd_kernel, ncx=ncx, inv_blur=inv_blur,
                          znear=znear, geo=geo),
        grid=(B, ncy * ncx),
        out_shape=[cells, cells,
                   jax.ShapeDtypeStruct((B, ncy * ncx, npx), jnp.int32)],
        backend="triton",
        compiler_params=_compiler_params(geo),
        interpret=interpret,
        name="raster_fwd",
    )(lists, bounds, agg, tab)


def _run_backward(rects, tab, dz, dlk, amin, win, inv_blur,
                  geo: KernelGeometry, interpret: bool):
    B, _, F_pad = tab.shape
    _, ncx = _grid_cells(win, geo)
    return pl.pallas_call(
        functools.partial(_bwd_kernel, ncx=ncx, inv_blur=inv_blur,
                          geo=geo),
        grid=(B, F_pad // geo.face_chunk),
        out_shape=jax.ShapeDtypeStruct((B, NCOEF, F_pad), jnp.float32),
        backend="triton",
        compiler_params=_compiler_params(geo),
        interpret=interpret,
        name="raster_bwd",
    )(rects, tab, dz, dlk, amin)


# ---------------------------------------------------------------------------
# Public API with custom VJP
# ---------------------------------------------------------------------------

def _face_order(bbox, cell_h: int):
    """Per-call spatial order for faces that come in no useful order:
    (cell-row band of the bbox top, x centre). Keys are small integers
    and pixels, so the f32 composite is exact."""
    band = jnp.clip(jnp.floor(bbox[:, 2] * (1.0 / cell_h)), -64.0, 8192.0)
    key = band * 65536.0 + jnp.clip(0.5 * (bbox[:, 0] + bbox[:, 1]),
                                    -4096.0, 4096.0)
    return jnp.argsort(key)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6, 7))
def raster_planes_pallas(planes, extents, win: int, inv_blur: float,
                         znear: float, preordered: bool = False,
                         interpret: bool = False,
                         geo: KernelGeometry = GEOMETRY):
    """(zbuf, sil), each (B, win, win), from per-face plane coeffs.

    planes: (B, F, 12) from rasterizer.face_planes (differentiated);
    extents: (bbox (B, F, 4), ok_sil (B, F), ok_depth (B, F)), data
    only. zbuf is +inf where uncovered. preordered: the faces follow a
    static spatially coherent order (rasterizer.spatial_face_order),
    which skips the per-call sort. interpret runs the kernels in the
    Pallas interpreter (CPU tests).
    """
    out, _ = _raster_fwd(planes, extents, win, inv_blur, znear,
                         preordered, interpret, geo)
    return out


def _raster_fwd(planes, extents, win, inv_blur, znear, preordered,
                interpret, geo):
    from jax.ad_checkpoint import checkpoint_name

    bbox, ok_sil, ok_depth = extents
    reach = _reach(inv_blur)
    order = None
    if not preordered:
        order = jax.vmap(lambda bb: _face_order(bb, geo.cell_h))(bbox)
        take = jax.vmap(lambda x, o: x[o])
        planes, bbox = take(planes, order), take(bbox, order)
        ok_sil, ok_depth = take(ok_sil, order), take(ok_depth, order)
    tab, agg = jax.vmap(functools.partial(
        _pack_table, reach=reach, fc=geo.face_chunk))(
            planes, bbox, ok_sil, ok_depth)
    lists, bounds = jax.vmap(
        lambda a: _row_chunk_lists(a, win, geo))(agg)
    zmin, logkeep, amin = _run_forward(lists, bounds, agg, tab, win,
                                       inv_blur, znear, geo, interpret)
    zmin = _cells_to_window(zmin, win, geo)
    logkeep = _cells_to_window(logkeep, win, geo)
    amin = _cells_to_window(amin, win, geo)
    # Middle remat tier: under jax.checkpoint with the engine's
    # save_only_these_names policy, the backward pass keeps ONLY these
    # small kernel outputs (the custom-VJP residuals and the zbuf/sil
    # the loss consumes) and recomputes the cheap prep (SMPL forward,
    # planes, table pack), never the forward kernel itself.
    logkeep = checkpoint_name(logkeep, "raster_residuals")
    amin = checkpoint_name(amin, "raster_residuals")
    zmin = checkpoint_name(zmin, "raster_residuals")
    zbuf = jnp.where(zmin >= BIG, jnp.inf, zmin)
    sil = checkpoint_name(1.0 - jnp.exp(logkeep), "raster_residuals")
    # `shape` carries the face count in its (empty) shape
    shape = jnp.zeros((0, planes.shape[1]), jnp.float32)
    return (zbuf, sil), (tab, agg, order, logkeep, amin, shape)


def _raster_bwd(win, inv_blur, znear, preordered, interpret, geo, res,
                cot):
    tab, agg, order, logkeep, amin, shape = res
    d_zbuf, d_sil = cot
    d_z = jnp.where(jnp.isfinite(d_zbuf) & (amin >= 0), d_zbuf, 0.0)
    # sil = 1 - exp(logkeep) => d_logkeep = -exp(logkeep) * d_sil
    d_lk = -jnp.exp(logkeep) * d_sil
    rects = jax.vmap(lambda a: _chunk_cell_rects(a, win, geo))(agg)
    dtab = _run_backward(
        rects, tab, _window_to_cells(d_z, win, geo, 0.0),
        _window_to_cells(d_lk, win, geo, 0.0),
        _window_to_cells(amin, win, geo, -1), win, inv_blur, geo,
        interpret)
    d_planes = dtab.transpose(0, 2, 1)[:, :shape.shape[1]]   # (B, F, 12)
    if order is not None:
        inv = jnp.argsort(order, axis=1)
        d_planes = jnp.take_along_axis(d_planes, inv[..., None], axis=1)
    return d_planes, None


raster_planes_pallas.defvjp(_raster_fwd, _raster_bwd)


def rasterize_bodies_pallas(verts, faces, cam_K, settings: RasterSettings,
                            geo: KernelGeometry = GEOMETRY):
    """Kernel counterpart of rasterizer.rasterize_bodies ("edge_lines"
    semantics). verts: (B, V, 3) -> zbuf/sil (B, win, win), origin
    (B, 2). Vertex gradients flow by autodiff through face_planes; only
    the kernels carry a custom VJP (w.r.t. the plane coefficients)."""
    uvz = project_points(verts, cam_K, return_depth=True)
    origin = jax.vmap(lambda p: window_origin(p[:, :2], p[:, 2],
                                              settings))(uvz)
    # one fused (V, 3) row gather per body
    fuvz = uvz[:, faces]                                # (B, F, 3, 3)
    fuv = fuvz[..., :2] - origin[:, None, None, :].astype(uvz.dtype)
    planes, bbox, ok_sil, ok_depth = jax.vmap(
        lambda a, z: face_planes(a, z, settings.znear))(fuv, fuvz[..., 2])
    zbuf, sil = raster_planes_pallas(
        planes, (bbox, ok_sil, ok_depth), settings.window,
        1.0 / settings.sil_blur_px2, settings.znear, settings.preordered,
        settings.interpret, geo)
    return {"zbuf": zbuf, "sil": sil, "origin": origin}
