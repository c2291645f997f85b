"""Two-stage space-time SMPL sequence optimizer — the heart.

Capability parity with the reference `SMPLDepthSequenceOptimizer`
(optimizer.py:146-770): stage init solves per-frame 3D root
translations from weighted 2D reprojection (optimizer.py:710-770);
stage 1 jointly optimizes {per-frame root translations, SMPL pose
parameters, time-shared betas, per-frame disparity de-normalization
bounds, per-person log-1.1 scales} against 2D-joint, rendered-depth,
occlusion-ordered silhouette, velocity, filtered-vertex smoothness,
reference-pose/beta, scale, scene-contact and foot-sliding losses
(optimizer.py:324-602), rebuilding a median static scene point cloud
as it converges.

Accelerator-first redesign (vs. the reference's epoch-of-batches loop with
dozens of host<->device syncs per cycle, survey §3.1 hot loop B):
  * one optimization cycle == ONE jitted program: a `lax.scan` over
    fixed-size frame chunks accumulates the per-frame losses (SMPL
    forward + crop-window rasterization per chunk, rematerialized
    under AD), temporal terms couple chunks through 1-frame halos, and
    a single full-batch optax update replaces per-batch gradient
    accumulation;
  * frames are processed in order (the reference shuffles batches,
    which only reorders the accumulation of the same epoch gradient —
    and makes its foot-sliding/silhouette 'adjacent' frames random;
    ordered chunks make those terms genuinely temporal);
  * the scene median depth, its postprocess, the point cloud, and the
    One-Euro filtered targets are computed on-device in separate
    jitted updates (the reference does all of this on the CPU every
    cycle);
  * all arrays are padded to a chunk multiple with a frame-validity
    mask, keeping shapes static for XLA; the time axis is the sharding
    axis for multi-chip execution (see parallel/).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax import lax

from ..models.smpl import SMPLModel, smpl_forward
from ..ops.cameras import project_points, softplus
from ..ops.morphology import erode
from ..ops.one_euro import one_euro_init, one_euro_step
from ..ops.rasterizer import RasterSettings, rasterize_bodies
from .scene import (ScenePointCloud, aggregate_scene_depth,
                    build_scene_pointcloud, contact_targets)


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineConfig:
    """Static configuration (hashable -> usable as a jit static arg)."""

    image_size: Tuple[int, int]          # (W, H)
    num_people: int
    num_frames: int                      # real T (before padding)
    chunk: int = 16                      # frames per scan step
    window: int = 128                    # raster crop window (shared)
    # Per-PERSON raster windows (len num_people; the Predictor derives
    # multiples of 16, whole cells of the raster kernel). None = every
    # person uses `window`. Far people project small, so sizing each
    # person's crop to their own observed bbox need cuts the
    # area-proportional work (window losses, gathers, buffers; the
    # kernel itself visits only overlapping cells). The
    # reference rasterizes the full image for everyone
    # (optimizer.py:211-232); the window crop is this engine's
    # documented deviation and the per-person sizes change nothing
    # semantically: the depth loss is a masked mean over the person's
    # own eroded mask, and the silhouette loss carries an explicit
    # outside-window term.
    windows: Optional[Tuple[int, ...]] = None
    face_chunk: int = 128
    joint_confidence_thr: float = 0.5
    eps: float = 1e-3
    znear: float = 1.0
    zfar: float = 100.0
    min_delta_z: float = 1.0             # optimizer.py:256
    batch_size_ref: int = 10             # reference batch for scale-reg
    knn: int = 32
    contact_offset: float = 0.02
    contact_thr: float = 0.20
    frame_rate: float = 25.0
    # (the reference also takes min_cutoff1/beta1 poses_T-filter args,
    # but its `poses_T_filtered` is dead code — optimizer.py:384 — so
    # those knobs are intentionally not carried here)
    min_cutoff2: float = 0.001           # verts filter
    beta2: float = 0.5
    update_filters_every: int = 25
    warmup_cycles: int = 30              # scene/filters start cycle
    scene_update_every: int = 1
    cam_dist_coef: Optional[Tuple[float, ...]] = None
    # Per-joint weights of the 2D losses (reference pose17j_weights,
    # optimizer.py:108-130,259: normalized len*w/sum(w), applied inside
    # the squared error of both the init solve :755 and stage-1 :419).
    # None = the reference's all-ones default. Stored RAW; the use
    # sites normalize (normalize_joint_weights).
    pose17j_weights: Optional[Tuple[float, ...]] = None
    # The caller has permuted model.faces with
    # rasterizer.spatial_face_order (Predictor does); the Pallas
    # kernel then skips its per-call face argsort+gather.
    preordered_faces: bool = False
    # Rematerialize chunk forwards in the backward pass. None = auto:
    # only when the sequence is long enough that storing per-body
    # residuals (face tables ~1.7 MB + window buffers) would exceed
    # residual_budget_bytes() of device memory.
    # When remat engages, the save_only_these_names middle tier (see
    # remat_policy) still keeps the Pallas kernel outputs, so only the
    # cheap chunk prep is re-executed in the backward pass.
    remat_chunks: Optional[bool] = None
    # Pad the sequence length to a multiple of this bucket so different
    # sequences (MuPoTs TS1..20 range 201..2300 frames) share compiled
    # programs; padding costs masked-out frames.
    frame_bucket: int = 64
    # Opt-in (parity-off) gap-aware temporal losses for detection
    # dropout. The reference anchors unobserved spans to a STALE 2D
    # copy (datautils.py:326-333) and its velocity/filtered-verts
    # regularizers (optimizer.py:560-573) smear the distortion into
    # the OBSERVED frames flanking the gap — which no post-fit pass
    # may touch (round-4 decomposition, docs/PARITY.md). When on:
    # temporal PAIR terms (velocity, filtered-verts smoothness, foot
    # sliding) are masked on pairs with a stale endpoint, and an
    # acceleration penalty (coefs['reg_gap_accel']) over triples
    # touching a stale frame makes the unobserved trajectory
    # INTERPOLATE during the fit instead of freezing at the anchor or
    # collapsing to zero motion. Clean sequences (no stale frames)
    # are unchanged. Requires SeqData.stale_tn; chunk halos widen to
    # 2 frames (the acceleration stencil).
    gap_aware_temporal: bool = False

    @property
    def halo(self) -> int:
        """Left-halo frames per chunk: 1 for the pair terms, 2 when
        the gap acceleration stencil is active."""
        return 2 if self.gap_aware_temporal else 1

    @property
    def use_remat(self) -> bool:
        if self.remat_chunks is not None:
            return self.remat_chunks
        # full-residual estimate per body: face tables (full SMPL) +
        # four window-sized buffers; remat when past the device budget
        bodies = self.padded_frames * self.num_people
        mean_win2 = float(np.mean([w * w for w in self.person_windows]))
        per_body = 1.7e6 + 16.0 * mean_win2
        return bodies * per_body > residual_budget_bytes()

    @property
    def padded_frames(self) -> int:
        # bucket rounded up to a chunk multiple so both constraints hold
        b = -(-max(self.chunk, self.frame_bucket) // self.chunk)
        b = b * self.chunk
        return ((self.num_frames + b - 1) // b) * b

    @property
    def num_chunks(self) -> int:
        return self.padded_frames // self.chunk

    @property
    def person_windows(self) -> Tuple[int, ...]:
        if self.windows is None:
            return (self.window,) * self.num_people
        assert len(self.windows) == self.num_people
        return self.windows

    @property
    def window_groups(self) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """Person indices grouped by window size, descending size:
        ((win, (n0, n1, ...)), ...). People sharing a window batch
        into ONE raster call (static at trace time)."""
        pw = self.person_windows
        sizes = sorted(set(pw), reverse=True)
        return tuple(
            (w, tuple(n for n in range(self.num_people) if pw[n] == w))
            for w in sizes)

    @property
    def raster_settings(self) -> RasterSettings:
        return self.raster_settings_for_window(self.window)

    def raster_settings_for_window(self, window: int) -> RasterSettings:
        return RasterSettings(
            image_size=self.image_size, window=window,
            face_chunk=self.face_chunk, znear=self.znear,
            zfar=self.zfar, preordered=self.preordered_faces)


# Share of the device's memory that stored chunk residuals may take;
# the rest holds the sequence data, the optimizer state and XLA's
# temporaries.
RESIDUAL_MEMORY_SHARE = 0.375
# Backends that report no memory limit (the CPU) are planned as a
# 16 GB device.
FALLBACK_DEVICE_BYTES = 16e9


def residual_budget_bytes(device=None) -> float:
    """Bytes of chunk residuals above which `use_remat` engages:
    RESIDUAL_MEMORY_SHARE of `memory_stats()["bytes_limit"]` of the
    default device (what this JAX process may allocate there)."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit") or FALLBACK_DEVICE_BYTES
    return RESIDUAL_MEMORY_SHARE * float(limit)


class StageParams(NamedTuple):
    """Optimized variables (optimizer.py:262-321). Tp = padded T."""

    poses_T: jax.Array      # (Tp, N, 1, 3)
    poses_smpl: jax.Array   # (Tp, N, 72)
    betas: jax.Array        # (1, N, 10) shared over time
    zmin_lin: jax.Array     # (Tp, 1, 1) pre-softplus scene near bound
    zmax_lin: jax.Array     # (Tp, 1, 1) pre-softplus scene range
    xscale: jax.Array       # (1, N, 1, 1) log_1.1 per-person scale


class SeqData(NamedTuple):
    """Per-sequence device data (padded to Tp frames)."""

    depths: jax.Array       # (Tp, H, W) f32 normalized disparity
    seg_mask: jax.Array     # (Tp, N, H, W) bool
    seg_eroded: jax.Array   # (Tp, N, H, W) bool — k3 x2 erosion of
    #                         seg_mask, precomputed (static data; the
    #                         reference erodes per batch per epoch,
    #                         optimizer.py:434-436)
    backmask: jax.Array     # (Tp, H, W) bool
    pose2d: jax.Array       # (Tp, N, 17, 3)
    poses_smpl_ref: jax.Array  # (Tp, N, 72)
    valid_smpl: jax.Array   # (Tp, N, 1) thresholded > 0.7
    frame_valid: jax.Array  # (Tp,)
    cam_K: jax.Array        # (3, 3)
    stale_tn: jax.Array     # (Tp, N) f32 1 = no current-frame 2D
    #                         evidence (SequenceArrays.lagged_tn);
    #                         consumed by cfg.gap_aware_temporal


class StageAux(NamedTuple):
    """Non-optimized cycle state."""

    betas_ref: jax.Array            # (1, N, 10)
    scene: ScenePointCloud
    have_scene: jax.Array           # () 0/1
    verts_filt_diff: jax.Array      # (Tp, N, V, 3) bf16 targets
    have_filters: jax.Array         # () 0/1


def normalize_joint_weights(w) -> np.ndarray:
    """Reference joint-weight normalization: len(w) * w / sum(w)
    (optimizer.py:104-105 and :128-129)."""
    w = np.asarray(w, np.float32)
    return w * (len(w) / np.sum(w))


def _j17_weights(cfg: "EngineConfig") -> Optional[jax.Array]:
    if cfg.pose17j_weights is None:
        return None
    return jnp.asarray(normalize_joint_weights(cfg.pose17j_weights))


def default_coefs() -> Dict[str, float]:
    """Loss coefficients as in configs/predict_mupots.yml:17-25."""
    return {
        "proj2d": 1.0, "depth": 0.05, "silhouette": 0.1,
        "reg_poses": 0.002, "reg_scales": 1e-4, "reg_velocity": 0.05,
        "reg_verts_filter": 0.002, "reg_contact": 0.001,
        "reg_foot_sliding": 0.01,
        # gap acceleration penalty (cfg.gap_aware_temporal only; no
        # reference analog) — defaults to the velocity coefficient
        "reg_gap_accel": 0.05,
    }


# ---------------------------------------------------------------------------
# Data preparation
# ---------------------------------------------------------------------------

def _pad_t(x: np.ndarray, tp: int) -> np.ndarray:
    pad = tp - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], 0)


def prepare_seq_data(seq, cfg: EngineConfig) -> SeqData:
    """SequenceArrays (host) -> SeqData (device, padded)."""
    tp = cfg.padded_frames
    frame_valid = np.zeros((tp,), np.float32)
    frame_valid[:cfg.num_frames] = 1.0
    seg_bool = _pad_t(seq.seg_mask > 0.5, tp)
    # erode in chunk-sized frame blocks: eroding the whole (Tp, N, H,
    # W) stack at once materializes f32 casts + conv intermediates
    # ~10x the bool footprint, which can OOM prep for sequences whose
    # optimization itself fits
    seg_er = jax.jit(lambda s: lax.map(
        lambda blk: erode(blk.astype(jnp.float32), kernel_size=3,
                          iterations=2) > 0.5,
        s.reshape((cfg.num_chunks, cfg.chunk) + s.shape[1:]),
    ).reshape(s.shape))(jnp.asarray(seg_bool))
    return SeqData(
        depths=jnp.asarray(_pad_t(seq.depths.astype(np.float32), tp)),
        seg_mask=jnp.asarray(seg_bool),
        seg_eroded=seg_er,
        backmask=jnp.asarray(_pad_t(seq.backmasks > 0.5, tp)),
        pose2d=jnp.asarray(_pad_t(seq.pose2d.astype(np.float32), tp)),
        poses_smpl_ref=jnp.asarray(
            _pad_t(seq.poses_smpl.astype(np.float32), tp)),
        valid_smpl=jnp.asarray(
            _pad_t((seq.valid_smpl > 0.7).astype(np.float32), tp)),
        frame_valid=jnp.asarray(frame_valid),
        cam_K=jnp.asarray(seq.cam["K"].astype(np.float32)),
        stale_tn=jnp.asarray(_pad_t(
            np.zeros((cfg.num_frames, cfg.num_people), np.float32)
            if getattr(seq, "lagged_tn", None) is None
            else np.asarray(seq.lagged_tn, np.float32), tp)),
    )


def empty_scene(cfg: EngineConfig) -> ScenePointCloud:
    W, H = cfg.image_size
    return ScenePointCloud(
        points=jnp.zeros((H * W, 3), jnp.float32),
        valid=jnp.zeros((H * W,), bool),
        depth=jnp.zeros((H, W), jnp.float32),
        depth_valid=jnp.zeros((H, W), bool))


def init_aux(cfg: EngineConfig, num_vertices: int,
             betas_ref: jax.Array) -> StageAux:
    tp, n = cfg.padded_frames, cfg.num_people
    return StageAux(
        betas_ref=betas_ref,
        scene=empty_scene(cfg),
        have_scene=jnp.zeros(()),
        verts_filt_diff=jnp.zeros((tp, n, num_vertices, 3),
                                  jnp.bfloat16),
        have_filters=jnp.zeros(()))


# ---------------------------------------------------------------------------
# Stage init: per-frame global translation solve (optimizer.py:710-770)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("num_iter", "joints_thr"))
def init_global_poses(
    model: SMPLModel,
    pose2d: jax.Array,          # (T, N, 17, 3) with confidence
    poses_smpl: jax.Array,      # (T, N, 72)
    betas_smpl: jax.Array,      # (T, N, 10)
    cam_K: jax.Array,           # (3, 3)
    xscale: jax.Array,          # (1, N, 1, 1)
    dist_coef: Optional[jax.Array] = None,
    proj2d_coef: float = 1.0,
    reg_velocity_coef: float = 0.05,
    num_iter: int = 100,
    joints_thr: float = 0.15,
    pose_weights: Optional[jax.Array] = None,   # (17,) normalized
):
    """Solve per-frame 3D root translations by minimizing weighted 2D
    reprojection with Adam(0.5, betas=(0.5, 0.5)) + exp(0.95) decay.
    `dist_coef` applies the camera's radial/tangential distortion to
    the projections (the reference passes Kd here, optimizer.py:752).
    `pose_weights` multiplies each joint's error inside the square
    (reference pose_weights at optimizer.py:755-756).

    The SMPL joints do not depend on poses_T, so (unlike the reference,
    which re-runs SMPL every iteration) the forward pass is hoisted out
    of the loop — the iteration is a pure projection solve.
    Returns (poses_T (T, N, 1, 3), loss_2d history (num_iter,)).
    """
    T, N = pose2d.shape[:2]
    out = smpl_forward(model, betas_smpl.reshape(T * N, -1),
                       poses_smpl.reshape(T * N, -1))
    joints = out["joints_alphapose"].reshape(T, N, -1, 3)
    scale = jnp.power(1.1, xscale)
    joints = scale * joints                       # (T, N, 17, 3)

    vis = (pose2d[..., 2:] > joints_thr).astype(jnp.float32)
    if pose_weights is not None:
        vis = vis * pose_weights[None, None, :, None]
    gt2d = pose2d[..., 0:2]

    sched = optax.exponential_decay(0.5, 1, 0.95)
    opt = optax.adam(sched, b1=0.5, b2=0.5, eps=1e-6)

    def loss_fn(poses_T):
        p3d = joints + poses_T
        proj = project_points(p3d, cam_K, dist_coef=dist_coef)
        loss_2d = jnp.mean(jnp.square(vis * proj - vis * gt2d))
        speed = jnp.sum(jnp.square(poses_T[1:] - poses_T[:-1]))
        return proj2d_coef * loss_2d + reg_velocity_coef * speed, loss_2d

    poses_T0 = jnp.tile(jnp.asarray([[[[0.0, 0.0, 1.0]]]]), (T, N, 1, 1))

    def step(carry, _):
        poses_T, opt_state = carry
        (_, l2d), g = jax.value_and_grad(loss_fn, has_aux=True)(poses_T)
        updates, opt_state = opt.update(g, opt_state, poses_T)
        poses_T = optax.apply_updates(poses_T, updates)
        return (poses_T, opt_state), l2d

    (poses_T, _), hist = lax.scan(
        step, (poses_T0, opt.init(poses_T0)), None, length=num_iter)
    return poses_T, hist


def init_params(
    model: SMPLModel,
    data_pose2d: np.ndarray,      # (T, N, 17, 3) unpadded
    data_poses_smpl: np.ndarray,  # (T, N, 72)
    data_betas_smpl: np.ndarray,  # (T, N, 10)
    cam_K: np.ndarray,
    cfg: EngineConfig,
    scale_factor: Optional[np.ndarray] = None,
    num_iter: int = 100,
):
    """Build initial StageParams (optimizer.py:262-321). Returns
    (params, init_log, optimize_scale: bool)."""
    T, N = data_pose2d.shape[:2]
    if scale_factor is not None:
        xscale = (np.log(scale_factor) / np.log(1.1)).astype(np.float32)
        xscale = jnp.asarray(xscale[None, :, None, None])
        optimize_scale = False
    else:
        xscale = jnp.zeros((1, N, 1, 1))
        optimize_scale = True

    kd = (None if cfg.cam_dist_coef is None
          else jnp.asarray(cfg.cam_dist_coef))
    poses_T, hist = init_global_poses(
        model, jnp.asarray(data_pose2d), jnp.asarray(data_poses_smpl),
        jnp.asarray(data_betas_smpl), jnp.asarray(cam_K),
        xscale, dist_coef=kd, num_iter=num_iter,
        pose_weights=_j17_weights(cfg))
    poses_T = np.asarray(poses_T)

    max_z = np.clip(np.max(poses_T[..., 2:], axis=1), 2, None)  # (T,1,1)
    avg_betas = np.mean(data_betas_smpl, axis=0, keepdims=True)

    tp = cfg.padded_frames
    params = StageParams(
        poses_T=jnp.asarray(_pad_t(poses_T.astype(np.float32), tp)),
        poses_smpl=jnp.asarray(
            _pad_t(data_poses_smpl.astype(np.float32), tp)),
        betas=jnp.asarray(avg_betas.astype(np.float32)),
        zmin_lin=jnp.asarray(_pad_t(np.ones_like(max_z, np.float32), tp)),
        zmax_lin=jnp.asarray(_pad_t((2.0 * max_z).astype(np.float32), tp)),
        xscale=xscale,
    )
    return params, np.asarray(hist), optimize_scale


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def scale_factor_of(params: StageParams) -> jax.Array:
    return jnp.power(1.1, params.xscale)


def z_bounds_of(params: StageParams, cfg: EngineConfig):
    """(min_z, max_z) (Tp, 1, 1); max_z = sg(min_z) + dz + sp(zmax_lin)
    (optimizer.py:683-688)."""
    min_z = softplus(params.zmin_lin)
    max_z = (lax.stop_gradient(min_z) + cfg.min_delta_z
             + softplus(params.zmax_lin))
    return min_z, max_z


def _smpl_bodies(model, params_chunk_poses, betas, scale, poses_T):
    """SMPL forward for a (F, N) block; returns absolute verts/joints.

    params_chunk_poses: (F, N, 72); betas (1, N, 10); poses_T (F,N,1,3).
    """
    F, N = params_chunk_poses.shape[:2]
    out = smpl_forward(
        model,
        jnp.broadcast_to(betas, (F, N, 10)).reshape(F * N, 10),
        params_chunk_poses.reshape(F * N, 72))
    verts = out["verts"].reshape(F, N, -1, 3)
    joints = out["joints_alphapose"].reshape(F, N, -1, 3)
    verts_abs = scale * verts + poses_T
    joints_abs = scale * joints + poses_T
    return verts_abs, joints_abs


def _gather_windows(imgs, origins, win):
    """imgs: (C, N, H, W), origins: (C, N, 2) ->
    (C, N, win, win) crops."""
    def one(img, o):
        return lax.dynamic_slice(img, (o[1], o[0]), (win, win))
    return jax.vmap(jax.vmap(one))(imgs, origins)


def _gather_windows_shared(img_c, origins, win):
    """Per-frame image shared by all people: img_c (C, H, W),
    origins (C, N, 2) -> (C, N, win, win) crops, WITHOUT materializing
    the (C, N, H, W) broadcast first."""
    def one(img, o):
        return lax.dynamic_slice(img, (o[1], o[0]), (win, win))
    return jax.vmap(lambda img, os: jax.vmap(
        lambda o: one(img, o))(os))(img_c, origins)


# ---------------------------------------------------------------------------
# The per-chunk loss (scanned; rematerialized under AD)
# ---------------------------------------------------------------------------

LOG_KEYS = ("loss_pose24j", "loss_depth", "loss_silhouette",
            "reg_ref_poses", "reg_scale", "reg_contact",
            "reg_foot_sliding", "reg_vel", "reg_filter_verts",
            "reg_gap_accel")


def remat_policy():
    """Middle remat tier for long sequences: keep only the Pallas
    rasterizer's small backward residuals (named in
    ops/raster_pallas._raster_fwd) and recompute everything else —
    the backward re-runs the cheap chunk prep (SMPL forward, face
    planes, table pack) but never the forward pixel-streaming kernel.
    ~130 KB/body saved instead of ~2 MB, at a fraction of full
    rematerialization's recompute cost."""
    return jax.checkpoint_policies.save_only_these_names(
        "raster_residuals")


class ChunkInputs(NamedTuple):
    """All tensors of one frame chunk [t0, t0+C) with a left halo of
    `cfg.halo` frames (leading elements of *_h arrays are frames
    t0-halo .. t0-1; halo is 1, or 2 when cfg.gap_aware_temporal
    widens the stencil). Built either by `_slice_chunk` (single
    device) or from local shards + ppermute halo exchange
    (parallel/spmd.py)."""

    poses_T_h: jax.Array       # (C+halo, N, 1, 3)
    poses_smpl_h: jax.Array    # (C+halo, N, 72)
    min_z_c: jax.Array         # (C, 1, 1)
    max_z_c: jax.Array         # (C, 1, 1)
    depths_c: jax.Array        # (C, H, W)
    seg_c: jax.Array           # (C, N, H, W) f32
    seg_er_c: jax.Array        # (C, N, H, W) f32 precomputed erosion
    pose2d_c: jax.Array        # (C, N, 17, 3)
    ref_poses_c: jax.Array     # (C, N, 72)
    valid_smpl_c: jax.Array    # (C, N, 1)
    frame_valid_h: jax.Array   # (C+halo,)
    global_t: jax.Array        # (C,) int
    dvf_c: jax.Array           # (C, N, V, 3) bf16 filtered-diff targets
    # (C+2, N) stale-frame mask, only when cfg.gap_aware_temporal
    # (None otherwise — the parity path never touches it)
    stale_h: Optional[jax.Array] = None


def _slice_chunk(params: StageParams, data: SeqData, aux: StageAux,
                 cfg: EngineConfig, chunk_idx) -> ChunkInputs:
    """Gather one chunk's tensors from the full-sequence arrays."""
    C, hl = cfg.chunk, cfg.halo
    t0 = chunk_idx * C
    halo_idx = jnp.clip(t0 - hl + jnp.arange(C + hl), 0, None)
    take = lambda arr: jnp.take(arr, halo_idx, axis=0)
    takec = lambda arr: lax.dynamic_slice_in_dim(arr, t0, C, axis=0)
    min_z, max_z = z_bounds_of(params, cfg)
    return ChunkInputs(
        stale_h=(take(data.stale_tn) if cfg.gap_aware_temporal
                 else None),
        poses_T_h=take(params.poses_T),
        poses_smpl_h=take(params.poses_smpl),
        min_z_c=takec(min_z),
        max_z_c=takec(max_z),
        depths_c=takec(data.depths),
        seg_c=takec(data.seg_mask).astype(jnp.float32),
        seg_er_c=takec(data.seg_eroded).astype(jnp.float32),
        pose2d_c=takec(data.pose2d),
        ref_poses_c=takec(data.poses_smpl_ref),
        valid_smpl_c=takec(data.valid_smpl),
        frame_valid_h=take(data.frame_valid),
        global_t=t0 + jnp.arange(C),
        dvf_c=takec(aux.verts_filt_diff),
    )


def _chunk_loss_core(chunk: ChunkInputs, model: SMPLModel,
                     betas: jax.Array, scale: jax.Array,
                     cam_K: jax.Array, aux: StageAux,
                     coefs: Dict[str, jax.Array], cfg: EngineConfig):
    """Loss of one frame chunk. Returns (scalar loss, parts vector).

    Includes all per-frame terms plus the temporal pairs (velocity,
    filtered-verts smoothness, foot sliding) of this chunk's frames
    against their predecessors, so the total over chunks covers every
    consecutive-frame pair exactly once. With cfg.gap_aware_temporal
    the halo is 2 frames and the acceleration triples centered at
    frames [t0-1, t0+C-2] likewise tile the sequence exactly once.
    """
    C = cfg.chunk
    N = cfg.num_people
    W, H = cfg.image_size

    # *_h arrays carry cfg.halo leading halo frames; everything
    # outside the gap-acceleration stencil uses the 1-frame-halo view
    # (identical slicing when halo == 1, so the parity path is
    # untouched)
    hoff = cfg.halo - 1
    poses_T_h = chunk.poses_T_h[hoff:]
    poses_smpl_h = chunk.poses_smpl_h[hoff:]
    min_z_c, max_z_c = chunk.min_z_c, chunk.max_z_c
    depths_c, seg_c = chunk.depths_c, chunk.seg_c
    pose2d_c, ref_poses_c = chunk.pose2d_c, chunk.ref_poses_c
    valid_smpl_c = chunk.valid_smpl_c
    frame_valid_h = chunk.frame_valid_h[hoff:]
    frame_valid_c = frame_valid_h[1:]
    # pair (t-1, t) valid: both frames real and t > 0 globally
    pair_valid = (frame_valid_h[:-1] * frame_valid_c
                  * (chunk.global_t > 0))         # (C,)
    # gap-aware gating (cfg docstring): pair weight drops pairs with a
    # stale endpoint so the stale anchor cannot smear the flanking
    # OBSERVED frames through the pair terms (reference
    # optimizer.py:560-573 has no such gate — its gaps freeze or drag)
    if cfg.gap_aware_temporal:
        stale_h2 = chunk.stale_h                  # (C+2, N)
        pair_obs = 1.0 - jnp.maximum(stale_h2[1:-1], stale_h2[2:])
        pair_w = pair_obs[:, :, None, None]       # (C, N, 1, 1)
        # release the FABRICATED 2D evidence on stale frames:
        # ingestion repeats the last detection above the loss
        # threshold (reference datautils.py:326-333), which pins gap
        # frames at the frozen anchor — with the pin in place the
        # acceleration penalty below can only smear it into the
        # flanking OBSERVED frames (measured: degraded jitter 44.2 →
        # 49.1 mm before this release). Real evidence stays on: the
        # depth/silhouette terms read the rendered masks (a person the
        # detector merely missed is still segmented; a truly absent
        # person self-gates through seg coverage) and the ROMP SMPL
        # prior has its own valid_smpl flag.
        obs_w = (1.0 - stale_h2[2:])[:, :, None, None]   # (C, N, 1, 1)
    else:
        pair_w = jnp.ones((), jnp.float32)
        obs_w = jnp.ones((), jnp.float32)

    verts_abs_h, joints_abs_h = _smpl_bodies(
        model, poses_smpl_h, betas, scale, poses_T_h)
    verts_abs = verts_abs_h[1:]                   # (C, N, V, 3)
    joints_abs = joints_abs_h[1:]

    # --- validity gates (optimizer.py:404-409) ---
    conf_ok = (pose2d_c[..., 2:] >= cfg.joint_confidence_thr
               ).astype(jnp.float32)              # (C, N, 17, 1)
    pose2d_valid = (jnp.sum(conf_ok, axis=(2, 3)) >= 2).astype(
        jnp.float32)                              # (C, N)
    mask_valid = (jnp.sum(seg_c, axis=(2, 3))
                  >= 0.005 * H * W).astype(jnp.float32)

    fv = frame_valid_c[:, None]                   # (C, 1)

    # --- 2D keypoint loss (optimizer.py:414-420) ---
    kd = (None if cfg.cam_dist_coef is None
          else jnp.asarray(cfg.cam_dist_coef))
    proj = project_points(joints_abs, cam_K, dist_coef=kd)
    norm = jnp.asarray([W, H], jnp.float32)
    w2d = conf_ok * fv[..., None, None] * obs_w
    jw = _j17_weights(cfg)
    if jw is not None:
        # reference: mask = pose_weights * pose2d_thr_scores applied
        # inside the squared error (optimizer.py:419-420 via :367-368)
        w2d = w2d * jw[None, None, :, None]
    loss_pose = jnp.sum(jnp.square(w2d * (proj - pose2d_c[..., :2])
                                   / norm))

    # --- depth-loss target (shared by all people) ------------------
    target_disp = (depths_c * (1.0 / min_z_c - 1.0 / max_z_c)
                   + 1.0 / max_z_c)               # (C, H, W)

    # --- occlusion keep masks (full-frame, window-independent) -----
    # acc_mask for person p = union of seg masks of people closer than
    # p in this frame (z order of poses_T). Data-only (no gradient).
    # Computed PAIRWISE: closer[c, p, q] = person q in front of person
    # p (z tiebreak by index, matching a stable sort) — at N <= ~10
    # one (C, N, N) @ (C, N, HW) einsum replaces the reference-shaped
    # sort + cumulative-OR + unsort, which moves the (C, N, H, W)
    # stack through two take_along_axis gathers. Its operands are 0/1,
    # so TF32 is exact here.
    z = poses_T_h[1:, :, 0, 2]                    # (C, N)
    idx = jnp.arange(N)
    in_front = ((z[:, None, :] < z[:, :, None])
                | ((z[:, None, :] == z[:, :, None])
                   & (idx[None, None, :] < idx[None, :, None])))
    closer = jnp.einsum(
        "cpq,cqx->cpx", in_front.astype(jnp.float32),
        seg_c.reshape(C, N, -1)).reshape(C, N, H, W)
    keep = 1.0 - (closer > 0).astype(jnp.float32)
    n_keep = jnp.sum(keep, axis=(2, 3)) + 1.0     # (C, N)
    seg_keep_total = jnp.sum(keep * seg_c, axis=(2, 3))
    dw = pose2d_valid * fv                        # (C, N)
    sil_gate = mask_valid * pose2d_valid * fv

    # --- rasterize + window losses, per window-size group ----------
    # People are rastered at their OWN crop window (cfg.windows);
    # same-size people batch into one call, so the default shared
    # window stays exactly one raster call per chunk. The depth loss
    # is a masked mean over the person's own eroded seg mask and the
    # silhouette loss carries an explicit outside-window term, so the
    # per-person sizes only drop pixels that contribute (0-0)^2 —
    # semantics match the shared-window path wherever the window
    # covers the person (guarded by Predictor._sized_window).
    loss_depth = jnp.zeros(())
    loss_sil = jnp.zeros(())
    for win, group in cfg.window_groups:
        g = np.asarray(group)
        ng = len(group)
        raster = rasterize_bodies(
            verts_abs[:, g].reshape(C * ng, -1, 3), model.faces,
            cam_K, cfg.raster_settings_for_window(win))
        zbuf = raster["zbuf"].reshape(C, ng, win, win)
        sil = raster["sil"].reshape(C, ng, win, win)
        origins = raster["origin"].reshape(C, ng, 2)

        # depth loss (optimizer.py:425-442)
        target_win = _gather_windows_shared(target_disp, origins, win)
        seg_er_win = _gather_windows(chunk.seg_er_c[:, g], origins,
                                     win)
        zbuf_valid = jnp.isfinite(zbuf)
        zbuf_safe = jnp.where(zbuf_valid, zbuf, 1.0)
        zbuf_disp = 1.0 / jnp.clip(zbuf_safe + 0.2, cfg.eps)
        dmask = (zbuf_valid.astype(jnp.float32) * seg_er_win
                 * dw[:, g][..., None, None])
        n_pix = jnp.sum(dmask, axis=(2, 3)) + 1.0
        mean_pred = jnp.sum(
            dmask * jnp.log(jnp.clip(zbuf_disp, cfg.eps)),
            axis=(2, 3)) / n_pix
        mean_true = jnp.sum(
            dmask * jnp.log(jnp.clip(target_win, cfg.eps)),
            axis=(2, 3)) / n_pix
        loss_depth = loss_depth + jnp.sum(
            jnp.square(mean_pred - mean_true))

        # occlusion-ordered silhouette loss (optimizer.py:447-477)
        keep_win = _gather_windows(keep[:, g], origins, win)
        seg_win = _gather_windows(seg_c[:, g], origins, win)
        in_win = jnp.sum(jnp.square(keep_win * (sil - seg_win)),
                         axis=(2, 3))
        seg_keep_win = jnp.sum(keep_win * seg_win, axis=(2, 3))
        outside = seg_keep_total[:, g] - seg_keep_win
        loss_sil = loss_sil + jnp.sum(
            sil_gate[:, g] * (in_win + outside) / n_keep[:, g])

    # --- contact + foot sliding (optimizer.py:485-518) ---
    # The 32-NN query against the 65k-point scene cloud is the
    # expensive part; lax.cond skips it entirely until the scene
    # exists (warmup cycles < 30 never pay for it).
    poses_T_c = poses_T_h[1:]
    pv = pair_valid[:, None, None, None]

    def _contact_terms(operands):
        verts_abs, verts_abs_h, poses_T_c = operands
        low, cdist, target_T = contact_targets(
            verts_abs, poses_T_c, aux.scene, k=cfg.knn,
            offset=cfg.contact_offset)
        reg_c = jnp.sum(fv[..., None, None]
                        * jnp.abs(poses_T_c - target_T))
        in_contact = (cdist > -cfg.contact_thr).astype(jnp.float32)
        # previous-frame verts at the CURRENT frame's lowest-vertex idx
        idx_low = jnp.argmax(verts_abs_h[..., 1],
                             axis=-1)[..., None, None]
        low_tm1 = jnp.take_along_axis(
            verts_abs_h[:-1], idx_low[1:].repeat(3, -1), axis=-2)
        fs_gate = pv * pair_w * in_contact
        fs_num = jnp.sum(jnp.abs(fs_gate * (low - low_tm1)))
        fs_den = jnp.clip(jnp.sum(fs_gate), 1.0)
        return reg_c, fs_num / fs_den

    reg_contact, reg_foot_sliding = lax.cond(
        aux.have_scene > 0, _contact_terms,
        lambda _: (jnp.zeros(()), jnp.zeros(())),
        (verts_abs, verts_abs_h, poses_T_c))

    # --- SMPL parameter regularization (optimizer.py:523-526) ---
    w_ref = valid_smpl_c * fv[..., None]          # (C, N, 1)
    reg_ref = jnp.sum(jnp.abs(
        w_ref * (ref_poses_c - poses_smpl_h[1:])))
    reg_ref = reg_ref + jnp.sum(frame_valid_c) * jnp.sum(
        jnp.abs(betas - aux.betas_ref))

    # --- filtered-verts smoothness (optimizer.py:563-574), computed
    # in-chunk against the precomputed filtered-diff targets ---
    dvf = chunk.dvf_c.astype(jnp.float32)
    gv_diff = verts_abs - verts_abs_h[:-1]
    reg_filter_verts = aux.have_filters * jnp.sum(
        jnp.square(pv * pair_w * (gv_diff - dvf)))

    # --- velocity regularizer on this chunk's pairs (optimizer.py:560)
    reg_vel = jnp.sum(jnp.square(
        pv * pair_w * (poses_T_h[1:] - poses_T_h[:-1])))

    # --- gap acceleration penalty (cfg.gap_aware_temporal only; no
    # reference analog): over triples (t-1, t, t+1) touching a stale
    # frame, penalize second differences of the root translation and
    # the SMPL pose angles so the unobserved span INTERPOLATES between
    # its observed endpoints (an accel-free trajectory through fixed
    # endpoints is the linear one) instead of freezing at the stale
    # anchor (velocity term) or collapsing to zero motion
    # (lagged_conf_decay alone). Triples tile the sequence exactly
    # once across chunks: centers [t0-1, t0+C-2].
    reg_gap_accel = jnp.zeros(())
    if cfg.gap_aware_temporal:
        pT2, pS2 = chunk.poses_T_h, chunk.poses_smpl_h   # (C+2, ...)
        fv2 = chunk.frame_valid_h                        # (C+2,)
        tri_stale = jnp.maximum(jnp.maximum(stale_h2[:-2],
                                            stale_h2[1:-1]),
                                stale_h2[2:])            # (C, N)
        center_t = chunk.global_t - 1
        tri_valid = (fv2[:-2] * fv2[1:-1] * fv2[2:]
                     * (center_t >= 1))                  # (C,)
        w_tri = tri_valid[:, None] * tri_stale           # (C, N)
        accel_T = pT2[2:] - 2.0 * pT2[1:-1] + pT2[:-2]
        accel_P = pS2[2:] - 2.0 * pS2[1:-1] + pS2[:-2]
        reg_gap_accel = (
            jnp.sum(jnp.square(w_tri[:, :, None, None] * accel_T))
            + jnp.sum(jnp.square(w_tri[:, :, None] * accel_P)))

    loss = (coefs["proj2d"] * loss_pose
            + coefs["depth"] * loss_depth
            + coefs["silhouette"] * loss_sil
            + coefs["reg_poses"] * reg_ref
            + coefs["reg_contact"] * reg_contact
            + coefs["reg_foot_sliding"] * reg_foot_sliding
            + coefs["reg_verts_filter"] * reg_filter_verts
            + coefs["reg_velocity"] * reg_vel)
    if cfg.gap_aware_temporal:
        loss = loss + coefs["reg_gap_accel"] * reg_gap_accel
    parts = jnp.stack([loss_pose, loss_depth, loss_sil, reg_ref,
                       jnp.zeros(()), reg_contact, reg_foot_sliding,
                       reg_vel, reg_filter_verts, reg_gap_accel])
    return loss, parts


def _scale_reg(params: StageParams, coefs, cfg: EngineConfig):
    """Scale regularization, once per epoch scaled to the reference's
    per-batch accounting (optimizer.py:531-539 runs per batch of
    `batch_size_ref` frames)."""
    scale = scale_factor_of(params)
    # the reference adds this term once per DataLoader batch, i.e.
    # ceil(T / batch_size) times per epoch (optimizer.py:531-539)
    n_batches = -(-cfg.num_frames // cfg.batch_size_ref)
    reg_scale_avg = jnp.square(jnp.sum(scale - 1.0))
    reg_scale_person = jnp.mean(jnp.square(scale - 1.0))
    loss = n_batches * (coefs["reg_scales"] * reg_scale_person
                        + (coefs["reg_scales"] > 0) * reg_scale_avg)
    logged = n_batches * (reg_scale_avg + reg_scale_person)
    return loss, logged


def _cycle_loss(params: StageParams, model: SMPLModel, data: SeqData,
                aux: StageAux, coefs, cfg: EngineConfig):
    """Full-sequence loss: scanned chunks + global scale term."""
    scale = scale_factor_of(params)

    def chunk_fn(p, i):
        chunk = _slice_chunk(p, data, aux, cfg, i)
        return _chunk_loss_core(chunk, model, p.betas, scale,
                                data.cam_K, aux, coefs, cfg)

    if cfg.use_remat:
        chunk_fn = jax.checkpoint(chunk_fn, policy=remat_policy())

    def body(carry, i):
        acc_loss, acc_parts = carry
        l, parts = chunk_fn(params, i)
        return (acc_loss + l, acc_parts + parts), None

    (loss, parts), _ = lax.scan(
        body, (jnp.zeros(()), jnp.zeros((len(LOG_KEYS),))),
        jnp.arange(cfg.num_chunks))

    reg_scale, logged = _scale_reg(params, coefs, cfg)
    loss = loss + reg_scale
    parts = parts.at[4].set(logged)
    return loss, parts


# ---------------------------------------------------------------------------
# Cycle step + auxiliary updates
# ---------------------------------------------------------------------------

def make_stage1_optimizer(lr: float = 0.01, alpha: float = 0.5,
                          momentum: float = 0.9, gamma: float = 0.99):
    """RMSprop(0.01, alpha=0.5, momentum=0.9) + ExponentialLR(0.99)
    (optimizer.py:355-356)."""
    sched = optax.exponential_decay(lr, 1, gamma)
    return optax.rmsprop(sched, decay=alpha, momentum=momentum,
                         eps=1e-8)


def grad_step(loss_fn, params: StageParams, opt_state,
              optimize_scale: bool):
    """value_and_grad + RMSprop update shared by every cycle variant
    (single-device, fused, and the sharded counterparts in
    parallel/spmd.py)."""
    opt = make_stage1_optimizer()
    (loss, parts), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    if not optimize_scale:
        grads = grads._replace(xscale=jnp.zeros_like(grads.xscale))
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss, parts


@functools.partial(jax.jit, static_argnames=("cfg", "optimize_scale"),
                   donate_argnums=(0, 1))
def stage1_cycle(params: StageParams, opt_state, model: SMPLModel,
                 data: SeqData, aux: StageAux, coefs,
                 cfg: EngineConfig, optimize_scale: bool = True):
    """One full optimization cycle (== one reference epoch): full-batch
    gradient over all frames, one RMSprop update."""
    return grad_step(
        lambda p: _cycle_loss(p, model, data, aux, coefs, cfg),
        params, opt_state, optimize_scale)


def _update_scene_impl(params: StageParams, data: SeqData,
                       cfg: EngineConfig):
    min_z, max_z = z_bounds_of(params, cfg)
    valid = data.backmask & (data.frame_valid[:, None, None] > 0.5)
    med, ok = aggregate_scene_depth(data.depths, valid, min_z, max_z)
    pcd = build_scene_pointcloud(med, ok, data.cam_K,
                                 use_bilateral=True)
    return pcd


@functools.partial(jax.jit, static_argnames=("cfg",))
def update_scene(params: StageParams, data: SeqData, cfg: EngineConfig):
    """Rebuild the static scene point cloud from the current disparity
    de-normalization (optimizer.py:578-584 + 605-616), fully on-device.
    """
    return _update_scene_impl(params, data, cfg)


def _update_filtered_targets_impl(params: StageParams,
                                  model: SMPLModel, cfg: EngineConfig):
    C, N = cfg.chunk, cfg.num_people
    scale = scale_factor_of(params)

    def chunk_verts(i):
        t0 = i * C
        poses = lax.dynamic_slice_in_dim(params.poses_smpl, t0, C, 0)
        pT = lax.dynamic_slice_in_dim(params.poses_T, t0, C, 0)
        v, _ = _smpl_bodies(model, poses, params.betas, scale, pT)
        return v                                  # (C, N, V, 3)

    def step_outer(carry, i):
        state, prev = carry
        v = chunk_verts(i)

        def step(inner, tv):
            st, pv = inner
            t, x = tv
            te = jnp.maximum(t.astype(jnp.float32) / cfg.frame_rate,
                             1e-6)
            st2, xf = one_euro_step(st, x, te, cfg.min_cutoff2,
                                    cfg.beta2)
            first = t == 0
            xf = jnp.where(first, x, xf)
            st2 = (jnp.where(first, x, st2[0]),
                   jnp.where(first, jnp.zeros_like(x), st2[1]))
            diff = (xf - pv) * (1.0 - first)
            return (st2, xf), diff

        ts = i * C + jnp.arange(C)
        (state, prev), diffs = lax.scan(step, (state, prev), (ts, v))
        return (state, prev), diffs.astype(jnp.bfloat16)

    dummy = jnp.zeros_like(chunk_verts(0)[0])
    init = (one_euro_init(dummy), dummy)
    _, diffs = lax.scan(step_outer, init, jnp.arange(cfg.num_chunks))
    return diffs.reshape(cfg.padded_frames, N, -1, 3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def update_filtered_targets(params: StageParams, model: SMPLModel,
                            cfg: EngineConfig):
    """One-Euro-filter the absolute vertex trajectories and return the
    per-frame filtered differences (bf16) used by the smoothness term.

    Matches the reference's every-25-cycles filtering of
    scale*verts + poses_T with min_cutoff2/beta2 and its 'ramp' time
    base (optimizer.py:383-392 + 664-675), computed chunk-by-chunk with
    the filter state carried across chunk boundaries.
    """
    return _update_filtered_targets_impl(params, model, cfg)


def fused_aux_refresh(params: StageParams, aux: StageAux, cycle_idx,
                      model: SMPLModel, data: SeqData,
                      cfg: EngineConfig) -> StageAux:
    """Conditional aux refreshes under `lax.cond` inside the cycle
    program: the scene rebuild (every `scene_update_every` cycles from
    `warmup_cycles`, reference optimizer.py:578-584) and the One-Euro
    filtered-target refresh (every `update_filters_every`,
    optimizer.py:383-392). Shared by the single-device and sharded
    fused cycles so the refresh cadence can never diverge between
    them."""
    do_aux = cycle_idx >= cfg.warmup_cycles
    do_scene = do_aux & (cycle_idx % cfg.scene_update_every == 0)
    do_filt = do_aux & (cycle_idx % cfg.update_filters_every == 0)

    scene = lax.cond(do_scene,
                     lambda _: _update_scene_impl(params, data, cfg),
                     lambda _: aux.scene, None)
    dvf = lax.cond(do_filt,
                   lambda _: _update_filtered_targets_impl(
                       params, model, cfg),
                   lambda _: aux.verts_filt_diff, None)
    return aux._replace(
        scene=scene,
        have_scene=jnp.maximum(aux.have_scene,
                               do_scene.astype(jnp.float32)),
        verts_filt_diff=dvf,
        have_filters=jnp.maximum(aux.have_filters,
                                 do_filt.astype(jnp.float32)))


@functools.partial(jax.jit,
                   static_argnames=("cfg", "optimize_scale"),
                   donate_argnums=(0, 1, 2))
def stage1_cycle_fused(params: StageParams, opt_state, aux: StageAux,
                       cycle_idx, model: SMPLModel, data: SeqData,
                       coefs, cfg: EngineConfig,
                       optimize_scale: bool = True):
    """One PRODUCTION cycle as ONE device program: the conditional
    aux refreshes (fused_aux_refresh) run inside the same program as
    the full-batch cycle update.

    Fusing makes the steady-state loop exactly one dispatch per cycle
    (instead of three) and keeps the aux state resident on device
    (donated and returned).
    """
    aux = fused_aux_refresh(params, aux, cycle_idx, model, data, cfg)
    params, opt_state, loss, parts = grad_step(
        lambda p: _cycle_loss(p, model, data, aux, coefs, cfg),
        params, opt_state, optimize_scale)
    return params, opt_state, aux, loss, parts


@functools.partial(jax.jit,
                   static_argnames=("cfg", "optimize_scale",
                                    "n_cycles"),
                   donate_argnums=(0, 1, 2))
def stage1_cycles_fused(params: StageParams, opt_state, aux: StageAux,
                        cycle_idx0, model: SMPLModel, data: SeqData,
                        coefs, cfg: EngineConfig,
                        optimize_scale: bool = True,
                        n_cycles: int = 1):
    """`n_cycles` consecutive PRODUCTION cycles as ONE device program
    (a lax.scan over stage1_cycle_fused's body, cycle indices
    cycle_idx0 + [0, n_cycles)). Losses and log parts come back
    stacked: (n_cycles,), (n_cycles, len(LOG_KEYS)). Semantically
    identical to
    n_cycles calls of stage1_cycle_fused — the refresh cadence conds
    take the traced per-iteration index.

    Predictor.fit keeps its one-dispatch-per-cycle loop (simpler
    checkpoint/bench boundaries); whether K cycles per dispatch buys
    anything on the GPU is not measured (ROADMAP S6/D4). This
    primitive serves driver-less long runs where a caller wants K
    cycles per host interaction."""
    def body(carry, k):
        params, opt_state, aux = carry
        aux = fused_aux_refresh(params, aux, cycle_idx0 + k, model,
                                data, cfg)
        params, opt_state, loss, parts = grad_step(
            lambda p: _cycle_loss(p, model, data, aux, coefs, cfg),
            params, opt_state, optimize_scale)
        return (params, opt_state, aux), (loss, parts)

    (params, opt_state, aux), (losses, parts) = lax.scan(
        body, (params, opt_state, aux),
        jnp.arange(n_cycles, dtype=jnp.uint32))
    return params, opt_state, aux, losses, parts


@functools.partial(jax.jit, static_argnames=("cfg",))
def get_filtered_vertices(params: StageParams, model: SMPLModel,
                          cfg: EngineConfig,
                          min_cutoff_T: float = 0.004,
                          min_cutoff_angles: float = 0.1,
                          beta_T: float = 0.7,
                          beta_angles: float = 0.1):
    """Final-output smoothing: One-Euro-filter poses_T and the SMPL
    pose angles (uniform time base), then rebuild absolute vertices.

    Parity with reference get_filtered_vertices_by_smpl
    (optimizer.py:639-661). Returns (Tp, N, V, 3).
    """
    from ..ops.one_euro import one_euro_filter

    tp, n = params.poses_T.shape[:2]
    poses_T_f = one_euro_filter(params.poses_T,
                                min_cutoff=min_cutoff_T, beta=beta_T,
                                frame_rate=cfg.frame_rate,
                                dt_mode="uniform")
    poses_f = one_euro_filter(params.poses_smpl,
                              min_cutoff=min_cutoff_angles,
                              beta=beta_angles,
                              frame_rate=cfg.frame_rate,
                              dt_mode="uniform")
    scale = scale_factor_of(params)

    def chunk_verts(i):
        t0 = i * cfg.chunk
        p = lax.dynamic_slice_in_dim(poses_f, t0, cfg.chunk, 0)
        t = lax.dynamic_slice_in_dim(poses_T_f, t0, cfg.chunk, 0)
        v, _ = _smpl_bodies(model, p, params.betas, scale, t)
        return v

    _, verts = lax.scan(lambda c, i: (c, chunk_verts(i)), 0,
                        jnp.arange(cfg.num_chunks))
    return verts.reshape(tp, n, -1, 3)


def get_optimized_variables(params: StageParams, cfg: EngineConfig,
                            data_valid_smpl: np.ndarray,
                            scene: Optional[Dict] = None) -> Dict:
    """Export the optvar dict with the reference's pickle schema
    (optimizer.py:619-636). Arrays are unpadded to the real T."""
    T = cfg.num_frames
    min_z, max_z = z_bounds_of(params, cfg)
    out = {
        "scale_factor": np.asarray(scale_factor_of(params)),
        "poses_T": np.asarray(params.poses_T)[:T],
        "poses_smpl": np.asarray(params.poses_smpl)[:T],
        "betas_smpl": np.asarray(params.betas),
        "valid_smpl": np.asarray(data_valid_smpl)[:T],
        "min_z": np.asarray(min_z)[:T],
        "max_z": np.asarray(max_z)[:T],
        "scene_depth": None,
        "scene_img": None,
        "scene_mask": None,
    }
    if scene:
        out.update(scene)
    return out
