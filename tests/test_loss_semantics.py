"""Golden tests for the stage-1 loss semantics.

Each test hand-computes the reference's formula (from its definition,
not its code) on a tiny constructed case and checks the engine's
chunk loss reproduces it: the depth term's per-instance mean-log
normalization, the silhouette term's (1-acc)/N normalization including
out-of-window content, and the regularizer accounting.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.engine import optimizer as E
from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.models.smpl import smpl_forward
from mhmocap.ops.cameras import project_points, intrinsics_from_fov
from mhmocap.ops.rasterizer import RasterSettings, rasterize_bodies
from mhmocap.ops.morphology import erode


@pytest.fixture(scope="module")
def setup():
    model = make_synthetic_smpl(num_vertices=256, seed=5)
    C, N = 2, 2
    W = H = 48
    K = intrinsics_from_fov((W, H), 60.0)
    cfg = E.EngineConfig(image_size=(W, H), num_people=N,
                         num_frames=C, chunk=C, window=48,
                         face_chunk=64)
    rng = np.random.RandomState(0)
    poses_T = np.zeros((C, N, 1, 3), np.float32)
    poses_T[:, 0, 0] = [-0.35, 0.3, 3.0]
    poses_T[:, 1, 0] = [0.35, 0.3, 3.5]
    poses_smpl = 0.05 * rng.randn(C, N, 72).astype(np.float32)
    betas = jnp.zeros((1, N, 10))
    return dict(model=model, cfg=cfg, K=K, poses_T=poses_T,
                poses_smpl=poses_smpl, betas=betas, rng=rng)


def _chunk(setup, seg, depths, pose2d, dvf=None):
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    params_T = jnp.asarray(setup["poses_T"])
    poses = jnp.asarray(setup["poses_smpl"])
    min_z = jnp.full((C, 1, 1), 2.0)
    max_z = jnp.full((C, 1, 1), 8.0)
    V = setup["model"].num_vertices
    return E.ChunkInputs(
        poses_T_h=jnp.concatenate([params_T[:1], params_T], 0),
        poses_smpl_h=jnp.concatenate([poses[:1], poses], 0),
        min_z_c=min_z, max_z_c=max_z,
        depths_c=jnp.asarray(depths),
        seg_c=jnp.asarray(seg),
        seg_er_c=erode(jnp.asarray(seg, jnp.float32), kernel_size=3,
                       iterations=2),
        pose2d_c=jnp.asarray(pose2d),
        ref_poses_c=poses,
        valid_smpl_c=jnp.ones((C, N, 1)),
        frame_valid_h=jnp.ones((C + 1,)),
        global_t=jnp.arange(C),
        dvf_c=(jnp.zeros((C, N, V, 3), jnp.bfloat16)
               if dvf is None else dvf),
    )


# One jitted wrapper shared by every test in this module (coefs and
# aux flags are traced, cfg is static) — eager execution of the chunk
# loss dispatches thousands of tiny CPU ops per call and dominated the
# suite's runtime.
import functools


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_core(chunk, model, betas, scale, K, aux, coefs, cfg):
    return E._chunk_loss_core(chunk, model, betas, scale, K, aux,
                              coefs, cfg)


def _run_core(setup, chunk, coefs, aux=None):
    cfg = setup["cfg"]
    if aux is None:
        aux = E.init_aux(cfg, setup["model"].num_vertices,
                         setup["betas"])
    scale = jnp.ones((1, cfg.num_people, 1, 1))
    coefs = {k: jnp.float32(v) for k, v in coefs.items()}
    loss, parts = _jit_core(chunk, setup["model"], setup["betas"],
                            scale, jnp.asarray(setup["K"]), aux, coefs,
                            cfg)
    return float(loss), dict(zip(E.LOG_KEYS, np.asarray(parts)))


def _zero_coefs():
    return {k: 0.0 for k in ("proj2d", "depth", "silhouette",
                             "reg_poses", "reg_scales", "reg_velocity",
                             "reg_verts_filter", "reg_contact",
                             "reg_foot_sliding")}


def _render(setup):
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    out = smpl_forward(
        setup["model"],
        jnp.broadcast_to(setup["betas"], (C, N, 10)).reshape(-1, 10),
        jnp.asarray(setup["poses_smpl"]).reshape(-1, 72))
    verts = (np.asarray(out["verts"]).reshape(C, N, -1, 3)
             + setup["poses_T"])
    joints = (np.asarray(out["joints_alphapose"]).reshape(C, N, -1, 3)
              + setup["poses_T"])
    r = rasterize_bodies(jnp.asarray(verts.reshape(C * N, -1, 3)),
                         setup["model"].faces, jnp.asarray(setup["K"]),
                         cfg.raster_settings)
    W = cfg.image_size[0]
    return verts, joints, {
        "zbuf": np.asarray(r["zbuf"]).reshape(C, N, W, W),
        "sil": np.asarray(r["sil"]).reshape(C, N, W, W),
    }


def test_pose2d_loss_formula(setup):
    """loss = sum((vis_mask * (proj - gt) / (W, H))^2)."""
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    W = cfg.image_size[0]
    _, joints, _ = _render(setup)
    uv = np.asarray(project_points(jnp.asarray(joints),
                                   jnp.asarray(setup["K"])))
    gt = uv + 2.0  # constant 2px offset
    conf = np.ones((C, N, 17, 1), np.float32)
    conf[0, 0, :5] = 0.1  # below threshold -> excluded
    pose2d = np.concatenate([gt, conf], axis=-1).astype(np.float32)

    seg = np.zeros((C, N, W, W), np.float32)
    depths = np.full((C, W, W), 0.5, np.float32)
    coefs = _zero_coefs() | {"proj2d": 1.0}
    loss, parts = _run_core(setup, _chunk(setup, seg, depths, pose2d),
                            coefs)
    n_joints = C * N * 17 - 5
    expected = n_joints * ((2.0 / W) ** 2 + (2.0 / W) ** 2)
    np.testing.assert_allclose(parts["loss_pose24j"], expected,
                               rtol=1e-4)


def test_depth_loss_is_mean_log_disparity_alignment(setup):
    """Per (frame, person): (mean log zbuf_disp - mean log target)^2
    with the (count + 1) normalizer, summed."""
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    W = cfg.image_size[0]
    verts, joints, r = _render(setup)
    uv = np.asarray(project_points(jnp.asarray(joints),
                                   jnp.asarray(setup["K"])))
    pose2d = np.concatenate(
        [uv, np.ones((C, N, 17, 1))], -1).astype(np.float32)
    # segmentation = exact coverage per person
    seg = np.isfinite(r["zbuf"]).astype(np.float32)
    depths = np.full((C, W, W), 0.5, np.float32)

    coefs = _zero_coefs() | {"depth": 1.0}
    loss, parts = _run_core(setup, _chunk(setup, seg, depths, pose2d),
                            coefs)

    # golden: window == full image here (48 <= window)
    target_disp = 0.5 * (1 / 2.0 - 1 / 8.0) + 1 / 8.0
    seg_er = np.asarray(erode(jnp.asarray(seg), 3, iterations=2))
    expected = 0.0
    for c in range(C):
        for n in range(N):
            m = seg_er[c, n] * np.isfinite(r["zbuf"][c, n])
            npix = m.sum() + 1.0
            zd = 1.0 / np.clip(
                np.where(m > 0, r["zbuf"][c, n], 1.0) + 0.2, 1e-3,
                None)
            mp = (m * np.log(zd)).sum() / npix
            mt = (m * np.log(target_disp)).sum() / npix
            expected += (mp - mt) ** 2
    np.testing.assert_allclose(parts["loss_depth"], expected,
                               rtol=2e-3)


def test_silhouette_loss_occlusion_ordering(setup):
    """Person 0 (closer) keeps its full mask; person 1's loss is
    masked by (1 - seg_0) and normalized by sum(1-acc)+1 over the
    image, including seg content outside the render window."""
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    W = cfg.image_size[0]
    verts, joints, r = _render(setup)
    uv = np.asarray(project_points(jnp.asarray(joints),
                                   jnp.asarray(setup["K"])))
    pose2d = np.concatenate(
        [uv, np.ones((C, N, 17, 1))], -1).astype(np.float32)
    rng = setup["rng"]
    seg = (rng.rand(C, N, W, W) > 0.5).astype(np.float32)
    depths = np.full((C, W, W), 0.5, np.float32)

    coefs = _zero_coefs() | {"silhouette": 1.0}
    loss, parts = _run_core(setup, _chunk(setup, seg, depths, pose2d),
                            coefs)

    expected = 0.0
    for c in range(C):
        # z-order: person 0 at z=3 closer than person 1 at z=3.5
        acc = np.zeros((W, W), np.float32)
        for n in (0, 1):
            keep = 1.0 - acc
            n_keep = keep.sum() + 1.0
            diff = (keep * (r["sil"][c, n] - seg[c, n])) ** 2
            expected += diff.sum() / n_keep
            acc = np.clip(acc + seg[c, n], 0, 1)
    np.testing.assert_allclose(parts["loss_silhouette"], expected,
                               rtol=2e-3)


def test_velocity_and_ref_pose_regularizers(setup):
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    W = cfg.image_size[0]
    seg = np.zeros((C, N, W, W), np.float32)
    depths = np.full((C, W, W), 0.5, np.float32)
    pose2d = np.zeros((C, N, 17, 3), np.float32)

    # perturb frame 1's translation and reference poses
    setup2 = dict(setup)
    pT = setup["poses_T"].copy()
    pT[1] += 0.1
    setup2["poses_T"] = pT

    coefs = _zero_coefs() | {"reg_velocity": 1.0, "reg_poses": 1.0}
    chunk = _chunk(setup2, seg, depths, pose2d)
    # reference poses offset by 0.2 for person 0 only
    ref = np.asarray(chunk.ref_poses_c).copy()
    ref[:, 0] += 0.2
    chunk = chunk._replace(ref_poses_c=jnp.asarray(ref))
    loss, parts = _run_core(setup2, chunk, coefs)

    # velocity: pair (0,1) only (pair 0 is global_t=0-gated);
    # diff = 0.1 on all N*3 components
    np.testing.assert_allclose(parts["reg_vel"],
                               N * 3 * 0.1 ** 2, rtol=1e-4)
    # ref poses: |0.2| * 72 params * C frames for person 0 + C * |betas
    # diff| (zero here)
    np.testing.assert_allclose(parts["reg_ref_poses"],
                               0.2 * 72 * C, rtol=1e-4)


def test_filtered_verts_regularizer(setup):
    """sum((dv - dvf_target)^2) over valid pairs."""
    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    W = cfg.image_size[0]
    V = setup["model"].num_vertices
    seg = np.zeros((C, N, W, W), np.float32)
    depths = np.full((C, W, W), 0.5, np.float32)
    pose2d = np.zeros((C, N, 17, 3), np.float32)

    coefs = _zero_coefs() | {"reg_verts_filter": 1.0}
    # identical frames => gv_diff == 0, isolating the target term
    setup = dict(setup)
    poses = setup["poses_smpl"].copy()
    poses[1] = poses[0]
    setup["poses_smpl"] = poses
    chunk = _chunk(setup, seg, depths, pose2d,
                   dvf=jnp.full((C, N, V, 3), 0.01, jnp.bfloat16))
    aux = E.init_aux(cfg, V, setup["betas"])
    aux = aux._replace(have_filters=jnp.ones(()))
    loss, parts = _run_core(setup, chunk, coefs, aux=aux)
    # poses identical across frames -> gv_diff == 0 for the valid pair
    # (frame 1 vs 0); target dvf = 0.01 everywhere
    dvf01 = np.float32(jnp.bfloat16(0.01))
    expected = N * V * 3 * dvf01 ** 2  # only pair t=1 contributes
    np.testing.assert_allclose(parts["reg_filter_verts"], expected,
                               rtol=2e-2)


def test_pose2d_joint_weights(setup):
    """pose17j_weights multiply each joint's error inside the square
    (reference optimizer.py:367-368 + 419-420: the MSE mask is
    pose_weights * conf); all-ones weights normalize to exactly 1 and
    reproduce the unweighted loss."""
    import dataclasses

    cfg = setup["cfg"]
    C, N = cfg.chunk, cfg.num_people
    W = cfg.image_size[0]
    _, joints, _ = _render(setup)
    uv = np.asarray(project_points(jnp.asarray(joints),
                                   jnp.asarray(setup["K"])))
    gt = uv + 2.0
    conf = np.ones((C, N, 17, 1), np.float32)
    pose2d = np.concatenate([gt, conf], axis=-1).astype(np.float32)
    seg = np.zeros((C, N, W, W), np.float32)
    depths = np.full((C, W, W), 0.5, np.float32)
    coefs = _zero_coefs() | {"proj2d": 1.0}

    base, parts0 = _run_core(setup, _chunk(setup, seg, depths, pose2d),
                             coefs)

    ones = dict(setup, cfg=dataclasses.replace(
        cfg, pose17j_weights=(1.0,) * 17))
    _, parts1 = _run_core(ones, _chunk(ones, seg, depths, pose2d),
                          coefs)
    np.testing.assert_allclose(parts1["loss_pose24j"],
                               parts0["loss_pose24j"], rtol=1e-6)

    w_raw = np.arange(1.0, 18.0, dtype=np.float32)
    wt = dict(setup, cfg=dataclasses.replace(
        cfg, pose17j_weights=tuple(float(x) for x in w_raw)))
    _, parts2 = _run_core(wt, _chunk(wt, seg, depths, pose2d), coefs)
    w = E.normalize_joint_weights(w_raw)
    # constant 2px error in u and v at every joint: each joint's
    # contribution scales by its squared normalized weight
    expected = C * N * float(np.sum(w ** 2)) * 2 * (2.0 / W) ** 2
    np.testing.assert_allclose(parts2["loss_pose24j"], expected,
                               rtol=1e-4)


def test_init_solve_joint_weights(setup):
    """init_global_poses with all-ones weights is bit-identical to
    None (reference normalization len*w/sum == 1), and non-uniform
    weights change the solve."""
    model = setup["model"]
    T, N = 3, 1
    K = jnp.asarray(setup["K"])
    rng = np.random.RandomState(7)
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = 24 + 2 * rng.randn(T, N, 17)
    pose2d[..., 1] = 24 + 2 * rng.randn(T, N, 17)
    pose2d[..., 2] = 0.9
    args = (model, jnp.asarray(pose2d), jnp.zeros((T, N, 72)),
            jnp.zeros((T, N, 10)), K, jnp.zeros((1, N, 1, 1)))

    sol_none, _ = E.init_global_poses(*args, num_iter=20)
    sol_ones, _ = E.init_global_poses(
        *args, num_iter=20, pose_weights=jnp.ones((17,)))
    np.testing.assert_array_equal(np.asarray(sol_none),
                                  np.asarray(sol_ones))

    w = jnp.asarray(E.normalize_joint_weights(np.arange(1.0, 18.0)))
    sol_w, hist = E.init_global_poses(*args, num_iter=20,
                                      pose_weights=w)
    assert np.isfinite(np.asarray(sol_w)).all()
    assert float(np.abs(np.asarray(sol_w) - np.asarray(sol_none)).max()) > 0
