"""Engine tests: init stage + stage-1 cycles on a tiny synthetic
sequence with a known optimum."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.models.smpl import smpl_forward
from mhmocap.ops.cameras import project_points, intrinsics_from_fov
from mhmocap.engine import optimizer as E


@pytest.fixture(scope="module")
def tiny_problem():
    """T=8 frames, N=2 people, 64x64 image, V=512 synthetic body."""
    model = make_synthetic_smpl(num_vertices=512, seed=1)
    T, N = 8, 2
    W = H = 64
    K = intrinsics_from_fov((W, H), 60.0)
    rng = np.random.RandomState(0)

    poses_T_gt = np.zeros((T, N, 1, 3), np.float32)
    poses_T_gt[:, 0, 0] = [-0.5, 0.3, 3.0]
    poses_T_gt[:, 1, 0] = [0.5, 0.3, 4.0]
    poses_T_gt[..., 0] += 0.05 * rng.randn(T, N, 1)

    poses_smpl = 0.1 * rng.randn(T, N, 72).astype(np.float32)
    betas = np.zeros((T, N, 10), np.float32)

    out = smpl_forward(model, jnp.asarray(betas.reshape(-1, 10)),
                       jnp.asarray(poses_smpl.reshape(-1, 72)))
    j3d = np.asarray(out["joints_alphapose"]).reshape(T, N, 17, 3) \
        + poses_T_gt
    uv = np.asarray(project_points(jnp.asarray(j3d), jnp.asarray(K)))
    pose2d = np.concatenate(
        [uv, 0.9 * np.ones((T, N, 17, 1), np.float32)], axis=-1)

    cfg = E.EngineConfig(image_size=(W, H), num_people=N, num_frames=T,
                         chunk=4, window=32, face_chunk=128,
                         frame_bucket=8)
    return dict(model=model, cfg=cfg, K=K, pose2d=pose2d,
                poses_smpl=poses_smpl, betas=betas,
                poses_T_gt=poses_T_gt)


def test_init_stage_recovers_translations(tiny_problem):
    p = tiny_problem
    params, hist, opt_scale = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        p["cfg"], num_iter=150)
    assert opt_scale
    assert hist.shape == (150,)
    assert hist[-1] < hist[0] * 0.05, (hist[0], hist[-1])
    T = p["cfg"].num_frames
    err = np.abs(np.asarray(params.poses_T)[:T] - p["poses_T_gt"])
    # depth is weakly constrained from 2D alone, xy should be close
    assert err[..., 0].mean() < 0.1
    assert err[..., 1].mean() < 0.1
    assert err[..., 2].mean() < 0.6


def _make_seq_data(p, params):
    """Build SeqData whose depths/masks come from the GT scene."""
    from mhmocap.data.ingestion import SequenceArrays
    cfg = p["cfg"]
    T, N = cfg.num_frames, cfg.num_people
    W, H = cfg.image_size
    rng = np.random.RandomState(1)
    depths = np.clip(0.5 + 0.1 * rng.randn(T, H, W), 0, 1).astype(
        np.float32)
    seg = np.zeros((T, N, H, W), np.float32)
    seg[:, 0, 10:40, 5:25] = 1
    seg[:, 1, 10:40, 35:55] = 1
    back = np.ones((T, H, W), np.float32)
    back[:, 10:40, 5:55] = 0
    seq = SequenceArrays(
        images=np.zeros((T, H, W, 3), np.uint8),
        depths=depths,
        instances=np.zeros((T, H, W), np.uint8),
        seg_mask=seg,
        backmasks=back,
        pose2d=p["pose2d"],
        cam_smpl=np.zeros((T, N, 3), np.float32),
        poses_smpl=p["poses_smpl"],
        betas_smpl=p["betas"],
        valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": p["K"], "fov": 60.0, "Kd": None,
             "image_size": (W, H)},
    )
    return E.prepare_seq_data(seq, cfg)


@pytest.mark.slow
def test_stage1_cycle_runs_and_descends(tiny_problem):
    p = tiny_problem
    cfg = p["cfg"]
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=50)
    data = _make_seq_data(p, params)
    aux = E.init_aux(cfg, p["model"].num_vertices,
                     jnp.asarray(p["betas"][:1].mean(0, keepdims=True)))
    coefs = E.default_coefs()
    opt = E.make_stage1_optimizer()
    opt_state = opt.init(params)

    losses = []
    for cycle in range(4):
        params, opt_state, loss, parts = E.stage1_cycle(
            params, opt_state, p["model"], data, aux, coefs, cfg)
        losses.append(float(loss))
        assert np.isfinite(losses[-1]), (cycle, parts)
    assert losses[-1] < losses[0], losses
    # log parts match the documented key order and are finite
    assert parts.shape == (len(E.LOG_KEYS),)
    assert np.isfinite(np.asarray(parts)).all()


@pytest.mark.slow
def test_scene_update_and_contact_terms(tiny_problem):
    p = tiny_problem
    cfg = p["cfg"]
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=30)
    data = _make_seq_data(p, params)
    pcd = E.update_scene(params, data, cfg)
    W, H = cfg.image_size
    assert pcd.points.shape == (H * W, 3)
    assert bool(pcd.valid.any())
    assert np.isfinite(np.asarray(pcd.depth)).all()

    aux = E.init_aux(cfg, p["model"].num_vertices,
                     jnp.asarray(p["betas"][:1]))
    aux = aux._replace(scene=pcd, have_scene=jnp.ones(()))
    coefs = E.default_coefs()
    opt = E.make_stage1_optimizer()
    opt_state = opt.init(params)
    params2, _, loss, parts = E.stage1_cycle(
        params, opt_state, p["model"], data, aux, coefs, cfg)
    # contact + foot sliding terms become active
    idx_contact = E.LOG_KEYS.index("reg_contact")
    assert float(parts[idx_contact]) > 0
    assert np.isfinite(float(loss))


def test_filtered_targets_shape_and_effect(tiny_problem):
    p = tiny_problem
    cfg = p["cfg"]
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=30)
    dvf = E.update_filtered_targets(params, p["model"], cfg)
    assert dvf.shape == (cfg.padded_frames, cfg.num_people,
                         p["model"].num_vertices, 3)
    assert dvf.dtype == jnp.bfloat16
    # frame 0 diff must be zero (no predecessor)
    assert float(jnp.abs(dvf[0]).max()) == 0.0
    # diffs should be small (walking motion)
    assert float(jnp.abs(dvf.astype(jnp.float32)).mean()) < 0.5


def test_get_optimized_variables_schema(tiny_problem):
    p = tiny_problem
    cfg = p["cfg"]
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=10)
    T, N = cfg.num_frames, cfg.num_people
    out = E.get_optimized_variables(
        params, cfg, np.ones((T, N, 1), np.float32))
    assert out["poses_T"].shape == (T, N, 1, 3)
    assert out["poses_smpl"].shape == (T, N, 72)
    assert out["betas_smpl"].shape == (1, N, 10)
    assert out["scale_factor"].shape == (1, N, 1, 1)
    assert out["min_z"].shape == (T, 1, 1)
    assert out["max_z"].shape == (T, 1, 1)
    assert (out["max_z"] > out["min_z"]).all()
    for k in ("scene_depth", "scene_img", "scene_mask"):
        assert k in out


@pytest.mark.slow
def test_fused_cycle_matches_separate_updates(tiny_problem):
    """stage1_cycle_fused (one program per production cycle) must
    reproduce the separate update_scene + update_filtered_targets +
    stage1_cycle sequence exactly, and skip the refreshes before
    warmup_cycles."""
    p = tiny_problem
    cfg = p["cfg"]
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=20)
    data = _make_seq_data(p, params)
    aux0 = E.init_aux(cfg, p["model"].num_vertices,
                      jnp.asarray(p["betas"][:1].mean(0, keepdims=True)))
    coefs = E.default_coefs()
    opt = E.make_stage1_optimizer()
    copy = lambda t: jax.tree.map(jnp.copy, t)

    # separate path at a cycle where BOTH refreshes fire (50 >= 30,
    # 50 % 25 == 0, scene every cycle)
    pcd = E.update_scene(params, data, cfg)
    dvf = E.update_filtered_targets(params, p["model"], cfg)
    aux_sep = aux0._replace(scene=pcd, have_scene=jnp.ones(()),
                            verts_filt_diff=dvf,
                            have_filters=jnp.ones(()))
    p1, _, l1, parts1 = E.stage1_cycle(
        copy(params), opt.init(params), p["model"], data, aux_sep,
        coefs, cfg)

    p2, _, aux2, l2, parts2 = E.stage1_cycle_fused(
        copy(params), opt.init(params), copy(aux0), jnp.uint32(50),
        p["model"], data, coefs, cfg)
    assert float(aux2.have_scene) == 1.0
    assert float(aux2.have_filters) == 1.0
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(parts2), np.asarray(parts1),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(p2.poses_T),
                               np.asarray(p1.poses_T), atol=1e-7)
    np.testing.assert_allclose(np.asarray(aux2.scene.depth),
                               np.asarray(pcd.depth), atol=1e-6)

    # warmup cycle: no refresh fires, cycle equals the bare one
    p3, _, l3, parts3 = E.stage1_cycle(
        copy(params), opt.init(params), p["model"], data, aux0,
        coefs, cfg)
    p4, _, aux4, l4, _ = E.stage1_cycle_fused(
        copy(params), opt.init(params), copy(aux0), jnp.uint32(0),
        p["model"], data, coefs, cfg)
    assert float(aux4.have_scene) == 0.0
    assert float(aux4.have_filters) == 0.0
    np.testing.assert_allclose(float(l4), float(l3), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p4.poses_T),
                               np.asarray(p3.poses_T), atol=1e-7)


@pytest.mark.slow
def test_per_person_windows(tiny_problem):
    """Per-person raster windows (EngineConfig.windows).

    (a) windows=(w, w) reproduces the shared-window loss exactly (the
        window_groups path batches equal sizes into the same single
        raster call);
    (b) shrinking the FAR person's window (still covering their bbox)
        changes the loss only by silhouette blur-tail amounts;
    (c) gradients stay finite and close.
    """
    import dataclasses

    p = tiny_problem
    # window 40 covers both bodies (z=3 and z=4 at 64 px, needs ~31/23)
    cfg = dataclasses.replace(p["cfg"], window=40)
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=30)
    data = _make_seq_data(p, params)
    aux = E.init_aux(cfg, p["model"].num_vertices,
                     jnp.asarray(p["betas"][:1].mean(0, keepdims=True)))
    coefs = E.default_coefs()

    def loss_parts(c):
        l, parts = jax.jit(
            lambda pr: E._cycle_loss(pr, p["model"], data, aux,
                                     coefs, c),
            static_argnames=())(params)
        return float(l), np.asarray(parts)

    l_shared, parts_shared = loss_parts(cfg)
    l_equal, parts_equal = loss_parts(
        dataclasses.replace(cfg, windows=(40, 40)))
    np.testing.assert_allclose(l_equal, l_shared, rtol=1e-6)
    np.testing.assert_allclose(parts_equal, parts_shared, rtol=1e-5)

    # far person (index 1, z=4) at a smaller window
    cfg_pp = dataclasses.replace(cfg, windows=(40, 32))
    l_pp, parts_pp = loss_parts(cfg_pp)
    assert np.isfinite(l_pp)
    np.testing.assert_allclose(l_pp, l_shared, rtol=0.05)

    g_shared = jax.grad(
        lambda pr: E._cycle_loss(pr, p["model"], data, aux, coefs,
                                 cfg)[0])(params)
    g_pp = jax.grad(
        lambda pr: E._cycle_loss(pr, p["model"], data, aux, coefs,
                                 cfg_pp)[0])(params)
    for a, b in zip(jax.tree.leaves(g_shared), jax.tree.leaves(g_pp)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all()
        # gradient direction must agree where it is meaningfully large
        big = np.abs(a) > 1e-3
        if big.any():
            cos = np.sum(a[big] * b[big]) / (
                np.linalg.norm(a[big]) * np.linalg.norm(b[big]) + 1e-12)
            assert cos > 0.99, cos


@pytest.mark.slow
def test_multi_cycle_scan_matches_cycle_loop(tiny_problem):
    """stage1_cycles_fused (K cycles per dispatch via lax.scan) must
    reproduce K sequential stage1_cycle_fused calls exactly —
    including the refresh-cadence conds firing mid-scan. The span
    28..34 crosses the warmup boundary (warmup_cycles=30), so the
    scan must leave cycles 28-29 unrefreshed and engage the scene
    from 30."""
    p = tiny_problem
    cfg = p["cfg"]
    K = 6
    params, _, _ = E.init_params(
        p["model"], p["pose2d"], p["poses_smpl"], p["betas"], p["K"],
        cfg, num_iter=20)
    data = _make_seq_data(p, params)
    aux0 = E.init_aux(cfg, p["model"].num_vertices,
                      jnp.asarray(p["betas"][:1].mean(0,
                                                      keepdims=True)))
    coefs = E.default_coefs()
    opt = E.make_stage1_optimizer()
    copy = lambda t: jax.tree.map(jnp.copy, t)

    pl, ol, auxl = copy(params), opt.init(params), copy(aux0)
    losses_l, parts_l = [], []
    for c in range(28, 28 + K):
        pl, ol, auxl, ll, pp = E.stage1_cycle_fused(
            pl, ol, auxl, jnp.uint32(c), p["model"], data, coefs, cfg)
        losses_l.append(float(ll))
        parts_l.append(np.asarray(pp))

    ps, os_, auxs, ls, parts_s = E.stage1_cycles_fused(
        copy(params), opt.init(params), copy(aux0), jnp.uint32(28),
        p["model"], data, coefs, cfg, n_cycles=K)
    assert ls.shape == (K,)
    assert parts_s.shape == (K, len(E.LOG_KEYS))
    np.testing.assert_allclose(np.asarray(ls), np.asarray(losses_l),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(parts_s),
                               np.stack(parts_l), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(ps.poses_T),
                               np.asarray(pl.poses_T), atol=1e-7)
    np.testing.assert_allclose(np.asarray(ps.poses_smpl),
                               np.asarray(pl.poses_smpl), atol=1e-7)
    # the scene engaged mid-scan (cycle 30) in both paths
    assert float(auxs.have_scene) == float(auxl.have_scene) == 1.0
    np.testing.assert_allclose(np.asarray(auxs.scene.depth),
                               np.asarray(auxl.scene.depth),
                               atol=1e-6)
