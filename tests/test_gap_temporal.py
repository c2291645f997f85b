"""Gap-aware temporal losses (EngineConfig.gap_aware_temporal).

The reference anchors detection-dropout spans to a stale 2D copy
(datautils.py:326-333) and its velocity/filtered-verts regularizers
(optimizer.py:560-573) smear the distortion into the OBSERVED frames
flanking the gap. The opt-in knob masks the temporal pair terms on
pairs with a stale endpoint and adds an acceleration penalty across
stale triples so gaps interpolate DURING the fit. These tests pin:
golden per-term values against independent numpy, exact chunk tiling,
clean-input bit-identity, the interpolation fixed point, and SPMD
parity with the stale mask riding the widened 2-frame halo exchange.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.engine import optimizer as E
from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.ops.cameras import intrinsics_from_fov


def _problem(T=12, N=2, chunk=4, gap=True, seed=0, stale=None,
             pose2d_mut=None):
    """Tiny full-pipeline problem with a constructed stale mask."""
    model = make_synthetic_smpl(num_vertices=128, seed=3)
    W = H = 32
    K = intrinsics_from_fov((W, H), 60.0)
    rng = np.random.RandomState(seed)

    cfg = E.EngineConfig(image_size=(W, H), num_people=N,
                         num_frames=T, chunk=chunk, window=16,
                         face_chunk=128, frame_bucket=chunk,
                         gap_aware_temporal=gap)

    poses_T = np.zeros((cfg.padded_frames, N, 1, 3), np.float32)
    poses_T[:, :, 0, 2] = 3.0
    poses_T[:T, :, 0, 0] = (0.1 * rng.randn(T, N)).astype(np.float32)
    poses_smpl = 0.05 * rng.randn(cfg.padded_frames, N, 72).astype(
        np.float32)
    params = E.StageParams(
        poses_T=jnp.asarray(poses_T),
        poses_smpl=jnp.asarray(poses_smpl),
        betas=jnp.zeros((1, N, 10)),
        zmin_lin=jnp.ones((cfg.padded_frames, 1, 1)),
        zmax_lin=jnp.full((cfg.padded_frames, 1, 1), 4.0),
        xscale=jnp.zeros((1, N, 1, 1)),
    )

    if stale is None:
        stale = np.zeros((T, N), np.float32)
        stale[4:7, 1] = 1.0              # a 3-frame gap for person 1
    stale_p = np.zeros((cfg.padded_frames, N), np.float32)
    stale_p[:T] = stale

    from mhmocap.data.ingestion import SequenceArrays
    seg = np.zeros((T, N, H, W), np.float32)
    for n in range(N):
        seg[:, n, 8:24, 4 + 14 * n:14 + 14 * n] = 1
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = 10.0 + 12.0 * np.arange(N)[None, :, None]
    pose2d[..., 1] = 16.0
    pose2d[..., 2] = 0.9
    if pose2d_mut is not None:
        pose2d_mut(pose2d)
    seq = SequenceArrays(
        images=np.zeros((T, H, W, 3), np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, H, W), 0, 1).astype(
            np.float32),
        instances=np.zeros((T, H, W), np.uint8),
        seg_mask=seg,
        backmasks=1.0 - seg.max(axis=1),
        pose2d=pose2d,
        cam_smpl=np.zeros((T, N, 3), np.float32),
        poses_smpl=poses_smpl[:T],
        betas_smpl=np.zeros((T, N, 10), np.float32),
        valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": K, "fov": 60.0, "Kd": None, "image_size": (W, H)},
        lagged_tn=stale.astype(bool),
    )
    data = E.prepare_seq_data(seq, cfg)
    aux = E.init_aux(cfg, model.num_vertices, jnp.zeros((1, N, 10)))
    coefs = E.default_coefs()
    return dict(model=model, cfg=cfg, params=params, data=data,
                aux=aux, coefs=coefs, stale=stale, T=T, N=N,
                poses_T=poses_T, poses_smpl=poses_smpl)


def _golden_temporal(p):
    """Independent numpy computation of reg_vel / reg_gap_accel under
    the gap-aware gates (masks from the DEFINITION, not the code)."""
    T, N = p["T"], p["N"]
    pT, pS, st = p["poses_T"], p["poses_smpl"], p["stale"]
    reg_vel = 0.0
    for t in range(1, T):
        for n in range(N):
            if st[t - 1, n] or st[t, n]:
                continue
            reg_vel += np.sum((pT[t, n] - pT[t - 1, n]) ** 2)
    reg_acc = 0.0
    for t in range(1, T - 1):                  # centers
        for n in range(N):
            if not (st[t - 1, n] or st[t, n] or st[t + 1, n]):
                continue
            a_T = pT[t + 1, n] - 2 * pT[t, n] + pT[t - 1, n]
            a_P = pS[t + 1, n] - 2 * pS[t, n] + pS[t - 1, n]
            reg_acc += np.sum(a_T ** 2) + np.sum(a_P ** 2)
    return reg_vel, reg_acc


def _parts(p):
    _, parts = jax.jit(
        lambda pa, d, a: E._cycle_loss(pa, p["model"], d, a,
                                       p["coefs"], p["cfg"]),
        static_argnames=())(p["params"], p["data"], p["aux"])
    return dict(zip(E.LOG_KEYS, np.asarray(parts)))


def test_gap_terms_match_numpy_golden():
    p = _problem()
    parts = _parts(p)
    g_vel, g_acc = _golden_temporal(p)
    np.testing.assert_allclose(parts["reg_vel"], g_vel, rtol=1e-5)
    np.testing.assert_allclose(parts["reg_gap_accel"], g_acc,
                               rtol=1e-5)
    assert parts["reg_gap_accel"] > 0.0


def test_gap_terms_tile_chunks_exactly_once():
    """Chunked scan (C=4) and whole-sequence chunk (C=12) must agree:
    the widened 2-frame halo makes acceleration triples tile the
    sequence exactly once across chunk boundaries (a stale span is
    placed straddling a chunk boundary to prove it)."""
    stale = np.zeros((12, 2), np.float32)
    stale[3:6, 0] = 1.0                    # straddles the C=4 boundary
    stale[7:9, 1] = 1.0                    # straddles the C=8 boundary
    pa = _parts(_problem(chunk=4, stale=stale))
    pb = _parts(_problem(chunk=12, stale=stale))
    for k in E.LOG_KEYS:
        np.testing.assert_allclose(pa[k], pb[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def test_clean_input_identical_with_knob_on():
    """With NO stale frames the knob must be inert: same loss, same
    parts (the appended reg_gap_accel is exactly zero)."""
    clean = np.zeros((12, 2), np.float32)
    p_on = _problem(gap=True, stale=clean)
    p_off = _problem(gap=False, stale=clean)
    l_on, parts_on = jax.jit(
        lambda pa, d, a: E._cycle_loss(pa, p_on["model"], d, a,
                                       p_on["coefs"], p_on["cfg"]))(
        p_on["params"], p_on["data"], p_on["aux"])
    l_off, parts_off = jax.jit(
        lambda pa, d, a: E._cycle_loss(pa, p_off["model"], d, a,
                                       p_off["coefs"], p_off["cfg"]))(
        p_off["params"], p_off["data"], p_off["aux"])
    assert float(np.asarray(parts_on)[-1]) == 0.0
    np.testing.assert_allclose(float(l_on), float(l_off), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(parts_on)[:-1],
                               np.asarray(parts_off)[:-1], rtol=1e-6)


def test_gap_accel_fixed_point_is_interpolation():
    """The acceleration penalty's purpose: a gap trajectory that moves
    at the surrounding constant velocity (i.e. interpolates) is a
    stationary zero of the penalty, while a span FROZEN at the stale
    anchor (the reference's behavior) pays a large re-acquisition kink
    whose gradient pushes the gap frames toward the future endpoint —
    the fit interpolates instead of snapping."""
    T, N = 12, 1
    stale = np.zeros((T, N), np.float32)
    stale[4:7, 0] = 1.0

    # ONE problem + ONE compiled value_and_grad, evaluated at two
    # trajectories (fast-tier latency: the former per-call _problem +
    # re-jit paid the compile twice)
    p = _problem(T=T, N=N, stale=stale, chunk=4)
    coefs = {k: jnp.float32(0.0) for k in p["coefs"]}
    coefs["reg_gap_accel"] = jnp.float32(1.0)

    @jax.jit
    def val_grad(params):
        def loss_fn(params):
            l, _ = E._cycle_loss(params, p["model"], p["data"],
                                 p["aux"], coefs, p["cfg"])
            return l
        return jax.value_and_grad(loss_fn)(params)

    def accel_only(poses_T_x):
        pT = np.asarray(p["params"].poses_T).copy()
        pT[:T, 0, 0, 0] = poses_T_x
        params = p["params"]._replace(
            poses_T=jnp.asarray(pT),
            poses_smpl=jnp.zeros_like(p["params"].poses_smpl))
        l, g = val_grad(params)
        return float(l), np.asarray(g.poses_T)[:T, 0]

    # constant-velocity trajectory THROUGH the gap: zero acceleration
    # everywhere, so the penalty and its whole gradient vanish
    linear = (0.75 * np.arange(T)).astype(np.float32)
    l_lin, g_lin = accel_only(linear)
    np.testing.assert_allclose(l_lin, 0.0, atol=1e-6)
    assert np.abs(g_lin).max() < 1e-5

    # frozen-at-anchor then snap (x: 0,...,0, 3, 3, ...): two kink
    # triples at the re-acquisition, loss 3^2 + 3^2 = 18, and the last
    # gap frame (t=6) is pushed up toward the future endpoint
    frozen = np.concatenate([np.zeros(7), np.full(5, 3.0)]).astype(
        np.float32)
    l_frz, g_frz = accel_only(frozen)
    np.testing.assert_allclose(l_frz, 18.0, rtol=1e-5)
    assert g_frz[6, 0, 0] < -1e-3


def test_stale_frames_release_2d_data_term():
    """With the knob ON, stale frames' 2D keypoints (the repeated
    anchor ingestion fabricates, reference datautils.py:326-333) must
    not enter loss_pose: perturbing the 2D evidence on stale frames
    only leaves the loss untouched, while the same perturbation with
    the knob OFF moves it. Real evidence (depth/sil/ROMP terms) is
    NOT released — their parts are identical in both problems by
    construction here."""
    stale = np.zeros((12, 2), np.float32)
    stale[4:7, 1] = 1.0

    def wreck_stale(pose2d):
        pose2d[4:7, 1, :, :2] += 500.0   # anchor far outside the image

    base_on = _parts(_problem(stale=stale))
    wrecked_on = _parts(_problem(stale=stale, pose2d_mut=wreck_stale))
    np.testing.assert_allclose(wrecked_on["loss_pose24j"],
                               base_on["loss_pose24j"], rtol=1e-6)

    base_off = _parts(_problem(gap=False, stale=stale))
    wrecked_off = _parts(_problem(gap=False, stale=stale,
                                  pose2d_mut=wreck_stale))
    assert wrecked_off["loss_pose24j"] > 10.0 * base_off["loss_pose24j"]


def test_spmd_parity_with_stale_halo():
    """Sharded vs single-device with the knob ON: the stale mask must
    ride the widened 2-frame ppermute halo exchange — loss, parts and
    poses_T gradients agree across a mesh whose shard boundaries cut
    through the stale spans."""
    from mhmocap.parallel import spmd
    T = 16
    stale = np.zeros((T, 2), np.float32)
    stale[3:6, 0] = 1.0                    # cuts the 2-frame shards
    stale[9:14, 1] = 1.0
    p = _problem(T=T, chunk=2, stale=stale)
    mesh = spmd.make_mesh()

    def loss_1d(params):
        return E._cycle_loss(params, p["model"], p["data"], p["aux"],
                             p["coefs"], p["cfg"])

    (l1, parts1), g1 = jax.value_and_grad(
        lambda pa: loss_1d(pa), has_aux=True)(p["params"])

    params_s = spmd.shard_params(p["params"], mesh)
    data_s = spmd.shard_data(p["data"], mesh)
    aux_s = spmd.shard_aux(p["aux"], mesh)

    def loss_8d(params):
        return spmd.spmd_cycle_loss(params, p["model"], data_s, aux_s,
                                    p["coefs"], p["cfg"], mesh)

    (l8, parts8), g8 = jax.jit(jax.value_and_grad(
        lambda pa: loss_8d(pa), has_aux=True))(params_s)

    np.testing.assert_allclose(float(l8), float(l1), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(parts8), np.asarray(parts1),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g8.poses_T),
                               np.asarray(g1.poses_T),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g8.poses_smpl),
                               np.asarray(g1.poses_smpl),
                               rtol=2e-3, atol=1e-5)
