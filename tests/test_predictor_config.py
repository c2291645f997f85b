"""Predictor configuration regressions: SPMD engagement on default
configs, raster-window guard, scale-reg batch accounting, distorted
init solve."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.engine import optimizer as E
from mhmocap.engine.predictor import Predictor
from mhmocap.data.ingestion import SequenceArrays
from mhmocap.ops.cameras import intrinsics_from_fov, project_points


def _default_args(**over):
    """The default MuPoTs flags (configs/predict_mupots.yml)."""
    d = dict(
        num_iter=2, batch_size=10, save_visualizations=False,
        proj2d_loss_coef=1.0, depth_loss_coef=0.05,
        silhouette_loss_coef=0.1, reg_poses_coef=0.002,
        reg_scales_coef=1e-4, reg_velocity_coef=0.05,
        reg_verts_filter_coef=0.002, reg_contact_coef=0.001,
        reg_foot_sliding_coef=0.01, joint_confidence_thr=0.5,
        raster_window=128)
    d.update(over)
    return types.SimpleNamespace(**d)


def _tiny_seq(T=7, N=2, side=256, pose2d=None):
    K = intrinsics_from_fov((side, side), 60.0)
    if pose2d is None:
        pose2d = np.zeros((T, N, 17, 3), np.float32)
        pose2d[..., 0] = side / 2 + 10 * np.random.RandomState(0).randn(
            T, N, 17)
        pose2d[..., 1] = side / 2
        pose2d[..., 2] = 0.9
    seg = np.zeros((T, N, side, side), np.float32)
    return SequenceArrays(
        images=np.zeros((T, side, side, 3), np.uint8),
        depths=np.zeros((T, side, side), np.float32),
        instances=np.zeros((T, side, side), np.uint8),
        seg_mask=seg,
        backmasks=1.0 - seg.max(axis=1),
        pose2d=pose2d.astype(np.float32),
        cam_smpl=np.zeros((T, N, 3), np.float32),
        poses_smpl=np.zeros((T, N, 72), np.float32),
        betas_smpl=np.zeros((T, N, 10), np.float32),
        valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": K, "fov": 60.0, "Kd": None,
             "image_size": (side, side)},
    )


def test_spmd_engages_on_default_mupots_config(tiny_smpl, tmp_path):
    """The flagship config (batch_size=10) must shard on the 8-device
    mesh: round-1 silently fell back to one chip because padded_frames
    (multiple of 70) never divided 8*10."""
    p = Predictor(_tiny_seq(T=201, side=64), tiny_smpl, str(tmp_path),
                  _default_args())
    n_dev = jax.device_count()
    assert n_dev == 8
    assert p.use_spmd
    assert p.cfg.padded_frames % (n_dev * p.cfg.chunk) == 0
    # every device gets at least one whole chunk
    assert p.cfg.padded_frames // (n_dev * p.cfg.chunk) >= 1


def test_spmd_auto_chunk_minimizes_padding(tiny_smpl, tmp_path):
    """Round-3 verdict weak #1: the SPMD branch snapped chunk to a
    power of two with bucket 64, padding T=201 to 256 — 21.5% of the
    shard compute ran on padding frames (raster/SMPL execute on them;
    only the loss is masked). The tuner must pick chunk 26 / bucket
    208 at T=201 on 8 devices (3.4% padding), and stay <=5% padding
    across the MuPoTs sequence lengths."""
    p = Predictor(_tiny_seq(T=201, side=16), tiny_smpl, str(tmp_path),
                  _default_args())
    assert p.use_spmd
    assert p.cfg.chunk == 26
    assert p.cfg.frame_bucket == 208
    assert p.cfg.padded_frames == 208

    for T in (201, 250, 500, 1198, 2300):
        p = Predictor(_tiny_seq(T=T, side=16), tiny_smpl,
                      str(tmp_path), _default_args())
        waste = (p.cfg.padded_frames - T) / p.cfg.padded_frames
        assert waste <= 0.05, (T, p.cfg.chunk, p.cfg.padded_frames)


def test_tune_time_layout_properties():
    """Property sweep of the (chunk, bucket) tuner over every length
    up to a full MuPoTs-scale range, both mesh sizes, with and
    without user buckets: shard divisibility always holds, padding
    stays within the documented bounds, and a device-count-multiple
    user bucket is never inflated."""
    from mhmocap.engine.predictor import tune_time_layout

    def padded(T, chunk, bucket):
        step = int(np.lcm(chunk, bucket))
        return -(-T // step) * step

    for T in range(2, 3001):
        # single device, auto bucket
        c, b = tune_time_layout(T, 1)
        p = padded(T, c, b)
        assert p % c == 0 and b == c
        if T >= 32:
            assert 16 <= c <= 48
            assert (p - T) / p <= 0.04, (T, c, p)

        # 8-device mesh, auto bucket: the pick must be OPTIMAL (no
        # candidate chunk pads less) — this is what rules out the
        # 16-chunk floor that wasted 50% at T=64 (round-4 self-review)
        c, b = tune_time_layout(T, 8)
        p = -(-T // b) * b
        assert b == 8 * c and p % (8 * c) == 0
        best = min(-(-T // (8 * cc)) * 8 * cc for cc in range(2, 49))
        assert p == best, (T, c, p, best)
        if T >= 201:
            assert (p - T) / p <= 0.05, (T, c, p)

    import warnings as W
    for T in (60, 201, 500):
        # buckets expressible as 8 * chunk with chunk in [2, 48] (or a
        # multiple of one, like 200 = 8 * 5 * 5) are honored EXACTLY,
        # silently
        for bucket in (16, 64, 200):
            with W.catch_warnings():
                W.simplefilter("error", RuntimeWarning)
                c, b = tune_time_layout(T, 8, user_bucket=bucket)
            assert b == bucket, (T, bucket, c, b)
            assert b % (8 * c) == 0
            assert (-(-T // b) * b) % (8 * c) == 0
        # bucket 8 < 8 * min-chunk cannot be honored: inflates + warns
        with W.catch_warnings(record=True) as caught:
            W.simplefilter("always", RuntimeWarning)
            c, b = tune_time_layout(T, 8, user_bucket=8)
        assert b > 8 and b % (8 * c) == 0 and b % 8 == 0
        assert any(issubclass(w.category, RuntimeWarning)
                   for w in caught)


def test_spmd_user_bucket_honored_exactly_when_possible(tiny_smpl,
                                                        tmp_path):
    """A user frame_bucket that is a multiple of the device count must
    be honored EXACTLY (the tuner picks chunk = bucket/devices rather
    than inflating via the lcm), preserving the user's compile-cache
    granularity."""
    import warnings as W

    with W.catch_warnings():
        W.simplefilter("error", RuntimeWarning)
        p = Predictor(_tiny_seq(T=201, side=16), tiny_smpl,
                      str(tmp_path), _default_args(frame_bucket=64))
    assert p.cfg.frame_bucket == 64
    assert p.cfg.padded_frames == 256
    assert p.cfg.padded_frames % (8 * p.cfg.chunk) == 0


def test_spmd_engages_for_every_mupots_length(tiny_smpl, tmp_path):
    """MuPoTs TS sequence lengths range 201..2300 — all must shard."""
    # side=16 keeps the 2300-frame SequenceArrays tiny (~25 MB, not
    # ~350 MB) — only the config math is under test here
    for T in (201, 250, 500, 1198, 2300):
        p = Predictor(_tiny_seq(T=T, side=16), tiny_smpl, str(tmp_path),
                      _default_args())
        assert p.cfg.padded_frames % (
            jax.device_count() * p.cfg.chunk) == 0, T
        # padding overhead stays bounded (< one bucket)
        assert p.cfg.padded_frames - T < p.cfg.frame_bucket + p.cfg.chunk


@pytest.mark.slow
def test_predictor_fit_shards_over_mesh(tmp_path, capsys):
    """Predictor.run must actually engage the SPMD path on the
    8-device mesh (round-1 regression: it silently fell back to one
    chip) — the sharding banner prints and outputs are finite.

    Shapes deliberately match tests/test_spmd.py's fixture (32x32,
    N=2, T=16, chunk=2, window=16, V=256) so the sharded cycle
    program is a jit-cache hit within one suite run."""
    from mhmocap.models.synthetic import make_synthetic_smpl

    T, N, side = 16, 2, 32
    model = make_synthetic_smpl(num_vertices=256, seed=2)
    rng = np.random.RandomState(3)
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 1] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 2] = 0.9
    seq = _tiny_seq(T=T, N=N, side=side, pose2d=pose2d)
    seq.seg_mask[:, :, 8:24, 8:24] = 1.0
    args = _default_args(batch_size=2, frame_bucket=16, num_iter=4,
                         raster_window=16, bench_cycles=(1, 2, 3))
    p = Predictor(seq, model, str(tmp_path), args)
    assert p.use_spmd
    assert p.cfg.padded_frames == 16       # 8 devices x 1 chunk x 2
    assert p.cfg.window == 16
    out = p.run()
    # multi-window bench instrumentation (bench.py dispersion): one
    # timing per [b_i, b_{i+1}) window, summing to the full span
    assert len(p.bench_window_seconds) == 2
    assert all(w > 0 for w in p.bench_window_seconds)
    np.testing.assert_allclose(sum(p.bench_window_seconds),
                               p.bench_seconds, rtol=1e-6)
    captured = capsys.readouterr().out
    assert "sharding 16 frames over 8 devices" in captured
    ov = out["stage1_optvar"]
    assert np.isfinite(ov["poses_T"]).all()
    assert np.isfinite(ov["poses_smpl"]).all()
    # window audit fields persist in the artifact (round-2 weak #4:
    # the clip rate was print-only)
    import pickle
    with open(tmp_path / "optvar_stage1.pkl", "rb") as f:
        on_disk = pickle.load(f)
    assert on_disk["raster_window"] == 16
    assert 0.0 <= on_disk["window_clip_rate"] <= 1.0


def test_gap_aware_temporal_wiring(tiny_smpl, tmp_path):
    """The gap_aware_temporal knob engages only when requested AND the
    sequence carries a stale mask; the gap-accel coefficient defaults
    to the velocity coefficient and honors an explicit override."""
    seq = _tiny_seq()
    p = Predictor(seq, tiny_smpl, str(tmp_path), _default_args())
    assert p.cfg.gap_aware_temporal is False      # parity default

    # knob on, but no stale mask on the sequence -> stays off
    args_on = _default_args(gap_aware_temporal=True)
    p = Predictor(seq, tiny_smpl, str(tmp_path), args_on)
    assert p.cfg.gap_aware_temporal is False
    assert p.coefs["reg_gap_accel"] == args_on.reg_velocity_coef

    # knob on with a stale mask -> engaged, halo widens to 2
    import dataclasses
    lag = np.zeros((seq.pose2d.shape[0], seq.num_people), bool)
    lag[3:5, 0] = True
    seq2 = dataclasses.replace(seq, lagged_tn=lag)
    p = Predictor(seq2, tiny_smpl, str(tmp_path), args_on)
    assert p.cfg.gap_aware_temporal is True
    assert p.cfg.halo == 2

    # explicit coefficient override (including zero)
    p = Predictor(seq2, tiny_smpl, str(tmp_path),
                  _default_args(gap_aware_temporal=True,
                                reg_gap_accel_coef=0.0))
    assert p.coefs["reg_gap_accel"] == 0.0


@pytest.mark.slow
def test_predictor_fit_gap_aware_spmd(tmp_path, capsys):
    """Full Predictor.run on the 8-device mesh with gap_aware_temporal
    engaged: the stale mask shards over the time axis, the 2-frame
    halo cycle compiles and executes, and outputs stay finite."""
    import dataclasses
    from mhmocap.models.synthetic import make_synthetic_smpl

    T, N, side = 16, 2, 32
    model = make_synthetic_smpl(num_vertices=256, seed=2)
    rng = np.random.RandomState(3)
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 1] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 2] = 0.9
    seq = _tiny_seq(T=T, N=N, side=side, pose2d=pose2d)
    seq.seg_mask[:, :, 8:24, 8:24] = 1.0
    lag = np.zeros((T, N), bool)
    lag[5:9, 0] = True                   # straddles 2-frame shards
    seq = dataclasses.replace(seq, lagged_tn=lag)
    args = _default_args(batch_size=2, frame_bucket=16, num_iter=3,
                         raster_window=16, gap_aware_temporal=True)
    p = Predictor(seq, model, str(tmp_path), args)
    assert p.use_spmd and p.cfg.gap_aware_temporal
    out = p.run()
    assert "sharding 16 frames over 8" in capsys.readouterr().out
    ov = out["stage1_optvar"]
    assert np.isfinite(ov["poses_T"]).all()
    assert np.isfinite(ov["poses_smpl"]).all()
    # the gap-accel part was computed and logged finite
    assert all(np.isfinite(row["reg_gap_accel"])
               for row in out["stage1_log"])
    # the stale mask rides into the artifact for downstream analysis
    # (script/decompose_jitter.py)
    np.testing.assert_array_equal(ov["lagged_tn"], lag)


def test_window_guard_grows_for_large_person(tiny_smpl, tmp_path):
    """A person taller than the requested window must grow the window
    instead of silently clipping supervision (reference rasterizes the
    full image, optimizer.py:211-232)."""
    T, N, side = 5, 1, 256
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = np.linspace(40, 220, 17)[None, None]  # 180px wide
    pose2d[..., 1] = np.linspace(20, 230, 17)[None, None]  # 210px tall
    pose2d[..., 2] = 0.9
    p = Predictor(_tiny_seq(T=T, N=N, pose2d=pose2d), tiny_smpl,
                  str(tmp_path), _default_args(raster_window=64))
    assert p.cfg.window >= 216            # 1.3 * 210 rounded down to cap
    assert p.cfg.window % 8 == 0
    assert p.window_clip_rate <= 1.0


def test_window_guard_records_clip_rate(tiny_smpl, tmp_path):
    """When the image caps the window below the person size, the clip
    rate must be visible."""
    T, N, side = 5, 1, 64
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = np.linspace(2, 62, 17)[None, None]
    pose2d[..., 1] = np.linspace(2, 62, 17)[None, None]
    pose2d[..., 2] = 0.9
    p = Predictor(_tiny_seq(T=T, N=N, side=side, pose2d=pose2d),
                  tiny_smpl, str(tmp_path),
                  _default_args(raster_window=64))
    assert p.cfg.window == 64             # capped at the image
    assert p.window_clip_rate == 1.0      # 1.3 * 60 > 64 everywhere
    # the per-person guard must record AND warn about the same clip
    assert p.window_clip_rates == (1.0,)
    assert p.cfg.windows == (64,)         # capped, multiple of 8


def test_per_person_window_clip_warns(tiny_smpl, tmp_path, capsys):
    """A person whose bbox tail exceeds their per-person window must
    trigger the same WARNING the shared guard prints (review finding:
    silent per-person supervision clipping)."""
    T, N, side = 10, 2, 256
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    # person 0: 40 px in most frames, 200 px in one tail frame
    pose2d[:, 0, :, 0] = np.linspace(100, 140, 17)[None]
    pose2d[-1, 0, :, 0] = np.linspace(20, 220, 17)
    pose2d[:, 0, :, 1] = 120
    # person 1: steady 60 px
    pose2d[:, 1, :, 0] = np.linspace(100, 160, 17)[None]
    pose2d[:, 1, :, 1] = 140
    pose2d[..., 2] = 0.9
    p = Predictor(_tiny_seq(T=T, N=N, pose2d=pose2d), tiny_smpl,
                  str(tmp_path), _default_args(raster_window=64))
    out = capsys.readouterr().out
    assert p.window_clip_rates[0] > 0.0   # tail frame clipped
    assert "person 0" in out and "WARNING" in out
    # the no-detection fallback stays a multiple of 8 even for odd
    # raster_window values
    pose2d[:, 1, :, 2] = 0.0              # person 1: nothing confident
    p2 = Predictor(_tiny_seq(T=T, N=N, pose2d=pose2d), tiny_smpl,
                   str(tmp_path), _default_args(raster_window=100))
    assert p2.cfg.windows[1] % 8 == 0


def test_scale_reg_batch_count_is_ceil():
    """Reference adds the scale term once per DataLoader batch, i.e.
    ceil(T / batch_size) times per epoch (optimizer.py:531-539)."""
    cfg = E.EngineConfig(image_size=(32, 32), num_people=2,
                         num_frames=15, chunk=4, frame_bucket=4)
    params = E.StageParams(
        poses_T=jnp.zeros((16, 2, 1, 3)),
        poses_smpl=jnp.zeros((16, 2, 72)),
        betas=jnp.zeros((1, 2, 10)),
        zmin_lin=jnp.zeros((16, 1, 1)),
        zmax_lin=jnp.zeros((16, 1, 1)),
        xscale=jnp.full((1, 2, 1, 1), 2.0))
    coefs = E.default_coefs()
    loss, logged = E._scale_reg(params, coefs, cfg)
    s = 1.1 ** 2.0
    per_batch = (coefs["reg_scales"] * np.mean((s - 1) ** 2)
                 + (2 * (s - 1)) ** 2)
    np.testing.assert_allclose(float(loss), 2 * per_batch, rtol=1e-5)


def test_init_solve_uses_camera_distortion(tiny_smpl):
    """init_global_poses must project with Kd (reference passes
    cam_dist_coef in __init_global_poses, optimizer.py:752): with a
    strongly distorted camera the distortion-aware solve recovers the
    true translation, the naive one does not."""
    from mhmocap.models.smpl import smpl_forward

    T, N, side = 4, 1, 256
    K = jnp.asarray(intrinsics_from_fov((side, side), 60.0))
    kd = jnp.asarray([-0.4, 0.2, 0.0, 0.0, 0.0], jnp.float32)

    model = tiny_smpl
    poses = jnp.zeros((T * N, 72))
    betas = jnp.zeros((T * N, 10))
    out = smpl_forward(model, betas, poses)
    joints = out["joints_alphapose"].reshape(T, N, 17, 3)
    true_T = jnp.asarray(
        np.tile([[[0.8, 0.1, 3.0]]], (T, N, 1))[:, :, None])
    gt_uv = project_points(joints + true_T, K, dist_coef=kd)
    pose2d = jnp.concatenate(
        [gt_uv, 0.9 * jnp.ones((T, N, 17, 1))], -1)

    sol, _ = E.init_global_poses(
        model, pose2d, jnp.zeros((T, N, 72)), jnp.zeros((T, N, 10)),
        K, jnp.zeros((1, N, 1, 1)), dist_coef=kd,
        reg_velocity_coef=0.0, num_iter=150)
    err = float(jnp.max(jnp.abs(sol - true_T)))
    assert err < 0.05, err

    sol_naive, _ = E.init_global_poses(
        model, pose2d, jnp.zeros((T, N, 72)), jnp.zeros((T, N, 10)),
        K, jnp.zeros((1, N, 1, 1)), dist_coef=None,
        reg_velocity_coef=0.0, num_iter=150)
    err_naive = float(jnp.max(jnp.abs(sol_naive - true_T)))
    assert err_naive > 2 * err, (err, err_naive)


@pytest.mark.slow
def test_checkpoint_resume_mid_stage(tmp_path, capsys):
    """Orbax checkpoint/resume (beyond the reference, survey §5): a
    second Predictor pointed at the same output_path must resume from
    the latest checkpoint and only run the remaining cycles."""
    from mhmocap.models.synthetic import make_synthetic_smpl

    T, N, side = 16, 2, 32
    model = make_synthetic_smpl(num_vertices=256, seed=2)
    rng = np.random.RandomState(3)
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 1] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 2] = 0.9
    seq = _tiny_seq(T=T, N=N, side=side, pose2d=pose2d)
    seq.seg_mask[:, :, 8:24, 8:24] = 1.0

    def make(num_iter):
        args = _default_args(batch_size=2, frame_bucket=16,
                             num_iter=num_iter, raster_window=16,
                             spmd=False, checkpoint_every=1)
        return Predictor(seq, model, str(tmp_path), args)

    out1 = make(2).run()
    assert len(out1["stage1_log"]) == 2
    capsys.readouterr()

    out2 = make(4).run()
    printed = capsys.readouterr().out
    assert "resumed from checkpoint at cycle 1" in printed
    assert len(out2["stage1_log"]) == 2        # cycles 2 and 3 only
    pt = out2["stage1_optvar"]["poses_T"]
    assert np.isfinite(np.asarray(pt)).all()


@pytest.mark.slow
@pytest.mark.isolated
def test_checkpoint_resume_under_spmd(tmp_path, capsys):
    """Checkpoint/resume on the 8-device time mesh (round-4 verdict
    weak #3): the orbax restore runs AFTER params/opt_state are
    sharded (Predictor.fit), so the restored arrays must come back
    with the SAME NamedSharding layouts — a resume that silently
    de-shards or mismatches layouts would surface as a preemption
    failure on the pod, not in CI. A resumed run must also match an
    uninterrupted run's final parameters."""
    from mhmocap.models.synthetic import make_synthetic_smpl

    T, N, side = 16, 2, 32
    model = make_synthetic_smpl(num_vertices=256, seed=2)
    rng = np.random.RandomState(3)
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 0] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 1] = side / 2 + 1.5 * rng.randn(T, N, 17)
    pose2d[..., 2] = 0.9
    seq = _tiny_seq(T=T, N=N, side=side, pose2d=pose2d)
    seq.seg_mask[:, :, 8:24, 8:24] = 1.0

    def make(num_iter, outdir):
        args = _default_args(batch_size=2, frame_bucket=16,
                             num_iter=num_iter, raster_window=16,
                             checkpoint_every=1)
        return Predictor(seq, model, str(outdir), args)

    # uninterrupted 4-cycle run on the mesh
    p_full = make(4, tmp_path / "full")
    assert p_full.use_spmd
    out_full = p_full.run()
    assert len(out_full["stage1_log"]) == 4
    def _fields(params):
        return params._asdict()      # StageParams is a NamedTuple
    sharded_kinds = {
        k: v.sharding for k, v in _fields(p_full._params).items()
        if hasattr(v, "sharding")}
    assert sharded_kinds, "no sharded params captured"
    capsys.readouterr()

    # interrupted at cycle 2, then resumed to 4
    out1 = make(2, tmp_path / "resumed").run()
    assert len(out1["stage1_log"]) == 2
    capsys.readouterr()
    p_res = make(4, tmp_path / "resumed")
    out2 = p_res.run()
    printed = capsys.readouterr().out
    assert "resumed from checkpoint at cycle 1" in printed
    assert "fit: sharding" in printed
    assert len(out2["stage1_log"]) == 2       # cycles 2 and 3 only

    # layouts: every sharded param of the resumed run must carry the
    # exact sharding the uninterrupted run computed with
    for k, v in _fields(p_res._params).items():
        if k in sharded_kinds:
            assert v.sharding.is_equivalent_to(
                sharded_kinds[k], v.ndim), (k, v.sharding)

    # values: resume == uninterrupted (orbax f32 roundtrip is exact;
    # the cycles after restore replay the same deterministic program)
    for k in ("poses_T", "poses_smpl", "betas_smpl"):
        np.testing.assert_allclose(
            np.asarray(out2["stage1_optvar"][k]),
            np.asarray(out_full["stage1_optvar"][k]),
            rtol=1e-5, atol=1e-6, err_msg=k)


def test_joint_weight_knobs_plumb_through(tiny_smpl, tmp_path):
    """Reference pose17j/pose24j_weights knobs (optimizer.py:77-130):
    17j reaches the engine config (raw; engine normalizes at use),
    24j is accepted and stored but never applied — exactly like the
    reference, which normalizes both but only uses pose17j (:259)."""
    w17 = [float(i) for i in range(1, 18)]
    p = Predictor(_tiny_seq(), tiny_smpl, str(tmp_path),
                  _default_args(pose17j_weights=w17,
                                pose24j_weights=[1.0] * 24))
    assert p.cfg.pose17j_weights == tuple(w17)
    assert p.pose24j_weights == tuple([1.0] * 24)
    # default: no weighting configured
    p2 = Predictor(_tiny_seq(), tiny_smpl, str(tmp_path),
                   _default_args())
    assert p2.cfg.pose17j_weights is None


def test_single_device_auto_chunk(tiny_smpl, tmp_path):
    """Without SPMD and without a user frame_bucket, the Predictor
    tunes the scan chunk for the cycle cadence: the chunk in [16, 48]
    minimizing padded length, fewer steps on ties (TS1 scale T=201 ->
    7 steps of 29 at padded 203)."""
    seq = _tiny_seq(T=201)
    p = Predictor(seq, tiny_smpl, str(tmp_path),
                  _default_args(spmd=False))
    assert p.cfg.chunk == 29
    assert p.cfg.padded_frames == 203
    assert p.cfg.num_chunks == 7
    # an explicit user frame_bucket still wins (chunk then follows
    # the reference's batch_size as before)
    p2 = Predictor(seq, tiny_smpl, str(tmp_path),
                   _default_args(spmd=False, frame_bucket=64))
    assert p2.cfg.frame_bucket == 64
    assert p2.cfg.chunk == 10
    # scale-reg accounting follows the reference batch size in both
    assert p.cfg.batch_size_ref == p2.cfg.batch_size_ref == 10


def test_frame_bucket_lcm_inflation_warns(tiny_smpl, tmp_path):
    """A user frame_bucket that is coprime-ish with devices*chunk
    silently inflated padding via the lcm (e.g. 100 -> 1600 with
    8 devices x chunk 8); that must warn."""
    import warnings as W

    import pytest

    with pytest.warns(RuntimeWarning, match="inflated"):
        Predictor(_tiny_seq(T=201, side=16), tiny_smpl, str(tmp_path),
                  _default_args(frame_bucket=100))

    # a well-aligned bucket stays silent
    with W.catch_warnings():
        W.simplefilter("error", RuntimeWarning)
        p = Predictor(_tiny_seq(T=201, side=16), tiny_smpl,
                      str(tmp_path), _default_args(frame_bucket=128))
    assert p.cfg.frame_bucket == 128
