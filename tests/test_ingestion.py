"""End-to-end ingestion tests on a generated synthetic sequence tree
(exact reference on-disk formats)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from mhmocap.data.synthetic import generate_sequence
from mhmocap.data.ingestion import load_sequence, split_instance_masks
from mhmocap.data import alphapose as AP
from mhmocap.models.smpl import smpl_forward


@pytest.fixture(scope="module")
def seq_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    gt = generate_sequence(root, num_frames=6, num_people=2,
                           image_size=(128, 128), num_vertices=512,
                           mupots_gt=True, seed=3)
    return root, gt


def _joints_fn(model):
    def fn(betas, poses):
        out = smpl_forward(model, jnp.asarray(betas), jnp.asarray(poses))
        return np.asarray(out["joints_alphapose"])
    return fn


def test_load_sequence_shapes_and_alignment(seq_tree):
    root, gt = seq_tree
    seq = load_sequence(root, _joints_fn(gt["model"]),
                        cam_K=gt["cam_K"], resize_factor=1.0,
                        post_process_depth=False,
                        renormalize_depth=False)
    T, N = 6, 2
    W, H = gt["image_size"]
    assert seq.num_frames == T and seq.num_people == N
    assert seq.images.shape == (T, H, W, 3)
    assert seq.depths.shape == (T, H, W)
    assert seq.seg_mask.shape == (T, N, H, W)
    assert seq.pose2d.shape == (T, N, 17, 3)
    assert seq.poses_smpl.shape == (T, N, 72)
    assert seq.betas_smpl.shape == (T, N, 10)
    assert seq.valid_smpl.shape == (T, N, 1)
    assert (seq.valid_smpl > 0.7).all()

    # the recovered SMPL poses must be the (noisy) GT ones, assigned to
    # the right tracked person
    err = np.abs(seq.poses_smpl - gt["poses_smpl"]).mean()
    assert err < 0.05, err

    # instance masks must be relabeled to match pose index: the mask of
    # person n should contain its own 2D joints far more than the other
    for t in range(T):
        for n in range(N):
            vis = seq.pose2d[t, n, :, 2] > 0.5
            xs = np.clip(seq.pose2d[t, n, vis, 0].round().astype(int),
                         0, W - 1)
            ys = np.clip(seq.pose2d[t, n, vis, 1].round().astype(int),
                         0, H - 1)
            own = seq.seg_mask[t, n, ys, xs].sum()
            other = seq.seg_mask[t, 1 - n, ys, xs].sum()
            assert own >= other

    # depth maps: normalized disparity in [0, 1]
    assert seq.depths.min() >= 0 and seq.depths.max() <= 1.0 + 1e-5

    # camera: resize_factor 1 keeps K
    np.testing.assert_allclose(seq.cam["K"], gt["cam_K"], atol=1e-4)


def test_pose2d_matches_projected_gt(seq_tree):
    root, gt = seq_tree
    seq = load_sequence(root, _joints_fn(gt["model"]),
                        cam_K=gt["cam_K"], resize_factor=1.0,
                        post_process_depth=False,
                        renormalize_depth=False)
    from mhmocap.ops.cameras import project_points
    out = smpl_forward(
        gt["model"],
        jnp.asarray(np.tile(gt["betas"], (6, 1, 1)).reshape(-1, 10)),
        jnp.asarray(gt["poses_smpl"].reshape(-1, 72)))
    j3d = np.asarray(out["joints_alphapose"]).reshape(6, 2, 17, 3) \
        + gt["poses_T"]
    uv = np.asarray(project_points(jnp.asarray(j3d),
                                   jnp.asarray(gt["cam_K"])))
    vis = seq.pose2d[..., 2] > 0.5
    err = np.abs(seq.pose2d[..., :2] - uv)[vis].mean()
    assert err < 1.0, err  # sub-pixel: tracks come from the same GT


def test_track_reconciliation_with_dropout(tmp_path):
    """With detection dropout the tracker must still produce a dense
    (T, N, 17, 3) array without swapping people."""
    root = str(tmp_path / "drop")
    gt = generate_sequence(root, num_frames=10, num_people=2,
                           image_size=(128, 128), num_vertices=512,
                           seed=5, track_dropout=0.25)
    annot = AP.load_tracking_results(
        os.path.join(root, "AlphaPose", "alphapose-results.json"),
        coef_thr=0.5)
    pose2d = AP.tracks_to_array(annot, max_num_people=2)
    assert pose2d.shape[1:] == (2, 17, 3)
    # every frame with a detection keeps consistent slots: x positions
    # of the two people must not cross (they are ~60 px apart)
    filled = pose2d[..., 2].max(axis=-1) > 0
    for t in range(len(pose2d)):
        if filled[t].all():
            assert (pose2d[t, 0, :, 0].mean()
                    < pose2d[t, 1, :, 0].mean())


def test_tracks_to_array_zero_detection_frames():
    """A frame with ZERO surviving detections (total detector dropout)
    must become a zero-confidence row at its correct position when
    `image_names` anchors the time axis — the reference's
    present-frames-only axis shifts the tail and then indexes out of
    bounds on this input (deliberate robustness deviation,
    alphapose.py docstring)."""
    names = [f"img_{t:06d}.jpg" for t in range(6)]
    pose = np.zeros((17, 3), np.float32)
    pose[:, 0] = 40.0
    pose[:, 1] = np.arange(17) * 3.0
    pose[:, 2] = 0.9
    # frames 2 and 5 (the LAST) have no detections at all
    annot = {names[t]: {1: pose + t} for t in (0, 1, 3, 4)}

    out = AP.tracks_to_array(annot, frame_ids=list(range(6)),
                             image_names=names)
    assert out.shape == (6, 1, 17, 3)
    for t in (0, 1, 3, 4):
        np.testing.assert_array_equal(out[t, 0], pose + t)  # aligned
    assert (out[2] == 0).all() and (out[5] == 0).all()

    # gap-free inputs are bit-identical with and without image_names
    annot_full = {names[t]: {1: pose + t} for t in range(6)}
    a = AP.tracks_to_array(annot_full, frame_ids=list(range(6)),
                           image_names=names)
    b = AP.tracks_to_array(annot_full, frame_ids=list(range(6)))
    np.testing.assert_array_equal(a, b)

    # unknown id scheme: fall back to the positional axis
    annot_png = {k.replace(".jpg", ".png"): v
                 for k, v in annot_full.items()}
    c = AP.tracks_to_array(annot_png, frame_ids=list(range(6)),
                           image_names=names)
    np.testing.assert_array_equal(c, b)

    # PARTIAL mismatch: re-anchoring proceeds but warns that the
    # unmatched frames' detections are dropped
    import warnings as W
    annot_mixed = dict(annot_full)
    annot_mixed["img_000001.png"] = annot_mixed.pop(names[1])
    with W.catch_warnings(record=True) as caught:
        W.simplefilter("always", RuntimeWarning)
        d = AP.tracks_to_array(annot_mixed, frame_ids=list(range(6)),
                               image_names=names)
    assert any("DROPPED" in str(w.message) for w in caught)
    assert (d[1] == 0).all()                     # unmatched frame
    np.testing.assert_array_equal(d[0], b[0])    # matched frames kept


def _walking_pose(x, y=20.0):
    pose = np.zeros((17, 3), np.float32)
    pose[:, 0] = x
    pose[:, 1] = y + np.arange(17) * 3.0
    pose[:, 2] = 0.9
    return pose


def test_id_swap_fix_corrects_sustained_switch():
    """A sustained tracker identity switch rides straight through the
    reference's known-id fast path (alphapose.py:119-262 has no gate on
    already-mapped ids) — pinned here — while the opt-in `id_swap_fix`
    ratio test re-routes each detection to the positionally consistent
    slot and remaps the ids once per transition."""
    T = 10
    names = [f"img_{t:06d}.jpg" for t in range(T)]
    # person A walks at x=30+t, person B at x=100+t (far apart)
    annot = {}
    for t in range(T):
        a, b = _walking_pose(30.0 + t), _walking_pose(100.0 + t)
        if 3 <= t < 6:           # ids swapped inside the span
            annot[names[t]] = {1: b, 2: a}
        else:
            annot[names[t]] = {1: a, 2: b}

    # reference parity (off): the swap passes through — slot 0 carries
    # person B's x~100 evidence mid-span
    off = AP.tracks_to_array(annot, max_num_people=2)
    assert off[4, 0, 0, 0] > 90 and off[4, 1, 0, 0] < 40

    # knob on: every frame keeps the positionally consistent person
    on = AP.tracks_to_array(annot, max_num_people=2, id_swap_fix=0.5)
    for t in range(T):
        np.testing.assert_allclose(on[t, 0, :, 0], 30.0 + t)
        np.testing.assert_allclose(on[t, 1, :, 0], 100.0 + t)


def test_id_swap_fix_handles_dropout_coincident_switch():
    """The pattern that actually dominates the degraded tree: the
    identity switch lands on the SAME frame as a detection dropout, so
    it presents as ONE mis-id'd detection (no permutation to find) —
    its true home is the other person's now-empty slot. Without the
    fix the surviving slot jumps to the wrong person AND the displaced
    slot goes dark for the whole span (the velocity gate rejects the
    far-away re-acquisition)."""
    T = 10
    names = [f"img_{t:06d}.jpg" for t in range(T)]
    annot = {}
    for t in range(T):
        a, b = _walking_pose(30.0 + t), _walking_pose(100.0 + t)
        if t == 3:
            annot[names[t]] = {2: a}          # switch-in + B dropout
        elif 3 < t < 6:
            annot[names[t]] = {1: b, 2: a}    # swapped span
        else:
            annot[names[t]] = {1: a, 2: b}

    # reference parity: slot 1 jumps onto person A at t=3 and carries
    # them through the span; slot 0 goes dark
    off = AP.tracks_to_array(annot, max_num_people=2)
    assert off[4, 1, 0, 0] < 40 and (off[4, 0, :, 2] == 0).all()

    # knob on: the mis-id'd detection is re-routed to the empty slot,
    # and the vacated slot re-acquires person B through the normal
    # velocity gate one frame later
    on = AP.tracks_to_array(annot, max_num_people=2, id_swap_fix=0.5)
    for t in range(T):
        np.testing.assert_allclose(on[t, 0, :, 0], 30.0 + t)
        if t != 3:
            np.testing.assert_allclose(on[t, 1, :, 0], 100.0 + t)
    assert (on[3, 1, :, 2] == 0).all()        # the dropped detection


def test_id_swap_fix_does_not_flap_on_crossing():
    """Correct ids through a genuine crossing: distances are near-tie
    around the crossing frame, so the ratio margin must reject every
    permutation and the output must be bit-identical to the off
    path."""
    T = 13
    names = [f"img_{t:06d}.jpg" for t in range(T)]
    annot = {names[t]: {1: _walking_pose(30.0 + 5 * t),
                        2: _walking_pose(90.0 - 5 * t)}
             for t in range(T)}
    off = AP.tracks_to_array(annot, max_num_people=2)
    on = AP.tracks_to_array(annot, max_num_people=2, id_swap_fix=0.5)
    np.testing.assert_array_equal(on, off)
    # and the slots really did cross in image space (ids honored)
    assert off[0, 0, 0, 0] < off[0, 1, 0, 0]
    assert off[T - 1, 0, 0, 0] > off[T - 1, 1, 0, 0]


def test_split_instance_masks_golden():
    inst = np.zeros((1, 4, 4), np.uint8)
    inst[0, 0, 0] = 1
    inst[0, 1, 1] = 2
    masks = split_instance_masks(inst, num_classes=3)
    assert masks.shape == (1, 3, 4, 4)
    assert masks[0, 0, 0, 0] == 1 and masks[0, 0].sum() == 1
    assert masks[0, 1, 1, 1] == 1 and masks[0, 1].sum() == 1
    assert masks[0, 2].sum() == 0


def test_smpl_imputation_fills_missing(seq_tree):
    """Frames with no ROMP detection for a person inherit the nearest
    valid frame's parameters with valid=0.51."""
    root, gt = seq_tree
    from mhmocap.data.ingestion import assign_smpl_to_poses
    T, N = 4, 2
    preds = []
    rng = np.random.RandomState(0)
    for t in range(T):
        # frame 2 misses the second person entirely
        count = 1 if t == 2 else N
        preds.append({
            "cam": np.tile(np.array([[1.0, 0, 0]], np.float32),
                           (count, 1)),
            "poses": rng.randn(count, 72).astype(np.float32) * 0.1,
            "betas": np.zeros((count, 10), np.float32),
        })
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 2] = 0.9
    pose2d[..., 0] = np.linspace(30, 90, N)[None, :, None]
    pose2d[..., 1] = 60

    out, _, _ = assign_smpl_to_poses(preds, pose2d, (128, 128),
                                     _joints_fn(gt["model"]))
    valids = np.stack([out[t]["valid"][:, 0] for t in range(T)])
    assert (valids[2] >= 0.5).all()
    assert (valids != 0).all()


def test_smpl_assignment_with_extra_detections(seq_tree):
    """A frame carrying MORE SMPL/ROMP detections than tracked people
    must not crash; the Hungarian match keeps the best N (reference
    trims via smpl[key][order], datautils.py:247-361). Regression for
    the batched-projection refactor, which assumed every frame had at
    most N bodies."""
    root, gt = seq_tree
    from mhmocap.data.ingestion import assign_smpl_to_poses
    T, N = 4, 2
    rng = np.random.RandomState(1)
    preds = []
    for t in range(T):
        count = 4 if t == 1 else N      # frame 1: two spurious bodies
        preds.append({
            "cam": np.tile(np.array([[1.0, 0, 0]], np.float32),
                           (count, 1)),
            "poses": rng.randn(count, 72).astype(np.float32) * 0.1,
            "betas": np.zeros((count, 10), np.float32),
        })
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 2] = 0.9
    pose2d[..., 0] = np.linspace(30, 90, N)[None, :, None]
    pose2d[..., 1] = 60

    out, _, _ = assign_smpl_to_poses(preds, pose2d, (128, 128),
                                     _joints_fn(gt["model"]))
    for t in range(T):
        assert out[t]["poses"].shape == (N, 72), t
        assert out[t]["valid"].shape == (N, 1), t
    valids = np.stack([out[t]["valid"][:, 0] for t in range(T)])
    assert (valids > 0).all()


def test_lagged_tn_marks_unrefreshed_dropout_frames(seq_tree):
    """assign_smpl_to_poses's lagged_tn must flag exactly the frames
    whose 2D pose is a stale lagged copy with no current-frame SMPL
    refresh (here: ROMP is ALSO empty on the dropout frames, so no
    refresh can happen)."""
    root, gt = seq_tree
    from mhmocap.data.ingestion import assign_smpl_to_poses
    T, N = 6, 2
    rng = np.random.RandomState(2)
    preds = []
    for t in range(T):
        count = 0 if t in (2, 3) else N   # total ROMP dropout on 2-3
        preds.append({
            "cam": np.tile(np.array([[1.0, 0, 0]], np.float32),
                           (count, 1)),
            "poses": rng.randn(count, 72).astype(np.float32) * 0.1,
            "betas": np.zeros((count, 10), np.float32),
        })
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 2] = 0.9
    pose2d[..., 0] = np.linspace(30, 90, N)[None, :, None]
    pose2d[..., 1] = 60
    pose2d[2:4, 1, :, 2] = 0.0            # person 1's track drops out

    _, out2d, lagged = assign_smpl_to_poses(
        preds, pose2d, (128, 128), _joints_fn(gt["model"]))
    assert lagged.shape == (T, N) and lagged.dtype == bool
    expect = np.zeros((T, N), bool)
    expect[2:4, 1] = True
    np.testing.assert_array_equal(lagged, expect)
    # the lagged copies carry the clipped 0.502 anchor confidence
    assert np.allclose(out2d[2:4, 1, :, 2], 0.502)


def test_lagged_tn_flags_evidence_free_frame_zero(seq_tree):
    """A person absent at the START of the sequence must be stale from
    frame 0 (round-4 advisor): frame 0 has no previous pose to copy
    (reference parity keeps it zero-confidence, datautils.py:305), but
    treating it as OBSERVED made gapfill interpolate not-yet-entered
    spans from frame 0's unconstrained fitted pose instead of holding
    the entry pose."""
    root, gt = seq_tree
    from mhmocap.data.ingestion import assign_smpl_to_poses
    T, N = 5, 2
    rng = np.random.RandomState(3)
    preds = [{
        "cam": np.tile(np.array([[1.0, 0, 0]], np.float32), (N, 1)),
        "poses": rng.randn(N, 72).astype(np.float32) * 0.1,
        "betas": np.zeros((N, 10), np.float32),
    } for _ in range(T)]
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 2] = 0.9
    pose2d[..., 0] = np.linspace(30, 90, N)[None, :, None]
    pose2d[..., 1] = 60
    pose2d[:3, 1, :, 2] = 0.0            # person 1 enters at t=3

    _, out2d, lagged = assign_smpl_to_poses(
        preds, pose2d, (128, 128), _joints_fn(gt["model"]))
    expect = np.zeros((T, N), bool)
    expect[:3, 1] = True                 # INCLUDING frame 0
    np.testing.assert_array_equal(lagged, expect)
    # frame 0's pose content is reference-parity untouched (all-zero
    # confidence, no lagged copy exists to impute)
    assert np.all(out2d[0, 1, :, 2] == 0.0)


def test_decay_lagged_confidences_runs_and_resets():
    """decay**k per consecutive stale frame, reset on real evidence;
    non-lagged frames and decay=1.0 are untouched."""
    from mhmocap.data.ingestion import decay_lagged_confidences
    T, N = 7, 2
    pose2d = np.zeros((T, N, 17, 3), np.float32)
    pose2d[..., 2] = 0.502
    lagged = np.zeros((T, N), bool)
    lagged[1:4, 0] = True     # 3-frame run for person 0
    lagged[5, 0] = True       # second run restarts at k=1
    lagged[2, 1] = True       # single frame for person 1

    out = decay_lagged_confidences(pose2d, lagged, 0.8)
    assert out is not pose2d and np.allclose(pose2d[..., 2], 0.502)
    g = 0.502
    np.testing.assert_allclose(
        out[:, 0, 0, 2],
        [g, g * 0.8, g * 0.8 ** 2, g * 0.8 ** 3, g, g * 0.8, g],
        rtol=1e-6)
    np.testing.assert_allclose(
        out[:, 1, 0, 2], [g, g, g * 0.8, g, g, g, g], rtol=1e-6)
    # x/y channels untouched
    np.testing.assert_array_equal(out[..., :2], pose2d[..., :2])
    # identity at decay=1.0
    np.testing.assert_array_equal(
        decay_lagged_confidences(pose2d, lagged, 1.0)[..., 2],
        pose2d[..., 2])


def test_id_swap_fix_identity_on_random_clean_tracks():
    """Property guard for the step-1 rewrite: on randomized scenes with
    honest track ids (random walks, staggered entries, NO switches, NO
    dropout) the correction must never fire — `id_swap_fix=0.5` output
    is bit-identical to the reference-parity path for every seed."""
    rng = np.random.RandomState(7)
    for trial in range(20):
        T = int(rng.randint(6, 20))
        N = int(rng.randint(1, 4))
        # well-separated starting columns, small random walks
        base_x = 60.0 + 120.0 * np.arange(N)
        enter = rng.randint(0, 3, size=N)  # staggered entries
        annot = {}
        walks = [base_x[n] + np.cumsum(rng.randn(T) * 2.0)
                 for n in range(N)]
        for t in range(T):
            frame = {}
            for n in range(N):
                if t >= enter[n]:
                    frame[n + 1] = _walking_pose(
                        float(walks[n][t]), y=20.0 + rng.rand() * 4)
            if frame:
                annot[f"img_{t:06d}.jpg"] = frame
        off = AP.tracks_to_array(annot, max_num_people=N)
        on = AP.tracks_to_array(annot, max_num_people=N,
                                id_swap_fix=0.5)
        np.testing.assert_array_equal(on, off, err_msg=f"trial {trial}")


def test_id_swap_fix_skips_sentinel_disjoint_joint_sets():
    """Regression (round-4 advisor, medium): an id-CORRECT detection
    whose confident-joint set is disjoint from its own slot's last-seen
    pose puts the 99999 no-shared-joints sentinel on the margin test's
    diagonal, inflating id_cost until any finite wrong-person
    permutation "wins" — the knob then permanently identity-swaps two
    correctly-tracked people (realistic partial occlusion: upper-body
    joints one frame, lower-body the next). The sentinel guard must
    keep the id assignment instead."""
    T = 8
    names = [f"img_{t:06d}.jpg" for t in range(T)]
    annot = {}
    for t in range(T):
        a, b = _walking_pose(30.0 + t), _walking_pose(100.0 + t)
        if t == 3:               # A visible only below the waist
            a[:9, 2] = 0.1
        elif t == 4:             # next frame only above: disjoint sets
            a[9:, 2] = 0.1
        annot[names[t]] = {1: a, 2: b}

    off = AP.tracks_to_array(annot, max_num_people=2)
    on = AP.tracks_to_array(annot, max_num_people=2, id_swap_fix=0.5)
    np.testing.assert_array_equal(on, off)
    # both slots track their own person through and after the occlusion
    for t in range(T):
        assert on[t, 0, 0, 0] < 40.0, t
        assert on[t, 1, 0, 0] > 90.0, t
