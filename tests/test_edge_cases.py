"""Degenerate-configuration regression tests: one person, one frame."""

import tempfile
import types

import numpy as np
import jax.numpy as jnp
import pytest

from mhmocap.data.synthetic import generate_sequence
from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.data.ingestion import load_sequence
from mhmocap.engine.predictor import Predictor
from mhmocap.models.smpl import smpl_forward


def _args():
    return types.SimpleNamespace(
        num_iter=2, batch_size=2, save_visualizations=False,
        proj2d_loss_coef=1.0, depth_loss_coef=0.05,
        silhouette_loss_coef=0.1, reg_poses_coef=0.002,
        reg_scales_coef=1e-4, reg_velocity_coef=0.05,
        reg_verts_filter_coef=0.002, reg_contact_coef=0.001,
        reg_foot_sliding_coef=0.01, joint_confidence_thr=0.5,
        raster_window=32, frame_bucket=1, spmd=False)


def _run(num_frames, num_people):
    root = tempfile.mkdtemp()
    model = make_synthetic_smpl(num_vertices=256, seed=6)
    generate_sequence(root, num_frames=num_frames,
                      num_people=num_people, image_size=(64, 64),
                      model=model, seed=6)

    def jf(b, p):
        out = smpl_forward(model, jnp.asarray(b), jnp.asarray(p))
        return np.asarray(out["joints_alphapose"])

    seq = load_sequence(root, jf, resize_factor=1.0,
                        post_process_depth=False,
                        renormalize_depth=False)
    out = Predictor(seq, model, tempfile.mkdtemp(), _args()).run()
    ov = out["stage1_optvar"]
    assert ov["poses_T"].shape == (num_frames, num_people, 1, 3)
    assert np.isfinite(ov["poses_T"]).all()
    assert np.isfinite(ov["poses_smpl"]).all()


@pytest.mark.slow
def test_single_person():
    _run(num_frames=4, num_people=1)


@pytest.mark.slow
def test_low_visibility_person_is_dropped_and_fit_completes():
    """A person detected in fewer than 1/8 of the frames must be
    DROPPED by ingestion (reference datautils.py:450-456) and the fit
    must complete on the survivors — GT/instances still contain the
    third person, so this also exercises N_pred < N_raw seg/ROMP
    realignment."""
    import json
    import os

    root = tempfile.mkdtemp()
    model = make_synthetic_smpl(num_vertices=256, seed=6)
    generate_sequence(root, num_frames=12, num_people=3,
                      image_size=(64, 64), model=model, seed=6)
    # keep person idx 3's detections only in frame 0 (1/12 < 1/8)
    ap = os.path.join(root, "AlphaPose", "alphapose-results.json")
    with open(ap) as f:
        entries = json.load(f)
    entries = [e for e in entries
               if e["idx"] != 3 or e["image_id"] == "img_000000.jpg"]
    with open(ap, "w") as f:
        json.dump(entries, f)

    def jf(b, p):
        out = smpl_forward(model, jnp.asarray(b), jnp.asarray(p))
        return np.asarray(out["joints_alphapose"])

    seq = load_sequence(root, jf, resize_factor=1.0,
                        post_process_depth=False,
                        renormalize_depth=False)
    assert seq.num_people == 2          # third person dropped
    assert seq.poses_smpl.shape[1] == 2  # ROMP realigned to survivors
    assert seq.seg_mask.shape[1] == 2
    out = Predictor(seq, model, tempfile.mkdtemp(), _args()).run()
    ov = out["stage1_optvar"]
    assert ov["poses_T"].shape == (12, 2, 1, 3)
    assert np.isfinite(ov["poses_T"]).all()


@pytest.mark.slow
def test_person_with_no_romp_in_any_frame():
    """A person tracked in 2D but NEVER detected by ROMP has no valid
    frame to impute from (datautils.py:336-352 scans for one and gives
    up): their SMPL slots stay zero with valid == 0 and the fit must
    still complete finitely on the pose-2D/silhouette evidence."""
    import os

    root = tempfile.mkdtemp()
    model = make_synthetic_smpl(num_vertices=256, seed=6)
    generate_sequence(root, num_frames=4, num_people=2,
                      image_size=(64, 64), model=model, seed=6)
    # strip person 1 (second row) from every ROMP frame
    rd = os.path.join(root, "ROMP_Predictions")
    for name in sorted(os.listdir(rd)):
        p = os.path.join(rd, name)
        d = np.load(p, allow_pickle=True)["results"].item()
        np.savez(p, results={
            "cam": d["cam"][:1],
            "smpl_thetas": d["smpl_thetas"][:1],
            "smpl_betas": d["smpl_betas"][:1],
        })

    def jf(b, p):
        out = smpl_forward(model, jnp.asarray(b), jnp.asarray(p))
        return np.asarray(out["joints_alphapose"])

    seq = load_sequence(root, jf, resize_factor=1.0,
                        post_process_depth=False,
                        renormalize_depth=False)
    assert seq.num_people == 2
    # one person's SMPL is invalid in EVERY frame (no imputation source)
    per_person_valid = (seq.valid_smpl[:, :, 0] > 0.5).all(axis=0)
    assert per_person_valid.sum() == 1, seq.valid_smpl[:, :, 0]
    out = Predictor(seq, model, tempfile.mkdtemp(), _args()).run()
    ov = out["stage1_optvar"]
    assert np.isfinite(ov["poses_T"]).all()
    assert np.isfinite(ov["poses_smpl"]).all()


@pytest.mark.slow
def test_romp_overdetection_is_trimmed():
    """ROMP frames carrying MORE bodies than tracked people (spurious
    detections) must be Hungarian-trimmed to the tracked set
    (assign_smpl_to_poses pads to M > N then selects the best N, like
    the reference's per-frame `smpl[key][order]`)."""
    import os

    root = tempfile.mkdtemp()
    model = make_synthetic_smpl(num_vertices=256, seed=6)
    generate_sequence(root, num_frames=4, num_people=2,
                      image_size=(64, 64), model=model, seed=6)
    # append a spurious far-offset third body to every ROMP frame
    rd = os.path.join(root, "ROMP_Predictions")
    for name in sorted(os.listdir(rd)):
        p = os.path.join(rd, name)
        d = np.load(p, allow_pickle=True)["results"].item()
        ghost_cam = d["cam"][:1] + np.float32([0.0, 5.0, 5.0])
        np.savez(p, results={
            "cam": np.concatenate([d["cam"], ghost_cam]),
            "smpl_thetas": np.concatenate(
                [d["smpl_thetas"], d["smpl_thetas"][:1]]),
            "smpl_betas": np.concatenate(
                [d["smpl_betas"], d["smpl_betas"][:1]]),
        })

    def jf(b, p):
        out = smpl_forward(model, jnp.asarray(b), jnp.asarray(p))
        return np.asarray(out["joints_alphapose"])

    seq = load_sequence(root, jf, resize_factor=1.0,
                        post_process_depth=False,
                        renormalize_depth=False)
    assert seq.num_people == 2
    assert seq.poses_smpl.shape[1] == 2   # ghost trimmed
    assert np.isfinite(seq.poses_smpl).all()
    out = Predictor(seq, model, tempfile.mkdtemp(), _args()).run()
    assert np.isfinite(out["stage1_optvar"]["poses_T"]).all()


@pytest.mark.slow
def test_single_frame():
    """num_frames=1: the reference documents that temporal losses are
    skipped (optimizer.py:175-177); here the pair-validity masks make
    them vanish."""
    _run(num_frames=1, num_people=2)
