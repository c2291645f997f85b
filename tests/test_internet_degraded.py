"""Internet-video entry on an adversarial tree (slow, CPU).

The internet path (reference predict_internet.py:10-92) differs from
MuPoTs in exactly the ways that interact with degraded input: no GT,
no intrinsics (FOV-60 default camera), One-Euro 2D pose filtering ON,
and a different default depth dir. PARITY.md §4 validated it on a
clean tree on the real chip; this drives it through the combined
degradations (occlusion, ID switches, detection/ROMP dropout, a
person leaving frame) end-to-end on the CPU.
"""

import os
import pickle

import numpy as np
import pytest
import yaml

pytestmark = pytest.mark.slow


def test_internet_entry_on_degraded_tree(tmp_path, monkeypatch):
    from mhmocap.data.synthetic import generate_sequence
    from mhmocap.models.synthetic import make_synthetic_smpl
    import mhmocap.predict_internet as PI

    root = str(tmp_path / "video")
    model = make_synthetic_smpl(num_vertices=512, seed=13)
    generate_sequence(root, num_frames=16, num_people=2,
                      image_size=(96, 96), model=model, seed=13,
                      degradations={
                          "crossing_paths": True,
                          "enter_leave": True,
                          "id_switch_spans": [(5, 9)],
                          "detection_dropout": 0.08,
                          "romp_person_dropout": 0.15,
                          "romp_missing_frames": 0.10,
                      })

    cfg = {
        "ARGS": {
            "batch_size": 4, "resize_factor": 1.0,
            "erode_segmentation_iters": 0, "erode_backmask_iters": 0,
            "renormalize_depth": False, "post_process_depth": False,
            "num_iter": 4,
            "proj2d_loss_coef": 1.0, "depth_loss_coef": 0.05,
            "silhouette_loss_coef": 0.1, "reg_poses_coef": 0.002,
            "reg_scales_coef": 0.0001, "reg_velocity_coef": 0.05,
            "reg_verts_filter_coef": 0.002, "reg_contact_coef": 0.001,
            "reg_foot_sliding_coef": 0.01,
            "save_visualizations": False, "raster_window": 64,
            "frame_bucket": 1, "spmd": False,
        },
        "smpl": {"smpl_model_parameters_path": "/nonexistent-synthetic"},
        "data": {
            "data_path": root,
            # the generator writes the MuPoTs-layout depth dir; the
            # internet default differs (DPT_midas21), so point at it
            "depth_path": "DPT_large_monodepth",
            "joint_confidence_thr": 0.5,
            "use_hrnet_pose": False,   # no HRNet stream on this tree
            "start_frame": 0, "end_frame": -1, "step_frame": 1,
        },
    }
    cfg_path = str(tmp_path / "internet.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out_dir = str(tmp_path / "out")

    monkeypatch.setattr(PI, "resolve_smpl_model", lambda path: model)
    PI.main(["--configs_yml", cfg_path, "--output_path", out_dir])

    with open(os.path.join(out_dir, "optvar_stage1.pkl"), "rb") as f:
        ov = pickle.load(f)
    assert ov["poses_T"].shape == (16, 2, 1, 3)
    for key in ("poses_T", "poses_smpl", "scale_factor", "min_z",
                "max_z"):
        assert np.isfinite(ov[key]).all(), key
    # scene slot persisted with the reference pickle schema (None at
    # num_iter=4 — the scene refresh only engages from cycle 30)
    assert "scene_depth" in ov
