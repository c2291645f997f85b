"""Full end-to-end pipeline test: synthetic MuPoTs-format sequence ->
predict_mupots CLI -> eval_mupots CLI -> FinalResults files.

This is the framework-level smoke test mirroring the reference's
script/predict_mupots_test.sh practice (survey §4) but with real
assertions on the outputs.
"""

import json
import os
import pickle

import numpy as np
import pytest
import yaml

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def mupots_tree(tmp_path_factory):
    """A synthetic ./data/mupots-like tree with one sequence (TS1)."""
    import jax
    from mhmocap.data.synthetic import generate_sequence
    from mhmocap.models.synthetic import make_synthetic_smpl

    root = tmp_path_factory.mktemp("mupots_data")
    model = make_synthetic_smpl(num_vertices=512, seed=7)
    gt = generate_sequence(str(root / "TS1"), num_frames=6,
                           num_people=2, image_size=(96, 96),
                           model=model, mupots_gt=True, seed=7)
    return str(root), gt, model


@pytest.fixture(scope="module")
def config_yml(tmp_path_factory, mupots_tree):
    data_path, _, _ = mupots_tree
    cfgdir = tmp_path_factory.mktemp("cfg")
    cfg = {
        "ARGS": {
            "batch_size": 3,
            "resize_factor": 1.0,
            "erode_segmentation_iters": 0,
            "erode_backmask_iters": 0,
            "renormalize_depth": False,
            "post_process_depth": False,
            "num_iter": 4,
            "proj2d_loss_coef": 1.0,
            "depth_loss_coef": 0.05,
            "silhouette_loss_coef": 0.1,
            "reg_poses_coef": 0.002,
            "reg_scales_coef": 0.0001,
            "reg_velocity_coef": 0.05,
            "reg_verts_filter_coef": 0.002,
            "reg_contact_coef": 0.001,
            "reg_foot_sliding_coef": 0.01,
            "save_visualizations": False,
            "raster_window": 64,
            "frame_bucket": 1,
            "spmd": False,
        },
        "smpl": {"smpl_model_parameters_path": "/nonexistent-synthetic"},
        "data": {
            "data_path": data_path,
            "depth_path": "DPT_large_monodepth",
            "joint_confidence_thr": 0.5,
            "use_hrnet_pose": False,
            "start_frame": 0,
            "end_frame": -1,
            "step_frame": 1,
        },
    }
    path = str(cfgdir / "test.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def predict_output(tmp_path_factory, mupots_tree, config_yml,
                   monkeypatch_module):
    """Run the predict_mupots CLI main() on the synthetic tree."""
    _, _, model = mupots_tree
    out_dir = str(tmp_path_factory.mktemp("out"))
    # patch the model resolver to return the generator's exact model
    import mhmocap.predict_mupots as PM
    monkeypatch_module.setattr(
        PM, "resolve_smpl_model", lambda path: model)
    PM.main(["--configs_yml", config_yml, "--ts_id", "1",
             "--output_path", out_dir])
    return out_dir


@pytest.fixture(scope="module")
def monkeypatch_module():
    from _pytest.monkeypatch import MonkeyPatch
    mp = MonkeyPatch()
    yield mp
    mp.undo()


def test_predict_writes_pickles(predict_output):
    ts = os.path.join(predict_output, "TS1")
    for name in ("optvar_init.pkl", "optvar_stage1.pkl",
                 "mupots_annot.pkl"):
        assert os.path.exists(os.path.join(ts, name)), name

    with open(os.path.join(ts, "optvar_stage1.pkl"), "rb") as f:
        ov = pickle.load(f)
    # reference pickle schema (optimizer.py:619-636)
    for key in ("scale_factor", "poses_T", "poses_smpl", "betas_smpl",
                "valid_smpl", "min_z", "max_z", "scene_depth",
                "scene_img", "scene_mask"):
        assert key in ov, key
    assert ov["poses_T"].shape == (6, 2, 1, 3)
    assert ov["poses_smpl"].shape == (6, 2, 72)
    assert np.isfinite(ov["poses_T"]).all()

    with open(os.path.join(ts, "mupots_annot.pkl"), "rb") as f:
        annot = pickle.load(f)
    assert annot["pose3d_gt"].shape == (6, 2, 17, 3)


def test_init_translations_close_to_gt(predict_output, mupots_tree):
    _, gt, _ = mupots_tree
    with open(os.path.join(predict_output, "TS1",
                           "optvar_init.pkl"), "rb") as f:
        ov = pickle.load(f)
    # x/y recovered from clean 2D should be decent even with 100 iters
    err_xy = np.abs(ov["poses_T"][..., :2] - gt["poses_T"][..., :2])
    assert err_xy.mean() < 0.25, err_xy.mean()


def test_eval_route_matches_reingestion(predict_output, mupots_tree):
    """Eval-route parity (reference eval_mupots.py:121-128 re-ingests
    the dataset with the eval config; this framework reads the stored
    mupots_annot.pkl instead): the stored cam_K and GT slicing must
    equal a fresh re-ingestion of the on-disk tree."""
    from mhmocap.data import mupots

    data_path, _, _ = mupots_tree
    with open(os.path.join(predict_output, "TS1",
                           "mupots_annot.pkl"), "rb") as f:
        stored = pickle.load(f)

    annot, occl, cam_K = mupots.load_sequence_metadata(
        os.path.join(data_path, "TS1", "images"))
    T = stored["pose3d_gt"].shape[0]
    p3d, p3d_univ, vis = mupots.slice_ground_truth(
        annot, occl, frame_ids=range(T))

    # resize_factor is 1.0 in the e2e config, so the stored
    # working-resolution intrinsics equal the tree's intrinsics.txt
    np.testing.assert_allclose(stored["cam_K"], cam_K, rtol=1e-6)
    np.testing.assert_allclose(stored["pose3d_gt"], p3d, rtol=1e-6)
    np.testing.assert_allclose(stored["pose3d_univ_gt"], p3d_univ,
                               rtol=1e-6)
    np.testing.assert_array_equal(stored["visibility"], vis)


def test_eval_mupots_writes_results(predict_output, mupots_tree,
                                    config_yml, monkeypatch_module):
    _, _, model = mupots_tree
    import mhmocap.eval_mupots as EM
    monkeypatch_module.setattr(
        EM, "resolve_smpl_model", lambda path: model)
    EM.main(["--configs_yml", config_yml,
             "--input_path", predict_output])

    with open(os.path.join(predict_output, "FinalResults.json")) as f:
        res = json.load(f)["final_results"]
    for key in ("mm_abs_error", "mm_rel_error", "mm_mrpe", "pck_rel",
                "ap25_root", "abs_jitter"):
        assert key in res and key + "_univ" in res
        assert len(res[key]) == 2  # TS1 + Avg.
        assert np.isfinite(res[key]).all()

    md = os.path.join(predict_output, "FinalResults.md")
    assert os.path.exists(md)
    content = open(md).read()
    assert "TS1" in content and "Avg." in content

    # Synthetic GT comes from the same generative model: with only 4
    # cycles the fit should still be in the right ballpark (the 2D
    # tracks are exact projections).
    assert res["pck_rel"][0] > 30.0, res["pck_rel"]
