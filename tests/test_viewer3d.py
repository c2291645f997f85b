"""Headless visualizer tests (C17): exports, frame/depth capture,
skeleton gating, render options."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from mhmocap.viz import viewer3d as V


def _camera(side=32):
    K = np.array([[side, 0, side / 2], [0, side, side / 2],
                  [0, 0, 1]], np.float32)
    return {"K": K, "image_size": (side, side)}


def _scene(side=32):
    img = np.full((side, side, 3), 128, np.uint8)
    depth = np.full((side, side), 4.0, np.float32)
    return img, depth


def _cube_verts(center, r=0.1):
    corners = np.array([[dx, dy, dz] for dx in (-r, r)
                        for dy in (-r, r) for dz in (-r, r)], np.float32)
    return corners + np.asarray(center, np.float32)


CUBE_FACES = np.array([[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
                       [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
                       [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7]],
                      np.int32)


def _viewer(tmp_path, T=3, N=2, valid=None, **kw):
    img, depth = _scene()
    verts = np.stack([
        np.stack([_cube_verts([0.3 * n - 0.2, 0.1 * t, 2.0])
                  for n in range(N)]) for t in range(T)])
    return V.SceneHumansVisualizer(
        img, depth, _camera(), vertices=verts, faces=CUBE_FACES,
        valid_vertices=valid, output_path=str(tmp_path / "cap"),
        verbose=False, **kw)


def test_export_writes_scene_and_meshes(tmp_path):
    v = _viewer(tmp_path)
    out = v.export(str(tmp_path / "viz"), max_frames=2)
    assert os.path.exists(os.path.join(out, "scene.ply"))
    assert os.path.exists(os.path.join(out, "human_0000_0.ply"))
    assert os.path.exists(os.path.join(out, "human_0001_1.ply"))
    assert os.path.exists(os.path.join(out, "camera_view_0000.png"))


def test_capture_writes_color_and_uint16_depth(tmp_path):
    """Parity with the reference's capture_frame contract
    (visualization.py:181-203): img_%06d.png color + depth_%06d.png
    uint16 millimeters."""
    v = _viewer(tmp_path, capture_rendered_color=True,
                capture_rendered_depth=True)
    v.capture_frame(0)
    v.capture_frame(1)
    cap = str(tmp_path / "cap")
    assert os.path.exists(os.path.join(cap, "img_000000.png"))
    assert os.path.exists(os.path.join(cap, "img_000001.png"))
    d = np.asarray(Image.open(os.path.join(cap, "depth_000000.png")))
    assert d.dtype == np.uint16
    # scene plane at 4 m -> 4000 mm; nearest cube corners at
    # 2.0 - 0.1 m -> 1900 mm (z-buffer keeps the nearest)
    vals = np.unique(d[d > 0])
    assert 4000 in vals
    assert 1900 in vals


def test_step_autocaptures_when_enabled(tmp_path):
    v = _viewer(tmp_path, capture_rendered_color=True)
    assert v.step() == 1
    assert v.step() == 2
    assert v.step() == 0          # wraps like the reference (:238-241)
    cap = str(tmp_path / "cap")
    assert os.path.exists(os.path.join(cap, "img_000002.png"))


def test_invalid_bodies_parked_behind_camera(tmp_path):
    valid = np.ones((3, 2, 1), np.float32)
    valid[1, 0, 0] = 0.0
    v = _viewer(tmp_path, valid=valid)
    fv = v.frame_vertices(1)
    np.testing.assert_array_equal(fv[0], np.tile([[0, 0, -1.0]],
                                                 (8, 1)))
    assert fv[1][0, 2] > 0        # the valid body untouched


def test_per_frame_scenes_accepted(tmp_path):
    imgs = np.stack([np.full((32, 32, 3), 50 * (t + 1), np.uint8)
                     for t in range(3)])
    depths = np.stack([np.full((32, 32), 2.0 + t, np.float32)
                       for t in range(3)])
    v = V.SceneHumansVisualizer(imgs, depths, _camera(),
                                verbose=False)
    assert v.multiple_scenes
    assert v.max_frames == 3
    pts1, _ = v._scene_of(1)
    assert np.allclose(np.unique(pts1[:, 2]), 3.0)


def test_mupots15_visibility_gating():
    """Reference make_pose_mesh_mupots (visualization.py:624-645):
    hidden joints collapse to origin; a link needs BOTH ends above the
    hard-coded 0.5 regardless of the sphere threshold."""
    pose = np.arange(17 * 3, dtype=np.float32).reshape(17, 3)
    vis = np.ones((17, 1), np.float32)
    vis[3] = 0.0
    pts, links, ok = V.mupots15_pose_arrays(pose, vis, thr=0.5)
    assert pts.shape == (15, 3) and links.shape == (15, 2)
    np.testing.assert_array_equal(pts[3], 0.0)        # hidden joint
    np.testing.assert_array_equal(links[3], [0, 0])   # its link
    np.testing.assert_array_equal(links[2], [0, 0])   # parent is 3
    np.testing.assert_array_equal(links[0], [0, 1])   # visible pair
    # sphere thr and link thr differ (the reference quirk): thr=0.05
    # shows the sphere but the 0.5 link gate still drops the link
    pts2, links2, ok2 = V.mupots15_pose_arrays(
        pose, np.full((17, 1), 0.3, np.float32), thr=0.05)
    assert ok2.all()
    np.testing.assert_array_equal(links2, np.zeros((15, 2)))


def test_skeleton_visualizer_exports_and_captures(tmp_path):
    T, N = 2, 2
    rng = np.random.RandomState(0)
    pred = rng.uniform(-0.5, 0.5, size=(T, N, 17, 3)).astype(np.float32)
    pred[..., 2] += 3.0
    vis = np.ones((T, N, 17, 1), np.float32)
    sk = V.SkeletonVisualizer(_camera(), pred, vis,
                              output_path=str(tmp_path / "cap"),
                              capture_rendered_color=True)
    out = sk.export(str(tmp_path / "viz"))
    assert os.path.exists(os.path.join(out, "skeleton_0000.ply"))
    assert os.path.exists(os.path.join(out, "skeleton_0001.ply"))
    assert os.path.exists(os.path.join(out, "img_000000.png"))


def test_skeleton_gt_overlay_uses_match_list(tmp_path):
    T, N = 1, 2
    pred = np.zeros((T, N, 17, 3), np.float32)
    pred[..., 2] = 3.0
    gt = pred + 0.1
    vis = np.ones((T, N, 17, 1), np.float32)
    match = [(np.array([1, 0]), np.array([0, 1]))]  # (gt_idx, pred_idx)
    sk = V.SkeletonVisualizer(_camera(), pred, vis, pose_gt=gt,
                              gt_vis=vis, match_list=match)
    # two predictions + two GT overlays per frame
    assert len(sk.frames[0]) == 4
    # GT skeletons are gray
    grays = [c for _, _, c in sk.frames[0]
             if np.allclose(c, [0.25, 0.25, 0.25])]
    assert len(grays) == 2


def test_renderoption_json_is_valid():
    assert os.path.exists(V.RENDEROPTION_PATH)
    with open(V.RENDEROPTION_PATH) as f:
        opt = json.load(f)
    assert opt["class_name"] == "RenderOption"
    assert "background_color" in opt and "point_size" in opt


@pytest.mark.slow
def test_save_visualization_stage1_outputs(tmp_path):
    """The stage-1 export (reference predict.py:141-257): loss curves,
    per-frame overlays, and the visualization pickle — with the SMPL
    forward and projections batched over all frames."""
    import types
    from mhmocap.viz.export import save_visualization_stage1
    from mhmocap.models.synthetic import make_synthetic_smpl
    from mhmocap.ops.cameras import intrinsics_from_fov
    from mhmocap.engine import optimizer as E

    T, N, side = 3, 2, 32
    model = make_synthetic_smpl(num_vertices=256, seed=5)
    rng = np.random.RandomState(0)
    class _Seq(types.SimpleNamespace):
        def __len__(self):
            return T

    seq = _Seq(
        images=np.zeros((T, side, side, 3), np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, side, side),
                       0.05, 1).astype(np.float32),
        backmasks=np.ones((T, side, side), np.float32),
        cam_smpl=np.zeros((T, N, 3), np.float32),
        valid_smpl=np.ones((T, N, 1), np.float32),
        cam={"K": intrinsics_from_fov((side, side), 60.0),
             "fov": 60.0, "Kd": None, "image_size": (side, side)},
    )
    optvar = {
        "scale_factor": np.ones((1, N, 1, 1), np.float32),
        "poses_T": np.tile([[[0.0, 0.3, 3.0]]], (T, N, 1))[
            :, :, None].reshape(T, N, 1, 3).astype(np.float32),
        "poses_smpl": np.zeros((T, N, 72), np.float32),
        "betas_smpl": np.zeros((1, N, 10), np.float32),
        "min_z": np.full((T, 1, 1), 2.0, np.float32),
        "max_z": np.full((T, 1, 1), 8.0, np.float32),
    }
    pose2d = 16.0 * np.ones((T, N, 17, 3), np.float32)
    log = [{k: 1.0 for k in E.LOG_KEYS} for _ in range(2)]

    save_visualization_stage1(str(tmp_path), seq, model, optvar,
                              pose2d, log, max_overlays=2)
    assert (tmp_path / "fig_optim_curves_stage1.png").exists()

    from mhmocap.viz.export import save_visualization_init_data
    init_ov = dict(optvar)
    init_ov["pose2d"] = pose2d
    save_visualization_init_data(str(tmp_path), seq, model, init_ov,
                                 [1.0, 0.5], max_frames=2)
    assert (tmp_path / "fig_optim_curves_init.png").exists()
    assert (tmp_path / "vis_init" / "vis_0000.png").exists()
    assert (tmp_path / "vis_stage1" / "vis_0000.png").exists()
    import pickle
    with open(tmp_path / "visualization_data_stage1.pkl", "rb") as f:
        vd = pickle.load(f)
    assert vd["verts"].shape == (T, N, 256, 3)
    assert np.isfinite(vd["verts"]).all()
    assert vd["depths"].shape == (T, side, side)
