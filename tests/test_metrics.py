import numpy as np
import pytest

from mhmocap.eval import metrics as M
from mhmocap.eval.mupots_eval import (append_weighted_average,
                                          write_results_as_markdown)


def test_remap_joints_weights():
    x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    mapping = [([1.0], [2]), ([0.5, 0.5], [0, 1])]
    y = M.remap_joints(x, mapping)
    np.testing.assert_allclose(y[:, 0], x[:, 2])
    np.testing.assert_allclose(y[:, 1], 0.5 * (x[:, 0] + x[:, 1]))


def test_masked_average_error_and_pck():
    dist = np.array([0.1, 0.2, 0.4, 1.0], np.float32)
    vis = np.array([1, 1, 1, 0], np.float32)
    assert abs(M.masked_average_error(dist, vis) - 0.7 / 3) < 1e-6
    assert abs(M.masked_average_pck(dist, vis, 0.15) - 1 / 3) < 1e-6


def test_pose_error_3dproj_perfect_prediction():
    """GT == prediction => zero errors, 100% PCK."""
    rng = np.random.RandomState(0)
    T, N = 3, 2
    K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]],
                 np.float32)
    joints_local = 0.3 * rng.randn(T, N, 17, 3).astype(np.float32)
    poses_T = np.zeros((T, N, 1, 3), np.float32)
    poses_T[..., 2] = 4.0
    poses_T[:, 1, :, 0] = 1.0
    gt = joints_local[:, :, :15] + poses_T

    optvar = {
        "poses_T": poses_T,
        "scale_factor": np.ones((1, N, 1, 1), np.float32),
        "poses_smpl": np.zeros((T, N, 72), np.float32),
        "betas_smpl": np.zeros((T, N, 10), np.float32),
    }

    calls = {"n": 0}

    def joints_fn(betas, poses):
        calls["n"] += 1
        return joints_local.reshape(T * N, 17, 3)

    vis = np.ones((T, N, 15, 3), np.float32)  # 17-joint GT sliced below
    gt17 = np.concatenate([gt, gt[:, :, -2:]], axis=2)  # pad to 17
    vis17 = np.ones((T, N, 17, 1), np.float32)

    out = M.pose_error_3dproj(optvar, gt17, vis17, joints_fn, K)
    assert calls["n"] == 1
    assert out["abs_dist"].max() < 1e-4
    assert out["rel_dist"].max() < 1e-4
    assert out["abs_root_pos_err"].max() < 1e-4
    assert out["abs_jitter"].max() < 1e-4
    assert out["valid_joints"].min() == 1.0


def test_pose_error_3dproj_matching_resolves_swaps():
    """Predictions in swapped person order must still match the GT."""
    rng = np.random.RandomState(1)
    T, N = 2, 2
    K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]],
                 np.float32)
    joints_local = 0.2 * rng.randn(T, N, 17, 3).astype(np.float32)
    poses_T = np.zeros((T, N, 1, 3), np.float32)
    poses_T[:, 0, :, 0] = -1.0
    poses_T[:, 1, :, 0] = 1.0
    poses_T[..., 2] = 4.0
    pred = joints_local + poses_T
    # GT has the people in the opposite order
    gt17 = pred[:, ::-1][:, :, :17]
    vis17 = np.ones((T, N, 17, 1), np.float32)
    optvar = {
        "poses_T": poses_T,
        "scale_factor": np.ones((1, N, 1, 1), np.float32),
        "poses_smpl": np.zeros((T, N, 72), np.float32),
        "betas_smpl": np.zeros((T, N, 10), np.float32),
    }
    out = M.pose_error_3dproj(
        optvar, gt17, vis17,
        lambda b, p: joints_local.reshape(T * N, 17, 3), K)
    assert out["abs_dist"].max() < 1e-4


def test_pose_error_3dproj_fewer_predictions_than_gt():
    """K=3 GT people vs N=2 predictions (e.g. a low-visibility person
    dropped by ingestion): the Hungarian match pairs the 2 real
    predictions with their GT, the unmatched GT row contributes zero
    valid joints, and every output stays finite."""
    rng = np.random.RandomState(2)
    T, N, KG = 3, 2, 3
    K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]],
                 np.float32)
    joints_local = 0.2 * rng.randn(T, N, 17, 3).astype(np.float32)
    poses_T = np.zeros((T, N, 1, 3), np.float32)
    poses_T[:, 0, :, 0] = -1.0
    poses_T[:, 1, :, 0] = 1.0
    poses_T[..., 2] = 4.0
    pred = joints_local + poses_T
    # GT = the 2 predicted people + a third far-away person
    extra = 0.2 * rng.randn(T, 1, 17, 3).astype(np.float32) \
        + np.float32([2.5, 0.0, 6.0])
    gt17 = np.concatenate([pred[:, :, :17], extra], axis=1)
    vis17 = np.ones((T, KG, 17, 1), np.float32)
    optvar = {
        "poses_T": poses_T,
        "scale_factor": np.ones((1, N, 1, 1), np.float32),
        "poses_smpl": np.zeros((T, N, 72), np.float32),
        "betas_smpl": np.zeros((T, N, 10), np.float32),
    }
    out = M.pose_error_3dproj(
        optvar, gt17, vis17,
        lambda b, p: joints_local.reshape(T * N, 17, 3), K)
    for v in out.values():
        assert np.isfinite(v).all()
    # exactly N=2 of the KG=3 slots matched per frame
    assert (out["valid_joints"].max(axis=2) > 0).sum(axis=1).max() <= N
    matched = out["valid_joints"].max(axis=2) > 0
    assert out["abs_dist"][matched].max() < 1e-4  # real pairs exact


def test_weighted_average_and_markdown(tmp_path):
    res = {"pck": [50.0, 70.0]}
    append_weighted_average(res, [100, 300])
    assert abs(res["pck"][-1] - 65.0) < 1e-9
    path = str(tmp_path / "r.md")
    write_results_as_markdown(res, ["TS1", "TS2", "Avg."], path)
    content = open(path).read()
    assert "| pck | 50.00 | 70.00 | 65.00 |" in content
