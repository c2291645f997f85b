"""3D pose evaluation metrics (host-side numpy).

Capability parity with reference `mhmocap/evaluate.py`: joint-layout
remapping tables (smpl24->mupots, cmu->mupots15, alphapose->mupots15,
evaluate.py:9-63), per-frame Hungarian GT<->prediction matching in the
projected 2D plane, absolute / root-relative joint distances, root
position error, temporal jitter, masked MPJPE and PCK aggregation
(evaluate.py:180-435).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..data.assignment import match_pose_sets
from ..ops.cameras import project_points, weak_perspective_projection

# Mapping tables: out_joint -> ([weights], [input joints]).
# (evaluate.py:9-63)
SMPL24_TO_MUPOTS = [
    ([8 / 2, -6 / 2], [15, 12]), ([1], [12]), ([1], [17]), ([1], [19]),
    ([1], [21]), ([1], [16]), ([1], [18]), ([1], [20]),
    ([3 / 2, -1 / 2], [2, 1]), ([1], [5]), ([1], [8]),
    ([3 / 2, -1 / 2], [1, 2]), ([1], [4]), ([1], [7]),
    ([3 / 2, -1 / 2], [0, 3]), ([1], [6]), ([1], [15]),
]

CMU_PANOPTIC_TO_MUPOTS15 = [
    ([1], [1]), ([1], [0]), ([1], [9]), ([1], [10]), ([1], [11]),
    ([1], [3]), ([1], [4]), ([1], [5]), ([1], [12]), ([1], [13]),
    ([1], [14]), ([1], [6]), ([1], [7]), ([1], [8]), ([1], [2]),
]

ALPHAPOSE_TO_MUPOTS15 = [
    ([1], [0]), ([1 / 2, 1 / 2], [5, 6]), ([1], [6]), ([1], [8]),
    ([1], [10]), ([1], [5]), ([1], [7]), ([1], [9]), ([1], [12]),
    ([1], [14]), ([1], [16]), ([1], [11]), ([1], [13]), ([1], [15]),
    ([1 / 2, 1 / 2], [11, 12]),
]


def remap_joints(x: np.ndarray, mapping) -> np.ndarray:
    """(N, J_in, D) -> (N, J_out, D) by weighted joint combination
    (evaluate.py:66-90)."""
    N, _, D = x.shape
    out = np.zeros((N, len(mapping), D), np.float32)
    for j, (w, idx) in enumerate(mapping):
        assert abs(sum(w) - 1.0) < 1e-6
        out[:, j] = np.tensordot(np.asarray(w, np.float32),
                                 x[:, np.asarray(idx, int)], axes=(0, 1))
    return out


def map_cmu_panoptic_to_mupots15(pose):
    return remap_joints(pose, CMU_PANOPTIC_TO_MUPOTS15)


def map_alphapose_to_mupots15(pose):
    return remap_joints(pose, ALPHAPOSE_TO_MUPOTS15)


def _dists(a, b):
    return np.sqrt(np.sum(np.square(a - b), axis=-1))


def pose_error_3dproj(
    optvar: Dict,
    ref_poses3d: np.ndarray,     # (T, K, 17|19, 3) GT
    visibility: np.ndarray,      # (T, K, 17|19, 1)
    smpl_joints_mupots_fn: Callable,
    cam_K: np.ndarray,
    Kd: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Absolute / relative / root errors with perspective-2D Hungarian
    matching (reference compute_smpl_pred_error_3dproj,
    evaluate.py:180-296).

    `smpl_joints_mupots_fn(betas (B, 10), poses (B, 72))` returns
    either mupots17 joints (17-joint GT) or alphapose joints remapped
    to mupots15 (19-joint CMU GT).
    """
    poses_T = optvar["poses_T"]
    scale = optvar["scale_factor"]
    T, N = poses_T.shape[:2]
    if scale.shape[0] == 1:
        scale = np.tile(scale, (T, 1, 1, 1))

    K, J = ref_poses3d.shape[1:3]
    assert J in (17, 19), f"unsupported GT joint count {J}"
    if J == 19:
        ref_poses3d = map_cmu_panoptic_to_mupots15(
            ref_poses3d.reshape(T * K, J, 3)).reshape(T, K, -1, 3)
        visibility = map_cmu_panoptic_to_mupots15(
            visibility.reshape(T * K, J, 1)).reshape(T, K, -1, 1)
    else:
        ref_poses3d = ref_poses3d[:, :, :15]
        visibility = visibility[:, :, :15]

    joints = smpl_joints_mupots_fn(
        optvar["betas_smpl"].repeat(T, 0).reshape(-1, 10)
        if optvar["betas_smpl"].shape[0] == 1
        else optvar["betas_smpl"].reshape(-1, 10),
        optvar["poses_smpl"].reshape(-1, 72))
    joints = np.asarray(joints).reshape(T, N, -1, 3)
    if J == 19:
        joints = map_alphapose_to_mupots15(
            joints.reshape(T * N, -1, 3)).reshape(T, N, -1, 3)
    else:
        joints = joints[:, :, :15]

    ref2d = np.asarray(project_points(
        ref_poses3d.reshape(-1, 3)[None], cam_K,
        dist_coef=Kd))[0].reshape(T, K, -1, 2)
    ref2d = np.concatenate([ref2d, visibility], axis=-1)

    matched_ref = np.zeros((T, K, 14, 3), np.float32)
    matched_pred = np.zeros((T, K, 14, 3), np.float32)
    abs_dist = np.zeros((T, K, 14), np.float32)
    rel_dist = np.zeros((T, K, 14), np.float32)
    valid_joints = np.zeros((T, K, 14), np.float32)
    abs_root = np.zeros((T, K), np.float32)
    valid_root = np.zeros((T, K), np.float32)

    # ONE batched projection for all frames instead of one device
    # call per frame
    pred3d_all = np.asarray(scale * joints + poses_T)    # (T, N, 15, 3)
    pred2d_all = np.asarray(project_points(
        pred3d_all.reshape(-1, 3)[None], cam_K,
        dist_coef=Kd))[0].reshape(T, N, -1, 2)
    pred2d_all = np.concatenate(
        [pred2d_all, np.ones_like(pred2d_all[..., :1])], axis=-1)

    for t in range(T):
        pred3d = pred3d_all[t]                           # (N, 15, 3)
        ref_idx, pred_idx = match_pose_sets(ref2d[t], pred2d_all[t])

        for k, (ri, pi) in enumerate(zip(ref_idx, pred_idx)):
            gt, pred = ref_poses3d[t, ri], pred3d[pi]
            vis = visibility[t, ri]
            if vis[14, 0] > 0:
                valid_root[t, k] = 1
                abs_root[t, k] = _dists(gt[14], pred[14])
            matched_ref[t, k] = gt[:14]
            matched_pred[t, k] = pred[:14]
            abs_dist[t, k] = _dists(gt[:14], pred[:14])
            rel_dist[t, k] = _dists(gt[:14] - gt[14:15],
                                    pred[:14] - pred[14:15])
            valid_joints[t, k] = (vis[:14, 0] > 0.49).astype(np.float32)

    jitter = np.abs(_dists(matched_ref[1:], matched_ref[:-1])
                    - _dists(matched_pred[1:], matched_pred[:-1]))
    jitter = np.concatenate([jitter[:1], jitter], axis=0)

    return {
        "abs_dist": abs_dist,
        "rel_dist": rel_dist,
        "valid_joints": valid_joints,
        "abs_root_pos_err": abs_root,
        "valid_root": valid_root,
        "abs_jitter": jitter,
    }


def pose_error_ortho(joints_mupots17, ref_poses3d, visibility, cam_smpl,
                     cam_K, image_size):
    """Root-relative errors with orthographic-projected prediction 2D
    matching (reference compute_smpl_pred_error_ortho,
    evaluate.py:133-177)."""
    T, N = joints_mupots17.shape[:2]
    K = ref_poses3d.shape[1]
    pred2d = np.asarray(weak_perspective_projection(
        joints_mupots17.reshape(T * N, -1, 3),
        cam_smpl.reshape(T * N, 3), image_size)).reshape(T, N, -1, 2)
    pred2d = np.concatenate([pred2d, np.ones_like(pred2d[..., :1])], -1)
    ref2d = np.asarray(project_points(
        ref_poses3d.reshape(-1, 3)[None], cam_K))[0].reshape(T, K, -1, 2)
    ref2d = np.concatenate([ref2d, visibility], axis=-1)

    rel = np.zeros((T, K, 14), np.float32)
    valid = np.zeros((T, K, 14), np.float32)
    for t in range(T):
        ri, pi = match_pose_sets(ref2d[t], pred2d[t])
        for k, (r, p) in enumerate(zip(ri, pi)):
            gt, pred = ref_poses3d[t, r], joints_mupots17[t, p]
            rel[t, k] = _dists(gt[:14] - gt[14:15],
                               pred[:14] - pred[14:15])
            valid[t, k] = (visibility[t, r][:14, 0] > 0.5)
    return rel, valid


def match_predictions_to_gt(ref_poses3d, visibility, joints_mupots17,
                            cam_smpl, cam_K, image_size):
    """Per-frame (ref_idx, pred_idx) match list via orthographic
    projection (reference match_pred_to_pref, evaluate.py:299-321)."""
    T, N = joints_mupots17.shape[:2]
    K = ref_poses3d.shape[1]
    pred2d = np.asarray(weak_perspective_projection(
        joints_mupots17.reshape(T * N, -1, 3),
        cam_smpl.reshape(T * N, 3), image_size)).reshape(T, N, -1, 2)
    pred2d = np.concatenate([pred2d, np.ones_like(pred2d[..., :1])], -1)
    ref2d = np.asarray(project_points(
        ref_poses3d.reshape(-1, 3)[None], cam_K))[0].reshape(T, K, -1, 2)
    ref2d = np.concatenate([ref2d, visibility], axis=-1)
    return [match_pose_sets(ref2d[t], pred2d[t]) for t in range(T)]


def pose_error_3dproj_matched(optvar, ref_poses3d, visibility,
                              joints_mupots17, match_list):
    """Errors with a precomputed match list; also returns the global
    least-squares scale and scale-invariant distances (reference
    compute_smpl_pred_error_3dproj_matched, evaluate.py:324-398)."""
    poses_T = optvar["poses_T"]
    scale = optvar["scale_factor"]
    T, N = poses_T.shape[:2]
    if scale.shape[0] == 1:
        scale = np.tile(scale, (T, 1, 1, 1))
    K = ref_poses3d.shape[1]

    m_ref = np.zeros((T, K, 14, 3), np.float32)
    m_pred = np.zeros((T, K, 14, 3), np.float32)
    abs_dist = np.zeros((T, K, 14), np.float32)
    rel_dist = np.zeros((T, K, 14), np.float32)
    valid = np.zeros((T, K, 14), np.float32)

    for t in range(T):
        pred3d = scale[t] * joints_mupots17[t] + poses_T[t]
        ri, pi = match_list[t]
        for k, (r, p) in enumerate(zip(ri, pi)):
            gt, pred = ref_poses3d[t, r], pred3d[p]
            m_ref[t, k] = gt[:14]
            m_pred[t, k] = pred[:14]
            abs_dist[t, k] = _dists(gt[:14], pred[:14])
            rel_dist[t, k] = _dists(gt[:14] - gt[14:15],
                                    pred[:14] - pred[14:15])
            valid[t, k] = (visibility[t, r][:14, 0] > 0.5)

    s = np.mean((m_ref * m_pred)
                / np.clip(m_pred * m_pred, 1e-3, None))
    si_dist = _dists(m_ref, s * m_pred)
    return abs_dist, rel_dist, si_dist, valid, s


def masked_average_error(dist, vis):
    """sum(vis * dist) / max(sum(vis), 1) (evaluate.py:401-416)."""
    dist = dist.reshape(-1).astype(np.float32)
    vis = (vis > 0.5).reshape(-1).astype(np.float32)
    return float(np.sum(vis * dist) / np.clip(np.sum(vis), 1, None))


def masked_average_pck(dist, vis, thr):
    """Fraction of visible joints with dist <= thr
    (evaluate.py:419-435)."""
    dist = dist.reshape(-1).astype(np.float32)
    vis = (vis > 0.5).reshape(-1).astype(np.float32)
    return float(np.sum(vis * (dist <= thr))
                 / np.clip(np.sum(vis), 1, None))
