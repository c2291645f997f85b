"""engine/gapfill.py: quaternion slerp goldens (vs scipy) and the
gap-interpolation semantics of the opt-in `gap_interpolate` knob.

The reference has no analog (it holds lost tracks at a stale anchor,
datautils.py:326-333); these tests pin the documented extension: only
unobserved (lagged_tn) spans change, interior spans get linear-root +
per-joint-slerp interpolation between the observed endpoints, boundary
spans hold the nearest observed frame, never-observed people are left
alone.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation, Slerp

from mhmocap.engine.gapfill import (
    axis_angle_to_quat, quat_to_axis_angle, slerp_axis_angle,
    interpolate_gap_trajectories)


def _as_matrices(aa):
    return Rotation.from_rotvec(np.asarray(aa).reshape(-1, 3)).as_matrix()


def test_axis_angle_quat_roundtrip():
    rng = np.random.RandomState(0)
    aa = rng.randn(50, 3) * 1.5
    aa = np.concatenate([aa, np.zeros((1, 3))])  # identity too
    back = quat_to_axis_angle(axis_angle_to_quat(aa))
    # same rotation (the round trip re-encodes on the short branch)
    np.testing.assert_allclose(_as_matrices(back), _as_matrices(aa),
                               atol=1e-9)
    # short branch: |theta| <= pi
    assert (np.linalg.norm(back, axis=-1) <= np.pi + 1e-9).all()


def test_slerp_matches_scipy_golden():
    rng = np.random.RandomState(1)
    aa0 = rng.randn(24, 3) * 0.8
    aa1 = rng.randn(24, 3) * 0.8
    w = np.array([0.25, 0.5, 0.75])
    ours = slerp_axis_angle(aa0, aa1, w)            # (3, 24, 3)
    for j in range(24):
        sl = Slerp([0.0, 1.0],
                   Rotation.from_rotvec([aa0[j], aa1[j]]))
        np.testing.assert_allclose(
            _as_matrices(ours[:, j]), sl(w).as_matrix(), atol=1e-7)


def test_slerp_endpoints_and_near_parallel():
    rng = np.random.RandomState(2)
    aa0 = rng.randn(4, 3)
    # endpoints reproduce the endpoint rotations exactly
    out = slerp_axis_angle(aa0, aa0 + 1e-12, np.array([0.0, 1.0]))
    np.testing.assert_allclose(_as_matrices(out[0]), _as_matrices(aa0),
                               atol=1e-9)
    np.testing.assert_allclose(_as_matrices(out[1]), _as_matrices(aa0),
                               atol=1e-8)
    # near-parallel endpoints fall back to a stable lerp (no 0/0)
    out = slerp_axis_angle(aa0, aa0, np.array([0.37]))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(_as_matrices(out[0]), _as_matrices(aa0),
                               atol=1e-9)


def _toy_problem(T=8, N=2):
    rng = np.random.RandomState(3)
    poses_T = rng.randn(T, N, 1, 3).astype(np.float32)
    poses_smpl = (0.3 * rng.randn(T, N, 72)).astype(np.float32)
    lagged = np.zeros((T, N), bool)
    return poses_T, poses_smpl, lagged


def test_interior_run_interpolates_between_endpoints():
    poses_T, poses_smpl, lagged = _toy_problem()
    lagged[3:6, 0] = True                   # run [3,5], anchors 2 / 6
    pt, ps, n = interpolate_gap_trajectories(poses_T, poses_smpl,
                                             lagged)
    assert n == 3
    # inputs not mutated, dtypes preserved
    assert pt is not poses_T and pt.dtype == np.float32
    assert ps.dtype == np.float32
    # linear root between the observed anchors
    for i, t in enumerate(range(3, 6)):
        w = (t - 2) / 4.0
        np.testing.assert_allclose(
            pt[t, 0], (1 - w) * poses_T[2, 0] + w * poses_T[6, 0],
            rtol=1e-6)
    # per-joint slerp for the SMPL pose (scipy golden at the midpoint)
    mid = ps[4, 0].reshape(24, 3)
    for j in range(24):
        sl = Slerp([0.0, 1.0], Rotation.from_rotvec(
            [poses_smpl[2, 0].reshape(24, 3)[j],
             poses_smpl[6, 0].reshape(24, 3)[j]]))
        np.testing.assert_allclose(_as_matrices(mid[j])[0],
                                   sl([0.5]).as_matrix()[0], atol=1e-5)
    # observed frames and the other person are untouched
    np.testing.assert_array_equal(pt[:3], poses_T[:3])
    np.testing.assert_array_equal(pt[6:], poses_T[6:])
    np.testing.assert_array_equal(pt[:, 1], poses_T[:, 1])
    np.testing.assert_array_equal(ps[:, 1], poses_smpl[:, 1])


def test_boundary_runs_hold_nearest_observed():
    poses_T, poses_smpl, lagged = _toy_problem()
    lagged[:3, 0] = True                    # not yet entered
    lagged[6:, 1] = True                    # gone for good
    pt, ps, n = interpolate_gap_trajectories(poses_T, poses_smpl,
                                             lagged)
    assert n == 5
    for t in range(3):
        np.testing.assert_array_equal(pt[t, 0], poses_T[3, 0])
        np.testing.assert_array_equal(ps[t, 0], poses_smpl[3, 0])
    for t in range(6, 8):
        np.testing.assert_array_equal(pt[t, 1], poses_T[5, 1])
        np.testing.assert_array_equal(ps[t, 1], poses_smpl[5, 1])


def test_never_observed_person_left_untouched():
    poses_T, poses_smpl, lagged = _toy_problem()
    lagged[:, 1] = True
    pt, ps, n = interpolate_gap_trajectories(poses_T, poses_smpl,
                                             lagged)
    assert n == 0
    np.testing.assert_array_equal(pt, poses_T)
    np.testing.assert_array_equal(ps, poses_smpl)


def test_clean_sequence_is_identity():
    poses_T, poses_smpl, lagged = _toy_problem()
    pt, ps, n = interpolate_gap_trajectories(poses_T, poses_smpl,
                                             lagged)
    assert n == 0
    np.testing.assert_array_equal(pt, poses_T)
    np.testing.assert_array_equal(ps, poses_smpl)


def test_multiple_runs_one_person():
    poses_T, poses_smpl, lagged = _toy_problem(T=10)
    lagged[2, 0] = True
    lagged[5:7, 0] = True
    pt, _, n = interpolate_gap_trajectories(poses_T, poses_smpl,
                                            lagged)
    assert n == 3
    np.testing.assert_allclose(
        pt[2, 0], 0.5 * (poses_T[1, 0] + poses_T[3, 0]), rtol=1e-6)
    np.testing.assert_allclose(
        pt[5, 0], poses_T[4, 0] + (poses_T[7, 0] - poses_T[4, 0]) / 3,
        rtol=1e-5)
