"""Unit tests for the pure-JAX SMPL core.

Golden values come from independent numpy re-derivations (sequential
kinematic chain, scipy Rodrigues), NOT from the reference code.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from mhmocap.models import smpl as M


def test_rodrigues_matches_scipy(rng):
    v = rng.randn(32, 3).astype(np.float32)
    ours = np.asarray(M.rodrigues(jnp.asarray(v)))
    # The reference semantics add 1e-8 to the vector before computing
    # the angle; mirror that in the golden value.
    golden = Rotation.from_rotvec(v + 1e-8).as_matrix()
    np.testing.assert_allclose(ours, golden, atol=2e-6)


def test_rodrigues_zero_is_near_identity():
    R = np.asarray(M.rodrigues(jnp.zeros((1, 3))))
    np.testing.assert_allclose(R[0], np.eye(3), atol=1e-6)


def test_rodrigues_grad_finite():
    g = jax.grad(lambda v: jnp.sum(M.rodrigues(v)))(jnp.zeros((4, 3)))
    assert np.all(np.isfinite(np.asarray(g)))


def _sequential_rigid_transform(rot_mats, joints, parents):
    """Naive per-joint sequential forward kinematics (numpy golden)."""
    B, J = joints.shape[:2]
    rel = joints.copy()
    rel[:, 1:] -= joints[:, parents[1:]]
    local = np.zeros((B, J, 4, 4), np.float64)
    local[:, :, :3, :3] = rot_mats
    local[:, :, :3, 3] = rel
    local[:, :, 3, 3] = 1
    world = np.zeros_like(local)
    world[:, 0] = local[:, 0]
    for j in range(1, J):
        world[:, j] = world[:, parents[j]] @ local[:, j]
    posed = world[:, :, :3, 3].copy()
    relw = world.copy()
    relw[:, :, :3, 3] -= np.einsum(
        "bjxy,bjy->bjx", world[:, :, :3, :3], joints)
    return posed, relw


def test_rigid_transform_matches_sequential(rng):
    B, J = 3, 24
    rot = Rotation.from_rotvec(
        0.3 * rng.randn(B * J, 3)).as_matrix().reshape(B, J, 3, 3)
    joints = rng.randn(B, J, 3).astype(np.float64) * 0.3
    golden_pj, golden_tf = _sequential_rigid_transform(
        rot, joints, M.SMPL_PARENTS)
    pj, tf = M.rigid_transform(
        jnp.asarray(rot, jnp.float32), jnp.asarray(joints, jnp.float32),
        M.SMPL_PARENTS)
    np.testing.assert_allclose(np.asarray(pj), golden_pj, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tf), golden_tf, atol=1e-5)


def test_lbs_zero_pose_keeps_rest_shape(tiny_smpl):
    B = 2
    betas = jnp.zeros((B, 10))
    poses = jnp.zeros((B, 72))
    verts, joints = M.lbs(betas, poses, tiny_smpl)
    v_expect = np.asarray(tiny_smpl.v_template)
    np.testing.assert_allclose(np.asarray(verts[0]), v_expect, atol=1e-5)
    j_expect = np.asarray(tiny_smpl.j_regressor) @ v_expect
    np.testing.assert_allclose(np.asarray(joints[0]), j_expect, atol=1e-5)


def test_lbs_hand_joints_are_ignored(tiny_smpl, rng):
    """Reference quirk: pose[66:72] (both hands) must have no effect."""
    base = 0.2 * rng.randn(1, 72).astype(np.float32)
    p1 = jnp.asarray(base)
    p2 = p1.at[:, 66:].add(1.0)
    v1, _ = M.lbs(jnp.zeros((1, 10)), p1, tiny_smpl)
    v2, _ = M.lbs(jnp.zeros((1, 10)), p2, tiny_smpl)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)


def test_lbs_betas_move_vertices(tiny_smpl):
    betas = jnp.ones((1, 10))
    v0, _ = M.lbs(jnp.zeros((1, 10)), jnp.zeros((1, 72)), tiny_smpl)
    v1, _ = M.lbs(betas, jnp.zeros((1, 72)), tiny_smpl)
    delta = np.asarray(v1 - v0)
    expect = np.asarray(tiny_smpl.shapedirs).sum(-1)
    np.testing.assert_allclose(delta[0], expect, atol=1e-5)


def test_lbs_articulation_rotates_subtree(tiny_smpl):
    """Bending the left elbow (18) moves wrist-weighted verts."""
    pose = jnp.zeros((1, 72)).at[0, 18 * 3 + 1].set(-1.5)
    v0, j0 = M.lbs(jnp.zeros((1, 10)), jnp.zeros((1, 72)), tiny_smpl)
    v1, j1 = M.lbs(jnp.zeros((1, 10)), pose, tiny_smpl)
    # Joint 20 (l_wrist) is a descendant of 18 and must move; joint 17
    # (r_shoulder) is in a different subtree and must not.
    assert np.linalg.norm(np.asarray(j1[0, 20] - j0[0, 20])) > 0.05
    np.testing.assert_allclose(
        np.asarray(j1[0, 17]), np.asarray(j0[0, 17]), atol=1e-5)


def test_smpl_forward_output_shapes(tiny_smpl):
    B = 4
    out = M.smpl_forward(
        tiny_smpl, jnp.zeros((B, 10)), jnp.zeros((B, 72)))
    V = tiny_smpl.num_vertices
    assert out["verts"].shape == (B, V, 3)
    assert out["joints_smpl24"].shape == (B, 24, 3)
    assert out["j3d"].shape == (B, 54, 3)  # 24 + 21 + 9 extra
    assert out["joints_h36m17"].shape == (B, 17, 3)
    assert out["joints_alphapose"].shape == (B, 17, 3)
    assert out["joints_mupots"].shape == (B, 17, 3)


def test_smpl_forward_h36m_is_pelvis_centered(tiny_smpl):
    out = M.smpl_forward(
        tiny_smpl, jnp.zeros((2, 10)), jnp.zeros((2, 72)))
    pelvis = np.asarray(out["joints_h36m17"][:, 14])
    np.testing.assert_allclose(pelvis, 0.0, atol=1e-6)


def test_smpl_forward_transl_shifts_everything(tiny_smpl):
    t = jnp.asarray([[1.0, -2.0, 3.0]])
    o0 = M.smpl_forward(tiny_smpl, jnp.zeros((1, 10)), jnp.zeros((1, 72)))
    o1 = M.smpl_forward(
        tiny_smpl, jnp.zeros((1, 10)), jnp.zeros((1, 72)), transl=t)
    for k in o0:
        np.testing.assert_allclose(
            np.asarray(o1[k] - o0[k]),
            np.broadcast_to(np.asarray(t)[:, None], o0[k].shape),
            atol=1e-5)


def test_smpl_forward_jit_and_grad(tiny_smpl):
    @jax.jit
    def loss(poses):
        out = M.smpl_forward(tiny_smpl, jnp.zeros((2, 10)), poses)
        return jnp.sum(out["verts"] ** 2)

    g = jax.grad(loss)(0.1 * jnp.ones((2, 72)))
    assert g.shape == (2, 72)
    assert np.all(np.isfinite(np.asarray(g)))
    # Hand-joint gradient must be zero (identity quirk).
    np.testing.assert_allclose(np.asarray(g[:, 66:]), 0.0, atol=1e-8)


@pytest.mark.slow
def test_smpl_forward_vmap_over_frames(tiny_smpl):
    T, N = 3, 2
    poses = jnp.zeros((T, N, 72))
    betas = jnp.zeros((T, N, 10))
    fn = jax.vmap(lambda b, p: M.smpl_forward(tiny_smpl, b, p)["verts"])
    verts = fn(betas, poses)
    assert verts.shape == (T, N, tiny_smpl.num_vertices, 3)


def test_load_smpl_pickle_with_chumpy_and_sparse(tmp_path):
    """The official SMPL_NEUTRAL.pkl wraps arrays in chumpy objects
    and stores J_regressor sparse; loading must work WITHOUT chumpy
    installed (reference smpl.py:179-275 requires chumpy importable).
    Build such a pickle with a throwaway fake chumpy module, drop the
    module, then load."""
    import pickle
    import sys
    import types
    import scipy.sparse as sp
    from mhmocap.models.smpl import load_smpl_model, smpl_forward
    from mhmocap.models.synthetic import make_synthetic_smpl

    src = make_synthetic_smpl(num_vertices=512, seed=9)
    V = src.num_vertices

    # fake chumpy whose Ch pickles by instance __dict__ (like real Ch)
    ch_mod = types.ModuleType("chumpy")
    ch_sub = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = np.asarray(x)

    Ch.__module__ = "chumpy.ch"
    Ch.__qualname__ = "Ch"
    ch_sub.Ch = Ch
    ch_mod.Ch = Ch
    sys.modules["chumpy"] = ch_mod
    sys.modules["chumpy.ch"] = ch_sub
    try:
        data = {
            "v_template": Ch(np.asarray(src.v_template)),
            "shapedirs": Ch(np.asarray(src.shapedirs)),
            "posedirs": Ch(np.asarray(src.posedirs).T.reshape(
                V, 3, 207)),
            "J_regressor": sp.csc_matrix(np.asarray(src.j_regressor)),
            "weights": Ch(np.asarray(src.lbs_weights)),
            "f": np.asarray(src.faces, np.uint32),
            "kintree_table": np.stack([
                np.asarray([2 ** 32 - 1] + list(src.parents[1:]),
                           np.int64),
                np.arange(24, dtype=np.int64)]),
        }
        pkl = tmp_path / "SMPL_NEUTRAL.pkl"
        with open(pkl, "wb") as f:
            pickle.dump(data, f, protocol=2)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]

    model = load_smpl_model(str(pkl))
    np.testing.assert_allclose(np.asarray(model.v_template),
                               np.asarray(src.v_template), atol=1e-6)
    np.testing.assert_allclose(np.asarray(model.j_regressor),
                               np.asarray(src.j_regressor), atol=1e-6)
    out = smpl_forward(model, jnp.zeros((1, 10)), jnp.zeros((1, 72)))
    ref = smpl_forward(src, jnp.zeros((1, 10)), jnp.zeros((1, 72)))
    np.testing.assert_allclose(np.asarray(out["verts"]),
                               np.asarray(ref["verts"]), atol=1e-5)
