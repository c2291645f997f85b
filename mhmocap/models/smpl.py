"""SMPL body model as pure JAX functions.

Capability parity with the reference `mhmocap/smpl.py` (SMPL class,
`lbs`, `batch_rodrigues`, `batch_rigid_transform`, `blend_shapes`,
`vertices2joints`, `VertexJointSelector`; see reference smpl.py:118-746),
re-designed for an accelerator:

  * everything is a pure function over a `SMPLModel` pytree — jit /
    vmap / grad / shard-friendly, no module state;
  * the kinematic chain composition (reference smpl.py:726-731 runs a
    sequential python loop over the 24 joints) is evaluated
    level-parallel over the kinematic tree depth: all joints at the
    same tree depth are composed with one batched 4x4 matmul, giving
    max-tree-depth (== 8 for SMPL) sequential steps instead of 23;
  * blendshape/regressor contractions are einsums that XLA maps onto
    its matmul libraries; there is no batch chunking (reference smpl.py:297-310
    chunks at 512 bodies) — XLA handles arbitrary batch sizes.

The model data is the standard SMPL_NEUTRAL.pkl (user-provided, not
vendored — same policy as the reference, README.md:50-52) plus the four
auxiliary joint regressors shipped in `model_data/parameters/`.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

# All SMPL contractions are tiny (<=6890x24) but feed mm-accuracy 3D
# metrics, so they are pinned to full f32 (the GPU's f32 matmul
# default is TF32, about three decimal digits).
_HI = jax.lax.Precision.HIGHEST

# SMPL kinematic tree: parents[j] is the parent joint of j (root = -1).
# This is the standard SMPL topology (reference reads it from
# kintree_table, smpl.py:270-272).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], dtype=np.int32)

NUM_JOINTS = 24
NUM_BETAS = 10

# SMPL-X topology variant of the same landmark set (reference
# VERTEX_IDS['smplx'], smpl.py:426-448), provided for model files with
# the SMPL-X mesh.
SMPLX_VERTEX_ID_MAP = {
    "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
    "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
    "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    "lthumb": 5361, "lindex": 4933, "lmiddle": 5058, "lring": 5169,
    "lpinky": 5286,
    "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
    "rpinky": 8022,
}

# Extra surface keypoints selected directly from mesh vertices
# (reference VertexJointSelector + VERTEX_IDS['smplh'], smpl.py:67-115,
# 402-425): 5 face + 6 feet + 10 finger tips, appended after the 24
# skeleton joints in this exact order.
VERTEX_ID_MAP = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
    "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
    "lpinky": 2673,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133,
}
EXTRA_VERTEX_IDS = np.array(
    [VERTEX_ID_MAP[k] for k in
     ("nose", "reye", "leye", "rear", "lear",
      "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
      "lthumb", "lindex", "lmiddle", "lring", "lpinky",
      "rthumb", "rindex", "rmiddle", "rring", "rpinky")],
    dtype=np.int32)

# Permutation applied to the H36M regressor output (reference
# smpl.py:242-243).
H36M_TO_J17 = np.array(
    [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9],
    dtype=np.int32)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["v_template", "shapedirs", "posedirs", "j_regressor",
                 "lbs_weights", "faces", "extra_vertex_ids",
                 "j_reg_extra9", "j_reg_h36m17", "j_reg_alphapose",
                 "j_reg_mupots"],
    meta_fields=["parents"])
@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """Immutable SMPL model data (a pytree of arrays).

    Shapes use V = num vertices (6890), F = num faces (13776),
    J = 24 joints, B = 10 betas, P = 207 pose-blendshape features.
    `parents` is static metadata (it drives code generation for the
    kinematic-chain levels), not a traced leaf.
    """

    v_template: jax.Array          # (V, 3)
    shapedirs: jax.Array           # (V, 3, B)
    posedirs: jax.Array            # (P, V*3)  — pre-transposed
    j_regressor: jax.Array         # (J, V)
    lbs_weights: jax.Array         # (V, J)
    faces: jax.Array               # (F, 3) int32
    extra_vertex_ids: jax.Array    # (21,) int32
    parents: Tuple[int, ...]
    # Optional auxiliary regressors (None when not loaded):
    j_reg_extra9: Optional[jax.Array] = None      # (9, V)
    j_reg_h36m17: Optional[jax.Array] = None      # (17, V), permuted
    j_reg_alphapose: Optional[jax.Array] = None   # (17, V)
    j_reg_mupots: Optional[jax.Array] = None      # (17, V)

    def replace(self, **changes) -> "SMPLModel":
        return dataclasses.replace(self, **changes)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


def _dense(x) -> np.ndarray:
    """Convert possibly-sparse (scipy) or chumpy-wrapped array-like
    data to dense float32."""
    if isinstance(x, _ChumpyPlaceholder):
        x = x.x
    if hasattr(x, "todense"):
        x = x.todense()
    return np.asarray(x, dtype=np.float32)


class _ChumpyPlaceholder:
    """Stand-in for chumpy.Ch when unpickling the official
    SMPL_NEUTRAL.pkl without chumpy installed (the download wraps
    v_template/shapedirs/... in chumpy objects; the reference only
    loads it with chumpy importable, smpl.py:187-188). Captures the
    pickled state; the wrapped numpy data lives in `.x`."""

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], np.ndarray):
            self.x = args[0]

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)

    @property
    def r(self):
        return np.asarray(self.x)


class _ChumpyTolerantUnpickler(pickle.Unpickler):
    """Map any chumpy.* class to the placeholder so the official SMPL
    pickle loads in a chumpy-free environment."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyPlaceholder
        return super().find_class(module, name)


def _tree_levels(parents):
    """Group joints by depth in the kinematic tree.

    Returns a list of (joint_idx_array, parent_idx_array) per level,
    excluding the root. All joints in one level can be composed in a
    single batched matmul because their parents' global transforms are
    already final.
    """
    parents = np.asarray(parents, dtype=np.int32)
    depth = np.zeros(len(parents), dtype=np.int32)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = []
    for d in range(1, int(depth.max()) + 1):
        idx = np.nonzero(depth == d)[0].astype(np.int32)
        levels.append((idx, parents[idx].astype(np.int32)))
    return levels


def load_smpl_model(
    model_path: str,
    parameters_path: Optional[str] = None,
    dtype=jnp.float32,
) -> SMPLModel:
    """Load SMPL_NEUTRAL.pkl (+ optional auxiliary regressors).

    Mirrors the data handling of the reference SMPL constructor
    (smpl.py:179-275): densifies the sparse J_regressor, truncates
    shapedirs to 10 betas, reshapes posedirs to (207, V*3), and loads
    the extra9/h36m17/alphapose/mupots regressors from
    `parameters_path` when present (h36m17 permuted by H36M_TO_J17;
    alphapose/mupots transposed on load, smpl.py:241-259).
    """
    if os.path.isdir(model_path):
        model_path = os.path.join(model_path, "SMPL_NEUTRAL.pkl")
    with open(model_path, "rb") as f:
        data = _ChumpyTolerantUnpickler(f, encoding="latin1").load()

    v_template = _dense(data["v_template"])
    shapedirs = _dense(data["shapedirs"])[:, :, :NUM_BETAS]
    posedirs = _dense(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (207, V*3)
    j_regressor = _dense(data["J_regressor"])
    weights = _dense(data["weights"])
    faces = np.asarray(data["f"], dtype=np.int32)
    parents = np.asarray(data["kintree_table"][0], dtype=np.int64)
    parents[0] = -1
    parents = parents.astype(np.int32)

    def _maybe(name, transpose=False, perm=None):
        if parameters_path is None:
            return None
        path = os.path.join(parameters_path, name)
        if not os.path.exists(path):
            return None
        arr = np.load(path).astype(np.float32)
        if transpose:
            arr = arr.T
        if perm is not None:
            arr = arr[perm]
        return jnp.asarray(arr, dtype=dtype)

    return SMPLModel(
        v_template=jnp.asarray(v_template, dtype=dtype),
        shapedirs=jnp.asarray(shapedirs, dtype=dtype),
        posedirs=jnp.asarray(posedirs, dtype=dtype),
        j_regressor=jnp.asarray(j_regressor, dtype=dtype),
        lbs_weights=jnp.asarray(weights, dtype=dtype),
        parents=tuple(int(p) for p in parents),
        faces=jnp.asarray(faces),
        extra_vertex_ids=jnp.asarray(EXTRA_VERTEX_IDS),
        j_reg_extra9=_maybe("J_regressor_extra.npy"),
        j_reg_h36m17=_maybe("J_regressor_h36m.npy", perm=H36M_TO_J17),
        j_reg_alphapose=_maybe(
            "SMPL_AlphaPose_Regressor_RMSprop_6.npy", transpose=True),
        j_reg_mupots=_maybe("SMPL_MuPoTs_Regressor_v1.npy", transpose=True),
    )


def rodrigues(rot_vecs: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Axis-angle vectors -> rotation matrices (Rodrigues formula).

    rot_vecs: (..., 3)  ->  (..., 3, 3)

    Numerics follow the reference (smpl.py:647-678): the angle is the
    norm of (v + eps), which regularizes the zero rotation.
    """
    shifted = rot_vecs + eps
    angle = jnp.sqrt(jnp.sum(shifted * shifted, axis=-1, keepdims=True)
                     + 1e-30)
    axis = shifted / angle
    cos = jnp.cos(angle)[..., None]
    sin = jnp.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = jnp.zeros_like(rx)
    K = jnp.stack([
        jnp.stack([zeros, -rz, ry], axis=-1),
        jnp.stack([rz, zeros, -rx], axis=-1),
        jnp.stack([-ry, rx, zeros], axis=-1),
    ], axis=-2)
    ident = jnp.eye(3, dtype=rot_vecs.dtype)
    KK = jnp.sum(K[..., :, :, None] * K[..., None, :, :], axis=-2)
    return ident + sin * K + (1.0 - cos) * KK


def blend_shapes(betas: jax.Array, shapedirs: jax.Array) -> jax.Array:
    """(B, num_betas) x (V, 3, num_betas) -> (B, V, 3)."""
    V = shapedirs.shape[0]
    flat = shapedirs.reshape(V * 3, shapedirs.shape[-1])  # (V*3, L)
    return jnp.matmul(betas, flat.T, precision=_HI).reshape(
        betas.shape[0], V, 3)


def joints_from_vertices(regressor: jax.Array, verts: jax.Array) -> jax.Array:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return jnp.matmul(regressor, verts, precision=_HI)


def rigid_transform(
    rot_mats: jax.Array,     # (B, J, 3, 3)
    joints: jax.Array,       # (B, J, 3) rest-pose joint locations
    parents: np.ndarray,     # (J,) static
):
    """Forward kinematics over the SMPL tree, level-parallel.

    Returns (posed_joints (B,J,3), rel_transforms (B,J,4,4)) with the
    same semantics as the reference batch_rigid_transform
    (smpl.py:692-746), but composing per tree level rather than per
    joint: joints at equal depth share one batched matmul.
    """
    B, J = joints.shape[:2]
    rel_joints = jnp.concatenate(
        [joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]], axis=1)

    # Local transforms A_j = [R_j | t_j]
    local = jnp.zeros((B, J, 4, 4), dtype=joints.dtype)
    local = local.at[:, :, :3, :3].set(rot_mats)
    local = local.at[:, :, :3, 3].set(rel_joints)
    local = local.at[:, :, 3, 3].set(1.0)

    # Compose down the tree, one broadcast-multiply-reduce per level.
    # 4x4 composes are deliberately NOT expressed as dots: they are far
    # below any matmul tile size, the elementwise form is exact f32 on
    # every backend, and a batched 4x4 dot_general with 3 batch dims
    # has crashed an XLA algebraic-simplifier pass when vmapped
    # (ROADMAP D6 weighs it against a plain batched matmul).
    def _mm4(a, b):  # (..., 4, 4) x (..., 4, 4)
        return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)

    world = local
    for idx, par in _tree_levels(parents):
        world = world.at[:, idx].set(_mm4(world[:, par], local[:, idx]))

    posed_joints = world[:, :, :3, 3]

    # Remove the rest-pose joint location so the transforms act on
    # rest-pose vertices (reference smpl.py:741-744).
    t_correction = jnp.sum(
        world[:, :, :3, :3] * joints[:, :, None, :], axis=-1)
    rel_transforms = world.at[:, :, :3, 3].add(-t_correction)
    return posed_joints, rel_transforms


def lbs(
    betas: jax.Array,        # (B, 10)
    pose: jax.Array,         # (B, 72) axis-angle
    model: SMPLModel,
):
    """Linear blend skinning. Returns (verts (B,V,3), joints (B,J,3)).

    Semantics match the reference `lbs` (smpl.py:490-576), including
    its quirk of forcing the two hand joints (22, 23) to the identity
    rotation (smpl.py:542-546 builds rodrigues only for pose[:, :-6]
    and appends identity "hand_pose").
    """
    B = pose.shape[0]
    v_shaped = model.v_template[None] + blend_shapes(betas, model.shapedirs)
    j_rest = joints_from_vertices(model.j_regressor, v_shaped)

    rot_body = rodrigues(pose[:, :-6].reshape(B, NUM_JOINTS - 2, 3))
    ident = jnp.broadcast_to(jnp.eye(3, dtype=pose.dtype), (B, 2, 3, 3))
    rot_mats = jnp.concatenate([rot_body, ident], axis=1)  # (B, 24, 3, 3)

    pose_feature = (rot_mats[:, 1:] - jnp.eye(3, dtype=pose.dtype)
                    ).reshape(B, -1)                        # (B, 207)
    pose_offsets = jnp.matmul(pose_feature, model.posedirs, precision=_HI).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_tf = rigid_transform(rot_mats, j_rest, model.parents)

    # Skinning: per-vertex transform T = sum_j w_vj * A_j, blended as a
    # single (V, J) x (B, J, 12) matmul, then applied as a
    # batched 3x3 matvec (no homogeneous padding needed).
    tf_flat = rel_tf[:, :, :3, :].reshape(B, NUM_JOINTS, 12)
    T = jnp.matmul(model.lbs_weights, tf_flat, precision=_HI)  # (B,V,12)
    T = T.reshape(B, -1, 3, 4)
    verts = (jnp.sum(T[..., :3] * v_posed[:, :, None, :], axis=-1)
             + T[..., 3])
    return verts, posed_joints


def smpl_forward(
    model: SMPLModel,
    betas: jax.Array,             # (B, 10)
    poses: jax.Array,             # (B, 72)
    transl: Optional[jax.Array] = None,   # (B, 3)
):
    """Full SMPL forward pass; returns a dict of arrays.

    Output keys mirror the reference single_forward (smpl.py:312-399):
      verts (B,V,3), joints_smpl24 (B,24,3),
      j3d (B,45or54,3) = 24 joints + 21 selected vertices (+9 extra),
      joints_h36m17 / joints_alphapose / joints_mupots when the
      corresponding regressors are loaded. joints_h36m17 is centered on
      its pelvis (smpl.py:370-372).
    """
    verts, joints24 = lbs(betas, poses, model)
    extra = verts[:, model.extra_vertex_ids]
    j3d = jnp.concatenate([joints24, extra], axis=1)

    out = {"verts": verts, "joints_smpl24": joints24}

    if model.j_reg_h36m17 is not None:
        j_h36m = joints_from_vertices(model.j_reg_h36m17, verts)
        out["joints_h36m17"] = j_h36m - j_h36m[:, 14:15]
    if model.j_reg_alphapose is not None:
        out["joints_alphapose"] = joints_from_vertices(
            model.j_reg_alphapose, verts)
    if model.j_reg_mupots is not None:
        out["joints_mupots"] = joints_from_vertices(model.j_reg_mupots, verts)
    if model.j_reg_extra9 is not None:
        j3d = jnp.concatenate(
            [j3d, joints_from_vertices(model.j_reg_extra9, verts)], axis=1)
    out["j3d"] = j3d

    if transl is not None:
        out = {k: v + transl[:, None, :] for k, v in out.items()}
    return out


def create(model_path: str, model_type: str = "smpl",
           **kwargs) -> SMPLModel:
    """Factory mirroring the reference `create` (smpl.py:42-65)."""
    if model_type.lower() != "smpl":
        raise ValueError(f"Unknown model type {model_type}")
    return load_smpl_model(model_path, **kwargs)


def vertices_to_landmarks(vertices, faces, lmk_face_idx,
                          lmk_bary_coords):
    """Barycentric landmark interpolation (smpl.py:451-487).

    vertices: (B, V, 3); faces: (F, 3); lmk_face_idx: (L,);
    lmk_bary_coords: (L, 3) -> (B, L, 3).
    """
    tri = vertices[:, faces[lmk_face_idx]]        # (B, L, 3, 3)
    return jnp.sum(tri * lmk_bary_coords[None, :, :, None], axis=2)


def rot_mat_to_euler(rot_mats):
    """Rotation matrices -> y-axis Euler angle (smpl.py:595-601)."""
    sy = jnp.sqrt(rot_mats[..., 0, 0] ** 2 + rot_mats[..., 1, 0] ** 2)
    return jnp.arctan2(-rot_mats[..., 2, 0], sy)


if __name__ == "__main__":
    # Visual LBS sanity harness (parity with reference smpl.py:749-777,
    # which zero-poses a body, bends one joint, and renders with vedo):
    # build a model (real SMPL_NEUTRAL.pkl via $SMPL_MODEL if present,
    # synthetic otherwise), bend the left elbow by 90 degrees, print
    # joint statistics, and save a front-view scatter PNG.
    import os as _os
    import sys as _sys

    import numpy as _np

    # host-side sanity tool: run on CPU (the reference harness is
    # CPU/vedo too)
    jax.config.update("jax_platforms", "cpu")

    path = _os.environ.get("SMPL_MODEL", "")
    if path and _os.path.exists(path):
        model = load_smpl_model(path)
        print(f"loaded SMPL model from {path}")
    else:
        from .synthetic import make_synthetic_smpl
        model = make_synthetic_smpl()
        print("SMPL_MODEL not set; using the synthetic body")

    poses = jnp.zeros((2, 72))
    poses = poses.at[1, 3 * 18 + 0].set(jnp.pi / 2)   # bend L elbow
    out = smpl_forward(model, jnp.zeros((2, 10)), poses)
    verts = _np.asarray(out["verts"])
    joints = _np.asarray(out["joints_smpl24"])
    moved = _np.abs(verts[1] - verts[0]).max(axis=-1)
    print(f"verts: {verts.shape}, joints: {joints.shape}")
    print(f"zero-pose extent y: [{verts[0, :, 1].min():+.3f}, "
          f"{verts[0, :, 1].max():+.3f}] m")
    print(f"bent-elbow moved {int((moved > 1e-4).sum())} / "
          f"{verts.shape[1]} vertices (max {moved.max():.3f} m)")
    assert (moved > 1e-4).any(), "bending a joint must move vertices"

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(8, 5))
        for i, ax in enumerate(axes):
            ax.scatter(verts[i, :, 0], -verts[i, :, 1], s=0.5)
            ax.set_aspect("equal")
            ax.set_title(["zero pose", "L elbow 90deg"][i])
        fname = _os.path.join(_os.getcwd(), "smpl_smoke.png")
        fig.savefig(fname, dpi=110)
        print(f"render saved to {fname}")
    except Exception as e:  # rendering is best-effort
        print(f"render skipped: {e}", file=_sys.stderr)
