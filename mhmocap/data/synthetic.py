"""Synthetic on-disk sequence generator (test fixture + demo data).

Writes a directory tree in the EXACT input formats the reference
pipeline consumes (survey §2.4 / reference README.md:85-102):

    <root>/images/img_%06d.jpg                 RGB frames
    <root>/AlphaPose/alphapose-results.json    2D keypoints + track ids
    <root>/DPT_large_monodepth/img_%06d.png    16-bit normalized disparity
    <root>/ROMP_Predictions/img_%06d.npz       SMPL init (new format)
    <root>/Mask2Former_Instances/img_%06d.png  uint8 instance labels
    <root>/images/{annot.mat,occlusion.mat,intrinsics.txt}  (MuPoTs mode)

The scene is a synthetic room (floor + back wall) with N articulated
synthetic-SMPL people walking; ground-truth depth, masks, keypoints
and SMPL parameters are rendered from the same model the framework
optimizes, so end-to-end tests have a known optimum.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..models.synthetic import make_synthetic_smpl
from ..models.smpl import smpl_forward, SMPLModel
from ..ops.cameras import project_points, intrinsics_from_fov


def _render_scene_depth(K, image_size, floor_y=1.0, wall_z=8.0):
    """Analytic depth of a floor plane (y=floor_y) + back wall
    (z=wall_z), per pixel."""
    W, H = image_size
    us, vs = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    # ray directions through pixels
    x = (us - K[0, 2]) / K[0, 0]
    y = (vs - K[1, 2]) / K[1, 1]
    # floor: y_cam * t = floor_y -> t = floor_y / y (y > 0 is down)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = np.where(y > 1e-3, floor_y / y, np.inf)
    z_floor = t_floor
    z = np.minimum(z_floor, wall_z)
    return z.astype(np.float32)


def generate_sequence(
    root: str,
    num_frames: int = 8,
    num_people: int = 2,
    image_size: Tuple[int, int] = (256, 256),
    fov: float = 60.0,
    seed: int = 0,
    model: Optional[SMPLModel] = None,
    num_vertices: int = 1024,
    mupots_gt: bool = False,
    track_dropout: float = 0.0,
    degradations: Optional[dict] = None,
    motion: Optional[dict] = None,
):
    """Write a synthetic sequence tree under `root`.

    Returns a dict with the ground-truth arrays (poses_T, poses_smpl,
    betas, scene depth, cam_K, and the model) for use in assertions.

    `degradations` (default None = the clean fixture used by the
    golden-accuracy sweeps) turns on adversarial input structure so
    the ingestion robustness machinery — inherited behavior-for-
    behavior from the reference — is exercised END-TO-END instead of
    only unit-tested (reference counterparts cited per key):

    * ``crossing_paths`` (bool): people swap sides over the sequence,
      so their projections CROSS — the nearer body occludes the
      farther one in the rendered depth/instance maps (overlapping
      masks, occlusion-ordered silhouettes; reference
      optimizer.py:209-232 renders occlusion-ordered too).
    * ``occlusion_conf`` (bool, default True when any degradation is
      on): AlphaPose joint confidences are depth-tested against the
      rendered scene — joints hidden behind a nearer person (or
      outside the frame) get low confidence, and detections with < 5
      confident joints are DROPPED like a real detector miss
      (exercises lagged-track imputation, datautils.py:326-333, and
      the in-frame visibility gate, datautils.py:441-447).
    * ``id_switch_spans`` (list of (t0, t1)): within each span the
      AlphaPose track ids of persons 0 and 1 are SWAPPED, emulating a
      tracker identity switch (exercises the velocity-gated Hungarian
      re-assignment, reference alphapose.py:119-262).
    * ``detection_dropout`` (float): per-(frame, person) probability
      of omitting the AlphaPose entry entirely.
    * ``romp_person_dropout`` (float): per-(frame, person) probability
      of omitting that person from the frame's ROMP npz (exercises
      SMPL nearest-valid-frame imputation, datautils.py:326-359).
    * ``romp_missing_frames`` (float): fraction of frames whose ROMP
      npz is EMPTY (zero detections).
    * ``enter_leave`` (bool): person 0 walks out of the camera
      frustum mid-sequence and returns (~15% of frames off-screen);
      its detections/ROMP rows vanish while it is out (exercises the
      low-visibility handling and per-frame validity gating without
      tripping the 1/8 min-visibility person drop,
      datautils.py:450-456).

    `motion` (default None = the standard clean kinematics) hardens
    the CLEAN tier without corrupting any input channel — the inputs
    stay noise-free, the TASK gets harder (round-4 verdict weak #4:
    a saturated 98.8-pck proxy cannot catch sub-point regressions):

    * ``speed`` (float, default 1.0): multiplies the temporal
      frequency of the trajectory sinusoids and the limb wave —
      larger inter-frame displacement stresses the velocity/
      filtered-verts regularizers' smoothing bias.
    * ``amp`` (float, default 1.0): multiplies the x/z drift
      amplitudes.
    * ``close_pair`` (bool): persons 0 and 1 weave within ~0.5 m at
      nearly equal depth, so their masks overlap for most of the
      sequence (combine with ``degradations={'occlusion_conf': True}``
      for detector-realistic confidences on the occluded joints).
    """
    import jax.numpy as jnp
    from PIL import Image

    rng = np.random.RandomState(seed)
    W, H = image_size
    K = intrinsics_from_fov(image_size, fov)

    if model is None:
        model = make_synthetic_smpl(num_vertices=num_vertices, seed=seed)

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for sub in ("AlphaPose", "DPT_large_monodepth", "ROMP_Predictions",
                "Mask2Former_Instances"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    deg = dict(degradations or {})
    occl_conf = deg.get("occlusion_conf", bool(deg))
    id_switch_spans = [tuple(s) for s in deg.get("id_switch_spans", [])]
    detection_dropout = float(deg.get("detection_dropout", 0.0)) \
        or track_dropout
    romp_person_dropout = float(deg.get("romp_person_dropout", 0.0))
    n_missing = int(round(float(deg.get("romp_missing_frames", 0.0))
                          * num_frames))
    romp_empty_frames = set(
        rng.choice(num_frames, size=n_missing, replace=False).tolist()
        if n_missing else [])

    mot = dict(motion or {})
    speed = float(mot.get("speed", 1.0))
    amp = float(mot.get("amp", 1.0))
    close_pair = bool(mot.get("close_pair", False))

    T, N = num_frames, num_people
    # Ground-truth trajectories: people at different depths drifting
    poses_T = np.zeros((T, N, 1, 3), np.float32)
    tt = np.linspace(0, 1, T)
    for n in range(N):
        z0 = 3.0 + 1.5 * n
        x0 = -0.8 + 1.6 * n / max(N - 1, 1)
        if close_pair and n < 2:
            # persons 0/1 weave within ~0.5 m at NEAR-EQUAL depth
            # (0.1 m offset: deep mutual occlusion with ambiguous z
            # order — the first 0.25 m/0.3-amp version measured
            # pck 99.3, not discriminative): persistent mask overlap,
            # crossing projections every half period
            z0 = 3.0 + 0.1 * n
            x0 = -0.25 + 0.5 * n
            poses_T[:, n, 0, 0] = x0 + (1 - 2 * n) * 0.4 * np.sin(
                2 * np.pi * speed * tt)
        elif deg.get("crossing_paths"):
            # swap sides over the sequence: projections cross near the
            # midpoint, the nearer person occluding the farther one
            poses_T[:, n, 0, 0] = x0 + (-2 * x0) * tt \
                + 0.1 * amp * np.sin(2 * np.pi * speed * tt + n)
        else:
            poses_T[:, n, 0, 0] = x0 + 0.3 * amp * np.sin(
                2 * np.pi * speed * tt + n)
        poses_T[:, n, 0, 1] = 0.35  # pelvis height above origin
        poses_T[:, n, 0, 2] = z0 + 0.4 * amp * np.cos(
            2 * np.pi * speed * tt + n)
    if deg.get("enter_leave"):
        # person 0 walks out of the frustum and back: a smooth x bump
        # over ~15% of the frames mid-sequence (at z ~= 3 the FOV-60
        # half-width is ~1.7 m; +4 m is far off-screen). The bump is
        # sampled at span MIDPOINTS and normalized to peak 1.0, so it
        # reaches full off-screen amplitude at EVERY span length
        # (linspace(0, pi, 2) hits only the sine's zero endpoints —
        # a silent no-op at short T, caught by self-review round 4).
        t0, t1 = int(0.40 * T), max(int(0.40 * T) + 2, int(0.55 * T))
        bump = np.zeros(T, np.float32)
        frac = (np.arange(t1 - t0) + 0.5) / (t1 - t0)
        b = np.sin(np.pi * frac) ** 2
        bump[t0:t1] = b / b.max()
        poses_T[:, 0, 0, 0] += 4.0 * bump

    poses_smpl = np.zeros((T, N, 72), np.float32)
    # wave arms / legs
    for n in range(N):
        phase = rng.rand() * np.pi
        sw = np.sin(np.linspace(0, 4 * np.pi * speed, T) + phase)
        poses_smpl[:, n, 18 * 3 + 1] = -0.8 * sw
        poses_smpl[:, n, 19 * 3 + 1] = 0.8 * sw
        poses_smpl[:, n, 4 * 3] = 0.4 * sw
        poses_smpl[:, n, 5 * 3] = -0.4 * sw
    betas = 0.5 * rng.randn(1, N, 10).astype(np.float32)
    betas_t = np.tile(betas, (T, 1, 1))

    out = smpl_forward(
        model,
        jnp.asarray(betas_t.reshape(T * N, 10)),
        jnp.asarray(poses_smpl.reshape(T * N, 72)))
    verts = np.asarray(out["verts"]).reshape(T, N, -1, 3) + poses_T
    joints_ap = np.asarray(out["joints_alphapose"]).reshape(T, N, -1, 3) \
        + poses_T

    scene_z = _render_scene_depth(K, image_size)

    # ONE batched projection for all T*N bodies and joint sets instead
    # of one device call per (frame, person)
    uvz_all = np.asarray(project_points(
        jnp.asarray(verts.reshape(T * N, -1, 3)), jnp.asarray(K),
        return_depth=True)).reshape(T, N, -1, 3)
    uv_j_all = np.asarray(project_points(
        jnp.asarray(joints_ap.reshape(T * N, -1, 3)),
        jnp.asarray(K))).reshape(T, N, -1, 2)

    # Per-frame rendering: z-buffer by splatting
    alphapose_json = []
    annot_list = []
    for t in range(T):
        depth = scene_z.copy()
        inst = np.zeros((H, W), np.uint8)
        img = np.full((H, W, 3), 200, np.uint8)
        img[depth >= 7.99] = (160, 170, 180)  # wall tint

        order = np.argsort(-poses_T[t, :, 0, 2])  # far to near
        for n in order:
            uvz = uvz_all[t, n]
            us = np.round(uvz[:, 0]).astype(int)
            vs = np.round(uvz[:, 1]).astype(int)
            ok = (us >= 0) & (us < W) & (vs >= 0) & (vs < H) \
                & (uvz[:, 2] > 0.5)
            # splat 2x2 to close holes
            for du in (0, 1):
                for dv in (0, 1):
                    u2 = np.clip(us[ok] + du, 0, W - 1)
                    v2 = np.clip(vs[ok] + dv, 0, H - 1)
                    closer = uvz[ok, 2] < depth[v2, u2]
                    depth[v2[closer], u2[closer]] = uvz[ok, 2][closer]
                    inst[v2[closer], u2[closer]] = n + 1
                    img[v2[closer], u2[closer]] = (
                        60 + 60 * n, 90, 200 - 50 * n)

        # normalized inverse depth, like DPT output (16-bit PNG)
        disp = 1.0 / np.clip(depth, 0.5, 50.0)
        disp01 = (disp - disp.min()) / (disp.max() - disp.min())
        disp16 = (disp01 * 65535).astype(np.uint16)

        name = f"img_{t:06d}"
        Image.fromarray(img).save(
            os.path.join(root, "images", name + ".jpg"), quality=92)
        Image.fromarray(disp16).save(
            os.path.join(root, "DPT_large_monodepth", name + ".png"))
        Image.fromarray(inst).save(
            os.path.join(root, "Mask2Former_Instances", name + ".png"))

        # AlphaPose entries (17 COCO keypoints ~ our joints_alphapose)
        in_switch_span = any(t0 <= t < t1 for t0, t1 in id_switch_spans)
        for n in range(N):
            if detection_dropout > 0 and rng.rand() < detection_dropout:
                continue
            uv = uv_j_all[t, n]
            if occl_conf:
                # depth-test each joint against the rendered frame: a
                # joint behind a nearer surface (another person) or
                # outside the image gets detector-miss confidence
                ju = np.round(uv[:, 0]).astype(int)
                jv = np.round(uv[:, 1]).astype(int)
                inside = (ju >= 0) & (ju < W) & (jv >= 0) & (jv < H)
                jz = joints_ap[t, n, :, 2]
                zbuf = depth[np.clip(jv, 0, H - 1),
                             np.clip(ju, 0, W - 1)]
                occluded = inside & (zbuf < jz - 0.3)
                conf = np.where(inside & ~occluded, 0.95,
                                np.where(occluded, 0.25, 0.0))
                if int((conf > 0.5).sum()) < 5:
                    continue  # a real detector would miss this person
                kpts = np.concatenate([uv, conf[:, None]], axis=1)
            else:
                kpts = np.concatenate(
                    [uv, 0.95 * np.ones((len(uv), 1))], axis=1)
            idx = n + 1
            if in_switch_span and n in (0, 1) and N >= 2:
                idx = 2 - n  # swap the track ids of persons 0 and 1
            alphapose_json.append({
                "image_id": name + ".jpg",
                "category_id": 1,
                "keypoints": [float(v) for v in kpts.reshape(-1)],
                "score": 2.5,
                "idx": idx,
            })

        # ROMP npz (new single-dict format), slightly noisy params
        cam = np.zeros((N, 3), np.float32)
        for n in range(N):
            # weak-persp cam roughly consistent with the projection
            z = poses_T[t, n, 0, 2]
            f = K[0, 0]
            s = 2 * f / (max(image_size) * z)
            cam[n] = (s,
                      2 * f * poses_T[t, n, 0, 0] / (max(image_size) * z)
                      + 2 * K[0, 2] / max(image_size) - W / max(image_size),
                      2 * f * poses_T[t, n, 0, 1] / (max(image_size) * z)
                      + 2 * K[1, 2] / max(image_size) - H / max(image_size))
        present = np.ones(N, bool)
        if t in romp_empty_frames:
            present[:] = False
        elif romp_person_dropout > 0 or deg.get("enter_leave"):
            for n in range(N):
                if romp_person_dropout > 0 \
                        and rng.rand() < romp_person_dropout:
                    present[n] = False
                # a person fully outside the frustum is never detected
                u_c = uv_j_all[t, n, :, 0]
                if u_c.min() > W + 5 or u_c.max() < -5:
                    present[n] = False
        np.savez(
            os.path.join(root, "ROMP_Predictions", name + ".npz"),
            results={
                "cam": cam[present],
                "smpl_thetas": (poses_smpl[t]
                                + 0.02 * rng.randn(N, 72)
                                .astype(np.float32))[present],
                "smpl_betas": (betas[0]
                               + 0.02 * rng.randn(N, 10)
                               .astype(np.float32))[present],
            })

    with open(os.path.join(root, "AlphaPose",
                           "alphapose-results.json"), "w") as f:
        json.dump(alphapose_json, f)

    if mupots_gt:
        _write_mupots_gt(root, K, poses_T, betas_t, poses_smpl, model,
                         image_size)

    return {
        "model": model,
        "cam_K": K,
        "poses_T": poses_T,
        "poses_smpl": poses_smpl,
        "betas": betas,
        "scene_depth": scene_z,
        "image_size": image_size,
    }


def _write_mupots_gt(root, K, poses_T, betas_t, poses_smpl, model,
                     image_size):
    """Write annot.mat / occlusion.mat / intrinsics.txt in the MuPoTs
    layout read by the reference (datautils.py:27-40,
    predict_mupots.py:64-73)."""
    import jax.numpy as jnp
    import scipy.io as sio

    T, N = poses_T.shape[:2]
    out = smpl_forward(
        model,
        jnp.asarray(betas_t.reshape(T * N, 10)),
        jnp.asarray(poses_smpl.reshape(T * N, 72)))
    j17 = np.asarray(out["joints_mupots"]).reshape(T, N, 17, 3) + poses_T

    annot = np.empty((T, N), object)
    occl = np.empty((T, N), object)
    for t in range(T):
        for n in range(N):
            entry = np.empty((1, 1), object)
            # MuPoTs annot3 is (3, 17) in millimeters
            rec = np.rec.fromarrays(
                [np.empty((1, 1), object), np.empty((1, 1), object)],
                names=["annot3", "univ_annot3"])
            rec["annot3"][0, 0] = (1000.0 * j17[t, n].T)
            rec["univ_annot3"][0, 0] = (1000.0 * j17[t, n].T)
            entry[0, 0] = rec
            annot[t, n] = rec
            occl[t, n] = np.zeros((17, 1), np.uint8).T
    sio.savemat(os.path.join(root, "images", "annot.mat"),
                {"annotations": annot})
    sio.savemat(os.path.join(root, "images", "occlusion.mat"),
                {"occlusion_labels": occl})
    with open(os.path.join(root, "images", "intrinsics.txt"), "w") as f:
        for row in K:
            f.write(" ".join(str(float(v)) for v in row) + "\n")
