"""Golden-file tests for the exact on-disk input contracts.

Each test hand-constructs files in the reference's formats (survey
§2.4; reference datautils.py:27-40,57-110,129-157) — independently of
mhmocap.data.synthetic — and checks the loaders reproduce known
values. This is the format half of the reference-parity story
(docs/PARITY.md); the numeric half needs the real MuPoTs data + GPU.
"""

import json
import os

import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

from mhmocap.data import mupots
from mhmocap.data.ingestion import (load_disparity_maps,
                                        load_segmentation_maps,
                                        split_instance_masks)
from mhmocap.data.romp import load_romp_prediction


# ---------------------------------------------------------------------------
# MuPoTs metadata: annot.mat / occlusion.mat / intrinsics.txt
# ---------------------------------------------------------------------------

def _write_mupots_metadata(root, T=3, K=2):
    """MATLAB-struct layout as MuPoTs ships it: annotations (T, K) cell
    of structs with (3, 17) annot3/univ_annot3 in millimeters;
    occlusion_labels (T, K) cell of (1, 17) int flags."""
    rng = np.random.RandomState(0)
    annot3 = rng.uniform(-2000, 2000, size=(T, K, 3, 17))
    occl = (rng.uniform(size=(T, K, 1, 17)) < 0.3).astype(np.uint8)

    ann_cells = np.empty((T, K), dtype=object)
    occ_cells = np.empty((T, K), dtype=object)
    for f in range(T):
        for i in range(K):
            ann_cells[f, i] = {
                "annot3": annot3[f, i],
                "univ_annot3": 1.1 * annot3[f, i],
            }
            occ_cells[f, i] = occl[f, i]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    sio.savemat(os.path.join(root, "images", "annot.mat"),
                {"annotations": ann_cells})
    sio.savemat(os.path.join(root, "images", "occlusion.mat"),
                {"occlusion_labels": occ_cells})
    cam_K = np.array([[1500.5, 0.0, 1024.0],
                      [0.0, 1500.9, 1024.5],
                      [0.0, 0.0, 1.0]], np.float32)
    with open(os.path.join(root, "images", "intrinsics.txt"), "w") as f:
        for row in cam_K:
            f.write(" ".join(str(v) for v in row) + "\n")
    return annot3, occl, cam_K


def test_mupots_metadata_roundtrip(tmp_path):
    root = str(tmp_path)
    annot3, occl, cam_K = _write_mupots_metadata(root)
    annot, occ, K = mupots.load_sequence_metadata(
        os.path.join(root, "images"))
    np.testing.assert_allclose(K, cam_K)
    assert annot.shape == (3, 2)

    gt, gt_univ, vis = mupots.slice_ground_truth(annot, occ,
                                                 frame_ids=[0, 2])
    # mm -> m, (3, 17) -> (17, 3) transpose (predict_mupots.py:64-73)
    np.testing.assert_allclose(gt[0, 1], annot3[0, 1].T / 1000.0,
                               rtol=1e-6)
    np.testing.assert_allclose(gt[1, 0], annot3[2, 0].T / 1000.0,
                               rtol=1e-6)
    np.testing.assert_allclose(gt_univ[0, 0],
                               1.1 * annot3[0, 0].T / 1000.0, rtol=1e-6)
    # occlusion -> visibility inversion
    np.testing.assert_array_equal(vis[0, 0, :, 0],
                                  (occl[0, 0, 0] == 0).astype(np.float32))


# ---------------------------------------------------------------------------
# DPT 16-bit disparity PNGs
# ---------------------------------------------------------------------------

def test_disparity_png_16bit_minmax_normalization(tmp_path):
    """datautils.py:57-80: 16-bit PNG read + min-max normalization."""
    raw = np.zeros((8, 8), np.uint16)
    raw[2, 3] = 40000
    raw[5, 5] = 10000
    raw[0, 0] = 5000
    path = str(tmp_path / "img_000000.png")
    Image.fromarray(raw).save(path)      # PIL picks I;16 for uint16

    out = load_disparity_maps([path], (8, 8), post_process=False)
    assert out.shape == (1, 8, 8) and out.dtype == np.float32
    expect = (raw.astype(np.float32) - 0.0) / 40000.0
    np.testing.assert_allclose(out[0], expect, atol=1e-6)
    assert out.min() == 0.0 and out.max() == 1.0


# ---------------------------------------------------------------------------
# Mask2Former instance PNGs
# ---------------------------------------------------------------------------

def test_instance_png_split_and_background(tmp_path):
    """uint8 labels: 0 = background, i = person i (survey §2.4)."""
    inst = np.zeros((16, 16), np.uint8)
    inst[2:8, 2:8] = 1
    inst[9:15, 9:15] = 2
    path = str(tmp_path / "img_000000.png")
    Image.fromarray(inst).save(path)

    loaded, back = load_segmentation_maps([path], (16, 16),
                                          fg_erode_iters=0,
                                          bg_erode_iters=0)
    np.testing.assert_array_equal(loaded[0], inst)
    np.testing.assert_array_equal(back[0], (inst == 0))

    masks = split_instance_masks(loaded)
    assert masks.shape == (1, 2, 16, 16)
    np.testing.assert_array_equal(masks[0, 0], (inst == 1))
    np.testing.assert_array_equal(masks[0, 1], (inst == 2))


# ---------------------------------------------------------------------------
# ROMP npz: BOTH format generations (datautils.py:129-157)
# ---------------------------------------------------------------------------

def _person(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3).astype(np.float32),
            rng.randn(72).astype(np.float32),
            rng.randn(10).astype(np.float32))


def test_romp_new_format(tmp_path):
    """ROMP >= 1.0.6: results = one dict of stacked arrays with
    cam/smpl_thetas/smpl_betas keys."""
    c0, p0, b0 = _person(1)
    c1, p1, b1 = _person(2)
    path = str(tmp_path / "img_000000.npz")
    np.savez(path, results={
        "cam": np.stack([c0, c1]),
        "smpl_thetas": np.stack([p0, p1]),
        "smpl_betas": np.stack([b0, b1]),
    })
    out = load_romp_prediction(path)
    assert out["cam"].shape == (2, 3)
    np.testing.assert_allclose(out["poses"][1], p1)
    np.testing.assert_allclose(out["betas"][0], b0)


def test_romp_old_format(tmp_path):
    """old ROMP: results = array of per-person dicts with
    cam/poses/betas keys."""
    c0, p0, b0 = _person(3)
    c1, p1, b1 = _person(4)
    results = np.array([
        {"cam": c0, "poses": p0, "betas": b0},
        {"cam": c1, "poses": p1, "betas": b1},
    ], dtype=object)
    path = str(tmp_path / "img_000000.npz")
    np.savez(path, results=results)
    out = load_romp_prediction(path)
    assert out["poses"].shape == (2, 72)
    np.testing.assert_allclose(out["cam"][1], c1)
    np.testing.assert_allclose(out["poses"][0], p0)
    np.testing.assert_allclose(out["betas"][1], b1)


def test_romp_extra_betas_truncated(tmp_path):
    """BEV-style 11-coefficient betas are truncated to 10."""
    c0, p0, _ = _person(5)
    b11 = np.arange(11, dtype=np.float32)
    path = str(tmp_path / "img_000000.npz")
    np.savez(path, results={
        "cam": c0[None], "smpl_thetas": p0[None],
        "smpl_betas": b11[None]})
    out = load_romp_prediction(path)
    assert out["betas"].shape == (1, 10)
    np.testing.assert_allclose(out["betas"][0], b11[:10])


# ---------------------------------------------------------------------------
# AlphaPose results JSON
# ---------------------------------------------------------------------------

def test_alphapose_json_contract(tmp_path):
    """alphapose-results.json: list of {image_id, category_id,
    keypoints (17*3 flat), idx, score} (reference alphapose.py:8-55)."""
    from mhmocap.data.alphapose import (load_tracking_results,
                                            tracks_to_array)

    kpts = np.zeros((17, 3), np.float32)
    kpts[:, 0] = np.linspace(10, 30, 17)
    kpts[:, 1] = np.linspace(5, 55, 17)
    kpts[:, 2] = 0.9
    conf_pad = np.zeros((17, 3), np.float32)   # all-low-confidence det
    conf_pad[:, 2] = 0.1
    entries = [
        {"image_id": "img_000000.jpg", "category_id": 1,
         "keypoints": kpts.reshape(-1).tolist(), "score": 2.0,
         "idx": 1.0},
        {"image_id": "img_000000.jpg", "category_id": 3,   # not person
         "keypoints": (kpts + 5).reshape(-1).tolist(), "score": 2.0,
         "idx": 2.0},
        {"image_id": "img_000000.jpg", "category_id": 1,   # low conf
         "keypoints": conf_pad.reshape(-1).tolist(), "score": 2.0,
         "idx": 3.0},
        {"image_id": "img_000001.jpg", "category_id": 1,
         "keypoints": (kpts + 1).reshape(-1).tolist(), "score": 2.0,
         "idx": 1.0},
    ]
    path = str(tmp_path / "alphapose-results.json")
    with open(path, "w") as f:
        json.dump(entries, f)

    annot = load_tracking_results(path)
    # category filter + confidence gate leave one person per frame
    assert set(annot.keys()) == {"img_000000.jpg", "img_000001.jpg"}
    assert len(annot["img_000000.jpg"]) == 1

    pose2d = tracks_to_array(annot)
    assert pose2d.shape == (2, 1, 17, 3)
    np.testing.assert_allclose(pose2d[0, 0], kpts, atol=1e-5)
    np.testing.assert_allclose(pose2d[1, 0], kpts + 1, atol=1e-5)


def test_shipped_configs_parse_through_loader():
    """Every configs/*.yml must parse through the real argparse+YAML
    merge (config.py parity loader); the round-5 robust profile must
    land its two degraded-input knobs where the entry points read
    them (ARGS attribute for gap_aware_temporal, data group for the
    ingestion knob) — the measured A/B retired lagged_conf_decay and
    gap_interpolate from the bundle (docs/PARITY.md section 5) — and
    the reference-parity profile must leave every knob at its off
    default."""
    import glob as _glob
    from mhmocap.config import PROJECT_DIR, parse_args

    ymls = sorted(_glob.glob(os.path.join(PROJECT_DIR, "configs", "*.yml")))
    assert len(ymls) >= 4
    for yml in ymls:
        parsed = parse_args(["--configs_yml", yml])
        assert parsed.resize_factor > 0

    robust = parse_args(["--configs_yml",
                         os.path.join(PROJECT_DIR, "configs",
                                      "predict_mupots_robust.yml")])
    assert robust.gap_aware_temporal is True
    assert robust.data["id_swap_fix"] == 0.5
    assert getattr(robust, "gap_interpolate", False) is False
    assert "lagged_conf_decay" not in robust.data

    parity = parse_args(["--configs_yml",
                         os.path.join(PROJECT_DIR, "configs",
                                      "predict_mupots.yml")])
    assert getattr(parity, "gap_interpolate", False) is False
    assert "lagged_conf_decay" not in parity.data
    assert "id_swap_fix" not in parity.data
