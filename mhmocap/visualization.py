"""Visualization entry point.

Parity with `python -m mhmocap.visualization` (reference
visualization.py:847-930): reloads `optvar_stage1.pkl` +
`visualization_data_stage1.pkl`, bilateral-filters the scene depth,
re-runs SMPL to rebuild the vertices, and opens the interactive 3D
viewer (Open3D) or, headless, exports PLY/render artifacts into
`<input_path>/viz3d/`.

Usage:
    python -m mhmocap.visualization \
        --configs_yml configs/predict_mupots.yml \
        --input_path ./output/mupots/TS1
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import jax.numpy as jnp

from .config import ConfigContext, parse_args
from .models.loader import resolve_smpl_model
from .models.smpl import smpl_forward
from .ops.image import bilateral_filter
from .viz.viewer3d import (HAVE_OPEN3D, SceneHumansVisualizer,
                           SkeletonVisualizer)


def main(argv=None):
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    with ConfigContext(parsed):
        base = parsed.input_path or parsed.output_path
        with open(os.path.join(base, "optvar_stage1.pkl"), "rb") as f:
            optvar = pickle.load(f)
        with open(os.path.join(base,
                               "visualization_data_stage1.pkl"),
                  "rb") as f:
            vis_data = pickle.load(f)

        model = resolve_smpl_model(
            parsed.smpl["smpl_model_parameters_path"])

        # scene depth smoothing (reference visualization.py:906-908)
        scene_depth = optvar.get("scene_depth")
        if scene_depth is None:
            scene_depth = np.median(vis_data["depths"], axis=0)
        scene_depth = np.asarray(bilateral_filter(
            jnp.asarray(scene_depth.astype(np.float32)), d=9,
            sigma_color=0.05, sigma_space=25.0))
        scene_img = optvar.get("scene_img")
        if scene_img is None:
            scene_img = np.median(vis_data["images"], axis=0).astype(
                np.uint8)
        scene_mask = optvar.get("scene_mask")
        if scene_mask is None:
            scene_mask = np.ones(scene_depth.shape, np.float32)

        # rebuild vertices from the optimized parameters
        T, N = optvar["poses_smpl"].shape[:2]
        out = smpl_forward(
            model,
            jnp.asarray(np.tile(optvar["betas_smpl"],
                                (T, 1, 1)).reshape(-1, 10)),
            jnp.asarray(optvar["poses_smpl"].reshape(-1, 72)))
        verts = (np.asarray(out["verts"]).reshape(T, N, -1, 3)
                 * optvar["scale_factor"] + optvar["poses_T"])

        mode = getattr(parsed, "viz_mode", "scene") or "scene"
        cap_color = bool(getattr(parsed, "capture_rendered_color",
                                 False))
        cap_depth = bool(getattr(parsed, "capture_rendered_depth",
                                 False))
        capture_dir = os.path.join(base, "viz3d_frames")

        if mode == "skeleton":
            # skeleton view of the regressed MuPoTs joints
            joints = (np.asarray(out["joints_mupots"]).reshape(
                T, N, -1, 3) * optvar["scale_factor"]
                + optvar["poses_T"])
            vis15 = np.ones(joints.shape[:3] + (1,), np.float32)
            viewer = SkeletonVisualizer(
                vis_data["cam"], joints, vis15,
                output_path=capture_dir,
                capture_rendered_color=cap_color)
        else:
            viewer = SceneHumansVisualizer(
                scene_img, scene_depth, vis_data["cam"],
                vertices=verts, faces=np.asarray(model.faces),
                valid_vertices=vis_data.get("valid"),
                scene_mask=scene_mask,
                output_path=capture_dir,
                capture_rendered_color=cap_color,
                capture_rendered_depth=cap_depth,
                show_coordinate_axis=False)
        if HAVE_OPEN3D and os.environ.get("DISPLAY"):
            viewer.run()
        else:
            out_dir = viewer.export(os.path.join(base, "viz3d"))
            print("Headless: 3D artifacts exported to", out_dir)


if __name__ == "__main__":
    main()
