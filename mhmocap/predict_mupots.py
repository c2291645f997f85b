"""MuPoTs prediction entry point.

Parity with reference `mhmocap/predict_mupots.py`: builds the MuPoTs
sequence (annot.mat / occlusion.mat / intrinsics.txt + the four input
modalities), runs the two-stage optimization, and pickles
`mupots_annot.pkl` next to the optvar outputs.

Usage:
    python -m mhmocap.predict_mupots \
        --configs_yml configs/predict_mupots.yml --ts_id 1 \
        --output_path ./output/mupots
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import jax
import jax.numpy as jnp

from .cache import enable_compile_cache
from .config import ConfigContext, parse_args
from .data import mupots
from .data.ingestion import load_sequence
from .engine.predictor import Predictor
from .models.loader import resolve_smpl_model
from .models.smpl import smpl_forward


def build_mupots_sequence(
    data_path, ts_id, smpl_model_parameters_path,
    resize_factor=1.0, start_frame=0, end_frame=-1, step_frame=1,
    cam_K=None,
    use_hrnet_pose=True,
    joint_confidence_thr=0.49,
    depth_path="DPT_midas21_monodepth",
    erode_segmentation_iters=0,
    erode_backmask_iters=0,
    renormalize_depth=True,
    post_process_depth=True,
    filter_2dpose=True,
    filter_min_cutoff=0.01,
    filter_beta=25,
    lagged_conf_decay=1.0,
    id_swap_fix=0.0,
    **_,
):
    """Ingest one MuPoTs TS sequence + its GT (reference
    predict_mupots.py:15-75). Returns (seq, model, pose3d_gt,
    pose3d_univ_gt, visibility)."""
    data_root = os.path.join(data_path, f"TS{ts_id}")
    annot, occl, cam_K_ts = mupots.load_sequence_metadata(
        os.path.join(data_root, "images"))
    if cam_K is None:
        cam_K = cam_K_ts

    end = annot.shape[0] if end_frame <= -1 else end_frame
    frame_ids = list(range(start_frame, end, step_frame))

    model = resolve_smpl_model(smpl_model_parameters_path)

    # jitted with the model as a traced argument (closure constants
    # would ship the 25 MB of weights inside the HLO); ingestion calls
    # this ONCE with all T*N bodies bucketed to a multiple of 512, so
    # the compile is shared across sequences via the persistent cache
    jfn = jax.jit(lambda m, b, p: smpl_forward(m, b, p)[
        "joints_alphapose"])

    def joints_fn(betas, poses):
        return np.asarray(jfn(model, jnp.asarray(betas),
                              jnp.asarray(poses)))

    seq = load_sequence(
        data_root, joints_fn,
        cam_K=cam_K,
        frame_ids=frame_ids,
        resize_factor=resize_factor,
        use_hrnet_pose=use_hrnet_pose,
        joint_confidence_thr=joint_confidence_thr,
        depth_path=depth_path,
        erode_segmentation_iters=erode_segmentation_iters,
        erode_backmask_iters=erode_backmask_iters,
        renormalize_depth=renormalize_depth,
        post_process_depth=post_process_depth,
        filter_2dpose=filter_2dpose,
        filter_min_cutoff=filter_min_cutoff,
        filter_beta=filter_beta,
        lagged_conf_decay=lagged_conf_decay,
        id_swap_fix=id_swap_fix,
    )
    pose3d_gt, pose3d_univ_gt, visibility = mupots.slice_ground_truth(
        annot, occl, frame_ids)
    return seq, model, pose3d_gt, pose3d_univ_gt, visibility


def main(argv=None):
    enable_compile_cache()
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    with ConfigContext(parsed):
        kargs = dict(parsed.smpl)
        kargs.update(parsed.data)
        output_path = os.path.join(parsed.output_path,
                                   f"TS{parsed.ts_id}")
        print("Info: writing output to", output_path)

        seq, model, p3d, p3d_univ, vis = build_mupots_sequence(
            ts_id=parsed.ts_id,
            resize_factor=parsed.resize_factor,
            erode_segmentation_iters=parsed.erode_segmentation_iters,
            erode_backmask_iters=parsed.erode_backmask_iters,
            renormalize_depth=parsed.renormalize_depth,
            post_process_depth=parsed.post_process_depth,
            **kargs)

        predictor = Predictor(seq, model, output_path=output_path,
                              parsed_args=parsed)
        result = predictor.run()

        with open(os.path.join(output_path, "mupots_annot.pkl"),
                  "wb") as f:
            pickle.dump({
                "pose3d_gt": p3d,
                "pose3d_univ_gt": p3d_univ,
                "visibility": vis,
                # additive extension vs the reference schema: the
                # working-resolution intrinsics, so evaluation does not
                # need to re-ingest the dataset (the reference's eval
                # re-reads intrinsics.txt from the data tree).
                "cam_K": seq.cam["K"],
            }, f)
    return result


if __name__ == "__main__":
    main()
