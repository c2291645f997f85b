"""MuPoTs evaluation entry point.

Parity with reference `mhmocap/eval_mupots.py.__main__`: loops
TS1..TS20 under --input_path, reloads the prediction pickles, and
writes FinalResults.json / FinalResults.md.

Usage:
    python -m mhmocap.eval_mupots \
        --configs_yml configs/eval_mupots.yml \
        --input_path ./output/mupots [--ts_id -1]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax.numpy as jnp

from .cache import enable_compile_cache
from .config import ConfigContext, parse_args
from .data import mupots
from .eval.mupots_eval import evaluate_mupots, MUPOTS_NUM_INSTANCES
from .models.loader import resolve_smpl_model
from .models.smpl import smpl_forward


def main(argv=None):
    enable_compile_cache()
    parsed = parse_args(argv if argv is not None else sys.argv[1:])
    with ConfigContext(parsed):
        model = resolve_smpl_model(
            parsed.smpl["smpl_model_parameters_path"])

        def joints_fn(betas, poses):
            out = smpl_forward(model, jnp.asarray(betas),
                               jnp.asarray(poses))
            return np.asarray(out["joints_mupots"])

        data_path = parsed.data["data_path"]
        resize = parsed.resize_factor

        # available sequences: all TS dirs under input_path with pickles
        ts_ids = []
        for i in range(1, 21):
            if os.path.exists(os.path.join(parsed.input_path, f"TS{i}",
                                           "optvar_stage1.pkl")):
                ts_ids.append(i)
        if not ts_ids:
            raise FileNotFoundError(
                f"no TS*/optvar_stage1.pkl under {parsed.input_path}")

        cam_per_ts = {}
        for i in ts_ids:
            # Prefer the working-resolution intrinsics stored by
            # predict_mupots; fall back to re-reading the dataset's
            # intrinsics.txt and rescaling.
            annot_pkl = os.path.join(parsed.input_path, f"TS{i}",
                                     "mupots_annot.pkl")
            K = None
            if os.path.exists(annot_pkl):
                import pickle
                with open(annot_pkl, "rb") as f:
                    K = pickle.load(f).get("cam_K")
            if K is None:
                _, _, K = mupots.load_sequence_metadata(
                    os.path.join(data_path, f"TS{i}", "images"))
                K = resize * K
                K[2, 2] = 1.0
            cam_per_ts[i] = np.asarray(K, np.float32)

        final = evaluate_mupots(
            parsed.input_path, joints_fn, cam_per_ts, ts_ids=ts_ids,
            num_instances=[MUPOTS_NUM_INSTANCES[i - 1] for i in ts_ids])
        print("FinalResults written to", parsed.input_path)
        for k, v in final.items():
            print(f"  {k}: avg={v[-1]:.2f}")


if __name__ == "__main__":
    main()
