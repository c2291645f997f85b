"""Per-frame matched-jitter decomposition against the stale mask.

The degraded tier's jitter has THREE distinct homes (docs/PARITY.md):
frames INSIDE a detection gap (unobserved — a post-fit pass may fix
them), the OBSERVED frames FLANKING a gap (smeared during the fit by
the temporal regularizers — only `gap_aware_temporal` can treat
them), and ID-switch transients (wrong person's real evidence —
`id_swap_fix` territory). This script classifies every frame of one
sequence and prints the per-class means plus the top spike frames, so
a knob's effect lands on the class it claims to treat.

Usage:
    python script/decompose_jitter.py --workdir /tmp/..._gaptemporal \
        [--ts 4] [--top 8]

Reads `<workdir>/predict.yml` + `<workdir>/out/TS<ts>` (the sweep's
layout). Re-ingests the sequence on CPU when the prediction pickle
predates the `lagged_tn` audit field.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def frame_jitter_mm(m: dict) -> np.ndarray:
    """(T,) masked mean matched jitter in mm (eval.metrics arrays)."""
    j, v = m["abs_jitter"], m["valid_joints"]
    num = (j * v).sum(axis=(1, 2))
    den = np.maximum(v.sum(axis=(1, 2)), 1.0)
    return 1000.0 * num / den


def classify_frames(stale_tn: np.ndarray) -> np.ndarray:
    """(T,) class per frame: 0 = clear, 1 = inside a gap (any person
    stale), 2 = observed flank (no person stale at t, but some person
    stale at t-1 or t+1 — the during-fit smear target)."""
    any_stale = stale_tn.any(axis=1)
    T = any_stale.shape[0]
    cls = np.zeros(T, np.int64)
    cls[any_stale] = 1
    prev_stale = np.concatenate([[False], any_stale[:-1]])
    next_stale = np.concatenate([any_stale[1:], [False]])
    flank = ~any_stale & (prev_stale | next_stale)
    cls[flank] = 2
    return cls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--ts", type=int, default=4)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        from mhmocap.cache import cpu_cache_dir
        jax.config.update("jax_compilation_cache_dir",
                          cpu_cache_dir(REPO))
    import jax.numpy as jnp

    from mhmocap.config import ConfigContext, parse_args
    from mhmocap.eval.metrics import pose_error_3dproj
    from mhmocap.models.smpl import smpl_forward
    from mhmocap.predict_mupots import build_mupots_sequence

    out_dir = os.path.join(args.workdir, "out", f"TS{args.ts}")
    with open(os.path.join(out_dir, "optvar_stage1.pkl"), "rb") as f:
        optvar = pickle.load(f)
    with open(os.path.join(out_dir, "mupots_annot.pkl"), "rb") as f:
        annot = pickle.load(f)

    # NOTE: --input_path overrides data['data_path'] (config.py:81),
    # so don't pass it — the yml's data_path points at the trees
    parsed = parse_args(["--configs_yml",
                         os.path.join(args.workdir, "predict.yml"),
                         "--ts_id", str(args.ts)])
    with ConfigContext(parsed):
        kargs = dict(parsed.smpl)
        kargs.update(parsed.data)
        stale = optvar.get("lagged_tn")
        if stale is None:
            # pickle predates the audit field: re-ingest for the mask
            seq, model, *_ = build_mupots_sequence(
                ts_id=args.ts, resize_factor=parsed.resize_factor,
                **kargs)
            stale = np.asarray(seq.lagged_tn)
        else:
            from mhmocap.models.loader import resolve_smpl_model
            model = resolve_smpl_model(
                kargs["smpl_model_parameters_path"])

        def joints_fn(betas, poses):
            out = smpl_forward(model, jnp.asarray(betas),
                               jnp.asarray(poses))
            return np.asarray(out["joints_mupots"])

        m = pose_error_3dproj(
            optvar, annot["pose3d_gt"], annot["visibility"],
            joints_fn, np.asarray(annot["cam_K"], np.float32))

    jmm = frame_jitter_mm(m)
    cls = classify_frames(stale.astype(bool))
    names = {0: "clear", 1: "gap", 2: "flank"}

    spans = []
    for n in range(stale.shape[1]):
        on = np.flatnonzero(stale[:, n])
        if on.size:
            cuts = np.split(on, np.flatnonzero(np.diff(on) > 1) + 1)
            spans += [f"p{n}[{c[0]}..{c[-1]}]" for c in cuts]
    print(f"TS{args.ts}: {stale.shape[0]} frames, "
          f"{int(stale.sum())} stale person-frames "
          f"({' '.join(spans) if spans else 'none'})")

    per_class = {}
    for c, name in names.items():
        sel = cls == c
        per_class[name] = {
            "frames": int(sel.sum()),
            "mean_jitter_mm": round(float(jmm[sel].mean()), 2)
            if sel.any() else None,
            "max_jitter_mm": round(float(jmm[sel].max()), 2)
            if sel.any() else None,
        }
    order = np.argsort(-jmm)[:args.top]
    print(f"{'t':>4} {'jitter_mm':>10}  class")
    for t in order:
        print(f"{t:>4} {jmm[t]:>10.1f}  {names[int(cls[t])]}")
    print(json.dumps({"metric": "jitter_decomposition",
                      "ts": args.ts, "per_class": per_class,
                      "top": [[int(t), round(float(jmm[t]), 1),
                               names[int(cls[t])]] for t in order]}))


if __name__ == "__main__":
    main()
