"""Self-contained synthetic end-to-end accuracy sweep.

Generates N synthetic MuPoTs-format sequence trees (full 6890-vertex
body, GT annot.mat/occlusion.mat/intrinsics.txt in the reference's
on-disk layout), runs each through the REAL production stack —
`mhmocap.predict_mupots` (ingestion, init solve, stage-1 cycles)
via the GPU-pinned sweep runner — then `mhmocap.eval_mupots`,
and prints the averaged FinalResults metrics as one JSON line.

This is the in-tree, reproducible version of the PARITY.md §4
evidence run (there is no real MuPoTs data or SMPL_NEUTRAL.pkl here;
the prediction subprocesses fall back to the SAME deterministic
synthetic body the generator used, so GT and model agree). Accuracy
on the GPU at the defaults: not measured yet.

Usage:
    python script/synthetic_e2e_sweep.py [--workdir /tmp/mupots_synth]
        [--num_seqs 5] [--frames 60] [--num_iter 100] [--workers 1]
        [--platform gpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

def make_config(path, data_path, num_iter, raster_window=128,
                lagged_decay=1.0, gap_interp=False, swap_fix=0.0,
                gap_temporal=False):
    import yaml
    cfg = {
        "ARGS": {
            "batch_size": 10,
            "gap_interpolate": gap_interp,
            "gap_aware_temporal": gap_temporal,
            "resize_factor": 1.0,
            "erode_segmentation_iters": 0,
            "erode_backmask_iters": 0,
            "renormalize_depth": False,
            "post_process_depth": False,
            "num_iter": num_iter,
            "proj2d_loss_coef": 1.0,
            "depth_loss_coef": 0.05,
            "silhouette_loss_coef": 0.1,
            "reg_poses_coef": 0.002,
            "reg_scales_coef": 0.0001,
            "reg_velocity_coef": 0.05,
            "reg_verts_filter_coef": 0.002,
            "reg_contact_coef": 0.001,
            "reg_foot_sliding_coef": 0.01,
            "save_visualizations": False,
            "raster_window": raster_window,
        },
        "smpl": {"smpl_model_parameters_path": "/nonexistent-synthetic"},
        "data": {
            "data_path": data_path,
            "depth_path": "DPT_large_monodepth",
            "joint_confidence_thr": 0.5,
            "use_hrnet_pose": False,
            "start_frame": 0,
            "end_frame": -1,
            "step_frame": 1,
            "lagged_conf_decay": lagged_decay,
            "id_swap_fix": swap_fix,
        },
    }
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def degradation_plan(ts_id: int, frames: int) -> dict:
    """Per-sequence degradation mix for the --degraded tier. Each of
    TS1..TS4 stresses ONE robustness path in isolation; TS5 combines
    them all at milder rates (see data/synthetic.py `degradations`)."""
    third = max(frames // 3, 2)
    plans = {
        1: {"crossing_paths": True},
        2: {"id_switch_spans": [(third, third + 5),
                                (2 * third, 2 * third + 4)],
            "detection_dropout": 0.10},
        3: {"romp_person_dropout": 0.20, "romp_missing_frames": 0.10},
        4: {"enter_leave": True},
        5: {"crossing_paths": True, "enter_leave": True,
            "id_switch_spans": [(third, third + 4)],
            "detection_dropout": 0.05,
            "romp_person_dropout": 0.10,
            "romp_missing_frames": 0.05},
    }
    return plans[1 + (ts_id - 1) % 5]


def hard_clean_plan(k: int) -> dict:
    """Harder CLEAN sequences (round-4 verdict weak #4): the inputs
    stay noise-free but the task is harder, so the clean proxy can
    move below its 98.8-pck saturation and catch sub-point
    regressions. Two scenarios, cycled:

    * fast: 2.5x motion frequency + 1.6x drift amplitude — larger
      inter-frame displacement stresses the temporal regularizers'
      smoothing bias;
    * close: two people weaving within ~0.5 m at near-equal depth
      with detector-realistic (depth-tested) joint confidences —
      persistent mutual occlusion stresses the occlusion-ordered
      silhouette/depth terms and the assignment.
    """
    plans = [
        {"motion": {"speed": 2.5, "amp": 1.6}, "num_people": 3,
         "degradations": None},
        {"motion": {"close_pair": True, "speed": 1.5}, "num_people": 2,
         "degradations": {"occlusion_conf": True}},
    ]
    return plans[k % 2]


# Pinned per-tier accuracy bounds (--assert_bounds): the sweep exits
# non-zero on violation so accuracy regressions fail loud instead of
# drifting. Values are the state measured before the GPU port plus
# slack; they have not been re-measured on the GPU yet (ROADMAP R0;
# docs/PARITY.md section 4).
BOUNDS = {
    # standard clean tier (TS1..TS5 defaults, no knobs)
    "clean": {"pck_rel": (">=", 98.5), "mm_rel_error": ("<=", 48.0)},
    # harder clean scenarios (--hard_clean): fast-motion pck 89.5 /
    # mm_rel 71.4 (the
    # discriminative sequence), close-pair 99.5 / 24.3 (the engine's
    # occlusion-ordered losses SATURATE this one even at 0.1 m depth
    # offset — a measured strength, kept as a regression canary);
    # bounds pin the 2-seq average 94.5 / 47.9 with ~3-pt slack
    "hard": {"pck_rel": (">=", 91.5), "mm_rel_error": ("<=", 58.0)},
    # degraded tier under the robust profile knobs (round-5 bundle
    # swap_fix 0.5 + gap_aware_temporal measured 97.13 / 28.09)
    "robust": {"pck_rel": (">=", 96.5), "abs_jitter": ("<=", 30.0)},
}


def check_bounds(final, n_std, n_hard, degraded, robust):
    """Evaluate the pinned BOUNDS against a FinalResults dict.

    `final` maps metric -> [TS1..TSn, instance-weighted Avg]; bounds
    average UNWEIGHTED over the tier's sequences (a pinned regression
    bound, not the headline metric). Returns (n_checks, violations).
    """
    def _avg(key, lo, hi):
        return float(np.mean(final[key][lo:hi]))

    checks = []   # (tier, key, op, bound, value)
    if not degraded:
        # n_std can be 0 (a --num_seqs 0 --hard_clean N run measures
        # only the hard tier): an empty tier has nothing to pin, and
        # np.mean([]) is nan — whose comparisons are all False, which
        # would silently PASS the bound
        if n_std:
            for key, (op, b) in BOUNDS["clean"].items():
                checks.append(("clean", key, op, b,
                               _avg(key, 0, n_std)))
        if n_hard:
            for key, (op, b) in BOUNDS["hard"].items():
                checks.append(("hard", key, op, b,
                               _avg(key, n_std, n_std + n_hard)))
    elif robust:
        for key, (op, b) in BOUNDS["robust"].items():
            checks.append(("robust", key, op, b, _avg(key, 0, n_std)))
    violations = [
        f"{tier} {key}={v:.2f} violates {op} {b}"
        for tier, key, op, b, v in checks
        if ((v < b) if op == ">=" else (v > b))]
    return len(checks), violations


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/mupots_synth")
    ap.add_argument("--num_seqs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--num_iter", type=int, default=100)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--platform", default="gpu",
                    choices=["gpu", "cpu"])
    ap.add_argument("--skip_generate", action="store_true",
                    help="reuse existing trees under --workdir")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--num_vertices", type=int, default=0,
                    help="downsampled synthetic body for CPU smoke "
                         "runs (0 = full 6890)")
    ap.add_argument("--raster_window", type=int, default=128)
    ap.add_argument("--degraded", action="store_true",
                    help="adversarial-input tier (round-3 verdict weak "
                         "#5): each sequence stresses one robustness "
                         "path — inter-person occlusion, tracker ID "
                         "switches + detection dropout, missing/empty "
                         "ROMP frames, people leaving the frame — plus "
                         "one all-combined sequence. Checks graceful "
                         "degradation (pipeline completes, finite "
                         "metrics), not golden accuracy.")
    ap.add_argument("--lagged_decay", type=float, default=1.0,
                    help="lagged_conf_decay ingestion knob (default "
                         "1.0 = reference parity; e.g. 0.8 releases "
                         "stale dropout-gap anchors after ~1 frame — "
                         "see load_sequence's docstring)")
    ap.add_argument("--gap_interp", action="store_true",
                    help="post-fit gap interpolation of unobserved "
                         "detection-dropout spans (opt-in knob, "
                         "engine/gapfill.py): removes the "
                         "re-acquisition snap that dominates the "
                         "degraded tier's jitter")
    ap.add_argument("--gap_temporal", action="store_true",
                    help="gap-aware temporal losses DURING the fit "
                         "(opt-in engine knob, EngineConfig."
                         "gap_aware_temporal): mask the velocity/"
                         "filtered-verts/foot-sliding pair terms on "
                         "stale endpoints and penalize acceleration "
                         "across stale triples so dropout gaps "
                         "interpolate instead of freezing — treats "
                         "the flanking-observed-frame jitter the "
                         "post-fit passes cannot touch")
    ap.add_argument("--job_timeout", type=float, default=1800,
                    help="per-TS worker timeout in seconds (kill + "
                         "one retry; raise it when a knob combination "
                         "changes the raster window shapes — a killed "
                         "compile caches nothing)")
    ap.add_argument("--hard_clean", type=int, default=0,
                    help="append N harder CLEAN sequences (fast "
                         "motion / close interactions, cycled — see "
                         "hard_clean_plan) after the standard ones, "
                         "reported separately in hard_per_ts")
    ap.add_argument("--assert_bounds", action="store_true",
                    help="assert the pinned per-tier accuracy bounds "
                         "(BOUNDS) and exit non-zero on violation: "
                         "clean avg over the standard sequences, hard "
                         "avg over --hard_clean ones, robust bounds "
                         "when --degraded runs with the robust-profile "
                         "knobs")
    ap.add_argument("--swap_fix", type=float, default=0.0,
                    help="id_swap_fix ingestion knob (default 0.0 = "
                         "reference parity; e.g. 0.5 corrects "
                         "sustained tracker identity switches when "
                         "the positional Hungarian beats the id "
                         "assignment 2x — see tracks_to_array's "
                         "docstring)")
    args = ap.parse_args()

    if args.degraded and args.workdir == "/tmp/mupots_synth":
        args.workdir += "_degraded"  # don't clobber the clean trees
    if args.lagged_decay < 1.0:
        args.workdir += "_decay"  # separate output tree per knob
    if args.gap_interp:
        args.workdir += "_interp"
    if args.swap_fix > 0.0:
        args.workdir += "_swapfix"
    if args.gap_temporal:
        args.workdir += "_gaptemporal"
    if args.hard_clean:
        if args.degraded:
            sys.exit("--hard_clean is a CLEAN-tier extension")
        args.workdir += "_hard"

    if args.num_vertices:
        # the prediction/eval subprocesses resolve the SAME
        # downsampled body via the loader's env hook
        os.environ["MHMOCAP_SYNTHETIC_SMPL"] = str(args.num_vertices)

    # The main process stays off the GPUs: generation and evaluation
    # are small CPU work, and each card must hold one JAX process only
    # (a JAX process reserves most of its card's memory), the worker.
    # Generation numerics are platform-stable: the SMPL contraction
    # runs at Precision.HIGHEST (models/smpl.py).
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # host-fingerprinted CPU cache (CPU AOT entries from another
        # host can crash on load, mhmocap/cache.py)
        from mhmocap.cache import cpu_cache_dir
        jax.config.update("jax_compilation_cache_dir",
                          cpu_cache_dir(REPO))

    data_path = os.path.join(args.workdir, "data")
    out_path = os.path.join(args.workdir, "out")
    log_dir = os.path.join(args.workdir, "logs")
    os.makedirs(data_path, exist_ok=True)

    ts_ids = list(range(1, args.num_seqs + 1))
    hard_ids = list(range(args.num_seqs + 1,
                          args.num_seqs + 1 + args.hard_clean))

    if not args.skip_generate:
        from mhmocap.data.synthetic import generate_sequence
        from mhmocap.models.synthetic import make_synthetic_smpl
        # the DEFAULT full-size synthetic body: the prediction
        # subprocesses resolve the same model via the
        # /nonexistent-synthetic fallback, so GT and fit agree
        model = make_synthetic_smpl(
            num_vertices=args.num_vertices or 6890)
        for i in ts_ids:
            generate_sequence(
                os.path.join(data_path, f"TS{i}"),
                num_frames=args.frames,
                num_people=3 if i % 2 else 2,
                image_size=(args.image_size, args.image_size),
                model=model, seed=7 + i, mupots_gt=True,
                degradations=degradation_plan(i, args.frames)
                if args.degraded else None)
            print(f"generated TS{i}"
                  + (" (degraded)" if args.degraded else ""),
                  flush=True)
        for k, i in enumerate(hard_ids):
            plan = hard_clean_plan(k)
            generate_sequence(
                os.path.join(data_path, f"TS{i}"),
                num_frames=args.frames,
                num_people=plan["num_people"],
                image_size=(args.image_size, args.image_size),
                model=model, seed=7 + i, mupots_gt=True,
                motion=plan["motion"],
                degradations=plan["degradations"])
            print(f"generated TS{i} (hard clean)", flush=True)
    ts_ids += hard_ids

    cfg_path = make_config(os.path.join(args.workdir, "predict.yml"),
                           data_path, args.num_iter,
                           raster_window=args.raster_window,
                           lagged_decay=args.lagged_decay,
                           gap_interp=args.gap_interp,
                           swap_fix=args.swap_fix,
                           gap_temporal=args.gap_temporal)

    from predict_mupots_sweep import build_commands, run_sweep
    cmds = build_commands(ts_ids, cfg_path, out_path)
    results = run_sweep(cmds, workers=args.workers,
                        platform=args.platform, log_dir=log_dir,
                        labels=[f"TS{i}" for i in ts_ids],
                        retries=1, job_timeout=args.job_timeout)
    if any(rc != 0 for rc in results.values()):
        print(json.dumps({"error": "sweep failures", **results}))
        sys.exit(1)

    from mhmocap import eval_mupots as EM
    EM.main(["--configs_yml", cfg_path, "--input_path", out_path])

    with open(os.path.join(out_path, "FinalResults.json")) as f:
        final = json.load(f)["final_results"]
    # each metric's list is [TS1..TSn, instance-weighted Avg.]
    n_std = args.num_seqs
    out_json = {
        "metric": "synthetic_e2e_sweep"
                  + ("_degraded" if args.degraded else ""),
        "sequences": args.num_seqs,
        "frames": args.frames,
        "num_iter": args.num_iter,
        "lagged_decay": args.lagged_decay,
        "gap_interp": args.gap_interp,
        "swap_fix": args.swap_fix,
        "gap_temporal": args.gap_temporal,
        "avg": {k: v[-1] for k, v in final.items()},
        "per_ts": {k: v[:n_std] for k, v in final.items()
                   if k in ("pck_rel", "mm_rel_error")},
    }
    if args.hard_clean:
        out_json["hard_per_ts"] = {
            k: v[n_std:-1] for k, v in final.items()
            if k in ("pck_rel", "mm_rel_error")}
    print(json.dumps(out_json))

    if args.assert_bounds:
        n_checks, violations = check_bounds(
            final, n_std, args.hard_clean, degraded=args.degraded,
            robust=args.swap_fix > 0.0 and args.gap_temporal)
        if violations:
            print(json.dumps({"bounds_violations": violations}))
            sys.exit(2)
        print(f"bounds OK ({n_checks} checks)")


if __name__ == "__main__":
    main()
