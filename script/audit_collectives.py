"""Audit the COMPILED collectives of the fused sharded cycle against
the analytic inter-device budget (tests/test_spmd_production.py).

The budget was hand-derived; this checks it against what XLA/GSPMD
actually compiles — in particular
`fused_aux_refresh` runs under GSPMD on the time-sharded arrays, where
the full-T scene median and the sequential One-Euro scan are free for
the partitioner to implement with whatever gathers it likes. This
script lowers `spmd_stage1_cycle_fused` at the production shape on a
virtual 8-device CPU mesh, compiles it, and extracts every collective
op (kind, per-device shape, bytes) from the optimized HLO.

Usage (CPU-only; no GPU needed):
    python script/audit_collectives.py            # V=128 structural
    python script/audit_collectives.py --full-smpl  # V=6890 production

Prints a markdown table plus one JSON line. The
shapes are PER-PARTITION (the compiled module is the per-device SPMD
program), so bytes are per-device per-cycle — directly comparable to
the analytic budget.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
          if "host_platform_device_count" not in f]
_flags.append("--xla_force_host_platform_device_count=8")
os.environ["XLA_FLAGS"] = " ".join(_flags)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mhmocap.cache import cpu_cache_dir  # noqa: E402

# an outside JAX_COMPILATION_CACHE_DIR wins; otherwise the
# host-fingerprinted CPU cache (CPU AOT entries from another host can
# crash on load)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", cpu_cache_dir(REPO))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)

import jax.numpy as jnp  # noqa: E402

from mhmocap.parallel.hlo_audit import extract_collectives  # noqa: E402


def build_problem(full_smpl: bool, T: int = 201):
    """Production TIME/raster shape (default T=201 -> padded 208,
    chunk 26 — the Predictor SPMD auto-chunk tune at 8 devices — side
    256); the SMPL vertex count is structural for every collective
    except the filtered-target refresh, which --full-smpl checks at
    V=6890; --frames checks the T-scaling claim (the scene-median
    all-reduce must stay O(H*W), only the pose all-gather may grow
    with T)."""
    import bench
    from mhmocap.engine import optimizer as E
    from mhmocap.models.synthetic import make_synthetic_smpl

    N, side = 3, 256
    if full_smpl:
        seq, model = bench.make_ts1_like_seq(T=T, N=N, side=side)
        window, windows = 160, (160, 128, 112)
    else:
        # small body, same raster/scene/temporal structure (passed
        # into the seq builder too — generating the sequence with the
        # full 6890-vert body would burn minutes of CPU smpl_forward
        # for arrays whose shapes are vertex-count independent)
        model = make_synthetic_smpl(num_vertices=128, seed=6)
        seq, _ = bench.make_ts1_like_seq(T=T, N=N, side=side,
                                         model=model)
        window, windows = 128, None

    # the Predictor SPMD tuner's layout at this T
    from mhmocap.engine.predictor import tune_time_layout
    chunk, bucket = tune_time_layout(T, n_dev=8)
    cfg = E.EngineConfig(
        image_size=(side, side), num_people=N, num_frames=T,
        chunk=chunk, frame_bucket=bucket, window=window,
        windows=windows, face_chunk=128)
    if T == 201:
        assert cfg.padded_frames == 208 and chunk == 26
    params, _, _ = E.init_params(model, seq.pose2d, seq.poses_smpl,
                                 seq.betas_smpl, seq.cam["K"], cfg,
                                 num_iter=2)
    data = E.prepare_seq_data(seq, cfg)
    aux = E.init_aux(cfg, model.num_vertices,
                     jnp.asarray(seq.betas_smpl[:1].mean(
                         0, keepdims=True)))
    return model, cfg, params, data, aux, E.default_coefs()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-smpl", action="store_true",
                    help="V=6890 production body (slow compile)")
    ap.add_argument("--frames", type=int, default=201,
                    help="sequence length T (tuned chunk/bucket follow)")
    args = ap.parse_args()

    from mhmocap.engine import optimizer as E
    from mhmocap.parallel import spmd

    model, cfg, params, data, aux, coefs = build_problem(
        args.full_smpl, T=args.frames)
    mesh = spmd.make_mesh()
    opt = E.make_stage1_optimizer()
    params_s = spmd.shard_params(params, mesh)
    data_s = spmd.shard_data(data, mesh)
    aux_s = spmd.shard_aux(aux, mesh)
    opt_state = opt.init(params_s)

    import time
    t0 = time.time()
    lowered = spmd.spmd_stage1_cycle_fused.lower(
        params_s, opt_state, aux_s, jnp.uint32(30), model, data_s,
        coefs, cfg, mesh, optimize_scale=True)
    compiled = lowered.compile()
    print(f"# lower+compile: {time.time() - t0:.1f}s "
          f"(V={model.num_vertices}, T={args.frames}->"
          f"{cfg.padded_frames}, chunk={cfg.chunk}, side=256, "
          f"window={cfg.window})", file=sys.stderr)

    colls = extract_collectives(compiled.as_text())
    by_kind = {}
    for kind, shape, nbytes in colls:
        by_kind.setdefault(kind, []).append((shape, nbytes))

    print("| Collective | count | per-device result shapes | "
          "total bytes/device |")
    print("|---|---|---|---|")
    grand = 0
    for kind in sorted(by_kind):
        rows = by_kind[kind]
        total = sum(b for _, b in rows)
        grand += total
        shapes = {}
        for s, b in rows:
            shapes[s] = shapes.get(s, 0) + 1
        desc = "; ".join(f"{c}x {s}" for s, c in
                         sorted(shapes.items(), key=lambda kv: -kv[1]))
        if len(desc) > 120:
            desc = desc[:117] + "..."
        print(f"| `{kind}` | {len(rows)} | {desc} | {total:,} |")
    print(f"| **total** | {len(colls)} | | **{grand:,}** |")

    print(json.dumps({
        "v": model.num_vertices,
        "t": args.frames,
        "padded_frames": cfg.padded_frames,
        "chunk": cfg.chunk,
        "collective_total_bytes_per_device": grand,
        "by_kind": {k: sum(b for _, b in v)
                    for k, v in by_kind.items()},
        "counts": {k: len(v) for k, v in by_kind.items()},
    }))


if __name__ == "__main__":
    main()
