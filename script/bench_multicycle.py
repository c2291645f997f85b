"""A/B: K production cycles per dispatch vs one dispatch per cycle.

Measures, at the exact bench.py TS1-scale workload and a warm
steady-state (scene + filters engaged, cycles >= 30), the per-cycle
cadence of:

  * loop:  stage1_cycle_fused dispatched once per cycle (what
    Predictor.fit does; the host queues cycles asynchronously);
  * scanK: stage1_cycles_fused with n_cycles=K (one dispatch per K
    cycles; identical math, indices threaded through lax.scan).

Also cross-checks that scanK reproduces the loop's losses bitwise-ish
(same program order, f32) over one refresh period.

Usage: python script/bench_multicycle.py [--Ks 5,15] [--meas 30]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402

from mhmocap.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--Ks", default="5,15")
    ap.add_argument("--meas", type=int, default=30,
                    help="steady-state cycles per measurement")
    ap.add_argument("--check", action="store_true",
                    help="numeric loop-vs-scan equivalence check "
                         "(doubles the warm work)")
    args = ap.parse_args()
    Ks = [int(k) for k in args.Ks.split(",")]

    import types
    import tempfile
    from bench import make_ts1_like_seq, WINDOW
    from mhmocap.engine.predictor import Predictor
    from mhmocap.engine import optimizer as E

    seq, model = make_ts1_like_seq()
    ns = types.SimpleNamespace(
        num_iter=1, batch_size=10, save_visualizations=False,
        verbose=False, proj2d_loss_coef=1.0, depth_loss_coef=0.05,
        silhouette_loss_coef=0.1, reg_poses_coef=0.002,
        reg_scales_coef=1e-4, reg_velocity_coef=0.05,
        reg_verts_filter_coef=0.002, reg_contact_coef=0.001,
        reg_foot_sliding_coef=0.01, joint_confidence_thr=0.5,
        raster_window=WINDOW, spmd=False)
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, ns)
    cfg, model = pred.cfg, pred.model
    coefs = pred.coefs

    params, _, _ = E.init_params(
        model, seq.pose2d, seq.poses_smpl, seq.betas_smpl,
        seq.cam["K"], cfg, num_iter=5)
    data = E.prepare_seq_data(seq, cfg)
    aux = E.init_aux(cfg, model.num_vertices,
                     jnp.asarray(seq.betas_smpl[:1].mean(
                         0, keepdims=True)))
    opt = E.make_stage1_optimizer()
    opt_state = opt.init(params)

    def loop(state, c0, n):
        params, opt_state, aux = state
        losses = []
        for c in range(c0, c0 + n):
            params, opt_state, aux, loss, _ = E.stage1_cycle_fused(
                params, opt_state, aux, jnp.uint32(c), model, data,
                coefs, cfg)
            losses.append(loss)
        return (params, opt_state, aux), jnp.stack(losses)

    def scan(state, c0, n, K):
        params, opt_state, aux = state
        losses = []
        for c in range(c0, c0 + n, K):
            params, opt_state, aux, ls, _ = E.stage1_cycles_fused(
                params, opt_state, aux, jnp.uint32(c), model, data,
                coefs, cfg, n_cycles=K)
            losses.append(ls)
        return (params, opt_state, aux), jnp.concatenate(losses)

    # warm to steady state (scene from cycle 30; filters on the
    # 25-cycle cadence) + compile the loop program
    state = (params, opt_state, aux)
    t0 = time.time()
    state, warm_losses = loop(state, 0, 35)
    jax.block_until_ready(warm_losses)
    print(f"warmup+compile loop: {time.time() - t0:.1f}s", flush=True)

    if args.check:
        # numeric equivalence over one refresh period from the same
        # state: scan must reproduce the loop's losses exactly (same
        # ops in the same order; only the dispatch grouping differs)
        stateA = jax.tree.map(jnp.copy, state)   # private copies
        stateB = jax.tree.map(jnp.copy, state)
        _, lA = loop(stateA, 35, Ks[0])
        _, lB = scan(stateB, 35, Ks[0], Ks[0])
        np.testing.assert_allclose(np.asarray(lA), np.asarray(lB),
                                   rtol=0, atol=0)
        print(f"check: scan{Ks[0]} losses == loop losses "
              f"(bitwise), {np.asarray(lA)[:3]}", flush=True)

    results = {}
    c0 = 35

    def measure(label, fn):
        nonlocal state, c0
        t0 = time.time()
        state, losses = fn(state, c0)
        jax.block_until_ready(losses)
        dt = (time.time() - t0) / args.meas
        c0 += args.meas
        results[label] = dt
        print(f"{label:10s} {dt * 1e3:8.1f} ms/cycle "
              f"({201 / dt:.1f} f-c/s)", flush=True)

    # compile the scan programs outside the timed windows
    for K in Ks:
        t0 = time.time()
        state, ls = scan(state, c0, K, K)
        jax.block_until_ready(ls)
        c0 += K
        print(f"compile scan{K}: {time.time() - t0:.1f}s", flush=True)

    # interleave loop/scan measurements to cancel slow drift
    for rep in range(2):
        measure(f"loop[{rep}]",
                lambda s, c: loop(s, c, args.meas))
        for K in Ks:
            measure(f"scan{K}[{rep}]",
                    lambda s, c, K=K: scan(s, c, args.meas, K))

    loops = [v for k, v in results.items() if k.startswith("loop")]
    base = float(np.median(loops))
    print("\nsummary (median loop = "
          f"{base * 1e3:.1f} ms/cycle, {201 / base:.1f} f-c/s):")
    for K in Ks:
        scans = [v for k, v in results.items()
                 if k.startswith(f"scan{K}[")]
        m = float(np.median(scans))
        print(f"  scan{K}: {m * 1e3:.1f} ms/cycle ({201 / m:.1f} "
              f"f-c/s), {100 * (base - m) / base:+.1f}% vs loop")


if __name__ == "__main__":
    main()
