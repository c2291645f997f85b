#!/usr/bin/env python3
"""Smoke test of the production path on one NVIDIA GPU.

Phases (any failure exits non-zero; no exception is swallowed):

1. environment: the card's name and power limit (nvidia-smi), the JAX
   and jaxlib versions, which optional packages import, the XLA flags;
2. the tests marked `gpu` (pytest child, run before this process
   touches the card, so only one process holds it at a time);
3. kernel check at real widths: the full 6890-vertex body at the
   bench's TS1 placement, 48 bodies per window of 160, 128 and 112 px,
   the raster kernel against the brute reference (forward coverage,
   z and silhouette; vertex gradient of a silhouette + depth loss),
   and fwd / fwd+bwd times of both;
4. end to end: a synthetic MuPoTs-format sequence (T=201, N=3, 256^2,
   full body, MuPoTs ground truth) through `predict_mupots` for 45
   cycles and `eval_mupots`; finite losses, output pickles, finite
   metrics, compile seconds, per-cycle time, frame-cycles/s and peak
   device memory.

`--four` runs only the time-sharded fused cycle on a four-GPU mesh
against the single-card cycle from the same start.

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}

Usage:
    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs, the sharded cycle only
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

KERNEL_WINDOWS = (160, 128, 112)
KERNEL_BODIES = 48
# acceptance bounds of the kernel check against the brute reference
MAX_COVER_MISMATCH = 0
MAX_DZBUF = 1e-3
MAX_DSIL = 1e-3
MAX_GRAD_REL = 2e-3
# Sharded vs single-card cycle. The gate is the gradient of the loss
# (relative L2 per leaf, same parameters and aux state) and the loss
# after FOUR_CYCLES fused cycles. Parameter differences after those
# cycles are reported, not gated: the two paths sum in different
# orders, and RMSprop moves every element by about lr*sqrt(2) per step
# whatever its gradient's size, so a near-zero gradient whose sign
# differs moves a parameter the other way.
FOUR_CYCLES = 5
FOUR_GRAD_REL = 1e-3
FOUR_LOSS_RTOL = 1e-3


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi lists no GPU")
    return out.splitlines()[0]


def env_phase() -> str:
    card = card_line()
    log(f"card: {card}")
    import jax
    import jaxlib
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"python {sys.version.split()[0]}")
    for mod in ("flax", "yaml", "PIL", "cv2", "orbax.checkpoint",
                "matplotlib", "scipy", "optax"):
        try:
            importlib.import_module(mod)
            log(f"import {mod}: yes")
        except ImportError:
            log(f"import {mod}: no")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return card


def gpu_tests_phase():
    env = dict(os.environ, JAX_PLATFORMS="")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests")],
        cwd=REPO, env=env, timeout=900, capture_output=True, text=True)
    summary = (res.stdout.strip().splitlines() or [""])[-1]
    log(f"gpu tests: {summary}")
    if res.returncode != 0 or "skipped" in summary \
            or "passed" not in summary:
        log(res.stdout[-4000:])
        raise RuntimeError(f"gpu-marked tests did not all pass "
                           f"(rc={res.returncode})")


def _timed(fn, *args, reps=7):
    import jax
    jax.block_until_ready(fn(*args))             # warm-up / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_bodies(bodies=KERNEL_BODIES, seed=0):
    """(verts (bodies, 6890, 3), preordered model, K) at the bench's
    TS1 placement with random 0.1-rad poses."""
    import jax.numpy as jnp
    from bench import ts1_poses_T
    from mhmocap.models.smpl import smpl_forward
    from mhmocap.models.synthetic import make_synthetic_smpl
    from mhmocap.ops.cameras import intrinsics_from_fov
    from mhmocap.ops.rasterizer import preorder_faces

    model = preorder_faces(make_synthetic_smpl())
    n_people = 3
    frames = bodies // n_people
    rng = np.random.RandomState(seed)
    poses = 0.1 * rng.randn(frames * n_people, 72).astype(np.float32)
    out = smpl_forward(model, jnp.zeros((frames * n_people, 10)),
                       jnp.asarray(poses))
    place = ts1_poses_T(frames, n_people).reshape(-1, 1, 3)
    verts = out["verts"] + jnp.asarray(place)
    K = jnp.asarray(intrinsics_from_fov((256, 256), 60.0))
    return verts, model, K


def kernel_check(win, verts, model, K, geo=None, reps=7,
                 interpret=False):
    """Kernel vs brute at window `win`: accuracy numbers and times
    (interpret: the kernel in the Pallas interpreter, for rehearsals
    on the CPU)."""
    import jax
    import jax.numpy as jnp
    from mhmocap.ops import raster_pallas as RP
    from mhmocap.ops import rasterizer as R

    geo = geo or RP.GEOMETRY
    st = R.RasterSettings(image_size=(256, 256), window=win,
                          preordered=True, interpret=interpret)
    faces = model.faces

    def kern(v):
        o = RP.rasterize_bodies_pallas(v, faces, K, st, geo=geo)
        return o["zbuf"], o["sil"]

    def brute(v):
        o = R.rasterize_bodies(v, faces, K, st._replace(backend="brute"))
        return o["zbuf"], o["sil"]

    rng = np.random.RandomState(1)
    w_sil = jnp.asarray(rng.randn(verts.shape[0], win, win), jnp.float32)
    w_z = jnp.asarray(rng.randn(verts.shape[0], win, win), jnp.float32)

    def loss_of(fn):
        def loss(v):
            zbuf, sil = fn(v)
            zb = jnp.where(jnp.isfinite(zbuf), zbuf, 0.0)
            return jnp.sum(w_sil * sil) + 0.1 * jnp.sum(w_z * zb)
        return jax.jit(jax.grad(loss))

    fk, fb = jax.jit(kern), jax.jit(brute)
    gk, gb = loss_of(kern), loss_of(brute)
    zk, sk = (np.asarray(x) for x in fk(verts))
    zb, sb = (np.asarray(x) for x in fb(verts))
    cov_k, cov_b = np.isfinite(zk), np.isfinite(zb)
    both = cov_k & cov_b
    g_k, g_b = np.asarray(gk(verts)), np.asarray(gb(verts))
    n = np.linalg.norm(g_b)
    big = np.abs(g_b) > 1e-3 * n
    res = {
        "window": win, "bodies": int(verts.shape[0]),
        "covered_px": int(cov_b.sum()),
        "cover_mismatch": int((cov_k != cov_b).sum()),
        "max_dzbuf": float(np.abs(zk[both] - zb[both]).max()),
        "max_dsil": float(np.abs(sk - sb).max()),
        "grad_rel": float((np.abs(g_k - g_b)[big]
                           / np.abs(g_b)[big]).max()),
        "grad_norm_rel": float(np.linalg.norm(g_k - g_b) / n),
        "grad_finite": bool(np.isfinite(g_k).all()),
    }
    if reps:
        res.update({
            "kernel_fwd_ms": 1e3 * _timed(fk, verts, reps=reps),
            "brute_fwd_ms": 1e3 * _timed(fb, verts, reps=reps),
            "kernel_fwdbwd_ms": 1e3 * _timed(gk, verts, reps=reps),
            "brute_fwdbwd_ms": 1e3 * _timed(gb, verts, reps=reps),
        })
    return res


def kernel_phase(card):
    verts, model, K = kernel_bodies()
    failures = []
    for win in KERNEL_WINDOWS:
        r = kernel_check(win, verts, model, K)
        log(f"kernel [{card}] " + json.dumps(r))
        if r["cover_mismatch"] > MAX_COVER_MISMATCH:
            failures.append(f"win {win}: {r['cover_mismatch']} "
                            f"covered-pixel mismatches")
        if r["max_dzbuf"] > MAX_DZBUF or r["max_dsil"] > MAX_DSIL:
            failures.append(f"win {win}: |dzbuf| {r['max_dzbuf']} "
                            f"|dsil| {r['max_dsil']}")
        if not r["grad_finite"] or r["grad_rel"] > MAX_GRAD_REL:
            failures.append(f"win {win}: gradient rel {r['grad_rel']}")
    if failures:
        raise AssertionError("kernel check: " + "; ".join(failures))


def _write_config(path, data_path, tmp):
    """configs/predict_mupots.yml pointed at the synthetic tree: the
    images are written at MuPoTs' working size (2048^2 at resize
    0.125 = 256^2), so resize_factor is 1; no visualizations; cycle
    marks for the cadence."""
    import yaml
    with open(os.path.join(REPO, "configs", "predict_mupots.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["ARGS"].update(resize_factor=1.0, save_visualizations=False,
                       bench_cycles=[1, 25, 44])
    cfg["smpl"]["smpl_model_parameters_path"] = os.path.join(
        tmp, "no_smpl_model")
    cfg["data"]["data_path"] = data_path
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def e2e_phase(card, T=201, N=3, side=256, num_vertices=6890):
    """(T, N, side, num_vertices are cut only for CPU rehearsals.)"""
    import jax
    from mhmocap import eval_mupots, predict_mupots
    from mhmocap.data.synthetic import generate_sequence
    from mhmocap.models.synthetic import make_synthetic_smpl

    cycles = 45
    if num_vertices != 6890:
        # the predict side resolves the same body by this hook
        os.environ["MHMOCAP_SYNTHETIC_SMPL"] = str(num_vertices)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_path = os.path.join(tmp, "data")
        out_path = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        generate_sequence(os.path.join(data_path, "TS1"), num_frames=T,
                          num_people=N, image_size=(side, side),
                          model=make_synthetic_smpl(num_vertices), seed=8,
                          mupots_gt=True)
        log(f"e2e: generated T={T} N={N} {side}^2 in "
            f"{time.perf_counter() - t0:.1f}s")
        cfg_path = os.path.join(tmp, "predict.yml")
        _write_config(cfg_path, data_path, tmp)

        t0 = time.perf_counter()
        result = predict_mupots.main(
            ["--configs_yml", cfg_path, "--ts_id", "1", "--output_path",
             out_path, "--num_iter", str(cycles)])
        predict_s = time.perf_counter() - t0
        ts_dir = os.path.join(out_path, "TS1")
        for name in ("optvar_init.pkl", "optvar_stage1.pkl",
                     "mupots_annot.pkl"):
            if not os.path.exists(os.path.join(ts_dir, name)):
                raise AssertionError(f"missing output {name}")
        losses = np.asarray([list(r.values())
                             for r in result["stage1_log"]])
        init = np.asarray([r["loss_2d"] for r in result["init_log_loss"]])
        if len(losses) != cycles or not np.isfinite(losses).all() \
                or not np.isfinite(init).all():
            raise AssertionError("non-finite or missing losses")

        eval_mupots.main(["--configs_yml", cfg_path, "--input_path",
                          out_path])
        with open(os.path.join(out_path, "FinalResults.json")) as f:
            final = json.load(f)["final_results"]
        metrics = {k: v[-1] for k, v in final.items()}
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite metrics {metrics}")

    start, marks = result["fit_marks"]
    steady = (marks[2] - marks[1]) / (44 - 25)
    compile_s = marks[0] - start - steady
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")
    res = {
        "frames": T, "people": N, "side": side, "cycles": cycles,
        "windows": list(result["stage1_optvar"]["raster_windows"]),
        "compile_s": compile_s, "steady_cycle_ms": 1e3 * steady,
        "frame_cycles_per_s": T / steady, "predict_s": predict_s,
        "peak_bytes_in_use": peak,
        "last_cycle_loss_parts": dict(zip(
            result["stage1_log"][-1], losses[-1].tolist())),
        "metrics": metrics,
    }
    log(f"e2e [{card}] " + json.dumps(res))


def four_phase(card, T=201, num_vertices=6890):
    """Sharded fused cycle on a 4-GPU time mesh vs the single-card
    fused cycle, both from the same start, after FOUR_CYCLES cycles.
    (T and num_vertices are cut only for CPU rehearsals.)"""
    import jax
    import jax.numpy as jnp
    from bench import fit_args, make_ts1_like_seq
    from mhmocap.engine import optimizer as E
    from mhmocap.engine.predictor import Predictor
    from mhmocap.parallel import spmd

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four needs 4 devices, found "
                           f"{len(jax.devices())}")
    from mhmocap.models.synthetic import make_synthetic_smpl
    seq, model = make_ts1_like_seq(
        T=T, model=make_synthetic_smpl(num_vertices))
    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp,
                         fit_args(num_iter=FOUR_CYCLES, spmd=True))
    cfg, model = pred.cfg, pred.model
    log(f"four: chunk {cfg.chunk} bucket {cfg.frame_bucket} padded "
        f"{cfg.padded_frames} windows {cfg.person_windows}")
    params0, _, _ = E.init_params(model, seq.pose2d, seq.poses_smpl,
                                  seq.betas_smpl, seq.cam["K"], cfg,
                                  num_iter=20)
    data = E.prepare_seq_data(seq, cfg)
    aux0 = E.init_aux(cfg, model.num_vertices, jnp.asarray(
        np.mean(seq.betas_smpl, axis=0, keepdims=True)))
    opt = E.make_stage1_optimizer()
    first = cfg.warmup_cycles       # scene rebuild + contact terms on
    mesh = spmd.make_mesh()
    fields = E.StageParams._fields

    # the sharded loss's gradient against the single-card one, from the
    # same parameters and the same (scene-engaged) aux state
    aux_s = E.fused_aux_refresh(params0, aux0, jnp.uint32(first), model,
                                data, cfg)
    g1 = jax.jit(jax.grad(lambda p: E._cycle_loss(
        p, model, data, aux_s, pred.coefs, cfg)[0]))(params0)
    g4 = jax.jit(jax.grad(lambda p: spmd.spmd_cycle_loss(
        p, model, spmd.shard_data(data, mesh), spmd.shard_aux(aux_s, mesh),
        pred.coefs, cfg, mesh)[0]))(spmd.shard_params(params0, mesh))
    grad_rel = {k: float(np.linalg.norm(np.asarray(b) - np.asarray(a))
                         / max(np.linalg.norm(np.asarray(a)), 1e-30))
                for k, a, b in zip(fields, g1, g4)}

    def run(sharded):
        copy = lambda t: jax.tree.map(jnp.copy, t)
        params, aux = copy(params0), copy(aux0)
        opt_state = opt.init(params)
        d = data
        if sharded:
            params = spmd.shard_params(params, mesh)
            d = spmd.shard_data(data, mesh)
            aux = spmd.shard_aux(aux, mesh)
            opt_state = spmd.shard_opt_state(opt_state, mesh)
        marks = [time.perf_counter()]
        for c in range(first, first + FOUR_CYCLES):
            if c == first + 1:                    # after the compile
                jax.block_until_ready(loss)
                marks.append(time.perf_counter())
            if sharded:
                params, opt_state, aux, loss, _ = \
                    spmd.spmd_stage1_cycle_fused(
                        params, opt_state, aux, jnp.uint32(c), model, d,
                        pred.coefs, cfg, mesh)
            else:
                params, opt_state, aux, loss, _ = E.stage1_cycle_fused(
                    params, opt_state, aux, jnp.uint32(c), model, d,
                    pred.coefs, cfg)
        jax.block_until_ready(loss)
        marks.append(time.perf_counter())
        return params, float(loss), {
            "first_cycle_s": marks[1] - marks[0],
            "steady_cycle_ms": 1e3 * (marks[2] - marks[1])
            / (FOUR_CYCLES - 1)}

    p1, l1, s1 = run(False)
    p4, l4, s4 = run(True)
    a1 = [np.asarray(x, np.float64) for x in p1]
    a4 = [np.asarray(x, np.float64) for x in p4]
    a0 = [np.asarray(x, np.float64) for x in params0]
    res = {
        "grad_rel_l2": grad_rel,
        "loss_1": l1, "loss_4": l4, "loss_rel": abs(l4 - l1) / abs(l1),
        "max_abs_diff": {k: float(np.abs(x - y).max())
                         for k, x, y in zip(fields, a1, a4)},
        # |sharded - single| over |single - start|, per leaf
        "step_rel_l2": {k: float(np.linalg.norm(y - x)
                                 / max(np.linalg.norm(x - z), 1e-30))
                        for k, x, y, z in zip(fields, a1, a4, a0)},
        "timing_1": s1, "timing_4": s4,
        "tolerance": {"grad_rel_l2": FOUR_GRAD_REL,
                      "loss_rtol": FOUR_LOSS_RTOL}}
    log(f"four [{card}] " + json.dumps(res))
    if max(grad_rel.values()) > FOUR_GRAD_REL \
            or res["loss_rel"] > FOUR_LOSS_RTOL:
        raise AssertionError("sharded cycle disagrees with single card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded cycle on four GPUs")
    args = ap.parse_args(argv)

    card = env_phase()
    if not args.four:
        gpu_tests_phase()

    from mhmocap.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform}")
    log(f"device: {dev.device_kind} x{len(jax.devices())}")

    if args.four:
        four_phase(card)
    else:
        kernel_phase(card)
        e2e_phase(card)
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
