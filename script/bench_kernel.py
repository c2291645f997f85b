"""Time the raster kernel against XLA's brute path on one GPU.

Runs chip_smoke's kernel check (full 6890-vertex body, 48 bodies at
the bench's TS1 placement) at windows 160, 128 and 112, then, with
--sweep, times the kernel alone at window 160 over a grid of block
geometries (cell size, faces per chunk, warps). One JSON line per
measurement on stdout, each with the card's name and power limit;
--out appends the same lines to a file.

Usage: python script/bench_kernel.py [--sweep] [--reps 7] [--out F]
"""

import argparse
import itertools
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402


def sweep_geometries():
    from mhmocap.ops.raster_pallas import KernelGeometry
    for (ch, cw), fc, nw in itertools.product(
            [(8, 16), (16, 16), (16, 32)], [16, 32, 64], [4, 8]):
        yield KernelGeometry(cell_h=ch, cell_w=cw, face_chunk=fc,
                             num_warps=nw)


def kernel_times(win, verts, model, K, geo, reps):
    import jax
    import jax.numpy as jnp
    from mhmocap.ops import raster_pallas as RP
    from mhmocap.ops.rasterizer import RasterSettings

    st = RasterSettings(image_size=(256, 256), window=win,
                        preordered=True)

    def fwd(v):
        o = RP.rasterize_bodies_pallas(v, model.faces, K, st, geo=geo)
        return o["zbuf"], o["sil"]

    def loss(v):
        zbuf, sil = fwd(v)
        return jnp.sum(sil) + jnp.sum(jnp.where(jnp.isfinite(zbuf),
                                                zbuf, 0.0))
    return (1e3 * C._timed(jax.jit(fwd), verts, reps=reps),
            1e3 * C._timed(jax.jit(jax.grad(loss)), verts, reps=reps))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    card = C.env_phase()
    from mhmocap.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU")

    def emit(rec):
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    verts, model, K = C.kernel_bodies()
    for win in C.KERNEL_WINDOWS:
        emit(dict(C.kernel_check(win, verts, model, K, reps=args.reps),
                  kind="check"))
    if args.sweep:
        for geo in sweep_geometries():
            try:
                f, fb = kernel_times(160, verts, model, K, geo, args.reps)
                emit({"kind": "sweep", "window": 160,
                      "geometry": geo._asdict(), "kernel_fwd_ms": f,
                      "kernel_fwdbwd_ms": fb})
            except Exception as e:       # a geometry the compiler refuses
                emit({"kind": "sweep", "window": 160,
                      "geometry": geo._asdict(),
                      "error": f"{type(e).__name__}: {e}"[:300]})


if __name__ == "__main__":
    main()
