"""Parallel MuPoTs TS1..TS20 sweep: one process per sequence, pinned
round-robin to the host's GPUs.

The per-sequence optimizations are independent (the reference runs
them as a sequential shell loop, script/predict_mupots_full.sh), so on
a multi-GPU host the sweep is embarrassingly parallel across cards;
the frame-axis SPMD inside each sequence (parallel/spmd.py) is the
tool when ONE long sequence must finish fast.

Each worker process gets `CUDA_VISIBLE_DEVICES=<slot>`, so JAX in that
process sees exactly one card: a JAX process reserves most of a
card's memory when it starts, so two workers must never share one.
With `--platform cpu` the sweep runs CPU workers instead (used by the
tests and useful for smoke runs).

Usage:
    python script/predict_mupots_sweep.py \
        --configs_yml configs/predict_mupots.yml \
        --output_path ./output/mupots \
        --workers 4 [--ts 1,2,5] [--retries 1]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_commands(ts_ids, configs_yml, output_path, extra_args=()):
    """One predict_mupots invocation per TS id."""
    return [
        [sys.executable, "-m", "mhmocap.predict_mupots",
         "--configs_yml", configs_yml, "--ts_id", str(ts),
         "--output_path", output_path, *extra_args]
        for ts in ts_ids
    ]


def worker_env(slot: int, platform: str = "gpu") -> dict:
    """Environment for a worker pinned to device `slot`."""
    env = dict(os.environ)
    if platform == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["CUDA_VISIBLE_DEVICES"] = str(slot)
        # a CPU-only orchestrator's forcing must not leak into workers
        env.pop("JAX_PLATFORMS", None)
    # workers share one compile cache (TS sequences bucket to the same
    # padded shapes): an outside JAX_COMPILATION_CACHE_DIR wins;
    # otherwise GPU workers use the repo's fixed cache (the entry
    # points' own default) and CPU workers the host-fingerprinted one
    # (CPU AOT entries from another host can crash on load,
    # mhmocap/cache.py)
    if platform == "cpu" and not env.get("JAX_COMPILATION_CACHE_DIR"):
        if REPO not in sys.path:
            sys.path.insert(0, REPO)
        from mhmocap.cache import cpu_cache_dir
        env["JAX_COMPILATION_CACHE_DIR"] = cpu_cache_dir(REPO)
    return env


def run_sweep(cmds, workers: int, platform: str = "gpu",
              log_dir: str | None = None, retries: int = 0,
              labels=None, job_timeout: float | None = None):
    """Run `cmds` over `workers` pinned slots; returns
    {label: returncode}. A failed command is retried up to `retries`
    times on the same slot before being recorded as failed. A job
    exceeding `job_timeout` seconds is killed and recorded/retried as
    rc=124 (an unbounded worker would turn one hung sequence into a
    stuck sweep)."""
    labels = labels or [f"job{i}" for i in range(len(cmds))]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    queue = list(zip(labels, cmds))
    results = {}
    lock = threading.Lock()

    def pump(slot):
        while True:
            with lock:
                if not queue:
                    return
                label, cmd = queue.pop(0)
            env = worker_env(slot, platform)
            for attempt in range(retries + 1):
                t0 = time.time()
                log_f = None
                if log_dir:
                    log_f = open(os.path.join(log_dir, f"{label}.log"),
                                 "ab")
                try:
                    try:
                        rc = subprocess.run(
                            cmd, cwd=REPO, env=env, stdout=log_f,
                            stderr=subprocess.STDOUT if log_f else None,
                            timeout=job_timeout,
                        ).returncode
                    except subprocess.TimeoutExpired:
                        rc = 124
                finally:
                    if log_f:
                        log_f.close()
                dt = time.time() - t0
                print(f"[slot {slot}] {label}: rc={rc} ({dt:.0f}s, "
                      f"attempt {attempt + 1})", flush=True)
                if rc == 0:
                    break
            with lock:
                results[label] = rc

    threads = [threading.Thread(target=pump, args=(s,))
               for s in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs_yml",
                    default="configs/predict_mupots.yml")
    ap.add_argument("--output_path", default="./output/mupots")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--ts", default=",".join(str(i)
                                             for i in range(1, 21)))
    ap.add_argument("--platform", default="gpu",
                    choices=["gpu", "cpu"])
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--log_dir", default=None,
                    help="per-TS log files (default: stream to stdout)")
    args, extra = ap.parse_known_args()

    ts_ids = [int(t) for t in args.ts.split(",") if t]
    cmds = build_commands(ts_ids, args.configs_yml, args.output_path,
                          extra)
    labels = [f"TS{t}" for t in ts_ids]
    t0 = time.time()
    results = run_sweep(cmds, min(args.workers, len(cmds)),
                        platform=args.platform, log_dir=args.log_dir,
                        retries=args.retries, labels=labels)
    failed = {k: v for k, v in results.items() if v != 0}
    print(f"sweep: {len(results) - len(failed)}/{len(results)} ok in "
          f"{time.time() - t0:.0f}s"
          + (f"; FAILED: {sorted(failed)}" if failed else ""))
    audit_windows(args.output_path, ts_ids)
    sys.exit(1 if failed else 0)


def audit_windows(output_path: str, ts_ids):
    """Post-run audit: surface each sequence's raster window and
    residual supervision clip rate from the stage-1 artifacts (the
    window guard otherwise reports only via stdout at init)."""
    import pickle
    for ts in ts_ids:
        pkl = os.path.join(output_path, f"TS{ts}", "optvar_stage1.pkl")
        if not os.path.exists(pkl):
            continue
        with open(pkl, "rb") as f:
            ov = pickle.load(f)
        win = ov.get("raster_window")
        clip = ov.get("window_clip_rate")
        if win is not None:
            flag = " !" if (clip or 0) > 0 else ""
            print(f"TS{ts}: raster_window={win} "
                  f"clip_rate={100 * (clip or 0):.2f}%{flag}")


if __name__ == "__main__":
    main()
