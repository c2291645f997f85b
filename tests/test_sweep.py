"""Sweep orchestrator tests: scheduling, pinning env, retry logic.

The heavy per-sequence payload is replaced with trivial commands; the
end-to-end predict path itself is covered by tests/test_e2e_pipeline.
"""

import os

import numpy as np
import pytest
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "script"))

import predict_mupots_sweep as sweep  # noqa: E402


def test_build_commands_shape():
    cmds = sweep.build_commands([1, 7], "cfg.yml", "/out",
                                ["--num_iter", "5"])
    assert len(cmds) == 2
    assert "--ts_id" in cmds[0] and "1" in cmds[0]
    assert cmds[1][cmds[1].index("--ts_id") + 1] == "7"
    assert cmds[0][-2:] == ["--num_iter", "5"]


def test_worker_env_pins_one_chip():
    env = sweep.worker_env(3, platform="gpu")
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    env = sweep.worker_env(0, platform="cpu")
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "JAX_COMPILATION_CACHE_DIR" in env


def test_run_sweep_schedules_all_jobs(tmp_path):
    marker = tmp_path / "done"
    cmds = [[sys.executable, "-c",
             f"open(r'{marker}_{i}', 'w').write('x')"]
            for i in range(5)]
    res = sweep.run_sweep(cmds, workers=2, platform="cpu",
                          labels=[f"TS{i}" for i in range(5)])
    assert res == {f"TS{i}": 0 for i in range(5)}
    for i in range(5):
        assert os.path.exists(f"{marker}_{i}")


def test_run_sweep_job_timeout_kills_hung_worker():
    """A worker exceeding job_timeout is killed and recorded as
    rc=124 instead of hanging the sweep forever."""
    import time
    t0 = time.time()
    res = sweep.run_sweep(
        [[sys.executable, "-c", "import time; time.sleep(60)"],
         [sys.executable, "-c", "pass"]],
        workers=1, platform="cpu", labels=["hung", "ok"],
        job_timeout=2.0)
    assert res == {"hung": 124, "ok": 0}
    assert time.time() - t0 < 30


def test_worker_env_scrubs_cpu_forcing_for_gpu(monkeypatch):
    """A CPU-only orchestrator (synthetic_e2e_sweep main process)
    must not leak its JAX_PLATFORMS into GPU workers."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    env = sweep.worker_env(1, platform="gpu")
    assert "JAX_PLATFORMS" not in env
    assert env["CUDA_VISIBLE_DEVICES"] == "1"


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_worker_env_keeps_outside_compile_cache(monkeypatch, platform):
    """An outside JAX_COMPILATION_CACHE_DIR reaches every worker as
    is; without one, CPU workers get the host-fingerprinted cache and
    GPU workers the entry points' own default."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/cache/outside")
    env = sweep.worker_env(0, platform=platform)
    assert env["JAX_COMPILATION_CACHE_DIR"] == "/cache/outside"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    env = sweep.worker_env(0, platform=platform)
    if platform == "cpu":
        assert ".jax_cache_cpu_" in env["JAX_COMPILATION_CACHE_DIR"]
    else:
        assert "JAX_COMPILATION_CACHE_DIR" not in env


def test_run_sweep_reports_failures_and_retries(tmp_path):
    # first attempt fails, the retry succeeds (file-existence toggle)
    flag = tmp_path / "flag"
    toggle = (f"import os,sys; p=r'{flag}'; "
              "sys.exit(0) if os.path.exists(p) else "
              "(open(p,'w').close(), sys.exit(3))")
    res = sweep.run_sweep(
        [[sys.executable, "-c", toggle],
         [sys.executable, "-c", "import sys; sys.exit(2)"]],
        workers=1, platform="cpu", retries=1, labels=["a", "b"])
    assert res["a"] == 0          # retry healed it
    assert res["b"] == 2          # persistent failure reported


@pytest.mark.slow
def test_synthetic_e2e_sweep_script_smoke(tmp_path):
    """The in-tree accuracy-sweep script end-to-end at CPU smoke
    scale: generate -> predict (subprocess, CPU worker) -> eval ->
    one JSON line with the averaged FinalResults metrics."""
    import json
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable,
         os.path.join(repo, "script", "synthetic_e2e_sweep.py"),
         "--workdir", str(tmp_path), "--num_seqs", "1",
         "--frames", "6", "--num_iter", "2", "--platform", "cpu",
         "--image_size", "96", "--num_vertices", "512",
         "--raster_window", "64"],
        capture_output=True, text=True, timeout=600,
        # O1 XLA:CPU in the subprocesses too (same rationale as
        # conftest.py: O3 is compile-heavy and slower for this engine)
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                           + " --xla_backend_optimization_level=1"
                           ).strip()})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    line = [ln for ln in out.stdout.strip().splitlines()
            if ln.startswith("{")][-1]
    res = json.loads(line)
    assert res["metric"] == "synthetic_e2e_sweep"
    assert np.isfinite(res["avg"]["pck_rel"])
    assert 0.0 <= res["avg"]["pck_rel"] <= 100.0


def test_check_bounds_pins_each_tier():
    """The pinned accuracy bounds (round-4 verdict weak #4) must fail
    LOUD: below-floor pck or above-ceiling mm_rel/jitter in the tier
    average produces a violation string; passing values produce none.
    Hard-clean sequences are bounded separately from the standard
    clean ones, and degraded runs are only checked under the robust
    knobs."""
    import synthetic_e2e_sweep as S

    def final(pck, mm, jit=10.0):
        # per-TS lists + trailing instance-weighted Avg (ignored)
        return {"pck_rel": pck + [0.0], "mm_rel_error": mm + [0.0],
                "abs_jitter": [jit] * len(pck) + [0.0]}

    # clean tier, all good
    n, v = S.check_bounds(final([99.0, 98.6], [40.0, 45.0]),
                          n_std=2, n_hard=0, degraded=False,
                          robust=False)
    assert n == 2 and v == []

    # clean pck regression caught
    _, v = S.check_bounds(final([98.0, 98.0], [40.0, 40.0]),
                          n_std=2, n_hard=0, degraded=False,
                          robust=False)
    assert any("pck_rel" in s and "clean" in s for s in v)

    # mm_rel drift caught (the 40.3 -> 47.2 failure mode, now > 48)
    _, v = S.check_bounds(final([99.0, 99.0], [49.0, 49.0]),
                          n_std=2, n_hard=0, degraded=False,
                          robust=False)
    assert any("mm_rel_error" in s for s in v)

    # hard sequences bounded separately: std fine, hard pck too low
    _, v = S.check_bounds(
        final([99.0, 99.0, 80.0], [40.0, 40.0, 60.0]),
        n_std=2, n_hard=1, degraded=False, robust=False)
    assert any(s.startswith("hard pck_rel") for s in v)
    assert not any(s.startswith("clean") for s in v)

    # empty clean tier (--num_seqs 0 --hard_clean N): no nan-mean
    # sneaking a silent pass — only the hard checks are evaluated
    n, v = S.check_bounds(final([89.52, 99.52], [71.44, 24.29]),
                          n_std=0, n_hard=2, degraded=False,
                          robust=False)
    assert n == 2 and v == []
    assert all(np.isfinite(b) for _, (_, b) in S.BOUNDS["hard"].items())

    # degraded: only the robust-knob runs are pinned
    n, _ = S.check_bounds(final([90.0], [70.0], jit=50.0),
                          n_std=1, n_hard=0, degraded=True,
                          robust=False)
    assert n == 0
    _, v = S.check_bounds(final([96.0], [55.0], jit=50.0),
                          n_std=1, n_hard=0, degraded=True, robust=True)
    assert any("abs_jitter" in s for s in v)


def test_hard_clean_plan_and_motion_kinematics():
    """hard_clean_plan cycles fast/close scenarios and the generator's
    `motion` knob actually hardens the kinematics: speed multiplies
    inter-frame displacement; close_pair keeps persons 0/1 within
    ~0.6 m laterally at near-equal depth (persistent mask overlap)."""
    import synthetic_e2e_sweep as S
    from mhmocap.data.synthetic import generate_sequence
    import tempfile

    p0, p1 = S.hard_clean_plan(0), S.hard_clean_plan(1)
    assert p0["motion"]["speed"] > 1 and p1["motion"]["close_pair"]
    assert S.hard_clean_plan(2) == p0                   # cycles

    with tempfile.TemporaryDirectory() as d:
        gt_std = generate_sequence(
            os.path.join(d, "std"), num_frames=8, num_people=2,
            image_size=(64, 64), num_vertices=128, seed=11)
        gt_fast = generate_sequence(
            os.path.join(d, "fast"), num_frames=8, num_people=2,
            image_size=(64, 64), num_vertices=128, seed=11,
            motion=p0["motion"])
        gt_close = generate_sequence(
            os.path.join(d, "close"), num_frames=8, num_people=2,
            image_size=(64, 64), num_vertices=128, seed=11,
            motion=p1["motion"], degradations=p1["degradations"])

    def disp(gt):
        pT = gt["poses_T"]
        return float(np.abs(pT[1:] - pT[:-1]).max())

    assert disp(gt_fast) > 1.5 * disp(gt_std)
    dx = np.abs(gt_close["poses_T"][:, 0, 0, 0]
                - gt_close["poses_T"][:, 1, 0, 0])
    dz = np.abs(gt_close["poses_T"][:, 0, 0, 2]
                - gt_close["poses_T"][:, 1, 0, 2])
    assert dx.max() < 1.2 and dz.max() < 0.8


def test_jitter_decomposition_frame_classes():
    """decompose_jitter classifies frames exactly: stale anywhere ->
    gap; clear frame adjacent to a gap -> flank (the during-fit smear
    target class); everything else clear. Per-frame jitter is the
    masked mean in mm."""
    import decompose_jitter as D

    stale = np.zeros((8, 2), bool)
    stale[3:5, 0] = True
    cls = D.classify_frames(stale)
    assert cls.tolist() == [0, 0, 2, 1, 1, 2, 0, 0]

    m = {"abs_jitter": np.ones((4, 1, 14), np.float32) * 0.002,
         "valid_joints": np.ones((4, 1, 14), np.float32)}
    m["valid_joints"][2] = 0.0          # fully invisible frame
    jmm = D.frame_jitter_mm(m)
    np.testing.assert_allclose(jmm[[0, 1, 3]], 2.0, rtol=1e-6)
    assert jmm[2] == 0.0                 # masked, not NaN


def test_degradation_plan_covers_every_mode():
    """--degraded assigns each TS one isolated robustness path, the
    fifth combines them all, and ids past 5 wrap around."""
    import synthetic_e2e_sweep as S

    plans = [S.degradation_plan(i, frames=60) for i in range(1, 6)]
    assert plans[0] == {"crossing_paths": True}
    assert plans[1]["detection_dropout"] > 0
    assert len(plans[1]["id_switch_spans"]) == 2
    assert plans[2]["romp_person_dropout"] > 0
    assert plans[2]["romp_missing_frames"] > 0
    assert plans[3] == {"enter_leave": True}
    combined = plans[4]
    for key in ("crossing_paths", "enter_leave", "id_switch_spans",
                "detection_dropout", "romp_person_dropout",
                "romp_missing_frames"):
        assert key in combined, key
    # id switch spans stay inside the sequence
    for p in plans:
        for t0, t1 in p.get("id_switch_spans", []):
            assert 0 <= t0 < t1 <= 60
    assert S.degradation_plan(6, 60) == plans[0]   # wraps
