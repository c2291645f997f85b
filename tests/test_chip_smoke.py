"""chip_smoke.py rehearsed on the CPU at tiny sizes (the script itself
needs an NVIDIA GPU), and its refusal to run anywhere else."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Copied into a directory with nothing else of the repo (and, here,
    without a GPU), the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_kernel_check_rehearsal():
    """The kernel phase's comparison, with the kernel interpreted."""
    from bench import ts1_poses_T
    from mhmocap.models.smpl import smpl_forward
    from mhmocap.models.synthetic import make_synthetic_smpl
    from mhmocap.ops.cameras import intrinsics_from_fov
    from mhmocap.ops.rasterizer import preorder_faces

    model = preorder_faces(make_synthetic_smpl(num_vertices=256, seed=1))
    out = smpl_forward(model, jnp.zeros((3, 10)), jnp.zeros((3, 72)))
    v = out["verts"] + jnp.asarray(ts1_poses_T(1, 3).reshape(-1, 1, 3))
    K = jnp.asarray(intrinsics_from_fov((256, 256), 60.0))
    r = C.kernel_check(40, v, model, K, reps=1, interpret=True)
    assert r["covered_px"] > 100 and r["cover_mismatch"] == 0
    assert r["max_dzbuf"] <= C.MAX_DZBUF and r["max_dsil"] <= C.MAX_DSIL
    assert r["grad_finite"] and r["grad_rel"] <= C.MAX_GRAD_REL
    assert r["kernel_fwdbwd_ms"] > 0


def test_chip_smoke_e2e_rehearsal(monkeypatch, capsys):
    """The end-to-end phase (generate -> predict_mupots -> eval_mupots)
    at a tiny size: outputs, finite losses and metrics, timing marks."""
    monkeypatch.setenv("MHMOCAP_SYNTHETIC_SMPL", "256")
    C.e2e_phase("cpu", T=12, N=2, side=64, num_vertices=256)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("e2e [cpu] ")][-1]
    res = json.loads(line[len("e2e [cpu] "):])
    assert res["cycles"] == 45 and res["frames"] == 12
    assert all(np.isfinite(v)
               for v in res["last_cycle_loss_parts"].values())
    assert all(np.isfinite(v) for v in res["metrics"].values())
    assert res["steady_cycle_ms"] > 0


@pytest.mark.slow
def test_chip_smoke_four_rehearsal():
    """The --four comparison on four virtual CPU devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = ("import chip_smoke as C; "
            "C.four_phase('cpu', T=24, num_vertices=256)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "four [cpu]" in res.stdout
