"""Native host-side kernels (C++), with transparent numpy fallbacks.

Builds `_native` (fillin_values, hungarian) from fast_ops.cpp on first
import via the system toolchain; if compilation is unavailable the
pure-python equivalents are used (scipy's linear_sum_assignment and a
vectorized numpy fill-in), so the package never hard-depends on a
compiler at runtime.

    from mhmocap.native import fillin_values, hungarian
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_native" + (sysconfig.get_config_var(
    "EXT_SUFFIX") or ".so"))

_native = None


def _build() -> bool:
    src = os.path.join(_DIR, "fast_ops.cpp")
    if not os.path.exists(src):
        return False
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(src)):
        return True
    inc_py = sysconfig.get_paths()["include"]
    inc_np = np.get_include()
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
        "-std=c++17", f"-I{inc_py}", f"-I{inc_np}", src, "-o", _SO,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True,
                       timeout=240)
        return True
    except Exception as e:  # pragma: no cover - toolchain dependent
        sys.stderr.write(f"mhmocap.native: build failed ({e}); "
                         "using python fallbacks\n")
        return False


def _load():
    global _native
    if _native is not None:
        return _native
    if _build():
        import importlib.util
        spec = importlib.util.spec_from_file_location("_native", _SO)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
            _native = mod
        except Exception:  # pragma: no cover
            _native = False
    else:
        _native = False
    return _native


def have_native() -> bool:
    return bool(_load())


def hungarian(cost: np.ndarray):
    """Optimal assignment (rows, cols) like linear_sum_assignment."""
    mod = _load()
    if mod:
        return mod.hungarian(np.ascontiguousarray(cost, np.float64))
    from scipy.optimize import linear_sum_assignment
    return linear_sum_assignment(cost)


def fillin_values(x: np.ndarray, mask: np.ndarray, filter_size: int,
                  metric: str = "median"):
    """One masked neighborhood fill-in iteration (reference
    utils.py:91-135 semantics: reads the pre-iteration mask)."""
    mod = _load()
    metric_id = {"median": 0, "mean": 1, "max": 2, "min": 3}[metric]
    if mod:
        return mod.fillin_values(
            np.ascontiguousarray(x, np.float32),
            np.ascontiguousarray(mask, np.float32), filter_size,
            metric_id)
    # numpy fallback (vectorized): one rank-filter pass
    import jax
    import jax.numpy as jnp
    from ..ops.image import masked_window_median
    if metric != "median":
        raise NotImplementedError(
            "python fallback supports median only")
    with jax.default_device(jax.devices("cpu")[0]):
        med, ok = masked_window_median(
            jnp.asarray(x, jnp.float32), jnp.asarray(mask), filter_size)
        newly = (jnp.asarray(mask) < 0.5) & ok
        xf = jnp.where(newly, med, jnp.asarray(x, jnp.float32))
        mf = jnp.where(newly, 1.0, jnp.asarray(mask, jnp.float32))
    return np.asarray(xf), np.asarray(mf)
