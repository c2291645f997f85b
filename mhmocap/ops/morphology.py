"""Binary morphology on regular grids.

Capability parity with the reference `mhmocap/morphology.py`
(thresholded conv2d erode/dilate, morphology.py:6-41) and the OpenCV
erode/dilate calls in ingestion (datautils.py:99-106). Implemented
with `lax.reduce_window` min/max pooling — the exact set-theoretic
definition of binary erosion/dilation with a square structuring
element, and cheaper than a thresholded conv.

All functions treat >= 0.5 as foreground and return {0., 1.} float
maps, matching the reference's thresholding semantics
(morphology.py:25-31).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _pool(x: jax.Array, kernel_size: int, op: str) -> jax.Array:
    """Min/max pool with SAME padding over the last two axes."""
    k = kernel_size
    nd = x.ndim
    window = (1,) * (nd - 2) + (k, k)
    strides = (1,) * nd
    pads = [(0, 0)] * (nd - 2) + [(k // 2, k // 2)] * 2
    if op == "min":
        return lax.reduce_window(x, jnp.inf, lax.min, window, strides, pads)
    return lax.reduce_window(x, -jnp.inf, lax.max, window, strides, pads)


def erode(x: jax.Array, kernel_size: int = 5, iterations: int = 1):
    """Binary erosion of (..., H, W) with a square structuring element."""
    y = (x >= 0.5).astype(x.dtype)
    for _ in range(iterations):
        y = _pool(y, kernel_size, "min")
    return y


def dilate(x: jax.Array, kernel_size: int = 5, iterations: int = 1):
    """Binary dilation of (..., H, W) with a square structuring element."""
    y = (x >= 0.5).astype(x.dtype)
    for _ in range(iterations):
        y = _pool(y, kernel_size, "max")
    return y


def erode_labels(labels: jax.Array, iterations: int) -> jax.Array:
    """Erode an integer label map without gluing touching instances.

    Mirrors the ingestion-time instance erosion (datautils.py:95-104):
    first mask out pixels where a 3x3 erode and dilate of the label map
    disagree (instance boundaries and contact lines), then erode the
    surviving labels `iterations - 1` more times.
    """
    if iterations <= 0:
        return labels
    lab = labels.astype(jnp.float32)
    lab_e = _pool(lab, 3, "min")
    lab_d = _pool(lab, 3, "max")
    out = jnp.where(lab_e == lab_d, lab, 0.0)
    for _ in range(iterations - 1):
        # Erode the binary support; keep labels where support survives.
        support = _pool((out > 0).astype(jnp.float32), 3, "min")
        out = out * support
    return out.astype(labels.dtype)
