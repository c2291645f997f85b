"""Print what XLA compiles `engine.scene.mean_knn_point`'s
`lax.approx_min_k` into on the default backend, at the production
scene size (256x256 points, 32 neighbours) and a contact-query batch.

Usage: python script/knn_lowering.py
"""

import collections
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mhmocap.engine.scene import ScenePointCloud, mean_knn_point  # noqa


def main():
    M, Q = 256 * 256, 29 * 3 * 2
    pcd = ScenePointCloud(points=jnp.ones((M, 3)),
                          valid=jnp.ones((M,), bool),
                          depth=jnp.ones((256, 256)),
                          depth_valid=jnp.ones((256, 256), bool))
    q = jnp.zeros((Q, 3))
    hlo = jax.jit(lambda q, p: mean_knn_point(q, p, k=32)).lower(
        q, pcd).compile().as_text()
    kinds = collections.Counter(
        m.group(1) for line in hlo.splitlines()
        if "approx_top_k" in line
        for m in [re.search(r"=\s.*?\s([a-z][\w-]*)\(", line)] if m)
    calls = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    print(f"{jax.devices()[0].device_kind}: ops tagged approx_top_k: "
          f"{dict(kinds)}; custom-calls: {calls}")


if __name__ == "__main__":
    main()
