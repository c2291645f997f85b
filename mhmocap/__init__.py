"""mhmocap — scene-aware 3D multi-human motion capture in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference implementation `dluvizon/scene-aware-3d-multi-human`
(EUROGRAPHICS/CGF 2023): absolute 3D position, SMPL shape/articulation and
per-person scale of multiple humans plus a static scene point cloud,
recovered from a single static-camera RGB video by non-linear space-time
optimization over four precomputed input modalities (AlphaPose 2D
keypoints+tracking, DPT normalized disparity, ROMP initial SMPL
parameters, Mask2Former person instance masks).

Design principles (accelerator-first, not a port):
  * the whole optimization is a single jitted program per cycle — no
    host<->device syncs in the hot loop (the reference syncs dozens of
    times per cycle, see reference optimizer.py:375-602);
  * SMPL LBS is a batched, vmapped pure function with a level-parallel
    kinematic-chain composition instead of a python loop over joints;
  * the differentiable depth/silhouette rasterizer runs on per-person
    crop windows (static shapes) instead of full images;
  * the sequence (time) axis is shardable across a `jax.sharding.Mesh`,
    with XLA/GSPMD inserting halo exchanges for temporal finite
    differences and psums for time-shared variable gradients.
"""

__version__ = "0.1.0"
