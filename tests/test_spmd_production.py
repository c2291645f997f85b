"""Production-shape SPMD parity (round-2 verdict: don't validate the
sharded cycle only on the 32x32 toy).

Shapes follow the MuPoTs production TIME structure at T=201 real
frames, in BOTH time layouts the engine can produce:

* ``tuned``: chunk 26 / bucket 208 — what ``Predictor.__init__``'s
  SPMD auto-chunk tuner picks at T=201 on 8 devices (padded 208,
  3.4% padding, ONE local chunk per device, 7 padded frames in the
  tail device) — the actual production shape since round 4;
* ``multi-chunk``: chunk 8 / bucket 64 (padded 256, 4 local chunks
  per device, 55 padded tail frames) — exercises the multi-chunk
  local scan and halo exchange across LOCAL chunks, which the tuned
  layout no longer hits at this T.

The body model is small (V=128) to keep the interpret-mode Pallas
raster tractable on the CPU mesh — the structural hazards being
tested (multi-chunk scans per device, halo exchange across devices
AND across local chunks, padded-frame gating at the sequence tail,
guard-sized window) do not depend on vertex count.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mhmocap.engine import optimizer as E
from mhmocap.parallel import spmd
from mhmocap.models.synthetic import make_synthetic_smpl
from mhmocap.models.smpl import smpl_forward
from mhmocap.ops.cameras import project_points, intrinsics_from_fov

pytestmark = [pytest.mark.slow, pytest.mark.isolated]


@pytest.fixture(scope="module",
                params=[(26, 208, 208), (8, 64, 256)],
                ids=["tuned-c26", "multichunk-c8"])
def prod_problem(request):
    chunk, bucket, padded = request.param
    model = make_synthetic_smpl(num_vertices=128, seed=6)
    T, N = 201, 2
    W = H = 128
    K = intrinsics_from_fov((W, H), 60.0)
    rng = np.random.RandomState(0)

    poses_smpl = 0.05 * rng.randn(T, N, 72).astype(np.float32)
    betas = np.zeros((T, N, 10), np.float32)
    poses_T_gt = np.zeros((T, N, 1, 3), np.float32)
    poses_T_gt[:, :, 0, 2] = np.linspace(3.0, 4.0, N)[None]
    poses_T_gt[:, :, 0, 0] = np.linspace(-0.5, 0.5, N)[None]
    out = smpl_forward(model, jnp.asarray(betas.reshape(-1, 10)),
                       jnp.asarray(poses_smpl.reshape(-1, 72)))
    j3d = np.asarray(out["joints_alphapose"]).reshape(T, N, 17, 3) \
        + poses_T_gt
    uv = np.asarray(project_points(jnp.asarray(j3d), jnp.asarray(K)))
    pose2d = np.concatenate(
        [uv, 0.9 * np.ones((T, N, 17, 1), np.float32)], -1)

    cfg = E.EngineConfig(image_size=(W, H), num_people=N, num_frames=T,
                         chunk=chunk, window=128, face_chunk=128,
                         frame_bucket=bucket)
    assert cfg.padded_frames == padded
    params, _, _ = E.init_params(model, pose2d, poses_smpl, betas, K,
                                 cfg, num_iter=10)

    from mhmocap.data.ingestion import SequenceArrays
    seg = np.zeros((T, N, H, W), np.float32)
    seg[:, 0, 30:100, 20:60] = 1
    seg[:, 1, 30:100, 70:110] = 1
    seq = SequenceArrays(
        images=np.zeros((T, H, W, 3), np.uint8),
        depths=np.clip(0.5 + 0.1 * rng.randn(T, H, W), 0, 1).astype(
            np.float32),
        instances=np.zeros((T, H, W), np.uint8),
        seg_mask=seg,
        backmasks=1.0 - seg.max(axis=1),
        pose2d=pose2d,
        cam_smpl=np.zeros((T, N, 3), np.float32),
        poses_smpl=poses_smpl,
        betas_smpl=betas,
        valid_smpl=np.ones((T, N, 1), np.float32),
        frame_ids=np.arange(T),
        cam={"K": K, "fov": 60.0, "Kd": None, "image_size": (W, H)},
    )
    data = E.prepare_seq_data(seq, cfg)
    # warm aux: scene + filtered targets engaged, like the production
    # steady state past cycle 30
    aux = E.init_aux(cfg, model.num_vertices,
                     jnp.asarray(betas[:1].mean(0, keepdims=True)))
    pcd = E.update_scene(params, data, cfg)
    dvf = E.update_filtered_targets(params, model, cfg)
    aux = aux._replace(scene=pcd, have_scene=jnp.ones(()),
                       verts_filt_diff=dvf, have_filters=jnp.ones(()))
    return dict(model=model, cfg=cfg, params=params, data=data,
                aux=aux, coefs=E.default_coefs())


@pytest.mark.slow
def test_spmd_production_shape_cycle_matches_single_device(
        prod_problem):
    p = prod_problem
    mesh = spmd.make_mesh()
    opt = E.make_stage1_optimizer()

    params_1, _, loss_1, parts_1 = E.stage1_cycle(
        jax.tree.map(jnp.copy, p["params"]), opt.init(p["params"]),
        p["model"], p["data"], p["aux"], p["coefs"], p["cfg"])

    params_s = spmd.shard_params(jax.tree.map(jnp.copy, p["params"]),
                                 mesh)
    data_s = spmd.shard_data(p["data"], mesh)
    aux_s = spmd.shard_aux(p["aux"], mesh)
    params_8, _, loss_8, parts_8 = spmd.spmd_stage1_cycle(
        params_s, opt.init(params_s), p["model"], data_s, aux_s,
        p["coefs"], p["cfg"], mesh)

    np.testing.assert_allclose(float(loss_8), float(loss_1), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(parts_8),
                               np.asarray(parts_1), rtol=5e-3,
                               atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(params_8.poses_T), np.asarray(params_1.poses_T),
        atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(params_8.poses_smpl),
        np.asarray(params_1.poses_smpl), atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(params_8.betas), np.asarray(params_1.betas),
        atol=5e-5)
    # padded tail frames received no update on either path
    T = p["cfg"].num_frames
    np.testing.assert_array_equal(
        np.asarray(params_8.poses_T)[T:],
        np.asarray(p["params"].poses_T)[T:])


@pytest.mark.slow
def test_fused_cycle_compiled_collectives_within_budget(prod_problem):
    """Audit what GSPMD ACTUALLY compiles for the fused production
    cycle against the analytic inter-device budget (read out of the
    compiled HLO). Audited facts this pins (script/audit_collectives
    measured identical totals at V=128 and V=6890 — no collective
    scales with the body):

    * halo `collective-permute`s stay ~2 KB/device/cycle;
    * the One-Euro refresh all-gathers only the POSES (O(T*N*72)),
      never the vertex trajectories (O(T*N*V));
    * the scene-median refresh moves O(H*W) all-reduces, never an
      O(T*H*W) depth-stack gather;
    * nothing else appears (no all-to-all / reduce-scatter surprise).
    """
    p = prod_problem
    cfg = p["cfg"]
    if cfg.chunk != 26:
        pytest.skip("the collective budget is audited at the tuned "
                    "production time layout (chunk 26 / padded 208)")
    from mhmocap.parallel.hlo_audit import (collective_totals,
                                                extract_collectives)

    mesh = spmd.make_mesh()
    opt = E.make_stage1_optimizer()
    params_s = spmd.shard_params(p["params"], mesh)
    data_s = spmd.shard_data(p["data"], mesh)
    aux_s = spmd.shard_aux(p["aux"], mesh)
    compiled = spmd.spmd_stage1_cycle_fused.lower(
        params_s, opt.init(params_s), aux_s, jnp.uint32(30),
        p["model"], data_s, p["coefs"], cfg, mesh,
        optimize_scale=True).compile()
    hlo = compiled.as_text()

    totals = collective_totals(hlo)
    Tp, N = cfg.padded_frames, cfg.num_people
    W, H = cfg.image_size
    # halos: 1 frame of poses_T/poses_smpl fwd + bwd cotangents +
    # frame_valid, ~1.8 KB audited; 2x headroom
    assert totals.get("collective-permute", 0) <= 4 * 1024, totals
    # pose gathers for the filtered-target refresh: full poses_smpl
    # (Tp,N,72) + poses_T (Tp,N,1,3) f32, audited 187,200 B; the
    # bound excludes any O(T*N*V) vertex gather by 20x margin
    assert totals.get("all-gather", 0) <= int(
        1.5 * Tp * N * (72 + 3) * 4), totals
    # scene median + grad/loss psums: O(H*W)-shaped plus a handful of
    # scalar loss/grad psums (audited 196,740 B at this 128 px shape;
    # 786,608 B at the 256 px production side). The bound excludes any
    # O(Tp*H*W) depth gather (which would be >= 26x over it).
    assert totals.get("all-reduce", 0) <= 3 * H * W * 4 + 8192, totals
    # no other collective kind appears
    assert set(totals) <= {"collective-permute", "all-gather",
                           "all-reduce"}, totals
    # and no SINGLE collective moves more than ~0.6 MB (largest
    # audited: the (f32[1,H,W] x2) scene tuple all-reduce, 524 KB)
    biggest = max(b for _, _, b in extract_collectives(hlo))
    assert biggest <= 3 * H * W * 4, biggest
