"""Pin the bench.py workload's DERIVED configuration.

bench.py's workload must stay the TS1-scale production shape (201
frames, 3 people, guard-grown 160 px window, the auto-tuned scan
chunk) or its numbers silently stop being comparable across PRs. This
test locks the config the Predictor derives from bench.make_ts1_like_seq
so any change to the guard/auto-chunk logic that would shift the
benchmarked shape fails loudly here first.
"""

import tempfile

import numpy as np
import pytest


@pytest.fixture(scope="module")
def bench_seq():
    import bench
    return bench.make_ts1_like_seq()


def _bench_args():
    import bench
    return bench.fit_args(num_iter=2, spmd=False)


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats, budget", [
    ({"bytes_limit": 60e9, "bytes_in_use": 0}, 0.375 * 60e9),
    ({"bytes_limit": 12e9}, 0.375 * 12e9),
    (None, 0.375 * 16e9),                 # CPU: no stats reported
    ({}, 0.375 * 16e9),
])
def test_remat_budget_from_device_memory(monkeypatch, stats, budget):
    """use_remat's threshold follows memory_stats()['bytes_limit'] of
    the default device, with a stated fallback where none is reported;
    the bench shape stays store-all on a card as small as 12 GB while
    a 2,300-frame sequence rematerializes there."""
    from mhmocap.engine import optimizer as E

    dev = _FakeDevice(stats)
    assert E.residual_budget_bytes(dev) == pytest.approx(budget)
    monkeypatch.setattr(E.jax, "devices", lambda: [dev])
    cfg = E.EngineConfig(image_size=(256, 256), num_people=3,
                         num_frames=201, chunk=29, frame_bucket=29,
                         window=160, windows=(160, 128, 112))
    assert not cfg.use_remat
    long = E.EngineConfig(image_size=(256, 256), num_people=3,
                          num_frames=2300, chunk=25, frame_bucket=25,
                          window=160, windows=(160, 128, 112))
    assert long.use_remat == (long.padded_frames * 3 * (
        1.7e6 + 16.0 * np.mean([160 ** 2, 128 ** 2, 112 ** 2]))
        > budget)


@pytest.mark.slow
def test_bench_workload_config_is_pinned(bench_seq):
    from mhmocap.engine.predictor import Predictor

    seq, model = bench_seq
    assert (seq.num_frames, seq.num_people) == (201, 3)
    assert seq.image_size == (256, 256)

    with tempfile.TemporaryDirectory() as tmp:
        pred = Predictor(seq, model, tmp, _bench_args())
    cfg = pred.cfg

    # the window guard must neither grow past the TS1 window nor
    # leave clipped supervision (bench.py places the nearest body at
    # z=3.4 specifically so the 99th-percentile bbox need lands just
    # under 160 px)
    assert cfg.window == 160
    assert pred.window_clip_rate == 0.0

    # per-person crop windows: one per depth (z = 3.4 / 4.2 / 5.0),
    # descending, multiples of 16 (kernel-cell geometry — see
    # Predictor._person_windows), zero residual clip for every person
    assert cfg.windows == (160, 128, 112)
    assert pred.window_clip_rates == (0.0, 0.0, 0.0)
    assert cfg.window_groups == ((160, (0,)), (128, (1,)), (112, (2,)))

    # auto-tuned scan chunk (tune_time_layout): 7 steps of 29 at
    # padded 203 — 1% padding, single-device, no remat at this scale
    assert cfg.chunk == 29
    assert cfg.padded_frames == 203
    assert cfg.num_chunks == 7
    assert not cfg.use_remat
    assert cfg.preordered_faces

    # bench pins the ONE-card cadence: spmd must stay disengaged even
    # on a multi-device host (the test mesh has 8 CPU devices)
    assert cfg.frame_bucket == cfg.chunk


@pytest.mark.slow
def test_bench_workload_visibility(bench_seq):
    """Every person-frame must contribute 2D supervision (occupancy
    matches the MuPoTs working configuration the narrative claims)."""
    seq, _ = bench_seq
    conf = seq.pose2d[..., 2]
    assert float(np.min(conf)) > 0.5
    # projected joints stay inside the image for every body
    uv = seq.pose2d[..., :2]
    assert float(np.min(uv)) >= 0.0
    assert float(np.max(uv)) <= 256.0
