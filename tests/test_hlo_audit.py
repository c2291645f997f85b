"""Unit tests for the compiled-HLO collective extraction
(parallel/hlo_audit.py) — the collective-budget regression test depends on
this parser reading optimized HLO correctly, so its contract is
pinned on hand-written HLO snippets."""

import numpy as np

from mhmocap.parallel.hlo_audit import (collective_totals,
                                            extract_collectives,
                                            shape_bytes)


def test_shape_bytes_scalars_tuples_and_unknown_dtypes():
    assert shape_bytes("f32[208,3,72]") == 208 * 3 * 72 * 4
    assert shape_bytes("bf16[16,128]") == 16 * 128 * 2
    assert shape_bytes("f32[]") == 4                      # scalar
    assert shape_bytes("(f32[1,256,256], f32[1,256,256])") \
        == 2 * 256 * 256 * 4
    assert shape_bytes("s32[256,256]{1,0}") == 256 * 256 * 4
    # tokens / unknown dtypes contribute nothing
    assert shape_bytes("token[]") == 0


def test_extract_collectives_kinds_and_start_done_dedup():
    hlo = "\n".join([
        "  %ag = f32[208,3,72]{2,1,0} all-gather(f32[26,3,72] %x), "
        "dimensions={0}",
        # async form: the (operand, result) tuple aliases the input —
        # only the larger element is the transfer
        "  %ags = (f32[26,3,72]{2,1,0}, f32[208,3,72]{2,1,0}) "
        "all-gather-start(f32[26,3,72] %y), dimensions={0}",
        "  %cp0 = f32[1,3,72]{2,1,0} collective-permute-start("
        "f32[1,3,72] %h), source_target_pairs={{0,1}}",
        "  %cp1 = f32[1,3,72]{2,1,0} collective-permute-done("
        "f32[1,3,72] %cp0)",
        "  %ar = (f32[1,256,256]{2,1,0}, f32[1,256,256]{2,1,0}) "
        "all-reduce(f32[1,256,256] %a, f32[1,256,256] %b), "
        "to_apply=%add",
        "  %dot = f32[128,128]{1,0} dot(f32[128,8] %p, f32[8,128] %c)",
    ])
    colls = extract_collectives(hlo)
    kinds = sorted(k for k, _, _ in colls)
    # '-done' is skipped ('-start' already carries the shape); the
    # plain dot is not a collective
    assert kinds == ["all-gather", "all-gather", "all-reduce",
                     "collective-permute"]

    totals = collective_totals(hlo)
    # sync form counts its result; async-start counts ONLY the larger
    # tuple element (not operand + result)
    assert totals["all-gather"] == 2 * 208 * 3 * 72 * 4
    assert totals["collective-permute"] == 3 * 72 * 4
    assert totals["all-reduce"] == 2 * 256 * 256 * 4


def test_extract_collectives_matches_live_compiled_module():
    """End-to-end on a REAL compiled psum: the parser must find one
    all-reduce moving exactly the operand bytes."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    devs = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devs, ("t",))

    def f(x):
        return jax.lax.psum(x, "t")

    fn = jax.jit(shard_map(
        f, mesh=mesh, in_specs=P("t"), out_specs=P()))
    hlo = fn.lower(jnp.zeros((8, 64), jnp.float32)).compile().as_text()
    totals = collective_totals(hlo)
    assert totals.get("all-reduce", 0) >= 64 * 4, totals
    assert "all-gather" not in totals
