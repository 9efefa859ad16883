"""Regression tests for the round-1 advisor/judge findings.

Covers: the deg16 degree-pair sign-extension bug (degrees in [2^15, 2^16)),
PlanCache id-reuse pinning, integer scatter_or accumulation, the native MTX
parser's truncated-record handling, and transpose_with_degree parity.
"""
import os
import sys

import numpy as np
import pytest

from conftest import random_graph

from linkpred_tpu import PredictOptions, from_edges, predict_links, to_dense
from linkpred_tpu.predict.api import PlanCache
from linkpred_tpu.predict.plan import build_plan


def test_deg16_high_degree_unpack():
    # A hub of degree 40000 exercises the deg16 packed payload with the int32
    # sign bit set: (40000 << 16) is negative, and an unmasked arithmetic
    # unshift recovered deg(u) as -25536, corrupting every degree-dependent
    # metric.  The pack's high half holds deg(u) of the pair's SOURCE, so the
    # hub must take the LOWEST id: H(id 0) - 40000 leaves; A(id 1) - 10 leaves.
    n_leaves = 40000
    H, A = 0, 1
    leaves = np.arange(2, 2 + n_leaves)
    src = np.concatenate([np.full(n_leaves, H), leaves,
                          np.full(10, A), leaves[:10]])
    dst = np.concatenate([leaves, np.full(n_leaves, H),
                          leaves[:10], np.full(10, A)])
    g = from_edges(src, dst)
    plan = build_plan(g, 64, cap=1 << 17)
    assert plan.deg16, "test must exercise the deg16 packed-payload path"
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=64,
                        options=PredictOptions(max_edges=1000), plan=plan)
    got = {(int(u), int(v)): float(s)
           for u, v, s in zip(res.u, res.v, res.score)}
    # (H, A) share the 10 leaves: Nuv=10, deg(H)=40000, deg(A)=10.
    assert (H, A) in got, "pair lost — deg16 unpack corrupted deg(H)"
    np.testing.assert_allclose(got[(H, A)], 10.0 / (40000 + 10 - 10), rtol=1e-5)


@pytest.mark.parametrize("split", [True, False])
def test_deg_above_16bit_pairs(split, monkeypatch):
    # Degrees >= 2^16 cannot ride the packed (du << 16 | dw) payload.  With
    # the degree-regime split (default) the oversized pairs move to the
    # 4-operand side plan and the main stream KEEPS deg16; with
    # LINKPRED_DEG_SPLIT=0 the whole plan falls back to the 4-operand sort
    # (the pre-round-3 RMAT-20 regime).  Scores must be exact either way.
    if not split:
        monkeypatch.setenv("LINKPRED_DEG_SPLIT", "0")
    n_leaves = 70000
    H, A = 0, 1
    leaves = np.arange(2, 2 + n_leaves)
    src = np.concatenate([np.full(n_leaves, H), leaves,
                          np.full(10, A), leaves[:10]])
    dst = np.concatenate([leaves, np.full(n_leaves, H),
                          leaves[:10], np.full(10, A)])
    g = from_edges(src, dst)
    plan = build_plan(g, 64, cap=1 << 17)
    assert plan.packed
    if split:
        assert plan.deg16 and plan.side_plan is not None
        assert not plan.side_plan.deg16
    else:
        assert not plan.deg16 and plan.side_plan is None
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=64,
                        options=PredictOptions(max_edges=1000), plan=plan)
    got = {(int(u), int(v)): float(s)
           for u, v, s in zip(res.u, res.v, res.score)}
    # (H, A) share the 10 leaves: Nuv=10, deg(H)=70000, deg(A)=10.
    assert (H, A) in got
    np.testing.assert_allclose(got[(H, A)], 10.0 / (70000 + 10 - 10), rtol=1e-5)


def test_segmented_selection_exact(rng, monkeypatch):
    # IHub-scale scans buffer raw tile output per SEGMENT and select
    # hierarchically (bounded HBM); winners must equal the one-pass selection
    # exactly.  Shrink SEG_LANES so a toy plan crosses the segment boundary.
    import linkpred_tpu.predict.scoring as scoring_mod

    g = random_graph(rng, n=400, avg_deg=10)
    plan = build_plan(g, 32, cap=256)
    assert plan.num_tiles_padded > 8, "plan too small to exercise segments"
    res_one = predict_links(g, metric="jaccard_coefficient", min_degree1=32,
                            options=PredictOptions(max_edges=5000), plan=plan)
    monkeypatch.setattr(scoring_mod, "SEG_LANES", 1024)  # seg = 4 tiles
    scoring_mod.score_tiles.clear_cache()
    try:
        res_seg = predict_links(g, metric="jaccard_coefficient", min_degree1=32,
                                options=PredictOptions(max_edges=5000),
                                plan=plan)
    finally:
        scoring_mod.score_tiles.clear_cache()  # drop the shrunken-SEG variants
    assert len(res_seg) == len(res_one) > 0
    # tie-breaking at the k-th score is arbitrary (as in the reference's heap):
    # the score multisets must match exactly, and so must every pair strictly
    # above the cutoff score.
    np.testing.assert_array_equal(res_seg.score, res_one.score)
    cutoff = res_one.score[-1]
    one = {(int(u), int(v)): float(s)
           for u, v, s in zip(res_one.u, res_one.v, res_one.score) if s > cutoff}
    seg = {(int(u), int(v)): float(s)
           for u, v, s in zip(res_seg.u, res_seg.v, res_seg.score) if s > cutoff}
    assert one == seg and len(one) > 0


def test_chunked_dispatch_exact(rng):
    # Edge-stream plans dispatch CHUNK_TILES tiles per device program;
    # chunk winners merge on device.  Tiny chunks must reproduce the single-dispatch result exactly.
    from linkpred_tpu.predict.scoring import score_tiles_chunked
    import linkpred_tpu.predict.api as api_mod

    g = random_graph(rng, n=400, avg_deg=10)
    plan = build_plan(g, 32, cap=256)
    assert plan.num_tiles_padded > 8
    res_one = predict_links(g, metric="common_neighbors", min_degree1=32,
                            options=PredictOptions(max_edges=4000), plan=plan)
    orig = api_mod.score_tiles_chunked

    def tiny_chunks(*args, **kwargs):
        kwargs["chunk"] = 2
        return orig(*args, **kwargs)

    api_mod.score_tiles_chunked = tiny_chunks
    try:
        res_chunk = predict_links(g, metric="common_neighbors", min_degree1=32,
                                  options=PredictOptions(max_edges=4000),
                                  plan=plan)
    finally:
        api_mod.score_tiles_chunked = orig
    np.testing.assert_array_equal(res_chunk.score, res_one.score)
    cutoff = res_one.score[-1] if len(res_one) else 0.0
    one = {(int(u), int(v)) for u, v, s in
           zip(res_one.u, res_one.v, res_one.score) if s > cutoff}
    chk = {(int(u), int(v)) for u, v, s in
           zip(res_chunk.u, res_chunk.v, res_chunk.score) if s > cutoff}
    assert one == chk


def test_auto_cap_scales_with_expansion(rng):
    # cap=None: tiny graphs clamp to AUTO_CAP_MIN (no 2^22-lane sorts for toy
    # inputs); the chosen cap targets ~AUTO_CAP_TILES tiles and is identical to
    # an explicitly-passed cap of the same value (pure default resolution).
    from linkpred_tpu.predict.plan import AUTO_CAP_MIN, AUTO_CAP_TILES

    g = random_graph(rng, n=200, avg_deg=5)
    p = build_plan(g, 4)
    assert p.cap == AUTO_CAP_MIN
    p2 = build_plan(g, 4, cap=p.cap)
    np.testing.assert_array_equal(p.slot_w, p2.slot_w)
    assert p.num_tiles == p2.num_tiles
    # a graph whose expansion exceeds AUTO_CAP_TILES * AUTO_CAP_MIN gets a
    # bigger cap: ~64 sources sharing ~2^16 mids-worth of expansion
    big = random_graph(rng, n=3000, avg_deg=40)
    pb = build_plan(big, 0)  # IHub: scan everything
    assert pb.cap > AUTO_CAP_MIN or pb.total_slots <= AUTO_CAP_TILES * AUTO_CAP_MIN
    # greedy source-aligned packing can fragment, but stays within 2x target
    assert pb.num_tiles <= 2 * AUTO_CAP_TILES


def test_plancache_pins_keyed_arrays(rng):
    # id()-keyed entries must hold strong refs to the keyed arrays, else a GC'd
    # graph's id can be reused by a different graph and hit a stale plan.
    g = random_graph(rng, n=60, avg_deg=4)
    cache = PlanCache()
    rc_off = sys.getrefcount(g.offsets)
    plan = cache.get(g, 4, cap=4096)
    assert sys.getrefcount(g.offsets) > rc_off, "cache entry must pin offsets"
    assert cache.get(g, 4, cap=4096) is plan  # hit
    gd = cache.device_graph(g)
    assert cache.device_graph(g) is gd
    # a structurally different graph of the same shape gets its own plan
    g2 = random_graph(rng, n=60, avg_deg=4, seed_extra=7)
    assert cache.get(g2, 4, cap=4096) is not plan


def test_scatter_or_int_accumulates():
    import jax.numpy as jnp

    from linkpred_tpu.ops.vector import scatter_or

    a = jnp.asarray([8, 8, 8, 8], dtype=jnp.int32)
    ids = jnp.asarray([1, 1, 2, 1])
    x = jnp.asarray([1, 2, 4, 16], dtype=jnp.int32)
    # duplicate ids must OR-accumulate all writers, not keep one
    np.testing.assert_array_equal(np.asarray(scatter_or(a, ids, x)),
                                  [8, 8 | 1 | 2 | 16, 8 | 4, 8])
    # empty ids: a well-defined no-op (the run-marker concatenate must not
    # see mismatched (1,) vs (0,) leading dims)
    empty = jnp.asarray([], dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(scatter_or(a, empty, empty)),
                                  np.asarray(a))


def test_native_truncated_record_stops(tmp_path):
    from linkpred_tpu.io.native import native_lib, parse_mtx_body

    if native_lib() is None:
        pytest.skip("native library unavailable")
    # "3" alone on a line: the parser must stop (or skip), NOT consume the next
    # line's first field as this record's second field (which would shift every
    # subsequent edge by one field).
    src, dst, _ = parse_mtx_body(b"1 2\n3\n4 5\n", 10, False)
    assert list(zip(src.tolist(), dst.tolist())) == [(1, 2)]
    # weighted variant: missing third field also stops cleanly
    src, dst, w = parse_mtx_body(b"1 2 0.5\n3 4\n5 6 1.5\n", 10, True)
    assert list(zip(src.tolist(), dst.tolist())) == [(1, 2)]
    np.testing.assert_allclose(w, [0.5])


@pytest.mark.parametrize("metric", ["jaccard_coefficient", "adamic_adar"])
def test_bign_packed_path(rng, metric):
    # n > 2^23 used to kill the old packed-key path (u and w no longer fit one
    # 32-bit key).  The stable w-only-key sort has no source-span bound, so the
    # packed path survives at any n <= 2^30: spread a 300-vertex graph over an
    # 8.4M-id space and check exactness against the same graph with compact ids
    # (identical degrees => identical scores).
    n_big = (1 << 23) + 1
    ids = np.sort(rng.choice(n_big, size=300, replace=False))
    small = random_graph(rng, n=300, avg_deg=5)
    s_src, s_dst = np.nonzero(to_dense(small))
    g_big = from_edges(ids[s_src], ids[s_dst], n=n_big)
    plan = build_plan(g_big, 4, cap=4096)
    assert plan.packed and plan.keyed, (plan.packed, plan.keyed, plan.w_bits)
    res_big = predict_links(g_big, metric=metric, min_degree1=4,
                            options=PredictOptions(max_edges=10_000), plan=plan)
    res_small = predict_links(small, metric=metric, min_degree1=4,
                              options=PredictOptions(max_edges=10_000))
    assert len(res_big) == len(res_small) > 0
    got = {(int(u), int(v)): float(s)
           for u, v, s in zip(res_big.u, res_big.v, res_big.score)}
    for u, v, s in zip(res_small.u, res_small.v, res_small.score):
        key = (int(ids[u]), int(ids[v]))
        assert key in got, f"missing pair {key}"
        np.testing.assert_allclose(got[key], s, rtol=1e-5)


def test_mmap_reader_paths(rng, tmp_path):
    # path inputs go through the mmap reader (zero-copy native parse or the
    # chunked fallback); both must match the in-memory file-object path
    from linkpred_tpu import read_mtx, write_mtx

    g = random_graph(rng, n=120, avg_deg=5)
    p = tmp_path / "g.mtx"
    write_mtx(g, str(p))
    via_mmap_native = read_mtx(str(p), use_native=True)
    via_mmap_chunked = read_mtx(str(p), use_native=False)
    with open(p) as f:
        via_buf = read_mtx(f, use_native=False)
    np.testing.assert_array_equal(to_dense(via_mmap_native), to_dense(via_buf))
    np.testing.assert_array_equal(to_dense(via_mmap_chunked), to_dense(via_buf))


def test_mmap_reader_comments_and_weights(tmp_path):
    from linkpred_tpu import read_mtx

    p = tmp_path / "w.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "% a comment\n"
        "4 4 3\n"
        "1 2 1.5\n"
        "% mid-body comment\n"
        "2 3 2.5\n"
        "3 4 -1e2\n")
    for use_native in (True, False):
        a = read_mtx(str(p), weighted=True, use_native=use_native)
        assert a.n == 4 and a.m == 6  # symmetric header doubles edges
        assert a.has_edge(1, 0) and a.has_edge(3, 2)


def test_mmap_chunked_block_boundaries(tmp_path, monkeypatch):
    # force tiny chunks so records cross block boundaries
    import linkpred_tpu.io.mtx as mtx_mod
    from linkpred_tpu import read_mtx

    lines = [f"{i + 1} {((i * 7) % 90) + 1}" for i in range(300)]
    p = tmp_path / "c.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                 "300 90 300\n" + "\n".join(lines) + "\n")
    monkeypatch.setattr(mtx_mod, "_CHUNK", 64)
    g = read_mtx(str(p), use_native=False)
    assert g.m == len(set(lines))


def test_transpose_with_degree(rng):
    from linkpred_tpu.ops.transform import transpose_with_degree

    g = random_graph(rng, n=40, avg_deg=3)
    gt, deg = transpose_with_degree(g)
    np.testing.assert_array_equal(to_dense(gt), to_dense(g).T)
    np.testing.assert_array_equal(deg, np.asarray(g.degrees))


def test_init_distributed_signal_gating(monkeypatch):
    # Only the explicit JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    # JAX_PROCESS_ID triple initializes; a weak cluster signal (SLURM_JOB_ID)
    # must not (it would block on a peer barrier that never forms).
    import jax

    from linkpred_tpu.parallel.distributed import init_distributed

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **k: calls.append((a, k)))
    for var in ("JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS",
                "JAX_PROCESS_ID", "SLURM_JOB_ID"):
        monkeypatch.delenv(var, raising=False)

    monkeypatch.setenv("SLURM_JOB_ID", "12345")
    init_distributed()
    assert not calls, "SLURM_JOB_ID alone must not initialize"

    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    init_distributed()
    assert not calls, "JAX_NUM_PROCESSES=1 is a single process"

    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    init_distributed()
    assert calls == [((), dict(coordinator_address="localhost:1234",
                               num_processes=2, process_id=1,
                               local_device_ids=None))]


def test_native_lib_rebuilds_stale_so(tmp_path, monkeypatch):
    # A corrupt/stale .so with a fresh mtime must trigger one rebuild from
    # source (mtimes are not content hashes), not a crash or silent None.
    # Operates on a TEMP .so path — overwriting the real one would invalidate
    # the library already mapped into this process.
    import linkpred_tpu.io.native as native_mod

    if native_mod.native_lib() is None:
        pytest.skip("native toolchain unavailable")
    so = tmp_path / "stale.so"
    so.write_bytes(b"not an elf file")
    os.utime(so, None)  # fresh mtime: passes the staleness check
    monkeypatch.setattr(native_mod, "_SO", str(so))
    monkeypatch.setattr(native_mod, "_lib", None)
    monkeypatch.setattr(native_mod, "_tried", False)
    lib = native_mod.native_lib()
    assert lib is not None and hasattr(lib, "lp_plan_firsthop")


def test_segmented_selection_with_pack_optin_exact(rng, monkeypatch):
    """LINKPRED_SEL_PACK_SEG=1 routes SEGMENTED selections through the
    threshold-pack path (default off — round-5 measurement; the env is the
    A/B opt-in).  Exactness must hold either way: same score multiset and
    same above-cutoff pairs as the one-pass selection."""
    import linkpred_tpu.predict.scoring as scoring_mod

    g = random_graph(rng, n=2000, avg_deg=10)
    plan = build_plan(g, 32, cap=128)
    seg_lanes, max_edges = 16384, 800          # k rounds up to 1024
    assert plan.num_tiles_padded * 128 > 2 * seg_lanes, ">= 2 segments"
    res_one = predict_links(g, metric="jaccard_coefficient", min_degree1=32,
                            options=PredictOptions(max_edges=max_edges),
                            plan=plan)
    monkeypatch.setattr(scoring_mod, "SEG_LANES", seg_lanes)
    monkeypatch.setenv("LINKPRED_SEL_PACK_SEG", "1")
    # lower the engagement floor so the per-segment buffers take the packed
    # dispatch, and ASSERT the static dispatch condition so this test can't
    # silently degrade to blocked-only coverage
    monkeypatch.setenv("LINKPRED_SEL_PACK_MIN", "512")
    import linkpred_tpu.ops.compact as compact_mod
    monkeypatch.setattr(compact_mod, "PACK_CHUNK", 4096)
    monkeypatch.setattr(compact_mod, "PACK_RATIO", 4)
    kk = min(1024, seg_lanes)
    assert seg_lanes >= 512 and kk * 4 <= seg_lanes // 4, \
        "premise: packed dispatch engages for the per-segment selection"
    scoring_mod.score_tiles.clear_cache()
    try:
        res_seg = predict_links(g, metric="jaccard_coefficient", min_degree1=32,
                                options=PredictOptions(max_edges=max_edges),
                                plan=plan)
    finally:
        scoring_mod.score_tiles.clear_cache()
    assert len(res_seg) == len(res_one) > 0
    np.testing.assert_array_equal(res_seg.score, res_one.score)
    cutoff = res_one.score[-1]
    one = {(int(u), int(v)) for u, v, s in zip(res_one.u, res_one.v,
                                               res_one.score) if s > cutoff}
    seg = {(int(u), int(v)) for u, v, s in zip(res_seg.u, res_seg.v,
                                               res_seg.score) if s > cutoff}
    assert one == seg and len(one) > 0
