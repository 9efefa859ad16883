"""Engine-vs-oracle tests for the tiled scoring pipeline (all metrics, IHub+LHub)."""
import numpy as np
import pytest

from conftest import powerlaw_graph, random_graph
from oracle import oracle_scores, oracle_topk_scores

from linkpred_tpu import METRICS, PredictOptions, predict_links

ALL_METRICS = sorted(METRICS)


def check_against_oracle(g, metric, min_degree1, max_edges, cap, min_score=0.0,
                         rtol=1e-5):
    pairs = oracle_scores(g, metric, min_degree1, min_score=min_score)
    res = predict_links(
        g, metric=metric, min_degree1=min_degree1,
        options=PredictOptions(max_edges=max_edges, min_score=min_score),
        cap=cap,
    )
    expect_n = min(max_edges, len(pairs))
    assert len(res) == expect_n, f"{metric} D1={min_degree1}: {len(res)} != {expect_n}"
    # every predicted pair is a valid candidate with the right score
    for u, v, s in zip(res.u, res.v, res.score):
        key = (int(u), int(v))
        assert key in pairs, f"{metric}: spurious pair {key}"
        assert np.isclose(s, pairs[key], rtol=rtol), (
            f"{metric}: score mismatch {key}: {s} vs {pairs[key]}")
    # the selected score multiset is the true top-k (tie-robust)
    np.testing.assert_allclose(
        np.sort(res.score)[::-1], oracle_topk_scores(pairs, expect_n), rtol=rtol)
    # output is sorted descending
    assert np.all(np.diff(res.score) <= 1e-7)


@pytest.mark.parametrize("metric", ALL_METRICS)
@pytest.mark.parametrize("min_degree1", [0, 4, 64])
def test_all_metrics_vs_oracle(rng, metric, min_degree1):
    g = random_graph(rng, n=150, avg_deg=5)
    check_against_oracle(g, metric, min_degree1, max_edges=10_000, cap=4096)


@pytest.mark.parametrize("metric", ["jaccard_coefficient", "adamic_adar"])
def test_topk_truncation(rng, metric):
    g = random_graph(rng, n=200, avg_deg=6)
    check_against_oracle(g, metric, 0, max_edges=25, cap=4096)


def test_small_cap_many_tiles(rng):
    # tiny cap forces dozens of tiles; exactness must not depend on tiling
    g = random_graph(rng, n=120, avg_deg=5)
    check_against_oracle(g, "common_neighbors", 0, max_edges=5000, cap=256)
    check_against_oracle(g, "resource_allocation", 8, max_edges=5000, cap=256)


def test_huge_source_device_path(rng):
    # power-law graph + small cap routes hub sources through the DEVICE hub
    # sub-plan (hub-sized tiles, same engine); the dense host scorer is only a
    # test oracle now
    g = powerlaw_graph(rng, n=300, m=2000)
    from linkpred_tpu.predict.plan import build_plan
    plan = build_plan(g, 0, cap=512)
    assert plan.huge_src.size > 0, "test should exercise the huge-source path"
    assert plan.huge_plan is not None
    assert plan.huge_plan.cap > 512 and plan.huge_plan.huge_src.size == 0
    check_against_oracle(g, "jaccard_coefficient", 0, max_edges=100_000, cap=512)
    check_against_oracle(g, "adamic_adar", 0, max_edges=50, cap=512)


def test_huge_source_matches_host_oracle(rng):
    # the demoted host dense scorer cross-checks the hub sub-plan directly
    from linkpred_tpu.predict.metrics import get_metric
    from linkpred_tpu.predict.plan import build_plan
    from linkpred_tpu.predict.scoring import score_huge_sources_host

    g = powerlaw_graph(rng, n=250, m=1800)
    plan = build_plan(g, 0, cap=256)
    assert plan.huge_src.size > 0
    res = predict_links(g, metric="salton_cosine_similarity", min_degree1=0,
                        options=PredictOptions(max_edges=100_000), plan=plan)
    got = {(int(u), int(v)): float(s)
           for u, v, s in zip(res.u, res.v, res.score)}
    hs, hu, hv = score_huge_sources_host(
        g, plan.huge_src, get_metric("salton_cosine_similarity"), 0, 0, 0.0)
    assert hs.size > 0
    for s, u, v in zip(hs, hu, hv):
        assert np.isclose(got[(int(u), int(v))], s, rtol=1e-5)


def test_lhub_skips_hubs(rng):
    g = powerlaw_graph(rng, n=300, m=3000)
    check_against_oracle(g, "common_neighbors", 2, max_edges=100_000, cap=2048)
    check_against_oracle(g, "salton_cosine_similarity", 16, max_edges=100_000, cap=2048)


def test_min_score_threshold(rng):
    g = random_graph(rng, n=150, avg_deg=5)
    check_against_oracle(g, "common_neighbors", 0, max_edges=10_000, cap=4096,
                         min_score=1.5)


def test_max_edges_zero_returns_empty(rng):
    g = random_graph(rng, n=50, avg_deg=4)
    res = predict_links(g, options=PredictOptions(max_edges=0))
    assert len(res) == 0


def test_empty_graph():
    from linkpred_tpu import from_edges
    g = from_edges(np.empty(0, np.int64), np.empty(0, np.int64), n=10)
    res = predict_links(g, options=PredictOptions(max_edges=10))
    assert len(res) == 0


def test_repeat_timing(rng):
    g = random_graph(rng, n=80, avg_deg=4)
    res = predict_links(g, options=PredictOptions(max_edges=100, repeat=3))
    assert res.time_ms >= res.scoring_ms >= 0.0


@pytest.mark.parametrize("metric", ["common_neighbors", "adamic_adar"])
def test_edge_stream_keyed_path_vs_oracle(rng, metric):
    # slot_budget=0 forces packed=False; the edge stream then uses the stable
    # w-key sort (the default whenever ids fit).
    from linkpred_tpu.predict.plan import build_plan

    g = random_graph(rng, n=150, avg_deg=5)
    plan = build_plan(g, 0, cap=4096, slot_budget=0)
    assert not plan.packed and plan.keyed
    pairs = oracle_scores(g, metric, 0)
    res = predict_links(g, metric=metric, min_degree1=0,
                        options=PredictOptions(max_edges=10_000), plan=plan,
                        cap=4096)
    assert len(res) == min(10_000, len(pairs))
    for u, v, s in zip(res.u, res.v, res.score):
        assert (int(u), int(v)) in pairs
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_edge_stream_sentinel_path_vs_oracle(rng, monkeypatch):
    # the two-key sentinel sort (the w_bits == 0 fallback for n > 2^30, forced
    # here via env for coverage)
    from linkpred_tpu.predict.plan import build_plan

    monkeypatch.setenv("LINKPRED_EDGE_SENTINEL", "1")
    g = random_graph(rng, n=120, avg_deg=5)
    plan = build_plan(g, 4, cap=4096, slot_budget=0)
    pairs = oracle_scores(g, "jaccard_coefficient", 4)
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=4,
                        options=PredictOptions(max_edges=10_000), plan=plan,
                        cap=4096)
    assert len(res) == min(10_000, len(pairs))
    for u, v, s in zip(res.u, res.v, res.score):
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_edge_stream_serving_mode_vs_oracle(rng):
    # serving mode over the EDGE stream (upper_only=False): directed
    # candidates, per-slot w != u dead test, killer rows decoded from the
    # bitwise-NOT source encoding
    from linkpred_tpu.predict.plan import build_plan

    g = random_graph(rng, n=150, avg_deg=5)
    sources = np.array([3, 17, 42, 99])
    plan = build_plan(g, 0, cap=4096, slot_budget=0, sources=sources)
    assert not plan.packed and not plan.upper_only
    pairs = oracle_scores(g, "jaccard_coefficient", 0, sources=sources)
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=0,
                        options=PredictOptions(max_edges=10_000), plan=plan,
                        cap=4096, sources=sources)
    assert len(res) == min(10_000, len(pairs))
    for u, v, s in zip(res.u, res.v, res.score):
        assert (int(u), int(v)) in pairs
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_maxfactor2_quirk_parity(rng):
    # The reference's MAXFACTOR2 predicate self-compares deg(u)
    # (predict.hxx:221,295): with maxf2=1 it keeps only pairs with
    # deg(w) <= deg(u). Oracle implements the same quirk; engine must match.
    g = random_graph(rng, n=120, avg_deg=5)
    pairs = oracle_scores(g, "common_neighbors", 0, max_factor2=1)
    res = predict_links(g, metric="common_neighbors", min_degree1=0,
                        max_factor2=1,
                        options=PredictOptions(max_edges=10_000), cap=4096)
    assert len(res) == min(10_000, len(pairs))
    for u, v, s in zip(res.u, res.v, res.score):
        assert (int(u), int(v)) in pairs
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_maxfactor2_host_scorer(rng):
    # Regression: the host mega-hub scorer's maxf2 filter referenced a
    # variable deleted in the single-source-of-truth metrics refactor
    # (NameError on any maxf2 != 0 run that hits the host path).
    from linkpred_tpu.predict.metrics import get_metric
    from linkpred_tpu.predict.scoring import score_huge_sources_host

    g = powerlaw_graph(rng, n=250, m=1800)
    hubs = np.argsort(np.asarray(g.degrees))[-3:].astype(np.int64)
    hs, hu, hv = score_huge_sources_host(
        g, hubs, get_metric("common_neighbors"), 0, 1, 0.0)
    deg = np.asarray(g.degrees)
    assert hs.size > 0
    # the reference's self-compare quirk: keeps pairs with deg(w) <= deg(u)
    assert np.all(deg[hv] <= deg[hu])
    pairs = oracle_scores(g, "common_neighbors", 0, max_factor2=1)
    for s, u, v in zip(hs, hu, hv):
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_source_restricted_prediction(rng):
    # serving mode: predictions only for the requested sources, over ALL
    # second-order neighbors (directed candidates)
    g = random_graph(rng, n=150, avg_deg=5)
    sources = np.array([3, 17, 42, 99])
    pairs = oracle_scores(g, "jaccard_coefficient", 0, sources=sources)
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=0,
                        options=PredictOptions(max_edges=10_000), cap=4096,
                        sources=sources)
    assert len(res) == min(10_000, len(pairs))
    srcset = set(sources.tolist())
    for u, v, s in zip(res.u, res.v, res.score):
        assert int(u) in srcset
        assert (int(u), int(v)) in pairs
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)
    np.testing.assert_allclose(
        np.sort(res.score)[::-1], oracle_topk_scores(pairs, len(res)), rtol=1e-5)


def test_source_restricted_multi(rng):
    g = random_graph(rng, n=120, avg_deg=5)
    sources = np.array([5, 60])
    from linkpred_tpu import predict_links_multi

    multi = predict_links_multi(
        g, ("common_neighbors", "adamic_adar"), min_degree1=0,
        options=PredictOptions(max_edges=500), cap=4096, sources=sources)
    for name, res in multi.items():
        pairs = oracle_scores(g, name, 0, sources=sources)
        assert len(res) == min(500, len(pairs))
        for u, v, s in zip(res.u, res.v, res.score):
            assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_top_per_source(rng):
    from linkpred_tpu.predict.api import top_per_source

    g = random_graph(rng, n=150, avg_deg=5)
    sources = np.array([3, 17, 42])
    res = predict_links(g, metric="common_neighbors", min_degree1=0,
                        options=PredictOptions(max_edges=10_000), cap=4096,
                        sources=sources)
    per = top_per_source(res, 5)
    # at most 5 per source, and each kept entry is among that source's best 5
    for s_ in sources:
        mine = per.score[per.u == s_]
        alls = np.sort(res.score[res.u == s_])[::-1]
        assert mine.shape[0] == min(5, alls.shape[0])
        np.testing.assert_allclose(np.sort(mine)[::-1], alls[:mine.shape[0]])
    assert np.all(np.diff(per.score) <= 1e-7)


@pytest.mark.parametrize("seed", [11, 23, 37])
def test_fuzz_random_configs(seed):
    # randomized graph/config sweeps vs oracle — edge-case net
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 200))
    avg = float(rng.uniform(2, 8))
    g = random_graph(rng, n=n, avg_deg=avg)
    metric = list(METRICS)[int(rng.integers(0, 9))]
    deg = int(rng.choice([0, 2, 8, 32, 1024]))
    cap = int(rng.choice([256, 1024, 4096]))
    k = int(rng.integers(1, 5000))
    min_score = float(rng.choice([0.0, 0.5]))
    pairs = oracle_scores(g, metric, deg, min_score=min_score)
    res = predict_links(g, metric=metric, min_degree1=deg,
                        options=PredictOptions(max_edges=k, min_score=min_score),
                        cap=cap)
    assert len(res) == min(k, len(pairs)), (metric, deg, cap, k, n)
    for u, v, s in zip(res.u, res.v, res.score):
        assert (int(u), int(v)) in pairs
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)
    np.testing.assert_allclose(
        np.sort(res.score)[::-1], oracle_topk_scores(pairs, len(res)), rtol=1e-5)


@pytest.mark.parametrize("seed", [5, 19])
def test_fuzz_segmented_chunked_paths(seed, monkeypatch):
    # same oracle net, but with the segment/chunk limits shrunk so the
    # hierarchical-selection and chunked-dispatch machinery runs on toy plans
    # (at production sizes they only trigger at IHub scale)
    import linkpred_tpu.predict.scoring as scoring_mod

    rng = np.random.default_rng(seed)
    n = int(rng.integers(100, 300))
    g = random_graph(rng, n=n, avg_deg=float(rng.uniform(5, 9)))
    metric = list(METRICS)[int(rng.integers(0, 9))]
    deg = int(rng.choice([0, 32]))
    cap = 256
    monkeypatch.setattr(scoring_mod, "SEG_LANES", 512)       # 2-tile segments
    monkeypatch.setattr(scoring_mod, "CHUNK_TILES", 8)
    monkeypatch.setattr(scoring_mod, "CHUNK_TILES_PACKED", 8)
    import linkpred_tpu.predict.api as api_mod
    monkeypatch.setattr(api_mod, "CHUNK_TILES", 8)
    monkeypatch.setattr(api_mod, "CHUNK_TILES_PACKED", 8)
    scoring_mod.score_tiles.clear_cache()
    try:
        k = int(rng.integers(50, 3000))
        pairs = oracle_scores(g, metric, deg)
        res = predict_links(g, metric=metric, min_degree1=deg,
                            options=PredictOptions(max_edges=k), cap=cap)
        assert len(res) == min(k, len(pairs))
        for u, v, s in zip(res.u, res.v, res.score):
            assert (int(u), int(v)) in pairs
            assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)
        np.testing.assert_allclose(
            np.sort(res.score)[::-1], oracle_topk_scores(pairs, len(res)),
            rtol=1e-5)
    finally:
        scoring_mod.score_tiles.clear_cache()


def test_mega_hub_host_fallback(rng, monkeypatch):
    # A hub whose one-tile expansion exceeds HUGE_DEVICE_MAX cannot run on
    # device (an unsegmentable tile would blow the deferred selection's HBM
    # bound); it must route to the exact host scorer and still produce
    # oracle-exact results merged with the device output.
    import linkpred_tpu.predict.plan as plan_mod

    monkeypatch.setattr(plan_mod, "HUGE_DEVICE_MAX", 2048)
    n_leaves = 900
    H = 0
    leaves = np.arange(1, 1 + n_leaves)
    ring = (leaves - 1 + 1) % n_leaves + 1
    src = np.concatenate([np.full(n_leaves, H), leaves, leaves, ring])
    dst = np.concatenate([leaves, np.full(n_leaves, H), ring, leaves])
    from linkpred_tpu import from_edges
    g = from_edges(src, dst)
    plan = plan_mod.build_plan(g, 8, cap=1024)
    assert plan.host_src.size and H in plan.host_src, (
        plan.host_src, plan.huge_src)
    # fused pass: the host fallback shares ONE expansion across metrics
    # (score_huge_sources_host_multi); each must stay oracle-exact
    from linkpred_tpu import predict_links_multi
    multi = predict_links_multi(
        g, ("jaccard_coefficient", "adamic_adar"), min_degree1=8,
        options=PredictOptions(max_edges=20000), plan=plan)
    for name in ("jaccard_coefficient", "adamic_adar"):
        res = multi[name]
        pairs = oracle_scores(g, name, 8)
        assert len(res) == min(20000, len(pairs))
        for u, v, s in zip(res.u, res.v, res.score):
            assert (int(u), int(v)) in pairs
            assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)


def test_accurate_log_vs_float64():
    # the AA weight path computes log on device; metrics.py evaluates it via
    # exact frexp range reduction + an atanh series, so a device's fast-math
    # log never enters — must stay within ~2e-7 of float64
    import jax.numpy as jnp

    from linkpred_tpu.predict.metrics import _accurate_log

    d = np.unique(np.concatenate([
        np.arange(2, 5000), 2 ** np.arange(2, 31),
        np.random.default_rng(0).integers(2, 1 << 30, 5000)]))
    got = np.asarray(_accurate_log(jnp.asarray(d, dtype=jnp.int32)))
    want = np.log(d.astype(np.float64))
    assert (np.abs(got - want) / want).max() < 5e-7
