"""Blocked deferred selection (`scoring._argselect_blocked`): exactness.

The deferred selection sorts per _SEL_BLOCK-lane block and recurses on block
winners.  These tests shrink the block so toy graphs exercise multi-level
blocking, and assert the result matches the oracle and the flat (block=0)
path exactly.
"""
import numpy as np
import pytest

from conftest import random_graph
from oracle import oracle_scores, oracle_topk_scores

from linkpred_tpu import PredictOptions, predict_links
from linkpred_tpu.predict import scoring


@pytest.fixture
def small_block(monkeypatch):
    # jit caches key on static (cap, k, shapes); the fixture's callers use
    # cap/k combinations unique to this file so stale traces can't leak in
    monkeypatch.setattr(scoring, "_SEL_BLOCK", 1024)


@pytest.mark.parametrize("metric,k", [
    ("jaccard_coefficient", 37),       # kk << block
    ("common_neighbors", 3000),        # kk > block (ties galore)
    ("adamic_adar", 1500),             # kk > block, weighted
])
def test_blocked_selection_matches_oracle(rng, small_block, metric, k):
    g = random_graph(rng, n=170, avg_deg=7)
    pairs = oracle_scores(g, metric, 0)
    res = predict_links(g, metric=metric, min_degree1=0,
                        options=PredictOptions(max_edges=k), cap=1280)
    assert len(res) == min(k, len(pairs))
    for u, v, s in zip(res.u, res.v, res.score):
        assert (int(u), int(v)) in pairs
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)
    np.testing.assert_allclose(
        np.sort(res.score)[::-1], oracle_topk_scores(pairs, len(res)),
        rtol=1e-5)


def test_blocked_matches_flat(rng, monkeypatch):
    g = random_graph(rng, n=160, avg_deg=6)
    kwargs = dict(metric="sorensen_index", min_degree1=8,
                  options=PredictOptions(max_edges=900), cap=1536)
    monkeypatch.setattr(scoring, "_SEL_BLOCK", 0)
    flat = predict_links(g, **kwargs)
    monkeypatch.setattr(scoring, "_SEL_BLOCK", 512)
    # same static signature would hit the jit cache of the flat trace; force
    # a fresh compile by nudging a static arg (cap) without changing content
    kwargs["cap"] = 1537
    blocked = predict_links(g, **kwargs)
    assert len(flat) == len(blocked)
    np.testing.assert_allclose(np.sort(flat.score), np.sort(blocked.score),
                               rtol=1e-6)


def test_blocked_selection_fuzz(rng):
    # Randomized net: random graph/cap/k/block-size combinations, blocked
    # result must match the flat (block=0) sort exactly (score multisets;
    # ties may resolve to different pairs).
    for trial in range(5):
        n = int(rng.integers(60, 220))
        g = random_graph(rng, n=n, avg_deg=float(rng.uniform(3, 9)),
                         seed_extra=trial)
        cap = int(rng.integers(256, 2048))
        k = int(rng.integers(1, 4000))
        metric = ("common_neighbors", "jaccard_coefficient",
                  "adamic_adar")[trial % 3]
        kwargs = dict(metric=metric, min_degree1=int(rng.integers(0, 12)),
                      options=PredictOptions(max_edges=k), cap=cap)
        old = scoring._SEL_BLOCK
        try:
            scoring._SEL_BLOCK = 0
            flat = predict_links(g, **kwargs)
            scoring._SEL_BLOCK = int(rng.integers(128, 2048))
            kwargs["cap"] = cap + 1  # force a fresh jit (cache keys on cap)
            blocked = predict_links(g, **kwargs)
        finally:
            scoring._SEL_BLOCK = old
        assert len(flat) == len(blocked), (trial, len(flat), len(blocked))
        np.testing.assert_allclose(np.sort(flat.score),
                                   np.sort(blocked.score), rtol=1e-6,
                                   err_msg=f"trial {trial}")


def test_argselect_blocked_unit(rng):
    import jax.numpy as jnp

    keys = jnp.asarray(rng.integers(0, 1 << 30, 10_000,
                                    dtype=np.int64).astype(np.uint32))
    idx = jnp.arange(10_000, dtype=jnp.int32)
    old = scoring._SEL_BLOCK
    try:
        scoring._SEL_BLOCK = 768  # non-divisor: exercises padding
        for kk in (1, 100, 769, 5000):
            sk, si = scoring._argselect_blocked(keys, idx, kk)
            ref = np.sort(np.asarray(keys))[:kk]
            np.testing.assert_array_equal(np.asarray(sk)[:kk], ref)
            np.testing.assert_array_equal(
                np.asarray(keys)[np.asarray(si)[:kk]], np.asarray(sk)[:kk])
    finally:
        scoring._SEL_BLOCK = old
