"""The post-sort run-reduce tail (`scoring._xla_tail`): run boundaries, the
run-start cummax, counts, AA/RA run totals and the nine formulas.

Checked directly on adversarial sorted streams (degenerate runs, killer
runs) and through every path that reaches it — packed and edge stream, both
engine modes, weighted metrics — against the dense oracle (tests/oracle.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from conftest import random_graph
from oracle import oracle_scores
from linkpred_tpu import PredictOptions, predict_links, predict_links_multi
from linkpred_tpu.predict import scoring
from linkpred_tpu.predict.metrics import METRICS
from linkpred_tpu.predict.plan import build_plan

UNWEIGHTED = [n for n, m in METRICS.items() if not m.needs_weight]
ALL = PredictOptions(max_edges=20_000)


def _assert_oracle(res, pairs, rtol):
    assert len(res) == len(pairs) > 0
    for u, v, s in zip(res.u, res.v, res.score):
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=rtol), (u, v, s)


def _tail(key, upay, metric="common_neighbors", killers=False, w_bits=10):
    cap = key.shape[0]
    deg = jnp.full((cap,), 7, jnp.int32)
    scores, ku, kw = scoring._xla_tail(
        key, upay, deg, deg, [], [], (METRICS[metric],), w_bits=w_bits,
        n=1 << w_bits, maxf2=0, min_score=jnp.float32(0.0), killers=killers)
    return np.asarray(scores[0]), np.asarray(ku), np.asarray(kw)


@pytest.mark.parametrize("metric", ["jaccard_coefficient", "common_neighbors",
                                    "hub_depressed"])
@pytest.mark.parametrize("cap", [512, 1024, 4096])
def test_tail_vs_oracle(rng, metric, cap):
    g = random_graph(rng, 250, 3)
    res = predict_links(g, metric=metric, min_degree1=16, options=ALL,
                        cap=cap)
    _assert_oracle(res, oracle_scores(g, metric, 16), 1e-6)


def test_tail_multi_metric_and_min_score(rng):
    g = random_graph(rng, 200, 4)
    out = predict_links_multi(g, UNWEIGHTED, min_degree1=0,
                              options=PredictOptions(max_edges=20_000,
                                                     min_score=0.25))
    for name in UNWEIGHTED:
        pairs = oracle_scores(g, name, 0, min_score=0.25)
        if pairs:
            _assert_oracle(out[name], pairs, 1e-6)
        else:
            assert len(out[name]) == 0


def test_tail_degenerate_runs():
    """All lanes one run / every lane its own run — the cummax's edges."""
    cap = 512
    one = jnp.full((cap,), 5, jnp.int32)
    s, ku, kw = _tail(one, jnp.zeros((cap,), jnp.int32))
    assert np.isneginf(s[:-1]).all() and s[-1] == cap
    own = jnp.arange(cap, dtype=jnp.int32)
    s, ku, kw = _tail(own, jnp.zeros((cap,), jnp.int32))
    np.testing.assert_array_equal(s, np.ones(cap))
    np.testing.assert_array_equal(kw, np.arange(cap))


def test_tail_killer_runs_dead():
    """With killers, a run whose first slot is a killer (flag bit 0) is dead;
    one led by a real slot scores its full run length."""
    key = jnp.asarray(np.repeat(np.arange(4, dtype=np.int32), 3))
    flag = np.ones(12, np.int32)
    flag[[3, 9]] = 0                       # runs 1 and 3 led by a killer
    upay = jnp.asarray((np.full(12, 9, np.int32) << 1) | flag)
    s, ku, _ = _tail(key, upay, killers=True)
    ends = s[2::3]
    np.testing.assert_array_equal(ends, [3.0, -np.inf, 3.0, -np.inf])
    assert (ku == 9).all()


def test_tail_weighted_and_killers_vs_oracle(rng):
    """AA/RA run totals on the keyed edge stream, whose runs carry killers."""
    g = random_graph(rng, 250, 6)
    for metric, d1 in [("adamic_adar", 0), ("resource_allocation", 16)]:
        plan = build_plan(g, d1, slot_budget=0)
        assert not plan.packed, "test premise: edge stream"
        res = predict_links(g, metric=metric, min_degree1=d1, options=ALL,
                            plan=plan)
        _assert_oracle(res, oracle_scores(g, metric, d1), 1e-5)


@pytest.mark.parametrize("key64", [False, True])
def test_tail_engine_modes_vs_oracle(rng, key64):
    g = random_graph(rng, 400, 5)
    out = predict_links_multi(g, ("jaccard_coefficient", "common_neighbors"),
                              min_degree1=64, options=ALL, cap=1 << 10,
                              key64=key64)
    for name, res in out.items():
        _assert_oracle(res, oracle_scores(g, name, 64), 1e-6)


@pytest.mark.parametrize("metric", ["adamic_adar", "resource_allocation"])
@pytest.mark.parametrize("key64", [False, True])
def test_tail_weighted_vs_oracle(rng, key64, metric):
    """AA/RA segmented sums over IHub-maximal runs on the packed stream."""
    g = random_graph(rng, 300, 5)
    res = predict_links(g, metric=metric, min_degree1=0, options=ALL,
                        cap=1 << 10, key64=key64)
    _assert_oracle(res, oracle_scores(g, metric, 0), 1e-5)


def test_tail_edge_stream_vs_oracle(rng):
    g = random_graph(rng, 300, 5)
    plan = build_plan(g, 32, slot_budget=0)
    assert not plan.packed, "test premise: edge stream"
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=32,
                        options=ALL, plan=plan)
    _assert_oracle(res, oracle_scores(g, "jaccard_coefficient", 32), 1e-6)
