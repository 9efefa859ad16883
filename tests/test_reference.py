"""The scale-check host reference (`linkpred_tpu/bench/reference.py`) against
the dense oracle, and its check catching planted faults."""
import numpy as np
import pytest

from conftest import random_graph
from oracle import oracle_scores
from linkpred_tpu import PredictOptions, predict_links
from linkpred_tpu.bench.reference import (METRIC_NAMES, check_topk,
                                          source_scores)


@pytest.mark.parametrize("metric", METRIC_NAMES)
def test_reference_matches_oracle(rng, metric):
    g = random_graph(rng, 150, 4)
    off, idx = np.asarray(g.offsets), np.asarray(g.indices)
    for d1 in (0, 8):
        want = oracle_scores(g, metric, d1)
        got = {}
        for u in range(g.n):
            w, scores = source_scores(off, idx, u, d1)
            s = scores[metric]
            got.update({(u, int(x)): float(y)
                        for x, y in zip(w, s) if y > 0})
        assert got.keys() == want.keys()
        for key, s in got.items():
            assert np.isclose(s, want[key], rtol=1e-12), (key, s)


@pytest.mark.parametrize("fault", ["wrong_score", "missing_pair"])
def test_reference_catches_planted_fault(rng, fault):
    g = random_graph(rng, 200, 4)
    k = 150
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=0,
                        options=PredictOptions(max_edges=k))
    off, idx = np.asarray(g.offsets), np.asarray(g.indices)
    us, vs, ss = res.u.copy(), res.v.copy(), res.score.copy()
    sources = np.unique(us)
    check_topk(off, idx, {"jaccard_coefficient": (us, vs, ss)},
               min_degree1=0, k=k, sources=sources)      # clean: passes
    if fault == "wrong_score":
        ss[0] *= 1.001
    else:                      # drop the best pair, keep k rows
        us, vs, ss = us[1:], vs[1:], ss[1:]
        k -= 1
    with pytest.raises(AssertionError):
        check_topk(off, idx, {"jaccard_coefficient": (us, vs, ss)},
                   min_degree1=0, k=k, sources=sources)
