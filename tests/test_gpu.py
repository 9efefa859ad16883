"""Tests that need the card.  They skip elsewhere; run them on the GPU with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""
import numpy as np
import pytest

from conftest import random_graph
from oracle import oracle_scores


@pytest.mark.gpu
@pytest.mark.parametrize("metric,d1", [("jaccard_coefficient", 0),
                                       ("adamic_adar", 16)])
def test_predict_links_on_gpu_matches_oracle(gpu, rng, metric, d1):
    from linkpred_tpu import PredictOptions, predict_links

    g = random_graph(rng, 250, 6)
    pairs = oracle_scores(g, metric, d1)
    res = predict_links(g, metric=metric, min_degree1=d1,
                        options=PredictOptions(max_edges=20_000))
    assert len(res) == min(20_000, len(pairs))
    for u, v, s in zip(res.u, res.v, res.score):
        assert np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5)
