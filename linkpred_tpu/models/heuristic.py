"""Heuristic link-prediction models — the model-zoo face of the metric engine.

The reference exposes its predictors as 18 free functions
(`/root/reference/inc/predict.hxx:503-831`, seq + OMP per metric); here each
(metric, hub-threshold) pair is a ``HeuristicPredictor`` with a uniform
``predict(graph)`` interface, so sweeps, serving code, and the hybrid GNN models
(`linkpred_tpu.models.gnn`) compose over one API.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..graph import CSRGraph
from ..predict.api import PlanCache, PredictOptions, PredictResult, predict_links
from ..predict.metrics import METRICS, TECHNIQUE_NAMES, get_metric

__all__ = ["HeuristicPredictor", "IHub", "LHub", "all_models"]


@dataclasses.dataclass
class HeuristicPredictor:
    """One similarity metric with an optional LHub hub threshold.

    ``min_degree1 = 0`` is IHub (scan all intermediates); > 0 is LHub
    (`predict.hxx:227,301`).
    """
    metric: str = "jaccard_coefficient"
    min_degree1: int = 4
    max_factor2: int = 0
    cap: int = 1 << 20
    plan_cache: Optional[PlanCache] = None

    def __post_init__(self) -> None:
        self.metric = get_metric(self.metric).name

    @property
    def name(self) -> str:
        return f"{TECHNIQUE_NAMES[self.metric]}Jax{self.min_degree1}"

    def predict(self, g: CSRGraph, max_edges: Optional[int] = None,
                min_score: float = 0.0, repeat: int = 1,
                mesh=None, sources=None) -> PredictResult:
        return predict_links(
            g, metric=self.metric, min_degree1=self.min_degree1,
            max_factor2=self.max_factor2,
            options=PredictOptions(repeat=repeat, max_edges=max_edges,
                                   min_score=min_score),
            cap=self.cap, plan_cache=self.plan_cache, mesh=mesh,
            sources=sources,
        )


def IHub(metric: str = "jaccard_coefficient", **kw) -> HeuristicPredictor:
    """Improved-baseline predictor: score all second-order pairs."""
    return HeuristicPredictor(metric=metric, min_degree1=0, **kw)


def LHub(metric: str = "jaccard_coefficient", min_degree1: int = 64,
         **kw) -> HeuristicPredictor:
    """Hub-skipping predictor (the reference's headline 1019x speedup regime)."""
    return HeuristicPredictor(metric=metric, min_degree1=min_degree1, **kw)


def all_models(degrees=(0, 4, 64), plan_cache: Optional[PlanCache] = None):
    """The full 9-metric x threshold zoo (mirrors PREDICT_LINKS_ALL,
    `main.cxx:67-80,212-220`)."""
    cache = plan_cache or PlanCache()
    return [
        HeuristicPredictor(metric=m, min_degree1=d, plan_cache=cache)
        for m in METRICS for d in degrees
    ]
