"""Dense NumPy oracle for link-prediction semantics.

Independent re-derivation of the reference algorithm (`/root/reference/inc/
predict.hxx:214-265` + metric formulas `:503-831`) in dense linear algebra, used as
ground truth for the engine. float64 throughout.
"""
from __future__ import annotations

import numpy as np

from linkpred_tpu.graph import CSRGraph, to_dense
from linkpred_tpu.predict.metrics import METRICS


def oracle_scores(g: CSRGraph, metric: str, min_degree1: int, max_factor2: int = 0,
                  min_score: float = 0.0, sources=None):
    """Return dict {(u, v): score} over all valid candidate pairs — upper
    triangle (u < v) by default; with ``sources``, directed pairs (s, w) for
    s in sources, w != s."""
    A = to_dense(g).astype(np.float64)
    n = g.n
    deg = A.sum(axis=1)
    mid_ok = deg > 0
    if min_degree1:
        mid_ok &= deg <= min_degree1

    cnt = (A * mid_ok[None, :]) @ A  # cnt[u, w] = |{v in N(u): deg v <= D1, w in N(v)}|
    spec = METRICS[metric]  # KeyError for unknown metrics
    if spec.needs_weight:
        # single source of truth: MetricSpec.weight_from_degree (float64)
        wt = spec.weight_from_degree(deg, xp=np) * mid_ok
        acc = (A * wt[None, :]) @ A
    else:
        acc = cnt

    du = deg[:, None]
    dv = deg[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        # single source of truth: MetricSpec.score (float64 host path)
        s = spec.score(cnt, acc, du, dv, xp=np)

    if sources is None:
        valid = np.triu(np.ones((n, n), dtype=bool), k=1)  # w > u
    else:
        valid = np.zeros((n, n), dtype=bool)
        valid[np.asarray(sources, dtype=np.int64), :] = True
        np.fill_diagonal(valid, False)                 # w != u
    valid &= ~(A > 0)                                  # not first-order
    valid &= cnt > 0                                   # touched candidates only
    if max_factor2:
        valid &= (du <= max_factor2 * du) & (dv <= max_factor2 * du)
    valid &= np.nan_to_num(s, nan=-np.inf) > min_score
    us, vs = np.nonzero(valid)
    return {(int(u), int(v)): float(s[u, v]) for u, v in zip(us, vs)}


def oracle_topk_scores(pairs: dict, k: int) -> np.ndarray:
    """Descending score array of the oracle's top-k (for tie-robust comparison)."""
    s = np.sort(np.array(list(pairs.values()), dtype=np.float64))[::-1]
    return s[:k]
