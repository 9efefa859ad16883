"""Plain host reference for checking engine results at benchmark scale.

For a sample of source vertices, every candidate's exact float64 score is
computed by per-source NumPy bincounts, written from the reference's
definitions (`/root/reference/inc/predict.hxx:214-265` for the candidate
rule, `:503-831` for the nine formulas).  It shares nothing with the engine:
not the plan, not the scoring path, not `MetricSpec`.

:func:`check_topk` then holds a global top-k result to it: every returned
pair from a sampled source carries the reference's score, and no sampled
candidate scoring above the k-th returned score is missing (ties at the cut
may fall either way).
"""
from __future__ import annotations

import numpy as np

__all__ = ["METRIC_NAMES", "source_scores", "check_topk", "rtol_for",
           "sample_sources"]

METRIC_NAMES = ("common_neighbors", "jaccard_coefficient", "sorensen_index",
                "salton_cosine_similarity", "hub_promoted", "hub_depressed",
                "leicht_holme_nerman", "adamic_adar", "resource_allocation")


def source_scores(offsets, indices, u: int, min_degree1: int):
    """Candidates ``w > u`` of source ``u`` and their scores for all nine
    metrics.  A candidate is reached through an intermediate ``v`` in N(u)
    with ``deg(v) <= min_degree1`` (no bound when ``min_degree1 == 0``), is
    not ``u`` and not a neighbor of ``u``.  Returns ``(w int64[c],
    {metric: float64[c]})`` for the candidates with a positive score."""
    deg = np.diff(offsets)
    nbrs = indices[offsets[u]: offsets[u + 1]]
    mids = nbrs if not min_degree1 else nbrs[deg[nbrs] <= min_degree1]
    if mids.size == 0:
        return np.empty(0, np.int64), {m: np.empty(0) for m in METRIC_NAMES}
    lens = deg[mids]
    first = np.repeat(offsets[mids] - (np.cumsum(lens) - lens), lens)
    cand = indices[first + np.arange(first.size)]
    via = np.repeat(mids, lens)
    keep = (cand > u) & ~np.isin(cand, nbrs)
    cand, via = cand[keep], via[keep]
    w, slot = np.unique(cand, return_inverse=True)
    cn = np.bincount(slot, minlength=w.size).astype(np.float64)
    dv = deg[via].astype(np.float64)
    with np.errstate(divide="ignore"):
        aa = np.bincount(slot, weights=np.where(dv > 1, 1.0 / np.log(dv), 0.0),
                         minlength=w.size)
    ra = np.bincount(slot, weights=1.0 / dv, minlength=w.size)
    du = float(deg[u])
    dw = deg[w].astype(np.float64)
    scores = {
        "common_neighbors": cn,
        "jaccard_coefficient": cn / (du + dw - cn),
        "sorensen_index": cn / (du + dw),
        "salton_cosine_similarity": cn / np.sqrt(du * dw),
        "hub_promoted": cn / np.minimum(du, dw),
        "hub_depressed": cn / np.maximum(du, dw),
        "leicht_holme_nerman": cn / (du * dw),
        "adamic_adar": aa,
        "resource_allocation": ra,
    }
    return w, scores


def sample_sources(offsets, result_u, count: int, seed: int):
    """Half of ``count`` sources drawn from vertices with neighbors, half
    from the sources that appear in a result (so returned pairs get
    checked), seeded."""
    rng = np.random.default_rng(seed)
    live = np.nonzero(np.diff(offsets) > 0)[0]
    a = rng.choice(live, min(count - count // 2, live.size), replace=False)
    used = np.unique(result_u)
    b = rng.choice(used, min(count // 2, used.size), replace=False) \
        if used.size else np.empty(0, np.int64)
    return np.unique(np.concatenate([a, b]).astype(np.int64))


def rtol_for(metric: str) -> float:
    """Score tolerance against the float64 reference: f32 rounding for the
    count metrics, and f32 sums taken in another order for AA/RA."""
    return 1e-5 if metric in ("adamic_adar", "resource_allocation") else 1e-6


def check_topk(offsets, indices, results: dict, *, min_degree1: int, k: int,
               sources) -> int:
    """Hold global top-k results ``{metric: (us, vs, scores)}`` to the
    reference on the sampled ``sources``.  Raises AssertionError on a wrong
    score or a missing candidate; returns the number of returned pairs
    checked."""
    offsets = np.asarray(offsets, np.int64)
    indices = np.asarray(indices, np.int64)
    res = {}
    for metric, (us, vs, scores) in results.items():
        scores = np.asarray(scores, np.float64)
        # a full result (k rows) admits ties at its last score; a short one
        # returned every positive candidate
        cut = scores.min() if scores.size >= k else 0.0
        res[metric] = (np.asarray(us, np.int64), np.asarray(vs, np.int64),
                       scores, cut)
    checked = 0
    for u in sources:
        w, ref_all = source_scores(offsets, indices, int(u), min_degree1)
        for metric, (us, vs, scores, cut) in res.items():
            ref, rtol = ref_all[metric], rtol_for(metric)
            mine = us == u
            got_w, got_s = vs[mine], scores[mine]
            pos = np.minimum(np.searchsorted(w, got_w), max(w.size - 1, 0))
            found = (w[pos] == got_w) if w.size else np.zeros(got_w.shape,
                                                                bool)
            assert found.all(), (f"{metric}: source {u} returned "
                                 f"non-candidates {got_w[~found][:5]}")
            want = ref[pos]
            bad = ~np.isclose(got_s, want, rtol=rtol, atol=0.0)
            assert not bad.any(), (f"{metric}: source {u} scores "
                                   f"{got_s[bad][:5]} != reference "
                                   f"{want[bad][:5]}")
            above = w[ref > cut * (1 + rtol)] if cut > 0 else w[ref > 0]
            missing = np.setdiff1d(above, got_w)
            assert missing.size == 0, (
                f"{metric}: source {u} lost candidates {missing[:5]} scoring "
                f"above the cut {cut}")
            checked += got_w.size
    return checked
