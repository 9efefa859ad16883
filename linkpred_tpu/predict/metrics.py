"""The nine neighborhood-similarity metrics.

Reference parity (`/root/reference/inc/predict.hxx:503-831`): each metric is a score
function of (|N(u) ∩ N(v)|, deg(u), deg(v)); Adamic–Adar and Resource Allocation
instead accumulate a per-intermediate weight during the second-hop scan
(`predict.hxx:770,788` — ``1/log(deg(mid))``; `:810,828` — ``1/deg(mid)``) and return
the accumulated value directly.

Here every metric is one elementwise JAX function over the vectorized run totals, so
all nine share the same expansion/reduction kernel; the kernel is specialized per
metric at jit time (the analog of the reference's template instantiation).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

__all__ = ["METRICS", "MetricSpec", "get_metric", "TECHNIQUE_NAMES",
           "maxf2_mask"]


def maxf2_mask(du, dw, maxf2):
    """The reference's MAXFACTOR2 validity predicate *as written*
    (`predict.hxx:221,295`): note it compares deg(u) against maxf2*deg(u)
    (a trivially-true self-compare) — preserved verbatim for parity; the
    published experiment never sets MAXFACTOR2.  This is the ONLY statement
    of the predicate: the device tail and the host oracle both call it
    (elementwise jnp/np ops only, so one definition serves device traces and
    NumPy arrays alike)."""
    return (du <= maxf2 * du) & (dw <= maxf2 * du)

_LN2 = 0.6931471805599453


def _accurate_log(x):
    """float32 natural log accurate to ~2e-7 relative on every backend (a
    device's builtin fast-math ``log`` need not be).  Exact range reduction
    via ``frexp``
    (pure bit manipulation), then log(m) for m in [0.5, 1) by the atanh
    series: ``log(m) = 2s(1 + s²/3 + ... + s¹⁰/11)``, s = (m-1)/(m+1),
    |s| <= 1/3 so the truncation error is ~9e-8.  The reference accumulates
    ``1/log(degree)`` in double (`predict.hxx:770,788`); this keeps f32 device
    scores within f32 rounding of that."""
    m, e = jnp.frexp(x.astype(jnp.float32))
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    logm = 2.0 * s * (1.0 + s2 * (1.0 / 3.0 + s2 * (1.0 / 5.0 + s2 * (
        1.0 / 7.0 + s2 * (1.0 / 9.0 + s2 * (1.0 / 11.0))))))
    return e.astype(jnp.float32) * jnp.float32(_LN2) + logm


class MetricSpec(NamedTuple):
    name: str
    needs_weight: bool  # True => accumulate mid-vertex weights (CUSTOMVALUE variant)

    def weight_from_degree(self, deg, xp=jnp):
        """Per-intermediate weight as an elementwise function of deg(mid)
        — the reference accumulates ``1.0/log(degree)`` / ``1.0/degree`` per
        scan step (`predict.hxx:770,788,810,828`).  This is the ONLY statement
        of the weight formulas: both engine paths call it with ``xp=jnp``
        (float32, exact-range-reduction log — bit-identical across paths) and
        the host scorer / test oracle call it with ``xp=np`` (float64, libm
        log — the reference's double accumulator).  Guarded against deg<=1
        (such lanes are masked downstream, but inf/nan must not be
        produced)."""
        if xp is jnp:
            d = deg.astype(jnp.float32)
            log = _accurate_log
        else:
            d = np.asarray(deg, dtype=np.float64)
            log = np.log
        if self.name == "adamic_adar":
            return xp.where(d > 1, 1.0 / log(xp.maximum(d, 2.0)), 0.0)
        if self.name == "resource_allocation":
            return xp.where(d > 0, 1.0 / xp.maximum(d, 1.0), 0.0)
        raise AssertionError(self.name)

    def score(self, cnt, acc, deg_u, deg_v, xp=jnp):
        """Similarity score — the ONLY statement of the 9 score formulas
        (`predict.hxx:503-831`).  ``cnt`` common-neighbor count, ``acc``
        accumulated weight (AA/RA only).  ``xp=jnp`` (device paths) computes
        in float32; ``xp=np`` (host scorer, test oracle) in float64."""
        dtype = jnp.float32 if xp is jnp else np.float64
        nuv = cnt.astype(dtype)
        du = deg_u.astype(dtype) if hasattr(deg_u, "astype") else dtype(deg_u)
        dv = deg_v.astype(dtype) if hasattr(deg_v, "astype") else dtype(deg_v)
        n = self.name
        if n == "common_neighbors":      # predict.hxx:504
            return nuv
        if n == "jaccard_coefficient":   # predict.hxx:542
            return nuv / (du + dv - nuv)
        if n == "sorensen_index":        # predict.hxx:580
            return nuv / (du + dv)
        if n == "salton_cosine_similarity":  # predict.hxx:618
            return nuv / xp.sqrt(du * dv)
        if n == "hub_promoted":          # predict.hxx:656
            return nuv / xp.minimum(du, dv)
        if n == "hub_depressed":         # predict.hxx:694
            return nuv / xp.maximum(du, dv)
        if n == "leicht_holme_nerman":   # predict.hxx:732
            return nuv / (du * dv)
        if n in ("adamic_adar", "resource_allocation"):  # predict.hxx:771,811
            return acc
        raise AssertionError(n)


METRICS = {
    s.name: s
    for s in [
        MetricSpec("common_neighbors", False),
        MetricSpec("jaccard_coefficient", False),
        MetricSpec("sorensen_index", False),
        MetricSpec("salton_cosine_similarity", False),
        MetricSpec("hub_promoted", False),
        MetricSpec("hub_depressed", False),
        MetricSpec("leicht_holme_nerman", False),
        MetricSpec("adamic_adar", True),
        MetricSpec("resource_allocation", True),
    ]
}

# Technique-name stems used in result-log lines, mirroring the reference's
# function-name-derived labels (main.cxx:212-220) with the Jax suffix.
TECHNIQUE_NAMES = {
    "common_neighbors": "predictLinksCommonNeighbors",
    "jaccard_coefficient": "predictLinksJaccardCoefficient",
    "sorensen_index": "predictLinksSorensenIndex",
    "salton_cosine_similarity": "predictLinksSaltonCosineSimilarity",
    "hub_promoted": "predictLinksHubPromoted",
    "hub_depressed": "predictLinksHubDepressed",
    "leicht_holme_nerman": "predictLinksLeichtHolmeNermanScore",
    "adamic_adar": "predictLinksAdamicAdarCoefficient",
    "resource_allocation": "predictLinksResourceAllocationScore",
}


def get_metric(name: str) -> MetricSpec:
    key = name.lower()
    aliases = {
        "cn": "common_neighbors",
        "jaccard": "jaccard_coefficient",
        "sorensen": "sorensen_index",
        "salton": "salton_cosine_similarity",
        "cosine": "salton_cosine_similarity",
        "hpi": "hub_promoted",
        "hdi": "hub_depressed",
        "lhn": "leicht_holme_nerman",
        "aa": "adamic_adar",
        "ra": "resource_allocation",
    }
    key = aliases.get(key, key)
    if key not in METRICS:
        raise KeyError(f"unknown metric {name!r}; one of {sorted(METRICS)}")
    return METRICS[key]
