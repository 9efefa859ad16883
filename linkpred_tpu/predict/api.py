"""Public link-prediction API.

Mirrors the reference's options/result types and metric entry points
(`/root/reference/inc/predict.hxx:33-102,503-831`) while routing the computation
through the tiled scoring engine (`scoring.py`).  jit specialization over
(metric, cap, k, padded sizes) replaces the reference's C++ template instantiation
over <MINDEGREE1, MAXFACTOR2, FORCEHEAP, CUSTOMVALUE>.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..graph import CSRGraph
from ..utils.numeric import next_pow2 as _next_pow2
from ..utils.timing import measure_duration
from .metrics import METRICS, get_metric
from .plan import TilePlan, build_plan
from .scoring import CHUNK_TILES, CHUNK_TILES_PACKED, score_tiles_chunked

__all__ = ["PredictOptions", "PredictResult", "predict_links",
           "predict_links_multi", "top_per_source", "PlanCache",
           "selection_k"]

_DEFAULT_MAX_EDGES = 1 << 20




@dataclasses.dataclass
class PredictOptions:
    """Parity with ``PredictLinkOptions<W>`` (`predict.hxx:33-55`).

    ``max_edges=None`` maps the reference's "unbounded" default (-1) to a practical
    2**20 bound (a truly unbounded top-k has no static shape); pass an explicit
    value for larger requests.
    """
    repeat: int = 1
    max_edges: Optional[int] = None
    min_score: float = 0.0


@dataclasses.dataclass
class PredictResult:
    """Parity with ``PredictLinkResult<K, W>`` (`predict.hxx:65-102`)."""
    u: np.ndarray          # int32[E] predicted source (u < v)
    v: np.ndarray          # int32[E] predicted target
    score: np.ndarray      # float32[E], descending
    time_ms: float         # total (scoring + ordering), like `predict.hxx:466`
    scoring_ms: float      # scoring only
    # device->host result transfer, reported separately and EXCLUDED from
    # time_ms: the reference's total covers compute (score+sort+merge) only
    # (`predict.hxx:426-466`), so the k-row fetch must not masquerade as
    # compute in CSV comparisons.
    transfer_ms: float = 0.0

    @property
    def edges(self):
        """[(u, v, score)] list view, reference-style."""
        return list(zip(self.u.tolist(), self.v.tolist(), self.score.tolist()))

    def __len__(self) -> int:
        return int(self.u.shape[0])


class PlanCache:
    """Memoizes tile plans per (graph identity, min_degree1, cap).

    The experiment harness sweeps 9 metrics over the same (graph, threshold) pair
    (`main.cxx:212-220`); the plan depends only on the graph and threshold, so it is
    shared across metrics.
    """

    def __init__(self) -> None:
        self._cache: dict = {}

    def _entry(self, key, g: CSRGraph, build):
        """``id()`` keys are only unique while the object is alive, so every
        entry pins the keyed arrays: a later graph can never reuse a cached id
        while its entry exists (stale-plan-after-GC trap)."""
        hit = self._cache.get(key)
        if hit is not None:
            return hit[2]
        value = build()
        self._cache[key] = (g.offsets, g.indices, value)
        return value

    def get(self, g: CSRGraph, min_degree1: int, cap: Optional[int],
            sources=None) -> TilePlan:
        skey = None if sources is None else hash(np.asarray(sources).tobytes())
        key = (id(g.offsets), id(g.indices), g.n, g.m, min_degree1, cap, skey)
        return self._entry(key, g,
                           lambda: build_plan(g, min_degree1, cap, sources=sources))

    def device_graph(self, g: CSRGraph) -> CSRGraph:
        """Device copy of ``g``, uploaded once per graph (the CSR arrays are tens
        of MB; re-uploading per metric/threshold costs wall-clock)."""
        key = ("gdev", id(g.offsets), id(g.indices), g.n, g.m)
        return self._entry(key, g, g.device)

    def clear(self) -> None:
        self._cache.clear()


def selection_k(plan: TilePlan, max_edges: int) -> int:
    """Top-k width the device selection runs at: the exact request rounded
    up to a multiple of 1024 (jit-shape bucketing), at most the slot count
    of the plan and its sub-plans."""
    # huge_slots already covers the hub sub-plan's stream; only the top-level
    # side stream's slots are additional.
    all_slots = max(plan.total_slots + plan.huge_slots
                    + (plan.side_plan.total_slots if plan.side_plan else 0), 1)
    return min(-(-min(max_edges, all_slots) // 1024) * 1024, all_slots)


def predict_links_multi(
    g: CSRGraph,
    metrics,
    min_degree1: int = 4,
    max_factor2: int = 0,
    options: Optional[PredictOptions] = None,
    cap: Optional[int] = None,
    plan: Optional[TilePlan] = None,
    plan_cache: Optional[PlanCache] = None,
    mesh=None,
    sources=None,
    key64: Optional[bool] = None,
) -> dict:
    """Predict links for SEVERAL metrics in one fused pass.

    ``key64``: engine mode — ``True`` selects the u64-key tile sort (the
    library default, ~24% faster tile sorts at scale; u64 dtypes are created
    under a trace-local ``jax.enable_x64`` so no global flag is needed),
    ``False`` the u32 three-operand engine, ``None`` (default) resolves from
    ``LINKPRED_KEY64``.  Both modes are call state and coexist in one process.

    ``sources``: optional vertex subset — serving mode: score only pairs whose
    source is in the subset, over ALL second-order neighbors (directed
    candidates, see `plan.build_plan`).

    The reference runs its 9 metrics as independent full scans
    (`main.cxx:212-220`); the expansion + sort + run reduction is metric-
    independent, so here it executes once and only the scoring formulas and
    top-k carries fan out.  Returns ``{metric_name: PredictResult}``; reported
    ``scoring_ms``/``time_ms`` are the shared pass time divided evenly across
    metrics (amortized cost per technique).

    ``mesh``: optional 1-D `jax.sharding.Mesh`; tiles shard across its axis with
    a hierarchical top-k merge across devices (the multi-chip replacement for the
    reference's per-thread heaps + serial merge, `predict.hxx:440-459`).
    """
    specs = tuple(get_metric(m) for m in metrics)
    names = tuple(s.name for s in specs)
    o = options or PredictOptions()
    max_edges = _DEFAULT_MAX_EDGES if o.max_edges is None else int(o.max_edges)
    if max_edges <= 0 or not specs:
        # Reference skips the loop entirely when maxEdges == 0 (predict.hxx:367).
        empty = np.empty(0)
        return {name: PredictResult(
            empty.astype(np.int32), empty.astype(np.int32),
            empty.astype(np.float32), 0.0, 0.0) for name in names}

    if plan is None:
        if plan_cache is not None:
            plan = plan_cache.get(g, min_degree1, cap, sources=sources)
        else:
            plan = build_plan(g, min_degree1, cap, sources=sources)

    def _collect_subplans(p):
        # Sub-plan passes in scoring order: the degree-regime side stream and
        # the hub sub-plan (which may itself carry a side stream).
        out = []
        for q in (p.side_plan, p.huge_plan):
            if q is not None:
                out.append(q)
                out.extend(_collect_subplans(q))
        return out

    sub_plans = _collect_subplans(plan)
    k = selection_k(plan, max_edges)
    gd = plan_cache.device_graph(g) if plan_cache is not None else g.device()
    # The stable w-key sort serves both streams whenever ids fit (n <= 2^30);
    # w_bits == 0 selects the sentinel two-key edge sort (set
    # LINKPRED_EDGE_SENTINEL=1 to force it, for A/B runs).
    import os as _os
    edge_sentinel = _os.environ.get("LINKPRED_EDGE_SENTINEL", "0") == "1"
    w_bits = plan.w_bits if (plan.keyed and not (edge_sentinel and not plan.packed)) else 0
    min_score = jnp.float32(o.min_score)
    if key64 is None:
        from .scoring import default_key64
        key64 = default_key64()
    key64 = bool(key64)

    stream_sharded = False
    dummy = jnp.zeros(1, jnp.int32)
    if mesh is not None:
        from ..parallel.mesh import (
            score_tiles_sharded_chunked, shard_stream_for_mesh)
        axis = mesh.axis_names[0]
        # Each device holds ONLY its contiguous block of the stream (memory =
        # total/D): slot arrays for packed plans, fe_* edge-row arrays for
        # edge-stream plans (exactly the IHub-scale runs that are memory-
        # bound on one chip).  The packed kernel reads nothing from the CSR
        # arrays; the edge kernel still gathers `indices` (replicated, 4B/
        # edge) — its 16B/row fe_* arrays are the distributed bulk.  The
        # full-stream device_stream() upload is SKIPPED entirely (it would
        # commit GBs to device 0 for nothing).
        stream_sharded = True
        m_stream, t_starts, t_ends = shard_stream_for_mesh(plan, mesh, axis)
    else:
        stream, tile_start = plan.device_stream()

    def run_sub(p):
        # Sub-plan pass (degree-regime side stream / hub sub-plan): the same
        # engine, and under a mesh the SAME sharded path as the main stream —
        # the reference keeps every source inside its one parallel loop
        # (predict.hxx:287-288), so no sub-pass may serialize onto one device.
        wb = p.w_bits if (p.keyed and not (edge_sentinel and not p.packed)) \
            else 0
        kw = dict(metric_names=names, cap=p.cap, k=k, maxf2=max_factor2,
                  w_bits=wb, packed=p.packed, deg16=p.deg16,
                  upper_only=p.upper_only, key64=key64,
                  chunk=CHUNK_TILES_PACKED if p.packed else CHUNK_TILES)
        if mesh is not None:
            s_stream, s_ts, s_te = shard_stream_for_mesh(p, mesh, axis)
            return score_tiles_sharded_chunked(
                dummy if p.packed else gd.indices, gd.degrees, s_stream,
                s_ts, s_te, min_score, mesh=mesh, axis=axis,
                stream_sharded=True, **kw)
        s_stream, s_ts = p.device_stream()
        return score_tiles_chunked(gd.indices, gd.degrees, s_stream, s_ts,
                                   min_score, **kw)

    def run_scoring():
        if mesh is not None:
            top = score_tiles_sharded_chunked(
                dummy if plan.packed else gd.indices,
                gd.degrees, m_stream,
                t_starts, t_ends, min_score,
                metric_names=names, cap=plan.cap, k=k, maxf2=max_factor2,
                w_bits=w_bits, packed=plan.packed, deg16=plan.deg16,
                upper_only=plan.upper_only, key64=key64,
                mesh=mesh, axis=axis, stream_sharded=stream_sharded,
                chunk=CHUNK_TILES_PACKED if plan.packed else CHUNK_TILES,
            )
        else:
            top = score_tiles_chunked(
                gd.indices, gd.degrees, stream,
                tile_start, min_score,
                metric_names=names, cap=plan.cap, k=k, maxf2=max_factor2,
                w_bits=w_bits, packed=plan.packed, deg16=plan.deg16,
                upper_only=plan.upper_only, key64=key64,
                chunk=CHUNK_TILES_PACKED if plan.packed else CHUNK_TILES,
            )
        return (top, *[run_sub(p) for p in sub_plans])

    # Mega-hub sources whose one-tile expansion would blow the deferred
    # selection's HBM bound run through the exact host scorer; their wall time
    # counts toward scoring (the reference keeps every source in its timed
    # loop, predict.hxx:287-288).
    host_rows = {}
    host_ms = 0.0
    if plan.host_src.size:
        import time as _time

        from .scoring import score_huge_sources_host_multi

        t0 = _time.perf_counter()
        # One expansion pass shared by every metric (the fused-pass contract
        # holds on the host path too).
        host_rows = score_huge_sources_host_multi(
            g, plan.host_src, specs, min_degree1, max_factor2,
            o.min_score, k=max_edges, upper_only=plan.upper_only)
        host_ms = (_time.perf_counter() - t0) * 1e3

    ts, tops = measure_duration(run_scoring, repeat=o.repeat)
    ts += host_ms
    top, sub_tops = tops[0], tops[1:]

    results = {}
    for i, name in enumerate(names):
        transfer = [0.0]

        def fetch(t, i):
            import time as _time

            t0 = _time.perf_counter()
            scores = np.asarray(t.scores[i])
            us = np.asarray(t.u[i])
            vs = np.asarray(t.v[i])
            transfer[0] += (_time.perf_counter() - t0) * 1e3
            valid = np.isfinite(scores)
            return scores[valid], us[valid], vs[valid]

        def finalize(i=i, name=name):
            scores, us, vs = fetch(top, i)
            for t in sub_tops:
                hs, hu, hv = fetch(t, i)
                scores = np.concatenate([scores, hs])
                us = np.concatenate([us, hu])
                vs = np.concatenate([vs, hv])
            if name in host_rows:
                ms_, mu_, mv_ = host_rows[name]
                scores = np.concatenate([scores, ms_])
                us = np.concatenate([us, mu_])
                vs = np.concatenate([vs, mv_])
            order = np.argsort(-scores, kind="stable")[:max_edges]
            return us[order], vs[order], scores[order]

        to, (us, vs, ss) = measure_duration(finalize, repeat=1, warmup=False)
        results[name] = PredictResult(
            u=us.astype(np.int32), v=vs.astype(np.int32),
            score=ss.astype(np.float32),
            time_ms=ts / len(names) + max(to - transfer[0], 0.0),
            scoring_ms=ts / len(names),
            transfer_ms=transfer[0],
        )
    return results


def predict_links(
    g: CSRGraph,
    metric: str = "common_neighbors",
    min_degree1: int = 4,
    max_factor2: int = 0,
    options: Optional[PredictOptions] = None,
    cap: Optional[int] = None,
    plan: Optional[TilePlan] = None,
    plan_cache: Optional[PlanCache] = None,
    mesh=None,
    sources=None,
    key64: Optional[bool] = None,
) -> PredictResult:
    """Predict the top-``max_edges`` unobserved links of an undirected graph.

    ``min_degree1`` = 0 is IHub (scan all intermediates); > 0 is LHub (skip hub
    intermediates with degree above the threshold) — `predict.hxx:227,301`.
    Defaults mirror the reference template defaults <MINDEGREE1=4, MAXFACTOR2=0>.
    Thin wrapper over :func:`predict_links_multi` with a single metric.
    """
    spec = get_metric(metric)
    return predict_links_multi(
        g, (spec.name,), min_degree1=min_degree1, max_factor2=max_factor2,
        options=options, cap=cap, plan=plan, plan_cache=plan_cache, mesh=mesh,
        sources=sources, key64=key64,
    )[spec.name]


def top_per_source(result: PredictResult, k: int) -> PredictResult:
    """Keep the best ``k`` predictions per source vertex (serving helper for
    source-restricted results; the engine's top-k is global)."""
    if len(result) == 0 or k <= 0:
        empty = np.empty(0)
        return PredictResult(empty.astype(np.int32), empty.astype(np.int32),
                             empty.astype(np.float32),
                             result.time_ms, result.scoring_ms,
                             result.transfer_ms)
    # result.score is descending; a stable sort by u preserves per-source order.
    order = np.argsort(result.u, kind="stable")
    u, v, s = result.u[order], result.v[order], result.score[order]
    is_first = np.empty(u.shape[0], dtype=bool)
    is_first[0] = True
    is_first[1:] = u[1:] != u[:-1]
    group_start = np.maximum.accumulate(
        np.where(is_first, np.arange(u.shape[0]), 0))
    rank = np.arange(u.shape[0]) - group_start
    keep = rank < k
    # restore global descending-score order
    back = np.argsort(-s[keep], kind="stable")
    return PredictResult(u=u[keep][back], v=v[keep][back], score=s[keep][back],
                         time_ms=result.time_ms, scoring_ms=result.scoring_ms,
                         transfer_ms=result.transfer_ms)
