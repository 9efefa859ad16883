"""Run the scoring engine's main path once on a GPU and check what it returns.

    python chip_smoke.py                # every phase on one card
    python chip_smoke.py --scale 19     # a smaller R-MAT graph
    python chip_smoke.py --kernels      # also time the threshold pack against
                                        # blocked selection alone
    python chip_smoke.py --sweep        # also sweep tile cap and selection block
    python chip_smoke.py --chips 4      # only the sharded path, on four cards

Phases (one process, through the public API; the path holds no hand-written
kernel, so everything runs as XLA compiles it for the card):

1. oracle: a 200-vertex graph through ``predict_links`` (Jaccard, Adamic-Adar)
   against a dense oracle;
2. scale: Graph500-parameter R-MAT (edge factor 16, seed 42) with 0.1|E|
   edges removed, LHub deg 64: ``predict_links`` (Jaccard, k = removed
   count) and ``predict_links_multi`` (all nine metrics) on one plan;
3. correctness at scale: both results against the float64 host reference
   (`linkpred_tpu/bench/reference.py`) on 256 sampled sources.

Times are printed as information.  Any failed phase exits non-zero before
the last line, which is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEG = 64                 # LHub hub threshold of the reference's headline
SEED = 42
N_SOURCES = 256


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def phase_oracle() -> None:
    import linkpred_tpu as lp

    rng = np.random.default_rng(7)
    n = 200
    a = rng.random((n, n)) < 0.08
    a = np.triu(a, 1)
    a = a | a.T
    src, dst = np.nonzero(a)
    g = lp.from_edges(src, dst, n=n)
    deg = a.sum(1)
    cn = a.astype(np.int64) @ a.astype(np.int64)
    with np.errstate(divide="ignore"):
        inv_log = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2)), 0.0)
    aa = (a * inv_log[None, :]).astype(np.float64) @ a.astype(np.float64)
    upper = np.triu(np.ones((n, n), bool), 1) & ~a & (cn > 0)
    want = {
        "jaccard_coefficient": np.where(
            upper, cn / np.maximum(deg[:, None] + deg[None, :] - cn, 1), 0.0),
        "adamic_adar": np.where(upper, aa, 0.0),
    }
    for metric, ref in want.items():
        res = lp.predict_links(g, metric=metric, min_degree1=0,
                               options=lp.PredictOptions(max_edges=500))
        assert len(res) > 0, metric
        np.testing.assert_allclose(res.score, ref[res.u, res.v], rtol=1e-5,
                                   err_msg=metric)
        top = np.sort(ref[ref > 0])[::-1][:len(res)]
        np.testing.assert_allclose(np.sort(res.score)[::-1], top, rtol=1e-5,
                                   err_msg=metric)
        print(f"oracle: {metric} {len(res)} rows match the dense oracle OK")


def make_graph(scale: int):
    """R-MAT graph with 0.1|E| undirected edges removed (the reference's
    protocol); returns (graph, removed undirected edge count)."""
    from linkpred_tpu.bench.synth import rmat_graph
    from linkpred_tpu.ops.batch import (apply_batch, generate_edge_deletions,
                                        tidy_batch)

    g = rmat_graph(scale, edge_factor=16, seed=SEED)
    rng = np.random.default_rng(0)
    dels = generate_edge_deletions(rng, g, int(0.1 * g.size / 2),
                                   undirected=True)
    dels, ins = tidy_batch(dels, np.empty((0, 2), np.int64), g)
    return apply_batch(g, dels, ins), max(dels.shape[0] // 2, 1)


def memory_analysis(y, plan, metric_names, max_edges: int):
    """``compiled.memory_analysis()`` of the single-card scoring step."""
    import jax.numpy as jnp

    from linkpred_tpu.predict import scoring
    from linkpred_tpu.predict.api import selection_k

    gd = y.device()
    stream, tile_start = plan.device_stream()
    w_bits = plan.w_bits if plan.keyed else 0
    lowered = scoring._score_tiles_jit.lower(
        gd.indices, gd.degrees, stream, tile_start, jnp.float32(0.0),
        metric_names=metric_names, cap=plan.cap,
        k=selection_k(plan, max_edges), w_bits=w_bits, packed=plan.packed,
        deg16=plan.deg16, upper_only=plan.upper_only,
        key64=scoring.default_key64())
    return lowered.compile().memory_analysis()


def timed_predict(y, plan, metric: str, max_edges: int, mesh=None):
    """Warm call (compiles), then one timed call; returns (result, wall ms).
    The wall time covers upload, scoring (a warm-up pass and the timed pass,
    as ``predict_links`` runs them), fetch and host ordering."""
    import linkpred_tpu as lp

    opts = lp.PredictOptions(max_edges=max_edges)
    lp.predict_links(y, metric=metric, min_degree1=DEG, options=opts,
                     plan=plan, mesh=mesh)
    t0 = time.perf_counter()
    res = lp.predict_links(y, metric=metric, min_degree1=DEG, options=opts,
                           plan=plan, mesh=mesh)
    return res, _ms(t0)


def phase_scale(scale: int):
    import jax

    import linkpred_tpu as lp
    from linkpred_tpu.bench.reference import (METRIC_NAMES, check_topk,
                                              sample_sources)
    from linkpred_tpu.predict.plan import build_plan

    t0 = time.perf_counter()
    y, k = make_graph(scale)
    print(f"scale: R-MAT {scale}: n={y.n} directed edges={y.size} "
          f"removed={k} ({_ms(t0):.0f} ms host set-up)")
    t0 = time.perf_counter()
    plan = build_plan(y, DEG)
    print(f"scale: plan {_ms(t0):.1f} ms: packed={plan.packed} "
          f"cap={plan.cap} tiles={plan.num_tiles} slots={plan.total_slots} "
          f"huge_slots={plan.huge_slots} host_src={plan.host_src.size}")
    ma = memory_analysis(y, plan, ("jaccard_coefficient",), k)
    print(f"scale: scoring step memory_analysis: {ma}")

    t0 = time.perf_counter()
    res, wall = timed_predict(y, plan, "jaccard_coefficient", k)
    print(f"scale: predict_links jaccard: {len(res)} rows, "
          f"scoring {res.scoring_ms:.2f} ms, fetch {res.transfer_ms:.2f} ms, "
          f"end-to-end {wall:.1f} ms (first call incl. compile: "
          f"{_ms(t0) - wall:.0f} ms)")
    t0 = time.perf_counter()
    multi = lp.predict_links_multi(y, METRIC_NAMES, min_degree1=DEG,
                                   options=lp.PredictOptions(max_edges=k),
                                   plan=plan)
    print(f"scale: predict_links_multi 9 metrics: {_ms(t0):.0f} ms incl. "
          f"compile, scoring {sum(r.scoring_ms for r in multi.values()):.2f}"
          f" ms")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"scale: peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
          f"bytes_limit {stats.get('bytes_limit')}")

    t0 = time.perf_counter()
    off, idx = np.asarray(y.offsets), np.asarray(y.indices)
    sources = sample_sources(off, res.u, N_SOURCES, SEED)
    n1 = check_topk(off, idx, {"jaccard_coefficient": (res.u, res.v,
                                                        res.score)},
                    min_degree1=DEG, k=k, sources=sources)
    n9 = check_topk(off, idx, {m: (r.u, r.v, r.score)
                               for m, r in multi.items()},
                    min_degree1=DEG, k=k, sources=sources)
    print(f"correct: {sources.size} sampled sources, {n1} jaccard and {n9} "
          f"nine-metric returned pairs match the host reference, no "
          f"candidate above the cut missing OK ({_ms(t0):.0f} ms)")
    return y, plan, k


def _switch(env: dict) -> None:
    """Set engine switches and drop traced variants (the switches are read
    while tracing)."""
    from linkpred_tpu.predict.scoring import score_tiles

    os.environ.update(env)
    score_tiles.clear_cache()


def phase_time_kernels(y, plan, k: int) -> None:
    """The threshold pack against blocked selection alone, in turns
    A B B A."""
    names = ("jaccard_coefficient",)
    _switch({"LINKPRED_SEL_PACK_DEBUG": "1"})   # prints whether it packed
    timed_predict(y, plan, names[0], k)
    _switch({"LINKPRED_SEL_PACK_DEBUG": "0"})
    for val in ("1", "0", "0", "1"):
        _switch({"LINKPRED_SEL_PACK": val})
        res, wall = timed_predict(y, plan, names[0], k)
        print(f"time: LINKPRED_SEL_PACK={val}: predict_links end-to-end "
              f"{wall:.2f} ms, scoring {res.scoring_ms:.2f} ms")
    _switch({"LINKPRED_SEL_PACK": "1"})


def phase_sweep(y, k: int) -> None:
    """Tile cap and selection block at this graph."""
    from linkpred_tpu.predict import scoring
    from linkpred_tpu.predict.plan import build_plan

    for cap in (1 << 21, 1 << 22, 1 << 23):
        plan = build_plan(y, DEG, cap=cap)
        res, wall = timed_predict(y, plan, "jaccard_coefficient", k)
        print(f"sweep: cap 2^{cap.bit_length() - 1} tiles={plan.num_tiles}: "
              f"end-to-end {wall:.2f} ms, scoring {res.scoring_ms:.2f} ms")
    plan = build_plan(y, DEG)
    default = scoring._SEL_BLOCK
    for block in (1 << 22, 1 << 23, 1 << 24):
        scoring._SEL_BLOCK = block
        scoring.score_tiles.clear_cache()
        res, wall = timed_predict(y, plan, "jaccard_coefficient", k)
        print(f"sweep: sel block 2^{block.bit_length() - 1} (cap "
              f"2^{plan.cap.bit_length() - 1}): end-to-end {wall:.2f} ms, "
              f"scoring {res.scoring_ms:.2f} ms")
    scoring._SEL_BLOCK = default
    scoring.score_tiles.clear_cache()


def phase_sharded(scale: int, n_dev: int) -> None:
    """The sharded path on ``n_dev`` cards against the single-card run."""
    from linkpred_tpu.parallel.mesh import make_mesh
    from linkpred_tpu.predict.plan import build_plan

    y, k = make_graph(scale)
    plan = build_plan(y, DEG)
    one, wall1 = timed_predict(y, plan, "jaccard_coefficient", k)
    many, wall4 = timed_predict(y, plan, "jaccard_coefficient", k,
                                mesh=make_mesh(n_dev))
    print(f"sharded: R-MAT {scale}, {n_dev} cards: {len(many)} rows, "
          f"scoring {many.scoring_ms:.2f} ms, end-to-end {wall4:.1f} ms; "
          f"one card: scoring {one.scoring_ms:.2f} ms, end-to-end "
          f"{wall1:.1f} ms")
    assert len(many) == len(one) > 0, (len(many), len(one))
    np.testing.assert_allclose(np.sort(many.score), np.sort(one.score),
                               rtol=1e-6)
    ties = int(np.isclose(one.score, one.score[-1]).sum())
    diff = len(set(zip(one.u.tolist(), one.v.tolist()))
               - set(zip(many.u.tolist(), many.v.tolist())))
    assert diff <= ties, (diff, ties)
    print(f"sharded: score multiset equal, {diff} pairs differ within "
          f"{ties} ties at the cut: sharded == single-card OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from linkpred_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    print(f"devices: {devs}")
    print(f"nvidia-smi: {_smi()}")
    print(f"jax {jax.__version__}, compile cache {cache}")
    if args.chips > 1:
        phase_sharded(args.scale, args.chips)
    else:
        phase_oracle()
        y, plan, k = phase_scale(args.scale)
        if args.kernels:
            phase_time_kernels(y, plan, k)
        if args.sweep:
            phase_sweep(y, k)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
