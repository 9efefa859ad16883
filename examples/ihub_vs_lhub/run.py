"""IHub vs LHub: the headline speedup experiment of the reference.

The reference's central claim (`/root/reference/README.md:9-17`) is that LHub —
skipping hub intermediates with degree > threshold — beats the exhaustive IHub
scan by 415x (0.1|E| removed) to 1622x (10^-2|E| removed) on average while
matching its F1 score.  This example reproduces that comparison on R-MAT graphs
(no network egress here; R-MAT matches the web/social skew the claim is about):

    for each scale, for each removal fraction:
        IHub  = predict_links(..., min_degree1=0)    # scan everything
        LHub  = predict_links(..., min_degree1=64)   # skip hubs (best-F1 regime)

and reports scoring time, the LHub/IHub speedup, and both F1 scores.  IHub
exercises the engine's paths: the packed slot stream, the edge stream once
the expansion exceeds the slot budget (sized from device memory), and the
device-side huge-hub sub-plan (s16 has a source whose expansion exceeds one
tile).

Usage:  python examples/ihub_vs_lhub/run.py [scales...]   (default 14 15 16)
Writes speedup.csv + speedup.md next to this file.
"""
from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import jax  # noqa: E402

from linkpred_tpu import PredictOptions, predict_links  # noqa: E402
from linkpred_tpu.bench.harness import common_pair_count, directed_pairs  # noqa: E402
from linkpred_tpu.bench.synth import rmat_graph  # noqa: E402
from linkpred_tpu.ops.batch import (  # noqa: E402
    apply_batch, generate_edge_deletions, tidy_batch)

METRIC = "jaccard_coefficient"   # the reference sweeps 9 and plots the best;
#                                  jaccard is its best-F1 measure on most graphs
HUB_DEG = 64                     # LHub threshold of the reference headline


def run_one(y, deletions0, min_degree1: int, repeat: int):
    max_edges = max(deletions0.shape[0] // 2, 1)
    res = predict_links(
        y, metric=METRIC, min_degree1=min_degree1,
        options=PredictOptions(repeat=repeat, max_edges=max_edges))
    predicted = np.stack([res.u, res.v], axis=1).astype(np.int64)
    insertions1 = directed_pairs(predicted, undirected=True)
    common = common_pair_count(deletions0, insertions1)
    precision = common / max(insertions1.shape[0], 1)
    recall = common / max(deletions0.shape[0], 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return res.scoring_ms, f1


def main(scales=(14, 15, 16), fractions=(0.01, 0.1), repeat=3):
    rows = []
    for scale in scales:
        print(f"s{scale}: building R-MAT graph...", flush=True)
        g = rmat_graph(scale, edge_factor=16, seed=42)
        for frac in fractions:
            rng = np.random.default_rng(0)
            dels = generate_edge_deletions(
                rng, g, int(frac * g.size / 2), undirected=True)
            dels, ins = tidy_batch(dels, np.empty((0, 2), np.int64), g)
            y = apply_batch(g, dels, ins)
            print(f"s{scale} frac={frac}: batch applied "
                  f"(|E|={y.size}); scoring IHub (compiles take minutes "
                  f"on first run)...", flush=True)
            t0 = time.time()
            ihub_ms, ihub_f1 = run_one(y, dels, 0, repeat)
            print(f"s{scale} frac={frac}: IHub {ihub_ms:.1f} ms f1={ihub_f1:.4f}"
                  f" (wall {time.time() - t0:.0f}s)", flush=True)
            t0 = time.time()
            lhub_ms, lhub_f1 = run_one(y, dels, HUB_DEG, repeat)
            print(f"s{scale} frac={frac}: LHub {lhub_ms:.1f} ms f1={lhub_f1:.4f}"
                  f" (wall {time.time() - t0:.0f}s)", flush=True)
            rows.append(dict(
                scale=scale, n=g.n, m_directed=y.size, fraction=frac,
                ihub_ms=round(ihub_ms, 2), lhub_ms=round(lhub_ms, 2),
                speedup=round(ihub_ms / max(lhub_ms, 1e-9), 1),
                ihub_f1=round(ihub_f1, 4), lhub_f1=round(lhub_f1, 4),
            ))
    # merge with rows of scales NOT re-measured this run (partial reruns like
    # `run.py 16` must not clobber the rest of the table)
    csv_path = os.path.join(HERE, "speedup.csv")
    if os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            rows += [r for r in csv.DictReader(f)
                     if int(r["scale"]) not in set(scales)]
    rows.sort(key=lambda r: (int(r["scale"]), float(r["fraction"])))
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(HERE, "speedup.md"), "w") as f:
        f.write(
            "# LHub vs IHub speedup (R-MAT, jaccard, hub threshold 64, "
            f"{jax.devices()[0].device_kind})\n\n"
            "Reproduces the reference's headline comparison"
            " (`/root/reference/README.md:9-17`:\nLHub beats IHub by 1622x /"
            " 415x on average at 10^-2|E| / 0.1|E| removed, 13\nSuiteSparse"
            " graphs, 32 Xeon cores).  R-MAT substitutes for SuiteSparse here"
            " (no\nnetwork egress); `python examples/ihub_vs_lhub/run.py`"
            " regenerates.\n\n"
            "| scale | \\|E\\| dir | removed | IHub ms | LHub ms | speedup |"
            " IHub F1 | LHub F1 |\n|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['scale']} | {int(r['m_directed']):,} |"
                    f" {r['fraction']} | {float(r['ihub_ms']):,.1f} |"
                    f" {float(r['lhub_ms']):.1f} |"
                    f" **{float(r['speedup']):,.1f}x** |"
                    f" {r['ihub_f1']} | {r['lhub_f1']} |\n")
        f.write("""
Notes:

- The speedup grows with graph size as the reference observes.  Where the
  IHub expansion exceeds the packed slot budget it falls to the memory-light
  edge-stream path (device-side slot-map rebuild, gather-bound), which
  widens the ratio — the same cliff that makes the reference's IHub thrash
  caches on large graphs.
- The edge-stream IHub runs exercise chunked dispatch and segmented
  deferred selection; LHub at every scale is the bench-default engine.
- F1 is ~0 for BOTH approaches on R-MAT: synthetic R-MAT graphs have far
  weaker triadic closure than the reference's web/social graphs (the
  reference's own IHub F1 is just 1.8e-2 / 1.1e-1).  The claim these columns
  support is the reference's equivalence claim — LHub's F1 matches IHub's —
  not absolute accuracy; for F1-meaningful recovery demos run the
  planted-partition sweep in `examples/README.md`.
""")
    print("wrote", os.path.join(HERE, "speedup.csv"))
    return rows


if __name__ == "__main__":
    scales = tuple(int(a) for a in sys.argv[1:]) or (14, 15, 16)
    main(scales)
