"""Serving mode: "top links for THESE vertices" — the request-shaped API.

The reference is an offline experiment driver; a production link-prediction
service answers per-user requests instead.  This example shows the serving
path the engine exposes for that (`predict/api.py` sources=..., PlanCache,
`top_per_source`):

  * source-restricted plans: only the requested vertices expand (directed
    candidates (s, w), not just the upper triangle);
  * `PlanCache` reuses the host-built plan across requests with the same
    (graph, threshold, sources) — request latency is scoring-only;
  * `top_per_source` turns the engine's global top-k into a per-user top-k.

Run: python examples/serving/run.py   (CPU or GPU; ~seconds)
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
from linkpred_tpu import (PlanCache, PredictOptions, from_edges,  # noqa: E402
                          predict_links, top_per_source)
from linkpred_tpu.ops.transform import remove_self_loops, symmetrize  # noqa: E402


def main():
    rng = np.random.default_rng(7)
    n, m = 5000, 60_000
    g = remove_self_loops(symmetrize(from_edges(
        rng.integers(0, n, m), rng.integers(0, n, m), n=n)))
    print(f"graph: n={g.n} |E|={g.size} (directed)")

    cache = PlanCache()
    users = np.sort(rng.choice(n, size=64, replace=False)).astype(np.int64)

    for request in range(3):
        t0 = time.perf_counter()
        res = predict_links(
            g, metric="adamic_adar", min_degree1=64, sources=users,
            options=PredictOptions(max_edges=64 * 50), plan_cache=cache)
        wall = (time.perf_counter() - t0) * 1e3
        top5 = top_per_source(res, 5)
        served = len(set(top5.u.tolist()))
        print(f"request {request}: {len(res)} candidates -> top-5 for "
              f"{served} users, wall {wall:.0f} ms "
              f"(scoring {res.scoring_ms:.1f} ms)"
              + ("  [plan built]" if request == 0 else "  [plan cached]"))

    # per-user sanity: every served row's source is a requested user and
    # scores within a user are descending
    u_set = set(users.tolist())
    assert all(int(u) in u_set for u in top5.u)
    order = np.argsort(top5.u, kind="stable")
    u_s, s_s = top5.u[order], top5.score[order]
    for i in range(1, len(u_s)):
        if u_s[i] == u_s[i - 1]:
            assert s_s[i] <= s_s[i - 1] + 1e-6
    print("OK: per-user top-5 lists are user-restricted and score-ordered")
    return 0


if __name__ == "__main__":
    sys.exit(main())
