"""Multi-host simulation on localhost: N coordinated CPU processes.

Each process owns one virtual "host" (1 CPU device), joins the
`jax.distributed` process group, builds the same graph + plan, and runs the
stream-sharded mesh scoring.  Process 0 re-runs single-device and asserts the
sharded result reproduces it exactly (score multiset).

Launch:  python examples/multihost_sim/run.py [nprocs]
Worker:  (spawned internally with MHS_RANK set)
"""
import os
import subprocess
import sys

PORT = 12123


def worker(rank: int, nprocs: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    from linkpred_tpu.parallel.distributed import (
        init_distributed, make_global_mesh, process_info)

    # must run before ANY backend-initialising JAX call
    init_distributed(f"localhost:{PORT}", nprocs, rank)
    import jax

    jax.config.update("jax_platforms", "cpu")
    # the key64 CI leg (LINKPRED_KEY64=1) propagates to the simulated hosts;
    # the u64-key engine needs x64 types in every process of the group
    if os.environ.get("LINKPRED_KEY64") == "1":
        jax.config.update("jax_enable_x64", True)
    pid, pcount = process_info()
    assert pcount == nprocs, (pid, pcount)

    import numpy as np

    from linkpred_tpu import PredictOptions, from_edges, predict_links
    from linkpred_tpu.ops.transform import remove_self_loops, symmetrize

    rng = np.random.default_rng(7)
    n, m = 300, 1800
    g = remove_self_loops(symmetrize(from_edges(
        rng.integers(0, n, m), rng.integers(0, n, m), n=n)))

    mesh = make_global_mesh()
    opts = PredictOptions(max_edges=200)
    res = predict_links(g, metric="jaccard_coefficient", min_degree1=8,
                        options=opts, cap=2048, mesh=mesh)
    if pid == 0:
        ref = predict_links(g, metric="jaccard_coefficient", min_degree1=8,
                            options=opts, cap=2048)
        assert len(res) == len(ref) > 0, (len(res), len(ref))
        np.testing.assert_allclose(np.sort(res.score), np.sort(ref.score),
                                   rtol=1e-6)
        print(f"multihost_sim OK: {pcount} processes, {len(res)} predictions, "
              f"sharded == single-host", flush=True)


def main() -> int:
    if "MHS_RANK" in os.environ:
        worker(int(os.environ["MHS_RANK"]), int(os.environ["MHS_NPROCS"]))
        return 0
    nprocs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for r in range(nprocs):
        env = dict(os.environ, MHS_RANK=str(r), MHS_NPROCS=str(nprocs),
                   JAX_PLATFORMS="cpu", PYTHONPATH=repo)
        env.pop("XLA_FLAGS", None)  # one device per simulated host
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if r == 0 else subprocess.DEVNULL))
    rcs = [p.wait(timeout=600) for p in procs]
    assert all(rc == 0 for rc in rcs), rcs
    return 0


if __name__ == "__main__":
    sys.exit(main())
