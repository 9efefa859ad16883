"""Command-line experiment driver.

Parity with the reference entry point (`/root/reference/main.cxx:231-249`):

    python -m linkpred_tpu <graph.mtx> [symmetric] [weighted] [options]

Loads an MTX graph, symmetrizes it unless marked symmetric, removes self-loops, and
runs the full sweep, printing reference-grammar log lines that the reference's
``process.js`` (or our ``linkpred_tpu.bench.process``) parses unchanged.

Compile-time ``-D`` macros of the reference (`main.sh:14-42`) surface here as
runtime ``--flags`` — JIT specialization replaces template instantiation, so no
rebuild is needed between configurations.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .bench.harness import ALL_DEGREES, ExperimentConfig, run_experiment
from .io.mtx import read_mtx
from .predict.metrics import METRICS, get_metric
from .utils.logging import graph_line, log

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="linkpred_tpu",
        description="IHub/LHub neighborhood link prediction experiment (JAX)",
    )
    p.add_argument("file", help="input graph in MatrixMarket (.mtx) format")
    p.add_argument("symmetric", nargs="?", default="0",
                   help="1 if the file already stores both edge directions")
    p.add_argument("weighted", nargs="?", default="0",
                   help="1 to read edge weights")
    p.add_argument("--metrics", default=",".join(METRICS),
                   help="comma-separated metric names or aliases")
    p.add_argument("--degrees", default=",".join(map(str, ALL_DEGREES)),
                   help="comma-separated MINDEGREE1 sweep (0 = IHub)")
    p.add_argument("--repeat-batch", type=int, default=5)
    p.add_argument("--repeat-method", type=int, default=5)
    p.add_argument("--batch-length", type=int, default=1)
    p.add_argument("--deletions-begin", type=float, default=1e-4)
    p.add_argument("--deletions-end", type=float, default=1e-1)
    p.add_argument("--deletions-step", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (default: OS entropy, like the reference)")
    p.add_argument("--cap", type=int, default=1 << 20,
                   help="scoring tile slot budget; 0 = adaptive per graph "
                        "(default stays fixed so sweep batches share jit shapes)")
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--jsonl", action="store_true",
                   help="emit JSON-lines result rows instead of the printf grammar")
    p.add_argument("--unfused", action="store_true",
                   help="score each metric as its own full pass (honest "
                        "per-technique times, like the reference's per-metric "
                        "scans; default shares one pass, amortizes the time, "
                        "and tags those rows ...JaxFused<deg> in the log)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    symmetric = bool(int(args.symmetric))
    weighted = bool(int(args.weighted))

    from .utils.debug import install_fault_handler
    install_fault_handler()  # main.cxx:234 install_sigsegv parity

    import jax

    num_threads = jax.device_count()
    # Keep the literal OMP_NUM_THREADS key: process.js keys on it (process.js:5).
    log(f"OMP_NUM_THREADS={num_threads}")
    log(f"Loading graph {args.file} ...")
    g = read_mtx(args.file, weighted=weighted)
    log(graph_line(g.order, g.size))
    if not symmetric:
        from .ops.transform import symmetrize
        g = symmetrize(g)
        log(graph_line(g.order, g.size) + " (symmetrize)")
    from .ops.transform import remove_self_loops
    g = remove_self_loops(g)
    log(graph_line(g.order, g.size) + " (removeSelfLoops)")

    cfg = ExperimentConfig(
        repeat_batch=args.repeat_batch,
        repeat_method=args.repeat_method,
        batch_length=args.batch_length,
        deletions_begin=args.deletions_begin,
        deletions_end=args.deletions_end,
        deletions_step=args.deletions_step,
        metrics=tuple(get_metric(m).name for m in args.metrics.split(",") if m),
        degrees=tuple(int(d) for d in args.degrees.split(",") if d),
        num_threads=num_threads,
        seed=args.seed,
        cap=args.cap or None,
        min_score=args.min_score,
        jsonl=args.jsonl,
        fused_metrics=not args.unfused,
    )
    run_experiment(g, cfg)
    print()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
