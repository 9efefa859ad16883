"""linkpred_tpu — neighborhood link prediction on an accelerator, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``puzzlef/neighborhood-link-prediction-openmp`` (IHub/LHub link prediction over nine
neighborhood-similarity metrics, dynamic batch experiments, precision/recall
harness), built for an accelerator: static CSR arrays, sort-based tiled scoring under ``jit``,
`shard_map` scaling over device meshes.

Layout (reference layer map in SURVEY.md §1):
  graph      — CSR graph pytree (replaces DiGraph/LazyBitset, inc/Graph.hxx)
  io         — MTX reader/writer (inc/mtx.hxx) + native C++ fast path
  ops        — graph transforms, batch updates, segment/topk primitives (inc/*.hxx L2/L0)
  predict    — the link-prediction engine: 9 metrics, IHub/LHub (inc/predict.hxx)
  parallel   — mesh sharding / multi-chip scaling (replaces OpenMP+belongsOmp)
  models     — predictor model zoo (heuristic metrics; GNN hybrids)
  bench      — experiment harness with reference log-grammar parity (main.cxx)
  utils      — timing, logging
"""

from .graph import (CSRGraph, GraphBuilder, from_edges, from_dense, to_dense,
                    edge_list)
from .predict.api import (
    PredictOptions, PredictResult, predict_links, predict_links_multi,
    top_per_source, PlanCache)
from .predict.metrics import METRICS, get_metric
from .io.mtx import read_mtx, read_mtx_header, write_mtx

__version__ = "0.1.0"

__all__ = [
    "CSRGraph", "GraphBuilder", "from_edges", "from_dense", "to_dense",
    "edge_list",
    "PredictOptions", "PredictResult", "predict_links", "predict_links_multi",
    "top_per_source", "PlanCache",
    "METRICS", "get_metric",
    "read_mtx", "read_mtx_header", "write_mtx",
    "__version__",
]
