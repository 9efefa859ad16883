"""Experiment harness: remove random edges, predict, measure precision/recall.

Behavioral parity with the reference driver (`/root/reference/main.cxx:158-221`):

* ``run_batches`` sweeps batch fractions ``deletions_begin → deletions_end`` with a
  multiplicative step (`main.cxx:158-177`, defaults from `main.sh:22-27`), repeating
  each fraction ``repeat_batch`` times over ``batch_length``-step sequences.
* Per batch: sample deletions/insertions, tidy, apply, then call the per-batch
  callback with the updated graph (`main.cxx:162-171`).
* ``run_experiment`` runs every (metric × min_degree1) combination per batch
  (`main.cxx:212-220`, ``PREDICT_LINKS_ALL`` degree sweep `main.cxx:67-80`), with
  ``max_edges`` = number of removed undirected edges (`main.cxx:50`), and logs one
  reference-grammar result line per run (`main.cxx:199-206`).
* precision = |common| / max(|predicted directed|, 1); recall = |common| /
  max(|removed directed|, 1) (`main.cxx:193-195`).

Unlike the reference (seeded from ``random_device``, `main.cxx:194`), the sweep takes
an explicit seed — runs are reproducible by default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from ..graph import CSRGraph
from ..ops.batch import (
    apply_batch,
    generate_edge_deletions,
    generate_edge_insertions,
    tidy_batch,
)
from ..predict.api import (
    PlanCache, PredictOptions, predict_links, predict_links_multi)
from ..predict.metrics import METRICS, TECHNIQUE_NAMES, get_metric
from ..utils.logging import log, result_line

__all__ = [
    "ALL_DEGREES",
    "ExperimentConfig",
    "directed_pairs",
    "common_pair_count",
    "run_batches",
    "run_experiment",
]

# The reference's MINDEGREE1 sweep (main.cxx:67-80).
ALL_DEGREES = (0, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass
class ExperimentConfig:
    """Sweep configuration. Defaults mirror `main.sh:14-42` / `main.cxx:17-34`
    (env-var → ``-D`` macros become plain runtime fields here)."""

    repeat_batch: int = 5         # REPEAT_BATCH
    repeat_method: int = 5        # REPEAT_METHOD
    batch_length: int = 1         # BATCH_LENGTH
    deletions_begin: float = 1e-4  # BATCH_DELETIONS_BEGIN
    deletions_end: float = 1e-1    # BATCH_DELETIONS_END
    deletions_step: float = 10.0   # BATCH_DELETIONS_STEP (*=)
    insertions_begin: float = 0.0
    insertions_end: float = 0.0
    insertions_step: float = 10.0
    metrics: Sequence[str] = tuple(METRICS)
    degrees: Sequence[int] = ALL_DEGREES
    num_threads: int = 0          # label only; 0 => jax.device_count()
    seed: Optional[int] = 0       # None => OS entropy (reference behavior)
    cap: Optional[int] = 1 << 20  # tile slot budget; None = adaptive
    #                               (fixed default keeps jit shapes stable
    #                               across sweep batches on slow-compile hosts)
    min_score: float = 0.0
    fused_metrics: bool = True    # one expansion+sort pass scores all metrics
    jsonl: bool = False           # emit JSON-lines instead of the printf grammar


def directed_pairs(pairs: np.ndarray, undirected: bool = False) -> np.ndarray:
    """Expand undirected (u, v) rows into directed rows, sorted and deduped
    (``directedInsertions`` + sort + unique, `main.cxx:95-120,51-54`)."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if undirected and pairs.shape[0]:
        pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    if pairs.shape[0] == 0:
        return pairs
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs = pairs[order]
    keep = np.empty(pairs.shape[0], dtype=bool)
    keep[0] = True
    keep[1:] = (pairs[1:] != pairs[:-1]).any(axis=1)
    return pairs[keep]


def common_pair_count(a: np.ndarray, b: np.ndarray) -> int:
    """|a ∩ b| for directed pair arrays (``commonEdges``, `main.cxx:129-133`)."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0
    hi = int(max(a[:, 1].max(), b[:, 1].max())) + 1
    ka = a[:, 0] * hi + a[:, 1]
    kb = b[:, 0] * hi + b[:, 1]
    return int(np.intersect1d(ka, kb, assume_unique=False).size)


def run_batches(
    g: CSRGraph,
    rng: np.random.Generator,
    fn: Callable,
    config: Optional[ExperimentConfig] = None,
) -> None:
    """Sweep batch updates over the fraction schedule and invoke
    ``fn(y, deletions_fraction, deletions, insertions_fraction, insertions,
    sequence, epoch)`` per batch (`main.cxx:158-177`)."""
    cfg = config or ExperimentConfig()
    d = cfg.deletions_begin
    i = cfg.insertions_begin
    epoch = 0
    while True:
        for _ in range(cfg.repeat_batch):
            y = g
            for sequence in range(cfg.batch_length):
                deletions = generate_edge_deletions(
                    rng, y, int(d * g.size / 2), undirected=True)
                insertions = generate_edge_insertions(
                    rng, y, int(i * g.size / 2), undirected=True)
                deletions, insertions = tidy_batch(deletions, insertions, y)
                y = apply_batch(y, deletions, insertions)
                fn(y, d, deletions, i, insertions, sequence, epoch)
        if d >= cfg.deletions_end and i >= cfg.insertions_end:
            break
        d = min(d * cfg.deletions_step, cfg.deletions_end)
        i = min(i * cfg.insertions_step, cfg.insertions_end)
        epoch += 1


def run_experiment(
    g: CSRGraph,
    config: Optional[ExperimentConfig] = None,
    emit: Callable[[str], None] = print,
) -> list[dict]:
    """Full sweep: per batch, per metric, per hub threshold — predict the removed
    edges back and log precision/recall in the reference grammar
    (`main.cxx:191-221`). Returns the result rows as dicts as well."""
    import jax

    cfg = config or ExperimentConfig()
    cfg = dataclasses.replace(
        cfg, metrics=tuple(get_metric(m).name for m in cfg.metrics))
    num_threads = cfg.num_threads or jax.device_count()
    rng = np.random.default_rng(cfg.seed)
    plan_cache = PlanCache()
    rows: list[dict] = []

    def per_batch(y, df, deletions, inf, insertions, sequence, epoch):
        if deletions.shape[0] == 0:
            return
        # deletions arrive directed (both orientations) from tidy_batch; they are
        # already sorted+unique — this is `deletions0` (main.cxx:210-211).
        deletions0 = deletions
        max_edges = deletions0.shape[0] // 2
        for deg in cfg.degrees:
            if cfg.fused_metrics:
                # One expansion+sort pass scores every metric (the reference
                # re-scans per metric, main.cxx:212-220); reported times are
                # amortized per technique.
                multi = predict_links_multi(
                    y, cfg.metrics, min_degree1=deg,
                    options=PredictOptions(
                        repeat=cfg.repeat_method, max_edges=max_edges,
                        min_score=cfg.min_score),
                    cap=cfg.cap, plan_cache=plan_cache,
                )
            else:
                multi = {
                    metric: predict_links(
                        y, metric=metric, min_degree1=deg,
                        options=PredictOptions(
                            repeat=cfg.repeat_method, max_edges=max_edges,
                            min_score=cfg.min_score),
                        cap=cfg.cap, plan_cache=plan_cache)
                    for metric in cfg.metrics
                }
            for metric in cfg.metrics:
                res = multi[metric]
                predicted = np.stack([res.u, res.v], axis=1).astype(np.int64)
                insertions1 = directed_pairs(predicted, undirected=True)
                common = common_pair_count(deletions0, insertions1)
                precision = common / max(insertions1.shape[0], 1)
                recall = common / max(deletions0.shape[0], 1)
                # Amortized rows are TAGGED in the technique name: a fused
                # multi-metric pass divides ONE shared expansion+sort evenly
                # across the metrics, so its per-row times are not comparable
                # to the reference's per-technique scans (main.cxx:212-220).
                # A reference-CSV reader sees `...JaxFused64` and cannot
                # mistake it for a per-technique measurement; `--unfused`
                # (or a single metric, where nothing is amortized) keeps the
                # plain `...Jax64` label.
                amortized = cfg.fused_metrics and len(cfg.metrics) > 1
                tag = "JaxFused" if amortized else "Jax"
                technique = f"{TECHNIQUE_NAMES[metric]}{tag}{deg}"
                # NOTE: the reference prints the deletion fraction in the "+" slot
                # with 0.0 in the "-" slot (`main.cxx:199-206` passes insertionsf=
                # deletionsf) — kept verbatim for process.js column parity.
                row = dict(
                    batch_deletions_fraction=0.0,
                    batch_insertions_fraction=df,
                    num_threads=num_threads,
                    total_time=res.time_ms,
                    scoring_time=res.scoring_ms,
                    precision=precision,
                    recall=recall,
                    technique=technique,
                )
                if cfg.jsonl:
                    import json

                    emit(json.dumps(row))
                else:
                    emit(result_line(0.0, df, num_threads, res.time_ms,
                                     res.scoring_ms, precision, recall,
                                     technique))
                rows.append(row)
        plan_cache.clear()

    run_batches(g, rng, per_batch, cfg)
    return rows
