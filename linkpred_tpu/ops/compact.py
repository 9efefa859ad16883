"""Threshold compaction for the deferred selection.

The deferred top-k selection (`predict/scoring.py::_argselect_blocked`)
sorts every buffered lane even though only ~k(1+eps) of them can matter.
This module cuts the lanes entering the sort instead:

1. **Sampled threshold**: a strided sample of the selection keys is sorted
   and the k-quantile with a safety margin gives a key threshold T such that
   `count(key <= T) >= k` with high probability (ascending keys = descending
   scores, `scoring._desc_score_key`).
2. **Pack**: per PACK_CHUNK-lane chunk, survivors (key <= T) are compacted in
   order into a fixed chunk/RATIO-lane block together with their original
   lane index: one cumsum for the ranks and one scatter.
3. **Exactness check + fallback**: survivors are counted per chunk.  If any
   chunk overflows its block or the global count falls short of k (sampling
   undershot T), the caller's `lax.cond` falls back to the full blocked sort
   — the packed path is an exact-or-fallback accelerator, never an
   approximation.

The reference analog is the per-thread bounded heap (predict.hxx:309-337):
it too touches every candidate once and keeps only plausible winners.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["pack_survivors", "sample_threshold", "PACK_CHUNK", "PACK_RATIO"]

# Chunk/budget sizing: survivors cluster in hub tiles, so a large chunk with
# a chunk/4 budget pools the slack.  Env-overridable for A/Bs.
PACK_CHUNK = 1 << int(os.environ.get("LINKPRED_PACK_CHUNK_LOG2", "19"))
PACK_RATIO = int(os.environ.get("LINKPRED_PACK_RATIO", "4"))


def pack_survivors(key, threshold, chunk: int = None, ratio: int = None):
    """Pack lanes with ``key <= threshold`` to the front of fixed per-chunk
    blocks.  ``key``: u32[total] (total a multiple of ``chunk`` — the caller
    pads with the 0xFFFFFFFF sentinel, which never survives a real
    threshold).  Returns ``(packed_key u32[total/ratio],
    packed_idx i32[total/ratio], counts i32[nch])`` where ``packed_idx``
    holds ORIGINAL lane indices and dead output lanes carry the 0xFFFFFFFF
    key sentinel (sorts after every survivor).  An overflowing chunk keeps
    its first chunk/ratio survivors in order.
    """
    chunk = PACK_CHUNK if chunk is None else chunk   # module attrs at call
    ratio = PACK_RATIO if ratio is None else ratio   # time (tests patch them)
    i32 = jnp.int32
    total = key.shape[0]
    nch = total // chunk
    assert nch * chunk == total and chunk % ratio == 0, (total, chunk, ratio)
    w = chunk // ratio
    out = total // ratio

    keep = (key <= threshold.astype(key.dtype)).reshape(nch, chunk)
    rank = jnp.cumsum(keep, axis=1, dtype=i32) - 1
    cnt = rank[:, -1] + 1
    lane = jax.lax.broadcasted_iota(i32, (total,), 0)
    base = (jax.lax.broadcasted_iota(i32, (nch, 1), 0) * w)
    # dropped lanes get distinct out-of-range slots, so every index is unique
    dest = jnp.where(keep & (rank < w), base + rank,
                     out + lane.reshape(nch, chunk)).reshape(total)
    pk = jnp.full((out,), jnp.uint32(0xFFFFFFFF), key.dtype).at[dest].set(
        key, mode="drop", unique_indices=True)
    pidx = jnp.zeros((out,), i32).at[dest].set(
        lane, mode="drop", unique_indices=True)
    return pk, pidx, cnt


def sample_threshold(key, kk: int, sample_log2: int = 20,
                     margin: float = 1.10):
    """Sampled k-quantile threshold: T such that count(key <= T) >= kk with
    high probability.  Strided sample (cheap slice, no gather), 1-operand
    sort, quantile at kk/total inflated by ``margin`` plus a 4-sigma
    binomial sampling allowance.  Returns (T, q) — q only for tests.

    ``margin`` 1.10: with 2^20 samples the 4-sigma binomial term already
    covers the global-undershoot risk (~1e-4 relative), and every extra
    survivor tightens the PER-CHUNK budget."""
    total = key.shape[0]
    n_s = min(1 << sample_log2, total)
    stride = total // n_s
    sample = jax.lax.sort(key[: n_s * stride: stride])
    frac = kk / total
    q = frac * margin + 4.0 * float(np.sqrt(max(frac * (1 - frac), 1e-12)
                                            / n_s))
    qi = min(int(q * n_s), n_s - 1)
    return sample[qi], qi
