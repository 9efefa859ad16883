"""Segmented reductions over sorted key runs — the sort-based "hash table".

The reference accumulates per-candidate counts in a dense per-thread scratch array
indexed by vertex id (`/root/reference/inc/predict.hxx:117-138,154-192`).  The
static-shape equivalent here is: sort the (key, value) stream, then reduce equal-key runs with
scans — O(touched) memory, static shapes, no scatter contention.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["run_boundaries", "segment_run_totals", "cummax"]


def cummax(x, axis: int = -1):
    """Inclusive running maximum (the `lax.cummax` primitive, which XLA
    lowers natively rather than as a generic associative scan)."""
    axis = axis % x.ndim
    return jax.lax.cummax(x, axis=axis)


def run_boundaries(key_hi, key_lo):
    """For lexicographically sorted key pairs, return (is_start, is_end) masks."""
    same_prev = jnp.concatenate([
        jnp.zeros((1,), dtype=bool),
        (key_hi[1:] == key_hi[:-1]) & (key_lo[1:] == key_lo[:-1]),
    ])
    is_start = ~same_prev
    is_end = jnp.concatenate([is_start[1:], jnp.ones((1,), dtype=bool)])
    return is_start, is_end


def segment_run_totals(is_start, *values):
    """Per-position within-run inclusive sums; the value at a run's end position is
    the run total.

    Implemented as a segmented associative scan (sum resets at run starts), NOT as
    differences of a global cumsum — the difference form cancels catastrophically in
    float32 when tiles are large.
    """

    def comb(a, b):
        af, *avs = a
        bf, *bvs = b
        return (af | bf, *[jnp.where(bf, bv, av + bv) for av, bv in zip(avs, bvs)])

    out = jax.lax.associative_scan(comb, (is_start, *values))
    return tuple(out[1:]) if len(values) > 1 else out[1]
