"""The scoring engine: tiled expand → sort → segment-reduce → fused top-k.

This is the JAX re-expression of the reference's hot loop
(`/root/reference/inc/predict.hxx:284-339`):

* the per-thread dense scratch scatter (`predict.hxx:154-179`) becomes a sort of
  per-slot candidate keys + a run reduction (sort-based accumulation is the
  XLA-idiomatic hash table);
* the "zero out self + first-order neighbors" pass (`predict.hxx:306-307`) becomes
  killer slots injected by the plan (see `plan.py`): a killer shares its (u, w) run
  but sorts first, so any run led by a killer is dead;
* the per-thread bounded min-heap (`predict.hxx:309-337`) becomes a fused per-tile
  top-k merged into a running top-k carry inside `lax.scan`;
* `schedule(dynamic, 2048)` load balancing (`predict.hxx:287`) is precomputed as the
  work-balanced tile schedule.

Two execution paths (chosen statically by the plan, see `plan.py`):

* **Packed slot stream** (fast): the expansion is precomputed host-side; the
  device does dynamic-slice window reads → one STABLE single-key sort of the
  candidate id w (source/degrees ride as payloads; no gathers at all) → one
  max-scan.  Stability + the plan's killers-first stream order keep each
  (w, u) group contiguous with its killer at the head, so the common-neighbor
  count is the *run length* (killers invalidate, never subtract) and no
  source-span bound exists.  Tile windows are dynamic slices (an indexed
  read with a dynamic start lowers to a full gather) and every sort is 1-D.
* **Edge stream** (memory-light fallback): the device rebuilds the slot mapping
  (cumsum + scatter + max-scan) and reduces via the same stable w-key sort
  (sentinel two-key sort when ids exceed 2^30 or LINKPRED_EDGE_SENTINEL=1).
  Used for IHub-scale expansions where materializing slots would blow memory.

Everything is static-shaped and jit-compiled once per (metric, cap, k, padded
sizes) — the analog of the reference's template instantiation.
"""
from __future__ import annotations

import os as _os
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

# 64-bit-key engine mode (THE LIBRARY DEFAULT): the tile sort packs
# (w, src) into ONE u64 key — 2 sort operands instead of 3 (deg16) or packs
# the degree pair into a u64 payload — 2 instead of 4 (wide degrees).
# Grouping by the composite key makes sort stability unnecessary (intra-run
# payload order is irrelevant: degrees are constant within a run and the
# AA/RA weights are summed).  Which mode is faster on the GPU is open
# (ROADMAP D4).  The u64 dtypes are created under a TRACE-LOCAL
# jax.enable_x64(True) context (no process-global x64 flag needed or
# touched); LINKPRED_KEY64=0 selects the u32 engine.  The mode is
# CALL STATE (a static jit arg threaded from the API), not an import-time
# global: both engines coexist in one process, and the full
# oracle/differential/mesh suite runs both modes via scripts/ci.sh.


def default_key64() -> bool:
    """Engine-mode default (key64, the faster engine), read from
    ``LINKPRED_KEY64`` at CALL time (so a test or harness can flip modes
    without reimporting)."""
    return _os.environ.get("LINKPRED_KEY64", "1") == "1"

from ..graph import CSRGraph
from ..ops.segment import cummax, run_boundaries, segment_run_totals
from ..ops.topk import TopK
from .metrics import METRICS, MetricSpec, maxf2_mask
from .plan import KILL

__all__ = ["score_tiles", "score_tiles_chunked", "tile_candidates",
           "score_huge_sources_host", "score_huge_sources_host_multi"]

_SENTINEL = np.int32(2**31 - 1)


def _score_runs(metrics, du, dw, cnt_tot, wt_tots, valid, maxf2, min_score):
    """Shared tail: per-metric formulas + validity/min-score mask
    (predict.hxx:503-831).  ``wt_tots`` maps weighted-metric name -> accumulated
    run totals.  Returns scores stacked [M, cap]."""
    if maxf2:
        valid &= maxf2_mask(du, dw, maxf2)  # single source: metrics.maxf2_mask
    nuv = jnp.maximum(cnt_tot, 0)
    rows = []
    for metric in metrics:
        acc = wt_tots[metric.name] if metric.needs_weight else nuv.astype(jnp.float32)
        s = metric.score(nuv, acc, du, dw)
        rows.append(jnp.where(valid & (s > min_score), s, -jnp.inf))
    return jnp.stack(rows)


def _pad_key(iota, w_bits):
    """Keys for invalid/padding lanes: one value range above every real
    candidate id, spread by lane index (a constant sentinel mass degrades XLA's
    sort)."""
    return jnp.int32(1 << w_bits) | (iota & jnp.int32(1023))


def _keyed_sort_reduce(key, upay, udeg, wdeg, wts, weighted, metrics,
                       *, w_bits: int, n: int, maxf2: int,
                       min_score, deg16: bool = False, killers: bool = True,
                       predpacked: bool = False, key64: bool = False):
    """Shared reduce: STABLE single-key sort of the candidate id w (payloads:
    ``upay`` = src << 1 | real_flag, degrees, AA/RA weights) → run boundaries on
    (w, src) → count-by-run-length with killer-flag liveness → scores.

    Stability + the plan's killers-first stream order keep each (w, u) group
    contiguous with its killer slots at the head, so a run is alive iff its
    first slot is real and the common-neighbor count is simply the run length.
    No source-span bound exists — tiles fill to cap at any n <= 2^30.
    ``deg16`` packs the degree pair into one int32 payload (fewer operands);
    ``predpacked`` means the plan already packed it (``udeg`` holds the pair,
    ``wdeg`` is unused).  ``killers=False`` (packed slot stream): dead slots
    were dropped at plan time, so ``upay`` is the bare source id and the
    liveness flag machinery drops out of the tail.
    """
    i32 = jnp.int32
    if key64:
        # One u64 key carries (w, upay): grouping is BY THE KEY, so the sort
        # needs no stability (payloads within a run are a constant degree pack
        # or summed weights), and the killer flag in upay's low bit keeps
        # killers first within their run by VALUE rather than by stream order.
        # The u64 types are created under a TRACE-LOCAL jax.enable_x64(True)
        # context, so the engine no longer needs (or changes) the
        # process-global x64 flag — no u64 escapes this block (everything is
        # extracted back to 32-bit before the context closes).
        with jax.enable_x64(True):
            u64 = jnp.uint64
            m32 = u64(0xFFFFFFFF)
            # zero-extend via uint32 (pad lanes may carry junk; int32 sign
            # extension would smear high bits into the w field)
            key64 = (key.astype(jnp.uint32).astype(u64) << u64(32)) \
                | upay.astype(jnp.uint32).astype(u64)
            if deg16:
                dpack = udeg if predpacked else ((udeg << 16) | wdeg)
                key64, dpack, *wts = jax.lax.sort(
                    (key64, dpack, *wts), num_keys=1, is_stable=False)
                udeg = (dpack >> 16) & 0xFFFF
                wdeg = dpack & 0xFFFF
            else:
                dpack64 = (udeg.astype(jnp.uint32).astype(u64) << u64(32)) \
                    | wdeg.astype(jnp.uint32).astype(u64)
                key64, dpack64, *wts = jax.lax.sort(
                    (key64, dpack64, *wts), num_keys=1, is_stable=False)
                udeg = (dpack64 >> u64(32)).astype(i32)
                wdeg = (dpack64 & m32).astype(i32)
            upay = (key64 & m32).astype(i32)
            key = (key64 >> u64(32)).astype(i32)
    elif deg16:
        dpack = udeg if predpacked else ((udeg << 16) | wdeg)
        key, upay, dpack, *wts = jax.lax.sort(
            (key, upay, dpack, *wts), num_keys=1, is_stable=True)
        # Mask after the shift: for udeg >= 2^15 the pack sets the int32 sign
        # bit and `>> 16` alone would sign-extend (40000 would come back as
        # -25536, silently corrupting every degree-dependent metric).
        udeg = (dpack >> 16) & 0xFFFF
        wdeg = dpack & 0xFFFF
    else:
        key, upay, udeg, wdeg, *wts = jax.lax.sort(
            (key, upay, udeg, wdeg, *wts), num_keys=1, is_stable=True)
    return _xla_tail(key, upay, udeg, wdeg, wts, weighted, metrics,
                     w_bits=w_bits, n=n, maxf2=maxf2, min_score=min_score,
                     killers=killers)


def _xla_tail(key, upay, udeg, wdeg, wts, weighted, metrics, *, w_bits: int,
              n: int, maxf2: int, min_score, killers: bool):
    """The post-sort tail in plain XLA: run boundaries, run-start cummax,
    counts, AA/RA run totals and scores over one sorted tile.  Returns
    (scores [M, cap], ku, kw)."""
    i32 = jnp.int32
    cap = key.shape[0]
    iota = jax.lax.broadcasted_iota(i32, (cap,), 0)
    src = upay if not killers else (upay >> 1)
    neq = (key[1:] != key[:-1]) | (src[1:] != src[:-1])
    is_start = jnp.concatenate([jnp.ones((1,), bool), neq])
    is_end = jnp.concatenate([neq, jnp.ones((1,), bool)])
    if killers:
        # One max-scan carries both the run-start position and the first
        # slot's real/killer flag.
        flag = (upay & 1).astype(i32)
        m = cummax(jnp.where(is_start, (iota << 1) | flag, 0))
        start = m >> 1
        alive = (m & 1) == 1
    else:
        start = cummax(jnp.where(is_start, iota, 0))
        alive = jnp.ones((cap,), bool)
    cnt_tot = iota - start + 1                    # run length == Nuv when alive

    wt_tots = {}
    if weighted:
        tots = segment_run_totals(is_start, *wts)
        tots = tots if isinstance(tots, tuple) else (tots,)
        wt_tots = {m.name: t for m, t in zip(weighted, tots)}

    # pads/dead lanes live at key >= 2^w_bits; the w > u (or w != u) candidate
    # filter was applied at plan time (predict.hxx:221 ft)
    valid = is_end & alive & (key < (1 << w_bits))
    ku = jnp.minimum(src, n - 1)
    kw = jnp.minimum(key, n - 1)
    scores = _score_runs(metrics, udeg, wdeg, cnt_tot, wt_tots, valid,
                         maxf2, min_score)
    return scores, ku, kw


def tile_candidates_packed(
    slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg,
    t_start, t_end,
    *, metrics, cap: int, maxf2: int, min_score, w_bits: int, n: int,
    deg16: bool = False, key64: bool = False,
):
    """Packed-path tile scoring over the precomputed slot stream — ZERO gathers:
    every per-slot quantity (candidate w, source id, the degrees) is a
    dynamic-slice window read; everything rides the stable w-key sort as
    payloads; AA/RA weights are elementwise functions of deg(mid).

    Dead slots (self/first-order candidates) were dropped at plan time, so the
    stream carries bare source ids and no killer machinery runs here
    (``killers=False``); with ``deg16`` the degree pair is also pre-packed into
    ``slot_udeg`` (``slot_wdeg`` is a dummy).

    One expansion + one sort serves every metric in ``metrics`` (the reference
    runs its 9 metrics as separate full passes, `main.cxx:212-220`; here the
    second-hop scan is shared and only the final formula differs).
    Returns (scores [M, cap], ku [cap], kw [cap]).
    """
    i32 = jnp.int32
    iota = jax.lax.broadcasted_iota(i32, (cap,), 0)

    def window(a):
        return jax.lax.dynamic_slice(a, (t_start,), (cap,))

    src = window(slot_u)
    w = window(slot_w)
    udeg = window(slot_udeg)
    wdeg = udeg if deg16 else window(slot_wdeg)
    lanes = iota < (t_end - t_start)
    key = jnp.where(lanes, w, _pad_key(iota, w_bits))

    weighted = [m for m in metrics if m.needs_weight]
    wts = []
    if weighted:
        middeg = window(slot_middeg)
        wts = [jnp.where(lanes, m.weight_from_degree(middeg), jnp.float32(0.0))
               for m in weighted]
    return _keyed_sort_reduce(key, src, udeg, wdeg, wts, weighted, metrics,
                              w_bits=w_bits, n=n,
                              maxf2=maxf2, min_score=min_score, deg16=deg16,
                              killers=False, predpacked=deg16, key64=key64)


def tile_candidates(
    indices, degrees,
    fe_work, fe_adr, fe_usrc, fe_middeg,
    t_start, t_end,
    *, metrics, cap: int, maxf2: int, min_score,
    w_bits: int = 0, deg16: bool = False, upper_only: bool = True,
    key64: bool = False,
):
    """Edge-stream tile scoring: rebuild the slot mapping on device, then reduce.

    Memory-light path for expansions too large to materialize (IHub-scale).
    The plan precomputes per edge row the neighbor-window address
    ``fe_adr = offsets[mid] + skip`` (the w <= u head of mid's sorted row is
    pre-dropped), the source ``fe_usrc`` (killer rows bitwise-NOTed), and
    ``fe_middeg = deg(mid)`` — each becomes ONE eloc-gather here.
    When ``w_bits > 0`` (ids fit the w key, n <= 2^30) the reduction is the
    same stable w-key sort as the slot stream — source/degrees/AA-RA weights
    are gathered pre-sort and ride as payloads.  ``w_bits == 0`` falls back to
    the two-int32-key sentinel sort.
    Returns (scores [M, cap], ku, kw).
    """
    i32 = jnp.int32
    iota = jax.lax.broadcasted_iota(i32, (cap,), 0)
    n = degrees.shape[0]

    def window(a):
        # contiguous tile window as dynamic_slice — spelled a[t_start + iota]
        # it lowers to a full gather
        return jax.lax.dynamic_slice(a, (t_start,), (cap,))

    # --- edge window -------------------------------------------------------
    evalid = iota < (t_end - t_start)
    ework = jnp.where(evalid, window(fe_work), 0)
    eprefix = jnp.cumsum(ework) - ework         # exclusive slot prefix within tile
    total = eprefix[-1] + ework[-1]

    # --- slot -> edge mapping (scatter starts + cummax; no per-slot search) --
    pos = jnp.where(ework > 0, eprefix, cap)    # cap => dropped
    starts = jnp.zeros((cap,), i32).at[pos].max(iota, mode="drop")
    eloc = cummax(starts)                       # local edge index per slot

    # --- expansion (eloc-indexed reads gather within the sliced windows) ----
    svalid = iota < total
    # adr = fe_adr[row] + j with j = iota - eprefix[row]: fold the row prefix
    # into the base so one gather serves both
    base = window(fe_adr) - eprefix
    w = indices[base[eloc] + iota]
    raw = window(fe_usrc)[eloc]
    real = raw >= 0
    u = jnp.where(real, raw, ~raw)
    weighted = [m for m in metrics if m.needs_weight]

    def mid_weights(live):
        # One deg(mid) window-gather serves every weighted metric; the
        # elementwise weight formula is IDENTICAL to the packed path's (a
        # per-metric host float64 table would produce low-order-bit
        # differences between paths, flipping near-tied ranks).
        dmid_g = window(fe_middeg)[eloc]
        return [jnp.where(live, m.weight_from_degree(dmid_g),
                          jnp.float32(0.0))
                for m in weighted]

    if w_bits:
        # --- stable w-key reduction (shared with the slot stream) -----------
        # serving mode (upper_only=False) scores w != u; self-candidates go to
        # the pad range (upper_only prefilters w <= u at plan time already)
        dead = ~svalid if upper_only else (~svalid | (w == u))
        key = jnp.where(dead, _pad_key(iota, w_bits), w)
        upay = (u << 1) | real.astype(i32)
        udeg = degrees[jnp.clip(u, 0, n - 1)]
        wdeg = degrees[jnp.clip(w, 0, n - 1)]
        wts = mid_weights(svalid & real) if weighted else []
        return _keyed_sort_reduce(key, upay, udeg, wdeg, wts, weighted,
                                  metrics, w_bits=w_bits, n=n, maxf2=maxf2,
                                  min_score=min_score, deg16=deg16,
                                  key64=key64)

    # --- sentinel two-key fallback (vertex ids too wide for the packed key) --
    cand = svalid & ((w > u) if upper_only else (w != u))
    ku = jnp.where(cand, u, _SENTINEL)
    kw = jnp.where(cand, w, _SENTINEL)
    # killer slots contribute KILL so their run's count total goes negative
    cnt = jnp.where(cand, jnp.where(real, i32(1), i32(KILL)), i32(0))
    if weighted:
        wts = mid_weights(cnt > 0)
        ku, kw, cnt, *wts = jax.lax.sort((ku, kw, cnt, *wts), num_keys=2, is_stable=False)
        is_start, is_end = run_boundaries(ku, kw)
        tots = segment_run_totals(is_start, cnt, *wts)
        cnt_tot, wt_list = tots[0], tots[1:]
        wt_tots = {m.name: t for m, t in zip(weighted, wt_list)}
    else:
        ku, kw, cnt = jax.lax.sort((ku, kw, cnt), num_keys=2, is_stable=False)
        is_start, is_end = run_boundaries(ku, kw)
        cnt_tot = segment_run_totals(is_start, cnt)
        wt_tots = {}

    valid = is_end & (ku != _SENTINEL) & (cnt_tot > 0)
    ku = jnp.minimum(ku, n - 1)
    kw = jnp.minimum(kw, n - 1)
    du = degrees[ku]
    dw = degrees[kw]
    scores = _score_runs(metrics, du, dw, cnt_tot, wt_tots, valid,
                         maxf2, min_score)
    return scores, ku, kw


import os

_USE_COND = os.environ.get("LINKPRED_TILE_COND", "1") != "0"


def _desc_score_key(x):
    """uint32 key whose ASCENDING order is the float scores' DESCENDING order
    (the radix-sort float trick, flipped).  -inf sinks to the end, so invalid
    lanes never enter the top-k."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    asc = u ^ jnp.where(u >> 31 == 1, jnp.uint32(0xFFFFFFFF),
                        jnp.uint32(0x80000000))
    return ~asc


def _desc_key_score(key):
    """Inverse of :func:`_desc_score_key` (recovers the float scores from the
    sorted keys — cheaper than gathering the score array at the top-k lanes)."""
    asc = ~key
    u = jnp.where(asc >> 31 == 1, asc ^ jnp.uint32(0x80000000), ~asc)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


# Lane bound for one deferred-selection segment: raw (scores, u, v) tile output
# is buffered in HBM up to this many lanes (2^28 lanes = 3.2 GB at one metric)
# before a selection pass runs.  Plans whose t_pad * cap fits a single segment
# take the one-pass path; bigger scans (IHub-scale: hundreds of tiles) select
# hierarchically, so the raw buffer plus sort workspace stays bounded.
# ``None`` (the default when LINKPRED_SEG_LANES is unset) auto-sizes from the
# queried device memory (utils/device.py: ~20% of it); tests monkeypatch the
# module attribute with a concrete int.
SEG_LANES = (int(_os.environ["LINKPRED_SEG_LANES"])
             if _os.environ.get("LINKPRED_SEG_LANES") else None)


def _seg_lanes() -> int:
    if SEG_LANES is not None:
        return SEG_LANES
    from ..utils.device import auto_seg_lanes
    return auto_seg_lanes()


# Block bound for ONE selection sort.  _argselect_blocked sorts per
# SEL_BLOCK-lane block and recurses on the per-block winners instead of one
# flat sort of every lane; lane indices ride as sort payload through the
# levels, so nothing is gathered until the caller fetches the final top-k.
# The value is set from a sweep on the card (PERF.md).  Set
# LINKPRED_SEL_BLOCK=0 to restore the single flat sort (A/B + tests).
_SEL_BLOCK = int(_os.environ.get("LINKPRED_SEL_BLOCK", str(1 << 23)) or "0")


# Threshold-compaction selection (ops/compact.py): sample a key threshold,
# pack the ~k(1+eps) surviving lanes to 1/PACK_RATIO of the buffer,
# and sort ONLY those — with an in-jit lax.cond fallback to the full blocked
# sort whenever the sample undershot or survivors over-clustered (exactness
# is never at stake, only speed).  Engaged for large single-metric
# selections where k is a small fraction of the lanes; LINKPRED_SEL_PACK=0
# disables.
def _sel_pack_enabled() -> bool:
    return _os.environ.get("LINKPRED_SEL_PACK", "1") != "0"


def _sel_pack_min() -> int:
    """Smallest selection buffer that takes the pack path (below it the
    blocked sort is already at its small-sort floor and the threshold
    sample+pack overhead can't pay).  Env-overridable so CPU-scale tests can
    engage the packed path inside full engine runs (LINKPRED_SEL_PACK_MIN)."""
    return int(_os.environ.get("LINKPRED_SEL_PACK_MIN", str(1 << 22)))


def _argselect_packed(key, idx, kk: int):
    """Exact top-kk via threshold pack + small sort, cond-fallback to
    `_argselect_blocked`.  Returns (keys[:kk], idx[:kk]) — NOTE: already
    sliced to kk, unlike `_argselect_blocked`."""
    from ..ops.compact import PACK_CHUNK, PACK_RATIO, pack_survivors, \
        sample_threshold

    total = key.shape[0]
    pad = -total % PACK_CHUNK
    if pad:
        key = jnp.concatenate(
            [key, jnp.full((pad,), jnp.uint32(0xFFFFFFFF), key.dtype)])
    thr, _ = sample_threshold(key, kk)
    pk, pidx, cnt = pack_survivors(key, thr)
    w = PACK_CHUNK // PACK_RATIO
    ok = (jnp.sum(cnt) >= kk) & (jnp.max(cnt) <= w)
    if _os.environ.get("LINKPRED_SEL_PACK_DEBUG", "0") == "1":
        jax.debug.print(
            "sel_pack: kk={k} survivors={s} max_chunk={m} budget={w} ok={o}",
            k=kk, s=jnp.sum(cnt), m=jnp.max(cnt), w=w, o=ok)

    def packed_path():
        # blocked sorts over the packed buffer — a single flat sort of
        # total/RATIO lanes pays lax.sort's superlinear per-lane cost
        sk, si = _argselect_blocked(pk, pidx, kk)
        return sk[:kk], si[:kk]

    def fallback():
        sk, si = _argselect_blocked(key[:total], idx, kk)
        return sk[:kk], si[:kk]

    return jax.lax.cond(ok, packed_path, fallback)


def _argselect(key, idx, kk: int, allow_pack: bool = True):
    """Dispatch: threshold-pack selection where it pays (large buffer, k a
    small fraction), blocked sorts otherwise.  Returns (keys, idx) of
    length >= kk (callers slice [:kk]).

    ``allow_pack=False`` is set by SEGMENTED scans: per-segment packing pays
    the sample+pack overhead once per segment, and its pk/pidx buffers sit on
    top of the largest-memory regime."""
    total = key.shape[0]
    from ..ops.compact import PACK_CHUNK, PACK_RATIO
    if (allow_pack and _sel_pack_enabled() and total >= _sel_pack_min()
            and kk * 4 <= total // PACK_RATIO):
        return _argselect_packed(key, idx, kk)
    return _argselect_blocked(key, idx, kk)


def _argselect_blocked(key, idx, kk: int):
    """Top-``kk`` (ascending) of ``key``: per-block sorts + recursion on block
    winners.  Returns the fully sorted last level ``(keys, lane indices)`` —
    the caller slices ``[:kk]``.
    Exact: a global top-kk element is inside its block's top-min(kk, B)."""
    block = _SEL_BLOCK
    total = key.shape[0]
    pad_key = jnp.array(jnp.iinfo(key.dtype).max, key.dtype)

    while block and total > block \
            and -(-total // block) * min(kk, block) < total:
        nb = -(-total // block)
        kb = min(kk, block)
        pad = nb * block - total
        if pad:
            # pad keys sort after every real lane (dtype max >= the -inf
            # key); a pad lane can only surface when a block has fewer than
            # kb real lanes, and then it decodes to -inf — the TopK
            # contract's empty sentinel, same as a ghost-tile lane today
            key = jnp.concatenate([key, jnp.full((pad,), pad_key, key.dtype)])
            idx = jnp.concatenate([idx, jnp.zeros((pad,), idx.dtype)])

        def body(carry, kb_ib):
            sk, si = jax.lax.sort(kb_ib, num_keys=1, is_stable=False)
            return carry, (sk[:kb], si[:kb])

        _, (keys, idxs) = jax.lax.scan(
            body, 0, (key.reshape(nb, block), idx.reshape(nb, block)),
            unroll=int(_os.environ.get("LINKPRED_SEL_UNROLL", "1")))
        key, idx = keys.reshape(-1), idxs.reshape(-1)
        total = nb * kb

    return jax.lax.sort((key, idx), num_keys=1, is_stable=False)


def _select_topk(scores, us, vs, k: int, num_metrics: int,
                 allow_pack: bool = True) -> TopK:
    """One deferred-selection pass: descending blocked key sort per metric over
    the flattened lanes; returns [M, k].  ``allow_pack``: see `_argselect`
    (False inside segmented scans)."""
    i32 = jnp.int32
    total = scores.shape[0] * scores.shape[-1]
    us = us.reshape(total)
    vs = vs.reshape(total)
    kk = min(k, total)
    iota = jax.lax.broadcasted_iota(i32, (total,), 0)
    out_s, out_u, out_v = [], [], []
    for i in range(num_metrics):
        flat = scores[:, i, :].reshape(total)
        key = _desc_score_key(flat)
        # NOTE: selection stays (u32 key, i32 index) in BOTH engine modes.
        # Spread the invalid lanes' keys by lane index: most lanes are -inf
        # (non-run-end slots + ghost tiles) and a constant duplicate mass
        # can degrade a sort.
        # key(-inf) = 0xFF800000 strictly exceeds every finite score's key, so
        # OR-ing low bits keeps invalid lanes after all real candidates.  The
        # spread mask's low bit stays clear (0x7FFFFE, not 0x7FFFFF) so the
        # widest spread key is 0xFFFFFFFE — _argselect_blocked's pad sentinel
        # (uint32 max) stays RESERVED and provably sorts after every real lane.
        key = jnp.where(jnp.isneginf(flat),
                        key | (iota & jnp.int32(0x7FFFFE)).astype(jnp.uint32),
                        key)
        skey, idx = _argselect(key, iota, kk, allow_pack)
        top = idx[:kk]
        dec = _desc_key_score(skey[:kk])
        # spread invalid-lane keys decode to NaN (0xFF80xxxx); restore the
        # TopK contract's -inf empty-slot sentinel for downstream consumers
        out_s.append(jnp.where(jnp.isnan(dec), -jnp.inf, dec))
        out_u.append(us[top])
        out_v.append(vs[top])
    return TopK(jnp.stack(out_s), jnp.stack(out_u), jnp.stack(out_v))


def _merge_stacked(stacked: TopK, k: int) -> TopK:
    """Merge stacked [S, M, kk] winners into [M, k]: one selection per metric
    over the S*kk candidates.  Shared by the in-jit segmented merge, the
    chunked dispatcher, and the sharded chunked dispatcher."""
    num_metrics = stacked.scores.shape[1]
    out = [_select_topk(stacked.scores[:, i, :][:, None, :],
                        stacked.u[:, i, :], stacked.v[:, i, :], k, 1)
           for i in range(num_metrics)]
    return TopK(jnp.concatenate([t.scores for t in out]),
                jnp.concatenate([t.u for t in out]),
                jnp.concatenate([t.v for t in out]))


def scan_tiles(
    stream_fn, tile_start, tile_end, k: int,
    num_metrics: int, cap: int,
) -> TopK:
    """Run ``stream_fn(t_start, t_end) -> (scores [M, cap], u, v)``
    over all tiles under `lax.scan`, then select the global top-k.

    The per-thread heap + serial k-way merge of the reference
    (`predict.hxx:309-337,440-459`) becomes a DEFERRED selection: every tile
    streams its raw (scores, u, v) to HBM (bandwidth-trivial next to the tile
    sort), and ONE single-key sort per metric over all T*cap lanes picks the
    winners, instead of an in-scan sort-merged carry (a 3-operand float merge
    of cap+k per tile); the deferred selection is 2-operand (uint32 score key
    + lane index) and runs once.  Empty tiles (schedule padding) skip compute via `lax.cond`
    (set LINKPRED_TILE_COND=0 to disable, for profiling cond effects).

    Scans whose raw output exceeds ``SEG_LANES`` lanes (IHub-scale tile
    counts) buffer and select per SEGMENT of tiles under an outer `lax.scan`,
    then merge the per-segment winners — bounding device memory regardless
    of total slot count.  Exact: any global top-k candidate is inside its
    segment's top-k.
    """
    i32 = jnp.int32
    t_pad = tile_start.shape[0]
    # The raw buffer costs (4*M + 8) bytes/lane (scores per metric + u + v);
    # the segment bound is calibrated for ONE metric (12 B/lane), so scale
    # the lane bound down for multi-metric passes — a fused 9-metric scan at
    # the single-metric bound would buffer ~3.7x the budget and OOM exactly
    # the way the pre-segmentation engine did.
    seg_lanes = max(cap, _seg_lanes() * 12 // (4 * num_metrics + 8))
    seg = max(1, seg_lanes // cap)

    def empty(*_):
        return (jnp.full((num_metrics, cap), -jnp.inf, jnp.float32),
                jnp.zeros((cap,), i32), jnp.zeros((cap,), i32))

    def body(carry, ts):
        t_start, t_end = ts
        if _USE_COND:
            out = jax.lax.cond(t_start < t_end,
                               lambda: stream_fn(t_start, t_end),
                               empty)
        else:
            out = stream_fn(t_start, t_end)
        return carry, out

    # unroll=2 exposes consecutive tile bodies to XLA together, so one
    # tile's window reads can overlap the previous tile's sort.
    unroll = int(_os.environ.get("LINKPRED_SCAN_UNROLL", "2"))

    if t_pad <= seg:
        _, (scores, us, vs) = jax.lax.scan(
            body, 0, (tile_start, tile_end), unroll=unroll)
        return _select_topk(scores, us, vs, k, num_metrics)

    # --- hierarchical: segments of `seg` tiles, selection per segment --------
    n_seg = -(-t_pad // seg)
    # Balance the segments: 68 tiles split as 2x34, not 64+4 — a segment's
    # selection sorts its FULL seg*cap lane buffer whether or not the tiles
    # are real, so an unbalanced trailing segment pays a whole SEG_LANES-sized
    # sort for mostly ghost lanes.
    seg = -(-t_pad // n_seg)
    pad = n_seg * seg - t_pad
    # padding tiles have start == end == 0 -> cond skips them
    ts = jnp.concatenate([tile_start, jnp.zeros((pad,), i32)]).reshape(n_seg, seg)
    te = jnp.concatenate([tile_end, jnp.zeros((pad,), i32)]).reshape(n_seg, seg)
    kk = min(k, seg * cap)

    # Segmented scans default to pack-off (see `_argselect`).
    # LINKPRED_SEL_PACK_SEG=1 opts segments in
    # (A/B: pair with a smaller LINKPRED_SEG_LANES so the per-segment raw
    # buffer shrinks by more than the pack buffers add).
    seg_pack = _os.environ.get("LINKPRED_SEL_PACK_SEG", "0") == "1"

    def seg_body(carry, bounds):
        s_ts, s_te = bounds
        _, (scores, us, vs) = jax.lax.scan(body, 0, (s_ts, s_te),
                                           unroll=unroll)
        return carry, _select_topk(scores, us, vs, kk, num_metrics,
                                   allow_pack=seg_pack)

    _, tops = jax.lax.scan(seg_body, 0, (ts, te))  # [S, M, kk] per leaf
    return _merge_stacked(tops, k)


def _make_stream_fn(indices, degrees, stream,
                    metrics, cap, maxf2, min_score, w_bits, packed,
                    deg16=False, upper_only=True, key64=False):
    if packed:
        slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg = stream
        n = degrees.shape[0]

        def stream_fn(t_start, t_end):
            return tile_candidates_packed(
                slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg,
                t_start, t_end,
                metrics=metrics, cap=cap, maxf2=maxf2, min_score=min_score,
                w_bits=w_bits, n=n, deg16=deg16, key64=key64,
            )
    else:
        fe_work, fe_adr, fe_usrc, fe_middeg = stream

        def stream_fn(t_start, t_end):
            return tile_candidates(
                indices, degrees,
                fe_work, fe_adr, fe_usrc, fe_middeg,
                t_start, t_end,
                metrics=metrics, cap=cap, maxf2=maxf2, min_score=min_score,
                w_bits=w_bits, deg16=deg16, upper_only=upper_only,
                key64=key64,
            )
    return stream_fn


@partial(
    jax.jit,
    static_argnames=("metric_names", "cap", "k", "maxf2", "w_bits", "packed",
                     "deg16", "upper_only", "key64"),
)
def _score_tiles_jit(
    indices, degrees,
    stream,
    tile_start,
    min_score,
    *, metric_names, cap: int, k: int, maxf2: int = 0, w_bits: int = 0,
    packed: bool = False, deg16: bool = False, upper_only: bool = True,
    key64: bool = False,
) -> TopK:
    metrics = tuple(METRICS[name] for name in metric_names)
    stream_fn = _make_stream_fn(indices, degrees, stream,
                                metrics, cap, maxf2, min_score, w_bits, packed,
                                deg16, upper_only, key64)
    return scan_tiles(
        stream_fn, tile_start[:-1], tile_start[1:], k, len(metrics), cap)


def score_tiles(
    indices, degrees,
    stream,
    tile_start,
    min_score,
    *, metric_names, cap: int, k: int, maxf2: int = 0, w_bits: int = 0,
    packed: bool = False, deg16: bool = False, upper_only: bool = True,
    key64: bool = False,
) -> TopK:
    """Score all tiles for every metric in ``metric_names`` (tuple of names) in
    one shared expansion+sort pass; returns a [M, k] TopK.

    ``stream`` is the packed slot arrays when ``packed`` else
    ``(fe_work, fe_adr, fe_usrc, fe_middeg)``.  ``tile_start``
    indexes slots (packed) or edges (fallback).  AA/RA weights are elementwise
    functions of deg(mid) on both paths (identical formula => identical
    low-order bits)."""
    return _score_tiles_jit(
        indices, degrees, stream, tile_start, min_score,
        metric_names=metric_names, cap=cap, k=k, maxf2=maxf2, w_bits=w_bits,
        packed=packed, deg16=deg16, upper_only=upper_only, key64=key64)


# jit-cache management passthrough (tests shrink SEG_LANES and need to drop
# the traced variants)
score_tiles.clear_cache = _score_tiles_jit.clear_cache


# Max tiles per device dispatch (edge stream / packed slot stream).  A plan
# with more tiles runs as several programs whose winners merge on device;
# whether chunking pays on the GPU is open (ROADMAP D2).
CHUNK_TILES = 32
CHUNK_TILES_PACKED = 2048


_merge_topk_stacked = jax.jit(_merge_stacked, static_argnames=("k",))


def score_tiles_chunked(
    indices, degrees, stream, tile_start, min_score,
    *, metric_names, cap: int, k: int, maxf2: int = 0, w_bits: int = 0,
    packed: bool = False, deg16: bool = False, upper_only: bool = True,
    key64: Optional[bool] = None, chunk: int = CHUNK_TILES,
) -> TopK:
    """`score_tiles` dispatched ``chunk`` tiles at a time (see
    ``CHUNK_TILES``).  Exact: every chunk keeps its top-k and one final
    device-side selection merges them.  All chunks share one jit variant (the
    last is padded with empty tiles)."""
    if key64 is None:
        key64 = default_key64()
    t_pad = int(tile_start.shape[0]) - 1
    kwargs = dict(metric_names=metric_names, cap=cap, k=k, maxf2=maxf2,
                  w_bits=w_bits, packed=packed, deg16=deg16,
                  upper_only=upper_only, key64=key64)
    if t_pad <= chunk:
        return score_tiles(indices, degrees, stream,
                           tile_start, min_score, **kwargs)
    tops = []
    for c in range(0, t_pad, chunk):
        ts = tile_start[c: c + chunk + 1]
        if int(ts.shape[0]) < chunk + 1:  # pad: start == end => empty tiles
            pad = chunk + 1 - int(ts.shape[0])
            ts = jnp.concatenate([ts, jnp.broadcast_to(ts[-1:], (pad,))])
        tops.append(score_tiles(indices, degrees, stream, ts,
                                min_score, **kwargs))
    stacked = TopK(jnp.stack([t.scores for t in tops]),
                   jnp.stack([t.u for t in tops]),
                   jnp.stack([t.v for t in tops]))
    return _merge_topk_stacked(stacked, k)


def score_huge_sources_host_multi(
    g: CSRGraph, huge_src: np.ndarray, metrics,
    min_degree1: int, maxf2: int, min_score: float,
    k: Optional[int] = None, upper_only: bool = True,
):
    """Exact scoring for hub sources whose expansion exceeds one tile — ALL
    metrics in one expansion pass per source.

    Dense per-source accumulation via vectorized bincount — the direct analog of the
    reference's dense ``veout`` scratch (`predict.hxx:117-123`), used only for the
    rare sources where sort-based tiles would fragment (host NumPy for now; these
    sources are off the benchmark path by construction of ``cap``).  The
    candidate expansion and count bincount are computed ONCE and shared by
    every metric (the engine's fused-pass contract); each weighted metric
    adds one weighted bincount.
    Returns ``{metric_name: (scores f32[*], u i32[*], w i32[*])}``.
    """
    g = g.host()
    deg = np.asarray(g.degrees, dtype=np.int64)
    offsets = np.asarray(g.offsets, dtype=np.int64)
    indices = np.asarray(g.indices, dtype=np.int64)
    out = {m.name: ([], [], []) for m in metrics}
    for u in np.asarray(huge_src, dtype=np.int64):
        nbrs = indices[offsets[u]: offsets[u] + deg[u]]
        mids = nbrs[(deg[nbrs] > 0) & ((deg[nbrs] <= min_degree1) if min_degree1 else True)]
        if mids.size == 0:
            continue
        dm = deg[mids]
        # expansion: all neighbors of all mids (repeat+cumsum trick)
        base = np.repeat(offsets[mids], dm)
        step = np.arange(base.shape[0], dtype=np.int64) - np.repeat(
            np.cumsum(dm) - dm, dm)
        cand = indices[base + step]
        sel = (cand > u) if upper_only else (cand != u)
        cand = cand[sel]
        cnt = np.bincount(cand, minlength=g.n).astype(np.int64)
        accs = {}
        for m in metrics:
            if not m.needs_weight:
                continue
            # single source of truth: MetricSpec.weight_from_degree (float64)
            wts = np.repeat(m.weight_from_degree(dm, xp=np), dm)[sel]
            accs[m.name] = np.bincount(cand, weights=wts, minlength=g.n)
        # drop self + first-order neighbors (predict.hxx:306-307)
        cnt[nbrs] = 0
        cnt[u] = 0
        ws_all = np.nonzero(cnt > 0)[0]
        if ws_all.size == 0:
            continue
        du, dws_all = float(deg[u]), deg[ws_all].astype(np.float64)
        nuv_all = cnt[ws_all].astype(np.float64)
        for m in metrics:
            name, ws = m.name, ws_all
            # single source of truth: MetricSpec.score (float64 host path)
            acc = accs[name][ws] if m.needs_weight else nuv_all
            s = m.score(nuv_all, acc, du, dws_all, xp=np).astype(np.float32)
            keep = s > min_score
            if maxf2:
                keep &= maxf2_mask(du, dws_all, maxf2)
            ws, s = ws[keep], s[keep]
            if k is not None and s.shape[0] > k:
                top = np.argpartition(-s, k - 1)[:k]
                ws, s = ws[top], s[top]
            o = out[name]
            o[0].append(s)
            o[1].append(np.full(ws.shape[0], u, dtype=np.int32))
            o[2].append(ws.astype(np.int32))

    def cat(lists):
        if not lists[0]:
            z = np.empty(0, dtype=np.float32)
            zi = np.empty(0, dtype=np.int32)
            return z, zi, zi
        return tuple(np.concatenate(x) for x in lists)

    return {name: cat(lists) for name, lists in out.items()}


def score_huge_sources_host(
    g: CSRGraph, huge_src: np.ndarray, metric: MetricSpec,
    min_degree1: int, maxf2: int, min_score: float,
    k: Optional[int] = None, upper_only: bool = True,
):
    """Single-metric wrapper around :func:`score_huge_sources_host_multi`
    (the test-oracle entry point).  Returns (scores, u, w)."""
    return score_huge_sources_host_multi(
        g, huge_src, (metric,), min_degree1, maxf2, min_score,
        k=k, upper_only=upper_only)[metric.name]
