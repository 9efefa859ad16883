"""Work-balanced tiling plan for the second-hop expansion.

The reference load-balances its irregular per-vertex work with
``schedule(dynamic, 2048)`` (`/root/reference/inc/predict.hxx:287`).  XLA needs static
shapes, so we *precompute* a balanced schedule on the host:

1. Build the filtered first-hop edge list: directed edges (u → mid) whose intermediate
   passes the LHub hub mask ``deg(mid) <= min_degree1`` (`predict.hxx:301`) and has
   work to do (``deg(mid) > 0``).  Each such edge expands into ``deg(mid)`` candidate
   slots — the innermost loop of `predict.hxx:154-179`.
2. Handle the reference's "zero out self + 1-hop" pass (`predict.hxx:306-307`):
   the packed path DROPS dead slots outright (candidates w ∈ N(u) ∪ {u} can
   never score; one vectorized membership searchsorted finds them, and with
   them gone no killers are needed); the edge-stream path appends one *killer
   pseudo edge* (u → u) per active source whose slots enumerate N(u) and sort
   ahead of real slots inside their (w, u) run, so any run led by a killer is
   dead.
3. Partition sources into tiles of total slot count <= ``cap``, aligned to source
   boundaries so every (u, w) pair reduces inside exactly one tile (exact counts —
   the analog of per-thread-private scratch).
4. Sources whose slot count alone exceeds ``cap`` ("huge" hubs) run on device
   through a hub-sized sub-plan (``huge_plan``; the dense host scorer
   `scoring.score_huge_sources_host` survives as a test oracle).

**Two device-side execution formats** (static choice per plan):

* **Packed slot stream** (``packed=True``, the fast path): the full expansion is
  precomputed on the host as per-slot arrays — the candidate vertex ``slot_w``
  (the ONLY sort key), the source payload ``slot_u`` (``src << 1 | real_flag``),
  and the degree triplet (``slot_udeg``/``slot_wdeg``/``slot_middeg``) that the
  scoring formulas need.  The device does dynamic-slice window reads, one
  STABLE single-key sort of w with u/degrees as payloads, and one max-scan —
  stability keeps each (w, u) group contiguous (dead slots were dropped at plan
  time), so no source-span bound exists and tiles fill to ``cap`` at any
  n <= 2^30.  ZERO full-table gathers.  AA/RA weights are computed
  elementwise from
  ``slot_middeg``.  Used when the slot count fits ``slot_budget``.
* **Edge stream** (``packed=False``): per-edge-row arrays only — ``fe_work``
  (slots per row), ``fe_adr`` (= offsets[mid] + skip, the row's first expanded
  neighbor address), ``fe_usrc`` (source; killer rows bitwise-NOTed) and
  ``fe_middeg``; the device reconstructs the slot->row mapping with cumsum +
  scatter + max-scan (one eloc-gather per array) and reduces via the same
  stable w-key sort (two-key sentinel sort when ids exceed the key width).
  Memory-light — used for IHub-scale expansions (slot counts beyond
  ``slot_budget``, e.g. min_degree1=0 on web graphs) and very wide vertex-ID ranges.

The plan depends on (graph, min_degree1, cap) only; planning is vectorized NumPy and
sits outside the timed scoring path (like the reference's hashtable allocation,
`predict.hxx:414-424`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..graph import CSRGraph
from ..utils.numeric import next_pow2 as _next_pow2

__all__ = ["TilePlan", "build_plan", "KILL"]

# Count contribution of a killer slot in the edge-stream path; any run containing
# one goes negative. Real contributions per run are bounded by max degree < 2**30.
KILL = -(1 << 30)

# Ceiling on precomputed slots (packed path; ~12 device bytes per slot for
# the three int32 arrays).  Beyond this, fall back to the edge stream.
# ``None`` (the default when LINKPRED_SLOT_BUDGET is unset) auto-sizes from
# the queried device memory (utils/device.py: ~55% of it / 12 B).  Tests
# monkeypatch a concrete int.
SLOT_BUDGET = (int(os.environ["LINKPRED_SLOT_BUDGET"])
               if os.environ.get("LINKPRED_SLOT_BUDGET") else None)


def _slot_budget() -> int:
    if SLOT_BUDGET is not None:
        return SLOT_BUDGET
    from ..utils.device import auto_slot_budget
    return auto_slot_budget()


# A huge-hub sub-plan puts one source's whole expansion in ONE tile; beyond
# this many slots the deferred selection cannot bound its raw buffer (a single
# tile is not segmentable) and a multi-metric pass would OOM the device, so
# bigger hubs fall back to the exact host scorer (score_huge_sources_host).
# ``None`` auto-sizes to HALF one selection segment; tests monkeypatch a
# concrete int.
HUGE_DEVICE_MAX = None


def _huge_device_max() -> int:
    if HUGE_DEVICE_MAX is not None:
        return HUGE_DEVICE_MAX
    from ..utils.device import auto_seg_lanes
    return auto_seg_lanes() // 2

# Adaptive cap (cap=None): target tile count and cap bounds.  Swept on the
# H100 at R-MAT 21 (PERF.md): single-metric scoring gains from larger caps,
# but above 2^21 the nine-metric pass's raw buffer crosses the selection
# segment bound (`scoring.scan_tiles`) and loses more than that, so the
# ceiling stays until cap and segment bound are tuned together per cell.
# The floor keeps toy graphs off large sorts and was not re-derived.
AUTO_CAP_TILES = 32
AUTO_CAP_MIN = 1 << 16
AUTO_CAP_MAX = 1 << 21




def _native_expand(g, src, mid, skip, est: int, deg16: bool):
    """Fused C++ slot expansion + dead-slot removal (`native/src/
    plan_native.cpp`); returns ``(kept, sw, su, sudeg, swdeg, smid, cnt_u)``
    or None when the native library is unavailable (or disabled with
    LINKPRED_NATIVE_PLAN=0), in which case the NumPy pipeline runs."""
    import os

    if os.environ.get("LINKPRED_NATIVE_PLAN", "1") == "0":
        return None
    try:
        from ..io.native import native_lib
    except Exception:
        return None
    lib = native_lib()
    if lib is None:
        return None
    n = g.n
    offs = np.ascontiguousarray(np.asarray(g.offsets, dtype=np.int32))
    inds = np.ascontiguousarray(np.asarray(g.indices, dtype=np.int32))
    rsrc = np.ascontiguousarray(src.astype(np.int32))
    rmid = np.ascontiguousarray(mid.astype(np.int32))
    rskip = np.ascontiguousarray(skip.astype(np.int32))
    sw = np.empty(est, dtype=np.int32)
    su = np.empty(est, dtype=np.int32)
    sudeg = np.empty(est, dtype=np.int32)
    swdeg = np.empty(1 if deg16 else est, dtype=np.int32)
    smid = np.empty(est, dtype=np.int32)
    cnt_u = np.empty(n, dtype=np.int64)
    kept = int(lib.lp_plan_expand(
        offs, inds, n, rsrc, rmid, rskip, rsrc.shape[0],
        1, 1 if deg16 else 0, est, sw, su, sudeg, swdeg, smid, cnt_u))
    if kept < 0:  # cannot happen (est is an upper bound); defensive fallback
        return None
    return (kept, sw[:kept], su[:kept], sudeg[:kept],
            None if deg16 else swdeg[:kept], smid[:kept], cnt_u)


def _native_firsthop(g, min_degree1: int, upper_only: bool):
    """C++ first-hop stage (`lp_plan_firsthop`): the filtered (src, mid, skip)
    edge rows plus the killer (kuniq, kskip) list in one CSR walk — one
    binary search per edge replaces the NumPy pipeline's O(m) int64
    global-edge-key temp + searchsorted.  Returns None when the native
    library is unavailable (or LINKPRED_NATIVE_PLAN=0); full-graph mode only
    (the ``sources``/``_keep_src`` subset filters stay NumPy)."""
    import os

    if os.environ.get("LINKPRED_NATIVE_PLAN", "1") == "0":
        return None
    try:
        from ..io.native import native_lib
    except Exception:
        return None
    lib = native_lib()
    if lib is None:
        return None
    import ctypes

    n, m = g.n, g.m
    offs = np.ascontiguousarray(np.asarray(g.offsets, dtype=np.int32))
    inds = np.ascontiguousarray(np.asarray(g.indices, dtype=np.int32))
    src = np.empty(max(m, 1), dtype=np.int32)
    mid = np.empty(max(m, 1), dtype=np.int32)
    skip = np.empty(max(m, 1), dtype=np.int32)
    kuniq = np.empty(max(n, 1), dtype=np.int32)
    kskip = np.empty(max(n, 1), dtype=np.int32)
    ku = ctypes.c_int64(0)
    m1 = int(lib.lp_plan_firsthop(offs, inds, n, int(min_degree1),
                                  1 if upper_only else 0, src, mid, skip,
                                  kuniq, kskip, ctypes.byref(ku)))
    k = int(ku.value)
    # int64 views keep every downstream consumer (bincounts, address math,
    # the NumPy expansion fallback's n*src keys) identical to the NumPy path
    return (src[:m1].astype(np.int64), mid[:m1].astype(np.int64),
            skip[:m1].astype(np.int64), kuniq[:k].astype(np.int64),
            kskip[:k].astype(np.int64))


def _pad_bucket(x: int) -> int:
    """Array-length padding bucket: the smallest value >= x of the form
    m * 2^e with 8 <= m <= 16 (a 4-bit mantissa).  Replaces `_next_pow2` for
    the big stream arrays: pow2 padding cost up to 2x memory right above a
    power boundary, while the bucket pads at most ~11% and still bounds jit
    shape variants to four per octave (the padding exists only for shape-bucketing across experiment
    batches)."""
    x = max(int(x), 8)
    e = max(x.bit_length() - 4, 0)
    return -(-x // (1 << e)) << e


def _pad_tiles(t: int) -> int:
    """Tile-count padding: multiple of 4 (not pow2 — the deferred selection
    sorts t_pad * cap lanes, and pow2 padding wasted up to ~30% of it; a
    4-granular count still bounds jit variants across experiment batches)."""
    return max(4, (t + 3) & ~3)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    # Edge stream (1-element dummies for packed plans, which never read it).
    # Per-row precomputes fold the device rebuild to ONE eloc-gather each:
    fe_work: np.ndarray   # int32[M1_pad] = #neighbors of mid expanded; 0 in padding
    fe_adr: np.ndarray    # int32[M1_pad] = offsets[mid] + skip: address of the
    #                        first expanded neighbor (the w <= u head of mid's
    #                        sorted row is pre-dropped, predict.hxx:221 ft)
    fe_usrc: np.ndarray   # int32[M1_pad] source vertex; KILLER rows store
    #                        ~src (bitwise NOT < 0 marks them at any n <= 2^31)
    fe_middeg: np.ndarray  # int32[M1_pad] deg(mid) (AA/RA weight input)
    tile_edge_start: np.ndarray  # int32[T_pad + 1]; tile t covers edges [t, t+1)
    cap: int              # static slot budget per tile
    num_tiles: int        # true tile count (<= T_pad)
    huge_src: np.ndarray  # int64[H] sources routed to the dense fallback
    total_slots: int      # expansion slots across tiles (incl. killer slots)
    huge_slots: int       # expansion slots routed to the huge-source path
    w_bits: int           # bit width of candidate ids (pads live at 2^w_bits+)
    upper_only: bool      # True => score pairs w > u only (full-graph mode)
    deg16: bool           # True => every pair degree in THIS stream < 2^16
    #                        (degree pair packs to one i32; globally-oversized
    #                        pairs ride ``side_plan``)
    keyed: bool           # True => candidate ids fit the w key (n <= 2^30)
    packed: bool          # True => slot stream precomputed (fast path)
    huge_plan: Optional["TilePlan"] = None  # device sub-plan for hub sources
    #                        whose expansion exceeds one ``cap`` tile
    side_plan: Optional["TilePlan"] = None  # degree-regime side stream: slots
    #                        whose pair degrees exceed 16 bits ride a small
    #                        4-operand plan so the main stream keeps the
    #                        packed-pair 3-operand sort (scored as an extra
    #                        pass, merged like the hub sub-plan)
    # Mega-hubs whose expansion exceeds HUGE_DEVICE_MAX slots (one tile would
    # blow the deferred selection's HBM bound): scored by the exact host
    # fallback instead (api.py wires score_huge_sources_host).
    host_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    # Packed slot stream (None unless packed).  Everything the device pipeline
    # needs is precomputed per slot, so tiles run with ZERO full-table gathers
    # (tile windows are dynamic-slice reads):
    slot_w: Optional[np.ndarray] = None      # int32[S_pad] candidate w (the key)
    slot_u: Optional[np.ndarray] = None      # int32[S_pad] bare source id (dead
    #                        slots are dropped at plan time -> no flag bit)
    slot_udeg: Optional[np.ndarray] = None   # int32[S_pad] deg(u); when deg16,
    #                        the packed pair (deg(u) << 16 | deg(w))
    slot_wdeg: Optional[np.ndarray] = None   # int32[S_pad] deg(w); 1-elem dummy
    #                        when deg16 (pair pre-packed into slot_udeg)
    slot_middeg: Optional[np.ndarray] = None  # int32[S_pad] deg(mid) (AA/RA wts)
    tile_slot_start: Optional[np.ndarray] = None  # int32[T_pad + 1]
    # Memoized device copies (mutable contents of a frozen dataclass — not part
    # of equality/pytree; streams are hundreds of MB, so re-uploading per call
    # through the host link costs seconds).
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def num_tiles_padded(self) -> int:
        return int(self.tile_edge_start.shape[0]) - 1

    @property
    def tile_start(self) -> np.ndarray:
        """Per-tile stream offsets for the active path."""
        return self.tile_slot_start if self.packed else self.tile_edge_start

    def device_stream(self):
        """(stream tuple, tile_start) as device arrays, uploaded once per
        plan and reused across metrics/calls."""
        d = self._device
        if "stream" not in d:
            import jax.numpy as jnp

            if self.packed:
                d["stream"] = (jnp.asarray(self.slot_w),
                               jnp.asarray(self.slot_u),
                               jnp.asarray(self.slot_udeg),
                               jnp.asarray(self.slot_wdeg),
                               jnp.asarray(self.slot_middeg))
            else:
                d["stream"] = (jnp.asarray(self.fe_work),
                               jnp.asarray(self.fe_adr),
                               jnp.asarray(self.fe_usrc),
                               jnp.asarray(self.fe_middeg))
            d["tile_start"] = jnp.asarray(self.tile_start)
        return d["stream"], d["tile_start"]


def build_plan(g: CSRGraph, min_degree1: int, cap: Optional[int] = None,
               pad_tiles_pow2: bool = True,
               slot_budget: Optional[int] = None,
               sources: Optional[np.ndarray] = None,
               _keep_src: Optional[np.ndarray] = None,
               _allow_huge: bool = True) -> TilePlan:
    """``sources``: optional vertex subset — restrict prediction to pairs whose
    source is in the subset (serving mode: "top links for these vertices").
    Restricted plans score DIRECTED candidates (s, w) for every second-order w,
    not just w > s (``upper_only=False``).

    ``cap=None`` picks the tile capacity adaptively: the next power of two that
    yields ~``AUTO_CAP_TILES`` tiles, clamped to [``AUTO_CAP_MIN``,
    ``AUTO_CAP_MAX``] (see the module constants).  Pass an explicit cap to pin jit
    variants across runs (the harness does, for sweep-wide shape stability).

    ``_keep_src``/``_allow_huge`` are internal: the huge-hub sub-plan restricts
    to the hub sources WITHOUT flipping to directed-candidate semantics.

    ``slot_budget=None`` auto-sizes from device HBM (``0`` forces the edge
    stream; an explicit int pins the ceiling — see ``SLOT_BUDGET``)."""
    if slot_budget is None:
        slot_budget = _slot_budget()
    g = g.host()
    n = g.n
    deg = np.asarray(g.degrees, dtype=np.int64)
    offsets64 = np.asarray(g.offsets, dtype=np.int64)
    indices = np.asarray(g.indices, dtype=np.int64)

    upper_only = sources is None
    _gk = [None]

    def gkeys():
        # Globally-sorted (src*n + dst) edge keys: the closed-form w>u skip
        # and the NumPy fallback's dead-slot test binary-search this.  Built
        # lazily and memoized — native-first-hop plans and serving-mode plans
        # with the native expansion never need it, and it costs ~16 bytes/edge
        # of transient (the np.repeat temp) plus 8 retained at IHub scale.
        if _gk[0] is None:
            _gk[0] = (np.repeat(np.arange(n, dtype=np.int64), deg) * n
                      + indices[: g.m])
        return _gk[0]

    # Stage 1 — the filtered first-hop edge list (LHub mask + w > u candidate
    # prefilter, predict.hxx:221,227,301) and the killer pseudo-edge list (one
    # per active source, expanding over N(u) itself; their counts enter the
    # per-source totals that drive cap selection and huge routing in BOTH
    # paths, but the rows are materialized only for the edge stream — the
    # packed path drops dead slots at plan time and needs no killers).
    # Adjacency rows are sorted, so the prefilter survivors are a contiguous
    # TAIL of each mid's row — this halves the slot stream for symmetric
    # graphs.  The native C++ walk (lp_plan_firsthop) does one binary search
    # per edge; the vectorized NumPy pipeline below is the fallback and
    # semantic oracle (and handles the sources/_keep_src subset modes).
    fh = (_native_firsthop(g, min_degree1, upper_only)
          if sources is None and _keep_src is None else None)
    if fh is not None:
        src, mid, skip, kuniq, kskip = fh
    else:
        src = np.repeat(np.arange(n, dtype=np.int64), deg)
        mid = indices[: g.m]
        dmid = deg[mid]
        # LHub mask (predict.hxx:227,301); min_degree1 == 0 means IHub.
        keep = dmid > 0
        if min_degree1:
            keep &= dmid <= min_degree1
        if sources is not None:
            keep &= np.isin(src, np.asarray(sources, dtype=np.int64))
        if _keep_src is not None:
            keep &= np.isin(src, np.asarray(_keep_src, dtype=np.int64))
        src, mid = src[keep], mid[keep]

        if upper_only and src.size:
            skip = np.searchsorted(gkeys(), mid * n + src, side="right") \
                - offsets64[mid]
            nz = deg[mid] - skip > 0
            src, mid, skip = src[nz], mid[nz], skip[nz]
        else:
            skip = np.zeros(src.shape[0], dtype=np.int64)

        uniq = np.unique(src)
        if upper_only and uniq.size:
            kskip = np.searchsorted(gkeys(), uniq * n + uniq, side="right") \
                - offsets64[uniq]
            knz = deg[uniq] - kskip > 0
            kuniq, kskip = uniq[knz], kskip[knz]
        else:
            kuniq = uniq
            kskip = np.zeros(uniq.shape[0], dtype=np.int64)
    kwork = deg[kuniq] - kskip
    work = deg[mid] - skip      # real rows, already (src, mid)-sorted

    if cap is None:
        # Adaptive: ~AUTO_CAP_TILES full tiles over the (pre-dead-slot-removal)
        # expansion estimate; small graphs land on small caps so tiny inputs
        # never pay a 2^22-lane sort.
        est = int(work.sum() + kwork.sum())
        cap = int(min(max(_next_pow2(-(-est // AUTO_CAP_TILES)),
                          AUTO_CAP_MIN), AUTO_CAP_MAX))

    # Per-source slot counts; sources too big for one tile go to the dense path.
    w_u = (np.bincount(src, weights=work.astype(np.float64), minlength=n)
           + np.bincount(kuniq, weights=kwork.astype(np.float64),
                         minlength=n)).astype(np.int64)
    huge_src = np.nonzero(w_u > cap)[0]
    huge_slots = int(w_u[huge_src].sum())
    huge_plan = None
    host_src = np.empty(0, dtype=np.int64)
    dev_huge_slots = 0   # device-routed hub expansion (materializes its own
    #                      packed stream BESIDE the main one — counted in the
    #                      main stream's budget check below)
    if huge_src.size:
        not_huge = ~np.isin(src, huge_src)
        src, mid, work, skip = (src[not_huge], mid[not_huge],
                                work[not_huge], skip[not_huge])
        not_huge_k = ~np.isin(kuniq, huge_src)
        kuniq, kskip, kwork = (kuniq[not_huge_k], kskip[not_huge_k],
                               kwork[not_huge_k])
        huge_sizes = w_u[huge_src]
        w_u = w_u.copy()
        w_u[huge_src] = 0
        if _allow_huge:
            # Device-side huge-hub path: the same tile machinery with a cap
            # large enough to hold the biggest hub's expansion in one tile —
            # the reference keeps every source in its parallel loop
            # (predict.hxx:287-288); here the hubs get their own jit variant.
            # pad_tiles_pow2=False: hub sub-plans have 1-2 giant-cap tiles and
            # are per-graph one-offs — padding to 4 tiles would make the
            # deferred selection sort up to 3 ghost tiles of cap lanes each.
            # Mega-hubs past HUGE_DEVICE_MAX (one unsegmentable tile would
            # blow the deferred selection's HBM bound) go to host_src instead.
            on_device = huge_sizes <= _huge_device_max()
            dev_huge = huge_src[on_device]
            host_src = huge_src[~on_device]
            dev_huge_slots = int(huge_sizes[on_device].sum())
            if dev_huge.size:
                huge_plan = build_plan(
                    g, min_degree1, cap=_next_pow2(int(huge_sizes[on_device].max())),
                    pad_tiles_pow2=False, slot_budget=slot_budget,
                    sources=sources, _keep_src=dev_huge, _allow_huge=False)

    m1 = src.shape[0] + kuniq.shape[0]
    total_slots = int(work.sum() + kwork.sum())

    deg16 = bool(deg.max(initial=0) < (1 << 16))
    # Stable w-key sort layout (scoring.py): the key is the candidate vertex w
    # ALONE (ids need bit_length(n-1) bits; one extra value range above 2^w_bits
    # marks pad/dead lanes), u rides as a payload, and sort stability plus the
    # killers-first stream order keeps each (w, u) group contiguous with its
    # killer at the head.  No source-span bound exists, so tiles fill to cap
    # and any n < 2^30 works.
    w_bits = max(int(max(n - 1, 1)).bit_length(), 1)
    keyed = w_bits + 1 <= 31             # one spare value range for pads
    # Slot-stream materializability: the budget must bound the TOTAL slots
    # resident at once — the main stream at its PADDED size (<= 9/8 of the
    # kept count, see _pad_bucket) PLUS the device-routed hub sub-plan's
    # stream, which materializes beside it.  Counting only the raw main
    # count let an IHub plan ride the packed path into a device OOM.
    packed = keyed and total_slots * 9 // 8 + dev_huge_slots <= slot_budget

    def partition(prefix, cap_s=None):
        # Source-aligned greedy partition: tile boundaries at row starts, each
        # tile's slot total <= cap.  The Python loop runs num_tiles times.
        cap_s = cap if cap_s is None else cap_s
        starts, ends = [], []
        b = 0
        while prefix[b] < prefix[-1]:
            # first source >= b with any slots (skip inactive ranges)
            a = int(np.searchsorted(prefix, prefix[b], side="right")) - 1
            a = max(a, b)
            nb = int(np.searchsorted(prefix, prefix[a] + cap_s, side="right")) - 1
            if nb <= a:  # defensive; cannot happen since per-source work <= cap
                nb = a + 1
            starts.append(a)
            ends.append(nb)
            b = nb
        return starts, ends

    slot_w = slot_u = slot_udeg = slot_wdeg = slot_middeg = None
    tile_slot_start = None
    side_plan = None
    if packed:
        # --- host-side slot expansion + DEAD-SLOT REMOVAL --------------------
        # The reference zeroes self + first-order neighbors AFTER accumulating
        # (predict.hxx:306-307); since the plan knows the adjacency, those
        # slots can be dropped BEFORE the device ever sees them — (u, w) runs
        # where w ∈ N(u) or w == u can never score, and with them gone the
        # killer slots have nothing to kill and are dropped too (~25-30% of
        # the stream on RMAT; the packed upay flag is then constantly "real").
        # The edge-stream path keeps killers (it cannot drop non-contiguous
        # slots).  A native C++ pass (native/src/plan_native.cpp) fuses the
        # expansion and the drop in one CSR walk (~10-20x the NumPy temps
        # pipeline below, which stays as the fallback and semantic oracle).
        expanded = _native_expand(g, src, mid, skip, int(work.sum()), deg16)
        if expanded is not None:
            kept, sw, su, sudeg, swdeg_k, smid, cnt_u = expanded
        else:
            work32 = work.astype(np.int64)
            eprefix = np.cumsum(work32) - work32
            eloc = np.repeat(np.arange(src.shape[0], dtype=np.int64), work32)
            s_iota = np.arange(int(work.sum()), dtype=np.int64)
            j = s_iota - eprefix[eloc]
            adr = offsets64[mid][eloc] + skip[eloc] + j
            wv = indices[adr]
            slot_src = np.repeat(src, work32)
            kq = slot_src * n + wv
            gk = gkeys()
            pos = np.searchsorted(gk, kq)
            is_edge = np.zeros(kq.shape[0], dtype=bool)
            if gk.size:
                inb = pos < gk.size
                is_edge[inb] = gk[pos[inb]] == kq[inb]
            keep_s = ~is_edge & (wv != slot_src)
            wv = wv[keep_s]
            slot_src = slot_src[keep_s]
            smid = deg[np.repeat(mid, work32)[keep_s]].astype(np.int32)
            kept = int(wv.shape[0])
            cnt_u = np.bincount(slot_src, minlength=n).astype(np.int64)
            sw = wv.astype(np.int32)
            su = slot_src.astype(np.int32)
            if deg16:
                # Pre-pack the degree pair (udeg << 16 | wdeg) on the host:
                # one fewer stream array (134 MB at 2^25 slots) and no pack op
                # in the kernel.  uint32 keeps udeg >= 2^15 from tripping
                # int32 overflow; the kernel unpacks with a mask post-shift.
                pair = (deg[slot_src].astype(np.uint32) << np.uint32(16)) \
                    | deg[wv].astype(np.uint32)
                sudeg = pair.view(np.int32)
                swdeg_k = None
            else:
                sudeg = deg[slot_src].astype(np.int32)
                swdeg_k = deg[wv].astype(np.int32)
        def _emit(sw_s, su_s, sudeg_s, swdeg_s, smid_s, cnt_u_s, cap_s,
                  deg16_s, pad4):
            """Pack one slot sub-stream into padded device arrays plus its
            source-aligned tile partition (slots <= cap_s per tile).  Shared
            by the main stream and the degree-regime side stream."""
            kept_s = int(sw_s.shape[0])
            prefix_s = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(cnt_u_s, out=prefix_s[1:])
            starts, ends = partition(prefix_s, cap_s)
            s_pad = _pad_bucket(kept_s + cap_s)
            z_w = np.zeros(s_pad, dtype=np.int32)
            z_u = np.zeros(s_pad, dtype=np.int32)
            z_ud = np.zeros(s_pad, dtype=np.int32)
            z_md = np.zeros(s_pad, dtype=np.int32)
            z_w[:kept_s] = sw_s
            # Bare source id: dead slots are gone, so the packed kernel runs
            # with killers=False and needs no real/killer flag bit.
            z_u[:kept_s] = su_s
            z_ud[:kept_s] = sudeg_s
            if deg16_s:
                z_wd = np.zeros(1, dtype=np.int32)  # unused dummy
            else:
                z_wd = np.zeros(s_pad, dtype=np.int32)
                z_wd[:kept_s] = swdeg_s
            z_md[:kept_s] = smid_s
            nt = max(len(starts), 1)
            tp = _pad_tiles(nt) if pad4 else nt
            t_start = np.full(tp + 1, kept_s, dtype=np.int32)
            if starts:
                bounds = np.asarray(starts + [ends[-1]], dtype=np.int64)
                t_start[: nt + 1] = prefix_s[bounds]
            else:
                t_start[:] = 0
            return z_w, z_u, z_ud, z_wd, z_md, t_start, nt, kept_s

        # --- degree-regime split ---------------------------------------------
        # deg16 is a PAIR property: every slot of a (u, w) run shares deg(u)/
        # deg(w), so slots partition cleanly by "both degrees fit 16 bits".
        # When only a few hub vertices push max_deg past 2^16 (RMAT-20/21: ONE
        # vertex, slot mass ~0.2-3%), the whole stream used to pay the
        # 4-operand sort; now the lo-regime majority keeps the packed-pair
        # 3-operand sort and the hi-regime minority rides a small 4-operand
        # side plan (scored as an extra pass, merged like the hub sub-plan).
        # LINKPRED_DEG_SPLIT=0 disables (A/B + exactness tests).
        split_hi = None
        if not deg16:
            if os.environ.get("LINKPRED_DEG_SPLIT", "1") != "0":
                hi = (sudeg >= (1 << 16)) | (swdeg_k >= (1 << 16))
                n_hi = int(np.count_nonzero(hi))
                if n_hi == 0:
                    # The oversized-degree vertices never appear in a live
                    # pair (e.g. hubs whose candidates are all first-order):
                    # the whole stream packs.
                    pair = (sudeg.astype(np.uint32) << np.uint32(16)) \
                        | swdeg_k.astype(np.uint32)
                    sudeg, swdeg_k = pair.view(np.int32), None
                    deg16 = True
                elif n_hi < kept:
                    lo = ~hi
                    cnt_hi = np.bincount(su[hi], minlength=n).astype(np.int64)
                    split_hi = (sw[hi], su[hi], sudeg[hi], swdeg_k[hi],
                                smid[hi], cnt_hi)
                    pair = (sudeg[lo].astype(np.uint32) << np.uint32(16)) \
                        | swdeg_k[lo].astype(np.uint32)
                    sw, su, smid = sw[lo], su[lo], smid[lo]
                    sudeg, swdeg_k = pair.view(np.int32), None
                    cnt_u = cnt_u.astype(np.int64) - cnt_hi
                    deg16 = True  # the MAIN stream packs the degree pair now

        (slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg, tile_slot_start,
         num_tiles, total_slots) = _emit(sw, su, sudeg, swdeg_k, smid, cnt_u,
                                         cap, deg16, pad_tiles_pow2)

        if split_hi is not None:
            hw, hu, hud, hwd, hmd, cnt_hi = split_hi
            hi_total = int(hw.shape[0])
            # Full side tiles: ~AUTO_CAP_TILES of them, but at least the
            # largest per-source hi count (a source must fit one tile) and
            # never above the main cap.
            cap_h = int(min(cap, max(
                _next_pow2(max(int(cnt_hi.max()), 1)),
                _next_pow2(-(-hi_total // AUTO_CAP_TILES)))))
            (zw, zu, zud, zwd, zmd, t_s, nt_h, tot_h) = _emit(
                hw, hu, hud, hwd, hmd, cnt_hi, cap_h, False, False)
            dummy1 = np.zeros(1, dtype=np.int32)
            side_plan = TilePlan(
                fe_work=dummy1, fe_adr=dummy1, fe_usrc=dummy1,
                fe_middeg=dummy1, tile_edge_start=t_s.copy(), cap=cap_h,
                num_tiles=nt_h, huge_src=np.empty(0, dtype=np.int64),
                total_slots=tot_h, huge_slots=0, w_bits=w_bits,
                upper_only=upper_only, deg16=False, keyed=keyed, packed=True,
                slot_w=zw, slot_u=zu, slot_udeg=zud, slot_wdeg=zwd,
                slot_middeg=zmd, tile_slot_start=t_s)
        # The edge-stream arrays are never read for packed plans: store
        # 1-element dummies (a packed RMAT-scale plan would otherwise pin four
        # ~m1-sized int32 arrays for nothing) and mirror the slot boundaries
        # into tile_edge_start so num_tiles_padded stays consistent.
        tile_edge_start = tile_slot_start.copy()
        fe_work = fe_adr = fe_usrc = fe_middeg = np.zeros(1, dtype=np.int32)
    else:
        # Materialize killer rows and interleave them killers-FIRST per source:
        # the stable w-key sort preserves stream order inside each (w, u)
        # group, which is what puts a killer at its run's head (the liveness
        # test reads the first slot's flag).
        esrc = np.concatenate([src, kuniq])
        emid = np.concatenate([mid, kuniq])
        eskip = np.concatenate([skip, kskip])
        real = np.concatenate([np.ones(src.shape[0], dtype=bool),
                               np.zeros(kuniq.shape[0], dtype=bool)])
        order = np.lexsort((emid, real, esrc))
        esrc, emid, real, eskip = (esrc[order], emid[order], real[order],
                                   eskip[order])
        ework = deg[emid] - eskip

        row_prefix = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(w_u, out=row_prefix[1:])
        starts, ends = partition(row_prefix)
        num_tiles = max(len(starts), 1)
        t_pad = _pad_tiles(num_tiles) if pad_tiles_pow2 else num_tiles

        row_edge_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(esrc, minlength=n), out=row_edge_start[1:])
        tile_edge_start = np.full(t_pad + 1, m1, dtype=np.int32)
        if starts:
            bounds = np.asarray(starts + [ends[-1]], dtype=np.int64)
            tile_edge_start[: num_tiles + 1] = row_edge_start[bounds]
        else:  # empty stream: single all-padding tile
            tile_edge_start[:] = 0

        # Pad edge arrays so every tile can read a full cap-sized window,
        # bucket-rounded so jitted shapes stay stable across experiment
        # batches (see _pad_bucket).
        m1_pad = _pad_bucket(m1 + cap)
        fe_work = np.zeros(m1_pad, dtype=np.int32)
        fe_adr = np.zeros(m1_pad, dtype=np.int32)
        fe_usrc = np.zeros(m1_pad, dtype=np.int32)
        fe_middeg = np.zeros(m1_pad, dtype=np.int32)
        fe_work[:m1] = ework
        fe_adr[:m1] = offsets64[emid] + eskip
        fe_usrc[:m1] = np.where(real, esrc, ~esrc)
        fe_middeg[:m1] = deg[emid]

    return TilePlan(
        fe_work=fe_work,
        fe_adr=fe_adr,
        fe_usrc=fe_usrc,
        fe_middeg=fe_middeg,
        tile_edge_start=tile_edge_start,
        cap=cap,
        num_tiles=num_tiles,
        huge_src=huge_src,
        total_slots=total_slots,
        huge_slots=huge_slots,
        w_bits=w_bits,
        upper_only=upper_only,
        deg16=deg16,
        keyed=keyed,
        packed=packed,
        huge_plan=huge_plan,
        side_plan=side_plan,
        host_src=host_src,
        slot_w=slot_w,
        slot_u=slot_u,
        slot_udeg=slot_udeg,
        slot_wdeg=slot_wdeg,
        slot_middeg=slot_middeg,
        tile_slot_start=tile_slot_start,
    )
