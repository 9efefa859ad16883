"""CSR graph container — the static-shape replacement for the reference's adjacency
structures.

The reference (`/root/reference/inc/Graph.hxx:23-372`) stores a ``DiGraph`` as one
``LazyBitset`` (sorted key/value vector with deferred batch updates,
`inc/_bitset.hxx:24-316`) per vertex, mutated in place under OpenMP.  That design is
pointer-heavy and mutation-oriented — wrong for XLA.  Here a graph is a frozen pytree of
padded ``int32`` arrays (the layout the reference defines but never uses:
``DiGraphCsr``, `inc/Graph.hxx:383-639`):

* ``offsets``  — ``int32[n + 1]`` row starts into ``indices``
* ``indices``  — ``int32[m_pad]`` neighbor ids, sorted ascending within each row,
  padded with the sentinel ``n`` so speculative gathers stay in range
* ``degrees``  — ``int32[n]`` true row lengths (``offsets[i+1] - offsets[i]``)
* ``weights``  — optional ``float32[m_pad]`` edge values
* ``values``   — optional ``[n]`` per-vertex values (the reference's vertex
  value V, `inc/Graph.hxx:176-186` ``vertexValue``/``setVertexValue``; e.g.
  ``transpose_with_degree`` stores the pre-transpose out-degree here,
  `inc/transpose.hxx:79-134`)

``n`` and ``m`` are static (Python ints) so jitted functions specialize on graph shape,
mirroring how the reference specializes via C++ templates.  All mutation is functional:
builders return new graphs (host-side NumPy — graph construction is I/O-bound and
happens once per experiment batch, outside the jitted hot path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "CSRGraph",
    "GraphBuilder",
    "from_edges",
    "from_dense",
    "to_dense",
    "edge_list",
    "PAD_ALIGN",
]

# Pad edge arrays to a lane-aligned length so tiled device gathers never mask the tail.
PAD_ALIGN = 128


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR graph pytree. Array leaves may be NumPy (host) or JAX (device)."""

    offsets: jax.Array  # int32[n + 1]
    indices: jax.Array  # int32[m_pad], row-sorted, padded with sentinel ``n``
    degrees: jax.Array  # int32[n]
    weights: Optional[jax.Array]  # float32[m_pad] or None
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    values: Optional[jax.Array] = None  # per-vertex values [n] or None

    # -- reference-parity accessors (Graph.hxx: span/order/size/degree/hasEdge) --
    @property
    def span(self) -> int:
        """Number of vertex slots (reference ``span()``; vertices are 0..n-1)."""
        return self.n

    @property
    def order(self) -> int:
        """Number of vertices (reference ``order()``)."""
        return self.n

    @property
    def size(self) -> int:
        """Number of directed edges (reference ``size()``)."""
        return self.m

    @property
    def m_pad(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, u: int) -> int:
        return int(self.degrees[u])

    def neighbors(self, u: int) -> np.ndarray:
        """Sorted neighbor ids of ``u`` (host helper, not for jit)."""
        o = np.asarray(self.offsets)
        return np.asarray(self.indices)[o[u] : o[u + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        nbrs = self.neighbors(u)
        j = np.searchsorted(nbrs, v)
        return bool(j < nbrs.shape[0] and nbrs[j] == v)

    # -- per-vertex values (reference Graph.hxx:176-186; functional here) ----
    def vertex_value(self, u: int):
        """The vertex value of ``u`` (reference ``vertexValue``); None-graph
        returns None like the reference's V() default-constructed value."""
        return None if self.values is None else self.values[u]

    def with_vertex_values(self, values) -> "CSRGraph":
        """New graph carrying ``values`` as the per-vertex value array — the
        functional ``setVertexValue`` (the reference mutates in place;
        CSRGraph is a frozen pytree)."""
        if values is not None:
            values = np.asarray(values) if isinstance(self.offsets, np.ndarray) \
                else jnp.asarray(values)
            if values.shape[0] != self.n:
                raise ValueError(f"values length {values.shape[0]} != n={self.n}")
        return dataclasses.replace(self, values=values)

    def device(self) -> "CSRGraph":
        """Move array leaves to the default device as jnp arrays."""
        return CSRGraph(
            offsets=jnp.asarray(self.offsets),
            indices=jnp.asarray(self.indices),
            degrees=jnp.asarray(self.degrees),
            weights=None if self.weights is None else jnp.asarray(self.weights),
            n=self.n,
            m=self.m,
            values=None if self.values is None else jnp.asarray(self.values),
        )

    def host(self) -> "CSRGraph":
        return CSRGraph(
            offsets=np.asarray(self.offsets),
            indices=np.asarray(self.indices),
            degrees=np.asarray(self.degrees),
            weights=None if self.weights is None else np.asarray(self.weights),
            n=self.n,
            m=self.m,
            values=None if self.values is None else np.asarray(self.values),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"CSRGraph(n={self.n}, m={self.m}, m_pad={self.m_pad})"


def _pad_len(m: int) -> int:
    return max(PAD_ALIGN, ((m + PAD_ALIGN - 1) // PAD_ALIGN) * PAD_ALIGN)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: Optional[int] = None,
    weights: Optional[np.ndarray] = None,
    dedup: bool = True,
    vertex_values: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Build a CSR graph from directed edge arrays (host, vectorized NumPy).

    Replaces the reference's replay-all-edges + owner-computes parallel insert
    (`inc/mtx.hxx:179-186`, `inc/_openmp.hxx:16-33`) with a lexsort: sorting by
    (src, dst) both shards rows and orders neighbors in one O(m log m) pass.
    Duplicate edges keep the LAST-seen weight — the reference's bitset commit
    merges pending insertions with ``set_union_last_inplace``
    (`inc/_bitset.hxx:258`), so a later ``addEdge`` of an existing pair
    replaces its value.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    n = int(n)
    if src.size and (src.min(initial=0) < 0 or int(max(src.max(initial=0), dst.max(initial=0))) >= n):
        raise ValueError("vertex id out of range")

    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    w = None if weights is None else np.asarray(weights, dtype=np.float32)[order]
    if dedup and src.size:
        # keep the LAST duplicate (lexsort is stable, so the last-sorted entry
        # of each (src, dst) group is the last-seen input edge)
        keep = np.empty(src.shape[0], dtype=bool)
        keep[-1] = True
        np.logical_or(src[1:] != src[:-1], dst[1:] != dst[:-1], out=keep[:-1])
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]

    m = int(src.shape[0])
    degrees = np.bincount(src, minlength=n).astype(np.int32)
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(degrees, out=offsets[1:])

    mp = _pad_len(m)
    indices = np.full(mp, n, dtype=np.int32)
    indices[:m] = dst
    wpad = None
    if w is not None:
        wpad = np.zeros(mp, dtype=np.float32)
        wpad[:m] = w
    vv = None
    if vertex_values is not None:
        vv = np.asarray(vertex_values)
        if vv.shape[0] != n:
            raise ValueError(f"vertex_values length {vv.shape[0]} != n={n}")
    return CSRGraph(offsets=offsets, indices=indices, degrees=degrees,
                    weights=wpad, n=n, m=m, values=vv)


def edge_list(g: CSRGraph, with_weights: bool = False):
    """Directed (src, dst) int64 arrays (host); with ``with_weights``, a
    third element carries the per-edge float32 values (None if unweighted) —
    the reference's update path flows edge values E alongside the keys
    (`inc/update.hxx:130-150`)."""
    g = g.host()
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.asarray(g.degrees, dtype=np.int64))
    dst = np.asarray(g.indices[: g.m], dtype=np.int64)
    if with_weights:
        w = (None if g.weights is None
             else np.asarray(g.weights[: g.m], dtype=np.float32))
        return src, dst, w
    return src, dst


def from_dense(a: np.ndarray) -> CSRGraph:
    """Build from a dense boolean adjacency matrix (test helper)."""
    src, dst = np.nonzero(np.asarray(a))
    return from_edges(src, dst, n=a.shape[0])


class GraphBuilder:
    """Deferred-mutation builder with the reference's ``DiGraph`` workflow:
    ``addEdge``/``removeEdge`` accumulate, ``update()`` commits
    (`/root/reference/inc/Graph.hxx:228-284`, `inc/_bitset.hxx:227-289`).

    The reference merges lazy deltas into per-vertex sorted bitsets in place;
    here ``update`` is one functional rebuild (sort-based, last-op-wins per
    directed pair) producing an immutable :class:`CSRGraph`.
    """

    def __init__(self, base: Optional[CSRGraph] = None, n: Optional[int] = None):
        self._base = base
        self._n = n if n is not None else (base.n if base is not None else 0)
        self._add: list[tuple[int, int, float]] = []
        self._rem: list[tuple[int, int]] = []

    def add_edge(self, u: int, v: int, w: float = 1.0) -> "GraphBuilder":
        self._n = max(self._n, int(u) + 1, int(v) + 1)
        self._add.append((int(u), int(v), float(w)))
        return self

    def remove_edge(self, u: int, v: int) -> "GraphBuilder":
        self._rem.append((int(u), int(v)))
        return self

    def respan(self, n: int) -> "GraphBuilder":
        """Grow the vertex range (reference ``respan``, `Graph.hxx:258`)."""
        self._n = max(self._n, int(n))
        return self

    def update(self) -> CSRGraph:
        """Commit pending ops; removals win over prior edges, additions are
        applied last with LAST-wins value semantics (apply order of
        `batch.hxx:222-247`; value merge of `_bitset.hxx:258`
        ``set_union_last_inplace`` — re-adding an existing pair replaces its
        weight).  Weights flow through the rebuild like the reference's edge
        values E (`update.hxx:130-150`); the result is weighted iff the base
        was or any pending addition carries a non-default weight."""
        if self._base is not None:
            src, dst, w = edge_list(self._base, with_weights=True)
        else:
            src = np.empty(0, dtype=np.int64)
            dst = np.empty(0, dtype=np.int64)
            w = None
        if self._rem:
            rem = np.asarray(self._rem, dtype=np.int64).reshape(-1, 2)
            hi = max(self._n, 1)
            keys = src * hi + dst
            rkeys = rem[:, 0] * hi + rem[:, 1]
            keep = ~np.isin(keys, rkeys)
            src, dst = src[keep], dst[keep]
            if w is not None:
                w = w[keep]
        if self._add:
            add = np.asarray([(u, v) for u, v, _ in self._add], dtype=np.int64)
            addw = np.asarray([x for _, _, x in self._add], dtype=np.float32)
            weighted = w is not None or bool(np.any(addw != 1.0))
            if weighted:
                base_w = w if w is not None \
                    else np.ones(src.shape[0], dtype=np.float32)
                w = np.concatenate([base_w, addw])
            src = np.concatenate([src, add[:, 0]])
            dst = np.concatenate([dst, add[:, 1]])
        vv = None
        if self._base is not None and self._base.values is not None:
            # vertex values survive edge mutations (reference Graph.hxx:
            # values live per vertex, not per edge); a respan extends with
            # the default-constructed value V() == 0 (Graph.hxx:258,176-186)
            old = np.asarray(self._base.values)
            if old.shape[0] < self._n:
                vv = np.zeros(self._n, dtype=old.dtype)
                vv[: old.shape[0]] = old
            else:
                vv = old
        g = from_edges(src, dst, n=self._n, weights=w, vertex_values=vv)
        self._base, self._add, self._rem = g, [], []
        return g


def to_dense(g: CSRGraph) -> np.ndarray:
    """Dense boolean adjacency (test helper; small graphs only)."""
    g = g.host()
    a = np.zeros((g.n, g.n), dtype=bool)
    src, dst = edge_list(g)
    a[src, dst] = True
    return a
