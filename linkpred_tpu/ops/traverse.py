"""Graph traversal: BFS and DFS.

Reference parity: frontier-swap BFS with visit filter/callback
(`/root/reference/inc/bfs.hxx:22-55`) and recursive DFS (`inc/dfs.hxx:19-25`), used
by ``communitiesDisconnectedOmp`` (`inc/properties.hxx:379-400`).

Design: BFS runs as a `lax.while_loop` of edge-parallel level expansions
(frontier propagation by scatter-max over the edge list — the pull/push duality of
the reference's per-vertex loop).  DFS order is inherently sequential, so it stays a
host-side iterative routine (the reference's recursion, made stack-safe).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..graph import CSRGraph, edge_list

__all__ = ["bfs_levels", "bfs_visited", "dfs_order", "dfs_visited"]


@partial(jax.jit, static_argnames=("n",))
def _bfs_device(esrc, edst, start_mask, *, n: int):
    """Level-synchronous BFS. Returns int32[n] levels (-1 = unreached)."""
    levels0 = jnp.where(start_mask, 0, -1)

    def cond(state):
        levels, frontier, depth = state
        return frontier.any()

    def body(state):
        levels, frontier, depth = state
        on_edge = frontier[esrc]
        reached = jnp.zeros((n,), bool).at[edst].max(on_edge, mode="drop")
        nxt = reached & (levels < 0)
        return jnp.where(nxt, depth + 1, levels), nxt, depth + 1

    levels, _, _ = jax.lax.while_loop(
        cond, body, (levels0, start_mask, jnp.int32(0)))
    return levels


def bfs_levels(g: CSRGraph, start, n: Optional[int] = None) -> np.ndarray:
    """BFS levels from ``start`` (vertex id or boolean mask); -1 = unreached."""
    g = g.host()
    esrc, edst = edge_list(g)
    if np.isscalar(start) or getattr(start, "ndim", 1) == 0:
        mask = np.zeros(g.n, bool)
        mask[int(start)] = True
    else:
        mask = np.asarray(start, bool)
    return np.asarray(_bfs_device(
        jnp.asarray(esrc, jnp.int32), jnp.asarray(edst, jnp.int32),
        jnp.asarray(mask), n=g.n))


def bfs_visited(g: CSRGraph, start, visited: Optional[np.ndarray] = None,
                ft: Optional[Callable] = None,
                fp: Optional[Callable] = None) -> np.ndarray:
    """Reference-style ``bfsVisitedForEachU`` (`bfs.hxx:22-55`): mark vertices
    reachable from ``start``, honoring an optional visit filter ``ft(v, depth)``
    and calling ``fp(v, depth)`` per visit.  Host implementation (callbacks are
    Python); use :func:`bfs_levels` for the vectorized device path."""
    g = g.host()
    offsets = np.asarray(g.offsets)
    indices = np.asarray(g.indices)
    vis = np.zeros(g.n, bool) if visited is None else visited
    frontier = [int(start)]
    vis[int(start)] = True
    if fp is not None:
        fp(int(start), 0)
    depth = 1
    while frontier:
        nxt = []
        for u in frontier:
            for v in indices[offsets[u]: offsets[u + 1]]:
                v = int(v)
                if vis[v] or (ft is not None and not ft(v, depth)):
                    continue
                vis[v] = True
                if fp is not None:
                    fp(v, depth)
                nxt.append(v)
        frontier = nxt
        depth += 1
    return vis


def dfs_order(g: CSRGraph, start: int) -> np.ndarray:
    """Preorder DFS vertex sequence from ``start`` (host, stack-based — the
    reference's recursion `dfs.hxx:19-25` made stack-safe)."""
    g = g.host()
    offsets = np.asarray(g.offsets)
    indices = np.asarray(g.indices)
    visited = np.zeros(g.n, bool)
    order = []
    stack = [int(start)]
    while stack:
        u = stack.pop()
        if visited[u]:
            continue
        visited[u] = True
        order.append(u)
        # push in reverse so the smallest neighbor is visited first
        stack.extend(int(v) for v in indices[offsets[u]: offsets[u + 1]][::-1])
    return np.asarray(order, dtype=np.int64)


def dfs_visited(g: CSRGraph, start: int,
                visited: Optional[np.ndarray] = None) -> np.ndarray:
    """Mark vertices reachable from ``start`` in DFS order (``dfsVisitedForEachU``)."""
    g = g.host()
    vis = np.zeros(g.n, bool) if visited is None else visited
    for u in dfs_order(g, start):
        vis[u] = True
    return vis
