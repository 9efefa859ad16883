"""Device introspection: memory budgets derived from the device's memory.

The reference runs "any graph that fits RAM" with zero configuration
(`/root/reference/main.sh:46-62` feeds sk-2005-class graphs to a fixed
binary); the engine mirrors that posture by sizing its slot/selection
budgets from the memory the device reports.  Env vars
(`LINKPRED_SLOT_BUDGET`, `LINKPRED_SEG_LANES`) remain as overrides for A/B
runs — see `plan.py` / `scoring.py` for the consumers.
"""
from __future__ import annotations

from functools import lru_cache

__all__ = ["hbm_bytes", "auto_slot_budget", "auto_seg_lanes"]

# What the CPU backend (tests, rehearsals) plans against: CPU devices report
# no memory limit, so this fixed size stands in for device memory there.
CPU_PLAN_BYTES = 16 << 30


@lru_cache(maxsize=None)
def hbm_bytes() -> int:
    """Memory of the default device in bytes: ``bytes_limit`` from its
    memory stats (on a GPU, the share JAX's allocator preallocated), or
    ``CPU_PLAN_BYTES`` on the CPU.  Raises if an accelerator reports no
    limit.  Cached — one backend query per process."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return CPU_PLAN_BYTES
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(f"{dev.device_kind} reports no memory bytes_limit")
    return int(limit)


# The 0.55 and 0.20 fractions below were set on another chip and have not
# been re-derived on the GPU (ROADMAP S4); there they apply to the share of
# the card that JAX preallocates.

def auto_slot_budget() -> int:
    """Packed-slot-stream ceiling: ~55% of device memory at 12 B/slot (three
    int32 stream arrays), leaving room for one selection segment + sort
    workspace."""
    return min(int(hbm_bytes() * 0.55) // 12, (1 << 31) - (1 << 22))


def auto_seg_lanes() -> int:
    """Deferred-selection raw-buffer bound: ~20% of device memory at 12
    B/lane (single-metric scores + u + v)."""
    return min(int(hbm_bytes() * 0.20) // 12, 1 << 29)
