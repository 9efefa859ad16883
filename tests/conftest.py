"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set env vars before the first `import jax` anywhere in the test process, so this
sits at the top of conftest (pytest imports it before test modules).  Tests marked
``gpu`` need the card: run them there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Engine-mode CI axis: LINKPRED_KEY64=1 runs the WHOLE suite on the u64-key
# engine (the bench default), which needs x64 types enabled.  `scripts/ci.sh`
# runs the suite in both modes.
if os.environ.get("LINKPRED_KEY64") == "1":
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skips unless JAX's backend is a GPU.  The
    decision is made here, when the test runs, never at import."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's backend is {jax.default_backend()}")
    return jax.devices()[0]


def random_graph(rng, n: int, avg_deg: float, seed_extra: int = 0):
    """Random undirected simple graph as a symmetric CSRGraph (test helper)."""
    from linkpred_tpu import from_edges
    from linkpred_tpu.ops.transform import remove_self_loops, symmetrize

    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    g = from_edges(src, dst, n=n)
    return remove_self_loops(symmetrize(g))


def powerlaw_graph(rng, n: int, m: int, alpha: float = 1.2):
    """Skewed-degree graph (preferential-attachment-ish) for hub-path tests."""
    from linkpred_tpu import from_edges
    from linkpred_tpu.ops.transform import remove_self_loops, symmetrize

    # Zipf-weighted endpoint sampling produces heavy-tailed degrees.
    w = 1.0 / np.arange(1, n + 1) ** alpha
    p = w / w.sum()
    src = rng.choice(n, size=m, p=p)
    dst = rng.integers(0, n, size=m)
    g = from_edges(src, dst, n=n)
    return remove_self_loops(symmetrize(g))
