"""Threshold-pack selection (ops/compact.py) — exactness and fallback.

Tests use small chunk sizes (the production chunk is just more chunks of the
same code).  The oracle is NumPy boolean compaction.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from linkpred_tpu.ops import compact
from linkpred_tpu.ops.compact import pack_survivors, sample_threshold

CHUNK = 1 << 11     # 16 rows x 128 — small for interpret mode
RATIO = 2


def _oracle_pack(key, thr, chunk, ratio):
    total = key.shape[0]
    w = chunk // ratio
    pk = np.full(total // ratio, 0xFFFFFFFF, np.uint32)
    pidx = np.zeros(total // ratio, np.int32)
    cnts = []
    for c in range(total // chunk):
        seg = key[c * chunk: (c + 1) * chunk]
        surv = np.nonzero(seg <= thr)[0]
        cnts.append(len(surv))
        kept = surv[:w]
        pk[c * w: c * w + len(kept)] = seg[kept]
        pidx[c * w: c * w + len(kept)] = (c * chunk + kept).astype(np.int32)
    return pk, pidx, np.asarray(cnts, np.int32)


@pytest.mark.parametrize("dist", ["uniform", "clustered", "ties", "empty"])
def test_pack_survivors_vs_oracle(rng, dist):
    total = CHUNK * 4
    if dist == "uniform":
        key = rng.integers(0, 1 << 31, total, dtype=np.int64)
        thr = np.uint32(1 << 28)                      # ~12% survive
    elif dist == "clustered":
        key = np.full(total, 1 << 30, np.int64)
        key[CHUNK - 200: CHUNK + 77] = 5              # straddles a boundary
        key[-300:] = 7                                 # tail cluster
        thr = np.uint32(100)
    elif dist == "ties":
        key = rng.integers(0, 4, total, dtype=np.int64) * 1000
        thr = np.uint32(1000)                          # huge tie mass
    else:
        key = rng.integers(1 << 20, 1 << 31, total, dtype=np.int64)
        thr = np.uint32(3)                             # nothing survives
    key = key.astype(np.uint32)
    pk, pidx, cnt = pack_survivors(jnp.asarray(key), jnp.uint32(thr),
                                   chunk=CHUNK, ratio=RATIO)
    opk, opidx, ocnt = _oracle_pack(key, thr, CHUNK, RATIO)
    np.testing.assert_array_equal(np.asarray(cnt), ocnt)
    # where a chunk overflows (cnt > w) the kernel's kept prefix is still the
    # FIRST w survivors in order — same as the oracle's
    np.testing.assert_array_equal(np.asarray(pk), opk)
    np.testing.assert_array_equal(np.asarray(pidx), opidx)


def test_pack_overflow_detected(rng):
    """More survivors than the block: counts expose it (caller falls back)."""
    total = CHUNK * 2
    key = np.zeros(total, np.uint32)                   # EVERYTHING survives
    pk, pidx, cnt = pack_survivors(jnp.asarray(key), jnp.uint32(10),
                                   chunk=CHUNK, ratio=RATIO)
    assert int(jnp.max(cnt)) == CHUNK > CHUNK // RATIO
    # the kept prefix is exact even in overflow
    np.testing.assert_array_equal(np.asarray(pidx[:CHUNK // RATIO]),
                                  np.arange(CHUNK // RATIO))


def test_sample_threshold_covers_k(rng):
    for total, kk in [(1 << 16, 500), (1 << 16, 5000), (1 << 14, 100)]:
        key = rng.integers(0, 1 << 30, total, dtype=np.int64).astype(np.uint32)
        thr, _ = sample_threshold(jnp.asarray(key), kk, sample_log2=12)
        assert int(np.sum(key <= np.uint32(thr))) >= kk


def test_argselect_packed_equals_blocked(rng, monkeypatch):
    """End-to-end _argselect dispatch: packed path == blocked sorts, and the
    fallback engages when survivors overflow."""
    from linkpred_tpu.predict import scoring

    monkeypatch.setattr(compact, "PACK_CHUNK", CHUNK)
    monkeypatch.setattr(compact, "PACK_RATIO", RATIO)
    total = CHUNK * 8
    kk = 300
    # realistic selection keys: descending-score keys with an -inf spread mass
    scores = rng.random(total, np.float32)
    scores[rng.random(total) < 0.6] = -np.inf
    flat = jnp.asarray(scores)
    key = scoring._desc_score_key(flat)
    iota = jnp.arange(total, dtype=jnp.int32)
    key = jnp.where(jnp.isneginf(flat),
                    key | (iota & jnp.int32(0x7FFFFE)).astype(jnp.uint32),
                    key)
    sk_p, si_p = scoring._argselect_packed(key, iota, kk)
    sk_b, si_b = scoring._argselect_blocked(key, iota, kk)
    np.testing.assert_array_equal(np.asarray(sk_p), np.asarray(sk_b[:kk]))
    # winners agree as (key, idx) sets (tie order inside equal keys may vary)
    assert (set(zip(np.asarray(sk_p).tolist(), np.asarray(si_p).tolist()))
            == set(zip(np.asarray(sk_b[:kk]).tolist(),
                       np.asarray(si_b[:kk]).tolist())))


def test_argselect_packed_fallback_on_ties(rng, monkeypatch):
    """A giant tie plateau at the cutoff overflows every chunk — the cond
    falls back to the blocked path and stays exact."""
    from linkpred_tpu.predict import scoring

    monkeypatch.setattr(compact, "PACK_CHUNK", CHUNK)
    monkeypatch.setattr(compact, "PACK_RATIO", RATIO)
    total = CHUNK * 4
    kk = 64
    scores = np.full(total, 0.5, np.float32)           # all equal
    key = scoring._desc_score_key(jnp.asarray(scores))
    iota = jnp.arange(total, dtype=jnp.int32)
    sk_p, si_p = scoring._argselect_packed(key, iota, kk)
    sk_b, si_b = scoring._argselect_blocked(key, iota, kk)
    np.testing.assert_array_equal(np.asarray(sk_p), np.asarray(sk_b[:kk]))
