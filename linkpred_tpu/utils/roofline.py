"""Device-memory roofline accounting: how far is a measured pass from the
bandwidth bound?

This module prices a scoring pass in MINIMUM device-memory bytes (every
stream read once, every intermediate written+read once, the sort at its
theoretical one-read-one-write) and reports achieved GB/s against the card's
published peak.  The model is a LOWER bound on traffic — XLA's sort makes
multiple internal passes — so `frac_of_peak` is an upper bound on how close
the engine could possibly be; it makes "we are N× off the roofline" a
checkable statement (bench.py emits it with every headline number).

Per-slot byte model (packed stream, deg16, key64, pack select):

  stream window reads      slot_w + slot_u + slot_udeg        12 B
  key64 build write        u64 key                             8 B
  tile sort (min 1r+1w)    (key 8 + payload 4) x 2            24 B
  run-reduce tail          cummax/score intermediates,
                           write scores 4M + ku 4 + kw 4      24+4M+8 B
  selection (pack path)    read skey 4M, pack write 9/RATIO,
                           packed sort ~2x9/RATIO             ~4M+3.4 B

(M = number of metrics; weighted metrics add a 4 B f32 weight through the
sort: +4 stream read, +8 sort.)  The blocked selection (~2 x 8 B x levels)
is priced in :func:`packed_pass_min_bytes` too, so either selection gets an
honest figure.
"""
from __future__ import annotations

from typing import Optional

import jax

__all__ = ["device_peak_gbps", "packed_pass_min_bytes", "roofline_report"]

# Peak device-memory bandwidth (GB/s) by device_kind substring; NVIDIA's
# H100 data sheet (SXM, PCIe and NVL parts).
PEAK_GBPS = {
    "H100 80GB HBM3": 3350.0,
    "H100 PCIe": 2000.0,
    "H100 NVL": 3900.0,
}


def device_peak_gbps(device=None) -> Optional[float]:
    """Peak device-memory GB/s for ``device`` (default: the first JAX
    device).  The CPU has no peak here (``None``); an accelerator kind that
    is not in ``PEAK_GBPS`` raises."""
    d = device or jax.devices()[0]
    if d.platform == "cpu":
        return None
    for kind, peak in PEAK_GBPS.items():
        if kind in d.device_kind:
            return peak
    raise KeyError(f"no peak bandwidth known for device kind "
                   f"{d.device_kind!r}; add it to PEAK_GBPS")


def packed_pass_min_bytes(total_slots: int, num_metrics: int = 1,
                          weighted: int = 0, key64: bool = True,
                          deg16: bool = True, sel_pack: bool = True) -> int:
    """Minimum device-memory bytes for one packed-stream scoring pass
    (model above)."""
    m = num_metrics
    b = 12.0                                    # stream window reads
    if not deg16:
        b += 4                                  # separate wdeg stream
    b += 4 * weighted                           # per-slot f32 weights read
    b += 8 if key64 else 4                      # key build write
    payload = (4 if deg16 else 8) + 4 * weighted
    b += 2 * ((8 if key64 else 8) + payload)    # sort: one read + one write
    #   (u32 mode sorts (key4 + upay4) + payload — same 8 B of keys)
    b += 24 + 4 * m + 8                         # tail intermediates + outputs
    if sel_pack:
        b += 4 * m + (9.0 / 8) * m + 2 * (9.0 / 8) * m   # pack + small sort
    else:
        b += 2 * 8 * 1.7 * m                    # blocked sorts, ~1.7 levels
    return int(b * total_slots)


def roofline_report(min_bytes: int, device_ms: float,
                    peak_gbps: Optional[float] = None) -> dict:
    """Achieved GB/s on the minimum-byte model, and the fraction of the
    card's peak where the device has one (not on the CPU)."""
    peak = peak_gbps if peak_gbps is not None else device_peak_gbps()
    gbps = min_bytes / max(device_ms, 1e-9) / 1e6
    out = {"hbm_model_bytes": int(min_bytes),
           "achieved_gbps_min_model": round(gbps, 1)}
    if peak is not None:
        out["hbm_peak_gbps"] = peak
        out["frac_of_peak"] = round(gbps / peak, 4)
    return out
