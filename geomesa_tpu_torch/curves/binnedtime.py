"""Epoch time binning for Z3/XZ3 keys.

Copy of ``geomesa_tpu/curves/binnedtime.py``, trimmed to what the slice
uses. Semantics follow GeoMesa's BinnedTime: time is split into a
(bin: int16, offset: int64) pair where the bin counts whole periods since
the 1970-01-01T00:00:00Z epoch and the offset is expressed in a
period-dependent unit chosen so it fits 21 bits of z precision:

=======  ================  ==========  ===========
period   bin               offset in   max offset
=======  ================  ==========  ===========
day      days since epoch  millis      86400000
week     weeks since epoch seconds     604800
month    months since epoch seconds    2678400   (31 days)
year     years since epoch minutes     527040    (366 days)
=======  ================  ==========  ===========

Vectorized over int64 epoch-millisecond arrays. Note: for pre-1970 instants
java.time's ``ChronoUnit.between`` truncates toward zero while we use floor
division; GeoMesa constrains dates to [0001, 9999] and the curves themselves
reject negative offsets, so post-1970 data (all benchmark configs) is
bit-identical.
"""

from __future__ import annotations

import enum

import numpy as np

DAY_MS = 86_400_000
WEEK_MS = 7 * DAY_MS


class TimePeriod(enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @staticmethod
    def parse(s: "str | TimePeriod") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return TimePeriod(s.lower())


# max offset per period, in the period's offset unit (ref BinnedTime.maxOffset)
MAX_OFFSET = {
    TimePeriod.DAY: 86_400_000,  # millis in a day
    TimePeriod.WEEK: 604_800,  # seconds in a week
    TimePeriod.MONTH: 2_678_400,  # seconds in 31 days
    TimePeriod.YEAR: 527_040,  # minutes in 366 days
}


def max_offset(period: TimePeriod) -> int:
    return MAX_OFFSET[TimePeriod.parse(period)]


def _floordiv_i64(a: np.ndarray, d: int) -> np.ndarray:
    """Exact int64 floor-division by a positive constant.

    int64 idiv does not vectorize (scalar ~25 cycles each; the two
    divides in the WEEK path cost ~2s per 2^25-row flush/staging pass).
    A float64 reciprocal multiply + floor is off by at most one for
    |a| < 2^52, and a single integer fix-up restores exactness. Inputs
    outside that range (not epoch millis) take the exact slow path."""
    if a.ndim == 0 or len(a) < (1 << 16):
        return a // d  # small inputs: not worth the extra passes
    # signed bounds, NOT np.abs: INT64_MIN (the datetime64 NaT sentinel)
    # overflows np.abs back to a negative value and would defeat the
    # exactness guard, sending NaT-bearing arrays down the float path
    if np.min(a) <= -(1 << 52) or np.max(a) >= (1 << 52):
        return a // d
    q = np.floor(a * (1.0 / d)).astype(np.int64)
    r = a - q * d
    q += r >= d
    q -= r < 0
    return q


def to_binned_time(millis, period: TimePeriod):
    """Vectorized epoch-millis -> (bin int16-ranged int64, offset int64)."""
    period = TimePeriod.parse(period)
    ms = np.asarray(millis, dtype=np.int64)
    if period is TimePeriod.DAY:
        b = _floordiv_i64(ms, DAY_MS)
        off = ms - b * DAY_MS  # millis
    elif period is TimePeriod.WEEK:
        b = _floordiv_i64(ms, WEEK_MS)
        off = _floordiv_i64(ms - b * WEEK_MS, 1000)  # seconds
    elif period is TimePeriod.MONTH:
        dt = ms.astype("datetime64[ms]")
        months = dt.astype("datetime64[M]")
        b = months.astype(np.int64)  # months since 1970-01
        start = months.astype("datetime64[ms]").astype(np.int64)
        off = (ms - start) // 1000  # seconds
    elif period is TimePeriod.YEAR:
        dt = ms.astype("datetime64[ms]")
        years = dt.astype("datetime64[Y]")
        b = years.astype(np.int64)  # years since 1970
        start = years.astype("datetime64[ms]").astype(np.int64)
        off = (ms - start) // 60_000  # minutes
    else:  # pragma: no cover
        raise ValueError(period)
    return b, off


def bin_to_millis(bin_idx, period: TimePeriod):
    """Epoch millis of the start of each bin (vectorized inverse)."""
    period = TimePeriod.parse(period)
    b = np.asarray(bin_idx, dtype=np.int64)
    if period is TimePeriod.DAY:
        return b * DAY_MS
    if period is TimePeriod.WEEK:
        return b * WEEK_MS
    if period is TimePeriod.MONTH:
        return b.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
    if period is TimePeriod.YEAR:
        return b.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
    raise ValueError(period)  # pragma: no cover


def offset_to_millis(offset, period: TimePeriod):
    """Offset (period unit) -> millis within the bin."""
    period = TimePeriod.parse(period)
    off = np.asarray(offset, dtype=np.int64)
    if period is TimePeriod.DAY:
        return off
    if period in (TimePeriod.WEEK, TimePeriod.MONTH):
        return off * 1000
    return off * 60_000


def bins_for_interval(start_ms: int, end_ms: int, period: TimePeriod):
    """Decompose [start_ms, end_ms] (inclusive) into per-bin offset windows.

    Returns a list of (bin, offset_lo, offset_hi) with offsets inclusive, in
    the period's offset unit -- the shape Z3IndexKeySpace needs to emit
    per-bin z ranges.
    """
    period = TimePeriod.parse(period)
    if end_ms < start_ms:
        return []
    b_lo, off_lo = to_binned_time(np.int64(start_ms), period)
    b_hi, off_hi = to_binned_time(np.int64(end_ms), period)
    b_lo, off_lo, b_hi, off_hi = int(b_lo), int(off_lo), int(b_hi), int(off_hi)
    mx = max_offset(period)
    if b_lo == b_hi:
        return [(b_lo, off_lo, off_hi)]
    out = [(b_lo, off_lo, mx)]
    out.extend((b, 0, mx) for b in range(b_lo + 1, b_hi))
    out.append((b_hi, 0, off_hi))
    return out
