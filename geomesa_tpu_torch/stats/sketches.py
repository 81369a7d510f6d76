"""Mergeable streaming sketches.

Copy of ``geomesa_tpu/stats/sketches.py``: ``CountStat``, ``MinMax``,
``Cardinality`` (HyperLogLog), ``TopK`` (space-saving), ``Frequency``
(count-min), the fixed-bin ``Histogram`` and ``Z3HistogramStat``, with
``stat_from_json``/``seq_from_json``. Host numpy, as in the counterpart.
Vectorized ``observe(values)`` over numpy columns (the write-path
StatUpdater analog); ``merge`` folds partials from distributed ingest;
``to_json``/``from_json`` round-trip for store metadata persistence.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _hash64(values: np.ndarray) -> np.ndarray:
    """Stable 64-bit hashes of arbitrary values (vectorized-ish)."""
    if values.dtype.kind in "iuf":
        # splitmix64 over the bit pattern
        h = values.astype(np.int64).view(np.uint64).copy()
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
        return h
    # strings/objects: vectorized FNV-1a over a fixed-width byte matrix
    # (the per-element blake2b loop made stats updates the fs-flush
    # bottleneck at bench scales). Rows longer than 256 bytes hash their
    # prefix -- fine for sketch-quality hashing.
    s = np.asarray(values, dtype="U")
    b = np.char.encode(s, "utf-8", "replace")
    if b.dtype.itemsize == 0:  # all-empty column
        return np.full(len(b), np.uint64(0xCBF29CE484222325))
    width = min(b.dtype.itemsize, 256)
    mat = np.frombuffer(
        np.ascontiguousarray(b).tobytes(), dtype=np.uint8
    ).reshape(len(b), b.dtype.itemsize)[:, :width]
    h = np.full(len(b), np.uint64(0xCBF29CE484222325))
    prime = np.uint64(0x100000001B3)
    live = np.ones(len(b), dtype=bool)
    for j in range(width):
        c = mat[:, j]
        live = live & (c != 0)  # S-dtype zero-pads; stop at first NUL
        h = np.where(live, (h ^ c.astype(np.uint64)) * prime, h)
    # final avalanche so short strings spread across the register space
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return h


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Exact vectorized bit_length for uint64 lanes."""
    x = x.astype(np.uint64).copy()
    bl = np.zeros(x.shape, dtype=np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> np.uint64(s)
        m = y != 0
        bl += np.where(m, np.uint64(s), np.uint64(0))
        x = np.where(m, y, x)
    return bl + (x != 0).astype(np.uint64)


class Stat:
    """Base: observe / merge / value / json."""

    def observe(self, values: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError

    def merge(self, other: "Stat") -> "Stat":  # pragma: no cover
        raise NotImplementedError

    def to_json(self) -> dict:  # pragma: no cover
        raise NotImplementedError


@dataclass
class CountStat(Stat):
    count: int = 0

    def observe(self, values):
        self.count += len(values)

    def merge(self, other):
        self.count += other.count
        return self

    def to_json(self):
        return {"type": "count", "count": self.count}


@dataclass
class MinMax(Stat):
    attr: str
    min: "float | None" = None
    max: "float | None" = None
    count: int = 0

    def observe(self, values):
        v = np.asarray(values)
        if len(v) == 0:
            return
        self.count += len(v)
        lo, hi = v.min(), v.max()
        lo = lo.item() if hasattr(lo, "item") else lo
        hi = hi.item() if hasattr(hi, "item") else hi
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def merge(self, other):
        if other.min is not None:
            self.observe(np.array([other.min, other.max]))
            self.count += other.count - 2
        return self

    def selectivity(self, lo, hi) -> float:
        """Fraction of rows expected in [lo, hi] under a uniform-range
        assumption (ref: stat-based attribute costing)."""
        if self.min is None or self.max is None:
            return 1.0
        span = float(self.max) - float(self.min)
        if span <= 0:
            return 1.0 if lo <= self.min <= hi else 0.0
        ov = min(float(hi), float(self.max)) - max(float(lo), float(self.min))
        return max(0.0, min(1.0, ov / span))

    def to_json(self):
        return {
            "type": "minmax",
            "attr": self.attr,
            "min": self.min,
            "max": self.max,
            "count": self.count,
        }


@dataclass
class Cardinality(Stat):
    """HyperLogLog distinct-count (ref Stat.Cardinality backed by HLL++)."""

    attr: str
    p: int = 12  # 2^12 registers -> ~1.6% error
    registers: np.ndarray = None

    def __post_init__(self):
        if self.registers is None:
            self.registers = np.zeros(1 << self.p, dtype=np.uint8)

    def observe(self, values):
        v = np.asarray(values)
        if len(v) == 0:
            return
        h = _hash64(v)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = h << np.uint64(self.p)
        # rank = leading zeros of the (64-p)-bit remainder + 1; exact
        # branchless bit_length (float log2 rounds at power-of-two edges)
        lz = np.uint64(64) - _bit_length(rest)
        rank = np.minimum(lz + np.uint64(1), np.uint64(64 - self.p + 1))
        np.maximum.at(self.registers, idx, rank.astype(np.uint8))

    def merge(self, other):
        np.maximum(self.registers, other.registers, out=self.registers)
        return self

    @property
    def estimate(self) -> float:
        m = float(len(self.registers))
        alpha = 0.7213 / (1 + 1.079 / m)
        inv = np.power(2.0, -self.registers.astype(np.float64))
        e = alpha * m * m / inv.sum()
        zeros = int((self.registers == 0).sum())
        if e <= 2.5 * m and zeros:
            e = m * np.log(m / zeros)  # linear counting for small n
        return float(e)

    def to_json(self):
        import base64

        return {
            "type": "cardinality",
            "attr": self.attr,
            "p": self.p,
            "registers": base64.b64encode(self.registers.tobytes()).decode(),
        }


@dataclass
class TopK(Stat):
    """Space-saving top-k heavy hitters (ref Stat.TopK)."""

    attr: str
    k: int = 10
    counters: dict = field(default_factory=dict)

    def observe(self, values):
        vals, counts = np.unique(np.asarray(values), return_counts=True)
        for v, c in zip(vals.tolist(), counts.tolist()):
            v = str(v)  # canonical str keys: survives the JSON round trip
            if v in self.counters:
                self.counters[v] += c
            elif len(self.counters) < self.k * 4:
                self.counters[v] = c
            else:
                victim = min(self.counters, key=self.counters.get)
                base = self.counters.pop(victim)
                self.counters[v] = base + c

    def merge(self, other):
        for v, c in other.counters.items():
            v = str(v)
            self.counters[v] = self.counters.get(v, 0) + c
        return self

    @property
    def topk(self):
        return sorted(self.counters.items(), key=lambda kv: -kv[1])[: self.k]

    def to_json(self):
        return {
            "type": "topk",
            "attr": self.attr,
            "k": self.k,
            "counters": {str(k): v for k, v in self.topk},
        }


@dataclass
class Frequency(Stat):
    """Count-min sketch (ref Stat.Frequency)."""

    attr: str
    depth: int = 4
    width: int = 1 << 12
    table: np.ndarray = None

    def __post_init__(self):
        if self.table is None:
            self.table = np.zeros((self.depth, self.width), dtype=np.int64)

    def observe(self, values):
        v = np.asarray(values)
        if len(v) == 0:
            return
        h = _hash64(v)
        for d in range(self.depth):
            # derive row hash: xor-fold with row-salt splitmix step
            salt = np.uint64((0x9E3779B97F4A7C15 * (d + 1)) & 0xFFFFFFFFFFFFFFFF)
            hd = h ^ salt
            idx = (hd % np.uint64(self.width)).astype(np.int64)
            np.add.at(self.table[d], idx, 1)

    def count(self, value) -> int:
        h = _hash64(np.array([value]))
        est = []
        for d in range(self.depth):
            salt = np.uint64((0x9E3779B97F4A7C15 * (d + 1)) & 0xFFFFFFFFFFFFFFFF)
            hd = h ^ salt
            est.append(int(self.table[d][int(hd[0] % np.uint64(self.width))]))
        return min(est)

    def merge(self, other):
        self.table += other.table
        return self

    def to_json(self):
        return {
            "type": "frequency",
            "attr": self.attr,
            "depth": self.depth,
            "width": self.width,
            "total": int(self.table[0].sum()),
            "table": self.table.tolist(),
        }


@dataclass
class Histogram(Stat):
    """Fixed-bin histogram over [lo, hi] (ref Stat.Histogram); values
    outside clip into the end bins."""

    attr: str
    bins: int
    lo: float
    hi: float
    counts: np.ndarray = None

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.bins, dtype=np.int64)

    def bin_of(self, values):
        v = np.asarray(values, dtype=np.float64)
        scale = self.bins / (self.hi - self.lo) if self.hi > self.lo else 0.0
        idx = np.floor((v - self.lo) * scale).astype(np.int64)
        return np.clip(idx, 0, self.bins - 1)

    def observe(self, values):
        v = np.asarray(values)
        if len(v) == 0:
            return
        np.add.at(self.counts, self.bin_of(v), 1)

    def merge(self, other):
        self.counts += other.counts
        return self

    def to_json(self):
        return {
            "type": "histogram",
            "attr": self.attr,
            "bins": self.bins,
            "lo": self.lo,
            "hi": self.hi,
            "counts": self.counts.tolist(),
        }


@dataclass
class Z3HistogramStat(Stat):
    """Coarse spatio-temporal occupancy histogram keyed by (bin, z-prefix)
    (ref Stat.Z3Histogram): drives spatial selectivity estimates."""

    geom_attr: str
    dtg_attr: str
    period: str = "week"
    prefix_bits: int = 12
    counts: dict = field(default_factory=dict)

    def observe_xyt(self, x, y, t_ms):
        from geomesa_tpu_torch.curves.binnedtime import TimePeriod, to_binned_time
        from geomesa_tpu_torch.curves.z3 import Z3SFC

        sfc = Z3SFC(TimePeriod.parse(self.period))
        b, off = to_binned_time(np.asarray(t_ms), self.period)
        z = sfc.index(x, y, off)
        self.observe_binned(b, z)

    def observe_binned(self, b, z):
        """Observe pre-encoded (bin, z) keys — the flush path already
        computed them for the sorted-index build; re-encoding 4M rows
        just for the histogram doubled the encode cost."""
        key = (np.asarray(b).astype(np.int64) << np.int64(self.prefix_bits)) | (
            np.asarray(z) >> np.uint64(63 - self.prefix_bits)
        ).astype(np.int64)
        if len(key) == 0:
            return
        # occupancy keys are COARSE (a few bins x 2^prefix_bits cells):
        # when the key span is small, bincount over the shifted range is
        # a single linear pass — np.unique sorts all n keys (~4s at 2^25)
        kmin = int(key.min())
        span = int(key.max()) - kmin + 1
        if span <= max(1 << 24, 4 * len(key)):
            cnts = np.bincount(key - kmin, minlength=span)
            nz = np.nonzero(cnts)[0]
            vals, cnts = nz + kmin, cnts[nz]
        else:  # pathological spread: fall back to sort-based unique
            vals, cnts = np.unique(key, return_counts=True)
        for k, c in zip(vals.tolist(), cnts.tolist()):
            self.counts[k] = self.counts.get(k, 0) + c

    def observe(self, values):  # pragma: no cover - use observe_xyt
        raise TypeError("Z3Histogram observes (x, y, t) triples")

    def merge(self, other):
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c
        return self

    def estimate(self, envelopes, t_intervals_ms) -> float:
        """Estimated rows intersecting any (envelope, time-interval) pair
        (ref: the stat-based side of StrategyDecider). Each occupancy
        cell's count is prorated by the fraction of its (lon, lat, time)
        box the query covers (uniform-within-cell assumption); disjoint
        query ranges SUM their per-cell coverage (clipped to 1)."""
        from geomesa_tpu_torch.curves.binnedtime import to_binned_time

        if not self.counts or not envelopes or not t_intervals_ms:
            return 0.0
        keys, cnts, bins, (cx0, cy0, ct0), (cw_x, cw_y, cw_t), mx_off, period = (
            self._cells()
        )
        # time fraction is envelope-independent: compute it once
        tf = np.zeros(len(keys), dtype=np.float64)
        for t0, t1 in t_intervals_ms:
            b0, o0 = to_binned_time(np.int64(t0), period)
            b1, o1 = to_binned_time(np.int64(t1), period)
            b0, o0 = int(b0), float(o0)
            b1, o1 = int(b1), float(o1)
            # per-bin offset window: full bins cover [0, mx_off]
            q0 = np.where(bins == b0, o0, 0.0)
            q1 = np.where(bins == b1, o1, mx_off)
            inside = (bins >= b0) & (bins <= b1)
            tf += np.where(inside, self._overlap(ct0, cw_t, q0, q1), 0.0)
        tf = np.clip(tf, 0.0, 1.0)
        sp = self._spatial_fraction(envelopes, cx0, cy0, cw_x, cw_y)
        return float((cnts * sp * tf).sum())

    def _cells(self):
        """Decode occupancy keys -> (keys, counts, bins, cx0, cy0, ct0) cell
        origins at the coarse grid resolution (shared by both estimators)."""
        from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset
        from geomesa_tpu_torch.curves.zorder import decode_3d_np

        period = TimePeriod.parse(self.period)
        mx_off = float(max_offset(period))
        bpd = self.prefix_bits // 3
        grid = 1 << bpd
        keys = np.fromiter(self.counts.keys(), dtype=np.int64)
        cnts = np.fromiter(self.counts.values(), dtype=np.float64)
        bins = keys >> np.int64(self.prefix_bits)
        prefix = (keys & np.int64((1 << self.prefix_bits) - 1)).astype(np.uint64)
        ix, iy, it = decode_3d_np(prefix << np.uint64(63 - self.prefix_bits))
        ix = (ix >> np.uint64(21 - bpd)).astype(np.int64)
        iy = (iy >> np.uint64(21 - bpd)).astype(np.int64)
        it = (it >> np.uint64(21 - bpd)).astype(np.int64)
        cw = (360.0 / grid, 180.0 / grid, mx_off / grid)
        origins = (
            -180.0 + ix * cw[0],
            -90.0 + iy * cw[1],
            it * cw[2],
        )
        return keys, cnts, bins, origins, cw, mx_off, period

    @staticmethod
    def _overlap(lo, width, q0, q1):
        return np.clip(
            np.minimum(lo + width, q1) - np.maximum(lo, q0), 0.0, width
        ) / width

    def _spatial_fraction(self, envelopes, cx0, cy0, cw_x, cw_y):
        sp = np.zeros(len(cx0), dtype=np.float64)
        for env, _ in envelopes:
            sp += self._overlap(cx0, cw_x, env.xmin, env.xmax) * self._overlap(
                cy0, cw_y, env.ymin, env.ymax
            )
        return np.clip(sp, 0.0, 1.0)

    def estimate_spatial(self, envelopes) -> float:
        """Estimated rows intersecting any envelope, time-marginalized
        (drives z2/xz2 costing with the same data-aware model as z3)."""
        if not self.counts or not envelopes:
            return 0.0
        _, cnts, _, (cx0, cy0, _), (cw_x, cw_y, _), _, _ = self._cells()
        sp = self._spatial_fraction(envelopes, cx0, cy0, cw_x, cw_y)
        return float((cnts * sp).sum())

    def to_json(self):
        return {
            "type": "z3histogram",
            "geom": self.geom_attr,
            "dtg": self.dtg_attr,
            "period": self.period,
            "prefix_bits": self.prefix_bits,
            "nonzero": len(self.counts),
            "total": sum(self.counts.values()),
            # full occupancy map: needed for the round-trip that feeds
            # reopened stores' stat-based planning. Parallel key/count
            # lists, not a dict -- a 100k-entry dict dominated the whole
            # manifest dump (json encodes dict items one at a time)
            "cell_keys": list(self.counts.keys()),
            "cell_counts": list(self.counts.values()),
        }


# -- JSON codec (store-metadata persistence; completes to_json round-trip) ---


def stat_from_json(d: dict):
    """Inverse of each Stat.to_json (used by store metadata persistence;
    no pickle: manifests are plain JSON an operator may edit)."""
    import base64

    t = d.get("type")
    if t == "count":
        return CountStat(count=int(d["count"]))
    if t == "minmax":
        return MinMax(d["attr"], d.get("min"), d.get("max"), int(d.get("count", 0)))
    if t == "cardinality":
        regs = np.frombuffer(
            base64.b64decode(d["registers"]), dtype=np.uint8
        ).copy()
        return Cardinality(d["attr"], int(d["p"]), regs)
    if t == "topk":
        s = TopK(d["attr"], int(d.get("k", 10)))
        s.counters = {k: int(v) for k, v in d.get("counters", {}).items()}
        return s
    if t == "histogram":
        s = Histogram(d["attr"], int(d["bins"]), float(d["lo"]), float(d["hi"]))
        s.counts = np.asarray(d["counts"], dtype=np.int64)
        return s
    if t == "frequency":
        st = Frequency(d["attr"], int(d.get("depth", 4)), int(d.get("width", 1 << 12)))
        if "table" in d:
            st.table = np.asarray(d["table"], dtype=np.int64)
        return st
    if t == "z3histogram":
        s = Z3HistogramStat(
            d["geom"],
            d["dtg"],
            d.get("period", "week"),
            int(d.get("prefix_bits", 12)),
        )
        if "cell_keys" in d:
            s.counts = dict(
                zip(map(int, d["cell_keys"]), map(int, d["cell_counts"]))
            )
        else:  # manifests written before the parallel-list format
            s.counts = {int(k): int(v) for k, v in d.get("cells", {}).items()}
        return s
    raise ValueError(f"unknown stat json type {t!r}")


def seq_from_json(items: list):
    from geomesa_tpu_torch.stats.dsl import SeqStat

    return SeqStat([stat_from_json(d) for d in items])
