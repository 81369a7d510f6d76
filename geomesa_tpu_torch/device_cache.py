"""Device-resident index: a type's scan planes pinned in GPU memory,
serving bbox+during count and query, density grids and stats, under
per-request authorizations.

Counterpart of ``DeviceIndex`` in ``geomesa_tpu/device_cache.py``, trimmed
to what the port has so far: full staging (attribute planes, the
envelope planes of non-point geometries, the key planes of z3/z2 point
schemas and xz3/xz2 non-point ones, and the visibility label-id plane
``__visid``), the loose key-only count and mask, the exact fused count and
mask, the host take with its residual predicates, and the
pushdown-aggregation hook ``_fused_agg`` with its two consumers,
``density`` (the density kernel; None for non-point schemas) and
``stats`` (Count/MinMax/Histogram as torch reductions). Uploads are plain per-plane
copies (the counterpart's packed transfer and thin-transfer tricks exist
for its remote link).

Key planes come in two layouts, chosen at staging as the counterpart
chooses them: the de-interleaved dim planes ``__znx/__zny/__zbt`` (the
dim-scan kernels) whenever the bins pack into the bt word, else -- with
``dim_planes=False``, or z3 data spanning too many period bins, such as
day bins over more than 2,047 days -- the interleaved Morton key
``__zhi/__zlo`` plus the z3 bin plane ``__zbin`` (the masked-compare
kernel). Both answer ``loose=True`` with the same cell-granular rows.
Non-point schemas stage the xz code in ``__zhi/__zlo`` (plus ``__zbin``
for xz3), encoded on the card, and answer ``loose=True`` from the range
masks of ``ops/zscan.py``; their exact answers come from the filter-scan
kernel over the envelope planes ``<geom>__x0/__y0/__x1/__y1`` plus the
host residual.

The AIS processes' entry points run on point schemas: ``knn`` (distance,
mask and selection in torch ops, ``ops/knn.py``) and
``window_union_query``/``bbox_window_query`` (the window-union mask,
``ops/window.py``); each ANDs in a base filter's mask from the
filter-scan kernel and the auth verdict.

The device query scheduler's fused loose paths (``fused_loose_counts``,
``fused_loose_query``) answer a group of compatible loose queries in one
launch of the batched dim-scan or interleaved-scan kernel.

``StreamingDeviceIndex`` keeps a live store's appends, evictions and
upserts resident without a restage: fixed-capacity buffers behind a bool
validity plane. Every scan above reads the subclass hooks
(``_host_rows``, ``_host_valid``, ``_device_valid``, ``_staged_len``):
each launch covers the staged rows only, and the count and mask kernels
(dim scan, interleaved scan, filter scan and both batched scans) take the
validity plane as an operand; density, kNN and the window union get it
through ``_and_seen``. Build one over a store, feed it through
``append``/``evict``/``upsert``/``refresh_delta`` or ``attach_live``
(Put, Remove, Clear messages of ``stream/log.py``), and query it as a
``DeviceIndex``.

The spatial join's coarse pass ``window_pairs_query`` (the pair pack of
``ops/window.py`` behind the base filter's scan kernel) and BIN output:
``bin_export``, the host twin over the scan kernels' mask, and
``bin_rider``, the device pack (``ops/binpack.py``) of a lane matrix
built once per staged generation (``_gen``, bumped by every staging and
eviction; the join engine's layout keys on it too).

A resident index stages from any store of the port through
:func:`_staging_query` (a ``BatchStore`` or a ``MemoryDataStore``); the
host sketches (Cardinality, TopK, Frequency, Z3Histogram) of ``stats``
observe the masked host rows.

The resident warmup (``warmup_plan``, ``warmup``) runs each kernel family
once before traffic, as the counterpart does; on the card that pays the
first use of each kernel library, the allocator's growth and the filter
scan's launch records, not a compile. Sharded indexes are not in the port
yet (ROADMAP item 7).
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

from geomesa_tpu_torch.bucketing import bucket_cap
from geomesa_tpu_torch.curves.binnedtime import (
    bin_to_millis,
    max_offset,
    offset_to_millis,
)
from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.keyplanes import encode_inputs, schema_kind
from geomesa_tpu_torch.ops import binpack
from geomesa_tpu_torch.ops import knn as knn_ops
from geomesa_tpu_torch.ops import zscan
from geomesa_tpu_torch.ops.density import density_grid, inverted
from geomesa_tpu_torch.ops.int64lanes import widen_u32
from geomesa_tpu_torch.ops.scan import stage_columns_host, to_tensor
from geomesa_tpu_torch.ops.window import group_words, pairs_pack, union_mask, widen
from geomesa_tpu_torch.security import VisibilityEvaluator
from geomesa_tpu_torch.stats.dsl import _observe_on_batch, parse_stat
from geomesa_tpu_torch.stats.sketches import CountStat, Histogram, MinMax

# reserved names of the de-interleaved key planes (a leading underscore
# cannot clash with attribute planes "<attr>" / "<attr>__suffix")
Z_NX, Z_NY, Z_BT = "__znx", "__zny", "__zbt"
# reserved names of the interleaved key planes: the Morton key's two words
# and (z3 only) the int32 period bin
Z_BIN, Z_HI, Z_LO = "__zbin", "__zhi", "__zlo"
# a loose window over more bins than this, or xz bounds of more words,
# takes the exact scan (the counterpart's cuts: past them the per-row cost
# outweighs the key scan's win)
_LOOSE_MAX_BINS = 64
_LOOSE_MAX_WORDS = 8192
# hits one ``torch.nonzero`` of a fused query's demux returns at most
# over a block of queries (int64 pairs: 256 MiB on the device)
_FUSED_HIT_PAIRS = 1 << 24
# reserved name of the visibility label-id plane: each row carries the id
# of its label expression in a small vocabulary; a per-request auth table
# gathers to a bool mask on the device
VIS_ID = "__visid"
_AUTH_TABLES_MAX = 256  # cached auth sets (request input: bounded)


class _VisOverflow(Exception):
    """The label vocabulary exceeded VIS_VOCAB_MAX."""


class _BtRebase(Exception):
    """A delta's period bins fall outside the window the staged bt plane
    is packed around: the bt plane repacks in a full restage."""


def _launch_faults() -> None:
    """The chaos points of a resident launch: ``fail.device.launch``, which
    every device launch evaluates (the store's runs too), and
    ``fail.resident.launch``, which only the resident index evaluates."""
    from geomesa_tpu_torch.failpoints import fail_point

    fail_point("fail.device.launch")
    fail_point("fail.resident.launch")


def _stageable_planes(sft: SimpleFeatureType) -> list:
    """Device plane names for every attribute the scan kernels can read."""
    planes: list = []
    for a in sft.attributes:
        if a.is_geometry:
            if a.is_point:
                planes += [f"{a.name}__x", f"{a.name}__y"]
            else:
                # non-point geometries: envelope planes (the device bbox and
                # the envelope prefilter of exact residual predicates)
                planes += [f"{a.name}__x0", f"{a.name}__y0",
                           f"{a.name}__x1", f"{a.name}__y1"]
            continue
        dtype = a.column_dtype
        if dtype == np.int64:
            planes += [f"{a.name}__hi", f"{a.name}__lo"]
        elif dtype in (np.float32, np.float64, np.int32):
            planes.append(a.name)
    return planes


def _z_planes_np(batch, sft: SimpleFeatureType):
    """(kind, planes, bins) of the interleaved key layout through the HOST
    encode (``sfc.index``): the oracle the card's staging encode must
    equal. Planes are numpy: ``__zhi/__zlo`` uint32, ``__zbin`` int32 for
    binned kinds."""
    kind, sfc = schema_kind(sft)
    if kind is None:
        return None, {}, None
    coords, bins = encode_inputs(batch, kind, sfc, sft.geom_field, sft.dtg_field)
    code = np.asarray(sfc.index(*coords)).astype(np.uint64)
    planes = {
        Z_HI: (code >> np.uint64(32)).astype(np.uint32),
        Z_LO: (code & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    }
    if bins is not None:
        planes[Z_BIN] = np.asarray(bins, np.int32)
    return kind, planes, bins


def _staging_query():
    """The resident index's staging scan (the counterpart's
    ``device_cache.py:171``): every row, visibility labels kept raw (the
    index enforces each request's auths itself through its label-id
    plane), exempt from user-facing caps. Never a user-facing query."""
    from geomesa_tpu_torch.query.plan import Query

    return Query(filter=ast.Include, hints={"internal": True, "raw_visibility": True})


class DeviceIndex:
    """Resident scan cache over one store type.

    >>> di = DeviceIndex(BatchStore(batch), "gdelt", z_planes=True)
    >>> di.count("BBOX(geom, -10, 35, 30, 60) AND dtg DURING ...")
    >>> di.count(..., loose=True)   # key planes only, cell granularity
    >>> batch = di.query(...)        # mask on device, take on host
    >>> grid = di.density(..., Envelope(-180, -90, 180, 90), 512, 256)
    >>> seq = di.stats(..., 'Count();MinMax("count")')

    With ``z_planes=True`` the key planes stay resident too, and
    ``loose=True`` answers bbox(+during) filters from them at cell
    granularity: a superset of the exact answer (GeoMesa's loose-bbox
    mode). Without key planes ``loose=True`` answers exactly, as in the
    counterpart. ``dim_planes`` picks the key layout: None (the default)
    stages dim planes when the bins pack and the interleaved key
    otherwise, False always the interleaved key, True dim planes or a
    ``ValueError``. With ``loose=None`` a call reads the
    ``query.loose.bbox`` property (off by default). ``columns`` names the
    attribute planes to stage (default: every plane the scans can read);
    a filter over a plane left out is evaluated on the host. Runs on
    ``cuda:0`` unless ``device`` says otherwise; ``device="cpu"`` runs
    the kernels' plain versions on the host.

    Visibility (per-auth resident serving, ref Accumulo cell visibility):
    staging keeps EVERY row plus a compact label-id plane (the distinct
    label expressions form a vocabulary capped at ``VIS_VOCAB_MAX``). Each
    request's auths evaluate the vocabulary once on the host into a bool
    table; the device gathers it by label id and ANDs it into the hit
    mask. No auths (the default) hides labeled rows: fail closed, the
    store semantics. If the vocabulary overflows the cap, labeled rows are
    dropped from the resident copy (served by the store path only) with a
    warning.
    """

    #: distinct visibility expressions the resident cache will track
    VIS_VOCAB_MAX = 4096
    #: 64-window groups per pass of ``window_pairs_query``
    PAIRS_GROUPS_PER_DISPATCH = 8

    #: the staged generation: bumped by every staging (an install or a
    #: delta) and every eviction, so caches built over the staged rows (the
    #: join layout, the BIN lane matrix) key on it and rebuild after a change
    _gen = 0
    #: the join engine's layout over these rows (``join/engine.py``), tagged
    #: with the generation it was built for
    _join_index = None

    def __init__(
        self,
        store,
        type_name: str,
        columns: "list[str] | None" = None,
        z_planes: bool = False,
        dim_planes: "bool | None" = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.store = store
        self.type_name = type_name
        self.sft = store.get_schema(type_name)
        self._planes = list(columns) if columns else _stageable_planes(self.sft)
        self._want_z = z_planes
        self._dim_pref = dim_planes
        self._reset_vis()
        self._reset()
        self.refresh()

    def _reset(self) -> None:
        self._z_kind = None
        self._dim_mode = False  # key layout: dim planes (True) or interleaved
        self._bin_range = None  # (min, max) period bins staged
        self._bt_base = None  # bin_base the bt plane is packed around
        self._host_batch = None
        self._cols: dict = {}
        self._compiled: dict = {}  # repr(filter) -> CompiledFilter
        self._loose_cache: dict = {}  # repr(filter) -> _loose_bounds result
        self._visid_np = None  # host mirror of the VIS_ID plane
        self._bin_lanes: dict = {}  # BIN lane matrix of the latest generation

    def _reset_vis(self) -> None:
        """Vocabulary state; like the counterpart's it outlives a refresh,
        so label ids stay stable across restages."""
        self._vis_vocab: "dict | None" = None  # label expr -> id
        self._vis_disabled = False  # vocabulary overflowed: public-only
        self._auth_tables: dict = {}  # sorted auths -> (host, device) table

    @classmethod
    def from_planes(
        cls,
        sft: SimpleFeatureType,
        host_batch,
        planes: dict,
        bt_base: "int | None",
        bin_range: "tuple | None",
        device=None,
        vis_vocab: "dict | None" = None,
    ) -> "DeviceIndex":
        """Serve from planes staged elsewhere (``convert.planes_from_numpy``
        of the counterpart's ``_cols``): the same resident state, so the
        same answers. ``host_batch`` is the row-aligned host mirror;
        ``vis_vocab`` is the counterpart's ``_vis_vocab`` (label -> id),
        required exactly when the planes hold ``__visid``."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.store = None
        self.type_name = sft.type_name
        self.sft = sft
        self._planes = _stageable_planes(sft)
        self._want_z = Z_NX in planes or Z_HI in planes
        self._dim_pref = None
        self._reset_vis()
        self._reset()
        n = len(host_batch)
        for k, t in planes.items():
            if t.device != self.device or t.dim() != 1 or t.shape[0] != n:
                raise ValueError(
                    f"plane {k}: expected 1-D of {n} rows on {self.device}"
                )
        missing = [p for p in self._planes if p not in planes]
        if missing:
            raise ValueError(f"planes {missing} missing")
        self._host_batch = host_batch
        self._cols = dict(planes)
        if (VIS_ID in planes) != (vis_vocab is not None):
            raise ValueError(f"a {VIS_ID} plane and vis_vocab come together")
        if vis_vocab is not None:
            ids = planes[VIS_ID].cpu().numpy()
            if ids.dtype != np.int32 or (n and not 0 <= ids.min() <= ids.max() < len(vis_vocab)):
                raise ValueError(f"{VIS_ID} must hold int32 ids of the vocabulary")
            self._vis_vocab = dict(vis_vocab)
            self._visid_np = ids
        if self._want_z:
            kind, _ = schema_kind(sft)
            self._dim_mode = Z_NX in planes
            if self._dim_mode:
                want = (Z_NX, Z_NY, Z_BT) if kind == "z3" else (Z_NX, Z_NY)
            else:
                want = (Z_BIN, Z_HI, Z_LO) if kind in ("z3", "xz3") else (Z_HI, Z_LO)
            if kind is None or any(p not in planes for p in want):
                raise ValueError(f"key planes {want} missing for a {kind} schema")
            self._z_kind = kind
            self._bt_base = None if bt_base is None else int(bt_base)
            self._bin_range = None if bin_range is None else tuple(int(b) for b in bin_range)
        return self

    # -- staging -----------------------------------------------------------

    def refresh(self) -> None:
        """Re-stage from the backing store (after writes) through
        :func:`_staging_query`."""
        if self.store is None:
            raise RuntimeError("an index built from planes has no store")
        res = self.store.query(self.type_name, _staging_query())
        self._reset()
        self._host_batch, self._cols = self._stage_checked(res.batch)

    def refresh_delta(self, batch) -> str:
        """Fold freshly appended rows into the resident planes. This index
        has no validity plane or capacity headroom, so its move is a full
        restage from the store; ``StreamingDeviceIndex`` appends in place.
        Returns the mode taken (``"delta"`` / ``"restage"``) and counts it
        on ``geomesa_stream_delta_refreshes_total``."""
        from geomesa_tpu_torch import metrics

        self.refresh()
        metrics.stream_delta_refreshes.inc(mode="restage")
        return "restage"

    def attach_live(self, live_store):
        """Restage on every change a live layer applies (``live_store``
        has ``add_listener``, and may have ``remove_listener``). Returns a
        callable of no arguments that detaches the listener."""
        listener = lambda _msg: self.refresh()  # noqa: E731
        return _attach(live_store, listener)

    def _stage_checked(self, batch):
        """(batch, cols) with the vocabulary-overflow route, decided on the
        host before anything is staged: on overflow, per-auth residency is
        disabled and labeled rows are dropped from the resident copy (the
        store path still serves them), loudly."""
        try:
            ids = self._vis_ids(batch)
        except _VisOverflow:
            warnings.warn(
                f"visibility vocabulary exceeds {self.VIS_VOCAB_MAX} "
                "distinct labels; labeled rows leave the resident cache "
                "and are served by the store path only",
                RuntimeWarning,
                stacklevel=3,
            )
            self._vis_disabled = True
            self._vis_vocab = None
            self._auth_tables.clear()
            keep = np.array(
                [v is None or str(v) == "" for v in batch.visibilities], dtype=bool
            )
            batch = batch.take(np.nonzero(keep)[0])
            ids = self._vis_ids(batch)
        cols = self._stage_batch(batch)
        if ids is not None:
            cols[VIS_ID] = self._up(ids)
        self._visid_np = ids
        return batch, cols

    # -- visibility plane --------------------------------------------------

    def _vis_ids(self, batch) -> "np.ndarray | None":
        """int32 label ids of a batch (extends the vocabulary; raises
        _VisOverflow past VIS_VOCAB_MAX), or None when no label was ever
        seen: pure-public schemas stage no plane at all."""
        vis = batch.visibilities
        norm = None
        if vis is not None:
            norm = np.array(["" if v is None else str(v) for v in vis], dtype=object)
        labeled = norm is not None and bool(np.any(norm != ""))
        if self._vis_disabled:
            if labeled:
                raise _VisOverflow()
            return None
        if self._vis_vocab is None:
            if not labeled:
                return None
            self._vis_vocab = {"": 0}
        if norm is None:
            return np.zeros(len(batch), np.int32)
        return self._vocab_ids(norm)

    def _vocab_ids(self, labels: np.ndarray) -> np.ndarray:
        uniq, inv = np.unique(labels.astype(str), return_inverse=True)
        mapped = np.empty(len(uniq), np.int32)
        grew = False
        for i, lab in enumerate(uniq.tolist()):
            vid = self._vis_vocab.get(lab)
            if vid is None:
                if len(self._vis_vocab) >= self.VIS_VOCAB_MAX:
                    raise _VisOverflow()
                vid = len(self._vis_vocab)
                self._vis_vocab[lab] = vid
                grew = True
            mapped[i] = vid
        if grew:
            self._auth_tables.clear()  # tables are per-vocabulary
        return mapped[inv.reshape(-1)].astype(np.int32)

    def _auth_table(self, auths) -> tuple:
        """(host, device) bool tables over the vocabulary for one auth set:
        entry v is True iff label v is visible under ``auths`` (None/() =
        no authorizations: labeled rows hide, fail closed). Padded to a
        power of two of at least 16, as the counterpart pads its jit
        shapes; at most 256 auth sets are cached, since they come straight
        from request input."""
        key = tuple(sorted(str(a) for a in (auths or ())))
        tab = self._auth_tables.get(key)
        if tab is None:
            if len(self._auth_tables) >= _AUTH_TABLES_MAX:
                self._auth_tables.clear()
            vals = np.zeros(bucket_cap(len(self._vis_vocab), floor=16), dtype=bool)
            ev = VisibilityEvaluator(auths or ())
            for lab, vid in self._vis_vocab.items():
                vals[vid] = ev.can_see(lab if lab else None)
            tab = (vals, torch.from_numpy(vals).to(self.device))
            self._auth_tables[key] = tab
        return tab

    def _apply_auths_np(self, m: np.ndarray, auths) -> np.ndarray:
        """Host-side auth AND over a hit mask (the mask/query path; the
        fused paths apply the same table on the device)."""
        if self._visid_np is None:
            return m
        return m & self._auth_table(auths)[0][self._visid_np[: len(m)]]

    #: stage through pinned, non-blocking copies (a streaming index's
    #: deltas); full stagings copy from pageable memory
    _pin_uploads = False

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the index's device, bits unchanged, on
        the current stream. With ``_pin_uploads`` on a card the copy goes
        through pinned memory without a host synchronisation (PyTorch's
        pinned allocator keeps the block until the copy has run)."""
        if not (self._pin_uploads and self.device.type == "cuda"):
            return to_tensor(a, self.device)
        t = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
        return t.to(self.device, non_blocking=True)

    def _stage_batch(self, batch) -> dict:
        """Attribute planes + (optionally) key planes for a batch. The key
        layout is decided when nothing is staged yet (``_bin_range`` None:
        an install); a delta keeps it and packs its bt words around the
        staged base (:class:`_BtRebase` when they do not fit). Widens the
        staged bin range and bumps the staged generation."""
        self._gen += 1
        host = stage_columns_host(batch, self._planes)
        cols = {k: self._up(v) for k, v in host.items()}
        if not self._want_z:
            return cols
        kind, sfc = schema_kind(self.sft)
        if kind is None:
            return cols
        coords, bins = encode_inputs(
            batch, kind, sfc, self.sft.geom_field, self.sft.dtg_field
        )
        if self._bin_range is None:
            self._dim_mode = self._dim_usable(kind, sfc, bins)
        self._z_kind = kind
        if not self._dim_mode:
            cols.update(self._interleaved_planes(sfc, coords, bins))
        elif kind == "z2":
            cols.update(self._dim_planes_z2(sfc, coords))
        else:
            cols.update(self._dim_planes_for(sfc, coords, bins))
        if kind in ("z3", "xz3") and len(batch):
            lo, hi = int(bins.min()), int(bins.max())
            rng = (lo, hi) if self._bin_range is None else (
                min(self._bin_range[0], lo), max(self._bin_range[1], hi))
            if rng != self._bin_range:
                self._bin_range = rng
                self._loose_cache.clear()  # entries keyed on the old range
        return cols

    def _dim_usable(self, kind, sfc, bins) -> bool:
        """Whether the dim-plane layout packs: not with ``dim_planes=False``
        or for a non-point kind (xz codes take the interleaved planes); z2
        always; z3 with 21-bit time precision
        and a bin span inside the packable window (top bin reserved for the
        out-of-range sentinel)."""
        if self._dim_pref is False or kind not in ("z3", "z2"):
            if self._dim_pref is True:
                raise ValueError("dim_planes=True requires a z3/z2 (point) schema")
            return False
        if kind == "z2":
            return True
        if sfc.precision != zscan.BT_TIME_BITS:
            if self._dim_pref is True:
                raise ValueError(
                    f"dim_planes=True requires time precision "
                    f"{zscan.BT_TIME_BITS} (got {sfc.precision})"
                )
            return False
        if bins is None or len(bins) == 0:
            return True
        span_ok = int(bins.max()) - int(bins.min()) < zscan.BT_BIN_SPAN - 1
        if not span_ok and self._dim_pref is True:
            raise ValueError(
                f"dim_planes=True but the data spans >= {zscan.BT_BIN_SPAN - 1} "
                "period bins; the bt word cannot pack them"
            )
        return span_ok

    def _quantize(self, dim, values: np.ndarray) -> torch.Tensor:
        # float64 on the device: the counterpart quantizes under scoped x64
        return dim.normalize_t(self._up(values))

    def _dim_planes_z2(self, sfc, coords) -> dict:
        x, y = coords
        return {
            Z_NX: zscan._u32(self._quantize(sfc.lon, x)),
            Z_NY: zscan._u32(self._quantize(sfc.lat, y)),
        }

    def _interleaved_planes(self, sfc, coords, bins) -> dict:
        """{Z_HI, Z_LO} (+ Z_BIN for binned kinds): the Morton key or the
        xz code encoded on the device (float64 math, bit for bit the host
        ``sfc.index``) and the int32 period bins."""
        hi, lo = sfc.index_hi_lo(
            *(self._up(np.asarray(c, np.float64)) for c in coords)
        )
        planes = {Z_HI: hi, Z_LO: lo}
        if bins is not None:
            planes[Z_BIN] = self._up(np.asarray(bins, np.int32))
        return planes

    def _dim_planes_for(self, sfc, coords, bins) -> dict:
        if bins is None or len(bins) == 0:
            e = torch.empty(0, dtype=torch.uint32, device=self.device)
            return {Z_NX: e, Z_NY: e.clone(), Z_BT: e.clone()}
        lo, hi = int(bins.min()), int(bins.max())
        if self._bt_base is None:
            self._bt_base = lo  # the first non-empty batch sets the base
        if lo < self._bt_base or hi - self._bt_base >= zscan.BT_BIN_SPAN - 1:
            raise _BtRebase()
        x, y, off = coords
        nx, ny, bt = zscan.z3_dim_planes(
            sfc,
            self._quantize(sfc.lon, x),
            self._quantize(sfc.lat, y),
            self._quantize(sfc.time, off),
            self._up(np.asarray(bins, np.int64)),
            self._bt_base,
        )
        return {Z_NX: nx, Z_NY: ny, Z_BT: bt}

    def __len__(self) -> int:
        return len(self._host_batch)

    @property
    def nbytes(self) -> int:
        """Resident device bytes."""
        return int(sum(t.numel() * t.element_size() for t in self._cols.values()))

    # -- subclass hooks ------------------------------------------------------

    def _host_rows(self):
        """Host mirror aligned row for row with the device planes."""
        return self._host_batch

    def _host_valid(self) -> "np.ndarray | None":
        """Validity over the host mirror's rows; None: every row live."""
        return None

    def _device_valid(self) -> "torch.Tensor | None":
        """The bool validity plane over the staged rows, the operand of
        every count and mask launch; None: every row live."""
        return None

    def _staged_len(self) -> int:
        """Rows staged on the device (live and dead)."""
        return len(self._host_batch)

    # -- loose (key-only) scans --------------------------------------------

    def _bbox_during_parts(self, f):
        """(envelope, window) when the filter is EXACTLY a bbox on the
        default geometry, a during on the default date, or both ANDed --
        the only shapes the key planes answer; else None."""
        geom, dtg = self.sft.geom_field, self.sft.dtg_field
        parts = f.children if isinstance(f, ast.And) else (f,)
        env = window = None
        for p in parts:
            if isinstance(p, ast.BBox) and p.attr == geom and env is None:
                env = (p.xmin, p.ymin, p.xmax, p.ymax)
            elif isinstance(p, ast.During) and p.attr == dtg and window is None:
                window = (int(p.t0), int(p.t1))
            else:
                return None
        return env, window

    def _loose_bounds(self, f):
        """How the key planes answer the filter, or None when they cannot:
        ``("dim", qarr, R)`` for the dim scan (R = 0: the 2-plane z2 scan),
        ``("zscan", bounds, ids, (count_fn, mask_fn))`` for the interleaved
        scan and ``("xz", bounds, ids, (count_fn, mask_fn))`` for the xz
        range masks (``ids`` None for the unbinned z2 and xz2). Cached per
        filter."""
        key = repr(f)
        if key not in self._loose_cache:
            self._loose_cache[key] = self._loose_bounds_uncached(f)
        return self._loose_cache[key]

    def _loose_bounds_uncached(self, f):
        if self._z_kind is None:
            return None
        parts = self._bbox_during_parts(f)
        if parts is None:
            return None
        env, window = parts
        if env is None and window is None:
            return None  # INCLUDE: nothing to prune, use the normal path
        _, sfc = schema_kind(self.sft)
        if self._z_kind == "z2":
            if window is not None:
                return None  # no time in the key
            if self._dim_mode:
                return "dim", zscan.z2_dim_plane_qarr(sfc, env), 0
            qlo = (int(sfc.lon.normalize(env[0])), int(sfc.lat.normalize(env[1])))
            qhi = (int(sfc.lon.normalize(env[2])), int(sfc.lat.normalize(env[3])))
            bounds = zscan.z2_dim_bounds(qlo, qhi)
            return "zscan", bounds, None, zscan.build_z2_zscan(bounds)
        if self._z_kind == "xz2":
            if window is not None:
                return None  # no time in the key
            bounds = zscan.pad_ranges(zscan.xz2_query_bounds(sfc, *env))
            return "xz", bounds, None, zscan.build_xz_scan(bounds, None)
        if env is None:
            env = (-180.0, -90.0, 180.0, 90.0)
        if window is None:
            if self._bin_range is None:
                return None  # empty index; the normal path returns empty too
            p = sfc.period
            window = (
                int(bin_to_millis(self._bin_range[0], p)),
                int(bin_to_millis(self._bin_range[1], p))
                + int(offset_to_millis(max_offset(p), p)),
            )
        if not self._dim_mode:
            return self._binned_bounds(sfc, env, window)
        if self._bt_base is None:
            return None  # nothing staged; the normal path returns empty too
        q = zscan.z3_dim_plane_qarr(sfc, env, window, self._bt_base, self._bin_range)
        return None if q is None else ("dim", *q)

    def _binned_bounds(self, sfc, env, window):
        """The binned key scan's entry -- the interleaved z3 scan, or the
        xz3 range masks: one bound set per staged bin of the window; an
        empty window becomes one never-matching padded entry. None past 64
        bins or 8192 bound words, and for a window over a bin before 1970
        (both scans read a negative id as padding and would lose that
        bin's rows): the exact scan answers those."""
        xz = self._z_kind == "xz3"
        build = zscan.xz3_query_bounds if xz else zscan.z3_query_bounds
        bounds, ids = build(sfc, *env, *window)
        if self._bin_range is not None:
            keep = (ids >= self._bin_range[0]) & (ids <= self._bin_range[1])
            bounds, ids = bounds[keep], ids[keep]
        if (ids < 0).any():
            return None
        if len(ids) == 0:
            bounds = (
                np.broadcast_to(zscan._NEVER_RANGE, (1, 1, 4)).copy()
                if xz else np.zeros((1, 3, 6), np.uint32)
            )
            ids = np.full(1, -1, np.int32)
        if len(ids) > _LOOSE_MAX_BINS or bounds.size > _LOOSE_MAX_WORDS:
            return None
        bounds, ids = zscan.pad_bins(bounds, ids)
        if xz:
            return "xz", bounds, ids, zscan.build_xz_scan(bounds, ids)
        return "zscan", bounds, ids, zscan.build_z3_pallas_scan(bounds, ids)

    def _loose_args(self, lb) -> tuple:
        """(count_fn, mask_fn, operands) for a ``_loose_bounds`` result: the
        one place that pairs a loose scan with its resident planes, so
        ``count``, ``mask``, ``_fused_agg`` and ``loose_scan_kernel`` run the
        same kernel. Both functions take the planes and ``valid=``."""
        if lb[0] == "dim":
            _, qarr, r = lb
            ops = (self._cols[Z_NX], self._cols[Z_NY])
            if r:
                ops += (self._cols[Z_BT],)
            return partial(zscan.dimscan_count, qarr), partial(zscan.dimscan_mask, qarr), ops
        _, _, ids, (count_fn, mask_fn) = lb
        ops = (self._cols[Z_HI], self._cols[Z_LO])
        if ids is not None:
            ops = (self._cols[Z_BIN],) + ops
        return count_fn, mask_fn, ops  # "zscan" and "xz": one operand order

    def _resolve_loose(self, loose: "bool | None") -> bool:
        if loose is None:
            from geomesa_tpu_torch.conf import sys_prop

            loose = bool(sys_prop("query.loose.bbox"))
        return bool(loose) and self._z_kind is not None

    # -- queries -----------------------------------------------------------

    def _parse(self, query) -> ast.Filter:
        from geomesa_tpu_torch.filter.ecql import parse_ecql

        if isinstance(query, str):
            return parse_ecql(query)
        if isinstance(query, ast.Filter):
            return query
        raise TypeError(
            "DeviceIndex takes a CQL string or filter AST; pass auths= "
            "explicitly (a Query object is the store path's plumbing)"
        )

    def _compiled_for(self, f):
        from geomesa_tpu_torch.filter.compile import compile_filter

        key = repr(f)
        if key not in self._compiled:
            self._compiled[key] = compile_filter(f, self.sft)
        return self._compiled[key]

    def _resident(self, compiled) -> bool:
        """Whether every plane the filter's device part reads is staged (a
        ``columns=`` list may leave some out: the host evaluates those
        filters)."""
        return all(c in self._cols for c in compiled.device_cols)

    def _resident_subset(self, compiled) -> dict:
        return {c: self._cols[c] for c in compiled.device_cols}

    def _host_mask(self, compiled) -> np.ndarray:
        """The filter over the host mirror, dead rows False."""
        m = compiled.host_mask(self._host_rows())
        hv = self._host_valid()
        return m if hv is None else m & hv

    def count(self, query, loose: "bool | None" = None, auths=None) -> int:
        """Fused device count; exact when the filter is fully on device,
        else it falls through to query(). With loose=True (or, for
        loose=None, the ``query.loose.bbox`` property) bbox(+during)
        filters are answered at cell granularity from the key planes.
        ``auths`` applies per-request row security against the staged
        label-id plane (None/() hides labeled rows: fail closed)."""
        _launch_faults()  # chaos: resident count launch
        f = self._parse(query)
        if VIS_ID in self._cols:
            # labeled data: the auth table must AND into the device mask
            if self._staged_len() == 0:
                return 0
            n = self._fused_agg(f, loose, lambda cols, m: int(m.sum()), auths=auths)
            if n is not None:
                return n
            return int(self.mask(f, loose=loose, auths=auths).sum())
        dv = self._device_valid()
        if self._resolve_loose(loose):
            lb = self._loose_bounds(f)
            if lb is not None:
                count_fn, _, ops = self._loose_args(lb)
                return int(count_fn(*ops, valid=dv))
        compiled = self._compiled_for(f)
        if not compiled.device_cols or not self._resident(compiled):
            return int(self._host_mask(compiled).sum())
        if not compiled.fully_on_device:
            return len(self.query(f))
        return int(compiled.count(self._resident_subset(compiled), valid=dv))

    def mask(self, query, loose: "bool | None" = None, auths=None) -> np.ndarray:
        """Boolean hit mask over the staged rows (host array); dead rows
        (evicted, in a streaming index) are False. When a label-id plane
        is staged, the per-request ``auths`` verdict is ANDed in (fail
        closed on None/())."""
        _launch_faults()  # chaos: resident scan launch
        f = self._parse(query)
        dv = self._device_valid()
        if self._resolve_loose(loose):
            lb = self._loose_bounds(f)
            if lb is not None:
                _, mask_fn, ops = self._loose_args(lb)
                return self._apply_auths_np(mask_fn(*ops, valid=dv).cpu().numpy(), auths)
        compiled = self._compiled_for(f)
        if not compiled.device_cols or not self._resident(compiled):
            return self._apply_auths_np(self._host_mask(compiled), auths)
        m = compiled.mask(self._resident_subset(compiled), valid=dv).cpu().numpy()
        if not compiled.fully_on_device:
            idx = np.nonzero(m)[0]
            out = np.zeros(len(m), dtype=bool)
            if len(idx):
                keep = compiled.residual_mask(self._host_rows().take(idx))
                out[idx[keep]] = True
            m = out
        return self._apply_auths_np(m, auths)

    def query(self, query, loose: "bool | None" = None, auths=None):
        """FeatureBatch of hits (host-side take over the device mask)."""
        return self._host_rows().take(
            np.nonzero(self.mask(query, loose=loose, auths=auths))[0]
        )

    def loose_scan_kernel(self, query):
        """(count_fn, operands): the kernel wrapper and resident planes that
        ``count(query, loose=True)`` launches, so a benchmark can time the
        serving path's own kernel. None when the key planes cannot answer
        the filter or a validity or label-id plane would change the
        result."""
        lb = self._loose_bounds(self._parse(query))
        if lb is None or self._device_valid() is not None or VIS_ID in self._cols:
            return None
        count_fn, _, ops = self._loose_args(lb)
        return count_fn, ops

    # -- pushdown aggregation (StatsIterator / DensityIterator analogs) ----

    def _device_mask(self, f, loose):
        """The filter's mask on the device as a function of no arguments
        that launches it (and returns None for INCLUDE: every row), or None
        when the filter is not fully on the device. Nothing launches here."""
        dv = self._device_valid()
        lb = self._loose_bounds(f) if self._resolve_loose(loose) else None
        if lb is not None:
            _, mask_fn, ops = self._loose_args(lb)
            return lambda: mask_fn(*ops, valid=dv)
        if f is ast.Include and self._cols:
            return lambda: None
        compiled = self._compiled_for(f)
        if not (compiled.device_cols and compiled.fully_on_device and self._resident(compiled)):
            return None
        return lambda: compiled.mask(self._resident_subset(compiled), valid=dv)

    def _fused_agg(self, f, loose, agg_build, auths=None):
        """The pushdown-aggregation hook: the filter mask, computed next to
        the data, handed to an aggregation over the resident planes --
        ``agg_build(cols, mask)``, whose result is returned. The mask is
        the loose key scan (``loose=True`` and a filter the key planes
        answer: the dim scan or the interleaved scan), None for INCLUDE
        (every row; the consumer skips the read), or the exact filter scan (the filter-scan kernel, or the plain
        ``device_fn`` for a filter the encoder refuses), each launch reading
        the validity plane; with a label-id plane staged, the auth verdict
        gathered by label id is ANDed in.
        Returns None when the filter is not fully on the device: the caller
        then takes its host path. The counterpart jits one dispatch per
        (filter, kind, aggregation); PyTorch runs eagerly, so only the
        filter's compiled program is cached (per ``repr(f)``)."""
        _launch_faults()  # chaos: fused-agg launch
        mask = self._device_mask(f, loose)
        if mask is None:
            return None
        return agg_build(self._cols, self._and_seen(mask(), auths))

    def _and_seen(self, m, auths):
        """The rows a request sees: mask ``m`` -- None for every staged
        row, else a mask whose launch already read the validity plane --
        with, for None, the validity plane (when one is staged), ANDed with
        the per-request auth verdict gathered by label id (when a label-id
        plane is staged). The one place the aggregations, kNN and the
        window union take validity and auths."""
        if m is None:
            m = self._device_valid()
        if VIS_ID not in self._cols:
            return m
        seen = self._auth_table(auths)[1][self._cols[VIS_ID]]
        return seen if m is None else m & seen

    def stats(self, query, spec: str, loose: "bool | None" = None, auths=None):
        """Stat-DSL aggregation on the pushdown hook (ref StatsIterator:
        stats computed next to the data, never shipping features). Count,
        MinMax over resident numeric/date planes and fixed-bin Histogram
        over resident planes reduce on the device; any other stat observes
        the masked host rows. A filter that is not fully on the device
        falls back to host observation entirely.

        Precision: MinMax over a float attribute reflects the device
        storage type, float32 (the counterpart's is float64 on the CPU).
        Date (int64) MinMax is exact through the lexicographic hi/lo
        reduction; Histogram bins in float64, as the counterpart does
        under x64."""
        seq = parse_stat(spec)
        f = self._parse(query)
        device_parts, host_parts = [], []
        for s in seq.stats:
            if isinstance(s, CountStat):
                device_parts.append(("count", s))
            elif isinstance(s, MinMax) and (
                s.attr in self._cols or f"{s.attr}__hi" in self._cols
            ):
                device_parts.append(("minmax", s))
            elif isinstance(s, Histogram) and s.attr in self._cols:
                device_parts.append(("hist", s))  # every plane is numeric
            else:
                host_parts.append(s)
        if self._staged_len() == 0:
            return seq  # nothing staged: zero-size reductions have no identity
        outs = self._fused_agg(
            f, loose,
            lambda cols, m: self._stats_reduce(cols, m, device_parts, bool(host_parts)),
            auths=auths,
        )
        if outs is None:  # filter not fully on the device
            seq.observe_batch(self.query(f, loose=loose, auths=auths))
            return seq
        n_hits = outs["__count"]
        for i, (tag, s) in enumerate(device_parts):
            if tag == "count":
                s.count += n_hits
            elif tag == "minmax" and n_hits:
                s.count += n_hits
                mn, mx = outs[i]
                s.min = mn if s.min is None else min(s.min, mn)
                s.max = mx if s.max is None else max(s.max, mx)
            elif tag == "hist":
                s.counts += outs[i]
        if host_parts:
            # the fused mask already evaluated the filter: reuse it
            rows = self._host_rows().take(np.nonzero(outs["__mask"])[0])
            for s in host_parts:
                _observe_on_batch(s, rows)
        return seq

    def _stats_reduce(self, cols, m, device_parts, need_mask) -> dict:
        """The device reductions of :meth:`stats` over mask ``m`` (None:
        every row), keyed by part index (two stats over one attribute must
        not share a slot): (min, max) for MinMax, the int64 bin counts for
        Histogram; ``__count`` always, ``__mask`` (host) for host parts."""
        n = self._staged_len()
        out: dict = {"__count": n if m is None else int(m.sum())}
        if need_mask:
            out["__mask"] = np.ones(n, bool) if m is None else m.cpu().numpy()

        def masked(v, sel, fill):
            return v if sel is None else torch.where(sel, v, fill)

        for i, (tag, s) in enumerate(device_parts):
            if tag == "minmax" and f"{s.attr}__hi" in cols:
                vhi = cols[f"{s.attr}__hi"].to(torch.int64)
                vlo = widen_u32(cols[f"{s.attr}__lo"])
                mnhi = int(masked(vhi, m, 2**31 - 1).min())
                mxhi = int(masked(vhi, m, -(2**31)).max())
                at_mn = vhi == mnhi if m is None else m & (vhi == mnhi)
                at_mx = vhi == mxhi if m is None else m & (vhi == mxhi)
                mnlo = int(masked(vlo, at_mn, 0xFFFFFFFF).min())
                mxlo = int(masked(vlo, at_mx, 0).max())
                out[i] = ((mnhi << 32) | mnlo, (mxhi << 32) | mxlo)
            elif tag == "minmax":
                v = cols[s.attr]
                if v.dtype.is_floating_point:
                    big, small = float("inf"), float("-inf")
                else:
                    big, small = torch.iinfo(v.dtype).max, torch.iinfo(v.dtype).min
                out[i] = (masked(v, m, big).min().item(), masked(v, m, small).max().item())
            elif tag == "hist":
                v = cols[s.attr].to(torch.float64)
                scale = s.bins / (s.hi - s.lo) if s.hi > s.lo else 0.0
                b = torch.clamp(torch.floor((v - s.lo) * scale), 0, s.bins - 1)
                idx = torch.nan_to_num(b, nan=0.0).to(torch.int64)
                ones = torch.ones_like(idx) if m is None else m.to(torch.int64)
                h = torch.zeros(s.bins, dtype=torch.int64, device=v.device)
                out[i] = h.index_add_(0, idx, ones).cpu().numpy()
        return out

    def density(
        self,
        query,
        envelope,
        width: int,
        height: int,
        weight_attr: "str | None" = None,
        loose: "bool | None" = None,
        auths=None,
    ) -> "np.ndarray | None":
        """Fused density rasterization (ref DensityIterator: aggregation
        next to the data, no feature batch materialized): the filter mask,
        then the density kernel over the resident coordinates. Returns a
        (height, width) float32 grid, or None when the filter or the needed
        planes are not resident (the caller takes the store path): a
        non-point geometry, a weight attribute without a 32-bit plane
        (int64 attributes stage as ``__hi/__lo``), or a filter that is not
        fully on the device.

        The density kernel's engines serve every grid size; the
        counterpart switches from its Pallas kernel to an XLA scatter past
        512x512, a TPU limit (see ``ops/density.py``).

        Viewports without area answer as the counterpart's do: an inverted
        one (xmax < xmin or ymax < ymin) gives a zero grid and launches
        nothing; one of zero width or height counts the rows on its line,
        in cell 0 of that axis (``viewport(..., lines=True)``)."""
        geom = self.sft.geom_field
        gx, gy = f"{geom}__x", f"{geom}__y"
        if gx not in self._cols or gy not in self._cols:
            return None  # non-point (or unstaged) geometry: host path
        if weight_attr is not None and weight_attr not in self._cols:
            return None
        f = self._parse(query)
        if inverted(envelope):
            if self._device_mask(f, loose) is None:
                return None
            return np.zeros((height, width), dtype=np.float32)

        def agg_build(cols, m):
            w = cols[weight_attr] if weight_attr is not None else None
            return density_grid(cols[gx], cols[gy], envelope, width, height, mask=m,
                                weights=w, lines=True)

        grid = self._fused_agg(f, loose, agg_build, auths=auths)
        return None if grid is None else grid.cpu().numpy()

    # -- the AIS processes' resident passes ----------------------------------

    def _point_planes(self):
        """(x, y) resident coordinate planes of the default point geometry,
        or None (non-point or no geometry)."""
        geom = self.sft.geom_field
        gx, gy = f"{geom}__x", f"{geom}__y"
        if geom is None or gx not in self._cols:
            return None
        return self._cols[gx], self._cols[gy]

    def _base_mask(self, query):
        """(ok, mask function) for an optional base filter: ok is False when
        the filter is not fully on the device (the caller takes its host
        path); the function launches the exact mask (the filter-scan
        kernel) and is None for no filter or INCLUDE."""
        f = None if query is None else self._parse(query)
        if f is None or f is ast.Include:
            return True, None
        fn = self._device_mask(f, loose=False)
        return fn is not None, fn

    def _empty(self):
        return self._host_rows().take(np.array([], np.int64))

    def window_union_query(self, envs, times=None, auths=None, base=None):
        """Candidate rows inside ANY of m runtime windows: the coarse pass of
        tube select (one bbox+time window per track segment) and proximity
        search (one expanded bbox per input geometry).

        ``envs``: (m, 4) ``[xmin, ymin, xmax, ymax]``; ``times``: optional
        (m, 2) int64 ``[t_lo, t_hi]`` epoch ms, inclusive, tested against
        the default date's lanes. ``base``: an optional filter whose exact
        device mask (the filter-scan kernel, reading the validity plane) is
        ANDed in; ``auths`` as in ``count``. Bounds widen one float32 ulp outward (candidate
        semantics: callers refine). Returns the matching host rows in row
        order, or None when the point planes, the date lanes for
        ``times``, or a fully device-expressible ``base`` are missing."""
        planes = self._point_planes()
        if planes is None:
            return None
        dtg = self.sft.dtg_field
        lanes = (None, None)
        if times is not None:
            if dtg is None or f"{dtg}__hi" not in self._cols:
                return None
            lanes = (self._cols[f"{dtg}__hi"], self._cols[f"{dtg}__lo"])
        ok, base_fn = self._base_mask(base)
        if not ok:
            return None  # base not on the device: the store path instead
        if self._staged_len() == 0:
            return self._empty()
        m = union_mask(*planes, widen(envs), *lanes, times=times)
        seen = self._and_seen(None if base_fn is None else base_fn(), auths)
        if seen is not None:
            m &= seen
        return self._host_rows().take(np.nonzero(m.cpu().numpy())[0])

    def bbox_window_query(self, xmin, ymin, xmax, ymax, auths=None):
        """A bbox query with runtime bounds, the probe of the expanding-window
        kNN search: the m = 1 case of :meth:`window_union_query`."""
        return self.window_union_query(
            np.array([[xmin, ymin, xmax, ymax]], np.float64), auths=auths
        )

    def knn(self, px: float, py: float, k: int, query=None, auths=None,
            max_radius_deg: float = 45.0):
        """k nearest neighbours of ``(px, py)``: (batch, distances in
        degrees), nearest first. Candidates are the rows inside the
        ``max_radius_deg`` box around the target that pass ``query`` (the
        filter-scan kernel) and ``auths`` (fail closed on None/()); fewer
        than ``k`` of them give fewer results, and equal distances prefer
        the earlier row (``ops/knn.py``). The distance is the lat-corrected
        equirectangular one, ``sqrt`` taken in float64 of a float32 square.

        Returns None for a non-point schema or a filter that is not fully
        on the device: the process then takes expanding windows."""
        planes = self._point_planes()
        if planes is None:
            return None
        ok, base_fn = self._base_mask(query)
        if not ok:
            return None
        if self._staged_len() == 0:
            return self._empty(), np.array([], np.float64)
        q = knn_ops.query_vector(px, py, max_radius_deg, knn_ops.lon_factor(py), self.device)
        m = self._and_seen(None if base_fn is None else base_fn(), auths)
        idx, d2 = knn_ops.knn(*planes, q, k, mask=m)
        return (self._host_rows().take(idx.cpu().numpy()),
                np.sqrt(d2.cpu().numpy().astype(np.float64)))

    # -- micro-batch scan fusion (the device query scheduler) ----------------

    def fused_loose_counts(self, queries, loose: "bool | None" = None):
        """Answer Q compatible loose queries in ONE batched launch: the
        group's queries, and no padding query, go to one pass over the key
        planes that returns every count -- the batched dim scan (R padded
        to the group's maximum with never-matching ranges), the batched
        interleaved scan (each query's real entries), or for the xz kinds
        the range masks' torch ops, query by query.
        Results equal ``[count(q, loose=True) for q in queries]``. Returns
        None when the group cannot fuse -- no queries, labeled rows staged
        (auth tables are per request), loose mode off, nothing staged, a
        filter the key planes cannot answer, mixed scan engines or a z2
        query in a z3 group -- and the caller runs the queries serially."""
        out = self._fused_loose(queries, loose, want="count")
        if out is None:
            return None
        return [int(v) for v in out.cpu().tolist()]

    def fused_loose_query(self, queries, loose: "bool | None" = None):
        """Batched sibling of :meth:`query`: one launch computes the (Q, n)
        hit matrix, then one host take per query demuxes the rows. Returns
        a list of FeatureBatch aligned with ``queries``, or None when the
        group cannot fuse (see :meth:`fused_loose_counts`). The counterpart
        copies the whole matrix to the host (4 GiB at Q = 64 over 2^26
        rows) for one ``np.nonzero`` a row; the port finds the hits on the
        matrix's device instead (:meth:`_fused_hits`)."""
        m = self._fused_loose(queries, loose, want="mask")
        if m is None:
            return None
        rows = self._host_rows()
        return [rows.take(r) for r in self._fused_hits(m)]

    @staticmethod
    def _fused_hits(m, max_pairs: "int | None" = None) -> "list[np.ndarray]":
        """Each row's ascending hit positions of the (Q, n) bool matrix
        ``m``, as int64 host arrays. ``torch.nonzero`` runs over blocks of
        ``max(1, max_pairs // n)`` rows (``max_pairs`` defaults to
        ``_FUSED_HIT_PAIRS``), so one call returns at most ``max(max_pairs,
        n)`` hits whatever the boxes' hit density: 16 bytes a hit of a
        block, 8 of a lone row (at most 512 MiB at 2^26 rows), and only the
        hits cross to the host. No row count is taken first: a sum over a
        bool matrix casts it to int64, 8 bytes a cell."""
        if max_pairs is None:
            max_pairs = _FUSED_HIT_PAIRS
        q, n = m.shape
        step = max(1, max_pairs // max(n, 1))
        out: list = []
        for a in range(0, q, step):
            if step == 1:
                out.append(torch.nonzero(m[a]).view(-1).cpu().numpy())
                continue
            blk = m[a:a + step]
            hits = torch.nonzero(blk).cpu().numpy()
            cuts = np.searchsorted(hits[:, 0], np.arange(1, blk.shape[0]))
            out += np.split(hits[:, 1], cuts)
        return out

    def _fused_loose(self, queries, loose, want: str):
        """(Q,) int32 counts or the (Q, n) bool mask matrix of a fusable
        group, on the device, or None. The counterpart tells the dim-plane
        bounds by their length; the port's loose bounds carry their engine
        as a tag (``"dim"``, ``"zscan"``, ``"xz"``), and a group fuses only
        when all of its queries share one. Counts and masks both read the
        validity plane in the launch."""
        _launch_faults()  # chaos: fused resident launch
        if not queries:
            return None
        if VIS_ID in self._cols:
            return None
        if not self._resolve_loose(loose) or self._staged_len() == 0:
            return None
        lbs = []
        for q in queries:
            lb = self._loose_bounds(self._parse(q))
            if lb is None:
                return None
            lbs.append(lb)
        if len({lb[0] for lb in lbs}) != 1:
            return None  # mixed engines: serial
        if lbs[0][0] == "dim":
            return self._fused_dim(lbs, want)
        return self._fused_compare(lbs, want)

    def _fused_dim(self, lbs, want: str):
        """Stacked dim-plane launch of the group's queries: each query
        vector pads to the group's largest R with never-matching bt ranges
        (the ``z3_dim_plane_qarr`` padding); no query is added."""
        rs = [lb[2] for lb in lbs]
        r = max(rs)
        if r and 0 in rs:
            return None  # a z2 (no bt plane) query cannot join a z3 group
        qmat = np.empty((len(lbs), 4 + 2 * r), np.uint32)
        qmat[:, 4:] = np.array([0xFFFFFFFF, 0] * r, np.uint32)
        for i, lb in enumerate(lbs):
            qa = np.asarray(lb[1], np.uint32)
            qmat[i, : len(qa)] = qa
        planes = (self._cols[Z_NX], self._cols[Z_NY])
        if r:
            planes += (self._cols[Z_BT],)
        fn = zscan.batched_dimscan_count if want == "count" else zscan.batched_dimscan_mask
        return fn(qmat, *planes, valid=self._device_valid())

    def _fused_compare(self, lbs, want: str):
        """One launch over the group's queries for the interleaved kinds:
        each query's real bound entries go to the batched kernel's packer
        as they are (nothing padded; ids < 0 never match in the port). The
        xz kinds stack their range masks' torch ops: each query's ranges
        and bins pad to the group's maxima with entries that match nothing
        (inverted ranges, ids -1)."""
        kind = self._z_kind
        hi, lo = self._cols[Z_HI], self._cols[Z_LO]
        bins = self._cols[Z_BIN] if kind in ("z3", "xz3") else None
        dv = self._device_valid()
        if kind in ("z3", "z2"):  # the batched interleaved-scan kernel
            scan = zscan.batched_zscan_group(
                [lb[1] for lb in lbs], [lb[2] for lb in lbs] if kind == "z3" else None)
            return scan.run(bins, hi, lo, want_mask=want == "mask", valid=dv)
        bs = [np.asarray(lb[1]) for lb in lbs]
        if kind == "xz3":
            ids = [np.asarray(lb[2]) for lb in lbs]
            bmax = max(len(i) for i in ids)  # a power of two already (pad_bins)
            rmax = max(b.shape[1] for b in bs)
            bounds = np.zeros((len(lbs), bmax, rmax, 4), np.uint32)
            idm = np.full((len(lbs), bmax), -1, np.int32)
            for i, (b, bi) in enumerate(zip(bs, ids)):
                bounds[i, : len(bi)] = zscan.pad_ranges(b, min_r=rmax)
                idm[i, : len(bi)] = bi
            m = zscan.batched_kind_mask(kind)(hi, lo, bins, bounds, idm)
        else:
            rmax = max(b.shape[0] for b in bs)
            bounds = np.stack([zscan.pad_ranges(b, min_r=rmax) for b in bs])
            m = zscan.batched_kind_mask(kind)(hi, lo, bounds)
        if dv is not None:
            m &= dv
        return m.sum(dim=1, dtype=torch.int32) if want == "count" else m

    # -- window pairs: the coarse pass of a spatial join ----------------------

    def _plane_rows(self) -> int:
        """Rows of the resident planes (a streaming index: its capacity),
        which size window_pairs_query's compaction cap as the counterpart's
        plane length does."""
        return self._staged_len()

    def window_pairs_query(self, envs, auths=None, base=None):
        """Candidate (row, window) PAIRS for m runtime envelope windows: the
        device coarse pass of a spatial join (each right-side feature one
        envelope; the exact predicate refines per pair on the host). Where
        :meth:`window_union_query` collapses the window axis, this keeps
        it: windows go in groups of 64, each row's hits in a group one
        64-bit word (``ops/window.py`` ``pairs_pack``), ``G`` groups a pass.

        The per-row gate is computed once per call: ``base``'s exact mask
        (the filter-scan kernel, reading the validity plane), the validity
        plane and the auth verdict (``auths`` as in ``count``). Each
        group's rows with a hit come first in row order, at most ``C`` of
        them fetched; a group past ``C`` refetches its full word plane
        (``_pairs_full_group``), counted on
        ``geomesa_join_pair_overflows_total``. ``envs``: (m, 4) [xmin, ymin,
        xmax, ymax], widened one float32 ulp (candidate semantics). Returns
        (rows, wins) int64 arrays, group after group, rows ascending and
        windows ascending within a row; None for a non-point schema or a
        base filter not fully on the device."""
        from geomesa_tpu_torch import metrics
        from geomesa_tpu_torch.tracing import span

        planes = self._point_planes()
        if planes is None:
            return None
        ok, base_fn = self._base_mask(base)
        if not ok:
            return None
        envs = np.asarray(envs, np.float64).reshape(-1, 4)
        m = envs.shape[0]
        plane_n = self._plane_rows()
        ngroups = max(1, -(-m // 64))
        G = min(self.PAIRS_GROUPS_PER_DISPATCH, bucket_cap(ngroups))
        C = min(plane_n, max(4096, bucket_cap(plane_n // 32)))
        rows_out: list = []
        wins_out: list = []
        if self._staged_len():
            row_ok = self._and_seen(None if base_fn is None else base_fn(), auths)
            with span("join.pairs", windows=m, groups=ngroups) as sp:
                overflows = self._pairs_dispatch(envs, planes, row_ok, G, C, rows_out, wins_out)
                sp.set(overflows=overflows)
            if overflows:
                metrics.join_pair_overflows.inc(overflows)
        if not rows_out:
            e = np.array([], np.int64)
            return e, e.copy()
        return np.concatenate(rows_out), np.concatenate(wins_out)

    def _pairs_dispatch(self, envs, planes, row_ok, G, C, rows_out, wins_out):
        """window_pairs_query's loop: one pair pack per chunk of ``G`` groups
        (padding windows inverted: they match nothing), one fetch of the
        capped rows and words, and the full word plane of each group past
        the cap. Returns the overflow count."""
        m = envs.shape[0]
        overflows = 0
        wspan = 64 * G

        def decode(rids, words, g0):
            """(candidate rows, their hit words) -> aligned pair lists."""
            bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8).reshape(-1, 8),
                                 axis=1, bitorder="little")  # (c, 64): bit j, window j
            r, w = np.nonzero(bits)
            keep = w + g0 < m  # the planes hold the staged rows only
            rows_out.append(rids[r[keep]].astype(np.int64))
            wins_out.append((w[keep] + g0).astype(np.int64))

        for c0 in range(0, max(m, 1), wspan):
            env_pad = np.empty((wspan, 4), np.float32)
            k = len(envs[c0: c0 + wspan])
            env_pad[:k] = widen(envs[c0: c0 + wspan])
            env_pad[k:] = [1.0, 1.0, 0.0, 0.0]  # inverted: no matches
            rid, word, cnts = pairs_pack(*planes, env_pad, row_ok, C)
            rid, word, cnts = rid.cpu().numpy(), word.cpu().numpy(), cnts.cpu().numpy()
            at = 0
            for g in range(G):
                g0 = c0 + g * 64
                cnt = int(cnts[g])
                kept = min(cnt, C)
                if g0 < m and cnt and cnt <= C:
                    decode(rid[at: at + kept], word[at: at + kept], g0)
                elif g0 < m and cnt:
                    # a dense group overflowed the cap: its full word plane
                    overflows += 1
                    full = self._pairs_full_group(planes, env_pad[g * 64: (g + 1) * 64], row_ok)
                    nz = np.nonzero(full)[0]
                    decode(nz, full[nz], g0)
                at += kept
        return overflows

    def _pairs_full_group(self, planes, env64, row_ok) -> np.ndarray:
        """The full (uncompacted) word plane of ONE dense 64-window group,
        on the host: window_pairs_query's overflow path."""
        return group_words(*planes, env64, row_ok).cpu().numpy()

    # -- BIN output ----------------------------------------------------------

    def bin_export(self, query, track_attr: str, dtg_attr: "str | None" = None,
                   geom_attr: "str | None" = None, label_attr: "str | None" = None,
                   sort: bool = False, loose: "bool | None" = None, auths=None) -> bytes:
        """BIN track records of the hits, the host twin: the hit mask from
        the scan kernels (``mask``), then the 3-5 needed columns of the hit
        rows only, encoded by ``process/binexport.py`` (ref
        BinAggregatingIterator builds the records during the scan)."""
        from geomesa_tpu_torch.process.binexport import encode_bin_arrays

        idx = np.nonzero(self.mask(query, loose=loose, auths=auths))[0]
        host = self._host_rows()
        gname = geom_attr or self.sft.geom_field
        # slice the geometry column first, then decode coordinates of the hits
        mini = FeatureBatch(self.sft, host.fids[idx], {gname: host.column(gname)[idx]})
        x, y = mini.point_coords(gname)
        dtg_attr = dtg_attr or self.sft.dtg_field
        return encode_bin_arrays(
            host.column(track_attr)[idx],
            host.column(dtg_attr)[idx],
            x,
            y,
            host.column(label_attr)[idx] if label_attr else None,
            sort=sort,
        )

    def _device_hit_mask(self, f, loose) -> "torch.Tensor | None":
        """The filter's bool hit mask over the staged rows, left on the
        device: the loose key scan (dim plane or interleaved), the exact
        filter scan, or for INCLUDE the validity plane (every row without
        one); each launch reads the validity plane. None when the filter is
        not fully on the device, and always for a labeled staging
        (per-request auths evaluate on the host): the twin serves those."""
        if VIS_ID in self._cols:
            return None
        if f is ast.Include:
            dv = self._device_valid()
            return dv if dv is not None else torch.ones(
                self._staged_len(), dtype=torch.bool, device=self.device)
        fn = self._device_mask(f, loose)
        return None if fn is None else fn()

    def _bin_lane_matrix(self, track_attr, dtg_attr, gname, label_attr) -> torch.Tensor:
        """The BIN record lanes as ONE (L, rows) matrix on the device, the
        uint32 bits held as int32 (CUDA gathers no uint32): [track hash,
        dtg seconds, lat f32, lon f32] (+ the label's low and high words).
        Built once per staged generation (vector host passes, one upload)
        and gathered by every pack after that; only the latest kept."""
        from geomesa_tpu_torch.process.binexport import _label_pack, _track_hash

        key = (track_attr, dtg_attr, gname, label_attr, self._gen)
        mat = self._bin_lanes.get(key)
        if mat is not None:
            return mat
        host = self._host_rows()
        col = host.column(gname)
        lanes = [
            _track_hash(np.asarray(host.column(track_attr))),
            (host.column(dtg_attr) // 1000).astype(np.int32),
            np.ascontiguousarray(col[:, 1]).astype(np.float32).view(np.int32),
            np.ascontiguousarray(col[:, 0]).astype(np.float32).view(np.int32),
        ]
        if label_attr:
            # little-endian int64: the low word first, as the record lays it
            words = _label_pack(np.asarray(host.column(label_attr))).view(np.int32).reshape(-1, 2)
            lanes += [words[:, 0], words[:, 1]]
        self._bin_lanes = {}  # free the previous generation's matrix first
        mat = to_tensor(np.stack(lanes), self.device)
        self._bin_lanes = {key: mat}
        return mat

    def bin_rider(self, query, track_attr: str, dtg_attr: "str | None" = None,
                  geom_attr: "str | None" = None, label_attr: "str | None" = None,
                  sort: bool = False, loose: "bool | None" = None, auths=None) -> "bytes | None":
        """BIN track records packed ON THE DEVICE: the hit mask stays on the
        card, a count pass sizes the answer and one compaction gathers the
        hit rows' record lanes in mask order (``ops/binpack.py``); only the
        packed records cross to the host, once. Bit for bit the twin
        :meth:`bin_export`. Returns None for a shape the device cannot
        express (labeled staging, a host-residual filter, non-point
        geometry): callers take the twin. ``auths`` is accepted for the
        twin's signature; an unlabeled staging has nothing to hide."""
        from geomesa_tpu_torch import metrics
        from geomesa_tpu_torch.process.binexport import DTYPE_16, DTYPE_24

        f = self._parse(query)
        host = self._host_rows()
        gname = geom_attr or self.sft.geom_field
        if host is None or host.column(gname).dtype == object:
            return None  # non-point geometry: the twin decodes coordinates
        if len(host) == 0:
            return b""
        m = self._device_hit_mask(f, loose)
        if m is None:
            return None
        mat = self._bin_lane_matrix(track_attr, dtg_attr or self.sft.dtg_field, gname, label_attr)
        rows = int(mat.shape[1])
        if int(m.shape[0]) < rows:
            return None  # mirror and planes disagree: the twin is exact
        if binpack.bin_count(m[:rows]) == 0:
            return b""
        data = binpack.bin_pack(m[:rows], mat).tobytes()  # the one device-to-host copy
        metrics.results_bin_device_launches.inc()
        if not sort:
            return data
        rec = np.frombuffer(data, dtype=DTYPE_24 if label_attr else DTYPE_16)
        return rec[np.argsort(rec["dtg"], kind="stable")].tobytes()

    # -- the resident warmup ------------------------------------------------

    def warmup_plan(
        self,
        k: int = 10,
        density_px: int = 256,
        knn_kmax: "int | None" = None,
        fusion_max: "int | None" = None,
    ) -> "list[tuple[str, object]]":
        """The warmup plan: ``(signature, thunk)`` legs covering the kernel
        families this index serves, which :mod:`geomesa_tpu_torch.warmup`
        runs before a server lets traffic in (reference
        ``geomesa_tpu/device_cache.py:1417-1529``). Base legs run the loose
        and exact counts at two window scales (a city and a country box,
        AND a DURING over the staged dates' whole interval, read from the
        host rows once a plan where the counterpart reads it for every
        box: 2^26 dates a read), then mask,
        window union, window pairs, density and stats; ``knn_kmax`` adds
        one kNN leg per rung of the k ladder (:func:`bucketing.ladder`) up
        to it, and ``fusion_max`` one fused count and one fused query leg
        per width rung (loose, as the scheduler fuses). Legs the schema or
        staging cannot serve (kNN and density on a non-point schema; every
        leg on an empty staging) are not planned. The centre is the first
        point, else the first envelope's lower corner, else (0, 0).

        On the card there is no jit cache to fill: a leg pays what a cold
        process pays on its first request of that family -- the kernel
        library's build or load (``kernels/_build.py``), the caching
        allocator's first growth at the staged shapes, the filter scan's
        launch records of each plane set and the batched scans' packing."""
        from geomesa_tpu_torch.bucketing import ladder
        from geomesa_tpu_torch.geom import Envelope

        legs: list = []
        geom = self.sft.geom_field
        if geom is None or self._staged_len() == 0:
            return legs
        gx, gy = f"{geom}__x", f"{geom}__y"
        is_point = gx in (self._cols or {})
        if is_point:
            cx = float(self._cols[gx][:1].cpu()[0])
            cy = float(self._cols[gy][:1].cpu()[0])
        elif f"{geom}__x0" in (self._cols or {}):
            cx = float(self._cols[f"{geom}__x0"][:1].cpu()[0])
            cy = float(self._cols[f"{geom}__y0"][:1].cpu()[0])
        else:
            cx = cy = 0.0
        dtg = self.sft.dtg_field
        span: list = []  # the staged dates' interval, read once a plan

        def bbox(half):
            f = ast.BBox(geom, cx - half, cy - half, cx + half, cy + half)
            if dtg is not None:
                if not span:
                    col = self._host_rows().columns.get(dtg)
                    span.append(None)
                    if col is not None and len(col):
                        ms = np.asarray(col).astype("datetime64[ms]")
                        span[0] = (int(ms.min().astype(np.int64)), int(ms.max().astype(np.int64)))
                if span[0] is not None:
                    f = ast.And([f, ast.During(dtg, *span[0])])
            return f

        for name, half in (("city", 0.05), ("country", 5.0)):
            q = bbox(half)
            legs.append((f"count_loose_{name}", lambda q=q: self.count(q, loose=True)))
            legs.append((f"count_exact_{name}", lambda q=q: self.count(q, loose=False)))
        legs.append(("mask", lambda: self.mask(bbox(1.0))))
        if is_point:
            legs.append(("knn", lambda: self.knn(cx, cy, k)))
            if knn_kmax is not None:
                for kk in ladder(min(int(knn_kmax), max(self._staged_len(), 1))):
                    legs.append((f"knn:k={kk}", lambda kk=kk: self.knn(cx, cy, kk)))
        env1 = np.array([[cx - 0.5, cy - 0.5, cx + 0.5, cy + 0.5]], np.float64)
        legs.append(("window_union", lambda: self.window_union_query(env1)))
        legs.append(("window_pairs", lambda: self.window_pairs_query(env1)))
        if is_point:
            legs.append((
                "density",
                lambda: self.density(
                    ast.Include, Envelope(cx - 5, cy - 5, cx + 5, cy + 5), density_px, density_px),
            ))
        legs.append(("stats", lambda: self.stats(ast.Include, "Count()")))
        if fusion_max is not None:
            # loose=True: the scheduler fuses loose requests only; without it
            # (the reference's call) the legs read query.loose.bbox, which is
            # off by default, and launch nothing (ROADMAP section 3)
            q = bbox(0.05)
            for w in ladder(max(int(fusion_max), 1)):
                legs.append((f"fused_counts:q={w}",
                             lambda q=q, w=w: self.fused_loose_counts([q] * w, loose=True)))
                legs.append((f"fused_query:q={w}",
                             lambda q=q, w=w: self.fused_loose_query([q] * w, loose=True)))
        return legs

    def warmup(self, k: int = 10, density_px: int = 256) -> dict:
        """Run the base :meth:`warmup_plan` legs inline, so the first real
        request of each family pays no first-use cost (reference
        ``geomesa_tpu/device_cache.py:1531-1565``). Returns ``{leg:
        seconds}``; a leg that raised is warned about and maps to None (a
        warmup never takes a server down: the first real request launches
        the kernel again, and raises if it fails), and ``knn`` and
        ``density`` map to None on a schema without points. The server's
        background pass (:mod:`geomesa_tpu_torch.warmup`) runs the full
        plan, with the kNN and fusion ladders, under the ``_system``
        ledger tenant instead."""
        import time as _time

        out: dict = {}
        for name, fn in self.warmup_plan(k=k, density_px=density_px):
            t0 = _time.perf_counter()
            try:
                fn()
                out[name] = round(_time.perf_counter() - t0, 3)
            except Exception as e:  # warmup must never break serving
                warnings.warn(f"warmup leg {name!r} failed: {e!r}")
                out[name] = None
        if "knn" not in out:
            out["knn"] = None  # non-point schema: leg unavailable
        if "density" not in out:
            out["density"] = None
        return out


def _attach(live_store, listener):
    """Register ``listener`` with a live layer; the returned callable of no
    arguments unregisters it (when the layer can), releasing the index."""
    live_store.add_listener(listener)

    def detach() -> None:
        remove = getattr(live_store, "remove_listener", None)
        if remove is not None:
            remove(listener)

    return detach


class _FidIndex:
    """fid -> staged row for a streaming index's live rows. The fids of an
    install that are dense non-negative integers (a store's sequential
    ids) go into a direct table, one numpy gather a lookup and no Python
    object per row (an install stages tens of millions); the fids appended
    later, and any other install's, go into a dict that takes precedence.
    A fid maps to its last staged row, as a dict filled in row order
    would; a row whose validity bit is clear maps to nothing."""

    def __init__(self, fids: np.ndarray):
        self._table = None
        self._later: dict = {}
        n = len(fids)
        if n and fids.dtype.kind in "iu" and fids.min() >= 0 and fids.max() < 4 * n + 4096:
            rows = np.arange(n)
            self._table = np.full(int(fids.max()) + 1, -1, np.int64)
            self._table[fids] = rows
            if (self._table[fids] != rows).any():  # duplicate fids: the last row wins
                np.maximum.at(self._table, fids, rows)
        else:
            self._later = {f: i for i, f in enumerate(fids.tolist())}

    def add(self, fids: np.ndarray, first_row: int) -> None:
        for i, f in enumerate(fids.tolist()):
            self._later[f] = first_row + i

    def rows(self, fids, valid: np.ndarray) -> np.ndarray:
        """The staged rows of ``fids`` that are live; -1 for a fid not held."""
        fids = np.asarray(fids)
        out = np.full(len(fids), -1, np.int64)
        if self._table is not None and len(fids):
            keys = fids if fids.dtype.kind != "O" else np.asarray(fids.tolist())
            if keys.dtype.kind in "iu":
                hit = (keys >= 0) & (keys < len(self._table))
                out[hit] = self._table[keys[hit]]
        if self._later:
            for i, f in enumerate(fids.tolist()):
                r = self._later.get(f)
                if r is not None:
                    out[i] = r
        live = out >= 0
        live[live] = valid[out[live]]
        out[~live] = -1
        return out


class StreamingDeviceIndex(DeviceIndex):
    """Delta-refreshed resident index: appends, evictions and upserts touch
    only the changed rows instead of restaging every plane (counterpart:
    ``StreamingDeviceIndex`` in ``geomesa_tpu/device_cache.py``; ref role:
    a Kafka consumer keeping its cache warm).

    >>> di = StreamingDeviceIndex(store, "gdelt", z_planes=True)
    >>> di.append(batch)          # new fids: copied in place, validity set
    >>> di.evict(fids)            # validity bits cleared, nothing restaged
    >>> di.upsert(batch)          # evict the fids it holds, then append
    >>> detach = di.attach_live(live)   # Put -> upsert, Remove -> evict

    Device planes live in buffers of a fixed capacity (a power of two of
    at least ``max(rows, capacity, MIN_DELTA_ROWS)``) beside a bool
    validity plane. An append copies its rows into the buffers after the
    staged ones and sets their validity bits; an eviction clears bits
    through one index tensor. Every scan launches over the staged rows
    only (contiguous views of the buffers' first ``_staged_len()`` rows)
    with the validity plane as the kernels' operand, so masks have one
    entry per staged row and dead rows are False. An append that would
    overflow the capacity compacts the live rows and restages them at
    double capacity; dead rows past ``compact_threshold`` of the staged
    ones compact in place. A delta restages in full, as the counterpart's
    does, when its labels overflow the vocabulary, its bins fall outside
    the packed bt window, or it brings a plane the buffers lack (the first
    labeled rows). One re-entrant lock guards every mutation and every
    scan, so a scan's rows and mask come from one snapshot; launches and
    copies run on the calling thread's current stream.
    """

    #: smallest capacity, and the headroom the growth test keeps for a delta
    MIN_DELTA_ROWS = 256

    def __init__(
        self,
        store,
        type_name: str,
        columns: "list[str] | None" = None,
        capacity: "int | None" = None,
        compact_threshold: float = 0.5,
        z_planes: bool = False,
        dim_planes: "bool | None" = None,
        device=None,
    ):
        self._capacity_hint = capacity
        self.compact_threshold = compact_threshold
        self.restages = 0  # full restages (init, growth, compaction, fallbacks)
        self.delta_appends = 0  # appends served in place
        self._lock = threading.RLock()
        super().__init__(store, type_name, columns, z_planes=z_planes,
                         dim_planes=dim_planes, device=device)

    # -- staging -----------------------------------------------------------

    def refresh(self) -> None:
        with self._lock:
            if self.store is None:
                raise RuntimeError("an index built from planes has no store")
            res = self.store.query(self.type_name, _staging_query())
            self._install(res.batch)

    def _install(self, batch, min_cap: int = 0) -> None:
        """Full (re)stage of ``batch`` into fresh capacity buffers."""
        self._reset()
        batch, cols = self._stage_checked(batch)
        n = len(batch)
        cap = bucket_cap(max(n, min_cap, self._capacity_hint or 0, self.MIN_DELTA_ROWS))
        self._bufs = {}
        for k, v in cols.items():
            buf = torch.empty(cap, dtype=v.dtype, device=self.device)
            buf[:n].copy_(v)
            self._bufs[k] = buf
        del cols
        self._valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self._valid[:n] = True
        self._cap, self._n, self._n_dead = cap, n, 0
        self._parts = [batch]
        self._host_cache = batch
        self._valid_np = np.zeros(cap, dtype=bool)  # host mirror of the plane
        self._valid_np[:n] = True
        self._fids = _FidIndex(batch.fids)
        self._set_views()
        self.restages += 1

    def _set_views(self) -> None:
        """The base class's planes: views of the buffers' staged rows."""
        self._cols = {k: b[: self._n] for k, b in self._bufs.items()}

    def _host(self):
        if self._host_cache is None:
            self._host_cache = FeatureBatch.concat(self._parts)
            self._parts = [self._host_cache]
        return self._host_cache

    def _live_rows(self):
        """Host batch of the live (not evicted) rows, in staged order."""
        return self._host().take(np.nonzero(self._host_valid())[0])

    def _rows_of(self, fids) -> np.ndarray:
        """The live staged rows of ``fids`` (-1: not held)."""
        return self._fids.rows(fids, self._valid_np)

    def _restage_with(self, batch, grow: bool = False) -> None:
        """Restage the live rows and ``batch``: at double the merged rows'
        capacity to grow, else at the current capacity."""
        merged = FeatureBatch.concat([self._live_rows(), batch])
        self._install(merged, min_cap=2 * len(merged) if grow else self._cap)

    @contextmanager
    def _pinned(self):
        """Uploads through pinned memory, as a delta's are."""
        self._pin_uploads = True
        try:
            yield
        finally:
            self._pin_uploads = False

    # -- deltas ------------------------------------------------------------

    def append(self, batch) -> None:
        """Stage only the new rows, in place. Fids must be new: use
        ``upsert`` when a batch may overwrite rows."""
        with self._lock:
            self._append_locked(batch)

    def _stage_delta(self, batch):
        """(planes, label ids) of a delta, uploaded through pinned memory;
        raises _BtRebase or _VisOverflow for a delta that needs a full
        restage."""
        with self._pinned():
            cols = self._stage_batch(batch)
            ids = self._vis_ids(batch)
            if ids is not None:
                cols[VIS_ID] = self._up(ids)
        return cols, ids

    def _append_locked(self, batch) -> None:
        m = len(batch)
        if m == 0:
            return
        if self._n + max(bucket_cap(m), self.MIN_DELTA_ROWS) > self._cap:
            # grow: compact out dead rows, double the capacity for headroom
            self._restage_with(batch, grow=True)
            return
        try:
            delta, ids = self._stage_delta(batch)  # widens _bin_range / vocabulary
        except (_VisOverflow, _BtRebase):
            # a vocabulary overflow applies the public-only route to every
            # row; bins outside the packed window repack the bt plane
            self._restage_with(batch)
            return
        if set(delta) != set(self._bufs):
            # a plane the buffers lack (the first labeled rows) or a key
            # layout decided anew after an empty install: dropping it would
            # serve labeled rows as public
            self._restage_with(batch)
            return
        n = self._n
        for k, buf in self._bufs.items():
            buf[n: n + m].copy_(delta[k])
        self._valid[n: n + m] = True
        self._parts.append(batch)
        self._host_cache = None
        self._valid_np[n: n + m] = True
        if ids is not None:
            self._visid_np = ids if self._visid_np is None else np.concatenate(
                [self._visid_np, ids])
        self._fids.add(batch.fids, n)
        self._n = n + m
        self._set_views()
        self.delta_appends += 1

    def evict(self, fids) -> None:
        """Drop rows by fid: validity bits cleared on the device, no
        restage (unless dead rows pass ``compact_threshold``)."""
        with self._lock:
            self._evict_locked(fids)

    def _evict_locked(self, fids) -> None:
        self._evict_rows(self._rows_of(fids))

    def _evict_rows(self, rows: np.ndarray) -> None:
        idx = np.unique(rows[rows >= 0])
        if not len(idx):
            return
        self._gen += 1  # the live set changed
        self._valid_np[idx] = False
        self._n_dead += len(idx)
        with self._pinned():
            self._valid[self._up(idx)] = False
        if self._n_dead > self.compact_threshold * max(self._n, 1):
            self._install(self._live_rows(), min_cap=self._cap)

    def upsert(self, batch) -> None:
        """Evict the rows of the batch's fids this index holds, then append."""
        with self._lock:
            self._evict_rows(self._rows_of(batch.fids))
            self._append_locked(batch)

    def clear(self) -> None:
        """Drop every row (one empty restage)."""
        with self._lock:
            self._install(self._parts[0].take(np.array([], dtype=np.int64)))

    def refresh_delta(self, batch) -> str:
        """Streamed-append hook: fresh fids append in place. A batch with a
        fid this index holds is ambiguous (a duplicate-fid append, which
        the store serves as two rows, or a re-delivery): the store's view
        decides, so the index restages from it. Returns ``"delta"`` or
        ``"restage"`` and counts it on the metric."""
        from geomesa_tpu_torch import metrics

        with self._lock:
            if (self._rows_of(batch.fids) >= 0).any():
                self.refresh()
                mode = "restage"
            else:
                before = self.restages
                self._append_locked(batch)
                mode = "restage" if self.restages > before else "delta"
        metrics.stream_delta_refreshes.inc(mode=mode)
        return mode

    def attach_live(self, live_store):
        """Apply a live layer's messages as deltas: Put upserts its rows,
        Remove evicts its fids, anything else (Clear) restages from the
        store. Returns a callable of no arguments that detaches."""
        from geomesa_tpu_torch.stream.log import Put, Remove

        def listener(msg):
            if isinstance(msg, Put):
                self.upsert(FeatureBatch.from_columns(self.sft, msg.columns, msg.fids))
            elif isinstance(msg, Remove):
                self.evict(np.asarray(msg.fids))
            else:
                self.refresh()

        return _attach(live_store, listener)

    # -- scans: the base class's, under the lock -----------------------------

    def count(self, query, loose: "bool | None" = None, auths=None) -> int:
        with self._lock:
            return super().count(query, loose=loose, auths=auths)

    def mask(self, query, loose: "bool | None" = None, auths=None) -> np.ndarray:
        with self._lock:
            return super().mask(query, loose=loose, auths=auths)

    def query(self, query, loose: "bool | None" = None, auths=None):
        # one lock span across the mask and the take: one snapshot
        with self._lock:
            return super().query(query, loose=loose, auths=auths)

    def stats(self, query, spec: str, loose: "bool | None" = None, auths=None):
        with self._lock:
            return super().stats(query, spec, loose=loose, auths=auths)

    def density(self, query, envelope, width: int, height: int,
                weight_attr: "str | None" = None, loose: "bool | None" = None, auths=None):
        with self._lock:
            return super().density(query, envelope, width, height,
                                   weight_attr=weight_attr, loose=loose, auths=auths)

    def window_union_query(self, envs, times=None, auths=None, base=None):
        # bbox_window_query delegates here: this lock covers both
        with self._lock:
            return super().window_union_query(envs, times=times, auths=auths, base=base)

    def knn(self, px: float, py: float, k: int, query=None, auths=None,
            max_radius_deg: float = 45.0):
        with self._lock:
            return super().knn(px, py, k, query=query, auths=auths,
                               max_radius_deg=max_radius_deg)

    def window_pairs_query(self, envs, auths=None, base=None):
        with self._lock:
            return super().window_pairs_query(envs, auths=auths, base=base)

    def bin_export(self, query, track_attr, dtg_attr=None, geom_attr=None,
                   label_attr=None, sort=False, loose=None, auths=None):
        # one lock span across the mask and the host reads: one snapshot
        with self._lock:
            return super().bin_export(query, track_attr, dtg_attr=dtg_attr, geom_attr=geom_attr,
                                      label_attr=label_attr, sort=sort, loose=loose, auths=auths)

    def bin_rider(self, query, track_attr, dtg_attr=None, geom_attr=None,
                  label_attr=None, sort=False, loose=None, auths=None):
        # the lane matrix and the device mask must come from one staging
        with self._lock:
            return super().bin_rider(query, track_attr, dtg_attr=dtg_attr, geom_attr=geom_attr,
                                     label_attr=label_attr, sort=sort, loose=loose, auths=auths)

    def fused_loose_counts(self, queries, loose: "bool | None" = None):
        with self._lock:
            return super().fused_loose_counts(queries, loose=loose)

    def fused_loose_query(self, queries, loose: "bool | None" = None):
        # one lock span across the launch and the host takes
        with self._lock:
            return super().fused_loose_query(queries, loose=loose)

    # -- hooks ---------------------------------------------------------------

    def __len__(self) -> int:
        return self._n - self._n_dead

    @property
    def nbytes(self) -> int:
        """Resident device bytes: the capacity buffers and the validity plane."""
        return int(sum(b.numel() * b.element_size() for b in self._bufs.values())
                   + self._valid.numel())

    def _host_rows(self):
        return self._host()

    def _host_valid(self):
        return self._valid_np[: self._n]

    def _device_valid(self):
        return self._valid[: self._n]

    def _staged_len(self) -> int:
        return self._n

    def _plane_rows(self) -> int:
        return self._cap
