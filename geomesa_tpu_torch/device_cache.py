"""Device-resident index: a type's scan planes pinned in GPU memory,
serving bbox+during count and query, density grids and stats, under
per-request authorizations.

Counterpart of ``DeviceIndex`` in ``geomesa_tpu/device_cache.py``, trimmed
to what the port has so far: full staging (attribute planes, the key
planes of z3/z2 point schemas, and the visibility label-id plane
``__visid``), the loose key-only count and mask, the exact fused count and
mask, the host take, and the pushdown-aggregation hook ``_fused_agg``
with its two consumers, ``density`` (the density kernel) and ``stats``
(Count/MinMax/Histogram as torch reductions). Uploads are plain per-plane
copies (the counterpart's packed transfer and thin-transfer tricks exist
for its remote link).

Key planes come in two layouts, chosen at staging as the counterpart
chooses them: the de-interleaved dim planes ``__znx/__zny/__zbt`` (the
dim-scan kernels) whenever the bins pack into the bt word, else -- with
``dim_planes=False``, or z3 data spanning too many period bins, such as
day bins over more than 2,047 days -- the interleaved Morton key
``__zhi/__zlo`` plus the z3 bin plane ``__zbin`` (the masked-compare
kernel). Both answer ``loose=True`` with the same cell-granular rows.

Not in the port yet; each raises ``NotImplementedError`` naming its
ROADMAP item: the xz kinds, the Q-batched fused loose paths, streaming and
sharded indexes, knn, joins, and the stats the host sketches serve
(Cardinality, TopK, Frequency, Z3Histogram).
"""

from __future__ import annotations

import warnings
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
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.keyplanes import encode_inputs, schema_kind
from geomesa_tpu_torch.ops import zscan
from geomesa_tpu_torch.ops.density import density_grid
from geomesa_tpu_torch.ops.int64lanes import widen_u32
from geomesa_tpu_torch.ops.scan import stage_columns_host, to_tensor
from geomesa_tpu_torch.security import VisibilityEvaluator
from geomesa_tpu_torch.stats.dsl import _observe_on_batch, parse_stat
from geomesa_tpu_torch.stats.sketches import CountStat, Histogram, MinMax

# reserved names of the de-interleaved key planes (a leading underscore
# cannot clash with attribute planes "<attr>" / "<attr>__suffix")
Z_NX, Z_NY, Z_BT = "__znx", "__zny", "__zbt"
# reserved names of the interleaved key planes: the Morton key's two words
# and (z3 only) the int32 period bin
Z_BIN, Z_HI, Z_LO = "__zbin", "__zhi", "__zlo"
# a loose window over more bins than this takes the exact scan (the
# counterpart's cut: past it the per-row cost outweighs the key scan's win;
# its second cut, 8192 bound words, concerns xz bounds: 64 z3 bins hold 1152)
_LOOSE_MAX_BINS = 64
# reserved name of the visibility label-id plane: each row carries the id
# of its label expression in a small vocabulary; a per-request auth table
# gathers to a bool mask on the device
VIS_ID = "__visid"
_AUTH_TABLES_MAX = 256  # cached auth sets (request input: bounded)


class _VisOverflow(Exception):
    """The label vocabulary exceeded VIS_VOCAB_MAX."""


def _later(item: str) -> str:
    return f"not in the port yet: ROADMAP, port queue: {item}"


def _stageable_planes(sft: SimpleFeatureType) -> list:
    """Device plane names for every attribute the scan kernels can read."""
    planes: list = []
    for a in sft.attributes:
        if a.is_geometry:
            if a.is_point:
                planes += [f"{a.name}__x", f"{a.name}__y"]
            continue
        dtype = a.column_dtype
        if dtype == np.int64:
            planes += [f"{a.name}__hi", f"{a.name}__lo"]
        elif dtype in (np.float32, np.float64, np.int32):
            planes.append(a.name)
    return planes


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
    ``ValueError``. Runs on ``cuda:0`` unless ``device`` says otherwise;
    ``device="cpu"`` runs the kernels' plain versions on the host.

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

    def __init__(
        self,
        store,
        type_name: str,
        z_planes: bool = False,
        dim_planes: "bool | None" = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.store = store
        self.type_name = type_name
        self.sft = store.get_schema(type_name)
        self._planes = _stageable_planes(self.sft)
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
                want = (Z_BIN, Z_HI, Z_LO) if kind == "z3" else (Z_HI, Z_LO)
            if kind is None or any(p not in planes for p in want):
                raise ValueError(f"key planes {want} missing for a {kind} schema")
            self._z_kind = kind
            self._bt_base = None if bt_base is None else int(bt_base)
            self._bin_range = None if bin_range is None else tuple(int(b) for b in bin_range)
        return self

    # -- staging -----------------------------------------------------------

    def refresh(self) -> None:
        """Re-stage from the backing store (after writes). The staging
        scan keeps labeled rows (``raw_visibility``): this index enforces
        each request's auths itself."""
        if self.store is None:
            raise RuntimeError("an index built from planes has no store")
        res = self.store.query(self.type_name, ast.Include, raw_visibility=True)
        self._reset()
        self._host_batch, self._cols = self._stage_checked(res.batch)

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
            cols[VIS_ID] = to_tensor(ids, self.device)
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

    def _stage_batch(self, batch) -> dict:
        """Attribute planes + (optionally) key planes for a batch."""
        host = stage_columns_host(batch, self._planes)
        cols = {k: to_tensor(v, self.device) for k, v in host.items()}
        if not self._want_z:
            return cols
        kind, sfc = schema_kind(self.sft)
        if kind is None:
            return cols
        coords, bins = encode_inputs(
            batch, kind, sfc, self.sft.geom_field, self.sft.dtg_field
        )
        self._dim_mode = self._dim_usable(kind, sfc, bins)
        self._z_kind = kind
        if not self._dim_mode:
            cols.update(self._interleaved_planes(sfc, coords, bins))
        elif kind == "z2":
            cols.update(self._dim_planes_z2(sfc, coords))
        else:
            cols.update(self._dim_planes_for(sfc, coords, bins))
        if kind == "z3" and len(batch):
            lo, hi = int(bins.min()), int(bins.max())
            rng = (lo, hi) if self._bin_range is None else (
                min(self._bin_range[0], lo), max(self._bin_range[1], hi))
            if rng != self._bin_range:
                self._bin_range = rng
                self._loose_cache.clear()  # entries keyed on the old range
        return cols

    def _dim_usable(self, kind, sfc, bins) -> bool:
        """Whether the dim-plane layout packs: not with ``dim_planes=False``
        or for a non-point kind; z2 always; z3 with 21-bit time precision
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
        return dim.normalize_t(torch.from_numpy(values).to(self.device))

    def _dim_planes_z2(self, sfc, coords) -> dict:
        x, y = coords
        return {
            Z_NX: zscan._u32(self._quantize(sfc.lon, x)),
            Z_NY: zscan._u32(self._quantize(sfc.lat, y)),
        }

    def _interleaved_planes(self, sfc, coords, bins) -> dict:
        """{Z_HI, Z_LO} (+ Z_BIN for z3): the Morton key encoded on the
        device (float64 quantize, bit for bit the host ``sfc.index``) and
        the int32 period bins."""
        hi, lo = sfc.index_hi_lo(
            *(torch.from_numpy(np.asarray(c, np.float64)).to(self.device) for c in coords)
        )
        planes = {Z_HI: hi, Z_LO: lo}
        if bins is not None:
            planes[Z_BIN] = to_tensor(np.asarray(bins, np.int32), self.device)
        return planes

    def _dim_planes_for(self, sfc, coords, bins) -> dict:
        if bins is None or len(bins) == 0:
            e = torch.empty(0, dtype=torch.uint32, device=self.device)
            return {Z_NX: e, Z_NY: e.clone(), Z_BT: e.clone()}
        self._bt_base = int(bins.min())
        x, y, off = coords
        nx, ny, bt = zscan.z3_dim_planes(
            sfc,
            self._quantize(sfc.lon, x),
            self._quantize(sfc.lat, y),
            self._quantize(sfc.time, off),
            torch.from_numpy(np.asarray(bins, np.int64)).to(self.device),
            self._bt_base,
        )
        return {Z_NX: nx, Z_NY: ny, Z_BT: bt}

    def __len__(self) -> int:
        return len(self._host_batch)

    @property
    def nbytes(self) -> int:
        """Resident device bytes."""
        return int(sum(t.numel() * t.element_size() for t in self._cols.values()))

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
        scan (``ids`` None for z2). Cached per filter."""
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
            return self._zscan_bounds(sfc, env, window)
        if self._bt_base is None:
            return None  # nothing staged; the normal path returns empty too
        q = zscan.z3_dim_plane_qarr(sfc, env, window, self._bt_base, self._bin_range)
        return None if q is None else ("dim", *q)

    def _zscan_bounds(self, sfc, env, window):
        """The interleaved z3 scan's entry: one bound set per staged bin of
        the window; an empty window becomes one never-matching padded
        entry. None past 64 bins, and for a window over a bin before 1970
        (the scan reads a negative id as padding and would lose that bin's
        rows): the exact scan answers those."""
        bounds, ids = zscan.z3_query_bounds(sfc, *env, *window)
        if self._bin_range is not None:
            keep = (ids >= self._bin_range[0]) & (ids <= self._bin_range[1])
            bounds, ids = bounds[keep], ids[keep]
        if (ids < 0).any():
            return None
        if len(ids) == 0:
            bounds, ids = np.zeros((1, 3, 6), np.uint32), np.full(1, -1, np.int32)
        if len(ids) > _LOOSE_MAX_BINS:
            return None
        bounds, ids = zscan.pad_bins(bounds, ids)
        return "zscan", bounds, ids, zscan.build_z3_pallas_scan(bounds, ids)

    def _loose_args(self, lb) -> tuple:
        """(count_fn, mask_fn, operands) for a ``_loose_bounds`` result: the
        one place that pairs a loose scan with its resident planes, so
        ``count``, ``mask``, ``_fused_agg`` and ``loose_scan_kernel`` run the
        same kernel."""
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
        return count_fn, mask_fn, ops

    def _resolve_loose(self, loose: "bool | None") -> bool:
        # None: the counterpart's query.loose.bbox default (off)
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

    def _resident_subset(self, compiled) -> dict:
        return {c: self._cols[c] for c in compiled.device_cols}

    def count(self, query, loose: "bool | None" = None, auths=None) -> int:
        """Fused device count; exact when the filter is fully on device,
        else it falls through to query(). With loose=True bbox(+during)
        filters are answered at cell granularity from the key planes.
        ``auths`` applies per-request row security against the staged
        label-id plane (None/() hides labeled rows: fail closed)."""
        f = self._parse(query)
        if VIS_ID in self._cols:
            # labeled data: the auth table must AND into the device mask
            if len(self) == 0:
                return 0
            n = self._fused_agg(f, loose, lambda cols, m: int(m.sum()), auths=auths)
            if n is not None:
                return n
            return int(self.mask(f, loose=loose, auths=auths).sum())
        if self._resolve_loose(loose):
            lb = self._loose_bounds(f)
            if lb is not None:
                count_fn, _, ops = self._loose_args(lb)
                return int(count_fn(*ops))
        compiled = self._compiled_for(f)
        if not compiled.device_cols:
            return int(compiled.host_mask(self._host_batch).sum())
        if not compiled.fully_on_device:
            return len(self.query(f))
        return int(compiled.count(self._resident_subset(compiled)))

    def mask(self, query, loose: "bool | None" = None, auths=None) -> np.ndarray:
        """Boolean hit mask over the staged rows (host array). When a
        label-id plane is staged, the per-request ``auths`` verdict is
        ANDed in (fail closed on None/())."""
        f = self._parse(query)
        if self._resolve_loose(loose):
            lb = self._loose_bounds(f)
            if lb is not None:
                _, mask_fn, ops = self._loose_args(lb)
                return self._apply_auths_np(mask_fn(*ops).cpu().numpy(), auths)
        compiled = self._compiled_for(f)
        if not compiled.device_cols:
            return self._apply_auths_np(compiled.host_mask(self._host_batch), auths)
        m = compiled.mask(self._resident_subset(compiled)).cpu().numpy()
        if not compiled.fully_on_device:
            idx = np.nonzero(m)[0]
            out = np.zeros(len(m), dtype=bool)
            if len(idx):
                keep = compiled.residual_mask(self._host_batch.take(idx))
                out[idx[keep]] = True
            m = out
        return self._apply_auths_np(m, auths)

    def query(self, query, loose: "bool | None" = None, auths=None):
        """FeatureBatch of hits (host-side take over the device mask)."""
        return self._host_batch.take(
            np.nonzero(self.mask(query, loose=loose, auths=auths))[0]
        )

    def loose_scan_kernel(self, query):
        """(count_fn, operands): the kernel wrapper and resident planes that
        ``count(query, loose=True)`` launches, so a benchmark can time the
        serving path's own kernel. None when the key planes cannot answer
        the filter or a label-id plane would change the result."""
        lb = self._loose_bounds(self._parse(query))
        if lb is None or VIS_ID in self._cols:
            return None
        count_fn, _, ops = self._loose_args(lb)
        return count_fn, ops

    # -- pushdown aggregation (StatsIterator / DensityIterator analogs) ----

    def _fused_agg(self, f, loose, agg_build, auths=None):
        """The pushdown-aggregation hook: the filter mask, computed next to
        the data, handed to an aggregation over the resident planes --
        ``agg_build(cols, mask)``, whose result is returned. The mask is
        the loose key scan (``loose=True`` and a filter the key planes
        answer: the dim scan or the interleaved scan), None for INCLUDE
        (every row; the consumer skips the read), or the exact filter scan (the filter-scan kernel, or the plain
        ``device_fn`` for a filter the encoder refuses); with a label-id
        plane staged, the auth verdict gathered by label id is ANDed in.
        Returns None when the filter is not fully on the device: the caller
        then takes its host path. The counterpart jits one dispatch per
        (filter, kind, aggregation); PyTorch runs eagerly, so only the
        filter's compiled program is cached (per ``repr(f)``)."""
        m = None
        lb = self._loose_bounds(f) if self._resolve_loose(loose) else None
        if lb is not None:
            _, mask_fn, ops = self._loose_args(lb)
            m = mask_fn(*ops)
        elif not (f is ast.Include and self._cols):
            compiled = self._compiled_for(f)
            if not (compiled.device_cols and compiled.fully_on_device):
                return None
            m = compiled.mask(self._resident_subset(compiled))
        if VIS_ID in self._cols:
            # per-request row security: the auth verdict by label id
            seen = self._auth_table(auths)[1][self._cols[VIS_ID]]
            m = seen if m is None else m & seen
        return agg_build(self._cols, m)

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
        if len(self) == 0:
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
            rows = self._host_batch.take(np.nonzero(outs["__mask"])[0])
            for s in host_parts:
                _observe_on_batch(s, rows)
        return seq

    def _stats_reduce(self, cols, m, device_parts, need_mask) -> dict:
        """The device reductions of :meth:`stats` over mask ``m`` (None:
        every row), keyed by part index (two stats over one attribute must
        not share a slot): (min, max) for MinMax, the int64 bin counts for
        Histogram; ``__count`` always, ``__mask`` (host) for host parts."""
        n = len(self)
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

        One kernel serves every grid size; the counterpart switches from
        its Pallas kernel to an XLA scatter past 512x512, a TPU limit (see
        ``ops/density.py``)."""
        geom = self.sft.geom_field
        gx, gy = f"{geom}__x", f"{geom}__y"
        if gx not in self._cols or gy not in self._cols:
            return None  # non-point (or unstaged) geometry: host path
        if weight_attr is not None and weight_attr not in self._cols:
            return None
        f = self._parse(query)

        def agg_build(cols, m):
            w = cols[weight_attr] if weight_attr is not None else None
            return density_grid(cols[gx], cols[gy], envelope, width, height, mask=m, weights=w)

        grid = self._fused_agg(f, loose, agg_build, auths=auths)
        return None if grid is None else grid.cpu().numpy()

    # -- later slices --------------------------------------------------------

    def fused_loose_counts(self, queries, loose=None):
        raise NotImplementedError(_later("Q-batched fused loose paths"))

    def fused_loose_query(self, queries, loose=None):
        raise NotImplementedError(_later("Q-batched fused loose paths"))

    def refresh_delta(self, batch):
        raise NotImplementedError(_later("StreamingDeviceIndex"))

    def knn(self, *args, **kwargs):
        raise NotImplementedError(_later("stats/knn/joins"))
