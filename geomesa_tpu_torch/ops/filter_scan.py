"""Exact filter scan: AST -> kernel program, the CUDA filter-scan kernel
wrapper, and its plain PyTorch version.

Counterpart of ``geomesa_tpu/ops/pallas_scan.py``. The Pallas kernel is
traced anew for every filter with its constants baked in. Here the
filter's device part is ENCODED into a short program -- fixed-width
instructions over column slots plus a table of 32-bit constants -- that
one prebuilt CUDA kernel (``csrc/filter_scan.cu``) interprets per row, so
no compiler runs on the serving path. The encoder accepts exactly what
``supported_columns``/``_build_tile_fn`` accept and raises
:class:`PallasUnsupported` with the same messages on the rest; callers
then use the plain ``device_fn`` (filter/compile.py), as the counterpart
falls back to its XLA path. Three limits are the port's own, far beyond
real filters: at most 64 distinct columns, a stack 64 deep, and a program
of 12288 words (48 KB of shared memory).

Constants follow the reference's float32 rounding exactly: Python-float
literals round to float32 once (JAX weak typing); the polygon's
``ex2 - ex1`` and ``denom`` are computed in float64 first and then
rounded; an int32 column against a Python int wraps the literal to int32
and against a Python float compares as float64 (rewritten here into an
exact int32 compare or a constant); int64 columns compare as (signed hi,
unsigned lo) words with During/Between bounds taken by ceil/floor.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom import Point, polygon_edges
from geomesa_tpu_torch.ops.int64lanes import cmp_lanes, split_value

MAX_KERNEL_EDGES = 64  # the counterpart's unrolled edge budget
MAX_COLS = 64
MAX_DEPTH = 64
MAX_PROGRAM_WORDS = 12288
INSTR_WORDS = 8
# the counterpart refuses partitions this close to the int32 index range
# (its largest tile is 1024 x 128 rows)
MAX_ROWS = 2**31 - 1 - 1024 * 128

# opcodes (csrc/filter_scan.cu, enum Op)
OP_TRUE, OP_FALSE, OP_BBOX, OP_BBOX_ENV, OP_DWITHIN, OP_PIP = range(6)
OP_CMP_F32, OP_CMP_I32, OP_CMP_I64, OP_AND, OP_OR, OP_NOT = range(6, 12)
CMP_CODES = {"=": 0, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_CMP_NAMES = {v: k for k, v in CMP_CODES.items()}
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


class PallasUnsupported(Exception):
    """Filter shape not expressible in the scan kernel; use device_fn."""


def _check(cond, why: str):
    if not cond:
        raise PallasUnsupported(why)


def supported_columns(f: ast.Filter, sft: SimpleFeatureType) -> list[str]:
    """Device columns the kernel will read; raises PallasUnsupported."""
    from geomesa_tpu_torch.filter.compile import device_columns_for

    cols = device_columns_for(f, sft)
    for c in cols:
        if c.endswith(("__x", "__y", "__hi", "__lo",
                       "__x0", "__y0", "__x1", "__y1")):
            continue
        dtype = sft.descriptor(c).column_dtype
        _check(
            dtype in (np.float32, np.int32, np.float64),
            f"column {c}: dtype {dtype} not 32-bit-lane representable",
        )
        _check(dtype != np.float64, f"column {c} is float64")
    return cols


def plane_dtype(name: str, sft: SimpleFeatureType) -> torch.dtype:
    """Storage dtype of a staged plane (ops/scan.py)."""
    if name.endswith(("__x", "__y", "__x0", "__y0", "__x1", "__y1")):
        return torch.float32
    if name.endswith("__hi"):
        return torch.int32
    if name.endswith("__lo"):
        return torch.uint32
    dt = sft.descriptor(name).column_dtype
    return torch.int32 if dt == np.int32 else torch.float32


@dataclass
class Program:
    """An encoded filter: ``instr`` is (n_instr, 8) int32, ``consts`` the
    uint32 constant table, ``cols`` the plane read by each column slot."""

    cols: list
    col_dtypes: list
    instr: np.ndarray
    consts: np.ndarray
    depth: int
    _dev: dict = field(default_factory=dict, repr=False)
    _records: dict = field(default_factory=dict, repr=False)  # plane set -> _Record

    @property
    def n_instr(self) -> int:
        return int(self.instr.shape[0])

    def words(self) -> np.ndarray:
        return np.concatenate([self.instr.reshape(-1).view(np.uint32), self.consts])

    def device_words(self, device) -> torch.Tensor:
        """The program as one uint32 buffer on ``device`` (cached). Threads
        that build it at once all get the first one stored: a launch record
        keeps its pointer, so the stored buffer must never be replaced."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = self._dev.setdefault(key, torch.from_numpy(self.words()).to(device))
        return t


def _f32_bits(v: float) -> int:
    return int(np.array([v], np.float32).view(np.uint32)[0])


def _wrap_i32(v: int) -> int:
    v = int(v)
    if not -(2**63) <= v < 2**63:
        raise OverflowError(f"literal {v} is outside the int64 range")
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


class _Encoder:
    """AST -> Program. ``kernel=True`` applies the counterpart kernel's
    acceptance rules and its float64-then-float32 polygon constants;
    ``kernel=False`` accepts every device-supported filter and uses the
    XLA path's float32 polygon arithmetic (points_in_polygon_jax)."""

    def __init__(self, sft: SimpleFeatureType, cols: list, kernel: bool):
        self.sft = sft
        self.kernel = kernel
        self.slot = {c: i for i, c in enumerate(cols)}
        self.instr: list = []
        self.consts: list = []
        self.depth = 0
        self.max_depth = 0

    # -- emission ----------------------------------------------------------

    def _k(self, words) -> int:
        at = len(self.consts)
        self.consts.extend(int(w) & 0xFFFFFFFF for w in words)
        return at

    def _emit(self, op, cols=(), k=0, n=0, flag=0, pops=0):
        c = [self._col(x) for x in cols] + [0] * (4 - len(cols))
        self.instr.append([op, *c, k, n, flag])
        self.depth += 1 - pops
        self.max_depth = max(self.max_depth, self.depth)

    def _col(self, name: str) -> int:
        if name not in self.slot:
            raise TypeError(f"plane {name} is not among the scan's columns")
        return self.slot[name]

    def _const(self, value: bool):
        self._emit(OP_TRUE if value else OP_FALSE)

    # -- leaves ------------------------------------------------------------

    def _bbox(self, attr, xmin, ymin, xmax, ymax):
        k = self._k(_f32_bits(v) for v in (xmin, ymin, xmax, ymax))
        if self.sft.descriptor(attr).is_point:
            self._emit(OP_BBOX, (f"{attr}__x", f"{attr}__y"), k)
        else:
            # envelope overlap == exact BBOX for non-points
            pre = f"{attr}__"
            self._emit(
                OP_BBOX_ENV, (pre + "x0", pre + "y0", pre + "x1", pre + "y1"), k
            )

    def _pip(self, node):
        x1, y1, x2, y2 = polygon_edges(node.geometry.rings())
        if self.kernel:
            _check(
                len(x1) <= MAX_KERNEL_EDGES,
                f"{len(x1)} polygon edges > kernel unroll budget",
            )
            words = []
            for a, b, c, d in zip(x1, y1, x2, y2):
                a, b, c, d = float(a), float(b), float(c), float(d)
                denom = (d - b) if d != b else 1.0
                words += [_f32_bits(v) for v in (b, d, a, c - a, denom)]
        else:
            f1, g1 = x1.astype(np.float32), y1.astype(np.float32)
            f2, g2 = x2.astype(np.float32), y2.astype(np.float32)
            dx = f2 - f1  # float32 arithmetic, as on the device
            den = g2 - g1
            den = np.where(den == 0, np.float32(1.0), den).astype(np.float32)
            tab = np.stack([g1, g2, f1, dx, den], axis=1).astype(np.float32)
            words = tab.reshape(-1).view(np.uint32).tolist()
        k = self._k(words)
        neg = node.op == "disjoint"
        self._emit(
            OP_PIP, (f"{node.attr}__x", f"{node.attr}__y"), k, n=len(x1),
            flag=int(neg),
        )

    def _cmp_i64(self, attr, op, v):
        vhi, vlo = split_value(v)
        if not _I32_MIN <= vhi <= _I32_MAX:
            raise OverflowError(f"{v} is outside the int64 lane range")
        k = self._k((vhi, vlo))
        self._emit(
            OP_CMP_I64, (f"{attr}__hi", f"{attr}__lo"), k, flag=CMP_CODES[op]
        )

    def _cmp_scalar(self, attr, op, v):
        """attr <op> literal on a 32-bit scalar column."""
        if self.sft.descriptor(attr).column_dtype == np.int32:
            self._cmp_i32(attr, op, v)
        else:
            k = self._k([_f32_bits(float(v))])
            self._emit(OP_CMP_F32, (attr,), k, flag=CMP_CODES[op])

    def _cmp_i32(self, attr, op, v):
        if isinstance(v, (bool, int, np.integer)):
            # a Python int literal takes the column's type: it wraps
            k = self._k([_wrap_i32(v)])
            self._emit(OP_CMP_I32, (attr,), k, flag=CMP_CODES[op])
            return
        # a float literal promotes the compare to float64, where every
        # int32 is exact: rewrite as an exact int32 compare or a constant
        v = float(v)
        if math.isnan(v):
            return self._const(op == "<>")
        if op in ("=", "<>"):
            if v.is_integer() and _I32_MIN <= v <= _I32_MAX:
                k = self._k([int(v)])
                return self._emit(OP_CMP_I32, (attr,), k, flag=CMP_CODES[op])
            return self._const(op == "<>")
        if op in ("<", "<="):  # c <= t
            if math.isinf(v):
                return self._const(v > 0)
            t = math.ceil(v) - 1 if op == "<" else math.floor(v)
            if t >= _I32_MAX:
                return self._const(True)
            if t < _I32_MIN:
                return self._const(False)
            k = self._k([t])
            return self._emit(OP_CMP_I32, (attr,), k, flag=CMP_CODES["<="])
        # ">", ">=": c >= t
        if math.isinf(v):
            return self._const(v < 0)
        t = math.floor(v) + 1 if op == ">" else math.ceil(v)
        if t <= _I32_MIN:
            return self._const(True)
        if t > _I32_MAX:
            return self._const(False)
        k = self._k([t])
        self._emit(OP_CMP_I32, (attr,), k, flag=CMP_CODES[">="])

    # -- recursion ---------------------------------------------------------

    def rec(self, node):
        sft = self.sft
        if node is ast.Include:
            return self._const(True)
        if node is ast.Exclude:
            return self._const(False)
        if isinstance(node, (ast.And, ast.Or)):
            op = OP_AND if isinstance(node, ast.And) else OP_OR
            self.rec(node.children[0])
            for c in node.children[1:]:
                self.rec(c)
                self._emit(op, pops=2)
            return None
        if isinstance(node, ast.Not):
            self.rec(node.child)
            return self._emit(OP_NOT, pops=1)
        if isinstance(node, ast.BBox):
            return self._bbox(node.attr, node.xmin, node.ymin, node.xmax, node.ymax)
        if isinstance(node, ast.DWithin):
            if not (
                sft.descriptor(node.attr).is_point
                and isinstance(node.geometry, Point)
            ):
                # padded-envelope bbox == the exact host semantics
                e = node.geometry.envelope
                d = node.distance
                return self._bbox(
                    node.attr, e.xmin - d, e.ymin - d, e.xmax + d, e.ymax + d
                )
            k = self._k(
                _f32_bits(v)
                for v in (node.geometry.x, node.geometry.y, node.distance**2)
            )
            return self._emit(OP_DWITHIN, (f"{node.attr}__x", f"{node.attr}__y"), k)
        if isinstance(node, ast.Intersects):
            ok = (
                sft.descriptor(node.attr).is_point
                and hasattr(node.geometry, "rings")
                and node.op in ("intersects", "within", "disjoint")
            )
            if self.kernel:
                _check(ok, "intersects shape not kernelizable")
            elif not ok:
                raise TypeError(f"not device-supported: {type(node)}")
            return self._pip(node)
        if isinstance(node, (ast.During, ast.Between, ast.Compare, ast.In)):
            from geomesa_tpu_torch.filter.compile import _device_supported, _is_i64

            if self.kernel:
                _check(_device_supported(node, sft), f"{type(node).__name__}")
            elif not _device_supported(node, sft):
                raise TypeError(f"not device-supported: {type(node)}")
            i64 = _is_i64(sft, node.attr)
            if isinstance(node, (ast.During, ast.Between)):
                lo = node.t0 if isinstance(node, ast.During) else node.lo
                hi = node.t1 if isinstance(node, ast.During) else node.hi
                if i64:
                    self._cmp_i64(node.attr, ">=", math.ceil(lo))
                    self._cmp_i64(node.attr, "<=", math.floor(hi))
                else:
                    self._cmp_scalar(node.attr, ">=", lo)
                    self._cmp_scalar(node.attr, "<=", hi)
                return self._emit(OP_AND, pops=2)
            if isinstance(node, ast.Compare):
                op, v = node.op, node.value
                if not i64:
                    return self._cmp_scalar(node.attr, op, v)
                # non-integer literals vs int64 lanes: round the bound so
                # the integer compare is equivalent ('>5.5' == '>=6')
                if v != math.floor(v):
                    if op in ("=", "<>"):
                        return self._const(op == "<>")
                    if op in ("<", "<="):
                        op, v = "<=", math.floor(v)
                    else:
                        op, v = ">=", math.ceil(v)
                return self._cmp_i64(node.attr, op, int(v))
            # In
            if i64:
                vals = [int(v) for v in node.values if v == math.floor(v)]
                if not vals:
                    return self._const(False)
                for i, v in enumerate(vals):
                    self._cmp_i64(node.attr, "=", v)
                    if i:
                        self._emit(OP_OR, pops=2)
                return None
            for i, v in enumerate(node.values):
                self._cmp_scalar(node.attr, "=", v)
                if i:
                    self._emit(OP_OR, pops=2)
            return None
        if self.kernel:
            raise PallasUnsupported(f"node {type(node).__name__}")
        raise TypeError(f"not device-supported: {type(node)}")

    def program(self, cols: list) -> Program:
        instr = np.array(self.instr, np.int32).reshape(-1, INSTR_WORDS)
        consts = np.array(self.consts, np.uint32)
        return Program(
            cols=list(cols),
            col_dtypes=[plane_dtype(c, self.sft) for c in cols],
            instr=instr,
            consts=consts,
            depth=self.max_depth,
        )


def encode_kernel_program(f: ast.Filter, sft: SimpleFeatureType) -> Program:
    """The filter's kernel program; raises PallasUnsupported where the
    counterpart's ``build_pallas_scan`` does (plus the port's size limits)."""
    cols = supported_columns(f, sft)
    _check(bool(cols), "no device columns (constant filter)")
    enc = _Encoder(sft, cols, kernel=True)
    enc.rec(f)
    prog = enc.program(cols)
    _check(len(cols) <= MAX_COLS, f"{len(cols)} columns > {MAX_COLS}")
    _check(prog.depth <= MAX_DEPTH, f"filter nesting deeper than {MAX_DEPTH}")
    _check(
        prog.instr.size + prog.consts.size <= MAX_PROGRAM_WORDS,
        f"program of {prog.instr.size + prog.consts.size} words > "
        f"{MAX_PROGRAM_WORDS}",
    )
    return prog


def encode_device_program(f: ast.Filter, sft: SimpleFeatureType, cols: list) -> Program:
    """Program for the plain ``device_fn`` path (no kernel limits; the XLA
    path's float32 polygon arithmetic)."""
    enc = _Encoder(sft, cols, kernel=False)
    enc.rec(f)
    return enc.program(cols)


# -- plain version -----------------------------------------------------------


def _cmp_t(op: str, a, b):
    return {
        "=": torch.eq, "<>": torch.ne, "<": torch.lt,
        "<=": torch.le, ">": torch.gt, ">=": torch.ge,
    }[op](a, b)


def run_program_plain(prog: Program, cols: dict, n: "int | None" = None,
                      valid=None) -> torch.Tensor:
    """Plain PyTorch version of the filter scan: interpret ``prog`` with
    tensor ops over whole columns and return the bool mask, ANDed with
    ``valid`` (a bool plane of live rows) when given. Float32 arithmetic
    runs one rounded op at a time, as the kernel does."""
    ts = [cols[c] for c in prog.cols]
    if n is None:
        n = int(ts[0].shape[0]) if ts else (0 if valid is None else int(valid.shape[0]))
    dev = ts[0].device if ts else (torch.device("cpu") if valid is None else valid.device)
    kf = prog.consts.view(np.float32)
    ki = prog.consts.view(np.int32)

    def f32(i):
        return torch.tensor(float(kf[i]), dtype=torch.float32, device=dev)

    stack: list = []
    for op, c0, c1, c2, c3, k, cnt, flag in prog.instr.tolist():
        if op in (OP_TRUE, OP_FALSE):
            stack.append(torch.full((n,), op == OP_TRUE, dtype=torch.bool, device=dev))
        elif op == OP_BBOX:
            x, y = ts[c0], ts[c1]
            stack.append(
                (x >= f32(k)) & (x <= f32(k + 2)) & (y >= f32(k + 1)) & (y <= f32(k + 3))
            )
        elif op == OP_BBOX_ENV:
            stack.append(
                (ts[c2] >= f32(k)) & (ts[c0] <= f32(k + 2))
                & (ts[c3] >= f32(k + 1)) & (ts[c1] <= f32(k + 3))
            )
        elif op == OP_DWITHIN:
            dx = ts[c0] - f32(k)
            dy = ts[c1] - f32(k + 1)
            stack.append(dx * dx + dy * dy <= f32(k + 2))
        elif op == OP_PIP:
            px, py = ts[c0], ts[c1]
            cross = torch.zeros(n, dtype=torch.int32, device=dev)
            for e in range(cnt):
                b = k + 5 * e
                ey1, ey2, ex1, dxe, den = (f32(b + j) for j in range(5))
                straddle = (ey1 > py) != (ey2 > py)
                xint = ex1 + ((py - ey1) * dxe) / den
                cross += (straddle & (px < xint)).to(torch.int32)
            m = (cross & 1) == 1
            stack.append(~m if flag else m)
        elif op == OP_CMP_F32:
            stack.append(_cmp_t(_CMP_NAMES[flag], ts[c0], f32(k)))
        elif op == OP_CMP_I32:
            stack.append(_cmp_t(_CMP_NAMES[flag], ts[c0], int(ki[k])))
        elif op == OP_CMP_I64:
            stack.append(cmp_lanes(
                _CMP_NAMES[flag], ts[c0], ts[c1], int(ki[k]), int(prog.consts[k + 1])
            ))
        elif op in (OP_AND, OP_OR):
            b = stack.pop()
            a = stack.pop()
            stack.append(a & b if op == OP_AND else a | b)
        elif op == OP_NOT:
            stack.append(~stack.pop())
        else:
            raise ValueError(f"bad opcode {op}")
    if len(stack) != 1:
        raise ValueError(f"malformed program: stack holds {len(stack)} values")
    return kernels.and_valid(stack[0], valid)


# -- kernel wrapper ----------------------------------------------------------
#
# A launch reads a plane set through a launch record: the checks below run
# once per plane set, and the record keeps what the C entry point reads
# (csrc/filter_scan.cu FilterScanLaunch) as ready ctypes structures. Records
# live on their Program, keyed on everything the checks read, at most
# RECORDS_PER_PROGRAM of them (a store query stages new planes every run);
# they hold pointer ints, never tensors, and are never changed once built,
# so the scheduler's workers share them. What a call writes, the output, is
# its own.

RECORDS_PER_PROGRAM = 8
# shared memory on Hopper (csrc/filter_scan.cu): what an SM shares among its
# blocks, the most one block may take, and the system's share per block
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1_024
SMEM_HEADER = 256  # the stages' mbarriers and the count's warp sums
# (blocks per SM, rows per stage, stage counts), tried in order after the
# first choice, 2 stages on 3 blocks an SM (stage_plan); a sweep of rows,
# stages and blocks on the H100 put these first
_PLANS = (
    (2, (2048, 1024), (3, 2)),
    (1, (4096, 2048, 1024, 512, 256, 128, 64, 32), (4, 3, 2)),
)
_NAMES = ("filter_scan_count", "filter_scan_mask")
_records_lock = threading.Lock()
_gm_filter_scan = None  # the C entry point, bound at the first launch
_sms: dict = {}


class _Launch(ctypes.Structure):
    _fields_ = [
        ("cols", ctypes.c_uint64 * MAX_COLS), ("valid", ctypes.c_uint64),
        ("prog", ctypes.c_uint64), ("n", ctypes.c_int64), ("n_cols", ctypes.c_int),
        ("n_instr", ctypes.c_int), ("n_const", ctypes.c_int), ("rows", ctypes.c_int),
        ("stages", ctypes.c_int), ("grid", ctypes.c_int), ("device", ctypes.c_int),
    ]


def _pad128(b: int) -> int:
    return -(-b // 128) * 128


def stage_smem(n_cols: int, words: int, rows: int, stages: int, valid: bool,
               mask: bool) -> int:
    """Dynamic shared memory of one block of the kernel: the header, the
    program, and ``stages`` stages of ``rows`` rows of each column, the
    validity bytes (and 16 for their alignment) and for a mask its
    ``rows`` bytes; each part padded to 128 bytes."""
    stage = 4 * rows * n_cols + (_pad128(rows + 16) if valid else 0)
    return SMEM_HEADER + _pad128(4 * words) + stages * (stage + (_pad128(rows) if mask else 0))


def stage_plan(n_cols: int, words: int, valid: bool, mask: bool) -> tuple:
    """(rows per stage R, stages S, blocks per SM) for a program of
    ``n_cols`` distinct columns and ``words`` program words: 2 stages of
    2048 rows (1024 from 3 columns on: about 16 KB a stage) on 3 blocks an
    SM where they fit, else the first plan of ``_PLANS`` whose layout fits
    the blocks' share of an SM. Every legal program fits (at worst 32 rows
    in 2 stages)."""
    first = ((3, (2048 if n_cols <= 2 else 1024,), (2,)),)
    for per_sm, rows_opts, stage_opts in first + _PLANS:
        budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - SMEM_RESERVED)
        for rows in rows_opts:
            for stages in stage_opts:
                if stage_smem(n_cols, words, rows, stages, valid, mask) <= budget:
                    return rows, stages, per_sm
    raise ValueError(f"no stage layout for {n_cols} columns and {words} words")


def _sm_count(dev) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


class _Record:
    """One validated plane set of one program: the count's and the mask's
    launch operands, and the index of the device they run on."""

    __slots__ = ("args", "addrs", "grids", "index", "n", "valid")

    def __init__(self, prog: Program, ts: list, valid):
        dev = ts[0].device
        n = int(ts[0].shape[0])
        words = prog.device_words(dev)
        vptr = kernels.valid_ptr(valid)
        self.args, self.grids = [], []
        for mask in (False, True):
            rows, stages, per_sm = stage_plan(
                len(ts), prog.instr.size + prog.consts.size, vptr is not None, mask)
            grid = max(1, min(-(-n // rows), per_sm * _sm_count(dev)))
            a = _Launch(n=n, n_cols=len(ts), n_instr=prog.n_instr,
                        n_const=int(prog.consts.size), rows=rows, stages=stages, grid=grid,
                        device=dev.index or 0, valid=vptr or 0, prog=words.data_ptr())
            for i, t in enumerate(ts):
                a.cols[i] = t.data_ptr()
            self.args.append(a)
            self.grids.append(grid)
        self.addrs = tuple(map(ctypes.addressof, self.args))
        self.index, self.n, self.valid = dev.index, n, vptr is not None


def _plane_key(t) -> tuple:
    return (t.data_ptr(), t.dtype, t.shape, t.stride(), t.device)


def _columns(prog: Program, ts: list) -> None:
    n = ts[0].shape
    dev = ts[0].device
    for c, t, dt in zip(prog.cols, ts, prog.col_dtypes):
        if t.dtype != dt:
            raise TypeError(f"plane {c}: {t.dtype}, the scan reads {dt}")
        if t.dim() != 1 or t.shape != n:
            raise ValueError(f"plane {c}: shape {tuple(t.shape)} != {tuple(n)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"plane {c} must be contiguous on {dev}")
    if n[0] > MAX_ROWS:
        raise PallasUnsupported("partition too large for int32 indexing")


def _record(prog: Program, ts: list, valid) -> "_Record | None":
    """The launch record of this plane set, or None for CPU planes (the
    plain version). A plane set not seen before (any plane's pointer,
    dtype, shape, stride or device, or the validity plane's, differs) is
    checked as a whole, and raises where the checks fail."""
    key = tuple(map(_plane_key, ts))
    if valid is not None:
        key += (_plane_key(valid),)
    rec = prog._records.get(key)
    if rec is not None:
        return rec
    _columns(prog, ts)
    kernels.check_valid(valid, int(ts[0].shape[0]), ts[0].device)
    if not kernels.on_cuda(ts[0]):
        return None
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("filter-scan planes must be 16-byte aligned")
    rec = _Record(prog, ts, valid)
    with _records_lock:
        prog._records[key] = rec
        while len(prog._records) > RECORDS_PER_PROGRAM:
            del prog._records[next(iter(prog._records))]
    return rec


def _launch(rec: _Record, want_mask: bool) -> torch.Tensor:
    global _gm_filter_scan
    if _gm_filter_scan is None:
        from geomesa_tpu_torch.kernels import _build

        _gm_filter_scan = _build.load("filter_scan").gm_filter_scan
    # (device=rec.index: an int is the CUDA ordinal, and parses fastest)
    if want_mask:
        out = torch.empty(rec.n, dtype=torch.bool, device=rec.index)
    else:  # the total, then one partial per block
        out = torch.empty(rec.grids[0] + 1, dtype=torch.int32, device=rec.index)
    # on the current stream of the planes' device (its raw handle: what
    # torch.cuda.current_stream(i).cuda_stream reads, without the Stream
    # object); the C side makes the device current only if it is not
    rc = _gm_filter_scan(rec.addrs[want_mask], out.data_ptr(), int(want_mask),
                         torch._C._cuda_getCurrentRawStream(rec.index))
    name = _NAMES[want_mask]
    kernels.check_status(rc, name)
    kernels.count_launch(name, valid=rec.valid)
    return out if want_mask else out[0]


def filter_scan_count(prog: Program, cols: dict, valid=None) -> torch.Tensor:
    """int32 hit count of the program over the staged columns' rows that
    ``valid`` marks live (None: every row): the CUDA kernel for CUDA
    planes, the plain version for CPU planes."""
    rec = _record(prog, [cols[c] for c in prog.cols], valid)
    if rec is not None:
        return _launch(rec, False)
    return run_program_plain(prog, cols, valid=valid).sum(dtype=torch.int32)


def filter_scan_mask(prog: Program, cols: dict, valid=None) -> torch.Tensor:
    """bool hit mask, False on dead rows; routing as
    :func:`filter_scan_count`."""
    rec = _record(prog, [cols[c] for c in prog.cols], valid)
    if rec is not None:
        return _launch(rec, True)
    return run_program_plain(prog, cols, valid=valid)
