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

    @property
    def n_instr(self) -> int:
        return int(self.instr.shape[0])

    def words(self) -> np.ndarray:
        return np.concatenate([self.instr.reshape(-1).view(np.uint32), self.consts])

    def device_words(self, device) -> torch.Tensor:
        """The program as one uint32 buffer on ``device`` (cached)."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self.words()).to(device)
            self._dev[key] = t
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


def run_program_plain(prog: Program, cols: dict, n: "int | None" = None) -> torch.Tensor:
    """Plain PyTorch version of the filter scan: interpret ``prog`` with
    tensor ops over whole columns and return the bool mask. Float32
    arithmetic runs one rounded op at a time, as the kernel does."""
    ts = [cols[c] for c in prog.cols]
    if n is None:
        n = int(ts[0].shape[0]) if ts else 0
    dev = ts[0].device if ts else torch.device("cpu")
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
    return stack[0]


# -- kernel wrapper ----------------------------------------------------------


def _columns(prog: Program, cols: dict) -> list:
    ts = [cols[c] for c in prog.cols]
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
    return ts


def _launch(prog: Program, ts: list, want_mask: bool) -> torch.Tensor:
    from geomesa_tpu_torch.kernels import _build

    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("filter-scan planes must be 16-byte aligned")
    lib = _build.load("filter_scan")
    fn = lib.gm_filter_scan
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    dev = ts[0].device
    n = int(ts[0].shape[0])
    ptrs = np.array([t.data_ptr() for t in ts], np.uint64)
    with torch.cuda.device(dev):
        words = prog.device_words(dev)
        out = (
            torch.empty(n, dtype=torch.bool, device=dev)
            if want_mask
            else torch.empty((), dtype=torch.int32, device=dev)
        )
        rc = fn(
            ptrs.ctypes.data, len(ts), words.data_ptr(), prog.n_instr,
            int(prog.consts.size), n, int(want_mask), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    name = f"filter_scan_{'mask' if want_mask else 'count'}"
    kernels.check_status(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def filter_scan_count(prog: Program, cols: dict) -> torch.Tensor:
    """int32 hit count of the program over the staged columns: the CUDA
    kernel for CUDA planes, the plain version for CPU planes."""
    ts = _columns(prog, cols)
    if kernels.on_cuda(ts[0]):
        return _launch(prog, ts, want_mask=False)
    return run_program_plain(prog, cols).sum(dtype=torch.int32)


def filter_scan_mask(prog: Program, cols: dict) -> torch.Tensor:
    """bool hit mask; routing as :func:`filter_scan_count`."""
    ts = _columns(prog, cols)
    if kernels.on_cuda(ts[0]):
        return _launch(prog, ts, want_mask=True)
    return run_program_plain(prog, cols)
