"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
for ``sm_90a``. Libraries land in ``geomesa_tpu_torch/_build/``, named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds and an
unchanged one loads the existing file. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them. Each entry point's
``argtypes``/``restype`` (:data:`SIGNATURES`) are bound once, when its
library loads: the wrappers call them from several threads at once.

Nothing here runs at import: the host without a card imports every
module of the port.

These builds are the port's only compiles. Each library load reports to
the build listeners (:func:`add_build_listener`; the compile ledger is
one): a library found already built as a hit, an ``nvcc`` run as a miss
with its seconds. :func:`compile_cache_stats` is the ``compile_cache``
entry of the server's ``/stats`` (the counterpart's persistent XLA
cache, ``jaxconf.compile_cache_stats``): ``dir`` is :data:`BUILD_DIR`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("dimscan", "dimscan_baked", "zscan", "filter_scan", "density")

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# every C entry point of each source: (argtypes, restype); a pointer, the
# stream and a null validity plane included, is c_void_p (a plain int
# would cut it to 32 bits)
SIGNATURES = {
    "dimscan": {
        "gm_dimscan": ([_P] * 4 + [_LL, _P, _I, _I, _P, _P], _I),
        "gm_dimscan_batched": ([_P] * 4 + [_LL, _P] + [_I] * 7 + [_P, _P], _I),
        "gm_dimscan_batched_compare": ([_P] * 4 + [_LL, _P, _I, _I, _I, _P, _P], _I),
    },
    "dimscan_baked": {
        "gm_dimscan_baked": ([_P] * 3 + [_LL, _P, _P, _I, _I, _P, _P], _I),
    },
    "zscan": {
        "gm_zscan": ([_P] * 4 + [_LL, _P] + [_I] * 5 + [_P, _P], _I),
        "gm_zscan_batched": ([_P] * 4 + [_LL, _P] + [_I] * 9 + [_P, _P], _I),
    },
    "filter_scan": {
        "gm_filter_scan": ([_P, _P, _I, _P], _I),
    },
    "density": {
        "gm_density": ([_P] * 4 + [_LL] + [_D] * 6 + [_I] * 4 + [_P, _P], _I),
    },
}

# -fmad=false: the filter scan's float32 distance and crossing tests and the
# density kernel's float64 pixel math must round every product and sum on
# its own, as the reference does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
_logs: dict = {}
_events = {"requests": 0, "hits": 0}
_built_s: dict = {}  # source -> seconds of the nvcc run this process made
_listeners: list = []


def add_build_listener(fn) -> None:
    """``fn(name, built, seconds)`` after each library load: ``built`` is
    True for an ``nvcc`` run (a miss), False for a library found built."""
    if fn not in _listeners:
        _listeners.append(fn)


def _note_build(name: str, built: bool, dur_s: float) -> None:
    _events["requests"] += 1
    if not built:
        _events["hits"] += 1
    for fn in list(_listeners):
        try:
            fn(name, built, dur_s)
        except Exception:  # a listener must not fail the build
            pass


def compile_cache_stats() -> dict:
    """The build cache for ``/stats``: its directory, the loads that found
    a library built (hits) or ran ``nvcc`` (misses), and the libraries on
    disk."""
    d: dict = {
        "dir": str(BUILD_DIR),
        "enabled": True,
        "requests": _events["requests"],
        "hits": _events["hits"],
        "misses": max(0, _events["requests"] - _events["hits"]),
    }
    try:
        entries = [e for e in os.scandir(BUILD_DIR) if e.is_file() and e.name.endswith(".so")]
        d["entries"] = len(entries)
        d["bytes"] = sum(e.stat().st_size for e in entries)
    except OSError:
        pass
    return d


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    # the shared headers (csrc/*.cuh) count as part of every source
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Popen of the nvcc build for one source, or None if already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, t0


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    _logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    _built_s[name] = time.perf_counter() - t0


def build_all() -> dict:
    """Compile every source (one nvcc each, all started together) and load
    them. Returns {name: compiler output} for the sources built now."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for n, s in started.items():
            _finish(n, s)
        for n in SOURCES:
            _load_locked(n)
        return {n: _logs[n] for n in SOURCES if started[n] is not None}


def _load_locked(name: str):
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        built = name in _built_s
        _note_build(name, built, _built_s.get(name, 0.0))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        return _load_locked(name)
