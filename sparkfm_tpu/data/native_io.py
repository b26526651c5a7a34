"""ctypes bridge to the native (C++) data-loading fast paths.

Loads native/build/libfm_parser.so and native/build/dedup_plan.so, building
them from native/*.cpp with the repo Makefile on first use (and again when a
source is newer than its library) if a C++ toolchain is available. The
libraries are build outputs, never committed. Set SPARKFM_NO_NATIVE=1 to
force the pure-Python fallbacks (sparkfm_tpu/data/libfm.py is the semantics
reference; tests/test_native_io.py pins byte-for-byte parity).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libfm_parser.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _ensure_built(so_path: str) -> bool:
    """Run ``make`` when ``so_path`` is missing or older than its source
    (native/<name>.cpp). Returns False if the build fails."""
    src = os.path.join(_NATIVE_DIR,
                       os.path.basename(so_path)[:-len(".so")] + ".cpp")
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src)):
        return True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(so_path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if os.environ.get("SPARKFM_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _ensure_built(_SO_PATH):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.lf_scan.restype = ctypes.c_int
        lib.lf_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.lf_fill.restype = ctypes.c_int64
        lib.lf_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_libfm_padded(path: str, max_nnz: Optional[int] = None
                       ) -> Optional[Tuple]:
    """Parse a libFM file straight into padded-CSR numpy arrays.

    Returns (y, ids, vals, max_index) or None if the native library is
    unavailable. Two native passes: scan (sizes) + fill (writes into
    caller-owned zeroed arrays) — no per-row Python objects at any point.
    """
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    n = len(buf)
    rows = ctypes.c_int64()
    mnnz = ctypes.c_int64()
    midx = ctypes.c_int64()
    if lib.lf_scan(buf, n, ctypes.byref(rows), ctypes.byref(mnnz),
                   ctypes.byref(midx)) != 0:
        return None
    r = rows.value
    if r == 0:
        return (np.zeros((0,), np.float32), np.zeros((0, 1), np.int32),
                np.zeros((0, 1), np.float32), -1)
    L = max(1, mnnz.value if max_nnz is None else max_nnz)
    y = np.zeros((r,), np.float32)
    ids = np.zeros((r, L), np.int32)
    vals = np.zeros((r, L), np.float32)
    filled = lib.lf_fill(
        buf, n, L,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if filled != r:
        return None
    return y, ids, vals, int(midx.value)


# ---------------------------------------------------------------------------
# Native dedup-plan builder (native/dedup_plan.cpp)

_DP_SO = os.path.join(_NATIVE_DIR, "build", "dedup_plan.so")
_dp_lib = None
_dp_failed = False


def _load_dedup() -> Optional[ctypes.CDLL]:
    global _dp_lib, _dp_failed
    if os.environ.get("SPARKFM_NO_NATIVE"):
        return None
    with _lock:
        if _dp_lib is not None:
            return _dp_lib
        if _dp_failed:
            return None
        if not _ensure_built(_DP_SO):
            _dp_failed = True
            return None
        try:
            lib = ctypes.CDLL(_DP_SO)
        except OSError:
            _dp_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.dp_build.restype = ctypes.c_int
        lib.dp_build.argtypes = [
            i32p, f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p, i32p, i32p, f32p, i32p, i32p]
        _dp_lib = lib
        return _dp_lib


def dedup_available() -> bool:
    """True when the native dedup-plan builder is loaded (False under
    SPARKFM_NO_NATIVE or when it cannot be built)."""
    return _load_dedup() is not None


def dedup_plan_native(ids: np.ndarray, budget: int, fill: int,
                      vals: Optional[np.ndarray] = None):
    """Native twin of ops.embedding.host_dedup's array math.

    Returns (uids, ranks, count, overflow, order, seg, svals, sex) as
    numpy arrays (svals/sex None when vals is None), or None when the
    native library is unavailable (radix sort + fused derivation
    passes).
    """
    lib = _load_dedup()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, np.int32)
    shape = ids.shape
    flat = ids.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return None
    order = np.empty((n,), np.int32)
    ranks = np.empty((n,), np.int32)
    seg = np.empty((n,), np.int32)
    uids = np.empty((budget,), np.int32)
    out2 = np.zeros((2,), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if vals is not None:
        vflat = np.ascontiguousarray(vals, np.float32).reshape(-1)
        svals = np.empty((n,), np.float32)
        sex = np.empty((n,), np.int32)
        vp = vflat.ctypes.data_as(f32p)
        sp = svals.ctypes.data_as(f32p)
        xp = sex.ctypes.data_as(i32p)
    else:
        svals = sex = None
        vp = ctypes.cast(None, f32p)
        sp = ctypes.cast(None, f32p)
        xp = ctypes.cast(None, i32p)
    rc = lib.dp_build(
        flat.ctypes.data_as(i32p), vp, n, int(shape[-1]), int(budget),
        int(fill), order.ctypes.data_as(i32p),
        ranks.ctypes.data_as(i32p), seg.ctypes.data_as(i32p),
        uids.ctypes.data_as(i32p), sp, xp,
        out2.ctypes.data_as(i32p))
    if rc != 0:
        return None
    return (uids, ranks.reshape(shape), np.int32(out2[0]),
            np.bool_(bool(out2[1])), order, seg, svals, sex)
