"""The host merge routes' C library, loaded through ctypes.

Counterpart of paimon_tpu/native/__init__.py, reduced to the merge
plane (radix_sort.c: the radix argsort, the fused winner select and the
offset-value-coded merge).  The library compiles with the host C
compiler on first use into the package's gitignored `_build/`
directory, never next to the source; the build writes a temporary name
and renames it, so concurrent processes may build at once.  Every
wrapper returns None when the library is unavailable (no compiler, a
failed build, or PAIMON_DISABLE_NATIVE=1, read on every call), and the
callers take their numpy routes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

__all__ = ["load", "predicted_available", "radix_argsort", "merge_winners",
           "ovc_codes_u64", "ovc_codes_lanes", "ovc_merge_u64",
           "ovc_merge_lanes", "LIB_PATH", "SOURCES"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("radix_sort.c",)
_SRCS = tuple(os.path.join(_DIR, s) for s in SOURCES)
LIB_PATH = os.path.join(os.path.dirname(_DIR), "_build",
                        "_paimon_torch_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _disabled() -> bool:
    return os.environ.get("PAIMON_DISABLE_NATIVE") == "1"


def _compiler() -> Optional[str]:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    return None


def _compile(cc: str, out: str) -> Optional[str]:
    """Compile every source into `out` through a temporary name; the
    compiler's complaint goes to stderr and None comes back on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + f".build-{os.getpid()}-{threading.get_ident()}"
    cmd = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, *_SRCS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            sys.stderr.write(f"paimon_tpu_torch.native: build failed:\n"
                             f"{proc.stderr[-1000:]}\n")
            return None
        os.replace(tmp, out)           # atomic against concurrent builds
        return out
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"paimon_tpu_torch.native: build failed: {e}\n")
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.radix_argsort_u64.argtypes = [p_u64, i64, p_i32]
    lib.merge_winners_u64.argtypes = [p_u64, p_i64, i64, ctypes.c_int,
                                      p_i32, p_u8]
    lib.ovc_codes_u64.argtypes = [p_u64, p_i64, p_i64, i64, p_u64]
    lib.ovc_codes_lanes.argtypes = [p_u32, p_i64, p_i64, i64, i64, p_u64]
    lib.ovc_merge_u64.argtypes = [p_u64, p_i64, p_u64, p_i64, i64, i64,
                                  p_i32, p_u64]
    lib.ovc_merge_lanes.argtypes = [p_u32, p_i64, p_u64, p_i64, i64, i64,
                                    i64, p_i32, p_u64]
    for fn in (lib.radix_argsort_u64, lib.merge_winners_u64,
               lib.ovc_codes_u64, lib.ovc_codes_lanes, lib.ovc_merge_u64,
               lib.ovc_merge_lanes):
        fn.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when unavailable."""
    global _lib, _tried
    if _disabled():
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        cc = _compiler()
        out = LIB_PATH
        fresh = os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(s) for s in _SRCS)
        if not fresh and (cc is None or _compile(cc, out) is None):
            _tried = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(out))
        # a stale library from another platform fails to open: build
        # afresh once
        except OSError:
            if cc is not None and _compile(cc, out) is not None:
                _lib = _bind(ctypes.CDLL(out))
        _tried = True
        return _lib


_predicted: Optional[bool] = None


def predicted_available() -> bool:
    """Will the library (eventually) be available in this process?  A
    cheap predicate for the cost model, which must not trigger the
    build: a loaded library -> True; disabled, no compiler or a failed
    build -> False; otherwise a compiler on PATH."""
    global _predicted
    if _disabled():
        return False
    if _lib is not None:
        return True
    if _tried:
        return False
    if _predicted is None:
        _predicted = _compiler() is not None
    return _predicted


def radix_argsort(keys: np.ndarray) -> Optional[np.ndarray]:
    """Stable ascending argsort of uint64 keys via the C radix sort;
    None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    perm = np.empty(len(keys), dtype=np.int32)
    if lib.radix_argsort_u64(keys, len(keys), perm) != 0:
        return None
    return perm


def merge_winners(keys: np.ndarray, seq: np.ndarray, keep_last: bool
                  ) -> Optional[tuple]:
    """(perm, winner_mask_in_sorted_order) via the fused C path, or
    None when unavailable."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    n = len(keys)
    perm = np.empty(n, dtype=np.int32)
    winner = np.empty(n, dtype=np.uint8)
    if lib.merge_winners_u64(keys, seq, n, int(keep_last), perm,
                             winner) != 0:
        return None
    return perm, winner.view(bool)


def _arrays(seq, starts):
    return (np.ascontiguousarray(seq, dtype=np.int64),
            np.ascontiguousarray(starts, dtype=np.int64))


def ovc_codes_u64(keys: np.ndarray, seq: np.ndarray,
                  starts: np.ndarray) -> Optional[np.ndarray]:
    """Initial per-run offset-value codes for packed u64 keys, or None
    when the library is unavailable or a run violates its (key, seq)
    ascending sort contract."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    seq, starts = _arrays(seq, starts)
    codes = np.empty(len(keys), dtype=np.uint64)
    if lib.ovc_codes_u64(keys, seq, starts, len(starts) - 1, codes) != 0:
        return None
    return codes


def ovc_codes_lanes(lanes: np.ndarray, seq: np.ndarray,
                    starts: np.ndarray) -> Optional[np.ndarray]:
    """Lane-matrix variant of ovc_codes_u64."""
    lib = load()
    if lib is None:
        return None
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    seq, starts = _arrays(seq, starts)
    codes = np.empty(lanes.shape[0], dtype=np.uint64)
    if lib.ovc_codes_lanes(lanes, seq, starts, len(starts) - 1,
                           lanes.shape[1], codes) != 0:
        return None
    return codes


def ovc_merge_u64(keys: np.ndarray, seq: np.ndarray,
                  starts: np.ndarray) -> Optional[tuple]:
    """Offset-value coded k-way merge of sorted runs over packed u64
    keys: one C pass computes the per-run codes (verifying the sort
    contract), a second merges.  (perm, code_out) in merged order, or
    None when the library is unavailable or a run violates its
    contract."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    seq, starts = _arrays(seq, starts)
    n, k = len(keys), len(starts) - 1
    codes = np.empty(n, dtype=np.uint64)
    if lib.ovc_codes_u64(keys, seq, starts, k, codes) != 0:
        return None
    perm = np.empty(n, dtype=np.int32)
    code = np.empty(n, dtype=np.uint64)
    if lib.ovc_merge_u64(keys, seq, codes, starts, k, n, perm, code) != 0:
        return None
    return perm, code


def ovc_merge_lanes(lanes: np.ndarray, seq: np.ndarray,
                    starts: np.ndarray) -> Optional[tuple]:
    """Lane-matrix variant of ovc_merge_u64 for multi-lane keys."""
    lib = load()
    if lib is None:
        return None
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    seq, starts = _arrays(seq, starts)
    (n, num_lanes), k = lanes.shape, len(starts) - 1
    codes = np.empty(n, dtype=np.uint64)
    if lib.ovc_codes_lanes(lanes, seq, starts, k, num_lanes, codes) != 0:
        return None
    perm = np.empty(n, dtype=np.int32)
    code = np.empty(n, dtype=np.uint64)
    if lib.ovc_merge_lanes(lanes, seq, codes, starts, k, n, num_lanes,
                           perm, code) != 0:
        return None
    return perm, code
