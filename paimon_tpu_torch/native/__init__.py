"""The host C library, loaded through ctypes.

Counterpart of paimon_tpu/native/__init__.py: the merge plane's
radix_sort.c (the radix argsort, the fused winner select and the
offset-value-coded merge) and the point-lookup plane's probe.c (the
batched SST probe: bloom filter and binary search over the flat sorted
key buffer, GIL released for the call).  The library compiles with the host C
compiler on first use into the package's gitignored `_build/`
directory, never next to the source; the build writes a temporary name
and renames it, so concurrent processes may build at once.  Every
wrapper returns None when the library is unavailable (no compiler, a
failed build, or PAIMON_DISABLE_NATIVE=1, read on every call), and the
callers take their numpy routes; the probe is optional per call, so a
library built before probe.c existed degrades the probe alone.
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
           "ovc_merge_lanes", "sst_probe", "sst_probe_prepare",
           "sst_probe_prepared", "LIB_PATH", "SOURCES"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("radix_sort.c", "probe.c")
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


def sst_probe(flat_keys: np.ndarray, n_rows: int, key_width: int,
              bloom_bits: Optional[np.ndarray], bloom_k: int,
              qkeys: np.ndarray, qhashes: np.ndarray) -> Optional[tuple]:
    """Batched SST probe, one C call for the whole query batch: per
    query the matching row range (lo int64[m], hi int64[m]; lo == hi a
    miss, -1/-1 a bloom rejection), or None when the library or its
    probe symbol is unavailable."""
    fn = _raw_probe()
    if fn is None:
        return None
    return sst_probe_prepared(
        _prepare(fn, flat_keys, n_rows, key_width, bloom_bits, bloom_k),
        qkeys, qhashes)


_RAW_PROBE: dict = {}


def _raw_probe():
    """`sst_probe_batch` bound through a raw CFUNCTYPE of c_void_p
    arguments (no per-call ndpointer validation, which at a few keys a
    probe rivals the search); one binding per loaded library.  Foreign
    calls release the GIL."""
    lib = load()
    if lib is None or not hasattr(lib, "sst_probe_batch"):
        return None
    fn = _RAW_PROBE.get(id(lib))
    if fn is None:
        addr = ctypes.cast(lib.sst_probe_batch, ctypes.c_void_p).value
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        fn = ctypes.CFUNCTYPE(ctypes.c_int, vp, i64, i64, vp, i64, i64,
                              vp, vp, i64, vp, vp)(addr)
        _RAW_PROBE[id(lib)] = fn
    return fn


def sst_probe_prepare(flat_keys: np.ndarray, n_rows: int, key_width: int,
                      bloom_bits: Optional[np.ndarray],
                      bloom_k: int) -> Optional[tuple]:
    """Pin an SST's static probe arguments (flat key buffer and bloom
    words) as raw pointers, once per reader; None when the probe is
    unavailable."""
    fn = _raw_probe()
    if fn is None:
        return None
    return _prepare(fn, flat_keys, n_rows, key_width, bloom_bits, bloom_k)


def _prepare(fn, flat_keys, n_rows, key_width, bloom_bits, bloom_k):
    fk = np.ascontiguousarray(flat_keys, dtype=np.uint8)
    bb = np.ascontiguousarray(bloom_bits, dtype=np.uint64) \
        if bloom_bits is not None else np.zeros(0, dtype=np.uint64)
    # the trailing arrays keep the pinned buffers alive with the tuple
    return (fn, fk.ctypes.data, int(n_rows), int(key_width),
            bb.ctypes.data, len(bb), int(bloom_k),
            (fk, bb))


def sst_probe_prepared(prep: tuple, qkeys: np.ndarray,
                       qhashes: np.ndarray) -> Optional[tuple]:
    """`sst_probe` over a `sst_probe_prepare` context: only the query
    arrays cross per call; lo and hi share one allocation."""
    fn, fk_ptr, n_rows, kw, bb_ptr, bb_len, bk, _pin = prep
    qk = np.ascontiguousarray(qkeys, dtype=np.uint8)
    qh = np.ascontiguousarray(qhashes, dtype=np.uint64)
    m = len(qh)
    res = np.empty(2 * m, dtype=np.int64)
    base = res.__array_interface__["data"][0]
    if fn(fk_ptr, n_rows, kw, bb_ptr, bb_len, bk,
          qk.__array_interface__["data"][0],
          qh.__array_interface__["data"][0], m, base, base + 8 * m) != 0:
        return None
    return res[:m], res[m:]
