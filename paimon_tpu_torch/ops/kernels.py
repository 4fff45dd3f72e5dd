"""Hand-written CUDA kernels of the merge plane, and their plain versions.

Counterpart of paimon_tpu/ops/pallas_kernels.py.  The one kernel is the
winner-select's neighbour-equality mask (`_eq_next_fn` there, plain and
offset-value-code variants), written in CUDA C++ for sm_90a in
csrc/eq_next_mask.cu.  It is built with nvcc into a shared library with
a plain C interface at first use and loaded with ctypes.

`eq_next_mask` launches the kernel for CUDA tensors and runs
`eq_next_mask_plain` for CPU tensors; nothing else selects between the
two.  With `seg_len` one launch serves a batch of merges (the bucket
lanes of a mesh step) laid end to end.  `EQ_NEXT_LAUNCHES` counts
kernel launches, so a run can show that its merges went through the
kernel; `EQ_NEXT_OVC_LAUNCHES` counts the launches of the
offset-value-code variant among them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

__all__ = ["eq_next_mask", "eq_next_mask_plain", "build",
           "EQ_NEXT_LAUNCHES", "EQ_NEXT_OVC_LAUNCHES", "OVC_SENTINEL_I32"]

# ovc_off value marking rows whose offset-value code is unusable (run
# starts), as the int32 bit pattern of ops/ovc.OVC_OFF_SENTINEL
OVC_SENTINEL_I32 = -1

EQ_NEXT_LAUNCHES = 0
EQ_NEXT_OVC_LAUNCHES = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "eq_next_mask.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libeq_next_mask.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
# the bound C entry point, set once by _bind()
_fn = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_command():
    return [_nvcc(), *NVCC_FLAGS, "-o", _LIB_PATH, _SOURCE]


def build() -> float:
    """Compile csrc/eq_next_mask.cu into _build/ unless an up-to-date
    library is there; returns the seconds the compile took (0.0 when
    none was needed)."""
    if os.path.exists(_LIB_PATH) and \
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SOURCE):
        return 0.0
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = build_command()
    tmp = _LIB_PATH + f".{os.getpid()}.tmp"
    cmd[cmd.index(_LIB_PATH)] = tmp
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0


def _bind():
    """Build and load the library once; returns its entry point."""
    global _fn
    with _lock:
        if _fn is None:
            build()
            fn = ctypes.CDLL(_LIB_PATH).paimon_eq_next_mask
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
    return _fn


def eq_next_mask_plain(lanes: torch.Tensor, invalid: torch.Tensor,
                       ovc_off: Optional[torch.Tensor] = None,
                       perm: Optional[torch.Tensor] = None,
                       num_key_lanes: Optional[int] = None,
                       seg_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version with exactly the semantics of
    paimon_tpu/ops/pallas_kernels.py `_eq_next_xla`, applied to each
    lane of `seg_len` rows (`jax.vmap` of it over a [B, N] stack)."""
    if num_key_lanes is None:
        num_key_lanes = lanes.shape[0]
    eq = (lanes[:, :-1] == lanes[:, 1:]).all(dim=0)
    if ovc_off is not None:
        consec = perm[1:] == perm[:-1] + 1
        known = ovc_off[1:] != OVC_SENTINEL_I32
        # known codes are small non-negative offsets, so the signed
        # compare equals the reference's unsigned one where it is used
        eq_code = ovc_off[1:] >= num_key_lanes
        eq = torch.where(consec & known, eq_code, eq)
    eq = eq & (invalid[:-1] == invalid[1:])
    eq = torch.cat([eq, torch.zeros(1, dtype=torch.bool, device=eq.device)])
    if seg_len is not None and seg_len < eq.shape[0]:
        eq[seg_len - 1::seg_len] = False
    return eq


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype is not torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bit patterns), "
                        f"got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def eq_next_mask(lanes: torch.Tensor, invalid: torch.Tensor,
                 ovc_off: Optional[torch.Tensor] = None,
                 perm: Optional[torch.Tensor] = None,
                 num_key_lanes: Optional[int] = None,
                 seg_len: Optional[int] = None) -> torch.Tensor:
    """bool[N]: sorted row i continues the same (validity, lanes...)
    segment at row i+1.

    lanes: int32[L, N] key lanes (uint32 bit patterns), most significant
    first; invalid: int32[N].  `ovc_off` (int32[N], sorted-order
    offset-value-code offsets, -1 where unknown) and `perm` (int32[N],
    the sort permutation) switch on the code variant.  `seg_len`: the
    rows are B lanes of seg_len rows each (N = B * seg_len), merged
    independently: no segment continues from a lane's last row, and
    `perm` counts rows within each lane.  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version.  The
    kernel launches on the current stream of the tensors' device; when
    that is not the current device, it is made current for the launch."""
    if (ovc_off is None) != (perm is None):
        raise ValueError("ovc_off and perm go together")
    n = lanes.shape[-1]
    if seg_len is not None and (seg_len < 1 or (
            seg_len < n and (n % seg_len or seg_len >= 1 << 31))):
        raise ValueError(f"seg_len {seg_len} does not divide n = {n} into "
                         f"lanes below 2^31 rows")
    if not lanes.is_cuda:
        if lanes.device.type == "cpu":
            return eq_next_mask_plain(lanes, invalid, ovc_off, perm,
                                      num_key_lanes, seg_len)
        raise ValueError(f"eq_next_mask: unsupported device {lanes.device}")
    shape = lanes.shape
    if len(shape) != 2 or shape[0] < 1:
        raise ValueError("lanes must be [L, N] with L >= 1")
    num_lanes, n = shape
    if num_key_lanes is None:
        num_key_lanes = num_lanes
    if seg_len is None:
        seg_len = n
    dev = lanes.device
    _check("lanes", lanes, shape, dev)
    _check("invalid", invalid, (n,), dev)
    if ovc_off is not None:
        _check("ovc_off", ovc_off, (n,), dev)
        _check("perm", perm, (n,), dev)
    # invalid is int32[n] on dev: the cheapest of torch's allocations here
    out = torch.empty_like(invalid, dtype=torch.bool)
    if n == 0:
        return out
    fn = _fn or _bind()
    index = dev.index
    args = (lanes.data_ptr(), num_lanes, n, invalid.data_ptr(),
            None if ovc_off is None else ovc_off.data_ptr(),
            None if perm is None else perm.data_ptr(), num_key_lanes,
            seg_len, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        rc = fn(*args)
    else:
        with torch.cuda.device(index):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"eq_next_mask kernel launch failed: CUDA "
                           f"error {rc}")
    global EQ_NEXT_LAUNCHES, EQ_NEXT_OVC_LAUNCHES
    # two merge threads launch concurrently: the count takes the lock
    with _lock:
        EQ_NEXT_LAUNCHES += 1
        if ovc_off is not None:
            EQ_NEXT_OVC_LAUNCHES += 1
    return out
