"""paimon_tpu_torch.ops.kernels: the plain version of the winner-select
mask against the reference kernel.

The reference `eq_next_mask` runs its Pallas kernel in interpret mode on
the CPU for tile-aligned N; `_eq_next_xla` defines the semantics for
any N.  Inputs are made with numpy from a seed and handed to both.  The
mask is boolean, so equality is exact (no tolerance).  The CUDA kernel
itself runs only on the card; chip_smoke.py holds it against this same
plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paimon_tpu.ops import pallas_kernels as ref
from paimon_tpu.ops.ovc import run_ovc_offsets
from paimon_tpu_torch.ops import kernels


def _inputs(seed: int, n: int, num_lanes: int, with_ovc: bool):
    """Sorted-order inputs as a merge produces them: runs sorted and
    concatenated, then stably sorted by (invalid, lanes), with the
    padded tail invalid."""
    rng = np.random.default_rng(seed)
    real = n - int(rng.integers(1, max(2, n // 8)))
    lanes = rng.integers(0, 3, (n, num_lanes), dtype=np.uint64) \
        .astype(np.uint32)
    lanes[real:] = 0
    cuts = np.sort(rng.choice(np.arange(1, real), 3, replace=False))
    starts = np.concatenate([[0], cuts, [real]]).astype(np.int64)
    for a, b in zip(starts[:-1], starts[1:]):
        lanes[a:b] = lanes[a:b][np.lexsort(lanes[a:b].T[::-1])]
    invalid = (np.arange(n) >= real).astype(np.uint32)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:real] = run_ovc_offsets(lanes[:real], starts)
    order = np.lexsort((np.arange(n),) + tuple(lanes.T[::-1]) + (invalid,))
    s_lanes = lanes[order]
    return (s_lanes, invalid[order],
            off[order] if with_ovc else None,
            order.astype(np.int32) if with_ovc else None)


def _ref(s_lanes, invalid, off, perm, aligned: bool):
    lane_list = [jnp.asarray(s_lanes[:, i]) for i in range(s_lanes.shape[1])]
    args = (jnp.asarray(off), jnp.asarray(perm)) if off is not None \
        else (None, None)
    if aligned:
        out = ref.eq_next_mask(lane_list, jnp.asarray(invalid), *args)
    else:
        out = ref._eq_next_xla(lane_list, jnp.asarray(invalid), *args,
                               num_key_lanes=s_lanes.shape[1])
    return np.asarray(out)


def _port(s_lanes, invalid, off, perm):
    lanes_t = torch.from_numpy(np.ascontiguousarray(s_lanes.T)
                               .view(np.int32))
    inv_t = torch.from_numpy(invalid.view(np.int32))
    off_t = torch.from_numpy(off.view(np.int32)) if off is not None else None
    perm_t = torch.from_numpy(perm) if perm is not None else None
    return kernels.eq_next_mask(lanes_t, inv_t, off_t, perm_t).numpy()


@pytest.mark.parametrize("with_ovc", [False, True])
@pytest.mark.parametrize("n", [1024, 4096, 8192])
@pytest.mark.parametrize("num_lanes", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_plain_matches_reference_kernel(seed, num_lanes, n, with_ovc):
    assert n % ref.PALLAS_TILE == 0      # the reference's Pallas path
    args = _inputs(seed, n, num_lanes, with_ovc)
    want = _ref(*args, aligned=True)
    want_xla = _ref(*args, aligned=False)
    got = _port(*args)
    assert got.dtype == np.bool_ and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_xla)


@pytest.mark.parametrize("with_ovc", [False, True])
@pytest.mark.parametrize("n", [9, 1000, 2049, (1 << 12) + 37])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_plain_matches_reference_ragged(seed, n, with_ovc):
    args = _inputs(seed, n, 2, with_ovc)
    np.testing.assert_array_equal(_port(*args),
                                  _ref(*args, aligned=False))


def test_all_zero_keys_never_join_padding():
    """Real rows whose key encodes like padding (all-zero lanes) must
    not continue into the padding segment (validity is part of the
    segment identity)."""
    n = 1024
    s_lanes = np.zeros((n, 2), dtype=np.uint32)
    invalid = (np.arange(n) >= 5).astype(np.uint32)
    got = _port(s_lanes, invalid, None, None)
    want = _ref(s_lanes, invalid, None, None, aligned=True)
    np.testing.assert_array_equal(got, want)
    assert got[:4].all() and not got[4] and got[5:-1].all() and not got[-1]


def test_cuda_wrapper_rejects_wrong_inputs():
    """On any device the wrapper validates before it launches: the code
    variant needs both codes and the permutation."""
    lanes = torch.zeros((2, 8), dtype=torch.int32)
    inv = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        kernels.eq_next_mask(lanes, inv, ovc_off=inv)
