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


EDGE_SIZES = [1, 2, 3, 4, 5, 31, 32, 33, 127, 128, 129, 1023, 1025,
              (1 << 20) + 3, (1 << 20) + 37]


def _edge_inputs(seed: int, n: int, num_lanes: int, with_ovc: bool):
    """As `_inputs` for any n >= 1: up to four sorted runs of keys drawn
    from {0, 1, 2} per lane, so neighbours are often equal."""
    rng = np.random.default_rng(seed)
    real = n - int(rng.integers(0, n // 8 + 1))
    lanes = rng.integers(0, 3, (n, num_lanes)).astype(np.uint32)
    lanes[real:] = 0
    cuts = np.sort(rng.choice(np.arange(1, real), min(3, real - 1),
                              replace=False)) if real > 1 else []
    starts = np.concatenate([[0], cuts, [real]]).astype(np.int64)
    for a, b in zip(starts[:-1], starts[1:]):
        lanes[a:b] = lanes[a:b][np.lexsort(lanes[a:b].T[::-1])]
    invalid = (np.arange(n) >= real).astype(np.uint32)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:real] = run_ovc_offsets(lanes[:real], starts)
    order = np.lexsort((np.arange(n),) + tuple(lanes.T[::-1]) + (invalid,))
    return (lanes[order], invalid[order],
            off[order] if with_ovc else None,
            order.astype(np.int32) if with_ovc else None)


@pytest.mark.parametrize("with_ovc", [False, True])
@pytest.mark.parametrize("num_lanes", [1, 2, 5, 8])
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_plain_matches_reference_edge_sizes(n, num_lanes, with_ovc):
    """Sizes around every boundary of the rows a thread (4), a warp
    (128) and a block take in the kernel, and sizes it takes on its
    scalar path (n % 4 != 0)."""
    args = _edge_inputs(n + num_lanes, n, num_lanes, with_ovc)
    got = _port(*args)
    assert got.dtype == np.bool_ and got.shape == (n,)
    np.testing.assert_array_equal(got, _ref(*args, aligned=False))


def _clustered_runs(n: int, runs: int = 10):
    """10 sorted runs of consecutive 64-bit ids (two lanes), each run's
    range overlapping its neighbour's by 1/32 of a run, then merged:
    the codes decide every pair except at run starts and in the
    overlaps, where equal ids of two runs meet."""
    per = n // runs
    step = per - per // 32
    keys = np.concatenate(
        [np.arange(k * step, k * step + per, dtype=np.uint64)
         for k in np.random.default_rng(n).permutation(runs)]
        + [np.zeros(n - per * runs, dtype=np.uint64)])
    lanes = np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                      (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=1)
    starts = np.arange(0, per * runs + 1, per, dtype=np.int64)
    off = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    off[:per * runs] = run_ovc_offsets(lanes[:per * runs], starts)
    invalid = (np.arange(n) >= per * runs).astype(np.uint32)
    order = np.lexsort((np.arange(n), keys, invalid))
    return lanes[order], invalid[order], off[order], order.astype(np.int32)


@pytest.mark.parametrize("n", [10 * 1024, 1 << 16, (1 << 16) + 37])
def test_plain_matches_reference_clustered_runs(n):
    args = _clustered_runs(n)
    _, _, off, perm = args
    decided = (perm[1:] == perm[:-1] + 1) & (off[1:] != 0xFFFFFFFF)
    assert 0.9 < decided.mean() < 1.0
    got = _port(*args)
    np.testing.assert_array_equal(got, _ref(*args, aligned=False))
    if n % ref.PALLAS_TILE == 0:
        np.testing.assert_array_equal(got, _ref(*args, aligned=True))
    # equal ids of two runs meet in the overlaps
    assert got.any()


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


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "layout"])
def test_wrapper_checks_name_the_fault(case):
    """The checks the wrapper runs before a launch reject each input the
    kernel does not take, and name it."""
    good = torch.zeros(8, dtype=torch.int32)
    bad = {"dtype": good.to(torch.int64),
           "shape": torch.zeros(9, dtype=torch.int32),
           "device": torch.zeros(8, dtype=torch.int32, device="meta"),
           "layout": torch.zeros((8, 2), dtype=torch.int32)[:, 0]}[case]
    kernels._check("invalid", good, (8,), good.device)
    with pytest.raises(TypeError if case == "dtype" else ValueError,
                       match="invalid"):
        kernels._check("invalid", bad, (8,), good.device)


@pytest.mark.parametrize("with_ovc", [False, True])
@pytest.mark.parametrize("num_lanes", [1, 2, 5])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_lane_stride_matches_reference_per_lane(b, num_lanes, with_ovc):
    """seg_len: B merges laid end to end equal the reference kernel run
    on each (jax.vmap of it over the mesh's [B, N] stack)."""
    n = 1024
    parts = [_inputs(40 + k, n, num_lanes, with_ovc) for k in range(b)]
    whole = [np.concatenate([p[i] for p in parts])
             if parts[0][i] is not None else None for i in range(4)]
    got = _port_strided(*whole, seg_len=n)
    want = np.concatenate([_ref(*p, aligned=True) for p in parts])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_ovc", [False, True])
def test_lane_stride_cuts_equal_keys_across_lanes(with_ovc):
    """Full lanes of one key, perms running on across each lane boundary
    and codes claiming equality there: only the stride cuts the pair."""
    b, n, num_lanes = 4, 1024, 2
    s_lanes = np.zeros((b * n, num_lanes), dtype=np.uint32)
    invalid = np.zeros(b * n, dtype=np.uint32)
    off = np.full(b * n, num_lanes, dtype=np.uint32) if with_ovc else None
    perm = np.arange(b * n, dtype=np.int32) if with_ovc else None
    got = _port_strided(s_lanes, invalid, off, perm, seg_len=n)
    want = np.concatenate([_ref(s_lanes[k * n:(k + 1) * n],
                                invalid[k * n:(k + 1) * n],
                                None if off is None else off[:n],
                                None if perm is None else perm[:n],
                                aligned=True) for k in range(b)])
    np.testing.assert_array_equal(got, want)
    assert (~got).sum() == b and not got[n - 1::n].any()


@pytest.mark.parametrize("seg_len", [0, 3, 5000])
def test_lane_stride_must_divide_rows(seg_len):
    lanes = torch.zeros((2, 4096), dtype=torch.int32)
    inv = torch.zeros(4096, dtype=torch.int32)
    if seg_len == 5000:                  # one lane longer than n: fine
        assert kernels.eq_next_mask(lanes, inv, seg_len=seg_len)[:-1].all()
        return
    with pytest.raises(ValueError, match="seg_len"):
        kernels.eq_next_mask(lanes, inv, seg_len=seg_len)


def _port_strided(s_lanes, invalid, off, perm, seg_len):
    lanes_t = torch.from_numpy(np.ascontiguousarray(s_lanes.T)
                               .view(np.int32))
    return kernels.eq_next_mask(
        lanes_t, torch.from_numpy(invalid.view(np.int32)),
        None if off is None else torch.from_numpy(off.view(np.int32)),
        None if perm is None else torch.from_numpy(perm),
        seg_len=seg_len).numpy()
