"""Parquet page primitives as torch ops.

Counterpart of paimon_tpu/ops/decode.py.  The raw-page reader
(format/rawpage.py) parses page and run headers on the host and hands
the page bytes to these ops on the table's device:

  * PLAIN fixed-width values — a reinterpret of the page bytes
    (INT32/INT64/FLOAT/DOUBLE physical types);
  * RLE/bit-packed hybrid runs — definition levels and dictionary
    indices: each output position finds its run by searchsorted over
    the cumulative run counts, RLE runs broadcast their value,
    bit-packed runs unpack a little-endian bit window;
  * dictionary index gather;
  * definition-level null expansion (values scatter to present slots).

torch has no full unsigned arithmetic, so u32 and u64 bit patterns
travel in int32 and int64 tensors.  Out-of-range indices are clamped,
as the reference's gathers clamp, so a malformed stream decodes to
garbage that the reader's checks reject rather than reading past a
buffer.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["unpack_bits", "expand_rle_hybrid", "expand_rle_at",
           "plain_to_u64", "plain_to_u32", "dict_gather", "expand_nulls",
           "int64_to_key_lanes", "float64_to_key_lanes",
           "int32_to_key_lanes", "fused_decode_merge", "pad_pow2"]

_I64_MIN = -(1 << 63)


def pad_pow2(n: int, floor: int = 1024) -> int:
    """The reference's power-of-two shape bucket (ops/merge._pad_size)."""
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def unpack_bits(words: torch.Tensor, bit_width: Union[int, torch.Tensor],
                bit_offsets: torch.Tensor) -> torch.Tensor:
    """Gather `bit_width`-bit little-endian values at arbitrary bit
    offsets from a u32 word stream (the parquet bit-packed layout).

    words: int32[W] (u32 bit patterns) little-endian view of the page
    bytes; bit_offsets: integer[n] absolute bit positions; bit_width: an
    int, or an int64 tensor of one width per value (0..32).  Returns
    int32[n] (u32 bit patterns).  The two-word window is an int64: an
    arithmetic right shift of a negative window is harmless once
    masked, because bit offset plus width is at most 63."""
    if isinstance(bit_width, int) and bit_width == 0:
        return torch.zeros(bit_offsets.shape, dtype=torch.int32,
                           device=bit_offsets.device)
    offs = bit_offsets.long()
    word_idx = (offs >> 5).clamp(0, max(words.shape[0] - 2, 0))
    lo = words[word_idx].long() & 0xFFFFFFFF
    hi = words[(word_idx + 1).clamp(max=words.shape[0] - 1)].long() << 32
    if isinstance(bit_width, int):
        mask = (1 << bit_width) - 1
    else:
        mask = (torch.ones_like(bit_width) << bit_width) - 1
    return (((lo | hi) >> (offs & 31)) & mask).to(torch.int32)


def expand_rle_at(words: torch.Tensor, run_is_packed: torch.Tensor,
                  run_value: torch.Tensor, run_cum: torch.Tensor,
                  run_bit_start: torch.Tensor,
                  bit_width: Union[int, torch.Tensor],
                  pos: torch.Tensor) -> torch.Tensor:
    """Values of parsed RLE/bit-packed hybrid runs at positions `pos`
    (int64).  run_is_packed, run_value (u32 bit patterns), run_cum
    (inclusive cumulative value counts) and run_bit_start (absolute bit
    offset of a packed run's data): int64[R]; bit_width: an int or an
    int64[R] of one width per run.  Returns int32[len(pos)]."""
    run = torch.searchsorted(run_cum, pos, right=True)
    run = run.clamp(max=run_cum.shape[0] - 1)
    run_start = torch.where(run > 0, run_cum[(run - 1).clamp(min=0)], 0)
    width = bit_width if isinstance(bit_width, int) else bit_width[run]
    packed = run_is_packed[run] != 0
    # RLE runs read no bits: their offsets stay at 0, inside the stream
    bit_offs = torch.where(packed, run_bit_start[run]
                           + (pos - run_start) * width, 0)
    vals = unpack_bits(words, width, bit_offs)
    return torch.where(packed, vals, run_value[run].to(torch.int32))


def expand_rle_hybrid(words: torch.Tensor, run_is_packed: torch.Tensor,
                      run_value: torch.Tensor, run_cum: torch.Tensor,
                      run_bit_start: torch.Tensor,
                      bit_width: Union[int, torch.Tensor],
                      count: int) -> torch.Tensor:
    """Expand parsed RLE/bit-packed hybrid runs to `count` values
    (int32, u32 bit patterns); positions past the last run read the
    last run."""
    pos = torch.arange(count, dtype=torch.int64, device=words.device)
    return expand_rle_at(words, run_is_packed, run_value, run_cum,
                         run_bit_start, bit_width, pos)


def plain_to_u32(page_bytes: torch.Tensor, count: int) -> torch.Tensor:
    """PLAIN INT32/FLOAT payload (uint8, starting 4-byte aligned) ->
    int32[count] bit patterns."""
    return page_bytes[:4 * count].view(torch.int32)


def plain_to_u64(page_bytes: torch.Tensor, count: int) -> torch.Tensor:
    """PLAIN INT64/DOUBLE payload (uint8, starting 8-byte aligned) ->
    int64[count] bit patterns."""
    return page_bytes[:8 * count].view(torch.int64)


def dict_gather(dict_values: torch.Tensor,
                indices: torch.Tensor) -> torch.Tensor:
    """Dictionary decode: dictionary values gathered by the data pages'
    RLE-hybrid indices (clamped into the dictionary)."""
    idx = indices.long().clamp(0, dict_values.shape[0] - 1)
    return dict_values[idx]


def expand_nulls(values: torch.Tensor, present: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter dense (nulls-stripped) values onto their logical slots.

    present: bool[n] from the definition levels (def == max_def).
    Returns (full[n] with zeros at null slots, present)."""
    if values.shape[0] == 0:
        return torch.zeros(present.shape, dtype=values.dtype,
                           device=values.device), present
    vidx = (torch.cumsum(present, 0) - 1).clamp(0, values.shape[0] - 1)
    return torch.where(present, values[vidx], values.new_zeros(())), present


def _lanes_of(packed: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    halves = packed.contiguous().view(torch.int32).view(-1, 2)
    return packed, halves[:, 1], halves[:, 0]          # little-endian


def int64_to_key_lanes(u: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """int64 raw bits -> (packed u64, hi lane, lo lane) as int64/int32
    bit patterns: the order-preserving sign-bit flip of ops/normkey."""
    return _lanes_of(u ^ _I64_MIN)


def float64_to_key_lanes(u: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """int64 raw double bits -> IEEE-total-order packed key + lanes."""
    return _lanes_of(torch.where(u < 0, ~u, u ^ _I64_MIN))


def int32_to_key_lanes(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """int32 raw bits -> widened order-preserving u64 key + lanes
    (normkey casts every int kind to int64 first)."""
    return _lanes_of(v.long() ^ _I64_MIN)


def fused_decode_merge(key_bytes: torch.Tensor, seq_bytes: torch.Tensor,
                       invalid: torch.Tensor, keep: str = "last",
                       kind: str = "int64"):
    """Raw PLAIN page bytes of the key and sequence columns in, merge
    winners out: decode, normalized-key transform and the segmented
    winner-select (ops/kernels.eq_next_mask, the CUDA kernel on the
    card) on the bytes' device, with no host step between.

    key_bytes/seq_bytes: uint8[8n] PLAIN payloads; invalid: int32[n]
    (1 = padding row).  Returns (perm int32, winner bool, packed int64
    u64 bit patterns)."""
    from paimon_tpu_torch.ops.merge import segmented_merge_body
    n = invalid.shape[0]
    raw = plain_to_u64(key_bytes, n)
    if kind == "float64":
        packed, hi, lo = float64_to_key_lanes(raw)
    else:
        packed, hi, lo = int64_to_key_lanes(raw)
    seq = plain_to_u64(seq_bytes, n).contiguous().view(torch.int32) \
        .view(-1, 2)
    perm, winner, _ = segmented_merge_body(
        torch.stack([hi, lo]), seq[:, 1], seq[:, 0], invalid, keep,
        num_key_lanes=2)
    return perm, winner, packed
