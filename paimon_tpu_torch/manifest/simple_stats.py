"""SimpleStats: per-file column min/max/null-count triple.

reference: paimon-core/.../stats/SimpleStats.java; min/max are BinaryRow
bytes over the stat'd columns (spec manifest.md appendix).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

from paimon_tpu_torch.data.binary_row import BINARY_ROW_EMPTY, BinaryRowCodec
from paimon_tpu_torch.types import DataType

__all__ = ["SimpleStats"]


@dataclass
class SimpleStats:
    """min/max kept as raw BinaryRow bytes so stats round-trip without
    knowing the schema; decode on demand with a codec."""

    min_values: bytes
    max_values: bytes
    null_counts: Optional[List[Optional[int]]]

    EMPTY: "SimpleStats" = None  # set below

    @staticmethod
    def from_values(field_types: Sequence[DataType],
                    mins: Sequence[Any], maxs: Sequence[Any],
                    null_counts: Sequence[int]) -> "SimpleStats":
        codec = BinaryRowCodec(field_types)
        return SimpleStats(codec.to_bytes(mins), codec.to_bytes(maxs),
                           list(null_counts))

    def decode(self, field_types: Sequence[DataType]) -> Tuple[tuple, tuple]:
        codec = BinaryRowCodec(field_types)
        return (codec.from_bytes(self.min_values),
                codec.from_bytes(self.max_values))

    def to_avro(self) -> dict:
        return {"_MIN_VALUES": self.min_values,
                "_MAX_VALUES": self.max_values,
                "_NULL_COUNTS": self.null_counts}

    @staticmethod
    def from_avro(d: dict) -> "SimpleStats":
        return SimpleStats(bytes(d["_MIN_VALUES"]), bytes(d["_MAX_VALUES"]),
                           d.get("_NULL_COUNTS"))


SimpleStats.EMPTY = SimpleStats(BINARY_ROW_EMPTY, BINARY_ROW_EMPTY, [])
