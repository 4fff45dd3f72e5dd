"""Row abstractions.

The reference's ``InternalRow`` (paimon-common/.../data/InternalRow.java:91)
is a positional accessor interface; here rows at API edges are thin tuples
with a row kind. Bulk data never goes through rows -- it flows as Arrow
RecordBatches (host) and jax struct-of-arrays (device).
"""

from __future__ import annotations

from typing import Any, List, Sequence

from paimon_tpu_torch.types import RowKind

__all__ = ["InternalRow", "GenericRow"]


class InternalRow:
    """Positional row view."""

    def get_field(self, pos: int) -> Any:
        raise NotImplementedError

    def get_row_kind(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class GenericRow(InternalRow):
    __slots__ = ("values", "row_kind")

    def __init__(self, *values, row_kind: int = RowKind.INSERT):
        if len(values) == 1 and isinstance(values[0], (list, tuple)):
            values = tuple(values[0])
        self.values: tuple = tuple(values)
        self.row_kind = row_kind

    @staticmethod
    def of(*values) -> "GenericRow":
        return GenericRow(*values)

    @staticmethod
    def of_kind(kind: int, *values) -> "GenericRow":
        return GenericRow(*values, row_kind=kind)

    def get_field(self, pos: int) -> Any:
        return self.values[pos]

    def get_row_kind(self) -> int:
        return self.row_kind

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __getitem__(self, i):
        return self.values[i]

    def __eq__(self, other):
        return (isinstance(other, GenericRow)
                and self.values == other.values
                and self.row_kind == other.row_kind)

    def __hash__(self):
        return hash((self.values, self.row_kind))

    def __repr__(self):
        return (f"{RowKind.short_string(self.row_kind)}"
                f"{list(self.values)}")
