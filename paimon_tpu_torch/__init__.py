"""paimon_tpu_torch: the PyTorch/CUDA port of paimon_tpu.

A second package beside paimon_tpu, which stays the reference it is
held against.  It reads and writes the same on-disk table format.  The
merge plane runs in PyTorch on an explicit device (None means "cuda"),
and its winner-select is a CUDA kernel written for Hopper
(ops/kernels.py, csrc/eq_next_mask.cu).  This package imports torch,
numpy and pyarrow, never jax and never paimon_tpu.
"""

__version__ = "0.1.0"

from paimon_tpu_torch.types import (  # noqa: F401
    DataType, DataField, RowType,
    TinyIntType, SmallIntType, IntType, BigIntType,
    FloatType, DoubleType, BooleanType, CharType, VarCharType,
    BinaryType, VarBinaryType, DecimalType, DateType, TimeType,
    TimestampType, LocalZonedTimestampType,
)
from paimon_tpu_torch.options import Options, ConfigOption, CoreOptions  # noqa: F401
from paimon_tpu_torch.schema.schema import Schema  # noqa: F401
