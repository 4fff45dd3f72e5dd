"""File formats (L2): ``get_format(identifier)`` returns a reader/writer
factory pair over Arrow tables (parquet data files); manifests are avro
object files through the pure-Python codec in format/avro.py.
Counterpart of paimon_tpu/format/.
"""

from paimon_tpu_torch.format.format import (  # noqa: F401
    FileFormatFactory, get_format, FormatReader, FormatWriter,
)
