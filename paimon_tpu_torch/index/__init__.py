"""Table indexes: per-file column indexes and row-level DELETE.

Counterpart of paimon_tpu/index/: the roaring-bitmap wire codec
(roaring), bloom filters and the column hash the sketches build on
(bloom), the bitmap, bit-sliced and range-bitmap indexes (bitmap), their
per-file container and skip evaluator (file_index), the primary-key
DELETE (dv_maintainer), and full-text search: the BM25 analyzer, the
in-memory index and the persisted segments (fulltext).
"""

from paimon_tpu_torch.index.fulltext import (  # noqa: F401
    Analyzer, FullTextIndex, PersistedFullTextIndex, full_text_search,
)
