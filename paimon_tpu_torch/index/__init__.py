"""Table indexes: per-file column indexes and row-level DELETE.

Counterpart of paimon_tpu/index/: the roaring-bitmap wire codec
(roaring), bloom filters and the column hash the sketches build on
(bloom), the bitmap, bit-sliced and range-bitmap indexes (bitmap), their
per-file container and skip evaluator (file_index), and the primary-key
DELETE (dv_maintainer).
"""
