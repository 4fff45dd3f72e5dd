"""Index codecs the merge engines need, and row-level DELETE.

Counterpart of paimon_tpu/index/, reduced to the roaring-bitmap wire
codec (roaring), the column hash the sketches build on (bloom) and the
primary-key DELETE (dv_maintainer).
"""
