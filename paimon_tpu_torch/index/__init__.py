"""Index codecs the merge engines need.

Counterpart of paimon_tpu/index/, reduced to the roaring-bitmap wire
codec (roaring) and the column hash the sketches build on (bloom).
"""
