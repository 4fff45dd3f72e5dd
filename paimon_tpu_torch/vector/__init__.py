"""Vector search: ANN indexes on the table's device.

Counterpart of paimon_tpu/vector/ (reference: paimon-vector's native
index, NativeVectorIndexLoader.java:28 loading IVF-Flat/IVF-PQ/IVF-HNSW
factories via JNI, and table/VectorSearchTable + VectorSearchSplit).
Brute-force search and IVF training are batched matmul + top-k or
argmin on the card; IVF queries and HNSW stay on the host, as in the
reference.
"""

from paimon_tpu_torch.vector.ann import (  # noqa: F401
    BruteForceIndex, IVFFlatIndex, vector_search,
)
from paimon_tpu_torch.vector.hybrid import (  # noqa: F401
    hybrid_search, rank_hybrid,
)
