"""Query service: remote point lookups, scans and changelog polls.

Counterpart of paimon_tpu/service/ for one replica (the router, warm
boot and the stream daemon are ROADMAP.md A.7b).  reference:
paimon-service/ (KvQueryServer, KvQueryClient, ServiceManager).
"""

from paimon_tpu_torch.service.admission import (  # noqa: F401
    AdmissionController, AdmissionRejected,
)
from paimon_tpu_torch.service.delta import (  # noqa: F401
    DeltaTier, ServingWriter,
)
from paimon_tpu_torch.service.query_service import (  # noqa: F401
    KvQueryClient, KvQueryServer, ServiceBusyError, ServiceManager,
)
