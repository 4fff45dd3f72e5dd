"""Query service: remote point lookups, scans and changelog polls; the
streaming daemon (stream_daemon.py) in its single-host mode.

Counterpart of paimon_tpu/service/ for one replica (the router and warm
boot are ROADMAP.md A.7b).  reference:
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
