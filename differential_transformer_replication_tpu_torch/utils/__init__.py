"""Host-side utilities of the port: the fault-injection plan
(``faults.py``, stdlib only) and the profiler window and throughput
counter (``profiling.py``, on ``torch.profiler``)."""

from differential_transformer_replication_tpu_torch.utils import faults  # noqa: F401
from differential_transformer_replication_tpu_torch.utils.profiling import (  # noqa: F401
    ProfilerWindow,
    Throughput,
)
