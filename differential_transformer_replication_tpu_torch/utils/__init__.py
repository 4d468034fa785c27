"""Host-side utilities of the port: the fault-injection plan
(``faults.py``, stdlib only) and the profiler window and throughput
counter (``profiling.py``, on ``torch.profiler``).

:mod:`utils.faults` is imported eagerly: the fault harness must be
armable from the router and fleet processes, which never load torch.
The profiling helpers pull in torch, so they resolve lazily (PEP 562):
``from ...utils import ProfilerWindow`` works as before but pays the
torch import at first access, keeping ``from ...utils import faults``
torch-free (as the JAX package's ``utils/__init__.py`` keeps it
jax-free).
"""

from typing import TYPE_CHECKING

from differential_transformer_replication_tpu_torch.utils import faults  # noqa: F401

_LAZY = {"ProfilerWindow", "Throughput"}

__all__ = ["ProfilerWindow", "Throughput", "faults"]

if TYPE_CHECKING:
    from differential_transformer_replication_tpu_torch.utils.profiling import (
        ProfilerWindow,
        Throughput,
    )


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    from differential_transformer_replication_tpu_torch.utils import profiling

    value = getattr(profiling, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
