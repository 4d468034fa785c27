"""Serving stack of the PyTorch port: request types, the scheduler copy,
the continuous-batching engine (contiguous and paged pools), its runner,
client and HTTP front-end, and the fleet front over N such servers (the
router with predictive admission, and the fleet supervisor).

Exports resolve lazily (PEP 562), as the JAX package's
``serving/__init__.py`` does: the engine/server stack pulls in torch,
but the host-side members of this package — :mod:`serving.retry`,
:mod:`serving.admission`, :mod:`serving.router` and
:mod:`serving.fleet` — are pure stdlib and must stay importable from
processes that deliberately avoid the device runtime (the fleet
launcher and router front babysit the very processes whose runtime may
be crashing). ``from ...serving import ServingEngine`` pays the torch
import at first attribute access instead of at package import.
"""

from typing import TYPE_CHECKING

# attribute name -> submodule that defines it
_EXPORTS = {
    "ServingEngine": "engine",
    "EngineCrashError": "engine",
    "ConstraintCache": "constrain",
    "ConstraintCompileError": "constrain",
    "ConstraintDeadEndError": "constrain",
    "TokenFsm": "constrain",
    "HostTier": "host_tier",
    "Request": "request",
    "RequestOutput": "request",
    "SamplingParams": "request",
    "Scheduler": "scheduler",
    "PagePool": "pages",
    "PagePoolExhaustedError": "pages",
    "ModelDrafter": "spec",
    "NGramDrafter": "spec",
    "QueueFullError": "scheduler",
    "DeadlineExceededError": "scheduler",
    "ShuttingDownError": "server",
    "EngineRunner": "server",
    "ServingClient": "server",
    "serve": "server",
    "backoff_delay": "retry",
    "call_with_retries": "retry",
    "http_post_json_with_retries": "retry",
    "Router": "router",
    "Replica": "router",
    "serve_router": "router",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:  # static analyzers see the eager imports
    from differential_transformer_replication_tpu_torch.serving.constrain import (
        ConstraintCache,
        ConstraintCompileError,
        ConstraintDeadEndError,
        TokenFsm,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        EngineCrashError,
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.host_tier import (
        HostTier,
    )
    from differential_transformer_replication_tpu_torch.serving.pages import (
        PagePool,
        PagePoolExhaustedError,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        Request,
        RequestOutput,
        SamplingParams,
    )
    from differential_transformer_replication_tpu_torch.serving.retry import (
        backoff_delay,
        call_with_retries,
        http_post_json_with_retries,
    )
    from differential_transformer_replication_tpu_torch.serving.router import (
        Replica,
        Router,
        serve_router,
    )
    from differential_transformer_replication_tpu_torch.serving.scheduler import (
        DeadlineExceededError,
        QueueFullError,
        Scheduler,
    )
    from differential_transformer_replication_tpu_torch.serving.server import (
        EngineRunner,
        ServingClient,
        ShuttingDownError,
        serve,
    )
    from differential_transformer_replication_tpu_torch.serving.spec import (
        ModelDrafter,
        NGramDrafter,
    )


def __getattr__(name: str):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    module = importlib.import_module(f"{__name__}.{submodule}")
    value = getattr(module, name)
    globals()[name] = value  # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
