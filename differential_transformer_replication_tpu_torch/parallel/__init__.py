"""Parallelism of the port: the mesh of ranks and its collectives
(``mesh.py``), the batch, tensor and FSDP layouts (``sharding.py``), the
``tensor`` axis's region collectives (``regions.py``) and its per-rank
attention seed (``shard_flash.py``), the step on a mesh (``dp_step.py``:
overlap-scheduled data parallelism, the flat step, FSDP), the two
strategies of the ``sequence`` axis (``ring.py``: ring flash attention;
``ulysses.py``: all-to-all), the GPipe stages of the ``pipeline`` axis
(``pipeline.py``), the multi-process runtime (``multihost.py``: joining
the world, the primary rank, each rank's batch, the full state on the
host) and the liveness mesh between processes (``heartbeat.py``).

``dp_step`` and ``pipeline`` import the train step, which imports the
models, which import this package: their names load at first use."""

from differential_transformer_replication_tpu_torch.parallel.mesh import (  # noqa: F401
    Line,
    Mesh,
    SequenceGroup,
    all_gather_,
    all_reduce_sum_,
    all_to_all_,
    create_mesh,
    destroy_mesh,
    destroy_sequence_group,
    init_sequence_group,
    reduce_scatter_,
)
from differential_transformer_replication_tpu_torch.parallel.sharding import (  # noqa: F401
    FsdpLayout,
    shard_batch,
)
from differential_transformer_replication_tpu_torch.parallel import multihost  # noqa: F401
from differential_transformer_replication_tpu_torch.parallel import ring  # noqa: F401
from differential_transformer_replication_tpu_torch.parallel.ring import (  # noqa: F401
    ring_diff_attention,
    ring_flash_body,
    ring_multi_stream_attention,
    ring_ndiff_attention,
    ring_vanilla_attention,
    rotate,
    use_ring,
)
from differential_transformer_replication_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_flash_body,
    ulysses_multi_stream_attention,
)

_LAZY = {"dp_step": ("make_sharded_train_step", "make_param_sync", "overlap_eligible"),
         "pipeline": ("create_pipeline_train_state", "make_pipeline_eval_many",
                      "make_pipeline_eval_step", "make_pipeline_train_step",
                      "stack_blocks", "unstack_blocks")}


def __getattr__(name: str):
    import importlib

    for module, names in _LAZY.items():
        if name in names:
            mod = importlib.import_module(
                f"differential_transformer_replication_tpu_torch.parallel.{module}")
            return getattr(mod, name)
    raise AttributeError(name)
