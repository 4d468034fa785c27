"""Parallelism of the port: the mesh of ranks and its collectives
(``mesh.py``), the batch, tensor and FSDP layouts (``sharding.py``), the
``tensor`` axis's region collectives (``regions.py``) and its per-rank
attention seed (``shard_flash.py``), the step on a mesh (``dp_step.py``:
overlap-scheduled data parallelism, the flat step, FSDP), the two
strategies of the ``sequence`` axis (``ring.py``: ring flash attention;
``ulysses.py``: all-to-all), and the liveness mesh between processes
(``heartbeat.py``). The pipeline and multihost are what is left (ROADMAP
Queue A: parallelism, item 9).

``dp_step`` imports the train step, which imports the models, which
import this package: its names load at first use."""

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

_LAZY = ("make_sharded_train_step", "make_param_sync", "overlap_eligible")


def __getattr__(name: str):
    if name in _LAZY:
        from differential_transformer_replication_tpu_torch.parallel import dp_step

        return getattr(dp_step, name)
    raise AttributeError(name)
