"""Parallelism of the port: the sequence-parallel ring (``mesh.py``: the
process group; ``ring.py``: ring flash attention) and the liveness mesh
between processes (``heartbeat.py``). Data, FSDP, tensor and
pipeline parallelism and Ulysses are later slices (ROADMAP Queue A)."""

from differential_transformer_replication_tpu_torch.parallel.mesh import (  # noqa: F401
    SequenceGroup,
    all_reduce_sum_,
    destroy_sequence_group,
    init_sequence_group,
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
