"""Retrieval at scale (port of ``repro/serving/retrieval``, DESIGN.md §13):
the device-sharded exact top-k and the coarse→fine two-stage path."""
from repro_torch.serving.retrieval.sharded import (  # noqa: F401
    ShardedMatrix,
    default_data_mesh,
    shard_matrix,
    shard_winner_shares,
    sharded_similarity_topk,
)
from repro_torch.serving.retrieval.twostage import (  # noqa: F401
    CentroidIndex,
    build_centroid_index,
    two_stage_topk,
)
