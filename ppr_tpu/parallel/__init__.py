from .sharded import (  # noqa: F401
    make_mesh,
    make_sharded_push_sweeps,
    make_sharded_walk_counts,
    shard_graph,
    sharded_fora_step,
)
from .node_sharded import make_node_sharded_propagate  # noqa: F401
from .scaling import scaling_sweep  # noqa: F401

# heavier engines are imported lazily by their consumers; re-exported here
# for discoverability of the full mesh surface
from .sharded_fora import ShardedForaTopk  # noqa: F401
from .node_sharded_fora import (  # noqa: F401
    NodeShardedForaTopk,
    NodeShardedForaWholeGraph,
)
from .node_sharded_allpair import (  # noqa: F401
    NodeShardedBackwardSearch,
    node_sharded_base_allpair,
)
from .mesh_algos import mesh_algo_obj  # noqa: F401
from .comm_model import four_card_prediction, predict_sweep  # noqa: F401
