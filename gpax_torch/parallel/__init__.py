from .distributed_chol import (
    make_sharded_mvn_log_prob,
    sharded_chol_inv,
    sharded_linalg,
)
from .mesh import Mesh, get_mesh, init_distributed, shard_leading_axis
from .sharded import sharded_acquisition, sharded_predict

__all__ = ["get_mesh", "init_distributed", "shard_leading_axis",
           "sharded_predict", "sharded_acquisition", "sharded_chol_inv",
           "sharded_linalg", "make_sharded_mvn_log_prob", "Mesh"]
