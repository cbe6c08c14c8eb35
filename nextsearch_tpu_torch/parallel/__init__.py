from .mesh import Mesh, make_mesh
from .sharded import ShardedIndex
