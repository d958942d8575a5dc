from .mesh import Mesh, MeshSpec, build_mesh, shard_batch
