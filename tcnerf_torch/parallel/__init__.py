from .mesh import make_mesh, shard_nerf_batch, shard_params  # noqa: F401
