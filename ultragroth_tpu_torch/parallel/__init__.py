"""Multi-device execution of the port: mesh-sharded MSM and NTT, the twin
of the JAX package's `parallel/` (`shard_map` over a `jax.sharding.Mesh`).

Here a mesh is a grid of `torch.device`s (`mesh.py`); each shard's work is
the port's own single-device code and kernels on that device, and the
exchanges between shards are device copies within a process and
`torch.distributed` collectives across processes.
"""
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
