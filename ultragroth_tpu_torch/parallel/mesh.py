"""Device meshes and the multi-process bootstrap: the twin of the JAX
package's `parallel/mesh.py`.

A `Mesh` is a grid of `torch.device`s with named axes.  A 1-D mesh
(`make_mesh`, axis `data`) is one process's devices.  A 2-D mesh
(`make_host_chip_mesh`, axes `host` and `chip`) has one row a process and
one column a local device; its rows are processes when the mesh carries a
`torch.distributed` process group, and all local ("virtual hosts" of one
process) when it does not.  The sharded entry points (`parallel/msm.py`,
`parallel/ntt.py`) take `axis` as one name or a tuple of names and shard
over the product of those axes:

  * across local devices a collective is a device-to-device copy;
  * across processes it is `all_gather` / `all_to_all_single` on the
    mesh's group (NCCL for CUDA devices, gloo on the CPU).

Each shard's work runs under `on_device(shard device)`, so every kernel
launches on that device's current stream.

On the CPU platform one process may hold a mesh of the one `cpu` device
repeated (`make_mesh` counts one `cpu` entry a core): the counterpart of
the JAX tests' forced host device count.  A `Mesh` built by hand may repeat
a CUDA device too; `make_mesh` hands out distinct GPUs only.

Multi-process launch (one command a process; one GPU a process, e.g. by
CUDA_VISIBLE_DEVICES, since NCCL refuses two ranks on one GPU):

    ULTRAGROTH_COORDINATOR=host0:9876 ULTRAGROTH_NUM_PROCESSES=2 \\
    ULTRAGROTH_PROCESS_ID=<i> python -m ultragroth_tpu_torch.cli prove ...

`distributed_init()` is a no-op without those variables.
"""
from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import torch

DATA_AXES = ("host", "chip")


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D or 2-D grid of torch devices with named axes.

    devices: a sequence of devices (1-D) or of equal-length sequences (2-D,
    rows first).  group: for a 2-D mesh, the `torch.distributed` process
    group whose ranks are its rows (this process holds row `rank`); None
    means every row is local to this process."""

    def __init__(self, devices, axis_names=("data",), group=None):
        devices = list(devices)
        two_d = bool(devices) and isinstance(devices[0], (list, tuple))
        rows = [list(r) for r in devices] if two_d else [devices]
        axis_names = ((axis_names,) if isinstance(axis_names, str)
                      else tuple(axis_names))
        if len(axis_names) != (2 if two_d else 1):
            raise ValueError(f"a {'2' if two_d else '1'}-D mesh needs as "
                             f"many axis names, got {axis_names}")
        if not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("mesh rows must be non-empty and of one length")
        if group is not None:
            import torch.distributed as dist
            if not two_d or dist.get_world_size(group) != len(rows):
                raise ValueError("a process group needs a 2-D mesh with one "
                                 "row a rank")
        self.grid = tuple(tuple(_as_device(d) for d in r) for r in rows)
        self.axis_names = axis_names
        self.group = group
        sizes = (len(rows), len(rows[0])) if two_d else (len(rows[0]),)
        self.shape = dict(zip(axis_names, sizes))

    @property
    def devices(self) -> tuple:
        return self.grid if len(self.axis_names) == 2 else self.grid[0]

    def __repr__(self):
        return f"Mesh({self.shape}, group={self.group is not None})"


@dataclass(frozen=True)
class Shards:
    """This process's part of a sharding over `axis` of a mesh: its shards'
    devices, the global index of the first, the number of shards in all,
    and the process group across which they spread (None: all local)."""
    devices: tuple
    first: int
    count: int
    group: object


def shards(mesh: Mesh, axis) -> Shards:
    """The shards of `mesh` over `axis` (a name or a tuple of names), in
    the flattened order of the JAX package's tuple axes (host-major).  An
    axis left out is replicated: the port computes it once, on the first
    device of that axis."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = [a for a in axes if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"axes {unknown} not in mesh {mesh.axis_names}")
    if len(mesh.axis_names) == 1:
        return Shards(mesh.grid[0], 0, len(mesh.grid[0]), None)
    host, chip = mesh.axis_names
    cols = len(mesh.grid[0]) if chip in axes else 1
    if mesh.group is not None:
        import torch.distributed as dist
        rank = dist.get_rank(mesh.group)
        local = mesh.grid[rank][:cols]
        if host in axes:
            return Shards(local, rank * cols, len(mesh.grid) * cols,
                          mesh.group)
        return Shards(local, 0, cols, None)
    rows = mesh.grid if host in axes else mesh.grid[:1]
    local = tuple(d for r in rows for d in r[:cols])
    return Shards(local, 0, len(local), None)


def on_device(dev: torch.device):
    """Run the work inside on `dev`: for a CUDA device, make it current, so
    each kernel launches on its own device's stream."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def axis_size(mesh: Mesh, axis) -> int:
    """Total device count under `axis` (a name or tuple of names)."""
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def visible_devices(device=None) -> list:
    """The devices a mesh may take on the platform of `device` (default
    `runtime.default_device()`): every CUDA device, or on the CPU one
    `cpu` entry a core."""
    if device is None:
        from ..runtime import default_device
        device = default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def make_mesh(n_devices: int | str | None = None, axis: str = "data",
              device=None) -> Mesh:
    """1-D device mesh over the first `n_devices` visible devices of the
    platform of `device` (`visible_devices`).

    n_devices None/0/"all" -> every visible device, rounded DOWN to a power
    of two (the sharded MSM/NTT paths shard power-of-two extents)."""
    devs = visible_devices(device)
    if n_devices in (None, 0, "all"):
        n = 1 << (len(devs).bit_length() - 1)
    else:
        n = int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    if n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")
    return Mesh(devs[:n], (axis,))


def distributed_init() -> bool:
    """`torch.distributed.init_process_group` from ULTRAGROTH_COORDINATOR
    (host:port) / ULTRAGROTH_NUM_PROCESSES / ULTRAGROTH_PROCESS_ID, with
    NCCL when the platform is cuda and gloo on the CPU.  Returns True when
    a process group exists (formed here or before); False (no-op) when the
    variables are absent."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    coord = os.environ.get("ULTRAGROTH_COORDINATOR")
    if not coord:
        return False
    from ..runtime import platform
    backend = "nccl" if platform() == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ["ULTRAGROTH_NUM_PROCESSES"]),
        rank=int(os.environ["ULTRAGROTH_PROCESS_ID"]))
    return True


def make_host_chip_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A ('host', 'chip') mesh over every process of the process group.

    Single-process (no group): one 'host' row over the first n_devices
    visible devices.  With a group (after `distributed_init`, even of one
    rank): one row a rank, each row this process's first n_devices
    visible devices (the same count in every process), and the 'host'
    axis exchanges through the group."""
    import torch.distributed as dist
    devs = visible_devices(device)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not dist.is_initialized():
        return Mesh([devs], DATA_AXES)
    world = dist.get_world_size()
    return Mesh([devs] * world, DATA_AXES, group=dist.group.WORLD)


# -- exchanges between shards ----------------------------------------------

def to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A tensor on `dev`; limb tensors change to `dev`'s limb dtype
    (`ops.limbs.limb_dtype`: int32 on CUDA, int64 on the CPU)."""
    from ..ops.limbs import limb_dtype, narrow, widen
    if x.dtype in (torch.int32, torch.int64):
        want = limb_dtype(dev)
        if x.dtype != want:
            x = narrow(widen(x), want)
    return x.to(dev)


def _all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def gather(sh: Shards, parts: list, dev: torch.device) -> torch.Tensor:
    """Every shard's part (one tensor of one shape a local shard) stacked
    in global shard order, [sh.count, *shape], on `dev`."""
    comm = sh.devices[0]
    with on_device(comm):
        local = torch.stack([to_device(p, comm) for p in parts])
        if sh.group is not None:
            ranks = sh.count // len(parts)
            out = torch.empty(ranks * local.numel(), dtype=local.dtype,
                              device=comm)
            _all_gather_flat(out, local.reshape(-1), sh.group)
            local = out.reshape(sh.count, *parts[0].shape)
    return to_device(local, dev)


def all_to_all(sh: Shards, sends: list) -> list:
    """The tiled all-to-all of the 4-step NTT's transpose.  sends: one
    tensor a local shard, [sh.count, *piece], entry g' for shard g'.
    Returns one tensor a local shard, [sh.count, *piece], entry g from
    shard g, on the shard's device."""
    if sh.group is None:
        return [torch.stack([to_device(s[j], dev) for s in sends])
                for j, dev in enumerate(sh.devices)]
    import torch.distributed as dist
    comm, cl = sh.devices[0], len(sh.devices)
    piece = tuple(sends[0].shape[1:])
    with on_device(comm):
        send = torch.stack([to_device(s, comm) for s in sends])
        # [src local, dest rank, dest local] -> [dest rank, src local,
        # dest local]: each rank's block contiguous for the equal split
        send = send.reshape(cl, sh.count // cl, cl, *piece).transpose(
            0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.reshape(-1), send.reshape(-1),
                               group=sh.group)
    # [src rank, src local, dest local]: dest j's sources in global order
    return [to_device(recv[:, :, j].reshape(sh.count, *piece), dev)
            for j, dev in enumerate(sh.devices)]
