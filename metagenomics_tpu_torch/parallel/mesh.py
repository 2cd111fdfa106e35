"""Device meshes of the sharded engine (port of
metagenomics_tpu/parallel/mesh.py)."""

import torch

from .collectives import Distributed, InProcess


class Mesh:
    """A (dp, ix) grid of shards: shard (d, i) lives on devices[d * ix + i]
    (rank d * ix + i under torch.distributed).  `comm` is the backend that
    moves data between shards (parallel/collectives.py) and `local` lists
    the shards this process holds, in (d, i) order."""

    def __init__(self, dp, ix, devices, comm):
        self.shape = {"dp": dp, "ix": ix}
        self.devices = devices
        self.comm = comm
        self.local = comm.local

    def device(self, key):
        return self.devices[key[0] * self.shape["ix"] + key[1]]


def _distributed():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def default_devices(device=None):
    """One shard per rank of an initialized torch.distributed world, on
    this rank's card (cuda:LOCAL_RANK) under NCCL, else on the CPU;
    otherwise one per visible card for a cuda device, or the one device
    given (MGTPU_TORCH_DEVICE by default)."""
    if _distributed():
        import torch.distributed as dist
        from .launcher import local_rank
        mine = (torch.device("cuda", local_rank())
                if dist.get_backend() == "nccl" else torch.device("cpu"))
        return [mine] * dist.get_world_size()
    from ..ops.device_overlap import torch_device
    device = torch_device() if device is None else torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [device]


def make_mesh(dp=None, ix=1, devices=None):
    """Build a (dp, ix) mesh over `devices` (default_devices() if None).

    dp * ix must equal the device count; dp defaults to len(devices)//ix.
    A device may repeat: [torch.device("cuda:0")] * 8 holds eight shards
    on one card.  Under an initialized torch.distributed world the mesh
    has one shard per rank (the count must equal the world size) and this
    process holds its own; otherwise it holds every shard.
    """
    if devices is None:
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // ix
    if dp * ix != n:
        raise ValueError("dp*ix (%d*%d) != device count %d" % (dp, ix, n))
    if _distributed():
        import torch.distributed as dist
        if n != dist.get_world_size():
            raise ValueError("a mesh over torch.distributed needs one shard "
                             "per rank: %d shards, world size %d"
                             % (n, dist.get_world_size()))
        comm = Distributed(dp, ix, devices[dist.get_rank()])
    else:
        comm = InProcess(dp, ix, devices)
    return Mesh(dp, ix, devices, comm)
