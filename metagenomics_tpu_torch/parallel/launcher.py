"""Multi-process runtime initialization (port of
metagenomics_tpu/parallel/launcher.py over torch.distributed).

The reference has no distributed runtime at all (copyToServers.sh:1-3 just
scp's the binary to lab hosts for separate manual runs).  Here one Python
process per card (or per CPU rank) joins one torch.distributed process
group, and the sharded overlap pipeline (parallel/sharded.py) holds one
shard per rank.

Usage (one of):
  * set MGTPU_COORDINATOR (host:port of rank 0's rendezvous),
    MGTPU_NUM_PROCESSES and MGTPU_PROCESS_ID before launching each process;
  * launch with torchrun, whose RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT (and LOCAL_RANK) are read when no MGTPU_* value is set.

The process group's backend is NCCL when the pipeline's device
(MGTPU_TORCH_DEVICE, cuda by default) is a card, gloo on the CPU.
"""

import os

import torch


def local_rank():
    """This process's card index on its host: LOCAL_RANK (torchrun), else
    the global rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    import torch.distributed as dist
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def world_size():
    """Ranks in the initialized torch.distributed world (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, log=print, device=None):
    """Join this process into a torch.distributed process group.

    Arguments default to MGTPU_COORDINATOR / MGTPU_NUM_PROCESSES /
    MGTPU_PROCESS_ID, then to torchrun's MASTER_ADDR:MASTER_PORT /
    WORLD_SIZE / RANK; with none set this is a no-op, so single-process
    runs need no configuration; a process that has joined already stays
    joined.  Returns True if a process group is initialized.
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or env.get("MGTPU_COORDINATOR")
    num_processes = num_processes or env.get("MGTPU_NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else env.get("MGTPU_PROCESS_ID")
    if coordinator is None and num_processes is None:
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                      "MASTER_PORT")):
            return False
        coordinator = "%s:%s" % (env["MASTER_ADDR"], env["MASTER_PORT"])
        num_processes, process_id = env["WORLD_SIZE"], env["RANK"]

    from ..ops.device_overlap import torch_device
    device = torch_device() if device is None else torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id))
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    log("metagenomics_tpu: joined distributed runtime as process %d/%d "
        "(%d local / %d global devices)"
        % (dist.get_rank(), dist.get_world_size(), 1,
           dist.get_world_size()))
    return True
