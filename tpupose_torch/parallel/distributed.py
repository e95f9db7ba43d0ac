"""Multi-process initialisation: one process per device, one process group.

The port's counterpart of ``tpupose/parallel/distributed.py``. The JAX
package initialises ``jax.distributed`` and lets XLA route collectives;
the port initialises a ``torch.distributed`` process group, and its
data-parallel programs (``training.loop.train(use_mesh=True)``,
``parallel.inference.multihost_process_batch``) call its collectives:
NCCL when the process drives a CUDA device, gloo on the CPU.

Arguments that are not given are read from the variables ``torchrun``
sets, PyTorch's counterparts of the reference's ``JAX_*`` variables:

  reference                   port
  JAX_COORDINATOR_ADDRESS     MASTER_ADDR:MASTER_PORT
  JAX_NUM_PROCESSES           WORLD_SIZE
  JAX_PROCESS_ID              RANK

Launch, e.g. 4 processes on one host of 4 GPUs:
``torchrun --nproc-per-node 4 -m tpupose_torch.cli train --dataset d.tpr``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Initialise the process group from the arguments or the ``torchrun``
    variables (``host:port`` of rank 0's rendezvous, the world size, this
    process's rank). Returns True if a group was initialised, False for a
    single-process run (no address given or set).

    ``backend``: None picks ``nccl`` when CUDA is available and ``gloo``
    otherwise; ``gloo`` also carries CUDA tensors (through the host), which
    lets several processes share one card. With ``nccl`` the process takes
    the card ``LOCAL_RANK`` (else its rank modulo the card count) as its
    current device. A failed initialisation raises."""
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        coordinator_address = f"{addr}:{port}" if addr and port else None
    if not coordinator_address:
        return False
    # `is None` (not falsy-or): an explicit process_id=0 must never be
    # replaced by the environment's value
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def is_primary() -> bool:
    """Whether this process writes checkpoints and logs: rank 0 of the
    process group, or True without one."""
    return not dist.is_initialized() or dist.get_rank() == 0
