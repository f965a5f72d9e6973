"""Processes across devices and hosts: the process group of a run.

Counterpart of ``automix_tpu/parallel/multihost.py`` on
``torch.distributed``.  Every process runs the same program on one
device; :func:`initialize` joins them into the default process group
(NCCL on the card, gloo on the CPU) and :func:`make_global_mesh` puts the
chain axis over all of them.  Started by ``torchrun``, which sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``::

    # torchrun --nproc_per_node=4 run.py
    from automix_tpu_torch import AMSampler
    from automix_tpu_torch.parallel import multihost
    multihost.initialize()                 # once per process
    am = AMSampler(models, cfg, mesh=multihost.make_global_mesh())
    am.burn_samples(1000)
    stats = am.rjmcmc_samples(10000)       # the same on every rank
    if multihost.is_primary():
        print(stats.model_probs)

or without ``torchrun``, each process with its own ``process_id``::

    multihost.initialize("localhost:29500", num_processes=2, process_id=i)

Chains interact only through small statistics (counts and sums of size
K * D once a sweep or a chunk), so the traffic between ranks is a few
kilobytes a chunk; every rank computes the same global statistics.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from automix_tpu_torch.parallel import mesh as mesh_lib


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the run's default process group; a no-op if
    it is initialized already.  ``backend`` defaults to NCCL where CUDA is
    available and gloo otherwise; NCCL without CUDA raises.  With the
    three arguments None the group comes from the environment
    (``env://``, as ``torchrun`` sets it), else from the coordinator's
    ``host:port`` (or a ``tcp://`` URL), the process count and this
    process's index.  Under NCCL the process takes the card
    ``LOCAL_RANK`` (``torchrun``'s), else its index modulo the cards the
    host has."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize(backend='nccl'): CUDA is not "
                           "available; use backend='gloo' on the CPU")
    if coordinator_address is None:
        init_method, world, rank = "env://", None, None
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs "
                             "num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            index = rank if rank is not None else int(
                os.environ.get("RANK", "0"))
            local = index % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    kwargs = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def make_global_mesh():
    """A mesh over every rank of the default group, on the backend's
    device (``parallel.mesh.make_mesh``)."""
    return mesh_lib.make_mesh()


def is_primary() -> bool:
    """True on rank 0 (and in a process without a group)."""
    return not dist.is_initialized() or dist.get_rank() == 0
