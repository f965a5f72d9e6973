"""The chain axis across devices: a mesh of ranks and its collectives.

Counterpart of ``automix_tpu/parallel/mesh.py`` on ``torch.distributed``.
The layout is JAX's: the chain state (``Chains``) is split along its
chain axis, one contiguous block of rows a rank; the sweep counter and
the proposal are replicated; chunk statistics are summed across the
ranks once a chunk, so every rank holds the same global statistics.
Every random stream is keyed by the global chain index (a rank's first
chain is :func:`chain0`), so a sharded run is a pure layout change.

A :class:`ChainMesh` is one process group over the ranks that share the
chain axis, with this process's rank and device: NCCL groups work on
``cuda`` tensors, gloo groups on ``cpu`` tensors.  Where JAX's
``shard_map`` inserts ``psum``s, the port calls the collectives below:
:func:`all_reduce_sum` (integer tensors summed as int64, so counts stay
exact), :func:`broadcast` from the mesh's first rank and
:func:`all_gather` along the chain axis.  A ``mesh`` of None everywhere
means one device and no collective.

JAX's ``pvary`` is not ported: it types replicated values as varying for
``shard_map``'s checker, and torch has no such checker.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from automix_tpu_torch.state import Chains, Proposal

CHAIN_AXIS = "chains"

_CHAIN_FIELDS = ("k", "theta", "logp", "pk", "pkllim", "nreinit", "key")
_PROP_FIELDS = ("lam", "mu", "B", "logdetB", "nmix", "sig")


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """One axis (``CHAIN_AXIS``) of ``size`` ranks, the global ranks 0 ...
    size - 1 (the process group ``group``, None for the default group),
    over which the chains are split; ``rank`` is this process's index on
    the axis, ``device`` the device its tensors live on."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def local(self, n: int, what: str = "n_chains") -> int:
        """The rows of ``n`` (a global count of ``what``) each rank
        holds; raises unless the ranks split it evenly."""
        if n % self.size:
            raise ValueError(f"{what}={n} does not split evenly over the "
                             f"{self.size} ranks of the mesh")
        return n // self.size


def _backend_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, device=None):
    """A mesh over the ranks of the initialized default process group, or
    over its first ``n_devices`` ranks (a new group, which every rank
    must make together; the ranks outside it get None).  ``device``
    defaults to the backend's: ``cuda`` (the current device) under NCCL,
    ``cpu`` under gloo.  A ``cuda`` mesh on a gloo group, or a ``cpu``
    one on NCCL, raises: nothing moves tensors behind the caller's back."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks of a world of {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    want = _backend_device(group)
    dev = want if device is None else torch.device(device)
    if dev.type != want.type:
        raise ValueError(f"make_mesh: a {dist.get_backend(group)} group "
                         f"moves {want.type} tensors, not {dev.type}")
    return ChainMesh(group=group, rank=dist.get_rank(group), size=n,
                     device=dev)


def chain0(mesh: Optional[ChainMesh], n_local: int) -> int:
    """The global index of this rank's first chain when every rank holds
    ``n_local`` chains (0 without a mesh)."""
    return 0 if mesh is None else mesh.rank * n_local


def all_reduce_sum(x: torch.Tensor, mesh: Optional[ChainMesh]):
    """The sum of ``x`` over the mesh's ranks, in a new tensor of ``x``'s
    dtype, the same on every rank.  Integer and bool tensors are summed
    as int64, so counts stay exact.  Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    out = x.to(x.dtype if x.dtype.is_floating_point else torch.int64,
               copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out.to(x.dtype)


def broadcast(x: torch.Tensor, mesh: Optional[ChainMesh]):
    """The mesh's first rank's ``x`` on every rank (a new tensor; each
    rank passes a tensor of the same shape and dtype).  Without a mesh,
    ``x`` itself."""
    if mesh is None:
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src=0, group=mesh.group)
    return out


def all_gather(x: torch.Tensor, mesh: Optional[ChainMesh], dim: int = 0):
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    rank order: the global array of a tensor split along ``dim``.
    Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def barrier(mesh: Optional[ChainMesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


def shard_chains(chains: Chains, mesh: ChainMesh) -> Chains:
    """This rank's block of rows of a global ``Chains`` (which every rank
    builds alike, as ``init_chains`` does from the seed), on the mesh's
    device; the sweep counter stays as it is.  Raises unless the ranks
    split the chains evenly."""
    n = mesh.local(chains.n_chains)
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    parts = {f: (None if getattr(chains, f) is None else
                 getattr(chains, f)[rows].to(mesh.device).contiguous())
             for f in _CHAIN_FIELDS}
    return Chains(**parts, sweep=chains.sweep)


def gather_chains(chains: Chains, mesh: Optional[ChainMesh]) -> Chains:
    """The global ``Chains`` from every rank's block (each rank gets it):
    the inverse of :func:`shard_chains`.  Without a mesh, ``chains``."""
    if mesh is None:
        return chains
    parts = {f: (None if getattr(chains, f) is None else
                 all_gather(getattr(chains, f), mesh))
             for f in _CHAIN_FIELDS}
    return Chains(**parts, sweep=chains.sweep)


def replicate(proposal: Proposal, mesh: ChainMesh) -> Proposal:
    """The first rank's proposal on every rank, on the mesh's device."""
    return Proposal(**{f: broadcast(getattr(proposal, f).to(mesh.device),
                                    mesh) for f in _PROP_FIELDS})
