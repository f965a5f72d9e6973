"""Model registry of the port.

Counterpart of ``automix_tpu/model.py`` plus ``make_logpost_cols``
(``automix_tpu/kernels/fused.py``).  A model is a column density
``logp_cols(rows) -> lp`` on torch tensors (``rows[i]`` holds coordinate i
of every chain) and, for the CUDA kernels, a :class:`CudaDensity`
descriptor: the id of a density the kernels implement plus its float
constants.  A model set whose models lack descriptors runs on the CPU
only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from automix_tpu_torch.config import NEG_INF

# Constant slots of a CudaDensity (csrc/common.cuh AM_N_CONSTS).  Twenty
# slots hold the largest density of the ported problems, toy1's 2-D
# three-component mixture: its length, then 6 floats per component.
N_DENSITY_CONSTS = 20


@dataclasses.dataclass(frozen=True)
class CudaDensity:
    """A density the CUDA kernels evaluate: ``kind`` selects the formula in
    ``csrc/common.cuh`` and ``consts`` are its float32 constants."""

    kind: int
    consts: tuple

    def __post_init__(self):
        if len(self.consts) > N_DENSITY_CONSTS:
            raise ValueError(f"at most {N_DENSITY_CONSTS} density constants")


@dataclasses.dataclass(frozen=True)
class Model:
    """One model: ``dim`` parameters, a column log-posterior, the stage-1
    start point (uniform [0, 1) draws where None), an optional CUDA
    descriptor of the same density, and an optional column form of the
    likelihood alone (``loglik``, the second column of ``_lp.data``)."""

    name: str
    dim: int
    logp_cols: Callable
    init: Optional[np.ndarray] = None
    cuda: Optional[CudaDensity] = None
    loglik: Optional[Callable] = None


def sanitize(lp):
    """Clamp a log-density to [NEG_INF, -NEG_INF] and send NaN to NEG_INF,
    so arithmetic blends never see 0 * inf."""
    lp = torch.clamp(lp, min=NEG_INF, max=-NEG_INF)
    return torch.where(lp == lp, lp, torch.full_like(lp, NEG_INF))


class ModelSet:
    """A fixed collection of models padded to a common ``dmax``."""

    def __init__(self, models: Sequence[Model]):
        if not models:
            raise ValueError("need at least one model")
        self.models = tuple(models)
        self.nmodels = len(self.models)
        self.dims = np.array([m.dim for m in self.models], dtype=np.int32)
        self.dmax = int(self.dims.max())
        self._density_tables = {}

    def logpost_cols(self, k, rows):
        """Sanitized log-posterior of each chain under its own model:
        ``k`` [S] model indices, ``rows`` dmax tensors [S]."""
        out = None
        for m, model in enumerate(self.models):
            lp = sanitize(model.logp_cols(rows[:model.dim]))
            out = lp if out is None else torch.where(k == m, lp, out)
        return out

    def density_table(self, device):
        """(kinds int32 [K], consts float32 [K, N_DENSITY_CONSTS], dims
        int32 [K]) for the CUDA kernels, made once per device."""
        device = torch.device(device)
        if device in self._density_tables:
            return self._density_tables[device]
        missing = [m.name for m in self.models if m.cuda is None]
        if missing:
            raise ValueError(f"models {missing} have no CUDA density "
                             "descriptor; this model set runs on the CPU only")
        consts = np.zeros((self.nmodels, N_DENSITY_CONSTS), np.float32)
        for i, m in enumerate(self.models):
            consts[i, :len(m.cuda.consts)] = m.cuda.consts
        kinds = torch.tensor([m.cuda.kind for m in self.models],
                             dtype=torch.int32, device=device)
        table = (kinds, torch.from_numpy(consts).to(device),
                 torch.from_numpy(self.dims).to(device))
        self._density_tables[device] = table
        return table

    def init_points(self, generator: torch.Generator) -> torch.Tensor:
        """[K, dmax] float32 stage-1 start points (padded with 0); a model
        without ``init`` gets uniform [0, 1) draws from ``generator``."""
        out = torch.zeros((self.nmodels, self.dmax), dtype=torch.float32)
        for i, m in enumerate(self.models):
            if m.init is not None:
                arr = np.asarray(m.init, dtype=np.float64).reshape(-1)
                if arr.shape[0] != m.dim:
                    raise ValueError(f"model {m.name}: init has length "
                                     f"{arr.shape[0]}, expected {m.dim}")
                out[i, :m.dim] = torch.from_numpy(arr).to(torch.float32)
            else:
                out[i, :m.dim] = torch.rand(m.dim, generator=generator)
        return out
