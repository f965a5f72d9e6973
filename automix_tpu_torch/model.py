"""Model registry of the port.

Counterpart of ``automix_tpu/model.py`` plus ``make_logpost_cols``
(``automix_tpu/kernels/fused.py``).  A model is a log-density in one or
two forms: a column density ``logp_cols(rows) -> lp`` on torch tensors
(``rows[i]`` holds coordinate i of every chain), and/or JAX's per-theta
``logp(theta [dim]) -> scalar``.  For the CUDA kernels it may also carry
a :class:`CudaDensity` descriptor: the id of a density the kernels
implement plus its float constants.  A model set whose models all have
descriptors at a compiled (K, D) can run on the kernels; every set runs
on the general engine (``kernels/rjmcmc.py``, ``kernels/rwm.py``), which
evaluates :meth:`ModelSet.logpost_batch`.

A model set may also carry an incremental density (``fused_density``,
the JAX ``FusedColsDensity``): per-chain cached statistics that the sweep
updates coordinate by coordinate.  :func:`make_density` gives the sweep
its density object, the stateless adapter for every other family.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from automix_tpu_torch.config import NEG_INF
from automix_tpu_torch.ops import randoms

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
    """One model: ``dim`` parameters, a column log-posterior and/or a
    per-theta one (``logp``, by keyword), the stage-1 start point (uniform
    [0, 1) draws where None), an optional CUDA descriptor of the same
    density, and an optional column form of the likelihood alone
    (``loglik``, the second column of ``_lp.data``).

    ``logp(theta) -> scalar`` takes a [dim] float32 tensor; the general
    engine maps it over chains with ``torch.func.vmap``, so it must use
    torch operations only and no Python control flow on tensor values
    (``torch.where`` in place of ``if``), as ``jax.vmap`` asks of JAX's
    ``logp``.  Any model prior weight is folded into the density."""

    name: str
    dim: int
    logp_cols: Optional[Callable] = None
    init: Optional[np.ndarray] = None
    cuda: Optional[CudaDensity] = None
    loglik: Optional[Callable] = None
    logp: Optional[Callable] = None

    def __post_init__(self):
        if self.logp_cols is None and self.logp is None:
            raise ValueError(f"model {self.name}: needs logp or logp_cols")

    def cols(self, rows):
        """The column density at ``rows`` (dim tensors [S]): ``logp_cols``
        where the model has one, else ``logp`` mapped over the chains."""
        if self.logp_cols is not None:
            return self.logp_cols(rows)
        return torch.func.vmap(self.logp)(torch.stack(list(rows), dim=1))


def memoized_set(factory):
    """Memoize a ModelSet factory on its keyword arguments (JAX's
    ``memoized_set``): the same problem gives the same ModelSet object, so
    the caches keyed on it (density tables, kernel tables) are reused.
    Calls with positional or unhashable arguments are not memoized."""
    cache = {}

    @functools.wraps(factory)
    def wrapped(*args, **kw):
        if args:
            return factory(*args, **kw)
        key = tuple(sorted(kw.items(), key=lambda t: t[0]))
        try:
            hash(key)
        except TypeError:
            return factory(**kw)
        if key not in cache:
            cache[key] = factory(**kw)
        return cache[key]

    return wrapped


def sanitize(lp):
    """Clamp a log-density to [NEG_INF, -NEG_INF] and send NaN to NEG_INF,
    so arithmetic blends never see 0 * inf."""
    lp = torch.clamp(lp, min=NEG_INF, max=-NEG_INF)
    return torch.where(lp == lp, lp, torch.full_like(lp, NEG_INF))


class ModelSet:
    """A fixed collection of models padded to a common ``dmax``.

    ``batched_logpost_cols(k, rows)``, where given, evaluates the whole
    family in one column form (``ModelSet(batched_logpost_cols=...)`` of
    the JAX package, which passes one-hot masks where this takes ``k``).
    ``fused_density``, where given, is the family's incremental density
    (see :func:`make_density`)."""

    def __init__(self, models: Sequence[Model],
                 batched_logpost_cols: Optional[Callable] = None,
                 fused_density=None):
        if not models:
            raise ValueError("need at least one model")
        self.batched_logpost_cols = batched_logpost_cols
        self.fused_density = fused_density
        self.models = tuple(models)
        self.nmodels = len(self.models)
        self.dims = np.array([m.dim for m in self.models], dtype=np.int32)
        self.dmax = int(self.dims.max())
        self._density_tables = {}

    @classmethod
    def from_callback(cls, nmodels: int, model_dims: Sequence[int], logpost,
                      init=None, name: str = "model"):
        """Build from a C-style single callback ``logpost(k, theta)``, with
        ``theta`` the [dim] slice of model k (JAX's ``from_callback``):
        each model's per-theta ``logp`` calls it with its static k.
        ``init`` is the flat concatenated start vector of all models."""
        inits = [None] * nmodels
        if init is not None:
            flat = np.asarray(init, dtype=np.float64)
            off = 0
            inits = []
            for d in model_dims:
                inits.append(flat[off:off + d].copy())
                off += d
        return cls([Model(name=f"{name}{k}", dim=int(model_dims[k]),
                          logp=functools.partial(logpost, k),
                          init=inits[k]) for k in range(nmodels)])

    def logpost_cols(self, k, rows):
        """Log-posterior of each chain under its own model, clamped by
        :func:`sanitize` (the kernels' twins): ``k`` [S] model indices,
        ``rows`` dmax tensors [S]."""
        if self.batched_logpost_cols is not None:
            return sanitize(self.batched_logpost_cols(k, rows))
        out = None
        for m, model in enumerate(self.models):
            lp = sanitize(model.cols(rows[:model.dim]))
            out = lp if out is None else torch.where(k == m, lp, out)
        return out

    def logpost_batch(self, k, theta, models=None):
        """Log-posterior of the general engine (JAX's ``logpost_batch``):
        ``k`` [S], ``theta`` [S, dmax] -> [S].  Every model is evaluated
        on every chain (its column form, or its ``logp`` under vmap on
        ``theta[:, :dim]``) and the chain's own model selected; every
        non-finite value becomes NEG_INF and finite values stay as they
        are (the kernels' :func:`sanitize` also clamps +inf).  ``models``,
        where given, lists the only models to evaluate, and the values of
        the other models' chains are meaningless: a componentwise move on
        coordinate j needs no model of dim <= j, whose chains it masks
        out."""
        rows = theta.unbind(1)
        if self.batched_logpost_cols is not None:
            lp = self.batched_logpost_cols(k, rows)
        else:
            lp = None
            for m in (range(self.nmodels) if models is None else models):
                lm = self.models[m].cols(rows[:self.models[m].dim])
                lp = lm if lp is None else torch.where(k == m, lm, lp)
        lp = lp.to(torch.float32)
        return torch.where(torch.isfinite(lp), lp,
                           torch.full_like(lp, NEG_INF))

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

    def logpost_and_grad(self, k, theta):
        """(logpost_batch(k, theta) [S], its gradient [S, dmax] with
        respect to each chain's own theta): ``jax.grad`` of JAX's
        ``logpost_padded`` under vmap, the HMC move's gradient.  A family
        form is differentiated through the sum over chains, exact since
        each chain's value depends on its own row alone; otherwise every
        model is differentiated on its own copy of theta and each chain
        takes its own model's gradient, so a model's non-finite gradient
        on another model's chains never reaches them (JAX's select over
        the switch's branches).  A value sent to NEG_INF by the sanitizing
        ``where`` passes no gradient, as there."""
        f32 = torch.float32

        def clean(lp):
            lp = lp.to(f32)
            return torch.where(torch.isfinite(lp), lp,
                               torch.full_like(lp, NEG_INF))

        with torch.enable_grad():
            if self.batched_logpost_cols is not None:
                th = theta.detach().requires_grad_(True)
                lp = clean(self.batched_logpost_cols(k, th.unbind(1)))
                g, = torch.autograd.grad(lp.sum(), th, allow_unused=True)
                g = torch.zeros_like(th) if g is None else g
                return lp.detach(), g
            leaves, values = [], []
            for model in self.models:
                th = theta.detach().requires_grad_(True)
                leaves.append(th)
                values.append(clean(model.cols(th.unbind(1)[:model.dim])))
            grads = torch.autograd.grad(sum(v.sum() for v in values),
                                        leaves, allow_unused=True)
        lp = g = None
        for m, (v, gm) in enumerate(zip(values, grads)):
            gm = torch.zeros_like(theta) if gm is None else gm
            v = v.detach()
            if lp is None:
                lp, g = v, gm
            else:
                sel = k == m
                lp = torch.where(sel, v, lp)
                g = torch.where(sel[:, None], gm, g)
        return lp, g

    def init_points(self, key) -> torch.Tensor:
        """[K, dmax] float32 stage-1 start points (padded with 0).  A model
        without ``init`` starts at uniform [0, 1) draws from the threefry
        key ``key`` folded with the model's index, as JAX's
        ``init_points``."""
        out = torch.zeros((self.nmodels, self.dmax), dtype=torch.float32)
        for i, m in enumerate(self.models):
            if m.init is not None:
                arr = np.asarray(m.init, dtype=np.float64).reshape(-1)
                if arr.shape[0] != m.dim:
                    raise ValueError(f"model {m.name}: init has length "
                                     f"{arr.shape[0]}, expected {m.dim}")
                out[i, :m.dim] = torch.from_numpy(arr).to(torch.float32)
            else:
                out[i, :m.dim] = randoms.uniform(
                    randoms.fold_in(key, i), (m.dim,)).cpu()
        return out


class StatelessDensity:
    """The sweep's density for a family without a cache: every evaluation
    is a fresh ``ModelSet.logpost_cols`` (the JAX ``_StatelessDensity``),
    so the sweep computes exactly what it did before densities had a
    protocol."""

    n_cache = 0

    def __init__(self, modelset: ModelSet):
        self._ms = modelset

    def full(self, k, rows):
        return self._ms.logpost_cols(k, rows), ()

    def coord(self, j, k, rows, old_j, cache):
        return self._ms.logpost_cols(k, rows), ()


def make_density(modelset: ModelSet):
    """The sweep's density object (the JAX ``make_density``): the model
    set's ``fused_density`` or the stateless adapter.  An incremental
    density has ``n_cache`` (per-chain float32 cache columns),
    ``full(k, rows) -> (lp, cache)`` (fresh evaluation and fresh cache of
    the chains, ``k`` their model indices) and ``coord(j, k, rows, old_j,
    cache) -> (lp, cache')`` (evaluation after ONLY coordinate j changed
    from ``old_j`` to ``rows[j]``; cache columns it did not touch come
    back as the same objects, so the sweep skips their accept-blends)."""
    if modelset.fused_density is not None:
        return modelset.fused_density
    return StatelessDensity(modelset)
