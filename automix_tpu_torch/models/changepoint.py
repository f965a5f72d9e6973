"""Poisson change-point model selection (thesis section 5.5.2, Green 1995).

Counterpart of ``automix_tpu/models/changepoint.py``: the coal-mining
disaster times (``usercpt.c``) and their variant rescaled by 1459
(``usercptrs.c``); six models, model k having k + 1 change points and
k + 2 Poisson rates (dims 3, 5, ..., 13), Gamma(alpha, beta) rate priors,
a Poisson(lambda) prior on the number of change points and the
even-order-statistics prior on their positions.  A state with a rate
<= 0 or a segment of length <= 0 (change points unordered or outside
(0, T)) gets the set's reject value, -10000 or -100000.

The likelihood counts the events of each segment exactly, as JAX's
``searchsorted(s_in, data, side="left")`` histogram does, not as the C
walk (which misassigns events after an empty segment).  With the change
points s_0 < ... < s_{n-1} in order, an event x lies in segment q exactly
when s_{q-1} < x <= s_q, so the count of segment q is G_q - G_{q-1} with
G_q the number of events <= s_q: integer counts, exact by any algorithm.

The family is one column form (:func:`family_cols`) with each chain's own
model; the per-model ``logp_cols`` are that form at a fixed model.  It
follows JAX's operation order: the prior's per-segment terms and the
likelihood's each summed from the first segment on, the Python-float
constants rounded to float32 as JAX's typing rounds them (folded on the
host in float64 first).  The CUDA kernels evaluate the same formula
(``am_density_cpt`` in ``csrc/changepoint.cuh``); the 191 event times of
both sets reach them through the header :func:`header` generates
(``am_cpt.h``), so kernel and twin read one source.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from scipy.special import gammaln

from automix_tpu_torch.model import CudaDensity, Model, ModelSet

# Density kinds of csrc/common.cuh.
KIND_CPT = 11
KIND_CPTRS = 12

# Coal-mining disaster times (usercpt.c:56-76), interval [0, 40907].
COAL_DATA = np.array([
    74, 231, 354, 356, 480, 492, 496, 506, 722, 802,
    814, 847, 913, 1145, 1971, 2011, 2023, 2052, 2242, 2339,
    2404, 2590, 2613, 2705, 2902, 3333, 3349, 3503, 3598, 3623,
    3642, 3720, 3922, 3958, 4068, 4344, 4360, 4448, 4673, 4726,
    4743, 5281, 5468, 5502, 5603, 5644, 5783, 5825, 5826, 6076,
    6156, 6159, 6483, 6539, 6570, 6666, 6736, 6777, 6870, 6894,
    6985, 7128, 7144, 7171, 7315, 7360, 7366, 7574, 7603, 7715,
    7758, 7951, 8085, 8505, 8600, 8725, 8759, 8886, 9104, 9106,
    9106, 9484, 9520, 9535, 9566, 9781, 9792, 9929, 9933, 9948,
    10020, 10116, 10240, 10290, 10410, 10613, 10789, 10844, 10937, 10996,
    11311, 11370, 11431, 11432, 11445, 11634, 11979, 11999, 12080, 12366,
    12480, 12588, 12776, 13009, 13037, 13059, 13120, 13198, 13297, 13623,
    13898, 13952, 14169, 14282, 14314, 14702, 14853, 15214, 15526, 15880,
    16187, 16462, 16540, 16557, 17762, 18406, 18873, 19744, 19792, 19915,
    20371, 20869, 20918, 21049, 21231, 21486, 21680, 21904, 22470, 22932,
    23160, 23966, 24483, 26126, 26180, 26506, 27818, 28166, 28911, 29128,
    29248, 29523, 29543, 29609, 29901, 29905, 30273, 30580, 30916, 30935,
    31264, 31594, 31906, 32442, 32587, 32662, 33026, 33063, 33082, 33238,
    33285, 33414, 35044, 35073, 35290, 35297, 35315, 36673, 39039, 39991,
    40623], dtype=np.float64)

K = 6                        # models: 1 ... 6 change points
D = 2 * K + 1                # the largest model's 7 rates and 6 points
N_EVENTS = len(COAL_DATA)


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True, eq=False)
class ChangepointSpec:
    """One data set and its constants (automix_tpu/models/changepoint.py
    cpt_set, cptrs_set)."""

    name: str
    kind: int
    data: np.ndarray         # float64 event times, as the reference has them
    t_end: float
    alpha: float
    beta: float
    lam_prior: float
    reject_value: float

    @functools.cached_property
    def events(self) -> np.ndarray:
        """The sorted events in float64, then rounded to float32 (JAX's
        order: a cast before the rounding of cptrs' times would move
        events across a change point)."""
        return np.sort(np.asarray(self.data, np.float64)).astype(np.float32)

    def consts(self, nsteps: int) -> tuple:
        """The CudaDensity constants of the model with ``nsteps`` change
        points, each rounded to float32 once: nsteps; the prior constant
        of the number of change points; the order-statistics constants
        added and subtracted after the per-segment sum; the Gamma
        constant alpha log beta - lgamma(alpha); alpha - 1; beta; T; the
        reject value."""
        lam = self.lam_prior
        p0 = -lam + nsteps * np.log(lam) - float(gammaln(nsteps + 1.0))
        a2 = float(gammaln(2.0 * (nsteps + 1)))
        b2 = (2.0 * nsteps + 1.0) * np.log(self.t_end)
        abcon = self.alpha * np.log(self.beta) - float(gammaln(self.alpha))
        return (float(nsteps), _f32(p0), _f32(a2), _f32(b2), _f32(abcon),
                _f32(self.alpha - 1.0), _f32(self.beta), _f32(self.t_end),
                _f32(self.reject_value))

    def tables(self, device):
        """(the models' constants float32 [K, 9], the events float32 [N])
        on ``device``, made once per device."""
        key = (self.name, torch.device(device))
        if key not in _TABLES:
            _TABLES[key] = (
                torch.tensor([self.consts(m + 1) for m in range(K)],
                             dtype=torch.float32, device=device),
                torch.from_numpy(self.events).to(device))
        return _TABLES[key]


_TABLES = {}


CPT = ChangepointSpec("cpt", KIND_CPT, COAL_DATA, 40907.0, alpha=1.0,
                      beta=200.0, lam_prior=3.0, reject_value=-10000.0)
# usercptrs.c: the times over 1459, rounded to 2 decimals in float64
CPTRS = ChangepointSpec("cptrs", KIND_CPTRS, np.round(COAL_DATA / 1459.0, 2),
                        28.04, alpha=1.0, beta=0.137, lam_prior=3.0,
                        reject_value=-100000.0)


def family_cols(spec: ChangepointSpec, k, rows):
    """Log-posterior of each chain under its own model of ``spec``: ``k``
    [S] model indices (k + 1 change points), ``rows`` the D coordinate
    tensors [S] (rates first, then change points).  Unsanitized."""
    f32 = torch.float32
    consts, events = spec.tables(rows[0].device)
    ns = k.long() + 1
    p0, a2, b2, abcon, am1, beta, t_end, rej = consts[k][:, 1:].unbind(1)
    th = torch.stack(list(rows))
    # boundaries: 0, the ns change points, T
    bnd = [torch.zeros_like(rows[0])]
    for q in range(K):
        s_q = th.gather(0, torch.clamp(ns + 1 + q, max=D - 1)[None])[0]
        bnd.append(torch.where(q < ns, s_q, t_end))
    bnd.append(t_end)
    act = [q <= ns for q in range(K + 1)]
    h = [rows[q] for q in range(K + 1)]
    ds = [bnd[q + 1] - bnd[q] for q in range(K + 1)]
    ok = None
    for q in range(K + 1):
        okq = ((h[q] > 0.0) & (ds[q] > 0.0)) | ~act[q]
        ok = okq if ok is None else ok & okq
    hs = [torch.where(ok, h[q], 1.0) for q in range(K + 1)]
    dss = [torch.where(ok, ds[q], 1.0) for q in range(K + 1)]
    lhs = [torch.log(x) for x in hs]

    def seq_sum(terms):
        out = terms[0]
        for q in range(1, K + 1):
            out = torch.where(act[q], out + terms[q], out)
        return out

    # prior (usercpt.c:100-109)
    lp = p0 + seq_sum([((abcon + am1 * lhs[q]) - beta * hs[q])
                       + torch.log(dss[q]) for q in range(K + 1)])
    lp = (lp + a2) - b2
    # likelihood: the events of each segment (usercpt.c:115-130), from
    # the events up to each change point; the last segment ends at T
    cum = [torch.where(q < ns, torch.searchsorted(events, bnd[q + 1],
                                                  right=True), N_EVENTS)
           for q in range(K)]
    cum.append(torch.full_like(cum[0], N_EVENTS))
    nj = [cum[q] - (cum[q - 1] if q else 0) for q in range(K + 1)]
    llh = seq_sum([nj[q].to(f32) * lhs[q] - hs[q] * dss[q]
                   for q in range(K + 1)])
    return torch.where(ok, lp + llh, rej)


def header() -> str:
    """``am_cpt.h``: the family's shape (K, D), which alone compiles the
    density in, the number of events and both sets' float32 events (cpt,
    then cptrs), sorted, in global memory for ``am_density_cpt``'s binary
    search."""
    body = ", ".join(repr(float(x))
                     for spec in (CPT, CPTRS) for x in spec.events)
    return ("// Generated by automix_tpu_torch/kernels/_build.py from "
            "automix_tpu_torch/models/changepoint.py.\n#pragma once\n"
            f"#define AM_CPT_K {K}\n"
            f"#define AM_CPT_D {D}\n"
            f"#define AM_CPT_N {N_EVENTS}\n"
            f"static __device__ float am_cpt_events[{2 * N_EVENTS}] = "
            f"{{{body}}};\n")


def _model(spec: ChangepointSpec, m: int) -> Model:
    nsteps = m + 1
    dim = 2 * nsteps + 1

    def cols(rows):
        pad = list(rows) + [torch.zeros_like(rows[0])] * (D - len(rows))
        return family_cols(spec, torch.full_like(rows[0], m,
                                                 dtype=torch.int64), pad)

    # stage-1 inits (usercpt.c:32-40): rates at the prior mean, change
    # points evenly spaced
    init = np.empty(dim)
    init[:nsteps + 1] = spec.alpha / spec.beta
    init[nsteps + 1:] = spec.t_end * np.arange(1, nsteps + 1) / (nsteps + 1)
    return Model(f"cpt_k{m + 1}", dim, cols, init=init,
                 cuda=CudaDensity(spec.kind, spec.consts(nsteps)))


def _set(spec: ChangepointSpec) -> ModelSet:
    return ModelSet([_model(spec, m) for m in range(K)],
                    batched_logpost_cols=functools.partial(family_cols,
                                                           spec))


@functools.cache
def cpt_set() -> ModelSet:
    """usercpt.c: raw time scale [0, 40907], Gamma(1, 200) rate priors."""
    return _set(CPT)


@functools.cache
def cptrs_set() -> ModelSet:
    """usercptrs.c: times over 1459 rounded to 2 decimals, T = 28.04,
    beta = 0.137."""
    return _set(CPTRS)
