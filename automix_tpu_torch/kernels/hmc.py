"""Hamiltonian within-model move of the general engine.

Counterpart of ``automix_tpu/kernels/hmc.py``: ``sample_n_steps``, the
move of ``build_hmc_move`` over the whole chain batch, and
``tune_step_scale``.  One move is leapfrog HMC with a diagonal mass
preconditioner from the stage-1 scales: step size eps_j = scale_k *
sig[k, j], ``scale_k`` a per-model multiplier that
:func:`tune_step_scale` dual-averages toward ``cfg.hmc_target_accept``.
The leapfrog carries the gradient between steps (n + 1 gradient
evaluations for n steps), and the gradient is
``ModelSet.logpost_and_grad``, autograd of the chains' log-posterior.

The trajectory length is shared by the batch: uniform on 1..hmc_steps
under ``hmc_jitter``, drawn from a stream indexed by the sweep alone
(``kernels/rjmcmc.py``), so the batch runs exactly that many gradient
steps.  Every chain's length is still marginally uniform, and a
state-independent length keeps detailed balance.

Across devices (``tune_step_scale(..., mesh=)``, as JAX's) the tuning
chains split over the ranks in blocks of the [K * C] layout; each rank
draws its momenta and accept uniforms from the round key folded with its
rank, and the per-model acceptance sums are summed across the ranks every
round, so the dual-averaging state is the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.kernels.fused_stage1 import _accept
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.parallel import mesh as mesh_lib


def sample_n_steps(cfg: EngineConfig, u) -> int:
    """The move's trajectory length from a state-independent float32
    uniform ``u``: 1 + floor(u * hmc_steps) (at most hmc_steps) under
    jitter, else hmc_steps."""
    if not cfg.hmc_jitter:
        return int(cfg.hmc_steps)
    steps = 1 + int(np.floor(np.float32(u) * np.float32(cfg.hmc_steps)))
    return min(steps, int(cfg.hmc_steps))


def hmc_move(modelset, u_acc, n_steps: int, z, k, theta, logp, eps, mask):
    """One HMC move of every chain (JAX's ``build_hmc_move`` under vmap):
    accept uniforms ``u_acc`` [S], the shared length ``n_steps``, momenta
    ``z`` [S, D], model indices ``k`` [S], state ``theta`` [S, D] and
    ``logp`` [S], leapfrog steps ``eps`` [S, D] and the chains' coordinate
    masks [S, D].  Returns (theta', logp', accepted [S] bool).  A
    trajectory with a non-finite point or end value is rejected (its
    log-ratio -inf, clamped as every MH ratio)."""
    eps = eps * mask
    p0 = z * mask
    _, g = modelset.logpost_and_grad(k, theta)
    g = g * mask
    q, p = theta, p0
    lp_new = logp
    for _ in range(n_steps):
        p_half = p + 0.5 * eps * g
        q = (q + eps * p_half) * mask
        lp_new, g = modelset.logpost_and_grad(k, q)
        g = g * mask
        p = p_half + 0.5 * eps * g
    bad = ~(torch.isfinite(q).all(dim=1) & torch.isfinite(lp_new))
    h0 = -logp + 0.5 * torch.sum(p0 * p0, dim=1)
    h1 = -lp_new + 0.5 * torch.sum(p * p, dim=1)
    log_accept = torch.where(bad, torch.full_like(h0, -torch.inf), h0 - h1)
    acc = u_acc < _accept(log_accept)
    theta = torch.where(acc[:, None], q, theta)
    logp = torch.where(acc, lp_new, logp)
    return theta, logp, acc


def _log32(x: float) -> float:
    """float32 log as XLA computes it on the CPU."""
    return float(randoms._log(torch.tensor([x], dtype=torch.float32))[0])


def tune_step_scale(modelset, cfg: EngineConfig, sig, key,
                    n_rounds: int = 100, n_chains_per_model: int = 256,
                    device=None, mesh=None):
    """Dual averaging of the per-model HMC step multiplier (JAX's
    ``tune_step_scale``, Hoffman & Gelman 2014, Algorithm 5): ``n_rounds``
    HMC moves of ``n_chains_per_model`` chains pinned to each model, the
    pooled acceptance a_k of each round driving

        Hbar_t   = (1 - w_t) Hbar_{t-1} + w_t (delta - a_k),  w_t = 1/(t+t0)
        log s_t  = mu - sqrt(t)/gamma * Hbar_t
        log sbar = t^-kappa log s_t + (1 - t^-kappa) log sbar_{t-1}

    with ``sig`` [K, D] the stage-1 scales and ``key`` a threefry key.
    Each round's key is split from the last, its length drawn from the
    round key folded with 0x5EED, its accept uniforms and momenta from the
    round key's two halves, as in JAX.  Returns the multipliers exp(log
    sbar) as a [K] float64 numpy array.  Under a ``mesh`` (module note;
    its device) the same multipliers come back on every rank; the run's
    momenta differ from the run on one device, as JAX's do."""
    dev = torch.device(device) if device is not None else sig.device
    f32 = torch.float32
    K, D = modelset.nmodels, modelset.dmax
    C = n_chains_per_model
    M = K * C
    M_local = M if mesh is None else mesh.local(
        M, "K * n_chains_per_model")
    r0 = mesh_lib.chain0(mesh, M_local)
    rows = slice(r0, r0 + M_local)
    delta = float(np.float32(cfg.hmc_target_accept))
    t0, gamma, kappa = 10.0, np.float32(0.05), np.float32(0.75)
    if np.ndim(cfg.hmc_step_scale) == 0:
        mu0 = _log32(float(np.float32(10.0 * cfg.hmc_step_scale)))
    else:
        mu0 = _log32(2.0)
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    k_assign = torch.arange(K, device=dev).repeat_interleave(C)[rows]
    mask = (torch.arange(D, device=dev)[None, :]
            < dims[k_assign][:, None]).to(f32)
    sig_k = sig.to(f32).to(dev)[k_assign]

    rkey, k_init = randoms.split_host(key, 2)
    theta = modelset.init_points(k_init).to(dev)[k_assign]
    lp = modelset.logpost_batch(k_assign, theta)
    start = float(np.float32(np.float32(mu0) - np.float32(_log32(10.0))))
    log_s = torch.full((K,), start, dtype=f32, device=dev)
    log_sbar = log_s.clone()
    hbar = torch.zeros(K, dtype=f32, device=dev)
    for t in range(1, n_rounds + 1):
        rkey, rk = randoms.split_host(rkey, 2)
        nst = sample_n_steps(cfg, randoms.uniform_host(
            randoms.fold_in(rk, 0x5EED)))
        if mesh is not None:
            rk = randoms.fold_in(rk, mesh.rank)
        ku, kz = randoms.split_host(rk, 2)
        u = randoms.uniform(ku, (M_local,), dev)
        z = randoms.normal(kz, (M_local, D), dev)
        eps = torch.exp(log_s)[k_assign][:, None] * sig_k
        theta, lp, acc = hmc_move(modelset, u, nst, z, k_assign, theta, lp,
                                  eps, mask)
        a_k = mesh_lib.all_reduce_sum(torch.zeros(
            K, dtype=f32, device=dev).index_add_(0, k_assign, acc.to(f32)),
            mesh) / float(C)
        tt = np.float32(t)
        w = float(np.float32(1.0) / (tt + np.float32(t0)))
        hbar = (1.0 - w) * hbar + w * (delta - a_k)
        log_s = mu0 - float(np.sqrt(tt) / gamma) * hbar
        eta = float(np.power(tt, -kappa))
        log_sbar = eta * log_s + float(np.float32(1.0) - np.float32(eta)) \
            * log_sbar
    return torch.exp(log_sbar).cpu().numpy().astype(np.float64)
