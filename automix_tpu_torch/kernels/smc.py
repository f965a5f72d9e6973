"""Annealed SMC evidences per model: the port of the SMC alternative to
reversible-jump visit counting.

Counterpart of ``automix_tpu/kernels/smc.py`` on one device: one
annealed SMC per model, all models at once, bridging from the stage-2
mixture q_k to the target p_k through

    pi_beta  ∝  q_k(theta)^(1-beta) * p_k(theta)^beta,   beta: 0 -> 1,

so log Z_k = sum_t log E_{pi_{beta_t}}[exp(dbeta (log p - log q))] and,
each density carrying its model prior, the model probabilities are
softmax(log Z).  Every temperature step adds the evidence increment,
resamples each model's particles systematically and mutates them by
componentwise RWM targeting pi_beta with the stage-1 scales.  The ladder
is adaptive (each model's next beta by bisection so that the incremental
ESS stays at ``ess_target`` N, ``n_temps`` a cap that closes the bridge)
or linear.

Random words are JAX's threefry words from the same keys: the run's key
split for the start, one key per particle for the start draws, then per
step a key split per model for the resampling uniforms and a key per
move folded with the coordinate for the proposal normals and accept
uniforms.  The key chain is host ints; the draws are on the particles'
device.

Across devices (``mesh=``, as JAX's) the particle axis splits over the
ranks; each rank folds its rank into the start key and the move keys, so
the ranks draw disjoint streams.  Resampling needs the global weights:
once a temperature step the ranks' weights (and the particle cloud, a few
floats a particle) are gathered, the evidence increment, the ESS, the
adaptive ladder's bisection and the resampling indices come from the
global weights on every rank alike, and each rank keeps its slice of the
resampled cloud.  The final particles are gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from automix_tpu_torch.kernels.fused_stage1 import _accept
from automix_tpu_torch.ops import linalg, randoms
from automix_tpu_torch.parallel import mesh as mesh_lib


def _loglam(lam):
    return torch.where(lam > 0, torch.log(torch.clamp(lam, min=1e-38)),
                       torch.full_like(lam, -torch.inf))


def _mixture_logq(theta, lam, mu, B, dims):
    """log q_k(theta) of each model's particles: ``theta`` [K, N, D] under
    the fitted Normal mixtures lam [K, L], mu [K, L, D], B [K, L, D, D]
    of the model dims ``dims`` [K]."""
    lp = linalg.lnormprob(theta[:, :, None, :], mu[:, None], B[:, None],
                          dims[:, None, None])                  # [K, N, L]
    return torch.logsumexp(_loglam(lam)[:, None, :] + lp, dim=-1)


def _sample_mixture(keys, lam, mu, B, dims):
    """theta ~ q_k for every particle, one key per particle (``keys``
    [K, N, 2]): the component ``categorical(fold_in(key, 0), log lam)``,
    the normals ``normal(fold_in(key, 1), (D,))``."""
    K, N = keys.shape[:2]
    L, D = mu.shape[1], mu.shape[2]
    gum = randoms.gumbel_noise(randoms.fold_in(keys, 0), (L,))
    comp = torch.argmax(gum + _loglam(lam)[:, None, :], dim=-1)  # [K, N]
    z = randoms.normal(randoms.fold_in(keys, 1), (D,))           # [K, N, D]
    mask = (torch.arange(D, device=z.device)[None, :]
            < dims[:, None]).to(z.dtype)[:, None, :]
    rows = torch.arange(K, device=z.device)[:, None]
    theta = mu[rows, comp] + linalg.lower_matvec(B[rows, comp], z * mask)
    return theta * mask


def _systematic_resample(key, logw, n: int):
    """Systematic resampling indices [n] from the log-weights ``logw`` [N]
    with the uniform offset ``uniform(key, ())``: the first index whose
    cumulative normalized weight reaches (u0 + i) / n.  The float32
    cumulative sum can end below 1, so the last points can lie past it:
    JAX's ``searchsorted`` gives them N, which its gather fills with NaN
    and the whole model's evidence with it; here they take the last
    particle of positive weight, the one whose interval they fall in."""
    w = torch.exp(logw - torch.logsumexp(logw, dim=0))
    cum = torch.cumsum(w, dim=0)
    u0 = float(randoms.uniform_host(key))
    pts = (u0 + torch.arange(n, device=logw.device,
                             dtype=torch.float32)) / float(n)
    idx = torch.searchsorted(cum, pts, side="left")
    last = w.shape[0] - 1 - torch.argmax(torch.flip(w > 0, (0,)).to(
        torch.uint8))
    return torch.minimum(idx, last)


def _take(x, idx):
    """x[m, idx[m]] per model."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def run_smc(modelset, cfg, proposal, key, n_particles: int = 2048,
            n_temps: int = 20, n_moves: int = 3, betas=None,
            tempering: str = "adaptive", ess_target: float = 0.5,
            mesh=None):
    """Annealed SMC for all models at once on the proposal's device (JAX's
    ``run_smc``).  ``key`` is a threefry key.  Returns a dict of numpy
    arrays: ``log_evidence`` [K], ``model_probs`` [K] (softmax of the
    evidences), ``ess`` [n_temps, K] (adaptive runs pad unused steps
    with N), ``betas_used`` [n_temps, K], and the final particles
    ``theta`` [K, N, D] with their ``logp`` [K, N].  Under a ``mesh``
    (module note) ``n_particles`` is the global count, which its ranks
    must split evenly, and every rank returns the same dict."""
    K, D = modelset.nmodels, modelset.dmax
    N = int(n_particles)
    Nloc = N if mesh is None else mesh.local(N, "n_particles")
    p0 = mesh_lib.chain0(mesh, Nloc)
    mine = slice(p0, p0 + Nloc)
    dev = proposal.lam.device
    f32 = torch.float32
    adaptive = tempering == "adaptive" and betas is None
    if betas is None:
        betas = np.linspace(0.0, 1.0, n_temps + 1, dtype=np.float32)[1:]
    else:
        betas = np.asarray(betas, np.float32)
        n_temps = betas.shape[0]
    lam, mu, B = (proposal.lam.to(f32), proposal.mu.to(f32),
                  proposal.B.to(f32))
    sig = proposal.sig.to(f32)
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    k_idx = torch.arange(K, device=dev).repeat_interleave(Nloc)
    # the models a move on coordinate j changes (the others' values are
    # never accepted)
    above = [[m for m in range(K) if modelset.dims[m] > j] for j in range(D)]
    log_n = float(randoms._log(torch.tensor([float(N)], dtype=f32))[0])

    def logq_all(theta):
        return _mixture_logq(theta, lam, mu, B, dims)

    def logp_all(theta, models=None):
        return modelset.logpost_batch(k_idx, theta.reshape(K * Nloc, D),
                                      models).reshape(K, Nloc)

    def gather(x):
        return mesh_lib.all_gather(x, mesh, dim=1)

    def rank_key(k):
        return k if mesh is None else randoms.fold_in(k, mesh.rank)

    key, k_init = randoms.split_host(key, 2)
    init_keys = randoms.split(rank_key(k_init), K * Nloc,
                              dev).reshape(K, Nloc, 2)
    theta = _sample_mixture(init_keys, lam, mu, B, dims)
    logq = logq_all(theta)
    logp = logp_all(theta)
    logz = torch.zeros(K, dtype=f32, device=dev)

    def lse(x):
        return torch.logsumexp(x, dim=1)

    def ess_of(lw):
        return torch.exp(2 * lse(lw) - lse(2 * lw))

    def step(theta, logp, logq, logz, key, beta_new, dbeta, delta):
        # delta: the global logp - logq [K, N]
        lw = dbeta[:, None] * delta
        logz = logz + lse(lw) - log_n
        ess = ess_of(lw)
        key, k_rs = randoms.split_host(key, 2)
        idx = torch.stack([_systematic_resample(kk, lw[m], N) for m, kk in
                           enumerate(randoms.split_host(k_rs, K))])[:, mine]
        theta, logp, logq = _take(gather(theta), idx), \
            _take(gather(logp), idx), _take(gather(logq), idx)
        key, k_mv = randoms.split_host(key, 2)
        b = beta_new[:, None]
        for mkey in randoms.split_host(k_mv, n_moves):
            mkey = rank_key(mkey)
            for j in range(D):
                ck = randoms.fold_in(mkey, j)
                z = randoms.normal(randoms.fold_in(ck, 0), (K, Nloc), dev)
                u = randoms.uniform(randoms.fold_in(ck, 1), (K, Nloc), dev)
                active = (j < dims)[:, None]
                prop = theta[:, :, j] + sig[:, j][:, None] * z
                theta_p = theta.clone()
                theta_p[:, :, j] = torch.where(active, prop, theta[:, :, j])
                logp_p = logp_all(theta_p, above[j])
                logq_p = logq_all(theta_p)
                dlt = b * (logp_p - logp) + (1 - b) * (logq_p - logq)
                acc = (u < _accept(dlt)) & active
                theta = torch.where(acc[:, :, None], theta_p, theta)
                logp = torch.where(acc, logp_p, logp)
                logq = torch.where(acc, logq_p, logq)
        return theta, logp, logq, logz, key, ess

    ess_buf = torch.full((n_temps, K), float(N), dtype=f32, device=dev)
    beta_buf = torch.ones((n_temps, K), dtype=f32, device=dev)
    if not adaptive:
        prev = np.float32(0.0)
        for t, beta in enumerate(betas):
            bk = torch.full((K,), float(beta), dtype=f32, device=dev)
            dbk = torch.full((K,), float(np.float32(beta - prev)),
                             dtype=f32, device=dev)
            theta, logp, logq, logz, key, ess = step(
                theta, logp, logq, logz, key, bk, dbk, gather(logp - logq))
            ess_buf[t], beta_buf[t] = ess, bk
            prev = beta
    else:
        target = float(np.float32(ess_target * N))
        close = float(np.float32(1.0 - 1e-6))
        beta = torch.zeros(K, dtype=f32, device=dev)
        t = 0
        while t < n_temps and bool((beta < 1.0).any()):
            delta = gather(logp - logq)
            hi0 = 1.0 - beta
            full_ok = ess_of(hi0[:, None] * delta) >= target
            lo, hi = torch.zeros_like(beta), hi0
            for _ in range(26):
                mid = 0.5 * (lo + hi)
                good = ess_of(mid[:, None] * delta) >= target
                lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid)
            dbeta = torch.where(full_ok, hi0, lo)
            if t == n_temps - 1:
                dbeta = hi0
            beta_new = torch.where(beta + dbeta > close,
                                   torch.ones_like(beta), beta + dbeta)
            dbeta = beta_new - beta
            theta, logp, logq, logz, key, ess = step(
                theta, logp, logq, logz, key, beta_new, dbeta, delta)
            ess_buf[t], beta_buf[t] = ess, beta_new
            beta = beta_new
            t += 1
    probs = torch.softmax(logz, dim=0)
    return {k: v.cpu().numpy() for k, v in (
        ("log_evidence", logz), ("model_probs", probs), ("ess", ess_buf),
        ("betas_used", beta_buf), ("theta", gather(theta)),
        ("logp", gather(logp)))}
