"""Stage 2: Figueiredo-Jain component-annihilating EM, batched over models.

Counterpart of ``fit_figueiredo``, ``fit_autorj``, ``fit_proposal`` and
``trim_proposal`` of ``automix_tpu/kernels/em.py``, in plain torch with a
leading model axis K.  A component is a slot with an alive mask (dead
slots keep lam == 0); responsibilities are computed in log space; the fit
runs in phases of shrinking slot width (lmax -> 10 -> 4), compacting live
slots to the front between phases, exactly as the JAX fit does.

The JAX ``lax.while_loop`` under ``vmap`` becomes a Python loop that runs
while any model continues and keeps the old state of models that stopped.
Deciding whether to go on reads one flag per iteration on the host: on
the card that is one device-to-host sync per EM iteration.

Across devices (``mesh=``) the sample axis stays split over the ranks, as
stage 1 leaves it: every sample-axis sum (responsibility sums, weighted
means and Gram matrices, the mixture log-likelihood) is summed across the
ranks (JAX's ``psum`` points, em.py:79,186,195,197), and only the
component seeding gathers the samples, so every rank starts from the same
components and takes the same decisions.  The AutoRJ fit gathers its
samples first.
"""

from __future__ import annotations

import math

import torch

from automix_tpu_torch.config import (EM_ANNIHILATION_THRESHOLD,
                                      EM_DEGENERATE_LOGSUM,
                                      EM_DEGENERATE_PENALTY, EngineConfig)
from automix_tpu_torch.ops import linalg
from automix_tpu_torch.parallel import mesh as mesh_lib
from automix_tpu_torch.state import Proposal


def _renormalize(lam, alive):
    lam = lam * alive.to(lam.dtype)
    return lam / torch.clamp(lam.sum(-1, keepdim=True), min=1e-38)


def _e_step(lam, alive, lpdata, psum=lambda x: x):
    """Responsibilities w [K, N, L] and mixture log-likelihood lpn [K]
    (``psum`` sums it over the ranks holding the samples)."""
    alive_f = alive.to(lpdata.dtype)
    n_alive = torch.clamp(alive_f.sum(-1), min=1.0)
    loglam = torch.where(alive, torch.log(torch.clamp(lam, min=1e-38)),
                         -math.inf)
    logw = loglam[:, None, :] + lpdata
    logsum = torch.logsumexp(logw, dim=2)                      # [K, N]
    degenerate = logsum < EM_DEGENERATE_LOGSUM
    shift = torch.where(degenerate, 0.0, logsum)
    softmax = torch.exp(logw - shift[..., None]) * alive_f[:, None, :]
    uniform = (alive_f / n_alive[:, None])[:, None, :]
    w = torch.where(degenerate[..., None], uniform, softmax)
    lpn = psum(torch.where(degenerate, EM_DEGENERATE_PENALTY,
                           logsum).sum(-1))
    return w, lpn


def _mml_cost(lam, alive, Lkk, lpn, nparams, n: int):
    """The MML cost of the current mixture [K]."""
    s = torch.where(alive, torch.log(torch.clamp(n * lam / 12.0,
                                                 min=1e-38)), 0.0).sum(-1)
    Lf = Lkk.to(lam.dtype)
    log_n12 = torch.log(torch.tensor(n / 12.0, dtype=lam.dtype,
                                     device=lam.device))
    return (nparams / 2.0) * s + (Lf / 2.0) * log_n12 \
        + Lf * (nparams + 1.0) / 2.0 - lpn


def _lnormprob_slots(samples, mu, B, dim):
    """[K, N, L] log-densities of every slot: samples [K, N, D], mu
    [K, L, D], B [K, L, D, D], dim [K]."""
    return linalg.lnormprob(samples[:, :, None, :], mu[:, None],
                            B[:, None], dim[:, None, None])


def _where_k(mask, new, old):
    """Per-model select with ``mask`` [K] broadcast over trailing axes."""
    return torch.where(mask.reshape(-1, *([1] * (new.dim() - 1))), new, old)


def _pad_l(x, fill, lmax: int):
    """Pad the slot axis (axis 1) of an active-width array to lmax."""
    Lw = x.shape[1]
    if Lw == lmax:
        return x
    pad = torch.full((x.shape[0], lmax - Lw, *x.shape[2:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def fit_figueiredo(samples, dims, lmax: int, max_iters: int,
                   generator: torch.Generator = None, seed_idx=None,
                   mesh=None):
    """Fit every model's mixture.  ``samples`` [K, N, D] padded, ``dims``
    [K] int tensor.  Seeding indices come from ``generator`` (N distinct
    samples per model, tiled to lmax) unless ``seed_idx`` [K, lmax] is
    given.  Returns dict with lam, mu, B [K, lmax, ...], alive, nmix,
    iters and the per-iteration telemetry.  Under a ``mesh`` ``samples``
    is this rank's block of the sample axis (module note); the seeding
    indices index the gathered [K, N_total, D], and every rank's
    generator must be in the same state."""
    dev, dtype = samples.device, samples.dtype

    def psum(x):
        return mesh_lib.all_reduce_sum(x, mesh)

    samples_g = mesh_lib.all_gather(samples, mesh, dim=1)
    K, N, D = samples_g.shape
    dims = dims.to(dev)
    dimf = dims.to(dtype)
    nparams = dimf + dimf * (dimf + 1.0) / 2.0                  # [K]
    coord_mask = linalg.dim_mask(dims, D, dtype)                 # [K, D]
    eye = torch.eye(D, dtype=dtype, device=dev)

    # --- init: components at distinct random samples with a common
    # spherical covariance trace(cov) / (10 * dim); live count ~N/20
    l_init = max(1, min(lmax, N // 20 if N >= 20 else 1))
    if seed_idx is None:
        n_pick = min(lmax, N)
        idx = torch.stack([torch.randperm(N, generator=generator)[:n_pick]
                           for _ in range(K)])
        reps = -(-lmax // n_pick)
        seed_idx = idx.repeat(1, reps)[:, :lmax]
    seed_idx = torch.as_tensor(seed_idx, dtype=torch.int64).to(dev)
    mu0 = torch.gather(samples_g, 1,
                       seed_idx[..., None].expand(K, lmax, D))
    var = samples_g.var(dim=1, unbiased=False) * coord_mask      # [K, D]
    del samples_g
    sigma = var.sum(-1) / (10.0 * dimf)
    diag0 = torch.where(coord_mask > 0, torch.sqrt(sigma)[:, None], 1.0)
    B0 = torch.diag_embed(diag0)[:, None].expand(K, lmax, D, D).clone()
    alive0 = (torch.arange(lmax, device=dev) < l_init).expand(K, lmax)
    lam0 = torch.where(alive0, 1.0 / l_init, 0.0).to(dtype)
    lpdata0 = _lnormprob_slots(samples, mu0, B0, dims)
    w0, lpn0 = _e_step(lam0, alive0, lpdata0, psum)

    zk_i = torch.zeros(K, dtype=torch.int32, device=dev)
    zk_f = torch.zeros(K, dtype=dtype, device=dev)
    st = {
        "lam": lam0, "mu": mu0, "B": B0, "lpdata": lpdata0, "w": w0,
        "alive": alive0.clone(), "Lkk": zk_i + l_init, "lpn": lpn0,
        "costfn": zk_f.clone(), "costmin": zk_f + math.inf,
        "best_lam": lam0, "best_mu": mu0, "best_B": B0,
        "best_alive": alive0.clone(), "best_Lkk": zk_i + l_init,
        "count": zk_i.clone(), "stop": torch.zeros(K, dtype=torch.bool,
                                                   device=dev),
        "tele_Lkk": torch.zeros((K, max_iters), dtype=torch.int32,
                                device=dev),
        "tele_lpn": torch.zeros((K, max_iters), dtype=dtype, device=dev),
        "tele_cost": torch.zeros((K, max_iters), dtype=dtype, device=dev),
        "tele_ann": torch.zeros((K, max_iters), dtype=torch.int32,
                                device=dev),
    }
    ar_k = torch.arange(K, device=dev)

    def slot_step(st, l1):
        """Component-wise M-step + E-step for slot l1 of every model.
        Updates the iteration's own copies of mu, B, lpdata in place."""
        lam, alive, w = st["lam"], st["alive"], st["w"]
        process = alive[:, l1]
        sumw = psum(w.sum(1))                                    # [K, L]
        wnew = torch.clamp(sumw - nparams[:, None] / 2.0, min=0.0) \
            * alive.to(dtype)
        lam_upd = lam.clone()
        lam_upd[:, l1] = wnew[:, l1] / torch.clamp(wnew.sum(-1), min=1e-38)
        lam_upd = _renormalize(lam_upd, alive)
        keep = lam_upd[:, l1] > EM_ANNIHILATION_THRESHOLD

        # refit component l1
        wl = w[:, :, l1]                                         # [K, N]
        sw = torch.clamp(sumw[:, l1], min=1e-38)
        mean = psum(torch.einsum("kn,knd->kd", wl, samples)) \
            / sw[:, None] * coord_mask
        xc = (samples - mean[:, None]) * coord_mask[:, None]
        cov = psum(torch.einsum("kn,kni,knj->kij", wl, xc, xc)) \
            / sw[:, None, None]
        cov = torch.where(torch.isfinite(cov), cov, eye)
        B_l1 = linalg.chol(cov, dims, jitter=1e-6)
        B_l1 = torch.where(torch.isfinite(B_l1), B_l1, eye)
        lp_l1 = linalg.lnormprob(samples, mean[:, None], B_l1[:, None],
                                 dims[:, None])                  # [K, N]

        # natural annihilation: kill the slot and renormalize
        lam_z = lam_upd.clone()
        lam_z[:, l1] = 0.0
        alive_z = alive.clone()
        alive_z[:, l1] = False
        lam_ann = _renormalize(lam_z, alive_z)

        upd_keep = process & keep
        upd_ann = process & ~keep
        lam = torch.where(upd_ann[:, None], lam_ann,
                          torch.where(process[:, None], lam_upd, lam))
        alive = alive.clone()
        alive[:, l1] = alive[:, l1] & ~upd_ann
        mu, B, lpdata = st["mu"], st["B"], st["lpdata"]
        mu[:, l1] = _where_k(upd_keep, mean, mu[:, l1])
        B[:, l1] = _where_k(upd_keep, B_l1, B[:, l1])
        lpdata[:, :, l1] = _where_k(upd_keep, lp_l1, lpdata[:, :, l1])
        w, lpn = _e_step(lam, alive, lpdata, psum)
        return dict(st, lam=lam, alive=alive, w=w,
                    Lkk=st["Lkk"] - upd_ann.to(torch.int32),
                    lpn=lpn, natann=st["natann"] | upd_ann)

    def iteration(st0, Lw):
        """One EM iteration of every model (the while-loop body)."""
        count = st0["count"] + 1
        st = dict(st0, count=count, mu=st0["mu"].clone(),
                  B=st0["B"].clone(), lpdata=st0["lpdata"].clone(),
                  natann=torch.zeros(K, dtype=torch.bool, device=dev))
        for l1 in range(Lw):
            st = slot_step(st, l1)

        cost_new = _mml_cost(st["lam"], st["alive"], st["Lkk"], st["lpn"],
                             nparams, N)
        first = count == 1
        costfn = torch.where(first, cost_new, st["costfn"])
        better = first | (cost_new < st["costmin"])
        best = {
            "best_lam": _where_k(better, _pad_l(st["lam"], 0.0, lmax),
                                 st["best_lam"]),
            "best_mu": _where_k(better, _pad_l(st["mu"], 0.0, lmax),
                                st["best_mu"]),
            "best_B": _where_k(better, _pad_l(st["B"], 0.0, lmax),
                               st["best_B"]),
            "best_alive": _where_k(better, _pad_l(st["alive"], False, lmax),
                                   st["best_alive"]),
            "best_Lkk": torch.where(better, st["Lkk"], st["best_Lkk"]),
        }
        costmin = torch.where(better, cost_new, st["costmin"])

        converged = ((torch.abs(costfn - cost_new)
                      < torch.clamp(1e-5 * torch.abs(costfn), max=0.01))
                     & (count > 1))
        stop = converged & (st["Lkk"] == 1)

        # forced annihilation of the min-weight component on convergence
        force = converged & (st["Lkk"] > 1)
        lam_masked = torch.where(st["alive"], st["lam"], math.inf)
        ldel = torch.argmin(lam_masked, dim=1)
        alive_f = st["alive"].clone()
        alive_f[ar_k, ldel] = alive_f[ar_k, ldel] & ~force
        lam_d = st["lam"].clone()
        lam_d[ar_k, ldel] = 0.0
        lam_f = _where_k(force, _renormalize(lam_d, alive_f), st["lam"])
        Lkk_f = st["Lkk"] - force.to(torch.int32)
        w_f, lpn_f = _e_step(lam_f, alive_f, st["lpdata"], psum)
        cost_f = _mml_cost(lam_f, alive_f, Lkk_f, lpn_f, nparams, N)
        lam = _where_k(force, lam_f, st["lam"])
        alive = _where_k(force, alive_f, st["alive"])
        Lkk = torch.where(force, Lkk_f, st["Lkk"])
        w = _where_k(force, w_f, st["w"])
        lpn = torch.where(force, lpn_f, st["lpn"])
        cost_new = torch.where(force, cost_f, cost_new)
        stop = stop | (count > max_iters)

        # telemetry: annulations code natann + 2*force
        t = torch.clamp(count - 1, max=max_iters - 1).long()
        tele = {}
        for name, val in (("tele_Lkk", Lkk), ("tele_lpn", lpn),
                          ("tele_cost", cost_new),
                          ("tele_ann", st["natann"].to(torch.int32)
                           + 2 * force.to(torch.int32))):
            arr = st[name].clone()
            arr[ar_k, t] = val.to(arr.dtype)
            tele[name] = arr
        new = dict(st, lam=lam, alive=alive, Lkk=Lkk, w=w, lpn=lpn,
                   costfn=cost_new, costmin=costmin, stop=stop, **tele,
                   **best)
        del new["natann"]
        return new

    def compact(st, next_w):
        """Permute live slots to the front and truncate the active state to
        ``next_w`` slots (best_* buffers keep the full width)."""
        order = torch.argsort((~st["alive"]).to(torch.int8), dim=1,
                              stable=True)
        take = order[:, :next_w]

        def tk(x, axis):
            shape = [1] * x.dim()
            shape[0], shape[axis] = K, next_w
            idx = take.reshape(shape).expand(
                *[x.shape[i] if i not in (0, axis) else shape[i]
                  for i in range(x.dim())])
            return torch.gather(x, axis, idx)

        return dict(st, lam=tk(st["lam"], 1), mu=tk(st["mu"], 1),
                    B=tk(st["B"], 1), alive=tk(st["alive"], 1),
                    lpdata=tk(st["lpdata"], 2), w=tk(st["w"], 2))

    widths = [lmax] + [wdt for wdt in (10, 4) if wdt < lmax]
    for pi, Lw in enumerate(widths):
        next_w = widths[pi + 1] if pi + 1 < len(widths) else 0
        while True:
            go = ~(st["stop"] | (st["Lkk"] <= next_w))
            go_host = go.tolist()                # one host sync per iteration
            if not any(go_host):
                break
            new = iteration(st, Lw)
            st = new if all(go_host) else {
                name: _where_k(go, new[name], st[name]) for name in st}
        if next_w:
            st = compact(st, next_w)

    best_alive = st["best_alive"]
    af = best_alive.to(dtype)
    lam = _renormalize(st["best_lam"], best_alive)
    mu = st["best_mu"] * af[..., None]
    B = torch.where(best_alive[..., None, None], st["best_B"], eye)
    return {
        "lam": lam, "mu": mu, "B": B, "alive": best_alive,
        "nmix": st["best_Lkk"], "iters": st["count"],
        "tele": {"Lkk": st["tele_Lkk"], "lpn": st["tele_lpn"],
                 "cost": st["tele_cost"], "ann": st["tele_ann"]},
    }


def fit_autorj(samples, dims):
    """AutoRJ mode: one Normal per model (the reference's
    automix.c:1008-1033), batched over K.  ``samples`` [K, N, D], ``dims``
    [K].  Returns (mean [K, D], lower Cholesky factor B [K, D, D])."""
    K, N, D = samples.shape
    coord_mask = linalg.dim_mask(dims, D, samples.dtype)         # [K, D]
    mean = samples.mean(dim=1) * coord_mask
    xc = (samples - mean[:, None]) * coord_mask[:, None]
    cov = torch.einsum("kni,knj->kij", xc, xc) / (N - 1)
    return mean, linalg.chol(cov, dims, jitter=1e-6)


def fit_proposal(modelset, cfg: EngineConfig, samples, sig,
                 generator: torch.Generator = None, seed_idx=None,
                 mesh=None):
    """Fit every model's proposal: ``samples`` [K, C, D] stage-1 output,
    ``sig`` [K, D] adapted scales.  ``cfg.mix_fit`` selects the
    Figueiredo-Jain mixture or the AutoRJ single Normal.  Returns
    (Proposal trimmed to the largest live mixture, telemetry dict; the
    AutoRJ fit has no telemetry).  Under a ``mesh`` ``samples`` is this
    rank's block of the sample axis (module note) and every rank gets
    the same proposal."""
    K, _, D = samples.shape
    dev, dtype = samples.device, samples.dtype
    dims = torch.as_tensor(modelset.dims, device=dev)
    lmax = cfg.max_mix_comps
    if cfg.mix_fit == "autorj":
        # a small input: gathered, then fitted alike on every rank
        means, Bs = fit_autorj(mesh_lib.all_gather(samples, mesh, dim=1),
                               dims)
        lam = torch.zeros((K, lmax), dtype=dtype, device=dev)
        lam[:, 0] = 1.0
        mu = torch.zeros((K, lmax, D), dtype=dtype, device=dev)
        mu[:, 0] = means
        B = torch.eye(D, dtype=dtype, device=dev).repeat(K, lmax, 1, 1)
        B[:, 0] = Bs
        nmix = torch.ones((K,), dtype=torch.int32, device=dev)
        telemetry = {}
    else:
        out = fit_figueiredo(samples, dims, lmax, cfg.max_em_iters,
                             generator=generator, seed_idx=seed_idx,
                             mesh=mesh)
        lam, mu, B, nmix = out["lam"], out["mu"], out["B"], out["nmix"]
        telemetry = {"em_iters": out["iters"], "em_trace": out["tele"]}
    logdetB = linalg.log_det_tri(B, dims[:, None])
    proposal = Proposal(lam=lam, mu=mu, B=B, logdetB=logdetB, nmix=nmix,
                        sig=sig)
    return trim_proposal(proposal), telemetry


def trim_proposal(proposal: Proposal) -> Proposal:
    """Compact each model's live slots to the front and cut the slot axis
    to the largest fitted mixture size."""
    K, L = proposal.lam.shape
    D = proposal.mu.shape[2]
    l_active = max(1, min(L, int(proposal.nmix.max())))
    dead = proposal.lam <= 0
    order = torch.argsort(dead.to(torch.int8), dim=1, stable=True)
    take = order[:, :l_active]
    alive = torch.gather(~dead, 1, take)

    def compact(x, fill):
        tail = x.shape[2:]
        idx = take.reshape(K, l_active, *([1] * len(tail))).expand(
            K, l_active, *tail)
        kept = torch.gather(x, 1, idx)
        a = alive.reshape(K, l_active, *([1] * len(tail)))
        return torch.where(a, kept, fill)

    eye = torch.eye(D, dtype=proposal.B.dtype, device=proposal.B.device)
    return Proposal(lam=compact(proposal.lam, 0.0),
                    mu=compact(proposal.mu, 0.0),
                    B=compact(proposal.B, eye),
                    logdetB=compact(proposal.logdetB, 0.0),
                    nmix=proposal.nmix, sig=proposal.sig)
