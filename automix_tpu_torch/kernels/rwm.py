"""Stage 1: adaptive within-model RWM for every model at once.

Counterpart of ``automix_tpu/kernels/rwm.py``: ``run_stage1`` routes the
run to the kernels of ``fused_stage1`` or to the general engine's scan
(``_build_stage1_core`` of the JAX package), by
``fused_stage1.stage1_eligible``.

On the kernels, the K*C chains (C per model) run the pooled-adaptation
segments of ``fused_stage1``: one segment kernel per segment when the
card holds the population resident for its cooperative launch, else the
one-sweep kernel per sweep (``fused_stage1.stage1_runner``).

The general engine (:func:`run_general_stage1`) runs the same schedule as
a plain torch loop over sweeps on the chains' device, for any model set:
pooled integer acceptance counts per (model, coordinate), the AAP or log
rule, after burn-in a batch-wide block move on 10% of sweeps, telemetry
every 100 sweeps and ``n_tail`` thinned snapshots of every chain, laid
out chain-major.  Its words are JAX's threefry words, as JAX's scan draws
them: the stage-1 key split into three (the next key, the start points'
key, the chains' key), one key per chain split from the third, folded
with the sweep and then 0 for the uniforms and 1 for the perturbations
(t(dof) for a Student-t run), and the block-move coin from the first key
folded with 7 and then the sweep.

Across devices (``mesh=``, ``parallel/mesh.py``) the chain axis splits per
model, as JAX's [K, C] key layout does: each rank runs C / size chains of
every model, the same global chains (keys and hash words) as in a run on
one device.  The pooled acceptance counts are summed across the ranks as
integers once a sweep, so sig, the telemetry and every chain's
trajectory are the unsharded run's bit for bit; the kernels take their
one-sweep route (K3 moves only, then the rule), as JAX's
``run_fused_stage1_sharded`` does.  The samples and final logp come back
as this rank's chains' blocks.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from automix_tpu_torch.config import EngineConfig, RWM_TARGET_ACCEPT
from automix_tpu_torch.kernels import fused_stage1, rjmcmc
from automix_tpu_torch.kernels.fused_stage1 import _accept
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.parallel import mesh as mesh_lib

TELEMETRY_EVERY = 100


def run_general_stage1(modelset, cfg: EngineConfig, nsweeps: int, C: int,
                       init_theta, device, key, k_chains, n_tail: int = 1,
                       mesh=None):
    """The general engine's stage 1 over K*C chains on ``device``: the
    block coin from ``fold_in(key, 7)``, the chains' keys split from
    ``k_chains`` (both threefry keys; :func:`run_stage1` splits them from
    the stage-1 key).  Returns (sig [K, D], samples [K, C * n_tail, D],
    tele_sig and tele_acc [n_tele, K, D] on the CPU, final logp [K, C]).
    Under a ``mesh`` this rank runs its C / size chains of each model and
    returns their samples and logp; the counts are summed every sweep."""
    K, D = modelset.nmodels, modelset.dmax
    C_total = C
    if mesh is not None:
        C = mesh.local(C_total, "chains per model")
    M = K * C
    f32 = torch.float32
    nburn = nsweeps // 10
    total = nsweeps + nburn
    n_tail = max(1, min(n_tail, max(1, (total - nburn) // 2)))
    stride = max(1, (total - max(nburn, total // 2)) // n_tail)
    smp_start = total - n_tail * stride
    n_tele = max(1, total // TELEMETRY_EVERY)
    block_key = randoms.fold_in(key, 7)
    chain_keys = randoms.split(k_chains, K * C_total, device)
    if mesh is not None:
        off = mesh.rank * C
        chain_keys = chain_keys.reshape(K, C_total, 2)[:, off:off + C] \
            .reshape(M, 2)
    coin = np.float32(0.1)
    # the models a componentwise move on coordinate j changes
    above = [[m for m in range(K) if modelset.dims[m] > j] for j in range(D)]

    dims = torch.as_tensor(np.asarray(modelset.dims), device=device).long()
    coord_active = torch.arange(D, device=device)[None, :] < dims[:, None]
    active_f = coord_active.to(f32)
    k_assign = torch.arange(K, device=device).repeat_interleave(C)
    dims_assign = dims[k_assign]
    mask = active_f[k_assign]
    theta = init_theta.to(f32).to(device)[k_assign]
    lp = modelset.logpost_batch(k_assign, theta)
    sig = torch.full((K, D), 10.0, dtype=f32, device=device)  # automix.c:595
    nacc = torch.zeros((K, D), dtype=torch.int32, device=device)
    ntry = torch.zeros((K, D), dtype=torch.int32, device=device)
    try_inc = coord_active.to(torch.int32) * C_total
    tele_sig = torch.zeros((n_tele, K, D), dtype=f32, device=device)
    tele_acc = torch.zeros((n_tele, K, D), dtype=f32, device=device)
    smp = torch.zeros((n_tail, M, D), dtype=f32, device=device)

    for sweep in range(1, total + 1):
        u, z = rjmcmc.draw_sweep_randoms(chain_keys, sweep, D, D,
                                         cfg.student_t_dof)
        if sweep > nburn and randoms.uniform_host(
                randoms.fold_in(block_key, sweep)) < coin:
            # a full-vector non-adapting move (automix.c:606-617)
            theta_prop = theta + sig[k_assign] * z * mask
            lpn = modelset.logpost_batch(k_assign, theta_prop)
            acc = u[:, 0] < _accept(lpn - lp)
            theta = torch.where(acc[:, None], theta_prop, theta)
            lp = torch.where(acc, lpn, lp)
        else:
            # componentwise with the sweep-start sig (automix.c:618-640)
            gamma = rjmcmc.gamma_f32(sweep)
            sig_sel = sig[k_assign]
            cols = []
            for j in range(D):
                theta_prop = theta.clone()
                theta_prop[:, j] = theta[:, j] + sig_sel[:, j] * z[:, j]
                lpn = modelset.logpost_batch(k_assign, theta_prop, above[j])
                acc = (u[:, j] < _accept(lpn - lp)) & (j < dims_assign)
                theta = torch.where(acc[:, None], theta_prop, theta)
                lp = torch.where(acc, lpn, lp)
                cols.append(acc.to(torch.int32).reshape(K, C).sum(dim=1))
            acc_cols = mesh_lib.all_reduce_sum(
                torch.stack(cols, dim=1).to(torch.int32), mesh)
            err = (acc_cols.to(f32) / C_total - RWM_TARGET_ACCEPT) \
                * active_f
            if cfg.stage1_adapt == "log":
                gain = float(np.float32(cfg.stage1_log_gain)
                             * np.float32(gamma))
                sig = sig * torch.exp(gain * err)
            else:
                gain = float(np.float32(10.0) * np.float32(gamma))
                sig = torch.clamp(sig + gain * err, min=0.0)
            nacc = nacc + acc_cols
            ntry = ntry + try_inc
        if sweep % TELEMETRY_EVERY == 0:
            t_idx = min(sweep // TELEMETRY_EVERY, n_tele - 1)
            tele_sig[t_idx] = sig
            tele_acc[t_idx] = nacc.to(f32) / torch.clamp(ntry.to(f32),
                                                          min=1.0)
        if sweep > smp_start and (sweep - smp_start) % stride == 0:
            s_idx = min(max((sweep - smp_start) // stride - 1, 0),
                        n_tail - 1)
            smp[s_idx] = theta
    samples = smp.reshape(n_tail, K, C, D).permute(1, 2, 0, 3) \
        .reshape(K, C * n_tail, D)
    return sig, samples, tele_sig.cpu(), tele_acc.cpu(), lp.reshape(K, C)


def run_stage1(modelset, cfg: EngineConfig, key, nsweeps: int, device,
               n_chains_per_model: int | None = None, mesh=None):
    """Returns ``(sig [K, D], samples [K, C * n_tail, D], telemetry)``; the
    telemetry holds the sig and pooled acceptance traces (at segment
    boundaries on the kernels, every 100 sweeps on the general engine),
    the final logp [K, C] and the sweep count.  ``key`` is the stage-1
    threefry key: split into three as in JAX, the second gives the start
    points.  Logs the engine and why.  Under a ``mesh`` (on its device)
    the chains split across its ranks (module note): the samples and the
    final logp are this rank's blocks, the rest is the same on every
    rank."""
    C = n_chains_per_model or cfg.n_chains_stage1
    key, k_init, k_chains = randoms.split_host(key, 3)
    init_theta = modelset.init_points(k_init)                # [K, D]
    kernels, why = fused_stage1.stage1_eligible(modelset, cfg, mesh, C)
    logging.getLogger("automix_tpu_torch").info(
        "stage 1: %s engine (%s)", "kernel" if kernels else "general", why)
    if kernels and mesh is not None:
        sig, samples, tele_sig, tele_acc, lp = \
            fused_stage1.run_fused_stage1_sweeps(
                modelset, cfg, nsweeps, C, init_theta, device, mesh=mesh)
    elif kernels:
        run = fused_stage1.stage1_runner(modelset, cfg, C, device)
        sig, samples, tele_sig, tele_acc, lp = run(
            modelset, cfg, nsweeps, C, init_theta, device)
    else:
        target = cfg.stage1_target_samples or 1000 * modelset.dmax
        sig, samples, tele_sig, tele_acc, lp = run_general_stage1(
            modelset, cfg, nsweeps, C, init_theta, device, key, k_chains,
            n_tail=-(-target // C), mesh=mesh)
    return sig, samples, {
        "sig_trace": tele_sig,
        "accept_trace": tele_acc,
        "final_logp": lp,
        "nsweeps": nsweeps + nsweeps // 10,
    }
