"""Stage 1: pooled adaptive RWM for the whole model family, in segments.

Counterpart of ``automix_tpu/kernels/fused_stage1.py`` (``_schedule``,
``run_fused_stage1`` and the segment kernel of ``_segment_call``).  The
K*C chains (C per model, lane i in model i // C) run ~100-sweep segments;
each segment is one launch of the CUDA kernel ``csrc/fused_stage1.cu`` on
the card, or of its plain twin :func:`segment_ref` on the CPU.  Telemetry
and the thinned-tail stage-2 snapshots are read at segment boundaries on
the host.

Randomness is the counter hash of (seed_eff, 1-based global sweep, chain,
slot) with ``seed_eff = (seed * 1000003 + 777) & 0x7FFFFFFF``, so the
port's words equal the JAX kernel's and any segmentation gives the same
trajectories.  State layouts: theta [D, K*C]; sig, nacc, ntry [K, D]
(every chain of a model shares its row).
"""

from __future__ import annotations

import torch

from automix_tpu_torch.config import (EngineConfig, LOG_ACCEPT_CLAMP,
                                      RWM_TARGET_ACCEPT)
from automix_tpu_torch.kernels import _build
from automix_tpu_torch.ops import randoms

_SEG_DEFAULT = 100
_TWO_PI = 6.283185307179586
# The kernel's shared-memory budget: theta and logp of every chain.
_MAX_SMEM = 227 * 1024


def schedule(cfg: EngineConfig, nsweeps: int, C: int, D: int):
    """Static segment schedule: (total, nburn, seg, n_seg, snap_segs)."""
    nburn = nsweeps // 10
    total = nsweeps + nburn
    target = cfg.stage1_target_samples or 1000 * D
    n_tail = -(-target // C)
    n_tail = max(1, min(n_tail, max(1, (total - nburn) // 2)))

    seg = _SEG_DEFAULT
    # enough whole segments in the back half for n_tail snapshots
    while seg > 1 and (total // seg) // 2 < n_tail:
        seg = max(1, seg // 2)
    n_seg = -(-total // seg)
    back = n_seg - max(nburn // seg + 1, n_seg // 2)
    back = max(back, n_tail)
    ssep = max(1, back // n_tail)
    snap_segs = tuple(sorted(n_seg - 1 - i * ssep for i in range(n_tail)))
    if snap_segs[0] < 0:
        raise ValueError("stage-1 schedule has a snapshot before sweep 0")
    return total, nburn, seg, n_seg, snap_segs


def _accept(delta):
    return torch.exp(torch.clamp(delta, LOG_ACCEPT_CLAMP, 0.0))


def _gain(t: int, device):
    """gamma_t = exp(-2/3 * log(t + 1)) in float32 on ``device``."""
    tf = torch.tensor(float(t), dtype=torch.float32, device=device)
    return torch.exp((-2.0 / 3.0) * torch.log(tf + 1.0))


def segment_ref(modelset, theta, sig, nacc, ntry, *, C: int, sweep0: int,
                seed: int, nburn: int, n_active: int):
    """Plain PyTorch twin of the segment kernel: ``n_active`` sweeps
    (global sweeps sweep0+1 ... sweep0+n_active).  Returns
    (theta [D, N], sig [K, D], nacc [K, D], ntry [K, D], logp [N])."""
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    lane = torch.arange(N, device=dev)
    model_of = lane // C
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    coord_active = torch.arange(D, device=dev)[None, :] < dims[:, None]
    active = [(dims[model_of] > d).to(torch.float32) for d in range(D)]
    th = [theta[d].clone() for d in range(D)]
    lp = modelset.logpost_cols(model_of, th)
    sig, nacc, ntry = sig.clone(), nacc.clone(), ntry.clone()
    for tr in range(n_active):
        t = sweep0 + tr + 1
        w = randoms.sweep_words(seed, t, lane, range(3 * D))
        u = [randoms.u01(w[j]) for j in range(D)]
        z = [torch.sqrt(-2.0 * torch.log1p(-randoms.u01(w[D + j])))
             * torch.cos(_TWO_PI * randoms.u01(w[2 * D + j]))
             for j in range(D)]
        sig_l = sig[model_of]                               # [N, D]
        if t > nburn and randoms.block_coin(seed, t):
            prop = [th[d] + sig_l[:, d] * z[d] for d in range(D)]
            lpn = modelset.logpost_cols(model_of, prop)
            acc = (u[0] < _accept(lpn - lp)).to(torch.float32)
            th = [th[d] + acc * (prop[d] - th[d]) for d in range(D)]
            lp = lp + acc * (lpn - lp)
            continue
        cnt = torch.zeros((K, D), dtype=torch.int64, device=dev)
        for j in range(D):
            prop = list(th)
            prop[j] = th[j] + sig_l[:, j] * z[j]
            lpn = modelset.logpost_cols(model_of, prop)
            acc = (u[j] < _accept(lpn - lp)).to(torch.float32) * active[j]
            th[j] = th[j] + acc * (prop[j] - th[j])
            lp = lp + acc * (lpn - lp)
            cnt[:, j].index_add_(0, model_of, acc.to(torch.int64))
        # one pooled update per sweep from the sweep-start sig
        err = cnt.to(torch.float32) * (1.0 / C) - RWM_TARGET_ACCEPT
        new_sig = torch.clamp(sig + (10.0 * _gain(t, dev)) * err, min=0.0)
        sig = torch.where(coord_active, new_sig, sig)
        nacc = nacc + torch.where(coord_active, cnt, 0).to(nacc.dtype)
        ntry = ntry + (coord_active * C).to(ntry.dtype)
    return torch.stack(th), sig, nacc, ntry, lp


def segment(modelset, theta, sig, nacc, ntry, *, C: int, sweep0: int,
            seed: int, nburn: int, n_active: int):
    """One stage-1 segment: the CUDA kernel for tensors on the card, its
    plain twin for tensors on the CPU.  Same arguments and results as
    :func:`segment_ref`."""
    if theta.device.type == "cpu":
        return segment_ref(modelset, theta, sig, nacc, ntry, C=C,
                           sweep0=sweep0, seed=seed, nburn=nburn,
                           n_active=n_active)
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"segment: unsupported device {dev}")
    if (K, D) != (3, 2):
        raise ValueError(f"segment: kernel instantiated for K=3, D=2 only "
                         f"(got K={K}, D={D})")
    if N != K * C or (D + 1) * N * 4 > _MAX_SMEM:
        raise ValueError(f"segment: {N} chains do not fit one block")
    for name, x, dtype, shape in (("theta", theta, torch.float32, (D, N)),
                                  ("sig", sig, torch.float32, (K, D)),
                                  ("nacc", nacc, torch.int32, (K, D)),
                                  ("ntry", ntry, torch.int32, (K, D))):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"segment: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}")
    kinds, consts, dims = modelset.density_table(dev)
    th_o = torch.empty_like(theta)
    sig_o = torch.empty_like(sig)
    nacc_o = torch.empty_like(nacc)
    ntry_o = torch.empty_like(ntry)
    lp_o = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _build.library()
    status = lib.am_fused_stage1(
        K, D, N, C, sweep0, seed, nburn, n_active,
        kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        theta.data_ptr(), sig.data_ptr(), nacc.data_ptr(), ntry.data_ptr(),
        th_o.data_ptr(), sig_o.data_ptr(), nacc_o.data_ptr(),
        ntry_o.data_ptr(), lp_o.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "am_fused_stage1")
    segment.launches += 1
    return th_o, sig_o, nacc_o, ntry_o, lp_o


segment.launches = 0


def run_fused_stage1(modelset, cfg: EngineConfig, nsweeps: int, C: int,
                     init_theta, device):
    """Stage 1 for all models at once.  Returns (sig [K, D], samples
    [K, C*n_tail, D], tele_sig [n_seg, K, D], tele_acc [n_seg, K, D],
    logp [K, C]) in the JAX package's layouts; sig is 10 on coordinates a
    model lacks.  ``init_theta`` is the [K, D] start point."""
    K, D = modelset.nmodels, modelset.dmax
    N = K * C
    total, nburn, seg, n_seg, snap_segs = schedule(cfg, nsweeps, C, D)
    model_of = torch.arange(N) // C
    theta = init_theta.to(torch.float32)[model_of].T.contiguous().to(device)
    dims = torch.as_tensor(modelset.dims).long()
    coord_active = torch.arange(D)[None, :] < dims[:, None]     # [K, D]
    sig = (10.0 * coord_active.to(torch.float32)).to(device)
    nacc = torch.zeros((K, D), dtype=torch.int32, device=device)
    ntry = torch.zeros((K, D), dtype=torch.int32, device=device)
    seed_eff = (int(cfg.seed) * 1000003 + 777) & 0x7FFFFFFF

    snaps, tele = [], []
    done = 0
    lp = None
    for s in range(n_seg):
        n = min(seg, total - done)
        theta, sig, nacc, ntry, lp = segment(
            modelset, theta, sig, nacc, ntry, C=C, sweep0=done,
            seed=seed_eff, nburn=nburn, n_active=n)
        done += n
        tele.append((sig, nacc, ntry))
        if s in snap_segs:
            snaps.append(theta)
    if done != total:
        raise RuntimeError("stage-1 segments do not cover the schedule")

    tele_sig = torch.stack([t[0] for t in tele]).cpu()
    tele_nacc = torch.stack([t[1] for t in tele]).cpu().to(torch.float32)
    tele_ntry = torch.stack([t[2] for t in tele]).cpu().to(torch.float32)
    tele_sig = torch.where(coord_active, tele_sig, 10.0)
    tele_acc = tele_nacc / torch.clamp(tele_ntry, min=1.0)
    smp = torch.stack(snaps)                                # [T, D, N]
    T = smp.shape[0]
    samples = smp.reshape(T, D, K, C).permute(2, 3, 0, 1).reshape(
        K, C * T, D).contiguous()
    return tele_sig[-1].to(device), samples, tele_sig, tele_acc, \
        lp.reshape(K, C)

