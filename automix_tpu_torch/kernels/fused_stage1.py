"""Stage 1: pooled adaptive RWM for the whole model family.

Counterpart of ``automix_tpu/kernels/fused_stage1.py`` (``_schedule``,
``run_fused_stage1`` with the segment kernel of ``_segment_call``, and
``run_fused_stage1_sharded`` with the one-sweep kernel of ``_sweep_call``).
The K*C chains (C per model, lane i in model i // C) run ~100-sweep
segments.  Telemetry and the thinned-tail stage-2 snapshots are read at
segment boundaries on the host.

Two runners, one result.  Routing rule (:func:`fits_one_block`): when the
segment kernel's one CUDA block can hold theta and logp of every chain
beside its static shared arrays, (D + 1) * K * C * 4 bytes plus
:func:`static_smem_bound` within ``_MAX_SMEM``, stage 1 runs
:func:`run_fused_stage1`: one launch of ``csrc/fused_stage1.cu`` (K2) per
segment, the pooled update inside the kernel.  Otherwise it runs
:func:`run_fused_stage1_sweeps`: one launch of ``csrc/fused_stage1_sweep.cu``
(K3) per sweep over as many blocks as the population needs, and the pooled
update between launches.  The rule is the same on the CPU, where both
kernels are their plain twins (:func:`segment_ref`, :func:`sweep_ref`);
there the two runners give bitwise the same sig, samples and logp.

Randomness is the counter hash of (seed_eff, 1-based global sweep, chain,
slot) with ``seed_eff = (seed * 1000003 + 777) & 0x7FFFFFFF``, so the
port's words equal the JAX kernels' and any segmentation gives the same
trajectories.  Perturbations are Box-Muller normals, or with
``student_t_dof > 0`` Bailey polar t variates from the same two words.
State layouts: theta [D, K*C]; sig, nacc, ntry [K, D] (every chain of a
model shares its row).
"""

from __future__ import annotations

import torch

from automix_tpu_torch.config import (EngineConfig, LOG_ACCEPT_CLAMP,
                                      RWM_TARGET_ACCEPT)
from automix_tpu_torch.kernels import _build
from automix_tpu_torch.model import N_DENSITY_CONSTS
from automix_tpu_torch.ops import randoms

_SEG_DEFAULT = 100
# Shared memory one block may opt in to on the H100 (sm_90): 227 KiB.
_MAX_SMEM = 227 * 1024


def static_smem_bound(K: int, D: int) -> int:
    """Bytes of the segment kernel's static shared arrays, an upper bound:
    sig, nacc, ntry, cnt [K*D], consts [K*N_DENSITY_CONSTS], kinds and
    dims [K], 4 bytes each, and 16 bytes of alignment for each of the 7
    arrays.  The card test holds it against the kernel's own count
    (``am_fused_stage1_smem``)."""
    return 4 * (4 * K * D + K * N_DENSITY_CONSTS + 2 * K) + 16 * 7


def fits_one_block(K: int, D: int, C: int) -> bool:
    """True when the segment kernel's one block holds all K*C chains:
    theta and logp of each, (D + 1) * 4 bytes, beside the static arrays."""
    return (D + 1) * K * C * 4 + static_smem_bound(K, D) <= _MAX_SMEM


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
    tf = torch.full((), float(t), dtype=torch.float32, device=device)
    return torch.exp((-2.0 / 3.0) * torch.log(tf + 1.0))


def _perturbations(w, D: int, tdist):
    """The D proposal perturbations of a sweep from its 3D words: Box-
    Muller normals (cos half) or Bailey t variates of words D+j, 2D+j."""
    u1 = [randoms.u01(w[D + j]) for j in range(D)]
    u2 = [randoms.u01(w[2 * D + j]) for j in range(D)]
    if tdist is not None:
        return [randoms.bailey_t(u1[j], u2[j], tdist) for j in range(D)]
    return [randoms.box_muller(u1[j], u2[j])[0] for j in range(D)]


def _moves(modelset, th, lp, sig_l, model_of, active, u, z, block: bool):
    """One sweep's within-model moves of every lane from (th, lp): the
    block move, or D componentwise moves.  Returns (th, lp, per-coordinate
    accept indicators as float32 lists, empty for a block move)."""
    D = len(th)
    if block:
        prop = [th[d] + sig_l[:, d] * z[d] for d in range(D)]
        lpn = modelset.logpost_cols(model_of, prop)
        acc = (u[0] < _accept(lpn - lp)).to(torch.float32)
        th = [th[d] + acc * (prop[d] - th[d]) for d in range(D)]
        return th, lp + acc * (lpn - lp), []
    th = list(th)
    accs = []
    for j in range(D):
        prop = list(th)
        prop[j] = th[j] + sig_l[:, j] * z[j]
        lpn = modelset.logpost_cols(model_of, prop)
        acc = (u[j] < _accept(lpn - lp)).to(torch.float32) * active[j]
        th[j] = th[j] + acc * (prop[j] - th[j])
        lp = lp + acc * (lpn - lp)
        accs.append(acc)
    return th, lp, accs


def _lane_layout(modelset, N: int, C: int, dev):
    lane = torch.arange(N, device=dev)
    model_of = lane // C
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    active = [(dims[model_of] > d).to(torch.float32)
              for d in range(modelset.dmax)]
    return lane, model_of, active


def segment_ref(modelset, theta, sig, nacc, ntry, *, C: int, sweep0: int,
                seed: int, nburn: int, n_active: int, tdist=None):
    """Plain PyTorch twin of the segment kernel: ``n_active`` sweeps
    (global sweeps sweep0+1 ... sweep0+n_active).  ``tdist`` is a
    ``randoms.StudentT`` for t perturbations, None for normals.  Returns
    (theta [D, N], sig [K, D], nacc [K, D], ntry [K, D], logp [N])."""
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    lane, model_of, active = _lane_layout(modelset, N, C, dev)
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    coord_active = torch.arange(D, device=dev)[None, :] < dims[:, None]
    th = [theta[d].clone() for d in range(D)]
    lp = modelset.logpost_cols(model_of, th)
    sig, nacc, ntry = sig.clone(), nacc.clone(), ntry.clone()
    for tr in range(n_active):
        t = sweep0 + tr + 1
        w = randoms.sweep_words(seed, t, lane, range(3 * D))
        u = [randoms.u01(w[j]) for j in range(D)]
        z = _perturbations(w, D, tdist)
        block = t > nburn and randoms.block_coin(seed, t)
        th, lp, accs = _moves(modelset, th, lp, sig[model_of], model_of,
                              active, u, z, block)
        if block:
            continue
        cnt = torch.zeros((K, D), dtype=torch.int64, device=dev)
        for j in range(D):
            cnt[:, j].index_add_(0, model_of, accs[j].to(torch.int64))
        # one pooled update per sweep from the sweep-start sig
        err = cnt.to(torch.float32) * (1.0 / C) - RWM_TARGET_ACCEPT
        new_sig = torch.clamp(sig + (10.0 * _gain(t, dev)) * err, min=0.0)
        sig = torch.where(coord_active, new_sig, sig)
        nacc = nacc + torch.where(coord_active, cnt, 0).to(nacc.dtype)
        ntry = ntry + (coord_active * C).to(ntry.dtype)
    return torch.stack(th), sig, nacc, ntry, lp


def _check(name, x, dev, dtype, shape, fn):
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {dev}")


def segment(modelset, theta, sig, nacc, ntry, *, C: int, sweep0: int,
            seed: int, nburn: int, n_active: int, tdist=None):
    """One stage-1 segment: the CUDA kernel for tensors on the card, its
    plain twin for tensors on the CPU.  Same arguments and results as
    :func:`segment_ref`."""
    if theta.device.type == "cpu":
        return segment_ref(modelset, theta, sig, nacc, ntry, C=C,
                           sweep0=sweep0, seed=seed, nburn=nburn,
                           n_active=n_active, tdist=tdist)
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"segment: unsupported device {dev}")
    _build.check_shape(K, D, "segment")
    if N != K * C or not fits_one_block(K, D, C):
        raise ValueError(f"segment: {N} chains do not fit one block")
    for name, x, dtype, shape in (("theta", theta, torch.float32, (D, N)),
                                  ("sig", sig, torch.float32, (K, D)),
                                  ("nacc", nacc, torch.int32, (K, D)),
                                  ("ntry", ntry, torch.int32, (K, D))):
        _check(name, x, dev, dtype, shape, "segment")
    kinds, consts, dims = modelset.density_table(dev)
    th_o = torch.empty_like(theta)
    sig_o = torch.empty_like(sig)
    nacc_o = torch.empty_like(nacc)
    ntry_o = torch.empty_like(ntry)
    lp_o = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _build.library()
    status = lib.am_fused_stage1(
        K, D, N, C, sweep0, seed, nburn, n_active, _build.tconsts(tdist),
        kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        theta.data_ptr(), sig.data_ptr(), nacc.data_ptr(), ntry.data_ptr(),
        th_o.data_ptr(), sig_o.data_ptr(), nacc_o.data_ptr(),
        ntry_o.data_ptr(), lp_o.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "am_fused_stage1")
    segment.launches += 1
    return th_o, sig_o, nacc_o, ntry_o, lp_o


segment.launches = 0


def sweep_ref(modelset, theta, logp, sig, *, C: int, t: int, seed: int,
              nburn: int, seg_start: bool, tdist=None):
    """Plain PyTorch twin of the one-sweep kernel: global sweep ``t`` of
    every lane, moves only.  logp is recomputed from theta when
    ``seg_start``.  Returns (theta [D, N], logp [N], accept counts
    [K, D] int32 of the componentwise moves, zero on a block sweep)."""
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    lane, model_of, active = _lane_layout(modelset, N, C, dev)
    th = [theta[d] for d in range(D)]
    lp = modelset.logpost_cols(model_of, th) if seg_start else logp
    w = randoms.sweep_words(seed, t, lane, range(3 * D))
    u = [randoms.u01(w[j]) for j in range(D)]
    z = _perturbations(w, D, tdist)
    block = t > nburn and randoms.block_coin(seed, t)
    th, lp, accs = _moves(modelset, th, lp, sig[model_of], model_of, active,
                          u, z, block)
    cnt = torch.zeros((K, D), dtype=torch.int32, device=dev)
    for j, acc in enumerate(accs):
        cnt[:, j].index_add_(0, model_of, acc.to(torch.int32))
    return torch.stack(th), lp, cnt


def sweep(modelset, theta, logp, sig, *, C: int, t: int, seed: int,
          nburn: int, seg_start: bool, tdist=None):
    """One stage-1 sweep: the CUDA kernel for tensors on the card, its
    plain twin for tensors on the CPU.  Same arguments and results as
    :func:`sweep_ref`."""
    if theta.device.type == "cpu":
        return sweep_ref(modelset, theta, logp, sig, C=C, t=t, seed=seed,
                         nburn=nburn, seg_start=seg_start, tdist=tdist)
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"sweep: unsupported device {dev}")
    _build.check_shape(K, D, "sweep")
    if N != K * C:
        raise ValueError(f"sweep: {N} chains are not {K} x {C}")
    for name, x, dtype, shape in (("theta", theta, torch.float32, (D, N)),
                                  ("logp", logp, torch.float32, (N,)),
                                  ("sig", sig, torch.float32, (K, D))):
        _check(name, x, dev, dtype, shape, "sweep")
    kinds, consts, dims = modelset.density_table(dev)
    th_o = torch.empty_like(theta)
    lp_o = torch.empty_like(logp)
    cnt = torch.zeros((K, D), dtype=torch.int32, device=dev)
    lib = _build.library()
    status = lib.am_fused_stage1_sweep(
        K, D, N, C, t, seed, nburn, int(seg_start), _build.tconsts(tdist),
        kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        theta.data_ptr(), logp.data_ptr(), sig.data_ptr(), th_o.data_ptr(),
        lp_o.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "am_fused_stage1_sweep")
    sweep.launches += 1
    return th_o, lp_o, cnt


sweep.launches = 0


def _start(modelset, cfg, nsweeps, C, init_theta, device):
    """Shared start of both runners: schedule, theta at the start points,
    sig 10 on each model's coordinates, zero counts, the stage-1 seed."""
    K, D = modelset.nmodels, modelset.dmax
    N = K * C
    model_of = torch.arange(N) // C
    theta = init_theta.to(torch.float32)[model_of].T.contiguous().to(device)
    dims = torch.as_tensor(modelset.dims).long()
    coord_active = torch.arange(D)[None, :] < dims[:, None]     # [K, D]
    sig = (10.0 * coord_active.to(torch.float32)).to(device)
    nacc = torch.zeros((K, D), dtype=torch.int32, device=device)
    ntry = torch.zeros((K, D), dtype=torch.int32, device=device)
    seed_eff = (int(cfg.seed) * 1000003 + 777) & 0x7FFFFFFF
    tdist = (randoms.student_t(cfg.student_t_dof)
             if cfg.student_t_dof > 0 else None)
    return (schedule(cfg, nsweeps, C, D), coord_active, theta, sig, nacc,
            ntry, seed_eff, tdist)


def _finish(modelset, C, coord_active, tele, snaps, lp, device):
    """(sig, samples, tele_sig, tele_acc, logp) in the JAX layouts from
    the segment-boundary telemetry and snapshots."""
    K, D = modelset.nmodels, modelset.dmax
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


def run_fused_stage1(modelset, cfg: EngineConfig, nsweeps: int, C: int,
                     init_theta, device):
    """Stage 1 for all models at once, one segment kernel per segment.
    Returns (sig [K, D], samples [K, C*n_tail, D], tele_sig [n_seg, K, D],
    tele_acc [n_seg, K, D], logp [K, C]) in the JAX package's layouts; sig
    is 10 on coordinates a model lacks.  ``init_theta`` is the [K, D]
    start point."""
    ((total, nburn, seg, n_seg, snap_segs), coord_active, theta, sig, nacc,
     ntry, seed_eff, tdist) = _start(modelset, cfg, nsweeps, C, init_theta,
                                     device)
    snaps, tele = [], []
    done = 0
    lp = None
    for s in range(n_seg):
        n = min(seg, total - done)
        theta, sig, nacc, ntry, lp = segment(
            modelset, theta, sig, nacc, ntry, C=C, sweep0=done,
            seed=seed_eff, nburn=nburn, n_active=n, tdist=tdist)
        done += n
        tele.append((sig, nacc, ntry))
        if s in snap_segs:
            snaps.append(theta)
    if done != total:
        raise RuntimeError("stage-1 segments do not cover the schedule")
    return _finish(modelset, C, coord_active, tele, snaps, lp, device)


def run_fused_stage1_sweeps(modelset, cfg: EngineConfig, nsweeps: int,
                            C: int, init_theta, device):
    """Stage 1 for a population one block cannot hold: the one-device
    form of the JAX ``run_fused_stage1_sharded``.  Each sweep is one
    launch of the one-sweep kernel, then the pooled AAP update of sig,
    nacc and ntry from its exact integer accept counts, in the JAX
    order, blends included.  Same schedule, arguments and results as
    :func:`run_fused_stage1`, and bitwise the same values in the twins."""
    ((total, nburn, seg, n_seg, snap_segs), coord_active, theta, sig, nacc,
     ntry, seed_eff, tdist) = _start(modelset, cfg, nsweeps, C, init_theta,
                                     device)
    ca = coord_active.to(torch.float32).to(device)
    ca_c = (coord_active * C).to(torch.int32).to(device)
    lp = torch.zeros((theta.shape[1],), dtype=torch.float32, device=device)
    snaps, tele = [], []
    done = 0
    for s in range(n_seg):
        n = min(seg, total - done)
        for i in range(n):
            t = done + i + 1                             # 1-based global
            theta, lp, cnt = sweep(modelset, theta, lp, sig, C=C, t=t,
                                   seed=seed_eff, nburn=nburn,
                                   seg_start=i == 0, tdist=tdist)
            # block-move sweeps do not adapt (the kernel's own coin)
            adapt = not (t > nburn and randoms.block_coin(seed_eff, t))
            err = (cnt.to(torch.float32) * (1.0 / C)
                   - RWM_TARGET_ACCEPT) * ca
            sig_new = torch.clamp(sig + (10.0 * _gain(t, device)) * err,
                                  min=0.0)
            sig = sig + float(adapt) * (sig_new - sig)
            nacc = nacc + int(adapt) * cnt
            ntry = ntry + int(adapt) * ca_c
        done += n
        tele.append((sig, nacc, ntry))
        if s in snap_segs:
            snaps.append(theta)
    if done != total:
        raise RuntimeError("stage-1 segments do not cover the schedule")
    return _finish(modelset, C, coord_active, tele, snaps, lp, device)
