"""Stage 1: pooled adaptive RWM for the whole model family.

Counterpart of ``automix_tpu/kernels/fused_stage1.py`` (``_schedule``,
``run_fused_stage1`` with the segment kernel of ``_segment_call``, and
``run_fused_stage1_sharded`` with the one-sweep kernel of ``_sweep_call``).
The K*C chains (C per model, lane i in model i // C) run ~100-sweep
segments.  Telemetry and the thinned-tail stage-2 snapshots are read at
segment boundaries on the host.

Two runners, one result.  Routing rule (:func:`runs_segment_kernel`):
when the card holds every chain resident at once for the segment
kernel's cooperative launch (:func:`segment_capacity`, one thread per
chain), stage 1 runs :func:`run_fused_stage1`: one launch of
``csrc/fused_stage1.cu`` (K2) per segment, the pooled update inside the
kernel across a grid barrier per sweep.  A larger population runs
:func:`run_fused_stage1_sweeps`: one launch of
``csrc/fused_stage1_sweep.cu`` (K3) per sweep, the pooled update inside
the launch (its last block applies it).  On the CPU, where both kernels
are their plain twins (:func:`segment_ref`, :func:`sweep_ref`) and there
is no card to hold a population, every population takes the segment
runner; the two runners give bitwise the same sig, samples and logp
there.

The pooled update is the rule of ``cfg.stage1_adapt``: AAP,
``sig = max(sig + 10 * gamma * err, 0)``, or the log rule,
``sig = sig * exp(log_gain * gamma * err)``, with err = acc / C - 0.25 and
JAX's grouping of the products.  Both kernels apply it inside their
launch.  The one-sweep kernel also has a moves-only mode, which writes
the sweep's counts alone, for a caller that sums them across devices
before the rule (:func:`pooled_update`), as the JAX ``seg_fn`` does
outside its kernel; it takes a chain base (``C_total``, ``chain_off``), so
that a rank's chains draw their global chains' words.  Across devices
(``mesh=``) stage 1 always runs :func:`run_fused_stage1_sweeps` in that
mode, the counts summed over the ranks every sweep (JAX's
``run_fused_stage1_sharded``); the segment kernel, whose update needs the
whole population in one launch, is not run there, as in JAX.

Randomness is the counter hash of (seed_eff, 1-based global sweep, chain,
slot) with ``seed_eff = (seed * 1000003 + 777) & 0x7FFFFFFF``, so the
port's words equal the JAX kernels' and any segmentation gives the same
trajectories.  Perturbations are Box-Muller normals, or with
``student_t_dof > 0`` Bailey polar t variates from the same two words.
State layouts: theta [D, K*C]; sig, nacc, ntry [K, D] (every chain of a
model shares its row).

The JAX package runs DDI's stage 1 on its XLA engine (``rwm.py``; its
fused stage 1 sees no column form there, ``fused_stage1.py:103-105``).
The port has only these kernels, and evaluates DDI's statistics from
scratch in them (``AM_KIND_DDI``): held to its twins bitwise on the card
and to JAX statistically.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from automix_tpu_torch.config import (EngineConfig, LOG_ACCEPT_CLAMP,
                                      RWM_TARGET_ACCEPT, STAGE1_RULES)
from automix_tpu_torch.kernels import _build
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.parallel import mesh as mesh_lib

_SEG_DEFAULT = 100


def stage1_eligible(modelset, cfg: EngineConfig, mesh=None, C=None):
    """(True, why) when the stage-1 kernels serve the model set, else
    (False, why not): ``fused_stage1`` is not "off", every model has a
    CUDA density, the kernels are instantiated at its (K, D) and, under a
    ``mesh``, its ranks split the ``C`` chains of each model evenly (JAX
    fused_stage1.py:107-116).  ``fused_stage1="on"`` raises where they do
    not serve it."""
    K, D = modelset.nmodels, modelset.dmax
    missing = [m.name for m in modelset.models if m.cuda is None]
    if cfg.fused_stage1 == "off":
        ok, why = False, "fused_stage1='off'"
    elif missing:
        ok, why = False, f"models {missing} have no CUDA density"
    elif (K, D) not in _build.SHAPES:
        ok, why = False, f"no kernel instantiation at (K, D) = ({K}, {D})"
    elif mesh is not None and C % mesh.size:
        ok, why = False, (f"{C} chains per model do not split evenly over "
                          f"the {mesh.size} ranks of the mesh")
    else:
        ok, why = True, (f"every model has a CUDA density at (K, D) = "
                         f"({K}, {D})")
    if cfg.fused_stage1 == "on" and not ok:
        raise ValueError(f"fused_stage1='on', but the stage-1 kernels "
                         f"cannot serve this model set: {why}")
    return ok, why


def segment_capacity(modelset, device, tdist=None) -> int:
    """Chains the segment kernel (K2) holds resident on the card at once
    for the model set's (K, D), Normal or Student-t (``tdist``): the CUDA
    occupancy of its one-warp block times the SM count times 32.  The
    routing bound of stage 1 (:func:`runs_segment_kernel`)."""
    K, D = modelset.nmodels, modelset.dmax
    _build.check_shape(K, D, "segment_capacity")
    chains = ctypes.c_int()
    symbol = _build.stage1_symbol(tdist is not None, "cap")
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), symbol)(
            K, D, ctypes.byref(chains)), symbol)
    return chains.value


def runs_segment_kernel(n_chains: int, capacity: int) -> bool:
    """The stage-1 routing rule: the segment kernel (K2) for a population
    of ``n_chains`` that the card holds resident (``capacity``, from
    :func:`segment_capacity`), the one-sweep kernel (K3) above it.  K2
    measured faster than K3 on every stage-1 population of the shipped
    configurations, 1.3-6.3 times since K3 applies the update in its
    launch (PERF.md section 6)."""
    return n_chains <= capacity


def stage1_runner(modelset, cfg: EngineConfig, C: int, device):
    """The runner stage 1 takes for K*C chains on ``device``:
    :func:`run_fused_stage1` where :func:`runs_segment_kernel` holds or on
    the CPU, else :func:`run_fused_stage1_sweeps`."""
    if torch.device(device).type != "cuda":
        return run_fused_stage1
    tdist = (randoms.student_t(cfg.student_t_dof)
             if cfg.student_t_dof > 0 else None)
    cap = segment_capacity(modelset, device, tdist)
    return (run_fused_stage1
            if runs_segment_kernel(modelset.nmodels * C, cap)
            else run_fused_stage1_sweeps)


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


def _adapted(sig, err, gamma, rule: str, log_gain: float):
    """The pooled rule's new sig from the acceptance error ``err`` and
    the gain ``gamma`` (a float32 tensor), grouped as in JAX
    (automix_tpu/kernels/fused_stage1.py:239-243, 669-673)."""
    if rule == "log":
        return sig * torch.exp((log_gain * gamma) * err)
    return torch.clamp(sig + (10.0 * gamma) * err, min=0.0)


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


def _lane_layout(modelset, N: int, C: int, dev, C_total=None,
                 chain_off: int = 0):
    """(global chain of each lane, its model, per-coordinate activity):
    lane i of model m = i // C is global chain m * C_total + chain_off +
    (i - m * C), the chain base of a population split across devices
    (C_total = C and chain_off 0 for a whole one: lane i is chain i)."""
    lane = torch.arange(N, device=dev)
    model_of = lane // C
    if C_total is not None:
        lane = model_of * C_total + chain_off + (lane - model_of * C)
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    active = [(dims[model_of] > d).to(torch.float32)
              for d in range(modelset.dmax)]
    return lane, model_of, active


def segment_ref(modelset, theta, sig, nacc, ntry, *, C: int, sweep0: int,
                seed: int, nburn: int, n_active: int, tdist=None,
                rule: str = "aap", log_gain: float = 3.0):
    """Plain PyTorch twin of the segment kernel: ``n_active`` sweeps
    (global sweeps sweep0+1 ... sweep0+n_active).  ``tdist`` is a
    ``randoms.StudentT`` for t perturbations, None for normals; ``rule``
    ("aap" or "log") and ``log_gain`` are the pooled update's.  Returns
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
        new_sig = _adapted(sig, err, _gain(t, dev), rule, log_gain)
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
            seed: int, nburn: int, n_active: int, tdist=None,
            rule: str = "aap", log_gain: float = 3.0):
    """One stage-1 segment: the CUDA kernel for tensors on the card, its
    plain twin for tensors on the CPU.  Same arguments and results as
    :func:`segment_ref`.  The kernel's launcher refuses a population above
    :func:`segment_capacity` (then this raises; nothing falls back)."""
    if theta.device.type == "cpu":
        return segment_ref(modelset, theta, sig, nacc, ntry, C=C,
                           sweep0=sweep0, seed=seed, nburn=nburn,
                           n_active=n_active, tdist=tdist, rule=rule,
                           log_gain=log_gain)
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"segment: unsupported device {dev}")
    _build.check_shape(K, D, "segment")
    if N != K * C:
        raise ValueError(f"segment: {N} chains are not {K} x {C}")
    if rule not in STAGE1_RULES:
        raise ValueError(f"segment: unknown rule {rule!r}")
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
    gcnt = torch.zeros(3 * K * D, dtype=torch.int32, device=dev)
    symbol = _build.stage1_symbol(tdist is not None)
    status = getattr(_build.library(), symbol)(
        K, D, N, C, sweep0, seed, nburn, n_active, _build.tconsts(tdist),
        int(rule == "log"), float(log_gain), gcnt.data_ptr(),
        kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        theta.data_ptr(), sig.data_ptr(), nacc.data_ptr(), ntry.data_ptr(),
        th_o.data_ptr(), sig_o.data_ptr(), nacc_o.data_ptr(),
        ntry_o.data_ptr(), lp_o.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, symbol)
    segment.launches += 1
    return th_o, sig_o, nacc_o, ntry_o, lp_o


segment.launches = 0


@functools.lru_cache(maxsize=None)
def _coord_active(dims: tuple, dmax: int, dev: str):
    """[K, D] bool on ``dev``: coordinate d belongs to model k."""
    dims_t = torch.as_tensor(dims, device=dev).long()
    return torch.arange(dmax, device=dev)[None, :] < dims_t[:, None]


def pooled_update(modelset, sig, nacc, ntry, cnt, *, C: int, t: int,
                  adapt: bool, rule: str = "aap", log_gain: float = 3.0):
    """Sweep ``t``'s pooled update from its exact [K, D] accept counts
    ``cnt``, as the JAX ``seg_fn`` applies it outside its kernel
    (automix_tpu/kernels/fused_stage1.py:230-243), blends included: err =
    cnt / C - 0.25 on each model's coordinates (0 on the others), sig
    blended towards the rule's value by ``adapt`` (False on a block-move
    sweep), nacc and ntry advanced by the counts and C.  The one-sweep
    kernel's in-launch update computes the same expressions.  Returns
    (sig, nacc, ntry)."""
    active = _coord_active(tuple(modelset.dims), modelset.dmax,
                           str(sig.device))
    err = (cnt.to(torch.float32) * (1.0 / C) - RWM_TARGET_ACCEPT) \
        * active.to(torch.float32)
    sig_new = _adapted(sig, err, _gain(t, sig.device), rule, log_gain)
    return (sig + float(adapt) * (sig_new - sig), nacc + int(adapt) * cnt,
            ntry + int(adapt) * (active * C).to(torch.int32))


def sweep_ref(modelset, theta, logp, sig, *, C: int, t: int, seed: int,
              nburn: int, seg_start: bool, tdist=None, nacc=None, ntry=None,
              rule: str = "aap", log_gain: float = 3.0, C_total=None,
              chain_off: int = 0):
    """Plain PyTorch twin of the one-sweep kernel: global sweep ``t`` of
    every lane; logp is recomputed from theta when ``seg_start``.  Moves
    only (``nacc`` and ``ntry`` None): returns (theta [D, N], logp [N],
    accept counts [K, D] int32 of the componentwise moves, zero on a block
    sweep).  With ``nacc`` and ``ntry`` [K, D], the sweep's pooled update
    (:func:`pooled_update`, the rule ``rule`` with ``log_gain``) is
    applied to ``sig``, ``nacc`` and ``ntry`` in place, as the kernel
    applies it inside its launch, and the counts come back as None.
    ``C_total`` and ``chain_off`` are the chain base: these C chains of
    each model are its chains chain_off ... of C_total (moves only; the
    update needs the whole population)."""
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    _check_base(C, C_total, chain_off, nacc is not None, "sweep_ref")
    lane, model_of, active = _lane_layout(modelset, N, C, dev, C_total,
                                          chain_off)
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
    if nacc is None:
        return torch.stack(th), lp, cnt
    new = pooled_update(modelset, sig, nacc, ntry, cnt, C=C, t=t,
                        adapt=not block, rule=rule, log_gain=log_gain)
    for x, v in zip((sig, nacc, ntry), new):
        x.copy_(v)
    return torch.stack(th), lp, None


def _check_base(C: int, C_total, chain_off: int, update: bool, fn: str):
    """Raise unless the chain base holds C chains of each model from
    position ``chain_off`` of ``C_total``, and the pooled update (which
    needs every chain) goes with the whole population."""
    if C_total is None:
        C_total = C
    if chain_off < 0 or C_total < chain_off + C:
        raise ValueError(f"{fn}: chains {chain_off} ... {chain_off + C - 1} "
                         f"of each model's {C_total}")
    if update and (C_total != C or chain_off):
        raise ValueError(f"{fn}: the pooled update needs the whole "
                         "population; sum the moves-only counts across "
                         "devices, then pooled_update")


# The one-sweep kernel's rule codes (csrc/fused_stage1_sweep.cu; -1 is
# moves only).
_K3_RULES = {"aap": 0, "log": 1}

def sweep(modelset, theta, logp, sig, *, C: int, t: int, seed: int,
          nburn: int, seg_start: bool, tdist=None, nacc=None, ntry=None,
          rule: str = "aap", log_gain: float = 3.0, work=None,
          C_total=None, chain_off: int = 0):
    """One stage-1 sweep: the CUDA kernel for tensors on the card, its
    plain twin for tensors on the CPU.  Same arguments and results as
    :func:`sweep_ref`: with ``nacc`` and ``ntry`` the kernel applies the
    pooled update to ``sig``, ``nacc`` and ``ntry`` in device memory inside
    its launch, else it writes the counts alone (the moves-only mode, whose
    counts a caller can sum across devices before the rule).  ``work``,
    with the update, is the launch's counts and ticket: int32 [K * D + 1],
    zero before the launch and left zero by it, so a caller that runs many
    sweeps makes it once; None makes a zeroed one for this call.
    ``C_total`` and ``chain_off``, the chain base, are the kernel's
    run-time arguments (moves only)."""
    if theta.device.type == "cpu":
        return sweep_ref(modelset, theta, logp, sig, C=C, t=t, seed=seed,
                         nburn=nburn, seg_start=seg_start, tdist=tdist,
                         nacc=nacc, ntry=ntry, rule=rule, log_gain=log_gain,
                         C_total=C_total, chain_off=chain_off)
    K, D = modelset.nmodels, modelset.dmax
    N = theta.shape[1]
    dev = theta.device
    if dev.type != "cuda":
        raise ValueError(f"sweep: unsupported device {dev}")
    _build.check_shape(K, D, "sweep")
    if N != K * C:
        raise ValueError(f"sweep: {N} chains are not {K} x {C}")
    if rule not in STAGE1_RULES:
        raise ValueError(f"sweep: unknown rule {rule!r}")
    update = nacc is not None
    if update != (ntry is not None):
        raise ValueError("sweep: nacc and ntry go together")
    _check_base(C, C_total, chain_off, update, "sweep")
    checks = [("theta", theta, torch.float32, (D, N)),
              ("logp", logp, torch.float32, (N,)),
              ("sig", sig, torch.float32, (K, D))]
    if work is not None and not update:
        raise ValueError("sweep: work serves the update only")
    if update:
        if work is None:
            work = torch.zeros(K * D + 1, dtype=torch.int32, device=dev)
        checks += [("nacc", nacc, torch.int32, (K, D)),
                   ("ntry", ntry, torch.int32, (K, D)),
                   ("work", work, torch.int32, (K * D + 1,))]
    else:
        work = torch.zeros(K * D, dtype=torch.int32, device=dev)
    for name, x, dtype, shape in checks:
        _check(name, x, dev, dtype, shape, "sweep")
    kinds, consts, dims = modelset.density_table(dev)
    th_o = torch.empty_like(theta)
    lp_o = torch.empty_like(logp)
    symbol = _build.stage1_sweep_symbol(tdist is not None)
    status = getattr(_build.library(), symbol)(
        K, D, N, C, C if C_total is None else C_total, chain_off, t, seed,
        nburn, int(seg_start), _build.tconsts(tdist),
        _K3_RULES[rule] if update else -1, float(log_gain),
        kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        theta.data_ptr(), logp.data_ptr(), sig.data_ptr(),
        nacc.data_ptr() if update else None,
        ntry.data_ptr() if update else None, th_o.data_ptr(),
        lp_o.data_ptr(), work.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, symbol)
    sweep.launches += 1
    return th_o, lp_o, None if update else work.view(K, D)


sweep.launches = 0


def sweep_grid(N: int, device, tdist=None):
    """(threads a block, blocks) of the one-sweep kernel's launch for N
    chains on the card ``device``: the launcher's own choice."""
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    symbol = _build.stage1_sweep_symbol(tdist is not None, "grid")
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), symbol)(
            N, ctypes.byref(threads), ctypes.byref(blocks)), symbol)
    return threads.value, blocks.value


def _start(modelset, cfg, nsweeps, C, init_theta, device, C_local=None):
    """Shared start of both runners: schedule, theta at the start points
    (of ``C_local`` chains a model, C by default), sig 10 on each model's
    coordinates, zero counts, the stage-1 seed."""
    K, D = modelset.nmodels, modelset.dmax
    C_local = C if C_local is None else C_local
    N = K * C_local
    model_of = torch.arange(N) // C_local
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
            seed=seed_eff, nburn=nburn, n_active=n, tdist=tdist,
            rule=cfg.stage1_adapt, log_gain=cfg.stage1_log_gain)
        done += n
        tele.append((sig, nacc, ntry))
        if s in snap_segs:
            snaps.append(theta)
    if done != total:
        raise RuntimeError("stage-1 segments do not cover the schedule")
    return _finish(modelset, C, coord_active, tele, snaps, lp, device)


def run_fused_stage1_sweeps(modelset, cfg: EngineConfig, nsweeps: int,
                            C: int, init_theta, device, sweep_fn=None,
                            mesh=None):
    """Stage 1 for a population the segment kernel cannot hold resident:
    the one-device form of the JAX ``run_fused_stage1_sharded``.  Each
    sweep is one launch of the one-sweep kernel, which applies the pooled
    update of sig (the rule of ``cfg.stage1_adapt``), nacc and ntry inside
    the launch from its exact integer accept counts, in the JAX order,
    blends included; telemetry is read at segment ends.  Same schedule,
    arguments and results as :func:`run_fused_stage1`, and bitwise the
    same values in the twins.  ``sweep_fn=sweep_ref`` is the runner's
    plain twin on any device.

    Under a ``mesh`` (the JAX ``run_fused_stage1_sharded``) each rank runs
    its C / size chains of every model, from position rank * C / size of
    each model's C, in the one-sweep kernel's moves-only mode at that
    chain base; every sweep its counts are summed across the ranks as
    integers and :func:`pooled_update` applies the rule to the replicated
    sig, nacc and ntry on every rank, so sig, the telemetry and each
    chain's trajectory are the unsharded run's bit for bit.  The samples
    and logp are the rank's chains' ([K, C / size * n_tail, D] and
    [K, C / size]; ``parallel.mesh.all_gather`` along axis 1 gives the
    unsharded layout)."""
    C_local = C if mesh is None else mesh.local(C, "chains per model")
    ((total, nburn, seg, n_seg, snap_segs), coord_active, theta, sig, nacc,
     ntry, seed_eff, tdist) = _start(modelset, cfg, nsweeps, C, init_theta,
                                     device, C_local)
    if mesh is not None:
        sweep_fn = _meshed(sweep_fn or sweep, mesh, C, C_local)
    elif sweep_fn is None:
        # the kernel's counts and ticket, zeroed once: each launch leaves
        # them zeroed for the next
        K, D = modelset.nmodels, modelset.dmax
        sweep_fn = functools.partial(sweep, work=torch.zeros(
            K * D + 1, dtype=torch.int32, device=device))
    rule, log_gain = cfg.stage1_adapt, cfg.stage1_log_gain
    lp = torch.zeros((theta.shape[1],), dtype=torch.float32, device=device)
    snaps, tele = [], []
    done = 0
    for s in range(n_seg):
        n = min(seg, total - done)
        for i in range(n):
            t = done + i + 1                             # 1-based global
            # sig, nacc and ntry updated in place
            theta, lp, _ = sweep_fn(modelset, theta, lp, sig, C=C, t=t,
                                    seed=seed_eff, nburn=nburn,
                                    seg_start=i == 0, tdist=tdist, nacc=nacc,
                                    ntry=ntry, rule=rule, log_gain=log_gain)
        done += n
        tele.append((sig.clone(), nacc.clone(), ntry.clone()))
        if s in snap_segs:
            snaps.append(theta)
    if done != total:
        raise RuntimeError("stage-1 segments do not cover the schedule")
    return _finish(modelset, C_local, coord_active, tele, snaps, lp, device)


def _meshed(sweep_fn, mesh, C: int, C_local: int):
    """A one-sweep function of :func:`run_fused_stage1_sweeps`'s form for
    this rank's C_local chains of each model: ``sweep_fn``'s moves-only
    mode at the rank's chain base, the counts summed across the mesh,
    then :func:`pooled_update` of sig, nacc and ntry in place with the
    global C (JAX's seg_fn, fused_stage1.py:223-246)."""
    off = mesh.rank * C_local

    def run(modelset, theta, lp, sig, *, nacc, ntry, rule, log_gain, C,
            **kw):
        C_total = C
        theta, lp, cnt = sweep_fn(modelset, theta, lp, sig, C=C_local,
                                  C_total=C_total, chain_off=off, **kw)
        cnt = mesh_lib.all_reduce_sum(cnt, mesh)
        t = kw["t"]
        block = t > kw["nburn"] and randoms.block_coin(kw["seed"], t)
        new = pooled_update(modelset, sig, nacc, ntry, cnt, C=C_total, t=t,
                            adapt=not block, rule=rule, log_gain=log_gain)
        for x, v in zip((sig, nacc, ntry), new):
            x.copy_(v)
        return theta, lp, None

    return run
