"""Stage 3 on the general engine: reversible-jump sweeps in plain PyTorch.

Counterpart of ``automix_tpu/kernels/rjmcmc.py``: ``precompute_tables``,
``_alloc_logits``, ``rand_slots``, ``build_sweep_all``, ``_chunk_scan``
and the one-device ``build_chunk_runner``, plus ``init_chains``.  It
serves every model set the kernels do not (``AMSampler``'s engine rule):
a model given as a per-theta ``logp``, a (K, D) the kernels are not
instantiated for, or a proposal larger than the sweep kernel holds.  It
runs eagerly on the chains' device, one sweep at a time, over the whole
chain batch at padded shapes.

One sweep (``reversible_jump_move``, automix.c:1035-1288): (a) a
within-model RWM move, block every 10th sweep, else componentwise; (b)
the jump: allocate the state to a component of its model, standardize,
draw the destination model from pk and a component from its weights,
dimension-match with latent normals (the padded coordinates are the
latent), optionally permute, de-standardize, the reverse allocation and
the accept; (c) pk's diminishing adaptation, per chain or pooled, with
the re-init safeguard.

Per-chain table rows are gathered by k where the JAX package contracts a
one-hot matrix with the table (its choice for the TPU, rjmcmc.py:18-37):
both give the same values while the tables are finite.  The products
that carry a chain's own coordinates stay dense at padded shapes, as in
JAX, so that a non-finite draw propagates as it does there: the ``fast``
stream gives z = +inf at u = 1.0 (``ops/randoms.py``), inf * 0 in a padded
coordinate is NaN, and a NaN log-ratio rejects the move.

The random words of a sweep are [S, MU] uniforms and [S, MZ] normals
(:func:`rand_slots`) from the ``fast`` counter hash
(``randoms.fast_sweep_randoms``, bitwise JAX's words), from K4
(``kernels/sweep_rng.py``, ``rng="pallas"``) or, under ``rng="threefry"``
(the stream of every Student-t run), from JAX's threefry stream keyed by
the chains' keys (:func:`draw_sweep_randoms`), whose z are t(dof) for a
Student-t run; the latent terms of the jump then take t(dof) too.

With ``within_move="hmc"`` the within-model move is a leapfrog HMC move
(``kernels/hmc.py``) of a length drawn per sweep from
``fold_in(key(seed ^ 0x177A7EC7), sweep)``, shared by the batch.

Across devices (``mesh=``, ``parallel/mesh.py``) each rank sweeps its block
of chains: the ``fast`` words are drawn at the rank's first global chain
(``chain0``), K4 at its first global block, and threefry from the chains'
own keys, so every chain draws what it draws on one device.  The chunk's
accumulators are summed across the ranks once a chunk, a pooled pk's
visit histogram once a sweep, and the traces of the global chain prefix
(rank 0's chains) are broadcast from rank 0 (JAX rjmcmc.py:545-595).
"""

from __future__ import annotations

import numpy as np
import torch

from automix_tpu_torch.config import EngineConfig, NEG_INF
from automix_tpu_torch.kernels import hmc, sweep_rng
from automix_tpu_torch.kernels.fused_stage1 import _accept
from automix_tpu_torch.ops import linalg, randoms
from automix_tpu_torch.parallel import mesh as mesh_lib
from automix_tpu_torch.state import Chains, Proposal

_LOG_2PI = 1.8378770664093453


def precompute_tables(prop: Proposal, dims) -> dict:
    """Fold the proposal into per-(model, component) tables, flat over
    the K*L component axis (JAX's ``precompute_tables``): ``binv_flat``,
    ``b_flat`` and ``p_flat`` (B^-T B^-1) [K*L, D*D]; ``q_flat``,
    ``muc_flat`` [K*L, D] and ``c0_flat``, ``logdet_flat`` [K*L] of the
    expanded quadratic around the per-model mixture mean ``center``
    [K, D]; ``abase`` (log lam - log det B - dim/2 log 2 pi) and ``loglam``
    [K, L], dead components at NEG_INF."""
    K, L, D = prop.mu.shape
    f32 = torch.float32
    B = torch.tril(prop.B.to(f32))
    binv = linalg.tri_inverse(B)
    lam = prop.lam.to(f32)
    mu = prop.mu.to(f32)
    center = torch.einsum("kl,kld->kd", lam, mu)
    mu_c = mu - center[:, None, :]
    p = torch.einsum("kled,klef->kldf", binv, binv)
    q = torch.einsum("kldf,klf->kld", p, mu_c)
    c0 = torch.einsum("kld,kld->kl", q, mu_c)
    loglam = torch.where(lam > 0, torch.log(torch.clamp(lam, min=1e-38)),
                         torch.full_like(lam, NEG_INF))
    logdet = prop.logdetB.to(f32)
    dims_f = torch.as_tensor(np.asarray(dims), dtype=f32, device=lam.device)
    abase = loglam - logdet - 0.5 * dims_f[:, None] * _LOG_2PI
    return {
        "binv_flat": binv.reshape(K * L, D * D),
        "b_flat": B.reshape(K * L, D * D),
        "p_flat": p.reshape(K * L, D * D),
        "q_flat": q.reshape(K * L, D),
        "c0_flat": c0.reshape(K * L),
        "muc_flat": mu_c.reshape(K * L, D),
        "logdet_flat": logdet.reshape(K * L),
        "center": center,
        "abase": abase,
        "loglam": loglam,
    }


def _alloc_logits(x_c, k, tab, K: int, L: int):
    """Allocation logits [S, L] of centered states ``x_c`` [S, D] against
    their model's mixture: abase - 0.5 |B^-1 (x - mu)|^2 through the Gram
    tables (two products against all K*L components), then model k's
    row."""
    S, D = x_c.shape
    x2 = (x_c[:, :, None] * x_c[:, None, :]).reshape(S, D * D)
    quad = (x2 @ tab["p_flat"].T - 2.0 * (x_c @ tab["q_flat"].T)
            + tab["c0_flat"][None, :])
    full = (tab["abase"].reshape(-1)[None, :] - 0.5 * quad).reshape(S, K, L)
    return full[torch.arange(S, device=k.device), k]


def rand_slots(dmax: int, lmax: int, nmodels: int):
    """Static layout of a sweep's uniform columns ({name: (start, end)}),
    their count MU = 2D + 2L + K + 2 and the normals' MZ = 2D ([0, D) the
    RWM perturbation, [D, 2D) the latent)."""
    D, L, K = dmax, lmax, nmodels
    u = {
        "rwm": (0, D),
        "alloc": (D, D + L),
        "model": (D + L, D + L + K),
        "comp": (D + L + K, D + L + K + L),
        "perm": (D + L + K + L, D + L + K + L + D),
        "acc": (D + L + K + L + D, D + L + K + L + D + 1),
        "extra": (D + L + K + L + D + 1, D + L + K + L + D + 2),
    }
    return u, D + 2 * L + K + D + 2, 2 * D


def gamma_f32(sweep: int) -> float:
    """The adaptation gain (1 / (sweep + 1))^(2/3) in float32 from a
    float32 sweep, as JAX computes it (automix.c:1145), on the host: the
    same bits on every device."""
    s = np.float32(sweep)
    return float(np.power(np.float32(1.0) / (s + np.float32(1.0)),
                          np.float32(2.0 / 3.0)))


def draw_sweep_randoms(keys, sweep: int, mu_count: int, mz_count: int,
                       dof: int):
    """One sweep's u [S, MU] and z [S, MZ] from the chains' threefry keys
    ``keys`` [S, 2] (JAX's ``draw_sweep_randoms``): each key folded with
    the sweep, then with 0 for the uniforms and 1 for the perturbations,
    ``uniform(k0, (MU,))`` and ``rand_t(k1, (MZ,), dof)``.  The uniform
    and normal words come from one threefry pass."""
    dev = keys.device
    kk = randoms.fold_in(randoms.fold_in(keys, sweep)[:, None, :],
                         torch.arange(2, device=dev))           # [S, 2, 2]
    which = torch.cat([torch.zeros(mu_count, dtype=torch.int64, device=dev),
                       torch.ones(mz_count, dtype=torch.int64, device=dev)])
    counts = torch.cat([torch.arange(mu_count, device=dev),
                        torch.arange(mz_count, device=dev)])
    bits = randoms.keyed_words(kk[:, which], counts)
    u = randoms.uniform_of_bits(bits[:, :mu_count])
    z = randoms.normal_of_bits(bits[:, mu_count:])
    return u, randoms.t_scale(z, kk[:, 1], (mz_count,), dof)


def sweep_randoms(cfg: EngineConfig, rng_mode: str, chains: Chains,
                  mu_count: int, mz_count: int, chain0: int = 0):
    """One sweep's u [S, MU] and z [S, MZ] from the ``fast`` hash, K4 or
    the chains' threefry keys; ``chain0`` is the global index of the
    batch's first chain (K4's first block is chain0 over its block size,
    as JAX's)."""
    S, sweep, dev = chains.n_chains, chains.sweep, chains.theta.device
    if rng_mode == "fast":
        return randoms.fast_sweep_randoms(int(cfg.seed), sweep, chain0, S,
                                          mu_count, mz_count, dev)
    if rng_mode == "pallas":
        return sweep_rng.draw(int(cfg.seed), sweep,
                              chain0 // sweep_rng.choose_block(S), S,
                              mu_count, mz_count, dev)
    if rng_mode == "threefry":
        if chains.key is None:
            raise ValueError("rng='threefry' needs the chains' keys "
                             "(init_chains makes them)")
        return draw_sweep_randoms(chains.key, sweep, mu_count, mz_count,
                                  cfg.student_t_dof)
    raise ValueError(f"unknown rng mode {rng_mode!r}")


HMC_LENGTH_SALT = 0x177A7EC7


def hmc_length(cfg: EngineConfig, sweep: int) -> int:
    """The HMC move's shared trajectory length at ``sweep``, from a
    uniform of ``fold_in(key(seed ^ 0x177A7EC7), sweep)``: a stream
    indexed by the sweep alone, independent of the chains' draws."""
    k = randoms.fold_in(randoms.key(int(cfg.seed) ^ HMC_LENGTH_SALT),
                        sweep)
    return hmc.sample_n_steps(cfg, randoms.uniform_host(k))


def build_sweep_all(modelset, cfg: EngineConfig, burning: bool,
                    rng_mode: str = "fast", mesh=None):
    """One sweep over all chains (JAX's ``build_sweep_all``):
    ``sweep_all(chains, prop, tables=None) -> (chains', stats)`` with
    stats int32 [S] per event kind.  ``tables`` is
    :func:`precompute_tables` of ``prop``.  Under a ``mesh`` ``chains``
    are this rank's block (module note)."""
    K, D = modelset.nmodels, modelset.dmax
    tc = (randoms.student_t(cfg.student_t_dof) if cfg.student_t_dof > 0
          else None)
    scale = cfg.hmc_step_scale
    per_model_scale = np.ndim(scale) != 0
    adapt = cfg.adapt and not burning
    dims_np = np.asarray(modelset.dims)
    # the models a componentwise move on coordinate j changes
    above = [[m for m in range(K) if dims_np[m] > j] for j in range(D)]
    consts = {}

    def device_consts(dev):
        # made once per device: a host-to-device copy every sweep would
        # wait for the card's queue
        if dev not in consts:
            consts[dev] = (torch.as_tensor(dims_np, device=dev).long(),
                           torch.arange(D, device=dev),
                           torch.tensor(np.float32(scale), device=dev)
                           if per_model_scale else None)
        return consts[dev]

    def sweep_all(chains: Chains, prop: Proposal, tables=None):
        k, theta, logp = chains.k.long(), chains.theta, chains.logp
        pk, pkllim, nreinit = chains.pk, chains.pkllim, chains.nreinit
        sweep = chains.sweep
        S = k.shape[0]
        dev = theta.device
        L = prop.lam.shape[1]
        tab = tables if tables is not None else precompute_tables(
            prop, dims_np)
        slots, mu_count, mz_count = rand_slots(D, L, K)
        u, z = sweep_randoms(cfg, rng_mode, chains, mu_count, mz_count,
                             mesh_lib.chain0(mesh, S))

        def us(name):
            a, b = slots[name]
            return u[:, a:b]

        dims, coords, scale_t = device_consts(dev)
        rows = torch.arange(S, device=dev)
        dim_k = dims[k]
        mask_k = (coords[None, :] < dim_k[:, None]).to(torch.float32)
        sig_k = prop.sig.to(torch.float32)[k]
        stats = {}
        zero = torch.zeros_like(chains.k)

        # ---- (a) within-model move (automix.c:1054-1085) ----------------
        if cfg.within_move == "hmc":
            eps_k = (scale_t[k][:, None] * sig_k if per_model_scale
                     else float(np.float32(scale)) * sig_k)
            theta, logp, acc = hmc.hmc_move(
                modelset, us("rwm")[:, 0], hmc_length(cfg, sweep), z[:, :D],
                k, theta, logp, eps_k, mask_k)
            naccb, ntryb = acc.to(torch.int32), zero + 1
            naccs = ntrys = zero
        elif sweep % 10 == 0:
            theta_prop = theta + sig_k * z[:, :D] * mask_k
            lpn = modelset.logpost_batch(k, theta_prop)
            acc = us("rwm")[:, 0] < _accept(lpn - logp)
            theta = torch.where(acc[:, None], theta_prop, theta)
            logp = torch.where(acc, lpn, logp)
            naccb, ntryb = acc.to(torch.int32), zero + 1
            naccs = ntrys = zero
        else:
            u_rwm = us("rwm")
            naccs = ntrys = zero
            for j in range(D):
                active = j < dim_k
                theta_prop = theta.clone()
                theta_prop[:, j] = theta[:, j] + sig_k[:, j] * z[:, j]
                lpn = modelset.logpost_batch(k, theta_prop, above[j])
                acc = (u_rwm[:, j] < _accept(lpn - logp)) & active
                theta = torch.where(acc[:, None], theta_prop, theta)
                logp = torch.where(acc, lpn, logp)
                naccs = naccs + acc.to(torch.int32)
                ntrys = ntrys + active.to(torch.int32)
            naccb = ntryb = zero
        stats["naccrwmb"], stats["ntryrwmb"] = naccb, ntryb
        stats["naccrwms"], stats["ntryrwms"] = naccs, ntrys

        # ---- (b) reversible jump (automix.c:1087-1256) ------------------
        loglam_k = tab["loglam"][k]                              # [S, L]
        theta_c = theta - tab["center"][k]
        logits = _alloc_logits(theta_c, k, tab, K, L)
        ll = torch.argmax(logits + randoms.gumbel(us("alloc")), dim=1)
        log_palloc = (logits[rows, ll]
                      - torch.logsumexp(logits, dim=1))

        kl = k * L + ll
        binv_kl = tab["binv_flat"][kl].reshape(S, D, D)
        muc_kl = tab["muc_flat"][kl]
        work = torch.einsum("sde,se->sd", binv_kl, theta_c - muc_kl)
        work = work * mask_k

        if K == 1:
            kn = k
            logratio = torch.zeros_like(logp)
        else:
            logpk = torch.log(torch.clamp(pk, min=1e-38))
            kn = torch.argmax(logpk + randoms.gumbel(us("model")), dim=1)
            logratio = logpk[rows, k] - logpk[rows, kn]
        dim_kn = dims[kn]
        mask_kn = (coords[None, :] < dim_kn[:, None]).to(torch.float32)
        loglam_kn = tab["loglam"][kn]
        ln = torch.argmax(loglam_kn + randoms.gumbel(us("comp")), dim=1)

        # dimension matching (automix.c:1171-1204)
        work_full = torch.where(coords[None, :] < dim_k[:, None], work,
                                z[:, D:2 * D])
        up = ((coords[None, :] >= dim_k[:, None])
              & (coords[None, :] < dim_kn[:, None]))
        lpdf = randoms.latent_lpdf(work_full, tc)
        logratio = logratio - torch.where(up, lpdf, 0.0).sum(dim=1)
        if cfg.perm:
            n_active = torch.maximum(dim_k, dim_kn)[:, None]
            sort_key = torch.where(coords[None, :] < n_active, us("perm"),
                                   1.0 + coords[None, :].to(torch.float32))
            work_full = torch.gather(
                work_full, 1, torch.argsort(sort_key, dim=1, stable=True))
        down = ((coords[None, :] >= dim_kn[:, None])
                & (coords[None, :] < dim_k[:, None]))
        lpdf = randoms.latent_lpdf(work_full, tc)
        logratio = logratio + torch.where(down, lpdf, 0.0).sum(dim=1)

        # de-standardize into the destination (automix.c:1206-1211)
        kln = kn * L + ln
        b_kln = tab["b_flat"][kln].reshape(S, D, D)
        muc_kln = tab["muc_flat"][kln]
        center_kn = tab["center"][kn]
        thetan = (center_kn + muc_kln
                  + torch.einsum("sde,se->sd", b_kln, work_full * mask_kn))
        thetan = thetan * mask_kn

        # reverse-move allocation (automix.c:1213-1235)
        logits_n = _alloc_logits(thetan - center_kn, kn, tab, K, L)
        log_pallocn = (logits_n[rows, ln]
                       - torch.logsumexp(logits_n, dim=1))

        # accept (automix.c:1237-1256)
        lpn = modelset.logpost_batch(kn, thetan)
        logratio = (logratio + (lpn - logp)
                    + (log_pallocn - log_palloc)
                    + (loglam_k[rows, ll] - loglam_kn[rows, ln])
                    + (tab["logdet_flat"][kln] - tab["logdet_flat"][kl]))
        acc = us("acc")[:, 0] < _accept(logratio)
        k = torch.where(acc, kn, k)
        theta = torch.where(acc[:, None], thetan, theta)
        logp = torch.where(acc, lpn, logp)
        stats["nacctd"] = acc.to(torch.int32)
        stats["ntrytd"] = zero + 1

        # ---- (c) pk adaptation + re-init safeguard (automix.c:1258-1281)
        if adapt and K > 1:
            gamma = gamma_f32(sweep)
            target = torch.nn.functional.one_hot(k, K).to(torch.float32)
            if cfg.pk_mode == "pooled":
                hist = mesh_lib.all_reduce_sum(target.sum(dim=0), mesh)
                n_total = S if mesh is None else S * mesh.size
                target = (hist / float(n_total))[None, :].expand(S, K)
            pk = pk + gamma * (target - pk)
            reinit = torch.any(pk < pkllim[:, None], dim=1)
            nreinit = nreinit + reinit.to(torch.int32)
            pkllim = torch.where(reinit,
                                 1.0 / (10.0 * nreinit.to(torch.float32)),
                                 pkllim)
            pk = torch.where(reinit[:, None], torch.full_like(pk, 1.0 / K),
                             pk)

        return Chains(k=k.to(torch.int32), theta=theta, logp=logp, pk=pk,
                      pkllim=pkllim, nreinit=nreinit,
                      sweep=sweep + 1, key=chains.key), stats

    return sweep_all


def _kahan(s, c, x):
    """Compensated float32 add: (s', c') with c' the negated residual."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def chunk_scan(sweep_all, modelset, cfg: EngineConfig, collect: bool,
               chains: Chains, prop: Proposal, n_sweeps: int, mesh=None):
    """``n_sweeps`` sweeps with the chunk statistics accumulated on the
    device (JAX's ``_chunk_scan``): visit counts, float32 Kahan sums of
    theta and theta^2 per model, the six acceptance counters and, with
    ``collect``, per-sweep traces of the first ``n_trace_chains`` chains'
    k and chain 0's k, pk, logp and theta.  Under a ``mesh`` the
    accumulators are summed across the ranks at the chunk's end and the
    traces (of rank 0's chains, the global prefix) broadcast from rank 0,
    so every rank returns the same chunk."""
    K, D = modelset.nmodels, modelset.dmax
    dev = chains.theta.device
    tables = precompute_tables(prop, modelset.dims)
    f32 = torch.float32
    ks = torch.zeros(K, dtype=torch.int64, device=dev)
    ts = torch.zeros((K, D), dtype=f32, device=dev)
    tsc = torch.zeros_like(ts)
    tq = torch.zeros_like(ts)
    tqc = torch.zeros_like(ts)
    names = ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
             "ntrytd")
    cnt = torch.zeros(len(names), dtype=torch.int64, device=dev)
    traces = {n: [] for n in ("k_trace", "k0_trace", "pk0_trace",
                              "logp0_trace", "theta0_trace")}
    nt = min(cfg.n_trace_chains, chains.n_chains)
    for _ in range(n_sweeps):
        chains, stats = sweep_all(chains, prop, tables)
        onehot = torch.nn.functional.one_hot(chains.k.long(), K).to(f32)
        ts, tsc = _kahan(ts, tsc, onehot.T @ chains.theta)
        tq, tqc = _kahan(tq, tqc, onehot.T @ (chains.theta * chains.theta))
        ks = ks + onehot.sum(dim=0).to(torch.int64)
        cnt = cnt + torch.stack([stats[n].sum(dtype=torch.int64)
                                 for n in names])
        if collect:
            traces["k_trace"].append(chains.k[:nt].to(torch.int8))
            traces["k0_trace"].append(chains.k[0].to(torch.int8))
            traces["pk0_trace"].append(chains.pk[0])
            traces["logp0_trace"].append(chains.logp[0])
            traces["theta0_trace"].append(chains.theta[0])
    ks, ts, tq, cnt = (mesh_lib.all_reduce_sum(x, mesh)
                       for x in (ks, ts - tsc, tq - tqc, cnt))
    chunk = {"ksummary": ks, "theta_sum": ts, "theta_sqsum": tq}
    chunk.update({n: cnt[i] for i, n in enumerate(names)})
    if collect:
        chunk.update({n: mesh_lib.broadcast(torch.stack(v), mesh)
                      for n, v in traces.items()})
    return chains, chunk


def build_chunk_runner(modelset, cfg: EngineConfig, burning: bool,
                       collect: bool, mesh=None):
    """``runner(chains, prop, n_sweeps) -> (chains', chunk)`` (JAX's
    ``build_chunk_runner``), with the stream of
    ``sweep_rng.resolve_rng(cfg)``.  Under a ``mesh`` ``chains`` are this
    rank's block and ``chunk`` the global statistics (module note)."""
    sweep_all = build_sweep_all(modelset, cfg, burning,
                                sweep_rng.resolve_rng(cfg), mesh)

    def runner(chains: Chains, prop: Proposal, n_sweeps: int):
        return chunk_scan(sweep_all, modelset, cfg, collect, chains, prop,
                          n_sweeps, mesh)

    return runner


def init_keys(cfg: EngineConfig, n_chains: int, device):
    """The chain keys ``init_chains`` makes in a run of ``cfg.seed``
    through stages 1 and 2: the sampler's key after those stages' keys
    (and the HMC tuner's, where the run tunes) split into four, the
    second split into one key per chain."""
    k = randoms.key(int(cfg.seed))
    n_before = 3 + (cfg.within_move == "hmc" and cfg.hmc_autotune)
    for _ in range(n_before):
        k, sub = randoms.split_host(k, 2)
    _, k_keys, _, _ = randoms.split_host(sub, 4)
    return randoms.split(k_keys, n_chains, device)


def init_chains(modelset, cfg: EngineConfig, key, device,
                n_chains: int | None = None) -> Chains:
    """Chain batch at the start of stage 3 (JAX's ``init_chains``): from
    the threefry key ``key``, split into four, one key per chain split
    from the second, the model index ``randint`` of the fourth over the K
    models, theta at the chosen model's stage-1 start point
    (``init_points`` of the third), pk uniform, pkllim 0.1, nreinit 1 and
    the sweep counter at 1.

    logp comes from the column densities (``ModelSet.logpost_cols``),
    where the JAX function evaluates the scalar ``logp`` with ``gammaln``;
    the two agree to float32 rounding at the start points."""
    S = n_chains or cfg.n_chains
    K = modelset.nmodels
    _, k_keys, k_init, k_chain = randoms.split_host(key, 4)
    chain_keys = randoms.split(k_keys, S, device)
    k0 = randoms.randint(k_chain, (S,), 0, K, device)
    init_theta = modelset.init_points(k_init).to(device)         # [K, D]
    theta0 = init_theta[k0]
    logp0 = modelset.logpost_cols(k0, list(theta0.T))
    f32 = torch.float32
    return Chains(
        k=k0.to(torch.int32),
        theta=theta0,
        logp=logp0,
        pk=torch.full((S, K), 1.0 / K, dtype=f32, device=device),
        pkllim=torch.full((S,), 0.1, dtype=f32, device=device),
        nreinit=torch.ones((S,), dtype=torch.int32, device=device),
        sweep=1,
        key=chain_keys,
    )
