"""Stage 3: reversible-jump sweeps, a whole chunk per kernel launch.

Counterpart of ``automix_tpu/kernels/fused.py`` on its main-path
configuration (per-chain pk, Gaussian proposals, no perm, stateless column
densities, ``hash`` randomness): ``_prep_tables``, the chunk runner of
``_compiled``/``runner``, and the sweep kernel itself, which is
``csrc/fused_sweep.cu`` on the card and :func:`sweep_chunk_ref` on the CPU.

Chain i draws its words at hash counters i * NW + slot, NW = 3D+1+2L+K,
which is the JAX kernel's chain_id for the flat chain index.  The kernel
layouts are struct-of-arrays: theta [D, S], pk [K, S]; per-chain chunk
statistics come back as [K, S], [K*D, S] and [6, S] partial sums that the
runner reduces with ``torch.sum`` outside the kernel, as JAX reduces them
outside its ``pallas_call``.
"""

from __future__ import annotations

import dataclasses

import torch

from automix_tpu_torch.config import EngineConfig, LOG_ACCEPT_CLAMP, NEG_INF
from automix_tpu_torch.kernels import _build
from automix_tpu_torch.ops import linalg, randoms
from automix_tpu_torch.ops.plmath import HALF_LOG_2PI
from automix_tpu_torch.state import Chains, Proposal

_LOG_2PI = 1.8378770664093453
_TWO_PI = 6.283185307179586
_MAX_L = 32          # csrc/fused_sweep.cu kLMax


@dataclasses.dataclass
class SweepTables:
    """Per-chunk proposal tables: sig [K, D]; loglam, abase, logdet [K, L];
    mu [K*L, D]; binv and B [K*L, D*D] (binv the inverse factor)."""

    sig: torch.Tensor
    loglam: torch.Tensor
    abase: torch.Tensor
    logdet: torch.Tensor
    mu: torch.Tensor
    binv: torch.Tensor
    B: torch.Tensor

    def packed(self) -> torch.Tensor:
        """One contiguous float32 buffer in the kernel's table order."""
        return torch.cat([getattr(self, f.name).reshape(-1)
                          for f in dataclasses.fields(self)])


def prep_tables(prop: Proposal, dims) -> SweepTables:
    """Inverse factor, log-weights and the allocation-logit base of a
    proposal (``_prep_tables``)."""
    K, L, D = prop.mu.shape
    f32 = torch.float32
    B = torch.tril(prop.B.to(f32))
    binv = linalg.tri_inverse(B)
    lam = prop.lam.to(f32)
    loglam = torch.where(lam > 0, torch.log(torch.clamp(lam, min=1e-38)),
                         torch.full_like(lam, NEG_INF))
    logdet = prop.logdetB.to(f32)
    dims_f = torch.as_tensor(dims, dtype=f32, device=lam.device)
    abase = loglam - logdet - 0.5 * dims_f[:, None] * _LOG_2PI
    return SweepTables(sig=prop.sig.to(f32).contiguous(), loglam=loglam,
                       abase=abase, logdet=logdet,
                       mu=prop.mu.to(f32).reshape(K * L, D).contiguous(),
                       binv=binv.reshape(K * L, D * D).contiguous(),
                       B=B.reshape(K * L, D * D).contiguous())


def _accept(delta):
    return torch.exp(torch.clamp(delta, LOG_ACCEPT_CLAMP, 0.0))


def _lse(cols):
    """log-sum-exp over a list of [S] tensors in the kernel's order."""
    m = cols[0]
    for v in cols[1:]:
        m = torch.maximum(m, v)
    s = torch.exp(cols[0] - m)
    for v in cols[1:]:
        s = s + torch.exp(v - m)
    return m + torch.log(s)


def _standardize(x, mu, binv, dim, D: int):
    """Residuals w_r = sum_{c<=r} binv[r, c] (x_c - mu_c) of every
    component: ``x`` D tensors [S], ``mu`` [S, L, D], ``binv``
    [S, L, D, D], ``dim`` [S].  Returns (w list of [S, L], quad [S, L])
    with quad summed over the first ``dim`` rows in row order."""
    w, quad = [], None
    for r in range(D):
        acc = binv[..., r, 0] * (x[0][:, None] - mu[..., 0])
        for c in range(1, r + 1):
            acc = acc + binv[..., r, c] * (x[c][:, None] - mu[..., c])
        w.append(acc)
        sq = acc * acc
        quad = sq if quad is None else torch.where(
            (dim > r)[:, None], quad + sq, quad)
    return w, quad


def sweep_chunk_ref(modelset, k, theta, logp, pk, pkllim, nreinit,
                    tables: SweepTables, *, seed: int, sweep0: int,
                    n_sweeps: int, adapt: bool):
    """Plain PyTorch twin of the sweep kernel: ``n_sweeps`` sweeps (global
    sweeps sweep0 ...) of every chain.  ``theta`` is [D, S] and ``pk``
    [K, S].  Returns (k, theta, logp, pk, pkllim, nreinit, ksum [K, S],
    tsum [K*D, S], tqsum [K*D, S], cnt [6, S])."""
    K, D = modelset.nmodels, modelset.dmax
    S = k.shape[0]
    L = tables.loglam.shape[1]
    dev = k.device
    f32 = torch.float32
    NW = 3 * D + 1 + 2 * L + K
    s_uacc, s_gall, s_gmod = D, D + 1, D + 1 + L
    s_gcmp, s_bm = D + 1 + L + K, D + 1 + 2 * L + K
    chain = torch.arange(S, device=dev)
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    mu3 = tables.mu.reshape(K, L, D)
    binv4 = tables.binv.reshape(K, L, D, D)
    B4 = tables.B.reshape(K, L, D, D)
    inv_k = torch.tensor(1.0 / K, dtype=f32, device=dev)

    kk = k.long()
    th = [theta[d].clone() for d in range(D)]
    lp = logp.clone()
    pkv = [pk[m].clone() for m in range(K)]
    pkl = pkllim.clone()
    nri = nreinit.clone()
    ks = torch.zeros((K, S), dtype=torch.int32, device=dev)
    ts = torch.zeros((K * D, S), dtype=f32, device=dev)
    tq = torch.zeros((K * D, S), dtype=f32, device=dev)
    cnt = torch.zeros((6, S), dtype=torch.int32, device=dev)

    for tr in range(n_sweeps):
        t = sweep0 + tr
        words = randoms.sweep_words(seed, t, chain, range(NW))
        u = randoms.u01(words)                                  # [NW, S]
        r_bm = torch.sqrt(-2.0 * torch.log1p(-u[s_bm:s_bm + D]))
        ang = _TWO_PI * u[s_bm + D:s_bm + 2 * D]
        z_rwm = r_bm * torch.cos(ang)
        z_lat = r_bm * torch.sin(ang)
        dk = dims[kk]
        active = [dk > d for d in range(D)]
        sig_k = tables.sig[kk]                                  # [S, D]

        # (a) within-model move
        if t % 10 == 0:
            prop = [torch.where(active[d], th[d] + sig_k[:, d] * z_rwm[d],
                                th[d]) for d in range(D)]
            lpn = modelset.logpost_cols(kk, prop)
            acc = (u[0] < _accept(lpn - lp)).to(f32)
            th = [th[d] + acc * (prop[d] - th[d]) for d in range(D)]
            lp = lp + acc * (lpn - lp)
            cnt[0] += acc.to(torch.int32)
            cnt[1] += 1
        else:
            for j in range(D):
                prop = list(th)
                prop[j] = th[j] + sig_k[:, j] * z_rwm[j]
                lpn = modelset.logpost_cols(kk, prop)
                acc = ((u[j] < _accept(lpn - lp)) & active[j]).to(f32)
                th[j] = th[j] + acc * (prop[j] - th[j])
                lp = lp + acc * (lpn - lp)
                cnt[2] += acc.to(torch.int32)
                cnt[3] += active[j].to(torch.int32)

        # (b) reversible jump: forward allocation in the chain's model
        w, quad = _standardize(th, mu3[kk], binv4[kk], dk, D)
        logits = tables.abase[kk] - 0.5 * quad                  # [S, L]
        g_all = randoms.gumbel(u[s_gall:s_gall + L]).T
        l_idx = torch.argmax(logits + g_all, dim=1)   # first max: strict >
        cols = list(logits.unbind(1))
        sel = l_idx[:, None]
        log_palloc = logits.gather(1, sel)[:, 0] - _lse(cols)
        work = [torch.where(active[d], w[d].gather(1, sel)[:, 0],
                            torch.zeros_like(th[d])) for d in range(D)]

        # destination model kn ~ pk, component ln ~ lam[kn]
        if K > 1:
            logpk = torch.log(torch.clamp(torch.stack(pkv), min=1e-38))
            g_mod = randoms.gumbel(u[s_gmod:s_gmod + K])
            kn = torch.argmax(logpk + g_mod, dim=0)
            logratio = (logpk.gather(0, kk[None])[0]
                        - logpk.gather(0, kn[None])[0])
        else:
            kn = kk
            logratio = torch.zeros_like(lp)
        dkn = dims[kn]
        active_n = [dkn > d for d in range(D)]
        g_cmp = randoms.gumbel(u[s_gcmp:s_gcmp + L]).T
        ln = torch.argmax(tables.loglam[kn] + g_cmp, dim=1)

        # latent dimension matching (N(0,1) fill on coords k lacks)
        wf = [torch.where(active[d], work[d], z_lat[d]) for d in range(D)]
        for d in range(D):
            up = ~active[d] & active_n[d]
            lat = -0.5 * wf[d] * wf[d] - HALF_LOG_2PI
            logratio = torch.where(up, logratio - lat, logratio)
        for d in range(D):
            down = active[d] & ~active_n[d]
            lat = -0.5 * wf[d] * wf[d] - HALF_LOG_2PI
            logratio = torch.where(down, logratio + lat, logratio)

        # de-standardize into the destination model
        mu_n = mu3[kn, ln]                                      # [S, D]
        B_n = B4[kn, ln]                                        # [S, D, D]
        thn = []
        for r in range(D):
            a = mu_n[:, r]
            for c in range(r + 1):
                a = a + B_n[:, r, c] * wf[c]
            thn.append(torch.where(active_n[r], a, torch.zeros_like(a)))

        # reverse allocation in the destination model
        _, quad_n = _standardize(thn, mu3[kn], binv4[kn], dkn, D)
        logits_n = tables.abase[kn] - 0.5 * quad_n
        log_pallocn = (logits_n.gather(1, ln[:, None])[:, 0]
                       - _lse(list(logits_n.unbind(1))))

        # accept
        lpn = modelset.logpost_cols(kn, thn)
        ll_kl = tables.loglam[kk, l_idx]
        ll_kln = tables.loglam[kn, ln]
        ld_kl = tables.logdet[kk, l_idx]
        ld_kln = tables.logdet[kn, ln]
        logratio = (logratio + (lpn - lp) + (log_pallocn - log_palloc)
                    + (ll_kl - ll_kln) + (ld_kln - ld_kl))
        accf = (u[s_uacc] < _accept(logratio)).to(f32)
        acci = accf.to(torch.int64)
        kk = kk + acci * (kn - kk)
        th = [th[d] + accf * (thn[d] - th[d]) for d in range(D)]
        lp = lp + accf * (lpn - lp)

        # (c) pk diminishing adaptation with the re-init safeguard
        if adapt and K > 1:
            tf = torch.tensor(float(t), dtype=f32, device=dev)
            gamma = torch.exp((-2.0 / 3.0) * torch.log(tf + 1.0))
            newpk = [pkv[m] + gamma * ((kk == m).to(f32) - pkv[m])
                     for m in range(K)]
            reinit = newpk[0] < pkl
            for m in range(1, K):
                reinit = reinit | (newpk[m] < pkl)
            nri = nri + reinit.to(nri.dtype)
            pkl = torch.where(reinit, 1.0 / (10.0 * nri.to(f32)), pkl)
            rf = reinit.to(f32)
            pkv = [newpk[m] + rf * (inv_k - newpk[m]) for m in range(K)]

        # chunk statistics
        for m in range(K):
            mk = kk == m
            mf = mk.to(f32)
            ks[m] += mk.to(torch.int32)
            for d in range(D):
                ts[m * D + d] += mf * th[d]
                tq[m * D + d] += mf * th[d] * th[d]
        cnt[4] += acci.to(torch.int32)
        cnt[5] += 1

    return (kk.to(torch.int32), torch.stack(th), lp, torch.stack(pkv), pkl,
            nri, ks, ts, tq, cnt)


def sweep_chunk(modelset, k, theta, logp, pk, pkllim, nreinit,
                tables: SweepTables, *, seed: int, sweep0: int,
                n_sweeps: int, adapt: bool):
    """``n_sweeps`` stage-3 sweeps of every chain: the CUDA kernel for
    tensors on the card, its plain twin for tensors on the CPU.  Same
    arguments and results as :func:`sweep_chunk_ref`."""
    if k.device.type == "cpu":
        return sweep_chunk_ref(modelset, k, theta, logp, pk, pkllim, nreinit,
                               tables, seed=seed, sweep0=sweep0,
                               n_sweeps=n_sweeps, adapt=adapt)
    K, D = modelset.nmodels, modelset.dmax
    S = k.shape[0]
    L = tables.loglam.shape[1]
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_chunk: unsupported device {dev}")
    if (K, D) != (3, 2):
        raise ValueError(f"sweep_chunk: kernel instantiated for K=3, D=2 "
                         f"only (got K={K}, D={D})")
    if not 1 <= L <= _MAX_L:
        raise ValueError(f"sweep_chunk: L={L} outside 1..{_MAX_L}")
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("k", k, i32, (S,)), ("theta", theta, f32, (D, S)),
            ("logp", logp, f32, (S,)), ("pk", pk, f32, (K, S)),
            ("pkllim", pkllim, f32, (S,)), ("nreinit", nreinit, i32, (S,))):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"sweep_chunk: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    tab = tables.packed()
    if tab.device != dev or tab.dtype != f32:
        raise ValueError(f"sweep_chunk: tables must be float32 on {dev}")
    kinds, consts, dims = modelset.density_table(dev)
    outs = (torch.empty_like(k), torch.empty_like(theta),
            torch.empty_like(logp), torch.empty_like(pk),
            torch.empty_like(pkllim), torch.empty_like(nreinit),
            torch.empty((K, S), dtype=i32, device=dev),
            torch.empty((K * D, S), dtype=f32, device=dev),
            torch.empty((K * D, S), dtype=f32, device=dev),
            torch.empty((6, S), dtype=i32, device=dev))
    lib = _build.library()
    status = lib.am_fused_sweep(
        K, D, S, L, seed & 0xFFFFFFFF, sweep0, n_sweeps, int(adapt),
        tab.data_ptr(), kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        k.data_ptr(), theta.data_ptr(), logp.data_ptr(), pk.data_ptr(),
        pkllim.data_ptr(), nreinit.data_ptr(),
        *[o.data_ptr() for o in outs],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "am_fused_sweep")
    sweep_chunk.launches += 1
    return outs


sweep_chunk.launches = 0


def build_fused_chunk_runner(modelset, cfg: EngineConfig, burning: bool):
    """``runner(chains, prop, n_sweeps) -> (chains', chunk)`` where
    ``chunk`` holds device tensors: ksummary [K], theta_sum and
    theta_sqsum [K, D], and the six acceptance counters.  pk adapts only
    when ``cfg.adapt`` and not burning."""
    K, D = modelset.nmodels, modelset.dmax
    adapt = cfg.adapt and not burning
    cache = {}

    def tables_for(prop: Proposal) -> SweepTables:
        # one set of tables per installed proposal object
        if cache.get("prop") is not prop:
            cache["prop"] = prop
            cache["tables"] = prep_tables(prop, modelset.dims)
        return cache["tables"]

    def runner(chains: Chains, prop: Proposal, n_sweeps: int):
        outs = sweep_chunk(
            modelset, chains.k, chains.theta.T.contiguous(), chains.logp,
            chains.pk.T.contiguous(), chains.pkllim, chains.nreinit,
            tables_for(prop), seed=int(cfg.seed), sweep0=chains.sweep,
            n_sweeps=n_sweeps, adapt=adapt)
        (k2, th2, lp2, pk2, pkl2, nri2, ks2, ts2, tq2, cnt2) = outs
        chains_out = Chains(k=k2, theta=th2.T.contiguous(), logp=lp2,
                            pk=pk2.T.contiguous(), pkllim=pkl2,
                            nreinit=nri2, sweep=chains.sweep + n_sweeps)
        cnt_tot = cnt2.sum(dim=1, dtype=torch.int64)
        chunk = {
            "ksummary": ks2.sum(dim=1, dtype=torch.int64),
            "theta_sum": ts2.sum(dim=1).reshape(K, D),
            "theta_sqsum": tq2.sum(dim=1).reshape(K, D),
            "naccrwmb": cnt_tot[0], "ntryrwmb": cnt_tot[1],
            "naccrwms": cnt_tot[2], "ntryrwms": cnt_tot[3],
            "nacctd": cnt_tot[4], "ntrytd": cnt_tot[5],
        }
        return chains_out, chunk

    return runner
