"""Run reports: the reference's nine output files.

Counterpart of ``automix_tpu/io/reports.py`` (the reference's
logwrite.c): for a filestem ``<f>`` it writes ``<f>_{mix,log,adapt,cf,k,
lp,pk,ac,theta<k+1>}.data`` with the same names, columns and formats as
the JAX writer.  The per-sweep files are chain 0's traces.
"""

from __future__ import annotations

import numpy as np
import torch

from automix_tpu_torch import diagnostics
from automix_tpu_torch.io.mixfile import write_mix_file


def report_cond_prob_estimation(fname: str, sampler):
    """Stage-1/2 reports: _adapt, _mix, _cf (logwrite.c:111-118)."""
    write_adapt_file(f"{fname}_adapt.data", sampler)
    write_mix_file(f"{fname}_mix.data", sampler.proposal,
                   sampler.modelset.dims)
    write_cf_file(f"{fname}_cf.data", sampler)


def write_adapt_file(path: str, sampler):
    """sig / pooled-acceptance evolution (logwrite.c:142-160)."""
    cp = sampler.cpstats
    dims = sampler.modelset.dims
    with open(path, "w") as f:
        if cp.sig_trace is None:
            return
        for k in range(len(dims)):
            f.write(f"RWM for Model {k + 1}\n")
            for t in range(cp.sig_trace.shape[0]):
                cols = [f"{cp.sig_trace[t, k, i]:f} "
                        f"{cp.accept_trace[t, k, i]:f}"
                        for i in range(dims[k])]
                f.write(" ".join(cols) + " \n")


def write_cf_file(path: str, sampler):
    """EM cost-function evolution (logwrite.c:120-140)."""
    cp = sampler.cpstats
    with open(path, "w") as f:
        if cp.em_trace is None:
            return
        for k in range(sampler.modelset.nmodels):
            f.write(f"RWM for Model {k + 1}\n")
            iters = min(int(cp.em_iters[k]), len(cp.em_trace["Lkk"][k]))
            for i in range(iters):
                f.write(f"{int(cp.em_trace['Lkk'][k][i])} "
                        f"{cp.em_trace['lpn'][k][i]:f} "
                        f"{cp.em_trace['cost'][k][i]:f} "
                        f"{int(cp.em_trace['ann'][k][i])}\n")


def report_rjmcmc_run(fname: str, sampler, mode: int = 0,
                      nsweep2: int = 0, nsweep: int = 0):
    """Stage-3 reports: _pk, _k, _lp, _log, _ac, _theta<k> files
    (logwrite.c:222-233)."""
    st = sampler.stats
    write_pk_file(f"{fname}_pk.data", st)
    write_k_file(f"{fname}_k.data", st)
    write_lp_file(f"{fname}_lp.data", st, sampler)
    sokal = None
    if st.k_trace is not None:
        # tau in sweeps when the trace is decimated
        sokal = diagnostics.sokal_batched(st.k_trace,
                                          stride=st.trace_stride)
    write_log_file(f"{fname}_log.data", sampler, mode, nsweep2,
                   nsweep or st.nsweeps, sokal)
    if sokal is not None:
        write_ac_file(f"{fname}_ac.data", sokal)
    write_theta_files(fname, sampler)


def write_k_file(path: str, st):
    """Model-index trace, 1-based like the reference (automix.c:101)."""
    k0 = st.k0_trace
    with open(path, "w") as f:
        if k0 is None:
            return
        for k in k0:
            f.write(f"{int(k) + 1}\n")


def write_lp_file(path: str, st, sampler=None):
    """Log-posterior trace (logwrite.c:162-172): lp and the model's
    ``loglik`` on chain 0's trace when every model has one, else lp
    twice (the reference library's behaviour)."""
    lp = st.logp_trace
    llh = _loglik_trace(st, sampler) if sampler is not None else None
    with open(path, "w") as f:
        if lp is None:
            return
        if llh is None:
            llh = lp
        for v, w in zip(lp, llh):
            f.write(f"{v:f} {w:f}\n")


def _loglik_trace(st, sampler):
    """[n_entries] likelihood trace of chain 0 from ``Model.loglik``;
    None unless every model has one."""
    models = sampler.modelset.models
    if (st.k0_trace is None or st.theta0_trace is None
            or any(m.loglik is None for m in models)):
        return None
    k0 = np.asarray(st.k0_trace).astype(np.int64).reshape(-1)
    th = torch.tensor(st.theta0_trace, dtype=torch.float32)
    out = np.zeros(k0.shape[0], np.float64)
    for k, m in enumerate(models):
        sel = k0 == k
        if sel.any():
            rows = list(th[torch.from_numpy(sel)].T[:m.dim])
            out[sel] = m.loglik(rows).numpy()
    return out


def write_pk_file(path: str, st):
    """pk evolution (logwrite.c:186-200)."""
    pk = st.pk_trace
    with open(path, "w") as f:
        if pk is None:
            return
        for row in pk:
            f.write(" ".join(f"{v:f}" for v in row) + " \n")


def write_ac_file(path: str, sokal):
    """Autocorrelation coefficients of chain 0 up to the Sokal truncation
    (logwrite.c:235-245)."""
    rho = np.asarray(sokal["rho"])[0]
    m = int(np.asarray(sokal["m"]).reshape(-1)[0])
    with open(path, "w") as f:
        for i in range(m):
            f.write(f"{rho[i]:f}\n")


def write_theta_files(fname: str, sampler):
    """Per-model theta traces from chain 0 (logwrite.c:202-220)."""
    st = sampler.stats
    if st.k0_trace is None or st.theta0_trace is None:
        return
    dims = sampler.modelset.dims
    k0 = np.asarray(st.k0_trace)
    th = np.asarray(st.theta0_trace)
    for k in range(len(dims)):
        rows = th[k0 == k][:, : dims[k]]
        with open(f"{fname}_theta{k + 1}.data", "w") as f:
            for row in rows:
                f.write(" ".join(f"{v:f}" for v in row) + " \n")


def write_log_file(path: str, sampler, mode: int, nsweep2: int, nsweep: int,
                   sokal=None):
    """The summary log (logwrite.c:279-344): options, fitted proposal,
    autocorrelation time, posterior model probabilities, acceptance rates,
    run time."""
    st = sampler.stats
    cfg = sampler.cfg
    jd = sampler.proposal
    dims = sampler.modelset.dims
    lam = jd.lam.cpu().numpy()
    mu = jd.mu.cpu().numpy()
    B = jd.B.cpu().numpy()
    sig = jd.sig.cpu().numpy()
    rates = diagnostics.acceptance_rates(st)
    with open(path, "w") as f:
        f.write(f"seed: {cfg.seed}\n")
        f.write(f"m: {mode}\n")
        f.write(f"a: {int(cfg.adapt)}\n")
        f.write(f"p: {int(cfg.perm)}\n")
        f.write(f"n: {nsweep2}\n")
        f.write(f"N: {nsweep}\n")
        f.write(f"chains: {st.n_chains}\n")
        for k in range(len(dims)):
            f.write(f"\nModel:{k + 1}\n")
            live = np.nonzero(lam[k] > 0)[0]
            f.write("\nARW params:\n")
            f.write(" ".join(f"{sig[k, j]:f}" for j in range(dims[k]))
                    + " \n")
            f.write(f"\nLkk:{len(live)}\n")
            for idx, l in enumerate(live):
                f.write(f"\nComponent:{idx + 1}\n")
                f.write(f"lambda:{lam[k, l]:f}\n")
                f.write("mu:\n")
                f.write(" ".join(f"{mu[k, l, j]:f}"
                                 for j in range(dims[k])) + " \n")
                f.write("B:\n")
                for i in range(dims[k]):
                    f.write(" ".join(f"{B[k, l, i, j]:f}"
                                     for j in range(i + 1)) + " \n")
        f.write("\nAutocorrelation Time:\n")
        if sokal is not None:
            # nkeep entries, nsokal sweeps between them, tau in sweeps
            f.write(f"nkeep:{sokal['nkeep']}, "
                    f"nsokal:{sokal.get('stride', 1)}, "
                    f"var:{float(np.asarray(sokal['var']).reshape(-1)[0]):f}, "
                    f"tau:{sokal['tau_mean']:f}\n")
        else:
            f.write("nkeep:0, nsokal:1, var:nan, tau:nan\n")
        f.write("\nPosterior Model Probabilities:\n")
        probs = st.model_probs
        for k in range(len(dims)):
            f.write(f"Model {k + 1}: {probs[k]:f}\n")
        f.write("\nAcceptance Rates:\n")
        f.write(f"Block RWM: {rates['block_rwm']:f}\n")
        f.write(f"Single RWM: {rates['single_rwm']:f}\n")
        f.write(f"Auto RJ: {rates['rj']:f}\n")
        f.write("\nRun time:\n")
        f.write(f"Time: {st.timesecs_burn + st.timesecs_rjmcmc:f}\n")
