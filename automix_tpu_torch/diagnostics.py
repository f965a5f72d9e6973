"""Run diagnostics: Sokal integrated autocorrelation time, split-R-hat,
ESS and acceptance rates.

Counterpart of ``automix_tpu/diagnostics.py``, with ``torch.fft`` for the
periodogram.  The reference's convention holds: tau is the sum of the
autocorrelation function over all lags (logwrite.c:354-403), estimated
with Sokal's adaptive truncation, vectorized over chains.
"""

from __future__ import annotations

import numpy as np
import torch


def sokal_iact(x):
    """IACT of series ``x`` [..., n] (n >= 4) in float32.  Returns (tau,
    var, m, rho) as tensors.

    Power spectrum with the DC term removed, transformed back to
    autocovariances (the reference applies its forward transform twice,
    which for the real, symmetric spectrum equals n * ifft), then Sokal's
    truncation: stop at the first lag i where -1/3 + sum_{j<=i}(rho_j -
    1/6) < 0, with tau = 2 (sum + i/6) and m = i + 1 coefficients."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[-1]
    p = torch.abs(torch.fft.fft(x)) ** 2
    p[..., 0] = 0.0
    a = torch.real(torch.fft.fft(p))
    var = a[..., 0] / (n * (n - 1.0))
    rho = a / torch.clamp(a[..., 0:1], min=1e-30)
    partial = torch.cumsum(rho - 1.0 / 6.0, dim=-1) - 1.0 / 3.0
    hit = partial < 0.0
    i = torch.where(hit.any(dim=-1), torch.argmax(hit.to(torch.int8), -1),
                    n - 1)
    s_i = torch.gather(partial, -1, i[..., None])[..., 0]
    tau = 2.0 * (s_i + i / 6.0)
    return tau, var, i + 1, rho


def sokal_batched(traces, stride: int = 1):
    """IACT over a [nsweep, n_chains] batch of model-index traces, on the
    last power-of-two entries (at most 2^20).  ``stride`` is the number of
    sweeps between trace entries (``RunStats.trace_stride``); tau is
    reported in sweeps, ``rho`` and ``m`` in entries."""
    traces = np.asarray(traces, np.float32)
    if traces.ndim == 1:
        traces = traces[:, None]
    n = traces.shape[0]
    nkeep = 1 << min(20, int(np.log2(max(n, 4))))
    x = torch.from_numpy(np.ascontiguousarray(traces[n - nkeep:].T))
    tau, var, m, rho = sokal_iact(x)
    tau = tau.numpy() * stride
    return {
        "tau": tau,
        "tau_mean": float(tau.mean()),
        "tau_median": float(np.median(tau)),
        "var": var.numpy(),
        "m": m.numpy(),
        "rho": rho.numpy(),
        "nkeep": nkeep,
        "stride": stride,
    }


def split_rhat(traces):
    """Split-R-hat over a [nsweep, n_chains] trace batch: each chain's
    trace is halved, and R-hat = sqrt((n-1)/n + B/(n W)) compares the
    between-half and within-half variances."""
    x = np.asarray(traces, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = (x.shape[0] // 2) * 2
    halves = x[:n].T.reshape(-1, 2, n // 2).reshape(-1, n // 2)
    hn = halves.shape[1]
    means = halves.mean(axis=1)
    w = halves.var(axis=1, ddof=1).mean()
    b = hn * means.var(ddof=1)
    if w <= 0.0:
        return 1.0 if b <= 0.0 else float("inf")
    return float(np.sqrt((hn - 1) / hn + b / (hn * w)))


def ess(traces, stride: int = 1):
    """Cross-chain effective sample size: total sweeps over the mean
    Sokal tau in sweeps (at least ``stride`` and 1)."""
    x = np.asarray(traces)
    if x.ndim == 1:
        x = x[:, None]
    res = sokal_batched(x, stride=stride)
    total = x.shape[0] * stride * x.shape[1]
    return total / max(res["tau_mean"], float(stride), 1.0)


def acceptance_rates(stats):
    """Acceptance-rate summary, the `_log.data` block (logwrite.c:334-339)."""
    def rate(a, b):
        return a / b if b else float("nan")

    return {
        "block_rwm": rate(stats.naccrwmb, stats.ntryrwmb),
        "single_rwm": rate(stats.naccrwms, stats.ntryrwms),
        "rj": rate(stats.nacctd, stats.ntrytd),
    }
