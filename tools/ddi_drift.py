#!/usr/bin/env python3
"""Show where DDI's carried logp drifts, and why, on one NVIDIA GPU.

Runs DDI through ``AMSampler`` exactly as ``chip_smoke.py``'s DDI phase
does (16384 chains, seed 0, 500 burn-in and 10000 sweeps), then reads the
carried logp against a fresh evaluation through refresh windows of 16
sweeps (``chip_smoke.drift_readings``), per class of chain: those that
entered the 16-dim model by a jump within the window, and the others.
Each window is read twice, each run in its own line of windows from the
run's state:

- the sweep kernel K1e, whose jump blends the statistics as the JAX kernel
  does, c + (cn - c) (automix_tpu/kernels/fused.py:748);
- the plain twin ``sweep_chunk_ref`` changed so that every accepted
  evaluation of the statistics from scratch (the block move and the jump)
  stores them as they are, cn.

It also prints, at the run's state, the largest model-1 (16-dim) statistic
of the chains in each model and the range of coordinates 6-8, which are
model 1's alpha but model 2's precisions.  Run from the checkout:

    python3 tools/ddi_drift.py [--windows N]

Prints the card's name and power limit, a line per reading, and one JSON
line of every reading last.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


class _Fresh(tuple):
    """Statistics evaluated from scratch (marks them for the blend)."""


class _MarkingDensity:
    """The DDI density with ``full``'s statistics marked as fresh."""

    def __init__(self, density):
        self.density = density
        self.n_cache = density.n_cache

    def full(self, k, rows):
        lp, cache = self.density.full(k, rows)
        return lp, _Fresh(cache)

    def coord(self, j, k, rows, old_j, cache):
        return self.density.coord(j, k, rows, old_j, cache)


def twin_storing_fresh(ms, *args, **kw):
    """``sweep_chunk_ref`` in which an accepted evaluation from scratch
    stores its statistics cn in place of c + (cn - c)."""
    import torch
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.model import ModelSet
    blend = fused._blend

    def store(cache, cache_n, acc):
        if not isinstance(cache_n, _Fresh):
            return blend(cache, cache_n, acc)
        keep = (acc > 0)[None, :]
        return tuple(torch.where(keep, torch.stack(cache_n),
                                 torch.stack(cache)).unbind(0))

    marked = ModelSet(ms.models,
                      batched_logpost_cols=ms.batched_logpost_cols,
                      fused_density=_MarkingDensity(ms.fused_density))
    fused._blend = store
    try:
        return fused.sweep_chunk_ref(marked, *args, **kw)
    finally:
        fused._blend = blend


def main():
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--windows", type=int, default=3)
    windows = parser.parse_args().windows
    if not torch.cuda.is_available():
        sys.exit("ddi_drift: needs an NVIDIA GPU")
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import _build, fused
    from automix_tpu_torch.models import ddi
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(_build.build(), flush=True)
    ms = ddi.ddi_set()
    am = AMSampler(ms, EngineConfig(
        n_chains=chip_smoke.DDI_CHAINS,
        n_chains_stage1=chip_smoke.DDI_C_STAGE1,
        stage1_sweeps=chip_smoke.DDI_STAGE1_SWEEPS,
        sweep_chunk=chip_smoke.DDI_CHUNK, seed=0, trace_chain0=False,
        n_trace_chains=1), device="cuda")
    am.estimate_conditional_probs()
    am.burn_samples(chip_smoke.DDI_BURN)
    am.rjmcmc_samples(chip_smoke.DDI_TIMED)
    ch, prop = am.chains, am.proposal
    tabs = fused.prep_tables(prop, ms.dims)

    dens = ddi.ddi_density()
    n0 = dens.parts[0].n_cols
    stats0 = torch.stack(dens.full(ch.k.long(), list(ch.theta.T))[1][:n0])
    record = {"stats": {}, "kernel": [], "twin_storing_fresh": []}
    for m in range(2):
        sel = ch.k == m
        top = float(stats0[:, sel].abs().max())
        th = ch.theta[sel][:, 6:9]
        record["stats"][f"model {m + 1}"] = {
            "chains": int(sel.sum()), "max_abs_model1_stat": top,
            "theta6_8_min": th.min(0).values.tolist(),
            "theta6_8_max": th.max(0).values.tolist()}
    record["stats"]["model1_alpha_hat_6_8"] = dens.parts[0].alpha_hat[6:9]
    print(json.dumps(record["stats"]), flush=True)

    start = chip_smoke.chunk_args(ch)
    start = (start[0], start[1],
             ms.logpost_cols(start[0].long(), list(start[1])), *start[3:])
    s0 = ch.sweep + (-ch.sweep) % 16
    for name, fn in (("kernel", fused.sweep_chunk),
                     ("twin_storing_fresh", twin_storing_fresh)):
        state = start
        for w in range(windows):
            out, rows = chip_smoke.drift_readings(ms, tabs, state,
                                                  s0 + 16 * w, fn)
            record[name].append(rows)
            print(f"{name} window {w} from sweep {s0 + 16 * w}, max|diff| "
                  "after 1..16 sweeps, chains that entered the 16-dim "
                  "model (their number) / the others: "
                  + " ".join(f"{a:.3e} ({c}) / {b:.3e}"
                             for a, c, b in rows), flush=True)
            state = out[:6]
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
