#!/usr/bin/env python3
"""Time the stage-3 sweep kernel (K1) on rb9 on one NVIDIA GPU, to compare
two versions of the kernel source.

Fits rb9's proposal as ``chip_smoke.py``'s rb9 phase does (1024 stage-1
chains per model, 2000 stage-1 sweeps, lmax 30, seed 0), makes the state
of its K1 check (131072 chains, 200 burn-in sweeps, seed 7) and times K1
there with ``chip_smoke.py``'s own functions: 100 sweeps in one launch
with pk adapting, and 100 sweeps with pk frozen run as launches of 1, 10
and 100 sweeps.  The script imports the port from the checkout it lies
in and builds its kernels there, so two checkouts are compared by running
each one's copy in turn on one machine:

    python3 tools/time_rb9_sweeps.py

Prints the card's name and power limit, then one JSON line: milliseconds
per sweep, and K1c's co-residency bound at the fitted L.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_rb9_sweeps: needs an NVIDIA GPU")
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import _build, fused
    from automix_tpu_torch.models.rb9 import rb9_set
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(_build.build(), flush=True)
    ms = rb9_set()
    fit = AMSampler(ms, EngineConfig(
        n_chains_stage1=chip_smoke.RB9_C_STAGE1,
        stage1_sweeps=chip_smoke.STAGE1_SWEEPS,
        max_mix_comps=chip_smoke.RB9_MAX_MIX, seed=0), device="cuda")
    fit.estimate_conditional_probs()
    prop = fit.proposal
    am = AMSampler(ms, EngineConfig(n_chains=chip_smoke.N_CHAINS, seed=7,
                                    trace_chain0=False), device="cuda")
    am.set_proposal(prop)
    am.burn_samples(200)
    ch, n = am.chains, chip_smoke.TIME_SWEEPS
    tabs = fused.prep_tables(prop, ms.dims)
    full = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit)
    adapting = chip_smoke.cuda_ms(lambda: fused.sweep_chunk(
        ms, *full, tabs, seed=11, sweep0=ch.sweep, n_sweeps=n,
        adapt=True), 5) / n
    frozen = chip_smoke.launch_lengths(ms, prop, ch)
    print(json.dumps({
        "L": prop.lmax, "chains": ch.n_chains,
        "ms_per_sweep_adapting": adapting,
        "ms_per_sweep_frozen_by_launch_length": frozen,
        "k1c_capacity": fused.pooled_capacity(ms, prop.lmax, ch.k.device),
    }), flush=True)


if __name__ == "__main__":
    main()
