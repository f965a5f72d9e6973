"""Command-line entry point of the port: the counterpart of the reference CLI.

Counterpart of ``automix_tpu/cli.py``, with the same flags and defaults
(-m/-N/-n/-a/-p/-s/-t/-b/-f, --chains, --chains-stage1, --trace-every,
--no-reports, --checkpoint-every, --resume).  ``--device`` (cuda or cpu,
default cuda) takes the place of ``--platform``; without CUDA,
``--device cuda`` raises.  The JAX engine switches (--fused,
--fused-stage1) have no counterpart: the port always runs its kernels,
so traces default to every 16th sweep.

    python -m automix_tpu_torch.cli toy2 --chains 131072 -N 20000 -s 1

Modes (-m): 0 = full pipeline with mixture fitting, 1 = resume stage 3
from a ``<f>_mix.data`` proposal file, 2 = AutoRJ single-Normal fit.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

# Problems of the JAX registry whose densities are not ported yet, with
# the ROADMAP item that ports them.
_NOT_PORTED = {
    "cpt": "D5 (change-point densities)",
    "cptrs": "D5 (change-point densities)",
    "rb9": "D3 (the rb9 family density)",
    "ddi": "D4 (the DDI density)",
}


def _problem_registry():
    from automix_tpu_torch.models import builtin, toy, tutorial

    return {
        "tutorial": tutorial.tutorial_set,
        "toy1": toy.toy1_set,
        "toy2": toy.toy2_set,
        "normal": builtin.normal_sampler_set,
        "truncnormal": builtin.truncnormal_sampler_set,
        "beta": builtin.beta_sampler_set,
        "normal_params": builtin.normal_params_set,
        "beta_params": builtin.beta_params_set,
        "gamma_params": builtin.gamma_params_set,
        "gamma_beta": builtin.gamma_beta_set,
        "normal_beta": builtin.normal_beta_set,
        "normal_gamma": builtin.normal_gamma_set,
    }


def _resolve_problem(name: str):
    reg = _problem_registry()
    if name in reg:
        return reg[name]
    if name in _NOT_PORTED:
        raise SystemExit(
            f"problem {name!r} is not ported to automix_tpu_torch yet "
            f"(ROADMAP queue 2, {_NOT_PORTED[name]})")
    if ":" in name:
        mod, fn = name.split(":", 1)
        return getattr(importlib.import_module(mod), fn)
    raise SystemExit(
        f"unknown problem {name!r}; built-ins: {', '.join(sorted(reg))} "
        f"(or use module:function)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m automix_tpu_torch.cli",
        description="automatic RJMCMC sampler (PyTorch + CUDA port)")
    p.add_argument("problem", help="built-in problem name or module:function")
    p.add_argument("-m", "--mode", type=int, default=0, choices=(0, 1, 2),
                   help="0 mixture fitting, 1 load mixture params from "
                        "<f>_mix.data, 2 AutoRJ")
    p.add_argument("-N", "--nsweep", type=int, default=100_000,
                   help="reversible-jump sweeps in stage 3")
    p.add_argument("-n", "--nsweep2", type=int, default=None,
                   help="stage-1 adaptation sweeps (default: the engine's "
                        "stage1_sweeps)")
    p.add_argument("-a", "--adapt", type=int, default=1,
                   help="1 to adapt pk in stage 3")
    p.add_argument("-p", "--perm", type=int, default=1,
                   help="1 to permute the RJ latent (CLI default 1)")
    p.add_argument("-s", "--seed", type=int, default=0,
                   help="random seed; 0 seeds from the clock")
    p.add_argument("-t", "--dof", type=int, default=0,
                   help="Student-t dof for RWM/RJ perturbations; 0 = Normal")
    p.add_argument("-b", "--nburn", type=int, default=-1,
                   help="burn-in sweeps; default max(N/10, 10000)")
    p.add_argument("-f", "--fname", default="output", help="output filestem")
    p.add_argument("--chains", type=int, default=4096,
                   help="parallel stage-3 chains")
    p.add_argument("--chains-stage1", type=int, default=2048)
    p.add_argument("--trace-every", type=int, default=16,
                   help="record traces every Nth sweep (1 = every sweep)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the kernels (raises without CUDA); cpu "
                        "runs their plain PyTorch versions")
    p.add_argument("--no-reports", action="store_true",
                   help="skip writing the output files")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a full-state checkpoint to <f>_ckpt.npz "
                        "after burn-in and then every N production sweeps "
                        "(0 disables)")
    p.add_argument("--resume", action="store_true",
                   help="resume a killed run from <f>_ckpt.npz: stages 1-2 "
                        "and completed sweeps are skipped and trajectories "
                        "continue exactly")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from automix_tpu_torch.config import (AUTORJ_MIX_FIT, EngineConfig,
                                          FIGUEIREDO_MIX_FIT)
    from automix_tpu_torch.io import mixfile, reports
    from automix_tpu_torch.sampler import AMSampler

    t0 = time.perf_counter()
    seed = args.seed if args.seed != 0 else int(time.time()) & 0x7FFFFFFF
    nburn = args.nburn
    if nburn < 0:
        nburn = max(args.nsweep // 10, 10_000)

    cfg = EngineConfig(
        seed=seed,
        adapt=bool(args.adapt),
        perm=bool(args.perm),
        student_t_dof=args.dof,
        mix_fit=AUTORJ_MIX_FIT if args.mode == 2 else FIGUEIREDO_MIX_FIT,
        n_chains=args.chains,
        n_chains_stage1=args.chains_stage1,
        trace_every=args.trace_every,
    )
    modelset = _resolve_problem(args.problem)()
    if args.trace_every > 1:
        print(f"Tracing every {args.trace_every}th sweep (pass "
              f"--trace-every 1 for per-sweep traces).")
    am = AMSampler(modelset, cfg, device=args.device)

    ckpt_path = f"{args.fname}_ckpt.npz"
    resumed = False
    if args.resume:
        if os.path.exists(ckpt_path):
            am.load(ckpt_path)
            resumed = am.chains is not None
            done = am.stats.nsweeps if am.stats is not None else 0
            print(f"Resumed from {ckpt_path}: "
                  f"{done}/{args.nsweep} production sweeps done.")
        else:
            print(f"No checkpoint at {ckpt_path}; starting fresh.")

    if resumed:
        pass        # proposal, chains and statistics restored above
    elif args.mode == 1:
        print("Reading parameters from mix file.")
        prop = mixfile.read_mix_file(
            f"{args.fname}_mix.data", modelset.dims,
            lmax=cfg.max_mix_comps, dmax=modelset.dmax)
        am.set_proposal(prop)
    else:
        nsweep2 = args.nsweep2
        print(f"Adapting proposals "
              f"({nsweep2 or cfg.stage1_sweeps} sweeps x "
              f"{cfg.n_chains_stage1} chains/model).")
        am.estimate_conditional_probs(nsweep2)
        if not args.no_reports:
            reports.report_cond_prob_estimation(args.fname, am)

    every = args.checkpoint_every
    if not resumed or am.stats is None:
        print(f"Burning in {nburn} sweeps.")
        am.burn_samples(nburn)
        if every:
            am.save(ckpt_path)
    print(f"Sampling {args.nsweep} sweeps x {args.chains} chains.")
    # stage 3 in checkpoint-aligned blocks: a kill loses at most the
    # current block, and --resume continues the exact trajectories
    done = am.stats.nsweeps if (resumed and am.stats is not None) else 0
    while done < args.nsweep:
        n = min(every, args.nsweep - done) if every else args.nsweep - done
        stats = am.rjmcmc_samples(n)
        done = stats.nsweeps
        if every:
            am.save(ckpt_path)
    stats = am.stats

    probs = stats.model_probs
    for k in range(modelset.nmodels):
        print(f"p(M={k + 1}|E) = {probs[k]:.6f}")
    if not args.no_reports:
        reports.report_rjmcmc_run(args.fname, am, mode=args.mode,
                                  nsweep2=args.nsweep2 or cfg.stage1_sweeps,
                                  nsweep=args.nsweep)
    agg = stats.n_chains * stats.nsweeps / max(stats.timesecs_rjmcmc, 1e-9)
    print(f"Stage-3 throughput: {agg:,.0f} chain-sweeps/s")
    print(f"Time: conditional-probability estimation "
          f"{am.cpstats.timesecs_condprobs:.3f} sec, "
          f"burn-in {stats.timesecs_burn:.3f} sec, "
          f"rjmcmc {stats.timesecs_rjmcmc:.3f} sec.")
    print(f"Total time elapsed: {time.perf_counter() - t0:.3f} sec.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
