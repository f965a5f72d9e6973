"""The port across several devices against the same run on one device.

Run with one process a device, under ``torchrun`` (NCCL on cards, gloo
on the CPU); every rank joins with ``multihost.initialize()`` and the
mesh spans them all.  On the tutorial (the main path's set, its
``fused_rng="hash"`` kernels):

* stage 1 across the mesh (the one-sweep kernel K3 in its moves-only
  mode at each rank's chain base, the counts summed every sweep) against
  rank 0's stage 1 on its device alone (the segment kernel K2 where the
  card holds the population): sig bitwise;
* the AutoRJ fit (one Normal a model, the samples gathered) of the
  sharded samples, the same on every rank;
* stage 3 across the mesh, burn-in and timed sweeps with per-chain pk
  (the sweep kernel at each rank's chain base) and a pooled run (the
  one-sweep route, the visit histogram summed every sweep), each against
  rank 0's run of the same configuration on its device alone: the
  gathered chains and ksummary bitwise, and chain-sweeps/s of both.

Prints one JSON line on rank 0 and exits non-zero if any comparison
fails.  On four cards of one host::

    torchrun --nproc_per_node=4 tools/mesh_check.py

(on the CPU, for a rehearsal: ``--chains 2048 --stage1-chains 64
--stage1-sweeps 100 --burn 20 --sweeps 40 --pooled-sweeps 20``).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=131072)
    ap.add_argument("--stage1-chains", type=int, default=1024)
    ap.add_argument("--stage1-sweeps", type=int, default=2000)
    ap.add_argument("--burn", type=int, default=1000)
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--pooled-sweeps", type=int, default=1000)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import em, fused, fused_stage1, rwm
    from automix_tpu_torch.models.tutorial import tutorial_set
    from automix_tpu_torch.ops import randoms
    from automix_tpu_torch.parallel import mesh as mesh_lib
    from automix_tpu_torch.parallel import multihost

    multihost.initialize()
    mesh = multihost.make_global_mesh()
    primary = multihost.is_primary()
    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dist.barrier()
        return out, time.perf_counter() - t0

    ms = tutorial_set()
    cfg = EngineConfig(n_chains=args.chains,
                       n_chains_stage1=args.stage1_chains,
                       stage1_sweeps=args.stage1_sweeps, sweep_chunk=1000,
                       seed=0, fused_rng="hash", mix_fit="autorj",
                       trace_chain0=False, n_trace_chains=1)
    out = {"world": mesh.size, "backend": dist.get_backend(),
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    ok = True
    # the AMSampler's stage-1 key (its first)
    _, k1 = randoms.split_host(randoms.key(cfg.seed), 2)
    (sig, samples, _), out["stage1_mesh_s"] = timed(lambda: rwm.run_stage1(
        ms, cfg, k1, args.stage1_sweeps, dev, mesh=mesh))
    prop, _ = em.fit_proposal(ms, cfg, samples, sig, mesh=mesh)
    same = all(torch.equal(x, mesh_lib.broadcast(x, mesh)) for x in (
        prop.mu, prop.B, sig))
    ok &= bool(mesh_lib.all_reduce_sum(torch.tensor(
        [int(not same)], device=dev), mesh).item() == 0)
    if primary:
        t0 = time.perf_counter()
        sig1, samples1, _ = rwm.run_stage1(ms, cfg, k1, args.stage1_sweeps,
                                           dev)
        sync()
        out["stage1_one_s"] = time.perf_counter() - t0
        out["stage1_sig_bitwise"] = torch.equal(sig, sig1)
        ok &= out["stage1_sig_bitwise"]
    gathered = mesh_lib.all_gather(samples, mesh, dim=1)
    if primary:
        out["samples_bitwise"] = torch.equal(gathered, samples1)
        ok &= out["samples_bitwise"]

    for label, extra, n in (("per_chain", {}, args.sweeps),
                            ("pooled", {"pk_mode": "pooled"},
                             args.pooled_sweeps)):
        run_cfg = dataclasses.replace(cfg, **extra)
        sh = AMSampler(ms, run_cfg, mesh=mesh)
        sh.set_proposal(prop)
        _, burn_s = timed(lambda: sh.burn_samples(args.burn))
        stats, secs = timed(lambda: sh.rjmcmc_samples(n))
        chains = mesh_lib.gather_chains(sh.chains, mesh)
        rec = {"burn_s": burn_s, "timed_s": secs,
               "chain_sweeps_per_s": args.chains * n / secs,
               "model_probs": [round(float(p), 4)
                               for p in stats.model_probs]}
        if primary:
            ref = AMSampler(ms, run_cfg, device=dev)
            ref.set_proposal(prop)
            ref.burn_samples(args.burn)
            sync()
            t0 = time.perf_counter()
            rstats = ref.rjmcmc_samples(n)
            sync()
            one = time.perf_counter() - t0
            rec["one_device_timed_s"] = one
            rec["one_device_chain_sweeps_per_s"] = args.chains * n / one
            rec["bitwise"] = bool(
                all(torch.equal(getattr(chains, f), getattr(ref.chains, f))
                    for f in ("k", "theta", "logp", "pk", "pkllim",
                              "nreinit"))
                and np.array_equal(stats.ksummary, rstats.ksummary))
            ok &= rec["bitwise"]
        out[label] = rec
        dist.barrier()
    out["launches"] = {"K1": fused.sweep_chunk.launches,
                       "K3": fused_stage1.sweep.launches,
                       "K2": fused_stage1.segment.launches}
    out["ok"] = bool(ok)
    if primary:
        print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
