#!/usr/bin/env python3
"""Time DDI's cached sweep kernel (K1e) and the general engine's draw
kernel (K4) on one NVIDIA GPU, to compare two versions of the kernel
sources.

Makes DDI's state as ``chip_smoke.py``'s DDI phase does (16384 chains,
512 stage-1 chains per model, 1500 stage-1 sweeps, 500-sweep chunks, seed
0, 500 burn-in sweeps), then times with ``chip_smoke.py``'s own functions
K1e on every chain of that state, 100 sweeps in one launch with pk
adapting, on the hash and the hw stream (K1f), with and without perm, and
K4 at the tutorial's stage-3 shapes (131072 x (25 + 4)) beside
``torch.rand`` + ``torch.randn`` into the same shapes, both called one by
one from Python and replayed from a CUDA graph (device time).  The script
imports the port from the checkout it lies in and builds its kernels
there, so two checkouts are compared by running each one's copy in turn
on one machine (parent, change, change, parent):

    python3 tools/time_k1e_k4.py [--state PATH] [--chains N ...]

With ``--state PATH`` the state is read from PATH where that file exists,
else made and written there, so that every copy times the same chains.
``--chains`` times K1e at each population N (default: the state's 16384),
the state's chains repeated to N; a population above 16896 is more than
one block of 128 chains per SM of an H100.

Prints the card's name and power limit, then one JSON line: K1e's
milliseconds per launch of 100 sweeps by population, stream and perm,
K4's and the library call's milliseconds, and, where the checkout has the
query, the per-chain kernel's resident warps per SM at DDI's fitted L.
"""

import argparse

import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def graph_ms(fn, reps):
    """chip_smoke.graph_ms where the checkout has it, else the same
    replay of one CUDA graph of ``reps`` calls."""
    import torch
    if hasattr(chip_smoke, "graph_ms"):
        return chip_smoke.graph_ms(fn, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return chip_smoke.cuda_ms(graph.replay, 5) / reps


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_k1e_k4: needs an NVIDIA GPU")
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import _build, fused, sweep_rng
    from automix_tpu_torch.models import ddi
    from automix_tpu_torch.state import Chains, Proposal
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(_build.build(), flush=True)
    cs = chip_smoke
    dev = torch.device("cuda", 0)
    ms = ddi.ddi_set()
    ap = argparse.ArgumentParser()
    ap.add_argument("--state")
    ap.add_argument("--chains", type=int, nargs="+")
    opts = ap.parse_args()
    state = opts.state
    if state and os.path.exists(state):
        saved = torch.load(state, map_location=dev)
        ch, prop = Chains(**saved["chains"]), Proposal(**saved["proposal"])
    else:
        am = AMSampler(ms, EngineConfig(
            n_chains=cs.DDI_CHAINS, n_chains_stage1=cs.DDI_C_STAGE1,
            stage1_sweeps=cs.DDI_STAGE1_SWEEPS, sweep_chunk=cs.DDI_CHUNK,
            seed=0, trace_chain0=False, n_trace_chains=1), device="cuda")
        am.estimate_conditional_probs()
        am.burn_samples(cs.DDI_BURN)
        ch, prop = am.chains, am.proposal
        if state:
            torch.save({"chains": dataclasses.asdict(ch),
                        "proposal": dataclasses.asdict(prop)}, state)
    n = cs.TIME_SWEEPS
    tabs = fused.prep_tables(prop, ms.dims)
    k1e = {}
    for S in opts.chains or [ch.n_chains]:
        reps = -(-S // ch.n_chains)
        args = cs.chunk_args(Chains(**{
            f: v if f == "sweep" else torch.cat([v] * reps)[:S]
            for f, v in dataclasses.asdict(ch).items()}))
        for rng in ("hash", "hw"):
            for perm in (False, True):
                k1e[f"{S} {rng}{' perm' if perm else ''}"] = cs.cuda_ms(
                    lambda: fused.sweep_chunk(
                        ms, *args, tabs, seed=11, sweep0=ch.sweep,
                        n_sweeps=n, adapt=True, perm=perm, rng=rng), 3)
    S, MU, MZ = cs.K4_SHAPES[0]

    def draw():
        return sweep_rng.draw(7, 12, 0, S, MU, MZ, dev)

    def library():
        return (torch.rand(S, MU, device=dev), torch.randn(S, MZ, device=dev))

    out = {"sweeps": n, "L": prop.lmax, "k1e_ms": k1e,
           "k4_shape": [S, MU, MZ], "k4_ms": cs.cuda_ms(draw, 200),
           "library_ms": cs.cuda_ms(library, 200),
           "k4_graph_ms": graph_ms(draw, 100),
           "library_graph_ms": graph_ms(library, 100)}
    if hasattr(fused, "occupancy"):
        out["warps_per_sm"] = fused.occupancy(ms, prop.lmax, dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
