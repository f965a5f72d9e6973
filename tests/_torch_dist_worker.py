"""One rank of a gloo world for the port's several-device tests, and the
cases those tests hold to the runs on one device.

Each case is a function ``case(mesh, inputs) -> dict`` of tensors, numpy
arrays and numbers: with a ``ChainMesh`` it runs this rank's part of a
sharded run and returns what the whole run would (global statistics,
gathered chains), with ``mesh=None`` the same run on one device, which
the parent test computes as the reference.  ``inputs`` holds the arrays
the parent wrote (the JAX package's start chains and seeding indices);
this module imports no JAX.

    python tests/_torch_dist_worker.py RANK WORLD PORT IN_DIR OUT_DIR CASES

runs the comma-separated CASES in order and writes ``OUT_DIR/rank<R>.pt``:
{case: result, or {"error": traceback}}.
"""

import os
import sys
import traceback

import numpy as np
import torch

from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import chains_from_numpy, proposal_from_numpy
from automix_tpu_torch.kernels import em, fused, hmc, rjmcmc, rwm, smc
from automix_tpu_torch.models import builtin, toy, tutorial
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.parallel import mesh as mesh_lib

STAGE1 = dict(n_chains_stage1=64, stage1_sweeps=100,
              stage1_target_samples=256, seed=5)


def _gather_chains(chains, mesh):
    ch = mesh_lib.gather_chains(chains, mesh)
    return {f: getattr(ch, f) for f in ("k", "theta", "logp", "pk",
                                        "pkllim", "nreinit")}


def _tutorial_proposal():
    """A fixed proposal near the tutorial's posterior (two components a
    model), the tables of tests/test_torch_general.py's ``_proposal``."""
    modes = np.float32([[0.26, 0.38], [2.2, 4.0], [3.0, 8.0]])
    scale = np.float32([[0.06, 0.08], [0.8, 1.5], [1.0, 2.5]])
    K, L, D = 3, 2, 2
    lam = np.full((K, L), 0.5, np.float32)
    mu = np.stack([modes * 0.9, modes * 1.1], axis=1)
    B = np.zeros((K, L, D, D), np.float32)
    for k in range(K):
        for li, f in enumerate((1.0, 1.5)):
            B[k, li] = np.diag(scale[k] * f)
            B[k, li, 1, 0] = 0.1 * scale[k, 1]
    logdet = np.log(np.abs(np.diagonal(B, axis1=-2, axis2=-1))).sum(-1)
    return proposal_from_numpy(lam, mu, B, logdet.astype(np.float32),
                               np.full(K, L, np.int32), scale)


def _toy1_proposal():
    """toy1's seeded proposal of tests/test_torch_smc.py."""
    K, L, D = 2, 3, 2
    lam = np.float32([[0.2, 0.8, 0.0], [1 / 3, 1 / 3, 1 / 3]])
    mu = np.float32([[[-3, 0], [2, 0], [0, 0]], [[0, 3], [-4, 1], [4, 1]]])
    B = np.tile(np.eye(D, dtype=np.float32), (K, L, 1, 1)) * 1.2
    B[0, :, 1, 1] = 1.0
    logdet = np.log(np.abs(np.diagonal(B, axis1=-2, axis2=-1)))
    logdet = (logdet * (np.arange(D) < np.array([1, 2])[:, None, None])
              ).sum(-1).astype(np.float32)
    return proposal_from_numpy(lam, mu, B, logdet, np.int32([2, 3]),
                               np.float32([[1.5, 1.0], [2.0, 2.0]]))


def _stage1(mesh, fused_stage1):
    cfg = EngineConfig(fused_stage1=fused_stage1, **STAGE1)
    sig, samples, tele = rwm.run_stage1(
        tutorial.tutorial_set(), cfg, randoms.key(11),
        STAGE1["stage1_sweeps"], "cpu", mesh=mesh)
    return {"sig": sig, "samples": mesh_lib.all_gather(samples, mesh, 1),
            "samples_local": samples,
            "sig_trace": tele["sig_trace"],
            "accept_trace": tele["accept_trace"],
            "final_logp": mesh_lib.all_gather(tele["final_logp"], mesh, 1)}


def case_stage1_kernels(mesh, inputs):
    """Stage 1 on the kernels' twins: under a mesh the one-sweep route
    (K3's twin moves only at each rank's chain base, the counts summed,
    then pooled_update), on one device the segment runner."""
    return _stage1(mesh, "auto")


def case_stage1_general(mesh, inputs):
    """Stage 1 on the general engine (threefry keys split per model)."""
    return _stage1(mesh, "off")


def _em_samples():
    """Three 2-D sample sets of mixtures with 1, 2 and 3 modes (tests/
    test_torch_em.py's ``_samples``), [3, 512, 2]."""
    rng = np.random.default_rng(3)
    out = []
    for nmodes in (1, 2, 3):
        centers = rng.uniform(-6, 6, size=(nmodes, 2))
        comp = rng.integers(0, nmodes, size=512)
        scale = rng.uniform(0.3, 1.0, size=(nmodes, 2))
        out.append(centers[comp] + rng.normal(size=(512, 2)) * scale[comp])
    return torch.tensor(np.stack(out), dtype=torch.float32)


def case_em(mesh, inputs):
    """The EM on [3, 512, 2] samples split along the sample axis, seeded
    with the JAX package's indices of its key 9 (``inputs``)."""
    x = _em_samples()
    if mesh is not None:
        n = mesh.local(x.shape[1], "samples")
        x = x[:, mesh.rank * n:(mesh.rank + 1) * n]
    cfg = EngineConfig(max_mix_comps=6, max_em_iters=60)
    prop, tele = em.fit_proposal(
        tutorial.tutorial_set(), cfg, x, torch.ones(3, 2),
        seed_idx=torch.as_tensor(inputs["em_seed_idx"]), mesh=mesh)
    auto, _ = em.fit_proposal(tutorial.tutorial_set(), EngineConfig(
        mix_fit="autorj"), x, torch.ones(3, 2), mesh=mesh)
    return {"lam": prop.lam, "mu": prop.mu, "B": prop.B, "nmix": prop.nmix,
            "iters": tele["em_iters"], "autorj_mu": auto.mu,
            "autorj_B": auto.B}


def _general_chunk(mesh, rng, chains=None, prop=None, n_sweeps=8,
                   collect=True, pk_mode="per_chain"):
    ms = tutorial.tutorial_set()
    S = 4096 if chains is None else chains.n_chains
    cfg = EngineConfig(n_chains=S, fused="off", rng=rng, seed=4,
                       n_trace_chains=6, pk_mode=pk_mode)
    if chains is None:
        chains = rjmcmc.init_chains(ms, cfg, randoms.key(2), "cpu")
    prop = prop or _tutorial_proposal()
    if mesh is not None:
        chains = mesh_lib.shard_chains(chains, mesh)
        prop = mesh_lib.replicate(prop, mesh)
    run = rjmcmc.build_chunk_runner(ms, cfg, burning=False, collect=collect,
                                    mesh=mesh)
    out, chunk = run(chains, prop, n_sweeps)
    return {**_gather_chains(out, mesh), **chunk}


def case_chunk_fast(mesh, inputs):
    """8 sweeps of 4096 chains on the general engine, ``fast`` words,
    with pooled pk (its histogram summed every sweep) and traces."""
    return _general_chunk(mesh, "fast", pk_mode="pooled")


def case_chunk_pallas(mesh, inputs):
    """The same on K4's twin (``rng="pallas"``, per-chain pk)."""
    return _general_chunk(mesh, "pallas")


def case_chunk_jax(mesh, inputs):
    """5 sweeps of the JAX package's 1024 start chains after 20 JAX sweeps
    (``inputs``), on the ``fast`` words, no traces."""
    c = {f: inputs[f"chains_{f}"] for f in (
        "k", "theta", "logp", "pk", "pkllim", "nreinit", "sweep", "key")}
    return _general_chunk(mesh, "fast", chains=chains_from_numpy(**c),
                          n_sweeps=5, collect=False)


def _kernel_start(S=1024, seed=2):
    ms = tutorial.tutorial_set()
    cfg = EngineConfig(n_chains=S, seed=seed)
    return ms, rjmcmc.init_chains(ms, cfg, randoms.key(seed), "cpu")


def _kernel_chunk(mesh, fused_rng, pk_mode="per_chain", n_sweeps=12):
    ms, chains = _kernel_start()
    cfg = EngineConfig(n_chains=chains.n_chains, seed=7, fused="on",
                       fused_rng=fused_rng, pk_mode=pk_mode)
    prop = _tutorial_proposal()
    if mesh is not None:
        chains = mesh_lib.shard_chains(chains, mesh)
        prop = mesh_lib.replicate(prop, mesh)
    run = fused.build_fused_chunk_runner(ms, cfg, burning=False, mesh=mesh)
    out, chunk = run(chains, prop, n_sweeps)
    out, chunk2 = run(out, prop, n_sweeps)
    chunk = {f"{k}_1": v for k, v in chunk.items()} | chunk2
    return {**_gather_chains(out, mesh), **chunk}


def case_kernel_hash(mesh, inputs):
    """The sweep kernel's twin per chain on the hash, 2 x 12 sweeps."""
    return _kernel_chunk(mesh, "hash")


def case_kernel_hw(mesh, inputs):
    """The same on the hw stream (K1f's twin)."""
    return _kernel_chunk(mesh, "hw")


def case_pooled(mesh, inputs):
    """Pooled pk adapting: K1c's twin on one device, the one-sweep route
    with the histogram summed every sweep under a mesh."""
    return _kernel_chunk(mesh, "hash", pk_mode="pooled")


def _pipeline_cfg(**kw):
    return EngineConfig(n_chains=128, n_chains_stage1=64, stage1_sweeps=200,
                        sweep_chunk=100, max_em_iters=60, max_mix_comps=6,
                        seed=4, **kw)


def case_pipeline(mesh, inputs):
    """AMSampler through all three stages on normal_beta_set."""
    am = AMSampler(builtin.normal_beta_set(), _pipeline_cfg(), device="cpu",
                   mesh=mesh)
    am.estimate_conditional_probs()
    am.burn_samples(50)
    stats = am.rjmcmc_samples(200)
    return {"ksummary": stats.ksummary, "n_chains": stats.n_chains,
            "theta_mean": stats.theta_mean(), "nmix": am.proposal.nmix,
            "sig": am.proposal.sig, "k": _gather_chains(am.chains, mesh)["k"],
            "k_trace": stats.k_trace}


def _ckpt_sampler(mesh):
    cfg = _pipeline_cfg(fused_rng="hash", trace_chain0=False)
    am = AMSampler(tutorial.tutorial_set(), cfg, device="cpu", mesh=mesh)
    am.set_proposal(_tutorial_proposal())
    return am


def case_checkpoint(mesh, inputs):
    """A run of 100 + 100 sweeps saved after the first 100 (under a mesh
    every rank saves; the parent resumes the file on one device), and a
    run resumed here from the parent's checkpoint of one device."""
    am = _ckpt_sampler(mesh)
    am.burn_samples(40)
    am.rjmcmc_samples(100)
    path = os.path.join(inputs["out_dir"],
                        f"ckpt_{'one' if mesh is None else mesh.size}.npz")
    am.save(path)
    stats = am.rjmcmc_samples(100)
    out = {"ksummary": stats.ksummary.copy(), "path": path,
           **_gather_chains(am.chains, mesh)}
    if "ckpt_one" in inputs:
        back = _ckpt_sampler(mesh)
        back.load(inputs["ckpt_one"])
        st = back.rjmcmc_samples(100)
        out["resumed_ksummary"] = st.ksummary.copy()
        out.update({f"resumed_{k}": v for k, v in
                    _gather_chains(back.chains, mesh).items()})
    return out


def case_hmc(mesh, inputs):
    """The HMC step tuner on toy1 (256 chains a model, 80 rounds)."""
    ms = toy.toy1_set()
    cfg = EngineConfig(within_move="hmc")
    return {"scales": hmc.tune_step_scale(
        ms, cfg, torch.ones(ms.nmodels, ms.dmax), randoms.key(17),
        n_rounds=80, n_chains_per_model=256, device="cpu", mesh=mesh)}


def case_smc(mesh, inputs):
    """SMC on toy1's seeded proposal, 1024 particles, 10 steps, 2 moves."""
    out = smc.run_smc(toy.toy1_set(), EngineConfig(), _toy1_proposal(),
                      randoms.key(9), n_particles=1024, n_temps=10,
                      n_moves=2, mesh=mesh)
    return {k: out[k] for k in ("log_evidence", "model_probs", "ess",
                                "theta")}


def case_collectives(mesh, inputs):
    """The mesh helpers: integer sums stay integer, gathers and broadcasts
    follow the rank order, chains split and gather back, a sub-mesh, and
    what must raise."""
    out = {}
    r = mesh.rank
    counts = torch.tensor([r, 2 * r + 1], dtype=torch.int32)
    s = mesh_lib.all_reduce_sum(counts, mesh)
    out["sum_dtype"] = str(s.dtype)
    out["sum"] = s
    out["gather"] = mesh_lib.all_gather(torch.full((1, 2), float(r)), mesh)
    out["bcast"] = mesh_lib.broadcast(torch.tensor([float(r) + 7]), mesh)
    _, chains = _kernel_start(S=64)
    part = mesh_lib.shard_chains(chains, mesh)
    out["local_rows"] = part.n_chains
    back = mesh_lib.gather_chains(part, mesh)
    out["roundtrip"] = all(torch.equal(getattr(back, f), getattr(chains, f))
                           for f in ("k", "theta", "logp", "pk", "key"))
    out["chain0"] = mesh_lib.chain0(mesh, part.n_chains)
    sub = mesh_lib.make_mesh(1)
    out["sub"] = None if sub is None else (sub.size, sub.rank)
    errors = {}
    for name, fn in (
            ("cuda_on_gloo", lambda: mesh_lib.make_mesh(device="cuda")),
            ("uneven_shard", lambda: mesh_lib.shard_chains(
                _kernel_start(S=mesh.size * 8 + 1)[1], mesh)),
            ("uneven_sampler", lambda: AMSampler(
                tutorial.tutorial_set(), EngineConfig(n_chains=1001),
                device="cpu", mesh=mesh)),
            ("uneven_stage1", lambda: AMSampler(
                tutorial.tutorial_set(), EngineConfig(
                    n_chains=1024, n_chains_stage1=mesh.size * 16 + 1),
                device="cpu", mesh=mesh)),
            ("device_mismatch", lambda: AMSampler(
                tutorial.tutorial_set(), EngineConfig(), device="cuda",
                mesh=mesh))):
        try:
            fn()
            errors[name] = None
        except (ValueError, RuntimeError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    in_dir, out_dir, cases = sys.argv[4], sys.argv[5], sys.argv[6]
    torch.set_num_threads(1)
    from automix_tpu_torch.parallel import multihost
    multihost.initialize(f"localhost:{port}", num_processes=world,
                         process_id=rank)
    mesh = multihost.make_global_mesh()
    assert (mesh.rank, mesh.size) == (rank, world)
    inputs = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    inputs["out_dir"] = out_dir
    ckpt = os.path.join(in_dir, "ckpt_one.npz")
    if os.path.exists(ckpt):
        inputs["ckpt_one"] = ckpt
    results = {}
    for name in cases.split(","):
        try:
            results[name] = CASES[name](mesh, inputs)
        except Exception:                       # noqa: BLE001
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
