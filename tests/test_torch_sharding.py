"""The port across devices: gloo worlds of 2 and 4 processes on the CPU.

Each world runs ``tests/_torch_dist_worker.py``'s cases, one process a
rank joined by ``parallel.multihost.initialize`` on a free local port;
this process runs the same cases without a mesh as the reference, and
the JAX package's sharded runs on four of the eight virtual CPU devices
(``tests/conftest.py``) while the worlds run.  The contract is JAX's
(tests/test_sharding.py, tests/test_multihost.py): every rank reports the
same global statistics, and a sharded run is the run on one device bit
for bit wherever the streams are keyed by the global chain; the EM's
sums, taken in another order, agree within its tolerances, and the HMC
tuner's and SMC's per-rank streams statistically.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import em as jem
from automix_tpu.kernels import fused_stage1 as jstage1
from automix_tpu.kernels import rjmcmc as jrjmcmc
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.parallel import mesh as jmesh
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch.kernels import fused, fused_stage1
from automix_tpu_torch.models import toy, tutorial
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.parallel import multihost
import _torch_dist_worker as cases
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_stage1 import _agree_with_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
BITWISE = ["collectives", "stage1_kernels", "stage1_general", "em",
           "chunk_fast", "chunk_pallas", "kernel_hash", "kernel_hw",
           "pooled", "pipeline", "checkpoint"]
WORLD_CASES = {2: BITWISE, 4: BITWISE + ["chunk_jax", "hmc", "smc"]}
TIMEOUT = 600
_CHAIN_FIELDS = ("k", "theta", "logp", "pk", "pkllim", "nreinit")
_COUNTERS = ("ksummary", "naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms",
             "nacctd", "ntrytd")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_world(world: int, in_dir: str, out_dir: str):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port), in_dir,
         out_dir, ",".join(WORLD_CASES[world])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        text=True) for r in range(world)]


def _finish_world(procs, out_dir: str):
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _jax_inputs():
    """The JAX package's inputs: 1024 tutorial chains after 20 sweeps on
    the ``fast`` words, the proposal they ran under, and the EM's seeding
    indices of its key 9 (as ``fit_proposal`` draws them)."""
    jms = jtutorial.tutorial_set()
    jcfg = JaxConfig(seed=4, n_chains=1024, fused="off", rng="fast")
    prop = cases._tutorial_proposal()
    jprop = JaxProposal(**{f: jnp.asarray(getattr(prop, f).numpy()) for f in
                           ("lam", "mu", "B", "logdetB", "nmix", "sig")})
    chains = jrjmcmc.init_chains(jms, jcfg, jax.random.PRNGKey(2))
    burn = jrjmcmc.build_chunk_runner(jms, jcfg, burning=True,
                                      collect=False)
    chains, _ = burn(chains, jprop, 20)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    N = cases._em_samples().shape[1]
    idx = np.stack([np.asarray(jnp.resize(jax.random.choice(
        k, N, (6,), replace=False), (6,))) for k in keys])
    out = {f"chains_{f}": np.asarray(getattr(chains, f)) for f in
           ("k", "theta", "logp", "pk", "pkllim", "nreinit", "sweep", "key")}
    out["em_seed_idx"] = idx
    return out, jprop, chains


def _jax_sharded(jprop, jchains):
    """JAX's sharded runs on make_mesh(4): stage 1 on the one-sweep kernel
    in interpret mode, the general stage-3 chunk and the EM."""
    mesh = jmesh.make_mesh(4)
    jms = jtutorial.tutorial_set()
    init = jnp.asarray(jms.init_points(None))
    cfg1 = JaxConfig(seed=cases.STAGE1["seed"], fused_stage1="on",
                     stage1_target_samples=cases.STAGE1[
                         "stage1_target_samples"])
    stage1 = [np.asarray(x) for x in jstage1.run_fused_stage1_sharded(
        jms, cfg1, cases.STAGE1["stage1_sweeps"],
        cases.STAGE1["n_chains_stage1"], init, mesh)]
    jcfg = JaxConfig(seed=4, n_chains=1024, fused="off", rng="fast")
    run = jrjmcmc.build_chunk_runner(jms, jcfg, burning=False,
                                     collect=False, mesh=mesh)
    out, chunk = run(jmesh.shard_chains(jchains, mesh),
                     jmesh.replicate(jprop, mesh), 5)
    x = jax.device_put(jnp.asarray(cases._em_samples().numpy()),
                       jax.sharding.NamedSharding(
                           mesh, jax.sharding.PartitionSpec(None, "chains",
                                                            None)))
    prop, _ = jem.fit_proposal(jms, JaxConfig(max_mix_comps=6,
                                              max_em_iters=60), x,
                               jnp.ones((3, 2)), jax.random.PRNGKey(9),
                               mesh=mesh)
    return {"stage1": stage1, "chunk_k": np.asarray(out.k),
            "chunk": jax.device_get(chunk),
            "em": {f: np.asarray(getattr(prop, f))
                   for f in ("lam", "mu", "B", "nmix")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(both worlds' results by rank, this process's references, the JAX
    package's sharded runs), the last two computed while the worlds run."""
    tmp = str(tmp_path_factory.mktemp("torch_sharding"))
    inputs, jprop, jchains = _jax_inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    inputs["out_dir"] = tmp
    ref = {"checkpoint": cases.case_checkpoint(None, inputs)}
    worlds = {}
    for w in WORLD_CASES:
        out_dir = os.path.join(tmp, f"w{w}")
        os.makedirs(out_dir)
        worlds[w] = (_start_world(w, tmp, out_dir), out_dir)
    jax_runs = _jax_sharded(jprop, jchains)
    for name in sorted(set(sum(WORLD_CASES.values(), [])) - {"collectives",
                                                             "checkpoint"}):
        ref[name] = cases.CASES[name](None, inputs)
    results = {w: _finish_world(*worlds[w]) for w in worlds}
    return results, ref, jax_runs


def _case(runs, world, name):
    """Every rank's result of ``name`` in the world, failing on an error
    one of them reported."""
    results = runs[0][world]
    outs = [r[name] for r in results]
    for rank, out in enumerate(outs):
        assert "error" not in out, f"rank {rank}:\n{out['error']}"
    return outs


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _assert_ranks_agree(outs, keys):
    for rank, out in enumerate(outs[1:], 1):
        for k in keys:
            assert _equal(out[k], outs[0][k]), (rank, k)


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_helpers_and_refusals(runs, world):
    """Sums of int32 counts stay int32 and exact, gathers follow the rank
    order, broadcasts come from rank 0, chains split and gather back, a
    sub-mesh of one rank, and every uneven split, a ``cuda`` mesh on a
    gloo group and a sampler device other than the mesh's raise."""
    outs = _case(runs, world, "collectives")
    r = np.arange(world)
    for rank, out in enumerate(outs):
        assert out["sum_dtype"] == "torch.int32"
        assert out["sum"].tolist() == [int(r.sum()), int((2 * r + 1).sum())]
        assert out["gather"][:, 0].tolist() == list(map(float, r))
        assert out["bcast"].tolist() == [7.0]
        assert out["local_rows"] == 64 // world and out["roundtrip"]
        assert out["chain0"] == rank * 64 // world
        assert out["sub"] == ((1, 0) if rank == 0 else None)
        errors = out["errors"]
        assert all(errors.values()), errors
        for name, numbers in (("uneven_sampler", ("1001", str(world))),
                              ("uneven_stage1", (str(world * 16 + 1),
                                                 str(world)))):
            assert all(n in errors[name] for n in numbers), errors[name]


def test_initialize_nccl_without_cuda_raises():
    """No fallback: NCCL on a machine without CUDA raises before any group
    is made."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("localhost:1", num_processes=1, process_id=0,
                             backend="nccl")
    assert multihost.is_primary()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ["kernels", "general"])
def test_stage1_bitwise(runs, world, engine):
    """Stage 1 on the tutorial (64 chains a model, 110 sweeps): the kernels'
    twins across devices take K3's moves-only route at each rank's chain
    base, the counts summed as integers every sweep, and the general
    engine splits the per-model keys; sig, the samples, the telemetry and
    logp equal the run on one device (the segment runner, for the
    kernels) bit for bit on every rank."""
    name = f"stage1_{engine}"
    outs = _case(runs, world, name)
    ref = runs[1][name]
    keys = ("sig", "samples", "sig_trace", "accept_trace", "final_logp")
    _assert_ranks_agree(outs, keys)
    for k in keys:
        assert torch.equal(outs[0][k], ref[k]), k
    n_local = ref["samples"].shape[1] // world
    for rank, out in enumerate(outs):
        assert torch.equal(out["samples_local"], ref["samples"][
            :, rank * n_local:(rank + 1) * n_local])


def test_stage1_kernels_match_jax_sharded(runs):
    """The 4-rank stage 1 on K3's twin against JAX's
    ``run_fused_stage1_sharded`` on four devices in interpret mode, with
    the tolerances of the port's stage-1 JAX tests."""
    out = _case(runs, 4, "stage1_kernels")[0]
    want = runs[2]["stage1"]
    got = [out[k].numpy() for k in ("sig", "samples", "sig_trace",
                                     "accept_trace", "final_logp")]
    _agree_with_jax(got, want)


def _assert_em(got, want):
    np.testing.assert_array_equal(np.asarray(got["nmix"]),
                                  np.asarray(want["nmix"]))
    np.testing.assert_allclose(np.asarray(got["lam"]),
                               np.asarray(want["lam"]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got["mu"]), np.asarray(want["mu"]),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(got["B"]), np.asarray(want["B"]),
                               atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_em_sharded_matches_unsharded(runs, world):
    """The EM on [3, 512, 2] samples split over the ranks (the sums summed
    across them, the seeding on the gathered samples): every rank fits the
    same mixture, with the live counts of the fit on one device and
    parameters within 1e-4 (lam) and 2e-4 (mu, B), the JAX package's
    tolerances (tests/test_sharding.py:118-124); AutoRJ gathers its
    samples and fits bit for bit."""
    outs = _case(runs, world, "em")
    ref = runs[1]["em"]
    _assert_ranks_agree(outs, ("lam", "mu", "B", "nmix", "autorj_mu",
                               "autorj_B"))
    _assert_em(outs[0], ref)
    for k in ("autorj_mu", "autorj_B"):
        assert torch.equal(outs[0][k], ref[k]), k


def test_em_matches_jax_sharded(runs):
    """The 4-rank EM against JAX's sharded ``fit_proposal`` on four devices
    from the same samples and seeding indices, within the same
    tolerances."""
    _assert_em(_case(runs, 4, "em")[0], runs[2]["em"])


def _assert_chunk_bitwise(outs, ref, traces=False, exact_theta=True):
    """k, pk, the counters and ksummary bitwise the run on one device's,
    theta and logp too (``exact_theta``) or within rtol 1e-6 (tests/
    test_sharding.py:60-64); the float chunk sums, each rank's summed
    first, within float32 rounding of a sum in another order."""
    keys = _CHAIN_FIELDS + _COUNTERS + ("theta_sum", "theta_sqsum")
    _assert_ranks_agree(outs, keys)
    out = outs[0]
    for k in _COUNTERS + ("k", "pk", "pkllim", "nreinit"):
        assert _equal(out[k], ref[k]), k
    for k in ("theta", "logp"):
        if exact_theta:
            assert torch.equal(out[k], ref[k]), k
        else:
            torch.testing.assert_close(out[k], ref[k], rtol=1e-6, atol=0)
    for k in ("theta_sum", "theta_sqsum"):
        torch.testing.assert_close(out[k], ref[k], rtol=1e-5, atol=1e-3)
    if traces:
        for k in ("k_trace", "k0_trace", "pk0_trace", "logp0_trace",
                  "theta0_trace"):
            for o in outs:
                assert torch.equal(o[k], ref[k]), k


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("rng", ["fast", "pallas"])
def test_general_chunk_bitwise(runs, world, rng):
    """8 sweeps of 4096 tutorial chains on the general engine, on the
    ``fast`` words (pooled pk, its histogram summed every sweep) and on
    K4's twin (each rank's first chain block): k, pk, the counters and
    ksummary equal the run on one device bit for bit, theta and logp
    within rtol 1e-6, and the traces of the global chain prefix,
    broadcast from rank 0, bit for bit."""
    _assert_chunk_bitwise(_case(runs, world, f"chunk_{rng}"),
                          runs[1][f"chunk_{rng}"], traces=True,
                          exact_theta=False)


def test_general_chunk_matches_jax_sharded(runs):
    """5 sweeps of the JAX package's 1024 start chains (converted) on the
    ``fast`` words across 4 ranks, against JAX's sharded
    ``build_chunk_runner(fused="off", rng="fast")`` on four devices: k on
    >= 99% of chains and ksummary within 1% (tests/test_torch_general.py's
    tolerances), and bitwise the port's run on one device."""
    outs = _case(runs, 4, "chunk_jax")
    ref = runs[1]["chunk_jax"]
    _assert_chunk_bitwise(outs, ref, exact_theta=False)
    jax_run = runs[2]
    same = outs[0]["k"].numpy() == jax_run["chunk_k"]
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(outs[0]["ksummary"].numpy(),
                               np.asarray(jax_run["chunk"]["ksummary"]),
                               rtol=0.01, atol=1024 * 5 * 0.002)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("rng", ["hash", "hw"])
def test_kernel_chunk_bitwise(runs, world, rng):
    """The sweep kernel's twin over two 12-sweep chunks of 1024 tutorial
    chains, each rank at its chain base, on the hash and on the hw
    stream: k, theta, logp, pk, ksummary and the counters equal one launch
    over all the chains."""
    _assert_chunk_bitwise(_case(runs, world, f"kernel_{rng}"),
                          runs[1][f"kernel_{rng}"])


@pytest.mark.parametrize("world", WORLDS)
def test_pooled_route_bitwise(runs, world):
    """Pooled pk adapting across devices takes the one-sweep route, the
    visit histogram summed every sweep: ksummary, k, theta and pk equal
    the in-kernel pooled twin (K1c's) on one device, every row of pk the
    shared one (tests/test_fused.py:340-343)."""
    outs = _case(runs, world, "pooled")
    _assert_chunk_bitwise(outs, runs[1]["pooled"])
    pk = outs[0]["pk"]
    assert torch.equal(pk, pk[:1].expand_as(pk))


@pytest.mark.parametrize("world", WORLDS)
def test_full_pipeline_with_mesh(runs, world):
    """AMSampler(mesh=) through all three stages on normal_beta_set (128
    chains, 64 stage-1 chains a model): every rank holds the same
    statistics, the visits cover every chain-sweep (tests/
    test_sharding.py:132-145), the fit matches the fit on one device in
    its live counts and sig, and the posterior means are finite."""
    outs = _case(runs, world, "pipeline")
    _assert_ranks_agree(outs, ("ksummary", "theta_mean", "nmix", "sig",
                               "k", "k_trace"))
    out, ref = outs[0], runs[1]["pipeline"]
    assert out["ksummary"].sum() == 128 * 200 and out["n_chains"] == 128
    assert torch.equal(out["nmix"], ref["nmix"])
    assert torch.equal(out["sig"], ref["sig"])
    assert np.all(np.isfinite(out["theta_mean"]))
    assert out["k_trace"].shape == ref["k_trace"].shape


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_across_layouts(runs, world):
    """A checkpoint written across devices resumed on one device, and one
    written on one device resumed across devices, continue the run that
    was not interrupted bit for bit: the chains and the visit counts of
    the last 100 sweeps."""
    outs = _case(runs, world, "checkpoint")
    ref = runs[1]["checkpoint"]
    _assert_ranks_agree(outs, _CHAIN_FIELDS + ("ksummary",))
    out = outs[0]
    for k in _CHAIN_FIELDS:
        assert torch.equal(out[k], ref[k]), k
        assert torch.equal(out[f"resumed_{k}"], ref[k]), k
    np.testing.assert_array_equal(out["resumed_ksummary"], ref["ksummary"])
    # resume the checkpoint the world wrote on one device
    am = cases._ckpt_sampler(None)
    am.load(out["path"])
    assert am.chains.n_chains == 128
    stats = am.rjmcmc_samples(100)
    for k in _CHAIN_FIELDS:
        assert torch.equal(getattr(am.chains, k), ref[k]), k
    np.testing.assert_array_equal(stats.ksummary, ref["ksummary"])


def test_hmc_tuner_sharded(runs):
    """The HMC step tuner across 4 ranks (toy1, 256 chains a model, 80
    rounds): the same multipliers on every rank, and log-scales within
    0.35 of the tuner on one device (tests/test_smc.py:84)."""
    outs = _case(runs, 4, "hmc")
    _assert_ranks_agree(outs, ("scales",))
    got, want = outs[0]["scales"], runs[1]["hmc"]["scales"]
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(np.log(got), np.log(want), atol=0.35)


def test_smc_sharded(runs):
    """SMC across 4 ranks on toy1's seeded proposal (1024 particles, 10
    steps, 2 moves): every rank returns the same evidences, within 0.1 of
    the run on one device and of toy1's exact log weights, and the whole
    particle cloud (tests/test_smc.py:55-61)."""
    outs = _case(runs, 4, "smc")
    _assert_ranks_agree(outs, ("log_evidence", "model_probs", "ess",
                               "theta"))
    got, want = outs[0], runs[1]["smc"]
    np.testing.assert_allclose(got["log_evidence"], want["log_evidence"],
                               atol=0.1)
    np.testing.assert_allclose(got["log_evidence"],
                               np.log(toy.TOY1_MODEL_PROBS), atol=0.1)
    assert got["theta"].shape == want["theta"].shape == (2, 1024, 2)


def _halves(ms, ch, n_sweeps, **kw):
    """The sweep kernel's twin over all chains, and over the two halves at
    chain bases 0 and S / 2, from ``ch``."""
    tabs = fused.prep_tables(cases._tutorial_proposal(), ms.dims)
    h = ch.n_chains // 2

    def run(rows, chain0=0):
        return fused.sweep_chunk_ref(
            ms, ch.k[rows], ch.theta[rows].T.contiguous(), ch.logp[rows],
            ch.pk[rows].T.contiguous(), ch.pkllim[rows], ch.nreinit[rows],
            tabs, seed=3, sweep0=ch.sweep, n_sweeps=n_sweeps, adapt=True,
            chain0=chain0, **kw)

    return run(slice(None)), [run(slice(i * h, (i + 1) * h), i * h)
                              for i in (0, 1)]


@pytest.mark.parametrize("rng", ["hash", "hw"])
def test_sweep_twin_chain_base_splits(rng):
    """The sweep kernel's twin, 512 tutorial chains x 10 sweeps, as one
    call and as two over the halves at chain bases 0 and 256: every output
    bitwise equal, chain for chain (the contract the card test holds the
    kernel to)."""
    ms, ch = cases._kernel_start(S=512)
    whole, halves = _halves(ms, ch, 10, rng=rng)
    for i, w in enumerate(whole):
        assert torch.equal(w, torch.cat([halves[0][i], halves[1][i]],
                                        dim=-1)), i
    assert (whole[0] != ch.k).any()


def test_k3_twin_chain_base_splits():
    """K3's twin moves only, tutorial 3 x 64 chains x 12 sweeps: each
    model's first and last 32 chains at ``chain_off`` 0 and 32 of
    ``C_total`` 64 move as in one call over all of them, and their counts
    sum to its counts."""
    ms = tutorial.tutorial_set()
    K, D, C, h = 3, 2, 64, 32
    init = ms.init_points(randoms.key(0))
    theta = init[torch.arange(K * C) // C].T.contiguous()
    sig = torch.full((K, D), 0.5)
    lp = torch.zeros(K * C)

    def half(x, i):
        return x.reshape(D if x.dim() == 2 else 1, K, C)[
            ..., i * h:(i + 1) * h].reshape(x.shape[:-1] + (K * h,))

    parts = [(half(theta, i), half(lp, i)) for i in (0, 1)]
    for t in range(1, 13):
        kw = dict(t=t, seed=9, nburn=4, seg_start=t == 1)
        theta, lp, cnt = fused_stage1.sweep_ref(ms, theta, lp, sig, C=C,
                                                **kw)
        got = [fused_stage1.sweep_ref(ms, *parts[i], sig, C=h, C_total=C,
                                      chain_off=i * h, **kw) for i in (0, 1)]
        parts = [g[:2] for g in got]
        assert torch.equal(got[0][2] + got[1][2], cnt), t
        for i in (0, 1):
            assert torch.equal(parts[i][0], half(theta, i))
            assert torch.equal(parts[i][1], half(lp, i))


def test_chain_base_refusals():
    """What needs the whole population refuses a chain base: the pooled
    sweep kernel and K3's in-launch update; a base outside the population
    raises too."""
    ms, ch = cases._kernel_start(S=64)
    tabs = fused.prep_tables(cases._tutorial_proposal(), ms.dims)
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    with pytest.raises(ValueError, match="whole population"):
        fused.sweep_chunk(ms, *args, seed=1, sweep0=1, n_sweeps=1,
                          adapt=True, pooled=True, chain0=64)
    with pytest.raises(ValueError, match="chain0"):
        fused.sweep_chunk(ms, *args, seed=1, sweep0=1, n_sweeps=1,
                          adapt=True, chain0=-1)
    theta = torch.zeros(2, 3 * 16)
    zi = torch.zeros((3, 2), dtype=torch.int32)
    kw = dict(t=1, seed=1, nburn=0, seg_start=True)
    with pytest.raises(ValueError, match="whole population"):
        fused_stage1.sweep(ms, theta, theta[0], torch.ones(3, 2), C=16,
                           C_total=32, chain_off=16, nacc=zi, ntry=zi, **kw)
    with pytest.raises(ValueError, match="of each model"):
        fused_stage1.sweep(ms, theta, theta[0], torch.ones(3, 2), C=16,
                           C_total=24, chain_off=16, **kw)
