"""The port's I/O and diagnostics against the JAX package's: ``_mix.data``
(the C-written fixture, round trips, a JAX-written file), the nine report
files for the same run statistics, and the Sokal IACT."""

import os
import types

import numpy as np
import pytest
import torch

from automix_tpu import diagnostics as jdiag
from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.io import mixfile as jmixfile
from automix_tpu.io import reports as jreports
from automix_tpu.models import toy as jtoy
from automix_tpu.state import CondProbStats as JaxCondProbStats
from automix_tpu.state import RunStats as JaxRunStats
from automix_tpu_torch import EngineConfig, diagnostics
from automix_tpu_torch.convert import proposal_from_arrays
from automix_tpu_torch.io import mixfile, reports
from automix_tpu_torch.models import toy
from automix_tpu_torch.state import CondProbStats, RunStats
from _torch_threads import one_torch_thread  # noqa: F401

ORACLE = os.path.join(os.path.dirname(__file__), "data",
                      "toy1_mix_c_oracle.data")


def _np(prop):
    return {f: np.asarray(getattr(prop, f)) for f in
            ("lam", "mu", "B", "logdetB", "nmix", "sig")}


def test_read_c_oracle_mix_file_as_jax_does():
    """The mix file written by the reference C program: the port's reader
    gives the JAX reader's proposal (logdet within float32 rounding)."""
    prop = mixfile.read_mix_file(ORACLE, [1, 2], lmax=30, dmax=2)
    want = _np(jmixfile.read_mix_file(ORACLE, [1, 2], lmax=30, dmax=2))
    got = _np(prop)
    for f in ("lam", "mu", "B", "nmix", "sig"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["logdetB"], want["logdetB"], atol=1e-6)
    assert prop.lam.dtype == torch.float32
    np.testing.assert_allclose(got["lam"].sum(1), 1.0, atol=1e-5)


def test_mix_file_round_trips_and_reads_jax_written_files(tmp_path):
    prop = mixfile.read_mix_file(ORACLE, [1, 2], lmax=30, dmax=2)
    out = str(tmp_path / "rt_mix.data")
    mixfile.write_mix_file(out, prop, [1, 2])
    back = mixfile.read_mix_file(out, [1, 2], lmax=30, dmax=2)
    for f in ("lam", "mu", "B", "sig"):
        torch.testing.assert_close(getattr(back, f), getattr(prop, f),
                                   rtol=0, atol=1e-5)
    # the JAX writer's file, read by the port, equals the JAX reader's
    jprop = jmixfile.read_mix_file(ORACLE, [1, 2], lmax=30, dmax=2)
    jpath = str(tmp_path / "jax_mix.data")
    jmixfile.write_mix_file(jpath, jprop, [1, 2])
    assert open(jpath).read() == open(out).read()
    got = _np(mixfile.read_mix_file(jpath, [1, 2], lmax=30, dmax=2))
    want = _np(jmixfile.read_mix_file(jpath, [1, 2], lmax=30, dmax=2))
    for f in ("lam", "mu", "B", "sig"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_mix_file_validation():
    with pytest.raises(ValueError, match="nmodels"):
        mixfile.read_mix_file(ORACLE, [1, 2, 3], lmax=30, dmax=3)
    with pytest.raises(ValueError, match="dim"):
        mixfile.read_mix_file(ORACLE, [2, 2], lmax=30, dmax=2)


def _run_statistics(rng, K=2, D=2, n=64):
    """Identical synthetic statistics for both packages' writers: chunk
    dicts with traces, stage-1/2 telemetry and a toy1 proposal."""
    chunks = []
    for _ in range(4):
        k = rng.integers(0, K, size=(n, 4)).astype(np.int8)
        chunks.append({
            "ksummary": rng.integers(0, 1000, K),
            "theta_sum": rng.normal(size=(K, D)),
            "theta_sqsum": rng.uniform(1, 2, size=(K, D)),
            "naccrwmb": 10, "ntryrwmb": 40, "naccrwms": 30, "ntryrwms": 90,
            "nacctd": 20, "ntrytd": 64,
            "k_trace": k, "k0_trace": k[:, 0],
            "pk0_trace": rng.dirichlet(np.ones(K), size=n),
            "logp0_trace": rng.normal(-3, 1, size=n),
            "theta0_trace": rng.normal(size=(n, D)).astype(np.float32),
        })
    cp = dict(sig_trace=rng.uniform(0.1, 2, size=(6, K, D)),
              accept_trace=rng.uniform(0, 1, size=(6, K, D)),
              em_trace={"Lkk": rng.integers(1, 5, size=(K, 9)),
                        "lpn": rng.normal(size=(K, 9)),
                        "cost": rng.normal(size=(K, 9)),
                        "ann": rng.integers(0, 3, size=(K, 9))},
              em_iters=np.array([7, 9]))
    return chunks, cp


def _writer_input(stats, cpstats, cfg, prop, modelset, chunks, cp):
    stats.n_chains, stats.nsweeps = 256, 4 * 64
    stats.trace_stride = 4
    stats.timesecs_burn, stats.timesecs_rjmcmc = 0.5, 1.25
    for c in chunks:
        stats.absorb_chunk(c)
    for name, v in cp.items():
        setattr(cpstats, name, v)
    return types.SimpleNamespace(stats=stats, cpstats=cpstats, cfg=cfg,
                                 proposal=prop, modelset=modelset)


def test_reports_match_the_jax_writer(tmp_path):
    """For the same run statistics both writers make the same nine files
    (toy1: _theta1 and _theta2) with the same lines and columns; numbers
    agree to the last printed digit except the _lp likelihood column and
    the _log tau, which the two packages compute (loglik, FFT) to float32
    rounding."""
    chunks, cp = _run_statistics(np.random.default_rng(0))
    jprop = jmixfile.read_mix_file(ORACLE, [1, 2], lmax=30, dmax=2)
    outs = {}
    for name, stats, cpstats, cfg, prop, ms, rep in (
            ("jax", JaxRunStats(2, 2), JaxCondProbStats(),
             JaxConfig(seed=9, perm=True), jprop, jtoy.toy1_set(), jreports),
            ("port", RunStats(2, 2), CondProbStats(),
             EngineConfig(seed=9, perm=True), proposal_from_arrays(jprop),
             toy.toy1_set(), reports)):
        d = tmp_path / name
        d.mkdir()
        am = _writer_input(stats, cpstats, cfg, prop, ms, chunks, cp)
        rep.report_cond_prob_estimation(str(d / "run"), am)
        rep.report_rjmcmc_run(str(d / "run"), am, mode=0, nsweep2=300,
                              nsweep=256)
        outs[name] = {f: open(d / f).read().splitlines()
                      for f in sorted(os.listdir(d))}
    assert sorted(outs["port"]) == sorted(outs["jax"]) == sorted(
        f"run_{s}.data" for s in ("mix", "log", "adapt", "cf", "k", "lp",
                                  "pk", "ac", "theta1", "theta2"))
    for f, want in outs["jax"].items():
        got = outs["port"][f]
        assert len(got) == len(want), f
        for a, b in zip(got, want):
            ta, tb = a.split(), b.split()
            assert len(ta) == len(tb), (f, a, b)
            if f in ("run_lp.data", "run_log.data") and a != b:
                for x, y in zip(ta, tb):
                    if x != y:
                        x = x.split(":")[-1].rstrip(",")
                        y = y.split(":")[-1].rstrip(",")
                        assert float(x) == pytest.approx(float(y), rel=1e-5,
                                                         abs=2e-6), (f, a, b)
            else:
                assert a == b, (f, a, b)


@pytest.mark.parametrize("stride", [1, 8])
def test_sokal_matches_jax(stride):
    """Sokal tau, var, m and rho on the same AR(1) and binary series,
    torch.fft against jnp.fft (float32 FFTs: 1e-4 relative)."""
    rng = np.random.default_rng(stride)
    n = 4096
    z = np.zeros((n, 3), np.float32)
    for i in range(1, n):
        z[i] = 0.9 * z[i - 1] + rng.standard_normal(3)
    for x in (z, rng.integers(0, 3, size=(n, 2)).astype(np.float32)):
        got = diagnostics.sokal_batched(x, stride=stride)
        want = jdiag.sokal_batched(x, stride=stride)
        assert got["nkeep"] == want["nkeep"]
        np.testing.assert_array_equal(got["m"], want["m"])
        for key in ("tau", "var"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
        np.testing.assert_allclose(got["rho"], want["rho"], atol=1e-5)
    assert diagnostics.split_rhat(z) == pytest.approx(jdiag.split_rhat(z))
    assert diagnostics.ess(z) == pytest.approx(jdiag.ess(z), rel=1e-4)
