"""Posteriors of the general engine on the CPU: whole AMSampler runs and
the CLI on sets with exact, published or closed-form model
probabilities, and JAX's end-to-end contract of its ``rng="pallas"``
stream on the single Normal target."""

import os
from pathlib import Path

import numpy as np
import pytest

from automix_tpu_torch import AMSampler, EngineConfig, cli
from automix_tpu_torch.kernels import fused, fused_stage1, sweep_rng
from automix_tpu_torch.models import builtin, toy, tutorial
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_general import _per_theta, _proposal

ROOT = Path(__file__).resolve().parents[1]


def _launches():
    return (fused.sweep_chunk.launches, fused_stage1.segment.launches,
            fused_stage1.sweep.launches, sweep_rng.draw.launches)


def test_toy2_per_theta_meets_its_exact_probabilities():
    """toy2 with per-theta wrappers and no CudaDensity under fused='auto':
    the general engine's stage 3 (512 chains x 1000 sweeps after 200
    burn-in) within 0.01 of the exact 0.5 / 0.25 / 0.125 / 0.0625 /
    0.0625, and no kernel twin ran.  The proposal is toy2's own mixture,
    each model's +5 and -5 components: a stage 1 from the origin leaves
    the higher models' chains in one of the two modes, 10 apart in every
    coordinate, so the fit misweights them and p(M) settles ~0.01 off,
    in JAX as in the port (tools/toy2_general_witness.py); the chip run
    drives toy2's whole pipeline."""
    from automix_tpu_torch.convert import proposal_from_arrays
    before = _launches()
    am = AMSampler(_per_theta(toy.toy2_set()), EngineConfig(
        n_chains=512, sweep_chunk=500, seed=5, trace_chain0=False),
        device="cpu")
    am.set_proposal(proposal_from_arrays(_proposal("toy2")))
    am.burn_samples(200)
    probs = am.rjmcmc_samples(1000).model_probs
    assert _launches() == before
    np.testing.assert_allclose(probs, toy.TOY2_MODEL_PROBS, atol=0.01)


def test_tutorial_on_the_general_engine_meets_the_published_values():
    """The tutorial under fused='off' and fused_stage1='off' (2048
    chains x 1500 sweeps) within 0.01 of 0.7928 / 0.0239 / 0.1834."""
    before = _launches()
    am = AMSampler(tutorial.tutorial_set(), EngineConfig(
        n_chains=2048, n_chains_stage1=128, stage1_sweeps=400,
        stage1_target_samples=512, max_mix_comps=6, max_em_iters=300,
        sweep_chunk=500, seed=3, fused="off", fused_stage1="off",
        trace_chain0=False), device="cpu")
    am.estimate_conditional_probs()
    am.burn_samples(300)
    stats = am.rjmcmc_samples(1500)
    assert _launches() == before
    assert stats.ksummary.sum() == 2048 * 1500
    np.testing.assert_allclose(stats.model_probs,
                               tutorial.TUTORIAL_MODEL_PROBS, atol=0.01)


def test_normal_sampler_with_the_pallas_stream():
    """JAX's end-to-end contract of rng='pallas' (tests/test_sweep_rng.py
    :123-147): the single N(0.5, 1) target at its size, mean 0.5 +- 0.2
    and std 1 +- 0.3, here on K4's twin; the twin counts no launch."""
    cfg = EngineConfig(n_chains=64, n_chains_stage1=64, stage1_sweeps=200,
                       sweep_chunk=50, max_em_iters=40, max_mix_comps=4,
                       seed=0, rng="pallas", fused="off",
                       trace_chain0=False)
    am = AMSampler(builtin.normal_sampler_set(), cfg, device="cpu")
    launches = sweep_rng.draw.launches
    am.burn_samples(50)
    stats = am.rjmcmc_samples(300)
    assert sweep_rng.draw.launches == launches
    assert abs(stats.theta_mean()[0, 0] - 0.5) < 0.2
    assert abs(stats.theta_std()[0, 0] - 1.0) < 0.3


def _example(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from examples import model_selection_torch
    return model_selection_torch


def test_model_selection_example_meets_the_closed_form(monkeypatch):
    """examples/model_selection_torch.py through AMSampler on the CPU:
    p(M) within 0.01 of the closed form, which is [2e-27, 1]: the
    parabola takes every visit, so the check shows that the jumps keep
    to it and the per-theta densities run, not the mixing between
    comparable models (toy2 shows that)."""
    ex = _example(monkeypatch)
    exact = ex.exact_model_probs()
    assert exact[0] < 1e-20
    am = AMSampler(ex.model_set(), EngineConfig(
        n_chains=256, n_chains_stage1=128, stage1_sweeps=300,
        stage1_target_samples=512, max_mix_comps=3, max_em_iters=100,
        seed=1, trace_chain0=False), device="cpu")
    am.estimate_conditional_probs()
    am.burn_samples(100)
    stats = am.rjmcmc_samples(300)
    np.testing.assert_allclose(stats.model_probs, exact, atol=0.01)
    np.testing.assert_allclose(stats.theta_mean()[1, :3], [1.0, 0.5, 1.5],
                               atol=0.25)


def test_model_selection_example_through_the_cli(monkeypatch, tmp_path,
                                                 capsys):
    """The CLI resolves module:function to the per-theta set and runs it
    on the general engine (AutoRJ, traces every sweep by default there)."""
    _example(monkeypatch)
    stem = str(tmp_path / "ms")
    assert cli.main(["examples.model_selection_torch:model_set", "-m", "2",
                     "-N", "200", "-b", "50", "-n", "200", "-s", "4",
                     "--chains", "256", "--chains-stage1", "128",
                     "--device", "cpu", "-f", stem]) == 0
    out = capsys.readouterr().out
    probs = [float(line.split("=")[-1]) for line in out.splitlines()
             if line.startswith("p(M=")]
    from examples import model_selection_torch as ex
    np.testing.assert_allclose(probs, ex.exact_model_probs(), atol=0.01)
    assert "Tracing every" not in out
    assert os.path.exists(f"{stem}_k.data")
    assert len(open(f"{stem}_k.data").read().split()) == 200


def test_cli_fused_switches_pick_the_engine(tmp_path, capsys):
    """--fused off / --fused-stage1 off run a kernel set on the general
    engine, with per-sweep traces by default; an unknown choice exits."""
    before = _launches()
    assert cli.main(["normal", "-N", "100", "-b", "20", "-n", "100", "-s",
                     "5", "-m", "2", "--chains", "64", "--chains-stage1",
                     "32", "--fused", "off", "--fused-stage1", "off",
                     "--device", "cpu", "--no-reports",
                     "-f", str(tmp_path / "n")]) == 0
    out = capsys.readouterr().out
    assert "Tracing every" not in out
    assert [float(line.split("=")[-1]) for line in out.splitlines()
            if line.startswith("p(M=")] == [1.0]
    assert _launches() == before
    with pytest.raises(SystemExit):
        cli.main(["normal", "--fused", "sometimes"])
