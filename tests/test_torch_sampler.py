"""The whole ported slice on the CPU: stage 1, stage 2, burn-in and
production sweeps through ``AMSampler``, against the published tutorial
posteriors and a JAX fused run of the same size."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.sampler import AMSampler as JaxSampler
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.models import tutorial
from _torch_threads import one_torch_thread  # noqa: F401

SIZE = dict(n_chains=1024, n_chains_stage1=128, stage1_sweeps=200,
            stage1_target_samples=512, max_mix_comps=10, max_em_iters=300,
            sweep_chunk=100, seed=3)
BURN, SWEEPS = 100, 600


def test_tutorial_slice_matches_published_and_jax():
    """p(M) within 0.05 of the published 0.7928 / 0.0239 / 0.1834 and of
    the JAX package's fused interpret-mode run of the same size (1024
    chains x 600 sweeps: the Monte Carlo error of a visit fraction is
    ~0.01 here, and the two runs share the hash words but not every
    trajectory)."""
    am = AMSampler(tutorial.tutorial_set(), EngineConfig(**SIZE),
                   device="cpu")
    am.estimate_conditional_probs()
    am.burn_samples(BURN)
    stats = am.rjmcmc_samples(SWEEPS)
    probs = am.model_probs()
    assert stats.ksummary.sum() == SIZE["n_chains"] * SWEEPS
    assert stats.ntrytd == SIZE["n_chains"] * SWEEPS
    assert 0 < stats.nacctd < stats.ntrytd
    assert am.chains.sweep == 1 + BURN + SWEEPS
    np.testing.assert_allclose(probs, tutorial.TUTORIAL_MODEL_PROBS,
                               atol=0.05)

    jam = JaxSampler(jtutorial.tutorial_set(), JaxConfig(
        **SIZE, fused="on", fused_rng="hash", fused_stage1="on",
        trace_chain0=False))
    jam.estimate_conditional_probs()
    jam.burn_samples(BURN)
    jprobs = jam.rjmcmc_samples(SWEEPS, collect=False).model_probs
    np.testing.assert_allclose(probs, jprobs, atol=0.05)


def test_import_leaves_jax_out():
    """The port imports neither JAX nor the JAX package."""
    code = ("import sys, automix_tpu_torch, automix_tpu_torch.sampler, "
            "automix_tpu_torch.convert, automix_tpu_torch.kernels.fused, "
            "automix_tpu_torch.kernels.fused_stage1, automix_tpu_torch.cli, "
            "automix_tpu_torch.diagnostics, automix_tpu_torch.io.reports, "
            "automix_tpu_torch.io.checkpoint, automix_tpu_torch.models.toy, "
            "automix_tpu_torch.models.builtin; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'automix_tpu.'))"
            " or m == 'automix_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_raises_without_cuda(monkeypatch):
    """device='cuda' (the default) never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AMSampler(tutorial.tutorial_set(), EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AMSampler(tutorial.tutorial_set(), EngineConfig(), device="cuda")


def test_config_defaults_match_jax():
    """Every field the port's EngineConfig honours has the JAX default,
    the trace fields included (trace_chain0=True, trace_every=1,
    n_trace_chains=8)."""
    port, ref = EngineConfig(), JaxConfig()
    names = [f.name for f in dataclasses.fields(EngineConfig)]
    assert {"trace_chain0", "trace_every", "n_trace_chains"} <= set(names)
    for name in names:
        if name == "dtype":
            assert str(port.dtype) == f"torch.{np.dtype(ref.dtype).name}"
        else:
            assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("knob", [dict(perm=True, pk_mode="pooled"),
                                  dict(student_t_dof=3, within_move="hmc"),
                                  dict(pk_mode="pooled"),
                                  dict(within_move="hmc"),
                                  dict(mix_fit="autorj", stage1_adapt="log"),
                                  dict(stage1_adapt="log"),
                                  dict(trace_every=4, pk_mode="pooled"),
                                  dict(dtype=torch.float64)])
def test_unported_knobs_raise(knob):
    """Pooled pk, HMC, the log stage-1 rule and float64 are not ported:
    each raises, alone or beside a ported knob."""
    with pytest.raises(NotImplementedError):
        EngineConfig(**knob)


@pytest.mark.parametrize("knob", [dict(perm=True), dict(student_t_dof=3),
                                  dict(mix_fit="autorj"), dict(trace_every=4),
                                  dict(trace_chain0=False)])
def test_ported_knobs_accepted(knob):
    cfg = EngineConfig(**knob)
    for name, value in knob.items():
        assert getattr(cfg, name) == value


@pytest.mark.parametrize("knob", [dict(trace_every=0),
                                  dict(student_t_dof=-1),
                                  dict(mix_fit="em")])
def test_invalid_knobs_raise_as_in_jax(knob):
    with pytest.raises(ValueError):
        EngineConfig(**knob)
    with pytest.raises(ValueError):
        JaxConfig(**knob)


def test_collect_raises_and_wrappers_take_the_plain_path_on_cpu():
    """model_probs raises before any production sweep; collect=True
    records one trace entry per trace_every sweeps; on CPU tensors no
    kernel is launched."""
    from automix_tpu_torch.kernels import fused, fused_stage1
    am = AMSampler(tutorial.tutorial_set(), EngineConfig(
        n_chains=64, n_chains_stage1=16, stage1_sweeps=20,
        stage1_target_samples=64, max_mix_comps=4, max_em_iters=50,
        trace_every=4, n_trace_chains=3), device="cpu")
    with pytest.raises(RuntimeError):
        am.model_probs()
    before = (fused.sweep_chunk.launches, fused_stage1.segment.launches,
              fused_stage1.sweep.launches)
    am.burn_samples(5)
    stats = am.rjmcmc_samples(10, collect=True)
    assert (fused.sweep_chunk.launches, fused_stage1.segment.launches,
            fused_stage1.sweep.launches) == before
    assert stats.trace_stride == 4 and stats.k_trace.shape == (3, 3)
    assert stats.ksummary.sum() == 64 * 10
