"""The port's CLI on the CPU (``--device cpu``), in process: the flow of
``tests/test_cli.py`` at tiny sizes."""

import os

import numpy as np
import pytest
import torch

from automix_tpu_torch import cli
from automix_tpu_torch.sampler import AMSampler
from _torch_threads import one_torch_thread  # noqa: F401


def _probs(out):
    return [float(line.split("=")[-1]) for line in out.splitlines()
            if line.startswith("p(M=")]


def test_cli_end_to_end_and_mode1_restart(tmp_path, capsys):
    """Full pipeline with the reports, then mode 1 from the written
    ``_mix.data``: the reference CI's smoke flow."""
    stem = str(tmp_path / "run")
    assert cli.main(["normal", "-N", "400", "-b", "100", "-n", "300", "-s",
                     "5", "-f", stem, "--chains", "64", "--chains-stage1",
                     "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "p(M=1|E) = 1.0" in out
    assert "Tracing every 16th sweep" in out
    for suffix in ("mix", "log", "adapt", "cf", "k", "lp", "pk", "ac",
                   "theta1"):
        assert os.path.exists(f"{stem}_{suffix}.data"), suffix
    # 400 sweeps traced every 16th: 25 entries
    assert len(open(f"{stem}_k.data").read().split()) == 25
    assert "p: 1\n" in open(f"{stem}_log.data").read()      # perm on
    assert cli.main(["normal", "-m", "1", "-N", "300", "-b", "100", "-s",
                     "6", "-f", stem, "--chains", "64", "--device", "cpu",
                     "--no-reports"]) == 0
    out = capsys.readouterr().out
    assert "Reading parameters from mix file." in out
    assert _probs(out) == [1.0]


def test_cli_problem_errors():
    """An unknown problem exits with the list of built-ins, which holds
    every problem of the JAX registry: cpt and cptrs resolve to the
    port's change-point sets."""
    from automix_tpu_torch.models import changepoint
    with pytest.raises(SystemExit, match="unknown problem"):
        cli.main(["nonexistent_problem", "--device", "cpu"])
    assert cli._resolve_problem("cpt") is changepoint.cpt_set
    assert cli._resolve_problem("cptrs") is changepoint.cptrs_set


def test_cli_cptrs_on_the_cpu(tmp_path, capsys):
    """cptrs through the CLI on the CPU: AutoRJ (mode 2), 64 stage-1
    chains per model x 44 sweeps, 128 chains x 100 sweeps after 20
    burn-in.  Six model probabilities summing to 1, and the _mix.data
    written for all six models."""
    stem = str(tmp_path / "cptrs")
    assert cli.main(["cptrs", "-m", "2", "-N", "100", "-b", "20", "-n",
                     "40", "-s", "3", "--chains", "128", "--chains-stage1",
                     "64", "--device", "cpu", "-f", stem]) == 0
    probs = _probs(capsys.readouterr().out)
    assert len(probs) == 6 and abs(sum(probs) - 1.0) < 1e-4
    assert os.path.exists(f"{stem}_mix.data")


def test_cli_device_cuda_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["normal", "-f", str(tmp_path / "x")])


def test_cli_kill_and_resume(tmp_path, capsys, monkeypatch):
    """AutoRJ (mode 2) on the two-model normal_beta set with a checkpoint
    every 200 sweeps: a run stopped right after its first stage-3
    checkpoint and resumed with --resume prints the p(M) of the run that
    was never stopped, exactly (sweeps depend only on the seed, the sweep
    counter and the chain)."""
    flags = ["normal_beta", "-m", "2", "-N", "600", "-b", "100", "-n",
             "200", "-s", "11", "--chains", "64", "--chains-stage1", "64",
             "--device", "cpu", "--no-reports", "--checkpoint-every", "200"]
    ref = str(tmp_path / "ref")
    assert cli.main(flags + ["-f", ref]) == 0
    want = _probs(capsys.readouterr().out)
    assert len(want) == 2 and 0.0 < want[0] < 1.0

    class Killed(Exception):
        pass

    saves = []
    real_save = AMSampler.save

    def save_then_die(self, path):
        real_save(self, path)
        saves.append(path)
        if len(saves) == 2:               # after burn-in and 200 sweeps
            raise Killed

    killed = str(tmp_path / "killed")
    monkeypatch.setattr(AMSampler, "save", save_then_die)
    with pytest.raises(Killed):
        cli.main(flags + ["-f", killed])
    monkeypatch.setattr(AMSampler, "save", real_save)
    capsys.readouterr()
    assert cli.main(flags + ["-f", killed, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "Resumed from" in out and "200/600 production sweeps" in out
    assert _probs(out) == want
    ck = np.load(f"{killed}_ckpt.npz")
    np.testing.assert_array_equal(ck["stats.ksummary"],
                                  np.load(f"{ref}_ckpt.npz")["stats.ksummary"])
