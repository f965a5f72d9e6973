"""Minimal model-selection example for the PyTorch port: which of two
linear-Gaussian regressions explains the data?

The two models of ``examples/model_selection.py`` (a line and a parabola
through 40 noisy points of a quadratic trend, noise sigma 0.3 known,
N(0, 1) priors on the coefficients), each given as a per-theta torch
``logp``.  No model has a CUDA density, so ``AMSampler`` runs them on the
general engine, on the card by default.  Both models are linear-Gaussian,
so each model's evidence, and the posterior model probabilities, are
exact (:func:`exact_model_probs`); the data favour the parabola so
strongly that the answer is [0, 1] to many digits.

Run:  python examples/model_selection_torch.py          (on the card)
      python examples/model_selection_torch.py --cpu
  or  python -m automix_tpu_torch.cli \\
          examples.model_selection_torch:model_set -m 2 --chains 2048
"""

import functools
import sys

import numpy as np
import torch

from automix_tpu_torch import AMSampler, EngineConfig, Model, ModelSet
from automix_tpu_torch.model import memoized_set

# Synthetic data from a quadratic trend (the JAX example's draw)
rng = np.random.default_rng(0)
X = np.linspace(-1, 1, 40)
Y = 1.0 + 0.5 * X + 1.5 * X ** 2 + rng.normal(0, 0.3, 40)
SIGMA = 0.3


@functools.lru_cache(maxsize=None)
def _data(device):
    """(x, y) as float32 tensors, copied to each device once."""
    return (torch.tensor(X, dtype=torch.float32, device=device),
            torch.tensor(Y, dtype=torch.float32, device=device))


def logp_linear(th):
    """y = a + b x, fixed noise; N(0, 1) priors on (a, b)."""
    x, y = _data(th.device)
    resid = y - th[0] - th[1] * x
    return (-0.5 * torch.sum(resid ** 2) / SIGMA ** 2
            - 0.5 * torch.sum(th[:2] ** 2))


def logp_quadratic(th):
    """y = a + b x + c x^2, same priors."""
    x, y = _data(th.device)
    resid = y - th[0] - th[1] * x - th[2] * x ** 2
    return (-0.5 * torch.sum(resid ** 2) / SIGMA ** 2
            - 0.5 * torch.sum(th[:3] ** 2))


@memoized_set
def model_set() -> ModelSet:
    return ModelSet([
        Model("linear", 2, logp=logp_linear, init=np.zeros(2)),
        Model("quadratic", 3, logp=logp_quadratic, init=np.zeros(3)),
    ])


def exact_model_probs() -> np.ndarray:
    """p(M | y) of the two models as the sampler defines them (each
    ``logp`` integrated over its coefficients, equal model weights): the
    Gaussian integral exp(-y'y / 2 s^2 + b' A^-1 b / 2) (2 pi)^(d/2)
    |A|^(-1/2), A = X'X / s^2 + I, b = X'y / s^2, in float64."""
    logz = []
    for d in (2, 3):
        design = np.stack([X ** i for i in range(d)], axis=1)
        A = design.T @ design / SIGMA ** 2 + np.eye(d)
        b = design.T @ Y / SIGMA ** 2
        logz.append(-0.5 * Y @ Y / SIGMA ** 2
                    + 0.5 * b @ np.linalg.solve(A, b)
                    + 0.5 * d * np.log(2 * np.pi)
                    - 0.5 * np.linalg.slogdet(A)[1])
    logz = np.array(logz)
    p = np.exp(logz - logz.max())
    return p / p.sum()


def main():
    device = "cpu" if "--cpu" in sys.argv else "cuda"
    ms = model_set()
    am = AMSampler(ms, EngineConfig(n_chains=2048, seed=1,
                                    n_chains_stage1=1024,
                                    stage1_sweeps=2000), device=device)
    am.burn_samples(2000)
    stats = am.rjmcmc_samples(20_000)
    print("posterior model probabilities (RJ visit fractions):")
    for m, p in zip(ms.models, stats.model_probs):
        print(f"  {m.name:10s} {p:.4f}")
    print("exact:", np.round(exact_model_probs(), 4))
    means = stats.theta_mean()
    print("quadratic-model coefficient means:", np.round(means[1, :3], 3),
          "(true: [1.0, 0.5, 1.5])")


if __name__ == "__main__":
    main()
