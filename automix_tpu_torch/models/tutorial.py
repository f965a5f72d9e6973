"""The tutorial model-choice problem: Normal vs Beta vs Gamma.

Counterpart of ``automix_tpu/models/tutorial.py``: three 2-parameter
models of ten observations, with published posterior model probabilities
0.7928 / 0.0239 / 0.1834.
"""

from __future__ import annotations

import functools

import numpy as np

from automix_tpu_torch.model import Model, ModelSet
from automix_tpu_torch.models.builtin import make_params_targets_cols

TUTORIAL_DATA = np.array([0.2, 0.13, 0.35, 0.17, 0.89,
                          0.33, 0.78, 0.23, 0.54, 0.16])

# Published reference posteriors.
TUTORIAL_MODEL_PROBS = np.array([0.7928, 0.0239, 0.1834])


@functools.cache
def tutorial_set() -> ModelSet:
    """The tutorial ModelSet with its start points (0.5, 0.5), (2, 2),
    (9, 2).  Model sets are immutable, so one instance is shared."""
    (normal, beta, gamma), (cu_n, cu_b, cu_g) = \
        make_params_targets_cols(TUTORIAL_DATA)
    return ModelSet([
        Model("normal", 2, normal, init=np.array([0.5, 0.5]), cuda=cu_n),
        Model("beta", 2, beta, init=np.array([2.0, 2.0]), cuda=cu_b),
        Model("gamma", 2, gamma, init=np.array([9.0, 2.0]), cuda=cu_g),
    ])
