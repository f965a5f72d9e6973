"""Branch-free log-gamma shared by the column densities.

Counterpart of ``automix_tpu/ops/plmath.py``: the shifted Stirling series
lgamma(x) = lgamma(x+4) - log(x(x+1)(x+2)(x+3)) with three correction
terms, in the same operation order (``csrc/common.cuh`` has the device
twin).  Relative error < 1e-6 for x in (0, 1e4]; callers guard x > 0.
"""

from __future__ import annotations

import torch

HALF_LOG_2PI = 0.9189385332046727


def pal_gammaln(x):
    p = x * (x + 1.0) * (x + 2.0) * (x + 3.0)
    z = x + 4.0
    r = 1.0 / z
    r2 = r * r
    series = r * (1.0 / 12.0 + r2 * (-1.0 / 360.0 + r2 * (1.0 / 1260.0)))
    return ((z - 0.5) * torch.log(z) - z + HALF_LOG_2PI + series
            - torch.log(p))
