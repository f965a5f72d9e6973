"""Stage 1 entry point: adaptive within-model RWM for every model at once.

Counterpart of ``run_stage1`` in ``automix_tpu/kernels/rwm.py`` (its fused
branch, the only engine the port has): C chains per model for all K
models run the pooled-adaptation segments of ``fused_stage1``; their
thinned tail snapshots feed the stage-2 fit.
"""

from __future__ import annotations

import torch

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.kernels import fused_stage1


def run_stage1(modelset, cfg: EngineConfig, generator: torch.Generator,
               nsweeps: int, device, n_chains_per_model: int | None = None):
    """Returns ``(sig [K, D], samples [K, C * n_tail, D], telemetry)``; the
    telemetry holds the sig and pooled acceptance traces at segment
    boundaries, the final logp [K, C] and the sweep count."""
    C = n_chains_per_model or cfg.n_chains_stage1
    init_theta = modelset.init_points(generator)             # [K, D]
    sig, samples, tele_sig, tele_acc, lp = fused_stage1.run_fused_stage1(
        modelset, cfg, nsweeps, C, init_theta, device)
    return sig, samples, {
        "sig_trace": tele_sig,
        "accept_trace": tele_acc,
        "final_logp": lp,
        "nsweeps": nsweeps + nsweeps // 10,
    }
