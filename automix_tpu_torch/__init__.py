"""automix_tpu_torch: the PyTorch + CUDA port of automix_tpu.

The three AutoMix stages (stage-1 adaptive RWM, stage-2 EM, stage-3
reversible-jump sweeps, with perm and Student-t options) run through
hand-written CUDA kernels on an NVIDIA H100 (``csrc/``) for model sets
with compiled CUDA densities, and through the general engine (plain
PyTorch on the same device, with the K4 draw kernel) for any other set,
a user's per-theta ``logp`` models among them.  HMC within-model moves
and annealed SMC evidences (``AMSampler.smc_evidence``) run on the
general engine.  Every kernel has a plain
PyTorch twin that runs on the CPU.  The CLI
(``python -m automix_tpu_torch.cli``) drives them on the tutorial, toy
and builtin problems and writes the reference's report files.  This
package never imports JAX or ``automix_tpu``.
"""

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.model import CudaDensity, Model, ModelSet
from automix_tpu_torch.sampler import AMSampler
from automix_tpu_torch.state import Chains, Proposal, RunStats

__all__ = ["AMSampler", "Chains", "CudaDensity", "EngineConfig", "Model",
           "ModelSet", "Proposal", "RunStats"]
