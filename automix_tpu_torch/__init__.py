"""automix_tpu_torch: the PyTorch + CUDA port of automix_tpu.

The tutorial main path (stage-1 adaptive RWM, stage-2 EM, stage-3
reversible-jump sweeps) runs through two hand-written CUDA kernels on an
NVIDIA H100 (``csrc/``), with plain PyTorch twins that run on the CPU.
This package never imports JAX or ``automix_tpu``.
"""

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.model import CudaDensity, Model, ModelSet
from automix_tpu_torch.sampler import AMSampler
from automix_tpu_torch.state import Chains, Proposal, RunStats

__all__ = ["AMSampler", "Chains", "CudaDensity", "EngineConfig", "Model",
           "ModelSet", "Proposal", "RunStats"]
