"""Counter-hash randomness of the fused kernels, in torch.

Counterpart of the in-kernel hash of ``automix_tpu/kernels/fused.py``
(``_triple32``, ``_lowbias32``, ``_u01``, ``_gumbel`` and the ``hash``
branch of ``draw_words``) and of the stage-1 batch-wide ``block_coin``
(``automix_tpu/kernels/fused_stage1.py``).  Every word is a pure function
of (seed, global sweep, global chain, slot), so the port reproduces the
JAX package's words bit for bit; ``csrc/common.cuh`` holds the same
functions for the CUDA kernels.

torch has no complete uint32 arithmetic, so words live in int64 tensors
holding values in [0, 2^32): every multiply and add is masked back to 32
bits before the next shift.  A product that wraps int64 keeps its low 32
bits, so the masked result is exact.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# Largest float32 strictly below 1 (the clamp of the fused kernels' _u01).
_U01_MAX = 1.0 - 2.0 ** -24


def _mul(x, c: int):
    return (x * c) & _M32


def triple32(x):
    """Avalanche hash of uint32 values held in int64 tensors or Python
    ints."""
    x = x ^ (x >> 17)
    x = _mul(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul(x, 0x31848BAB)
    return x ^ (x >> 14)


def lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def sweep_salts(seed: int, t: int):
    """The two per-(seed, sweep) salts of the word hash (Python ints)."""
    seed_u = seed & _M32
    sweep_u = t & _M32
    return (triple32(sweep_u ^ _mul(seed_u, 0x9E3779B9)),
            lowbias32((sweep_u + 0x85EBCA6B + seed_u * 0xC2B2AE35) & _M32))


def sweep_words(seed: int, t: int, chain_ids, slots):
    """[len(slots), S] words of sweep ``t``: counter = chain * NW + slot,
    the ``draw_words`` formula of the fused kernel in ``hash`` mode
    (``slots`` is ``range(NW)`` there)."""
    nw = len(slots)
    slot_t = torch.as_tensor(list(slots), dtype=torch.int64,
                             device=chain_ids.device)
    c = (chain_ids.to(torch.int64)[None, :] * nw + slot_t[:, None]) & _M32
    salt1, salt2 = sweep_salts(seed, t)
    return triple32(c ^ salt1) ^ lowbias32((c + salt2) & _M32)


def u01(words):
    """Words -> float32 uniforms in (0, 1): top 24 bits plus a half ulp,
    clamped to the largest float32 below 1 (1 - 2^-25 rounds to 1.0)."""
    u = (words >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)
    return torch.clamp(u, max=_U01_MAX)


def gumbel(u):
    return -torch.log(-torch.log1p(-u) + 1e-38)


def block_coin(seed: int, t: int) -> bool:
    """Stage-1 batch-wide block-move coin of sweep ``t``: an integer
    compare standing for u < 0.1 (one coin per sweep for all chains)."""
    h = triple32(((t * 2654435761 + seed) & _M32) ^ 0xB5297A4D)
    return (h >> 8) < int(0.1 * 2 ** 24)
