"""K4: the general engine's per-sweep random draws (``rng="pallas"``).

Counterpart of ``automix_tpu/kernels/sweep_rng.py``: ``CHAIN_BLOCK``,
``choose_block``, ``resolve_rng`` and ``draw``, which gives one stage-3
sweep's uniforms [S, MU] and Box-Muller normals [S, MZ] from a stream
seeded per (seed, sweep, global chain block).  The TPU kernel draws from
the core's hardware PRNG; the port's kernel (``csrc/sweep_rng.cu``) runs
Philox-4x32-10 per chain row, and :func:`draw_ref` is its plain twin in
torch int64, bitwise on the words.  The two packages share the contract
(uniforms strictly inside (0, 1), normals in the TPU kernel's column
layout, a draw depending only on (seed, sweep, global block, row in
block)), not the words.

Philox-4x32-10: per round, (hi0, lo0) = M0 * c0 and (hi1, lo1) = M1 * c2
as 64-bit products, then c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0),
and the key is bumped by (W0, W1) between rounds.  A 32 x 32 -> 64-bit
product overflows int64, so the twin splits the counter word into 16-bit
halves.
"""

from __future__ import annotations

import torch

from automix_tpu_torch.kernels import _build
from automix_tpu_torch.ops import randoms

# Chains per Philox key.  Fixed so a draw is a pure function of the
# chain's global index, independent of sharding.
CHAIN_BLOCK = 1024

_M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586


def choose_block(s_local: int) -> int:
    """Largest power-of-two block <= CHAIN_BLOCK dividing the local chain
    count."""
    cb = CHAIN_BLOCK
    while cb > 1 and s_local % cb != 0:
        cb //= 2
    return cb


def resolve_rng(cfg) -> str:
    """cfg.rng resolved to a stream of the general engine, as JAX's
    ``resolve_rng``: "auto" is "fast" for float32 Gaussian runs and
    "threefry" otherwise (Student-t: the chains' keys)."""
    if cfg.rng != "auto":
        return cfg.rng
    if cfg.student_t_dof == 0 and cfg.dtype == torch.float32:
        return "fast"
    return "threefry"


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox-4x32-``rounds`` of counters (c0, c1, c2, c3) under key
    (k0, k1): uint32 values in int64 tensors or Python ints, broadcast."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _M32
            k1 = (k1 + _W1) & _M32
        hi0, lo0 = randoms.mulhilo(_M0, c0)
        hi1, lo1 = randoms.mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draw_ref(seed: int, sweep: int, block0: int, n_chains: int,
             mu_count: int, mz_count: int, device="cpu"):
    """Plain twin of the K4 kernel: u [S, MU] and z [S, MZ] float32."""
    cb = choose_block(n_chains)
    n_pairs = (mz_count + 1) // 2
    n_words = mu_count + 2 * n_pairs
    n_groups = -(-n_words // 4)
    rows = torch.arange(n_chains, dtype=torch.int64, device=device)
    k0 = ((seed & _M32) + (block0 + rows // cb) * _W0) & _M32
    rib = (rows % cb)[:, None].expand(n_chains, n_groups)
    grp = torch.arange(n_groups, dtype=torch.int64, device=device)
    grp = grp[None, :].expand(n_chains, n_groups)
    zero = torch.zeros_like(rib)
    words = philox4x32(rib, grp, zero, zero, k0[:, None], sweep & _M32)
    words = torch.stack(words, dim=-1).reshape(n_chains, 4 * n_groups)
    uall = randoms.u01(words[:, :n_words])
    u1 = uall[:, mu_count:mu_count + n_pairs]
    u2 = uall[:, mu_count + n_pairs:]
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    ang = _TWO_PI * u2
    z = torch.cat([r * torch.cos(ang), r * torch.sin(ang)], dim=1)
    return uall[:, :mu_count].contiguous(), z[:, :mz_count].contiguous()


def draw(seed: int, sweep: int, block0: int, n_chains: int, mu_count: int,
         mz_count: int, device):
    """One sweep's u [S, MU] and z [S, MZ] on ``device``: the CUDA kernel
    on the card (counted in ``draw.launches``), its plain twin on the CPU.
    ``block0`` is the first global chain block of these rows (0
    unsharded)."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_ref(seed, sweep, block0, n_chains, mu_count, mz_count,
                        device)
    if device.type != "cuda":
        raise ValueError(f"draw: unsupported device {device}")
    u = torch.empty((n_chains, mu_count), dtype=torch.float32, device=device)
    z = torch.empty((n_chains, mz_count), dtype=torch.float32, device=device)
    status = _build.library().am_sweep_rng(
        n_chains, mu_count, mz_count, choose_block(n_chains), seed & _M32,
        sweep & _M32, block0, u.data_ptr(), z.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(status, "am_sweep_rng")
    draw.launches += 1
    return u, z


draw.launches = 0
