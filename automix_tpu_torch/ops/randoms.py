"""Counter-hash randomness of the fused kernels and the general engine.

Counterpart of the in-kernel hash of ``automix_tpu/kernels/fused.py``
(``_triple32``, ``_lowbias32``, ``_u01``, ``_gumbel`` and the ``hash``
branch of ``draw_words``) and of the stage-1 batch-wide ``block_coin``
(``automix_tpu/kernels/fused_stage1.py``), plus the Box-Muller and
Bailey polar draws and the latent log-densities built on the words
(``fused.py`` 337-351, 479-504).  Every word is a pure function
of (seed, global sweep, global chain, slot), so the port reproduces the
JAX package's words bit for bit; ``csrc/common.cuh`` holds the same
functions for the CUDA kernels.

The general engine's ``fast`` stream (``fast_sweep_randoms``, from
``automix_tpu/ops/randoms.py``) hashes the same way at counters
row * (MU + MZ) + slot.  Its uniforms are ``bits_to_uniform`` without the
kernels' clamp, so a word whose top 24 bits are all ones gives exactly
1.0, as in JAX; its normals are sqrt(2) * erf_inv(2u - 1) with
:func:`erf_inv`, XLA's float32 polynomial, so u = 1.0 gives z = +inf
there too.

The stage-3 kernel's second stream, ``hw`` (K1f, the port's counterpart
of the JAX kernel's TPU hardware PRNG), keeps one 64-bit state per chain:
:func:`hw_state` seeds it at a launch's first sweep from (seed, sweep0,
global chain) through the hash, :func:`hw_step` advances it once per sweep
(a PCG32 step: the LCG state * 6364136223846793005 + 1442695040888963407
mod 2^64, and the XSH-RR output of the old state as the sweep's 32-bit
key), and :func:`hw_words` makes each word a pure function of (key, slot),
lowbias32(key ^ slot * 0x9E3779B9).  Like the TPU stream it is
chunk-granular: a launch reseeds, so runs chunked alike are bitwise equal
and runs chunked otherwise draw other words.

The general engine's third stream is JAX's own: threefry2x32 with the
key functions and samplers of ``jax.random`` (the end of this module),
for the chains' keys, the ``threefry`` sweep draws, stage 1's scan and
the draws of HMC and SMC.

torch has no complete uint32 arithmetic, so words live in int64 tensors
holding values in [0, 2^32): every multiply and add is masked back to 32
bits before the next shift.  A product that wraps int64 keeps its low 32
bits, so the masked result is exact.  The ``hw`` stream's functions do not
rely on that: they split each 32 x 32-bit product into 16-bit halves, and
hold the 64-bit state as two 32-bit halves (lo, hi).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from automix_tpu_torch.ops.plmath import HALF_LOG_2PI

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


def hash_words(seed: int, t: int, counters):
    """Words of sweep ``t`` at uint32 ``counters`` (int64 tensor):
    triple32(c ^ salt1) ^ lowbias32(c + salt2)."""
    salt1, salt2 = sweep_salts(seed, t)
    return triple32(counters ^ salt1) ^ lowbias32((counters + salt2) & _M32)


def sweep_words(seed: int, t: int, chain_ids, slots):
    """[len(slots), S] words of sweep ``t``: counter = chain * NW + slot,
    the ``draw_words`` formula of the fused kernel in ``hash`` mode
    (``slots`` is ``range(NW)`` there)."""
    nw = len(slots)
    slot_t = torch.as_tensor(list(slots), dtype=torch.int64,
                             device=chain_ids.device)
    c = (chain_ids.to(torch.int64)[None, :] * nw + slot_t[:, None]) & _M32
    return hash_words(seed, t, c)


# The hw stream (K1f): PCG32's multiplier and increment, and the golden
# ratio that spreads the slots of a sweep's words.
_PCG_MUL = 6364136223846793005
_PCG_INC = 1442695040888963407
_GOLDEN = 0x9E3779B9


def mulhilo(m: int, b):
    """(hi, lo) 32-bit halves of the uint32 constant ``m`` times the uint32
    words ``b`` (int64 tensor), every partial product below 2^49."""
    p_lo = m * (b & 0xFFFF)
    mid = m * (b >> 16) + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def _mul_lo(x, c: int):
    """The low 32 bits of ``x * c`` (uint32 values, a uint32 constant)."""
    return mulhilo(c, x)[1]


def hw_state(seed: int, sweep0: int, chain_ids):
    """The hw stream's per-chain state at a launch whose first sweep is
    ``sweep0``: (lo, hi), the hash words of sweep ``sweep0`` at counters
    2 * chain and 2 * chain + 1 (``chain_ids`` the global chain indices, an
    int64 tensor)."""
    c = (chain_ids.to(torch.int64) * 2) & _M32
    return (hash_words(seed, sweep0, c),
            hash_words(seed, sweep0, (c + 1) & _M32))


def hw_step(state):
    """One sweep's advance of the hw stream: (the next state, the sweep's
    32-bit key), the key being the XSH-RR output of the current state."""
    lo, hi = state
    # state * _PCG_MUL + _PCG_INC mod 2^64, in 32-bit halves
    m_lo, m_hi = _PCG_MUL & _M32, _PCG_MUL >> 32
    p_hi, p_lo = mulhilo(m_lo, lo)
    s_lo = p_lo + (_PCG_INC & _M32)
    n_hi = (p_hi + _mul_lo(lo, m_hi) + _mul_lo(hi, m_lo) + (_PCG_INC >> 32)
            + (s_lo >> 32)) & _M32
    # XSH-RR: x = ((old >> 18) ^ old) >> 27 (low 32 bits), rotated right by
    # old >> 59
    y_lo = ((lo >> 18) | ((hi << 14) & _M32)) ^ lo
    y_hi = (hi >> 18) ^ hi
    x = (y_lo >> 27) | ((y_hi << 5) & _M32)
    rot = hi >> 27
    key = (x >> rot) | ((x << ((32 - rot) & 31)) & _M32)
    return (s_lo & _M32, n_hi), key


def hw_words(key, slots):
    """[len(slots), S] words of one sweep from its keys [S]:
    lowbias32(key ^ slot * 0x9E3779B9)."""
    slot_t = torch.as_tensor(list(slots), dtype=torch.int64,
                             device=key.device)
    x = key[None, :] ^ ((slot_t * _GOLDEN) & _M32)[:, None]
    x = x ^ (x >> 16)
    x = _mul_lo(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_lo(x, 0x846CA68B)
    return x ^ (x >> 16)


def bits_to_uniform(words):
    """Words -> float32 top 24 bits * 2^-24 + 2^-25 (``_bits_to_uniform``
    of the JAX package): all ones in the top bits gives exactly 1.0."""
    return (words >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


def u01(words):
    """Words -> float32 uniforms in (0, 1): top 24 bits plus a half ulp,
    clamped to the largest float32 below 1 (1 - 2^-25 rounds to 1.0)."""
    return torch.clamp(bits_to_uniform(words), max=_U01_MAX)


# XLA's float32 log1p (a Cephes rational for |x| < sqrt(2) - 1, else
# log(1 + x)) and erf_inv (Giles, "Approximating the erfinv function": two
# degree-8 polynomials in w = -log1p(-x^2), split at w = 5), with their
# coefficients rounded to float32.  XLA's CPU backend contracts each Horner
# step to a fused multiply-add, so :func:`_horner` rounds each step once.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
_LOG1P_SMALL = 0.41421356237309504880


@functools.lru_cache(maxsize=None)
def _coeffs(rows: tuple, device: str):
    """[n, degree + 1] float64 tensor of float32-rounded coefficient
    lists, made once per device."""
    return torch.tensor(rows, dtype=torch.float32).to(torch.float64) \
        .to(device)


def _horner(x2, rows: tuple):
    """Several polynomials at once: ``x2`` [n, ...] float32 points,
    ``rows`` the n coefficient lists, highest degree first.  Each step
    p * x + c is exact in float64 and rounded once to float32: a fused
    multiply-add (where the float64 sum sits on a float32 midpoint, the
    second rounding can differ from it by one ulp)."""
    c = _coeffs(rows, str(x2.device))
    c = c.reshape(c.shape + (1,) * (x2.dim() - 1))
    xd = x2.to(torch.float64)
    p = c[:, 0].expand_as(x2).to(torch.float32)
    for i in range(1, c.shape[1]):
        p = torch.addcmul(c[:, i], p.to(torch.float64), xd) \
            .to(torch.float32)
    return p


# XLA's CPU float32 log (Cephes logf): x = m * 2^e with m in [1/2, 1),
# folded to [sqrt(1/2), sqrt(2)), then three degree-2 pieces of a degree-8
# polynomial in t = m - 1.
_LOG_P = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
          (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
          (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))


def _fma(a, b, c):
    return torch.addcmul(c.to(torch.float64), a.to(torch.float64),
                         b.to(torch.float64)).to(torch.float32)


def _log(x):
    """log of float32 x > 0 in XLA's operation order."""
    bits = torch.clamp(x, min=2.0 ** -126).view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    y = _horner(torch.stack([t, t, t]), _LOG_P)
    y = _fma(_fma(y[0], x3, y[1]), x3, y[2]) * x3
    y = y + -2.12194440e-4 * e
    t = t - 0.5 * x2
    t = t + y
    return t + 0.693359375 * e


def _log1p(x):
    """log1p in XLA's operation order."""
    x2 = x * x
    nd = _horner(torch.stack([x, x]), (_LOG1P_NUM, _LOG1P_DEN))
    small = x + (-0.5 * x2 + (x * x2) * (nd[0] / nd[1]))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, _log(x + 1.0))


def erf_inv(x):
    """float32 inverse error function in the operation order of XLA's
    ``erf_inv`` (``jax.lax.erf_inv``), +-inf at x = +-1.  torch.erfinv is
    another approximation: ~59% of the fast stream's normals differ from
    JAX's, by up to ~80 ulps; this one, with XLA's log1p and log, is
    within a few ulps of JAX's on the CPU (tests/test_torch_fast_rng.py
    states the share that differs)."""
    w = -_log1p(x * -x)
    p = _horner(torch.stack([w - 2.5, torch.sqrt(w) - 3.0]),
                (_ERFINV_W_LT_5, _ERFINV_W_GE_5))
    out = torch.where(w < 5.0, p[0], p[1]) * x
    return torch.where(torch.abs(x) == 1.0, x * math.inf, out)


_SQRT2 = float(np.sqrt(np.float32(2.0)))


def fast_sweep_randoms(seed: int, sweep: int, chain0: int, n_chains: int,
                       mu_count: int, mz_count: int, device="cpu"):
    """Uniforms [S, MU] and normals [S, MZ] of one general-engine sweep
    (``fast_sweep_randoms`` of the JAX package): words at counters
    (chain0 + row) * (MU + MZ) + slot, uniforms without the clamp,
    normals sqrt(2) * erf_inv(2u - 1)."""
    w = mu_count + mz_count
    rows = (chain0 + torch.arange(n_chains, dtype=torch.int64,
                                  device=device)) & _M32
    slots = torch.arange(w, dtype=torch.int64, device=device)
    counters = (rows[:, None] * w + slots[None, :]) & _M32
    uall = bits_to_uniform(hash_words(seed, sweep, counters))
    z = _SQRT2 * erf_inv(2.0 * uall[:, mu_count:] - 1.0)
    return uall[:, :mu_count], z


def gumbel(u):
    return -torch.log(-torch.log1p(-u) + 1e-38)


def block_coin(seed: int, t: int) -> bool:
    """Stage-1 batch-wide block-move coin of sweep ``t``: an integer
    compare standing for u < 0.1 (one coin per sweep for all chains)."""
    h = triple32(((t * 2654435761 + seed) & _M32) ^ 0xB5297A4D)
    return (h >> 8) < int(0.1 * 2 ** 24)


_TWO_PI = 6.283185307179586


class StudentT(NamedTuple):
    """float32 constants of the Student-t draws and latent density for a
    dof, computed on the host in float64 and rounded once, as the JAX
    kernels fold them (``kernels/fused.py`` ``_lt_const``)."""

    dof: float             # float32(dof)
    neg2_over_dof: float   # float32(-2 / dof)
    half_dof1: float       # float32(0.5 * (dof + 1))
    inv_dof: float         # float32(1 / dof)
    lt_const: float        # float32(lgamma((dof+1)/2) - lgamma(dof/2)
    #                                 - log(dof * pi) / 2)


def student_t(dof: int) -> StudentT:
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return StudentT(
        dof=f32(dof), neg2_over_dof=f32(-2.0 / dof),
        half_dof1=f32(0.5 * (dof + 1)), inv_dof=f32(1.0 / dof),
        lt_const=f32(math.lgamma(0.5 * (dof + 1)) - math.lgamma(0.5 * dof)
                     - 0.5 * math.log(dof * math.pi)))


def bailey_t(u1, u2, tc: StudentT):
    """Bailey's polar t(dof) variate from two uniforms:
    sqrt(dof * (u1^(-2/dof) - 1)) * cos(2 pi u2), in the kernels'
    operation order."""
    r = torch.sqrt(tc.dof * (torch.exp(tc.neg2_over_dof * torch.log(u1))
                             - 1.0))
    return r * torch.cos(_TWO_PI * u2)


def box_muller(u1, u2):
    """(cos, sin) normal pair of the kernels' Box-Muller transform."""
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    ang = _TWO_PI * u2
    return r * torch.cos(ang), r * torch.sin(ang)


def latent_lpdf(w, tc: StudentT | None):
    """Log-density of one latent filler coordinate: t(dof) when ``tc`` is
    given, else N(0, 1)."""
    if tc is not None:
        return tc.lt_const - tc.half_dof1 * torch.log1p(w * w * tc.inv_dof)
    return -0.5 * w * w - HALF_LOG_2PI


# ---------------------------------------------------------------------------
# JAX's threefry2x32 stream (``jax.random`` of JAX 0.9 with its defaults,
# ``jax_threefry_partitionable=True`` and the threefry2x32 implementation):
# the general engine's ``threefry`` mode, the stage-1 scan's words, the
# chain keys and the draws of HMC and SMC.
#
# A key is two uint32 words.  A single key is a tuple of two Python ints,
# so a chain of splits and folds on the host costs no tensor operation; a
# batch of keys is an int64 tensor [..., 2].  Every function takes either
# and broadcasts a single key against the counters of a draw.  The words
# live in int64 as the hash's do; the round's sum x0 + x1 is masked only
# where its high bits could reach the low 32 (shifted right), so x0 runs
# unmasked through a block of rounds.
# ---------------------------------------------------------------------------

_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TF_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (``prng.py _threefry2x32_lowering``):
    the two output words of counters (x0, x1) under key (k0, k1), uint32
    values as Python ints or int64 tensors, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _TF_PARITY)
    x0 = x0 + k0
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _TF_ROT[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int):
    """``jax.random.PRNGKey(seed)`` of a 32-bit seed: (0, seed mod 2^32)."""
    return (0, int(seed) & _M32)


def key_tensor(k, device="cpu"):
    """A key (tuple or tensor) as an int64 tensor [..., 2] on ``device``."""
    if isinstance(k, tuple):
        return torch.tensor(k, dtype=torch.int64, device=device)
    return k.to(device)


def _halves(k):
    if isinstance(k, tuple):
        return k
    return k[..., 0], k[..., 1]


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _bcast(k, n_new: int):
    """Key words with ``n_new`` trailing axes for broadcasting against the
    counters of a draw."""
    k0, k1 = _halves(k)
    if isinstance(k0, int):
        return k0, k1
    view = k0.shape + (1,) * n_new
    return k0.reshape(view), k1.reshape(view)


def _iota(shape, device):
    n = math.prod(shape)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _device(k, device):
    if device is not None:
        return device
    return "cpu" if isinstance(k, tuple) else k.device


def split(k, num=2, device=None):
    """``jax.random.split``: keys [..., *num, 2] from keys [..., 2] (a tuple
    key gives a tensor on ``device``, the CPU by default): threefry of
    the counters (0, i) for i over the new shape, its two words the new
    key (``_threefry_split_foldlike``)."""
    shape = _shape(num)
    k0, k1 = _bcast(k, len(shape))
    b0, b1 = threefry2x32(k0, k1, 0, _iota(shape, _device(k, device)))
    return torch.stack([b0, b1], dim=-1)


def split_host(k, num: int = 2):
    """``split`` of one tuple key on the host: a list of tuple keys."""
    k0, k1 = k
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def fold_in(k, data):
    """``jax.random.fold_in``: threefry of the counters (0, data) under the
    key.  A tuple key and an int give a tuple key; otherwise keys [..., 2]
    (``data`` an int or an int64 tensor broadcast against the batch)."""
    k0, k1 = _halves(k)
    if isinstance(data, int):
        data = data & _M32
    else:
        data = data.to(torch.int64) & _M32
    b0, b1 = threefry2x32(k0, k1, 0, data)
    if isinstance(b0, int):
        return (b0, b1)
    return torch.stack([b0, b1], dim=-1)


def random_bits(k, shape, device=None):
    """``jax.random.bits`` in 32 bits: [..., *shape] words, the xor of the
    two threefry words of the counters (0, i), i the row-major index into
    ``shape`` (``_threefry_random_bits_partitionable``)."""
    shape = _shape(shape)
    k0, k1 = _bcast(k, len(shape))
    b0, b1 = threefry2x32(k0, k1, 0, _iota(shape, _device(k, device)))
    return b0 ^ b1


def _unit_floats(bits):
    """Words -> float32 in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (``random.py _uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def uniform_of_bits(bits, minval: float = 0.0, maxval: float = 1.0):
    """Words -> float32 uniforms in [minval, maxval) as ``jax.random.
    uniform`` makes them: max(minval, f (maxval - minval) + minval) for
    the unit floats f."""
    f = _unit_floats(bits)
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    if span != 1.0 or lo != 0.0:
        f = f * span + float(lo)
    return torch.clamp(f, min=float(lo))


def uniform(k, shape, device=None, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32 of the key's words."""
    return uniform_of_bits(random_bits(k, shape, device), minval, maxval)


def uniform_host(k) -> np.float32:
    """``jax.random.uniform(k, ())`` of one tuple key, on the host."""
    b0, b1 = threefry2x32(k[0], k[1], 0, 0)
    f = np.array([((b0 ^ b1) >> 9) | 0x3F800000], np.uint32)
    return np.float32(f.view(np.float32)[0] - np.float32(1.0))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal_of_bits(bits):
    """Words -> float32 normals as ``jax.random.normal`` makes them:
    sqrt(2) erf_inv(u) with u uniform in (nextafter(-1, 0), 1)."""
    return _SQRT2 * erf_inv(uniform_of_bits(bits, _NORMAL_LO, 1.0))


def normal(k, shape, device=None):
    """``jax.random.normal`` in float32 of the key's words."""
    return normal_of_bits(random_bits(k, shape, device))


def randint(k, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint`` in int32 (int64 tensor): two 32-bit words per
    value from the key's two halves, reduced modulo the span as JAX
    does."""
    if isinstance(k, tuple):
        k = key_tensor(k, _device(k, device))
    halves = split(k, 2)
    hi = random_bits(halves[..., 0, :], shape)
    lo = random_bits(halves[..., 1, :], shape)
    span = max(int(maxval) - int(minval), 1) & _M32
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    return int(minval) + (off & _M32) % span


_TINY = float(np.finfo(np.float32).tiny)


def gumbel_noise(k, shape, device=None):
    """``jax.random.gumbel`` (mode "low") in float32: -log(-log(u)) with u
    uniform in [tiny, 1), through XLA's float32 log."""
    return -_log(-_log(uniform(k, shape, device, _TINY, 1.0)))


def categorical(k, logits, axis: int = -1):
    """``jax.random.categorical``: argmax over ``axis`` of the logits plus
    Gumbel noise of their shape (ties to the first index, as
    ``jnp.argmax``)."""
    g = gumbel_noise(k, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=axis)


_THIRD = float(np.float32(1.0 / 3.0))


def _gamma_one(keys, alpha: float):
    """Marsaglia-Tsang draws of Gamma(alpha) with one key per draw (``keys``
    [N, 2]; ``random.py _gamma_one``), as a masked loop over the draws
    not yet accepted: each round splits an active key into three, draws a
    normal x from a split of the second until v = 1 + c x > 0 and a
    uniform U from the third, and accepts where U < 1 - 0.0331 x^4 or
    log U < x^2 / 2 + d (1 - v^3 + log v^3)."""
    dev = keys.device
    alpha32 = np.float32(alpha)
    boost = bool(alpha32 >= 1.0)
    a = alpha32 if boost else np.float32(alpha32 + np.float32(1.0))
    d = float(np.float32(a - np.float32(_THIRD)))
    c = float(np.float32(np.float32(_THIRD) / np.sqrt(np.float32(d))))
    n = keys.shape[0]
    first = split(keys, 2)
    key_c, subkey = first[:, 0], first[:, 1]
    X = torch.zeros(n, dtype=torch.float32, device=dev)
    V = torch.ones(n, dtype=torch.float32, device=dev)
    idx = torch.arange(n, device=dev)
    lanes = torch.tensor([1, 1, 2], device=dev)
    counts = torch.tensor([0, 1, 0], dtype=torch.int64, device=dev)
    while idx.numel():
        parts = split(key_c[idx], 3)
        key_c[idx] = parts[:, 0]
        # one threefry pass for the split of the normal's key (its first
        # round) and the uniform U
        b0, b1 = threefry2x32(parts[:, lanes, 0], parts[:, lanes, 1], 0,
                              counts)
        U = uniform_of_bits(b0[:, 2] ^ b1[:, 2])
        x_key = torch.stack([b0[:, 0], b1[:, 0]], dim=-1)
        sub = torch.stack([b0[:, 1], b1[:, 1]], dim=-1)
        x = normal(sub, ())
        # 1 + x c as one fused multiply-add, as XLA's CPU code has it
        v = _fma(x, torch.full_like(x, c), torch.ones_like(x))
        pend = torch.nonzero(v <= 0.0).flatten()
        while pend.numel():
            kx = split(x_key[pend], 2)
            x_key[pend] = kx[:, 0]
            xp = normal(kx[:, 1], ())
            x[pend] = xp
            v[pend] = _fma(xp, torch.full_like(xp, c), torch.ones_like(xp))
            pend = pend[v[pend] <= 0.0]
        Xi = x * x
        Vi = v * v * v
        X[idx] = Xi
        V[idx] = Vi
        more = (U >= 1.0 - 0.0331 * (Xi * Xi)) \
            & (_log(U) >= Xi * 0.5 + d * ((1.0 - Vi) + _log(Vi)))
        idx = idx[more]
    out = d * V
    if not boost:
        s = 1.0 - uniform(subkey, ())
        out = out * torch.pow(s, float(np.float32(1.0) / alpha32))
    return out


def gamma(k, alpha: float, shape, device=None):
    """``jax.random.gamma(k, alpha, shape)`` in float32, for keys [..., 2]
    (or a tuple key): one key per draw by ``split(k, prod(shape))``, then
    :func:`_gamma_one` (``random.py _gamma_impl``)."""
    shape = _shape(shape)
    if isinstance(k, tuple):
        k = key_tensor(k, _device(k, device))
    keys = split(k, math.prod(shape))
    out = _gamma_one(keys.reshape(-1, 2), alpha)
    return out.reshape(k.shape[:-1] + shape)


def t_scale(z, k, shape, dof: int):
    """Normals ``z`` [..., *shape] drawn from keys ``k`` [..., 2] made
    Student-t(dof): z / sqrt(g / s) with g ``gamma(fold_in(k, 1), s)``
    and s = dof / 2; dof == 0 leaves z."""
    if dof <= 0:
        return z
    s = 0.5 * dof
    return z / torch.sqrt(gamma(fold_in(k, 1), s, shape, z.device) / s)


def rand_t(k, shape, dof: int, device=None):
    """Independent Student-t(dof) draws (``automix_tpu/ops/randoms.py
    rand_t``): :func:`t_scale` of ``normal(k)``; dof == 0 gives the
    normals."""
    return t_scale(normal(k, shape, device), k, shape, dof)


def keyed_words(keys, counts):
    """One threefry pass for several draws at once: ``keys`` [..., n, 2]
    and ``counts`` [n] give the words [..., n] of each key at its count
    (the words of ``random_bits`` for draws laid side by side)."""
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], 0, counts)
    return b0 ^ b1
