"""The stage-3 sweep kernel's allocation and builtin densities, in the
kernel's order of operations, against the plain twin on the CPU.

``csrc/fused_sweep.cu`` (``am_alloc``) keeps an allocation's logits in the
thread's column of shared memory (a local array at the larger shapes),
then folds the Gumbel argmax and the running maximum in one pass and the
exp-sum in another, and reads the selected component's logit back.
In the sweep kernel at the small shapes ``csrc/common.cuh`` evaluates the
builtin kinds 1-3 with one shared logf and am_pal_gammaln per lane
(``am_density_builtin``).  The torch models
below repeat those orders in float32 with the twin's own torch.exp,
torch.log and pal_gammaln, so that only the order differs: every result
must equal the twin's bit for bit.
"""

import numpy as np
import pytest
import torch

from automix_tpu_torch.config import NEG_INF
from automix_tpu_torch.kernels.fused import _lse
from automix_tpu_torch.models import builtin
from automix_tpu_torch.ops.plmath import pal_gammaln

S = 512
L_MAX = 32


def kernel_alloc(logits, gumbel, draw, idx=None):
    """``am_alloc`` for every chain: logits [S, L], gumbel [S, L].  With
    ``draw`` idx is the Gumbel argmax (strict >, so the first maximum),
    else the given component.  Returns (idx, log-probability of idx)."""
    L = logits.shape[1]
    kept = [logits[:, li] for li in range(L)]   # the thread's column
    mx = kept[0]
    if draw:
        idx = torch.zeros(logits.shape[0], dtype=torch.int64)
        best = kept[0] + gumbel[:, 0]
        for li in range(1, L):
            v = kept[li] + gumbel[:, li]
            take = v > best
            best = torch.where(take, v, best)
            idx = torch.where(take, torch.full_like(idx, li), idx)
            mx = torch.fmax(mx, kept[li])
    else:
        for li in range(1, L):
            mx = torch.fmax(mx, kept[li])
    se = torch.exp(kept[0] - mx)
    for li in range(1, L):
        se = se + torch.exp(kept[li] - mx)
    sel = torch.stack(kept, 1).gather(1, idx[:, None])[:, 0]
    return idx, sel - (mx + torch.log(se))


def kernel_component_draw(loglam, gumbel):
    """The destination component ln: the Gumbel argmax over loglam [S, L]
    in component order with strict >."""
    bl = loglam[:, 0] + gumbel[:, 0]
    ln = torch.zeros(loglam.shape[0], dtype=torch.int64)
    for li in range(1, loglam.shape[1]):
        v = loglam[:, li] + gumbel[:, li]
        take = v > bl
        bl = torch.where(take, v, bl)
        ln = torch.where(take, torch.full_like(ln, li), ln)
    return ln


def _inputs(rng, L, case):
    """Logits and Gumbel values [S, L] of one case: random, ties (every
    value drawn from a few levels, so argmax and mx meet equal values), or
    with NEG_INF logits (whole components, and whole rows but one)."""
    width = L
    if case == "ties":
        logits = rng.choice([-3.0, -1.5, 0.25], size=(S, width))
        gumbel = rng.choice([0.0, 0.5, 1.25], size=(S, width))
    else:
        logits = rng.normal(-2.0, 3.0, size=(S, width))
        gumbel = -np.log(-np.log(rng.uniform(1e-7, 1.0, size=(S, width))))
    if case == "neg_inf":
        logits[rng.uniform(size=(S, width)) < 0.3] = NEG_INF
        logits[: S // 8, 1:] = NEG_INF
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return t(logits), t(gumbel)


@pytest.mark.parametrize("case", ["random", "ties", "neg_inf"])
def test_allocation_order_equals_twin(case):
    """The forward allocation (Gumbel argmax, then log p of the selected
    component) and the reverse one (log p of a given component) in the
    kernel's order equal the twin's torch.argmax + _lse + gather bitwise
    at every L = 1 ... 32."""
    rng = np.random.default_rng(len(case))
    for L in range(1, L_MAX + 1):
        logits, gumbel = _inputs(rng, L, case)
        lo, g = logits[:, :L], gumbel[:, :L]
        # the twin: sweep_chunk_ref's forward and reverse allocation
        want_idx = torch.argmax(lo + g, dim=1)
        lse = _lse(list(lo.unbind(1)))
        want = lo.gather(1, want_idx[:, None])[:, 0] - lse
        idx, got = kernel_alloc(lo, g, draw=True)
        assert torch.equal(idx, want_idx), (L, case)
        assert torch.equal(got, want), (L, case)
        given = torch.as_tensor(rng.integers(0, L, size=S))
        _, got_n = kernel_alloc(lo, g, draw=False, idx=given)
        want_n = lo.gather(1, given[:, None])[:, 0] - lse
        assert torch.equal(got_n, want_n), (L, case)


@pytest.mark.parametrize("case", ["random", "ties", "neg_inf"])
def test_component_draw_order_equals_twin(case):
    """The destination component's Gumbel argmax over loglam (NEG_INF where
    a weight is 0, and ties) equals the twin's torch.argmax at every L."""
    rng = np.random.default_rng(10 + len(case))
    for L in range(1, L_MAX + 1):
        loglam, gumbel = _inputs(rng, L, case)
        want = torch.argmax(loglam[:, :L] + gumbel[:, :L], dim=1)
        got = kernel_component_draw(loglam[:, :L], gumbel[:, :L])
        assert torch.equal(got, want), (L, case)


def kernel_builtin(kind, consts, t0, t1):
    """``am_density_builtin`` for every chain: per-kind arguments, one log
    and one pal_gammaln on every lane, the two Beta-only pal_gammaln, then
    each kind's combination."""
    n, s1, s2, sl, sl1 = consts
    normal = kind == builtin.KIND_NORMAL_PARAMS
    beta = kind == builtin.KIND_BETA_PARAMS
    ok = (t0 > 0.0) & (normal | (t1 > 0.0))
    one = torch.ones_like(t0)
    a = torch.where(ok, t0, one)
    b = torch.where(ok, t1, one)
    lx = torch.log(torch.where(normal, a, b))
    ga = pal_gammaln(torch.where(normal, one, a))
    gab = pal_gammaln(a + b)
    gb = pal_gammaln(b)
    x0 = t1
    ss = -(s2 - 2.0 * x0 * s1 + n * x0 * x0)
    lp_normal = -n * lx + ss / (2.0 * a * a)
    lp_beta = (a - 1.0) * sl + (b - 1.0) * sl1 + n * (gab - ga - gb)
    lp_gamma = (a - 1.0) * sl - b * s1 + n * (a * lx - ga)
    lp = torch.where(normal, lp_normal, torch.where(beta, lp_beta, lp_gamma))
    return torch.where(ok, lp, torch.full_like(lp, NEG_INF))


def test_builtin_densities_uniform_order_equals_twin():
    """The warp-uniform evaluation of kinds 1-3 equals models/builtin.py's
    cols_normal, cols_beta and cols_gamma bitwise at random points inside
    and outside each support (either coordinate <= 0, and zeros)."""
    rng = np.random.default_rng(7)
    cols, cuda = builtin.make_params_targets_cols(builtin.DATA_SAMPLES)
    consts = cuda[0].consts
    n = 4096
    pts = rng.uniform(-1.0, 6.0, size=(2, n))
    pts[:, :64] = rng.choice([0.0, -0.0, 1e-30, 1.0], size=(2, 64))
    t0, t1 = torch.as_tensor(pts, dtype=torch.float32)
    kinds = torch.as_tensor(rng.integers(1, 4, size=n))
    got = kernel_builtin(kinds, consts, t0, t1)
    for kind, f in enumerate(cols, start=1):
        m = kinds == kind
        want = f([t0[m], t1[m]])
        assert torch.equal(got[m], want), kind
        assert bool((t0[m] <= 0).any()) and bool((t0[m] > 0).any())
