"""Stage 3: reversible-jump sweeps, a whole chunk per kernel launch.

Counterpart of ``automix_tpu/kernels/fused.py``, with or without perm
and Student-t: ``_prep_tables``, the chunk runners of ``_compiled``,
``_compiled_pooled`` and ``runner``, and the sweep kernel itself, which is
``csrc/fused_sweep.cu`` on the card and :func:`sweep_chunk_ref` on the
CPU.

The words come from one of two streams, as in JAX (``fused_rng``).
``hash`` is JAX's counter hash, every word a pure function of (seed,
global sweep, chain, slot), so its runs are bitwise JAX's words and
resume at any sweep.  ``hw`` (K1f) stands for the TPU's hardware PRNG,
which no GPU has: a per-chain state seeded at each launch's first sweep
from (seed, sweep0, global chain) and stepped once per sweep into a key,
every word a cheap mix of (key, slot) (``ops/randoms.py`` ``hw_*``).  It
is chunk-granular as JAX's is: a launch reseeds, so a run resumed at a
chunk boundary and chunked the same way reproduces bitwise, and K1d
reseeds every sweep, as JAX's ``_compiled_pooled`` does.  ``auto``
resolves on the chains' device (:func:`resolve_rng`): ``hw`` on the
card, ``hash`` on the CPU, as JAX's is ``hw`` on its chip
and ``hash`` under its interpreter.  An explicit ``hw`` on the CPU runs
the twin of the port's own stream, which JAX cannot do for the TPU's.
The wrappers' own default stays ``hash``.

A model set's density is a stateless column density or an incremental
one with a per-chain cache (``model.make_density``; the DDI family's,
K1e).  The cache follows the JAX kernel: fresh at a chunk's start (logp
kept), blended with the accepted moves (columns a coordinate move did not
touch are skipped), and recomputed with logp after the RJ move of every
sweep t with t % 16 == 15.  A chunk boundary therefore refreshes the
cache but not logp, so runs chunked differently differ in the last bits.

Pooled pk (``pk_mode="pooled"``: one shared pk adapted from the
population's visit histogram, automix.c:1258-1281) takes one of two
routes while it adapts.  K1c (:func:`sweep_chunk` with ``pooled=True``)
does the update inside the kernel, a cooperative launch over every chain,
for a population the card holds resident at once
(:func:`pooled_capacity`).  A larger population takes K1d
(:func:`pooled_scan`), the JAX ``_compiled_pooled``: every sweep, every
chain with pk frozen, then the shared update from the sweep's histogram;
one cooperative launch a chunk, each thread carrying several chains and
the update behind a grid barrier.  It equals the one-sweep route
(:func:`pooled_sweeps`: one launch of the per-chain kernel per sweep and
the update in torch) bit for bit.  With the hash and a stateless density
K1c and K1d give bitwise the same chains; with a cache they do not, since
K1d rebuilds it every sweep, nor with the hw stream, which K1d reseeds
every sweep.  Burn-in and ``adapt=False`` runs keep the per-chunk kernel,
pk being frozen.

The stateless form copies the proposal tables into each block's shared
memory, so their size bounds L: at the change-point shape (6, 13) on the
H100 the wrappers refuse L > 27 before any launch (:func:`check_tables`
asks the kernel's launcher).

Chain i draws its hash words at counters (chain0 + i) * NW + slot, which
is the JAX kernel's chain_id for the flat global chain index; its hw
stream is keyed by chain0 + i too, so neither depends on the launch
geometry.  ``chain0``, the chain base, is 0 for a whole population and a
rank's first global chain when the population is split across devices
(``mesh=``, ``parallel/mesh.py``): the JAX ``_shard_index() * S_local``.
Under a mesh the runner launches the per-chain kernel on its rank's
chains and sums the chunk statistics across the ranks once a chunk (JAX
``fused.py:907-930``); an adapting pooled run takes the one-sweep route
with each sweep's histogram summed across the ranks before the shared
update, as JAX sends every meshed pooled run to ``_compiled_pooled``.
K1c and K1d need the whole population and are not run under a mesh.

The slots follow the JAX layout: D RWM accepts, the RJ accept, L + K + L
Gumbel words, then ``s_perm = 2L + K + D + 1`` (D permutation keys with perm),
``s_bm = s_perm + (D if perm else 0)`` and
``NW = s_bm + (4D if student_t_dof > 0 else 2D)``; with perm off and
Normal draws that is NW = 3D + 1 + 2L + K.  The kernel layouts are
struct-of-arrays: theta [D, S], pk [K, S]; per-chain chunk statistics come
back as [K, S], [K*D, S] and [6, S] partial sums that the runner reduces
with ``torch.sum`` outside the kernel, as JAX reduces them outside its
``pallas_call``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from automix_tpu_torch.config import EngineConfig, LOG_ACCEPT_CLAMP, NEG_INF
from automix_tpu_torch.kernels import _build
from automix_tpu_torch.model import make_density
from automix_tpu_torch.ops import linalg, randoms
from automix_tpu_torch.parallel import mesh as mesh_lib
from automix_tpu_torch.state import Chains, Proposal

_LOG_2PI = 1.8378770664093453
_MAX_L = 32          # csrc/fused_sweep.cu kLMax
# Sweeps between full refreshes of an incremental density's cache and
# logp (the JAX _REFRESH): keyed on the global sweep, t % 16 == 15.
_REFRESH = 16
# The sweep kernel's word streams, by their launcher code (csrc/common.cuh
# AM_RNG_HASH, AM_RNG_HW).
RNG_STREAMS = {"hash": 0, "hw": 1}


def resolve_rng(fused_rng: str, device) -> str:
    """``EngineConfig.fused_rng`` on ``device``: "auto" is "hw" on the card
    and "hash" on the CPU (JAX's rule: "hw" on a TPU, "hash" under the
    interpreter); "hw" and "hash" are kept."""
    if fused_rng == "auto":
        return "hw" if torch.device(device).type == "cuda" else "hash"
    if fused_rng not in RNG_STREAMS:
        raise ValueError(f"unknown fused_rng {fused_rng!r}")
    return fused_rng


@dataclasses.dataclass
class SweepTables:
    """Per-chunk proposal tables: sig [K, D]; loglam, abase, logdet [K, L];
    mu [K*L, D]; binv and B [K*L, D*D] (binv the inverse factor)."""

    sig: torch.Tensor
    loglam: torch.Tensor
    abase: torch.Tensor
    logdet: torch.Tensor
    mu: torch.Tensor
    binv: torch.Tensor
    B: torch.Tensor

    def packed(self) -> torch.Tensor:
        """One contiguous float32 buffer in the kernel's table order."""
        return torch.cat([getattr(self, f.name).reshape(-1)
                          for f in dataclasses.fields(self)])


def prep_tables(prop: Proposal, dims) -> SweepTables:
    """Inverse factor, log-weights and the allocation-logit base of a
    proposal (``_prep_tables``)."""
    K, L, D = prop.mu.shape
    f32 = torch.float32
    B = torch.tril(prop.B.to(f32))
    binv = linalg.tri_inverse(B)
    lam = prop.lam.to(f32)
    loglam = torch.where(lam > 0, torch.log(torch.clamp(lam, min=1e-38)),
                         torch.full_like(lam, NEG_INF))
    logdet = prop.logdetB.to(f32)
    dims_f = torch.as_tensor(dims, dtype=f32, device=lam.device)
    abase = loglam - logdet - 0.5 * dims_f[:, None] * _LOG_2PI
    return SweepTables(sig=prop.sig.to(f32).contiguous(), loglam=loglam,
                       abase=abase, logdet=logdet,
                       mu=prop.mu.to(f32).reshape(K * L, D).contiguous(),
                       binv=binv.reshape(K * L, D * D).contiguous(),
                       B=B.reshape(K * L, D * D).contiguous())


def _accept(delta):
    return torch.exp(torch.clamp(delta, LOG_ACCEPT_CLAMP, 0.0))


def _lse(cols):
    """log-sum-exp over a list of [S] tensors in the kernel's order."""
    m = cols[0]
    for v in cols[1:]:
        m = torch.maximum(m, v)
    s = torch.exp(cols[0] - m)
    for v in cols[1:]:
        s = s + torch.exp(v - m)
    return m + torch.log(s)


def _standardize(x, mu, binv, dim, D: int):
    """Residuals w_r = sum_{c<=r} binv[r, c] (x_c - mu_c) of every
    component: ``x`` D tensors [S], ``mu`` [S, L, D], ``binv``
    [S, L, D, D], ``dim`` [S].  Returns (w list of [S, L], quad [S, L])
    with quad summed over the first ``dim`` rows in row order."""
    w, quad = [], None
    for r in range(D):
        acc = binv[..., r, 0] * (x[0][:, None] - mu[..., 0])
        for c in range(1, r + 1):
            acc = acc + binv[..., r, c] * (x[c][:, None] - mu[..., c])
        w.append(acc)
        sq = acc * acc
        quad = sq if quad is None else torch.where(
            (dim > r)[:, None], quad + sq, quad)
    return w, quad


def word_slots(K: int, D: int, L: int, perm: bool, tdist: bool):
    """(s_uacc, s_gall, s_gmod, s_gcmp, s_perm, s_bm, NW): the per-sweep
    word slots of the JAX kernel (``_built``, fused.py 394-406)."""
    s_uacc, s_gall = D, D + 1
    s_gmod = s_gall + L
    s_gcmp = s_gmod + K
    s_perm = s_gcmp + L
    s_bm = s_perm + (D if perm else 0)
    NW = s_bm + (4 * D if tdist else 2 * D)
    return s_uacc, s_gall, s_gmod, s_gcmp, s_perm, s_bm, NW


def _blend(cache, cache_n, acc):
    """The accept-blend c + acc * (cn - c) of every cache column the move
    touched; a column that came back as the same object is kept."""
    idx = [i for i, (c, cn) in enumerate(zip(cache, cache_n)) if cn is not c]
    if not idx:
        return cache
    c = torch.stack([cache[i] for i in idx])
    cn = torch.stack([cache_n[i] for i in idx])
    blended = (c + acc[None, :] * (cn - c)).unbind(0)
    out = list(cache)
    for r, i in enumerate(idx):
        out[i] = blended[r]
    return tuple(out)


def _gains(sweep0: int, n_sweeps: int, device) -> torch.Tensor:
    """float32 [n_sweeps] pk gains gamma_t = exp(-2/3 log(t + 1)) of
    sweeps sweep0 ..., in float32 as the JAX kernel and the CUDA kernel
    (``am_gain``) compute them.  The pooled twin and the one-sweep route
    both take a chunk's gains from here, so they agree on every device."""
    t = torch.arange(sweep0, sweep0 + n_sweeps, device=device)
    return torch.exp((-2.0 / 3.0) * torch.log(t.to(torch.float32) + 1.0))


def sweep_chunk_ref(modelset, k, theta, logp, pk, pkllim, nreinit,
                    tables: SweepTables, *, seed: int, sweep0: int,
                    n_sweeps: int, adapt: bool, perm: bool = False,
                    tdist=None, pooled: bool = False, rng: str = "hash",
                    chain0: int = 0):
    """Plain PyTorch twin of the sweep kernel: ``n_sweeps`` sweeps (global
    sweeps sweep0 ...) of every chain.  ``theta`` is [D, S] and ``pk``
    [K, S]; ``perm`` permutes the RJ latent and ``tdist`` (a
    ``randoms.StudentT``) selects Student-t perturbations.  ``rng`` is the
    word stream, "hash" or "hw" (seeded here from (seed, sweep0, chain)
    and stepped once per sweep).  ``chain0`` is the chain base: chain i
    draws global chain chain0 + i's words.  ``pooled``
    (K1c's twin) adapts pk from the population's visit histogram; every
    row of pk, pkllim and nreinit then stays equal.  Returns (k, theta,
    logp, pk, pkllim, nreinit, ksum [K, S], tsum [K*D, S], tqsum
    [K*D, S], cnt [6, S])."""
    K, D = modelset.nmodels, modelset.dmax
    S = k.shape[0]
    L = tables.loglam.shape[1]
    dev = k.device
    f32 = torch.float32
    density = make_density(modelset)
    s_uacc, s_gall, s_gmod, s_gcmp, s_perm, s_bm, NW = word_slots(
        K, D, L, perm, tdist is not None)
    chain = torch.arange(chain0, chain0 + S, device=dev)
    if rng == "hw":
        stream = randoms.hw_state(seed, sweep0, chain)
    elif rng != "hash":
        raise ValueError(f"sweep_chunk: unknown rng {rng!r}")
    dims = torch.as_tensor(modelset.dims, device=dev).long()
    mu3 = tables.mu.reshape(K, L, D)
    binv4 = tables.binv.reshape(K, L, D, D)
    B4 = tables.B.reshape(K, L, D, D)
    inv_k = torch.tensor(1.0 / K, dtype=f32, device=dev)
    inv_s = torch.tensor(1.0 / S, dtype=f32, device=dev)
    gains = _gains(sweep0, n_sweeps, dev) if pooled else None

    kk = k.long()
    th = [theta[d].clone() for d in range(D)]
    lp = logp.clone()
    pkv = [pk[m].clone() for m in range(K)]
    pkl = pkllim.clone()
    nri = nreinit.clone()
    ks = torch.zeros((K, S), dtype=torch.int32, device=dev)
    ts = torch.zeros((K * D, S), dtype=f32, device=dev)
    tq = torch.zeros((K * D, S), dtype=f32, device=dev)
    cnt = torch.zeros((6, S), dtype=torch.int32, device=dev)
    # an incremental density's cache, fresh at the chunk's start state
    # (logp is kept: a chunk boundary refreshes the cache only)
    cache = density.full(kk, th)[1] if density.n_cache else ()

    for tr in range(n_sweeps):
        t = sweep0 + tr
        if rng == "hw":
            stream, key = randoms.hw_step(stream)
            words = randoms.hw_words(key, range(NW))
        else:
            words = randoms.sweep_words(seed, t, chain, range(NW))
        u = randoms.u01(words)                                  # [NW, S]
        if tdist is not None:
            z_rwm = randoms.bailey_t(u[s_bm:s_bm + D],
                                     u[s_bm + D:s_bm + 2 * D], tdist)
            z_lat = randoms.bailey_t(u[s_bm + 2 * D:s_bm + 3 * D],
                                     u[s_bm + 3 * D:s_bm + 4 * D], tdist)
        else:
            z_rwm, z_lat = randoms.box_muller(u[s_bm:s_bm + D],
                                              u[s_bm + D:s_bm + 2 * D])
        dk = dims[kk]
        active = [dk > d for d in range(D)]
        sig_k = tables.sig[kk]                                  # [S, D]

        # (a) within-model move
        if t % 10 == 0:
            prop = [torch.where(active[d], th[d] + sig_k[:, d] * z_rwm[d],
                                th[d]) for d in range(D)]
            lpn, cache_n = density.full(kk, prop)
            acc = (u[0] < _accept(lpn - lp)).to(f32)
            th = [th[d] + acc * (prop[d] - th[d]) for d in range(D)]
            lp = lp + acc * (lpn - lp)
            cache = _blend(cache, cache_n, acc)
            cnt[0] += acc.to(torch.int32)
            cnt[1] += 1
        else:
            for j in range(D):
                prop = list(th)
                prop[j] = th[j] + sig_k[:, j] * z_rwm[j]
                lpn, cache_n = density.coord(j, kk, prop, th[j], cache)
                acc = ((u[j] < _accept(lpn - lp)) & active[j]).to(f32)
                th[j] = th[j] + acc * (prop[j] - th[j])
                lp = lp + acc * (lpn - lp)
                cache = _blend(cache, cache_n, acc)
                cnt[2] += acc.to(torch.int32)
                cnt[3] += active[j].to(torch.int32)

        # (b) reversible jump: forward allocation in the chain's model
        w, quad = _standardize(th, mu3[kk], binv4[kk], dk, D)
        logits = tables.abase[kk] - 0.5 * quad                  # [S, L]
        g_all = randoms.gumbel(u[s_gall:s_gall + L]).T
        l_idx = torch.argmax(logits + g_all, dim=1)   # first max: strict >
        cols = list(logits.unbind(1))
        sel = l_idx[:, None]
        log_palloc = logits.gather(1, sel)[:, 0] - _lse(cols)
        work = [torch.where(active[d], w[d].gather(1, sel)[:, 0],
                            torch.zeros_like(th[d])) for d in range(D)]

        # destination model kn ~ pk, component ln ~ lam[kn]
        if K > 1:
            logpk = torch.log(torch.clamp(torch.stack(pkv), min=1e-38))
            g_mod = randoms.gumbel(u[s_gmod:s_gmod + K])
            kn = torch.argmax(logpk + g_mod, dim=0)
            logratio = (logpk.gather(0, kk[None])[0]
                        - logpk.gather(0, kn[None])[0])
        else:
            kn = kk
            logratio = torch.zeros_like(lp)
        dkn = dims[kn]
        active_n = [dkn > d for d in range(D)]
        g_cmp = randoms.gumbel(u[s_gcmp:s_gcmp + L]).T
        ln = torch.argmax(tables.loglam[kn] + g_cmp, dim=1)

        # latent dimension matching: latent fill on coords k lacks; the
        # grow density reads the latent before the permutation, the shrink
        # density after it
        wf = [torch.where(active[d], work[d], z_lat[d]) for d in range(D)]
        for d in range(D):
            up = ~active[d] & active_n[d]
            lat = randoms.latent_lpdf(wf[d], tdist)
            logratio = torch.where(up, logratio - lat, logratio)
        if perm:
            # stable bubble network over per-slot keys: uniform on the
            # first max(dk, dkn) slots, 1 + d beyond
            keys = [torch.where(active[d] | active_n[d], u[s_perm + d],
                                torch.full_like(u[s_perm + d], 1.0 + d))
                    for d in range(D)]
            for _ in range(D):
                for j in range(D - 1):
                    swap = keys[j] > keys[j + 1]
                    keys[j], keys[j + 1] = (
                        torch.where(swap, keys[j + 1], keys[j]),
                        torch.where(swap, keys[j], keys[j + 1]))
                    wf[j], wf[j + 1] = (torch.where(swap, wf[j + 1], wf[j]),
                                        torch.where(swap, wf[j], wf[j + 1]))
        for d in range(D):
            down = active[d] & ~active_n[d]
            lat = randoms.latent_lpdf(wf[d], tdist)
            logratio = torch.where(down, logratio + lat, logratio)

        # de-standardize into the destination model
        mu_n = mu3[kn, ln]                                      # [S, D]
        B_n = B4[kn, ln]                                        # [S, D, D]
        thn = []
        for r in range(D):
            a = mu_n[:, r]
            for c in range(r + 1):
                a = a + B_n[:, r, c] * wf[c]
            thn.append(torch.where(active_n[r], a, torch.zeros_like(a)))

        # reverse allocation in the destination model
        _, quad_n = _standardize(thn, mu3[kn], binv4[kn], dkn, D)
        logits_n = tables.abase[kn] - 0.5 * quad_n
        log_pallocn = (logits_n.gather(1, ln[:, None])[:, 0]
                       - _lse(list(logits_n.unbind(1))))

        # accept
        lpn, cache_rj = density.full(kn, thn)
        ll_kl = tables.loglam[kk, l_idx]
        ll_kln = tables.loglam[kn, ln]
        ld_kl = tables.logdet[kk, l_idx]
        ld_kln = tables.logdet[kn, ln]
        logratio = (logratio + (lpn - lp) + (log_pallocn - log_palloc)
                    + (ll_kl - ll_kln) + (ld_kln - ld_kl))
        accf = (u[s_uacc] < _accept(logratio)).to(f32)
        acci = accf.to(torch.int64)
        kk = kk + acci * (kn - kk)
        th = [th[d] + accf * (thn[d] - th[d]) for d in range(D)]
        lp = lp + accf * (lpn - lp)
        cache = _blend(cache, cache_rj, accf)
        if density.n_cache and t % _REFRESH == _REFRESH - 1:
            # periodic refresh of the cache and logp from the state, which
            # bounds the float32 drift of the incremental updates
            lp, cache = density.full(kk, th)

        # (c) pk diminishing adaptation with the re-init safeguard
        if adapt and K > 1:
            if pooled:
                gamma = gains[tr]
                oh = [(kk == m).sum().to(f32) * inv_s for m in range(K)]
            else:
                tf = torch.tensor(float(t), dtype=f32, device=dev)
                gamma = torch.exp((-2.0 / 3.0) * torch.log(tf + 1.0))
                oh = [(kk == m).to(f32) for m in range(K)]
            newpk = [pkv[m] + gamma * (oh[m] - pkv[m]) for m in range(K)]
            reinit = newpk[0] < pkl
            for m in range(1, K):
                reinit = reinit | (newpk[m] < pkl)
            nri = nri + reinit.to(nri.dtype)
            pkl = torch.where(reinit, 1.0 / (10.0 * nri.to(f32)), pkl)
            rf = reinit.to(f32)
            pkv = [newpk[m] + rf * (inv_k - newpk[m]) for m in range(K)]

        # chunk statistics
        for m in range(K):
            mk = kk == m
            mf = mk.to(f32)
            ks[m] += mk.to(torch.int32)
            for d in range(D):
                ts[m * D + d] += mf * th[d]
                tq[m * D + d] += mf * th[d] * th[d]
        cnt[4] += acci.to(torch.int32)
        cnt[5] += 1

    return (kk.to(torch.int32), torch.stack(th), lp, torch.stack(pkv), pkl,
            nri, ks, ts, tq, cnt)


def check_form(modelset):
    """Raise unless the sweep kernel's form at the model set's (K, D)
    evaluates its density: at :data:`_build.CACHED_SHAPE` the kernel has
    only its cached form, the DDI family's incremental density (K1e), and
    at every other shape only the stateless form."""
    density = make_density(modelset)
    if density.n_cache and getattr(density, "cuda_cache", None) != "ddi":
        raise ValueError("sweep_chunk: the CUDA kernels implement no "
                         f"incremental density of kind {density!r}")
    K, D = modelset.nmodels, modelset.dmax
    cached = (K, D) == _build.CACHED_SHAPE
    if bool(density.n_cache) != cached:
        raise ValueError(
            f"sweep_chunk: the sweep kernel at K={K}, D={D} has only its "
            f"{'cached (DDI)' if cached else 'stateless'} form")


@functools.lru_cache(maxsize=None)
def _max_l(K: int, D: int, perm: bool, tdist: bool, pooled: bool,
           device: int) -> int:
    """The largest L the sweep kernel's launcher takes at (K, D) on the
    card ``device``, as the kernel counts its shared memory."""
    L = ctypes.c_int()
    symbol = _build.sweep_symbol(perm, tdist, "max_l")
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), symbol)(
            K, D, int(pooled), ctypes.byref(L)), symbol)
    return L.value


def check_tables(K: int, D: int, L: int, device, perm: bool = False,
                 tdist: bool = False, pooled: bool = False):
    """Raise, before any launch on the card ``device``, unless the sweep
    kernel holds the proposal tables of L components at (K, D): within
    kLMax and, in the stateless form, within one block's shared memory
    (at the change-point shape (6, 13) on the H100, L <= 27)."""
    if not 1 <= L <= _MAX_L:
        raise ValueError(f"sweep_chunk: L={L} outside 1..{_MAX_L}")
    index = torch.device(device).index
    fit = _max_l(K, D, perm, tdist, pooled, torch.cuda.current_device()
                 if index is None else index)
    if L > fit:
        raise ValueError(
            f"sweep_chunk: the proposal tables of L={L} components at "
            f"K={K}, D={D} do not fit one block's shared memory; the sweep "
            f"kernel holds at most L={fit} here (EngineConfig.max_mix_comps)")


def eligible(modelset, cfg: EngineConfig, L: int, device, mesh=None):
    """(True, why) when the stage-3 kernels serve the model set at
    proposal size L on ``device``, else (False, why not); the counterpart
    of JAX's ``fused_eligible``.  The kernels serve it when ``fused`` is
    not "off", the within-model move is RWM (HMC runs on the general
    engine, as on JAX's XLA engine), every model has a CUDA density, the kernels are
    instantiated at its (K, D) in the density's form (:func:`check_form`)
    and L is within what the sweep kernel's launcher holds there (on the
    CPU, where the twins run, within kLMax); under a ``mesh`` the ranks
    must split ``cfg.n_chains`` evenly.  ``fused="on"`` raises where they
    do not serve it."""
    K, D = modelset.nmodels, modelset.dmax
    missing = [m.name for m in modelset.models if m.cuda is None]
    ok = False
    if cfg.fused == "off":
        why = "fused='off'"
    elif cfg.within_move != "rwm":
        why = f"within_move={cfg.within_move!r} (the kernels move by RWM)"
    elif missing:
        why = f"models {missing} have no CUDA density"
    elif (K, D) not in _build.SHAPES:
        why = f"no kernel instantiation at (K, D) = ({K}, {D})"
    elif mesh is not None and cfg.n_chains % mesh.size:
        why = (f"n_chains={cfg.n_chains} does not split evenly over the "
               f"{mesh.size} ranks of the mesh")
    else:
        try:
            check_form(modelset)
            dev = torch.device(device)
            if dev.type == "cuda":
                tdist = cfg.student_t_dof > 0
                for pooled in {False, cfg.pk_mode == "pooled" and K > 1}:
                    check_tables(K, D, L, dev, cfg.perm, tdist, pooled)
            elif not 1 <= L <= _MAX_L:
                raise ValueError(f"L={L} outside 1..{_MAX_L}")
            ok, why = True, (f"every model has a CUDA density at (K, D) = "
                             f"({K}, {D}), L = {L}")
        except ValueError as err:
            why = str(err)
    if cfg.fused == "on" and not ok:
        raise ValueError(f"fused='on', but the stage-3 kernels cannot serve "
                         f"this model set: {why}")
    return ok, why


def pooled_capacity(modelset, L: int, device, perm: bool = False,
                    tdist=None) -> int:
    """Chains the pooled kernel (K1c) can hold resident on the card at
    once at this proposal size L: the CUDA occupancy of the kernel's
    block times the SM count times its threads.  The routing bound of
    pooled runs."""
    K, D = modelset.nmodels, modelset.dmax
    _build.check_shape(K, D, "pooled_capacity")
    check_form(modelset)
    check_tables(K, D, L, device, perm, tdist is not None, pooled=True)
    chains = ctypes.c_int()
    symbol = _build.sweep_symbol(perm, tdist is not None, "pooled_cap")
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), symbol)(
            K, D, L, ctypes.byref(chains)), symbol)
    return chains.value


def occupancy(modelset, L: int, device, perm: bool = False,
              tdist=None) -> int:
    """Warps of the per-chain sweep kernel resident per SM on the card at
    this proposal size L, from the CUDA occupancy of its block (registers
    and shared memory)."""
    K, D = modelset.nmodels, modelset.dmax
    _build.check_shape(K, D, "occupancy")
    check_form(modelset)
    check_tables(K, D, L, device, perm, tdist is not None)
    warps = ctypes.c_int()
    symbol = _build.sweep_symbol(perm, tdist is not None, "occupancy")
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), symbol)(
            K, D, L, ctypes.byref(warps)), symbol)
    return warps.value


def sweep_chunk(modelset, k, theta, logp, pk, pkllim, nreinit,
                tables: SweepTables, *, seed: int, sweep0: int,
                n_sweeps: int, adapt: bool, perm: bool = False,
                tdist=None, pooled: bool = False, rng: str = "hash",
                chain0: int = 0):
    """``n_sweeps`` stage-3 sweeps of every chain: the CUDA kernel for
    tensors on the card, its plain twin for tensors on the CPU.  Same
    arguments and results as :func:`sweep_chunk_ref`; ``chain0``, the
    chain base, is the kernel's run-time argument.  ``pooled`` launches
    K1c, whose launcher refuses a population above :func:`pooled_capacity`
    (then this raises).  Launches count by stream: the per-chain kernel in
    ``sweep_chunk.launches`` (hash) and ``sweep_chunk.hw_launches`` (K1f),
    the pooled one in ``sweep_chunk.pooled_launches`` and
    ``sweep_chunk.pooled_hw_launches``.  A model set with an incremental
    density (DDI) launches the cached form K1e; a kernel that cannot build
    or launch raises, and nothing falls back to the twin."""
    if pooled and not (adapt and modelset.nmodels > 1):
        raise ValueError("sweep_chunk: pooled pk needs adapt and K > 1")
    if pooled and chain0:
        raise ValueError("sweep_chunk: pooled pk needs the whole population "
                         "(chain0 = 0)")
    if rng not in RNG_STREAMS:
        raise ValueError(f"sweep_chunk: unknown rng {rng!r}")
    if chain0 < 0:
        raise ValueError(f"sweep_chunk: chain0={chain0} < 0")
    if k.device.type == "cpu":
        return sweep_chunk_ref(modelset, k, theta, logp, pk, pkllim, nreinit,
                               tables, seed=seed, sweep0=sweep0,
                               n_sweeps=n_sweeps, adapt=adapt, perm=perm,
                               tdist=tdist, pooled=pooled, rng=rng,
                               chain0=chain0)
    K, D = modelset.nmodels, modelset.dmax
    S = k.shape[0]
    L = tables.loglam.shape[1]
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_chunk: unsupported device {dev}")
    _build.check_shape(K, D, "sweep_chunk")
    check_tables(K, D, L, dev, perm, tdist is not None, pooled)
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("k", k, i32, (S,)), ("theta", theta, f32, (D, S)),
            ("logp", logp, f32, (S,)), ("pk", pk, f32, (K, S)),
            ("pkllim", pkllim, f32, (S,)), ("nreinit", nreinit, i32, (S,))):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"sweep_chunk: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    tab = tables.packed()
    if tab.device != dev or tab.dtype != f32:
        raise ValueError(f"sweep_chunk: tables must be float32 on {dev}")
    kinds, consts, dims = modelset.density_table(dev)
    check_form(modelset)
    outs = (torch.empty_like(k), torch.empty_like(theta),
            torch.empty_like(logp), torch.empty_like(pk),
            torch.empty_like(pkllim), torch.empty_like(nreinit),
            torch.empty((K, S), dtype=i32, device=dev),
            torch.empty((K * D, S), dtype=f32, device=dev),
            torch.empty((K * D, S), dtype=f32, device=dev),
            torch.empty((6, S), dtype=i32, device=dev))
    state = (tab.data_ptr(), kinds.data_ptr(), consts.data_ptr(),
             dims.data_ptr(), k.data_ptr(), theta.data_ptr(),
             logp.data_ptr(), pk.data_ptr(), pkllim.data_ptr(),
             nreinit.data_ptr(), *[o.data_ptr() for o in outs],
             torch.cuda.current_stream(dev).cuda_stream)
    if pooled:
        ghist = torch.zeros(3 * K, dtype=i32, device=dev)
        symbol = _build.sweep_symbol(perm, tdist is not None, "pooled")
        status = getattr(_build.library(), symbol)(
            K, D, S, L, seed & 0xFFFFFFFF, sweep0, n_sweeps,
            RNG_STREAMS[rng], _build.tconsts(tdist), ghist.data_ptr(),
            float(torch.tensor(1.0 / S, dtype=f32)), *state)
        _build.check(status, symbol)
        if rng == "hw":
            sweep_chunk.pooled_hw_launches += 1
        else:
            sweep_chunk.pooled_launches += 1
        return outs
    symbol = _build.sweep_symbol(perm, tdist is not None)
    status = getattr(_build.library(), symbol)(
        K, D, S, L, seed & 0xFFFFFFFF, sweep0, n_sweeps, int(adapt),
        RNG_STREAMS[rng], int(chain0), _build.tconsts(tdist), *state)
    _build.check(status, symbol)
    if rng == "hw":
        sweep_chunk.hw_launches += 1
    else:
        sweep_chunk.launches += 1
    return outs


sweep_chunk.launches = 0
sweep_chunk.pooled_launches = 0
sweep_chunk.hw_launches = 0
sweep_chunk.pooled_hw_launches = 0
sweep_chunk.scan_launches = 0      # K1d, pooled_scan
sweep_chunk.scan_hw_launches = 0


def pooled_update(pk_vec, pkl, nri, hist, gamma, inv_s, inv_k):
    """The shared pk update of one sweep from its visit histogram (the
    JAX ``_compiled_pooled`` step, fused.py:1028-1043): ``pk_vec`` [K],
    ``pkl`` and ``nri`` 0-dim, ``hist`` [K] integer counts, ``gamma`` the
    sweep's gain, ``inv_s`` and ``inv_k`` float32 1/S and 1/K.  The
    re-init is a device-side blend, not a host branch, and an arithmetic
    one as in the kernel.  Returns (pk_vec, pkl, nri)."""
    f32 = torch.float32
    oh = hist.to(f32) * inv_s
    newpk = pk_vec + gamma * (oh - pk_vec)
    reinit = (newpk < pkl).any()
    nri = nri + reinit.to(nri.dtype)
    pkl = torch.where(reinit, 1.0 / (10.0 * nri.to(f32)), pkl)
    rf = reinit.to(f32)
    return newpk + rf * (inv_k - newpk), pkl, nri


def pooled_sweeps(modelset, chains: Chains, tables: SweepTables, n_sweeps,
                  *, seed: int, perm: bool = False, tdist=None,
                  sweep_fn=None, rng: str = "hash", mesh=None):
    """The one-sweep pooled route (the JAX ``_compiled_pooled`` as a host
    loop): each sweep one launch of the per-chain kernel with pk frozen
    (``sweep_fn``, :func:`sweep_chunk` by default), then
    :func:`pooled_update` of the shared pk from the sweep's integer
    histogram, all on the chains' device with no host sync.  Returns
    (chains', chunk) as the chunk runner does; the float sums are summed
    sweep by sweep, so they may differ from K1c's in the last bits.  Its
    launches count in ``sweep_chunk.launches`` (or ``hw_launches`` with
    ``rng="hw"``, whose one-sweep launches reseed the stream every sweep).
    The runner takes K1d (:func:`pooled_scan`) instead; this route is what
    K1d is held to on the card, and with ``sweep_fn=sweep_chunk_ref`` it
    is K1d's plain version on any device.  Under a ``mesh`` (the route of
    every adapting pooled run across devices) ``chains`` are this rank's,
    each launch takes the rank's chain base, each sweep's histogram is
    summed across the ranks before the update (the JAX psum, fused.py:
    1034-1036) and the float sums and counters once at the end."""
    sweep_fn = sweep_fn or sweep_chunk
    K, D = modelset.nmodels, modelset.dmax
    S_local = chains.n_chains
    S = S_local * (1 if mesh is None else mesh.size)
    c0 = mesh_lib.chain0(mesh, S_local)
    dev = chains.k.device
    f32, i64 = torch.float32, torch.int64
    inv_s = torch.tensor(1.0 / S, dtype=f32, device=dev)
    inv_k = torch.tensor(1.0 / K, dtype=f32, device=dev)
    gains = _gains(chains.sweep, n_sweeps, dev)
    pk_vec = chains.pk[0].clone()
    pkl, nri = chains.pkllim[0].clone(), chains.nreinit[0].clone()
    pk_in = pk_vec[:, None].expand(K, S_local).contiguous()
    k, th, lp = chains.k, chains.theta.T.contiguous(), chains.logp
    ks_a = torch.zeros(K, dtype=i64, device=dev)
    ts_a = torch.zeros(K * D, dtype=f32, device=dev)
    tq_a = torch.zeros(K * D, dtype=f32, device=dev)
    cnt_a = torch.zeros(6, dtype=i64, device=dev)
    for tr in range(n_sweeps):
        outs = sweep_fn(modelset, k, th, lp, pk_in, chains.pkllim,
                        chains.nreinit, tables, seed=seed,
                        sweep0=chains.sweep + tr, n_sweeps=1, adapt=False,
                        perm=perm, tdist=tdist, rng=rng, chain0=c0)
        k, th, lp = outs[0], outs[1], outs[2]
        hist = mesh_lib.all_reduce_sum(outs[6].sum(dim=1, dtype=i64), mesh)
        ks_a += hist
        ts_a += outs[7].sum(dim=1)
        tq_a += outs[8].sum(dim=1)
        cnt_a += outs[9].sum(dim=1, dtype=i64)
        pk_vec, pkl, nri = pooled_update(pk_vec, pkl, nri, hist, gains[tr],
                                         inv_s, inv_k)
        pk_in.copy_(pk_vec[:, None].expand(K, S_local))
    chains_out = Chains(k=k, theta=th.T.contiguous(), logp=lp,
                        pk=pk_vec[None, :].expand(S_local, K).contiguous(),
                        pkllim=pkl.expand(S_local).contiguous(),
                        nreinit=nri.expand(S_local).contiguous(),
                        sweep=chains.sweep + n_sweeps, key=chains.key)
    ts_a, tq_a, cnt_a = (mesh_lib.all_reduce_sum(x, mesh)
                         for x in (ts_a, tq_a, cnt_a))
    return chains_out, _chunk(ks_a, ts_a, tq_a, cnt_a, K, D)


@functools.lru_cache(maxsize=None)
def _scan_grid(K: int, D: int, S: int, L: int, perm: bool, tdist: bool,
               device: int) -> int:
    """K1d's grid for S chains at (K, D, L) on the card ``device``, in
    threads (the launcher's own choice)."""
    G = ctypes.c_int()
    symbol = _build.sweep_symbol(perm, tdist, "scan_grid")
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), symbol)(
            K, D, S, L, ctypes.byref(G)), symbol)
    return G.value


def pooled_scan(modelset, chains: Chains, tables: SweepTables, n_sweeps,
                *, seed: int, perm: bool = False, tdist=None,
                rng: str = "hash"):
    """K1d, the pooled route above K1c's bound: ``n_sweeps`` sweeps of the
    JAX ``_compiled_pooled`` (each sweep every chain with the shared pk
    frozen, then :func:`pooled_update` from the sweep's histogram) in one
    cooperative launch of ``csrc/fused_sweep.cu``'s K1d on chains on the
    card, each thread carrying several chains through every sweep; on the
    CPU its plain version, :func:`pooled_sweeps` over
    :func:`sweep_chunk_ref`.  Bit for bit the one-sweep route
    ``pooled_sweeps(..., sweep_fn=sweep_chunk)`` in every chain field and
    counter (its float sums in another order).  Returns (chains', chunk).
    Launches count in ``sweep_chunk.scan_launches`` (hash) and
    ``sweep_chunk.scan_hw_launches``; a kernel that cannot build or launch
    raises, and nothing falls back."""
    if modelset.nmodels < 2:
        raise ValueError("pooled_scan: pooled pk needs K > 1")
    if rng not in RNG_STREAMS:
        raise ValueError(f"pooled_scan: unknown rng {rng!r}")
    dev = chains.k.device
    if dev.type == "cpu":
        return pooled_sweeps(modelset, chains, tables, n_sweeps, seed=seed,
                             perm=perm, tdist=tdist,
                             sweep_fn=sweep_chunk_ref, rng=rng)
    if dev.type != "cuda":
        raise ValueError(f"pooled_scan: unsupported device {dev}")
    K, D = modelset.nmodels, modelset.dmax
    S = chains.n_chains
    L = tables.loglam.shape[1]
    _build.check_shape(K, D, "pooled_scan")
    check_form(modelset)
    check_tables(K, D, L, dev, perm, tdist is not None, pooled=True)
    f32, i32 = torch.float32, torch.int32
    tab = tables.packed()
    if tab.device != dev or tab.dtype != f32:
        raise ValueError(f"pooled_scan: tables must be float32 on {dev}")
    for name, x, dtype, shape in (
            ("k", chains.k, i32, (S,)), ("theta", chains.theta, f32, (S, D)),
            ("logp", chains.logp, f32, (S,)), ("pk", chains.pk, f32, (S, K)),
            ("pkllim", chains.pkllim, f32, (S,)),
            ("nreinit", chains.nreinit, i32, (S,))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"pooled_scan: {name} must be a {dtype} "
                             f"{shape} tensor on {dev}")
    kinds, consts, dims = modelset.density_table(dev)
    G = _scan_grid(K, D, S, L, perm, tdist is not None,
                   torch.cuda.current_device() if dev.index is None
                   else dev.index)
    # the state, updated in place; the shared pk, pkllim and nreinit
    fresh = functools.partial(torch.clone,
                              memory_format=torch.contiguous_format)
    k, th, lp = fresh(chains.k), fresh(chains.theta.T), fresh(chains.logp)
    shared = (chains.pk[0].contiguous(), chains.pkllim[:1].contiguous(),
              chains.nreinit[:1].contiguous())
    outs = (torch.empty(K, dtype=f32, device=dev),
            torch.empty(1, dtype=f32, device=dev),
            torch.empty(1, dtype=i32, device=dev),
            torch.empty((K, G), dtype=i32, device=dev),
            torch.empty((K * D, G), dtype=f32, device=dev),
            torch.empty((K * D, G), dtype=f32, device=dev),
            torch.empty((6, G), dtype=i32, device=dev))
    ghist = torch.zeros(3 * K, dtype=i32, device=dev)
    symbol = _build.sweep_symbol(perm, tdist is not None, "scan")
    status = getattr(_build.library(), symbol)(
        K, D, S, L, seed & 0xFFFFFFFF, chains.sweep, n_sweeps,
        RNG_STREAMS[rng], _build.tconsts(tdist), G, ghist.data_ptr(),
        float(torch.tensor(1.0 / S, dtype=f32)), tab.data_ptr(),
        kinds.data_ptr(), consts.data_ptr(), dims.data_ptr(),
        k.data_ptr(), th.data_ptr(), lp.data_ptr(),
        *[x.data_ptr() for x in shared], *[o.data_ptr() for o in outs],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, symbol)
    if rng == "hw":
        sweep_chunk.scan_hw_launches += 1
    else:
        sweep_chunk.scan_launches += 1
    pk, pkl, nri, ks, ts, tq, cnt = outs
    chains_out = Chains(k=k, theta=th.T.contiguous(), logp=lp,
                        pk=pk[None, :].expand(S, K).contiguous(),
                        pkllim=pkl.expand(S).contiguous(),
                        nreinit=nri.expand(S).contiguous(),
                        sweep=chains.sweep + n_sweeps, key=chains.key)
    return chains_out, _chunk(
        ks.sum(dim=1, dtype=torch.int64), ts.sum(dim=1), tq.sum(dim=1),
        cnt.sum(dim=1, dtype=torch.int64), K, D)


def _chunk(ks, ts, tq, cnt, K: int, D: int) -> dict:
    """The chunk statistics from the summed visit counts [K], theta sums
    [K*D] and counters [6]."""
    return {
        "ksummary": ks,
        "theta_sum": ts.reshape(K, D),
        "theta_sqsum": tq.reshape(K, D),
        "naccrwmb": cnt[0], "ntryrwmb": cnt[1],
        "naccrwms": cnt[2], "ntryrwms": cnt[3],
        "nacctd": cnt[4], "ntrytd": cnt[5],
    }


def build_fused_chunk_runner(modelset, cfg: EngineConfig, burning: bool,
                             mesh=None):
    """``runner(chains, prop, n_sweeps) -> (chains', chunk)`` where
    ``chunk`` holds device tensors: ksummary [K], theta_sum and
    theta_sqsum [K, D], and the six acceptance counters.  pk adapts only
    when ``cfg.adapt`` and not burning.  An adapting pooled run takes K1c
    when the card holds the population resident (on the CPU, where both
    routes are twins, always) and K1d otherwise or when
    ``_FORCE_POOLED_SCAN`` is set.  The words follow ``cfg.fused_rng``
    resolved on the chains' device (:func:`resolve_rng`).  Under a
    ``mesh`` ``chains`` are this rank's block: the per-chain kernel runs
    at the rank's chain base and the chunk statistics are summed across
    the ranks (every rank gets the global ones); an adapting pooled run
    takes :func:`pooled_sweeps` with the histogram summed every sweep."""
    K, D = modelset.nmodels, modelset.dmax
    adapt = cfg.adapt and not burning
    pooled = cfg.pk_mode == "pooled" and adapt and K > 1
    tdist = (randoms.student_t(cfg.student_t_dof)
             if cfg.student_t_dof > 0 else None)
    cache = {}

    def tables_for(prop: Proposal) -> SweepTables:
        # one set of tables per installed proposal object
        if cache.get("prop") is not prop:
            cache["prop"] = prop
            cache["tables"] = prep_tables(prop, modelset.dims)
        return cache["tables"]

    def runner(chains: Chains, prop: Proposal, n_sweeps: int):
        tables = tables_for(prop)
        dev = chains.k.device
        rng = resolve_rng(cfg.fused_rng, dev)
        if pooled and mesh is not None:
            return pooled_sweeps(modelset, chains, tables, n_sweeps,
                                 seed=int(cfg.seed), perm=cfg.perm,
                                 tdist=tdist, rng=rng, mesh=mesh)
        if pooled and (_FORCE_POOLED_SCAN or (
                dev.type == "cuda" and chains.n_chains > pooled_capacity(
                    modelset, tables.loglam.shape[1], dev, cfg.perm,
                    tdist))):
            return pooled_scan(modelset, chains, tables, n_sweeps,
                               seed=int(cfg.seed), perm=cfg.perm,
                               tdist=tdist, rng=rng)
        outs = sweep_chunk(
            modelset, chains.k, chains.theta.T.contiguous(), chains.logp,
            chains.pk.T.contiguous(), chains.pkllim, chains.nreinit,
            tables, seed=int(cfg.seed), sweep0=chains.sweep,
            n_sweeps=n_sweeps, adapt=adapt, perm=cfg.perm, tdist=tdist,
            pooled=pooled, rng=rng,
            chain0=mesh_lib.chain0(mesh, chains.n_chains))
        (k2, th2, lp2, pk2, pkl2, nri2, ks2, ts2, tq2, cnt2) = outs
        chains_out = Chains(k=k2, theta=th2.T.contiguous(), logp=lp2,
                            pk=pk2.T.contiguous(), pkllim=pkl2,
                            nreinit=nri2, sweep=chains.sweep + n_sweeps,
                            key=chains.key)
        sums = (ks2.sum(dim=1, dtype=torch.int64), ts2.sum(dim=1),
                tq2.sum(dim=1), cnt2.sum(dim=1, dtype=torch.int64))
        return chains_out, _chunk(
            *(mesh_lib.all_reduce_sum(x, mesh) for x in sums), K, D)

    return runner


# Test hook: send adapting pooled runs to K1d (pooled_scan) even where the
# card holds the population resident, so that its bitwise equality with
# K1c can be shown (the JAX package's hook of this name).
_FORCE_POOLED_SCAN = False
