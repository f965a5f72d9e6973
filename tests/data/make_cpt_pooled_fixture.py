"""Write ``cpt_pooled_fixture.npz``: one pooled-pk chunk of the JAX
package's per-sweep pooled runner (``_compiled_pooled``, forced with
``fused._FORCE_POOLED_SCAN``) on the change-point family at (6, 13), for
``tests/test_torch_pooled.py``.

1024 chains x 4 sweeps from sweep 41 at the start points of their models
(drawn with numpy from seed 7) under a two-component proposal around them
at the posterior's scales, run in interpret mode with the counter hash.
The JAX package's cpt models have no column form (their ``logp`` closes
over the event array, which a Pallas kernel cannot capture), so the run
gives its fused kernel one here: ``CptDensity``, each model's ``logp``
formula with the constants its closure holds and the events passed in as
the kernel's table.  The file holds the inputs and the outputs.  The
kernel's compile alone takes ~2.5 minutes on a CPU, too long for the test
suite, hence the frozen copy.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/make_cpt_pooled_fixture.py
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import gammaln as np_gammaln

from automix_tpu.config import NEG_INF, EngineConfig
from automix_tpu.kernels import fused
from automix_tpu.model import ModelSet
from automix_tpu.models.changepoint import cpt_set
from automix_tpu.state import Chains, Proposal

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "cpt_pooled_fixture.npz")
S, L, NSWEEPS, SWEEP0, SEED = 1024, 2, 4, 41, 7


class CptDensity:
    """JAX's cpt densities in column form for its fused kernel, which the
    JAX package's cpt models lack (their ``logp`` closes over the event
    array, which a Pallas kernel cannot capture, and runs a per-state
    ``searchsorted``).  Each model's ``logp`` formula with the constants
    its closure holds, the segment counts by comparisons with the events
    (passed in as the kernel's table; the same integers as the
    histogram), mask-selected and sanitized as ``make_logpost_cols``."""

    n_cache = 0

    def __init__(self):
        self.models = cpt_set().models
        logp = self.models[0].logp
        self.c = {name: cell.cell_contents for name, cell in
                  zip(logp.__code__.co_freevars, logp.__closure__)}
        self.events = np.asarray(self.c["data_j"])

    def table_arrays(self, ndim):
        return (self.events.reshape((-1,) + (1,) * ndim),)

    def _logp(self, n, rows, ev):
        c = self.c
        h, s_in = rows[:n + 1], rows[n + 1:2 * n + 1]
        s = [jnp.zeros_like(rows[0])] + list(s_in) + [
            jnp.full_like(rows[0], c["t_end"])]
        ds = [s[i + 1] - s[i] for i in range(n + 1)]
        ok = functools.reduce(jnp.logical_and,
                              [x > 0.0 for x in list(h) + ds])
        hs = [jnp.where(ok, x, 1.0) for x in h]
        dss = [jnp.where(ok, x, 1.0) for x in ds]
        lp = (-c["lam_prior"] + n * np.log(c["lam_prior"])
              - float(np_gammaln(n + 1.0)))
        lp = lp + sum(c["abcon"] + (c["alpha"] - 1.0) * jnp.log(a)
                      - c["beta"] * a + jnp.log(b) for a, b in zip(hs, dss))
        lp = lp + float(np_gammaln(2.0 * (n + 1))) \
            - (2.0 * n + 1.0) * c["logl"]
        below = [jnp.sum((ev <= x).astype(jnp.float32), axis=0)
                 for x in s_in]
        nj = ([below[0]] + [below[i] - below[i - 1] for i in range(1, n)]
              + [float(len(self.events)) - below[-1]])
        llh = sum(a * jnp.log(b) - b * d for a, b, d in zip(nj, hs, dss))
        return jnp.where(ok, lp + llh, c["reject_value"])

    def full(self, mks, rows, tabs=()):
        ev = tabs[0][...]
        out = None
        for m in range(len(self.models)):
            lp = self._logp(m + 1, rows, ev)
            lp = jnp.minimum(jnp.maximum(lp, NEG_INF), -NEG_INF)
            term = mks[m] * jnp.where(lp == lp, lp, NEG_INF)
            out = term if out is None else out + term
        return out, ()

    def coord(self, j, mks, rows, old_j, cache, tabs=()):
        return self.full(mks, rows, tabs)


def _cpt_inputs(rng, n_chains, L=2):
    """cpt (6, 13) chains at the start points of their models (drawn from
    ``rng``) under an L-component proposal around them at the posterior's
    scales (rates 1e-3, change points 2000), and their JAX logp."""
    ms = cpt_set()
    K, D = ms.nmodels, ms.dmax
    init = np.asarray(ms.init_points(None), np.float64)
    dm = np.arange(D)[None] < np.asarray(ms.dims)[:, None]
    rate = np.arange(D)[None] < (np.arange(K) + 2)[:, None]
    scale = np.where(rate, 1e-3, 2000.0) * dm
    mu = (init[:, None] + 0.3 * scale[:, None]
          * rng.standard_normal((K, L, D))) * dm[:, None]
    B = np.where(dm[:, None, :, None] & dm[:, None, None, :],
                 np.eye(D) * (scale[:, None, None, :]
                              * rng.uniform(0.8, 1.2, (K, L, 1, D))),
                 np.eye(D))
    logdet = (np.log(np.diagonal(B, axis1=-2, axis2=-1))
              * dm[:, None]).sum(-1)
    f32 = np.float32
    p = dict(lam=rng.dirichlet(np.ones(L), K).astype(f32),
             mu=mu.astype(f32), B=B.astype(f32), logdetB=logdet.astype(f32),
             nmix=np.full(K, L, np.int32), sig=(0.3 * scale).astype(f32))
    k = rng.integers(0, K, n_chains).astype(np.int32)
    theta = init[k].astype(f32)
    dens = CptDensity()
    logp = np.asarray(dens.full(
        [jnp.asarray((k == m).astype(f32)) for m in range(K)],
        [jnp.asarray(theta[:, d]) for d in range(D)],
        (jnp.asarray(dens.table_arrays(1)[0]),))[0])
    c = dict(k=k, theta=theta, logp=logp,
             pk=np.full((n_chains, K), 1 / K, f32),
             pkllim=np.full(n_chains, 0.1, f32),
             nreinit=np.ones(n_chains, np.int32))
    return p, c


def main():
    jax.config.update("jax_platforms", "cpu")
    prop, chains = _cpt_inputs(np.random.default_rng(SEED), S, L)
    jprop = Proposal(**{n: jnp.asarray(v) for n, v in prop.items()})
    jch = Chains(key=jax.random.split(jax.random.PRNGKey(0), S),
                 **{n: jnp.asarray(v) for n, v in chains.items()},
                 sweep=jnp.asarray(SWEEP0, jnp.int32))
    ms = ModelSet(cpt_set().models, fused_density=CptDensity())
    fused._FORCE_POOLED_SCAN = True
    try:
        run = fused.build_fused_chunk_runner(ms, EngineConfig(
            seed=SEED, n_chains=S, fused="on", fused_rng="hash",
            pk_mode="pooled"), burning=False)
        ch, chunk = jax.device_get(run(jch, jprop, NSWEEPS))
    finally:
        fused._FORCE_POOLED_SCAN = False
    out = {f"prop_{n}": v for n, v in prop.items()}
    out.update({f"in_{n}": v for n, v in chains.items()})
    out.update({f"out_{f}": np.asarray(getattr(ch, f))
                for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit")})
    out.update({f"chunk_{n}": np.asarray(v) for n, v in chunk.items()})
    out["meta"] = np.array([S, L, NSWEEPS, SWEEP0, SEED])
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: ksummary {np.asarray(chunk['ksummary'])}, "
          f"chains that changed model {(ch.k != chains['k']).mean():.4f}")


if __name__ == "__main__":
    main()
