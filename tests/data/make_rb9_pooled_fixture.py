"""Write ``rb9_pooled_fixture.npz``: one pooled-pk chunk of the JAX fused
sweep kernel on the rb9 family, for ``tests/test_torch_pooled.py``.

1024 chains x 5 sweeps under a two-component proposal (L = 2) made with
numpy from seed 0, run by the JAX package in interpret mode with the
counter hash through both of its pooled routes (the in-kernel histogram
and the per-sweep scan, ``fused._FORCE_POOLED_SCAN``), which must agree
bit for bit.  The file holds the inputs and the outputs.  A live JAX run
takes 40-80 s per route on a CPU, too long for the test suite, hence the
frozen copy.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/make_rb9_pooled_fixture.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from automix_tpu.config import EngineConfig
from automix_tpu.kernels import fused
from automix_tpu.models.rb9 import rb9_set
from automix_tpu.state import Chains, Proposal

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "rb9_pooled_fixture.npz")
S, L, NSWEEPS, SWEEP0, SEED = 1024, 2, 5, 5, 1


def inputs():
    """Proposal and chain state as numpy arrays."""
    ms = rb9_set()
    K, D = ms.nmodels, ms.dmax
    rng = np.random.default_rng(0)
    mask = np.arange(D)[None] < np.asarray(ms.dims)[:, None]
    init = np.asarray(ms.init_points(None), np.float64)
    mu = init[:, None, :] * (1 + 0.1 * rng.normal(size=(K, L, D)))
    mu = mu * mask[:, None, :]
    B = np.where(mask[:, None, :, None] & mask[:, None, None, :],
                 np.eye(D) * 2.0, np.eye(D))
    B = np.broadcast_to(B, (K, L, D, D))
    logdet = (np.log(np.diagonal(B, axis1=-2, axis2=-1))
              * mask[:, None, :]).sum(-1)
    f32 = np.float32
    prop = dict(lam=np.full((K, L), 0.5, f32), mu=mu.astype(f32),
                B=B.astype(f32), logdetB=logdet.astype(f32),
                nmix=np.full(K, L, np.int32), sig=mask.astype(f32))
    k = rng.integers(0, K, S).astype(np.int32)
    theta = init[k].astype(f32)
    cols = fused.make_logpost_cols(ms)
    logp = np.asarray(cols([jnp.asarray((k == m).astype(f32))
                            for m in range(K)],
                           [jnp.asarray(theta[:, d]) for d in range(D)]))
    chains = dict(k=k, theta=theta, logp=logp,
                  pk=np.full((S, K), 1.0 / K, f32),
                  pkllim=np.full(S, 0.1, f32), nreinit=np.ones(S, np.int32))
    return prop, chains


def main():
    jax.config.update("jax_platforms", "cpu")
    prop, chains = inputs()
    jprop = Proposal(**{n: jnp.asarray(v) for n, v in prop.items()})
    jch = Chains(key=jax.random.split(jax.random.PRNGKey(0), S),
                 **{n: jnp.asarray(v) for n, v in chains.items()},
                 sweep=jnp.asarray(SWEEP0, jnp.int32))
    outs = []
    for force in (False, True):
        fused._FORCE_POOLED_SCAN = force
        try:
            run = fused.build_fused_chunk_runner(rb9_set(), EngineConfig(
                seed=SEED, n_chains=S, fused="on", fused_rng="hash",
                pk_mode="pooled"), burning=False)
            outs.append(jax.device_get(run(jch, jprop, NSWEEPS)))
        finally:
            fused._FORCE_POOLED_SCAN = False
    (ch, chunk), (ch2, chunk2) = outs
    for f in ("k", "theta", "pk", "pkllim", "nreinit"):
        np.testing.assert_array_equal(getattr(ch, f), getattr(ch2, f))
    np.testing.assert_array_equal(chunk["ksummary"], chunk2["ksummary"])
    out = {f"prop_{n}": v for n, v in prop.items()}
    out.update({f"in_{n}": v for n, v in chains.items()})
    out.update({f"out_{f}": np.asarray(getattr(ch, f))
                for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit")})
    out.update({f"chunk_{n}": np.asarray(v) for n, v in chunk.items()})
    out["meta"] = np.array([S, L, NSWEEPS, SWEEP0, SEED])
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: ksummary {np.asarray(chunk['ksummary'])}")


if __name__ == "__main__":
    main()
