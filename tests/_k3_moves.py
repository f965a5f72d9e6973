"""The one-sweep stage-1 kernel's moves-only mode as a runner's sweep
function, for tests that hold the in-launch update to it."""

from automix_tpu_torch.kernels import fused_stage1
from automix_tpu_torch.ops import randoms


def moves_then_update(sweep_fn):
    """A one-sweep function of ``run_fused_stage1_sweeps``'s form over
    ``sweep_fn``'s moves-only mode: the sweep's counts alone, then
    ``pooled_update`` applied to sig, nacc and ntry in place, as the JAX
    ``seg_fn`` applies the rule outside its kernel (the form a run across
    devices takes, the counts summed in between)."""
    def run(modelset, theta, lp, sig, *, nacc, ntry, rule, log_gain, **kw):
        theta, lp, cnt = sweep_fn(modelset, theta, lp, sig, **kw)
        t = kw["t"]
        block = t > kw["nburn"] and randoms.block_coin(kw["seed"], t)
        new = fused_stage1.pooled_update(
            modelset, sig, nacc, ntry, cnt, C=kw["C"], t=t, adapt=not block,
            rule=rule, log_gain=log_gain)
        for x, v in zip((sig, nacc, ntry), new):
            x.copy_(v)
        return theta, lp, None
    return run
