"""profiling.py of the port: trace capture, stage timers, throughput (the
contract of tests/test_profiling.py)."""

import glob
import json
import os

import numpy as np
import torch

from automix_tpu_torch import profiling
from automix_tpu_torch.state import RunStats
from _torch_threads import one_torch_thread  # noqa: F401


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.square(torch.arange(128.0)).sum()
    files = [f for f in glob.glob(os.path.join(logdir, "**", "*"),
                                  recursive=True) if os.path.isfile(f)]
    assert files, "no trace artifacts"
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::square" in str(e.get("name")) for e in events)


def test_stage_timer_segments_and_summary():
    t = profiling.StageTimer()
    x = torch.arange(64.0)
    with t.segment("warm"):
        pass
    with t.segment("compute", sync=torch.cumsum(x, 0)):
        pass
    with t.segment("compute", sync=[x, x]):   # accumulates
        pass
    assert set(t.segments) == {"warm", "compute"}
    assert all(v >= 0.0 for v in t.segments.values())
    s = t.summary()
    assert "compute" in s and "%" in s


def test_throughput_from_runstats():
    st = RunStats(2, 3)
    assert profiling.throughput(None) is None
    assert profiling.throughput(st) is None      # no time recorded yet
    st.n_chains = 1000
    st.nsweeps = 50
    st.timesecs_rjmcmc = 2.0
    np.testing.assert_allclose(profiling.throughput(st), 25_000.0)
