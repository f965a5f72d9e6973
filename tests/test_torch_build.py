"""The kernels' build (``kernels/_build.py``) with a stand-in compiler:
the units, K1d's among them, run at most one a CPU core at once in their
order, the log records each, and a failing unit stops the build.  No
``nvcc`` is needed: the stand-in writes each object and records when it
ran."""

import os
import re
import stat
import sys

import pytest

from automix_tpu_torch.kernels import _build

_FAKE = '''
import json, os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
record = os.environ["FAKE_NVCC_RECORD"]
t0 = time.time()
if "-shared" not in args:
    time.sleep(0.2)
    if os.environ.get("FAKE_NVCC_FAIL", "-") in args:
        print("error: refused")
        sys.exit(2)
with open(out, "w") as f:
    f.write("object")
with open(record, "a") as f:
    f.write(json.dumps([args[-1], [a for a in args if a.startswith("-D")],
                        t0, time.time()]) + "\\n")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc on two cores, building into ``tmp_path``; returns
    the file it records its runs in."""
    script = tmp_path / "fake_nvcc.py"
    script.write_text(_FAKE)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    record = tmp_path / "runs.jsonl"
    monkeypatch.setenv("FAKE_NVCC_RECORD", str(record))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    return record


def _runs(record):
    import json
    return [json.loads(line) for line in record.read_text().splitlines()]


def test_units_hold_k1d_in_units_of_its_own():
    """Four K1d units (one a perm / Student-t variant) start after K1's
    four, K3 is a unit per Student-t variant, and every symbol a unit
    exports has a signature and one unit."""
    units = _build._UNITS
    scan = [i for i, u in enumerate(units) if "-DAM_SCAN=1" in u[1]]
    k1 = [i for i, u in enumerate(units)
          if u[0] == "fused_sweep.cu" and i not in scan]
    assert len(scan) == len(k1) == 4 and max(k1) < min(scan)
    assert [u[1][0] for u in units if u[0] == "fused_stage1_sweep.cu"] \
        == ["-DAM_K3_T=0", "-DAM_K3_T=1"]
    exported = [d.split("=", 1)[1] for u in units for d in u[1]
                if "SYMBOL=" in d]
    assert sorted(exported) == sorted(set(exported))
    assert set(exported) <= set(_build._SIGNATURES)
    assert {_build.sweep_symbol(p, t, kind) for p in (0, 1) for t in (0, 1)
            for kind in ("scan", "scan_grid")} <= set(exported)


def test_build_runs_one_unit_a_core_in_order(fake_nvcc):
    """On two cores at most two units compile at once, they start in
    _UNITS order, and the log records each unit's start and end."""
    lib = _build.build()
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    runs = _runs(fake_nvcc)[:-1]                     # the link last
    assert sorted(r[1] for r in runs) == sorted(
        list(u[1]) for u in _build._UNITS)
    for r in runs:
        assert sum(q[2] <= r[2] < q[3] for q in runs) <= 2
    log = lib.with_suffix(".log").read_text()
    started = [float(s) for s in re.findall(r"unit started after ([\d.]+) s",
                                            log)]
    assert len(started) == log.count("unit done after") \
        == len(_build._UNITS)
    assert started == sorted(started) and started[-1] > 0
    assert _build.build() == lib                  # the cached library


def test_build_stops_when_a_unit_fails(fake_nvcc, monkeypatch):
    """A unit that fails raises with the compiler's output, the units not
    yet started never start, and no library is written."""
    monkeypatch.setenv("FAKE_NVCC_FAIL", "-DAM_SCAN=1")
    with pytest.raises(RuntimeError, match="refused"):
        _build.build()
    runs = _runs(fake_nvcc) if fake_nvcc.exists() else []
    assert not any("-DAM_SCAN=1" in r[1] for r in runs)
    assert len(runs) < len(_build._UNITS)
    assert not list(_build.BUILD_DIR.glob("*.so"))
