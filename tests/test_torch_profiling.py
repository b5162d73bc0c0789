"""The port's profiling hooks (``sevennet_tpu_torch/profiling.py``) on the
CPU: ``step_timer`` laps (a result of tensors passes through; the laps add
up to the wall time), and ``trace`` writes a Chrome trace of the block
that names its operators."""

import glob
import json
import time

import torch

from sevennet_tpu_torch.profiling import step_timer, trace


def test_step_timer_laps():
    t0 = time.perf_counter()
    with step_timer() as t:
        time.sleep(0.01)
        dt1 = t.lap({"x": [torch.ones(3)]})
        dt2 = t.lap()
    wall = time.perf_counter() - t0
    assert dt1 >= 0.01 and dt2 >= 0.0
    assert t.laps == [dt1, dt2]
    assert abs(t.mean - (dt1 + dt2) / 2) < 1e-12
    assert dt1 + dt2 <= wall


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
