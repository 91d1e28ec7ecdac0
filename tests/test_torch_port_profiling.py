"""The port's utils/profiling.py against the JAX package's
(macarons_tpu.utils.profiling), on the CPU: the timers' means and report
lines under one scripted clock, gradient norms on weights carried across,
and a trace written by profile_trace."""

import json
import os

import numpy as np
import torch

from macarons_tpu.utils import profiling as JP
from macarons_tpu_torch.models.attention import init_weights
from macarons_tpu_torch.models.scone import SconeVis
from macarons_tpu_torch.utils import profiling as P
from macarons_tpu_torch.utils.convert import torch_to_flax
from torch_port_helpers import VIS_KW, torch_one_thread  # noqa: F401


class Clock:
    """perf_counter replaced by a scripted sequence of times."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


TICKS = [0.0, 0.25, 1.0, 1.125, 2.0, 2.0625, 3.0, 3.5, 3.5, 3.75]


def drive_timers(mod, monkeypatch):
    monkeypatch.setattr(mod.time, "perf_counter", Clock(TICKS))
    timer = mod.StepTimer()
    for name in ("decision", "capture", "decision"):
        with timer.phase(name, np.zeros(2) if mod is JP else
                         torch.zeros(2)):
            pass
    check = mod.TimeCheck()
    off = mod.TimeCheck(on=False)
    return timer, check.check("step"), off.check("off")


def test_timers_match_jax(monkeypatch, capsys):
    """StepTimer's means and report and TimeCheck's checkpoints equal JAX's
    under the same clock."""
    out = {}
    for mod in (JP, P):
        timer, dt, off = drive_timers(mod, monkeypatch)
        timer.report()
        out[mod] = (timer.means(), dict(timer.times), dt, off,
                    capsys.readouterr().out)
    assert out[JP] == out[P]
    means, _, dt, off, lines = out[P]
    assert means == {"decision": (0.25 + 0.0625) / 2, "capture": 0.125}
    assert dt == 0.5 and off is None
    assert lines.splitlines() == ["[time] step: 0.5000s",
                                  "[step-timer] decision: 156.25 ms (n=2)",
                                  "[step-timer] capture: 125.00 ms (n=1)"]


def test_check_gradients_match_jax(capsys):
    """Per-parameter gradient norms of a SconeVis's .grads equal JAX's
    check_gradients on the same gradients carried across to Flax
    (torch_to_flax), parameter for parameter; the same ten are printed."""
    gen = torch.Generator().manual_seed(4)
    vis = init_weights(SconeVis(**VIS_KW), gen)
    pts = torch.randn(2, 40, 4, generator=gen)
    harm = torch.randn(2, 40, 64, generator=gen)
    vis(pts, harm).square().sum().backward()
    port = P.check_gradients(vis)
    port_lines = capsys.readouterr().out.splitlines()
    carried = SconeVis(**VIS_KW)
    with torch.no_grad():
        for (name, p), q in zip(vis.named_parameters(), carried.parameters()):
            q.copy_(p.grad)
    jax = JP.check_gradients(torch_to_flax(carried))
    jax_lines = capsys.readouterr().out.splitlines()
    assert len(port) == len(jax) == len(list(vis.parameters()))
    np.testing.assert_allclose(sorted(port.values()), sorted(jax.values()),
                               rtol=1e-6)
    assert [float(l.split()[1]) for l in port_lines] == \
        [float(l.split()[1]) for l in jax_lines]
    assert P.check_gradients({n: p.grad for n, p in vis.named_parameters()},
                             verbose=False) == port


def test_profile_trace_writes_a_trace(tmp_path):
    """profile_trace writes a Chrome trace of the block into log_dir (CPU
    activity here) naming the ops it ran."""
    with P.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
