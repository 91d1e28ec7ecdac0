"""The online trainer one epoch a process (``max_epochs_per_process``, the
train CLI's ``--restart-per-epoch``) on the CPU.

A 2-epoch run of the trainer at test_torch_port_train_loop.py's widths
(perfect depth, SCONE replay in epoch 1, the learning-rate warm-up,
validation after each epoch, the device memory flushed at each epoch's
end and hydrated on resume) through the CLI, once in one process and
once as two child processes of ``--restart-per-epoch``: the losses, every
checkpoint (weights, the optimizer's state, metadata) and every memory
file equal bit for bit. Both runs take one thread, as torch's CPU
reductions may sum in another order on more. Without the resume's
restored best loss (``run_training``) the best_unval_ checkpoint would
differ. The CLI's parent process is also run with its children scripted:
it starts one per epoch, resumes all but the first, never asks torch
about a card, and ends with a failing child's exit code.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from macarons_tpu_torch import train
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.trainers import train_macarons as TM
from test_torch_port_train_loop import TRAIN
from torch_port_helpers import make_scene_root, torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict({k: v for k, v in TRAIN.items() if k != "device_memory"},
           epochs=2, n_poses_in_trajectory=2, macarons_model_name="rpe",
           use_perfect_depth=True, schedule_learning_rate=True,
           scone_warmup=3, val_scenes=["synth_00"], validate_every_n_epochs=1,
           n_val_poses=1)


def write_config(path, **extra):
    path.write_text(json.dumps(dict(RUN, **extra)))
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """(one process's run directory, the restarted run's), each holding
    ``w/`` (checkpoints) and ``mem/`` (the replay memory)."""
    out = tmp_path_factory.mktemp("restart")
    cfg = write_config(out / "config.json", data_path=root)
    one, two = out / "one", out / "two"
    train.main(["-c", cfg, "--weights-dir", str(one / "w"), "--memory-root",
                str(one / "mem"), "--device", "cpu"])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"),
                    os.environ.get("PYTHONPATH")) if p))
    subprocess.run(
        [sys.executable, "-m", "macarons_tpu_torch.train", "-c", cfg,
         "--weights-dir", str(two / "w"), "--memory-root", str(two / "mem"),
         "--device", "cpu", "--restart-per-epoch"],
        env=env, check=True, cwd=str(out))
    return one, two


def files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) for f in fs)


def same(a, b, where):
    """Nested checkpoint contents equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_restarted_losses_and_checkpoints(runs):
    one, two = runs
    assert files(one / "w") == files(two / "w")
    meta = json.loads((two / "w" / "unvalidated_rpe.json").read_text())
    assert meta["epoch"] == 2 and len(meta["train_losses"]) == 2
    assert meta["scone_opt_steps"] > 0
    for name in files(one / "w"):
        a, b = one / "w" / name, two / "w" / name
        if name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), \
                name
        else:
            same(torch.load(a, weights_only=False),
                 torch.load(b, weights_only=False), name)
    losses = json.loads((two / "w" / "losses_data_rpe.json").read_text())
    assert all(np.isfinite(v) for e in losses["train_losses"]
               for v in e.values())


def test_restarted_memory_files(runs):
    one, two = runs
    names = files(one / "mem")
    assert names == files(two / "mem")
    assert any("/1/frames/" in n for n in names)  # epoch 1's slot
    for name in names:
        a, b = one / "mem" / name, two / "mem" / name
        if name.endswith(".npz"):  # a zip stamps the time it was written
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files), name
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=name)
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_max_epochs_per_process(root, tmp_path):
    """One epoch of two: the run stops, its resume point written."""
    _, losses = TM.run_training(
        Params(dict(RUN, data_path=root, max_epochs_per_process=1)),
        weights_dir=str(tmp_path / "w"), memory_root=str(tmp_path / "mem"),
        device="cpu", verbose=False)
    assert len(losses) == 1
    meta = json.loads((tmp_path / "w" / "unvalidated_rpe.json").read_text())
    assert meta["epoch"] == 1
    assert (tmp_path / "w" / "unvalidated_rpe.pt").exists()
    assert not (tmp_path / "w" / "epoch_1_rpe.pt").exists()


def test_restart_parent(tmp_path, monkeypatch):
    """The parent of --restart-per-epoch, its children scripted: one child
    per epoch, the first fresh and the others resuming, each through the
    same CLI on the same device; torch is never asked about a card; a
    failing child's exit code ends the parent, and so does a child that
    trains no epoch."""
    cfg = write_config(tmp_path / "config.json", epochs=3,
                       data_path=str(tmp_path / "none"))
    wdir = tmp_path / "w"
    calls = []

    def child(cmd, env, code=0, advance=1):
        calls.append(cmd)
        assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
        if code == 0:
            done = len([c for c in calls if c is not None]) * advance
            wdir.mkdir(exist_ok=True)
            (wdir / "unvalidated_rpe.json").write_text(json.dumps(
                {"epoch": done}))
        return subprocess.CompletedProcess(cmd, code)

    def no_card(*args, **kw):
        raise AssertionError("the parent asked torch about a card")

    for name in ("is_available", "device_count", "init", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    monkeypatch.setattr(subprocess, "run", child)
    args = ["-c", cfg, "--weights-dir", str(wdir), "--restart-per-epoch"]
    train.main(args)
    assert len(calls) == 3
    for i, cmd in enumerate(calls):
        assert cmd[:3] == [sys.executable, "-m", "macarons_tpu_torch.train"]
        assert "--epoch-child" in cmd and cmd[cmd.index("--device") + 1] \
            == "cuda"
        assert ("--fresh" in cmd) == (i == 0)

    calls.clear()
    (wdir / "unvalidated_rpe.json").unlink()
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, env: child(cmd, env, code=3))
    with pytest.raises(SystemExit) as ended:
        train.main(args)
    assert ended.value.code == 3 and len(calls) == 1

    calls.clear()
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, env: child(cmd, env, advance=0))
    with pytest.raises(SystemExit, match="started"):
        train.main(args)
    assert len(calls) == 1
