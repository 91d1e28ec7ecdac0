"""The ranks' side of tests/test_torch_port_dist.py: functions that
``parallel.distributed.spawn`` runs in each of W processes on the CPU
(gloo). They import nothing of the JAX package, so a rank starts fast; the
test module builds their inputs and holds their results.

Each case takes its inputs (CPU tensors, numpy arrays and plain dicts,
the global batch or the whole scene group) and returns this rank's
results: the group's losses, the gradients and parameters after the step
(every rank's must be equal), and whether the replicas agree bit for
bit (``mesh.replicas_agree``). Called in one process, a case is the
world-1 run.
"""

import os
import threading
import time
import types

import numpy as np
import torch

from macarons_tpu_torch.config import Params
from macarons_tpu_torch.models import many_depth as md
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    create_optimizers
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.parallel import distributed, mesh
from macarons_tpu_torch.parallel.nbv import make_sharded_coverage_gain_fn
from macarons_tpu_torch.scene import runtime as R
from macarons_tpu_torch.trainers import pretrain_occ as po
from macarons_tpu_torch.trainers import pretrain_vis as pv
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.utils.device import make_generator


def grads_and_params(*nets):
    return ({f"{i}.{n}": p.grad.clone() for i, net in enumerate(nets)
             for n, p in net.named_parameters() if p.grad is not None},
            {f"{i}.{n}": p.detach().clone() for i, net in enumerate(nets)
             for n, p in net.named_parameters()})


def occ_case(x):
    """One occupancy pretraining step on this rank's rows: SconeOcc's
    down-samples deterministic ("plain") and drawn from a generator
    ("drawn")."""
    params = Params(x["params"])
    consts = po.step_constants(params, "cpu")
    out = {}
    for label, seed in (("plain", None), ("drawn", 11)):
        net = SconeOcc(**x["occ_kw"])
        net.load_state_dict(x["state"])
        opt, schedule = po.make_optimizer(params, net, steps_per_epoch=4)
        batch = po.batch_to_device(mesh.shard_batch(x["batch"]), "cpu")
        gen = None if seed is None else make_generator(torch.device("cpu"),
                                                       seed)
        loss = po.occ_loss(params, net, consts, batch, gen)
        po.optimizer_step(opt, schedule, 0, loss)
        grads, after = grads_and_params(net)
        out[label] = {"loss": float(mesh.all_reduce_sum(loss)),
                      "grads": grads, "params": after,
                      "agree": mesh.replicas_agree(net, optimizers=[opt])}
    return out


def vis_case(x):
    """One coverage-gain pretraining step on this rank's rows: the draws
    injected ("plain") and drawn ("drawn")."""
    params = Params(x["params"])
    consts = po.step_constants(params, "cpu")
    occ = SconeOcc(**x["occ_kw"])
    occ.load_state_dict(x["occ_state"])
    occ.eval()
    rows = mesh.shard_rows(len(x["X"]))
    out = {}
    for label in ("plain", "drawn"):
        vis = SconeVis(**x["vis_kw"])
        vis.load_state_dict(x["vis_state"])
        opt, schedule = po.make_optimizer(params, vis, steps_per_epoch=4)
        batch = po.batch_to_device(mesh.shard_batch(x["batch"]), "cpu")
        if label == "plain":
            draws, gen = {"X": torch.as_tensor(x["X"][rows]),
                          "sample_idx": torch.as_tensor(x["idx"][rows])}, None
        else:
            draws, gen = None, make_generator(torch.device("cpu"), 12)
        loss, pred, _ = pv.vis_loss(params, occ, vis, consts, batch, gen,
                                    draws)
        po.optimizer_step(opt, schedule, 0, loss)
        grads, after = grads_and_params(vis)
        out[label] = {"loss": float(mesh.all_reduce_sum(loss)),
                      "pred": pred.detach(), "rows": rows, "grads": grads,
                      "params": after,
                      "agree": mesh.replicas_agree(vis, optimizers=[opt])}
    return out


def depth_case(x):
    """One group depth step in train mode over this rank's scenes'
    supervision windows (in ``x["dtype"]``, default float32)."""
    dtype = x.get("dtype", torch.float32)
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return _depth_case(x, dtype)
    finally:
        torch.set_default_dtype(before)


def _depth_case(x, dtype):
    params = Params(x["params"])
    m = md.ManyDepth(*x["many_depth"])
    m.load_state_dict(x["state"])
    m.to(dtype)
    model = MacaronsModel(SconeOcc(**x["occ_kw"]), SconeVis(**x["vis_kw"]),
                          m.eval())
    rt = TM.MacaronsRuntime(params, model, device="cpu")
    opts = create_optimizers(params, model)
    scenes = []
    for fr in mesh.shard_batch(x["frames"]):
        scene = types.SimpleNamespace(ring=None)
        TM.push_frames(rt, scene, *(
            torch.as_tensor(fr[k]).to(dtype) if fr[k].dtype == np.float32
            else torch.as_tensor(fr[k]) for k in (
                "images", "zbuf", "mask", "R", "T")))
        scenes.append(scene)
    batch, alpha = TM.group_supervision_batch(rt, scenes)
    loss, depth, mask, err = rt.depth_train_step(opts["depth"], batch, alpha,
                                                 draws=x["draws"])
    grads, after = grads_and_params(m)
    return {"loss": float(loss), "grads": grads, "params": after,
            "stats": {k: v.clone() for k, v in m.state_dict().items()
                      if "running" in k},
            "depth": depth, "mask": mask, "err": err,
            "agree": mesh.replicas_agree(m, optimizers=[opts["depth"]])}


def scone_case(x):
    """One group SCONE step over this rank's block of the group, the draws
    injected."""
    params = Params(x["params"])
    occ, vis = SconeOcc(**x["occ_kw"]), SconeVis(**x["vis_kw"])
    occ.load_state_dict(x["occ_state"])
    vis.load_state_dict(x["vis_state"])
    rt = TM.MacaronsRuntime(params, MacaronsModel(occ.eval(), vis.eval(),
                                                  None), device="cpu")
    opts = create_optimizers(params, rt.model)
    rows = mesh.shard_rows(len(x["group"]))
    losses = rt.parallel_scone_train_step(
        opts["scone"], x["group"][rows], n_cells_active=x["n_active"],
        cell_noise=x["noise"][rows], sample_idx=x["idx"][rows])
    grads, after = grads_and_params(occ, vis)
    return {"losses": [float(v) for v in losses], "grads": grads,
            "params": after,
            "agree": mesh.replicas_agree(occ, vis,
                                         optimizers=[opts["scone"]])}


def scorer_case(x):
    """The NBV scorer with the candidates split over the ranks: the MC
    sample injected ("plain") and drawn ("drawn")."""
    vis = SconeVis(**x["vis_kw"])
    vis.load_state_dict(x["vis_state"])
    vis.eval()
    fn = make_sharded_coverage_gain_fn(R.CoverageGain(**x["kw"]))
    args = (vis, *x["field"], x["cams"], x["X"], x["pred_cam"],
            x["box_diag"], x["cell_resolution"], x["sensor_range"])
    plain = fn(*args, sample_idx=x["idx"])
    drawn = fn(*args, generator=make_generator(torch.device("cpu"), 13))
    return {"plain": plain, "drawn": drawn,
            "argmax": int(torch.argmax(plain))}


CASES = {"occ": occ_case, "vis": vis_case, "depth": depth_case,
         "scone": scone_case, "scorer": scorer_case}


def all_cases(inputs):
    """Every case of ``inputs`` on this rank: {case: results}, and
    "on_device": how many ranks share this rank's device."""
    out = {name: CASES[name](x) for name, x in inputs.items()}
    out["on_device"] = mesh.ranks_on_device()
    return out


def training_case(x):
    """``run_training`` at a scene group over the ranks: an epoch, then a
    resumed second one with depth and SCONE replay. Returns the losses,
    every network's state, whether the replicas agree, and over several
    ranks the error of a run at a group of 4 (a trailing group of 3 that
    does not split over 2 ranks), else None."""
    p = dict(x["params"], epochs=1, start_from_scratch=True)
    trailing = None
    if mesh.world() > 1:
        try:
            TM.run_training(Params(dict(p, n_parallel_scenes=4)),
                            weights_dir=x["weights_dir"],
                            memory_root=x["memory_root"], device="cpu",
                            verbose=False)
        except ValueError as e:
            trailing = str(e)
    TM.run_training(Params(p), weights_dir=x["weights_dir"],
                    memory_root=x["memory_root"], device="cpu",
                    verbose=False)
    p.update(epochs=2, start_from_scratch=False)
    model, losses = TM.run_training(Params(p), weights_dir=x["weights_dir"],
                                    memory_root=x["memory_root"],
                                    device="cpu", verbose=False)
    nets = [n for n in ("depth", "occ", "vis")
            if getattr(model, n) is not None]
    return {"losses": losses, "trailing": trailing,
            "state": {n: {k: v.clone() for k, v in
                          getattr(model, n).state_dict().items()}
                      for n in nets},
            "agree": mesh.replicas_agree(*(getattr(model, n) for n in nets))}


def memory_state(memory):
    """A device memory's keys as (scene name, slot) -> ``key_state`` on the
    CPU (the scene name is the memory path's parent directory)."""
    return {(os.path.basename(os.path.dirname(p)), t): {
        k: v.detach().cpu().clone() for k, v in memory.key_state((p, t))
        .items()} for p, t in memory.keys()}


def device_memory_training_case(x):
    """``run_training`` with the device memory at a scene group over the
    ranks: epochs 0 and 1 in one run (epoch 1 replays the slots exchanged
    at epoch 0's end), then a resume, which hydrates the memory and finds
    no epoch left. Returns the losses, every network's state, whether the
    replicas agree, the memory after each epoch's exchange and after the
    resume's hydration, each exchange's record, and each SCONE replay's
    (epoch, scene, slot)."""
    from macarons_tpu_torch.scene.memory import DeviceMemory

    memories, exchanges, replays = {}, {}, []
    exchange = TM.exchange_device_memory
    sample = DeviceMemory.get_random_scene_for_scone
    hydrate = DeviceMemory.hydrate_from_disk

    def exchanged(memory, owners, verbose=False):
        out = exchange(memory, owners, verbose)
        memories[memory.current_epoch] = memory_state(memory)
        exchanges[memory.current_epoch] = dict(out, loaded=[
            (os.path.basename(os.path.dirname(p)), t)
            for p, t in out["loaded"]])
        return out

    def scone_replay(self, rs, scene_path, *args, **kw):
        got = sample(self, rs, scene_path, *args, **kw)
        if got is not None:
            replays.append((self.current_epoch, os.path.basename(
                os.path.dirname(scene_path)), got[0]))
        return got

    def hydrated(self):
        hydrate(self)
        memories["hydrated"] = memory_state(self)

    TM.exchange_device_memory = exchanged
    DeviceMemory.get_random_scene_for_scone = scone_replay
    DeviceMemory.hydrate_from_disk = hydrated
    try:
        for scratch in (True, False):
            p = dict(x["params"], epochs=2, start_from_scratch=scratch)
            model, losses = TM.run_training(
                Params(p), weights_dir=x["weights_dir"],
                memory_root=x["memory_root"], device="cpu", verbose=False)
    finally:
        TM.exchange_device_memory = exchange
        DeviceMemory.get_random_scene_for_scone = sample
        DeviceMemory.hydrate_from_disk = hydrate
    nets = [n for n in ("depth", "occ", "vis")
            if getattr(model, n) is not None]
    return {"losses": losses, "memories": memories, "exchanges": exchanges,
            "replays": replays,
            "state": {n: {k: v.clone() for k, v in
                          getattr(model, n).state_dict().items()}
                      for n in nets},
            "agree": mesh.replicas_agree(*(getattr(model, n) for n in nets))}


def failing_rank(path):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if distributed.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_reduce_(torch.ones(1))
    with open(path, "w") as f:
        f.write("rank 0 went past the collective")


def wait_for(path, seconds=60.0):
    end = time.monotonic() + seconds
    while not os.path.exists(path) and time.monotonic() < end:
        time.sleep(0.01)


def both_ranks_fail(marker_dir):
    """Rank 1 raises; rank 0 raises a second later. Rank 1's process
    outlives rank 0's by two seconds (a non-daemon thread holds its exit),
    so the launcher sees rank 0's end first."""
    raised = {r: os.path.join(marker_dir, f"rank_{r}_raised")
              for r in (0, 1)}
    if distributed.rank() == 1:
        def linger():
            wait_for(raised[0])
            time.sleep(2.0)

        threading.Thread(target=linger).start()
        open(raised[1], "w").close()
        raise RuntimeError("rank 1 fails first")
    wait_for(raised[1])
    time.sleep(1.0)
    open(raised[0], "w").close()
    raise RuntimeError("rank 0 fails after rank 1")


def lone_rank(seconds, timeout, store):
    """The two ranks form their group again, with a ``timeout``-second
    timeout, over the file store ``store``. Then rank 0 works alone for
    ``seconds``, twice. The first time rank 1 waits in
    ``await_lone_work`` and then both all-reduce; the second time rank 1
    waits in an all-reduce of the group, which times out."""
    distributed.barrier()
    rank = distributed.rank()
    distributed.shutdown()
    distributed.initialize(backend="gloo", timeout=timeout,
                           init_method=store, world_size=2, rank=rank,
                           device="cpu")
    out = {"timed_out": None}
    if rank == 0:
        with distributed.local():
            time.sleep(seconds)
    distributed.await_lone_work()
    out["after"] = float(mesh.all_reduce_sum(torch.ones(1)))
    if rank == 0:
        time.sleep(seconds)
    else:
        try:
            mesh.all_reduce_(torch.ones(1))
        except RuntimeError as e:
            out["timed_out"] = str(e)
    return out


def sleeping_rank(seconds):
    time.sleep(seconds)
    return os.getpid()
