"""SconeVis coverage-gain pretraining (traffic mixes whose ``driver`` is
``pretrain_vis``): the step that ``trainers/pretrain_vis.run_training``
composes, ``assemble_vis_batch`` -> ``batch_to_device`` -> ``vis_loss`` ->
``optimizer_step`` -> the loss's ``.item()``, run back to back over the
train split's shuffled batches, epoch after epoch. Validation and
checkpoints stay out of the window.

Set-up builds one training state (the frozen SconeOcc, SconeVis, AdamW
and its schedule, the generators), drives it through its first steps with
the window's own call, recording each step's batch, draws, loss and the
optimizer's state, and hands the same state to the window. After the
window the plain reference follows those first steps from the seed's
weights (``benchmark/reference/pretrain_vis.py``)."""

from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import flops as F
from ..harness import scenes
from ..harness.common import (
    PROGRAM_STREAM,
    Clock,
    Patches,
    Tracer,
    generator,
    network_weights,
    stream_seed,
)
from .explore import clone


def setup(ctx):
    from macarons_tpu_torch.config import Params
    from macarons_tpu_torch.data import datasets as D
    from macarons_tpu_torch.data import generate_shapenet_data, shapenet
    from macarons_tpu_torch.models import scone as scone_module
    from macarons_tpu_torch.trainers import pretrain_occ as po
    from macarons_tpu_torch.trainers import pretrain_vis as pv
    from macarons_tpu_torch.utils.device import resolve_device

    tr = ctx.traffic
    dev = resolve_device(ctx.device)
    params = Params({k: v for k, v in ctx.config.items()
                     if not k.startswith("_")})
    root = os.path.join(ctx.work_dir, "ShapeNetCore.v1")
    scenes.shapenet_root(root, tr["mesh_levels"])
    params.update(dict(data_path=root))
    generate_shapenet_data.generate(
        root, shapenet.ShapeNetGTConfig(**tr.get("gt_config", {})),
        device=dev, verbose=False)
    paths = D.ShapeNetDataset(root, "train_list.json").paths
    occ = po.build_model(params).to(dev)
    vis = pv.build_vis_model(params).to(dev)
    network_weights(ctx.seed, dev, occ, vis)
    for p in occ.parameters():
        p.requires_grad_(False)
    occ.eval()
    vis.train()
    steps_per_epoch = max(len(paths) // params.batch_size, 1)
    opt, schedule = po.make_optimizer(params, vis, steps_per_epoch)
    consts = po.step_constants(params, dev)
    st = SimpleNamespace(
        params=params, occ=occ, vis=vis, opt=opt, schedule=schedule,
        consts=consts, X_np=consts.X_cam.cpu().numpy(), dev=dev,
        gen=generator(dev, ctx.seed, PROGRAM_STREAM),
        rs=np.random.default_rng(stream_seed(ctx.seed, PROGRAM_STREAM)),
        step=0, steps_per_epoch=steps_per_epoch, paths=paths,
        batches=batches(paths, params.batch_size, ctx.seed), counting=False,
        shapes=[], pv=pv, po=po, records=[], patches=Patches())
    _instrument(ctx, st, scone_module)
    # The first steps, through the window's call, recorded for the check;
    # they also warm up every shape of a step.
    for i in range(tr["check_steps"]):
        rec = {}
        step(st, rec)
        if i == 0:
            # AdamW's first moment; a step that changed nothing has none.
            rec["exp_avg"] = [clone(opt.state[p].get("exp_avg",
                                                     torch.zeros_like(p)))
                              for p in vis.parameters()]
        st.records.append(rec)
    st.after = [clone(p) for p in vis.parameters()]
    Tracer(ctx.trace).warm()
    return st


def batches(paths, batch_size: int, seed: int):
    """The train split's shuffled batches, epoch after epoch."""
    from macarons_tpu_torch.data import datasets as D

    epoch = 0
    while True:
        yield from D.iterate_batches(paths, batch_size, shuffle=True,
                                     seed=seed % 2 ** 31, epoch=epoch)
        epoch += 1


def _instrument(ctx, st, scone_module):
    """Shapes of the networks' and B3's calls, for the model FLOPs; the
    planted faults of the controls and tests."""
    faults = set(ctx.faults)

    def shapes(kind):
        def hook(module, args):
            if st.counting:
                st.shapes.append((kind, tuple(tuple(a.shape) for a in args
                                              if isinstance(a,
                                                            torch.Tensor))))
        return hook

    st.occ.register_forward_pre_hook(shapes("occ"))
    st.vis.register_forward_pre_hook(shapes("vis"))
    sh_fn = scone_module.sh_visibility

    def sh_visibility(pts, harmonics, X_cam, use_sigmoid=True):
        out = sh_fn(pts, harmonics, X_cam, use_sigmoid=use_sigmoid)
        if st.counting:
            st.shapes.append(("sh", (pts.shape[0], X_cam.shape[1],
                                     pts.shape[1])))
        if "answer" in faults:
            out = out * 1.05
        return out

    st.patches.set(scone_module, "sh_visibility", sh_visibility)
    if "half" in faults:
        loss_fn = st.pv.vis_loss

        def vis_loss(params, occ, vis, consts, batch, gen=None, draws=None):
            half = max(batch["pc"].shape[0] // 2, 1)
            return loss_fn(params, occ, vis, consts,
                           {k: v[:half] for k, v in batch.items()}, gen,
                           draws)

        st.patches.set(st.pv, "vis_loss", vis_loss)
    if "unchanged" in faults:
        def optimizer_step(opt, schedule, step_, loss):
            opt.zero_grad(set_to_none=True)
            loss.backward()

        st.patches.set(st.po, "optimizer_step", optimizer_step)


def step(st, rec=None, clock=None, tracer=None):
    """One step of the pretrainer, as its loop composes it. Returns the
    loss's value and the batch's items."""
    pv, po = st.pv, st.po
    t0 = clock.now() if clock else None
    if tracer:
        tracer.mark("bench.batch")
    paths = next(st.batches)
    batch = po.batch_to_device(pv.assemble_vis_batch(
        st.rs, paths, st.X_np, st.params), st.dev)
    if clock:
        t1 = clock.now()
        clock.span("batch", t1 - t0)
    if tracer:
        tracer.mark("bench.step")
    if rec is not None:
        rec.update(batch=clone(batch), gen_state=st.gen.get_state(),
                   step=st.step)
    loss, pred, _ = pv.vis_loss(st.params, st.occ, st.vis, st.consts, batch,
                                st.gen)
    po.optimizer_step(st.opt, st.schedule, st.step, loss)
    st.step += 1
    value = loss.item()
    if clock:
        clock.span("step", clock.now() - t1)
    if rec is not None:
        rec.update(loss=value, pred=clone(pred))
    return value, len(paths)


def window(ctx, st):
    tr = ctx.traffic
    clock = Clock(sync=ctx.trace)
    tracer = Tracer(ctx.trace)
    items = steps = 0
    st.counting = True
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    now = t_start
    while now < t_end:
        if steps == tr["trace_from"]:
            tracer.start()
            mark = len(st.shapes)
        _, n = step(st, clock=clock, tracer=tracer)
        items += n
        steps += 1
        if steps == tr["trace_from"] + tr["trace_steps"] and tracer.active:
            tracer.mark(None)
            tracer.stop()
            traced = st.shapes[mark:]
        now = time.perf_counter()
    # A profiler stopped inside the window paused the program meanwhile.
    window_s = now - t_start - tracer.stop_s
    if tracer.active:
        tracer.mark(None)
        tracer.stop()
        traced = st.shapes[mark:]
    st.counting = False
    reading = tracer.reading() if tracer.done else None
    if reading is not None:
        reading["model_flops"] = model_flops(st, traced)
        reading["sh_bound_s"] = sum(
            F.bound_seconds(F.sh_visibility_flops(*s),
                            F.sh_visibility_bytes(*s))
            for kind, s in traced if kind == "sh")
        reading["sh_backward_bound_s"] = sum(
            F.bound_seconds(F.sh_visibility_backward_flops(*s),
                            F.sh_visibility_backward_bytes(*s))
            for kind, s in traced if kind == "sh")
    return {
        "attempted": items, "failed": 0,
        "metrics": {"pretrain_items_per_s": items / window_s},
        "run": {"spans": clock.spans, "units": steps, "window_s": window_s,
                "trace": reading, "model_flops": model_flops(st, st.shapes)},
    }


def model_flops(st, shapes) -> int:
    """SconeOcc forward (frozen), SconeVis forward and backward (three
    times its forward) and B3 with B3' (every B3 call of a training step
    is differentiated)."""
    p = st.params
    total = 0
    for kind, s in shapes:
        if kind == "occ":
            (B, L, _), (_, S, _) = s[0], s[1]
            total += F.scone_occ_flops(B, S, L, p.get("seq_len", 2048),
                                       p.get("k_for_knn", 16))
        elif kind == "vis":
            total += 3 * F.scone_vis_flops(s[0][0], s[0][1])
        elif kind == "sh":
            total += (F.sh_visibility_flops(*s)
                      + F.sh_visibility_backward_flops(*s))
    return total


def check(ctx, st, out, control: bool = False):
    """The compared numbers of the recorded steps (with ``control``, of
    the reference in TF32 in the program's place)."""
    from ..reference import pretrain_vis as reference

    st.patches.restore()
    program = {"records": st.records, "after": st.after,
               "steps_per_epoch": st.steps_per_epoch}
    params = dict(st.params.to_dict())
    st.occ = st.vis = st.opt = None
    gc.collect()
    torch.cuda.empty_cache()
    return reference.compare(ctx, params, program, control)
