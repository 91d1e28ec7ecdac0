"""The check of the smoke's SCONE hold (chip_smoke.py) on the card: the hold
on sound states, with the gaps of every flip it excuses, and on two
planted faults that it must refuse.

Usage: python3 scone_holds.py N [--first-seed S] [--only I,J,...]

Trains one epoch of the default training config on synth_00 subdivided to
59,392 faces, holds N SCONE steps of it (draws from seeds SEED + S on) on
the card against the CPU's float64 and float32 runs forced to the card's
picks (chip_smoke.hold_scone_runs, scone_verdict), then one state with a wrong
max-pool pick planted (planted_pick) and one with B3's backward scaled by
1 + WRONG_GRADIENT_REL (scaled_backward); both must fail the hold. A state
saved by the smoke and copied to macarons_tpu_torch/_build/scone_step.pt.gz
is replayed last. Rerun it when SconeOcc's widths, its kNN or max-pool,
B3's kernels or chip_smoke.TIE_REL change. Needs a CUDA card; exits
non-zero if any check fails.
"""

import collections
import os
import tempfile
import time

import numpy as np
import torch

from chip_smoke import BUILD_DIR, HELD_DIR, RUNS, SCENE_LEVELS, SEED, \
    TIE_REL, StepRecorder, _work_dir, fail, gap_summary, hold_scone_runs, \
    in_dtype, load_scone_step, phase_build, print_excused, \
    replay_scone_step, save_scone_step, scene_scale_suite, scone_state, \
    scone_stepper, scone_verdict, shv, train_params
from macarons_tpu_torch.trainers.train_macarons import run_training
from macarons_tpu_torch.utils.device import make_generator, resolve_device

# A planted wrong pick's gap is at least this many TIE_RELs; a planted
# wrong gradient scales B3's backward by 1 + WRONG_GRADIENT_REL.
PLANT_TIE_RELS = 100
WRONG_GRADIENT_REL = 1e-3
# The first seed offset whose draws no earlier check used (the first
# check drew from 200-209).
FIRST_SEED = 300


def phase_scone_holds(n, first=FIRST_SEED, only=None):
    """The SCONE hold alone, ``n`` times on sound states, then on two
    planted faults. One training epoch as phase_depth_holds' (4 poses on
    the 59,392-face scene, at the config's seeds) gives the trained
    networks and its online SCONE steps' calls; hold i takes call i mod 4
    with its draws (the cell noise, the Monte-Carlo sample) from seed
    SEED + ``first`` + i.
    Every hold must pass; the gaps of every flip are printed; the first
    state that fails is saved under chip_smoke.HELD_DIR as
    scone_hold_<seed>.pt.gz, and the holds go on to count every state. A
    state where a network has no float64 gradient at all cannot be held
    by the relative rule: it is counted apart, and fails unless the card's
    and the CPU's gradients of that network are zero too. ``only``: the
    holds (0-based) to run of the n, each with its own call and draws.
    Then on the first held state: a wrong pick (planted_pick: the
    global transformer's first maximum moved to its column's smallest
    value, a gap of at least PLANT_TIE_RELS x TIE_REL) and a wrong gradient
    (scaled_backward) must each fail the hold. Then a saved state, if one
    was copied to macarons_tpu_torch/_build/scone_step.pt.gz, replayed
    (replay_scone_step) and its verdict printed."""
    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_holds_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        params = train_params(root, 1)
        with StepRecorder() as rec:
            model, _ = run_training(params, weights_dir=os.path.join(
                tmp, "weights"), memory_root=os.path.join(tmp, "mem"),
                device=dev, verbose=False, on_phase=rec.on_phase)
    calls = rec.scone_calls
    gaps = {"knn": [], "pool": [], "view": []}
    failed, unreadable, held = [], [], []
    for i in range(n):
        if only is not None and i not in only:
            continue
        rt, args, kw = calls[i % len(calls)]
        t0 = time.perf_counter()
        state = scone_state(params, model, rt, args, kw,
                            make_generator(dev, SEED + first + i))
        tag = f"scone holds {i + 1}/{n}"
        card, cpu, ref = hold_scone_runs(scone_stepper(state), tag)
        flat = no_gradient(card, cpu, ref)
        if flat:
            # The rule is relative to the float64 gradient: a network
            # without one cannot be held, only seen to be zero everywhere.
            print(f"[scone holds] hold {i + 1}/{n} (seed {SEED + first + i}) "
                  f"unreadable: no float64 gradient for {flat}", flush=True)
            unreadable.append(SEED + first + i)
            if any(v for v in flat.values()):
                failed.append(SEED + first + i)
            continue
        errs, faults = scone_verdict(card, cpu, ref)
        if faults:
            # The first failing state is kept for replay_scone_step; the
            # holds go on, so that the run counts every state.
            print(f"[scone holds] hold {i + 1}/{n} FAILED on a sound state "
                  f"(seed {SEED + first + i}): {'; '.join(faults)}: {errs}",
                  flush=True)
            if not failed:
                save_scone_step(os.path.join(
                    HELD_DIR, f"scone_hold_{SEED + first + i}.pt.gz"),
                    state, card)
            failed.append(SEED + first + i)
            continue
        print_excused(tag, errs)
        held.append(i)
        ref_gaps = ref["gaps"]
        for k in gaps:
            gaps[k].append(ref_gaps[k])
        print(f"[scone holds] hold {i + 1}/{n} (call {i % len(calls)}) "
              f"passed in {time.perf_counter() - t0:.1f} s: {errs}; gaps "
              f"by decade {gap_decades(ref_gaps)}", flush=True)
    ran = len(held) + len(unreadable) + len(failed) - len(
        set(unreadable) & set(failed))
    print(f"[scone holds] {len(held)} of {ran} states held; unreadable (a "
          f"network without a float64 gradient): {unreadable}; failed: "
          f"{failed}", flush=True)
    if failed:
        fail(f"{len(failed)} of {ran} SCONE holds failed on sound states "
             f"(seeds {failed})")
    if not held:
        fail("no state could be held")
    every = {k: torch.cat(v) for k, v in gaps.items()}
    largest = max(g for _, g in gap_summary(every).values())
    print(f"[scone holds] {len(held)} sound states: flips "
          f"{gap_summary(every)}, by decade {gap_decades(every)}; the "
          f"largest gap is {largest / TIE_REL:.3e} x TIE_REL "
          f"({TIE_REL:.3e})", flush=True)

    # The planted faults on the first state held.
    state = scone_state(params, model, *calls[held[0] % len(calls)],
                        make_generator(dev, SEED + first + held[0]))
    step = scone_stepper(state)
    planted = {"pick": lambda: step(*RUNS[0], plant=planted_pick),
               "gradient": lambda: with_scaled_backward(step)}
    for name, card_run in planted.items():
        card = in_dtype(torch.float32, card_run)
        ref = in_dtype(torch.float64, lambda: step(
            *RUNS[2], card["picks"], card["maxima"], views=card["views"]))
        cpu = in_dtype(torch.float32, lambda: step(
            *RUNS[1], card["picks"], card["maxima"], views=card["views"]))
        errs, faults = scone_verdict(card, cpu, ref)
        largest = float(ref["gaps"]["pool"].max()) if len(
            ref["gaps"]["pool"]) else 0.0
        print(f"[scone holds] planted wrong {name}: the hold "
              f"{'fails' if faults else 'passes'}: "
              f"{'; '.join(faults)}: {errs}; largest max-pool gap "
              f"{largest:.3e} ({largest / TIE_REL:.1f} x TIE_REL)", flush=True)
        if name == "pick" and not largest >= PLANT_TIE_RELS * TIE_REL:
            fail(f"the planted pick's gap {largest:.3e} is below "
                 f"{PLANT_TIE_RELS} x TIE_REL")
        if not faults:
            fail(f"the SCONE hold passed a planted wrong {name}")

    saved = os.path.join(BUILD_DIR, "scone_step.pt.gz")
    if os.path.exists(saved):
        print(f"[scone holds] replaying the saved state {saved}", flush=True)
        replay_scone_step(load_scone_step(saved))


def no_gradient(card, cpu, ref):
    """The networks whose float64 gradient is zero everywhere, each with
    the largest |g| of the card's and the CPU's float32 gradients (0.0
    where they are zero too)."""
    out = {}
    for name in ("occ", "vis"):
        if all(float(g.abs().max()) == 0.0 for g in ref[name].values()):
            out[name] = max(float(g.abs().max()) for run in (card, cpu)
                            for g in run[name].values())
    return out


def gap_decades(gaps):
    """Per kind of pick, the number of flips whose gap lies in each decade
    [1e-(e+1), 1e-e), keyed by its upper end, zeros under "0"."""
    out = {}
    for kind, g in gaps.items():
        g = torch.as_tensor(g, dtype=torch.float64)
        zero = g <= 0
        e = torch.ceil(torch.log10(g[~zero])).long().tolist()
        out[kind] = dict(sorted(collections.Counter(
            f"1e{x}" for x in e).items()), **({"0": int(zero.sum())}
                                               if zero.any() else {}))
    return out


def with_scaled_backward(step):
    """``step``'s float32 run on the card with B3's backward scaled by
    1 + WRONG_GRADIENT_REL (scaled_backward)."""
    with scaled_backward(WRONG_GRADIENT_REL):
        return step(*RUNS[0])


class planted_pick:
    """A planted wrong pick, as a faulty kernel would make one: on the
    first call of ``net``'s (SconeOcc's) global transformer, the maximum
    of feature 0 of its first cloud is moved to the valid point with the
    column's smallest value, by raising that point to just above the
    maximum. Enter it before pool_picks, which then records the planted
    pick as the run's own."""

    def __init__(self, net):
        self.mod = net.global_transformer

    def __enter__(self):
        self.done, self.mask = False, None
        self.hooks = [
            self.mod.register_forward_pre_hook(self.pre, with_kwargs=True),
            self.mod.Dense_0.register_forward_hook(self.post)]
        return self

    def pre(self, module, args, kwargs):
        self.mask = kwargs.get("pts_mask")

    def post(self, module, args, out):
        if self.done:
            return out
        self.done = True
        col = out.detach()[0, :, 0]
        ok = (self.mask[0] if self.mask is not None
              else torch.ones_like(col, dtype=torch.bool))
        low = int(torch.argmin(col.masked_fill(~ok, np.inf)))
        peak = col.masked_fill(~ok, -np.inf).max()
        lift = torch.zeros_like(out)
        lift[0, low, 0] = torch.nextafter(peak, peak + 1) - col[low]
        return out + lift

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


class scaled_backward:
    """A planted wrong gradient, for the hold's check only: B3's backward
    kernel's output scaled by ``1 + rel`` while the block runs (its launch
    count kept)."""

    def __init__(self, rel):
        self.rel = rel

    def __enter__(self):
        self.own = own = shv.sh_visibility_backward

        def scaled(*args, **kw):
            return own(*args, **kw) * (1.0 + self.rel)

        # The wrapper counts its launches under the module's name for it.
        scaled.launches = own.launches
        shv.sh_visibility_backward = scaled
        return self

    def __exit__(self, *exc):
        self.own.launches = shv.sh_visibility_backward.launches
        shv.sh_visibility_backward = self.own


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int, help="the number of sound states")
    parser.add_argument("--only", default=None, metavar="I,J,...",
                        help="hold only these of the n states (0-based), "
                        "each with the draws and call it has in the run of n")
    parser.add_argument("--first-seed", type=int, default=FIRST_SEED,
                        help="the seed offset of the first state's draws")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    phase_build()
    phase_scone_holds(args.n, args.first_seed, None if args.only is None
                      else {int(i) for i in args.only.split(",")})
