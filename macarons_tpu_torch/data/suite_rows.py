"""The synthetic suite's quality rows on one card, held to the committed
RESULTS_synthetic.json: nbv, random and carving at torch seeds 5, 6 and 7,
and an nbv row from a checkpoint the port trains on the suite.

Usage:
  python -m macarons_tpu_torch.data.suite_rows --run nbv,random,carving
  python -m macarons_tpu_torch.data.suite_rows --run train,trained
  python -m macarons_tpu_torch.data.suite_rows --summarize
  (each with [--out-dir results/suite_rows])

``--run`` evaluates each row through the suite's CLI (``synthetic_suite
eval``) on the card at the committed protocol, 100 poses x 5 starts:
carving on the 10 scenes, nbv on scenes 0-4 with the committed SconeVis
weights, the trained row on scenes 0-4 with the SconeVis of the newest
epoch of the training run (``<out-dir>/weights/epoch_<e>_vis.msgpack``;
under ``eval_params`` only SconeVis reaches a decision). The committed
random row is two runs, scenes 0-4 and scenes 5-9, each with its own numpy
generator, and is run so. A row's runs go side by side,
one process each sharing the card (the seconds per pose each writes are
taken under that load); the rows go one after another. ``train`` first
writes the suite's training config (``synthetic_suite train-config``) and
trains on it (``macarons_tpu_torch.train``), one epoch per process, each
resuming the last, and writes each epoch's SconeVis as a Flax variables
msgpack (``epoch_<e>_vis.msgpack``, which the JAX package reads too) as
soon as the epoch ends. Each run writes
``<out-dir>/<run>_<seed>.json`` and ``<out-dir>/logs/<run>_<seed>.log``;
``rows.json`` then holds each row's mean and standard deviation over the
seeds beside the committed JAX row, the hold (the JAX value within the mean
+- max(3 s, 0.005)), and how many walks take the committed poses.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np

from .synthetic_suite import REPO_DIR, SUITE_VIS_INIT
from .synthetic_suite import summarize as summarize_results

SUITE = "data/synthetic_scenes"
POSES, STARTS, SEEDS = 100, 5, (5, 6, 7)
FIRST_RUN = [f"synth_{i:02d}" for i in range(5)]
SECOND_RUN = [f"synth_{i:02d}" for i in range(5, 10)]
METRICS = ("mean_final_coverage", "mean_auc", "mean_auc_30")
HOLD_FLOOR = 0.005
TRAINED_VIS = re.compile(r"epoch_(\d+)_vis\.msgpack")
# Each row's runs: (run name, policy, scenes or None for all). The
# committed random row's walks of scenes 5-9 are those of a run that
# starts at synth_05, so "random_b" is that second run.
ROWS = {"nbv": [("nbv", "nbv", FIRST_RUN)],
        "random": [("random", "random", FIRST_RUN),
                   ("random_b", "random", SECOND_RUN)],
        "carving": [("carving", "carving", None)],
        "trained": [("trained", "nbv", FIRST_RUN)]}
# The committed row each is held to.
JAX_ROW = {"nbv": "nbv", "random": "random", "carving": "carving",
           "trained": "nbv_trained"}


def eval_cmd(run, policy, scenes, seed, out_dir):
    """The CLI command of one evaluation run."""
    cmd = [sys.executable, "-m", "macarons_tpu_torch.data.synthetic_suite",
           "eval", SUITE, "--policies", policy, "--poses", str(POSES),
           "--starts", str(STARTS), "--torch-seed", str(seed),
           "--out", os.path.join(out_dir, f"{run}_{seed}.json")]
    if scenes:
        cmd += ["--test-scenes", ",".join(scenes)]
    if run == "nbv":
        cmd += ["--vis-weights", SUITE_VIS_INIT + ".msgpack"]
    if run == "trained":
        cmd += ["--vis-weights", trained_vis(out_dir)]
    return cmd


def trained_vis(out_dir):
    """The newest epoch's SconeVis msgpack under ``<out_dir>/weights``."""
    found = {int(m.group(1)): m.group(0) for m in (
        TRAINED_VIS.fullmatch(f) for f in os.listdir(
            os.path.join(out_dir, "weights"))) if m}
    if not found:
        raise FileNotFoundError(f"no epoch_<e>_vis.msgpack under "
                                f"{out_dir}/weights")
    return os.path.join(out_dir, "weights", found[max(found)])


def write_epoch_vis(config, out_dir, epoch):
    """``<out_dir>/weights/epoch_<epoch>_vis.msgpack``: the SconeVis of the
    training run's ``epoch_<epoch>`` checkpoint as Flax variables."""
    import torch

    from ..config import Params
    from ..models.macarons import create_macarons_model
    from ..utils.convert import torch_to_flax, write_msgpack

    wdir = os.path.join(out_dir, "weights")
    name = config.get("macarons_model_name", "macarons")
    vis = create_macarons_model(Params(config), "cpu").vis
    vis.load_state_dict(torch.load(
        os.path.join(wdir, f"epoch_{epoch}_{name}.pt"), map_location="cpu",
        weights_only=True)["vis"])
    return write_msgpack(os.path.join(wdir, f"epoch_{epoch}_vis"),
                         torch_to_flax(vis))


def run_logged(cmds, logs):
    """Run ``{name: command}`` side by side from the repo's root, each to
    ``<logs>/<name>.log``, one host thread each (processes with every core
    each gain nothing from sharing the card); raise if any fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for name, cmd in cmds.items():
        with open(os.path.join(logs, name + ".log"), "w") as log:
            procs[name] = subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           cwd=REPO_DIR, env=env)
    failed = [name for name, p in procs.items() if p.wait() != 0]
    if failed:
        raise RuntimeError(f"{', '.join(failed)} failed (logs under {logs})")


def run(rows, out_dir):
    """Train if ``rows`` holds "train", then evaluate the other rows."""
    logs = os.path.join(out_dir, "logs")
    os.makedirs(logs, exist_ok=True)
    if "train" in rows:
        cfg = os.path.join(out_dir, "train_config.json")
        run_logged({"train_config": [
            sys.executable, "-m", "macarons_tpu_torch.data.synthetic_suite",
            "train-config", SUITE, "--out", cfg]}, logs)
        with open(cfg) as f:
            config = json.load(f)
        for epoch in range(config["epochs"]):
            epoch_cfg = os.path.join(out_dir, f"train_config_{epoch}.json")
            with open(epoch_cfg, "w") as f:
                json.dump(dict(config, epochs=epoch + 1,
                               start_from_scratch=epoch == 0), f, indent=1)
            run_logged({f"train_{epoch}": [
                sys.executable, "-m", "macarons_tpu_torch.train", "-c",
                epoch_cfg, "--weights-dir", os.path.join(out_dir, "weights"),
                "--memory-root", os.path.join(out_dir, "_train_memory")]},
                logs)
            print(f"wrote {write_epoch_vis(config, out_dir, epoch)}",
                  flush=True)
    for row in rows:
        if row != "train":
            run_logged({f"{name}_{seed}": eval_cmd(name, policy, scenes,
                                                   seed, out_dir)
                        for name, policy, scenes in ROWS[row]
                        for seed in SEEDS}, logs)


def pose_matches(results, committed):
    """Trajectories of the scenes in ``results`` whose cam_idx equal the
    committed ones of their scene and start, out of the committed ones of
    those scenes, and the first that does not: (scene, start, pose index,
    ours, committed)."""
    n, total, first = 0, 0, None
    for scene, starts in committed.items():
        if scene not in results:
            continue
        for s, ref in starts.items():
            total += 1
            ours = results[scene].get(s, {}).get("cam_idx")
            if ours == ref["cam_idx"]:
                n += 1
            elif first is None and ours is not None:
                i = next((i for i, (a, b) in enumerate(
                    zip(ours, ref["cam_idx"])) if a != b),
                    min(len(ours), len(ref["cam_idx"])))
                first = (scene, s, i, ours[i] if i < len(ours) else None,
                         ref["cam_idx"][i] if i < len(ref["cam_idx"]) else
                         None)
    return n, total, first


def trajectories(data):
    """A one-policy results file's trajectories (its top level)."""
    return {k: v for k, v in data.items() if not k.startswith("_")}


def load_runs(out_dir, run):
    """{seed: results} of ``<out_dir>/<run>_<seed>.json``."""
    data = {}
    for path in glob.glob(os.path.join(out_dir, f"{run}_*.json")):
        m = re.fullmatch(rf"{run}_(\d+)\.json", os.path.basename(path))
        if m:
            with open(path) as f:
                data[int(m.group(1))] = json.load(f)
    return dict(sorted(data.items()))


def load_row(out_dir, row):
    """{seed: (trajectories, seconds per pose)} of a row: its runs'
    trajectories of their own scenes, and the mean of their seconds per
    pose; only the seeds that every run of the row has."""
    runs = [(load_runs(out_dir, name), policy, scenes)
            for name, policy, scenes in ROWS[row]]
    seeds = set.intersection(*(set(r) for r, _, _ in runs))
    out = {}
    for seed in sorted(seeds):
        res, sec = {}, []
        for r, policy, scenes in runs:
            traj = trajectories(r[seed])
            res.update({k: v for k, v in traj.items()
                        if scenes is None or k in scenes})
            sec.append(r[seed]["_protocol"]["seconds_per_pose"][policy])
        out[seed] = (res, float(np.mean(sec)))
    return out


def hold(values, jax_value):
    """The hold of one number: the JAX value within the seeds' mean +-
    max(3 s, HOLD_FLOOR), s the sample standard deviation."""
    v = np.asarray(values, float)
    sd = float(v.std(ddof=1)) if len(v) > 1 else float("nan")
    half = max(3 * sd, HOLD_FLOOR) if len(v) > 1 else HOLD_FLOOR
    return {"per_seed": v.tolist(), "mean": float(v.mean()), "sd": sd,
            "half_width": half, "jax_minus_mean": jax_value - float(v.mean()),
            "held": bool(abs(jax_value - v.mean()) <= half)}


def vis_change(path):
    """How far a trained SconeVis msgpack lies from its start,
    SUITE_VIS_INIT: the largest |w - w0| and ||w - w0|| / ||w0||."""
    import torch

    from ..utils.convert import flax_to_torch, read_msgpack

    init = flax_to_torch(read_msgpack(SUITE_VIS_INIT))
    vis = flax_to_torch(read_msgpack(path[:-len(".msgpack")]))
    d = torch.cat([(vis[k] - w).reshape(-1) for k, w in init.items()])
    w0 = torch.cat([w.reshape(-1) for w in init.values()])
    return {"checkpoint": os.path.basename(path),
            "max_abs": float(d.abs().max()),
            "relative_norm": float(d.norm() / w0.norm())}


def summarize(out_dir):
    """rows.json: each row over the seeds beside the committed JAX row;
    the walks of every random and carving run on the committed poses."""
    with open(os.path.join(REPO_DIR, "RESULTS_synthetic.json")) as f:
        committed = json.load(f)
    jax_rows = committed["_all_summaries"]
    out = {"rows": {}, "pose_matches": {}, "seconds_per_pose": {},
           "hold": f"JAX within mean +- max(3 s, {HOLD_FLOOR}), s the "
                   "sample standard deviation (ddof 1) over the seeds"}
    for row, ref in JAX_ROW.items():
        data = load_row(out_dir, row)
        if not data:
            continue
        out["seconds_per_pose"][row] = {s: d[1] for s, d in data.items()}
        policy = ROWS[row][0][1]
        for subset in ("", "_valid_starts"):
            per_seed = {s: summarize_results({policy: d[0]})[0][
                policy + subset] for s, d in data.items()}
            entry = {"seeds": sorted(per_seed), "n_traj": sorted(
                {r["n_traj"] for r in per_seed.values()}),
                "jax": jax_rows[ref + subset]}
            entry.update({m: hold([r[m] for r in per_seed.values()],
                                  jax_rows[ref + subset][m])
                          for m in METRICS})
            out["rows"][row + subset] = entry
        if ref in committed["_baselines"]:
            walks = committed["_baselines"][ref]
            out["pose_matches"][row] = {
                s: dict(zip(("matching", "of", "first_mismatch"),
                            pose_matches(d[0], walks)))
                for s, d in data.items()}
            # A row of two runs: each run alone, on every scene it ran.
            for name, _, _ in ROWS[row] if len(ROWS[row]) > 1 else ():
                for s, d in load_runs(out_dir, name).items():
                    out["pose_matches"][f"{name}_{s}.json"] = dict(zip(
                        ("matching", "of", "first_mismatch"),
                        pose_matches(trajectories(d), walks)))
    if glob.glob(os.path.join(out_dir, "weights", "epoch_*_vis.msgpack")):
        out["vis_change"] = vis_change(trained_vis(out_dir))
    epochs = []
    for log in sorted(glob.glob(os.path.join(out_dir, "logs", "train*.log"))):
        with open(log) as f:
            epochs += [{"epoch": int(m.group(1)), "seconds": float(m.group(2)),
                        "losses": m.group(3)} for m in re.finditer(
                r"epoch (\d+) done in ([\d.]+)s: (\{.*\})", f.read())]
    if epochs:
        out["train_epochs"] = sorted(epochs, key=lambda e: e["epoch"])
    with open(os.path.join(out_dir, "rows.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run", default=None,
                        help="comma-separated: train, " + ", ".join(ROWS))
    parser.add_argument("--out-dir", default="results/suite_rows")
    parser.add_argument("--summarize", action="store_true",
                        help="only summarize the results in --out-dir")
    args = parser.parse_args(argv)
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    if not args.summarize:
        rows = args.run.split(",") if args.run else ["train", *ROWS]
        unknown = set(rows) - {"train", *ROWS}
        if unknown:
            parser.error(f"unknown rows {sorted(unknown)}")
        from .synthetic_suite import generate_suite

        generate_suite(os.path.join(REPO_DIR, SUITE))
        run(rows, out_dir)
    print(json.dumps(summarize(out_dir), indent=1))


if __name__ == "__main__":
    main()
