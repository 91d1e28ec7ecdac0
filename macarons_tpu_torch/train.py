"""CLI: MACARONS online self-supervised training on the GPU.

Usage: python -m macarons_tpu_torch.train -c configs/macarons/macarons_default_training_config.json
       [--weights-dir DIR] [--memory-root DIR] [--device cuda|cpu]
       [--restart-per-epoch]

Reads the same training configs as the JAX package's train.py and writes
checkpoints ``<weights-dir>/{unvalidated,best_unval,coverage_validated,
epoch_<e>}_<name>.{pt,json}`` and ``losses_data_<name>.json``; the replay
memory goes under ``<memory-root>/<scene>/<memory_dir_name>/``.

With ``n_parallel_scenes`` > 1 on CUDA, each scene group spreads over
``group_ranks`` cards (the pinned ``n_devices``, else the largest divisor
of the group within the visible cards), one process per card (NCCL),
as the JAX package shards the group over its mesh. Either replay memory
works there: with the device memory (the default) every card holds every
scene's slots, and the cards exchange the slots they captured at each
epoch's end. Under ``torchrun --nproc_per_node N`` each process is a
rank.

``--restart-per-epoch`` trains each epoch in a fresh child process (each
launched as above, so a scene group over several cards restarts whole),
resumed from ``unvalidated_<name>``; the parent only starts the children
and never touches a card. Epoch e draws from streams seeded by e, so the
run equals one process's. Every epoch hands its process's device memory
back (the caching allocator's reserve included).
"""

import argparse
import json
import os
import subprocess
import sys

import torch

from .config import load_params
from .parallel import distributed
from .trainers.train_macarons import group_ranks, run_training
from .utils.checkpoint import checkpoint_exists

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train MACARONS online.")
    parser.add_argument("-c", "--config", default=os.path.join(
        REPO_DIR, "configs/macarons/macarons_default_training_config.json"))
    parser.add_argument("--weights-dir", default=None,
                        help="checkpoint directory (default weights/macarons)")
    parser.add_argument("--memory-root", default=None,
                        help="replay memory root (default: the data path)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--restart-per-epoch", action="store_true",
                        help="train each epoch in a fresh process (the same "
                        "result as one process)")
    parser.add_argument("--epoch-child", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--fresh", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    params = load_params(args.config)
    weights_dir = args.weights_dir or os.path.join(REPO_DIR,
                                                   "weights/macarons")
    resume = os.path.join(weights_dir, "unvalidated_"
                          + params.get("macarons_model_name", "macarons"))
    if (args.restart_per_epoch and not args.epoch_child
            and params.get("epochs", 1) > 1):
        restart_per_epoch(args, params, weights_dir, resume)
        return
    overrides = {}
    if args.epoch_child:
        overrides["max_epochs_per_process"] = 1
        if not args.fresh and checkpoint_exists(resume):
            overrides["start_from_scratch"] = False
    cards = (torch.cuda.device_count() if torch.device(args.device).type
             == "cuda" and torch.cuda.is_available() else 1)
    distributed.launch(train, (args.config, weights_dir, args.memory_root,
                               args.device, overrides),
                       device=args.device, n_ranks=group_ranks(params, cards))


def restart_per_epoch(args, params, weights_dir: str, resume: str):
    """Start one child process per epoch (``--epoch-child``: one epoch,
    resumed unless it is the run's first) until ``<resume>.json`` records
    the config's epochs. A child that fails, or trains no epoch, ends this
    process with an error."""
    total = int(params.get("epochs", 1))
    fresh = params.get("start_from_scratch", True)
    cmd = [sys.executable, "-m", "macarons_tpu_torch.train", "-c",
           args.config, "--weights-dir", weights_dir, "--device", args.device,
           "--epoch-child"]
    if args.memory_root:
        cmd += ["--memory-root", args.memory_root]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_DIR, os.environ.get("PYTHONPATH")) if p))

    def epochs_done():
        if fresh or not os.path.exists(resume + ".json"):
            return 0
        with open(resume + ".json") as f:
            return int(json.load(f).get("epoch", 0))

    done = epochs_done()
    while done < total:
        ret = subprocess.run(cmd + (["--fresh"] if fresh else []),
                             env=env).returncode
        if ret != 0:
            raise SystemExit(ret)
        fresh = False
        before, done = done, epochs_done()
        if done <= before:
            raise SystemExit(f"an epoch process ended at epoch {done}, "
                             f"where it started")


def train(config, weights_dir, memory_root, device, overrides=None):
    """One rank's run (or the only one)."""
    params = load_params(config)
    params.update(overrides or {})
    run_training(params, weights_dir=weights_dir, memory_root=memory_root,
                 device=device)


if __name__ == "__main__":
    main()
