"""CLI: MACARONS online self-supervised training on the GPU.

Usage: python -m macarons_tpu_torch.train -c configs/macarons/macarons_default_training_config.json
       [--weights-dir DIR] [--memory-root DIR] [--device cuda|cpu]

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
"""

import argparse
import os

import torch

from .config import load_params
from .parallel import distributed
from .trainers.train_macarons import group_ranks, run_training

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
    args = parser.parse_args(argv)
    params = load_params(args.config)
    cards = (torch.cuda.device_count() if torch.device(args.device).type
             == "cuda" and torch.cuda.is_available() else 1)
    distributed.launch(train, (args.config, args.weights_dir or os.path.join(
        REPO_DIR, "weights/macarons"), args.memory_root, args.device),
        device=args.device, n_ranks=group_ranks(params, cards))


def train(config, weights_dir, memory_root, device):
    """One rank's run (or the only one)."""
    run_training(load_params(config), weights_dir=weights_dir,
                 memory_root=memory_root, device=device)


if __name__ == "__main__":
    main()
