"""CLI: MACARONS online self-supervised training on the GPU.

Usage: python -m macarons_tpu_torch.train -c configs/macarons/macarons_default_training_config.json
       [--weights-dir DIR] [--memory-root DIR] [--device cuda|cpu]

Reads the same training configs as the JAX package's train.py and writes
checkpoints ``<weights-dir>/{unvalidated,best_unval,coverage_validated,
epoch_<e>}_<name>.{pt,json}`` and ``losses_data_<name>.json``; the replay
memory goes under ``<memory-root>/<scene>/<memory_dir_name>/``.
"""

import argparse
import os

from .config import load_params
from .trainers.train_macarons import run_training

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
    run_training(params, weights_dir=args.weights_dir or os.path.join(
        REPO_DIR, "weights/macarons"), memory_root=args.memory_root,
        device=args.device)


if __name__ == "__main__":
    main()
