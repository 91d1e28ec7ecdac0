"""CLI: pretrain SconeOcc, SCONE's occupancy module, on ShapeNet GT.

Usage: python -m macarons_tpu_torch.initialize_occ
       [-c configs/scone/occupancy/occupancy_pretraining_config.json]
       [--data-path DIR] [--weights-dir DIR] [--device cuda|cpu]

Reads the JAX package's pretraining configs; the data path holds the
ShapeNet split files and each model's ``tensors/`` (see
``python -m macarons_tpu_torch.data.generate_shapenet_data``). Writes
``<weights-dir>/{unvalidated,best_unval}_<scone_occ_model_name>.{pt,json}``.

On CUDA it trains data-parallel over every visible card, one process per
card (NCCL), at a global batch of ``batch_size`` x cards, as the JAX
package's pretrainer takes every device; on one card, or the CPU, in one
process. Under ``torchrun --nproc_per_node N`` each process is a rank.
"""

import argparse
import os

from .config import load_params
from .parallel import distributed
from .trainers.pretrain_occ import run_training

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Pretrain the SconeOcc occupancy-probability module.")
    parser.add_argument("-c", "--config", default=os.path.join(
        REPO_DIR, "configs/scone/occupancy/occupancy_pretraining_config.json"))
    parser.add_argument("--data-path", default=None,
                        help="ShapeNet root (default: the config's)")
    parser.add_argument("--weights-dir", default=os.path.join(
        REPO_DIR, "weights/scone/occupancy"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    distributed.launch(train, (args.config, args.data_path, args.weights_dir,
                               args.device), device=args.device)


def train(config, data_path, weights_dir, device):
    """One rank's run (or the only one)."""
    run_training(load_params(config), data_path=data_path,
                 weights_dir=weights_dir, device=device)


if __name__ == "__main__":
    main()
