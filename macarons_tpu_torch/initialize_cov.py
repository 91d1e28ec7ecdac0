"""CLI: pretrain SconeVis, SCONE's coverage-gain module, on ShapeNet GT
with a frozen pretrained SconeOcc.

Usage: python -m macarons_tpu_torch.initialize_cov
       [-c configs/scone/coverage_gain/coverage_gain_pretraining_config.json]
       [--data-path DIR] [--weights-dir DIR] [--device cuda|cpu]

SconeOcc's weights are ``weights/scone/occupancy/<scone_occ_model_name>``
under the repository (the port's ``.pt`` or the JAX package's
``.msgpack``; random weights if there are none), as the JAX package's
initialize_cov.py reads them. Writes
``<weights-dir>/{unvalidated,best_unval}_<scone_vis_model_name>.{pt,json}``.

On CUDA it trains data-parallel over every visible card, one process per
card (NCCL), at a global batch of ``batch_size`` x cards, as the JAX
package's pretrainer takes every device; on one card, or the CPU, in one
process. Under ``torchrun --nproc_per_node N`` each process is a rank.
"""

import argparse
import os

from .config import load_params
from .parallel import distributed
from .trainers.pretrain_vis import run_training

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Pretrain the SconeVis coverage-gain module.")
    parser.add_argument("-c", "--config", default=os.path.join(
        REPO_DIR,
        "configs/scone/coverage_gain/coverage_gain_pretraining_config.json"))
    parser.add_argument("--data-path", default=None,
                        help="ShapeNet root (default: the config's)")
    parser.add_argument("--weights-dir", default=os.path.join(
        REPO_DIR, "weights/scone/coverage_gain"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    distributed.launch(train, (args.config, args.data_path, args.weights_dir,
                               args.device), device=args.device)


def train(config, data_path, weights_dir, device):
    """One rank's run (or the only one)."""
    params = load_params(config)
    occ_name = params.get("scone_occ_model_name",
                          "best_unval_pretrained_scone_occ")
    occ_path = os.path.join(REPO_DIR, "weights/scone/occupancy",
                            occ_name.replace(".pth", ""))
    run_training(params, data_path=data_path, weights_dir=weights_dir,
                 occ_weights_path=occ_path, device=device)


if __name__ == "__main__":
    main()
