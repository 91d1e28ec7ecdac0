"""CLI: SCONE NBV evaluation on ShapeNet.

Usage: python -m macarons_tpu_torch.test_shapenet
       [-c configs/test/test_on_shapenet_seen_categories_config.json]
       [--data-path DIR] [--weights-dir DIR] [--results-dir DIR]
       [--device cuda|cpu]

Reads the same test configs as the JAX package's test_shapenet.py (its own
schema or the reference's, with the training config they name). The
config's relative ``occ_weights_path`` and ``vis_weights_path`` are read
under --weights-dir (default: the repository); the results JSON is the JAX
package's, in --results-dir (default results/shapenet_reconstruction).
"""

import argparse
import os

from .config import load_params, normalize_test_config
from .testers.shapenet import run_test

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SCONE NBV evaluation on ShapeNet.")
    parser.add_argument("-c", "--config", default=os.path.join(
        REPO_DIR, "configs/test/test_on_shapenet_seen_categories_config.json"))
    parser.add_argument("--data-path", default=None,
                        help="ShapeNet root (default: the config's)")
    parser.add_argument("--weights-dir", default=REPO_DIR)
    parser.add_argument("--results-dir", default=os.path.join(
        REPO_DIR, "results/shapenet_reconstruction"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    params = normalize_test_config(load_params(args.config), REPO_DIR)
    if params.get("training_config") is not None:
        train_params = load_params(os.path.join(REPO_DIR,
                                                params.training_config))
        train_params.update(params.to_dict())
        params = train_params

    def weights(key):
        p = params.get(key)
        return None if p is None else os.path.join(args.weights_dir, p)

    run_test(params, data_path=args.data_path,
             occ_weights_path=weights("occ_weights_path"),
             vis_weights_path=weights("vis_weights_path"),
             test_novel=params.get("test_novel", False),
             results_dir=args.results_dir,
             max_meshes=params.get("max_meshes"),
             results_name=params.get("results_name"), device=args.device)


if __name__ == "__main__":
    main()
