"""CLI: assemble a MACARONS checkpoint from the pretrained module
checkpoints, for the trainer's ``pretrained_model_path``.

Usage: python -m macarons_tpu_torch.utils.generate_macarons_model
       [-o weights/scone/occupancy/best_unval_pretrained_scone_occ]
       [-c weights/scone/coverage_gain/best_unval_pretrained_scone_vis]
       [-d DEPTH_CHECKPOINT] [--out weights/macarons/initialized_macarons]
       [--config configs/macarons/macarons_default_training_config.json]
       [--device cuda|cpu]

Each module checkpoint may be the port's (``.pt``) or the JAX package's
(``.msgpack``). The depth checkpoint is a port MACARONS checkpoint
(``.pt``), whose depth network is grafted, or the JAX package's depth
variables (``.msgpack``, as weights_tools/generate_depth_model.py writes
them). Modules without a checkpoint keep the trainer's
seeded initialisation. Writes ``<out>.pt`` and ``<out>.json``, which
``python -m macarons_tpu_torch.train`` loads with ``pretrained: true``.
"""

import argparse
import os

from ..config import load_params
from ..models.macarons import (
    create_macarons_model,
    init_macarons_weights,
    load_macarons,
    save_macarons,
)
from ..trainers.train_macarons import seeded_generator
from .checkpoint import checkpoint_exists, load_checkpoint
from .convert import flax_to_torch, read_msgpack
from .device import resolve_device

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def assemble(params, occ_ckpt=None, vis_ckpt=None, depth_ckpt=None,
             out=None, device="cuda"):
    """The trainer's model with the module checkpoints that exist loaded,
    saved to ``out`` if given. Returns the model."""
    dev = resolve_device(device)
    model = create_macarons_model(params, dev)
    init_macarons_weights(model, seeded_generator(
        dev, params.get("torch_seed", 5)))
    for path, net in ((occ_ckpt, model.occ), (vis_ckpt, model.vis)):
        if path and checkpoint_exists(path):
            load_checkpoint(path, net)
    if depth_ckpt and model.depth is not None:
        if os.path.exists(depth_ckpt + ".pt"):
            donor = create_macarons_model(params, dev)
            load_macarons(depth_ckpt, donor)
            model.depth.load_state_dict(donor.depth.state_dict())
        else:
            state = flax_to_torch(read_msgpack(depth_ckpt))
            model.depth.load_state_dict({k: v.to(dev)
                                         for k, v in state.items()})
    if out:
        save_macarons(out, model, {"occ_ckpt": occ_ckpt,
                                   "vis_ckpt": vis_ckpt,
                                   "depth_ckpt": depth_ckpt})
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Assemble a MACARONS checkpoint from module checkpoints.")
    parser.add_argument("-o", "--occupancy", default=os.path.join(
        REPO_DIR, "weights/scone/occupancy/best_unval_pretrained_scone_occ"))
    parser.add_argument("-c", "--coverage_gain", default=os.path.join(
        REPO_DIR,
        "weights/scone/coverage_gain/best_unval_pretrained_scone_vis"))
    parser.add_argument("-d", "--depth", default=None,
                        help="MACARONS checkpoint whose depth network to "
                        "graft")
    parser.add_argument("--out", default=os.path.join(
        REPO_DIR, "weights/macarons/initialized_macarons"))
    parser.add_argument("--config", default=os.path.join(
        REPO_DIR, "configs/macarons/macarons_default_training_config.json"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    assemble(load_params(args.config), args.occupancy, args.coverage_gain,
             args.depth, args.out, args.device)
    print("saved assembled MACARONS model to", args.out)


if __name__ == "__main__":
    main()
