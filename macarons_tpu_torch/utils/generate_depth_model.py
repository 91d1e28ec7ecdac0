"""CLI: build and save an initial depth model, optionally grafting a
torchvision resnet18 state dict (ImageNet weights) into it (port of
weights_tools/generate_depth_model.py).

Usage: python -m macarons_tpu_torch.utils.generate_depth_model
       [-r resnet18_state_dict.pth] [-o weights/macarons/initial_depth]
       [--height 256] [--width 456] [--device cuda|cpu]

Writes ``<out>.pt`` (ManyDepth's state dict, as utils.checkpoint writes a
module) and ``<out>.json`` (``{"source": <state dict path or "random">}``).
``python -m macarons_tpu_torch.utils.generate_macarons_model -d <out>``
grafts it into a MACARONS checkpoint.
"""

import argparse
import os

import torch

from ..models.macarons import init_depth_weights
from ..models.many_depth import ManyDepth
from ..models.resnet import convert_torch_resnet18
from .checkpoint import save_checkpoint
from .device import make_generator, resolve_device

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def graft_resnet(model: ManyDepth, converted) -> ManyDepth:
    """Load ``convert_torch_resnet18``'s state dicts into the depth network:
    the feature extractor's stem and layer 1, and the contraction layers
    2-4 each where every shape agrees with torchvision's (a layer whose
    shapes differ keeps its weights)."""
    dd = model.depth_decoder
    dd.feature_extractor.stem.load_state_dict(converted["stem"])
    dd.feature_extractor.layer1.load_state_dict(converted["layer1"])
    for name, src in (("resnet_layer_2", "layer2"),
                      ("resnet_layer_3", "layer3"),
                      ("resnet_layer_4", "layer4")):
        layer = getattr(dd, name)
        own = layer.state_dict()
        if all(own[k].shape == v.shape for k, v in converted[src].items()):
            layer.load_state_dict(converted[src])
        else:
            print(f"skipping {name}: channel mismatch with torchvision {src}")
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Build an initial depth model, optionally with "
        "torchvision resnet18 weights.")
    parser.add_argument("-r", "--resnet", default=None,
                        help="Path to a torch resnet18 state dict (.pth).")
    parser.add_argument("-o", "--output", default=os.path.join(
        REPO_DIR, "weights", "macarons", "initial_depth"))
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=456)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    model = init_depth_weights(
        ManyDepth(input_height=args.height, input_width=args.width).to(dev),
        make_generator(dev, 0))
    if args.resnet:
        sd = torch.load(args.resnet, map_location="cpu")
        graft_resnet(model, {k: {n: t.to(dev) for n, t in v.items()}
                             for k, v in convert_torch_resnet18(sd).items()})
        print("grafted torchvision resnet18 weights")
    save_checkpoint(args.output, model, {"source": args.resnet or "random"})
    print("saved depth model to", args.output)


if __name__ == "__main__":
    main()
