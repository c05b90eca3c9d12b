"""Offline checkpoint converter, on PyTorch and numpy: the flags of
``heuristique_style_transfer_code_tpu/cli/convert_checkpoint.py``, both
directions of the reference's checkpoint ecosystem.

reference .pth -> the flat-key .npz both packages read:
    python -m heuristique_style_transfer_code_tpu_torch.cli.convert_checkpoint \\
        --family truncated_resnet50 --input best_global_model.pth \\
        --output best_global_model.npz [--config cfg.json]

.npz -> reference .pth (--to pth): the reference's exact torch layouts
(family-1 nested {moco_model_state_dict, classifier_state_dict}, family-2
{truncated_encoder, classifier, attention} component dicts, family-3 flat
MultiScaleDiscriminator state_dicts):
    python -m heuristique_style_transfer_code_tpu_torch.cli.convert_checkpoint \\
        --family truncated_resnet50 --input best_global_model.npz \\
        --output best_global_model.pth --to pth

Families: truncated_resnet50 | gram_attention | multi_patchgan |
multi_patchgan_test (the PatchGAN families need --config for
patch_sizes/ndf/norm). Orbax checkpoints, in or out, are not ported yet.
"""
from __future__ import annotations

import argparse
import json


def build_parser():
    parser = argparse.ArgumentParser(
        description="Convert checkpoints between the reference's .pth layouts and .npz")
    parser.add_argument(
        "--family", required=True,
        choices=["truncated_resnet50", "gram_attention", "multi_patchgan",
                 "multi_patchgan_test"],
    )
    parser.add_argument("--input", required=True, help="source checkpoint (.pth or .npz)")
    parser.add_argument("--output", required=True, help="destination path")
    parser.add_argument("--config", help="hyperparameter JSON (patch_sizes/ndf/norm)")
    parser.add_argument(
        "--to", choices=["npz", "orbax", "pth"], default=None,
        help="target format (default: inferred from --output suffix, npz otherwise)",
    )
    # the JAX CLI's legacy spelling
    parser.add_argument("--format", choices=["npz", "orbax"], default=None,
                        help=argparse.SUPPRESS)
    return parser


def _load_native(path: str):
    if not path.endswith(".npz"):
        raise NotImplementedError(f"{path}: orbax checkpoints are not ported yet (.npz only)")
    from ..checkpoint.io import load_pytree_npz

    return load_pytree_npz(path)


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = {}
    if args.config:
        with open(args.config) as f:
            config = json.load(f)

    target = args.to or args.format
    if target is None:
        if args.output.endswith((".pth", ".pt")):
            target = "pth"
        elif args.output.endswith(".orbax"):
            target = "orbax"
        else:
            target = "npz"
    if target == "orbax":
        raise NotImplementedError("--to orbax is not ported yet (npz, pth)")

    from ._common import count_params

    if target == "pth":
        from ..checkpoint.pth_exporter import export_checkpoint_tree, save_pth

        if args.input.endswith((".pth", ".pt")):
            raise ValueError("--to pth expects a native .npz/orbax input")
        tree = _load_native(args.input)
        n = count_params(tree)
        save_pth(export_checkpoint_tree(tree, args.family, config), args.output)
    else:
        if args.input.endswith((".pth", ".pt")):
            from ._common import load_checkpoint_tree

            tree = load_checkpoint_tree(args.input, args.family, config)
        else:
            tree = _load_native(args.input)
        n = count_params(tree)
        from ..checkpoint.io import save_pytree_npz

        save_pytree_npz(tree, args.output)

    print(f"Converted {args.input} -> {args.output} ({n} parameters)")


if __name__ == "__main__":
    main()
