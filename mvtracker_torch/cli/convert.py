"""Checkpoint conversion CLI, counterpart of `python -m mvtracker_tpu.cli.convert`.

    python -m mvtracker_torch.cli.convert reference.pth converted.msgpack

Converts a reference torch checkpoint (the released
`mvtracker_200000_june2025.pth`, a raw state dict or a training checkpoint
with the model under "model"; a port checkpoint too, whose names are the
reference's) into the flax msgpack params file the JAX package's
`cli.convert` writes for it, byte for byte: `convert.load_reference_checkpoint`
maps it to the flax tree, and `convert.save_flax_msgpack` writes it in the
tree's order, as `flax.serialization.to_bytes` does. Neither JAX nor flax nor
msgpack is needed.

The JAX module's `load_converted(path, model, example_args)` has its
counterpart in `convert.load_release(path, model)`, which loads such a file
into a port model strictly.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("input", help="torch .pth checkpoint")
    parser.add_argument("output", help="output .msgpack params file")
    return parser


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def main(argv=None):
    args = build_parser().parse_args(argv)

    from mvtracker_torch.convert import load_reference_checkpoint, save_flax_msgpack

    params = load_reference_checkpoint(args.input)
    save_flax_msgpack(params, args.output, sort_keys=False)
    n = sum(p.size for p in _leaves(params))
    print(f"converted {n:,} parameters -> {args.output}")
    return params


if __name__ == "__main__":
    main()
