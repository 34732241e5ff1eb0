"""Export a port experiment's newest checkpoint (`<exp_dir>/checkpoints/step_<n>.pt`)
as the flax msgpack params file that `scripts/export_params_msgpack.py`
writes for a JAX experiment, for cross-architecture warm starts through
`Trainer.warm_start`'s non-strict merge (e.g. a medium model's weights into a
vis_geom-extended one). The PyTorch counterpart of that script: the same
arguments and printed line, plus `--device` (default cuda). The file is the
JAX layout (`convert.convert_reference_state_dict`) written with keys sorted,
as `flax.serialization.msgpack_serialize` writes it; neither JAX nor flax is
needed.

    python scripts/export_params_msgpack_torch.py --exp_dir experiments/r2_medium_tex \
        --model_size medium --out /tmp/r2_medium.msgpack
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--model_size", choices=["small", "medium", "flagship"], default="medium")
    p.add_argument("--out", required=True)
    p.add_argument("--res", type=int, default=64,
                   help="kept for the JAX script's command lines; the port's model needs no example scene to build")
    p.add_argument("--vis_geom", action="store_true", help="checkpoint was trained with vis_geom_features")
    p.add_argument("--vis_head_hidden", type=int, default=0,
                   help="checkpoint's vis-head hidden width (0 = linear head)")
    p.add_argument("--corr_k0", type=int, default=0,
                   help="finest-level neighbor count the checkpoint was trained with (0 = uniform preset k)")
    p.add_argument("--dtype", choices=["float32", "bfloat16", "float16"], default="float32",
                   help="cast exported params (bfloat16 halves artifact size; warm_start casts back to the "
                        "train dtype on load)")
    p.add_argument("--device", default="cuda", help="torch device the checkpoint is restored onto")
    return p


def cast_leaves(tree: dict, dtype: str) -> dict:
    """Every floating leaf of a numpy params tree cast to `dtype`; bfloat16
    leaves become torch tensors, which the encoder writes as flax does."""
    import numpy as np
    import torch

    def cast(x):
        if not np.issubdtype(x.dtype, np.floating):
            return x
        if dtype == "bfloat16":
            return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16)
        return x.astype(np.dtype(dtype))

    return {k: cast_leaves(v, dtype) if isinstance(v, dict) else cast(v) for k, v in tree.items()}


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from mvtracker_torch import convert
    from mvtracker_torch.presets import build_model
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    model = build_model(args.model_size, vis_geom=args.vis_geom, vis_head_hidden=args.vis_head_hidden,
                        corr_k0=args.corr_k0, device=args.device)
    trainer = Trainer(model, TrainConfig(exp_dir=args.exp_dir, tensorboard=False, watchdog_timeout_s=0))
    state = step_lib.init_state(model, trainer.optimizer)
    state, step = trainer.restore_latest(state)
    assert step > 0, f"no checkpoint in {args.exp_dir}"
    params = cast_leaves(convert.convert_reference_state_dict(state.model.state_dict()), args.dtype)
    convert.save_flax_msgpack(params, args.out)
    print(f"exported step-{step} params ({args.dtype}) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
