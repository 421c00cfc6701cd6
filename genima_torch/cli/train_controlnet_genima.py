"""ControlNet fine-tune CLI (SD-turbo), with the reference's flag names.

    python -m genima_torch.cli.train_controlnet_genima --data_path DIR --tasks TASK \
        --enable_xformers_memory_efficient_attention [--device cpu] ...
"""

from __future__ import annotations

import sys

from genima_torch.cli._diffusion_args import build_parser
from genima_torch.diffusion.driver import run_training


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None) -> dict:
    return run_training(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
