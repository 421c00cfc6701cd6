"""Dataset rendering CLI, hydra-style ``key=value`` overrides:

    python -m genima_torch.cli.render_data dataset_root=/data/rlbench \\
        task=take_lid_off_saucepan episodes=100 [device=cpu]

Counterpart of ``genima_tpu/cli/render_data.py`` (reference
``render/render_data.py:436-453``); its defaults are
``genima_torch.core.config.RENDER``. ``device=`` picks where the spheres
are drawn: the card (``cuda``, the default) or ``cpu``. It is not part of
the render config, so the config snapshot in the output trees is the JAX
package's.
"""

from __future__ import annotations

import sys
import time

from genima_torch.core.config import RENDER, build_config, load_yaml, parse_cli


def main(argv=None) -> None:
    overrides, flags = parse_cli(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    rest = []
    for o in overrides:
        if o.startswith("device="):
            device = o.split("=", 1)[1]
        else:
            rest.append(o)
    defaults = load_yaml(flags["config_name"]) if "config_name" in flags else RENDER
    cfg = build_config(defaults, rest)
    from genima_torch.rendering.render_data import RenderData

    t0 = time.time()
    RenderData(cfg.to_dict(), device=device).generate()
    print(f"Total time: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
