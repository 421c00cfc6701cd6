"""Compositing rendered spheres onto backgrounds, as tensor ops.

Counterpart of ``genima_tpu/rendering/compositor.py``. The reference
composites on host numpy (``render/render_data.py:282-311``):

* *rgb_rendered* (full context): white render pixels <- original RGB,
* *rnd_bg* (random context): white <- a random texture image; sphere pixels
  alpha-blended with the texture, blend ~ U(alpha_blend, 1.0).

The renderer returns an exact hit mask, so compositing is a masked select
or lerp. Every argument may carry leading frame axes; ``blend`` is one
value per frame, shaped to broadcast against the (..., H, W, 3) images.
"""

from __future__ import annotations

import torch


def composite_rgb_rendered(
    render: torch.Tensor,  # (..., H, W, 3) [0, 1], white bg
    hit_mask: torch.Tensor,  # (..., H, W) bool
    rgb: torch.Tensor,  # (..., H, W, 3) [0, 1] original observation
) -> torch.Tensor:
    return torch.where(hit_mask[..., None], render, rgb)


def composite_rnd_bg(
    render: torch.Tensor,
    hit_mask: torch.Tensor,
    texture: torch.Tensor,  # (..., H, W, 3) [0, 1] random background texture
    blend: torch.Tensor,  # in [alpha_blend, 1]: a scalar, or (..., 1, 1, 1)
) -> torch.Tensor:
    blended = render * blend + texture * (1.0 - blend)
    return torch.where(hit_mask[..., None], blended, texture)
