"""2x2 camera tiling / untiling, NHWC, as tensor reshapes.

Counterpart of ``genima_tpu/data/tiling.py``. Quadrant order is camera
order: [top-left, top-right, bottom-left, bottom-right].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _grid_perm(n_lead: int) -> list[int]:
    # (..., a, b, c, d, ch) -> (..., a, c, b, d, ch)
    return list(range(n_lead)) + [n_lead, n_lead + 2, n_lead + 1, n_lead + 3, n_lead + 4]


def tile_images(views: torch.Tensor) -> torch.Tensor:
    """(..., 4, H, W, C) -> (..., 2H, 2W, C), quadrants [TL, TR, BL, BR]."""
    *lead, four, h, w, c = views.shape
    if four != 4:
        raise ValueError(f"tile_images expects 4 views, got {four}")
    grid = views.reshape(*lead, 2, 2, h, w, c).permute(_grid_perm(len(lead)))
    return grid.reshape(*lead, 2 * h, 2 * w, c)


def untile_images(tiled: torch.Tensor) -> torch.Tensor:
    """(..., 2H, 2W, C) -> (..., 4, H, W, C), inverse of ``tile_images``."""
    *lead, hh, ww, c = tiled.shape
    h, w = hh // 2, ww // 2
    grid = tiled.reshape(*lead, 2, h, 2, w, c).permute(_grid_perm(len(lead)))
    return grid.reshape(*lead, 4, h, w, c)


def _resize(images: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="linear", antialias=downscale)`` on the two
    spatial axes of float (..., H, W, C): half-pixel centres, a triangle
    filter widened by the scale when shrinking, and the weights of taps
    outside the image dropped and the rest renormalised. PyTorch's bilinear
    resize with ``antialias=True`` builds those weights (upscaling: the
    clamped source index gives the same edge weights)."""
    *lead, h, w, c = images.shape
    x = images.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                      antialias=size[0] < h or size[1] < w)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def resize_half(images: torch.Tensor) -> torch.Tensor:
    """Antialiased bilinear 2x downscale of float (..., H, W, C)."""
    h, w = images.shape[-3:-1]
    return _resize(images, (h // 2, w // 2))


def untile_to_cameras(tiled: torch.Tensor, target_size: int = 256) -> torch.Tensor:
    """Generated tile -> per-camera controller inputs, (..., 4, S, S, C).
    Quadrants are resized (antialiased when shrinking) only when they are
    not already ``target_size``."""
    views = untile_images(tiled)
    if views.shape[-3] != target_size:
        views = _resize(views, (target_size, target_size))
    return views


def denormalize_to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, round half to even (as ``jnp.round``)."""
    x = torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)
