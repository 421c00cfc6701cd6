"""The trainers' image augmentations, on NHWC float tensors.

Counterpart of ``genima_tpu/data/augment.py``'s two recipes and the ops
they use. ``controlnet_train_augment`` (the reference's ``augment_data``):
colour jitter, elastic and blur on the conditioning image only; one affine
transform, the same for image and conditioning; one reflect-pad-2 random
crop of the pair. ``act_train_augment`` (the ACT policy's train-time
transforms) on [0, 255] images: each of elastic (alpha 80, sigma 10),
colour jitter and a zero-pad-4 random crop applied with probability 1/2
(one decision for the whole batch, ``random_apply``), then gaussian noise
of std 5.

Each op takes its random parameters as tensors and draws nothing:
``sample_controlnet_augment_draws`` draws them from a ``torch.Generator`` in
the JAX package's shapes and ranges, and tests hand both packages the same
numbers. The JAX recipe's quirks are its semantics here too: the affine
transform's ``tx`` and ``ty`` come from one uniform draw (the JAX code draws
both from one key), scaled by ``w`` and by ``h``.

``bilinear_sample`` is the JAX package's gather (clamp to the edge before
the floor, or a constant fill outside), not ``grid_sample``, whose edge
handling differs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

JITTER = (0.2, 0.2, 0.1, 0.05)  # brightness, contrast, saturation, hue
ELASTIC = (80.0, 10.0)  # alpha, sigma
BLUR_KERNEL, BLUR_SIGMA = 3, (0.1, 2.0)
AFFINE_DEGREES, AFFINE_TRANSLATE, AFFINE_SCALE = (0.0, 10.0), (0.1, 0.1), (0.9, 1.1)
CROP_PAD = 2
ACT_CROP_PAD, ACT_NOISE_STD, ACT_APPLY_P = 4, 5.0, 0.5


# -- colour jitter ------------------------------------------------------------------


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), torch.zeros_like(maxc))
    d = torch.clamp(delta, min=1e-8)
    rc, gc, bc = (maxc - r) / d, (maxc - g) / d, (maxc - b) / d
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(opts):
        out = opts[0]
        for idx in range(1, 6):
            out = torch.where(i == idx, opts[idx], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def color_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter on (B, H, W, 3) in [0, 1]; ``factors`` is
    (brightness, contrast, saturation) multipliers and the hue shift."""
    b, c, s, hue = factors.unbind(0)
    x = images * b
    mean = x.mean(dim=(-1, -2, -3), keepdim=True)
    x = torch.clamp((x - mean) * c + mean, 0.0, 1.0)
    h, sat, v = _rgb_to_hsv(x).unbind(-1)
    sat = torch.clamp(sat * s, 0.0, 1.0)
    h = torch.remainder(h + hue, 1.0)
    return torch.clamp(_hsv_to_rgb(torch.stack([h, sat, v], dim=-1)), 0.0, 1.0)


# -- gaussian filtering ---------------------------------------------------------------


def _gaussian_kernel1d(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _reflect_index(n: int, radius: int, device) -> torch.Tensor:
    """Source indices of numpy's "reflect" padding by ``radius`` on both
    sides of a length-``n`` axis (repeated reflection when radius >= n)."""
    idx = torch.arange(-radius, n + radius, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _separable_filter(images: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Reflect pad, then two VALID 1-D convolutions, over (B, H, W, C)."""
    b, h, w, c = images.shape
    radius = (k.shape[0] - 1) // 2
    x = images.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = x.index_select(2, _reflect_index(h, radius, x.device))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = x.index_select(3, _reflect_index(w, radius, x.device))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor,
                  kernel_size: int = BLUR_KERNEL) -> torch.Tensor:
    """Separable gaussian blur of (B, H, W, C) with the drawn ``sigma``."""
    return _separable_filter(images, _gaussian_kernel1d(sigma, kernel_size // 2))


# -- bilinear warping ----------------------------------------------------------------


def bilinear_sample(images: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
                    cval: Optional[float] = None) -> torch.Tensor:
    """Resample (B, H, W, C) at one (H, W) grid of source coordinates.
    ``cval=None`` clamps to the edge (the clamp comes before the floor, so a
    coordinate in (-1, 0) reads row 0 only); a float fills outside the
    image with it."""
    b, h, w, c = images.shape
    if cval is None:
        src_y = torch.clamp(src_y, 0.0, h - 1)
        src_x = torch.clamp(src_x, 0.0, w - 1)
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy = (src_y - y0f)[None, :, :, None]
    wx = (src_x - x0f)[None, :, :, None]
    y0 = torch.clamp(y0f.to(torch.long), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(x0f.to(torch.long), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)

    def g(yi, xi):
        return images[:, yi, xi, :]

    out = ((1 - wy) * (1 - wx) * g(y0, x0) + (1 - wy) * wx * g(y0, x1)
           + wy * (1 - wx) * g(y1, x0) + wy * wx * g(y1, x1))
    if cval is not None:
        inside = ((src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1))
        out = torch.where(inside[None, :, :, None], out, torch.full_like(out, cval))
    return out.to(images.dtype)


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def elastic_transform(images: torch.Tensor, noise: torch.Tensor, alpha: float = ELASTIC[0],
                      sigma: float = ELASTIC[1]) -> torch.Tensor:
    """torchvision ElasticTransform: ``noise`` (2, H, W) uniform in [-1, 1]
    (dx, dy), gaussian-smoothed, scaled by alpha / size, one field for the
    batch."""
    b, h, w, c = images.shape
    radius = int(2 * sigma) | 1
    k = _gaussian_kernel1d(torch.tensor(sigma, dtype=torch.float32, device=images.device), radius)
    dx = _separable_filter(noise[0][None, :, :, None], k)[0, ..., 0] * (alpha / w)
    dy = _separable_filter(noise[1][None, :, :, None], k)[0, ..., 0] * (alpha / h)
    yy, xx = _grid(h, w, images.device)
    return bilinear_sample(images, yy + dy * h / 2.0, xx + dx * w / 2.0)


def random_affine(images: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Rotation about the centre, translation and scale, zero fill outside;
    ``params`` is (angle in degrees, tx and ty as fractions of the width
    and height, scale)."""
    b, h, w, c = images.shape
    angle_deg, tx, ty, sc = params.unbind(0)
    angle = torch.deg2rad(angle_deg)
    tx, ty = tx * w, ty * h
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(angle) / sc, torch.sin(angle) / sc
    yy, xx = _grid(h, w, images.device)
    x0 = xx - cx - tx
    y0 = yy - cy - ty
    src_x = cos * x0 + sin * y0 + cx
    src_y = -sin * x0 + cos * y0 + cy
    return bilinear_sample(images, src_y, src_x, cval=0.0)


def random_crop_with_pad(images: torch.Tensor, offset: torch.Tensor,
                         padding: int = CROP_PAD, mode: str = "reflect") -> torch.Tensor:
    """Pad by ``padding`` (``mode`` "reflect", or "constant": zeros), then
    crop back to (H, W) at ``offset`` (oy, ox), each in [0, 2 * padding];
    on the device, no host sync."""
    b, h, w, c = images.shape
    oy, ox = offset.unbind(0)
    rows = oy + torch.arange(h, device=images.device)
    cols = ox + torch.arange(w, device=images.device)
    if mode == "constant":
        padded = F.pad(images, (0, 0, padding, padding, padding, padding))
        return padded.index_select(1, rows).index_select(2, cols)
    if mode != "reflect":
        raise ValueError(f"padding mode {mode!r}: reflect or constant")
    rows = _reflect_index(h, padding, images.device).index_select(0, rows)
    cols = _reflect_index(w, padding, images.device).index_select(0, cols)
    return images.index_select(1, rows).index_select(2, cols)


def add_gaussian_noise(images: torch.Tensor, noise: torch.Tensor, std: float = ACT_NOISE_STD,
                       mean: float = 0.0) -> torch.Tensor:
    """AddGaussianNoise: ``noise`` is standard normal of the images' shape;
    ``std`` in the images' units (5 on [0, 255] pixels)."""
    return images + noise * std + mean


def random_apply(fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                 apply: bool) -> torch.Tensor:
    """torchvision RandomApply with its decision drawn beforehand: one
    decision for the whole batch."""
    return fn(images) if apply else images


# -- the recipe ----------------------------------------------------------------------


class ControlNetAugmentDraws(NamedTuple):
    """The random parameters of one ``controlnet_train_augment`` call; None
    for an augmentation that is off."""

    jitter: Optional[torch.Tensor] = None  # (4,) see color_jitter
    elastic: Optional[torch.Tensor] = None  # (2, H, W) uniform in [-1, 1]
    blur_sigma: Optional[torch.Tensor] = None  # ()
    affine: Optional[torch.Tensor] = None  # (4,) see random_affine
    crop: Optional[torch.Tensor] = None  # (2,) long


def parse_augmentations(augmentations: Optional[str]) -> list[str]:
    known = ("colorjitter", "elastic", "blur", "affine", "crop")
    augs = [a for a in (augmentations or "").split(",") if a]
    bad = [a for a in augs if a not in known]
    if bad:
        raise ValueError(f"unknown augmentations {bad}; known: {','.join(known)}")
    return augs


def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def sample_controlnet_augment_draws(augmentations: Optional[str], h: int, w: int,
                                    generator: torch.Generator) -> ControlNetAugmentDraws:
    """Draws for ``controlnet_train_augment`` on (B, h, w, 3) images, in the
    JAX package's ranges, from ``generator`` (on its device)."""
    augs = parse_augmentations(augmentations)
    out = {}
    if "colorjitter" in augs:
        br, co, sa, hu = JITTER
        out["jitter"] = torch.cat([
            _uniform(generator, (1,), 1 - br, 1 + br), _uniform(generator, (1,), 1 - co, 1 + co),
            _uniform(generator, (1,), 1 - sa, 1 + sa), _uniform(generator, (1,), -hu, hu)])
    if "elastic" in augs:
        out["elastic"] = _uniform(generator, (2, h, w), -1.0, 1.0)
    if "blur" in augs:
        out["blur_sigma"] = _uniform(generator, (), *BLUR_SIGMA)
    if "affine" in augs:
        t = _uniform(generator, (1,), -AFFINE_TRANSLATE[0], AFFINE_TRANSLATE[0])
        out["affine"] = torch.cat([_uniform(generator, (1,), *AFFINE_DEGREES), t, t,
                                   _uniform(generator, (1,), *AFFINE_SCALE)])
    if "crop" in augs:
        out["crop"] = torch.randint(0, 2 * CROP_PAD + 1, (2,), generator=generator,
                                    device=generator.device)
    return ControlNetAugmentDraws(**out)


def controlnet_train_augment(pixel_values: torch.Tensor, conditioning: torch.Tensor,
                             augmentations: Optional[str],
                             draws: ControlNetAugmentDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``augment_data`` on a target batch (B, H, W, 3) in
    [-1, 1] and its conditioning (B, H, W, 3) in [0, 1]."""
    augs = parse_augmentations(augmentations)
    if "colorjitter" in augs:
        conditioning = color_jitter(conditioning, draws.jitter)
    if "elastic" in augs:
        conditioning = elastic_transform(conditioning, draws.elastic)
    if "blur" in augs:
        conditioning = gaussian_blur(conditioning, draws.blur_sigma)
    if "affine" in augs:
        pixel_values = random_affine(pixel_values, draws.affine)
        conditioning = random_affine(conditioning, draws.affine)
    if "crop" in augs:
        both = random_crop_with_pad(torch.cat([pixel_values, conditioning], dim=-1), draws.crop)
        pixel_values, conditioning = both.chunk(2, dim=-1)
    return pixel_values, conditioning


class ACTAugmentDraws(NamedTuple):
    """The random parameters of one ``act_train_augment`` call: whether
    elastic, colour jitter and the crop apply, and their draws (None where
    an op does not apply), then the noise."""

    apply: tuple[bool, bool, bool]
    elastic: Optional[torch.Tensor]  # (2, H, W) uniform in [-1, 1]
    jitter: Optional[torch.Tensor]  # (4,) see color_jitter
    crop: Optional[torch.Tensor]  # (2,) long in [0, 2 * ACT_CROP_PAD]
    noise: torch.Tensor  # (N, H, W, 3) standard normal


def sample_act_augment_draws(n: int, h: int, w: int,
                             generator: torch.Generator) -> ACTAugmentDraws:
    """Draws for ``act_train_augment`` on (n, h, w, 3) images, in the JAX
    package's ranges, from ``generator`` (on its device). The three
    decisions come to the host (on the card, a wait for the device)."""
    dev = generator.device
    apply = tuple(bool(a) for a in (torch.rand(3, generator=generator, device=dev)
                                     < ACT_APPLY_P).tolist())
    br, co, sa, hu = JITTER
    return ACTAugmentDraws(
        apply=apply,
        elastic=_uniform(generator, (2, h, w), -1.0, 1.0) if apply[0] else None,
        jitter=torch.cat([
            _uniform(generator, (1,), 1 - br, 1 + br), _uniform(generator, (1,), 1 - co, 1 + co),
            _uniform(generator, (1,), 1 - sa, 1 + sa), _uniform(generator, (1,), -hu, hu),
        ]) if apply[1] else None,
        crop=torch.randint(0, 2 * ACT_CROP_PAD + 1, (2,), generator=generator,
                           device=dev) if apply[2] else None,
        noise=torch.randn((n, h, w, 3), generator=generator, device=dev),
    )


def act_train_augment(images: torch.Tensor, draws: ACTAugmentDraws) -> torch.Tensor:
    """The ACT policy's train-time recipe on (N, H, W, 3) floats in [0, 255]."""
    x = images / 255.0
    x = random_apply(lambda t: elastic_transform(t, draws.elastic), x, draws.apply[0])
    x = random_apply(lambda t: color_jitter(t, draws.jitter), x, draws.apply[1])
    x = x * 255.0
    x = random_apply(lambda t: random_crop_with_pad(t, draws.crop, ACT_CROP_PAD, "constant"),
                     x, draws.apply[2])
    return add_gaussian_noise(x, draws.noise)
