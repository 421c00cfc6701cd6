"""The port's ControlNet augmentations against the JAX package's, f32, on the CPU.

Each op, and the composed ``controlnet_train_augment``, gets the numbers the
JAX op draws from its key, derived here in the JAX package's split order
(``jax_augment_draws``), so both packages compute on the same parameters.
Tolerance ``atol 1e-5``: f32 arithmetic in another order (the 43-tap
elastic smoothing, the HSV round trip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.data import augment as jax_aug

from genima_torch.data import augment as aug

ATOL = 1e-5
B, H, W = 2, 32, 24  # not square: height and width must not swap
ALL = "colorjitter,elastic,blur,affine,crop"


def jax_augment_draws(k_aug, augmentations, h, w) -> aug.ControlNetAugmentDraws:
    """The draws ``controlnet_train_augment(k_aug, ...)`` makes, in the JAX
    ops' own split order."""
    augs = augmentations.split(",")
    k = jax.random.split(k_aug, 6)
    u = jax.random.uniform
    out = {}
    if "colorjitter" in augs:
        kb, kc, ks, kh = jax.random.split(k[0], 4)
        out["jitter"] = [u(kb, (), minval=0.8, maxval=1.2), u(kc, (), minval=0.8, maxval=1.2),
                         u(ks, (), minval=0.9, maxval=1.1), u(kh, (), minval=-0.05, maxval=0.05)]
    if "elastic" in augs:
        kx, ky = jax.random.split(k[1])
        out["elastic"] = [u(kx, (h, w), minval=-1.0, maxval=1.0),
                          u(ky, (h, w), minval=-1.0, maxval=1.0)]
    if "blur" in augs:
        out["blur_sigma"] = u(k[2], (), minval=0.1, maxval=2.0)
    if "affine" in augs:
        ka, kt, ks = jax.random.split(k[3], 3)
        out["affine"] = [u(ka, (), minval=0.0, maxval=10.0), u(kt, (), minval=-0.1, maxval=0.1),
                         u(kt, (), minval=-0.1, maxval=0.1), u(ks, (), minval=0.9, maxval=1.1)]
    if "crop" in augs:
        ky, kx = jax.random.split(k[4])
        out["crop"] = [jax.random.randint(ky, (), 0, 5), jax.random.randint(kx, (), 0, 5)]
    return aug.ControlNetAugmentDraws(**{
        name: torch.from_numpy(np.stack([np.asarray(x) for x in v]) if isinstance(v, list)
                               else np.array(v)).to(torch.long if name == "crop" else torch.float32)
        for name, v in out.items()})


def _images(seed, lo=0.0, hi=1.0, shape=(B, H, W, 3)):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=what)


@pytest.mark.parametrize("op", ["colorjitter", "elastic", "blur", "affine", "crop"])
def test_op_matches_jax(op):
    x = _images(0)
    key = jax.random.key(3)
    # the op's key is k[i] of split(k_aug, 6); rebuild it the same way
    k = jax.random.split(key, 6)
    d = jax_augment_draws(key, op, H, W)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if op == "colorjitter":
        got, want = aug.color_jitter(xt, d.jitter), jax_aug.color_jitter(k[0], xj)
    elif op == "elastic":
        got, want = aug.elastic_transform(xt, d.elastic), jax_aug.elastic_transform(k[1], xj)
    elif op == "blur":
        got, want = aug.gaussian_blur(xt, d.blur_sigma), jax_aug.gaussian_blur(k[2], xj)
    elif op == "affine":
        got, want = aug.random_affine(xt, d.affine), jax_aug.random_affine(k[3], xj)
    else:
        got, want = (aug.random_crop_with_pad(xt, d.crop, padding=2),
                     jax_aug.random_crop_with_pad(k[4], xj, padding=2, mode="reflect"))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, op)
    assert not np.allclose(np.asarray(want), x)  # the op did something


@pytest.mark.parametrize("cval", [None, 0.0])
def test_bilinear_sample_matches_jax(cval):
    """Coordinates inside, at the edges and outside; the edge clamp comes
    before the floor."""
    x = _images(1)
    rng = np.random.RandomState(2)
    sy = rng.uniform(-3, H + 2, (H, W)).astype(np.float32)
    sx = rng.uniform(-3, W + 2, (H, W)).astype(np.float32)
    sy[0, :4] = [-0.5, 0.0, H - 1, H - 0.5]
    got = aug.bilinear_sample(torch.from_numpy(x), torch.from_numpy(sy), torch.from_numpy(sx), cval)
    want = jax_aug.bilinear_sample(jnp.asarray(x), jnp.asarray(sy), jnp.asarray(sx), cval)
    _close(got, want)
    if cval is None:  # -0.5 reads row 0 only
        np.testing.assert_allclose(got[:, 0, 0].numpy(),
                                   aug.bilinear_sample(torch.from_numpy(x), torch.zeros(H, W),
                                                       torch.from_numpy(sx))[:, 0, 0].numpy())


@pytest.mark.parametrize("size", [(5, 3), (1, 4)])
def test_separable_filter_reflects_like_numpy(size):
    """Reflect padding wider than the image repeats the reflection, as
    numpy's (and so jnp.pad's) "reflect" does."""
    x = _images(4, shape=(1, *size, 2))
    k = np.asarray(jax_aug._gaussian_kernel1d(jnp.float32(1.5), 4))
    got = aug._separable_filter(torch.from_numpy(x), torch.from_numpy(k))
    _close(got, jax_aug._separable_filter(jnp.asarray(x), jnp.asarray(k)))


@pytest.mark.parametrize("augmentations", [ALL, "colorjitter,crop", "affine"])
def test_controlnet_train_augment_matches_jax(augmentations):
    px, cond = _images(5, -1.0, 1.0), _images(6)
    key = jax.random.key(7)
    want = jax_aug.controlnet_train_augment(key, jnp.asarray(px), jnp.asarray(cond), augmentations)
    got = aug.controlnet_train_augment(torch.from_numpy(px), torch.from_numpy(cond), augmentations,
                                       jax_augment_draws(key, augmentations, H, W))
    for g, w, name in zip(got, want, ("pixel_values", "conditioning")):
        _close(g, w, f"{augmentations}: {name}")
    if "affine" not in augmentations and "crop" not in augmentations:
        np.testing.assert_array_equal(got[0].numpy(), px)  # the target is left alone


def test_affine_translations_share_one_draw():
    """The JAX recipe draws tx and ty from one key: one uniform number,
    scaled by the width and by the height. The port's sampler keeps that."""
    _, kt, _ = jax.random.split(jax.random.split(jax.random.key(9), 6)[3], 3)
    u = jax.random.uniform
    assert float(u(kt, (), minval=-0.1, maxval=0.1)) == float(u(kt, (), minval=-0.1, maxval=0.1))
    for seed in range(5):
        d = aug.sample_controlnet_augment_draws("affine", H, W, torch.Generator().manual_seed(seed))
        assert d.affine[1] == d.affine[2]


def test_sampler_draws_in_the_jax_ranges():
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        d = aug.sample_controlnet_augment_draws(ALL, H, W, g)
        b, c, s, h = d.jitter.tolist()
        assert 0.8 <= b <= 1.2 and 0.8 <= c <= 1.2 and 0.9 <= s <= 1.1 and -0.05 <= h <= 0.05
        assert d.elastic.shape == (2, H, W) and d.elastic.abs().max() <= 1
        assert 0.1 <= float(d.blur_sigma) <= 2.0
        angle, tx, ty, sc = d.affine.tolist()
        assert 0 <= angle <= 10 and -0.1 <= tx <= 0.1 and 0.9 <= sc <= 1.1
        assert d.crop.dtype == torch.long and 0 <= d.crop.min() and d.crop.max() <= 4
    assert aug.sample_controlnet_augment_draws("crop", H, W, g).jitter is None
    with pytest.raises(ValueError, match="unknown augmentations"):
        aug.parse_augmentations("crop,flip")


def test_zero_strength_is_identity():
    x = torch.from_numpy(_images(8))
    cases = {
        "colorjitter": aug.color_jitter(x, torch.tensor([1.0, 1.0, 1.0, 0.0])),
        "elastic": aug.elastic_transform(x, torch.zeros(2, H, W)),
        "blur": aug.gaussian_blur(x, torch.tensor(0.1)),  # taps exp(-50) off the centre
        "affine": aug.random_affine(x, torch.tensor([0.0, 0.0, 0.0, 1.0])),
        "crop": aug.random_crop_with_pad(x, torch.tensor([2, 2])),
    }
    for name, y in cases.items():
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-6, err_msg=name)
