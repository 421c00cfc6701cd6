"""Port's Euler scheduler and tiling helpers against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.data import tiling as jt
from genima_tpu.diffusion.schedulers import (
    EulerDiscreteScheduler as JaxEuler,
    SchedulerConfig as JaxSchedulerConfig,
)

from genima_torch.data import tiling as tt
from genima_torch.diffusion.schedulers import EulerDiscreteScheduler, SchedulerConfig


def _pair(spacing):
    return (
        EulerDiscreteScheduler(SchedulerConfig(timestep_spacing=spacing)),
        JaxEuler(JaxSchedulerConfig(timestep_spacing=spacing)),
    )


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
@pytest.mark.parametrize("steps", [1, 2, 4, 5, 10])
def test_tables_equal_exactly(spacing, steps):
    ours, ref = _pair(spacing)
    a, b = ours.set_timesteps(steps), ref.set_timesteps(steps)
    np.testing.assert_array_equal(a.timesteps, np.asarray(b.timesteps))
    np.testing.assert_array_equal(a.sigmas, np.asarray(b.sigmas))
    assert a.timesteps.dtype == a.sigmas.dtype == np.float32
    assert np.float32(a.init_noise_sigma) == np.float32(b.init_noise_sigma)


def test_default_config_is_sd_turbo_trailing():
    assert EulerDiscreteScheduler().config == SchedulerConfig(timestep_spacing="trailing")
    assert dataclasses.asdict(SchedulerConfig()).items() <= dataclasses.asdict(
        JaxSchedulerConfig()
    ).items()


@pytest.mark.parametrize("i", [0, 3, 4])
def test_scale_and_step_match(i):
    ours, ref = _pair("trailing")
    a, b = ours.set_timesteps(5), ref.set_timesteps(5)
    rng = np.random.RandomState(i)
    sample = (rng.randn(1, 4, 8, 8) * 14.6).astype(np.float32)
    eps = rng.randn(1, 4, 8, 8).astype(np.float32)
    np.testing.assert_allclose(
        ours.scale_model_input(a, torch.from_numpy(sample), i).numpy(),
        np.asarray(ref.scale_model_input(b, jnp.asarray(sample), i)),
        rtol=1e-6, atol=0,
    )
    np.testing.assert_allclose(
        ours.step(a, torch.from_numpy(eps), i, torch.from_numpy(sample)).numpy(),
        np.asarray(ref.step(b, jnp.asarray(eps), i, jnp.asarray(sample))),
        rtol=1e-6, atol=1e-6,
    )


def test_tile_untile_bit_equal():
    views = np.random.RandomState(0).randint(0, 256, (2, 4, 8, 6, 3)).astype(np.uint8)
    tiled = tt.tile_images(torch.from_numpy(views))
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(jt.tile_images(jnp.asarray(views))))
    back = tt.untile_images(tiled)
    np.testing.assert_array_equal(back.numpy(), views)
    np.testing.assert_array_equal(
        tt.untile_to_cameras(tiled, target_size=8).numpy(),
        np.asarray(jt.untile_to_cameras(jnp.asarray(tiled.numpy()), target_size=8)),
    )


def test_untile_to_cameras_raises_on_resize():
    # the antialiased resize is ported: a 32x32 quadrant shrunk to 16 matches
    # JAX's jax.image.resize (f32, values in [0, 1])
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(
        tt.untile_to_cameras(torch.from_numpy(x), target_size=16).numpy(),
        np.asarray(jt.untile_to_cameras(jnp.asarray(x), target_size=16)), atol=1e-4, rtol=0,
    )
    with pytest.raises(ValueError):
        tt.tile_images(torch.zeros(1, 3, 8, 8, 3))


def test_denormalize_to_uint8_bit_equal():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1.2, 1.2, 4096).astype(np.float32)
    # exact ties: x*0.5+0.5 == (k + 0.5)/255 rounds half to even in both
    ties = ((np.arange(0, 255) + 0.5) / 255.0 * 2.0 - 1.0).astype(np.float32)
    x = np.concatenate([x, ties, [-1.0, 1.0, 0.0]]).astype(np.float32)
    got = tt.denormalize_to_uint8(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt.denormalize_to_uint8(jnp.asarray(x))))
