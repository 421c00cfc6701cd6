"""The port's goldens harness (``weights/goldens.py``) against the JAX
package's: JAX's ``make_self_goldens`` writes a fixture, and the port's
``run_ours`` reproduces every activation from its state dicts (diffusers
names, loaded with no conversion) to 1e-4; the port's own fixture has
JAX's schema."""

import numpy as np
import pytest
import torch

from genima_tpu.weights import goldens as jax_goldens

from genima_torch.weights import goldens


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_run_ours_reproduces_the_jax_self_goldens(tmp_path):
    jax_goldens.make_self_goldens(tmp_path / "jax.npz")
    source, sds, outs = goldens.load_goldens(tmp_path / "jax.npz")
    assert source == "self" and set(sds) == {"unet", "controlnet", "vae"}
    ours = goldens.run_ours(sds)
    assert ours.keys() == outs.keys()
    for k, want in outs.items():
        assert ours[k].shape == want.shape, k
        np.testing.assert_allclose(ours[k], want, rtol=1e-4, atol=1e-4, err_msg=k)


def test_the_port_fixture_has_the_jax_schema(tmp_path):
    goldens.make_self_goldens(tmp_path / "port.npz")
    source, sds, outs = jax_goldens.load_goldens(tmp_path / "port.npz")
    assert source == "self"
    ref = goldens.run_ours(sds)
    assert outs.keys() == ref.keys()
    for k in outs:
        np.testing.assert_array_equal(outs[k], ref[k])
    # ControlNet outputs are non-zero here (the seeded init has no zero convs)
    assert np.abs(outs["controlnet_mid"]).max() > 0


def test_inputs_configs_and_path_equal_jax():
    ours, ref = goldens.golden_inputs(), jax_goldens.golden_inputs()
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert goldens.TINY_UNET == jax_goldens.TINY_UNET and goldens.TINY_VAE == jax_goldens.TINY_VAE
    assert goldens.CN_COND_CHANNELS == jax_goldens.CN_COND_CHANNELS
    assert goldens.CONDITIONING_SCALE == jax_goldens.CONDITIONING_SCALE
    assert goldens.GOLDENS_PATH == jax_goldens.GOLDENS_PATH
