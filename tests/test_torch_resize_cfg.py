"""The antialiased resize on untile and classifier-free guidance in
``generate``, against the JAX package, tiny config, on the CPU.

Resize: ``untile_to_cameras`` (shrinking and growing quadrants) and
``resize_half`` against ``jax.image.resize(method="linear")`` at 1e-4 in f32
on values in [0, 1] (the same triangle-filter weights; the rest is f32
rounding). CFG: ``generate`` with ``guidance_scale=2.0`` and negative
embeddings, weights carried across by the port's converter and the same
numpy latents, gives targets within 1 LSB (f32 pixels on a .5 boundary may
round the other way, as in ``test_torch_fused_step.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.data import tiling as jt
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

import genima_torch.nn.layers as torch_layers
from genima_torch.data import tiling as tt
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.kernels.packed_attention import packed_flash_attention
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

RESIZE_ATOL = 1e-4
STEPS = 2
GUIDANCE = 2.0


@pytest.mark.parametrize("tile, target", [(128, 32), (128, 48), (64, 24), (32, 32), (32, 48),
                                          (30, 64)])
def test_untile_to_cameras_resize_matches_jax(tile, target):
    x = np.random.RandomState(tile + target).rand(2, tile, tile, 3).astype(np.float32)
    got = tt.untile_to_cameras(torch.from_numpy(x), target_size=target).numpy()
    want = np.asarray(jt.untile_to_cameras(jnp.asarray(x), target_size=target))
    assert got.shape == want.shape == (2, 4, target, target, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 4, 32, 32, 3), (3, 30, 18, 3)])
def test_resize_half_matches_jax(shape):
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    got = tt.resize_half(torch.from_numpy(x)).numpy()
    want = np.asarray(jt.resize_half(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def cfg_case():
    pipe = JaxPipeline(
        unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
        text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32,
    )
    params = pipe.init_params(jax.random.key(0), 64)
    # the ControlNet's zero convs start at zero; randomise them so its
    # residuals shape the output
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    rng = np.random.RandomState(0)
    inputs = dict(
        tiled=rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8),
        latents=rng.randn(1, 32, 32, 4).astype(np.float32),
        pos_ids=rng.randint(0, 1000, (1, 77)).astype(np.int32),
        neg_ids=rng.randint(0, 1000, (1, 77)).astype(np.int32),
    )
    pos = pipe.encode_prompt(params, jnp.asarray(inputs["pos_ids"]))
    neg = pipe.encode_prompt(params, jnp.asarray(inputs["neg_ids"]))
    want = {}
    for name, scale, negative in (("cfg", GUIDANCE, neg), ("plain", 0.0, None)):
        want[name] = np.asarray(pipe.generate(
            params, jnp.asarray(inputs["tiled"]), pos, jnp.asarray(inputs["latents"]),
            num_inference_steps=STEPS, guidance_scale=scale, negative_prompt_embeds=negative,
        ))
    port = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), device="cpu",
    )
    port_params = port.params_from_jax(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params))
    return port, port_params, inputs, want


def _port_generate(cfg_case, guidance, with_negative):
    port, params, inputs, _ = cfg_case
    pos = port.encode_prompt(params, inputs["pos_ids"])
    neg = port.encode_prompt(params, inputs["neg_ids"]) if with_negative else None
    return port.generate(
        params, torch.from_numpy(inputs["tiled"]), pos, torch.from_numpy(inputs["latents"]),
        num_inference_steps=STEPS, guidance_scale=guidance, negative_prompt_embeds=neg,
    )


def test_cfg_generate_matches_jax(cfg_case):
    got = _port_generate(cfg_case, GUIDANCE, True)
    want = cfg_case[3]["cfg"]
    assert got.dtype == torch.uint8 and got.shape == want.shape == (1, 64, 64, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1, f"target differs by {diff.max()} LSB"
    # guidance moves the target: the negative branch is not a no-op
    assert np.abs(want.astype(int) - cfg_case[3]["plain"].astype(int)).max() > 1


@pytest.mark.parametrize("guidance, with_negative", [(1.0, True), (2.0, False), (0.0, False)])
def test_no_cfg_without_guidance_or_negatives(cfg_case, guidance, with_negative):
    """As in JAX (and diffusers), the negative branch runs only with
    guidance above 1 and negative embeddings given."""
    got = _port_generate(cfg_case, guidance, with_negative)
    diff = np.abs(got.numpy().astype(int) - cfg_case[3]["plain"].astype(int))
    assert diff.max() <= 1, f"target differs by {diff.max()} LSB"


def test_cfg_doubles_the_batch_of_every_attention(cfg_case, monkeypatch):
    """Under CFG the long self-attentions reach the packed wrapper at batch 2
    ([negative, positive]); without it at batch 1."""
    calls = []

    def counting(q, k, v, num_heads):
        calls.append(q.shape[0])
        return packed_flash_attention(q, k, v, num_heads)

    monkeypatch.setattr(torch_layers, "packed_flash_attention", counting)
    _port_generate(cfg_case, GUIDANCE, True)
    assert calls and set(calls) == {2}
    calls.clear()
    _port_generate(cfg_case, 0.0, False)
    assert calls and set(calls) == {1}
