"""The serving pipeline's opt-in configuration in both packages, tiny config,
on the CPU: ``backend="pallas+w8"`` (every attention through the flash
kernel, the transformer linears in int8) with ``conv_backend="fused"`` (the
VAE decoder through the fused GN-SiLU-conv3x3). The JAX side runs its flash
kernel in Pallas interpret mode and its int8 and fused-conv kernels through
their off-TPU XLA paths; the port runs the plain versions of B3, B4 and B5.
Same quantized params (exported from JAX), same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet, UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig
from genima_tpu.weights.quantize import quantize_dense_tree as jax_quantize_tree
from genima_tpu.weights.quantize import quantize_pipeline_params as jax_quantize_pipeline

import genima_torch.nn.layers as torch_layers
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval.agents import make_tiny_sd_agent
from genima_torch.kernels import fused_conv, w8_matmul
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights.from_jax import load_from_jax
from genima_torch.weights.init import build_module

STEPS = 2
BACKEND, CONV_BACKEND = "pallas+w8", "fused"


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return dict(
        cond=rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8),
        embeds=rng.randn(1, 77, 32).astype(np.float32),
        latents=rng.randn(1, 16, 16, 4).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_side(inputs):
    pipe = JaxPipeline(
        unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
        text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32, backend=BACKEND,
        conv_backend=CONV_BACKEND,
    )
    params = pipe.init_params(jax.random.key(0), image_size=32)
    # the ControlNet's zero convs start at zero; randomise them so its
    # residuals shape the output
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in cn:
        if k.startswith("controlnet_"):
            cn[k] = jax.tree_util.tree_map(
                lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    params = jax_quantize_pipeline(params)
    target = pipe.generate(
        params, jnp.asarray(inputs["cond"]), jnp.asarray(inputs["embeds"]),
        jnp.asarray(inputs["latents"]), num_inference_steps=STEPS,
    )
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(target)


@pytest.fixture(scope="module")
def port(jax_side):
    pipe = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), device="cpu", backend=BACKEND,
        conv_backend=CONV_BACKEND,
    )
    return pipe, pipe.params_from_jax(jax_side[0])


def _generate(port, inputs):
    pipe, params = port
    return pipe.generate(
        params, torch.from_numpy(inputs["cond"]), torch.from_numpy(inputs["embeds"]),
        torch.from_numpy(inputs["latents"]), num_inference_steps=STEPS,
    )


def test_generate_matches_jax(port, jax_side, inputs):
    target = _generate(port, inputs)
    assert target.dtype == torch.uint8 and target.shape == (1, 32, 32, 3)
    diff = np.abs(target.numpy().astype(int) - jax_side[1].astype(int))
    assert diff.max() <= 1, f"target differs by {diff.max()} LSB"


def test_generate_routes_through_the_three_wrappers(port, inputs, monkeypatch):
    """Per denoise step the tiny config sends 12 attentions to the flash
    wrapper (UNet 4 and ControlNet 2 transformer blocks, self and cross) and
    72 linears to the int8 wrapper (12 per block); the decode sends 9 convs
    to the fused wrapper (2 up levels x 2 resnets x 2 convs, and conv_out).
    On the CPU no kernel launches."""
    calls = {"flash": 0, "w8": 0, "conv": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(torch_layers, "flash_attention",
                        counting("flash", torch_layers.flash_attention))
    monkeypatch.setattr(torch_layers, "w8_matmul", counting("w8", torch_layers.w8_matmul))
    import genima_torch.nn.fused_blocks as fb
    monkeypatch.setattr(fb, "fused_conv3x3", counting("conv", fb.fused_conv3x3))
    launches = (w8_matmul.w8_matmul.launches, fused_conv.fused_conv3x3.launches)
    _generate(port, inputs)
    assert calls == {"flash": 12 * STEPS, "w8": 72 * STEPS, "conv": 2 * 2 * 2 + 1}
    assert (w8_matmul.w8_matmul.launches, fused_conv.fused_conv3x3.launches) == launches


# '+w8' rounds every int8 linear's input to bf16, so an f32-level difference
# upstream flips some of those roundings: at this seed JAX's own
# 'pallas_self+w8' and 'xla+w8' outputs of the same UNet differ by 7.2e-3
# (outputs up to ~2). The float UNet has no such roundings.
UNET_ATOL = {"pallas_self": 1e-4, "pallas_self+w8": 1e-2}


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.RandomState(7)
    sample = rng.randn(1, 8, 8, 4).astype(np.float32)
    t = np.array([499.0], np.float32)
    ctx = rng.randn(1, 77, 32).astype(np.float32)
    args = (jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    params = fast_init(JaxUNet(JaxUNetConfig.tiny(), backend="pallas_self"), jax.random.key(2),
                       *args, seed=31)["params"]
    return sample, t, ctx, params


@pytest.mark.parametrize("backend", sorted(UNET_ATOL))
def test_unet_forward_pallas_self_matches_jax(unet_inputs, backend):
    sample, t, ctx, params = unet_inputs
    args = (jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    if backend.endswith("+w8"):
        params = jax_quantize_tree(params)
    want = JaxUNet(JaxUNetConfig.tiny(), backend=backend).apply({"params": params}, *args)
    tm = load_from_jax(
        build_module(lambda: UNet2DConditionModel(UNetConfig.tiny(), backend),
                     torch.device("cpu"), torch.float32),
        jax.tree_util.tree_map(np.asarray, params), "diffusers_unet")
    got = tm(torch.from_numpy(np.ascontiguousarray(sample.transpose(0, 3, 1, 2))),
             torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=UNET_ATOL[backend])


def test_tiny_agent_takes_the_opt_in_backends():
    """make_tiny_sd_agent passes pipeline settings through; under '+w8' its
    seeded float weights are quantized, so the int8 weights are not zero."""
    agent = make_tiny_sd_agent(device="cpu", seed=1, backend=BACKEND, conv_backend=CONV_BACKEND)
    assert agent.pipe.backend == BACKEND and agent.params["vae"].decoder.conv_backend == "fused"
    qs = [m.kernel_q for m in agent.params["unet"].modules()
          if isinstance(m, torch_layers.W8Linear)]
    assert len(qs) == 48 and all(q.dtype == torch.int8 and q.abs().max() == 127 for q in qs)
