"""The port's weight converter against the reference's exporter.

``genima_torch.weights.from_jax.state_dict_from_jax`` keeps its own copy of
the naming rules of ``genima_tpu.weights.torch_port``; on the tiny UNet,
ControlNet, VAE, CLIP and ResNet trees it must give the same keys and arrays
as ``export_torch_state_dict``, and the port's modules must load the result
with ``load_state_dict(strict=True)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig, CLIPTextModel as JaxCLIP
from genima_tpu.nn.controlnet import (
    ControlNetModel as JaxControlNet,
    controlnet_params_from_unet as jax_from_unet,
)
from genima_tpu.nn.resnet import ImageEncoderACT as JaxEncoder
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet, UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig
from genima_tpu.weights.torch_port import export_torch_state_dict

from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.controlnet import ControlNetModel, controlnet_params_from_unet
from genima_torch.nn.resnet import ImageEncoderACT
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.nn.vae import DECODE_SUBTREES, AutoencoderKL, VAEConfig
from genima_torch.weights.from_jax import drop_subtrees, load_from_jax, state_dict_from_jax
from genima_torch.weights.init import build_module, init_random_


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    cfg = JaxUNetConfig.tiny()
    lat, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))
    ctx = jnp.zeros((1, 4, cfg.cross_attention_dim))
    key = jax.random.key(0)
    unet = fast_init(JaxUNet(cfg), key, lat, t, ctx, seed=1)["params"]
    cn = fast_init(
        JaxControlNet(cfg, conditioning_scale_channels=(8, 16)), key, lat, t, ctx,
        jnp.zeros((1, 16, 16, 3)), seed=2,
    )["params"]
    vae = fast_init(
        JaxVAE(JaxVAEConfig.tiny_test()), key, jnp.zeros((1, 16, 16, 3)), key, seed=3
    )["params"]
    clip = fast_init(
        JaxCLIP(JaxCLIPConfig.tiny()), key, jnp.zeros((1, 77), jnp.int32), seed=4
    )["params"]
    enc = fast_init(
        JaxEncoder(hidden_dim=32, width=8), key, jnp.zeros((1, 2, 32, 32, 3)),
        jnp.zeros((1, 16)), seed=5,
    )["params"]
    return {
        "diffusers_unet": unet, "diffusers_controlnet": cn, "diffusers_vae": vae,
        "hf_clip": clip, "torchvision_resnet": enc,
    }


PORT_MODULES = {
    "diffusers_unet": lambda: UNet2DConditionModel(UNetConfig.tiny()),
    "diffusers_controlnet": lambda: ControlNetModel(UNetConfig.tiny(), (8, 16)),
    "diffusers_vae": lambda: AutoencoderKL(VAEConfig.tiny_test()),
    "hf_clip": lambda: CLIPTextModel(CLIPTextConfig.tiny()),
    "torchvision_resnet": lambda: ImageEncoderACT(32, True, 8, False, 16),
}


@pytest.mark.parametrize("family", sorted(PORT_MODULES))
def test_converter_matches_reference_exporter(trees, family):
    got = state_dict_from_jax(_np(trees[family]), family)
    want = export_torch_state_dict(trees[family], family)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", sorted(PORT_MODULES))
def test_port_module_loads_strictly(trees, family):
    tree = _np(trees[family])
    if family == "diffusers_vae":  # the port holds the decode path only
        tree = drop_subtrees(tree, DECODE_SUBTREES, keep=True)
    module = build_module(PORT_MODULES[family], torch.device("cpu"), torch.float32)
    load_from_jax(module, tree, family)
    sd = module.state_dict()
    for k, v in state_dict_from_jax(tree, family).items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_missing_or_extra_tensor_raises(trees):
    tree = _np(trees["hf_clip"])
    module = build_module(PORT_MODULES["hf_clip"], torch.device("cpu"), torch.float32)
    missing = dict(tree, final_layer_norm={"scale": tree["final_layer_norm"]["scale"]})
    with pytest.raises(RuntimeError, match="final_layer_norm.bias"):
        load_from_jax(module, missing, "hf_clip")
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="stray"):
        load_from_jax(module, extra, "hf_clip")


def test_controlnet_from_unet_matches_reference(trees):
    unet, cn = trees["diffusers_unet"], trees["diffusers_controlnet"]
    want = export_torch_state_dict(jax_from_unet(unet, cn), "diffusers_controlnet")
    got = controlnet_params_from_unet(
        state_dict_from_jax(_np(unet), "diffusers_unet"),
        state_dict_from_jax(_np(cn), "diffusers_controlnet"),
    )
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_random_init_is_seeded_and_scaled():
    def make(seed):
        m = build_module(PORT_MODULES["diffusers_unet"], torch.device("cpu"), torch.float32)
        return init_random_(m, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    w = a["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"]
    assert abs(w.std().item() - w.shape[1] ** -0.5) < 0.2 * w.shape[1] ** -0.5
    assert torch.equal(a["conv_norm_out.weight"], torch.ones(32))
    assert torch.equal(a["conv_out.bias"], torch.zeros(4))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_text_matches_real_transformers_goldens(act):
    """The one oracle outside JAX: ``tests/fixtures/clip_text_golden_hf.npz``
    holds weights, ids and activations written by transformers'
    ``CLIPTextModelWithProjection``. Its state dict loads into the port's
    CLIP tower with ``strict=True`` (the port keeps HF's names), and the last
    and penultimate hidden states and the projected embeddings hold at
    ``tests/test_weights.py``'s tolerances."""
    from pathlib import Path

    fx = np.load(Path(__file__).parent / "fixtures" / "clip_text_golden_hf.npz")
    cfg = CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=2, hidden_act=act, projection_dim=32)
    model = CLIPTextModel(cfg)
    prefix = f"{act}.sd."
    sd = {k[len(prefix):]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith(prefix)}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(fx[f"{act}.ids"]).long())
    for got, name in ((out.last_hidden_state, "last_hidden_state"),
                      (out.penultimate_hidden_state, "penultimate"),
                      (out.text_embeds, "text_embeds")):
        np.testing.assert_allclose(got.numpy(), fx[f"{act}.{name}"], atol=2e-5, rtol=1e-4,
                                   err_msg=f"{act} {name}")
