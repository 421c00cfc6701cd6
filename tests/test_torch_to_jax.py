"""The port's modules written back as the reference's trees
(``weights/to_jax.py::tree_from_module``), against the JAX package.

For each family the port writes (``controlnet``, ``act``,
``torchvision_resnet``, and the base models a pretrain saves: ``unet``,
``vae`` with its encoder, ``hf_clip``): a JAX tree loaded into the port's
module and
written back must be that tree, leaf for leaf and bit for bit, and must
equal what the JAX package's own importer (``port_torch_state_dict``) makes
of the module's state dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.control.policy import GenimaACTAgent as JaxACTAgent
from genima_tpu.core.init_utils import fast_init
from genima_tpu.nn.act import ACTConfig as JaxACTConfig
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.clip_text import CLIPTextModel as JaxCLIP
from genima_tpu.nn.controlnet import ControlNetModel as JaxControlNet
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet, UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig
from genima_tpu.weights.torch_port import port_torch_state_dict

from genima_torch.nn.act import ACTConfig, GenimaACTModel
from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.controlnet import ControlNetModel
from genima_torch.nn.resnet import ImageEncoderACT
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.nn.vae import AutoencoderKL, VAEConfig
from genima_torch.weights.from_jax import load_from_jax
from genima_torch.weights.init import build_module
from genima_torch.weights.to_jax import tree_from_module


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _randomised(tree, seed):
    """Every leaf drawn anew, so zero-initialised leaves cannot hide a swap."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def trees():
    cfg = JaxUNetConfig.tiny()
    lat, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))
    ctx = jnp.zeros((1, 4, cfg.cross_attention_dim))
    cn = fast_init(
        JaxControlNet(cfg, conditioning_scale_channels=(8, 16)), jax.random.key(0), lat, t,
        ctx, jnp.zeros((1, 16, 16, 3)), seed=2,
    )["params"]
    agent = JaxACTAgent(
        act_cfg=JaxACTConfig.tiny(num_queries=6), clip_cfg=JaxCLIPConfig.tiny(projection_dim=16),
        image_size=32, resnet_width=8, data_augmentation=False,
    )
    params, _ = agent.init_params(jax.random.key(1))
    unet = fast_init(JaxUNet(cfg), jax.random.key(2), lat, t, ctx, seed=6)["params"]
    key = jax.random.key(3)
    vae = fast_init(JaxVAE(JaxVAEConfig.tiny_test()), key, jnp.zeros((1, 16, 16, 3)), key,
                    seed=7)["params"]
    clip = fast_init(JaxCLIP(JaxCLIPConfig.tiny()), key, jnp.zeros((1, 77), jnp.int32),
                     seed=8)["params"]
    return {
        "diffusers_unet": _randomised(_np(unet), 9),
        "diffusers_vae": _randomised(_np(vae), 10),
        "hf_clip": _randomised(_np(clip), 11),
        "diffusers_controlnet": _randomised(_np(cn), 3),
        "torchvision_resnet": _randomised(_np(params["encoder"]), 4),
        "act": _randomised(_np(params["actor"]), 5),
    }


PORT_MODULES = {
    "diffusers_unet": lambda: UNet2DConditionModel(UNetConfig.tiny()),
    "diffusers_vae": lambda: AutoencoderKL(VAEConfig.tiny_test(), encoder=True),
    "hf_clip": lambda: CLIPTextModel(CLIPTextConfig.tiny()),
    "diffusers_controlnet": lambda: ControlNetModel(UNetConfig.tiny(), (8, 16)),
    "torchvision_resnet": lambda: ImageEncoderACT(32, True, 8, False, 16),
    "act": lambda: GenimaACTModel(ACTConfig.tiny(num_queries=6)),
}


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == np.float32 and got[k].shape == np.shape(want[k]), f"{path}/{k}"
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


@pytest.mark.parametrize("family", sorted(PORT_MODULES))
def test_tree_from_module_inverts_the_converter(trees, family):
    module = build_module(PORT_MODULES[family], torch.device("cpu"), torch.float32)
    load_from_jax(module, trees[family], family)
    _assert_trees_equal(tree_from_module(module, family), trees[family])


@pytest.mark.parametrize("family", ["diffusers_controlnet", "torchvision_resnet",
                                    "diffusers_unet", "diffusers_vae", "hf_clip"])
def test_tree_from_module_matches_the_reference_importer(trees, family):
    module = build_module(PORT_MODULES[family], torch.device("cpu"), torch.float32)
    load_from_jax(module, trees[family], family)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    want = _np(port_torch_state_dict(sd, trees[family], family))
    _assert_trees_equal(tree_from_module(module, family), want)


def test_bf16_module_writes_its_values_exactly(trees):
    """A bf16 module (the card's storage) writes f32 leaves that load back
    into a bf16 module bit for bit."""
    family = "diffusers_controlnet"
    module = build_module(PORT_MODULES[family], torch.device("cpu"), torch.bfloat16)
    load_from_jax(module, trees[family], family)
    again = build_module(PORT_MODULES[family], torch.device("cpu"), torch.bfloat16)
    load_from_jax(again, tree_from_module(module, family), family)
    for (k, x), (_, y) in zip(module.state_dict().items(), again.state_dict().items()):
        assert torch.equal(x, y), k


def test_names_the_rules_cannot_invert_raise():
    with pytest.raises(KeyError, match="no flax path"):
        # "foo" is no indexed diffusers token: foo_0 would map to foo_0.weight
        module = torch.nn.ModuleDict({"foo": torch.nn.Sequential(torch.nn.Linear(2, 2))})
        tree_from_module(module, "diffusers_controlnet")
