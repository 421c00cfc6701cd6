"""``python -m genima_torch.cli.convert_checkpoint`` against the JAX
package's converter, kind by kind, on source files this test writes in the
published layouts (tiny models where the converter builds a target; the
real taesd geometry):

- ``sd_base`` / ``sdxl_base``: diffusers snapshots in fp16 safetensors;
- ``controlnet``: a diffusers ControlNet directory;
- ``export_controlnet``: a reference tree back to diffusers safetensors,
  read by the ``safetensors`` package and by JAX's loader;
- ``clip_vit_b32``: an OpenAI CLIP file; ``resnet18``: a torchvision file;
- ``taesd``: upstream ``taesd_encoder`` / ``taesd_decoder`` files, a merged
  dict and a diffusers ``AutoencoderTiny`` file.

Every tree the port writes equals JAX's leaf for leaf, read back with
JAX's ``load_pytree``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import genima_tpu.diffusion.pipeline as jax_pipeline_mod
import genima_tpu.nn.resnet as jax_resnet_mod
from genima_tpu.cli import convert_checkpoint as jax_convert
from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.core.init_utils import fast_init
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import AutoencoderTiny as JaxTiny
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig
from genima_tpu.weights.torch_port import export_torch_state_dict, load_taesd as jax_load_taesd

from genima_torch.cli import convert_checkpoint
from genima_torch.diffusion.pipeline import SDControlNetPipeline, SDXLControlNetPipeline
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.resnet import ResNet18
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import AutoencoderTiny, VAEConfig
from genima_torch.weights.init import build_module, init_random_
from genima_torch.weights.load_pretrained import (
    load_safetensors, load_taesd, save_safetensors, taesd_key,
)
from genima_torch.weights.to_jax import tree_from_module

CPU = torch.device("cpu")
JaxSD, JaxSDXL = jax_pipeline_mod.SDControlNetPipeline, jax_pipeline_mod.SDXLControlNetPipeline
FAMILIES = {"unet": "diffusers_unet", "controlnet": "diffusers_controlnet",
            "vae": "diffusers_vae", "text_encoder": "hf_clip", "text_encoder_2": "hf_clip"}
FILES = {"unet": "diffusion_pytorch_model.safetensors",
         "vae": "diffusion_pytorch_model.safetensors", "text_encoder": "model.safetensors",
         "text_encoder_2": "model.safetensors"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_sd(dtype=jnp.float32):
    return JaxSD(
        unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
        text_cfg=JaxCLIPConfig.tiny(), dtype=dtype)


def _jax_sdxl(dtype=jnp.float32):
    return JaxSDXL(
        unet_cfg=JaxUNetConfig.tiny(addition_embed_type="text_time", addition_time_embed_dim=8,
                                    cross_attention_dim=48),
        vae_cfg=JaxVAEConfig.tiny_test(scaling_factor=0.13025),
        text_cfg=JaxCLIPConfig.tiny(hidden_size=16, num_heads=2),
        text_cfg_2=JaxCLIPConfig.tiny(hidden_size=32, projection_dim=16), dtype=dtype)


def _port_sd():
    return SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32,
                                device="cpu", backend="xla", vae_encoder=True)


def _port_sdxl():
    return SDXLControlNetPipeline(
        unet_cfg=UNetConfig.tiny(addition_embed_type="text_time", addition_time_embed_dim=8,
                                 cross_attention_dim=48,
                                 projection_class_embeddings_input_dim=64),
        vae_cfg=VAEConfig.tiny_test(scaling_factor=0.13025),
        text_cfg=CLIPTextConfig.tiny(hidden_size=16, num_heads=2),
        text_cfg_2=CLIPTextConfig.tiny(hidden_size=32, projection_dim=16),
        dtype=torch.float32, device="cpu", backend="xla", vae_encoder=True)


def _tiny_init(sdxl: bool):
    """A JAX pipeline whose init gives the tiny trees, whatever the converter asks."""
    def make(dtype=jnp.float32):
        pipe = (_jax_sdxl if sdxl else _jax_sd)(dtype)
        object.__setattr__(pipe, "init_params", lambda *a, **kw: dict(_jax_params(sdxl)))
        return pipe
    return make


@functools.lru_cache(maxsize=None)
def _jax_params(sdxl: bool) -> dict:
    """The tiny pipeline's trees by ``fast_init`` (no init program compiled)."""
    if not sdxl:
        return _jax_sd().init_params(jax.random.key(3), image_size=64, fast=True)
    pipe, key, size = _jax_sdxl(), jax.random.key(3), 64
    lat, t = jnp.zeros((1, size // pipe.vae_scale_factor, size // pipe.vae_scale_factor, 4)), \
        jnp.zeros((1,))
    ctx = jnp.zeros((1, 77, pipe.text_cfg.hidden_size + pipe.text_cfg_2.hidden_size))
    cond, ids = jnp.zeros((1, size, size, 3)), jnp.zeros((1, 77), jnp.int32)
    added = {"text_embeds": jnp.zeros((1, pipe.text_cfg_2.projection_dim)),
             "time_ids": pipe.make_time_ids(1, size)}
    return {
        "unet": fast_init(pipe.unet, key, lat, t, ctx, added_cond_kwargs=added, seed=1)["params"],
        "controlnet": fast_init(pipe.controlnet, key, lat, t, ctx, cond,
                                added_cond_kwargs=added, seed=2)["params"],
        "vae": fast_init(pipe.vae, key, cond, key, seed=3)["params"],
        "text_encoder": fast_init(pipe.text_encoder, key, ids, seed=4)["params"],
        "text_encoder_2": fast_init(pipe.text_encoder_2, key, ids, seed=5)["params"],
    }


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, (*prefix, key)).items()}
    return {prefix: np.asarray(tree)}


def _assert_same_tree(got_path, want_path):
    got, want = _leaves(jax_ckpt.load_pytree(got_path)), _leaves(jax_ckpt.load_pytree(want_path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _fp16_noisy(sd: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {k: (np.asarray(v) + rng.uniform(-0.05, 0.05, np.shape(v))).astype(np.float16)
            for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["sd_base", "sdxl_base"])
def test_base_snapshot_converts_as_jax(kind, tmp_path, monkeypatch):
    sdxl = kind == "sdxl_base"
    params = _jax_params(sdxl)
    snap = tmp_path / "snapshot"
    for i, name in enumerate(n for n in FILES if n in params):
        (snap / name).mkdir(parents=True)
        save_file(_fp16_noisy(export_torch_state_dict(params[name], FAMILIES[name]), i),
                  str(snap / name / FILES[name]))
    cls = "SDXLControlNetPipeline" if sdxl else "SDControlNetPipeline"
    monkeypatch.setattr(jax_pipeline_mod, cls, _tiny_init(sdxl))
    jax_convert.main([kind, "--src", str(snap), "--dst", str(tmp_path / "jax")])
    report = convert_checkpoint.convert_sd_base(snap, tmp_path / "port", sdxl=sdxl,
                                                pipe=_port_sdxl() if sdxl else _port_sd())
    assert report["controlnet"] == "missing"
    names = [n for n in FILES if n in params]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(names)
    for name in names:
        _assert_same_tree(tmp_path / "port" / name / "params.msgpack",
                          tmp_path / "jax" / name / "params.msgpack")


def _jax_controlnet_tree():
    return _jax_params(False)["controlnet"]


def test_controlnet_converts_and_exports_as_jax(tmp_path, monkeypatch):
    tree = _jax_controlnet_tree()
    src = tmp_path / "checkpoint-15000" / "controlnet"
    src.mkdir(parents=True)
    save_file(_fp16_noisy(export_torch_state_dict(tree, "diffusers_controlnet"), 7),
              str(src / "diffusion_pytorch_model.safetensors"))
    monkeypatch.setattr(jax_convert, "_controlnet_target", _jax_controlnet_tree)
    jax_convert.main(["controlnet", "--src", str(src), "--dst", str(tmp_path / "jax")])
    convert_checkpoint.convert_controlnet(src, tmp_path / "port", unet_cfg=UNetConfig.tiny(),
                                          cond_channels=_port_sd().cond_channels)
    _assert_same_tree(tmp_path / "port" / "params.msgpack", tmp_path / "jax" / "params.msgpack")

    # back to diffusers: the same tensors through both readers, and JAX's file's
    convert_checkpoint.main(["export_controlnet", "--src", str(tmp_path / "port"),
                             "--dst", str(tmp_path / "port_out")])
    jax_convert.main(["export_controlnet", "--src", str(tmp_path / "jax"),
                      "--dst", str(tmp_path / "jax_out")])
    name = "diffusion_pytorch_model.safetensors"
    ours, ref = load_file(str(tmp_path / "port_out" / name)), load_file(
        str(tmp_path / "jax_out" / name))
    assert ours.keys() == ref.keys()
    mine = load_safetensors(tmp_path / "port_out" / name)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(mine[k].numpy(), ref[k], err_msg=k)
    # and JAX's controlnet kind reads the port's export back to the same tree
    jax_convert.main(["controlnet", "--src", str(tmp_path / "port_out"),
                      "--dst", str(tmp_path / "jax_back")])
    _assert_same_tree(tmp_path / "jax_back" / "params.msgpack",
                      tmp_path / "jax" / "params.msgpack")


def test_safetensors_writer_round_trips_every_dtype(tmp_path):
    tensors = {"f32": torch.randn(3, 4), "f16": torch.randn(5).half(),
               "bf16": torch.randn(2, 2).bfloat16(), "i64": torch.arange(7),
               "i32": torch.arange(3, dtype=torch.int32), "i8": torch.tensor([-3, 4], dtype=torch.int8),
               "u8": torch.tensor([250], dtype=torch.uint8), "empty": torch.zeros(0, 3)}
    save_safetensors(tensors, tmp_path / "x.safetensors")
    back = load_safetensors(tmp_path / "x.safetensors")
    assert back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    ref = load_file(str(tmp_path / "x.safetensors"))  # the safetensors package reads it
    np.testing.assert_array_equal(ref["f32"], tensors["f32"].numpy())


def _openai_clip(cfg, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    d, ff = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    sd = {"token_embedding.weight": r(cfg.vocab_size, d), "positional_embedding": r(77, d),
          "ln_final.weight": r(d), "ln_final.bias": r(d),
          "text_projection": r(d, cfg.projection_dim), "logit_scale": r(1)[0],
          "visual.proj": r(4, 4)}
    for i in range(cfg.num_layers):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "attn.in_proj_weight": r(3 * d, d), p + "attn.in_proj_bias": r(3 * d),
                   p + "attn.out_proj.weight": r(d, d), p + "attn.out_proj.bias": r(d),
                   p + "ln_1.weight": r(d), p + "ln_1.bias": r(d), p + "ln_2.weight": r(d),
                   p + "ln_2.bias": r(d), p + "mlp.c_fc.weight": r(ff, d),
                   p + "mlp.c_fc.bias": r(ff), p + "mlp.c_proj.weight": r(d, ff),
                   p + "mlp.c_proj.bias": r(d)})
    return sd


def test_clip_converts_as_jax(tmp_path, monkeypatch):
    jcfg = JaxCLIPConfig.tiny(projection_dim=16)
    torch.save(_openai_clip(jcfg), tmp_path / "ViT-B-32.pt")
    monkeypatch.setattr(JaxCLIPConfig, "vit_b_32", staticmethod(lambda: jcfg))
    jax_convert.main(["clip_vit_b32", "--src", str(tmp_path / "ViT-B-32.pt"),
                      "--dst", str(tmp_path / "jax")])
    convert_checkpoint.convert_clip(tmp_path / "ViT-B-32.pt", tmp_path / "port",
                                    text_cfg=CLIPTextConfig.tiny(projection_dim=16))
    _assert_same_tree(tmp_path / "port" / "params.msgpack", tmp_path / "jax" / "params.msgpack")


def test_resnet18_converts_as_jax(tmp_path, monkeypatch):
    src = init_random_(build_module(lambda: ResNet18(8), CPU, torch.float32),
                       torch.Generator().manual_seed(1))
    sd = dict(src.state_dict())
    sd.update({"fc.weight": torch.randn(10, 64), "fc.bias": torch.randn(10),
               "bn1.num_batches_tracked": torch.tensor(3)})
    torch.save(sd, tmp_path / "resnet18.pth")
    monkeypatch.setattr(jax_resnet_mod, "ResNet18",
                        functools.partial(jax_resnet_mod.ResNet18, width=8))
    jax_convert.main(["resnet18", "--src", str(tmp_path / "resnet18.pth"),
                      "--dst", str(tmp_path / "jax")])
    convert_checkpoint.convert_resnet(tmp_path / "resnet18.pth", tmp_path / "port", width=8)
    _assert_same_tree(tmp_path / "port" / "params.msgpack", tmp_path / "jax" / "params.msgpack")


@functools.lru_cache(maxsize=None)
def _upstream_taesd() -> dict:
    """taesd weights in upstream Sequential names, ``encoder.`` / ``decoder.``
    prefixed (the merged layout), from a seeded port module."""
    tiny = init_random_(build_module(AutoencoderTiny, CPU, torch.float32),
                        torch.Generator().manual_seed(4))
    out = {}
    for key, v in tiny.state_dict().items():
        tower, name = key.split(".", 1)
        out[f"{tower}.{taesd_key(tower, name)}"] = v.clone()
    return out


@pytest.mark.parametrize("layout", ["two_files", "merged", "diffusers"])
def test_taesd_converts_as_jax(tmp_path, layout):
    sd = _upstream_taesd()
    if layout == "two_files":
        src = tmp_path / "taesd"
        src.mkdir()
        for tower in ("encoder", "decoder"):
            torch.save({k[len(tower) + 1:]: v for k, v in sd.items() if k.startswith(tower)},
                       src / f"taesd_{tower}.pth")
    elif layout == "merged":
        src = tmp_path / "taesd.pth"
        torch.save(sd, src)
    else:
        src = tmp_path / "diffusion_pytorch_model.safetensors"
        save_file({k.replace(".", ".layers.", 1): v.numpy() for k, v in sd.items()}, str(src))
    jax_convert.main(["taesd", "--src", str(src), "--dst", str(tmp_path / "jax")])
    convert_checkpoint.main(["taesd", "--src", str(src), "--dst", str(tmp_path / "port")])
    _assert_same_tree(tmp_path / "port" / "params.msgpack", tmp_path / "jax" / "params.msgpack")


def test_load_taesd_equals_jax_and_needs_every_tensor():
    sd = _upstream_taesd()
    target = fast_init(JaxTiny(), jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    want = _leaves(jax_load_taesd({k: v.numpy() for k, v in sd.items()}, target))
    tiny = build_module(AutoencoderTiny, CPU, torch.float32)
    got = _leaves(tree_from_module(load_taesd(tiny, sd), "tiny_vae"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    with pytest.raises(KeyError, match="missing taesd tensor"):
        load_taesd(tiny, {k: v for k, v in sd.items() if k != "decoder.1.bias"})
