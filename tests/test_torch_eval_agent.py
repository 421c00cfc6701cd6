"""The port's diffusion agent and controller against the JAX package's, on
checkpoints the JAX package writes.

- ``SDControlNetAgent._load_params``: the seeded init, the ``sd_ckpt`` base
  trees over it, then the ControlNet that ``find_model_checkpoint`` picks in
  a JAX-written ``checkpoint-<step>/`` tree, f32 and bf16 -> the port's
  modules hold exactly those trees (the bf16 one bit for bit).
- the prompt cache, per-episode latents and ``infer`` with CFG.
- ``build_agent`` from a train config (``use_onehot_time``, frame stacks)
  gives the JAX agent's parameter shapes, and the OpenAI CLIP text file
  loads as JAX's ``load_openai_clip_text`` loads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.cli.train_act import build_agent as jax_build_agent
from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.core.config import Config as JaxConfig
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig
from genima_tpu.weights.torch_port import load_openai_clip_text as jax_load_openai_clip

from genima_torch.cli.eval_genima import load_eval_clip
from genima_torch.control.policy import build_agent
from genima_torch.core.config import Config
from genima_torch.eval.agents import make_tiny_sd_agent
from genima_torch.weights.from_jax import state_dict_from_jax
from genima_torch.weights.init import build_module
from genima_torch.nn.clip_text import CLIPTextModel

FAMILIES = {"unet": "diffusers_unet", "controlnet": "diffusers_controlnet",
            "text_encoder": "hf_clip"}


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), tree)


def _redrawn(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_trees():
    pipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                       text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32)
    params = _np(pipe.init_params(jax.random.key(0), 64))
    return {"base": {k: _redrawn(params[k], i) for i, k in enumerate(("unet", "text_encoder"))},
            "controlnet": _redrawn(params["controlnet"], 7)}


def _assert_module_holds(module, tree, family, dtype=torch.float32):
    want = state_dict_from_jax(tree, family)
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        assert torch.equal(got[k], v.to(dtype)), k


def test_agent_loads_jax_checkpoints(tmp_path, jax_trees):
    jax_ckpt.save_final_model(tmp_path / "sd", jax_trees["base"])
    for step in (5, 12):  # the latest checkpoint-<step> wins
        tree = jax_trees["controlnet"] if step == 12 else _redrawn(jax_trees["controlnet"], step)
        jax_ckpt.save_step_checkpoint(tmp_path / "out", step, model_params=tree)
    agent = make_tiny_sd_agent(device="cpu", sd_ckpt=None, diffusion_ckpt=str(tmp_path / "out"))
    _assert_module_holds(agent.params["controlnet"], jax_trees["controlnet"],
                         FAMILIES["controlnet"])
    # the seeded init is the same with and without a checkpoint, below it
    fresh = make_tiny_sd_agent(device="cpu")
    for name in ("unet", "vae", "text_encoder"):
        for (k, x), (_, y) in zip(agent.params[name].state_dict().items(),
                                  fresh.params[name].state_dict().items()):
            assert torch.equal(x, y), (name, k)


def test_agent_overlays_sd_ckpt_base_trees(tmp_path, jax_trees):
    """sd_ckpt's params.msgpack subtrees replace the seeded init (the tiny
    agent drops sd_ckpt as JAX's does, so the full agent's loader is used on
    a tiny pipeline here)."""
    from genima_torch.diffusion.pipeline import SDControlNetPipeline
    from genima_torch.eval.agents import SDControlNetAgent
    from genima_torch.nn.clip_text import CLIPTextConfig
    from genima_torch.nn.unet import UNetConfig
    from genima_torch.nn.vae import VAEConfig

    jax_ckpt.save_final_model(tmp_path / "sd", jax_trees["base"])
    pipe = SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), device="cpu")
    agent = SDControlNetAgent(pipe=pipe, sd_ckpt=str(tmp_path / "sd"), resolution=64)
    for name, tree in jax_trees["base"].items():
        _assert_module_holds(agent.params[name], tree, FAMILIES[name])


def test_agent_loads_a_bf16_checkpoint_bit_for_bit(tmp_path, jax_trees):
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), jax_trees["controlnet"])
    jax_ckpt.save_step_checkpoint(tmp_path, 1, model_params=bf16)
    agent = make_tiny_sd_agent(device="cpu", diffusion_ckpt=str(tmp_path))
    want = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(torch.bfloat16)
            for k, v in state_dict_from_jax(_np(bf16, jnp.bfloat16), "diffusers_controlnet")
            .items()}
    got = agent.params["controlnet"].state_dict()
    for k, v in want.items():
        assert torch.equal(got[k].to(torch.bfloat16), v), k


def test_prompt_cache_latents_and_cfg_infer():
    agent = make_tiny_sd_agent(device="cpu", seed=4)
    e = agent._embed_prompts(["a", "a"])
    assert agent._embed_prompts(["a", "a"]) is e and e.shape == (2, 77, 32)
    agent.new_episode()
    first = agent._next_latents(2)
    second = agent._next_latents(1)
    agent.new_episode()  # the same stream again each episode
    assert torch.equal(agent._next_latents(2), first)
    assert first.shape == (2, 32, 32, 4) and not torch.equal(first[:1], second)
    images = np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    out = agent.infer(images, ["x"], ["y"], num_inference_steps=1, guidance_scale=2.0)
    assert out.shape == (1, 64, 64, 3) and out.dtype == np.uint8
    # autoencoder="taesd": the pipeline decodes with its tiny VAE
    taesd = make_tiny_sd_agent(device="cpu", seed=4, autoencoder="taesd")
    assert taesd.pipe.use_tiny_vae and "tiny_vae" in taesd.params
    plain = make_tiny_sd_agent(device="cpu", seed=4)
    outs = [a.infer(images, ["x"], num_inference_steps=1) for a in (taesd, plain)]
    assert outs[0].shape == (1, 64, 64, 3) and outs[0].dtype == np.uint8
    assert not np.array_equal(outs[0], outs[1])


TRAIN_CFG = {
    "frame_stack": 2, "use_onehot_time": True, "action_sequence": 6,
    "env": {"episode_length": 12},
    "method": {
        "_target_": "genima_tpu.control.policy.GenimaACTAgent", "lr": 5e-05,
        "lr_backbone": 1e-05, "weight_decay": 0.0001, "actor_grad_clip": None,
        "num_views": 4, "frame_stack": 2, "image_size": 32, "data_augmentation": False,
        "resnet_width": 8,
        "act_cfg": {"hidden_dim": 32, "enc_layers": 1, "dec_layers": 1, "dim_feedforward": 64,
                    "dropout": 0.1, "nheads": 2, "num_queries": 6, "state_dim": 8,
                    "action_dim": 8, "latent_dim": 8, "kl_weight": 10.0, "use_lang_cond": True,
                    "lang_dim": 16},
    },
}


def test_build_agent_matches_jax_parameter_shapes():
    jagent = jax_build_agent(JaxConfig.from_dict(TRAIN_CFG))
    params, _ = jagent.init_params(jax.random.key(0))
    agent = build_agent(Config.from_dict(TRAIN_CFG), device="cpu")
    # proprio input: (state_dim + episode_length) x frame_stack
    assert agent.act_cfg.state_dim == 8 + 12 and agent.frame_stack == 2
    port = agent.load_params(jax.tree_util.tree_map(np.asarray, params))
    assert port["actor"].proprio_proj_0.weight.shape == (32, 40)
    with pytest.raises(TypeError):
        build_agent(Config.from_dict({**TRAIN_CFG, "method": {**TRAIN_CFG["method"],
                                                              "unknown": 1}}), device="cpu")


def _openai_clip_state_dict(cfg: JaxCLIPConfig, seed: int) -> dict:
    """An OpenAI-CLIP-format state dict for a (tiny) text tower, with a
    visual tower and logit scale that loading must drop."""
    rng = np.random.RandomState(seed)
    d, ff = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    sd = {"token_embedding.weight": r(cfg.vocab_size, d), "positional_embedding": r(77, d),
          "ln_final.weight": r(d), "ln_final.bias": r(d), "text_projection": r(d, 16),
          "logit_scale": r(1)[0], "visual.proj": r(4, 4)}
    for i in range(cfg.num_layers):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "attn.in_proj_weight": r(3 * d, d), p + "attn.in_proj_bias": r(3 * d),
                   p + "attn.out_proj.weight": r(d, d), p + "attn.out_proj.bias": r(d),
                   p + "ln_1.weight": r(d), p + "ln_1.bias": r(d), p + "ln_2.weight": r(d),
                   p + "ln_2.bias": r(d), p + "mlp.c_fc.weight": r(ff, d),
                   p + "mlp.c_fc.bias": r(ff), p + "mlp.c_proj.weight": r(d, ff),
                   p + "mlp.c_proj.bias": r(d)})
    return sd


def test_openai_clip_file_loads_as_in_jax(tmp_path):
    from genima_tpu.control.policy import GenimaACTAgent as JaxACTAgent
    from genima_tpu.nn.act import ACTConfig as JaxACTConfig

    jcfg = JaxCLIPConfig.tiny(projection_dim=16)
    sd = _openai_clip_state_dict(jcfg, 0)
    torch.save(sd, tmp_path / "clip.pt")
    jagent = JaxACTAgent(act_cfg=JaxACTConfig.tiny(), clip_cfg=jcfg, image_size=32,
                         resnet_width=8)
    _, clip_template = jagent.init_params(jax.random.key(0))
    want = jax_load_openai_clip({k: v.numpy() for k, v in sd.items()}, clip_template)

    agent = build_agent(Config.from_dict({**TRAIN_CFG, "use_onehot_time": False}), device="cpu")
    agent.clip_cfg = type(agent.clip_cfg).tiny(projection_dim=16)
    agent.clip_params = build_module(lambda: CLIPTextModel(agent.clip_cfg),
                                     torch.device("cpu"), torch.float32)
    load_eval_clip(Config(clip_weights=str(tmp_path / "clip.pt")), None, agent)
    got = agent.clip_params.state_dict()
    for k, v in state_dict_from_jax(_np(want), "hf_clip").items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
