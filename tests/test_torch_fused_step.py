"""The port's fused control step against the JAX one, tiny config, on CPU.

Same weights (carried across by the port's converter), same numpy inputs.
At resolution 64 the tiny latents are 32x32, so the JAX side sends its
1024- and 256-token self-attentions through the Pallas packed kernel in
interpret mode; the port sends the same attentions to its packed wrapper,
which on the CPU runs the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.control.policy import GenimaACTAgent as JaxACTAgent
from genima_tpu.data.tiling import untile_to_cameras
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.eval.agents import SDControlNetAgent as JaxSDAgent
from genima_tpu.eval.fused import FusedGenimaStep as JaxFusedStep
from genima_tpu.nn.act import ACTConfig as JaxACTConfig
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

import genima_torch.nn.layers as torch_layers
from genima_torch.control.policy import GenimaACTAgent
from genima_torch.data.tiling import untile_to_cameras as torch_untile
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval.agents import SDControlNetAgent, make_tiny_sd_agent
from genima_torch.eval.fused import FusedGenimaStep
from genima_torch.kernels.packed_attention import packed_flash_attention
from genima_torch.nn.act import ACTConfig
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

STEPS = 2
ACTION_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return dict(
        tiled=rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8),
        latents=rng.randn(1, 32, 32, 4).astype(np.float32),
        qpos=rng.randn(1, 8).astype(np.float32),
        prompt_ids=rng.randint(0, 1000, (1, 77)).astype(np.int32),
        lang_ids=rng.randint(0, 1000, (1, 77)).astype(np.int32),
    )


@pytest.fixture(scope="module")
def jax_side(inputs):
    pipe = JaxPipeline(
        unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
        text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32,
    )
    dag = JaxSDAgent(pipe=pipe, resolution=64, dtype=jnp.float32)
    # the ControlNet's zero convs start at zero; randomise them so its
    # residuals shape the output
    rng = np.random.RandomState(5)
    cn = dict(dag.params["controlnet"])
    for k in cn:
        if k.startswith("controlnet_"):
            cn[k] = jax.tree_util.tree_map(
                lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1),
                cn[k],
            )
    dag.params["controlnet"] = cn
    agent = JaxACTAgent(
        act_cfg=JaxACTConfig.tiny(num_queries=6),
        clip_cfg=JaxCLIPConfig.tiny(projection_dim=16),
        image_size=32, resnet_width=8, num_views=4, data_augmentation=False,
    )
    params, clip_p = agent.init_params(jax.random.key(0))
    # FiLM projections start at zero (identity); randomise them too
    enc = params["encoder"]["backbone"]
    for k in [k for k in enc if k.startswith("film")]:
        enc[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), enc[k]
        )
    agent.create_state(params, clip_p)
    embeds = pipe.encode_prompt(dag.params, jnp.asarray(inputs["prompt_ids"]))
    fused = JaxFusedStep(dag, agent, obs_size=32)
    actions, target = fused(
        dag.params, params, clip_p, jnp.asarray(inputs["tiled"]), embeds,
        jnp.asarray(inputs["latents"]), jnp.asarray(inputs["qpos"]),
        jnp.asarray(inputs["lang_ids"]), num_inference_steps=STEPS,
    )
    def act_on(target_u8):
        # the reference controller on a given target, as the fused step feeds it
        cams = untile_to_cameras(jnp.asarray(target_u8, jnp.float32), target_size=32)
        images = jnp.transpose(cams, (1, 0, 2, 3, 4)).reshape(1, 4, 32, 32, 3)
        return np.asarray(agent.act(
            params, images, jnp.asarray(inputs["qpos"]), jnp.asarray(inputs["lang_ids"])
        ))

    return dict(
        diffusion=_np_tree(dag.params), act=_np_tree(params), clip=_np_tree(clip_p),
        embeds=np.asarray(embeds), actions=np.asarray(actions),
        target=np.asarray(target), act_on=act_on,
    )


@pytest.fixture(scope="module")
def port(jax_side):
    pipe = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), device="cpu",
    )
    dag = SDControlNetAgent(pipe, params=pipe.params_from_jax(jax_side["diffusion"]))
    agent = GenimaACTAgent(
        act_cfg=ACTConfig.tiny(num_queries=6),
        clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
        resnet_width=8, device="cpu",
    )
    params, clip = agent.params_from_jax(jax_side["act"], jax_side["clip"])
    return dag, agent, params, clip


def _run_port(port, inputs):
    dag, agent, params, clip = port
    step = FusedGenimaStep(dag, agent, obs_size=32)
    embeds = dag.embed_prompt_ids(inputs["prompt_ids"])
    return step(
        dag.params, params, clip, torch.from_numpy(inputs["tiled"]), embeds,
        torch.from_numpy(inputs["latents"]), torch.from_numpy(inputs["qpos"]),
        torch.from_numpy(inputs["lang_ids"]), num_inference_steps=STEPS,
    )


def test_prompt_embeds_match(port, jax_side, inputs):
    embeds = port[0].embed_prompt_ids(inputs["prompt_ids"])
    np.testing.assert_allclose(embeds.numpy(), jax_side["embeds"], atol=1e-4)
    # the cache hands back the same tensor for the same ids
    assert port[0].embed_prompt_ids(inputs["prompt_ids"]) is embeds


def test_fused_step_matches_jax(port, jax_side, inputs):
    actions, target = _run_port(port, inputs)
    assert target.dtype == torch.uint8 and target.shape == (1, 64, 64, 3)
    assert actions.shape == (1, 6, 8)
    diff = np.abs(target.numpy().astype(int) - jax_side["target"].astype(int))
    assert diff.max() <= 1, f"target differs by {diff.max()} LSB"
    # f32 rounding lets a few pixels that sit on a .5 boundary round the
    # other way, and one such pixel moves these random-weight actions by
    # ~2e-4; so the actions are held to the reference controller run on the
    # very target the port produced
    np.testing.assert_allclose(
        actions.numpy(), jax_side["act_on"](target.numpy()), atol=ACTION_ATOL
    )


def test_fused_step_routes_long_self_attention_to_the_kernel(port, inputs, monkeypatch):
    """Per denoise step the tiny config sends 6 self-attentions to the packed
    wrapper (UNet 32x32 level: 1 down + 2 up, mid 16x16: 1; ControlNet: 1
    down + 1 mid), as the reference routes them to its Pallas kernel. On the
    CPU no kernel launches."""
    calls = []

    def counting(q, k, v, num_heads):
        calls.append(q.shape[1])
        return packed_flash_attention(q, k, v, num_heads)

    monkeypatch.setattr(torch_layers, "packed_flash_attention", counting)
    before = packed_flash_attention.launches
    _run_port(port, inputs)
    assert sorted(calls) == sorted([1024] * 4 * STEPS + [256] * 2 * STEPS)
    assert packed_flash_attention.launches == before


def test_generate_then_act_matches_fused_step(port, inputs):
    """The staged path (generate, untile, act) gives the fused step's result."""
    dag, agent, params, clip = port
    actions, target = _run_port(port, inputs)
    embeds = dag.embed_prompt_ids(inputs["prompt_ids"])
    target2 = dag.pipe.generate(
        dag.params, torch.from_numpy(inputs["tiled"]), embeds,
        torch.from_numpy(inputs["latents"]), num_inference_steps=STEPS,
    )
    assert torch.equal(target, target2)
    cams = torch_untile(target2.float(), 32).transpose(0, 1).reshape(1, 4, 32, 32, 3)
    actions2 = agent.act(params, cams, torch.from_numpy(inputs["qpos"]),
                         torch.from_numpy(inputs["lang_ids"]))
    torch.testing.assert_close(actions, actions2, atol=1e-6, rtol=0)


def test_tiny_agent_random_init_is_seeded_and_runs():
    """make_tiny_sd_agent draws its weights from a seeded generator."""
    a, b = make_tiny_sd_agent(device="cpu", seed=3), make_tiny_sd_agent(device="cpu", seed=3)
    for k in a.params:
        for (n, x), (_, y) in zip(a.params[k].state_dict().items(),
                                  b.params[k].state_dict().items()):
            assert torch.equal(x, y), n
    ids = np.zeros((1, 77), np.int64)
    out = a.fused_generate(
        a.params, torch.zeros(1, 64, 64, 3, dtype=torch.uint8),
        a.embed_prompt_ids(ids), torch.zeros(1, 32, 32, 4), None,
        num_inference_steps=1,
    )
    assert out.shape == (1, 64, 64, 3) and out.dtype == torch.uint8


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        make_tiny_sd_agent()
