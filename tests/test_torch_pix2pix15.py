"""InstructPix2Pix at SD-1.5 geometry against the JAX package, tiny, f32, on
the CPU.

The public instruct-pix2pix model is SD-1.5's UNet with 8 input channels:
JAX builds it as ``SDPix2PixPipeline(unet_cfg=UNetConfig.sd15(in_channels=8),
text_cfg=CLIPTextConfig.sd15())``, the port as
``eval/main_path.py::pix2pix15_pipeline`` (``variant="pix2pix15"``). Here a
tiny UNet keeps SD-1.5's traits: 8 input channels, 1x1-conv projections
(``use_linear_projection=False``) and the same number of heads at every
level (so the head dim grows with the width: 16 and 32), with the tiny CLIP
and KL-VAE of ``test_torch_pix2pix.py``. JAX's params come from
``fast_init`` and cross through the port's converter. At 32x32 images the
256-token self-attentions take the packed path (JAX's Pallas kernel in
interpret mode, the port's plain B1 here; B2a/B2b in the trainer's
backward). Tolerances: uint8 images within 1 level; losses within
``LOSS_RTOL`` and gradient norms within ``GRAD_NORM_RTOL`` relative; params
and EMA after two steps within ``PARAM_ATOL`` (Adam's first updates are ~lr
x sign(grad); ``test_torch_pix2pix.py`` gives the reason for each).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDPix2PixPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

import genima_torch.nn.layers as torch_layers
from genima_torch.diffusion import training
from genima_torch.diffusion.pipeline import SDPix2PixPipeline
from genima_torch.eval import main_path
from genima_torch.kernels import packed_attention as pa
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights.from_jax import state_dict_from_jax

IMAGE = 32  # 16x16 latents: level 0's 256-token self-attentions take the packed path
TRAIN_IMAGE = 16
STEPS = 2
BSZ = 2
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
DROPOUT, EMA_DECAY = 0.3, 0.5
# SD-1.5's traits at tiny widths: 8 input channels, conv projections, two
# heads at every level (head dims 16 and 32)
TINY_SD15 = dict(in_channels=8, use_linear_projection=False, num_heads=(2, 2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def jax_tiny_pipe():
    return JaxPipeline(unet_cfg=JaxUNetConfig.tiny(**TINY_SD15), vae_cfg=JaxVAEConfig.tiny_test(),
                       text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32)


def port_tiny_pipe():
    return SDPix2PixPipeline(unet_cfg=UNetConfig.tiny(**TINY_SD15), vae_cfg=VAEConfig.tiny_test(),
                             text_cfg=CLIPTextConfig.tiny(), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_params() -> dict:
    pipe = jax_tiny_pipe()
    h = IMAGE // pipe.vae_scale_factor
    key = jax.random.key(0)
    t, ctx = jnp.zeros((1,)), jnp.zeros((1, 77, pipe.text_cfg.hidden_size))
    cond, ids = jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 77), jnp.int32)
    return {
        "unet": fast_init(pipe.unet, key, jnp.zeros((1, h, h, 8)), t, ctx, seed=11)["params"],
        "vae": fast_init(pipe.vae, key, cond, key, seed=12)["params"],
        "text_encoder": fast_init(pipe.text_encoder, key, ids, seed=13)["params"],
    }


def test_pix2pix15_variant_is_sd15_with_eight_input_channels():
    """``variant="pix2pix15"`` builds what JAX's ``SDPix2PixPipeline`` with
    ``UNetConfig.sd15(in_channels=8)`` and ``CLIPTextConfig.sd15()`` holds
    (configs only: nothing is drawn)."""
    agent = main_path.VARIANTS["pix2pix15"]
    assert issubclass(agent, main_path.SDPix2PixAgent) and agent.SUBMODEL == "unet"
    pipe = agent.PIPELINE(device="cpu")
    want = JaxPipeline(unet_cfg=JaxUNetConfig.sd15(in_channels=8),
                       text_cfg=JaxCLIPConfig.sd15())
    for name in ("unet_cfg", "text_cfg", "vae_cfg"):
        got, ref = getattr(pipe, name), getattr(want, name)
        fields = set(vars(ref)) & set(vars(got))
        assert {k: vars(got)[k] for k in fields} == {k: vars(ref)[k] for k in fields}, name
    assert pipe.unet_cfg.in_channels == 8 and not pipe.unet_cfg.use_linear_projection
    assert pipe.unet_cfg.num_heads == (8, 8, 8, 8) and pipe.text_cfg.hidden_size == 768


def test_pix2pix15_generate_matches_jax(monkeypatch):
    """Two Euler steps with the conditioning image's latents beside the
    noisy ones, then the decode: uint8 within 1 level; the 256-token
    self-attentions routed to the packed wrapper as JAX routes them to its
    Pallas kernel."""
    jpipe, params = jax_tiny_pipe(), jax_params()
    pipe = port_tiny_pipe()
    port = pipe.params_from_jax(_np(params))
    rng = np.random.RandomState(16)
    cond = rng.randint(0, 256, (1, IMAGE, IMAGE, 3)).astype(np.uint8)
    latents = rng.randn(1, 16, 16, 4).astype(np.float32)
    ids = rng.randint(0, 1000, (1, 77)).astype(np.int32)
    want = jpipe.generate(params, jnp.asarray(cond), jpipe.encode_prompt(params, jnp.asarray(ids)),
                          jnp.asarray(latents), num_inference_steps=STEPS)
    routed = []

    def counting(q, k, v, num_heads):
        routed.append((q.shape[1], q.shape[2] // num_heads))
        return pa.packed_flash_attention(q, k, v, num_heads)

    monkeypatch.setattr(torch_layers, "packed_flash_attention", counting)
    got = pipe.generate(port, torch.from_numpy(cond), pipe.encode_prompt(port, ids),
                        torch.from_numpy(latents), num_inference_steps=STEPS)
    assert got.dtype == torch.uint8 and got.shape == (1, IMAGE, IMAGE, 3)
    diff = np.abs(got.numpy().astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1, f"target differs by {diff.max()} levels"
    # level 0 of the UNet (1 down + 2 up transformer blocks) each denoise step
    assert routed == [(256, 16)] * 3 * STEPS


def test_pix2pix15_trainer_two_steps_with_ema_match_jax():
    """Two steps of the whole-UNet fine-tune at SD-1.5's traits, with
    conditioning dropout 0.3 and EMA decay 0.5: each loss and gradient norm,
    then the params and the EMA."""
    jpipe, params = jax_tiny_pipe(), jax_params()
    null_ids = np.zeros((1, 77), np.int32)
    null_ids[0, :2] = (49406, 49407)
    jt = jax_training.Pix2PixTrainer(jpipe, jax_training.TrainConfig(), None,
                                     conditioning_dropout_prob=DROPOUT, use_ema=True,
                                     ema_decay=EMA_DECAY, null_token_ids=null_ids)
    state = jt.create_state(params)
    pipe = port_tiny_pipe()
    trainer = training.Pix2PixTrainer(pipe, training.TrainConfig(),
                                      conditioning_dropout_prob=DROPOUT, use_ema=True,
                                      ema_decay=EMA_DECAY, null_token_ids=null_ids)
    pstate = trainer.create_state(pipe.params_from_jax(_np(params)))
    shape = (BSZ, TRAIN_IMAGE // 2, TRAIN_IMAGE // 2, 4)
    for i in range(STEPS):
        rng = np.random.RandomState(50 + i)
        img = (BSZ, TRAIN_IMAGE, TRAIN_IMAGE, 3)
        batch = dict(pixel_values=rng.randint(0, 256, img).astype(np.uint8),
                     conditioning_pixel_values=rng.randint(0, 256, img).astype(np.uint8),
                     input_ids=rng.randint(0, 1000, (BSZ, 77)).astype(np.int32))
        key = jax.random.key(60 + i)
        k_noise, k_t, k_sample, k_drop = jax.random.split(key, 4)
        draws = training.Draws(
            sample_noise=torch.from_numpy(np.array(jax.random.normal(k_sample, shape))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
            timesteps=torch.from_numpy(np.array(
                jax_training.sample_train_timesteps(jt.cfg, k_t, BSZ))).long(),
            random_p=torch.from_numpy(np.array(jax.random.uniform(k_drop, (BSZ,)))),
        )
        state, want = jt.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        pstate, got = trainer.step_with_draws(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
    for name, tree in (("params", state.params), ("ema", state.ema)):
        got = getattr(pstate, name)
        for k, v in state_dict_from_jax(_np(tree), "diffusers_unet").items():
            np.testing.assert_allclose(got[k].numpy(), v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} {k}")
    lag = max(float((pstate.ema[k] - pstate.params[k]).abs().max()) for k in pstate.ema)
    assert lag > 0  # the EMA trails the params
