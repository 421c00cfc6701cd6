"""The port's InstructPix2Pix variant, tiny VAE and conv-projection
transformers against the JAX package, tiny, f32, on the CPU.

The JAX side uses the widths of ``genima_tpu/eval/agents.py::make_tiny_pix2pix_agent``
(UNet 32/64 channels with 8 input channels, the tiny CLIP, the tiny KL-VAE)
and a taesd of one level (one per VAE downsample); its params are made by
``fast_init`` (no init program is compiled) and carried to the port by the
port's converter. Random draws are inputs in the port: the JAX key's draws
are handed to it. Tolerances: module outputs within ``MODEL_RTOL`` of max
|y|, uint8 images within 1 level, losses within ``LOSS_RTOL`` relative,
params and EMA after two steps within ``PARAM_ATOL``. At 32x32 images the
latents are 16x16, so the 256-token self-attentions take the packed path
(the Pallas kernels in interpret mode on the JAX side, the plain versions
of the port's wrappers here); the trainers run at 16x16 images.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.core.init_utils import fast_init
from genima_tpu.diffusion import pretrain as jax_pretrain
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxSDPipeline
from genima_tpu.diffusion.pipeline import SDPix2PixPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.layers import Transformer2DModel as JaxTransformer
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import AutoencoderTiny as JaxTiny
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

from genima_torch.core import checkpoint as ckpt
from genima_torch.diffusion import driver, pretrain, training
from genima_torch.diffusion.pipeline import SDControlNetPipeline, SDPix2PixPipeline
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.layers import Transformer2DModel
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.nn.vae import AutoencoderTiny, VAEConfig
from genima_torch.weights.from_jax import load_from_jax, state_dict_from_jax
from genima_torch.weights.init import build_module
from genima_torch.weights.quantize import quantize_dense_tree
from genima_torch.weights.to_jax import tree_from_module

IMAGE = 32  # 16x16 latents: the 256-token self-attentions take the packed path
TRAIN_IMAGE = 16
STEPS = 2
BSZ = 2
MODEL_RTOL = 1e-4  # f32 forward of a model, error / max |output|
LOSS_RTOL = 1e-5
# params and EMA after two steps at the trainers' default learning rate
# (1e-5, as the SDXL trainer's test): Adam's first updates are ~lr x
# sign(grad), so an element whose gradient is at the f32 rounding level
# (~1e-7 here, against gradients up to ~0.1) may step either way; the
# gradients themselves are held by their global norm
PARAM_ATOL = 1e-5
GRAD_NORM_RTOL = 1e-4
DROPOUT, EMA_DECAY = 0.3, 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def jax_tiny_pipe(**kw):
    """``make_tiny_pix2pix_agent``'s pipeline."""
    return JaxPipeline(unet_cfg=JaxUNetConfig.tiny(in_channels=8),
                       vae_cfg=JaxVAEConfig.tiny_test(), text_cfg=JaxCLIPConfig.tiny(),
                       dtype=jnp.float32, **kw)


def port_tiny_pipe(**kw):
    """The same widths in the port (``eval.agents.make_tiny_pix2pix_agent``'s)."""
    return SDPix2PixPipeline(unet_cfg=UNetConfig.tiny(in_channels=8),
                             vae_cfg=VAEConfig.tiny_test(), text_cfg=CLIPTextConfig.tiny(),
                             device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def jax_fast_params() -> dict:
    """The tiny pix2pix pipeline's trees by ``fast_init``, a one-level taesd
    and a tiny ControlNet-SD UNet/ControlNet pair for the SD pipeline, made
    once a process: copy the top-level dict before replacing a model."""
    pipe = jax_tiny_pipe(use_tiny_vae=True)
    sd = JaxSDPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                       text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32, use_tiny_vae=True)
    h = IMAGE // pipe.vae_scale_factor
    key = jax.random.key(0)
    t, ctx = jnp.zeros((1,)), jnp.zeros((1, 77, pipe.text_cfg.hidden_size))
    cond, ids = jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 77), jnp.int32)
    lat4 = jnp.zeros((1, h, h, 4))
    return {
        "unet": fast_init(pipe.unet, key, jnp.zeros((1, h, h, 8)), t, ctx, seed=1)["params"],
        "vae": fast_init(pipe.vae, key, cond, key, seed=3)["params"],
        "text_encoder": fast_init(pipe.text_encoder, key, ids, seed=4)["params"],
        "tiny_vae": fast_init(pipe.tiny_vae, key, cond, seed=7)["params"],
        "sd_unet": fast_init(sd.unet, key, lat4, t, ctx, seed=5)["params"],
        "sd_controlnet": fast_init(sd.controlnet, key, lat4, t, ctx, cond, seed=6,
                                   zero_prefixes=())["params"],
    }


def _pix2pix_trees() -> dict:
    p = jax_fast_params()
    return {k: p[k] for k in ("unet", "vae", "text_encoder", "tiny_vae")}


# -- configs and modules -----------------------------------------------------------------


def _cfg_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("sample_size", None)  # flax's init shape; the port builds no sample
    return {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in d.items()}


@pytest.mark.parametrize("name", ["sd21", "sd15", "sdxl", "pix2pix"])
def test_unet_configs_mirror_jax(name):
    assert _cfg_dict(getattr(UNetConfig, name)()) == _cfg_dict(getattr(JaxUNetConfig, name)())


def test_conv_projection_transformer_matches_jax():
    """``use_linear_projection=False``: 1x1-conv proj_in / proj_out, whose
    4-D kernels cross both converters; ``+w8`` leaves them in float."""
    jmodel = JaxTransformer(in_channels=32, heads=2, cross_attention_dim=24,
                            use_linear_projection=False)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    ctx = rng.randn(2, 77, 24).astype(np.float32)
    tree = _np(fast_init(jmodel, jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx),
                         seed=3)["params"])
    assert tree["proj_in"]["kernel"].shape == (1, 1, 32, 32)
    want = jax.jit(jmodel.apply)({"params": tree}, jnp.asarray(x), jnp.asarray(ctx))
    model = build_module(lambda: Transformer2DModel(32, 2, 24, use_linear_projection=False),
                         "cpu", torch.float32)
    load_from_jax(model, tree, "diffusers_unet")
    assert isinstance(model.proj_in, torch.nn.Conv2d)
    with torch.no_grad():
        got = _nhwc(model(_nchw(x), torch.from_numpy(ctx)))
    assert _rel(got, want) <= MODEL_RTOL
    back = tree_from_module(model, "diffusers_unet")
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    quantize_dense_tree(model)
    assert isinstance(model.proj_in, torch.nn.Conv2d) and isinstance(model.proj_out,
                                                                     torch.nn.Conv2d)
    assert type(model.transformer_blocks[0].attn1.to_q).__name__ == "W8Linear"


def test_unet_without_linear_projection_matches_jax():
    cfg = dict(num_heads=(2, 4), use_linear_projection=False)
    jmodel = JaxUNet(JaxUNetConfig.tiny(**cfg), dtype=jnp.float32)
    rng = np.random.RandomState(2)
    lat = rng.randn(BSZ, 8, 8, 4).astype(np.float32)
    t = np.array([999.0, 3.0], np.float32)
    ctx = rng.randn(BSZ, 77, 32).astype(np.float32)
    tree = _np(fast_init(jmodel, jax.random.key(0), jnp.asarray(lat), jnp.asarray(t),
                         jnp.asarray(ctx), seed=8)["params"])
    want = jax.jit(jmodel.apply)({"params": tree}, jnp.asarray(lat), jnp.asarray(t),
                                 jnp.asarray(ctx))
    model = build_module(lambda: UNet2DConditionModel(UNetConfig.tiny(**cfg)), "cpu",
                         torch.float32)
    load_from_jax(model, tree, "diffusers_unet")
    with torch.no_grad():
        got = _nhwc(model(_nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx)))
    assert _rel(got, want) <= MODEL_RTOL


def test_tiny_vae_encode_and_decode_match_jax():
    tree = _np(jax_fast_params()["tiny_vae"])
    jmodel = JaxTiny(n_levels=1)
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (BSZ, IMAGE, IMAGE, 3)).astype(np.float32)
    z = (rng.randn(BSZ, 16, 16, 4) * 4).astype(np.float32)  # past the tanh clamp's knee
    jz, jx = jax.jit(lambda p, x, z: (jmodel.apply(p, x, method=jmodel.encode),
                                      jmodel.apply(p, z, method=jmodel.decode)))(
        {"params": tree}, jnp.asarray(x), jnp.asarray(z))
    model = build_module(lambda: AutoencoderTiny(n_levels=1), "cpu", torch.float32)
    load_from_jax(model, tree, "tiny_vae")
    with torch.no_grad():
        assert _rel(_nhwc(model.encode(_nchw(x))), jz) <= MODEL_RTOL
        assert _rel(_nhwc(model.decode(_nchw(z))), jx) <= MODEL_RTOL
    back = tree_from_module(model, "tiny_vae")
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


# -- sampling ------------------------------------------------------------------------------


def _assert_within_one_level(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.uint8 and tuple(got.shape) == np.asarray(want).shape
    diff = np.abs(got.numpy().astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1


def test_pix2pix_generate_matches_jax():
    """Two Euler steps with the conditioning image's latents beside the
    noisy ones, then the decode: uint8 within 1 level. (The tiny-VAE decode
    is held on the ControlNet pipeline below.)"""
    jpipe = jax_tiny_pipe()
    params = {k: v for k, v in _pix2pix_trees().items() if k != "tiny_vae"}
    pipe = port_tiny_pipe()
    port = pipe.params_from_jax(_np(params))
    assert sorted(port) == sorted(params)
    rng = np.random.RandomState(6)
    cond = rng.randint(0, 256, (1, IMAGE, IMAGE, 3)).astype(np.uint8)
    latents = rng.randn(1, 16, 16, 4).astype(np.float32)
    ids = rng.randint(0, 1000, (1, 77)).astype(np.int32)
    embeds = jpipe.encode_prompt(params, jnp.asarray(ids))
    want = jpipe.generate(params, jnp.asarray(cond), embeds, jnp.asarray(latents),
                          num_inference_steps=STEPS)
    pe = pipe.encode_prompt(port, ids)
    got = pipe.generate(port, torch.from_numpy(cond), pe, torch.from_numpy(latents),
                        num_inference_steps=STEPS)
    _assert_within_one_level(got, want)
    other = pipe.generate(port, torch.from_numpy(255 - cond), pe, torch.from_numpy(latents),
                          num_inference_steps=STEPS)
    assert not torch.equal(other, got)  # the conditioning image reaches the sample


def test_sd_pipeline_decodes_with_the_tiny_vae_like_jax():
    """``use_tiny_vae`` on the ControlNet pipeline: the whole generate,
    decoded by the tiny VAE on scaled latents, within 1 level of JAX's."""
    fp = jax_fast_params()
    params = {"unet": fp["sd_unet"], "controlnet": fp["sd_controlnet"], "vae": fp["vae"],
              "text_encoder": fp["text_encoder"], "tiny_vae": fp["tiny_vae"]}
    jpipe = JaxSDPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                          text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32, use_tiny_vae=True)
    pipe = SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), device="cpu", use_tiny_vae=True)
    port = pipe.params_from_jax(_np(params))
    rng = np.random.RandomState(8)
    cond = rng.randint(0, 256, (1, IMAGE, IMAGE, 3)).astype(np.uint8)
    latents = rng.randn(1, 16, 16, 4).astype(np.float32)
    ids = rng.randint(0, 1000, (1, 77)).astype(np.int32)
    want = jpipe.generate(params, jnp.asarray(cond), jpipe.encode_prompt(params, jnp.asarray(ids)),
                          jnp.asarray(latents), num_inference_steps=STEPS)
    got = pipe.generate(port, torch.from_numpy(cond), pipe.encode_prompt(port, ids),
                        torch.from_numpy(latents), num_inference_steps=STEPS)
    _assert_within_one_level(got, want)
    # the random init appends the tiny VAE: the other models draw as before
    plain = SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                 text_cfg=CLIPTextConfig.tiny(), device="cpu")
    a = pipe.init_params(torch.Generator().manual_seed(1))
    b = plain.init_params(torch.Generator().manual_seed(1))
    assert list(a) == [*b, "tiny_vae"]
    assert torch.equal(a["text_encoder"].state_dict()["text_model.final_layer_norm.weight"],
                       b["text_encoder"].state_dict()["text_model.final_layer_norm.weight"])
    assert all(torch.equal(v, b["vae"].state_dict()[k]) for k, v in a["vae"].state_dict().items())


# -- the trainers --------------------------------------------------------------------------


def _train_batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    shape = (BSZ, TRAIN_IMAGE, TRAIN_IMAGE, 3)
    return dict(pixel_values=rng.randint(0, 256, shape).astype(np.uint8),
                conditioning_pixel_values=rng.randint(0, 256, shape).astype(np.uint8),
                input_ids=rng.randint(0, 1000, (BSZ, 77)).astype(np.int32))


def test_pix2pix_trainer_two_steps_match_jax():
    """Two steps of the whole-UNet fine-tune with conditioning dropout 0.3
    (random_p drawn so that one step drops a prompt and another an image)
    and EMA decay 0.5: each loss, then the params and the EMA."""
    jpipe = jax_tiny_pipe()
    params = {k: v for k, v in _pix2pix_trees().items() if k != "tiny_vae"}
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
    assert sorted(trainer.frozen) == ["text_encoder", "vae"] and pstate.ema is not None
    shape = (BSZ, TRAIN_IMAGE // 2, TRAIN_IMAGE // 2, 4)
    dropped = {"prompt": 0, "image": 0}
    for i in range(STEPS):
        batch = _train_batch(30 + i)
        key = jax.random.key(40 + i)
        k_noise, k_t, k_sample, k_drop = jax.random.split(key, 4)
        random_p = np.array(jax.random.uniform(k_drop, (BSZ,)))
        dropped["prompt"] += int((random_p < 2 * DROPOUT).sum())
        dropped["image"] += int(((random_p >= DROPOUT) & (random_p < 3 * DROPOUT)).sum())
        draws = training.Draws(
            sample_noise=torch.from_numpy(np.array(jax.random.normal(k_sample, shape))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
            timesteps=torch.from_numpy(np.array(
                jax_training.sample_train_timesteps(jt.cfg, k_t, BSZ))).long(),
            random_p=torch.from_numpy(random_p),
        )
        state, want = jt.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        pstate, got = trainer.step_with_draws(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
    assert dropped["prompt"] and dropped["image"]  # both dropout branches ran
    for name, tree in (("params", state.params), ("ema", state.ema)):
        got = getattr(pstate, name)
        for k, v in state_dict_from_jax(_np(tree), "diffusers_unet").items():
            np.testing.assert_allclose(got[k].numpy(), v, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} {k}")
    init = state_dict_from_jax(_np(params["unet"]), "diffusers_unet")
    moved = max(float((pstate.params[k] - torch.from_numpy(v)).abs().max())
                for k, v in init.items())
    lag = max(float((pstate.ema[k] - pstate.params[k]).abs().max()) for k in pstate.ema)
    assert moved > 0 and lag > 0  # the params moved and the EMA trails them


def test_tiny_vae_distiller_two_steps_and_psnr_match_jax():
    jpipe = jax_tiny_pipe(use_tiny_vae=True)
    params = _pix2pix_trees()
    jd = jax_pretrain.TinyVAEDistiller(jpipe, jax_training.TrainConfig())
    state = jd.create_state(params)
    pipe = port_tiny_pipe(use_tiny_vae=True)
    port = pipe.params_from_jax(_np(params))
    distiller = pretrain.TinyVAEDistiller(pipe, training.TrainConfig())
    pstate = distiller.create_state(port)
    for i in range(STEPS):
        batch = _train_batch(50 + i)
        state, want = jd.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.key(i))
        pstate, got = distiller.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
    for k, v in state_dict_from_jax(_np(state.params), "tiny_vae").items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
    images = _train_batch(60)["pixel_values"]
    distiller.sync_working_copy(pstate)
    want = jax_pretrain.tiny_vae_decode_psnr(jpipe, {**params, "tiny_vae": state.params}, images)
    got = pretrain.tiny_vae_decode_psnr(pipe, port, images)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(ValueError, match="tiny_vae"):
        pretrain.TinyVAEDistiller(pipe, training.TrainConfig()).create_state(
            {k: v for k, v in port.items() if k != "tiny_vae"})


# -- EMA checkpoints across the packages ---------------------------------------------------


def test_ema_checkpoint_files_cross_the_packages(tmp_path):
    """The port's step checkpoint with ``ema.msgpack`` loads in JAX's
    ``load_pytree`` against its EMA tree; a JAX one resumes the port's EMA."""
    params = {k: v for k, v in _pix2pix_trees().items() if k != "tiny_vae"}
    pipe = port_tiny_pipe()
    trainer = training.Pix2PixTrainer(pipe, training.TrainConfig(), use_ema=True)
    state = trainer.create_state(pipe.params_from_jax(_np(params)))
    gen = torch.Generator().manual_seed(0)
    for k in state.ema:
        state.ema[k].normal_(generator=gen)
    model_tree, state_tree = driver.checkpoint_trees(trainer, state)
    d = ckpt.save_step_checkpoint(tmp_path / "port", 3, model_params=model_tree,
                                  model_subdir="unet", train_state=state_tree,
                                  extra=driver.extra_trees(trainer, state))
    jt = jax_training.Pix2PixTrainer(jax_tiny_pipe(), jax_training.TrainConfig(), None,
                                     use_ema=True)
    jstate = jt.create_state(params)
    jema = jax_ckpt.load_pytree(d / "ema.msgpack", target=jstate.ema)
    for k, v in state_dict_from_jax(_np(jema), "diffusers_unet").items():
        np.testing.assert_array_equal(state.ema[k].numpy(), v, err_msg=k)

    jd = jax_ckpt.save_step_checkpoint(tmp_path / "jax", 3, model_params=jstate.params,
                                       model_subdir="unet",
                                       train_state={"opt_state": jstate.opt_state,
                                                    "step": jstate.step},
                                       extra={"ema": jema})
    fresh = trainer.create_state(pipe.params_from_jax(_np(params)))
    got = driver.restore_checkpoint(trainer, fresh, jd)
    assert got.step == 0
    for k, v in state.ema.items():
        assert torch.equal(got.ema[k], v), k
