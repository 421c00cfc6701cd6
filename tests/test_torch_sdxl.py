"""The port's SDXL-turbo variant against the JAX package, tiny, f32, on the CPU.

The JAX side uses the widths of ``genima_tpu/eval/agents.py::make_tiny_sdxl_agent``
(UNet 32/64 channels with text_time conditioning, CLIP towers of width 16 and
32, the tiny VAE); its params are made by ``fast_init`` (no init program is
compiled) and carried to the port by the port's converter. The port's
``UNetConfig`` names the add embedding's input width, which flax infers:
16 pooled + 6 time ids x 8 = 64. Random draws are inputs in the port: the
JAX key chain's draws (``split_maybe_batched`` / ``_normal_maybe_batched``)
are handed to it. Tolerances are stated per check; at 32x32 images the
latents are 16x16, so the 256-token self-attentions take the packed path
(the Pallas kernels in interpret mode on the JAX side, the plain versions of
the port's wrappers here).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.diffusion import schedulers as jax_sched
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDXLControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.clip_text import CLIPTextModel as JaxCLIPTextModel
from genima_tpu.nn.controlnet import controlnet_params_from_unet as jax_from_unet
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

from genima_torch.diffusion import schedulers, training
from genima_torch.diffusion.pipeline import SDXLControlNetPipeline
from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.controlnet import controlnet_params_from_unet
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights.from_jax import load_from_jax, state_dict_from_jax
from genima_torch.weights.init import build_module

IMAGE = 32  # 16x16 latents: the 256-token self-attentions take the packed path
TRAIN_IMAGE = 16
STEPS = 2
BSZ = 2
MODEL_RTOL = 1e-4  # f32 forward of a model, error / max |output|
SCHED_TOL = 1e-5  # one f32 scheduler step, rtol and atol on unit-scale samples
LOSS_RTOL = 1e-5


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


def jax_tiny_pipe(**kw):
    """``make_tiny_sdxl_agent``'s pipeline."""
    return JaxPipeline(
        unet_cfg=JaxUNetConfig.tiny(addition_embed_type="text_time", addition_time_embed_dim=8,
                                    cross_attention_dim=48),
        vae_cfg=JaxVAEConfig.tiny_test(scaling_factor=0.13025),
        text_cfg=JaxCLIPConfig.tiny(hidden_size=16, num_heads=2),
        text_cfg_2=JaxCLIPConfig.tiny(hidden_size=32, projection_dim=16),
        dtype=jnp.float32, **kw)


def port_tiny_pipe(**kw):
    """The same widths in the port (``eval.agents.make_tiny_sdxl_agent``'s)."""
    return SDXLControlNetPipeline(
        unet_cfg=UNetConfig.tiny(addition_embed_type="text_time", addition_time_embed_dim=8,
                                 cross_attention_dim=48,
                                 projection_class_embeddings_input_dim=64),
        vae_cfg=VAEConfig.tiny_test(scaling_factor=0.13025),
        text_cfg=CLIPTextConfig.tiny(hidden_size=16, num_heads=2),
        text_cfg_2=CLIPTextConfig.tiny(hidden_size=32, projection_dim=16),
        device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def jax_fast_params() -> dict:
    """The tiny JAX pipeline's five param trees by ``fast_init``: the
    shapes of its ``init_params``, no init program compiled. Made once a
    process and shared: copy the top-level dict before replacing a model."""
    pipe, image_size = jax_tiny_pipe(), IMAGE
    h = image_size // pipe.vae_scale_factor
    key = jax.random.key(0)
    lat, t = jnp.zeros((1, h, h, 4)), jnp.zeros((1,))
    ctx = jnp.zeros((1, 77, pipe.text_cfg.hidden_size + pipe.text_cfg_2.hidden_size))
    cond, ids = jnp.zeros((1, image_size, image_size, 3)), jnp.zeros((1, 77), jnp.int32)
    added = {"text_embeds": jnp.zeros((1, pipe.text_cfg_2.projection_dim)),
             "time_ids": pipe.make_time_ids(1, image_size)}
    return {
        "unet": fast_init(pipe.unet, key, lat, t, ctx, added_cond_kwargs=added, seed=1)["params"],
        "controlnet": fast_init(pipe.controlnet, key, lat, t, ctx, cond,
                                added_cond_kwargs=added, seed=2)["params"],
        "vae": fast_init(pipe.vae, key, cond, key, seed=3)["params"],
        "text_encoder": fast_init(pipe.text_encoder, key, ids, seed=4)["params"],
        "text_encoder_2": fast_init(pipe.text_encoder_2, key, ids, seed=5)["params"],
    }


@pytest.fixture(scope="module")
def models():
    """The JAX pipeline, its params (ControlNet from_unet, then its zero
    convs drawn at random so that the ControlNet shapes every output), and
    the port's pipeline on the same params."""
    jpipe = jax_tiny_pipe()
    params = dict(jax_fast_params())
    params["controlnet"] = jax_from_unet(params["unet"], params["controlnet"])
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    pipe = port_tiny_pipe()
    return jpipe, params, pipe, pipe.params_from_jax(_np(params))


def _noise_chain(key, steps: int, shape) -> np.ndarray:
    """The (steps, *shape) draws JAX's SDXL generate makes from ``key``: one
    split and one block a step, a (N,) key batch giving each slot its own."""
    blocks = []
    for _ in range(steps):
        key, sub = jax_sched.split_maybe_batched(key)
        blocks.append(np.asarray(jax_sched._normal_maybe_batched(sub, shape)))
    return np.stack(blocks)


# -- schedulers ----------------------------------------------------------------------


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("name", ["ddpm", "ddim", "euler_discrete", "euler_ancestral"])
def test_scheduler_steps_match_jax(name, prediction):
    """Every step of a 4-step run through ``make_scheduler``: the tables,
    ``scale_model_input`` and ``step``, the stochastic samplers on the
    standard-normal block JAX draws from the step's key."""
    spacing = "trailing" if "euler" in name else "leading"
    ours = schedulers.make_scheduler(
        name, schedulers.SchedulerConfig(timestep_spacing=spacing, prediction_type=prediction))
    ref = jax_sched.make_scheduler(
        name, jax_sched.SchedulerConfig(timestep_spacing=spacing, prediction_type=prediction))
    a, b = ours.set_timesteps(4), ref.set_timesteps(4)
    np.testing.assert_array_equal(a.timesteps, np.asarray(b.timesteps))
    rng = np.random.RandomState(1)
    shape = (2, 4, 8, 8)
    key = jax.random.key(7)
    for i in range(4):
        sample = (rng.randn(*shape) * 3).astype(np.float32)
        out = rng.randn(*shape).astype(np.float32)
        np.testing.assert_allclose(
            ours.scale_model_input(a, torch.from_numpy(sample), i).numpy(),
            np.asarray(ref.scale_model_input(b, jnp.asarray(sample), i)),
            rtol=SCHED_TOL, atol=SCHED_TOL)
        args = (jnp.asarray(out), i, jnp.asarray(sample))
        if name in ("ddpm", "euler_ancestral"):
            key, sub = jax.random.split(key)
            want = ref.step(b, *args, sub)
            # DDPM draws with jax.random.normal, ancestral through
            # _normal_maybe_batched: the same block for a scalar key
            noise = torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))
            got = ours.step(a, torch.from_numpy(out), i, torch.from_numpy(sample), noise)
        else:
            want = ref.step(b, *args)
            got = ours.step(a, torch.from_numpy(out), i, torch.from_numpy(sample))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCHED_TOL,
                                   atol=SCHED_TOL, err_msg=f"step {i}")


def test_make_scheduler_mirrors_jax():
    for name in ("ddpm", "ddim", "euler_discrete", "euler_ancestral"):
        ours, ref = schedulers.make_scheduler(name), jax_sched.make_scheduler(name)
        assert type(ours).__name__ == type(ref).__name__
        assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    with pytest.raises(ValueError, match="not supported"):
        schedulers.make_scheduler("lms")


def test_ancestral_noise_per_slot_matches_a_key_batch():
    """A (N,) key batch gives each slot its own block: the port, handed the
    blocks stacked on the batch axis, steps each row as its serial run."""
    ours, ref = schedulers.EulerAncestralScheduler(), jax_sched.EulerAncestralScheduler()
    a, b = ours.set_timesteps(3), ref.set_timesteps(3)
    keys = jnp.stack([jax.random.key(3), jax.random.key(9)])
    rng = np.random.RandomState(2)
    sample = (rng.randn(2, 8, 8, 4) * 14.6).astype(np.float32)
    out = rng.randn(2, 8, 8, 4).astype(np.float32)
    noise = _noise_chain(keys, 3, sample.shape)
    for i in range(3):
        keys, sub = jax_sched.split_maybe_batched(keys)
        want = ref.step(b, jnp.asarray(out), i, jnp.asarray(sample), sub)
        got = ours.step(a, torch.from_numpy(out), i, torch.from_numpy(sample),
                        torch.from_numpy(noise[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCHED_TOL,
                                   atol=SCHED_TOL)
        row = ours.step(a, torch.from_numpy(out[1:]), i, torch.from_numpy(sample[1:]),
                        torch.from_numpy(_noise_chain(jax.random.key(9), i + 1,
                                                      (1, 8, 8, 4))[i]))
        np.testing.assert_array_equal(row.numpy(), got[1:].numpy())


# -- configs and models ------------------------------------------------------------------


def test_sdxl_configs_mirror_jax():
    assert dataclasses.asdict(CLIPTextConfig.sdxl_one()) == dataclasses.asdict(
        JaxCLIPConfig.sdxl_one())
    assert dataclasses.asdict(CLIPTextConfig.sdxl_two()) == dataclasses.asdict(
        JaxCLIPConfig.sdxl_two())
    assert dataclasses.asdict(VAEConfig.sdxl()) == dataclasses.asdict(JaxVAEConfig.sdxl())
    want = dataclasses.asdict(JaxUNetConfig.sdxl())
    want.pop("sample_size")  # flax's init shape; the port builds no sample
    got = dataclasses.asdict(UNetConfig.sdxl())
    assert {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in got.items()} == {
        k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in want.items()}
    assert want["projection_class_embeddings_input_dim"] == (
        CLIPTextConfig.sdxl_two().projection_dim + 6 * want["addition_time_embed_dim"])


def test_controlnet_from_unet_copies_the_add_embedding(models):
    """diffusers' ``from_unet`` copies SDXL's add_embedding with the time
    embedding: the port's initialisation equals JAX's key for key."""
    jpipe, params, pipe, port = models
    cn_tree = jax_fast_params()["controlnet"]  # its own add_embedding
    want = state_dict_from_jax(_np(jax_from_unet(params["unet"], cn_tree)),
                               "diffusers_controlnet")
    cn = build_module(lambda: pipe._factories("fused")["controlnet"](), "cpu", torch.float32)
    load_from_jax(cn, _np(cn_tree), "diffusers_controlnet")
    got = controlnet_params_from_unet(port["unet"].state_dict(), cn.state_dict())
    assert sorted(got) == sorted(want)
    assert any(k.startswith("add_embedding.") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _model_inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    return dict(
        latents=rng.randn(BSZ, 16, 16, 4).astype(np.float32),
        t=np.array([999.0, 249.0], np.float32),
        context=rng.randn(BSZ, 77, 48).astype(np.float32),
        cond=rng.rand(BSZ, IMAGE, IMAGE, 3).astype(np.float32),
        pooled=rng.randn(BSZ, 16).astype(np.float32),
    )


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def test_controlnet_and_unet_with_added_cond_match_jax(models):
    jpipe, params, pipe, port = models
    x = _model_inputs()
    jadded = {"text_embeds": jnp.asarray(x["pooled"]), "time_ids": jpipe.make_time_ids(BSZ, IMAGE)}

    @jax.jit
    def jax_eps(params, lat, t, ctx, cond, added):
        down, mid = jpipe.controlnet.apply({"params": params["controlnet"]}, lat, t, ctx, cond,
                                           added_cond_kwargs=added)
        eps = jpipe.unet.apply({"params": params["unet"]}, lat, t, ctx,
                               down_block_additional_residuals=down,
                               mid_block_additional_residual=mid, added_cond_kwargs=added)
        return down, mid, eps

    jdown, jmid, jeps = jax_eps(params, *(jnp.asarray(x[k]) for k in
                                          ("latents", "t", "context", "cond")), jadded)
    added = {"text_embeds": torch.from_numpy(x["pooled"]),
             "time_ids": pipe.make_time_ids(BSZ, IMAGE)}

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()

    with torch.no_grad():
        lat, t, ctx = nchw(x["latents"]), torch.from_numpy(x["t"]), torch.from_numpy(x["context"])
        down, mid = port["controlnet"](lat, t, ctx, nchw(x["cond"]), added_cond_kwargs=added)
        eps = port["unet"](lat, t, ctx, down, mid, added_cond_kwargs=added)
        plain = port["unet"](lat, t, ctx, added_cond_kwargs=added)
    for i, (g, w) in enumerate(zip(down, jdown)):
        assert _rel(g.permute(0, 2, 3, 1), w) <= MODEL_RTOL, f"residual {i}"
    assert _rel(mid.permute(0, 2, 3, 1), jmid) <= MODEL_RTOL
    assert _rel(eps.permute(0, 2, 3, 1), jeps) <= MODEL_RTOL
    assert float((plain - eps).abs().max()) > 1e-3  # the ControlNet shapes the output
    with pytest.raises(ValueError, match="added_cond_kwargs"):
        port["unet"](lat, t, ctx)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_text_encoders_match_jax(act):
    """A tiny tower of each SDXL encoder's activation, with its projection:
    every output field."""
    cfg = dict(hidden_size=32, projection_dim=16, hidden_act=act)
    jmodel = JaxCLIPTextModel(JaxCLIPConfig.tiny(**cfg))
    ids = np.random.RandomState(3).randint(0, 1000, (2, 77)).astype(np.int32)
    tree = fast_init(jmodel, jax.random.key(0), jnp.zeros((1, 77), jnp.int32), seed=9)["params"]
    want = jmodel.apply({"params": tree}, jnp.asarray(ids))
    model = build_module(lambda: CLIPTextModel(CLIPTextConfig.tiny(**cfg)), "cpu", torch.float32)
    load_from_jax(model, _np(tree), "hf_clip")
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    for field in got._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def test_encode_prompt_matches_jax(models):
    """Both encoders' penultimate states side by side (16 + 32 = 48
    features) and encoder 2's pooled projection (16)."""
    jpipe, params, pipe, port = models
    ids = np.random.RandomState(4).randint(0, 1000, (2, 77)).astype(np.int32)
    jh, jp = jpipe.encode_prompt(params, jnp.asarray(ids))
    h, p = pipe.encode_prompt(port, ids)
    assert h.shape == (2, 77, 48) and p.shape == (2, 16)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)


def test_generate_matches_jax(models):
    """Two Euler-ancestral steps and the decode: the uint8 targets within 1
    level (a pixel on a .5 boundary may round the other way)."""
    jpipe, params, pipe, port = models
    rng = np.random.RandomState(6)
    cond = rng.randint(0, 256, (1, IMAGE, IMAGE, 3)).astype(np.uint8)
    latents = rng.randn(1, 16, 16, 4).astype(np.float32)
    ids = rng.randint(0, 1000, (1, 77)).astype(np.int32)
    key = jax.random.key(11)
    jh, jp = jpipe.encode_prompt(params, jnp.asarray(ids))
    want = np.asarray(jpipe.generate(params, jnp.asarray(cond), jh, jp, jnp.asarray(latents), key,
                                     num_inference_steps=STEPS))
    h, p = pipe.encode_prompt(port, ids)
    noise = torch.from_numpy(_noise_chain(key, STEPS, latents.shape))
    got = pipe.generate(port, torch.from_numpy(cond), h, p, torch.from_numpy(latents), noise,
                        num_inference_steps=STEPS)
    assert got.shape == (1, IMAGE, IMAGE, 3) and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    other = pipe.generate(port, torch.from_numpy(cond), h, p, torch.from_numpy(latents),
                          torch.zeros_like(noise), num_inference_steps=STEPS)
    assert not torch.equal(other, got)  # the noise reaches the sample


# -- the trainer ---------------------------------------------------------------------------


def test_sdxl_trainer_two_steps_match_jax(models):
    """Two steps of the SDXL ControlNet fine-tune: each loss and grad norm,
    the JAX key's draws handed to the port. At 16x16 images (8x8 latents)
    every attention is the library's in both packages: the packed path's
    training kernels are held to JAX in ``test_torch_training.py``; here the
    conditioning is (both encoders, ``add_time_ids`` at the trainer's
    resolution)."""
    jpipe, params, _, _ = models
    image = TRAIN_IMAGE
    rng = np.random.RandomState(7)
    batch = dict(
        pixel_values=rng.randint(0, 256, (BSZ, image, image, 3)).astype(np.uint8),
        conditioning_pixel_values=rng.randint(0, 256, (BSZ, image, image, 3)).astype(np.uint8),
        input_ids=rng.randint(0, 1000, (BSZ, 77)).astype(np.int32),
    )
    jt = jax_training.SDXLControlNetTrainer(jpipe, jax_training.TrainConfig(), None, image)
    state = jt.create_state(params)
    pipe = port_tiny_pipe(vae_encoder=True)
    trainer = training.SDXLControlNetTrainer(pipe, training.TrainConfig(), image)
    pstate = trainer.create_state(pipe.params_from_jax(_np(params)))
    assert sorted(trainer.frozen) == ["text_encoder", "text_encoder_2", "unet", "vae"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    shape = (BSZ, image // 2, image // 2, 4)
    for i in range(STEPS):
        key = jax.random.key(20 + i)
        k_noise, k_t, k_sample = jax.random.split(key, 3)
        draws = training.Draws(
            sample_noise=torch.from_numpy(np.array(jax.random.normal(k_sample, shape))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
            timesteps=torch.from_numpy(np.array(
                jax_training.sample_train_timesteps(jt.cfg, k_t, BSZ))).long(),
        )
        state, want = jt.train_step(state, jb, key)
        pstate, got = trainer.step_with_draws(pstate, pb, draws)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    want_params = state_dict_from_jax(_np(state.params), "diffusers_controlnet")
    for k, v in want_params.items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, atol=1e-5, err_msg=k)


# -- weights to JAX and back ----------------------------------------------------------------


def test_port_trees_load_in_the_jax_agent_and_back(models, tmp_path):
    """The port's five models written as JAX trees (``sd_ckpt``'s
    ``params.msgpack`` and a ControlNet ``checkpoint-1``): JAX's SDXL agent
    loads them as written, and the port's agent loads them back bit for bit."""
    from genima_tpu.eval.agents import SDXLControlNetAgent as JaxAgent

    from genima_torch.core import checkpoint as ckpt
    from genima_torch.eval.agents import SDXLControlNetAgent
    from genima_torch.weights.init import init_random_
    from genima_torch.weights.to_jax import tree_from_module

    jpipe, _, pipe, _ = models
    mine = pipe.init_params(torch.Generator().manual_seed(3))
    init_random_(mine["controlnet"], torch.Generator().manual_seed(4))
    families = {"unet": "diffusers_unet", "controlnet": "diffusers_controlnet",
                "vae": "diffusers_vae", "text_encoder": "hf_clip", "text_encoder_2": "hf_clip"}
    trees = {k: tree_from_module(m, families[k]) for k, m in mine.items()}
    base, diff = tmp_path / "base", tmp_path / "diffusion"
    ckpt.save_pytree({k: v for k, v in trees.items() if k != "controlnet"},
                     base / "params.msgpack")
    ckpt.save_pytree(trees["controlnet"], diff / "checkpoint-1" / "controlnet" / "params.msgpack")

    jpipe.init_params = lambda key, image_size=512: dict(jax_fast_params())
    try:
        jagent = JaxAgent(pipe=jpipe, resolution=IMAGE, dtype=jnp.float32,
                          sd_ckpt=str(base), diffusion_ckpt=str(diff))
    finally:
        del jpipe.init_params
    for name, tree in trees.items():
        got = dict(jax.tree_util.tree_flatten_with_path(_np(jagent.params[name]))[0])
        want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert got.keys() == want.keys(), name
        for path, v in want.items():
            np.testing.assert_array_equal(got[path], v, err_msg=f"{name} {path}")

    back = SDXLControlNetAgent(pipe=pipe, sd_ckpt=str(base), diffusion_ckpt=str(diff),
                               resolution=IMAGE, device="cpu")
    for name, module in mine.items():
        want = module.state_dict()
        for k, v in back.params[name].state_dict().items():
            assert torch.equal(v, want[k]), f"{name} {k}"
