"""The port's ControlNet fine-tune against the JAX package, f32, on the CPU.

Tiny configs; the same numpy inputs, weights carried across by the port's
converter, and the JAX key splits' draws handed to the port. At image 32
the tiny latents are 16x16, so the 256-token self-attentions take the
packed path in both packages: the Pallas LSE forward and flash backward in
interpret mode on the JAX side, ``PackedFlashAttention``'s plain versions
on the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from genima_tpu import native as jax_native
from genima_tpu.core.init_utils import fast_init
from genima_tpu.data import dataset as jax_dataset
from genima_tpu.data import tokenizer as jax_tok
from genima_tpu.diffusion import driver as jax_driver
from genima_tpu.diffusion import schedulers as jax_sched
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.controlnet import controlnet_params_from_unet as jax_from_unet
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig

from genima_torch.cli.train_controlnet_genima import parse_args
from genima_torch.core.optim import AdamW, clip_by_global_norm_
from genima_torch.core.rng import seed_everything
from genima_torch.data import dataset, tokenizer
from genima_torch.diffusion import driver, schedulers, training
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.kernels import packed_attention as pa
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import AutoencoderKL, VAEConfig
from genima_torch.weights.from_jax import load_from_jax, state_dict_from_jax
from genima_torch.weights.init import build_module

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
STEPS = 2
IMAGE = 32  # 16x16 latents: 256-token self-attention takes the packed path
BSZ = 2


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
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _tiny_port_pipe(**kw):
    return SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32, device="cpu",
        vae_encoder=True, **kw,
    )


# -- modules ------------------------------------------------------------------


def test_vae_encode_matches_jax():
    cfg = JaxVAEConfig.tiny_test()
    key = jax.random.key(0)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jm = JaxVAE(cfg)
    params = fast_init(jm, key, jnp.zeros((1, 16, 16, 3)), key, seed=3)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    port = load_from_jax(
        build_module(lambda: AutoencoderKL(VAEConfig.tiny_test(), encoder=True),
                     torch.device("cpu"), torch.float32),
        _np(params), "diffusers_vae",
    )
    dist = port.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, ref in ((dist.mean, want.mean), (dist.logvar, want.logvar)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4)
    noise = np.random.RandomState(2).randn(*want.mean.shape).astype(np.float32)
    sample = want.mean + jnp.exp(0.5 * want.logvar) * noise  # LatentDistribution.sample
    got = dist.sample(torch.from_numpy(noise).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(sample), atol=1e-4)
    assert torch.equal(dist.mode(), dist.mean)


def test_add_noise_matches_jax():
    acp = jax_sched.make_alphas_cumprod(jax_sched.SchedulerConfig())
    np.testing.assert_array_equal(
        schedulers.make_alphas_cumprod(schedulers.SchedulerConfig()), acp
    )
    rng = np.random.RandomState(3)
    x, n = (rng.randn(3, 4, 8, 8).astype(np.float32) for _ in range(2))
    t = np.array([0, 499, 999])
    want = jax_sched.add_noise(jnp.asarray(acp), jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    got = schedulers.add_noise(torch.from_numpy(acp), *map(torch.from_numpy, (x, n, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", [
    "constant", "constant_with_warmup", "linear", "cosine", "cosine_with_restarts",
    "polynomial",
])
def test_lr_schedule_matches_optax(name):
    for kw in (dict(lr_warmup_steps=10, max_train_steps=50, lr_num_cycles=3, lr_power=2.0),
               dict(lr_warmup_steps=0, max_train_steps=20)):
        jcfg = jax_training.TrainConfig(learning_rate=1e-3, lr_scheduler=name, **kw)
        pcfg = training.TrainConfig(learning_rate=1e-3, lr_scheduler=name, **kw)
        want, got = jax_training.make_lr_schedule(jcfg), training.make_lr_schedule(pcfg)
        for step in range(0, 60, 3):  # optax evaluates in f32, the port in f64
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-12,
                                       err_msg=f"{name} {kw} step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])  # clipped, and not
def test_clip_and_adamw_match_optax(max_norm):
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    sched = training.make_lr_schedule(training.TrainConfig(
        learning_rate=1e-2, lr_scheduler="linear", lr_warmup_steps=1, max_train_steps=4))
    jsched = jax_training.make_lr_schedule(jax_training.TrainConfig(
        learning_rate=1e-2, lr_scheduler="linear", lr_warmup_steps=1, max_train_steps=4))
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(jsched, 0.9, 0.999, 1e-8, weight_decay=1e-2))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = AdamW(sched, 0.9, 0.999, 1e-8, 1e-2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        norm = clip_by_global_norm_(tg, max_norm)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        ts = opt.step_(tp, tg, ts)
    assert ts.count == 3
    for k in params:
        # f32 rounding of the AdamW arithmetic: ~1e-4 of a 1e-2 update
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)


def test_normalize_image_batch_matches_jax():
    rng = np.random.RandomState(6)
    u8 = rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    f32 = rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    for a, b in ((u8, u8), (f32, f32)):
        want = jax_training.normalize_image_batch(jnp.asarray(a), jnp.asarray(b))
        got = training.normalize_image_batch(torch.from_numpy(a), torch.from_numpy(b))
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-7)


@pytest.mark.parametrize("spacing,grid,allowed", [
    ("uniform", None, set(range(1000))),
    ("turbo_timesteps", None, set(training.TURBO_TIMESTEPS)),
    ("uniform", (999, 0, 500), {999, 0, 500}),
])
def test_sample_train_timesteps_draws_from_the_policy(spacing, grid, allowed):
    cfg = training.TrainConfig(timestep_spacing=spacing, train_timestep_grid=grid)
    t = training.sample_train_timesteps(cfg, torch.Generator().manual_seed(0), 64)
    assert t.shape == (64,) and t.dtype == torch.long
    assert set(t.tolist()) <= allowed


@pytest.mark.parametrize("grid", [(999, 1000), (-1, 5)])
def test_sample_train_timesteps_out_of_range_raises(grid):
    """A known divergence (ROADMAP C-ref): the JAX gather clamps an
    out-of-range grid value silently; the port raises."""
    cfg = training.TrainConfig(train_timestep_grid=grid)
    with pytest.raises(ValueError, match="outside"):
        training.sample_train_timesteps(cfg, torch.Generator().manual_seed(0), 4)
    jcfg = jax_training.TrainConfig(train_timestep_grid=grid)
    t = jax_training.sample_train_timesteps(jcfg, jax.random.key(0), 16)
    assert np.asarray(t).min() >= min(grid)  # drawn, no error


def test_trainer_needs_the_vae_encoder():
    with pytest.raises(ValueError, match="vae_encoder"):
        training.ControlNetTrainer(
            SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                 text_cfg=CLIPTextConfig.tiny(), device="cpu"),
            training.TrainConfig(),
        )


def test_seed_everything_seeds_torch_and_numpy():
    g = seed_everything(7)
    a, x = torch.randn(3, generator=g), np.random.rand()
    g = seed_everything(7)
    assert torch.equal(a, torch.randn(3, generator=g)) and x == np.random.rand()


# -- tokenizer and data ----------------------------------------------------------

MERGES = [("t", "h"), ("th", "e</w>"), ("r", "o"), ("ro", "b"), ("a", "r"), ("ar", "m</w>")]
TEXTS = ["the robot arm", "The  ROBOT's arm_7 executing 'open drawer'!", "", "x" * 200]


def test_tokenizer_copy_matches_jax(tmp_path):
    got, want = tokenizer.ClipTokenizer(MERGES), jax_tok.ClipTokenizer(MERGES)
    np.testing.assert_array_equal(got(TEXTS), want(TEXTS))
    assert got.decode(got.encode(TEXTS[0])) == want.decode(want.encode(TEXTS[0]))
    np.testing.assert_array_equal(tokenizer.HashTokenizer()(TEXTS), jax_tok.HashTokenizer()(TEXTS))
    merges = tmp_path / "tokenizer" / "merges.txt"
    merges.parent.mkdir()
    merges.write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    for src in (merges, tmp_path):  # a merges file, or a snapshot dir holding one
        np.testing.assert_array_equal(
            tokenizer.load_tokenizer(src)(TEXTS), jax_tok.load_tokenizer(src)(TEXTS)
        )
    with pytest.raises(FileNotFoundError):
        tokenizer.load_tokenizer(tmp_path / "missing.txt")


def _make_rendered_dataset(root, task="toy", episodes=2, frames=4, size=IMAGE):
    """The rendered-dataset tree: tiled_rgb / tiled_rgb_rendered PNG pairs."""
    rng = np.random.RandomState(0)
    for ep in range(episodes):
        ep_dir = root / task / "variation0" / "episodes" / f"episode{ep}"
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = ep_dir / sub
            d.mkdir(parents=True)
            for i in range(frames):
                Image.fromarray(rng.randint(0, 255, (size, size, 3), dtype=np.uint8)).save(
                    d / f"{i}.png")
    return root


@pytest.fixture(scope="module")
def jax_native_own_build(tmp_path_factory):
    """The JAX package's native decoder, built into this module's own
    directory. Its loader builds ``genima_tpu/native/_image_ops.so`` in
    place (not atomically) and caches a failed load for the process: under
    several test workers one of them can load a half-written library and
    from then on decode with PIL, where the port decodes natively."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", tmp_path_factory.mktemp("jax_native") / "_image_ops.so")
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_attempted", False)
        yield jax_native


@pytest.mark.parametrize("use_native", [False, True])  # PIL, or the C++ decoder in both
@pytest.mark.parametrize("emit_uint8", [True, False])
def test_dataset_copy_matches_jax(tmp_path, emit_uint8, use_native, jax_native_own_build):
    root = _make_rendered_dataset(tmp_path, size=40)
    want = jax_dataset.index_rendered_dataset(root, ["toy"])
    got = dataset.index_rendered_dataset(root, ["toy"])
    assert [vars(s) for s in got] == [vars(s) for s in want] and len(got) == 6
    tok = tokenizer.HashTokenizer()
    jl = jax_dataset.DiffusionDataLoader(want, tok, batch_size=2, resolution=IMAGE, seed=3,
                                         num_workers=2, use_native=use_native,
                                         emit_uint8=emit_uint8)
    pl = dataset.DiffusionDataLoader(got, tok, batch_size=2, resolution=IMAGE, seed=3,
                                     num_workers=2, use_native=use_native, emit_uint8=emit_uint8)
    assert len(pl) == len(jl) == 3
    for a, b in zip(pl, jl):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert pl.decoded == {"native" if use_native else "pil": 3}
    batches = list(dataset.DevicePrefetcher(pl, "cpu"))
    assert len(batches) == 3 and batches[0]["pixel_values"].shape == (2, IMAGE, IMAGE, 3)


# -- the train step ------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """JAX tiny pipeline params (ControlNet from_unet, its zero convs and
    cond-embedding conv_out randomised so that every ControlNet module
    shapes the loss from the first step), a uint8 batch, per-step keys."""
    pipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                       text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32, backend="fused")
    params = pipe.init_params(jax.random.key(0), image_size=IMAGE)
    params["controlnet"] = jax_from_unet(params["unet"], params["controlnet"])
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in cn:
        if k.startswith("controlnet_"):
            cn[k] = jax.tree_util.tree_map(
                lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    batch = dict(
        pixel_values=rng.randint(0, 256, (BSZ, IMAGE, IMAGE, 3)).astype(np.uint8),
        conditioning_pixel_values=rng.randint(0, 256, (BSZ, IMAGE, IMAGE, 3)).astype(np.uint8),
        input_ids=rng.randint(0, 1000, (BSZ, 77)).astype(np.int32),
    )
    keys = [jax.random.key(10 + i) for i in range(STEPS)]
    return dict(pipe=pipe, params=params, tree=_np(params), batch=batch, keys=keys)


def _draws(cfg, key):
    """The draws ``ControlNetTrainer._loss_fn`` makes from ``key``."""
    k_noise, k_t, k_sample = jax.random.split(key, 3)
    shape = (BSZ, IMAGE // 2, IMAGE // 2, 4)
    return training.Draws(
        sample_noise=torch.from_numpy(np.array(jax.random.normal(k_sample, shape, jnp.float32))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        timesteps=torch.from_numpy(
            np.array(jax_training.sample_train_timesteps(cfg, k_t, BSZ))).long(),
    )


def _port_trainer(setup, **cfg):
    pipe = _tiny_port_pipe()
    trainer = training.ControlNetTrainer(pipe, training.TrainConfig(**cfg))
    return trainer, trainer.create_state(pipe.params_from_jax(setup["tree"]))


def _port_batch(setup):
    return {k: torch.from_numpy(v) for k, v in setup["batch"].items()}


@pytest.mark.parametrize("checkpointing", [False, True])
def test_train_steps_match_jax(setup, checkpointing):
    """Two steps: each loss, the grad norm, and the updated ControlNet."""
    cfg = dict(gradient_checkpointing=checkpointing)
    jt = jax_training.ControlNetTrainer(setup["pipe"], jax_training.TrainConfig(**cfg))
    state = jt.create_state(setup["params"])
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    trainer, pstate = _port_trainer(setup, **cfg)
    for key in setup["keys"]:
        state, want = jt.train_step(state, jb, key)
        pstate, got = trainer.step_with_draws(pstate, _port_batch(setup), _draws(jt.cfg, key))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
        assert got["lr"] == pytest.approx(float(want["lr"]), rel=1e-6)
    assert pstate.step == int(state.step) == STEPS
    want_params = state_dict_from_jax(_np(state.params), "diffusers_controlnet")
    assert sorted(pstate.params) == sorted(want_params)
    moved = 0.0
    for k, v in want_params.items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, atol=PARAM_ATOL, err_msg=k)
        moved = max(moved, float(np.abs(v - state_dict_from_jax(
            setup["tree"]["controlnet"], "diffusers_controlnet")[k]).max()))
    assert moved > PARAM_ATOL  # the steps did move the weights


def test_first_step_gradients_match_jax(setup):
    """The ControlNet gradients of one loss, through the packed LSE forward
    and backward, against jax.grad of the JAX loss (Pallas interpret mode)."""
    jt = jax_training.ControlNetTrainer(setup["pipe"], jax_training.TrainConfig())
    jt.create_state(setup["params"])
    key = setup["keys"][0]
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    want = jax.jit(jax.grad(jt._loss_fn))(setup["params"]["controlnet"], jt._frozen, jb, key)
    want = state_dict_from_jax(_np(want), "diffusers_controlnet")
    trainer, state = _port_trainer(setup)
    _, got = trainer.gradients(state, _port_batch(setup), _draws(jt.cfg, key))
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4 * scale, err_msg=k)
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert np.abs(want[attn]).max() > 1e-3 * scale  # attention shapes the gradient


def test_train_step_routes_attention_through_the_function(setup, monkeypatch):
    """Per step at 16x16 latents: the UNet down block's self-attention needs
    no gradient (plain forward); the UNet up blocks' two and the ControlNet
    down block's one run the LSE forward and the backward; no fallback, and
    on the CPU no kernel launch."""
    calls = {"lse": 0, "bwd": 0, "plain": 0}

    def counting(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    kernels = (pa.packed_flash_attention, pa.packed_attention_forward_lse,
               pa.packed_attention_backward)
    monkeypatch.setattr(pa, "packed_attention_forward_lse",
                        counting("lse", pa.packed_attention_forward_lse))
    monkeypatch.setattr(pa, "packed_attention_backward",
                        counting("bwd", pa.packed_attention_backward))
    monkeypatch.setattr(pa, "_forward", counting("plain", pa._forward))
    fallbacks = pa.PackedFlashAttention.fallbacks
    launches = [f.launches for f in kernels]
    trainer, state = _port_trainer(setup)
    trainer.train_step(state, _port_batch(setup), torch.Generator().manual_seed(0))
    assert calls == {"lse": 3, "bwd": 3, "plain": 1}
    assert pa.PackedFlashAttention.fallbacks == fallbacks
    assert [f.launches for f in kernels] == launches


def test_init_model_params_applies_from_unet(setup):
    tree = _np(setup["pipe"].init_params(jax.random.key(1), image_size=IMAGE))
    args = parse_args(["--device", "cpu", "--seed", "0"])
    params = driver.init_model_params(_tiny_port_pipe(), args, tree=tree)
    want = state_dict_from_jax(jax_from_unet(tree["unet"], tree["controlnet"]),
                               "diffusers_controlnet")
    got = params["controlnet"].state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# -- the driver and the CLI ---------------------------------------------------------


def _cli_args(data, *extra):
    return parse_args([
        "--data_path", str(data), "--tasks", "toy", "--resolution", str(IMAGE),
        "--train_batch_size", str(BSZ), "--max_train_steps", "2", "--seed", "0",
        "--device", "cpu", "--mixed_precision", "no",
        "--enable_xformers_memory_efficient_attention", "--dataloader_num_workers", "2",
        "--output_dir", f"{data}_out", "--report_to", "none", *extra,
    ])


def test_run_training_takes_two_steps(tmp_path, capsys):
    data = _make_rendered_dataset(tmp_path / "data")
    pipe = _tiny_port_pipe()
    steps = []
    result = driver.run_training(
        _cli_args(data, "--lr_scheduler", "linear", "--lr_warmup_steps", "1"), pipe=pipe,
        step_hook=lambda step, state, metrics: steps.append((step, metrics["lr"])),
    )
    assert result["global_step"] == 2 and np.isfinite(result["final_loss"])
    assert steps == [(1, 0.0), (2, pytest.approx(5e-6))]
    assert "[step 1] train/loss" in capsys.readouterr().out  # logged at step 1


def test_run_training_matches_jax_config(tmp_path):
    """The driver's TrainConfig carries the CLI flags as the JAX driver's does."""
    argv = ["--lr_scheduler", "cosine", "--lr_warmup_steps", "3", "--train_timestep_grid",
            "999,499", "--train_scheduler", "euler_discrete", "--scale_lr"]
    args = _cli_args(tmp_path, *argv)
    got = driver.train_config(args, max_steps=7)
    assert got.learning_rate == pytest.approx(args.learning_rate * BSZ)
    assert (got.lr_scheduler, got.lr_warmup_steps, got.max_train_steps) == ("cosine", 3, 7)
    assert got.train_timestep_grid == (999, 499)
    assert got.scheduler_config.timestep_spacing == "trailing"


@pytest.mark.parametrize("argv", [
    ["--enable_xformers_memory_efficient_attention"], ["--mixed_precision", "no"],
])
def test_build_pipeline_mirrors_jax_driver(argv):
    """Same attention backend and compute dtype as the JAX driver picks."""
    args = parse_args(["--device", "cpu", *argv])
    want = jax_driver.build_pipeline(args, "sd")
    got = driver.build_pipeline(args)
    assert got.backend == want.backend and got.vae_encoder
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
