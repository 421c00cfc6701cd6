"""The port's base-model pretrainers and snapshot against the JAX package,
f32, on the CPU.

The tiny pipeline's weights are made by the port and carried to JAX as
trees (``weights/to_jax.py``), so no flax init runs. One ``VAETrainer`` step
and one ``UNetPretrainer`` step take the same params, batch and draws (the
JAX key's draws, handed to the port): the loss within 1e-5 relative, and
the updated params within 1e-5 of the norm of all params. Tensors whose
gradient is zero in exact arithmetic get rounding noise that Adam scales
up to +-lr, so they are held to 2 lr instead and left out of the norm: in
the tiny models these are the VAE attention's key biases (softmax is
shift-invariant), and the conv biases and time-embedding projections whose
output only reaches a GroupNorm with one channel a group (which removes a
per-channel shift); they are found as the tensors whose JAX first moment is below 1e-7 of the
largest. At 32 px
the latents are 16x16: the UNet's 256-token self-attentions take the packed
path (``PackedFlashAttention``'s plain versions here; the JAX side runs
the XLA attention). ``save_base_model`` snapshots load in both packages'
``load_pretrained_pipeline``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.diffusion import pretrain as jax_pretrain
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig
from genima_tpu.weights.load_pretrained import load_pretrained_pipeline as jax_load_pretrained

from genima_torch.core import checkpoint as ckpt
from genima_torch.diffusion import pretrain, training
from genima_torch.diffusion import train_state as ts
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.kernels import packed_attention as pa
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights.from_jax import state_dict_from_jax
from genima_torch.weights.load_pretrained import load_pretrained_pipeline
from genima_torch.weights.to_jax import tree_from_module

LOSS_RTOL = 1e-5
PARAM_REL = 1e-5  # of the norm of all params
IMAGE, BSZ, LR = 32, 2, 1e-3
FAMILIES = {"unet": "diffusers_unet", "controlnet": "diffusers_controlnet",
            "vae": "diffusers_vae", "text_encoder": "hf_clip"}


def _port_pipe():
    return SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32,
                                device="cpu", vae_encoder=True)


def _trees(params):
    return {k: tree_from_module(m, FAMILIES[k]) for k, m in params.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    params = _port_pipe().init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    batch = dict(
        pixel_values=rng.randint(0, 256, (BSZ, IMAGE, IMAGE, 3)).astype(np.uint8),
        conditioning_pixel_values=rng.randint(0, 256, (BSZ, IMAGE, IMAGE, 3)).astype(np.uint8),
        input_ids=rng.randint(0, 1000, (BSZ, 77)).astype(np.int32),
    )
    jpipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                        text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32, backend="xla")
    return dict(tree=_trees(params), batch=batch, jpipe=jpipe)


def _flat(tree):
    return {k: np.asarray(v, np.float64) for k, v in flatten_dict(tree).items()}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _step_both(setup, jax_cls, port_cls, draws_fn, key):
    cfg = dict(learning_rate=LR, lr_scheduler="constant", lr_warmup_steps=0)
    jt = jax_cls(setup["jpipe"], jax_training.TrainConfig(**cfg))
    jstate = jt.create_state(jax.tree_util.tree_map(jnp.asarray, setup["tree"]))
    jstate, want = jt.train_step(jstate, {k: jnp.asarray(v) for k, v in setup["batch"].items()},
                                 key)
    pipe = _port_pipe()
    trainer = port_cls(pipe, training.TrainConfig(**cfg))
    pstate = trainer.create_state(pipe.params_from_jax(setup["tree"]))
    pbatch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    pstate, got = trainer.step_with_draws(pstate, pbatch, draws_fn(key))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
    return trainer, pstate, jstate


def _assert_update_matches(name, trainer, pstate, jstate, setup):
    want = _flat(jstate.params)
    got = _flat(ts.params_tree(pstate.params, trainer.paths))
    init = _flat(setup["tree"][name])
    assert sorted(got) == sorted(want)
    mu = _flat(jstate.opt_state[1][0].mu)
    scale = max(np.abs(m).max() for m in mu.values())
    noise = {p for p, m in mu.items() if np.abs(m).max() <= 1e-7 * scale}
    for p in noise:  # gradient-free in exact arithmetic
        assert p[-1] == "bias" or p[-2] == "time_emb_proj", p
        assert np.abs(got[p] - init[p]).max() <= 2 * LR, p
    kept = sorted(set(want) - noise)
    cat = lambda t: np.concatenate([t[p].ravel() for p in kept])  # noqa: E731
    assert _rel(cat(got), cat(want)) <= PARAM_REL
    assert _rel(cat(want), cat(init)) > 100 * PARAM_REL  # the step moved the weights
    return noise


def _latent_shape():
    return (BSZ, IMAGE // 2, IMAGE // 2, 4)


def test_vae_step_matches_jax(setup):
    """JAX's VAE trainer samples the posterior with the step's key itself."""
    def draws(key):
        noise = np.array(jax.random.normal(key, _latent_shape(), jnp.float32))
        return training.Draws(sample_noise=torch.from_numpy(noise), noise=None, timesteps=None)

    trainer, pstate, jstate = _step_both(setup, jax_pretrain.VAETrainer, pretrain.VAETrainer,
                                         draws, jax.random.key(11))
    noise = _assert_update_matches("vae", trainer, pstate, jstate, setup)
    assert {("decoder", "mid_block", "attentions_0", "to_k", "bias"),
            ("encoder", "mid_block", "attentions_0", "to_k", "bias")} <= noise


def test_unet_step_matches_jax(setup, monkeypatch):
    """The key splits into noise, timesteps and the posterior sample, as in
    the fine-tune. Per step at 16x16 latents the UNet's down-block and two
    up-block self-attentions run the LSE forward and the backward, none the
    plain forward, with no fallback."""
    def draws(key):
        k_noise, k_t, k_sample = jax.random.split(key, 3)
        cfg = jax_training.TrainConfig()
        return training.Draws(
            sample_noise=torch.from_numpy(np.array(jax.random.normal(k_sample, _latent_shape()))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, _latent_shape()))),
            timesteps=torch.from_numpy(
                np.array(jax_training.sample_train_timesteps(cfg, k_t, BSZ))).long(),
        )

    calls = {"lse": 0, "bwd": 0, "plain": 0}

    def counting(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(pa, "packed_attention_forward_lse",
                        counting("lse", pa.packed_attention_forward_lse))
    monkeypatch.setattr(pa, "packed_attention_backward",
                        counting("bwd", pa.packed_attention_backward))
    monkeypatch.setattr(pa, "_forward", counting("plain", pa._forward))
    fallbacks = pa.PackedFlashAttention.fallbacks
    trainer, pstate, jstate = _step_both(setup, jax_pretrain.UNetPretrainer,
                                         pretrain.UNetPretrainer, draws, jax.random.key(12))
    assert calls == {"lse": 3, "bwd": 3, "plain": 0}
    assert pa.PackedFlashAttention.fallbacks == fallbacks
    _assert_update_matches("unet", trainer, pstate, jstate, setup)
    for name in ("vae", "text_encoder", "controlnet"):  # the other models stay
        assert not any(p.requires_grad for p in trainer.frozen[name].parameters())


def test_pretrain_base_model_trains_both_stages(setup, capsys):
    """Two steps a stage on cycled batches: each stage's masters are kept,
    the modules end holding them, the other models are untouched, and the
    JAX package's log lines are printed."""
    pipe = _port_pipe()
    params = pipe.params_from_jax(setup["tree"])
    before = {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in params.items()}
    masters = {}
    out = pretrain.pretrain_base_model(pipe, params, [setup["batch"]], vae_steps=2,
                                       unet_steps=2, log_every=1, masters=masters)
    assert sorted(masters) == ["unet", "vae"]
    for name, module in out.items():
        moved = any(not torch.equal(before[name][n], t) for n, t in module.state_dict().items())
        assert moved == (name in masters), name
        for n, p in module.named_parameters():
            if name in masters:
                assert torch.equal(p, masters[name][n]), (name, n)
            assert not p.requires_grad
    log = capsys.readouterr().out
    assert "pretrain[vae] step 1: loss=" in log and "pretrain[unet] step 0: loss=" in log


def test_save_base_model_round_trips_with_jax(setup, tmp_path):
    """Port-written snapshot -> JAX's loader and the port's; JAX-written
    snapshot (the same weights) -> the port's loader."""
    pipe = _port_pipe()
    params = pipe.params_from_jax(setup["tree"])
    with torch.no_grad():
        for p in params["unet"].parameters():
            p.mul_(1.5)  # weights the seeded init does not give
    masters = {"vae": {n: p.detach() * 2 for n, p in params["vae"].named_parameters()}}
    out = pretrain.save_base_model(tmp_path / "port", params, masters)
    for name in ("vae", "unet", "text_encoder"):
        assert (out / name / "params.msgpack").exists(), name
    one_file = ckpt.load_pytree(out / "params.msgpack")
    assert sorted(one_file) == ["text_encoder", "unet", "vae"]

    jparams = jax.tree_util.tree_map(jnp.asarray, setup["tree"])
    report = jax_load_pretrained(out, jparams)
    assert report == {"unet": "native", "controlnet": "missing", "vae": "native",
                      "text_encoder": "native"}
    want_vae = {k: v.numpy() for k, v in masters["vae"].items()}
    got_vae = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams["vae"]),
                                  "diffusers_vae")
    for k, v in want_vae.items():
        np.testing.assert_array_equal(got_vae[k], v, err_msg=k)
    got_unet = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams["unet"]),
                                   "diffusers_unet")
    for k, v in params["unet"].state_dict().items():
        np.testing.assert_array_equal(got_unet[k], v.numpy(), err_msg=k)

    # JAX writes the tree it loaded; the port reads it back
    jax_dir = jax_pretrain.save_base_model(tmp_path / "jax", jparams)
    fresh = _port_pipe().params_from_jax(setup["tree"])
    assert load_pretrained_pipeline(jax_dir, fresh)["vae"] == "native"
    for name in ("vae", "unet", "text_encoder"):
        want = {**params[name].state_dict(),
                **(masters.get(name) or {})}
        for k, v in fresh[name].state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
    assert sorted(jax_ckpt.load_pytree(jax_dir / "params.msgpack")) == sorted(one_file)
