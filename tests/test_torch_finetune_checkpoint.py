"""The fine-tune's checkpoints, resume, loss variants and weight loading
against the JAX package's, f32, on the CPU, at the tiny configs.

- Checkpoint interop, both ways, for every optimizer the trainer builds
  (f32 AdamW, bf16 first moment, 8-bit, each under accumulation too): a
  port ``checkpoint-<step>/`` restores through JAX's ``load_pytree(target=)``
  and a JAX one through the port's ``restore_checkpoint``, leaves equal bit
  for bit; one more update from the restored states agrees at ``atol 1e-6``.
- Retention: the same save sequence leaves the same directories.
- One train step resumed from a JAX checkpoint, with the JAX key's draws
  injected, against JAX's next step: ``LOSS_RTOL`` / ``PARAM_ATOL`` of
  ``test_torch_training.py``.
- The loss with linear betas, the v-prediction target and every
  augmentation against JAX's ``_loss_fn`` (``LOSS_RTOL``).
- The safetensors reader against the ``safetensors`` package; base weights
  from a directory JAX's ``export_torch_state_dict`` wrote, against JAX's
  ``load_pretrained_pipeline`` (exact: f32 both ways).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.diffusion import schedulers as jax_sched
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.controlnet import controlnet_params_from_unet as jax_from_unet
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig
from genima_tpu.weights import load_pretrained as jax_load_pretrained
from genima_tpu.weights.torch_port import export_torch_state_dict

from genima_torch.core import checkpoint as ckpt
from genima_torch.diffusion import driver, schedulers, training
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights import load_pretrained
from genima_torch.weights.from_jax import state_dict_from_jax

from test_torch_augment import jax_augment_draws

LOSS_RTOL = 1e-5  # test_torch_training.py's
PARAM_ATOL = 1e-5
UPDATE_ATOL = 1e-6  # one optimizer update from equal states
IMAGE, BSZ = 32, 2
OPTIMIZERS = {
    "adamw": {},
    "mu_bf16": dict(adam_mu_bf16=True),
    "adamw_8bit": dict(use_8bit_adam=True),
    "accumulate": dict(gradient_accumulation_steps=2),
    "adamw_8bit_accumulate": dict(use_8bit_adam=True, gradient_accumulation_steps=2),
}


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


def _port_pipe():
    return SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32, device="cpu", vae_encoder=True)


@pytest.fixture(scope="module")
def setup():
    """JAX tiny pipeline params (ControlNet from_unet with its zero convs
    randomised, as ``test_torch_training.py`` does), a uint8 batch."""
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
    return dict(pipe=pipe, params=params, tree=_np(params), batch=batch, updates={})


def _trainers(setup, **cfg):
    jt = jax_training.ControlNetTrainer(setup["pipe"], jax_training.TrainConfig(**cfg))
    jstate = jt.create_state(setup["params"])
    pipe = _port_pipe()
    trainer = training.ControlNetTrainer(pipe, training.TrainConfig(**cfg))
    return jt, jstate, trainer, trainer.create_state(pipe.params_from_jax(setup["tree"]))


def _grads(setup, seed):
    """Random gradients shaped like the ControlNet: (JAX tree, port dict)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape) * 1e-2).astype(np.float32), _np(setup["params"]["controlnet"]))
    port = {k: torch.from_numpy(np.array(v)) for k, v in
            state_dict_from_jax(tree, "diffusers_controlnet").items()}
    return tree, port


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(_leaves(v, (*prefix, str(k))))
        else:
            out[(*prefix, str(k))] = v
    return out


def _assert_trees_equal(port_tree, jax_tree):
    got = _leaves(port_tree)
    want = _leaves(serialization.to_state_dict(jax_tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if w is None or isinstance(w, dict):
            assert g is None or g == {}, path
            continue
        g = g.float() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        g = np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g)
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64), err_msg=str(path))


def _jax_update(setup, name, jt):
    """``jt.tx.update``, jitted once per optimizer for the module (eager
    optax over the ControlNet tree dispatches thousands of small ops)."""
    if name not in setup["updates"]:
        setup["updates"][name] = jax.jit(jt.tx.update)
    return setup["updates"][name]


def _one_more_update(setup, update, jstate_params, jopt, trainer, pparams, popt):
    g_tree, g_port = _grads(setup, 99)
    upd, _ = update(jax.tree_util.tree_map(jnp.asarray, g_tree), jopt, jstate_params)
    want = state_dict_from_jax(_np(optax.apply_updates(jstate_params, upd)), "diffusers_controlnet")
    trainer.tx.step_(pparams, g_port, popt)
    for k, v in want.items():
        np.testing.assert_allclose(pparams[k].numpy(), v, atol=UPDATE_ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_port_checkpoint_restores_in_jax(setup, tmp_path, name):
    jt, jstate, trainer, state = _trainers(setup, **OPTIMIZERS[name])
    for i in range(3):  # moments, counts and a half-accumulated mean
        state = training.TrainState(
            state.params, trainer.tx.step_(state.params, _grads(setup, i)[1], state.opt_state)[0],
            i + 1)
    model_tree, state_tree = driver.checkpoint_trees(trainer, state)
    d = ckpt.save_step_checkpoint(tmp_path, 3, model_params=model_tree, train_state=state_tree)
    params = jax_ckpt.load_pytree(d / "controlnet" / "params.msgpack", target=jstate.params)
    restored = jax_ckpt.load_pytree(d / "train_state.msgpack",
                                    target={"opt_state": jstate.opt_state, "step": jstate.step})
    assert json.loads((d / "metadata.json").read_text()) == {"step": 3}
    assert restored["step"].dtype == np.int32 and restored["step"].shape == () and restored["step"] == 3
    _assert_trees_equal(model_tree, params)
    _assert_trees_equal(state_tree["opt_state"], restored["opt_state"])
    for want, got in zip(jax.tree_util.tree_leaves(jstate.opt_state),
                         jax.tree_util.tree_leaves(restored["opt_state"])):
        assert np.asarray(got).dtype == want.dtype  # the JAX state's own dtypes
    _one_more_update(setup, _jax_update(setup, name, jt), jax.tree_util.tree_map(jnp.asarray, params),
                     jax.tree_util.tree_map(jnp.asarray, restored["opt_state"]),
                     trainer, state.params, state.opt_state)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_jax_checkpoint_restores_in_port(setup, tmp_path, name):
    jt, jstate, trainer, state = _trainers(setup, **OPTIMIZERS[name])
    jparams, jopt = jstate.params, jstate.opt_state
    for i in range(3):
        upd, jopt = _jax_update(setup, name, jt)(
            jax.tree_util.tree_map(jnp.asarray, _grads(setup, i)[0]), jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
    d = jax_ckpt.save_step_checkpoint(
        tmp_path, 3, model_params=jparams, model_subdir="controlnet",
        train_state={"opt_state": jopt, "step": jnp.asarray(3, jnp.int32)})
    got = driver.restore_checkpoint(trainer, state, d)
    assert got.step == 3
    model_tree, state_tree = driver.checkpoint_trees(trainer, got)
    _assert_trees_equal(model_tree, jparams)
    _assert_trees_equal(state_tree["opt_state"], jopt)
    _one_more_update(setup, _jax_update(setup, name, jt), jparams, jopt, trainer, got.params,
                     got.opt_state)


def test_restore_refuses_a_mismatched_checkpoint(setup, tmp_path):
    """An 8-bit checkpoint into an f32 AdamW state, and a tree missing a
    parameter, raise."""
    _, jstate, _, _ = _trainers(setup, use_8bit_adam=True)
    d = jax_ckpt.save_step_checkpoint(
        tmp_path, 1, model_params=jstate.params, model_subdir="controlnet",
        train_state={"opt_state": jstate.opt_state, "step": jstate.step})
    _, _, trainer, state = _trainers(setup)
    with pytest.raises((KeyError, TypeError)):
        driver.restore_checkpoint(trainer, state, d)
    params = dict(jstate.params)
    params.pop(sorted(params)[0])
    (d / "train_state.msgpack").unlink()
    jax_ckpt.save_pytree(params, d / "controlnet" / "params.msgpack")
    with pytest.raises(KeyError, match="missing"):
        driver.restore_checkpoint(trainer, state, d)


@pytest.mark.parametrize("limit", [None, 1, 2, 3])
def test_retention_matches_jax(tmp_path, limit):
    tree = {"w": np.arange(4, dtype=np.float32)}
    for pkg, save in (("jax", jax_ckpt.save_step_checkpoint), ("port", ckpt.save_step_checkpoint)):
        seen = []
        for step in (2, 4, 6, 8, 10):
            save(tmp_path / pkg, step, model_params=tree, train_state={"step": np.int32(step)},
                 total_limit=limit)
            seen.append([p.name for _, p in ckpt.list_step_checkpoints(tmp_path / pkg)])
        if pkg == "jax":
            want = seen
    assert seen == want
    assert (ckpt.latest_step_checkpoint(tmp_path / "port").name
            == jax_ckpt.latest_step_checkpoint(tmp_path / "jax").name == "checkpoint-10")


def test_async_checkpointer_copies_at_submit_and_raises_at_wait(tmp_path):
    t = torch.arange(6.0).reshape(2, 3)
    writer = ckpt.AsyncCheckpointer()
    writer.submit(ckpt.save_pytree, {"w": t, "wt": t.t(), "n": np.int32(1)}, tmp_path / "a.msgpack")
    t.add_(100.0)  # after submit: must not reach the file
    writer.wait()
    back = ckpt.load_pytree(tmp_path / "a.msgpack")
    np.testing.assert_array_equal(back["w"], np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(back["wt"], np.arange(6.0).reshape(2, 3).T)

    def fail():
        raise OSError("disk full")

    writer.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        writer.submit(ckpt.save_pytree, {}, tmp_path / "b.msgpack")  # waits on the failed one
    writer.close()


def _draws(key, cfg, augmentations=None):
    """The draws ``ControlNetTrainer._loss_fn`` makes from ``key``."""
    k_noise, k_t, k_sample = jax.random.split(key, 3)
    shape = (BSZ, IMAGE // 2, IMAGE // 2, 4)
    augment = None
    if augmentations:
        _, k_aug = jax.random.split(key)
        augment = jax_augment_draws(k_aug, augmentations, IMAGE, IMAGE)
    return training.Draws(
        sample_noise=torch.from_numpy(np.array(jax.random.normal(k_sample, shape, jnp.float32))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        timesteps=torch.from_numpy(
            np.array(jax_training.sample_train_timesteps(cfg, k_t, BSZ))).long(),
        augment=augment,
    )


def _port_batch(setup):
    return {k: torch.from_numpy(v) for k, v in setup["batch"].items()}


def test_step_resumed_from_jax_checkpoint_matches_jax(setup, tmp_path):
    """JAX takes a step and checkpoints; the port resumes from that
    checkpoint and takes the next step on JAX's next key's draws."""
    jt, jstate, trainer, state = _trainers(setup)
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    jstate, _ = jt.train_step(jstate, jb, jax.random.key(20))
    d = jax_ckpt.save_step_checkpoint(
        tmp_path, 1, model_params=jstate.params, model_subdir="controlnet",
        train_state={"opt_state": jstate.opt_state, "step": jstate.step})
    key = jax.random.key(21)
    jstate, want = jt.train_step(jstate, jb, key)
    state = driver.restore_checkpoint(trainer, state, d)
    assert state.step == 1 and state.opt_state.count == 1
    state, got = trainer.step_with_draws(state, _port_batch(setup), _draws(key, jt.cfg))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == 2
    for k, v in state_dict_from_jax(_np(jstate.params), "diffusers_controlnet").items():
        np.testing.assert_allclose(state.params[k].numpy(), v, atol=PARAM_ATOL, err_msg=k)


def test_linear_betas_and_velocity_match_jax():
    cfg = dict(beta_schedule="linear", prediction_type="v_prediction")
    acp = jax_sched.make_alphas_cumprod(jax_sched.SchedulerConfig(**cfg))
    np.testing.assert_array_equal(schedulers.make_alphas_cumprod(schedulers.SchedulerConfig(**cfg)),
                                  acp)
    rng = np.random.RandomState(3)
    x, n = (rng.randn(3, 4, 8, 8).astype(np.float32) for _ in range(2))
    t = np.array([0, 499, 999])
    want = jax_sched.get_velocity(jnp.asarray(acp), jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    got = schedulers.get_velocity(torch.from_numpy(acp), *map(torch.from_numpy, (x, n, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_loss_with_velocity_linear_betas_and_augmentations_matches_jax(setup):
    aug = "colorjitter,elastic,blur,affine,crop"
    sched = dict(beta_schedule="linear", prediction_type="v_prediction")
    jt = jax_training.ControlNetTrainer(setup["pipe"], jax_training.TrainConfig(
        augmentations=aug, scheduler_config=jax_sched.SchedulerConfig(**sched)))
    jt.create_state(setup["params"])
    key = jax.random.key(30)
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    want = jax.jit(jt._loss_fn)(setup["params"]["controlnet"], jt._frozen, jb, key)
    pipe = _port_pipe()
    trainer = training.ControlNetTrainer(pipe, training.TrainConfig(
        augmentations=aug, scheduler_config=schedulers.SchedulerConfig(**sched)))
    state = trainer.create_state(pipe.params_from_jax(setup["tree"]))
    trainer.sync_working_copy(state)
    got = trainer.loss(_port_batch(setup), _draws(key, jt.cfg, aug))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


# -- weights from disk ---------------------------------------------------------------


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load, save_file

    rng = np.random.RandomState(0)
    tensors = {
        "f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
        "bf16": torch.from_numpy(rng.randn(2, 3, 4).astype(np.float32)).bfloat16(),
        "i64": torch.arange(-3, 6, dtype=torch.int64),
        "i32": torch.arange(4, dtype=torch.int32).reshape(2, 2),
        "empty": torch.zeros(0, 3),
        "scalar": torch.tensor(2.5),
    }
    path = tmp_path / "model.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got = load_pretrained.load_torch_file(path)
    assert sorted(got) == sorted(tensors)
    numpy_ref = np_load(str(path))  # the numpy loader has no bf16
    torch_ref = torch_load(str(path))
    for k, t in got.items():
        assert t.dtype == tensors[k].dtype and t.shape == tensors[k].shape, k
        assert torch.equal(t, torch_ref[k]), k
        if k != "bf16":
            np.testing.assert_array_equal(t.numpy(), numpy_ref[k], err_msg=k)
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError):
        load_pretrained.load_torch_file(bad)


def test_load_pretrained_pipeline_matches_jax(setup, tmp_path):
    """unet as diffusers safetensors, vae as a torch .bin, the text encoder
    as native msgpack, an empty controlnet dir, no text_encoder_2."""
    from safetensors.numpy import save_file

    src = _np(setup["params"])
    (tmp_path / "unet").mkdir()
    save_file(export_torch_state_dict(src["unet"], "diffusers_unet"),
              str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors"))
    (tmp_path / "vae").mkdir()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                export_torch_state_dict(src["vae"], "diffusers_vae").items()},
               tmp_path / "vae" / "diffusion_pytorch_model.bin")
    jax_ckpt.save_pytree(src["text_encoder"], tmp_path / "text_encoder" / "params.msgpack")
    (tmp_path / "controlnet").mkdir()

    jtarget = _np(setup["pipe"].init_params(jax.random.key(5), image_size=IMAGE))
    want_report = jax_load_pretrained.load_pretrained_pipeline(tmp_path, jtarget)
    pipe = _port_pipe()
    params = pipe.init_params(torch.Generator().manual_seed(5))
    cn_before = {k: t.clone() for k, t in params["controlnet"].state_dict().items()}
    report = load_pretrained.load_pretrained_pipeline(tmp_path, params)
    assert report == want_report == {"unet": "diffusers", "controlnet": "no-weights-file",
                                     "vae": "diffusers", "text_encoder": "native"}
    for name, family in load_pretrained.FAMILIES.items():
        if name == "controlnet":
            continue
        want = state_dict_from_jax(_np(jtarget[name]), family)
        got = params[name].state_dict()
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{name}.{k}")
    assert all(torch.equal(cn_before[k], t) for k, t in params["controlnet"].state_dict().items())


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_diffusers_file_loads_strictly(setup, tmp_path, fault):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export_torch_state_dict(_np(setup["params"]["text_encoder"]), "hf_clip").items()}
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]  # dropped, as JAX does
    if fault == "missing":
        sd.pop(sorted(sd)[0])
    elif fault == "extra":
        sd["text_model.unexpected.weight"] = torch.zeros(2)
    else:
        k = "text_model.final_layer_norm.weight"
        sd[k] = torch.zeros(sd[k].shape[0] + 1)
    (tmp_path / "text_encoder").mkdir()
    torch.save(sd, tmp_path / "text_encoder" / "pytorch_model.bin")
    params = {"text_encoder": _port_pipe().init_params(torch.Generator().manual_seed(0))["text_encoder"]}
    with pytest.raises((RuntimeError, ValueError)):
        load_pretrained.load_pretrained_pipeline(tmp_path, params)
