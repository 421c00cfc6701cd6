"""The InstructPix2Pix and tiny-VAE agents in the port's closed-loop eval,
and the pix2pix trainer CLI, on the CPU.

The controller checkpoint, its tiny CLIP tower and the eval arguments are
``test_torch_sdxl_eval.py``'s (32x32 tiles of four 16x16 views); the
diffusion models are ``test_torch_pix2pix.py``'s tiny ones, f32.

- Held to JAX: one serial episode (2 control steps) of
  ``GenimaEvalWorkspace`` with the pix2pix agent, and with the SD agent
  decoding through the tiny VAE (``autoencoder=taesd``), the same latents
  injected into both packages' agents: equal episode entries and every
  action chunk within ``ACTION_ATOL``.
- Held in the port: lockstep episodes (2 envs) equal to the same episodes
  run serially; the pix2pix trainer CLI (every flag of JAX's
  ``build_parser("pix2pix")`` is held in ``test_torch_sdxl_eval.py``) with
  EMA and conditioning dropout, a checkpoint, a resume whose EMA is the
  written one bit for bit, and the final save, the EMA, which JAX's
  ``load_pytree`` reads; then the eval CLI with
  ``diffusion_agent._target_=genima_torch.eval.agents.SDPix2PixAgent`` (its
  pipeline cut to the tiny widths) on that save, serially and at 2 envs,
  with and without ``autoencoder=taesd``.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from genima_tpu.cli import eval_genima as jax_eval_genima
from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from genima_tpu.diffusion import training as jax_training
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxSDPipeline
from genima_tpu.eval.agents import SDControlNetAgent as JaxSDAgent
from genima_tpu.eval.agents import SDPix2PixAgent as JaxPix2PixAgent
from genima_tpu.eval.harness import GenimaEvalWorkspace as JaxWorkspace
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

from test_torch_pix2pix import _np, jax_fast_params, jax_tiny_pipe
from test_torch_sdxl_eval import (  # noqa: F401  (fixtures)
    ACTION_ATOL, CLI_ARGS, EVAL_ARGS, HORIZON, LANG_DIM, LAT, RES, STEPS, _inject,
    _port_parallel, _port_serial, _record_actions, ctrl, jax_clip, one_torch_thread,
)

from genima_torch.cli import eval_genima, train_instruct_pix2pix_genima
from genima_torch.control import policy
from genima_torch.diffusion import driver
from genima_torch.diffusion.pipeline import SDControlNetPipeline, SDPix2PixPipeline
from genima_torch.eval import agents
from genima_torch.eval.agents import SDControlNetAgent, SDPix2PixAgent
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights.from_jax import state_dict_from_jax

KINDS = ("pix2pix", "taesd")


def _trees(kind: str) -> dict:
    fp = jax_fast_params()
    if kind == "pix2pix":
        return {k: fp[k] for k in ("unet", "vae", "text_encoder")}
    return {"unet": fp["sd_unet"], "controlnet": fp["sd_controlnet"], "vae": fp["vae"],
            "text_encoder": fp["text_encoder"], "tiny_vae": fp["tiny_vae"]}


def _tiny_pipe(kind: str, **kw):
    if kind == "pix2pix":
        return SDPix2PixPipeline(unet_cfg=UNetConfig.tiny(in_channels=8),
                                 vae_cfg=VAEConfig.tiny_test(), text_cfg=CLIPTextConfig.tiny(),
                                 **kw)
    return SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), use_tiny_vae=True, **kw)


def _port_agent(kind: str):
    pipe = _tiny_pipe(kind, device="cpu")
    cls = SDPix2PixAgent if kind == "pix2pix" else SDControlNetAgent
    return cls(pipe=pipe, params=pipe.params_from_jax(_np(_trees(kind))), resolution=RES,
               autoencoder="" if kind == "pix2pix" else "taesd")


def _jax_agent(kind: str):
    params = _trees(kind)
    if kind == "pix2pix":
        jpipe, cls = jax_tiny_pipe(), JaxPix2PixAgent
    else:
        jpipe = JaxSDPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                              text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32,
                              use_tiny_vae=True)
        cls = JaxSDAgent
    # the agent's init program replaced by the trees (no init is compiled)
    jpipe.init_params = lambda key, image_size=512, **kw: dict(params)
    try:
        jdag = cls(pipe=jpipe, resolution=RES, dtype=jnp.float32)
    finally:
        del jpipe.init_params
    jdag.params = params
    return jdag


@pytest.mark.parametrize("kind", KINDS)
def test_serial_episode_matches_jax(ctrl, jax_clip, kind):
    jdag = _jax_agent(kind)
    jcalls, _ = _inject(jdag, jnp.asarray, None)
    jcfg, jtrain = jax_eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl}", "num_eval_episodes=1"] + EVAL_ARGS)
    jagent = dataclasses.replace(jax_eval_genima.build_controller_agent(jtrain, jcfg),
                                 clip_cfg=JaxCLIPConfig.tiny(projection_dim=LANG_DIM))
    jagent._clip_params = jax.tree_util.tree_map(jnp.asarray, jax_clip)
    jenv = jax_eval_genima.build_eval_env(jcfg, jtrain, ctrl)
    jchunks = _record_actions(jenv)
    jws = JaxWorkspace(jcfg, jenv, jagent, diffusion_agent=jdag, cameras=jcfg.env.cameras,
                       tokenizer=jax_load_tokenizer(None))
    jws._fused_gen_est = 0.0
    jlogs = jws.eval()

    port = _port_agent(kind)
    pcalls, _ = _inject(port, torch.from_numpy, None)
    ws, pchunks = _port_serial(ctrl, jax_clip, port, ["num_eval_episodes=1"])
    plogs = ws.eval()

    assert jcalls == pcalls == {"latents": 2, "noise": 0}
    assert plogs["eval_episodes"] == jlogs["eval_episodes"]
    assert plogs["results"]["env_exception_episodes"] == 0
    assert len(pchunks[0]) == len(jchunks) == 2
    for i, (p, j) in enumerate(zip(pchunks[0], jchunks)):
        assert p.shape == j.shape == (HORIZON, 8)
        np.testing.assert_allclose(p, j, atol=ACTION_ATOL, rtol=0, err_msg=f"control step {i}")


@pytest.mark.parametrize("kind", KINDS)
def test_batched_episodes_equal_the_serial_harness(ctrl, jax_clip, kind):
    """2 envs in one batch, 2 episodes, against the serial harness: each
    slot's latents come from a generator of its own seeded as the serial
    agent's, so the episodes and every chunk agree."""
    dag = _port_agent(kind)
    decodes = []
    model = dag.params["tiny_vae" if kind == "taesd" else "vae"]
    decode = model.decode
    model.decode = lambda z: decodes.append(z.shape[0]) or decode(z)
    serial, s_chunks = _port_serial(ctrl, jax_clip, dag, ["num_eval_episodes=2"])
    s_logs = serial.eval()
    ws, p_chunks = _port_parallel(ctrl, jax_clip, dag, 2, [
        "num_eval_episodes=2", "num_parallel_envs=2", "eval_overlap=false"])
    try:
        p_logs = ws.eval()
    finally:
        ws.close()
    assert p_logs["eval_episodes"] == s_logs["eval_episodes"]
    assert 1 in decodes and 2 in decodes  # serial and batched generates decoded
    want = [s_chunks[0][:2], s_chunks[0][2:]]  # 2 chunks an episode
    for env_i, (got, ref) in enumerate(zip(p_chunks, want)):
        assert len(got) == len(ref) == 2
        for p, s in zip(got, ref):
            np.testing.assert_allclose(p, s, atol=ACTION_ATOL, rtol=0, err_msg=f"env {env_i}")


# -- the trainer CLI, then the eval CLI on its save ----------------------------------------

BSZ = 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train_instruct_pix2pix_genima.main`` on the tiny pipeline with
    ``--use_ema``: run A, 2 steps with a checkpoint each (limit 1) and a
    validation at step 2; run B resumes ``latest`` to step 3."""
    root = tmp_path_factory.mktemp("pix2pix")
    rng = np.random.RandomState(0)
    data = root / "data"
    for ep in range(2):
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = data / "toy" / "variation0" / "episodes" / f"episode{ep}" / sub
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.randint(0, 255, (RES, RES, 3), dtype=np.uint8)).save(
                    d / f"{i}.png")
    out = root / "out"
    runs = {"steps": [], "restored": []}
    real_run, real_restore = driver.run_training, driver.restore_checkpoint
    mp = pytest.MonkeyPatch()
    mp.setattr(driver, "build_pipeline", lambda args, variant="sd", device=None:
               _tiny_pipe("pix2pix", device="cpu"))

    def restore(trainer, state, resume_dir):
        got = real_restore(trainer, state, resume_dir)
        runs["restored"].append({k: v.clone() for k, v in got.ema.items()})
        return got

    mp.setattr(driver, "restore_checkpoint", restore)

    def run(args, variant="sd", **kw):
        assert variant == "pix2pix"
        return real_run(args, variant, step_hook=lambda step, state, m: runs["steps"].append(
            {"step": step, "ema": {k: v.clone() for k, v in state.ema.items()},
             "params": {k: v.clone() for k, v in state.params.items()}}), **kw)

    mp.setattr(train_instruct_pix2pix_genima, "run_training", run)
    argv = ["--data_path", str(data), "--tasks", "toy", "--resolution", str(RES),
            "--train_batch_size", str(BSZ), "--seed", "0", "--mixed_precision", "no",
            "--enable_xformers_memory_efficient_attention", "--dataloader_num_workers", "2",
            "--output_dir", str(out), "--report_to", "none", "--device", "cpu",
            "--use_ema", "--conditioning_dropout_prob", "0.3", "--learning_rate", "1e-3",
            "--checkpointing_steps", "1", "--checkpoints_total_limit", "1"]
    try:
        a = train_instruct_pix2pix_genima.main(argv + ["--max_train_steps", "2",
                                                       "--validation_steps", "2"])
        b = train_instruct_pix2pix_genima.main(argv + ["--max_train_steps", "3",
                                                       "--resume_from_checkpoint", "latest"])
    finally:
        mp.undo()
    return {"out": out, "a": a, "b": b, "runs": runs}


def test_trainer_cli_checkpoints_resumes_and_saves_the_ema(trained):
    out, runs = trained["out"], trained["runs"]
    assert trained["a"]["global_step"] == 2 and np.isfinite(trained["a"]["val_mse"])
    assert trained["b"]["global_step"] == 3
    assert [s["step"] for s in runs["steps"]] == [1, 2, 3]
    assert sorted(p.name for p in out.glob("checkpoint-*")) == ["checkpoint-3"]
    assert (out / "checkpoint-3" / "unet" / "params.msgpack").exists()
    assert (out / "logs" / "validation" / "step2_val0.png").exists()
    # the resume's EMA is the one written at step 2, bit for bit
    step2 = runs["steps"][1]["ema"]
    for k, v in runs["restored"][0].items():
        assert torch.equal(v, step2[k]), k
    last = runs["steps"][2]
    assert any(not torch.equal(last["ema"][k], last["params"][k]) for k in last["ema"])
    # the final save is the EMA, and JAX's load_pytree reads it and the
    # checkpoint's ema.msgpack against its own UNet tree
    jt = jax_training.Pix2PixTrainer(jax_tiny_pipe(), jax_training.TrainConfig(), None,
                                     use_ema=True)
    jstate = jt.create_state({k: v for k, v in _trees("pix2pix").items()})
    for path, want in ((out / "unet" / "params.msgpack", last["ema"]),
                       (out / "checkpoint-3" / "ema.msgpack", last["ema"])):
        tree = jax_ckpt.load_pytree(path, target=jstate.ema)
        for k, v in state_dict_from_jax(_np(tree), "diffusers_unet").items():
            np.testing.assert_array_equal(want[k].numpy(), v, err_msg=f"{path.name} {k}")


@pytest.mark.parametrize("n_envs,autoencoder", [(1, ""), (2, "taesd")])
def test_eval_cli_runs_the_pix2pix_agent_on_the_final_save(ctrl, trained, tmp_path, monkeypatch,
                                                           n_envs, autoencoder):
    """``diffusion_agent._target_=...SDPix2PixAgent``, its pipeline cut to
    the tiny widths: the agent loads the fine-tune's final save (the EMA,
    ``<out>/unet``: on the output dir it would take the latest checkpoint's
    params, as JAX's does); with ``autoencoder=taesd`` it decodes with the
    tiny VAE."""
    build = policy.build_agent

    def build_tiny(cfg, device="cuda", dtype=None):
        agent = build(cfg, device=device, dtype=dtype)
        agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=LANG_DIM)
        return agent

    monkeypatch.setattr(policy, "build_agent", build_tiny)
    made = []

    def tiny(backend, device, use_tiny_vae):
        made.append(_tiny_pipe("pix2pix", backend=backend, device=device,
                               use_tiny_vae=use_tiny_vae))
        return made[-1]

    monkeypatch.setattr(SDPix2PixAgent, "PIPELINE", staticmethod(tiny))
    loaded = []
    real_load = SDPix2PixAgent._load_params
    monkeypatch.setattr(SDPix2PixAgent, "_load_params",
                        lambda self: loaded.append(real_load(self)) or loaded[-1])
    d = tmp_path / "ctrl"
    shutil.copytree(ctrl, d)
    logs = eval_genima.main(
        [f"controller_ckpt={d}", "device=cpu", "num_eval_episodes=2",
         f"num_parallel_envs={n_envs}", f"diffusion_ckpt={trained['out'] / 'unet'}",
         f"num_diffusion_steps={STEPS}", f"image_resolution={RES}",
         "diffusion_agent._target_=genima_torch.eval.agents.SDPix2PixAgent"] + CLI_ARGS
        + ([f"autoencoder={autoencoder}"] if autoencoder else []))
    results = logs["results"]
    assert results["total_episodes"] == 2 and results["env_exception_episodes"] == 0
    assert [e["steps"] for e in logs["eval_episodes"]] == [20, 20]
    assert len(made) == 1 and made[0].use_tiny_vae == (autoencoder == "taesd")
    assert ("tiny_vae" in loaded[0]) == (autoencoder == "taesd")
    ema = trained["runs"]["steps"][-1]["ema"]
    got = loaded[0]["unet"].state_dict()
    for k, v in ema.items():
        assert torch.equal(got[k], v), k
    assert agents.make_tiny_pix2pix_agent(device="cpu").pipe.unet_cfg.in_channels == 8
