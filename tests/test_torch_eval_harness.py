"""The port's closed-loop eval against the JAX package's, on the fake env.

A tiny controller is trained once with the JAX ``train_act`` CLI (frame
stack 2, so the camera-major view order and a diffusion batch of 2 are
exercised). Both packages then evaluate it:

- ``GenimaEvalWorkspace`` on the fused path (guidance 0), the CFG path
  (guidance 2.0, negative prompts, the split infer -> untile -> ACT path)
  and the ACT-only path. The diffusion, ACT and CLIP params are carried
  across (the port loads the controller checkpoint with its own codec), and
  the same latents are injected into both diffusion agents by patching
  ``_next_latents`` on the two instances: the packages' RNGs differ.
  Rewards, steps and per-episode log entries must be equal, and the action
  chunk of every control step within ``ACTION_ATOL``: both run in f32 on the
  CPU (chunks agree to ~6e-5 here), but a target pixel on a .5 boundary may
  round the other way (1 LSB, ``test_torch_fused_step.py``) and move the
  tiny controller's actions by ~2e-4.
- the CLIs, ``eval_genima.main`` and ``eval_act.main`` with ``device=cpu``:
  the same episode count and steps in ``eval_genima_fake_reach.json``.

The port's results carry one key the JAX package's lack,
``env_exception_episodes`` (episodes an env exception ended), which must be 0.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.cli import eval_act as jax_eval_act
from genima_tpu.cli import eval_genima as jax_eval_genima
from genima_tpu.cli import train_act as jax_train_act
from genima_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.eval.agents import SDControlNetAgent as JaxSDAgent
from genima_tpu.eval.harness import GenimaEvalWorkspace as JaxWorkspace
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

from genima_torch.cli import eval_act, eval_genima
from genima_torch.core import checkpoint as ckpt
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval.agents import SDControlNetAgent
from genima_torch.eval.harness import GenimaEvalWorkspace
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import AutoencoderTiny, VAEConfig

ACTION_ATOL = 5e-4
FRAME_STACK = 2
HORIZON = 6
EVAL_ARGS = [
    "task=fake_reach", "env.factory=fake", "env.image_size=32", "episode_length=20",
    "num_eval_episodes=2", f"execution_horizon={HORIZON}", "eval_type=latest",
    "num_diffusion_steps=2",
]
PORT_KEYS_ONLY = {"env_exception_episodes"}


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
def trained(tmp_path_factory):
    work = tmp_path_factory.mktemp("ctrl")
    jax_train_act.main([
        f"work_dir={work}", "env.factory=fake", "env.task=fake_reach", "env.image_size=32",
        "env.episode_length=20", "num_train_epochs=1", "checkpoint_every=1", "num_demos=2",
        "batch_size=4", f"action_sequence={HORIZON}", f"frame_stack={FRAME_STACK}",
        "method.image_size=32", "+method.resnet_width=8", "method.act_cfg.hidden_dim=32",
        "method.act_cfg.enc_layers=1", "method.act_cfg.dec_layers=1",
        "method.act_cfg.dim_feedforward=64", "method.act_cfg.nheads=2",
        "method.act_cfg.latent_dim=8", "method.act_cfg.lang_dim=16",
        "method.data_augmentation=false",
    ])
    return work


def _copy(trained, tmp_path, name):
    """A copy of the trained checkpoint dir: each run writes its own logs."""
    dst = tmp_path / name
    shutil.copytree(trained, dst)
    return dst


@pytest.fixture(scope="module")
def diffusion_params():
    """The tiny JAX pipeline's params with its ControlNet zero convs drawn
    at random, so the ControlNet shapes the targets."""
    pipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                       text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32)
    params = pipe.init_params(jax.random.key(0), 64)
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    return pipe, params


def _inject_latents(agent, to_array):
    """Per call n, seeded standard-normal latents (batch, 32, 32, 4)."""
    calls = []

    def next_latents(batch):
        calls.append(batch)
        return to_array(np.random.RandomState(100 + len(calls)).randn(batch, 32, 32, 4)
                        .astype(np.float32))

    agent._next_latents = next_latents
    return calls


def _record_actions(env):
    chunks = []
    step = env.step

    def recording(actions):
        chunks.append(np.asarray(actions, np.float32).copy())
        return step(actions)

    env.step = recording
    return chunks


def _jax_run(ctrl_dir, argv, diffusion):
    eval_cfg, train_cfg = jax_eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl_dir}"] + argv)
    env = jax_eval_genima.build_eval_env(eval_cfg, train_cfg, ctrl_dir)
    agent = jax_eval_genima.build_controller_agent(train_cfg, eval_cfg)
    params, clip = agent.init_params(jax.random.key(eval_cfg.seed))
    agent.create_state(params, clip)
    dag, calls = None, []
    if diffusion is not None:
        pipe, dparams = diffusion
        dag = JaxSDAgent(pipe=pipe, resolution=64, dtype=jnp.float32)
        dag.params = dparams
        calls = _inject_latents(dag, jnp.asarray)
    chunks = _record_actions(env)
    ws = JaxWorkspace(eval_cfg, env, agent, diffusion_agent=dag,
                      cameras=eval_cfg.env.cameras, tokenizer=jax_load_tokenizer(None))
    return ws.eval(), chunks, calls, clip


def _jax_clip_params(ctrl_dir):
    """The CLIP tower the JAX eval CLI makes (seeded; checkpoints hold none)."""
    eval_cfg, train_cfg = jax_eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl_dir}"] + EVAL_ARGS)
    agent = jax_eval_genima.build_controller_agent(train_cfg, eval_cfg)
    return agent.init_params(jax.random.key(eval_cfg.seed))[1]


def _port_run(ctrl_dir, argv, diffusion, clip_tree):
    eval_cfg, train_cfg = eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl_dir}", "device=cpu"] + argv)
    env = eval_genima.build_eval_env(eval_cfg, train_cfg, ctrl_dir)
    agent = eval_genima.build_controller_agent(train_cfg, eval_cfg)
    tree = ckpt.load_epoch_checkpoint(ctrl_dir / "latest.ckpt")["agent"]
    agent.params_from_jax(tree, jax.tree_util.tree_map(np.asarray, clip_tree))
    dag, calls = None, []
    if diffusion is not None:
        jpipe, dparams = diffusion
        pipe = SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                    text_cfg=CLIPTextConfig.tiny(), device="cpu")
        params = pipe.params_from_jax(jax.tree_util.tree_map(np.asarray, dparams))
        dag = SDControlNetAgent(pipe=pipe, params=params, resolution=64)
        calls = _inject_latents(dag, torch.from_numpy)
    chunks = _record_actions(env)
    ws = GenimaEvalWorkspace(eval_cfg, env, agent, diffusion_agent=dag,
                             cameras=eval_cfg.env.cameras, tokenizer=load_tokenizer(None))
    return ws.eval(), chunks, calls


def _assert_same_eval(jax_out, port_out):
    (jlogs, jchunks, jcalls), (plogs, pchunks, pcalls) = jax_out[:3], port_out
    assert jcalls == pcalls  # the same latent draws, in the same order
    assert plogs["eval_episodes"] == jlogs["eval_episodes"]
    assert set(plogs["results"]) == set(jlogs["results"]) | PORT_KEYS_ONLY
    assert plogs["results"]["env_exception_episodes"] == 0
    assert {k: plogs["results"][k] for k in jlogs["results"]} == jlogs["results"]
    assert len(pchunks) == len(jchunks) > 0
    for i, (p, j) in enumerate(zip(pchunks, jchunks)):
        assert p.shape == j.shape == (HORIZON, 8)
        np.testing.assert_allclose(p, j, atol=ACTION_ATOL, rtol=0, err_msg=f"control step {i}")


@pytest.mark.parametrize("guidance", [0.0, 2.0])
def test_harness_with_diffusion_matches_jax(trained, diffusion_params, tmp_path, guidance):
    argv = EVAL_ARGS + [f"guidance_scale={guidance}"]
    jax_out = _jax_run(_copy(trained, tmp_path, "jax"), argv, diffusion_params)
    port_out = _port_run(_copy(trained, tmp_path, "port"), argv, diffusion_params, jax_out[3])
    _assert_same_eval(jax_out, port_out)
    # fused path: one latent draw of batch fs per control step plus the two
    # of the one-off gen-time measurement; CFG: one per control step
    steps = sum(-(-e["steps"] // HORIZON) for e in port_out[0]["eval_episodes"])
    assert len(port_out[2]) == steps + (2 if guidance <= 1 else 0)
    assert set(port_out[2]) == {FRAME_STACK}
    saved = json.loads((tmp_path / "port" / "eval_genima_fake_reach.json").read_text())
    want = json.loads((tmp_path / "jax" / "eval_genima_fake_reach.json").read_text())
    assert saved["eval_episodes"] == want["eval_episodes"]


def test_harness_act_only_matches_jax(trained, tmp_path):
    jax_out = _jax_run(_copy(trained, tmp_path, "jax"), EVAL_ARGS, None)
    port_out = _port_run(_copy(trained, tmp_path, "port"), EVAL_ARGS, None, jax_out[3])
    _assert_same_eval(jax_out, port_out)


CLI_ARGS = [
    "task=fake_reach", "env.factory=fake", "env.image_size=32", "episode_length=20",
    "num_eval_episodes=1", f"execution_horizon={HORIZON}", "eval_type=latest",
]
TINY_AGENT = ["num_diffusion_steps=2", "+diffusion_agent.resolution=64",
              "enable_xformers_memory_efficient_attention=false"]


def _episode_steps(logs):
    return [(e["episode"], e["steps"]) for e in logs["eval_episodes"]]


def test_eval_genima_cli_matches_jax(trained, tmp_path):
    jdir, pdir = _copy(trained, tmp_path, "jax"), _copy(trained, tmp_path, "port")
    want = jax_eval_genima.main([f"controller_ckpt={jdir}"] + CLI_ARGS + TINY_AGENT + [
        "diffusion_agent._target_=genima_tpu.eval.agents.make_tiny_sd_agent"])
    got = eval_genima.main([f"controller_ckpt={pdir}", "device=cpu"] + CLI_ARGS + TINY_AGENT + [
        "diffusion_agent._target_=genima_torch.eval.agents.make_tiny_sd_agent"])
    saved = json.loads((pdir / "eval_genima_fake_reach.json").read_text())
    assert saved["results"]["total_episodes"] == want["results"]["total_episodes"] == 1
    assert _episode_steps(saved) == _episode_steps(want) == _episode_steps(got)
    assert saved["results"]["env_exception_episodes"] == 0
    metrics = [json.loads(line) for line in (pdir / "eval_logs" / "metrics.jsonl").open()]
    assert {"eval_genima/gen_time", "eval_genima/control_time",
            "eval_genima/fused_step_time"} <= set(metrics[-1])


def test_eval_act_cli_matches_jax(trained, tmp_path):
    jdir, pdir = _copy(trained, tmp_path, "jax"), _copy(trained, tmp_path, "port")
    want = jax_eval_act.main([f"controller_ckpt={jdir}"] + CLI_ARGS)
    eval_act.main([f"controller_ckpt={pdir}", "device=cpu"] + CLI_ARGS)
    saved = json.loads((pdir / "eval_genima_fake_reach.json").read_text())
    assert saved["results"]["total_episodes"] == want["results"]["total_episodes"] == 1
    assert _episode_steps(saved) == _episode_steps(want)


def test_cli_refuses_what_is_not_ported(trained, tmp_path):
    pdir = _copy(trained, tmp_path, "port")
    # mesh serving runs; a mesh whose data rows do not divide the envs does not
    with pytest.raises(ValueError, match="multiple of the mesh data size"):
        eval_genima.main([f"controller_ckpt={pdir}", "device=cpu", "num_parallel_envs=2",
                          "eval_data_parallel=true", "eval_mesh_devices=3"] + CLI_ARGS)
    with pytest.raises(FileNotFoundError, match="clip_weights"):
        eval_act.main([f"controller_ckpt={pdir}", "device=cpu",
                       f"clip_weights={tmp_path / 'missing.pt'}"] + CLI_ARGS)
    with pytest.raises(ValueError, match="controller_ckpt"):
        eval_act.main(["device=cpu"] + CLI_ARGS)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            eval_act.main([f"controller_ckpt={pdir}"] + CLI_ARGS)


NO_OP_ARGS = ["torch_compile=true", "channel_last=true", "allow_tf32=true", "vae_slicing=true",
              "upcast_vae=true", "fused_projections=true", "temporal_agg=true", "wandb.use=true"]


@pytest.mark.parametrize("cli", ["eval_act", "eval_genima"])
def test_cli_runs_with_the_no_op_keys_and_wandb(trained, tmp_path, monkeypatch, capsys, cli):
    """The seven keys ``eval_genima.yaml`` declares and no JAX module reads
    run as no-ops (one line names them); ``wandb.use`` reaches the logger.
    ``eval_act.yaml`` declares none of the seven (in JAX too), so there they
    are added with ``+``."""
    pdir = _copy(trained, tmp_path, "port")
    loggers = []

    class RecordingLogger(eval_genima.MetricLogger):
        def __init__(self, *a, **kw):
            loggers.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(eval_genima, "MetricLogger", RecordingLogger)
    if cli == "eval_act":
        logs = eval_act.main([f"controller_ckpt={pdir}", "device=cpu"] + CLI_ARGS
                             + [f"+{a}" for a in NO_OP_ARGS[:-1]] + NO_OP_ARGS[-1:])
    else:
        logs = eval_genima.main([f"controller_ckpt={pdir}", "device=cpu"] + CLI_ARGS + TINY_AGENT
                                + NO_OP_ARGS + ["episode_length=6", "diffusion_agent._target_="
                                                "genima_torch.eval.agents.make_tiny_sd_agent"])
    assert logs["results"]["total_episodes"] == 1
    assert loggers[0]["use_wandb"] is True
    out = capsys.readouterr().out
    assert ("no effect here, as in the JAX package: torch_compile, channel_last, allow_tf32, "
            "vae_slicing, upcast_vae, fused_projections, temporal_agg") in out


@pytest.mark.parametrize("argv,error,match", [
    # the simulator gate, with JAX's error type (no RLBench here)
    (["colosseum_use=true", "colosseum_task_config=random_camera_poses", "env.factory=rlbench"],
     ImportError, "rlbench/pyrep are not installed"),
    # JAX's mesh checks
    (["eval_data_parallel=true", "eval_mesh_devices=3", "num_parallel_envs=2"], ValueError,
     "multiple of the mesh data size"),
    (["eval_tensor_parallel=3", "eval_mesh_devices=2", "num_parallel_envs=2"], ValueError,
     "must divide the mesh device count"),
])
def test_cli_still_refuses_the_unported_options(trained, tmp_path, argv, error, match):
    pdir = _copy(trained, tmp_path, "port")
    with pytest.raises(error, match=match):
        eval_genima.main([f"controller_ckpt={pdir}", "device=cpu"] + CLI_ARGS + argv)


def test_cli_runs_the_tiny_vae_with_autoencoder_taesd(trained, tmp_path, monkeypatch):
    """``autoencoder=taesd`` reaches the agent, whose pipeline then decodes
    every control step's latents with the tiny VAE."""
    decodes = []
    real = AutoencoderTiny.decode
    monkeypatch.setattr(AutoencoderTiny, "decode",
                        lambda self, z: decodes.append(tuple(z.shape)) or real(self, z))
    pdir = _copy(trained, tmp_path, "port")
    logs = eval_genima.main([f"controller_ckpt={pdir}", "device=cpu"] + CLI_ARGS + TINY_AGENT
                            + ["episode_length=6", "autoencoder=taesd", "diffusion_agent._target_="
                               "genima_torch.eval.agents.make_tiny_sd_agent"])
    assert logs["results"]["total_episodes"] == 1
    assert logs["results"]["env_exception_episodes"] == 0
    assert decodes and all(shape[1:] == (4, 32, 32) for shape in decodes)


def test_harness_saves_videos_and_debug_images(trained, diffusion_params, tmp_path):
    """save_video / save_gen_image / save_input_image on the fused path
    (PIL is imported only here)."""
    media = tmp_path / "media"
    argv = EVAL_ARGS + ["num_eval_episodes=1", "save_video=true", "save_gen_image=true",
                        "save_input_image=true", f"save_image_path={media}"]
    (logs, _, _) = _port_run(_copy(trained, tmp_path, "port"), argv, diffusion_params,
                             _jax_clip_params(trained))
    assert logs["results"]["total_episodes"] == 1
    videos = list((media / "videos").iterdir())
    assert len(videos) == 1 and videos[0].name.startswith("fake_reach_ep1_")
    for kind in ("input", "gen_target"):
        assert len(list(media.glob(f"{kind}_ep0_step*_frame*.png"))) == 4 * FRAME_STACK
