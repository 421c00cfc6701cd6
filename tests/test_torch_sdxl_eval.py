"""The SDXL agent in the port's closed-loop eval and its trainer CLI, on the CPU.

A tiny controller checkpoint is written from seeded port weights (no
training); every controller gets the same seeded tiny CLIP tower, made by
JAX and carried to the port. The diffusion models are the tiny SDXL ones of
``test_torch_sdxl.py`` at 32x32 tiles of four 16x16 views (16x16 latents, so
the 256-token self-attentions take the packed path), f32.

- Held to JAX: one serial episode (2 control steps) of
  ``GenimaEvalWorkspace`` with the same latents injected into both agents
  and the same ancestral noise (JAX's key chain into JAX's agent, its draws
  into the port's): equal episode entries and every action chunk within
  ``ACTION_ATOL`` (a target pixel on a .5 boundary may round the other way
  and move the tiny controller's actions by ~2e-4).
- Held in the port: lockstep episodes (2 envs, overlap on and off) equal to
  the same episodes run serially, each slot's latents and ancestral noise
  from generators of its own seeded as the serial agent's; the eval CLI
  with ``make_tiny_sdxl_agent``, serially and with ``num_parallel_envs=2``;
  the SDXL trainer CLI (every flag of JAX's ``build_parser("sdxl")``, 2
  steps with a checkpoint and a validation, the final save loaded by the
  SDXL agent).
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from genima_tpu.cli import eval_genima as jax_eval_genima
from genima_tpu.cli._diffusion_args import build_parser as jax_build_parser
from genima_tpu.control.policy import fast_init as jax_fast_init
from genima_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from genima_tpu.eval.agents import SDXLControlNetAgent as JaxSDXLAgent
from genima_tpu.eval.harness import GenimaEvalWorkspace as JaxWorkspace
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.clip_text import CLIPTextModel as JaxCLIPTextModel

from test_torch_sdxl import _noise_chain, _np, jax_fast_params, jax_tiny_pipe, port_tiny_pipe

from genima_torch.cli import eval_genima, train_controlnet_sdxl_genima
from genima_torch.cli._diffusion_args import build_parser
from genima_torch.control import policy
from genima_torch.core import checkpoint as ckpt
from genima_torch.core.config import save_yaml
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion import driver
from genima_torch.eval.agents import SDXLControlNetAgent
from genima_torch.eval.harness import GenimaEvalWorkspace
from genima_torch.eval.parallel import ParallelGenimaEvalWorkspace
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.weights.to_jax import tree_from_module

ACTION_ATOL = 5e-4
VIEW = 16
RES = 2 * VIEW  # the tiles of four views
LAT = RES // 2  # the tiny VAE's one downsampling
HORIZON = 10  # episodes of 20 steps: 2 control steps each
LANG_DIM = 16
STEPS = 2
CONFIG = {  # the controller's train config, in the layout the trainers save it
    "frame_stack": 1, "action_sequence": HORIZON, "use_onehot_time": False,
    "clip_weights": None, "seed": 0,
    "env": {"factory": "fake", "task": "fake_reach", "episode_length": 20, "image_size": VIEW},
    "method": {
        "_target_": "genima_tpu.control.policy.GenimaACTAgent", "lr": 5e-05,
        "lr_backbone": 1e-05, "weight_decay": 0.0001, "actor_grad_clip": None,
        "num_views": 4, "frame_stack": 1, "image_size": VIEW, "data_augmentation": False,
        "resnet_width": 8,
        "act_cfg": {"hidden_dim": 32, "enc_layers": 1, "dec_layers": 1, "dim_feedforward": 64,
                    "dropout": 0.1, "nheads": 2, "num_queries": HORIZON, "state_dim": 8,
                    "action_dim": 8, "latent_dim": 8, "kl_weight": 10.0,
                    "use_lang_cond": True, "lang_dim": LANG_DIM},
    },
}
EVAL_ARGS = [
    "task=fake_reach", "env.factory=fake", f"env.image_size={VIEW}", "episode_length=20",
    f"execution_horizon={HORIZON}", "eval_type=latest", f"num_diffusion_steps={STEPS}",
    "guidance_scale=0.0",
]


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
def jax_clip():
    clip = JaxCLIPTextModel(JaxCLIPConfig.tiny(projection_dim=LANG_DIM))
    return _np(jax_fast_init(clip, jax.random.key(2), jnp.zeros((1, 77), jnp.int32),
                             seed=13)["params"])


@pytest.fixture(scope="module")
def ctrl(tmp_path_factory):
    """A controller checkpoint (``latest.ckpt`` with its config, the config
    as ``config.yaml``, the stats JSONs) from seeded port weights."""
    root = tmp_path_factory.mktemp("ctrl")
    agent = policy.build_agent(CONFIG, device="cpu")
    params, _ = agent.init_params(torch.Generator().manual_seed(11))
    tree = {"encoder": tree_from_module(params["encoder"], "torchvision_resnet"),
            "actor": tree_from_module(params["actor"], "act")}
    ckpt.save_pytree(ckpt.epoch_payload(1, 10, tree, CONFIG), root / ckpt.LATEST_NAME)
    save_yaml(CONFIG, root / "config.yaml")  # where the JAX eval reads it
    rng = np.random.RandomState(0)
    for name in ("action_stats.json", "proprio_stats.json"):
        (root / name).write_text(json.dumps({"mean": rng.uniform(-0.3, 0.3, 8).tolist(),
                                             "std": rng.uniform(0.5, 1.5, 8).tolist()}))
    return root


@pytest.fixture(scope="module")
def diffusion():
    """The tiny JAX SDXL pipeline and params (ControlNet zero convs drawn at
    random), and the port's agent on the same params."""
    jpipe = jax_tiny_pipe()
    params = dict(jax_fast_params())
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    pipe = port_tiny_pipe()
    port = SDXLControlNetAgent(pipe=pipe, params=pipe.params_from_jax(_np(params)),
                               resolution=RES)
    return jpipe, params, port


def _record_actions(env):
    chunks = []
    step = env.step

    def recording(actions):
        chunks.append(np.asarray(actions, np.float32).copy())
        return step(actions)

    env.step = recording
    return chunks


def _inject(agent, to_array, noise_fn):
    """Seeded latents per call, and the n-th call's noise from ``noise_fn(n)``."""
    calls = {"latents": 0, "noise": 0}

    def next_latents(batch):
        calls["latents"] += 1
        return to_array(np.random.RandomState(100 + calls["latents"]).randn(batch, LAT, LAT, 4)
                        .astype(np.float32))

    def next_noise(*shape):
        calls["noise"] += 1
        return noise_fn(calls["noise"], *shape)

    agent._next_latents = next_latents
    return calls, next_noise


def _noise_key(n: int):
    return jax.random.key(500 + n)


def test_serial_episode_matches_jax(ctrl, jax_clip, diffusion):
    jpipe, params, port = diffusion
    # JAX: its agent's key chain replaced by seeded keys; the gen-time probe
    # preset (it would compile the diffusion half alone: timings are not compared)
    jpipe.init_params = lambda key, image_size=512: dict(jax_fast_params())
    try:
        jdag = JaxSDXLAgent(pipe=jpipe, resolution=RES, dtype=jnp.float32)
    finally:
        del jpipe.init_params
    jdag.params = params
    jcalls, jnoise = _inject(jdag, jnp.asarray, lambda n: _noise_key(n))
    jdag._next_key = jnoise
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

    pcalls, pnoise = _inject(port, torch.from_numpy, lambda n, batch, steps: torch.from_numpy(
        _noise_chain(_noise_key(n), steps, (batch, LAT, LAT, 4))))
    port._next_noise = pnoise
    ws, pchunks = _port_serial(ctrl, jax_clip, port, ["num_eval_episodes=1"])
    plogs = ws.eval()

    assert jcalls == pcalls == {"latents": 2, "noise": 2}
    assert plogs["eval_episodes"] == jlogs["eval_episodes"]
    assert plogs["results"]["env_exception_episodes"] == 0
    assert len(pchunks[0]) == len(jchunks) == 2
    for i, (p, j) in enumerate(zip(pchunks[0], jchunks)):
        assert p.shape == j.shape == (HORIZON, 8)
        np.testing.assert_allclose(p, j, atol=ACTION_ATOL, rtol=0, err_msg=f"control step {i}")


def _port_controller(ctrl, clip_tree, argv):
    eval_cfg, train_cfg = eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl}", "device=cpu"] + EVAL_ARGS + argv)
    agent = eval_genima.build_controller_agent(train_cfg, eval_cfg)
    agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=LANG_DIM)
    agent.params_from_jax(ckpt.load_epoch_checkpoint(ctrl / "latest.ckpt")["agent"], clip_tree)
    return agent, eval_cfg, train_cfg


def _port_serial(ctrl, clip_tree, dag, argv):
    agent, eval_cfg, train_cfg = _port_controller(ctrl, clip_tree, argv)
    env = eval_genima.build_eval_env(eval_cfg, train_cfg, ctrl)
    chunks = _record_actions(env)
    ws = GenimaEvalWorkspace(eval_cfg, env, agent, diffusion_agent=dag,
                             cameras=eval_cfg.env.cameras, tokenizer=load_tokenizer(None))
    ws._fused_gen_est = 0.0  # the probe draws latents and noise: preset it
    return ws, [chunks]


def _port_parallel(ctrl, clip_tree, dag, n_envs, argv):
    agent, eval_cfg, train_cfg = _port_controller(ctrl, clip_tree, argv)
    envs = [eval_genima.build_eval_env(eval_cfg, train_cfg, ctrl) for _ in range(n_envs)]
    chunks = [_record_actions(e) for e in envs]
    return ParallelGenimaEvalWorkspace(
        eval_cfg, envs, agent, diffusion_agent=dag, cameras=eval_cfg.env.cameras,
        tokenizer=load_tokenizer(None)), chunks


@pytest.fixture(scope="module")
def fresh_port(diffusion):
    """A port agent on the module's params, its own generators untouched."""
    _, params, _ = diffusion
    pipe = port_tiny_pipe()
    return SDXLControlNetAgent(pipe=pipe, params=pipe.params_from_jax(_np(params)),
                               resolution=RES)


@pytest.mark.parametrize("overlap", [False, True])
def test_batched_episodes_equal_the_serial_harness(ctrl, jax_clip, fresh_port, overlap):
    """2 envs, 2 episodes (overlap on: two cohorts of 1) against the serial
    harness: each slot's latents and noise come from generators of its own
    seeded as the serial agent's, so the episodes and every chunk agree."""
    serial, s_chunks = _port_serial(ctrl, jax_clip, fresh_port, ["num_eval_episodes=2"])
    s_logs = serial.eval()
    ws, p_chunks = _port_parallel(ctrl, jax_clip, fresh_port, 2, [
        "num_eval_episodes=2", "num_parallel_envs=2", f"eval_overlap={str(overlap).lower()}"])
    assert ws._cohort_partition([{}] * 2) == ([[0], [1]] if overlap else [[0, 1]])
    try:
        p_logs = ws.eval()
    finally:
        ws.close()
    assert p_logs["eval_episodes"] == s_logs["eval_episodes"]
    want = [s_chunks[0][:2], s_chunks[0][2:]]  # 2 chunks an episode
    for env_i, (got, ref) in enumerate(zip(p_chunks, want)):
        assert len(got) == len(ref) == 2
        for p, s in zip(got, ref):
            np.testing.assert_allclose(p, s, atol=ACTION_ATOL, rtol=0, err_msg=f"env {env_i}")


def test_noise_streams_are_the_episodes_own(fresh_port):
    """The ancestral noise comes from a second generator seeded seed + 1 at
    each episode: drawing it leaves the latent stream as it was."""
    dag = fresh_port
    dag.new_episode()
    lat = dag._next_latents(1)
    noise = dag._next_noise(1, STEPS)
    assert noise.shape == (STEPS, 1, LAT, LAT, 4)
    dag.new_episode()
    assert torch.equal(dag._next_latents(1), lat)
    assert torch.equal(dag._next_noise(1, STEPS), noise)
    want = torch.randn(STEPS, 1, LAT, LAT, 4,
                       generator=torch.Generator().manual_seed(dag.seed + 1))
    assert torch.equal(noise, want)


TINY_AGENT = [f"num_diffusion_steps={STEPS}", f"+diffusion_agent.resolution={RES}",
              "diffusion_agent._target_=genima_torch.eval.agents.make_tiny_sdxl_agent"]
CLI_ARGS = ["task=fake_reach", "env.factory=fake", f"env.image_size={VIEW}",
            "episode_length=20", f"execution_horizon={HORIZON}", "eval_type=latest"]


@pytest.mark.parametrize("n_envs", [1, 2])
def test_eval_cli_runs_the_tiny_sdxl_agent(ctrl, tmp_path, monkeypatch, n_envs):
    build = policy.build_agent

    def build_tiny(cfg, device="cuda", dtype=None):
        agent = build(cfg, device=device, dtype=dtype)
        agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=LANG_DIM)
        return agent

    monkeypatch.setattr(policy, "build_agent", build_tiny)
    d = tmp_path / "ctrl"
    shutil.copytree(ctrl, d)
    logs = eval_genima.main([f"controller_ckpt={d}", "device=cpu", "num_eval_episodes=2",
                             f"num_parallel_envs={n_envs}"] + CLI_ARGS + TINY_AGENT)
    results = logs["results"]
    assert results["total_episodes"] == 2 and results["env_exception_episodes"] == 0
    assert [e["steps"] for e in logs["eval_episodes"]] == [20, 20]


# -- the trainer CLI -----------------------------------------------------------------------

BSZ = 2


def test_parser_has_every_jax_sdxl_flag_and_default():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required, a.nargs,
                         tuple(a.choices) if a.choices else None)
                for a in parser._actions if a.dest != "help"}

    got, want = flags(build_parser("sdxl")), flags(jax_build_parser("sdxl"))
    assert got.pop("device") == (("--device",), "cuda", False, None, ("cuda", "cpu"))
    assert got == want
    assert "pretrained_vae_model_name_or_path" not in flags(build_parser())
    # the pix2pix trainer's: JAX's four extra flags and defaults, plus --device
    got, want = flags(build_parser("pix2pix")), flags(jax_build_parser("pix2pix"))
    assert got.pop("device") == (("--device",), "cuda", False, None, ("cuda", "cpu"))
    assert got == want
    assert {"conditioning_dropout_prob", "use_ema", "original_image_column",
            "edited_image_column"} <= set(got) - set(flags(build_parser()))


def test_trainer_cli_trains_validates_and_saves(tmp_path, monkeypatch):
    """``train_controlnet_sdxl_genima.main`` on a tiny SDXL pipeline: 2
    steps, a checkpoint and a validation at step 2, the final save, which
    the SDXL agent loads as the final master weights."""
    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    for ep in range(2):
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = data / "toy" / "variation0" / "episodes" / f"episode{ep}" / sub
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.randint(0, 255, (RES, RES, 3), dtype=np.uint8)).save(
                    d / f"{i}.png")
    built, held = [], {}

    def tiny_pipeline(args, variant="sd", device=None):
        assert variant == "sdxl"
        built.append(port_tiny_pipe(vae_encoder=True))
        return built[-1]

    monkeypatch.setattr(driver, "build_pipeline", tiny_pipeline)
    real_run = driver.run_training

    def run(args, variant="sd", **kw):
        return real_run(args, variant, step_hook=lambda step, state, m: held.update(state=state),
                        **kw)

    monkeypatch.setattr(train_controlnet_sdxl_genima, "run_training", run)
    out = tmp_path / "out"
    result = train_controlnet_sdxl_genima.main([
        "--data_path", str(data), "--tasks", "toy", "--resolution", str(RES),
        "--train_batch_size", str(BSZ), "--seed", "0", "--mixed_precision", "no",
        "--enable_xformers_memory_efficient_attention", "--dataloader_num_workers", "2",
        "--output_dir", str(out), "--report_to", "none", "--device", "cpu",
        "--max_train_steps", "2", "--checkpointing_steps", "2", "--validation_steps", "2",
        "--pretrained_vae_model_name_or_path", str(tmp_path / "vae")])
    assert result["global_step"] == 2 and np.isfinite(result["final_loss"])
    assert np.isfinite(result["val_mse"])
    assert (out / "checkpoint-2" / "controlnet" / "params.msgpack").exists()
    assert (out / "logs" / "validation" / "step2_val0.png").exists()
    agent = SDXLControlNetAgent(pipe=built[0], diffusion_ckpt=str(out), resolution=RES,
                                device="cpu")
    for k, v in agent.params["controlnet"].state_dict().items():
        assert torch.equal(v, held["state"].params[k]), k
