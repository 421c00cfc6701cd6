"""The port's lockstep-batched eval (``eval/parallel.py``) against the JAX package's.

A tiny controller is trained once with the port's own ``train_act`` (frame
stack 2, so each env's camera-major then frame view order in the batched
step is exercised); both packages load its checkpoint. Every controller
gets the same seeded tiny CLIP tower, made by JAX and carried to the port
(no checkpoint holds CLIP). All runs are f32 on the CPU, the port's on one
intra-op thread.

Held to JAX, with the same params and the same latents:

- ``BatchedGenimaStep`` at N=2: targets within 1 uint8 level, actions
  within ``ACTION_ATOL`` (``test_torch_eval_harness.py`` states why: a
  target pixel on a .5 boundary may round the other way and move the tiny
  controller's actions by ~2e-4);
- ``ParallelGenimaEvalWorkspace`` at 2 envs and 3 episodes (a padded final
  round), latents injected into both through ``_slot_latents``: equal
  episode entries, results equal apart from the port-only
  ``env_exception_episodes``, and every action chunk within
  ``ACTION_ATOL``.

Held in the port alone: overlap on and off, batched episodes against the
port's serial harness, the ACT-only path (also with more env threads than
cores under fast thread switching), the CFG refusal, a mid-episode error,
a retired env, all envs dead, and both CLIs with ``num_parallel_envs=2``.
"""

import dataclasses
import functools
import json
import os
import shutil
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.cli import eval_genima as jax_eval_genima
from genima_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.eval.agents import SDControlNetAgent as JaxSDAgent
from genima_tpu.eval.parallel import BatchedGenimaStep as JaxBatchedStep
from genima_tpu.eval.parallel import ParallelGenimaEvalWorkspace as JaxParallelWorkspace
from genima_tpu.control.policy import fast_init as jax_fast_init
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.clip_text import CLIPTextModel as JaxCLIPTextModel
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

from genima_torch.cli import eval_act, eval_genima, train_act
from genima_torch.control import policy
from genima_torch.core import checkpoint as ckpt
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.envs import core
from genima_torch.eval.agents import SDControlNetAgent
from genima_torch.eval.fused import FusedGenimaStep
from genima_torch.eval.harness import GenimaEvalWorkspace
from genima_torch.eval.parallel import BatchedGenimaStep, ParallelGenimaEvalWorkspace
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

ACTION_ATOL = 5e-4
FRAME_STACK = 2
HORIZON = 10  # episodes of 20 steps: 2 chunks each
LANG_DIM = 16
TRAIN_ARGS = [
    "env.factory=fake", "env.task=fake_reach", "env.image_size=32", "env.episode_length=20",
    "num_train_epochs=1", "checkpoint_every=1", "num_demos=2", "batch_size=4",
    f"action_sequence={HORIZON}", f"frame_stack={FRAME_STACK}", "method.image_size=32",
    "+method.resnet_width=8", "method.act_cfg.hidden_dim=32", "method.act_cfg.enc_layers=1",
    "method.act_cfg.dec_layers=1", "method.act_cfg.dim_feedforward=64",
    "method.act_cfg.nheads=2", "method.act_cfg.latent_dim=8",
    f"method.act_cfg.lang_dim={LANG_DIM}", "method.data_augmentation=false",
]
EVAL_ARGS = [
    "task=fake_reach", "env.factory=fake", "env.image_size=32", "episode_length=20",
    f"execution_horizon={HORIZON}", "eval_type=latest", "num_diffusion_steps=2",
    "guidance_scale=0.0",
]
ONE_STEP = ["num_diffusion_steps=1"]  # where the port is held to itself
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


def _tiny_clip(mp):
    """The port's controller agents get a tiny CLIP tower."""
    build = policy.build_agent

    def build_tiny(cfg, device="cuda", dtype=None):
        agent = build(cfg, device=device, dtype=dtype)
        agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=LANG_DIM)
        return agent

    mp.setattr(policy, "build_agent", build_tiny)
    mp.setattr(train_act, "build_agent", build_tiny)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    work = tmp_path_factory.mktemp("ctrl")
    with pytest.MonkeyPatch.context() as mp:
        _tiny_clip(mp)
        train_act.main([f"work_dir={work}", "device=cpu", *TRAIN_ARGS])
    return work


def _copy(trained, tmp_path, name):
    """A copy of the trained checkpoint dir: each run writes its own logs."""
    dst = tmp_path / name
    shutil.copytree(trained, dst)
    return dst


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def diffusion():
    """The tiny JAX pipeline's params with its ControlNet zero convs drawn at
    random, so the ControlNet shapes the targets; the port's agent on the
    same params."""
    pipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                       text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32)
    params = pipe.init_params(jax.random.key(0), 64)
    rng = np.random.RandomState(5)
    cn = dict(params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    port_pipe = SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                     text_cfg=CLIPTextConfig.tiny(), device="cpu")
    port = SDControlNetAgent(pipe=port_pipe, params=port_pipe.params_from_jax(_np(params)),
                             resolution=64)
    return pipe, params, port


def _jax_dag(diffusion):
    pipe, params, _ = diffusion
    dag = JaxSDAgent(pipe=pipe, resolution=64, dtype=jnp.float32)
    dag.params = params
    return dag


@pytest.fixture(scope="module")
def jax_clip():
    """A seeded tiny CLIP tower (the controller's, projecting to its
    language width), as JAX initialises it."""
    clip = JaxCLIPTextModel(JaxCLIPConfig.tiny(projection_dim=LANG_DIM))
    return _np(jax_fast_init(clip, jax.random.key(2), jnp.zeros((1, 77), jnp.int32),
                             seed=13)["params"])


@pytest.fixture(scope="module")
def jax_side(trained, diffusion, jax_clip):
    """The JAX controller, its diffusion agent and one ``BatchedGenimaStep``,
    compiled once for the module: both JAX tests call it at N=2 with slot
    noise keys, as the workspace does without overlap."""
    agent, _, _ = _jax_controller(trained, jax_clip)
    dag = _jax_dag(diffusion)
    return agent, jax_clip, dag, JaxBatchedStep(dag, agent, obs_size=32)


def _jax_controller(ctrl_dir, clip_tree, argv=EVAL_ARGS):
    eval_cfg, train_cfg = jax_eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl_dir}"] + argv)
    agent = dataclasses.replace(jax_eval_genima.build_controller_agent(train_cfg, eval_cfg),
                                clip_cfg=JaxCLIPConfig.tiny(projection_dim=LANG_DIM))
    agent._clip_params = jax.tree_util.tree_map(jnp.asarray, clip_tree)
    return agent, eval_cfg, train_cfg


def _port_controller(ctrl_dir, clip_tree, argv=EVAL_ARGS):
    eval_cfg, train_cfg = eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={ctrl_dir}", "device=cpu"] + argv)
    agent = eval_genima.build_controller_agent(train_cfg, eval_cfg)
    agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=LANG_DIM)
    agent.params_from_jax(ckpt.load_epoch_checkpoint(ctrl_dir / "latest.ckpt")["agent"],
                          clip_tree)
    return agent, eval_cfg, train_cfg


def _record_actions(env):
    chunks = []
    step = env.step

    def recording(actions):
        chunks.append(np.asarray(actions, np.float32).copy())
        return step(actions)

    env.step = recording
    return chunks


def _injected_latents(to_array, slot, fs):
    """Per slot: seeded standard-normal latents by episode and draw."""
    slot["draws"] = slot.get("draws", 0) + 1
    seed = 1000 * (slot["ep"] + 2) + slot["draws"]
    return to_array(np.random.RandomState(seed).randn(fs, 32, 32, 4).astype(np.float32))


def _port_workspace(ctrl_dir, clip_tree, dag, n_envs, argv, wrap=None, cls=None):
    """The port's parallel workspace (or ``cls``) on ``n_envs`` fake envs;
    returns it and each env's recorded action chunks."""
    agent, eval_cfg, train_cfg = _port_controller(ctrl_dir, clip_tree, EVAL_ARGS + argv)
    envs = [eval_genima.build_eval_env(eval_cfg, train_cfg, ctrl_dir) for _ in range(n_envs)]
    if wrap is not None:
        envs = wrap(envs)
    chunks = [_record_actions(e) for e in envs]
    kw = dict(diffusion_agent=dag, cameras=eval_cfg.env.cameras, tokenizer=load_tokenizer(None))
    if cls is GenimaEvalWorkspace:
        return cls(eval_cfg, envs[0], agent, **kw), chunks
    return ParallelGenimaEvalWorkspace(eval_cfg, envs, agent, **kw), chunks


def _eval(ws):
    try:
        return ws.eval()
    finally:
        ws.close()


def _assert_chunks_close(got, want):
    assert [len(c) for c in got] == [len(c) for c in want]
    for env_i, (g, w) in enumerate(zip(got, want)):
        for i, (p, j) in enumerate(zip(g, w)):
            assert p.shape == j.shape == (HORIZON, 8)
            np.testing.assert_allclose(p, j, atol=ACTION_ATOL, rtol=0,
                                       err_msg=f"env {env_i}, control step {i}")


# -- held to JAX ---------------------------------------------------------------------------


def test_batched_step_matches_jax_and_the_serial_step(trained, diffusion, jax_side):
    """N=2, frame stack 2: the port's batched step against JAX's on the same
    params and inputs, and each of its rows against the port's serial step."""
    n, fs = 2, FRAME_STACK
    jagent, jax_clip, jdag, jstep = jax_side
    pagent, _, _ = _port_controller(trained, jax_clip)
    tree = ckpt.load_epoch_checkpoint(trained / "latest.ckpt")["agent"]
    pdag = diffusion[2]
    rng = np.random.RandomState(0)
    tiled = rng.randint(0, 256, (n * fs, 64, 64, 3)).astype(np.uint8)
    embeds = np.asarray(jnp.concatenate(
        [jdag._embed_prompts([goal] * fs) for goal in ("reach the goal", "open the box")]))
    latents = rng.randn(n * fs, 32, 32, 4).astype(np.float32)
    qpos = rng.randn(n, 8 * fs).astype(np.float32)
    lang = np.asarray(load_tokenizer(None)(["reach the goal", "open the box"]), np.int32)

    j_actions, j_target = jstep(
        jdag.params, tree, jagent._clip_params,
        *(jnp.asarray(a) for a in (tiled, embeds, latents, qpos, lang)),
        key=jnp.stack([jax.random.key(3)] * n), num_inference_steps=2)
    pparams = pagent.load_params(tree)
    p_actions, p_target = BatchedGenimaStep(pdag, pagent, obs_size=32)(
        pdag.params, pparams, pagent.clip_params,
        *(torch.from_numpy(a) for a in (tiled, embeds, latents, qpos, lang)),
        num_inference_steps=2)
    assert p_target.shape == (n * fs, 64, 64, 3) and p_target.dtype == torch.uint8
    assert p_actions.shape == (n, HORIZON, 8)
    lsb = np.abs(p_target.numpy().astype(np.int16) - np.asarray(j_target).astype(np.int16))
    assert lsb.max() <= 1
    np.testing.assert_allclose(p_actions.numpy(), np.asarray(j_actions), atol=ACTION_ATOL,
                               rtol=0)

    serial = FusedGenimaStep(pdag, pagent, obs_size=32)
    for i in range(n):
        rows = slice(i * fs, (i + 1) * fs)
        s_actions, s_target = serial(
            pdag.params, pparams, pagent.clip_params,
            *(torch.from_numpy(a) for a in (tiled[rows], embeds[rows], latents[rows],
                                            qpos[i:i + 1], lang[i:i + 1])),
            num_inference_steps=2)
        diff = (s_target.to(torch.int16) - p_target[rows].to(torch.int16)).abs()
        assert diff.max() <= 1
        np.testing.assert_allclose(s_actions.numpy(), p_actions[i:i + 1].numpy(),
                                   atol=ACTION_ATOL, rtol=0)


def test_parallel_workspace_matches_jax(trained, diffusion, jax_side, tmp_path):
    """2 envs, 3 episodes (the second round pads with an uncounted slot),
    the same latents injected into both packages through ``_slot_latents``.
    Both run one batch of 2 (no overlap), so the JAX workspace reuses the
    module's compiled step; its gen-time probe, which would compile the
    diffusion half alone, is stubbed (timings are not compared)."""
    argv = ["num_eval_episodes=3", "num_parallel_envs=2"]
    jdir, pdir = _copy(trained, tmp_path, "jax"), _copy(trained, tmp_path, "port")
    jagent, jax_clip, jdag, jstep = jax_side
    jcfg, jtrain = jax_eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={jdir}"] + EVAL_ARGS + argv)
    jcfg.eval_overlap = False
    jenvs = [jax_eval_genima.build_eval_env(jcfg, jtrain, jdir) for _ in range(2)]
    jchunks = [_record_actions(e) for e in jenvs]
    jws = JaxParallelWorkspace(jcfg, jenvs, jagent, diffusion_agent=jdag,
                               cameras=jcfg.env.cameras, tokenizer=jax_load_tokenizer(None))
    jws._batched_step = jstep
    jws._measure_batched_gen = lambda *probe: 0.0
    jws._slot_latents = functools.partial(_injected_latents, jnp.asarray)
    jlogs = jws.eval()

    pws, pchunks = _port_workspace(pdir, jax_clip, diffusion[2], 2, argv + ["eval_overlap=false"])
    pws._slot_latents = functools.partial(_injected_latents, torch.from_numpy)
    plogs = _eval(pws)

    assert jlogs["results"]["total_episodes"] == 3
    assert plogs["eval_episodes"] == jlogs["eval_episodes"]
    assert set(plogs["results"]) == set(jlogs["results"]) | PORT_KEYS_ONLY
    assert plogs["results"]["env_exception_episodes"] == 0
    assert {k: plogs["results"][k] for k in jlogs["results"]} == jlogs["results"]
    assert plogs["results"]["num_parallel_envs"] == 2
    assert plogs["results"]["timing_attribution"] == "estimated"
    _assert_chunks_close(pchunks, jchunks)
    saved = json.loads((pdir / "eval_genima_fake_reach.json").read_text())
    want = json.loads((jdir / "eval_genima_fake_reach.json").read_text())
    assert saved["eval_episodes"] == want["eval_episodes"]


# -- held in the port alone --------------------------------------------------------------------


def test_overlap_on_and_off_give_the_same_episodes(trained, diffusion, jax_clip):
    """Two cohorts of 2 against one batch of 4: the same episodes, rewards,
    steps, and each env's action chunks."""
    results, chunks = {}, {}
    for overlap in (False, True):
        ws, chunks[overlap] = _port_workspace(
            trained, jax_clip, diffusion[2], 4, ONE_STEP
            + ["num_eval_episodes=4", "num_parallel_envs=4", f"eval_overlap={str(overlap).lower()}"])
        assert ws._cohort_partition([{}] * 4) == ([[0, 1], [2, 3]] if overlap
                                                  else [[0, 1, 2, 3]])
        logs = _eval(ws)
        results[overlap] = [(e["episode"], e["reward"], e["steps"])
                            for e in logs["eval_episodes"]]
    assert len(results[True]) == 4
    assert results[True] == results[False]
    _assert_chunks_close(chunks[True], chunks[False])


def test_batched_episodes_equal_the_serial_harness(trained, diffusion, jax_clip):
    """Each batched episode draws its latents from a generator of its own,
    seeded as the serial agent's: it equals the same episode run by the
    serial harness (its gen-time probe, which draws latents, preset)."""
    dag = diffusion[2]
    serial, s_chunks = _port_workspace(trained, jax_clip, dag, 1,
                                       ONE_STEP + ["num_eval_episodes=2"], cls=GenimaEvalWorkspace)
    serial._fused_gen_est = 0.0
    s_logs = serial.eval()
    ws, p_chunks = _port_workspace(trained, jax_clip, dag, 2, ONE_STEP + [
        "num_eval_episodes=2", "num_parallel_envs=2", "eval_overlap=false"])
    p_logs = _eval(ws)
    assert p_logs["eval_episodes"] == s_logs["eval_episodes"]
    per_episode, chunk_i = [], 0
    for e in s_logs["eval_episodes"]:
        n = -(-e["steps"] // HORIZON)
        per_episode.append(s_chunks[0][chunk_i:chunk_i + n])
        chunk_i += n
    _assert_chunks_close(p_chunks, per_episode)


def test_act_only_matches_the_serial_harness(trained, jax_clip):
    """ACT alone, raw camera views batched over 2 envs, 3 episodes."""
    serial, s_chunks = _port_workspace(trained, jax_clip, None, 1, ["num_eval_episodes=3"],
                                       cls=GenimaEvalWorkspace)
    s_logs = serial.eval()
    ws, p_chunks = _port_workspace(trained, jax_clip, None, 2,
                                   ["num_eval_episodes=3", "num_parallel_envs=2"])
    assert ws._cohort_partition([{}] * 2) == [[0, 1]]
    p_logs = _eval(ws)
    assert p_logs["eval_episodes"] == s_logs["eval_episodes"]
    # episodes 1 and 3 ran on env 0, episode 2 on env 1 (env 1 then re-ran
    # episode 3 uncounted)
    per_env = [[], []]
    chunk_i = 0
    for k, e in enumerate(s_logs["eval_episodes"]):
        n = -(-e["steps"] // HORIZON)
        per_env[k % 2] += s_chunks[0][chunk_i:chunk_i + n]
        chunk_i += n
    _assert_chunks_close([p_chunks[0], p_chunks[1][:len(per_env[1])]], per_env)


def test_more_envs_than_cores_under_fast_thread_switching(trained, jax_clip):
    """Stress: ACT alone on more env threads than the host has cores, with
    the interpreter switching threads every microsecond; the episodes must
    be the serial harness's (a lost slot update would change a step count
    or a reward), within a time bound."""
    n_envs = (os.cpu_count() or 4) + 2
    argv = [f"num_eval_episodes={n_envs + 1}"]
    serial, _ = _port_workspace(trained, jax_clip, None, 1, argv, cls=GenimaEvalWorkspace)
    s_logs = serial.eval()
    ws, _ = _port_workspace(trained, jax_clip, None, n_envs,
                            argv + [f"num_parallel_envs={n_envs}"])
    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: out.update(logs=_eval(ws)), daemon=True)
        runner.start()
        runner.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not runner.is_alive()
    assert out["logs"]["eval_episodes"] == s_logs["eval_episodes"]


def test_refuses_classifier_free_guidance(trained, diffusion, jax_clip):
    with pytest.raises(ValueError, match="guidance"):
        _port_workspace(trained, jax_clip, diffusion[2], 2,
                        ["num_eval_episodes=2", "guidance_scale=7.5"])


class FlakyEnv(core.Wrapper):
    """Raises on the first ``fail_steps`` steps and the first
    ``fail_resets`` resets, then behaves."""

    def __init__(self, env, fail_steps=0, fail_resets=0):
        super().__init__(env)
        self._fail_steps = fail_steps
        self._fail_resets = fail_resets

    def step(self, actions):
        if self._fail_steps > 0:
            self._fail_steps -= 1
            raise RuntimeError("injected sim crash (step)")
        return self.env.step(actions)

    def reset(self, **kwargs):
        if self._fail_resets > 0:
            self._fail_resets -= 1
            raise RuntimeError("injected sim crash (reset)")
        return self.env.reset(**kwargs)


def test_survives_a_midepisode_error(trained, jax_clip):
    """A simulator error in round 1 ends that episode only; its failed
    chunk is not counted and the env steps again in round 2."""
    ws, _ = _port_workspace(
        trained, jax_clip, None, 2, ["num_eval_episodes=4", "num_parallel_envs=2"],
        wrap=lambda envs: [envs[0], FlakyEnv(envs[1], fail_steps=1)])
    logs = _eval(ws)
    steps = [e["steps"] for e in logs["eval_episodes"]]
    assert logs["results"]["total_episodes"] == 4 and len(steps) == 4
    assert steps[1] == 0 and all(s > 0 for s in steps[:1] + steps[2:])
    assert logs["results"]["env_exception_episodes"] == 1
    assert not ws._retired


def test_retires_a_dead_env_and_requeues_its_episodes(trained, diffusion, jax_clip):
    """Resets that keep failing retire the env; a placeholder keeps the
    batch at 2 and the survivor runs every episode."""
    ws, chunks = _port_workspace(
        trained, jax_clip, diffusion[2], 2,
        ONE_STEP + ["num_eval_episodes=3", "num_parallel_envs=2", "eval_overlap=false"],
        wrap=lambda envs: [envs[0], FlakyEnv(envs[1], fail_resets=10_000)])
    logs = _eval(ws)
    assert logs["results"]["total_episodes"] == 3
    assert all(e["steps"] > 0 for e in logs["eval_episodes"])
    assert ws._retired == {1}
    assert not chunks[1] and chunks[0]


def test_all_envs_dead_raises(trained, jax_clip):
    ws, _ = _port_workspace(
        trained, jax_clip, None, 2, ["num_eval_episodes=2", "num_parallel_envs=2"],
        wrap=lambda envs: [FlakyEnv(e, fail_resets=10_000) for e in envs])
    with pytest.raises(RuntimeError, match="environments have died"):
        _eval(ws)


CLI_ARGS = [
    "task=fake_reach", "env.factory=fake", "env.image_size=32", "episode_length=20",
    f"execution_horizon={HORIZON}", "eval_type=latest", "num_eval_episodes=3",
]
TINY_AGENT = ["num_diffusion_steps=1", "+diffusion_agent.resolution=64",
              "enable_xformers_memory_efficient_attention=false",
              "diffusion_agent._target_=genima_torch.eval.agents.make_tiny_sd_agent"]


def test_clis_run_num_parallel_envs(trained, tmp_path, monkeypatch):
    _tiny_clip(monkeypatch)
    gdir = _copy(trained, tmp_path, "genima")
    logs = eval_genima.main([f"controller_ckpt={gdir}", "device=cpu", "num_parallel_envs=2"]
                            + CLI_ARGS + TINY_AGENT)
    results = logs["results"]
    assert results["total_episodes"] == 3 and results["num_parallel_envs"] == 2
    assert results["env_exception_episodes"] == 0
    assert all(e["steps"] > 0 for e in logs["eval_episodes"])
    saved = json.loads((gdir / "eval_genima_fake_reach.json").read_text())
    assert saved["results"]["timing_attribution"] == "estimated"
    metrics = [json.loads(line) for line in (gdir / "eval_logs" / "metrics.jsonl").open()]
    assert metrics[-1]["eval_genima/num_parallel_envs"] == 2
    assert {"eval_genima/gen_time", "eval_genima/control_time",
            "eval_genima/fused_step_time"} <= set(metrics[-1])

    serial = eval_act.main([f"controller_ckpt={_copy(trained, tmp_path, 'act1')}",
                            "device=cpu"] + CLI_ARGS)
    parallel = eval_act.main([f"controller_ckpt={_copy(trained, tmp_path, 'act2')}",
                              "device=cpu", "num_parallel_envs=2"] + CLI_ARGS)
    assert parallel["eval_episodes"] == serial["eval_episodes"]
    assert parallel["results"]["num_parallel_envs"] == 2


def test_clis_refuse_mesh_serving_and_cfg(trained, tmp_path, monkeypatch):
    _tiny_clip(monkeypatch)
    pdir = _copy(trained, tmp_path, "port")
    base = [f"controller_ckpt={pdir}", "device=cpu", "num_parallel_envs=2"] + CLI_ARGS
    # JAX's checks on the serving mesh: data rows must divide the envs, the
    # tensor-parallel size the devices
    with pytest.raises(ValueError, match="multiple of the mesh data size"):
        eval_genima.main(base + ["eval_data_parallel=true", "eval_mesh_devices=3"])
    with pytest.raises(ValueError, match="must divide the mesh device count"):
        eval_genima.main(base + ["eval_tensor_parallel=3", "eval_mesh_devices=2"])
    with pytest.raises(ValueError, match="guidance"):
        eval_genima.main(base + TINY_AGENT + ["guidance_scale=2.0"])
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            eval_act.main([f"controller_ckpt={pdir}", "num_parallel_envs=2"] + CLI_ARGS)
