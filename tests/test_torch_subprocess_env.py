"""``envs/subprocess_env.py``: the eval CLI's fake env in a spawned child.

The children build their env with the CLI's own ``build_eval_env``, as its
real-simulator path does. A child serves reset, step, the demo restore
re-wrapped inside it, the initial object pose and a rendered frame, all
equal to the same env in this process; it never initialises CUDA; its
errors re-raise here as ``RuntimeError``; a child that dies is respawned
from its spec, and the lockstep workspace respawns one that dies
mid-episode and finishes every episode. Port only: the JAX package plays
no part. The constructors the children call are this module's, so they
import it (and pytest) but nothing of JAX.
"""

import os

import numpy as np
import pytest
import torch

from genima_torch.cli import eval_genima, train_act
from genima_torch.control import policy
from genima_torch.envs import core
from genima_torch.envs.subprocess_env import SubprocessEnv, start_subprocess_envs
from genima_torch.envs.wrappers import rewrap_obs
from genima_torch.eval.parallel import ParallelGenimaEvalWorkspace
from genima_torch.nn.clip_text import CLIPTextConfig

HORIZON = 6
EVAL_ARGS = ["device=cpu", "task=fake_reach", "env.factory=fake", "env.image_size=32",
             "episode_length=20", f"execution_horizon={HORIZON}", "num_eval_episodes=4",
             "num_parallel_envs=2"]


class _CudaReport(core.Wrapper):
    """The env, its ``initial_object_pose`` also reporting whether its
    process has initialised CUDA, and its pid."""

    @property
    def unwrapped(self):
        return self

    def initial_object_pose(self):
        return {"pose": self.env.unwrapped.initial_object_pose(), "pid": os.getpid(),
                "cuda_initialized": torch.cuda.is_initialized()}


class _CrashOnSignal(core.Wrapper):
    """When ``crash_file`` exists at step time, consume it and end the
    process, as a simulator abort takes its child down mid-episode."""

    def __init__(self, env, crash_file: str):
        super().__init__(env)
        self._crash_file = crash_file

    def step(self, action):
        if os.path.exists(self._crash_file):
            try:
                os.unlink(self._crash_file)  # one-shot
            finally:
                os._exit(17)
        return self.env.step(action)


def build_reporting_env(**kwargs):
    return _CudaReport(eval_genima.build_eval_env(**kwargs))


def build_crashy_env(crash_file, **kwargs):
    return _CrashOnSignal(eval_genima.build_eval_env(**kwargs), crash_file)


def build_failing_env(**kwargs):
    raise ValueError("no simulator here")


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
    """A tiny controller trained by the port's ``train_act`` (tiny CLIP)."""
    work = tmp_path_factory.mktemp("ctrl")
    build = policy.build_agent

    def build_tiny(cfg, device="cuda", dtype=None):
        agent = build(cfg, device=device, dtype=dtype)
        agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=agent.act_cfg.lang_dim)
        return agent

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(policy, "build_agent", build_tiny)
        mp.setattr(train_act, "build_agent", build_tiny)
        train_act.main([
            f"work_dir={work}", "device=cpu", "env.factory=fake", "env.task=fake_reach",
            "env.image_size=32", "env.episode_length=20", "num_train_epochs=1",
            "checkpoint_every=1", "num_demos=1", "batch_size=4", f"action_sequence={HORIZON}",
            "frame_stack=2", "method.image_size=32", "+method.resnet_width=8",
            "method.act_cfg.hidden_dim=32", "method.act_cfg.enc_layers=1",
            "method.act_cfg.dec_layers=1", "method.act_cfg.dim_feedforward=64",
            "method.act_cfg.nheads=2", "method.act_cfg.latent_dim=8",
            "method.act_cfg.lang_dim=16", "method.data_augmentation=false",
        ])
        yield work


@pytest.fixture(scope="module")
def env_kw(trained):
    """The CLI's ``build_eval_env`` arguments (frame stack 2, from the
    trained controller's config)."""
    eval_cfg, train_cfg = eval_genima.load_train_and_eval_cfg(
        [f"controller_ckpt={trained}"] + EVAL_ARGS)
    return dict(eval_cfg=eval_cfg, train_cfg=train_cfg, stats_path=str(trained))


def _assert_obs_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_child_env_equals_the_in_process_env(env_kw):
    kw = env_kw
    envs = start_subprocess_envs(build_reporting_env, 2, **kw)
    local = eval_genima.build_eval_env(**kw)
    try:
        assert envs[0].observation_space is not None and envs[0].action_space is not None
        assert envs[0].unwrapped is envs[0]
        for idx in (1, 0):
            obs, info = envs[0].reset_to_demo_wrapped(idx)
            want, want_info = local.reset()
            _, raw = local.unwrapped.reset_to_demo(idx=idx)
            want = rewrap_obs(local, raw, want)
            assert obs["wrist_rgb"].shape[0] == 2 and info == want_info
            _assert_obs_equal(obs, want)
            report = envs[0].initial_object_pose()
            assert report["pose"] == local.unwrapped.initial_object_pose()
            assert report["pid"] != os.getpid() and report["cuda_initialized"] is False
            actions = np.random.RandomState(idx).uniform(-1, 1, (HORIZON, 8)).astype(np.float32)
            got_step, want_step = envs[0].step(actions), local.step(actions)
            _assert_obs_equal(got_step[0], want_step[0])
            assert got_step[1:4] == want_step[1:4]
        frame = envs[0].render_frame()
        assert frame.shape == (32, 32, 3) and frame.dtype == np.uint8
        # an error in the child's env re-raises here, and the child serves on
        _assert_obs_equal(envs[1].reset()[0], eval_genima.build_eval_env(**kw).reset()[0])
        with pytest.raises(RuntimeError, match="SubprocessEnv child error"):
            envs[1].step(np.zeros((HORIZON, 3), np.float32))  # 3 of 8 action dims
        envs[1].reset()
    finally:
        for env in envs:
            env.close()
    assert not any(env._proc.is_alive() for env in envs)


def test_a_child_that_cannot_build_its_env_raises_here():
    with pytest.raises(RuntimeError, match="no simulator here"):
        start_subprocess_envs(build_failing_env, 1)


def test_respawn_rebuilds_a_dead_child(env_kw, tmp_path):
    crash = tmp_path / "crash"
    env = SubprocessEnv(build_crashy_env, crash_file=str(crash), **env_kw)
    try:
        obs, _ = env.reset()
        crash.touch()
        with pytest.raises(RuntimeError, match="died"):
            env.step(np.zeros((HORIZON, 8), np.float32))
        assert not crash.exists()  # consumed before the child died
        env.respawn()
        env.reset()
        obs2, *_ = env.step(np.zeros((HORIZON, 8), np.float32))
        assert obs2.keys() == obs.keys()
    finally:
        env.close()


def test_workspace_respawns_a_child_that_dies_midepisode(env_kw, tmp_path):
    """Env 1's child dies on its first step: the episode ends there, the
    slot is respawned, and every episode is run."""
    crash = tmp_path / "crash"
    eval_cfg = env_kw["eval_cfg"]
    agent = eval_genima.build_controller_agent(env_kw["train_cfg"], eval_cfg)
    agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=agent.act_cfg.lang_dim)
    agent.init_params(torch.Generator().manual_seed(2))
    envs = [SubprocessEnv(build_crashy_env, crash_file=str(crash) + ("" if i else ".never"),
                          **env_kw) for i in range(2)]
    crash.touch()
    ws = ParallelGenimaEvalWorkspace(eval_cfg, envs, agent)
    try:
        logs = ws.eval()
    finally:
        ws.close()
        for env in envs:
            env.close()
    steps = [e["steps"] for e in logs["eval_episodes"]]
    assert logs["results"]["total_episodes"] == 4
    assert steps[1] == 0 and all(s > 0 for s in steps[:1] + steps[2:])
    assert logs["results"]["env_exception_episodes"] == 1
    assert not ws._retired
