"""The port's fake env and wrapper stack against the JAX package's.

Both packages' eval envs, built by their factories from the same stats
files, take the same scripted action chunks; observations (bit for bit),
rewards, terminations and truncations must agree, including
``reset_to_demo`` re-wrapped by ``rewrap_obs``, frame stacks of 2 and the
one-hot time wrapper.
"""

import json
import sys

import numpy as np
import pytest

from genima_tpu.envs import fake as jfake
from genima_tpu.envs import wrappers as jwrap
from genima_tpu.envs.rlbench import make_factory as jax_make_factory

from genima_torch.envs import fake as tfake
from genima_torch.envs import wrappers as twrap
from genima_torch.envs.rlbench import make_factory


def _assert_obs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _joint_norm(env):
    while not isinstance(env, (jwrap.JointNormalization, twrap.JointNormalization)):
        env = env.env
    return env


def _reach_action(env):
    """The normalised action that puts the arm on the episode's target."""
    base, norm = env.unwrapped, _joint_norm(env)
    target = np.concatenate([base._target, [base._target_gripper]]).astype(np.float32)
    return type(norm).transform_to_norm(target, norm.mean, norm.std)


@pytest.fixture
def stats_dir(tmp_path):
    rng = np.random.RandomState(0)
    for name in ("action_stats.json", "proprio_stats.json"):
        (tmp_path / name).write_text(json.dumps({
            "mean": rng.uniform(-0.3, 0.3, 8).tolist(),
            "std": rng.uniform(0.5, 1.5, 8).tolist(),
        }))
    return tmp_path


def _envs(stats_dir, fs, onehot, goal_observable, horizon=5, episode_length=12):
    env_cfg = {"factory": "fake", "task": "fake_reach", "image_size": 32,
               "episode_length": episode_length, "goal_observable": goal_observable}
    kw = dict(episode_length=episode_length, frame_stack=fs, action_sequence=horizon,
              stats_path=str(stats_dir), use_onehot_time=onehot, task_name="fake_reach")
    return (jax_make_factory(dict(env_cfg)).make_eval_env(**kw),
            make_factory(dict(env_cfg)).make_eval_env(**kw))


@pytest.mark.parametrize("fs, onehot, goal_observable",
                         [(1, False, False), (2, False, False), (2, True, True), (1, True, False)])
def test_eval_env_matches_jax_under_scripted_actions(stats_dir, fs, onehot, goal_observable):
    jenv, tenv = _envs(stats_dir, fs, onehot, goal_observable)
    rng = np.random.RandomState(fs + 2 * onehot)
    for episode in range(3):
        jobs, jinfo = jenv.reset()
        tobs, tinfo = tenv.reset()
        assert jinfo == tinfo
        _assert_obs_equal(jobs, tobs)
        # the harness's demo-restored start
        _, jraw = jenv.unwrapped.reset_to_demo(idx=episode)
        _, traw = tenv.unwrapped.reset_to_demo(idx=episode)
        _assert_obs_equal(jraw, traw)
        jobs, tobs = jwrap.rewrap_obs(jenv, jraw, jobs), twrap.rewrap_obs(tenv, traw, tobs)
        _assert_obs_equal(jobs, tobs)
        assert jenv.unwrapped.initial_object_pose() == tenv.unwrapped.initial_object_pose()
        done = False
        while not done:
            chunk = rng.randn(5, 8).astype(np.float32) * 0.5
            if episode == 1:  # the chunk ends on the target
                chunk[-1] = _reach_action(jenv)
            jout, tout = jenv.step(chunk), tenv.step(chunk)
            _assert_obs_equal(jout[0], tout[0])
            assert jout[1:] == tout[1:]
            done = jout[2] or jout[3]


def test_goal_reached_ends_the_episode_with_reward(stats_dir):
    jenv, tenv = _envs(stats_dir, 1, False, False)
    for env in (jenv, tenv):
        env.reset()
        chunk = np.stack([_reach_action(env)] * 2)
        _, reward, terminated, truncated, _ = env.step(chunk)
        assert (reward, terminated, truncated) == (1.0, True, False)


@pytest.mark.parametrize("camera", tfake.CAMERAS)
def test_renderers_match_jax(camera):
    rng = np.random.RandomState(3)
    joints = rng.uniform(-2, 2, 7).astype(np.float32)
    goal = rng.uniform(-1.5, 1.5, 7).astype(np.float32)
    np.testing.assert_array_equal(tfake.render_joint_bars(joints, 1.0, camera, 48),
                                  jfake.render_joint_bars(joints, 1.0, camera, 48))
    np.testing.assert_array_equal(tfake.render_goal_scene(joints, 0.0, goal, 1.0, camera, 48),
                                  jfake.render_goal_scene(joints, 0.0, goal, 1.0, camera, 48))


def test_wrappers_forward_attributes_and_refuse_what_jax_asserts(stats_dir):
    _, tenv = _envs(stats_dir, 1, False, False, horizon=3)
    assert tenv.task_name == "fake_reach" and isinstance(tenv.unwrapped, tfake.FakeRLBenchEnv)
    tenv.reset()
    with pytest.raises(ValueError, match="exceeds action_sequence"):
        tenv.step(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="stats"):
        twrap.JointNormalization(tfake.FakeRLBenchEnv())


def test_stats_are_written_where_given(tmp_path):
    stats = {"mean": np.arange(8.0), "std": np.ones(8)}
    env = twrap.wrap_env(tfake.FakeRLBenchEnv(image_size=16), episode_length=5,
                         action_stats=stats, proprio_stats=stats, stats_path=str(tmp_path))
    assert json.loads((tmp_path / "action_stats.json").read_text())["mean"] == list(range(8))
    assert env.reset()[0]["low_dim_state"].shape == (1, 8)


def test_other_factories_raise():
    with pytest.raises(NotImplementedError, match="RLBench simulator"):
        make_factory({"factory": "rlbench"})


def test_video_recorder_falls_back_to_npz(tmp_path, monkeypatch, stats_dir):
    """Without imageio (as on the card's machine) the frames go to an .npz;
    frames are the base env's first camera, as the JAX recorder takes them."""
    from genima_tpu.eval.video import frame_from_env as jax_frame

    from genima_torch.eval.video import VideoRecorder, frame_from_env

    jenv, tenv = _envs(stats_dir, 1, False, False)
    jenv.reset()
    tenv.reset()
    np.testing.assert_array_equal(frame_from_env(tenv), jax_frame(jenv))
    monkeypatch.setitem(sys.modules, "imageio", None)
    rec = VideoRecorder(tmp_path / "videos")
    rec.init(tenv, enabled=True)
    rec.record(tenv)
    path = rec.save("fake_reach_ep1_fail.mp4")
    assert path == tmp_path / "videos" / "fake_reach_ep1_fail.npz"
    assert np.load(path)["frames"].shape == (2, 32, 32, 3)
    assert VideoRecorder(tmp_path).save("x.mp4") is None  # not enabled: nothing written
