"""The port's demo export and rendered-demo factory against the JAX package.

The same goal-observable fake demos (each package's fake env, seeded alike,
make equal demos) are exported by both packages: the trees must be equal
file for file, ``low_dim_obs.pkl`` and ``variation_descriptions.pkl``
byte for byte. The port's ``RenderedDemoFactory`` reads the tree back into
the demos and stats JAX's does, exactly, and ``make_factory`` builds it for
``env.factory=rendered``, on which the port's ``train_act`` CLI trains
(on the port's ``render_data`` output).
"""

import pickle

import numpy as np
import pytest

from genima_tpu.envs.export import export_demos_rlbench_format as jax_export
from genima_tpu.envs.fake import FakeRLBenchFactory as JaxFakeFactory
from genima_tpu.envs.rendered import RenderedDemoFactory as JaxRenderedFactory
from genima_tpu.envs.rendered import load_episode_as_demo as jax_load_episode

from genima_torch.cli import render_data, train_act
from genima_torch.control import policy
from genima_torch.core import checkpoint as ckpt
from genima_torch.envs.export import export_demos_rlbench_format
from genima_torch.envs.fake import FakeRLBenchFactory
from genima_torch.envs.rendered import RenderedDemoFactory, load_episode_as_demo
from genima_torch.envs.rlbench import make_factory
from genima_torch.nn.clip_text import CLIPTextConfig

TASK = "fake_reach_visual"
CAMERAS = ("wrist", "front", "right_shoulder", "left_shoulder")
FACTORY_KW = dict(task_name=TASK, image_size=24, demo_length=6, episode_length=12,
                  goal_observable=True, seed=3)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("exported")
    demos = FakeRLBenchFactory(**FACTORY_KW).collect_or_fetch_demos(2)
    jdemos = JaxFakeFactory(**FACTORY_KW).collect_or_fetch_demos(2)
    export_demos_rlbench_format(demos, root / "port", TASK)
    jax_export(jdemos, root / "jax", TASK)
    return demos, root


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_equal(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b, path


def test_export_tree_equals_jax(exported):
    _, root = exported
    files = _files(root / "jax")
    assert _files(root / "port") == files
    assert len([f for f in files if f.suffix == ".png"]) == 2 * 4 * 6
    for rel in files:
        got, want = (root / "port" / rel).read_bytes(), (root / "jax" / rel).read_bytes()
        if rel.suffix == ".png":
            assert got == want, rel
        else:  # the pickles: equal records (and bytes, as both write the same objects)
            _assert_equal(pickle.loads(got), pickle.loads(want), str(rel))
            assert got == want, rel


def test_load_episode_matches_jax(exported):
    demos, root = exported
    ep0 = root / "port" / TASK / "variation0" / "episodes" / "episode0"
    got = load_episode_as_demo(ep0, CAMERAS, "desc")
    want = jax_load_episode(ep0, CAMERAS, "desc")
    assert len(got) == len(want) == len(demos[0])
    for g, w, orig in zip(got, want, demos[0]):
        _assert_equal(g.observation, w.observation)
        _assert_equal(g.misc, w.misc)
        np.testing.assert_array_equal(g.joint_positions, w.joint_positions)
        np.testing.assert_array_equal(g.gripper_matrix, w.gripper_matrix)
        assert g.gripper_open == w.gripper_open == orig.gripper_open
        np.testing.assert_array_equal(g.observation["front_rgb"], orig.observation["front_rgb"])


def test_rendered_factory_matches_jax(exported):
    """Demos and stats from disk equal JAX's, and the stats equal the
    in-memory demos' (the controller normalizes alike on either path)."""
    demos, root = exported
    fake = FakeRLBenchFactory(**FACTORY_KW)
    got = RenderedDemoFactory(root / "port", task_names=[TASK], eval_factory=fake)
    want = JaxRenderedFactory(root / "port", task_names=[TASK])
    gd, wd = got.collect_or_fetch_demos(2), want.collect_or_fetch_demos(2)
    assert [len(d) for d in gd] == [len(d) for d in wd] == [6, 6]
    for ga, wa in zip(gd, wd):
        for g, w in zip(ga, wa):
            _assert_equal(g.observation, w.observation)
            _assert_equal(g.misc, w.misc)
    for k in ("mean", "std", "min", "max"):
        if k in want.action_stats:
            np.testing.assert_array_equal(got.action_stats[k], want.action_stats[k])
            np.testing.assert_array_equal(got.proprio_stats[k], want.proprio_stats[k])
    from genima_torch.envs.demo import compute_action_stats

    np.testing.assert_allclose(got.action_stats["mean"], compute_action_stats(demos)["mean"],
                               atol=1e-6)
    env = got.make_eval_env(frame_stack=1, action_sequence=4)
    obs, _ = env.reset()
    assert obs["front_rgb"].shape[-1] == 24


def test_make_eval_env_needs_a_live_factory(exported):
    _, root = exported
    with pytest.raises(RuntimeError, match="eval_factory"):
        RenderedDemoFactory(root / "port", task_names=[TASK]).make_eval_env(frame_stack=1)


def test_make_factory_rendered(exported):
    _, root = exported
    f = make_factory({"factory": "rendered", "dataset_root": str(root / "port"), "task": TASK,
                      "eval_env_factory": "fake", "image_size": 24, "goal_observable": True})
    assert isinstance(f, RenderedDemoFactory) and isinstance(f.eval_factory, FakeRLBenchFactory)
    assert len(f.collect_or_fetch_demos(1)) == 1
    env = f.make_eval_env(frame_stack=1, action_sequence=4)
    assert env.reset()[0]["front_rgb"].shape[-1] == 24


def test_train_act_cli_trains_on_a_rendered_tree(exported, tmp_path, monkeypatch):
    """``render_data`` on the exported tree, then ``train_act
    env.factory=rendered env.eval_env_factory=fake`` on its output, one
    epoch, tiny widths (and a tiny CLIP: no checkpoint holds CLIP)."""
    _, root = exported
    render_data.main([f"dataset_root={root / 'port'}", f"save_path={tmp_path}", f"task={TASK}",
                      "episodes=2", "image_width=24", "image_height=24", "action_horizon=2",
                      f"cameras=[{','.join(CAMERAS)}]", "camera_scales=[1.0,1.0,1.0,1.0]",
                      "render.sphere.radius=0.11", "draw.rnd_bg=false", "device=cpu"])
    build = policy.build_agent

    def build_tiny(cfg, device="cuda", dtype=None):
        agent = build(cfg, device=device, dtype=dtype)
        agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=agent.act_cfg.lang_dim)
        return agent

    monkeypatch.setattr(train_act, "build_agent", build_tiny)
    work = tmp_path / "ctrl"
    ws = train_act.main([
        f"work_dir={work}", "device=cpu", "num_train_epochs=1", "env.factory=rendered",
        f"env.dataset_root={tmp_path / 'port_rgb_rendered'}", f"env.train_tasks=[{TASK}]",
        "+env.eval_env_factory=fake", "env.image_size=24", "+env.goal_observable=true",
        "num_demos=2", "batch_size=4", "action_sequence=4", "method.image_size=24",
        "+method.resnet_width=8", "method.act_cfg.hidden_dim=32", "method.act_cfg.enc_layers=1",
        "method.act_cfg.dec_layers=1", "method.act_cfg.dim_feedforward=64",
        "method.act_cfg.nheads=2", "method.act_cfg.latent_dim=8", "method.act_cfg.lang_dim=16",
    ])
    assert isinstance(ws.factory, RenderedDemoFactory)
    assert ws._num_iters > 0 and not ws.update_failures
    payload = ckpt.load_epoch_checkpoint(work / ckpt.LATEST_NAME)
    assert payload["epoch"] == 1 and payload["config"]["env"]["factory"] == "rendered"
