"""The port's controller trainer against the JAX package's, on the CPU.

Demos, stats and replay contents from the fake factory; the epoch
checkpoints' rotation and retention and their payloads, read by either
package; ``config.yaml``; a torchvision-named ResNet file; and the port's
``train_act`` CLI: it trains one epoch, the JAX package's controller
workspace resumes from the port's work dir for a second, the port resumes
from the JAX package's checkpoint for a third, and the port's ``eval_act``
runs on the result.
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

from genima_tpu.control.policy import GenimaACTAgent as JaxACTAgent
from genima_tpu.control.replay import EpochReplayBuffer as JaxReplay
from genima_tpu.control.trainer import ControllerWorkspace as JaxWorkspace
from genima_tpu.core import checkpoint as jckpt
from genima_tpu.core import config as jconfig
from genima_tpu.data.tokenizer import load_tokenizer as jax_tokenizer
from genima_tpu.envs.rlbench import make_factory as jax_make_factory
from genima_tpu.nn.act import ACTConfig as JaxACTConfig
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.resnet import ResNet18 as JaxResNet
from genima_tpu.weights.torch_port import load_torch_file, port_torch_state_dict

from genima_torch.cli import eval_act, train_act
from genima_torch.control import policy
from genima_torch.control.policy import GenimaACTAgent
from genima_torch.control.replay import EpochReplayBuffer
from genima_torch.control.trainer import ControllerWorkspace
from genima_torch.core import checkpoint as ckpt
from genima_torch.core import config
from genima_torch.core.preemption import PreemptionGuard
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.envs.rlbench import make_factory
from genima_torch.nn.act import ACTConfig
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.resnet import ResNet18
from genima_torch.weights.init import build_module, init_random_
from genima_torch.weights.load_pretrained import load_torchvision_resnet
from genima_torch.weights.to_jax import tree_from_module

TINY = [
    "env.factory=fake", "env.task=fake_reach", "env.image_size=32", "env.episode_length=30",
    "checkpoint_every=1", "num_demos=2", "batch_size=6", "action_sequence=8",
    "method.image_size=32", "+method.resnet_width=8", "method.act_cfg.hidden_dim=32",
    "method.act_cfg.enc_layers=1", "method.act_cfg.dec_layers=1",
    "method.act_cfg.dim_feedforward=64", "method.act_cfg.nheads=2",
    "method.act_cfg.latent_dim=8", "method.act_cfg.lang_dim=16",
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


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


# -- demos, stats, replay -------------------------------------------------------------------


def test_demos_stats_and_replay_match_jax():
    """Two tasks pooled, one-hot time, each episode's own description."""
    env = {"factory": "fake", "train_tasks": ["reach_a", "reach_b"], "image_size": 16,
           "episode_length": 12}
    jf, pf = jax_make_factory(dict(env)), make_factory(dict(env))
    jd, pd = jf.collect_or_fetch_demos(2), pf.collect_or_fetch_demos(2)
    assert len(jd) == len(pd) == 4
    for a, b in zip(jd, pd):
        assert len(a) == len(b)
        for sa, sb in zip(a, b):
            np.testing.assert_array_equal(sa.joint_positions, sb.joint_positions)
            assert sa.gripper_open == sb.gripper_open and sa.misc.keys() == sb.misc.keys()
            for k in sa.observation:
                np.testing.assert_array_equal(sa.observation[k], sb.observation[k])
    for name in ("action_stats", "proprio_stats"):
        for k, v in getattr(jf, name).items():
            np.testing.assert_array_equal(getattr(pf, name)[k], v, err_msg=f"{name}.{k}")
    jr, pr = JaxReplay(batch_size=3, action_sequence=4), EpochReplayBuffer(batch_size=3,
                                                                           action_sequence=4)
    jf.load_demos_into_replay(jr, tokenizer=jax_tokenizer(), onehot_time_len=12)
    pf.load_demos_into_replay(pr, tokenizer=load_tokenizer(), onehot_time_len=12)
    assert jr.num_episodes == pr.num_episodes == 4
    for a, b in zip(jr._episodes, pr._episodes):
        for field in ("images", "low_dim_state", "actions", "rewards", "lang_tokens"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    assert pr._episodes[0].low_dim_state.shape[1] == 8 + 12  # one-hot time
    assert not np.array_equal(pr._episodes[0].lang_tokens, pr._episodes[2].lang_tokens)


# -- checkpoints and config.yaml --------------------------------------------------------------


def test_epoch_checkpoint_rotation_matches_jax_and_payloads_cross_load(tmp_path):
    rng = np.random.RandomState(0)
    cfg = {"seed": 3, "method": {"lr": 5e-05}, "tasks": ["a", "b"]}
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    trees = {}
    for epoch in range(1, 6):
        trees[epoch] = {"encoder": {"w": rng.randn(3, 2).astype(np.float32)},
                        "actor": {"b": rng.randn(4).astype(np.float32)}}
        jckpt.save_epoch_checkpoint(jdir, epoch=epoch, num_iters=10 * epoch,
                                    agent_params=trees[epoch], config=cfg, num_checkpoints=2)
        ckpt.save_epoch_checkpoint(pdir, epoch=epoch, num_iters=10 * epoch,
                                   agent_params={k: {n: torch.from_numpy(a) for n, a in v.items()}
                                                 for k, v in trees[epoch].items()},
                                   config=cfg, num_checkpoints=2)
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == ["3.ckpt", "4.ckpt", "latest.ckpt"]
    for name, epoch in (("latest.ckpt", 5), ("4.ckpt", 4), ("3.ckpt", 3)):
        for reader, d in ((jckpt.load_epoch_checkpoint, pdir), (ckpt.load_epoch_checkpoint, jdir)):
            payload = reader(d / name)
            assert int(payload["epoch"]) == epoch and int(payload["num_iters"]) == 10 * epoch
            assert payload["config"] == cfg
            _assert_trees_equal(payload["agent"], trees[epoch])


def test_save_yaml_reads_back_as_jax_writes_it(tmp_path):
    cfg = config.build_config(train_act.CONTROLLER, ["env.factory=fake", "+extra=[1, {a: null}]",
                                                     "+odd='yes'", "+empty={}"])
    config.save_yaml(cfg, tmp_path / "port.yaml")
    jconfig.save_yaml(jconfig.Config.from_dict(cfg.to_dict()), tmp_path / "jax.yaml")
    want = yaml.safe_load((tmp_path / "jax.yaml").read_text())
    assert yaml.safe_load((tmp_path / "port.yaml").read_text()) == want == cfg.to_dict()
    assert config.parse_yaml((tmp_path / "port.yaml").read_text()) == want
    assert config.parse_yaml((tmp_path / "jax.yaml").read_text()) == want
    assert want["method"]["lr"] == 5e-05 and want["odd"] == "yes" and want["empty"] == {}


def test_torchvision_resnet_file_loads_as_jax_loads_it(tmp_path):
    """A file in torchvision's names (``fc.*`` and ``num_batches_tracked``
    included, FiLM absent) into a backbone with FiLM: the same tree as the
    JAX package's non-strict import; FiLM keeps its values."""
    src = build_module(lambda: ResNet18(8), torch.device("cpu"), torch.float32)
    init_random_(src, torch.Generator().manual_seed(1))
    sd = dict(src.state_dict())
    sd.update({"fc.weight": torch.randn(10, 64), "fc.bias": torch.randn(10),
               "bn1.num_batches_tracked": torch.tensor(3)})
    torch.save(sd, tmp_path / "resnet18.pth")

    port = build_module(lambda: ResNet18(8, lang_dim=16), torch.device("cpu"), torch.float32)
    init_random_(port, torch.Generator().manual_seed(2))
    film = {k: v.clone() for k, v in port.state_dict().items() if k.startswith("film")}
    loaded = load_torchvision_resnet(port, tmp_path / "resnet18.pth")
    assert "fc.weight" not in loaded and "conv1.weight" in loaded

    template = tree_from_module(port, "torchvision_resnet")  # FiLM as the port holds it
    want = port_torch_state_dict(load_torch_file(tmp_path / "resnet18.pth"), template,
                                 "torchvision_resnet", strict=False)
    _assert_trees_equal(tree_from_module(port, "torchvision_resnet"),
                        jax.tree_util.tree_map(np.asarray, want))
    for k, v in film.items():
        assert torch.equal(port.state_dict()[k], v)
    shapes = jax.eval_shape(lambda: JaxResNet(width=8).init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 16), np.float32)))
    assert set(shapes["params"]) == set(want)  # the JAX backbone's own modules


# -- the workspace ----------------------------------------------------------------------------


def _tiny_workspace(work_dir, epochs=1, checkpoint_every=1, **agent_kw):
    agent = GenimaACTAgent(act_cfg=ACTConfig.tiny(num_queries=8),
                           clip_cfg=CLIPTextConfig.tiny(projection_dim=16), resnet_width=8,
                           device="cpu", dtype=torch.float32, **agent_kw)
    cfg = config.Config.from_dict({
        "num_train_epochs": epochs, "checkpoint_every": checkpoint_every, "num_checkpoints": 3,
        "batch_size": 8, "action_sequence": 8, "seed": 0, "env": {"episode_length": 30}})
    factory = make_factory({"factory": "fake", "image_size": 32, "episode_length": 30})
    return ControllerWorkspace(cfg, agent, factory, work_dir, num_demos=1)


def test_swallowed_update_exception_preemption_and_params_only_resume(tmp_path, monkeypatch):
    ws = _tiny_workspace(tmp_path, epochs=3, checkpoint_every=10, data_augmentation=True)
    steps = -(-len(ws.replay) // 8)
    calls = {"n": 0}
    update = ws.agent.update

    def flaky(*args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("update failed")
        return update(*args)

    monkeypatch.setattr(ws.agent, "update", flaky)
    guard = PreemptionGuard()
    guard.request()
    ws.train(preemption=guard)
    # the failed update is logged, kept and skipped; the preemption stops the
    # run after the epoch, through a snapshot checkpoint_every did not ask for
    assert len(ws.update_failures) == 1 and "update failed" in ws.update_failures[0]
    assert ws._epoch == 1 and ws._num_iters == steps - 1
    payload = ckpt.load_epoch_checkpoint(tmp_path / ckpt.LATEST_NAME)
    assert int(payload["epoch"]) == 1 and int(payload["num_iters"]) == steps - 1
    _assert_trees_equal(payload["agent"], jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), ws.state.tree()))
    assert (tmp_path / "config.yaml").exists()
    assert all(s.count == steps - 1 for s in ws.state.opt_state.values())

    resumed = _tiny_workspace(tmp_path, epochs=3, checkpoint_every=10)
    assert resumed.resumed and resumed._epoch == 1 and resumed._num_iters == steps - 1
    assert all(s.count == 0 for s in resumed.state.opt_state.values())  # fresh optimizer
    _assert_trees_equal(jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                               resumed.state.tree()), payload["agent"])


def _tiny_clip(mp):
    """The agents the CLIs build get a tiny CLIP tower: no checkpoint holds
    CLIP, and its ViT-B/32 width (which ``chip_smoke.py`` runs on the card)
    would set these CPU tests' time."""
    build = policy.build_agent

    def build_tiny(cfg, device="cuda", dtype=None):
        agent = build(cfg, device=device, dtype=dtype)
        agent.clip_cfg = CLIPTextConfig.tiny(projection_dim=agent.act_cfg.lang_dim)
        return agent

    mp.setattr(policy, "build_agent", build_tiny)
    mp.setattr(train_act, "build_agent", build_tiny)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Port 1 epoch -> JAX resumes to 2 -> port resumes to 3, one work dir,
    every agent with a tiny CLIP tower. The JAX side is its
    ``ControllerWorkspace`` with the CLI's agent. 2 demos give 78 samples:
    batches of 6 leave no ragged last batch for JAX to compile again."""
    work = tmp_path_factory.mktemp("ctrl")
    with pytest.MonkeyPatch.context() as mp:
        _tiny_clip(mp)
        first = train_act.main([f"work_dir={work}", "device=cpu", "num_train_epochs=1", *TINY])
    files_after_first = sorted(p.name for p in work.iterdir())
    latest_first = ckpt.load_epoch_checkpoint(work / ckpt.LATEST_NAME)
    jagent = JaxACTAgent(act_cfg=JaxACTConfig.tiny(num_queries=8),
                         clip_cfg=JaxCLIPConfig.tiny(projection_dim=16), image_size=32,
                         resnet_width=8, data_augmentation=False)
    jcfg = jconfig.Config.from_dict({**config.build_config(train_act.CONTROLLER, TINY).to_dict(),
                                     "num_train_epochs": 2})
    jws = JaxWorkspace(jcfg, jagent, jax_make_factory(dict(jcfg.env)), work, num_demos=2,
                       logger=None)
    jws.train()
    latest_jax = ckpt.load_epoch_checkpoint(work / ckpt.LATEST_NAME)
    with pytest.MonkeyPatch.context() as mp:
        _tiny_clip(mp)
        third = train_act.main([f"work_dir={work}", "device=cpu", "num_train_epochs=3", *TINY])
    return dict(work=work, first=first, files=files_after_first, latest_first=latest_first,
                jws=jws, latest_jax=latest_jax, third=third)


def test_train_act_cli_writes_the_work_dir(cli_runs):
    first = cli_runs["first"]
    assert {"latest.ckpt", "config.yaml", "action_stats.json",
            "proprio_stats.json"} <= set(cli_runs["files"])
    assert not first.resumed and not first.update_failures
    payload = cli_runs["latest_first"]
    assert int(payload["epoch"]) == 1 and int(payload["num_iters"]) == first._num_iters > 0
    assert payload["config"]["device"] == "cpu"
    saved = config.parse_yaml((cli_runs["work"] / "config.yaml").read_text())
    assert saved["method"]["act_cfg"]["hidden_dim"] == 32
    stats = json.loads((cli_runs["work"] / "action_stats.json").read_text())
    assert len(stats["mean"]) == 8


def test_each_package_resumes_from_the_others_checkpoint(cli_runs):
    jws, third = cli_runs["jws"], cli_runs["third"]
    n = cli_runs["first"]._num_iters
    assert jws.resumed and jws._epoch == 2 and jws._num_iters == 2 * n
    assert int(cli_runs["latest_jax"]["epoch"]) == 2
    assert third.resumed and third._epoch == 3 and third._num_iters == 3 * n
    names = sorted(p.name for p in cli_runs["work"].iterdir() if p.suffix == ".ckpt")
    assert names == ["1.ckpt", "2.ckpt", "latest.ckpt"]
    final = ckpt.load_epoch_checkpoint(cli_runs["work"] / ckpt.LATEST_NAME)
    _assert_trees_equal(final["agent"], jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), third.state.tree()))
    assert "style_encoder_0" in final["agent"]["actor"]


def test_port_eval_act_runs_on_the_port_trained_controller(cli_runs, monkeypatch):
    _tiny_clip(monkeypatch)
    logs = eval_act.main([f"controller_ckpt={cli_runs['work']}", "device=cpu", "task=fake_reach",
                          "env.factory=fake", "env.image_size=32", "episode_length=30",
                          "num_eval_episodes=1", "execution_horizon=8"])
    assert logs["results"]["total_episodes"] == 1
    assert not logs["results"]["env_exception_episodes"]
