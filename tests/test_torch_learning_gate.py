"""The port's offline learning gate, on the CPU.

Tier 1 runs the whole chain at a cut ``GateConfig`` (demos -> export ->
render -> pretrain -> ControlNet fine-tune through the CLI driver -> ACT on
the rendered tree -> closed-loop eval, trained against fresh): it must
finish and write ``learning_gate.json`` with the JAX package's keys and
config fields. The ``slow`` test runs the default gate and asserts what
``tests/test_learning_gate.py`` asserts of JAX's (which records a failing
gate, ``GATE_r05.json``; neither package's gate is required to pass in
tier 1).
"""

import dataclasses
import json
import math

import pytest
import torch

from genima_tpu.eval import learning_gate as jax_gate

from genima_torch.eval import learning_gate

# the keys JAX's run_learning_gate writes (genima_tpu/eval/learning_gate.py)
JAX_KEYS = ["config", "val_mse_init", "cn_final_loss", "val_mse_final", "trained_success",
            "untrained_success", "elapsed_s", "passed"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gate_config_is_jax_config():
    assert dataclasses.asdict(learning_gate.GateConfig()) == dataclasses.asdict(
        jax_gate.GateConfig())


def test_cut_gate_runs_the_chain(tmp_path):
    cfg = learning_gate.GateConfig(
        demo_length=12, episode_length=16, num_demos=4, vae_steps=1, unet_steps=2, cn_steps=2,
        diffusion_batch=4, act_epochs=1, eval_episodes=1)
    results = learning_gate.run_learning_gate(tmp_path / "gate", cfg, device="cpu")
    saved = json.loads((tmp_path / "gate" / "learning_gate.json").read_text())
    assert list(saved) == JAX_KEYS
    assert saved["config"] == dataclasses.asdict(cfg)
    assert saved["passed"] is results["passed"] is False  # 1 epoch and 2 steps learn nothing
    for k in ("val_mse_init", "val_mse_final", "cn_final_loss"):
        assert math.isfinite(saved[k]), k
    assert 0.0 <= saved["trained_success"] <= 1.0 and 0.0 <= saved["untrained_success"] <= 1.0
    work = tmp_path / "gate"
    for rel in ("raw/fake_reach_visual/variation0/variation_descriptions.pkl",
                "raw_rgb_rendered/render_data_config.yaml",
                "raw_rgb_rendered/fake_reach_visual/variation0/episodes/episode3/tiled_rgb/10.png",
                "base/params.msgpack", "base/unet/params.msgpack", "cn/controlnet/params.msgpack",
                "ctrl/latest.ckpt", "ctrl_untrained/latest.ckpt",
                "ctrl/eval_genima_fake_reach_visual.json"):
        assert (work / rel).exists(), rel
    assert not (work / "raw_rnd_bg").exists()


def test_main_takes_a_work_dir_and_a_device(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(learning_gate, "run_learning_gate",
                        lambda work, device: seen.update(work=work, device=device))
    learning_gate.main([str(tmp_path), "device=cpu"])
    assert seen == {"work": str(tmp_path), "device": "cpu"}


@pytest.mark.slow
def test_default_gate_trained_policy_wins(tmp_path):
    cfg = learning_gate.GateConfig()
    results = learning_gate.run_learning_gate(tmp_path / "gate", cfg, device="cpu")
    assert results["val_mse_final"] < results["val_mse_init"], results
    assert results["trained_success"] >= cfg.min_trained_success, results
    assert results["untrained_success"] <= cfg.max_untrained_success, results
    assert results["passed"], results
    saved = json.loads((tmp_path / "gate" / "learning_gate.json").read_text())
    assert saved["passed"] is True
