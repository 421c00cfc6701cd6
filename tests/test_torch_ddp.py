"""Data-parallel training in the port: two gloo ranks spawned on the CPU
(``file://`` rendezvous) against one process on the concatenated batch.

- One ``ControlNetTrainer`` step, one ``Pix2PixTrainer`` step with its EMA
  and conditioning dropout, and one ACT update (augmentation and dropout
  on), each at batch 1 a rank: the ranks' parameters are bit-equal, and
  equal to one single-process step at batch 2 with the same global draws
  to 1e-5 (relative norm; the gradients the same).
- ``run_training`` at world 2 writes one checkpoint tree and one
  ``metrics.jsonl`` (rank 0's), and its ranks end bit-equal.
- The learning rate, warmup and schedule length at N processes follow the
  JAX driver's formula at ``n_dev = N``.

Every rank runs all cases in one spawn (each child imports torch and the
port once); the parent computes the references.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from PIL import Image

from genima_torch.cli.train_controlnet_genima import parse_args
from genima_torch.control import policy
from genima_torch.core import checkpoint as ckpt
from genima_torch.core import distributed as dist
from genima_torch.core.mesh import process_mesh
from genima_torch.diffusion import driver, training
from genima_torch.diffusion.pipeline import SDControlNetPipeline, SDPix2PixPipeline
from genima_torch.nn import act
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

WORLD, IMAGE, B = 2, 32, 2  # B: the global batch
V, HW, T = 2, 32, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sd_pipe():
    return SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32, device="cpu", vae_encoder=True)


def _pix2pix_pipe():
    return SDPix2PixPipeline(unet_cfg=UNetConfig.tiny(in_channels=8),
                             vae_cfg=VAEConfig.tiny_test(), text_cfg=CLIPTextConfig.tiny(),
                             dtype=torch.float32, device="cpu")


def _agent():
    return policy.GenimaACTAgent(
        act_cfg=act.ACTConfig.tiny(num_queries=T), clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
        resnet_width=8, data_augmentation=True, device="cpu", dtype=torch.float32)


def _image_batch(seed):
    rng = np.random.RandomState(seed)
    return {
        "pixel_values": rng.randint(0, 255, (B, IMAGE, IMAGE, 3)).astype(np.uint8),
        "conditioning_pixel_values": rng.randint(0, 255, (B, IMAGE, IMAGE, 3)).astype(np.uint8),
        "input_ids": rng.randint(0, 1000, (B, 77)).astype(np.int32),
    }


def _act_batch(seed=3):
    rng = np.random.RandomState(seed)
    is_pad = np.zeros((B, T), bool)
    is_pad[1, 2:] = True
    return {
        "images": rng.uniform(0, 255, (B, V, HW, HW, 3)).astype(np.float32),
        "qpos": rng.randn(B, 8).astype(np.float32),
        "actions": rng.randn(B, T, 8).astype(np.float32),
        "is_pad": is_pad,
        "lang_tokens": rng.randint(0, 1000, (B, 77)).astype(np.int32),
    }


def _rows(batch, rows):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def _capturing(real, grads: dict):
    """``all_reduce_mean_`` that also keeps the (reduced) gradients."""

    def capture(g, *scalars):
        out = real(g, *scalars)
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return out

    return capture


def _diffusion_step(kind, mesh, rows):
    """One step of the ``kind`` trainer on ``rows`` of the global batch: the
    f32 params (and EMA) after it, and the gradients the update used."""
    grads, real = {}, training.all_reduce_mean_
    training.all_reduce_mean_ = _capturing(real, grads)
    try:
        if kind == "controlnet":
            pipe = _sd_pipe()
            trainer = training.ControlNetTrainer(
                pipe, training.TrainConfig(augmentations="colorjitter,crop"), mesh)
        else:
            pipe = _pix2pix_pipe()
            trainer = training.Pix2PixTrainer(pipe, training.TrainConfig(), mesh,
                                              conditioning_dropout_prob=0.3, use_ema=True,
                                              ema_decay=0.5)
        params = pipe.init_params(torch.Generator().manual_seed(0))
        state = trainer.create_state(params)
        state, metrics = trainer.train_step(state, _rows(_image_batch(1), rows),
                                            torch.Generator().manual_seed(5))
    finally:
        training.all_reduce_mean_ = real
    out = {"params": {k: v.detach() for k, v in state.params.items()}, "grads": grads,
           "loss": float(metrics["loss"])}
    if state.ema is not None:
        out["ema"] = state.ema
    return out


def _act_step(mesh, rows):
    agent = _agent()
    params, clip = agent.init_params(torch.Generator().manual_seed(0))
    state = agent.create_state(params, clip)
    batch = _rows(_act_batch(), rows)
    draws = agent.sample_draws(batch, torch.Generator().manual_seed(7), mesh=mesh)
    grads, real = {}, policy.all_reduce_mean_
    policy.all_reduce_mean_ = _capturing(real, grads)
    try:
        state, metrics = agent.update(state, batch, draws)
    finally:
        policy.all_reduce_mean_ = real
    return {"params": {k: v.detach() for k, v in state.master.items()}, "grads": grads,
            "loss": float(metrics["loss"])}


def _rank_main(rank, init_file, out_dir, data_dir):
    torch.set_num_threads(1)
    dist.initialize(init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                    backend="gloo", device="cpu")
    try:
        mesh = process_mesh("cpu")
        rows = slice(rank, rank + 1)
        results = {kind: _diffusion_step(kind, mesh, rows) for kind in ("controlnet", "pix2pix")}
        results["act"] = _act_step(mesh, rows)
        finals = {}
        args = parse_args(_train_argv(data_dir, out_dir))
        driver.run_training(args, pipe=_sd_pipe(),
                            step_hook=lambda step, state, m: finals.update(
                                {k: v.clone() for k, v in state.params.items()}))
        results["run_training"] = {"params": finals}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def _train_argv(data_dir, out_dir):
    return ["--data_path", str(data_dir), "--tasks", "toy", "--resolution", str(IMAGE),
            "--train_batch_size", "1", "--seed", "0", "--mixed_precision", "no",
            "--enable_xformers_memory_efficient_attention", "--dataloader_num_workers", "1",
            "--output_dir", os.path.join(out_dir, "run"), "--report_to", "none",
            "--device", "cpu", "--max_train_steps", "2", "--checkpointing_steps", "2",
            "--validation_steps", "0", "--lr_scheduler", "constant"]


def _write_data(root):
    rng = np.random.RandomState(0)
    for ep in range(2):
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = root / "toy" / "variation0" / "episodes" / f"episode{ep}" / sub
            d.mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.randint(0, 255, (IMAGE, IMAGE, 3), dtype=np.uint8)).save(
                    d / f"{i}.png")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    data = root / "data"
    _write_data(data)
    mp.spawn(_rank_main, args=(str(root / "rendezvous"), str(root), str(data)),
             nprocs=WORLD, join=True)
    return root, [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rel(got: dict, want: dict) -> float:
    num = sum(float((got[k].double() - want[k].double()).norm() ** 2) for k in want)
    den = sum(float(want[k].double().norm() ** 2) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("kind", ["controlnet", "pix2pix", "act"])
def test_two_ranks_equal_one_process_on_the_concatenated_batch(ranks, kind):
    _, results = ranks
    got = [r[kind] for r in results]
    for name in got[0]["params"]:
        assert torch.equal(got[0]["params"][name], got[1]["params"][name]), name
    single = (_act_step(None, slice(None)) if kind == "act"
              else _diffusion_step(kind, None, slice(None)))
    assert set(got[0]["params"]) == set(single["params"])
    assert _rel(got[0]["params"], single["params"]) <= 1e-5
    assert got[0]["loss"] == pytest.approx(single["loss"], rel=1e-5)
    if "grads" in single:
        assert _rel(got[0]["grads"], single["grads"]) <= 1e-5
        assert _rel(got[1]["grads"], got[0]["grads"]) == 0.0
    if "ema" in single:
        assert all(torch.equal(got[0]["ema"][k], got[1]["ema"][k]) for k in single["ema"])
        assert _rel(got[0]["ema"], single["ema"]) <= 1e-5


def test_run_training_at_world_two_writes_once(ranks):
    root, results = ranks
    out = root / "run"
    finals = [r["run_training"]["params"] for r in results]
    assert finals[0] and all(torch.equal(finals[0][k], finals[1][k]) for k in finals[0])
    assert [p.name for _, p in ckpt.list_step_checkpoints(out)] == ["checkpoint-2"]
    assert (out / "checkpoint-2" / "controlnet" / "params.msgpack").is_file()
    assert (out / "controlnet" / "params.msgpack").is_file()
    lines = [json.loads(x) for x in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [1]  # rank 0's line alone
    saved = ckpt.load_pytree(out / "controlnet" / "params.msgpack")
    assert np.isfinite(np.asarray(saved["conv_in"]["kernel"])).all()


@pytest.mark.parametrize("scheduler", ["constant", "cosine"])
def test_learning_rate_warmup_and_length_follow_jax_at_two_devices(tmp_path, scheduler):
    n_dev, max_steps = 2, 7
    args = parse_args(["--data_path", str(tmp_path), "--tasks", "toy", "--scale_lr",
                       "--train_batch_size", "3", "--gradient_accumulation_steps", "2",
                       "--lr_warmup_steps", "5", "--lr_scheduler", scheduler,
                       "--device", "cpu"])
    cfg = driver.train_config(args, max_steps, n_dev)
    # genima_tpu/diffusion/driver.py: lr *= accumulation * batch * n_dev,
    # lr_warmup_steps * n_dev, max_train_steps * n_dev
    assert cfg.learning_rate == args.learning_rate * 2 * 3 * n_dev
    assert cfg.lr_warmup_steps == 5 * n_dev
    assert cfg.max_train_steps == max_steps * n_dev
    assert driver.train_config(args, max_steps).max_train_steps == max_steps


def test_a_dataset_too_small_for_the_world_raises(tmp_path, monkeypatch):
    data = tmp_path / "data"
    _write_data(data)  # 4 samples
    args = parse_args(_train_argv(data, tmp_path) + ["--train_batch_size", "3"])
    with dist.force_process(0, 2), pytest.raises(ValueError, match="on each of 2 processes"):
        driver.run_training(args, pipe=_sd_pipe())
