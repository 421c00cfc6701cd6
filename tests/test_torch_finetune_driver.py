"""The trainer CLI end to end on the CPU at the tiny config, against the JAX
package's driver.

- The port's parser takes every flag of JAX's ``build_parser("sd")`` with
  the same default, plus ``--device``.
- One run with step checkpoints, validation, every augmentation and a
  preemption request after step 3, then a resume from ``latest`` to the
  end, then the eval agent loading the final save: the checkpoint
  directories, retention, the restored state (bit for bit), the validation
  PNGs and the final ControlNet.
- The port's ``run_training`` and JAX's on the same arguments leave the
  same file tree and the same ``metrics.jsonl`` keys at each line.
- The 8-bit AdamW under accumulation through the CLI.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from genima_tpu.cli._diffusion_args import build_parser as jax_build_parser
from genima_tpu.diffusion import driver as jax_driver
from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

from genima_torch.cli._diffusion_args import build_parser
from genima_torch.cli.train_controlnet_genima import parse_args
from genima_torch.core import checkpoint as ckpt
from genima_torch.core.optim import Adam8bitState, MultiStepsState
from genima_torch.core.preemption import PreemptionGuard
from genima_torch.diffusion import driver
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval.agents import SDControlNetAgent
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

IMAGE, BSZ = 32, 2
AUGMENTATIONS = "colorjitter,elastic,blur,affine,crop"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_pipe():
    return SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32, device="cpu", vae_encoder=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The rendered-dataset tree: 2 episodes of 4 tiled_rgb /
    tiled_rgb_rendered PNG pairs (6 samples)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for ep in range(2):
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = root / "toy" / "variation0" / "episodes" / f"episode{ep}" / sub
            d.mkdir(parents=True)
            for i in range(4):
                Image.fromarray(rng.randint(0, 255, (IMAGE, IMAGE, 3), dtype=np.uint8)).save(
                    d / f"{i}.png")
    return root


def _argv(data, out, *extra):
    return ["--data_path", str(data), "--tasks", "toy", "--resolution", str(IMAGE),
            "--train_batch_size", str(BSZ), "--seed", "0", "--mixed_precision", "no",
            "--enable_xformers_memory_efficient_attention", "--dataloader_num_workers", "2",
            "--output_dir", str(out), "--report_to", "none", *extra]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_parser_has_every_jax_flag_and_default():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required, a.nargs,
                         tuple(a.choices) if a.choices else None)
                for a in parser._actions if a.dest != "help"}

    got, want = flags(build_parser()), flags(jax_build_parser("sd"))
    assert got.pop("device") == (("--device",), "cuda", False, None, ("cuda", "cpu"))
    assert got == want
    defaults = vars(build_parser().parse_args([]))
    assert (defaults["checkpointing_steps"], defaults["validation_steps"],
            defaults["report_to"]) == (500, 100, "tensorboard")


def test_checkpoint_preempt_resume_and_final_save(data, tmp_path):
    out = tmp_path / "out"
    argv = _argv(data, out, "--device", "cpu", "--max_train_steps", "6",
                 "--checkpointing_steps", "2", "--checkpoints_total_limit", "1",
                 "--validation_steps", "2", "--augmentations", AUGMENTATIONS)
    guard, held = PreemptionGuard(), {}

    def hook(step, state, metrics):
        assert np.isfinite(float(metrics["loss"]))
        if step == 3:
            held["params"] = {k: t.clone() for k, t in state.params.items()}
            held["mu"] = {k: t.clone() for k, t in state.opt_state.mu.items()}
            guard.request()

    result = driver.run_training(parse_args(argv), pipe=_port_pipe(), step_hook=hook,
                                 preemption=guard)
    assert result["global_step"] == 3 and np.isfinite(result["val_mse"])
    assert [p.name for _, p in ckpt.list_step_checkpoints(out)] == ["checkpoint-3"]
    for f in ("controlnet/params.msgpack", "train_state.msgpack", "metadata.json"):
        assert (out / "checkpoint-3" / f).is_file(), f
    assert json.loads((out / "checkpoint-3" / "metadata.json").read_text()) == {"step": 3}
    assert (out / "logs" / "validation" / "step2_val0.png").is_file()
    grid = np.asarray(Image.open(out / "logs" / "validation" / "step2_val0.png"))
    assert grid.shape == (IMAGE, 4 * IMAGE, 3)

    # the state a resume loads, bit for bit what the run held at step 3
    pipe = _port_pipe()
    trainer_args = parse_args(argv + ["--resume_from_checkpoint", "latest"])
    trainer = driver.ControlNetTrainer(pipe, driver.train_config(trainer_args, 6))
    state = trainer.create_state(driver.init_model_params(pipe, trainer_args))
    state = driver.restore_checkpoint(trainer, state, ckpt.latest_step_checkpoint(out))
    assert state.step == 3 and state.opt_state.count == 3
    for k in held["params"]:
        assert torch.equal(state.params[k], held["params"][k]), k
        assert torch.equal(state.opt_state.mu[k], held["mu"][k]), k
    final = {}
    result = driver.run_training(trainer_args, pipe=_port_pipe(),
                                 step_hook=lambda s, st, m: final.update(step=s, params=st.params))
    assert result["global_step"] == final["step"] == 6
    assert [p.name for _, p in ckpt.list_step_checkpoints(out)] == ["checkpoint-6"]
    assert {f"step{s}_val0.png" for s in (2, 4, 6)} <= {
        p.name for p in (out / "logs" / "validation").iterdir()}

    # the final save loads into the eval agent
    agent = SDControlNetAgent(pipe=_port_pipe(), diffusion_ckpt=str(out / "controlnet"),
                              resolution=IMAGE, device="cpu")
    cn = agent.params["controlnet"].state_dict()
    for k, t in final["params"].items():
        assert torch.equal(cn[k], t), k


def test_file_tree_and_metrics_match_jax(data, tmp_path):
    common = ["--max_train_steps", "4", "--checkpointing_steps", "2", "--checkpoints_total_limit",
              "2", "--validation_steps", "3", "--lr_warmup_steps", "0"]
    jpipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(), vae_cfg=JaxVAEConfig.tiny_test(),
                        text_cfg=JaxCLIPConfig.tiny(), dtype=jnp.float32, backend="fused")
    jres = jax_driver.run_training(
        jax_build_parser("sd").parse_args(_argv(data, tmp_path / "jax", *common)), "sd", jpipe)
    res = driver.run_training(parse_args(_argv(data, tmp_path / "port", "--device", "cpu", *common)),
                              pipe=_port_pipe())
    assert res["global_step"] == jres["global_step"] == 4
    assert np.isfinite(res["val_mse"]) and np.isfinite(jres["val_mse"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")

    def keys(root):
        lines = (root / "logs" / "metrics.jsonl").read_text().splitlines()
        return [(json.loads(s)["step"], sorted(json.loads(s))) for s in lines]

    assert keys(tmp_path / "port") == keys(tmp_path / "jax")


def test_8bit_adam_with_accumulation_through_the_cli(data, tmp_path):
    seen = []

    def hook(step, state, metrics):
        seen.append((step, {k: t.clone() for k, t in state.params.items()}, state.opt_state))

    argv = _argv(data, tmp_path, "--device", "cpu", "--max_train_steps", "4", "--use_8bit_adam",
                 "--gradient_accumulation_steps", "2", "--checkpointing_steps", "4",
                 "--validation_steps", "0", "--lr_warmup_steps", "0")
    result = driver.run_training(parse_args(argv), pipe=_port_pipe(), step_hook=hook)
    assert result["global_step"] == 4 and np.isfinite(result["final_loss"])
    assert [s for s, _, _ in seen] == [1, 2, 3, 4]
    assert all(isinstance(o, MultiStepsState) and isinstance(o.inner_opt_state, Adam8bitState)
               for _, _, o in seen)
    assert [o.inner_opt_state.count for _, _, o in seen] == [0, 1, 1, 2]
    cn = driver.init_model_params(_port_pipe(), parse_args(argv))["controlnet"]  # as the run's
    init = {k: p.detach() for k, p in cn.named_parameters()}
    params = [init] + [p for _, p, _ in seen]
    moved = [not all(torch.equal(a[k], b[k]) for k in a) for a, b in zip(params, params[1:])]
    assert moved == [False, True, False, True]  # updates on mini-steps 2 and 4 only
    restored = ckpt.load_pytree(tmp_path / "checkpoint-4" / "train_state.msgpack")
    assert int(restored["opt_state"]["gradient_step"]) == 2
    assert int(restored["step"]) == 4
