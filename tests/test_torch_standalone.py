"""The port stands alone: importing every module of ``genima_torch`` loads
neither JAX nor anything of the JAX package ``genima_tpu``; importing the
eval path loads none of the packages the card's machine lacks."""

import os
import subprocess
import sys

CODE = """
import importlib, pkgutil, sys
import genima_torch
names = [m.name for m in pkgutil.walk_packages(genima_torch.__path__, "genima_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "genima_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 74  # every module was walked


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = "import sys, runpy; runpy.run_path('chip_smoke.py', run_name='not_main');" \
           "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'genima_tpu')];" \
           "assert not bad, bad"
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


EVAL_PATH = """
import importlib, sys
for name in ("core.checkpoint", "core.config", "core.logging", "envs.core", "envs.wrappers",
             "envs.fake", "envs.rlbench", "eval.agents", "eval.video", "eval.harness",
             "weights.to_jax", "weights.openai_clip", "cli.eval_genima", "cli.eval_act"):
    importlib.import_module("genima_torch." + name)
absent = ("gymnasium", "msgpack", "flax", "yaml", "imageio", "PIL", "jax", "genima_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
assert not bad, bad
"""


def test_eval_path_imports_none_of_the_packages_the_card_lacks():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", EVAL_PATH], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


TRAIN_PATH = """
import importlib, sys
for name in ("core.optim", "core.preemption", "core.logging", "core.checkpoint", "data.augment",
             "diffusion.schedulers", "diffusion.train_state", "diffusion.training",
             "diffusion.driver", "weights.load_pretrained", "cli._diffusion_args",
             "cli.train_controlnet_genima"):
    importlib.import_module("genima_torch." + name)
absent = ("jax", "jaxlib", "genima_tpu", "flax", "optax", "safetensors", "tensorboard", "wandb")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
assert not bad, bad
"""


def test_train_path_imports_none_of_the_packages_the_card_lacks():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", TRAIN_PATH], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


ACT_TRAIN_PATH = """
import importlib, sys
for name in ("nn.act", "nn.resnet", "core.optim", "core.config", "core.checkpoint",
             "core.preemption", "core.logging", "data.augment", "data.tokenizer", "envs.demo",
             "envs.fake", "envs.rlbench", "control.policy", "control.replay", "control.trainer",
             "weights.load_pretrained", "weights.openai_clip", "cli.train_act"):
    importlib.import_module("genima_torch." + name)
absent = ("yaml", "msgpack", "flax", "jax", "jaxlib", "gymnasium", "PIL", "genima_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
assert not bad, bad
"""


def test_act_train_path_imports_none_of_the_packages_the_card_lacks():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", ACT_TRAIN_PATH], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


PARALLEL_EVAL_PATH = """
import importlib, sys
for name in ("eval.parallel", "envs.subprocess_env", "envs.fake", "envs.wrappers", "eval.video",
             "cli.eval_genima", "cli.eval_act"):
    importlib.import_module("genima_torch." + name)
absent = ("jax", "jaxlib", "genima_tpu", "flax", "msgpack", "yaml", "gymnasium")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
assert not bad, bad
"""


def test_parallel_eval_path_imports_none_of_the_packages_the_card_lacks():
    """What ``num_parallel_envs > 1`` imports in the CLIs, the workspace, and
    the env children (``envs.subprocess_env`` and the modules it runs)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", PARALLEL_EVAL_PATH], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


RENDER_PRETRAIN_PATH = """
import importlib, sys
for name in ("rendering.spheres", "rendering.compositor", "rendering.render_data", "envs.export",
             "envs.rendered", "envs.rlbench", "native", "data.dataset", "diffusion.pretrain",
             "eval.learning_gate", "cli.render_data"):
    importlib.import_module("genima_torch." + name)
absent = ("jax", "jaxlib", "genima_tpu", "flax", "msgpack", "yaml")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
assert not bad, bad
"""


def test_render_and_pretrain_path_imports_none_of_the_packages_the_card_lacks():
    """What ``render_data``, the rendered-demo factory, the pretrainers and
    the learning gate import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", RENDER_PRETRAIN_PATH], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
