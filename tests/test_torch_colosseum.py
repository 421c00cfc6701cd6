"""The Colosseum configs as the port's Python data (``genima_torch/cfgs.py``)
against the six ``genima_tpu/cfgs/colosseum/*.yaml`` files, and
``colosseum_use`` reaching the simulator gate with JAX's error type in the
env factory and ``train_act`` (the eval CLIs: ``test_torch_eval_harness.py``)."""

from pathlib import Path

import pytest
import yaml

import genima_tpu
from genima_tpu.envs.rlbench import make_factory as jax_make_factory

from genima_torch.cfgs import COLOSSEUM
from genima_torch.cli import train_act
from genima_torch.core.config import parse_yaml
from genima_torch.envs.rlbench import SimulatorMissing, make_factory

YAML_DIR = Path(genima_tpu.__file__).parent / "cfgs" / "colosseum"
NAMES = sorted(p.stem for p in YAML_DIR.glob("*.yaml"))


def test_every_yaml_file_has_its_entry():
    assert len(NAMES) == 6 and sorted(COLOSSEUM) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_entry_equals_the_yaml_file(name):
    text = (YAML_DIR / f"{name}.yaml").read_text()
    assert COLOSSEUM[name] == yaml.safe_load(text) == parse_yaml(text)


def test_colosseum_use_meets_the_simulator_gate_as_jax():
    env_cfg = {"factory": "rlbench", "task": "open_drawer", "colosseum_use": True,
               "colosseum_task_config": "random_object_color"}
    with pytest.raises(ImportError) as ref:
        jax_make_factory(dict(env_cfg))
    with pytest.raises(ImportError) as ours:
        make_factory(dict(env_cfg))
    assert isinstance(ours.value, SimulatorMissing) and "random_object_color" in str(ours.value)
    assert str(ref.value).split(";")[0] in str(ours.value)


def test_train_act_with_colosseum_use_meets_the_gate(tmp_path):
    with pytest.raises(ImportError, match="rlbench/pyrep are not installed"):
        train_act.main([f"work_dir={tmp_path}", "device=cpu", "env.factory=rlbench",
                        "env.colosseum_use=true",
                        "env.colosseum_task_config=random_table_textures"])
