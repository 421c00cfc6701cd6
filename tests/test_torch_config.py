"""The port's config system against the JAX package's.

Override values are parsed by the port's own YAML-scalar parser (PyYAML is
not on the card's machine); here they are held to ``yaml.safe_load``. The
eval CLIs' defaults, kept as Python data, are held to the JAX YAML files.
"""

import math
from pathlib import Path

import pytest
import yaml

from genima_tpu.core import config as jcfg

from genima_torch.cli.eval_act import EVAL_ACT
from genima_torch.cli.eval_genima import EVAL_GENIMA
from genima_torch.core import config as cfg

VALUES = [
    "5", "-3", "0", "007", "0x1F", "0b101", "1_000", "+5", "1:30", "5.0e-05", "1e-3", "1e+3",
    "1.0e+3", "1.5", ".5", "3.", "-.inf", ".nan", "null", "~", "", "NULL", "true", "False",
    "on", "off", "yes", "abc", "/tmp/x/", "[a, b]", "[wrist, front, right_shoulder, left_shoulder]",
    "[3.0, 8.0, 6.5, 6.5]", "[]", "[1,2]", "[a,[b,c]]", "{a: 1, b: [x, y]}", "'quoted'",
    '"dq\\n"', "genima_torch.eval.agents.make_tiny_sd_agent", "a b c", "${x.y}", "x#y",
    "x #c", "a:b", "a: b", "- a", "http://x", "fake_reach", "it's", "[unclosed",
]


def _same(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", VALUES)
def test_override_values_parse_as_yaml_does(text):
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        want = text
    assert _same(cfg.parse_value(text), want), (text, want)


def test_overrides_interpolation_and_cli_match_jax():
    base = {"a": {"b": 1, "c": "${a.b}"}, "name": "x_${a.b}", "lst": [1, 2],
            "node": {"_target_": "m.C"}}
    argv = ["a.b=7", "+new.key=[1, 2]", "name=y_${a.b}", "--config-name", "f.yaml",
            "--multirun", "lst=[3]"]
    j_over, j_flags = jcfg.parse_cli(argv)
    p_over, p_flags = cfg.parse_cli(argv)
    assert (p_over, p_flags) == (j_over, j_flags)
    want = jcfg.resolve(jcfg.apply_overrides(jcfg.Config.from_dict(base), j_over))
    got = cfg.resolve(cfg.apply_overrides(cfg.Config.from_dict(base), p_over))
    assert got.to_dict() == want.to_dict()
    assert got.a.c == 7 and got.name == "y_7"
    merged = cfg.merge(base, {"a": {"d": 2}, "lst": [9]})
    assert merged.to_dict() == jcfg.merge(base, {"a": {"d": 2}, "lst": [9]}).to_dict()
    for bad in (["nokey=1"], ["a.nokey=1"], ["novalue"]):
        with pytest.raises((KeyError, ValueError)):
            cfg.apply_overrides(cfg.Config.from_dict(base), bad)


def test_instantiate_refuses_targets_outside_the_port():
    with pytest.raises(ValueError, match="outside genima_torch"):
        cfg.instantiate({"_target_": "genima_tpu.eval.agents.SDControlNetAgent"})
    with pytest.raises(ValueError, match="fully qualified"):
        cfg.instantiate({"_target_": "Agent"})
    part = cfg.instantiate({"_target_": "genima_torch.core.config.merge", "_partial_": True,
                            "override": {"b": 2}})
    assert part({"a": 1}).to_dict() == {"a": 1, "b": 2}


JAX_CFGS = Path(__file__).resolve().parent.parent / "genima_tpu" / "cfgs"
# defaults the port sets apart, and why: no /tmp paths (the checkpoint dir
# must be named; media go beside it), and its own diffusion agent class
PORT_DIFFERENCES = {"diffusion_ckpt", "controller_ckpt", "dataset_root", "save_image_path",
                    "diffusion_agent"}


# keys the port adds to the JAX configs, and why: the device to run on;
# eval_overlap, which the JAX lockstep workspace reads with a default of
# true (genima_tpu/eval/parallel.py); num_parallel_envs for eval_act, which
# runs eval_genima's main, whose config has it (JAX's eval_act.yaml does not)
PORT_ONLY = {"eval_genima": {"device": "cuda", "eval_overlap": True},
             "eval_act": {"device": "cuda", "num_parallel_envs": 1}}


@pytest.mark.parametrize("name, port", [("eval_genima", EVAL_GENIMA), ("eval_act", EVAL_ACT)])
def test_eval_defaults_follow_the_jax_configs(name, port):
    jax_defaults = jcfg.load_yaml(JAX_CFGS / f"{name}.yaml").to_dict()
    assert set(port) == set(jax_defaults) | set(PORT_ONLY[name])
    assert {k: port[k] for k in PORT_ONLY[name]} == PORT_ONLY[name]
    for key, value in jax_defaults.items():
        if key not in PORT_DIFFERENCES:
            assert port[key] == value, key
    if name == "eval_genima":
        assert port["diffusion_agent"] == {
            "_target_": "genima_torch.eval.agents.SDControlNetAgent"}


def test_load_yaml_reads_a_config_file(tmp_path):
    (tmp_path / "c.yaml").write_text("a: 1\nb: {c: [x, y]}\n")
    assert cfg.load_yaml(tmp_path / "c.yaml").b.c == ["x", "y"]
