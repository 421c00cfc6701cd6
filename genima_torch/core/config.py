"""Hydra-style configuration without hydra, OmegaConf or PyYAML.

Counterpart of ``genima_tpu/core/config.py``: nested ``Config`` dicts with
attribute access, deep ``merge``, dotted CLI overrides (``a.b=value``,
``+new.key=value``), ``${a.b}`` interpolation (``resolve``), ``parse_cli``
and ``_target_`` instantiation.

The port's entry points keep their defaults as Python data and read a saved
train config from the checkpoint's JSON, so no YAML file is read on their
path. Override values are parsed here with PyYAML's rules for plain
scalars and flow lists/maps (``5`` -> int, ``5.0e-05`` -> float, ``1e-3``
-> str, ``null`` -> None, ``[a, b]`` -> list), the same values the JAX
package gets from ``yaml.safe_load``. ``load_yaml`` imports PyYAML only
when called, and raises naming it where it is absent. ``save_yaml`` writes
a config as ``yaml.safe_dump`` does (``config.yaml`` beside the controller's
checkpoints), and ``parse_yaml`` reads such a file back without PyYAML.
"""

from __future__ import annotations

import copy
import functools
import importlib
import json
import math
import re
from pathlib import Path
from typing import Any, Callable


class Config(dict):
    """A dict with attribute access, like a tiny OmegaConf."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_dict(d: dict) -> "Config":
        return _wrap(d)

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [_wrap(v) for v in obj]
    return obj


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unwrap(v) for v in obj]
    return obj


def load_yaml(path: str | Path) -> Config:
    """A YAML config file; needs PyYAML, which the port's own entry points
    do not (their defaults are Python data)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the YAML file {path} needs PyYAML, which is not installed; "
            "pass the settings as key=value overrides instead"
        ) from e
    with open(path) as f:
        return _wrap(yaml.safe_load(f) or {})


# -- YAML out, and back in without PyYAML -------------------------------------------

_PLAIN = re.compile(r"^[A-Za-z0-9_./$()~+][A-Za-z0-9_./${}()~+=, -]*$")


def _yaml_str(s: str) -> str:
    """A string as a YAML scalar that ``yaml.safe_load`` reads back as that
    string: plain where it is unambiguous, else single- or double-quoted."""
    if _PLAIN.match(s) and not s.endswith(" ") and _scalar(s) == s:
        return s
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    return json.dumps(s)  # JSON's escapes are YAML double-quoted escapes


def _yaml_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        # PyYAML's representer: YAML 1.1 floats need a '.' before the exponent
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        return _yaml_str(v)
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _yaml_block(v: Any, indent: int) -> list[str]:
    """Lines of a non-empty mapping or sequence, block style, as
    ``yaml.safe_dump`` lays them out (a sequence under a key not indented)."""
    pad = " " * indent
    lines = []
    if isinstance(v, dict):
        for k, x in v.items():
            key = _yaml_str(str(k))
            if isinstance(x, dict) and x:
                lines += [f"{pad}{key}:"] + _yaml_block(x, indent + 2)
            elif isinstance(x, (list, tuple)) and x:
                lines += [f"{pad}{key}:"] + _yaml_block(x, indent)
            else:
                lines.append(f"{pad}{key}: {_yaml_value(x)}")
        return lines
    for x in v:
        if isinstance(x, (dict, list, tuple)) and x:
            inner = _yaml_block(x, indent + 2)
            lines += [f"{pad}- {inner[0][indent + 2:]}"] + inner[1:]
        else:
            lines.append(f"{pad}- {_yaml_value(x)}")
    return lines


def _yaml_value(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _yaml_scalar(v)


def dump_yaml(data: Any) -> str:
    """``data`` (dicts, lists, str, int, float, bool, None) as block YAML."""
    data = _unwrap(data)
    if isinstance(data, (dict, list, tuple)) and data:
        return "\n".join(_yaml_block(data, 0)) + "\n"
    return _yaml_value(data) + "\n"


def save_yaml(cfg: Config | dict, path: str | Path) -> None:
    """Write ``cfg`` as YAML (what ``yaml.safe_dump(cfg, sort_keys=False)``
    writes, read back by ``yaml.safe_load`` or ``parse_yaml`` to the same
    dict)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(dump_yaml(cfg))


_KEY = re.compile(r"""^('(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^\s'"#\[\]{}-][^:#]*?|-[^\s:#][^:#]*?)"""
                  r"\s*:(?:\s+(.*)|)$")


def _one_value(text: str) -> Any:
    p = _Flow(text)
    value = p.value(False)
    p.ws()
    if p.i != len(p.s) and not p.s[p.i:].startswith("#"):
        raise ValueError(f"cannot read YAML value {text!r}")
    return value


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _yaml_node(lines: list[tuple[int, str]], i: int, indent: int) -> tuple[Any, int]:
    """The block node whose lines start at ``lines[i]``, at ``indent``;
    returns it and the index of the first line after it."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            rest = lines[i][1][1:].lstrip()
            if not rest:  # the item's node starts on the next line
                value, i = _yaml_node(lines, i + 1, lines[i + 1][0])
            elif _is_item(rest) or _KEY.match(rest):  # a node inline after "- "
                inner = indent + len(lines[i][1]) - len(rest)
                value, i = _yaml_node(lines[:i] + [(inner, rest)] + lines[i + 1:], i, inner)
            else:
                value, i = _one_value(rest), i + 1
            out.append(value)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        m = _KEY.match(lines[i][1])
        if not m:
            raise ValueError(f"cannot read YAML line {lines[i][1]!r}")
        key, rest = _one_value(m.group(1)), m.group(2)
        i += 1
        if rest is not None and not rest.startswith("#"):
            out[key] = _one_value(rest)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _yaml_node(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str) -> Any:
    """The port's own reader of block YAML as ``dump_yaml`` (and
    ``yaml.safe_dump``) writes it: nested block mappings and sequences of
    the scalars and flow collections ``parse_value`` reads; comments and
    blank lines skipped. Anchors, tags, multi-line scalars and several
    documents are not read."""
    lines = []
    for raw in text.splitlines():
        content = raw.strip()
        if content and not content.startswith("#") and content != "---":
            lines.append((len(raw) - len(raw.lstrip(" ")), content))
    if not lines:
        return None
    if len(lines) == 1 and not _is_item(lines[0][1]) and not _KEY.match(lines[0][1]):
        return _one_value(lines[0][1])
    value, i = _yaml_node(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"cannot read YAML from line {lines[i][1]!r}")
    return value


def merge(base: dict, override: dict) -> Config:
    """Deep merge; values in ``override`` win. Lists are replaced, not merged."""
    out = copy.deepcopy(_wrap(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(_wrap(v))
    return out


# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1) for plain scalars
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _sexagesimal(text: str, cast: Callable) -> Any:
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _scalar(text: str) -> Any:
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _sexagesimal(t, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t == ".nan":
            return float("nan")
        return _sexagesimal(t, float) if ":" in t else float(t)
    return text


class _Flow:
    """A parser for one YAML value on a line: a plain or quoted scalar, or a
    flow sequence / mapping of them."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        self.ws()
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c and c in "'\"":
            return self.quoted(c)
        return self.plain(in_flow)

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self.ws()
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "]":
                raise ValueError("expected , or ]")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self.ws()
            if self.s[self.i] != ":":
                raise ValueError("expected :")
            self.i += 1
            out[key] = self.value(True)
            self.ws()
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "}":
                raise ValueError("expected , or }")

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while True:
            c = self.s[self.i]
            self.i += 1
            if c == q:
                if q == "'" and self.s[self.i:self.i + 1] == "'":
                    out.append("'")
                    self.i += 1
                    continue
                return "".join(out)
            if c == "\\" and q == '"':
                esc = self.s[self.i]
                self.i += 1
                out.append({"n": "\n", "t": "\t", "\\": "\\", '"': '"', "0": "\0"}[esc])
                continue
            out.append(c)

    def plain(self, in_flow: bool) -> Any:
        start = self.i
        stops = ",[]{}" if in_flow else ""
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in stops or (c == ":" and in_flow and self.s[self.i + 1:self.i + 2] in (" ", "")):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if in_flow and text[:1] in ("-", "?", ":") and text[1:2] in ("", " "):
            raise ValueError(f"unsupported YAML token {text!r}")
        return _scalar(text)


def parse_value(text: str) -> Any:
    """A CLI override value with ``yaml.safe_load``'s result for it; text
    that is not one YAML value stays text."""
    block = re.match(r"^-\s+(.*)$|^([^\s:'\"\[{#][^:#]*?)\s*:\s+(.*)$", text.strip())
    if block:  # one block-sequence item or one block-mapping entry
        if block.group(1) is not None:
            return [parse_value(block.group(1))]
        return {_scalar(block.group(2)): parse_value(block.group(3))}
    try:
        p = _Flow(text)
        value = p.value(False)
        p.ws()
        if p.i != len(p.s) and not p.s[p.i:].lstrip().startswith("#"):
            return text
        return value
    except (ValueError, IndexError, KeyError):
        return text


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply hydra-style dotted overrides. ``+key=value`` adds new keys."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like key=value, got: {ov!r}")
        key, _, raw = ov.partition("=")
        additive = key.startswith("+")
        key = key.lstrip("+~")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node:
                if not additive:
                    raise KeyError(f"Unknown config key {key!r} (use +{key} to add)")
                node[p] = Config()
            node = node[p]
        leaf = parts[-1]
        if leaf not in node and not additive:
            raise KeyError(f"Unknown config key {key!r} (use +{key} to add)")
        node[leaf] = _wrap(parse_value(raw))
    return cfg


_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _lookup(root: dict, dotted: str) -> Any:
    node: Any = root
    for p in dotted.split("."):
        node = node[p]
    return node


def resolve(cfg: Config) -> Config:
    """Resolve ``${a.b}`` interpolations against the config root."""
    root = copy.deepcopy(cfg)

    def _resolve_value(v: Any, depth: int = 0) -> Any:
        if depth > 16:
            raise ValueError("Interpolation recursion limit exceeded")
        if isinstance(v, str):
            full = _INTERP_RE.fullmatch(v.strip())
            if full:  # whole-string interpolation preserves type
                return _resolve_value(_lookup(root, full.group(1)), depth + 1)
            return _INTERP_RE.sub(
                lambda m: str(_resolve_value(_lookup(root, m.group(1)), depth + 1)), v
            )
        return v

    def _walk(node: Any) -> Any:
        if isinstance(node, dict):
            return Config({k: _walk(v) for k, v in node.items()})
        if isinstance(node, list):
            return [_walk(v) for v in node]
        return _resolve_value(node)

    return _walk(root)


def build_config(defaults: dict, overrides: list[str] | None = None) -> Config:
    """Defaults (Python data), then CLI overrides, then interpolation."""
    cfg = _wrap(copy.deepcopy(defaults))
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve(cfg)


def import_object(target: str) -> Any:
    """Import ``genima_torch.module.Object``. A target outside the port is
    refused: a config written for the JAX package would otherwise import it."""
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ must be fully qualified, got {target!r}")
    if module_name.split(".")[0] != "genima_torch":
        raise ValueError(f"_target_ {target!r} is outside genima_torch; the port "
                         "instantiates only its own classes")
    return getattr(importlib.import_module(module_name), attr)


def instantiate(cfg: dict, *args: Any, **kwargs: Any) -> Any:
    """Instantiate an object from a ``_target_`` config node (hydra's
    ``instantiate``); ``_partial_: true`` returns a ``functools.partial``."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        raise ValueError(f"instantiate() needs a dict with _target_, got {cfg!r}")
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    partial = cfg.pop("_partial_", False)
    cls: Callable = import_object(target)
    call_kwargs = {k: _unwrap_preserving_targets(v) for k, v in cfg.items()}
    call_kwargs.update(kwargs)
    if partial:
        return functools.partial(cls, *args, **call_kwargs)
    return cls(*args, **call_kwargs)


def _unwrap_preserving_targets(v: Any) -> Any:
    """Recursively instantiate nested ``_target_`` nodes."""
    if isinstance(v, dict):
        if "_target_" in v:
            return instantiate(v)
        return Config({k: _unwrap_preserving_targets(x) for k, x in v.items()})
    if isinstance(v, list):
        return [_unwrap_preserving_targets(x) for x in v]
    return v


def parse_cli(argv: list[str]) -> tuple[list[str], dict]:
    """Split argv into hydra-style overrides and flags (``--config-path`` /
    ``--config-name`` with their values, other ``--flag``s as True)."""
    overrides: list[str] = []
    flags: dict = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--config-path", "--config-name", "-cp", "-cn"):
            key = "config_path" if a in ("--config-path", "-cp") else "config_name"
            flags[key] = argv[i + 1]
            i += 2
        elif a.startswith("--"):
            flags[a.lstrip("-").replace("-", "_")] = True
            i += 1
        else:
            overrides.append(a)
            i += 1
    return overrides, flags


# ``genima_tpu/cfgs/render.yaml`` (the reference's render/cfgs/render.yaml)
# as Python data, in the file's key order: the defaults of
# ``python -m genima_torch.cli.render_data``
RENDER = {
    "dataset_root": "/tmp/",
    "save_path": None,
    "textures_path": "./textures",
    "cameras": ["wrist", "front", "right_shoulder", "left_shoulder", "overhead"],
    "camera_scales": [3.0, 8.0, 6.5, 6.5, 6.5],
    "task": "take_lid_off_saucepan",
    "episodes": 100,
    "episode_offset": 0,
    "variation": 0,
    "num_processes": 1,
    "image_width": 256,
    "image_height": 256,
    "znear": 1e-05,
    "zfar": 3.0,
    "action_horizon": 20,
    "alpha_blend": 0.7,
    "seed": 0,
    "render": {
        "sphere": {"radius": 0.01},
        "joints": {
            "wrist": [1, 3, 5],
            "front": [1, 3, 5],
            "right_shoulder": [1, 3, 5],
            "left_shoulder": [1, 3, 5],
            "overhead": [],
        },
    },
    "draw": {"rgb_rendered": True, "rnd_bg": True},
}
