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
when called, and raises naming it where it is absent.
"""

from __future__ import annotations

import copy
import functools
import importlib
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
