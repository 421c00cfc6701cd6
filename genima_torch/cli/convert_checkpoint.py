"""Convert published torch checkpoints into the reference's msgpack trees,
and a ControlNet tree back into a diffusers file:

    python -m genima_torch.cli.convert_checkpoint sd_base --src /path/sd-turbo --dst /out/sd
    python -m genima_torch.cli.convert_checkpoint controlnet \\
        --src /path/checkpoint-15000/controlnet --dst /out/controlnet
    python -m genima_torch.cli.convert_checkpoint export_controlnet \\
        --src /out/controlnet --dst /out/controlnet_diffusers

Counterpart of ``genima_tpu/cli/convert_checkpoint.py``, with its seven
kinds:

* ``sd_base`` / ``sdxl_base``: a diffusers snapshot (``unet/``, ``vae/``,
  ``text_encoder/`` [, ``text_encoder_2/``]) -> ``<dst>/<model>/params.msgpack``
  for every model the snapshot holds;
* ``controlnet``: a diffusers or native ControlNet directory ->
  ``<dst>/params.msgpack``;
* ``export_controlnet``: ``<src>/params.msgpack`` ->
  ``<dst>/diffusion_pytorch_model.safetensors`` in diffusers names;
* ``clip_vit_b32``: an OpenAI CLIP file -> its text tower's tree;
* ``resnet18``: a torchvision ``resnet18`` file -> the trunk's tree (``fc``
  dropped);
* ``taesd``: upstream taesd files (a directory of ``taesd_encoder`` /
  ``taesd_decoder``, a merged dict, or a diffusers ``AutoencoderTiny``
  file) -> the tiny VAE's tree.

Each source loads into the port's own modules (f32, on the CPU) and the
trees are written with ``weights/to_jax.py::tree_from_module`` and
``core/checkpoint.py::save_pytree``, so both packages read them; a leaf
keeps the float dtype its tensor had in the file (fp16 stays fp16), as
the JAX converter keeps it. The
functions' configuration arguments (``pipe``, ``unet_cfg``, ``text_cfg``,
widths) take smaller models (the tests' tiny ones); the CLI converts the
published ones.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.weights.to_jax import flax_paths, tree_from_module

KINDS = ("sd_base", "sdxl_base", "controlnet", "export_controlnet", "clip_vit_b32",
         "resnet18", "taesd")
CPU = torch.device("cpu")


def _write(module, family: str, path: Path, source: Optional[dict] = None) -> None:
    """``module``'s tree to ``path``; with ``source`` (the file's tensors
    under the module's names), each float leaf in its tensor's dtype."""
    tree = tree_from_module(module, family)
    for key, fpath in (flax_paths(module, family).items() if source else ()):
        src = source.get(key)
        if src is not None and src.dtype in (torch.float16, torch.float64):
            node = tree
            for token in fpath[:-1]:
                node = node[token]
            node[fpath[-1]] = node[fpath[-1]].astype(torch.empty((), dtype=src.dtype).numpy().dtype)
    ckpt.save_pytree(tree, path)
    print(f"wrote {path}")


def _load_submodel(path: Path, module, family: str) -> Optional[dict]:
    """``module`` from the submodel directory ``path``: the file's tensors
    (None for a native tree, which loads as it is); raises without one."""
    from genima_torch.weights.load_pretrained import (
        WEIGHT_FILES, load_state_dict_strict, load_submodel, load_torch_file,
    )

    weights = next((path / f for f in WEIGHT_FILES if (path / f).exists()), None)
    if (path / "params.msgpack").exists() or weights is None:
        if load_submodel(path, module, family) is None:
            raise FileNotFoundError(f"no weights found under {path}")
        return None
    sd = load_torch_file(weights)
    load_state_dict_strict(module, sd)
    return sd


def convert_sd_base(src: Path, dst: Path, sdxl: bool = False, pipe=None) -> dict:
    """Every model of the snapshot ``src`` holds -> ``<dst>/<model>/params.msgpack``
    (a model the snapshot lacks is left out: there is nothing to convert).
    ``pipe`` picks the configuration (default: sd-turbo's or sdxl-turbo's)."""
    from genima_torch.diffusion.pipeline import SDControlNetPipeline, SDXLControlNetPipeline
    from genima_torch.weights.load_pretrained import MODEL_FAMILIES

    if pipe is None:
        pipe = (SDXLControlNetPipeline if sdxl else SDControlNetPipeline)(
            dtype=torch.float32, device=CPU, backend="xla", vae_encoder=True)
    report = {}
    for name, module in pipe._build().items():
        sub = Path(src) / name
        if not sub.is_dir():
            report[name] = "missing"
            continue
        try:
            source = _load_submodel(sub, module, MODEL_FAMILIES[name])
        except FileNotFoundError:
            report[name] = "no-weights-file"
            continue
        report[name] = "native" if source is None else "diffusers"
        _write(module, MODEL_FAMILIES[name], dst / name / "params.msgpack", source)
    print(f"loaded: {report}")
    return report


def convert_controlnet(src: Path, dst: Path, unet_cfg=None,
                       cond_channels: tuple = (16, 32, 96, 256)) -> None:
    """A ControlNet directory (diffusers or native) -> ``<dst>/params.msgpack``;
    ``unet_cfg`` and ``cond_channels`` its configuration (default sd-turbo's)."""
    from genima_torch.nn.controlnet import ControlNetModel
    from genima_torch.nn.unet import UNetConfig
    from genima_torch.weights.init import build_module

    cfg = unet_cfg or UNetConfig.sd21()
    cn = build_module(lambda: ControlNetModel(cfg, cond_channels, "xla"), CPU, torch.float32)
    source = _load_submodel(Path(src), cn, "diffusers_controlnet")
    _write(cn, "diffusers_controlnet", dst / "params.msgpack", source)


def export_controlnet(src: Path, dst: Path) -> None:
    """``<src>/params.msgpack`` -> ``<dst>/diffusion_pytorch_model.safetensors``
    in diffusers names and layouts."""
    from genima_torch.weights.from_jax import state_dict_from_jax
    from genima_torch.weights.load_pretrained import save_safetensors

    sd = state_dict_from_jax(ckpt.load_pytree(src / "params.msgpack"), "diffusers_controlnet")
    out = dst / "diffusion_pytorch_model.safetensors"
    save_safetensors(sd, out)
    print(f"wrote {out}")


def convert_clip(src: Path, dst: Path, text_cfg=None) -> None:
    """An OpenAI CLIP file -> the text tower's tree (``text_cfg`` default ViT-B/32)."""
    from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
    from genima_torch.weights.init import build_module
    from genima_torch.weights.load_pretrained import load_state_dict_strict
    from genima_torch.weights.openai_clip import openai_clip_text_state_dict

    cfg = text_cfg or CLIPTextConfig.vit_b_32()
    clip = build_module(lambda: CLIPTextModel(cfg), CPU, torch.float32)
    sd = torch.load(str(src), map_location="cpu", weights_only=True)
    sd = openai_clip_text_state_dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    load_state_dict_strict(clip, sd)
    _write(clip, "hf_clip", dst / "params.msgpack", sd)


def convert_resnet(src: Path, dst: Path, width: int = 64) -> None:
    """A torchvision ``resnet18`` file -> the trunk's tree (``fc`` dropped);
    every trunk tensor must be in the file."""
    from genima_torch.nn.resnet import ResNet18
    from genima_torch.weights.init import build_module
    from genima_torch.weights.load_pretrained import load_torch_file, load_torchvision_resnet

    net = build_module(lambda: ResNet18(width), CPU, torch.float32)
    loaded = load_torchvision_resnet(net, src)
    missing = sorted(set(net.state_dict()) - set(loaded))
    if missing:
        raise KeyError(f"{src} lacks resnet18 tensors: {missing[:4]}")
    _write(net, "torchvision_resnet", dst / "params.msgpack", load_torch_file(src))


def convert_taesd(src: Path, dst: Path, n_levels: int = 3, blocks_per_level: int = 3,
                  width: int = 64) -> None:
    """Upstream taesd (a directory of its two files, a merged dict, or a
    diffusers ``AutoencoderTiny`` file) -> the tiny VAE's tree."""
    from genima_torch.nn.vae import AutoencoderTiny
    from genima_torch.weights.init import build_module
    from genima_torch.weights.load_pretrained import (
        load_state_dict_strict, read_taesd, taesd_state_dict,
    )

    tiny = build_module(lambda: AutoencoderTiny(width=width, n_levels=n_levels,
                                                blocks_per_level=blocks_per_level),
                        CPU, torch.float32)
    sd = taesd_state_dict(tiny, read_taesd(src))
    load_state_dict_strict(tiny, sd)
    _write(tiny, "tiny_vae", dst / "params.msgpack", sd)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=KINDS)
    p.add_argument("--src", type=Path, required=True)
    p.add_argument("--dst", type=Path, required=True)
    args = p.parse_args(argv)
    if args.kind in ("sd_base", "sdxl_base"):
        convert_sd_base(args.src, args.dst, sdxl=args.kind == "sdxl_base")
    elif args.kind == "controlnet":
        convert_controlnet(args.src, args.dst)
    elif args.kind == "export_controlnet":
        export_controlnet(args.src, args.dst)
    elif args.kind == "clip_vit_b32":
        convert_clip(args.src, args.dst)
    elif args.kind == "resnet18":
        convert_resnet(args.src, args.dst)
    else:
        convert_taesd(args.src, args.dst)


if __name__ == "__main__":
    main()
