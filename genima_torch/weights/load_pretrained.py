"""Pretrained weights from local files: the base models into the pipeline's
modules, and a torchvision ResNet-18 into the ACT controller's backbone.

Counterpart of ``genima_tpu/weights/load_pretrained.py`` and of
``load_torch_file`` in ``genima_tpu/weights/torch_port.py``. For each model
of the pipeline, ``<dir>/<name>/`` (``unet/``, ``vae/``, ``text_encoder/``,
``controlnet/``, and SDXL's ``text_encoder_2/``: the HF hub layout of
``stabilityai/sd-turbo`` and ``stabilityai/sdxl-turbo``) gives the
first that exists of:

* ``params.msgpack``: the reference's flax tree, through the port's codec
  and naming rules (``state_dict_from_jax``);
* ``diffusion_pytorch_model.safetensors``, ``model.safetensors``,
  ``diffusion_pytorch_model.bin`` or ``pytorch_model.bin``: a diffusers /
  HF state dict, which loads into the module as it is, since the port's
  module names are the diffusers and HF-CLIP names.

Loading is strict: a missing, extra or misshapen tensor raises (the
``num_batches_tracked`` and ``position_ids`` buffers torch checkpoints carry
are dropped, as the JAX package drops them). The report says per model
``native``, ``diffusers``, ``missing`` (no directory) or ``no-weights-file``.

``load_torch_file`` reads safetensors itself (an 8-byte little-endian
header length, a JSON header, then raw little-endian buffers) and ``.bin``
files with ``torch.load(weights_only=True)``; ``save_safetensors`` writes
that layout (no ``safetensors`` package on the card's machine).

``load_taesd`` loads upstream taesd weights (madebyollin's ``taesd.py``
Sequential indices, ``taesd_encoder.pth`` / ``taesd_decoder.pth``, a
merged ``encoder.`` / ``decoder.`` dict, or a diffusers ``AutoencoderTiny``
file's ``encoder.layers.`` / ``decoder.layers.`` names) into the port's
``AutoencoderTiny``, the rule of ``genima_tpu/weights/torch_port.py::
load_taesd``; ``read_taesd`` gathers such a dict from a directory or a file.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import torch
from torch import nn

from genima_torch.core import checkpoint as ckpt
from genima_torch.weights.from_jax import load_from_jax

FAMILIES = {
    "unet": "diffusers_unet",
    "controlnet": "diffusers_controlnet",
    "vae": "diffusers_vae",
    "text_encoder": "hf_clip",
}
# every pipeline model's: SDXL adds a second prompt encoder (text_encoder_2/),
# ``use_tiny_vae`` the taesd decoder (tiny_vae/, as ``save_base_model`` writes it)
MODEL_FAMILIES = {**FAMILIES, "text_encoder_2": "hf_clip", "tiny_vae": "tiny_vae"}
WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.bin",
)
SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8,
}


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> CPU tensors (each its own aligned copy)."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack_from("<Q", data, 0)
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes past the end of the file")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != count * itemsize or not 0 <= start <= end <= len(body):
            raise ValueError(f"{path}: tensor {name} has offsets {start}..{end} for {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            buf = bytearray(body[start:end])
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
    return out


def save_safetensors(tensors: dict, path: str | Path) -> None:
    """Write ``tensors`` (name -> tensor or numpy array) as a ``.safetensors``
    file: the header padded with spaces to a multiple of 8 bytes, then each
    tensor's little-endian bytes, in name order."""
    codes = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        if t.dtype not in codes:
            raise ValueError(f"tensor {name} has unsupported dtype {t.dtype}")
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_torch_file(path: str | Path) -> dict[str, torch.Tensor]:
    """``.safetensors`` or a torch ``.bin`` / ``.pt`` state dict -> CPU tensors."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def load_state_dict_strict(module: nn.Module, sd: dict[str, torch.Tensor]) -> nn.Module:
    """Load a torch-layout state dict into ``module`` on its device, each
    tensor in the module's dtype; anything missing, extra or misshapen raises."""
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked") and "position_ids" not in k}
    target = module.state_dict()
    module.load_state_dict({k: v.to(target[k].device, target[k].dtype) if k in target else v
                            for k, v in sd.items()}, strict=True)
    return module


def load_submodel(path: Path, module: nn.Module, family: str) -> str | None:
    """Load ``module`` from the submodel directory ``path``; returns the
    layout found, or None when it holds no weights file."""
    native = path / "params.msgpack"
    if native.exists():
        load_from_jax(module, ckpt.load_pytree(native), family)
        return "native"
    for fname in WEIGHT_FILES:
        f = path / fname
        if f.exists():
            load_state_dict_strict(module, load_torch_file(f))
            return "diffusers"
    return None


def load_pretrained_pipeline(base_dir: str | Path, params: dict[str, nn.Module]) -> dict:
    """Fill the modules of ``params`` from ``base_dir`` in place; returns
    the report."""
    base_dir = Path(base_dir)
    report = {}
    for name, module in params.items():
        family = MODEL_FAMILIES.get(name)
        if family is None:
            continue
        sub = base_dir / name
        if not sub.is_dir():
            report[name] = "missing"
            continue
        report[name] = load_submodel(sub, module, family) or "no-weights-file"
    return report


def load_torchvision_resnet(backbone: nn.Module, path: str | Path) -> list[str]:
    """A torchvision ``resnet18`` state dict into the ACT's ResNet backbone,
    not strictly, as the JAX package loads it: ``fc.*`` and every tensor the
    backbone lacks are dropped, the backbone's tensors the file lacks (FiLM)
    keep their values; a tensor of another shape raises. Returns the names
    loaded."""
    target = backbone.state_dict()
    sd = {k: v for k, v in load_torch_file(path).items()
          if k in target and not k.startswith("fc.")}
    bad = [k for k, v in sd.items() if tuple(v.shape) != tuple(target[k].shape)]
    if bad:
        raise ValueError(f"{path}: misshapen tensors for the backbone: {bad[:4]}")
    backbone.load_state_dict({k: v.to(target[k].device, target[k].dtype) for k, v in sd.items()},
                             strict=False)
    return sorted(sd)


# -- taesd (AutoencoderTiny): the upstream Sequential-index layout ------------------


def taesd_key(tower: str, name: str, n_levels: int = 3, blocks_per_level: int = 3) -> str:
    """A parameter of one ``AutoencoderTiny`` tower (its name in the tower,
    e.g. ``block_0_1.conv_2.weight``) -> the upstream Sequential key:

    * encoder: ``[conv, Block, (conv_s2, Block * b) * L, conv]``;
    * decoder: ``[Clamp, conv, ReLU, (Block * b, Upsample, conv) * L, Block, conv]``;
    * a Block's ``conv = Sequential(conv, ReLU, conv, ReLU, conv)`` (``conv.0/2/4``)
      and its optional 1x1 ``skip``.
    """
    first, *rest = name.split(".")
    span = blocks_per_level + (1 if tower == "encoder" else 2)
    if tower == "encoder":
        if first == "conv_in":
            idx = 0
        elif first == "block_in":
            idx = 1
        elif first.startswith("down_"):
            idx = 2 + int(first[5:]) * span
        elif first.startswith("block_"):
            lvl, b = map(int, first[6:].split("_"))
            idx = 2 + lvl * span + 1 + b
        elif first == "conv_out":
            idx = 2 + n_levels * span
        else:
            raise KeyError(name)
    else:
        if first == "conv_in":
            idx = 1  # 0 is the parameterless clamp
        elif first.startswith("block_") and first != "block_out":
            lvl, b = map(int, first[6:].split("_"))
            idx = 3 + lvl * span + b
        elif first.startswith("up_"):
            idx = 3 + int(first[3:]) * span + blocks_per_level + 1
        elif first == "block_out":
            idx = 3 + n_levels * span
        elif first == "conv_out":
            idx = 3 + n_levels * span + 1
        else:
            raise KeyError(name)
    parts = [str(idx)]
    for token in rest[:-1]:
        parts += ["conv", token[5:]] if token.startswith("conv_") else [token]
    return ".".join([*parts, rest[-1]])


def taesd_state_dict(tiny: nn.Module, state_dict: dict) -> dict:
    """Upstream taesd weights (any of the three layouts) under ``tiny``'s own
    names (an ``AutoencoderTiny``), as the file holds them; every one of its
    tensors must be found, as in the JAX loader."""
    towers: dict[str, dict] = {"encoder": {}, "decoder": {}}
    for k, v in state_dict.items():
        for tower in towers:
            pref = next((p for p in (f"{tower}.layers.", f"{tower}.") if k.startswith(p)), None)
            if pref is not None:
                towers[tower][k[len(pref):]] = v
                break
    sd = {}
    for key in tiny.state_dict():
        tower, name = key.split(".", 1)
        enc = getattr(tiny, tower)
        up = taesd_key(tower, name, enc.n_levels, enc.blocks_per_level)
        if up not in towers[tower]:
            raise KeyError(f"missing taesd tensor {tower}.{up} for {key}")
        sd[key] = torch.as_tensor(towers[tower][up])
    return sd


def load_taesd(tiny: nn.Module, state_dict: dict) -> nn.Module:
    """Load upstream taesd weights (any of the three layouts) into ``tiny``
    (an ``AutoencoderTiny``) in place (``taesd_state_dict``)."""
    return load_state_dict_strict(tiny, taesd_state_dict(tiny, state_dict))


def read_taesd(src: str | Path) -> dict:
    """An upstream taesd state dict from ``src``: a directory holding the
    ``*encoder*`` and ``*decoder*`` files (``.pt``/``.pth`` or
    ``.safetensors``; their keys are prefixed with the tower), or one file
    (a merged or a diffusers dict)."""
    src = Path(src)
    if not src.is_dir():
        return load_torch_file(src)
    sd = {}
    for tower in ("encoder", "decoder"):
        f = next(iter(sorted(src.glob(f"*{tower}*.pt*"))), None) or next(
            iter(sorted(src.glob(f"*{tower}*.safetensors"))), None)
        if f is None:
            raise FileNotFoundError(f"no taesd_{tower} file under {src}")
        sd.update({f"{tower}.{k}": v for k, v in load_torch_file(f).items()})
    return sd
