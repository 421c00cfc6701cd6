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
files with ``torch.load(weights_only=True)``.
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
    "I64": torch.int64, "I32": torch.int32,
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
