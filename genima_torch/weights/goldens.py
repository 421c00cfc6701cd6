"""Golden-activation fixtures for the three diffusion models.

Counterpart of ``genima_tpu/weights/goldens.py``, with the same tiny
configurations, inputs and npz schema (``meta/source``,
``sd/<model>/<torch key>``, ``out/<name>``), so a fixture written by either
package is read by the other:

* ``scripts/make_diffusers_goldens.py`` (run where ``diffusers`` is
  installed) writes ``tests/fixtures/diffusers_goldens.npz`` from the real
  diffusers models;
* ``make_self_goldens`` writes the same schema from the port's own seeded
  models: the stand-in that proves the harness (schema, names, forwards,
  tolerances) until the real fixture is in the repository.

``run_ours`` loads the saved state dicts, which are in diffusers names and
torch layouts already, straight into the port's modules (no conversion)
and runs the golden forwards on the CPU in f32, NCHW as the fixture stores
them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

GOLDENS_PATH = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "diffusers_goldens.npz"

CONDITIONING_SCALE = 0.7
CN_COND_CHANNELS = (8, 16)

# ours -> UNetConfig kwargs; diffusers -> UNet2DConditionModel kwargs (its
# ``attention_head_dim`` holds the head count for SD-family configs)
TINY_UNET = {
    "ours": dict(
        sample_size=8,
        block_out_channels=(32, 64),
        down_block_has_attn=(True, False),
        layers_per_block=1,
        num_heads=(2, 2),
        transformer_layers_per_block=(1, 1),
        cross_attention_dim=32,
    ),
    "diffusers": dict(
        sample_size=8,
        in_channels=4,
        out_channels=4,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        block_out_channels=(32, 64),
        layers_per_block=1,
        attention_head_dim=(2, 2),
        cross_attention_dim=32,
        use_linear_projection=True,
        norm_num_groups=32,
    ),
}

TINY_VAE = {
    "ours": dict(block_out_channels=(32, 32), layers_per_block=1),
    "diffusers": dict(
        in_channels=3,
        out_channels=3,
        latent_channels=4,
        down_block_types=("DownEncoderBlock2D", "DownEncoderBlock2D"),
        up_block_types=("UpDecoderBlock2D", "UpDecoderBlock2D"),
        block_out_channels=(32, 32),
        layers_per_block=1,
        norm_num_groups=32,
    ),
}

def golden_inputs() -> dict:
    """Fixed forward inputs, stored NCHW (the torch layout) on disk."""
    rng = np.random.RandomState(0)
    return {
        "sample": rng.randn(2, 4, 8, 8).astype(np.float32),
        "t": np.array([999.0, 17.0], np.float32),
        "ctx": rng.randn(2, 4, 32).astype(np.float32),
        "cond": rng.rand(2, 3, 16, 16).astype(np.float32),
        "image": (rng.rand(2, 3, 16, 16) * 2.0 - 1.0).astype(np.float32),
        "latents": rng.randn(2, 4, 8, 8).astype(np.float32),
    }


def save_goldens(path, source: str, state_dicts: dict, outputs: dict) -> None:
    """Flat npz: ``meta/source``, ``sd/<model>/<torch key>``, ``out/<name>``.
    ``state_dicts`` maps model -> torch-layout state dict; ``outputs`` maps
    output name -> NCHW array."""
    flat = {"meta/source": np.str_(source)}
    for model, sd in state_dicts.items():
        for k, v in sd.items():
            flat[f"sd/{model}/{k}"] = np.asarray(v)
    for k, v in outputs.items():
        flat[f"out/{k}"] = np.asarray(v)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def load_goldens(path) -> tuple[str, dict, dict]:
    """Inverse of ``save_goldens``."""
    with np.load(path) as z:
        source = str(z["meta/source"])
        sds: dict = {}
        outs: dict = {}
        for k in z.files:
            if k.startswith("sd/"):
                _, model, torch_key = k.split("/", 2)
                sds.setdefault(model, {})[torch_key] = z[k]
            elif k.startswith("out/"):
                outs[k[4:]] = z[k]
    return source, sds, outs


def build_ours() -> dict:
    """The three tiny models on the CPU in f32, uninitialised."""
    from genima_torch.nn.controlnet import ControlNetModel
    from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
    from genima_torch.nn.vae import AutoencoderKL, VAEConfig
    from genima_torch.weights.init import build_module

    cpu, f32 = torch.device("cpu"), torch.float32
    # sample_size sizes the reference's init only
    ucfg = UNetConfig(**{k: v for k, v in TINY_UNET["ours"].items() if k != "sample_size"})
    return {
        "unet": build_module(lambda: UNet2DConditionModel(ucfg, "xla"), cpu, f32),
        "controlnet": build_module(lambda: ControlNetModel(ucfg, CN_COND_CHANNELS, "xla"),
                                   cpu, f32),
        "vae": build_module(lambda: AutoencoderKL(VAEConfig(**TINY_VAE["ours"]), encoder=True),
                            cpu, f32),
    }


@torch.no_grad()
def run_ours(state_dicts: dict) -> dict:
    """Load the torch-layout ``state_dicts`` into the tiny models and run the
    golden forwards; outputs in NCHW (the on-disk layout)."""
    from genima_torch.weights.load_pretrained import load_state_dict_strict

    models = build_ours()
    for name, module in models.items():
        load_state_dict_strict(module, {k: torch.as_tensor(np.asarray(v))
                                        for k, v in state_dicts[name].items()})
    unet, cn, vae = models["unet"], models["controlnet"], models["vae"]
    x = {k: torch.from_numpy(v) for k, v in golden_inputs().items()}
    eps_plain = unet(x["sample"], x["t"], x["ctx"])
    down, mid = cn(x["sample"], x["t"], x["ctx"], x["cond"],
                   conditioning_scale=CONDITIONING_SCALE)
    eps_injected = unet(x["sample"], x["t"], x["ctx"], down_block_additional_residuals=down,
                        mid_block_additional_residual=mid)
    dist = vae.encode(x["image"])
    outs = {
        "unet_eps": eps_plain,
        "controlnet_mid": mid,
        "combined_eps": eps_injected,
        "vae_mean": dist.mean,
        "vae_std": torch.exp(0.5 * dist.logvar),
        "vae_decoded": vae.decode(x["latents"]),
    }
    for i, d in enumerate(down):
        outs[f"controlnet_down{i}"] = d
    return {k: v.float().numpy() for k, v in outs.items()}


def make_self_goldens(path, seed: int = 0) -> None:
    """Write a fixture from the port's own seeded models through the schema
    the diffusers script writes (the harness-validation stand-in)."""
    from genima_torch.weights.init import init_random_

    gen = torch.Generator().manual_seed(seed)
    sds = {name: {k: v.numpy() for k, v in init_random_(m, gen).state_dict().items()}
           for name, m in build_ours().items()}
    save_goldens(path, "self", sds, run_ours(sds))
