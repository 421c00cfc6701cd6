"""The Genima ACT controller agent at inference: CLIP language, ImageNet
normalisation, multi-view ResNet-18 and the DETR-VAE actor.

Counterpart of the inference half of ``GenimaACTAgent`` in
``genima_tpu/control/policy.py`` (``encode_lang``, ``_act_impl``, ``act``).
Its params are ``{"encoder": ImageEncoderACT, "actor": GenimaACTModel}``
plus the frozen CLIP text tower, kept apart as in the reference.
``build_agent`` makes the agent a saved train config describes
(``genima_tpu/cli/train_act.py::build_agent``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from genima_torch import default_dtype, resolve_device
from genima_torch.nn.act import TRAIN_ONLY_SUBTREES, ACTConfig, GenimaACTModel
from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.resnet import ImageEncoderACT
from genima_torch.weights.from_jax import drop_subtrees, load_from_jax
from genima_torch.weights.init import build_module, init_random_

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(eq=False)
class GenimaACTAgent:
    act_cfg: ACTConfig = dataclasses.field(default_factory=ACTConfig)
    clip_cfg: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig.vit_b_32)
    resnet_width: int = 64
    resnet_small_inputs: bool = False
    # frames stacked per observation: qpos is (B, state_dim * frame_stack)
    frame_stack: int = 1
    dtype: Optional[torch.dtype] = None  # bf16 on the card, f32 on the CPU
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dtype is None:
            self.dtype = default_dtype(self.device)
        # the CLIP projection feeds FiLM and the task token: its width
        # follows act_cfg.lang_dim
        if self.clip_cfg.projection_dim != self.act_cfg.lang_dim:
            self.clip_cfg = dataclasses.replace(
                self.clip_cfg, projection_dim=self.act_cfg.lang_dim
            )
        self.clip_params: Optional[CLIPTextModel] = None

    def _build_params(self) -> dict[str, nn.Module]:
        c = self.act_cfg
        encoder = build_module(
            lambda: ImageEncoderACT(
                c.hidden_dim, c.use_lang_cond, self.resnet_width,
                self.resnet_small_inputs, c.lang_dim,
            ),
            self.device, self.dtype,
        )
        actor_cfg = dataclasses.replace(c, state_dim=c.state_dim * self.frame_stack)
        actor = build_module(lambda: GenimaACTModel(actor_cfg), self.device, self.dtype)
        return {"encoder": encoder, "actor": actor}

    def _build_clip(self) -> CLIPTextModel:
        return build_module(lambda: CLIPTextModel(self.clip_cfg), self.device, self.dtype)

    def init_params(self, generator: torch.Generator):
        """(agent params, frozen clip) with seeded scaled-normal weights; the
        clip tower also becomes the one ``act`` uses."""
        params, clip = self._build_params(), self._build_clip()
        for m in (*params.values(), clip):
            init_random_(m, generator)
        self.clip_params = clip
        return params, clip

    def params_from_jax(self, params_tree: dict, clip_tree: dict):
        """(agent params, clip) loaded from the reference's trees; the clip
        tower also becomes the one ``act`` uses."""
        params, clip = self.load_params(params_tree), self._build_clip()
        load_from_jax(clip, clip_tree, "hf_clip")
        self.clip_params = clip
        return params, clip

    def load_params(self, params_tree: dict) -> dict[str, nn.Module]:
        """The agent params from a reference ``{"encoder", "actor"}`` tree (a
        controller checkpoint's ``agent``); the actor drops its
        training-only style-encoder subtrees. The clip tower is not touched."""
        params = self._build_params()
        load_from_jax(params["encoder"], params_tree["encoder"], "torchvision_resnet")
        load_from_jax(
            params["actor"], drop_subtrees(params_tree["actor"], TRAIN_ONLY_SUBTREES),
            "act",
        )
        return params

    def encode_lang(self, clip_params: CLIPTextModel, lang_tokens) -> torch.Tensor:
        """(B, 77) -> (B, lang_dim) projected EOT feature, f32."""
        ids = torch.as_tensor(lang_tokens, dtype=torch.long, device=self.device)
        out = clip_params(ids)
        emb = out.text_embeds if out.text_embeds is not None else out.pooled_output
        return emb.float()

    @torch.inference_mode()
    def _act_impl(self, params, clip_params, images, qpos, lang_tokens) -> torch.Tensor:
        """images: (B, V, H, W, 3) float in [0, 255]; qpos: (B, state_dim*fs)."""
        lang = self.encode_lang(clip_params, lang_tokens)
        x = images.to(self.device, torch.float32) / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        x = ((x - mean) / std).permute(0, 1, 4, 2, 3)  # (B, V, 3, H, W)
        tokens, pos = params["encoder"](x.to(self.dtype), lang)
        qpos = torch.as_tensor(qpos, dtype=torch.float32, device=self.device)
        return params["actor"](tokens, pos, qpos, task_emb=lang).actions

    def act(self, params, images, qpos, lang_tokens) -> torch.Tensor:
        """The (B, num_queries, action_dim) action chunk."""
        return self._act_impl(params, self.clip_params, images, qpos, lang_tokens)


# train-config keys of the reference agent and ACTConfig that only its
# training half reads (optimizer, augmentation, dropout, the CVAE loss) or
# that only shaped its flax init's dummy images (views, image size)
_TRAIN_ONLY_METHOD_KEYS = ("lr", "lr_backbone", "weight_decay", "actor_grad_clip",
                           "data_augmentation", "num_views", "image_size")
_TRAIN_ONLY_ACT_KEYS = ("dropout", "kl_weight")


def build_agent(cfg: dict, device: Any = "cuda") -> GenimaACTAgent:
    """The controller agent of a saved train config (its ``method`` node):
    ``use_onehot_time`` widens ``state_dim`` by the episode length, as the
    OnehotTime wrapper widened ``low_dim_state``."""
    method = dict(cfg["method"])
    method.pop("_target_", None)
    act_kwargs = {k: v for k, v in method.pop("act_cfg").items()
                  if k not in _TRAIN_ONLY_ACT_KEYS}
    if cfg.get("use_onehot_time", False):
        act_kwargs["state_dim"] = int(act_kwargs.get("state_dim", 8)) + int(
            cfg["env"].get("episode_length", 200))
    kwargs = {k: v for k, v in method.items() if k not in _TRAIN_ONLY_METHOD_KEYS}
    return GenimaACTAgent(act_cfg=ACTConfig(**act_kwargs), device=device, **kwargs)
