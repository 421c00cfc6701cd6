"""The Genima ACT controller agent: CLIP language, ImageNet normalisation,
multi-view ResNet-18 and the DETR-VAE actor, for inference and training.

Counterpart of ``GenimaACTAgent`` in ``genima_tpu/control/policy.py``. Its
params are ``{"encoder": ImageEncoderACT, "actor": GenimaACTModel}`` plus
the frozen CLIP text tower, kept apart as in the reference. ``build_agent``
makes the agent a saved train config describes
(``genima_tpu/cli/train_act.py::build_agent``).

Training (``create_state``, ``update``) follows the reference's update: the
ACT augmentations on [0, 255] images, ImageNet normalisation, the CLIP
embedding without gradients, the CVAE forward with dropout, ``act_loss``,
then ``MultiTransform``: an optional clip over every gradient, AdamW at
``lr`` for the ``main`` group and at ``lr_backbone`` for the ResNet
(``backbone``, FiLM included), and the frozen BatchNorm tensors never moved
(``frozen``). The master weights are f32; the modules compute in
``dtype`` and are the master weights themselves when that is f32. The
random draws (augmentation, the latent noise, the dropout masks) are
``ACTDraws``, made by ``sample_draws`` from a ``torch.Generator`` or handed
in by a caller. Data-parallel (one process per GPU): ``sample_draws(...,
mesh=)`` draws every batch-axis draw (the augmentation noise, the latent
noise, the dropout masks) at the global batch and keeps this rank's rows,
and ``update`` averages the gradients and the loss over the process group
whenever one is live, before the clip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from genima_torch import default_dtype, resolve_device
from genima_torch.core.distributed import all_reduce_mean_
from genima_torch.core.optim import AdamW, AdamWState, MultiTransform
from genima_torch.data.augment import (ACTAugmentDraws, act_train_augment,
                                       sample_act_augment_draws)
from genima_torch.nn.act import (ACTConfig, DropoutMasks, GenimaACTModel, GlobalRowsDropout,
                                 RandomDropout, act_loss)
from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.resnet import ImageEncoderACT
from genima_torch.weights.from_jax import load_from_jax
from genima_torch.weights.init import build_module, init_random_
from genima_torch.weights.to_jax import flax_paths, params_tree

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FAMILIES = {"encoder": "torchvision_resnet", "actor": "act"}


def _param_label(path_names: list[str]) -> str:
    """Optimizer group of a reference parameter path: ``frozen`` for the
    FrozenBatchNorm tensors, ``backbone`` for the rest of the ResNet (FiLM
    included), ``main`` for everything else."""
    in_backbone = any(n == "backbone" for n in path_names)
    is_bn = any(n.startswith("bn") or n == "downsample_1" for n in path_names)
    if in_backbone and is_bn:
        return "frozen"
    if in_backbone:
        return "backbone"
    return "main"


class ACTDraws(NamedTuple):
    """The random inputs of one update."""

    augment: Optional[ACTAugmentDraws]  # None without data augmentation
    latent_eps: torch.Tensor  # (B, latent_dim) standard normal
    dropout: Optional[DropoutMasks]  # None: dropout off


@dataclasses.dataclass
class ACTTrainState:
    params: dict[str, nn.Module]  # {"encoder", "actor"}, in the compute dtype
    live: dict[str, nn.Parameter]  # "encoder.<name>" / "actor.<name>" -> module parameter
    master: dict[str, torch.Tensor]  # same keys, f32 (the module's own tensor when f32)
    paths: dict[str, tuple[str, ...]]  # same keys -> reference path ("encoder", ...)
    opt_state: dict[str, AdamWState]  # per optimizer group

    def tree(self) -> dict:
        """The master weights as the reference's ``{"encoder", "actor"}``
        params tree, of views (no copy)."""
        return params_tree(self.master, self.paths)


@dataclasses.dataclass(eq=False)
class GenimaACTAgent:
    act_cfg: ACTConfig = dataclasses.field(default_factory=ACTConfig)
    clip_cfg: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig.vit_b_32)
    lr: float = 5e-5
    lr_backbone: float = 1e-5
    weight_decay: float = 1e-4
    actor_grad_clip: Optional[float] = None
    # the reference's init shapes; the port's modules do not depend on them
    num_views: int = 4
    image_size: int = 256
    data_augmentation: bool = True
    resnet_width: int = 64
    resnet_small_inputs: bool = False
    # frames stacked per observation: qpos is (B, state_dim * frame_stack)
    frame_stack: int = 1
    dtype: Optional[torch.dtype] = None  # None: bf16 on the card, f32 on the CPU
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
        self.tx: Optional[MultiTransform] = None

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
        controller checkpoint's ``agent``), the style encoder included. The
        clip tower is not touched."""
        params = self._build_params()
        for part, family in FAMILIES.items():
            load_from_jax(params[part], params_tree[part], family)
        return params

    def encode_lang(self, clip_params: CLIPTextModel, lang_tokens) -> torch.Tensor:
        """(B, 77) -> (B, lang_dim) projected EOT feature, f32."""
        ids = torch.as_tensor(lang_tokens, dtype=torch.long, device=self.device)
        out = clip_params(ids)
        emb = out.text_embeds if out.text_embeds is not None else out.pooled_output
        return emb.float()

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        """(B, V, H, W, 3) in [0, 255] -> ImageNet-normalised (B, V, 3, H, W)."""
        x = images.to(self.device, torch.float32) / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        return ((x - mean) / std).permute(0, 1, 4, 2, 3)

    @torch.inference_mode()
    def _act_impl(self, params, clip_params, images, qpos, lang_tokens) -> torch.Tensor:
        """images: (B, V, H, W, 3) float in [0, 255]; qpos: (B, state_dim*fs)."""
        lang = self.encode_lang(clip_params, lang_tokens)
        tokens, pos = params["encoder"](self._normalize(images).to(self.dtype), lang)
        qpos = torch.as_tensor(qpos, dtype=torch.float32, device=self.device)
        return params["actor"](tokens, pos, qpos, task_emb=lang).actions

    def act(self, params, images, qpos, lang_tokens) -> torch.Tensor:
        """The (B, num_queries, action_dim) action chunk."""
        return self._act_impl(params, self.clip_params, images, qpos, lang_tokens)

    # -- training ---------------------------------------------------------------------

    def create_state(self, params: dict[str, nn.Module], clip_params: CLIPTextModel
                     ) -> ACTTrainState:
        """Make ``params`` trainable, with fresh optimizer state; the clip
        tower becomes the frozen one the loss embeds with."""
        self.clip_params = clip_params
        live, master, paths = {}, {}, {}
        for part, family in FAMILIES.items():
            module = params[part].requires_grad_(True)
            fpaths = flax_paths(module, family)
            for name, p in module.named_parameters():
                key = f"{part}.{name}"
                live[key] = p
                master[key] = p if p.dtype == torch.float32 else p.detach().float()
                paths[key] = (part, *fpaths[name])
        labels = {k: _param_label(list(path)) for k, path in paths.items()}
        self.tx = MultiTransform(
            {"main": AdamW(lambda _: self.lr, weight_decay=self.weight_decay),
             "backbone": AdamW(lambda _: self.lr_backbone, weight_decay=self.weight_decay)},
            labels, self.actor_grad_clip)
        return ACTTrainState(params, live, master, paths, self.tx.init(master))

    def sample_draws(self, batch: dict, generator: torch.Generator,
                     record_dropout: bool = False, mesh=None) -> ACTDraws:
        """The draws of one update on ``batch``, from ``generator`` (on its
        device); ``record_dropout`` keeps the dropout masks for a replay.
        With ``mesh`` (``core/mesh.py::process_mesh``) each batch-axis draw
        is made at the global batch and this rank's rows are kept."""
        b, v, h, w, _ = batch["images"].shape
        if mesh is None:
            gb, rows = b, slice(None)
        else:
            gb, start = b * mesh.n_data, b * mesh.data_offset
            rows = slice(start, start + b)
        augment = (sample_act_augment_draws(gb * v, h, w, generator)
                   if self.data_augmentation else None)
        if augment is not None and mesh is not None:
            augment = augment._replace(noise=augment.noise[rows.start * v:rows.stop * v])
        eps = torch.randn((gb, self.act_cfg.latent_dim), generator=generator,
                          device=generator.device)[rows]
        masks = (RandomDropout(generator, record_dropout) if mesh is None
                 else GlobalRowsDropout(generator, gb, rows, record_dropout))
        return ACTDraws(augment, eps, masks)

    def loss(self, params: dict[str, nn.Module], batch: dict, draws: ACTDraws
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The training loss on ``batch`` (device tensors: images (B, V, H,
        W, 3) in [0, 255], qpos, actions (B, T, A), is_pad (B, T),
        lang_tokens (B, 77)) and its parts."""
        images = batch["images"].to(self.device, torch.float32)
        if self.data_augmentation:
            b, v, h, w, c = images.shape
            images = act_train_augment(images.reshape(b * v, h, w, c), draws.augment)
            images = images.reshape(b, v, h, w, c)
        with torch.no_grad():
            lang = self.encode_lang(self.clip_params, batch["lang_tokens"])
        tokens, pos = params["encoder"](self._normalize(images).to(self.dtype), lang)
        out = params["actor"](
            tokens, pos, batch["qpos"].float(), task_emb=lang, actions=batch["actions"],
            latent_eps=draws.latent_eps, dropout_masks=draws.dropout)
        return act_loss(out, batch["actions"], batch["is_pad"], self.act_cfg.kl_weight)

    def update(self, state: ACTTrainState, batch: dict, draws: ACTDraws
               ) -> tuple[ACTTrainState, dict[str, torch.Tensor]]:
        """One BC step in place: loss, gradients of every parameter (a
        parameter the loss does not reach gets zeros, as in JAX), the
        optimizer chain on the f32 master weights, then the modules take
        them. Returns the state and the loss parts (0-d device tensors;
        under a process group, their means over it)."""
        loss, metrics = self.loss(state.params, batch, draws)
        loss.backward()
        grads = {}
        for k, p in state.live.items():
            grads[k] = torch.zeros_like(state.master[k]) if p.grad is None else p.grad.float()
            p.grad = None
        # data-parallel: the global batch's gradients (before the clip) and loss parts
        names = list(metrics)
        metrics = dict(zip(names, all_reduce_mean_(grads, *(metrics[k].detach() for k in names))))
        opt_state, _ = self.tx.step_(state.master, grads, state.opt_state)
        with torch.no_grad():
            for k, p in state.live.items():
                if p is not state.master[k]:
                    p.copy_(state.master[k])
        return (dataclasses.replace(state, opt_state=opt_state),
                {k: v.detach() for k, v in metrics.items()})


def build_agent(cfg: dict, device: Any = "cuda", dtype: Optional[torch.dtype] = None
                ) -> GenimaACTAgent:
    """The controller agent of a saved train config (its ``method`` node):
    ``use_onehot_time`` widens ``state_dim`` by the episode length, as the
    OnehotTime wrapper widened ``low_dim_state``."""
    method = dict(cfg["method"])
    method.pop("_target_", None)
    act_kwargs = dict(method.pop("act_cfg"))
    if cfg.get("use_onehot_time", False):
        act_kwargs["state_dim"] = int(act_kwargs.get("state_dim", 8)) + int(
            cfg["env"].get("episode_length", 200))
    return GenimaACTAgent(act_cfg=ACTConfig(**act_kwargs), device=device, dtype=dtype, **method)
