"""Where a step's time goes on the card.

    python -m genima_torch.profile_step [--path serve|batched|train|act] [--n 4] [--steps 3]
        [--out FILE] [--backend fused] [--conv_backend xla] [--variant sd|sdxl|pix2pix|sd15]

``serve`` (the default) builds the full-width fused control step
(``eval.main_path``; ``--variant sdxl``: at sdxl-turbo width; ``--variant
pix2pix``: the InstructPix2Pix UNet at sd-turbo width; ``--variant sd15``:
SD-1.5's geometry, head dims 40/80/160) under the pipeline's ``--backend`` and
``--conv_backend`` (``--backend pallas+w8 --conv_backend fused`` is the
opt-in serving configuration); ``batched`` builds the lockstep-batched step
for ``--n`` envs (``eval.parallel.BatchedGenimaStep``) and profiles it
beside the serial step on the same models and the first env's inputs, in
one process; ``train`` builds a full-width ControlNet fine-tune
step (sd-turbo width, or sdxl-turbo's under ``--variant sdxl``, SD-1.5's
under ``--variant sd15``; the
pix2pix UNet fine-tune, EMA and conditioning dropout 0.05 on, under
``--variant pix2pix``; batch 4,
512x512, bf16 compute, f32 master weights, packed attention kernels;
seeded random weights and a random uint8 batch);
``act`` one ACT controller update at the trainer's defaults (``ACTConfig()``,
ResNet-18 width 64, 4 views at 256x256, batch 8, augmentations, f32 under
PyTorch's TF32 defaults; seeded weights, a random batch, fresh draws each
step). It warms the step up, then:

* times each top-level model's forward per step with CUDA events recorded
  by forward hooks (serve: ControlNet, UNet, VAE decoder, the two CLIP
  towers, the ResNet encoder, the ACT actor; train: VAE encoder, CLIP,
  ControlNet, UNet, forward only; act: CLIP, the ResNet encoder, the
  actor, forward only), so each span includes any device idle inside it;
* profiles one step with ``torch.profiler`` and reports the device-busy
  share (summed kernel time over the step's wall time), device time by
  kernel family, the top kernels, and the launches each hand-written
  kernel's wrapper counted in that step (B1-B5).

Prints one JSON object (and writes it to ``--out``). Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from genima_torch.eval.main_path import build_main_path

FAMILIES = (  # first match wins, on the lower-cased kernel name
    # the Hopper forward B1/B2a and B3 share (the step's path says which ran)
    ("attention_fwd_b1_b2a_b3", ("attention_fwd_kernel",)),
    ("packed_attention_bwd_b2b", ("packed_attention_bwd",)),
    ("fused_conv_b4", ("fused_conv3x3",)),
    ("w8_matmul_b5", ("w8_matmul",)),
    ("optimizer", ("multi_tensor",)),  # the foreach AdamW and clip
    ("library_attention", ("flash", "fmha", "attention")),
    ("layout", ("nchwtonhwc", "nhwctonchw")),  # cuDNN's NCHW <-> NHWC copies
    ("conv", ("conv", "implicit", "fprop", "winograd")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
    ("norm", ("norm", "moments")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce", "copy", "cat")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def kernel_counters() -> dict:
    """The launch counter of each hand-written kernel's wrapper."""
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import packed_attention as pa
    from genima_torch.kernels import w8_matmul as w8

    return {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
            "B2b": pa.packed_attention_backward, "B3": fa.flash_attention,
            "B4": fc.fused_conv3x3, "B5": w8.w8_matmul}


def _serve_watched(args):
    p, c = args["diffusion_params"], args["controller_params"]
    watched = {
        "unet": p["unet"], "vae_decoder": p["vae"].decoder,
        "clip_prompt": p["text_encoder"], "clip_lang": args["clip_params"],
        "resnet_encoder": c["encoder"], "act_actor": c["actor"],
    }
    if "controlnet" in p:
        watched["controlnet"] = p["controlnet"]
    if "text_encoder_2" in p:
        watched["clip_prompt_2"] = p["text_encoder_2"]
    if hasattr(p["vae"], "encoder"):  # pix2pix encodes its conditioning image
        watched["vae_encoder"] = p["vae"].encoder
    return watched


def serve_step(backend: str = "fused", conv_backend: str = "xla", variant: str = "sd"):
    """The fused control step and the models to time in it."""
    step, args = build_main_path("cuda", backend=backend, conv_backend=conv_backend,
                                 variant=variant)
    return lambda: step(**args), _serve_watched(args)


def batched_steps(n: int, backend: str = "fused", conv_backend: str = "xla"):
    """The batched step for ``n`` envs and the serial step on the same
    models (the first env's inputs), each with the models to time in it."""
    from genima_torch.eval.fused import FusedGenimaStep

    step, args = build_main_path("cuda", backend=backend, conv_backend=conv_backend, n_envs=n)
    serial = FusedGenimaStep(step.diffusion_agent, step.controller, step.obs_size)
    rows = ("tiled_u8", "prompt_embeds", "latents", "qpos", "lang_tokens")
    one = {k: v[:1] if k in rows else v for k, v in args.items()}  # noise: None under sd
    watched = _serve_watched(args)
    return {"serial": (lambda: serial(**one), watched),
            f"batched_n{n}": (lambda: step(**args), watched)}


def train_step(variant: str = "sd"):
    """One fine-tune step at the trainer CLI's defaults (batch 4, 512x512,
    bf16; pix2pix with ``--use_ema --conditioning_dropout_prob 0.05``), and
    the models to time in it."""
    from genima_torch.cli._diffusion_args import build_parser
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver

    argv = ["--device", "cuda", "--seed", "0", "--enable_xformers_memory_efficient_attention"]
    if variant == "pix2pix":
        argv += ["--use_ema", "--conditioning_dropout_prob", "0.05"]
    # SD-1.5 trains as "sd" does, on a pipeline built with its configs
    trainer_variant = "sd" if variant == "sd15" else variant
    args = build_parser(trainer_variant).parse_args(argv)
    batch_size, resolution = args.train_batch_size, args.resolution
    if variant == "sd15":
        from genima_torch.eval.main_path import sd15_pipeline

        pipe = sd15_pipeline(dtype=torch.bfloat16, backend="fused", device="cuda",
                             vae_encoder=True)
    else:
        pipe = driver.build_pipeline(args, variant)
    params = driver.init_model_params(pipe, args)
    cfg = driver.train_config(args, max_steps=1000)
    trainer = driver.make_trainer(args, trainer_variant, pipe, cfg, HashTokenizer())
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (batch_size, resolution, resolution, 3)
    batch = {
        "pixel_values": torch.randint(0, 256, shape, generator=gen, device="cuda",
                                      dtype=torch.uint8),
        "conditioning_pixel_values": torch.randint(0, 256, shape, generator=gen,
                                                   device="cuda", dtype=torch.uint8),
        "input_ids": torch.randint(0, 49406, (batch_size, 77), generator=gen, device="cuda"),
    }
    state = [trainer.create_state(params)]

    def step():
        state[0], _ = trainer.train_step(state[0], batch, gen)

    watched = {
        "vae_encoder": params["vae"].encoder, "clip_prompt": params["text_encoder"],
        "unet_fwd": params["unet"],
    }
    if "controlnet" in params:
        watched["controlnet_fwd"] = params["controlnet"]
    if "text_encoder_2" in params:
        watched["clip_prompt_2"] = params["text_encoder_2"]
    return step, watched


def act_step():
    """One ACT controller update at the trainer's defaults, and the models
    to time in it."""
    from genima_torch.control.policy import GenimaACTAgent

    agent = GenimaACTAgent(device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = [agent.create_state(*agent.init_params(gen))]
    b, c = 8, agent.act_cfg
    batch = {
        "images": torch.rand((b, agent.num_views, agent.image_size, agent.image_size, 3),
                             generator=gen, device="cuda") * 255.0,
        "qpos": torch.randn((b, c.state_dim), generator=gen, device="cuda"),
        "actions": torch.randn((b, c.num_queries, c.action_dim), generator=gen, device="cuda"),
        "is_pad": torch.zeros((b, c.num_queries), dtype=torch.bool, device="cuda"),
        "lang_tokens": torch.randint(0, 49406, (b, 77), generator=gen, device="cuda"),
    }

    def step():
        state[0], _ = agent.update(state[0], batch, agent.sample_draws(batch, gen))

    params = state[0].params
    watched = {"clip_lang": agent.clip_params, "resnet_encoder": params["encoder"],
               "act_actor": params["actor"]}
    return step, watched


def module_spans(step, watched):
    """Per-model device ms over one step, from forward-hook CUDA events."""
    events = collections.defaultdict(list)
    handles = []
    for name, mod in watched.items():
        def pre(m, a, name=name):
            events[name].append([torch.cuda.Event(enable_timing=True), None])
            events[name][-1][0].record()

        def post(m, a, out, name=name):
            events[name][-1][1] = torch.cuda.Event(enable_timing=True)
            events[name][-1][1].record()

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    step()
    end.record()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    spans = {k: {"calls": len(v), "ms": sum(a.elapsed_time(b) for a, b in v)}
             for k, v in events.items()}
    return start.elapsed_time(end), spans


def profile(step, watched, warmup: int) -> dict:
    """Per-model spans by events, then one step under ``torch.profiler``:
    the device-busy share, device time by kernel family, the top kernels."""
    for _ in range(warmup):
        step()
    torch.cuda.reset_peak_memory_stats()
    step_ms, spans = module_spans(step, watched)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        h0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    hand_written = {k: fn.launches - before[k] for k, fn in counters.items()}
    kernels = collections.Counter()
    counts = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] += ev.device_time_total / 1e3  # us -> ms
            counts[ev.name] += 1
    busy_ms = sum(kernels.values())
    fams = collections.Counter()
    for name, ms in kernels.items():
        fams[family(name)] += ms
    return {
        "step_ms_events": step_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches": sum(counts.values()),
        "hand_written_launches": hand_written,
        "by_family_ms": dict(fams.most_common()),
        "by_model_ms": spans,
        "top_kernels": [
            {"name": n[:120], "ms": ms, "calls": counts[n]}
            for n, ms in kernels.most_common(15)
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("serve", "batched", "train", "act"), default="serve")
    ap.add_argument("--n", type=int, default=4, help="batched: lockstep envs")
    ap.add_argument("--steps", type=int, default=3, help="warm-up steps")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--backend", default="fused", help="serve, batched: attention backend spec")
    ap.add_argument("--conv_backend", default="xla", help="serve, batched: VAE decoder convs")
    ap.add_argument("--variant", choices=("sd", "sdxl", "pix2pix", "sd15"), default="sd",
                    help="serve, train: sd-turbo, sdxl-turbo, the pix2pix UNet or SD-1.5")
    a = ap.parse_args()
    if a.variant != "sd" and a.path not in ("serve", "train"):
        raise SystemExit(f"--variant {a.variant} applies to --path serve and --path train")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    out = {"card": card, "path": a.path, "variant": a.variant}
    if a.path in ("serve", "batched"):
        out.update(backend=a.backend, conv_backend=a.conv_backend)
    if a.path == "serve":
        out.update(profile(*serve_step(a.backend, a.conv_backend, a.variant), a.steps))
    elif a.path == "batched":
        out["n_envs"] = a.n
        for name, (step, watched) in batched_steps(a.n, a.backend, a.conv_backend).items():
            out[name] = profile(step, watched, a.steps)
    else:
        out.update(profile(*(train_step(a.variant) if a.path == "train" else act_step()),
                           a.steps))
    text = json.dumps(out, indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
