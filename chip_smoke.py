#!/usr/bin/env python3
"""Drive genima_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the paths from ``genima_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, started together).
2. Kernel phase: each kernel at the shapes its path gives it, on seeded bf16
   inputs, against its plain PyTorch version (stated tolerance), timed with
   CUDA events beside its plain version and the one library call that
   computes the same function (``scaled_dot_product_attention`` forward, or
   its autograd backward: yardsticks the port never calls). B1, the packed
   forward, at the serving batch 1; B2a (forward + log-sum-exp) and B2b
   (backward) at the trainer's batch 4.
3. Serving path: the fused control step (SD-turbo ControlNet 5-step
   denoise, VAE decode, untile, ACT) at full sd-turbo + ACT width with
   seeded random weights, for a few steps on 512x512 uint8 observations.
   Launch counts are zeroed just before and read just after; each step must
   launch B1 exactly 105 times. The result is checked for shape, dtype and
   finiteness, and one denoise step's noise prediction is held to the same
   models run with the library attention instead of the kernel.
4. Train path: ``genima_torch.diffusion.driver.run_training`` (the CLI's
   entry point) takes 3 ControlNet fine-tune steps at full sd-turbo width,
   512x512, batch 4, bf16 compute with f32 master weights, the packed
   attention kernels, on a small rendered dataset written from the seed.
   Each step must launch B1 6 times, B2a and B2b 15 times each, with no
   plain-recompute fallback; the loss must be finite, the ControlNet must
   move and the UNet, VAE and CLIP must stay bit-unchanged. Then one step's
   ControlNet gradients through the kernels are held to those through the
   library attention.

Prints the card's name and power limit, the per-step times and peak memory,
one ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a GPU or without the package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 1e-2  # bf16 output and bf16-rounded P on unit-scale inputs
EPS_REL_TOL = 5e-2  # kernel vs library attention through one full-width step
PATH_STEPS = 4
LAUNCHES_PER_STEP = 105  # 7 per level per denoise step x 3 levels x 5 steps
# (B, S, C, heads) of the SD-turbo self-attention levels at 64x64 latents
SD_LEVELS = [(1, 4096, 320, 5), (1, 1024, 640, 10), (1, 256, 1280, 20)]
TRAIN_BATCH = 4  # the trainer CLI's default train_batch_size
TRAIN_LEVELS = [(TRAIN_BATCH, s, c, h) for _, s, c, h in SD_LEVELS]
LSE_TOL = 2e-3  # f32 log-sum-exp of unit-scale scores over <= 4096 keys
GRAD_TOL = 2e-2  # bf16 dq/dk/dv and bf16-rounded P, dS: error / max |grad|
TRAIN_STEPS = 3
# per train step at batch 4: the UNet down blocks' 2 self-attentions per
# level need no gradient (B1); the UNet up blocks' 3 and the ControlNet down
# blocks' 2 per level do (B2a forward, B2b backward); x 3 levels
TRAIN_LAUNCHES = {"B1": 6, "B2a": 15, "B2b": 15, "fallbacks": 0}
# ControlNet gradients, kernels vs library attention, one full-width bf16
# step: relative global-norm difference, and the worst attention projection's
TRAIN_GRAD_REL_TOL = 0.1


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device ms per call. A ~50 ms sleep kernel goes first, so the host has
    queued every launch before the device reaches them: the events then
    time device work, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(pa) -> list[dict]:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, c, h in SD_LEVELS:
        q, k, v = (
            torch.randn(b, s, c, generator=gen, device="cuda").bfloat16() for _ in range(3)
        )
        got = pa.packed_flash_attention(q, k, v, h)
        want = pa.packed_attention_reference(q, k, v, h)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"packed attention {b}x{s}x{c}/{h}: max abs err {err}")

        def library():
            d = c // h
            return F.scaled_dot_product_attention(
                *(x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
            ).transpose(1, 2).reshape(b, s, c)

        flops = 4 * b * s * s * c
        nbytes = 2 * (2 * b * s * c + 2 * b * s * c)  # q, k, v read, o written
        bound_s = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
        kernel_ms = cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), 100)
        rows.append({
            "name": "packed_flash_attention",
            "route": "cuda",
            "source": "genima_torch/csrc/packed_attention.cu",
            "replaces": "genima_tpu/kernels/packed_attention.py:194",
            "shape": f"{b}x{s}x{c}/{h}",
            "launches": None,  # filled from the path phase
            "max_abs_err": err,
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "plain_ms": cuda_ms(lambda: pa.packed_attention_reference(q, k, v, h), 5),
            "library_ms": cuda_ms(library, 100),
            "bound_ms": bound_s * 1e3,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES
            else "bytes",
        })
    return rows


def path_phase(pa) -> dict:
    from genima_torch.eval.main_path import build_main_path
    from genima_torch.nn.layers import set_attention_backend

    t0 = time.time()
    step, args = build_main_path(device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    pa.packed_flash_attention.launches = 0
    pa.packed_flash_attention.launches_by_shape.clear()
    step_ms, host_ms = [], []
    for _ in range(PATH_STEPS):
        before = pa.packed_flash_attention.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        actions, target = step(**args)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        n = pa.packed_flash_attention.launches - before
        if n != LAUNCHES_PER_STEP:
            raise AssertionError(f"{n} packed-attention launches in a step, want 105")
    launches = dict(pa.packed_flash_attention.launches_by_shape)
    total = pa.packed_flash_attention.launches

    if actions.shape != (1, 20, 8) or not torch.isfinite(actions).all():
        raise AssertionError(f"actions {tuple(actions.shape)} finite={torch.isfinite(actions).all()}")
    if target.shape != (1, 512, 512, 3) or target.dtype != torch.uint8:
        raise AssertionError(f"target {tuple(target.shape)} {target.dtype}")

    # one denoise step's noise prediction: kernel vs the library attention
    pipe = step.pipe
    unet, cn = args["diffusion_params"]["unet"], args["diffusion_params"]["controlnet"]
    embeds = args["prompt_embeds"]
    state = pipe.scheduler.set_timesteps(5)
    with torch.inference_mode():
        x = args["latents"].permute(0, 3, 1, 2) * float(state.init_noise_sigma)
        x = pipe.scheduler.scale_model_input(state, x.contiguous(), 0).to(pipe.dtype)
        t = torch.full((1,), float(state.timesteps[0]), device="cuda")
        cond = args["tiled_u8"].permute(0, 3, 1, 2).to(pipe.dtype).contiguous() / 255.0
        eps = {}
        for backend in ("fused", "xla"):
            set_attention_backend(unet, backend)
            set_attention_backend(cn, backend)
            down, mid = cn(x, t, embeds, cond, cond_is_embedded=False)
            eps[backend] = unet(x, t, embeds, down, mid).float()
        set_attention_backend(unet, "fused")
        set_attention_backend(cn, "fused")
    rel = ((eps["fused"] - eps["xla"]).abs().max() / eps["xla"].abs().max()).item()
    if not (torch.isfinite(eps["fused"]).all() and rel <= EPS_REL_TOL):
        raise AssertionError(f"eps kernel vs library attention: rel err {rel}")

    return {
        "setup_s": setup_s,
        "step_ms": step_ms,
        "host_step_ms": host_ms,
        "launches_total": total,
        "launches_by_shape": {"x".join(map(str, k)): v for k, v in launches.items()},
        "eps_rel_err_vs_library_attention": rel,
        "actions_abs_max": actions.abs().max().item(),
        "target_mean": target.float().mean().item(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    ops_s, bytes_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s > bytes_s else "bytes"


def training_kernel_phase(pa) -> list[dict]:
    """B2a and B2b at the three SD levels at batch 4."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, s, c, h in TRAIN_LEVELS:
        q, k, v, do = (
            torch.randn(b, s, c, generator=gen, device="cuda").bfloat16() for _ in range(4)
        )
        shape = f"{b}x{s}x{c}/{h}"

        # B2a: o and L against the plain version
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (o_err <= ATTN_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"B2a {shape}: o err {o_err}, L err {lse_err}")
        heads = [x.view(b, s, h, c // h).transpose(1, 2) for x in (q, k, v)]
        bound_ms, bound_by = _bound(4 * b * s * s * c, 2 * 4 * b * s * c + 4 * b * s * h)
        rows.append({
            "name": "packed_attention_forward_lse",
            "route": "cuda",
            "source": "genima_torch/csrc/packed_attention.cu",
            "replaces": "genima_tpu/kernels/packed_attention.py:274",
            "shape": shape,
            "launches": None,  # filled from the train path
            "max_abs_err": max(o_err, lse_err),
            "o_abs_err": o_err,
            "lse_abs_err": lse_err,
            "ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 50),
            "plain_ms": cuda_ms(lambda: pa.packed_attention_lse_reference(q, k, v, h), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })

        # B2b: dq, dk, dv against the plain version, from the kernel's o and L
        got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
        torch.cuda.synchronize()
        abs_err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
        rel_err = max(
            ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
            for x, y in zip(got, want)
        )
        if not rel_err <= GRAD_TOL:
            raise AssertionError(f"B2b {shape}: max err {rel_err} of max |grad|")
        leaves = [x.detach().requires_grad_() for x in heads]
        out = F.scaled_dot_product_attention(*leaves)
        go = do.view(b, s, h, c // h).transpose(1, 2)
        bound_ms, bound_by = _bound(10 * b * s * s * c, 2 * 8 * b * s * c + 4 * b * s * h)
        rows.append({
            "name": "packed_attention_backward",
            "route": "cuda",
            "source": "genima_torch/csrc/packed_attention_bwd.cu",
            "replaces": "genima_tpu/kernels/packed_attention.py:380",
            "shape": shape,
            "launches": None,
            "max_abs_err": abs_err,
            "max_rel_err": rel_err,
            "ms": cuda_ms(lambda: pa.packed_attention_backward(q, k, v, o, lse, do, h), 50),
            "plain_ms": cuda_ms(
                lambda: pa.packed_attention_backward_reference(q, k, v, o, lse, do, h), 3),
            "library_ms": cuda_ms(
                lambda: torch.autograd.grad(out, leaves, go, retain_graph=True), 50),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
        del out, leaves
    return rows


def write_rendered_dataset(root: Path, episodes: int = 2, frames: int = 5, size: int = 512):
    """A seeded rendered dataset in the layout ``index_rendered_dataset``
    reads: <task>/variation0/episodes/episode<i>/{tiled_rgb,tiled_rgb_rendered}."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    for ep in range(episodes):
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = root / "toy_task" / "variation0" / "episodes" / f"episode{ep}" / sub
            d.mkdir(parents=True)
            for i in range(frames):
                img = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / f"{i}.png")


def train_phase(pa) -> dict:
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.data.dataset import to_device
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion.training import ControlNetTrainer
    from genima_torch.nn.layers import set_attention_backend

    with tempfile.TemporaryDirectory() as tmp:
        write_rendered_dataset(Path(tmp))
        args = parse_args([
            "--data_path", tmp, "--tasks", "toy_task", "--resolution", "512",
            "--train_batch_size", str(TRAIN_BATCH), "--max_train_steps", str(TRAIN_STEPS),
            "--seed", "0", "--device", "cuda", "--mixed_precision", "bf16",
            "--enable_xformers_memory_efficient_attention", "--max_grad_norm", "1.0",
            "--dataloader_num_workers", "4",
        ])
        t0 = time.time()
        pipe = driver.build_pipeline(args)
        params = driver.init_model_params(pipe, args)
        frozen = {
            name: {k: t.clone() for k, t in params[name].state_dict().items()}
            for name in ("unet", "vae", "text_encoder")
        }
        cn_init = {k: p.detach().float().clone() for k, p in params["controlnet"].named_parameters()}
        torch.cuda.synchronize()
        setup_s = time.time() - t0

        counters = {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
                    "B2b": pa.packed_attention_backward}
        for fn in counters.values():
            fn.launches = 0
            fn.launches_by_shape.clear()
        pa.PackedFlashAttention.fallbacks = 0
        per_step, step_ms, losses, last = [], [], [], {}
        marks = [time.perf_counter()]

        def hook(step, state, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            step_ms.append((marks[-1] - marks[-2]) * 1e3)
            counts = {k: fn.launches for k, fn in counters.items()}
            counts["fallbacks"] = pa.PackedFlashAttention.fallbacks
            per_step.append(counts)
            losses.append(float(metrics["loss"]))
            last["state"] = state

        torch.cuda.reset_peak_memory_stats()
        result = driver.run_training(args, pipe=pipe, params=params, step_hook=hook)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches_by_shape = {
            k: {"x".join(map(str, s)): n for s, n in fn.launches_by_shape.items()}
            for k, fn in counters.items()
        }
        deltas = [
            {k: c[k] - (per_step[i - 1][k] if i else 0) for k in c}
            for i, c in enumerate(per_step)
        ]
        if result["global_step"] != TRAIN_STEPS or len(deltas) != TRAIN_STEPS:
            raise AssertionError(f"train path took {result['global_step']} steps")
        for i, d in enumerate(deltas):
            if d != TRAIN_LAUNCHES:
                raise AssertionError(f"train step {i + 1} launches {d}, want {TRAIN_LAUNCHES}")
        if not all(map(torch.isfinite, map(torch.tensor, losses))):
            raise AssertionError(f"train losses {losses}")
        for name, before in frozen.items():
            after = params[name].state_dict()
            changed = [k for k, t in before.items() if not torch.equal(t, after[k])]
            if changed:
                raise AssertionError(f"frozen {name} changed: {changed[:3]}")
        moved = max(
            (last["state"].params[k] - v).abs().max().item() for k, v in cn_init.items()
        )
        if not moved > 0:
            raise AssertionError("the ControlNet did not move")

        # one step's ControlNet gradients: kernels vs the library attention
        trainer = ControlNetTrainer(pipe, driver.train_config(args, TRAIN_STEPS))
        state = trainer.create_state(params)
        loader = driver.make_train_dataset(args, HashTokenizer())
        batch = to_device(next(iter(loader)), pipe.device)
        draws = trainer.sample_draws(
            TRAIN_BATCH, 512, torch.Generator(device="cuda").manual_seed(7))
        grads = {}
        for backend in ("fused", "xla"):
            for name in ("unet", "controlnet"):
                set_attention_backend(params[name], backend)
            grads[backend] = trainer.gradients(state, batch, draws)[1]
        for name in ("unet", "controlnet"):
            set_attention_backend(params[name], "fused")

    def norm(ts):
        return torch.stack([t.norm() for t in ts]).norm().item()

    f, x = grads["fused"], grads["xla"]
    diff = {k: f[k] - x[k] for k in x}
    global_rel = norm(diff.values()) / norm(x.values())
    max_rel = max(d.abs().max().item() for d in diff.values()) / max(
        t.abs().max().item() for t in x.values())
    attn = [k for k in x if ".attn1.to_" in k and k.endswith("weight")]
    attn_rel = max(diff[k].norm().item() / x[k].norm().item() for k in attn)
    if not (global_rel <= TRAIN_GRAD_REL_TOL and attn_rel <= TRAIN_GRAD_REL_TOL
            and norm(x.values()) > 0):
        raise AssertionError(
            f"ControlNet grads kernels vs library: global {global_rel}, "
            f"attention projections {attn_rel}")
    return {
        "setup_s": setup_s,
        "step_ms": step_ms,
        "losses": losses,
        "launches_per_step": deltas,
        "launches_by_shape": launches_by_shape,
        "controlnet_max_move": moved,
        "grad_rel_norm_diff_vs_library_attention": global_rel,
        "grad_max_err_vs_library_attention": max_rel,
        "grad_attn_proj_rel_norm_diff_vs_library_attention": attn_rel,
        "peak_mem_gb": peak_gb,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from genima_torch.kernels import _build
    from genima_torch.kernels import packed_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32 = "
          "torch.backends.cudnn.allow_tf32 = False")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.build_all(["packed_attention", "packed_attention_bwd"])
    print(f"built kernels in {time.time() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = kernel_phase(pa)
    train_kernels = training_kernel_phase(pa)
    path = path_phase(pa)
    for row in kernels:
        b, s, c, _ = SD_LEVELS[kernels.index(row)]
        row["launches"] = path["launches_by_shape"].get(f"{b}x{s}x{s}x{c}", 0)
        if row["launches"] == 0:
            raise AssertionError(f"kernel {row['name']} {row['shape']} never launched")
    print("path " + json.dumps(path))
    train = train_phase(pa)
    for row in train_kernels:
        b, s, c, _ = TRAIN_LEVELS[train_kernels.index(row) // 2]
        key = "B2a" if row["name"] == "packed_attention_forward_lse" else "B2b"
        row["launches"] = train["launches_by_shape"][key].get(f"{b}x{s}x{s}x{c}", 0)
        if row["launches"] == 0:
            raise AssertionError(f"kernel {row['name']} {row['shape']} never launched")
    print("train " + json.dumps(train))
    print(json.dumps({"kernels": kernels + train_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
