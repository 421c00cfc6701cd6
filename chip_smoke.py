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
   forward, at the serving batch 1 and the trainer's batch 4; B2a (forward
   + log-sum-exp) and B2b (backward) at batch 4. B2a's output must be B1's
   bit for bit. B1/B2a rows carry their launch plan (``forward_plan``),
   ptxas registers and spills and shared memory (held to the kernel's own
   count); B2b's rows its two kernels' registers, spills and shared memory,
   and two B2b calls on the same inputs must give the same bits.
3. Serving path: the fused control step (SD-turbo ControlNet 5-step
   denoise, VAE decode, untile, ACT) at full sd-turbo + ACT width with
   seeded random weights, for a few steps on 512x512 uint8 observations.
   Launch counts are zeroed just before and read just after; each step must
   launch B1 exactly 105 times. The result is checked for shape, dtype and
   finiteness, and one denoise step's noise prediction is held to the same
   models run with the library attention instead of the kernel.
4. Opt-in kernel phase: B3 (flash attention on (B, S, H, 64)), B4 (fused
   GN-SiLU-conv3x3, NHWC) and B5 (int8 weight-only matmul) at every distinct
   shape the opt-in serving configuration gives them, against their plain
   versions, timed beside their bound and a labelled library yardstick.
   B3/B4/B5 rows carry their launch plan, ptxas registers and spills and
   shared memory (held to the kernel's own count); two B5 calls on the
   same inputs must give the same bits.
5. Opt-in serving path: the same control step built with
   ``backend="pallas+w8", conv_backend="fused"`` (int8 weights quantized by
   ``quantize_pipeline_params`` from the seeded floats). Each step must
   launch B3 230 times, B5 1380 times, B4 25 times and B1 never. One
   denoise step's noise prediction is held to the library attention on the
   same int8 weights (B3 in place), that to the float models on the
   dequantised weights (B5 in place), and the fused VAE decode to the
   default decoder on the same latents (B4 in place).
6. Train path: ``genima_torch.diffusion.driver.run_training`` (the CLI's
   entry point) takes 3 ControlNet fine-tune steps at full sd-turbo width,
   512x512, batch 4, bf16 compute with f32 master weights, the packed
   attention kernels, on a small rendered dataset written from the seed.
   Each step must launch B1 6 times, B2a and B2b 15 times each, with no
   plain-recompute fallback; the loss must be finite, the ControlNet must
   move and the UNet, VAE and CLIP must stay bit-unchanged. Then one step's
   ControlNet gradients through the kernels are held to those through the
   library attention.

Prints the card's name and power limit, the per-step times and peak memory,
a ``per_step`` line (per path, per kernel: launches a step x ms, and the
same sums of its bound and library time), one ``{"kernels": [...]}`` line,
and last
``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a GPU or without the package.
"""

from __future__ import annotations

import json
import math
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

# the opt-in serving configuration: "pallas+w8" attention, fused VAE convs
OPT_BACKEND, OPT_CONV_BACKEND = "pallas+w8", "fused"
OPT_STEPS = 3
# per control step (5 denoise steps): B3 = 46 attentions per denoise step
# (16 UNet + 7 ControlNet transformer blocks, self and cross) x 5; B5 = 12
# int8 linears per transformer block x 23 x 5; B4 = 12 decoder resnets x 2
# convs + conv_out; B1 none (the "pallas" backend replaces it)
OPT_LAUNCHES = {"B1": 0, "B3": 230, "B4": 25, "B5": 1380}
# (tokens, channels, heads) of the UNet / ControlNet levels at 64x64 latents
OPT_LEVELS = [(4096, 320, 5), (1024, 640, 10), (256, 1280, 20), (64, 1280, 20)]
CONTEXT = (77, 1024)  # prompt tokens, CLIP width
# B3 (B, Sq, Sk, C, heads): self-attention, then cross-attention over 77 keys
FLASH_SHAPES = [(1, s, s, c, h) for s, c, h in OPT_LEVELS] + [
    (1, s, CONTEXT[0], c, h) for s, c, h in OPT_LEVELS]
# B4 (B, H, W, C, O) of the SD VAE decoder's up blocks and conv_out at 512^2
CONV_SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
    (1, 512, 512, 128, 3),
]
# B5 (M, K, N): proj_in/out and attention projections, GEGLU in and out,
# and the cross-attention K/V on the 77 prompt tokens
W8_SHAPES = sorted(
    {(m, k, n) for m, c, _ in OPT_LEVELS for k, n in ((c, c), (c, 8 * c), (4 * c, c))}
    | {(CONTEXT[0], CONTEXT[1], c) for _, c, _ in OPT_LEVELS})
KERNEL_SOURCES = ["packed_attention", "packed_attention_bwd", "flash_attention", "fused_conv",
                  "w8_matmul"]
CONV_REL_TOL = 2e-2  # bf16 activation and output roundings: error / max |y|
W8_REL_TOL = 1e-2  # bf16 output rounding: error / max |y|
OPT_REL_TOL = 5e-2  # each kernel vs the library path through a full model


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


def _forward_report(pa, b: int, s: int, h: int, with_lse: bool) -> dict:
    """B1's or B2a's launch plan at a shape, the shared memory its kernel
    asks for (held to ``forward_plan``'s count) and its ptxas registers and
    spills."""
    from genima_torch.kernels import _build

    plan = pa.forward_plan(b, s, s, h)
    smem = pa._library().packed_attention_smem_bytes(plan.nwg, plan.bn, plan.stages)
    if smem != plan.smem_bytes:
        raise AssertionError(f"packed forward plan's shared memory {plan.smem_bytes} != {smem}")
    regs = ptxas_report(_build.build_log("packed_attention"))
    return {
        "plan": {"warpgroups": plan.nwg, "query_rows": plan.rows, "key_tile": plan.bn,
                 "stages": plan.stages, "blocks": plan.blocks},
        "smem_bytes": smem, **regs.get(f"{plan.nwg}x{plan.bn}x{int(with_lse)}", {}),
    }


def _b1_row(pa, q, k, v, h, err: float) -> dict:
    import torch.nn.functional as F

    b, s, c = q.shape
    iters = 100 if b == 1 else 50

    def library():  # SDPA on (B, heads, S, 64) views, back to the packed layout
        return F.scaled_dot_product_attention(
            *(x.view(b, s, h, c // h).transpose(1, 2) for x in (q, k, v))
        ).transpose(1, 2).reshape(b, s, c)

    bound_ms, bound_by = _bound(4 * b * s * s * c, 2 * 4 * b * s * c)  # q, k, v read, o written
    kernel_ms = cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), iters)
    return {
        "name": "packed_flash_attention",
        "route": "cuda",
        "source": "genima_torch/csrc/packed_attention.cu",
        "replaces": "genima_tpu/kernels/packed_attention.py:194",
        "shape": f"{b}x{s}x{c}/{h}", "key": f"{b}x{s}x{s}x{c}",
        "launches": None,  # filled from the path phase
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(lambda: pa.packed_attention_reference(q, k, v, h), 5 if b == 1 else 3),
        "library_ms": cuda_ms(library, iters),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        **_forward_report(pa, b, s, h, with_lse=False),
    }


def kernel_phase(pa) -> list[dict]:
    """B1 at the three SD levels at the serving batch 1."""
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
        rows.append(_b1_row(pa, q, k, v, h, err))
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


def _bwd_kernel_report() -> dict:
    """ptxas registers and spills of B2b's two kernels and the shared memory
    each asks for (held to ``backward_plan``'s count), keyed "dq" and
    "dkdv"."""
    from genima_torch.kernels import _build
    from genima_torch.kernels import packed_attention as pa

    lib = pa._bwd_library()
    report = ptxas_report(_build.build_log("packed_attention_bwd"))
    plan = pa.backward_plan(1, 64, 64, 1)
    out = {}
    for name, dkdv in (("dq", 0), ("dkdv", 1)):
        smem = lib.packed_attention_bwd_smem_bytes(dkdv)
        if smem != getattr(plan, f"{name}_smem_bytes"):
            raise AssertionError(f"B2b {name} kernel's shared memory {smem} != backward_plan's")
        regs = next((r for k, r in report.items() if f"_{name}_kernel" in k), {})
        out[name] = {**regs, "smem_bytes": smem}
    return out


def training_kernel_phase(pa) -> list[dict]:
    """B2a, B1 and B2b at the three SD levels at batch 4."""
    import torch.nn.functional as F

    bwd_report = _bwd_kernel_report()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, s, c, h in TRAIN_LEVELS:
        q, k, v, do = (
            torch.randn(b, s, c, generator=gen, device="cuda").bfloat16() for _ in range(4)
        )
        shape = f"{b}x{s}x{c}/{h}"
        bp = pa.backward_plan(b, s, s, h)

        # B2a: o and L against the plain version
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (o_err <= ATTN_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"B2a {shape}: o err {o_err}, L err {lse_err}")
        o1 = pa.packed_flash_attention(q, k, v, h)
        torch.cuda.synchronize()
        if not torch.equal(o, o1):  # one kernel, one plan: B2a adds the L store
            raise AssertionError(f"B2a {shape}: output differs from B1's")
        heads = [x.view(b, s, h, c // h).transpose(1, 2) for x in (q, k, v)]
        bound_ms, bound_by = _bound(4 * b * s * s * c, 2 * 4 * b * s * c + 4 * b * s * h)
        rows.append({
            "name": "packed_attention_forward_lse",
            "route": "cuda",
            "source": "genima_torch/csrc/packed_attention.cu",
            "replaces": "genima_tpu/kernels/packed_attention.py:274",
            "shape": shape, "key": f"{b}x{s}x{s}x{c}",
            "launches": None,  # filled from the train path
            "max_abs_err": max(o_err, lse_err),
            "o_abs_err": o_err,
            "lse_abs_err": lse_err,
            "ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 50),
            "plain_ms": cuda_ms(lambda: pa.packed_attention_lse_reference(q, k, v, h), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **_forward_report(pa, b, s, h, with_lse=True),
        })
        # B1 at batch 4 (the UNet down blocks' attention, which needs no gradient)
        rows.append(_b1_row(pa, q, k, v, h, (o1.float() - o_ref.float()).abs().max().item()))

        # B2b: dq, dk, dv against the plain version, from the kernel's o and L
        got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
        again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):  # no atomics
            raise AssertionError(f"B2b {shape}: two calls differ")
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
            "shape": shape, "key": f"{b}x{s}x{s}x{c}",
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
            "plan": {"kernels": "dq, then dk/dv", "rows_per_block": pa.BWD_BLOCK_ROWS,
                     "stages": pa.BWD_STAGES,
                     "blocks": [math.prod(bp.dq_grid), math.prod(bp.dkdv_grid)]},
            **bwd_report,
        })
        del out, leaves
    return rows


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers and spills of each kernel instantiation in an ``nvcc
    -Xptxas -v`` log, keyed by its template arguments ("128" for
    ``w8_matmul_kernel<128>``, "128x2" for ``fused_conv3x3_kernel<128, 2>``,
    "2x128x1" for ``attention_fwd_kernel<2, 128, true>``)."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = "x".join(re.findall(r"L[ib](\d+)E", m.group(1))) or m.group(1)
            out[key] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key is not None:
            out[key]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            out[key]["registers"] = int(m.group(1))
    return out


def opt_kernel_phase() -> list[dict]:
    """B3, B4 and B5 at every shape of the opt-in serving path."""
    import torch.nn.functional as F

    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import _build
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import w8_matmul as w8

    regs = {name: ptxas_report(_build.build_log(name))
            for name in ("flash_attention", "fused_conv", "w8_matmul")}
    fa_lib, conv_lib, w8_lib = fa._library(), fc._library(), w8._library()
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b, sq, sk, c, h in FLASH_SHAPES:
        q, k, v = (torch.randn(b, s, h, c // h, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"B3 {b}x{sq}x{sk}x{c}/{h}: max abs err {err}")
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        plan = fa.plan(b, sq, sk, h)
        if fa_lib.flash_attention_smem_bytes(plan.nwg, plan.bn, plan.stages) != plan.smem_bytes:
            raise AssertionError(f"B3 plan's shared memory {plan.smem_bytes} != the kernel's")
        bound_ms, bound_by = _bound(4 * b * sq * sk * c, 2 * b * (2 * sq + 2 * sk) * c)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "genima_torch/csrc/flash_attention.cu",
            "replaces": "genima_tpu/kernels/flash_attention.py:129",
            "shape": f"{b}x{sq}x{sk}x{c}/{h}", "key": f"{b}x{sq}x{sk}x{c}",
            "launches": None, "max_abs_err": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 50),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "library": "scaled_dot_product_attention forward on the same (B, H, S, 64) views",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": {"warpgroups": plan.nwg, "query_rows": plan.rows, "key_tile": plan.bn,
                     "stages": plan.stages, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes,
            **regs["flash_attention"].get(f"{plan.nwg}x{plan.bn}x0", {}),
        })

    for b, h, w, c, o in CONV_SHAPES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").bfloat16()
        gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
        scale, shift = fc.fold_group_norm(x, gamma, beta, 32, 1e-6)
        wt = (torch.randn(3, 3, c, o, generator=gen, device="cuda") / (3 * c ** 0.5)).bfloat16()
        bias = torch.randn(o, generator=gen, device="cuda").bfloat16()
        # the path's calls at a C == O shape include each block's second conv,
        # which adds the residual
        res = torch.randn(b, h, w, o, generator=gen, device="cuda").bfloat16() if c == o else None
        args = (x, wt, bias, scale, shift, None, res)
        got = fc.fused_conv3x3(*args)
        want = fc.fused_conv3x3_reference(*args)
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        if not rel <= CONV_REL_TOL:
            raise AssertionError(f"B4 {b}x{h}x{w}x{c}->{o}: max err {rel} of max |y|")
        plan = fc.plan(b, h, w, c, o)
        if conv_lib.fused_conv3x3_smem_bytes(plan.bn, plan.rows) != plan.smem_bytes:
            raise AssertionError(f"B4 plan's shared memory {plan.smem_bytes} != the kernel's")
        act = (x.float() * scale[:, None, None] + shift[:, None, None])
        act = (act * torch.sigmoid(act)).bfloat16().permute(0, 3, 1, 2)  # channels_last NCHW
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = 2 * b * h * w * (c + o + (o if res is not None else 0)) + 2 * 9 * c * o \
            + 2 * o + 8 * b * c
        bound_ms, bound_by = _bound(2 * b * h * w * o * 9 * c, nbytes)
        rows.append({
            "name": "fused_conv3x3", "route": "cuda",
            "source": "genima_torch/csrc/fused_conv.cu",
            "replaces": "genima_tpu/kernels/fused_conv.py:380",
            "shape": f"{b}x{h}x{w}x{c}->{o}" + ("+res" if res is not None else ""),
            "key": f"{b}x{h}x{w}x{c}x{o}",
            "launches": None, "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_rel_err": rel,
            "ms": cuda_ms(lambda: fc.fused_conv3x3(*args), 20),
            "plain_ms": cuda_ms(lambda: fc.fused_conv3x3_reference(*args), 3),
            "library_ms": cuda_ms(lambda: F.conv2d(act, w_cl, bias, padding=1), 20),
            "library": "cuDNN conv2d alone, channels_last bf16, on the pre-activated input "
                       "(a lower yardstick: it skips the GN/SiLU prologue and the residual)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": {"tile": f"{plan.rows * 64} pixels x {plan.bn} channels",
                     "tiles": plan.n_tiles, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes,
            **regs["fused_conv"].get(f"{plan.bn}x{plan.rows}", {}),
        })

    for m, k, n in W8_SHAPES:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
        got = w8.w8_matmul(x, w_q, scale)
        want = w8.w8_matmul_reference(x, w_q, scale)
        again = w8.w8_matmul(x, w_q, scale)
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        if not rel <= W8_REL_TOL:
            raise AssertionError(f"B5 {m}x{k}x{n}: max err {rel} of max |y|")
        if not torch.equal(got, again):  # split-K sums in a fixed order
            raise AssertionError(f"B5 {m}x{k}x{n}: two calls differ")
        plan = w8.plan(m, k, n)
        if w8_lib.w8_matmul_smem_bytes(plan.bt, plan.stages) != plan.smem_bytes:
            raise AssertionError(f"B5 plan's shared memory {plan.smem_bytes} != the kernel's")
        w_deq = (w_q.float() * scale[:, None]).bfloat16().t()
        bound_ms, bound_by = _bound(2 * m * k * n, 2 * m * k + k * n + 4 * n + 2 * m * n)
        rows.append({
            "name": "w8_matmul", "route": "cuda",
            "source": "genima_torch/csrc/w8_matmul.cu",
            "replaces": "genima_tpu/kernels/w8_matmul.py:94",
            "shape": f"{m}x{k}x{n}", "key": f"{m}x{k}x{n}",
            "launches": None, "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_rel_err": rel,
            "ms": cuda_ms(lambda: w8.w8_matmul(x, w_q, scale), 100),
            "plain_ms": cuda_ms(lambda: w8.w8_matmul_reference(x, w_q, scale), 5),
            "library_ms": cuda_ms(lambda: torch.matmul(x, w_deq), 100),
            "library": "torch.matmul on the pre-dequantised bf16 weight (reads twice the "
                       "weight bytes)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": {"tile": f"{plan.bt} tokens x {w8.BN} rows", "split": plan.split,
                     "stages": plan.stages, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes, **regs["w8_matmul"].get(str(plan.bt), {}),
        })
    return rows


def _denoise_eps(pipe, unet, cn, args) -> torch.Tensor:
    """One denoise step's noise prediction at the first timestep."""
    state = pipe.scheduler.set_timesteps(5)
    with torch.inference_mode():
        x = args["latents"].permute(0, 3, 1, 2) * float(state.init_noise_sigma)
        x = pipe.scheduler.scale_model_input(state, x.contiguous(), 0).to(pipe.dtype)
        t = torch.full((1,), float(state.timesteps[0]), device="cuda")
        cond = args["tiled_u8"].permute(0, 3, 1, 2).to(pipe.dtype).contiguous() / 255.0
        down, mid = cn(x, t, args["prompt_embeds"], cond, cond_is_embedded=False)
        return unet(x, t, args["prompt_embeds"], down, mid).float()


def opt_path_phase() -> dict:
    """The control step under the opt-in backends, its launches pinned, and
    each kernel held in place against the library path."""
    import copy

    from genima_torch.eval.main_path import build_main_path
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import packed_attention as pa
    from genima_torch.kernels import w8_matmul as w8
    from genima_torch.nn.layers import set_attention_backend
    from genima_torch.weights.quantize import dequantize_dense_tree

    t0 = time.time()
    step, args = build_main_path(device="cuda", seed=0, backend=OPT_BACKEND,
                                 conv_backend=OPT_CONV_BACKEND)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    counters = {"B1": pa.packed_flash_attention, "B3": fa.flash_attention,
                "B4": fc.fused_conv3x3, "B5": w8.w8_matmul}
    for fn in counters.values():
        fn.launches = 0
        fn.launches_by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, per_step = [], [], []
    for _ in range(OPT_STEPS):
        before = {k: fn.launches for k, fn in counters.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        actions, target = step(**args)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
        if per_step[-1] != OPT_LAUNCHES:
            raise AssertionError(f"opt-in step launches {per_step[-1]}, want {OPT_LAUNCHES}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches_by_shape = {
        k: {"x".join(map(str, s)): n for s, n in fn.launches_by_shape.items()}
        for k, fn in counters.items()
    }
    if actions.shape != (1, 20, 8) or not torch.isfinite(actions).all():
        raise AssertionError(f"actions {tuple(actions.shape)} finite={torch.isfinite(actions).all()}")
    if target.shape != (1, 512, 512, 3) or target.dtype != torch.uint8:
        raise AssertionError(f"target {tuple(target.shape)} {target.dtype}")

    pipe = step.pipe
    params = args["diffusion_params"]
    unet, cn = params["unet"], params["controlnet"]
    eps = {"pallas+w8": _denoise_eps(pipe, unet, cn, args)}
    for m in (unet, cn):  # (a) B3 in place: the library attention, same int8 weights
        set_attention_backend(m, "xla+w8")
    eps["xla+w8"] = _denoise_eps(pipe, unet, cn, args)
    for m in (unet, cn):
        set_attention_backend(m, OPT_BACKEND)
    # (b) B5 in place: float models on the dequantised weights w_q * scale
    f_unet, f_cn = (dequantize_dense_tree(copy.deepcopy(m)) for m in (unet, cn))
    for m in (f_unet, f_cn):
        set_attention_backend(m, "xla")
    eps["xla"] = _denoise_eps(pipe, f_unet, f_cn, args)
    del f_unet, f_cn
    # (c) B4 in place: the fused decode against the default decoder
    vae = params["vae"]
    z = args["latents"].permute(0, 3, 1, 2).contiguous().to(pipe.dtype)
    with torch.inference_mode():
        fused_img = vae.decode(z).float()
        vae.decoder.conv_backend = "xla"
        xla_img = vae.decode(z).float()
        vae.decoder.conv_backend = OPT_CONV_BACKEND
    errs = {
        "eps_pallas_vs_library_attention_same_int8": _rel_err(eps["pallas+w8"], eps["xla+w8"]),
        "eps_int8_vs_dequantised_float": _rel_err(eps["xla+w8"], eps["xla"]),
        "vae_fused_vs_default_decode": _rel_err(fused_img, xla_img),
    }
    finite = all(torch.isfinite(t).all() for t in (*eps.values(), fused_img))
    if not (finite and all(e <= OPT_REL_TOL for e in errs.values())):
        raise AssertionError(f"opt-in path vs library path: {errs} (finite={finite})")
    return {
        "backend": OPT_BACKEND, "conv_backend": OPT_CONV_BACKEND,
        "setup_s": setup_s, "step_ms": step_ms, "host_step_ms": host_ms,
        "launches_per_step": per_step, "launches_by_shape": launches_by_shape,
        **errs,
        "actions_abs_max": actions.abs().max().item(),
        "target_mean": target.float().mean().item(),
        "peak_mem_gb": peak_gb,
    }


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


def per_step_sums(rows) -> dict:
    """Per path and kernel, launches per step x ms summed over its shapes,
    beside the same sum of its bound and of its library yardstick: (path,
    row, steps the row's launches were counted over)."""
    out: dict[str, dict] = {}
    for path, row, steps in rows:
        d = out.setdefault(path, {}).setdefault(
            row["name"], {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "launches": 0})
        per = row["launches"] / steps
        d["launches"] += per
        d["ms"] += per * row["ms"]
        d["bound_ms"] += per * row["bound_ms"]
        d["library_ms"] += per * row["library_ms"]
    return out


def _fill_launches(rows, launches_by_shape: dict, counter: dict) -> None:
    """Each row's launches on its path, from the counter of its kernel
    (``counter[name]``) by shape key; a kernel the path never launched at
    a row's shape fails the run."""
    for row in rows:
        row["launches"] = launches_by_shape[counter[row["name"]]].get(row.pop("key"), 0)
        if row["launches"] == 0:
            raise AssertionError(f"kernel {row['name']} {row['shape']} never launched")


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
    _build.build_all(KERNEL_SOURCES)
    print(f"built kernels in {time.time() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for key, report in ptxas_report(_build.build_log(name)).items():
            print(f"  {name} <{key}>: {json.dumps(report)}")

    kernels = kernel_phase(pa)
    train_kernels = training_kernel_phase(pa)
    opt_kernels = opt_kernel_phase()
    path = path_phase(pa)
    _fill_launches(kernels, {"B1": path["launches_by_shape"]}, {"packed_flash_attention": "B1"})
    print("path " + json.dumps(path))
    train = train_phase(pa)
    _fill_launches(train_kernels, train["launches_by_shape"], {
        "packed_flash_attention": "B1", "packed_attention_forward_lse": "B2a",
        "packed_attention_backward": "B2b"})
    print("train " + json.dumps(train))
    opt = opt_path_phase()
    _fill_launches(opt_kernels, opt["launches_by_shape"],
                   {"flash_attention": "B3", "fused_conv3x3": "B4", "w8_matmul": "B5"})
    print("opt_path " + json.dumps(opt))
    print("per_step " + json.dumps(per_step_sums(
        [("control", r, PATH_STEPS) for r in kernels]
        + [("train", r, TRAIN_STEPS) for r in train_kernels]
        + [("opt_in", r, OPT_STEPS) for r in opt_kernels])))
    print(json.dumps({"kernels": kernels + train_kernels + opt_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
