"""Time every launch plan of B3 (flash attention), B4 (fused conv) or B5
(int8 matmul) at the opt-in serving path's shapes, of B1/B2a (the packed
forward) at the serving and the trainer's shapes, or B2b (the flash
backward) at the trainer's, beside the plan the wrapper picks. The attention
modes also take SD-1.5's head dims (40/80/160) and the SD levels at 768x768
(9216 and 2304 tokens).

    python -m genima_torch.tune_kernels {attn,packed,bwd,w8,conv}

Run from the repository root: the shapes and the timer are
``chip_smoke.py``'s (``FLASH_SHAPES``/``SD15_FLASH_SHAPES``/``SD_LEVELS``/
``TRAIN_LEVELS``/``SD15_LEVELS``/``SD768_LEVELS``/``W8_SHAPES``/
``CONV_SHAPES``, ``cuda_ms``). Prints one JSON line per shape:
ms of each candidate plan, of the default plan, and of the library yardstick
(``scaled_dot_product_attention`` forward for B1/B2a/B3, its autograd
backward for B2b, ``torch.matmul`` on the dequantised weight for B5). Needs
a GPU; this is how the plans' rules were chosen.
"""

from __future__ import annotations

import json
import sys

import torch


def tune_attn(shapes, cuda_ms) -> None:
    import torch.nn.functional as F

    from genima_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, sq, sk, c, h in shapes:
        hd = c // h
        q, k, v = (torch.randn(b, s, h, hd, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        times = {}
        for nwg, bn in fa.tiles_for(hd):
            tiles = -(-sk // bn)
            if bn == 80 and sk > 80:  # the 80-key tile is for the 77 prompt tokens
                continue
            deepest = fa.max_stages(nwg, bn, fa.head_atoms(hd))
            for stages in range(2 if tiles > 1 else 1, min(tiles, deepest) + 1):
                p = fa.make_plan(b, sq, sk, h, nwg, bn, stages, d=hd)
                fa._plan_for = lambda *a, p=p: p
                times[f"{nwg}wg/bn{bn}/stages{stages}"] = cuda_ms(
                    lambda: fa.flash_attention(q, k, v), 50)
        fa._plan_for = lambda *a: fa.plan(*a)
        d = fa.plan(b, sq, sk, h, hd)
        print(json.dumps({
            "shape": f"{b}x{sq}x{sk}x{c}/{h}",
            "default": f"{d.nwg}wg/bn{d.bn}/stages{d.stages}",
            "default_ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 50),
            "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "plans_ms": times}))


def tune_packed(shapes, cuda_ms) -> None:
    """B1 and B2a (which take one plan) at every candidate plan of
    ``forward_plan`` and at the default one; SDPA's forward beside them."""
    import torch.nn.functional as F

    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import packed_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(3)
    for b, s, c, h in shapes:
        q, k, v = (torch.randn(b, s, c, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        heads = [x.view(b, s, h, c // h).transpose(1, 2) for x in (q, k, v)]
        times, lse_times = {}, {}
        hd = c // h
        for nwg, bn in pa.forward_tiles(hd):
            tiles = -(-s // bn)
            deepest = fa.max_stages(nwg, bn, fa.head_atoms(hd))
            for stages in range(2 if tiles > 1 else 1, min(tiles, deepest) + 1):
                p = pa.make_forward_plan(b, s, s, h, nwg, bn, stages, d=hd)
                pa._plan_for = lambda *a, p=p: p
                name = f"{nwg}wg/bn{bn}/stages{stages}"
                times[name] = cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), 50)
                lse_times[name] = cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 50)
        pa._plan_for = lambda *a: pa.forward_plan(*a)
        d = pa.forward_plan(b, s, s, h, hd)
        print(json.dumps({
            "shape": f"{b}x{s}x{c}/{h}", "default": f"{d.nwg}wg/bn{d.bn}/stages{d.stages}",
            "default_ms": cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), 50),
            "default_lse_ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 50),
            "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "plans_ms": times, "plans_lse_ms": lse_times}))


def _kernel_ms(fn, calls: int = 20) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key[:60]] = us / 1e3 / calls
    return out


def tune_bwd(shapes, cuda_ms) -> None:
    """B2b has one plan a head dim (two 128-row kernels, a ring): timed beside
    SDPA's backward and B2a, the forward that feeds it, with the device time
    of each of its two kernels."""
    import torch.nn.functional as F

    from genima_torch.kernels import packed_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, s, c, h in shapes:
        q, k, v, do = (torch.randn(b, s, c, generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        leaves = [x.view(b, s, h, c // h).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        go = do.view(b, s, h, c // h).transpose(1, 2)

        def backward():
            return pa.packed_attention_backward(q, k, v, o, lse, do, h)

        print(json.dumps({
            "shape": f"{b}x{s}x{c}/{h}",
            "backward_ms": cuda_ms(backward, 50),
            "kernels_ms": _kernel_ms(backward),
            "sdpa_backward_ms": cuda_ms(
                lambda: torch.autograd.grad(out, leaves, go, retain_graph=True), 50),
            "forward_lse_ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 50)}))


def tune_w8(shapes, cuda_ms) -> None:
    from genima_torch.kernels import w8_matmul as w8

    default = w8._plan_for
    gen = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
        w_deq = (w_q.float() * scale[:, None]).bfloat16().t()
        k_tiles = -(-k // w8.BK)
        bts = [t for t in w8.TOKEN_TILES if m <= t][:1] or [64, 128]
        times = {}
        for bt in bts:
            for split in (1, 2, 3, 4, 6, 8):
                if split <= k_tiles:
                    p = w8.make_plan(m, k, n, bt, split)
                    w8._plan_for = lambda *a, p=p, **kw: p
                    times[f"bt{bt}/split{split}/stages{p.stages}"] = cuda_ms(
                        lambda: w8.w8_matmul(x, w_q, scale), 100)
        w8._plan_for = default
        d = w8.plan(m, k, n)
        print(json.dumps({
            "shape": f"{m}x{k}x{n}", "default": f"bt{d.bt}/split{d.split}/stages{d.stages}",
            "default_ms": cuda_ms(lambda: w8.w8_matmul(x, w_q, scale), 100),
            "matmul_ms": cuda_ms(lambda: torch.matmul(x, w_deq), 100), "plans_ms": times}))


def tune_conv(shapes, cuda_ms) -> None:
    from genima_torch.kernels import fused_conv as fc

    default = fc._plan_for
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, h, w, c, o in shapes:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").bfloat16()
        scale, shift = fc.fold_group_norm(
            x, 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda"),
            0.2 * torch.randn(c, generator=gen, device="cuda"), 32, 1e-6)
        wt = (torch.randn(3, 3, c, o, generator=gen, device="cuda") / (3 * c ** 0.5)).bfloat16()
        bias = torch.randn(o, generator=gen, device="cuda").bfloat16()
        res = torch.randn(b, h, w, o, generator=gen, device="cuda").bfloat16() if c == o else None
        args = (x, wt, bias, scale, shift, None, res)
        times = {}
        for bn, rows in fc.TILES:
            if (bn == 16) == (o <= 16):
                p = fc.make_plan(b, h, w, c, o, bn, rows)
                fc._plan_for = lambda *a, p=p, **kw: p
                times[f"{bn}x{rows}"] = cuda_ms(lambda: fc.fused_conv3x3(*args), 20)
        fc._plan_for = default
        d = fc.plan(b, h, w, c, o)
        print(json.dumps({"shape": f"{b}x{h}x{w}x{c}->{o}", "default": f"{d.bn}x{d.rows}",
                          "plans_ms": times}))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in (["attn"], ["packed"], ["bwd"], ["w8"], ["conv"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tune_kernels needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke

    if argv == ["attn"]:
        tune_attn(chip_smoke.FLASH_SHAPES + chip_smoke.SD15_FLASH_SHAPES, chip_smoke.cuda_ms)
    elif argv == ["packed"]:
        tune_packed(chip_smoke.SD_LEVELS + chip_smoke.TRAIN_LEVELS + chip_smoke.SD15_LEVELS
                    + chip_smoke.SD15_TRAIN_LEVELS + chip_smoke.SD768_LEVELS, chip_smoke.cuda_ms)
    elif argv == ["bwd"]:
        tune_bwd(chip_smoke.TRAIN_LEVELS + chip_smoke.SD15_TRAIN_LEVELS
                 + chip_smoke.SD768_TRAIN_LEVELS, chip_smoke.cuda_ms)
    elif argv == ["w8"]:
        tune_w8(chip_smoke.W8_SHAPES, chip_smoke.cuda_ms)
    else:
        tune_conv(chip_smoke.CONV_SHAPES, chip_smoke.cuda_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
