"""Time every launch plan of B4 (fused conv) or B5 (int8 matmul) at the
opt-in serving path's shapes, beside the plan the wrapper picks.

    python -m genima_torch.tune_kernels {w8,conv}

Run from the repository root: the shapes and the timer are
``chip_smoke.py``'s (``W8_SHAPES``/``CONV_SHAPES``, ``cuda_ms``). Prints one
JSON line per shape: ms of each candidate plan, of the default plan, and of
the library yardstick (``torch.matmul`` on the dequantised weight for B5).
Needs a GPU; this is how the plans' rules were chosen.
"""

from __future__ import annotations

import json
import sys

import torch


def tune_w8(shapes, cuda_ms) -> None:
    from genima_torch.kernels import w8_matmul as w8

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
                    w8._plan_for = lambda *a, p=p: p
                    times[f"bt{bt}/split{split}/stages{p.stages}"] = cuda_ms(
                        lambda: w8.w8_matmul(x, w_q, scale), 100)
        w8._plan_for = lambda *a: w8.plan(*a)
        d = w8.plan(m, k, n)
        print(json.dumps({
            "shape": f"{m}x{k}x{n}", "default": f"bt{d.bt}/split{d.split}/stages{d.stages}",
            "default_ms": cuda_ms(lambda: w8.w8_matmul(x, w_q, scale), 100),
            "matmul_ms": cuda_ms(lambda: torch.matmul(x, w_deq), 100), "plans_ms": times}))


def tune_conv(shapes, cuda_ms) -> None:
    from genima_torch.kernels import fused_conv as fc

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
                fc._plan_for = lambda *a, p=p: p
                times[f"{bn}x{rows}"] = cuda_ms(lambda: fc.fused_conv3x3(*args), 20)
        fc._plan_for = lambda *a: fc.plan(*a)
        d = fc.plan(b, h, w, c, o)
        print(json.dumps({"shape": f"{b}x{h}x{w}x{c}->{o}", "default": f"{d.bn}x{d.rows}",
                          "plans_ms": times}))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in (["w8"], ["conv"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tune_kernels needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke

    if argv == ["w8"]:
        tune_w8(chip_smoke.W8_SHAPES, chip_smoke.cuda_ms)
    else:
        tune_conv(chip_smoke.CONV_SHAPES, chip_smoke.cuda_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
