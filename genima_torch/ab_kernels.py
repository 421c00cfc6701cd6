"""Time the packed attention kernels of another checkout against this one.

    python -m genima_torch.ab_kernels OTHER_DIR [--profile | --f32 | --wide]

Run from the repository root on a GPU host, with ``OTHER_DIR`` a second
checkout (``git archive <commit> | tar -x -C OTHER_DIR``). Four processes
run in turns, the other tree, this one, this one, the other tree, so both
see the same card and its drift; each builds its own kernels and times B1,
B2a and B2b at ``chip_smoke.py``'s trainer levels (batch 4) and B1 at the
serving levels by CUDA events (``chip_smoke.cuda_ms``), or with
``--profile`` B2b's two kernels by ``torch.profiler``, or with ``--f32``
the f32 kernels on f32 inputs (TF32 off): B1 at the serving levels, B2a and
B2b at the trainer levels, B3 (self-attention and the 77 prompt keys), B4
and B5 at the opt-in path's shapes, or with ``--wide`` the wide kernels
(heads past 256 columns) in bf16 and f32 (TF32 off): B1 at the wide-head
path's serving levels (``chip_smoke.WIDE_LEVELS``), B1, B2a and B2b at its
trainer levels, B3 at its opt-in shapes (self-attention and the 77 prompt
keys), and at every d of ``chip_smoke.WIDE_SWEEP_DIMS`` B1 at 1 x 4096 in
one head, B2a and B2b at 4 x 1024 and B3 over 1000 queries (self and 77
keys) in ``chip_smoke._sweep_heads(d)`` heads. Prints each key's times on
both sides and this tree's over the other's.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CODE = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from genima_torch.kernels import _build, packed_attention as pa
from genima_torch.tune_kernels import _kernel_ms
_build.build_all(["packed_attention", "packed_attention_bwd"])
gen = torch.Generator(device="cuda").manual_seed(1)
out = {}
for b, s, c, h in cs.TRAIN_LEVELS + cs.SD_LEVELS:
    q, k, v, do = (torch.randn(b, s, c, generator=gen, device="cuda").bfloat16() for _ in range(4))
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    key = f"{b}x{s}x{c}/{h}"
    bwd = lambda: pa.packed_attention_backward(q, k, v, o, lse, do, h)
    if PROFILE:
        if b > 1:
            for name, ms in _kernel_ms(bwd, 50).items():
                if "bwd" in name:
                    out[f"B2b {'dkdv' if 'dkdv' in name else 'dq'} {key}"] = ms
        continue
    out["B1 " + key] = cs.cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), 100)
    if b > 1:
        out["B2a " + key] = cs.cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 100)
        out["B2b " + key] = cs.cuda_ms(bwd, 100)
print("RESULT " + json.dumps(out))
'''


F32_CODE = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from genima_torch.kernels import _build, fused_conv as fc, w8_matmul as w8
from genima_torch.kernels import flash_attention as fa, packed_attention as pa
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
_build.build_all(["fused_conv", "w8_matmul", "packed_attention", "packed_attention_bwd",
                  "flash_attention"])
gen = torch.Generator(device="cuda").manual_seed(1)
out = {}
for b, s, c, h in cs.SD_LEVELS + cs.TRAIN_LEVELS:
    q, k, v, do = (torch.randn(b, s, c, generator=gen, device="cuda") for _ in range(4))
    key = f"{b}x{s}x{c}/{h}"
    if b == 1:
        out["B1 f32 " + key] = cs.cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), 20)
        continue
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    out["B2a f32 " + key] = cs.cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 20)
    out["B2b f32 " + key] = cs.cuda_ms(
        lambda: pa.packed_attention_backward(q, k, v, o, lse, do, h), 10)
for b, sq, sk, c, h in cs.FLASH_SHAPES:
    q, k, v = (torch.randn(b, x, h, c // h, generator=gen, device="cuda") for x in (sq, sk, sk))
    out[f"B3 f32 {b}x{sq}x{sk}x{c}/{h}"] = cs.cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
for b, h, w, c, o in cs.CONV_SHAPES:
    x = torch.randn(b, h, w, c, generator=gen, device="cuda")
    scale, shift = fc.fold_group_norm(x, 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda"),
                                      0.2 * torch.randn(c, generator=gen, device="cuda"), 32, 1e-6)
    args = (x, torch.randn(3, 3, c, o, generator=gen, device="cuda") / (3 * c ** 0.5),
            torch.randn(o, generator=gen, device="cuda"), scale, shift, None,
            torch.randn(b, h, w, o, generator=gen, device="cuda") if c == o else None)
    out[f"B4 f32 {b}x{h}x{w}x{c}->{o}"] = cs.cuda_ms(lambda: fc.fused_conv3x3(*args), 10)
for m, k, n in cs.W8_SHAPES:
    x = torch.randn(m, k, generator=gen, device="cuda")
    w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
    out[f"B5 f32 {m}x{k}x{n}"] = cs.cuda_ms(lambda: w8.w8_matmul(x, w_q, scale), 50)
print("RESULT " + json.dumps(out))
'''


WIDE_CODE = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from genima_torch.kernels import _build, flash_attention as fa, packed_attention as pa
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
_build.build_all(["packed_attention", "flash_attention", "packed_attention_bwd"])
gen = torch.Generator(device="cuda").manual_seed(1)
out = {}
for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
    iters = 20 if dtype == torch.bfloat16 else 10
    packed = [(b, s, c, h, "") for b, s, c, h in cs.WIDE_LEVELS + cs.WIDE_TRAIN_LEVELS]
    flash = [(b, sq, sk, c, h, "") for b, sq, sk, c, h in cs.WIDE_FLASH_SHAPES]
    for d in cs.WIDE_SWEEP_DIMS:
        h = cs._sweep_heads(d)
        packed += [(1, 4096, d, 1, " sweep"), (cs.TRAIN_BATCH, 1024, h * d, h, " sweep")]
        flash += [(1, 1000, 1000, h * d, h, " sweep"), (1, 1000, cs.CONTEXT[0], h * d, h, " sweep")]
    for b, s, c, h, what in packed:
        q, k, v = (torch.randn(b, s, c, generator=gen, device="cuda").to(dtype) for _ in range(3))
        key = f"{tag} {b}x{s}x{c}/{h} d {c // h}{what}"
        if b == 1 or not what:
            out["B1 " + key] = cs.cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), iters)
        if b > 1:
            out["B2a " + key] = cs.cuda_ms(
                lambda: pa.packed_attention_forward_lse(q, k, v, h), iters)
            do = torch.randn(b, s, c, generator=gen, device="cuda").to(dtype)
            o, lse = pa.packed_attention_forward_lse(q, k, v, h)
            out["B2b " + key] = cs.cuda_ms(
                lambda: pa.packed_attention_backward(q, k, v, o, lse, do, h), iters)
    for b, sq, sk, c, h, what in flash:
        q, k, v = (torch.randn(b, x, h, c // h, generator=gen, device="cuda").to(dtype)
                   for x in (sq, sk, sk))
        out[f"B3 {tag} {b}x{sq}x{sk}x{c}/{h} d {c // h}{what}"] = cs.cuda_ms(
            lambda: fa.flash_attention(q, k, v), iters)
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other, here = str(Path(argv[0]).resolve()), str(Path.cwd())
    if "--f32" in argv:
        code = F32_CODE
    elif "--wide" in argv:
        code = WIDE_CODE
    else:
        code = f"PROFILE = {'--profile' in argv}\n" + CODE
    runs = []
    for tree in (other, here, here, other):
        r = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                           text=True)
        line = next((x for x in r.stdout.splitlines() if x.startswith("RESULT ")), None)
        if line is None:
            print(tree, r.stdout[-2000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append((tree, json.loads(line[len("RESULT "):])))
    for key in runs[0][1]:
        a = [r[key] for t, r in runs if t == other]
        b = [r[key] for t, r in runs if t == here]
        print(json.dumps({"key": key, "other_ms": a, "this_ms": b,
                          "this_over_other": sum(b) / sum(a)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
