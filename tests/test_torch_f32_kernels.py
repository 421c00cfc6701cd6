"""Float32 through the port's kernels, on the CPU.

- The f32 launch plans fit the card: at every head dim from 1 to 256 and at
  every shape the f32 paths pin, each block's shared memory is within the
  232,448 bytes a block may take and its tile is one the sources
  instantiate (the card tests hold the sources' own counts to these).
- The wrappers' checks take f32 (and bf16) and still refuse f16 and f64,
  and mixed dtypes.
- ``SDControlNetAgent(dtype=torch.float32)`` (and its SDXL and pix2pix
  subclasses) builds an f32 pipeline and keeps an f32 tree, as JAX's
  ``DiffusionAgent.dtype`` does; on the tiny config its ``infer`` on seeded
  numpy inputs matches JAX's ``make_tiny_sd_agent(dtype=float32)`` within
  one uint8 level (the two attention paths and the conv orders differ at
  f32 rounding, which can move a pixel across a level).
- ``build_main_path(dtype=...)`` hands the dtype to the pipeline.
- The f32 B4 kernel's 3xTF32 arithmetic, emulated in plain PyTorch: each
  f32 operand split into tf32(a) and tf32(a - tf32(a)) (TF32 rounding done
  on the bits), three products summed in f32, lands within 1e-6 of max
  |y| of the f64 sums at K = 9 x 512, where one TF32 pass misses the
  kernels' 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.eval.agents import make_tiny_sd_agent as jax_make_tiny_sd_agent

from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval import main_path
from genima_torch.eval.agents import SDControlNetAgent, SDPix2PixAgent, SDXLControlNetAgent
from genima_torch.kernels import flash_attention as fa
from genima_torch.kernels import fused_conv as fc
from genima_torch.kernels import packed_attention as pa
from genima_torch.kernels import w8_matmul as w8
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

SMEM_BLOCK = 232448  # dynamic shared memory one block may take on an H100
F32 = torch.float32
F32_TOL = 1e-4  # the f32 kernels' limit against their plain versions, of max |y|

# (B, S, C, heads) the f32 paths and checks give B1/B2a/B2b: SD's levels
# (SDXL's 1024 and 256 tokens among them) at batch 1, 2 and 4, SD-1.5's and
# 768x768's
ATTN_SHAPES = [(b, s, c, h) for b in (1, 2, 4)
               for s, c, h in ((4096, 320, 5), (1024, 640, 10), (256, 1280, 20))] + [
    (b, s, c, 8) for b in (1, 4) for s, c in ((4096, 320), (1024, 640), (256, 1280))] + [
    (b, s, c, h) for b in (1, 4) for s, c, h in ((9216, 320, 5), (2304, 640, 10))]
# B3 (B, Sq, Sk, C, heads): self-attention and the 77 prompt keys at the
# opt-in path's four levels
FLASH_SHAPES = [(1, s, k, c, h) for s, c, h in ((4096, 320, 5), (1024, 640, 10), (256, 1280, 20),
                                                (64, 1280, 20)) for k in (s, 77)]
# B4 (B, H, W, C, O): the SD VAE decoder at 512^2
CONV_SHAPES = [(1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 256),
               (1, 256, 256, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
               (1, 512, 512, 128, 3)]
# B5 (M, K, N): the opt-in path's int8 linears
W8_SHAPES = [(m, k, n) for m, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
             for k, n in ((c, c), (c, 8 * c), (4 * c, c))] + [(77, 1024, c) for c in (320, 640, 1280)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_f32_attention_plans_fit_at_every_head_dim():
    for d in range(1, 257):
        atoms = fa.head_atoms(d)
        dp = fa.f32_padded_head_dim(d)
        assert dp % 4 == 0 and d <= dp < d + 4 and fa.head_atoms(dp) == atoms, d
        for plan in (fa._plan_for(1, 1000, 77, 8, d, dtype=F32),
                     pa._plan_for(4, 1024, 1024, 8, d, dtype=F32)):
            assert isinstance(plan, fa.F32Plan) and plan.atoms == atoms and 1 <= atoms <= 4, d
            assert (plan.nwg, plan.bn) in fa.F32_TILES[atoms], d
            assert plan.rows == 64 * plan.nwg and plan.threads == 128 * plan.nwg + 128
            # Q, a ring of (K, its remainders, V) and 8-byte barriers, as fwd_smem_bytes
            slab_rows = 2 * atoms * fa.F32_SLAB_BYTES
            assert plan.smem_bytes == (1024 + plan.rows * slab_rows
                                       + plan.stages * 3 * plan.bn * slab_rows
                                       + 8 * (3 * plan.stages + 1)) <= SMEM_BLOCK, d
        bp = pa.backward_plan(4, 1024, 1024, 8, d, dtype=F32)
        assert bp.rows == 64 * pa.f32_backward_nwg(atoms) == (128 if atoms == 1 else 64), d
        assert bp.tile == 128 >> atoms and bp.passes == (2 if atoms >= 3 else 1), d
        assert max(bp.dq_smem_bytes, bp.dkdv_smem_bytes) <= SMEM_BLOCK, d
        # two resident tensors, a ring of four tiles (the dk/dv kernel's with a
        # tile's L * log2(e) and Drow) and its barriers, as bwd_smem_bytes
        slab_rows = 2 * atoms * fa.F32_SLAB_BYTES
        for smem, tile, stages, rows in ((bp.dq_smem_bytes, bp.tile, bp.stages, 0),
                                         (bp.dkdv_smem_bytes, bp.dkdv_tile, bp.dkdv_stages, 8)):
            assert smem == (1024 + 2 * bp.rows * slab_rows
                            + stages * (4 * tile * slab_rows + rows * tile)
                            + 8 * (3 * stages + 1)), d
        # the bf16 plans of the same head dim are untouched
        assert fa._plan_for(1, 1000, 77, 8, d) == fa.plan(1, 1000, 77, 8, d)


@pytest.mark.parametrize("b,s,c,h", ATTN_SHAPES)
def test_f32_packed_plans_at_the_pinned_shapes(b, s, c, h):
    plan = pa._plan_for(b, s, s, h, c // h, dtype=F32)
    assert plan.grid == (-(-s // plan.rows), h, b) and plan.smem_bytes <= SMEM_BLOCK
    assert plan.stages == 2 and (plan.nwg, plan.bn) == fa.F32_TILES[plan.atoms][0]
    bp = pa.backward_plan(b, s, s, h, c // h, dtype=F32)
    assert bp.dq_grid == (s // bp.rows, h, b) == bp.dkdv_grid
    assert bp.threads == 128 * bp.rows // 64 + 128
    assert max(bp.dq_smem_bytes, bp.dkdv_smem_bytes) <= SMEM_BLOCK


@pytest.mark.parametrize("b,sq,sk,c,h", FLASH_SHAPES)
def test_f32_flash_plans_at_the_pinned_shapes(b, sq, sk, c, h):
    plan = fa._plan_for(b, sq, sk, h, c // h, dtype=F32)
    assert plan.grid == (-(-sq // plan.rows), h, b) and plan.smem_bytes <= SMEM_BLOCK
    # the 77 prompt keys (and a 64-token self-attention) in one 80-key tile
    assert (plan.nwg, plan.bn, plan.stages) == ((1, 80, 1) if sk <= 80 else (2, 64, 2))


# B5's f32 plans at the pinned shapes: (token tile, K split), and the grid
# (N tiles, token tiles, split) that follows
W8_F32_PLANS = {
    (4096, 320, 320): (64, 1), (4096, 320, 2560): (64, 1), (4096, 1280, 320): (64, 1),
    (1024, 640, 640): (64, 1), (1024, 640, 5120): (64, 1), (1024, 2560, 640): (64, 1),
    (256, 1280, 1280): (64, 1), (256, 1280, 10240): (64, 1), (256, 5120, 1280): (64, 1),
    (64, 1280, 1280): (64, 4), (64, 1280, 10240): (64, 1), (64, 5120, 1280): (64, 4),
    (77, 1024, 320): (80, 8), (77, 1024, 640): (80, 7), (77, 1024, 1280): (80, 4),
}
HALF_WAVE = -(-w8.SMS // 2)
SMEM_TWO_BLOCKS = 115712  # each of two blocks that share an SM


def test_f32_conv_and_w8_plans_at_the_pinned_shapes():
    for b, hh, ww, c, o in CONV_SHAPES:
        plan = fc._plan_for(b, hh, ww, c, o, dtype=F32)
        assert plan.f32 and (plan.bn, plan.rows) == ((16, 4) if o <= 16 else (128, 2))
        band = -(-(plan.rows + 2) * 66 * 32 * 4 // 1024) * 1024  # 32 f32 channels a pixel
        smem = 1024 + 2 * band + 4 * 2 * plan.bn * 32 * 4 + 8 * 16  # as F32Cfg::smem_bytes
        assert plan.smem_bytes == fc.smem_bytes(plan.bn, plan.rows, f32=True) == smem <= SMEM_BLOCK
        assert plan.tiles == (-(-hh // plan.rows) * -(-ww // 64), -(-o // plan.bn), b)
        assert plan.chunks == -(-c // 32) and plan.blocks == min(plan.n_tiles, fc.SMS)
    assert set(W8_F32_PLANS) == set(W8_SHAPES)
    for (m, k, n), (bt, split) in W8_F32_PLANS.items():
        plan = w8._plan_for(m, k, n, dtype=F32)
        assert plan.f32 and (plan.bt, plan.split) == (bt, split), (m, k, n)
        assert plan.grid == (-(-n // 64), -(-m // bt), split)
        # as w8_matmul_f32_smem_bytes: the int8 W box and four f32 x boxes a stage
        smem = 1024 + plan.stages * (64 * 128 + 4 * bt * 128) + 16 * plan.stages + 16
        assert plan.smem_bytes == w8.smem_bytes(bt, plan.stages, f32=True) == smem <= SMEM_BLOCK
        if plan.blocks > w8.SMS:  # two blocks an SM
            assert plan.smem_bytes <= SMEM_TWO_BLOCKS
        if m <= 256:  # no longer 20-80 blocks walking K alone: half a wave, or every K tile split
            assert plan.blocks >= HALF_WAVE or plan.split == plan.k_tiles, (m, k, n)
    assert w8._plan_for(64, 5120, 1280, dtype=F32).blocks >= HALF_WAVE


@pytest.mark.parametrize("m,k,n", W8_SHAPES)
def test_f32_w8_plan_splits_k_like_the_bf16_one(m, k, n):
    """The f32 plan is the bf16 kernel's: the same K tiles and split ranges,
    a ring of at least two stages where a split walks two K tiles or more,
    and a split only while the tiles make under half a wave."""
    p, q = w8._plan_for(m, k, n, dtype=F32), w8.plan(m, k, n)
    assert p.k_tiles == q.k_tiles and p.k_ranges()[-1][1] == p.k_tiles
    longest = max(b - a for a, b in p.k_ranges())
    assert p.stages >= (2 if longest > 1 else 1) and p.stages <= max(longest, 2)
    assert (p.split > 1) == (p.tiles < HALF_WAVE)
    assert p.workspace_floats == (p.split * p.tiles * 64 * p.bt if p.split > 1 else 0)


def _inputs(name, dtype):
    """A call of each wrapper's input checks on CPU tensors of ``dtype``."""
    if name == "packed":
        q = torch.zeros(1, 256, 128, dtype=dtype)
        return lambda: pa._check_cuda_inputs(q, q, q, 2)
    if name == "flash":
        q = torch.zeros(1, 77, 2, 40, dtype=dtype)
        return lambda: fa._check_cuda_inputs(q, q, q)
    if name == "conv":
        x = torch.zeros(1, 4, 4, 16, dtype=dtype)
        return lambda: fc._check_cuda_inputs(x, torch.zeros(3, 3, 16, 8), torch.zeros(8), None,
                                             None, None, None)
    x = torch.zeros(4, 32, dtype=dtype)
    return lambda: w8._check_cuda_inputs(x, torch.zeros(8, 32, dtype=torch.int8),
                                         torch.ones(8))


@pytest.mark.parametrize("name", ["packed", "flash", "conv", "w8"])
@pytest.mark.parametrize("dtype,ok", [(torch.float32, True), (torch.bfloat16, True),
                                      (torch.float16, False), (torch.float64, False)])
def test_wrappers_take_f32_and_refuse_f16_and_f64(name, dtype, ok):
    check = _inputs(name, dtype)
    if ok:
        check()
        return
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        check()


def test_attention_wrappers_refuse_mixed_dtypes():
    q, k = torch.zeros(1, 256, 128), torch.zeros(1, 256, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k must be torch.float32"):
        pa._check_cuda_inputs(q, k, q, 2)
    q4, v4 = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16), torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="v must be torch.bfloat16"):
        fa._check_cuda_inputs(q4, q4, v4)


def _tiny_pipeline(**kw):
    return SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), **kw)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cls", [SDControlNetAgent, SDXLControlNetAgent, SDPix2PixAgent])
def test_every_agent_hands_its_dtype_to_the_pipeline(monkeypatch, cls):
    seen = []

    def record(**kw):
        seen.append(kw)
        raise _Stop

    monkeypatch.setattr(cls, "PIPELINE", staticmethod(record))
    for dtype in (torch.float32, None):
        with pytest.raises(_Stop):
            cls(dtype=dtype, device="cpu")
    assert seen[0]["dtype"] is torch.float32 and "dtype" not in seen[1]


def test_f32_agent_builds_an_f32_pipeline_and_keeps_an_f32_tree(monkeypatch):
    monkeypatch.setattr(SDControlNetAgent, "PIPELINE", staticmethod(_tiny_pipeline))
    agent = SDControlNetAgent(dtype=torch.float32, device="cpu", resolution=32)
    assert agent.pipe.dtype == agent.dtype == torch.float32
    for name, module in agent.params.items():
        dtypes = {t.dtype for t in module.state_dict().values() if t.is_floating_point()}
        assert dtypes == {torch.float32}, name
    # None keeps the pipeline's default; a dtype that contradicts a given pipe raises
    assert SDControlNetAgent(device="cpu", resolution=32).dtype == torch.float32
    with pytest.raises(ValueError, match="does not match"):
        SDControlNetAgent(pipe=agent.pipe, params=agent.params, dtype=torch.bfloat16)


def test_f32_agent_infer_matches_jax(monkeypatch):
    """Both agents on one f32 tree (JAX's seeded init, the ControlNet's zero
    convs redrawn so that its residuals shape the output), the same latents
    injected and the same prompt through each package's tokenizer and CLIP."""
    jagent = jax_make_tiny_sd_agent(resolution=32, dtype=jnp.float32, seed=3)
    leaves = jax.tree_util.tree_leaves(jagent.params)
    assert {x.dtype for x in leaves} == {np.dtype(np.float32)}  # JAX keeps an f32 tree f32
    rng = np.random.RandomState(5)
    cn = dict(jagent.params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    jagent.params = {**jagent.params, "controlnet": cn}

    monkeypatch.setattr(SDControlNetAgent, "PIPELINE", staticmethod(_tiny_pipeline))
    agent = SDControlNetAgent(dtype=torch.float32, device="cpu", resolution=32, seed=3,
                              params={})  # weights from JAX below
    agent.params = agent.pipe.params_from_jax(jax.tree_util.tree_map(np.asarray, jagent.params))
    latents = rng.randn(1, 16, 16, 4).astype(np.float32)
    agent._next_latents = lambda batch: torch.from_numpy(latents)
    jagent._next_latents = lambda batch: jnp.asarray(latents)
    images = rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    got = agent.infer(images, ["reach the red target"], num_inference_steps=2)
    want = jagent.infer(images, ["reach the red target"], num_inference_steps=2)
    assert got.shape == want.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1, f"targets differ by {diff.max()} levels"


def test_build_main_path_hands_the_dtype_to_the_pipeline(monkeypatch):
    seen = []

    def record(**kw):
        seen.append(kw)
        raise _Stop

    monkeypatch.setattr(main_path.SD15ControlNetAgent, "PIPELINE", staticmethod(record))
    for dtype in (torch.float32, None):
        with pytest.raises(_Stop):
            main_path.build_main_path(device="cpu", variant="sd15", dtype=dtype,
                                      backend="pallas+w8", conv_backend="fused")
    assert seen[0] == {"device": "cpu", "backend": "pallas+w8", "conv_backend": "fused",
                       "dtype": torch.float32}
    assert "dtype" not in seen[1]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits, nearest, ties away from zero:
    ``cvt.rna.tf32.f32``) on the bits."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(t: torch.Tensor) -> torch.Tensor:
    """f32 with its low 13 bits cleared: the big part of the attention
    kernels' split, and what the tensor cores read of any f32 operand."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the attention kernels take it: each operand split into big =
    its low 13 bits cleared and small = the rest (exact in f32), of which
    the tensor cores read 19 bits again; three products summed in f32."""
    a_big, b_big = _trunc(a), _trunc(b)
    a_small, b_small = _trunc(a - a_big), _trunc(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return _tf32(a) @ _tf32(b)


# the mma.sync products of a tile take k = t and t + 4 of each 8-key slice
# from keys 2t and 2t + 1, the order the S accumulator holds P in
KEY_ORDER = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _slices(n: int) -> torch.Tensor:
    return (torch.arange(0, n, 8)[:, None] + KEY_ORDER).reshape(-1)


def _attention_fwd(q, k, v, mm, tile=64):
    """The f32 forward's arithmetic on one head: S = Q K^T, then per tile of
    keys an online softmax and P V into a fresh accumulator (keys taken in
    the kernel's k order), added in f32 to the rescaled running one."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    m = torch.full((q.shape[0], 1), -float("inf"))
    l = torch.zeros(q.shape[0], 1)
    o = torch.zeros(q.shape[0], v.shape[1])
    for k0 in range(0, k.shape[0], tile):
        s = mm(q, k[k0:k0 + tile].T) * scale
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        order = _slices(s.shape[1])
        o = o * alpha + mm(p[:, order], v[k0:k0 + tile][order])
        l = l * alpha + p.sum(dim=1, keepdim=True)
        m = m_new
    return o / l, (m + torch.log(l)).squeeze(1)


def _attention_bwd(q, k, v, o, lse, do, mm, tile=64):
    """The f32 backward's arithmetic on one head: dQ over tiles of keys, dK
    and dV over tiles of queries, each tile's sum in a fresh accumulator."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    drow = (do * o).sum(dim=1, keepdim=True)

    def ds_of(s, dp, lq, dr):
        p = torch.exp(s * scale - lq)
        return p, p * (dp - dr) * scale

    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], tile):
        kt, vt = k[k0:k0 + tile], v[k0:k0 + tile]
        _, ds = ds_of(mm(q, kt.T), mm(do, vt.T), lse[:, None], drow)
        order = _slices(ds.shape[1])
        dq = dq + mm(ds[:, order], kt[order])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, q.shape[0], tile):
        qt, dot = q[q0:q0 + tile], do[q0:q0 + tile]
        p_t, ds_t = ds_of(mm(k, qt.T), mm(v, dot.T), lse[None, q0:q0 + tile],
                          drow[q0:q0 + tile].T)
        order = _slices(p_t.shape[1])
        dv = dv + mm(p_t[:, order], dot[order])
        dk = dk + mm(ds_t[:, order], qt[order])
    return dq, dk, dv


@pytest.mark.parametrize("kind", ["randn", "silu", "wide", "attention_fwd", "attention_bwd"])
def test_3xtf32_split_keeps_f32_accuracy_where_one_pass_does_not(kind):
    rng = np.random.RandomState({"randn": 0, "silu": 1, "wide": 2, "attention_fwd": 3,
                                 "attention_bwd": 4}[kind])
    if kind.startswith("attention"):
        # one head of 64 columns at unit scale over 4096 keys, as the SD
        # path's 4096-token level
        sq = 64 if kind == "attention_fwd" else 128
        q, k, v, do = (torch.from_numpy(rng.randn(n, 64).astype(np.float32))
                       for n in (sq, 4096, 4096, sq))
        q64, k64, v64 = q.double(), k.double(), v.double()
        s64 = q64 @ k64.T / 8.0
        lse64 = torch.logsumexp(s64, dim=1)
        p64 = torch.exp(s64 - lse64[:, None])
        o64 = p64 @ v64
        if kind == "attention_fwd":
            def err(mm):
                o, lse = _attention_fwd(q, k, v, mm)
                return max((o.double() - o64).abs().max().item(),
                           (lse.double() - lse64).abs().max().item())
        else:
            do64 = do.double()
            ds64 = p64 * (do64 @ v64.T - (do64 * o64).sum(1, keepdim=True)) / 8.0
            want = (ds64 @ k64, ds64.T @ q64, p64.T @ do64)

            def err(mm):
                got = _attention_bwd(q, k, v, o64.float(), lse64.float(), do, mm)
                return max(((x.double() - y).abs().max() / y.abs().max()).item()
                           for x, y in zip(got, want))
        assert err(_mm3) <= 1e-5
        assert err(_mm1) > F32_TOL  # one TF32 pass fails the kernels' limit
        return
    k = 9 * 512  # a 3x3 conv's sum over 512 input channels
    a = rng.randn(64, k).astype(np.float32)
    if kind == "silu":  # the activated band, as B4 reads it
        a = a / (1 + np.exp(-a))
    if kind == "wide":  # values over many binades
        a = a * np.exp2(rng.randint(-8, 9, a.shape)).astype(np.float32)
    a = torch.from_numpy(a)
    b = torch.from_numpy((rng.randn(k, 16) / np.sqrt(k)).astype(np.float32))
    a_big, b_big = _tf32(a), _tf32(b)
    assert not (a_big.view(torch.int32) & 0x1FFF).any()  # 13 low bits cut
    assert torch.equal(a_big + (a - a_big), a)  # the remainder is exact in f32
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    want = a.double() @ b.double()

    def err(y):
        return ((y.double() - want).abs().max() / want.abs().max()).item()

    three = a_small @ b_big + a_big @ b_small + a_big @ b_big
    assert err(three) <= 1e-6
    assert err(a_big @ b_big) > F32_TOL  # one TF32 pass fails the kernels' limit


def _scaled_heads(x: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    """(B, S, heads * dp) -> (B, heads, S, dp)."""
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2)


@pytest.mark.parametrize("d,heads", [(1, 2), (3, 4), (6, 3), (37, 2), (62, 3)])
def test_f32_padded_heads_keep_the_real_columns(d, heads):
    """The f32 wrappers zero-pad a head dim off a multiple of 4 (TMA's
    16-byte rows) and hand the kernels the real d for the scale: attention,
    L and the three gradients computed as the kernels do on the padded
    layout (scale 1 / sqrt(d), the padded columns zero), then unpadded, are
    the plain versions' on the real columns, and nothing reaches the padded
    columns of any output."""
    dp = fa.f32_padded_head_dim(d)
    assert dp % 4 == 0 and dp > d  # every case here pads
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 128, heads * d).astype(np.float32))
                   for _ in range(4))
    qp, kp, vp, dop = (fa.pad_heads(x, d, dp) for x in (q, k, v, do))
    assert qp.shape == (2, 128, heads * dp)
    qh, kh, vh, doh = (_scaled_heads(x, heads, dp).double() for x in (qp, kp, vp, dop))
    scale = 1.0 / np.sqrt(d)  # scale_dim, not the padded width
    s = qh @ kh.transpose(-1, -2) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    oh = p @ vh
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True)) * scale
    grads = (ds @ kh, ds.transpose(-1, -2) @ qh, p.transpose(-1, -2) @ doh)
    for x in (oh, *grads):
        assert not x[..., d:].any()  # the padded columns stay zero
    packed = [x.transpose(1, 2).reshape(2, 128, heads * dp).float() for x in (oh, *grads)]
    o, dq, dk, dv = (fa.unpad_heads(x, d, dp) for x in packed)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, heads)
    assert o.shape == q.shape and (o - o_ref).abs().max().item() <= 1e-6
    assert (lse.transpose(1, 2).float() - lse_ref).abs().max().item() <= 1e-5
    want = pa.packed_attention_backward_reference(q, k, v, o_ref, lse_ref, do, heads)
    for x, y in zip((dq, dk, dv), want):
        assert x.shape == y.shape and ((x - y).abs().max() / y.abs().max()).item() <= 1e-5
    # B3's (B, S, H, D) layout pads and unpads the same way
    x4 = q.reshape(2, 128, heads, d)
    assert torch.equal(fa.unpad_heads(fa.pad_heads(x4, d, dp), d, dp), x4)
