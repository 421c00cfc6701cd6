"""The port's fused GN-SiLU-conv3x3 (B4): its plain version against the JAX
Pallas kernel (whole-image interpret mode on the CPU), the GroupNorm fold,
the gradient, and the fused VAE decoder against the JAX one. The CUDA
kernel itself is tested in test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.kernels import fused_conv as jfc
from genima_tpu.nn.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig

from genima_torch.kernels import _build
from genima_torch.kernels import fused_conv as fc
from genima_torch.nn.vae import DECODE_SUBTREES, AutoencoderKL, VAEConfig
from genima_torch.weights.from_jax import drop_subtrees, load_from_jax
from genima_torch.weights.init import build_module

ATOL = 1e-5


def _inputs(B=1, H=16, W=16, C=16, O=16, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, H, W, C).astype(np.float32),
        w=(rng.randn(3, 3, C, O) * 0.1).astype(np.float32),
        b=rng.randn(O).astype(np.float32),
        gamma=(rng.randn(C) * 0.5 + 1.0).astype(np.float32),
        beta=(rng.randn(C) * 0.2).astype(np.float32),
        wskip=(rng.randn(C, O) * 0.1).astype(np.float32),
        res=rng.randn(B, H, W, O).astype(np.float32),
    )


def _t(i):
    return {k: torch.from_numpy(v) for k, v in i.items()}


def _j(i):
    return {k: jnp.asarray(v) for k, v in i.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def test_plain_conv_matches_pallas_kernel():
    i = _inputs()
    j, t = _j(i), _t(i)
    want = jfc.fused_conv3x3(j["x"], j["w"], j["b"], interpret=True)
    _close(fc.fused_conv3x3_reference(t["x"], t["w"], t["b"]), want)


def test_gn_silu_conv_matches_pallas_kernel():
    i = _inputs(seed=1)
    j, t = _j(i), _t(i)
    want = jfc.gn_silu_conv3x3(j["x"], j["w"], j["b"], j["gamma"], j["beta"], groups=4,
                               interpret=True)
    got = fc.gn_silu_conv3x3(t["x"], t["w"], t["b"], t["gamma"], t["beta"], groups=4)
    _close(got, want)


def test_skip_and_residual_match_pallas_kernel():
    i = _inputs(B=2, W=12, seed=2)  # W not a multiple of the kernel's tiles
    j, t = _j(i), _t(i)
    js, jt = jfc.fold_group_norm(j["x"], j["gamma"], j["beta"], 4, 1e-6)
    want = jfc.fused_conv3x3(j["x"], j["w"], j["b"], js, jt, j["wskip"], j["res"],
                             interpret=True)
    ts, tt = fc.fold_group_norm(t["x"], t["gamma"], t["beta"], 4, 1e-6)
    _close(fc.fused_conv3x3_reference(t["x"], t["w"], t["b"], ts, tt, t["wskip"], t["res"]),
           want)


def test_channel_change_matches_pallas_kernel():
    i = _inputs(C=24, O=8, seed=3)
    j, t = _j(i), _t(i)
    js, jt = jfc.fold_group_norm(j["x"], j["gamma"], j["beta"], 8, 1e-6)
    want = jfc.fused_conv3x3(j["x"], j["w"], j["b"], js, jt, interpret=True)
    ts, tt = fc.fold_group_norm(t["x"], t["gamma"], t["beta"], 8, 1e-6)
    _close(fc.fused_conv3x3_reference(t["x"], t["w"], t["b"], ts, tt), want)


def test_fold_group_norm_matches_jax():
    i = _inputs(B=2, seed=5)
    want = jfc.fold_group_norm(jnp.asarray(i["x"]), jnp.asarray(i["gamma"]),
                               jnp.asarray(i["beta"]), 4, 1e-6)
    got = fc.fold_group_norm(*(torch.from_numpy(i[k]) for k in ("x", "gamma", "beta")), 4, 1e-6)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 16)
        _close(g, w)


def test_gradient_recomputes_through_plain_version():
    """Gradients through the port's Function against jax.grad through the
    Pallas kernel's custom VJP (which recomputes through XLA)."""
    i = _inputs(seed=4)
    j, t = _j(i), _t(i)
    js, jt = jfc.fold_group_norm(j["x"], j["gamma"], j["beta"], 4, 1e-6)

    def jax_loss(x, w):
        return jnp.sum(jfc.fused_conv3x3(x, w, j["b"], js, jt, interpret=True) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1))(j["x"], j["w"])
    ts, tt = fc.fold_group_norm(t["x"], t["gamma"], t["beta"], 4, 1e-6)
    x, w = t["x"].requires_grad_(), t["w"].requires_grad_()
    out = fc.fused_conv3x3(x, w, t["b"], ts, tt)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    # the weight gradient sums 256 pixels of O(10) products: O(100) values,
    # so f32 summation order shows at ~1e-6 relative
    for got, ref in zip((x.grad, w.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_cpu_call_never_touches_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    t = _t(_inputs(seed=6))
    before = fc.fused_conv3x3.launches
    out = fc.fused_conv3x3(t["x"], t["w"], t["b"], residual=t["res"])
    assert fc.fused_conv3x3.launches == before
    torch.testing.assert_close(
        out, fc.fused_conv3x3_reference(t["x"], t["w"], t["b"], residual=t["res"]),
        rtol=0, atol=0)


def test_other_devices_raise():
    x = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        fc.fused_conv3x3(x, torch.empty(3, 3, 8, 8, device="meta"),
                         torch.empty(8, device="meta"))


@pytest.fixture(scope="module")
def vae_pair():
    cfg = JaxVAEConfig.tiny_test()
    jm = JaxVAE(cfg, conv_backend="fused")
    p = fast_init(jm, jax.random.key(3), jnp.zeros((1, 16, 16, 3)), jax.random.key(4),
                  seed=13)["params"]
    tree = drop_subtrees(jax.tree_util.tree_map(np.asarray, p), DECODE_SUBTREES, keep=True)
    tm = build_module(lambda: AutoencoderKL(VAEConfig.tiny_test(), conv_backend="fused"),
                      torch.device("cpu"), torch.float32)
    return jm, p, load_from_jax(tm, tree, "diffusers_vae")


def test_fused_decoder_matches_jax(vae_pair):
    """The JAX fused decoder (its fused blocks; on the CPU the kernel's XLA
    chain) against the port's, on the same weights: the resnet with a
    channel-change shortcut, the upsample and conv_out included."""
    jm, p, tm = vae_pair
    z = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    want = jm.apply({"params": p}, jnp.asarray(z), method=jm.decode)
    got = tm.decode(torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2))))
    assert got.shape == (2, 3, 16, 16)
    _close(got.detach().numpy().transpose(0, 2, 3, 1), want, atol=1e-4)


def test_fused_decoder_matches_the_default_one(vae_pair):
    """Same parameters under both conv backends, same function."""
    _, _, tm = vae_pair
    z = torch.from_numpy(np.random.RandomState(5).randn(1, 4, 8, 8).astype(np.float32))
    fused = tm.decode(z)
    tm.decoder.conv_backend = "xla"
    try:
        plain = tm.decode(z)
    finally:
        tm.decoder.conv_backend = "fused"
    torch.testing.assert_close(fused, plain, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="conv backend"):
        AutoencoderKL(VAEConfig.tiny_test(), conv_backend="pallas")
