"""The port's int8 weight-only path (B5): quantization bit-equal to JAX, the
plain matmul against the JAX Pallas kernel (interpret mode) and its XLA
fallback, and quantized JAX trees carried across into ``W8Linear``s. The
CUDA kernel itself is tested in test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.kernels import w8_matmul as jw8
from genima_tpu.nn.controlnet import ControlNetModel as JaxControlNet
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet, UNetConfig as JaxUNetConfig
from genima_tpu.weights.quantize import quantize_pipeline_params as jax_quantize_pipeline

from genima_torch.kernels import _build
from genima_torch.kernels import w8_matmul as w8
from genima_torch.nn.controlnet import ControlNetModel
from genima_torch.nn.layers import Attention, W8Linear
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.weights.from_jax import load_from_jax
from genima_torch.weights.init import build_module
from genima_torch.weights.quantize import (
    dequantize_dense_tree,
    quantize_dense_tree,
    quantize_pipeline_params,
)

CPU = torch.device("cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_quantize_weight_bit_equal_to_jax():
    """Same rounding (half to even), same scale: the port's (N, K) int8 is
    the transpose of JAX's (K, N), bit for bit."""
    rng = np.random.RandomState(0)
    k = (rng.randn(64, 48) * 0.3).astype(np.float32)
    k[3, 5] = 0.0
    k[:, 7] = 0.0  # an all-zero column takes the 1e-12 floor
    jq, js = jw8.quantize_weight(jnp.asarray(k))
    tq, ts = w8.quantize_weight(torch.from_numpy(k.T.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_plain_version_matches_pallas_kernel():
    rng = np.random.RandomState(1)
    x = rng.randn(128, 320).astype(np.float32)
    w_q, scale = jw8.quantize_weight(jnp.asarray(rng.randn(320, 256).astype(np.float32) * 0.1))
    want = jw8.w8_matmul_interpret(jnp.asarray(x), w_q, scale)
    got = w8.w8_matmul_reference(torch.from_numpy(x), torch.from_numpy(np.asarray(w_q).T.copy()),
                                 torch.from_numpy(np.array(scale)))
    assert _rel(got, want) <= 1e-5


def test_plain_version_matches_jax_fallback():
    """The XLA dequant path JAX takes off the TPU (and for M = 77 or
    N % 128 != 0 on it), on a leading batch dim."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 77, 320).astype(np.float32)
    w_q, scale = jw8.quantize_weight(jnp.asarray(rng.randn(320, 640).astype(np.float32) * 0.05))
    want = jw8.w8_matmul(jnp.asarray(x), w_q, scale)
    got = w8.w8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(w_q).T.copy()),
                       torch.from_numpy(np.array(scale)))
    assert got.shape == (4, 77, 640)
    assert _rel(got, want) <= 1e-5


def test_cpu_call_never_touches_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = w8.w8_matmul.launches
    x = torch.randn(5, 48)
    w_q, scale = w8.quantize_weight(torch.randn(24, 48))
    out = w8.w8_matmul(x, w_q, scale)
    assert w8.w8_matmul.launches == before
    torch.testing.assert_close(out, w8.w8_matmul_reference(x, w_q, scale), rtol=0, atol=0)
    with pytest.raises(ValueError, match="device"):
        w8.w8_matmul(x.to("meta"), w_q.to("meta"), scale.to("meta"))


def test_w8_linear_keeps_its_scale_f32():
    """A cast of the module to bf16 leaves the int8 weight and the f32 scale
    as they are; a float linear's bias follows the module."""
    lin = torch.nn.Linear(32, 16)
    with torch.no_grad():
        lin.weight.normal_(0, 0.1)
    parent = torch.nn.Module()
    parent.proj_in = lin
    quantize_dense_tree(parent)
    q = parent.proj_in
    assert isinstance(q, W8Linear)
    scale = q.scale.clone()
    parent.to(torch.bfloat16)
    assert q.kernel_q.dtype == torch.int8 and q.bias.dtype == torch.bfloat16
    assert q.scale.dtype == torch.float32 and torch.equal(q.scale, scale)


@pytest.fixture(scope="module")
def trees():
    cfg = JaxUNetConfig.tiny()
    args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    unet = fast_init(JaxUNet(cfg, backend="xla"), jax.random.key(0), *args, seed=21)["params"]
    cn = fast_init(JaxControlNet(cfg, conditioning_scale_channels=(8, 16), backend="xla"),
                   jax.random.key(1), *args, jnp.zeros((1, 16, 16, 3)), seed=22)["params"]
    floats = {"unet": unet, "controlnet": cn}
    quant = jax_quantize_pipeline(floats)
    return (jax.tree_util.tree_map(np.asarray, floats),
            jax.tree_util.tree_map(np.asarray, quant))


FACTORIES = {
    "unet": lambda b: UNet2DConditionModel(UNetConfig.tiny(), b),
    "controlnet": lambda b: ControlNetModel(UNetConfig.tiny(), (8, 16), b),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_jax_quantized_tree_loads_and_equals_port_quantization(trees, name):
    """A JAX ``quantize_pipeline_params`` tree loads strictly into the port's
    '+w8' modules and equals the port's own quantization of the float
    weights it carried across."""
    floats, quant = trees
    family = f"diffusers_{name}"
    loaded = load_from_jax(build_module(lambda: FACTORIES[name]("pallas+w8"), CPU,
                                        torch.float32), quant[name], family)
    port = {name: load_from_jax(build_module(lambda: FACTORIES[name]("pallas"), CPU,
                                             torch.float32), floats[name], family)}
    quantize_pipeline_params(port)
    want, got = loaded.state_dict(), port[name].state_dict()
    assert set(got) == set(want)
    n_q = 0
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        n_q += k.endswith("kernel_q")
    # 12 int8 linears per transformer block: UNet 4 blocks, ControlNet 2
    assert n_q == {"unet": 48, "controlnet": 24}[name]
    backends = {m.backend for m in port[name].modules() if isinstance(m, Attention)}
    assert backends == {"pallas+w8"}


def test_dequantize_inverts_the_module_swap(trees):
    floats, quant = trees
    m = load_from_jax(build_module(lambda: FACTORIES["unet"]("xla+w8"), CPU, torch.float32),
                      quant["unet"], "diffusers_unet")
    q = {k: t.clone() for k, t in m.state_dict().items()}
    dequantize_dense_tree(m)
    sd = m.state_dict()
    for k, t in q.items():
        if k.endswith("kernel_q"):
            base = k[: -len("kernel_q")]
            want = t.float() * q[base + "scale"][:, None]
            torch.testing.assert_close(sd[base + "weight"], want, rtol=0, atol=0)
    assert not any(isinstance(x, W8Linear) for x in m.modules())
    assert {x.backend for x in m.modules() if isinstance(x, Attention)} == {"xla"}


def test_gradient_flows_through_the_wrapper():
    """A call that needs a gradient goes through ``W8Matmul`` (the kernel
    forward on CUDA, a plain-version recompute backward): dx equals the
    plain version's, and int8 weights get none."""
    x = torch.randn(2, 7, 48, requires_grad=True)
    w_q, scale = w8.quantize_weight(torch.randn(24, 48))
    out = w8.w8_matmul(x, w_q, scale)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    ref = x.detach().clone().requires_grad_()
    (w8.w8_matmul_reference(ref, w_q, scale) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, ref.grad, rtol=0, atol=0)
