"""The SDXL-turbo variant under the opt-in serving backends against the JAX
package, tiny, f32, on the CPU.

``backend="pallas+w8"``: every UNet and ControlNet attention through the
flash kernel (JAX's Pallas kernel in interpret mode; the port's plain B3)
and every transformer linear in int8 (JAX's off-TPU XLA path; the port's
plain B5), on the text_time models of ``test_torch_sdxl.py``'s tiny widths,
from one quantized tree (JAX's ``quantize_pipeline_params``) carried to the
port by its converter. The noise prediction is held at ``W8_ATOL``, the
tolerance of the SD ``+w8`` test (``test_torch_opt_serving.py``): '+w8'
rounds every int8 linear's input to bf16, so an f32-level difference
upstream flips some of those roundings (JAX's own two attention paths of
the same int8 UNet differ by 7.2e-3 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.nn.controlnet import controlnet_params_from_unet as jax_from_unet
from genima_tpu.weights.quantize import quantize_pipeline_params as jax_quantize_pipeline

import genima_torch.nn.layers as torch_layers
from test_torch_sdxl import IMAGE, _model_inputs, jax_fast_params, jax_tiny_pipe, port_tiny_pipe

BACKEND = "pallas+w8"
W8_ATOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sdxl_controlnet_and_unet_under_pallas_w8_match_jax(monkeypatch):
    """ControlNet residuals into the UNet, text_time conditioning, at batch
    2: the noise prediction within ``W8_ATOL``, every attention sent to the
    flash wrapper and every transformer linear to the int8 one."""
    params = dict(jax_fast_params())
    params["controlnet"] = jax_from_unet(params["unet"], params["controlnet"])
    rng = np.random.RandomState(25)
    cn = dict(params["controlnet"])
    for k in [k for k in cn if k.startswith("controlnet_")]:  # zero convs: drawn
        cn[k] = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    params = jax_quantize_pipeline(params)
    jpipe = jax_tiny_pipe(backend=BACKEND)
    x = _model_inputs(seed=3)
    bsz = x["latents"].shape[0]
    added = {"text_embeds": jnp.asarray(x["pooled"]), "time_ids": jpipe.make_time_ids(bsz, IMAGE)}

    @jax.jit
    def jax_eps(params, lat, t, ctx, cond, added):
        down, mid = jpipe.controlnet.apply({"params": params["controlnet"]}, lat, t, ctx, cond,
                                           added_cond_kwargs=added)
        return jpipe.unet.apply({"params": params["unet"]}, lat, t, ctx,
                                down_block_additional_residuals=down,
                                mid_block_additional_residual=mid, added_cond_kwargs=added)

    want = np.asarray(jax_eps(params, *(jnp.asarray(x[k]) for k in
                                        ("latents", "t", "context", "cond")), added))
    pipe = port_tiny_pipe(backend=BACKEND)
    port = pipe.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    w8 = [m for name in ("unet", "controlnet") for m in port[name].modules()
          if isinstance(m, torch_layers.W8Linear)]
    assert w8 and all(m.kernel_q.dtype == torch.int8 for m in w8)
    calls = {"flash": 0, "w8": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(torch_layers, "flash_attention",
                        counting("flash", torch_layers.flash_attention))
    monkeypatch.setattr(torch_layers, "w8_matmul", counting("w8", torch_layers.w8_matmul))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()

    with torch.no_grad():
        lat, t, ctx = nchw(x["latents"]), torch.from_numpy(x["t"]), torch.from_numpy(x["context"])
        tadded = {"text_embeds": torch.from_numpy(x["pooled"]),
                  "time_ids": pipe.make_time_ids(bsz, IMAGE)}
        down, mid = port["controlnet"](lat, t, ctx, nchw(x["cond"]), added_cond_kwargs=tadded)
        got = port["unet"](lat, t, ctx, down, mid, added_cond_kwargs=tadded)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=W8_ATOL, rtol=0)
    # self and cross attention in each transformer block; in int8, 10
    # linears a block (q, k, v, out twice, GEGLU in and out) and each
    # Transformer2D's proj_in and proj_out (linear at SDXL)
    def count(cls):
        return sum(isinstance(m, cls) for name in ("unet", "controlnet")
                   for m in port[name].modules())

    blocks, t2d = count(torch_layers.BasicTransformerBlock), count(torch_layers.Transformer2DModel)
    assert blocks and calls == {"flash": 2 * blocks, "w8": 10 * blocks + 2 * t2d}
