"""The port's native PNG decoder against the JAX package's, on the CPU.

The port builds its copy of ``image_ops.cpp`` into the repository's
``build/``; on the same PNG bytes (resized up, down, and not at all; both
normalizations and the uint8 path) its output must equal the JAX decoder's
bit for bit, and a corrupt PNG must make both return None. The loader's
native path holds to the JAX loader's native path exactly, and a missing
library falls back to PIL and says so in ``decoded``.
"""

import io

import numpy as np
import pytest
from PIL import Image

from genima_tpu import native as jax_native
from genima_tpu.data import dataset as jax_dataset

from genima_torch import native
from genima_torch.data import dataset
from genima_torch.data.tokenizer import HashTokenizer


@pytest.fixture(autouse=True)
def _needs_the_decoders():
    """Decided when a test runs, not at import: the first call builds."""
    if native.get_lib() is None or jax_native.get_lib() is None:
        pytest.skip(f"native decoder unavailable (no g++ or libpng): {native.build_error}")


def _png(arr: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="PNG")
    return b.getvalue()


def _pngs(seed=0):
    rng = np.random.RandomState(seed)
    return [_png(rng.randint(0, 256, shape, np.uint8))
            for shape in ((32, 32, 3), (48, 40, 3), (20, 28, 3), (32, 32, 3))]


def test_library_is_built_into_build_dir():
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent == native.SRC.parents[2]  # the repository root
    assert not any(native.SRC.parent.glob("*.so"))  # nothing beside the source


@pytest.mark.parametrize("resolution", [16, 32, 40])
def test_decode_matches_jax_bit_for_bit(resolution):
    pngs = _pngs()
    for mode in (0, 1):
        got = native.decode_png_batch(pngs, resolution, mode=mode, n_threads=2)
        want = jax_native.decode_png_batch(pngs, resolution, mode=mode, n_threads=2)
        assert got.shape == (4, resolution, resolution, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got = native.decode_png_batch_u8(pngs, resolution, n_threads=3)
    np.testing.assert_array_equal(got, jax_native.decode_png_batch_u8(pngs, resolution, 3))
    assert got.dtype == np.uint8


def test_corrupt_input_returns_none_like_jax():
    pngs = _pngs(1)
    pngs[2] = b"not a png"
    assert native.decode_png_batch(pngs, 16, mode=0) is None
    assert jax_native.decode_png_batch(pngs, 16, mode=0) is None
    assert native.decode_png_batch_u8(pngs, 16) is None
    assert jax_native.decode_png_batch_u8(pngs, 16) is None
    assert native.decode_png_batch([], 16, mode=0) is None


def _samples(tmp_path, n=4):
    rng = np.random.RandomState(3)
    out = []
    for i in range(n):
        img, cond = tmp_path / f"img{i}.png", tmp_path / f"cond{i}.png"
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(img)
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(cond)
        out.append(dataset.Sample(str(img), str(cond), f"text {i}"))
    return out


@pytest.mark.parametrize("emit_uint8", [True, False])
def test_loader_native_path_matches_jax(tmp_path, emit_uint8):
    samples = _samples(tmp_path)
    jsamples = [jax_dataset.Sample(**vars(s)) for s in samples]
    kw = dict(batch_size=2, resolution=32, seed=1, num_workers=2, use_native=True,
              emit_uint8=emit_uint8)
    got = dataset.DiffusionDataLoader(samples, HashTokenizer(), **kw)
    want = jax_dataset.DiffusionDataLoader(jsamples, HashTokenizer(), **kw)
    for a, b in zip(got, want, strict=True):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.decoded == {"native": 2}


def test_loader_falls_back_to_pil_and_says_so(tmp_path, monkeypatch):
    samples = _samples(tmp_path)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    loader = dataset.DiffusionDataLoader(samples, HashTokenizer(), batch_size=2, resolution=32,
                                         shuffle=False, use_native=True, emit_uint8=True)
    pil = dataset.DiffusionDataLoader(samples, HashTokenizer(), batch_size=2, resolution=32,
                                      shuffle=False, use_native=False, emit_uint8=True)
    for a, b in zip(loader, pil, strict=True):
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
    assert loader.decoded == {"pil": 2} and pil.decoded == {"pil": 2}
