"""The port's flax-msgpack codec and checkpoint discovery against flax and the
JAX package.

Trees go both ways: flax's ``to_bytes`` -> the port's reader, and the port's
writer -> flax's ``msgpack_restore``; leaves must come back equal (bit for
bit: no arithmetic happens). bf16 leaves are a ``torch.bfloat16`` tensor on
the port's side (numpy has no bf16 here) and an ``ml_dtypes`` array on
flax's; they are compared through their 16-bit patterns.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from genima_tpu.core import checkpoint as jax_ckpt

from genima_torch.core import checkpoint as ckpt


def _tree():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "bf16": jnp.asarray(rng.randn(5, 2), jnp.bfloat16),
        "i8": rng.randint(-128, 127, (7,)).astype(np.int8),
        "i32": rng.randint(-2**31, 2**31 - 1, (2, 3)).astype(np.int32),
        "u8_empty": np.zeros((0, 3), np.uint8),
        "f16": rng.randn(4).astype(np.float16),
        "f64_0d": np.asarray(3.5),
        "np_scalar": np.float32(2.25),
        "np_int_scalar": np.int64(-7),
        "ints": {"small": 5, "neg": -3, "negbig": -2**40, "big": 2**40, "u64": 2**63 + 1},
        "floats": {"x": 0.1, "inf": float("inf")},
        "flags": {"t": True, "f": False, "none": None},
        "text": "tiled perspectives of a robot arm" * 3,
        "bytes": b"\x00\x01raw" * 100,
        "tuple": (np.arange(3, dtype=np.int32), "a", {"nested": np.ones(2, np.float32)}),
        "list": [1, 2.5, "x"],
        "nest": {f"k{i}": {"kernel": rng.randn(2, 2).astype(np.float32)} for i in range(20)},
    }


def _flax_view(tree):
    """The tree flax's to_bytes writes: tuples and lists as {"0": ...} maps,
    dict keys as strings."""
    if isinstance(tree, dict):
        return {str(k): _flax_view(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _flax_view(v) for i, v in enumerate(tree)}
    return tree


def _bits(x):
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy()
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x


def _assert_same(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, list(a), list(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
        return
    if isinstance(a, (np.ndarray, np.generic, torch.Tensor)) or hasattr(a, "dtype"):
        x, y = _bits(a), _bits(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)
        assert type(a).__name__ == type(b).__name__ or isinstance(a, torch.Tensor) \
            or isinstance(b, torch.Tensor), (path, type(a), type(b))
        return
    assert type(a) is type(b) and a == b, (path, a, b)


def _port_view(tree):
    """The flax tree with bf16 leaves as the torch tensors the port holds."""
    if isinstance(tree, dict):
        return {k: _port_view(v) for k, v in tree.items()}
    if hasattr(tree, "dtype") and tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(tree).view(np.int16).copy()).view(torch.bfloat16)
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


def test_flax_bytes_read_by_the_port():
    tree = _tree()
    got = ckpt.loads(serialization.to_bytes(tree))
    _assert_same(got, _flax_view(_port_view(_flax_view(tree))))


def _written(tree, path):
    """The bytes the port's writer puts in a file."""
    ckpt.save_pytree(tree, path)
    return path.read_bytes()


def test_port_bytes_read_by_flax(tmp_path):
    data = _written(_port_view(_flax_view(_tree())), tmp_path / "t.msgpack")
    flax_bytes = serialization.to_bytes(_tree())
    _assert_same(serialization.msgpack_restore(data), serialization.msgpack_restore(flax_bytes))
    # and byte for byte what flax writes for the same tree
    assert data == flax_bytes


def test_chunked_arrays_both_ways(monkeypatch, tmp_path):
    """Arrays above MAX_CHUNK_SIZE bytes are cut into chunks (patched small
    here, in both packages)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(7, 11).astype(np.float32), "small": np.arange(4, dtype=np.int32),
            "bf16": jnp.asarray(rng.randn(9, 9), jnp.bfloat16),
            "nested": {"big_i8": rng.randint(-5, 5, (300,)).astype(np.int8)}}
    flax_bytes = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    _assert_same(ckpt.loads(flax_bytes), _port_view(tree))
    port_bytes = _written(_port_view(tree), tmp_path / "t.msgpack")
    assert port_bytes == flax_bytes
    _assert_same(serialization.msgpack_restore(port_bytes),
                 serialization.msgpack_restore(flax_bytes))


def _param_tree():
    """A params tree as the JAX package saves one: array leaves only (its
    ``save_pytree`` turns every leaf into a numpy array)."""
    full = _tree()
    return {k: full[k] for k in ("f32", "bf16", "i8", "i32", "f16", "f64_0d", "nest")}


def test_save_and_load_pytree_files_across_packages(tmp_path):
    tree = _port_view(_param_tree())
    ckpt.save_pytree(tree, tmp_path / "a" / "params.msgpack")
    _assert_same(jax_ckpt.load_pytree(tmp_path / "a" / "params.msgpack"),
                 serialization.msgpack_restore(serialization.to_bytes(_param_tree())))
    jax_ckpt.save_pytree(_param_tree(), tmp_path / "b.msgpack")
    _assert_same(ckpt.load_pytree(tmp_path / "b.msgpack"), tree)
    # the loaded numpy leaves may be handed to torch without a copy
    leaf = ckpt.load_pytree(tmp_path / "b.msgpack")["f32"]
    assert leaf.flags.writeable


def test_decoder_rejects_malformed_data(tmp_path):
    data = _written({"x": np.ones(4, np.float32)}, tmp_path / "t.msgpack")
    with pytest.raises(ValueError):
        ckpt.loads(data[:-3])
    with pytest.raises(ValueError):
        ckpt.loads(data + b"\x00")
    with pytest.raises(TypeError):
        ckpt.save_pytree({"x": object()}, tmp_path / "u.msgpack")


def test_epoch_checkpoint_from_jax_loads_in_the_port(tmp_path):
    config = {"method": {"lr": 5e-05, "act_cfg": {"hidden_dim": 32}}, "frame_stack": 1}
    agent = {"encoder": {"w": np.ones((2, 2), np.float32)}, "actor": {"b": np.zeros(3)}}
    jax_ckpt.save_epoch_checkpoint(tmp_path, epoch=1, num_iters=10, agent_params=agent,
                                   config=config)
    jax_ckpt.save_epoch_checkpoint(tmp_path, epoch=2, num_iters=20, agent_params=agent,
                                   config=config)
    payload = ckpt.load_epoch_checkpoint(tmp_path / "latest.ckpt")
    assert payload["epoch"] == 2 and payload["num_iters"] == 20
    assert payload["config"] == config
    np.testing.assert_array_equal(payload["agent"]["encoder"]["w"], agent["encoder"]["w"])
    # the port's payload, read by the JAX package
    ckpt.save_pytree(ckpt.epoch_payload(3, 30, agent, config), tmp_path / "port.ckpt")
    back = jax_ckpt.load_epoch_checkpoint(tmp_path / "port.ckpt")
    assert back["config"] == config and int(back["epoch"]) == 3


def _write_tree(root, layout):
    for rel in layout:
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"")


@pytest.mark.parametrize("layout, query", [
    (["checkpoint-2/controlnet/params.msgpack", "checkpoint-10/controlnet/params.msgpack",
      "checkpoint-9/controlnet/params.msgpack"], ""),
    (["checkpoint-3/controlnet/params.msgpack"], "checkpoint-3"),
    (["params.msgpack"], ""),
    (["controlnet/params.msgpack"], ""),
    (["checkpoint-4/unet/params.msgpack", "checkpoint-5/notes.txt"], ""),
    (["checkpoint-x/controlnet/params.msgpack"], ""),
])
def test_step_checkpoint_discovery_matches_jax(tmp_path, layout, query):
    _write_tree(tmp_path, layout)
    assert [(s, p) for s, p in ckpt.list_step_checkpoints(tmp_path)] == \
        jax_ckpt.list_step_checkpoints(tmp_path)
    assert ckpt.latest_step_checkpoint(tmp_path) == jax_ckpt.latest_step_checkpoint(tmp_path)
    target = tmp_path / query
    try:
        want = jax_ckpt.find_model_checkpoint(target, "controlnet")
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            ckpt.find_model_checkpoint(target, "controlnet")
    else:
        assert ckpt.find_model_checkpoint(target, "controlnet") == want


@pytest.mark.parametrize("files", [
    ["latest.ckpt"],
    ["latest.ckpt", "10.ckpt", "20.ckpt", "30.ckpt", "40.ckpt"],
    ["latest.ckpt", "5.ckpt", "x.ckpt", "7.ckpt.bak"],
])
@pytest.mark.parametrize("eval_type", ["latest", "last", "last_three", "20", "7", "best"])
def test_epoch_checkpoint_selection_matches_jax(tmp_path, files, eval_type):
    _write_tree(tmp_path, files)
    assert ckpt.list_epoch_checkpoints(tmp_path) == jax_ckpt.list_epoch_checkpoints(tmp_path)
    try:
        want = jax_ckpt.select_eval_checkpoints(tmp_path, eval_type)
    except (FileNotFoundError, ValueError) as e:
        with pytest.raises(type(e)):
            ckpt.select_eval_checkpoints(tmp_path, eval_type)
    else:
        assert ckpt.select_eval_checkpoints(tmp_path, eval_type) == want


def test_config_json_round_trip(tmp_path):
    config = {"a": [1, 2, {"b": None}], "s": "ü", "f": 1.5}
    ckpt.save_pytree(ckpt.epoch_payload(0, 0, {"encoder": {}, "actor": {}}, config),
                     tmp_path / "latest.ckpt")
    assert ckpt.load_epoch_checkpoint(tmp_path / "latest.ckpt")["config"] == config
    assert json.loads(bytes(jax_ckpt.load_pytree(tmp_path / "latest.ckpt")["config_json"])) \
        == config
