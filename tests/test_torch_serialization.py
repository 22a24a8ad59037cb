"""The port's flax-msgpack reader against ``flax.serialization``, on the CPU.

Every tree here is written by flax (or, for the msgpack headers flax
happens not to emit, by ``msgpack`` itself) and read back by both
readers; the results must be equal exactly: same keys, same types, same
dtypes and shapes, the same bytes in every array. A bfloat16 leaf, which
the port returns as a ``torch.bfloat16`` tensor, is compared through its
16-bit pattern.
"""

import json
import re
from pathlib import Path

import flax.serialization as fser
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.models import model_from_metadata
from neuraloperator_tpu_torch.serialization import msgpack_restore, read_msgpack
from neuraloperator_tpu_torch.training import load_training_state

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2"
BF16 = jnp.bfloat16


def _assert_same(port, ref, path="tree"):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), path
        for k in ref:
            _assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == BF16:
        assert isinstance(port, torch.Tensor) and port.dtype == torch.bfloat16, path
        assert tuple(port.shape) == ref.shape, path
        np.testing.assert_array_equal(
            port.view(torch.int16).numpy(), np.asarray(ref).view(np.int16), err_msg=path
        )
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(port) is type(ref) and port.dtype == ref.dtype, path
        assert port.shape == ref.shape and port.tobytes() == ref.tobytes(), path
    else:
        assert type(port) is type(ref) and port == ref, path


def _both(encoded):
    ref = fser.msgpack_restore(encoded)
    _assert_same(msgpack_restore(encoded), ref)
    return ref


def _rand(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


TREES = {
    "array_leaves": lambda: {
        "f32": _rand(0, 3, 4),
        "nested": {"f16": _rand(1, 5, dtype=np.float16),
                   "bf16": _rand(2, 2, 3).astype(BF16),
                   "deeper": {"f64": _rand(3, 2, dtype=np.float64)}},
        "i32": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
        "i64": np.array([-(2**62), 0, 2**62], dtype=np.int64),
        "u8": np.arange(7, dtype=np.uint8),
        "bool": np.array([True, False, True]),
        "c64": (_rand(4, 3) + 1j * _rand(5, 3)).astype(np.complex64),
    },
    "scalar_leaves": lambda: {
        "np_f32": np.float32(1.5), "np_f16": np.float16(-2.25), "np_i64": np.int64(-7),
        "np_bool": np.bool_(True), "np_bf16": BF16(0.375),
        "float": 0.1, "complex": 1.5 - 2.0j, "none": None, "true": True, "false": False,
    },
    "zero_d_and_empty": lambda: {
        "zero_d": np.array(3.25, dtype=np.float32), "empty": np.zeros((0, 3), np.float32),
        "empty_bf16": np.zeros((2, 0), BF16), "zero_d_bf16": np.array(1.0, BF16),
        "empty_i32": np.zeros((0,), np.int32),
    },
    "values": lambda: {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -(2**15), -(2**15) - 1, -(2**31), -(2**31) - 1,
                 -(2**63)],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535, "f" * 65536,
                 "ünïcode ✓"],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
        "tuple": (1, "two", 3.0),
        "map16": {f"k{i}": [i] for i in range(20)},
    },
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_flax_trees_read_back_equal(name):
    _both(fser.to_bytes(TREES[name]()))


# flax's to_bytes turns lists into maps; these reach msgpack's own arrays
RAW = {
    "fixarray": [1, [2, [3, None]], True, False, "s", b"b", 1.5],
    "array16": list(range(20)),
    "array32": [[i, -i] for i in range(70_000)],
    "map32": {f"k{i}": i for i in range(70_000)},
    "float32": [1.5, [0.25, -3.0], {"x": 2.0}],
}


@pytest.mark.parametrize("name", sorted(RAW))
def test_msgpack_values_read_back_equal(name):
    _both(msgpack.packb(RAW[name], use_bin_type=True, use_single_float=name == "float32"))


def test_ext_headers():
    """fixext 4 and 8 (complex payloads of those sizes) and fixext16 (how
    flax writes an np.float32 scalar)."""
    for parts in ([-100, 1], [70000, 200]):  # 4- and 8-byte payloads: fixext4, fixext8
        payload = msgpack.packb(parts)
        encoded = msgpack.packb(msgpack.ExtType(2, payload))
        assert encoded[0] in (0xD6, 0xD7)
        _both(encoded)
    # np.float32 scalars travel as fixext16
    assert fser.to_bytes(np.float32(2.5))[0] == 0xD8
    _both(fser.to_bytes({"s": np.float32(2.5)}))


@pytest.mark.parametrize("top_level", [False, True])
def test_chunked_arrays_are_joined(monkeypatch, top_level):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {"big": _rand(6, 10, 7), "small": _rand(7, 3),
            "nested": {"big_bf16": _rand(8, 50).astype(BF16), "big_i64": np.arange(30)}}
    if top_level:
        tree = _rand(9, 5, 9)
    encoded = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in encoded
    ref = _both(encoded)
    port = msgpack_restore(encoded)
    if top_level:
        assert port.shape == (5, 9)
    else:
        assert port["nested"]["big_bf16"].shape == (50,) and ref["big"].shape == (10, 7)


def test_arrays_are_views_of_the_file(tmp_path):
    path = tmp_path / "tree.msgpack"
    path.write_bytes(fser.to_bytes({"w": _rand(10, 4, 4), "b": _rand(11, 4).astype(BF16)}))
    tree = read_msgpack(path)
    _assert_same(tree, fser.msgpack_restore(path.read_bytes()))
    assert tree["w"].base is not None and tree["w"].flags.writeable
    # read from a file, a bf16 leaf is a view of the same buffer
    gap = tree["b"].data_ptr() - tree["w"].__array_interface__["data"][0]
    assert abs(gap) < path.stat().st_size


@pytest.mark.parametrize(
    "encoded,what",
    [
        (b"\xc1", "starts no msgpack value"),
        (b"\x92\x01", "runs past the end"),
        (b"\x01\x02", "1 bytes after the value"),
        (b"\xd4\x05\x00", "ext type 5"),
        (b"\xd4\x02\x01", "not (re, im)"),
        (msgpack.packb({1: 2}), "map key of type int"),
        (b"\xa2\xff\xfe", "not UTF-8"),
        (msgpack.packb(msgpack.ExtType(1, msgpack.packb(([3], "float32", b"\0" * 8)))),
         "with 8 bytes"),
        (msgpack.packb(msgpack.ExtType(1, msgpack.packb(([1], "float99", b"\0" * 4)))),
         "dtype 'float99'"),
    ],
)
def test_malformed_input_names_its_offset(encoded, what):
    with pytest.raises(ValueError, match=re.escape(what) + r".* at byte \d+"):
        msgpack_restore(encoded)


def test_flagship_f16_checkpoint_reads_bit_for_bit():
    """The published checkpoint, leaf for leaf against flax's reader, and its
    tree against the full-width port's state_dict by name and shape."""
    path = FLAGSHIP / "best_model_f16.msgpack"
    port = read_msgpack(path)
    ref = fser.msgpack_restore(path.read_bytes())
    _assert_same(port, ref)
    flat = convert.flatten_flax(port)
    assert len(flat) == 40 and {v.dtype for v in flat.values()} == {np.dtype(np.float16)}
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    template = model_from_metadata(meta, device="meta").state_dict()
    convert.check_flax_params(port, template)
    assert sum(v.numel() for v in template.values()) == 69_265_345

    # loaded into the f32 template: every f16 value survives the cast exactly
    state, opt_state, epoch = load_training_state(FLAGSHIP, "best_model_f16", template,
                                                  device="cpu")
    assert opt_state is None and epoch == 199
    for name, value in state.items():
        assert value.dtype == torch.float32 and value.device.type == "cpu"
        np.testing.assert_array_equal(value.numpy(), flat[name].astype(np.float32))
