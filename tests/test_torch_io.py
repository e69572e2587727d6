"""The port's model checkpoints against the JAX package's (`models/io.py`).

 - The port's msgpack codec writes what msgpack-python (as flax calls it)
   writes, byte for byte, and reads it back: f32, f16, i32, i64, bool and
   numpy scalars, nested maps, lists, str, bytes, every integer width.
 - A model file the port writes is byte-equal to the one the JAX package
   writes for the same weights, loads in the JAX package's `load_model`, and
   a JAX file loads in the port's `load_posenet`; both forwards then agree
   with the tolerances of `test_torch_model.py` (rtol 1e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from neuralnet_tracker_traincode_tpu.models import io as jio
from neuralnet_tracker_traincode_torch.models import io as tio
from neuralnet_tracker_traincode_torch.models import msgpack_codec
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead as TNet
from tests.torch_port_helpers import SMALL_NET, jax_posenet_variables, t, torch_posenet

SIXD_NET = dict(SMALL_NET, enable_6drot=True)


def _tree(rng):
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "nested": {
            "f16": rng.randn(5).astype(np.float16),
            "i32": rng.randint(-2**31, 2**31 - 1, (2, 2, 2)).astype(np.int32),
            "deeper": {"i64": np.arange(-3, 4, dtype=np.int64), "scalar0d": np.asarray(1.5, np.float32)},
            "bools": np.asarray([True, False]),
        },
        "big": rng.randn(70, 9).astype(np.float32),  # payload above 2**16 bytes: ext32, bin32
        "npscalar": np.float32(2.25),
        "empty": np.zeros((0, 3), np.float32),
    }


_SCALARS = [0, 1, 127, 128, 255, 256, 2**16 - 1, 2**16, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129,
            -(2**15), -(2**15) - 1, -(2**31), -(2**31) - 1, -(2**63), 0.5, -1e300, True, False, None,
            "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000,
            list(range(15)), list(range(16)), list(range(70000)),
            # maps are written in sorted key order, as flax's trees come
            {k: int(k) for k in sorted(map(str, range(15)))}, {k: int(k) for k in sorted(map(str, range(16)))}]


@pytest.mark.parametrize("value", _SCALARS, ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}")
def test_codec_encodes_every_type_as_msgpack_does(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert msgpack_codec.packb(value) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)


def test_codec_writes_flax_bytes_and_round_trips_arrays():
    tree = _tree(np.random.RandomState(0))
    blob = msgpack_codec.packb(tree)
    assert blob == serialization.msgpack_serialize(tree)
    back = msgpack_codec.unpackb(blob)
    flax_back = serialization.msgpack_restore(blob)

    def check(a, b, c):
        if isinstance(b, dict):
            assert set(a) == set(b) == set(c)
            for k in b:
                check(a[k], b[k], c[k])
            return
        assert type(a) is type(b) or (np.ndim(b) == 0 and np.asarray(a).dtype == np.asarray(b).dtype)
        assert np.asarray(a).dtype == np.asarray(b).dtype == np.asarray(c).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))

    check(back, tree, flax_back)
    assert back["nested"]["i32"].flags.writeable


def test_codec_rejects_what_it_cannot_write():
    with pytest.raises(TypeError):
        msgpack_codec.packb({1: np.zeros(1)})
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": object()})
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack_codec.packb([1, 2]) + b"\x00")


@pytest.mark.parametrize("net", ["quat", "6d"])
def test_port_model_file_is_the_jax_file(net, tmp_path):
    """Same weights: the same bytes; and each package loads the other's file."""
    cfg = SIXD_NET if net == "6d" else SMALL_NET
    jmodel, variables = jax_posenet_variables(7, **cfg)
    model = torch_posenet(variables, **cfg)
    tio.save_model(model, None, str(tmp_path / "port.ckpt"))
    jio.save_model(jmodel, variables, str(tmp_path / "jax.ckpt"))
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()

    x = np.random.RandomState(7).rand(2, 129, 129, 1).astype(np.float32) - 0.5
    conv = np.asarray([0, 3], np.int32)
    jm, jvars = jio.load_posenet(str(tmp_path / "port.ckpt"))
    assert jm.get_config() == jmodel.get_config()
    ref = jm.apply(jvars, jnp.asarray(x), coord_convention_id=jnp.asarray(conv), train=False)
    loaded = tio.load_posenet(str(tmp_path / "jax.ckpt"))
    assert not loaded.training and loaded.get_config() == model.get_config()
    with torch.no_grad():
        out = loaded(t(x), coord_convention_id=t(conv))
    for k in ("coord", "roi", "pose", "pt3d_68", "shapeparam", "pose_scales_tril", "coord_scales"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_model_file_holds_the_given_state_dict(tmp_path):
    model = TNet(**SMALL_NET)
    model.init_weights(torch.Generator().manual_seed(1))
    other = TNet(**SMALL_NET)
    other.init_weights(torch.Generator().manual_seed(2))
    tio.save_model(model, other.state_dict(), str(tmp_path / "m.ckpt"))
    loaded = tio.load_posenet(str(tmp_path / "m.ckpt"))
    for k, v in other.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded.state_dict()[k], v), k
    header, tree = tio.read_model_file(str(tmp_path / "m.ckpt"))
    assert header == {"class_name": "NetworkWithPointHead", "config": model.get_config()}
    assert sorted(tree) == ["batch_stats", "params"]
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax_posenet_variables(0, **SMALL_NET)[1])


def test_bad_files_are_refused(tmp_path):
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"NOTMAGIC" + bytes(16))
    with pytest.raises(tio.InvalidFileFormatError):
        tio.load_posenet(str(bad))
    jmodel, variables = jax_posenet_variables(0, **SMALL_NET)
    jio.save_model(jmodel, variables, str(tmp_path / "j.ckpt"))
    with pytest.raises(tio.InvalidFileFormatError, match="Unknown model class"):
        tio.load_model(str(tmp_path / "j.ckpt"), [])
