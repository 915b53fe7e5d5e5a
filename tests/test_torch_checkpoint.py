"""The port's pure-Python flax msgpack reader/writer and its weight bridge
against flax itself, on a real `MCAQYOLO.init` tree (float32 leaves, the
int32 `num_batches` and bool `frozen` quantizer state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.models import MCAQYOLO as JaxMCAQYOLO
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables, to_jax_variables
from mcaq_yolo_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_meta,
    read_msgpack,
    save_checkpoint,
    write_msgpack,
)


@pytest.fixture(scope="module")
def init_tree():
    m = JaxMCAQYOLO(variant="yolov8n", num_classes=4, morph_downsample=2)
    v = jax.jit(lambda k, x: m.init(k, x, training=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jax.tree_util.tree_map(np.asarray, v)


def _assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_init_tree_has_int_and_bool_state(init_tree):
    qs = init_tree["quant_stats"]["quantizer_p3"]
    assert qs["num_batches"].dtype == np.int32 and qs["frozen"].dtype == np.bool_


def test_flax_to_port_to_flax(init_tree):
    blob = serialization.msgpack_serialize(init_tree)
    tree = read_msgpack(blob)
    _assert_trees_equal(init_tree, tree)
    _assert_trees_equal(init_tree, serialization.msgpack_restore(write_msgpack(tree)))
    assert write_msgpack(tree) == blob  # the same bytes as flax writes


def test_port_to_flax(init_tree):
    _assert_trees_equal(init_tree, serialization.msgpack_restore(write_msgpack(init_tree)))


def test_mixed_payload_round_trip():
    """What a Trainer checkpoint also holds: Python scalars and strings,
    lists, numpy scalars, a bfloat16 leaf (read back as float32), chunk-free
    large-ish arrays, and long keys."""
    payload = {
        "step": 123456789, "neg": -40000, "lr": 1e-3, "name": "x" * 40, "none": None,
        "flags": [True, False], "np_scalar": np.float32(2.5), "i8": np.arange(300, dtype=np.int8),
        "bf16": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16)),
        "big": np.random.default_rng(0).normal(size=(70, 70)).astype(np.float32),
        "k" * 300: {"nested": np.zeros((0, 3), np.float32)},
    }
    blob = serialization.msgpack_serialize(payload)
    ours = read_msgpack(blob)
    assert ours["step"] == 123456789 and ours["neg"] == -40000 and ours["none"] is None
    assert ours["flags"] == [True, False] and ours["name"] == "x" * 40
    assert ours["np_scalar"] == np.float32(2.5)
    np.testing.assert_array_equal(ours["bf16"], np.asarray([1.5, -2.25], np.float32))
    np.testing.assert_array_equal(ours["big"], payload["big"])
    np.testing.assert_array_equal(ours["i8"], payload["i8"])
    assert ours["k" * 300]["nested"].shape == (0, 3)
    back = serialization.msgpack_restore(write_msgpack({k: v for k, v in ours.items()
                                                        if k != "bf16"}))
    np.testing.assert_array_equal(back["big"], payload["big"])
    assert back["step"] == 123456789 and back["flags"] == [True, False]


def test_weight_bridge_round_trip(init_tree, tmp_path):
    """flax tree -> port modules -> flax tree is the identity, also through
    the port's checkpoint files."""
    port = load_jax_variables(MCAQYOLO(num_classes=4, morph_downsample=2, device="cpu"),
                              init_tree)
    _assert_trees_equal(init_tree, to_jax_variables(port))
    path = tmp_path / "m.ckpt"
    save_checkpoint(path, to_jax_variables(port), meta={"variant": "yolov8n"})
    _assert_trees_equal(init_tree, load_checkpoint(path))
    assert load_meta(path) == {"variant": "yolov8n"}


def test_bf16_network_exports_float32(init_tree):
    port = load_jax_variables(MCAQYOLO(num_classes=4, dtype=torch.bfloat16, device="cpu"),
                              init_tree)
    assert port.backbone.ConvBnSiLU_0.Conv_0.weight.dtype == torch.bfloat16
    assert port.backbone.ConvBnSiLU_0.BatchNorm_0.weight.dtype == torch.float32
    out = to_jax_variables(port)
    k = out["params"]["backbone"]["ConvBnSiLU_0"]["Conv_0"]["kernel"]
    assert k.dtype == np.float32
    ref = init_tree["params"]["backbone"]["ConvBnSiLU_0"]["Conv_0"]["kernel"]
    np.testing.assert_allclose(k, ref, rtol=2 ** -8)


def test_strict_load_rejects_unknown_leaves(init_tree):
    port = MCAQYOLO(num_classes=4, device="cpu")
    with pytest.raises(ValueError, match="no module"):
        load_jax_variables(port, {"params": {"nope": {"kernel": np.zeros(3)}}})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(port, {"params": {"head": {"cls0_out": {"bias": np.zeros(5)}}}})
