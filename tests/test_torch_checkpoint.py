"""The port's checkpoints (``repro_torch.training.checkpoint``): the JAX
package's on-disk layout (``step_XXXXXXXX/manifest.json``, ``shard_<i>.npz``
of <= 512 MB, an atomic ``LATEST``), round trips of tensor trees (bf16 as
its int16 bits, bool, bytes, nested dicts, lists and tuples) onto the
like-tree's device, async saves, and checkpoints read across the two
packages."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.training import checkpoint as ckpt


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn((4, 3), generator=g),
        "b16": torch.randn((5,), generator=g).to(torch.bfloat16),
        "layers": [{"k": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                    "live": torch.tensor([True, False])},
                   {"codes": torch.randint(0, 256, (3, 2), generator=g,
                                           dtype=torch.uint8)}],
        "pair": (torch.zeros(2, dtype=torch.int64), torch.ones(1)),
        "none": None,
    }


def _assert_trees_equal(a, b):
    flat_a, flat_b = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_roundtrip_keeps_dtypes_structure_and_values(tmp_path):
    tree = _tree()
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, tree, extra={"note": np.int32(3)})
    assert ckpt.latest_step(d) == 7
    like = {"w": torch.empty(0), "b16": torch.empty(0, dtype=torch.bfloat16),
            "layers": [{"k": torch.empty(0), "live": torch.empty(0)},
                       {"codes": torch.empty(0)}],
            "pair": (torch.empty(0), torch.empty(0)), "none": None}
    got, manifest = ckpt.restore(d, like)
    _assert_trees_equal(got, tree)
    assert isinstance(got["pair"], tuple) and got["none"] is None
    assert manifest["step"] == 7 and manifest["extra"] == {"note": 3}
    assert manifest["dtypes"][0] == "bfloat16"       # sorted keys: b16 first
    assert manifest["paths"][0] == "['b16']"


def test_layout_is_the_reference_layout(tmp_path, monkeypatch):
    """One directory a step, shards cut at the byte limit, LATEST naming
    the step directory; the manifest has the reference's keys."""
    monkeypatch.setattr(ckpt, "_MAX_SHARD_BYTES", 40)
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, _tree())
    step = os.path.join(d, "step_00000003")
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "step_00000003"
    with open(os.path.join(step, "manifest.json")) as f:
        m = json.load(f)
    assert {"step", "paths", "n_leaves", "n_shards", "extra"} <= set(m)
    assert m["n_leaves"] == 7 and m["n_shards"] > 1
    assert sorted(os.listdir(step)) == sorted(
        ["manifest.json"] + [f"shard_{i}.npz" for i in range(m["n_shards"])])


def test_atomic_pointer(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, (torch.ones(3),))
    ckpt.save(d, 2, (torch.ones(3),))
    assert ckpt.latest_step(d) == 2
    # a stale tmp dir must never be visible as a checkpoint
    assert not any(x.startswith(".tmp") for x in os.listdir(d)
                   if os.path.isdir(os.path.join(d, x)))
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), (torch.ones(3),))


def test_failed_write_leaves_the_pointer(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, (torch.ones(3),))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        ckpt.save(d, 2, (torch.ones(3),))
    assert ckpt.latest_step(d) == 1
    assert not any(x.startswith(".tmp") for x in os.listdir(d))


def test_async_save(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    t = ckpt.save_async(d, 3, tree)
    tree["w"].zero_()            # the host copy was taken at the call
    t.join()
    ckpt.wait_pending()
    assert ckpt.latest_step(d) == 3
    got, _ = ckpt.restore(d, tree)
    assert got["w"].abs().sum() > 0


def test_restore_onto_the_like_leaf_device_and_refuses_other_trees(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 0, {"a": torch.ones(2), "b": torch.zeros(3)})
    got, _ = ckpt.restore(d, {"a": torch.empty(0, device="meta"),
                              "b": np.zeros(0)})
    assert got["a"].device.type == "meta"
    assert isinstance(got["b"], np.ndarray)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, {"a": torch.ones(2)})


def test_jsonable_extra():
    extra = {"slots": [None, {"out": [np.int32(1)], "remaining":
                              np.int32(4), "t": torch.tensor([2, 3])}],
             1: np.arange(2)}
    assert ckpt._jsonable(extra) == {
        "slots": [None, {"out": [1], "remaining": 4, "t": [2, 3]}],
        "1": [0, 1]}


def test_checkpoints_read_across_the_packages(tmp_path):
    """A port checkpoint restores in the JAX package and a JAX package
    checkpoint in the port: the same paths, files and values."""
    import jax.numpy as jnp

    from repro.training import checkpoint as jckpt

    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "s": [{"k": torch.tensor([1, 2], dtype=torch.int32)}]}
    ckpt.save(str(tmp_path / "port"), 4, tree, extra={"a": 1})
    jlike = {"w": jnp.zeros((2, 3)), "s": [{"k": jnp.zeros(2, jnp.int32)}]}
    got, m = jckpt.restore(str(tmp_path / "port"), jlike)
    assert m["step"] == 4 and m["extra"] == {"a": 1}
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["s"][0]["k"]), [1, 2])

    jckpt.save(str(tmp_path / "jax"), 5, jlike, extra={"b": 2})
    back, m = ckpt.restore(str(tmp_path / "jax"), tree)
    assert m["step"] == 5 and m["extra"] == {"b": 2}
    assert back["w"].dtype == torch.float32 and not back["w"].any()
    with open(tmp_path / "port" / "step_00000004" / "manifest.json") as f:
        port_paths = json.load(f)["paths"]
    with open(tmp_path / "jax" / "step_00000005" / "manifest.json") as f:
        assert json.load(f)["paths"] == port_paths
