"""The port's checkpoint manager: the JAX package's own cases
(``test_checkpoint.py``: roundtrip, async save and latest, gc, no partial
checkpoint visible, restore from shard slices) on the port, and
checkpoints read across packages — an fp32 state written by
``repro.checkpoint.manager`` restored by the port bit for bit, the
reverse, and a bf16 state written by the JAX package restored exactly by
the port (the JAX package cannot read its own bf16 files back: its
restore casts the loaded ``|V2`` words)."""
import json
import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.model import params_from_numpy


def _state(key=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(key)
    return {"params": {"w": torch.randn(16, 8, generator=g).to(dtype),
                       "b": torch.zeros(8, dtype=dtype)},
            "step": torch.tensor(7 + key, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roundtrip(tmp_path, dtype):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state(dtype=dtype)
    mgr.save(7, st)
    back = mgr.restore(7, _zeros_like(st))
    for a, b in zip(_leaves(st), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, _state(s))
    mgr.wait()
    assert mgr.list_steps() == [1, 2, 3]
    back = mgr.restore_latest(_zeros_like(_state()))
    assert int(back["step"]) == int(_state(3)["step"])
    assert torch.equal(back["params"]["w"], _state(3)["params"]["w"])


def test_async_save_snapshots_before_writing(tmp_path):
    """``save`` copies the tensors first: an in-place update right after
    it (the optimizer's) does not reach the files."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    st = _state(1)
    want = st["params"]["w"].clone()
    mgr.save(1, st)
    st["params"]["w"].add_(100.0)
    mgr.wait()
    back = mgr.restore(1, _zeros_like(st))
    assert torch.equal(back["params"]["w"], want)


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in range(5):
        mgr.save(s, _state(s))
    assert mgr.list_steps() == [3, 4]


def test_no_partial_checkpoint_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state())
    os.makedirs(os.path.join(str(tmp_path), "step_000000099.tmp"))
    assert mgr.list_steps() == [1]


def test_restore_from_shard_slices(tmp_path):
    """Manifest index ranges reassemble a leaf saved in two halves."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mgr.save(1, {"w": w})
    d = os.path.join(str(tmp_path), "step_000000001")
    man = json.load(open(os.path.join(d, "manifest.json")))
    data = np.load(os.path.join(d, man["leaves"][0]["shards"][0]["file"]))
    np.save(os.path.join(d, "leaf_00000_shard_000.npy"), data[:4])
    np.save(os.path.join(d, "leaf_00000_shard_001.npy"), data[4:])
    man["leaves"][0]["shards"] = [
        {"file": "leaf_00000_shard_000.npy", "index": [[0, 4], [0, 8]]},
        {"file": "leaf_00000_shard_001.npy", "index": [[4, 8], [0, 8]]},
    ]
    json.dump(man, open(os.path.join(d, "manifest.json"), "w"))
    back = mgr.restore(1, {"w": torch.zeros(8, 8)})
    assert torch.equal(back["w"], w)


def test_restore_onto_template_dtype_and_layout(tmp_path):
    """Each leaf takes the template's dtype; paths are JAX's keystr."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, _state())
    man = json.load(open(os.path.join(str(tmp_path), "step_000000002",
                                      "manifest.json")))
    assert [e["path"] for e in man["leaves"]] == [
        "['params']['b']", "['params']['w']", "['step']"]
    assert [e["dtype"] for e in man["leaves"]] == ["float32", "float32",
                                                   "int32"]
    tmpl = _zeros_like(_state())
    tmpl["params"]["w"] = tmpl["params"]["w"].double()
    back = mgr.restore(2, tmpl)
    assert back["params"]["w"].dtype == torch.float64


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _jax_state(dtype):
    k = jax.random.PRNGKey(3)
    return {"params": {"blocks": {"pos0": {"attn": {
                "wq": jax.random.normal(k, (6, 4)).astype(dtype)}}},
                       "embed": jax.random.normal(k, (5, 3)).astype(dtype)},
            "opt": {"count": jnp.asarray(2, jnp.int32),
                    "m": {"w": jnp.ones((3,), jnp.float32)}},
            "step": jnp.asarray(11, jnp.int32)}


def _np_state(dtype):
    return jtu.tree_map(np.asarray, _jax_state(dtype))


def test_jax_fp32_checkpoint_restores_in_port(tmp_path):
    JCM(str(tmp_path), async_save=False).save(4, _jax_state(jnp.float32))
    want = _np_state(jnp.float32)
    tmpl = _zeros_like(params_from_numpy(want, device="cpu"))
    back = CheckpointManager(str(tmp_path)).restore(4, tmpl)
    got_leaves = _leaves(back)
    want_leaves = jtu.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_port_fp32_checkpoint_restores_in_jax(tmp_path):
    want = _np_state(jnp.float32)
    CheckpointManager(str(tmp_path), async_save=False).save(
        5, params_from_numpy(want, device="cpu"))
    tmpl = jtu.tree_map(jnp.zeros_like, _jax_state(jnp.float32))
    back = JCM(str(tmp_path)).restore(5, tmpl)
    for g, w in zip(jtu.tree_leaves(back), jtu.tree_leaves(want)):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_jax_bf16_checkpoint_restores_exactly_in_port(tmp_path):
    JCM(str(tmp_path), async_save=False).save(6, _jax_state(jnp.bfloat16))
    want = _np_state(jnp.bfloat16)
    tmpl = _zeros_like(params_from_numpy(want, device="cpu"))
    back = CheckpointManager(str(tmp_path)).restore(6, tmpl)
    w = want["params"]["blocks"]["pos0"]["attn"]["wq"]
    g = back["params"]["blocks"]["pos0"]["attn"]["wq"]
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
    np.testing.assert_array_equal(back["params"]["embed"].view(
        torch.int16).numpy(), want["params"]["embed"].view(np.int16))
    assert int(back["step"]) == 11 and int(back["opt"]["count"]) == 2


def test_port_bf16_files_are_the_jax_package_bytes(tmp_path):
    """The port writes a bf16 leaf byte for byte as the JAX package does
    (an ``'<V2'`` npy, manifest dtype "bfloat16")."""
    st = _np_state(jnp.bfloat16)
    JCM(str(tmp_path / "j"), async_save=False).save(1, _jax_state(
        jnp.bfloat16))
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        1, params_from_numpy(st, device="cpu"))
    dj, dt = (os.path.join(str(tmp_path / s), "step_000000001")
              for s in ("j", "t"))
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    mt = json.load(open(os.path.join(dt, "manifest.json")))
    assert mj == mt
    for e in mj["leaves"]:
        f = e["shards"][0]["file"]
        assert open(os.path.join(dj, f), "rb").read() == \
            open(os.path.join(dt, f), "rb").read(), e["path"]
