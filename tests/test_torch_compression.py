"""int8 gradient compression against the JAX package's
``repro.distributed.compression``: quantize / dequantize / error feedback
bit-equal on seeded inputs, the wire-byte ratio, and the compressed mean
over a world of 2 gloo ranks against the reference's formula (the mean of
each rank's quantize-dequantize)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.distributed import compression as TC

SHAPES = [(5000,), (64, 96), (3, 7, 11), (2048,)]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * (1 + seed)


@pytest.mark.parametrize("chunk", [2048, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_dequantize_bit_equal(shape, chunk):
    import jax.numpy as jnp
    from repro.distributed import compression as JC
    x = _x(shape, 1)
    jq, js, jshape = JC.quantize_int8(jnp.asarray(x), chunk)
    tq, ts, tshape = TC.quantize_int8(torch.from_numpy(x), chunk)
    assert tuple(jshape) == tshape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TC.dequantize_int8(tq, ts, tshape).numpy(),
        np.asarray(JC.dequantize_int8(jq, js, jshape)))
    np.testing.assert_array_equal(
        TC.quantization_error(torch.from_numpy(x), chunk).numpy(),
        np.asarray(JC.quantization_error(jnp.asarray(x), chunk)))


def test_error_feedback_bit_equal():
    import jax.numpy as jnp
    from repro.distributed import compression as JC
    grads = {"a": _x((300,), 2), "b": {"c": _x((40, 50), 3)}}
    jg = {"a": jnp.asarray(grads["a"]), "b": {"c": jnp.asarray(grads["b"]["c"])}}
    tg = {"a": torch.from_numpy(grads["a"]),
          "b": {"c": torch.from_numpy(grads["b"]["c"])}}
    je, te = JC.ef_init(jg), TC.ef_init(tg)
    for _ in range(3):                       # the residual carries over
        jp, je = JC.ef_compress(jg, je, chunk=128)
        tp, te = TC.ef_compress(tg, te, chunk=128)
        np.testing.assert_array_equal(te["a"].numpy(), np.asarray(je["a"]))
        np.testing.assert_array_equal(te["b"]["c"].numpy(),
                                      np.asarray(je["b"]["c"]))
        np.testing.assert_array_equal(tp["b"]["c"][0].numpy(),
                                      np.asarray(jp["b"]["c"][0]))


def test_wire_byte_ratio():
    # the reference's docstring: n + n/chunk*4 against 4n (~3.9x)
    n, chunk = 1 << 20, 2048
    comp, full = TC.wire_bytes(n, chunk)
    assert comp == n + n // chunk * 4 and full == 4 * n
    assert full / comp == pytest.approx(4 * chunk / (chunk + 4))


def _worker(rank: int, world: int, root: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=world)
    try:
        x = torch.from_numpy(_x((3000,), 10 + rank))
        got = TC.compressed_psum_mean(x, dist.group.WORLD, chunk=512)
        if rank == 0:
            np.save(os.path.join(root, "got.npy"), got.numpy())
    finally:
        dist.destroy_process_group()


def test_compressed_psum_mean_two_ranks(tmp_path):
    import jax.numpy as jnp
    from repro.distributed import compression as JC
    mp.spawn(_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    got = np.load(tmp_path / "got.npy")
    deq = []
    for r in range(2):
        q, s, shp = JC.quantize_int8(jnp.asarray(_x((3000,), 10 + r)), 512)
        deq.append(np.asarray(JC.dequantize_int8(q, s, shp)))
    want = np.mean(np.stack(deq), axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
