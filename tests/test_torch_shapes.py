"""``repro_torch.configs.shapes`` against the JAX package's
``repro.configs.shapes``: for every assigned architecture at full size and
every assigned shape, ``input_specs`` gives the same tree with the same
shapes and dtypes (stand-ins on the meta device against
``ShapeDtypeStruct``s, nothing allocated), and ``shape_applicable`` the
same verdict; ``spec_only=False`` gives zeros on the asked device.
"""
import jax
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config, reduced
from repro.configs import shapes as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import shapes as TS


def _desc(tree):
    """{path: (shape, dtype name)} of a tree of tensors or JAX stand-ins."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update({(k,) + p: d for p, d in _desc(v).items()})
        return out
    dt = str(tree.dtype).replace("torch.", "")
    return {(): (tuple(tree.shape), dt)}


def test_shapes_table_is_the_jax_packages():
    assert {k: (v.name, v.kind, v.seq, v.batch)
            for k, v in TS.SHAPES.items()} \
        == {k: (v.name, v.kind, v.seq, v.batch)
            for k, v in JS.SHAPES.items()}


@pytest.mark.parametrize("shape", list(JS.SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match(arch, shape):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    ok, why = TS.shape_applicable(tcfg, shape)
    jok, jwhy = JS.shape_applicable(jcfg, shape)
    assert ok == jok and bool(why) == bool(jwhy)
    got = TS.input_specs(tcfg, shape)
    want = JS.input_specs(jcfg, shape)
    assert all(isinstance(w, jax.ShapeDtypeStruct)
               for w in jax.tree_util.tree_leaves(want))
    assert all(t.device.type == "meta" for t in _leaves(got))
    assert _desc(got) == _desc(want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-mistral-7b"])
def test_input_specs_allocate_zeros_on_request(arch):
    cfg = reduced(t_get_config(arch))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        got = TS.input_specs(cfg, shape, batch_override=1, spec_only=False,
                             device="cpu")
        want = JS.input_specs(reduced(get_config(arch)), shape,
                              batch_override=1)
        assert _desc(got) == _desc(want)
        for t in _leaves(got):
            assert t.device.type == "cpu" and not bool(t.any())
