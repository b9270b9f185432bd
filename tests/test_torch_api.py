"""The port's serving front door against the JAX package's: the same
params and requests through ``LLM(paged=True, backend=HeteGenBackend(...))``
with ``submit`` + ``drain`` give identical greedy tokens — chunked
admission with a pool small enough to force swap preemption, and int8
pages with int8 weight streaming — on ``tiny`` and a reduced OPT.  The
backends run on the paper's A10 spec with ``alpha_override=1.0``: with
the 128-column tile the 128-wide MLP input linear streams to the device
while the 64-wide linears stay on the host (split linears are covered by
tests/test_torch_engine.py with a 16-column tile)."""
import jax
import jax.tree_util as jtu
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.core.hw import PAPER_A10 as J_A10
from repro.models import model as JM
from repro.serving.api import LLM as JLLM
from repro.serving.backends import HeteGenBackend as JHB
from repro_torch.core.hw import PAPER_A10 as T_A10
from repro_torch.models import model as TM
from repro_torch.serving.api import LLM
from repro_torch.serving.backends import HeteGenBackend
from repro_torch.launch import serve
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.speculative import NgramDrafter, SpecConfig
from repro_torch.serving.tokenizer import ByteTokenizer


@pytest.fixture(scope="module", params=["tiny", "opt-125m"])
def setup(request):
    cfg = get_config(request.param)
    if request.param != "tiny":
        cfg = reduced(cfg)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jtu.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, cfg.vocab_size, n))
               for n in (8, 12, 8, 12)]
    return cfg, jp, tp, prompts


def _serve(llm_cls, hb_cls, hw, cfg, params, prompts, wstream, dev, **kw):
    hb_kw = dict(hw=hw, budget_bytes=0, batch=2, alpha_override=1.0,
                 wstream=wstream)
    if dev is not None:
        hb_kw["device"] = dev
    hb = hb_cls(cfg, params, **hb_kw)
    with llm_cls(cfg, backend=hb, own_backend=True, max_slots=2, max_len=32,
                 paged=True, wstream=wstream, **kw) as llm:
        rids = [llm.submit(p, max_new=6) for p in prompts]
        outs = llm.drain()
        st = llm.stats()
    return [outs[r].tokens for r in rids], st


@pytest.mark.parametrize("wstream,kw", [
    ("fp", dict(chunk_tokens=4, page_size=8, n_pages=4)),
    ("q8", dict(kv_dtype="int8", page_size=4))])
def test_greedy_tokens_identical_to_jax(setup, wstream, kw):
    cfg, jp, tp, prompts = setup
    want, jst = _serve(JLLM, JHB, J_A10, cfg, jp, prompts, wstream, None,
                       **kw)
    got, st = _serve(LLM, HeteGenBackend, T_A10, cfg, tp, prompts, wstream,
                     "cpu", **kw)
    assert got == want
    assert all(len(t) == 6 for t in got)
    assert st["scheduler"]["preemptions"] == \
        jst["scheduler"]["preemptions"]
    if "n_pages" in kw:
        assert st["scheduler"]["preemptions"] > 0
        assert st["scheduler"]["chunks_planned"] > len(prompts)
    assert st["phase_alpha"] == jst["phase_alpha"]
    assert st["stream"].trans > 0 and st["stream"].cpu > 0


def test_unported_features_raise(setup):
    cfg, jp, tp, prompts = setup
    with JLLM(cfg, jp, max_slots=2, max_len=32) as jllm:
        want = [o.tokens for o in jllm.generate([prompts[0], prompts[2]],
                                                max_new=3)]
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32) as llm:
        # nucleus sampling is served now
        rid = llm.submit(prompts[0], 3,
                         sampling=SamplingParams(kind="topp", top_p=0.9))
        topp = llm.drain()[rid].tokens
        assert len(topp) == 3
        assert all(0 <= t < cfg.vocab_size for t in topp)
        # a rectangular batch runs one-shot, token-identical to JAX's
        one = llm.generate([prompts[0], prompts[2]], max_new=3)
        assert llm.last_executor == "generator"
        assert [o.tokens for o in one] == want
        # a ragged batch runs through the batcher
        outs = llm.generate(prompts[:2], max_new=3)
        assert llm.last_executor == "batcher"
        assert [len(o.tokens) for o in outs] == [3, 3]
    # speculative decoding and text I/O are served now, token-identical
    # to the plain run; the launcher's --dryrun traces its dry-run cell
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32,
             spec=SpecConfig(NgramDrafter(), k=2),
             tokenizer=ByteTokenizer(eos_id=None)) as llm:
        spec_outs = llm.generate(prompts[:2], max_new=3)
        assert llm.last_executor == "batcher"
        assert [o.tokens for o in spec_outs] == [o.tokens for o in outs]
        assert spec_outs[0].text == ByteTokenizer().decode(outs[0].tokens)
        assert "spec" in llm.stats()
    rec = serve.serve(serve.build_parser().parse_args(
        ["--arch", "tiny", "--device", "meta", "--dryrun"]))
    assert rec["status"] == "ok", rec.get("traceback")
    # tracing and trace-driven recalibration are served now
    with LLM(cfg, tp, device="cpu", max_slots=2, max_len=32,
             trace=True) as llm:
        traced = llm.generate(prompts[:2], max_new=3)
        assert llm.last_executor == "batcher"
        assert [o.tokens for o in traced] == [o.tokens for o in outs]
        assert {"step", "phase", "sample"} <= {
            s.track for s in llm.tracer.spans()}
    hb = HeteGenBackend(cfg, tp, device="cpu", recalibrate=0.05)
    assert hb.recalibrate == 0.05 and hb.recalibrations == 0
    hb.close()
    with pytest.raises(ValueError):
        LLM(cfg, tp, device="cpu", wstream="q8")
