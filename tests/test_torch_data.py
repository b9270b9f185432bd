"""The port's data pipeline gives the JAX package's arrays bit for bit from
the same seed — corpus, packed batches and labels, the prefetcher's order,
``make_training_data`` — and keeps the JAX package's own properties
(``test_data.py``)."""
import numpy as np
import pytest

from repro.configs import get_config
from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("seed,vocab", [(0, 100), (3, 512), (7, 256000)])
def test_corpus_bit_identical(seed, vocab):
    a = JP.synthetic_corpus(12, vocab=vocab, seed=seed)
    b = TP.synthetic_corpus(12, vocab=vocab, seed=seed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("batch,seq", [(4, 32), (1, 4096), (8, 64)])
def test_packed_batches_bit_identical(batch, seq):
    docs = TP.synthetic_corpus(16, vocab=50, seed=0)
    a = JP.PackedLMDataset(docs, batch=batch, seq=seq)
    b = TP.PackedLMDataset(docs, batch=batch, seq=seq)
    for _ in range(5):                       # past a wrap of the stream
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        np.testing.assert_array_equal(y["tokens"][:, 1:],
                                      y["labels"][:, :-1])


def test_make_training_data_bit_identical():
    cfg = get_config("tiny")
    a = JP.make_training_data(cfg, batch=4, seq=32, seed=2)
    b = TP.make_training_data(cfg, batch=4, seq=32, seed=2)
    for _ in range(4):
        x, y = next(a), next(b)
        assert all(np.array_equal(x[k], y[k]) for k in ("tokens", "labels"))
    a.close()
    b.close()


def test_tokenizer_matches():
    s = "HeteGen: héllo ✓"
    assert TP.ByteTokenizer().encode(s) == JP.ByteTokenizer().encode(s)
    assert TP.ByteTokenizer().decode(TP.ByteTokenizer().encode(s)) == s
    assert TP.ByteTokenizer().vocab_size == 259


def test_prefetcher_yields_everything_in_order():
    items = [{"i": np.asarray(i)} for i in range(10)]
    out = list(TP.Prefetcher(iter(items), depth=3))
    assert [int(x["i"]) for x in out] == list(range(10))


def test_prefetcher_propagates_errors():
    def gen():
        yield {"i": 0}
        raise ValueError("bad shard")
    it = TP.Prefetcher(gen(), depth=2)
    assert next(it) == {"i": 0}
    with pytest.raises(ValueError, match="bad shard"):
        next(it)


def test_motif_structure_is_learnable():
    docs = TP.synthetic_corpus(64, vocab=200, seed=1, motif_len=8,
                               n_motifs=8)
    stream = np.concatenate(docs)
    pairs = {}
    for a, b in zip(stream[:-1], stream[1:]):
        pairs.setdefault(int(a), []).append(int(b))
    dom = [np.bincount(v).max() / len(v) for v in pairs.values()
           if len(v) > 10]
    assert np.mean(dom) > 0.5
