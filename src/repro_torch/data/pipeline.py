"""Data pipeline: tokenizer, synthetic corpus, packing, host-side prefetch.

Everything the training examples need, built in-repo with numpy only (a
copy of the JAX package's ``data/pipeline.py``: the same arrays from the
same seed, bit for bit):

* :class:`ByteTokenizer` — reversible byte-level vocabulary (256 + specials)
* :func:`synthetic_corpus` — seeded documents with learnable structure
  (repeated n-gram motifs), so tiny-model training demonstrably reduces
  loss below the uniform floor
* :class:`PackedLMDataset` — documents packed into fixed (B, S) batches with
  next-token labels, deterministic given (seed, step)
* :class:`Prefetcher` — background thread keeping ``depth`` batches ready so
  host input never stalls the device step (the single-host analogue of a
  per-host input pipeline)
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


class ByteTokenizer:
    PAD, BOS, EOS = 256, 257, 258

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str) -> List[int]:
        return [self.BOS] + list(text.encode("utf-8")) + [self.EOS]

    def decode(self, ids) -> str:
        bs = bytes(i for i in ids if i < 256)
        return bs.decode("utf-8", errors="replace")


def synthetic_corpus(n_docs: int, *, vocab: int, seed: int = 0,
                     min_len: int = 64, max_len: int = 512,
                     motif_len: int = 8, n_motifs: int = 32
                     ) -> List[np.ndarray]:
    """Documents built from a shared motif bank: the next token is highly
    predictable within a motif, so cross entropy can drop well below
    log(vocab)."""
    rng = np.random.default_rng(seed)
    motifs = rng.integers(0, vocab, (n_motifs, motif_len))
    docs = []
    for _ in range(n_docs):
        length = int(rng.integers(min_len, max_len))
        out: List[int] = []
        while len(out) < length:
            m = motifs[int(rng.integers(0, n_motifs))]
            out.extend(m.tolist())
        docs.append(np.asarray(out[:length], np.int32))
    return docs


class PackedLMDataset:
    """Packs documents into (B, S) token blocks with next-token labels."""

    def __init__(self, docs: List[np.ndarray], *, batch: int, seq: int,
                 seed: int = 0, pad_id: int = 0):
        self.batch, self.seq = batch, seq
        stream = np.concatenate(docs)
        self.rng = np.random.default_rng(seed)
        n_tokens = batch * (seq + 1)
        reps = max(1, -(-n_tokens * 4 // len(stream)))
        self.stream = np.concatenate([stream] * reps)
        self.pos = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.batch * (self.seq + 1)
        if self.pos + need > len(self.stream):
            self.pos = 0
        chunk = self.stream[self.pos:self.pos + need]
        self.pos += need
        block = chunk.reshape(self.batch, self.seq + 1)
        return {"tokens": np.ascontiguousarray(block[:, :-1]),
                "labels": np.ascontiguousarray(block[:, 1:])}


class Prefetcher:
    """Thread that keeps up to ``depth`` batches materialized ahead."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self.it:
                if self.done:
                    return
                self.q.put(item)
        except Exception as e:            # propagate through the queue
            self.q.put(e)
        finally:
            self.q.put(StopIteration())

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, StopIteration):
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self.done = True


def make_training_data(cfg, *, batch: int, seq: int, seed: int = 0,
                       prefetch: int = 2):
    docs = synthetic_corpus(256, vocab=cfg.vocab_size, seed=seed)
    ds = PackedLMDataset(docs, batch=batch, seq=seq, seed=seed)
    return Prefetcher(iter(ds), depth=prefetch)
