"""Tokenizer-aware text IO for the serving front door.

The serving stack is token-native — every queue, cache, and sampler
works on int32 ids — so text support is a thin boundary layer: a
:class:`Tokenizer` protocol (``encode``/``decode`` plus an eos id) that
the :class:`repro_torch.serving.api.LLM` facade calls at submit time and in
its output/streaming paths.  Anything with those two methods plugs in
(a sentencepiece/BPE wrapper in real deployments); the in-repo default
is :class:`ByteTokenizer`, which maps UTF-8 bytes to ids 0..255 — no
vocabulary files, works with any model whose vocab covers 256 ids, and
is exactly what the tiny test config needs.

Streaming text is stateful: a token boundary can split a multi-byte
UTF-8 character, so :class:`StreamDecoder` buffers incomplete suffixes
and only releases whole characters — a facade stream yields ``""`` for
a token that ends mid-character and the full character once its last
byte arrives.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    """The text boundary: ids in, ids out; everything inside is tokens.

    ``eos_id`` may be None (no end-of-sequence convention); the facade
    threads it into submissions that don't pass an explicit ``eos``.
    """

    eos_id: Optional[int]

    def encode(self, text: str) -> List[int]: ...

    def decode(self, tokens: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as token ids 0..255 (vocab 256 + optional eos).

    ``eos_id`` defaults to 0 (the NUL byte, which never appears in
    sensible text); pass ``eos_id=None`` to disable.  Ids outside 0..255
    decode as the replacement character rather than raising — a sampled
    model token need not be a valid byte.
    """

    vocab_size = 256

    def __init__(self, eos_id: Optional[int] = 0):
        self.eos_id = eos_id

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: Sequence[int]) -> str:
        data = bytes(max(0, min(int(t), 255)) for t in tokens)
        return data.decode("utf-8", errors="replace")


class StreamDecoder:
    """Incremental UTF-8 decoding over a token stream.

    ``push(token)`` returns the text completed by that token — possibly
    ``""`` while a multi-byte character is still accumulating; ``flush``
    drains whatever trailing bytes remain (replacement characters for an
    incomplete tail)."""

    def __init__(self, tok: Tokenizer):
        self.tok = tok
        self._pending: List[int] = []

    def push(self, token: int) -> str:
        self._pending.append(int(token))
        text = self.tok.decode(self._pending)
        # a trailing replacement char usually means a split character —
        # hold the bytes back until the sequence completes or diverges
        if text.endswith("�"):
            probe = self.tok.decode(self._pending[-1:])
            if probe == "�" and len(self._pending) < 8:
                return ""
        self._pending = []
        return text

    def flush(self) -> str:
        text = self.tok.decode(self._pending)
        self._pending = []
        return text
