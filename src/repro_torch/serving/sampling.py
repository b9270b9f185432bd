"""Token samplers: greedy / temperature / top-k / nucleus (top-p).

Every sampler maps (B, V) logits to (B,) int32 token ids on the logits'
device; nothing is read back to the host.

Two generations of API live here, as in the JAX package:

  * the whole-batch samplers (``greedy`` / ``temperature_sample`` / ... /
    ``make_sampler(SamplerConfig)``) apply ONE sampler config to every
    row — the offload runtime's benchmark loop uses them;
  * the request-level API (:class:`SamplingParams`, :func:`pack_sampling`,
    :func:`sample_rows`) vectorizes the sampler *parameters* over rows:
    each row carries its own kind/temperature/top-k/top-p and its own
    random key, so one decode batch can mix greedy and stochastic
    requests.

Keys are 64-bit integers.  :func:`request_key` derives a request's key
from its ``seed`` (or from the serving base seed and the request id) and
:func:`step_key` the key of its ``n``-th sampled token, both through the
splitmix64 finalizer.  A row's draw is Gumbel-max over the surviving
sorted logits, with noise that is a function of the row's step key and
the sorted position alone (:func:`gumbel_noise`: the splitmix64 stream
seeded with the key, computed on the logits' device in int64 arithmetic),
so every row's draw depends only on that row's logits and that row's key
— never on its position in the batch, on the other rows, or on the
decode step: paged and dense, one-shot and batched execution of the same
requests draw the same tokens, on the CPU and on the card alike.  The
noise is one vectorized chain of device operations, so a sampling step
can be captured in a CUDA graph.  The stream is not JAX's threefry: the
port agrees with the JAX package in distribution, and bit for bit where
no row draws (greedy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "greedy"        # greedy | temperature | topk | topp
    temperature: float = 1.0
    top_k: int = 40
    top_p: float = 0.9


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers whose output
    bits each depend on every input bit."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def seed_key(seed: int) -> int:
    """The key of a user seed (the counterpart of ``PRNGKey(seed)``)."""
    return _mix64(int(seed) & _MASK64)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (the counterpart of
    ``jax.random.fold_in``)."""
    return _mix64(key ^ _mix64(int(data) & _MASK64))


_GAMMA = 0x9E3779B97F4A7C15                # splitmix64's increment


def _signed(x: int) -> int:
    """A 64-bit key as torch's int64 (two's complement)."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` elementwise on an int64 tensor (wrapping
    arithmetic)."""
    x = x + _signed(_GAMMA)
    x = (x ^ _shr(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def key_tensor(keys: Sequence[Optional[int]], device=None) -> torch.Tensor:
    """(B,) int64 step keys on ``device`` (None: 0).  The host-to-device
    copy does not wait for the device."""
    t = torch.tensor([_signed(k or 0) for k in keys], dtype=torch.int64)
    return t.to(device, non_blocking=True) if device is not None else t


def gumbel_noise(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) fp32 standard Gumbel noise: position ``j`` of row ``i`` is
    ``-log(-log u)`` with ``u`` from the top 53 bits of ``_mix64(keys[i] +
    j * gamma)``, the ``j``-th output of the splitmix64 stream seeded
    with the row's key (``u`` lies strictly inside (0, 1), so the noise is
    finite)."""
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = _mix64_t(keys[:, None] + pos * _signed(_GAMMA))
    u = (_shr(x, 11).double() + 0.5) * 2.0 ** -53
    return (-torch.log(-torch.log(u))).float()


def _gumbel_argmax(scores: torch.Tensor, keys) -> torch.Tensor:
    """Per-row categorical draw over ``scores`` (B, V) (unnormalized
    log-probabilities, ``-inf`` where excluded): ``argmax(scores + G)``
    with ``G`` the row's :func:`gumbel_noise`.  ``keys``: a (B,) int64
    tensor on the scores' device, or one key per row."""
    if not isinstance(keys, torch.Tensor):
        keys = key_tensor(keys, scores.device)
    return torch.argmax(scores + gumbel_noise(keys, scores.shape[-1]),
                        dim=-1)


def greedy(logits: torch.Tensor, key: Optional[int] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax (first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _batch_keys(key: int, b: int):
    """One key per row of a whole-batch draw."""
    return [fold_in(key, i) for i in range(b)]


def temperature_sample(logits: torch.Tensor, key: int,
                       temperature: float = 1.0) -> torch.Tensor:
    t = max(temperature, 1e-4)
    x = logits.float() / t
    return _gumbel_argmax(x, _batch_keys(key, x.shape[0])).to(torch.int32)


def topk_sample(logits: torch.Tensor, key: int, k: int = 40,
                temperature: float = 1.0) -> torch.Tensor:
    vals, idx = torch.topk(logits.float(), k, dim=-1)
    t = max(temperature, 1e-4)
    choice = _gumbel_argmax(vals / t, _batch_keys(key, vals.shape[0]))
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)


def topp_sample(logits: torch.Tensor, key: int, p: float = 0.9,
                temperature: float = 1.0) -> torch.Tensor:
    t = max(temperature, 1e-4)
    probs = torch.softmax(logits.float() / t, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_probs, dim=-1)
    # smallest set with cumulative mass >= p: keep tokens whose prob >= cutoff
    cutoff_idx = torch.sum(csum < p, dim=-1).clamp(max=probs.shape[-1] - 1)
    cutoff = torch.gather(sorted_probs, -1, cutoff_idx[:, None])
    masked = torch.where(probs >= cutoff, torch.log(probs + 1e-30),
                         torch.full_like(probs, -1e30))
    return _gumbel_argmax(masked, _batch_keys(key, probs.shape[0])) \
        .to(torch.int32)


def make_sampler(cfg: SamplerConfig):
    """``fn(logits, key) -> tokens`` applying ``cfg`` to every row."""
    if cfg.kind == "greedy":
        return lambda logits, key: greedy(logits)
    if cfg.kind == "temperature":
        return lambda logits, key: temperature_sample(
            logits, key, cfg.temperature)
    if cfg.kind == "topk":
        return lambda logits, key: topk_sample(logits, key, cfg.top_k,
                                               cfg.temperature)
    if cfg.kind == "topp":
        return lambda logits, key: topp_sample(logits, key, cfg.top_p,
                                               cfg.temperature)
    raise ValueError(f"unknown sampler {cfg.kind!r}")


# ---------------------------------------------------------------------------
# Request-level sampling: per-row parameters, per-request random streams.
# ---------------------------------------------------------------------------

_KINDS = ("greedy", "temperature", "topk", "topp")
_KIND_ID = {k: i for i, k in enumerate(_KINDS)}


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling parameters (the serving front door's unit).

    ``top_k <= 0`` disables top-k truncation; ``top_p >= 1`` disables
    nucleus truncation (but for the tokens after the fp32 running sum has
    rounded to 1, as in the JAX package) — both filters compose, so ``kind="topp"`` with a
    positive ``top_k`` applies both.  ``seed`` pins the request's random
    stream; ``None`` derives it from the serving base seed and the
    request id (:func:`request_key`).
    """

    kind: str = "greedy"        # greedy | temperature | topk | topp
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    # None = no logprobs; k >= 0 = record each sampled token's logprob
    # plus its k most likely alternatives (k=0: the chosen token only)
    logprobs: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError("logprobs must be None or >= 0")

    @classmethod
    def from_config(cls, cfg: SamplerConfig,
                    seed: Optional[int] = None) -> "SamplingParams":
        """Lift a whole-batch :class:`SamplerConfig` to request level."""
        return cls(kind=cfg.kind, temperature=cfg.temperature,
                   top_k=cfg.top_k if cfg.kind == "topk" else 0,
                   top_p=cfg.top_p if cfg.kind == "topp" else 1.0,
                   seed=seed)


def request_key(base_key: int, rid: int, params: SamplingParams) -> int:
    """The key owning one request's whole sampling stream; ``base_key``
    is :func:`seed_key` of the serving seed."""
    if params.seed is not None:
        return seed_key(params.seed)
    return fold_in(base_key, rid)


def step_key(req_key: int, n_generated: int) -> int:
    """Key for the request's ``n_generated``-th sampled token (0-based).

    Indexing by the request's own token count — not by decode-step or
    batch-row number — is what makes draws independent of scheduling.
    """
    return fold_in(req_key, n_generated)


def pack_sampling(params: Sequence[SamplingParams],
                  device=None) -> Dict:
    """Row-vectorize a list of per-request params into device tensors."""
    return {
        "kind": torch.tensor([_KIND_ID[p.kind] for p in params],
                             dtype=torch.int32, device=device),
        "temperature": torch.tensor([p.temperature for p in params],
                                    dtype=torch.float32, device=device),
        "top_k": torch.tensor([p.top_k for p in params], dtype=torch.int32,
                              device=device),
        "top_p": torch.tensor([p.top_p for p in params],
                              dtype=torch.float32, device=device),
    }


def descending_order(logits: torch.Tensor) -> torch.Tensor:
    """Per-row descending argsort with the JAX package's tie order
    (``argsort(x)[:, ::-1]``: among equal logits the *higher* index comes
    first), i.e. a stable ascending argsort reversed."""
    return torch.argsort(logits, dim=-1, stable=True).flip(-1)


def filter_sorted(logits: torch.Tensor, packed: Dict):
    """The per-row filter of :func:`sample_rows`: returns ``(order,
    sorted_scaled, keep)`` — the descending order, the temperature-scaled
    logits in that order, and the (B, V) mask of surviving sorted
    positions."""
    logits = logits.float()
    n_vocab = logits.shape[-1]
    t = packed["temperature"].clamp(min=1e-4)[:, None]
    order = descending_order(logits)
    sorted_scaled = torch.gather(logits / t, -1, order)
    probs = torch.softmax(sorted_scaled, dim=-1)
    pos = torch.arange(n_vocab, device=logits.device)[None, :]
    k = packed["top_k"][:, None]
    keep = torch.where(k > 0, pos < k, torch.ones_like(pos, dtype=torch.bool))
    csum = torch.cumsum(probs, dim=-1)
    keep = keep & ((csum - probs) < packed["top_p"][:, None])
    keep[:, 0] = True
    return order, sorted_scaled, keep


def sample_rows(logits: torch.Tensor, keys, packed: Dict,
                top_logprobs: Optional[int] = None):
    """Sample one token per row under per-row parameters.

    ``logits``: (B, V) fp; ``keys``: one step key per row (rows with
    ``kind="greedy"`` never use theirs, which may be None), or the (B,)
    int64 :func:`key_tensor` of them on the logits' device; ``packed``:
    :func:`pack_sampling` output on the logits' device.  Given tensors
    only, the call is a fixed chain of device operations (no host sync),
    which a CUDA graph can capture.

    One descending sort per row serves every kind: top-k keeps the first
    ``k`` sorted positions, top-p keeps the smallest prefix whose
    cumulative mass reaches ``p`` (the crossing token included), and the
    draw is a per-row categorical over the surviving sorted logits with
    that row's own key.  Position 0 always survives, so the filters can
    never empty a row.

    With ``top_logprobs`` (an int >= 0) the same sort also yields the
    serving-API logprob payload — returns ``(tokens, info)`` where
    ``info`` holds ``logprob`` (B,) for the sampled token and
    ``top_tokens`` / ``top_logprobs`` (B, k) alternatives, all under the
    raw model distribution.
    """
    logits = logits.float()
    order, sorted_scaled, keep = filter_sorted(logits, packed)
    masked = torch.where(keep, sorted_scaled,
                         torch.full_like(sorted_scaled, -torch.inf))
    choice = _gumbel_argmax(masked, keys)
    sampled = torch.gather(order, -1, choice[:, None])[:, 0]
    toks = torch.where(packed["kind"] == _KIND_ID["greedy"],
                       torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)
    if top_logprobs is None:
        return toks
    kk = max(int(top_logprobs), 0)
    log_z = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, toks[:, None].long())[:, 0] - log_z
    top = order[:, :kk]
    info = {"logprob": chosen,
            "top_tokens": top,
            "top_logprobs": torch.gather(logits, -1, top) - log_z[:, None]}
    return toks, info
