"""Heterogeneous speculative decoding: the host drafts, the card verifies.

HeteGen's thesis is that the host should do real work instead of serving
as a weight warehouse; Dovetail (PAPERS.md) carries that CPU/GPU split
into speculative decoding.  A cheap **drafter** proposes up to ``k``
tokens on the host, and the target model scores all ``batch x (k + 1)``
candidate positions in ONE prefill-shaped pass (``backend.verify`` — the
paged-prefill kernel's per-row ``kv_offset`` makes it a multi-token
verify kernel).  In the offload serving path this turns ``k`` decode
steps — ``k`` full streams of every offloaded weight over the link —
into one.

Two drafters ship behind one protocol:

  * :class:`NgramDrafter` — prompt lookup: match the newest n-gram of the
    request's own token history against earlier positions and propose
    the continuation.  Host-side list matching, no extra weights.
  * :class:`ModelDrafter` — a small draft model run greedily through its
    own :class:`repro_torch.serving.backends.ResidentBackend`.  Keeps one
    batch-1 dense cache per request, reconciled against the request's
    token history by longest common prefix (a dense truncate is a length
    reset).

Acceptance is speculative rejection sampling for **deterministic
(point-mass) drafters**: draft ``d`` is accepted with probability
``p(d)`` under the request's *filtered* sampling distribution (the
top-k/top-p/temperature filter ``sample_rows`` applies, mirrored on the
host by :func:`filtered_probs`); on rejection the replacement is drawn
from ``p`` with ``d`` removed and renormalized, so the marginal of the
emitted token is ``p``.  Greedy requests degenerate to ``accept iff d ==
argmax`` with the argmax emitted on rejection: token-identical to the
baseline, drawing nothing.

Every draw uses the request's own random stream.  Position ``j`` of a
spec step emits generated-token index ``n0 + j``; its accept and
residual uniforms are :func:`uniform` of ``fold_in(step_key(req_key, n0
+ j), 1)`` and ``..., 2)`` — splitmix64 in Python integers, so the card
and the CPU draw the same bits (the JAX package draws them from
threefry: the two agree in distribution).  The bonus position draws
through :func:`repro_torch.serving.sampling.sample_rows` with the plain
step key, which makes a draft-less row bitwise the baseline decode draw.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.serving.sampling import (SamplingParams, _mix64, fold_in,
                                          pack_sampling, sample_rows,
                                          step_key)


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------

@runtime_checkable
class Drafter(Protocol):
    """The drafting seam: host-side token proposal.

    ``propose`` sees the request's full known token history (prompt plus
    every generated token, the pending input included) and returns up to
    ``k`` candidate continuations — fewer (or none) when it has no
    confident guess; an empty proposal falls back to a plain decode row
    for that request.  Drafters must be deterministic in their inputs: a
    preempted request re-proposes on resume, which keeps mid-speculation
    preemption token-identical.
    """

    def propose(self, rid: int, tokens: Sequence[int],
                k: int) -> List[int]: ...

    def release(self, rid: int) -> None:
        """Drop any per-request state (the request finished)."""
        ...

    def close(self) -> None: ...


class NgramDrafter:
    """Prompt-lookup drafting over the request's own history.

    Finds the most recent earlier occurrence of the newest ``n``-gram
    (longest ``n`` first) and proposes the tokens that followed it.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, rid: int, tokens: Sequence[int], k: int) -> List[int]:
        toks = [int(t) for t in tokens]
        n_toks, k = len(toks), int(k)
        if k <= 0:
            return []
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if n_toks <= n:
                continue
            pat = toks[-n:]
            # the most recent earlier occurrence wins
            for i in range(n_toks - n - 1, -1, -1):
                if toks[i:i + n] == pat:
                    cont = toks[i + n:i + n + k]
                    if cont:
                        return cont
                    break              # suffix-at-end match: shorter n
        return []

    def release(self, rid: int) -> None:
        pass

    def close(self) -> None:
        pass


class ModelDrafter:
    """A small draft model decoded greedily on resident weights.

    One batch-1 dense cache per request; ``propose`` reconciles it with
    the request's current token history by longest common prefix —
    rejected speculation resets the cache length (``cache["len"]``, an
    int32 tensor on the backend's device) and re-feeds the divergent
    tail.  ``device=`` places the drafter's own backend (built from
    ``params``); a passed ``backend`` keeps its device.
    """

    def __init__(self, cfg, params=None, *, backend=None,
                 max_len: int = 512, device=None):
        if backend is None:
            from repro_torch.serving.backends import ResidentBackend
            if params is None:
                raise ValueError("ModelDrafter needs params or a backend")
            backend = ResidentBackend(cfg, params, device=device)
            self._own_backend = True
        else:
            self._own_backend = False
        self.cfg = cfg
        self.backend = backend
        self.device = backend.device
        self.max_len = max_len
        self._fed: Dict[int, List[int]] = {}    # tokens whose KV is cached
        self._cache: Dict[int, Dict] = {}

    def propose(self, rid: int, tokens: Sequence[int], k: int) -> List[int]:
        toks = [int(t) for t in tokens]
        k = min(int(k), self.max_len - len(toks))
        if k <= 0 or not toks:
            return []
        fed = self._fed.get(rid, [])
        lcp = 0
        for a, b in zip(fed, toks):
            if a != b:
                break
            lcp += 1
        # always re-feed at least the newest token: its logits are the
        # first draft's distribution (the cache stores KV, not logits)
        start = min(lcp, len(toks) - 1)
        cache = self._cache.get(rid)
        if cache is None or start == 0:
            cache = self.backend.init_cache(1, self.max_len)
            start = 0
        else:
            cache = dict(cache)
        cache["len"] = torch.full((1,), start, dtype=torch.int32,
                                  device=self.device)
        chunk = torch.tensor([toks[start:]], dtype=torch.int32,
                             device=self.device)
        cache, logits = self.backend.prefill({"tokens": chunk}, cache)
        drafts: List[int] = []
        for j in range(k):
            nxt = int(torch.argmax(logits[0]))
            drafts.append(nxt)
            if j + 1 == k:
                break
            cache, logits = self.backend.decode(
                torch.tensor([nxt], dtype=torch.int32, device=self.device),
                cache)
        self._cache[rid] = cache
        # KV materialized: toks plus every draft except the last
        self._fed[rid] = toks + drafts[:-1]
        return drafts

    def release(self, rid: int) -> None:
        self._fed.pop(rid, None)
        self._cache.pop(rid, None)

    def close(self) -> None:
        self._fed.clear()
        self._cache.clear()
        if self._own_backend:
            self.backend.close()


# ---------------------------------------------------------------------------
# Config / stats / adaptive-k
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding knobs the serving front door exposes.

    ``k`` is the draft length (per step, before per-request budget and
    capacity caps); ``adaptive=True`` lets :class:`AdaptiveK` steer each
    request's draft length from its observed acceptance, bounded to
    ``[k_min, k_max]``.
    """

    drafter: Drafter
    k: int = 4
    adaptive: bool = False
    k_min: int = 1
    k_max: int = 8

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("SpecConfig.k must be >= 1")
        if not (1 <= self.k_min <= self.k_max):
            raise ValueError("need 1 <= k_min <= k_max")


@dataclasses.dataclass
class SpecStats:
    """Counters of one request's (or the whole batcher's) speculation."""

    steps: int = 0          # verify steps that carried >= 1 draft token
    drafted: int = 0        # draft tokens scored
    accepted: int = 0       # draft tokens emitted
    rolled_back: int = 0    # draft tokens rejected (KV truncated away)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def record(self, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        self.steps += 1
        self.drafted += drafted
        self.accepted += accepted
        self.rolled_back += drafted - accepted

    def as_dict(self) -> Dict[str, float]:
        return {"steps": self.steps, "drafted": self.drafted,
                "accepted": self.accepted, "rolled_back": self.rolled_back,
                "acceptance_rate": self.acceptance_rate}


class AdaptiveK:
    """Per-request draft-length controller.

    Deterministic hill-climb on the per-step acceptance: a fully accepted
    run earns one more draft token next step, a run where less than
    ``shrink_below`` of the drafts survived loses one; bounded to
    ``[k_min, k_max]``.
    """

    def __init__(self, k0: int, k_min: int = 1, k_max: int = 8,
                 shrink_below: float = 0.5):
        self.k0 = min(max(int(k0), k_min), k_max)
        self.k_min = k_min
        self.k_max = k_max
        self.shrink_below = shrink_below
        self._k: Dict[int, int] = {}

    def k_for(self, rid: int) -> int:
        return self._k.get(rid, self.k0)

    def update(self, rid: int, proposed: int, accepted: int) -> None:
        if proposed <= 0:
            return
        k = self._k.get(rid, self.k0)
        if accepted >= proposed:
            k = min(k + 1, self.k_max)
        elif accepted < proposed * self.shrink_below:
            k = max(k - 1, self.k_min)
        self._k[rid] = k

    def release(self, rid: int) -> None:
        self._k.pop(rid, None)


# ---------------------------------------------------------------------------
# Verification: host mirror of the row sampler + rejection sampling
# ---------------------------------------------------------------------------

def filtered_probs(logits: np.ndarray,
                   params: SamplingParams) -> np.ndarray:
    """Full-vocab probabilities after ``sample_rows``' per-row filter.

    The host mirror of the sampler's masking, numpy float32 as the JAX
    package computes it (bit-equal to its ``filtered_probs`` on equal
    logits): one stable descending sort (a reversed stable ascending
    argsort, so among ties the *higher* index sorts first),
    temperature-scaled softmax over the sorted logits, top-k keeps the
    first ``k`` sorted positions, top-p keeps the smallest prefix reaching
    mass ``p`` (crossing token included), position 0 always survives.
    Returns the renormalized distribution in vocab order.
    """
    x = np.asarray(logits, np.float32)
    t = np.float32(max(params.temperature, 1e-4))
    order = np.argsort(x, kind="stable")[::-1]
    sorted_scaled = (x / t)[order]
    e = np.exp(sorted_scaled - sorted_scaled.max())
    probs = (e / e.sum()).astype(np.float32)
    keep = np.ones(x.shape[0], bool)
    if params.top_k > 0:
        keep[params.top_k:] = False
    csum = np.cumsum(probs, dtype=np.float32)
    keep &= (csum - probs) < np.float32(params.top_p)
    keep[0] = True
    kept = np.where(keep, probs, np.float32(0))
    out = np.zeros_like(kept)
    out[order] = kept / kept.sum()
    return out


def uniform(key: int) -> float:
    """A float in [0, 1) from a 64-bit key: the top 53 bits of the
    splitmix64 finalizer of ``key`` (:func:`sampling._mix64`), times
    2^-53.  Python integer arithmetic, so every host draws the same
    bits."""
    return (_mix64(int(key)) >> 11) * 2.0 ** -53


def _inverse_cdf(probs: np.ndarray, u: float) -> int:
    idx = int(np.searchsorted(np.cumsum(probs, dtype=np.float64), u,
                              side="right"))
    return min(idx, probs.shape[0] - 1)


def accept_drafts(rows: np.ndarray, drafts: Sequence[int],
                  params: SamplingParams, req_key: int,
                  n0: int) -> Tuple[List[int], bool]:
    """Speculative rejection sampling for one request, without the bonus.

    ``rows`` is the request's slice of the verify logits, ``(len(drafts)
    + 1, V)``: row ``j`` is the model's distribution for generated-token
    index ``n0 + j``.  Returns ``(emitted, bonus)``: the accepted drafts,
    then the rejection replacement if the run was cut; ``bonus`` is True
    when every draft survived and the caller still owes the token of
    index ``n0 + len(drafts)`` (:func:`bonus_token`, or one batched
    ``sample_rows`` call over several requests' bonus rows).  Greedy
    requests run the argmax chain; stochastic ones accept ``d`` when
    ``uniform(fold_in(step_key(req_key, n0 + j), 1)) < p(d)`` and
    otherwise draw from the ``d``-excluded residual with the uniform of
    ``fold_in(..., 2)``.
    """
    assert rows.shape[0] == len(drafts) + 1
    out: List[int] = []
    if params.kind == "greedy":
        for j, d in enumerate(drafts):
            tgt = int(np.argmax(rows[j]))
            out.append(tgt)
            if int(d) != tgt:
                return out, False
        return out, True
    for j, d in enumerate(drafts):
        d = int(d)
        skey = step_key(req_key, n0 + j)
        p = filtered_probs(rows[j], params)
        if uniform(fold_in(skey, 1)) < p[d]:
            out.append(d)
            continue
        q = p.copy()
        q[d] = 0.0
        s = q.sum()
        if s <= 0.0:                     # p was a point mass at d
            out.append(d)
            return out, False
        out.append(_inverse_cdf(q / s, uniform(fold_in(skey, 2))))
        return out, False
    return out, True


def bonus_token(row, params: SamplingParams, req_key: int, n: int) -> int:
    """The token of generated index ``n`` drawn from one logits row
    exactly as a baseline decode step draws it: the argmax for greedy
    requests, else ``sample_rows`` with ``step_key(req_key, n)`` on the
    row's device."""
    if params.kind == "greedy":
        return int(np.argmax(np.asarray(row, np.float32)))
    x = torch.as_tensor(row)[None]
    tok = sample_rows(x, [step_key(req_key, n)],
                      pack_sampling([params], device=x.device))
    return int(tok[0])


def accept_row(rows: np.ndarray, drafts: Sequence[int],
               params: SamplingParams, req_key: int,
               n0: int) -> List[int]:
    """:func:`accept_drafts` plus the bonus token from ``rows[-1]`` when
    every draft survived: the tokens one verify step emits for one
    request."""
    out, bonus = accept_drafts(rows, drafts, params, req_key, n0)
    if bonus:
        m = len(drafts)
        out.append(bonus_token(rows[m], params, req_key, n0 + m))
    return out


def logprob_record(row: np.ndarray, token: int, top_k: int) -> Dict:
    """The serving API's per-token logprob payload, computed on the host
    for speculation-emitted tokens (raw model distribution, top-k by the
    same descending stable order as ``sample_rows``)."""
    x = np.asarray(row, np.float64)
    log_z = float(np.log(np.exp(x - x.max()).sum()) + x.max())
    order = np.argsort(np.asarray(row, np.float32),
                       kind="stable")[::-1][:max(top_k, 0)]
    return {"token": int(token),
            "logprob": float(x[int(token)] - log_z),
            "top": {int(t): float(x[int(t)] - log_z) for t in order}}
