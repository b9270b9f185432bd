"""Layer math of the decoder families, as plain functions on tensors.

The PyTorch counterpart of the JAX package's ``models/layers.py``: norms
(Gemma's ``(1+w)`` RMSNorm among them), RoPE, softcap, the masked GQA
attention core, the q/k/v and output projections, MLA over its compressed
cache (MiniCPM3), the four MLP kinds, and top-1 MoE with capacity
dispatch and a shared expert (Llama-4).  Parameters are
plain dicts of tensors; every weight matmul can be routed through an
injected ``linear(x, name)`` callable (the backend seam).  Norm statistics
and attention scores are computed in fp32.  Every RMSNorm (the block
norms and the qk-norms) goes through
:func:`repro_torch.kernels.ops.rmsnorm`, and the first stage of an MLP
over resident weights through ``ops.matmul`` / ``ops.gated_matmul``
(:func:`mlp_in`): the hand-written kernels on a CUDA tensor, their plain
versions on the CPU.

The training path passes ``plain=True`` to every function that would reach
a kernel (:func:`apply_norm`, :func:`gqa_qkv`, the MLA projections,
:func:`mlp`, :func:`moe`): the kernels have no backward, so training runs
the JAX package's plain forms on every device, as its ``forward_train``
does.  :func:`moe_aux_loss` is the training path's load-balancing term.

``rules`` (a :class:`repro_torch.distributed.shardings.ShardingRules`)
places activations where the JAX package annotates them; ``NO_RULES``
(the default) changes nothing.  On ``DTensor`` operands every kernel runs
on the local shards (:mod:`repro_torch.distributed.local`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import local as DL
from repro_torch.distributed.shardings import (NO_RULES, ShardingRules,
                                               is_dtensor)
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float,
            plus_one: bool = False, plain: bool = False) -> torch.Tensor:
    """RMSNorm through the kernel (on the local shards of a ``DTensor``),
    or its plain form with ``plain``."""
    if plain:
        return R.rmsnorm(x, scale, eps=eps, plus_one=plus_one)
    if is_dtensor(x):
        return DL.rmsnorm(x, scale, eps=eps, plus_one=plus_one)
    return K.rmsnorm(x, scale, eps=eps, plus_one=plus_one)


def apply_norm(cfg, p: Dict, x: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], eps=cfg.norm_eps,
                   plus_one=cfg.post_norm, plain=plain)   # gemma (1+w)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply RoPE to ``x`` of shape (..., S, H, D) at ``positions`` (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    if is_dtensor(positions):
        freq = DL.as_dtensor(freq, positions.device_mesh)
    ang = positions[..., None].float() * freq                  # (..., S, half)
    ang = ang[..., None, :]                                    # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention core (the dense-cache branch; paged caches go through kernels)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
               window: Optional[int], kv_len=None) -> torch.Tensor:
    """(B, Sq, Skv) additive bias from position/validity constraints."""
    qp = q_pos[..., :, None].long()
    kp = kv_pos[..., None, :].long()
    ok = (kp >= 0) & (qp == qp)            # (B, Sq, Skv), all kv_pos >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=qp.device).long()
        ok = ok & (kp < kl[..., None, None])
    return torch.where(ok, 0.0, NEG_INF)


def _heads_split(q) -> int:
    """Over how many ranks a ``DTensor`` q (B, S, H, D) splits its heads."""
    n = 1
    for i, p in enumerate(q.placements):
        if p.is_shard() and p.dim == 2:
            n *= q.device_mesh.size(i)
    return n


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, cap: Optional[float],
                  kv_format: str) -> torch.Tensor:
    """q (B,Sq,Hq,D); k/v as :func:`attention`; bias (B,Sq,Skv)
    -> (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    hdim = 2 if kv_format == "bthd" else 1
    hkv = k.shape[hdim]
    if is_dtensor(q) and hkv != hq and hkv % _heads_split(q):
        # q's heads are split finer than the kv heads: each kv head
        # repeated over its group (the same products), so the q heads'
        # sharding carries over to the keys
        k = k.repeat_interleave(hq // hkv, dim=hdim)
        v = v.repeat_interleave(hq // hkv, dim=hdim)
        hkv = hq
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    kspec = "btkd" if kv_format == "bthd" else "bktd"
    scores = torch.einsum(f"bskgd,{kspec}->bkgst", qg, k.float())
    scores = scores * (1.0 / math.sqrt(d))
    scores = softcap(scores, cap)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(f"bkgst,{kspec}->bskgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, kv_positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              attn_softcap: Optional[float] = None, kv_len=None,
              chunk_q: int = 1024, kv_format: str = "bthd",
              rules: ShardingRules = NO_RULES) -> torch.Tensor:
    """Masked multi-head attention with GQA, windows and softcap.

    q (B,Sq,Hq,D); k/v (B,Skv,Hkv,D) ["bthd"] or (B,Hkv,Skv,D) ["bhtd"]
    -> (B,Sq,Hq,D).  Memory-bounded as the reference's: once Sq*Skv is
    above 4096*2048 the queries go in blocks of ``chunk_q`` rows, each
    block's whole score rows at once (no online softmax), so the result
    equals the unchunked one.
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1] if kv_format == "bthd" else k.shape[2]
    qp = q_positions.expand(b, sq)
    kvp = kv_positions.expand(b, skv)
    if sq * skv <= 4096 * 2048 or sq == 1 or sq % chunk_q != 0:
        bias = _mask_bias(qp, kvp, causal=causal, window=window,
                          kv_len=kv_len)
        return _attend_block(q, k, v, bias, attn_softcap, kv_format)
    chunks = []
    for s0 in range(0, sq, chunk_q):
        bias = _mask_bias(qp[:, s0:s0 + chunk_q], kvp, causal=causal,
                          window=window, kv_len=kv_len)
        chunks.append(_attend_block(q[:, s0:s0 + chunk_q], k, v, bias,
                                    attn_softcap, kv_format))
    return rules.act(torch.cat(chunks, dim=1), "batch", "seq", "heads",
                     None)


# ---------------------------------------------------------------------------
# GQA attention block (qkv projections + rope + out projection)
# ---------------------------------------------------------------------------

def gqa_qkv(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
            rules: ShardingRules = NO_RULES, linear=None, *,
            plain: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to q/k/v (with optional bias, qk-norm, rope).

    ``linear(x, "wq")`` must return ``x @ W_q`` with the bias applied;
    ``None`` uses the weights in ``p`` directly.
    """
    b, s, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if linear is not None:
        q = linear(x, "wq").reshape(b, s, hq, hd)
        k = linear(x, "wk").reshape(b, s, hkv, hd)
        v = linear(x, "wv").reshape(b, s, hkv, hd)
    else:
        q = DL.split_last(DL.matmul(x, p["wq"]), (hq, hd))
        k = DL.split_last(DL.matmul(x, p["wk"]), (hkv, hd))
        v = DL.split_last(DL.matmul(x, p["wv"]), (hkv, hd))
        if cfg.attn_bias:
            q = q + DL.split_last(p["bq"], (hq, hd))
            k = k + DL.split_last(p["bk"], (hkv, hd))
            v = v + DL.split_last(p["bv"], (hkv, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], eps=cfg.norm_eps, plain=plain)
        k = rmsnorm(k, p["k_norm"], eps=cfg.norm_eps, plain=plain)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if s > 1:
        # decode (s == 1) skips these, as the JAX package does: with a
        # seq-sharded cache the useful layout follows the cache
        q = rules.act(q, "batch", "seq", "heads", None)
        k = rules.act(k, "batch", "seq", "kv_heads", None)
        v = rules.act(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def attn_out(cfg, p: Dict, o: torch.Tensor, rules: ShardingRules = NO_RULES,
             linear=None) -> torch.Tensor:
    b, s, hq, hd = o.shape
    if linear is not None:
        y = linear(o.reshape(b, s, hq * hd), "wo")
    else:
        y = DL.matmul(DL.merge_last(o), p["wo"])
        if cfg.attn_bias:
            y = y + p["bo"]
    return rules.act(y, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (minicpm3 / deepseek style)
# ---------------------------------------------------------------------------

def mla_project_q(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  *, plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (q_nope (B,S,H,dn), q_rope (B,S,H,dr))."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rmsnorm(x @ p["wq_a"], p["q_a_norm"], eps=cfg.norm_eps,
                 plain=plain)
    q = DL.split_last(DL.matmul(ql, p["wq_b"]), (h, dn + dr))
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def mla_latent_kv(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  *, plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed per-token cache entries: (latent (B,S,R), k_rope
    (B,S,dr))."""
    r = cfg.kv_lora_rank
    ckv = x @ p["wkv_a"]                                # (B,S,R+dr)
    latent = rmsnorm(ckv[..., :r], p["kv_a_norm"], eps=cfg.norm_eps,
                     plain=plain)
    k_rope = rope(ckv[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0]
    return latent, k_rope


def mla_attend(cfg, p: Dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
               latent: torch.Tensor, k_rope: torch.Tensor, *,
               q_positions, kv_positions, kv_len=None,
               causal: bool = True,
               rules: ShardingRules = NO_RULES) -> torch.Tensor:
    """Attention over the compressed cache through the weight-absorption
    identity ``(q_nope @ Wk) . latent == (q_nope @ Wk_absorbed) . latent``:
    scores are computed in the R-dim latent space and values expanded once
    per step, as the JAX package's ``absorbed=True`` path does.  Scores and
    their softmax are fp32; the products round to the model dtype where
    the JAX package's do.  Plain PyTorch on every device: the JAX package
    computes it outside any Pallas kernel."""
    b, sq, h, dn = q_nope.shape
    skv = latent.shape[1]
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    wk = DL.split_last(p["wk_b"], (h, dn))              # latent -> k_nope
    wv = DL.split_last(p["wv_b"], (h, dv))              # latent -> v
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_dim)
    bias = _mask_bias(q_positions.expand(b, sq), kv_positions.expand(b, skv),
                      causal=causal, window=None, kv_len=kv_len)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk)          # absorb Wk
    s_nope = torch.einsum("bshr,btr->bhst", q_lat.float(), latent.float())
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    scores = (s_nope + s_rope) * scale + bias[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs.to(latent.dtype).float(),
                         latent.float()).to(latent.dtype)
    o = torch.einsum("bshr,rhd->bshd", o_lat, wv)
    return rules.act(DL.matmul(DL.merge_last(o), p["wo"]), "batch", "seq",
                     "embed")


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; match it
    return F.gelu(x, approximate="tanh")


def mlp_in(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP's first stage on device-resident weights in ``p``, fused
    through the matmul kernels: ``act(x @ w_gate) * (x @ w_up)`` for a
    gated MLP (:func:`repro_torch.kernels.ops.gated_matmul`), ``act(x @ w_in
    + b_in)`` otherwise (:func:`repro_torch.kernels.ops.matmul`).  One fp32
    sum and one cast, where the JAX package's jnp dots round each product
    to the model dtype before the activation (the same numbers in fp32)."""
    kind = cfg.mlp_kind
    gated = kind.startswith("gated")
    bias = None
    if gated:
        act = "silu" if kind == "gated_silu" else "gelu"
    else:
        bias = p.get("b_in") if cfg.attn_bias else None
        act = kind if kind in ("relu2", "gelu") else "relu"
    if is_dtensor(x):
        if gated:
            return DL.mlp_in(x, p["w_gate"], p["w_up"], activation=act,
                             gated=True)
        return DL.mlp_in(x, p["w_in"], bias=bias, activation=act,
                         gated=False)
    x2 = x.reshape(-1, x.shape[-1])
    if gated:
        h = K.gated_matmul(x2, p["w_gate"], p["w_up"], activation=act)
    else:
        h = K.matmul(x2, p["w_in"], bias, activation=act)
    return h.reshape(*x.shape[:-1], h.shape[-1])


def _resident_linear(cfg, p: Dict):
    """``linear(h, name)`` over the weights in ``p``: ``h @ w`` plus the
    layer's bias where it has one, as the JAX package's plain MLP."""
    def linear(h, nm):
        y = h @ p[nm]
        bias = {"w_in": "b_in", "w_down": "b_down"}.get(nm)
        if cfg.attn_bias and bias in p:
            y = y + p[bias]
        return y
    return linear


def mlp(cfg, p: Dict, x: torch.Tensor, rules: ShardingRules = NO_RULES,
        linear=None, *, plain: bool = False) -> torch.Tensor:
    """The MLP block.  Where ``p`` holds the first stage's weights (the
    stacked whole model's layer, or the per-layer dict of a backend that
    holds its weights whole on the device) that stage runs fused
    (:func:`mlp_in`); a backend that splits each weight between host and
    device leaves them out, and its ``linear(x, name)`` runs the stage and
    the activation follows, as in the JAX package.  ``w_down`` is
    ``linear``'s where one is given, else ``h @ w (+ b)``.  ``plain``
    runs the JAX package's form over the weights in ``p`` (each product
    rounded to the model dtype, no kernel)."""
    kind = cfg.mlp_kind
    if plain:
        linear = linear or _resident_linear(cfg, p)
    if not plain and ("w_gate" in p or "w_in" in p):
        h = mlp_in(cfg, p, x)
    elif kind.startswith("gated"):
        act = F.silu if kind == "gated_silu" else _gelu
        h = act(linear(x, "w_gate")) * linear(x, "w_up")
    else:
        h = linear(x, "w_in")
        if kind == "relu2":
            h = torch.square(torch.relu(h))
        elif kind == "gelu":
            h = _gelu(h)
        else:
            h = torch.relu(h)
    h = rules.act(h, "batch", "seq", "ff")
    if linear is not None:
        y = linear(h, "w_down")
    else:
        y = DL.matmul(h, p["w_down"])
        if cfg.attn_bias and "b_down" in p:
            y = y + p["b_down"]
    return rules.act(y, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# MoE — top-1 (Switch-style) with GShard capacity dispatch
# ---------------------------------------------------------------------------

def moe_route(cfg, p: Dict, x: torch.Tensor, *, capacity: int):
    """Top-1 routing of ``x`` (G, n, d), each of the G groups on its own.

    Returns ``(idx, gate, slot, keep)``, each (G, n): the chosen expert,
    its softmax gate (fp32), the token's position in that expert's buffer
    (the cumsum order: earlier tokens of the group first) and whether it
    fits the expert's ``capacity``.  The router runs in the model dtype
    and the softmax in fp32, as in the JAX package."""
    logits = (x @ p["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    gate, idx = torch.max(gates, dim=-1)
    onehot = F.one_hot(idx, cfg.n_experts).float()
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
    slot = pos.amax(dim=-1).long()
    return idx, gate, slot, slot < capacity


def _experts(cfg, p: Dict, xin: torch.Tensor,
             rules: ShardingRules = NO_RULES) -> torch.Tensor:
    """Every expert's MLP over its buffer: xin (E, C, d) -> (E, C, d), the
    products in the model dtype (plain PyTorch: the JAX package's expert
    einsums run outside any Pallas kernel)."""
    kind = cfg.mlp_kind
    if kind.startswith("gated"):
        act = F.silu if kind == "gated_silu" else _gelu
        h = act(torch.bmm(xin, p["we_gate"])) * torch.bmm(xin, p["we_up"])
    else:
        h = torch.relu(torch.bmm(xin, p["we_in"]))
    h = rules.act(h, "experts", None, None)
    return torch.bmm(h, p["we_down"])


def _dispatch(cfg, p: Dict, xg: torch.Tensor, capacity: int,
              rules: ShardingRules = NO_RULES) -> torch.Tensor:
    """Route the tokens of xg (G, n, d) into per-(group, expert) buffers of
    ``capacity`` rows, run the experts and combine: y (G, n, d), each kept
    token's expert output times its gate (rounded to the model dtype), a
    dropped token's 0.  The scatter and gather stand in for the JAX
    package's one-hot dispatch/combine einsums, which select the same rows
    exactly; a dropped token writes to a spare row no expert reads."""
    g, n, d = xg.shape
    e = cfg.n_experts
    idx, gate, slot, keep = moe_route(cfg, p, xg, capacity=capacity)
    if is_dtensor(xg):
        return _dispatch_onehot(cfg, p, xg, idx, gate, slot, keep, capacity,
                                rules)
    rows = g * e * capacity
    grp = torch.arange(g, device=xg.device)[:, None]
    flat = torch.where(keep, (grp * e + idx) * capacity + slot,
                       rows)                             # the spare row
    buf = torch.zeros((rows + 1, d), dtype=xg.dtype, device=xg.device)
    buf[flat.reshape(-1)] = xg.reshape(-1, d)
    xin = buf[:rows].reshape(g, e, capacity, d).transpose(0, 1) \
        .reshape(e, g * capacity, d)
    xin = rules.act(xin, "experts", None, "embed")
    xout = rules.act(_experts(cfg, p, xin, rules), "experts", None, "embed")
    xout = xout.reshape(e, g, capacity, d).transpose(0, 1)
    out = torch.cat([xout.reshape(rows, d),
                     torch.zeros((1, d), dtype=xout.dtype,
                                 device=xout.device)])
    y = out[flat.reshape(-1)].reshape(g, n, d)
    return gate.to(xg.dtype)[..., None] * y


def _dispatch_onehot(cfg, p: Dict, xg, idx, gate, slot, keep,
                     capacity: int, rules: ShardingRules) -> torch.Tensor:
    """:func:`_dispatch` over ``DTensor``s, by the JAX package's one-hot
    dispatch / combine einsums (a 0/1 mask (G, n, E, C)): each kept
    token's row is selected exactly, and the einsums shard over groups and
    experts where the scatter could not."""
    g, n, d = xg.shape
    e = cfg.n_experts
    mask = (F.one_hot(idx, e)[..., None]
            * F.one_hot(slot.clamp(0, capacity - 1), capacity)[..., None, :]
            * keep[..., None, None]).to(xg.dtype)           # (G, n, E, C)
    xin = torch.einsum("gnec,gnd->egcd", mask, xg).reshape(
        e, g * capacity, d)
    xin = rules.act(xin, "experts", None, "embed")
    xout = rules.act(_experts(cfg, p, xin, rules), "experts", None, "embed")
    y = torch.einsum("gnec,egcd->gnd", mask,
                     xout.reshape(e, g, capacity, d))
    return gate.to(xg.dtype)[..., None] * y


def _moe_decode(cfg, p: Dict, x: torch.Tensor,
                rules: ShardingRules = NO_RULES) -> torch.Tensor:
    """Single-token routing over x (B, 1, d): dropless, capacity = B."""
    b = x.shape[0]
    return _dispatch(cfg, p, x[:, 0][None], b, rules)[0][:, None]


def moe(cfg, p: Dict, x: torch.Tensor, rules: ShardingRules = NO_RULES, *,
        plain: bool = False) -> torch.Tensor:
    """Top-1 routed experts with an optional always-on shared expert.

    Prefill (S > 1) routes in groups of ``moe_group_size`` tokens, each
    expert taking at most ``ceil(group * capacity_factor * top_k / E)``
    tokens of a group in the cumsum order, the rest dropped; single-token
    decode is dropless (capacity = batch), as the JAX package's
    ``_moe_decode``.  The shared expert is :func:`mlp` (its first stage
    through the ``gated_matmul`` kernel on the card, unless ``plain``)."""
    b, s, d = x.shape
    if s == 1:
        y = _moe_decode(cfg, p, x, rules)
    else:
        tokens = b * s
        n_groups = max(tokens // min(cfg.moe_group_size, tokens), 1)
        gs = tokens // n_groups
        cap = max(1, int(math.ceil(gs * cfg.capacity_factor * cfg.top_k
                                   / cfg.n_experts)))
        xg = rules.act(x.reshape(n_groups, gs, d), "expert_group", None,
                       "embed")
        y = _dispatch(cfg, p, xg, cap, rules).reshape(b, s, d)
    if cfg.shared_expert:
        y = y + mlp(cfg, {"w_gate": p["ws_gate"], "w_up": p["ws_up"],
                          "w_down": p["ws_down"]}, x, rules, plain=plain)
    return rules.act(y, "batch", "seq", "embed")


def moe_aux_loss(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss over x (B, S, d): E times the sum
    over experts of (share of tokens routed there) x (mean router
    probability), the training path's aux term."""
    e = cfg.n_experts
    probs = torch.softmax((x @ p["router"].to(x.dtype)).float(), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    frac_tokens = torch.mean(F.one_hot(idx, e).float(), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    return e * torch.sum(frac_tokens * frac_probs)
