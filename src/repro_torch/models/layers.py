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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    """RMSNorm through the kernel, or its plain form with ``plain``."""
    fn = R.rmsnorm if plain else K.rmsnorm
    return fn(x, scale, eps=eps, plus_one=plus_one)


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
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=qp.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=qp.device).long()
        ok &= kp < kl[..., None, None]
    ok &= kp >= 0
    zero = torch.zeros((), dtype=torch.float32, device=qp.device)
    return torch.where(ok, zero, NEG_INF)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, kv_positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              attn_softcap: Optional[float] = None, kv_len=None,
              kv_format: str = "bthd") -> torch.Tensor:
    """Masked multi-head attention with GQA, windows and softcap.

    q (B,Sq,Hq,D); k/v (B,Skv,Hkv,D) ["bthd"] or (B,Hkv,Skv,D) ["bhtd"]
    -> (B,Sq,Hq,D).
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1] if kv_format == "bthd" else k.shape[2]
    hkv = k.shape[2] if kv_format == "bthd" else k.shape[1]
    bias = _mask_bias(q_positions.expand(b, sq), kv_positions.expand(b, skv),
                      causal=causal, window=window, kv_len=kv_len)
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    kspec = "btkd" if kv_format == "bthd" else "bktd"
    scores = torch.einsum(f"bskgd,{kspec}->bkgst", qg, k.float())
    scores = scores * (1.0 / math.sqrt(d))
    scores = softcap(scores, attn_softcap)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(f"bkgst,{kspec}->bskgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (qkv projections + rope + out projection)
# ---------------------------------------------------------------------------

def gqa_qkv(cfg, p: Dict, x: torch.Tensor, positions: torch.Tensor,
            linear=None, *, plain: bool = False
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
        q = (x @ p["wq"]).reshape(b, s, hq, hd)
        k = (x @ p["wk"]).reshape(b, s, hkv, hd)
        v = (x @ p["wv"]).reshape(b, s, hkv, hd)
        if cfg.attn_bias:
            q = q + p["bq"].reshape(hq, hd)
            k = k + p["bk"].reshape(hkv, hd)
            v = v + p["bv"].reshape(hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], eps=cfg.norm_eps, plain=plain)
        k = rmsnorm(k, p["k_norm"], eps=cfg.norm_eps, plain=plain)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg, p: Dict, o: torch.Tensor, linear=None) -> torch.Tensor:
    b, s, hq, hd = o.shape
    if linear is not None:
        return linear(o.reshape(b, s, hq * hd), "wo")
    y = o.reshape(b, s, hq * hd) @ p["wo"]
    if cfg.attn_bias:
        y = y + p["bo"]
    return y


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
    q = (ql @ p["wq_b"]).reshape(b, s, h, dn + dr)
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
               causal: bool = True) -> torch.Tensor:
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
    wk = p["wk_b"].reshape(r, h, dn)                    # latent -> k_nope
    wv = p["wv_b"].reshape(r, h, dv)                    # latent -> v
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
    return o.reshape(b, sq, h * dv) @ p["wo"]


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
    x2 = x.reshape(-1, x.shape[-1])
    if kind.startswith("gated"):
        h = K.gated_matmul(x2, p["w_gate"], p["w_up"],
                           activation="silu" if kind == "gated_silu"
                           else "gelu")
    else:
        bias = p.get("b_in") if cfg.attn_bias else None
        h = K.matmul(x2, p["w_in"], bias,
                     activation=kind if kind in ("relu2", "gelu") else "relu")
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


def mlp(cfg, p: Dict, x: torch.Tensor, linear=None, *,
        plain: bool = False) -> torch.Tensor:
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
    if linear is not None:
        return linear(h, "w_down")
    y = h @ p["w_down"]
    if cfg.attn_bias and "b_down" in p:
        y = y + p["b_down"]
    return y


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


def _experts(cfg, p: Dict, xin: torch.Tensor) -> torch.Tensor:
    """Every expert's MLP over its buffer: xin (E, C, d) -> (E, C, d), the
    products in the model dtype (plain PyTorch: the JAX package's expert
    einsums run outside any Pallas kernel)."""
    kind = cfg.mlp_kind
    if kind.startswith("gated"):
        act = F.silu if kind == "gated_silu" else _gelu
        h = act(torch.bmm(xin, p["we_gate"])) * torch.bmm(xin, p["we_up"])
    else:
        h = torch.relu(torch.bmm(xin, p["we_in"]))
    return torch.bmm(h, p["we_down"])


def _dispatch(cfg, p: Dict, xg: torch.Tensor, capacity: int) -> torch.Tensor:
    """Route the tokens of xg (G, n, d) into per-(group, expert) buffers of
    ``capacity`` rows, run the experts and combine: y (G, n, d), each kept
    token's expert output times its gate (rounded to the model dtype), a
    dropped token's 0.  The scatter and gather stand in for the JAX
    package's one-hot dispatch/combine einsums, which select the same rows
    exactly; a dropped token writes to a spare row no expert reads."""
    g, n, d = xg.shape
    e = cfg.n_experts
    idx, gate, slot, keep = moe_route(cfg, p, xg, capacity=capacity)
    rows = g * e * capacity
    grp = torch.arange(g, device=xg.device)[:, None]
    flat = torch.where(keep, (grp * e + idx) * capacity + slot,
                       rows)                             # the spare row
    buf = torch.zeros((rows + 1, d), dtype=xg.dtype, device=xg.device)
    buf[flat.reshape(-1)] = xg.reshape(-1, d)
    xin = buf[:rows].reshape(g, e, capacity, d).transpose(0, 1) \
        .reshape(e, g * capacity, d)
    xout = _experts(cfg, p, xin).reshape(e, g, capacity, d).transpose(0, 1)
    out = torch.cat([xout.reshape(rows, d),
                     torch.zeros((1, d), dtype=xout.dtype,
                                 device=xout.device)])
    y = out[flat.reshape(-1)].reshape(g, n, d)
    return gate.to(xg.dtype)[..., None] * y


def moe(cfg, p: Dict, x: torch.Tensor, *, plain: bool = False
        ) -> torch.Tensor:
    """Top-1 routed experts with an optional always-on shared expert.

    Prefill (S > 1) routes in groups of ``moe_group_size`` tokens, each
    expert taking at most ``ceil(group * capacity_factor * top_k / E)``
    tokens of a group in the cumsum order, the rest dropped; single-token
    decode is dropless (capacity = batch), as the JAX package's
    ``_moe_decode``.  The shared expert is :func:`mlp` (its first stage
    through the ``gated_matmul`` kernel on the card, unless ``plain``)."""
    b, s, d = x.shape
    if s == 1:
        y = _dispatch(cfg, p, x[:, 0][None], b)[0][:, None]
    else:
        tokens = b * s
        n_groups = max(tokens // min(cfg.moe_group_size, tokens), 1)
        gs = tokens // n_groups
        cap = max(1, int(math.ceil(gs * cfg.capacity_factor * cfg.top_k
                                   / cfg.n_experts)))
        y = _dispatch(cfg, p, x.reshape(n_groups, gs, d), cap
                      ).reshape(b, s, d)
    if cfg.shared_expert:
        y = y + mlp(cfg, {"w_gate": p["ws_gate"], "w_up": p["ws_up"],
                          "w_down": p["ws_down"]}, x, plain=plain)
    return y


def moe_aux_loss(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss over x (B, S, d): E times the sum
    over experts of (share of tokens routed there) x (mean router
    probability), the training path's aux term."""
    d = x.shape[-1]
    logits = x.reshape(-1, d) @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    e = cfg.n_experts
    frac_tokens = torch.mean(F.one_hot(idx, e).float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    return e * torch.sum(frac_tokens * frac_probs)
