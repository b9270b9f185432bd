"""Mamba2 — state-space duality (SSD) blocks, the port of the JAX
package's ``models/ssm.py``.

The selective state-space recurrence

    h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t x_t^T        (per head)
    y_t = C_t . h_t + D x_t

is computed three ways, as in the JAX package:

* :func:`ssd_recurrent` — the step-by-step scan (prompts whose length is
  not a multiple of the chunk, or not above one chunk);
* :func:`ssd_chunked` — the chunked form: its intra-chunk part (``y_intra``,
  each chunk's state contribution and the decay cumsum) is
  :func:`repro_torch.kernels.ops.ssd_chunk`, the hand-written kernel on a
  CUDA tensor and its plain version on the CPU; the inter-chunk carry is
  a loop over the chunks here, as the JAX package keeps it outside its
  kernel;
* :func:`ssd_decode_step` — the one-token state update (decode), plain
  tensor ops with no host sync.

With ``plain=True`` (the training path) the chunked form takes the
intra-chunk part from :func:`repro_torch.kernels.ref.ssd_chunk`, the plain
version of the kernel, and the block's gated norm the plain RMSNorm: the
kernels have no backward, and the JAX package's ``forward_train`` runs
its plain ``ssd_chunked`` too.

The block (in_proj -> conv1d -> SSD -> gated RMSNorm -> out_proj) follows
the JAX package's layout; its gated norm runs the RMSNorm kernel on the
card.  B and C are broadcast from their groups to the heads as stride-0
views where the groups allow one (one group, as Mamba2-2.7B has), so the
head broadcast is never materialized on the chunked path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import local as DL
from repro_torch.distributed.shardings import (NO_RULES, ShardingRules,
                                               is_dtensor)
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R


def heads_of_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N), group g serving heads [g*rep, (g+1)*rep)
    as ``jnp.repeat`` does: a stride-0 view for one group, a copy for
    more."""
    g = t.shape[-2]
    if g == 1:
        return t.expand(*t.shape[:-2], h, t.shape[-1])
    return t.repeat_interleave(h // g, dim=-2)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_recurrent(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step scan.  x (B,L,H,P); dt (B,L,H); a (H) negative;
    b/c (B,L,G,N) broadcast over heads; d (H).  Returns (y, h_final) with
    h (B,H,P,N) fp32."""
    bs, ln, h, p = x.shape
    n = b.shape[3]
    hs = x.new_zeros((bs, h, p, n), dtype=torch.float32) \
        if h0 is None else h0
    bh, ch = heads_of_groups(b, h), heads_of_groups(c, h)
    ys = []
    for t in range(ln):
        hs, yt = _step(hs, x[:, t], dt[:, t], a, bh[:, t], ch[:, t])
        ys.append(yt)
    y = torch.stack(ys, dim=1) + x.float() * d[:, None]
    return y.to(x.dtype), hs


def _step(hs, xt, dtt, a, bt, ct):
    """One recurrence step over (B,H,...) operands; bt/ct (B,H,N)."""
    decay = torch.exp(dtt * a)[..., None, None]
    upd = (dtt[..., None] * xt)[..., None] * bt[:, :, None, :]
    hnew = hs * decay + upd.float()
    yt = torch.einsum("bhpn,bhn->bhp", hnew, ct.float())
    return hnew, yt


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                chunk: int = 128, h0: Optional[torch.Tensor] = None,
                plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD form, equal to :func:`ssd_recurrent` up to fp
    association.  Same operands; L % chunk == 0.  ``plain`` takes the
    intra-chunk part from the kernel's plain version (differentiable)."""
    bs, ln, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if ln % chunk:
        raise ValueError(f"seq {ln} not divisible by chunk {chunk}")
    nc = ln // chunk
    hs = x.new_zeros((bs, h, p, n), dtype=torch.float32) \
        if h0 is None else h0
    intra = R.ssd_chunk if plain else \
        DL.ssd_chunk if is_dtensor(x) else K.ssd_chunk
    y_intra, state_c, cum = intra(x, dt, a, heads_of_groups(b, h),
                                  heads_of_groups(c, h), chunk=chunk)
    cum = cum.reshape(bs, nc, chunk, h)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    # y_inter_i = C_i . h_prev * exp(cum_i), with C read per group
    cg = c.reshape(bs, nc, chunk, g, n).float()
    y_inter = []
    for i in range(nc):
        hg = hs.reshape(bs, g, h // g, p, n)
        yi = torch.einsum("bkgs,bgrps->bkgrp", cg[:, i], hg)
        y_inter.append(yi.reshape(bs, chunk, h, p)
                       * torch.exp(cum[:, i])[..., None])
        hs = hs * chunk_decay[:, i, :, None, None] + state_c[:, i]
    y = y_intra + torch.cat(y_inter, dim=1)
    y = y + x.float() * d[:, None]
    return y.to(x.dtype), hs


def ssd_decode_step(h: torch.Tensor, xt: torch.Tensor, dtt: torch.Tensor,
                    a: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor,
                    d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token state update.  h (B,H,P,N); xt (B,H,P); dtt (B,H);
    bt/ct (B,G,N)."""
    hq = h.shape[1]
    hnew, yt = _step(h, xt, dtt, a, heads_of_groups(bt, hq),
                     heads_of_groups(ct, hq))
    yt = yt + xt.float() * d[:, None]
    return hnew, yt.to(xt.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------

def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xbc (B,L,C); w (K,C); returns (y, new_state)
    where the state carries the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    xpad = torch.cat([state, xbc], dim=1)
    new_state = xpad[:, -(k - 1):, :] if k > 1 else state
    ln = xbc.shape[1]
    ys = 0
    for i in range(k):               # in order, as the JAX package sums
        ys = ys + xpad[:, i:i + ln, :] * w[i]
    return F.silu(ys + bias), new_state


def mamba_block(cfg, p: Dict, x: torch.Tensor, *,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                plain: bool = False, rules: ShardingRules = NO_RULES):
    """Full Mamba2 block over a sequence.  x (B,L,d_model).

    Returns (y, new_ssm_state, (new_conv_x, new_conv_bc)).  Decode (L == 1
    with a state) takes :func:`ssd_decode_step`; a prefill whose length is
    a multiple of ``cfg.ssm_chunk`` and above one chunk the chunked form;
    any other the scan (counted on the card as ``plain_ssd_scan``, unless
    ``plain``: the training path reaches no kernel and counts nothing)."""
    bs, ln, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups

    z = DL.matmul(x, p["w_z"])
    xr = DL.matmul(x, p["w_x"])
    bc = DL.matmul(x, p["w_bc"])
    dt = DL.matmul(x, p["w_dt"])
    z = rules.act(z, "batch", None, "ff")
    xr = rules.act(xr, "batch", None, "ff")
    # the fused [x; B; C] depthwise conv split into x / BC parts is exact
    cs_x, cs_bc = conv_state if conv_state is not None else (None, None)
    xr, new_conv_x = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"], cs_x)
    bc, new_conv_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"], cs_bc)
    xs = rules.act(DL.split_last(xr, (h, pdim)), "batch", None, "ssm_heads",
                   None)
    b = bc[..., :g * n].reshape(bs, ln, g, n)
    c = bc[..., g * n:].reshape(bs, ln, g, n)

    a = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    if ln == 1 and ssm_state is not None:
        hnew, yt = ssd_decode_step(ssm_state, xs[:, 0], dt[:, 0], a,
                                   b[:, 0], c[:, 0], p["D"])
        y, new_state = yt[:, None], hnew
    elif ln % cfg.ssm_chunk == 0 and ln > cfg.ssm_chunk:
        y, new_state = ssd_chunked(xs, dt, a, b, c, p["D"],
                                   chunk=cfg.ssm_chunk, h0=ssm_state,
                                   plain=plain)
    else:
        if not plain:
            K.count_plain("plain_ssd_scan", xs)
        y, new_state = ssd_recurrent(xs, dt, a, b, c, p["D"], h0=ssm_state)

    y = y.reshape(bs, ln, cfg.d_inner)
    y = y * F.silu(z)
    if plain:
        y = R.rmsnorm(y, p["gnorm"], eps=cfg.norm_eps)
    elif is_dtensor(y):
        y = DL.rmsnorm(y, p["gnorm"], eps=cfg.norm_eps)
    else:
        y = K.rmsnorm(y, p["gnorm"], eps=cfg.norm_eps)
    return rules.act(DL.matmul(y, p["out_proj"]), "batch", None, "embed"), \
        new_state, (new_conv_x, new_conv_bc)
