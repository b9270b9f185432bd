"""The bf16 route of ``ssd_chunk`` on the tensor cores, on the CPU.  No
card here, so an emulation in torch of the kernel's arithmetic stands for
it (``csrc/ssd_chunk.cu``, ``ssd_tc_kernel``):

* cum by the kernel's warp scan: four values a lane summed in order, the
  lanes' totals by a Hillis-Steele scan over shuffles, each lane's
  exclusive prefix added to its values;
* S = C B^T from the bf16 operands with fp32 sums;
* W_ij = S_ij (exp(cum_i - cum_j) dt_j) (j <= i) in fp32, split into bf16
  terms (two from chunk 64, three below), each the residual rounded to
  nearest; y = sum of the terms times the exact bf16 x, summed 16 keys at
  a time in the kernel's order;
* x'_j = tail_j dt_j x_j in fp32, split into three terms; state_c =
  x'^T B, 16 positions at a time.

At Mamba2-2.7B's widths (P 64, N 128, chunk 128) over a few heads and two
chunks, the emulation lies within ``ref.ssd_chunk_limit`` (with its own
cum) of the plain version and of the JAX package's Pallas kernel in
interpret mode, at most half the limit; one term lies beyond it.  Two
terms of x' lie above half the limit over Mamba2-2.7B's 80 heads (beyond
it at chunk 16), and two of W above half of it at chunk 16, which is why
the kernel takes three there.  Inputs come from numpy with a seed;
x, b and c are bf16 values, handed to the Pallas kernel as fp32 (this
CPU's XLA has no bf16 x bf16 -> fp32 dot).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_chunk as jssd
from repro_torch.kernels import ref as R


def _bf(x):
    return x.to(torch.bfloat16).float()


def _split(x, terms):
    """x as the kernel's bf16 terms: each the residual rounded to nearest."""
    out = []
    for _ in range(terms):
        t = _bf(x)
        out.append(t)
        x = x - t
    return out


def _scan_cum(la):
    """Inclusive scan of ``la`` (..., K, H) over K <= 128 in the kernel's
    order: lane l holds positions 4l..4l+3."""
    k = la.shape[-2]
    v = torch.zeros(*la.shape[:-2], 128, la.shape[-1])
    v[..., :k, :] = la
    v = v.reshape(*la.shape[:-2], 32, 4, la.shape[-1])
    for e in range(1, 4):
        v[..., e, :] = v[..., e, :] + v[..., e - 1, :]
    tot = v[..., 3, :].clone()
    o = 1
    while o < 32:
        shifted = torch.zeros_like(tot)
        shifted[..., o:, :] = tot[..., :-o, :]
        tot = torch.where((torch.arange(32) >= o)[:, None], tot + shifted,
                          tot)
        o *= 2
    excl = torch.zeros_like(tot)
    excl[..., 1:, :] = tot[..., :-1, :]
    cum = excl[..., None, :] + v
    return cum.reshape(*la.shape[:-2], 128, la.shape[-1])[..., :k, :]


def _ssd_tc_emulation(x, dt, a, b, c, *, chunk, w_terms=None, x_terms=3):
    """(y, state_c, cum) as the tensor-core kernel computes them, with
    W in ``w_terms`` bf16 terms (the kernel's: two from chunk 64, three
    below) and x' in ``x_terms``."""
    if w_terms is None:
        w_terms = 2 if chunk >= 64 else 3
    bs, ln, h, p = x.shape
    n = b.shape[-1]
    nc = ln // chunk
    xc = x.float().reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    bc = b.float().reshape(bs, nc, chunk, h, n)
    cc = c.float().reshape(bs, nc, chunk, h, n)
    cum = _scan_cum(dtc * a)
    s = torch.einsum("bnihs,bnjhs->bnhij", cc, bc)
    cu = cum.permute(0, 1, 3, 2)                       # (B,nc,H,K)
    seg = cu[..., :, None] - cu[..., None, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    w = torch.where(causal, s * (torch.exp(seg)
                                 * dtc.permute(0, 1, 3, 2)[..., None, :]),
                    0.0)
    xh = xc.permute(0, 1, 3, 2, 4)                     # (B,nc,H,K,P)
    y = torch.zeros(bs, nc, h, chunk, p)
    for j in range(0, chunk, 16):
        for t in _split(w[..., j:j + 16], w_terms):
            y = y + t @ xh[..., j:j + 16, :]
    tail = torch.exp(cu[..., -1:] - cu)
    xp = (tail * dtc.permute(0, 1, 3, 2))[..., None] * xh
    bh = bc.permute(0, 1, 3, 2, 4)                     # (B,nc,H,K,N)
    st = torch.zeros(bs, nc, h, p, n)
    xps = _split(xp, x_terms)
    for j in range(0, chunk, 16):
        for t in xps:
            st = st + (t[..., j:j + 16, :].transpose(-1, -2)
                       @ bh[..., j:j + 16, :])
    return (y.permute(0, 1, 3, 2, 4).reshape(bs, ln, h, p), st,
            cum.reshape(bs, ln, h))


def _operands(seed, bs, nc, chunk, h, p, n):
    """x, b and c bf16 values (one group, broadcast over the heads), dt
    after softplus, a in [-1.5, -0.5), as fp32 tensors."""
    rng = np.random.default_rng(seed)
    ln = nc * chunk
    t = torch.from_numpy
    x = _bf(t(rng.standard_normal((bs, ln, h, p)).astype(np.float32)))
    dt = torch.nn.functional.softplus(
        t(rng.standard_normal((bs, ln, h)).astype(np.float32)) - 1.0)
    a = t(-rng.uniform(0.5, 1.5, h).astype(np.float32))
    bm, cm = (_bf(t(rng.standard_normal((bs, ln, 1, n)).astype(np.float32)))
              .expand(bs, ln, h, n) for _ in range(2))
    return x, dt, a, bm, cm


def _ratios(got, want, limits):
    return [float(((g - w).abs() / lim).max())
            for g, w, lim in zip(got, want, limits)]


def test_ssd_tc_emulation_within_limit_at_mamba2_widths():
    """The kernel's terms at P 64, N 128, chunk 128 (4 heads, two chunks;
    W in two, x' in three): y, state_c and cum within half of
    ``ref.ssd_chunk_limit`` of the plain version and within the limit of
    the Pallas kernel (interpret mode); one term of each beyond it in y
    and state_c."""
    x, dt, a, bm, cm = _operands(0, 1, 2, 128, 4, 64, 128)
    got = _ssd_tc_emulation(x, dt, a, bm, cm, chunk=128)
    want = R.ssd_chunk(x, dt, a, bm, cm, chunk=128)
    limits = R.ssd_chunk_limit(x, dt, a, bm, cm, got[2], chunk=128)
    ratios = _ratios(got, want, limits)
    print(f"kernel's terms: y {ratios[0]:.3f}, state {ratios[1]:.3f}, "
          f"cum {ratios[2]:.3f} of the limit")
    assert max(ratios) <= 0.5
    pallas = jssd.ssd_chunk(*(jnp.asarray(v.contiguous().numpy()) for v in
                              (x, dt, a, bm, cm)), chunk=128, interpret=True)
    pallas = [torch.from_numpy(np.array(v)) for v in pallas]
    assert max(_ratios(got, pallas, limits)) <= 1.0
    one = _ssd_tc_emulation(x, dt, a, bm, cm, chunk=128, w_terms=1,
                            x_terms=1)
    one_ratios = _ratios(one, want, limits)
    print(f"one term: y {one_ratios[0]:.1f}, state {one_ratios[1]:.1f}")
    assert min(one_ratios[:2]) > 1.0


@pytest.mark.parametrize("chunk,h,p,n", [(128, 80, 64, 128), (64, 4, 24, 40),
                                         (16, 4, 16, 16)])
def test_ssd_tc_emulation_term_counts(chunk, h, p, n):
    """Why these terms: at Mamba2-2.7B's widths over its 80 heads, and at
    chunk 64, the kernel's terms lie within half of
    ``ref.ssd_chunk_limit``, while two terms of x' put state_c above half
    of it (more so at shorter chunks, whose summation budget is smaller:
    beyond it at chunk 16); at chunk 16 two terms of W put y above half
    of it, so W takes three there."""
    x, dt, a, bm, cm = _operands(chunk + h + p, 1, 2, chunk, h, p, n)
    want = R.ssd_chunk(x, dt, a, bm, cm, chunk=chunk)
    got = _ssd_tc_emulation(x, dt, a, bm, cm, chunk=chunk)
    limits = R.ssd_chunk_limit(x, dt, a, bm, cm, got[2], chunk=chunk)
    assert max(_ratios(got, want, limits)) <= 0.5
    two = _ssd_tc_emulation(x, dt, a, bm, cm, chunk=chunk, x_terms=2)
    limits = R.ssd_chunk_limit(x, dt, a, bm, cm, two[2], chunk=chunk)
    two_ratio = _ratios(two, want, limits)[1]
    print(f"chunk {chunk}: x' in two terms, state_c at {two_ratio:.3f} of "
          f"the limit")
    assert two_ratio > (1.0 if chunk == 16 else 0.5)
    if chunk < 64:
        w2 = _ssd_tc_emulation(x, dt, a, bm, cm, chunk=chunk, w_terms=2)
        limits = R.ssd_chunk_limit(x, dt, a, bm, cm, w2[2], chunk=chunk)
        assert _ratios(w2, want, limits)[0] > 0.5


def test_scan_cum_is_an_inclusive_scan():
    """The emulated warp scan is an inclusive prefix sum (to fp32 order)."""
    la = -torch.rand(2, 128, 3)
    np.testing.assert_allclose(_scan_cum(la).numpy(),
                               torch.cumsum(la, dim=1).numpy(), rtol=1e-5)
    assert torch.equal(_scan_cum(la[:, :37]), _scan_cum(la)[:, :37])
