"""The arithmetic of the pairwise-LSE kernel's tensor-core path, emulated on
the CPU (csrc/pairwise_lse.cu cannot run here).

The kernel splits each fp32 value x into hi = tf32_rna(x) and lo =
tf32_rna(x - hi) and sums three TF32 products, hi.lo + lo.hi + hi.hi, in an
fp32 accumulator; bf16 inputs take one bf16 product. Its epilogue works in
base 2 and relative to the row constant r_b = fma(-k, |z_b|^2, C0):
l = min(fma(2k, z.mu, c_n), C0 - r_b) = logit - r_b, with k =
0.5*log2(e)/var, c_n = -k*|mu_n|^2 (the masked logit for padding) and C0 =
-0.5*log2(e)*D*log_var; lse = (max l + r_b + log2 sum 2^(l - max l)) * ln 2.
These tests hold that arithmetic against
pairwise_lse_plain with the card tolerance of the kernel tests (rtol 1e-5,
atol 1e-4), and show that one TF32 pass would not meet it.
"""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch.ops import pairwise_lse as tpl

RTOL, ATOL = 1e-5, 1e-4
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
NEG2 = np.float32(-1e30) * LOG2E


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round fp32 to a 10-bit mantissa, to nearest, ties
    away from zero (add half of the 13 dropped bits to the magnitude, then
    clear them; the sign bit is untouched for finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fma(a, b, c):
    """fp32 fma: the fp64 product of two fp32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def kernel_lse(z, mu, log_var, valid, passes):
    """The kernel's LSE with no index masks, from its cross term: "3xtf32",
    "tf32" (one pass) or "bf16" (inputs already bf16-rounded)."""
    d = z.shape[1]
    if passes == "3xtf32":
        zh, mh = tf32_rna(z), tf32_rna(mu)
        zl, ml = tf32_rna(z - zh), tf32_rna(mu - mh)
        cross = (zh @ ml.T + zl @ mh.T) + zh @ mh.T
    elif passes == "tf32":
        cross = tf32_rna(z) @ tf32_rna(mu).T
    else:
        cross = z @ mu.T
    lv = np.float32(log_var)
    k = np.float32(0.5) * LOG2E * np.float32(np.exp(-lv))
    c0 = np.float32(-0.5) * LOG2E * np.float32(d) * lv
    kt = torch.tensor(k)
    row = _fma(-kt, (z * z).sum(-1), torch.tensor(c0))
    col = torch.where(valid, -kt * (mu * mu).sum(-1), torch.tensor(NEG2))
    rel = torch.minimum(_fma(torch.tensor(2 * k), cross, col[None, :]),
                        (c0 - row)[:, None])
    m = rel.max(-1).values
    s = torch.exp2(rel - m[:, None]).sum(-1)
    return (m + row + torch.log2(s)) * LN2, rel


def _inputs(b, n, d, scale, seed):
    rng = np.random.default_rng(seed)
    means = (scale * rng.normal(size=(n, d))).astype(np.float32)
    own = rng.integers(0, n, b)
    z = (means[own] + 0.7 * scale * rng.normal(size=(b, d))).astype(np.float32)
    valid = rng.random(n) >= 0.01
    return torch.from_numpy(z), torch.from_numpy(means), torch.from_numpy(valid)


# serving-shape norms (|z|, |mu| ~ sqrt(40)), and |z|, |mu| ~ 10
NORMS = [pytest.param(1.0, id="serving-norms"),
         pytest.param(10 / np.sqrt(40), id="norms-10")]


def _plain(z, mu, valid, log_var, in_dtype=torch.float32):
    n = mu.shape[0]
    return tpl.pairwise_lse_plain(
        z, mu, torch.tensor(log_var), None,
        torch.arange(n, dtype=torch.int32), valid, in_dtype=in_dtype)


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -11), 0.0, 1.5], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, 1.0, 1 + 2 ** -9, -(1 + 2 ** -10),
                         0.0, 1.5], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    # every result has a 10-bit mantissa and lies within half a TF32 ulp
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    h = tf32_rna(r)
    assert int((h.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((h - r).abs() <= r.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("scale", NORMS)
def test_three_tf32_products_meet_the_card_tolerance(scale):
    z, mu, valid = _inputs(256, 2048, 40, scale, seed=1)
    got, rel = kernel_lse(z, mu, -0.5, valid, "3xtf32")
    want = _plain(z, mu, valid, -0.5)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # padding's column constant is the masked logit, exactly
    assert bool((rel[:, ~valid] == NEG2).all())


@pytest.mark.parametrize("scale", NORMS)
def test_one_tf32_pass_misses_the_card_tolerance(scale):
    z, mu, valid = _inputs(256, 2048, 40, scale, seed=1)
    got, _ = kernel_lse(z, mu, -0.5, valid, "tf32")
    want = _plain(z, mu, valid, -0.5)
    assert not torch.allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_products_are_exact_in_fp32():
    rng = np.random.default_rng(2)
    a = torch.from_numpy((10 * rng.normal(size=100_000)).astype(np.float32))
    b = torch.from_numpy((10 * rng.normal(size=100_000)).astype(np.float32))
    a, b = a.bfloat16().float(), b.bfloat16().float()
    assert torch.equal((a * b).double(), a.double() * b.double())


@pytest.mark.parametrize("scale", NORMS)
def test_one_bf16_pass_meets_the_card_tolerance(scale):
    z, mu, valid = _inputs(256, 2048, 40, scale, seed=3)
    zb, mb = z.bfloat16().float(), mu.bfloat16().float()
    got, _ = kernel_lse(zb, mb, -0.5, valid, "bf16")
    want = _plain(z, mu, valid, -0.5, in_dtype=torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
