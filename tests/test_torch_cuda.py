"""Tests that need a CUDA card: the port's kernels against their plain
versions on the card, the prior's gradients through the kernel, and the
serving path through them at a small size.

They are marked ``cuda`` and skip without a card. This file imports no JAX,
so it also runs where JAX is absent (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: rtol 1e-5 / atol 1e-4. The kernel's three TF32 products keep
fp32 accuracy (the dropped lo.lo term is ~2^-22 relative) and both sides sum
in another order (bf16 inputs are rounded identically on both sides, and
their products are exact); |z|^2 + |mu|^2 - 2 z.mu cancels, so the error
scales with the norms (~80 at D = 40, a few ulps of 7.6e-6), not with an
LSE that may lie near 0.

Gradients through the kernel: the backward recomputes the logits with fp32
torch GEMMs (TF32 off) and divides by the kernel's LSE, which differs from
the scan's by up to ~2e-5; that scales each row's weights by 1 +- 2e-5, so
each gradient tensor is held within GRAD_REL = 1e-4 of its largest element.
"""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch.ops import pairwise_lse as tpl

RTOL, ATOL = 1e-5, 1e-4
GRAD_REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from exemplar_vae_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _inputs(dev, b, n, d, loo, seed=0, scale=1.0, minus_one=()):
    """``scale`` multiplies z and means (norms ~scale*sqrt(d)); the exemplar
    indices in the slice ``minus_one`` become -1, which rows without
    data_idx match (NO_LOO_IDX)."""
    rng = np.random.default_rng(seed)
    means = (scale * rng.normal(size=(n, d))).astype(np.float32)
    own = rng.integers(0, n, b)
    z = (means[own] + 0.5 * scale * rng.normal(size=(b, d))).astype(np.float32)
    ex = (np.arange(n) * 3 + 1).astype(np.int32)
    if minus_one:
        ex[slice(*minus_one)] = -1
    valid = rng.random(n) >= 0.05
    didx = ex[own] if loo else None
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(dev)
    return (t(z), t(means), torch.tensor(-0.3, device=dev), t(didx), t(ex),
            t(valid))


_LARGE = 10 / np.sqrt(40)   # |z|, |mu| ~ 10 at D = 40


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,loo,in_dtype,extra", [
    (1, 300, 8, True, torch.float32, {}),
    (130, 1000, 40, False, torch.bfloat16, {}),
    (257, 513, 128, True, torch.float32, {}),  # widest D: >48 KB shared memory
    (96, 700, 128, False, torch.bfloat16, {}),
    (64, 65, 3, True, torch.float32, {}),      # odd D, one column past a tile
    (70, 300, 41, True, torch.float32, {}),    # D padded to the MMA depth
    (70, 300, 41, False, torch.bfloat16, {}),
    (5, 64, 40, False, torch.float32, {}),     # N exactly one tile
    (33, 10, 40, True, torch.float32, {}),     # N below one tile
    (9, 10, 40, False, torch.bfloat16, {}),
    (63, 500, 40, True, torch.float32, {}),    # around the 64-row m-tiles
    (65, 500, 40, False, torch.float32, {}),
    # one tile holds index -1 (compared, masked for every row), the others
    # are not compared
    (200, 300, 40, False, torch.float32, {"minus_one": (70, 75)}),
    (200, 300, 40, False, torch.bfloat16, {"minus_one": (70, 75)}),
    # large norms stress the cancellation of the 3xTF32 split
    (500, 2000, 40, False, torch.float32, {"scale": _LARGE}),
    (500, 2000, 40, True, torch.float32, {"scale": _LARGE}),
    (3000, 50_000, 40, True, torch.bfloat16, {}),
])
def test_kernel_matches_plain(dev, b, n, d, loo, in_dtype, extra):
    args = _inputs(dev, b, n, d, loo, **extra)
    before = tpl.pairwise_lse.launches
    got = tpl.pairwise_lse(*args, in_dtype=in_dtype)
    torch.cuda.synchronize()
    assert tpl.pairwise_lse.launches == before + 1
    want = tpl.pairwise_lse_plain(*args, in_dtype=in_dtype)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_fully_masked_row(dev):
    z, means, lv, _, ex, _ = _inputs(dev, 2, 5, 8, False)
    valid = torch.tensor([False, False, False, True, False], device=dev)
    didx = torch.stack([ex[3], ex[1]]).to(torch.int32)
    got = tpl.pairwise_lse(z, means, lv, didx, ex, valid)
    want = tpl.pairwise_lse_plain(z, means, lv, didx, ex, valid)
    assert got[0] <= 0.5 * tpl.NEG_INF and want[0] <= 0.5 * tpl.NEG_INF
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    z, means, lv, didx, ex, valid = _inputs(dev, 4, 70, 129, True)
    with pytest.raises(ValueError, match="D <= 128"):
        tpl.pairwise_lse(z, means, lv, didx, ex, valid)
    z, means, lv, didx, ex, valid = _inputs(dev, 4, 70, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        tpl.pairwise_lse(z, torch.cat([means, means], 1)[:, ::2], lv, didx,
                         ex, valid)
    with pytest.raises(RuntimeError, match="forward-only"):
        tpl.pairwise_lse(z.requires_grad_(), means, lv, didx, ex, valid)
    with pytest.raises(ValueError, match="different devices"):
        tpl.pairwise_lse(z.detach(), means.cpu(), lv, didx, ex, valid)


@pytest.mark.cuda
def test_prior_gradients_through_kernel_match_scan(dev):
    """exemplar_log_prob at the train shape (B = 100, N = 50 000, D = 40,
    LOO): the kernel forward and the scan forward give the same gradients
    in z, means and log_var through the shared backward, one launch."""
    from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
    z, means, _, didx, ex, valid = _inputs(dev, 100, 50_000, 40, True)
    g = torch.randn(100, device=dev, generator=torch.Generator(dev).manual_seed(1))
    grads = {}
    for impl in ("pallas", "scan"):
        leaves = [t.clone().requires_grad_() for t in
                  (z, means, torch.tensor(-0.3, device=dev))]
        before = tpl.pairwise_lse.launches
        out = exemplar_log_prob(*leaves[:2], leaves[2],
                                log_denom=float(np.log(49_999.0)),
                                data_idx=didx, exemplar_idx=ex, valid=valid,
                                impl=impl)
        (g * out).sum().backward()
        assert tpl.pairwise_lse.launches == before + (impl == "pallas")
        grads[impl] = [t.grad for t in leaves]
    for name, a, b in zip(("dz", "dmu", "dlogvar"), *grads.values()):
        assert bool(torch.isfinite(a).all()), name
        err = float((a - b).abs().max())
        assert err <= GRAD_REL * float(b.abs().max()), (name, err)


@pytest.mark.cuda
def test_small_serving_path_runs_the_kernel(dev):
    """score_nll on the card through the kernel equals the scan prior with
    the same noise; one launch per round."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.serve import make_serving_fns
    from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
    from exemplar_vae_tpu_torch.train.loss import Bank

    cfg = Config(hidden_size=32, z1_size=8, S=16, MB=8)
    model = create_model(cfg, device=dev, seed=1)
    rng = np.random.default_rng(0)
    bank_x = (rng.random((300, 28, 28, 1)) < 0.3).astype(np.float32)
    eb = make_eval_bank_fn(model, cfg)(Bank(
        images=bank_x, data_idx=np.arange(300, dtype=np.int32),
        valid=np.ones(300, bool), cache_means=None, n_effective=300))
    eps = torch.randn((2, 4 * 8, 8), device=dev)
    nll = {}
    for kernel in (True, False):
        _, _, score = make_serving_fns(
            model, cfg.replace(use_pallas_prior=kernel), 300, 4, 2, 8)
        before = tpl.pairwise_lse.launches
        nll[kernel] = score(bank_x[:4], eb.cache_means, eb.data_idx,
                            eb.valid, eps=eps)
        assert tpl.pairwise_lse.launches == before + (2 if kernel else 0)
    torch.testing.assert_close(nll[True], nll[False], rtol=RTOL, atol=ATOL)
