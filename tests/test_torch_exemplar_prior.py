"""Port vs JAX: the exemplar prior's pairwise log-sum-exp.

The port's plain pairwise LSE and ``exemplar_log_prob`` (naive / scan /
pallas, the last being the kernel wrapper's plain version on the CPU) are
held against JAX ``exemplar_log_prob`` with impl naive, scan and pallas (the
Pallas kernel in interpret mode on the CPU, as the JAX package's own tests
run it). Covered: the LOO mask, valid=False rows, ragged N with block_n not
dividing N, a fully-masked row and lse_combine.

Tolerance: fp32, rtol 1e-5 / atol 1e-5 (summation order of the cross term
and of the LSE). A fully-masked row's value depends on the tile padding
(-1e30 + log(#masked entries)), so such rows are compared only as
<= 0.5 * NEG_INF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.ops import exemplar_prior as jep
from exemplar_vae_tpu.ops.pallas_lse import pairwise_lse_pallas
from exemplar_vae_tpu_torch.ops import exemplar_prior as tep
from exemplar_vae_tpu_torch.ops import pairwise_lse as tpl

B, N, D, BLOCK_N = 7, 300, 8, 128   # 128 does not divide 300
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(B, D)).astype(np.float32)
    means = rng.normal(size=(N, D)).astype(np.float32)
    ex_idx = (np.arange(N) * 2 + 5).astype(np.int32)
    valid = np.ones(N, bool)
    valid[rng.choice(N, 9, replace=False)] = False
    # rows 0-3 are in the bank (LOO removes their own exemplar); row 4's own
    # exemplar is padding; rows 5-6 are not in the bank
    data_idx = np.array([ex_idx[3], ex_idx[100], ex_idx[299], ex_idx[0],
                         ex_idx[np.flatnonzero(~valid)[0]], 1, 2], np.int32)
    z[0] = means[3] + 0.01      # the LOO mask removes the dominant component
    return z, means, np.float32(0.3), data_idx, ex_idx, valid


def _jax(p, impl, loo, block_n=BLOCK_N):
    z, means, lv, didx, ex, valid = p
    return np.asarray(jep.exemplar_log_prob(
        jnp.asarray(z), jnp.asarray(means), lv, log_denom=np.log(N - 1.0),
        data_idx=jnp.asarray(didx) if loo else None,
        exemplar_idx=jnp.asarray(ex), valid=jnp.asarray(valid), impl=impl,
        block_n=block_n))


def _torch(p, impl, loo, block_n=BLOCK_N):
    z, means, lv, didx, ex, valid = p
    return tep.exemplar_log_prob(
        torch.from_numpy(z), torch.from_numpy(means), lv,
        log_denom=np.log(N - 1.0),
        data_idx=torch.from_numpy(didx) if loo else None,
        exemplar_idx=torch.from_numpy(ex), valid=torch.from_numpy(valid),
        impl=impl, block_n=block_n).numpy()


@pytest.mark.parametrize("loo", [False, True])
@pytest.mark.parametrize("impl", ["naive", "scan", "pallas"])
def test_exemplar_log_prob_matches_jax(problem, impl, loo):
    got = _torch(problem, impl, loo)
    want = _jax(problem, impl, loo)
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loo", [False, True])
def test_plain_pairwise_lse_matches_pallas_interpret(problem, loo, in_dtype):
    """The kernel's plain version against the Pallas kernel itself. bf16
    rounds z and mu the same way on both sides and accumulates in fp32, so
    the fp32 tolerance holds."""
    z, means, lv, didx, ex, valid = problem
    want = np.asarray(pairwise_lse_pallas(
        jnp.asarray(z), jnp.asarray(means), jnp.float32(lv),
        jnp.asarray(didx) if loo else None, jnp.asarray(ex),
        jnp.asarray(valid), block_n=BLOCK_N,
        in_dtype=getattr(jnp, in_dtype)))
    got = tpl.pairwise_lse_plain(
        torch.from_numpy(z), torch.from_numpy(means), torch.tensor(lv),
        torch.from_numpy(didx) if loo else None, torch.from_numpy(ex),
        torch.from_numpy(valid), in_dtype=getattr(torch, in_dtype),
        block_n=BLOCK_N).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["naive", "scan", "pallas"])
def test_fully_masked_row(impl):
    """Row 0's only valid exemplar is its own (LOO): every logit is masked.
    Row 1 keeps that exemplar and must match exactly."""
    rng = np.random.default_rng(1)
    z = rng.normal(size=(2, D)).astype(np.float32)
    means = rng.normal(size=(5, D)).astype(np.float32)
    ex = np.arange(10, 15, dtype=np.int32)
    valid = np.array([False, False, False, True, False])
    didx = np.array([13, 11], np.int32)
    p = (z, means, np.float32(-0.2), didx, ex, valid)
    got = _torch(p, impl, True, block_n=2)
    want = _jax(p, impl, True, block_n=2)
    assert got[0] <= 0.5 * tep.NEG_INF and want[0] <= 0.5 * jep.NEG_INF
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


def test_lse_combine_matches_jax_and_merges_halves(problem):
    z, means, lv, _, ex, valid = problem
    halves = []
    for sl in (slice(0, 130), slice(130, N)):
        lse = tpl.pairwise_lse_plain(
            torch.from_numpy(z), torch.from_numpy(means[sl]),
            torch.tensor(lv), None, torch.from_numpy(ex[sl]),
            torch.from_numpy(valid[sl]))
        halves.append((lse, torch.ones_like(lse)))   # state (m, s) = (lse, 1)
    m, s = tep.lse_combine(*halves[0], *halves[1])
    jm, js = jep.lse_combine(*(jnp.asarray(t.numpy()) for h in halves
                               for t in h))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    full = _torch(problem, "naive", False) + np.log(N - 1.0)
    np.testing.assert_allclose((m + torch.log(s)).numpy(), full,
                               rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_counts_no_launch(problem):
    z, means, lv, _, ex, valid = problem
    before = tpl.pairwise_lse.launches
    tpl.pairwise_lse(torch.from_numpy(z), torch.from_numpy(means),
                     torch.tensor(lv), None, torch.from_numpy(ex),
                     torch.from_numpy(valid))
    assert tpl.pairwise_lse.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "ex_idx"])
def test_wrapper_rejects_bad_inputs(problem, bad):
    z, means, lv, _, ex, valid = problem
    args = [torch.from_numpy(z), torch.from_numpy(means), torch.tensor(lv),
            None, torch.from_numpy(ex), torch.from_numpy(valid)]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[1] = args[1][:, :3]
    else:
        args[4] = args[4].long()
    with pytest.raises((TypeError, ValueError)):
        tpl.pairwise_lse(*args)
