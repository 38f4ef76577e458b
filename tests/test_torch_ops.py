"""Port vs JAX: preprocessing and log-density primitives
(exemplar_vae_tpu_torch/ops/{preprocess,distributions}.py against
exemplar_vae_tpu/ops/{preprocess,distributions}.py) on the same numpy
inputs. Random draws are replayed: JAX's uniform draw is injected as ``u``.

Tolerance: elementwise fp32 ops agree to rounding (rtol 1e-6); pixel sums
over 784 terms to rtol 1e-5, atol 1e-4 (summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.ops import distributions as jd
from exemplar_vae_tpu.ops import preprocess as jp
from exemplar_vae_tpu.ops.knn import pairwise_sq_dist as j_sq_dist
from exemplar_vae_tpu_torch.ops import distributions as td
from exemplar_vae_tpu_torch.ops import preprocess as tp
from exemplar_vae_tpu_torch.ops.knn import pairwise_sq_dist


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_float(dtype):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (3, 28, 28, 1)).astype(dtype)
    if dtype == np.float32:
        x = x / 255.0
    _close(tp.to_float(torch.from_numpy(np.array(x))),
           jp.to_float(jnp.asarray(x)), rtol=1e-7, atol=0)


CASES = [
    # (input_type, dynamic_binarization, train, raw dtype)
    ("binary", True, False, np.float32),    # eval: pass-through
    ("binary", True, False, np.uint8),      # eval, raw: /255
    ("binary", True, True, np.float32),     # fresh Bernoulli draw
    ("binary", False, True, np.float32),    # static binarization
    ("continuous", False, True, np.uint8),  # (x + u)/256
    ("continuous", False, False, np.uint8),  # (x + 0.5)/256
    ("continuous", False, False, np.float32),
    ("gray", False, True, np.uint8),
]


@pytest.mark.parametrize("input_type,dyn,train,dtype", CASES)
def test_preprocess_batch_matches_jax(input_type, dyn, train, dtype):
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, (4, 28, 28, 1))
    x = raw.astype(np.uint8) if dtype == np.uint8 else \
        (raw / 255.0).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jp.preprocess_batch(key, jnp.asarray(x), input_type=input_type,
                               dynamic_binarization=dyn, train=train)
    # jax.random.bernoulli(key, p) == uniform(key, shape) < p
    u = np.array(jax.random.uniform(key, x.shape))
    got = tp.preprocess_batch(torch.from_numpy(np.array(x)),
                              input_type=input_type, dynamic_binarization=dyn,
                              train=train, u=torch.from_numpy(u))
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-6, atol=0)


def _gauss_inputs():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    mean = rng.normal(size=(6, 40)).astype(np.float32)
    log_var = rng.uniform(-6, 2, size=(6, 40)).astype(np.float32)
    return x, mean, log_var


@pytest.mark.parametrize("include_const", [False, True])
@pytest.mark.parametrize("reduce_dim", [-1, None])
def test_log_normal_diag(include_const, reduce_dim):
    x, mean, lv = _gauss_inputs()
    want = jd.log_normal_diag(jnp.asarray(x), jnp.asarray(mean),
                              jnp.asarray(lv), reduce_dim=reduce_dim,
                              include_const=include_const)
    got = td.log_normal_diag(torch.from_numpy(x), torch.from_numpy(mean),
                             torch.from_numpy(lv), reduce_dim=reduce_dim,
                             include_const=include_const)
    _close(got, want)


@pytest.mark.parametrize("include_const", [False, True])
def test_log_normal_standard(include_const):
    x, _, _ = _gauss_inputs()
    _close(td.log_normal_standard(torch.from_numpy(x),
                                  include_const=include_const),
           jd.log_normal_standard(jnp.asarray(x), include_const=include_const))


def test_log_bernoulli_clamps():
    rng = np.random.default_rng(3)
    x = (rng.random((5, 784)) < 0.5).astype(np.float32)
    p = rng.random((5, 784)).astype(np.float32)
    p[:, :10] = 0.0          # clamped to MIN_EPSILON
    p[:, 10:20] = 1.0        # clamped to 1 - MIN_EPSILON
    got = td.log_bernoulli(torch.from_numpy(x), torch.from_numpy(p))
    assert torch.isfinite(got).all()
    _close(got, jd.log_bernoulli(jnp.asarray(x), jnp.asarray(p)))


def test_log_logistic_256_bin_snapping():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (5, 784)).astype(np.float32) / 256.0
    x[:, :5] += 0.3 / 256.0              # inside a bin: snaps to its left edge
    x[:, 5:10] = 255.0 / 256.0           # last bin
    mean = rng.uniform(1 / 512, 1 - 1 / 512, (5, 784)).astype(np.float32)
    lv = rng.uniform(-4.5, 0.0, (5, 784)).astype(np.float32)
    lv[:, :3] = -4.5                     # narrow logistic: 1e-7 floor binds
    args = (x, mean, lv)
    got = td.log_logistic_256(*map(torch.from_numpy, args))
    want = jd.log_logistic_256(*map(jnp.asarray, args))
    _close(got, want)
    # per pixel, compare the bin mass cdf(x+) - cdf(x-) + 1e-7: each
    # framework's sigmoid is within one ulp of 1.0 (6e-8), so a narrow bin's
    # mass cancels to within 2.5e-7, which is a large share of its log
    per_pix_t = td.log_logistic_256(*map(torch.from_numpy, args),
                                    reduce_dim=None)
    per_pix_j = jd.log_logistic_256(*map(jnp.asarray, args), reduce_dim=None)
    _close(np.exp(per_pix_t.numpy()), np.exp(np.asarray(per_pix_j)),
           rtol=0, atol=2.5e-7)


def test_pairwise_sq_dist():
    """Expanded |q|^2 + |b|^2 - 2 q.b, clamped at 0 (an exact duplicate
    row gives 0, not a small negative)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(7, 40)).astype(np.float32)
    bank = rng.normal(size=(30, 40)).astype(np.float32)
    bank[3] = q[2]
    got = pairwise_sq_dist(torch.from_numpy(q), torch.from_numpy(bank))
    assert got.shape == (7, 30) and (got >= 0).all()
    _close(got, j_sq_dist(jnp.asarray(q), jnp.asarray(bank)), rtol=1e-5,
           atol=1e-4)
