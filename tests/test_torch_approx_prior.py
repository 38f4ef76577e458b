"""Port vs JAX: the approximate (kNN) exemplar prior, at a small size.

kNN selection and the batch-union mask are held equal to the JAX package
exactly (integer-valued data keeps every distance exact in fp32, so planted
ties are real ties in both). The per-row prior, the cache refresh and one
ConvHVAE train step in the exact, approximate per-row and approximate
batch-union modes are held against JAX with the same params, the same stale
cache and JAX's reparameterization noise injected; the Experiment's cache
lags the params by one epoch, as the JAX trainer's does.

Tolerances (fp32): per-row prior and cache means rtol 1e-5 / atol 1e-5; the
step's loss rtol 1e-5 and each gradient tensor within 1e-4 of its largest
element; recompute on and off (``approx_remat``, ``exact_remat``) within
1e-6 relative, 1e-7 absolute (the same arithmetic, recomputed).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.models.base import (
    rows_exemplar_log_prob as j_rows_log_prob)
from exemplar_vae_tpu.ops.knn import dedup_valid_mask as j_dedup
from exemplar_vae_tpu.ops.knn import knn_indices as j_knn
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu.train import steps as jsteps
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.models.base import rows_exemplar_log_prob
from exemplar_vae_tpu_torch.ops.knn import dedup_valid_mask, knn_indices
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.train.trainer import Experiment
from exemplar_vae_tpu_torch.weights import params_from_flax

HW, N, N_TRAIN, K, Z1, Z2 = 12, 24, 30, 4, 4, 6
ROWS = np.array([0, 3, 7, 20, 23, 27])          # the last is not in the bank
BETA = 0.7
GRAD_REL = 1e-4
SMALL_CONV = dict(conv_enc_spec="4k3s1,4k3s2,8k3s1,8k3s2",
                  conv_dec_spec="t8k3s2,t4k3s2,c4k3s1", conv_proj_channels=5)

# ---------------------------------------------------------------------------
# kNN selection, the batch-union mask, the per-row prior
# ---------------------------------------------------------------------------


def _tied_problem(rng, n_base, reps, d=6, b=5):
    """A cache of ``reps`` identical copies of ``n_base`` integer rows
    (rows i, n_base+i, ... tie exactly) and integer queries."""
    base = rng.integers(-3, 4, (n_base, d)).astype(np.float32)
    cache = np.concatenate([base] * reps)
    q = base[rng.integers(0, n_base, b)] + rng.integers(-1, 2, (b, d))
    return q.astype(np.float32), cache


@pytest.mark.parametrize("case", ["ties", "valid_mask", "k_over_n",
                                  "all_tied"])
def test_knn_indices_equal_lax_top_k(case):
    rng = np.random.default_rng(0)
    q, cache = _tied_problem(rng, 10, 3)
    valid, k = None, 7
    if case == "valid_mask":                # padding rows that would win
        cache[25:] = q[:5]
        valid = np.arange(30) < 25
    elif case == "k_over_n":
        q, cache = _tied_problem(rng, 3, 2)
        k = 10
    elif case == "all_tied":
        cache = np.zeros((30, 6), np.float32)
    want = np.asarray(j_knn(jnp.asarray(q), jnp.asarray(cache), k,
                            valid=None if valid is None else jnp.asarray(valid)))
    got = knn_indices(torch.from_numpy(q), torch.from_numpy(cache), k,
                      valid=None if valid is None else torch.from_numpy(valid))
    assert got.shape == want.shape == (5, min(k, cache.shape[0]))
    np.testing.assert_array_equal(got.numpy(), want)
    if valid is not None:
        assert (got.numpy() < 25).all()


def test_dedup_valid_mask_equals_jax():
    rng = np.random.default_rng(1)
    for n, hi in ((40, 12), (7, 100), (1, 3)):
        flat = rng.integers(0, hi, n).astype(np.int32)
        want = np.asarray(j_dedup(jnp.asarray(flat)))
        got = dedup_valid_mask(torch.from_numpy(flat))
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == len(np.unique(flat))


@pytest.mark.parametrize("loo", [False, True])
def test_rows_exemplar_log_prob_matches_jax(loo):
    """Values and gradients (z, the per-row means, log sigma^2), with the
    LOO mask hitting some rows' own neighbour."""
    rng = np.random.default_rng(2)
    z = rng.normal(size=(5, Z2)).astype(np.float32)
    means = (z[:, None] + 0.8 * rng.normal(size=(5, K, Z2))).astype(np.float32)
    ex = rng.integers(0, 20, (5, K)).astype(np.int32)
    didx = ex[:, 0].copy()
    didx[3] = 99
    g = rng.normal(size=5).astype(np.float32)
    kw = dict(log_denom=float(np.log(N - 1.0)))

    def jf(z_, m_, lv_):
        out = j_rows_log_prob(z_, m_, lv_, data_idx=jnp.asarray(didx) if loo
                              else None, exemplar_idx_bk=jnp.asarray(ex), **kw)
        return jnp.sum(jnp.asarray(g) * out), out

    (_, want), wgrads = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(z), jnp.asarray(means), jnp.float32(-0.4))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (z, means, np.float32(-0.4))]
    got = rows_exemplar_log_prob(
        *leaves, data_idx=torch.from_numpy(didx) if loo else None,
        exemplar_idx_bk=torch.from_numpy(ex), **kw)
    (torch.from_numpy(g) * got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, w in zip(leaves, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the cache refresh and the train step in three prior modes
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    kw = dict(dict(model_name="convhvae_2level", input_size=(1, HW, HW),
                   input_type="gray", dynamic_binarization=False,
                   hidden_size=16, z1_size=Z1, z2_size=Z2, number_components=N,
                   approximate_k=K, prior_variance_init=0.6,
                   use_pallas_prior=True, prior_block_n=10,
                   exact_reencode_chunk=0, exact_remat=False, **SMALL_CONV),
              **kw)
    jcfg = JConfig(**kw)
    return jcfg, Config.from_json(jcfg.to_json())


def _narrow_bins(params):
    """Start the gray decoder's log-scale head at -4 (a trained model's
    range): with scale ~1 a 1/256 bin holds ~1e-3 of mass, the difference
    of two sigmoids near 0.5, and the two frameworks' sigmoids (an ulp
    apart) then disagree by ~1e-4 relative in the gradients."""
    params = dict(params)
    head = dict(params["p_x_logvar_head"])
    if "Dense_0" in head:
        head["Dense_0"] = dict(head["Dense_0"],
                               bias=head["Dense_0"]["bias"] - 4.0)
    else:
        head["bias"] = head["bias"] - 4.0
    params["p_x_logvar_head"] = head
    return params


@pytest.fixture(scope="module")
def problem():
    jcfg, cfg = _cfgs()
    jm = j_create_model(jcfg)
    key = jax.random.PRNGKey(0)
    train_x = np.random.default_rng(3).random(
        (N_TRAIN, HW, HW, 1)).astype(np.float32)
    params = _narrow_bins(jm.init(key, jnp.asarray(train_x[:2]),
                                  key)["params"])
    # a stale cache: the bank encoded by params 10% off the current ones
    stale = jax.tree.map(lambda p: p * 1.1, params)
    cache = jsteps.make_cache_refresh(jm, jcfg)(stale, jnp.asarray(
        train_x[:N]), jax.random.PRNGKey(1))
    return jm, params, stale, np.array(cache), train_x


def _port_model(cfg, params):
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return tm


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_cache_refresh_matches_jax(problem, raw_uint8):
    jm, _, stale, cache, train_x = problem
    jcfg, cfg = _cfgs(exact_reencode_chunk=0 if raw_uint8 else 7)
    bank = (train_x[:N] * 255).astype(np.uint8) if raw_uint8 else train_x[:N]
    want = (np.asarray(jsteps.make_cache_refresh(jm, jcfg)(
        stale, jnp.asarray(bank), jax.random.PRNGKey(1))) if raw_uint8
        else cache)
    got = tsteps.make_cache_refresh(_port_model(cfg, stale), cfg)(
        torch.from_numpy(bank))
    assert got.shape == (N, Z2) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_grads(jcfg, jm, params, cache, train_x):
    bank = jloss.Bank(images=jnp.asarray(train_x[:N]),
                      data_idx=jnp.arange(N, dtype=jnp.int32),
                      valid=jnp.ones(N, bool), cache_means=jnp.asarray(cache),
                      n_effective=N)
    _, _, k_z = jax.random.split(jax.random.PRNGKey(7), 3)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jloss.batch_loss(jm, {"params": p}, jnp.asarray(
            train_x[ROWS]), k_z, BETA, jcfg,
            data_idx=jnp.asarray(ROWS, jnp.int32), bank=bank, train=True),
        has_aux=True)(params)
    k2, k1 = jax.random.split(k_z)
    eps = (torch.from_numpy(np.array(jax.random.normal(k2, (len(ROWS), Z2)))),
           torch.from_numpy(np.array(jax.random.normal(k1, (len(ROWS), Z1)))))
    return float(loss), params_from_flax(jax.tree.map(np.asarray, grads)), eps


def _port_step(cfg, params, cache, train_x, eps, bank_images=None):
    tm = _port_model(cfg, params)
    imgs = train_x[:N] if bank_images is None else bank_images
    tb = Bank(images=torch.from_numpy(imgs),
              data_idx=torch.arange(N, dtype=torch.int32),
              valid=torch.ones(N, dtype=torch.bool),
              cache_means=torch.from_numpy(cache), n_effective=N)
    state = tsteps.init_train_state(tm, cfg)
    _, aux = tsteps.make_train_step(cfg)(
        state, torch.from_numpy(train_x[ROWS]),
        torch.from_numpy(ROWS.astype(np.int32)), tb, BETA, eps=eps)
    return float(aux["loss"]), {n: p.grad.clone()
                                for n, p in tm.named_parameters()}


@pytest.mark.parametrize("mode", ["exact", "per_row", "batch_union"])
def test_train_step_gradients_match_jax(problem, mode):
    jm, params, _, cache, train_x = problem
    kw = ({} if mode == "exact" else
          dict(approximate_prior=True, approximate_support=mode))
    jcfg, cfg = _cfgs(**kw)
    loss_j, grads_j, eps = _jax_grads(jcfg, jm, params, cache, train_x)
    loss_t, grads_t = _port_step(cfg, params, cache, train_x, eps)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert grads_t.keys() == grads_j.keys()
    for name, g in grads_t.items():
        w = grads_j[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * max(float(np.abs(w).max()), 1e-30), (name, err)


@pytest.mark.parametrize("support", ["per_row", "batch_union"])
def test_approx_remat_on_and_off_agree(problem, support):
    _, params, _, cache, train_x = problem
    eps = (torch.randn(len(ROWS), Z2, generator=torch.Generator().manual_seed(0)),
           torch.randn(len(ROWS), Z1, generator=torch.Generator().manual_seed(1)))
    out = [_port_step(_cfgs(approximate_prior=True, approximate_support=support,
                            approx_remat=remat)[1], params, cache, train_x, eps)
           for remat in (False, True)]
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for name, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_approx_step_on_a_raw_uint8_bank(problem):
    """A raw uint8 bank is gathered raw and preprocessed per gathered row:
    the same step as the float bank of the same gray levels."""
    _, params, _, cache, train_x = problem
    _, cfg = _cfgs(approximate_prior=True)
    raw = (train_x[:N] * 255).astype(np.uint8)
    x = train_x.copy()
    x[:N] = raw / np.float32(255.0)
    eps = (torch.zeros(len(ROWS), Z2), torch.zeros(len(ROWS), Z1))
    loss_f, grads_f = _port_step(cfg, params, cache, x, eps)
    loss_u, grads_u = _port_step(cfg, params, cache, x, eps, bank_images=raw)
    assert loss_u == pytest.approx(loss_f, rel=1e-6)
    for name, g in grads_f.items():
        np.testing.assert_allclose(grads_u[name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_stochastic_uint8_bank_under_exact_remat(problem):
    """A raw uint8 bank with stochastic preprocessing under the exact
    prior: each chunk's uniforms are drawn outside the recomputed region,
    so recompute on and off give the same gradients from the same
    generator; the draws really are stochastic (another seed differs)."""
    _, params, _, _, train_x = problem
    _, cfg = _cfgs(input_type="binary", dynamic_binarization=True,
                   bank_stochastic_preprocess=True, exact_reencode_chunk=10)
    raw = torch.from_numpy((train_x[:N] * 255).astype(np.uint8))
    eps = (torch.zeros(len(ROWS), Z2), torch.zeros(len(ROWS), Z1))
    params = {k: v for k, v in params.items() if k != "p_x_logvar_head"}

    def step(remat, seed):
        c = cfg.replace(exact_remat=remat)
        tm = _port_model(c, params)
        tb = Bank(images=raw, data_idx=torch.arange(N, dtype=torch.int32),
                  valid=torch.ones(N, dtype=torch.bool), cache_means=None,
                  n_effective=N)
        _, aux = tsteps.make_train_step(c)(
            tsteps.init_train_state(tm, c), raw[ROWS[:-1]],
            torch.from_numpy(ROWS[:-1].astype(np.int32)), tb, BETA,
            eps=(eps[0][:-1], eps[1][:-1]),
            generator=torch.Generator().manual_seed(seed))
        return float(aux["loss"]), {n: p.grad for n, p in tm.named_parameters()}

    (l0, g0), (l1, g1), (l2, _) = step(False, 0), step(True, 0), step(True, 1)
    assert l1 == pytest.approx(l0, rel=1e-6) and l2 != l0
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# the Experiment
# ---------------------------------------------------------------------------


def _exp_cfg(tmp_path, **kw):
    d = dict(dataset_name="synthetic_gray", model_name="convhvae_2level",
             training_set_size=96, val_set_size=32, test_set_size=16,
             number_components=96, batch_size=32, warmup=1, epochs=2, S=4,
             MB=2, test_batch_size=16, hidden_size=16, z1_size=Z1,
             z2_size=Z2, approximate_prior=True, approximate_k=5,
             exact_reencode_chunk=40, snapshot_dir=str(tmp_path), **SMALL_CONV)
    d.update(kw)
    return Config(**d)


def test_cache_is_stale_by_one_epoch(tmp_path):
    """The cache used in epoch e is the bank encoded with the params that
    epoch e started from, and the zero cache before the first epoch."""
    exp = Experiment(_exp_cfg(tmp_path), device="cpu", verbose=False)
    assert exp.bank.cache_means.shape == (96, Z2)
    assert not exp.bank.cache_means.any()
    fresh = create_model(exp.cfg, device="cpu")
    for _ in range(2):
        before = {k: v.clone() for k, v in exp.model.state_dict().items()}
        exp.train_epoch()
        fresh.load_state_dict(before)
        want = tsteps.make_cache_refresh(fresh, exp.cfg)(exp.bank.images)
        torch.testing.assert_close(exp.bank.cache_means, want, rtol=0,
                                   atol=1e-6)
        now = tsteps.make_cache_refresh(exp.model, exp.cfg)(exp.bank.images)
        assert not torch.allclose(exp.bank.cache_means, now, atol=1e-6)


@pytest.mark.parametrize("support", ["per_row", "batch_union"])
def test_experiment_trains_approx_convhvae(tmp_path, support):
    """Two CPU epochs of a tiny approximate ConvHVAE through Experiment.run:
    finite metrics in metrics.jsonl and results.json."""
    exp = Experiment(_exp_cfg(tmp_path, approximate_support=support),
                     device="cpu", verbose=False)
    results = exp.run()
    lines = [json.loads(line) for line in open(exp._metrics_path)]
    epochs = [line for line in lines if "val_loss" in line]
    assert len(epochs) == 2 and exp.state.step == 2 * exp.steps_per_epoch
    for line in epochs:
        assert all(np.isfinite(v) for v in line.values()
                   if isinstance(v, float)), line
    with open(os.path.join(exp.exp_dir, "results.json")) as f:
        assert json.load(f) == results
    assert np.isfinite(results["test_nll"]) and results["test_nll"] > 0


def test_approximate_k_larger_than_bank_still_trains(tmp_path):
    """k > N picks every bank row (min(k, N)), as lax.top_k does."""
    exp = Experiment(_exp_cfg(tmp_path, model_name="hvae_2level",
                              dataset_name="synthetic", number_components=40,
                              approximate_k=1000), device="cpu",
                     verbose=False)
    assert np.isfinite(exp.train_epoch()["loss"])
