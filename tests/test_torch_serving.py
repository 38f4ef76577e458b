"""Port vs JAX: the serving slice as a whole.

Same weights, same data and JAX's noise replayed into the port: the key
splits of generate (split(key, 4); randint, normal), of
reference_generate (split(key, 3)) and of the IWAE (per chunk
fold_in(key, i), then split into (k_bin, k_s), per round fold_in(k_s, j)).
A JAX-exported bundle is loaded by the port's ServingBundle and held
against JAX's own replay of it.

Tolerance: decoder means rtol 1e-5 / atol 1e-5; NLLs (hundreds of nats,
sums over 784 pixels and over the bank) rtol 1e-5 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.serve import ServingBundle as JBundle
from exemplar_vae_tpu.serve import export_serving_bundle
from exemplar_vae_tpu.serve import make_serving_fns as j_serving_fns
from exemplar_vae_tpu.train import sampling as jsampling
from exemplar_vae_tpu.train.evaluation import (make_eval_bank_fn as j_bank_fn,
                                               make_iwae_fn as j_iwae_fn)
from exemplar_vae_tpu.train.loss import Bank as JBank
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.serve import ServingBundle, make_serving_fns
from exemplar_vae_tpu_torch.train import sampling
from exemplar_vae_tpu_torch.train.evaluation import (make_eval_bank_fn,
                                                     make_iwae_fn)
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.weights import params_from_flax

NB, Z = 24, 8
IMG_TOL = dict(rtol=1e-5, atol=1e-5)
NLL_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig(model_name="vae", prior="exemplar_prior", hidden_size=32,
                   z1_size=Z, S=16, MB=8, test_batch_size=8,
                   dataset_name="synthetic", use_pallas_prior=False,
                   prior_block_n=16, exact_reencode_chunk=10,
                   prior_variance_init=0.5)
    jm = j_create_model(jcfg)
    k = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    x = (rng.random((NB, 28, 28, 1)) < 0.3).astype(np.float32)
    params = jm.init(k, jnp.asarray(x), k)["params"]
    jbank = JBank(images=jnp.asarray(x),
                  data_idx=jnp.arange(NB, dtype=jnp.int32),
                  valid=jnp.ones(NB, bool), cache_means=None, n_effective=NB)
    jeb = j_bank_fn(jm, jcfg)(params, jbank, k)
    cfg = Config.from_json(jcfg.to_json())
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    bank = Bank(images=x, data_idx=np.arange(NB, dtype=np.int32),
                valid=np.ones(NB, bool), cache_means=None, n_effective=NB)
    eb = make_eval_bank_fn(tm, cfg)(bank)
    return jcfg, jm, params, jeb, cfg, tm, eb, x


def _round_eps(k_chunk, rounds, rows):
    """The per-round reparameterization noise of JAX's chunk_nll."""
    _, k_s = jax.random.split(k_chunk)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(k_s, i), (rows, Z)))
        for i in range(rounds)]))


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_eval_bank_matches_jax(pair, raw_uint8):
    jcfg, jm, params, _, cfg, tm, _, x = pair
    imgs = (x * 255).astype(np.uint8) if raw_uint8 else x
    jeb = j_bank_fn(jm, jcfg)(
        params, JBank(images=jnp.asarray(imgs),
                      data_idx=jnp.arange(NB, dtype=jnp.int32),
                      valid=jnp.ones(NB, bool), cache_means=None,
                      n_effective=NB), jax.random.PRNGKey(1))
    eb = make_eval_bank_fn(tm, cfg)(
        Bank(images=imgs, data_idx=np.arange(NB, dtype=np.int32),
             valid=np.ones(NB, bool), cache_means=None, n_effective=NB))
    assert eb.cache_means.shape == (NB, Z) and eb.images is None
    np.testing.assert_allclose(eb.cache_means.numpy(),
                               np.asarray(jeb.cache_means), **IMG_TOL)


@pytest.mark.parametrize("port_kernel", [False, True])
@pytest.mark.parametrize("jax_pallas", [False, True])
def test_chunk_nll_matches_jax(pair, jax_pallas, port_kernel):
    """IWAE chunk with injected per-round noise; JAX scan or Pallas
    (interpret) against the port's scan or kernel wrapper (plain on CPU)."""
    jcfg, jm, params, jeb, cfg, tm, eb, x = pair
    rounds, r, t = 2, 8, 5
    key = jax.random.PRNGKey(4)
    want = j_iwae_fn(jm, jcfg.replace(use_pallas_prior=jax_pallas)).chunk_nll(
        params, jnp.asarray(x[:t]), key, jeb, rounds, r)
    iwae = make_iwae_fn(tm, cfg.replace(use_pallas_prior=port_kernel))
    got = iwae.chunk_nll(x[:t], eb, rounds, r,
                         eps=_round_eps(key, rounds, t * r))
    assert got.shape == (t,) and torch.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NLL_TOL)


@pytest.mark.parametrize("s_total,r,chunk", [(16, 8, 8), (20, 8, None)])
def test_calculate_likelihood_matches_jax(pair, s_total, r, chunk):
    """Chunk loop with a ragged tail, ceil-divided rounds (20 = 3 x 8) and
    the chunk autotune."""
    jcfg, jm, params, jeb, cfg, tm, eb, x = pair
    n, key = 20, jax.random.PRNGKey(5)
    mean_j, per_j = j_iwae_fn(jm, jcfg)(params, jnp.asarray(x[:n]), key, jeb,
                                        s_total=s_total, chunk=chunk, r=r)
    step = chunk or jcfg.test_batch_size
    rounds = -(-s_total // r)
    eps = [_round_eps(jax.random.fold_in(key, i), rounds,
                      min(step, n - start) * r)
           for i, start in enumerate(range(0, n, step))]
    mean_t, per_t = make_iwae_fn(tm, cfg)(x[:n], eb, s_total=s_total,
                                          chunk=chunk, r=r, eps=eps)
    np.testing.assert_allclose(per_t, np.asarray(per_j), **NLL_TOL)
    assert mean_t == pytest.approx(float(mean_j), rel=1e-5)


def _gen_draws(key, n, hi):
    k_pick, _, k_z, _ = jax.random.split(key, 4)
    return (np.array(jax.random.randint(k_pick, (n,), 0, hi)),
            np.array(jax.random.normal(k_z, (n, Z))))


def test_generate_x_matches_jax(pair):
    jcfg, jm, params, _, cfg, tm, _, x = pair
    key = jax.random.PRNGKey(11)
    want = jsampling.generate_x(jm, params, jcfg, 6, key,
                                bank_images_raw=jnp.asarray(x), n_valid=20)
    idx, eps = _gen_draws(key, 6, 20)
    got = sampling.generate_x(tm, cfg, 6, x, n_valid=20, idx=idx, eps=eps)
    assert got.shape == (6, 28, 28, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG_TOL)


def test_generate_x_standard_prior_matches_jax(pair):
    jcfg, jm, params, _, cfg, tm, _, _ = pair
    jcfg, cfg = jcfg.replace(prior="standard"), cfg.replace(prior="standard")
    jm = j_create_model(jcfg)
    p = {k: v for k, v in params.items() if k != "prior_log_var"}
    ts = create_model(cfg, device="cpu")
    ts.load_state_dict(params_from_flax(jax.tree.map(np.asarray, p)))
    key = jax.random.PRNGKey(12)
    want = jsampling.generate_x(jm, p, jcfg, 4, key)
    _, eps = _gen_draws(key, 4, 1)
    got = sampling.generate_x(ts, cfg, 4, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG_TOL)


@pytest.mark.parametrize("n_per_ref", [1, 2])
def test_reference_generation_matches_jax(pair, n_per_ref):
    jcfg, jm, params, _, cfg, tm, _, x = pair
    key = jax.random.PRNGKey(13)
    want = jsampling.reference_based_generation_x(
        jm, params, jcfg, key, jnp.asarray(x[:4]), n_per_ref=n_per_ref)
    _, k_z, _ = jax.random.split(key, 3)
    eps = np.array(jax.random.normal(k_z, (4 * n_per_ref, Z)))
    got = sampling.reference_based_generation_x(tm, cfg, x[:4],
                                                n_per_ref=n_per_ref, eps=eps)
    assert got.shape == (4 * n_per_ref, 28, 28, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG_TOL)


def test_serving_fns_match_jax(pair):
    jcfg, jm, params, jeb, cfg, tm, eb, x = pair
    rounds, r = 2, 4
    jgen, jref, jscore = j_serving_fns(jm, jcfg, NB, 5, rounds, r)
    gen, ref, score = make_serving_fns(tm, cfg, NB, 5, rounds, r)
    key = jax.random.PRNGKey(3)
    idx, eps = _gen_draws(key, 5, NB)
    np.testing.assert_allclose(
        gen(eb.cache_means, idx=idx, eps=eps).numpy(),
        np.asarray(jgen(params, jeb.cache_means, key)), **IMG_TOL)
    _, k_z, _ = jax.random.split(key, 3)
    np.testing.assert_allclose(
        ref(x[:4], eps=np.array(jax.random.normal(k_z, (4, Z)))).numpy(),
        np.asarray(jref(params, jnp.asarray(x[:4]), key)), **IMG_TOL)
    np.testing.assert_allclose(
        score(x[:4], eb.cache_means, eb.data_idx, eb.valid,
              eps=_round_eps(key, rounds, 4 * r)).numpy(),
        np.asarray(jscore(params, jnp.asarray(x[:4]), key, jeb.cache_means,
                          jeb.data_idx, jeb.valid)), **NLL_TOL)


@pytest.fixture(scope="module")
def bundle_dir(pair, tmp_path_factory):
    jcfg, jm, params, jeb, _, _, _, _ = pair
    out = str(tmp_path_factory.mktemp("bundle"))
    export_serving_bundle(jm, jcfg, params, out, bank_means=jeb.cache_means,
                          data_idx=jeb.data_idx, valid=jeb.valid,
                          n_effective=jeb.n_effective, n_gen=5, ref_batch=4,
                          score_chunk=8, s_total=16, r=8)
    return out


def test_jax_bundle_served_by_port(pair, bundle_dir):
    """The port loads a JAX-exported bundle (weights + eval bank from
    arrays.npz, config from bundle.json) and serves all three programs as
    JAX's replay of the same bundle does, incl. the padded score tail."""
    *_, x = pair
    jb = JBundle.load(bundle_dir)
    tb = ServingBundle.load(bundle_dir, device="cpu")
    assert tb.cfg.hidden_size == 32 and not tb.cfg.use_pallas_prior
    key = jax.random.PRNGKey(21)

    idx, eps = _gen_draws(key, 5, NB)
    np.testing.assert_allclose(tb.generate(idx=idx, eps=eps).numpy(),
                               np.asarray(jb.generate(key)), **IMG_TOL)
    _, k_z, _ = jax.random.split(key, 3)
    np.testing.assert_allclose(
        tb.reference_generate(x[:4], eps=np.array(
            jax.random.normal(k_z, (4, Z)))).numpy(),
        np.asarray(jb.reference_generate(x[:4], key)), **IMG_TOL)

    n = 20                                      # 2 full chunks + tail of 4
    mean_j, per_j = jb.score_nll(x[:n], key)
    eps = [_round_eps(jax.random.fold_in(key, i), 2, 8 * 8)
           for i in range(3)]
    mean_t, per_t = tb.score_nll(x[:n], eps=eps)
    assert per_t.shape == (n,)
    np.testing.assert_allclose(per_t, per_j, **NLL_TOL)
    assert mean_t == pytest.approx(mean_j, rel=1e-5)


def test_bundle_input_rules(pair, bundle_dir, tmp_path):
    """_prep_x: raw uint8 is scaled by 1/255 for binary bundles (same NLL
    as the float input), a wrong ref batch is refused, and a continuous
    bundle refuses float input."""
    *_, x = pair
    tb = ServingBundle.load(bundle_dir, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x8 = (x[:8] * 255).astype(np.uint8)
    _, per8 = tb.score_nll(x8, generator=gen)
    _, perf = tb.score_nll(x8.astype(np.float32) / 255.0,
                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(per8, perf, rtol=0, atol=0)
    with pytest.raises(ValueError, match="batches of 4"):
        tb.reference_generate(x[:3])

    tb.manifest = dict(tb.manifest, x_dtype="uint8")
    with pytest.raises(ValueError, match="uint8"):
        tb.score_nll(x[:4])
    assert tb._prep_x(x8).dtype == np.uint8
