"""Port vs JAX: weights crossing over and the MLP VAE at fp32.

The same flax params go into both packages (weights.params_from_flax); the
same numpy inputs and the same Gaussian noise (JAX's draw, injected) go
through flax and the port. Tolerance: rtol 1e-5 / atol 1e-5 on encoder
stats and decoder means (fp32 GEMMs in another summation order); the prior
log-densities, rtol 1e-5 / atol 1e-4 (sums over D and over components)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.train.checkpoints import _flatten_with_keys
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.weights import (keystr_path, params_from_flax,
                                            params_from_keystr,
                                            params_to_flax)

B = 6


def _pair(input_type="binary", prior="exemplar_prior", **kw):
    jcfg = JConfig(model_name="vae", prior=prior, hidden_size=32, z1_size=8,
                   input_type=input_type, number_components=5,
                   prior_variance_init=0.7, **kw)
    jm = j_create_model(jcfg)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    x = (rng.random((B, 28, 28, 1)) < 0.4).astype(np.float32)
    params = jm.init(key, jnp.asarray(x), key)["params"]
    if prior == "vampprior":   # move pseudo-inputs off the clamp's zero edge
        params = dict(params, pseudo_inputs=jnp.asarray(
            rng.random(params["pseudo_inputs"].shape, np.float32)))
    cfg = Config.from_json(jcfg.to_json())
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, cfg, tm, x


def test_params_from_flax_round_trip():
    _, _, params, _, tm, _ = _pair(input_type="gray")
    flat = dict(_flatten_with_keys(params))
    back = params_to_flax(tm.state_dict())
    assert dict(_flatten_with_keys(back)).keys() == flat.keys()
    for k, v in _flatten_with_keys(back):
        np.testing.assert_array_equal(v, np.asarray(flat[k]))
    sd = params_from_keystr({k: np.asarray(v) for k, v in flat.items()})
    assert sd.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("bad", ["q_layers_0", "['a']b", "['a']['b'"])
def test_keystr_rejects_malformed(bad):
    with pytest.raises(ValueError):
        keystr_path(bad)


@pytest.mark.parametrize("input_type", ["binary", "gray"])
def test_vae_matches_flax(input_type):
    jcfg, jm, params, cfg, tm, x = _pair(input_type=input_type)
    v = {"params": params}
    key = jax.random.PRNGKey(3)
    jout = jm.apply(v, jnp.asarray(x), key)
    eps = np.array(jax.random.normal(key, (B, cfg.z1_size)))
    with torch.no_grad():
        tout = tm(torch.from_numpy(x), eps=torch.from_numpy(eps))
        t_mean, t_lv = tm.encode_top(torch.from_numpy(x))
        t_dec = tm.decode(tout.z_top)
    j_mean, j_lv = jm.apply(v, jnp.asarray(x), method="encode_top")
    for got, want in ((t_mean, j_mean), (t_lv, j_lv),
                      (tout.z_top, jout.z_top), (tout.x_mean, jout.x_mean),
                      (tout.x_logvar, jout.x_logvar), (t_dec[0], jout.x_mean),
                      (tout.extra_kl, jout.extra_kl)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert tout.x_mean.shape == (B, 28, 28, 1)


@pytest.mark.parametrize("prior", ["standard", "vampprior", "exemplar_prior"])
def test_log_p_z_top_matches_flax(prior):
    jcfg, jm, params, cfg, tm, x = _pair(prior=prior)
    rng = np.random.default_rng(5)
    z = rng.normal(size=(B, cfg.z1_size)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if prior == "exemplar_prior":
        means = rng.normal(size=(11, cfg.z1_size)).astype(np.float32)
        common = dict(log_denom=np.log(11.0), impl="scan", block_n=4)
        kw_j = dict(bank_means=jnp.asarray(means),
                    exemplar_idx=jnp.arange(11, dtype=jnp.int32), **common)
        kw_t = dict(bank_means=torch.from_numpy(means),
                    exemplar_idx=torch.arange(11, dtype=torch.int32), **common)
    want = jm.apply({"params": params}, jnp.asarray(z), method="log_p_z_top",
                    **kw_j)
    with torch.no_grad():
        got = tm.log_p_z_top(torch.from_numpy(z), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("floor", [0.0, 0.05])
def test_prior_log_var_clamp(floor):
    _, jm, params, cfg, tm, _ = _pair(prior_var_min=floor)
    from exemplar_vae_tpu.models.base import clamped_prior_log_var as j_clamp
    from exemplar_vae_tpu_torch.models.base import clamped_prior_log_var
    for val in (-9.0, -3.5, 0.2, 9.0):
        with torch.no_grad():
            tm.prior_log_var.fill_(val)
        p = dict(params, prior_log_var=jnp.float32(val))
        want = float(j_clamp(p, JConfig(prior_var_min=floor)))
        assert float(clamped_prior_log_var(tm, cfg).detach()) == pytest.approx(
            want, rel=1e-6)


@pytest.mark.parametrize("name", ["pixelhvae_2level", "pixelhvae",
                                  "pixel_hvae"])
def test_unported_families_name_their_slice(name):
    """Every family is ported: PixelHVAE, which this test saw refused
    before its slice, builds under each of its names (its parity tests:
    tests/test_torch_pixel_hvae.py)."""
    from exemplar_vae_tpu_torch.models.pixel_hvae import PixelHVAE
    tm = create_model(Config(model_name=name, hidden_size=8, z1_size=2,
                             z2_size=2, pixelcnn_features=4,
                             pixelcnn_layers=1), device="cpu")
    assert isinstance(tm, PixelHVAE)


def test_seeded_init_is_reproducible():
    cfg = Config(hidden_size=16, z1_size=4)
    a = create_model(cfg, device="cpu", seed=3).state_dict()
    b = create_model(cfg, device="cpu", seed=3).state_dict()
    c = create_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q_layers_0.h_kernel"], c["q_layers_0.h_kernel"])
