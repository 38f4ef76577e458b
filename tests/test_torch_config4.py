"""Port vs JAX: BASELINE Config 4's shapes at a small spatial size.

Config 4 is the two-level ConvHVAE on 3-channel continuous images stored as
uint8 (CelebA; here a numpy-seeded 16x16x3 stand-in), with the default conv
spec (enc 32k7s1, 32k3s2, 64k5s1, 64k3s2; dec t64k3s2, t32k3s2, c32k3s1;
projection 64), whose x4 downsampling 16 divides. At C = 1 the NHWC and
NCHW flatten orders coincide; at C = 3 a channel-order slip in the NHWC <->
NCHW views, the first conv's HWIO kernel or the 1x1 heads would show here.

The same flax params go into both packages and the port is fed JAX's noise
and the dequantization uniforms that the JAX side sees as (x + u)/256. The
bank is raw uint8 in both, preprocessed per chunk ((x + 0.5)/256).

Tolerances (fp32): encoder stats, conv features and decoder outputs rtol
1e-5 / atol 1e-5; RE and KL per example (sums over 768 pixels and the
latents), validation and IWAE NLLs rtol 1e-5 / atol 1e-4; each train-step
gradient tensor within 1e-4 of its largest element, with the decoder's
log-scale head started near -4 as a trained model's is (at scale ~1 the two
frameworks' sigmoids, an ulp apart, move logistic-256 gradients by ~1e-4
relative; ROADMAP.md, Queue 3).
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
from exemplar_vae_tpu.train import evaluation as jev
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu.train import steps as jsteps
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.serve import ServingBundle
from exemplar_vae_tpu_torch.train import evaluation as tev
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank, elbo_terms
from exemplar_vae_tpu_torch.weights import params_from_flax

HW, C, N, N_TRAIN, K, Z1, Z2 = 16, 3, 24, 30, 4, 4, 6
ROWS = np.array([0, 3, 7, 20, 23, 27])          # the last is not in the bank
BETA = 0.7
TOL = dict(rtol=1e-5, atol=1e-5)
TERM_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_REL = 1e-4


def _cfgs(**kw):
    base = dict(model_name="convhvae_2level", input_size=(C, HW, HW),
                input_type="continuous", dynamic_binarization=False,
                hidden_size=16, z1_size=Z1, z2_size=Z2, number_components=N,
                approximate_k=K, prior_variance_init=0.6,
                use_pallas_prior=False, prior_block_n=10,
                exact_reencode_chunk=10, exact_remat=False, S=8, MB=4,
                test_batch_size=4)
    base.update(kw)
    jcfg = JConfig(**base)
    return jcfg, Config.from_json(jcfg.to_json())


def _narrow_bins(params):
    params = dict(params)
    head = dict(params["p_x_logvar_head"])
    head["bias"] = head["bias"] - 4.0
    params["p_x_logvar_head"] = head
    return params


def _images(n, seed):
    """uint8 NHWC images: a smooth per-channel pattern plus noise, so the
    three channels differ in mean and structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(HW), np.arange(HW), indexing="ij")
    base = np.stack([40 + 8 * yy, 200 - 9 * xx, 60 + 5 * (xx + yy)], -1)
    noise = rng.integers(-40, 41, (n, HW, HW, C))
    return np.clip(base[None] + noise, 0, 255).astype(np.uint8)


def _eval_pre(x):
    return (x.astype(np.float32) + 0.5) / 256.0


@pytest.fixture(scope="module")
def problem():
    jcfg, cfg = _cfgs()
    jm = j_create_model(jcfg)
    key = jax.random.PRNGKey(0)
    train_x = _images(N_TRAIN, 3)
    params = _narrow_bins(jm.init(key, jnp.asarray(_eval_pre(train_x[:2])),
                                  key)["params"])
    return jm, params, train_x


def _port_model(cfg, params):
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return tm


def _banks(jm, jcfg, params, tm, cfg, train_x):
    jb = jloss.Bank(images=jnp.asarray(train_x[:N]),
                    data_idx=jnp.arange(N, dtype=jnp.int32),
                    valid=jnp.ones(N, bool), cache_means=None, n_effective=N)
    tb = Bank(images=torch.from_numpy(train_x[:N]),
              data_idx=torch.arange(N, dtype=torch.int32),
              valid=torch.ones(N, dtype=torch.bool), cache_means=None,
              n_effective=N)
    return (jb, tb, jev.make_eval_bank_fn(jm, jcfg)(params, jb,
                                                    jax.random.PRNGKey(1)),
            tev.make_eval_bank_fn(tm, cfg)(tb))


def _fwd_noise(key, b):
    """JAX's forward draws: split(key) -> (k2, k1), z2's noise then z1's."""
    k2, k1 = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(k2, (b, Z2)))),
            torch.from_numpy(np.array(jax.random.normal(k1, (b, Z1)))))


def test_default_conv_spec_at_three_channels(problem):
    """The parameter shapes that carry the channel axis: the first convs'
    HWIO kernels take 3 input channels, the 1x1 heads give 3, and the dense
    heads read 4*4*64 features."""
    _, params, _ = problem
    _, cfg = _cfgs()
    tm = _port_model(cfg, params)
    assert cfg.conv_enc_spec == "32k7s1,32k3s2,64k5s1,64k3s2"
    assert cfg.conv_dec_spec == "t64k3s2,t32k3s2,c32k3s1"
    assert tm.q_z2_conv_0.h_kernel.shape == (7, 7, 3, 32)
    assert tm.q_z1_conv_0.h_kernel.shape == (7, 7, 3, 32)
    assert tm.p_x_mean_head.kernel.shape == (1, 1, 32, 3)
    assert tm.p_x_logvar_head.kernel.shape == (1, 1, 32, 3)
    assert tm.q_z2_mean_head.kernel.shape == (4 * 4 * 64, Z2)
    assert tm.p_x_project.kernel.shape == (32, 4 * 4 * 64)


def test_forward_and_elbo_terms_match_jax(problem):
    """encode_top, q_z1_cache, the forward's decode and the ELBO terms on
    uint8 images dequantized at eval, against a uint8 eval bank."""
    jm, params, train_x = problem
    jcfg, cfg = _cfgs()
    tm = _port_model(cfg, params)
    *_, jeb, teb = _banks(jm, jcfg, params, tm, cfg, train_x)
    np.testing.assert_allclose(teb.cache_means.numpy(),
                               np.asarray(jeb.cache_means), **TOL)
    xb = _eval_pre(train_x[ROWS])
    key = jax.random.PRNGKey(3)
    v = {"params": params}
    jout = jm.apply(v, jnp.asarray(xb), key)
    jre, jkl, _ = jloss.elbo_terms(jm, v, jnp.asarray(xb), key, jcfg,
                                   bank=jeb, train=False)
    want_top = jm.apply(v, jnp.asarray(xb), method="encode_top")
    want_hx = jm.apply(v, jnp.asarray(xb), method="q_z1_cache")
    eps = _fwd_noise(key, len(ROWS))
    with torch.no_grad():
        xt = torch.from_numpy(xb)
        tout = tm(xt, eps=eps)
        tre, tkl, _ = elbo_terms(tm, xt, cfg, bank=teb, train=False, eps=eps)
        got_top = tm.encode_top(xt)
        hx = tm.q_z1_cache(xt)
    assert tuple(tout.x_mean.shape) == (len(ROWS), HW, HW, C)
    for got, want in zip(tuple(tout) + tuple(got_top) + (hx,),
                         tuple(jout) + tuple(want_top) + (want_hx,)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), **TERM_TOL)
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), **TERM_TOL)


def test_decode_matches_jax(problem):
    """decode(z1, z2) alone, both likelihood heads, NHWC out."""
    jm, params, _ = problem
    _, cfg = _cfgs()
    tm = _port_model(cfg, params)
    rng = np.random.default_rng(4)
    z1 = rng.normal(size=(5, Z1)).astype(np.float32)
    z2 = rng.normal(size=(5, Z2)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(z1), jnp.asarray(z2),
                    method="decode")
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z1), torch.from_numpy(z2))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (5, HW, HW, C)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_cache_refresh_on_a_uint8_bank_matches_jax(problem):
    jm, params, train_x = problem
    jcfg, cfg = _cfgs()
    want = jsteps.make_cache_refresh(jm, jcfg)(params, jnp.asarray(
        train_x[:N]), jax.random.PRNGKey(1))
    got = tsteps.make_cache_refresh(_port_model(cfg, params), cfg)(
        torch.from_numpy(train_x[:N]))
    assert got.shape == (N, Z2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["exact", "per_row", "batch_union"])
def test_train_step_gradients_match_jax(problem, mode):
    """One train step on uint8 images: the port dequantizes the batch with
    the injected uniforms u, JAX gets (x + u)/256; the raw uint8 bank is
    re-encoded in chunks (exact) or gathered by kNN over a stale cache
    (approximate, per-row or batch-union support)."""
    jm, params, train_x = problem
    kw = ({} if mode == "exact" else
          dict(approximate_prior=True, approximate_support=mode))
    jcfg, cfg = _cfgs(**kw)
    stale = jax.tree.map(lambda p: p * 1.1, params)
    cache = np.array(jsteps.make_cache_refresh(jm, jcfg)(
        stale, jnp.asarray(train_x[:N]), jax.random.PRNGKey(1)))
    u = np.random.default_rng(5).random(
        (len(ROWS), HW, HW, C)).astype(np.float32)
    x_j = (train_x[ROWS].astype(np.float32) + u) / 256.0
    jb = jloss.Bank(images=jnp.asarray(train_x[:N]),
                    data_idx=jnp.arange(N, dtype=jnp.int32),
                    valid=jnp.ones(N, bool), cache_means=jnp.asarray(cache),
                    n_effective=N)
    _, _, k_z = jax.random.split(jax.random.PRNGKey(7), 3)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss.batch_loss(jm, {"params": p}, jnp.asarray(x_j), k_z,
                                   BETA, jcfg,
                                   data_idx=jnp.asarray(ROWS, jnp.int32),
                                   bank=jb, train=True), has_aux=True)(params)
    tm = _port_model(cfg, params)
    tb = Bank(images=torch.from_numpy(train_x[:N]),
              data_idx=torch.arange(N, dtype=torch.int32),
              valid=torch.ones(N, dtype=torch.bool),
              cache_means=torch.from_numpy(cache), n_effective=N)
    _, aux = tsteps.make_train_step(cfg)(
        tsteps.init_train_state(tm, cfg), torch.from_numpy(train_x[ROWS]),
        torch.from_numpy(ROWS.astype(np.int32)), tb, BETA,
        u=torch.from_numpy(u), eps=_fwd_noise(k_z, len(ROWS)))
    np.testing.assert_allclose(float(aux["loss"]), float(jl), rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_REL * max(float(np.abs(w).max()), 1e-30), (name, err)


def test_elbo_eval_matches_jax(problem):
    """Validation ELBO on uint8 images in batches of 4 with a tail of 2."""
    jm, params, train_x = problem
    jcfg, cfg = _cfgs()
    tm = _port_model(cfg, params)
    *_, jeb, teb = _banks(jm, jcfg, params, tm, cfg, train_x)
    val = _images(10, 6)
    key = jax.random.PRNGKey(5)
    want = jev.make_elbo_eval_fn(jm, jcfg)(params, val, key, jeb)
    eps = [_fwd_noise(jax.random.split(jax.random.fold_in(key, i))[1], s)
           for i, s in enumerate([4, 4, 2])]
    got = tev.make_elbo_eval_fn(tm, cfg)(val, teb, eps=eps)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)


def _iwae_eps(k_chunk, rounds, rows):
    _, k_s = jax.random.split(k_chunk)
    e2, e1 = zip(*[_fwd_noise(jax.random.fold_in(k_s, i), rows)
                   for i in range(rounds)])
    return torch.stack(e2), torch.stack(e1)


@pytest.mark.parametrize("kernel", [False, True])
def test_iwae_matches_jax(problem, kernel):
    """chunk_nll on raw uint8 points, the encode-once path and the generic
    path on the same noise, both against JAX; the kernel impl runs its plain
    version on the CPU."""
    jm, params, train_x = problem
    jcfg, cfg = _cfgs()
    tm = _port_model(cfg, params)
    *_, jeb, teb = _banks(jm, jcfg, params, tm, cfg, train_x)
    cfg = cfg.replace(use_pallas_prior=kernel)
    rounds, r, t = 2, 3, 4
    xs = train_x[N:N + t]
    key = jax.random.PRNGKey(4)
    want = jev.make_iwae_fn(jm, jcfg).chunk_nll(params, jnp.asarray(xs), key,
                                               jeb, rounds, r)
    eps = _iwae_eps(key, rounds, t * r)
    fast = tev.make_iwae_fn(tm, cfg).chunk_nll(xs, teb, rounds, r, eps=eps)
    generic = tev.make_iwae_fn(tm, cfg, force_generic=True).chunk_nll(
        xs, teb, rounds, r, eps=eps)
    assert fast.shape == (t,) and torch.isfinite(fast).all()
    np.testing.assert_allclose(fast.numpy(), generic.numpy(), **TERM_TOL)
    np.testing.assert_allclose(fast.numpy(), np.asarray(want), **TERM_TOL)


def test_continuous_bundle_from_jax_served_by_port(problem, tmp_path):
    """A continuous bundle (x_dtype uint8) exported by the JAX package
    scores raw uint8 points in the port as in JAX, and refuses floats."""
    jm, params, train_x = problem
    jcfg, cfg = _cfgs()
    tm = _port_model(cfg, params)
    *_, jeb, _ = _banks(jm, jcfg, params, tm, cfg, train_x)
    export_serving_bundle(jm, jcfg, params, str(tmp_path),
                          bank_means=jeb.cache_means, data_idx=jeb.data_idx,
                          valid=jeb.valid, n_effective=N, n_gen=3,
                          ref_batch=2, score_chunk=4, s_total=6, r=3)
    jb = JBundle.load(str(tmp_path))
    tb = ServingBundle.load(str(tmp_path), device="cpu")
    assert tb.manifest["x_dtype"] == "uint8"
    xs = train_x[:6]
    key = jax.random.PRNGKey(21)
    mean_j, per_j = jb.score_nll(xs, key)
    eps = [_iwae_eps(jax.random.fold_in(key, i), 2, 4 * 3) for i in range(2)]
    mean_t, per_t = tb.score_nll(xs, eps=eps)
    np.testing.assert_allclose(per_t, per_j, **TERM_TOL)
    assert mean_t == pytest.approx(mean_j, rel=1e-5)
    with pytest.raises(ValueError, match="uint8"):
        tb.score_nll(xs.astype(np.float32) / 255.0, eps=eps)
