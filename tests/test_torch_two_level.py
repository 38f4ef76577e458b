"""Port vs JAX: the two-level models (HVAE, ConvHVAE) at a small size.

The same flax params go into both packages (weights.params_from_flax, conv
kernels in the HWIO layout) and the port is fed JAX's noise: the forward's
``split(key)`` into (k2, k1), generation's z1 draw, the IWAE's per-round
(k2, k1). Inputs are 12x12 / 18x18 gray or binary images made from a numpy
seed; conv specs cover SAME padding that is asymmetric (k3 s2 on even
sizes), an odd decoder input (3x3), a transposed conv whose stride exceeds
k-1 (k2 s3) and one that is cropped (k3 s2).

Tolerances (fp32): encoder stats, latents and decoder means rtol 1e-5 /
atol 1e-5; RE and KL per example (sums over pixels and latents) and NLLs
rtol 1e-5 / atol 1e-4; the fast IWAE path against the generic one on the
same noise rtol 1e-5 / atol 1e-4 (the same arithmetic on rows in another
grouping); a fp32 train step's gradients each within 1e-4 of the tensor's
largest element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.config import parse_conv_spec as j_parse_conv_spec
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.serve import export_serving_bundle
from exemplar_vae_tpu.train import evaluation as jev
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu.train import sampling as jsampling
from exemplar_vae_tpu.train.checkpoints import _flatten_with_keys
from exemplar_vae_tpu_torch.config import Config, parse_conv_spec
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.serve import ServingBundle
from exemplar_vae_tpu_torch.train import evaluation as tev
from exemplar_vae_tpu_torch.train import sampling
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank, elbo_terms
from exemplar_vae_tpu_torch.weights import params_from_flax, params_to_flax

B, N, Z1, Z2 = 5, 24, 4, 6
TOL = dict(rtol=1e-5, atol=1e-5)
TERM_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_REL = 1e-4

# (model, H = W, conv_enc_spec, conv_dec_spec)
ARCHS = {
    "hvae": ("hvae_2level", 12, None, None),
    "conv": ("convhvae_2level", 12, "4k3s1,4k3s2,8k3s1,8k3s2",
             "t8k3s2,t4k3s2,c4k3s1"),
    "conv_odd": ("convhvae_2level", 18, "4k3s1,4k4s2,8k5s3",
                 "t8k2s3,t4k3s2,c4k3s1"),
}


def _images(hw, n, input_type, seed):
    x = np.random.default_rng(seed).random((n, hw, hw, 1)).astype(np.float32)
    return (x < 0.4).astype(np.float32) if input_type == "binary" else x


def _pair(arch, input_type, **kw):
    name, hw, enc, dec = ARCHS[arch]
    conv = {} if enc is None else dict(conv_enc_spec=enc, conv_dec_spec=dec,
                                       conv_proj_channels=5)
    jcfg = JConfig(model_name=name, hidden_size=16, z1_size=Z1, z2_size=Z2,
                   input_size=(1, hw, hw), input_type=input_type,
                   dynamic_binarization=False, number_components=N,
                   prior_variance_init=0.6, use_pallas_prior=False,
                   prior_block_n=10, exact_reencode_chunk=0, S=8, MB=4,
                   test_batch_size=4, **conv, **kw)
    jm = j_create_model(jcfg)
    key = jax.random.PRNGKey(0)
    x = _images(hw, N, input_type, 1)
    params = jm.init(key, jnp.asarray(x[:2]), key)["params"]
    if input_type == "gray":
        params = _narrow_bins(params)
    cfg = Config.from_json(jcfg.to_json())
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, cfg, tm, x


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


def _banks(x, jm, jcfg, params, tm, cfg):
    jb = jloss.Bank(images=jnp.asarray(x), data_idx=jnp.arange(N, dtype=jnp.int32),
                    valid=jnp.ones(N, bool), cache_means=None, n_effective=N)
    tb = Bank(images=torch.from_numpy(x),
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


def test_parse_conv_spec_matches_jax():
    for spec in ("32k7s1,32k3s2,64k5s1,64k3s2", "t64k3s2, t32k3s2,c32k3s1",
                 "8k1s1"):
        assert parse_conv_spec(spec) == j_parse_conv_spec(spec)
    with pytest.raises(ValueError, match="bad conv-spec"):
        parse_conv_spec("8x3s1")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_flax_two_level(arch):
    """Every flax leaf (conv kernels HWIO, numbered stacks q_z2_conv_0 ...)
    maps onto one state_dict entry of the same shape, and back."""
    _, _, params, _, tm, _ = _pair(arch, "gray")
    flat = dict(_flatten_with_keys(params))
    back = dict(_flatten_with_keys(params_to_flax(tm.state_dict())))
    assert back.keys() == flat.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(flat[k]), err_msg=k)


@pytest.mark.parametrize("input_type", ["binary", "gray"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_elbo_terms_match_jax(arch, input_type):
    jcfg, jm, params, cfg, tm, x = _pair(arch, input_type)
    *_, jeb, teb = _banks(x, jm, jcfg, params, tm, cfg)
    np.testing.assert_allclose(teb.cache_means.numpy(),
                               np.asarray(jeb.cache_means), **TOL)
    key = jax.random.PRNGKey(3)
    xb = x[:B]
    jout = jm.apply({"params": params}, jnp.asarray(xb), key)
    jre, jkl, _ = jloss.elbo_terms(jm, {"params": params}, jnp.asarray(xb),
                                   key, jcfg, bank=jeb, train=False)
    with torch.no_grad():
        eps = _fwd_noise(key, B)
        tout = tm(torch.from_numpy(xb), eps=eps)
        tre, tkl, _ = elbo_terms(tm, torch.from_numpy(xb), cfg, bank=teb,
                                 train=False, eps=eps)
        hx = tm.q_z1_cache(torch.from_numpy(xb))
    want_hx = jm.apply({"params": params}, jnp.asarray(xb),
                       method="q_z1_cache")
    for got, want in zip(tuple(tout) + (hx,), tuple(jout) + (want_hx,)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), **TERM_TOL)
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), **TERM_TOL)


def test_conv_model_shapes_at_config_3_widths():
    """The default spec at 28x28: encoder features 7*7*64 = 3136 into the
    z2 heads and q_z1_joint, the decoder's project to 7*7*64."""
    tm = create_model(Config(model_name="convhvae_2level", hidden_size=16,
                             input_type="gray"), device="cpu")
    assert tm.q_z2_mean_head.kernel.shape == (3136, 40)
    assert tm.q_z1_joint.h_kernel.shape == (3136 + 16, 16)
    assert tm.p_x_project.kernel.shape == (32, 3136)
    assert tm.q_z2_conv_0.h_kernel.shape == (7, 7, 1, 32)
    assert tm.p_x_deconv_0.h_kernel.shape == (3, 3, 64, 64)
    assert tm.p_x_mean_head.kernel.shape == (1, 1, 32, 1)
    with torch.no_grad():
        out = tm(torch.rand(2, 28, 28, 1))
    assert out.x_mean.shape == (2, 28, 28, 1) and out.z_top.shape == (2, 40)


@pytest.mark.parametrize("enc,dec,hw,match", [
    ("4k3s2,4k3s2", "t4k3s2", 12, "downsampling x4 != decoder"),
    ("4k3s2", "t4k3s2,4k3s2", 12, "downsampling x2 != decoder"),
    ("4k3s2", "t4k3s2", 13, "divisible by 2"),
    ("t4k3s2", "4k3s2", 12, "net-downsampling"),
])
def test_conv_setup_checks(enc, dec, hw, match):
    with pytest.raises(ValueError, match=match):
        create_model(Config(model_name="convhvae_2level", conv_enc_spec=enc,
                            conv_dec_spec=dec, input_size=(1, hw, hw)),
                     device="cpu")


def test_two_level_models_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("hvae_2level", "convhvae_2level"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model(Config(model_name=name))


def test_resolve_device_turns_tf32_off(monkeypatch):
    """An fp32 conv model is held against its CPU run on the card because
    cuDNN and the matmuls run without TF32 there."""
    from exemplar_vae_tpu_torch.device import resolve_device
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert resolve_device("cuda").type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# the train step (exact prior), validation ELBO, IWAE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["hvae", "conv"])
def test_exact_train_step_gradients_match_jax(arch):
    jcfg, jm, params, cfg, tm, x = _pair(arch, "gray")
    jb, tb, _, _ = _banks(x, jm, jcfg, params, tm, cfg)
    rows = np.array([0, 3, 7, 20, 23])
    key = jax.random.PRNGKey(7)
    _, _, k_z = jax.random.split(key, 3)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss.batch_loss(jm, {"params": p}, jnp.asarray(x[rows]),
                                   k_z, 0.7, jcfg,
                                   data_idx=jnp.asarray(rows, jnp.int32),
                                   bank=jb, train=True), has_aux=True)(params)
    state = tsteps.init_train_state(tm, cfg)
    _, aux = tsteps.make_train_step(cfg)(
        state, torch.from_numpy(x[rows]), torch.from_numpy(rows.astype(np.int32)),
        tb, 0.7, eps=_fwd_noise(k_z, len(rows)))
    np.testing.assert_allclose(float(aux["loss"]), float(jl), rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, jg))
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_REL * max(float(np.abs(w).max()), 1e-30), (name, err)


@pytest.mark.parametrize("arch", ["hvae", "conv"])
def test_elbo_eval_matches_jax(arch):
    """Validation ELBO in batches of 4 with a tail of 2; JAX's per-batch
    draws (fold_in(key, i), split, then the forward's split)."""
    jcfg, jm, params, cfg, tm, x = _pair(arch, "gray")
    *_, jeb, teb = _banks(x, jm, jcfg, params, tm, cfg)
    val = _images(ARCHS[arch][1], 10, "gray", 6)
    key = jax.random.PRNGKey(5)
    want = jev.make_elbo_eval_fn(jm, jcfg)(params, val, key, jeb)
    eps = [_fwd_noise(jax.random.split(jax.random.fold_in(key, i))[1], s)
           for i, s in enumerate([4, 4, 2])]
    got = tev.make_elbo_eval_fn(tm, cfg)(val, teb, eps=eps)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)


def _iwae_eps(k_chunk, rounds, rows):
    """JAX's chunk_nll draws: split(key) -> (k_bin, k_s); per round
    fold_in(k_s, i), split into (k2, k1)."""
    _, k_s = jax.random.split(k_chunk)
    e2, e1 = zip(*[_fwd_noise(jax.random.fold_in(k_s, i), rows)
                   for i in range(rounds)])
    return torch.stack(e2), torch.stack(e1)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("arch", ["hvae", "conv"])
def test_iwae_fast_and_generic_match_jax(arch, kernel):
    """The encode-once path and the generic path on the same noise, and
    both against JAX's chunk_nll; the port's kernel impl runs its plain
    version on the CPU."""
    jcfg, jm, params, cfg, tm, x = _pair(arch, "gray")
    *_, jeb, teb = _banks(x, jm, jcfg, params, tm, cfg)
    cfg = cfg.replace(use_pallas_prior=kernel)
    rounds, r, t = 2, 3, 4
    key = jax.random.PRNGKey(4)
    want = jev.make_iwae_fn(jm, jcfg).chunk_nll(params, jnp.asarray(x[:t]),
                                               key, jeb, rounds, r)
    eps = _iwae_eps(key, rounds, t * r)
    fast = tev.make_iwae_fn(tm, cfg).chunk_nll(x[:t], teb, rounds, r, eps=eps)
    generic = tev.make_iwae_fn(tm, cfg, force_generic=True).chunk_nll(
        x[:t], teb, rounds, r, eps=eps)
    assert fast.shape == (t,) and torch.isfinite(fast).all()
    np.testing.assert_allclose(fast.numpy(), generic.numpy(), **TERM_TOL)
    np.testing.assert_allclose(fast.numpy(), np.asarray(want), **TERM_TOL)
    with pytest.raises(ValueError, match="eps must be"):
        tev.make_iwae_fn(tm, cfg).chunk_nll(x[:t], teb, rounds, r,
                                            eps=eps[0])


def test_calculate_likelihood_two_level_matches_jax():
    """The chunk loop (chunks of 4, a tail of 2, S = 7 in ceil(7/3) rounds)
    for the ConvHVAE, with the generator instead of noise on the port's
    second call (finite, same shape)."""
    jcfg, jm, params, cfg, tm, x = _pair("conv", "gray")
    *_, jeb, teb = _banks(x, jm, jcfg, params, tm, cfg)
    n, key = 10, jax.random.PRNGKey(9)
    mean_j, per_j = jev.make_iwae_fn(jm, jcfg)(params, jnp.asarray(x[:n]),
                                              key, jeb, s_total=7, chunk=4,
                                              r=3)
    eps = [_iwae_eps(jax.random.fold_in(key, i), 3, min(4, n - s) * 3)
           for i, s in enumerate(range(0, n, 4))]
    mean_t, per_t = tev.make_iwae_fn(tm, cfg)(x[:n], teb, s_total=7, chunk=4,
                                             r=3, eps=eps)
    np.testing.assert_allclose(per_t, np.asarray(per_j), **TERM_TOL)
    assert mean_t == pytest.approx(float(mean_j), rel=1e-5)
    _, drawn = tev.make_iwae_fn(tm, cfg)(x[:n], teb, s_total=7, chunk=4, r=3,
                                        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (n,) and np.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# generation and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["hvae", "conv"])
def test_generation_matches_jax(arch):
    jcfg, jm, params, cfg, tm, x = _pair(arch, "gray")
    key = jax.random.PRNGKey(11)
    want = jsampling.generate_x(jm, params, jcfg, 3, key,
                                bank_images_raw=jnp.asarray(x), n_valid=20)
    k_pick, _, k_z, k_dec = jax.random.split(key, 4)
    got = sampling.generate_x(
        tm, cfg, 3, x, n_valid=20,
        idx=np.array(jax.random.randint(k_pick, (3,), 0, 20)),
        eps=np.array(jax.random.normal(k_z, (3, Z2))),
        eps1=np.array(jax.random.normal(k_dec, (3, Z1))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jsampling.reference_based_generation_x(jm, params, jcfg, key,
                                                  jnp.asarray(x[:2]),
                                                  n_per_ref=2)
    _, k_z, k_dec = jax.random.split(key, 3)
    got = sampling.reference_based_generation_x(
        tm, cfg, x[:2], n_per_ref=2,
        eps=np.array(jax.random.normal(k_z, (4, Z2))),
        eps1=np.array(jax.random.normal(k_dec, (4, Z1))))
    assert got.shape == (4,) + x.shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv_bundle_from_jax_served_by_port(tmp_path):
    """A ConvHVAE bundle exported by the JAX package loads through
    ServingBundle.load(device='cpu') and scores and generates as the JAX
    bundle does (a padded tail chunk included)."""
    from exemplar_vae_tpu.serve import ServingBundle as JBundle
    jcfg, jm, params, cfg, tm, x = _pair("conv", "gray")
    *_, jeb, _ = _banks(x, jm, jcfg, params, tm, cfg)
    export_serving_bundle(jm, jcfg, params, str(tmp_path),
                          bank_means=jeb.cache_means, data_idx=jeb.data_idx,
                          valid=jeb.valid, n_effective=N, n_gen=3,
                          ref_batch=2, score_chunk=4, s_total=6, r=3)
    jb = JBundle.load(str(tmp_path))
    tb = ServingBundle.load(str(tmp_path), device="cpu")
    assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(
        Config.from_json(jcfg.to_json()))
    key = jax.random.PRNGKey(21)
    mean_j, per_j = jb.score_nll(x[:6], key)
    eps = [_iwae_eps(jax.random.fold_in(key, i), 2, 4 * 3) for i in range(2)]
    mean_t, per_t = tb.score_nll(x[:6], eps=eps)
    np.testing.assert_allclose(per_t, per_j, **TERM_TOL)
    assert mean_t == pytest.approx(mean_j, rel=1e-5)
    k_pick, _, k_z, k_dec = jax.random.split(key, 4)
    got = tb.generate(idx=np.array(jax.random.randint(k_pick, (3,), 0, N)),
                      eps=np.array(jax.random.normal(k_z, (3, Z2))),
                      eps1=np.array(jax.random.normal(k_dec, (3, Z1))))
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.generate(key)), **TOL)
    _, k_z, k_dec = jax.random.split(key, 3)
    got = tb.reference_generate(
        x[:2], eps=np.array(jax.random.normal(k_z, (2, Z2))),
        eps1=np.array(jax.random.normal(k_dec, (2, Z1))))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jb.reference_generate(x[:2], key)), **TOL)
