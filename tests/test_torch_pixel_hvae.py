"""Port vs JAX: the PixelHVAE (masked-conv PixelCNN decoder) at a small size.

The same flax params go into both packages (weights.params_from_flax, the
masked kernels HWIO) and the port is fed JAX's noise: the forward's
``split(key)`` into (k2, k1), the IWAE's per-round (k2, k1), and the
samplers' ``split(key)`` into (k1, k_pix) with one uniform per pixel,
``fold_in(k_pix, i)``. Sizes: PixelCNN features 8, 2 masked 'B' layers,
hidden 16, 12x12 binary or gray images from a numpy seed. The slowest
cases (the crop sampler at 28x28, an Experiment epoch, a CLI epoch and
resume) are in tests/test_torch_pixel_hvae_runs.py.

Tolerances: fp32 decoder means, latents and encoder stats rtol 1e-5 / atol
1e-5; RE and KL per example and NLLs rtol 1e-5 / atol 1e-4; a fp32 train
step's gradients each within 1e-4 of the tensor's largest element; bf16
decoder means within 3e-2 of the largest (the bf16 train-step tolerance of
tests/test_torch_training.py); gray (mean-fill) samples atol 1e-4. Binary
samples are equal, except that a row may part at its first differing pixel
when that pixel's uniform lies within 1e-5 of its decoded mean (two
summation orders on either side of u); every pixel after it then follows
another canvas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.train import evaluation as jev
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu.train import sampling as jsampling
from exemplar_vae_tpu.train.checkpoints import _flatten_with_keys
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.train import evaluation as tev
from exemplar_vae_tpu_torch.train import sampling
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank, elbo_terms
from exemplar_vae_tpu_torch.weights import params_from_flax, params_to_flax

B, N, Z1, Z2, HW = 5, 24, 4, 6, 12
TOL = dict(rtol=1e-5, atol=1e-5)
TERM_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_REL = 1e-4
BF16_REL = 3e-2
U_MARGIN = 1e-5


def _images(n, input_type, seed, hw=HW):
    x = np.random.default_rng(seed).random((n, hw, hw, 1)).astype(np.float32)
    return (x < 0.4).astype(np.float32) if input_type == "binary" else x


def _pair(input_type="binary", hw=HW, **kw):
    jcfg = JConfig(model_name="pixelhvae_2level", hidden_size=16, z1_size=Z1,
                   z2_size=Z2, input_size=(1, hw, hw), input_type=input_type,
                   dynamic_binarization=False, number_components=N,
                   prior_variance_init=0.6, use_pallas_prior=False,
                   prior_block_n=10, exact_reencode_chunk=0, S=8, MB=4,
                   test_batch_size=4, pixelcnn_features=8, pixelcnn_layers=2,
                   **kw)
    jm = j_create_model(jcfg)
    key = jax.random.PRNGKey(0)
    x = _images(N, input_type, 1, hw)
    params = jm.init(key, jnp.asarray(x[:2]), key)["params"]
    if input_type == "gray":
        # the log-scale head near -3, off the narrow bins' cancellation at
        # scale ~1 (tests/test_torch_two_level.py::_narrow_bins) and inside
        # its clamp [-4.5, 0]: at -4 some pixels of this 8-feature stack
        # reach -4.5, where an ulp decides whether a gradient passes
        params = dict(params, p_x_logvar_head=dict(
            params["p_x_logvar_head"],
            bias=params["p_x_logvar_head"]["bias"] - 3.0))
    cfg = Config.from_json(jcfg.to_json())
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, cfg, tm, x


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _fwd_noise(key, b):
    """JAX's forward draws: split(key) -> (k2, k1), z2's noise then z1's."""
    k2, k1 = jax.random.split(key)
    return (_t(jax.random.normal(k2, (b, Z2))), _t(jax.random.normal(k1, (b, Z1))))


def _sampler_noise(key, b, hw=HW):
    """JAX's sampler draws: split(key) -> (k1, k_pix); z1's noise, then
    uniform(fold_in(k_pix, i), (b, 1)) for pixel i."""
    k1, k_pix = jax.random.split(key)
    u = np.stack([np.array(jax.random.uniform(jax.random.fold_in(k_pix, i),
                                              (b, 1)))
                  for i in range(hw * hw)])
    return _t(jax.random.normal(k1, (b, Z1))), torch.from_numpy(u)


def _differing_rows(got, want, u, tm, z2, eps1):
    """Rows in which binary samples differ; each must part at a pixel whose
    uniform lies within U_MARGIN of its mean, decoded teacher-forced from
    ``want`` (pixels before the first difference are shared, and the
    decoder is causal)."""
    got, want = np.array(got), np.array(want)
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert set(np.unique(want)) <= {0.0, 1.0}
    b = got.shape[0]
    with torch.no_grad():
        p1_mean, p1_logvar = tm.p_z1(z2)
        z1 = p1_mean + torch.exp(0.5 * p1_logvar) * eps1
        mean = tm.decode(torch.from_numpy(want), z1, z2)[0].reshape(b, -1)
    rows = 0
    for row in range(b):
        diff = np.nonzero(got[row].reshape(-1) != want[row].reshape(-1))[0]
        if diff.size:
            i = diff[0]
            assert abs(float(u[i, row, 0]) - float(mean[row, i])) < U_MARGIN, (
                row, i, float(u[i, row, 0]), float(mean[row, i]))
            rows += 1
    return rows


# ---------------------------------------------------------------------------
# the model: params, decode, causality, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("input_type", ["binary", "gray"])
def test_params_from_flax_pixel(input_type):
    """Every flax leaf (ctx_proj, pix_in, pix_layers_i, the 1x1 heads, the
    two-level MLP nets) maps onto one state_dict entry of the same shape,
    and back; the masks are buffers outside the state_dict."""
    _, _, params, _, tm, _ = _pair(input_type)
    flat = dict(_flatten_with_keys(params))
    back = dict(_flatten_with_keys(params_to_flax(tm.state_dict())))
    assert back.keys() == flat.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(flat[k]), err_msg=k)
    assert tm.pix_in.kernel.shape == (5, 5, 1, 8)
    assert tm.pix_layers_1.kernel.shape == (3, 3, 8, 8)
    assert tm.ctx_proj.kernel.shape == (Z1 + Z2, HW * HW * 8)


def _latents(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, Z1)).astype(np.float32),
            rng.normal(size=(b, Z2)).astype(np.float32))


@pytest.mark.parametrize("input_type", ["binary", "gray"])
def test_decode_matches_jax(input_type):
    jcfg, jm, params, cfg, tm, x = _pair(input_type)
    z1, z2 = _latents(B, 2)
    want = jm.apply({"params": params}, jnp.asarray(x[:B]), jnp.asarray(z1),
                    jnp.asarray(z2), method="decode")
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(x[:B]), torch.from_numpy(z1),
                        torch.from_numpy(z2))
    for a, w in zip(got, want):
        assert tuple(a.shape) == (B, HW, HW, 1) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_decode_bf16_matches_jax():
    jcfg, jm, params, cfg, _, x = _pair("gray", compute_dtype="bfloat16")
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    z1, z2 = _latents(B, 3)
    want = jm.apply({"params": params}, jnp.asarray(x[:B]), jnp.asarray(z1),
                    jnp.asarray(z2), method="decode")
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(x[:B]), torch.from_numpy(z1),
                        torch.from_numpy(z2))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32
        assert float(np.abs(a.numpy() - w).max()) <= BF16_REL * float(
            np.abs(w).max())


def test_decoder_is_causal():
    """Pixel i's likelihood params depend on no pixel at or after i in
    raster order ('A' blocks the centre), and do depend on earlier ones."""
    _, _, _, _, tm, x = _pair("gray")
    z1, z2 = (torch.from_numpy(a) for a in _latents(4, 4))
    r, c = 7, 5
    x1 = torch.from_numpy(x[:4])
    x2 = x1.clone()
    x2[:, r, c, 0] = 1.0 - x2[:, r, c, 0]
    with torch.no_grad():
        a = tm.decode(x1, z1, z2)[0].reshape(4, -1)
        b = tm.decode(x2, z1, z2)[0].reshape(4, -1)
    i = r * HW + c
    assert torch.equal(a[:, :i + 1], b[:, :i + 1])
    assert not torch.allclose(a[:, i + 1:], b[:, i + 1:])


def test_masks_survive_the_layout():
    """'A' keeps the rows above and the taps left of the centre; 'B' the
    centre too; applied to the HWIO kernel, read as OIHW by F.conv2d."""
    _, _, _, _, tm, _ = _pair("binary")
    a = tm.pix_in.mask[..., 0, 0]
    want_a = torch.ones(5, 5)
    want_a[2, 2:] = 0
    want_a[3:] = 0
    assert torch.equal(a, want_a)
    b = tm.pix_layers_0.mask[..., 0, 0]
    assert torch.equal(b, torch.tensor([[1.0, 1, 1], [1, 1, 0], [0, 0, 0]]))


@pytest.mark.parametrize("input_type", ["binary", "gray"])
def test_forward_and_elbo_terms_match_jax(input_type):
    jcfg, jm, params, cfg, tm, x = _pair(input_type)
    *_, jeb, teb = _banks(x, jm, jcfg, params, tm, cfg)
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
    for got, want in zip(tout, jout):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), **TERM_TOL)
    np.testing.assert_allclose(tkl.numpy(), np.asarray(jkl), **TERM_TOL)


# ---------------------------------------------------------------------------
# the train step (exact prior), IWAE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("input_type", ["binary", "gray"])
def test_exact_train_step_gradients_match_jax(input_type):
    jcfg, jm, params, cfg, tm, x = _pair(input_type)
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


def _iwae_eps(k_chunk, rounds, rows):
    _, k_s = jax.random.split(k_chunk)
    e2, e1 = zip(*[_fwd_noise(jax.random.fold_in(k_s, i), rows)
                   for i in range(rounds)])
    return torch.stack(e2), torch.stack(e1)


@pytest.mark.parametrize("kernel", [False, True])
def test_iwae_fast_and_generic_match_jax(kernel):
    """The encode-once path (its decoder given the repeated x) and the
    generic path on the same noise, and both against JAX's chunk_nll (its
    ``decode_needs_x`` fast path)."""
    jcfg, jm, params, cfg, tm, x = _pair("gray")
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


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("input_type", ["binary", "gray"])
def test_samplers_match_jax(input_type):
    """Both samplers against JAX's, from the same z2 and JAX's draws."""
    jcfg, jm, params, cfg, tm, x = _pair(input_type)
    z2 = jax.random.normal(jax.random.PRNGKey(7), (B, Z2))
    key = jax.random.PRNGKey(9)
    eps1, u = _sampler_noise(key, B)
    tz2 = _t(z2)
    for method in ("generate_from_top", "generate_from_top_naive"):
        want = np.asarray(jm.apply({"params": params}, z2, key, method=method))
        got = getattr(tm, method)(tz2, eps=(eps1, u)).numpy()
        assert got.shape == (B, HW, HW, 1)
        if input_type == "binary":
            _differing_rows(got, want, u, tm, tz2, eps1)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("input_type,hw", [("binary", HW), ("gray", HW)])
def test_crop_sampler_equals_naive(input_type, hw):
    """Inside the port: the crop sampler on noise drawn from a seed (z1's,
    then every uniform) and the full-canvas oracle drawing from a generator
    of that seed give the same samples, at the image edges too (the crop's
    validity mask stands in for SAME padding)."""
    cfg = Config(model_name="pixelhvae_2level", prior="standard",
                 hidden_size=16, z1_size=Z1, z2_size=Z2,
                 input_size=(1, hw, hw), input_type=input_type,
                 pixelcnn_features=8, pixelcnn_layers=2)
    tm = create_model(cfg, device="cpu", seed=5)
    # biases off zero, so that a leak into the padding would show
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    z2 = torch.randn((3, Z2), generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    eps1 = torch.randn((3, Z1), generator=g)
    u = torch.rand((hw * hw, 3, 1), generator=g)
    crop = tm.generate_from_top(z2, eps=(eps1, u))
    naive = tm.generate_from_top_naive(
        z2, generator=torch.Generator().manual_seed(3))
    assert crop.shape == naive.shape == (3, hw, hw, 1)
    if input_type == "binary":
        _differing_rows(crop, naive, u, tm, z2, eps1)
    else:
        torch.testing.assert_close(crop, naive, atol=1e-5, rtol=0)


def test_sampler_checks_injected_uniforms():
    _, _, _, _, tm, _ = _pair("binary")
    with pytest.raises(ValueError, match="u must be"):
        tm.generate_from_top(torch.zeros(2, Z2),
                             eps=(torch.zeros(2, Z1), torch.zeros(3, 2, 1)))


def test_generate_x_matches_jax():
    """sampling.generate_x over the exemplar bank passes the sampler's
    noise pair through (JAX: split(key, 4) -> pick, _, z, dec)."""
    jcfg, jm, params, cfg, tm, x = _pair("binary")
    key = jax.random.PRNGKey(11)
    want = jsampling.generate_x(jm, params, jcfg, 3, key,
                                bank_images_raw=jnp.asarray(x), n_valid=20)
    k_pick, _, k_z, k_dec = jax.random.split(key, 4)
    eps1, u = _sampler_noise(k_dec, 3)
    got = sampling.generate_x(
        tm, cfg, 3, x, n_valid=20,
        idx=np.array(jax.random.randint(k_pick, (3,), 0, 20)),
        eps=np.array(jax.random.normal(k_z, (3, Z2))), eps1=(eps1, u))
    idx = np.array(jax.random.randint(k_pick, (3,), 0, 20))
    with torch.no_grad():
        mu = tm.encode_top_mean(torch.from_numpy(x[idx]))
        z2 = mu + torch.exp(0.5 * tm.get_prior_log_var()) * _t(
            jax.random.normal(k_z, (3, Z2)))
    _differing_rows(got, np.asarray(want), u, tm, z2, eps1)
