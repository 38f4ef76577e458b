"""Exemplar-guided augmentation (BASELINE Config 5), the sampling functions
it adds and the PNG grids, against the JAX package on the CPU at a small
size (hidden 16-32, z 4-8).

The same flax params go into both packages and the port is fed JAX's draws:
the augmentation's ``k_z, k_dec = split(key)`` (the top latent's noise,
then the two-level models' z1 noise), the forward's noise in
``reconstruct_x``, and a classifier step's ``k_bin, k_aug, k_mask =
split(key, 3)`` (binarization uniforms, augmentation, the replacement
mask's uniforms). Tolerances (fp32): samples and reconstructions rtol 1e-5
/ atol 1e-6; one classifier step's loss, gradients and Adam-updated params
rtol 1e-5 (atol 1e-7 for entries near 0); kNN indices and the grids'
pixels exactly.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.ops.preprocess import preprocess_batch as j_preprocess
from exemplar_vae_tpu.train import augment as jaug
from exemplar_vae_tpu.train import plots as jplots
from exemplar_vae_tpu.train import sampling as jsampling
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.data.loaders import load_dataset
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.train import plots, sampling
from exemplar_vae_tpu_torch.train.augment import (MLPClassifier,
                                                  load_experiment,
                                                  make_augment_fn,
                                                  make_classifier_step,
                                                  train_classifier)
from exemplar_vae_tpu_torch.train.trainer import Experiment
from exemplar_vae_tpu_torch.weights import params_from_flax

B, Z1, Z2 = 6, 4, 5
TOL = dict(rtol=1e-5, atol=1e-6)

MODELS = {
    "vae": dict(model_name="vae"),
    "vae_standard": dict(model_name="vae", prior="standard"),
    "hvae": dict(model_name="hvae_2level"),
}


def _pair(name, input_type="binary"):
    jcfg = JConfig(hidden_size=16, z1_size=Z1, z2_size=Z2,
                   input_size=(1, 10, 10), input_type=input_type,
                   dynamic_binarization=input_type == "binary",
                   prior_variance_init=0.6, **MODELS[name])
    jm = j_create_model(jcfg)
    x = _images(B, 1)
    key = jax.random.PRNGKey(0)
    params = jm.init(key, jnp.asarray(x[:2]), key)["params"]
    cfg = Config.from_json(jcfg.to_json())
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, cfg, tm


def _images(n, seed, hw=10):
    return np.random.default_rng(seed).random((n, hw, hw, 1)).astype(
        np.float32)


def _top(cfg):
    return cfg.z1_size if cfg.model_name == "vae" else cfg.z2_size


def _aug_noise(key, cfg, n):
    """JAX augment's draws: split(key) -> (k_z, k_dec)."""
    k_z, k_dec = jax.random.split(key)
    eps = np.array(jax.random.normal(k_z, (n, _top(cfg))))
    eps1 = (np.array(jax.random.normal(k_dec, (n, Z1)))
            if cfg.model_name != "vae" else None)
    return eps, eps1


@pytest.mark.parametrize("name", list(MODELS))
def test_augment_fn_matches_jax(name):
    jcfg, jm, params, cfg, tm = _pair(name)
    x = (_images(B, 2) < 0.4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jaug.make_augment_fn(jm, params, jcfg)(
        key, jnp.asarray(x)))
    eps, eps1 = _aug_noise(key, cfg, B)
    got = make_augment_fn(tm, cfg)(torch.from_numpy(x), eps=eps, eps1=eps1)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # conditioned on different inputs -> different samples
    assert not np.allclose(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("name", ["vae", "hvae"])
def test_reconstruct_x_matches_jax(name):
    jcfg, jm, params, cfg, tm = _pair(name)
    x = _images(B, 4)
    key = jax.random.PRNGKey(5)
    want_x, want_mean = jsampling.reconstruct_x(jm, params, jcfg, key,
                                                jnp.asarray(x))
    _, k_f = jax.random.split(key)
    if name == "vae":
        eps = np.array(jax.random.normal(k_f, (B, Z1)))
    else:
        k2, k1 = jax.random.split(k_f)
        eps = (np.array(jax.random.normal(k2, (B, Z2))),
               np.array(jax.random.normal(k1, (B, Z1))))
    got_x, got_mean = sampling.reconstruct_x(tm, cfg, x, eps=eps)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), **TOL)


@pytest.mark.parametrize("name", ["vae", "hvae"])
def test_latent_neighbors_matches_jax(name):
    jcfg, jm, params, cfg, tm = _pair(name, input_type="gray")
    bank = _images(40, 6)
    queries = _images(5, 7)
    cache = np.array(jm.apply({"params": params}, jnp.asarray(bank),
                              method="encode_top_mean"))
    valid = np.ones(40, bool)
    valid[[3, 17, 28]] = False
    want_idx, want_imgs = jsampling.latent_neighbors(
        jm, params, jcfg, jnp.asarray(queries), jnp.asarray(bank),
        jnp.asarray(cache), 4, jax.random.PRNGKey(0),
        valid=jnp.asarray(valid))
    got_idx, got_imgs = sampling.latent_neighbors(tm, cfg, queries, bank,
                                                  cache, 4, valid=valid)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_imgs.numpy(), np.asarray(want_imgs))
    assert not np.isin(got_idx.numpy(), [3, 17, 28]).any()


@pytest.mark.parametrize("augment", [False, True])
def test_classifier_step_matches_jax(augment):
    """One classifier step, JAX's MLPClassifier and optax.adam against the
    port's step with JAX's draws: loss, gradients, updated params."""
    jcfg, jm, vae_params, cfg, tm = _pair("vae")
    x_raw = _images(B, 8)
    y = np.arange(B) % 3
    clf = jaug.MLPClassifier(n_classes=3, hidden=32)
    key = jax.random.PRNGKey(11)
    cparams = clf.init(key, jnp.zeros((2, 10, 10, 1)))["params"]
    tx = optax.adam(1e-3)
    pi = 0.5
    k_bin, k_aug, k_mask = jax.random.split(jax.random.PRNGKey(12), 3)
    x = j_preprocess(k_bin, jnp.asarray(x_raw), input_type="binary",
                     dynamic_binarization=True, train=True)
    if augment:
        x_gen = jaug.make_augment_fn(jm, vae_params, jcfg)(k_aug, x)
        mask = jax.random.bernoulli(k_mask, pi, (B,))
        x = jnp.where(mask[:, None, None, None], x_gen, x)

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            clf.apply({"params": p}, x), jnp.asarray(y)).mean()

    loss, grads = jax.value_and_grad(loss_fn)(cparams)
    updates, _ = tx.update(grads, tx.init(cparams), cparams)
    want_params = params_from_flax(jax.tree.map(
        np.asarray, optax.apply_updates(cparams, updates)))
    want_grads = params_from_flax(jax.tree.map(np.asarray, grads))

    tclf = MLPClassifier(100, 3, hidden=32)
    tclf.load_state_dict(params_from_flax(jax.tree.map(np.asarray, cparams)))
    opt = torch.optim.Adam(tclf.parameters(), lr=1e-3)
    step = make_classifier_step(
        tclf, opt, cfg, make_augment_fn(tm, cfg) if augment else None, pi)
    eps, _ = _aug_noise(k_aug, cfg, B)
    got = step(torch.from_numpy(x_raw), torch.from_numpy(y),
               u=torch.from_numpy(np.array(jax.random.uniform(
                   k_bin, x_raw.shape))),
               eps=eps,
               u_mask=np.array(jax.random.uniform(k_mask, (B,))))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    for n, p in tclf.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[n].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_mlp_classifier_init_is_flax_lecun():
    """Names and (in, out) layout of flax's MLPClassifier, LeCun-normal
    kernels (std 1/sqrt(fan_in), truncated), zero biases."""
    clf = MLPClassifier(784, 10, hidden=512,
                        generator=torch.Generator().manual_seed(0))
    flax_p = jaug.MLPClassifier(n_classes=10, hidden=512).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    want = params_from_flax(jax.tree.map(np.asarray, flax_p))
    got = dict(clf.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k in got:
        if k.endswith("bias"):
            assert not got[k].any()
        else:
            fan_in = got[k].shape[0]
            assert float(got[k].detach().std()) == pytest.approx(fan_in ** -0.5,
                                                        rel=0.05)
    assert clf(torch.zeros(4, 28, 28, 1)).shape == (4, 10)


@pytest.fixture(scope="module")
def vae_setup():
    cfg = Config(dataset_name="synthetic", model_name="vae",
                 prior="exemplar_prior", hidden_size=32, z1_size=8,
                 training_set_size=256, val_set_size=64, test_set_size=128)
    splits, cfg = load_dataset(cfg)
    return cfg, create_model(cfg, device="cpu", seed=0), splits


def test_classifier_learns_with_and_without_augmentation(vae_setup):
    cfg, m, splits = vae_setup
    r_plain = train_classifier(m, cfg, splits, epochs=8, augment=False,
                               seed=1)
    assert r_plain.test_error < 0.5          # 10 classes, chance 0.9
    r_aug = train_classifier(m, cfg, splits, epochs=8, pi=0.3, augment=True,
                             seed=1)
    assert r_aug.test_error < 0.7
    assert np.isfinite(r_aug.history).all() and len(r_aug.history) == 8


def test_classifier_label_budget_subsamples(vae_setup):
    cfg, m, splits = vae_setup
    r = train_classifier(m, cfg, splits, epochs=4, augment=False,
                         label_budget=50, batch_size=100, seed=3)
    assert np.isfinite(r.test_error) and len(r.history) == 4


def test_classifier_requires_labels(vae_setup):
    cfg, m, splits = vae_setup
    with pytest.raises(ValueError, match="no labels"):
        train_classifier(m, cfg, splits._replace(train_labels=None))


def _trained_dir(tmp_path, **kw):
    cfg = Config(**dict(dict(
        dataset_name="synthetic", model_name="vae", prior="standard",
        hidden_size=16, z1_size=4, training_set_size=64, val_set_size=16,
        test_set_size=16, batch_size=16, epochs=1,
        snapshot_dir=str(tmp_path / "snap")), **kw))
    exp = Experiment(cfg, device="cpu", verbose=False)
    exp.train_epoch()
    exp.save_checkpoint("final")
    return exp


def test_load_experiment_moved_dir_and_missing_checkpoint(tmp_path):
    """load_experiment restores from the directory given (a moved run
    directory keeps working though config.json's snapshot_dir went stale)
    and raises rather than hand back untrained params when there is no
    checkpoint."""
    exp = _trained_dir(tmp_path)
    moved = str(tmp_path / "elsewhere" / "run")
    shutil.move(exp.exp_dir, moved)
    got = load_experiment(moved, device="cpu")
    assert got.epoch == 1 and got.exp_dir == moved
    for (name, a), b in zip(exp.model.named_parameters(),
                            got.model.parameters()):
        assert torch.equal(a, b), name

    bare = tmp_path / "bare"
    os.makedirs(bare)
    with open(bare / "config.json", "w") as f:
        f.write(exp.cfg.to_json())
    with pytest.raises(FileNotFoundError, match="untrained"):
        load_experiment(str(bare), device="cpu")


def test_classify_mnist_cli_on_the_cpu(tmp_path, capsys):
    from exemplar_vae_tpu_torch.classify_mnist import main
    exp = _trained_dir(tmp_path, prior="exemplar_prior",
                       number_components=64)
    results = main(["--no_cuda", "--vae_dir", exp.exp_dir,
                    "--classifier_epochs", "2", "--pi", "0.5",
                    "--batch_size", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == results
    with open(os.path.join(exp.exp_dir, "classifier_results.json")) as f:
        assert json.load(f) == results
    for name in ("plain", "exemplar_augmented"):
        assert 0.0 <= results[name]["test_error"] <= 1.0
    with pytest.raises(SystemExit, match="--vae_dir or --train_first"):
        main(["--no_cuda"])


# ---------------------------------------------------------------------------
# PNG grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels,ncol", [(1, None), (3, 4), (1, 5)])
def test_png_grid_decodes_to_the_pixels_pil_reads(tmp_path, channels, ncol):
    """The port's standard-library PNG and the JAX package's PIL-written one
    decode (by PIL) to the same pixels; read_png reads the port's file as
    PIL does; make_grid is the JAX package's."""
    Image = pytest.importorskip("PIL.Image")
    imgs = np.random.default_rng(channels).random(
        (7, 6, 5, channels)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(plots.make_grid(imgs, ncol),
                                  jplots.make_grid(imgs, ncol))
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    plots.save_grid(imgs, ours, ncol=ncol)
    jplots.save_grid(imgs, theirs, ncol=ncol)
    with Image.open(ours) as a, Image.open(theirs) as b:
        assert a.mode == b.mode == ("L" if channels == 1 else "RGB")
        pa, pb = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(plots.read_png(ours).reshape(pa.shape), pa)


def test_png_writer_refuses_other_channel_counts(tmp_path):
    with pytest.raises(ValueError, match="1 or 3 channels"):
        plots.save_grid(np.zeros((2, 4, 4, 2)), str(tmp_path / "x.png"))
    (tmp_path / "bad.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        plots.read_png(str(tmp_path / "bad.png"))
