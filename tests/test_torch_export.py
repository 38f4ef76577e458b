"""serve.export_serving_bundle and the export CLI: a bundle the port writes.

* Round trip: export, then ServingBundle.load of the same directory on the
  CPU reproduces the live serving functions bitwise (the same weights, the
  same code, the same injected noise) for the VAE, HVAE, ConvHVAE and
  PixelHVAE, on binary 12x12 and continuous 8x8x3 raw uint8 input.
* Layout: arrays.npz keys and values and the manifest's shared fields equal
  a JAX ``export_serving_bundle`` of the same weights and eval bank
  (``platforms=("cpu",)``, ``use_pallas_prior=False``); the port's manifest
  names its writer and lists its torch.export programs and the device type
  they were exported on (none for the PixelHVAE, whose bundle has no
  programs), and the JAX loader, which needs its own compiled programs,
  refuses it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.serve import ServingBundle as JBundle
from exemplar_vae_tpu.serve import export_serving_bundle as j_export
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.serve import (PROGRAMS, ServingBundle,
                                          export_serving_bundle,
                                          make_serving_fns)
from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.weights import params_from_flax

N, Z1, Z2 = 20, 4, 6
ARCHS = {
    "vae": {},
    "hvae_2level": {},
    "convhvae_2level": dict(conv_enc_spec="4k3s1,4k3s2",
                            conv_dec_spec="t4k3s2,c4k3s1",
                            conv_proj_channels=4),
    "pixelhvae_2level": dict(pixelcnn_features=8, pixelcnn_layers=1),
}
INPUTS = {"binary": (1, 12, 12), "continuous": (3, 8, 8)}
SIZES = dict(n_gen=3, ref_batch=2, score_chunk=4, s_total=6, r=3)
ROUNDS = 2


def _cfg(name, input_type, prior="exemplar_prior"):
    return Config(model_name=name, prior=prior, input_type=input_type,
                  input_size=INPUTS[input_type], dynamic_binarization=False,
                  hidden_size=16, z1_size=Z1, z2_size=Z2, number_components=N,
                  **ARCHS[name])


def _images(n, input_type, seed):
    c, h, w = INPUTS[input_type]
    rng = np.random.default_rng(seed)
    if input_type == "continuous":
        return rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    return (rng.random((n, h, w, c)) < 0.4).astype(np.float32)


def _eval_bank(model, cfg, bank_x):
    return make_eval_bank_fn(model, cfg)(Bank(
        images=bank_x, data_idx=np.arange(N, dtype=np.int32),
        valid=np.ones(N, bool), cache_means=None, n_effective=N))


def _noise(cfg, b, seed):
    """(eps of the top latent, eps1 as the model's generate_from_top takes
    it) for ``b`` rows."""
    g = torch.Generator().manual_seed(seed)
    top = Z1 if cfg.model_name == "vae" else Z2
    eps = torch.randn((b, top), generator=g)
    if cfg.model_name == "vae":
        return eps, None
    eps1 = torch.randn((b, Z1), generator=g)
    if cfg.model_name != "pixelhvae_2level":
        return eps, eps1
    c, h, w = cfg.input_size
    u = (torch.rand((h * w, b, c), generator=g)
         if cfg.input_type == "binary" else None)
    return eps, (eps1, u)


def _iwae_noise(cfg, t, seed):
    g = torch.Generator().manual_seed(seed)
    rows = t * SIZES["r"]
    if cfg.model_name == "vae":
        return torch.randn((ROUNDS, rows, Z1), generator=g)
    return (torch.randn((ROUNDS, rows, Z2), generator=g),
            torch.randn((ROUNDS, rows, Z1), generator=g))


@pytest.mark.parametrize("input_type", list(INPUTS))
@pytest.mark.parametrize("name", list(ARCHS))
def test_export_load_reproduces_live_serving(name, input_type, tmp_path):
    cfg = _cfg(name, input_type)
    model = create_model(cfg, device="cpu", seed=3).eval()
    bank_x = _images(N, input_type, 1)
    eb = _eval_bank(model, cfg, bank_x)
    manifest = export_serving_bundle(
        model, cfg, str(tmp_path), bank_means=eb.cache_means,
        data_idx=eb.data_idx, valid=eb.valid, n_effective=N, **SIZES)
    assert manifest == json.loads((tmp_path / "bundle.json").read_text())
    programs = name != "pixelhvae_2level"
    assert manifest["platforms"] == (["cpu"] if programs else [])
    assert manifest["programs"] == ([f"{p}.pt2" for p in PROGRAMS]
                                    if programs else [])
    assert manifest["rounds"] == ROUNDS
    assert manifest["x_dtype"] == ("uint8" if input_type == "continuous"
                                   else "float32")
    b = ServingBundle.load(str(tmp_path), device="cpu")
    assert b.cfg == cfg
    gen, ref, score = make_serving_fns(model, cfg, N, SIZES["n_gen"], ROUNDS,
                                       SIZES["r"])
    x = _images(4, input_type, 2)
    e = _iwae_noise(cfg, 4, 4)
    want = score(x, eb.cache_means, eb.data_idx, eb.valid, eps=e).numpy()
    mean, per = b.score_nll(x, eps=[e])
    assert np.array_equal(per, want) and mean == float(want.mean())
    idx = np.array([0, 7, 19])
    eps, eps1 = _noise(cfg, 3, 5)
    assert torch.equal(b.generate(idx=idx, eps=eps, eps1=eps1),
                       gen(eb.cache_means, idx=idx, eps=eps, eps1=eps1))
    eps, eps1 = _noise(cfg, 2, 6)
    assert torch.equal(b.reference_generate(x[:2], eps=eps, eps1=eps1),
                       ref(x[:2], eps=eps, eps1=eps1))


def test_export_without_a_bank(tmp_path):
    """A standard-prior bundle has no bank arrays and n_effective 0; an
    exemplar-prior export without its eval bank raises."""
    cfg = _cfg("hvae_2level", "binary", prior="standard")
    model = create_model(cfg, device="cpu", seed=3).eval()
    manifest = export_serving_bundle(model, cfg, str(tmp_path), **SIZES)
    assert manifest["n_effective"] == 0
    with np.load(tmp_path / "arrays.npz") as data:
        assert all(k.startswith("param:") for k in data.files)
    b = ServingBundle.load(str(tmp_path), device="cpu")
    _, _, score = make_serving_fns(model, cfg, 0, 3, ROUNDS, SIZES["r"])
    x = _images(4, "binary", 2)
    e = _iwae_noise(cfg, 4, 4)
    assert np.array_equal(b.score_nll(x, eps=[e])[1], score(x, eps=e).numpy())
    with pytest.raises(ValueError, match="eval bank"):
        export_serving_bundle(create_model(_cfg("vae", "binary"), device="cpu"),
                              _cfg("vae", "binary"), str(tmp_path / "x"))


@pytest.mark.parametrize("name", ["vae", "pixelhvae_2level"])
def test_export_layout_matches_jax(name, tmp_path):
    jcfg = JConfig(model_name=name, input_size=(1, 12, 12),
                   input_type="binary", dynamic_binarization=False,
                   hidden_size=16, z1_size=Z1, z2_size=Z2,
                   number_components=N, use_pallas_prior=False, **ARCHS[name])
    jm = j_create_model(jcfg)
    bank_x = _images(N, "binary", 1)
    key = jax.random.PRNGKey(0)
    params = jm.init(key, jnp.asarray(bank_x[:2]), key)["params"]
    cfg = Config.from_json(jcfg.to_json())
    model = create_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    eb = _eval_bank(model, cfg, bank_x)
    bank = dict(bank_means=eb.cache_means.numpy(), data_idx=eb.data_idx.numpy(),
                valid=eb.valid.numpy(), n_effective=N)
    want = j_export(jm, jcfg, params, str(tmp_path / "jax"),
                    platforms=("cpu",), **bank, **SIZES)
    got = export_serving_bundle(model, cfg, str(tmp_path / "port"), **bank,
                                **SIZES)
    programs = name != "pixelhvae_2level"
    assert got.pop("platforms") == (["cpu"] if programs else [])
    assert want.pop("platforms") == ["cpu"]
    assert got.pop("programs") == ([f"{p}.pt2" for p in PROGRAMS]
                                   if programs else [])
    assert got.pop("exported_by") == "exemplar_vae_tpu_torch"
    assert got == want
    with np.load(tmp_path / "jax" / "arrays.npz") as j, \
            np.load(tmp_path / "port" / "arrays.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="generate.bin"):
        JBundle.load(str(tmp_path / "port"))


def test_export_cli_on_cpu(tmp_path, capsys):
    """python -m exemplar_vae_tpu_torch.export_serving --no_cuda on a run
    directory: the best params and the eval bank, loaded back and scored."""
    from exemplar_vae_tpu_torch.export_serving import main as export
    from exemplar_vae_tpu_torch.main import main as train
    train(["--no_cuda", "--dataset_name", "synthetic", "--training_set_size",
           "64", "--number_components", "64", "--val_set_size", "16",
           "--test_set_size", "8", "--batch_size", "32", "--epochs", "1",
           "--warmup", "1", "--S", "4", "--MB", "2", "--hidden_size", "16",
           "--z1_size", "4", "--snapshot_dir", str(tmp_path)])
    (run,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    manifest = export(["--vae_dir", str(run), "--no_cuda", "--S", "8",
                       "--MB", "4", "--score_chunk", "8"])
    assert "exported serving bundle" in capsys.readouterr().out
    assert (manifest["n_effective"], manifest["rounds"], manifest["r"]) == (
        64, 2, 4)
    b = ServingBundle.load(str(run / "serving"), device="cpu")
    _, per = b.score_nll(np.random.default_rng(0).random((10, 28, 28, 1)) < 0.3,
                         generator=torch.Generator().manual_seed(0))
    assert per.shape == (10,) and np.isfinite(per).all()
