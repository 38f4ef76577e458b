"""Port vs JAX and port behaviour: the dataset readers, the CLI parser and
the Experiment, on the CPU at a small size.

* ``load_dataset`` gives bit-identical splits and the same Config as the
  JAX package, for the synthetic sets and for small files of every format
  that the tests write themselves.
* The CLI parser gives the same Config as the JAX package's for the same
  argv; ``--no_cuda`` runs the port on the CPU.
* The Experiment mirrors tests/test_training.py: beta schedule, log
  denominator, ELBO improvement, metrics files, early stopping, same-seed
  reproduction, validation determinism, a batch larger than the dataset
  failing loudly; the options and models that later slices bring raise and
  name them.
* The run's lifecycle: the artifacts (PNG grids) and a recorded artifact
  error, profile_epoch's trace (tests/test_profiling.py), debug_nans, and
  the CLI's --checkpoint_every, --resume and --eval_only on the CPU.
"""

import dataclasses
import gzip
import json
import os
import struct

import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.config import config_from_args as j_config_from_args
from exemplar_vae_tpu.config import reference_arg_parser as j_parser
from exemplar_vae_tpu.data.loaders import load_dataset as j_load_dataset
from exemplar_vae_tpu_torch.config import (Config, config_from_args,
                                           reference_arg_parser)
from exemplar_vae_tpu_torch.data.loaders import load_dataset
from exemplar_vae_tpu_torch.train.loss import Bank, bank_log_denom
from exemplar_vae_tpu_torch.train.trainer import Experiment, beta_schedule

# ---------------------------------------------------------------------------
# load_dataset
# ---------------------------------------------------------------------------


def _assert_same_splits(jcfg):
    want, wcfg = j_load_dataset(jcfg)
    got, gcfg = load_dataset(Config.from_json(jcfg.to_json()))
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)
    assert got.source == want.source
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field == "source":
            continue
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    return got


@pytest.mark.parametrize("name", ["synthetic", "synthetic_gray",
                                  "synthetic_continuous", "dynamic_mnist",
                                  "static_mnist"])
def test_load_dataset_synthetic_is_bit_identical(name, tmp_path):
    """No files under data_dir: the synthetic fallback of each dataset."""
    ds = _assert_same_splits(JConfig(
        dataset_name=name, data_dir=str(tmp_path), training_set_size=40,
        val_set_size=12, test_set_size=9))
    assert ds.source == "synthetic"


def _write_idx(path, arr, gz=False):
    arr = np.asarray(arr, np.uint8)
    head = struct.pack(">I", 0x800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("fmt", ["idx", "idx_gz", "fashion_subdir", "amat",
                                 "omniglot", "celeba", "npz"])
def test_load_dataset_readers_match_jax(fmt, tmp_path):
    rng = np.random.default_rng(0)
    kw = dict(data_dir=str(tmp_path), val_set_size=10, test_set_size=8)
    if fmt in ("idx", "idx_gz", "fashion_subdir"):
        gz = fmt == "idx_gz"
        name = "fashion_mnist" if fmt == "fashion_subdir" else "dynamic_mnist"
        d = tmp_path / name if fmt == "fashion_subdir" else tmp_path
        d.mkdir(exist_ok=True)
        sfx = ".gz" if gz else ""
        _write_idx(d / f"train-images-idx3-ubyte{sfx}",
                   rng.integers(0, 256, (30, 28, 28)), gz)
        _write_idx(d / f"train-labels-idx1-ubyte{sfx}",
                   rng.integers(0, 10, (30,)), gz)
        _write_idx(d / f"t10k-images-idx3-ubyte{sfx}",
                   rng.integers(0, 256, (8, 28, 28)), gz)
        kw["dataset_name"] = name
    elif fmt == "amat":
        for s, n in (("train", 12), ("valid", 5), ("test", 4)):
            np.savetxt(tmp_path / f"binarized_mnist_{s}.amat",
                       rng.integers(0, 2, (n, 784)), fmt="%d")
        kw["dataset_name"] = "static_mnist"
    elif fmt == "omniglot":
        from scipy import io as scipy_io
        scipy_io.savemat(tmp_path / "chardata.mat",
                         {"data": rng.random((784, 40)).astype(np.float32),
                          "testdata": rng.random((784, 8)).astype(np.float32)})
        kw["dataset_name"] = "omniglot"
    elif fmt == "celeba":
        for s, n in (("train", 6), ("valid", 3), ("test", 2)):
            np.savez(tmp_path / f"celeba_{s}.npz",
                     x=rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8))
        kw["dataset_name"] = "celeba"
    else:
        np.savez(tmp_path / "synthetic_gray.npz",
                 train_x=rng.random((9, 28, 28, 1)).astype(np.float32),
                 val_x=rng.random((4, 28, 28, 1)).astype(np.float32),
                 test_x=rng.random((3, 28, 28, 1)).astype(np.float32),
                 train_labels=np.arange(9, dtype=np.int32))
        kw["dataset_name"] = "synthetic_gray"
    ds = _assert_same_splits(JConfig(**kw))
    assert ds.source == "real"


def test_load_dataset_rejects_val_eating_train(tmp_path):
    _write_idx(tmp_path / "train-images-idx3-ubyte", np.zeros((5, 28, 28)))
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", np.zeros((2, 28, 28)))
    with pytest.raises(ValueError, match="consumes the whole"):
        load_dataset(Config(data_dir=str(tmp_path), val_set_size=5))


# ---------------------------------------------------------------------------
# the CLI parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset_name", "synthetic", "--model_name", "VAE", "--prior",
     "vampprior", "--number_components", "500", "--z1_size", "20",
     "--hidden_size", "64", "--batch_size", "50", "--lr", "0.001",
     "--optimizer", "adam", "--epochs", "3", "--warmup", "0", "--S", "10",
     "--MB", "5", "--seed", "3", "--no_cuda", "--no_pallas",
     "--compute_dtype", "bfloat16", "--dynamic_binarization",
     "--val_set_size", "7", "--test_set_size", "9", "--training_set_size",
     "70", "--snapshot_dir", "snaps", "--data_dir", "dd"],
    ["--approximate_prior", "--approximate_k", "5", "--approximate_support",
     "batch_union", "--prior_variance", "0.5", "--prior_var_min", "0.01",
     "--q_logvar_min", "-4", "--no_mask", "--use_training_data_init",
     "--mesh", "2,2", "--checkpoint_every", "2", "--checkpoint_backend",
     "orbax", "--resume", "--eval_only", "--epoch_splits", "2",
     "--approx_remat", "--debug_nans", "--profile_epoch", "1",
     "--conv_enc_spec", "8k3s1", "--conv_dec_spec", "c8k3s1",
     "--conv_proj_channels", "4", "--pixelcnn_features", "8",
     "--pixelcnn_layers", "2", "--test_batch_size", "11",
     "--early_stopping_epochs", "4", "--z2_size", "6"],
])
def test_cli_config_matches_jax(argv):
    got = config_from_args(reference_arg_parser().parse_args(argv))
    want = j_config_from_args(j_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.experiment_name() == want.experiment_name()


def test_cli_no_cuda_flag():
    assert reference_arg_parser().parse_args(["--no_cuda"]).no_cuda
    assert not reference_arg_parser().parse_args([]).no_cuda


# ---------------------------------------------------------------------------
# the Experiment
# ---------------------------------------------------------------------------


def _base(tmp_path, **kw):
    d = dict(dataset_name="synthetic", training_set_size=256, val_set_size=64,
             test_set_size=32, number_components=256, batch_size=64, warmup=2,
             epochs=3, S=2, MB=2, test_batch_size=32, use_pallas_prior=True,
             prior_block_n=64, exact_reencode_chunk=64, hidden_size=32,
             z1_size=8, z2_size=8, snapshot_dir=str(tmp_path))
    d.update(kw)
    return Config(**d)


def _exp(cfg):
    return Experiment(cfg, device="cpu", verbose=False)


def test_beta_schedule():
    assert beta_schedule(1, 100) == 0.01
    assert beta_schedule(100, 100) == 1.0
    assert beta_schedule(500, 100) == 1.0
    assert beta_schedule(3, 0) == 1.0


def test_log_denom_loo_vs_eval():
    bank = Bank(None, None, None, None, 100)
    cfg = Config(prior="exemplar_prior")
    assert bank_log_denom(cfg, bank, train=True) == pytest.approx(np.log(99.0))
    assert bank_log_denom(cfg, bank, train=False) == pytest.approx(
        np.log(100.0))
    assert bank_log_denom(Config(no_mask=True), bank,
                          train=True) == pytest.approx(np.log(100.0))


def test_elbo_improves_over_epochs(tmp_path):
    exp = _exp(_base(tmp_path))
    ms = [exp.train_epoch() for _ in range(3)]
    assert ms[-1]["loss"] < ms[0]["loss"], ms
    assert all(np.isfinite(m["prior_log_var"]) for m in ms)
    assert exp.state.step == 3 * exp.steps_per_epoch


def test_bank_aliases_train_x(tmp_path):
    exp = _exp(_base(tmp_path, number_components=100))
    assert exp.bank.images.data_ptr() == exp.train_x.data_ptr()
    assert exp.bank.n_effective == 100
    assert torch.equal(exp.bank.data_idx, torch.arange(100, dtype=torch.int32))


def test_metrics_jsonl_and_results_written(tmp_path):
    exp = _exp(_base(tmp_path, epochs=1))
    results = exp.run(max_epochs=1)
    lines = [json.loads(line) for line in open(exp._metrics_path)]
    assert any("val_loss" in line for line in lines)
    assert any("final_test_nll" in line for line in lines)
    with open(os.path.join(exp.exp_dir, "results.json")) as f:
        on_disk = json.load(f)
    assert on_disk == results and np.isfinite(results["test_nll"])
    with open(os.path.join(exp.exp_dir, "config.json")) as f:
        assert Config.from_json(f.read()) == exp.cfg
    # best_val_loss is the validation loss of the best params, as tracked
    assert results["best_val_loss"] == pytest.approx(exp.best_val, rel=1e-6)


def test_early_stopping_stops(tmp_path):
    cfg = _base(tmp_path, epochs=50, warmup=0, early_stopping_epochs=2,
                prior="standard", lr=0.0)    # lr=0: val loss never improves
    exp = _exp(cfg)
    exp.run()
    assert exp.epoch <= 5


def test_non_finite_loss_aborts_and_keeps_best(tmp_path):
    exp = _exp(_base(tmp_path, epochs=4))
    exp.run(max_epochs=1)
    best = {k: v.clone() for k, v in exp.best_params.items()}
    with torch.no_grad():
        exp.model.q_mean_head.kernel.fill_(float("nan"))
    exp.run(max_epochs=3)
    assert exp.epoch == 2
    lines = [json.loads(line) for line in open(exp._metrics_path)]
    assert any(line.get("aborted_non_finite") for line in lines)
    for k, v in exp.best_params.items():
        assert torch.equal(v, best[k]), k


def test_reproducible_same_seed(tmp_path):
    cfg = _base(tmp_path, epochs=1)
    ma = _exp(cfg).train_epoch()
    mb = _exp(cfg).train_epoch()
    assert ma["loss"] == mb["loss"]
    mc = _exp(cfg.replace(seed=15)).train_epoch()
    assert mc["loss"] != ma["loss"]


def test_validation_deterministic_given_params(tmp_path):
    exp = _exp(_base(tmp_path))
    exp.train_epoch()
    a = exp.validate()
    exp.epoch += 5       # the epoch counter must not influence evaluation
    exp.train_x.add_(0)  # nor anything but the params
    b = exp.validate()
    assert a == b, (a, b)


def test_batch_larger_than_dataset_fails_loudly(tmp_path):
    with pytest.raises(ValueError, match="zero steps per epoch"):
        _exp(_base(tmp_path, training_set_size=8, batch_size=32))


def test_vamp_use_training_data_init(tmp_path):
    exp = _exp(_base(tmp_path, prior="vampprior", number_components=16,
                     use_training_data_init=True))
    np.testing.assert_allclose(exp.model.pseudo_inputs.detach().numpy(),
                               exp.splits.train_x[:16], atol=1e-6)
    assert np.isfinite(exp.train_epoch()["loss"])


@pytest.mark.parametrize("kw,exc,match", [
    # the mesh (item 11) is ported: without a process group a mesh of 2
    # raises and names torchrun, and never runs on one process
    pytest.param(dict(mesh_shape=(2,)), RuntimeError, "torchrun",
                 id="kw1-item 11"),
    pytest.param(dict(checkpoint_backend="orbax"), NotImplementedError,
                 "Queue 3", id="kw2-Queue 3"),
])
def test_later_slices_raise_and_name_their_item(tmp_path, kw, exc, match,
                                                monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(exc, match=match):
        _exp(_base(tmp_path, **kw))


def test_main_cli_trains_on_the_cpu(tmp_path, capsys):
    from exemplar_vae_tpu_torch.main import main
    results = main(["--no_cuda", "--dataset_name", "synthetic",
                    "--training_set_size", "96", "--number_components", "96",
                    "--val_set_size", "32", "--test_set_size", "32",
                    "--batch_size", "32", "--epochs", "2", "--warmup", "1",
                    "--S", "4", "--MB", "2", "--hidden_size", "16",
                    "--z1_size", "4", "--test_batch_size", "16",
                    "--snapshot_dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == results
    assert results["epochs_trained"] == 2 and np.isfinite(results["test_nll"])
    assert "device=cpu" in "\n".join(out)


# ---------------------------------------------------------------------------
# the run's lifecycle: artifacts, profiling, NaN detection, the CLI
# ---------------------------------------------------------------------------


def test_fold_seed_is_stable_and_separates_epochs():
    from exemplar_vae_tpu_torch.train.trainer import fold_seed
    seeds = {fold_seed(s, e) for s in (0, 14, 15) for e in range(50)}
    assert len(seeds) == 150
    assert all(0 <= x < 2 ** 63 for x in seeds)
    assert fold_seed(14, 3) == fold_seed(14, 3)


def test_final_evaluation_writes_the_artifacts(tmp_path):
    from exemplar_vae_tpu_torch.train.plots import read_png
    exp = _exp(_base(tmp_path, epochs=1))
    results = exp.run(max_epochs=1)
    assert "artifact_error" not in results
    # 5x5 grids of 28x28 with 2-pixel separators; 5 columns of 5 rows
    side = 5 * 30 + 2
    for name in ("reconstructions.png", "real.png", "generations.png",
                 "exemplar_neighborhoods.png", "latent_knn_retrieval.png"):
        img = read_png(os.path.join(exp.exp_dir, name))
        assert img.shape == (side, side, 1), name
        assert img.max() > img.min(), name


def test_artifact_error_is_recorded_not_raised(tmp_path, monkeypatch):
    exp = _exp(_base(tmp_path, epochs=1, prior="standard"))

    def broken(eval_bank):
        raise OSError("disk full")

    monkeypatch.setattr(exp, "save_artifacts", broken)
    results = exp.run(max_epochs=1)
    assert results["artifact_error"] == "OSError: disk full"
    with open(os.path.join(exp.exp_dir, "results.json")) as f:
        assert json.load(f) == results


def test_trace_writes_a_chrome_trace(tmp_path):
    from exemplar_vae_tpu_torch.train.profiling import trace
    d = tmp_path / "prof"
    with trace(str(d)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(d / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_nan_debug_raises_in_the_backward_then_restores():
    from exemplar_vae_tpu_torch.train.profiling import nan_debug
    x = torch.tensor([-1.0], requires_grad=True)
    with nan_debug(True):
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()          # back to silent NaN
    assert torch.isnan(x.grad).all()


def test_profile_epoch_writes_trace(tmp_path):
    exp = _exp(_base(tmp_path, training_set_size=128, number_components=128,
                     batch_size=32, profile_epoch=2))
    exp.train_epoch()
    assert not os.path.exists(os.path.join(exp.exp_dir, "profile"))
    exp.train_epoch()
    assert os.path.isfile(os.path.join(exp.exp_dir, "profile", "trace.json"))


def test_debug_nans_stops_the_step_at_the_backward(tmp_path):
    """With debug_nans a NaN weight raises in the first backward; without,
    the epoch finishes with a NaN loss (and the run aborts on it)."""
    for debug in (True, False):
        exp = _exp(_base(tmp_path / str(debug), debug_nans=debug))
        with torch.no_grad():
            exp.model.q_mean_head.kernel.fill_(float("nan"))
        if debug:
            with pytest.raises(RuntimeError, match="nan"):
                exp.train_epoch()
        else:
            assert not np.isfinite(exp.train_epoch()["loss"])
    assert not torch.is_anomaly_enabled()


def _cli(tmp_path, *extra):
    from exemplar_vae_tpu_torch.main import main
    return main(["--no_cuda", "--dataset_name", "synthetic",
                 "--training_set_size", "96", "--number_components", "96",
                 "--val_set_size", "32", "--test_set_size", "32",
                 "--batch_size", "32", "--warmup", "1", "--S", "4", "--MB",
                 "2", "--hidden_size", "16", "--z1_size", "4",
                 "--test_batch_size", "16", "--snapshot_dir", str(tmp_path),
                 *extra])


def test_cli_checkpoint_resume_and_eval_only(tmp_path, capsys):
    """--checkpoint_every 1 leaves ckpt_last and the run ckpt_final;
    --resume trains on from the checkpoint's epoch and logs only the new
    epochs; --eval_only reproduces results.json's test_nll."""
    _cli(tmp_path, "--epochs", "1", "--checkpoint_every", "1")
    (exp_dir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    for tag in ("last", "final"):
        with open(exp_dir / f"ckpt_{tag}" / "meta.json") as f:
            assert json.load(f)["epoch"] == 1
    capsys.readouterr()
    results = _cli(tmp_path, "--epochs", "2", "--resume",
                   "--checkpoint_every", "1")
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert results["epochs_trained"] == 2
    with open(exp_dir / "metrics.jsonl") as f:
        epochs = [json.loads(line).get("epoch") for line in f]
    assert [e for e in epochs if e is not None] == [1, 2]
    with open(exp_dir / "results.json") as f:
        on_disk = json.load(f)
    again = _cli(tmp_path, "--eval_only")
    assert "eval_only: restored ckpt_final (epoch 2)" in capsys.readouterr().out
    assert again["test_nll"] == on_disk["test_nll"]
    assert again["best_val_loss"] == on_disk["best_val_loss"]


def test_cli_eval_only_and_resume_without_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit, match="no restorable checkpoint"):
        _cli(tmp_path, "--eval_only")
    results = _cli(tmp_path, "--epochs", "1", "--resume")
    assert "no checkpoint found" in capsys.readouterr().out
    assert results["epochs_trained"] == 1
