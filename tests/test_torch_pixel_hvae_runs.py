"""The PixelHVAE's slowest CPU cases, apart from
tests/test_torch_pixel_hvae.py so that ``--dist loadfile`` runs them on
another worker: the crop sampler against the full-canvas oracle at 28x28,
an Experiment epoch, and a CLI epoch and resume. Same cases, same sizes and
tolerances as that file's.
"""

import json

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from test_torch_pixel_hvae import Z1, Z2, _differing_rows


@pytest.mark.parametrize("input_type,hw", [("binary", 28)])
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


# ---------------------------------------------------------------------------
# the Experiment and the CLI
# ---------------------------------------------------------------------------


def test_experiment_epoch_on_cpu(tmp_path):
    """Train, validate, IWAE-score and write the artifacts through the
    Experiment; the generations are binary samples; a checkpoint restores
    into a fresh Experiment bitwise."""
    from exemplar_vae_tpu_torch.train.plots import read_png
    from exemplar_vae_tpu_torch.train.trainer import Experiment
    cfg = Config(dataset_name="synthetic", model_name="pixelhvae_2level",
                 training_set_size=64, number_components=64, val_set_size=16,
                 test_set_size=8, batch_size=32, test_batch_size=8, S=4,
                 MB=2, warmup=1, hidden_size=16, z1_size=4, z2_size=4,
                 pixelcnn_features=8, pixelcnn_layers=1,
                 snapshot_dir=str(tmp_path))
    exp = Experiment(cfg, device="cpu", verbose=False)
    m = exp.train_epoch()
    assert np.isfinite(m["loss"])
    assert all(np.isfinite(v) for v in exp.validate())
    res = exp.final_evaluation()
    assert np.isfinite(res["test_nll"]) and "artifact_error" not in res
    grid = read_png(f"{exp.exp_dir}/generations.png")
    assert set(np.unique(grid)) <= {0, 255}
    exp.save_checkpoint()
    back = Experiment(cfg, device="cpu", verbose=False)
    assert back.restore_checkpoint()
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, back.model.state_dict()[k]), k


def test_cli_epoch_and_resume_on_cpu(tmp_path, capsys):
    from exemplar_vae_tpu_torch.main import main
    base = ["--no_cuda", "--model_name", "pixelhvae_2level", "--dataset_name",
            "synthetic", "--training_set_size", "64", "--number_components",
            "64", "--val_set_size", "16", "--test_set_size", "8",
            "--batch_size", "32", "--test_batch_size", "8", "--warmup", "1",
            "--S", "4", "--MB", "2", "--hidden_size", "16", "--z1_size", "4",
            "--z2_size", "4", "--pixelcnn_features", "8", "--pixelcnn_layers",
            "1", "--checkpoint_every", "1", "--snapshot_dir", str(tmp_path)]
    first = main(base + ["--epochs", "1"])
    assert first["epochs_trained"] == 1 and np.isfinite(first["test_nll"])
    capsys.readouterr()
    again = main(base + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    assert json.loads(out.strip().splitlines()[-1]) == again
    assert again["epochs_trained"] == 2 and np.isfinite(again["test_nll"])
    (exp_dir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    for name in ("reconstructions.png", "real.png", "generations.png",
                 "exemplar_neighborhoods.png", "latent_knn_retrieval.png"):
        assert (exp_dir / name).stat().st_size > 0, name
