"""Exemplar-VAE generative data augmentation experiment (BASELINE Config
5), flag-compatible with the root classify_mnist.py:

    python -m exemplar_vae_tpu_torch.classify_mnist --vae_dir <run dir> --pi 0.5
    python -m exemplar_vae_tpu_torch.classify_mnist --train_first

It trains an MLP classifier twice, plain and with each example replaced
with probability ``pi`` by an exemplar-conditioned sample of the VAE's best
params, prints both test errors and writes them to
``<run dir>/classifier_results.json``. It runs on the CUDA card;
``--no_cuda`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--vae_dir", type=str, default=None,
                   help="run directory of a trained (exemplar) VAE")
    p.add_argument("--train_first", action="store_true",
                   help="train a small exemplar VAE first (no --vae_dir)")
    p.add_argument("--pi", type=float, default=0.5,
                   help="per-example replacement probability")
    p.add_argument("--classifier_epochs", type=int, default=30)
    p.add_argument("--label_budget", type=int, default=0,
                   help="subsample the labeled set to this many examples "
                        "(0 = all); augmentation matters most when labels "
                        "are scarce")
    p.add_argument("--classifier_lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_cuda", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    # flags of --train_first
    p.add_argument("--dataset_name", type=str, default="dynamic_mnist")
    p.add_argument("--vae_epochs", type=int, default=20)
    p.add_argument("--training_set_size", type=int, default=50_000)
    p.add_argument("--S", type=int, default=16,
                   help="IWAE samples for the VAE's final eval in "
                        "--train_first mode")
    ns = p.parse_args(argv)

    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.train.augment import (load_experiment,
                                                      train_classifier)
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    device = "cpu" if ns.no_cuda else "cuda"
    if ns.vae_dir:
        exp = load_experiment(ns.vae_dir, device=device)
    elif ns.train_first:
        cfg = Config(dataset_name=ns.dataset_name, model_name="vae",
                     prior="exemplar_prior", epochs=ns.vae_epochs,
                     warmup=min(10, ns.vae_epochs), S=ns.S, MB=ns.S,
                     training_set_size=ns.training_set_size,
                     number_components=ns.training_set_size, seed=ns.seed)
        exp = Experiment(cfg, device=device)
        exp.run()
        exp.save_checkpoint("final")
    else:
        raise SystemExit("need --vae_dir or --train_first")

    exp.model.load_state_dict(exp.best_params)
    results = {}
    for name, aug in [("plain", False), ("exemplar_augmented", True)]:
        r = train_classifier(exp.model, exp.cfg, exp.splits, pi=ns.pi,
                             epochs=ns.classifier_epochs,
                             lr=ns.classifier_lr, batch_size=ns.batch_size,
                             seed=ns.seed, augment=aug,
                             label_budget=ns.label_budget)
        results[name] = {"test_error": r.test_error,
                         "train_seconds": r.train_seconds}
        print(f"{name}: test error {100 * r.test_error:.2f}% "
              f"({r.train_seconds:.1f}s)")
    out = json.dumps(results)
    with open(os.path.join(exp.exp_dir, "classifier_results.json"), "w") as f:
        f.write(out)
    print(out)
    return results


if __name__ == "__main__":
    main()
