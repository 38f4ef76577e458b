"""CLI entry point of the port, flag-compatible with the root main.py:

    python -m exemplar_vae_tpu_torch.main --dataset_name dynamic_mnist \\
        --model_name vae --prior exemplar_prior --number_components 25000

It trains on the CUDA card; ``--no_cuda`` runs on the CPU. The flags are
listed in exemplar_vae_tpu_torch/config.py. It prints the experiment
directory, one line of metrics per epoch and, last, the results as JSON.
"""

from __future__ import annotations

import json


def main(argv=None) -> dict:
    from exemplar_vae_tpu_torch.config import (config_from_args,
                                               reference_arg_parser)
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    ns = reference_arg_parser().parse_args(argv)
    cfg = config_from_args(ns)
    exp = Experiment(cfg, device="cpu" if ns.no_cuda else "cuda")
    print(f"experiment dir: {exp.exp_dir}")
    print(f"dataset={exp.cfg.dataset_name} source={exp.splits.source} "
          f"n_train={exp.n_train} device={exp.device}")
    results = exp.run()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
