"""CLI entry point of the port, flag-compatible with the root main.py:

    python -m exemplar_vae_tpu_torch.main --dataset_name dynamic_mnist \\
        --model_name vae --prior exemplar_prior --number_components 25000

It trains on the CUDA card; ``--no_cuda`` runs on the CPU. The flags are
listed in exemplar_vae_tpu_torch/config.py. It prints the experiment
directory, one line of metrics per epoch and, last, the results as JSON,
and saves the final state to ``ckpt_final``.

* ``--checkpoint_every K`` saves ``ckpt_last`` every K epochs;
* ``--resume`` restores ``ckpt_last`` and trains on up to ``--epochs``
  (it warns and starts afresh when there is none);
* ``--eval_only`` restores ``ckpt_final`` (else ``ckpt_last``) and runs
  the final evaluation and the artifacts, with no training.

Bank sharding: ``--mesh W`` under torchrun runs W ranks, the exemplar bank
and its cache split by rows over them (parallel/mesh.py), NCCL between
cards (``--no_cuda``: gloo on the CPU); rank 0 prints and writes:

    torchrun --nproc_per_node W -m exemplar_vae_tpu_torch.main --mesh W ...
"""

from __future__ import annotations

import json


def main(argv=None) -> dict:
    from exemplar_vae_tpu_torch.config import (config_from_args,
                                               reference_arg_parser)
    from exemplar_vae_tpu_torch.parallel.mesh import shutdown
    from exemplar_vae_tpu_torch.train.trainer import Experiment

    ns = reference_arg_parser().parse_args(argv)
    cfg = config_from_args(ns)
    exp = Experiment(cfg, device="cpu" if ns.no_cuda else "cuda")
    try:
        return _run(exp, cfg)
    finally:
        if exp.mesh is not None:
            shutdown()


def _run(exp, cfg) -> dict:
    say = print if exp._is_main else (lambda *a, **k: None)
    if cfg.eval_only:
        # the final checkpoint first: its best params gave the reported
        # numbers
        for tag in ("final", "last"):
            if exp.restore_checkpoint(tag):
                say(f"eval_only: restored ckpt_{tag} (epoch {exp.epoch})")
                break
        else:
            raise SystemExit(
                f"--eval_only: no restorable checkpoint (ckpt_final or "
                f"ckpt_last) under {exp.exp_dir}")
        say(f"experiment dir: {exp.exp_dir}")
        results = exp.final_evaluation()
        say(json.dumps(results))
        return results
    if cfg.resume:
        if exp.restore_checkpoint():
            say(f"resumed from epoch {exp.epoch}")
        else:
            say(f"WARNING: --resume given but no checkpoint found under "
                f"{exp.exp_dir}/ckpt_last; starting fresh")
    say(f"experiment dir: {exp.exp_dir}")
    say(f"dataset={exp.cfg.dataset_name} source={exp.splits.source} "
        f"n_train={exp.n_train} device={exp.device}"
        + (f" mesh={exp.mesh.size}" if exp.mesh else ""))
    results = exp.run()
    exp.save_checkpoint("final")
    say(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
