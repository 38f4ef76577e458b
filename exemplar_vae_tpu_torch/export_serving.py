"""Export a serving bundle from a run directory (the port's counterpart of
tools/export_serving.py):

    python -m exemplar_vae_tpu_torch.export_serving --vae_dir <run dir> \\
        [--out <run dir>/serving] [--n_gen 25] [--ref_batch 16] \\
        [--score_chunk 16] [--S 64] [--MB 16] [--no_cuda]

It restores the run's checkpoint (ckpt_final, else ckpt_last), encodes the
eval bank with the best params (full bank, no LOO) and writes bundle.json,
arrays.npz and the three torch.export programs (serve.export_serving_bundle;
a PixelHVAE bundle has no programs). The bundle loads in the port only, and
its programs serve on the device type they were exported on. It runs on the
CUDA card; ``--no_cuda`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--vae_dir", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--n_gen", type=int, default=25)
    p.add_argument("--ref_batch", type=int, default=16)
    p.add_argument("--score_chunk", type=int, default=16)
    p.add_argument("--S", type=int, default=64)
    p.add_argument("--MB", type=int, default=16)
    p.add_argument("--no_cuda", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    ns = p.parse_args(argv)

    from exemplar_vae_tpu_torch.device import resolve_device
    from exemplar_vae_tpu_torch.serve import export_serving_bundle
    from exemplar_vae_tpu_torch.train.augment import load_experiment

    device = resolve_device("cpu" if ns.no_cuda else "cuda")
    exp = load_experiment(ns.vae_dir, device=device)
    exp.model.load_state_dict(exp.best_params)
    out = ns.out or os.path.join(ns.vae_dir, "serving")
    kw = {}
    if exp.bank is not None:
        eb = exp.build_eval_bank(exp.bank)
        kw = dict(bank_means=eb.cache_means, data_idx=eb.data_idx,
                  valid=eb.valid, n_effective=eb.n_effective)
    manifest = export_serving_bundle(
        exp.model, exp.cfg, out, n_gen=ns.n_gen, ref_batch=ns.ref_batch,
        score_chunk=ns.score_chunk, s_total=ns.S, r=ns.MB, **kw)
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"exported serving bundle to {out} ({size / 1e6:.1f} MB, "
          f"exported_by={manifest['exported_by']})")
    return manifest


if __name__ == "__main__":
    main()
