"""Serving (counterpart of exemplar_vae_tpu/serve.py: make_serving_fns and
ServingBundle).

Three programs:

* ``generate``           - unconditional samples: n ~ U(N), z ~ N(mu_n,
                           sigma^2 I) with mu_n read from the encoded eval
                           bank, decode;
* ``reference_generate`` - exemplar-conditioned generation (the
                           data-augmentation primitive);
* ``score_nll``          - per-point IWAE NLL of one chunk (the reference
                           eval protocol: full bank, no LOO).

``export_serving_bundle`` writes a bundle in the JAX package's layout
(``bundle.json`` and ``arrays.npz``: weights and the eval bank) without the
StableHLO ``.bin`` programs, which only ``jax.export`` can write: its
manifest says ``"platforms": []`` and ``"exported_by":
"exemplar_vae_tpu_torch"``, and the JAX package's ``ServingBundle.load``,
which needs the programs, refuses it. ``ServingBundle.load`` reads a bundle
of either package (ignoring the ``.bin`` programs of a JAX one), builds the
port's model from the manifest's config and serves the three programs on
the card.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.device import resolve_device
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.models.base import clamped_prior_log_var
from exemplar_vae_tpu_torch.train import sampling
from exemplar_vae_tpu_torch.train.evaluation import (as_tensor, make_iwae_fn,
                                                     model_device)
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.weights import params_from_keystr, params_to_keystr


def make_serving_fns(model, cfg: Config, n_effective: int, n_gen: int,
                     rounds: int, r: int):
    """(generate, reference_generate, score_nll) for ``model`` at fixed
    sizes. Noise is drawn from ``generator`` or injected (``idx``/``eps``,
    and ``eps1``: a two-level model's z1 noise, for the PixelHVAE the pair
    (z1 noise, per-pixel uniforms)), in the draw order of the JAX
    programs."""

    @torch.no_grad()
    def generate(bank_means, *, generator=None, idx=None, eps=None,
                 eps1=None):
        if cfg.prior != "exemplar_prior":
            return sampling.generate_x(model, cfg, n_gen, generator=generator,
                                       idx=idx, eps=eps, eps1=eps1)
        dev = model_device(model)
        i = sampling.draw_index(idx, n_gen, n_effective, generator, dev)
        mu = as_tensor(bank_means, dev)[i]
        log_var = clamped_prior_log_var(model, cfg)
        z = mu + torch.exp(0.5 * log_var) * sampling.draw_normal(
            eps, mu.shape, generator, dev)
        return model.generate_from_top(z, eps=eps1, generator=generator)

    def reference_generate(x_ref_raw, *, generator=None, eps=None,
                           eps1=None):
        return sampling.reference_based_generation_x(
            model, cfg, x_ref_raw, generator=generator, eps=eps, eps1=eps1)

    iwae = make_iwae_fn(model, cfg)

    def score_nll(x_chunk_raw, bank_means, data_idx, valid, *,
                  generator=None, eps=None):
        dev = model_device(model)
        bank = Bank(images=None, data_idx=as_tensor(data_idx, dev, torch.int32),
                    valid=as_tensor(valid, dev, torch.bool),
                    cache_means=as_tensor(bank_means, dev),
                    n_effective=n_effective)
        return iwae.chunk_nll(x_chunk_raw, bank, rounds, r,
                              generator=generator, eps=eps)

    def score_nll_no_bank(x_chunk_raw, *, generator=None, eps=None):
        return iwae.chunk_nll(x_chunk_raw, None, rounds, r,
                              generator=generator, eps=eps)

    return generate, reference_generate, (
        score_nll if cfg.prior == "exemplar_prior" else score_nll_no_bank)


def export_serving_bundle(model, cfg: Config, out_dir: str, *,
                          bank_means=None, data_idx=None, valid=None,
                          n_effective: Optional[int] = None, n_gen: int = 25,
                          ref_batch: int = 16, score_chunk: int = 16,
                          s_total: int = 64, r: int = 16) -> dict:
    """Write ``model``'s weights (``"param:" + keystr`` keys) and, for an
    exemplar prior, its eval bank (from make_eval_bank_fn: full bank, no
    LOO) into ``out_dir``/arrays.npz, and the manifest into bundle.json;
    returns the manifest. The bundle has no programs, so it loads in the
    port only (``ServingBundle.load``)."""
    arrays = params_to_keystr(model.state_dict(), "param:")
    if cfg.prior == "exemplar_prior":
        if bank_means is None or data_idx is None or valid is None:
            raise ValueError("an exemplar-prior bundle needs the eval bank: "
                             "bank_means, data_idx and valid")
        n_effective = int(n_effective if n_effective is not None
                          else bank_means.shape[0])
        arrays.update(bank_means=as_tensor(bank_means, "cpu").numpy(),
                      data_idx=as_tensor(data_idx, "cpu", torch.int32).numpy(),
                      valid=as_tensor(valid, "cpu", torch.bool).numpy())
    else:
        n_effective = 0
    r = min(r, s_total)
    c, h, w = (int(s) for s in cfg.input_size)
    # continuous models score raw uint8 (dequantized inside preprocessing)
    x_dtype = np.uint8 if cfg.input_type == "continuous" else np.float32
    manifest = {
        "model_name": cfg.model_name, "prior": cfg.prior,
        "input_type": cfg.input_type, "image_shape_nhwc": [h, w, c],
        "x_dtype": np.dtype(x_dtype).name,
        "n_gen": n_gen, "ref_batch": ref_batch, "score_chunk": score_chunk,
        "s_total": s_total, "r": r, "rounds": max(-(-s_total // r), 1),
        "n_effective": n_effective, "platforms": [],
        "exported_by": "exemplar_vae_tpu_torch",
        "config": json.loads(cfg.to_json()),
    }
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    with open(os.path.join(out_dir, "bundle.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingBundle:
    """A serving bundle (exported by either package), served by the port.

    >>> b = ServingBundle.load("serving/")          # on the card
    >>> imgs = b.generate(generator=torch.Generator("cuda").manual_seed(0))
    >>> mean, per_point = b.score_nll(test_images)
    """

    def __init__(self, manifest, cfg, model, bank, fns):
        self.manifest = manifest
        self.cfg = cfg
        self.model = model
        self.bank = bank
        self._generate, self._reference_generate, self._score = fns

    @classmethod
    def load(cls, d: str, device="cuda") -> "ServingBundle":
        dev = resolve_device(device)
        with open(os.path.join(d, "bundle.json")) as f:
            manifest = json.load(f)
        cfg = Config.from_json(manifest["config"])
        model = create_model(cfg, device=dev)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            flat = {k[len("param:"):]: data[k] for k in data.files
                    if k.startswith("param:")}
            bank = None
            if manifest["prior"] == "exemplar_prior":
                bank = {"bank_means": torch.as_tensor(data["bank_means"],
                                                      device=dev),
                        "data_idx": torch.as_tensor(data["data_idx"],
                                                    dtype=torch.int32,
                                                    device=dev),
                        "valid": torch.as_tensor(data["valid"],
                                                 dtype=torch.bool,
                                                 device=dev)}
        model.load_state_dict(params_from_keystr(flat))
        model.eval()
        fns = make_serving_fns(model, cfg, int(manifest["n_effective"]),
                               int(manifest["n_gen"]),
                               int(manifest["rounds"]), int(manifest["r"]))
        return cls(manifest, cfg, model, bank, fns)

    def _prep_x(self, x):
        """User input -> the bundle's x type. Continuous bundles take raw
        uint8 (dequantized inside score/generate, as at eval); a float
        array is rejected rather than silently cast. Binary/gray bundles
        take floats in [0,1]; raw uint8 is scaled by 1/255."""
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if self.manifest.get("x_dtype", "float32") == "uint8":
            if x.dtype != np.uint8:
                raise ValueError(
                    f"this bundle (input_type="
                    f"{self.manifest['input_type']!r}) was exported for raw "
                    f"uint8 images; got dtype {x.dtype} - pass the undecoded "
                    f"uint8 array")
            return x
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return x.astype(np.float32)

    def generate(self, *, generator=None, idx=None, eps=None, eps1=None):
        bm = self.bank["bank_means"] if self.bank is not None else None
        return self._generate(bm, generator=generator, idx=idx, eps=eps,
                              eps1=eps1)

    def reference_generate(self, x_ref, *, generator=None, eps=None,
                           eps1=None):
        if x_ref.shape[0] != self.manifest["ref_batch"]:
            raise ValueError(f"this bundle serves batches of "
                             f"{self.manifest['ref_batch']}, got "
                             f"{x_ref.shape[0]}")
        return self._reference_generate(self._prep_x(x_ref),
                                        generator=generator, eps=eps,
                                        eps1=eps1)

    def score_nll(self, x, *, generator=None, eps=None):
        """Mean + per-point IWAE NLL; loops fixed-size chunks, padding the
        tail (padded rows are scored and discarded). ``eps``: one chunk's
        noise per chunk, as make_iwae_fn's chunk_nll takes it."""
        chunk = self.manifest["score_chunk"]
        x = self._prep_x(x)
        outs = []
        for i, start in enumerate(range(0, x.shape[0], chunk)):
            xc = x[start:start + chunk]
            true = xc.shape[0]
            if true < chunk:
                xc = np.concatenate(
                    [xc, np.zeros((chunk - true,) + xc.shape[1:], xc.dtype)], 0)
            e = None if eps is None else eps[i]
            if self.bank is not None:
                o = self._score(xc, self.bank["bank_means"],
                                self.bank["data_idx"], self.bank["valid"],
                                generator=generator, eps=e)
            else:
                o = self._score(xc, generator=generator, eps=e)
            outs.append(o.cpu().numpy()[:true])
        per = np.concatenate(outs)
        return float(per.mean()), per
