"""Serving (counterpart of exemplar_vae_tpu/serve.py: make_serving_fns,
export_serving_bundle and ServingBundle).

Three programs:

* ``generate``           - unconditional samples: n ~ U(N), z ~ N(mu_n,
                           sigma^2 I) with mu_n read from the encoded eval
                           bank, decode;
* ``reference_generate`` - exemplar-conditioned generation (the
                           data-augmentation primitive);
* ``score_nll``          - per-point IWAE NLL of one chunk (the reference
                           eval protocol: full bank, no LOO).

``export_serving_bundle`` writes a bundle in the JAX package's layout
(``bundle.json`` and ``arrays.npz``: weights and the eval bank) and, where
the JAX package writes its ``jax.export`` programs (``generate.bin`` ...),
three ``torch.export`` programs (``generate.pt2``, ``reference_generate.pt2``,
``score_nll.pt2``) at the bundle's fixed sizes. As in the JAX programs, the
weights, the bank and the noise are inputs: the programs hold no weights,
so one program serves re-trained weights of the same architecture, and
every draw (exemplar index, top latent, a two-level model's z1; the IWAE's
per round) is an input tensor. The exemplar prior's pairwise LSE stays one
node of the program, the custom op ``exemplar_vae_tpu_torch::pairwise_lse``
(ops/pairwise_lse.py: the CUDA kernel on the card, its plain version on the
CPU), and so does a ConvHVAE's gated-conv epilogue,
``exemplar_vae_tpu_torch::gated_epilogue`` (ops/gated_epilogue.py). The
manifest lists the programs and the device type they were exported on
(``"platforms"``), and names its writer (``"exported_by":
"exemplar_vae_tpu_torch"``); the JAX package's loader, which needs its
``.bin`` programs, refuses it.

``ServingBundle.load`` serves a bundle that lists programs from those
programs alone: it loads them, binds the weights from ``arrays.npz`` and
draws their noise from the caller's generator in the live functions' order,
and imports no model code. A bundle without programs (a JAX one, whose
``.bin`` programs torch cannot replay, or a PixelHVAE one: its samplers
are a Python loop over the pixels) is served by the port's model, built
from the manifest's config.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.device import as_tensor, resolve_device
# registers the ops that the programs call, before torch.export.load
from exemplar_vae_tpu_torch.ops import gated_epilogue, pairwise_lse  # noqa: F401
from exemplar_vae_tpu_torch.weights import params_from_keystr, params_to_keystr

PROGRAMS = ("generate", "reference_generate", "score_nll")
# a program's noise inputs, in the order the live functions draw them
NOISE = ("idx", "eps", "eps1")


def make_serving_fns(model, cfg: Config, n_effective: int, n_gen: int,
                     rounds: int, r: int):
    """(generate, reference_generate, score_nll) for ``model`` at fixed
    sizes. Noise is drawn from ``generator`` or injected (``idx``/``eps``,
    and ``eps1``: a two-level model's z1 noise, for the PixelHVAE the pair
    (z1 noise, per-pixel uniforms)), in the draw order of the JAX
    programs."""
    from exemplar_vae_tpu_torch.models.base import clamped_prior_log_var
    from exemplar_vae_tpu_torch.train import sampling
    from exemplar_vae_tpu_torch.train.evaluation import (make_iwae_fn,
                                                         model_device)
    from exemplar_vae_tpu_torch.train.loss import Bank

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


class _Bound(torch.nn.Module):
    """A serving function over ``model``: functional_call's target."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, inputs):
        return self.fn(**inputs)


class _Program(torch.nn.Module):
    """The module torch.export traces: ``forward(params, **inputs)`` runs
    the serving function with ``params`` (the model's state_dict) bound in
    place of the model's own tensors. It registers no parameter, so the
    exported program takes the weights as an input and holds none."""

    def __init__(self, model, fn):
        super().__init__()
        self._bound = (_Bound(model, fn),)       # a tuple: no submodule

    def forward(self, params, **inputs):
        return torch.func.functional_call(
            self._bound[0], {"model." + k: v for k, v in params.items()},
            (inputs,), strict=True)


def _export_programs(model, cfg: Config, out_dir: str, bank, n_effective,
                     n_gen, ref_batch, score_chunk, rounds, r, x_dtype):
    """torch.export each serving function at the bundle's sizes, with the
    weights, the bank (``bank``: its bank_means, data_idx and valid, or
    None) and the noise as inputs; save each as ``<name>.pt2``. Returns the
    file names."""
    from exemplar_vae_tpu_torch.models.hvae import TwoLevelMLPCore
    from exemplar_vae_tpu_torch.train.evaluation import model_device

    dev = model_device(model)
    gen, ref, score = make_serving_fns(model, cfg, n_effective, n_gen,
                                       rounds, r)
    c, h, w = (int(s) for s in cfg.input_size)
    two_level = isinstance(model, TwoLevelMLPCore)

    def noise(lead):
        """eps (and eps1) of ``lead`` + (latent width,)."""
        out = {"eps": torch.zeros(lead + (model.top_dim,), device=dev)}
        if two_level:
            out["eps1"] = torch.zeros(lead + (cfg.z1_size,), device=dev)
        return out

    def x(b):
        return torch.zeros((b, h, w, c), dtype=x_dtype, device=dev)

    def gen_fn(bank_means=None, idx=None, eps=None, eps1=None):
        return gen(bank_means, idx=idx, eps=eps, eps1=eps1)

    def ref_fn(x, eps, eps1=None):
        return ref(x, eps=eps, eps1=eps1)

    def score_fn(x, eps, eps1=None, bank_means=None, data_idx=None,
                 valid=None):
        e = eps if eps1 is None else (eps, eps1)
        if bank_means is None:
            return score(x, eps=e)
        return score(x, bank_means, data_idx, valid, eps=e)

    bank = bank or {}
    gen_in = {"bank_means": bank["bank_means"]} if bank else {}
    if cfg.prior in ("exemplar_prior", "vampprior"):
        gen_in["idx"] = torch.zeros((n_gen,), dtype=torch.int64, device=dev)
    programs = {
        "generate": (gen_fn, {**gen_in, **noise((n_gen,))}),
        "reference_generate": (ref_fn, {"x": x(ref_batch),
                                        **noise((ref_batch,))}),
        "score_nll": (score_fn, {"x": x(score_chunk), **bank,
                                 **noise((rounds, score_chunk * r))}),
    }
    params = dict(model.state_dict())
    files = []
    for name in PROGRAMS:
        fn, inputs = programs[name]
        # traced with grad mode off throughout, as the programs are served:
        # the serving functions' own no_grad regions then leave no grad-mode
        # subgraphs (nested ones left empty subgraphs that torch.export.load
        # refuses)
        with torch.no_grad():
            ep = torch.export.export(_Program(model, fn), (),
                                     {"params": params, **inputs},
                                     strict=False)
        ep.example_inputs = None        # else saved: the weights, the noise
        files.append(name + ".pt2")
        torch.export.save(ep, os.path.join(out_dir, files[-1]))
    return files


def export_serving_bundle(model, cfg: Config, out_dir: str, *,
                          bank_means=None, data_idx=None, valid=None,
                          n_effective: Optional[int] = None, n_gen: int = 25,
                          ref_batch: int = 16, score_chunk: int = 16,
                          s_total: int = 64, r: int = 16) -> dict:
    """Write ``model``'s weights (``"param:" + keystr`` keys) and, for an
    exemplar prior, its eval bank (from make_eval_bank_fn: full bank, no
    LOO) into ``out_dir``/arrays.npz, the three serving programs exported
    on the model's device (not for the PixelHVAE), and the manifest into
    bundle.json; returns the manifest. The bundle loads in the port only
    (``ServingBundle.load``)."""
    from exemplar_vae_tpu_torch.models.pixel_hvae import PixelHVAE
    from exemplar_vae_tpu_torch.train.evaluation import model_device

    arrays = params_to_keystr(model.state_dict(), "param:")
    bank = None
    if cfg.prior == "exemplar_prior":
        if bank_means is None or data_idx is None or valid is None:
            raise ValueError("an exemplar-prior bundle needs the eval bank: "
                             "bank_means, data_idx and valid")
        n_effective = int(n_effective if n_effective is not None
                          else bank_means.shape[0])
        dev = model_device(model)
        bank = {"bank_means": as_tensor(bank_means, dev),
                "data_idx": as_tensor(data_idx, dev, torch.int32),
                "valid": as_tensor(valid, dev, torch.bool)}
        arrays.update({k: v.cpu().numpy() for k, v in bank.items()})
    else:
        n_effective = 0
    r = min(r, s_total)
    rounds = max(-(-s_total // r), 1)
    c, h, w = (int(s) for s in cfg.input_size)
    # continuous models score raw uint8 (dequantized inside preprocessing)
    x_dtype = np.uint8 if cfg.input_type == "continuous" else np.float32
    os.makedirs(out_dir, exist_ok=True)
    programs, platforms = [], []
    if not isinstance(model, PixelHVAE):
        programs = _export_programs(
            model, cfg, out_dir, bank, n_effective, n_gen, ref_batch,
            score_chunk, rounds, r,
            torch.uint8 if x_dtype == np.uint8 else torch.float32)
        platforms = [model_device(model).type]
    manifest = {
        "model_name": cfg.model_name, "prior": cfg.prior,
        "input_type": cfg.input_type, "image_shape_nhwc": [h, w, c],
        "x_dtype": np.dtype(x_dtype).name,
        "n_gen": n_gen, "ref_batch": ref_batch, "score_chunk": score_chunk,
        "s_total": s_total, "r": r, "rounds": rounds,
        "n_effective": n_effective, "platforms": platforms,
        "exported_by": "exemplar_vae_tpu_torch", "programs": programs,
        "config": json.loads(cfg.to_json()),
    }
    np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    with open(os.path.join(out_dir, "bundle.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class _LoadedProgram:
    """One exported program, its weights bound from the bundle's
    ``arrays.npz``: called with its non-noise inputs and the injected noise,
    it draws the noise not injected from ``generator`` in the live
    functions' order (``rounds`` > 0: the IWAE's per-round draws, round
    after round) and runs the program."""

    def __init__(self, path: str, flat_params: dict, dev, hi: int = 0,
                 rounds: int = 0):
        ep = torch.export.load(path)
        spec = ep.call_spec.in_spec
        _, kw = pytree.tree_unflatten(list(range(spec.num_leaves)), spec)
        user = set(ep.graph_signature.user_inputs)
        vals = [n.meta["val"] for n in ep.graph.nodes
                if n.op == "placeholder" and n.name in user]
        want = list(kw["params"])
        if set(want) != set(flat_params):
            raise ValueError(
                f"{path}: arrays.npz does not hold the program's weights: "
                f"missing {sorted(set(want) - set(flat_params))}, unexpected "
                f"{sorted(set(flat_params) - set(want))}")
        self.params = {k: flat_params[k] for k in want}
        self.inputs = {k: (tuple(vals[i].shape), vals[i].dtype)
                       for k, i in kw.items() if k != "params"}
        self.module = ep.module()
        self.dev, self.hi, self.rounds = dev, hi, rounds

    def _draw(self, name, shape, generator):
        if name == "idx":
            return torch.randint(0, self.hi, shape, generator=generator,
                                 device=self.dev)
        return torch.randn(shape, generator=generator, device=self.dev)

    def __call__(self, *, generator=None, **given):
        noise = [n for n in NOISE if n in self.inputs and given.get(n) is None]
        if self.rounds and noise:
            per = {n: [] for n in noise}
            for _ in range(self.rounds):
                for n in noise:
                    per[n].append(self._draw(n, self.inputs[n][0][1:],
                                             generator))
            drawn = {n: torch.stack(v) for n, v in per.items()}
        else:
            drawn = {n: self._draw(n, self.inputs[n][0], generator)
                     for n in noise}
        args = {k: drawn[k] if k in drawn else
                as_tensor(given[k], self.dev, self.inputs[k][1])
                for k in self.inputs}
        with torch.no_grad():
            return self.module(params=self.params, **args)


def _program_fns(programs: dict):
    """(generate, reference_generate, score_nll) served by the loaded
    programs, with the live functions' signatures."""
    gen_p, ref_p, score_p = (programs[n] for n in PROGRAMS)

    def generate(bank_means, *, generator=None, idx=None, eps=None,
                 eps1=None):
        return gen_p(generator=generator, bank_means=bank_means, idx=idx,
                     eps=eps, eps1=eps1)

    def reference_generate(x_ref_raw, *, generator=None, eps=None,
                           eps1=None):
        return ref_p(generator=generator, x=x_ref_raw, eps=eps, eps1=eps1)

    def score_nll(x_chunk_raw, bank_means=None, data_idx=None, valid=None, *,
                  generator=None, eps=None):
        eps, eps1 = eps if isinstance(eps, (tuple, list)) else (eps, None)
        return score_p(generator=generator, x=x_chunk_raw,
                       bank_means=bank_means, data_idx=data_idx, valid=valid,
                       eps=eps, eps1=eps1)

    return generate, reference_generate, score_nll


class ServingBundle:
    """A serving bundle (exported by either package), served by the port.

    >>> b = ServingBundle.load("serving/")          # on the card
    >>> imgs = b.generate(generator=torch.Generator("cuda").manual_seed(0))
    >>> mean, per_point = b.score_nll(test_images)

    ``programs`` (name -> loaded program) serve a bundle that lists
    programs, and ``model`` is then None; else ``model`` serves it and
    ``programs`` is empty.
    """

    def __init__(self, manifest, cfg, model, bank, fns, programs=None):
        self.manifest = manifest
        self.cfg = cfg
        self.model = model
        self.bank = bank
        self.programs = programs or {}
        self._generate, self._reference_generate, self._score = fns

    @classmethod
    def load(cls, d: str, device="cuda") -> "ServingBundle":
        """Read the bundle in ``d`` onto ``device``: through its programs
        when the manifest lists any (``device`` must be one of its
        ``platforms``; a listed program that is missing or fails to load
        raises), else through the port's model built from its config."""
        dev = resolve_device(device)
        with open(os.path.join(d, "bundle.json")) as f:
            manifest = json.load(f)
        cfg = Config.from_json(manifest["config"])
        if manifest.get("programs") and dev.type not in manifest["platforms"]:
            raise ValueError(
                f"bundle {d} holds programs exported for "
                f"{manifest['platforms']}; it cannot serve on {dev}")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            flat = params_from_keystr({k[len("param:"):]: data[k]
                                       for k in data.files
                                       if k.startswith("param:")})
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
        if manifest.get("programs"):
            missing = sorted({n + ".pt2" for n in PROGRAMS}
                             - set(manifest["programs"]))
            if missing:
                raise ValueError(f"bundle {d} lists {manifest['programs']}, "
                                 f"not {missing}")
            hi = (manifest["n_effective"] if cfg.prior == "exemplar_prior"
                  else cfg.number_components)
            flat = {k: v.to(dev) for k, v in flat.items()}
            programs = {n: _LoadedProgram(
                os.path.join(d, n + ".pt2"), flat, dev,
                hi=hi if n == "generate" else 0,
                rounds=int(manifest["rounds"]) if n == "score_nll" else 0)
                for n in PROGRAMS}
            return cls(manifest, cfg, None, bank, _program_fns(programs),
                       programs)
        from exemplar_vae_tpu_torch.models import create_model
        model = create_model(cfg, device=dev)
        model.load_state_dict(flat)
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
