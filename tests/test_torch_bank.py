"""The exemplar bank's policy (exemplar_vae_tpu_torch/train/bank.py), path
by path: the exact re-encode with gradients, the cache refresh, the eval
bank and the approximate prior's gathered rows, on a raw uint8 and a float
bank, with deterministic and with stochastic bank preprocessing.

Each path's means must be bitwise model.encode_top_mean(preprocess_batch(
...)) composed by hand, in the same chunks, from a generator in the same
state, and must leave the generator where the hand composition leaves it.
The eval bank is deterministic whatever the flag says."""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
from exemplar_vae_tpu_torch.train.bank import (Bank, draw_rows_u,
                                               encode_bank_with_grad,
                                               epoch_bank, rows_input)
from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
from exemplar_vae_tpu_torch.train.steps import make_cache_refresh

N, CHUNK = 23, 5                # four chunks of 5 and a ragged one of 3
ROWS = torch.tensor([3, 17, 3, 22, 0, 9])
PATHS = ("exact_reencode", "cache_refresh", "eval_bank", "approx_rows")


def _cfg(input_type, stochastic):
    return Config(model_name="vae", hidden_size=8, z1_size=4,
                  input_size=(1, 6, 6) if input_type == "binary"
                  else (3, 4, 4), input_type=input_type,
                  number_components=N, exact_reencode_chunk=CHUNK,
                  bank_stochastic_preprocess=stochastic)


def _pre(cfg, x, train, generator=None, u=None):
    return preprocess_batch(x, input_type=cfg.input_type,
                            dynamic_binarization=cfg.dynamic_binarization,
                            train=train, generator=generator, u=u)


def _chunks(x):
    return [x[s:s + CHUNK] for s in range(0, x.shape[0], CHUNK)]


def _by_module(path, model, cfg, bank, g):
    if path == "exact_reencode":
        return encode_bank_with_grad(model, epoch_bank(bank, cfg, g).images,
                                     cfg, g)
    if path == "cache_refresh":
        return make_cache_refresh(model, cfg)(bank.images, generator=g)
    if path == "eval_bank":
        return make_eval_bank_fn(model, cfg)(bank).cache_means
    bank = epoch_bank(bank, cfg, g)
    u = draw_rows_u(cfg, bank, len(ROWS), g)
    return model.encode_top_mean(rows_input(bank.images[ROWS], cfg, g, u))


def _by_hand(path, model, cfg, raw, g):
    stochastic = cfg.bank_stochastic_preprocess and path != "eval_bank"
    enc = model.encode_top_mean
    if raw.dtype != torch.uint8:
        x = _pre(cfg, raw, stochastic, g)       # the whole bank at once
        if path == "approx_rows":
            return enc(x[ROWS])
        return torch.cat([enc(xc) for xc in _chunks(x)])
    if path == "approx_rows":
        u = (torch.rand((len(ROWS),) + tuple(raw.shape[1:]), generator=g)
             if stochastic else None)
        return enc(_pre(cfg, raw[ROWS], stochastic, u=u))
    outs = []
    for xc in _chunks(raw):
        if path == "exact_reencode" and stochastic:
            # drawn before the chunk's recomputed region
            u = torch.rand(xc.shape, generator=g)
            outs.append(enc(_pre(cfg, xc, True, u=u)))
        else:
            outs.append(enc(_pre(cfg, xc, stochastic, g)))
    return torch.cat(outs)


@pytest.mark.parametrize("input_type", ["binary", "continuous"])
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("path", PATHS)
def test_bank_path_is_the_hand_composed_encode(path, dtype, stochastic,
                                               input_type):
    cfg = _cfg(input_type, stochastic)
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    c, h, w = cfg.input_size
    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 256, (N, h, w, c), dtype=np.uint8))
    if dtype == "float":
        raw = raw.float() / 255.0
    bank = Bank(images=raw, data_idx=torch.arange(N, dtype=torch.int32),
                valid=torch.ones(N, dtype=torch.bool), cache_means=None,
                n_effective=N)
    g_mod = torch.Generator().manual_seed(7)
    g_hand = torch.Generator().manual_seed(7)
    got = _by_module(path, model, cfg, bank, g_mod)
    want = _by_hand(path, model, cfg, raw, g_hand)
    assert got.shape == (len(ROWS) if path == "approx_rows" else N,
                         cfg.z1_size)
    assert torch.equal(got, want)
    assert torch.equal(torch.rand(8, generator=g_mod),
                       torch.rand(8, generator=g_hand))
    if path in ("exact_reencode", "approx_rows"):
        params = [p for p in model.parameters() if p.requires_grad]
        grads = [torch.autograd.grad(m.sum(), params, allow_unused=True)
                 for m in (got, want)]
        assert any(a is not None for a in grads[0])
        for a, b in zip(*grads):
            assert (a is None and b is None) or torch.equal(a, b)
    else:
        assert not got.requires_grad
