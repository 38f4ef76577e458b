"""The transposed conv's two routes (models/layers.py::conv_transpose_same).

With a gradient to carry, the call runs ``F.conv_transpose2d``; otherwise it
runs one stride-1 sub-pixel ``F.conv2d`` and a depth-to-space copy, and
``conv_transpose_same.subpixel`` counts the call. Both are held against the
``F.conv_transpose2d`` formulation copied below as the oracle: fp64 to 1e-12
and fp32 to 1e-5 relative (of the output's largest element), the same
mathematics summed in another order.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from exemplar_vae_tpu_torch import serve
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.models import layers
from exemplar_vae_tpu_torch.models.layers import conv_transpose_same
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank

REL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = [(3, 2, 16, 16), (3, 2, 7, 7), (3, 2, 5, 8), (4, 2, 8, 8),
         (5, 2, 9, 9), (3, 3, 5, 5), (2, 2, 6, 6)]


def oracle(x, w_hwio, b, stride):
    """conv_transpose_same's F.conv_transpose2d formulation: lax's SAME
    transposed correlation as the flipped kernel's transposed conv, cropped
    or output-padded."""
    (ph, oph, ch), (pw, opw, cw) = (
        layers._transpose_pads(w_hwio.shape[0], stride[0]),
        layers._transpose_pads(w_hwio.shape[1], stride[1]))
    w = w_hwio.permute(2, 3, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(x, w, b, stride=stride, padding=(ph, pw),
                           output_padding=(oph, opw))
    if ch or cw:
        y = y[:, :, :y.shape[2] - ch, :y.shape[3] - cw]
    return y


def _inputs(k, s, h, w, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 5, h, w), generator=g, dtype=dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    return (x, torch.randn((k, k, 5, 6), generator=g, dtype=dtype),
            torch.randn((6,), generator=g, dtype=dtype))


def _close(got, want):
    rel = REL[want.dtype]
    torch.testing.assert_close(got, want, rtol=rel,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("k,s,h,w", CASES)
def test_subpixel_route_matches_oracle(k, s, h, w, channels_last, dtype):
    """Without grad: the sub-pixel route, counted once; output shape
    input * s, and the input's memory format kept."""
    x, wt, b = _inputs(k, s, h, w, dtype, channels_last)
    before = conv_transpose_same.subpixel
    with torch.no_grad():
        got = conv_transpose_same(x, wt, b, (s, s))
    assert conv_transpose_same.subpixel == before + 1
    assert got.shape == (2, 6, h * s, w * s)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    _close(got, oracle(x, wt, b, (s, s)))


@pytest.mark.parametrize("k,s,h,w", [(3, 2, 7, 7), (4, 2, 8, 8), (3, 3, 5, 5)])
@pytest.mark.parametrize("needs_grad", ["x", "w", "b", "all"])
def test_autograd_takes_the_transpose_route(k, s, h, w, needs_grad):
    """Grad mode on and any of x, w, b requiring grad: F.conv_transpose2d,
    not counted; output and the x, w, b grads equal the oracle's."""
    inputs = _inputs(k, s, h, w, torch.float64, True)
    mine = [t.clone().requires_grad_(needs_grad in (name, "all"))
            for name, t in zip("xwb", inputs)]
    ref = [t.clone().requires_grad_(needs_grad in (name, "all"))
           for name, t in zip("xwb", inputs)]
    cot = torch.randn((2, 6, h * s, w * s), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    before = conv_transpose_same.subpixel
    got = conv_transpose_same(*mine, (s, s))
    assert conv_transpose_same.subpixel == before
    want = oracle(*ref, (s, s))
    assert torch.equal(got, want)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for a, r in zip(mine, ref):
        if r.requires_grad:
            assert torch.equal(a.grad, r.grad)


def test_grad_mode_without_a_leaf_needing_grad_takes_the_subpixel_route():
    x, wt, b = _inputs(3, 2, 6, 6, torch.float64, True)
    before = conv_transpose_same.subpixel
    with torch.enable_grad():
        got = conv_transpose_same(x, wt, b, (2, 2))
    assert conv_transpose_same.subpixel == before + 1
    _close(got, oracle(x, wt, b, (2, 2)))


def test_no_grad_counts_one_per_call():
    x, wt, b = _inputs(3, 2, 6, 6, torch.float32, True)
    before = conv_transpose_same.subpixel
    with torch.no_grad():
        for _ in range(3):
            conv_transpose_same(x, wt, b, (2, 2))
    assert conv_transpose_same.subpixel == before + 3


def _config4(**kw):
    """Config 4's model widths and conv spec (default enc/dec specs,
    projection 64, hidden 300, z 40 + 40) on 3-channel continuous images."""
    base = dict(model_name="convhvae_2level", hidden_size=300, z1_size=40,
                z2_size=40, input_size=(3, 64, 64), input_type="continuous",
                dynamic_binarization=False, number_components=12,
                use_pallas_prior=False)
    base.update(kw)
    return Config(**base)


def test_config4_decode_no_grad_matches_oracle_decode(monkeypatch):
    """Config 4's decoder (t64k3s2, t32k3s2, c32k3s1 from 16x16) under
    no_grad on 2 samples: two counted calls, the oracle's decode (the
    unfused gate over F.conv_transpose2d) to 1e-5."""
    model = create_model(_config4(), device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    z1, z2 = torch.randn((2, 40), generator=g), torch.randn((2, 40), generator=g)
    before = conv_transpose_same.subpixel
    with torch.no_grad():
        got = model.decode(z1, z2)
        assert conv_transpose_same.subpixel == before + 2
        monkeypatch.setattr(layers.GatedConvTranspose2d, "_conv",
                            staticmethod(oracle))
        monkeypatch.setattr(layers._GatedConvBase, "_fused_route",
                            lambda self, x, dt: False)
        want = model.decode(z1, z2)
    assert conv_transpose_same.subpixel == before + 2
    for a, r in zip(got, want):
        assert a.shape == (2, 64, 64, 3)
        _close(a, r)


def _small_convhvae():
    n = 12
    cfg = _config4(hidden_size=16, z1_size=4, z2_size=6, input_size=(3, 16, 16),
                   number_components=n, S=8, MB=4, test_batch_size=4)
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (n, 16, 16, 3), generator=g, dtype=torch.uint8)
    return cfg, create_model(cfg, device="cpu", seed=0), raw, g


def test_score_request_counts_two_per_round_and_train_step_none():
    """A score request decodes once a round through the two strided
    transposed layers: 20 counted calls in 10 rounds. A train step carries
    gradients through them and counts none."""
    cfg, model, raw, g = _small_convhvae()
    n = raw.shape[0]
    _, _, score = serve.make_serving_fns(model, cfg, n, 1, 10, 2)
    before = conv_transpose_same.subpixel
    nll = score(raw[:2], torch.randn((n, 6), generator=g),
                torch.arange(n, dtype=torch.int32),
                torch.ones(n, dtype=torch.bool), generator=g)
    assert np.isfinite(nll.numpy()).all()
    assert conv_transpose_same.subpixel == before + 20
    bank = Bank(images=raw, data_idx=torch.arange(n, dtype=torch.int32),
                valid=torch.ones(n, dtype=torch.bool), cache_means=None,
                n_effective=n)
    before = conv_transpose_same.subpixel
    _, aux = tsteps.make_train_step(cfg)(
        tsteps.init_train_state(model, cfg), raw[:4],
        torch.arange(4, dtype=torch.int32), bank, 1.0, generator=g)
    assert np.isfinite(float(aux["loss"]))
    assert conv_transpose_same.subpixel == before
    assert all(p.grad is not None for p in model._p_x_deconv[0].parameters())
