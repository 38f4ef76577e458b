"""The gated convs' fused epilogue (ops/gated_epilogue.py) and the gated
convs' two routes (models/layers.py), on the CPU.

* the op's plain version is, bitwise, the chain it replaces given the same
  raw conv output: without a stride the bias add, ``chunk``, sigmoid and
  product; with one the sub-pixel conv's depth-to-space copy that adds the
  bias, then the same; one launch a call, a fresh NCHW-contiguous output;
* a no-grad fp32 ``decode`` and ``encode_top`` of Config 4's and Config 3's
  ConvHVAE take the fused route and equal the parent's route (each conv
  with its bias on the models' channels-last view, the unfused gate) to the
  convs' fp32 rounding: the CPU's convs sum in another order per memory
  format;
* a call that needs a gradient, a bf16 call and ``GatedDense`` take the
  parent's route, bitwise, and count nothing;
* ``gated_epilogue.launches`` grows by 38 a Config 4 IWAE request (3
  decoder layers x 10 rounds, 4 + 4 encoder layers once) and by 0 a train
  step;
* the op stays one node under torch.export, its fake kernel giving the
  output's shape; the wrapper refuses what the op does not take.
"""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch import serve
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model, layers
from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank

counter = ge.gated_epilogue


def launches(fn):
    before = counter.launches
    out = fn()
    return counter.launches - before, out


def _weights(k, c_in, f, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((k, k, c_in, 2 * f), generator=g) / (3 * k),
            torch.randn((f,), generator=g), torch.randn((f,), generator=g))


def _unfused(y):
    """The parent's chain over a 2F-channel output that holds its bias."""
    h, g = torch.chunk(y, 2, dim=1)
    return h * torch.sigmoid(g)


@pytest.mark.parametrize("f", [32, 64])
@pytest.mark.parametrize("hw", [7, 16, 32])
@pytest.mark.parametrize("s", [1, 2])
def test_plain_is_the_unfused_chain_bitwise(s, hw, f):
    w, hb, gb = _weights(3, 8, f, seed=hw + f + s)
    x = torch.randn((3, 8, hw, hw), generator=torch.Generator().manual_seed(s))
    b = torch.cat([hb, gb])
    if s == 1:
        y = layers.conv_same(x, w, None, (1, 1))
        want = _unfused(y + b.view(-1, 1, 1))
    else:
        y = layers._subpixel_conv(x, w, (2, 2))
        want = _unfused(layers._conv_transpose_subpixel(x, w, b, (2, 2)))
    n, got = launches(lambda: ge.gated_epilogue(y, hb, gb, (s, s)))
    assert n == 1 and got.shape == (3, f, s * hw, s * hw)
    assert got.is_contiguous()
    assert torch.equal(got, want)


def _convhvae(config, hidden=300, z=40, **kw):
    """Config 4 (3-channel continuous 64x64) or Config 3 (gray 28x28) at the
    default conv spec; ``hidden`` / ``z`` at their widths unless cut."""
    size = {4: (3, 64, 64), 3: (1, 28, 28)}[config]
    kind = {4: "continuous", 3: "gray"}[config]
    base = dict(model_name="convhvae_2level", hidden_size=hidden, z1_size=z,
                z2_size=z, input_size=size, input_type=kind,
                dynamic_binarization=False, number_components=12,
                use_pallas_prior=False)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("config", [4, 3])
def test_no_grad_decode_and_encode_equal_the_parent_route(config,
                                                          monkeypatch):
    cfg = _convhvae(config)
    model = create_model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(config)
    c, ih, iw = cfg.input_size
    x = torch.rand((2, ih, iw, c), generator=g)
    z1, z2 = torch.randn((2, 40), generator=g), torch.randn((2, 40),
                                                            generator=g)
    with torch.no_grad():
        n_dec, got_dec = launches(lambda: model.decode(z1, z2))
        n_enc, got_enc = launches(lambda: model.encode_top(x))
        n_cache, got_cache = launches(lambda: model.q_z1_cache(x))
        monkeypatch.setattr(layers._GatedConvBase, "_fused_route",
                            lambda self, x, dt: False)
        n_parent, want = launches(lambda: (model.decode(z1, z2),
                                           model.encode_top(x),
                                           model.q_z1_cache(x)))
    assert (n_dec, n_enc, n_cache, n_parent) == (3, 4, 4, 0)
    for a, r in zip((*got_dec, *got_enc, got_cache),
                    (*want[0], *want[1], want[2])):
        assert a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("cls,k,s", [(layers.GatedConv2d, 3, 1),
                                     (layers.GatedConv2d, 3, 2),
                                     (layers.GatedConvTranspose2d, 3, 2)])
def test_grad_and_bf16_calls_take_the_parent_route(cls, k, s):
    """With a gradient to carry, and in bf16, the layer is its conv with
    the bias, chunk, sigmoid and product, bitwise, gradients included, and
    launches nothing."""
    x = torch.randn((2, 6, 8, 8), generator=torch.Generator().manual_seed(k))
    for dtype in (None, torch.bfloat16):
        layer = cls(6, 5, (k, k), (s, s), dtype=dtype,
                    generator=torch.Generator().manual_seed(s))
        dt = dtype or torch.float32
        w = torch.cat([layer.h_kernel.to(dt), layer.g_kernel.to(dt)], -1)
        b = torch.cat([layer.h_bias.to(dt), layer.g_bias.to(dt)])
        want = _unfused(layer._conv(x.to(dt), w, b, (s, s)))
        n, got = launches(lambda: layer(x))
        assert n == 0 and torch.equal(got, want)
        if dtype is None:
            got.sum().backward()
            grads = [p.grad.clone() for p in layer.parameters()]
            layer.zero_grad()
            want.sum().backward()
            for a, p in zip(grads, layer.parameters()):
                assert torch.equal(a, p.grad)
        else:
            with torch.no_grad():
                n, got = launches(lambda: layer(x))
            assert n == 0 and torch.equal(got, want.detach())
    dense = layers.GatedDense(6, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        n, _ = launches(lambda: dense(torch.randn((3, 6))))
    assert n == 0


def test_grad_mode_with_frozen_params_takes_the_fused_route():
    layer = layers.GatedConv2d(6, 5, (3, 3), (1, 1),
                               generator=torch.Generator().manual_seed(0))
    layer.requires_grad_(False)
    x = torch.randn((2, 6, 8, 8))
    n, _ = launches(lambda: layer(x))
    assert n == 1
    n, _ = launches(lambda: layer(x.requires_grad_()))
    assert n == 0


def test_request_counts_38_and_train_step_none():
    """A score request at reduced rows: 3 decoder layers x 10 rounds plus
    the 4 + 4 encoder layers of encode_top and q_z1_cache once; a train
    step carries gradients through every gated conv and counts none."""
    n = 12
    cfg = _convhvae(4, hidden=16, z=4, z2_size=6, input_size=(3, 16, 16),
                    number_components=n, S=8, MB=4, test_batch_size=4)
    model = create_model(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (n, 16, 16, 3), generator=g,
                        dtype=torch.uint8)
    _, _, score = serve.make_serving_fns(model, cfg, n, 1, 10, 2)
    sub = layers.conv_transpose_same.subpixel
    count, nll = launches(lambda: score(
        raw[:2], torch.randn((n, 6), generator=g),
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        generator=g))
    assert np.isfinite(nll.numpy()).all()
    assert count == 38
    assert layers.conv_transpose_same.subpixel == sub + 20
    bank = Bank(images=raw, data_idx=torch.arange(n, dtype=torch.int32),
                valid=torch.ones(n, dtype=torch.bool), cache_means=None,
                n_effective=n)
    count, (_, aux) = launches(lambda: tsteps.make_train_step(cfg)(
        tsteps.init_train_state(model, cfg), raw[:4],
        torch.arange(4, dtype=torch.int32), bank, 1.0, generator=g))
    assert np.isfinite(float(aux["loss"])) and count == 0


@pytest.mark.parametrize("cls,s", [(layers.GatedConv2d, 1),
                                   (layers.GatedConvTranspose2d, 2)])
def test_export_keeps_the_op_as_one_node_with_its_shape(cls, s):
    layer = cls(6, 5, (3, 3), (s, s),
                generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 6, 7, 7))
    with torch.no_grad():
        program = torch.export.export(layer, (x,))
        want = layer(x)
        n, got = launches(lambda: program.module()(x))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "gated_epilogue" in str(n.target)]
    assert len(nodes) == 1
    assert tuple(nodes[0].meta["val"].shape) == (2, 5, 7 * s, 7 * s)
    assert n == 1 and torch.equal(got, want)


@pytest.mark.parametrize("case", ["dtype", "bias_dtype", "channels_last",
                                  "slice", "channels", "bias", "grad"])
def test_the_wrapper_refuses_what_the_op_does_not_take(case):
    g = torch.Generator().manual_seed(0)
    y = torch.randn((2, 16, 3, 3), generator=g)
    hb, gb = torch.randn((2,), generator=g), torch.randn((2,), generator=g)
    err, phases = ValueError, (2, 2)
    if case == "dtype":
        y, err = y.double(), TypeError
    elif case == "bias_dtype":
        gb, err = gb.double(), TypeError
    elif case == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
    elif case == "slice":
        y = torch.randn((2, 16, 3, 4), generator=g)[..., :3]
    elif case == "channels":
        phases = (3, 1)
    elif case == "bias":
        hb = hb[:1]
    else:
        y, err = y.requires_grad_(), RuntimeError
    before = counter.launches
    with pytest.raises(err):
        ge.gated_epilogue(y, hb, gb, phases)
    assert counter.launches == before
