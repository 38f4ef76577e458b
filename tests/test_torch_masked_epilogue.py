"""The PixelHVAE masked layers' fused epilogue (ops/masked_epilogue.py) and
the teacher-forced stack's two routes (models/pixel_hvae.py), on the CPU.

* the op's plain version is relu((h + b) + ctx) bitwise, in any memory
  format, and counts one launch a call;
* a no-grad fp32 decode takes the fused route: it equals the route that
  carries a gradient (each conv with its bias, the context added in place,
  a ReLU) bitwise, both NCHW-contiguous in fp32; against channels-last
  inputs (x's permuted view, the context a permuted view of the
  NHWC-ordered projection: the bf16 stack's memory format) the CPU's convs
  sum in another order, a few ulps;
* the context map is NCHW-contiguous in fp32 and channels-last in bf16,
  the same values as the NHWC-ordered projection's permuted view;
* ``masked_epilogue.launches`` grows by 1 + pixelcnn_layers a no-grad
  decode, and by 0 on a decode that carries a gradient, in bf16 and in the
  crop sampler;
* the op stays one node under torch.export, its fake kernel giving the
  output's shape; the wrapper refuses what the op does not take.
"""

import pytest
import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.ops import masked_epilogue as me


def _inputs(shape, seed=0, channels_last=False):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(shape, generator=g)
    if channels_last:
        h = h.contiguous(memory_format=torch.channels_last)
    return (h, torch.randn((shape[1],), generator=g),
            torch.randn(shape, generator=g))


@pytest.mark.parametrize("shape,channels_last", [
    ((1, 64, 28, 28), False), ((7, 64, 28, 28), False),
    ((3, 5, 7, 9), False), ((4, 8, 6, 6), True)])
def test_plain_is_the_three_passes_bitwise(shape, channels_last):
    h, b, ctx = _inputs(shape, channels_last=channels_last)
    want = torch.relu((h + b.view(-1, 1, 1)) + ctx)
    before = me.masked_epilogue.launches
    got = me.masked_epilogue(h, b, ctx)
    assert got is h and me.masked_epilogue.launches == before + 1
    assert torch.equal(got, want)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)


def _model(input_type="binary", layers=2, features=8, dtype="float32",
           hw=8):
    cfg = Config(model_name="pixelhvae_2level", prior="exemplar_prior",
                 input_type=input_type, input_size=(1, hw, hw),
                 dynamic_binarization=False, hidden_size=16, z1_size=4,
                 z2_size=6, pixelcnn_features=features,
                 pixelcnn_layers=layers, number_components=8,
                 training_set_size=8, compute_dtype=dtype)
    model = create_model(cfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((5, hw, hw, 1), generator=g)
    if input_type == "binary":
        x = (x < 0.5).float()
    return model, x, torch.randn((5, 4), generator=g), torch.randn(
        (5, 6), generator=g)


@pytest.mark.parametrize("input_type,layers,features,hw", [
    ("binary", 2, 8, 8), ("binary", 4, 64, 28), ("continuous", 3, 8, 12)])
def test_no_grad_decode_equals_the_parent_route_bitwise(input_type, layers,
                                                        features, hw):
    model, x, z1, z2 = _model(input_type, layers, features, hw=hw)
    before = me.masked_epilogue.launches
    with torch.no_grad():
        got = model.decode(x, z1, z2)
        assert me.masked_epilogue.launches == before + 1 + layers
        nchw = x.reshape(x.shape[0], 1, hw, hw)
        want = model._stack(nchw, model._ctx(z1, z2))
        # channels-last inputs: x's permuted view and the context a
        # permuted view of the NHWC-ordered projection
        ctx = model.ctx_proj(torch.cat([z1, z2], -1)).reshape(
            x.shape[0], hw, hw, features).permute(0, 3, 1, 2)
        parent = model._stack(x.permute(0, 3, 1, 2), ctx)
    trained = model.decode(x, z1, z2)
    assert me.masked_epilogue.launches == before + 1 + layers
    for a, w, t, p in zip(got, want, trained, parent):
        if w is not None:
            assert a.is_contiguous()
            assert torch.equal(a, w.permute(0, 2, 3, 1))
            assert torch.equal(a, t.detach())
            torch.testing.assert_close(a, p.permute(0, 2, 3, 1), rtol=2e-6,
                                       atol=1e-6)


def test_the_context_map_written_nchw_is_the_permuted_view_bitwise():
    model, _, z1, z2 = _model(features=8, hw=12)
    with torch.no_grad():
        got = model._ctx(z1, z2)
        want = model.ctx_proj(torch.cat([z1, z2], -1)).reshape(
            5, 12, 12, 8).permute(0, 3, 1, 2)
    assert got.shape == (5, 8, 12, 12) and got.is_contiguous()
    assert torch.equal(got, want)


def test_the_bf16_context_map_is_the_channels_last_view_bitwise():
    model, x, z1, z2 = _model(features=8, hw=12, dtype="bfloat16")
    got = model._ctx(z1, z2)
    want = model.ctx_proj(torch.cat([z1, z2], -1)).reshape(
        5, 12, 12, 8).permute(0, 3, 1, 2)
    assert got.dtype == torch.bfloat16 and got.requires_grad
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_launches_count_the_fused_route_only():
    model, x, z1, z2 = _model(layers=3)
    counter = me.masked_epilogue

    def launches(fn):
        before = counter.launches
        fn()
        return counter.launches - before

    assert launches(lambda: model.decode(x, z1, z2)) == 0     # params train
    with torch.no_grad():
        assert launches(lambda: model.decode(x, z1, z2)) == 4
    model.requires_grad_(False)
    assert launches(lambda: model.decode(x, z1, z2)) == 4     # nothing flows
    assert launches(lambda: model.decode(x, z1.requires_grad_(), z2)) == 0
    assert launches(lambda: model.generate_from_top(
        z2, generator=torch.Generator().manual_seed(0))) == 0
    bf16, x, z1, z2 = _model(layers=3, dtype="bfloat16")
    with torch.no_grad():
        assert launches(lambda: bf16.decode(x, z1, z2)) == 0


def test_export_keeps_the_op_as_one_node_with_its_shape():
    class Layer(torch.nn.Module):
        def forward(self, h, bias, ctx):
            return me.masked_epilogue(h.clone(), bias, ctx) * 2.0

    h, b, ctx = _inputs((3, 4, 5, 6))
    program = torch.export.export(Layer(), (h, b, ctx))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "masked_epilogue" in str(n.target)]
    assert len(nodes) == 1
    (out,) = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    assert tuple(out.meta["val"].shape) == (3, 4, 5, 6)
    want = 2.0 * torch.relu((h + b.view(-1, 1, 1)) + ctx)
    assert torch.equal(program.module()(h, b, ctx), want)


@pytest.mark.parametrize("case", ["shape", "bias", "dtype", "grad"])
def test_the_wrapper_refuses_what_the_op_does_not_take(case):
    h, b, ctx = _inputs((2, 4, 3, 3))
    err = ValueError
    if case == "shape":
        ctx = ctx[:1]
    elif case == "bias":
        b = b[:3]
    elif case == "dtype":
        h, err = h.double(), TypeError
    else:
        b, err = b.requires_grad_(), RuntimeError
    before = me.masked_epilogue.launches
    with pytest.raises(err):
        me.masked_epilogue(h, b, ctx)
    assert me.masked_epilogue.launches == before
