"""The ConvHVAE's conv memory format, chosen once at the model's boundary
by the compute dtype (models/layers.py::nchw_for), on the CPU, for
Config 4's shapes (C = 3 continuous, here at 16x16) and Config 3's (C = 1
gray at 28x28), at tiny dense widths:

* an fp32 train step of the approximate prior carries a gradient through
  15 gated convs, each counted in ``gated_conv.grad_nchw`` (4 + 4 of
  q(z2|x) over the batch and over its B*K neighbours, 4 of q(z1|x,z2), 3 of
  the decoder), each input and output NCHW-contiguous, with NCHW strides
  where C is 1;
* its loss and every parameter's gradient equal those of the channels-last
  route (``layers.channels_last`` patched to True) to the convs' fp32
  rounding: the CPU's convs sum in another order per memory format (the
  gradients part by up to ~6e-5 of a leaf's largest; one route on 4
  threads against 1 already by up to ~1.4e-5);
* a bf16 step counts none and keeps every gated conv channels-last;
* a no-grad fp32 score request counts ``gated_epilogue.launches`` 38 and
  ``gated_conv.grad_nchw`` 0, and its NLLs are bitwise those of a
  channels-last boundary whose first gated layer copies its input NCHW
  (the route before the boundary chose the format);
* the fused route refuses input that is not NCHW-contiguous;
* an fp32 likelihood head with a gradient to carry over NCHW input runs
  its forward as one GEMM: its output and input gradient are bitwise the
  same on 1 and on 4 CPU threads (the NCHW 1x1 conv's output is not), and
  its output and gradients equal the conv's to fp32 rounding.
"""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch import serve
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import conv_hvae, create_model, layers
from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank

N, B, K = 12, 4, 3
SHAPES = {4: ((3, 16, 16), "continuous"), 3: ((1, 28, 28), "gray")}


def _cfg(config, dtype="float32"):
    size, kind = SHAPES[config]
    return Config(model_name="convhvae_2level", hidden_size=16, z1_size=4,
                  z2_size=6, input_size=size, input_type=kind,
                  dynamic_binarization=False, number_components=N,
                  prior="exemplar_prior", approximate_prior=True,
                  approximate_k=K, approximate_support="per_row",
                  use_pallas_prior=False, compute_dtype=dtype, S=8, MB=4,
                  test_batch_size=4)


def _data(cfg):
    c, h, w = cfg.input_size
    g = torch.Generator().manual_seed(c)
    raw = torch.randint(0, 256, (N, h, w, c), generator=g, dtype=torch.uint8)
    bank = Bank(images=raw, data_idx=torch.arange(N, dtype=torch.int32),
                valid=torch.ones(N, dtype=torch.bool),
                cache_means=torch.randn((N, cfg.z2_size), generator=g),
                n_effective=N)
    return raw, bank


def _step(cfg):
    """One train step from seed-0 weights, the decoder's log-scale head
    started at -4 (a trained model's range: at scale ~1 a 1/256 bin's mass
    is the difference of two sigmoids near 0.5, whose rounding moves the
    gradients by ~1e-4 relative): (loss, {name: grad}, count, [(gated conv
    input, output)])."""
    model = create_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.p_x_logvar_head.bias -= 4.0      # narrow bins, as trained
    seen = []
    for m in model.modules():
        if isinstance(m, layers._GatedConvBase):
            m.register_forward_hook(
                lambda m, args, out: seen.append((args[0], out)))
    raw, bank = _data(cfg)
    before = layers.gated_conv.grad_nchw
    _, aux = tsteps.make_train_step(cfg)(
        tsteps.init_train_state(model, cfg), raw[:B],
        torch.arange(B, dtype=torch.int32), bank, 1.0,
        generator=torch.Generator().manual_seed(1))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return (float(aux["loss"]), grads, layers.gated_conv.grad_nchw - before,
            seen)


def _nchw_strides(t):
    n, c, h, w = t.shape
    return t.stride() == (c * h * w, h * w, w, 1)


@pytest.mark.parametrize("config", [4, 3])
def test_fp32_step_counts_15_nchw_gated_convs(config):
    _, _, count, seen = _step(_cfg(config))
    assert count == 15 and len(seen) == 15
    for x, y in seen:
        assert x.is_contiguous() and _nchw_strides(x)
        assert y.is_contiguous() and _nchw_strides(y)
    assert seen[0][0].shape[1] == SHAPES[config][0][0]


@pytest.mark.parametrize("config", [4, 3])
def test_fp32_step_equals_the_channels_last_route(config, monkeypatch):
    cfg = _cfg(config)
    loss, grads, _, _ = _step(cfg)
    monkeypatch.setattr(layers, "channels_last", lambda cfg: True)
    want_loss, want, count, seen = _step(cfg)
    assert count == 0
    assert all(not _nchw_strides(x) for x, _ in seen)
    assert grads.keys() == want.keys() and len(grads) > 30
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for name, g in grads.items():
        r = want[name]
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=2e-4 * float(r.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("config", [4, 3])
def test_bf16_step_counts_none_and_stays_channels_last(config):
    _, _, count, seen = _step(_cfg(config, "bfloat16"))
    assert count == 0 and len(seen) == 15
    for x, y in seen:
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert not _nchw_strides(x)


def _request(cfg):
    model = create_model(cfg, device="cpu", seed=0)
    raw, bank = _data(cfg)
    _, _, score = serve.make_serving_fns(model, cfg, N, 1, 10, 2)
    g = torch.Generator().manual_seed(2)
    launches, grad_nchw = ge.gated_epilogue.launches, \
        layers.gated_conv.grad_nchw
    nll = score(raw[:2], bank.cache_means, bank.data_idx, bank.valid,
                generator=g)
    return (nll, ge.gated_epilogue.launches - launches,
            layers.gated_conv.grad_nchw - grad_nchw)


@pytest.mark.parametrize("config", [4, 3])
def test_score_request_is_bitwise_the_channels_last_boundary(config,
                                                            monkeypatch):
    cfg = _cfg(config)
    nll, launches, grad_nchw = _request(cfg)
    assert (launches, grad_nchw) == (38, 0)
    assert np.isfinite(np.asarray(nll)).all()
    monkeypatch.setattr(conv_hvae, "nchw_for",
                        lambda x, cfg: x.permute(0, 3, 1, 2))
    forward = layers._GatedConvBase.forward
    monkeypatch.setattr(layers._GatedConvBase, "forward", lambda self, x:
                        forward(self, x.contiguous().flatten().view(x.shape)))
    want, launches, grad_nchw = _request(cfg)
    assert (launches, grad_nchw) == (38, 0)
    assert torch.equal(torch.as_tensor(nll), torch.as_tensor(want))


@pytest.mark.parametrize("s", [1, 2])
def test_the_fused_route_refuses_channels_last_input(s):
    cls = layers.GatedConv2d if s == 1 else layers.GatedConvTranspose2d
    layer = cls(6, 5, (3, 3), (s, s),
                generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 6, 7, 7)).contiguous(memory_format=torch.channels_last)
    before = ge.gated_epilogue.launches
    with torch.no_grad(), pytest.raises(ValueError, match="NCHW"):
        layer(x)
    assert ge.gated_epilogue.launches == before


@pytest.mark.parametrize("c_in,c_out,hw", [(32, 3, 16), (32, 1, 28)])
def test_fp32_head_with_a_gradient_is_one_gemm_whatever_the_threads(
        c_in, c_out, hw):
    g = torch.Generator().manual_seed(c_out)
    head = layers.GemmConv(c_in, c_out, generator=g)
    with torch.no_grad():
        head.bias.normal_(generator=g)
    x0 = torch.randn((4, c_in, hw, hw), generator=g)
    dy = torch.randn((4, c_out, hw, hw), generator=g)

    def run(threads):
        x = x0.clone().requires_grad_()
        head.zero_grad()
        torch.set_num_threads(threads)
        try:
            y = head(x)
            y.backward(dy)
        finally:
            torch.set_num_threads(default)
        return y.detach(), x.grad, head.kernel.grad, head.bias.grad

    default = torch.get_num_threads()
    one, four = run(1), run(4)
    assert torch.equal(one[0], four[0]) and torch.equal(one[1], four[1])
    for a, b in zip(one[2:], four[2:]):     # sums over B*H*W, split by threads
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    x = x0.clone().requires_grad_()
    head.zero_grad()
    want = layers.Conv.forward(head, x)     # the conv, with its autograd
    want.backward(dy)
    torch.testing.assert_close(one[0], want.detach(), rtol=1e-5, atol=1e-5)
    for a, b in zip(one[1:], (x.grad, head.kernel.grad, head.bias.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
