"""The PixelHVAE's decoder spans and its masked-stack row counter, under
torch.profiler on the CPU at a tiny size.

* each round of one IWAE chunk opens ``evae.pixelcnn.context`` and
  ``evae.pixelcnn.stack`` once, inside that round's ``evae.iwae.decode``;
* ``masked_stack.rows`` grows by t * r a round, and while a profiler runs
  ``masked_stack.kept`` keeps each call's count before it and the model's
  Config;
* with no profiler running, and with one, the NLLs are bitwise those of
  the decode without spans or counter.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model, pixel_hvae
from exemplar_vae_tpu_torch.train.evaluation import (make_eval_bank_fn,
                                                     make_iwae_fn)
from exemplar_vae_tpu_torch.train.loss import Bank

N, T, R, ROUNDS = 24, 3, 4, 3
CPU = torch.autograd.DeviceType.CPU


def _run():
    cfg = Config(model_name="pixelhvae_2level", prior="exemplar_prior",
                 input_type="binary", input_size=(1, 8, 8),
                 dynamic_binarization=False, hidden_size=16, z1_size=4,
                 z2_size=6, pixelcnn_features=4, pixelcnn_layers=2,
                 number_components=N, training_set_size=N,
                 use_pallas_prior=True, exact_reencode_chunk=10)
    model = create_model(cfg, device="cpu", seed=3).eval()
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((N, 8, 8, 1), generator=g) < 0.5).float()
    bank = make_eval_bank_fn(model, cfg)(Bank(
        images=x, data_idx=torch.arange(N, dtype=torch.int32),
        valid=torch.ones(N, dtype=torch.bool), cache_means=None,
        n_effective=N))
    iwae = make_iwae_fn(model, cfg)

    def nll():
        return iwae.chunk_nll(x[:T], bank, ROUNDS, R,
                              generator=torch.Generator().manual_seed(4))
    return model, nll


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.device_type == CPU
                 and e.name.startswith("evae.")]


def _inside(span, spans, name):
    """The ``name`` spans on ``span``'s thread that hold it."""
    s, e = span.time_range.start, span.time_range.end
    return [o for o in spans if o.name == name and o.thread == span.thread
            and o.time_range.start <= s and e <= o.time_range.end]


def test_each_round_opens_the_context_and_the_stack_inside_its_decode():
    _, nll = _run()
    _, spans = _profiled(nll)
    decodes = [sp for sp in spans if sp.name == "evae.iwae.decode"]
    assert len(decodes) == ROUNDS
    for name in ("evae.pixelcnn.context", "evae.pixelcnn.stack"):
        mine = [sp for sp in spans if sp.name == name]
        assert len(mine) == ROUNDS, name
        for sp in mine:
            assert len(_inside(sp, spans, "evae.iwae.decode")) == 1, name
    for d in decodes:
        held = {sp.name for sp in spans if _inside(sp, [d], d.name)}
        assert {"evae.pixelcnn.context", "evae.pixelcnn.stack"} <= held
    # the context before the stack in every round
    order = [sp.name for sp in sorted(spans, key=lambda e: e.time_range.start)
             if sp.name.startswith("evae.pixelcnn.")]
    assert order == ["evae.pixelcnn.context", "evae.pixelcnn.stack"] * ROUNDS


def test_the_rows_counter_grows_by_t_r_a_round():
    model, nll = _run()
    counter = pixel_hvae.masked_stack
    counter.kept.clear()
    before = counter.rows
    nll()
    assert counter.rows - before == ROUNDS * T * R
    assert len(counter.kept) == 0
    before = counter.rows
    _profiled(nll)
    assert counter.rows - before == ROUNDS * T * R
    kept = list(counter.kept)
    assert [n for n, _ in kept] == [before + i * T * R for i in range(ROUNDS)]
    assert all(cfg is model.cfg for _, cfg in kept)
    counter.kept.clear()


def _decode_without_spans(self, x, z1, z2):
    fused = self._fused_route(x, z1, z2)
    mean, logvar = self._teacher_forced(x, self._ctx(z1, z2), fused)
    return mean.permute(0, 2, 3, 1), logvar.permute(0, 2, 3, 1)


@pytest.mark.parametrize("profiled", [False, True])
def test_the_nlls_are_bitwise_those_without_spans(profiled, monkeypatch):
    _, nll = _run()
    got = _profiled(nll)[0] if profiled else nll()
    monkeypatch.setattr(pixel_hvae.PixelHVAE, "decode", _decode_without_spans)
    monkeypatch.setattr(pixel_hvae.PixelHVAE, "decode_x",
                        _decode_without_spans)
    want = nll()
    assert torch.equal(got, want)
    pixel_hvae.masked_stack.kept.clear()
