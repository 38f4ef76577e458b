"""The port's spans and its re-encode counter, on the CPU at a tiny size.

* ``span`` is one shared null context while no profiler runs, and a
  ``record_function`` range while one does;
* one approximate-prior step of a ConvHVAE (raw uint8 bank) and one
  exact-prior step of a VAE emit the layers' spans, nested as the layers
  are: ``evae.prior.knn``, ``evae.prior.reencode`` and ``evae.prior.lse``
  under ``evae.step.forward``, which, with ``evae.step.inputs``,
  ``evae.step.backward`` and ``evae.step.optimizer``, lies under
  ``evae.step``; the epoch loop's row gather is an ``evae.step.inputs``
  before the step, and the epoch's bank and the cache refresh have theirs;
* one IWAE chunk emits ``evae.iwae.chunk`` over ``evae.iwae.encode`` and
  one ``evae.iwae.round`` a round, each over ``evae.iwae.decode`` and
  ``evae.prior.lse`` side by side; the eval bank has ``evae.eval_bank``;
* the backward functions of the re-encode's operators carry the autograd
  sequence numbers of forward operators inside ``evae.prior.reencode``
  (what a reader uses to give a forward span its backward time);
* the steps' losses, every gradient and the parameters after them, and an
  IWAE chunk's NLLs, are bitwise the same with the profiler on and off;
* ``approx_log_p_top.rows`` grows by B*K a step, and the selections, with
  the count before each, are kept only while a profiler runs;
* a serving bundle exported under a profiler holds no profiler operator in
  its programs' graphs.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.train import profiling
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.evaluation import (make_eval_bank_fn,
                                                     make_iwae_fn)
from exemplar_vae_tpu_torch.train.loss import Bank, approx_log_p_top

N, B, K = 24, 6, 3
CONV = dict(conv_enc_spec="4k3s1,4k3s2", conv_dec_spec="t4k3s2,c4k3s1",
            conv_proj_channels=4)
CPU = torch.autograd.DeviceType.CPU


def _cfg(mode):
    """``approximate``: a ConvHVAE on 3-channel uint8, the kNN prior
    (per-row support, K = 3); ``exact``: a VAE on binary input, the exact
    prior through the pairwise-LSE op."""
    if mode == "approximate":
        return Config(model_name="convhvae_2level", prior="exemplar_prior",
                      input_type="continuous", input_size=(3, 8, 8),
                      dynamic_binarization=False, hidden_size=16, z1_size=4,
                      z2_size=6, number_components=N, training_set_size=N,
                      batch_size=B, approximate_prior=True, approximate_k=K,
                      exact_reencode_chunk=0, **CONV)
    return Config(model_name="vae", prior="exemplar_prior",
                  input_type="binary", input_size=(1, 8, 8),
                  dynamic_binarization=True, hidden_size=16, z1_size=4,
                  number_components=N, training_set_size=N, batch_size=B,
                  use_pallas_prior=True, exact_reencode_chunk=10,
                  exact_remat=False)


def _data(cfg):
    c, h, w = cfg.input_size
    rng = np.random.default_rng(1)
    if cfg.input_type == "continuous":
        x = rng.integers(0, 256, (N, h, w, c), dtype=np.uint8)
    else:
        x = rng.random((N, h, w, c)).astype(np.float32)
    return torch.from_numpy(x)


class _Run:
    """A model of ``mode``, its train state, data, bank and epoch function,
    from fixed seeds."""

    def __init__(self, mode):
        self.cfg = cfg = _cfg(mode)
        self.model = create_model(cfg, device="cpu", seed=3)
        self.state = tsteps.init_train_state(self.model, cfg)
        self.train_x = _data(cfg)
        self.train_idx = torch.arange(N, dtype=torch.int32)
        self.bank = Bank(images=self.train_x, data_idx=self.train_idx,
                         valid=torch.ones(N, dtype=torch.bool),
                         cache_means=None, n_effective=N)
        self.refresh = None
        if cfg.approximate_prior:
            self.refresh = tsteps.make_cache_refresh(self.model, cfg)
            self.bank = self.bank._replace(
                cache_means=self.refresh(self.train_x))
        self.epoch_fn = tsteps.make_epoch_fn(cfg)

    def epoch(self, steps=1, seed=5):
        perm = torch.randperm(N, generator=torch.Generator().manual_seed(
            seed))[:steps * B].reshape(steps, B)
        self.state, metrics = self.epoch_fn(
            self.state, self.train_x, self.train_idx, perm, self.bank, 1.0,
            generator=torch.Generator().manual_seed(seed + 1))
        return metrics


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.device_type == CPU]


def _spans(events):
    return [e for e in events if e.name.startswith("evae.")]


def _parent(span, spans):
    """The name of the innermost other span that holds ``span`` on its
    thread, or None."""
    s, e = span.time_range.start, span.time_range.end
    around = [o for o in spans if o is not span and o.thread == span.thread
              and o.time_range.start <= s and e <= o.time_range.end]
    if not around:
        return None
    return min(around, key=lambda o: o.time_range.end
               - o.time_range.start).name


def _parents(spans) -> dict:
    out = {}
    for sp in spans:
        out.setdefault(sp.name, set()).add(_parent(sp, spans))
    return out


def _counts(spans) -> dict:
    out = {}
    for sp in spans:
        out[sp.name] = out.get(sp.name, 0) + 1
    return out


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not profiling.profiler_active()
    a, b = profiling.span("evae.a"), profiling.span("evae.b")
    assert a is b is profiling._NULL
    with a, b:                               # reusable, nestable
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.profiler_active()
        inside = profiling.span("evae.a")
        assert inside is not profiling._NULL
        assert isinstance(inside, torch.profiler.record_function)
    assert profiling.span("evae.a") is profiling._NULL


@pytest.mark.parametrize("mode", ["approximate", "exact"])
def test_a_train_step_emits_the_layers_spans_nested(mode):
    run = _Run(mode)
    _, events = _profiled(lambda: run.epoch(steps=2))
    spans = _spans(events)
    counts, parents = _counts(spans), _parents(spans)
    step = "evae.step"
    assert counts[step] == 2 and parents[step] == {None}
    assert counts["evae.epoch.bank"] == 1
    assert parents["evae.epoch.bank"] == {None}
    # the epoch loop's row gather before the step, then the step's draws
    # and preprocessing inside it
    assert counts["evae.step.inputs"] == 4
    assert parents["evae.step.inputs"] == {None, step}
    for name in ("evae.step.forward", "evae.step.backward",
                 "evae.step.optimizer"):
        assert parents[name] == {step}, name
    assert counts["evae.step.forward"] == counts["evae.step.backward"] == 2
    prior = ({"evae.prior.knn", "evae.prior.reencode", "evae.prior.lse"}
             if mode == "approximate" else
             {"evae.prior.reencode", "evae.prior.lse"})
    for name in prior:
        assert counts[name] == 2 and parents[name] == {"evae.step.forward"}
    assert set(counts) == prior | {step, "evae.epoch.bank", "evae.step.inputs",
                                   "evae.step.forward", "evae.step.backward",
                                   "evae.step.optimizer"}
    # a step called alone opens its own evae.step
    x, idx = run.train_x[:B], run.train_idx[:B]
    _, events = _profiled(lambda: tsteps.make_train_step(run.cfg)(
        run.state, x, idx, run.bank, 1.0,
        generator=torch.Generator().manual_seed(0)))
    spans = _spans(events)
    assert _counts(spans)[step] == 1
    assert _parents(spans)["evae.step.forward"] == {step}
    if run.refresh is not None:
        _, events = _profiled(lambda: run.refresh(run.train_x))
        assert _counts(_spans(events)) == {"evae.cache_refresh": 1}


@pytest.mark.parametrize("mode", ["approximate", "exact"])
def test_an_iwae_chunk_emits_a_round_span_per_round(mode):
    run = _Run(mode)
    model = run.model.eval()
    _, events = _profiled(lambda: make_eval_bank_fn(model, run.cfg)(
        run.bank._replace(cache_means=None)))
    assert _counts(_spans(events)) == {"evae.eval_bank": 1}
    bank = make_eval_bank_fn(model, run.cfg)(run.bank._replace(
        cache_means=None))
    iwae = make_iwae_fn(model, run.cfg)
    rounds = 3
    _, events = _profiled(lambda: iwae.chunk_nll(
        run.train_x[:4], bank, rounds, 2,
        generator=torch.Generator().manual_seed(2)))
    spans = _spans(events)
    assert _counts(spans) == {"evae.iwae.chunk": 1, "evae.iwae.encode": 1,
                              "evae.iwae.round": rounds,
                              "evae.iwae.decode": rounds,
                              "evae.prior.lse": rounds}
    parents = _parents(spans)
    assert parents["evae.iwae.chunk"] == {None}
    assert parents["evae.iwae.encode"] == {"evae.iwae.chunk"}
    assert parents["evae.iwae.round"] == {"evae.iwae.chunk"}
    assert parents["evae.iwae.decode"] == {"evae.iwae.round"}
    assert parents["evae.prior.lse"] == {"evae.iwae.round"}


def test_the_reencode_s_backward_carries_its_forward_sequence_numbers():
    run = _Run("approximate")
    _, events = _profiled(lambda: run.epoch(steps=1))
    reencode = [e for e in events if e.name == "evae.prior.reencode"]
    assert len(reencode) == 1
    r = reencode[0]
    backward = [e for e in events if e.name.startswith(
        "autograd::engine::evaluate_function: ") and e.sequence_nr >= 0]
    inside = {(e.thread, e.sequence_nr) for e in events
              if e.sequence_nr >= 0 and e.thread == r.thread
              and not e.name.startswith("evae.")
              and e not in backward
              and r.time_range.start <= e.time_range.start
              and e.time_range.end <= r.time_range.end}
    linked = [e.name for e in backward
              if (e.fwd_thread, e.sequence_nr) in inside]
    assert any("ConvolutionBackward0" in n for n in linked), linked
    # and none of the encoder's backward falls outside the forward ops
    # that ran anywhere in the step
    forward = {(e.thread, e.sequence_nr) for e in events
               if e.sequence_nr >= 0 and e not in backward
               and "Backward" not in e.name}
    assert all((e.fwd_thread, e.sequence_nr) in forward for e in backward)


@pytest.mark.parametrize("mode", ["approximate", "exact"])
def test_outputs_are_bitwise_equal_with_the_profiler_on_and_off(mode):
    off, on = _Run(mode), _Run(mode)
    m_off = off.epoch(steps=2)
    m_on, _ = _profiled(lambda: on.epoch(steps=2))
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for (name, p), q in zip(off.model.named_parameters(),
                            on.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name

    def nll(run):
        model = run.model.eval()
        bank = make_eval_bank_fn(model, run.cfg)(run.bank._replace(
            cache_means=None))
        return make_iwae_fn(model, run.cfg).chunk_nll(
            run.train_x[:4], bank, 2, 3,
            generator=torch.Generator().manual_seed(4))

    want = nll(off)
    got, _ = _profiled(lambda: nll(on))
    assert torch.equal(want, got)


def test_the_rows_counter_and_the_kept_selections():
    run = _Run("approximate")
    approx_log_p_top.kept.clear()
    before = approx_log_p_top.rows
    run.epoch(steps=2)
    assert approx_log_p_top.rows - before == 2 * B * K
    assert len(approx_log_p_top.kept) == 0
    before = approx_log_p_top.rows
    _profiled(lambda: run.epoch(steps=2, seed=8))
    grew = approx_log_p_top.rows - before
    kept = list(approx_log_p_top.kept)
    assert grew == 2 * B * K and len(kept) == 2
    # each call's count before it, and its (B, K) selection
    assert [n for n, _ in kept] == [before, before + B * K]
    assert all(tuple(s.shape) == (B, K) for _, s in kept)
    assert all(0 <= int(s.min()) and int(s.max()) < N for _, s in kept)
    approx_log_p_top.kept.clear()


def test_a_bundle_exported_under_a_profiler_holds_no_profiler_operator(
        tmp_path):
    from exemplar_vae_tpu_torch.serve import (ServingBundle,
                                              export_serving_bundle)
    run = _Run("exact")
    model = run.model.eval()
    bank = make_eval_bank_fn(model, run.cfg)(run.bank._replace(
        cache_means=None))
    _profiled(lambda: export_serving_bundle(
        model, run.cfg, str(tmp_path), bank_means=bank.cache_means,
        data_idx=bank.data_idx, valid=bank.valid, n_effective=N, n_gen=3,
        ref_batch=2, score_chunk=4, s_total=6, r=3))
    b = ServingBundle.load(str(tmp_path), device="cpu")
    assert set(b.programs) == {"generate", "reference_generate", "score_nll"}
    for name, program in b.programs.items():
        targets = [str(n.target) for gm in program.module.modules()
                   if isinstance(gm, torch.fx.GraphModule)
                   for n in gm.graph.nodes if n.op == "call_function"]
        assert targets, name
        assert not [t for t in targets if "profiler" in t
                    or "record_function" in t], name
