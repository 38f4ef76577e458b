"""Tests that need a CUDA card: the port's kernels against their plain
versions on the card, the prior's gradients through the kernel, the
serving path through them at a small size, the two-level models, the
approximate prior and the augmentation on the card against the CPU, and a
checkpoint round trip on the card.

They are marked ``cuda`` and skip without a card. This file imports no JAX,
so it also runs where JAX is absent (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: rtol 1e-5 / atol 1e-4. The kernel's three TF32 products keep
fp32 accuracy (the dropped lo.lo term is ~2^-22 relative) and both sides sum
in another order (bf16 inputs are rounded identically on both sides, and
their products are exact); |z|^2 + |mu|^2 - 2 z.mu cancels, so the error
scales with the norms (~80 at D = 40, a few ulps of 7.6e-6), not with an
LSE that may lie near 0.

Gradients through the kernel: the backward recomputes the logits with fp32
torch GEMMs (TF32 off) and divides by the kernel's LSE, which differs from
the scan's by up to ~2e-5; that scales each row's weights by 1 +- 2e-5, so
each gradient tensor is held within GRAD_REL = 1e-4 of its largest element.
"""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch.ops import pairwise_lse as tpl

RTOL, ATOL = 1e-5, 1e-4
GRAD_REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from exemplar_vae_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _inputs(dev, b, n, d, loo, seed=0, scale=1.0, minus_one=()):
    """``scale`` multiplies z and means (norms ~scale*sqrt(d)); the exemplar
    indices in the slice ``minus_one`` become -1, which rows without
    data_idx match (NO_LOO_IDX)."""
    rng = np.random.default_rng(seed)
    means = (scale * rng.normal(size=(n, d))).astype(np.float32)
    own = rng.integers(0, n, b)
    z = (means[own] + 0.5 * scale * rng.normal(size=(b, d))).astype(np.float32)
    ex = (np.arange(n) * 3 + 1).astype(np.int32)
    if minus_one:
        ex[slice(*minus_one)] = -1
    valid = rng.random(n) >= 0.05
    didx = ex[own] if loo else None
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(dev)
    return (t(z), t(means), torch.tensor(-0.3, device=dev), t(didx), t(ex),
            t(valid))


_LARGE = 10 / np.sqrt(40)   # |z|, |mu| ~ 10 at D = 40


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,loo,in_dtype,extra", [
    (1, 300, 8, True, torch.float32, {}),
    (130, 1000, 40, False, torch.bfloat16, {}),
    (257, 513, 128, True, torch.float32, {}),  # widest D: >48 KB shared memory
    (96, 700, 128, False, torch.bfloat16, {}),
    (64, 65, 3, True, torch.float32, {}),      # odd D, one column past a tile
    (70, 300, 41, True, torch.float32, {}),    # D padded to the MMA depth
    (70, 300, 41, False, torch.bfloat16, {}),
    (5, 64, 40, False, torch.float32, {}),     # N exactly one tile
    (33, 10, 40, True, torch.float32, {}),     # N below one tile
    (9, 10, 40, False, torch.bfloat16, {}),
    (63, 500, 40, True, torch.float32, {}),    # around the 64-row m-tiles
    (65, 500, 40, False, torch.float32, {}),
    # one tile holds index -1 (compared, masked for every row), the others
    # are not compared
    (200, 300, 40, False, torch.float32, {"minus_one": (70, 75)}),
    (200, 300, 40, False, torch.bfloat16, {"minus_one": (70, 75)}),
    # large norms stress the cancellation of the 3xTF32 split
    (500, 2000, 40, False, torch.float32, {"scale": _LARGE}),
    (500, 2000, 40, True, torch.float32, {"scale": _LARGE}),
    (3000, 50_000, 40, True, torch.bfloat16, {}),
    # Config 4's bank of 200 000: the IWAE round and a validation batch; a
    # rank's shard of Config 1's bank on a mesh of 2, with LOO
    (5000, 200_000, 40, False, torch.float32, {}),
    (5000, 200_000, 40, False, torch.bfloat16, {}),
    (100, 200_000, 40, False, torch.float32, {}),
    (100, 200_000, 40, False, torch.bfloat16, {}),
    (100, 25_000, 40, True, torch.float32, {}),
])
def test_kernel_matches_plain(dev, b, n, d, loo, in_dtype, extra):
    args = _inputs(dev, b, n, d, loo, **extra)
    before = tpl.pairwise_lse.launches
    got = tpl.pairwise_lse(*args, in_dtype=in_dtype)
    torch.cuda.synchronize()
    assert tpl.pairwise_lse.launches == before + 1
    want = tpl.pairwise_lse_plain(*args, in_dtype=in_dtype)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("loo", [False, True])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_op_cuda_kernel_matches_plain(dev, loo, in_dtype):
    """torch.ops.exemplar_vae_tpu_torch.pairwise_lse (the custom op that
    the serving programs call) launches the kernel once on CUDA tensors."""
    args = _inputs(dev, 100, 50_000, 40, loo)
    before = tpl.pairwise_lse.launches
    got = torch.ops.exemplar_vae_tpu_torch.pairwise_lse(*args, in_dtype, 2048)
    torch.cuda.synchronize()
    assert tpl.pairwise_lse.launches == before + 1
    want = tpl.pairwise_lse_plain(*args, in_dtype=in_dtype)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_fully_masked_row(dev):
    z, means, lv, _, ex, _ = _inputs(dev, 2, 5, 8, False)
    valid = torch.tensor([False, False, False, True, False], device=dev)
    didx = torch.stack([ex[3], ex[1]]).to(torch.int32)
    got = tpl.pairwise_lse(z, means, lv, didx, ex, valid)
    want = tpl.pairwise_lse_plain(z, means, lv, didx, ex, valid)
    assert got[0] <= 0.5 * tpl.NEG_INF and want[0] <= 0.5 * tpl.NEG_INF
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    z, means, lv, didx, ex, valid = _inputs(dev, 4, 70, 129, True)
    with pytest.raises(ValueError, match="D <= 128"):
        tpl.pairwise_lse(z, means, lv, didx, ex, valid)
    z, means, lv, didx, ex, valid = _inputs(dev, 4, 70, 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        tpl.pairwise_lse(z, torch.cat([means, means], 1)[:, ::2], lv, didx,
                         ex, valid)
    with pytest.raises(RuntimeError, match="forward-only"):
        tpl.pairwise_lse(z.requires_grad_(), means, lv, didx, ex, valid)
    with pytest.raises(ValueError, match="different devices"):
        tpl.pairwise_lse(z.detach(), means.cpu(), lv, didx, ex, valid)


@pytest.mark.cuda
def test_prior_gradients_through_kernel_match_scan(dev):
    """exemplar_log_prob at the train shape (B = 100, N = 50 000, D = 40,
    LOO): the kernel forward and the scan forward give the same gradients
    in z, means and log_var through the shared backward, one launch."""
    from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
    z, means, _, didx, ex, valid = _inputs(dev, 100, 50_000, 40, True)
    g = torch.randn(100, device=dev, generator=torch.Generator(dev).manual_seed(1))
    grads = {}
    for impl in ("pallas", "scan"):
        leaves = [t.clone().requires_grad_() for t in
                  (z, means, torch.tensor(-0.3, device=dev))]
        before = tpl.pairwise_lse.launches
        out = exemplar_log_prob(*leaves[:2], leaves[2],
                                log_denom=float(np.log(49_999.0)),
                                data_idx=didx, exemplar_idx=ex, valid=valid,
                                impl=impl)
        (g * out).sum().backward()
        assert tpl.pairwise_lse.launches == before + (impl == "pallas")
        grads[impl] = [t.grad for t in leaves]
    for name, a, b in zip(("dz", "dmu", "dlogvar"), *grads.values()):
        assert bool(torch.isfinite(a).all()), name
        err = float((a - b).abs().max())
        assert err <= GRAD_REL * float(b.abs().max()), (name, err)


@pytest.mark.cuda
def test_small_serving_path_runs_the_kernel(dev):
    """score_nll on the card through the kernel equals the scan prior with
    the same noise; one launch per round."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.serve import make_serving_fns
    from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
    from exemplar_vae_tpu_torch.train.loss import Bank

    cfg = Config(hidden_size=32, z1_size=8, S=16, MB=8)
    model = create_model(cfg, device=dev, seed=1)
    rng = np.random.default_rng(0)
    bank_x = (rng.random((300, 28, 28, 1)) < 0.3).astype(np.float32)
    eb = make_eval_bank_fn(model, cfg)(Bank(
        images=bank_x, data_idx=np.arange(300, dtype=np.int32),
        valid=np.ones(300, bool), cache_means=None, n_effective=300))
    eps = torch.randn((2, 4 * 8, 8), device=dev)
    nll = {}
    for kernel in (True, False):
        _, _, score = make_serving_fns(
            model, cfg.replace(use_pallas_prior=kernel), 300, 4, 2, 8)
        before = tpl.pairwise_lse.launches
        nll[kernel] = score(bank_x[:4], eb.cache_means, eb.data_idx,
                            eb.valid, eps=eps)
        assert tpl.pairwise_lse.launches == before + (2 if kernel else 0)
    torch.testing.assert_close(nll[True], nll[False], rtol=RTOL, atol=ATOL)


def _two_level(dev, name, seed=0):
    """A small-hidden two-level model at the Config 3 conv widths (28x28
    gray, the default spec), on the CPU and a copy on ``dev``."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    cfg = Config(model_name=name, hidden_size=32, z1_size=8, z2_size=8,
                 input_type="gray", dynamic_binarization=False,
                 number_components=300, approximate_prior=True,
                 approximate_k=10, prior_block_n=128, exact_reencode_chunk=0)
    cpu = create_model(cfg, device="cpu", seed=seed)
    card = create_model(cfg, device=dev, seed=seed)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hvae_2level", "convhvae_2level"])
def test_two_level_fp32_forward_on_card_matches_cpu(dev, name):
    """fp32 on the card (cuDNN convs and cuBLAS GEMMs with TF32 off)
    against the same model on the CPU, same input and noise: rtol 1e-4."""
    _, cpu, card = _two_level(dev, name)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((16, 28, 28, 1), generator=g)
    eps = (torch.randn((16, 8), generator=g), torch.randn((16, 8), generator=g))
    with torch.no_grad():
        want = cpu(x, eps=eps)
        got = card(x.to(dev), eps=tuple(e.to(dev) for e in eps))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_config4_convhvae_fp32_forward_on_card_matches_cpu(dev):
    """Config 4's model: the default conv spec on 3-channel continuous
    64x64 uint8 images, dequantized at eval; fp32 on the card against the
    CPU (rtol 1e-4), including the 3-channel logistic-256 RE."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.models.base import reconstruction_log_lik
    from exemplar_vae_tpu_torch.ops.preprocess import preprocess_batch
    cfg = Config(model_name="convhvae_2level", hidden_size=32, z1_size=8,
                 z2_size=8, input_size=(3, 64, 64), input_type="continuous",
                 dynamic_binarization=False, number_components=300)
    cpu = create_model(cfg, device="cpu", seed=0)
    card = create_model(cfg, device=dev, seed=0)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (8, 64, 64, 3), generator=g, dtype=torch.uint8)
    x = preprocess_batch(raw, input_type="continuous",
                         dynamic_binarization=False, train=False)
    eps = (torch.randn((8, 8), generator=g), torch.randn((8, 8), generator=g))
    with torch.no_grad():
        want = cpu(x, eps=eps)
        got = card(x.to(dev), eps=tuple(e.to(dev) for e in eps))
        re = [reconstruction_log_lik(xx, o.x_mean, o.x_logvar, "continuous")
              for xx, o in ((x, want), (x.to(dev), got))]
    assert got.x_mean.shape == (8, 64, 64, 3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(re[1].cpu(), re[0], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", [(5, 30, 7), (100, 50_000, 10)])
def test_knn_indices_on_card_equal_cpu_on_ties(dev, b, n, k):
    """Integer data: every distance is exact, repeated rows tie exactly,
    and the card returns the CPU's lowest-index-first order."""
    from exemplar_vae_tpu_torch.ops.knn import knn_indices
    rng = np.random.default_rng(0)
    base = rng.integers(-3, 4, (-(-n // 3), 6)).astype(np.float32)
    cache = np.concatenate([base] * 3)[:n]
    q = base[rng.integers(0, base.shape[0], b)] + rng.integers(-1, 2, (b, 6))
    valid = rng.random(n) >= 0.1
    q, cache = torch.from_numpy(q.astype(np.float32)), torch.from_numpy(cache)
    valid = torch.from_numpy(valid)
    want = knn_indices(q, cache, k, valid=valid)
    got = knn_indices(q.to(dev), cache.to(dev), k, valid=valid.to(dev))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("support", ["per_row", "batch_union"])
def test_approx_train_step_on_card(dev, support):
    """One approximate ConvHVAE step on the card over a 300-row bank and a
    stale cache: finite loss and gradients, no kernel launch (the per-row
    prior is an LSE over K), the loss within 1e-4 of the CPU's."""
    from exemplar_vae_tpu_torch.train import steps
    from exemplar_vae_tpu_torch.train.loss import Bank
    cfg, cpu, card = _two_level(dev, "convhvae_2level")
    cfg = cfg.replace(approximate_support=support)
    g = torch.Generator().manual_seed(1)
    bank_x = torch.rand((300, 28, 28, 1), generator=g)
    rows = torch.arange(0, 300, 30)
    eps = (torch.randn((10, 8), generator=g), torch.randn((10, 8), generator=g))
    losses = []
    for model, d in ((cpu, torch.device("cpu")), (card, dev)):
        cache = steps.make_cache_refresh(model, cfg)(bank_x.to(d))
        bank = Bank(images=bank_x.to(d),
                    data_idx=torch.arange(300, dtype=torch.int32, device=d),
                    valid=torch.ones(300, dtype=torch.bool, device=d),
                    cache_means=cache, n_effective=300)
        before = tpl.pairwise_lse.launches
        _, aux = steps.make_train_step(cfg)(
            steps.init_train_state(model, cfg), bank_x[rows].to(d),
            rows.to(torch.int32).to(d), bank, 1.0,
            eps=tuple(e.to(d) for e in eps))
        assert tpl.pairwise_lse.launches == before
        for name, p in model.named_parameters():
            assert bool(torch.isfinite(p.grad).all()), name
        losses.append(float(aux["loss"]))
    assert np.isfinite(losses[1])
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """Save on the card, restore into a fresh Experiment on the card: the
    params, Adam moments, count, step, best params and the approximate
    prior's cache come back bitwise, the tensors on the card."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.train.trainer import Experiment
    cfg = Config(dataset_name="synthetic", training_set_size=256,
                 number_components=256, val_set_size=32, test_set_size=32,
                 batch_size=64, hidden_size=32, z1_size=8,
                 approximate_prior=True, approximate_k=5,
                 snapshot_dir=str(tmp_path))
    exp = Experiment(cfg, device=dev, verbose=False)
    exp.train_epoch()
    exp.best_params = exp._params_on_cpu()
    exp.save_checkpoint()
    back = Experiment(cfg, device=dev, verbose=False)
    assert back.restore_checkpoint()
    assert (back.epoch, back.state.step, back.state.opt.count) == (
        1, exp.state.step, exp.state.opt.count)
    for (name, p), q in zip(exp.model.named_parameters(),
                            back.model.parameters()):
        assert q.device.type == "cuda" and torch.equal(p, q), name
        for k in ("m", "v"):
            got = back.state.opt.state[q][k]
            assert got.device.type == "cuda", (name, k)
            assert torch.equal(exp.state.opt.state[p][k], got), (name, k)
        assert torch.equal(exp.best_params[name], back.best_params[name])
    assert back.bank.cache_means.device.type == "cuda"
    assert torch.equal(exp.bank.cache_means, back.bank.cache_means)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vae", "hvae_2level"])
def test_augment_on_card_matches_cpu(dev, name):
    """The exemplar-conditioned augmentation at fp32 on the card against
    the CPU on the same weights, input and noise: rtol 1e-4."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.train.augment import make_augment_fn
    cfg = Config(model_name=name, hidden_size=300, z1_size=40, z2_size=40)
    cpu = create_model(cfg, device="cpu", seed=3)
    card = create_model(cfg, device=dev, seed=3)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((100, 28, 28, 1), generator=g) < 0.3).float()
    eps = torch.randn((100, 40), generator=g)
    eps1 = torch.randn((100, 40), generator=g) if name != "vae" else None
    want = make_augment_fn(cpu, cfg)(x, eps=eps, eps1=eps1)
    got = make_augment_fn(card, cfg)(
        x.to(dev), eps=eps.to(dev), eps1=None if eps1 is None else eps1.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_mesh_over_nccl_on_one_rank(dev, tmp_path):
    """The mesh's collectives over NCCL on a group of one card (uint8, int32,
    int64, bool and fp32 gathers, MAX, the differentiable SUM, the gradient
    average, the barrier), and the sharded exact prior's log-space combine
    of the kernel's LSE, the kNN select and the row gather, which on one
    rank equal the unsharded functions."""
    import torch.distributed as dist

    from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
    from exemplar_vae_tpu_torch.ops.knn import knn_indices
    from exemplar_vae_tpu_torch.parallel.mesh import Mesh, shutdown
    from exemplar_vae_tpu_torch.parallel.sharded_knn import (
        sharded_knn_select, sharded_row_gather)

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = Mesh(size=1, rank=0, device=dev)
        for dt in (torch.uint8, torch.int32, torch.int64, torch.bool,
                   torch.float32):
            t = (torch.arange(12, device=dev) % 3).to(dt).reshape(4, 3)
            assert torch.equal(mesh.all_gather_rows(t), t), dt
        x = torch.tensor([1.0, -2.0], device=dev)
        assert torch.equal(mesh.all_reduce(x.clone(), op="max"), x)
        y = x.clone().requires_grad_()
        (3.0 * mesh.all_reduce_sum_grad(y)).sum().backward()
        assert torch.equal(y.grad, torch.full_like(x, 3.0))
        mesh.average_grads([y])
        assert torch.equal(y.grad, torch.full_like(x, 3.0))
        mesh.barrier()
        z, means, lv, didx, ex, valid = _inputs(dev, 100, 3000, 40, True)
        before = tpl.pairwise_lse.launches
        lse = exemplar_log_prob(z, means, lv, log_denom=0.0, data_idx=didx,
                                exemplar_idx=ex, valid=valid, impl="pallas")
        assert tpl.pairwise_lse.launches == before + 1
        m = mesh.all_reduce(lse.clone(), op="max")
        combined = m + torch.log(mesh.all_reduce_sum_grad(torch.exp(lse - m)))
        torch.testing.assert_close(combined, lse, rtol=RTOL, atol=ATOL)
        rows = sharded_knn_select(z, means, valid, 10, mesh)
        assert torch.equal(rows, knn_indices(z, means, 10, valid=valid))
        imgs = torch.randint(0, 256, (3000, 4, 4, 3), dtype=torch.uint8,
                             device=dev)
        assert torch.equal(sharded_row_gather(imgs, rows, mesh), imgs[rows])
        assert torch.equal(sharded_row_gather(ex, rows, mesh), ex[rows])
    finally:
        shutdown()


def _pixel(dev, features=64, layers=4, input_type="binary", seed=0):
    """A PixelHVAE (hidden 32, z1 = z2 = 8, 28x28), on the CPU and a copy
    on ``dev``."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    cfg = Config(model_name="pixelhvae_2level", hidden_size=32, z1_size=8,
                 z2_size=8, input_type=input_type,
                 dynamic_binarization=False, number_components=300,
                 pixelcnn_features=features, pixelcnn_layers=layers,
                 prior_block_n=128, exact_reencode_chunk=0)
    cpu = create_model(cfg, device="cpu", seed=seed)
    card = create_model(cfg, device=dev, seed=seed)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.cuda
def test_pixelhvae_fp32_forward_on_card_matches_cpu(dev):
    """The default masked stack (64 features, 4 'B' layers) at fp32 on the
    card (cuDNN, TF32 off) against the CPU, same input and noise."""
    _, cpu, card = _pixel(dev)
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((16, 28, 28, 1), generator=g) < 0.3).float()
    eps = (torch.randn((16, 8), generator=g), torch.randn((16, 8), generator=g))
    with torch.no_grad():
        want = cpu(x, eps=eps)
        got = card(x.to(dev), eps=tuple(e.to(dev) for e in eps))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def _parting_rows(model, got, want, u, z2, eps1, margin=1e-5):
    """Rows in which binary samples differ; each must part at a pixel whose
    uniform lies within ``margin`` of its mean (decoded teacher-forced from
    ``want``, which shares the pixels before the first difference)."""
    b = got.shape[0]
    with torch.no_grad():
        p1_mean, p1_logvar = model.p_z1(z2)
        z1 = p1_mean + torch.exp(0.5 * p1_logvar) * eps1
        mean = model.decode(want, z1, z2)[0].reshape(b, -1).cpu()
    got, want, u = (t.reshape(t.shape[0], -1).cpu() for t in (got, want, u))
    rows = 0
    for row in range(b):
        diff = torch.nonzero(got[row] != want[row]).flatten()
        if diff.numel():
            i = int(diff[0])
            assert abs(float(u[i, row]) - float(mean[row, i])) < margin
            rows += 1
    return rows


@pytest.mark.cuda
def test_pixel_samplers_on_card(dev):
    """Both samplers on the card from the same injected noise: binary
    samples, the crop sampler equal to the full-canvas oracle and to the
    CPU's crop sampler (a row may part only where u lies within 1e-5 of
    the mean); no kernel launch."""
    _, cpu, card = _pixel(dev, features=16, layers=2)
    g = torch.Generator().manual_seed(1)
    z2 = torch.randn((8, 8), generator=g)
    eps1 = torch.randn((8, 8), generator=g)
    u = torch.rand((784, 8, 1), generator=g)
    noise = (eps1.to(dev), u.to(dev))
    before = tpl.pairwise_lse.launches
    crop = card.generate_from_top(z2.to(dev), eps=noise)
    naive = card.generate_from_top_naive(z2.to(dev), eps=noise)
    assert tpl.pairwise_lse.launches == before
    assert crop.shape == (8, 28, 28, 1) and crop.device.type == dev.type
    assert set(torch.unique(crop).tolist()) <= {0.0, 1.0}
    _parting_rows(card, crop, naive, u, z2.to(dev), eps1.to(dev))
    on_cpu = cpu.generate_from_top(z2, eps=(eps1, u))
    _parting_rows(cpu, crop.cpu(), on_cpu, u, z2, eps1)


@pytest.mark.cuda
def test_pixel_exact_step_through_kernel(dev):
    """One exact-prior PixelHVAE step on the card (the default masked
    stack, a 300-row bank, LOO): the kernel prior against the scan prior
    from the same params and noise, one launch; loss rtol 1e-5, gradients
    within GRAD_REL of their largest element."""
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.train import steps
    from exemplar_vae_tpu_torch.train.loss import Bank
    cfg, cpu, _ = _pixel(dev)
    g = torch.Generator().manual_seed(2)
    bank_x = (torch.rand((300, 28, 28, 1), generator=g) < 0.3).float().to(dev)
    bank = Bank(images=bank_x, data_idx=torch.arange(300, dtype=torch.int32,
                                                     device=dev),
                valid=torch.ones(300, dtype=torch.bool, device=dev),
                cache_means=None, n_effective=300)
    rows = torch.arange(0, 300, 15, device=dev)
    eps = (torch.randn((20, 8), generator=g).to(dev),
           torch.randn((20, 8), generator=g).to(dev))
    out = {}
    for kernel in (True, False):
        c = cfg.replace(use_pallas_prior=kernel)
        model = create_model(c, device=dev)
        model.load_state_dict(cpu.state_dict())
        before = tpl.pairwise_lse.launches
        _, aux = steps.make_train_step(c)(
            steps.init_train_state(model, c), bank_x[rows],
            rows.to(torch.int32), bank, 1.0, eps=eps)
        assert tpl.pairwise_lse.launches == before + kernel
        out[kernel] = (float(aux["loss"]),
                       {n: p.grad for n, p in model.named_parameters()})
    (lk, gk), (ls, gs) = out[True], out[False]
    assert np.isfinite(lk) and lk == pytest.approx(ls, rel=1e-5)
    for name, a in gk.items():
        assert bool(torch.isfinite(a).all()), name
        err = float((a - gs[name]).abs().max())
        assert err <= GRAD_REL * float(gs[name].abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vae", "pixelhvae_2level"])
def test_export_load_round_trip_on_card(dev, name, tmp_path):
    """export_serving_bundle of a model on the card, ServingBundle.load on
    the card: score_nll and generate equal the live functions' bitwise on
    the same noise (the same code on the same card)."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.serve import (ServingBundle,
                                              export_serving_bundle,
                                              make_serving_fns)
    from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
    from exemplar_vae_tpu_torch.train.loss import Bank
    cfg = Config(model_name=name, hidden_size=32, z1_size=8, z2_size=8,
                 pixelcnn_features=16, pixelcnn_layers=2)
    model = create_model(cfg, device=dev, seed=1).eval()
    rng = np.random.default_rng(0)
    bank_x = (rng.random((300, 28, 28, 1)) < 0.3).astype(np.float32)
    eb = make_eval_bank_fn(model, cfg)(Bank(
        images=bank_x, data_idx=np.arange(300, dtype=np.int32),
        valid=np.ones(300, bool), cache_means=None, n_effective=300))
    export_serving_bundle(model, cfg, str(tmp_path), bank_means=eb.cache_means,
                          data_idx=eb.data_idx, valid=eb.valid, n_gen=4,
                          score_chunk=4, s_total=16, r=8)
    b = ServingBundle.load(str(tmp_path), device=dev)
    if name == "vae":               # served by its programs, exported on the card
        assert b.model is None and b.manifest["platforms"] == ["cuda"]
    else:                           # no programs: served by the model
        assert next(b.model.parameters()).device.type == dev.type
    gen, _, score = make_serving_fns(model, cfg, 300, 4, 2, 8)
    g = torch.Generator(dev).manual_seed(3)
    two = name != "vae"
    eps = ((torch.randn((2, 32, 8), generator=g, device=dev),) * 2 if two
           else torch.randn((2, 32, 8), generator=g, device=dev))
    want = score(bank_x[:4], eb.cache_means, eb.data_idx, eb.valid, eps=eps)
    assert np.array_equal(b.score_nll(bank_x[:4], eps=[eps])[1],
                          want.cpu().numpy())
    idx = np.array([0, 5, 17, 299])
    e = torch.randn((4, 8), generator=g, device=dev)
    e1 = ((e, torch.rand((784, 4, 1), generator=g, device=dev)) if two
          else None)
    assert torch.equal(b.generate(idx=idx, eps=e, eps1=e1),
                       gen(eb.cache_means, idx=idx, eps=e, eps1=e1))


@pytest.mark.cuda
def test_cuda_exported_program_launches_the_kernel(dev, tmp_path):
    """A VAE bundle exported on the card: its score_nll program launches the
    kernel once per round, equals the live function bitwise on the same
    noise, and draws the same noise from the same generator."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model
    from exemplar_vae_tpu_torch.serve import (ServingBundle,
                                              export_serving_bundle,
                                              make_serving_fns)
    from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn
    from exemplar_vae_tpu_torch.train.loss import Bank
    cfg = Config(hidden_size=32, z1_size=8)
    model = create_model(cfg, device=dev, seed=1).eval()
    rng = np.random.default_rng(0)
    bank_x = (rng.random((300, 28, 28, 1)) < 0.3).astype(np.float32)
    eb = make_eval_bank_fn(model, cfg)(Bank(
        images=bank_x, data_idx=np.arange(300, dtype=np.int32),
        valid=np.ones(300, bool), cache_means=None, n_effective=300))
    export_serving_bundle(model, cfg, str(tmp_path), bank_means=eb.cache_means,
                          data_idx=eb.data_idx, valid=eb.valid, n_gen=4,
                          score_chunk=4, s_total=24, r=8)
    b = ServingBundle.load(str(tmp_path), device=dev)
    _, _, score = make_serving_fns(model, cfg, 300, 4, 3, 8)
    eps = torch.randn((3, 32, 8), device=dev)
    before = tpl.pairwise_lse.launches
    _, per = b.score_nll(bank_x[:4], eps=[eps])
    assert tpl.pairwise_lse.launches == before + 3
    want = score(bank_x[:4], eb.cache_means, eb.data_idx, eb.valid, eps=eps)
    assert np.array_equal(per, want.cpu().numpy())
    _, per = b.score_nll(bank_x[:4],
                         generator=torch.Generator(dev).manual_seed(5))
    want = score(bank_x[:4], eb.cache_means, eb.data_idx, eb.valid,
                 generator=torch.Generator(dev).manual_seed(5))
    assert np.array_equal(per, want.cpu().numpy())


@pytest.mark.cuda
def test_config4_subpixel_decode_on_card_matches_transpose_route(
        dev, monkeypatch):
    """Config 4's decoder on 500 samples on the card, TF32 off: the
    sub-pixel route (no_grad; the fused gated epilogue) against the
    F.conv_transpose2d formulation with the unfused gate, both fp32 through
    cuDNN: rtol 1e-5 / atol 1e-5."""
    import torch.nn.functional as F

    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model, layers

    def transpose_route(x, w_hwio, b, stride):
        (ph, oph, ch), (pw, opw, cw) = (
            layers._transpose_pads(w_hwio.shape[0], stride[0]),
            layers._transpose_pads(w_hwio.shape[1], stride[1]))
        y = F.conv_transpose2d(x, w_hwio.permute(2, 3, 0, 1).flip(2, 3), b,
                               stride=stride, padding=(ph, pw),
                               output_padding=(oph, opw))
        return y[:, :, :y.shape[2] - ch, :y.shape[3] - cw]

    cfg = Config(model_name="convhvae_2level", hidden_size=300, z1_size=40,
                 z2_size=40, input_size=(3, 64, 64), input_type="continuous",
                 dynamic_binarization=False, number_components=300)
    model = create_model(cfg, device=dev, seed=0).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    z1 = torch.randn((500, 40), generator=g, device=dev)
    z2 = torch.randn((500, 40), generator=g, device=dev)
    before = layers.conv_transpose_same.subpixel
    with torch.no_grad():
        assert not torch.backends.cudnn.allow_tf32
        got = model.decode(z1, z2)
        assert layers.conv_transpose_same.subpixel == before + 2
        monkeypatch.setattr(layers.GatedConvTranspose2d, "_conv",
                            staticmethod(transpose_route))
        monkeypatch.setattr(layers._GatedConvBase, "_fused_route",
                            lambda self, x, dt: False)
        want = model.decode(z1, z2)
        assert not torch.backends.cudnn.allow_tf32
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        assert a.shape == (500, 64, 64, 3)
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hw,offset", [
    (1, (28, 28), 0), (7, (28, 28), 0), (2000, (28, 28), 0), (5, (7, 9), 0),
    (3, (28, 28), 1)])
def test_masked_epilogue_kernel_matches_plain(dev, rows, hw, offset):
    """The masked layers' fused epilogue on the card against its plain
    version at (R, 64, H, W): bitwise, the same fp32 sums in the same
    order. H*W = 63, and an h 4 bytes off a 16-byte boundary, take the
    kernel's one-float loop; one launch a call."""
    from exemplar_vae_tpu_torch.ops import masked_epilogue as me
    shape = (rows, 64) + hw
    g = torch.Generator(device=dev).manual_seed(rows)
    flat = torch.randn(int(np.prod(shape)) + offset, generator=g, device=dev)
    h = flat[offset:].view(shape)
    bias = torch.randn((64,), generator=g, device=dev)
    ctx = torch.randn(shape, generator=g, device=dev)
    want = me.masked_epilogue_plain(h.clone(), bias, ctx)
    before = me.masked_epilogue.launches
    got = me.masked_epilogue(h, bias, ctx)
    torch.cuda.synchronize()
    assert got is h and me.masked_epilogue.launches == before + 1
    assert torch.equal(got, want)
    assert bool((got == 0).any()) and bool((got > 0).any())


@pytest.mark.cuda
def test_masked_epilogue_refusals_on_card(dev):
    """A channels-last h is refused before a launch; sizes that the kernel
    refuses (planes not a multiple of the channels, a grid past 2^31 - 1
    blocks) raise without a launch, and nothing is counted."""
    from exemplar_vae_tpu_torch.ops import masked_epilogue as me
    h = torch.randn((2, 64, 28, 28), device=dev)
    bias, ctx = torch.randn((64,), device=dev), torch.randn_like(h)
    want = h.clone()
    before = me.masked_epilogue.launches
    with pytest.raises(ValueError, match="NCHW"):
        me.masked_epilogue(h.contiguous(memory_format=torch.channels_last),
                           bias, ctx)
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        me._launch(h, bias, ctx, 127, 64, 784)
    with pytest.raises(RuntimeError, match="cudaError 9$"):
        me._launch(h, bias, ctx, 64 << 34, 64, 784)
    torch.cuda.synchronize()
    assert me.masked_epilogue.launches == before
    assert torch.equal(h, want)


@pytest.mark.cuda
def test_pixelhvae_decode_routes_on_card(dev):
    """The default masked stack (64 features, 4 'B' layers) over 2000 rows
    on the card, TF32 off: the no-grad decode (NCHW, the fused epilogue, 5
    launches) against the decode with gradients (each conv with its bias,
    the context added, a ReLU, channels-last). Each row's log-likelihood
    within the benchmark cell's nll_gap 5e-6 of the other's, relative;
    whether the means are bitwise equal is printed."""
    from exemplar_vae_tpu_torch.ops import masked_epilogue as me
    from exemplar_vae_tpu_torch.ops.distributions import log_bernoulli
    _, _, card = _pixel(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    x = (torch.rand((2000, 28, 28, 1), generator=g, device=dev) < 0.3).float()
    z1 = torch.randn((2000, 8), generator=g, device=dev)
    z2 = torch.randn((2000, 8), generator=g, device=dev)
    before = me.masked_epilogue.launches
    with torch.no_grad():
        fused = card.decode(x, z1, z2)[0]
    assert me.masked_epilogue.launches == before + 5
    parent = card.decode(x, z1, z2)[0].detach()
    assert me.masked_epilogue.launches == before + 5
    assert not torch.backends.cudnn.allow_tf32
    ll = [log_bernoulli(x.reshape(2000, -1), m.reshape(2000, -1)).double()
          for m in (fused, parent)]
    gap = float(((ll[0] - ll[1]).abs() / ll[1].abs()).max())
    print(f"decode routes: means bitwise {torch.equal(fused, parent)}, max "
          f"abs diff {float((fused - parent).abs().max()):.3e}; "
          f"log-likelihood gap {gap:.3e}")
    assert gap <= 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f,hw,phases,offset", [
    (1, 32, (16, 16), (2, 2), 0), (7, 64, (16, 16), (2, 2), 0),
    (2000, 32, (32, 32), (2, 2), 0), (3, 32, (64, 64), (1, 1), 0),
    (5, 64, (16, 16), (1, 1), 0), (5, 32, (7, 7), (2, 2), 0),
    (5, 32, (7, 7), (1, 1), 0), (3, 32, (16, 16), (2, 2), 1),
    (3, 32, (16, 16), (1, 1), 1), (3, 8, (5, 6), (3, 3), 0),
    (3, 8, (8, 8), (1, 2), 0)])
def test_gated_epilogue_kernel_matches_plain(dev, rows, f, hw, phases,
                                             offset):
    """The gated convs' fused epilogue on the card against its plain
    version at (R, s_h*s_w*2F, h, w): bitwise, the same fp32 chain in the
    same order. 2x2 phases over a w that is a multiple of 4, and no phases
    over an h*w that is, take the float4 kernels; an odd h*w, a y 4 bytes
    off a 16-byte boundary and other phases the scalar one; one launch a
    call, a fresh NCHW-contiguous output."""
    from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
    shape = (rows, 2 * f * phases[0] * phases[1]) + hw
    g = torch.Generator(device=dev).manual_seed(rows + f)
    flat = torch.randn(int(np.prod(shape)) + offset, generator=g, device=dev)
    y = flat[offset:].view(shape)
    hb = torch.randn((f,), generator=g, device=dev)
    gb = torch.randn((f,), generator=g, device=dev)
    want = ge.gated_epilogue_plain(y, hb, gb, *phases)
    before = ge.gated_epilogue.launches
    got = ge.gated_epilogue(y, hb, gb, phases)
    torch.cuda.synchronize()
    assert ge.gated_epilogue.launches == before + 1
    assert got.shape == (rows, f, hw[0] * phases[0], hw[1] * phases[1])
    assert got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gated_epilogue_refusals_on_card(dev):
    """A channels-last y is refused before a launch; sizes that the kernel
    refuses (a size that is not positive, one row of R past 2^31 - 2^16
    units) raise without a launch, and nothing is counted."""
    from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
    y = torch.randn((2, 256, 16, 16), device=dev)
    hb, gb = torch.randn((32,), device=dev), torch.randn((32,), device=dev)
    out = torch.zeros((2, 32, 32, 32), device=dev)
    before = ge.gated_epilogue.launches
    with pytest.raises(ValueError, match="NCHW"):
        ge.gated_epilogue(y.contiguous(memory_format=torch.channels_last),
                          hb, gb, (2, 2))
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        ge._launch(y, hb, gb, out, 2, 0, 2, 2, 16, 16)
    with pytest.raises(RuntimeError, match="cudaError 9$"):
        ge._launch(y, hb, gb, out, 2, 1 << 20, 1, 1, 128, 128)
    torch.cuda.synchronize()
    assert ge.gated_epilogue.launches == before
    assert not out.any()


@pytest.mark.cuda
def test_config4_gated_decode_on_card_matches_parent_route(dev, monkeypatch):
    """Config 4's decoder on 500 samples on the card, TF32 off: the no-grad
    decode (NCHW convs without bias, the fused epilogue, 3 launches) against
    the parent's route (the convs with their bias on the channels-last view,
    the depth-to-space add, the unfused gate): rtol 1e-5 / atol 1e-5, the
    tolerance of the sub-pixel test above; whether the means are bitwise
    equal is printed."""
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.models import create_model, layers
    from exemplar_vae_tpu_torch.ops import gated_epilogue as ge
    cfg = Config(model_name="convhvae_2level", hidden_size=300, z1_size=40,
                 z2_size=40, input_size=(3, 64, 64), input_type="continuous",
                 dynamic_binarization=False, number_components=300)
    model = create_model(cfg, device=dev, seed=0).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    z1 = torch.randn((500, 40), generator=g, device=dev)
    z2 = torch.randn((500, 40), generator=g, device=dev)
    before = ge.gated_epilogue.launches
    with torch.no_grad():
        got = model.decode(z1, z2)
        assert ge.gated_epilogue.launches == before + 3
        monkeypatch.setattr(layers._GatedConvBase, "_fused_route",
                            lambda self, x, dt: False)
        want = model.decode(z1, z2)
    assert ge.gated_epilogue.launches == before + 3
    assert not torch.backends.cudnn.allow_tf32
    torch.cuda.synchronize()
    print(f"gated decode routes: means bitwise {torch.equal(got[0], want[0])},"
          f" max abs diff {float((got[0] - want[0]).abs().max()):.3e}")
    for a, r in zip(got, want):
        assert a.shape == (500, 64, 64, 3)
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
