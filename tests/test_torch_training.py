"""Port vs JAX: the training slice at a small size (hidden 32, D = 8, a bank
of N = 64 exemplars with a tile of 24 that leaves a ragged last tile, B = 8).

The same flax params go into both packages (weights.params_from_flax) and
the port is fed the JAX package's own draws: the batch's binarization
uniforms (``bernoulli(k, p) == uniform(k) < p``) and the reparameterization
noise, from ``k_bin, k_bank, k_z = split(key, 3)``. JAX's Pallas prior runs
in interpret mode on the CPU, as its own tests run it; the port's 'pallas'
impl runs the kernel's plain version on the CPU.

Tolerances (fp32 unless stated):
* prior gradients: atol 1e-5 / rtol 1e-5 (sums over N and D in another
  order);
* one train step: loss rtol 1e-5; every gradient tensor atol 1e-5 /
  rtol 1e-4 (the bank encoder's gradient sums 64 exemplars' terms); the
  AdamNormGrad update atol 1e-7 where the normalized gradient exceeds 1e-5
  (there the step-1 update is ~lr = 5e-4 whatever the gradient's last
  bits), and atol 5e-5 elsewhere: near 0 the update moves lr / 3.2e-7
  per unit of normalized gradient, so fp32 noise of 1e-8 there is 1.6e-5;
* bf16 compute: loss rtol 1e-3 and each gradient tensor within 3e-2 of its
  largest element (the two frameworks round bf16 products and bias adds at
  other places; measured 8e-5 and 1.6e-2, two bf16 ulps);
* three plain-Adam steps: params atol 1e-6 / rtol 1e-5, epoch metrics
  rtol 1e-5;
* optimizers against optax: rtol 1e-6 over 5 updates;
* validation ELBO: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exemplar_vae_tpu.ops.exemplar_prior as jep
import exemplar_vae_tpu_torch.ops.exemplar_prior as tep
from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.train import evaluation as jev
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu.train import optimizer as jopt
from exemplar_vae_tpu.train import steps as jsteps
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.train import evaluation as tev
from exemplar_vae_tpu_torch.train import optimizer as topt
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.weights import params_from_flax

B, N, D, BLOCK = 8, 64, 8, 24
N_TRAIN = 80
BETA = 0.7

# ---------------------------------------------------------------------------
# the prior's gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prior_problem():
    rng = np.random.default_rng(0)
    means = rng.normal(size=(N, D)).astype(np.float32)
    ex = (np.arange(N) * 3 + 1).astype(np.int32)
    valid = np.ones(N, bool)
    valid[[5, 40, 63]] = False                      # padding rows
    own = np.array([0, 3, 10, 20, 30, 40, 50, 63])  # 40, 63: own row padding
    z = (means[own] + 0.5 * rng.normal(size=(B, D))).astype(np.float32)
    didx = ex[own].copy()
    didx[6] = 999                                   # not in the bank
    g = rng.normal(size=B).astype(np.float32)       # cotangent of the rows
    return z, means, np.float32(-0.3), didx, ex, valid, g


def _prior_grads(p, impl, loo, block_n=BLOCK):
    z, means, lv, didx, ex, valid, g = p
    n = means.shape[0]

    def f(z_, m_, lv_):
        out = jep.exemplar_log_prob(
            z_, m_, lv_, log_denom=np.log(n - 1.0),
            data_idx=jnp.asarray(didx) if loo else None,
            exemplar_idx=jnp.asarray(ex), valid=jnp.asarray(valid),
            impl=impl, block_n=block_n)
        return jnp.sum(jnp.asarray(g) * out)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(z), jnp.asarray(means),
                                          jnp.float32(lv))
    tz, tm = torch.tensor(z, requires_grad=True), torch.tensor(
        means, requires_grad=True)
    tl = torch.tensor(lv, requires_grad=True)
    out = tep.exemplar_log_prob(
        tz, tm, tl, log_denom=np.log(n - 1.0),
        data_idx=torch.from_numpy(didx) if loo else None,
        exemplar_idx=torch.from_numpy(ex), valid=torch.from_numpy(valid),
        impl=impl, block_n=block_n)
    (torch.from_numpy(g) * out).sum().backward()
    return [t.grad.numpy() for t in (tz, tm, tl)], [np.asarray(w) for w in want]


def _force_schedule(monkeypatch, schedule):
    if schedule == "blockwise":
        monkeypatch.setattr(jep, "WIDE_BWD_MAX_BYTES", 0)
        monkeypatch.setattr(tep, "WIDE_BWD_MAX_BYTES", 0)


@pytest.mark.parametrize("loo", [False, True])
@pytest.mark.parametrize("schedule", ["wide", "blockwise"])
@pytest.mark.parametrize("impl", ["naive", "scan", "pallas"])
def test_prior_gradients_match_jax(prior_problem, impl, schedule, loo,
                                   monkeypatch):
    _force_schedule(monkeypatch, schedule)
    got, want = _prior_grads(prior_problem, impl, loo)
    for name, a, b in zip(("dz", "dmu", "dlogvar"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_wide_bwd_budget_is_the_jax_value():
    assert tep.WIDE_BWD_MAX_BYTES == jep.WIDE_BWD_MAX_BYTES == 256 * 2 ** 20


@pytest.mark.parametrize("case", ["own_only", "all_padding"])
@pytest.mark.parametrize("schedule", ["wide", "blockwise"])
@pytest.mark.parametrize("impl", ["naive", "scan", "pallas"])
def test_prior_gradients_fully_masked_rows(impl, schedule, case, monkeypatch):
    """A row whose only valid exemplar is its own (LOO), or a bank of
    padding only: after the 0.5*NEG_INF clamp its weights are exactly 0, so
    its gradients are 0 and finite in both packages."""
    _force_schedule(monkeypatch, schedule)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(3, D)).astype(np.float32)
    means = rng.normal(size=(5, D)).astype(np.float32)
    ex = np.arange(10, 15, dtype=np.int32)
    valid = (np.array([False, False, False, True, False]) if case == "own_only"
             else np.zeros(5, bool))
    didx = np.array([13, 11, 12], np.int32)
    p = (z, means, np.float32(-0.2), didx, ex, valid,
         np.array([1.0, -0.5, 2.0], np.float32))
    got, want = _prior_grads(p, impl, True, block_n=2)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.all(got[0][0] == 0.0)          # row 0 is fully masked


# ---------------------------------------------------------------------------
# optimizers against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adam_norm_grad", "adam"])
def test_optimizer_matches_optax(kind):
    """Five updates on a param tree that starts at 0 (so the params are the
    summed updates, compared at rtol 1e-6); one tensor's gradients are
    ~1e-6, which the per-tensor normalization scales up to unit norm."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (), "tiny": (2, 3)}
    lr = 0.05
    tx = (jopt.adam_norm_grad if kind == "adam_norm_grad"
          else jopt.plain_adam)(lr)
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    js = tx.init(jp)
    tp = {k: torch.zeros(s, dtype=torch.float32, requires_grad=True)
          for k, s in shapes.items()}
    opt = (topt.adam_norm_grad if kind == "adam_norm_grad"
           else topt.plain_adam)(list(tp.values()), lr)
    for _ in range(5):
        grads = {k: np.asarray(rng.normal(size=s) * (1e-6 if k == "tiny"
                                                     else 1.0), np.float32)
                 for k, s in shapes.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, js,
                            jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6 * lr, err_msg=k)
    assert opt.count == 5


def test_adam_norm_grad_is_not_torch_adam():
    """torch.optim.Adam's step-1 update differs from AdamNormGrad's: on a
    normalized gradient element of 1e-9 its effective eps is 1e-8 against
    AdamNormGrad's 1e-8 / sqrt(1 - b2) = 3.2e-7 (0.09 against 0.003)."""
    g = torch.tensor([1e-9, 1.0])
    g = g / (g.norm() + topt.NORM_EPS)
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    ours = topt.adam_norm_grad([a], 1.0)
    ref = torch.optim.Adam([b], lr=1.0)
    a.grad, b.grad = g.clone(), g.clone()
    ours.step()
    ref.step()
    assert float(a[0].detach()) == pytest.approx(-1e-9 / (1e-9 + 3.1623e-7),
                                              rel=1e-3)
    assert float(b[0].detach()) == pytest.approx(-1e-9 / (1e-9 + 1e-8),
                                              rel=1e-3)


def test_make_optimizer_picks_the_rule():
    p = [torch.zeros(2, requires_grad=True)]
    assert topt.make_optimizer(Config(), p).norm_grad
    assert not topt.make_optimizer(Config(optimizer="adam"), p).norm_grad
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(Config(optimizer="sgd"), p)


# ---------------------------------------------------------------------------
# one train step, three steps, the epoch loop
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    kw = dict(dict(dataset_name="synthetic", hidden_size=32, z1_size=D,
                   number_components=N, batch_size=B, prior_block_n=BLOCK,
                   exact_reencode_chunk=0, exact_remat=False,
                   use_pallas_prior=True), **kw)
    jcfg = JConfig(**kw)
    return jcfg, Config.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    train_x = rng.random((N_TRAIN, 28, 28, 1)).astype(np.float32)
    rows = np.array([0, 5, 23, 24, 47, 63, 64, 79])   # last two not in bank
    return train_x, rows


def _pair(jcfg, cfg):
    jm = j_create_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = jm.init(key, jnp.zeros((2, 28, 28, 1)), key)["params"]
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _banks(train_x):
    jb = jloss.Bank(images=jnp.asarray(train_x[:N]),
                    data_idx=jnp.arange(N, dtype=jnp.int32),
                    valid=jnp.ones(N, bool), cache_means=None, n_effective=N)
    tb = Bank(images=torch.from_numpy(train_x[:N]),
              data_idx=torch.arange(N, dtype=torch.int32),
              valid=torch.ones(N, dtype=torch.bool), cache_means=None,
              n_effective=N)
    return jb, tb


def _step_noise(key, x_shape):
    """JAX's per-step draws, as the train step splits them."""
    k_bin, _, k_z = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k_bin, x_shape)),
            np.array(jax.random.normal(k_z, (x_shape[0], D))))


def _jax_step(jcfg, data):
    """JAX's loss, gradients and AdamNormGrad-updated params of one step."""
    train_x, rows = data
    jm, params, _ = _pair(jcfg, Config.from_json(jcfg.to_json()))
    jb, _ = _banks(train_x)
    tx = jopt.make_optimizer(jcfg)
    key = jax.random.PRNGKey(7)
    x_raw = jnp.asarray(train_x[rows])
    idx = jnp.asarray(rows.astype(np.int32))
    k_bin, k_bank, k_z = jax.random.split(key, 3)
    x = jax.random.bernoulli(k_bin, x_raw).astype(jnp.float32)
    bank = jsteps._preprocess_bank(k_bank, jb, jcfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jloss.batch_loss(jm, {"params": p}, x, k_z, BETA, jcfg,
                                   data_idx=idx, bank=bank, train=True,
                                   bank_key=k_bank), has_aux=True)(params)
    state = jsteps.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state, aux = jsteps.make_train_step(jm, tx, jcfg)(state, x_raw, idx, jb,
                                                      key, BETA)
    np.testing.assert_allclose(float(aux["loss"]), float(loss), rtol=1e-6)
    u, eps = _step_noise(key, x_raw.shape)
    np.testing.assert_array_equal(u < train_x[rows], np.asarray(x) > 0.5)
    return dict(loss=float(loss), u=u, eps=eps,
                grads=params_from_flax(jax.tree.map(np.asarray, grads)),
                before=params_from_flax(jax.tree.map(np.asarray, params)),
                after=params_from_flax(jax.tree.map(np.asarray,
                                                    state.params)))


@pytest.fixture(scope="module")
def jax_step_fp32(data):
    return _jax_step(_cfgs()[0], data)


def _torch_step(cfg, data, ref, **kw):
    train_x, rows = data
    cfg = cfg.replace(**kw)
    tm = create_model(cfg, device="cpu")
    tm.load_state_dict(ref["before"])
    _, tb = _banks(train_x)
    state = tsteps.init_train_state(tm, cfg)
    state, aux = tsteps.make_train_step(cfg)(
        state, torch.from_numpy(train_x[rows]),
        torch.from_numpy(rows.astype(np.int32)), tb, BETA,
        u=torch.from_numpy(ref["u"]), eps=torch.from_numpy(ref["eps"]))
    assert state.step == 1 and state.opt.count == 1
    return (float(aux["loss"]),
            {n: p.grad.clone() for n, p in tm.named_parameters()},
            {n: p.detach().clone() for n, p in tm.named_parameters()})


@pytest.mark.parametrize("chunk,remat", [(0, False), (0, True), (24, False),
                                         (24, True)])
def test_train_step_matches_jax(data, jax_step_fp32, chunk, remat):
    ref = jax_step_fp32
    loss, grads, after = _torch_step(_cfgs()[1], data, ref,
                                     exact_reencode_chunk=chunk,
                                     exact_remat=remat)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    assert grads.keys() == ref["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        upd = (after[name] - ref["before"][name]).numpy()
        want = (ref["after"][name] - ref["before"][name]).numpy()
        g_n = np.abs(g.numpy()) / (np.linalg.norm(g.numpy()) + 1e-7)
        big = g_n > 1e-5
        np.testing.assert_allclose(upd[big], want[big], rtol=0, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(upd, want, rtol=0, atol=5e-5,
                                   err_msg=name)


def test_train_step_chunk_and_remat_agree(data, jax_step_fp32):
    """The bank encode in one piece, in ragged chunks, with and without
    recompute in the backward: the same loss and gradients."""
    cfg = _cfgs()[1]
    base = _torch_step(cfg, data, jax_step_fp32)
    for chunk, remat in ((0, True), (24, False), (24, True)):
        loss, grads, _ = _torch_step(cfg, data, jax_step_fp32,
                                     exact_reencode_chunk=chunk,
                                     exact_remat=remat)
        assert loss == pytest.approx(base[0], rel=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), base[1][name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


def test_train_step_bf16_matches_jax(data):
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    ref = _jax_step(jcfg, data)
    loss, grads, _ = _torch_step(cfg, data, ref)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-3)
    for name, g in grads.items():
        want = ref["grads"][name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g.numpy() - want).max()) <= 3e-2 * scale, name


def test_three_adam_steps_match_jax(data):
    """Three steps of the JAX epoch scan and of the port's epoch loop under
    plain Adam, from the same params, on the same permutation, with JAX's
    per-step draws (``fold_in(key, i)`` then the step's split)."""
    jcfg, cfg = _cfgs(optimizer="adam", use_pallas_prior=False)
    train_x, _ = data
    jm, params, tm = _pair(jcfg, cfg)
    jb, tb = _banks(train_x)
    perm = np.random.default_rng(4).permutation(N_TRAIN)[:3 * B].reshape(3, B)
    key = jax.random.PRNGKey(11)
    tx = jopt.make_optimizer(jcfg)
    jstate = jsteps.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jstate, jm_metrics = jsteps.make_epoch_fn(jm, tx, jcfg, donate=False)(
        jstate, jnp.asarray(train_x), jnp.arange(N_TRAIN, dtype=jnp.int32),
        jnp.asarray(perm), jb, key, jnp.float32(BETA))
    noise = [tuple(torch.from_numpy(a) for a in _step_noise(
        jax.random.fold_in(key, i), (B, 28, 28, 1))) for i in range(3)]
    state = tsteps.init_train_state(tm, cfg)
    state, metrics = tsteps.make_epoch_fn(cfg)(
        state, torch.from_numpy(train_x),
        torch.arange(N_TRAIN, dtype=torch.int32), torch.from_numpy(perm), tb,
        BETA, noise=noise)
    assert state.step == 3
    for k in ("loss", "re", "kl"):
        np.testing.assert_allclose(float(metrics[k]), float(jm_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_epoch_loop_matches_hand_loop(data):
    """The epoch loop equals the train step called by hand on the same rows
    with the same generator draws (the bank preprocessed once per epoch, or
    per step: deterministic either way)."""
    _, cfg = _cfgs()
    train_x, _ = data
    perm = torch.from_numpy(
        np.random.default_rng(5).permutation(N_TRAIN)[:4 * B].reshape(4, B))
    results = []
    for by_hand in (False, True):
        tm = create_model(cfg, device="cpu", seed=2)
        _, tb = _banks(train_x)
        gen = torch.Generator().manual_seed(9)
        state = tsteps.init_train_state(tm, cfg)
        if by_hand:
            step = tsteps.make_train_step(cfg)
            losses = []
            for rows in perm:
                state, aux = step(state, torch.from_numpy(train_x)[rows],
                                  rows.to(torch.int32), tb, BETA,
                                  generator=gen)
                losses.append(aux["loss"])
            loss = torch.stack(losses).mean()
        else:
            state, m = tsteps.make_epoch_fn(cfg)(
                state, torch.from_numpy(train_x),
                torch.arange(N_TRAIN, dtype=torch.int32), perm, tb, BETA,
                generator=gen)
            loss = m["loss"]
        results.append((float(loss), [p.detach().clone()
                                      for p in tm.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_bank_preprocessed_in_bf16_when_compute_is_bf16(data):
    train_x, _ = data
    _, tb = _banks(train_x)
    for dtype, want in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        out = tsteps._preprocess_bank(tb, Config(compute_dtype=dtype))
        assert out.images.dtype == want
        # deterministic by default: the gray levels, not a Bernoulli draw
        torch.testing.assert_close(out.images.float(),
                                   tb.images.to(want).float())
    raw = tb._replace(images=(tb.images * 255).to(torch.uint8))
    assert tsteps._preprocess_bank(raw, Config()).images is raw.images


# ---------------------------------------------------------------------------
# validation ELBO
# ---------------------------------------------------------------------------


def test_elbo_eval_matches_jax(data):
    """Full batches of 16, then a tail of 2; JAX's per-batch draws
    (fold_in(key, i), then split) injected into the port."""
    jcfg, cfg = _cfgs(test_batch_size=16)
    train_x, _ = data
    jm, params, tm = _pair(jcfg, cfg)
    jb, tb = _banks(train_x)
    val_x = (np.random.default_rng(6).random((50, 28, 28, 1)) < 0.3).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    jbank = jev.make_eval_bank_fn(jm, jcfg)(params, jb, key)
    want = jev.make_elbo_eval_fn(jm, jcfg)(params, val_x, key, jbank)
    sizes = [16, 16, 16, 2]
    eps = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(jax.random.fold_in(key, i))[1], (s, D))))
        for i, s in enumerate(sizes)]
    tbank = tev.make_eval_bank_fn(tm, cfg)(tb)
    got = tev.make_elbo_eval_fn(tm, cfg)(val_x, tbank, eps=eps)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
