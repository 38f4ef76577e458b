"""Checkpoints of the port against the JAX package's, on the CPU at a small
size (hidden 16, z 4, 64 training images, batch 16).

* The port's npz checkpoint has the JAX TrainState's keys (both optimizer
  chains, every model family) and moves between the packages bitwise in
  both directions: params, Adam moments and count, step, epoch, best_val,
  bad_epochs, best params and the approximate prior's cache.
* A restored port optimizer takes the step optax takes from the JAX state
  on the same fixed gradient: rtol 1e-6 on the updated params (the
  per-tensor gradient norms sum in another order).
* A resumed run equals an uninterrupted one bitwise; the crash windows of
  the two-rename commit and a stale .tmp are survived; a config-drifted or
  tampered checkpoint raises CheckpointMismatch; an orbax checkpoint is
  refused.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.train.checkpoints import _flatten_with_keys
from exemplar_vae_tpu.train.optimizer import make_optimizer as j_make_optimizer
from exemplar_vae_tpu.train.steps import init_train_state as j_init_state
from exemplar_vae_tpu.train.trainer import Experiment as JExperiment
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.train.checkpoints import CheckpointMismatch
from exemplar_vae_tpu_torch.train.optimizer import make_optimizer
from exemplar_vae_tpu_torch.train.trainer import Experiment
from exemplar_vae_tpu_torch.weights import (adam_state_prefix,
                                            params_from_flax, params_to_flax,
                                            train_state_to_keystr)

CASES = {
    "adam_norm_grad": {},
    "adam": dict(optimizer="adam"),
    "approximate": dict(approximate_prior=True, approximate_k=5),
}


def _jcfg(tmp_path, **kw):
    d = dict(dataset_name="synthetic", training_set_size=64, val_set_size=16,
             test_set_size=16, number_components=64, batch_size=16, warmup=1,
             epochs=2, S=2, MB=2, test_batch_size=16, use_pallas_prior=False,
             prior_block_n=32, exact_reencode_chunk=32, hidden_size=16,
             z1_size=4, z2_size=4, snapshot_dir=str(tmp_path))
    d.update(kw)
    return JConfig(**d)


def _cfg(tmp_path, **kw):
    return Config.from_json(_jcfg(tmp_path, **kw).to_json())


def _exp(cfg, **kw):
    return Experiment(cfg, device="cpu", verbose=False, **kw)


def _np(tree):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(tree))).items()}


def _port_trees(exp):
    """(params, mu, nu) of the port as {state_dict name: array}."""
    st = exp.state
    named = list(st.model.named_parameters())
    return ({n: p.detach().numpy() for n, p in named},
            {n: st.opt.state[p]["m"].numpy() for n, p in named},
            {n: st.opt.state[p]["v"].numpy() for n, p in named})


def _jax_trees(jexp):
    adam = jexp.state.opt_state[1 if jexp.cfg.optimizer == "adam_norm_grad"
                                else 0]
    return (_np(jexp.state.params), _np(adam.mu), _np(adam.nu),
            int(adam.count))


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_state(exp, jexp):
    params, mu, nu = _port_trees(exp)
    jparams, jmu, jnu, jcount = _jax_trees(jexp)
    for got, want in ((params, jparams), (mu, jmu), (nu, jnu)):
        _assert_trees_equal(got, want)
    assert exp.state.opt.count == jcount
    assert exp.state.step == int(jexp.state.step)
    assert (exp.epoch, exp.best_val, exp.bad_epochs) == (
        jexp.epoch, jexp.best_val, jexp.bad_epochs)
    _assert_trees_equal({k: v.numpy() for k, v in exp.best_params.items()},
                        _np(jexp.best_params))
    if exp.bank.cache_means is None:
        assert jexp.bank.cache_means is None
    else:
        np.testing.assert_array_equal(exp.bank.cache_means.numpy(),
                                      np.asarray(jexp.bank.cache_means))


@pytest.mark.parametrize("model,kw", [
    ("vae", {}), ("vae", dict(optimizer="adam")),
    ("vae", dict(prior="vampprior", number_components=6)),
    ("hvae_2level", {}),
    ("convhvae_2level", dict(conv_enc_spec="4k3s2", conv_dec_spec="t4k3s2",
                             conv_proj_channels=3)),
])
def test_state_keys_are_the_jax_train_state_keys(model, kw):
    jcfg = JConfig(model_name=model, hidden_size=8, z1_size=2, z2_size=3,
                   input_size=(1, 8, 8), **kw)
    jm, tx = j_create_model(jcfg), j_make_optimizer(jcfg)
    want = {k: np.asarray(v) for k, v in _flatten_with_keys(
        j_init_state(jm, tx, jcfg, jax.random.PRNGKey(0)))}
    cfg = Config.from_json(jcfg.to_json())
    tm = create_model(cfg, device="cpu")
    got = train_state_to_keystr(tm, make_optimizer(cfg, tm.parameters()), 0)
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k


def test_adam_state_prefix_follows_the_optax_chains():
    assert adam_state_prefix(True) == ".opt_state[1]"
    assert adam_state_prefix(False) == ".opt_state[0]"


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_restores_into_port(tmp_path, case):
    jcfg = _jcfg(tmp_path, **CASES[case])
    jexp = JExperiment(jcfg, verbose=False)
    jexp.train_epoch()
    jexp.best_val, jexp.bad_epochs = 123.5, 1
    jexp.save_checkpoint()

    exp = _exp(Config.from_json(jcfg.to_json()))
    assert exp.exp_dir == jexp.exp_dir
    assert exp.restore_checkpoint()
    _assert_same_state(exp, jexp)

    # one optimizer step on a fixed gradient from both restored states
    rng = np.random.default_rng(0)
    grads = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
             for n, p in exp.model.named_parameters()}
    for n, p in exp.model.named_parameters():
        p.grad = torch.from_numpy(grads[n].copy())
    exp.state.opt.step()
    jgrads = params_to_flax({n: torch.from_numpy(g) for n, g in grads.items()})
    updates, _ = jexp.tx.update(jgrads, jexp.state.opt_state,
                                jexp.state.params)
    want = _np(optax.apply_updates(jexp.state.params, updates))
    for n, p in exp.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=1e-9, err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_restores_into_jax(tmp_path, case):
    jcfg = _jcfg(tmp_path, **CASES[case])
    exp = _exp(Config.from_json(jcfg.to_json()))
    exp.train_epoch()
    exp.best_val, exp.bad_epochs = 77.25, 2
    exp.save_checkpoint("final")

    jexp = JExperiment(jcfg, verbose=False)
    assert jexp.exp_dir == exp.exp_dir
    assert jexp.restore_checkpoint("final")
    _assert_same_state(exp, jexp)


@pytest.mark.parametrize("case", ["adam_norm_grad", "approximate"])
def test_resume_equals_uninterrupted_run(tmp_path, case):
    """Two epochs straight, and one epoch, save, restore into a fresh
    Experiment and one more: the same params, moments, best params and
    epoch metrics, bitwise."""
    kw = dict(CASES[case], checkpoint_every=1)
    straight = _exp(_cfg(tmp_path / "straight", **kw))
    straight.run(max_epochs=2)
    first = _exp(_cfg(tmp_path / "resumed", **kw))
    first.run(max_epochs=1)
    resumed = _exp(_cfg(tmp_path / "resumed", **kw))
    assert resumed.restore_checkpoint() and resumed.epoch == 1
    resumed.run(max_epochs=2)
    for a, b in zip(_port_trees(straight), _port_trees(resumed)):
        _assert_trees_equal(a, b)
    assert (straight.state.opt.count, straight.state.step) == (
        resumed.state.opt.count, resumed.state.step)
    for k, v in straight.best_params.items():
        assert torch.equal(v, resumed.best_params[k]), k

    def epochs(e):
        with open(e._metrics_path) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k not in ("epoch_seconds", "images_per_sec")}
                    for line in f if '"epoch"' in line]

    assert epochs(straight) == epochs(resumed)


def test_checkpoint_save_is_atomic_and_crash_recoverable(tmp_path):
    """The ckpt_<tag> directory is the atomic unit: built at .tmp and
    committed with two renames; between them the previous generation sits
    at .old, which restore falls back to and the next save promotes back
    first; a stale .tmp is ignored by restore and cleared by the next save
    (tests/test_training.py's crash windows)."""
    cfg = _cfg(tmp_path)
    exp = _exp(cfg)
    exp.train_epoch()
    exp.best_val = 42.0
    exp.save_checkpoint()
    d = os.path.join(exp.exp_dir, "ckpt_last")
    assert os.path.exists(os.path.join(d, "meta.json"))
    assert not os.path.exists(d + ".tmp")
    assert not os.path.exists(d + ".old")

    os.replace(d, d + ".old")            # the crash window between renames
    exp2 = _exp(cfg)
    assert exp2.restore_checkpoint()
    assert exp2.epoch == 1 and exp2.best_val == 42.0

    exp2.save_checkpoint()
    assert os.path.exists(os.path.join(d, "meta.json"))
    assert not os.path.exists(d + ".old")
    assert not os.path.exists(d + ".tmp")
    exp3 = _exp(cfg)
    assert exp3.restore_checkpoint()
    assert exp3.epoch == 1 and exp3.best_val == 42.0

    os.makedirs(d + ".tmp")              # a half-written tmp of a crash
    exp4 = _exp(cfg)
    assert exp4.restore_checkpoint()
    assert exp4.epoch == 1 and exp4.best_val == 42.0
    exp4.save_checkpoint()
    assert not os.path.exists(d + ".tmp")


def test_restore_without_checkpoint_returns_false(tmp_path):
    assert not _exp(_cfg(tmp_path)).restore_checkpoint()


def _tamper_dtype(path):
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    k = ".params['prior_log_var']"
    flat[k] = flat[k].astype(np.float64)
    np.savez(path, **flat)


@pytest.mark.parametrize("drift", ["shape", "keys", "dtype"])
def test_checkpoint_mismatch_fails_loudly(tmp_path, drift):
    """A restore into a config with other parameter shapes (hidden size),
    another key set (the other optimizer chain) or a leaf of another dtype
    raises rather than loading garbage."""
    cfg = _cfg(tmp_path)
    exp = _exp(cfg)
    exp.save_checkpoint()
    if drift == "dtype":
        _tamper_dtype(os.path.join(exp.exp_dir, "ckpt_last", "state.npz"))
        other = cfg
    else:
        other = cfg.replace(**({"hidden_size": 24} if drift == "shape"
                               else {"optimizer": "adam"}))
    exp2 = _exp(other, exp_dir=exp.exp_dir)
    with pytest.raises(CheckpointMismatch,
                       match="structure" if drift == "keys" else "expects"):
        exp2.restore_checkpoint()


def test_orbax_checkpoint_is_refused(tmp_path):
    exp = _exp(_cfg(tmp_path))
    exp.save_checkpoint()
    meta_p = os.path.join(exp.exp_dir, "ckpt_last", "meta.json")
    with open(meta_p) as f:
        meta = json.load(f)
    with open(meta_p, "w") as f:
        json.dump(dict(meta, backend="orbax"), f)
    with pytest.raises(NotImplementedError, match="npz checkpoints only"):
        exp.restore_checkpoint()
