"""Run the JAX package's Experiment and the port's Experiment through one
training trajectory and compare them (tests/test_torch_trajectory*.py).

Both start from the same flax params (weights.params_from_flax) and train on
the same static data (dynamic binarization off, as
tools/parity_trajectory.py sets it), so the only random inputs are the
epoch permutations and the reparameterization noise. The port is given the
JAX package's own draws, replayed by its key discipline
(tools/parity_trajectory.py:16-33):

  epoch e:  ekey = fold_in(PRNGKey(seed), e)
            perm = permutation(fold_in(ekey, 2), N)[:S*B]
            step i: (_, _, k_z) = split(fold_in(fold_in(ekey, 3), i), 3)
  val:      batch i: (_, k_z) = split(fold_in(fold_in(fold_in(key,
                                     1_000_003), 5), i))
  IWAE:     chunk i: (_, k_s) = split(fold_in(fold_in(fold_in(key,
                                      999_983), 1), i))
            round j: k_z = fold_in(k_s, j)

and from k_z the model's draw: normal(k_z, (b, z1)) for the VAE; for the
two-level models (k2, k1) = split(k_z), normal(k2, (b, z2)) then
normal(k1, (b, z1)).

The draws enter the port only through its seams: Experiment.epoch_perm, the
epoch loop's ``noise=``, the validation ELBO's and the IWAE's ``eps=``.
Everything else, the run loop, beta, the optimizer, best-on-val, early
stopping, the cache refresh and the final evaluation, is the port's own
code. The JAX side runs the scan prior (use_pallas_prior=False), as
tools/parity_trajectory.py does; the port runs its default, the kernel
path, whose plain version runs on the CPU.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.train.trainer import Experiment as JExperiment
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.train.trainer import Experiment
from exemplar_vae_tpu_torch.weights import params_from_flax

# the JAX trainer's fold-in constants of its evaluation keys
VAL_FOLD, TEST_FOLD = 1_000_003, 999_983


def _normal(k, shape):
    return torch.from_numpy(np.array(jax.random.normal(k, shape,
                                                       dtype=jnp.float32)))


class JaxDraws:
    """The JAX Experiment's permutations and reparameterization noise for
    a run of ``cfg`` (the loader-resolved JAX config)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.key = jax.random.PRNGKey(cfg.seed)
        self.two_level = cfg.model_name != "vae"

    def eps(self, k_z, b):
        """The model's reparameterization draw of ``b`` rows from k_z."""
        c = self.cfg
        if not self.two_level:
            return _normal(k_z, (b, c.z1_size))
        k2, k1 = jax.random.split(k_z)
        return (_normal(k2, (b, c.z2_size)), _normal(k1, (b, c.z1_size)))

    def perm(self, epoch, n_train, steps, batch):
        ekey = jax.random.fold_in(self.key, epoch)
        p = jax.random.permutation(jax.random.fold_in(ekey, 2), n_train)
        return torch.from_numpy(
            np.asarray(p[:steps * batch], np.int64).reshape(steps, batch))

    def step_noise(self, epoch, steps, batch):
        """Per step (u, eps): static data draws no uniforms."""
        skey = jax.random.fold_in(jax.random.fold_in(self.key, epoch), 3)
        return [(None, self.eps(jax.random.split(
            jax.random.fold_in(skey, i), 3)[2], batch))
            for i in range(steps)]

    def val_eps(self, n):
        """One draw per validation batch: the full batches, then the tail."""
        vkey = jax.random.fold_in(jax.random.fold_in(self.key, VAL_FOLD), 5)
        batch = min(self.cfg.test_batch_size, n)
        sizes = [batch] * (n // batch) + ([n % batch] if n % batch else [])
        return [self.eps(jax.random.split(jax.random.fold_in(vkey, i))[1], b)
                for i, b in enumerate(sizes)]

    def iwae_eps(self, test_shape):
        """Per IWAE chunk the stacked draws of its rounds: (rounds, t*r, z1),
        or the pair (z2's, z1's) for the two-level models. The chunk is the
        one both packages' autotune picks."""
        c = self.cfg
        r = min(c.MB, c.S)
        rounds = max(-(-c.S // r), 1)
        d_in = int(np.prod(test_shape[1:]))
        chunk = max(1, min(c.test_batch_size,
                           max(4096, 268_435_456 // (d_in * 4)) // r))
        ikey = jax.random.fold_in(jax.random.fold_in(self.key, TEST_FOLD), 1)
        out = []
        for i, start in enumerate(range(0, test_shape[0], chunk)):
            t = min(chunk, test_shape[0] - start)
            k_s = jax.random.split(jax.random.fold_in(ikey, i))[1]
            draws = [self.eps(jax.random.fold_in(k_s, j), t * r)
                     for j in range(rounds)]
            out.append(tuple(torch.stack(e) for e in zip(*draws))
                       if self.two_level else torch.stack(draws))
        return out


class ReplayExperiment(Experiment):
    """The port's Experiment on the CPU, started from ``init_params`` (a
    flax tree) and fed ``draws``' permutations and noise through its seams."""

    def __init__(self, cfg, init_params, draws: JaxDraws):
        super().__init__(cfg, device="cpu", verbose=False)
        self.draws = draws
        self.model.load_state_dict(params_from_flax(init_params))
        self.best_params = self._params_on_cpu()
        epoch_fn, elbo_eval, iwae = self.epoch_fn, self.elbo_eval, self.iwae

        def replay_epoch(state, train_x, train_idx, perm, bank, beta, *,
                         generator=None):
            steps, batch = perm.shape
            return epoch_fn(state, train_x, train_idx, perm, bank, beta,
                            generator=generator,
                            noise=draws.step_noise(self.epoch, steps, batch))

        def replay_elbo(images, bank, *, generator=None):
            return elbo_eval(images, bank, eps=draws.val_eps(images.shape[0]))

        def replay_iwae(images, bank, *, generator=None):
            return iwae(images, bank, eps=draws.iwae_eps(tuple(images.shape)))

        self.epoch_fn, self.elbo_eval, self.iwae = (replay_epoch, replay_elbo,
                                                    replay_iwae)

    def epoch_perm(self, steps, batch):
        return self.draws.perm(self.epoch, self.n_train, steps, batch)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if "val_loss" in line]


def run_both(tmp_path, *, epochs, n_train=256, val=64, test=32, hidden=32,
             z=8, batch=64, warmup=2, S=8, MB=4, seed=7, model_name="vae",
             prior="exemplar_prior", n_pseudo=24, approximate_k=None,
             optimizer="adam_norm_grad", input_type="binary",
             early_stopping_epochs=None, **extra):
    """Train both packages through one trajectory; returns their per-epoch
    metrics records, results and the largest differences. The config is
    tools/parity_trajectory.py::run_parity's (the conv and PixelCNN widths
    included); ``extra`` overrides any field of it."""
    kw = dict(
        dataset_name={"binary": "synthetic",
                      "gray": "synthetic_gray"}[input_type],
        dynamic_binarization_override=False, training_set_size=n_train,
        val_set_size=val, test_set_size=test,
        number_components=n_pseudo if prior == "vampprior" else n_train,
        use_training_data_init=prior == "vampprior", model_name=model_name,
        prior=prior, approximate_prior=approximate_k is not None,
        approximate_k=approximate_k or 10, hidden_size=hidden,
        optimizer=optimizer, conv_enc_spec="8k7s1,8k3s2,16k5s1,16k3s2",
        conv_dec_spec="t16k3s2,t8k3s2,c8k3s1", conv_proj_channels=16,
        pixelcnn_features=8, pixelcnn_layers=2, z1_size=z, z2_size=z,
        batch_size=batch, test_batch_size=val, warmup=warmup, epochs=epochs,
        early_stopping_epochs=(epochs + 1 if early_stopping_epochs is None
                               else early_stopping_epochs),
        S=S, MB=MB, seed=seed, prior_block_n=max(64, n_train // 4),
        exact_reencode_chunk=max(64, n_train // 4))
    kw.update(extra)

    jcfg = JConfig(**kw, use_pallas_prior=False,
                   snapshot_dir=str(tmp_path / "jax"))
    jexp = JExperiment(jcfg, verbose=False)
    assert not jexp.cfg.dynamic_binarization
    init_params = jax.device_get(jexp.state.params)
    jres = jexp.run(max_epochs=epochs)

    cfg = Config(**kw, use_pallas_prior=True,
                 snapshot_dir=str(tmp_path / "port"))
    exp = ReplayExperiment(cfg, init_params, JaxDraws(jexp.cfg))
    for name in ("train_x", "train_idx", "val_x", "test_x"):
        np.testing.assert_array_equal(getattr(exp.splits, name),
                                      getattr(jexp.splits, name), name)
    assert exp.cfg.input_type == jexp.cfg.input_type == input_type
    res = exp.run(max_epochs=epochs)

    jrec, rec = _records(jexp._metrics_path), _records(exp._metrics_path)
    want = params_from_flax(jexp.best_params)
    assert want.keys() == exp.best_params.keys()
    return {
        "jax": jrec, "port": rec, "jax_results": jres, "port_results": res,
        "max_val_diff": max(abs(a["val_loss"] - b["val_loss"])
                            for a, b in zip(jrec, rec)),
        "nll_diff": abs(jres["test_nll"] - res["test_nll"]),
        "max_param_diff": max(float((exp.best_params[k] - v).abs().max())
                              for k, v in want.items()),
    }


def assert_trajectories(out, val_tol, nll_tol, param_tol):
    """The bounds, and what every case asserts beside them: per epoch equal
    beta and best flags, equal epochs trained, and a first validation loss
    at least 1 nat above the last (the comparison is not vacuous)."""
    jrec, rec = out["jax"], out["port"]
    summary = {k: out[k] for k in ("max_val_diff", "nll_diff",
                                   "max_param_diff")}
    assert len(rec) == len(jrec) > 0, summary
    for a, b in zip(jrec, rec):
        assert a["epoch"] == b["epoch"] and a["beta"] == b["beta"], (a, b)
        assert a.get("best") == b.get("best"), (a, b)
    assert (out["port_results"]["epochs_trained"]
            == out["jax_results"]["epochs_trained"] == len(jrec))
    assert out["max_val_diff"] < val_tol, summary
    assert out["nll_diff"] < nll_tol, summary
    assert out["max_param_diff"] < param_tol, summary
    assert jrec[-1]["val_loss"] < jrec[0]["val_loss"] - 1.0, summary

