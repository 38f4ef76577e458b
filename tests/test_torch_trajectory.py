"""The port's whole training run against the JAX package's, across epochs:
the single-level VAE (exact, vampprior and approximate-kNN priors, and a
run that early stopping ends).

Each case trains the JAX package's Experiment and the port's Experiment
(on the CPU) through one trajectory: the same flax initial params, the
same static data, the JAX package's own permutations and noise replayed
into the port's seams (tests/_torch_trajectory.py). The run loop, beta, the
optimizer, best-on-val, early stopping, the cache refresh and the final
IWAE on the best params are each package's own. The scale is
tests/test_trajectory_parity.py's (256 train, 64 validation, 32 test,
hidden 32, z 8, S 8, MB 4, seed 7); so are the epochs of each case.

Every case asserts, per epoch, equal beta and best flags in the two
metrics.jsonl files, equal epochs trained, the largest per-epoch
validation-loss difference, the final IWAE NLL difference and the largest
difference of the best params, and a last validation loss at least 1 nat
below the first.

Bounds (validation / IWAE nats / params), each no looser than the JAX
package's twin test, and the readings on an 8-core x86 CPU (val losses
~550-640 nats, where one fp32 ulp is 6e-5):

| case                                  | bound                | reading                     |
| VAE exact, AdamNormGrad, 4 epochs     | 5e-3 / 5e-3 / 1e-4   | 1.2e-4 / 0 / 4.0e-6         |
| VAE vampprior (24), AdamNormGrad, 3   | 5e-3 / 5e-3 / 1e-4   | 0 / 0 / 8.9e-7              |
| approximate kNN K=4, batch 32, Adam, 4| 5e-3 / 5e-3 / 1e-4   | 1.2e-4 / 6.1e-5 / 5.7e-6    |
| plain Adam, VAE exact, 3              | 5e-3 / 5e-3 / 1e-5   | 6.1e-5 / 0 / 5.0e-7         |
| plain Adam, VAE vampprior, 3          | 5e-3 / 5e-3 / 1e-2   | 6.7e-4 / 1.8e-4 / 4.6e-3    |
| early stopping (below)                | 5e-2 / 5e-2 / 1e-2   | 8.1e-3 / 8.4e-4 / 7.2e-4    |

The JAX twin test's bounds are 2e-2 / 2e-2 / 1e-4 (exact), 1e-1 / 1e-1 /
3e-2 (vampprior), 1e-2 / 1e-2 / 1e-4 (approximate) and 1e-2 / 1e-2 /
param_tol (plain Adam).
"""

import pytest

from _torch_trajectory import assert_trajectories, run_both

VAL_TOL = 5e-3


def test_vae_exact_trajectory_matches_jax(tmp_path):
    """AdamNormGrad, the reference optimizer, 4 epochs with a 2-epoch
    warm-up: beta, AdamNormGrad's state across 16 steps and the final
    IWAE on the best params."""
    out = run_both(tmp_path, epochs=4)
    assert_trajectories(out, VAL_TOL, VAL_TOL, 1e-4)


def test_vamp_trajectory_matches_jax(tmp_path):
    """The vampprior: 24 trainable pseudo-inputs started from the first 24
    training images."""
    out = run_both(tmp_path, epochs=3, prior="vampprior")
    assert_trajectories(out, VAL_TOL, VAL_TOL, 1e-4)


def test_approximate_knn_trajectory_matches_jax(tmp_path):
    """The approximate prior (K = 4 per row) over a cache that both
    packages refresh at the start of every epoch with the params the
    previous epoch ended with; plain Adam, batch 32."""
    out = run_both(tmp_path, epochs=4, batch=32, optimizer="adam",
                   approximate_k=4)
    assert_trajectories(out, VAL_TOL, VAL_TOL, 1e-4)


@pytest.mark.parametrize("prior,param_tol", [("exemplar_prior", 1e-5),
                                             ("vampprior", 1e-2)])
def test_variance_reduced_trajectories_match_jax(tmp_path, prior, param_tol):
    """Plain Adam keeps the two trajectories contractive, so a systematic
    drift cannot hide in AdamNormGrad's amplified rounding; the params are
    held to the JAX twin test's param_tol (the pseudo-inputs take large
    raw gradients)."""
    out = run_both(tmp_path, epochs=3, prior=prior, optimizer="adam")
    assert_trajectories(out, VAL_TOL, VAL_TOL, param_tol)


def test_early_stopping_trajectory_matches_jax(tmp_path):
    """Early stopping fires: patience 1 and a 1-epoch warm-up, so the
    first epoch after the warm-up whose validation loss does not improve
    ends the run. The config was found by running the JAX Experiment alone
    over lr in {5e-3, 2e-2, 5e-2, 1e-1} and both optimizers for up to 10
    epochs: at the default lr 5e-4 and up to 2e-2 the validation loss
    falls every epoch; AdamNormGrad at lr 5e-2 is the first that stops
    with a finite, falling run. JAX: validation 400.956, 268.276,
    236.247, 237.596, so it stops after epoch 4 of 8 with epoch 3 best,
    1.35 nats ahead of epoch 4, far beyond the two packages' difference.
    The bounds are looser than the other cases' because lr is 100 times
    the default, and AdamNormGrad moves each param by up to lr a step."""
    out = run_both(tmp_path, epochs=8, warmup=1, early_stopping_epochs=1,
                   lr=5e-2)
    assert_trajectories(out, 5e-2, 5e-2, 1e-2)
    for rec in (out["jax"], out["port"]):
        assert [r["epoch"] for r in rec] == [1, 2, 3, 4]
        assert [r["epoch"] for r in rec if r.get("best")][-1] == 3
