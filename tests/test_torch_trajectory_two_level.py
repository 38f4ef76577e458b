"""The port's whole training run against the JAX package's, across epochs:
the two-level models (HVAE, PixelHVAE, and the ConvHVAE binary and gray,
which the JAX package's own twin test marks slow).

The harness, the scale and what every case asserts are those of
tests/test_torch_trajectory.py (tests/_torch_trajectory.py replays the JAX
package's draws; z2's noise, then z1's, from split(k_z)). The conv and
PixelCNN widths are tools/parity_trajectory.py's.

Bounds (validation / IWAE nats / params), each no looser than the JAX
package's twin test, and the readings on an 8-core x86 CPU:

| case                                   | bound               | reading                   |
| HVAE exact, AdamNormGrad, 3 epochs     | 5e-3 / 5e-3 / 1e-4  | 1.2e-4 / 6.1e-5 / 1.0e-6  |
| PixelHVAE exact, AdamNormGrad, 3       | 5e-3 / 5e-3 / 1e-4  | 6.1e-5 / 6.1e-5 / 1.1e-6  |
| plain Adam, HVAE, 3                    | 5e-3 / 5e-3 / 1e-5  | 6.1e-5 / 6.1e-5 / 2.6e-7  |
| plain Adam, PixelHVAE, 3               | 5e-3 / 5e-3 / 1e-3  | 1.2e-4 / 1.2e-4 / 1.3e-4  |
| ConvHVAE binary, AdamNormGrad, 3 (slow)| 5e-3 / 5e-3 / 1e-4  | 6.1e-5 / 0 / 7.4e-7       |
| ConvHVAE gray, plain Adam, 3 (slow)    | 5e-3 / 5e-3 / 1e-3  | 4.9e-4 / 4.9e-4 / 7.6e-4  |

The JAX twin test's bounds are 1e-1 / 1e-1 / 3e-2 for the AdamNormGrad
HVAE and PixelHVAE (its twin's drift reached 0.03 nats), 1e-2 / 1e-2 /
param_tol for plain Adam, 5e-2 / 5e-2 / 1e-2 for the ConvHVAE binary and
1e-2 / 1e-2 / 1e-3 for the gray one. The gray head's params part most (its
sigmoids differ by an ulp between the frameworks; ROADMAP.md, Queue 3).
"""

import pytest

from _torch_trajectory import assert_trajectories, run_both

VAL_TOL = 5e-3


@pytest.mark.parametrize("model_name", ["hvae_2level", "pixelhvae_2level"])
def test_two_level_trajectory_matches_jax(tmp_path, model_name):
    """AdamNormGrad, 3 epochs: the level-1 KL, the (k2, k1) draw order, the
    logvar clamps and, for the PixelHVAE, the teacher-forced masked-conv
    decoder across epochs."""
    out = run_both(tmp_path, epochs=3, model_name=model_name)
    assert_trajectories(out, VAL_TOL, VAL_TOL, 1e-4)


@pytest.mark.parametrize("model_name,param_tol", [("hvae_2level", 1e-5),
                                                  ("pixelhvae_2level", 1e-3)])
def test_variance_reduced_two_level_trajectories_match_jax(tmp_path,
                                                           model_name,
                                                           param_tol):
    """Plain Adam, the JAX twin test's param_tol."""
    out = run_both(tmp_path, epochs=3, model_name=model_name,
                   optimizer="adam")
    assert_trajectories(out, VAL_TOL, VAL_TOL, param_tol)


@pytest.mark.slow
def test_conv_trajectory_matches_jax(tmp_path):
    """The ConvHVAE (SAME padding, transposed convs, the NHWC flatten, the
    gated conv split), AdamNormGrad, binary."""
    out = run_both(tmp_path, epochs=3, model_name="convhvae_2level")
    assert_trajectories(out, VAL_TOL, VAL_TOL, 1e-4)


@pytest.mark.slow
def test_conv_gray_logistic256_trajectory_matches_jax(tmp_path):
    """The ConvHVAE's logistic-256 head on gray data, plain Adam."""
    out = run_both(tmp_path, epochs=3, model_name="convhvae_2level",
                   input_type="gray", optimizer="adam")
    assert_trajectories(out, VAL_TOL, VAL_TOL, 1e-3)
