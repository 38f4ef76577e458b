"""The port's PixelHVAE against the benchmark's plain reference
(benchmark/portbench/reference/pixelhvae.py) at a tiny size on the CPU.

The port is built as the benchmark builds it (portbench/program.py's
``build_model``, the benchmark's seeded weights copied in); the reference
takes the same weights by their flax names. Sizes: 1x8x8 binary images,
hidden 16, z 4 + 4, 4 PixelCNN features, 2 masked 'B' layers, a bank of
N = 64. Compared: the eval bank's means, the teacher-forced Bernoulli
means, and one IWAE request's NLLs through ``serve.make_serving_fns`` with
injected noise; both decoders are causal; and the reference loads no JAX
and nothing of the port.

Tolerances. Both sides are fp32 on the CPU and run the same products in
other orders (the port's addmm and in-place adds against the reference's
matmul and separate adds), so elements may differ by a few ulps (measured
here: the bank means by 1.2e-7 at most, the Bernoulli means not at all,
the NLLs by 2.2e-7 relative). Bank means and Bernoulli means within 1e-5
relative and 1e-6 absolute, values of order 1; NLLs, sums of 64
log-probabilities and a log-sum-exp over S, within 1e-5 relative. A 'B'
mask without its centre tap moves the reference's NLLs by 5e-2 relative or
more at this size.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from portbench import program, weights  # noqa: E402
from portbench.reference import pixelhvae as ref  # noqa: E402

from exemplar_vae_tpu_torch import serve  # noqa: E402
from exemplar_vae_tpu_torch.train.evaluation import make_eval_bank_fn  # noqa: E402
from exemplar_vae_tpu_torch.train.loss import Bank  # noqa: E402

N, T, ROUNDS, R = 64, 3, 2, 4
MEANS_TOL = dict(rtol=1e-5, atol=1e-6)
NLL_RTOL = 1e-5
PROGRAM = dict(dataset_name="dynamic_mnist", model_name="pixelhvae_2level",
               prior="exemplar_prior", input_size=[1, 8, 8],
               input_type="binary", dynamic_binarization=True,
               hidden_size=16, z1_size=4, z2_size=4, pixelcnn_features=4,
               pixelcnn_layers=2, number_components=N, approximate_prior=False,
               prior_variance_init=1.0, q_logvar_min=-6.0,
               training_set_size=N, val_set_size=8, test_set_size=8,
               batch_size=8, test_batch_size=T, lr=5e-4,
               optimizer="adam_norm_grad", S=ROUNDS * R, MB=R,
               compute_dtype="float32", use_pallas_prior=True,
               exact_reencode_chunk=16, seed=14)
CPU = torch.device("cpu")


def _pair(seed=11):
    """(port model, reference, program dict) on the same seeded weights."""
    wts = weights.make_weights(ref.param_spec(PROGRAM), seed=seed, device=CPU)
    cfg = program.config(PROGRAM)
    model = program.build_model(cfg, wts, CPU).eval()
    return model, ref.Reference(PROGRAM, weights.reference_params(wts)), cfg


def _images(n, seed, binary=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 8, 8, 1), generator=g)
    return (x < 0.5).float() if binary else x


def _latents(n, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, PROGRAM["z1_size"]), generator=g),
            torch.randn((n, PROGRAM["z2_size"]), generator=g))


def _bank(model, cfg, images):
    return make_eval_bank_fn(model, cfg)(Bank(
        images=images, data_idx=torch.arange(N, dtype=torch.int32),
        valid=torch.ones(N, dtype=torch.bool), cache_means=None,
        n_effective=N))


def test_bank_means_match_the_reference():
    model, reference, cfg = _pair()
    images = _images(N, 1, binary=False)
    got = _bank(model, cfg, images).cache_means
    with torch.no_grad():
        want = reference.bank_means(images, 16)
    torch.testing.assert_close(got, want, **MEANS_TOL)


def test_teacher_forced_means_match_the_reference():
    model, reference, _ = _pair()
    x = _images(6, 2)
    z1, z2 = _latents(6, 3)
    with torch.no_grad():
        got = model.decode(x, z1, z2)[0].reshape(6, -1)
        want = reference.bernoulli_means(x.reshape(6, -1), z1, z2)
    torch.testing.assert_close(got, want, **MEANS_TOL)


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_an_iwae_request_matches_the_reference(seed):
    model, reference, cfg = _pair(seed)
    images = _images(N, 4, binary=False)
    bank = _bank(model, cfg, images)
    _, _, score = serve.make_serving_fns(model, cfg, N, 1, ROUNDS, R)
    x = _images(T, 5)
    g = torch.Generator().manual_seed(seed)
    eps = tuple(torch.randn((ROUNDS, T * R, k), generator=g)
                for k in ref.eps_widths(PROGRAM))
    got = score(x, bank.cache_means, bank.data_idx, bank.valid, eps=eps)
    with torch.no_grad():
        means = reference.bank_means(images, 16)
        want = reference.iwae_nll(x, eps, means, N, 5)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=NLL_RTOL)


def _means_of(decode, x, z1, z2):
    with torch.no_grad():
        return decode(x, z1, z2).reshape(x.shape[0], -1)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_the_decoder_is_causal(side):
    """Changing the pixels at raster index >= i leaves the means at <= i
    as they were, and changing pixel i - 1 moves the mean at i."""
    model, reference, _ = _pair()
    if side == "port":
        def decode(x, z1, z2):
            return model.decode(x, z1, z2)[0]
    else:
        def decode(x, z1, z2):
            return reference.bernoulli_means(x.reshape(x.shape[0], -1), z1,
                                             z2)
    x = _images(4, 6)
    z1, z2 = _latents(4, 7)
    base = _means_of(decode, x, z1, z2)
    for i in (0, 1, 9, 27, 63):
        flat = x.reshape(4, -1).clone()
        flat[:, i:] = 1.0 - flat[:, i:]
        moved = _means_of(decode, flat.reshape(x.shape), z1, z2)
        assert torch.equal(moved[:, :i + 1], base[:, :i + 1]), i
        if i:
            flat = x.reshape(4, -1).clone()
            flat[:, i - 1] = 1.0 - flat[:, i - 1]
            moved = _means_of(decode, flat.reshape(x.shape), z1, z2)
            assert not torch.equal(moved[:, i], base[:, i]), i


def test_the_reference_loads_no_jax_and_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.pixelhvae, portbench.flops.pixelhvae; "
            "from portbench.common import BANNED_MODULES, banned_loaded; "
            "print(banned_loaded(), sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('exemplar_vae_tpu_torch', 'tools')))"
            % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"

