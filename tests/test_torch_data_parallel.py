"""The port's data-parallel training: each rank of a gloo mesh on the CPU
trains on its own rows of every batch, and W ranks equal one process.

Two module-scoped child runs of tests/_torch_mp_child.py: ``dp`` on 2
ranks (batch 16, 8 rows each) and ``dp3`` on 3 ranks (batch 10, split
4 / 3 / 3). Each rank holds its shard of a bank of 45 exemplars padded to a
multiple of the mesh (index -2, valid False) and its rows of the batch; the
one-process references run here from the same params, batch and generator
seed (on the children's thread count), as does one process that sums
each batch in the ranks' row blocks (_torch_mp_child.make_block_train_step)
where the order of the sums shows; the data-parallel exact prior is also
held against the JAX package's make_sharded_exact_prior on a mesh of 2 of
conftest's 8 CPU devices with z placed P("data").

Tolerances (fp32): prior values and losses rtol 1e-5, each gradient tensor
within 1e-4 of its largest element, epoch metrics rtol 1e-5, params after
an epoch rtol 1e-5 / atol 1e-6 (test_torch_sharding.
_assert_params_after_steps); draws, what each rank's forward sees,
generator states and the ranks' params bitwise.
"""

import hashlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.parallel.mesh import create_mesh as j_create_mesh
from exemplar_vae_tpu.parallel.sharded_prior import \
    make_sharded_exact_prior as j_make_sharded_exact_prior
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.parallel.mesh import Mesh, pad_to_shards
from exemplar_vae_tpu_torch.train import steps as tsteps
from exemplar_vae_tpu_torch.train.loss import Bank
from exemplar_vae_tpu_torch.weights import params_from_flax

from _torch_mp_child import epoch_case, step_case
from test_torch_sharding import (CHILD_THREADS, _assert_grads,
                                 _assert_params_after_steps, _one_rank_prior,
                                 _run_ranks)

N, N_TRAIN, HW, K = 45, 50, 16, 4
SMALL_CONV = dict(conv_enc_spec="4k3s1,4k3s2,8k3s1,8k3s2",
                  conv_dec_spec="t8k3s2,t4k3s2,c4k3s1", conv_proj_channels=5)
# name -> its Config fields; every case: hidden 32, z 8, a bank of 45
CASES = {
    "vae_exact": dict(model_name="vae"),
    "hvae_exact": dict(model_name="hvae_2level"),
    "convhvae_per_row": dict(model_name="convhvae_2level",
                             input_size=(1, HW, HW), input_type="gray",
                             dynamic_binarization=False,
                             approximate_prior=True, approximate_k=K,
                             **SMALL_CONV),
    "convhvae_batch_union": dict(model_name="convhvae_2level",
                                 input_size=(1, HW, HW), input_type="gray",
                                 dynamic_binarization=False,
                                 approximate_prior=True, approximate_k=K,
                                 approximate_support="batch_union",
                                 **SMALL_CONV),
    "vae_standard": dict(model_name="vae", prior="standard"),
    # Config 4's shape at 16x16: 3-channel continuous uint8 batch and raw
    # bank, per-row support, the bank's preprocessing stochastic so that
    # its (B*K, ...) uniforms are drawn whole and split by rows too
    "convhvae_uint8_rgb": dict(model_name="convhvae_2level",
                               input_size=(3, HW, HW),
                               input_type="continuous",
                               dynamic_binarization=False,
                               approximate_prior=True, approximate_k=K,
                               bank_stochastic_preprocess=True, **SMALL_CONV),
}
# the same with the logistic-256 head at the model's own initial scale
CASES["convhvae_uint8_rgb_init_head"] = CASES["convhvae_uint8_rgb"]
EPOCH_CASES = ("vae_exact", "vae_standard", "convhvae_per_row")
UNEVEN_CASES = ("vae_exact", "convhvae_uint8_rgb")
INIT_HEAD = "convhvae_uint8_rgb_init_head"


def _case(name, batch, seed):
    """Inputs of one case: config, params, a batch of ``batch`` rows (some
    not in the bank), the bank of the first N training images (and a cache
    for the approximate prior), the generator seed; for an epoch case also
    the training set and a (2, batch) permutation."""
    cfg = Config(hidden_size=32, z1_size=8, z2_size=8, number_components=N,
                 prior_variance_init=0.6, prior_block_n=8,
                 exact_reencode_chunk=10, exact_remat=False,
                 approx_remat=False, **CASES[name])
    rng = np.random.default_rng(seed)
    c, h, w = cfg.input_size
    if cfg.input_type == "continuous":
        train_x = rng.integers(0, 256, (N_TRAIN, h, w, c), dtype=np.uint8)
    else:
        train_x = rng.random((N_TRAIN, h, w, c)).astype(np.float32)
    train_x = torch.from_numpy(train_x)
    rows = torch.from_numpy(rng.permutation(N_TRAIN)[:batch])
    dz = cfg.z1_size if cfg.model_name == "vae" else cfg.z2_size
    params = {k: v.clone() for k, v in create_model(
        cfg, device="cpu", seed=seed).state_dict().items()}
    if "p_x_logvar_head.bias" in params and name != INIT_HEAD:
        # the logistic-256 head started near -4, a trained model's range:
        # at scale ~1 a bin's mass is the difference of two sigmoids near
        # 0.5, and two summation orders of the batch then part its
        # gradients by ~1e-4 relative; INIT_HEAD keeps the model's scale
        params["p_x_logvar_head.bias"] -= 4.0
    return dict(
        cfg=cfg.to_json(), beta=0.7, seed=seed + 100, params=params,
        x=train_x[rows], idx=rows.to(torch.int32), bank_images=train_x[:N],
        cache=(torch.from_numpy(rng.normal(size=(N, dz)).astype(np.float32))
               if cfg.approximate_prior else None),
        train_x=train_x,
        train_idx=torch.arange(N_TRAIN, dtype=torch.int32),
        perm=torch.from_numpy(rng.permutation(N_TRAIN)[:2 * batch]
                              .reshape(2, batch)))


def _prior_inputs():
    """The exact prior's inputs: a VAE's flax params, a bank of 45 padded to
    46, z (16, 8), LOO indices in both shards and outside the bank, a
    cotangent."""
    jcfg = JConfig(model_name="vae", hidden_size=32, z1_size=8,
                   mesh_shape=(2,), use_pallas_prior=False, prior_block_n=8,
                   exact_reencode_chunk=10, prior_variance_init=0.6)
    cfg = Config.from_json(jcfg.to_json()).replace(use_pallas_prior=True)
    jm = j_create_model(jcfg)
    rng = np.random.default_rng(7)
    imgs = rng.random((N, 28, 28, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    params = jm.init(key, jnp.asarray(imgs[:2]), key)["params"]
    padded, _ = pad_to_shards(imgs, 2)
    n_pad = padded.shape[0]
    data_idx = np.where(np.arange(n_pad) < N, np.arange(n_pad), -2)
    loo = rng.permutation(N + 5)[:16].astype(np.int32)
    inputs = dict(
        cfg=cfg.to_json(), params=params_from_flax(jax.tree.map(np.asarray,
                                                                 params)),
        images=torch.from_numpy(padded),
        data_idx=torch.from_numpy(data_idx.astype(np.int32)),
        valid=torch.from_numpy(np.arange(n_pad) < N), n=N,
        z=torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
        loo=torch.from_numpy(loo),
        cot=torch.from_numpy(rng.normal(size=16).astype(np.float32)),
        log_denom=math.log(N - 1.0))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params, inputs=inputs)


def _one_process(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(CHILD_THREADS)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _run(scenario, work, world, batch, names, epochs=(), prior=None,
         blocks=()):
    steps = {n: _case(n, batch, seed=i) for i, n in enumerate(names)}
    epoch_in = {n: _case(n, batch, seed=20 + i) for i, n in enumerate(epochs)}
    inputs = {"cfg": Config(mesh_shape=(world,)).to_json(), "steps": steps,
              "epochs": epoch_in}
    if prior is not None:
        inputs["prior"] = prior["inputs"]
    outs = _run_ranks(scenario, work, inputs, world=world)
    refs = {n: _one_process(step_case, c) for n, c in steps.items()}
    block_refs = {n: _one_process(step_case, steps[n], None, world)
                  for n in blocks}
    epoch_refs = {n: dict(_one_process(epoch_case, c), blocks=_one_process(
        epoch_case, c, None, world)["params"]) for n, c in epoch_in.items()}
    return dict(steps=steps, outs=outs, refs=refs, block_refs=block_refs,
                epoch_refs=epoch_refs, prior=prior, world=world, batch=batch)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    return _run("dp", tmp_path_factory.mktemp("dp"), 2, 16, list(CASES),
                epochs=EPOCH_CASES, prior=_prior_inputs())


@pytest.fixture(scope="module")
def dp3(tmp_path_factory):
    return _run("dp3", tmp_path_factory.mktemp("dp3"), 3, 10,
                UNEVEN_CASES + (INIT_HEAD,), blocks=(INIT_HEAD,))


def _rows(world, batch):
    return [Mesh(size=world, rank=r, device=torch.device("cpu"))
            .batch_rows(batch) for r in range(world)]


def _pair(eps):
    """The VAE's eps tensor or the two-level models' (eps2, eps1), as a
    tuple."""
    return eps if isinstance(eps, tuple) else (eps,)


def _assert_step(run, name, grads_ref="refs"):
    ref, world = run["refs"][name], run["world"]
    for r, out in enumerate(run["outs"]):
        got = out["steps"][name]
        np.testing.assert_allclose(got["terms"].numpy(), ref["terms"].numpy(),
                                   rtol=1e-5, err_msg=f"{name} rank {r}")
        _assert_grads(got["grads"], run[grads_ref][name]["grads"],
                      f"{name} rank {r}")
    first = run["outs"][0]["steps"][name]["grads"]
    for out in run["outs"][1:world]:
        for k, g in out["steps"][name]["grads"].items():
            assert torch.equal(g, first[k]), (name, k)


# ---------------------------------------------------------------------------
# the batch split (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,w", [(16, 2), (10, 3), (100, 8)])
def test_batch_rows_split_as_tensor_split(b, w):
    """Each rank's [lo, hi) are torch.tensor_split's blocks: contiguous,
    rank-major, the first b mod w one row longer (100 on 3: 34/33/33)."""
    want = [(int(t[0]), int(t[-1]) + 1)
            for t in torch.tensor_split(torch.arange(b), w)]
    assert _rows(w, b) == want


def test_batch_smaller_than_mesh_raises():
    with pytest.raises(ValueError, match="without rows"):
        Mesh(size=4, rank=3, device=torch.device("cpu")).batch_rows(3)


# ---------------------------------------------------------------------------
# the data-parallel exact prior
# ---------------------------------------------------------------------------


def _jax_prior(o):
    """JAX's make_sharded_exact_prior on a mesh of 2, z and the LOO indices
    placed P("data") (batch-sharded), the bank P("data")."""
    inp, jcfg, jm = o["inputs"], o["jcfg"], o["jm"]
    mesh = j_create_mesh(jcfg)
    rows, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    prior_fn = j_make_sharded_exact_prior(jm, jcfg, mesh)
    bank = jloss.Bank(*(jax.device_put(jnp.asarray(inp[k].numpy()), shard)
                        for k in ("images", "data_idx", "valid")), None, N)
    z = jax.device_put(jnp.asarray(inp["z"].numpy()), shard)
    loo = jax.device_put(jnp.asarray(inp["loo"].numpy()), shard)
    cot = jax.device_put(jnp.asarray(inp["cot"].numpy()), rows)

    def f(v, z):
        out = prior_fn(v, z, loo, bank, jnp.float32(inp["log_denom"]))
        return jnp.sum(cot * out), out

    (_, val), (gv, gz) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))({"params": o["params"]}, z)
    assert z.sharding.spec == P("data")
    return (np.asarray(val), np.asarray(gz),
            {k: v.numpy() for k, v in params_from_flax(jax.tree.map(
                np.asarray, gv["params"])).items()})


@pytest.mark.parametrize("reference", ["port_one_process", "jax_mesh_of_2"])
def test_data_parallel_exact_prior(dp, reference):
    """2 ranks, each with 8 of the 16 rows of z and 23 of the bank's 46
    rows: z gathered through AllGatherRows, each shard's LSE combined in
    log space, each rank's rows returned; the gathered prior, the z
    gradient (AllGatherRows' reduce-scatter) and the encoder and
    prior_log_var gradients (averaged) as on one process and as JAX's."""
    o = dp["prior"]
    val, gz, grads = (_one_rank_prior(o) if reference == "port_one_process"
                      else _jax_prior(o))
    assert np.abs(grads["prior_log_var"]).max() > 0
    for out in dp["outs"]:
        got = out["prior"]
        np.testing.assert_allclose(got["prior"].numpy(), val, rtol=1e-5)
        _assert_grads({"z": got["z_grad"]}, {"z": gz}, reference)
        _assert_grads(got["grads"], grads, reference)
    a, b = (out["prior"]["grads"] for out in dp["outs"])
    for name, g in a.items():
        assert torch.equal(g, b[name]), name


# ---------------------------------------------------------------------------
# one train step: 2 ranks, and 3 ranks with an uneven split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_step_on_two_ranks_equals_one_process(dp, name):
    """One data-parallel step (8 rows per rank) from the same params,
    batch and generator seed: the loss terms summed over the ranks and
    every gradient as on one process, the ranks' gradients bitwise
    alike."""
    _assert_step(dp, name)


@pytest.mark.parametrize("name", UNEVEN_CASES)
def test_uneven_split_step_equals_one_process(dp3, name):
    """Batch 10 on 3 ranks (4 / 3 / 3 rows): the (W / B) weighting of each
    rank's loss makes the averaged gradient the one-process mean for an
    uneven split; the uint8 case also splits the bank's uniforms by rows'
    K neighbours."""
    _assert_step(dp3, name)


def test_uneven_split_at_init_head_equals_row_blocks(dp3):
    """Config 4's shape with the logistic-256 head at the model's own
    initial scale, batch 10 on 3 ranks: the loss terms as one process's,
    every gradient as that of one process that sums the batch in the
    ranks' row blocks (make_block_train_step). At this scale a bin's mass
    is the difference of two sigmoids near 0.5, and the whole batch summed
    in one piece parts the decoder head's gradients from those blocks by
    about the gradient tolerance: the rounding of the order of the sums,
    which the blocks reproduce."""
    _assert_step(dp3, INIT_HEAD, grads_ref="block_refs")


@pytest.mark.parametrize("run", ["dp", "dp3"])
def test_rank_sees_one_process_rows_and_noise(dp, dp3, run):
    """Each rank's forward sees its rows of one process's preprocessed
    batch (the batch's uniforms drawn whole, then split) and of its eps,
    bitwise; after the step every rank's generator is in one process's
    state."""
    run = dp if run == "dp" else dp3
    ranges = _rows(run["world"], run["batch"])
    for name, ref in run["refs"].items():
        (x_ref,), (eps_ref,) = ref["x"], ref["eps"]
        for (lo, hi), out in zip(ranges, run["outs"]):
            got = out["steps"][name]
            (x,), (eps,) = got["x"], got["eps"]
            assert torch.equal(x, x_ref[lo:hi]), name
            assert torch.equal(torch.cat(_pair(eps), 1),
                               torch.cat(_pair(eps_ref), 1)[lo:hi]), name
            assert torch.equal(got["gen_state"], ref["gen_state"]), name


@pytest.mark.parametrize("run", ["dp", "dp3"])
def test_work_is_divided(dp, dp3, run):
    """Each rank's batch forward sees its B_r rows; the per-row re-encode
    its B_r * K neighbours, the batch union all B * K rows, the exact
    prior its own bank shard (in chunks of 10)."""
    run = dp if run == "dp" else dp3
    world = run["world"]
    shard = -(-N // world)
    for name in run["refs"]:
        cfg = Config.from_json(run["steps"][name]["cfg"])
        for (lo, hi), out in zip(_rows(world, run["batch"]), run["outs"]):
            got = out["steps"][name]
            assert [x.shape[0] for x in got["x"]] == [hi - lo], name
            if cfg.prior != "exemplar_prior":
                want = []
            elif not cfg.approximate_prior:
                want = [min(10, shard - s) for s in range(0, shard, 10)]
            elif cfg.approximate_support == "batch_union":
                want = [run["batch"] * K]
            else:
                want = [(hi - lo) * K]
            assert got["reencode"] == want, (name, got["reencode"])


# ---------------------------------------------------------------------------
# one process's draws, against a record of the code before the mesh split
# the batch
# ---------------------------------------------------------------------------

# (function, shape, sha256 of the bytes[:16]) of every draw of one train
# step (or a 2-step epoch) with a generator seeded 3, recorded before the
# step drew its noise up front (draw_step_noise)
STORED_DRAWS = {
    "vae_exact_step": [
        ("rand", (6, 28, 28, 1), "0c4801668809b3b7"),
        ("randn", (6, 4), "c7f3829925b0b2d3")],
    "vae_stochastic_float_bank_step": [
        ("rand", (6, 28, 28, 1), "0c4801668809b3b7"),
        ("rand", (24, 28, 28, 1), "1d80d0bba5df1cf8"),
        ("randn", (6, 4), "bf068622b5480e1c")],
    "hvae_exact_epoch": [
        ("rand", (6, 28, 28, 1), "0c4801668809b3b7"),
        ("randn", (6, 6), "6b7ff66dee03344d"),
        ("randn", (6, 4), "c72dcdf1c664095c"),
        ("rand", (6, 28, 28, 1), "eba5d48a7edf8d03"),
        ("randn", (6, 6), "ec7f1922dcd195a6"),
        ("randn", (6, 4), "be466828e7d47e9c")],
    "convhvae_u8_approx_step": [
        ("rand", (6, 16, 16, 3), "e0eff795c37ba0d1"),
        ("randn", (6, 6), "cea65fc07dbce55d"),
        ("randn", (6, 4), "78ea6189a7355034"),
        ("rand", (24, 16, 16, 3), "8a9b5f16899fb1d6")],
    "convhvae_u8_exact_step": [
        ("rand", (6, 16, 16, 3), "e0eff795c37ba0d1"),
        ("randn", (6, 6), "cea65fc07dbce55d"),
        ("randn", (6, 4), "78ea6189a7355034"),
        ("rand", (10, 16, 16, 3), "047f91bb58ee3e61"),
        ("rand", (10, 16, 16, 3), "b33203a93b128002"),
        ("rand", (4, 16, 16, 3), "d103cb843e77f2a3")],
}


def _record_draws(fn, monkeypatch):
    """Run ``fn`` and return the (function, shape, digest) of every
    torch.rand / randn / randint draw it makes, in order."""
    seen = []
    for name in ("rand", "randn", "randint"):
        orig = getattr(torch, name)

        def wrapped(*a, _name=name, _orig=orig, **kw):
            t = _orig(*a, **kw)
            seen.append((_name, tuple(t.shape), hashlib.sha256(
                t.contiguous().numpy().tobytes()).hexdigest()[:16]))
            return t

        monkeypatch.setattr(torch, name, wrapped)
    fn()
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", list(STORED_DRAWS))
def test_one_process_draws_unchanged(name, monkeypatch):
    """mesh_shape (1,): the step's draws, through draw_step_noise, are the
    ones it made before (the batch's uniforms, a stochastic float bank's
    between them and eps, eps2 then eps1, the approximate prior's raw-bank
    uniforms, the exact prior's per-chunk uniforms after eps)."""
    rng = np.random.default_rng(0)
    b, n = 6, 24
    conv = name.startswith("convhvae")
    if conv:
        cfg = Config(model_name="convhvae_2level", input_size=(3, HW, HW),
                     input_type="continuous", dynamic_binarization=False,
                     hidden_size=16, z1_size=4, z2_size=6, number_components=n,
                     approximate_k=4, use_pallas_prior=False, prior_block_n=10,
                     exact_reencode_chunk=10, exact_remat=False,
                     bank_stochastic_preprocess=True,
                     approximate_prior="approx" in name, **SMALL_CONV)
        imgs = torch.from_numpy(rng.integers(0, 256, (n, HW, HW, 3),
                                             dtype=np.uint8))
    else:
        cfg = Config(model_name="vae" if name.startswith("vae")
                     else "hvae_2level", hidden_size=16, z1_size=4, z2_size=6,
                     number_components=n, use_pallas_prior=False,
                     prior_block_n=10, exact_reencode_chunk=10,
                     bank_stochastic_preprocess="stochastic" in name)
        imgs = torch.from_numpy(rng.random((n, 28, 28, 1)).astype(np.float32))
    model = create_model(cfg, device="cpu", seed=1)
    cache = torch.from_numpy(rng.normal(size=(
        n, cfg.z2_size if conv else cfg.z1_size)).astype(np.float32))
    bank = Bank(images=imgs, data_idx=torch.arange(n, dtype=torch.int32),
                valid=torch.ones(n, dtype=torch.bool),
                cache_means=cache if cfg.approximate_prior else None,
                n_effective=n)
    g = torch.Generator().manual_seed(3)
    state = tsteps.init_train_state(model, cfg)
    if name.endswith("epoch"):
        perm = torch.from_numpy(rng.permutation(n)[:2 * b].reshape(2, b))

        def run():
            tsteps.make_epoch_fn(cfg)(state, imgs, bank.data_idx, perm, bank,
                                      0.5, generator=g)
    else:
        rows = torch.from_numpy(rng.permutation(n)[:b])

        def run():
            tsteps.make_train_step(cfg)(state, imgs[rows],
                                        rows.to(torch.int32), bank, 0.5,
                                        generator=g)
    assert _record_draws(run, monkeypatch) == STORED_DRAWS[name]


# ---------------------------------------------------------------------------
# the epoch: metrics, params, one collective for the metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EPOCH_CASES)
def test_epoch_on_two_ranks_equals_one_process(dp, name):
    """A 2-step epoch (make_epoch_fn): the metrics (each rank's shares
    summed on the device, all-reduced once) rtol 1e-5 of one process's,
    the params after it as one process's, the ranks' params bitwise
    alike."""
    ref = dp["epoch_refs"][name]
    cfg = Config.from_json(dp["steps"][name]["cfg"])
    outs = [out["epochs"][name] for out in dp["outs"]]
    for out in outs:
        for k in ("loss", "re", "kl"):
            np.testing.assert_allclose(out["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=f"{name} {k}")
        for got, want in zip(out["step_grads"], ref["step_grads"]):
            _assert_grads(got, want, name)
        _assert_params_after_steps(out["params"], ref["params"],
                                   ref["blocks"], cfg.lr,
                                   len(ref["step_grads"]), name)
    for k, p in outs[0]["params"].items():
        assert torch.equal(p, outs[1]["params"][k]), (name, k)


@pytest.mark.parametrize("name", EPOCH_CASES)
def test_epoch_metrics_take_one_collective(dp, name):
    """The all_reduce calls of a 2-step epoch are two steps' and one more,
    the metrics' (none per step for them): no per-step metrics
    collective."""
    for out in dp["outs"]:
        e = out["epochs"][name]
        assert e["step_reduces"] >= 1
        assert e["epoch_reduces"] == 2 * e["step_reduces"] + 1, e
