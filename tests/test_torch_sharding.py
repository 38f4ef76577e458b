"""The port's mesh over torch.distributed: two gloo ranks on the CPU, each
holding its shard of the bank and its rows of every batch.

Each scenario runs tests/_torch_mp_child.py in two processes (RANK 0 and 1,
a ``file://`` process group under tmp_path, so that test workers never
share a port), which import the port and torch only. The parent holds their
results against the port on one process and, for the data-parallel exact
prior, against the JAX package's make_sharded_exact_prior on a mesh of 2 of
the 8 virtual CPU devices. A scenario that does not finish within
CHILD_TIMEOUT_S fails its tests (a hung collective), not the run.

Tolerances (fp32): prior values and losses rtol 1e-5 (the cross-shard
log-space combine adds the shards' partial sums in another order), each
gradient tensor within 1e-4 of its largest element, validation rtol 1e-5;
params after an epoch rtol 1e-5 / atol 1e-6 (every element against one
process that sums each batch in the ranks' row blocks; against one process
all but PARTING_SHARE of them); kNN rows, gathers and the checkpoint cycle
exact.
"""

import json
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplar_vae_tpu.config import Config as JConfig
from exemplar_vae_tpu.models import create_model as j_create_model
from exemplar_vae_tpu.parallel.mesh import create_mesh as j_create_mesh
from exemplar_vae_tpu.parallel.mesh import pad_to_shards as j_pad_to_shards
from exemplar_vae_tpu.parallel.sharded_prior import \
    make_sharded_exact_prior as j_make_sharded_exact_prior
from exemplar_vae_tpu.train import loss as jloss
from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.models import create_model
from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
from exemplar_vae_tpu_torch.ops.knn import knn_indices
from exemplar_vae_tpu_torch.parallel.mesh import pad_to_shards, row_range
from exemplar_vae_tpu_torch.train.bank import encode_bank_with_grad
from exemplar_vae_tpu_torch.train.trainer import Experiment
from exemplar_vae_tpu_torch.weights import params_from_flax

from _torch_mp_child import block_epoch_fn, record_step_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_mp_child.py")
CHILD_TIMEOUT_S = 120
# each CLI process of the torchrun test, on its own: 7.5x the slowest
# wall measured under the suite's -n 6 (5.8-19.9 s), 5x the slowest
# beside 32 spinning processes (28.1 s)
CLI_TIMEOUT_S = 150
CHILD_THREADS = 2
W = 2
N = 25                          # odd: the last shard holds one padding row
GRAD_REL = 1e-4
# Params after an epoch that part from one process's (rtol 1e-5 / atol
# 1e-6), as a share of all elements: where a gradient cancels to near zero,
# AdamNormGrad's first update lr * g_n / (|g_n| + 3.2e-7) (g_n the gradient
# over its tensor's norm) turns the ulp by which the ranks' row blocks and
# one process's whole batch sum it apart into more than the atol.
PARTING_SHARE = 1e-5


def _run_ranks(scenario, work, inputs, world=W):
    """Run ``scenario`` on ``world`` ranks; returns their result dicts."""
    os.makedirs(work, exist_ok=True)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ, WORLD_SIZE=str(world),
               OMP_NUM_THREADS=str(CHILD_THREADS))
    procs = [subprocess.Popen(
        [sys.executable, CHILD, scenario, str(work)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            errs.append(err)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenario}: the ranks did not finish within "
                    f"{CHILD_TIMEOUT_S} s (a hung collective?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"{scenario} rank {r}:\n{err[-3000:]}"
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
    for out in outs:
        assert out["jax_loaded"] == []
    return outs


def _assert_params_after_steps(got, want, blocks, lr, steps, what):
    """Params after ``steps`` optimizer steps at rtol 1e-5 / atol 1e-6:
    every element of one process's that sums each batch in the ranks' row
    blocks (``blocks``, block_epoch_fn); of one process's (``want``) all
    but PARTING_SHARE of the elements, and those within what AdamNormGrad
    can move a param in ``steps`` steps (lr each, so 2 * lr apart)."""
    n_part = n_all = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), blocks[name].numpy(),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what} {name}, row blocks")
        d = (got[name] - w).abs()
        part = d > 1e-6 + 1e-5 * w.abs()
        assert (d[part] <= 2 * lr * steps).all(), (what, name, d.max())
        n_part, n_all = n_part + int(part.sum()), n_all + w.numel()
    assert n_part <= PARTING_SHARE * n_all, (what, n_part, n_all)


def _assert_grads(got, want, what):
    for name, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(np.asarray(got[name]) - w).max())
        assert err <= GRAD_REL * max(float(np.abs(w).max()), 1e-30), \
            (what, name, err)


# ---------------------------------------------------------------------------
# pad_to_shards and the row ranges (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,w", [(25, 2), (24, 2), (7, 4), (3, 8)])
def test_pad_to_shards_and_row_ranges(n, w):
    arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, true_n = pad_to_shards(arr, w, pad_value=-1)
    want, want_n = j_pad_to_shards(arr, j_create_mesh(JConfig(mesh_shape=(w,))),
                                   pad_value=-1)
    np.testing.assert_array_equal(got, want)
    assert true_n == want_n == n and got.shape[0] % w == 0
    ranges = [row_range(got.shape[0], w, r) for r in range(w)]
    assert ranges[0][0] == 0 and ranges[-1][1] == got.shape[0]
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    with pytest.raises(ValueError, match="pad them first"):
        row_range(got.shape[0] + 1, w, 0)


# ---------------------------------------------------------------------------
# the sharded exact prior, kNN select, row gather, mesh size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    jcfg = JConfig(model_name="vae", hidden_size=16, z1_size=4,
                   mesh_shape=(W,), use_pallas_prior=False, prior_block_n=8,
                   exact_reencode_chunk=6, prior_variance_init=0.6)
    cfg = Config.from_json(jcfg.to_json()).replace(use_pallas_prior=True)
    jm = j_create_model(jcfg)
    rng = np.random.default_rng(0)
    imgs = rng.random((N, 28, 28, 1)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    params = jm.init(key, jnp.asarray(imgs[:2]), key)["params"]
    padded, _ = pad_to_shards(imgs, W)
    n_pad = padded.shape[0]
    data_idx = np.where(np.arange(n_pad) < N, np.arange(n_pad), -2).astype(
        np.int32)
    valid = np.arange(n_pad) < N
    z = rng.normal(size=(6, 4)).astype(np.float32)
    loo = np.array([0, 5, 12, 13, 24, 30], np.int32)   # both shards, and none
    cot = rng.normal(size=6).astype(np.float32)
    # kNN: five integer rows repeated five times (ties within and across the
    # shards) and a padding row equal to the first query (it would win)
    base = rng.integers(-3, 4, (5, 6)).astype(np.float32)
    q = (base[rng.integers(0, 5, 5)] + rng.integers(-1, 2, (5, 6))).astype(
        np.float32)
    cache = np.concatenate([np.tile(base, (5, 1)), q[:1]])
    big_idx = (2 ** 24 + 1 + 3 * np.arange(n_pad)).astype(np.int32)
    inputs = dict(
        cfg=cfg.to_json(), params=params_from_flax(jax.tree.map(np.asarray,
                                                                 params)),
        images=torch.from_numpy(padded), data_idx=torch.from_numpy(data_idx),
        valid=torch.from_numpy(valid), n=N, z=torch.from_numpy(z),
        loo=torch.from_numpy(loo), cot=torch.from_numpy(cot),
        log_denom=math.log(N - 1.0), q=torch.from_numpy(q),
        cache=torch.from_numpy(cache), cache_valid=torch.from_numpy(valid),
        ks=[4, 15], big_idx=torch.from_numpy(big_idx),
        rows=torch.from_numpy(rng.integers(0, n_pad, (6, 3))),
        images_u8=torch.from_numpy(rng.integers(0, 256, (n_pad, 4, 4, 3),
                                                dtype=np.uint8)))
    outs = _run_ranks("ops", tmp_path_factory.mktemp("ops"), inputs)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, params=params, inputs=inputs,
                outs=outs)


def _one_rank_prior(o):
    """The port's unsharded exact prior over the whole padded bank."""
    inp, cfg = o["inputs"], o["cfg"]
    model = create_model(cfg, device="cpu")
    model.load_state_dict(inp["params"])
    z = inp["z"].clone().requires_grad_(True)
    means = encode_bank_with_grad(model, inp["images"], cfg)
    prior = exemplar_log_prob(
        z, means, model.get_prior_log_var(), log_denom=inp["log_denom"],
        data_idx=inp["loo"], exemplar_idx=inp["data_idx"],
        valid=inp["valid"], impl="pallas", block_n=cfg.prior_block_n)
    (inp["cot"] * prior).sum().backward()
    return (prior.detach().numpy(), z.grad.numpy(),
            {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for k, p in model.named_parameters()})


def _jax_sharded_prior(o):
    """The JAX package's make_sharded_exact_prior on a mesh of 2."""
    inp, jcfg, jm = o["inputs"], o["jcfg"], o["jm"]
    prior_fn = j_make_sharded_exact_prior(jm, jcfg, j_create_mesh(jcfg))
    bank = jloss.Bank(jnp.asarray(inp["images"].numpy()),
                      jnp.asarray(inp["data_idx"].numpy()),
                      jnp.asarray(inp["valid"].numpy()), None, N)
    cot = jnp.asarray(inp["cot"].numpy())

    def f(v, z):
        out = prior_fn(v, z, jnp.asarray(inp["loo"].numpy()), bank,
                       jnp.float32(inp["log_denom"]))
        return jnp.sum(cot * out), out

    (_, val), (gv, gz) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))({"params": o["params"]},
                                          jnp.asarray(inp["z"].numpy()))
    return (np.asarray(val), np.asarray(gz),
            {k: v.numpy() for k, v in params_from_flax(jax.tree.map(
                np.asarray, gv["params"])).items()})


@pytest.mark.parametrize("reference", ["port_one_rank", "jax_mesh_of_2"])
def test_sharded_exact_prior_value_and_gradients(ops, reference):
    """Two ranks, each holding 3 of the 6 rows of z and half the bank, each
    through the kernel's wrapper (its plain version on the CPU) on the
    gathered z against its shard with the LOO mask and global indices,
    combined in log space; the ranks' rows of the prior and of the z
    gradient gathered, parameter gradients averaged over the ranks."""
    val, gz, grads = (_one_rank_prior(ops) if reference == "port_one_rank"
                      else _jax_sharded_prior(ops))
    for out in ops["outs"]:
        np.testing.assert_allclose(out["prior"].numpy(), val, rtol=1e-5)
        _assert_grads({"z": out["z_grad"]}, {"z": gz}, reference)
        _assert_grads(out["grads"], grads, reference)
    a, b = ops["outs"]
    for name, g in a["grads"].items():
        assert torch.equal(g, b["grads"][name]), name


@pytest.mark.parametrize("k", [4, 15])
def test_sharded_knn_select_equals_one_rank(ops, k):
    """N = 25 over 2 ranks (13 rows each, one padding row that would win);
    exact ties within and across the shards go to the lowest global row;
    k = 15 exceeds a shard's 13 rows."""
    inp = ops["inputs"]
    want = knn_indices(inp["q"], inp["cache"], k, valid=inp["cache_valid"])
    assert want.shape == (5, k) and not (want == N).any()
    for out in ops["outs"]:
        np.testing.assert_array_equal(out["knn"][k].numpy(), want.numpy())


@pytest.mark.parametrize("what", ["gather_idx", "gather_img"])
def test_sharded_row_gather_is_exact(ops, what):
    """int32 indices above 2**24 (not representable in fp32) and uint8
    images come back exact and in their own types."""
    inp = ops["inputs"]
    src = inp["big_idx"] if what == "gather_idx" else inp["images_u8"]
    want = src[inp["rows"]]
    for out in ops["outs"]:
        assert out[what].dtype == src.dtype
        assert torch.equal(out[what], want)


def test_shard_generators_differ_and_step_generators_stay_in_step(ops):
    """Stochastic bank draws over a shard come from the rank's own
    generator (independent noise per shard, as the JAX package folds in the
    axis index), seeded by one draw of the step's generator on every rank,
    which keeps the ranks' step draws equal."""
    a, b = ops["outs"]
    assert not torch.equal(a["shard_draw"], b["shard_draw"])
    assert torch.equal(a["step_draw"], b["step_draw"])


@pytest.mark.parametrize("case", [0, 1])
def test_mesh_size_must_equal_world_size(ops, case):
    """mesh (3,) and mesh (1,) in a group of 2 ranks both raise."""
    for out in ops["outs"]:
        assert "process group has 2" in out["mismatch"][case]


# ---------------------------------------------------------------------------
# the Experiment on two ranks against one, and the checkpoint cycle
# ---------------------------------------------------------------------------


def _exp_cfg(mode, snapshot_dir):
    kw = dict(model_name="vae", hidden_size=16, z1_size=4,
              training_set_size=45, number_components=45, val_set_size=20,
              test_set_size=10, batch_size=16, test_batch_size=8, warmup=1,
              epochs=1, S=4, MB=2, prior_block_n=8, exact_reencode_chunk=10,
              snapshot_dir=str(snapshot_dir))
    if mode == "exact":
        kw.update(dataset_name="synthetic")
    else:       # a raw uint8 bank: 3 x 64 x 64 continuous stand-in
        kw.update(dataset_name="synthetic_continuous", approximate_prior=True,
                  approximate_k=5)
    return Config(**kw)


def _epoch(mode, work):
    # the one-rank reference on the ranks' thread count: CPU kernels sum in
    # an order that depends on it, and Adam's first step turns an ulp of a
    # near-zero gradient element into +-lr, which the logistic-256 head's
    # gradients at scale ~1 then show in the second step (~1e-3 relative)
    threads = torch.get_num_threads()
    torch.set_num_threads(CHILD_THREADS)
    try:
        one = Experiment(_exp_cfg(mode, work / "one"), device="cpu",
                         verbose=False)
        step_grads = record_step_grads(one.model, one.state.opt)
        ref = {"metrics": one.train_epoch(),
               "step_grads": step_grads,
               "grads": {k: p.grad.clone()
                         for k, p in one.model.named_parameters()},
               "params": {k: v.clone()
                          for k, v in one.model.state_dict().items()},
               "val": one.validate()}
        blocks = Experiment(_exp_cfg(mode, work / "blocks"), device="cpu",
                            verbose=False)
        blocks.epoch_fn = block_epoch_fn(blocks.cfg, W)
        blocks.train_epoch()
        ref["blocks"] = {k: v.clone()
                         for k, v in blocks.model.state_dict().items()}
    finally:
        torch.set_num_threads(threads)
    cfg = _exp_cfg(mode, work / "two").replace(mesh_shape=(W,))
    outs = _run_ranks(mode, work / "ranks", {"cfg": cfg.to_json()})
    return ref, outs, cfg


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """epochs(mode) -> (one-rank reference, the ranks' results, config),
    each mode run once per module."""
    done = {}

    def get(mode):
        if mode not in done:
            done[mode] = _epoch(mode, tmp_path_factory.mktemp(mode))
        return done[mode]

    return get


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_experiment_epoch_on_two_ranks_equals_one(epochs, mode):
    """One epoch (2 steps of 16, data-parallel: each rank trains on 8 rows
    of every batch) over a bank of 45 split 23 / 23 (one padding row,
    index -2, valid False), then validation over the gathered eval bank:
    the epoch's metrics (all-reduced once), every step's gradients, the
    params (_assert_params_after_steps) and the validation as on one
    process; the two ranks bitwise alike."""
    ref, outs, cfg = epochs(mode)
    for r, out in enumerate(outs):
        assert out["bank_rows"] == 23
        assert out["bank_idx"].tolist() == (
            list(range(23)) if r == 0 else list(range(23, 45)) + [-2])
        for k in ("loss", "re", "kl"):
            np.testing.assert_allclose(out["metrics"][k], ref["metrics"][k],
                                       rtol=1e-5, err_msg=f"{mode} {k}")
        for got, want in zip(out["step_grads"], ref["step_grads"]):
            _assert_grads(got, want, mode)
        _assert_grads(out["grads"], ref["grads"], mode)
        _assert_params_after_steps(out["params"], ref["params"],
                                   ref["blocks"], cfg.lr,
                                   len(ref["step_grads"]), mode)
        np.testing.assert_allclose(np.array(out["val"]), np.array(ref["val"]),
                                   rtol=1e-5)
    for name, p in outs[0]["params"].items():
        assert torch.equal(p, outs[1]["params"][name]), name


def test_two_rank_checkpoint_cycle(epochs):
    """Approximate mode: every rank enters save, rank 0 alone writes (one
    metrics line, not two), cache.npz holds the padded bank's 46 rows, the
    two shards in rank order, and a fresh 2-rank Experiment restores
    params, moments, bookkeeping and each rank's cache shard bitwise."""
    _, outs, cfg = epochs("approx")
    (name,) = os.listdir(cfg.snapshot_dir)
    exp_dir = os.path.join(cfg.snapshot_dir, name)
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        assert len([json.loads(line) for line in f]) == 1
    with np.load(os.path.join(exp_dir, "ckpt_cycle", "cache.npz")) as data:
        saved = data["cache"]
    assert saved.shape == (46, 4)
    np.testing.assert_array_equal(
        saved, torch.cat([o["cache"] for o in outs]).numpy())
    for out in outs:
        assert out["restored"] is True
        assert torch.equal(out["restored_cache"], out["cache"])
        for name, p in out["params"].items():
            assert torch.equal(out["restored_params"][name], p), name
        for a, b in zip(out["restored_m"], out["saved_m"]):
            assert torch.equal(a, b)
        assert out["restored_meta"] == out["saved_meta"]


# ---------------------------------------------------------------------------
# the CLI under torchrun
# ---------------------------------------------------------------------------


def _cli(args, snapshot_dir, ranks=None):
    """The port's CLI in a child process (under torchrun --standalone, whose
    rendezvous store and workers' store bind port 0 and keep it, when
    ``ranks`` is given); its stdout. Each process has CLI_TIMEOUT_S of its
    own; a failure reports the launch, its wall time and its stderr."""
    argv = ["--no_cuda", "--dataset_name", "synthetic_continuous",
            "--approximate_prior", "--approximate_k", "5",
            "--training_set_size", "45", "--number_components", "45",
            "--val_set_size", "20", "--test_set_size", "10",
            "--batch_size", "16", "--test_batch_size", "8", "--warmup", "1",
            "--S", "4", "--MB", "2", "--hidden_size", "16", "--z1_size", "4",
            "--snapshot_dir", str(snapshot_dir)] + args
    launch = [sys.executable, "-m", "exemplar_vae_tpu_torch.main"]
    if ranks:
        launch = [sys.executable, "-m", "torch.distributed.run",
                  "--standalone", "--nproc_per_node", str(ranks), "-m",
                  "exemplar_vae_tpu_torch.main", "--mesh", str(ranks)]
    what = f"{'torchrun ' if ranks else ''}CLI {' '.join(args)}"
    t0 = time.monotonic()
    try:
        proc = subprocess.run(launch + argv, cwd=ROOT, capture_output=True,
                              text=True, timeout=CLI_TIMEOUT_S,
                              env=dict(os.environ,
                                       OMP_NUM_THREADS=str(CHILD_THREADS)))
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode(errors="replace") if isinstance(
            e.stderr, bytes) else (e.stderr or "")
        pytest.fail(f"{what}: no exit within {CLI_TIMEOUT_S} s; stderr: "
                    f"{err[-3000:]}")
    wall = time.monotonic() - t0
    assert proc.returncode == 0, (f"{what}: exit {proc.returncode} after "
                                  f"{wall:.1f} s; stderr: "
                                  f"{proc.stderr[-3000:]}")
    return proc.stdout


def test_cli_under_torchrun_resumes_and_equals_one_process(tmp_path):
    """torchrun runs the CLI on 2 ranks with the approximate prior over a
    uint8 bank of 45: one epoch with a checkpoint, then a resume to epoch 2
    (the gathered cache re-sharded); rank 0 alone prints, and the results
    equal two epochs on one process. Each of the three runs has a time
    limit of its own."""
    two = tmp_path / "two"
    _cli(["--epochs", "1", "--checkpoint_every", "1"], two, ranks=W)
    out = _cli(["--epochs", "2", "--resume", "--checkpoint_every", "1"], two,
               ranks=W)
    assert out.count("resumed from epoch 1") == 1 and "mesh=2" in out
    got = json.loads(out.strip().splitlines()[-1])
    want = json.loads(_cli(["--epochs", "2"], tmp_path / "one")
                      .strip().splitlines()[-1])
    assert got["epochs_trained"] == want["epochs_trained"] == 2
    for k in ("test_nll", "best_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
