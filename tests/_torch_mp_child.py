"""One rank of the port's mesh tests (tests/test_torch_sharding.py,
tests/test_torch_data_parallel.py).

    python tests/_torch_mp_child.py <scenario> <work dir>

RANK and WORLD_SIZE come from the environment; the process group is a gloo
group on the CPU, initialized through ``file://<work dir>/pg``. The inputs
are ``<work dir>/inputs.pt``; the rank writes ``<work dir>/rank<r>.pt``.
Imports the port and torch only, never JAX.

Scenarios:
  ops        the data-parallel exact prior's value and gradients (each
             rank holding its rows of z), the kNN select, the row gather,
             and a mesh size that differs from the world size;
  exact      one Experiment epoch with the exact prior, then validation;
  approx     one Experiment epoch with the approximate prior, validation,
             then a checkpoint save and a restore into a fresh Experiment;
  dp         the data-parallel exact prior (prior_case), one train step of
             each case (step_case) and epochs with their all_reduce counts
             (epoch_case);
  dp3        one train step of each case, on 3 ranks;
  mesh_spans one epoch of one step of the approximate prior, without and
             with a profiler (mesh_spans_case).

step_case and epoch_case run on one process too (mesh None): the tests
call them for their references; block_epoch_fn is one process's epoch
that sums each batch in the ranks' row blocks, the reference that parts
the mesh's summation order from the rest of it.
"""

import contextlib
import functools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from exemplar_vae_tpu_torch.config import Config  # noqa: E402
from exemplar_vae_tpu_torch.models import create_model  # noqa: E402
from exemplar_vae_tpu_torch.ops.preprocess import \
    preprocess_batch  # noqa: E402
from exemplar_vae_tpu_torch.parallel.mesh import (Mesh,  # noqa: E402
                                                  create_mesh,
                                                  init_distributed,
                                                  pad_to_shards, shutdown)
from exemplar_vae_tpu_torch.parallel.sharded_knn import (  # noqa: E402
    sharded_knn_select, sharded_row_gather)
from exemplar_vae_tpu_torch.parallel.sharded_prior import \
    make_sharded_exact_prior  # noqa: E402
from exemplar_vae_tpu_torch.train import steps as train_steps  # noqa: E402
from exemplar_vae_tpu_torch.train.loss import Bank, batch_loss  # noqa: E402
from exemplar_vae_tpu_torch.train.steps import (  # noqa: E402
    draw_step_noise, init_train_state, make_epoch_fn, make_train_step)
from exemplar_vae_tpu_torch.train.trainer import Experiment  # noqa: E402


def _ops(inp, mesh):
    out = {}
    cfg = Config.from_json(inp["cfg"])
    lo, hi = mesh.shard_range(inp["images"].shape[0])
    # the data-parallel exact prior: value and gradients (params and z)
    model = create_model(cfg, device="cpu")
    model.load_state_dict(inp["params"])
    out.update(prior_case(inp, mesh, model))
    # the kNN select for each k, over the rank's cache shard
    out["knn"] = {k: sharded_knn_select(
        inp["q"], inp["cache"][lo:hi], inp["cache_valid"][lo:hi], k, mesh)
        for k in inp["ks"]}
    # the row gather of int32 indices above 2**24 and of uint8 images
    out["gather_idx"] = sharded_row_gather(inp["big_idx"][lo:hi],
                                           inp["rows"], mesh)
    out["gather_img"] = sharded_row_gather(inp["images_u8"][lo:hi],
                                           inp["rows"], mesh)
    # a shard's generator: the ranks' draws differ, their step generators
    # stay in step
    step_gen = torch.Generator().manual_seed(5)
    out["shard_draw"] = torch.rand(4, generator=mesh.shard_generator(step_gen))
    out["step_draw"] = torch.rand(4, generator=step_gen)
    # a mesh that differs from the world size raises
    out["mismatch"] = []
    for shape in ((3,), (1,)):
        try:
            create_mesh(cfg.replace(mesh_shape=shape), "cpu")
            out["mismatch"].append("")
        except ValueError as e:
            out["mismatch"].append(str(e))
    return out


def prior_case(inp, mesh, model):
    """The data-parallel exact prior of ``inp``'s z (B, D) and LOO indices,
    this rank holding its rows of them (Mesh.batch_rows) and its shard of
    the padded bank: the whole batch's log p(z) and z gradient, gathered,
    and the parameter gradients of sum_b cot_b * log p(z_b). The rank's
    loss is W times its rows' share (the train step's accounting), so the
    gradients averaged over the ranks are the one-process gradients."""
    b = inp["z"].shape[0]
    rows = slice(*mesh.batch_rows(b))
    lo, hi = mesh.shard_range(inp["images"].shape[0])
    z = inp["z"][rows].clone().requires_grad_(True)
    bank = Bank(images=inp["images"][lo:hi], data_idx=inp["data_idx"][lo:hi],
                valid=inp["valid"][lo:hi], cache_means=None,
                n_effective=inp["n"])
    prior = make_sharded_exact_prior(Config.from_json(inp["cfg"]), mesh)(
        model, z, inp["loo"][rows], bank, inp["log_denom"], batch_size=b)
    (mesh.size * (inp["cot"][rows] * prior).sum()).backward()
    mesh.average_grads(model.parameters())
    return {"prior": mesh.all_gather_rows(prior.detach(), b),
            "z_grad": mesh.all_gather_rows(z.grad, b) / mesh.size,
            "grads": {k: torch.zeros_like(p) if p.grad is None else p.grad
                      for k, p in model.named_parameters()}}


def _case_bank(case, mesh):
    """The case's bank (images, index, valid, cache), whole on one process;
    on a mesh this rank's rows of it padded to a multiple of the mesh size
    (zero images and cache, index -2, valid False), as the Experiment
    holds it."""
    n = case["bank_images"].shape[0]
    arrs = [case["bank_images"].numpy(), np.arange(n, dtype=np.int32),
            np.ones(n, bool),
            None if case["cache"] is None else case["cache"].numpy()]
    pads = [0, -2, False, 0]
    if mesh is not None:
        arrs = [None if a is None else pad_to_shards(a, mesh.size, p)[0]
                for a, p in zip(arrs, pads)]
        lo, hi = mesh.shard_range(arrs[0].shape[0])
        arrs = [None if a is None else a[lo:hi] for a in arrs]
    images, idx, valid, cache = (None if a is None else torch.from_numpy(a)
                                 for a in arrs)
    return Bank(images=images, data_idx=idx, valid=valid, cache_means=cache,
                n_effective=n)


def _case_model(case):
    """The case's model with its params, and what its calls see: the batch
    and eps of each forward (a pre-hook), the rows of each re-encode
    (encode_top_mean)."""
    cfg = Config.from_json(case["cfg"])
    model = create_model(cfg, device="cpu")
    model.load_state_dict(case["params"])
    seen = {"x": [], "eps": [], "reencode": []}

    def pre(_, args, kwargs):
        seen["x"].append(args[0].detach().clone())
        seen["eps"].append(kwargs.get("eps"))

    model.register_forward_pre_hook(pre, with_kwargs=True)
    encode = model.encode_top_mean

    def counted(x):
        seen["reencode"].append(x.shape[0])
        return encode(x)

    model.encode_top_mean = counted
    return cfg, model, seen


def step_case(case, mesh=None, blocks=None):
    """One train step of ``case`` from its params, batch and generator seed
    (on a mesh: data-parallel, this rank's bank shard; with ``blocks``, one
    process summing the batch in the row blocks of a mesh of that size,
    make_block_train_step): the loss terms (summed over the ranks), the
    gradients, the generator's state after the step, and what the model
    saw (_case_model)."""
    cfg, model, seen = _case_model(case)
    g = torch.Generator().manual_seed(case["seed"])
    step = (make_train_step(cfg, mesh=mesh) if blocks is None
            else make_block_train_step(cfg, blocks))
    _, aux = step(
        init_train_state(model, cfg), case["x"], case["idx"],
        _case_bank(case, mesh), case["beta"], generator=g)
    terms = torch.stack([aux[k] for k in ("loss", "re", "kl")])
    if mesh is not None:
        mesh.all_reduce(terms)
    return {"terms": terms, "gen_state": g.get_state(),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            **seen}


def epoch_case(case, mesh=None, blocks=None):
    """An epoch of ``case`` over its (S, B) permutation: the metrics, the
    params after it and each step's gradients; on a mesh also the
    all_reduce calls of one train step and of the epoch (from other copies
    of the model). With ``blocks`` (one process) each batch is summed in
    the row blocks of a mesh of that size (block_epoch_fn)."""
    counts = {"n": 0}
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        counts["n"] += 1
        return all_reduce(*a, **kw)

    def epoch(steps=None):
        cfg, model, _ = _case_model(case)
        bank = _case_bank(case, mesh)
        g = torch.Generator().manual_seed(case["seed"])
        state = init_train_state(model, cfg)
        if steps is not None:               # one step, for its count
            make_train_step(cfg, bank_preprocessed=True, mesh=mesh)(
                state, case["train_x"][case["perm"][0]],
                case["train_idx"][case["perm"][0]], bank, case["beta"],
                generator=g)
            return None
        step_grads = record_step_grads(model, state.opt)
        epoch_fn = (make_epoch_fn(cfg, mesh) if blocks is None
                    else block_epoch_fn(cfg, blocks))
        _, metrics = epoch_fn(
            state, case["train_x"], case["train_idx"], case["perm"], bank,
            case["beta"], generator=g)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": {k: v.clone()
                           for k, v in model.state_dict().items()},
                "step_grads": step_grads}

    if mesh is None:
        return epoch()
    dist.all_reduce = counted
    try:
        epoch(steps=1)
        step_reduces, counts["n"] = counts["n"], 0
        out = epoch()
    finally:
        dist.all_reduce = all_reduce
    return dict(out, step_reduces=step_reduces, epoch_reduces=counts["n"])


def make_block_train_step(cfg, world, *, bank_preprocessed=False, mesh=None):
    """One process's train step, its batch summed in the row blocks of a
    mesh of ``world`` (per-row support only): the whole batch's noise
    drawn as every rank draws it, then each rank's rows (Mesh.batch_rows)
    through the one-process loss over the whole bank, batch_loss(
    batch_size=B), and a backward of ``world`` times it, in rank order, so
    that each .grad adds up the blocks as the mesh's all_reduce does; then
    / world, as Mesh.average_grads. The metrics are the blocks' shares
    summed."""
    assert mesh is None and cfg.approximate_support == "per_row"

    def train_step(state, x_raw, data_idx, bank, beta, *, generator=None,
                   u=None, eps=None):
        noise, bank = draw_step_noise(
            state.model, cfg, x_raw, bank, generator, u=u, eps=eps,
            preprocess_bank=not bank_preprocessed)
        b = x_raw.shape[0]
        state.opt.zero_grad(set_to_none=True)
        metrics = {}
        for r in range(world):
            lo, hi = Mesh(size=world, rank=r,
                          device=x_raw.device).batch_rows(b)
            rows = noise.rows(lo, hi, cfg.approximate_k)
            x = preprocess_batch(x_raw[lo:hi], input_type=cfg.input_type,
                                 dynamic_binarization=cfg.dynamic_binarization,
                                 train=True, u=rows.u)
            loss, aux = batch_loss(state.model, x, beta, cfg,
                                   data_idx=data_idx[lo:hi], bank=bank,
                                   train=True, eps=rows.eps,
                                   bank_u=rows.bank_u, generator=generator,
                                   batch_size=b)
            (loss * world).backward()
            metrics = {k: metrics.get(k, 0) + v.detach()
                       for k, v in aux.items()}
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.div_(world)
        state.opt.step()
        state.step += 1
        return state, metrics

    return train_step


def block_epoch_fn(cfg, world):
    """make_epoch_fn(cfg) on one process, its steps make_block_train_step's
    with ``world`` blocks."""
    make = train_steps.make_train_step
    train_steps.make_train_step = functools.partial(make_block_train_step,
                                                    world=world)
    try:
        return make_epoch_fn(cfg)
    finally:
        train_steps.make_train_step = make


def _data_parallel(inp, mesh):
    out = {"steps": {name: step_case(c, mesh)
                     for name, c in inp["steps"].items()}}
    if "prior" in inp:
        p = inp["prior"]
        model = create_model(Config.from_json(p["cfg"]), device="cpu")
        model.load_state_dict(p["params"])
        out["prior"] = prior_case(p, mesh, model)
    out["epochs"] = {name: epoch_case(c, mesh)
                     for name, c in inp.get("epochs", {}).items()}
    return out


def mesh_spans_case(case, mesh):
    """One epoch of one step of ``case`` on the mesh from its params, first
    without a profiler and then under one: for each, the bytes that the
    port's all_reduce counted, the calls it kept (the profiler's only), the
    ranges of the profiler's trace by name and the params after it; and
    the number of gradient elements the step averaged."""
    from torch.profiler import ProfilerActivity, profile

    from exemplar_vae_tpu_torch.parallel.mesh import all_reduce
    out = {}
    for profiled in (False, True):
        cfg, model, _ = _case_model(case)
        g = torch.Generator().manual_seed(case["seed"])
        epoch_fn = make_epoch_fn(cfg, mesh)
        all_reduce.kept.clear()
        before = all_reduce.bytes
        with (profile(activities=[ProfilerActivity.CPU]) if profiled
              else contextlib.nullcontext()) as prof:
            epoch_fn(init_train_state(model, cfg), case["train_x"],
                     case["train_idx"], case["perm"][:1],
                     _case_bank(case, mesh), case["beta"], generator=g)
        ranges = {}
        for e in (prof.events() if profiled else ()):
            if e.name.startswith("evae."):
                ranges[e.name] = ranges.get(e.name, 0) + 1
        out[profiled] = {
            "bytes": all_reduce.bytes - before, "kept": list(all_reduce.kept),
            "ranges": ranges,
            "params": {k: v.clone() for k, v in model.state_dict().items()}}
        out["grad_numel"] = sum(p.grad.numel() for p in model.parameters()
                                if p.grad is not None)
    return out


def record_step_grads(model, opt):
    """The gradients of each of ``opt``'s steps, by parameter name (a list
    that grows as the steps run)."""
    seen = []
    step = opt.step

    def recording(closure=None):
        seen.append({k: p.grad.clone() for k, p in model.named_parameters()})
        return step(closure)

    opt.step = recording
    return seen


def _experiment(inp, mesh, scenario):
    cfg = Config.from_json(inp["cfg"])
    exp = Experiment(cfg, device="cpu", verbose=False)
    assert exp.mesh is not None and exp.mesh.size == mesh.size
    step_grads = record_step_grads(exp.model, exp.state.opt)
    out = {"bank_rows": exp.bank.images.shape[0],
           "bank_idx": exp.bank.data_idx.clone(),
           "metrics": exp.train_epoch(),
           "step_grads": step_grads,
           "grads": {k: p.grad.clone()
                     for k, p in exp.model.named_parameters()},
           "params": {k: v.clone() for k, v in exp.model.state_dict().items()},
           "val": exp.validate()}
    exp._log(out["metrics"])            # every rank logs, rank 0 writes
    if scenario == "approx":
        out["cache"] = exp.bank.cache_means.clone()
        exp.save_checkpoint("cycle")
        fresh = Experiment(cfg, device="cpu", verbose=False)
        out["restored"] = fresh.restore_checkpoint("cycle")
        out["restored_cache"] = fresh.bank.cache_means.clone()
        out["restored_params"] = {k: v.clone() for k, v in
                                  fresh.model.state_dict().items()}
        out["restored_m"] = [fresh.state.opt.state[p]["m"].clone()
                             for p in fresh.model.parameters()]
        out["saved_m"] = [exp.state.opt.state[p]["m"].clone()
                          for p in exp.model.parameters()]
        out["restored_meta"] = (fresh.epoch, fresh.best_val,
                                fresh.bad_epochs, fresh.state.step,
                                fresh.state.opt.count)
        out["saved_meta"] = (exp.epoch, exp.best_val, exp.bad_epochs,
                             exp.state.step, exp.state.opt.count)
    return out


def main():
    scenario, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    init_distributed("cpu", init_method=f"file://{os.path.join(work, 'pg')}")
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        cfg = Config.from_json(inp["cfg"])
        mesh = create_mesh(cfg, "cpu")
        if scenario == "ops":
            out = _ops(inp, mesh)
        elif scenario in ("dp", "dp3"):
            out = _data_parallel(inp, mesh)
        elif scenario == "mesh_spans":
            out = mesh_spans_case(inp["case"], mesh)
        else:
            out = _experiment(inp, mesh, scenario)
        out["jax_loaded"] = [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "exemplar_vae_tpu")]
        torch.save(out, os.path.join(work, f"rank{mesh.rank}.pt"))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
