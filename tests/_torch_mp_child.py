"""One rank of the port's bank-sharding tests (tests/test_torch_sharding.py).

    python tests/_torch_mp_child.py <scenario> <work dir>

RANK and WORLD_SIZE come from the environment; the process group is a gloo
group on the CPU, initialized through ``file://<work dir>/pg``. The inputs
are ``<work dir>/inputs.pt``; the rank writes ``<work dir>/rank<r>.pt``.
Imports the port and torch only, never JAX.

Scenarios:
  ops        the sharded exact prior's value and gradients, the kNN select,
             the row gather, and a mesh size that differs from the world
             size;
  exact      one Experiment epoch with the exact prior, then validation;
  approx     one Experiment epoch with the approximate prior, validation,
             then a checkpoint save and a restore into a fresh Experiment.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from exemplar_vae_tpu_torch.config import Config  # noqa: E402
from exemplar_vae_tpu_torch.models import create_model  # noqa: E402
from exemplar_vae_tpu_torch.parallel.mesh import (create_mesh,  # noqa: E402
                                                  init_distributed, shutdown)
from exemplar_vae_tpu_torch.parallel.sharded_knn import (  # noqa: E402
    sharded_knn_select, sharded_row_gather)
from exemplar_vae_tpu_torch.parallel.sharded_prior import \
    make_sharded_exact_prior  # noqa: E402
from exemplar_vae_tpu_torch.train.loss import Bank  # noqa: E402
from exemplar_vae_tpu_torch.train.trainer import Experiment  # noqa: E402


def _ops(inp, mesh):
    out = {}
    cfg = Config.from_json(inp["cfg"])
    lo, hi = mesh.shard_range(inp["images"].shape[0])
    # the sharded exact prior: value and gradients (params and z)
    model = create_model(cfg, device="cpu")
    model.load_state_dict(inp["params"])
    z = inp["z"].clone().requires_grad_(True)
    bank = Bank(images=inp["images"][lo:hi], data_idx=inp["data_idx"][lo:hi],
                valid=inp["valid"][lo:hi], cache_means=None,
                n_effective=inp["n"])
    prior = make_sharded_exact_prior(cfg, mesh)(
        model, z, inp["loo"], bank, inp["log_denom"])
    (inp["cot"] * prior).sum().backward()
    mesh.average_grads(list(model.parameters()) + [z])
    out["prior"] = prior.detach()
    out["grads"] = {k: torch.zeros_like(p) if p.grad is None else p.grad
                    for k, p in model.named_parameters()}
    out["z_grad"] = z.grad
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


def _experiment(inp, mesh, scenario):
    cfg = Config.from_json(inp["cfg"])
    exp = Experiment(cfg, device="cpu", verbose=False)
    assert exp.mesh is not None and exp.mesh.size == mesh.size
    out = {"bank_rows": exp.bank.images.shape[0],
           "bank_idx": exp.bank.data_idx.clone(),
           "metrics": exp.train_epoch(),
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
        else:
            out = _experiment(inp, mesh, scenario)
        out["jax_loaded"] = [m for m in sys.modules
                             if m.split(".")[0] in ("jax", "exemplar_vae_tpu")]
        torch.save(out, os.path.join(work, f"rank{mesh.rank}.pt"))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
