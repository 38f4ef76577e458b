"""The exact exemplar prior over a sharded bank (counterpart of
exemplar_vae_tpu/parallel/sharded_prior.py).

Each rank re-encodes its own bank shard with gradients and runs the
pairwise-LSE kernel (ops/pairwise_lse.py, through the prior's autograd
Function) of the replicated batch latents against it, with the LOO mask on
the shard's global exemplar indices. The global mixture is the log-space
combine of the per-shard partials:

    m = all_reduce_MAX(lse_local.detach()),
    lse = m + log(all_reduce_SUM(exp(lse_local - m)))

The max is a shift and carries no gradient; the SUM is the mesh's
differentiable all-reduce, whose backward scales each rank's shard gradient
by the world size, which the train step's gradient average undoes
(parallel/mesh.py::AllReduceSum).
"""

from __future__ import annotations

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
from exemplar_vae_tpu_torch.ops.knn import encode_bank_with_grad
from exemplar_vae_tpu_torch.parallel.mesh import Mesh
from exemplar_vae_tpu_torch.train.loss import bank_draw_fn, bank_pre_fn


def make_sharded_exact_prior(cfg: Config, mesh: Mesh):
    """``prior_fn(model, z, loo_idx, bank, log_denom, generator=None) ->
    (B,) log p(z)``, the train loss's ``sharded_exact_fn``. ``bank`` holds
    this rank's shard: images (n_loc, ...), global data_idx and valid
    (n_loc,); padding rows have index -2 and valid False."""
    impl = "pallas" if cfg.use_pallas_prior else "scan"

    def prior_fn(model, z, loo_idx, bank, log_denom, generator=None):
        pre = draw = None
        if bank.images.dtype == torch.uint8:
            if cfg.bank_stochastic_preprocess:
                generator = mesh.shard_generator(generator)
            pre = bank_pre_fn(cfg, generator)
            draw = bank_draw_fn(cfg, generator)
        means = encode_bank_with_grad(model, bank.images,
                                      chunk=cfg.exact_reencode_chunk,
                                      remat=cfg.exact_remat, pre_fn=pre,
                                      draw_fn=draw)
        lse_local = exemplar_log_prob(
            z, means, model.get_prior_log_var(), log_denom=0.0,
            data_idx=loo_idx, exemplar_idx=bank.data_idx, valid=bank.valid,
            impl=impl, block_n=cfg.prior_block_n)
        m = mesh.all_reduce(lse_local.detach().clone(), op="max")
        s = mesh.all_reduce_sum_grad(torch.exp(lse_local - m))
        return m + torch.log(s) - float(log_denom)

    return prior_fn
