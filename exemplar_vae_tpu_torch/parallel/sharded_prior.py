"""The exact exemplar prior on the data mesh (counterpart of
exemplar_vae_tpu/parallel/sharded_prior.py).

Each rank holds its own rows of the batch and its own shard of the bank.
The batch latents z (B_r, D) are gathered into the whole batch's (B, D)
with the mesh's differentiable gather (parallel/mesh.py::AllGatherRows),
the LOO indices with the plain one; the JAX package's shard_map takes z
replicated too (P()), so XLA gathers the batch-sharded z into it. Each
rank re-encodes its bank shard with gradients (train/bank.py, which also
owns the shard's draws) and runs the pairwise-LSE kernel
(ops/pairwise_lse.py, through the prior's autograd Function) of the whole
batch against it, with the LOO mask on the shard's global exemplar indices.
The global mixture is the log-space combine of the per-shard partials:

    m = all_reduce_MAX(lse_local.detach()),
    lse = m + log(all_reduce_SUM(exp(lse_local - m)))

and the rank returns its own rows of it. The max is a shift and carries no
gradient; the SUM is the mesh's differentiable all-reduce, whose backward
brings each row's cotangent from the rank that owns the row to every bank
shard (parallel/mesh.py::AllReduceSum, Mesh.average_grads).
"""

from __future__ import annotations

import torch

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.ops.exemplar_prior import exemplar_log_prob
from exemplar_vae_tpu_torch.parallel.mesh import Mesh
from exemplar_vae_tpu_torch.train.bank import encode_bank_with_grad
from exemplar_vae_tpu_torch.train.loss import prior_impl


def make_sharded_exact_prior(cfg: Config, mesh: Mesh):
    """``prior_fn(model, z, loo_idx, bank, log_denom, generator=None, *,
    batch_size) -> (B_r,) log p(z)``, the train loss's ``sharded_exact_fn``.
    ``z`` (B_r, D) and ``loo_idx`` (B_r,) (or None) are this rank's rows of
    a batch of ``batch_size`` (Mesh.batch_rows); ``bank`` holds this rank's
    shard: images (n_loc, ...), global data_idx and valid (n_loc,); padding
    rows have index -2 and valid False."""
    impl = prior_impl(cfg)

    def prior_fn(model, z, loo_idx, bank, log_denom, generator=None, *,
                 batch_size):
        lo, hi = mesh.batch_rows(batch_size)
        z_all = mesh.all_gather_rows_grad(z, batch_size)
        loo_all = (None if loo_idx is None
                   else mesh.all_gather_rows(loo_idx, batch_size))
        means = encode_bank_with_grad(model, bank.images, cfg, generator,
                                      mesh)
        lse_local = exemplar_log_prob(
            z_all, means, model.get_prior_log_var(), log_denom=0.0,
            data_idx=loo_all, exemplar_idx=bank.data_idx, valid=bank.valid,
            impl=impl, block_n=cfg.prior_block_n)
        m = mesh.all_reduce(lse_local.detach().clone(), op="max")
        s = mesh.all_reduce_sum_grad(torch.exp(lse_local - m))
        return (m[lo:hi] + torch.log(s[lo:hi])) - float(log_denom)

    return prior_fn
