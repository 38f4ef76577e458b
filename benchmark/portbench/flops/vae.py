"""FLOP counter of the ``vae`` family (the MLP VAE, exact exemplar prior)
and the pairwise-LSE calls its step and its IWAE request make.

Train step (batch B, bank N, latent D): the batch's encoder, decoder and
their backward; the whole bank re-encoded (mean head only) with its
weight gradients; the prior's cross term z . mu over the bank, 2 B N D
FLOPs forward and twice that backward. IWAE request of t points (S =
rounds * r samples each): the encoder once per point, the decoder on every
sample, the prior's cross term over the bank for every sample."""

from __future__ import annotations

from portbench.flops.ops import dense, gated, total


def _sizes(cfg):
    c, h, w = cfg["input_size"]
    return c * h * w, cfg["hidden_size"], cfg["z1_size"]


def _encoder(rows, cfg, *, backward=False, logvar=True):
    x, h, z = _sizes(cfg)
    ops = [gated("q_layers_0", rows, x, h, backward=backward, dx=False),
           gated("q_layers_1", rows, h, h, backward=backward),
           dense("q_mean_head", rows, h, z, backward=backward)]
    if logvar:
        ops.append(dense("q_logvar_head", rows, h, z, backward=backward))
    return ops


def _decoder(rows, cfg, *, backward=False):
    x, h, z = _sizes(cfg)
    return [gated("p_layers_0", rows, z, h, backward=backward),
            gated("p_layers_1", rows, h, h, backward=backward),
            dense("p_mean_head", rows, h, x, backward=backward)]


def _prior(rows, cfg, *, backward=False):
    return dense("prior_cross_term", rows, cfg["z1_size"],
                 cfg["number_components"], backward=backward)


def step_ops(cfg: dict):
    b, n = cfg["batch_size"], cfg["number_components"]
    return (_encoder(b, cfg, backward=True) + _decoder(b, cfg, backward=True)
            + [op._replace(name="bank_" + op.name) for op in
               _encoder(n, cfg, backward=True, logvar=False)]
            + [_prior(b, cfg, backward=True)])


def request_ops(cfg: dict, t: int):
    samples = t * rounds(cfg) * cfg["MB"]
    return _encoder(t, cfg) + _decoder(samples, cfg) + [_prior(samples, cfg)]


def rounds(cfg: dict) -> int:
    return -(-cfg["S"] // cfg["MB"])


def step_flops(cfg: dict) -> float:
    return total(step_ops(cfg))


def request_flops(cfg: dict, t: int) -> float:
    return total(request_ops(cfg, t))


def lse_calls_step(cfg: dict):
    """One call a step: the batch against the whole bank, leave-one-out."""
    return [(cfg["batch_size"], cfg["number_components"], cfg["z1_size"],
             True)]


def lse_calls_request(cfg: dict, t: int):
    """One call a round: t * r samples against the whole bank."""
    return [(t * cfg["MB"], cfg["number_components"], cfg["z1_size"],
             False)] * rounds(cfg)
