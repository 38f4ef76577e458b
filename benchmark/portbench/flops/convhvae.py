"""FLOP counter of the ``convhvae`` family (the two-level ConvHVAE,
approximate kNN exemplar prior for training, exact prior for the IWAE)
and the pairwise-LSE calls its step and its IWAE request make.

Train step (batch B, K neighbours, bank N, latent D): the batch's two conv
stacks, the q(z1|x,z2) and p(z1|z2) nets, the decoder (gated dense, the
projection, the gated transposed convs, the 1x1 heads) and their backward;
the kNN distances' cross term against the cache, 2 B N D FLOPs, no
gradient; the B K selected rows re-encoded (q(z2|x) stack and mean head)
with their weight gradients. The per-row mixture over K is elementwise.
IWAE request of t points (S = rounds * r samples each): q(z2|x) and the
x-side conv stack of q(z1|x,z2) once per point; the z1 nets and the
decoder on every sample; the exact prior's cross term over the bank for
every sample."""

from __future__ import annotations

from portbench.flops.ops import conv, conv_t, dense, gated, total
from portbench.reference.convhvae import geometry


def _stack(prefix, rows, cfg, *, backward=False):
    enc, _, _, _ = geometry(cfg)
    c, h, w = cfg["input_size"]
    ops = []
    for i, (_, f, k, s) in enumerate(enc):
        h, w = -(-h // s), -(-w // s)
        ops.append(conv(f"{prefix}_{i}", rows, (h, w), c, 2 * f, k,
                        backward=backward, dx=i > 0))
        c = f
    return ops


def _q_z2(rows, cfg, *, backward=False, logvar=True):
    _, _, _, enc_dim = geometry(cfg)
    ops = _stack("q_z2_conv", rows, cfg, backward=backward)
    ops.append(dense("q_z2_mean_head", rows, enc_dim, cfg["z2_size"],
                     backward=backward))
    if logvar:
        ops.append(dense("q_z2_logvar_head", rows, enc_dim, cfg["z2_size"],
                         backward=backward))
    return ops


def _z1_nets(rows, cfg, *, backward=False):
    _, _, _, enc_dim = geometry(cfg)
    h, z1, z2 = cfg["hidden_size"], cfg["z1_size"], cfg["z2_size"]
    kw = dict(backward=backward)
    return [gated("q_z1_z2", rows, z2, h, **kw),
            gated("q_z1_joint", rows, enc_dim + h, h, **kw),
            dense("q_z1_mean_head", rows, h, z1, **kw),
            dense("q_z1_logvar_head", rows, h, z1, **kw),
            gated("p_z1_layers_0", rows, z2, h, **kw),
            gated("p_z1_layers_1", rows, h, h, **kw),
            dense("p_z1_mean_head", rows, h, z1, **kw),
            dense("p_z1_logvar_head", rows, h, z1, **kw)]


def _decoder(rows, cfg, *, backward=False):
    _, dec, down, _ = geometry(cfg)
    c_in, ih, iw = cfg["input_size"]
    h, proj = cfg["hidden_size"], cfg["conv_proj_channels"]
    hw = (ih // down, iw // down)
    kw = dict(backward=backward)
    ops = [gated("p_x_z1", rows, cfg["z1_size"], h, **kw),
           gated("p_x_z2", rows, cfg["z2_size"], h, **kw),
           dense("p_x_project", rows, 2 * h, hw[0] * hw[1] * proj, **kw)]
    c = proj
    for i, (kind, f, k, s) in enumerate(dec):
        if kind == "t":
            ops.append(conv_t(f"p_x_deconv_{i}", rows, hw, c, 2 * f, k, s,
                              **kw))
            hw = (hw[0] * s, hw[1] * s)
        else:
            hw = (-(-hw[0] // s), -(-hw[1] // s))
            ops.append(conv(f"p_x_deconv_{i}", rows, hw, c, 2 * f, k, **kw))
        c = f
    heads = 1 if cfg["input_type"] == "binary" else 2
    for name in ("p_x_mean_head", "p_x_logvar_head")[:heads]:
        ops.append(conv(name, rows, hw, c, c_in, 1, **kw))
    return ops


def step_ops(cfg: dict):
    b, k, n = cfg["batch_size"], cfg["approximate_k"], cfg["number_components"]
    return (_q_z2(b, cfg, backward=True)
            + _stack("q_z1_conv", b, cfg, backward=True)
            + _z1_nets(b, cfg, backward=True)
            + _decoder(b, cfg, backward=True)
            + [dense("knn_cross_term", b, cfg["z2_size"], n)]
            + [op._replace(name="reencode_" + op.name) for op in
               _q_z2(b * k, cfg, backward=True, logvar=False)])


def rounds(cfg: dict) -> int:
    return -(-cfg["S"] // cfg["MB"])


def request_ops(cfg: dict, t: int):
    samples = t * rounds(cfg) * cfg["MB"]
    return (_q_z2(t, cfg) + _stack("q_z1_conv", t, cfg)
            + _z1_nets(samples, cfg) + _decoder(samples, cfg)
            + [dense("prior_cross_term", samples, cfg["z2_size"],
                     cfg["number_components"])])


def step_flops(cfg: dict) -> float:
    return total(step_ops(cfg))


def request_flops(cfg: dict, t: int) -> float:
    return total(request_ops(cfg, t))


def lse_calls_step(cfg: dict):
    """None: the approximate prior is a per-row mixture over K rows."""
    return []


def lse_calls_request(cfg: dict, t: int):
    """One call a round: t * r samples against the whole bank."""
    return [(t * cfg["MB"], cfg["number_components"], cfg["z2_size"],
             False)] * rounds(cfg)
