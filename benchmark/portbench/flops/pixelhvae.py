"""FLOP counter of the ``pixelhvae`` family (the two-level HVAE with a
PixelCNN decoder, exact exemplar prior), the pairwise-LSE calls its IWAE
request makes, and the least time of its masked stack.

IWAE request of t points (S = rounds * r samples each): q(z2|x) and the
x-side of q(z1|x,z2) once per point; on every sample the z1 nets, the
context map ctx_proj(z1 || z2), the masked stack and the 1x1 head; the
exact prior's cross term over the bank, 2 N D FLOPs a sample. A masked
conv counts the taps its mask keeps, (k // 2) * k + k // 2 of k * k for
'A' and one more for 'B' (12 of 25 for the 5x5 'A', 5 of 9 for the 3x3
'B'); the head counts in full. No cell trains this family, so the train
step is not counted."""

from __future__ import annotations

from portbench.common import PEAK_FLOPS, PEAK_HBM_BYTES_PER_S
from portbench.flops.ops import Op, dense, gated, total
from portbench.reference.pixelhvae import masked_layers

ELEM = 4            # fp32


def kept_taps(k: int, kind: str) -> int:
    return (k // 2) * k + k // 2 + (1 if kind == "B" else 0)


def _sizes(cfg):
    c, h, w = cfg["input_size"]
    return c, h * w, cfg["pixelcnn_features"]


def _masked_stack(rows, cfg):
    """The masked layers by their kept taps, then the head."""
    c, hw, pf = _sizes(cfg)
    ops, c_in = [], c
    for name, kind, k in masked_layers(cfg):
        ops.append(Op(name, rows, hw * c_in * pf * kept_taps(k, kind), False))
        c_in = pf
    ops.append(Op("p_x_mean_head", rows, hw * pf * c, False))
    return ops


def _encode(rows, cfg):
    c, hw, _ = _sizes(cfg)
    x, h, z2 = c * hw, cfg["hidden_size"], cfg["z2_size"]
    return [gated("q_z2_layers_0", rows, x, h),
            gated("q_z2_layers_1", rows, h, h),
            dense("q_z2_mean_head", rows, h, z2),
            dense("q_z2_logvar_head", rows, h, z2),
            gated("q_z1_x", rows, x, h)]


def _per_sample(rows, cfg):
    c, hw, pf = _sizes(cfg)
    h, z1, z2 = cfg["hidden_size"], cfg["z1_size"], cfg["z2_size"]
    return [gated("q_z1_z2", rows, z2, h),
            gated("q_z1_joint", rows, 2 * h, h),
            dense("q_z1_mean_head", rows, h, z1),
            dense("q_z1_logvar_head", rows, h, z1),
            gated("p_z1_layers_0", rows, z2, h),
            gated("p_z1_layers_1", rows, h, h),
            dense("p_z1_mean_head", rows, h, z1),
            dense("p_z1_logvar_head", rows, h, z1),
            dense("ctx_proj", rows, z1 + z2, hw * pf)] + _masked_stack(
                rows, cfg)


def rounds(cfg: dict) -> int:
    return -(-cfg["S"] // cfg["MB"])


def request_ops(cfg: dict, t: int):
    samples = t * rounds(cfg) * cfg["MB"]
    return (_encode(t, cfg) + _per_sample(samples, cfg)
            + [dense("prior_cross_term", samples, cfg["z2_size"],
                     cfg["number_components"])])


def step_flops(cfg: dict) -> float:
    raise NotImplementedError("no cell trains the pixelhvae family")


def request_flops(cfg: dict, t: int) -> float:
    return total(request_ops(cfg, t))


def lse_calls_request(cfg: dict, t: int):
    """One call a round: t * r samples against the whole bank."""
    return [(t * cfg["MB"], cfg["number_components"], cfg["z2_size"],
             False)] * rounds(cfg)


def masked_stack_bound_s(rows: int, cfg: dict) -> float:
    """The least time of the teacher-forced masked stack over ``rows``
    images: over the masked layers and the head, each max(its kept-tap
    FLOPs / the TF32 peak, its bytes / the HBM rate). Bytes: the layer's
    input and output in fp32 once each, and for a masked layer the context
    map read once."""
    c, hw, pf = _sizes(cfg)
    # (input, output, context) channels of each layer
    channels = ([(c, pf, pf)] + [(pf, pf, pf)] * cfg["pixelcnn_layers"]
                + [(pf, c, 0)])
    return sum(max(op.flops / PEAK_FLOPS,
                   rows * hw * sum(ch) * ELEM / PEAK_HBM_BYTES_PER_S)
               for op, ch in zip(_masked_stack(rows, cfg), channels))
