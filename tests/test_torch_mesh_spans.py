"""The data mesh's spans and byte counter on 2 gloo ranks on the CPU
(parallel/mesh.py): ``evae.mesh.grads`` around the gradient average,
``evae.mesh.gather`` around the kNN prior's gathers and candidate merge,
``evae.mesh.metrics`` around the epoch's metric sums, and
``all_reduce.bytes`` / ``all_reduce.kept``, the bytes each rank puts
through all_reduce. One epoch of one step of Config 4's shape at 16x16
(tests/test_torch_data_parallel.py's ``convhvae_uint8_rgb``), without and
then under a profiler (tests/_torch_mp_child.py's ``mesh_spans``).

Compared exactly: the counted bytes against the buffers the step's
collectives take, from the shapes; the params after the epoch with the
profiler on and off, bitwise (the ranges and the counter add no work)."""

import numpy as np
import pytest
import torch

from exemplar_vae_tpu_torch.config import Config

from test_torch_data_parallel import CASES, _case
from test_torch_sharding import _run_ranks

W, B, SEED = 2, 8, 23
CASE = "convhvae_uint8_rgb"


@pytest.fixture(scope="module")
def spans_run(tmp_path_factory):
    case = _case(CASE, B, SEED)
    outs = _run_ranks("mesh_spans", tmp_path_factory.mktemp("mesh_spans"),
                      {"cfg": Config(mesh_shape=(W,)).to_json(),
                       "case": case}, world=W)
    return case, outs


def _buffers(case, grad_numel):
    """The bytes of each all_reduce of one step and its epoch, in order:
    the batch's query means gathered (B, Dz) fp32; the candidates' distances
    (W, B, K) fp32 and bank rows (W, B, K) int64; the selected bank images
    (B * K, C * H * W) uint8 and their exemplar indices (B * K, 1) int32; the
    gradients, fp32; the epoch's loss, RE and KL sums, fp32."""
    cfg = Config.from_json(case["cfg"])
    k, dz = cfg.approximate_k, cfg.z2_size
    c, h, w = cfg.input_size
    return [B * dz * 4, W * B * k * 4, W * B * k * 8, B * k * c * h * w,
            B * k * 4, grad_numel * 4, 3 * 4]


def test_the_counter_counts_the_collectives_buffers(spans_run):
    case, outs = spans_run
    assert CASES[CASE]["approximate_prior"]
    for out in outs:
        want = _buffers(case, out["grad_numel"])
        kept = out[True]["kept"]
        assert [n for _, n in kept] == want
        # each kept count is the counter before its call
        assert [b for b, _ in kept] == list(np.cumsum([0] + want[:-1])
                                            + kept[0][0])
        assert out[True]["bytes"] == out[False]["bytes"] == sum(want)
        assert out[False]["kept"] == []


def test_the_mesh_ranges_open_under_a_profiler_only(spans_run):
    _, outs = spans_run
    for out in outs:
        ranges = out[True]["ranges"]
        assert ranges["evae.mesh.grads"] == 1
        assert ranges["evae.mesh.metrics"] == 1
        # the queries' gather, the merge and its two gathers, the images'
        # and the indices' row gathers
        assert ranges["evae.mesh.gather"] == 6
        assert out[False]["ranges"] == {}


def test_the_profiler_leaves_the_params_bitwise_equal(spans_run):
    _, outs = spans_run
    for out in outs:
        off, on = out[False]["params"], out[True]["params"]
        assert set(off) == set(on)
        for k in off:
            assert torch.equal(off[k], on[k]), k
    for k in outs[0][True]["params"]:
        assert torch.equal(outs[0][True]["params"][k],
                           outs[1][True]["params"][k]), k
