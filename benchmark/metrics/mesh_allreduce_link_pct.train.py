"""mesh_allreduce_link_pct.train: the mesh's all-reduces as a share of
their roofline, over the profiled stretch of the mesh's train cells on
rank 0, in %.

The bound is the bytes that rank 0 put through all_reduce in the stretch
(the port's counter ``mesh.all_reduce.bytes``: the change over the calls
it keeps while a profiler runs, ``all_reduce.kept``) over the NVLink rate
of one card in one direction: no all-reduce algorithm, an in-switch
reduction included, sends or receives less than its buffer. The divisor is
the device time of the NCCL kernels (names ``nccl*``) of the stretch; the
port makes every all_reduce inside an ``evae.mesh.*`` span, and the reading
is taken only where the kernels are as many as the calls the counter kept.
Nothing without the spans or the counter (one card, or a port that has
neither), or where the counts differ.

LINK_BYTES_PER_S: NVIDIA H100 SXM5, NVLink 4: 18 links of 26.5625 GB/s in
each direction (read on the four-card H100 host with `nvidia-smi nvlink
-s`: 18 links on card 0, each at 26.562 GB/s; `nvidia-smi topo -m` does
not run in that machine's sandbox)."""

from portbench import spans

spans.install()

LINK_BYTES_PER_S = 18 * 26.5625e9
MESH = "evae.mesh."


def is_nccl(name: str) -> bool:
    return name.startswith("nccl")


def counted():
    """(calls, bytes) that the port's all_reduce kept under the profiler,
    or None where it keeps none (or more than its window holds)."""
    try:
        from exemplar_vae_tpu_torch.parallel.mesh import all_reduce
    except ImportError:
        return None
    kept = getattr(all_reduce, "kept", None)
    if not kept or len(kept) == kept.maxlen:
        return None
    return len(kept), sum(n for _, n in kept)


def read(r):
    s = spans.spans_of(r, "train")
    if s is None or not any(n.startswith(MESH) for n in s.counts):
        return None
    got = counted()
    if got is None:
        return None
    calls, nbytes = got
    seconds, kernels = r.trace.device_seconds(is_nccl)
    if not seconds or kernels != calls:
        return None
    return 100.0 * nbytes / LINK_BYTES_PER_S / seconds
