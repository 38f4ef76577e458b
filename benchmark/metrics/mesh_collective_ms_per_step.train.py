"""mesh_collective_ms_per_step.train: rank 0's device ms a train step under
the port's ``evae.mesh.*`` spans (the gradient average ``evae.mesh.grads``;
the kNN prior's gathers and candidate merge ``evae.mesh.gather``; the
epoch's metric sums ``evae.mesh.metrics``: the collectives' kernels, which
wait there for the slowest rank, and the buffers' fills and copies), over
the profiled stretch of the mesh's train cells (portbench/spans.py).
Nothing without the spans: one card, or a port that opens none."""

from portbench import spans

spans.install()

MESH = "evae.mesh."


def under_mesh(names) -> bool:
    return any(n.startswith(MESH) for n in names)


def read(r):
    s = spans.spans_of(r, "train")
    if s is None or not under_mesh(s.counts):
        return None
    seconds = sum(sec for sec, launch, fwd in s.ops
                  if under_mesh(launch | fwd))
    return 1e3 * seconds / r.units
