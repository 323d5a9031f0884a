"""Distribution layer: device meshes, sharding rules, and collectives (the
port of ``repro.dist`` on ``torch.distributed``).

This package maps model computation onto a mesh (``launch.mesh.Mesh``):
the software analogue of the Ring-Mesh interconnect hierarchy (DESIGN.md
§9): the ``model`` mesh axis plays the role of a ringlet (tight,
high-bandwidth neighborhood), ``data`` the global mesh, and ``pod`` the
expensive pod-boundary hop whose traffic the hierarchical/compressed
collectives shape.

The reference runs its collectives inside ``shard_map`` bodies over named
axes, in one process; the port runs one process per rank, with one
process group per mesh axis (and per set of axes), on NCCL on the card or
gloo on the CPU.  The entry points keep the reference's global view: they
take the global tensors, each rank takes its rows or chunk by its mesh
coordinate, and each returns the replicated result.

Modules:
    context       - ambient mesh registry (``use_mesh`` / ``current_mesh``)
    sharding      - logical axes -> mesh axes (``fit_spec`` divisibility
                    fallback, param/batch/cache specs, DTensor placements)
    collectives   - hierarchical all-reduce (reduce-scatter in-pod, psum
                    across pods, all-gather back)
    compression   - int8 quantization + error feedback, compressed psum
    data_parallel - manual-DP gradient functions (flat / hier / int8 pod hop)
    decode_attn   - sequence-sharded decode attention over a P2P ring

The reference's ``compat`` is not ported: it only backfills newer jax
APIs (``jax.make_mesh(axis_types=...)``, ``jax.shard_map``,
``AxisType``, the dict-shaped ``cost_analysis``) for older jax versions,
and the port uses none of them.
"""

__all__ = ["context", "sharding", "collectives", "compression",
           "data_parallel", "decode_attn"]
