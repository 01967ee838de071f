"""Pixel rows split over ``torch.distributed`` ranks (port of
strolle_tpu/parallel/).

One process per card (a rank) in a process group: ``nccl`` on CUDA,
``gloo`` on the CPU. A mesh is a ``torch.distributed`` DeviceMesh over
every rank of the group in rank order: ``("px",)`` from
``sharding.make_mesh``, ``("host", "chip")`` from
``distributed.make_host_chip_mesh``. Rows split host-major over both
axes, which is the rank order, so the 2-D mesh shares the 1-D mesh's
code.

- ``sharding``: the reference sample, each rank tracing only its own
  rows and the blocks gathered at the end.
- ``frame_sharding``: the realtime frame. Every rank holds the whole
  state and runs the per-pixel and cross-pixel stages at full height;
  only the trace calls split their rows (``ops.trace.trace_rows_sharded``).
- ``distributed``: process-group set-up (torchrun's variables), the
  host x chip mesh and its sample and training step.

The training step (``models.train.train_step_sharded``) renders each
rank's rows, runs its backward locally and sums the loss and gradients
over the ranks in one all-reduce.
"""
