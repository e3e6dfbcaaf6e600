"""accl_tpu_torch.ops: collectives over ranks that share one device.

* ``collectives`` — the plain stacked-rank forms (the ``xla`` lowering).
* ``ring`` — the explicit segmented ring pipeline (the ``ring`` lowering).
* ``cuda`` — the hand-written kernels (ring collectives, rooted relays,
  combine, the command-ring sequencer).
* ``cmdring`` — the command ring's device half: ``slot_epilogue`` and
  ``run_window``.
* ``driver`` — stacked-in, stacked-out entry points over a :class:`Mesh`.
* ``attention`` — the blockwise online-softmax fold (the transformer's
  ``attention="blockwise"`` lowering).
"""

from . import attention, cmdring, collectives, cuda, ring, wire  # noqa: F401
from .driver import (  # noqa: F401
    Mesh,
    make_mesh,
    run_allgather,
    run_allreduce,
    run_alltoall,
    run_bcast,
    run_compressed_allreduce,
    run_gather,
    run_pallas_allreduce,
    run_pallas_bcast,
    run_pallas_gather,
    run_pallas_reduce,
    run_pallas_scatter,
    run_reduce,
    run_reduce_scatter,
    run_ring_allreduce,
    run_scatter,
)
