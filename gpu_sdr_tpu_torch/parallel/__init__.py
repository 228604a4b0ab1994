"""One front end's stream sharded over a (time, channels) mesh of torch
devices, driven by one process or by one process a host (port of
gpu_sdr_tpu/parallel).

* ``channels``: tones / PFB bins shard across devices, each owning a
  column slice of the modulated taps or of the DFT;
* ``time``: each block's samples shard across devices; the overlap-save
  halo of the FIR or the PFB rides one step around the time ring
  (mesh.ppermute), and the resident replays and fused chains stage it
  at upload or build time instead.

Per-shard work is a Python loop over the process's own shards, each
shard's kernels queued on its device's current stream (the counterpart
of shard_map); a device may repeat in a mesh (virtual shards).  Across
processes (distributed.py: torch.distributed, NCCL between cards, gloo
on the CPU and between ranks that share a card) the mesh spans every
rank's devices, the ring, the psum and the gather run between the
processes, and every rank's sinks get the global stream; host_ingest.py
feeds each rank its own span over TCP; rehearsal.py drives every
sharded path across processes.
"""

from .mesh import Mesh, Sharded, default_mesh, make_mesh  # noqa: F401
from .sharded import ShardedDDC  # noqa: F401
from .fused_sharded import ShardedFusedLoopback  # noqa: F401
