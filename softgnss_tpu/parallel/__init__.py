"""Distribution layer: device meshes, sharded acquisition and tracking.

The reference is single-process/single-threaded (SURVEY.md §2 parallelism
table); this package supplies the device-mesh equivalents:

* **satellite (PRN) sharding** of the acquisition search grid — the
  (PRN x Doppler x code-phase) tensor partitions cleanly on the PRN axis
  (softgnss_tpu.parallel.acquire),
* **channel sharding** of tracking — each mesh slot tracks a subset of
  channels over the replicated capture (embarrassingly parallel, exact),
* **time-block sharding** of tracking — long captures split across the
  'time' mesh axis, boundary samples exchanged with `lax.ppermute`
  (overlap-save halos), with a warm-up re-lock interval replacing the
  sequential loop-filter carry (softgnss_tpu.parallel.track),
* **exact time blocking** — the sequential-carry handoff anchor
  (bit-identical to single-device; softgnss_tpu.parallel.track_time_exact),
* **pipeline (stage) overlap** — software-pipelined tracking whose
  capture upload / device compute / output readback overlap across time
  chunks (softgnss_tpu.parallel.track_streamed),
* multi-host bootstrap helpers (softgnss_tpu.parallel.mesh).
"""

from softgnss_tpu.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    receiver_mesh,
)
from softgnss_tpu.parallel.acquire import acquire_sharded  # noqa: F401
from softgnss_tpu.parallel.stream import track_streamed  # noqa: F401
from softgnss_tpu.parallel.track import (  # noqa: F401
    track_channels_sharded,
    track_time_exact,
    track_time_sharded,
)
