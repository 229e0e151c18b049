"""File-based rendezvous barrier for coordinating plain OS processes
(port of ``multiverso_tpu/utils/filesync.py``).

Used by multi-process test and bench workers (the async-PS plane itself
has NO barriers: this is harness-side coordination, what mpirun's world
bring-up did around the reference's Test/main.cpp battery). Each rank
publishes ``<dir>/<tag>.<rank>`` and polls for all ranks.

Enter, exit and timeout ride the flight recorder, and a timeout names
which ranks arrived and which are missing.
"""

from __future__ import annotations

import os
import time


def file_barrier(directory: str, world: int, rank: int, tag: str,
                 timeout: float = 120.0, poll: float = 0.01) -> None:
    from multiverso_tpu_torch.telemetry import flightrec
    flightrec.record(flightrec.EV_BARRIER_ENTER, note=tag)
    open(os.path.join(directory, f"{tag}.{rank}"), "w").close()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(os.path.exists(os.path.join(directory, f"{tag}.{r}"))
               for r in range(world)):
            flightrec.record(flightrec.EV_BARRIER_EXIT, note=tag)
            return
        time.sleep(poll)
    # arrival snapshot: the missing ranks ARE the diagnosis, so they
    # belong in the exception (and on the black box before the raise —
    # a rank that dies on this timeout still leaves the evidence)
    arrived = [r for r in range(world)
               if os.path.exists(os.path.join(directory, f"{tag}.{r}"))]
    missing = [r for r in range(world) if r not in arrived]
    if not missing:
        # the last marker landed between the loop's final check and the
        # deadline: the barrier IS satisfied — raising with its own
        # evidence saying "missing []" would be a spurious failure
        flightrec.record(flightrec.EV_BARRIER_EXIT, note=tag)
        return
    flightrec.record(flightrec.EV_BARRIER_TIMEOUT,
                     note=f"{tag}: missing {missing}"[:200])
    raise TimeoutError(
        f"file_barrier {tag!r}: rank {rank} waited {timeout}s; "
        f"arrived {arrived}, missing {missing} of world {world}")
