"""The device idle between segments, waiting for the host to launch the
next one (the loss read included), in % of the sampled calls' time in
the untraced window (``harness/recorder.py``). Within a call the host
enqueues ahead of the device, so the gaps between its replays count as
the replays' own (``segment.device_ms_per_replay``)."""
from port_bench.harness.recorder import launch_gap_share, snapshot


def read(ctx):
    return launch_gap_share(snapshot())
