"""The 95th percentile of the latency of every request of the untraced
window, launch to decoded output on the host. A closed loop keeps the card
at capacity, where a tail swings with the smallest change of the host's
pace, so it is read here and not bounded end to end."""

LAYER = "estimator"
UNIT = "ms"
MOVES = "serve_audio_s_per_s"
SOURCE = "host_clock"


def read(readings):
    return readings["window"].get("p95_ms")
