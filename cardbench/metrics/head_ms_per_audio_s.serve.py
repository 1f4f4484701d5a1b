"""Device milliseconds of the kernels launched inside the benchmark's
head range of the traced stretch, per real audio second served in it.
The range is a forward hook on the port's projection head."""

LAYER = "head"
UNIT = "ms/audio-s"
MOVES = "serve_audio_s_per_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["audio_s"] or not trace["head_s"]:
        return None
    return 1e3 * trace["head_s"] / trace["audio_s"]
