"""Device milliseconds of the kernels launched inside the benchmark's
encoder range of the traced stretch, per real audio second served in it.
The range is a forward hook on the port's acoustic model (extractor, K2, positional conv, encoder layers with K1)."""

LAYER = "encoder"
UNIT = "ms/audio-s"
MOVES = "serve_audio_s_per_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["audio_s"] or not trace["encoder_s"]:
        return None
    return 1e3 * trace["encoder_s"] / trace["audio_s"]
