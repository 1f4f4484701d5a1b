"""Device milliseconds of the kernels launched inside the benchmark's
decode range of the traced stretch, per real audio second served in it.
The range runs from the end of the head's forward to the end of the request's launch: the f32 log_softmax, the greedy grid or K3 and the backtrace."""

LAYER = "decoding"
UNIT = "ms/audio-s"
MOVES = "serve_audio_s_per_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["audio_s"] or not trace["decode_s"]:
        return None
    return 1e3 * trace["decode_s"] / trace["audio_s"]
