"""Real frames over the frames of the padded buckets the estimator ran, in
the untraced window. The padded frames are read off the time axis of each
returned grid or n-best, not from the program's bucketing."""

LAYER = "estimator"
UNIT = "%"
MOVES = "serve_audio_s_per_s"
SOURCE = "program_counter"


def read(readings):
    window = readings["window"]
    if not window.get("padded_frames"):
        return None
    return 100.0 * window["real_frames"] / window["padded_frames"]
