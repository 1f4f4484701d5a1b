"""Real frames over the frames of the stacked groups the training step ran,
in the untraced window."""

LAYER = "training loop"
UNIT = "%"
MOVES = "train_device_ms_per_padded_s"
SOURCE = "program_counter"


def read(readings):
    window = readings["window"]
    if not window.get("padded_frames"):
        return None
    return 100.0 * window["real_frames"] / window["padded_frames"]
