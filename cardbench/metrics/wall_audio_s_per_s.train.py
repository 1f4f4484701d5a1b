"""Real audio of every update the untraced window completed, over the time
to the end of the last: the training rate on the host's clock. The host sets
its pace (the update's remat dispatch and its synchronising reads), so it
swings with the load on the machine's cores; the device's time for the work is
the end-to-end ``train_device_ms_per_padded_s``."""

LAYER = "training loop"
UNIT = "audio-s/s"
MOVES = "train_device_ms_per_padded_s"
SOURCE = "host_clock"


def read(readings):
    window = readings["window"]
    if not window.get("wall_s") or not window.get("updates"):
        return None
    return window["audio_s"] / window["wall_s"]
