"""Host milliseconds an update spends in the benchmark's call into
``stack_microbatches`` and the copy of the stacked group to the device, over
the untraced window's updates."""

LAYER = "training loop"
UNIT = "ms"
MOVES = "train_device_ms_per_padded_s"
SOURCE = "host_clock"


def read(readings):
    window = readings["window"]
    if not window.get("updates"):
        return None
    return 1e3 * window["host_s"] / window["updates"]
