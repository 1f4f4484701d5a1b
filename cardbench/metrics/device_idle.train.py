"""1 - the union of device operations (kernels, copies, fills) over the wall
time of the traced stretch of one training update."""

LAYER = "device"
UNIT = "%"
MOVES = "train_device_ms_per_padded_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
