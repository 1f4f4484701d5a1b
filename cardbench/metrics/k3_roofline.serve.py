"""K3's share of its roofline in the traced stretch of beam requests: the
least time of each launch's work (``work/k3.py``) over K3's device time. A
request launches K3 once a class count, over the heads of that count
stacked along the rows."""

from cardbench.core import peaks
from cardbench.work import k3

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_audio_s_per_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["k3_s"] or not trace["beam_width"]:
        return None
    bound = 0.0
    for request in trace["requests"]:
        for classes, members in trace["heads_by_classes"].items():
            lengths = list(request["frames"]) * members
            bound += peaks.bound_s(*k3.launch_work(request["padded_frames"], int(classes), trace["beam_width"], lengths), "float32")
    return 100.0 * bound / trace["k3_s"]
