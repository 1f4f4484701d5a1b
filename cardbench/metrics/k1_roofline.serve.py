"""K1's share of its roofline in the traced stretch: the sum over its
launches of the least time their work needs (``work/k1.py``, bf16 at
989 TFLOP/s against 3.35 TB/s) over K1's device time. A request launches K1
once an encoder layer over [rows, padded frames, heads * head_dim]."""

from cardbench.core import peaks
from cardbench.work import k1

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_audio_s_per_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["k1_s"]:
        return None
    arch = readings["config"]["architecture"]
    heads = arch["num_attention_heads"]
    head_dim = arch["hidden_size"] // heads
    bound = 0.0
    for request in trace["requests"]:
        work = k1.launch_work(request["padded_frames"], heads, head_dim, request["frames"], 2)
        bound += trace["layers"] * peaks.bound_s(*work, "bfloat16")
    return 100.0 * bound / trace["k1_s"]
