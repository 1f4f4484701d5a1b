"""K7's share of its roofline in the traced stretch: the sum over its
launches of the least time their work needs (``work/k7.py``, bf16 at
989 TFLOP/s against 3.35 TB/s) over K7's device time. A w2v-BERT request
launches K7 once an encoder layer over [rows, padded frames, heads *
head_dim]. Nothing to read where K7 did not run (or the program has none)."""

from cardbench.core import peaks
from cardbench.work import k7

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_audio_s_per_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    seconds = (trace or {}).get("kernel_s", {}).get("K7")
    if not seconds:
        return None
    arch = readings["config"]["architecture"]
    heads = arch["num_attention_heads"]
    head_dim = arch["hidden_size"] // heads
    positions = arch["left_max_position_embeddings"] + arch["right_max_position_embeddings"] + 1
    bound = 0.0
    for request in trace["requests"]:
        work = k7.launch_work(request["padded_frames"], heads, head_dim, positions, request["frames"], 2)
        bound += trace["layers"] * peaks.bound_s(*work, "bfloat16")
    return 100.0 * bound / seconds
