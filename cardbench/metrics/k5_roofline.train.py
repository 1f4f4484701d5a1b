"""K5's share of its roofline in the traced update: the least time of
each launch's work (``work/k5.py``, bf16 at 989 TFLOP/s against 3.35 TB/s) over
its device time. A microbatch launches it once an encoder layer over the
stacked group's [rows, frames, heads * head_dim]."""

from cardbench.core import peaks
from cardbench.work import k5

LAYER = "kernels"
UNIT = "%"
MOVES = "train_device_ms_per_padded_s"
SOURCE = "device_trace"


def read(readings):
    trace = readings.get("trace")
    if not trace or not trace["k5_s"]:
        return None
    arch = readings["config"]["architecture"]
    heads = arch["num_attention_heads"]
    head_dim = arch["hidden_size"] // heads
    bound = 0.0
    for microbatch in trace["microbatches"]:
        work = k5.launch_work(microbatch["padded_frames"], heads, head_dim, microbatch["frames"], 2)
        bound += trace["layers"] * peaks.bound_s(*work, "bfloat16")
    return 100.0 * bound / trace["k5_s"]
