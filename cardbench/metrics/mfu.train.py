"""The whole update's share of the card's peak: the model's products and
convolutions over the untraced window's updates (forward and backward, the frozen extractor forward only) (``work/model_flops.py``),
each type at its own peak (bf16 encoder at 989 TFLOP/s, the f32 head at the
preset's float32 rate), over the window's wall time."""

from cardbench.core import peaks

LAYER = "device, whole request or update"
UNIT = "%"
MOVES = "train_device_ms_per_padded_s"
SOURCE = "host_clock"


def read(readings):
    window = readings["window"]
    if not window.get("wall_s") or not window.get("flops"):
        return None
    ideal = sum(value / peaks.OPS_PER_S[dtype] for dtype, value in window["flops"].items())
    return 100.0 * ideal / window["wall_s"]
