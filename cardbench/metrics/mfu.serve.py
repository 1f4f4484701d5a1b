"""The whole request's share of the card's peak: the model's products and
convolutions over the untraced window's requests (``work/model_flops.py``),
each type at its own peak (bf16 encoder at 989 TFLOP/s, the f32 head at the
preset's float32 rate), over the window's wall time."""

from cardbench.core import peaks

LAYER = "device, whole request or update"
UNIT = "%"
MOVES = "serve_audio_s_per_s"
SOURCE = "host_clock"


def read(readings):
    window = readings["window"]
    if not window.get("wall_s") or not window.get("flops"):
        return None
    ideal = sum(value / peaks.OPS_PER_S[dtype] for dtype, value in window["flops"].items())
    return 100.0 * ideal / window["wall_s"]
