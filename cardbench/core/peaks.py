"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W): HBM3 bandwidth, and arithmetic by the type the
operands are multiplied in. A card set below 700 W reaches less; the run
prints the card's power limit beside every number."""

BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bfloat16": 989e12,  # tensor cores
    "tf32": 495e12,  # float32 products with TF32 on
    "float32": 67e12,  # float32 products with TF32 off (CUDA cores)
}


def bound_s(bytes_moved: float, operations: float, dtype: str) -> float:
    """Least seconds for the work: the larger of bytes over the memory rate
    and operations over the type's peak."""
    return max(bytes_moved / BYTES_PER_S, operations / OPS_PER_S[dtype])
