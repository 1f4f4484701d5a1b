"""The beam backtrace (``csrc/beam_search.cu:beam_backtrace_kernel``): one
launch after each K3 launch, reading the parents and emitted tokens back
into each beam's sequence. No work function: no metric reads its roofline."""

KERNEL = "backtrace"
COUNTER = ("allophant_tpu_torch.ops.beam_kernel", "backtrace_cuda")
TWINS = (("allophant_tpu_torch.ops.decode", "backtrace_beams_device"),)
KERNEL_NAMES = ("beam_backtrace_kernel",)
