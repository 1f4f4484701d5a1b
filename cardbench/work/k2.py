"""K2, the fused frame encoder (``csrc/frame_encoder.cu``): the extractor's
first convolution, its layer norm and GELU in one launch a request or
microbatch. No work function yet: no metric reads K2's roofline."""

KERNEL = "K2"
COUNTER = ("allophant_tpu_torch.ops.frame_encoder", "fused_frame_conv")
TWINS = (("allophant_tpu_torch.ops.frame_encoder", "reference_frame_conv"),)
KERNEL_NAMES = ("frame_encoder_kernel", "frame_encoder_chunked_kernel")
