"""Multi-device training and inference over ``torch.distributed`` (counterpart
of ``allophant_tpu/parallel/``): one process per device, a (data, model) grid
of ranks, Megatron-style tensor parallelism of the wav2vec2 encoder layers."""
