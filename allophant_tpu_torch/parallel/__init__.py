"""Multi-device training and inference over ``torch.distributed`` (counterpart
of ``allophant_tpu/parallel/``): one process per device, a (data, model) grid
of ranks, Megatron-style tensor parallelism of the wav2vec2 encoder layers,
the transformer acoustic model's layers and the head's attention classifiers."""
