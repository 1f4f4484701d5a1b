"""Command-line interfaces (counterpart of ``allophant_tpu/cli``): ``allophant``
(:mod:`allophant_tpu_torch.cli.run`: generate-config, predict, evaluate,
edits) and ``allophant-error-rates`` (:mod:`allophant_tpu_torch.cli.error_rates`)."""
