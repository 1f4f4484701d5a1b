"""Command-line interfaces (counterpart of ``allophant_tpu/cli``): ``allophant``
(:mod:`allophant_tpu_torch.cli.run`: train, generate-config, predict,
evaluate, edits), ``allophant-data`` (:mod:`allophant_tpu_torch.cli.data`:
transcribe, download-meta, save-lengths, preprocess, stats),
``allophant-features`` (:mod:`allophant_tpu_torch.cli.features`) and
``allophant-error-rates`` (:mod:`allophant_tpu_torch.cli.error_rates`)."""
