"""``allophant`` CLI of the port (counterpart of ``allophant_tpu/cli/run.py``):
train, generate-config, predict, evaluate, edits and export, with the JAX
CLI's flags.

    python -m allophant_tpu_torch.cli.run train CORPUS -a table.csv -c config.toml -d -s checkpoints/
    python -m allophant_tpu_torch.cli.run predict CORPUS CHECKPOINT -o predictions.jsonl
    python -m allophant_tpu_torch.cli.run evaluate predictions.jsonl -j
    python -m allophant_tpu_torch.cli.run export CHECKPOINT transcriber.pt2 -s 8 -d 10 --decode beam4

Training, inference and the device scorer run on the GPU; ``--cpu`` runs
them on the CPU instead (the plain PyTorch path), as the JAX CLI's ``--cpu``
selects its CPU backend. ``export`` writes an artifact bound to one device:
its ``--platforms`` takes one entry, ``cuda`` or ``cpu`` (``--cpu`` is
``--platforms cpu``), where JAX's lowers for a list of platforms.

``train`` trains data-parallel over every visible GPU, as the JAX CLI trains
over every visible chip: started by ``torchrun`` it joins the process group
of its environment (one process a GPU; with ``--cpu``, gloo processes on the
CPU); started plainly with more than one visible GPU it starts one process a
GPU itself and forwards SIGTERM and SIGINT to them. ``CUDA_VISIBLE_DEVICES``
chooses the GPUs."""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import sys
import time
import tomllib
from argparse import ArgumentParser, FileType, Namespace
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

MAIN_LOGGER = logging.getLogger("allophant_tpu_torch")

BEST_CHECKPOINT = "best.ckpt"
# Written on graceful preemption (SIGTERM/SIGINT during training): the full
# resumable state at the interrupted step, independent of the best model.
INTERRUPTED_CHECKPOINT = "interrupted.ckpt"


class TrainingLanguageMode(Enum):
    INCLUDE = "include"
    EXCLUDE = "exclude"
    ONLY = "only"


def _device(arguments: Namespace) -> Optional[str]:
    """The device of a subcommand: the CPU with ``--cpu``, else the GPU."""
    return "cpu" if getattr(arguments, "cpu", False) else None


def _load_config_file(config_path: Optional[str], json_data: Optional[str]):
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.package_data import DEFAULT_CONFIG_PATH

    if json_data is not None:
        return Config.load(json.loads(json_data))
    if config_path is None:
        return Config.from_toml(DEFAULT_CONFIG_PATH)
    with open(config_path, "rb") as file:
        return Config.load(tomllib.load(file))


# ---------------------------------------------------------------------------
# generate-config
# ---------------------------------------------------------------------------


def generate_config(arguments: Namespace) -> None:
    """Writes the commented default config template (to stdout without a path)."""
    from allophant_tpu_torch.package_data import DEFAULT_CONFIG_PATH

    if arguments.config_path is None:
        with open(DEFAULT_CONFIG_PATH, "r", encoding="utf-8") as file:
            sys.stdout.write(file.read())
    else:
        shutil.copyfile(DEFAULT_CONFIG_PATH, arguments.config_path)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _checkpoint_name(epoch: int) -> str:
    return f"epoch-{epoch}.ckpt"


def _interrupted_checkpoint_path(save_path: str) -> str:
    """Sibling path the preemption checkpoint is written to: `interrupted.ckpt`
    inside a --save-all directory, `<file>.interrupted` next to a single file."""
    if os.path.isdir(save_path):
        return os.path.join(save_path, INTERRUPTED_CHECKPOINT)
    return save_path + ".interrupted"


def _prefer_interrupted_checkpoint(candidate: str, save_path: str) -> str:
    """Resumes from the preemption checkpoint when it is the newest state.

    A later regular save (new best model / epoch checkpoint) supersedes an
    older interrupted file, so the choice is by modification time."""
    interrupted = _interrupted_checkpoint_path(save_path)
    if not os.path.exists(interrupted):
        return candidate
    if not os.path.exists(candidate):
        return interrupted
    return interrupted if os.path.getmtime(interrupted) >= os.path.getmtime(candidate) else candidate


def _restore_candidate(save_path: str) -> str:
    """What ``train --restore`` resumes from: ``best.ckpt`` in a save
    directory, else the file itself, or the preemption checkpoint when it is
    newer. A save directory that is an Orbax checkpoint is itself the
    checkpoint until a run has saved one of those two into it."""
    from allophant_tpu_torch.training.checkpoint import is_orbax_directory

    candidate = os.path.join(save_path, BEST_CHECKPOINT) if os.path.isdir(save_path) else save_path
    candidate = _prefer_interrupted_checkpoint(candidate, save_path)
    if not os.path.exists(candidate) and is_orbax_directory(save_path):
        return save_path
    return candidate


def train(arguments: Namespace, args: Sequence[str]) -> None:
    """``train`` on one device, or data-parallel over several: in the process
    group of a ``torchrun`` environment, or over every visible GPU in one
    spawned process each (``args`` are the command line, parsed again in
    each)."""
    from allophant_tpu_torch.parallel import mesh as mesh_module

    if mesh_module.torchrun_environment():
        import torch.distributed as dist

        device = mesh_module.rank_device(_device(arguments))
        mesh_module.initialize(device)
        try:
            train_network(arguments, mesh_module.create_mesh(), device)
        finally:
            dist.destroy_process_group()
        return
    if not arguments.cpu:
        import torch

        count = torch.cuda.device_count()
        if count > 1:
            train_on_devices(args, [f"cuda:{index}" for index in range(count)])
            return
    train_network(arguments)


def _train_rank(_rank: int, _world_size: int, device, args: Sequence[str]) -> None:
    """One spawned rank of ``train_on_devices``."""
    from allophant_tpu_torch.parallel.mesh import create_mesh

    arguments = make_parser().parse_args(args)
    if arguments.detect_anomaly:
        import torch

        torch.autograd.set_detect_anomaly(True)
    train_network(arguments, create_mesh(), device)


def train_on_devices(args: Sequence[str], devices: Sequence[str]) -> None:
    """Trains data-parallel in one spawned process for each of ``devices``
    (``parallel.launch.spawn``), the command line ``args`` parsed in each;
    SIGTERM and SIGINT sent to this process reach every rank. The kernels are
    built here first, so that the ranks find them built."""
    import tempfile

    import torch

    from allophant_tpu_torch.parallel import launch

    if any(torch.device(device).type == "cuda" for device in devices):
        from allophant_tpu_torch.kernels.build import build_all

        build_all()
    with tempfile.TemporaryDirectory() as workdir:
        launch.spawn(_train_rank, workdir, devices, (list(args),), forward_signals=True)


def train_network(arguments: Namespace, mesh=None, device=None) -> None:
    """Runs the training loop: restore or build, iterate ``Estimator.train``,
    checkpoint on improvement, and on SIGTERM or SIGINT stop after the
    in-flight step and write the interrupted checkpoint. Over a ``mesh`` (this
    process's rank on ``device``) every rank runs it; the first rank prints
    and writes the checkpoints."""
    from allophant_tpu_torch.data import corpus_loading
    from allophant_tpu_torch.device import resolve_device
    from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
    from allophant_tpu_torch.training import checkpoint as checkpoint_module
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.run import DatasetManager, TrainingStatus

    # Raises now, before the corpus is read, when there is no card and no --cpu.
    device = resolve_device(_device(arguments) if device is None else device)
    first = mesh is None or mesh.index == 0
    if arguments.save_path is not None and not arguments.save_all and checkpoint_module.is_orbax_directory(arguments.save_path):
        # The best model would be saved as one file in place of the directory.
        raise ValueError(
            f"{arguments.save_path} is an Orbax checkpoint directory: train into it with --save-all, which writes "
            f"{BEST_CHECKPOINT} and the epoch checkpoints beside it"
        )
    restore_path = arguments.save_path if arguments.restore else None
    checkpoint = None
    if restore_path is not None:
        candidate = _restore_candidate(restore_path)
        MAIN_LOGGER.info("Restoring from %s", candidate)
        checkpoint = checkpoint_module.load_checkpoint(candidate)
        if arguments.config is not None or arguments.config_json_data is not None:
            # An explicit config on resume overrides the checkpoint's own (e.g.
            # to extend maximum_iterations); the architecture must stay
            # compatible with the stored parameters.
            checkpoint.config = _load_config_file(arguments.config, arguments.config_json_data)
        config = checkpoint.config
    else:
        config = _load_config_file(arguments.config, arguments.config_json_data)

    corpus = corpus_loading.load_corpus(
        arguments.dataset_path,
        arguments.dataset_type,
        config.preprocessing.resample,
        config.data.languages,
        config.data.validation_limits,
        config.data.only_primary_script,
        first and not arguments.no_progress,
    )

    train_features = validation_features = None
    train_lengths = validation_lengths = None
    if arguments.features is not None or arguments.lengths is not None:
        languages = {"train": corpus.train.languages, "dev": corpus.dev.languages}
        processed = corpus_loading.preprocessed_features_or_lengths(
            arguments.features or arguments.lengths, languages, lengths_only=arguments.features is None
        )
        train_lengths = processed["train"].lengths
        validation_lengths = processed["dev"].lengths
        if arguments.features is not None:
            train_features = processed["train"].features
            validation_features = processed["dev"].features

    if arguments.no_validation:
        corpus.dev = corpus.dev.__class__.empty()

    # Training rematerialises the encoder layers, as the JAX CLI does, at the
    # config's precision: bf16 matmuls with an f32 loss tail when mixed
    # precision is on, full float32 when off.
    precision = "mixed" if config.nn.mixed_precision else "float32"
    if checkpoint is not None:
        estimator, attribute_indexer = Estimator.restore(
            checkpoint, remat=True, precision=precision, device=device, mesh=mesh
        )
    else:
        attribute_table = arguments.attribute_path.read() if arguments.attribute_path else None
        attribute_indexer = PhoneticAttributeIndexer.from_config(
            config, attribute_table, corpus.train.language_id_inventories()
        )
        if arguments.save_all and arguments.save_path is not None:
            os.makedirs(arguments.save_path, exist_ok=True)
        estimator = None

    manager = DatasetManager.from_config(
        config,
        corpus,
        attribute_indexer,
        config.preprocessing.resample or 16_000,
        train_features,
        validation_features,
        train_lengths,
        validation_lengths,
        data_workers=arguments.data_workers,
    )
    if estimator is None:
        estimator = Estimator.from_config(
            config,
            manager.feature_size,
            config.preprocessing.resample or 16_000,
            manager.attribute_graph(),
            attribute_indexer,
            precision=precision,
            device=device,
            remat=True,
            mesh=mesh,
        )

    tensorboard_directory = arguments.tensorboard_directory
    if tensorboard_directory == "":
        tensorboard_directory = os.path.join("runs", "allophant")
    if not first:
        tensorboard_directory = None

    skip_batches = arguments.skip_batches
    if skip_batches < 0:
        # Auto-resume: skip the batches the checkpoint's current epoch already
        # consumed (recorded at every validation point).
        skip_batches = int(estimator.epoch.step or 0) if arguments.restore else 0

    run = estimator.train(manager, tensorboard_directory, skip_batches=skip_batches, show_progress=first and not arguments.no_progress)

    # Graceful preemption: SIGTERM/SIGINT ask the loop to stop at the next step
    # boundary, after which the INTERRUPTED branch below checkpoints the full
    # resumable state. A second signal restores the default handler, so it
    # kills the process the usual way if the final step or save hangs.
    original_handlers = {}

    def _graceful_stop(signum, frame):
        run.request_stop()
        signal.signal(signum, original_handlers[signum])
        MAIN_LOGGER.warning(
            "Received %s: stopping after the in-flight step and checkpointing (send again to force exit)",
            signal.Signals(signum).name,
        )

    for signum in (signal.SIGTERM, signal.SIGINT):
        original_handlers[signum] = signal.signal(signum, _graceful_stop)
    try:
        for status, statistics in run:
            if first:
                MAIN_LOGGER.info("%s", statistics)
                if not arguments.no_progress:
                    print(statistics, flush=True)
            if arguments.save_path is not None and status not in (
                TrainingStatus.FINISHED,
                TrainingStatus.EARLY_STOPPED,
            ):
                indexer_state = manager.processor.indexer_state()
                training_state = run.serialized_training_state()
                if status == TrainingStatus.INTERRUPTED:
                    interrupted_path = _interrupted_checkpoint_path(arguments.save_path)
                    estimator.save(interrupted_path, optimizer_state=training_state, phonetic_indexer_state=indexer_state)
                    if first:
                        print(f"Training interrupted; state saved to {interrupted_path}", flush=True)
                elif arguments.save_all:
                    epoch_path = os.path.join(arguments.save_path, _checkpoint_name(statistics.epoch))
                    estimator.save(epoch_path, optimizer_state=training_state, phonetic_indexer_state=indexer_state)
                    if status == TrainingStatus.IMPROVED and first:
                        shutil.copy2(epoch_path, os.path.join(arguments.save_path, BEST_CHECKPOINT))
                elif status == TrainingStatus.IMPROVED:
                    estimator.save(
                        arguments.save_path, optimizer_state=training_state, phonetic_indexer_state=indexer_state
                    )
            if status == TrainingStatus.EARLY_STOPPED and not arguments.no_progress and first:
                print("Training stopped early", flush=True)
    finally:
        for signum, handler in original_handlers.items():
            # Leave the default handler in place if the first signal already
            # restored it mid-loop.
            if signal.getsignal(signum) is _graceful_stop:
                signal.signal(signum, handler)


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------


def _dataset_from_data(data, config, indexer):
    from allophant_tpu_torch.data.dataset import (
        BatchType,
        PhoneticallySegmentedDataset,
        SamplesProcessor,
        TranscribedDataset,
    )

    processor = SamplesProcessor.from_config(
        config, data.audio_info.sample_rate or config.preprocessing.resample or 16_000, indexer
    )
    if data.UTTERANCE_TYPE == "phonetically-segmented":
        return PhoneticallySegmentedDataset(BatchType.RAW, data, processor)
    return TranscribedDataset(BatchType.RAW, data, processor)


def _filter_split_raw_batches_by_language(batch_generator, data, excluded_languages: Set[str]):
    for original_batch in batch_generator:
        for language_id, batch in original_batch.split_by_language():
            language_code = data.language(language_id)
            if language_code in excluded_languages:
                continue
            yield batch, [language_code] * len(batch)


def predict(arguments: Namespace) -> None:
    """Batch inference of a corpus into a JSONL predictions file."""
    from allophant_tpu_torch import predictions
    from allophant_tpu_torch.config import BatchingMode, PhonemeLayerType, ProjectionEntryConfig
    from allophant_tpu_torch.data import corpus_loading
    from allophant_tpu_torch.data.batching import Batcher
    from allophant_tpu_torch.evaluation_runner import _fix_inventories, _missing_mappings
    from allophant_tpu_torch.ops.decode import DeviceBeamCTCDecoder, GreedyCTCDecoder
    from allophant_tpu_torch.phonetics import language_codes
    from allophant_tpu_torch.predictions import FeatureDecoder, JsonlWriter, PredictionMetaData, UtterancePrediction
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.utils import progress_bar

    n_candidates = arguments.n_best
    if n_candidates > arguments.ctc_beam:
        raise ValueError(f"n_best {n_candidates} larger than the beam size {arguments.ctc_beam}")

    # --precision picks a serving preset; --bf16 is the legacy spelling of
    # --precision bfloat16. Default (None) = DEFAULT_SERVING_PRECISION.
    precision = arguments.precision
    if arguments.bf16:
        precision = "bfloat16"
    device = _device(arguments)
    inference_estimator, attribute_indexer = Estimator.restore(arguments.model_path, precision=precision, device=device)
    config = inference_estimator.config

    is_allophone_model = config.nn.projection.phoneme_layer == PhonemeLayerType.ALLOPHONES
    if arguments.language_phonemes and not is_allophone_model:
        raise ValueError(
            "--language-phonemes can only be used with models that use an allophone layer."
            f" The restored checkpoint layer type is {config.nn.projection.phoneme_layer}"
        )

    feature_names = list(attribute_indexer.feature_names)
    is_composition_model = config.nn.projection.embedding_composition is not None

    map_allophones = False
    composition_output_name = ProjectionEntryConfig.PHONEME_LAYER
    phone_indexer = None
    if is_allophone_model:
        if attribute_indexer.allophone_data is None:
            raise ValueError("Allophone data is missing from the attribute indexer")
        phone_indexer = attribute_indexer.allophone_data.shared_phone_indexer
        feature_names.append(ProjectionEntryConfig.PHONE)
        composition_output_name = ProjectionEntryConfig.PHONE
        if arguments.language_phonemes:
            map_allophones = True
        else:
            feature_names.remove(ProjectionEntryConfig.PHONEME_LAYER)

    if arguments.feature_subset is not None:
        if not set(arguments.feature_subset).issubset(set(feature_names)):
            raise ValueError(
                f"The provided feature subset {sorted(arguments.feature_subset)} "
                f"is not a subset of {sorted(feature_names)}"
            )
        feature_names = arguments.feature_subset

    MAIN_LOGGER.info("Predicting with attributes: %s", feature_names)

    batching_mode = config.nn.batching_mode if arguments.batch_mode is None else BatchingMode(arguments.batch_mode)
    batch_size = arguments.batch_size
    if batch_size is None:
        batch_size = max(config.nn.batch_size // max(config.nn.accumulation_factor, 1), 1)
    batcher = Batcher(batch_size, batching_mode, data_workers=arguments.data_workers)

    mode = TrainingLanguageMode(arguments.training_languages)
    corpus_languages = config.data.languages if mode == TrainingLanguageMode.ONLY else None
    exclude_known = mode == TrainingLanguageMode.EXCLUDE

    test_data = corpus_loading.load_corpus(
        arguments.dataset_path,
        arguments.dataset_type,
        config.preprocessing.resample,
        corpus_languages,
        only_primary_script=config.data.only_primary_script,
        progress_bar=not arguments.no_progress,
    ).test

    test_languages = list(test_data.languages)
    excluded_languages: Set[str] = set()
    if exclude_known:
        known = {language_codes.standardize_to_iso6393(code) for code in config.data.languages}
        kept = []
        for language in test_languages:
            if language in known:
                excluded_languages.add(language)
            else:
                kept.append(language)
        test_languages = kept
        MAIN_LOGGER.info("Excluding languages: %s", excluded_languages)

    if batching_mode == BatchingMode.FRAMES or arguments.lengths is not None:
        if arguments.lengths is not None:
            test_data_lengths = corpus_loading.preprocessed_features_or_lengths(
                arguments.lengths, {"test": test_data.languages}
            )["test"].lengths
        else:
            test_data_lengths = _corpus_lengths(test_data)
    else:
        test_data_lengths = None

    dataset = _dataset_from_data(test_data, config, attribute_indexer)
    model_output_start_offset = config.nn.loss.BLANK_OFFSET

    ctc_decoders = predictions.feature_decoders(attribute_indexer, arguments.ctc_beam, feature_names, n_candidates, device)

    per_language_decoders = None
    # The allophone map takes the phone head's log-probs over the training
    # phones, so with --language-phonemes the phone head keeps them and is not
    # recomposed over each language's inventory. (The JAX CLI recomposes it
    # and the map then gathers phone classes the recomposed head does not
    # have.)
    if is_composition_model and not map_allophones:
        attributes = attribute_indexer.composition_features
        language_inventories = {language: test_data.inventory(language) for language in test_languages}
        if arguments.fix_unicode:
            language_inventories = _fix_inventories(
                language_inventories, _missing_mappings(attribute_indexer, language_inventories)
            )
        per_language_decoders = {
            language: FeatureDecoder(
                attribute_indexer.full_attributes.subset(inventory, attributes),
                arguments.ctc_beam,
                n_candidates,
                device,
            )
            for language, inventory in language_inventories.items()
        }

    batch_generator = batcher.batches(dataset, test_data_lengths)
    if per_language_decoders is not None or excluded_languages:
        batch_generator = _filter_split_raw_batches_by_language(batch_generator, test_data, excluded_languages)
    else:
        batch_generator = (
            (batch, [test_data.language(int(language_id)) for language_id in batch.language_ids])
            for batch in batch_generator
        )

    ipa_layers = {ProjectionEntryConfig.PHONEME_LAYER, ProjectionEntryConfig.PHONE}
    with JsonlWriter(
        arguments.output,
        PredictionMetaData(
            str(vars(arguments)),
            arguments.dataset_type,
            test_languages,
            config.nn.projection.feature_set,
            attribute_indexer.state(),
            feature_names,
            {language: test_data.inventory(language) for language in test_languages},
        ),
        use_gzip=arguments.compress,
    ) as writer:
        progress = progress_bar(enabled=not arguments.no_progress, desc="predict", unit="utt")

        def launch(batch, language_batch):
            """Device work only: the forward and every head's decode are queued
            without synchronising with the device. Copying to the host and
            writing the JSONL happen in ``finish``, one batch later, so the
            device computes batch i+1 while the host drains and writes batch i.

            When every head decodes greedily (beam width 1), the fused path
            ``predict_decoded`` returns one packed grid of all heads; when
            every head runs the same beam, ``predict_beam_decoded`` does the
            same for the beam search and its backtrace."""
            language_decoder = None
            feature_matrix = None
            if per_language_decoders is not None:
                language_decoder = per_language_decoders[language_batch[0]]
                ctc_decoders[composition_output_name] = language_decoder.decoder
                feature_matrix = language_decoder.feature_matrix

            decoders_snapshot = dict(ctc_decoders)
            if all(isinstance(decoder, GreedyCTCDecoder) for decoder in decoders_snapshot.values()):
                heads = tuple(sorted(decoders_snapshot))
                grid, _lengths = inference_estimator.predict_decoded(
                    batch, feature_matrix, heads=heads, map_allophones=map_allophones
                )
                return batch, language_batch, language_decoder, heads, ("fused", grid)

            beam_widths = {
                decoder._beam_width
                for decoder in decoders_snapshot.values()
                if isinstance(decoder, DeviceBeamCTCDecoder)
            }
            if len(beam_widths) == 1 and all(
                isinstance(decoder, DeviceBeamCTCDecoder) for decoder in decoders_snapshot.values()
            ):
                heads = tuple(sorted(decoders_snapshot))
                fused = inference_estimator.predict_beam_decoded(
                    batch, feature_matrix, heads=heads, beam_width=beam_widths.pop(), map_allophones=map_allophones
                )
                return batch, language_batch, language_decoder, (heads, decoders_snapshot), ("fused_beam", *fused)

            model_outputs = inference_estimator.predict(batch, feature_matrix, time_major=False)
            # Outputs stay on the device in batch-first layout, which the
            # decoders take as they are.
            outputs = dict(model_outputs.outputs)
            if map_allophones:
                outputs[ProjectionEntryConfig.PHONEME_LAYER] = inference_estimator.map_allophones(
                    outputs[ProjectionEntryConfig.PHONE], batch.language_ids, time_major=False
                )
            batch_size_now = len(batch)
            output_lengths = model_outputs.lengths[:batch_size_now]
            dispatched = {
                name: decoder.dispatch(outputs[name][:batch_size_now], output_lengths)
                for name, decoder in decoders_snapshot.items()
            }
            return batch, language_batch, language_decoder, decoders_snapshot, dispatched

        def token_values(name, tokens, language_decoder):
            """Decoded token ids -> IPA or feature value strings: IPA layers
            offset by the blank, attribute layers by the model's output start
            offset."""
            if name in ipa_layers:
                indices = tokens - 1  # blank offset
                if language_decoder is not None:
                    return list(language_decoder.attributes.phoneme(indices))
                if name == ProjectionEntryConfig.PHONE:
                    return list(phone_indexer.phoneme(indices))
                return list(attribute_indexer.phoneme(indices))
            return attribute_indexer.feature_values(name, tokens - model_output_start_offset)

        def finish(state):
            batch, language_batch, language_decoder, decoders_now, dispatched = state
            batch_size_now = len(batch)
            prediction_batches: Dict[str, List[List[List[str]]]] = {}
            if isinstance(dispatched, tuple) and dispatched[0] == "fused":
                # Fused greedy path: one grid copy for every head.
                heads = decoders_now  # head names in grid order
                grid = dispatched[1].cpu().numpy()
                for head_index, name in enumerate(heads):
                    lane = grid[head_index]
                    counts = lane[:, 0]
                    tokens = lane[:, 1:]
                    prediction_batches[name] = [
                        [token_values(name, tokens[row, : counts[row]].astype(np.int64), language_decoder)]
                        for row in range(batch_size_now)
                    ]
            elif isinstance(dispatched, tuple) and dispatched[0] == "fused_beam":
                # Fused beam path: two copies (tokens, scores) for every head.
                heads, decoders_now = decoders_now
                collected = dispatched[1].cpu().numpy().astype(np.int64)
                scores = dispatched[2].cpu().numpy()
                greedy_collected: Dict[str, Any] = {}
                beam_collected = {
                    name: decoders_now[name]._assemble(collected[head_index], scores[head_index])
                    for head_index, name in enumerate(heads)
                }
            else:
                # Mixed greedy and beam heads: the greedy heads drain together
                # through one packed copy, the beam heads through stacked grids.
                greedy_collected = GreedyCTCDecoder.collect_many(
                    {
                        name: dispatched[name]
                        for name, decoder in decoders_now.items()
                        if isinstance(decoder, GreedyCTCDecoder)
                    },
                    # JSONL records carry no timesteps.
                    with_timesteps=False,
                )
                beam_decoders = {
                    name: decoder
                    for name, decoder in decoders_now.items()
                    if isinstance(decoder, DeviceBeamCTCDecoder)
                }
                beam_collected = DeviceBeamCTCDecoder.collect_many(
                    {name: dispatched[name] for name in beam_decoders}, beam_decoders
                )
            if not prediction_batches:
                for name, decoder in decoders_now.items():
                    if name in greedy_collected:
                        beam_results = greedy_collected[name]
                    elif name in beam_collected:
                        beam_results = beam_collected[name]
                    else:
                        beam_results = decoder.collect(dispatched[name])
                    prediction_batch = []
                    for result in range(len(beam_results)):
                        candidates = []
                        for beam_index in range(min(n_candidates, len(beam_results[result]))):
                            tokens = np.asarray(beam_results[result][beam_index].tokens, dtype=np.int64)
                            candidates.append(token_values(name, tokens, language_decoder))
                        prediction_batch.append(candidates)
                    prediction_batches[name] = prediction_batch

            label_batches = batch.raw_labels
            for index in range(batch_size_now):
                labels = [engine_labels[index] for engine_labels in label_batches]
                writer.write(
                    UtterancePrediction(
                        language_batch[index],
                        batch.utterance_ids[index],
                        {name: rows[index] for name, rows in prediction_batches.items()},
                        labels,
                    )
                )
            progress.update(batch_size_now)

        # One-batch-deep pipeline: batch i+1's device work is queued before
        # batch i is drained and written. ALLOPHANT_PREDICT_TIMING=1 prints
        # each batch's wall time and audio seconds to stderr, in the JAX CLI's
        # format.
        timing = os.environ.get("ALLOPHANT_PREDICT_TIMING") == "1"
        last_mark = time.perf_counter()

        def mark(audio_seconds: float) -> None:
            nonlocal last_mark
            if not timing:
                return
            now = time.perf_counter()
            print(
                f"[predict-timing] batch {audio_seconds:.1f} audio-s in {now - last_mark:.3f}s",
                file=sys.stderr,
                flush=True,
            )
            last_mark = now

        pending = None
        pending_audio = 0.0
        for batch, language_batch in batch_generator:
            state = launch(batch, language_batch)
            if pending is not None:
                finish(pending)
                mark(pending_audio)
            pending = state
            pending_audio = float(np.asarray(batch.lengths).sum()) / (config.preprocessing.resample or 16_000)
        if pending is not None:
            finish(pending)
            mark(pending_audio)
        progress.close()


def _corpus_lengths(corpus) -> Optional[np.ndarray]:
    reader = getattr(corpus, "read_lengths", None)
    if reader is None:
        return None
    lengths: List[int] = []
    for _language, generator in reader():
        lengths.extend(generator)
    return np.asarray(lengths, dtype=np.int64)


# ---------------------------------------------------------------------------
# evaluate / edits
# ---------------------------------------------------------------------------


def evaluate(arguments: Namespace) -> None:
    """Prediction file -> per-language, per-classifier error rates."""
    from allophant_tpu_torch.evaluation_runner import compute_edit_statistics, summarize_edit_statistics
    from allophant_tpu_torch.predictions import PredictionReader

    with PredictionReader(arguments.prediction_path, arguments.decompress) as reader:
        statistics = compute_edit_statistics(
            reader,
            map_phonemes=not arguments.no_remap,
            fix_unicode=arguments.fix_unicode,
            split_complex=arguments.split_complex,
            scorer="host" if arguments.host_scorer else "device",
            show_progress=not arguments.no_progress,
            device=_device(arguments),
        )
        results = summarize_edit_statistics(statistics, reader.metadata.classifiers, str(vars(arguments)))

    if arguments.output is not None:
        with arguments.output as file:
            if arguments.json:
                file.write(results.dumps())
            else:
                file.write(str(results))
    elif arguments.json:
        print(results.dumps())
    else:
        print(results)


def edits(arguments: Namespace) -> None:
    """Prediction file -> per-utterance alignment operations."""
    from allophant_tpu_torch.evaluation_runner import compute_edits
    from allophant_tpu_torch.predictions import JsonlWriter, PredictionReader

    with PredictionReader(arguments.prediction_path, arguments.decompress) as reader:
        with JsonlWriter(arguments.output, reader.metadata, use_gzip=arguments.compress) as writer:
            for utterance_edits in compute_edits(
                reader,
                map_phonemes=not arguments.no_remap,
                fix_unicode=arguments.fix_unicode,
                split_complex=arguments.split_complex,
            ):
                writer.write(utterance_edits)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


def make_parser() -> ArgumentParser:
    from allophant_tpu_torch.training.checkpoint import VERSION

    needs_config_parser = ArgumentParser(add_help=False)
    needs_config_parser.add_argument(
        "-c", "--config", default=None,
        help="Path to a configuration file in toml format (generate one with generate-config)",
    )
    needs_config_parser.add_argument(
        "-j", "--config-json-data", default=None, help="Inline JSON configuration overriding -c/--config"
    )

    progress_parser = ArgumentParser(add_help=False)
    progress_parser.add_argument("--no-progress", action="store_true", help="Disables progress printing")

    fix_inventory_parser = ArgumentParser(add_help=False)
    fix_inventory_parser.add_argument(
        "--fix-unicode", action="store_true",
        help="Attempts resolving phonemes by performing unicode normalization",
    )

    cpu_parser = ArgumentParser(add_help=False)
    cpu_parser.add_argument(
        "--cpu", action="store_true", help="Runs on the CPU (the plain PyTorch path) instead of the GPU"
    )

    dataset_processing_parser = ArgumentParser(add_help=False, parents=[cpu_parser])
    dataset_processing_parser.add_argument(
        "dataset_path", help="Path to a corpus containing phonetically transcribed utterances"
    )
    dataset_processing_parser.add_argument(
        "-w", "--data-workers", type=int, default=None,
        help="Batch-building worker processes (decoding, resampling, labels and padding"
        " outside the GIL, like the reference's DataLoader workers). Default: a single"
        " prefetch thread; 0 disables prefetching entirely",
    )

    parser = ArgumentParser(description="Trains and evaluates universal phoneme recognizer models")
    parser.add_argument("-v", "--version", action="version", version=f"%(prog)s {VERSION}")
    subparsers = parser.add_subparsers(dest="mode")
    subparsers.required = True

    train_parser = subparsers.add_parser(
        "train",
        parents=[needs_config_parser, dataset_processing_parser, progress_parser],
        help="Trains a universal phoneme recognizer model",
    )
    train_parser.add_argument(
        "-a", "--attribute-path", type=FileType("r", encoding="utf-8"), help="Path to a (processed) feature table"
    )
    train_parser.add_argument(
        "-t", "--dataset-type", choices=["common-voice"], default="common-voice", help="Type of the dataset"
    )
    train_parser.add_argument(
        "-s", "--save-path", help="Path the best model is saved to, or a checkpoint directory with --save-all"
    )
    train_parser.add_argument(
        "-r", "--restore", action="store_true",
        help="Restores the model from --save-path instead of initializing a new model",
    )
    train_parser.add_argument("-n", "--no-validation", action="store_true", help="Disables validation during training")
    train_parser.add_argument(
        "-d", "--save-all", action="store_true",
        help="Saves all checkpoints in a directory; the best is copied to best.ckpt",
    )
    train_parser.add_argument(
        "-b", "--tensorboard", nargs="?", const="", action="store", dest="tensorboard_directory",
        help="Enables tensorboard summary writing",
    )
    train_parser.add_argument(
        "--detect-anomaly", action="store_true",
        help="Enables autograd anomaly detection to trace NaNs during training",
    )
    train_parser.add_argument(
        "--skip-batches", type=int, default=-1,
        help="Batches of the current epoch to skip when resuming (-1 resumes from the checkpoint's"
        " recorded position with --restore; 0 disables)",
    )
    preprocessed_group = train_parser.add_mutually_exclusive_group()
    preprocessed_group.add_argument(
        "-f", "--features", help="Path to precomputed features generated via the data 'preprocess' command"
    )
    preprocessed_group.add_argument(
        "-l", "--lengths", help="Precomputed per-utterance feature lengths (data 'save-lengths' command)"
    )

    config_parser = subparsers.add_parser(
        "generate-config", help="Generates a configuration file from a default template"
    )
    config_parser.add_argument(
        "config_path", nargs="?", default=None, help="Path for the new config file (stdout if omitted)"
    )

    error_analysis_parser = ArgumentParser(add_help=False, parents=[cpu_parser])
    error_analysis_parser.add_argument(
        "prediction_path", help="Path to a file containing labeled predictions from `predict`"
    )
    error_analysis_parser.add_argument(
        "-d", "--decompress", default=None, action="store_true", help="Forces gzip decompression of the input"
    )
    error_analysis_parser.add_argument(
        "--no-remap", action="store_true",
        help="Disables train-to-target phoneme remapping before computing edit statistics",
    )
    error_analysis_parser.add_argument(
        "-s", "--split-complex", action="store_true",
        help="Splits complex segments in predictions and references before comparison",
    )
    error_analysis_parser.add_argument(
        "--host-scorer", action="store_true",
        help="Scores with the per-utterance native engine instead of the batched device DP",
    )

    evaluate_parser = subparsers.add_parser(
        "evaluate",
        help="Evaluates a predictions file",
        parents=[progress_parser, fix_inventory_parser, error_analysis_parser],
    )
    evaluate_parser.add_argument("-j", "--json", action="store_true", help="Outputs evaluation results in json format")
    evaluate_parser.add_argument(
        "-o", "--output", type=FileType("x", encoding="utf-8"), help="Writes evaluation outputs to the given file"
    )

    compressed_output_parser = ArgumentParser(add_help=False)
    compressed_output_parser.add_argument("-o", "--output", default=None, help="Writes output to the given file")
    compressed_output_parser.add_argument(
        "-c", "--compress", action="store_true", default=None, help="Uses gzip compression for outputs"
    )

    subparsers.add_parser(
        "edits",
        help="Computes the lowest cost Levenshtein edit operations for detailed analysis",
        parents=[progress_parser, fix_inventory_parser, error_analysis_parser, compressed_output_parser],
    )

    predict_parser = subparsers.add_parser(
        "predict",
        parents=[dataset_processing_parser, progress_parser, fix_inventory_parser, compressed_output_parser],
        help="Transcribes a corpus into a predictions file",
    )
    predict_parser.add_argument(
        "--training-languages",
        choices=[mode.value for mode in TrainingLanguageMode],
        default=TrainingLanguageMode.INCLUDE.value,
        help="Only evaluate on, include, or exclude languages the model was trained on",
    )
    predict_parser.add_argument("model_path", help="Model id or path to the model checkpoint for transcribing the data")
    predict_parser.add_argument(
        "-t", "--dataset-type", choices=["common-voice", "ucla-phonetic"],
        default="ucla-phonetic", help="Type of the evaluation dataset",
    )
    predict_parser.add_argument(
        "-l", "--lengths", help="Precomputed feature lengths (required for utterance batching only)"
    )
    predict_parser.add_argument("-s", "--batch-size", type=int, default=None, help="Batch size used for evaluation")
    predict_parser.add_argument(
        "-m", "--batch-mode", choices=["frames", "utterances"], default=None, help="Type of batching"
    )
    predict_parser.add_argument(
        "-f", "--feature-subset", type=lambda codes: codes.split(","),
        help="Comma separated subset of features (including phoneme) to evaluate on",
    )
    predict_parser.add_argument("-b", "--ctc-beam", type=int, default=1, help="Beam size used during beam decoding")
    predict_parser.add_argument(
        "-n", "--n-best", type=int, default=1, help="Uses the best result from the n highest scoring beams"
    )
    predict_parser.add_argument(
        "--language-phonemes", action="store_true", default=None,
        help="For allophone models, outputs language-specific phoneme classifiers",
    )
    predict_parser.add_argument(
        "--precision", choices=["float32", "float32_high", "mixed", "bfloat16"], default=None,
        help="Serving precision preset (default: 'mixed', a bf16 encoder with an f32 head)."
        " 'float32_high' allows TF32 on the GPU; 'float32' is full float32",
    )
    predict_parser.add_argument("--bf16", action="store_true", help="Legacy alias for --precision bfloat16")

    export_parser = subparsers.add_parser(
        "export",
        help="Exports the transcription step (weights included) as a torch.export artifact for serving"
        " hosts without the model code",
    )
    export_parser.add_argument("model_path", help="Model id or checkpoint path to export")
    export_parser.add_argument("output", help="Output artifact path")
    export_parser.add_argument("-s", "--batch-size", type=int, default=8, help="Static serving batch size")
    export_parser.add_argument(
        "-d", "--seconds", type=float, default=10.0, help="Static audio length per utterance in seconds (at 16 kHz)"
    )
    export_parser.add_argument(
        "--decode", default="greedy",
        help="'greedy' (on-device CTC tokens per head), 'log_probs' (per-head log-probs), or 'beam[width]'"
        " (greedy attributes + the beam search kernel on the phoneme track, e.g. 'beam4')",
    )
    export_parser.add_argument("--bf16", action="store_true", help="Export the bfloat16 compute path")
    export_parser.add_argument(
        "--platforms", type=lambda values: values.split(","), default=None,
        help="The artifact's device, one of 'cuda' (the default) or 'cpu': a torch artifact runs on one device",
    )
    export_parser.add_argument("--cpu", action="store_true", help="Exports for the CPU (the same as --platforms cpu)")
    return parser


EXPORT_PLATFORMS = ("cuda", "cpu")


def _export_device(arguments: Namespace) -> Optional[str]:
    """The device of ``export``: the CPU with ``--cpu``, else the one entry of
    ``--platforms`` (default: the card). Raises on anything else."""
    platforms = arguments.platforms
    if platforms is None:
        return "cpu" if arguments.cpu else None
    if len(platforms) != 1 or platforms[0] not in EXPORT_PLATFORMS:
        raise ValueError(
            f"--platforms takes one device, 'cuda' or 'cpu', not {','.join(platforms)!r}:"
            " a torch.export artifact is bound to the device it was exported on"
        )
    if arguments.cpu and platforms[0] != "cpu":
        raise ValueError("--cpu exports for the CPU; it contradicts --platforms cuda")
    return "cpu" if platforms[0] == "cpu" else None


def export_model(arguments: Namespace) -> None:
    from allophant_tpu_torch import serving
    from allophant_tpu_torch.training.estimator import Estimator

    device = _export_device(arguments)
    estimator, _indexer = Estimator.restore(
        arguments.model_path, precision="bfloat16" if arguments.bf16 else None, device=device
    )
    exported = serving.export_transcriber(
        estimator, arguments.batch_size, int(16_000 * arguments.seconds), decode=arguments.decode, device=device
    )
    serving.save_transcriber(exported, arguments.output)
    print(
        f"Exported {arguments.model_path} at batch {arguments.batch_size} x"
        f" {arguments.seconds:g}s ({arguments.decode}) to {arguments.output}"
    )


def main(args: Sequence[str] | None = None) -> None:
    args = sys.argv[1:] if args is None else list(args)
    arguments = make_parser().parse_args(args)
    if arguments.mode == "generate-config":
        generate_config(arguments)
    elif arguments.mode == "train":
        if arguments.detect_anomaly:
            import torch

            torch.autograd.set_detect_anomaly(True)
        train(arguments, args)
    elif arguments.mode == "evaluate":
        evaluate(arguments)
    elif arguments.mode == "predict":
        predict(arguments)
    elif arguments.mode == "edits":
        edits(arguments)
    elif arguments.mode == "export":
        export_model(arguments)
    else:
        raise ValueError(f"Unsupported action: {arguments.mode}")


if __name__ == "__main__":
    main()
