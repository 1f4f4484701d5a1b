"""Estimator (counterpart of ``allophant_tpu/training/estimator.py``): bucketed
``predict``, the fused greedy serving step ``predict_decoded``, the fused beam
serving step ``predict_beam_decoded``, ``map_allophones`` and
``downsampled_lengths``; and for a model built from a configuration
(``from_config``) or restored from a checkpoint (``restore``), ``train`` and
``save``.

Over a ``parallel.mesh.Mesh`` (``use_data_parallel``, or ``from_config`` and
``restore`` given one) each data rank predicts its rows of a batch and every
rank returns the whole batch's outputs; ``train`` trains over the mesh; only
the mesh's first rank writes a checkpoint, the full one-device checkpoint
gathered from the model-parallel shards.

PyTorch runs eagerly, so there is no per-bucket compile cache; the audio is
still bucketed exactly as the JAX estimator buckets it, because the width of
the decoded grid depends on the bucket."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from allophant_tpu_torch import tracing
from allophant_tpu_torch.config import Config, Wav2Vec2PretrainedConfig
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.device import resolve_device, set_float32_precision, to_device
from allophant_tpu_torch.models.allophant import AllophantModel, Predictions
from allophant_tpu_torch.models.projection import PHONE, PHONEME_LAYER
from allophant_tpu_torch.models.wav2vec2 import REMAT_SAVE_NAMES_BASE, Wav2Vec2Architecture
from allophant_tpu_torch.ops.decode import beam_search_heads, greedy_decode_heads
from allophant_tpu_torch.parallel import mesh as mesh_module
from allophant_tpu_torch.phonetics.attribute_graph import AttributeGraph
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer, PhoneticIndexerState
from allophant_tpu_torch.training import checkpoint as checkpoint_module
from allophant_tpu_torch.training.checkpoint import Checkpoint, EpochPosition, save_native, variables_from_model

#: Serving precision presets: name -> (dtype, head_dtype, f32_matmul_precision).
#: "float32" is full f32 (TF32 off for matmuls and cuDNN convolutions).
#: "mixed" runs the encoder in bf16 and the classifier head, composition and
#: allophone matmuls and log_softmax in f32. "float32_high" keeps f32
#: activations with TF32 matmuls and convolutions on the GPU — not the TPU's
#: 3-pass bf16 lowering that the JAX preset of the same name selects.
PRECISION_PRESETS = {
    "float32": (torch.float32, None, "highest"),
    "float32_high": (torch.float32, None, "high"),
    "mixed": (torch.bfloat16, torch.float32, "highest"),
    "bfloat16": (torch.bfloat16, None, "highest"),
}

#: The preset a serving estimator uses when the caller names none.
DEFAULT_SERVING_PRECISION = "mixed"

#: The CTC blank's class index: every head's classes are offset by one blank.
BLANK_INDEX = 0


def resolve_precision(precision: str):
    try:
        return PRECISION_PRESETS[precision]
    except KeyError:
        raise ValueError(
            f"Unknown precision preset {precision!r} (expected one of {sorted(PRECISION_PRESETS)})"
        ) from None


def _bucket_length(length: int, minimum: int = 1024) -> int:
    """Rounds a sequence length up to its bucket: powers of two below 64k
    samples, then multiples of 32k (2 s at 16 kHz)."""
    length = max(length, minimum)
    if length <= 65_536:
        return 1 << (length - 1).bit_length()
    step = 32_768
    return ((length + step - 1) // step) * step


def _pack_audio_for_upload(audio: np.ndarray) -> np.ndarray:
    """The audio as int16 when that is lossless, else unchanged.

    16-bit sources reach the model as float32 ``i / 32768``
    (``data/audio.py``), so they are sent as the int16 ``i`` and scaled back on
    the device: exact, since int16 -> float32 is exact and 2^-15 is a power of
    two. Half the bytes cross to the device. Anything else (resampled audio,
    float WAV sources) is sent unchanged."""
    if audio.ndim != 2 or audio.dtype != np.float32:
        return audio
    scaled = audio * 32768.0
    packed = scaled.astype(np.int16)
    if np.array_equal(scaled, packed):
        return packed
    return audio


def _unpack_audio_on_device(audio: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack_audio_for_upload``, on the device."""
    if audio.dtype == torch.int16:
        return audio.to(torch.float32) * (1.0 / 32768.0)
    return audio


def infer_wav2vec2_architecture(model_state: Dict[str, np.ndarray]) -> Wav2Vec2Architecture:
    """The encoder architecture of a reference checkpoint's state dict (hidden
    size, depth, conv stack, norm mode, positional conv): the checkpoints store
    only the hub model id."""
    prefix = "_acoustic_model._model."
    layer_ids = set()
    conv_ids = set()
    for key in model_state:
        if key.startswith(prefix + "encoder.layers."):
            layer_ids.add(int(key[len(prefix + "encoder.layers.") :].split(".")[0]))
        if key.startswith(prefix + "feature_extractor.conv_layers."):
            conv_ids.add(int(key[len(prefix + "feature_extractor.conv_layers.") :].split(".")[0]))

    num_layers = max(layer_ids) + 1
    num_convs = max(conv_ids) + 1
    hidden_size = model_state[prefix + "encoder.layers.0.attention.q_proj.weight"].shape[0]
    intermediate = model_state[prefix + "encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0]
    conv_dim = tuple(
        model_state[prefix + f"feature_extractor.conv_layers.{i}.conv.weight"].shape[0] for i in range(num_convs)
    )
    conv_kernel = tuple(
        model_state[prefix + f"feature_extractor.conv_layers.{i}.conv.weight"].shape[2] for i in range(num_convs)
    )
    layer_norm_mode = "layer" if prefix + "feature_extractor.conv_layers.1.layer_norm.weight" in model_state else "group"
    # Pre-norm ("stable") and post-norm encoders have the same parameter names
    # in HF wav2vec2; every released wav2vec2-family config couples them to
    # the extractor's norm: group norm <=> post-norm, layer norm <=> pre-norm.
    stable = layer_norm_mode == "layer"
    defaults = Wav2Vec2Architecture()
    # The positional conv's width and group count come from its (weight-normed)
    # torch Conv1d weight [out, in/groups, kernel_size].
    pos_prefix = prefix + "encoder.pos_conv_embed.conv"
    pos_weight = None
    for suffix in (".parametrizations.weight.original1", ".weight_v", ".weight"):
        if pos_prefix + suffix in model_state:
            pos_weight = model_state[pos_prefix + suffix]
            break
    if pos_weight is not None:
        num_pos = int(pos_weight.shape[2])
        pos_groups = max(1, int(hidden_size) // int(pos_weight.shape[1]))
    else:
        num_pos = defaults.num_conv_pos_embeddings
        pos_groups = defaults.num_conv_pos_embedding_groups
    return Wav2Vec2Architecture(
        hidden_size=int(hidden_size),
        num_hidden_layers=int(num_layers),
        num_attention_heads=max(1, int(hidden_size) // 64),
        intermediate_size=int(intermediate),
        conv_dim=conv_dim,
        conv_kernel=conv_kernel,
        conv_stride=defaults.conv_stride[:num_convs],
        conv_bias=prefix + "feature_extractor.conv_layers.0.conv.bias" in model_state,
        feat_extract_norm=layer_norm_mode,
        do_stable_layer_norm=stable,
        num_conv_pos_embeddings=num_pos,
        num_conv_pos_embedding_groups=pos_groups,
    )


def _flat_shapes(tree, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            shapes.update(_flat_shapes(value, path))
        else:
            shapes[path] = tuple(np.shape(value))
    return shapes


def _check_tree_shapes(expected: Dict, actual: Dict) -> None:
    """Raises unless ``actual`` has exactly ``expected``'s leaves, each of the
    same shape."""
    expected_flat = _flat_shapes(expected)
    actual_flat = _flat_shapes(actual)
    missing = set(expected_flat) - set(actual_flat)
    extra = set(actual_flat) - set(expected_flat)
    if missing or extra:
        raise ValueError(f"Checkpoint parameter mismatch. Missing: {sorted(missing)[:8]}; extra: {sorted(extra)[:8]}")
    for key, shape in expected_flat.items():
        if actual_flat[key] != shape:
            raise ValueError(f"Shape mismatch for {key}: checkpoint {actual_flat[key]} vs model {shape}")


class Estimator:
    """A model on a device with its precision preset, answering predictions.
    An Estimator built by ``from_config`` also carries what training and a
    checkpoint need: the configuration, the feature size and sample rate, the
    attribute graph, the epoch position, the history of validation points
    and, after a restore, the serialized training state."""

    def __init__(
        self,
        model: AllophantModel,
        precision: str = DEFAULT_SERVING_PRECISION,
        device=None,
        *,
        config: Optional[Config] = None,
        feature_size: int = 1,
        sample_rate: int = 16_000,
        attribute_graph: Optional[AttributeGraph] = None,
    ):
        self.device = resolve_device(device)
        dtype, head_dtype, f32_matmul_precision = resolve_precision(precision)
        if model.dtype != dtype or model.head_dtype != (dtype if head_dtype is None else head_dtype):
            raise ValueError(f"Model dtypes ({model.dtype}, {model.head_dtype}) do not match preset {precision!r}")
        self.precision = precision
        self.f32_matmul_precision = f32_matmul_precision
        self.model = model.to(self.device).eval()
        self.config = config
        self.feature_size = feature_size
        self.sample_rate = sample_rate
        self.attribute_graph = attribute_graph
        self.history: List[Any] = []
        self.epoch = EpochPosition()
        self.dataset_meta_data: List[Any] = []
        # Serialized optimizer and early-stopping state to resume from
        # (``TrainingRun.serialized_training_state``); consumed by ``train``.
        self.training_state: Optional[bytes] = None
        # The mesh of the model's shards, if any; ``use_data_parallel`` sets
        # the one predictions shard their rows over.
        self.mesh = model.mesh

    def use_data_parallel(self, mesh=None) -> "Estimator":
        """Shards prediction batches over the data ranks of ``mesh`` (default:
        every rank of the process group, no model axis): each data rank runs
        its contiguous rows of a batch, and every rank returns the whole
        batch's outputs. The mesh's model axis must be the model's own (1 for
        a model that is not sharded). Training over it follows from
        ``train``."""
        if mesh is None:
            mesh = mesh_module.create_mesh(model_parallel=1)
        own = 1 if self.model.mesh is None else self.model.mesh.model_parallel
        if mesh.model_parallel != own:
            raise ValueError(f"The mesh's model axis ({mesh.model_parallel}) is not the model's ({own})")
        self.mesh = mesh
        return self

    @classmethod
    def from_config(
        cls,
        config: Config,
        feature_size: int,
        sample_rate: int,
        attribute_graph: AttributeGraph,
        attribute_indexer: Optional[PhoneticAttributeIndexer] = None,
        wav2vec2_architecture=None,
        load_pretrained_weights: bool = True,
        seed: int = 0,
        precision: Optional[str] = None,
        device=None,
        remat: bool = False,
        remat_save_names=REMAT_SAVE_NAMES_BASE,
        mesh=None,
    ) -> "Estimator":
        """A trainable Estimator of ``config`` on ``device`` (CUDA unless the
        caller asks for another; raises without one): float32 master
        parameters drawn from ``seed`` (``weights.seeded_initialization``),
        computed in the preset ``precision`` (default: "mixed" when the
        config asks for mixed precision, else "float32"). ``feature_size`` is
        the input's features a frame (1 for raw samples; the preprocessing
        config's, ``DatasetManager.feature_size``), which the transformer's
        frontend reads. ``remat`` rematerialises the wav2vec2 encoder layers
        in training. With ``load_pretrained_weights`` (the default, as in
        JAX) a pretrained wav2vec2 encoder takes the weights of the config's
        ``model_id`` from the local HuggingFace cache, and keeps the seeded
        ones when they are not there (``models/pretrained.py``). Over a
        ``mesh`` with a model axis the model is this rank's shard of the
        one-device model."""
        from allophant_tpu_torch.models.allophant import build_model
        from allophant_tpu_torch.models.pretrained import load_pretrained_encoder
        from allophant_tpu_torch.weights import seeded_initialization

        device = resolve_device(device)
        if precision is None:
            precision = "mixed" if config.nn.mixed_precision else "float32"
        dtype, head_dtype, _ = resolve_precision(precision)
        built = build_model(
            config.nn, feature_size, sample_rate, attribute_graph, attribute_indexer, wav2vec2_architecture,
            dtype=dtype, head_dtype=head_dtype, device=device, param_dtype=torch.float32,
            remat=remat, remat_save_names=remat_save_names, mesh=mesh,
        )
        seeded_initialization(built.model, seed, mesh)
        if load_pretrained_weights and isinstance(config.nn.acoustic_model, Wav2Vec2PretrainedConfig):
            load_pretrained_encoder(built.model, config.nn.acoustic_model.model_id, mesh)
        return cls(
            built.model, precision, device,
            config=config, feature_size=feature_size, sample_rate=sample_rate, attribute_graph=attribute_graph,
        )

    @classmethod
    def restore(
        cls,
        checkpoint: Checkpoint | str,
        dtype=None,
        wav2vec2_architecture: Optional[Wav2Vec2Architecture] = None,
        precision: Optional[str] = None,
        device=None,
        remat: bool = False,
        mesh=None,
    ) -> Tuple["Estimator", PhoneticAttributeIndexer]:
        """Restores from a native, Orbax or reference checkpoint (a path, a
        hub model id in the local cache, or a parsed ``Checkpoint``) onto ``device``
        (CUDA unless the caller asks for another; raises without one); returns
        the estimator, with float32 master parameters, and the indexer rebuilt
        from the checkpoint's state.

        ``precision`` names a preset (default ``DEFAULT_SERVING_PRECISION``).
        ``dtype`` selects the single-dtype preset of that dtype ("float32" or
        "bfloat16") when no ``precision`` is given. A string second argument
        is a torch device name of the reference's API: it is not a dtype, and
        is ignored (pass ``device``). Without ``wav2vec2_architecture`` the
        encoder is XLS-R 300M, or for a reference checkpoint the architecture
        its tensors show. Every leaf of the checkpoint is shape-checked
        against the model before any is loaded. ``remat`` rematerialises the
        encoder layers when the restored model trains. Over a ``mesh`` with a
        model axis every rank reads the checkpoint and keeps its shard."""
        from allophant_tpu_torch.weights import load_full_state, state_dict_from_jax

        if isinstance(dtype, str):
            dtype = None
        if precision is None:
            precision = DEFAULT_SERVING_PRECISION if dtype is None else {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
        if not isinstance(checkpoint, Checkpoint):
            checkpoint = checkpoint_module.load_checkpoint(checkpoint)

        indexer = PhoneticAttributeIndexer.from_config(checkpoint.config, state_dict=checkpoint.phonetic_indexer_state)
        if (
            wav2vec2_architecture is None
            and isinstance(checkpoint.config.nn.acoustic_model, Wav2Vec2PretrainedConfig)
            and checkpoint.reference_model_state is not None
        ):
            wav2vec2_architecture = infer_wav2vec2_architecture(checkpoint.reference_model_state)

        estimator = cls.from_config(
            checkpoint.config,
            checkpoint.feature_size,
            checkpoint.sample_rate,
            checkpoint.attribute_graph,
            indexer,
            wav2vec2_architecture,
            load_pretrained_weights=False,
            precision=precision,
            device=device,
            remat=remat,
            mesh=mesh,
        )
        model = estimator.model
        expected = variables_from_model(model, estimator.full_parameters())
        if checkpoint.variables is not None:
            variables = checkpoint.variables
        elif checkpoint.reference_model_state is not None:
            params = checkpoint_module.convert_reference_model_state(
                checkpoint.reference_model_state,
                model.plan,
                wav2vec2_architecture,
                acoustic_config=checkpoint.config.nn.acoustic_model,
            )
            variables = {**expected, "params": params}
        else:
            raise ValueError("The checkpoint holds no model weights")
        _check_tree_shapes(expected, variables)
        load_full_state(model, state_dict_from_jax(variables, model.architecture.num_hidden_layers), mesh)

        estimator.epoch = checkpoint.epoch
        estimator.history = checkpoint.history
        estimator.training_state = checkpoint.optimizer_state
        return estimator, indexer

    def train(self, dataset_manager, tensorboard_dir: Optional[str] = None, skip_batches: int = 0, show_progress: bool = False):
        """A ``TrainingRun``: an iterable yielding ``(TrainingStatus,
        EpochStatistics)`` at every validation point, updating the model in
        place. A restored ``training_state`` resumes the optimizer and early
        stopping; ``skip_batches`` skips batches already consumed in the
        current epoch (pass ``self.epoch.step`` to resume mid-epoch)."""
        from allophant_tpu_torch.training.run import TrainingRun

        return TrainingRun(self, dataset_manager, tensorboard_dir, skip_batches, self.training_state, show_progress)

    def save(
        self,
        file_path: str,
        optimizer_state: Optional[bytes] = None,
        phonetic_indexer_state: Optional[PhoneticIndexerState] = None,
        additional_parameters: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Writes the native checkpoint (``training/checkpoint.save_native``).
        Over a mesh every rank calls it: the model-parallel shards are
        gathered, the mesh's first rank writes, and the others wait for it."""
        if self.config is None or self.attribute_graph is None:
            raise ValueError("Only an Estimator built from a configuration can be saved")
        parameters = self.full_parameters()
        mesh = self.model.mesh
        if mesh is not None and mesh.index != 0:
            mesh_module.barrier(mesh)
            return
        save_native(
            Checkpoint(
                config=self.config,
                feature_size=self.feature_size,
                sample_rate=self.sample_rate,
                attribute_graph=self.attribute_graph,
                epoch=self.epoch,
                phonetic_indexer_state=phonetic_indexer_state,
                variables=variables_from_model(self.model, parameters),
                optimizer_state=optimizer_state,
                history=self.history,
                dataset_meta_data=self.dataset_meta_data,
                additional=additional_parameters,
            ),
            file_path,
        )
        if mesh is not None:
            mesh_module.barrier(mesh)

    def full_parameters(self) -> Dict[str, torch.Tensor]:
        """The model's parameters by name, whole: gathered over the model
        group when the model is sharded (every rank of the group calls it)."""
        from allophant_tpu_torch.parallel.sharding import gather_state

        named = dict(self.model.named_parameters())
        if self.model.mesh is None:
            return {name: parameter.detach() for name, parameter in named.items()}
        return gather_state(named, self.model.mesh)

    @property
    def classes(self):
        return self.model.classes

    def _inputs(self, batch: Batch, target_feature_indices):
        """Bucket-pads the audio (as ``_padded`` in the JAX estimator) and moves
        the batch to the device without waiting for the device: 16-bit audio
        as int16 (``_pack_audio_for_upload``)."""
        audio = np.asarray(batch.audio_features, dtype=np.float32)
        target = _bucket_length(audio.shape[1])
        if audio.shape[1] < target:
            audio = np.pad(audio, [(0, 0), (0, target - audio.shape[1])] + [(0, 0)] * (audio.ndim - 2))
        device = self.device
        inputs = (
            _unpack_audio_on_device(to_device(_pack_audio_for_upload(audio), device)),
            to_device(np.asarray(batch.lengths, dtype=np.int64), device),
            to_device(np.asarray(batch.language_ids, dtype=np.int64), device),
        )
        if target_feature_indices is not None:
            target_feature_indices = to_device(np.asarray(target_feature_indices, dtype=np.int64), device)
        return inputs, target_feature_indices

    def _local_rows(self, batch: Batch):
        """(this rank's rows of ``batch``, their place) under a data-parallel
        mesh, else (``batch``, None). The batch is padded to a multiple of the
        data ranks with copies of its last row; the place is (first row,
        padded rows, real rows)."""
        mesh = self.mesh
        if mesh is None or mesh.data_parallel == 1:
            return batch, None
        size = len(batch.lengths)
        total = -(-size // mesh.data_parallel) * mesh.data_parallel
        rows = np.minimum(np.arange(total), size - 1)
        share = mesh_module.process_local_slice(total, mesh)
        local = rows[share]
        language_ids = np.broadcast_to(np.asarray(batch.language_ids), (size,))
        local_batch = Batch(
            np.asarray(batch.audio_features)[local], np.asarray(batch.lengths)[local], language_ids[local]
        )
        return local_batch, (share.start, total, size)

    def _all_rows(self, tensor: torch.Tensor, place, dim: int = 0) -> torch.Tensor:
        """The whole batch's ``tensor`` from this rank's rows along ``dim``
        (``place`` from ``_local_rows``; None: already whole)."""
        if place is None:
            return tensor
        start, total, size = place
        gathered = mesh_module.gather_rows(tensor.movedim(dim, 0), start, total, self.mesh.data_group)
        return gathered[:size].movedim(0, dim)

    def _forward(self, batch: Batch, target_feature_indices) -> Tuple[Predictions, torch.Tensor, Any]:
        """(predictions, language ids on the device, the rows' place from
        ``_local_rows``) of this rank's rows of ``batch``."""
        set_float32_precision(self.f32_matmul_precision)
        with tracing.span("estimator.inputs"):
            batch, place = self._local_rows(batch)
            (audio, lengths, language_ids), target_feature_indices = self._inputs(batch, target_feature_indices)
        with tracing.span("estimator.forward"):
            predictions = self.model(audio, lengths, language_ids, target_feature_indices, predict=True)
        return predictions, language_ids, place

    @torch.inference_mode()
    def predict(
        self,
        batch: Batch,
        target_feature_indices: Optional[np.ndarray] = None,
        log_probabilities: bool = True,
        time_major: bool = True,
    ) -> Predictions:
        """Per-task outputs, time-first [T, B, C] by default (batch-first with
        ``time_major=False``); log-probabilities are taken in f32 on every path."""
        with tracing.span("estimator.request"):
            predictions, _, place = self._forward(batch, target_feature_indices)
            with tracing.span("estimator.decode"):
                outputs = predictions.outputs
                if log_probabilities:
                    outputs = {name: torch.log_softmax(value.float(), dim=-1) for name, value in outputs.items()}
                outputs = {name: self._all_rows(value, place) for name, value in outputs.items()}
                if time_major:
                    outputs = {name: value.transpose(0, 1) for name, value in outputs.items()}
                return Predictions(outputs, self._all_rows(predictions.lengths, place))

    @torch.inference_mode()
    def predict_decoded(
        self,
        batch: Batch,
        target_feature_indices: Optional[np.ndarray] = None,
        heads: Tuple[str, ...] = (),
        map_allophones: bool = False,
    ):
        """Fused greedy serving step: returns (grid, lengths) device tensors where
        ``grid`` is uint16 [H, B, T'+1] — per head ``heads[h]``, row b: column 0
        the decoded token count, columns 1.. the blank-free collapsed token ids
        (0 past the count). Heads of equal class count and dtype share one
        decoding call (``greedy_decode_heads``)."""
        with tracing.span("estimator.request"):
            predictions, language_ids, place = self._forward(batch, target_feature_indices)
            with tracing.span("estimator.decode"):
                outputs = dict(predictions.outputs)
                if map_allophones:
                    # Map log-probs, not raw logits: the allophone max-pool multiplies by
                    # learned weights, so its argmax is not invariant to log_softmax.
                    outputs[PHONEME_LAYER] = self.model.map_allophones(
                        torch.log_softmax(outputs[PHONE].float(), dim=-1), language_ids
                    )
                # Per-head greedy argmax is invariant to log_softmax (a per-frame
                # shift), so plain heads decode raw outputs.
                grid = greedy_decode_heads([outputs[name] for name in heads], predictions.lengths, BLANK_INDEX)
                return self._all_rows(grid, place, dim=1), self._all_rows(predictions.lengths, place)

    @torch.inference_mode()
    def predict_beam_decoded(
        self,
        batch: Batch,
        target_feature_indices: Optional[np.ndarray] = None,
        heads: Tuple[str, ...] = (),
        beam_width: int = 4,
        map_allophones: bool = False,
    ):
        """Fused beam serving step: returns device tensors ``(collected, scores,
        lengths)`` where ``collected`` is int16 [H, T, B, K] (the token emitted
        at step t by beam k of row b for head ``heads[h]``, -1 = none) and
        ``scores`` is f32 [H, B, K].

        Every head decodes f32 log-probs, since the reported beam scores are
        not invariant to log_softmax; with ``map_allophones`` the phoneme layer
        is the allophone map of the phone head's log-probs. Heads of equal
        class count share one search launch (``beam_search_heads``)."""
        with tracing.span("estimator.request"):
            predictions, language_ids, place = self._forward(batch, target_feature_indices)
            with tracing.span("estimator.decode"):
                outputs = {name: torch.log_softmax(value.float(), dim=-1) for name, value in predictions.outputs.items()}
                if map_allophones:
                    outputs[PHONEME_LAYER] = self.model.map_allophones(outputs[PHONE], language_ids)
                collected, scores = beam_search_heads(
                    [outputs[name] for name in heads], predictions.lengths, beam_width, BLANK_INDEX
                )
                return (
                    self._all_rows(collected, place, dim=2),
                    self._all_rows(scores, place, dim=1),
                    self._all_rows(predictions.lengths, place),
                )

    def downsampled_lengths(self, lengths) -> np.ndarray:
        """CTC frame counts of audio lengths in samples."""
        return self.model.architecture.downsampled_lengths(np.asarray(lengths))

    @torch.inference_mode()
    def map_allophones(self, phone_logits, language_ids, time_major: bool = True) -> torch.Tensor:
        """Maps phone log-probs to per-language phoneme log-probs (time-first in
        and out by default; ``time_major=False`` for batch-first)."""
        phone_logits = torch.as_tensor(phone_logits, device=self.device)
        batch_first = phone_logits.transpose(0, 1) if time_major else phone_logits
        language_ids = torch.as_tensor(np.asarray(language_ids), dtype=torch.long, device=self.device)
        mapped = self.model.map_allophones(batch_first, language_ids)
        return mapped.transpose(0, 1) if time_major else mapped
