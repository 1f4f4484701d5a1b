"""Ahead-of-time serving export: the transcription step as a saved
``torch.export`` program (counterpart of ``allophant_tpu/serving.py``).

A serving host should not need the checkpoint pipeline or the model code.
``export_transcriber`` traces the whole prediction program — acoustic model,
every classifier head and the on-device decoding — at one static
``[batch_size, samples]`` shape with ``torch.export``, the weights carried in
the program; ``save_transcriber`` writes it with ``torch.export.save``, and
``load_transcriber`` reads it back into a plain callable. Export one artifact
per serving bucket, as the live path pads to its buckets.

The hand-written kernels of the path (K1 in every attention layer, K2 in the
first feature-extractor layer and K3 for ``decode="beam"``) are custom ops
(``kernels/library.py``), so the program holds each as one node and runs the
same CUDA code as the live path. An artifact is bound to the device it was
exported on (the card, unless the caller asks for the CPU). The float32
matmul switches of the estimator's precision preset are process state, not
graph nodes: they travel in the artifact's metadata and the loader sets them.

The loader imports ``kernels/library.py`` and ``device.py`` and nothing of
``models/``, ``training/`` or ``data/``."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from allophant_tpu_torch.device import resolve_device, set_float32_precision
from allophant_tpu_torch.ops.decode import beam_search_device, greedy_decode_logits

#: The ``extra_files`` entry of an artifact that holds its metadata.
METADATA_FILE = "allophant_serving.json"
#: The head whose log-probs the beam modes search (JAX's literal name).
BEAM_HEAD = "phoneme"


def parse_decode(decode: str):
    """(mode, beam width) of a decode mode: "greedy", "log_probs", or "beam"
    with an optional width ("beam8"; default 4). Raises JAX's ValueError on
    any other."""
    beam_width = None
    if decode.startswith("beam"):
        beam_width = int(decode[4:] or 4)
        decode = "beam"
    if decode not in ("greedy", "log_probs", "beam"):
        raise ValueError(f"Unknown decode mode {decode!r} (greedy | log_probs | beam[width])")
    return decode, beam_width


class Transcriber(nn.Module):
    """The transcription function over an estimator's model:
    ``forward(audio [B, S] f32, lengths [B] i32, language_ids [B] i32)``.

    ``decode="greedy"`` returns ``({head: (tokens [B, T'], counts [B])},
    lengths)``: blank-free, collapsed int32 token ids per head (class ids with
    the CTC blank at 0, -1 past each row's count), from
    ``ops.decode.greedy_decode_logits`` on the raw outputs.
    ``decode="log_probs"`` returns ``({head: f32 log_softmax [B, T', C]},
    lengths)``. ``decode="beam"`` (``"beam<width>"``, e.g. ``"beam8"``)
    returns ``(decoded, (parents, emitted, scores), lengths)``: the greedy
    tracks of every head but the phoneme head, whose f32 log-probs go through
    the CTC prefix beam search. JAX exports its ``lax.scan`` formulation of
    the search there; this module runs the search kernel K3 (the custom op
    ``allophant_torch::beam_search``), which computes the same
    (parents [T', B, K], emitted [T', B, K], scores [B, K]) triple. The
    backtrace stays on the host (``ops.decode.backtrace_beams``), as in JAX.
    Frame lengths are int32 [B]."""

    def __init__(self, model: nn.Module, decode: str = "greedy"):
        super().__init__()
        self.decode, self.beam_width = parse_decode(decode)
        self.model = model

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, language_ids: torch.Tensor):
        predictions = self.model(audio, lengths.long(), language_ids.long(), predict=True)
        frame_lengths = predictions.lengths
        outputs = predictions.outputs
        if self.decode == "log_probs":
            log_probs = {name: torch.log_softmax(value.float(), dim=-1) for name, value in outputs.items()}
            return log_probs, frame_lengths.to(torch.int32)
        decoded = {}
        for name, value in outputs.items():
            if self.decode == "beam" and name == BEAM_HEAD:
                continue
            tokens, _timesteps, counts, _scores = greedy_decode_logits(value, frame_lengths)
            decoded[name] = (tokens.to(torch.int32), counts.to(torch.int32))
        if self.decode == "beam":
            log_probs = torch.log_softmax(outputs[BEAM_HEAD].float(), dim=-1)
            beam = beam_search_device(log_probs, frame_lengths, self.beam_width)
            return decoded, beam, frame_lengths.to(torch.int32)
        return decoded, frame_lengths.to(torch.int32)


def make_serving_fn(estimator, decode: str = "greedy") -> Transcriber:
    """The transcription module over ``estimator``'s model (see
    ``Transcriber``); raises ValueError on an unknown decode mode."""
    return Transcriber(estimator.model, decode)


@dataclasses.dataclass
class ExportedTranscriber:
    """An exported transcription program and the metadata its loader needs:
    the precision preset, ``f32_matmul_precision``, decode mode, the output
    heads' names, static batch size and samples, and the device."""

    program: torch.export.ExportedProgram
    metadata: Dict[str, Any]


def export_transcriber(estimator, batch_size: int, samples: int, decode: str = "greedy", device=None) -> ExportedTranscriber:
    """Traces the transcription function at the static shapes ``audio``
    f32 [batch_size, samples], ``lengths`` and ``language_ids`` int32
    [batch_size] with ``torch.export``, on ``device`` (the card unless the
    caller asks for the CPU; raises without one), where the estimator must
    lie. An estimator spread over a mesh (``use_data_parallel``, or a sharded
    model) is refused: an artifact is one device's, as JAX's is."""
    if estimator.mesh is not None:
        raise ValueError("An estimator spread over a mesh cannot be exported: an artifact runs on one device")
    device = resolve_device(device)
    if estimator.device != device:
        raise ValueError(f"The estimator lies on {estimator.device}, not on {device}")
    transcriber = make_serving_fn(estimator, decode).eval()
    arguments = (
        torch.zeros(batch_size, samples, dtype=torch.float32, device=device),
        torch.full((batch_size,), samples, dtype=torch.int32, device=device),
        torch.zeros(batch_size, dtype=torch.int32, device=device),
    )
    set_float32_precision(estimator.f32_matmul_precision)
    # Tensors made under inference mode cannot be exported: trace under no_grad.
    with torch.no_grad():
        program = torch.export.export(transcriber, arguments, strict=False)
    out_spec = program.call_spec.out_spec
    decoded = torch.utils._pytree.tree_unflatten([None] * out_spec.num_leaves, out_spec)[0]
    heads = sorted(decoded) + ([BEAM_HEAD] if transcriber.decode == "beam" else [])
    metadata = {
        "precision": estimator.precision,
        "f32_matmul_precision": estimator.f32_matmul_precision,
        "decode": decode,
        "heads": heads,
        "batch_size": int(batch_size),
        "samples": int(samples),
        "device": str(device),
    }
    return ExportedTranscriber(program, metadata)


def save_transcriber(exported: ExportedTranscriber, path: str) -> None:
    """Writes the program with ``torch.export.save``, its metadata as the JSON
    ``extra_files`` entry ``METADATA_FILE``."""
    torch.export.save(exported.program, path, extra_files={METADATA_FILE: json.dumps(exported.metadata)})


class LoadedTranscriber:
    """A loaded artifact: call it with numpy arrays or tensors ``(audio [B,
    S], lengths [B], language_ids [B])`` at the artifact's static shape; it
    returns the exported function's outputs as tensors on its device."""

    def __init__(self, program: torch.export.ExportedProgram, metadata: Dict[str, Any]):
        self.metadata = metadata
        self.device = resolve_device(metadata["device"])
        self._module = program.module()

    def __call__(self, audio, lengths, language_ids):
        set_float32_precision(self.metadata["f32_matmul_precision"])
        inputs = (
            _as_tensor(audio, torch.float32, self.device),
            _as_tensor(lengths, torch.int32, self.device),
            _as_tensor(language_ids, torch.int32, self.device),
        )
        expected = (self.metadata["batch_size"], self.metadata["samples"])
        if tuple(inputs[0].shape) != expected:
            raise ValueError(f"The artifact takes audio of shape {expected}, not {tuple(inputs[0].shape)}")
        # Inference mode, as the live serving path runs: no autograd
        # bookkeeping around each of the program's operations.
        with torch.inference_mode():
            return self._module(*inputs)


def _as_tensor(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(values))
    return values.to(device=device, dtype=dtype)


def load_transcriber(path: str) -> LoadedTranscriber:
    """Loads a saved artifact into a callable on the device it was exported
    on (raises there without a CUDA device), with the float32 switches of its
    precision preset set. Imports the kernels' custom ops and no model code."""
    from allophant_tpu_torch.kernels import library  # noqa: F401  (registers the custom ops)

    extra_files = {METADATA_FILE: ""}
    program = torch.export.load(path, extra_files=extra_files)
    metadata = json.loads(extra_files[METADATA_FILE])
    set_float32_precision(metadata["f32_matmul_precision"])
    return LoadedTranscriber(program, metadata)
