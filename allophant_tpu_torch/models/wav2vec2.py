"""wav2vec2 / XLS-R speech encoder (counterpart of
``allophant_tpu/models/wav2vec2.py``).

Batch-first [B, T, D] layout throughout, as in the JAX model. Differences that
do not change valid outputs:
- no 128-frame alignment padding: the attention kernels take any T, and frames
  past each row's length are masked (keys) or dropped downstream (queries);
- q, k and v come from one fused [D, 3D] projection, and the attention kernels
  read them in place through their strides.

Rematerialisation (``remat=True``, training) keeps JAX's saved sets: of each
encoder layer only its input and the tensors named in ``remat_save_names``
(``REMAT_SAVE_NAMES_BASE``: the fused QKV projection, the FFN's pre-GELU tile
and the attention context; ``_EXTENDED`` adds the attention and FFN outputs)
outlive the forward; everything else is recomputed in the backward. A layer
runs as two checkpointed regions around the attention (``rematerialised``):
LayerNorm + QKV projection, then the output projection, residuals and FFN.
The attention's autograd Function (K5 forward, K4 backward) stays outside
both, so its inputs (the QKV tile) and output (the context) are kept and the
backward never reruns it. Inside a region, a selective-checkpoint policy keeps
the matmul outputs of the named projections; the region's dropout draws are
replayed from the ``DropoutRng`` states it began with.

Tensor parallelism (``mesh`` with a model axis of tp > 1, JAX's dp x tp
shardings, ``parallel/sharding.py``): each encoder layer holds H/tp heads of
the fused QKV projection and 4096/tp (``intermediate_size``/tp) FFN columns;
the attention kernels run on the local [B, T, (H/tp)·hd] tile; the output
projection and the FFN's down projection are row-parallel, their partial sums
reduced over the model group before the bias and the residual, and the
backward reduces the input gradient of the column-parallel projections
(``parallel/tensor_parallel.py``). Under remat the reduces inside a
rematerialised region run again in its recompute, on every rank of the model
group in the same order.

Every dropout site of the JAX model is here (feature projection, encoder
input, attention weights, after attention, FFN activation and output); a
forward with ``rng=None`` is deterministic. ``frozen_prefix`` (JAX
``Wav2Vec2Model.frozen_prefix``) runs the whole-run-frozen prefix of
(feature extractor, feature projection, encoder) under ``torch.no_grad()``."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from allophant_tpu_torch.models.layers import ChannelGroupNorm, Conv1d, Dense, DropoutRng, LayerNorm, dropout
from allophant_tpu_torch.ops import masking
from allophant_tpu_torch.ops.activations import fast_gelu
from allophant_tpu_torch.ops.attention import key_bias_from_mask, multi_head_attention
from allophant_tpu_torch.ops.frame_encoder import FusedFrameConv
from allophant_tpu_torch.parallel.tensor_parallel import (
    copy_to_model_parallel,
    model_parallel,
    output_dense,
    rank_offset,
    split_evenly,
)


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Architecture:
    """Static architecture hyperparameters (mirrors the public wav2vec2 config;
    the defaults are XLS-R 300M)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (XLS-R) or "group" (base wav2vec2)
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    do_normalize: bool = True
    use_attention_mask: bool = True

    def downsampled_lengths(self, lengths):
        """CTC frame counts after the conv feature extractor (no padding)."""
        return masking.stacked_conv_output_lengths(lengths, self.conv_kernel, self.conv_stride)

    def truncated(self, maximum_encoder_layers: Optional[int]) -> "Wav2Vec2Architecture":
        """Limits encoder depth to the highest required intermediate tap."""
        if maximum_encoder_layers is None or maximum_encoder_layers >= self.num_hidden_layers:
            return self
        return dataclasses.replace(self, num_hidden_layers=maximum_encoder_layers)

    @property
    def fuses_first_layer(self) -> bool:
        """Whether the first conv + LayerNorm + GELU run as the fused frame
        encoder kernel (the JAX model's condition, wav2vec2.py:171-176)."""
        return self.feat_extract_norm == "layer" and self.conv_kernel[0] == 10 and self.conv_stride[0] == 5


class ConvFeatureEncoder(nn.Module):
    """Strided 1D convolutions over raw audio: [B, S] -> [B, T', C]."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        in_channels = 1
        for layer_id, (out_channels, kernel, stride) in enumerate(
            zip(arch.conv_dim, arch.conv_kernel, arch.conv_stride)
        ):
            # The fused first layer reads f32 weights, as the TPU kernel does.
            fused = layer_id == 0 and arch.fuses_first_layer
            self.convs.append(
                Conv1d(
                    in_channels, out_channels, kernel, stride, bias=arch.conv_bias,
                    dtype=torch.float32 if fused else dtype, device=device,
                    param_dtype=torch.float32 if fused else param_dtype,
                )
            )
            if arch.feat_extract_norm == "layer":
                self.norms.append(LayerNorm(out_channels, arch.layer_norm_eps, dtype, device))
            elif layer_id == 0:
                self.norms.append(ChannelGroupNorm(out_channels, arch.layer_norm_eps, dtype, device))
            in_channels = out_channels

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        first = 0
        if arch.fuses_first_layer:
            conv, norm = self.convs[0], self.norms[0]
            bias = conv.bias if conv.bias is not None else torch.zeros_like(norm.bias)
            hidden = FusedFrameConv.apply(
                audio, conv.weight[:, 0, :].t(), bias, norm.weight, norm.bias, arch.layer_norm_eps, self.dtype
            )
            first = 1
        else:
            hidden = audio[:, :, None].to(self.dtype)
        for layer_id in range(first, len(self.convs)):
            hidden = self.convs[layer_id](hidden)
            if layer_id < len(self.norms):
                hidden = self.norms[layer_id](hidden)
            hidden = fast_gelu(hidden)
        return hidden


class FeatureProjection(nn.Module):
    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.dropout_rate = arch.feat_proj_dropout
        self.layer_norm = LayerNorm(arch.conv_dim[-1], arch.layer_norm_eps, dtype, device)
        self.projection = Dense(arch.conv_dim[-1], arch.hidden_size, dtype, device, param_dtype)

    def forward(self, features: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return dropout(self.projection(self.layer_norm(features)), self.dropout_rate, rng)


class PositionalConvEmbedding(nn.Module):
    """Grouped convolutional relative position embeddings (weight norm folded
    into the plain kernel, as in the JAX model)."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        kernel = arch.num_conv_pos_embeddings
        self.trim = kernel % 2 == 0
        self.conv = Conv1d(
            arch.hidden_size, arch.hidden_size, kernel, padding=kernel // 2,
            groups=arch.num_conv_pos_embedding_groups, dtype=dtype, device=device, param_dtype=param_dtype,
        )

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        embeddings = self.conv(hidden)
        if self.trim:
            # Padding kernel//2 on both sides makes one frame too many for an
            # even kernel; the trailing one is dropped.
            embeddings = embeddings[:, :-1]
        return fast_gelu(embeddings)


# Remat residual sets (names as in the JAX model): BASE keeps the projection
# and FFN tiles whose matmuls dominate the recompute; EXTENDED also keeps the
# attention out-projection and FFN down-projection outputs, leaving only
# elementwise work to recompute.
REMAT_SAVE_NAMES_BASE = ("w2v2_qkv", "w2v2_ffn_hidden", "w2v2_attn_context")
REMAT_SAVE_NAMES_EXTENDED = REMAT_SAVE_NAMES_BASE + ("w2v2_attn_out", "w2v2_ffn_out")

_aten = torch.ops.aten
# The ops that produce a Dense layer's output (F.linear decomposes into one of
# them, with the bias fused or added).
_PROJECTION_OPS = frozenset((_aten.addmm.default, _aten.mm.default, _aten.bmm.default, _aten.add.Tensor))
_SCOPE = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Names the projection computed inside (JAX ``checkpoint_name``): under
    ``rematerialised`` with ``name`` in its save set, its output is kept."""
    previous = getattr(_SCOPE, "name", None)
    _SCOPE.name = name
    try:
        yield
    finally:
        _SCOPE.name = previous


def _save_named(save_names: Tuple[str, ...]):
    def policy(_context, op, *_args, **_kwargs):
        if op in _PROJECTION_OPS and getattr(_SCOPE, "name", None) in save_names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def rematerialised(function: Callable, rng: Optional[DropoutRng], save_names: Tuple[str, ...], *inputs):
    """``function(*inputs)`` under activation checkpointing: only the inputs and
    the named projections of ``save_names`` are kept for the backward, which
    reruns the rest. ``torch.utils.checkpoint`` replays only the default
    generators, so the region's ``DropoutRng`` state is taken here and set
    again for the recompute (then put back), so that the backward sees the
    forward's dropout masks."""
    state = None if rng is None else rng.get_state()
    calls = 0

    def run(*arguments):
        nonlocal calls
        calls += 1
        if calls == 1 or rng is None:
            return function(*arguments)
        resumed = rng.get_state()
        rng.set_state(state)
        try:
            return function(*arguments)
        finally:
            rng.set_state(resumed)

    return checkpoint(
        run, *inputs, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: create_selective_checkpoint_contexts(_save_named(save_names)),
    )


class SelfAttention(nn.Module):
    """Multi-head self-attention over the one-shot kernels; q/k/v come from one
    fused projection whose [B, T, 3D] output the kernels read through strides.
    Training attention dropout runs inside the kernel (K5) for every
    0 < rate < 1. Under tensor parallelism the layer holds H/tp heads: a
    [B, T, 3D/tp] tile and a row-parallel output projection."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None, mesh=None):
        super().__init__()
        tp, self.group = model_parallel(mesh)
        self.heads = split_evenly(arch.num_attention_heads, tp, "attention heads")
        self.total_heads = arch.num_attention_heads
        self.head_offset = rank_offset(mesh, self.heads)
        self.width = arch.hidden_size // tp
        self.dropout_rate = arch.attention_dropout
        self.qkv_proj = Dense(arch.hidden_size, 3 * self.width, dtype, device, param_dtype)
        self.out_proj = output_dense(arch.hidden_size, arch.hidden_size, dtype, device, param_dtype, mesh)

    def project(self, hidden: torch.Tensor) -> torch.Tensor:
        """The fused [B, T, 3D/tp] QKV projection."""
        hidden = copy_to_model_parallel(hidden, self.group)
        with checkpoint_name("w2v2_qkv"):
            return self.qkv_proj(hidden)

    def attend(self, qkv: torch.Tensor, key_bias: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """The [B, T, D/tp] attention context of a fused QKV tile."""
        query, key, value = qkv.split(self.width, dim=-1)
        head_dim = self.width // self.heads
        return multi_head_attention(
            query, key, value, key_bias, head_dim**-0.5, self.heads, self.dropout_rate, rng,
            self.total_heads, self.head_offset,
        )

    def output(self, context: torch.Tensor) -> torch.Tensor:
        with checkpoint_name("w2v2_attn_out"):
            return self.out_proj(context)

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.output(self.attend(self.project(hidden), key_bias, rng))


class FeedForward(nn.Module):
    """The FFN; under tensor parallelism this rank's intermediate_size/tp
    columns and a row-parallel down projection."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None, mesh=None):
        super().__init__()
        tp, self.group = model_parallel(mesh)
        self.activation_dropout = arch.activation_dropout
        self.hidden_dropout = arch.hidden_dropout
        width = split_evenly(arch.intermediate_size, tp, "FFN columns")
        self.total_columns = arch.intermediate_size
        self.column_offset = rank_offset(mesh, width)
        self.intermediate_dense = Dense(arch.hidden_size, width, dtype, device, param_dtype)
        self.output_dense = output_dense(arch.intermediate_size, arch.hidden_size, dtype, device, param_dtype, mesh)

    def forward(self, hidden: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        hidden = copy_to_model_parallel(hidden, self.group)
        with checkpoint_name("w2v2_ffn_hidden"):
            hidden = self.intermediate_dense(hidden)
        hidden = dropout(fast_gelu(hidden), self.activation_dropout, rng, self.total_columns, self.column_offset)
        with checkpoint_name("w2v2_ffn_out"):
            hidden = self.output_dense(hidden)
        return dropout(hidden, self.hidden_dropout, rng)


class EncoderLayer(nn.Module):
    """Transformer encoder layer: pre-LN ("stable layer norm", XLS-R) or post-LN;
    with ``remat``, its training forward runs as two rematerialised regions
    around the attention."""

    def __init__(
        self,
        arch: Wav2Vec2Architecture,
        dtype: torch.dtype,
        device=None,
        param_dtype=None,
        remat: bool = False,
        remat_save_names: Tuple[str, ...] = REMAT_SAVE_NAMES_BASE,
        mesh=None,
    ):
        super().__init__()
        self.stable = arch.do_stable_layer_norm
        self.hidden_dropout = arch.hidden_dropout
        self.remat = remat
        self.remat_save_names = tuple(remat_save_names)
        self.layer_norm = LayerNorm(arch.hidden_size, arch.layer_norm_eps, dtype, device)
        self.attention = SelfAttention(arch, dtype, device, param_dtype, mesh)
        self.final_layer_norm = LayerNorm(arch.hidden_size, arch.layer_norm_eps, dtype, device)
        self.feed_forward = FeedForward(arch, dtype, device, param_dtype, mesh)

    def _attention_input(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(hidden) if self.stable else hidden

    def _project(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.attention.project(self._attention_input(hidden))

    def _residuals(self, hidden: torch.Tensor, attention_output: torch.Tensor, rng: Optional[DropoutRng]) -> torch.Tensor:
        hidden = hidden + dropout(attention_output, self.hidden_dropout, rng)
        if not self.stable:
            hidden = self.layer_norm(hidden)
        feed_forward_input = self.final_layer_norm(hidden) if self.stable else hidden
        hidden = hidden + self.feed_forward(feed_forward_input, rng)
        return hidden if self.stable else self.final_layer_norm(hidden)

    def _finish(self, hidden: torch.Tensor, context: torch.Tensor, rng: Optional[DropoutRng]) -> torch.Tensor:
        return self._residuals(hidden, self.attention.output(context), rng)

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            names = self.remat_save_names
            qkv = rematerialised(self._project, rng, names, hidden)
            context = self.attention.attend(qkv, key_bias, rng)
            return rematerialised(self._finish, rng, names, hidden, context, rng)
        return self._residuals(hidden, self.attention(self._attention_input(hidden), key_bias, rng), rng)


class Wav2Vec2Encoder(nn.Module):
    """Encoder stack. With ``collect_all`` it returns every layer's input plus
    the final (normed) output — the taps "OUTPUT_<i>" classifiers read; without
    it, only the final state."""

    def __init__(
        self,
        arch: Wav2Vec2Architecture,
        dtype: torch.dtype,
        collect_all: bool = True,
        device=None,
        param_dtype=None,
        remat: bool = False,
        remat_save_names: Tuple[str, ...] = REMAT_SAVE_NAMES_BASE,
        mesh=None,
    ):
        super().__init__()
        self.stable = arch.do_stable_layer_norm
        self.hidden_dropout = arch.hidden_dropout
        self.collect_all = collect_all
        self.pos_conv_embed = PositionalConvEmbedding(arch, dtype, device, param_dtype)
        self.layer_norm = LayerNorm(arch.hidden_size, arch.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList(
            EncoderLayer(arch, dtype, device, param_dtype, remat, remat_save_names, mesh)
            for _ in range(arch.num_hidden_layers)
        )

    def forward(
        self, hidden: torch.Tensor, pad_mask: Optional[torch.Tensor], rng: Optional[DropoutRng] = None
    ) -> List[torch.Tensor]:
        if pad_mask is not None:
            # Zero padded positions so the positional conv sees silence there.
            hidden = hidden * pad_mask[:, :, None].to(hidden.dtype)
        hidden = hidden + self.pos_conv_embed(hidden)
        if not self.stable:
            hidden = self.layer_norm(hidden)
        hidden = dropout(hidden, self.hidden_dropout, rng)
        batch, time, _ = hidden.shape
        key_bias = key_bias_from_mask(pad_mask, batch, time, hidden.device)
        states = [hidden] if self.collect_all else []
        for layer in self.layers:
            hidden = layer(hidden, key_bias, rng)
            if self.collect_all:
                states.append(hidden)
        if self.stable:
            hidden = self.layer_norm(hidden)
        if not self.collect_all:
            return [hidden]
        states[-1] = hidden
        return states


class Wav2Vec2Model(nn.Module):
    """Raw audio [B, S] + lengths -> (hidden_states, frame_lengths), where
    hidden_states is a list of [B, T', D] tensors (num_hidden_layers + 1 of
    them with ``collect_all``, else just the final one).

    ``param_dtype`` (None = ``dtype``) stores the matmul and convolution
    weights; ``frozen_prefix`` is the number of leading groups of
    (feature_extractor, feature_projection, encoder) that run without
    gradients (JAX: ``stop_gradient`` at the prefix boundary); ``remat``
    rematerialises the encoder layers in training; ``mesh`` (a
    ``parallel.mesh.Mesh``) shards the encoder layers over its model axis."""

    def __init__(
        self,
        arch: Wav2Vec2Architecture,
        dtype: torch.dtype = torch.float32,
        collect_all: bool = True,
        device=None,
        param_dtype=None,
        frozen_prefix: int = 0,
        remat: bool = False,
        remat_save_names: Tuple[str, ...] = REMAT_SAVE_NAMES_BASE,
        mesh=None,
    ):
        super().__init__()
        self.arch = arch
        self.frozen_prefix = frozen_prefix
        self.feature_extractor = ConvFeatureEncoder(arch, dtype, device, param_dtype)
        self.feature_projection = FeatureProjection(arch, dtype, device, param_dtype)
        self.encoder = Wav2Vec2Encoder(arch, dtype, collect_all, device, param_dtype, remat, remat_save_names, mesh)

    def _prefix(self, group: int):
        """The gradient mode of the ``group``-th group (1-based)."""
        return torch.no_grad() if self.frozen_prefix >= group else contextlib.nullcontext()

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, rng: Optional[DropoutRng] = None):
        arch = self.arch
        with self._prefix(1):
            if arch.do_normalize:
                sample_mask = masking.mask_sequence(lengths, audio.shape[1])
                audio = masking.zero_mean_unit_var_norm(audio, lengths, sample_mask)
            features = self.feature_extractor(audio)
        frame_lengths = arch.downsampled_lengths(lengths)
        pad_mask = masking.mask_sequence(frame_lengths, features.shape[1]) if arch.use_attention_mask else None
        with self._prefix(2):
            hidden = self.feature_projection(features, rng)
        with self._prefix(3):
            hidden_states = self.encoder(hidden, pad_mask, rng)
        return hidden_states, frame_lengths
