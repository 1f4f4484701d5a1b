"""w2v-BERT 2.0 speech encoder (Seamless Communication, Barrault et al. 2023;
https://huggingface.co/facebook/w2v-bert-2.0): a Kaldi-style filterbank
front end, a feature projection and Conformer layers with relative-key
self-attention, as transformers' ``Wav2Vec2BertModel`` computes them
(``models/wav2vec2_bert/modeling_wav2vec2_bert.py``) with
``SeamlessM4TFeatureExtractor``'s features.

Batch-first [B, T, D] throughout. Each Conformer layer computes

    x += FFN1(LN(x)) / 2;  x += W_o Attn(LN(x));  x += Conv(x);  x = LN(x + FFN2(LN(x)) / 2)

with swish feed-forwards, attention whose score adds q . E[clamp(j - i,
-left, right) + left] (K7, ``ops/relkey_attention.py``), and a convolution
module of LN, a 1x1 convolution to 2D channels, GLU, a causal depthwise
convolution, LN, swish and a 1x1 convolution back to D. Padded frames are
zeroed before the layers and inside the convolution module, and are never
attended to, as in transformers; frames past a row's length give outputs
that nothing valid reads.

Precision: the front end and its statistics in float32 (``ops/fbank.py``,
on the device); the residual stream between the sublayers in float32, as
the last layer norm of each layer leaves it (so the 96 residual sums of 24
layers are not rounded to bf16 each); the sublayers, products included,
in the compute dtype (bf16 under the "mixed" preset), layer norms'
statistics in float32 (``models/layers.py``).
Departures that do not change valid outputs: q, k and v come from one fused
[D, 3D] projection (``self_attn.qkv_proj``: transformers' ``linear_q``,
``linear_k`` and ``linear_v`` stacked) read by K7 through strides; the 1x1
convolutions run as products over the channel axis.

Serving on the card runs the layer stack as a CUDA graph per input shape
(``Wav2Vec2BertEncoder``), the graphs in one shared memory pool. The port
serves this encoder: it has no dropout, no adapter, no rematerialisation,
no tensor parallelism, no attention backward on the card and no
``torch.export`` (K7 is a ctypes launch, not a custom op), and asks for
none of them."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from allophant_tpu_torch import tracing
from allophant_tpu_torch.models.layers import Dense, LayerNorm
from allophant_tpu_torch.ops import fbank
from allophant_tpu_torch.ops.attention import key_bias_from_mask
from allophant_tpu_torch.ops.masking import mask_sequence
from allophant_tpu_torch.ops.relkey_attention import relkey_attention


@dataclasses.dataclass(frozen=True)
class Wav2Vec2BertArchitecture:
    """w2v-BERT 2.0's architecture (the names of transformers'
    ``Wav2Vec2BertConfig``, with the feature extractor's ``num_mel_bins``
    and ``stride``); the defaults are the published model's."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    hidden_act: str = "swish"
    layer_norm_eps: float = 1e-5
    position_embeddings_type: str = "relative_key"
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    add_adapter: bool = False
    num_mel_bins: int = 80
    stride: int = 2

    def __post_init__(self):
        implemented = {"hidden_act": "swish", "position_embeddings_type": "relative_key", "add_adapter": False}
        departed = {name: getattr(self, name) for name, value in implemented.items() if getattr(self, name) != value}
        if departed:
            raise ValueError(f"the port's w2v-BERT implements {implemented}, not {departed}")
        if self.feature_projection_input_dim != self.num_mel_bins * self.stride:
            raise ValueError(
                f"feature_projection_input_dim {self.feature_projection_input_dim} is not"
                f" num_mel_bins {self.num_mel_bins} x stride {self.stride}"
            )

    def downsampled_lengths(self, lengths):
        """Encoder frames of audio lengths in samples: whole stacks of
        ``stride`` filterbank frames."""
        return fbank.stacked_lengths(lengths, self.stride)

    def truncated(self, maximum_encoder_layers: Optional[int]) -> "Wav2Vec2BertArchitecture":
        """Limits encoder depth to the highest required intermediate tap."""
        if maximum_encoder_layers is None or maximum_encoder_layers >= self.num_hidden_layers:
            return self
        return dataclasses.replace(self, num_hidden_layers=maximum_encoder_layers)


class _Weight(nn.Module):
    """One weight, named ``<module>.weight`` as transformers names it: the
    distance embeddings (an ``nn.Embedding``) and the depthwise kernel (an
    ``nn.Conv1d`` without bias)."""

    def __init__(self, shape, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class _Pointwise(nn.Module):
    """A 1x1 convolution without bias over channel-last [B, T, C]: weight
    [out, in, 1] (torch's ``Conv1d`` layout) in ``param_dtype``, run as a
    product in the compute dtype."""

    def __init__(self, inputs: int, outputs: int, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        param_dtype = dtype if param_dtype is None else param_dtype
        self.weight = nn.Parameter(torch.empty(outputs, inputs, 1, dtype=param_dtype, device=device))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.linear(hidden.to(self.dtype), self.weight[:, :, 0].to(self.dtype))


class FeatureProjection(nn.Module):
    def __init__(self, arch: Wav2Vec2BertArchitecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.layer_norm = LayerNorm(arch.feature_projection_input_dim, arch.layer_norm_eps, dtype, device)
        self.projection = Dense(arch.feature_projection_input_dim, arch.hidden_size, dtype, device, param_dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(features))


class FeedForward(nn.Module):
    def __init__(self, arch: Wav2Vec2BertArchitecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.intermediate_dense = Dense(arch.hidden_size, arch.intermediate_size, dtype, device, param_dtype)
        self.output_dense = Dense(arch.intermediate_size, arch.hidden_size, dtype, device, param_dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(hidden)))


class RelativeKeyAttention(nn.Module):
    """Self-attention with relative-key distances (K7); q, k and v are column
    blocks of one fused projection."""

    def __init__(self, arch: Wav2Vec2BertArchitecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.heads = arch.num_attention_heads
        self.width = arch.hidden_size
        self.left = arch.left_max_position_embeddings
        self.right = arch.right_max_position_embeddings
        head_dim = arch.hidden_size // arch.num_attention_heads
        self.qkv_proj = Dense(arch.hidden_size, 3 * arch.hidden_size, dtype, device, param_dtype)
        self.linear_out = Dense(arch.hidden_size, arch.hidden_size, dtype, device, param_dtype)
        self.distance_embedding = _Weight(
            (self.left + self.right + 1, head_dim), dtype if param_dtype is None else param_dtype, device
        )

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        query, key, value = self.qkv_proj(hidden).split(self.width, dim=-1)
        context = relkey_attention(
            query, key, value, key_bias, self.distance_embedding.weight, (self.width // self.heads) ** -0.5, self.heads,
            self.left, self.right,
        )
        return self.linear_out(context)


class ConvolutionModule(nn.Module):
    """LN, padded frames zeroed, 1x1 convolution to 2D channels, GLU, causal
    depthwise convolution (kernel - 1 zeros on the left), LN, swish, 1x1
    convolution back to D."""

    def __init__(self, arch: Wav2Vec2BertArchitecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        width, kernel = arch.hidden_size, arch.conv_depthwise_kernel_size
        self.dtype = dtype
        self.kernel = kernel
        self.layer_norm = LayerNorm(width, arch.layer_norm_eps, dtype, device)
        self.pointwise_conv1 = _Pointwise(width, 2 * width, dtype, device, param_dtype)
        self.depthwise_conv = _Weight((width, 1, kernel), dtype if param_dtype is None else param_dtype, device)
        self.depthwise_layer_norm = LayerNorm(width, arch.layer_norm_eps, dtype, device)
        self.pointwise_conv2 = _Pointwise(width, width, dtype, device, param_dtype)

    def forward(self, hidden: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        hidden = self.layer_norm(hidden) * valid
        hidden = F.glu(self.pointwise_conv1(hidden), dim=-1)
        weight = self.depthwise_conv.weight.to(self.dtype)
        hidden = F.conv1d(F.pad(hidden.transpose(1, 2), (self.kernel - 1, 0)), weight, groups=weight.shape[0])
        hidden = F.silu(self.depthwise_layer_norm(hidden.transpose(1, 2)))
        return self.pointwise_conv2(hidden)


class ConformerLayer(nn.Module):
    def __init__(self, arch: Wav2Vec2BertArchitecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        width, eps = arch.hidden_size, arch.layer_norm_eps
        self.ffn1_layer_norm = LayerNorm(width, eps, dtype, device)
        self.ffn1 = FeedForward(arch, dtype, device, param_dtype)
        self.self_attn_layer_norm = LayerNorm(width, eps, dtype, device)
        self.self_attn = RelativeKeyAttention(arch, dtype, device, param_dtype)
        self.conv_module = ConvolutionModule(arch, dtype, device, param_dtype)
        self.ffn2_layer_norm = LayerNorm(width, eps, dtype, device)
        self.ffn2 = FeedForward(arch, dtype, device, param_dtype)
        self.final_layer_norm = LayerNorm(width, eps, torch.float32, device)

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The float32 residual stream ``hidden`` through one layer: each
        sublayer's output (compute dtype) is added in float32."""
        hidden = hidden + 0.5 * self.ffn1(self.ffn1_layer_norm(hidden))
        hidden = hidden + self.self_attn(self.self_attn_layer_norm(hidden), key_bias)
        hidden = hidden + self.conv_module(hidden, valid)
        return self.final_layer_norm(hidden + 0.5 * self.ffn2(self.ffn2_layer_norm(hidden)))


#: The share of the device's memory that an encoder's captured graphs may
#: hold (their shared workspace and each shape's outputs, as the capture
#: reserves them); a shape that comes after runs eagerly.
GRAPH_MEMORY_SHARE = 1 / 32


class _CapturedLayers:
    """The layer stack at one input shape as a CUDA graph in the shared
    ``pool``: static input buffers, the captured launches, and the outputs
    they write. A replay copies the inputs in, launches the graph and
    returns copies of the outputs (so a later replay of another shape, which
    may reuse the pool's memory, cannot touch them), and counts the K7
    launches that the capture recorded."""

    def __init__(self, run, pool, stream: torch.cuda.Stream, *inputs: torch.Tensor):
        self.inputs = tuple(value.clone() for value in inputs)
        self.graph = torch.cuda.CUDAGraph()
        recorded = relkey_attention.captured
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool)
            try:
                self.outputs = run(*self.inputs)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        self.launches = relkey_attention.captured - recorded

    def __call__(self, *inputs: torch.Tensor) -> List[torch.Tensor]:
        for static, value in zip(self.inputs, inputs):
            static.copy_(value)
        self.graph.replay()
        relkey_attention.launches += self.launches
        tracing.count("relkey_attention_calls", self.launches)
        return [state.clone() for state in self.outputs]


class Wav2Vec2BertEncoder(nn.Module):
    """The Conformer layers. Serving on a CUDA device runs them as one CUDA
    graph per input shape (``[B, T, D]``): eagerly the first time a shape
    comes, which also captures it, and by replay after, while the graphs
    hold under ``GRAPH_MEMORY_SHARE`` of the device's memory. Eager, the
    host issues some 40 launches a layer, more than the card takes to run
    them at these shapes; a replay is one call."""

    def __init__(
        self, arch: Wav2Vec2BertArchitecture, dtype: torch.dtype, collect_all: bool = True, device=None, param_dtype=None
    ):
        super().__init__()
        self.collect_all = collect_all
        self.layers = nn.ModuleList(
            ConformerLayer(arch, dtype, device, param_dtype) for _ in range(arch.num_hidden_layers)
        )
        self._captured = {}
        self._graph_bytes = 0
        self._pool = self._stream = None

    def inputs(self, hidden: torch.Tensor, pad_mask: torch.Tensor):
        """(the float32 residual stream with padded frames zeroed, the key
        bias, the valid frames in the compute dtype): ``_run``'s arguments."""
        valid = pad_mask[:, :, None].to(hidden.dtype)
        batch, time, _ = hidden.shape
        return (hidden * valid).float(), key_bias_from_mask(pad_mask, batch, time, hidden.device), valid

    def _run(self, hidden: torch.Tensor, key_bias: torch.Tensor, valid: torch.Tensor) -> List[torch.Tensor]:
        states = [hidden] if self.collect_all else []
        for layer in self.layers:
            hidden = layer(hidden, key_bias, valid)
            if self.collect_all:
                states.append(hidden)
        return states if self.collect_all else [hidden]

    def forward(self, hidden: torch.Tensor, pad_mask: torch.Tensor) -> List[torch.Tensor]:
        """Every layer's input and the last layer's output with
        ``collect_all`` (transformers' ``hidden_states``: the taps
        "OUTPUT_<i>" classifiers read), else the last output alone; float32."""
        inputs = self.inputs(hidden, pad_mask)
        if not hidden.is_cuda or torch.is_grad_enabled():
            return self._run(*inputs)
        shape = (tuple(hidden.shape), hidden.dtype)
        captured = self._captured.get(shape)
        if captured is not None:
            return captured(*inputs)
        states = self._run(*inputs)
        device = hidden.device
        if self._graph_bytes < GRAPH_MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory:
            if self._pool is None:
                self._pool, self._stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)
            reserved = torch.cuda.memory_reserved(device)
            self._captured[shape] = _CapturedLayers(self._run, self._pool, self._stream, *inputs)
            self._graph_bytes += torch.cuda.memory_reserved(device) - reserved
        return states


class Wav2Vec2BertModel(nn.Module):
    """Raw audio [B, S] in [-1, 1] + lengths in samples -> (hidden_states,
    frame_lengths), where hidden_states is a list of [B, T, D] tensors
    (num_hidden_layers + 1 of them with ``collect_all``, else the final one).
    ``param_dtype`` (None = ``dtype``) stores the products' weights."""

    def __init__(
        self,
        arch: Wav2Vec2BertArchitecture,
        dtype: torch.dtype = torch.float32,
        collect_all: bool = True,
        device=None,
        param_dtype=None,
    ):
        super().__init__()
        self.arch = arch
        self.feature_projection = FeatureProjection(arch, dtype, device, param_dtype)
        self.encoder = Wav2Vec2BertEncoder(arch, dtype, collect_all, device, param_dtype)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, rng=None):
        if rng is not None:
            raise ValueError("the port's w2v-BERT has no dropout: it serves, and a training forward is not ported")
        arch = self.arch
        with tracing.span("encoder.frontend"):
            features, frame_lengths = fbank.kaldi_fbank(audio, lengths, arch.num_mel_bins, arch.stride)
        hidden = self.feature_projection(features)
        return self.encoder(hidden, mask_sequence(frame_lengths, hidden.shape[1])), frame_lengths
