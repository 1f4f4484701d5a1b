"""w2v-BERT 2.0 in the port (``models/w2v_bert.py``, ``ops/fbank.py``, K7's
twin in ``ops/relkey_attention.py``) against the benchmark's plain reference
(``cardbench/reference/encoders/w2v_bert.py``) on the benchmark's seeded
weights, and both against transformers' ``Wav2Vec2BertModel`` and
``SeamlessM4TFeatureExtractor`` at random init with copied weights
(transformers is an oracle here; neither the port nor the reference imports
it). Tiny widths, float32, on the CPU."""

import numpy as np
import pytest
import torch
from transformers import SeamlessM4TFeatureExtractor, Wav2Vec2BertConfig, Wav2Vec2BertModel
from transformers.models.wav2vec2_bert.modeling_wav2vec2_bert import Wav2Vec2BertSelfAttention

from allophant_tpu_torch import tracing
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.demo import _flagship_build
from allophant_tpu_torch.models.w2v_bert import Wav2Vec2BertArchitecture, Wav2Vec2BertModel as PortModel
from allophant_tpu_torch.ops import fbank
from allophant_tpu_torch.ops.relkey_attention import reference_relkey_attention, relkey_attention
from allophant_tpu_torch.training.estimator import Estimator
from cardbench.core import weights
from cardbench.reference.encoders.w2v_bert import AcousticModel
from cardbench.reference.judge import bottleneck_gaps, pad_sequences
from cardbench.reference.model import ReferenceAllophant
from cardbench.reference.numerics import full_float32

TINY = {
    "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
    "feature_projection_input_dim": 160, "hidden_act": "swish", "layer_norm_eps": 1e-5,
    "position_embeddings_type": "relative_key", "left_max_position_embeddings": 64, "right_max_position_embeddings": 8,
    "conv_depthwise_kernel_size": 31, "add_adapter": False, "num_mel_bins": 80, "stride": 2,
}
#: Rows of 1.5 s, 0.47 s and 0.75 s: 148, 45 and 73 filterbank frames (the
#: last two odd, so a frame is dropped) and 74, 22 and 36 encoder frames, so
#: attention sees keys more than 64 frames behind their queries and more
#: than 8 ahead (both clamps), padded keys, and a length that is no multiple
#: of a 64-key tile.
LENGTHS = (24_000, 7_513, 12_001)
SEED = 2**33 + 20


def _audio(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lengths), max(lengths)), np.float32)
    for row, length in enumerate(lengths):
        audio[row, :length] = np.round(rng.normal(0.0, 0.1, length) * 32767) / 32768
    return audio


@pytest.fixture(scope="module")
def extractor_features():
    """transformers' features and attention mask of ``_audio()``."""
    audio = _audio()
    out = SeamlessM4TFeatureExtractor()(
        [row[:length] for row, length in zip(audio, LENGTHS)], sampling_rate=16_000, return_tensors="pt"
    )
    return audio, out["input_features"], out["attention_mask"].bool()


@pytest.fixture(scope="module")
def reference():
    """The reference encoder at the tiny widths with the benchmark's weights
    of ``SEED`` (as ``weights.draw`` gives them, under ``acoustic_model.``)."""
    model = AcousticModel(TINY)
    shapes = [("acoustic_model." + name, tuple(value.shape)) for name, value in model.named_parameters()]
    drawn = weights.draw(shapes, SEED, "cpu", {})
    weights.load_into(model, {name.removeprefix("acoustic_model."): value for name, value in drawn.items()})
    return model.eval()


def _transformers_model(reference_model):
    """transformers' ``Wav2Vec2BertModel`` at the tiny widths, holding the
    reference's weights (q, k and v split out of ``qkv_proj``)."""
    config = Wav2Vec2BertConfig(
        **{key: value for key, value in TINY.items() if key not in ("num_mel_bins", "stride")},
        hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
        conformer_conv_dropout=0.0, layerdrop=0.0, apply_spec_augment=False,
    )
    model = Wav2Vec2BertModel(config).eval()
    state = {}
    for name, value in reference_model.state_dict().items():
        if name.endswith("qkv_proj.weight") or name.endswith("qkv_proj.bias"):
            prefix, leaf = name.rsplit(".qkv_proj.", 1)
            for part, chunk in zip(("q", "k", "v"), value.chunk(3)):
                state[f"{prefix}.linear_{part}.{leaf}"] = chunk
        else:
            state[name] = value
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and not [name for name in missing if "masked_spec_embed" not in name], (missing, unexpected)
    return model


def test_the_port_front_end_matches_the_feature_extractor(extractor_features):
    """The port's on-device filterbank (float32 throughout) against the
    extractor's (float64, its spectrum kept in complex64): the normalised
    features, of unit scale per bin, agree to 1e-3, padding included (zero
    past a row's frames; a row's odd last frame is the first half of a pair
    that both mask); both keep the same frames (whole pairs)."""
    audio, expected, mask = extractor_features
    features, frames = fbank.kaldi_fbank(torch.as_tensor(audio), torch.as_tensor(LENGTHS))
    assert frames.tolist() == mask.sum(1).tolist() == [74, 22, 36]
    torch.testing.assert_close(features, expected, rtol=0, atol=1e-3)


def test_the_reference_front_end_matches_the_feature_extractor(reference, extractor_features):
    """The reference's float64 front end against the extractor's: they part
    only where the extractor rounds its spectrum to complex64 and normalises
    in float32, well under 1e-4 of features of unit scale."""
    audio, expected, mask = extractor_features
    features = reference.extract(torch.as_tensor(audio), torch.as_tensor(LENGTHS), "float32")
    assert reference.frame_lengths(torch.as_tensor(LENGTHS)).tolist() == [74, 22, 36]
    torch.testing.assert_close(features[mask], expected[mask], rtol=0, atol=1e-4)


def test_the_reference_encoder_matches_transformers(reference, extractor_features):
    """The reference's layers on the extractor's features against
    ``Wav2Vec2BertModel``'s last hidden state on the valid frames, both
    float32 on the CPU: they part by summation order, 1e-4 of outputs that
    the last layer norm holds near unit scale."""
    _, features, mask = extractor_features
    with torch.no_grad():
        expected = _transformers_model(reference)(features, attention_mask=mask.long()).last_hidden_state
        got = reference.encode(features, mask.sum(1), "float32", None)
    torch.testing.assert_close(got[mask], expected[mask], rtol=1e-4, atol=1e-4)


def test_the_bf16_encoder_keeps_its_residual_stream_in_float32(reference):
    """Under bf16 the port's layers add their sublayers' outputs to a
    float32 residual stream: the encoder's output is float32 and lies as
    near the float32 reference as the reference with its products in bf16
    does (0.035 against 0.030 here, outputs up to 3.5), within 1.5 times;
    a bf16 stream, rounded after each of the layers' residual sums, read
    0.054."""
    port = PortModel(Wav2Vec2BertArchitecture(**TINY), torch.bfloat16, collect_all=False)
    weights.load_into(port, {name: value for name, value in reference.state_dict().items()})
    audio, lengths = torch.as_tensor(_audio()), torch.as_tensor(LENGTHS)
    with torch.no_grad(), full_float32():
        states, frames = port(audio, lengths)
        features = reference.extract(audio, lengths, "float32")
        expected = reference.encode(features, frames, "float32", None)
        products = reference.encode(features, frames, "bfloat16", None)
    mask = torch.arange(expected.shape[1])[None] < frames[:, None]
    assert states[0].dtype == torch.float32
    error = float((states[0][:, : expected.shape[1]][mask] - expected[mask]).abs().max())
    assert error <= 1.5 * float((products[mask] - expected[mask]).abs().max()), error


@pytest.fixture(scope="module")
def allophant():
    """(the port's model through ``demo._flagship_build``, the reference
    model) at the tiny widths under the demo head, in float32, with the same
    seeded weights."""
    from cardbench.core import registry

    head = registry.head("allophant-demo")
    config = {"encoder": "w2v_bert", "architecture": TINY, "training": {}}
    model_reference = ReferenceAllophant(config, head)
    drawn = weights.draw(model_reference.shapes(), SEED, "cpu", head["static"])
    weights.load_into(model_reference, drawn)
    port = _flagship_build(Wav2Vec2BertArchitecture(**TINY), torch.float32, None, "cpu").model
    weights.load_into(port, drawn)
    return port.eval(), model_reference.eval(), head


def test_the_port_encoder_matches_the_reference(allophant):
    """Front end and layers: the port's encoder (float32, K7's twin) against
    the reference on the same weights and padded audio, on the valid frames.
    The front ends part by float32 rounding (1e-3 of unit-scale features,
    above), which the layers carry to their outputs, near unit scale: 2e-3."""
    port, model_reference, _ = allophant
    audio, lengths = torch.as_tensor(_audio()), torch.as_tensor(LENGTHS)
    with torch.no_grad(), full_float32():
        states, frames = port.acoustic_model(audio, lengths)
        features = model_reference.acoustic_model.extract(audio, lengths, "float32")
        expected = model_reference.acoustic_model.encode(features, frames, "float32", None)
    mask = torch.arange(expected.shape[1])[None] < frames[:, None]
    assert len(states) == 1 and frames.tolist() == [74, 22, 36]
    torch.testing.assert_close(states[0][:, : expected.shape[1]][mask], expected[mask], rtol=0, atol=2e-3)


def test_a_request_through_predict_decoded_matches_the_reference(allophant):
    """The whole request: ``Estimator.predict_decoded`` (bucket padding to
    32,768 samples, upload, the encoder, the head, the greedy decode) serves
    every output's sequence at a bottleneck gap under 1e-3 nats from the
    reference's log-probabilities, as the benchmark judges it (0 where both
    decode alike; the float32 front ends part by 1e-3, so a frame near a tie
    may choose the other class)."""
    port, model_reference, head = allophant
    audio, lengths, languages = _audio(), np.asarray(LENGTHS), np.array([0, 3, 1])
    names = [node["name"] for node in head["plan"]["nodes"]] + ["phone"]
    estimator = Estimator(port, "float32", torch.device("cpu"))
    grid, served_lengths = estimator.predict_decoded(Batch(audio, lengths, languages), heads=tuple(names))
    with torch.no_grad(), full_float32():
        outputs, frames = model_reference(torch.as_tensor(audio), torch.as_tensor(lengths), torch.as_tensor(languages))
    assert served_lengths.tolist() == frames.tolist()
    grid = grid.numpy().astype(np.int64)
    for index, name in enumerate(names):
        sequences = [grid[index, row, 1 : 1 + grid[index, row, 0]] for row in range(len(lengths))]
        tokens, counts = pad_sequences(sequences, "cpu")
        gaps = bottleneck_gaps(torch.log_softmax(outputs[name], dim=-1), frames, tokens, counts)
        assert float(gaps.max()) < 1e-3, (name, gaps)


def _attention_inputs(time=100, lengths=(100, 77, 0), heads=4, head_dim=8, seed=0):
    generator = torch.Generator().manual_seed(seed)
    width = heads * head_dim
    qkv = torch.randn(len(lengths), time, 3 * width, generator=generator)
    table = torch.randn(73, head_dim, generator=generator) * head_dim**-0.5
    valid = torch.arange(time)[None] < torch.as_tensor(lengths)[:, None]
    return qkv, table, valid


def test_the_k7_twin_matches_transformers_attention():
    """K7's twin against transformers' relative-key ``Wav2Vec2BertSelfAttention``
    (einsum over the gathered distance embeddings, its own q, k, v
    projections), float32: at T = 100 (keys more than 64 frames behind and
    more than 8 ahead of their queries), T not a multiple of the 64-key
    tile, a row with padded keys and a zero-length row, whose output both
    take over every key with the same -1e9-like bias (transformers' is
    float32's least value, the port's -1e9; the row's scores are all masked
    alike, so the softmax is uniform in both). Summation order: 1e-5."""
    heads, head_dim, time = 4, 8, 100
    width = heads * head_dim
    config = Wav2Vec2BertConfig(hidden_size=width, num_attention_heads=heads, attention_dropout=0.0)
    attention = Wav2Vec2BertSelfAttention(config).eval()
    generator = torch.Generator().manual_seed(1)
    hidden = torch.randn(3, time, width, generator=generator)
    lengths = torch.tensor([100, 77, 0])
    valid = torch.arange(time)[None] < lengths[:, None]
    mask = (~valid)[:, None, None, :].float() * torch.finfo(torch.float32).min
    with torch.no_grad():
        expected = attention(hidden, attention_mask=mask.expand(3, 1, time, time))[0]
        qkv = torch.cat([layer(hidden) for layer in (attention.linear_q, attention.linear_k, attention.linear_v)], dim=-1)
        query, key, value = qkv.split(width, dim=-1)
        bias = torch.zeros(3, time).masked_fill(~valid, -1e9)
        context = relkey_attention(
            query, key, value, bias, attention.distance_embedding.weight, head_dim**-0.5, heads, 64, 8
        )
        got = attention.linear_out(context)
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-5)


def test_the_k7_twin_in_bf16_follows_its_float32_form():
    """The bf16 twin (the card's arithmetic: bf16 q, k, v and table, f32
    scores, bf16 weights and output) against the float32 twin of the same
    bf16-rounded inputs: the weights' and the output's rounding, under 2^-7
    of the output's scale."""
    qkv, table, valid = _attention_inputs()
    bias = torch.zeros(valid.shape).masked_fill(~valid, -1e9)
    rounded = qkv.to(torch.bfloat16)
    low = reference_relkey_attention(*rounded.split(32, dim=-1), bias, table.to(torch.bfloat16), 8**-0.5, 4, 64, 8)
    high = reference_relkey_attention(*rounded.float().split(32, dim=-1), bias, table.to(torch.bfloat16).float(), 8**-0.5, 4, 64, 8)
    assert low.dtype == torch.bfloat16
    scale = high[valid].square().mean().sqrt()
    assert float((low.float() - high)[valid].abs().max()) < 2**-7 * float(scale) * 4


def test_the_k7_wrapper_checks_its_table_and_counts_calls():
    qkv, table, valid = _attention_inputs(time=9, lengths=(9, 4, 1))
    query, key, value = qkv.split(32, dim=-1)
    bias = torch.zeros(valid.shape).masked_fill(~valid, -1e9)
    with pytest.raises(ValueError, match="73 distances"):
        relkey_attention(query, key, value, bias, table[:72], 8**-0.5, 4, 64, 8)
    with tracing.recording() as counts:
        relkey_attention(query, key, value, bias, table, 8**-0.5, 4, 64, 8)
    assert counts == {"relkey_attention_calls": 1}


def test_the_encoder_traces_its_front_end_and_k7_calls(allophant):
    """Under a recording, a forward opens the ``encoder.frontend`` span and
    counts one K7 call a layer; off (the default), nothing is counted."""
    port, _, _ = allophant
    audio, lengths = torch.as_tensor(_audio()), torch.as_tensor(LENGTHS)
    with torch.no_grad(), torch.profiler.profile() as profiler, tracing.recording() as counts:
        port.acoustic_model(audio, lengths)
    assert counts == {"relkey_attention_calls": TINY["num_hidden_layers"]}
    assert any(event.name == tracing.PREFIX + "encoder.frontend" for event in profiler.events())
    with torch.no_grad():
        port.acoustic_model(audio, lengths)
    assert tracing._counts == {}


@pytest.mark.parametrize(
    "change, message",
    [({"hidden_act": "gelu"}, "implements"), ({"add_adapter": True}, "implements"), ({"stride": 3}, "num_mel_bins")],
    ids=["activation", "adapter", "stride"],
)
def test_the_architecture_raises_on_what_the_port_does_not_implement(change, message):
    with pytest.raises(ValueError, match=message):
        Wav2Vec2BertArchitecture(**{**TINY, **change})


def test_the_encoder_serves_only():
    """No dropout forward, no remat, no tensor parallelism: each raises
    rather than serving something else."""
    arch = Wav2Vec2BertArchitecture(**TINY)
    model = PortModel(arch, device="meta")
    with pytest.raises(ValueError, match="no dropout"):
        model(torch.zeros(1, 16_000), torch.tensor([16_000]), rng=object())
    with pytest.raises(ValueError, match="no remat"):
        _flagship_build(arch, torch.float32, None, "meta", remat=True)
    assert arch.downsampled_lengths(np.array([399, 400, 24_000, 7_513])).tolist() == [0, 0, 74, 22]
