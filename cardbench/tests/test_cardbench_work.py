"""The benchmark's operation and byte counts on hand-worked shapes."""

import pytest

from cardbench.core import peaks, registry
from cardbench.work import k1, k3, k4, k5, model_flops


def test_k1_counts_valid_queries_times_valid_keys():
    # Two rows of a [2, 4, 1 x 2] call, 3 and 2 valid frames.
    bytes_moved, operations = k1.launch_work(4, 1, 2, [3, 2], 2)
    assert operations == 4 * 2 * (3 * 3 + 2 * 2)
    assert bytes_moved == 4 * (3 + 2) * 2 * 2 + 2 * 4 * 4
    # Padded frames need nothing: the same rows padded to 16 frames.
    assert k1.launch_work(16, 1, 2, [3, 2], 2)[1] == operations


def test_k1_rows_without_frames_need_no_products():
    assert k1.launch_work(8, 2, 4, [0, 0], 2)[1] == 0.0


def test_k5_is_k1s_work_and_k4_five_products():
    assert k5.launch_work(6, 2, 8, [5, 6], 2) == k1.launch_work(6, 2, 8, [5, 6], 2)
    bytes_moved, operations = k4.launch_work(6, 2, 8, [5, 6], 2)
    assert operations == 10 * 16 * (25 + 36)
    assert bytes_moved == 7 * 11 * 16 * 2 + 2 * 6 * 4


def test_k3_counts_valid_steps():
    bytes_moved, operations = k3.launch_work(10, 4, 2, [10, 3])
    assert operations == 13 * 2 * 4 * 8
    assert bytes_moved == 13 * 4 * 4 + 2 * 4 + 2 * 10 * 2 * 2 * 4 + 2 * 2 * 4


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 67e12, "float32") == pytest.approx(2.0)


def test_model_flops_by_hand():
    arch = {
        "conv_kernel": [10, 2], "conv_stride": [5, 2], "conv_dim": [4, 4], "hidden_size": 8, "intermediate_size": 16,
        "num_conv_pos_embedding_groups": 2, "num_conv_pos_embeddings": 4, "num_hidden_layers": 1,
    }
    plan = {"nodes": [{"projection_size": 3, "output_size": 3}, {"projection_size": 5, "output_size": 2, "has_composition": True}]}
    # 50 samples -> 9 frames after the first conv -> 4 frames.
    config = {"encoder": "wav2vec2", "architecture": arch}
    serve = model_flops.utterance_flops(config, plan, 50, "bfloat16", "float32", training=False)
    first = 2 * 9 * 1 * 4 * 10
    second = 2 * 4 * 4 * 4 * 2
    projection = 2 * 4 * 4 * 8
    positional = 2 * 4 * 8 * 4 * 4
    layer = 2 * 4 * 8 * (24 + 8 + 32) + 4 * 4 * 4 * 8
    head = 2 * 4 * 8 * 3 + 2 * 4 * 8 * 5 + 2 * 4 * 5 * 2
    assert serve["float32"] == first + head
    assert serve["bfloat16"] == second + projection + positional + layer
    train = model_flops.utterance_flops(config, plan, 50, "bfloat16", "float32", training=True)
    assert train["float32"] == first + 3 * head
    assert train["bfloat16"] == second + 2 * projection + 3 * (positional + layer)


def test_metrics_and_work_are_found_by_name():
    spec = registry.benchmark()
    for workload in spec["workloads"]:
        readers = registry.per_layer(spec, workload["name"])
        for name, reader in readers.items():
            entry = next(entry for entry in spec["per_layer"] if entry["name"] == name)
            assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (entry["layer"], entry["unit"], entry["moves"], entry["source"])
