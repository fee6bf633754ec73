"""The PyTorch port's FedAvg round against the JAX package's, in f32: the
token batches, the converted weights, the aggregate and ``apply_delta``
bit for bit, the local update and the round within bounds, and the wire
round bit for bit (the tests and their bounds: ``_torch_federated.py``;
bf16: ``test_torch_federated_bf16.py``)."""
import pytest

from _torch_federated import (PLAIN_F32, _few_threads, reference_runs,  # noqa: F401
                              test_aggregate_bit_identical, test_apply_delta_bit_identical,
                              test_converted_weights_bit_identical,
                              test_federated_round_from_reference_params,
                              test_federated_round_two_rounds, test_local_update_matches,
                              test_reference_wire_round_same_words, test_round_uses_its_own_deltas,
                              test_token_batches_identical, test_wire_round_bit_identical)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [PLAIN_F32])


@pytest.fixture(params=("float32",))
def dtype(request):
    return request.param
