"""The PyTorch port's FedAvg round against the JAX package's, in bf16: the
converted weights, the aggregate and ``apply_delta`` bit for bit, the local
update and the round within bounds of the reference run without XLA's
excess precision, and that run's distance from the plain one (the tests
and their bounds: ``_torch_federated.py``; f32: ``test_torch_federated.py``)."""
import pytest

from _torch_federated import (BF16_NX, PLAIN_BF16, _few_threads, reference_runs,  # noqa: F401
                              test_aggregate_bit_identical, test_apply_delta_bit_identical,
                              test_bf16_reference_noise, test_converted_weights_bit_identical,
                              test_federated_round_from_reference_params,
                              test_federated_round_two_rounds, test_local_update_matches,
                              test_round_uses_its_own_deltas)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [PLAIN_BF16, BF16_NX])


@pytest.fixture(params=("bfloat16",))
def dtype(request):
    return request.param
