"""The three-axis step of ``chambers_tpu_torch.parallel`` in a world of 8
spawned gloo processes, ``{data: 2, model: 2, expert: 2}`` (the case of
``tests/test_parallel_composition.py``), and the tensor-parallel attention
forward of ``tests/test_parallel.py`` on its ``{data: 2, model: 4}`` mesh,
against the JAX package's single-device results (references and tolerances
as in ``test_torch_parallel.py``)."""

import numpy as np
import pytest

import test_torch_parallel as T


@pytest.fixture(scope="module")
def world():
    results, refs = T.run_checks(8, ["dp_tp_ep_step", "tp_mha"], timeout=600)
    return 8, results, refs


def test_three_axis_dp_tp_ep_train_step_matches_single_device(world):
    out, want = T._result(world, "dp_tp_ep_step"), world[2]["dp_tp_ep_step"]
    # both strategies placed: heads over model, experts over expert
    assert out["specs"] == {"multi_head_attention.w_query":
                            (None, "model", None),
                            "moe.w1": ("expert", None, None)}
    assert out["ep"] == "expert" and out["expert_local"][0] == 2
    np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
    T._close_params(out["params"], want["params"], atol=2e-5)


def test_three_axis_step_is_the_same_on_every_rank(world):
    first = T._result(world, "dp_tp_ep_step", 0)
    for rank in range(1, 8):
        out = T._result(world, "dp_tp_ep_step", rank)
        assert out["loss"] == first["loss"]
        T._close_params(out["params"], first["params"], rtol=0, atol=0)


def test_tensor_parallel_forward_on_eight(world):
    out = T._result(world, "tp_mha")
    assert out["tp"] and out["local_heads"] == 1
    np.testing.assert_allclose(out["out"], world[2]["tp_mha"], atol=1e-5)
