"""The tester's policies: an unknown one raises a ValueError at entry, in
``compute_trajectory``, ``run_test``, ``run_suite_eval`` and the suite
CLI's ``--policies``, before any set-up, capture or file. The three
policies pass the check (their trajectories are held elsewhere:
``test_torch_port_suite.py``, ``test_torch_port_trajectory.py``)."""

import os

import pytest

from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data import synthetic_suite
from macarons_tpu_torch.testers import scene as tester

UNKNOWN = ["greedy", "NBV", "", "nbv,random"]


@pytest.mark.parametrize("policy", tester.POLICIES)
def test_known_policies(policy):
    assert tester.check_policy(policy) is None


@pytest.mark.parametrize("policy", UNKNOWN)
def test_compute_trajectory_raises(policy):
    # Nothing of the runtime, the scene or the memory is touched first.
    with pytest.raises(ValueError, match="unknown policy"):
        tester.compute_trajectory(None, None, None, "", None, None, 3, 0.0,
                                  policy=policy)


def test_run_test_raises(tmp_path):
    results = tmp_path / "results"
    with pytest.raises(ValueError, match="nbv, random, carving"):
        tester.run_test(Params({}), data_path=str(tmp_path / "none"),
                        results_dir=str(results), policy="greedy",
                        device="cpu", verbose=False)
    assert not results.exists()


def test_run_suite_eval_raises(tmp_path):
    out = tmp_path / "out" / "r.json"
    with pytest.raises(ValueError, match="'greedy'"):
        synthetic_suite.run_suite_eval(
            str(tmp_path / "none"), str(out), policies=("nbv", "greedy"),
            device="cpu", verbose=False)
    assert not out.parent.exists()


def test_suite_cli_policies_raise(tmp_path):
    root = tmp_path / "suite"
    with pytest.raises(ValueError, match="'carve'"):
        synthetic_suite.main(["eval", str(root), "--policies",
                              "random,carve", "--device", "cpu",
                              "--out", str(tmp_path / "r.json")])
    # The suite was not generated first.
    assert not os.path.exists(root)
