"""Port parity: simulation tables, sample schedules and the dataset loaders.

``synthetic_sim_tables`` must come out bitwise identical in both packages
(same numpy draws in the same order), and so must the tables both packages
load from one on-disk tree in the reference's file formats
(``tests/synthetic_tree.py``).  Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim import tables as JT
from mansy_immersivevideostreaming_torch.config import Config as TorchConfig
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import tables as TT


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def assert_tables_equal(port: TT.SimTables, ref: JT.SimTables) -> None:
    for name in TT.SimTables._fields:
        a = getattr(port, name)
        if name == "av_quality":
            assert a is None and ref.av_quality is None
            continue
        b = getattr(ref, name)
        if isinstance(a, torch.Tensor):
            a, b = a.cpu().numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.tobytes() == b.tobytes(), name  # bitwise, signed zeros included
        else:
            assert a == b, name


@pytest.mark.parametrize("shape", [(2, 2, 2, 20, 2, 0), (3, 4, 3, 12, 4, 7)])
def test_synthetic_tables_bitwise(shape):
    *dims, seed = shape
    assert_tables_equal(TT.synthetic_sim_tables(*dims, seed=seed, device="cpu"),
                        JT.synthetic_sim_tables(*dims, seed=seed))


def test_sample_schedules_equal():
    np.testing.assert_array_equal(TE.generate_environment_samples(3, 5, 2, 4),
                                  JE.generate_environment_samples(3, 5, 2, 4))
    np.testing.assert_array_equal(TE.generate_environment_test_samples(2, 3, 2, 4),
                                  JE.generate_environment_test_samples(2, 3, 2, 4))
    np.testing.assert_array_equal(TE.generate_demo_samples(3, 5, 2, 4, 37, seed=9),
                                  JE.generate_demo_samples(3, 5, 2, 4, 37, seed=9))
    np.testing.assert_array_equal(
        TE.generate_demo_samples(3, 5, 2, 4, 20, seed=1, qoe_probs=[0.1, 0.2, 0.3, 0.4]),
        JE.generate_demo_samples(3, 5, 2, 4, 20, seed=1, qoe_probs=[0.1, 0.2, 0.3, 0.4]))


def port_config(cfg) -> TorchConfig:
    """The JAX package's Config as the port's (same schema)."""
    return TorchConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def test_build_sim_tables_from_dataset_tree_bitwise(tmp_path):
    cfg = build_synthetic_tree(str(tmp_path))
    videos, users, traces = [1, 2], [1, 2, 3], [0, 1]
    weights = [[5, 1, 3], [2, 4, 3]]
    ref = JT.build_sim_tables(cfg, "Jin2022", "4G", videos, users, traces, weights)
    port = TT.build_sim_tables(port_config(cfg), "Jin2022", "4G", videos, users, traces,
                               weights, device="cpu")
    assert_tables_equal(port, ref)
