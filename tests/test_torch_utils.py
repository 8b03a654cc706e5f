"""The port's ``utils/prng.py``, ``utils/profiling.py`` and TensorBoard
scalars.

* ``seed_everything`` seeds ``random``, numpy's and torch's global
  generators and returns a generator with the seed's stream.
* ``timed`` prints ``[label] x.xxxs`` and waits for the card (a recorder
  in place of ``torch.cuda.synchronize`` here) when nothing is watched;
  ``profile_to`` writes a Chrome trace file holding the ``trace`` label,
  as ``tests/test_profiling.py`` holds the JAX package's capture.
* ``run_mansy --train`` and ``run_simple_rl --train`` write the JAX CLIs'
  TensorBoard scalars: the same tags at the same steps as the JAX CLIs'
  event files on the same synthetic tree, and the values the port's own
  console prints (``train/reward`` to the console's 4 decimals, the loss
  terms of ``run_mansy`` exactly as f32, those of ``run_simple_rl`` to its
  4 decimals).

:func:`tb_scalars` reads an event file's scalars with the protobuf
classes of ``tensorboardX`` (no TensorFlow), whether written as
``simple_value`` (``torch.utils.tensorboard``, the JAX CLIs) or as a
tensor (``tensorboardX``).
"""

import glob
import json
import os
import random
import re
import struct
import sys

import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_tpu.cli import run_mansy as jax_run_mansy
from mansy_immersivevideostreaming_tpu.cli import run_simple_rl as jax_run_simple_rl
from mansy_immersivevideostreaming_torch.cli import run_mansy, run_simple_rl
from mansy_immersivevideostreaming_torch.utils import profiling
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything
from test_torch_tables import port_config

EVENTS = "events.out.tfevents"
MANSY = ["--train", "--use-identifier", "--train-identifier", "--epochs", "2",
         "--step-per-epoch", "64", "--step-per-collect", "64", "--train-lanes", "8",
         "--batch-size", "64", "--hidden-dim", "16", "--save-interval", "1", "--seed", "3"]
SIMPLE = ["--train", "--qoe-train-id", "0", "--epochs", "2", "--step-per-epoch", "64",
          "--step-per-collect", "64", "--train-lanes", "8", "--batch-size", "32"]
DECIMALS = 5e-5   # a console number printed with 4 decimals


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tb_scalars(log_dir: str) -> list:
    """[(tag, step, value)] of every event file under ``log_dir``, in the
    order written."""
    from tensorboardX.proto import event_pb2

    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, EVENTS + "*"))):
        with open(path, "rb") as f:
            data = f.read()
        at = 0
        while at < len(data):  # TFRecord: u64 length, u32 crc, data, u32 crc
            (n,) = struct.unpack("<Q", data[at:at + 8])
            event = event_pb2.Event.FromString(data[at + 12:at + 12 + n])
            at += 16 + n
            for v in event.summary.value:
                value = v.simple_value if v.WhichOneof("value") == "simple_value" \
                    else v.tensor.float_val[0]
                out.append((v.tag, event.step, value))
    return out


# ------------------------------------------------------------- prng

def test_seed_everything_seeds_every_stream():
    gen = seed_everything(7)
    first = (random.random(), np.random.rand(3), torch.rand(3), torch.rand(3, generator=gen))
    gen = seed_everything(7)
    again = (random.random(), np.random.rand(3), torch.rand(3), torch.rand(3, generator=gen))
    assert first[0] == again[0]
    for a, b in zip(first[1:], again[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the returned generator's stream is the seed's, apart from the global one
    np.testing.assert_array_equal(
        torch.rand(3, generator=seed_everything(7)).numpy(),
        torch.rand(3, generator=torch.Generator().manual_seed(7)).numpy())
    assert seed_everything(7, "cpu").device.type == "cpu"
    assert random.Random(7).random() == first[0]
    np.testing.assert_array_equal(np.random.RandomState(7).rand(3), first[1])


# ------------------------------------------------------------- profiling

def test_timed_waits_on_watched_work_and_prints_its_label(capsys):
    x = torch.ones((256, 256))
    with profiling.timed("matmul") as t:
        out = t.watch(x @ x)
    assert t.seconds is not None and t.seconds >= 0
    assert float(out[0, 0]) == 256.0
    assert re.search(r"^\[matmul\] [0-9]+\.[0-9]{3}s$", capsys.readouterr().out, re.M)


def test_timed_waits_for_the_card_when_nothing_is_watched(capsys, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    with profiling.timed("empty"):
        pass
    assert synced == [None]
    with profiling.timed("host") as t:  # a CPU tensor is done when its op returns
        t.watch((torch.ones(4), [torch.zeros(2)]))
    assert synced == [None]
    out = capsys.readouterr().out
    assert "[empty]" in out and "[host]" in out


def test_profile_to_writes_a_trace_file(tmp_path):
    target = str(tmp_path / "prof")
    with profiling.profile_to(target):
        with profiling.trace("annotated_block"):
            torch.ones((64, 64)).sum()
    (path,) = glob.glob(os.path.join(target, "*.json"))
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "annotated_block" for e in trace["traceEvents"])


# ------------------------------------------------------------- TensorBoard

def _run_jax(cli, argv, cfg, monkeypatch):
    """The JAX CLI's run, its writer flushed after each scalar (it never
    closes it: its events would wait for the writer's two-minute flush)."""
    assert cli.SummaryWriter is not None, "the JAX CLI writes no TensorBoard scalars here"

    class Flushed(cli.SummaryWriter):
        def add_scalar(self, *args, **kwargs):
            super().add_scalar(*args, **kwargs)
            self.flush()

    monkeypatch.setattr(cli, "SummaryWriter", Flushed)
    stdout = sys.stdout
    try:  # the JAX CLIs tee stdout into their console.log and leave it so
        cli.run(cli.build_parser().parse_args(argv), cfg)
    finally:
        sys.stdout = stdout


def _tags_steps(scalars):
    """The (tag, step) pairs, sorted: the JAX CLIs write a step's metrics in
    the sorted key order of a pytree, the port in the update's order."""
    return sorted((tag, step) for tag, step, _ in scalars)


def _steps(printed, tags):
    """{(tag, step): number} of the console's epochs, 64 env steps each."""
    return {(tag, 64 * (i // len(tags) + 1)): x
            for i, (tag, x) in enumerate(zip(tags * (len(printed) // len(tags)), printed))}


def test_run_mansy_scalars_match_the_jax_cli(tmp_path, monkeypatch):
    jcfg = build_synthetic_tree(str(tmp_path / "jax"))
    _run_jax(jax_run_mansy, MANSY, jcfg, monkeypatch)
    (jdir,) = glob.glob(str(tmp_path / "jax" / "models" / "**" / "mansy_tb_logger"),
                        recursive=True)
    pcfg = port_config(build_synthetic_tree(str(tmp_path / "port")))
    run_mansy.run(run_mansy.build_parser().parse_args(MANSY + ["--device", "cpu"]), pcfg)
    (pdir,) = glob.glob(str(tmp_path / "port" / "models" / "**" / "mansy_tb_logger"),
                        recursive=True)
    got, want = tb_scalars(pdir), tb_scalars(jdir)
    assert len(got) == 10 and _tags_steps(got) == _tags_steps(want)

    with open(os.path.join(os.path.dirname(pdir), "console.log")) as f:
        console = f.read()
    rewards = [float(x) for x in re.findall(r"valid mean return (-?[0-9.]+)", console)]
    losses = re.findall(r"^loss: (\S+)  ---  loss/clip: (\S+)  ---  loss/vf: (\S+)  ---  "
                        r"loss/ent: (\S+)$", console, re.M)
    assert len(rewards) == len(losses) == 2
    printed = []
    for reward, terms in zip(rewards, losses):
        printed += [reward] + [float(x) for x in terms]
    printed = _steps(printed, ["train/reward", "loss", "loss/clip", "loss/vf", "loss/ent"])
    for tag, step, value in got:
        if tag == "train/reward":
            assert abs(value - printed[tag, step]) <= DECIMALS, tag
        else:
            assert value == np.float32(printed[tag, step]), tag


def test_run_simple_rl_scalars_match_the_jax_cli(tmp_path, monkeypatch):
    jcfg = build_synthetic_tree(str(tmp_path / "jax"))
    _run_jax(jax_run_simple_rl, SIMPLE, jcfg, monkeypatch)
    (jdir,) = glob.glob(str(tmp_path / "jax" / "models" / "**" / "*_tb"), recursive=True)
    pcfg = port_config(build_synthetic_tree(str(tmp_path / "port")))
    run_simple_rl.run(run_simple_rl.build_parser().parse_args(SIMPLE + ["--device", "cpu"]),
                      pcfg)
    (pdir,) = glob.glob(str(tmp_path / "port" / "models" / "**" / "*_tb"), recursive=True)
    got, want = tb_scalars(pdir), tb_scalars(jdir)
    assert len(got) == 10 and _tags_steps(got) == _tags_steps(want)

    (log,) = glob.glob(os.path.join(os.path.dirname(pdir), "*console.log"))
    with open(log) as f:
        lines = re.findall(r"valid mean return (-?[0-9.]+) .* loss (-?[0-9.]+) \(actor "
                           r"(-?[0-9.]+), vf (-?[0-9.]+), ent (-?[0-9.]+)\)", f.read())
    assert len(lines) == 2
    printed = _steps([float(x) for line in lines for x in line],
                     ["train/reward", "loss", "loss/actor", "loss/vf", "loss/ent"])
    for tag, step, value in got:
        assert abs(value - printed[tag, step]) <= DECIMALS, tag
