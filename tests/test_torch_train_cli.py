"""The port's training launcher, ``python -m repro_torch.launch.train``, on
the CPU: ``--device cpu --reduced`` for Granite-MoE and Whisper (its
batches carry the reference launcher's stub frames), 3 steps each,
printing the reference launcher's lines (``step ... loss ... gnorm ...
lr ...`` at its steps and ``done: ... tok/s``), finite, and a ``--save``
that ``checkpoint.load_pytree`` reads back equal to the trained params;
the stub extras equal the reference launcher's; and the default device
is the card, which raises without CUDA.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import train
from repro_torch.training.optimizer import tree_leaves_with_path
from test_torch_training import one_cpu_thread  # noqa: F401

STEP = re.compile(r"^step +(\d+) loss +(-?[\d.]+) gnorm +([\d.]+) "
                  r"lr (\d\.\d\de[-+]\d\d)$")
DONE = re.compile(r"^done: 3 steps in [\d.]+s \(\d+ tok/s\)$")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-medium"])
def test_reduced_cpu_run_prints_the_reference_lines_and_saves(
        arch, tmp_path, capsys):
    path = str(tmp_path / "params")
    out = train.main(["--arch", arch, "--reduced", "--steps", "3",
                      "--batch", "2", "--seq", "24", "--device", "cpu",
                      "--save", path])
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [STEP.match(ln) for ln in lines[:3]]
    assert all(steps), lines
    assert [int(m.group(1)) for m in steps] == [0, 1, 2]
    assert all(np.isfinite(float(m.group(2))) for m in steps)
    assert DONE.match(lines[3]), lines[3]
    assert lines[4] == f"saved {path}"
    params = out["state"]["params"]
    back = load_pytree(path, params)
    for (p, x), (q, y) in zip(tree_leaves_with_path(back),
                              tree_leaves_with_path(params)):
        assert p == q and x.dtype == y.dtype and torch.equal(x, y.detach())
    assert out["state"]["opt"]["step"] == 3


def test_extras_are_the_reference_launcher_stubs():
    whisper = reduced(get_config("whisper-medium"))
    pali = reduced(get_config("paligemma-3b"))
    frames = train.extras_of(whisper)["frames"](2)
    assert frames.shape == (2, whisper.enc_seq, whisper.d_model)
    assert np.array_equal(frames, np.random.default_rng(0).standard_normal(
        (2, whisper.enc_seq, whisper.d_model), dtype=np.float32))
    assert set(train.extras_of(pali)) == {"img_embeds"}
    assert train.extras_of(get_config("edge-ladder")) == {}


def test_train_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "edge-ladder", "--steps", "1"])
