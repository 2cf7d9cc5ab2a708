"""PyTorch port: the CLI trains on the CPU (the tiny GPT with the dense
head and the fused loss, the MNIST CNN with the chief's performance
table), and a bare call selects the ported default model (split from
``test_torch_train.py``).
"""

import pytest
import torch

from tensorflow_distributed_tpu_torch import cli
from tests.conftest import FIXTURE_DIR
from torch_threads import _one_thread  # noqa: F401


def test_cli_trains_fused_on_cpu(capsys):
    """The tentpole command at tiny size on the CPU, with the kernels'
    plain versions."""
    argv = ["--device", "cpu", "--mode", "train", "--model", "gpt_lm",
            "--model-size", "tiny", "--ce-chunk", "32", "--ce-impl",
            "kernel", "--seq-len", "64", "--batch-size", "8",
            "--train-steps", "3", "--eval-every", "0", "--eval-batch-size",
            "8", "--log-every", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"event": "done"' in out and "val_loss" in out
    assert out.count("[step") == 3  # the final eval is in the done record


def test_cli_trains_end_to_end_on_cpu(capsys):
    argv = ["--mode", "train", "--model", "gpt_lm", "--model-size", "tiny",
            "--seq-len", "64", "--batch-size", "8", "--train-steps", "4",
            "--eval-every", "2", "--eval-batch-size", "8", "--log-every",
            "1", "--compute-dtype", "float32", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"event": "done"' in out and "val_loss" in out
    assert out.count("[step") == 4 + 2  # 4 train records, 2 eval records


def test_bare_cli_call_refuses_the_unported_default_model(capsys):
    """The bare call now selects the ported mnist_cnn; on a machine
    without CUDA it is refused by the device, with the fix named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        cli.main([])


def test_cli_trains_mnist_cnn_on_cpu_and_prints_the_table(capsys):
    """A few steps of the reference's job on the committed fixture, then
    the chief's performance table (one row per eval)."""
    argv = ["--device", "cpu", "--data-dir", FIXTURE_DIR,
            "--validation-size", "64", "--batch-size", "32",
            "--train-steps", "4", "--eval-every", "2", "--log-every", "2",
            "--eval-batch-size", "64"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"images_per_sec"' in out
    assert '"mesh": {"data": 1, "seq": 1, "model": 1}' in out
    table = out[out.index("Steps,        Time,"):].strip().splitlines()
    assert len(table) == 3 and table[1].startswith("2,")
    assert table[2].startswith("4,") and table[2].endswith("0.001")
