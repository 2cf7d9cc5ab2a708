"""PyTorch port: data 2 x seq 2 (four gloo ranks) through ``train()``
against the JAX package's mesh on the CPU (split from
``test_torch_data_parallel.py``, whose helpers it uses).
"""

import numpy as np
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from torch_ring_workers import spawn_ranks, train_run
from test_torch_data_parallel import (
    TINY_LM, _jax_run_and_init, _losses, _port_run)
from torch_threads import _one_thread  # noqa: F401


def test_gpt_data2_seq2_trajectory_matches_jax(tmp_path):
    """gpt_lm over (data 2, seq 2): 4 gloo ranks, two data rows of
    two-position rings (ring attention inside each row, gradients summed
    over all four), from the JAX init: the losses equal JAX's on its
    (data 4, seq 2) mesh to 1e-4 (the same global batch and math) and
    the port's one process to 1e-5."""
    jres, init = _jax_run_and_init(TINY_LM, JaxMesh(data=4, seq=2))
    torch.save(init, tmp_path / "init.pt")
    spawn_ranks(train_run, 4, tmp_path, TINY_LM, tmp_path / "init.pt",
                tmp_path, {"data": 2, "seq": 2})
    one = _port_run(TINY_LM, init)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for rank in ranks:
        assert len(rank["losses"]) == 3
        np.testing.assert_allclose(rank["losses"], _losses(jres.logger),
                                   atol=1e-4)
        np.testing.assert_allclose(rank["losses"], _losses(one.logger),
                                   atol=1e-5)
        np.testing.assert_allclose(rank["final"]["loss"],
                                   jres.final_metrics["loss"], atol=1e-4)
        for name, value in rank["params"].items():
            assert torch.equal(value, ranks[0]["params"][name]), name
