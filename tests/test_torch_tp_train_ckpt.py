"""PyTorch port: tensor parallelism's dropout masks (one per place) and
its checkpoint (the one-process save, byte for byte), over gloo ranks,
against the JAX package on the CPU (split from
``test_torch_tp_train.py``, whose helpers it uses).
"""

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_ring_workers import eval_run, spawn_ranks, train_run
from test_torch_tp_train import GPT, _losses, _ranks
from torch_threads import _one_thread  # noqa: F401


def test_dropout_masks_are_one_per_place(tmp_path):
    """With dropout 0.1 (and clipping, whose norm counts each shard
    once) two model ranks draw the mask one process draws: the same
    losses, and the model ranks' replicated params stay equal."""
    fields = dict(GPT, dropout_rate=0.1, grad_clip_norm=0.5)
    one = tloop.train(TrainConfig(**fields, device="cpu"),
                      logger=MetricLogger(enabled=False))
    spawn_ranks(train_run, 2, tmp_path, fields, None, tmp_path,
                {"model": 2})
    ranks = _ranks(tmp_path, 2)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], _losses(one.logger),
                                   rtol=1e-5)
    for name in ("ln_f.weight", "pos_emb.weight", "layer_0.ln1.bias",
                 "layer_1.attn.out.bias", "tok_emb.weight"):
        assert torch.equal(ranks[0]["params"][name],
                           ranks[1]["params"][name]), name


def test_tp_checkpoint_is_the_one_process_save(tmp_path):
    """3 steps under model 2 with a save at step 3: its state file and
    manifest equal what one process writes of the restored state; it
    resumes to step 5 under model 2 and under one process with the same
    losses, and --mode eval of it under model 2 equals one process's."""
    ck = tmp_path / "tp"
    fields = dict(GPT, train_steps=3, checkpoint_dir=str(ck),
                  checkpoint_every=3)
    spawn_ranks(train_run, 2, tmp_path, fields, None, tmp_path,
                {"model": 2})
    mesh_json = ckpt.read_mesh_manifest(str(ck), 3)
    assert mesh_json["mesh"] == {"data": 1, "seq": 1, "model": 2}
    assert mesh_json["specs"]["params/layer_0/attn/qkv/kernel"] == (
        "PartitionSpec(None, None, 'model', None)")
    one_cfg = TrainConfig(**fields, device="cpu")
    _, state = tloop._build_model_and_state(one_cfg, torch.device("cpu"))
    state = ckpt.restore(str(ck), state)
    assert state.step == 3
    ckpt.save(str(tmp_path / "one"), state)
    for name in ("state.msgpack", "manifest.json"):
        assert ((tmp_path / "one" / "step_00000003" / name).read_bytes()
                == (ck / "step_00000003" / name).read_bytes()), name

    resume = dict(fields, train_steps=5, resume=True, checkpoint_every=0)
    (tmp_path / "r").mkdir()
    spawn_ranks(train_run, 2, tmp_path / "r",
                dict(resume, checkpoint_dir=str(tmp_path / "one")), None,
                tmp_path / "r", {"model": 2})
    one = tloop.train(TrainConfig(**resume, device="cpu"),
                      logger=MetricLogger(enabled=False))
    assert one.state.step == 5
    for got in _ranks(tmp_path / "r", 2):
        assert len(got["losses"]) == 2
        np.testing.assert_allclose(got["losses"], _losses(one.logger),
                                   rtol=1e-5)

    ev = dict(GPT, mode="eval", checkpoint_dir=str(tmp_path / "one"))
    want = tloop.evaluate_only(TrainConfig(**ev, device="cpu"),
                               logger=MetricLogger(enabled=False))
    (tmp_path / "e").mkdir()
    spawn_ranks(eval_run, 2, tmp_path / "e", ev, tmp_path / "e",
                {"model": 2})
    for got in _ranks(tmp_path / "e", 2):
        for k in ("loss", "accuracy", "perplexity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
