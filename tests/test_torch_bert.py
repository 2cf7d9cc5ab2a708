"""PyTorch port: BERT masked LM (``bert_mlm``) against the JAX package on
the CPU.

The tiny BERT's logits, masked cross-entropy and every gradient match
the flax ``BertMLM`` at 1e-5 in f32 on the same weights (the [MASK]
sentinel row widens the input table to [V + 1, D]; the logits, and the
head a fused loss is handed, cover V), untied and tied; the masked-LM
stream is JAX's bit for bit; 5-step ``train()`` trajectories with the
dense head and the scan CE follow JAX's to 1e-4; the checkpoint layout
carries the [V + 1, D] table; and the config refuses what JAX refuses.
"""

import dataclasses

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.ops.losses import (
    masked_softmax_cross_entropy as jax_masked_ce)
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig, parse_args
from tensorflow_distributed_tpu_torch.data import lm as tlm
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.ops.losses import (
    masked_softmax_cross_entropy)
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401


BERT = dict(model="bert_mlm", model_size="tiny", seq_len=32, batch_size=8,
            train_steps=5, eval_every=0, log_every=1, eval_batch_size=64,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_tiny_bert_logits_loss_grads_match_flax(tie):
    jmodel = jtr.bert_tiny_mlm(tie_embeddings=tie)
    tmodel = ttr.bert_tiny_mlm(tie_embeddings=tie)
    ds = tlm.synthetic_mlm(n=2, seq_len=16, vocab_size=64, seed=0)
    tokens, targets, mask = ds.tokens, ds.targets, ds.mask
    assert tokens.max() == 64  # the [MASK] id: the sentinel row is read
    params = nn.meta.unbox(jmodel.init(jax.random.key(0), tokens,
                                       train=False)["params"])

    def jloss(p):
        logits = jmodel.apply({"params": p}, tokens, train=False)
        return jax_masked_ce(logits, targets, mask), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    state = interop.params_from_flax(jax.device_get(params))
    assert state["tok_emb.weight"].shape == (65, 32)
    tmodel.load_state_dict(state)
    t_logits = tmodel(torch.from_numpy(tokens))
    assert t_logits.shape == (2, 16, 64)
    t_loss = masked_softmax_cross_entropy(
        t_logits, torch.from_numpy(targets), torch.from_numpy(mask))
    t_loss.backward()
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=1e-5)
    assert abs(float(t_loss.detach()) - float(j_loss)) <= 1e-5
    want = interop.params_from_flax(jax.device_get(j_grads))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    feats, w, bias = tmodel(torch.from_numpy(tokens), features_only=True)
    jfeats, jw, jbias, v_axis = jmodel.apply(
        {"params": params}, tokens, train=False, features_only=True)
    assert w.shape == (64, 32) and np.asarray(jw).shape[v_axis] == 64
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats),
                               atol=1e-5)
    assert (bias is None) == (jbias is None) == tie


def test_bert_base_shapes_and_refusals():
    """BERT-base is the config's default (12 x 768, 12 heads, vocab 30522
    + [MASK], L 512, bidirectional); a decode cache needs a causal
    config, as in JAX."""
    cfg = ttr.bert_base_config()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.d_ff, cfg.max_len, cfg.causal) == (
        30522, 768, 12, 12, 3072, 512, False)
    assert cfg == ttr.TransformerConfig(**{
        k: getattr(jtr.bert_base_config(), k) for k in (
            "vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
            "max_len", "dropout_rate", "causal")})
    with pytest.raises(ValueError, match="size 'small'"):
        ttr.bert_base_mlm(size="small")
    model = ttr.bert_tiny_mlm()
    cache = ttr.KVCache.zeros(dataclasses.replace(model.cfg, causal=True), 1)
    with pytest.raises(ValueError, match="causal"):
        model(torch.zeros((1, 1), dtype=torch.long), decode=True,
              positions=torch.tensor([[0]]), cache=cache)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mlm_is_jax_s_bit_for_bit(seed):
    from tensorflow_distributed_tpu.data import lm as jlm

    got = tlm.synthetic_mlm(n=64, seq_len=24, vocab_size=50, seed=seed)
    want = jlm.synthetic_mlm(n=64, seq_len=24, vocab_size=50, seed=seed)
    for k in ("tokens", "targets", "mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    assert got.vocab_size == want.vocab_size == 50
    batch = got.batch(np.arange(4))
    assert batch["tokens"].dtype == np.int32
    assert (batch["mask"].sum(1) >= 1).all()


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


@pytest.mark.parametrize("extra", [{}, dict(ce_chunk=16)],
                         ids=["dense", "scan"])
def test_bert_trajectory_matches_jax_train(extra):
    """5 steps of the tiny BERT on the synthetic masked-LM stream, from
    the JAX init: the losses to 1e-4, and the final eval (no perplexity:
    a masked LM)."""
    fields = dict(BERT, **extra)
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    init = interop.params_from_flax(jax.device_get(jstate.params))
    tres = tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               rtol=1e-4)
    assert set(tres.final_metrics) == set(jres.final_metrics) == {
        "loss", "accuracy"}
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(tres.final_metrics[k],
                                   jres.final_metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_bert_eval_of_a_jax_checkpoint_matches_jax(tmp_path):
    """``--mode eval`` of a JAX BERT checkpoint (the [V + 1, D] table)
    gives JAX's metrics to 1e-5."""
    d = str(tmp_path)
    fields = dict(BERT, train_steps=2, checkpoint_dir=d, checkpoint_every=2)
    jloop.train(JaxConfig(**fields), logger=JaxLogger(enabled=False))
    ev = dict(fields, mode="eval")
    del ev["train_steps"]
    want = jloop.evaluate_only(JaxConfig(**ev),
                               logger=JaxLogger(enabled=False))
    got = tloop.evaluate_only(TrainConfig(**ev, device="cpu"),
                              logger=MetricLogger(enabled=False))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_bert_table_round_trips_through_the_flax_layout():
    model = ttr.bert_tiny_mlm(tie_embeddings=True)
    model.init_weights(torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    tree = interop.params_to_flax(params, model)
    assert tree["tok_emb"]["embedding"].shape == (65, 32)
    back = interop.params_from_flax(tree)
    for name, p in params.items():
        assert torch.equal(back[name], p.detach()), name


def test_bert_trains_on_a_gpu_only_in_bfloat16():
    """BERT is an LM family: training it in f32 on a GPU is refused, as
    the GPT's is (the flash kernels take bf16)."""
    with pytest.raises(NotImplementedError, match="bfloat16"):
        parse_args(["--model", "bert_mlm", "--compute-dtype", "float32"])


@pytest.mark.parametrize("argv,match", [
    (["--attn-window", "8"], "attn_window needs a causal LM family"),
    (["--mode", "serve"], "mode=serve needs a causal LM"),
    (["--mode", "generate", "--checkpoint-dir", "/x", "--prompt", "1"],
     "mode=generate needs a causal LM")])
def test_config_refuses_what_jax_refuses(argv, match):
    base = ["--model", "bert_mlm", "--device", "cpu"]
    with pytest.raises(ValueError, match=match):
        parse_args(base + argv)
    jax_argv = [a for a in base + argv if a not in ("--device", "cpu")]
    from tensorflow_distributed_tpu.config import parse_args as jax_parse

    with pytest.raises(ValueError, match=match):
        jax_parse(jax_argv)


def test_bert_on_text_is_refused_with_jax_s_message(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"abcdefgh" * 200)
    fields = dict(BERT, dataset="text", data_dir=str(corpus))
    with pytest.raises(ValueError) as want:
        jcfg = JaxConfig(**fields)
        jax_make_task(jcfg, make_mesh(jcfg.mesh))
    with pytest.raises(ValueError) as got:
        tloop.train(TrainConfig(**fields, device="cpu"),
                    logger=MetricLogger(enabled=False))
    assert str(got.value) == str(want.value)
    assert "bert_mlm has no byte-masking stream" in str(got.value)


def test_bert_cli_trains_on_cpu(capsys):
    from tensorflow_distributed_tpu_torch import cli

    argv = ["--device", "cpu", "--model", "bert_mlm", "--model-size", "tiny",
            "--batch-size", "8", "--train-steps", "2", "--eval-batch-size",
            "64", "--compute-dtype", "float32", "--eval-every", "0",
            "--log-every", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"task": "mlm"' in out and '"tokens_per_sec"' in out
