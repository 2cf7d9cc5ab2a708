"""PyTorch port: the text corpus path (``--dataset text``, byte-level and
BPE) against the JAX package on the CPU.

On small corpora written to ``tmp_path``: ``text_clm``'s windows and
token ids equal JAX's, byte-level and BPE (trained with ``tokenizers``
on the corpus; each package trains its own cache file); ``text_codec``
round-trips and encodes as JAX's; the corpus and config refusals are
JAX's word for word; a 5-step byte-level GPT ``train()`` follows JAX's
to 1e-4; ``--mode generate`` with a text prompt and the serve request
file's ``text`` key encode as JAX's, on a checkpoint both packages read.
"""

import importlib.util
import os
import shutil

import jax
import numpy as np
import pytest

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.data import lm as jlm
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.serve import run as jrun
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig, parse_args
from tensorflow_distributed_tpu_torch.data import lm as tlm
from tensorflow_distributed_tpu_torch.serve import run as trun
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401


HAVE_TOKENIZERS = importlib.util.find_spec("tokenizers") is not None
needs_tokenizers = pytest.mark.skipif(
    not HAVE_TOKENIZERS, reason="the BPE path needs the tokenizers package")


def _corpus(path, n=400):
    """Deterministic text with learnable byte patterns and some UTF-8
    (multi-byte) characters."""
    lines = [f"{'abcdefghij'[i % 10]}{i % 10}:" + "abcdefghij"[i % 10:]
             + "abcdefghij"[:i % 10] + (" é→λ" if i % 7 == 0 else "")
             + "\n" for i in range(n)]
    path.write_text("".join(lines), encoding="utf-8")
    return str(path)


def _copy(src, dst_dir):
    """The corpus in another directory: its BPE cache is its own."""
    os.makedirs(dst_dir, exist_ok=True)
    return shutil.copy(src, os.path.join(dst_dir, "corpus.txt"))


def _assert_sets_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.targets, w.targets)
        assert g.tokens.dtype == w.tokens.dtype
        assert g.mask is None and w.mask is None
        assert g.vocab_size == w.vocab_size


@pytest.mark.parametrize("seq_len,seed", [(32, 0), (17, 5)])
def test_byte_windows_equal_jax(seq_len, seed, tmp_path):
    path = _corpus(tmp_path / "c.txt")
    got = tlm.text_clm(path, seq_len=seq_len, seed=seed)
    want = jlm.text_clm(path, seq_len=seq_len, seed=seed)
    _assert_sets_equal(got, want)
    assert got[0].vocab_size == 256 and got[0].tokens.dtype == np.uint8
    batch = got[0].batch(np.arange(3))
    assert batch["tokens"].dtype == batch["targets"].dtype == np.int32
    np.testing.assert_array_equal(batch["mask"], np.ones((3, seq_len)))


@needs_tokenizers
@pytest.mark.parametrize("vocab", [300, 1000])
def test_bpe_windows_and_ids_equal_jax(vocab, tmp_path):
    """Each package trains its own BPE on its own copy of the corpus:
    the windows, the ids (uint16) and the vocab are JAX's, and the cache
    file has JAX's name."""
    path = _corpus(tmp_path / "c.txt")
    port_path = _copy(path, tmp_path / "port")
    jax_path = _copy(path, tmp_path / "jax")
    got = tlm.text_clm(port_path, seq_len=24, seed=1, tokenizer="bpe",
                       bpe_vocab_size=vocab)
    want = jlm.text_clm(jax_path, seq_len=24, seed=1, tokenizer="bpe",
                        bpe_vocab_size=vocab)
    _assert_sets_equal(got, want)
    assert got[0].tokens.dtype == np.uint16
    caches = sorted(os.listdir(tmp_path / "port"))
    assert caches == sorted(os.listdir(tmp_path / "jax"))
    assert any(f.startswith(f"corpus.txt.bpe{vocab}.") for f in caches)


@pytest.mark.parametrize("tokenizer", [
    "byte", pytest.param("bpe", marks=needs_tokenizers)])
def test_text_codec_round_trips_and_encodes_as_jax(tokenizer, tmp_path):
    path = _corpus(tmp_path / "c.txt")
    enc, dec, vocab = tlm.text_codec(_copy(path, tmp_path / "port"),
                                     tokenizer, 500)
    jenc, jdec, jvocab = jlm.text_codec(_copy(path, tmp_path / "jax"),
                                        tokenizer, 500)
    text = "c2:cdefghijab é→λ"
    assert enc(text) == jenc(text) and vocab == jvocab
    assert dec(enc(text)) == text == jdec(jenc(text))


def test_bpe_refusals(tmp_path, monkeypatch):
    """A binary file under bpe gets JAX's UTF-8 message; without the
    tokenizers package bpe is refused naming the byte tokenizer."""
    binary = tmp_path / "b.bin"
    binary.write_bytes(bytes(range(256)) * 8)
    for mod in (tlm, jlm):
        with pytest.raises(ValueError, match="is not valid UTF-8"):
            mod.text_clm(str(binary), seq_len=16, tokenizer="bpe")
    path = _corpus(tmp_path / "c.txt")
    import builtins

    real = builtins.__import__

    def no_tokenizers(name, *a, **k):
        if name.split(".")[0] == "tokenizers":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(RuntimeError, match="--text-tokenizer byte"):
        tlm.text_clm(path, seq_len=16, tokenizer="bpe")


def test_too_small_corpora_are_refused_as_in_jax(tmp_path):
    tiny = tmp_path / "t.txt"
    tiny.write_text("abc")
    for mod in (tlm, jlm):
        with pytest.raises(ValueError, match="< 2 windows of 33"):
            mod.text_clm(str(tiny), seq_len=32)
    small = _corpus(tmp_path / "s.txt", n=40)
    fields = dict(model="gpt_lm", model_size="tiny", dataset="text",
                  data_dir=small, batch_size=32, seq_len=32)
    jcfg = JaxConfig(**fields, mesh=JaxMesh(data=1))
    with pytest.raises(ValueError) as want:  # one data rank, as the port's
        jax_make_task(jcfg, make_mesh(jcfg.mesh, jax.devices()[:1]))
    with pytest.raises(ValueError) as got:
        tloop.train(TrainConfig(**fields, device="cpu"),
                    logger=MetricLogger(enabled=False))
    assert str(got.value) == str(want.value)
    assert "too small" in str(got.value)


@pytest.mark.parametrize("argv,match", [
    (["--dataset", "text", "--synthetic-vocab", "300"],
     "synthetic_vocab has no effect with dataset='text'"),
    (["--text-tokenizer", "wordpiece"], "unknown text_tokenizer"),
    (["--text-tokenizer", "bpe", "--bpe-vocab-size", "70000"],
     r"bpe_vocab_size must be in \[2, 65536\]"),
    (["--data-backend", "arrow"], "unknown data_backend")])
def test_new_fields_are_refused_with_jax_s_messages(argv, match):
    base = ["--model", "gpt_lm"]
    with pytest.raises(ValueError, match=match) as want:
        jax_parse_args(base + argv)
    with pytest.raises(ValueError, match=match) as got:
        parse_args(base + argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_new_fields_have_jax_s_defaults():
    port, ref = TrainConfig(), JaxConfig()
    for name in ("text_tokenizer", "bpe_vocab_size", "data_backend"):
        assert getattr(port, name) == getattr(ref, name), name


# --- train, generate and serve on a byte corpus ---------------------------------

TEXT = dict(model="gpt_lm", model_size="tiny", dataset="text", seq_len=32,
            batch_size=8, train_steps=5, eval_every=0, log_every=1,
            eval_batch_size=8, compute_dtype="float32", dropout_rate=0.0,
            learning_rate=3e-3, seed=0)


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def test_byte_gpt_trajectory_matches_jax_train(tmp_path):
    """5 steps of the byte-level tiny GPT on a corpus from the JAX init:
    the model's vocab is the tokenizer's (256), the losses follow JAX's
    to 1e-4, and the final eval (with perplexity) to 1e-4."""
    fields = dict(TEXT, data_dir=_corpus(tmp_path / "c.txt"))
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    init = interop.params_from_flax(jax.device_get(jstate.params))
    tres = tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)
    assert tres.state.model.cfg.vocab_size == 256
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               rtol=1e-4)
    for k in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(tres.final_metrics[k],
                                   jres.final_metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_generate_and_serve_encode_text_prompts_as_jax(tmp_path):
    """On a JAX checkpoint of the byte GPT: ``--mode generate`` with a
    text prompt gives JAX's tokens and decoded text, and the serve
    request file's ``text`` prompts are JAX's ``_workload``'s ids."""
    corpus = _corpus(tmp_path / "c.txt")
    d = str(tmp_path / "ckpt")
    fields = dict(TEXT, data_dir=corpus, train_steps=2, checkpoint_dir=d,
                  checkpoint_every=2)
    jloop.train(JaxConfig(**fields), logger=JaxLogger(enabled=False))
    gen = dict(fields, mode="generate", prompt="c2:cd", max_new_tokens=6)
    del gen["train_steps"]
    want = jloop.generate_only(JaxConfig(**gen),
                               logger=JaxLogger(enabled=False))
    got = tloop.generate_only(TrainConfig(**gen, device="cpu"),
                              logger=MetricLogger(enabled=False))
    assert got["new_tokens"] == want["new_tokens"]
    assert got["text"] == want["text"] and isinstance(got["text"], str)

    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"text": "a0:abc", "max_new_tokens": 4}\n'
                    '{"prompt": [97, 98], "max_new_tokens": 3}\n'
                    '{"text": "é→λ", "slo": "high"}\n')
    argv = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
            "--dataset", "text", "--data-dir", corpus,
            "--serve.requests", str(reqs)]
    jcfg = jax_parse_args(argv)
    jenc = jlm.text_codec(corpus)[0]
    want_reqs = jrun._workload(jcfg, 256, jenc)
    tcfg = parse_args(argv + ["--device", "cpu"])
    got_reqs = trun._workload(tcfg, 256, tlm.text_codec(corpus)[0])
    assert len(got_reqs) == len(want_reqs) == 3
    for g, w in zip(got_reqs, want_reqs):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.max_new_tokens, g.slo) == (w.max_new_tokens, w.slo)
    assert list(got_reqs[2].prompt) == list("é→λ".encode("utf-8"))


def test_serve_cli_sizes_the_model_by_the_tokenizer(tmp_path, capsys):
    """``--mode serve --dataset text`` from the port's own checkpoint:
    the 256-row model restores, and every text request is served."""
    from tensorflow_distributed_tpu_torch import cli

    corpus = _corpus(tmp_path / "c.txt")
    d = str(tmp_path / "ckpt")
    base = ["--device", "cpu", "--model", "gpt_lm", "--model-size", "tiny",
            "--dataset", "text", "--data-dir", corpus, "--seq-len", "32",
            "--compute-dtype", "float32"]
    assert cli.main(base + ["--batch-size", "8", "--train-steps", "2",
                            "--eval-batch-size", "8", "--eval-every", "0",
                            "--checkpoint-dir", d]) == 0
    reqs = tmp_path / "r.jsonl"
    reqs.write_text('{"text": "b1:bcd", "max_new_tokens": 5}\n'
                    '{"text": "j9:", "max_new_tokens": 5}\n')
    capsys.readouterr()
    assert cli.main(base + ["--mode", "serve", "--checkpoint-dir", d,
                            "--serve.requests", str(reqs),
                            "--serve.num-slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 10 tokens" in out and "checkpoint params" in out
