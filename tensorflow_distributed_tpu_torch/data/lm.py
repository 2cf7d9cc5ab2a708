"""LM data (numpy): the port of ``data/lm.py``: ``LmDataset``, the
synthetic masked-LM and causal-LM streams, the local text corpus path
(byte-level, or a byte-level BPE trained on the corpus) and
``LmBatcher``.

The generators draw from ``np.random.default_rng(seed)`` in the same
order as the JAX package, so both packages train on identical token
streams for the same seed, and the text path's windows and token ids
are the JAX package's for the same file. Batch layout: ``tokens``,
``targets`` and ``mask``, each [B, L] (for MLM, ``tokens`` carries the
[MASK] id ``vocab_size`` at the masked positions and ``mask`` is 1.0
there).

The BPE path needs the ``tokenizers`` package, imported only when it
is asked for; without it ``tokenizer="bpe"`` raises.
"""

from __future__ import annotations

import array
import codecs
import dataclasses
import hashlib
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tensorflow_distributed_tpu_torch.data.batcher import Batcher


@dataclasses.dataclass
class LmDataset:
    tokens: np.ndarray    # [N, L] inputs (MLM: [MASK] applied)
    targets: np.ndarray   # [N, L] next-token (CLM) or original (MLM) ids
    # [N, L] float {0,1}; None = all-ones, synthesized per batch (a text
    # corpus: no corpus-sized constant on the host).
    mask: Optional[np.ndarray]
    vocab_size: int

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # Storage may be narrow (uint8 / uint16 corpora); models take
        # int32, cast per batch.
        tokens = self.tokens[idx].astype(np.int32, copy=False)
        targets = self.targets[idx].astype(np.int32, copy=False)
        mask = (np.ones(targets.shape, np.float32) if self.mask is None
                else self.mask[idx])
        return {"tokens": tokens, "targets": targets, "mask": mask}


def synthetic_mlm(n: int = 2048, seq_len: int = 128, vocab_size: int = 64,
                  mask_rate: float = 0.15, seed: int = 0) -> LmDataset:
    """Synthetic masked-LM data: each sequence interleaves two period-2
    token streams (a at even positions, b at odd) with sparse
    substitutions, so a masked position is recoverable from its
    unmasked neighbours by attention. About ``mask_rate`` of the
    positions, at least one a row, are masked: the input holds the
    [MASK] id ``vocab_size`` there and the target the original id."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab_size, size=(n, 1))
    b = rng.integers(0, vocab_size, size=(n, 1))
    seq = np.where(np.arange(seq_len)[None, :] % 2 == 0, a, b)
    noise = rng.random((n, seq_len)) < 0.02
    seq = np.where(noise, rng.integers(0, vocab_size, size=(n, seq_len)), seq)
    seq = seq.astype(np.int32)
    mask = rng.random((n, seq_len)) < mask_rate
    mask[~mask.any(axis=1), 0] = True
    tokens = np.where(mask, vocab_size, seq).astype(np.int32)
    return LmDataset(tokens=tokens, targets=seq,
                     mask=mask.astype(np.float32), vocab_size=vocab_size)


def synthetic_clm(n: int = 2048, seq_len: int = 128, vocab_size: int = 64,
                  seed: int = 0) -> LmDataset:
    """Synthetic causal-LM data: each sequence is an arithmetic token
    progression x_t = (start + stride*t) mod V with sparse substitution
    noise — learnable only through causal attention. seq_len+1 tokens
    are generated so targets (inputs shifted left one) are genuine
    continuations; the mask is all-ones."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab_size, size=(n, 1))
    stride = rng.integers(1, 6, size=(n, 1))
    t = np.arange(seq_len + 1)[None, :]
    seq = ((start + stride * t) % vocab_size).astype(np.int32)
    noise = rng.random((n, seq_len + 1)) < 0.02
    seq = np.where(noise, rng.integers(0, vocab_size,
                                       size=(n, seq_len + 1)), seq)
    seq = seq.astype(np.int32)
    return LmDataset(tokens=seq[:, :-1], targets=seq[:, 1:],
                     mask=np.ones((n, seq_len), np.float32),
                     vocab_size=vocab_size)


def _tokenizers():
    try:
        import tokenizers
    except ImportError:
        raise RuntimeError(
            "text_tokenizer='bpe' trains a byte-level BPE with the "
            "'tokenizers' package, which is not installed here; use "
            "--text-tokenizer byte") from None
    return tokenizers


def train_or_load_bpe(path: str, vocab_size: int):
    """A byte-level BPE trained on the local UTF-8 corpus at ``path``
    (``tokenizers``; no download). The vocab is cached next to the
    corpus as ``<path>.bpe<V>.<content hash>.json``, keyed by content so
    an edited corpus retrains; the save is atomic (a temporary file and
    ``os.replace``), so concurrent processes never read a torn file. The
    JAX package's cache name and trainer settings, so either package
    reads the other's cache."""
    tk = _tokenizers()
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    cache = f"{path}.bpe{vocab_size}.{h.hexdigest()[:12]}.json"
    if os.path.exists(cache):
        return tk.Tokenizer.from_file(cache)
    tok = tk.Tokenizer(tk.models.BPE())
    tok.pre_tokenizer = tk.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tk.decoders.ByteLevel()
    tok.train([path], tk.trainers.BpeTrainer(vocab_size=vocab_size,
                                             special_tokens=[],
                                             show_progress=False))
    tmp = f"{cache}.tmp.{os.getpid()}"
    tok.save(tmp)
    os.replace(tmp, cache)
    return tok


def _encode_corpus(path: str, tok) -> np.ndarray:
    """The corpus encoded line by line (overlong lines in 1 MiB chunks)
    into a uint16 buffer; ``newline=""`` keeps the bytes the trainer saw
    (CRLF preserved)."""
    ids = array.array("H")
    lim = 1 << 20
    with open(path, "r", encoding="utf-8", errors="strict",
              newline="") as f:
        for line in f:
            for i in range(0, len(line), lim):
                ids.extend(tok.encode(line[i:i + lim]).ids)
    return np.frombuffer(ids.tobytes(), dtype=np.uint16).copy()


def text_codec(path: str, tokenizer: str = "byte",
               bpe_vocab_size: int = 8192
               ) -> Tuple[Callable[[str], List[int]], Callable, int]:
    """(encode: str -> ids, decode: ids -> str, vocab size) under the
    tokenization ``text_clm`` applies to the corpus at ``path``: what
    ``--mode generate`` and the serve request file's ``text`` key use."""
    if tokenizer == "byte":
        return (lambda s: list(s.encode("utf-8")),
                lambda ids: bytes(int(i) & 0xFF for i in ids).decode(
                    "utf-8", errors="replace"),
                256)
    if tokenizer == "bpe":
        tok = train_or_load_bpe(path, bpe_vocab_size)
        return (lambda s: tok.encode(s).ids,
                lambda ids: tok.decode([int(i) for i in ids]),
                tok.get_vocab_size())
    raise ValueError(f"tokenizer {tokenizer!r}; have ('byte', 'bpe')")


def _check_utf8(path: str) -> None:
    dec = codecs.getincrementaldecoder("utf-8")()
    try:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                dec.decode(chunk)
            dec.decode(b"", final=True)
    except UnicodeDecodeError as e:
        raise ValueError(
            f"{path!r} is not valid UTF-8 ({e}); "
            "tokenizer='bpe' needs a text corpus — use "
            "tokenizer='byte' for binary files") from None


def text_clm(path: str, seq_len: int = 128, seed: int = 0,
             val_fraction: float = 0.1, tokenizer: str = "byte",
             bpe_vocab_size: int = 8192) -> Tuple[LmDataset, LmDataset]:
    """(train, val) causal-LM datasets from a local file: byte-level
    (vocab 256, any file, stored uint8) or a byte-level BPE trained on
    the corpus (UTF-8 text only, stored uint16; the vocab covers every
    emitted id). The token stream is cut into non-overlapping
    (seq_len + 1)-token windows, shuffled by ``seed``, and the last
    ``val_fraction`` of the shuffle is held out; ``mask`` is None."""
    if tokenizer == "byte":
        data = np.fromfile(path, dtype=np.uint8)
        vocab = 256
    elif tokenizer == "bpe":
        if not 2 <= bpe_vocab_size <= 65536:
            raise ValueError(
                f"bpe_vocab_size must be in [2, 65536] (uint16 storage),"
                f" got {bpe_vocab_size}")
        _check_utf8(path)
        tok = train_or_load_bpe(path, bpe_vocab_size)
        data = _encode_corpus(path, tok)
        vocab = int(tok.get_vocab_size())
        if len(data):
            vocab = max(vocab, int(data.max()) + 1)
    else:
        raise ValueError(f"tokenizer {tokenizer!r}; have ('byte', 'bpe')")
    win = seq_len + 1
    n = len(data) // win
    if n < 2:
        raise ValueError(
            f"{path!r}: {len(data)} tokens < 2 windows of {win} "
            f"(need seq_len+1 tokens per sequence)")
    seq = data[:n * win].reshape(n, win)
    seq = seq[np.random.default_rng(seed).permutation(n)]
    n_val = max(1, int(n * val_fraction))

    def make(rows):
        return LmDataset(tokens=rows[:, :-1], targets=rows[:, 1:],
                         mask=None, vocab_size=vocab)

    return make(seq[:-n_val]), make(seq[-n_val:])


class LmBatcher(Batcher):
    """{tokens, targets, mask} batches over an LmDataset."""

    def __init__(self, ds: LmDataset, global_batch: int, seed: int = 0,
                 num_processes: int = 1, process_index: int = 0,
                 accum_steps: int = 1):
        self.ds = ds
        super().__init__(
            n_items=len(ds), global_batch=global_batch, gather=ds.batch,
            seed=seed, num_processes=num_processes,
            process_index=process_index,
            accum_steps=accum_steps)
