"""Pipeline-parallel transformer LM: the port of ``models/pipelined.py``.

The block stack runs as S pipeline stages over the mesh's ``pipe`` axis
(``parallel/pipeline.py``); the shell (token and position embeddings,
the final norm, the head) runs outside the pipe on every rank. A
``PipelinedLM`` holds the shell and only the blocks of the stages its
process runs: ``layer_g`` for each global layer g of its virtual stages
(every layer on a ``StackedPipe``), each the port's ``Block`` of
``models/transformer.py``. The names are ``gpt_lm``'s, so a whole
``CausalLM``'s state dict loads into it (``init_weights`` draws the
whole model from the seed as ``gpt_lm`` does and keeps its part), and
``interop`` stacks ``layer_g`` into JAX's ``{"shell": ..., "blocks":
[S, lps, ...] | [S, V, lps, ...]}`` tree and back.

Under ``--mesh.model`` (``tp``: ``StackedTP`` or ``ProcessGroupTP``)
every block is a Megatron block, cut as JAX's ``_TP_SUFFIX`` names the
stacked leaves (qkv or q columns, out rows, the MLP's up and gate
columns and down rows, a MoE block's experts: ``parallel/sharding.py``);
the shell stays whole on every model rank, as JAX's carries no TP
names. Under ``--mesh.seq`` (``ring``) every stage's attention is the
ring over the seq group, and the embedding and RoPE take this rank's
positions (``transformer.ring_block``: a process's contiguous block's
own, as ``CausalLM``'s). The stages' collectives pair up because every
model and seq rank of a stage runs the same slots in the same tick
(``parallel/pipeline.py``).

``forward`` is the GPipe forward (``pipeline_apply``): logits (or, with
``features_only``, the head's pieces for the fused loss) on the process
that holds the last virtual stage, None on the others. Dropout seeds a
generator for each (microbatch, virtual stage) from the step's
generator's seed, and the stage's layers draw from it in order, so GPipe,
1F1B's recompute and its stash draw the same masks (JAX folds its key
over (microbatch, stage) and then the layer). ``moe_aux`` (a list)
receives the router losses of this rank's (stage, microbatch) slots as
one dict of sums (``load_balance`` and ``z_loss`` this rank's
differentiable parts, ``dropped_fraction`` the slot's global value),
each a sum over the slots' layers: JAX's ``mutable=["moe_aux"]``
divides them by ``n_layers * M``, as the losses here do
(``train/tasks.py``, ``train/pipeline_step.py``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_distributed_tpu_torch.models.moe import moe_objective
from tensorflow_distributed_tpu_torch.models.transformer import (
    GPT2_SIZES, Block, TransformerConfig, TransformerLM, _is_ring, _LmHead,
    _check_config, _make_norm, _norm, _remat_block, check_tp,
    gpt2_small_config, ring_block, rope_angles, tiny_config)
from tensorflow_distributed_tpu_torch.parallel.mesh import StackedPipe
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    shard_state_dict)
from tensorflow_distributed_tpu_torch.parallel.pipeline import (
    local_virtual_stages, pipeline_apply, stage_layers)

# The layer count pipelined_lm bumps tiny_config's n_layers=2 up to, so
# that common stage counts (2, 4) divide it (JAX's).
PIPELINED_TINY_LAYERS = 4
SHELL = ("tok_emb", "pos_emb", "ln_f", "lm_head")


def slot_seed(base: int, m: int, j: int) -> int:
    """The dropout seed of microbatch ``m`` at virtual stage ``j`` of a
    step whose generator was seeded with ``base``."""
    return int(np.random.SeedSequence([base, m, j]).generate_state(
        1, np.uint64)[0] >> 1)


class _AuxGroup:
    """The data group as ``moe_objective``'s reducer: a microbatch's
    routed counts summed over its data ranks' rows."""

    def __init__(self, mesh):
        self.mesh = mesh

    def replica_all_reduce_(self, tensors):
        self.mesh.data_all_reduce_(tensors)


class PipelinedLM(nn.Module):
    """Decoder LM whose blocks run pipeline-parallel over ``pipe`` (a
    ``StackedPipe`` or ``ProcessGroupPipe``; default one stage)."""

    is_pipelined = True

    def __init__(self, cfg: TransformerConfig, pipe=None,
                 num_microbatches: int = 4, virtual_stages: int = 1,
                 aux_mesh=None, ring=None, tp=None):
        """``aux_mesh``: the mesh whose data group a MoE router's counts
        are summed over (None: this process's rows alone). ``ring``: the
        seq group's ring (``StackedRing`` or ``ProcessGroupRing``) every
        stage's attention runs over; ``tp``: the model group's transport
        (``StackedTP`` or ``ProcessGroupTP``) that cuts every block (and
        a MoE block's experts), the shell staying whole."""
        super().__init__()
        _check_config(cfg)
        if cfg.moe_experts and _is_ring(ring):
            raise NotImplementedError(
                "MoE with a sequence ring (--mesh.seq > 1: the expert "
                "positions' cumsum runs over the whole sequence) is not "
                "ported to PyTorch yet (see ROADMAP.md A5)")
        if tp is not None:
            check_tp(cfg, tp.size)
        pipe = pipe if pipe is not None else StackedPipe(1)
        S = pipe.size
        if virtual_stages < 1:
            raise ValueError(
                f"virtual_stages must be >= 1, got {virtual_stages}")
        if cfg.n_layers % (S * virtual_stages):
            raise ValueError(
                f"{cfg.n_layers} layers not divisible by {S} stages"
                + (f" x {virtual_stages} virtual chunks"
                   if virtual_stages > 1 else ""))
        self.cfg = cfg
        self.pipe = pipe
        self.num_microbatches = num_microbatches
        self.virtual_stages = virtual_stages
        self.aux_mesh = aux_mesh
        self.ring = ring
        self.tp = tp
        # JAX's _TP_SUFFIX pins a MoE block's experts to the model axis.
        self.ep = tp if cfg.moe_experts else None
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if cfg.pos_emb == "learned":
            self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        for j in local_virtual_stages(pipe, virtual_stages):
            for g in self.layers(j):
                self.add_module(f"layer_{g}", Block(cfg, ring, tp, self.ep))
        self.ln_f = _make_norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = _LmHead(cfg.d_model, cfg.vocab_size)

    @property
    def num_stages(self) -> int:
        return self.pipe.size

    def layers(self, j: int) -> range:
        """The global layer indices of virtual stage ``j``."""
        return stage_layers(j, self.cfg.n_layers, self.num_stages,
                            self.virtual_stages)

    def shell_names(self) -> List[str]:
        """The shell's parameter names (every other one is a block's)."""
        return [n for n, _ in self.named_parameters()
                if n.split(".")[0] in SHELL]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The whole model's flax init, drawn as ``gpt_lm`` draws it
        (module order: embeddings, layer_0 ..., the final norm, the
        head), of which this process keeps its part."""
        device = next(self.parameters()).device
        with torch.device(device):
            whole = TransformerLM(self.cfg)
        whole.init_weights(generator)
        mine = dict(self.named_parameters())
        full = {n: t for n, t in whole.state_dict().items() if n in mine}
        self.load_state_dict(shard_state_dict(full, self)
                             if self.tp is not None else full)

    def whole(self, device=None) -> "PipelinedLM":
        """Every stage of this config in one process (a ``StackedPipe``
        of the same S), built on ``device``; on ``"meta"`` a template."""
        with torch.device(device or next(self.parameters()).device):
            return PipelinedLM(self.cfg, StackedPipe(self.num_stages),
                               self.num_microbatches, self.virtual_stages)

    # -- the shell ------------------------------------------------------

    def positions(self, L: int, device) -> torch.Tensor:
        """[1, L] positions of this rank's ``L`` tokens: under a ring of
        processes its contiguous block's own (offset by the block's
        start, as ``TransformerLM`` offsets them), else 0 .. L - 1 (a
        ``StackedRing`` holds the whole sequence)."""
        return ring_block(self.ring, L)[1] + torch.arange(
            L, device=device)[None]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        L = tokens.shape[1]
        shards = ring_block(self.ring, L)[0]
        if L * shards > self.cfg.max_len:
            raise ValueError(f"sequence length {L * shards} > max_len "
                             f"{self.cfg.max_len}")
        x = self.tok_emb(tokens)
        if self.cfg.pos_emb == "learned":
            x = x + self.pos_emb(self.positions(L, tokens.device))
        return x.to(self.cfg.compute_dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _norm(x, self.ln_f).to(cfg.compute_dtype)
        if cfg.tie_embeddings:
            return F.linear(x, self.tok_emb.weight.to(
                cfg.compute_dtype)).float()
        return self.lm_head(x).float()

    def head_pieces(self, x: torch.Tensor):
        """(features, head matrix [V, D], bias or None): the fused loss's
        inputs, as ``TransformerLM``'s ``features_only``."""
        x = _norm(x, self.ln_f).to(self.cfg.compute_dtype)
        if self.cfg.tie_embeddings:
            return x, self.tok_emb.weight, None
        return x, self.lm_head.weight, self.lm_head.bias

    # -- the stages -----------------------------------------------------

    def make_stage_fn(self, train: bool, seed: Optional[int],
                      with_aux: bool = False):
        """``fn(j, x_mb, m)``: virtual stage j's layers on microbatch m,
        in order. ``seed`` (None: no dropout) and (m, j) seed the slot's
        generator (``slot_seed``). ``with_aux``: return ``(y, aux)``,
        the slot's router sums (see the module docstring)."""
        cfg = self.cfg
        if with_aux and cfg.moe_experts <= 0:
            raise ValueError("mutable=['moe_aux'] needs moe_experts > 0")
        reducer = (_AuxGroup(self.aux_mesh) if self.aux_mesh is not None
                   and self.aux_mesh.distributed else None)

        def stage_fn(j: int, x: torch.Tensor, m: int):
            gen = None
            if seed is not None:
                gen = torch.Generator(device=x.device)
                gen.manual_seed(slot_seed(seed, m, j))
            positions = self.positions(x.shape[1], x.device)
            rope = (rope_angles(positions, cfg.d_model // cfg.n_heads,
                                cfg.rope_theta)
                    if cfg.pos_emb == "rope" else None)
            auxes: Optional[list] = [] if with_aux else None
            remat = cfg.remat and torch.is_grad_enabled()
            for g in self.layers(j):
                block = getattr(self, f"layer_{g}")
                if remat:
                    x = _remat_block(block, x, train, gen, positions, rope,
                                     auxes)
                else:
                    x = block(x, train, gen, positions, None, rope, None,
                              auxes)
            if not with_aux:
                return x
            lb, z, metrics = moe_objective(auxes, reducer)
            n = len(auxes)
            return x, {"load_balance": lb * n, "z_loss": z * n,
                       "dropped_fraction": metrics["dropped_fraction"] * n}

        return stage_fn

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False,
                moe_aux: Optional[list] = None,
                link: Optional[list] = None):
        """The GPipe forward (see the module docstring). ``link``: a list
        that receives the token tying this rank's hops into its loss
        (``pipeline_apply``)."""
        x = self.embed(tokens)
        seed = (generator.initial_seed()
                if train and self.cfg.dropout_rate and generator is not None
                else None)
        if train and self.cfg.dropout_rate and generator is None:
            raise ValueError("dropout in training needs a torch.Generator")
        with_aux = moe_aux is not None
        res = pipeline_apply(self.make_stage_fn(train, seed, with_aux), x,
                             self.pipe, self.num_microbatches,
                             self.virtual_stages, stage_aux=with_aux,
                             link=link)
        out = res
        if with_aux:
            out, aux = res
            moe_aux.append(aux)
        if out is None:
            return None
        if features_only:
            return self.head_pieces(out)
        # The head a microbatch at a time, as 1F1B's last stage runs it:
        # its bf16 products (the logits, the head's gradient) are then
        # the same in both schedules.
        return torch.cat([self.head(o) for o in
                          out.tensor_split(self.num_microbatches)])


def pipelined_lm(size: str = "tiny", pipe=None, causal: bool = True,
                 num_microbatches: int = 4, virtual_stages: int = 1,
                 aux_mesh=None, ring=None, tp=None,
                 **overrides) -> PipelinedLM:
    """Registry factory ("pipelined_lm"): "tiny" (tests; n_layers
    ``PIPELINED_TINY_LAYERS``) or a GPT-2 size ("small": 12L x 768d x
    12H). ``pipe``: the transport; ``num_microbatches`` is
    --pipeline-microbatches, ``virtual_stages``
    --pipeline-virtual-stages; ``ring`` and ``tp`` the seq and model
    groups' transports (--mesh.seq, --mesh.model)."""
    overrides["causal"] = causal
    if size == "tiny":
        overrides.setdefault("n_layers", PIPELINED_TINY_LAYERS)
        cfg = tiny_config(**overrides)
    else:
        if size not in GPT2_SIZES:
            raise ValueError(
                f"pipelined_lm size {size!r}; have "
                f"(tiny, {', '.join(GPT2_SIZES)})")
        cfg = gpt2_small_config(**{**GPT2_SIZES[size], **overrides})
    return PipelinedLM(cfg, pipe, num_microbatches,
                       virtual_stages=virtual_stages, aux_mesh=aux_mesh,
                       ring=ring, tp=tp)
