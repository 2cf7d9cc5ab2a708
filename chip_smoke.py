#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  — the card (nvidia-smi name and power limit), torch, CUDA,
             and whether nvcc and ninja are on the machine;
2. build   — compiles the flash-attention and fused-CE kernels from
             ``tensorflow_distributed_tpu_torch/ops/csrc`` (sm_90a), one
             nvcc per source, started together; lists the registers and
             spills of the Hopper kernels (B1's forward, B2's dQ, B3's
             dK/dV, B4's forward, B5's dx, B6's dW/db, and the partial
             instantiations of B1's, B2's and B3's kernels, B7, B8 and
             B9), fails if one spills, if ptxas ignored a setmaxnreg or
             serialized a kernel's wgmmas (warnings C7510-C7515), and
             counts their wgmma, TMA, mbarrier and mma.sync instructions
             in the machine code (cuobjdump); fails if a library holds
             an mma.sync (no WMMA is left);
3. kernels — each kernel (forward, dQ, dK/dV) against its plain PyTorch
             version computed in f32 from the same bf16 inputs, at
             B=8 H=12 L=1024 D=64 (causal, non-causal, causal + window
             256) and one D=128 case; median times over 20 launches
             (CUDA events) beside the bound, the plain version and
             ``scaled_dot_product_attention`` (forward, fwd+bwd, and
             its flash backward alone) as yardsticks, and the profiler's
             device time of B1, B2, B3 and SDPA's forward and flash
             backward;
4. ce_kernels — each fused-CE kernel (forward, dx, dW/db) against its
             plain PyTorch version computed in f32 from the same bf16
             inputs, at GPT-2-small's head (T 8192, D 768, V 50257; with
             bias at eps 0 and 0.1, and without bias), at D 1024, on a
             ragged case and at BERT-base's masked-LM head (T 8192, D 768,
             V 30522, no bias, a 0/1 weight on 15% of the rows); median times over 20 launches beside the bound,
             the plain version and the dense head + cross-entropy
             (forward, fwd+bwd) as yardsticks, and the kernels' device
             time (torch.profiler);
5. model   — a small GPT (head dim 64) on the card in bf16 through the
             kernels against the same weights on the CPU in f32: the
             dense head, then the fused head+loss through the CE kernels,
             untied and tied;
6. train   — GPT-2-small training through the port's CLI path
             (seq 1024, batch 8, 30 steps, final eval): finite, falling
             loss and every flash kernel launched by the run;
7. train_fused — the same run with ``--ce-chunk 8192 --ce-impl kernel``
             (final eval through the scan formulation): finite, falling
             loss, the first step's loss within 1e-2 of the dense run's,
             each CE kernel launched once per step;
8. step_profile — where a step goes, for train's and train_fused's
             flags and the Llama-style phases' (train_llama,
             train_window; phases 23-24): its host-
             clocked time with and without the per-step loss fetch, the
             host's time to enqueue a step, and, from torch.profiler, the
             device's busy time and idle share by kernel kind (flash,
             fused CE, GEMM, other) and the host ops with the most self
             CPU time;
9. ring_kernels — each partial-attention kernel of the ring (forward,
             dQ, dK/dV) against its plain PyTorch version computed in
             f32 from the same bf16 inputs, at GPT-2-small's half-block
             under a 4-way ring (B 8, H 12, 128 rows, D 64) and at the
             long-context shape (B 4, H 8, 512 rows: L 8192 over 8),
             causal and full, and one D=128 case; median times over 20
             launches beside the bound and the plain version (no library
             call computes the unnormalized partials or their
             gradients: library_ms is null), the kernels' device time
             alone (torch.profiler) at the 128- and 512-row cases, and
             SDPA's flash backward at the half-block, full and causal,
             as a work-equivalent yardstick for B8 + B9 (the same
             products on the same shapes, for the normalized function);
10. ring    — ``ring_attention`` over ``StackedRing(S)`` (the S ring
             positions stacked in one process on one card), forward and
             backward, at S=4 (B 8, H 12, L 1024, D 64) and S=8 (B 4,
             H 8, L 8192): each partial kernel launched 2S+1 times per
             call, outputs and grads against the flash kernels and the
             plain full attention in f32 (at S=8 on the last 512 query
             rows, forward), the forward and fwd+bwd times, and the
             device time of a fwd+bwd (all kernels, the partial ones);
11. train_ring — on a machine with two or more cards only: GPT-2-small
             trained by torchrun over S = 4 (or 2) processes with
             ``--mesh.seq S`` (NCCL), the first five losses within 1e-2
             of a one-card run of the same flags, every rank launching
             the partial kernels. On one card it prints a ``skipped``
             line;
12. model_cnn — the reference's MNIST CNN on the card in bf16 against
             the same weights on the CPU in f32, at batch 256: the logits
             and every grad (cuDNN and cuBLAS; no kernel of this
             repository is on the CNN's path);
13. train_cnn — the reference's job through the port's CLI path: the
             JAX package's default-tier accuracy bar on the committed
             MNIST fixture (the fixture must load as real MNIST; final
             val accuracy >= 0.95), then a timing run at the JAX
             defaults (synthetic digits, batch 256, dropout 0.25, 300
             steps: median step ms, images/s, peak memory) and its step
             profile (device busy and idle share, host enqueue time);
14. train_data — sync data parallelism: torchrun over N = min(cards, 4)
             processes, one card each (NCCL; on one card a torchrun of
             one process with an NCCL group of one): on two or more
             cards the CNN with ``--mesh.data N``, GPT-2-small (fused CE)
             with ``--mesh.data
             N`` at 8 rows a rank and, on four cards, with ``--mesh.data
             2 --mesh.seq 2``; the first five losses within 1e-2 of one
             card on the same global batch, every rank launching the
             flash (or, under seq, the partial) and fused-CE kernels,
             the performance table printed by rank 0 only.

15. decode — the decode-cache path at GPT-2-small's full width (12
             layers, d 768, 12 heads, vocab 50257, max_len 1024, seeded
             fresh-init weights, bf16): four prompts of 17, 100, 300 and
             511 tokens prefilled in one batch (each row padded to 511,
             as a bucket pads), then 16 greedy decode steps with every row
             at its own depth; at each step the last-position logits
             against the training forward over the same tokens without a
             cache (through B1), max |diff| / max |ref| <= 2e-2;
16. serve_identity — the slot engine under the FIFO scheduler in f32 at
             the same width: 12 requests of 8-480 prompt tokens through 4
             slots (reused), 32 new tokens each, every stream against the
             request's own one-shot greedy ``generate()``; a mismatch is
             excused only where the reference's top-2 logit gap is under
             1e-4 (f32 sums in another order at batch 4 and batch 1), and
             that request is compared no further; the prefill shapes used
             stay within the bucket ladder;
17. serve   — ``--mode serve`` through the port's CLI at GPT-2-small's
             width in bf16 (32 requests of 64-512 prompt tokens, 8 slots,
             64 new tokens each): exit 0, every token delivered, its
             summary (tokens/s, time to first token, per-token latency,
             occupancy, buckets, decode steps) and peak memory; then 10
             decode steps of a full engine traced by torch.profiler
             (launches a step, host enqueue, device busy, idle share),
             logits finite and tokens in the vocabulary;
18. checkpoint — GPT-2-small with the fused CE kernels (``--ce-chunk
             8192 --ce-impl kernel``, dropout 0.25): 6 steps straight,
             then 3 steps saving a checkpoint at step 3 and ``--resume``
             to step 6 in a new process (torchrun of one, the CLI's
             path): steps 4-6 within 1e-5 relative of the straight run
             (the largest difference printed), the resumed leg
             launching B1-B6; then an in-process save and restore of the
             straight run's state, every tensor, the step and the count
             equal, with the step directory's bytes and the save and
             restore seconds;
19. eval    — ``--mode eval`` through the CLI on that checkpoint (dense
             head, bf16, eval batch 8): its val_loss within 1e-5
             relative of an in-process ``evaluate()`` of the restored
             state, B1 launched 12 times an eval batch, the eval
             seconds and tokens/s;
20. generate — ``--mode generate`` through the CLI on that checkpoint in
             f32: greedy tokens equal to ``generate()`` on the restored
             model, ``--num-beams 4`` exiting 0 with tokens in the
             vocabulary and a finite beam score, and ``beam_search``
             with one beam equal to greedy (a mismatch excused only
             where the top-2 logit gap is under 1e-4);
21. serve_checkpoint — ``--mode serve --checkpoint-dir`` on that
             checkpoint in f32 (8 requests, 4 slots, 16 new tokens):
             the summary says ``"params": "checkpoint"``, and every
             stream equals ``generate()`` on the restored weights (the
             same excuse);
22. model_llama — the Llama-style GPT at GPT-2-small's widths (RoPE,
             4 K/V heads, SwiGLU at d_ff 3072, RMSNorm, tied: ~142M
             params), batch 2 x L 1024, from one seeded param tree: the
             bf16 forward and backward on the card through B1-B3 against
             the f32 plain path on the CPU, logits and every grad within
             5e-2 of max |ref|;
23. train_llama — train_fused's run (30 steps, ``--ce-chunk 8192
             --ce-impl kernel``) with the Llama-style flags: B2 and B3
             exactly 12 launches a step, B1 at least 12, each CE kernel
             one, no ring kernel; tokens/s, step ms and peak memory
             beside train_fused's;
24. train_window — ``--seq-len 4096 --attn-window 512 --pos-emb rope``
             at GPT-2-small's width, batch 2 (8192 tokens a step),
             ``--remat full --optimizer adafactor``, 20 steps: B2 and
             B3 12 launches a step, B1 at least 24 (the forward and the
             recompute), a falling loss; then 3 steps under ``--remat
             dots`` (B1 still 24 a step: the kernel is recomputed, as
             JAX recomputes its pallas_call under dots_saveable) and 3
             without remat (B1 12 a step), whose peak memory over the
             train steps must be higher than the remat run's, and the
             gap;
25. decode_llama — ``decode`` on the Llama-style model in bf16: the
             logits within 2e-2 of the training forward (B1), and the
             narrow cache ([B, max_len, 4, 64]) exactly 4/12 of the
             bytes of an MHA cache of the same shape;
26. serve_llama — ``serve_identity`` on the Llama-style model in f32:
             every stream equal to ``generate()`` (the same excuse);
27. decode_int8 — ``decode`` over the int8 cache in bf16, an MHA leg and
             a Llama-style leg (4 K/V heads): the logits within 5e-2 of
             the training forward (B1), and the cache exactly n_layers x
             max_len x nk x (2 x 64 + 8) bytes a row (int8 K and V, f32
             scales), beside the compute-dtype cache's n_layers x
             max_len x nk x 256;
28. serve_paged_identity — the paged engine (page size 16, the radix
             prefix cache, 4 slots, max_len 1024) under the FIFO
             scheduler in f32, 32 new tokens a request: a warm-up
             request, 12 requests sharing a 256-token prefix (tails of
             8-200 tokens), a page-aligned prompt served three times
             (copy-on-write) and a 3-turn session; every stream equal
             to ``generate()`` (the same excuse), at least 12 prefix
             hits, a copy on write, each later session turn attaching
             all its conversation wrote, fewer prefill tokens computed
             than dense, and every page free or held by the prefix
             cache or the session afterwards; in two legs, a
             compute-dtype (f32) cache and an int8 pool, each stream
             against ``generate()`` over the same model's dense cache;
29. serve_paged — ``--mode serve --serve.paged --serve.kv-dtype int8
             --serve.session-turns 4`` through the CLI in bf16 (the
             serve phase's 32 requests x 64 new tokens on 8 slots,
             prompts of 64-224 tokens so that a fourth turn fits): every
             token delivered, the page's bytes equal to
             ``page_bytes_estimate``, its summary (tokens/s, time to
             first token, prefix hit rate, pages) and peak memory, and
             the paged int8 engine's decode-step profile beside the
             serve phase's;
30. serve_spec_identity — speculative serving (k = 4) in f32 at full
             width, 8 requests of 32 new tokens through 4 slots, prompts
             of a segment repeated thrice and a tail, in four legs: the
             k-gram self-draft on the dense engine; a draft GPT
             (``--serve.draft-config tiny``, seeded); the self-draft on
             the paged engine with the radix cache behind a shared
             prefix; a cache sized exactly to the longest prompt + 32,
             each budget filling it, so that slots near their end take
             the plain path inside the verify. Every stream equal to
             ``generate()`` (the top-2 gap excuse, the excused count
             printed), no whole-batch plain step, proposals accepted in
             the self-draft legs, prefix hits in the paged one, fallback
             slots in the exact one; accept rate and verify steps
             printed;
31. serve_spec — the serve phase's CLI run with ``--serve.spec-tokens
             4`` (bf16): every token delivered, a ``[serve]
             speculative:`` line, its summary (tokens/s, time to first
             token, accept rate) and a traced verify step (launches,
             host enqueue, device busy, tokens retired a step) beside the
             serve phase's decode step;
32. serve_slo — the SLO scheduler in f32 at full width over 2 slots:
             12 requests (``--serve.slo-mix high:0.25,batch:0.25
             --serve.tenants 2 --serve.tenant-quota 96``) arriving at 20
             a second against ~2 s of work, built by ``serve_setup`` as
             the CLI builds them and served under FIFO and under slo,
             dense and then paged: a preemption in each slo run, none
             under FIFO, every slo stream equal to the FIFO one (the
             top-2 gap excuse), each paged preemption coming back as a
             prefix hit; the high class's p95 time to first token under
             each policy printed;
33. serve_fire — serving under faults at GPT-2-small's full width, four
             legs: (a) f32, the checkpoint phase's weights, 8 slots, 8
             requests, ``--resilience.fault-plan
             slot_nan@5:2,slot_nan@9:0,reload@12`` through
             ``serve_setup``, dense then paged: every stream equal to the
             same run without faults (the top-2 gap excuse), 2 retries
             and 1 swap, the quarantined slots named by the step's
             device flag, the paged quarantines' private pages 0 after
             release, the swap's seconds; (b) two quarantines mid-verify
             under speculation (k = 4, the self-draft, tied fresh-init
             weights) with a journal: identical streams, every dispatch
             a verify, and the quarantined requests' journaled tokens
             exactly their streams (no token of a poisoned verify row
             retired); (c) ``decode_stall@4:3s`` with
             ``--resilience.sync-timeout-s 1`` in a CLI process: exit 3
             before the stall's 3 s are over; (d) ``sigkill@10`` with
             ``--serve.journal`` in a CLI process (f32): killed, the same
             command resumes and exits 0, every request done once in the
             journal with the uninterrupted stream (the top-2 gap
             excuse). Beside them the flag's own device cost on a decode
             step's logits, and the serve phase's traced step (launches,
             device busy, one device-to-host copy a step). (a) and (c)
             run alone; (d)'s two CLI processes run beside (b) and (d)'s
             in-process reference, none of which is timed; the legs'
             seconds are printed;
34. train_fire — training under faults on GPT-2-small's fused-CE path
             (``--ce-chunk 8192 --ce-impl kernel``, 8 steps, every loss
             logged), four legs: (a) the plain run, the same run under
             every per-step reader (``--resilience.nonfinite skip_batch
             --resilience.spike-window 4 --resilience.data-timeout-s 30
             --resilience.sync-timeout-s 30``), and that run saving every
             2 steps under
             ``ckpt_io_fail@4:2``: losses within 1e-5 of the plain run's,
             the injection and two retries at step 4 and no other record,
             every save landed, B1-B3 12 launches a step and B4-B6 one in
             each run; the runs' median step ms (steps 3-5), and over the
             three traced steps 6-8 their step ms, launches, device busy
             ms and idle share a step; (b) ``sigterm@5`` in a
             CLI process: exit 0, a ``preempted`` record at step 5 and the
             save there; a ``--resume`` process runs steps 6-8; the eight
             losses within 1e-5 of the plain run's; (c) ``data_stall@5:3s``
             under ``--resilience.data-timeout-s 1`` in a CLI process: exit
             3 with a ``stall`` record naming the next-batch fetch of step
             5, before the stall ends (the seconds from the stall to the
             exit printed); (d) the CNN on the MNIST fixture under
             ``nan_grad@5``: ``skip_batch`` trains past the skip record to
             a finite loss, ``halt`` exits 2 in a CLI process, ``rewind``
             with a save every 2 steps rewinds from 5 to 4, quarantines
             step 6 and ends at step 8 with a finite loss (no kernel).
             (a) and (c) run alone; (b)'s two CLI processes run beside
             (d), neither timed; the legs' seconds are printed;
35. model_bert — BERT-base (12 x 768, 12 heads, vocab 30522 + the [MASK]
             row, L 512) on the card in bf16 through B1 non-causal (once a
             layer) against the same weights in f32 on the CPU: the logits
             of a masked-token batch within 5e-2;
36. train_bert — ``--model bert_mlm --seq-len 512 --synthetic-vocab
             30522 --batch-size 16``, 20 steps with the dense head, then
             20 with ``--ce-chunk 8192 --ce-impl kernel``: B1-B3 non-causal
             12 launches a step each, B4-B6 one a step in the fused leg
             (the MLM mask as their weight), a falling loss, the fused
             leg's first loss within 1e-2 of the dense leg's; tokens/s,
             masked tokens/s, step ms and peak memory; B1-B3 at BERT's
             shape (B.H 192, L 512, D 64, non-causal) against their plain
             versions, with device times and bounds;
37. train_text — GPT-2-small, byte-level, seq 1024, batch 8, 20 steps
             over a corpus of the repository's own .md and .py files
             written to a temporary directory (B1-B3 12 a step), then two
             CLI processes on its checkpoint in f32: ``--mode generate``
             with a text prompt (the continuation decoded) and ``--mode
             serve`` with a request file of ``text`` prompts; every
             stream equal to ``generate()`` on the restored model (the
             top-2 gap excuse);
38. train_cnn_u8 — the CNN on the MNIST fixture under ``--data-backend
             u8_native`` in f32: the port's native library built from
             ``native/tfd_native.cc`` into ``build/torch_native/`` and
             loaded, every batch gathered by it and equal bit for bit to
             numpy's ``u8 * f32(scale)`` of the same rows, the first 5 losses within
             1e-5 of the numpy backend's (the rest drift: an ulp in half
             the byte values' f32), images/s beside the numpy backend's;
39. model_resnet — ResNet-50 at 224 on the card in bf16 (cuDNN) against
             the same weights in f32 on the CPU within 5e-2: with batch
             statistics at the init weights, and with running averages
             after random BN scales and averages (the bf16 train-mode error
             under those printed, not gated: bf16 batch statistics); and
             in f32 on the card, with batch statistics through the live
             residual branches of those random scales, within 1e-3;
40. train_resnet — (a) ``--model resnet50 --dataset imagenet_synthetic
             --batch-size 64``, 8 steps: finite losses (not gated to
             fall: they rise at these settings; the port's trajectory is
             held to JAX's on the CPU at 32 x 32 only), images/s, step ms, peak memory and the
             traced step's conv/GEMM/other split; (b)
             ``--model resnet20 --dataset cifar10_synthetic --batch-size
             128``, 30 steps with a final save: a falling loss, the
             restored batch_stats equal to the trained ones, the final
             eval equal to ``evaluate()`` of the restored state and not
             to the same eval with the averages reset (the eval reads the
             running averages; no kernel);
41. tp_kernels — B1-B3 at the shapes tensor parallelism gives a rank:
             GPT-2-small's batch 8 at H/M heads (B.H 48 at M 2, 24 at
             M 4; L 1024, D 64, causal) and BERT-base's batch 16 at M 2
             (B.H 96, L 512, non-causal), each against its plain version
             at phase 3's gates, with median times, profiler device
             times, plain times and bounds;
42. model_tp — GPT-2-small at full width (12 layers, seq 1024, batch 8,
             bf16) on ``StackedTP(M)`` (M 2 and 4, every model rank in
             this process) against the whole model on the same weights
             on the card: the dense head, the untied head under
             ``shard_vocab`` (the vocab-parallel lookup and CE), and the
             vocab-parallel fused scan (``ce_chunk`` 8192); the loss,
             the logits and the whole gradient (gathered; each
             parameter's worst printed beside bf16's floor, the whole
             model against itself on two half-batches) within 2e-2, and
             B1-B3 launched 12 x M times each (H/M heads a launch);
43. train_tp — ``--mesh.model M`` under torchrun (NCCL, M = 4 with four
             cards or more, else 2): the dense head, then ``--shard-vocab
             --ce-chunk 8192``, and with four cards ``--mesh.data 2
             --mesh.model 2``; the first five losses within 1e-2 of one
             card's, every rank launching B1-B3, step ms and tokens/s a
             card; skipped, by the device count alone, on one card;
44. model_zero — GPT-2-small as published (tied, 12 layers, seq 1024,
             global batch 8, bf16, Adam, clip 1.0, EMA 0.999) on the
             stacked transport of D data ranks (D 2 and 4, every data
             rank in this process), three steps under each of
             ``--param-partition replicated|zero1|fsdp`` and
             ``--grad-sync serial|overlap`` (their second step NaN-
             poisoned and skipped): serial and overlap params, slots and
             EMA bit-identical, zero1 and fsdp within 1e-5 of replicated
             (losses) and rtol 2e-5 / atol 1e-6 (params), B1-B3 launched
             12 x D times a step; each partition's per-rank resident
             bytes beside the prediction; then a zero1 leg with
             ``--ce-chunk 8192 --ce-impl kernel`` (B4-B6 once a rank a
             step);
45. train_zero — ``--param-partition zero1``, ``fsdp``, ``--grad-sync
             serial`` and ``--param-partition zero1 --grad-sync
             overlap`` over D = min(cards, 4) torchrun processes (NCCL),
             and with four cards ``--mesh.data 2 --mesh.model 2
             --param-partition fsdp``: the first five losses within 1e-2
             of one card's, every rank launching B1-B3, each rank's peak
             memory, step ms and tokens/s a card; skipped, by the device
             count alone, on one card;
46. model_moe — ``moe_lm`` at GPT-2-small widths (untied, head bias; 8
             experts, top-2, capacity 1.25: 320 slots an expert at L
             1024; 559,476,817 params, asserted), bf16, one batch of 8 x
             1024: dense against scatter dispatch (the first MoE layer's
             routing identical: masks, positions, kept slots; logits
             within 1e-2; the share of (token, k) slots routed alike in
             every layer printed); then on ``StackedTP(X)``, X 2 and 4
             (TP attention, E/X experts a rank), against the whole
             model: the loss within 1e-5, logits and the whole gradient
             within 2e-2 with the routing pinned to the whole model's,
             and the share of slots routed alike on their own at least
             0.97; B1-B3 launched 12 x X times; then the share of
             slots routed as the f32 plain model routes them on the CPU
             (two rows) and the loss difference, printed, not gated
             (bf16 rounding of the router's input flips near-ties);
47. train_moe — 20 steps of that configuration (Adam) in three legs:
             dense dispatch, scatter dispatch, dense with ``--ce-chunk
             8192 --ce-impl kernel``; the losses fall, ``aux_loss``,
             ``z_loss`` and ``dropped_frac`` finite in every record,
             B1-B3 12 a step, B4-B6 once a step in the fused leg; step
             ms, tokens/s, peak memory and the router metrics;
48. serve_moe — that model on the dense engine, 8 requests in f32 and
             then in bf16: every token delivered; a prompt whose length
             equals its prefill bucket streams what ``generate()``
             makes (f32; the top-2 gap excusal of serve_identity); the
             agreement of the other streams printed (pad tokens take
             capacity in the engine's prefill group, as in JAX);
49. train_ep — ``--mesh.expert 4``, ``--mesh.model 4`` (TP attention,
             experts on the model axis) and ``--mesh.data 2
             --mesh.expert 2``, 10 steps of that configuration under
             torchrun (NCCL, four cards): the first five losses and the
             first step's gradient norm (relative) within 1e-2 of one
             card's; for the model axis, whose TP bf16 partial sums tip
             ~1% of the routing near-ties so that the trajectories part
             from the third step, the first two losses and the norm,
             with the later losses printed; each rank's peak memory,
             step ms and tokens/s a card; skipped, by the device count
             alone, on fewer than four cards;
50. model_pipe — GPT-2-small as ``pipelined_lm`` (12 layers, d 768, 12
             heads, seq 1024, batch 8, bf16, dropout 0), its weights the
             whole ``gpt_lm``'s carried through ``interop``, on
             ``StackedPipe(S)`` (every stage in this process) at S 2 and
             4 with M 4 and at S 4 with M 8: GPipe against the whole
             model run over the same M microbatches (the loss within
             1e-4 relative, the logits and the whole gradient within
             2e-2, each parameter's worst printed; the whole batch at
             once printed beside bf16's floor, the whole model against
             itself on two halves), then 1F1B recompute, stash and (at S
             2) the interleaved schedule over 2 virtual stages against
             GPipe (the loss within 1e-5, the whole gradient within 1e-4
             relative); B1-B3 launched exactly 12 x M times (B1 24 x M
             under recompute and V 2); at M 8 each schedule's peak
             memory, recompute's below GPipe's;
51. train_pipe — ``--mesh.pipe 4`` under torchrun (NCCL, four cards):
             1F1B recompute, stash and GPipe, then ``--mesh.pipe 2
             --pipeline-virtual-stages 2 --pipeline-microbatches 8`` (12
             layers do not cut into 4 x 2 virtual stages) and
             ``--mesh.data 2 --mesh.pipe 2``, 10 steps each: the first
             five losses within 1e-2 of the same flags at ``--mesh.pipe
             1`` on one card, every rank launching its B1-B3 share
             (B2/B3 exactly (12/S) x M a step), each rank's peak memory,
             step ms and tokens/s a card; the first leg saves and
             ``--mode eval`` restores the save on the same four ranks
             (its loss within 1e-5 of the run's final eval); on two cards
             the pipe 2 legs only; skipped, by the device count alone,
             on one card;
52. model_local_sgd — local SGD (``--param-sync-every``) for
             GPT-2-small (seq 1024, batch 8, bf16, dropout 0, SGD) on
             ``stacked_data(4)`` (the 4 replicas in this process): at H
             1 one step equals the synchronous data-parallel step of the
             same flags on the same transport (the loss within 1e-5
             relative, the replicas' mean params within rtol 2e-5 /
             atol 1e-6); at H 4 the replicas differ after steps 1-3 and
             are equal to the bit after step 4; B1-B3 launched exactly
             12 x 4 times a step;
53. model_pipe_tp — GPT-2-small as ``pipelined_lm`` on ``StackedPipe(2)``
             x ``StackedTP(2)`` (Megatron blocks, the shell whole), M 4:
             GPipe against the plain ``gpt_lm`` on the same weights over
             the same 4 microbatches at model_pipe's gates (the loss
             1e-4 relative, the logits and the whole gradient 2e-2), and
             at the same gates against the same model unstaged (one
             stage, the same TP; the whole batch at once printed), 1F1B
             recompute and stash against GPipe (1e-5, 1e-4); B1-B3 at
             H/M = 6 heads launched exactly 12 x 4 x 2 times (B1 twice
             that under recompute);
54. model_pipe_seq — the same on ``StackedPipe(2)`` x ``StackedRing(2)``
             (every stage's attention the zigzag ring): B7-B9 at the
             stages' 256-row half-blocks launched exactly 12 x 4 x 5
             times (B7 twice that under recompute), no B1-B3;
55. train_local_sgd — ``--mesh.data D --param-sync-every 4`` under
             torchrun (NCCL, D = min(cards, 4)), 10 steps, saved, then
             ``--mode eval`` of the save on the same ranks (its loss
             within 1e-5 of the run's final eval of the replicas'
             mean); the first loss within 1e-2 of one card's (the
             replicas start alike), every rank launching B1-B3 12 a
             step; skipped, by the device count alone, on one card;
56. train_pipe3d — ``--mesh.pipe 2 --mesh.model 2``, ``--mesh.pipe 2
             --mesh.seq 2`` and ``--mesh.data 2 --mesh.pipe 2
             --param-partition zero1`` under torchrun (NCCL, four
             cards), 10 steps each: the first five losses within 1e-2 of
             one card's with a rank's tokens a microbatch (the zero1 and
             seq legs' to one card's 8 one-row microbatches),
             every rank's kernel share (B1-B3, or B7-B9 under seq), peak
             memory, step ms and tokens/s a card; skipped, by the device
             count alone, on fewer than four cards;
57-59. model_serve_tp, serve_tp, generate_tp — tensor-parallel serving
             and generation (``--serve.mesh-model N``, ``--mode generate
             --mesh.model M``): the engines on StackedTP(2) on one card
             (int8, k-gram and GQA on StackedTP(4) too); the CLI legs at
             M 4 on four;
60. model_reshard — ``restore_resharded`` at GPT-2-small's width
             (model_zero's configuration: tied, Adam, EMA, clip 1.0, bf16):
             one step on ``stacked_data(4)`` fsdp and a save, then the
             save restored onto ``stacked_data(4)`` fsdp again (a control
             on the writer's mesh: not resharded), ``stacked_data(2)``
             fsdp, one replicated process and ``StackedTP(2)``: ``info``
             resharded from data 4 to each other mesh, each of their
             re-saves' ``state.msgpack`` equal to the original's by
             sha256, and one more step from each against one more step
             from the unresharded state (the loss at model_zero's 1e-5,
             model_tp's 2e-2 on the model axis; the step's gradient, read
             from Adam's first moment, at model_tp's 2e-2; the control's
             params at model_zero's rtol 2e-5 / atol 1e-6; see
             RESHARD_LEGS), B1-B3 12 x D (12 x 2 on StackedTP(2))
             launches a step;
61. train_elastic — ``supervisor --elastic`` over the CLI: on one card
             ``--mesh.data 1`` with ``device_loss@3:1``: the leg writes the
             mask and dies, no mesh fits the survivors, ``mesh_exhausted``
             and exit 137; on two or three cards data 2 -> 1; on four
             (``--only train_elastic``) GPT-2-small, seq 1024, global batch
             8, bf16, 10 steps, a save every 2: (a) data 4 fsdp loses 2 at
             step 5 and resumes at data 2 from step 4 (the drill's, the
             mesh change's, the reshard's and the resume's records, exit
             0), (b) the mask deleted, the run grows back to data 4 and
             goes on to step 14 (the loop's reshard 2 -> 4), (c) data 2 x
             model 2 resumes at data 1 x model 2, (d) ``sigterm@5`` on
             every rank of data 4: every rank stops at step 6, one save,
             exit 0, and the ``--resume`` run ends; the losses after each
             resize within 1e-2 of one card's run;
62. serve_fleet — fleet serving (``fleet/``), run after serve_fire on
             the checkpoint phase's GPT-2-small (``--only serve_fleet``:
             the same model saved untrained from the seed) in f32: two
             replica processes of ``--mode serve`` (4 slots each) on the
             card behind ``fleet.run.run_fleet``; 16 requests of 16-64
             prompt tokens, 32 new tokens each, 0.1 s apart, classes
             high:standard 1:3. Replica r1 is SIGKILLed once a request
             there is mid-decode once half the requests have arrived
             (found through its journal); once every
             request is done and r1 is back, a newer step of the same
             weights is published and the controller rolls it one
             replica at a time. Gates: 16 done, none lost or shed; one
             death, one restart (a fresh epoch), at least one
             re-dispatch; one rolling swap, no partial roll, both
             replicas serving the new step (staleness back to 0); each
             replica's last snapshot parsing, its seq risen, its
             requests_done the router's count; every stream equal to
             one-process ``generate()`` on the restored weights (the
             top-2 gap excuse). Printed: the replicas' start seconds,
             death to the re-dispatched request's next token, the
             restart, each replica's swap seconds, fleet tokens/s, the
             TTFT p50/p95 of each class, each replica's peak memory.

It then prints the seconds of each phase, the nvidia-smi line, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.

    python3 chip_smoke.py --only model_bert,train_bert,...

runs the device and build phases, then only the named phases, with the
same checks, and prints the nvidia-smi line last (no kernels or ok
line). The phases it takes: ``ce_kernels`` and phases 35-62.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# Tolerances of kernel vs plain version (plain computed in f32 from the
# same bf16 inputs; the kernel rounds P and dS to bf16 before products).
TOL_O = 2e-2        # max abs error of the bf16 output
TOL_LSE = 1e-3      # max abs error of the f32 logsumexp
TOL_GRAD = 2e-2     # max abs error / max |reference| of dQ, dK, dV
# Fused-CE kernels vs their plain versions (plain computed in f32 from
# the same bf16 inputs; the kernels round dlogits to bf16 before the dx
# and dW products, as the scan formulation does).
TOL_CE = 1e-3       # max abs error of ce and lse (f32)
TOP2_GAP = 1e-2     # `correct` must agree where the top-2 logit gap exceeds it
TOL_CE_GRAD = 2e-2  # max abs error / max |reference| of dx and dW
TOL_DB = 1e-3       # max abs error / max |reference| of db
TOL_FIRST_LOSS = 1e-2  # fused vs dense first-step loss (same seed/batches)
CE_MAIN = dict(T=8192, D=768, V=50257, bias=True, eps=0.0)
CE_CASES = [CE_MAIN, dict(CE_MAIN, eps=0.1), dict(CE_MAIN, bias=False),
            dict(T=2048, D=1024, V=50257, bias=True, eps=0.0),
            dict(T=1000, D=768, V=179, bias=True, eps=0.1),
            # BERT-base's masked-LM head: the tied table sliced to V, no
            # bias, the weight a 0/1 mask on ``mask`` of the rows.
            dict(T=8192, D=768, V=30522, bias=False, eps=0.0, mask=0.15)]
# Model check: bf16 kernels on the card vs f32 plain path on the CPU.
TOL_MODEL = 5e-2    # max abs error / max |reference|, logits and grads
MAIN = dict(B=8, H=12, L=1024, D=64)
CASES = [dict(MAIN, causal=True, window=0),
         dict(MAIN, causal=False, window=0),
         dict(MAIN, causal=True, window=256),
         dict(B=2, H=8, L=1024, D=128, causal=True, window=0)]
TRAIN_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size", "small",
              "--seq-len", "1024", "--batch-size", "8", "--train-steps", "30",
              "--eval-every", "0", "--eval-batch-size", "8",
              "--compute-dtype", "bfloat16", "--log-every", "1"]
TRAIN_FUSED_ARGV = TRAIN_ARGV + ["--ce-chunk", "8192", "--ce-impl", "kernel"]
CE_KERNELS = ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")
RING_KERNELS = ("flash_fwd_partial", "flash_dq_partial", "flash_dkv_partial")
PROFILE_STEPS = 10  # timed and traced steps of a profiled run
# step_profile's four GPT runs and train_resnet's ResNet-50 profile take
# fewer, to keep the one-card smoke within its time budget.
STEP_PROFILE_STEPS = 3
# Partial (ring-step) kernels vs their plain versions; the ring vs the
# flash kernels and the plain full attention (plain in f32 from the same
# bf16 inputs; the kernels round P and dO to bf16 for their products).
TOL_PARTIAL_O = 2e-2  # max abs error / max |reference| of the f32 o
TOL_STATS = 1e-3      # max abs error of the partial forward's m and l
TOL_RING = 2e-2       # ring out, dQ, dK, dV: max abs error / max |reference|
TOL_RING_LOSS = 1e-2  # train_ring vs one card, first five losses
TRAIN_RING_TIMEOUT_S = 600  # torchrun's S ranks, builds included
RING_KERNEL_CASES = [  # the first is the main case (timed, in the kernels line)
    dict(B=8, H=12, nh=128, D=64, causal=False),
    dict(B=8, H=12, nh=128, D=64, causal=True),
    dict(B=4, H=8, nh=512, D=64, causal=False),
    dict(B=4, H=8, nh=512, D=64, causal=True),
    dict(B=2, H=8, nh=256, D=128, causal=True)]
RING_CASES = [dict(S=4, B=8, H=12, L=1024, D=64),  # launches in the kernels line
              dict(S=8, B=4, H=8, L=8192, D=64)]
# The ring is held to the whole plain f32 version where its [B, H, L, L]
# scores fit in PLAIN_SCORE_BYTES, else (L 8192: 8.6 GB) on the last
# RING_PLAIN_ROWS query rows, forward.
PLAIN_SCORE_BYTES = 2 ** 31
RING_PLAIN_ROWS = 512
TRAIN_RING_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                   "small", "--seq-len", "1024", "--batch-size", "8",
                   "--train-steps", "5", "--eval-every", "0",
                   "--eval-batch-size", "8", "--dropout-rate", "0",
                   "--compute-dtype", "bfloat16", "--log-every", "1"]
# The reference's job: the JAX package's default-tier accuracy bar on the
# committed MNIST fixture (tests/test_loop_cli.py's flags, at the default
# bf16 compute), then a timing run at the JAX defaults (synthetic digits,
# batch 256, dropout 0.25).
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "mnist")
CNN_ACCURACY_BAR = 0.95
TRAIN_CNN_ARGV = ["--mode", "train", "--model", "mnist_cnn", "--dataset",
                  "mnist", "--data-dir", FIXTURE_DIR, "--validation-size",
                  "64", "--batch-size", "64", "--train-steps", "50",
                  "--learning-rate", "2e-3", "--eval-every", "0",
                  "--eval-batch-size", "64", "--log-every", "1"]
TRAIN_CNN_TIMING_ARGV = ["--mode", "train", "--model", "mnist_cnn",
                         "--dataset", "synthetic", "--batch-size", "256",
                         "--train-steps", "300", "--eval-every", "0",
                         "--log-every", "1"]
# train_data: torchrun over N = min(cards, 4) processes, 5 steps, eval at
# step 5 (the chief's performance table), dropout 0 for the loss check.
TRAIN_DATA_CNN_ARGV = ["--mode", "train", "--model", "mnist_cnn",
                       "--dataset", "synthetic", "--batch-size", "256",
                       "--train-steps", "5", "--eval-every", "5",
                       "--dropout-rate", "0", "--log-every", "1"]
TRAIN_DATA_TIMEOUT_S = 420  # one torchrun, builds and NCCL start included
TABLE_HEADER = "Steps,        Time,      Accuracy,  Learning rate"
# Serving at GPT-2-small's full width (fresh-init weights from a seed).
DEVICE = "cuda"
TOL_DECODE = 2e-2   # decode vs training forward: max |diff| / max |ref|, bf16
DECODE_PROMPTS = (17, 100, 300, 511)  # one batch, each row at its own depth
DECODE_STEPS = 16
IDENTITY_SLOTS, IDENTITY_REQUESTS, IDENTITY_NEW = 4, 12, 32
IDENTITY_PROMPTS = (8, 480)  # lengths spread evenly over this range
IDENTITY_GAP = 1e-4  # a stream may differ only where the top-2 gap is below
SERVE_REQUESTS, SERVE_NEW = 32, 64
SERVE_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "small",
              "--synthetic-vocab", "50257", "--seq-len", "1024",
              "--serve.num-slots", "8", "--serve.num-requests",
              str(SERVE_REQUESTS), "--serve.prompt-len-min", "64",
              "--serve.prompt-len-max", "512", "--serve.max-new-tokens",
              str(SERVE_NEW)]
# The int8 and paged decode caches at GPT-2-small's full width.
TOL_DECODE_INT8 = 5e-2  # int8 decode vs training forward (JAX's int8 bound)
PAGE_SIZE = 16
PAGED_REQUESTS = 12     # share one PAGED_PREFIX-token prefix, tails below
PAGED_PREFIX, PAGED_TAILS = 256, (8, 200)
PAGED_ALIGNED = 320     # a whole number of pages, served three times (COW)
PAGED_TURN0, PAGED_TURN_NEW, PAGED_TURNS = 100, 24, 3  # the session's turns
# The serve phase's workload as sessions of 4 turns (each turn's prompt
# extends the last), with prompts of 64-224 tokens so that a fourth turn
# (at most 4 x 224) plus its 64 new tokens fits the 1024 cache.
SERVE_PAGED_PROMPT_MAX = 224
SERVE_PAGED_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size",
                    "small", "--synthetic-vocab", "50257", "--seq-len", "1024",
                    "--serve.num-slots", "8", "--serve.num-requests",
                    str(SERVE_REQUESTS), "--serve.prompt-len-min", "64",
                    "--serve.prompt-len-max", str(SERVE_PAGED_PROMPT_MAX),
                    "--serve.max-new-tokens", str(SERVE_NEW),
                    "--serve.paged", "true", "--serve.kv-dtype", "int8",
                    "--serve.session-turns", "4"]
# Speculative decoding and the SLO scheduler at GPT-2-small's full width.
SPEC_K = 4
SPEC_REQUESTS, SPEC_NEW = 8, 32
SPEC_SEGMENTS = (12, 40)  # a prompt: a segment of this many tokens, thrice,
SPEC_TAILS = (4, 60)      # then a tail of this many
SPEC_PREFIX = 128         # the paged leg's shared prefix
# Tied embeddings (GPT-2 as published): a fresh-init tied model repeats
# its input more often than an untied one, so more k-gram proposals are
# accepted (leg a on one H100: 0.29 tied against 0.10 untied).
SPEC_TIED = True
SERVE_SPEC_ARGV = SERVE_ARGV + ["--serve.spec-tokens", str(SPEC_K)]
SLO_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "small",
            "--synthetic-vocab", "50257", "--seq-len", "1024",
            "--compute-dtype", "float32", "--serve.num-slots", "2",
            "--serve.num-requests", "12", "--serve.prompt-len-min", "64",
            "--serve.prompt-len-max", "256", "--serve.max-new-tokens", "48",
            "--serve.arrival-rate", "20", "--serve.policy", "slo",
            "--serve.slo-mix", "high:0.25,batch:0.25", "--serve.tenants", "2",
            "--serve.tenant-quota", "96"]
# The paged leg's pool: every request's whole trajectory (1024 / 16 pages)
# fits beside the slots', so nothing is evicted and each preemption's
# continuation finds its retained pages.
SLO_NUM_PAGES = 1 + (2 + 12) * 64
# Serving under faults at GPT-2-small's full width.
FIRE_PLAN = "slot_nan@5:2,slot_nan@9:0,reload@12"
FIRE_SLOTS, FIRE_REQUESTS, FIRE_NEW = 8, 8, 24
FIRE_SPEC_PLAN = "slot_nan@3:1,slot_nan@6:2"
FIRE_STALL_S, FIRE_TIMEOUT_S = 3.0, 1.0
FIRE_STALL_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size",
                   "small", "--synthetic-vocab", "50257", "--seq-len", "1024",
                   "--serve.num-slots", "4", "--serve.num-requests", "8",
                   "--serve.prompt-len-min", "64", "--serve.prompt-len-max",
                   "256", "--serve.max-new-tokens", "16",
                   "--resilience.sync-timeout-s", str(FIRE_TIMEOUT_S),
                   "--resilience.fault-plan", f"decode_stall@4:{FIRE_STALL_S}s"]
FIRE_KILL_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size",
                  "small", "--synthetic-vocab", "50257", "--seq-len", "1024",
                  "--compute-dtype", "float32", "--serve.num-slots", "4",
                  "--serve.num-requests", "8", "--serve.prompt-len-min", "32",
                  "--serve.prompt-len-max", "256", "--serve.max-new-tokens",
                  "8", "--serve.decode-priority", "1"]
FIRE_KILL_PLAN = "sigkill@10"
FIRE_CLI_TIMEOUT_S = 300  # one CLI process: CUDA start, build, serve
# train_fire: training under faults on the fused-CE path (B1-B6) at full
# width, TRAIN_FIRE_STEPS steps a run, every loss logged.
TRAIN_FIRE_STEPS = 8
TRAIN_FIRE_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                   "small", "--seq-len", "1024", "--batch-size", "8",
                   "--train-steps", str(TRAIN_FIRE_STEPS), "--eval-every",
                   "0", "--eval-batch-size", "8", "--compute-dtype",
                   "bfloat16", "--log-every", "1", "--ce-chunk", "8192",
                   "--ce-impl", "kernel"]
# Every per-step reader at once: the skip policy (a verdict read before
# each update), the spike detector (each retired step's loss), the data
# and sync watchdogs (a thread hop a fetch and a retirement).
TRAIN_FIRE_WATCH = ["--resilience.nonfinite", "skip_batch",
                    "--resilience.spike-window", "4",
                    "--resilience.data-timeout-s", "30",
                    "--resilience.sync-timeout-s", "30"]
TRAIN_FIRE_SAVE_PLAN = "ckpt_io_fail@4:2"
# Traced: from one step's record to another's (the profiler's start and
# stop stay out of the untraced step times).
TRAIN_FIRE_PROFILE = (5, 8)
TRAIN_FIRE_SIGTERM = 5
TRAIN_FIRE_STALL_S, TRAIN_FIRE_TIMEOUT_S = 3.0, 1.0
TRAIN_FIRE_STALL_ARGV = TRAIN_FIRE_ARGV + [
    "--resilience.data-timeout-s", str(TRAIN_FIRE_TIMEOUT_S),
    "--resilience.fault-plan", f"data_stall@5:{TRAIN_FIRE_STALL_S}s"]
TRAIN_FIRE_CNN_ARGV = ["--mode", "train", "--model", "mnist_cnn",
                       "--dataset", "mnist", "--data-dir", FIXTURE_DIR,
                       "--validation-size", "64", "--batch-size", "64",
                       "--train-steps", str(TRAIN_FIRE_STEPS),
                       "--learning-rate", "2e-3", "--eval-every", "0",
                       "--eval-batch-size", "64", "--log-every", "1",
                       "--resilience.fault-plan", "nan_grad@5"]
TOL_FIRE_LOSS = 1e-5  # a run under faults vs the plain run, relative
FLAG_CALLS = 50  # calls a profiled cycle of the flag's cost
# Checkpoints and the modes that read them, at GPT-2-small's full width.
CKPT_MODEL_ARGV = ["--model", "gpt_lm", "--model-size", "small",
                   "--seq-len", "1024"]
CHECKPOINT_ARGV = ["--mode", "train", *CKPT_MODEL_ARGV, "--batch-size", "8",
                   "--eval-every", "0", "--eval-batch-size", "8",
                   "--compute-dtype", "bfloat16", "--log-every", "1",
                   "--ce-chunk", "8192", "--ce-impl", "kernel",
                   "--dropout-rate", "0.25"]
CHECKPOINT_STEPS, CHECKPOINT_EVERY = 6, 3
CHECKPOINT_TIMEOUT_S = 420  # the resumed leg's torchrun, start-up included
TOL_RESUME = 1e-5   # resumed vs straight losses, relative
EVAL_ARGV = ["--mode", "eval", *CKPT_MODEL_ARGV, "--eval-batch-size", "8",
             "--compute-dtype", "bfloat16"]
TOL_EVAL = 1e-5     # CLI eval vs in-process evaluate(), relative
GENERATE_PROMPT_LEN, GENERATE_NEW, GENERATE_BEAMS = 64, 32, 4
GENERATE_ARGV = ["--mode", "generate", *CKPT_MODEL_ARGV, "--compute-dtype",
                 "float32", "--max-new-tokens", str(GENERATE_NEW)]
SERVE_CKPT_ARGV = ["--mode", "serve", *CKPT_MODEL_ARGV, "--synthetic-vocab",
                   "50257", "--compute-dtype", "float32",
                   "--serve.num-slots", "4", "--serve.num-requests", "8",
                   "--serve.prompt-len-min", "16", "--serve.prompt-len-max",
                   "256", "--serve.max-new-tokens", "16", "--serve.stream",
                   "true"]
# serve_fleet: two replica processes of the port's --mode serve on one
# card behind the fleet router and controller (fleet/), the checkpoint
# phase's GPT-2-small in f32.
FLEET_REQUESTS, FLEET_NEW, FLEET_GAP_S, FLEET_SLOTS = 16, 32, 0.1, 4
FLEET_PROMPTS = (16, 64)   # prompt lengths, drawn from FLEET_SEED
FLEET_SEED = 7
FLEET_ARGV = ["--mode", "serve", *CKPT_MODEL_ARGV, "--synthetic-vocab",
              "50257", "--compute-dtype", "float32", "--serve.num-slots",
              str(FLEET_SLOTS), "--serve.buckets", "64,128"]
FLEET_ROLL = 3             # the rolled step: the served one + this
FLEET_TIMEOUT_S = 420      # the fleet's serving loop, the roll included
FLEET_KILL_TOKENS = (1, 16)  # r1 dies with a request this far decoded,
FLEET_KILL_AFTER_S = 0.8     # once half the requests have arrived
# The Llama-style GPT at GPT-2-small's published widths (12 layers x 768 x
# 12 heads of 64, vocab 50257, d_ff 3072) with RoPE, grouped-query
# attention over 4 K/V heads (the JAX package's genbench --n-kv-heads 4),
# a SwiGLU MLP, RMSNorm and tied embeddings: ~142M params.
LLAMA_OPTS = dict(pos_emb="rope", n_kv_heads=4, mlp_variant="swiglu",
                  norm="rmsnorm", tie_embeddings=True)
LLAMA_FLAGS = ["--pos-emb", "rope", "--n-kv-heads", "4", "--mlp-variant",
               "swiglu", "--norm", "rmsnorm", "--tie-embeddings", "true"]
MODEL_LLAMA_B, MODEL_LLAMA_L = 2, 1024
TRAIN_LLAMA_ARGV = TRAIN_ARGV + LLAMA_FLAGS + ["--ce-chunk", "8192",
                                               "--ce-impl", "kernel"]
# Mistral-style long context (the README's --seq-len 4096 --attn-window
# 512 --pos-emb rope) at GPT-2-small's width, 8192 tokens a step as in
# train, recomputing every block, with Adafactor; then short legs under
# --remat dots and without remat.
TRAIN_WINDOW_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                     "small", "--seq-len", "4096", "--batch-size", "2",
                     "--train-steps", "20", "--eval-every", "0",
                     "--eval-batch-size", "2", "--compute-dtype", "bfloat16",
                     "--log-every", "1", "--attn-window", "512",
                     "--pos-emb", "rope", "--remat", "full", "--optimizer",
                     "adafactor"]
WINDOW_CONTROL_STEPS = 3
# The BASELINE families (phases 35-40): BERT-base masked LM at L 512 on
# the synthetic masked-token stream (vocab 30522 + [MASK]), 16 rows a
# step (8192 tokens, as train), dense head and the fused CE kernels.
BERT_STEPS = 20
MODEL_BERT_B = 2
TRAIN_BERT_ARGV = ["--mode", "train", "--model", "bert_mlm", "--seq-len",
                   "512", "--synthetic-vocab", "30522", "--batch-size", "16",
                   "--train-steps", str(BERT_STEPS), "--eval-every", "0",
                   "--eval-batch-size", "16", "--compute-dtype", "bfloat16",
                   "--log-every", "1"]
TRAIN_BERT_FUSED_ARGV = TRAIN_BERT_ARGV + ["--ce-chunk", "8192",
                                           "--ce-impl", "kernel"]
BERT_KERNEL_CASE = dict(B=16, H=12, L=512, D=64, causal=False, window=0)
# Tensor parallelism: B1-B3 at a model rank's H/M heads (GPT-2-small's
# batch 8 at M 2 and 4, BERT-base's batch 16 at M 2); GPT-2-small on
# StackedTP(M) against the whole model; --mesh.model under torchrun.
TP_KERNEL_CASES = [dict(M=2, B=8, H=6, L=1024, D=64, causal=True, window=0),
                   dict(M=4, B=8, H=3, L=1024, D=64, causal=True, window=0),
                   dict(M=2, B=16, H=6, L=512, D=64, causal=False, window=0)]
TP_SIZES = (2, 4)
TP_MODEL = dict(size="small", B=8, L=1024)  # model_tp's model and batch
TP_VARIANTS = {"dense": {}, "shard_vocab": dict(shard_vocab=True),
               "fused_scan": dict(ce_chunk=8192)}
# TP vs the whole model: the loss (relative), the logits (max |diff| / max
# |ref|) and the whole gradient (||diff|| / ||ref|| over every parameter).
# A parameter's own max |diff| / max |ref| is printed, not gated: in bf16
# it is noise-bound (the whole model against itself, the batch run in two
# halves, reads 1-4.4% on an H100), and the phase prints that floor
# beside it.
TOL_TP = 2e-2
TRAIN_TP_STEPS = 10
TRAIN_TP_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                 "small", "--seq-len", "1024", "--batch-size", "8",
                 "--train-steps", str(TRAIN_TP_STEPS), "--eval-every", "0",
                 "--eval-batch-size", "8", "--dropout-rate", "0",
                 "--compute-dtype", "bfloat16", "--log-every", "1"]
TRAIN_TP_TIMEOUT_S = 600  # one torchrun, NCCL start-up included
# GPT-2-small, byte-level, over a corpus of the repository's own .md and
# .py files (no download); then --mode generate with a text prompt and
# --mode serve with text requests, each a CLI process, in f32.
TEXT_STEPS = 20
TRAIN_TEXT_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                   "small", "--dataset", "text", "--seq-len", "1024",
                   "--batch-size", "8", "--train-steps", str(TEXT_STEPS),
                   "--eval-every", "0", "--eval-batch-size", "8",
                   "--compute-dtype", "bfloat16", "--log-every", "1"]
TEXT_PROMPTS = ("def main(", "The port ", "import torch\n", "# ROADMAP")
TEXT_NEW = 24
TEXT_GEN_ARGV = ["--model", "gpt_lm", "--model-size", "small", "--dataset",
                 "text", "--seq-len", "1024", "--compute-dtype", "float32"]
# The CNN on the committed fixture from uint8 storage by the native
# gather, against the numpy backend, in f32. The batches are not bit-
# identical: u8 * (1/255) (JAX's native gather) and u8 / 255 (the float
# loader) differ by an ulp for 126 of the 256 byte values, and 50 steps
# at the fixture bar's learning rate amplify that; the first U8_STEPS_HELD
# losses are held to TOL_U8, the whole run's difference is printed.
TRAIN_CNN_U8_ARGV = TRAIN_CNN_ARGV + ["--compute-dtype", "float32",
                                      "--data-backend", "u8_native"]
TOL_U8 = 1e-5
U8_STEPS_HELD = 5
# ResNet-50 at 224 (ImageNet shapes, 1000 classes) and ResNet-20 on
# CIFAR-10 shapes, synthetic sets made from the seed.
# The phases ``--only`` runs alone: ce_kernels and phases 35-62.
ONLY_PHASES = ("ce_kernels", "model_bert", "train_bert", "train_text",
               "train_cnn_u8", "model_resnet", "train_resnet", "tp_kernels",
               "model_tp", "train_tp", "model_zero", "train_zero",
               "model_moe", "train_moe", "serve_moe", "train_ep",
               "model_pipe", "train_pipe", "model_local_sgd",
               "model_pipe_tp", "model_pipe_seq", "train_local_sgd",
               "train_pipe3d", "model_serve_tp", "serve_tp", "generate_tp",
               "model_reshard", "train_elastic", "serve_fleet")
# ZeRO-1, FSDP and the explicit gradient sync: GPT-2-small as published
# (tied) on the stacked transport of D data ranks, each leg's steps
# through the port's train step; then --param-partition / --grad-sync
# under torchrun.
ZERO_SIZES = (2, 4)
ZERO_STEPS = 3
MODEL_ZERO_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                   "small", "--seq-len", "1024", "--batch-size", "8",
                   "--tie-embeddings", "true", "--dropout-rate", "0",
                   "--compute-dtype", "bfloat16", "--grad-clip-norm", "1.0",
                   "--ema-decay", "0.999", "--train-steps", str(ZERO_STEPS),
                   "--eval-every", "0", "--eval-batch-size", "8"]
SKIP_NAN = ["--resilience.nonfinite", "skip_batch"]
ZERO_LEGS = {"replicated": [], "zero1": ["--param-partition", "zero1"],
             "fsdp": ["--param-partition", "fsdp"],
             "serial": ["--grad-sync", "serial"] + SKIP_NAN,
             "overlap": ["--grad-sync", "overlap", "--param-partition",
                         "zero1"] + SKIP_NAN}
ZERO_FUSED = ["--param-partition", "zero1", "--ce-chunk", "8192",
              "--ce-impl", "kernel"]
ZERO_MIN_SIZE = 2 ** 14  # the partition rule's threshold (JAX's)
TOL_ZERO_LOSS = 1e-5                    # relative, vs replicated
TOL_ZERO_PARAMS = dict(rtol=2e-5, atol=1e-6)  # JAX's test_fsdp bounds
# The prediction (bytes): GPT-2-small's f32 leaves the rule cuts
# (124,439,808 params less the 121,344 of the norms and biases under
# 2^14 elements), and those it leaves whole.
ZERO_CUT_BYTES = (124_439_808 - 121_344) * 4
ZERO_WHOLE_BYTES = 121_344 * 4
TRAIN_ZERO_ARGV = TRAIN_TP_ARGV
TRAIN_ZERO_TIMEOUT_S = 600
# Mixture of experts: the repository's MoE cell (MOEBENCH.json line 1's
# configuration): moe_lm at GPT-2-small widths, 8 experts, top-2,
# capacity 1.25, batch 8 x 1024, bf16.
MOE_MODEL = dict(size="small", experts=8, B=8, L=1024)
MOE_PARAMS = 559_476_817  # 163,087,441 - 12 dense MLPs + 12 MoE MLPs
MOE_EP_SIZES = (2, 4)
MOE_CPU_ROWS = 2        # rows of the f32 plain model's run on the CPU
TOL_MOE_LOGITS = 1e-2   # dense vs scatter: max |diff| / max |ref|
TOL_MOE_LOSS = 1e-5     # stacked EP vs the whole model, relative
# The stacked legs route on their own to the whole model's experts in
# 98.7-98.8% of (token, k) slots at the cell's size (bf16 rounding of
# the router's input tips near-ties); a fault in the expert branch
# moves far more of them.
MOE_ROUTING_FLOOR = 0.97
MOE_STEPS = 20
TRAIN_MOE_ARGV = ["--mode", "train", "--model", "moe_lm", "--model-size",
                  "small", "--moe-experts", "8", "--seq-len", "1024",
                  "--batch-size", "8", "--train-steps", str(MOE_STEPS),
                  "--eval-every", "0", "--eval-batch-size", "8",
                  "--compute-dtype", "bfloat16", "--log-every", "1"]
MOE_LEGS = {"dense": [], "scatter": ["--moe-dispatch", "scatter"],
            "dense_fused": ["--ce-chunk", "8192", "--ce-impl", "kernel"]}
MOE_METRICS = ("aux_loss", "z_loss", "dropped_frac")
# serve_moe: 4 prompts that fill their power-of-two bucket, 4 that do
# not (their prefill group holds pad tokens).
MOE_SERVE_PROMPTS = (32, 64, 128, 256, 40, 100, 200, 300)
MOE_SERVE_NEW = 24
MOE_SERVE_SLOTS = 4
TRAIN_EP_STEPS = 10
TRAIN_EP_ARGV = ["--mode", "train", "--model", "moe_lm", "--model-size",
                 "small", "--moe-experts", "8", "--seq-len", "1024",
                 "--batch-size", "8", "--train-steps", str(TRAIN_EP_STEPS),
                 "--eval-every", "0", "--eval-batch-size", "8",
                 "--dropout-rate", "0", "--compute-dtype", "bfloat16",
                 "--log-every", "1", "--log-grad-norm", "true"]
TRAIN_EP_TIMEOUT_S = 900  # one torchrun of 4 ranks, builds included
# A train_ep run whose attention is cut (--mesh.model M) routes on a
# stream that TP's bf16 partial sums have rounded: ~1% of (token, k)
# slots tip to another expert than one card's (model_moe's free-running
# agreement), and from the third step the trajectories part (2.5e-2 by
# the fourth loss). Such a run holds its first TRAIN_EP_MODEL_LOSSES
# losses and its first step's gradient norm to one card's within
# TOL_RING_LOSS; the later losses are printed.
TRAIN_EP_MODEL_LOSSES = 2
# Pipeline parallelism: GPT-2-small as pipelined_lm, its weights the
# whole gpt_lm's (the same names), on StackedPipe(S) (every stage in this
# process) at (S, M) of PIPE_CASES against the whole model; then
# --mesh.pipe over torchrun.
PIPE_MODEL = dict(size="small", B=8, L=1024)
PIPE_CASES = ((2, 4), (4, 4), (4, 8))  # (stages S, microbatches M)
PIPE_V2_STAGES = 2  # 12 layers cut into S x 2 virtual stages: S 2 only
TOL_PIPE = 2e-2             # GPipe vs the whole model: logits, gradient
TOL_PIPE_LOSS = 1e-4        # GPipe vs the whole model: loss, relative
TOL_PIPE_SCHED_LOSS = 1e-5  # 1F1B vs GPipe: loss, relative
TOL_PIPE_SCHED_GRAD = 1e-4  # 1F1B vs GPipe: the whole gradient, relative
TRAIN_PIPE_STEPS = 10
TRAIN_PIPE_ARGV = ["--mode", "train", "--model", "pipelined_lm",
                   "--model-size", "small", "--seq-len", "1024",
                   "--batch-size", "8", "--train-steps",
                   str(TRAIN_PIPE_STEPS), "--eval-every", "0",
                   "--eval-batch-size", "8", "--dropout-rate", "0",
                   "--compute-dtype", "bfloat16", "--log-every", "1"]
TRAIN_PIPE_TIMEOUT_S = 600  # one torchrun, NCCL start-up included
PIPE_LAYERS = 12  # TRAIN_PIPE_ARGV's model's (each rank's share of B1-B3)
TOL_PIPE_EVAL = 1e-5  # --mode eval of the save vs the run's final eval
# Local SGD: GPT-2-small (untied) on the stacked transport of LSGD_D
# replicas, SGD (an update is lr x grad, so H 1 is the synchronous step).
LSGD_D = 4
LSGD_STEPS = 4
MODEL_LSGD_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                   "small", "--seq-len", "1024", "--batch-size", "8",
                   "--dropout-rate", "0", "--compute-dtype", "bfloat16",
                   "--optimizer", "sgd", "--train-steps", str(LSGD_STEPS),
                   "--eval-every", "0", "--eval-batch-size", "8",
                   "--mesh.data", str(LSGD_D)]
TRAIN_LSGD_ARGV = TRAIN_TP_ARGV + ["--param-sync-every", "4"]
TRAIN_LSGD_TIMEOUT_S = 600
# Pipe x model and pipe x seq: GPT-2-small as pipelined_lm on
# StackedPipe(2) with 4 microbatches, each stage's blocks on StackedTP(2)
# or its attention on StackedRing(2).
PIPE3D_MODEL = dict(size="small", B=8, L=1024, S=2, M=4, width=2)
PIPE3D_LEGS = ("gpipe", "recompute", "stash")
# Each leg's one-card run has its rank's tokens a microbatch: 2 rows of
# 1024 (M 4) under pipe x model; 1 row of 1024 (M 8) under data 2 and
# under seq 2, where a rank's 2-row microbatch holds 2 x 512 positions.
# The bf16 weight-gradient products follow that count: one card's M 4
# and M 8 runs part by 1.2e-2 at step 3 themselves.
TRAIN_PIPE3D_RUNS = (
    ("pipe2_model2", ["--mesh.pipe", "2", "--mesh.model", "2"], []),
    ("pipe2_seq2", ["--mesh.pipe", "2", "--mesh.seq", "2"],
     ["--pipeline-microbatches", "8"]),
    ("data2_pipe2_zero1", ["--mesh.data", "2", "--mesh.pipe", "2",
                           "--param-partition", "zero1"],
     ["--pipeline-microbatches", "8"]))
# Tensor-parallel serving and generation (--serve.mesh-model N, --mode
# generate --mesh.model M): model_serve_tp holds the decode engine on
# StackedTP(M) against the whole engine on the same weights at
# GPT-2-small's widths (one card); serve_tp and generate_tp run the CLI
# over four cards.
SERVE_TP_SIZES = (2,)  # every leg, and the bf16 logits
# M 4 of these legs too (GQA at M 4 keeps a rank the fewest K/V heads);
# M 4 of dense, paged and bf16 runs on four cards (serve_tp).
SERVE_TP_MORE = {"int8": (4,), "kgram": (4,), "gqa": (4,)}
SERVE_TP_SLOTS, SERVE_TP_REQUESTS, SERVE_TP_NEW = 4, 6, 16
SERVE_TP_PROMPTS = (8, 200)     # lengths spread evenly over this range
SERVE_TP_TURN_NEW = 8           # a session's second turn: its new tokens
SERVE_TP_BUCKETS = 256          # the ladder covers the second turns
SERVE_TP_BF16_STEPS = 8
TOL_SERVE_TP = 2e-2  # bf16 decode logits vs the whole engine, / max |ref|
SERVE_TP_WIDTH = 4
SERVE_TP_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size",
                 "small", "--synthetic-vocab", "50257", "--shard-vocab",
                 "true", "--seq-len", "1024",
                 "--serve.num-slots", "8", "--serve.num-requests", "32",
                 "--serve.prompt-len-min", "64", "--serve.prompt-len-max",
                 "512", "--serve.max-new-tokens", "64"]
SERVE_TP_PAGED = ["--serve.paged", "true", "--serve.prompt-len-max", "224",
                  "--serve.session-turns", "2"]
SERVE_TP_KILL_PLAN = "sigkill@10"
SERVE_TP_CLI_TIMEOUT_S = 300  # one supervised leg: start-up, spawn, serve
GENERATE_TP_ARGV = ["--model", "gpt_lm", "--model-size", "small",
                    "--seq-len", "1024", "--shard-vocab", "true",
                    "--synthetic-vocab", "50257"]
GENERATE_TP_TRAIN = ["--mode", "train", *GENERATE_TP_ARGV, "--batch-size",
                     "8", "--train-steps", "2", "--eval-every", "0",
                     "--eval-batch-size", "8", "--dropout-rate", "0",
                     "--ce-chunk", "8192", "--checkpoint-every", "2"]
GENERATE_TP_PROMPT = "464,3290,318,257,1332,286"
GENERATE_TP_RUN = ["--mode", "generate", *GENERATE_TP_ARGV,
                   "--compute-dtype", "float32", "--prompt",
                   GENERATE_TP_PROMPT, "--max-new-tokens", "32"]
GENERATE_TP_TIMEOUT_S = 600
# Elastic restarts: model_reshard saves GPT-2-small (model_zero's
# configuration: tied, Adam, EMA, clip, bf16) one step into
# stacked_data(4) fsdp and restores it with restore_resharded onto three
# other layouts (data width or partition, processes, model axis); each
# takes one more step, held to the unresharded state's next step: the
# loss (model_zero's 1e-5 on a data layout, model_tp's 2e-2 on the model
# axis), and what the step computed, its gradient, read from Adam's
# first moment (the step's mu less b1 x the restored mu, which is the
# written one to the bit: (1 - b1) x the gradient), ||diff|| / ||ref||
# over every param within model_tp's 2e-2 gradient gate (a gradient of
# half the batch, or never reduced across ranks, or Adam blocks paired
# with the wrong shards, reads 0.3 or more). The params after one Adam
# step of lr 1e-3 move at most about lr, so they are held only on the
# same-mesh control leg (model_zero's rtol 2e-5 / atol 1e-6, the
# writer's own layout); elsewhere they and the share of update elements
# whose sign changed are printed.
RESHARD_FROM = ("stacked4_fsdp", 4, "fsdp")
RESHARD_LEGS = (("stacked4_fsdp_same_mesh", 4, "fsdp"),
                ("stacked2_fsdp", 2, "fsdp"),
                ("one_process", 1, "replicated"),
                ("stacked_tp2", "tp", "replicated"))
# train_elastic: supervisor --elastic over the CLI (torchrun with more
# than one card); GPT-2-small, seq 1024, global batch 8, bf16, the dense
# head, saves every 2 steps.
TRAIN_ELASTIC_STEPS = 10
TRAIN_ELASTIC_GROWN = 14  # leg (b)'s steps on the returned capacity
TRAIN_ELASTIC_ARGV = ["--mode", "train", "--model", "gpt_lm", "--model-size",
                      "small", "--seq-len", "1024", "--batch-size", "8",
                      "--eval-every", "0", "--eval-batch-size", "8",
                      "--dropout-rate", "0", "--compute-dtype", "bfloat16",
                      "--log-every", "1", "--checkpoint-every", "2"]
TRAIN_ELASTIC_ONE_CARD = ("device_loss@3:1", 3)  # (plan, step)
TRAIN_ELASTIC_LOSS = ("device_loss@5:2", 5)
TRAIN_ELASTIC_SIGTERM = ("sigterm@5", 5)
TRAIN_ELASTIC_SIGTERM_EVERY = 4  # (d)'s cadence: the stop is no save step
TRAIN_ELASTIC_TIMEOUT_S = 300  # one supervisor run: its legs and probes
MODEL_RESNET_B = 4
MODEL_RESNET_IMAGE = 224
TOL_RESNET_F32 = 1e-3  # f32 on the card vs f32 on the CPU, train mode
TRAIN_RESNET50_ARGV = ["--mode", "train", "--model", "resnet50", "--dataset",
                       "imagenet_synthetic", "--batch-size", "64",
                       "--train-steps", "8", "--eval-every", "0",
                       "--eval-batch-size", "64", "--log-every", "1"]
TRAIN_RESNET20_ARGV = ["--mode", "train", "--model", "resnet20", "--dataset",
                       "cifar10_synthetic", "--batch-size", "128",
                       "--train-steps", "30", "--eval-every", "0",
                       "--eval-batch-size", "500", "--log-every", "1"]
TOL_EVAL_STATS = 1e-5  # final eval vs evaluate() of the restored state
CSRC = "tensorflow_distributed_tpu_torch/ops/csrc"
SOURCES = {"flash_attention": f"{CSRC}/flash_attention.cu",
           "fused_ce": f"{CSRC}/fused_ce.cu"}
# The kernels built from ops/csrc/hopper.cuh (wgmma, TMA, mbarriers,
# setmaxnreg), each with the library (SOURCES key) that holds it: B1's
# forward, B2's dQ, B3's dK/dV, B4's forward, B5's dx and B6's dW/db,
# and "<partial>", the instantiations of B1's, B2's and B3's kernels
# with the template flag PARTIAL = true: B7's forward, B8's dQ and B9's
# dK/dV.
HOPPER_KERNELS = {"flash_fwd_hopper": "flash_attention",
                  "flash_fwd_hopper<partial>": "flash_attention",
                  "flash_dq_hopper": "flash_attention",
                  "flash_dkv_hopper": "flash_attention",
                  "flash_dq_hopper<partial>": "flash_attention",
                  "flash_dkv_hopper<partial>": "flash_attention",
                  "fused_ce_fwd_hopper": "fused_ce",
                  "fused_ce_dx_hopper": "fused_ce",
                  "fused_ce_dw_hopper": "fused_ce"}
PARTIAL_FLAG = "Lb1E"  # the template argument `bool PARTIAL = true`, mangled
# Machine-code instructions counted per kernel (cuobjdump -sass).
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA")
# ptxas's warnings that it serialized a kernel's wgmmas (C7510-C7515).
WGMMA_SERIALIZED = re.compile(r"\bC751[0-5]\b")
TPU_FLASH = "tensorflow_distributed_tpu/ops/flash_attention.py"
TPU_CE = "tensorflow_distributed_tpu/ops/fused_ce_kernel.py"
REPLACES = {"flash_fwd": f"{TPU_FLASH}:183", "flash_dq": f"{TPU_FLASH}:255",
            "flash_dkv": f"{TPU_FLASH}:284", "fused_ce_fwd": f"{TPU_CE}:84",
            "fused_ce_dx": f"{TPU_CE}:147", "fused_ce_dw": f"{TPU_CE}:172",
            "flash_fwd_partial": f"{TPU_FLASH}:395",
            "flash_dq_partial": f"{TPU_FLASH}:451",
            "flash_dkv_partial": f"{TPU_FLASH}:479"}


_LAPS: list = []  # (phase, its seconds), in order
_LAP_T = [time.time()]


def lap(name: str) -> None:
    """Close phase ``name``: its seconds since the previous lap, also
    written to standard error at once, so that a run cut by a time limit
    still shows where its time went."""
    now = time.time()
    _LAPS.append((name, round(now - _LAP_T[0], 1)))
    _LAP_T[0] = now
    sys.stderr.write(f"[smoke] {name}: {_LAPS[-1][1]} s\n")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_ms(torch, fn, iters: int = 10):
    """Device time per call of ``fn`` by kernel name, {name: ms}, from
    torch.profiler's CUDA activity over ``iters`` calls after one warm-up
    call: the kernels' own time, without the host gaps between launches
    that CUDA events around a call also count. Empty when the profiler
    reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = us / iters / 1e3
    return out


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(fa, torch, B, H, L, D, causal, window):
    """(bound_ms, bound_by) of each kernel: each input read once, each
    output written once, against the tensor-core work of the (query,
    key) pairs inside the band."""
    BH, Lk = B * H, L
    rows = torch.arange(L)[:, None]
    cols = torch.arange(Lk)[None, :]
    pairs = (int(fa.window_keep(rows, cols, window).sum()) if causal
             else L * Lk)
    qbytes, kbytes, lse_bytes = BH * L * D * 2, BH * Lk * D * 2, BH * L * 4
    return {
        # S = QK^T, O = PV
        "flash_fwd": bound(2 * qbytes + 2 * kbytes + lse_bytes,
                           4 * BH * pairs * D),
        # S, dP = dO V^T, dQ = dS K
        "flash_dq": bound(4 * qbytes + 2 * kbytes + lse_bytes,
                          6 * BH * pairs * D),
        # S, dP, dV = P^T dO, dK = dS^T Q
        "flash_dkv": bound(3 * qbytes + 4 * kbytes + lse_bytes,
                           8 * BH * pairs * D),
    }


def sdpa_flash_bwd(torch, q4, k4, v4, do4, causal=True):
    """The one library call that computes dQ, dK and dV together from
    (q, k, v, out, lse, dO), as a call without arguments: the backward
    of PyTorch's flash SDPA, on [B, H, L, D] inputs, with its own
    forward's outputs."""
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    bwd = aten._scaled_dot_product_flash_attention_backward
    return lambda: bwd(do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k,
                       0.0, causal, seed, offset)


def phase_device(torch) -> str:
    gpu = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": gpu,
          "cuda_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "ninja": shutil.which("ninja") is not None,
          "nvcc": shutil.which("nvcc")})
    return gpu


def ptxas_by_kernel(log: str):
    """{mangled kernel name: its ptxas register and spill lines} from
    nvcc's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            out[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            out[cur].append(ln.strip())
    return out


def hopper_instance(fn: str):
    """The HOPPER_KERNELS key of a mangled kernel name: the "<partial>"
    key where the name carries the template flag PARTIAL = true. None
    for a kernel that is not on the Hopper header."""
    for key in HOPPER_KERNELS:
        base, _, form = key.partition("<")
        if base in fn and (PARTIAL_FLAG in fn) == bool(form):
            return key
    return None


def spills(lines) -> bool:
    """Whether ptxas's lines for one kernel report a spill store or load
    of more than 0 bytes."""
    return any(re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)
               for ln in lines)


def phase_build(fa, fce) -> None:
    """Both libraries, one nvcc each, started together. The Hopper
    kernels' registers and spills are listed by instantiation, and the
    run fails if one spills, if ptxas ignored a setmaxnreg (the warp roles
    must split in one if/else for it to hold) or if it serialized the
    wgmmas of a kernel."""
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as pool:
        logs = dict(zip(("flash_attention", "fused_ce"),
                        pool.map(lambda mod: mod.build(), (fa, fce))))
    hopper = {}
    for name, log in logs.items():
        for fn, lines in ptxas_by_kernel(log).items():
            short = hopper_instance(fn)
            if short is not None:
                hopper[f"{short}{'<128>' if 'ILi128E' in fn else ''}"] = lines
    cached = [name for name, log in logs.items() if not log]
    from tensorflow_distributed_tpu_torch.ops import cuda_ext

    by_lib = {name: sass_counts(cuda_ext.load(name)._name)
              for name in SOURCES}
    sass = {k: None if by_lib[name] is None
            else by_lib[name].get(k, dict.fromkeys(SASS_OPS, 0))
            for k, name in HOPPER_KERNELS.items()}
    library_hmma = {name: None if c is None
                    else sum(n["HMMA"] for n in c.values())
                    for name, c in by_lib.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "cached": cached, "hopper_ptxas": hopper, "hopper_sass": sass,
          "library_hmma": library_hmma,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in logs.items()}})
    for name, log in logs.items():
        check("setmaxnreg" not in log or "ignored" not in log,
              f"ptxas ignored setmaxnreg in {name}: {log}")
        check(not WGMMA_SERIALIZED.search(log),
              f"ptxas serialized wgmmas in {name}: {log}")
    for k, lines in hopper.items():
        check(not spills(lines), f"{k} spills: {lines}")
    check(cached or set(HOPPER_KERNELS) <= {k.replace("<128>", "")
                                             for k in hopper},
          f"the build did not compile every Hopper kernel: {sorted(hopper)}")
    for k, counts in sass.items():
        check(counts is None or (counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                                 and counts["SYNCS"] > 0
                                 and counts["HMMA"] == 0),
              f"{k} is not a wgmma/TMA/mbarrier kernel: {counts}")
    check(all(n in (None, 0) for n in library_hmma.values()),
          f"a library still holds mma.sync (WMMA) code: {library_hmma}")


def sass_counts(lib: str):
    """Counts of the Hopper instructions in the machine code of the
    library ``lib`` (cuobjdump -sass), {HOPPER_KERNELS key: counts, both
    head dims together}, the library's other functions under None:
    HGMMA (wgmma), UTMALDG (TMA tensor load), SYNCS (mbarrier
    arrive/wait) and HMMA (the mma.sync that WMMA compiles to, which no
    kernel may use). None without cuobjdump."""
    from tensorflow_distributed_tpu_torch.ops import cuda_ext

    tool = os.path.join(os.path.dirname(cuda_ext.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120).stdout
    by_kernel = {}
    for part in out.split("Function : ")[1:]:
        counts = by_kernel.setdefault(
            hopper_instance(part.split("\n", 1)[0]),
            dict.fromkeys(SASS_OPS, 0))
        for ln in part.splitlines():
            words = ln.split("*/", 1)[-1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            op = words[0]
            for key in counts:
                if op.startswith(key + ".") or op == key:
                    counts[key] += 1
    return by_kernel


def flash_case(fa, torch, phase, case, seed):
    """B1-B3 on one case's random bf16 inputs (``seed``) against their
    plain versions in f32 from the same inputs: emits the errors as a
    ``phase`` row and fails past phase 3's gates. Returns (the row,
    (q, k, v, dO, out, lse) on the card)."""
    B, H, L, D = case["B"], case["H"], case["L"], case["D"]
    causal, window = case["causal"], case["window"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B * H, L, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal, window)
    dq = fa.flash_dq(q, k, v, out, lse, do, causal, window)
    dk, dv = fa.flash_dkv(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, out, do)]
    ref_o, ref_lse = fa.flash_attention_reference(f[0], f[1], f[2],
                                                  causal, window)
    ref_dq = fa.flash_dq_reference(f[0], f[1], f[2], f[3], lse, f[4],
                                   causal, window)
    ref_dk, ref_dv = fa.flash_dkv_reference(f[0], f[1], f[2], f[3], lse,
                                            f[4], causal, window)

    def abs_err(a, b):
        return float((a.float() - b).abs().max())

    def rel_err(a, b):
        return abs_err(a, b) / float(b.abs().max())

    row = {"phase": phase, **case,
           "o_abs_err": abs_err(out, ref_o),
           "lse_abs_err": abs_err(lse, ref_lse),
           "dq_rel_err": rel_err(dq, ref_dq),
           "dk_rel_err": rel_err(dk, ref_dk),
           "dv_rel_err": rel_err(dv, ref_dv),
           "dq_abs_err": abs_err(dq, ref_dq),
           "dkv_abs_err": max(abs_err(dk, ref_dk), abs_err(dv, ref_dv))}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out, lse, dq, dk, dv))
    emit(row)
    check(finite, f"non-finite kernel output in case {case}")
    check(row["o_abs_err"] <= TOL_O, f"flash_fwd out error {row}")
    check(row["lse_abs_err"] <= TOL_LSE, f"flash_fwd lse error {row}")
    for g in ("dq", "dk", "dv"):
        check(row[f"{g}_rel_err"] <= TOL_GRAD, f"{g} error {row}")
    return row, (q, k, v, do, out, lse)


def phase_kernels(fa, torch, F):
    """Correctness of every case; times at the main (training) case."""
    results = {}
    for i, case in enumerate(CASES):
        B, H, L, D = case["B"], case["H"], case["L"], case["D"]
        causal, window = case["causal"], case["window"]
        row, (q, k, v, do, out, lse) = flash_case(fa, torch, "kernels", case,
                                                  i)
        if i == 0:
            results["errors"] = row
            results["bounds"] = kernel_bounds(fa, torch, B, H, L, D, causal,
                                              window)
            results["ms"] = {
                "flash_fwd": time_ms(torch, lambda: fa.flash_fwd(
                    q, k, v, causal, window)),
                "flash_dq": time_ms(torch, lambda: fa.flash_dq(
                    q, k, v, out, lse, do, causal, window)),
                "flash_dkv": time_ms(torch, lambda: fa.flash_dkv(
                    q, k, v, out, lse, do, causal, window)),
            }
            results["plain_ms"] = {
                "flash_fwd": time_ms(
                    torch, lambda: fa.flash_attention_reference(
                        q, k, v, causal, window)),
                "flash_dq": time_ms(torch, lambda: fa.flash_dq_reference(
                    q, k, v, out, lse, do, causal, window)),
                "flash_dkv": time_ms(torch, lambda: fa.flash_dkv_reference(
                    q, k, v, out, lse, do, causal, window)),
            }
            q4, k4, v4, do4 = (t.view(B, H, L, D) for t in (q, k, v, do))
            sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True))
            qr, kr, vr = (t.detach().clone().requires_grad_()
                          for t in (q4, k4, v4))

            def sdpa_fwd_bwd():
                o4 = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
                torch.autograd.grad(o4, (qr, kr, vr), do4)

            # No library call computes dQ alone or dK/dV alone (null in
            # the kernels line); the flash backward computes all three.
            results["library_ms"] = {"flash_fwd": sdpa_fwd, "flash_dq": None,
                                     "flash_dkv": None}
            # Device time alone (torch.profiler): a short kernel's event
            # time also holds the host side of its call.
            sdpa_bwd = sdpa_flash_bwd(torch, q4, k4, v4, do4)
            fwd_device = {
                "flash_fwd": sum(device_ms(torch, lambda: fa.flash_fwd(
                    q, k, v, causal, window), 20).values()) or None,
                "sdpa_fwd": sum(device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True), 20).values()) or None}
            bwd_device = {
                "flash_dq": sum(device_ms(torch, lambda: fa.flash_dq(
                    q, k, v, out, lse, do, causal, window), 20).values())
                or None,
                "flash_dkv": sum(device_ms(torch, lambda: fa.flash_dkv(
                    q, k, v, out, lse, do, causal, window), 20).values())
                or None,
                "sdpa_flash_bwd": sum(device_ms(torch, sdpa_bwd,
                                                20).values()) or None}
            emit({"phase": "timing", **case, "ms": results["ms"],
                  "plain_ms": results["plain_ms"],
                  "fwd_device_ms": fwd_device,
                  "bwd_device_ms": bwd_device,
                  "sdpa_fwd_ms": sdpa_fwd,
                  "sdpa_fwd_bwd_ms": time_ms(torch, sdpa_fwd_bwd),
                  "sdpa_flash_bwd_ms": time_ms(torch, sdpa_bwd),
                  "flash_dq_plus_dkv_ms": (results["ms"]["flash_dq"]
                                           + results["ms"]["flash_dkv"]),
                  "flash_fwd_bwd_ms": sum(results["ms"].values()),
                  "bound_ms": {k: b[0] for k, b in results["bounds"].items()}})
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return results


def ce_bounds(T, D, V, bias):
    """(bound_ms, bound_by) of each fused-CE kernel: each input read
    once and each output written once, against the tensor-core work the
    function needs (the logits product, plus the dx or dW product)."""
    x, w, rows = T * D * 2, V * D * 2, T * 4
    b = V * 4 if bias else 0
    inputs = x + w + b + rows  # + targets
    return {
        "fused_ce_fwd": bound(inputs + 3 * rows, 2 * T * D * V),
        "fused_ce_dx": bound(inputs + 2 * rows + x, 4 * T * D * V),
        "fused_ce_dw": bound(inputs + 2 * rows + V * D * 4 + b,
                             4 * T * D * V),
    }


def phase_ce_kernels(fce, torch, F):
    """Correctness of every case; times at the main (training) case."""
    results = {}
    for i, case in enumerate(CE_CASES):
        T, D, V, eps = case["T"], case["D"], case["V"], case["eps"]
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn((T, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (0.05 * torch.randn((V, D), generator=gen, device="cuda")).to(
            torch.bfloat16)
        b = (0.1 * torch.randn(V, generator=gen, device="cuda")
             if case["bias"] else None)
        t = torch.randint(0, V, (T,), generator=gen, device="cuda",
                          dtype=torch.int32)
        coef = torch.rand(T, generator=gen, device="cuda")
        if case.get("mask"):
            coef = (coef < case["mask"]).float()
        ce, correct, lse = fce.fused_ce_fwd(x, w, b, t, V, eps)
        dx = fce.fused_ce_dx(x, w, b, t, lse, coef, V, eps)
        dw, db = fce.fused_ce_dw(x, w, b, t, lse, coef, V, eps)
        torch.cuda.synchronize()
        ref_ce, ref_correct, ref_lse = fce.fused_ce_fwd_reference(
            x, w, b, t, V, eps)
        ref_dx = fce.fused_ce_dx_reference(x, w, b, t, lse, coef, V, eps)
        ref_dw, ref_db = fce.fused_ce_dw_reference(x, w, b, t, lse, coef,
                                                   V, eps)
        logits = x.float() @ w.float().T + (0.0 if b is None else b)
        top2 = logits.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
        del logits, top2

        def abs_err(a, ref):
            return float((a.float() - ref.float()).abs().max())

        def rel_err(a, ref):
            return abs_err(a, ref) / float(ref.float().abs().max())

        row = {"phase": "ce_kernels", **case,
               "ce_abs_err": abs_err(ce, ref_ce),
               "lse_abs_err": abs_err(lse, ref_lse),
               "correct_mismatches": int((correct != ref_correct)[
                   decided].sum()),
               "correct_undecided": int((~decided).sum()),
               "dx_rel_err": rel_err(dx, ref_dx),
               "dw_rel_err": rel_err(dw, ref_dw),
               "db_rel_err": None if b is None else rel_err(db, ref_db),
               "dx_abs_err": abs_err(dx, ref_dx),
               "dw_abs_err": max([abs_err(dw, ref_dw)] + (
                   [] if b is None else [abs_err(db, ref_db)]))}
        finite = all(bool(torch.isfinite(v).all())
                     for v in (ce, lse, dx, dw) + (() if b is None else (db,)))
        emit(row)
        check(finite, f"non-finite fused-CE kernel output in case {case}")
        check(row["ce_abs_err"] <= TOL_CE and row["lse_abs_err"] <= TOL_CE,
              f"fused_ce_fwd ce/lse error {row}")
        check(row["correct_mismatches"] == 0, f"fused_ce_fwd argmax {row}")
        check(row["dx_rel_err"] <= TOL_CE_GRAD, f"fused_ce_dx error {row}")
        check(row["dw_rel_err"] <= TOL_CE_GRAD, f"fused_ce_dw error {row}")
        check((db is None) == (b is None), f"db without bias {row}")
        check(b is None or row["db_rel_err"] <= TOL_DB,
              f"fused_ce_dw db error {row}")
        if i == 0:
            results["errors"] = row
            results["bounds"] = ce_bounds(T, D, V, case["bias"])
            results["ms"] = {
                "fused_ce_fwd": time_ms(torch, lambda: fce.fused_ce_fwd(
                    x, w, b, t, V, eps)),
                "fused_ce_dx": time_ms(torch, lambda: fce.fused_ce_dx(
                    x, w, b, t, lse, coef, V, eps)),
                "fused_ce_dw": time_ms(torch, lambda: fce.fused_ce_dw(
                    x, w, b, t, lse, coef, V, eps)),
            }
            results["plain_ms"] = {
                "fused_ce_fwd": time_ms(torch, lambda: (
                    fce.fused_ce_fwd_reference(x, w, b, t, V, eps))),
                "fused_ce_dx": time_ms(torch, lambda: (
                    fce.fused_ce_dx_reference(x, w, b, t, lse, coef, V,
                                              eps))),
                "fused_ce_dw": time_ms(torch, lambda: (
                    fce.fused_ce_dw_reference(x, w, b, t, lse, coef, V,
                                              eps))),
            }
            # No single library call computes any of the three functions
            # (null in the kernels line); the dense head + cross-entropy
            # is the yardstick for the three together.
            results["library_ms"] = dict.fromkeys(results["ms"])
            tl, bb = t.long(), b.to(torch.bfloat16)
            dense_fwd = time_ms(torch, lambda: F.cross_entropy(
                F.linear(x, w, bb).float(), tl, reduction="none"))
            xr, wr, br = (v.detach().clone().requires_grad_()
                          for v in (x, w, bb))

            def dense_fwd_bwd():
                loss = F.cross_entropy(F.linear(xr, wr, br).float(), tl,
                                       reduction="none")
                torch.autograd.grad(loss, (xr, wr, br), coef)

            calls = {"fused_ce_fwd": lambda: fce.fused_ce_fwd(
                         x, w, b, t, V, eps),
                     "fused_ce_dx": lambda: fce.fused_ce_dx(
                         x, w, b, t, lse, coef, V, eps),
                     "fused_ce_dw": lambda: fce.fused_ce_dw(
                         x, w, b, t, lse, coef, V, eps)}
            emit({"phase": "ce_timing", **case, "ms": results["ms"],
                  "plain_ms": results["plain_ms"],
                  "device_ms": {name: sum(device_ms(torch, fn).values())
                                or None for name, fn in calls.items()},
                  "dense_fwd_ms": dense_fwd,
                  "dense_fwd_bwd_ms": time_ms(torch, dense_fwd_bwd),
                  "fused_fwd_bwd_ms": sum(results["ms"].values()),
                  "bound_ms": {k: v[0] for k, v in results["bounds"].items()}})
            del xr, wr, br
        del x, w, b, t, coef, ce, correct, lse, dx, dw, db
        del ref_ce, ref_correct, ref_lse, ref_dx, ref_dw, ref_db
        torch.cuda.empty_cache()
    return results


def phase_model(fa, torch, np) -> None:
    """A small GPT through the kernels (bf16, card) against the same
    weights through the plain path (f32, CPU): logits and every grad."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
    from tensorflow_distributed_tpu_torch.ops.losses import (
        masked_softmax_cross_entropy)

    shape = dict(d_model=128, n_heads=2, d_ff=256, max_len=128)
    ref_model = gpt_lm("tiny", compute_dtype=torch.float32, **shape)
    ref_model.init_weights(torch.Generator().manual_seed(0))
    model = gpt_lm("tiny", compute_dtype=torch.bfloat16, **shape).cuda()
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    targets = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    mask = torch.ones((4, 128))
    before = [kern.launches for kern in fa.KERNELS]

    def run(m, dev):
        logits = m(tokens.to(dev))
        loss = masked_softmax_cross_entropy(logits, targets.to(dev),
                                            mask.to(dev))
        loss.backward()
        return logits.detach().cpu(), {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}

    ref_logits, ref_grads = run(ref_model, "cpu")
    logits, grads = run(model, "cuda")
    torch.cuda.synchronize()
    launched = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
    logit_err = float((logits - ref_logits).abs().max()
                      / ref_logits.abs().max())
    grad_err = max(float((grads[n] - g).abs().max() / g.abs().max())
                   for n, g in ref_grads.items() if float(g.abs().max()) > 0)
    emit({"phase": "model", "logits_rel_err": logit_err,
          "grads_rel_err": grad_err, "kernel_launches": launched,
          "tolerance": TOL_MODEL})
    check(all(n == 2 for n in launched),
          f"model check did not run every kernel once per layer: {launched}")
    check(logit_err <= TOL_MODEL and grad_err <= TOL_MODEL,
          f"model on the card disagrees with the plain path: "
          f"logits {logit_err}, grads {grad_err}")


def phase_model_fused(fce, torch, np) -> None:
    """The same small GPT through ``features_only`` and the CE kernels
    (bf16, card) against the plain versions (f32, CPU), untied and tied:
    the loss and every grad; each CE kernel launches once per call."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    shape = dict(d_model=128, n_heads=2, d_ff=256, max_len=128)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    targets = torch.from_numpy(rng.integers(0, 64, size=(4, 128)))
    mask = torch.from_numpy((rng.random((4, 128)) < 0.8).astype(np.float32))
    for tie in (False, True):
        ref_model = gpt_lm("tiny", compute_dtype=torch.float32,
                           tie_embeddings=tie, **shape)
        ref_model.init_weights(torch.Generator().manual_seed(0))
        model = gpt_lm("tiny", compute_dtype=torch.bfloat16,
                       tie_embeddings=tie, **shape).cuda()
        model.load_state_dict(ref_model.state_dict())

        def run(m, dev):
            feats, w, bias = m(tokens.to(dev), features_only=True)
            ce, _, n = fce.fused_ce_sums_kernel(
                feats, w, bias, targets.to(dev), mask.to(dev), w.shape[0])
            loss = ce / n
            loss.backward()
            return float(loss.detach()), {k: p.grad.cpu()
                                 for k, p in m.named_parameters()}

        ref_loss, ref_grads = run(ref_model, "cpu")
        fce.reset_launch_counts()
        loss, grads = run(model, "cuda")
        torch.cuda.synchronize()
        launched = {kern.name: kern.launches for kern in fce.KERNELS}
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        grad_err = max(float((grads[k] - g).abs().max() / g.abs().max())
                       for k, g in ref_grads.items()
                       if float(g.abs().max()) > 0)
        emit({"phase": "model_fused", "tie_embeddings": tie,
              "loss_rel_err": loss_err, "grads_rel_err": grad_err,
              "kernel_launches": launched, "tolerance": TOL_MODEL})
        check(all(n == 1 for n in launched.values()),
              f"fused model check did not launch each CE kernel once: "
              f"{launched}")
        check(loss_err <= TOL_MODEL and grad_err <= TOL_MODEL,
              f"fused model on the card disagrees with the plain path: "
              f"loss {loss_err}, grads {grad_err}")


def run_train(kernels, torch, phase, argv, beside=None, on_result=None,
              falls=True):
    """One training run through the port's CLI path, every launch count
    set to 0 just before it and read just after. Checks what every run
    must show (finite, falling loss; a final eval) and returns its
    record: ``launches`` (the whole run, final eval included),
    ``train_launches`` and ``train_peak_mem_bytes`` (read at the last
    step's record, before the final eval) and the loss trajectory.
    ``beside`` ({name: record}) puts another run's numbers beside
    these; ``on_result`` is handed the run's ``TrainResult``; ``falls``
    False leaves out the falling-loss check (a throughput run)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    class StepReads(MetricLogger):
        """Reads the launch counts and the peak memory at each step's
        record: after the step is enqueued, before the final eval."""

        def log(self, step, **metrics):
            super().log(step, **metrics)
            if "loss" in metrics:
                self.at_step = ({kern.name: kern.launches for kern in kernels},
                                torch.cuda.max_memory_allocated())

    cfg = parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    logger = StepReads(stream=sys.stderr)
    t0 = time.time()
    result = train(cfg, logger=logger)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    records = [r for r in result.logger.records if "loss" in r.metrics]
    losses = [r.metrics["loss"] for r in records]
    times = [r.wall_time for r in records]
    step_s = [b - a for a, b in zip(times, times[1:])]
    step_ms = statistics.median(step_s[4:] or step_s) * 1e3  # steps 6..
    train_launches, train_peak = logger.at_step
    rec = {"phase": phase, "argv": argv, "steps": len(losses),
           "first_loss": losses[0],
           "last5_mean_loss": statistics.mean(losses[-5:]),
           "step_ms_median": step_ms,
           **({"tokens_per_s": cfg.batch_size * cfg.seq_len / step_ms * 1e3}
              if cfg.seq_len else
              {"images_per_s": cfg.batch_size / step_ms * 1e3}),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "train_peak_mem_bytes": train_peak,
           "eval": result.final_metrics, "launches": launches,
           "train_launches": train_launches, "wall_s": round(wall, 3)}
    for name, other in (beside or {}).items():
        rec[name] = {k: other[k] for k in (
            "first_loss", "step_ms_median", "tokens_per_s", "peak_mem_bytes")}
    emit(rec)
    check(len(losses) == cfg.train_steps,
          f"{phase}: expected {cfg.train_steps} loss records")
    check(all(math.isfinite(x) for x in losses),
          f"{phase}: non-finite loss {losses}")
    check(not falls or statistics.mean(losses[-5:]) < losses[0],
          f"{phase}: loss did not fall: {losses}")
    check(math.isfinite(result.final_metrics.get("loss", math.nan)),
          f"{phase}: final eval did not run")
    rec["losses"] = losses
    if on_result is not None:
        on_result(result)
    return rec


def phase_train(kernels, torch):
    rec = run_train(kernels, torch, "train", TRAIN_ARGV)
    n, launches = 12 * 30, rec["launches"]
    check(launches["flash_dq"] == n and launches["flash_dkv"] == n
          and launches["flash_fwd"] >= n,
          f"the run did not go through every flash kernel: {launches}")
    check(all(launches[k] == 0 for k in CE_KERNELS + RING_KERNELS),
          f"the dense run launched a fused-CE or ring kernel: {launches}")
    return rec


def phase_train_fused(kernels, torch, dense):
    """The tentpole command: the dense run with the head and loss fused
    into the CE kernels (eval by the scan formulation, no kernel)."""
    rec = run_train(kernels, torch, "train_fused", TRAIN_FUSED_ARGV,
                    {"dense": dense})
    launches = rec["launches"]
    check(all(launches[k] == 30 for k in CE_KERNELS),
          f"the fused run did not launch each CE kernel once per step: "
          f"{launches}")
    check(all(launches[k] == dense["launches"][k]
              for k in ("flash_fwd", "flash_dq", "flash_dkv")),
          f"flash launches differ from the dense run: {launches}")
    check(abs(rec["first_loss"] - dense["first_loss"]) <= TOL_FIRST_LOSS,
          f"first-step loss {rec['first_loss']} vs dense "
          f"{dense['first_loss']}")
    return rec


def profile_steps(torch, one, steps: int = PROFILE_STEPS) -> dict:
    """Where a train step's time goes: ``one(fetch)`` runs one step
    (ending in a host fetch of its loss when ``fetch``, as with
    --log-every 1). Over ``steps`` steps after 3 warm-up steps: the
    host-clocked step with and without the per-step fetch; the host's
    time to enqueue one step from an idle device; the device time of the
    steps from torch.profiler (CUDA activity), by kernel kind; and the
    host ops with the most self CPU time (CPU activity; the profiler's
    own cost inflates them)."""
    from torch.profiler import ProfilerActivity, profile

    def steps_ms(fetch):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            one(fetch)
        torch.cuda.synchronize()
        return (time.time() - t0) / steps * 1e3

    for _ in range(3):
        one(True)
    step_ms = steps_ms(True)
    step_ms_no_fetch = steps_ms(False)
    torch.cuda.synchronize()
    t0 = time.time()
    one(False)
    enqueue_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            one(True)
        torch.cuda.synchronize()
    host_top = [[e.key[:60], e.self_cpu_time_total / steps / 1e3,
                 e.count / steps]
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:8]]
    dev = device_ms(torch, lambda: one(True), steps)
    busy = sum(dev.values())
    kinds = {"flash": 0.0, "fused_ce": 0.0, "conv": 0.0, "gemm": 0.0,
             "other": 0.0}
    for name, ms in dev.items():
        low = name.lower()
        kind = ("flash" if "flash_" in low else
                "fused_ce" if "fused_ce" in low else
                "conv" if any(k in low for k in ("conv", "fprop", "dgrad",
                                                 "wgrad")) else
                "gemm" if any(k in low for k in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "cublas"))
                else "other")
        kinds[kind] += ms
    return {"step_ms": step_ms, "step_ms_no_fetch": step_ms_no_fetch,
            "host_enqueue_ms": enqueue_ms, "host_top_self_ms_calls": host_top,
            "device_busy_ms": busy or None,
            "device_idle_share": (1 - busy / step_ms) if busy else None,
            "device_ms_by_kind": kinds,
            "device_top": [[name[:80], ms] for name, ms in sorted(
                dev.items(), key=lambda kv: -kv[1])[:8]]}


def profiled(torch, argv, steps: int = PROFILE_STEPS) -> dict:
    """``profile_steps`` of the train step of ``argv`` on cuda:0, over
    four batches of its stream in turn (measurement only: no launch
    count of a train phase is read after it)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.data.prefetch import to_device
    from tensorflow_distributed_tpu_torch.train import loop
    from tensorflow_distributed_tpu_torch.train.step import make_train_step
    from tensorflow_distributed_tpu_torch.train.tasks import make_task

    device = torch.device("cuda")
    cfg = parse_args(argv)
    task = make_task(cfg)
    _, state = loop._build_model_and_state(cfg, device)
    step = make_train_step(task.loss, device, cfg.seed)
    stream = task.train_stream(0)
    batches = [to_device(next(stream), device) for _ in range(4)]
    it = iter(range(10 ** 9))

    def one(fetch):
        nonlocal state
        state, metrics = step(state, batches[next(it) % len(batches)])
        if fetch:
            float(metrics["loss"])

    out = profile_steps(torch, one, steps)
    del state, batches
    torch.cuda.empty_cache()
    return out


def phase_step_profile(torch) -> None:
    """Where a train step's time goes, for the dense, the fused, the
    Llama-style and the windowed run's flags (``profile_steps``)."""
    for run, argv in (("train", TRAIN_ARGV), ("train_fused", TRAIN_FUSED_ARGV),
                      ("train_llama", TRAIN_LLAMA_ARGV),
                      ("train_window", TRAIN_WINDOW_ARGV)):
        emit({"phase": "step_profile", "run": run,
              "steps": STEP_PROFILE_STEPS,
              **profiled(torch, argv, STEP_PROFILE_STEPS)})


def partial_bounds(B, H, nh, D, causal):
    """(bound_ms, bound_by) of each partial kernel on [B*H, nh, D]
    blocks: q, k, v bf16 read once, the f32 o / dO and the f32 rows
    (m, l, dl) read or written once, the bf16 grads written once,
    against the tensor-core work of the (query, key) pairs in the
    block (the in-block triangle when causal)."""
    BH = B * H
    pairs = nh * (nh + 1) // 2 if causal else nh * nh
    x16, x32, rows = BH * nh * D * 2, BH * nh * D * 4, BH * nh * 4
    return {
        # S = QK^T, O = PV; writes o (f32), m, l
        "flash_fwd_partial": bound(3 * x16 + x32 + 2 * rows,
                                   4 * BH * pairs * D),
        # S, dP = dO V^T, dQ = dS K; reads m, dl, dO (f32)
        "flash_dq_partial": bound(3 * x16 + 2 * rows + x32 + x16,
                                  6 * BH * pairs * D),
        # S, dP, dV = P^T dO, dK = dS^T Q
        "flash_dkv_partial": bound(3 * x16 + 2 * rows + x32 + 2 * x16,
                                   8 * BH * pairs * D),
    }


def phase_ring_kernels(fa, torch, gpu):
    """Correctness of every case; event and plain times at the main case,
    device times at every D 64 case, and SDPA's flash backward at the
    half-block."""
    results = {}
    for i, case in enumerate(RING_KERNEL_CASES):
        B, H, nh, D, causal = (case[k] for k in ("B", "H", "nh", "D",
                                                 "causal"))
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v = (torch.randn((B * H, nh, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        do = torch.randn((B * H, nh, D), generator=gen, device="cuda")
        dl = torch.randn((B * H, nh), generator=gen, device="cuda")
        o, m, l = fa.flash_fwd_partial(q, k, v, causal)
        dq = fa.flash_dq_partial(q, k, v, m, do, dl, causal)
        dk, dv = fa.flash_dkv_partial(q, k, v, m, do, dl, causal)
        torch.cuda.synchronize()
        f = [t.float() for t in (q, k, v)]
        ref_o, ref_m, ref_l = fa.flash_fwd_partial_reference(*f, causal)
        ref_dq = fa.flash_dq_partial_reference(*f, m, do, dl, causal)
        ref_dk, ref_dv = fa.flash_dkv_partial_reference(*f, m, do, dl,
                                                        causal)

        def abs_err(a, b):
            return float((a.float() - b).abs().max())

        def rel_err(a, b):
            return abs_err(a, b) / float(b.abs().max())

        row = {"phase": "ring_kernels", **case,
               "o_rel_err": rel_err(o, ref_o),
               "m_abs_err": abs_err(m, ref_m),
               "l_abs_err": abs_err(l, ref_l),
               "dq_rel_err": rel_err(dq, ref_dq),
               "dk_rel_err": rel_err(dk, ref_dk),
               "dv_rel_err": rel_err(dv, ref_dv),
               "o_abs_err": abs_err(o, ref_o),
               "dq_abs_err": abs_err(dq, ref_dq),
               "dkv_abs_err": max(abs_err(dk, ref_dk), abs_err(dv, ref_dv))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (o, m, l, dq, dk, dv))
        emit(row)
        check(finite, f"non-finite partial kernel output in case {case}")
        check(row["o_rel_err"] <= TOL_PARTIAL_O,
              f"flash_fwd_partial o error {row}")
        check(row["m_abs_err"] <= TOL_STATS and row["l_abs_err"] <= TOL_STATS,
              f"flash_fwd_partial m/l error {row}")
        for g in ("dq", "dk", "dv"):
            check(row[f"{g}_rel_err"] <= TOL_RING, f"partial {g} error {row}")
        # At these sizes a launch is short next to its host-side call
        # (checks, allocations, ctypes): the kernels' device time alone,
        # from the profiler, at the 128- and 512-row cases (D 64).
        calls = {"flash_fwd_partial": lambda: fa.flash_fwd_partial(
                     q, k, v, causal),
                 "flash_dq_partial": lambda: fa.flash_dq_partial(
                     q, k, v, m, do, dl, causal),
                 "flash_dkv_partial": lambda: fa.flash_dkv_partial(
                     q, k, v, m, do, dl, causal)}
        timing = {"phase": "ring_kernels_timing", **case, "gpu": gpu}
        bounds = partial_bounds(B, H, nh, D, causal)
        if i == 0:
            results["errors"] = row
            results["bounds"] = bounds
            results["ms"] = {name: time_ms(torch, fn)
                             for name, fn in calls.items()}
            results["plain_ms"] = {
                "flash_fwd_partial": time_ms(torch, lambda: (
                    fa.flash_fwd_partial_reference(q, k, v, causal))),
                "flash_dq_partial": time_ms(torch, lambda: (
                    fa.flash_dq_partial_reference(q, k, v, m, do, dl,
                                                  causal))),
                "flash_dkv_partial": time_ms(torch, lambda: (
                    fa.flash_dkv_partial_reference(q, k, v, m, do, dl,
                                                   causal))),
            }
            # No PyTorch call returns the unnormalized (o, m, l) of a
            # block or its partial gradients (SDPA normalizes).
            results["library_ms"] = dict.fromkeys(results["ms"])
            timing.update(ms=results["ms"], plain_ms=results["plain_ms"])
        if D == 64:
            timing["device_ms"] = {
                name: sum(device_ms(torch, fn, 20).values()) or None
                for name, fn in calls.items()}
            timing["bound_ms"] = {k: b[0] for k, b in bounds.items()}
        if nh == 128:
            # A work-equivalent yardstick for B8 + B9 together, not their
            # function: SDPA's flash backward on the same half-block does
            # the same products for the normalized softmax.
            q4, k4, v4, do4 = (t.view(B, H, nh, D) for t in (
                q, k, v, do.to(torch.bfloat16)))
            timing["sdpa_flash_bwd_device_ms"] = sum(device_ms(
                torch, sdpa_flash_bwd(torch, q4, k4, v4, do4, causal),
                20).values()) or None
            del q4, k4, v4, do4
        if "device_ms" in timing:
            emit(timing)
        del q, k, v, do, dl, o, m, l, dq, dk, dv, f
        del ref_o, ref_m, ref_l, ref_dq, ref_dk, ref_dv
        torch.cuda.empty_cache()
    return results


def phase_ring(fa, ra, torch, gpu):
    """The stacked zigzag ring on the card: launches per call (counted
    from 0 around the first case's fwd+bwd, the kernels line's
    launches), agreement with the flash kernels and the plain version,
    and times."""
    launches = None
    for case in RING_CASES:
        S, B, H, L, D = (case[k] for k in ("S", "B", "H", "L", "D"))
        gen = torch.Generator(device="cuda").manual_seed(300 + S)
        q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        ring = ra.StackedRing(S)
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        out = ra.ring_attention(*x, ring, causal=True)
        torch.autograd.backward(out, do)
        torch.cuda.synchronize()
        counts = {kern.name: kern.launches
                  for kern in fa.KERNELS + fa.PARTIAL_KERNELS}
        if launches is None:
            launches = counts
        got = [out.detach()] + [t.grad for t in x]
        del x, out

        y = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_out = fa.flash_attention(*y, causal=True)
        torch.autograd.backward(flash_out, do)
        flash = [flash_out.detach()] + [t.grad for t in y]
        del y, flash_out

        def rel_err(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())

        names = ("out", "dq", "dk", "dv")
        row = {"phase": "ring", **case, "gpu": gpu, "launches": counts,
               "vs_flash_rel_err": {n: rel_err(a, b)
                                    for n, a, b in zip(names, got, flash)}}
        del flash
        if L * L * B * H * 4 <= PLAIN_SCORE_BYTES:
            z = [t.float().requires_grad_() for t in (q, k, v)]
            ref = ra.full_attention(*z, ra.causal_bias(L, L, "cuda"))
            torch.autograd.backward(ref, do.float())
            plain = [ref.detach()] + [t.grad for t in z]
            row["vs_plain_rel_err"] = {n: rel_err(a, b)
                                       for n, a, b in zip(names, got, plain)}
            del z, ref, plain
        else:  # the last query rows, forward
            r0 = L - RING_PLAIN_ROWS
            rows = torch.arange(r0, L, device="cuda")[:, None]
            cols = torch.arange(L, device="cuda")[None, :]
            bias = torch.where(cols <= rows, 0.0, -1e30)[None]
            ref = ra.full_attention(q[:, r0:].float(), k.float(), v.float(),
                                    bias)
            row["vs_plain_rel_err"] = {
                f"out_last_{RING_PLAIN_ROWS}_rows": rel_err(got[0][:, r0:],
                                                            ref)}
            del ref, bias
        xr = [t.clone().requires_grad_() for t in (q, k, v)]
        yr = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            row["fwd_ms"] = time_ms(torch, lambda: ra.ring_attention(
                q, k, v, ring, causal=True), iters=10)
            row["flash_fwd_ms"] = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=True), iters=10)
        row["fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.backward(
            ra.ring_attention(*xr, ring, causal=True), do), iters=10)
        row["flash_fwd_bwd_ms"] = time_ms(
            torch, lambda: torch.autograd.backward(
                fa.flash_attention(*yr, causal=True), do), iters=10)
        # Device time of one ring fwd+bwd: every kernel, the partial
        # kernels' share (the rest is the zigzag's selects, merges and
        # permutes), and the largest kernels by name.
        dev = device_ms(torch, lambda: torch.autograd.backward(
            ra.ring_attention(*xr, ring, causal=True), do), iters=5)
        row["fwd_bwd_device_ms"] = sum(dev.values()) or None
        row["fwd_bwd_partial_kernels_device_ms"] = sum(
            ms for name, ms in dev.items() if "flash_" in name) or None
        row["fwd_bwd_device_top"] = [
            [name[:80], ms] for name, ms in sorted(
                dev.items(), key=lambda kv: -kv[1])[:6]]
        emit(row)
        del q, k, v, do, xr, yr, got
        torch.cuda.empty_cache()
        want = 2 * S + 1
        check(all(counts[kern.name] == want for kern in fa.PARTIAL_KERNELS)
              and all(counts[kern.name] == 0 for kern in fa.KERNELS),
              f"ring S={S}: expected {want} launches of each partial "
              f"kernel and none of B1-B3: {counts}")
        for key in ("vs_flash_rel_err", "vs_plain_rel_err"):
            check(all(e <= TOL_RING for e in row[key].values()),
                  f"ring S={S} {key}: {row[key]}")
    return launches


def rank_entry(outdir: str, argv) -> int:
    """One torchrun rank of train_ring or train_data: trains ``argv``
    through the CLI's path (the chief prints the performance table) with
    its standard output in ``rank{r}.out``, and writes its losses and
    launch counts (all nine kernels, set to 0 just before the run) to
    ``rank{r}.json`` in ``outdir``."""
    import contextlib

    from tensorflow_distributed_tpu_torch import cli
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce
    from tensorflow_distributed_tpu_torch.parallel import mesh
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
    import torch

    rank = int(os.environ["RANK"])
    cfg = parse_args(argv)
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS
    for kern in kernels:
        kern.launches = 0
    out = os.path.join(outdir, f"rank{rank}.out")
    if cfg.mode in ("eval", "generate"):
        from tensorflow_distributed_tpu_torch.train.loop import (
            evaluate_only, generate_only)
        run = evaluate_only if cfg.mode == "eval" else generate_only
        try:
            with open(out, "w") as f, contextlib.redirect_stdout(f):
                record = run(cfg, logger=MetricLogger(stream=sys.stderr))
        finally:
            mesh.shutdown()
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump({cfg.mode: record,
                       "launches": {kern.name: kern.launches
                                    for kern in kernels}}, f)
        return 0
    try:
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            result = cli.train_and_report(
                cfg, logger=MetricLogger(stream=sys.stderr))
    finally:
        mesh.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        steps = [r.metrics for r in result.logger.records
                 if "loss" in r.metrics]
        walls = [r.wall_time for r in result.logger.records
                 if "loss" in r.metrics]
        gaps = [b - a for a, b in zip(walls[1:], walls[2:])]
        json.dump({"losses": [m["loss"] for m in steps],
                   # Between the step records after the second: no
                   # first-step set-up, no final save.
                   "step_ms_median": (1e3 * statistics.median(gaps)
                                      if gaps else None),
                   "grad_norms": [m.get("grad_norm") for m in steps],
                   "steps_per_sec": result.steps_per_sec,
                   "images_per_sec": result.images_per_sec,
                   "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                            if torch.cuda.is_available()
                                            else None),
                   "final": result.final_metrics,
                   "launches": {kern.name: kern.launches
                                for kern in kernels}}, f)
    return 0


def torchrun_command(nproc: int, outdir: str, argv):
    """The torchrun line that starts ``nproc`` ranks of ``rank_entry``
    (one card each, NCCL) on ``argv``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", os.path.abspath(__file__),
            "--rank", outdir, *argv]


def run_torchrun(phase: str, nproc: int, argv, timeout: float):
    """Run ``torchrun_command``; kill it and every rank left over when it
    outlives ``timeout``. Returns (wall seconds, each rank's json record,
    each rank's standard output)."""
    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.time()
        proc = subprocess.Popen(
            torchrun_command(nproc, outdir, argv),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            # torchrun ends its ranks (each in a session of its own) on
            # SIGTERM; a rank that outlives that is killed by its pid.
            proc.terminate()
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            for line in subprocess.run(
                    ["pgrep", "-f", f"--rank {outdir}"],
                    capture_output=True, text=True).stdout.split():
                os.kill(int(line), signal.SIGKILL)
            fail(f"{phase}: torchrun still running after {timeout} s")
        wall = time.time() - t0
        sys.stderr.write(err[-4000:])
        check(proc.returncode == 0,
              f"{phase}: torchrun exited {proc.returncode}")
        ranks, outs = [], []
        for r in range(nproc):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            with open(os.path.join(outdir, f"rank{r}.out")) as f:
                outs.append(f.read())
    return wall, ranks, outs


def one_card_metrics(argv):
    """The step records' metrics and steps/s of ``argv`` trained in this
    process on one card (no process group)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    result = train(parse_args(argv), logger=MetricLogger(stream=sys.stderr))
    return ([r.metrics for r in result.logger.records if "loss" in r.metrics],
            result.steps_per_sec)


def one_card_losses(argv):
    """The first losses and steps/s of ``argv`` trained in this process
    on one card (no process group)."""
    metrics, sps = one_card_metrics(argv)
    return [m["loss"] for m in metrics], sps


def phase_train_ring(torch) -> None:
    """--mesh.seq S over torchrun's S processes (NCCL), S = 4 with four
    cards or more, else 2; skipped, by the device count alone, on one
    card."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "train_ring",
              "skipped": f"needs >= 2 CUDA devices, have {count}"})
        return
    S = 4 if count >= 4 else 2
    wall, ranks, _ = run_torchrun("train_ring", S,
                                  TRAIN_RING_ARGV + ["--mesh.seq", str(S)],
                                  TRAIN_RING_TIMEOUT_S)
    one, one_sps = one_card_losses(TRAIN_RING_ARGV)
    partial = ("flash_fwd_partial", "flash_dq_partial", "flash_dkv_partial")
    launches = [{k: r["launches"][k] for k in partial} for r in ranks]
    emit({"phase": "train_ring", "S": S, "wall_s": round(wall, 3),
          "losses": ranks[0]["losses"], "one_card_losses": one,
          "steps_per_sec": ranks[0]["steps_per_sec"],
          "one_card_steps_per_sec": one_sps, "launches": launches})
    for r, n in zip(ranks, launches):
        check(len(r["losses"]) == 5 and all(
            abs(a - b) <= TOL_RING_LOSS for a, b in zip(r["losses"], one)),
            f"train_ring losses {r['losses']} vs one card {one}")
        check(all(v > 0 for v in n.values()),
              f"train_ring: a rank did not launch every partial kernel: {n}")


def phase_model_cnn(torch, np) -> None:
    """The reference's CNN on the card in bf16 against the same weights
    on the CPU in f32, at batch 256: the logits and every grad (cuDNN
    convs and cuBLAS products: no kernel of this repository)."""
    from tensorflow_distributed_tpu_torch.models.cnn import MnistCNN
    from tensorflow_distributed_tpu_torch.ops.losses import (
        softmax_cross_entropy)

    ref_model = MnistCNN(compute_dtype=torch.float32, dropout_rate=0.0)
    ref_model.init_weights(torch.Generator().manual_seed(0))
    model = MnistCNN(compute_dtype=torch.bfloat16, dropout_rate=0.0).cuda()
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((256, 28, 28, 1), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, size=256))

    def run(m, dev):
        logits = m(images.to(dev))
        softmax_cross_entropy(logits, labels.to(dev)).backward()
        return logits.detach().cpu(), {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}

    ref_logits, ref_grads = run(ref_model, "cpu")
    logits, grads = run(model, "cuda")
    torch.cuda.synchronize()
    logit_err = float((logits - ref_logits).abs().max()
                      / ref_logits.abs().max())
    grad_err = {n: float((grads[n] - g).abs().max() / g.abs().max())
                for n, g in ref_grads.items()}
    emit({"phase": "model_cnn", "batch": 256, "logits_rel_err": logit_err,
          "grads_rel_err": grad_err, "tolerance": TOL_MODEL})
    check(logits.dtype == torch.float32 and logits.shape == (256, 10),
          f"model_cnn: logits {logits.dtype} {tuple(logits.shape)}")
    check(logit_err <= TOL_MODEL and max(grad_err.values()) <= TOL_MODEL,
          f"the CNN on the card disagrees with the plain path: logits "
          f"{logit_err}, grads {grad_err}")


def check_fixture(data_dir: str) -> None:
    """The accuracy bar must train on the committed idx files, not on
    the synthetic digits the loader falls back to when they are
    missing."""
    from tensorflow_distributed_tpu_torch.data.mnist import load_dataset

    train_ds, _, _ = load_dataset("mnist", data_dir, validation_size=64)
    check(train_ds.name == "mnist",
          f"the MNIST fixture did not load from {data_dir}: "
          f"{train_ds.name}")


def phase_train_cnn(kernels, torch) -> None:
    """The reference's job through the port's CLI path on one card: (a)
    the JAX package's default-tier accuracy bar on the committed MNIST
    fixture, (b) a timing run at the JAX defaults (synthetic digits,
    batch 256, dropout 0.25) with its step profile."""
    check_fixture(FIXTURE_DIR)
    bar = run_train(kernels, torch, "train_cnn", TRAIN_CNN_ARGV)
    accuracy = bar["eval"]["accuracy"]
    emit({"phase": "train_cnn", "run": "accuracy_bar",
          "val_accuracy": accuracy, "bar": CNN_ACCURACY_BAR})
    check(accuracy >= CNN_ACCURACY_BAR,
          f"train_cnn: val accuracy {accuracy} < {CNN_ACCURACY_BAR}")
    timing = run_train(kernels, torch, "train_cnn", TRAIN_CNN_TIMING_ARGV)
    check(all(n == 0 for n in timing["launches"].values()),
          f"the CNN launched a kernel of the GPT: {timing['launches']}")
    emit({"phase": "train_cnn", "run": "profile", "steps": PROFILE_STEPS,
          **profiled(torch, TRAIN_CNN_TIMING_ARGV)})


def gpt_data_argv(rows: int):
    """GPT-2-small at seq 1024 with the fused CE, ``rows`` global rows."""
    return ["--mode", "train", "--model", "gpt_lm", "--model-size", "small",
            "--seq-len", "1024", "--batch-size", str(rows), "--train-steps",
            "5", "--eval-every", "5", "--eval-batch-size", str(rows),
            "--dropout-rate", "0", "--compute-dtype", "bfloat16",
            "--ce-chunk", "8192", "--ce-impl", "kernel", "--log-every", "1"]


def data_runs(count: int):
    """train_data's runs for ``count`` cards: (name, processes, argv,
    the one-card argv on the same global batch, the kernels each rank
    must launch). N = min(count, 4) processes, 8 GPT rows a data rank;
    the CNN on two or more cards (on one, a torchrun of one process is
    the GPT run's, and the checkpoint phase's resumed leg's); a (data 2,
    seq 2) GPT run on four cards."""
    n = min(count, 4)
    flash = ["flash_fwd", "flash_dq", "flash_dkv"]
    ce = ["fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"]
    partial = ["flash_fwd_partial", "flash_dq_partial", "flash_dkv_partial"]
    runs = [("mnist_cnn", n, TRAIN_DATA_CNN_ARGV + ["--mesh.data", str(n)],
             TRAIN_DATA_CNN_ARGV, [])] if n > 1 else []
    runs.append(("gpt_lm", n, gpt_data_argv(8 * n) + ["--mesh.data", str(n)],
                 gpt_data_argv(8 * n), flash + ce))
    if n == 4:
        runs.append(("gpt_lm_seq", 4, gpt_data_argv(16)
                     + ["--mesh.data", "2", "--mesh.seq", "2"],
                     gpt_data_argv(16), ce + partial))
    return runs


def phase_train_data(torch) -> None:
    """Sync data parallelism: each run of ``data_runs`` under torchrun
    (N processes, one card each, NCCL; on one card a real torchrun of
    one process with an NCCL group of one), its first five losses held
    to one card's on the same global batch, every rank's kernel
    launches read, and the performance table printed by rank 0 only."""
    for name, nproc, argv, one_argv, must_launch in data_runs(
            torch.cuda.device_count()):
        wall, ranks, outs = run_torchrun(f"train_data {name}", nproc, argv,
                                         TRAIN_DATA_TIMEOUT_S)
        one, one_sps = one_card_losses(one_argv)
        diff = max(abs(a - b) for r in ranks
                   for a, b in zip(r["losses"], one))
        tables = [TABLE_HEADER in out for out in outs]
        emit({"phase": "train_data", "run": name, "processes": nproc,
              "argv": argv, "wall_s": round(wall, 3),
              "losses": ranks[0]["losses"], "one_card_losses": one,
              "max_loss_diff": diff, "tolerance": TOL_RING_LOSS,
              "steps_per_sec": ranks[0]["steps_per_sec"],
              "images_per_sec": ranks[0]["images_per_sec"],
              "one_card_steps_per_sec": one_sps,
              "launches_per_rank": [r["launches"] for r in ranks],
              "table_from_ranks": [r for r, t in enumerate(tables) if t]})
        for r in ranks:
            check(len(r["losses"]) == 5,
                  f"train_data {name}: {len(r['losses'])} loss records")
        check(diff <= TOL_RING_LOSS,
              f"train_data {name}: losses {[r['losses'] for r in ranks]} "
              f"vs one card {one}")
        check(all(r["launches"][k] > 0 for r in ranks for k in must_launch),
              f"train_data {name}: a rank did not launch {must_launch}: "
              f"{[r['launches'] for r in ranks]}")
        check(tables == [True] + [False] * (nproc - 1),
              f"train_data {name}: the table printed from ranks {tables}")


def gpt2_small(torch, dtype, **overrides):
    """GPT-2-small at its published widths on the card, fresh-init from
    seed 0, without dropout; ``overrides`` are TransformerConfig fields
    (the Llama-style options)."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    with torch.device(DEVICE):
        model = gpt_lm("small", compute_dtype=dtype, dropout_rate=0.0,
                       **overrides)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    return model


def decode_phase(fa, torch, np, phase, overrides, tol=TOL_DECODE,
                 extra=None) -> None:
    """Prefill four prompts at their own depths in one batch, then decode
    DECODE_STEPS greedy tokens; at every step hold the last-position
    logits to the training forward (B1) over the same tokens, within
    ``tol`` of max |ref|. With ``n_kv_heads`` in ``overrides`` the cache
    must hold exactly n_kv_heads / n_heads of an MHA cache's bytes; with
    ``kv_cache_quant="int8"`` exactly n_layers * max_len * nk * (2 * Dh
    + 8) bytes a row (int8 K and V, f32 scales). ``extra``: more fields
    for the phase's line."""
    import dataclasses

    from tensorflow_distributed_tpu_torch.models.generate import (
        decode_token, prefill_cache)
    from tensorflow_distributed_tpu_torch.models.transformer import KVCache

    model = gpt2_small(torch, torch.bfloat16, **overrides)
    rng = np.random.default_rng(0)
    B, P = len(DECODE_PROMPTS), max(DECODE_PROMPTS)
    width = -(-(P + DECODE_STEPS) // fa.BLOCK) * fa.BLOCK  # B1's tile
    seq = torch.zeros((B, width), dtype=torch.long, device=DEVICE)
    for b, n in enumerate(DECODE_PROMPTS):
        seq[b, :n] = torch.from_numpy(
            rng.integers(0, model.cfg.vocab_size, n))
    rows = torch.arange(B, device=DEVICE)
    pos = torch.tensor(DECODE_PROMPTS, device=DEVICE)
    b1 = fa.KERNELS[0]
    before = b1.launches
    with torch.no_grad():
        logits, cache = prefill_cache(model, seq[:, :P])
        last = logits[rows, pos - 1]
        errs = []
        for step in range(DECODE_STEPS + 1):
            ref = model(seq)[rows, pos - 1]
            check(bool(torch.isfinite(last).all()),
                  f"{phase}: non-finite logits at step {step}")
            errs.append(float((last - ref).abs().max() / ref.abs().max()))
            if step == DECODE_STEPS:
                break
            tok = last.argmax(dim=-1)
            seq[rows, pos] = tok
            last, cache = decode_token(model, cache, tok, pos)
            pos = pos + 1
    launched = b1.launches - before
    cfg = model.cfg
    mha_bytes = KVCache.zeros(dataclasses.replace(
        cfg, n_kv_heads=None, kv_cache_quant="none"), B,
        device="meta").nbytes()
    nk, dh = cfg.n_kv_heads or cfg.n_heads, cfg.d_model // cfg.n_heads
    want_bytes = (mha_bytes * overrides["n_kv_heads"] // cfg.n_heads
                  if "n_kv_heads" in overrides else mha_bytes)
    bf16_bytes = want_bytes
    if overrides.get("kv_cache_quant") == "int8":
        want_bytes = B * cfg.n_layers * cfg.max_len * nk * (2 * dh + 8)
    emit({"phase": phase, **(extra or {}), "prompts": list(DECODE_PROMPTS),
          "steps": DECODE_STEPS, "oracle_width": width,
          "rel_err_by_step": errs, "max_rel_err": max(errs),
          "tolerance": tol, "oracle_flash_fwd_launches": launched,
          "cache_shape": list(cache.k[0].shape),
          "cache_dtype": str(cache.k[0].dtype).replace("torch.", ""),
          "cache_bytes": cache.nbytes(), "cache_bytes_per_slot":
          cache.nbytes() // B, "same_heads_compute_dtype_bytes_per_slot":
          bf16_bytes // B, "mha_cache_bytes": mha_bytes})
    check(cache.nbytes() == want_bytes,
          f"{phase}: the cache holds {cache.nbytes()} bytes, not "
          f"{want_bytes} (n_kv_heads / n_heads of the MHA cache's "
          f"{mha_bytes}, or int8 rows and f32 scales): a GQA cache of full "
          f"width or a cache of the wrong type")
    check(max(errs) <= tol,
          f"{phase}: logits disagree with the training forward: {errs}")
    check(launched == model.cfg.n_layers * (DECODE_STEPS + 1),
          f"{phase}: the oracle forward did not run B1: {launched} launches")


def phase_decode(fa, torch, np) -> None:
    decode_phase(fa, torch, np, "decode", {})


def first_mismatch(got, ref):
    """The first step at which two token streams differ, or None."""
    for j, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return j
    return None if len(got) == len(ref) else min(len(got), len(ref))


def top2_gap(torch, model, prompt, ref, j: int) -> float:
    """The gap between the two largest logits where ``ref`` (a greedy
    stream after ``prompt``) takes its ``j``-th token."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        prefill_cache)

    seq = torch.tensor(list(prompt) + list(ref[:j]), device=DEVICE)[None]
    top2 = torch.topk(prefill_cache(model, seq)[0][0, -1], 2).values
    return float(top2[0] - top2[1])


def serve_identity(torch, np, phase, overrides) -> None:
    """The engine under the FIFO scheduler in f32, request by request
    against one-shot greedy ``generate()``: identical streams, except
    where the reference's top-2 logit gap is under IDENTITY_GAP."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets)
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)

    model = gpt2_small(torch, torch.float32, **overrides)
    rng = np.random.default_rng(1)
    lens = np.linspace(*IDENTITY_PROMPTS, IDENTITY_REQUESTS).astype(int)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]
    engine = SlotDecodeEngine(model, IDENTITY_SLOTS, buckets=default_buckets(
        max(lens), cap=model.cfg.max_len))
    engine.warmup()
    t0 = time.time()
    done = {c.rid: c for c in Scheduler(engine, decode_priority=4).run(
        [Request(rid=i, prompt=p, max_new_tokens=IDENTITY_NEW)
         for i, p in enumerate(prompts)])}
    wall = time.time() - t0

    excused = []
    for i, p in enumerate(prompts):
        ref = generate(model, torch.from_numpy(p).to(DEVICE)[None],
                       IDENTITY_NEW)[0].tolist()
        j = first_mismatch(done[i].tokens, ref)
        if j is None:
            continue
        gap = top2_gap(torch, model, p, ref, j)
        excused.append({"rid": i, "prompt_len": len(p), "step": j,
                        "top2_gap": gap})
        check(gap < IDENTITY_GAP,
              f"{phase}: request {i} (prompt {len(p)}) differs from "
              f"generate() at step {j}, where the top-2 logit gap is {gap}")
    emit({"phase": phase, "requests": IDENTITY_REQUESTS,
          "slots": IDENTITY_SLOTS, "new_tokens": IDENTITY_NEW,
          "prompt_lens": lens.tolist(), "identical": IDENTITY_REQUESTS
          - len(excused), "excused": excused,
          "buckets_used": engine.prefill_compiles,
          "ladder": list(engine.buckets), "prefills": engine.prefills,
          "decode_steps": engine.decode_steps,
          "cache_bytes_per_slot": engine.cache_bytes_per_slot(),
          "wall_s": round(wall, 3)})
    check(engine.prefills == IDENTITY_REQUESTS,
          f"{phase}: {engine.prefills} prefills")
    check(engine.prefill_compiles <= len(engine.buckets),
          f"{phase}: {engine.prefill_compiles} prefill shapes for a "
          f"ladder of {len(engine.buckets)}")


def phase_serve_identity(torch, np) -> None:
    serve_identity(torch, np, "serve_identity", {})


def run_cli(argv):
    """``cli.main(argv)`` in this process, its standard output captured
    (and echoed to standard error). Returns (exit code, the output)."""
    import contextlib
    import io

    from tensorflow_distributed_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    return rc, out


def event_record(out: str, event: str):
    """The first JSON record of ``event`` in a CLI's output, or None."""
    return next((json.loads(l) for l in out.splitlines()
                 if l.startswith(f'{{"event": "{event}"')), None)


def serve_cli(argv):
    """``cli.main(argv)`` in this process. Returns (exit code, the
    ``[serve]`` summary line, the ``serve_summary`` record, the
    output)."""
    rc, out = run_cli(argv)
    lines = out.splitlines()
    # "[serve] 32 requests, ..." (not a streamed token or a paged line).
    line = next((l for l in lines if l.startswith("[serve] ")
                 and l[len("[serve] "):][:1].isdigit()), None)
    record = event_record(out, "serve_summary")
    check(rc == 0 and line is not None and record is not None,
          f"serve: the CLI exited {rc} without its summary")
    return rc, line, record, out


def serve_profile(torch, argv) -> dict:
    """Where a decode step of ``argv``'s engine goes, every slot live:
    PROFILE_STEPS steps after 3 warm-up steps, each ending in the
    engine's token fetch; the host's time to enqueue a step onto an idle
    device; and from torch.profiler the kernels launched and the device
    busy time a step. With ``--serve.spec-tokens`` k a step is a verify
    of the k-gram self-draft's proposals (and the tokens it retired a
    step are counted). Also the cache's bytes on the card (a paged
    engine's whole pool) and the peak memory from the warm-up on."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.serve.run import serve_setup
    from tensorflow_distributed_tpu_torch.serve.speculate import SelfDraft

    _, engine, requests = serve_setup(parse_args(argv))
    k = engine.spec_tokens
    # Serving's own peak: from here the train state serve_setup built
    # (params and optimizer moments) is gone; the warm-up's prefills of
    # every bucket count.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.warmup()
    hist = {}
    for slot, r in enumerate(requests[:engine.num_slots]):
        if getattr(engine, "paged", False):
            # The paged engine reserves the request's whole trajectory.
            first = engine.prefill(r.prompt, slot,
                                   max_new_tokens=r.max_new_tokens)
        else:
            first = engine.prefill(r.prompt, slot)
        hist[slot] = [int(t) for t in r.prompt] + [first]
    drafter = SelfDraft(engine.num_slots, k) if k else None
    retired = [0]

    def step():
        """One decode step, or a verify of the self-draft's proposals;
        returns the tokens of every slot."""
        if not k:
            retired[0] += len(hist)
            return engine.step()
        toks, acc = engine.verify_step(drafter.propose(hist))
        for slot in hist:
            hist[slot] += toks[slot, :acc[slot]].tolist()
            retired[0] += int(acc[slot])
        return toks

    vocab = engine.model.cfg.vocab_size
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    retired[0] = 0
    t0 = time.time()
    for _ in range(PROFILE_STEPS):
        nxt = step()
    step_ms = (time.time() - t0) / PROFILE_STEPS * 1e3
    tokens_per_step = retired[0] / PROFILE_STEPS
    check(bool(((nxt >= 0) & (nxt < vocab)).all()),
          f"serve: tokens outside the vocabulary: {nxt}")
    torch.cuda.synchronize()
    t0 = time.time()
    # One step's work, enqueued without its fetch (it rewrites the
    # columns the next step writes again).
    if k:
        fed = np.concatenate([engine.tok[:, None], drafter.propose(hist)], 1)
        last = engine._dispatch_verify(engine._h2d(fed),
                                       engine._h2d(engine.pos))
    else:
        last = engine._dispatch_step(engine._h2d(engine.tok),
                                     engine._h2d(engine.pos))
    enqueue_ms = (time.time() - t0) * 1e3
    check(bool(torch.isfinite(last).all()), "serve: non-finite logits")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    busy, launches, top, d2h = 0.0, 0, [], 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if "DtoH" in e.key:
            d2h += e.count
        if us > 0:
            busy += us / PROFILE_STEPS / 1e3
            launches += e.count
            top.append([e.key[:80], us / PROFILE_STEPS / 1e3,
                        e.count / PROFILE_STEPS])
    top.sort(key=lambda row: -row[1])
    return {"step_ms": step_ms, "host_enqueue_ms": enqueue_ms,
            "launches_per_step": launches / PROFILE_STEPS,
            "device_busy_ms": busy or None,
            "device_idle_share": (1 - busy / step_ms) if busy else None,
            "device_top": top[:8], "spec_tokens": k,
            # The tokens and the finiteness flags: one copy a step.
            "d2h_copies_per_step": d2h / PROFILE_STEPS,
            "tokens_per_step": tokens_per_step,
            "cache_bytes": engine.cache.nbytes(),
            "serving_peak_mem_bytes": torch.cuda.max_memory_allocated()}


SERVE_KEYS = ("tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95", "tok_ms_mean",
              "mean_slot_occupancy", "buckets", "prefill_compiles",
              "decode_steps", "total_new_tokens", "wall_s")


def phase_serve(torch) -> dict:
    """``--mode serve`` through the CLI at full width in bf16, then a
    traced decode step of the same engine. Returns the phase's line."""
    torch.cuda.reset_peak_memory_stats()
    rc, line, summary, _ = serve_cli(SERVE_ARGV)
    peak = torch.cuda.max_memory_allocated()
    record = {"phase": "serve", "argv": SERVE_ARGV, "exit": rc,
              "summary_line": line, **{k: summary[k] for k in SERVE_KEYS},
              "peak_mem_bytes": peak,
              "profile": serve_profile(torch, SERVE_ARGV)}
    emit(record)
    check(summary["total_new_tokens"] == SERVE_REQUESTS * SERVE_NEW,
          f"serve: {summary['total_new_tokens']} tokens delivered, not "
          f"{SERVE_REQUESTS} x {SERVE_NEW}")
    return record


def sync(torch) -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def train_losses(result):
    return [r.metrics["loss"] for r in result.logger.records
            if "loss" in r.metrics]


def restored(torch, argv):
    """The model and train state that ``argv`` (with a
    ``--checkpoint-dir``) builds, restored from the latest checkpoint."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)

    cfg = parse_args(argv)
    model, state = _build_model_and_state(cfg, torch.device(cfg.device))
    return cfg, model, ckpt.restore(cfg.checkpoint_dir, state)


def states_equal(torch, a, b) -> bool:
    """Every tensor of two train states equal, and their step and count."""
    groups = [(a.params, b.params)] + [
        (a.opt_state[k], b.opt_state[k]) for k in a.opt_state if k != "count"]
    if a.ema is not None or b.ema is not None:
        groups.append((a.ema or {}, b.ema or {}))
    return (a.step == b.step
            and a.opt_state["count"] == b.opt_state["count"]
            and all(x.keys() == y.keys()
                    and all(torch.equal(x[n], y[n]) for n in x)
                    for x, y in groups))


def phase_checkpoint(kernels, torch, ckpt_dir: str) -> None:
    """6 straight steps of the fused run against 3 steps with a save at
    step 3 and ``--resume`` to 6 in a new process; then a save and a
    restore in this process of the straight run's state."""
    import hashlib

    from tensorflow_distributed_tpu_torch import interop
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state, train)
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    def run(argv):
        return train(parse_args(argv), logger=MetricLogger(stream=sys.stderr))

    steps = ["--train-steps", str(CHECKPOINT_STEPS)]
    save = ["--checkpoint-dir", ckpt_dir, "--checkpoint-every",
            str(CHECKPOINT_EVERY)]
    straight = run(CHECKPOINT_ARGV + steps)
    first = run(CHECKPOINT_ARGV + ["--train-steps", str(CHECKPOINT_EVERY)]
                + save)
    resume_argv = CHECKPOINT_ARGV + steps + save + ["--resume", "true"]
    wall, ranks, _ = run_torchrun("checkpoint", 1, resume_argv,
                                     CHECKPOINT_TIMEOUT_S)
    want = train_losses(straight)
    got = train_losses(first) + ranks[0]["losses"]
    diffs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    resumed = ranks[0]["launches"]
    legs = CHECKPOINT_STEPS - CHECKPOINT_EVERY
    with tempfile.TemporaryDirectory(prefix="tfd_roundtrip_") as rt:
        sync(torch)
        t0 = time.time()
        path = ckpt.save(rt, straight.state)
        save_s = time.time() - t0
        # Where a save goes: the device-to-host state dict, and the
        # sha256 rate on this host (the file is hashed once a save, and
        # once a restore).
        t0 = time.time()
        interop.state_to_flax(straight.state)
        to_host_s = time.time() - t0
        buf = bytes(2 ** 28)
        t0 = time.time()
        hashlib.sha256(buf).digest()
        sha256_gb_s = len(buf) / (time.time() - t0) / 1e9
        del buf
        files = {n: os.path.getsize(os.path.join(path, n))
                 for n in sorted(os.listdir(path))}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        cfg = parse_args(CHECKPOINT_ARGV + steps)
        device = next(straight.state.model.parameters()).device
        fresh = _build_model_and_state(cfg, device)[1]
        sync(torch)
        t0 = time.time()
        ckpt.restore(rt, fresh)
        sync(torch)
        restore_s = time.time() - t0
        equal = states_equal(torch, straight.state, fresh)
    emit({"phase": "checkpoint", "argv": resume_argv,
          "straight_losses": want, "split_losses": got,
          "max_rel_diff": max(diffs), "bit_identical": got == want,
          "tolerance": TOL_RESUME, "resumed_launches": resumed,
          "resume_wall_s": round(wall, 3),
          "steps_saved": ckpt.available_steps(ckpt_dir),
          "step_dir_bytes": sum(files.values()), "files": files,
          "param_bytes": manifest["param_bytes"], "save_s": save_s,
          "to_host_s": to_host_s, "sha256_gb_s": sha256_gb_s,
          "restore_s": restore_s, "roundtrip_equal": equal})
    check(len(got) == len(want) == CHECKPOINT_STEPS,
          f"checkpoint: {len(got)} split losses, {len(want)} straight")
    check(max(diffs) <= TOL_RESUME,
          f"checkpoint: the resumed run left the straight one: {diffs}")
    check(len(ranks[0]["losses"]) == legs,
          f"checkpoint: the second leg did not resume at step "
          f"{CHECKPOINT_EVERY}: {ranks[0]['losses']}")
    check(all(resumed[k] == legs for k in ("fused_ce_fwd", "fused_ce_dx",
                                           "fused_ce_dw"))
          and resumed["flash_dq"] == resumed["flash_dkv"] == 12 * legs
          and resumed["flash_fwd"] >= 12 * legs,
          f"checkpoint: the resumed leg did not run B1-B6: {resumed}")
    check(equal, "checkpoint: a tensor, the step or the count changed in a "
                 "save and restore")


def phase_eval(kernels, torch, ckpt_dir: str) -> None:
    """``--mode eval`` through the CLI against an in-process evaluate()
    of the restored state; B1 launched 12 times an eval batch."""
    from tensorflow_distributed_tpu_torch.train.loop import evaluate
    from tensorflow_distributed_tpu_torch.train.step import make_eval_step
    from tensorflow_distributed_tpu_torch.train.tasks import make_task

    argv = EVAL_ARGV + ["--checkpoint-dir", ckpt_dir]
    for kern in kernels:
        kern.launches = 0
    rc, out = run_cli(argv)
    launches = {kern.name: kern.launches for kern in kernels}
    rec = event_record(out, "eval")
    check(rc == 0 and rec is not None,
          f"eval: the CLI exited {rc} without its eval record")
    cfg, _, state = restored(torch, argv)
    task = make_task(cfg)
    batches = task.eval_size // cfg.eval_batch_size
    ref = evaluate(state, make_eval_step(task.eval_loss or task.loss), task,
                   cfg.eval_batch_size, torch.device(cfg.device))
    rel = abs(rec["val_loss"] - ref["loss"]) / abs(ref["loss"])
    tokens = batches * cfg.eval_batch_size * cfg.seq_len
    emit({"phase": "eval", "argv": argv, "record": rec,
          "in_process_loss": ref["loss"], "rel_diff": rel,
          "tolerance": TOL_EVAL, "eval_batches": batches,
          "launches": launches,
          "tokens_per_s": (tokens / rec["eval_seconds"]
                           if rec["eval_seconds"] else None)})
    check(rel <= TOL_EVAL,
          f"eval: the CLI's val_loss {rec['val_loss']} vs {ref['loss']}")
    check(launches["flash_fwd"] == 12 * batches,
          f"eval: the eval did not run B1 12 times a batch: {launches}")


def stream_check(torch, model, prompt, got, ref, what: str,
                 against: str = "generate()"):
    """A token stream against ``ref``, the greedy reference (``against``
    names it): equal, or differing first where ``model``'s top-2 logit
    gap is under IDENTITY_GAP. Returns the excuse (or None)."""
    j = first_mismatch(got, ref)
    if j is None:
        return None
    gap = top2_gap(torch, model, prompt, ref, j)
    check(gap < IDENTITY_GAP, f"{what} differs from {against} at step {j}, "
                              f"where the top-2 logit gap is {gap}")
    return {"step": j, "top2_gap": gap}


def phase_generate(torch, np, ckpt_dir: str) -> None:
    """``--mode generate`` through the CLI in f32: greedy against
    generate() on the restored model, 4 beams, and one beam against
    greedy."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        beam_search, generate)

    rng = np.random.default_rng(2)
    vocab_argv = GENERATE_ARGV + ["--checkpoint-dir", ckpt_dir]
    _, model, state = restored(torch, vocab_argv + ["--prompt", "0"])
    if state.ema is not None:
        model.load_state_dict(state.ema)
    vocab, n = model.cfg.vocab_size, GENERATE_NEW
    prompt = rng.integers(0, vocab, GENERATE_PROMPT_LEN).tolist()
    argv = vocab_argv + ["--prompt", ",".join(map(str, prompt))]
    t0 = time.time()
    rc, out = run_cli(argv)
    greedy_s = time.time() - t0
    greedy = event_record(out, "generate")
    check(rc == 0 and greedy is not None,
          f"generate: the CLI exited {rc} without its record")
    t0 = time.time()
    rc, out = run_cli(argv + ["--num-beams", str(GENERATE_BEAMS)])
    beams_s = time.time() - t0
    beams = event_record(out, "generate")
    check(rc == 0 and beams is not None,
          f"generate: the CLI with {GENERATE_BEAMS} beams exited {rc}")
    x = torch.tensor([prompt], device=DEVICE)
    ref = generate(model, x, n)[0].tolist()
    one = beam_search(model, x, n, num_beams=1)[0][0, 0].tolist()
    excused = {"greedy": stream_check(torch, model, prompt,
                                      greedy["new_tokens"], ref, "generate"),
               "one_beam": stream_check(torch, model, prompt, one, ref,
                                        "beam_search(num_beams=1)")}
    toks = beams["new_tokens"]
    emit({"phase": "generate", "argv": argv[:-2] + ["--prompt", "..."],
          "prompt_len": len(prompt), "new_tokens": n,
          "greedy_identical": greedy["new_tokens"] == ref,
          "one_beam_identical": one == ref, "excused": excused,
          "beams": GENERATE_BEAMS, "beam_score": beams.get("beam_score"),
          "greedy_s": greedy_s, "beams_s": beams_s, "step": greedy["step"]})
    check(len(toks) == n and all(0 <= t < vocab for t in toks),
          f"generate: beam tokens outside the vocabulary or short: {toks}")
    check(math.isfinite(beams.get("beam_score", math.nan)),
          f"generate: beam score {beams.get('beam_score')}")


def phase_serve_checkpoint(torch, ckpt_dir: str) -> None:
    """``--mode serve --checkpoint-dir`` in f32: every stream against
    generate() on the restored weights."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.serve.run import _workload

    argv = SERVE_CKPT_ARGV + ["--checkpoint-dir", ckpt_dir]
    rc, line, summary, out = serve_cli(argv)
    streams = {}
    for l in out.splitlines():
        if l.startswith("[serve] rid="):
            rid, tok = l.split()[1:3]
            streams.setdefault(int(rid[4:]), []).append(int(tok[4:]))
    cfg, model, state = restored(torch, argv)
    if state.ema is not None:
        model.load_state_dict(state.ema)
    excused = []
    for r in _workload(cfg, cfg.synthetic_vocab or 64):
        x = torch.tensor([r.prompt.tolist()], device=DEVICE)
        ref = generate(model, x, r.max_new_tokens)[0].tolist()
        why = stream_check(torch, model, r.prompt.tolist(),
                           streams.get(r.rid, []), ref,
                           f"serve_checkpoint: request {r.rid}")
        if why:
            excused.append({"rid": r.rid, **why})
    emit({"phase": "serve_checkpoint", "argv": argv, "exit": rc,
          "summary_line": line, "params": summary["params"],
          "requests": summary["requests"],
          "total_new_tokens": summary["total_new_tokens"],
          "identical": summary["requests"] - len(excused),
          "excused": excused})
    check(summary["params"] == "checkpoint",
          f"serve_checkpoint: served {summary['params']} params")


def phase_model_llama(fa, torch, np) -> None:
    """The Llama-style GPT at GPT-2-small's widths (LLAMA_OPTS), batch
    MODEL_LLAMA_B x L MODEL_LLAMA_L, from one seeded param tree: the
    bf16 forward and backward on the card (B1-B3, 12 launches each)
    against the f32 plain path on the CPU, logits and every grad."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
    from tensorflow_distributed_tpu_torch.ops.losses import (
        masked_softmax_cross_entropy)

    ref_model = gpt_lm("small", compute_dtype=torch.float32,
                       dropout_rate=0.0, **LLAMA_OPTS)
    ref_model.init_weights(torch.Generator().manual_seed(0))
    with torch.device(DEVICE):
        model = gpt_lm("small", compute_dtype=torch.bfloat16,
                       dropout_rate=0.0, **LLAMA_OPTS)
    model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(2)
    shape = (MODEL_LLAMA_B, MODEL_LLAMA_L)
    vocab = ref_model.cfg.vocab_size
    tokens = torch.from_numpy(rng.integers(0, vocab, size=shape))
    targets = torch.from_numpy(rng.integers(0, vocab, size=shape))
    mask = torch.ones(shape)

    def run(m, dev):
        logits = m(tokens.to(dev))
        loss = masked_softmax_cross_entropy(logits, targets.to(dev),
                                            mask.to(dev))
        loss.backward()
        return logits.detach().cpu(), {n: p.grad.cpu()
                                       for n, p in m.named_parameters()}

    t0 = time.time()
    ref_logits, ref_grads = run(ref_model, "cpu")
    cpu_s = time.time() - t0
    before = [kern.launches for kern in fa.KERNELS]
    logits, grads = run(model, DEVICE)
    sync(torch)
    launched = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
    logit_err = float((logits.float() - ref_logits).abs().max()
                      / ref_logits.abs().max())
    grad_errs = {n: float((grads[n] - g).abs().max() / g.abs().max())
                 for n, g in ref_grads.items() if float(g.abs().max()) > 0}
    worst = max(grad_errs, key=grad_errs.get)
    emit({"phase": "model_llama", "opts": LLAMA_OPTS, "batch": shape[0],
          "seq_len": shape[1], "params": sum(
              p.numel() for p in model.parameters()),
          "logits_rel_err": logit_err, "grads_rel_err": grad_errs[worst],
          "worst_grad": worst, "kernel_launches": launched,
          "tolerance": TOL_MODEL, "cpu_reference_s": round(cpu_s, 3)})
    n = model.cfg.n_layers
    check(launched == [n, n, n],
          f"model_llama: B1-B3 did not run once a layer: {launched}")
    check(logit_err <= TOL_MODEL and grad_errs[worst] <= TOL_MODEL,
          f"model_llama on the card disagrees with the plain path: logits "
          f"{logit_err}, grads {grad_errs[worst]} ({worst})")


def phase_train_llama(kernels, torch, fused):
    """train_fused's run with the Llama-style options: B2 and B3 12 times
    a step, B1 at least 12, each CE kernel once a step, no ring kernel;
    its tokens/s, step ms and peak memory beside train_fused's."""
    rec = run_train(kernels, torch, "train_llama", TRAIN_LLAMA_ARGV,
                    {"train_fused": fused})
    steps, t = rec["steps"], rec["train_launches"]
    n = 12 * steps
    check(t["flash_dq"] == n and t["flash_dkv"] == n
          and t["flash_fwd"] >= n,
          f"train_llama: the RoPE/GQA steps did not run B1-B3 once a layer "
          f"a step: {t}")
    check(all(t[k] == steps for k in CE_KERNELS),
          f"train_llama: a CE kernel did not launch once a step: {t}")
    check(all(rec["launches"][k] == 0 for k in RING_KERNELS),
          f"train_llama: a ring kernel launched: {rec['launches']}")
    return rec


def with_flags(argv, **flags):
    """``argv`` with each ``--flag value`` of ``flags`` (underscores as
    dashes) replaced."""
    out = list(argv)
    for name, value in flags.items():
        out[out.index("--" + name.replace("_", "-")) + 1] = str(value)
    return out


def phase_train_window(kernels, torch):
    """The windowed long-context run under --remat full with Adafactor:
    B2 and B3 12 times a step, B1 at least 24 (forward and recompute),
    a falling loss; then WINDOW_CONTROL_STEPS steps under --remat dots
    (B1 24 a step, B2 12) and as many without remat, which launch B1 12
    times a step and must peak higher than the remat run."""
    rec = run_train(kernels, torch, "train_window", TRAIN_WINDOW_ARGV)
    steps, t = rec["steps"], rec["train_launches"]
    check(t["flash_dq"] == 12 * steps and t["flash_dkv"] == 12 * steps,
          f"train_window: B2/B3 did not run once a layer a step: {t}")
    check(t["flash_fwd"] >= 24 * steps,
          f"train_window: B1 launched {t['flash_fwd']} times in {steps} "
          f"steps, not twice a layer a step (the forward and the "
          f"recompute): the blocks were not recomputed")
    # --remat dots saves the matmuls and recomputes the rest: B1 is a
    # ctypes launch, which the selective-checkpoint policy never sees,
    # so it runs again in the recompute (JAX recomputes its pallas_call).
    dots = run_train(kernels, torch, "train_window_dots", with_flags(
        TRAIN_WINDOW_ARGV, remat="dots", train_steps=WINDOW_CONTROL_STEPS))
    td = dots["train_launches"]
    check(td["flash_fwd"] == 24 * WINDOW_CONTROL_STEPS
          and td["flash_dq"] == 12 * WINDOW_CONTROL_STEPS,
          f"train_window_dots: B1 {td['flash_fwd']} and B2 {td['flash_dq']} "
          f"launches in {WINDOW_CONTROL_STEPS} steps, not 24 and 12 a step")
    control = run_train(kernels, torch, "train_window_control", with_flags(
        TRAIN_WINDOW_ARGV, remat="none", train_steps=WINDOW_CONTROL_STEPS))
    tc = control["train_launches"]
    check(tc["flash_fwd"] == 12 * WINDOW_CONTROL_STEPS,
          f"train_window_control: B1 launched {tc['flash_fwd']} times in "
          f"{WINDOW_CONTROL_STEPS} steps without remat, not 12 a step")
    saved = control["train_peak_mem_bytes"] - rec["train_peak_mem_bytes"]
    emit({"phase": "train_window_memory",
          "remat_peak_mem_bytes": rec["train_peak_mem_bytes"],
          "dots_peak_mem_bytes": dots["train_peak_mem_bytes"],
          "control_peak_mem_bytes": control["train_peak_mem_bytes"],
          "saved_bytes": saved, "remat_step_ms": rec["step_ms_median"],
          "dots_step_ms": dots["step_ms_median"],
          "control_step_ms": control["step_ms_median"]})
    check(saved > 0,
          f"train_window: remat saved no memory: peak "
          f"{rec['train_peak_mem_bytes']} B against the control's "
          f"{control['train_peak_mem_bytes']} B")
    return rec


def phase_decode_llama(fa, torch, np) -> None:
    decode_phase(fa, torch, np, "decode_llama", LLAMA_OPTS)


def phase_serve_llama(torch, np) -> None:
    serve_identity(torch, np, "serve_llama", LLAMA_OPTS)


def phase_decode_int8(fa, torch, np) -> None:
    """``decode`` over the int8 cache (``kv_cache_quant="int8"``) in bf16:
    an MHA leg and a Llama-style leg (4 K/V heads: the narrow and thin
    cache), the logits within 5e-2 of the training forward (B1)."""
    for leg, opts in (("mha", {}), ("llama", LLAMA_OPTS)):
        decode_phase(fa, torch, np, "decode_int8",
                     dict(opts, kv_cache_quant="int8"), tol=TOL_DECODE_INT8,
                     extra={"leg": leg})


def cached_page_ids(radix) -> set:
    """The pages the radix tree and the session store hold (none without
    a prefix cache)."""
    if radix is None:
        return set()
    pages, stack = set(), list(radix._root.children.values())
    while stack:
        node = stack.pop()
        pages.add(node.page)
        stack.extend(node.children.values())
    for ent in radix._sessions.values():
        pages.update(ent.pages)
    return pages


def phase_serve_paged_identity(torch, np) -> None:
    """serve_paged_identity in two legs: a compute-dtype cache, then the
    int8 pool (int8 K/V and f32 scales through the radix attach, the
    copy-on-write page copy and the session re-attach), each stream held
    against the same model's dense ``generate()``."""
    serve_paged_identity(torch, np, "f32", {})
    serve_paged_identity(torch, np, "int8", {"kv_cache_quant": "int8"})


def serve_paged_identity(torch, np, leg, overrides) -> None:
    """The paged engine (page size 16, the radix prefix cache) under the
    FIFO scheduler in f32, every stream against the request's own
    one-shot ``generate()`` over the dense cache of the same model (the
    top-2 gap excuse of serve_identity): a warm-up request of the shared
    prefix; PAGED_REQUESTS requests sharing it with tails of 8-200
    tokens (prefix hits); a page-aligned prompt served three times
    (copy-on-write of a shared page); a 3-turn session, each turn the
    conversation so far plus new tokens (the session re-attach, partial
    page included). Then every page is free or held by the prefix cache
    or a session. ``overrides``: TransformerConfig fields of the leg."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets)
    from tensorflow_distributed_tpu_torch.serve.paging.engine import (
        PagedSlotEngine)
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)

    phase = f"serve_paged_identity ({leg})"
    model = gpt2_small(torch, torch.float32, **overrides)
    want_dtype = (torch.int8 if overrides.get("kv_cache_quant") == "int8"
                  else torch.float32)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, PAGED_PREFIX)
    tails = np.linspace(*PAGED_TAILS, PAGED_REQUESTS).astype(int)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, n)])
              for n in tails]
    aligned = rng.integers(0, vocab, PAGED_ALIGNED)
    engine = PagedSlotEngine(model, IDENTITY_SLOTS, page_size=PAGE_SIZE,
                             buckets=default_buckets(
                                 model.cfg.max_len, cap=model.cfg.max_len))
    engine.warmup()
    sched = Scheduler(engine, decode_priority=4)
    served, excused = [], []
    t0 = time.time()

    def serve(prompts, session=""):
        base = len(served)
        done = {c.rid: c for c in sched.run(
            [Request(rid=base + i, prompt=p, max_new_tokens=IDENTITY_NEW,
                     session=session) for i, p in enumerate(prompts)])}
        for i, p in enumerate(prompts):
            served.append((p, done[base + i].tokens))
        return [done[base + i].tokens for i in range(len(prompts))]

    serve([np.concatenate([prefix, rng.integers(0, vocab, 8)])])
    serve(shared)
    hits_shared = engine.prefix_hits
    for _ in range(3):
        serve([aligned])
    turn, session_hits = rng.integers(0, vocab, PAGED_TURN0), []
    for j in range(PAGED_TURNS):
        before = engine.prefix_hit_tokens
        out = serve([turn], session="conversation")[0]
        session_hits.append(engine.prefix_hit_tokens - before)
        # The conversation so far, then the user's next message.
        turn = np.concatenate([turn, out, rng.integers(0, vocab,
                                                       PAGED_TURN_NEW)])
    wall = time.time() - t0
    for i, (p, got) in enumerate(served):
        ref = generate(model, torch.from_numpy(p).to(DEVICE)[None],
                       IDENTITY_NEW)[0].tolist()
        bad = stream_check(torch, model, p, got, ref,
                           f"{phase}: request {i} (prompt {len(p)})")
        if bad:
            excused.append({"rid": i, "prompt_len": len(p), **bad})
    stats = engine.paging_stats()
    held = cached_page_ids(engine.radix)
    # A session turn attaches everything its last turn wrote: the turn's
    # prompt and all but the last of its new tokens, the partial page too.
    written = [PAGED_TURN0 + j * (IDENTITY_NEW + PAGED_TURN_NEW)
               + IDENTITY_NEW - 1 for j in range(PAGED_TURNS - 1)]
    pool = engine.cache.k[0]
    emit({"phase": "serve_paged_identity", "leg": leg,
          "requests": len(served), "slots": IDENTITY_SLOTS,
          "page_size": PAGE_SIZE, "new_tokens": IDENTITY_NEW,
          "cache_dtype": str(pool.dtype).replace("torch.", ""),
          "scale_leaves": engine.cache.k_scale is not None,
          "identical": len(served) - len(excused), "excused": excused,
          "prefix_hits_of_shared": hits_shared,
          "session_hit_tokens": session_hits,
          "held_by_cache": len(held), **stats,
          "cache_bytes_per_slot": engine.cache_bytes_per_slot(),
          "wall_s": round(wall, 3)})
    check(pool.dtype == want_dtype and (engine.cache.k_scale is not None)
          == (want_dtype == torch.int8),
          f"{phase}: the pool holds {pool.dtype} pages (scales: "
          f"{engine.cache.k_scale is not None}), not {want_dtype}: a cache "
          f"of the wrong type")
    check(stats["prefix_hits"] >= PAGED_REQUESTS,
          f"{phase}: {stats['prefix_hits']} prefix hits, not >= "
          f"{PAGED_REQUESTS}")
    check(stats["cow_copies"] >= 1, f"{phase}: no copy-on-write")
    check(session_hits[1:] == written,
          f"{phase}: the session turns attached {session_hits[1:]} tokens, "
          f"not the {written} their conversations wrote")
    check(stats["prefill_tokens_computed"] < stats["prefill_tokens_dense"],
          f"{phase}: prefill computed {stats['prefill_tokens_computed']} "
          f"tokens, not fewer than the dense {stats['prefill_tokens_dense']}")
    check(not engine.active.any() and not engine.page_count.any(),
          f"{phase}: a slot still holds pages after the run")
    check(engine.pool.pages_in_use == len(held) <= stats["cached_pages"],
          f"{phase}: {engine.pool.pages_in_use} pages in use, but the prefix "
          f"cache and the sessions hold {len(held)}")


def phase_serve_paged(torch, dense: dict) -> None:
    """``--mode serve --serve.paged --serve.kv-dtype int8
    --serve.session-turns 4`` through the CLI at full width in bf16:
    every token delivered, the engine's page bytes equal to
    ``page_bytes_estimate``; then the paged int8 engine's decode-step
    profile, beside the dense bf16 serve phase's numbers of this run."""
    from tensorflow_distributed_tpu_torch.models.transformer import (
        gpt2_small_config)
    from tensorflow_distributed_tpu_torch.serve.paging.engine import (
        page_bytes_estimate)

    torch.cuda.reset_peak_memory_stats()
    rc, line, summary, out = serve_cli(SERVE_PAGED_ARGV)
    peak = torch.cuda.max_memory_allocated()
    paged_line = next((l for l in out.splitlines()
                       if l.startswith("[serve] paged: ")), None)
    estimate = page_bytes_estimate(
        gpt2_small_config(kv_cache_quant="int8"), PAGE_SIZE)
    keys = ("prefix_hit_rate", "prefix_hits", "slot_pages_peak", "num_pages",
            "page_bytes", "pages_peak", "page_evictions", "cow_copies",
            "sessions", "prefill_tokens_computed", "prefill_tokens_dense")
    emit({"phase": "serve_paged", "argv": SERVE_PAGED_ARGV, "exit": rc,
          "summary_line": line, "paged_line": paged_line,
          **{k: summary.get(k) for k in SERVE_KEYS + keys},
          "page_bytes_estimate": estimate, "peak_mem_bytes": peak,
          "profile": serve_profile(torch, SERVE_PAGED_ARGV),
          "dense_bf16_serve": {k: dense.get(k) for k in (
              "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95", "tok_ms_mean",
              "peak_mem_bytes", "profile")}})
    check(summary["total_new_tokens"] == SERVE_REQUESTS * SERVE_NEW,
          f"serve_paged: {summary['total_new_tokens']} tokens delivered, not "
          f"{SERVE_REQUESTS} x {SERVE_NEW}")
    check(paged_line is not None, "serve_paged: no [serve] paged: line")
    check(summary.get("page_bytes") == estimate,
          f"serve_paged: the engine's page holds {summary.get('page_bytes')} "
          f"bytes, not page_bytes_estimate's {estimate}")


def spec_prompts(np, rng, vocab, prefix=()):
    """SPEC_REQUESTS prompts, each a random segment of SPEC_SEGMENTS
    tokens repeated three times and a random tail of SPEC_TAILS tokens,
    after ``prefix``: the repeats give the k-gram self-draft earlier
    occurrences to propose from."""
    out = []
    for _ in range(SPEC_REQUESTS):
        seg = rng.integers(0, vocab, int(rng.integers(*SPEC_SEGMENTS)))
        tail = rng.integers(0, vocab, int(rng.integers(*SPEC_TAILS)))
        out.append(np.concatenate([np.asarray(prefix, dtype=np.int64),
                                   seg, seg, seg, tail]))
    return out


def spec_leg(torch, model, engine, speculator, prompts, budgets, leg):
    """One leg of serve_spec_identity: the prompts (with their budgets)
    through the FIFO scheduler with ``speculator`` over ``engine`` (built
    with SPEC_K), every stream against ``generate()`` on ``model`` under
    the top-2 gap rule. Returns the leg's record."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)

    engine.warmup(speculator)
    sched = Scheduler(engine, decode_priority=4, speculator=speculator)
    t0 = time.time()
    done = {c.rid: c for c in sched.run(
        [Request(rid=i, prompt=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, budgets))])}
    wall = time.time() - t0
    excused = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        ref = generate(model, torch.from_numpy(p).to(DEVICE)[None],
                       n)[0].tolist()
        why = stream_check(torch, model, p.tolist(), done[i].tokens, ref,
                           f"serve_spec_identity ({leg}): request {i} "
                           f"(prompt {len(p)})")
        if why:
            excused.append({"rid": i, "prompt_len": len(p), **why})
    summ = sched.summary
    return {"leg": leg, "requests": len(prompts), "budgets": list(budgets),
            "identical": len(prompts) - len(excused), "excused": excused,
            "excused_count": len(excused),
            **{k: summ[k] for k in ("accept_rate", "verify_steps",
                                    "spec_proposed", "spec_accepted",
                                    "spec_fallback_slots",
                                    "spec_batch_fallbacks", "decode_steps",
                                    "total_new_tokens")},
            "max_len": engine.max_len, "wall_s": round(wall, 3)}


def phase_serve_spec_identity(torch, np) -> None:
    """Speculative serving in f32 at full width (fresh-init from seed 0,
    tied embeddings: SPEC_TIED),
    SPEC_REQUESTS requests of SPEC_NEW tokens over IDENTITY_SLOTS slots,
    k = SPEC_K, every stream against ``generate()`` under the top-2 gap
    rule, in four legs: (a) the k-gram self-draft on the dense engine;
    (b) a draft GPT (``--serve.draft-config tiny``, seeded); (c) the
    self-draft on the paged engine with the radix cache, the prompts
    behind a shared prefix; (d) a cache sized exactly to the longest
    prompt + budget, where slots near their end take the plain path
    inside the verify (each request's budget fills the cache to its last
    column). Gates: every token delivered, no whole-batch plain step,
    accepted proposals in (a) and (c), prefix hits in (c), fallback slots
    in (d)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets)
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.paging.engine import (
        PagedSlotEngine)
    from tensorflow_distributed_tpu_torch.serve.speculate import (
        SelfDraft, build_speculator)

    model = gpt2_small(torch, torch.float32, tie_embeddings=SPEC_TIED)
    vocab, max_len = model.cfg.vocab_size, model.cfg.max_len
    rng = np.random.default_rng(3)
    prompts = spec_prompts(np, rng, vocab)
    shared = spec_prompts(np, rng, vocab,
                          prefix=rng.integers(0, vocab, SPEC_PREFIX))
    ladder = default_buckets(max(len(p) for p in shared), cap=max_len)
    budgets = [SPEC_NEW] * SPEC_REQUESTS
    legs = []

    def dense(m):
        return SlotDecodeEngine(m, IDENTITY_SLOTS, buckets=ladder,
                                spec_tokens=SPEC_K)

    legs.append(spec_leg(torch, model, dense(model),
                         SelfDraft(IDENTITY_SLOTS, SPEC_K), prompts, budgets,
                         "a: self-draft"))
    cfg = parse_args(["--mode", "serve", "--model", "gpt_lm",
                      "--serve.spec-tokens", str(SPEC_K),
                      "--serve.draft-config", "tiny", "--device", DEVICE])
    draft = build_speculator(cfg, model, cfg.seed + 1, IDENTITY_SLOTS, ladder)
    legs.append(spec_leg(torch, model, dense(model), draft, prompts, budgets,
                         "b: draft tiny"))
    legs[-1]["draft_params"] = sum(p.numel() for p in draft.model.parameters())
    paged = PagedSlotEngine(model, IDENTITY_SLOTS, page_size=PAGE_SIZE,
                            buckets=ladder, spec_tokens=SPEC_K)
    legs.append(spec_leg(torch, model, paged,
                         SelfDraft(IDENTITY_SLOTS, SPEC_K), shared, budgets,
                         "c: paged self-draft"))
    legs[-1]["prefix_hits"] = paged.prefix_hits
    need = max(len(p) for p in prompts) + SPEC_NEW
    exact = gpt2_small(torch, torch.float32, max_len=need,
                       tie_embeddings=SPEC_TIED)
    legs.append(spec_leg(torch, exact, SlotDecodeEngine(
        exact, IDENTITY_SLOTS, buckets=default_buckets(need, cap=need),
        spec_tokens=SPEC_K), SelfDraft(IDENTITY_SLOTS, SPEC_K), prompts,
        [need - len(p) for p in prompts], "d: exact cache"))
    emit({"phase": "serve_spec_identity", "k": SPEC_K,
          "slots": IDENTITY_SLOTS, "new_tokens": SPEC_NEW,
          "prompt_lens": [len(p) for p in prompts], "legs": legs})
    for leg in legs:
        check(leg["total_new_tokens"] == sum(leg["budgets"]),
              f"serve_spec_identity ({leg['leg']}): "
              f"{leg['total_new_tokens']} tokens delivered")
        check(leg["spec_batch_fallbacks"] == 0,
              f"serve_spec_identity ({leg['leg']}): "
              f"{leg['spec_batch_fallbacks']} whole-batch plain steps")
    for i in (0, 2):
        check(legs[i]["spec_accepted"] > 0,
              f"serve_spec_identity ({legs[i]['leg']}): no proposal accepted")
    # Every request admitted after the first release attaches the prefix.
    check(legs[2]["prefix_hits"] >= SPEC_REQUESTS - IDENTITY_SLOTS,
          f"serve_spec_identity (c): {legs[2]['prefix_hits']} prefix hits")
    check(legs[3]["spec_fallback_slots"] > 0,
          "serve_spec_identity (d): no slot took the plain path in an "
          "exactly sized cache")


def phase_serve_spec(torch, dense: dict) -> None:
    """``--mode serve --serve.spec-tokens SPEC_K`` through the CLI at full
    width in bf16 (the serve phase's workload): every token delivered,
    the speculative line printed; its summary and a traced verify step
    beside the serve phase's decode step."""
    torch.cuda.reset_peak_memory_stats()
    rc, line, summary, out = serve_cli(SERVE_SPEC_ARGV)
    peak = torch.cuda.max_memory_allocated()
    spec_line = next((l for l in out.splitlines()
                      if l.startswith("[serve] speculative: ")), None)
    keys = ("accept_rate", "verify_steps", "spec_proposed", "spec_accepted",
            "spec_fallback_slots", "spec_batch_fallbacks")
    emit({"phase": "serve_spec", "argv": SERVE_SPEC_ARGV, "exit": rc,
          "summary_line": line, "spec_line": spec_line,
          **{k: summary.get(k) for k in SERVE_KEYS + keys},
          "peak_mem_bytes": peak,
          "profile": serve_profile(torch, SERVE_SPEC_ARGV),
          "dense_bf16_serve": {k: dense.get(k) for k in (
              "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95", "tok_ms_mean",
              "profile")}})
    check(summary["total_new_tokens"] == SERVE_REQUESTS * SERVE_NEW,
          f"serve_spec: {summary['total_new_tokens']} tokens delivered, not "
          f"{SERVE_REQUESTS} x {SERVE_NEW}")
    check(spec_line is not None and summary.get("verify_steps", 0) > 0,
          "serve_spec: no verify step (no [serve] speculative: line)")


def slo_runs(torch, paged: bool):
    """SLO_ARGV's workload and engine (``serve_setup``, the CLI's), served
    under FIFO and then under slo on a fresh engine (a paged engine's
    prefix cache would otherwise carry the FIFO run's pages). Returns
    {policy: (completions by rid, summary)}, the requests and the
    dense model."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.serve.run import serve_setup
    from tensorflow_distributed_tpu_torch.serve.scheduler import Scheduler

    argv = SLO_ARGV + ["--device", DEVICE] + (
        ["--serve.paged", "true", "--serve.num-pages", str(SLO_NUM_PAGES)]
        if paged else [])
    out = {}
    for policy in ("fifo", "slo"):
        cfg, engine, requests = serve_setup(parse_args(argv))
        engine.warmup()
        slo = policy == "slo"
        sched = Scheduler(engine, decode_priority=cfg.serve.decode_priority,
                          policy=policy, preempt=cfg.serve.preempt,
                          tenant_quota=cfg.serve.tenant_quota if slo else 0)
        done = {c.rid: c for c in sched.run(requests)}
        out[policy] = (done, sched.summary)
    return out, requests, engine.model


def phase_serve_slo(torch, np) -> None:
    """The SLO scheduler in f32 at full width over 2 slots: SLO_ARGV's 12
    requests (classes high:0.25, batch:0.25; 2 tenants, quota 96 tokens;
    20 req/s against ~2 s of work), under FIFO and under slo, dense and
    then paged. Gates: a preemption in each slo run; every slo stream
    equal to the FIFO stream of the same request (the top-2 gap rule);
    on the paged engine each preemption's continuation a prefix hit.
    Prints the high class's p95 time to first token under each
    policy."""
    from tensorflow_distributed_tpu_torch.serve.scheduler import percentile

    model = None
    for leg in ("dense", "paged"):
        runs, requests, engine_model = slo_runs(torch, leg == "paged")
        if model is None:
            model = engine_model       # the dense model, for the gap
        fifo, slo = runs["fifo"][0], runs["slo"][0]
        excused = []
        for r in requests:
            why = stream_check(torch, model, r.prompt.tolist(),
                               slo[r.rid].tokens, fifo[r.rid].tokens,
                               f"serve_slo ({leg}): request {r.rid}")
            if why:
                excused.append({"rid": r.rid, **why})
        record = {"phase": "serve_slo", "leg": leg,
                  "classes": [r.slo for r in requests],
                  "tenants": [r.tenant for r in requests],
                  "identical": len(requests) - len(excused),
                  "excused": excused}
        for policy, (done, summ) in runs.items():
            by_cls = {}
            for c in done.values():
                by_cls.setdefault(requests[c.rid].slo, []).append(
                    1e3 * c.ttft_s)
            record[policy] = {
                "ttft_ms_p95_by_class": {
                    cls: round(percentile(sorted(v), 95), 3)
                    for cls, v in sorted(by_cls.items())},
                "preemptions": summ["preemptions"],
                "preempts_by_rid": {c.rid: c.preempts for c in done.values()
                                    if c.preempts},
                **{k: summ.get(k) for k in (
                    "tokens_per_sec", "wall_s", "decode_steps",
                    "total_new_tokens", "prefills", "prefix_hits",
                    "page_evictions", "prefill_tokens_computed",
                    "prefill_tokens_dense")}}
        emit(record)
        want = len(requests) * requests[0].max_new_tokens
        for policy in ("fifo", "slo"):
            check(record[policy]["total_new_tokens"] == want,
                  f"serve_slo ({leg}, {policy}): "
                  f"{record[policy]['total_new_tokens']} tokens delivered")
        check(record["slo"]["preemptions"] >= 1,
              f"serve_slo ({leg}): no preemption")
        check(record["fifo"]["preemptions"] == 0,
              f"serve_slo ({leg}): FIFO preempted")
        if leg == "paged":
            check(record["slo"]["prefix_hits"] == record["slo"]["preemptions"]
                  and record["slo"]["page_evictions"] == 0,
                  f"serve_slo (paged): {record['slo']['prefix_hits']} prefix "
                  f"hits for {record['slo']['preemptions']} preemptions "
                  f"({record['slo']['page_evictions']} evictions)")


def fire_engine_runs(torch, argv, paged: bool):
    """Leg (a) of serve_fire on one engine layout: ``argv`` + FIRE_PLAN
    built by ``serve_setup`` (the CLI's path: the checkpoint's weights,
    the fault plan on the engine), served by the scheduler as serve_run
    builds it; and the same requests without faults on a twin engine over
    the same model. Returns (the leg's record, the fire completions, the
    fault-free completions, the requests, the engine)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.paging.engine import (
        PagedSlotEngine)
    from tensorflow_distributed_tpu_torch.serve.run import (
        reload_from, serve_setup)
    from tensorflow_distributed_tpu_torch.serve.scheduler import Scheduler

    argv = argv + ["--device", DEVICE, "--resilience.fault-plan", FIRE_PLAN]
    if paged:
        argv += ["--serve.paged", "true"]
    cfg, engine, requests = serve_setup(parse_args(argv))
    if paged:
        twin = PagedSlotEngine(engine.model, engine.num_slots,
                               page_size=engine.page_size,
                               num_pages=engine.pool.capacity,
                               buckets=engine.buckets)
    else:
        twin = SlotDecodeEngine(engine.model, engine.num_slots,
                                buckets=engine.buckets)
    twin.warmup()
    base = {c.rid: c for c in Scheduler(
        twin, decode_priority=cfg.serve.decode_priority).run(requests)}
    del twin
    engine.warmup()
    # What the device flag named, and (paged) whether each quarantined
    # slot's private pages read 0 once released.
    flagged, scrubbed = [], []
    take = engine.take_bad_slots

    def take_bad_slots():
        bad = take()
        if bad:
            flagged.append({"step": engine.decode_steps, "slots": bad})
        return bad

    engine.take_bad_slots = take_bad_slots
    if paged:
        release = engine.release

        def checked_release(slot, tokens=None, session=""):
            bad = slot in engine._poisoned or slot in engine._flagged
            priv = engine._private_pages(slot) if bad else []
            release(slot, tokens=tokens, session=session)
            if bad:
                idx = torch.tensor(priv, device=engine.device)
                scrubbed.append({"slot": slot, "pages": len(priv),
                                 "zero": all(bool((t[idx] == 0).all())
                                             for t in engine.cache.leaves())})

        engine.release = checked_release
    # What the reload returned, to hold the served tensors against after
    # the swap: the same storage as before it, holding those values.
    reload, restored = reload_from(cfg, engine), []

    def reload_fn():
        got = reload()
        restored.append(got[0])
        return got

    ptrs = {n: t.data_ptr() for n, t in engine.model.named_parameters()}
    sched = Scheduler(engine, decode_priority=cfg.serve.decode_priority,
                      fault_plan=engine.fault_plan, reload_fn=reload_fn,
                      slot_retries=cfg.serve.slot_retries)
    t0 = time.time()
    done = {c.rid: c for c in sched.run(requests)}
    summ = sched.summary
    record = {"leg": "a: " + ("paged" if paged else "dense"),
              "plan": FIRE_PLAN, "wall_s": round(time.time() - t0, 3),
              "flagged_by_device": flagged,
              "flags_raised": engine.flagged_slots,
              "retries_by_rid": {c.rid: c.retries for c in done.values()
                                 if c.retries},
              **{k: summ[k] for k in ("retries", "swaps", "swap_seconds",
                                      "decode_steps", "prefills",
                                      "total_new_tokens")}}
    live = dict(engine.model.named_parameters())
    record["swap_wrote_through"] = len(restored) == 1 and all(
        live[n].data_ptr() == ptrs[n] and torch.equal(live[n], t)
        for n, t in restored[0].items())
    if paged:
        record["scrubbed"] = scrubbed
    return record, done, base, requests, engine


def beside(fn):
    """Run ``fn`` in a thread beside the caller's work; returns a call
    that waits for it and gives its result (or raises what it raised,
    a failed check's exit included)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:
            out["error"] = e

    worker = threading.Thread(target=run, daemon=True)
    worker.start()

    def result():
        worker.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return result


def fire_cli(argv, what: str, phase: str = "serve_fire"):
    """``python -m tensorflow_distributed_tpu_torch.cli argv`` in a
    process of its own, its standard output read as it comes. Returns
    (exit code, output, error output, the wall time at which the output
    first named an injected fault, the wall time at exit); the process
    is killed if it outlives FIRE_CLI_TIMEOUT_S."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflow_distributed_tpu_torch.cli",
         *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=REPO,
                            PYTHONUNBUFFERED="1"))
    expired = threading.Event()

    def expire():
        expired.set()
        proc.kill()

    timer = threading.Timer(FIRE_CLI_TIMEOUT_S, expire)
    timer.start()
    lines, t_fault, err = [], None, ""
    try:
        for line in proc.stdout:
            lines.append(line)
            if t_fault is None and '"kind": "fault_injected"' in line:
                t_fault = time.time()
        rc = proc.wait()
        t_exit = time.time()
        err = proc.stderr.read()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sys.stderr.write(err[-3000:])
    check(not expired.is_set(),
          f"{phase} ({what}): the CLI ran past {FIRE_CLI_TIMEOUT_S} s")
    return rc, "".join(lines), err, t_fault, t_exit


def flag_cost(torch, last) -> dict:
    """The per-slot finiteness flag's own device cost on a decode step's
    logits ``last``: launches and device time a call of the argmax alone
    and of the argmax with the flag (``SlotDecodeEngine._pack``), from
    torch.profiler over FLAG_CALLS calls, after a warm-up cycle of as
    many (a profile of a few microsecond kernels from a cold start can
    drop their records)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)

    cost = {}
    for name, fn in (("argmax", lambda: last.argmax(dim=-1)),
                     ("argmax_and_flag", lambda: SlotDecodeEngine._pack(last))):
        seen = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: seen.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(FLAG_CALLS):
                    fn()
                sync(torch)
                prof.step()
        busy = launches = 0
        for e in seen[-1] if seen else ():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                busy += us / FLAG_CALLS / 1e3
                launches += e.count / FLAG_CALLS
        cost[name] = {"device_ms": busy, "launches": launches}
    return cost


def fire_leg_a(torch, ckpt_dir: str, serve: dict) -> None:
    """serve_fire (a): two quarantines and a swap, dense then paged; then
    the flag's cost beside the serve phase's traced decode step."""
    fire_argv = SERVE_CKPT_ARGV[:SERVE_CKPT_ARGV.index("--serve.stream")] + [
        "--checkpoint-dir", ckpt_dir, "--serve.num-slots", str(FIRE_SLOTS),
        "--serve.num-requests", str(FIRE_REQUESTS),
        "--serve.max-new-tokens", str(FIRE_NEW),
        # Every slot fills in the first steps, so the named slots are live.
        "--serve.decode-priority", "1"]
    model = None
    for paged in (False, True):
        record, done, base, requests, engine = fire_engine_runs(
            torch, fire_argv, paged)
        if model is None:
            model = engine.model       # the dense f32 model, for the gap
        excused = []
        for r in requests:
            why = stream_check(torch, model, r.prompt.tolist(),
                               done[r.rid].tokens, base[r.rid].tokens,
                               f"serve_fire ({record['leg']}): request "
                               f"{r.rid}")
            if why:
                excused.append({"rid": r.rid, **why})
        record.update(phase="serve_fire", identical=len(requests)
                      - len(excused), excused=excused)
        emit(record)
        check(record["total_new_tokens"] == FIRE_REQUESTS * FIRE_NEW,
              f"serve_fire ({record['leg']}): "
              f"{record['total_new_tokens']} tokens delivered")
        check(record["retries"] == 2 and record["swaps"] == 1,
              f"serve_fire ({record['leg']}): retries {record['retries']}, "
              f"swaps {record['swaps']} (want 2 and 1)")
        check(record["swap_wrote_through"],
              f"serve_fire ({record['leg']}): the served tensors do not "
              f"hold the reloaded params in their own storage")
        check(record["flags_raised"] == 2
              and sum(len(f["slots"]) for f in record["flagged_by_device"])
              == 2, f"serve_fire ({record['leg']}): the device flag named "
              f"{record['flagged_by_device']}")
        if paged:
            check(len(record["scrubbed"]) == 2
                  and all(x["zero"] and x["pages"] for x in
                          record["scrubbed"]),
                  f"serve_fire (a: paged): scrub {record['scrubbed']}")
            continue
        # The flag's own cost on this engine's decode logits (the serve
        # phase's shape: 8 slots x the vocabulary).
        last = engine._dispatch_step(engine._h2d(engine.tok),
                                     engine._h2d(engine.pos))
        prof_serve = serve.get("profile", {})
        emit({"phase": "serve_fire", "leg": "decode_flag",
              "logits_shape": list(last.shape), **flag_cost(torch, last),
              "serve_decode_step": {k: prof_serve.get(k) for k in (
                  "launches_per_step", "device_busy_ms",
                  "d2h_copies_per_step", "step_ms")}})
        check(prof_serve.get("d2h_copies_per_step") == 1.0,
              f"serve_fire: {prof_serve.get('d2h_copies_per_step')} "
              f"device-to-host copies a decode step (want one)")


def fire_leg_b(torch, np) -> None:
    """serve_fire (b): two quarantines mid-verify (k = SPEC_K, the
    self-draft, tied fresh-init weights) with a journal."""
    from tensorflow_distributed_tpu_torch.resilience.faults import (
        parse_fault_plan)
    from tensorflow_distributed_tpu_torch.serve import journal
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets)
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)
    from tensorflow_distributed_tpu_torch.serve.speculate import SelfDraft

    tied = gpt2_small(torch, torch.float32, tie_embeddings=SPEC_TIED)
    prompts = spec_prompts(np, np.random.default_rng(4), tied.cfg.vocab_size)
    # Quarantine continuations re-prefill up to prompt + budget.
    ladder = default_buckets(max(len(p) for p in prompts) + SPEC_NEW,
                             cap=tied.cfg.max_len)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="tfd_fire_") as tmp:
        for name, plan in (("base", None), ("fire", FIRE_SPEC_PLAN)):
            fp = parse_fault_plan(plan) if plan else None
            engine = SlotDecodeEngine(tied, IDENTITY_SLOTS, buckets=ladder,
                                      spec_tokens=SPEC_K, fault_plan=fp)
            drafter = SelfDraft(IDENTITY_SLOTS, SPEC_K)
            engine.warmup(drafter)
            jpath = os.path.join(tmp, f"{name}.jsonl")
            jr = journal.RequestJournal(jpath)
            sched = Scheduler(engine, decode_priority=1, fault_plan=fp,
                              journal=jr, speculator=drafter)
            done = {c.rid: c for c in sched.run(
                [Request(rid=i, prompt=p, max_new_tokens=SPEC_NEW)
                 for i, p in enumerate(prompts)])}
            jr.close()
            runs[name] = (done, sched.summary, engine,
                          journal.replay(jpath))
    done, summ, engine, played = runs["fire"]
    base = runs["base"][0]
    excused = []
    for i, p in enumerate(prompts):
        why = stream_check(torch, tied, p.tolist(), done[i].tokens,
                           base[i].tokens, f"serve_fire (b): request {i}")
        if why:
            excused.append({"rid": i, **why})
    emit({"phase": "serve_fire", "leg": "b: mid-verify",
          "plan": FIRE_SPEC_PLAN, "k": SPEC_K,
          "identical": len(prompts) - len(excused), "excused": excused,
          "quarantined_rids": sorted(c.rid for c in done.values()
                                     if c.retries),
          "verify_steps": engine.verify_steps,
          "decode_steps": engine.decode_steps,
          **{k: summ[k] for k in ("retries", "accept_rate",
                                  "spec_accepted", "total_new_tokens")},
          "base_accept_rate": runs["base"][1]["accept_rate"]})
    check(summ["retries"] == 2 and engine.flagged_slots == 2,
          f"serve_fire (b): {summ['retries']} retries")
    check(engine.verify_steps == engine.decode_steps,
          "serve_fire (b): a quarantine came off a plain step, not a verify")
    check(all(played[i]["done"] and played[i]["tokens"] == done[i].tokens
              for i in done),
          "serve_fire (b): the journal holds a token the streams do not "
          "(a poisoned verify row was retired)")


def fire_leg_c() -> None:
    """serve_fire (c): a decode stall past the watchdog; the CLI process
    exits 3 while the stall still sleeps."""
    rc, _, err, t_fault, t_exit = fire_cli(FIRE_STALL_ARGV, "c: stall")
    stall_to_exit = None if t_fault is None else t_exit - t_fault
    emit({"phase": "serve_fire", "leg": "c: stall", "argv": FIRE_STALL_ARGV,
          "exit": rc, "stall_to_exit_s": stall_to_exit,
          "stall_s": FIRE_STALL_S, "timeout_s": FIRE_TIMEOUT_S})
    check(rc == 3 and "serve stalled" in err,
          f"serve_fire (c): the CLI exited {rc}, not 3")
    check(stall_to_exit is not None and stall_to_exit < FIRE_STALL_S,
          f"serve_fire (c): exit {stall_to_exit} s after the stall began "
          f"(the stall lasts {FIRE_STALL_S} s)")


def fire_leg_d_clis() -> dict:
    """serve_fire (d)'s two CLI processes: a run SIGKILLed mid-traffic
    with a journal, then the same command resuming it. Returns their exit
    codes, the second's output, the requests finished before the kill,
    the replayed journal and its records."""
    from tensorflow_distributed_tpu_torch.serve import journal

    with tempfile.TemporaryDirectory(prefix="tfd_fire_") as tmp:
        jpath = os.path.join(tmp, "serve.journal")
        argv = FIRE_KILL_ARGV + ["--serve.journal", jpath,
                                 "--resilience.fault-plan", FIRE_KILL_PLAN]
        rc1 = fire_cli(argv, "d: killed leg")[0]
        finished = sorted(r for r, e in journal.replay(jpath).items()
                          if e["done"])
        rc2, out2 = fire_cli(argv, "d: resumed leg")[:2]
        played = journal.replay(jpath)
        with open(jpath) as f:
            recs = [json.loads(line) for line in f if line.startswith("{")]
    return {"rc1": rc1, "finished": finished, "rc2": rc2, "out2": out2,
            "played": played, "recs": recs}


def fire_leg_d(torch, clis=None) -> None:
    """serve_fire (d): a CLI process SIGKILLed mid-traffic with a journal;
    the same command resumes it; against the uninterrupted run in this
    process (computed first: ``clis``, a ``beside`` of fire_leg_d_clis,
    runs the processes meanwhile; None runs them here)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.serve.run import serve_setup
    from tensorflow_distributed_tpu_torch.serve.scheduler import Scheduler

    cfg, engine, requests = serve_setup(parse_args(FIRE_KILL_ARGV + [
        "--device", DEVICE]))
    engine.warmup()
    ref = {c.rid: c for c in Scheduler(
        engine, decode_priority=cfg.serve.decode_priority).run(requests)}
    got = clis() if clis is not None else fire_leg_d_clis()
    rc1, finished, rc2, out2, played, recs = (
        got[k] for k in ("rc1", "finished", "rc2", "out2", "played", "recs"))
    summary2 = event_record(out2, "serve_summary") or {}
    done_records = {}
    for rec in recs:
        if rec.get("e") == "done":
            done_records[rec["rid"]] = done_records.get(rec["rid"], 0) + 1
    excused = []
    for r in requests:
        why = stream_check(torch, engine.model, r.prompt.tolist(),
                           played.get(r.rid, {}).get("tokens", []),
                           ref[r.rid].tokens, f"serve_fire (d): request "
                           f"{r.rid}")
        if why:
            excused.append({"rid": r.rid, **why})
    emit({"phase": "serve_fire", "leg": "d: sigkill + journal",
          "plan": FIRE_KILL_PLAN, "killed_exit": rc1, "resumed_exit": rc2,
          "finished_before_kill": finished,
          "resumed_requests": summary2.get("requests"),
          "done_records": done_records,
          "identical": len(requests) - len(excused), "excused": excused,
          "resume_line": next((l for l in out2.splitlines()
                               if l.startswith("[serve] journal resume")),
                              None)})
    check(rc1 == -signal.SIGKILL, f"serve_fire (d): the first leg exited "
                                  f"{rc1}, not by SIGKILL")
    check(rc2 == 0, f"serve_fire (d): the resumed leg exited {rc2}")
    check(bool(finished) and summary2.get("requests")
          == len(requests) - len(finished),
          f"serve_fire (d): {len(finished)} finished before the kill, "
          f"{summary2.get('requests')} served after it")
    check(done_records == {r.rid: 1 for r in requests},
          f"serve_fire (d): done records {done_records} (a request served "
          f"twice, or not at all)")


def phase_serve_fire(torch, np, ckpt_dir: str, serve: dict) -> None:
    """Serving under faults at full width: the four legs of the module
    docstring's phase 33 (``serve``: the serve phase's record, whose
    traced decode step the flag's cost stands beside)."""
    legs = {}
    t0 = time.time()
    fire_leg_a(torch, ckpt_dir, serve)
    legs["a"] = round(time.time() - t0, 1)
    t0 = time.time()
    fire_leg_c()
    legs["c"] = round(time.time() - t0, 1)
    # (d)'s two CLI processes run beside (b) and (d)'s reference in this
    # process: none of the three is timed.
    t0 = time.time()
    clis = beside(fire_leg_d_clis)
    fire_leg_b(torch, np)
    legs["b"] = round(time.time() - t0, 1)
    fire_leg_d(torch, clis)
    legs["b_and_d"] = round(time.time() - t0, 1)
    emit({"phase": "serve_fire", "leg_seconds": legs})


def fleet_workload(np, path: str) -> list:
    """serve_fleet's request file: FLEET_REQUESTS prompts of
    FLEET_PROMPTS tokens over GPT-2's vocabulary, FLEET_NEW new tokens
    each, arriving FLEET_GAP_S apart, every fourth of class high and the
    rest standard (1:3), all drawn from FLEET_SEED."""
    rng = np.random.default_rng(FLEET_SEED)
    rows = []
    for i in range(FLEET_REQUESTS):
        plen = int(rng.integers(FLEET_PROMPTS[0], FLEET_PROMPTS[1] + 1))
        rows.append({"prompt": rng.integers(0, 50257, plen).tolist(),
                     "max_new_tokens": FLEET_NEW,
                     "arrival_s": round(FLEET_GAP_S * i, 3),
                     "slo": "high" if i % 4 == 0 else "standard"})
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


def publish_step(src: str, ckpt_dir: str, step: int) -> str:
    """Publish checkpoint directory ``src`` as step ``step`` of
    ``ckpt_dir`` with the same weights: its ``state.msgpack`` hard-linked
    (copied where a link fails), its manifest naming the new step, staged
    and renamed so that a poller never sees half a step."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp)
    for name in os.listdir(src):
        a, b = os.path.join(src, name), os.path.join(tmp, name)
        if name == "manifest.json":
            with open(a) as f:
                manifest = json.load(f)
            manifest["step"] = step
            with open(b, "w") as f:
                json.dump(manifest, f)
        else:
            try:
                os.link(a, b)
            except OSError:
                shutil.copy2(a, b)
    os.rename(tmp, final)
    return final


def fleet_checkpoint(torch, tmp: str) -> str:
    """``--only serve_fleet``'s checkpoint: GPT-2-small as the
    checkpoint phase builds it (seeded, untrained), saved once."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)

    d = os.path.join(tmp, "ckpt_src")
    cfg = parse_args(CHECKPOINT_ARGV + ["--device", DEVICE])
    _, state = _build_model_and_state(cfg, torch.device(DEVICE))
    state.step = CHECKPOINT_STEPS
    ckpt.save(d, state)
    del state
    torch.cuda.empty_cache()
    return d


@contextlib.contextmanager
def fds_to(path: str):
    """Standard output and error (the file descriptors, so child
    processes' too) into ``path`` for the block."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(path, "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        try:
            yield
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            for fd in saved:
                os.close(fd)


def fleet_marks(ctl, router, marks: dict, stop) -> None:
    """serve_fleet's watcher (a thread from serving's start): kills r1
    once half the requests have arrived and a request there is mid-decode
    (FLEET_KILL_TOKENS decoded, found through its journal), then records the seconds to the first token of
    a re-dispatched request (as the router reads it), the restarted
    replica's first snapshot and the snapshots' first sequence numbers."""
    h0, h1 = ctl.members["r0"].handle, ctl.members["r1"].handle
    lo, hi = FLEET_KILL_TOKENS
    while not stop.is_set():
        now = time.monotonic()
        for name, h in (("r0", h0), ("r1", h1)):
            snap = h.read_snapshot()
            key = f"first_seq_{name}_e{h.epoch}"
            if snap is not None and key not in marks:
                marks[key] = snap["seq"]
        if "kill" not in marks:
            if now - marks["serving"] < FLEET_KILL_AFTER_S:
                stop.wait(0.005)
                continue
            jr = h1.read_journal(epoch=h1.epoch)
            if any(not e["done"] and lo <= len(e["tokens"]) <= hi
                   for e in jr.values()):
                marks["kill"] = now
                marks["killed_journal"] = {
                    int(rid): len(e["tokens"]) for rid, e in jr.items()
                    if not e["done"]}
                ctl.kill("r1")
        else:
            if "next_token" not in marks and any(
                    t.redispatched and t.cur and t.state != "shed"
                    for t in list(router.tracks.values())):
                marks["next_token"] = now
            if ("restarted" not in marks and h1.epoch >= 1
                    and h1.read_snapshot() is not None):
                marks["restarted"] = now
        stop.wait(0.005)


def phase_serve_fleet(torch, np, ckpt_dir=None) -> None:
    """Fleet serving on one card: two replicas of ``--mode serve`` behind
    ``fleet.run.run_fleet``; r1 SIGKILLed mid-decode and restarted on a
    fresh epoch, a newer step of the same weights rolled one replica at
    a time; every stream against one-process ``generate()`` (phase 62)."""
    from tensorflow_distributed_tpu_torch.fleet.controller import (
        ControllerConfig)
    from tensorflow_distributed_tpu_torch.fleet.router import RouterConfig
    from tensorflow_distributed_tpu_torch.fleet.run import (
        load_workload, run_fleet)
    from tensorflow_distributed_tpu_torch.models.generate import generate

    with tempfile.TemporaryDirectory(prefix="tfd_fleet_") as tmp:
        if ckpt_dir is None:
            ckpt_dir = fleet_checkpoint(torch, tmp)
        steps = sorted(int(n[5:]) for n in os.listdir(ckpt_dir)
                       if re.fullmatch(r"step_\d{8}", n))
        served = steps[-1]
        ck = os.path.join(tmp, "ckpt")
        os.makedirs(ck)
        publish_step(os.path.join(ckpt_dir, f"step_{served:08d}"), ck,
                     served)
        rows = fleet_workload(np, os.path.join(tmp, "wl.jsonl"))
        argv = FLEET_ARGV + ["--checkpoint-dir", ck]
        fleet_dir = os.path.join(tmp, "fleet")
        marks, stop = {}, threading.Event()
        ref = {}

        def reference():
            # One process's generate() on the restored weights, while the
            # replicas start (serving waits for it below).
            try:
                _, model, state = restored(torch, argv + ["--device",
                                                          DEVICE])
                if state.ema is not None:
                    model.load_state_dict(state.ema)
                del state
                ref["model"] = model
                ref["streams"] = [generate(model, torch.tensor(
                    [row["prompt"]], device=DEVICE), FLEET_NEW)[0].tolist()
                    for row in rows]
                sync(torch)
            except BaseException as e:  # re-raised by the phase
                ref["error"] = e

        worker = threading.Thread(target=reference, daemon=True)
        worker.start()

        def start(ctl, router):
            marks["serving"] = time.monotonic()
            worker.join()
            marks["reference_wait_s"] = time.monotonic() - marks["serving"]
            threading.Thread(target=fleet_marks, daemon=True,
                             args=(ctl, router, marks, stop)).start()

        def linger(ctl, router):
            # Every request done: once r1 is back, publish the newer step
            # and keep the fleet up until the controller has rolled it.
            if ctl.rolling_swaps + ctl.partial_rolls:
                return False
            if "restarted" in marks and "published" not in marks:
                publish_step(os.path.join(ck, f"step_{served:08d}"), ck,
                             served + FLEET_ROLL)
                marks["published"] = time.monotonic()
            return True

        log = os.path.join(tmp, "replicas.log")
        t_call = time.monotonic()
        try:
            with fds_to(log):
                summary = run_fleet(
                    fleet_dir=fleet_dir, replicas=2, base_args=argv,
                    workload=load_workload(os.path.join(tmp, "wl.jsonl")),
                    ckpt_dir=ck, actions=[(0.0, start)], linger=linger,
                    env=dict(os.environ, PYTHONPATH=REPO,
                             PYTHONUNBUFFERED="1"),
                    router_cfg=RouterConfig(dispatch_timeout_s=60.0),
                    controller_cfg=ControllerConfig(backoff_base_s=0.25),
                    timeout_s=FLEET_TIMEOUT_S,
                    jsonl=os.path.join(tmp, "fleet.jsonl"))
        except BaseException:
            with open(log) as f:
                sys.stderr.write(f.read()[-6000:])
            raise
        finally:
            stop.set()
        t_end = time.monotonic()
        fleet_recs = [json.loads(line) for line in
                      open(os.path.join(tmp, "fleet.jsonl"))]
        final = {}
        for name, epoch in (("r0", 0), ("r1", 1)):
            d = os.path.join(fleet_dir, name, f"e{epoch}")
            with open(os.path.join(d, "snapshot.json")) as f:
                snap = json.load(f)
            mem = [r for r in (json.loads(line) for line in
                               open(os.path.join(d, "metrics.jsonl")))
                   if r["event"] == "device_memory"]
            final[name] = {"snapshot": snap, "peak_bytes": (
                mem[-1]["peak_bytes_by_rank"][0] if mem else None)}
        dead_done = sum(
            1 for line in open(os.path.join(fleet_dir, "r1", "e0",
                                            "journal.jsonl"))
            if line.startswith('{"e": "done"'))
        roll = [r for r in fleet_recs if r["event"] in ("fleet_roll",
                                                        "fleet_swap")]
        begin = next((r["t_s"] for r in roll if r.get("state") == "begin"),
                     None)
        swap_s, prev = {}, begin
        for r in roll:
            if r["event"] == "fleet_swap" and "state" not in r:
                swap_s[r["replica"]] = round(r["t_s"] - prev, 3)
                prev = r["t_s"]
        with open(log) as f:
            replica_lines = f.read().count("\n")
        worker.join()
        if "error" in ref:
            raise ref["error"]
        excused = []
        for rid, row in enumerate(rows):
            why = stream_check(torch, ref["model"], row["prompt"],
                               summary["tokens"].get(str(rid), []),
                               ref["streams"][rid],
                               f"serve_fleet: request {rid}")
            if why:
                excused.append({"rid": rid, **why})
        ref.clear()
        torch.cuda.empty_cache()
    rolled = served + FLEET_ROLL
    record = {
        "phase": "serve_fleet", "argv": argv, "requests": FLEET_REQUESTS,
        "served_step": served, "rolled_step": rolled,
        "replica_start_s": round(marks["serving"] - t_call, 3)
        if "serving" in marks else None,
        "death_to_next_token_s": round(marks["next_token"] - marks["kill"], 3)
        if "next_token" in marks and "kill" in marks else None,
        "restart_s": round(marks["restarted"] - marks["kill"], 3)
        if "restarted" in marks and "kill" in marks else None,
        "killed_journal": marks.get("killed_journal"),
        "reference_wait_s": round(marks.get("reference_wait_s", 0.0), 3),
        "swap_s": swap_s, "fleet_wall_s": round(t_end - t_call, 3),
        "identical": FLEET_REQUESTS - len(excused), "excused": excused,
        "replica_log_lines": replica_lines,
        **{k: summary.get(k) for k in (
            "requests_done", "requests_lost", "requests_shed", "deaths",
            "restarts", "redispatches", "dispatches", "quarantines",
            "rolling_swaps", "partial_rolls", "swap_timeouts",
            "staleness_max_steps", "replica_done", "tokens_per_sec",
            "wall_s", "ttft_ms_p50_high", "ttft_ms_p95_high",
            "ttft_ms_p50_standard", "ttft_ms_p95_standard",
            "ttft_ms_p99_recovery", "drained_clean", "timed_out")},
        "replicas": {name: {
            "ckpt_step": v["snapshot"].get("ckpt_step"),
            "seq_first": marks.get(f"first_seq_{name}_e{e}"),
            "seq_last": v["snapshot"].get("seq"),
            "requests_done": v["snapshot"].get("requests_done"),
            "peak_bytes": v["peak_bytes"]}
            for (name, v), e in zip(sorted(final.items()), (0, 1))},
        "dead_epoch_done": dead_done}
    emit(record)
    fleet_gates(record)


def fleet_gates(rec: dict) -> None:
    """serve_fleet's gates on its record."""
    check(not rec["timed_out"], "serve_fleet: the fleet timed out")
    check(rec["requests_done"] == FLEET_REQUESTS
          and rec["requests_lost"] == 0 and rec["requests_shed"] == 0,
          f"serve_fleet: {rec['requests_done']} done, "
          f"{rec['requests_lost']} lost, {rec['requests_shed']} shed")
    check(rec["deaths"] == 1 and rec["restarts"] == 1
          and rec["redispatches"] >= 1,
          f"serve_fleet: deaths {rec['deaths']}, restarts "
          f"{rec['restarts']}, redispatches {rec['redispatches']}")
    check(rec["rolling_swaps"] == 1 and rec["partial_rolls"] == 0,
          f"serve_fleet: rolling_swaps {rec['rolling_swaps']}, "
          f"partial_rolls {rec['partial_rolls']}")
    reps = rec["replicas"]
    check(all(r["ckpt_step"] == rec["rolled_step"] for r in reps.values()),
          f"serve_fleet: staleness not back to 0 "
          f"({ {n: r['ckpt_step'] for n, r in reps.items()} } served, "
          f"{rec['rolled_step']} trained)")
    for name, r in reps.items():
        check(r["seq_first"] is not None and r["seq_last"] > r["seq_first"],
              f"serve_fleet: {name}'s snapshot seq did not rise "
              f"({r['seq_first']} -> {r['seq_last']})")
    done = rec["replica_done"] or {}
    check(reps["r0"]["requests_done"] == done.get("r0")
          and reps["r1"]["requests_done"] + rec["dead_epoch_done"]
          == done.get("r1"),
          f"serve_fleet: the replicas' snapshots count "
          f"{ {n: r['requests_done'] for n, r in reps.items()} } (+ "
          f"{rec['dead_epoch_done']} in r1's dead epoch), the router "
          f"{done}")


def step_losses(out: str):
    """{step: loss} from a CLI's ``[step N] ... loss=X`` lines."""
    got = {}
    for line in out.splitlines():
        m = re.match(r"\[step\s+(\d+)\].*\bloss=(\S+)", line)
        if m:
            got[int(m.group(1))] = float(m.group(2))
    return got


def fire_train(kernels, torch, argv) -> dict:
    """One in-process run of ``argv`` through ``train()``: the recovery
    records it printed, its losses, the latest checkpoint at each step's
    record, the kernels' launches (counts set to 0 just before), the
    median step ms untraced (from the step records' times, steps 4 on,
    outside the traced steps) and, on a card, from torch.profiler over
    the steps between the records of TRAIN_FIRE_PROFILE's two steps
    (whole steps: each record ends in the loss fetch): the step ms,
    launches, device busy ms a step and the device's idle share."""
    import contextlib
    import io

    from torch.profiler import ProfilerActivity, profile

    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train import checkpoint
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    cfg = parse_args(argv)
    lo, hi = TRAIN_FIRE_PROFILE
    traced = cfg.device != "cpu"
    window: dict = {}
    latest = []

    class Reads(MetricLogger):
        def log(self, step, **metrics):
            super().log(step, **metrics)
            if cfg.checkpoint_dir:
                latest.append(checkpoint.latest_step(cfg.checkpoint_dir))
            if traced and step == lo:
                window["prof"] = profile(activities=[ProfilerActivity.CUDA])
                window["prof"].__enter__()
                window["t0"] = time.time()
            elif traced and step == hi:
                torch.cuda.synchronize()
                window["s"] = time.time() - window["t0"]
                window["prof"].__exit__(None, None, None)

    for kern in kernels:
        kern.launches = 0
    logger = Reads(stream=sys.stderr)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = train(cfg, logger=logger)
    sys.stderr.write(buf.getvalue())
    records = [r for r in logger.records if "loss" in r.metrics]
    marks = [(r.step, r.wall_time) for r in records]
    # Per-step times of the intervals between records from step 3 on,
    # none overlapping the traced steps or the profiler's start and stop.
    step_s = [(b - a) / (sb - sa) for (sa, a), (sb, b) in zip(marks,
                                                             marks[1:])
              if sa >= 3 and (sb <= lo or sa > hi)]
    rec = {"losses": [r.metrics["loss"] for r in records],
           "recovery": [json.loads(l) for l in buf.getvalue().splitlines()
                        if l.startswith('{"event": "recovery"')],
           "latest": latest, "final": result.final_metrics,
           "steps": result.state.step,
           "launches": {kern.name: kern.launches for kern in kernels},
           "step_ms_median": (statistics.median(step_s) * 1e3
                              if step_s else None)}
    if "s" in window:
        n = hi - lo
        busy, launched = 0.0, 0
        for e in window["prof"].key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                busy += us / 1e3
                launched += e.count
        step_ms = window["s"] / n * 1e3
        rec.update(traced_step_ms=step_ms,
                   launches_per_step=launched / n,
                   device_busy_ms=busy / n if busy else None,
                   device_idle_share=(1 - busy / n / step_ms) if busy
                   else None)
    return rec


def fire_launch_check(rec, what: str) -> None:
    """B1-B3 twelve times a step and B4-B6 once (B1 also in the final
    eval), no ring kernel: the run went through the hand kernels."""
    got, n = rec["launches"], rec["steps"]
    check(got["flash_dq"] == got["flash_dkv"] == 12 * n
          and got["flash_fwd"] >= 12 * n
          and all(got[k] == n for k in CE_KERNELS)
          and not any(got[k] for k in RING_KERNELS),
          f"train_fire ({what}): not B1-B6 at every step: {got}")


def rel_diff(got, ref) -> float:
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, ref))


def train_fire_leg_a(kernels, torch) -> list:
    """train_fire (a): the plain run, the same run under every per-step
    reader (TRAIN_FIRE_WATCH: the window, the watchdogs and the skip
    policy's verdict read), and that run with a save every 2 steps under
    ckpt_io_fail@4:2. Returns the plain run's losses."""
    from tensorflow_distributed_tpu_torch.train import checkpoint

    plain = fire_train(kernels, torch, TRAIN_FIRE_ARGV)
    watched = fire_train(kernels, torch, TRAIN_FIRE_ARGV + TRAIN_FIRE_WATCH)
    with tempfile.TemporaryDirectory(prefix="tfd_train_fire_") as d:
        fire = fire_train(kernels, torch, TRAIN_FIRE_ARGV + TRAIN_FIRE_WATCH
                          + ["--checkpoint-dir", d, "--checkpoint-every", "2",
                             "--resilience.fault-plan", TRAIN_FIRE_SAVE_PLAN])
        landed = checkpoint.available_steps(d)
    keys = ("step_ms_median", "traced_step_ms", "launches_per_step",
            "device_busy_ms", "device_idle_share")
    retries = [r for r in fire["recovery"] if r["kind"] == "ckpt_retry"]
    emit({"phase": "train_fire", "leg": "a: resilience on the fused path",
          "argv": TRAIN_FIRE_ARGV, "watch": TRAIN_FIRE_WATCH,
          "plan": TRAIN_FIRE_SAVE_PLAN,
          "plain": {k: plain.get(k) for k in keys},
          "watched": {k: watched.get(k) for k in keys},
          "step_ms_cost": {
              "watched": watched["step_ms_median"] - plain["step_ms_median"]},
          "watched_max_rel_diff": rel_diff(watched["losses"], plain["losses"]),
          "fire_max_rel_diff": rel_diff(fire["losses"], plain["losses"]),
          "retries": [(r["step"], r["attempt"]) for r in retries],
          "latest_at_records": fire["latest"], "landed": landed,
          "launches": plain["launches"]})
    runs = (("plain", plain), ("watched", watched), ("fire", fire))
    for what, rec in runs:
        fire_launch_check(rec, what)
        check(len(rec["losses"]) == TRAIN_FIRE_STEPS
              and all(math.isfinite(x) for x in rec["losses"]),
              f"train_fire (a: {what}): losses {rec['losses']}")
    for what, rec in runs[1:]:
        check(rel_diff(rec["losses"], plain["losses"]) <= TOL_FIRE_LOSS,
              f"train_fire (a: {what}): losses {rec['losses']} vs the plain "
              f"run's {plain['losses']}")
    check(not watched["recovery"],
          f"train_fire (a): the run without faults recorded "
          f"{watched['recovery']}")
    check([(r["step"], r["attempt"]) for r in retries] == [(4, 1), (4, 2)]
          and len(fire["recovery"]) == 3,
          f"train_fire (a): records {fire['recovery']} (want the injection "
          f"and two retries at step 4, no skip)")
    # A step's record comes before its cadence save: the save of step k
    # is the latest at the record of step k + 1.
    want = [2 * ((k - 1) // 2) or None for k in range(1, TRAIN_FIRE_STEPS + 1)]
    check(fire["latest"] == want and landed == list(range(
        TRAIN_FIRE_STEPS - 4, TRAIN_FIRE_STEPS + 1, 2)),
          f"train_fire (a): checkpoints {fire['latest']}, {landed}")
    return plain["losses"]


def train_fire_leg_b_clis() -> dict:
    """train_fire (b)'s two CLI processes: sigterm@TRAIN_FIRE_SIGTERM,
    then the --resume run. Returns their exit codes and outputs and the
    saves after each."""
    from tensorflow_distributed_tpu_torch.train import checkpoint

    with tempfile.TemporaryDirectory(prefix="tfd_train_fire_") as d:
        argv = TRAIN_FIRE_ARGV + [
            "--checkpoint-dir", d, "--checkpoint-every", "100",
            "--resilience.fault-plan", f"sigterm@{TRAIN_FIRE_SIGTERM}"]
        rc1, out1 = fire_cli(argv, "b: sigterm", "train_fire")[:2]
        saved = checkpoint.available_steps(d)
        rc2, out2 = fire_cli(argv + ["--resume", "true"], "b: resumed",
                             "train_fire")[:2]
        final = checkpoint.available_steps(d)
    return {"rc1": rc1, "out1": out1, "saved": saved, "rc2": rc2,
            "out2": out2, "final": final}


def train_fire_leg_b(plain, clis=None) -> None:
    """train_fire (b): sigterm@TRAIN_FIRE_SIGTERM in a CLI process saves at
    the stopping step and exits 0; a --resume process completes the run
    on the plain run's losses (``clis``: a ``beside`` of
    train_fire_leg_b_clis; None runs the processes here)."""
    got = clis() if clis is not None else train_fire_leg_b_clis()
    rc1, out1, saved, rc2, out2, final = (
        got[k] for k in ("rc1", "out1", "saved", "rc2", "out2", "final"))
    stopped = event_record(out1, "preempted") or {}
    resumed = event_record(out2, "resumed") or {}
    first, second = step_losses(out1), step_losses(out2)
    losses = [{**first, **second}.get(k) for k in
              range(1, TRAIN_FIRE_STEPS + 1)]
    emit({"phase": "train_fire", "leg": "b: sigterm + resume",
          "exits": [rc1, rc2], "stopped_at": stopped.get("step"),
          "saved": saved, "resumed_at": resumed.get("step"), "final": final,
          "first_leg_steps": sorted(first), "resumed_steps": sorted(second),
          "max_rel_diff": (rel_diff(losses, plain)
                           if None not in losses else None)})
    check(rc1 == 0 and stopped.get("step") == TRAIN_FIRE_SIGTERM
          and saved == [TRAIN_FIRE_SIGTERM],
          f"train_fire (b): exit {rc1}, preempted {stopped}, saves {saved}")
    check(rc2 == 0 and resumed.get("step") == TRAIN_FIRE_SIGTERM
          and sorted(second) == list(range(TRAIN_FIRE_SIGTERM + 1,
                                           TRAIN_FIRE_STEPS + 1))
          and final == [TRAIN_FIRE_SIGTERM, TRAIN_FIRE_STEPS],
          f"train_fire (b): the resumed leg exited {rc2}, resumed {resumed}, "
          f"steps {sorted(second)}, saves {final}")
    check(None not in losses and rel_diff(losses, plain) <= TOL_FIRE_LOSS,
          f"train_fire (b): losses {losses} vs the plain run's {plain}")


def train_fire_leg_c() -> None:
    """train_fire (c): a stalled batch fetch past the data watchdog; the
    CLI process exits 3 while the stall still sleeps."""
    rc, out, err, t_fault, t_exit = fire_cli(TRAIN_FIRE_STALL_ARGV,
                                             "c: stall", "train_fire")
    stall = next((json.loads(l) for l in out.splitlines()
                  if l.startswith('{"event": "recovery"')
                  and '"kind": "stall"' in l), {})
    stall_to_exit = None if t_fault is None else t_exit - t_fault
    emit({"phase": "train_fire", "leg": "c: data stall",
          "argv": TRAIN_FIRE_STALL_ARGV, "exit": rc, "stall": stall,
          "stall_to_exit_s": stall_to_exit, "stall_s": TRAIN_FIRE_STALL_S,
          "timeout_s": TRAIN_FIRE_TIMEOUT_S})
    check(rc == 3 and "[resilience] stalled" in err
          and stall.get("what") == "next-batch fetch"
          and stall.get("step") == 5,
          f"train_fire (c): exit {rc}, stall record {stall}")
    check(stall_to_exit is not None and stall_to_exit < TRAIN_FIRE_STALL_S,
          f"train_fire (c): exit {stall_to_exit} s after the stall began")


def train_fire_leg_d(torch) -> None:
    """train_fire (d): the CNN on the MNIST fixture, nan_grad@5 under
    skip_batch (in this process), halt (a CLI process: exit 2) and rewind
    with a save every 2 steps (in this process). No kernel runs."""
    from tensorflow_distributed_tpu_torch.train import checkpoint

    skip = fire_train([], torch, TRAIN_FIRE_CNN_ARGV + [
        "--resilience.nonfinite", "skip_batch"])
    rc, _, err = fire_cli(TRAIN_FIRE_CNN_ARGV + [
        "--resilience.nonfinite", "halt"], "d: halt", "train_fire")[:3]
    with tempfile.TemporaryDirectory(prefix="tfd_train_fire_") as d:
        rewind = fire_train([], torch, TRAIN_FIRE_CNN_ARGV + [
            "--resilience.nonfinite", "rewind", "--checkpoint-dir", d,
            "--checkpoint-every", "2"])
        names = sorted(os.listdir(d))
        landed = checkpoint.available_steps(d)

    def kinds(rec):
        return [(r["kind"], r.get("step"), r.get("action"),
                 r.get("from_step"), r.get("to_step")) for r in rec["recovery"]]

    emit({"phase": "train_fire", "leg": "d: cnn nan_grad@5",
          "skip": {"records": kinds(skip), "final": skip["final"],
                   "loss_5": skip["losses"][4]},
          "halt_exit": rc,
          "rewind": {"records": kinds(rewind), "final": rewind["final"],
                     "dir": names, "steps": rewind["steps"]}})
    check(("nonfinite", 5, "skip", None, None) in kinds(skip)
          and math.isnan(skip["losses"][4])
          and skip["steps"] == TRAIN_FIRE_STEPS
          and math.isfinite(skip["final"].get("loss", math.nan)),
          f"train_fire (d: skip): {kinds(skip)}, {skip['final']}")
    check(rc == 2 and "[resilience] diverged" in err,
          f"train_fire (d: halt): the CLI exited {rc}, not 2")
    check(("rewind", None, None, 5, 4) in kinds(rewind)
          and ("quarantine", 6, None, None, None) in kinds(rewind)
          and "quarantined_step_00000006" in names
          and landed[-1] == TRAIN_FIRE_STEPS
          and rewind["steps"] == TRAIN_FIRE_STEPS
          and math.isfinite(rewind["final"].get("loss", math.nan)),
          f"train_fire (d: rewind): {kinds(rewind)}, {names}, "
          f"{rewind['final']}")


def phase_train_fire(kernels, torch) -> None:
    """Training under faults: the four legs of the module docstring's
    phase 34."""
    t0 = time.time()
    plain = train_fire_leg_a(kernels, torch)
    legs = {"a": round(time.time() - t0, 1)}
    t0 = time.time()
    train_fire_leg_c()
    legs["c"] = round(time.time() - t0, 1)
    # (b)'s two CLI processes run beside (d), the CNN legs: neither is
    # timed.
    t0 = time.time()
    clis = beside(train_fire_leg_b_clis)
    train_fire_leg_d(torch)
    legs["d"] = round(time.time() - t0, 1)
    train_fire_leg_b(plain, clis)
    legs["b_and_d"] = round(time.time() - t0, 1)
    emit({"phase": "train_fire", "leg_seconds": legs})


# --- the BASELINE families and their data (phases 35-40) --------------------

def phase_model_bert(fa, torch, np) -> None:
    """BERT-base (12 x 768, 12 heads, vocab 30522 + [MASK], L 512) on the
    card in bf16 through B1 non-causal against the same weights in f32 on
    the CPU: the logits of a masked-token batch."""
    from tensorflow_distributed_tpu_torch.data.lm import synthetic_mlm
    from tensorflow_distributed_tpu_torch.models.transformer import (
        bert_base_mlm)

    ref = bert_base_mlm(compute_dtype=torch.float32, dropout_rate=0.0)
    ref.init_weights(torch.Generator().manual_seed(0))
    model = bert_base_mlm(compute_dtype=torch.bfloat16, dropout_rate=0.0)
    model.load_state_dict(ref.state_dict())
    model = model.to(DEVICE)
    ds = synthetic_mlm(n=MODEL_BERT_B, seq_len=ref.cfg.max_len,
                       vocab_size=ref.cfg.vocab_size, seed=0)
    tokens = torch.from_numpy(ds.tokens).long()
    before = fa.FLASH_FWD.launches
    with torch.no_grad():
        logits = model(tokens.to(DEVICE)).cpu()
        torch.cuda.synchronize()
        launched = fa.FLASH_FWD.launches - before
        want = ref(tokens)
    err = float((logits - want).abs().max() / want.abs().max())
    emit({"phase": "model_bert", "batch": MODEL_BERT_B,
          "seq_len": ref.cfg.max_len, "vocab": ref.cfg.vocab_size,
          "embedding_rows": ref.tok_emb.weight.shape[0],
          "logits_shape": list(logits.shape), "logits_rel_err": err,
          "b1_launches": launched, "tolerance": TOL_MODEL})
    check(logits.shape == (MODEL_BERT_B, 512, 30522),
          f"model_bert: logits {tuple(logits.shape)}")
    check(launched == ref.cfg.n_layers,
          f"model_bert: B1 launched {launched} times, not once a layer")
    check(err <= TOL_MODEL, f"model_bert: logits error {err} > {TOL_MODEL}")


def flash_launch_check(rec, fused: bool, what: str) -> None:
    """B1-B3 12 times a step each (a 12-layer model: BERT-base non-causal,
    GPT-2-small causal) over the train steps (read before the final eval)
    and, fused, each CE kernel once a step; none of the ring's."""
    n, got = rec["steps"], rec["train_launches"]
    flash = all(got[k] == 12 * n for k in ("flash_fwd", "flash_dq",
                                           "flash_dkv"))
    ce = all(got[k] == (n if fused else 0) for k in CE_KERNELS)
    check(flash and ce and all(got[k] == 0 for k in RING_KERNELS),
          f"{what}: not B1-B3 12 times a step"
          f"{' and B4-B6 once' if fused else ''}: {got}")


def bert_kernel_times(fa, torch) -> dict:
    """B1-B3 non-causal at BERT-base's shape (B.H 192, L 512, D 64):
    errors against the plain versions, device ms and bounds."""
    c = BERT_KERNEL_CASE
    B, H, L, D = c["B"], c["H"], c["L"], c["D"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn((B * H, L, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, False, 0)
    dq = fa.flash_dq(q, k, v, out, lse, do, False, 0)
    dk, dv = fa.flash_dkv(q, k, v, out, lse, do, False, 0)
    f = [t.float() for t in (q, k, v, out, do)]
    ref_o, _ = fa.flash_attention_reference(f[0], f[1], f[2], False, 0)
    ref_dq = fa.flash_dq_reference(f[0], f[1], f[2], f[3], lse, f[4], False)
    ref_dk, ref_dv = fa.flash_dkv_reference(f[0], f[1], f[2], f[3], lse,
                                            f[4], False)

    def rel(a, b):
        return float((a.float() - b).abs().max() / b.abs().max())

    errs = {"o_abs_err": float((out.float() - ref_o).abs().max()),
            "dq_rel_err": rel(dq, ref_dq),
            "dkv_rel_err": max(rel(dk, ref_dk), rel(dv, ref_dv))}
    check(errs["o_abs_err"] <= TOL_O and errs["dq_rel_err"] <= TOL_GRAD
          and errs["dkv_rel_err"] <= TOL_GRAD,
          f"train_bert: B1-B3 at BERT's shape disagree: {errs}")
    dev = {}
    for name, fn in (("flash_fwd", lambda: fa.flash_fwd(q, k, v, False, 0)),
                     ("flash_dq", lambda: fa.flash_dq(q, k, v, out, lse, do,
                                                      False, 0)),
                     ("flash_dkv", lambda: fa.flash_dkv(q, k, v, out, lse,
                                                        do, False, 0))):
        dev[name] = sum(device_ms(torch, fn).values()) or None
    return {**c, **errs, "device_ms": dev,
            "bounds": kernel_bounds(fa, torch, B, H, L, D, False, 0)}


def phase_train_bert(fa, kernels, torch) -> None:
    """BERT-base masked-LM training through the port's CLI path, dense
    head then the fused CE kernels: B1-B3 non-causal at every step (and
    B4-B6 once a step, their weight the sparse MLM mask), a falling loss;
    tokens/s, masked tokens/s, step ms and peak memory; and B1-B3's own
    device times at this shape."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.tasks import make_task

    masked = float(make_task(parse_args(TRAIN_BERT_ARGV)).train_stream(
        0).__next__()["mask"].mean())
    runs = {}
    for leg, argv in (("dense", TRAIN_BERT_ARGV),
                      ("fused", TRAIN_BERT_FUSED_ARGV)):
        rec = run_train(kernels, torch, "train_bert", argv,
                        {"dense": runs["dense"]} if runs else None)
        flash_launch_check(rec, leg == "fused", f"train_bert ({leg})")
        runs[leg] = rec
    first = runs["fused"]["first_loss"], runs["dense"]["first_loss"]
    check(abs(first[0] - first[1]) <= TOL_FIRST_LOSS,
          f"train_bert: the fused leg's first loss {first[0]} vs the dense "
          f"leg's {first[1]}")
    emit({"phase": "train_bert", "summary": True,
          "masked_share_first_batch": masked,
          **{leg: {"tokens_per_s": r["tokens_per_s"],
                   "masked_tokens_per_s": r["tokens_per_s"] * masked,
                   "step_ms_median": r["step_ms_median"],
                   "peak_mem_bytes": r["peak_mem_bytes"],
                   "first_loss": r["first_loss"],
                   "last5_mean_loss": r["last5_mean_loss"],
                   "train_launches": r["train_launches"]}
             for leg, r in runs.items()},
          "kernels_at_bert_shape": bert_kernel_times(fa, torch)})


def text_corpus(path: str) -> int:
    """Write the repository's own .md and .py files (sorted by path,
    hidden and build directories left out) into one corpus at ``path``;
    returns its bytes."""
    skip = {"build", "chiprun_out", "__pycache__"}
    files = []
    for root, dirs, names in os.walk(REPO):
        dirs[:] = sorted(d for d in dirs
                         if d not in skip and not d.startswith("."))
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".md", ".py"))]
    with open(path, "wb") as out:
        for name in sorted(files):
            with open(name, "rb") as f:
                out.write(f.read())
    return os.path.getsize(path)


def text_streams_check(torch, model, prompts, streams, what: str):
    """Each text prompt's stream (ids) against generate() on ``model``:
    equal, or excused where the top-2 logit gap is under IDENTITY_GAP.
    Returns the excuses."""
    from tensorflow_distributed_tpu_torch.models.generate import generate

    excused = []
    for i, ids in enumerate(prompts):
        x = torch.tensor([ids], device=DEVICE)
        got = streams.get(i, [])
        ref = generate(model, x, TEXT_NEW)[0].tolist()
        check(len(got) == TEXT_NEW, f"{what}: request {i} got {len(got)} "
                                    f"tokens, not {TEXT_NEW}")
        why = stream_check(torch, model, ids, got, ref,
                           f"{what}: request {i}")
        if why:
            excused.append({"rid": i, **why})
    return excused


def phase_train_text(kernels, torch) -> None:
    """GPT-2-small on the byte corpus (B1-B3 at every step), then a
    --mode generate process with a text prompt and a --mode serve process
    with text requests (f32): every stream equal to generate() on the
    restored model (the top-2 gap excuse), the continuation decoded."""
    from tensorflow_distributed_tpu_torch.data.lm import text_codec

    with tempfile.TemporaryDirectory(prefix="tfd_text_") as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        size = text_corpus(corpus)
        ckpt_dir = os.path.join(tmp, "ckpt")
        data = ["--data-dir", corpus]
        rec = run_train(kernels, torch, "train_text", TRAIN_TEXT_ARGV + data
                        + ["--checkpoint-dir", ckpt_dir])
        flash_launch_check(rec, False, "train_text")
        encode, decode, vocab = text_codec(corpus)
        gen_argv = ["--mode", "generate", *TEXT_GEN_ARGV, *data,
                    "--checkpoint-dir", ckpt_dir, "--max-new-tokens",
                    str(TEXT_NEW), "--prompt", TEXT_PROMPTS[0]]
        rc, out, _, _, _ = fire_cli(gen_argv, "generate", "train_text")
        greedy = event_record(out, "generate")
        check(rc == 0 and greedy is not None,
              f"train_text: --mode generate exited {rc} without its record")
        requests = os.path.join(tmp, "requests.jsonl")
        with open(requests, "w") as f:
            for p in TEXT_PROMPTS:
                f.write(json.dumps({"text": p, "max_new_tokens": TEXT_NEW})
                        + "\n")
        serve_argv = ["--mode", "serve", *TEXT_GEN_ARGV, *data,
                      "--checkpoint-dir", ckpt_dir, "--serve.requests",
                      requests, "--serve.num-slots", "4", "--serve.stream",
                      "true"]
        rc, out, _, _, _ = fire_cli(serve_argv, "serve", "train_text")
        summary = event_record(out, "serve_summary")
        check(rc == 0 and summary is not None,
              f"train_text: --mode serve exited {rc} without its summary")
        streams = {}
        for l in out.splitlines():
            if l.startswith("[serve] rid="):
                rid, tok = l.split()[1:3]
                streams.setdefault(int(rid[4:]), []).append(int(tok[4:]))
        _, model, state = restored(torch, ["--mode", "generate",
                                           *TEXT_GEN_ARGV, *data,
                                           "--checkpoint-dir", ckpt_dir,
                                           "--prompt", "x"])
        prompts = [encode(p) for p in TEXT_PROMPTS]
        excused = text_streams_check(torch, model, prompts, streams,
                                     "train_text (serve)")
        gen_excused = text_streams_check(
            torch, model, prompts[:1], {0: greedy["new_tokens"]},
            "train_text (generate)")
    emit({"phase": "train_text", "corpus_bytes": size, "vocab": vocab,
          "tokens_per_s": rec["tokens_per_s"],
          "step_ms_median": rec["step_ms_median"],
          "peak_mem_bytes": rec["peak_mem_bytes"],
          "first_loss": rec["first_loss"],
          "last5_mean_loss": rec["last5_mean_loss"],
          "eval": rec["eval"], "generate_prompt": TEXT_PROMPTS[0],
          "generate_text": greedy.get("text"),
          "generate_excused": gen_excused,
          "serve_requests": summary["requests"],
          "serve_tokens": summary["total_new_tokens"],
          "serve_params": summary["params"],
          "serve_identical": len(prompts) - len(excused),
          "serve_excused": excused})
    check(isinstance(greedy.get("text"), str)
          and greedy["text"] == decode(greedy["new_tokens"]),
          f"train_text: generate's text {greedy.get('text')!r}")
    check(summary["params"] == "checkpoint"
          and summary["total_new_tokens"] == TEXT_NEW * len(prompts),
          f"train_text: serve summary {summary}")


def native_check(native, what: str) -> str:
    """The port's native library was built from ``native/tfd_native.cc``
    into ``build/torch_native/`` and loaded; returns its path."""
    path = native.loaded_path()
    ok = (path is not None and os.path.exists(path)
          and os.path.dirname(path) == os.path.join(REPO, "build",
                                                    "torch_native")
          and path == native.library_path()
          and native.SRC == os.path.join(REPO, "native", "tfd_native.cc"))
    check(ok, f"{what}: the native library was not built into "
              f"build/torch_native/ and loaded ({path})")
    return path


def phase_train_cnn_u8(kernels, torch) -> None:
    """The CNN on the MNIST fixture under --data-backend u8_native (the
    native threaded gather from uint8 storage) against the numpy backend:
    the library built and loaded, every batch gathered by it and equal
    bit for bit to numpy's ``src[idx] * f32(scale)``, the first losses
    within 1e-5."""
    import numpy as np

    from tensorflow_distributed_tpu_torch.native import runtime as native

    check_fixture(FIXTURE_DIR)
    gathers = []
    real = native.gather_u8_f32

    def counted(src, idx, scale, *a, **kw):
        out = real(src, idx, scale, *a, **kw)
        plain = src[idx].astype(np.float32) * np.float32(scale)
        check(out.dtype == plain.dtype and out.shape == plain.shape
              and np.array_equal(out.view(np.uint32), plain.view(np.uint32)),
              f"train_cnn_u8: native gather {len(gathers)} differs from "
              f"numpy's u8 * f32(scale) of the same rows")
        gathers.append(native.load_library() is not None)
        return out

    native.gather_u8_f32 = counted
    try:
        u8 = run_train(kernels, torch, "train_cnn_u8", TRAIN_CNN_U8_ARGV)
    finally:
        native.gather_u8_f32 = real
    path = native_check(native, "train_cnn_u8")
    plain = run_train(kernels, torch, "train_cnn_u8", [
        a if a != "u8_native" else "numpy" for a in TRAIN_CNN_U8_ARGV])
    diffs = [abs(a - b) / max(abs(b), 1e-12)
             for a, b in zip(u8["losses"], plain["losses"])]
    diff = max(diffs[:U8_STEPS_HELD])
    emit({"phase": "train_cnn_u8", "library": os.path.relpath(path, REPO),
          "native_gathers": len(gathers), "gathers_bit_exact": len(gathers),
          "steps": u8["steps"],
          "max_rel_loss_diff": diff, "steps_held": U8_STEPS_HELD,
          "max_rel_loss_diff_all_steps": max(diffs), "tolerance": TOL_U8,
          "images_per_s": u8["images_per_s"],
          "numpy_images_per_s": plain["images_per_s"],
          "step_ms_median": u8["step_ms_median"],
          "numpy_step_ms_median": plain["step_ms_median"]})
    check(len(gathers) >= u8["steps"] and all(gathers),
          f"train_cnn_u8: {len(gathers)} native gathers for "
          f"{u8['steps']} steps")
    check(diff <= TOL_U8, f"train_cnn_u8: the first {U8_STEPS_HELD} losses "
                          f"differ from the numpy backend's by {diff} > "
                          f"{TOL_U8}")


def phase_model_resnet(torch, np) -> None:
    """ResNet-50 at 224 on the card in bf16 (cuDNN) against the same
    weights in f32 on the CPU, within 5e-2: with batch statistics (train
    mode) at the weights training starts from (he_normal, zero-gamma:
    every residual branch outputs 0), and with running averages (eval)
    after the BN scales and averages are drawn at random (live residual
    branches). The bf16 train-mode error with those random scales is
    printed, not gated: batch statistics over bf16 activations amplify
    their rounding where a channel's spread is small against its mean
    (at batch 4 on the CPU, bf16 against f32: the port 12.0%, the flax
    model 11.1%). Train mode through the live branches is gated in f32:
    the card's f32 forward (TF32 off) against the CPU's, within 1e-3."""
    from tensorflow_distributed_tpu_torch.models.resnet import (
        BatchNorm, resnet50)

    ref = resnet50(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    ref.init_weights(gen)
    model = resnet50(compute_dtype=torch.bfloat16).to(DEVICE)
    size = MODEL_RESNET_IMAGE
    images = torch.from_numpy(np.random.default_rng(0).random(
        (MODEL_RESNET_B, size, size, 3), dtype=np.float32))

    def err(card, train: bool) -> float:
        card.load_state_dict(ref.state_dict())
        with torch.no_grad():
            got = card(images.to(DEVICE), train=train).cpu()
            want = ref(images, train=train)
        return float((got - want).abs().max() / want.abs().max())

    errs = {"train_at_init": err(model, True)}
    with torch.no_grad():
        for bn in ref.modules():
            if isinstance(bn, BatchNorm):
                bn.weight.uniform_(0.5, 1.5, generator=gen)
                bn.mean.normal_(0.0, 0.1, generator=gen)
                bn.var.uniform_(0.5, 1.5, generator=gen)
    errs["eval_random_bn"] = err(model, False)
    ungated = err(model, True)
    del model
    live = err(resnet50(compute_dtype=torch.float32).to(DEVICE), True)
    emit({"phase": "model_resnet", "batch": MODEL_RESNET_B, "image": size,
          "logits_rel_err": errs, "train_random_bn_rel_err": ungated,
          "tolerance": TOL_MODEL, "train_random_bn_f32_rel_err": live,
          "tolerance_f32": TOL_RESNET_F32})
    check(max(errs.values()) <= TOL_MODEL,
          f"model_resnet: ResNet-50 on the card disagrees: {errs}")
    check(live <= TOL_RESNET_F32,
          f"model_resnet: train mode through the live branches in f32 on "
          f"the card disagrees: {live} > {TOL_RESNET_F32}")


def stats_check(torch, got, want, what: str) -> None:
    """Two sets of BatchNorm running averages equal, tensor by tensor."""
    check(got.keys() == want.keys() and len(got) > 0
          and all(torch.equal(got[k].cpu(), want[k].cpu()) for k in got),
          f"{what}: batch_stats differ after the restore")


def phase_train_resnet(kernels, torch) -> None:
    """(a) ResNet-50 on imagenet_synthetic (224, 1000 classes), batch 64:
    images/s, step ms, peak memory and the traced step's conv/GEMM/other
    split; (b) ResNet-20 on cifar10_synthetic, batch 128: a falling loss,
    the final eval reading the running averages (an in-process evaluate()
    of the restored checkpoint agrees; with the averages reset it does
    not), and the restore bringing back batch_stats exactly."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import evaluate
    from tensorflow_distributed_tpu_torch.train.step import make_eval_step
    from tensorflow_distributed_tpu_torch.train.tasks import make_task

    # A throughput leg, its loss not gated to fall: it rises at these
    # settings. The port's ResNet-50 trajectory is held to JAX's on the
    # CPU only (5 steps at 32 x 32, tests/test_torch_resnet.py).
    big = run_train(kernels, torch, "train_resnet", TRAIN_RESNET50_ARGV,
                    falls=False)
    emit({"phase": "train_resnet", "run": "resnet50_profile",
          "steps": STEP_PROFILE_STEPS,
          **profiled(torch, TRAIN_RESNET50_ARGV, STEP_PROFILE_STEPS)})
    check(all(n == 0 for n in big["launches"].values()),
          f"ResNet-50 launched a kernel of the GPT: {big['launches']}")
    kept = {}
    with tempfile.TemporaryDirectory(prefix="tfd_resnet_") as tmp:
        argv = TRAIN_RESNET20_ARGV + ["--checkpoint-dir", tmp]
        small = run_train(kernels, torch, "train_resnet", argv,
                          on_result=lambda r: kept.update(
                              {k: v.detach().clone()
                               for k, v in r.state.extra.items()}))
        cfg, _, state = restored(torch, argv)
        stats_check(torch, state.extra, kept, "train_resnet")
        task = make_task(cfg)
        eval_fn = make_eval_step(task.eval_loss or task.loss)
        device = torch.device(cfg.device)
        again = evaluate(state, eval_fn, task, cfg.eval_batch_size, device)
        with torch.no_grad():
            for name, t in state.extra.items():
                t.fill_(0.0 if name.endswith(".mean") else 1.0)
        reset = evaluate(state, eval_fn, task, cfg.eval_batch_size, device)
    final = small["eval"]["loss"]
    rel = abs(again["loss"] - final) / abs(final)
    emit({"phase": "train_resnet", "run": "resnet20",
          "final_eval": small["eval"], "restored_eval": again,
          "eval_with_init_averages": reset, "eval_rel_diff": rel,
          "batch_stats_tensors": len(kept), "restored_exactly": True})
    check(rel <= TOL_EVAL_STATS,
          f"train_resnet: the restored state's eval {again['loss']} is not "
          f"the run's final eval {final}")
    check(abs(reset["loss"] - final) > 1e-3 * abs(final),
          "train_resnet: the eval does not read the running averages")


def phase_tp_kernels(fa, torch) -> None:
    """B1-B3 at the shapes a model rank gives them (``TP_KERNEL_CASES``):
    each against its plain version at phase 3's gates, then its median
    event time, profiler device time, plain time and bound."""
    for i, case in enumerate(TP_KERNEL_CASES):
        B, H, L, D = case["B"], case["H"], case["L"], case["D"]
        causal, window = case["causal"], case["window"]
        _, (q, k, v, do, out, lse) = flash_case(fa, torch, "tp_kernels",
                                                case, 100 + i)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, window),
                          lambda: fa.flash_attention_reference(
                              q, k, v, causal, window)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, out, lse, do, causal,
                                             window),
                         lambda: fa.flash_dq_reference(
                             q, k, v, out, lse, do, causal, window)),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, out, lse, do,
                                               causal, window),
                          lambda: fa.flash_dkv_reference(
                              q, k, v, out, lse, do, causal, window))}
        bounds = kernel_bounds(fa, torch, B, H, L, D, causal, window)
        emit({"phase": "tp_kernels_timing", **case, "bh": B * H,
              "ms": {n: time_ms(torch, c[0]) for n, c in calls.items()},
              "device_ms": {n: sum(device_ms(torch, c[0], 20).values())
                            or None for n, c in calls.items()},
              "plain_ms": {n: time_ms(torch, c[1], iters=5)
                           for n, c in calls.items()},
              "bound_ms": {n: b[0] for n, b in bounds.items()},
              "bound_by": {n: b[1] for n, b in bounds.items()}})
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def tp_pair(torch, M: int, **overrides):
    """GPT-2-small on ``StackedTP(M)`` (seeded init, every model rank in
    this process) and the whole model on the same weights (gathered), on
    the card in bf16, without dropout."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
    from tensorflow_distributed_tpu_torch.parallel.sharding import (
        gather_state_dict)
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        StackedTP)

    with torch.device(DEVICE):
        model = gpt_lm(TP_MODEL["size"], tp=StackedTP(M),
                       compute_dtype=torch.bfloat16, dropout_rate=0.0,
                       **overrides)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    whole = model.whole()
    with torch.no_grad():
        whole.load_state_dict(gather_state_dict(model.state_dict(), model))
    return model, whole


def phase_model_tp(fa, torch, np) -> None:
    """Each of ``TP_VARIANTS`` at M in ``TP_SIZES``: the stacked TP model
    against the whole model on the same batch, every launch count set to
    0 just before the TP model's forward and backward and read after."""
    from tensorflow_distributed_tpu_torch.ops.fused_ce import (
        fused_ce_sums_by)
    from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums
    from tensorflow_distributed_tpu_torch.parallel.sharding import (
        gather_state_dict)
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        VocabShards)

    rng = np.random.default_rng(0)
    B, L = TP_MODEL["B"], TP_MODEL["L"]
    batch = {}

    def run(m, chunk, rows=slice(None)):
        """Forward and backward of ``m`` on ``rows`` of the batch, the CE
        sum divided by the whole batch's count (halves add up)."""
        t0 = time.time()
        tokens, targets, mask = (batch[k][rows]
                                 for k in ("tokens", "targets", "mask"))
        if chunk:
            x, w, b = m(tokens, features_only=True)
            vocab = (w.vocab_size if isinstance(w, VocabShards)
                     else m.cfg.vocab_size)
            ce, _, n = fused_ce_sums_by("scan", x, w, b, targets, mask,
                                        vocab_size=vocab, chunk=chunk)
            logits = None
        else:
            out = m(tokens)
            ce, _, n = masked_ce_sums(out, targets, mask)
            logits = (out.gathered() if isinstance(out, VocabShards)
                      else out).detach()
        loss = ce / batch["mask"].sum()
        loss.backward()
        sync(torch)
        grads = {k: p.grad for k, p in m.named_parameters()}
        return float(loss.detach()), logits, grads, time.time() - t0

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))

    def grad_errs(got, ref):
        """(the whole gradient's relative error, each parameter's max
        |diff| / max |ref|: the worst and its name)."""
        diff = sum(float((got[k].float() - g.float()).pow(2).sum())
                   for k, g in ref.items())
        norm = sum(float(g.float().pow(2).sum()) for g in ref.values())
        each = {k: rel(got[k], g) for k, g in ref.items()
                if float(g.abs().max()) > 0}
        worst = max(each, key=each.get)
        return math.sqrt(diff / norm), each[worst], worst

    noise = None

    for M in TP_SIZES:
        for variant, overrides in TP_VARIANTS.items():
            chunk = overrides.get("ce_chunk", 0)
            model, whole = tp_pair(torch, M, **{
                k: v for k, v in overrides.items() if k != "ce_chunk"})
            if not batch:
                V = model.cfg.vocab_size
                batch.update({k: torch.from_numpy(v).to(DEVICE) for k, v in (
                    ("tokens", rng.integers(0, V, (B, L))),
                    ("targets", rng.integers(0, V, (B, L))),
                    ("mask", (rng.random((B, L)) < 0.9).astype(
                        np.float32)))})
            ref_loss, ref_logits, ref_grads, ref_s = run(whole, chunk)
            for kern in fa.KERNELS:
                kern.launches = 0
            loss, logits, grads, tp_s = run(model, chunk)
            launches = {kern.name: kern.launches for kern in fa.KERNELS}
            grads = gather_state_dict(grads, model)
            grad_err, worst_err, worst = grad_errs(grads, ref_grads)
            if noise is None:
                # bf16's floor: the whole model against itself, the batch
                # in two halves (other GEMM shapes, other sums).
                ref_grads = {k: g.clone() for k, g in ref_grads.items()}
                whole.zero_grad()
                run(whole, chunk, slice(0, B // 2))
                run(whole, chunk, slice(B // 2, B))
                noise = grad_errs({k: p.grad for k, p in
                                   whole.named_parameters()}, ref_grads)
            row = {"phase": "model_tp", "M": M, "variant": variant,
                   "heads_a_rank": model.cfg.n_heads // M, "loss": loss,
                   "ref_loss": ref_loss,
                   "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                   "logits_rel_err": (None if logits is None
                                      else rel(logits, ref_logits)),
                   "grads_rel_err": grad_err,
                   "worst_param_rel_err": worst_err, "worst_param": worst,
                   "bf16_floor_whole_vs_halves": {
                       "grads_rel_err": noise[0],
                       "worst_param_rel_err": noise[1],
                       "worst_param": noise[2]},
                   "launches": launches, "tp_fwd_bwd_s": round(tp_s, 4),
                   "whole_fwd_bwd_s": round(ref_s, 4), "tolerance": TOL_TP}
            emit(row)
            check(math.isfinite(loss), f"model_tp: non-finite loss {row}")
            check(row["loss_rel_err"] <= TOL_TP
                  and (logits is None or row["logits_rel_err"] <= TOL_TP)
                  and row["grads_rel_err"] <= TOL_TP,
                  f"model_tp: the TP model disagrees with the whole one: "
                  f"{row}")
            layers = model.cfg.n_layers
            check(all(n == layers * M for n in launches.values()),
                  f"model_tp: B1-B3 not launched {layers} x {M} times: "
                  f"{launches}")
            del model, whole, grads, ref_grads, logits, ref_logits
            torch.cuda.empty_cache()


def train_tp_runs(count: int):
    """train_tp's legs for ``count`` cards: (name, processes, argv, the
    one-card argv on the same global batch)."""
    M = 4 if count >= 4 else 2
    vp = ["--shard-vocab", "true", "--ce-chunk", "8192"]
    runs = [(f"model{M}", M, TRAIN_TP_ARGV + ["--mesh.model", str(M)],
             TRAIN_TP_ARGV),
            (f"model{M}_shard_vocab", M,
             TRAIN_TP_ARGV + vp + ["--mesh.model", str(M)],
             TRAIN_TP_ARGV + vp)]
    if count >= 4:
        runs.append(("data2_model2_shard_vocab", 4,
                     TRAIN_TP_ARGV + vp + ["--mesh.data", "2",
                                           "--mesh.model", "2"],
                     TRAIN_TP_ARGV + vp))
    return runs


def phase_train_tp(torch) -> None:
    """--mesh.model M over torchrun's processes (NCCL); skipped, by the
    device count alone, on one card (the stacked phases carry the kernel
    evidence there)."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "train_tp",
              "skipped": f"needs >= 2 CUDA devices, have {count}"})
        return
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    for name, nproc, argv, one_argv in train_tp_runs(count):
        wall, ranks, _ = run_torchrun(f"train_tp {name}", nproc, argv,
                                      TRAIN_TP_TIMEOUT_S)
        one, one_sps = one_card_losses(one_argv)
        sps = ranks[0]["steps_per_sec"]
        tokens = 8 * 1024
        emit({"phase": "train_tp", "run": name, "processes": nproc,
              "argv": argv, "wall_s": round(wall, 3),
              "losses": ranks[0]["losses"][:5], "one_card_losses": one[:5],
              "max_loss_diff": max(abs(a - b) for r in ranks
                                   for a, b in zip(r["losses"][:5], one)),
              "step_ms": 1e3 / sps if sps else None,
              "tokens_per_s_per_card": sps * tokens / nproc,
              "one_card_step_ms": 1e3 / one_sps if one_sps else None,
              "one_card_tokens_per_s": one_sps * tokens,
              "launches_per_rank": [{k: r["launches"][k] for k in flash}
                                    for r in ranks]})
        for r in ranks:
            check(len(r["losses"]) == TRAIN_TP_STEPS and all(
                abs(a - b) <= TOL_RING_LOSS
                for a, b in zip(r["losses"][:5], one)),
                f"train_tp {name}: losses {r['losses']} vs one card {one}")
            check(all(r["launches"][k] > 0 for k in flash),
                  f"train_tp {name}: a rank did not launch B1-B3: "
                  f"{r['launches']}")


def zero_predicted(kind: str, D: int) -> dict:
    """The predicted bytes a data rank holds between steps under
    ``kind`` at D data ranks (params, synced gradient, Adam's two
    slots)."""
    whole = ZERO_CUT_BYTES + ZERO_WHOLE_BYTES
    cut = ZERO_CUT_BYTES // D + ZERO_WHOLE_BYTES
    return {"params": cut if kind == "fsdp" else whole,
            "grads": cut if kind == "fsdp" else whole,
            "slots": 2 * (whole if kind == "replicated" else cut)}


def whole_tensors(state):
    """A state's params, Adam slots and EMA as whole tensors (copies)."""
    from tensorflow_distributed_tpu_torch.train.checkpoint import whole_state

    with whole_state(state) as w:
        out = {f"params/{n}": p.detach().clone()
               for n, p in w.params.items()}
        for slot in ("mu", "nu"):
            out.update((f"{slot}/{n}", t.clone())
                       for n, t in w.opt_state[slot].items())
        out.update((f"ema/{n}", t.clone()) for n, t in w.ema.items())
    return out


def zero_leg(kernels, torch, D: int, name: str, extra):
    """One leg of model_zero: ``ZERO_STEPS`` steps of the stacked
    transport of D data ranks (the serial and overlap legs' second step
    NaN-poisoned), every launch count set to 0 just before the steps and
    read just after. Returns (record, whole tensors)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.data.prefetch import to_device
    from tensorflow_distributed_tpu_torch.train.loop import build_stacked

    cfg = parse_args(MODEL_ZERO_ARGV + ["--mesh.data", str(D)] + extra)
    task, state, step = build_stacked(cfg, torch.device(DEVICE),
                                      ZERO_MIN_SIZE)
    stream = task.train_stream(0)
    batches = [to_device(next(stream), torch.device(DEVICE))
               for _ in range(ZERO_STEPS)]
    poison = bool(SKIP_NAN[0] in extra)
    if poison:
        batches[1] = dict(batches[1], mask=batches[1]["mask"] * math.nan)
    sync(torch)
    for kern in kernels:
        kern.launches = 0
    t0 = time.time()
    losses, skipped = [], []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        skipped.append(float(metrics.get("skipped_nonfinite", 0.0)))
    sync(torch)
    rec = {"phase": "model_zero", "D": D, "leg": name, "argv": extra,
           "losses": losses, "skipped": skipped,
           "steps_s": round(time.time() - t0, 3),
           "launches": {kern.name: kern.launches for kern in kernels},
           "resident_bytes_a_rank": state.partition.resident_bytes(
               state.params, slots=2),
           "predicted_bytes_a_rank": zero_predicted(
               cfg.param_partition, D),
           "blocked_leaves": len(state.partition.blocked)}
    if hasattr(step, "bucket_plan"):
        rec["plan"] = step.bucket_plan.describe()
    tensors = whole_tensors(state)
    del state, step, batches
    torch.cuda.empty_cache()
    return rec, tensors


def phase_model_zero(kernels, torch) -> None:
    """ZeRO-1, FSDP and the explicit sync on the stacked transport (see
    the module docstring, phase 44)."""
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    for D in ZERO_SIZES:
        recs, whole = {}, {}
        for name, extra in ZERO_LEGS.items():
            recs[name], tensors = zero_leg(kernels, torch, D, name, extra)
            if name in ("replicated", "serial"):
                whole[name] = tensors
            rec = recs[name]
            if name in ("zero1", "fsdp"):
                ref = recs["replicated"]["losses"]
                rec["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                          zip(rec["losses"], ref))
                worst = max(
                    (float(((t - whole["replicated"][k]).abs()
                            - TOL_ZERO_PARAMS["rtol"]
                            * whole["replicated"][k].abs()).max()), k)
                    for k, t in tensors.items() if k.startswith("params/"))
                rec["params_excess_over_tol"] = worst
            if name == "overlap":
                ref = whole["serial"]
                rec["bit_identical_to_serial"] = {
                    part: all(torch.equal(t, ref[k]) for k, t in
                              tensors.items() if k.startswith(part + "/"))
                    for part in ("params", "mu", "nu", "ema")}
            emit(rec)
            check(all(math.isfinite(x) for i, x in enumerate(rec["losses"])
                      if not (i == 1 and rec["skipped"][1])),
                  f"model_zero: non-finite loss {rec}")
            check(all(rec["launches"][k] == 12 * D * ZERO_STEPS
                      for k in flash),
                  f"model_zero {name} D {D}: B1-B3 not launched 12 x {D} "
                  f"times a step: {rec['launches']}")
            if name in ("serial", "overlap"):
                check(rec["skipped"] == [0.0, 1.0, 0.0],
                      f"model_zero {name}: the poisoned step was not "
                      f"skipped: {rec['skipped']}")
            if name in ("zero1", "fsdp"):
                check(rec["loss_rel_err"] <= TOL_ZERO_LOSS
                      and rec["params_excess_over_tol"][0]
                      <= TOL_ZERO_PARAMS["atol"],
                      f"model_zero {name} D {D}: disagrees with replicated: "
                      f"{rec}")
            if name == "overlap":
                check(all(rec["bit_identical_to_serial"].values()),
                      f"model_zero D {D}: overlap is not bit-identical to "
                      f"serial: {rec['bit_identical_to_serial']}")
            del tensors
        del whole
        torch.cuda.empty_cache()
    rec, _ = zero_leg(kernels, torch, ZERO_SIZES[0], "zero1_fused",
                      ZERO_FUSED)
    emit(rec)
    ce = ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")
    check(all(rec["launches"][k] == ZERO_SIZES[0] * ZERO_STEPS for k in ce)
          and all(math.isfinite(x) for x in rec["losses"]),
          f"model_zero zero1_fused: B4-B6 not launched once a rank a step, "
          f"or a non-finite loss: {rec}")


def train_zero_runs(count: int):
    """train_zero's legs for ``count`` cards: (name, processes, argv)."""
    D = min(count, 4)
    mesh = ["--mesh.data", str(D)]
    runs = [("zero1", D, mesh + ["--param-partition", "zero1"]),
            ("fsdp", D, mesh + ["--param-partition", "fsdp"]),
            ("serial", D, mesh + ["--grad-sync", "serial"]),
            ("overlap", D, mesh + ["--param-partition", "zero1",
                                   "--grad-sync", "overlap"])]
    if count >= 4:
        runs.append(("data2_model2_fsdp", 4,
                     ["--mesh.data", "2", "--mesh.model", "2",
                      "--param-partition", "fsdp"]))
    return [(name, n, TRAIN_ZERO_ARGV + argv) for name, n, argv in runs]


def phase_train_zero(torch) -> None:
    """--param-partition and --grad-sync over torchrun's processes
    (NCCL); skipped, by the device count alone, on one card (model_zero
    carries the kernel evidence there)."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "train_zero",
              "skipped": f"needs >= 2 CUDA devices, have {count}"})
        return
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    one, one_sps = one_card_losses(TRAIN_ZERO_ARGV)
    tokens = 8 * 1024
    legs = {}
    for name, nproc, argv in train_zero_runs(count):
        wall, ranks, _ = run_torchrun(f"train_zero {name}", nproc, argv,
                                      TRAIN_ZERO_TIMEOUT_S)
        sps = ranks[0]["steps_per_sec"]
        legs[name] = ranks[0]["losses"]
        rec = {"phase": "train_zero", "run": name, "processes": nproc,
               "argv": argv, "wall_s": round(wall, 3),
               "losses": ranks[0]["losses"][:5], "one_card_losses": one[:5],
               "max_loss_diff": max(abs(a - b) for r in ranks
                                    for a, b in zip(r["losses"][:5], one)),
               "step_ms": 1e3 / sps if sps else None,
               "tokens_per_s_per_card": sps * tokens / nproc,
               "one_card_step_ms": 1e3 / one_sps if one_sps else None,
               "max_memory_allocated_per_rank": [
                   r["max_memory_allocated"] for r in ranks],
               "launches_per_rank": [{k: r["launches"][k] for k in flash}
                                     for r in ranks]}
        if name == "overlap":
            rec["serial_losses"] = legs["serial"][:5]
            rec["max_diff_to_serial"] = max(
                abs(a - b) for a, b in zip(legs["serial"], legs["overlap"]))
        emit(rec)
        for r in ranks:
            check(len(r["losses"]) == TRAIN_TP_STEPS and all(
                abs(a - b) <= TOL_RING_LOSS
                for a, b in zip(r["losses"][:5], one)),
                f"train_zero {name}: losses {r['losses']} vs one card {one}")
            check(all(r["launches"][k] > 0 for k in flash),
                  f"train_zero {name}: a rank did not launch B1-B3: "
                  f"{r['launches']}")


def moe_model(torch, dtype, device=None, tp=None, **overrides):
    """``moe_lm`` at MOE_MODEL's widths on ``device`` (the card), fresh
    from seed 0, without dropout; on ``tp`` (a ``StackedTP``) its
    attention is cut over the model ranks and its experts with it."""
    from tensorflow_distributed_tpu_torch.models.transformer import moe_lm

    device = device or DEVICE
    with torch.device(device):
        model = moe_lm(MOE_MODEL["size"], tp=tp,
                       moe_experts=MOE_MODEL["experts"], compute_dtype=dtype,
                       dropout_rate=0.0, **overrides)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    return model


def record_routes(model, store: list, pin=None) -> None:
    """Wrap each MoE layer's ``route`` so that every call appends its
    (top-k expert ids [G, S, K], positions [G, S, K], kept flags) to
    ``store``, on the host. With ``pin`` (another run's store, in call
    order) each call routes to that run's expert ids (``route``'s
    ``picks``: positions, kept slots and gates follow from them by the
    layer's own code); what the model chose itself is what ``store``
    gets. Pinned, two models' outputs differ only by their arithmetic,
    not by a near-tie that bf16 rounding tipped the other way."""
    import torch

    pins = None if pin is None else iter(pin)
    for layer in model.moe_layers():
        def route(x, inner=layer.route):
            out = inner(x)
            masks, pos, _, withins, _ = out
            store.append((torch.stack([m.argmax(-1) for m in masks], -1)
                          .cpu(), torch.stack(pos, -1).cpu(),
                          torch.stack(withins, -1).cpu()))
            if pins is None:
                return out
            return inner(x, next(pins)[0].to(x.device))

        layer.route = route


def routing_agreement(got: list, ref: list, rows=None) -> float:
    """The share of (token, k) slots, over every layer, routed to the
    same expert in two runs' ``record_routes`` stores (``rows``: the
    groups of ``got`` to hold against ``ref``'s first ones)."""
    same = total = 0
    for (ids, _, _), (ref_ids, _, _) in zip(got, ref):
        if rows is not None:
            ids = ids[rows]
        ref_ids = ref_ids[:ids.shape[0]]
        same += int((ids == ref_ids).sum())
        total += ids.numel()
    return same / max(total, 1)


def moe_batch(torch, np, vocab: int):
    rng = np.random.default_rng(0)
    B, L = MOE_MODEL["B"], MOE_MODEL["L"]
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in (
        ("tokens", rng.integers(0, vocab, (B, L))),
        ("targets", rng.integers(0, vocab, (B, L))),
        ("mask", (rng.random((B, L)) < 0.9).astype(np.float32)))}


def moe_run(torch, model, batch, backward=True, rows=slice(None)):
    """The MoE objective (CE + 0.01 x load balance) of ``model`` on
    ``rows`` of ``batch``, with its backward: (loss, logits, grads,
    router metrics, seconds)."""
    from tensorflow_distributed_tpu_torch.models.moe import moe_objective
    from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        VocabShards)

    t0 = time.time()
    tokens, targets, mask = (batch[k][rows].to(next(model.parameters())
                                               .device)
                             for k in ("tokens", "targets", "mask"))
    auxes = []
    with torch.set_grad_enabled(backward):
        out = model(tokens, moe_aux=auxes)
        ce, _, n = masked_ce_sums(out, targets, mask)
        lb, _, metrics = moe_objective(auxes)
        loss = ce / n + 0.01 * lb
    if backward:
        loss.backward()
    if tokens.is_cuda:
        sync(torch)
    logits = (out.gathered() if isinstance(out, VocabShards) else out)
    grads = ({k: p.grad for k, p in model.named_parameters()}
             if backward else None)
    return (float(loss.detach()), logits.detach(), grads,
            {k: float(v) for k, v in metrics.items()}, time.time() - t0)


def phase_model_moe(fa, torch, np) -> None:
    """The MoE cell's model on the card (module docstring, phase 46).
    The stacked legs route as the whole model did (``record_routes``'s
    pin) for their gates, and print the share of slots they would have
    routed alike on their own."""
    from tensorflow_distributed_tpu_torch.parallel.sharding import (
        gather_state_dict)
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        StackedTP)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))

    whole = moe_model(torch, torch.bfloat16)
    params = sum(p.numel() for p in whole.parameters())
    check(params == MOE_PARAMS or MOE_MODEL["size"] != "small",
          f"model_moe: {params} params, want {MOE_PARAMS}")
    batch = moe_batch(torch, np, whole.cfg.vocab_size)
    layers = len(whole.moe_layers())
    capacity = whole.layer_0.moe_mlp.capacity(MOE_MODEL["L"])
    # dense against scatter dispatch, forward only
    store = []
    record_routes(whole, store)
    _, dense_logits, _, dense_aux, dense_s = moe_run(torch, whole, batch,
                                                     backward=False)
    dense_routes = store[:]
    store.clear()
    for layer in whole.moe_layers():
        layer.dispatch = "scatter"
    _, scatter_logits, _, scatter_aux, scatter_s = moe_run(
        torch, whole, batch, backward=False)
    scatter_routes = store[:]
    store.clear()
    for layer in whole.moe_layers():
        layer.dispatch = "dense"
    first = all(torch.equal(a, b) for a, b in zip(dense_routes[0],
                                                   scatter_routes[0]))
    row = {"phase": "model_moe", "leg": "dispatch", "params": params,
           "layers": layers, "capacity": capacity,
           "first_layer_routing_identical": first,
           "routing_agreement": routing_agreement(scatter_routes,
                                                  dense_routes),
           "logits_rel_err": rel(scatter_logits, dense_logits),
           "dense_router": dense_aux, "scatter_router": scatter_aux,
           "dense_fwd_s": round(dense_s, 4),
           "scatter_fwd_s": round(scatter_s, 4),
           "tolerance": TOL_MOE_LOGITS}
    emit(row)
    check(first and row["logits_rel_err"] <= TOL_MOE_LOGITS,
          f"model_moe: scatter dispatch disagrees with dense: {row}")
    del scatter_logits, dense_logits
    # the whole model's objective, forward and backward (the reference)
    ref_loss, ref_logits, ref_grads, ref_aux, ref_s = moe_run(torch, whole,
                                                              batch)
    routes = store[:]
    store.clear()
    for X in MOE_EP_SIZES:
        model = moe_model(torch, torch.bfloat16, tp=StackedTP(X))
        state = gather_state_dict(model.state_dict(), model)
        check(all(torch.equal(state[k], v)
                  for k, v in whole.state_dict().items()),
              f"model_moe: the X {X} model's init is not the whole one's")
        ep_routes = []
        record_routes(model, ep_routes, pin=routes)
        for kern in fa.KERNELS:
            kern.launches = 0
        loss, logits, grads, aux, ep_s = moe_run(torch, model, batch)
        launches = {kern.name: kern.launches for kern in fa.KERNELS}
        grads = gather_state_dict(grads, model)
        diff = sum(float((grads[k].float() - g.float()).pow(2).sum())
                   for k, g in ref_grads.items())
        norm = sum(float(g.float().pow(2).sum()) for g in ref_grads.values())
        row = {"phase": "model_moe", "leg": "stacked_ep", "X": X,
               "experts_a_rank": MOE_MODEL["experts"] // X,
               "heads_a_rank": model.cfg.n_heads // X, "loss": loss,
               "ref_loss": ref_loss,
               "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
               "logits_rel_err": rel(logits, ref_logits),
               "grads_rel_err": math.sqrt(diff / norm),
               "routing_pinned_to_whole": True,
               "routing_agreement": routing_agreement(ep_routes, routes),
               "router": aux, "ref_router": ref_aux, "launches": launches,
               "ep_fwd_bwd_s": round(ep_s, 4),
               "whole_fwd_bwd_s": round(ref_s, 4),
               "tolerance": {"loss": TOL_MOE_LOSS, "logits_grads": TOL_TP,
                             "routing_floor": MOE_ROUTING_FLOOR}}
        emit(row)
        check(row["loss_rel_err"] <= TOL_MOE_LOSS
              and row["logits_rel_err"] <= TOL_TP
              and row["grads_rel_err"] <= TOL_TP
              and row["routing_agreement"] >= MOE_ROUTING_FLOOR,
              f"model_moe: the stacked EP model disagrees with the whole "
              f"one: {row}")
        check(all(n == layers * X for n in launches.values()),
              f"model_moe: B1-B3 not launched {layers} x {X} times: "
              f"{launches}")
        del model, grads, logits, state
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    del ref_grads, ref_logits
    whole.zero_grad(set_to_none=True)
    # the f32 plain model on the CPU, on the first rows (not gated)
    rows = slice(0, MOE_CPU_ROWS)
    card_loss = moe_run(torch, whole, batch, backward=False, rows=rows)[0]
    t0 = time.time()
    with torch.device("cpu"):
        plain = type(whole)(dataclasses.replace(
            whole.cfg, compute_dtype=torch.float32, moe_dispatch="scatter"))
    plain.load_state_dict({k: v.cpu() for k, v in whole.state_dict().items()})
    cpu_routes = []
    record_routes(plain, cpu_routes)
    cpu_loss = moe_run(torch, plain, batch, backward=False, rows=rows)[0]
    emit({"phase": "model_moe", "leg": "f32_plain_cpu", "rows": MOE_CPU_ROWS,
          "routing_agreement": routing_agreement(
              [tuple(t[rows] for t in r) for r in routes], cpu_routes),
          "card_loss": card_loss, "cpu_f32_loss": cpu_loss,
          "loss_diff": card_loss - cpu_loss,
          "cpu_s": round(time.time() - t0, 3)})
    del whole, plain
    if DEVICE != "cpu":
        torch.cuda.empty_cache()


def moe_record_check(records, what: str) -> dict:
    """The router metrics of every step record, checked finite; returns
    the last record's."""
    for r in records:
        check(all(math.isfinite(r.metrics.get(k, math.nan))
                  for k in MOE_METRICS),
              f"{what}: a router metric is missing or not finite: "
              f"{r.metrics}")
    return {k: records[-1].metrics[k] for k in MOE_METRICS}


def phase_train_moe(kernels, torch) -> None:
    """The MoE cell trained 20 steps in each of MOE_LEGS (phase 47)."""
    for leg, extra in MOE_LEGS.items():
        got = {}

        def keep(result, got=got):
            got["records"] = [r for r in result.logger.records
                              if "loss" in r.metrics]

        rec = run_train(kernels, torch, "train_moe", TRAIN_MOE_ARGV + extra,
                        on_result=keep)
        router = moe_record_check(got["records"], f"train_moe {leg}")
        t = rec["train_launches"]
        n = 12 * rec["steps"]
        fused = "--ce-chunk" in extra
        emit({"phase": "train_moe", "leg": leg,
              "step_ms_median": rec["step_ms_median"],
              "tokens_per_s": rec["tokens_per_s"],
              "train_peak_mem_bytes": rec["train_peak_mem_bytes"],
              "first_loss": rec["first_loss"],
              "last5_mean_loss": rec["last5_mean_loss"],
              "router_last_step": router, "train_launches": t})
        check(t["flash_dq"] == n and t["flash_dkv"] == n
              and t["flash_fwd"] == n,
              f"train_moe {leg}: B1-B3 not launched 12 times a step: {t}")
        check(all(t[k] == (rec["steps"] if fused else 0)
                  for k in CE_KERNELS),
              f"train_moe {leg}: the CE kernels' launches: {t}")


def phase_serve_moe(torch, np) -> None:
    """The MoE cell's model on the dense engine (phase 48)."""
    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.models.transformer import (
        cast_dense_weights_)
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets, pick_bucket)
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)

    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        model = moe_model(torch, dtype)
        if dtype != torch.float32:
            cast_dense_weights_(model)
        prompts = [rng.integers(0, model.cfg.vocab_size, n)
                   for n in MOE_SERVE_PROMPTS]
        ladder = default_buckets(max(MOE_SERVE_PROMPTS), cap=model.cfg.max_len)
        engine = SlotDecodeEngine(model, MOE_SERVE_SLOTS, buckets=ladder)
        engine.warmup()
        t0 = time.time()
        done = {c.rid: c for c in Scheduler(engine, decode_priority=4).run(
            [Request(rid=i, prompt=p, max_new_tokens=MOE_SERVE_NEW)
             for i, p in enumerate(prompts)])}
        wall = time.time() - t0
        delivered = sum(len(c.tokens) for c in done.values())
        row = {"phase": "serve_moe", "dtype": str(dtype).split(".")[-1],
               "requests": len(prompts), "tokens": delivered,
               "tokens_per_s": delivered / wall, "wall_s": round(wall, 3),
               "decode_steps": engine.decode_steps,
               "prefills": engine.prefills, "ladder": list(engine.buckets)}
        check(delivered == len(prompts) * MOE_SERVE_NEW
              and all(len(c.tokens) == MOE_SERVE_NEW for c in done.values()),
              f"serve_moe: not every token was delivered: {row}")
        if dtype == torch.float32:
            aligned, others, excused = [], [], []
            for i, p in enumerate(prompts):
                ref = generate(model, torch.from_numpy(p).to(DEVICE)[None],
                               MOE_SERVE_NEW)[0].tolist()
                j = first_mismatch(done[i].tokens, ref)
                fills = pick_bucket(len(p), engine.buckets) == len(p)
                (aligned if fills else others).append(j is None)
                if fills and j is not None:
                    gap = top2_gap(torch, model, p, ref, j)
                    excused.append({"rid": i, "prompt_len": len(p),
                                    "step": j, "top2_gap": gap})
                    check(gap < IDENTITY_GAP,
                          f"serve_moe: request {i} (prompt {len(p)}, its "
                          f"bucket's length) differs from generate() at "
                          f"step {j}, where the top-2 gap is {gap}")
            row.update(bucket_filled=len(aligned),
                       bucket_filled_identical=sum(aligned),
                       excused=excused, padded=len(others),
                       padded_identical=sum(others))
        emit(row)
        del model, engine
        if DEVICE != "cpu":
            torch.cuda.empty_cache()


def train_ep_runs():
    """train_ep's legs: (name, processes, argv), each on four cards."""
    return [("expert4", 4, TRAIN_EP_ARGV + ["--mesh.expert", "4"]),
            ("model4", 4, TRAIN_EP_ARGV + ["--mesh.model", "4"]),
            ("data2_expert2", 4, TRAIN_EP_ARGV + ["--mesh.data", "2",
                                                  "--mesh.expert", "2"])]


def phase_train_ep(torch) -> None:
    """Expert parallelism under torchrun (NCCL, four cards; phase 49);
    skipped, by the device count alone, on fewer. Every run is emitted
    before any is checked."""
    count = torch.cuda.device_count()
    if count < 4:
        emit({"phase": "train_ep",
              "skipped": f"needs >= 4 CUDA devices, have {count}"})
        return
    whole, one_sps = one_card_metrics(TRAIN_EP_ARGV)
    one = [m["loss"] for m in whole]
    one_norm = whole[0]["grad_norm"]
    tokens = MOE_MODEL["B"] * MOE_MODEL["L"]
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    results = []
    for name, nproc, argv in train_ep_runs():
        wall, ranks, _ = run_torchrun(f"train_ep {name}", nproc, argv,
                                      TRAIN_EP_TIMEOUT_S)
        held = TRAIN_EP_MODEL_LOSSES if "--mesh.model" in argv else 5
        sps = ranks[0]["steps_per_sec"]
        emit({"phase": "train_ep", "run": name, "processes": nproc,
              "argv": argv, "wall_s": round(wall, 3),
              "losses": ranks[0]["losses"][:5], "one_card_losses": one[:5],
              "loss_diffs": [max(abs(r["losses"][i] - one[i]) for r in ranks)
                             for i in range(5)],
              "losses_held": held, "tolerance": TOL_RING_LOSS,
              "first_grad_norm": ranks[0]["grad_norms"][0],
              "one_card_first_grad_norm": one_norm,
              "step_ms": 1e3 / sps if sps else None,
              "tokens_per_s_per_card": sps * tokens / nproc,
              "one_card_step_ms": 1e3 / one_sps if one_sps else None,
              "one_card_tokens_per_s": one_sps * tokens,
              "peak_mem_bytes_per_rank": [r["max_memory_allocated"]
                                          for r in ranks],
              "launches_per_rank": [{k: r["launches"][k] for k in flash}
                                    for r in ranks]})
        results.append((name, ranks, held))
    for name, ranks, held in results:
        for r in ranks:
            check(len(r["losses"]) == TRAIN_EP_STEPS and all(
                abs(a - b) <= TOL_RING_LOSS
                for a, b in zip(r["losses"][:held], one)),
                f"train_ep {name}: the first {held} losses {r['losses']} "
                f"vs one card {one}")
            check(abs(r["grad_norms"][0] - one_norm)
                  <= TOL_RING_LOSS * one_norm,
                  f"train_ep {name}: first grad norm {r['grad_norms'][0]} "
                  f"vs one card {one_norm}")
            check(all(r["launches"][k] > 0 for k in flash),
                  f"train_ep {name}: a rank did not launch B1-B3: "
                  f"{r['launches']}")


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in f32."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def grad_errs(got, ref):
    """(the whole gradient's relative error ||got - ref|| / ||ref|| over
    every parameter, each parameter's ``rel_err``: the worst and its
    name)."""
    diff = sum(float((got[k].float() - g.float()).pow(2).sum())
               for k, g in ref.items())
    norm = sum(float(g.float().pow(2).sum()) for g in ref.values())
    each = {k: rel_err(got[k], g) for k, g in ref.items()
            if float(g.abs().max()) > 0}
    worst = max(each, key=each.get)
    return math.sqrt(diff / norm), each[worst], worst


def masked_loss(m, batch, rows=slice(None)):
    """Forward and backward of ``m`` on ``rows`` of ``batch`` (tokens,
    targets, mask): the masked CE sum over the whole batch's count, so
    that the losses and gradients of a batch's parts add up to the
    whole's. (loss, logits)."""
    from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums

    out = m(batch["tokens"][rows])
    ce, _, _ = masked_ce_sums(out, batch["targets"][rows],
                              batch["mask"][rows])
    loss = ce / batch["mask"].sum()
    loss.backward()
    return float(loss.detach()), out.detach()


def by_microbatch(torch, m, batch, M: int):
    """``m`` over ``batch``'s M microbatches in turn, their gradients
    accumulated: GPipe's bf16 products, a microbatch at a time (the
    oracle of the pipe phases' gates). (loss, logits, grads)."""
    B = batch["tokens"].shape[0]
    m.zero_grad(set_to_none=True)
    outs = [masked_loss(m, batch, slice(i * (B // M), (i + 1) * (B // M)))
            for i in range(M)]
    grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    return (sum(o[0] for o in outs), torch.cat([o[1] for o in outs]),
            grads)


_WHOLE_TREE: dict = {}  # model_pipe's whole model as a flax tree


def pipe_models(torch, whole, S: int, M: int, V: int = 1):
    """GPT-2-small (``PIPE_MODEL``) as ``pipelined_lm`` on
    ``StackedPipe(S)`` with M microbatches and V virtual stages, its
    weights the whole model's carried through ``interop`` (the gpt_lm
    tree stacked into JAX's pipelined tree, then this model's part of
    it), in bf16 without dropout."""
    from tensorflow_distributed_tpu_torch import interop
    from tensorflow_distributed_tpu_torch.models.pipelined import (
        pipelined_lm)
    from tensorflow_distributed_tpu_torch.parallel.mesh import StackedPipe

    with torch.device(DEVICE):
        model = pipelined_lm(PIPE_MODEL["size"], pipe=StackedPipe(S),
                             num_microbatches=M, virtual_stages=V,
                             compute_dtype=torch.bfloat16, dropout_rate=0.0,
                             n_layers=whole.cfg.n_layers,
                             max_len=whole.cfg.max_len)
    if "tree" not in _WHOLE_TREE:
        _WHOLE_TREE["tree"] = interop.params_to_flax(
            dict(whole.named_parameters()), whole)
    tree = interop.layers_to_pipelined(_WHOLE_TREE["tree"], S, V)
    with torch.no_grad():
        model.load_state_dict(interop.shards_from_flax(tree, model))
    return model


def pipe_1f1b(torch, model, batch, backward: str):
    """One 1F1B schedule of ``model`` over ``batch`` (the dense head's
    masked CE at the last stage, the mean over the batch's mask), the
    embedding's backward from stage 0's cotangent: (loss, grads)."""
    from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums
    from tensorflow_distributed_tpu_torch.parallel.pipeline import (
        interleaved_pipeline_value_and_grad, pipeline_value_and_grad)

    def last_fn(y, aux):
        tgt, msk = aux
        ce, correct, n = masked_ce_sums(model.head(y), tgt, msk)
        return ce, {"correct": correct, "mask": n}

    total = batch["mask"].sum()
    x = model.embed(batch["tokens"])
    stage_fn = model.make_stage_fn(train=True, seed=None)
    args = (stage_fn, last_fn, x, (batch["targets"], batch["mask"]),
            model.pipe, model.num_microbatches)
    if model.virtual_stages > 1:
        val, _, _, d_x = interleaved_pipeline_value_and_grad(
            *args, model.virtual_stages, cotangent_scale=1.0 / total)
    else:
        val, _, _, d_x = pipeline_value_and_grad(
            *args, cotangent_scale=1.0 / total, backward=backward)
    x.backward(d_x)
    return float(val / total), {k: p.grad for k, p in
                                model.named_parameters()}


def phase_model_pipe(fa, torch, np) -> None:
    """GPT-2-small as ``pipelined_lm`` on ``StackedPipe(S)`` at each (S,
    M) of ``PIPE_CASES``: GPipe against the whole model run over the same
    M microbatches (its gradients accumulated: the same bf16 products;
    against the whole batch at once, and the whole model's own floor on
    two halves, printed), then 1F1B
    (recompute, stash; at S ``PIPE_V2_STAGES`` the interleaved schedule
    over 2 virtual stages) against GPipe, every launch count set to 0
    just before each schedule's forward and backward and read after;
    at M 8 each schedule's peak memory. Returns the launch counts by
    leg."""
    from tensorflow_distributed_tpu_torch.models.pipelined import (
        PIPELINED_TINY_LAYERS)
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    rng = np.random.default_rng(0)
    B, L = PIPE_MODEL["B"], PIPE_MODEL["L"]
    layers = {} if PIPE_MODEL["size"] != "tiny" else {
        "n_layers": PIPELINED_TINY_LAYERS, "max_len": L}
    with torch.device(DEVICE):
        whole = gpt_lm(PIPE_MODEL["size"], compute_dtype=torch.bfloat16,
                       dropout_rate=0.0, **layers)
    whole.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    V_ = whole.cfg.vocab_size
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in (
        ("tokens", rng.integers(0, V_, (B, L))),
        ("targets", rng.integers(0, V_, (B, L))),
        ("mask", (rng.random((B, L)) < 0.9).astype(np.float32)))}

    def dense(m, rows=slice(None)):
        return masked_loss(m, batch, rows)

    def grads_of(m):
        return {k: p.grad.detach().clone() for k, p in m.named_parameters()}

    def counted(fn):
        """``fn()`` with every launch count set to 0 just before and
        read after, and (on the card) the peak memory of its run."""
        sync(torch)
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        for kern in fa.KERNELS:
            kern.launches = 0
        before = (torch.cuda.memory_allocated() if DEVICE != "cpu"
                  else None)
        t0 = time.time()
        out = fn()
        sync(torch)
        peak = (torch.cuda.max_memory_allocated() if DEVICE != "cpu"
                else None)
        return out, {kern.name: kern.launches for kern in fa.KERNELS}, \
            (peak, before), time.time() - t0

    ref_loss, ref_logits = dense(whole)
    ref_grads = grads_of(whole)
    whole.zero_grad(set_to_none=True)
    halves = by_microbatch(torch, whole, batch, 2)[2]
    noise = grad_errs(halves, ref_grads)
    refs = {M: by_microbatch(torch, whole, batch, M)
            for M in sorted({M for _, M in PIPE_CASES})}
    _WHOLE_TREE.clear()
    n_layers = whole.cfg.n_layers
    by_leg = {}
    for S, M in PIPE_CASES:
        legs = [("gpipe", 1), ("recompute", 1), ("stash", 1)]
        if S == PIPE_V2_STAGES:
            legs.append(("v2", 2))
        gp = None
        for leg, V in legs:
            model = pipe_models(torch, whole, S, M, V)
            if leg == "gpipe":
                (loss, logits), launches, peak, secs = counted(
                    lambda: dense(model))
            else:
                (loss, _), launches, peak, secs = counted(
                    lambda: (pipe_1f1b(torch, model, batch,
                                       "stash" if leg == "stash"
                                       else "recompute")[0], None))
            grads = grads_of(model)
            row = {"phase": "model_pipe", "S": S, "M": M, "V": V,
                   "leg": leg, "rows_a_microbatch": B // M,
                   "loss": loss, "launches": launches,
                   "fwd_bwd_s": round(secs, 4),
                   "peak_mem_bytes": peak[0] if M == 8 else None,
                   "mem_at_start_bytes": peak[1] if M == 8 else None}
            if leg == "gpipe":
                gp = (loss, grads, peak)
                m_loss, m_logits, m_grads = refs[M]
                g_err, w_err, worst = grad_errs(grads, m_grads)
                b_err, b_worst_err, b_worst = grad_errs(grads, ref_grads)
                row.update(ref_loss=m_loss,
                           loss_rel_err=abs(loss - m_loss) / abs(m_loss),
                           logits_rel_err=rel_err(logits, m_logits),
                           grads_rel_err=g_err, worst_param_rel_err=w_err,
                           worst_param=worst,
                           whole_batch={
                               "loss_rel_err": abs(loss - ref_loss)
                               / abs(ref_loss),
                               "logits_rel_err": rel_err(logits, ref_logits),
                               "grads_rel_err": b_err,
                               "worst_param_rel_err": b_worst_err,
                               "worst_param": b_worst},
                           bf16_floor_whole_vs_halves={
                               "grads_rel_err": noise[0],
                               "worst_param_rel_err": noise[1],
                               "worst_param": noise[2]},
                           tolerance=TOL_PIPE)
                ok = (row["loss_rel_err"] <= TOL_PIPE_LOSS
                      and row["logits_rel_err"] <= TOL_PIPE
                      and g_err <= TOL_PIPE)
            else:
                g_err, w_err, worst = grad_errs(grads, gp[1])
                row.update(gpipe_loss=gp[0],
                           loss_rel_err=abs(loss - gp[0]) / abs(gp[0]),
                           grads_rel_err=g_err, worst_param_rel_err=w_err,
                           worst_param=worst,
                           tolerance={"loss": TOL_PIPE_SCHED_LOSS,
                                      "grads": TOL_PIPE_SCHED_GRAD})
                ok = (row["loss_rel_err"] <= TOL_PIPE_SCHED_LOSS
                      and g_err <= TOL_PIPE_SCHED_GRAD)
            emit(row)
            by_leg[f"S{S}_M{M}_{leg}"] = launches
            check(math.isfinite(loss) and ok,
                  f"model_pipe S {S} M {M} {leg}: disagrees: {row}")
            fwd = n_layers * M * (2 if leg in ("recompute", "v2") else 1)
            want = {"flash_fwd": fwd, "flash_dq": n_layers * M,
                    "flash_dkv": n_layers * M}
            check(launches == want,
                  f"model_pipe S {S} M {M} {leg}: B1-B3 launched "
                  f"{launches}, want {want}")
            if M == 8 and leg == "recompute" and DEVICE != "cpu":
                check(peak[0] < gp[2][0],
                      f"model_pipe S {S} M {M}: 1F1B recompute's peak "
                      f"{peak[0]} B is not below GPipe's {gp[2][0]} B")
            del model, grads
            if DEVICE != "cpu":
                torch.cuda.empty_cache()
    _WHOLE_TREE.clear()
    return by_leg


M8 = ["--pipeline-microbatches", "8"]


def train_pipe_runs(count: int):
    """train_pipe's legs for ``count`` cards: (name, processes, the
    argv's pipeline flags, its mesh flags, the flags of the one-card run
    it is held to). 12 layers do not cut into 4 x 2 virtual stages, so
    the interleaved leg runs at pipe 2. A data rank of data 2 x pipe 2
    runs one-row microbatches (4 of its 4 rows), so that leg is held to
    one card's 8 one-row microbatches: the same bf16 products (one
    card's 4 two-row microbatches round each microbatch's weight
    gradient otherwise, printed beside)."""
    runs = []
    if count >= 4:
        p4 = ["--mesh.pipe", "4"]
        stash, gpipe = (["--pipeline-backward", "stash"],
                        ["--pipeline-schedule", "gpipe"])
        runs += [("pipe4_recompute", 4, [], p4, []),
                 ("pipe4_stash", 4, stash, p4, stash),
                 ("pipe4_gpipe", 4, gpipe, p4, gpipe)]
    else:
        runs.append(("pipe2_recompute", 2, [], ["--mesh.pipe", "2"], []))
    v2 = ["--pipeline-virtual-stages", "2"] + M8
    runs.append(("pipe2_v2", 2, v2, ["--mesh.pipe", "2"], v2))
    if count >= 4:
        runs.append(("data2_pipe2", 4, [],
                     ["--mesh.data", "2", "--mesh.pipe", "2"], M8))
    return runs


def phase_train_pipe(torch) -> None:
    """--mesh.pipe P under torchrun (NCCL): 10 steps a leg, the first
    five losses within 1e-2 of the same flags at --mesh.pipe 1 on one
    card, every rank launching its share of B1-B3; the first leg saves
    and --mode eval restores the save on the same ranks. Skipped, by the
    device count alone, on one card; on two, the pipe 2 legs only."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "train_pipe",
              "skipped": f"needs >= 2 CUDA devices, have {count}"})
        return
    tokens = 8 * 1024
    layers = PIPE_LAYERS
    one_card = {}
    results = []
    with tempfile.TemporaryDirectory(prefix="tfd_pipe_") as ckpt_dir:
        for i, (name, nproc, flags, mesh, ref) in enumerate(
                train_pipe_runs(count)):
            save = (["--checkpoint-dir", ckpt_dir, "--checkpoint-every",
                     str(TRAIN_PIPE_STEPS)] if i == 0 else [])
            argv = TRAIN_PIPE_ARGV + flags + mesh + save
            wall, ranks, _ = run_torchrun(f"train_pipe {name}", nproc, argv,
                                          TRAIN_PIPE_TIMEOUT_S)
            for key in {tuple(flags), tuple(ref)}:
                if key not in one_card:
                    one_card[key] = one_card_losses(TRAIN_PIPE_ARGV
                                                    + list(key))
            one, one_sps = one_card[tuple(ref)]
            same_argv = one_card[tuple(flags)][0]
            S = int(mesh[mesh.index("--mesh.pipe") + 1])
            D = (int(mesh[mesh.index("--mesh.data") + 1])
                 if "--mesh.data" in mesh else 1)
            M = (int(flags[flags.index("--pipeline-microbatches") + 1])
                 if "--pipeline-microbatches" in flags else 4)
            recompute = "--pipeline-backward" not in flags and (
                "--pipeline-schedule" not in flags)
            share = layers // S * M * TRAIN_PIPE_STEPS
            rec = {"phase": "train_pipe", "run": name, "processes": nproc,
                   "argv": argv, "wall_s": round(wall, 3),
                   "losses": ranks[0]["losses"][:5],
                   "one_card_flags": ref, "one_card_losses": one[:5],
                   "max_loss_diff": max(abs(a - b) for r in ranks
                                        for a, b in zip(r["losses"][:5],
                                                        one)),
                   "same_argv_one_card_losses": same_argv[:5],
                   "same_argv_max_loss_diff": max(
                       abs(a - b) for r in ranks
                       for a, b in zip(r["losses"][:5], same_argv)),
                   "step_ms_median_per_rank": [r["step_ms_median"]
                                               for r in ranks],
                   "tokens_per_s_per_card": [
                       tokens / (r["step_ms_median"] / 1e3) / nproc
                       if r["step_ms_median"] else None for r in ranks],
                   "one_card_step_ms": 1e3 / one_sps if one_sps else None,
                   "one_card_tokens_per_s": one_sps * tokens,
                   "peak_mem_bytes_per_rank": [r["max_memory_allocated"]
                                               for r in ranks],
                   "b1_b3_share_a_rank": {
                       "flash_fwd": share * (2 if recompute else 1),
                       "flash_dq": share, "flash_dkv": share},
                   "launches_per_rank": [
                       {k: r["launches"][k] for k in
                        ("flash_fwd", "flash_dq", "flash_dkv")}
                       for r in ranks],
                   "data": D, "pipe": S}
            emit(rec)
            results.append((name, ranks, one, rec))
            if i == 0:
                eval_argv = (["--mode", "eval"] + TRAIN_PIPE_ARGV[2:] + mesh
                             + ["--checkpoint-dir", ckpt_dir])
                _, evals, _ = run_torchrun(f"train_pipe {name} eval", nproc,
                                           eval_argv, TRAIN_PIPE_TIMEOUT_S)
                final = ranks[0]["final"]["loss"]
                got = [r["eval"]["loss"] for r in evals]
                emit({"phase": "train_pipe", "run": f"{name}_eval",
                      "argv": eval_argv, "eval_losses": got,
                      "final_eval_loss": final,
                      "max_rel_diff": max(abs(g - final) / abs(final)
                                          for g in got),
                      "tolerance": TOL_PIPE_EVAL})
                check(all(abs(g - final) <= TOL_PIPE_EVAL * abs(final)
                          for g in got),
                      f"train_pipe {name}: --mode eval of the save {got} "
                      f"vs the run's final eval {final}")
    for name, ranks, one, rec in results:
        share = rec["b1_b3_share_a_rank"]
        for r in ranks:
            check(len(r["losses"]) == TRAIN_PIPE_STEPS and all(
                abs(a - b) <= TOL_RING_LOSS
                for a, b in zip(r["losses"][:5], one)),
                f"train_pipe {name}: losses {r['losses']} vs one card "
                f"{one}")
            launched = r["launches"]
            check(launched["flash_dq"] == share["flash_dq"]
                  and launched["flash_dkv"] == share["flash_dkv"]
                  and launched["flash_fwd"] >= share["flash_fwd"],
                  f"train_pipe {name}: a rank did not launch its B1-B3 "
                  f"share {share}: {launched}")


def lsgd_leg(kernels, torch, argv, steps: int, sync_every=None):
    """``steps`` steps of ``argv`` on the stacked transport, every launch
    count set to 0 just before the steps and read just after; with
    ``sync_every`` the local-SGD step of that H (1 is not local SGD in a
    config). Returns (losses, launches, the state, each step's largest
    spread of the replicas' params)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.data.prefetch import to_device
    from tensorflow_distributed_tpu_torch.train.local_sgd import (
        make_local_sgd_train_step)
    from tensorflow_distributed_tpu_torch.train.loop import build_stacked

    device = torch.device(DEVICE)
    task, state, step = build_stacked(parse_args(argv), device)
    if sync_every is not None:
        step = make_local_sgd_train_step(task.loss, device, state.mesh,
                                         sync_every)
    stream = task.train_stream(0)
    batches = [to_device(next(stream), device) for _ in range(steps)]
    sync(torch)
    for kern in kernels:
        kern.launches = 0
    losses, spreads = [], []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        reps = getattr(state, "replicas", [])
        spreads.append(max((float((a.detach() - b.detach()).abs().max())
                            for r in reps[1:] for a, b in zip(
                                r.params.values(),
                                reps[0].params.values())), default=0.0))
    sync(torch)
    return losses, {kern.name: kern.launches for kern in kernels}, state, \
        spreads


def phase_model_local_sgd(kernels, torch) -> None:
    """Local SGD on the stacked transport (see the module docstring,
    phase 52)."""
    from tensorflow_distributed_tpu_torch.train.local_sgd import (
        averaged_view)

    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    D = LSGD_D
    sync_losses, _, sync_state, _ = lsgd_leg(
        kernels, torch, MODEL_LSGD_ARGV, 1)
    local = MODEL_LSGD_ARGV + ["--param-sync-every", "2"]
    h1_losses, h1_launches, h1_state, _ = lsgd_leg(kernels, torch, local,
                                                   1, sync_every=1)
    mean = averaged_view(h1_state)
    worst = max((float(((mean.params[n].detach() - p.detach()).abs()
                        - TOL_ZERO_PARAMS["rtol"] * p.detach().abs()).max()),
                 n) for n, p in sync_state.params.items())
    del sync_state, h1_state, mean
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    rec = {"phase": "model_local_sgd", "leg": "h1_vs_sync", "D": D,
           "losses": h1_losses, "sync_losses": sync_losses,
           "loss_rel_err": abs(h1_losses[0] - sync_losses[0])
           / abs(sync_losses[0]),
           "params_excess_over_tol": worst, "launches": h1_launches,
           "tolerance": {"loss": TOL_ZERO_LOSS, **TOL_ZERO_PARAMS}}
    emit(rec)
    check(math.isfinite(h1_losses[0])
          and rec["loss_rel_err"] <= TOL_ZERO_LOSS
          and worst[0] <= TOL_ZERO_PARAMS["atol"],
          f"model_local_sgd: H 1 disagrees with the synchronous step: "
          f"{rec}")
    t0 = time.time()
    losses, launches, state, spreads = lsgd_leg(
        kernels, torch, MODEL_LSGD_ARGV + ["--param-sync-every", "4"],
        LSGD_STEPS)
    secs = time.time() - t0
    rec = {"phase": "model_local_sgd", "leg": "h4", "D": D,
           "losses": losses, "replica_spread_after_step": spreads,
           "launches": launches, "steps_s": round(secs, 3),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if DEVICE != "cpu" else None)}
    emit(rec)
    del state
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses)
          and all(x > 0 for x in spreads[:3]) and spreads[3] == 0.0,
          f"model_local_sgd: the replicas did not part for 3 steps and "
          f"meet at the 4th: {spreads}")
    for name, got in (("h1", h1_launches), ("h4", launches)):
        steps = 1 if name == "h1" else LSGD_STEPS
        check(all(got[k] == 12 * D * steps for k in flash),
              f"model_local_sgd {name}: B1-B3 not launched 12 x {D} "
              f"times a step: {got}")


def pipe3d_models(torch, axis: str, S: int):
    """GPT-2-small (``PIPE3D_MODEL``) as ``pipelined_lm`` on
    ``StackedPipe(S)`` with its blocks on ``StackedTP(width)`` (``axis``
    "model") or its attention on ``StackedRing(width)`` ("seq"), the
    whole model's seeded init, in bf16 without dropout."""
    from tensorflow_distributed_tpu_torch.models.pipelined import (
        PIPELINED_TINY_LAYERS, pipelined_lm)
    from tensorflow_distributed_tpu_torch.parallel.mesh import StackedPipe
    from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
        StackedRing)
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        StackedTP)

    cut = PIPE3D_MODEL["width"]
    kw = {"tp": StackedTP(cut)} if axis == "model" else {
        "ring": StackedRing(cut)}
    layers = {} if PIPE3D_MODEL["size"] != "tiny" else {
        "n_layers": PIPELINED_TINY_LAYERS}
    with torch.device(DEVICE):
        model = pipelined_lm(PIPE3D_MODEL["size"], pipe=StackedPipe(S),
                             num_microbatches=PIPE3D_MODEL["M"],
                             compute_dtype=torch.bfloat16, dropout_rate=0.0,
                             max_len=PIPE3D_MODEL["L"], **layers, **kw)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    return model


def phase_model_pipe3d(fa, torch, np, axis: str):
    """model_pipe_tp (``axis`` "model") or model_pipe_seq ("seq"): see
    the module docstring, phases 53-54. Returns the launch counts by
    leg."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm
    from tensorflow_distributed_tpu_torch.parallel.sharding import (
        gather_state_dict)

    phase = "model_pipe_tp" if axis == "model" else "model_pipe_seq"
    kernels = fa.KERNELS + fa.PARTIAL_KERNELS
    rng = np.random.default_rng(0)
    B, L, S, M = (PIPE3D_MODEL[k] for k in ("B", "L", "S", "M"))
    unstaged = pipe3d_models(torch, axis, 1)
    V_ = unstaged.cfg.vocab_size
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in (
        ("tokens", rng.integers(0, V_, (B, L))),
        ("targets", rng.integers(0, V_, (B, L))),
        ("mask", (rng.random((B, L)) < 0.9).astype(np.float32)))}

    def whole(m, tensors):
        """A model's tensors by name, its TP shards gathered."""
        return gather_state_dict(tensors, m) if m.tp is not None else tensors

    def errs(loss, logits, grads, ref):
        g_err, w_err, worst = grad_errs(grads, ref[2])
        return {"ref_loss": ref[0],
                "loss_rel_err": abs(loss - ref[0]) / abs(ref[0]),
                "logits_rel_err": rel_err(logits, ref[1]),
                "grads_rel_err": g_err, "worst_param_rel_err": w_err,
                "worst_param": worst}

    def within(e):
        return (e["loss_rel_err"] <= TOL_PIPE_LOSS
                and e["logits_rel_err"] <= TOL_PIPE
                and e["grads_rel_err"] <= TOL_PIPE)

    # The same model unstaged (one stage, the same transport, its own M
    # microbatches): an extra check of the stage split alone.
    unstaged_ref = masked_loss(unstaged, batch) + (whole(unstaged, {
        k: p.grad.detach() for k, p in unstaged.named_parameters()}),)
    whole_params = whole(unstaged, {k: p.detach() for k, p in
                                    unstaged.named_parameters()})
    n_layers = unstaged.cfg.n_layers
    del unstaged
    # The gate's oracle: the plain gpt_lm (no transport) on the same
    # weights, over the same M microbatches; the whole batch at once
    # printed beside it.
    with torch.device(DEVICE):
        plain = gpt_lm(PIPE3D_MODEL["size"], compute_dtype=torch.bfloat16,
                       dropout_rate=0.0, max_len=L, **(
                           {"n_layers": n_layers}
                           if PIPE3D_MODEL["size"] == "tiny" else {}))
    plain.load_state_dict(whole_params)
    plain_ref = by_microbatch(torch, plain, batch, M)
    whole_batch = masked_loss(plain, batch)
    whole_batch += ({k: p.grad.detach() for k, p in
                     plain.named_parameters()},)
    del plain, whole_params
    per_call = (2 * PIPE3D_MODEL["width"] + 1 if axis == "seq"
                else PIPE3D_MODEL["width"])
    by_leg, gp = {}, None
    for leg in PIPE3D_LEGS:
        model = pipe3d_models(torch, axis, S)
        sync(torch)
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        t0 = time.time()
        if leg == "gpipe":
            loss, logits = masked_loss(model, batch)
        else:
            loss = pipe_1f1b(torch, model, batch, leg)[0]
        sync(torch)
        secs = time.time() - t0
        launches = {kern.name: kern.launches for kern in kernels}
        grads = whole(model, {k: p.grad.detach().clone()
                              for k, p in model.named_parameters()})
        row = {"phase": phase, "S": S, "M": M, "width": PIPE3D_MODEL[
            "width"], "leg": leg, "loss": loss, "launches": launches,
            "fwd_bwd_s": round(secs, 4),
            "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                               if DEVICE != "cpu" else None)}
        if leg == "gpipe":
            gp = (loss, grads)
            row.update(errs(loss, logits, grads, plain_ref))
            row.update(
                unstaged=errs(loss, logits, grads, unstaged_ref),
                plain_whole_batch=errs(loss, logits, grads, whole_batch),
                tolerance={"loss": TOL_PIPE_LOSS, "other": TOL_PIPE})
            ok = within(row) and within(row["unstaged"])
        else:
            g_err, w_err, worst = grad_errs(grads, gp[1])
            row.update(gpipe_loss=gp[0],
                       loss_rel_err=abs(loss - gp[0]) / abs(gp[0]),
                       grads_rel_err=g_err, worst_param_rel_err=w_err,
                       worst_param=worst,
                       tolerance={"loss": TOL_PIPE_SCHED_LOSS,
                                  "grads": TOL_PIPE_SCHED_GRAD})
            ok = (row["loss_rel_err"] <= TOL_PIPE_SCHED_LOSS
                  and g_err <= TOL_PIPE_SCHED_GRAD)
        emit(row)
        by_leg[f"{phase}_{leg}"] = launches
        check(math.isfinite(loss) and ok,
              f"{phase} {leg}: disagrees: {row}")
        calls = n_layers * M * per_call
        fwd = calls * (2 if leg == "recompute" else 1)
        names = (("flash_fwd_partial", "flash_dq_partial",
                  "flash_dkv_partial") if axis == "seq"
                 else ("flash_fwd", "flash_dq", "flash_dkv"))
        other = (("flash_fwd", "flash_dq", "flash_dkv") if axis == "seq"
                 else ("flash_fwd_partial", "flash_dq_partial",
                       "flash_dkv_partial"))
        want = dict(zip(names, (fwd, calls, calls)))
        want.update((k, 0) for k in other)
        check({k: launches[k] for k in want} == want,
              f"{phase} {leg}: launched {launches}, want {want}")
        del model, grads
        if DEVICE != "cpu":
            torch.cuda.empty_cache()
    return by_leg


def phase_model_pipe_tp(fa, torch, np):
    """Phase 53: pipe x model on the stacked transports."""
    return phase_model_pipe3d(fa, torch, np, "model")


def phase_model_pipe_seq(fa, torch, np):
    """Phase 54: pipe x seq on the stacked transports."""
    return phase_model_pipe3d(fa, torch, np, "seq")


def phase_train_local_sgd(torch) -> None:
    """--mesh.data D --param-sync-every 4 under torchrun (see the module
    docstring, phase 55); skipped, by the device count alone, on one
    card."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "train_local_sgd",
              "skipped": f"needs >= 2 CUDA devices, have {count}"})
        return
    D = min(count, 4)
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    tokens = 8 * 1024
    one, one_sps = one_card_losses(TRAIN_TP_ARGV)
    with tempfile.TemporaryDirectory(prefix="tfd_lsgd_") as ckpt_dir:
        argv = TRAIN_LSGD_ARGV + ["--mesh.data", str(D), "--checkpoint-dir",
                                  ckpt_dir, "--checkpoint-every",
                                  str(TRAIN_TP_STEPS)]
        wall, ranks, _ = run_torchrun("train_local_sgd", D, argv,
                                      TRAIN_LSGD_TIMEOUT_S)
        eval_argv = (["--mode", "eval"] + TRAIN_LSGD_ARGV[2:]
                     + ["--mesh.data", str(D), "--checkpoint-dir", ckpt_dir])
        _, evals, _ = run_torchrun("train_local_sgd eval", D, eval_argv,
                                   TRAIN_LSGD_TIMEOUT_S)
    final = ranks[0]["final"]["loss"]
    got = [r["eval"]["loss"] for r in evals]
    emit({"phase": "train_local_sgd", "processes": D, "argv": argv,
          "wall_s": round(wall, 3), "losses": ranks[0]["losses"],
          "one_card_losses": one[:5],
          "first_loss_diff": max(abs(r["losses"][0] - one[0])
                                 for r in ranks),
          "step_ms_median_per_rank": [r["step_ms_median"] for r in ranks],
          "tokens_per_s_per_card": [
              tokens / (r["step_ms_median"] / 1e3) / D
              if r["step_ms_median"] else None for r in ranks],
          "one_card_step_ms": 1e3 / one_sps if one_sps else None,
          "peak_mem_bytes_per_rank": [r["max_memory_allocated"]
                                      for r in ranks],
          "launches_per_rank": [{k: r["launches"][k] for k in flash}
                                for r in ranks],
          "eval_argv": eval_argv, "eval_losses": got,
          "final_eval_loss": final,
          "eval_max_rel_diff": max(abs(g - final) / abs(final)
                                   for g in got),
          "tolerance": {"first_loss": TOL_RING_LOSS, "eval": TOL_PIPE_EVAL}})
    for r in ranks:
        check(len(r["losses"]) == TRAIN_TP_STEPS
              and all(math.isfinite(x) for x in r["losses"])
              and abs(r["losses"][0] - one[0]) <= TOL_RING_LOSS,
              f"train_local_sgd: losses {r['losses']} vs one card {one}")
        check(all(r["launches"][k] >= 12 * TRAIN_TP_STEPS for k in flash),
              f"train_local_sgd: a rank did not launch B1-B3 12 a step: "
              f"{r['launches']}")
    check(all(abs(g - final) <= TOL_PIPE_EVAL * abs(final) for g in got),
          f"train_local_sgd: --mode eval of the save {got} vs the run's "
          f"final eval {final}")


def phase_train_pipe3d(torch) -> None:
    """pipe x model, pipe x seq and zero1 with the pipe under torchrun
    (see the module docstring, phase 56); skipped, by the device count
    alone, on fewer than four cards. Every leg runs before the checks."""
    count = torch.cuda.device_count()
    if count < 4:
        emit({"phase": "train_pipe3d",
              "skipped": f"needs >= 4 CUDA devices, have {count}"})
        return
    tokens = 8 * 1024
    one_card, legs = {}, []
    for name, flags, ref in TRAIN_PIPE3D_RUNS:
        argv = TRAIN_PIPE_ARGV + flags
        wall, ranks, _ = run_torchrun(f"train_pipe3d {name}", 4, argv,
                                      TRAIN_PIPE_TIMEOUT_S)
        if tuple(ref) not in one_card:
            one_card[tuple(ref)] = one_card_losses(TRAIN_PIPE_ARGV + ref)
        one, one_sps = one_card[tuple(ref)]
        seq = "--mesh.seq" in flags
        names = (("flash_fwd_partial", "flash_dq_partial",
                  "flash_dkv_partial") if seq
                 else ("flash_fwd", "flash_dq", "flash_dkv"))
        emit({"phase": "train_pipe3d", "run": name, "processes": 4,
              "argv": argv, "wall_s": round(wall, 3),
              "losses": ranks[0]["losses"][:5], "one_card_flags": ref,
              "one_card_losses": one[:5],
              "max_loss_diff": max(abs(a - b) for r in ranks
                                   for a, b in zip(r["losses"][:5], one)),
              "step_ms_median_per_rank": [r["step_ms_median"]
                                          for r in ranks],
              "tokens_per_s_per_card": [
                  tokens / (r["step_ms_median"] / 1e3) / 4
                  if r["step_ms_median"] else None for r in ranks],
              "one_card_step_ms": 1e3 / one_sps if one_sps else None,
              "peak_mem_bytes_per_rank": [r["max_memory_allocated"]
                                          for r in ranks],
              "kernel_share_per_rank": [{k: r["launches"][k]
                                         for k in names} for r in ranks]})
        legs.append((name, ranks, one, names))
    for name, ranks, one, names in legs:
        for r in ranks:
            got = r["losses"]
            check(len(got) == TRAIN_PIPE_STEPS and all(
                abs(a - b) <= TOL_RING_LOSS for a, b in zip(got[:5], one)),
                f"train_pipe3d {name}: losses {got} vs one card {one}")
            check(all(r["launches"][k] > 0 for k in names),
                  f"train_pipe3d {name}: a rank did not launch {names}: "
                  f"{r['launches']}")


def tp_twin(torch, whole, M: int):
    """``whole`` on ``StackedTP(M)`` (every model rank in this process)
    with the same weights, cut by the port's TP layout."""
    from tensorflow_distributed_tpu_torch.parallel.sharding import (
        shard_state_dict)
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        StackedTP)

    with torch.device(DEVICE):
        model = type(whole)(whole.cfg, tp=StackedTP(M))
    with torch.no_grad():
        model.load_state_dict(shard_state_dict(whole.state_dict(), model))
    return model.eval()


def with_fields(torch, model, **fields):
    """``model`` with ``fields`` of its config changed (the decode cache's
    layout), sharing its parameters."""
    cfg = dataclasses.replace(model.cfg, **fields)
    with torch.device("meta"):
        out = type(model)(cfg, model.ring, model.tp,
                          vocab_shards=model.vocab_shards, ep=model.ep)
    out.load_state_dict(model.state_dict(), assign=True)
    return out.eval()


def serve_tp_requests(np, vocab: int):
    """SERVE_TP_REQUESTS prompts with lengths spread over
    SERVE_TP_PROMPTS, drawn from seed 3."""
    rng = np.random.default_rng(3)
    lens = np.linspace(*SERVE_TP_PROMPTS, SERVE_TP_REQUESTS).astype(int)
    return [rng.integers(0, vocab, n) for n in lens]


def serve_tp_leg(torch, np, leg: str, model, prompts, turn2=None):
    """One leg's engine on ``model`` under the FIFO scheduler: ``dense``,
    ``int8`` (the model's cache int8), ``kgram`` (k-gram self-draft at
    SPEC_K) or ``paged`` (page size PAGE_SIZE, the radix cache; each
    prompt a session of two turns, the second ``turn2[i]``: the first
    turn's prompt, the reference's tokens and SERVE_TP_TURN_NEW new
    ones). Returns (the engine, each request's tokens, rid order)."""
    from tensorflow_distributed_tpu_torch.serve.buckets import (
        default_buckets)
    from tensorflow_distributed_tpu_torch.serve.engine import (
        SlotDecodeEngine)
    from tensorflow_distributed_tpu_torch.serve.paging.engine import (
        PagedSlotEngine)
    from tensorflow_distributed_tpu_torch.serve.scheduler import (
        Request, Scheduler)
    from tensorflow_distributed_tpu_torch.serve.speculate import SelfDraft

    buckets = default_buckets(SERVE_TP_BUCKETS, cap=model.cfg.max_len)
    speculator = None
    if leg == "paged":
        engine = PagedSlotEngine(model, SERVE_TP_SLOTS, page_size=PAGE_SIZE,
                                 buckets=buckets)
    elif leg == "kgram":
        engine = SlotDecodeEngine(model, SERVE_TP_SLOTS, buckets=buckets,
                                  spec_tokens=SPEC_K)
        speculator = SelfDraft(SERVE_TP_SLOTS, SPEC_K)
    else:
        engine = SlotDecodeEngine(model, SERVE_TP_SLOTS, buckets=buckets)
    engine.warmup()
    sched = Scheduler(engine, decode_priority=4, speculator=speculator)

    def run(ps, base):
        done = {c.rid: c for c in sched.run(
            [Request(rid=base + i, prompt=p, max_new_tokens=SERVE_TP_NEW,
                     session=f"s{i}" if leg == "paged" else "")
             for i, p in enumerate(ps)])}
        return [done[base + i].tokens for i in range(len(ps))]

    tokens = run(prompts, 0)
    if turn2 is not None:
        tokens += run(turn2, len(prompts))
    return engine, tokens


def phase_model_serve_tp(torch, np) -> None:
    """The decode engine on StackedTP(M), M in SERVE_TP_SIZES (and
    SERVE_TP_MORE's for its legs), against the
    whole engine on the same GPT-2-small weights: in f32 every stream
    through the Scheduler equals the whole engine's (dense, paged in
    sessions of two turns with radix hits, int8, k-gram at SPEC_K; the
    Llama-style GQA cache dense), excused only where the whole model's
    top-2 gap is under IDENTITY_GAP; cache_bytes_per_slot and page_bytes
    exactly 1/M of the whole engine's; then in bf16 the TP decode logits
    within TOL_SERVE_TP of the whole model's, step by step on the same
    tokens."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        decode_token, prefill_cache)

    t0 = time.time()
    legs = [("dense", {}), ("paged", {}), ("int8", {"kv_cache_quant": "int8"}),
            ("kgram", {}), ("gqa", LLAMA_OPTS)]
    rows = []
    for leg, overrides in legs:
        whole = gpt2_small(torch, torch.float32,
                           **{k: v for k, v in overrides.items()
                              if k != "kv_cache_quant"}).eval()
        if "kv_cache_quant" in overrides:
            whole = with_fields(torch, whole, kv_cache_quant="int8")
        prompts = serve_tp_requests(np, whole.cfg.vocab_size)
        rng = np.random.default_rng(4)
        ref_engine, ref = serve_tp_leg(torch, np, leg, whole, prompts)
        turn2 = None
        if leg == "paged":
            turn2 = [np.concatenate([p, t, rng.integers(
                0, whole.cfg.vocab_size, SERVE_TP_TURN_NEW)])
                for p, t in zip(prompts, ref)]
            ref_engine, ref = serve_tp_leg(torch, np, leg, whole, prompts,
                                           turn2)
        fed = prompts + (turn2 or [])
        for M in SERVE_TP_SIZES + SERVE_TP_MORE.get(leg, ()):
            model = tp_twin(torch, whole, M)
            engine, got = serve_tp_leg(torch, np, leg, model, prompts, turn2)
            excused = [dict(rid=i, **bad) for i, (p, g, r) in enumerate(
                zip(fed, got, ref)) if (bad := stream_check(
                    torch, whole, p, g, r,
                    f"model_serve_tp {leg} M={M}: request {i}",
                    "the whole engine"))]
            row = {"leg": leg, "M": M, "requests": len(fed),
                   "identical": len(fed) - len(excused), "excused": excused,
                   "cache_bytes_per_slot": engine.cache_bytes_per_slot(),
                   "whole_cache_bytes_per_slot":
                       ref_engine.cache_bytes_per_slot(),
                   "tp_width": engine.tp_width}
            check(engine.tp_width == M
                  and engine.cache_bytes_per_slot() * M
                  == ref_engine.cache_bytes_per_slot(),
                  f"model_serve_tp {leg} M={M}: {row['cache_bytes_per_slot']}"
                  f" cache bytes a slot on a device, not 1/{M} of the whole "
                  f"engine's {row['whole_cache_bytes_per_slot']}")
            if leg == "paged":
                row.update(page_bytes=engine.page_bytes(),
                           whole_page_bytes=ref_engine.page_bytes(),
                           prefix_hits=engine.prefix_hits)
                check(engine.page_bytes() * M == ref_engine.page_bytes()
                      and engine.prefix_hits >= SERVE_TP_REQUESTS,
                      f"model_serve_tp paged M={M}: page bytes "
                      f"{engine.page_bytes()} (whole {ref_engine.page_bytes()}"
                      f"), {engine.prefix_hits} prefix hits")
            if leg == "kgram":
                row["verify_steps"] = engine.verify_steps
                check(engine.verify_steps > 0,
                      f"model_serve_tp kgram M={M}: no verify step ran")
            rows.append(row)
            del model, engine
        del whole, ref_engine
    # bf16: the decode logits, fed the whole model's greedy tokens.
    whole = gpt2_small(torch, torch.bfloat16).eval()
    prompts = serve_tp_requests(np, whole.cfg.vocab_size)[:SERVE_TP_SLOTS]
    P = max(len(p) for p in prompts)
    batch = torch.zeros((len(prompts), P), dtype=torch.long, device=DEVICE)
    for b, p in enumerate(prompts):
        batch[b, P - len(p):] = torch.from_numpy(p)  # right-aligned rows
    bf16 = {}
    for M in SERVE_TP_SIZES:
        model = tp_twin(torch, whole, M)
        errs = []
        with torch.no_grad():
            ref_logits, ref_cache = prefill_cache(whole, batch)
            got_logits, cache = prefill_cache(model, batch)
            ref_last, last = ref_logits[:, -1], got_logits[:, -1]
            for step in range(SERVE_TP_BF16_STEPS + 1):
                errs.append(float((last - ref_last).abs().max()
                                  / ref_last.abs().max()))
                if step == SERVE_TP_BF16_STEPS:
                    break
                tok = ref_last.argmax(dim=-1)
                pos = torch.tensor([P + step], device=DEVICE)
                ref_last, ref_cache = decode_token(whole, ref_cache, tok, pos)
                last, cache = decode_token(model, cache, tok, pos)
        bf16[M] = errs
        check(max(errs) <= TOL_SERVE_TP,
              f"model_serve_tp bf16 M={M}: decode logits {errs} vs the whole "
              f"model, tolerance {TOL_SERVE_TP}")
        del model
    emit({"phase": "model_serve_tp", "legs": rows,
          "bf16_rel_err_by_step": bf16, "tolerance_bf16": TOL_SERVE_TP,
          "slots": SERVE_TP_SLOTS, "new_tokens": SERVE_TP_NEW,
          "wall_s": round(time.time() - t0, 3)})


def journal_streams(path: str) -> dict:
    """{rid: tokens} of a replayed journal, every request done."""
    from tensorflow_distributed_tpu_torch.serve import journal as journal_mod

    played = journal_mod.replay(path)
    check(all(e["done"] for e in played.values()),
          f"serve_tp: a request of {path} is not done")
    return {rid: e["tokens"] for rid, e in played.items()}


def tp_excuses(torch, argv, got: dict, ref: dict, what: str) -> list:
    """Where ``got`` (a TP run's streams) differs from ``ref`` (one
    card's, same flags), the one-card model's top-2 gap at the first
    difference: under IDENTITY_GAP or the phase fails. The model is the
    CLI's fresh-init one, rebuilt here; the prompts are its workload."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.serve.run import _workload
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)

    check(set(got) == set(ref),
          f"{what}: requests {sorted(got)} vs one card's {sorted(ref)}")
    bad = [rid for rid in ref if got[rid] != ref[rid]]
    if not bad:
        return []
    cfg = parse_args(argv)
    vocab = cfg.synthetic_vocab
    model, _ = _build_model_and_state(cfg, torch.device(DEVICE),
                                      vocab_size=vocab)
    prompts = {r.rid: r.prompt for r in _workload(cfg, vocab)}
    out = [dict(rid=rid, **stream_check(
        torch, model.eval(), prompts[rid], got[rid], ref[rid],
        f"{what}: request {rid}", "one card's run")) for rid in bad]
    del model
    return out


def replica_stop_s(out: str):
    """The seconds by part of a TP replica's stop, from its
    ``[serve] tensor-parallel replica stopped: {...}`` line (None for a
    one-card run)."""
    line = next((l for l in out.splitlines()
                 if l.startswith("[serve] tensor-parallel replica stopped")),
                None)
    return None if line is None else json.loads(line.split(": ", 1)[1])


def serve_tp_pids(out: str) -> list:
    """The worker pids a TP serving leg printed."""
    line = next((l for l in out.splitlines()
                 if l.startswith("[serve] tensor-parallel replica:")), "")
    m = re.search(r"worker pids \[([0-9, ]*)\]", line)
    check(m is not None, "serve_tp: no worker pids in the replica line")
    return [int(x) for x in m.group(1).split(",") if x.strip()]


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def phase_serve_tp(torch) -> None:
    """--serve.mesh-model SERVE_TP_WIDTH through the CLI (a chief and
    three worker processes, NCCL), skipped on fewer cards by the device
    count alone: ``serve_tp_readings``, then ``serve_tp_gates``."""
    count = torch.cuda.device_count()
    if count < SERVE_TP_WIDTH:
        emit({"phase": "serve_tp",
              "skipped": f"needs >= {SERVE_TP_WIDTH} CUDA devices, have "
                         f"{count}"})
        return
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="tfd_serve_tp_") as tmp:
        got = serve_tp_readings(tmp)
    runs = serve_tp_gates(torch, got)
    emit({"phase": "serve_tp", "width": SERVE_TP_WIDTH, "runs": runs,
          "wall_s": round(time.time() - t0, 3)})


def serve_tp_readings(tmp: str) -> dict:
    """In f32, dense then paged (sessions of two turns), one card's run
    and the TP run of the same flags, each with a journal; in bf16 the
    two runs' summaries; then the dense f32 TP command under the
    supervisor with a SIGKILL at decode step 10. Returns every run's
    summary fields, journal streams, and the supervised run's exit code,
    output and the killed leg's worker pids."""
    tp = ["--serve.mesh-model", str(SERVE_TP_WIDTH)]
    f32 = ["--compute-dtype", "float32"]
    keys = SERVE_KEYS + ("tp_width", "per_device_cache_bytes",
                         "peak_bytes_by_rank", "prefix_hits", "tp_commands",
                         "tp_command_s", "tp_start_s")
    got = {"runs": {}, "streams": {}}

    def run(run_name, argv):
        t0 = time.time()
        _, _, record, out = serve_cli(argv)
        got["runs"][run_name] = {k: record.get(k) for k in keys}
        got["runs"][run_name]["cli_s"] = round(time.time() - t0, 3)
        got["runs"][run_name]["tp_stop_s"] = replica_stop_s(out)
        sys.stderr.write(f"[serve_tp] {run_name}: {time.time() - t0:.1f} s "
                         f"in the CLI\n")

    for leg, extra in (("dense", []), ("paged", SERVE_TP_PAGED)):
        for name, flags in (("one_card", []), ("tp", tp)):
            journal = os.path.join(tmp, f"{leg}_{name}.jsonl")
            run(f"f32_{leg}_{name}", SERVE_TP_ARGV + f32 + extra + flags
                + ["--serve.journal", journal])
            got["streams"][f"f32_{leg}_{name}"] = journal_streams(journal)
    for name, flags in (("one_card", []), ("tp", tp)):
        run(f"bf16_{name}", SERVE_TP_ARGV + flags)
    journal = os.path.join(tmp, "kill.jsonl")
    cmd = [sys.executable, "-m",
           "tensorflow_distributed_tpu_torch.resilience.supervisor",
           "--max-restarts", "2", "--backoff-base-s", "0.5", "--",
           *SERVE_TP_ARGV, *f32, *tp, "--serve.journal", journal,
           "--resilience.fault-plan", SERVE_TP_KILL_PLAN]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=2 * SERVE_TP_CLI_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   PYTHONUNBUFFERED="1"))
    sys.stderr.write(proc.stderr[-3000:])
    legs = proc.stdout.split("[supervisor] leg ")
    got["supervised"] = {
        "rc": proc.returncode, "legs": len(legs) - 1,
        "wall_s": round(time.time() - t0, 3),
        "restarted": '"kind": "restart"' in proc.stdout,
        "killed_leg_workers": serve_tp_pids(legs[1]) if len(legs) > 2
        else [],
        "streams": journal_streams(journal)}
    got["supervised"]["workers_left"] = [
        p for p in got["supervised"]["killed_leg_workers"] if pid_alive(p)]
    return got


def serve_tp_gates(torch, got: dict) -> dict:
    """The gates of ``serve_tp_readings``: each f32 TP stream equal to
    one card's (excused only where the one-card model's top-2 gap is
    under IDENTITY_GAP), the per-device cache bytes 1/SERVE_TP_WIDTH of
    one card's; the supervised run restarted once and exited 0, its
    streams the clean TP run's, every request done once, and no worker
    of the killed leg alive. Returns the runs' fields for the phase's
    line."""
    runs = {k: dict(v) for k, v in got["runs"].items()}
    streams = got["streams"]
    for leg, extra in (("dense", []), ("paged", SERVE_TP_PAGED)):
        argv = SERVE_TP_ARGV + ["--compute-dtype", "float32"] + extra
        tp, one = streams[f"f32_{leg}_tp"], streams[f"f32_{leg}_one_card"]
        excused = tp_excuses(torch, argv, tp, one, f"serve_tp f32 {leg}")
        runs[f"f32_{leg}_tp"].update(identical=len(tp) - len(excused),
                                     excused=excused)
        bytes_tp = runs[f"f32_{leg}_tp"]["per_device_cache_bytes"]
        bytes_one = runs[f"f32_{leg}_one_card"]["per_device_cache_bytes"]
        check(runs[f"f32_{leg}_tp"]["tp_width"] == SERVE_TP_WIDTH
              and bytes_tp * SERVE_TP_WIDTH == bytes_one,
              f"serve_tp f32 {leg}: per-device cache bytes {bytes_tp}, not "
              f"1/{SERVE_TP_WIDTH} of one card's {bytes_one}")
    sup, clean = got["supervised"], streams["f32_dense_tp"]
    runs["supervised"] = {k: v for k, v in sup.items() if k != "streams"}
    runs["supervised"].update(requests=len(sup["streams"]),
                              equal_clean=sup["streams"] == clean)
    check(sup["rc"] == 0 and sup["restarted"] and sup["legs"] == 2,
          f"serve_tp: the supervised run exited {sup['rc']} after "
          f"{sup['legs']} legs (restarted: {sup['restarted']})")
    check(len(sup["killed_leg_workers"]) == SERVE_TP_WIDTH - 1
          and not sup["workers_left"],
          f"serve_tp: workers {sup['workers_left']} of the killed leg "
          f"{sup['killed_leg_workers']} alive")
    check(sup["streams"] == clean,
          f"serve_tp: the supervised streams differ from the clean TP run's "
          f"(requests {len(sup['streams'])} of {len(clean)})")
    return runs


def phase_generate_tp(torch) -> None:
    """--mode generate --mesh.model 4 (torchrun, NCCL) from a
    --shard-vocab checkpoint that --mode train --mesh.model 4 wrote (its
    tables padded to a multiple of 4): greedy and --num-beams 4 in f32,
    the tokens equal to one card's --mode generate from the same
    checkpoint. Skipped on fewer cards by the device count alone."""
    count = torch.cuda.device_count()
    if count < SERVE_TP_WIDTH:
        emit({"phase": "generate_tp",
              "skipped": f"needs >= {SERVE_TP_WIDTH} CUDA devices, have "
                         f"{count}"})
        return
    t0 = time.time()
    mesh = ["--mesh.model", str(SERVE_TP_WIDTH)]
    out = {}
    with tempfile.TemporaryDirectory(prefix="tfd_generate_tp_") as tmp:
        ck = ["--checkpoint-dir", tmp]
        run_torchrun("generate_tp train", SERVE_TP_WIDTH,
                     GENERATE_TP_TRAIN + mesh + ck, GENERATE_TP_TIMEOUT_S)
        for beams in ("1", "4"):
            argv = GENERATE_TP_RUN + ck + ["--num-beams", beams]
            wall, ranks, _ = run_torchrun(f"generate_tp beams {beams}",
                                          SERVE_TP_WIDTH, argv + mesh,
                                          GENERATE_TP_TIMEOUT_S)
            rc, text = run_cli(argv)
            one = event_record(text, "generate")
            check(rc == 0 and one is not None,
                  f"generate_tp: one card's --mode generate exited {rc}")
            got = [r["generate"]["new_tokens"] for r in ranks]
            out[f"beams_{beams}"] = {"tp_tokens": got[0],
                                     "one_card_tokens": one["new_tokens"],
                                     "tp_wall_s": round(wall, 3)}
            check(all(g == one["new_tokens"] for g in got),
                  f"generate_tp beams {beams}: ranks' tokens {got} vs one "
                  f"card's {one['new_tokens']}")
    emit({"phase": "generate_tp", "width": SERVE_TP_WIDTH, **out,
          "wall_s": round(time.time() - t0, 3)})


def reshard_layout(torch, leg):
    """A fresh GPT-2-small state of model_reshard's layout ``leg`` ((name,
    data width or "tp", partition)): (state, train step, mesh, task)."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
    from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
        StackedTP)
    from tensorflow_distributed_tpu_torch.train import loop

    _, width, partition = leg
    device = torch.device(DEVICE)
    if width == "tp":
        cfg = parse_args(MODEL_ZERO_ARGV)
        mesh = mesh_lib.Mesh(model=2, tp=StackedTP(2))
        task = loop._make_task(cfg, mesh_lib.ONE_PROCESS)
        _, state = loop._build_model_and_state(cfg, device, mesh=mesh,
                                               task=task,
                                               min_size=ZERO_MIN_SIZE)
        return state, loop._make_step(cfg, task, state, device, mesh), mesh, \
            task
    cfg = parse_args(MODEL_ZERO_ARGV + ["--mesh.data", str(width),
                                        "--param-partition", partition])
    task, state, step = loop.build_stacked(cfg, device, ZERO_MIN_SIZE)
    return state, step, mesh_lib.stacked_data(width), task


def written_sha256(ckpt_dir: str, step: int = 1) -> str:
    """The sha256 of a step's ``state.msgpack`` as its writer hashed the
    bytes it wrote (the manifest's)."""
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt

    with open(os.path.join(ckpt._step_dir(ckpt_dir, step),
                           "manifest.json")) as f:
        return json.load(f)["sha256"]


def reshard_gates(torch, leg, loss, ref_loss, tensors, ref, before,
                  b1) -> dict:
    """A leg's next step against the unresharded state's (see
    RESHARD_LEGS): ``tensors`` and ``ref`` after it, ``before`` the
    restored state (the written one), ``b1`` Adam's. The loss at
    model_zero's gate (model_tp's on the model axis), the step's
    gradient (mu less b1 x the restored mu) at model_tp's gradient gate,
    and on the same-mesh leg the params at model_zero's (each param's
    excess over rtol); every reading printed."""
    names = [k[len("params/"):] for k in ref if k.startswith("params/")]
    out = {"loss_rel_err": abs(loss - ref_loss) / abs(ref_loss)}

    def step_grads(t):
        return {n: t[f"mu/{n}"] - b1 * before[f"mu/{n}"] for n in names}

    out["grads_rel_err"], out["worst_grad_rel_err"], out["worst_grad"] = (
        grad_errs(step_grads(tensors), step_grads(ref)))
    flips = sum(int((torch.sign(tensors[f"params/{n}"] - before[f"params/{n}"])
                     != torch.sign(ref[f"params/{n}"] - before[f"params/{n}"])
                     ).sum()) for n in names)
    out["update_sign_flip_frac"] = flips / sum(ref[f"params/{n}"].numel()
                                               for n in names)
    worst = max(float((tensors[f"params/{n}"] - ref[f"params/{n}"]).abs()
                      .max()) for n in names)
    top = max(float(ref[f"params/{n}"].abs().max()) for n in names)
    out["params_rel_err"] = worst / top
    out["params_excess_over_tol"] = max(
        (float(((tensors[f"params/{n}"] - ref[f"params/{n}"]).abs()
                - TOL_ZERO_PARAMS["rtol"] * ref[f"params/{n}"].abs()).max()),
         f"params/{n}") for n in names)
    ok = (out["loss_rel_err"] <= (TOL_TP if leg[1] == "tp"
                                  else TOL_ZERO_LOSS)
          and out["grads_rel_err"] <= TOL_TP)
    if leg[1:] == RESHARD_FROM[1:]:
        ok = ok and out["params_excess_over_tol"][0] <= TOL_ZERO_PARAMS["atol"]
    out["ok"] = ok
    return out


def phase_model_reshard(kernels, torch) -> None:
    """restore_resharded at GPT-2-small's width on one card (see the
    module docstring, phase 60)."""
    from tensorflow_distributed_tpu_torch.data.prefetch import to_device
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt

    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    device = torch.device(DEVICE)

    def counted_step(step, state, batch):
        sync(torch)
        for kern in kernels:
            kern.launches = 0
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        sync(torch)
        return state, loss, {k.name: k.launches for k in kernels}

    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="tfd_reshard_") as root:
        state, step, mesh, task = reshard_layout(torch, RESHARD_FROM)
        stream = task.train_stream(0)
        batches = [to_device(next(stream), device) for _ in range(2)]
        state, first_loss, launches = counted_step(step, state, batches[0])
        src = os.path.join(root, RESHARD_FROM[0])
        t0 = time.time()
        ckpt.save(src, state, mesh=mesh)
        save_s = time.time() - t0
        blob = os.path.join(ckpt._step_dir(src, 1), "state.msgpack")
        sha = written_sha256(src)
        before = whole_tensors(state)
        b1 = (state.replicas[0] if hasattr(state, "replicas")
              else state).tx.b1
        state, ref_loss, ref_launches = counted_step(step, state, batches[1])
        ref = whole_tensors(state)
        emit({"phase": "model_reshard", "leg": RESHARD_FROM[0],
              "first_loss": first_loss, "next_loss": ref_loss,
              "save_s": round(save_s, 3), "state_bytes": os.path.getsize(blob),
              "launches": launches, "next_launches": ref_launches,
              "mesh": ckpt.mesh_shape_dict(mesh)})
        check(all(launches[k] == ref_launches[k] == 12 * RESHARD_FROM[1]
                  for k in flash),
              f"model_reshard: B1-B3 not launched 12 x {RESHARD_FROM[1]} "
              f"times a step: {launches} {ref_launches}")
        del state, step
        torch.cuda.empty_cache()
        for leg in RESHARD_LEGS:
            t0 = time.time()
            state, step, mesh, _ = reshard_layout(torch, leg)
            sync(torch)
            build_s = time.time() - t0
            t0 = time.time()
            state, info = ckpt.restore_resharded(src, state, mesh=mesh)
            sync(torch)
            restore_s = time.time() - t0
            moved = leg[1:] != RESHARD_FROM[1:]
            same = None  # the same-mesh leg's bytes: not re-saved (time)
            if moved:
                again = os.path.join(root, leg[0])
                ckpt.save(again, state, mesh=mesh)
                same = written_sha256(again) == sha
                shutil.rmtree(again)
            state, loss, got = counted_step(step, state, batches[1])
            t0 = time.time()
            gates = reshard_gates(torch, leg, loss, ref_loss,
                                  whole_tensors(state), ref, before, b1)
            gates_s = time.time() - t0
            width = 2 if leg[1] == "tp" else leg[1]
            rec = {"phase": "model_reshard", "leg": leg[0], "info": info,
                   "build_s": round(build_s, 3), "gates_s": round(gates_s, 3),
                   "restore_s": round(restore_s, 3),
                   "resave_sha256_equal": same, "next_loss": loss,
                   "ref_next_loss": ref_loss, "launches": got, **gates}
            emit(rec)
            want_from = {"data": RESHARD_FROM[1], "seq": 1, "model": 1}
            check(info["resharded"] == moved and info["step"] == 1
                  and info["from_mesh"] == want_from
                  and info["to_mesh"] == ckpt.mesh_shape_dict(mesh),
                  f"model_reshard {leg[0]}: info {info}")
            check(same is not False, f"model_reshard {leg[0]}: the re-save's "
                                     f"bytes differ from the checkpoint's")
            check(gates["ok"], f"model_reshard {leg[0]}: the next step left "
                               f"the unresharded state's: {gates}")
            check(all(got[k] == 12 * width for k in flash),
                  f"model_reshard {leg[0]}: B1-B3 not launched 12 x "
                  f"{width} times a step: {got}")
            del state, step
            torch.cuda.empty_cache()
    emit({"phase": "model_reshard", "seconds": round(time.time() - t_phase,
                                                       1)})


def supervise(argv, timeout: float = TRAIN_ELASTIC_TIMEOUT_S, env=None):
    """``supervisor --elastic`` over the CLI on ``argv`` (its own process
    group, killed whole past ``timeout``; ``env`` added to this process's):
    (exit code, standard output, its JSON records, the chief's losses by
    step)."""
    cmd = [sys.executable, "-m",
           "tensorflow_distributed_tpu_torch.resilience.supervisor",
           "--elastic", "--max-restarts", "2", "--backoff-base-s", "0.2",
           "--", *argv]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env=dict(os.environ, **(env or {})))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        sys.stderr.write(out[-6000:])
        fail(f"train_elastic: the supervisor still ran after {timeout} s: "
             f"{argv}")
    return proc.returncode, out, elastic_records(out), elastic_losses(out)


def elastic_records(out: str) -> list:
    """The JSON records of a supervisor run's output (its own, behind
    ``[supervisor] ``, and its legs'). The ranks share the pipe with the
    launcher's and the collectives' own messages (and unbuffered, a
    record's text and its newline are two writes), so a line may hold a
    fragment of another message and more than one record: each is read
    where it starts."""
    recs = []
    decoder = json.JSONDecoder()
    for line in out.splitlines():
        at = line.find('{"')
        while at >= 0:
            try:
                rec, end = decoder.raw_decode(line, at)
            except ValueError:
                at = line.find('{"', at + 1)
                continue
            recs.append(rec)
            at = line.find('{"', end)
    return recs


STEP_LINE = re.compile(r"\[step +(\d+)\] .* loss=([0-9.eE+-]+|nan|inf)")


def elastic_losses(out: str) -> dict:
    """The chief's losses by step (a later leg's over an earlier one's)."""
    losses = {}
    for line in out.splitlines():
        m = STEP_LINE.search(line)
        if m:
            losses[int(m[1])] = float(m[2])
    return losses


def records_of(recs, kind: str) -> list:
    return [r for r in recs if r.get("kind") == kind]


def elastic_gates(name, rc, out, recs, losses, one, from_mesh, to_mesh,
                  resumed_at, batch_a_card) -> dict:
    """A resize leg's record and checks: exit 0, the drill's records, the
    mesh change, the reshard, the resume and the losses after it within
    TOL_RING_LOSS of one card's run (``one``: losses by step)."""
    squeeze = lambda m: {k: v for k, v in (m or {}).items() if v != 1}  # noqa: E731
    resumed = [r for r in recs if r.get("event") == "resumed"]
    after = sorted(s for s in losses if s > resumed_at)
    diff = max((abs(losses[s] - one[s]) for s in after), default=math.inf)
    rec = {"phase": "train_elastic", "leg": name, "rc": rc,
           "lost": [r.get("lost") for r in recs
                    if r.get("fault") == "device_loss"][:1],
           "mesh_change": [(squeeze(r["from_mesh"]), squeeze(r["to_mesh"]))
                           for r in records_of(recs, "mesh_change")],
           "reshard": [(squeeze(r["from_mesh"]), squeeze(r["to_mesh"]),
                        r["seconds"]) for r in records_of(recs, "reshard_restore")],
           "resumed": resumed, "steps_after": after,
           "max_loss_diff_after": diff}
    emit(rec)
    if rc != 0:
        sys.stderr.write(out[-6000:])
    check(rc == 0, f"train_elastic {name}: exit {rc}")
    check(any(squeeze(r["from_mesh"]) == from_mesh
              and squeeze(r["to_mesh"]) == to_mesh
              for r in records_of(recs, "reshard_restore")),
          f"train_elastic {name}: no reshard {from_mesh} -> {to_mesh}")
    check([r["step"] for r in resumed] == [resumed_at]
          and resumed[0]["per_device_batch"] == batch_a_card,
          f"train_elastic {name}: resumed {resumed}")
    check(bool(after) and diff <= TOL_RING_LOSS,
          f"train_elastic {name}: losses after the resize {losses} vs one "
          f"card {one}")
    return rec


def train_elastic_one_card(torch, root: str) -> None:
    """One card: the drill loses the only card; no mesh fits; the
    supervisor stops with the dead leg's code (JAX's
    test_supervisor_elastic_stops_when_no_mesh_fits, on the card)."""
    plan, step = TRAIN_ELASTIC_ONE_CARD
    ck = os.path.join(root, "one")
    # No cadence save: nothing resumes from this leg.
    rc, out, recs, losses = supervise(
        TRAIN_ELASTIC_ARGV + ["--train-steps", str(TRAIN_ELASTIC_STEPS),
                              "--mesh.data", "1", "--checkpoint-dir", ck,
                              "--checkpoint-every", "0",
                              "--resilience.fault-plan", plan])
    try:
        with open(os.path.join(ck, "DEVICE_MASK")) as f:
            mask = json.load(f)
    except (OSError, ValueError):
        mask = None
    exhausted = records_of(recs, "mesh_exhausted")
    restarts = records_of(recs, "restart")
    emit({"phase": "train_elastic", "leg": "one_card", "rc": rc,
          "mask": mask, "restarts": restarts, "mesh_exhausted": exhausted,
          "losses": losses, "legs": out.count("[supervisor] leg ")})
    if rc != 128 + signal.SIGKILL:
        sys.stderr.write(out[-6000:])
    check(rc == 128 + signal.SIGKILL,
          f"train_elastic one_card: exit {rc}, not the dead leg's "
          f"{128 + signal.SIGKILL}")
    check(mask == {"lost": 1, "step": step},
          f"train_elastic one_card: mask file {mask}")
    check([r["rc"] for r in restarts] == [-signal.SIGKILL]
          and [(r["leg"], r["alive"]) for r in exhausted] == [(1, 0)]
          and out.count("[supervisor] leg ") == 1,
          f"train_elastic one_card: restarts {restarts}, exhausted "
          f"{exhausted}")
    check(sorted(losses) == list(range(1, step)),
          f"train_elastic one_card: the leg's steps {sorted(losses)}")


def train_elastic_runs(count: int):
    """The resize legs for ``count`` cards: (name, argv, plan, from mesh,
    to mesh, resumed step, rows a card after it). Two or three cards:
    (a) at data 2 -> 1; four: (a) data 4 fsdp -> 2 and (c) data 2 x
    model 2 -> model 2."""
    plan, step = TRAIN_ELASTIC_LOSS
    if count < 4:
        return [("a_data2", ["--mesh.data", "2"],
                 f"device_loss@{step}:{count - 1}", {"data": 2}, {},
                 step - 1, 8)]
    return [("a_data4_fsdp", ["--mesh.data", "4", "--param-partition",
                              "fsdp"], plan, {"data": 4}, {"data": 2},
             step - 1, 4),
            ("c_data2_model2", ["--mesh.data", "2", "--mesh.model", "2"],
             plan, {"data": 2, "model": 2}, {"model": 2}, step - 1, 8)]


def phase_train_elastic(torch) -> None:
    """Elastic restarts through the supervisor (see the module
    docstring, phase 61)."""
    count = torch.cuda.device_count()
    # More than four cards: the supervisor (its probe, its legs) sees four.
    env = ({"CUDA_VISIBLE_DEVICES": "0,1,2,3"} if count > 4 else None)
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="tfd_elastic_") as root:
        if count == 1:
            train_elastic_one_card(torch, root)
            emit({"phase": "train_elastic",
                  "seconds": round(time.time() - t_phase, 1)})
            return
        one = dict(enumerate(one_card_losses(
            TRAIN_ELASTIC_ARGV + ["--train-steps",
                                  str(TRAIN_ELASTIC_GROWN)])[0], 1))
        for name, mesh, plan, src, dst, at, rows in train_elastic_runs(count):
            ck = os.path.join(root, name)

            def argv(steps):
                return TRAIN_ELASTIC_ARGV + mesh + [
                    "--train-steps", str(steps), "--checkpoint-dir", ck,
                    "--resilience.fault-plan", plan]

            rc, out, recs, losses = supervise(argv(TRAIN_ELASTIC_STEPS),
                                              env=env)
            elastic_gates(name, rc, out, recs, losses, one, src, dst, at,
                          rows)
            check(any(r.get("fault") == "device_loss" for r in recs)
                  and [(({k: v for k, v in r["from_mesh"].items() if v != 1}),
                        ({k: v for k, v in r["to_mesh"].items() if v != 1}))
                       for r in records_of(recs, "mesh_change")] == [(src, dst)],
                  f"train_elastic {name}: the drill or the mesh change is "
                  f"missing: {records_of(recs, 'mesh_change')}")
            if name == "a_data4_fsdp":
                # (b) the capacity comeback: the mask gone, the same run
                # goes on to TRAIN_ELASTIC_GROWN steps at data 4.
                os.remove(os.path.join(ck, "DEVICE_MASK"))
                rc, out, recs, losses = supervise(
                    argv(TRAIN_ELASTIC_GROWN) + ["--resume", "true"], env=env)
                elastic_gates("b_comeback", rc, out, recs, losses, one,
                              {"data": 2}, {"data": 4}, TRAIN_ELASTIC_STEPS,
                              2)
                check(not records_of(recs, "mesh_change")
                      and "--nproc-per-node 4" in out,
                      "train_elastic b_comeback: the leg did not run at "
                      "data 4")
        if count >= 4:
            train_elastic_sigterm(root, one, env)
    emit({"phase": "train_elastic", "seconds": round(time.time() - t_phase,
                                                       1)})


def train_elastic_sigterm(root: str, one: dict, env=None) -> None:
    """(d) ``sigterm@K`` on every rank of data 4: every rank stops at the
    agreed step K + 1, one save there, exit 0; the ``--resume`` run ends
    its steps within TOL_RING_LOSS of one card's."""
    plan, step = TRAIN_ELASTIC_SIGTERM
    ck = os.path.join(root, "d_sigterm")
    argv = TRAIN_ELASTIC_ARGV + [
        "--train-steps", str(TRAIN_ELASTIC_STEPS), "--mesh.data", "4",
        "--checkpoint-dir", ck, "--resilience.fault-plan", plan,
        "--checkpoint-every", str(TRAIN_ELASTIC_SIGTERM_EVERY)]
    rc, out, recs, _ = supervise(argv, env=env)
    stops = sorted((r.get("rank"), r["step"]) for r in recs
                   if r.get("event") == "preempted")
    saved = sorted(int(n.split("_")[1]) for n in os.listdir(ck)
                   if n.startswith("step_") and "." not in n)
    rc2, out2, recs2, losses2 = supervise(argv + ["--resume", "true"],
                                          env=env)
    after = sorted(s for s in losses2 if s > step + 1)
    diff = max((abs(losses2[s] - one[s]) for s in after), default=math.inf)
    emit({"phase": "train_elastic", "leg": "d_sigterm", "rc": rc,
          "stops": stops, "saved": saved, "resume_rc": rc2,
          "resumed": [r for r in recs2 if r.get("event") == "resumed"],
          "steps_after": after, "max_loss_diff_after": diff})
    check(rc == 0 and stops == [(r, step + 1) for r in range(4)],
          f"train_elastic d_sigterm: exit {rc}, stops {stops}")
    check(saved == [TRAIN_ELASTIC_SIGTERM_EVERY, step + 1],
          f"train_elastic d_sigterm: saves {saved}")
    check(rc2 == 0 and after == list(range(step + 2,
                                           TRAIN_ELASTIC_STEPS + 1))
          and diff <= TOL_RING_LOSS,
          f"train_elastic d_sigterm: the resume leg (exit {rc2}): "
          f"{losses2} vs one card {one}")


def run_alone(names, fa, fce, kernels, torch, np, F) -> None:
    """``--only``: the named phases of ONLY_PHASES, in the order given."""
    alone = {"ce_kernels": lambda: phase_ce_kernels(fce, torch, F),
             "model_bert": lambda: phase_model_bert(fa, torch, np),
             "train_bert": lambda: phase_train_bert(fa, kernels, torch),
             "train_text": lambda: phase_train_text(kernels, torch),
             "train_cnn_u8": lambda: phase_train_cnn_u8(kernels, torch),
             "model_resnet": lambda: phase_model_resnet(torch, np),
             "train_resnet": lambda: phase_train_resnet(kernels, torch),
             "tp_kernels": lambda: phase_tp_kernels(fa, torch),
             "model_tp": lambda: phase_model_tp(fa, torch, np),
             "train_tp": lambda: phase_train_tp(torch),
             "model_zero": lambda: phase_model_zero(kernels, torch),
             "train_zero": lambda: phase_train_zero(torch),
             "model_moe": lambda: phase_model_moe(fa, torch, np),
             "train_moe": lambda: phase_train_moe(kernels, torch),
             "serve_moe": lambda: phase_serve_moe(torch, np),
             "train_ep": lambda: phase_train_ep(torch),
             "model_pipe": lambda: phase_model_pipe(fa, torch, np),
             "train_pipe": lambda: phase_train_pipe(torch),
             "model_local_sgd": lambda: phase_model_local_sgd(kernels,
                                                              torch),
             "model_pipe_tp": lambda: phase_model_pipe_tp(fa, torch, np),
             "model_pipe_seq": lambda: phase_model_pipe_seq(fa, torch, np),
             "train_local_sgd": lambda: phase_train_local_sgd(torch),
             "train_pipe3d": lambda: phase_train_pipe3d(torch),
             "model_serve_tp": lambda: phase_model_serve_tp(torch, np),
             "serve_tp": lambda: phase_serve_tp(torch),
             "generate_tp": lambda: phase_generate_tp(torch),
             "model_reshard": lambda: phase_model_reshard(kernels, torch),
             "train_elastic": lambda: phase_train_elastic(torch),
             "serve_fleet": lambda: phase_serve_fleet(torch, np)}
    for name in names:
        alone[name]()
        lap(name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        sys.path.insert(0, REPO)
        return rank_entry(argv[1], argv[2:])
    only = None
    if argv[:1] == ["--only"]:
        only = argv[1].split(",") if len(argv) > 1 else []
        check(bool(only) and set(only) <= set(ONLY_PHASES),
              f"--only takes phases of {list(ONLY_PHASES)}, got {only}")
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, REPO)
    try:
        from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
        from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce
        from tensorflow_distributed_tpu_torch.parallel import (
            ring_attention as ra)
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS

    gpu = phase_device(torch)
    lap("device")
    phase_build(fa, fce)
    lap("build")
    if only is not None:
        run_alone(only, fa, fce, kernels, torch, np, F)
        emit({"phase": "phase_seconds", "seconds": dict(_LAPS)})
        print(gpu, flush=True)
        return 0
    flash = phase_kernels(fa, torch, F)
    lap("kernels")
    ce = phase_ce_kernels(fce, torch, F)
    lap("ce_kernels")
    phase_model(fa, torch, np)
    lap("model")
    phase_model_fused(fce, torch, np)
    lap("model_fused")
    dense = phase_train(kernels, torch)
    lap("train")
    fused = phase_train_fused(kernels, torch, dense)
    lap("train_fused")
    phase_step_profile(torch)
    lap("step_profile")
    partial = phase_ring_kernels(fa, torch, gpu)
    lap("ring_kernels")
    ring_launches = phase_ring(fa, ra, torch, gpu)
    lap("ring")
    phase_train_ring(torch)
    lap("train_ring")
    phase_model_cnn(torch, np)
    lap("model_cnn")
    phase_train_cnn(kernels, torch)
    lap("train_cnn")
    phase_train_data(torch)
    lap("train_data")
    phase_decode(fa, torch, np)
    lap("decode")
    phase_serve_identity(torch, np)
    lap("serve_identity")
    serve = phase_serve(torch)
    lap("serve")
    # The checkpoint phase's directory lives until serve_fire swaps from it.
    with tempfile.TemporaryDirectory(prefix="tfd_ckpt_") as ckpt_dir:
        phase_checkpoint(kernels, torch, ckpt_dir)
        lap("checkpoint")
        phase_eval(kernels, torch, ckpt_dir)
        lap("eval")
        phase_generate(torch, np, ckpt_dir)
        lap("generate")
        phase_serve_checkpoint(torch, ckpt_dir)
        lap("serve_checkpoint")
        phase_model_llama(fa, torch, np)
        lap("model_llama")
        phase_train_llama(kernels, torch, fused)
        lap("train_llama")
        phase_train_window(kernels, torch)
        lap("train_window")
        phase_decode_llama(fa, torch, np)
        lap("decode_llama")
        phase_serve_llama(torch, np)
        lap("serve_llama")
        phase_decode_int8(fa, torch, np)
        lap("decode_int8")
        phase_serve_paged_identity(torch, np)
        lap("serve_paged_identity")
        phase_serve_paged(torch, serve)
        lap("serve_paged")
        phase_serve_spec_identity(torch, np)
        lap("serve_spec_identity")
        phase_serve_spec(torch, serve)
        lap("serve_spec")
        phase_serve_slo(torch, np)
        lap("serve_slo")
        phase_serve_fire(torch, np, ckpt_dir, serve)
        lap("serve_fire")
        phase_serve_fleet(torch, np, ckpt_dir)
        lap("serve_fleet")
    phase_train_fire(kernels, torch)
    lap("train_fire")
    phase_model_bert(fa, torch, np)
    lap("model_bert")
    phase_train_bert(fa, kernels, torch)
    lap("train_bert")
    phase_train_text(kernels, torch)
    lap("train_text")
    phase_train_cnn_u8(kernels, torch)
    lap("train_cnn_u8")
    phase_model_resnet(torch, np)
    lap("model_resnet")
    phase_train_resnet(kernels, torch)
    lap("train_resnet")
    phase_tp_kernels(fa, torch)
    lap("tp_kernels")
    phase_model_tp(fa, torch, np)
    lap("model_tp")
    phase_train_tp(torch)
    lap("train_tp")
    phase_model_zero(kernels, torch)
    lap("model_zero")
    phase_train_zero(torch)
    lap("train_zero")
    phase_model_moe(fa, torch, np)
    lap("model_moe")
    phase_train_moe(kernels, torch)
    lap("train_moe")
    phase_serve_moe(torch, np)
    lap("serve_moe")
    phase_train_ep(torch)
    lap("train_ep")
    pipe_launches = phase_model_pipe(fa, torch, np)
    lap("model_pipe")
    phase_train_pipe(torch)
    lap("train_pipe")
    phase_model_local_sgd(kernels, torch)
    lap("model_local_sgd")
    pipe_launches.update(phase_model_pipe_tp(fa, torch, np))
    lap("model_pipe_tp")
    pipe_launches.update(phase_model_pipe_seq(fa, torch, np))
    lap("model_pipe_seq")
    phase_train_local_sgd(torch)
    lap("train_local_sgd")
    phase_train_pipe3d(torch)
    lap("train_pipe3d")
    phase_model_serve_tp(torch, np)
    lap("model_serve_tp")
    phase_serve_tp(torch)
    lap("serve_tp")
    phase_generate_tp(torch)
    lap("generate_tp")
    phase_model_reshard(kernels, torch)
    lap("model_reshard")
    phase_train_elastic(torch)
    lap("train_elastic")

    err = {"flash_fwd": flash["errors"]["o_abs_err"],
           "flash_dq": flash["errors"]["dq_abs_err"],
           "flash_dkv": flash["errors"]["dkv_abs_err"],
           "fused_ce_fwd": max(ce["errors"]["ce_abs_err"],
                               ce["errors"]["lse_abs_err"]),
           "fused_ce_dx": ce["errors"]["dx_abs_err"],
           "fused_ce_dw": ce["errors"]["dw_abs_err"],
           "flash_fwd_partial": max(partial["errors"]["o_abs_err"],
                                    partial["errors"]["m_abs_err"],
                                    partial["errors"]["l_abs_err"]),
           "flash_dq_partial": partial["errors"]["dq_abs_err"],
           "flash_dkv_partial": partial["errors"]["dkv_abs_err"]}
    rows = []
    for kern in kernels:
        name = kern.name
        if name.endswith("_partial"):
            res, launched = partial, ring_launches
        elif name.startswith("flash"):
            res, launched = flash, dense["launches"]
        else:
            res, launched = ce, fused["launches"]
        bound_ms, bound_by = res["bounds"][name]
        row = {"name": name, "route": "cuda",
               "source": SOURCES[kern.library],
               "replaces": REPLACES[name],
               "launches": launched[name],
               "max_abs_err": err[name], "ms": res["ms"][name],
               "plain_ms": res["plain_ms"][name], "bound_ms": bound_ms,
               "bound_by": bound_by,
               "library_ms": res["library_ms"][name]}
        if name in pipe_launches.get("S2_M4_gpipe", {}) or (
                name in pipe_launches.get("model_pipe_seq_gpipe", {})):
            # model_pipe's launches (stacked stages) by (S, M, schedule),
            # and model_pipe_tp's and model_pipe_seq's by schedule.
            row["model_pipe_launches"] = {leg: n[name] for leg, n in
                                          pipe_launches.items()
                                          if name in n}
        rows.append(row)
    emit({"phase": "phase_seconds", "seconds": dict(_LAPS)})
    print(gpu, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
