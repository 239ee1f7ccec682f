#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the SAM cell — the copy task at the paper's widths (controller 100,
H = K = 4, W = 32, δ = 0.005) with N = 2^20 memory rows, B = 8 and T = 42
— through the hand-written CUDA kernels: on f32 rows forward and in
training, with the exact read and with the LSH read (kind ``sam_ann``: 4
tables of 8 bits, buckets of 32, so C = 4·32 + 20 = 148 candidates per
head), and on bf16 and int8 rows forward and in training, with both
reads; then the dense
baselines (DAM, whose least-used row is the `usage_argmin` kernel, the
NTM and the LSTM) forward and in training, and the paper's comparison of
SAM against DAM and the NTM as N grows; then the SAM-augmented LM at
StarCoder2-7B's full width (`starcoder2_7b_sam`: prefill, decode with
memory states and the static `serve`), whose attention is the
`flash_attention` kernel; then the SAM cell on a memory sharded by slots
over 4 processes (`repro_torch.distributed.mem_shard`), forward and in
training on f32, bf16 and int8 rows, whose ranks sweep their blocks with
the `topk_read` kernel; then the sparse DNC
(exact and LSH) forward and in training on associative recall, and the
paper's Fig. 7 against the dense DNC; then the LM served through the
continuous-batching engine with per-user memory sessions; then the LM
trained (8 of its 32 layers at full width, AdamW); then the streaming
trainer, which carries the SAM cell's memory from chunk to chunk of long
episodes and checkpoints mid-episode, and a ~100M LM trained under the
checkpointing, retrying loop; then the sliding-window LM, H2O-Danube3-4B
+ SAM at full width (`h2o_danube_3_4b_sam`: prefill, decode with memory
states into a ring cache, `serve` and the engine), whose attention is the
`flash_attention` kernel at head dim 120 with a window of 4096; last the
vision-language LM, PaliGemma-3B + SAM at full width (`paligemma_3b_sam`:
prefill on 256 patch embeddings, decode with memory states, `serve` and
the engine), whose attention is the `flash_attention` kernel at head dim
256 with the prefix-LM over the 256; then DeepSeek-V2 + SAM at full width
and 4 of its 60 layers (`deepseek_v2_236b_sam`: MLA, the dense layer and
3 MoE layers; prefill, decode with memory states, the engine with a
rescale, `serve` and `examples.serve_batched`), whose prefill attention
is the `flash_attention` kernel at q·k 192 wide and v 128 wide; Llama-4
Maverick + SAM at full width and 2 of its 48 layers
(`llama4_maverick_400b_a17b_sam`: top-1 MoE with a shared expert, 48
padded heads over 8; the same entry points), whose prefill attention is
the `flash_attention` kernel at head dim 128; MusicGen-medium + SAM at
full width and depth on frame embeddings (`musicgen_medium_sam`: 24 MHA
heads padded to 48 at head dim 64; prefill, decode with memory states,
`serve` and `examples.serve_batched` on frames, the engine's refusal of
audio), whose prefill attention is the `flash_attention` kernel at head
dim 64, bf16 and f32; RWKV-6 7B + SAM at full width and depth
(`rwkv6_7b_sam`: the attention-free RWKV block; prefill with the WKV
loop's host share, decode with memory states, the engine with a
rescale, `serve` and the example); the served LM families trained
(`make_train_step`): Hymba-1.5B at full width and depth, RWKV-6,
PaliGemma-3B and MusicGen-medium at full width and cut depth, DeepSeek-V2's
gradients at full width, each family's reduced config on the card against
the CPU; and last the paper's memory models trained on its bAbI-lite and
one-shot Omniglot tasks. It fails (nonzero
exit) if any phase fails:

1. build the kernels from `src/repro_torch/kernels/csrc/` with nvcc for
   sm_90a and print each kernel's registers, shared memory and spills
   (none may spill in `fused_read.cu`, `usage_argmin.cu`,
   `scatter_rows.cu`, `sparse_write.cu`, `fused_read_candidates.cu`,
   `lsh_hash.cu` or `flash_attention.cu`),
   and the HMMA
   (tensor-core) instructions in each `flash_attention` kernel's SASS
   (`cuobjdump -sass`): the bf16 kernels must have them, the f32 ones
   none;
2. hold each kernel against its plain PyTorch version at full width, on
   the inputs of a real rollout: the all-zero first step and step 21 for
   the forward kernels; for `scatter_rows`, the inputs of a real backward:
   the rollback of step 21 ('set', which must also give back the memory
   before step 21's write bit for bit), the read-cotangent add ('add') and
   a case heavy in duplicates (both modes); the same on a bf16 rollout's
   step 21 (the bf16 instantiation) and, on an int8 rollout's, the
   restore of (codes, scale) pairs ('set', which must give back both) and
   the f32 kernel at W = 1 on a (B, N+1, 1) view of the scales'
   cotangent ('set' and 'add');
3. run the forward path (`SAM.forward` = `sam_unroll`) in lockstep — at
   every step the plain versions run on the inputs the kernels got and the
   outputs are compared, the rollout going on with the kernels' results —
   and check that each forward kernel's launch counter reads exactly T;
4. train (`core/training.py`, `core/unroll.py`):
   a. a sparse-rollback forward and backward through `unroll` from the
      memory the rollout left, in lockstep (every `scatter_rows` call of
      the backward is compared with its plain version on the same inputs),
      with the counters read after the forward and after the backward: the
      backward launches no O(N) kernel (read, LRA, write 0) and
      `scatter_rows` at least T times; the memory is back to the initial
      memory bit for bit; the loss and every gradient leaf are finite;
   b. the same in chunked mode with C = `suggest_chunk(...)`: gradients as
      in sparse mode within the gradient tolerance;
   c. the main path: one `make_task_train_step` step, in lockstep, with
      every counter set to 0 just before it and read just after; then
      three more RMSProp steps, and nothing may turn NaN;
   d. a small training step (N = 1000, T = 12) on the card against the
      plain versions on the CPU;
5. the LSH read (`core/ann.py`, the ``ann="lsh"`` branch of `sam_step`):
   a. `lsh_hash` and `fused_read_candidates` against their plain versions
      at full width on the inputs of a real LSH rollout, the cold first
      step and step 21, and the hash on all B·N rows of the exact
      rollout's final memory (an index rebuild: the hash's plan must
      stream there and not at the step's R = B·H and B·J);
   b. the LSH forward rollout (`SAM.forward`, T = 42, cold index) in
      lockstep; per step the hash launches twice, the candidate read, the
      LRA and the write once each, the exact sweep never;
   c. a ``sam_ann`` sparse-mode forward and backward in lockstep (the
      backward launches no read, hash, LRA or write kernel and gives the
      memory back bit for bit), chunked against sparse, the main path
      (one ``sam_ann`` `make_task_train_step` step with the counters set
      to 0 before it and read after) and a small step on the card against
      the CPU;
6. time each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one (CUDA events, L2 flushed
   before each launch), `lra_topn` also on a rank's (B, 2^18 + 1) block,
   beside the floor of an empty launch in the same timer
   (`torch.cuda._sleep(0)`), the write also on its buffers cloned at four
   other places (its time moves with them), and the write and the
   candidate read with their rows folded into 2 MB of each batch row's
   memory, the rollouts' ms per step, device time per step
   (`torch.profiler`, with the exact step's kernels by name) and peak
   memory, exact and
   LSH (each sweep's `[time]` line, here and in phases 7, 9 and 10, also
   gives the bytes its bound counts over its time in GB/s, their share of
   3.35 TB/s and its rows per second), and the train steps' ms (forward and backward apart) and peak memory, the exact one
   beside `residual_accounting(mode="sparse")` plus the one dense memory
   cotangent;
7. bf16 and int8 rows (``mem_dtype``), for each of (bf16, int8) × (exact,
   LSH), at the same widths and seed:
   a. the write and the read (the sweep or the candidate read) against
      their plain versions on the inputs of a real rollout, the cold
      first step and step 21, and the write on a case heavy in
      duplicates (every column on rows 0-2);
   b. the forward rollout (`SAM.forward`, T = 42) in lockstep, with the
      launch count of every kernel and instantiation exact: per step the
      write, the read and the LRA once, the hash twice (LSH), nothing else;
   c. each instantiation's time against its bound, the plain version's
      time, the rollout's host ms/step, device ms/step (`torch.profiler`)
      and peak memory beside the state's size;
   d. training on these rows: a sparse forward and backward from the
      rollout's final state in lockstep, with the launches of a backward
      step exact (bf16: 6 scatters on bf16 rows; int8: 2 restores of
      (codes, scale) pairs, 2 f32 scatters on the scales' cotangent and
      the replayed int8 write) and the memory (and scales) back bit for
      bit; chunked against sparse within the gradient bar; the main path
      (one `make_task_train_step` step in lockstep with the counters set
      to 0 just before it and read just after, exact, then three more
      RMSProp steps without a NaN); a small step (N = 1000, T = 12) on the
      card against the CPU (int8 within 1e-5, bf16 within BF16_GRAD_BAR of
      max(1, |g|)); the train step's ms, forward and backward apart, and
      its peak beside `residual_accounting` plus the cotangent buffer;
   e. (exact read) the bf16 scatter ('set' of step 21's rollback, 'add' of
      the read cotangent) and the int8 restore timed against their bounds,
      plain versions and `index_put_` (with ``accumulate=True`` for
      'add'; none restores codes and scales in one call);
8. the dense baselines (`core/dense.py`), at the same widths, λ = 0.99:
   a. `usage_argmin` against its plain version at (B, N) = (8, 2^20),
      indices equal, on DAM's initial usage table, the table at step 21 of
      the DAM rollout, an all-equal table, a minimum in two chunks, -0.0
      beside +0.0 (far apart, and inside one float4), a ragged N, a
      ``valid_n``, and rows of N - 3 (misaligned) with each row's minimum
      in the scalar head the kernel reads before its first float4;
   b. the DAM forward rollout (`Dense.forward`, T = 42, N = 2^20) in
      lockstep: the kernel's index equals the plain version's at every
      step; `usage_argmin` launches exactly T times and nothing else does;
   c. for each of ``dam`` (N = 2^18), ``ntm`` (N = 2^16) and ``lstm``, a
      forward and a backward with the counters read after each (DAM: T
      launches in the forward, none in the backward), the loss and every
      gradient leaf finite, the peak memory beside `dense.activation_bytes`
      times T; the main path, one `make_task_train_step` step with the
      counters set to 0 just before it and read just after, and three more
      RMSProp steps without a NaN; a small ``dam`` step (N = 1000, T = 12)
      on the card against the CPU;
   d. the paper's comparison (`benchmarks/bench_speed.py`'s setup: T = 10,
      B = 8, loss (ys**2).sum()): for SAM (exact read, sparse mode), DAM
      and the NTM at N = 2^12 ... 2^20, the forward and the forward +
      backward (host clock around synchronised runs, median of 3 after a
      warm-up), the warm-up's peak memory and SAM's speed-up; each
      configuration runs only where its byte reckoning (the state, the
      activations kept for the backward, two steps' temporaries) fits the
      free device memory, and is reported as left out otherwise;
   e. the kernel's time at step 21's table, its share of the bound, its
      plain version's and `torch.argmin`'s time and the factor against
      it; then the kernel's time again, settled (the first follows (d)'s
      release of tens of GB, after which kernels run slower a while);
9. the LM (`repro_torch.models.lm`, weights from seed 0 held in bf16,
   7.9 B parameters):
   a. `flash_attention` against its plain version at (B, S, H, Hkv, D) =
      (4, 2048, 48, 4, 128) in f32 and bf16, at a ragged S and at G = 1,
      on unit normal inputs: f32 within 2e-5, bf16 within one bf16 ulp
      of the output's magnitude;
   b. `prefill` at B = 4, S = 2048 in lockstep: every attention launch
      against its plain version (`check_flash`), every read, write and
      LRA through the checker; exactly 32 attention launches (layers 0-3
      bf16, 4-31 f32: the first memory group promotes the stream) and 32
      of each memory kernel (8 groups × 4 segments), f32 logits;
   c. `decode_scan` with memory states over a 32-token prompt, then 32
      greedy `decode_step`s, in lockstep: per token 0 attention launches
      and 8 of each memory kernel; then `serve(..., use_reduced=False)`;
   d. (run first) the reduced config at f32 compute: `prefill` and a
      memoryless `decode_scan` on the card against the plain versions on
      the CPU, within 1e-4 of max(1, |CPU|) (`tests/test_torch_lm.py`'s
      bar), where the prefill's reads hold no near-tie at K;
   e. times: the attention kernel at layer 0's and layer 4's inputs
      against its bound (bf16: q·kᵀ and the two bf16 products of p·v at
      the tensor cores' rate; f32: f32 FMAs), its share of it, its plain
      version and `scaled_dot_product_attention` (and the factor); the
      memory kernels at the LM's shapes (the row scatter's 'set' and
      'add' of J = 36 rows too); the prefill (one timed run); the decode's ms per token, a
      window of 32 greedy steps timed as one span, one window after
      one untimed (single steps, median of 3, on the
      side); their peaks and the window's device time
      (`torch.profiler`);
10. the slot-sharded memory (N = 2^20 over S = 4 ranks, one block of
   2^18 + 1 rows each):
   a. `topk_read` against its plain version at (B, H, W, K) =
      (8, 4, 32, 4) on f32, bf16 and int8 rows (with their scales): step
      21's memory, whole (2^20 + 1 rows) and as each rank's block
      (valid_n = 2^18), an all-zero memory (rows 0..3), copies of one row
      spread over both sides of a block boundary (the lowest copy first)
      and a ragged valid_n; its indices equal `fused_read_sweep`'s on the
      same rows bit for bit;
   b. S = 4 processes on this card, joined by gloo (`file://` rendezvous
      in a temporary directory; the kernels built above), run
      `sam_unroll` (T = 42) from the model's weights and phase 3's inputs
      on a memory that `init_state` builds per rank under
      `memory_mesh`: every `topk_read`, `lra_topn` and write of a rank's
      block against its plain version; per rank exactly T launches of
      each and none of `fused_read_sweep`; the ranks' ys, read words and
      indices bit-identical; then the parent holds the gathered rows,
      usage table, ys and read against phase 3's single-device rollout
      (floats within 1e-5, with the count of memory elements that are not
      bit-equal; usage and read indices exact). The same processes then
      run the rollout on bf16 and on int8 rows in lockstep (T launches of
      each kernel's bf16 or int8 instantiation), held against the
      single-device rollouts on the card (ys and floats within 1e-5;
      read indices, usage table and int8 codes exact), and one sparse
      `make_task_train_step` step (T = 42) on each of f32, bf16 and int8
      rows from the same weights and batch, in lockstep: the launches
      (T of `topk_read`, `lra_topn` and the write, 2T of the write on
      int8 rows, whose replay writes; 6T scatters, 4T on int8 rows), the
      gradients (what the clip sees) bit-identical across ranks and
      within 1e-5 of max(1, |g|) of the single-device step's (bf16 rows
      2e-2), the weights after the step (and after a second f32 step)
      bit-identical across ranks, and the bytes each rank sent per step
      in the forward and in the backward. A failed rank fails the run;
   c. times, labelled as S ranks sharing one card with gloo through the
      host (not the times of S cards): `topk_read` at both shapes on each
      row dtype against its bound and its plain version; each rank's host
      ms per step (median of 3) and the part of it inside the collectives
      beside phase 6's single-device step; rank 0's device ms per step
      (`torch.profiler`); each rank's peak memory beside its block; a
      bare all-gather of a CUDA and of a host tensor; each train step's
      host ms per rank run bare (its forward's share and the collectives'
      share) and in lockstep, and its peak;
11. the sparse DNC and the DNC (`core/dnc.py`, `SDNCCell`; paper Suppl.
   D) at the same widths with K_L = 8, on associative recall (18 items of
   2 vectors: T = 42):
   a. the SDNC's forward rollout (`DNC.forward`, N = 2^20, about 2 GiB of
      state), exact and LSH (C = 4·32 + 17 = 145 candidates), in
      lockstep, with each kernel's launches per step exact: `lra_topn`
      once (n = 1), `scatter_rows` twice (the LRA row's 'set', the 'add'
      of J = 17 rows), `fused_read_sweep` once (exact) or `lsh_hash` twice
      and `fused_read_candidates` once (LSH), nothing else;
   b. a sparse-mode forward and backward from each rollout's final state
      in lockstep: the backward launches no read, hash or LRA, only 13
      scatters a step; memory, N_t and P_t come back bit for bit; every
      gradient leaf finite; chunked (C = 14) against sparse within the
      gradient bar;
   c. the main path: one ``sdnc`` `make_task_train_step` step in
      lockstep with the counters set to 0 just before it and read just
      after, three more RMSProp steps without a NaN; a small ``sdnc`` and
      ``dnc`` step (N = 1000, T = 12, from a random memory; the DNC from
      distinct usages) on the card against the CPU;
   d. flat in N: the sparse forward's and backward's ms and the peak above
      the state at N = 2^16 and 2^20, beside `residual_accounting`;
   e. Fig. 7 (`benchmarks/bench_sdnc.py`'s setup: B = 2, R = 2, K = 4,
      W = 32, hidden 64, T = 10): forward + backward ms (median of 3
      after a warm-up) and peak of the SDNC (its default sparse engine) at
      N = 2^8, 2^12, 2^16, 2^20 and of the dense DNC where its byte reckoning fits
      (`dnc_bytes`), with the SDNC's speed-up;
   f. the rollouts' host ms per step (median of five), device ms per step
      (`torch.profiler`) and peaks;
   g. the SDNC on bf16 rows, exact and LSH: the rollout in lockstep (its
      two scatters and its read on their bf16 instantiations), then a
      sparse forward and backward from its final state in lockstep, 7 of
      the 13 scatters a backward step on bf16 rows, the memory, N_t and
      P_t back bit for bit;
12. the continuous-batching serving engine (`repro_torch.launch.engine`)
   at StarCoder2-7B's full width on phase 9's weights: 4 lanes, a cache
   of 128, two hot sessions and the rest spilled to disk:
   a. an open-loop Poisson workload (6 requests at 1 a second, prompts
      of 16-32 tokens, 8 new tokens, a quarter revisiting earlier users,
      4 sampled, each submitted at its arrival), timed: tok/s, time to
      first token and end to end (p50, p99), engine steps, host ms an
      engine step, spills and restores with their ms, lane-to-host and
      host-to-lane ms, peak memory; then the device's busy share over 4
      steps of 4 decoding lanes (`torch.profiler`);
   b. the same requests first, all submitted at once, with every kernel
      launch of the first three steps after each restore and of every
      16th step held against its plain version (the timed run's tokens
      must equal this run's, request by request, whatever lanes and
      neighbours they had); in both, the counters set to 0 before each
      `step()` and read after: 8 reads, writes and LRAs an engine step
      and nothing else;
   c. determinism: user u (sampled, a 4-token prompt) 8 tokens
      uninterrupted against 4 + 4 across two engines that share a store
      of one hot session, u spilled to disk between them, with other
      neighbours and lanes: tokens, memory states, cache, position and
      counter bit for bit; then a live `rescale` 4 -> 2 -> 4 lanes
      against an uninterrupted run, bit for bit: tokens, u's logits at
      every token counter, the session (on failure it names the products
      of a decode step that give other bits for two lanes than for the
      same two rows of four);
13. (run right after the build, while the card holds nothing else: its
   37 GB of parameters, gradients and AdamW moments and the step's
   transients do not fit beside the ~20 GB the other phases keep) the
   LM's training at StarCoder2-7B's full width with its depth cut to
   8 of 32 layers (two memory groups; 2.32 B f32 parameters, bf16
   compute, `launch.steps.make_train_step`: AdamW after one warmup step),
   one B = 4, S = 2048 batch of `data.tokens.lm_token_batches`:
   a. the attention Function's gradient at one layer's shapes (48 heads
      over 4, unit normal, bf16 and f32) against autograd through the
      plain version: f32 within 2e-5 of max(1, |g|), bf16 one bf16 ulp;
   b. at f32 compute, every parameter's gradient in the sparse, chunked
      (C = 2) and naive unrolls of the memory layers: chunked against
      sparse within 1e-5 of max(1, |g|), naive against sparse within the
      JAX suite's atol 2e-4 (of the leaf's max(1, |g|): the gradients
      reach 1e6) / rtol 1e-3; the memory zero again, bit for bit, after
      every rollback; the leaf and element of the largest naive miss of
      the bar taken elementwise, with both values; then each memory group
      on the sparse run's inputs and output cotangent, its sparse and
      naive gradients at f32 against an f64 re-implementation of the
      group on the naive run's selections (`group_f64`, which in f32 must
      agree with the naive unroll within the JAX suite's bar);
   c. the step's forward and backward in lockstep (every attention,
      read, write, LRA and scatter launch held against its plain
      version), then the train step itself (the main path), the counters
      set to 0 before each and read after: 16 attention launches (8
      bf16, 8 f32: the forward and the blocks' recompute), 8 reads,
      writes and LRAs, 48 scatters; the same loss;
   d. more steps, timed (host ms, forward, backward and optimizer apart,
      tokens/s, peak memory against 16 B a parameter, the device's busy
      share and top kernels): the loss finite and falling;
14. the streaming trainer (`core/training.py::train_task_streaming`; the
   carry kept live after each backward by `core/unroll.py::roll_forward`)
   and the checkpointed training loop (`distributed/fault_tolerance.py::
   ResilientLoop`), checkpoints in a temporary directory it removes:
   a. the copy task at the smoke's widths (N = 2^20, B = 8, f32 rows, the
      exact read), two episodes of T = 514 in chunks of 42 (13 an episode,
      the last of 10 steps), a checkpoint every 4 chunks and at each
      episode's end: the first chunk in lockstep; after every chunk the
      carry's memory and usage table equal a clone taken after the
      chunk's forward, bit for bit; each chunk's launches exact (the
      forward's read, write and LRA one a step, the backward's 6 scatters
      a step, the redo's one 'set' a step and nothing else); nothing
      turns NaN; the chunk step's host ms (forward, backward, redo apart),
      time steps trained a second, the peak against
      `residual_accounting(mode="sparse")`, the cotangent, the redo log
      and the phase's clone, and each save's ms and bytes;
   b. the same run killed after 17 chunks (episode 1, chunk 4) and
      resumed: it goes on at the newest checkpoint's chunk, and its
      history, parameters and its last two checkpoints (parameters,
      RMSProp state, carry, loop) equal (a)'s bit for bit, the first leaf
      that differs named otherwise; the restore's ms;
   c. two chunks each of ``sam_ann`` (f32), ``sam`` on int8 rows and the
      SDNC (exact, f32) at the same widths, the first in lockstep: the
      carry's buffers back bit for bit and every chunk's launches exact
      (the redo: one f32 scatter a step, or one int8 (codes, scale)
      restore on int8 rows);
   d. the ~100M LM of `examples/train_lm_100m.py` at its 65,536 slots,
      B = 4, S = 256, 20 steps under `launch.train.train(ckpt_dir=)`, a
      checkpoint every 10: a run with two `TransientError`s at step 5
      saves at step 10 the clean run's state bit for bit; stopped at step
      17, it resumes at the step after its newest checkpoint with the
      state saved there, bit for bit; the final save is on disk when the loop's `run`
      returns; step ms, the saves' blocking and writer ms and bytes;
15. the sliding-window LM, `h2o_danube_3_4b_sam` at full width (bf16
   weights from seed 0; window 4096, head dim 120, the gated SiLU MLP):
   e. first the reduced config at head dim 120 (window 32, f32) on the
      card against the CPU: a prefill, a `decode_scan` of 80 tokens into
      a ring of 32 and one `loss_fn` gradient (the windowed kernel's
      forward, the plain backward), the token seeds the first of 0-63
      whose CPU reads hold no near-tie at K; gradients within atol 2e-4 /
      rtol 1e-3, or within twice the CPU's own move under a one-ulp
      perturbation of its weights (the gradient is that ill-conditioned
      at this config);
   b. a prefill at B = 4, S = 8192 (two windows) in lockstep: 24
      attention launches at D = 120 with the window (4 bf16, 20 f32: the
      stream is f32 after the first memory group), each against its plain
      version, and 96 each of the read, write and LRA; host ms, peak,
      device-busy share;
   a. the kernel at layer 0's (bf16) and layer 4's (f32) inputs: ms
      against the bound (the window's (query, key) pairs, `attn_pairs`),
      the plain version's and `scaled_dot_product_attention`'s with the
      (S, S) window mask; the D = 120 kernels' registers and spills (none);
   c. a decode with memory states, a 112-token prompt and 32 greedy
      tokens (in lockstep) into a ring of 128 that wraps: 6 reads, writes
      and LRAs and no attention launch a token; ms a token on the host and
      the device; `serve` once past the ring's end;
   d. the engine on 4 lanes of 128: 2 requests and a user returning past
      position 128 (admitted: the cache is a ring), at once in lockstep
      with exact launches a step, then one by one through a store of one
      hot session, the returning user spilled to disk and restored in
      another engine: every token equal, its session bit for bit;
16. the vision-language LM, `paligemma_3b_sam` at full width (bf16
   weights from seed 0; head dim 256, 8 heads over one kv head padded to
   16, the GeGLU MLP, the head tied to the embedding; 18 layers, memory
   every 4, so JAX's grouping runs blocks 0-15 with memory states):
   e. first the reduced config (f32) in two variants, JAX's (head dim 32,
      4 heads over 2) and one at head dim 256 over one kv head with 4 pad
      heads, on the card against the CPU: a prefill on 16 patch
      embeddings and 48 tokens, a `decode_scan` of 24 tokens with filled
      memory states, one `loss_fn` gradient, each on the first token seed
      of 0-63 whose CPU reads hold no near-tie at K; the bars of phase 15,
      a gradient leaf beyond atol/rtol held to twice the CPU's largest own
      move over three one-ulp perturbations of its weights (one in phase
      15);
   b. a prefill at B = 4, S = 2048 (256 patch embeddings, 1792 tokens,
      the prefix 256) in lockstep: 16 attention launches at D = 256 with
      the prefix (4 bf16, 12 f32), each against its plain version, and 16
      each of the read, write and LRA; host ms, peak, device-busy share;
   a. the kernel at layer 0's (bf16) and layer 4's (f32) inputs: ms
      against the bound (the prefix's (query, key) pairs, `attn_pairs`),
      the plain version's and `scaled_dot_product_attention`'s with the
      (S, S) prefix mask, naming the backend that took it; the D = 256
      kernels' registers, spills (none) and shared memory;
   c. a decode with memory states, a 32-token prompt and 16 greedy tokens
      (in lockstep): 4 reads, writes and LRAs and no attention launch a
      token, the caches of blocks 16 and 17 untouched; ms a token on the
      host and the device; `serve` once (no memory states: all 18
      blocks);
   d. the engine on 4 lanes of 128: 4 token requests, in lockstep with
      exact launches a step;
17. DeepSeek-V2 + SAM, `deepseek_v2_236b_sam` at full width with its depth
   cut to 4 of 60 layers (bf16 weights from seed 0, 13.3 B parameters;
   MLA with 128 heads, q·k 192 (nope 128, rope 64), v 128; the dense
   layer 0, then 3 layers of 160 experts, top-6, 2 shared; one memory
   group after the 4):
   e. first the reduced config at the kernel's heads (q·k 192, v 128, 2
      heads, 3 layers, a memory group every 2; f32) on the card against
      the CPU: a prefill of 64 tokens (3 f32 attention launches at (192,
      128)) and a `decode_scan` of 24 tokens with filled memory states,
      each on the first token seed of 0-63 whose CPU reads hold no
      near-tie at K and whose routers none at k; the bars of phase 15;
   b. a prefill at B = 4, S = 2048 in lockstep: 4 bf16 attention launches
      at (192, 128), each against its plain version, and 4 each of the
      read, write and LRA; host ms, peak, device-busy share;
   a. the kernel at layer 0's inputs, bf16 and upcast to f32, each against
      its plain version: ms against the bound (q·kᵀ at 192 and p·v at 128
      a pair), the plain version's and `scaled_dot_product_attention`'s
      (each fused backend tried, the refusals printed); the (192, 128)
      kernels' registers, spills (none) and shared memory;
   c. a decode with memory states, a 32-token prompt and 16 greedy tokens
      (in lockstep): 1 read, write and LRA and no attention launch a token
      (the absorbed decode is plain PyTorch); ms a token on the host and
      the device;
   d. the engine on 4 lanes of 128: 4 token requests in lockstep with
      exact launches a step, and a rescale 4 -> 2 -> 4 lanes mid-run
      against an uninterrupted run, bit for bit; then `serve` and
      `examples.serve_batched` once each (no memory states);
18. Llama-4 Maverick + SAM, `llama4_maverick_400b_a17b_sam` at full width
   with its depth cut to 2 of 48 layers (bf16 weights from seed 0, 34.7 B
   parameters, 69.4 GB: a slice of the routed experts past 8 GiB in f32
   drawn expert by expert; 40 heads over 8 padded to 48, head dim 128; 2
   layers of 128 experts of 8192, top-1, one shared, no dense layer; one
   memory group after both). It runs right after phase 13, while the card
   is empty: its weights leave ~15 GB of the 80;
   e. first the reduced config with pad heads (10 heads over 2 padded to
      12, groups of 6 as the full config's; a memory group every 4, so one
      group after both layers; f32) on the card against the CPU: a prefill
      of 64 tokens (2 f32 attention launches) and a `decode_scan` of 24
      tokens with filled memory states, on seeds free of read near-ties
      at K and router near-ties at k; the bars of phase 15;
   b. a prefill at B = 4, S = 2048 in lockstep: 2 bf16 attention launches
      at D = 128 over 48 heads (8 pad heads computed and masked), each
      against its plain version, and 4 each of the read, write and LRA
      (one group of 4 segments); host ms, peak, device-busy share;
   a. the kernel at layer 0's inputs, bf16 and upcast to f32, each against
      its plain version: ms against the bound, the plain version's and
      `scaled_dot_product_attention`'s (causal, GQA);
   c. a decode with memory states, a 32-token prompt and 16 greedy tokens
      (in lockstep): 1 read, write and LRA and no attention launch a token;
      ms a token on the host and the device (the expert products read C =
      8 slots of all 128 experts a layer, JAX's buffer: 64.4 GB a token);
   d. the engine on 4 lanes of 128: 4 token requests in lockstep and the
      rescale 4 -> 2 -> 4 lanes bit for bit; then `serve` and
      `examples.serve_batched --arch llama4_maverick_400b_a17b_sam --full
      --layers 2` once each;
19. the paper's tasks at the benches' widths (`benchmarks/bench_babi.py`,
   `benchmarks/bench_omniglot.py`; RMSProp at 1e-3 after a clip at 10):
   ``sdnc``, ``sam`` and ``lstm`` on bAbI-lite (V = 27, hidden 128, N =
   64, W = 24, H = 2, K = 4, B = 16, L = 32; softmax cross-entropy of the
   last step) and ``sam`` and ``lstm`` on one-shot Omniglot episodes (dim
   16, 8 label channels, hidden 100, N = 256, W = 24, H = 4, K = 4, B = 8,
   2-5 classes of 5 presentations; masked cross-entropy over every step),
   5 steps each (the benches' 250 and 150 cut): the first step on a
   batch whose CPU reads hold no near-tie at K, in lockstep (every read,
   write, LRA and backward scatter against its plain version, the
   launches exact) and against the same step on the CPU (loss, every
   gradient within 1e-5 of max(1, |g|)); ms a train step and the losses
   (printed, not gated);
20. MusicGen-medium + SAM, `musicgen_medium_sam` at full width and full
   depth (bf16 weights from seed 0, 1.6 B parameters, 3.3 GB; 24 MHA
   heads padded to 48, head dim 64, the GELU MLP; a memory group every 4
   of 48 layers), the stubbed audio frontend's frames of N(0, 1) in place
   of tokens:
   e. first the reduced config with the full config's head groups (4 MHA
      heads padded to 8; f32) on the card against the CPU, on frames: a
      prefill of 64 frames and a `decode_scan` of 24 with filled memory
      states, on seeds free of read near-ties at K;
   b. a prefill at B = 4, S = 2048 in lockstep: 4 bf16 attention launches
      (the blocks before the first memory group) and 44 f32 (after it,
      where the stream is promoted) at D = 64 over 48 heads, each against
      its plain version, and 48 each of the read, write and LRA (12 groups
      of 4 segments); host ms, peak, device-busy share;
   a. the kernel at layer 0's inputs, bf16 and upcast to f32, each against
      its plain version: ms against the bound, the plain version's and
      `scaled_dot_product_attention`'s (causal, GQA);
   c. a decode with memory states, a 16-frame prompt and 16 greedy tokens,
      each fed back as ``one_hot(token, d_model)`` (in lockstep): 12 reads,
      writes and LRAs and no attention launch a token; ms a token on the
      host and the device;
   d. the engine refuses audio, as JAX's; `serve` and
      `examples.serve_batched --arch musicgen_medium --full` on frames
      once each;
21. RWKV-6 7B + SAM, `rwkv6_7b_sam` at full width and full depth (bf16
   weights from seed 0 with the leaves JAX initialises to zero drawn, 7.7
   B parameters, 15.4 GB; 32 layers of d 4096, head size 64; a memory
   group every 4 layers):
   e. first the reduced config, its zero leaves drawn (f32), on the card
      against the CPU: a prefill of 64 tokens and a `decode_scan` of 24
      with filled memory states (the logits, the three state leaves, the
      memories);
   b. a prefill at B = 4, S = 2048 in lockstep: no attention launch, 32
      each of the read, write and LRA; its host ms and peak (not
      profiled: the WKV loop's ~400,000 launches), each WKV loop timed
      between synchronisations: the loop's host share;
   c. a decode with memory states, a 16-token prompt and 16 greedy tokens
      (in lockstep): 8 reads, writes and LRAs a token; the states (wkv
      f32); ms a token on the host and the device;
   d. `layers.row_mean` (the norms' mean of squares) of a row among 4
      lanes against the same row among 2, bit for bit over 200 draws
      (`mean(-1)`'s count apart printed); the engine on 4 lanes of 128: 4
      token requests in lockstep and the rescale 4 -> 2 -> 4 lanes bit
      for bit (the states, the memories, tokens and logits);
22. Hymba-1.5B + SAM, `hymba_1_5b_sam` at full width and full depth (bf16
   weights from seed 0, 1.78 B parameters, 3.57 GB; 32 layers of d 1600,
   25 heads over 5 padded to 80 at head dim 64, a window of 1024; the SSM
   at d_inner 1600, state 16; a memory group every 4 layers), every SSM
   leaf drawn (`draw_ssm_leaves`), then the sparse top-K decode:
   e. first the reduced config with the full config's head groups (10
      heads over 2 padded to 32), its SSM leaves drawn (f32), on the card
      against the CPU: a prefill of 64 tokens (the window of 32 binds)
      and a `decode_scan` of 24 with filled memory states (the logits, k,
      v, conv, ssm, the memories);
   b. a prefill at B = 4, S = 2048 in lockstep: 32 attention launches (4
      bf16, 28 f32, each against its plain version), 32 each of the read,
      write and LRA; timed once with each SSM head and scan timed between
      synchronisations (their share), its peak and device-busy share;
   a. the attention kernel at layer 0's inputs (D = 64, window 1024,
      groups of 16), bf16 and f32, against its plain version, its time,
      bound and SDPA's with the window mask;
   c. a decode with memory states, a 16-token prompt and 16 greedy tokens
      (in lockstep): 8 reads, writes and LRAs a token, no attention; the
      cache (k, v a ring, conv bf16, ssm f32); ms a token on the host and
      the device;
   d. the engine on 4 lanes of 128: 4 token requests in lockstep and the
      rescale 4 -> 2 -> 4 lanes bit for bit; `serve` and
      `examples.serve_batched --arch hymba_1_5b_sam --full` once each;
   s. the sparse decode: the reduced `starcoder2_7b_sam` with 2 blocks of
      4 read, on the card against the CPU as (e); one `gqa_decode_sparse`
      at StarCoder2-7B's attention widths (48 heads over 4, D 128, B = 4,
      a drawn cache of 4096 slots, 8 blocks of 128 read) equal to
      `gqa_decode` where every written block is read, and both timed at
      the last position, f32 and bf16;
23. the served LM families trained (`launch.steps.make_train_step`: the
   loss by autograd through the blocks, each under `torch.utils.checkpoint`
   at full width, the memory layers through the rollback engine, the
   chunked cross-entropy, clipping, the cosine schedule, AdamW); it runs
   third, after phase 18, while the card is empty:
   a. each family's reduced config (f32: Danube at head dim 120, PaliGemma
      at head dim 256 over one kv head with pad heads, MusicGen with its
      head groups, DeepSeek-V2 at (192, 128) heads over 3 layers with a
      memory group every 2, Llama-4 with its head groups and one memory
      group, RWKV-6 and Hymba with their leaves drawn), two steps at JAX's
      default schedule on the card against the CPU on one batch of 2 × 64
      (a frontend config's from `launch.specs.concrete_batch`), the batch
      seed the first of 0-63 whose CPU reads hold no near-tie at K and
      whose routers none at k: the losses within SLICE_TOL, every gradient
      leaf within 1e-5 of max(1, max |g|) or three times the CPU's own move
      under one-ulp perturbations of its weights, the parameters after the
      steps within 1e-5; the attention, read, write, LRA and scatter
      launches exact;
   b. the attention Function's gradient at each new full-width training
      shape (B = 4, S = 2048): Hymba's (D = 64, a window of 1024, 80 heads
      over 5), PaliGemma's (D = 256, a prefix of 256, 16 heads over 1),
      MusicGen's (D = 64, 48 heads over 24) and MLA's ((192, 128), 128
      heads), bf16 and f32, against autograd through the plain version as
      phase 13 (a);
   c. full width, bf16 compute, sparse, f32 weights from seed 0 (the SSM's
      and RWKV's leaves drawn), B = 4, S = 2048: Hymba-1.5B at all 32
      layers, 3 AdamW steps; RWKV-6 7B at 4 layers, PaliGemma-3B at 8 (256
      patch embeddings and 1792 tokens) and MusicGen-medium at 12, 2 steps
      each; DeepSeek-V2 at 2 layers (the dense one and one MoE) a forward
      and backward only: each step's launches exact, ms (forward,
      backward, optimizer apart), tokens/s, peak, the device's busy share
      (torch.profiler; not for RWKV-6, whose WKV loops launch too many
      kernels to trace), the losses finite;
24. print each phase's seconds, the empty-launch floor with each
   latency-bound kernel's time
   above it (`lra_topn`, the scatter, the write at step 21 on f32, bf16
   and int8 rows and at the LM's shapes, the candidate read on f32, bf16
   and int8 rows, the hash of the written rows and of the queries), the
   card, one JSON line of per-kernel numbers (the LM's
   under ``"lm"``, the sharded memory's under ``"mesh"``, the DNC's under
   ``"dnc"``, the engine's under ``"engine"``, the LM trainer's under
   ``"lm_train"``, the streaming trainer's under ``"stream"``, the
   sliding-window LM's under ``"swa"``, the vision-language LM's under
   ``"vlm"``, DeepSeek-V2's under ``"mla"``, Llama-4's under
   ``"llama4"``, MusicGen's under ``"musicgen"``, RWKV-6's under
   ``"rwkv"``, Hymba's and the sparse decode's under ``"hymba"``, the
   families' training under ``"family_train"``, the tasks' under
   ``"tasks"``, the phases' seconds under
   ``"phase_seconds"``), and last the
   ``{"ok": true, ...}`` line.

Tolerances: integer outputs exact; forward floats within 1e-5 of
max(1, |plain|), element by element (other summation order, rsqrt
rounding: an absolute 1e-5 up to 1, relative above, where the LM's memory
rows and reads reach magnitudes of thousands and an f32 ulp exceeds
1e-5), a read word's |plain| taken as its size Σ_k w_k·|row_k| (its
rounding's scale where the K terms cancel); the bf16 and int8 writes bit
for bit
(bf16 rows, int8 codes and scales). Read indices may differ from the plain
version's only where the plain similarities of the swapped rows lie within
1e-6 of each other; each such near-tie is counted and printed. A bucket id
of the hash may differ only in bits whose plain projection lies within
1e-6·|x|·|plane| of 0; each such bit is counted and printed.
`scatter_rows` bit for bit in both modes: 'add' sums each row's columns
in the plain version's j order, so a dropped or reordered duplicate shows
even where the cotangents are tiny. Card against CPU: loss within 1e-5
relative; gradients, card against CPU and chunked against sparse, within
atol 1e-5 / rtol 1e-5, the bar of `tests/test_torch_train.py` (cuBLAS
sums the controller's products in another order than the CPU, and T
recurrent steps carry it; the runs read errors of 1e-8 and below).

The attention kernel: f32 within 2e-5 of its plain version (the JAX
suite's bar), or, where two f32 summation orders differ by more (the
LM's scores reach a standard deviation of ~144: JAX draws stacked
weights with fan_in = the layer count), no further from the f64 result
than twice the plain version is; bf16 within one bf16 ulp of the
output's magnitude (the kernel sums q·kᵀ on the tensor cores and keeps p
at f32 precision as p_hi + p_lo for p·v; both versions round one f32
result, summed in other orders).

It exits nonzero without printing a result when no CUDA device is
present or the port's sources are missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
NEAR_TIE = 1e-6
GRAD_ATOL = GRAD_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
B, T, MAX_LEN, BITS = 8, 42, 20, 8
N, W, H, K, HIDDEN, DELTA = 1 << 20, 32, 4, 4, 100, 0.005
LR = 1e-4
RECORD_STEPS = (1, 21)
REPLACES = {
    "fused_read_sweep": ("src/repro/kernels/fused_read.py:85",
                         "src/repro_torch/kernels/csrc/fused_read.cu"),
    "sparse_write_update": ("src/repro/kernels/sparse_write.py:68",
                            "src/repro_torch/kernels/csrc/sparse_write.cu"),
    "lra_topn": ("src/repro/kernels/usage_argmin.py:71",
                 "src/repro_torch/kernels/csrc/usage_argmin.cu"),
    "scatter_rows": ("src/repro/kernels/scatter_rows.py:29",
                     "src/repro_torch/kernels/csrc/scatter_rows.cu"),
    "lsh_hash": ("src/repro/kernels/lsh_hash.py:17",
                 "src/repro_torch/kernels/csrc/lsh_hash.cu"),
    "fused_read_candidates": (
        "src/repro/kernels/fused_read.py:210",
        "src/repro_torch/kernels/csrc/fused_read_candidates.cu"),
    # The storage dtypes (phase 7): instantiations of the read and write
    # kernels for bf16 and int8 rows, and the int8 write (_kernel_q).
    "sparse_write_update_bf16": (
        "src/repro/kernels/sparse_write.py:68",
        "src/repro_torch/kernels/csrc/sparse_write.cu"),
    "sparse_write_update_int8": (
        "src/repro/kernels/sparse_write.py:90",
        "src/repro_torch/kernels/csrc/sparse_write.cu"),
    "fused_read_sweep_bf16": ("src/repro/kernels/fused_read.py:85",
                              "src/repro_torch/kernels/csrc/fused_read.cu"),
    "fused_read_sweep_int8": ("src/repro/kernels/fused_read.py:85",
                              "src/repro_torch/kernels/csrc/fused_read.cu"),
    "fused_read_candidates_bf16": (
        "src/repro/kernels/fused_read.py:210",
        "src/repro_torch/kernels/csrc/fused_read_candidates.cu"),
    "fused_read_candidates_int8": (
        "src/repro/kernels/fused_read.py:210",
        "src/repro_torch/kernels/csrc/fused_read_candidates.cu"),
    # The row scatter on bf16 rows (the Pallas kernel's bf16 case) and the
    # int8 (row, scale) restore, which JAX runs through its oracle: no
    # Pallas counterpart.
    "scatter_rows_bf16": ("src/repro/kernels/scatter_rows.py:29",
                          "src/repro_torch/kernels/csrc/scatter_rows.cu"),
    "scatter_rows_int8": ("src/repro/kernels/ref.py:247",
                          "src/repro_torch/kernels/csrc/scatter_rows.cu"),
    # DAM's least-used row (phase 8).
    "usage_argmin": ("src/repro/kernels/usage_argmin.py:26",
                     "src/repro_torch/kernels/csrc/usage_argmin.cu"),
    # The LM's causal attention (phase 9).
    "flash_attention": ("src/repro/kernels/flash_attention.py:94",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # The sliding-window attention at head dim 120 (phase 15): the same
    # kernels' D = 120 instantiations with the window of chunked_attention.
    "flash_attention_swa": ("src/repro/kernels/flash_attention.py:94",
                            "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_swa_bf16": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # The prefix-LM attention at head dim 256 (phase 16): the same
    # kernels' D = 256 instantiations with chunked_attention's prefix.
    "flash_attention_vlm": ("src/repro/kernels/flash_attention.py:94",
                            "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_vlm_bf16": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # MLA's prefill attention (phase 17): the same kernels' (192, 128)
    # instantiations, v narrower than q·k (chunked_attention in mla_forward,
    # src/repro/models/attention.py:452-468).
    "flash_attention_mla": ("src/repro/kernels/flash_attention.py:94",
                            "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_mla_bf16": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # Llama-4's prefill attention (phase 18): the D = 128 instantiations at
    # 48 heads (40 real, padded) over 8 kv heads.
    "flash_attention_llama4": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_llama4_bf16": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # MusicGen's prefill attention (phase 20): the D = 64 instantiations at
    # 48 heads (24 real, padded) over 24 kv heads, bf16 before the first
    # memory group and f32 after it.
    "flash_attention_musicgen": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_musicgen_bf16": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # Hymba's prefill attention (phase 22): the D = 64 instantiations with
    # the window of 1024, 80 heads (25 real, padded: groups of 16) over 5
    # kv heads, bf16 before the first memory group and f32 after it.
    "flash_attention_hymba": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_hymba_bf16": (
        "src/repro/kernels/flash_attention.py:94",
        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    # The slot-sharded memory's top-K (phase 10): fused_read.cu's first
    # pass and a merge without the softmax tail.
    "topk_read": ("src/repro/kernels/topk_read.py:31",
                  "src/repro_torch/kernels/csrc/fused_read.cu"),
    # The same kernel on bf16 rows (the Pallas kernel sweeps the rows it
    # is given) and on int8 rows with their scales (JAX sweeps their
    # dequantized f32 view with the Pallas kernel, addressing.py:88-104).
    "topk_read_bf16": ("src/repro/kernels/topk_read.py:31",
                       "src/repro_torch/kernels/csrc/fused_read.cu"),
    "topk_read_int8": ("src/repro/kernels/topk_read.py:31",
                       "src/repro_torch/kernels/csrc/fused_read.cu"),
}
SUFFIX = {"bfloat16": "_bf16", "int8": "_int8"}
# The kernels whose ptxas report may show no spill: the exact read's sweep,
# the LRA selection and DAM's argmin, the row scatter, the writes, the
# candidate read and the hash.
NO_SPILL = ("fused_read", "usage_argmin", "scatter_rows", "sparse_write",
            "fused_read_candidates", "lsh_hash", "flash_attention")


def kernel_name(base: str, mem: torch.Tensor) -> str:
    """The REPLACES name of kernel ``base`` on ``mem``'s row dtype."""
    return base + SUFFIX.get(str(mem.dtype)[6:], "")


FORWARD = ("fused_read_sweep", "sparse_write_update", "lra_topn")
# Launches of one LSH step (the exact sweep: none).
LSH_STEP = {"lsh_hash": 2, "fused_read_candidates": 1, "lra_topn": 1,
            "sparse_write_update": 1, "fused_read_sweep": 0}
LSH = dict(ann="lsh", lsh_tables=4, lsh_bits=8, lsh_bucket_size=32)
# Phase 8, the dense baselines. Their training keeps every step's
# activations (`dense.activation_bytes`: about 2.7 (B, N, W) f32 tensors a
# step for DAM, 9.4 for the NTM), so the main-path train steps (T = 42) run
# at the largest N that fits the card; the LSTM has no memory. The
# comparison with SAM runs at bench_speed.py's T and the N of the paper's
# Fig. 1, each configuration only where its reckoning fits.
DENSE_TRAIN_N = {"dam": 1 << 18, "ntm": 1 << 16, "lstm": 0}
CMP_T = 10
CMP_NS = tuple(1 << e for e in (12, 14, 16, 18, 20))
# Phase 9, the SAM-augmented LM at StarCoder2-7B's full width (bf16
# compute; weights from seed 0 held in bf16): a prefill of B × S tokens, and
# a decode of a PROMPT-token prompt and GEN greedy tokens into a cache of
# MAX_LEN. Its memory: N = 65536 rows of W = 128, H = 4 heads, K = 8.
LM_ARCH = "starcoder2_7b_sam"
LM_B, LM_S, LM_PROMPT, LM_GEN, LM_MAX_LEN = 4, 2048, 32, 32, 128
# The decode steps a device-time profile takes (phases 9, 15–18): the
# profiler's processing of a 32-step window took ~40 s, and the whole
# smoke must stay inside its limit on a slow host.
PROFILE_STEPS = 2
FLASH_TOL = 2e-5               # the JAX suite's f32 bar for the kernel
SLICE_TOL = 1e-4               # tests/test_torch_lm.py's bar for the slice
# Phase 13, the LM's train step at StarCoder2-7B's full width with its
# depth cut to TRAIN_LAYERS of 32 (two memory groups): f32 parameters, bf16
# compute, the sparse unroll, AdamW at TRAIN_LR after TRAIN_WARMUP steps;
# one B × S batch of `lm_token_batches`, TRAIN_STEPS steps. The modes'
# gradients are compared at f32 compute, chunked with C = TRAIN_CHUNK.
TRAIN_LAYERS, TRAIN_B, TRAIN_S = 8, 4, 2048
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP, TRAIN_CHUNK = 4, 3e-4, 1, 2
NAIVE_ATOL, NAIVE_RTOL = 2e-4, 1e-3   # tests/test_unroll.py's bar
# bf16 rows' gradients, card against CPU, of max(1, |g|): the bar the CPU
# tests hold the port to against JAX on bf16 rows, twice JAX's own spread
# across its modes and backends (0.0205 at their inputs,
# tests/test_torch_dtypes.py::_bf16_bar): one bf16 rounding that drift
# flips moves a gradient by up to an ulp of the memory's cotangent.
BF16_GRAD_BAR = 2e-2
# Phase 10, the slot-sharded memory: MESH_S ranks, one block of N/MESH_S
# rows each, all on the one card, joined by gloo.
MESH_S = 4
MESH_LABEL = f"{MESH_S} ranks sharing one card, gloo through the host"
# Phase 11, the DNC and the SDNC (paper Suppl. D) at the same widths with
# K_L = 8, on associative recall: 18 items of 2 vectors, so T = 42.
DNC_KL = 8
RECALL_ITEMS, RECALL_LEN = 18, 2
# Launches of one SDNC step: the LRA row (n = 1), the write as a 'set' and
# an 'add' of J = H·K + 1 rows, the exact read or the LSH hash of the
# queries and of the written rows and the candidate read; and the
# scatters of one backward step (two rollbacks of the memory, the
# replayed write's two, the write's cotangent 'set', the two reads' and
# the two link reads' 'add's, the linkage's 'set' and 'add' in N_t's and
# P_t's cotangents).
SDNC_STEP = {"lra_topn": 1, "scatter_rows": 2, "fused_read_sweep": 1}
SDNC_LSH_STEP = {"lra_topn": 1, "scatter_rows": 2, "lsh_hash": 2,
                 "fused_read_candidates": 1}
SDNC_BWD_SCATTERS = 13
# Of those, on bf16 rows, the memory's seven run on the bf16 instantiation.
SDNC_BF16_BWD_SCATTERS = 7
SDNC_CHUNK = 14
FLAT_NS = (1 << 16, 1 << 20)
# Phase 12, the serving engine at the LM's full width on phase 9's weights:
# ENGINE_LANES lanes, a cache of ENGINE_MAX_LEN, ENGINE_CAPACITY hot
# sessions (a session's memory: 8 × (65536 + 1) × 128 f32 rows, 256 MiB),
# the rest spilled to a temporary directory; an open-loop Poisson workload
# (`benchmarks/bench_serve.py::make_workload`'s): ENGINE_REQUESTS requests
# at ENGINE_RATE a second, prompts of ENGINE_PROMPT tokens, ENGINE_GEN new
# tokens, the trailing ENGINE_REVISIT of them revisiting earlier users,
# ENGINE_SAMPLED of them sampled. Lockstep on the first
# ENGINE_AFTER_RESTORE steps after each restore and every
# ENGINE_LOCKSTEP_EVERY-th step; the busy share over ENGINE_BUSY_STEPS.
ENGINE_LANES, ENGINE_MAX_LEN, ENGINE_CAPACITY = 4, 128, 2
ENGINE_REQUESTS, ENGINE_RATE, ENGINE_SEED = 6, 1.0, 12
ENGINE_PROMPT, ENGINE_GEN, ENGINE_REVISIT, ENGINE_SAMPLED = (16, 32), 8, \
    0.25, 4
ENGINE_AFTER_RESTORE, ENGINE_LOCKSTEP_EVERY, ENGINE_BUSY_STEPS = 3, 16, 4
# Fig. 7 (`benchmarks/bench_sdnc.py`): B = 2, R = 2, K = 4, W = 32,
# hidden 64, T = 10; the dense DNC only where its reckoning fits.
FIG7_B, FIG7_T = 2, 10
FIG7_NS = tuple(1 << e for e in range(8, 21, 4))   # every fourth 2^e
# Phase 14, the streaming trainer at the smoke's widths: episodes of the
# copy task at level STREAM_LEVEL (T = 2·256 + 2 = 514: 13 chunks of
# STREAM_CHUNK, the last of 10 steps), STREAM_EPISODES of them, a
# checkpoint every STREAM_EVERY chunks; (b) kills the run after
# STREAM_STOP chunks (episode 1, chunk 4) and resumes it. (d): the ~100M LM
# of `examples/train_lm_100m.py` at its full LM100_SLOTS slots, B × S =
# LM100_B × LM100_S, LM100_STEPS steps under `ResilientLoop`, a checkpoint
# every LM100_EVERY: a clean run, and a run with two transient errors at
# step LM100_FLAKY, stopped at step LM100_STOP and resumed.
STREAM_CHUNK, STREAM_LEVEL, STREAM_EPISODES, STREAM_EVERY = 42, 256, 2, 4
STREAM_STOP = 17
LM100_SLOTS, LM100_B, LM100_S, LM100_STEPS, LM100_EVERY = 65536, 4, 256, \
    20, 10
LM100_FLAKY, LM100_STOP = 5, 17


# Phase 15, the sliding-window LM at H2O-Danube3-4B's full width (bf16
# compute; weights from seed 0 held in bf16; window 4096, head_dim 120,
# the gated SiLU MLP; memory N = 65536, W = 128, H = 4, K = 8 every 4 of 24
# layers): a prefill of SWA_B × SWA_S tokens (two windows), timed
# SWA_PREFILL_RUNS times; a decode with memory states of a SWA_PROMPT-token
# prompt and SWA_GEN greedy tokens into a ring of SWA_MAX_LEN slots, which
# wraps; the engine on SWA_LANES lanes of SWA_MAX_LEN: SWA_REQUESTS
# requests of SWA_REQ_PROMPT tokens and SWA_REQ_GEN new ones, and a user
# returning with prompts of SWA_RETURN tokens, past SWA_MAX_LEN; the
# reduced config at head_dim 120 on the card against the CPU: a prefill of
# SWA_SMALL_S tokens, a decode of SWA_SMALL_DECODE into a ring of the
# window (max_len SWA_SMALL_MAX_LEN), a loss gradient.
SWA_ARCH = "h2o_danube_3_4b_sam"
SWA_B, SWA_S, SWA_PREFILL_RUNS = 4, 8192, 1
SWA_PROMPT, SWA_GEN, SWA_MAX_LEN = 112, 32, 128
SWA_LANES, SWA_REQUESTS, SWA_REQ_PROMPT, SWA_REQ_GEN = 4, 2, (16, 32), 12
SWA_RETURN = (100, 8)
SWA_SMALL_S, SWA_SMALL_DECODE, SWA_SMALL_MAX_LEN = 128, 80, 64
# Phase 16, the vision-language LM at PaliGemma-3B's full width (bf16
# compute; weights from seed 0 held in bf16, the head tied to the
# embedding; head_dim 256, 8 heads over one kv head padded to 16, the GeGLU
# MLP; memory N = 65536, W = 128, H = 4, K = 8 every 4 of 18 layers): a
# prefill of VLM_B × VLM_S positions (256 patch embeddings, then tokens;
# the prefix-LM over the 256), timed VLM_PREFILL_RUNS times; a decode
# with memory states of a VLM_PROMPT-token prompt and VLM_GEN greedy
# tokens into a cache of VLM_MAX_LEN; the engine on VLM_LANES lanes of
# VLM_MAX_LEN: VLM_REQUESTS requests of VLM_REQ_PROMPT tokens and
# VLM_REQ_GEN new ones; the reduced config in two variants on the card
# against the CPU: a prefill on VLM_SMALL_S_T tokens after its 16 patch
# embeddings, a decode of VLM_SMALL_DECODE tokens into a cache of
# VLM_SMALL_MAX_LEN, a loss gradient.
VLM_ARCH = "paligemma_3b_sam"
VLM_B, VLM_S, VLM_PREFILL_RUNS = 4, 2048, 1
VLM_PROMPT, VLM_GEN, VLM_MAX_LEN = 32, 16, 128
VLM_LANES, VLM_REQUESTS, VLM_REQ_PROMPT, VLM_REQ_GEN = 4, 4, (8, 16), 8
VLM_SMALL_S_T, VLM_SMALL_DECODE, VLM_SMALL_MAX_LEN = 48, 24, 32
# The reduced configs' loss gradients are ill-conditioned (scores of std
# ~64 at head dim 256; the tied embedding's gradient sums the head's and
# the input's): a leaf beyond atol/rtol is held to twice the CPU's largest
# own move over this many one-ulp perturbations of its weights.
VLM_SPREAD_DRAWS = 3
# Phase 17, DeepSeek-V2 (+ SAM) at full width with its depth cut to the
# first MLA_LAYERS of 60 (the dense layer 0 and 3 MoE layers: 13.3 B
# parameters, 26.6 GB in bf16; 60 layers are 472 GB) (bf16 compute;
# weights from seed 0 held in bf16; MLA q·k 192 wide (nope 128, rope 64),
# v 128, 128 heads; 160 routed experts of 1536, top-6, 2 shared; memory N =
# 65536, W = 128, H = 4, K = 8, one group after the 4 layers): a prefill of
# MLA_B × MLA_S tokens, timed MLA_PREFILL_RUNS times; a decode with
# memory states of a MLA_PROMPT-token prompt and MLA_GEN greedy tokens
# into a cache of MLA_MAX_LEN; the engine on MLA_LANES lanes of
# MLA_MAX_LEN: MLA_REQUESTS requests of MLA_REQ_PROMPT tokens and
# MLA_REQ_GEN new ones, and a rescale of 4 -> 2 -> 4 lanes; the reduced
# config at the kernel's (192, 128) heads (MLA_SMALL) on the card against
# the CPU: a prefill of MLA_SMALL_S tokens and a decode of
# MLA_SMALL_DECODE into a cache of MLA_SMALL_MAX_LEN.
MLA_ARCH, MLA_LAYERS = "deepseek_v2_236b_sam", 4
MLA_B, MLA_S, MLA_PREFILL_RUNS = 4, 2048, 1
MLA_PROMPT, MLA_GEN, MLA_MAX_LEN = 32, 16, 128
MLA_LANES, MLA_REQUESTS, MLA_REQ_PROMPT, MLA_REQ_GEN = 4, 4, (8, 16), 8
MLA_SMALL_S, MLA_SMALL_DECODE, MLA_SMALL_MAX_LEN = 64, 24, 32
MLA_SMALL = dict(num_layers=3, num_heads=2, num_kv_heads=2, every=2,
                 kv_lora=64, q_lora=48, rope_head_dim=64, nope_head_dim=128,
                 v_head_dim=128)
# Phase 18, Llama-4 Maverick (+ SAM) at full width with its depth cut to
# the first L4_LAYERS of 48 (two MoE layers: 34.7 B parameters, 69.4 GB in
# bf16; 48 layers are 1.57 TB) (bf16 compute; weights from seed 0 held in
# bf16; 40 heads over 8 padded to 48, head dim 128; 128 routed experts of
# 8192, top-1, one shared; memory N = 65536, W = 128, H = 4, K = 8, one
# group after both layers): a prefill of L4_B × L4_S tokens, timed
# L4_PREFILL_RUNS times; a decode with memory states of a L4_PROMPT-token
# prompt and L4_GEN greedy tokens into a cache of L4_MAX_LEN; the engine
# on L4_LANES lanes of L4_MAX_LEN: L4_REQUESTS requests of L4_REQ_PROMPT
# tokens and L4_REQ_GEN new ones, and a rescale of 4 -> 2 -> 4 lanes; the
# reduced config with the full config's head groups (L4_SMALL) on the
# card against the CPU: a prefill of L4_SMALL_S tokens and a decode of
# L4_SMALL_DECODE into a cache of L4_SMALL_MAX_LEN. L4_SPARE is what the
# prefill needs beside the weights (the head upcast to f32 for the
# promoted stream, 4.1 GB, and the activations).
L4_ARCH, L4_LAYERS = "llama4_maverick_400b_a17b_sam", 2
L4_B, L4_S, L4_PREFILL_RUNS = 4, 2048, 1
L4_PROMPT, L4_GEN, L4_MAX_LEN = 32, 16, 128
L4_LANES, L4_REQUESTS, L4_REQ_PROMPT, L4_REQ_GEN = 4, 4, (8, 16), 8
L4_SMALL_S, L4_SMALL_DECODE, L4_SMALL_MAX_LEN = 64, 24, 32
L4_SMALL = dict(num_heads=10, num_kv_heads=2, pad_head_groups=6)
L4_SPARE = 8 << 30
# Phase 20, MusicGen-medium (+ SAM) at full width and full depth (bf16
# compute; weights from seed 0 held in bf16: 1.6 B parameters, 3.3 GB; 24
# MHA heads padded to 48, head dim 64, the GELU MLP; memory N = 65536, W =
# 128, H = 4, K = 8, a group every 4 of 48 layers): a prefill of MG_B ×
# MG_S frame embeddings of N(0, 1) (the stubbed audio frontend), timed
# MG_PREFILL_RUNS times; a decode with memory states of a MG_PROMPT-frame
# prompt and MG_GEN greedy tokens, each fed back as a one-hot frame, into
# a cache of MG_MAX_LEN; `serve` and `examples.serve_batched` on frames;
# the engine's refusal of audio; the reduced config with the full
# config's head groups (MG_SMALL) on the card against the CPU: a prefill
# of MG_SMALL_S frames and a decode of MG_SMALL_DECODE into a cache of
# MG_SMALL_MAX_LEN.
MG_ARCH = "musicgen_medium_sam"
MG_B, MG_S, MG_PREFILL_RUNS = 4, 2048, 1
MG_PROMPT, MG_GEN, MG_MAX_LEN = 16, 16, 128
MG_SMALL_S, MG_SMALL_DECODE, MG_SMALL_MAX_LEN = 64, 24, 32
MG_SMALL = dict(num_heads=4, num_kv_heads=4, pad_head_groups=2)
# Phase 21, RWKV-6 7B (+ SAM) at full width and full depth (bf16 compute;
# weights from seed 0 held in bf16, the leaves JAX initialises to zero
# drawn (`draw_rwkv_zero_leaves`): 7.7 B parameters, 15.4 GB; 32 layers of
# d 4096, head size 64, d_ff 14336; memory N = 65536, W = 128, H = 4, K =
# 8, a group every 4 layers): a prefill of RW_B × RW_S tokens, timed
# once (in lockstep) with the WKV loop's host share; a
# decode with memory states of a RW_PROMPT-token prompt and RW_GEN greedy
# tokens; the engine on RW_LANES lanes of RW_MAX_LEN: RW_REQUESTS
# requests of RW_REQ_PROMPT tokens and RW_REQ_GEN new ones, and a rescale
# of 4 -> 2 -> 4 lanes; the reduced config on the card against the CPU: a
# prefill of RW_SMALL_S tokens and a decode of RW_SMALL_DECODE.
RW_ARCH = "rwkv6_7b_sam"
RW_B, RW_S = 4, 2048
RW_PROMPT, RW_GEN, RW_MAX_LEN = 16, 16, 128
RW_LANES, RW_REQUESTS, RW_REQ_PROMPT, RW_REQ_GEN = 4, 4, (8, 16), 8
RW_SMALL_S, RW_SMALL_DECODE, RW_SMALL_MAX_LEN = 64, 24, 32
ROW_SUM_DRAWS = 200
# Phase 22, Hymba-1.5B (+ SAM) at full width and full depth (bf16 compute;
# weights from seed 0 held in bf16, every SSM leaf drawn
# (`draw_ssm_leaves`): 1.78 B parameters, 3.57 GB; 32 layers of d 1600,
# 25 heads over 5 padded to 80 at head dim 64, a window of 1024, the SSM
# at d_inner 1600, state 16; memory N = 65536, W = 128, H = 4, K = 8, a
# group every 4 layers): a prefill of HY_B × HY_S tokens, timed
# HY_PREFILL_RUNS times with the SSM's host share; a decode with memory
# states of a HY_PROMPT-token prompt and HY_GEN greedy tokens; the engine
# on HY_LANES lanes of HY_MAX_LEN: HY_REQUESTS requests of HY_REQ_PROMPT
# tokens and HY_REQ_GEN new ones, and a rescale of 4 -> 2 -> 4 lanes; the
# reduced config with the full config's head groups (HY_SMALL) on the
# card against the CPU: a prefill of HY_SMALL_S tokens and a decode of
# HY_SMALL_DECODE into a cache of HY_SMALL_MAX_LEN. The sparse decode:
# the reduced `starcoder2_7b_sam` with SP_SMALL, the same card-against-CPU
# run; one `gqa_decode_sparse` call at StarCoder2-7B's attention widths
# with SP_BIG (`benchmarks/perf_iterations.py`'s overrides) over a drawn
# cache of SP_SLOTS slots, SP_B lanes, at SP_EQUAL_POS (every written
# block read: equal to `gqa_decode`) and timed at the last slot.
HY_ARCH = "hymba_1_5b_sam"
HY_B, HY_S, HY_PREFILL_RUNS = 4, 2048, 1
HY_PROMPT, HY_GEN, HY_MAX_LEN = 16, 16, 128
HY_LANES, HY_REQUESTS, HY_REQ_PROMPT, HY_REQ_GEN = 4, 4, (8, 16), 8
HY_SMALL_S, HY_SMALL_DECODE, HY_SMALL_MAX_LEN = 64, 24, 32
HY_SMALL = dict(num_heads=10, num_kv_heads=2, pad_head_groups=16)
# The SSM's matrices, drawn N(0, 1/fan_in) of their own input width.
SSM_PROJECTIONS = ("in_proj", "x_proj", "dt_proj", "out_proj")
SP_SMALL = dict(sparse_decode_blocks=2, sparse_decode_block=4)
SP_BIG = dict(sparse_decode_blocks=8, sparse_decode_block=128)
SP_B, SP_SLOTS, SP_EQUAL_POS = 4, 4096, 1000
# Phase 23, the served LM families trained (`make_train_step`: the loss
# by autograd through the blocks under checkpoint, the memory layers
# through the rollback engine, clipping, the cosine schedule, AdamW):
# (a) each family's reduced config (f32; the serving phases' head
# overrides, FT_SMALL) two steps on the card against the CPU, B = 2 ×
# FT_SMALL_S positions, at JAX's default schedule (rate 3e-4, 100 warmup
# steps: the first step's rate is 0, the second's 3e-6); (b) the attention
# Function's gradient at each new full-width training shape (Hymba's,
# PaliGemma's, MusicGen's, MLA's) at B = FT_ATTN_B, S = FT_ATTN_S; (c) full width, bf16 compute, sparse,
# f32 weights from seed 0 (FT_FULL: arch, layers or None for all, B, S,
# AdamW steps, 0 for a forward and backward only, whose f32 AdamW state
# would not fit beside the 5.4 B parameters: 16 B a parameter). A leaf of
# (a) beyond GRAD_ATOL of max(1, max |g|) is held to FT_SPREAD_FACTOR
# times the CPU's own move under one-ulp perturbations of its weights
# (FT_SPREAD_DRAWS draws; tests/torch_train_parity.py's arbiter).
FT_SMALL_S = 64
FT_SMALL = (("h2o_danube_3_4b_sam", dict(head_dim=120)),
            ("paligemma_3b_sam", dict(head_dim=256, num_kv_heads=1,
                                      pad_head_groups=8)),
            ("musicgen_medium_sam", MG_SMALL),
            ("deepseek_v2_236b_sam", MLA_SMALL),
            ("llama4_maverick_400b_a17b_sam", dict(L4_SMALL, every=4)),
            ("rwkv6_7b_sam", {}),
            ("hymba_1_5b_sam", HY_SMALL))
FT_FULL = (("hymba_1_5b_sam", None, 4, 2048, 3),
           ("rwkv6_7b_sam", 4, 4, 2048, 2),
           ("paligemma_3b_sam", 8, 4, 2048, 2),
           ("musicgen_medium_sam", 12, 4, 2048, 2),
           ("deepseek_v2_236b_sam", 2, 4, 2048, 0))
FT_SPREAD_FACTOR, FT_SPREAD_DRAWS = 3, 3
FT_ATTN_B, FT_ATTN_S = 4, 2048
# `serve` in phase 20: a prompt of SERVE_PROMPT frames and SERVE_GEN new
# tokens (host-bound decodes of ~0.17 s a token).
SERVE_PROMPT, SERVE_GEN = 8, 8
# The RWKV leaves JAX's `rwkv_defs` initialises to zeros.
RWKV_ZERO_LEAVES = {"tm": ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x",
                           "mix_b", "decay_base", "decay_b", "bonus",
                           "ln_x"),
                    "cm": ("mu_k2", "mu_r2")}
# Phase 19, the paper's tasks at the benches' widths: TASK_STEPS RMSProp
# steps of each (kind, task) of TASK_RUNS (the benches' 250 and 150 cut).
# bAbI-lite (`benchmarks/bench_babi.py`): stories of BABI_LEN words, B =
# BABI_B, hidden 128 over BABI_MEM; one-shot Omniglot
# (`benchmarks/bench_omniglot.py`): episodes of 2 to OMNI_CLASSES classes
# of OMNI_P presentations, examples of OMNI_DIM, inputs padded to
# OMNI_LABELS label channels, B = OMNI_B, hidden 100 over OMNI_MEM.
TASK_STEPS, TASK_LR, TASK_CLIP = 5, 1e-3, 10.0
TASK_RUNS = (("sdnc", "babi"), ("sam", "babi"), ("lstm", "babi"),
             ("sam", "omniglot"), ("lstm", "omniglot"))
BABI_LEN, BABI_B, BABI_HIDDEN = 32, 16, 128
BABI_MEM = dict(num_slots=64, word_size=24, num_heads=2, k=4)
OMNI_DIM, OMNI_LABELS, OMNI_CLASSES, OMNI_P, OMNI_B = 16, 8, 5, 5, 8
OMNI_HIDDEN = 100
OMNI_MEM = dict(num_slots=256, word_size=24, num_heads=4, k=4)
# Scatters a SAM backward step launches (phase 6).
SAM_BWD_SCATTERS = 6
ROUTER_NEAR_TIE = 1e-6


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor, size=None) -> float:
    """max |got - want| / max(1, size), element by element, with ``size``
    |want| unless given: an absolute error where the size is at most 1, a
    relative one (the f32 ulp grows with the value) above."""
    d = (got.float() - want.float()).abs_()
    size = want.float().abs() if size is None else size.clone()
    return d.div_(size.clamp_min_(1.0)).max().item()


def hmma_counts(lib: str) -> dict | str:
    """HMMA (tensor-core) instructions per `flash_attention` kernel in the
    library's SASS, from ``cuobjdump -sass``; a string saying why not where
    the toolkit has no cuobjdump or it fails."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "cuobjdump not found"
    res = subprocess.run([tool, "-sass", lib], capture_output=True, text=True)
    if res.returncode != 0:
        return f"cuobjdump failed: {res.stderr.strip()[:200]}"
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = next((k for k in ("flash_bf16_kernel", "flash_f32_kernel")
                       if k in name), None)
            if fn:
                dims = re.search(r"ILi(\d+)ELi(\d+)E", name)
                fn += f"<{dims[1]}, {dims[2]}>"
                counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


def ptxas_summary(log: str) -> list[str]:
    keep = ("entry function", "Used", "spill")
    return [" ".join(line.replace("ptxas info    :", "").split())
            for line in log.splitlines() if any(k in line for k in keep)]


class Checker:
    """Compares each kernel call with its plain version on the same inputs
    and keeps the largest float error, the near-tie count of the reads and
    the count of hash bits near 0 that differ."""

    def __init__(self, ref):
        self.ref = ref
        self.err = {name: 0.0 for name in REPLACES}
        self.near_ties = 0
        self.near_zero_bits = 0
        self.scatter_calls = {"add": 0, "set": 0}

    def lra(self, la, n, valid_n, out):
        want = self.ref.lra_topn_ref(la[:, :valid_n], n)
        require(torch.equal(out, want), "lra_topn differs from its plain version")

    def argmin(self, usage, valid_n, out):
        """Exactly: the kernel and its plain version see the same table."""
        want = self.ref.usage_argmin_ref(usage[:, :valid_n])
        require(torch.equal(out, want), "usage_argmin differs from its plain "
                f"version: {out.tolist()} against {want.tolist()}")

    def _selection(self, name, q, mem, idx, r_idx, mem_scale=None):
        """Swapped selections only at plain similarities within NEAR_TIE
        (signed indices: -1 scores -1e9)."""
        diff = idx != r_idx
        if not diff.any():
            return

        def sims(ix):
            rows = self.ref.gather_words(mem, ix.clamp_min(0), mem_scale)
            s = torch.einsum("bhw,bhkw->bhk", self.ref._normalize(q),
                             self.ref._normalize(rows))
            return torch.where(ix < 0, -1e9, s)

        gap = (sims(idx) - sims(r_idx)).abs()[diff].max().item()
        require(gap <= NEAR_TIE, f"{name} indices differ beyond a near-tie "
                                 f"(similarity gap {gap:.3g})")
        self.near_ties += int(diff.sum().item())

    def _tail(self, name, q, mem, beta, out, mem_scale=None):
        """The floats, held against the plain tail on the kernel's rows. A
        read word is Σ_k w_k·row_k, whose rounding scales with its size
        Σ_k w_k·|row_k|: |read| where no terms cancel."""
        read, w, idx = (t.detach() for t in out)
        t_read, t_w = self.ref.sparse_read_tail(q, mem, beta, idx, mem_scale)
        rows = self.ref.gather_words(mem, idx.clamp_min(0), mem_scale)
        size = torch.einsum("bhk,bhkw->bhw", t_w, rows.abs())
        err = max(rel_err(read, t_read, size), (w - t_w).abs().max().item())
        require(err <= TOL, f"{name} float error {err:.3g}")
        require(bool((w[idx < 0] == 0).all()),
                f"{name} gave an invalid selection a weight")
        self.err[name] = max(self.err[name], err)

    def topk(self, q, mem, k, valid_n, out, mem_scale=None):
        """The selection as a read's (swaps only at near-ties), and the
        scores within TOL of the plain similarities of the rows picked, on
        their f32 view (bf16 upcast, int8 dequantized)."""
        name = kernel_name("topk_read", mem)
        vals, idx = out
        _, r_idx = self.ref.topk_read_ref(q, mem, k, valid_n=valid_n,
                                          mem_scale=mem_scale)
        self._selection(name, q, mem, idx, r_idx, mem_scale)
        rows = self.ref.gather_words(mem, idx, mem_scale)
        sims = torch.einsum("bhw,bhkw->bhk", self.ref._normalize(q),
                            self.ref._normalize(rows))
        err = (vals - sims).abs().max().item()
        require(err <= TOL, f"{name} score error {err:.3g}")
        self.err[name] = max(self.err[name], err)

    def read(self, q, mem, beta, k, valid_n, out, mem_scale=None):
        name = kernel_name("fused_read_sweep", mem)
        _, _, r_idx = self.ref.fused_read_ref(q, mem, beta, k, valid_n=valid_n,
                                              mem_scale=mem_scale)
        self._selection(name, q, mem, out[2], r_idx, mem_scale)
        self._tail(name, q, mem, beta, out, mem_scale)

    def read_cand(self, q, mem, beta, k, cand, out, mem_scale=None):
        name = kernel_name("fused_read_candidates", mem)
        r_idx = self.ref.candidate_topk(q, mem, k, cand, mem_scale)
        self._selection(name, q, mem, out[2], r_idx, mem_scale)
        self._tail(name, q, mem, beta, out, mem_scale)

    def hash(self, x, planes, out):
        """x: (R, W), out: (R, T). Bits may differ only where the plain
        projection lies within NEAR_TIE·|x|·|plane| of 0."""
        want = self.ref.lsh_hash_ref(x, planes)
        shift = torch.arange(planes.shape[1], device=x.device,
                             dtype=torch.int32)
        diff = (((out ^ want)[..., None] >> shift) & 1).bool()
        if diff.any():
            proj = torch.einsum("rw,tbw->rtb", x, planes)
            near = proj.abs() <= NEAR_TIE * (x.norm(dim=-1)[:, None, None]
                                             * planes.norm(dim=-1)[None])
            far = int((diff & ~near).sum().item())
            require(far == 0, f"lsh_hash: {far} bucket-id bits differ away "
                              f"from 0")
            self.near_zero_bits += int(diff.sum().item())

    def write(self, before, after):
        """``before``: clones of the write's arguments (mem, la, widx, ww,
        a, lra, step, delta[, mem_scale]); ``after``: the kernel's result.
        f32 rows within TOL; bf16 rows, int8 codes and scales and the usage
        table bit for bit."""
        name = kernel_name("sparse_write_update", before[0])
        m_ref, l_ref = before[0].clone(), before[1].clone()
        scale = before[8] if len(before) > 8 else None
        if scale is None:
            self.ref.sparse_write_update_ref(m_ref, l_ref, *before[2:7],
                                             delta=before[7])
        else:
            s_ref = scale.clone()
            self.ref.sparse_write_update_q_ref(m_ref, s_ref, l_ref,
                                               *before[2:7], before[7])
            require(torch.equal(after[2], s_ref),
                    f"{name}: scales differ from the plain version's")
        require(torch.equal(after[1], l_ref), f"{name} usage table differs")
        if m_ref.dtype == torch.float32:
            err = rel_err(after[0], m_ref)
            require(err <= TOL, f"{name} float error {err:.3g}")
        else:
            err = (after[0].float() - m_ref.float()).abs().max().item()
            require(torch.equal(after[0], m_ref), f"{name}: rows differ from "
                    f"the plain version's bit for bit (max err {err:.3g})")
        self.err[name] = max(self.err[name], err)

    def scatter(self, before, idx, rows, mode, after, scales=None):
        """``before``: a copy of the buffer the kernel got, which the plain
        version updates here; ``after``: the kernel's result. For int8
        rows ``scales`` is (copy of the scales the kernel got, the rows'
        scales, the kernel's scales). Bit for bit, bf16 rows compared as
        their bits."""
        name = kernel_name("scatter_rows", before)
        if scales is None:
            want = self.ref.scatter_rows_ref(before, idx.contiguous(),
                                             rows.contiguous(), mode)
        else:
            s0, rows_scale, s_after = scales
            want, s_want = self.ref.scatter_rows_q_ref(
                before, s0, idx.contiguous(), rows.contiguous(),
                rows_scale.contiguous(), mode)
            require(torch.equal(s_after, s_want), f"{name} '{mode}': scales "
                    f"differ from its plain version's")
        err = (after.float() - want.float()).abs().max().item()
        require(torch.equal(after, want), f"{name} '{mode}' differs from "
                f"its plain version (max err {err:.3g})")
        self.scatter_calls[mode] += 1


class Intercept:
    """Wraps the seven ops of `repro_torch.kernels.ops` for one run. With a
    ``checker`` every call is compared with the plain version on the same
    inputs (lockstep); with ``record`` the inputs of the steps in
    RECORD_STEPS are kept as clones (the hash's under the step: a step
    hashes twice, its query and then its written rows)."""

    def __init__(self, ops, checker=None, record=False):
        self.ops, self.checker, self.record = ops, checker, record
        self.calls = {name: 0 for name in REPLACES}
        self.records = {}

    def _keep(self, name, args, per_step=1):
        self.calls[name] += 1
        step, nth = divmod(self.calls[name] - 1, per_step)
        if self.record and step + 1 in RECORD_STEPS:
            key = (name, step + 1) if per_step == 1 else (name, step + 1, nth)
            self.records[key] = tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args)

    def __enter__(self):
        ops = self.ops
        self.saved = (ops.lra_topn, ops.fused_read, ops.sparse_write_update,
                      ops.scatter_rows, ops.lsh_hash, ops.usage_argmin,
                      ops.topk_read)
        lra0, read0, write0, scatter0, hash0, argmin0, topk0 = self.saved

        def topk_read(q, mem, k, *, valid_n=None, mem_scale=None):
            self._keep("topk_read", (q, mem, k, valid_n, mem_scale))
            out = topk0(q, mem, k, valid_n=valid_n, mem_scale=mem_scale)
            if self.checker:
                self.checker.topk(q, mem, k, valid_n, out, mem_scale)
            return out

        def lra_topn(la, n, *, valid_n=None):
            self._keep("lra_topn", (la, n, valid_n))
            out = lra0(la, n, valid_n=valid_n)
            if self.checker:
                self.checker.lra(la, n, valid_n, out)
            return out

        def usage_argmin(usage, *, valid_n=None):
            self._keep("usage_argmin", (usage, valid_n))
            out = argmin0(usage, valid_n=valid_n)
            if self.checker:
                self.checker.argmin(usage, valid_n, out)
            return out

        def fused_read(q, mem, beta, k, *, valid_n=None, cand_idx=None,
                       mem_scale=None):
            if cand_idx is not None:
                self._keep("fused_read_candidates",
                           (q, mem, beta, k, cand_idx, mem_scale))
                out = read0(q, mem, beta, k, cand_idx=cand_idx,
                            mem_scale=mem_scale)
                if self.checker:
                    self.checker.read_cand(q.detach(), mem.detach(),
                                           beta.detach(), k, cand_idx, out,
                                           mem_scale)
                return out
            self._keep("fused_read_sweep", (q, mem, beta, k, valid_n,
                                            mem_scale))
            out = read0(q, mem, beta, k, valid_n=valid_n, mem_scale=mem_scale)
            if self.checker:
                self.checker.read(q, mem, beta, k, valid_n, out, mem_scale)
            return out

        def lsh_hash(x, planes):
            self._keep("lsh_hash", (x, planes), per_step=2)
            out = hash0(x, planes)
            if self.checker:
                W = x.shape[-1]
                self.checker.hash(x.reshape(-1, W), planes,
                                  out.reshape(-1, planes.shape[0]))
            return out

        def sparse_write_update(mem, la, widx, ww, a, lra, step, *, delta,
                                mem_scale=None):
            args = (mem, la, widx, ww, a, lra, step, delta, mem_scale)
            self._keep("sparse_write_update", args)
            before = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                           for x in args) if self.checker else None
            out = write0(mem, la, widx, ww, a, lra, step, delta=delta,
                         mem_scale=mem_scale)
            if self.checker:
                self.checker.write(before, out)
            return out

        def scatter_rows(mem, idx, rows, mode="add", *, mem_scale=None,
                         rows_scale=None):
            self._keep("scatter_rows", (mem, idx, rows, mode, mem_scale,
                                        rows_scale))
            before = mem.detach().clone() if self.checker else None
            s0 = (mem_scale.clone() if self.checker and mem_scale is not None
                  else None)
            out = scatter0(mem, idx, rows, mode, mem_scale=mem_scale,
                           rows_scale=rows_scale)
            if self.checker:
                if mem_scale is None:
                    self.checker.scatter(before, idx, rows.detach(), mode,
                                         out.detach())
                else:
                    self.checker.scatter(before, idx, rows, mode, out[0],
                                         (s0, rows_scale, out[1]))
            return out

        ops.lra_topn, ops.fused_read = lra_topn, fused_read
        ops.sparse_write_update, ops.scatter_rows = (sparse_write_update,
                                                     scatter_rows)
        ops.lsh_hash, ops.usage_argmin = lsh_hash, usage_argmin
        ops.topk_read = topk_read
        return self

    def __exit__(self, *exc):
        (self.ops.lra_topn, self.ops.fused_read, self.ops.sparse_write_update,
         self.ops.scatter_rows, self.ops.lsh_hash, self.ops.usage_argmin,
         self.ops.topk_read) = self.saved
        return False


def time_ms(fn, iters, flush):
    """Median ms of single launches on the device, each after an L2 flush.
    A GPU spin after the flush holds the stream until the host has queued
    the start event, the launch and the end event, so host-side wrapper
    time never lands inside the timed window."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.add_(1.0)            # 128 MB: pushes the 50 MB L2 out
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def host_ms(fn, runs=5, setup=None):
    """Median host-clock ms of ``fn`` over ``runs`` synchronised runs, each
    after ``setup`` (outside the window); returns (median, all times)."""
    times = []
    for _ in range(runs):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def device_time(fn):
    """Device time of the kernels of one ``fn()`` traced by torch.profiler:
    (ms, [(kernel, ms, launches)] largest first). Only the device's
    activity is traced: its kernels and their times are the same as with
    the host's ops traced too, at a fraction of the processing."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_dev = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0), key=lambda r: -r[1])
    return sum(r[1] for r in on_dev), on_dev


def bound(nbytes, nops, bf16_ops=0):
    """The least ms for the work: ``nbytes`` at the HBM rate against
    ``nops`` f32 operations at the CUDA cores' rate plus ``bf16_ops`` (bf16
    products summed in f32) at the bf16 tensor cores' rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (nops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_rate(r) -> str:
    """A sweep row's achieved rate: GB/s of the bytes its bound counts,
    their share of the HBM rate, and G rows/s; '' for other kernels."""
    if "rate" not in r:
        return ""
    nbytes, nrows = r["rate"]
    return (f"; {nbytes / r['ms'] / 1e6:.1f} GB/s, "
            f"{nbytes / (r['ms'] * 1e-3) / HBM_BYTES_PER_S:.1%} of "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
            f"{nrows / r['ms'] / 1e6:.2f} G rows/s")


def unique_rows(idx) -> int:
    return len({(b, r) for b, row in enumerate(idx.tolist()) for r in row})


def fits(need: int):
    """Whether ``need`` bytes fit in what the caching allocator can still
    hand out (free device memory and its own unused blocks), with 10 %
    spare. Returns (fits, bytes available)."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    avail = free + torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    return need <= 0.9 * avail, avail


def measure(fn, new_state, need, per=1, batch=B):
    """ms per run over ``per`` (median of 3 after a warm-up) and the
    warm-up's peak memory above what is held; only ``need`` and the bytes
    available where ``need`` does not fit. ``fn`` takes a fresh state,
    ``new_state(batch)``, made outside the timed window."""
    ok, avail = fits(need)
    if not ok:
        return dict(need=need, avail=avail)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn(new_state(batch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    med, times = host_ms(fn, runs=3, setup=lambda: new_state(batch))
    return dict(ms=med / per, all=[t / per for t in times], peak=peak,
                need=need)


def dense_phase(dev, ops, ref, usage_argmin, checker, zero_counts, counts,
                flush, small_train, batch):
    """Phase 8: DAM, the NTM and the LSTM baseline (`core/dense.py`), and
    the paper's comparison of SAM against DAM and the NTM. ``batch`` is
    the copy task's (inputs, targets, mask, xs). Returns the kernel's row,
    its launches in DAM's main-path train step, and what was measured."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import dense, sam, training
    from repro_torch.core import unroll as unroll_lib
    from repro_torch.core.cell import SAMCell
    from repro_torch.core.types import ControllerConfig, MemoryConfig
    from repro_torch.optim import optimizers as opt

    inputs, targets, mask, xs = batch
    ts, ms = targets.transpose(0, 1), mask.transpose(0, 1)
    ctl = ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                           output_size=BITS)

    def mem_cfg(n):
        return MemoryConfig(num_slots=n, word_size=W, num_heads=H, k=K,
                            delta=DELTA)

    def only(name, n):
        """The launch counts of a run that launched ``name`` n times and
        nothing else."""
        want = {k: 0 for k in counts()}
        if n:
            want[name] = n
        return want

    model = dense.Dense(dense.DenseConfig(mem_cfg(N), ctl, model="dam"),
                        seed=0, device=dev)
    step21 = max(RECORD_STEPS)

    # (a) the kernel against its plain version at full width, exactly.
    with Intercept(ops, record=True) as rec:
        model(model.init_state(B), xs[:step21])
    u0 = model.init_state(B).usage
    u21 = rec.records[("usage_argmin", step21)][0]
    cpu = torch.Generator().manual_seed(8)
    rows_b = torch.arange(B)
    two = torch.rand((B, N), generator=cpu) + 1.0
    lo, hi = rows_b * 7 + 3, N // 2 + rows_b * 11     # two of 128 chunks
    two[rows_b, lo] = two[rows_b, hi] = 0.25
    signed = torch.rand((B, N), generator=cpu) + 1.0
    signed[rows_b, 40] = torch.where(rows_b % 2 == 0, -0.0, 0.0)
    signed[rows_b, 9000] = torch.where(rows_b % 2 == 0, 0.0, -0.0)
    one4 = torch.rand((B, N), generator=cpu) + 1.0    # float4 40 .. 43
    one4[rows_b, 41] = torch.where(rows_b % 2 == 0, -0.0, 0.0)
    one4[rows_b, 42] = torch.where(rows_b % 2 == 0, 0.0, -0.0)
    # Rows of N - 3 entries: row b starts b entries (mod 4) past a 16-byte
    # boundary, so the kernel reads its first (-b) mod 4 entries as a
    # scalar head; each row's minimum on the head's last entry.
    heads = [(-b * (N - 3)) % 4 for b in range(B)]
    in_head = [max(hd - 1, 0) for hd in heads]
    misaligned = torch.rand((B, N - 3), generator=cpu) + 1.0
    misaligned[rows_b, torch.tensor(in_head)] = 0.25
    cases = {
        "DAM's initial usage": (u0, None, [0] * B),
        f"step {step21} of the DAM rollout": (u21, None, None),
        "all equal": (torch.full((B, N), 0.5, device=dev), None, [0] * B),
        "a minimum in two chunks": (two.to(dev), None, lo.tolist()),
        "-0.0 and +0.0": (signed.to(dev), None, [40] * B),
        "-0.0 and +0.0 in one float4": (one4.to(dev), None, [41] * B),
        f"ragged N = {N - 3}": (u21[:, :N - 3].contiguous(), None, None),
        f"valid_n = {N - 3}": (u21, N - 3, None),
        f"a minimum in each misaligned row's head (N = {N - 3}, entries "
        f"{in_head})": (misaligned.to(dev), None, in_head),
    }
    for name, (table, valid_n, want) in cases.items():
        got = usage_argmin(table, valid_n=valid_n)
        checker.argmin(table, valid_n, got)
        require(want is None or got.tolist() == want, f"usage_argmin on "
                f"{name}: {got.tolist()}, expected {want}")
    torch.cuda.synchronize()
    print(f"[dense] usage_argmin at (B, N) = {(B, N)} equal to its plain "
          f"version on: {'; '.join(cases)} (step {step21}'s indices "
          f"{usage_argmin(u21).tolist()})")

    # (b) the DAM forward rollout (Dense.forward), in lockstep.
    zero_counts()
    with Intercept(ops, checker=checker):
        d_state, d_ys = model(model.init_state(B), xs)
    torch.cuda.synchronize()
    rollout_launches = counts()
    require(rollout_launches == only("usage_argmin", T), f"the DAM rollout "
            f"launched {rollout_launches}, expected usage_argmin {T} times "
            f"and nothing else")
    read_sum_err = (d_state.read_w.sum(-1) - 1).abs().max().item()
    require(d_ys.shape == (T, B, BITS) and torch.isfinite(d_ys).all().item()
            and all(torch.isfinite(t).all().item() for t in d_state[:5])
            and read_sum_err <= 1e-4 and int(d_state.step) == T,
            "DAM outputs or state not finite, of the wrong shape, or read "
            "weights that do not sum to 1")
    print(f"[dense] DAM rollout (T={T}, N={N}) in lockstep: usage_argmin "
          f"launched {rollout_launches['usage_argmin']} times, equal to its "
          f"plain version at every step, no other kernel; outputs finite; "
          f"read weights sum to 1 within {read_sum_err:.3g}")
    del d_state, d_ys
    # Where a dense step's time goes: the kernels of a 3-step forward at
    # full width traced by torch.profiler (the state made outside it).
    breakdown = {}
    for kind in ("dam", "ntm"):
        m = model if kind == "dam" else dense.Dense(
            dense.DenseConfig(mem_cfg(N), ctl, model=kind), seed=0,
            device=dev)
        s0 = m.init_state(B)
        torch.cuda.synchronize()
        d_ms, on_dev = device_time(lambda: m(s0, xs[:3]))
        breakdown[kind] = dict(device_ms_per_step=d_ms / 3, kernels=[
            (name[:90], t / 3, n / 3) for name, t, n in on_dev[:8]])
        print(f"[dense] {kind} forward at N={N}: {d_ms / 3:.3f} ms of "
              f"kernels per step (torch.profiler, 3 steps); by kernel "
              f"(ms/step, launches/step): " + "; ".join(
                  f"{name} {t:.3f} ({n:.0f})"
                  for name, t, n in breakdown[kind]["kernels"]))
        del s0, m
    # ... and of a 2-step DAM forward and backward.
    leaves, tdef = pytree.tree_flatten(model.params())
    leaves = [p.detach().clone().requires_grad_() for p in leaves]
    s0 = model.init_state(B)
    torch.cuda.synchronize()
    d_ms, on_dev = device_time(lambda: torch.autograd.grad(
        dense.dense_unroll(pytree.tree_unflatten(leaves, tdef), model.cfg,
                           s0, xs[:2])[1].square().sum(), leaves))
    breakdown["dam_fwd_bwd"] = dict(device_ms_per_step=d_ms / 2, kernels=[
        (name[:90], t / 2, n / 2) for name, t, n in on_dev[:8]])
    print(f"[dense] dam forward + backward at N={N}: {d_ms / 2:.3f} ms of "
          f"kernels per step (torch.profiler, 2 steps); by kernel "
          f"(ms/step, launches/step): " + "; ".join(
              f"{name} {t:.3f} ({n:.1f})"
              for name, t, n in breakdown["dam_fwd_bwd"]["kernels"]))
    del s0, leaves

    # (c) training: forward and backward apart, then the main path (one
    # make_task_train_step step) and three more RMSProp steps.
    train = {}
    for kind, n in DENSE_TRAIN_N.items():
        spec = training.ModelSpec(kind, mem_cfg(n or N), ctl)
        reckoning = (T * dense.activation_bytes(dense.DenseConfig(
            spec.memory, ctl, model=kind), B) if n else 0)
        ok, avail = fits(3 * reckoning // 2)
        require(ok, f"the {kind} train step's reckoning {reckoning} B does "
                f"not fit the {avail} B available")
        init_p, init_s, unroll = training.build_model(spec, device=dev)
        params = init_p(torch.Generator().manual_seed(0))
        leaves, tdef = pytree.tree_flatten(params)
        leaves = [p.clone().requires_grad_() for p in leaves]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        with Intercept(ops, checker=checker):
            _, ys_k = unroll(pytree.tree_unflatten(leaves, tdef), init_s(B), xs)
            loss = training.bits_loss(ys_k, ts, ms)
            torch.cuda.synchronize()
            fwd = counts()
            zero_counts()
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            bwd = counts()
        peak = torch.cuda.max_memory_allocated() - held
        per = T if kind == "dam" else 0
        require(fwd == only("usage_argmin", per) and bwd == only("usage_argmin", 0),
                f"{kind}: forward launched {fwd}, backward {bwd}; expected "
                f"usage_argmin {per} times in the forward and nothing else")
        require(torch.isfinite(loss).item() and all(
            torch.isfinite(g).all().item() for g in grads),
            f"a {kind} loss or gradient leaf is not finite")
        del ys_k, loss, grads
        _, _, fn = training.make_task_train_step(spec, LR, device=dev)
        opt_state = opt.rmsprop_init(params)
        zero_counts()
        with Intercept(ops, checker=checker):
            p1, o1, loss, err = fn(params, opt_state, inputs, targets, mask)
        torch.cuda.synchronize()
        launched = counts()
        require(launched == only("usage_argmin", per), f"{kind} train step "
                f"launched {launched}")
        losses = [loss.item()]
        for _ in range(3):
            p1, o1, loss, _ = fn(p1, o1, inputs, targets, mask)
            losses.append(loss.item())
            require(torch.isfinite(loss).item() and all(
                torch.isfinite(p).all().item()
                for p in pytree.tree_leaves((p1, o1))),
                f"a {kind} RMSProp step produced a NaN or an infinity")
        train[kind] = dict(n=n, launches=launched, peak_bytes=peak,
                           reckoning_bytes=reckoning, losses=losses)
        print(f"[dense-train] {kind} (N={n or '-'}, T={T}): forward launches "
              f"usage_argmin {fwd['usage_argmin']} times, backward nothing; "
              f"loss and {len(leaves)} gradient leaves finite; peak "
              f"{peak} B against the reckoning T·activation_bytes "
              f"{reckoning} B; main path (one make_task_train_step step) "
              f"launched usage_argmin {launched['usage_argmin']} times; four "
              f"RMSProp steps, losses {losses}: all finite")
        del params, leaves, p1, o1, opt_state
    small_grad_err = small_train("dam")

    # (d) the paper's comparison (bench_speed.py's setup): forward and
    # forward+backward of SAM (exact read, sparse mode), DAM and the NTM.
    xs_c = torch.randn((CMP_T, B, BITS + 2),
                       generator=torch.Generator().manual_seed(7)).to(dev)

    def runners(kind, n):
        """(new_state, forward, fwd_bwd, state bytes, activation bytes
        kept for the backward, per-step transient bytes)."""
        if kind == "sam":
            cfg_k = sam.SAMConfig(mem_cfg(n), ctl)
            fwd_model = sam.SAM(cfg_k, seed=0, device=dev)
            cell = SAMCell(cfg_k)
            state_b = 4 * B * (n + 1) * (W + 1)
            act = 0
        else:
            cfg_k = dense.DenseConfig(mem_cfg(n), ctl, model=kind)
            fwd_model = dense.Dense(cfg_k, seed=0, device=dev)
            state_b = 4 * B * n * (W + 1 + 2 * H)
            act = dense.activation_bytes(cfg_k, B)
        flat, spec_p = pytree.tree_flatten(fwd_model.params())
        leaves = [p.detach().clone().requires_grad_() for p in flat]
        p_req = pytree.tree_unflatten(leaves, spec_p)

        def forward(s):
            fwd_model(s, xs_c)

        def fwd_bwd(s):
            if kind == "sam":
                _, ys_k = unroll_lib.unroll(cell, p_req, s, xs_c,
                                            mode="sparse")
            else:
                _, ys_k = dense.dense_unroll(p_req, cfg_k, s, xs_c)
            torch.autograd.grad((ys_k ** 2).sum(), leaves)

        if kind == "sam":   # the sparse backward's residuals, and the one
            #                 dense memory cotangent
            kept = (unroll_lib.residual_accounting(
                cell, p_req, fwd_model.init_state(1), xs_c[:, :1],
                mode="sparse")["residual_bytes"] * B + state_b)
        else:
            kept = CMP_T * act
        return fwd_model.init_state, forward, fwd_bwd, state_b, kept, act

    table = []
    for n in CMP_NS:
        for kind in ("sam", "dam", "ntm"):
            new_state, forward, fwd_bwd, state_b, kept, act = runners(kind, n)
            r = dict(model=kind, n=n, state_bytes=state_b, kept_bytes=kept,
                     fwd=measure(forward, new_state, 2 * state_b + 2 * act,
                                 per=CMP_T),
                     fwd_bwd=measure(fwd_bwd, new_state,
                                     state_b + kept + 2 * act))
            table.append(r)
    sam_of = {r["n"]: r for r in table if r["model"] == "sam"}
    for r in table:
        cells = []
        for what in ("fwd", "fwd_bwd"):
            m = r[what]
            if "ms" not in m:
                cells.append(f"{what} left out (needs {m['need']} B, "
                             f"{m['avail']} B available)")
                continue
            ratio = m["ms"] / sam_of[r["n"]][what]["ms"]
            m["sam_speedup"] = ratio
            unit = " ms/step" if what == "fwd" else " ms"
            cells.append(f"{what} {m['ms']:.3f}{unit} (of "
                         f"{', '.join(f'{t:.3f}' for t in m['all'])}), peak "
                         f"{m['peak']} B" + (f", {ratio:.2f}x SAM's"
                                             if r["model"] != "sam" else ""))
        print(f"[compare] {r['model']} N={r['n']} (B={B}, T={CMP_T}): "
              + "; ".join(cells) + f"; state {r['state_bytes']} B, kept for "
              f"the backward {r['kept_bytes']} B")

    # (e) the kernel's time at step 21's table. (d) has just released
    # tens of GB (`fits` empties the allocator's cache), and kernels
    # timed right after such a release run slower for a while; the first
    # time is the row's, as in earlier runs, and the kernel is timed
    # again after its plain version and torch.argmin, settled.
    row = dict(ms=time_ms(lambda: usage_argmin(u21), 50, flush),
               plain_ms=time_ms(lambda: ref.usage_argmin_ref(u21), 20, flush),
               library_ms=time_ms(lambda: torch.argmin(u21, dim=-1), 50,
                                  flush),
               bound=bound(4 * (B * N + B), B * N))
    settled_ms = time_ms(lambda: usage_argmin(u21), 50, flush)
    print(f"[time] usage_argmin: {row['ms']:.4f} ms (bound "
          f"{row['bound'][0]:.6f} ms by {row['bound'][1]}: "
          f"{row['bound'][0] / row['ms']:.1%} of it), plain "
          f"{row['plain_ms']:.4f} ms, library torch.argmin "
          f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}x "
          f"its time); timed again after those: {settled_ms:.4f} ms "
          f"({row['bound'][0] / settled_ms:.1%} of the bound)")
    return dict(row=row, settled_ms=settled_ms,
                launches=train["dam"]["launches"],
                rollout_launches=rollout_launches, breakdown=breakdown,
                train=train,
                card_vs_cpu_grad_err=small_grad_err, comparison=table)


def bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude max |x|."""
    _, e = torch.frexp(x.float().abs().max())
    return 2.0 ** (int(e) - 8)


def check_flash(ref, q, k, v, out, window=None, prefix=0) -> dict:
    """The attention kernel's output against its plain version on the same
    inputs (and window and prefix): bf16 within one bf16 ulp of the output's
    magnitude; f32 within FLASH_TOL, or, where the two f32 versions differ
    by more (scores as large as the LM's: two f32 summation orders then
    differ by ~1e-3), no further from the f64 result than twice the plain
    version is."""
    want = ref.flash_attention_ref(q, k, v, window, prefix)
    err = (out.float() - want.float()).abs().max().item()
    r = {"err": err}
    if q.dtype == torch.bfloat16:
        require(err <= bf16_ulp(want), f"flash_attention (bf16) differs from "
                f"its plain version by {err:.3g}, above one bf16 ulp "
                f"{bf16_ulp(want):.3g}")
    elif err > FLASH_TOL:
        del want
        exact = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                        window, prefix)
        r["exact_err"] = (out.double() - exact).abs().max().item()
        r["plain_exact_err"] = (ref.flash_attention_ref(
            q, k, v, window, prefix).double() - exact).abs().max().item()
        require(r["exact_err"] <= 2 * r["plain_exact_err"] + FLASH_TOL,
                f"flash_attention (f32) is {r['exact_err']:.3g} from the f64 "
                f"result, the plain version {r['plain_exact_err']:.3g}")
    return r


class FlashCheck:
    """Wraps `ops.flash_attention` for one run: every launch is held against
    the plain version (`check_flash`), and the inputs of the launches whose
    ordinal is in ``keep`` are kept."""

    def __init__(self, ops, ref, keep=()):
        self.ops, self.ref, self.keep = ops, ref, keep
        self.checks, self.kept = [], {}

    def __enter__(self):
        self.saved = self.ops.flash_attention

        def flash_attention(q, k, v, **kw):
            out = self.saved(q, k, v, **kw)
            n = len(self.checks)
            with torch.no_grad():
                if n in self.keep:
                    self.kept[n] = tuple(t.detach().contiguous().clone()
                                         for t in (q, k, v))
                check = check_flash(self.ref, q.detach().contiguous(),
                                    k.detach().contiguous(),
                                    v.detach().contiguous(), out.detach(),
                                    kw.get("window"), kw.get("prefix", 0))
            self.checks.append(dict(check, dtype=q.dtype,
                                    window=kw.get("window"),
                                    prefix=kw.get("prefix", 0)))
            return out

        self.ops.flash_attention = flash_attention
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.saved
        return False


def stable_reads(ref, reads, margin=NEAR_TIE) -> bool:
    """Whether no read of ``reads`` ((q, memory, k, valid_n) each) has a row
    within ``margin`` of its K-th similarity (f64) that could trade places
    across the K boundary: rows in that band either all lie in the top K
    or are equal (equal rows are ordered by index everywhere)."""
    for q, mem, k, valid_n in reads:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= margin
        straddles = (sims > v + margin).sum(-1) + band.sum(-1) > k
        if (straddles & (band & (sims != v)).any(-1)).any():
            return False
    return True


def card_close(a, b, what) -> float:
    """The card's ``a`` against the CPU's ``b``: |a - b| <= SLICE_TOL ·
    max(1, max |b|); returns the error."""
    a, b = a.float().cpu(), b.float().cpu()
    err = (a - b).abs().max().item()
    scale = max(1.0, b.abs().max().item())
    require(err <= SLICE_TOL * scale, f"{what}: card against CPU "
            f"{err:.3g} above {SLICE_TOL} x {scale:.3g}")
    return err


def lm_phase(dev, ops, ref, checker, zero_counts, counts, flush):
    """Phase 9: the SAM-augmented LM's serving forward at StarCoder2-7B's
    full width. Returns the attention kernel's row (f32, with its bf16
    instantiation as a sub-row), the prefill's launches and the numbers."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_read import fused_read_sweep
    from repro_torch.kernels.scatter_rows import scatter_rows
    from repro_torch.kernels.sparse_write import sparse_write_update
    from repro_torch.kernels.usage_argmin import lra_topn
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map

    cfg = get_config(LM_ARCH)
    m = cfg.memory
    N_, W_, H_, K_ = m.num_slots, m.word_size, m.num_heads, m.k
    groups = cfg.num_layers // m.every_n_layers
    segments = LM_S // m.segment
    out = {}

    # (d) first, at the reduced config in f32: the card against the plain
    # versions on the CPU (prefill; a decode without memory, whose
    # memory-carrying counterpart is held in lockstep in (c)).
    small = dataclasses.replace(reduced(cfg), compute_dtype="float32")
    p_cpu = lm.init_params(small, seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    toks_s = torch.randint(0, small.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    seen, fused_read = [], ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        seen.append((q.clone(), mem.clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    ops.fused_read = record
    try:
        want = lm.prefill(p_cpu, small, {"tokens": toks_s})
    finally:
        ops.fused_read = fused_read
    require(stable_reads(ref, seen), "the reduced prefill's reads hold a "
            "near-tie at K: card against CPU is undecidable there")
    got = lm.prefill(p_gpu, small, {"tokens": toks_s.to(dev)})
    errs = {"prefill": card_close(got, want, "prefill logits")}
    res = {}
    for name, p_, d_ in (("cpu", p_cpu, "cpu"), ("cuda", p_gpu, dev)):
        cache = lm.init_cache(small, 2, 16, device=d_)
        res[name] = lm.decode_scan(p_, small, cache, toks_s[:, :8].to(d_))
    errs["decode"] = card_close(res["cuda"][0], res["cpu"][0], "decode logits")
    errs["cache"] = max(card_close(res["cuda"][1][kk], res["cpu"][1][kk], kk)
                        for kk in ("k", "v"))
    torch.cuda.synchronize()
    out["card_vs_cpu_err"] = errs
    print(f"[lm] reduced {LM_ARCH} (f32 compute) on the card against the "
          f"CPU: prefill logits {errs['prefill']:.3g}, decode logits "
          f"{errs['decode']:.3g}, caches {errs['cache']:.3g} (bar {SLICE_TOL} "
          f"of max(1, |CPU|)); the prefill's {len(seen)} reads hold no "
          f"near-tie at K")
    del p_cpu, p_gpu, seen, res

    # (a) the kernel against its plain version at full width: StarCoder2's
    # heads (48 over 4: G = 12) at a ragged S and G = 1, unit normal.
    gen = torch.Generator().manual_seed(8)
    for Bq, S_, Hq, Hk, dtype in ((LM_B, LM_S, 48, 4, torch.float32),
                                  (LM_B, LM_S, 48, 4, torch.bfloat16),
                                  (2, LM_S - 61, 48, 4, torch.float32),
                                  (LM_B, LM_S, 4, 4, torch.float32)):
        q = torch.randn((Bq, S_, Hq, 128), generator=gen).to(dev, dtype)
        k = torch.randn((Bq, S_, Hk, 128), generator=gen).to(dev, dtype)
        v = torch.randn((Bq, S_, Hk, 128), generator=gen).to(dev, dtype)
        r = check_flash(ref, q, k, v, flash_attention(q, k, v))
        require(dtype == torch.bfloat16 or r["err"] <= FLASH_TOL,
                f"flash_attention on unit normal inputs: {r['err']:.3g}")
        torch.cuda.synchronize()
        print(f"[lm] flash_attention (B, S, H, Hkv, D) = "
              f"{(Bq, S_, Hq, Hk, 128)} {str(dtype)[6:]}, unit normal: max "
              f"err {r['err']:.3g} against its plain version")
        del q, k, v

    # (b) the prefill at full width, in lockstep.
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    out.update(params=n_params, param_bytes=param_bytes)
    print(f"[lm] {LM_ARCH}: {n_params} parameters, {param_bytes} B in bf16, "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab_size, (LM_B, LM_S),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    zero_counts()
    with torch.inference_mode(), Intercept(ops, checker=checker), \
            FlashCheck(ops, ref, keep=(0, m.every_n_layers)) as fc:
        logits = lm.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    launched = counts()
    want_counts = {name: 0 for name in launched}
    want_counts.update({"flash_attention": cfg.num_layers,
                        **{name: groups * segments for name in FORWARD}})
    require(launched == want_counts, f"prefill launches {launched}, expected "
            f"{want_counts}")
    require(logits.dtype == torch.float32
            and logits.shape == (LM_B, 1, cfg.vocab_size)
            and torch.isfinite(logits).all().item(),
            "prefill logits are not finite f32 of shape (B, 1, V)")
    q0, k0, v0 = fc.kept[0]
    q4, k4, v4 = fc.kept[m.every_n_layers]
    require(q0.dtype == torch.bfloat16 and q4.dtype == torch.float32,
            f"layer 0 ran {q0.dtype}, layer 4 {q4.dtype}: expected bf16, "
            f"then f32 after the first memory group")
    flash_err = max(c["err"] for c in fc.checks)
    conditioned = [c for c in fc.checks if "exact_err" in c]
    bf16_errs = [c["err"] for c in fc.checks[:m.every_n_layers]]
    out.update(prefill_launches=launched,
               flash_bf16_max_err=max(bf16_errs),
               flash_f32_max_err=max(c["err"] for c in
                                     fc.checks[m.every_n_layers:]),
               flash_f32_above_tol=len(conditioned),
               flash_f32_exact_err=max((c["exact_err"] for c in conditioned),
                                       default=None),
               flash_f32_plain_exact_err=max(
                   (c["plain_exact_err"] for c in conditioned), default=None))
    print(f"[lm] prefill (B={LM_B}, S={LM_S}) in lockstep: launches "
          f"{ {kk: vv for kk, vv in launched.items() if vv} }; flash against "
          f"plain: max err {flash_err:.3g} (layer 0 bf16 "
          f"{fc.checks[0]['err']:.3g}, layer 4 f32 "
          f"{fc.checks[m.every_n_layers]['err']:.3g}); {len(conditioned)} "
          f"f32 launches above {FLASH_TOL}, held against f64: kernel "
          f"{max((c['exact_err'] for c in conditioned), default=0):.3g}, "
          f"plain {max((c['plain_exact_err'] for c in conditioned), default=0):.3g}"
          f"; memory kernels: read err {checker.err['fused_read_sweep']:.3g}, "
          f"write err {checker.err['sparse_write_update']:.3g}, near-ties "
          f"{checker.near_ties}")

    # (c) the decode: a prompt, then greedy tokens, with memory states.
    cache = lm.init_cache(cfg, LM_B, LM_MAX_LEN, device=dev)
    mem = lm.init_memory_states(cfg, LM_B, device=dev)
    zero_counts()
    with torch.inference_mode(), Intercept(ops, checker=checker,
                                           record=True) as rec_lm:
        d_logits, cache, mem = lm.decode_scan(params, cfg, cache,
                                              toks[:, :LM_PROMPT],
                                              mem_states=mem)
        after_prompt = counts()
        per_token = []
        for _ in range(LM_GEN):
            tok = d_logits[:, -1].float().argmax(-1).to(torch.int32)
            zero_counts()
            d_logits, cache, mem = lm.decode_step(params, cfg, cache,
                                                  tok[:, None],
                                                  mem_states=mem)
            per_token.append(counts())
    torch.cuda.synchronize()
    one = {name: 0 for name in after_prompt}
    one.update({name: groups for name in FORWARD})
    require(after_prompt == {kk: vv * LM_PROMPT for kk, vv in one.items()},
            f"prompt launches {after_prompt}")
    require(all(c == one for c in per_token), f"a decode step launched "
            f"{[c for c in per_token if c != one][:1]}, expected {one}")
    n_tok = LM_PROMPT + LM_GEN
    require(d_logits.dtype == torch.bfloat16
            and torch.isfinite(d_logits).all().item()
            and int(cache["pos"]) == n_tok
            and all(int(st.step) == n_tok and st.memory[:, N_].eq(0).all()
                    and st.last_access[:, N_].eq(2 ** 31 - 1).all()
                    for st in mem),
            "decode: logits not finite bf16, or the position, the steps or "
            "the scratch rows are off")
    print(f"[lm] decode_scan with memory states: {LM_PROMPT} prompt tokens "
          f"({ {kk: vv for kk, vv in after_prompt.items() if vv} }), then "
          f"{LM_GEN} greedy tokens at {one['fused_read_sweep']} read, write "
          f"and LRA launches and 0 flash launches each; in lockstep, read "
          f"err {checker.err['fused_read_sweep']:.3g}, near-ties "
          f"{checker.near_ties}")

    # (e) times: the kernel at layer 0's (bf16) and layer 4's (f32) inputs
    # (`attention_row`), the memory kernels at the decode's 21st read, write
    # and LRA.
    flash_f32 = attention_row(ref, flash_attention, q4, k4, v4, flush)
    flash_bf16 = attention_row(ref, flash_attention, q0, k0, v0, flush)
    del q0, k0, v0, q4, k4, v4
    step21 = max(RECORD_STEPS)
    q_, mem_, beta_, k_, vn_, _ = rec_lm.records[("fused_read_sweep", step21)]
    la_, n_, _ = rec_lm.records[("lra_topn", step21)]
    wr_ = rec_lm.records[("sparse_write_update", step21)]
    m_w, l_w = wr_[0].clone(), wr_[1].clone()
    J_ = wr_[2].shape[1]
    uniq_ = unique_rows(wr_[2])
    neg_la = (-la_[:, :N_]).contiguous()
    sweep_bytes = 4 * (LM_B * N_ * W_ + 2 * LM_B * H_ * W_ + LM_B * H_
                       + 2 * LM_B * H_ * K_)
    mem_rows = {
        "fused_read_sweep": dict(
            ms=time_ms(lambda: fused_read_sweep(q_, mem_, beta_, k=k_,
                                                valid_n=vn_), 20, flush),
            plain_ms=time_ms(lambda: ref.fused_read_ref(
                q_, mem_, beta_, k_, valid_n=vn_), 5, flush),
            library_ms=None,
            bound=bound(sweep_bytes, LM_B * N_ * W_ * (2 * H_ + 2)),
            rate=(sweep_bytes, LM_B * N_)),
        "sparse_write_update": dict(
            ms=time_ms(lambda: sparse_write_update(m_w, l_w, *wr_[2:7],
                                                   delta=wr_[7]), 50, flush),
            plain_ms=time_ms(lambda: ref.sparse_write_update_ref(
                m_w, l_w, *wr_[2:7], wr_[7]), 20, flush),
            library_ms=None,
            bound=bound(4 * (2 * uniq_ * W_ + 2 * uniq_ + 2 * LM_B * J_
                             + LM_B * H_ * W_ + LM_B * H_ + LM_B),
                        2 * LM_B * J_ * W_)),
        "lra_topn": dict(
            ms=time_ms(lambda: lra_topn(la_, n_, valid_n=N_), 50, flush),
            plain_ms=time_ms(lambda: ref.lra_topn_ref(la_[:, :N_], n_), 20,
                             flush),
            library_ms=time_ms(lambda: torch.topk(neg_la, n_, dim=-1), 50,
                               flush),
            bound=bound(4 * (LM_B * N_ + LM_B * n_), LM_B * N_)),
    }
    # The row scatter at the LM's shapes, on a backward's inputs: the
    # rollback of step 21's J rows ('set') and its replayed write's 'add'
    # of the J rows w·a (six scatters of these shapes a replayed segment,
    # 48 a train step, phase 13).
    idx_s = wr_[2]
    old_s = ref.gather_rows(wr_[0], idx_s)
    add_s = ref.write_rows(wr_[3], wr_[4])
    m_s = wr_[0].clone()
    b_s = torch.arange(LM_B, device=dev)[:, None].expand(LM_B, J_)
    il_s = idx_s.long()
    mem_rows["scatter_rows"] = dict(
        ms=time_ms(lambda: scatter_rows(m_s, idx_s, old_s, mode="set"), 50,
                   flush),
        plain_ms=time_ms(lambda: ref.scatter_rows_ref(m_s, idx_s, old_s,
                                                      "set"), 20, flush),
        library_ms=time_ms(lambda: m_s.index_put_((b_s, il_s), old_s), 50,
                           flush),
        bound=bound(4 * (LM_B * J_ + 2 * uniq_ * W_), 0))
    mem_rows["scatter_rows_add"] = dict(
        ms=time_ms(lambda: scatter_rows(m_s, idx_s, add_s, mode="add"), 50,
                   flush),
        plain_ms=time_ms(lambda: ref.scatter_rows_ref(m_s, idx_s, add_s,
                                                      "add"), 20, flush),
        library_ms=time_ms(lambda: m_s.index_put_((b_s, il_s), add_s,
                                                  accumulate=True), 50,
                           flush),
        bound=bound(4 * (LM_B * J_ + LM_B * J_ * W_ + 2 * uniq_ * W_),
                    LM_B * J_ * W_))
    del m_w, l_w, rec_lm, m_s

    # The prefill and a decode step, on the host clock (synchronised).
    def prefill_run(_):
        lm.prefill(params, cfg, {"tokens": toks})

    # Peaks above what the script holds (the weights, the cache and the
    # memory states among it; earlier phases' tensors too).
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, prefill_all = host_ms(prefill_run, runs=1)
    prefill_peak = torch.cuda.max_memory_allocated() - held
    state = {"cache": cache, "mem": mem}

    def decode_run(_):
        tok = torch.ones((LM_B, 1), dtype=torch.int32, device=dev)
        _, state["cache"], state["mem"] = lm.decode_step(
            params, cfg, state["cache"], tok, mem_states=state["mem"])

    # The decode's rate: a window of GEN greedy steps (the token fed back
    # on the device) as one synchronised span, from the prompt's end of
    # the cache; one window after one untimed; single
    # steps (median of 3) on the side.
    def rewind():
        state["cache"] = {**state["cache"], "pos": torch.tensor(
            LM_PROMPT, dtype=torch.int32, device=dev)}

    def decode_window(_, steps=LM_GEN):
        tok = torch.ones((LM_B, 1), dtype=torch.int32, device=dev)
        for _ in range(steps):
            lg, state["cache"], state["mem"] = lm.decode_step(
                params, cfg, state["cache"], tok, mem_states=state["mem"])
            tok = lg[:, -1].float().argmax(-1).to(torch.int32)[:, None]

    torch.cuda.reset_peak_memory_stats()
    step_ms, step_all = host_ms(decode_run, runs=3)
    decode_peak = torch.cuda.max_memory_allocated() - held
    rewind()
    decode_window(None)
    window_ms, window_all = host_ms(decode_window, runs=1, setup=rewind)
    decode_ms = window_ms / LM_GEN
    decode_all = [t / LM_GEN for t in window_all]
    spread = (max(decode_all) - min(decode_all)) / decode_ms
    rewind()
    dev_ms, on_dev = device_time(lambda: decode_window(None, PROFILE_STEPS))
    dev_ms /= PROFILE_STEPS
    on_dev = [(kk, t / PROFILE_STEPS, c / PROFILE_STEPS)
              for kk, t, c in on_dev]
    out.update(prefill_ms=prefill_ms, prefill_ms_all=prefill_all,
               held_bytes=held, prefill_peak_bytes=prefill_peak,
               decode_ms_per_token=decode_ms,
               decode_ms_per_token_all=decode_all,
               decode_spread=spread, decode_step_ms=step_ms,
               decode_step_ms_all=step_all, decode_peak_bytes=decode_peak,
               decode_device_ms=dev_ms or None,
               decode_busy_share=(dev_ms / decode_ms) if dev_ms else None,
               kernels_at_lm_shapes={
                   kk: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]}
                   for kk, r in mem_rows.items()})
    for name, r in (("flash_attention f32 (layer 4)", flash_f32),
                    ("flash_attention bf16 (layer 0)", flash_bf16),
                    *mem_rows.items()):
        lib = "none" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x "
            f"its time)")
        print(f"[time] {name} at the LM's shapes: {r['ms']:.4f} ms (bound "
              f"{r['bound'][0]:.4f} ms by {r['bound'][1]}: "
              f"{r['bound'][0] / r['ms']:.1%} of it{sweep_rate(r)}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}")
    print(f"[time] prefill (B={LM_B}, S={LM_S}) {prefill_ms:.1f} ms, median "
          f"of {', '.join(f'{t:.1f}' for t in prefill_all)}; peak memory "
          f"{prefill_peak} B above the {held} B held ({param_bytes} B of "
          f"weights); decode {decode_ms:.3f} ms per token (B={LM_B}, with "
          f"memory; windows of {LM_GEN} greedy steps: "
          f"{', '.join(f'{t:.3f}' for t in decode_all)}, spread "
          f"{spread:.1%}); single steps {step_ms:.2f} ms, median of "
          f"{', '.join(f'{t:.2f}' for t in step_all)}; peak {decode_peak} B "
          f"above what is held")
    if dev_ms:
        print(f"[time] the decode on the device (torch.profiler, a window "
              f"of {PROFILE_STEPS} steps): {dev_ms:.3f} ms of kernels a "
              f"token, "
              f"{dev_ms / decode_ms:.1%} of the token's time; by kernel (ms, "
              f"launches a token): "
              + "; ".join(f"{kk[:60]} {t:.3f} ({c:g})"
                          for kk, t, c in on_dev[:6]))
    else:
        print("[time] the decode on the device: not measured (the "
              "profiler recorded no device time)")
    # The weights stay for phase 12's engine.
    del cache, mem, state, toks, logits, d_logits
    torch.cuda.empty_cache()

    # The static serving driver, once (it runs no memory op and, decoding
    # only, no attention kernel).
    zero_counts()
    served = serve(LM_ARCH, use_reduced=False, batch=LM_B,
                   prompt_len=LM_PROMPT, gen_len=LM_GEN, device=dev)
    torch.cuda.synchronize()
    tokens = served["tokens"]
    require(tokens.shape == (LM_B, LM_GEN)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
            and not any(counts().values()),
            "serve: tokens out of shape or range, or a kernel launched")
    out.update(serve_prefill_s=served["prefill_s"],
               serve_decode_s=served["decode_s"],
               serve_decode_tok_per_s=served["decode_tok_per_s"])
    print(f"[lm] serve(--full): {tuple(tokens.shape)} greedy tokens; prefill "
          f"{served['prefill_s']:.2f} s, decode "
          f"{served['decode_tok_per_s']:.1f} tok/s")
    del served
    torch.cuda.empty_cache()
    flash_f32["bf16"] = flash_bf16
    return {"row": flash_f32, "launches": launched,
            "err": out["flash_f32_max_err"],
            "bf16_err": out["flash_bf16_max_err"],
            "bf16_launches": m.every_n_layers, "lm": out, "params": params}


def engine_workload(vocab: int):
    """The open-loop workload of phase 12, built as
    `benchmarks/bench_serve.py::make_workload` builds it: Poisson arrivals
    at ENGINE_RATE, the trailing ENGINE_REVISIT of the requests revisiting
    earlier users round-robin; prompts of ENGINE_PROMPT tokens, ENGINE_GEN
    new tokens, ENGINE_SAMPLED requests sampled. [(arrival s, Request
    keywords)]."""
    import numpy as np

    rng = np.random.default_rng(ENGINE_SEED)
    n = ENGINE_REQUESTS
    arrivals = np.cumsum(rng.exponential(1.0 / ENGINE_RATE, n))
    n_fresh = max(1, int(round(n * (1.0 - ENGINE_REVISIT))))
    sampled = set(rng.choice(n, ENGINE_SAMPLED, replace=False).tolist())
    out = []
    for i, t in enumerate(arrivals):
        plen = int(rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1))
        out.append((float(t), dict(
            user=f"user{i if i < n_fresh else (i - n_fresh) % n_fresh}",
            prompt=rng.integers(1, vocab, plen).tolist(),
            max_new_tokens=ENGINE_GEN, greedy=i not in sampled,
            sample_seed=i)))
    return out


class Lockstep:
    """Holds the engine's kernel launches against their plain versions on
    chosen steps only: `Intercept` with a checker, entered by `start(n)`
    for the next n `step()` calls (the call under way counting, where a
    restore starts it from inside `step()`)."""

    def __init__(self, ops, checker):
        self.intercept = Intercept(ops, checker=checker)
        self.left, self.steps, self.next = 0, 0, 0

    def every(self, step: int, period: int) -> None:
        """Start for one call at the first call that reaches each multiple
        of ``period`` engine steps (a prefill hop runs several)."""
        if step >= self.next:
            self.start(1)
            self.next = step - step % period + period

    def start(self, n: int) -> None:
        if self.left == 0:
            self.intercept.__enter__()
        self.left = max(self.left, n)

    def stepped(self) -> None:
        if self.left:
            self.steps += 1
            self.left -= 1
            if self.left == 0:
                self.intercept.__exit__(None, None, None)

    def close(self) -> None:
        if self.left:
            self.left = 0
            self.intercept.__exit__(None, None, None)


def spy(obj, name, times, pre=None):
    """Wrap method ``name`` of ``obj`` (the instance only): its host ms
    go to ``times``; ``pre`` runs before it."""
    fn = getattr(obj, name)

    def timed(*args):
        if pre:
            pre()
        t0 = time.perf_counter()
        result = fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
        return result
    setattr(obj, name, timed)


def rows_depend_on_m(params, cfg, dev) -> list:
    """The products of one 4-lane decode step (`torch.einsum` calls, with
    their dtypes) whose first two batch rows change when computed for
    those two rows alone: what makes a step's bits depend on the lane
    count."""
    from repro_torch.models import lm

    seen, einsum = [], torch.einsum

    def record(spec, *ops):
        out = einsum(spec, *ops)
        seen.append((spec, ops, out))
        return out

    cache = lm.init_cache(cfg, 4, ENGINE_MAX_LEN, per_lane_pos=True,
                          device=dev)
    mem = lm.init_memory_states(cfg, 4, per_lane_step=True, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (4, 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    torch.einsum = record
    try:
        lm.decode_step(params, cfg, cache, toks, mem_states=mem)
    finally:
        torch.einsum = einsum
    differ = set()
    with torch.inference_mode():
        for spec, ops, out in seen:
            subs = spec.split("->")[0].split(",")
            two = [o[:2] if sub.startswith("b") else o
                   for sub, o in zip(subs, ops)]
            if not torch.equal(einsum(spec, *two), out[:2]):
                dtypes = ", ".join(str(o.dtype)[6:] for o in ops)
                differ.add(f"{spec} ({dtypes})")
    return sorted(differ)


def session_diff(a, b):
    """The first leaf of two engine sessions that is not bit-equal, or
    None."""
    pairs = [("cache." + k, a["cache"][k], b["cache"][k])
             for k in sorted(a["cache"])] + [("pos", a["pos"], b["pos"])]
    pairs += [(f"mem.{g}.{f}", getattr(sa, f), getattr(sb, f))
              for g, (sa, sb) in enumerate(zip(a["mem"], b["mem"]))
              for f in sa._fields]
    if int(a["counter"]) != int(b["counter"]):
        return "counter"
    for name, x, y in pairs:
        if not torch.equal(x, y):
            return (f"{name} (max abs diff "
                    f"{(x.float() - y.float()).abs().max().item():.3g})")
    return None


def engine_phase(dev, ops, ref, checker, zero_counts, counts, params):
    """Phase 12: the continuous-batching serving engine at StarCoder2-7B's
    full width on phase 9's weights. Returns its numbers."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Request, ServeEngine, SessionStore

    cfg = get_config(LM_ARCH)
    m = cfg.memory
    groups = cfg.num_layers // m.every_n_layers
    session_bytes = groups * (m.num_slots + 1) * (m.word_size * 4 + 4)
    workload = engine_workload(cfg.vocab_size)
    out = {"session_memory_bytes": session_bytes}

    def engine(tmp, lanes=ENGINE_LANES, capacity=ENGINE_CAPACITY,
               store=None, **kw):
        if store is None:
            store = SessionStore(num_slots=m.num_slots, capacity=capacity,
                                 spill_dir=tmp)
        return ServeEngine(cfg, lanes=lanes, max_len=ENGINE_MAX_LEN,
                           params=params, device=dev, session_store=store,
                           **kw)

    def checked_step(eng, lock=None):
        """One `step()` with the counters set to 0 just before it and read
        just after: 8 launches of each memory kernel an engine step (a
        prefill hop advances several) and nothing else."""
        before = eng.steps
        if lock is not None:
            lock.every(before, ENGINE_LOCKSTEP_EVERY)
        zero_counts()
        t0 = time.perf_counter()
        done = eng.step()
        ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        if lock is not None:
            lock.stepped()
        n = eng.steps - before
        want = {name: 0 for name in launched}
        want.update({name: groups * n for name in FORWARD})
        require(launched == want, f"engine step {before}: launches "
                f"{ {k: v for k, v in launched.items() if v} }, expected "
                f"{ {k: v for k, v in want.items() if v} }")
        return done, ms, n

    def serve(eng, lock=None, open_loop=True):
        """Serve the workload: open-loop, each request submitted at its
        arrival, or all at once in arrival order; the engine stepped while
        it has work."""
        pending, results, steps = list(workload), [], []
        t0 = time.time() - (0 if open_loop else pending[-1][0])
        while pending or eng.scheduler.has_work:
            now = time.time() - t0
            while pending and pending[0][0] <= now:
                t_arr, kw = pending.pop(0)
                eng.submit(Request(arrival=t0 + t_arr, **kw))
            if not eng.scheduler.has_work:
                time.sleep(max(0.0, pending[0][0] - now))
                continue
            done, ms, n = checked_step(eng, lock)
            results.extend(done)
            steps.append((ms, n))
        return results, time.time() - t0, steps

    def tokens_by_id(results):
        require(len(results) == len(workload) and all(
            len(r["tokens"]) == ENGINE_GEN
            and all(0 <= t < cfg.vocab_size for t in r["tokens"])
            for r in results), "engine: requests dropped, or tokens out of "
            "count or range")
        return {r["id"]: r["tokens"] for r in results}

    def warm(eng):
        """One throwaway request first (as the bench does), in both runs,
        so that request ids match."""
        eng.run([Request(user="warmup", prompt=[1, 2], max_new_tokens=2)])
        eng.sessions.take("warmup")

    # (b) the workload, all requests at once, with the kernels in lockstep
    # on the first three steps after each restore and on every 16th step.
    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(tmp)
        warm(eng)
        lock = Lockstep(ops, checker)
        restore_ms = []
        spy(eng, "_restore_lane", restore_ms,
            pre=lambda: lock.start(ENGINE_AFTER_RESTORE))
        try:
            res1, _, steps1 = serve(eng, lock, open_loop=False)
        finally:
            lock.close()
        tok1 = tokens_by_id(res1)
        require(bool(torch.isfinite(eng.last_logits).all()),
                "engine: logits not finite")
        out.update(lockstep_steps=lock.steps, lockstep_restores=len(
            restore_ms), lockstep_engine_steps=eng.steps)
        torch.cuda.synchronize()
        print(f"[engine] {ENGINE_REQUESTS} requests ({ENGINE_SAMPLED} "
              f"sampled, {len({kw['user'] for _, kw in workload})} users) "
              f"in {eng.steps} engine steps, {len(steps1)} step() calls at "
              f"{groups} read, write and LRA launches an engine step and 0 "
              f"attention; {lock.steps} calls in lockstep ({len(restore_ms)}"
              f" restores): read err {checker.err['fused_read_sweep']:.3g}, "
              f"write err {checker.err['sparse_write_update']:.3g}, LRA "
              f"exact, near-ties {checker.near_ties}")
        del eng

    # (a) the same workload timed, no lockstep: the tokens of every request
    # as in (b), whatever lanes and neighbours it had there.
    with tempfile.TemporaryDirectory() as tmp:
        eng = engine(tmp)
        warm(eng)
        evict_ms, insert_ms, spill_ms, disk_ms = [], [], [], []
        spy(eng, "_evict_lane", evict_ms)
        spy(eng, "_restore_lane", insert_ms)
        store = eng.sessions
        maybe_spill = store._maybe_spill

        def timed_spill():
            n, t0 = store.spills, time.perf_counter()
            maybe_spill()
            if store.spills > n:
                spill_ms.append((time.perf_counter() - t0) * 1e3
                                / (store.spills - n))
        store._maybe_spill = timed_spill
        spy(store, "_restore", disk_ms)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_steps = eng.steps
        res2, wall, steps2 = serve(eng)
        peak = torch.cuda.max_memory_allocated() - held
        require(tokens_by_id(res2) == tok1, "engine: the timed run's "
                "tokens differ from the lockstep run's")
        ttft = [r["first_token_time"] - r["arrival"] for r in res2]
        e2e = [r["finish_time"] - r["arrival"] for r in res2]
        per_step = sorted(ms / n for ms, n in steps2)
        pct = lambda xs, q: float(np.percentile(np.asarray(xs) * 1e3, q))
        out.update(
            tok_per_s=len(res2) * ENGINE_GEN / wall, wall_s=wall,
            engine_steps=eng.steps - t_steps, step_calls=len(steps2),
            ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
            e2e_p50_ms=pct(e2e, 50), e2e_p99_ms=pct(e2e, 99),
            host_ms_per_step=per_step[len(per_step) // 2],
            host_ms_per_step_p90=per_step[int(0.9 * (len(per_step) - 1))],
            spills=store.spills, restores=store.restores,
            spill_ms=spill_ms, restore_ms=disk_ms, evict_ms=evict_ms,
            insert_ms=insert_ms, peak_bytes=peak, held_bytes=held)
        med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None
        print(f"[engine] timed run: {out['tok_per_s']:.2f} tok/s "
              f"({len(res2) * ENGINE_GEN} tokens in {wall:.2f} s); TTFT "
              f"p50 {out['ttft_p50_ms']:.1f} ms, p99 "
              f"{out['ttft_p99_ms']:.1f}; end to end p50 "
              f"{out['e2e_p50_ms']:.1f}, p99 {out['e2e_p99_ms']:.1f}; "
              f"{out['engine_steps']} engine steps in {len(steps2)} calls, "
              f"host ms an engine step median {out['host_ms_per_step']:.2f}"
              f", p90 {out['host_ms_per_step_p90']:.2f}; {store.spills} "
              f"spills ({med(spill_ms) or 0:.1f} ms median), "
              f"{store.restores} restores from disk "
              f"({med(disk_ms) or 0:.1f} ms); lane to host "
              f"{med(evict_ms) or 0:.1f} ms, host to lane "
              f"{med(insert_ms) or 0:.1f} ms (a session's memory "
              f"{session_bytes} B); peak {peak} B above the {held} B held;"
              f" tokens equal to the lockstep run's")

        # The device's busy share: four lanes decoding, a window of steps
        # on the host clock, then the same window traced.
        eng.run()
        for i in range(ENGINE_LANES):
            eng.submit(Request(user=f"busy{i}", prompt=[1 + i],
                               max_new_tokens=4 * ENGINE_BUSY_STEPS))
        eng.step()
        busy_ms, busy_all = host_ms(lambda _: [
            eng.step() for _ in range(ENGINE_BUSY_STEPS)], runs=1)
        dev_ms, on_dev = device_time(lambda: [
            eng.step() for _ in range(ENGINE_BUSY_STEPS)])
        busy_ms /= ENGINE_BUSY_STEPS
        dev_ms /= ENGINE_BUSY_STEPS
        out.update(busy_host_ms_per_step=busy_ms,
                   busy_device_ms_per_step=dev_ms or None,
                   busy_share=(dev_ms / busy_ms) if dev_ms else None)
        if dev_ms:
            print(f"[engine] {ENGINE_LANES} lanes decoding: "
                  f"{busy_ms:.2f} ms an engine step on the host, "
                  f"{dev_ms:.3f} ms of kernels (torch.profiler, "
                  f"{ENGINE_BUSY_STEPS} steps): busy {dev_ms / busy_ms:.1%};"
                  f" by kernel (ms, launches a step): " + "; ".join(
                      f"{k[:50]} {t / ENGINE_BUSY_STEPS:.3f} "
                      f"({c / ENGINE_BUSY_STEPS:g})" for k, t, c in
                      on_dev[:5]))
        else:
            print("[engine] the busy share: not measured (the profiler "
                  "recorded no device time)")
        del eng, store
    torch.cuda.empty_cache()

    # (c) determinism: user u (sampled) 8 tokens uninterrupted against 4 +
    # 4 across two engines sharing a store of one hot session, u spilled to
    # disk between them, other neighbours and lanes.
    gen = np.random.default_rng(ENGINE_SEED + 1)
    P = gen.integers(1, cfg.vocab_size, 4).tolist()
    Pn, Po = (gen.integers(1, cfg.vocab_size, 4).tolist() for _ in range(2))

    def u(prompt, n):
        return Request(user="u", prompt=prompt, max_new_tokens=n,
                       greedy=False, sample_seed=42)

    def noise(n):
        return Request(user="noise", prompt=Pn, max_new_tokens=n,
                       greedy=False, sample_seed=7)

    def user_tokens(results, user="u"):
        return [r for r in results if r["user"] == user][0]["tokens"]

    with tempfile.TemporaryDirectory() as tmp:
        e1 = engine(tmp, lanes=3, capacity=None)
        tok_full = user_tokens(e1.run([u(P, 8), noise(6)]))
        sess_full = e1.sessions.take("u")
        del e1
        store = SessionStore(num_slots=m.num_slots, capacity=1,
                             spill_dir=tmp)
        a = engine(tmp, lanes=3, store=store)
        first = user_tokens(a.run([u(P, 4), noise(8)]))
        del a
        require(store.spills == 1, f"u did not spill: {store.spills}")
        b = engine(tmp, lanes=3, store=store)
        b.submit(Request(user="other", prompt=Po, max_new_tokens=9,
                         greedy=False, sample_seed=5))      # takes lane 0
        split = first + user_tokens(b.run([u([first[-1]], 4)]))
        require(store.restores == 1, "u was not restored from disk")
        diff = session_diff(b.sessions.take("u"), sess_full)
        require(split == tok_full and diff is None,
                f"evict/restore: tokens {split} against {tok_full}, first "
                f"differing leaf {diff}")
        del b, store
    out["round_trip_tokens"] = tok_full
    print(f"[engine] evict/restore round trip (lanes 3, a disk spill and "
          f"other neighbours between 4 + 4 sampled tokens): tokens, memory "
          f"states, cache, position and counter bit for bit")

    # Rescale 4 -> 2 -> 4 lanes mid-run, against an uninterrupted run.
    def logged(eng, log):
        """Make ``eng.step`` keep u's logits row by its token counter."""
        inner = eng.step

        def step():
            done = inner()
            for lane, req in eng.scheduler.active.items():
                if req.user == "u":
                    log[int(eng._counters[lane])] = \
                        eng.last_logits[lane].clone()
            return done
        eng.step = step

    with tempfile.TemporaryDirectory() as tmp:
        log_ref, log_live = {}, {}
        ref_eng = engine(tmp, lanes=4, capacity=None, replicas=2)
        logged(ref_eng, log_ref)
        tok_ref = user_tokens(ref_eng.run([u(P, 8), noise(6)]))
        tok_ref2 = user_tokens(ref_eng.run([u([5], 4)]))
        sess_ref = ref_eng.sessions.take("u")
        del ref_eng
        eng = engine(tmp, lanes=4, capacity=None, replicas=2)
        logged(eng, log_live)
        eng.submit(u(P, 8))
        eng.submit(noise(6))
        done = []
        for _ in range(6):
            done.extend(eng.step())
        eng.rescale(replicas=1)
        require(eng.lanes == 2, f"rescale left {eng.lanes} lanes")
        while eng.scheduler.has_work:
            done.extend(eng.step())
        tok_live = user_tokens(done)
        eng.rescale(replicas=2, lanes=4)
        tok_live2 = user_tokens(eng.run([u([5], 4)]))
        diff = session_diff(eng.sessions.take("u"), sess_ref)
        del eng
    exact = tok_live == tok_ref and tok_live2 == tok_ref2 and diff is None
    first_step = next((c for c in sorted(log_ref) if c in log_live
                       and not torch.equal(log_ref[c], log_live[c])), None)
    m_dependent = rows_depend_on_m(params, cfg, dev) if not exact else []
    out.update(rescale_bit_exact=exact, rescale_tokens_equal=(
        tok_live == tok_ref and tok_live2 == tok_ref2),
        rescale_first_differing_counter=first_step,
        rescale_first_differing_leaf=diff, products_rows_differ=m_dependent)
    require(exact and first_step is None,
            f"rescale 4 -> 2 -> 4 lanes is not bit-exact: tokens equal "
            f"{out['rescale_tokens_equal']}, u's logits first differ at token "
            f"counter {first_step}, first differing leaf {diff}; the products "
            f"of a decode step whose first two rows differ at B = 2 from B = "
            f"4's: {m_dependent}")
    print("[engine] rescale 4 -> 2 -> 4 lanes mid-run against an "
          "uninterrupted 4-lane run: tokens, u's logits at every token "
          "counter, memory states, cache, position and counter bit for bit")
    torch.cuda.empty_cache()
    return out


def f64_grads(ref, q, k, v, g):
    """The attention's gradients in q, k and v through the plain version
    in f64."""
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(ref.flash_attention_ref(*leaves), leaves,
                               g.double())


def f64_err(got: torch.Tensor, exact: torch.Tensor) -> float:
    """max |got - exact| / max(1, |exact|), in f64."""
    return ((got.double() - exact).abs_()
            / exact.abs().clamp_min(1.0)).max().item()


def leaf_names(tree, prefix="") -> list[str]:
    """Dotted names of a nested dict / list's leaves, in `tree_leaves`
    order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def group_f64(p, cfg, x, sels):
    """One LM memory group (`sam_layer.memory_layer_seq` over x (B, S, d))
    in plain PyTorch in x's dtype, with the LRA rows and the read rows of
    each segment fixed to ``sels`` [(lra (B, H), read (B, H, K))]: the
    memory a fresh (B, N+1, W) zero buffer, each write an erase and an
    accumulated add, each read the differentiable tail on its rows, all
    under autograd. In f64 it is the arbiter of the group's naive and
    sparse f32 gradients."""
    from types import SimpleNamespace

    from repro_torch.kernels import ref
    from repro_torch.models import sam_layer
    m = cfg.memory
    B, S, d = x.shape
    n = len(sels)
    seg = S // n
    H, K, W_ = m.num_heads, m.k, m.word_size
    pooled = x.reshape(B, n, seg, d).mean(2)
    mem = x.new_zeros((B, m.num_slots + 1, W_))
    prev = SimpleNamespace(read_idx=torch.zeros((B, H, K), dtype=torch.int32,
                                                device=x.device),
                           read_w=x.new_zeros((B, H, K)))
    b = torch.arange(B, device=x.device)[:, None]
    outs = []
    for t, (lra, idx) in enumerate(sels):
        q, a, alpha, gamma, beta = sam_layer._interface(p, cfg, pooled[:, t])
        widx, ww = sam_layer._write_weights(prev, lra, alpha, gamma)
        mem = mem.index_put((b.expand(B, H), lra.long()),
                            x.new_zeros((B, H, W_)))
        rows = ww[..., None] * a.repeat_interleave(K + 1, dim=1)
        mem = mem.index_put((b.expand(B, widx.shape[1]), widx.long()), rows,
                            accumulate=True)
        words = mem[b[:, :, None], idx.long()]
        read, w = ref.read_tail_rows(q, words, beta, idx >= 0)
        outs.append(torch.einsum("bhw,hwd->bd", read, p["wr"]))
        prev = SimpleNamespace(read_idx=idx, read_w=w)
    reads = torch.stack(outs, dim=1).repeat_interleave(seg, dim=1)
    return x + reads


def group_f64_check(cfg, rec, seq, init_state, ops, ref):
    """Satellite of phase 13 (b): one memory group at full width, on the
    sparse run's inputs to it (``rec``: its weights, its input x and the
    cotangent of its output), the group's gradients (weights and x) in
    the sparse and the naive unroll at f32 against `group_f64` in f64 on
    the selections the naive run made. `group_f64` in f32 must agree with
    the naive unroll within the JAX suite's bar (it computes the same
    function). Returns the errors, of max(1, |g64|) element by element."""
    B = rec["x"].shape[0]

    def port(mode):
        c = dataclasses.replace(cfg, memory=dataclasses.replace(
            cfg.memory, unroll_mode=mode, unroll_chunk=None))
        p = {k: v.clone().requires_grad_() for k, v in rec["p"].items()}
        x = rec["x"].clone().requires_grad_()
        y, _ = seq(p, c, x, init_state(c, B, device=x.device))
        return torch.autograd.grad(y, [*p.values(), x], rec["ct"])

    sels, lra0, read0 = [], ops.lra_topn, ops.fused_read

    def lra(*a, **kw):
        out = lra0(*a, **kw)
        sels.append([out.detach().clone()])
        return out

    def read(*a, **kw):
        out = read0(*a, **kw)
        sels[-1].append(out[2].detach().clone())
        return out

    g_sparse = port("sparse")
    ops.lra_topn, ops.fused_read = lra, read
    try:
        g_naive = port("naive")
    finally:
        ops.lra_topn, ops.fused_read = lra0, read0

    def reimpl(dtype):
        p = {k: v.to(dtype).requires_grad_() for k, v in rec["p"].items()}
        x = rec["x"].to(dtype).requires_grad_()
        y = group_f64(p, cfg, x, sels)
        return torch.autograd.grad(y, [*p.values(), x], rec["ct"].to(dtype))

    g64 = reimpl(torch.float64)
    g32 = reimpl(torch.float32)
    names = [*rec["p"], "x"]

    def err(got):
        return {n: f64_err(a, e) for n, a, e in zip(names, got, g64)}

    bar = max(((a - b).abs() / (NAIVE_ATOL * max(1.0, b.abs().max().item())
                                + NAIVE_RTOL * b.abs())).max().item()
              for a, b in zip(g32, g_naive))
    require(bar <= 1.0, f"the f64 arbiter computed in f32 is not the naive "
            f"unroll's function: {bar:.3g} of the JAX suite's bar")
    res = {"sparse": err(g_sparse), "naive": err(g_naive),
           "reimpl_f32": err(g32), "reimpl_f32_vs_naive_bar_ratio": bar}
    s_max, n_max = max(res["sparse"].values()), max(res["naive"].values())
    res["nearer"] = "sparse" if s_max < n_max else (
        "naive" if n_max < s_max else "equal")
    print(f"[train] a memory group at full width against an f64 naive "
          f"gradient on the same selections, of max(1, |g64|): sparse "
          f"{s_max:.3g} ({', '.join(f'{k} {v:.3g}' for k, v in res['sparse'].items())}), "
          f"naive {n_max:.3g} ({', '.join(f'{k} {v:.3g}' for k, v in res['naive'].items())}); "
          f"{res['nearer']} is nearer; the arbiter in f32 "
          f"{max(res['reimpl_f32'].values()):.3g} (at {bar:.3g} of the JAX "
          f"suite's bar from the naive unroll)")
    del g_sparse, g_naive, g64, g32
    torch.cuda.empty_cache()
    return res


def lm_train_phase(dev, ops, ref, checker, zero_counts, counts):
    """Phase 13: the LM's train step (`launch.steps.make_train_step`) at
    StarCoder2-7B's full width, TRAIN_LAYERS layers deep. Returns its
    numbers."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import lm_token_batches
    from repro_torch.launch import steps
    from repro_torch.models import lm, sam_layer
    from repro_torch.optim import optimizers as opt

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=TRAIN_LAYERS)
    m = cfg.memory
    n_steps = cfg.num_layers // m.every_n_layers * (TRAIN_S // m.segment)
    L = cfg.num_layers
    torch.cuda.empty_cache()
    out = {"layers": L, "memory_steps": n_steps,
           "held_at_start_bytes": torch.cuda.memory_allocated()}

    # (a) the attention Function's gradient at one layer's shapes, unit
    # normal, against autograd through the plain version (f32).
    gen = torch.Generator().manual_seed(11)
    shapes = ((TRAIN_B, TRAIN_S, cfg.padded_heads, cfg.head_dim),
              (TRAIN_B, TRAIN_S, cfg.num_kv_heads, cfg.head_dim))
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(shapes[i > 0], generator=gen).to(dev, dtype)
                   .requires_grad_() for i in range(3))
        g = torch.randn(shapes[0], generator=gen).to(dev, dtype)
        zero_counts()
        got = torch.autograd.grad(
            ops.flash_attention(q, k, v, q_block=cfg.q_block), (q, k, v), g)
        require(counts()["flash_attention"] == 1,
                "the attention Function did not launch its kernel once")
        plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*plain), plain,
                                   g.float())
        errs = []
        for name, a, b in zip("qkv", got, want):
            if dtype == torch.bfloat16:
                err = (a.float() - b).abs().max().item()
                require(a.dtype == dtype and err <= bf16_ulp(b),
                        f"attention d{name} (bf16) {err:.3g} above one bf16 "
                        f"ulp {bf16_ulp(b):.3g}")
            else:
                err = rel_err(a, b)
            errs.append(err)
        if dtype == torch.float32 and max(errs) > FLASH_TOL:
            # Sums over S·G terms: two f32 orders may differ by more; then
            # each gradient lies no further from the f64 one than twice
            # the plain version's does.
            exact = f64_grads(ref, q, k, v, g)
            for name, a, b, e in zip("qkv", got, want, exact):
                got_err, plain_err = f64_err(a, e), f64_err(b, e)
                require(got_err <= 2 * plain_err + FLASH_TOL,
                        f"attention d{name} (f32): {got_err:.3g} from the "
                        f"f64 gradient, the plain version {plain_err:.3g}")
                out[f"attention_grad_f64_err_d{name}"] = (got_err, plain_err)
            del exact
        out[f"attention_grad_err_{str(dtype)[6:]}"] = max(errs)
        del q, k, v, g, got, want, plain
        torch.cuda.empty_cache()
    print(f"[train] attention gradient at one layer's shapes (B, S, H, Hkv, "
          f"D) = {shapes[0][:3] + shapes[1][2:]}, blocks of {cfg.q_block} "
          f"query rows, against autograd through the plain version: bf16 "
          f"{out['attention_grad_err_bfloat16']:.3g} (one bf16 ulp), f32 "
          f"{out['attention_grad_err_float32']:.3g} of max(1, |g|) (bar "
          f"{FLASH_TOL}, or twice the plain version's distance from f64: "
          + (", ".join(f"{kk[-2:]} {e[0]:.3g} against {e[1]:.3g}"
                       for kk, e in out.items() if "f64" in kk) or "not needed")
          + ")")

    # The weights (f32) and one batch; the memory state each forward makes.
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    b, _ = next(lm_token_batches(cfg.vocab_size, TRAIN_B, TRAIN_S))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
    made = []
    init_state = sam_layer.init_memory_state

    def recorded_init(*a, **kw):
        made.append(init_state(*a, **kw))
        return made[-1]

    def memory_back_to_zero(what):
        require(len(made) == 1 and torch.equal(
            made[0].memory, torch.zeros_like(made[0].memory)),
            f"{what}: the memory is not zero again after the backward")
        made.clear()

    sam_layer.init_memory_state = recorded_init
    try:
        # (b) the three unroll modes' gradients, at f32 compute.
        f32 = dataclasses.replace(cfg, compute_dtype="float32")

        def grads_of(mode, chunk=None):
            c = dataclasses.replace(f32, memory=dataclasses.replace(
                m, unroll_mode=mode, unroll_chunk=chunk))
            return steps.value_and_grad(params, c, batch)

        # The sparse run's inputs to each memory group, and the cotangent
        # its output gets: what the f64 check below replays a group on.
        groups = []
        seq = sam_layer.memory_layer_seq

        def capturing_seq(p, c, x, state, segment=None):
            y, st = seq(p, c, x, state, segment)
            rec = {"p": {kk: vv.detach().clone() for kk, vv in p.items()},
                   "x": x.detach().clone()}
            y.register_hook(lambda g: rec.__setitem__("ct", g.detach()))
            groups.append(rec)
            return y, st

        zero_counts()
        sam_layer.memory_layer_seq = capturing_seq
        try:
            loss_s, _, g_s = grads_of("sparse")
        finally:
            sam_layer.memory_layer_seq = seq
        torch.cuda.synchronize()
        f32_launches = counts()
        memory_back_to_zero("sparse (f32 compute)")
        loss_c, _, g_c = grads_of("chunked", TRAIN_CHUNK)
        memory_back_to_zero("chunked (f32 compute)")
        chunk_err = max(rel_err(a, b) for a, b in zip(
            pytree.tree_leaves(g_c), pytree.tree_leaves(g_s)))
        require(chunk_err <= GRAD_ATOL, f"chunked against sparse gradients: "
                f"{chunk_err:.3g} above {GRAD_ATOL} of max(1, |g|)")
        del g_c
        made.clear()
        loss_n, _, g_n = grads_of("naive")
        made.clear()
        # The JAX suite's bar, its absolute part taken relative to the
        # leaf's scale max(1, max |g|) as the LM's floats are everywhere
        # (ROADMAP §C, "Large scores": gradients reach 1e6 here, where an
        # f32 ulp is 0.06); `elementwise` is the bar taken literally.
        naive_ratio = elementwise = 0.0
        for a, b in zip(pytree.tree_leaves(g_s), pytree.tree_leaves(g_n)):
            d = (a - b).abs()
            scale = max(1.0, b.abs().max().item())
            naive_ratio = max(naive_ratio, (d / (NAIVE_ATOL * scale
                                                 + NAIVE_RTOL * b.abs())
                                            ).max().item())
            elementwise = max(elementwise, (d / (NAIVE_ATOL + NAIVE_RTOL
                                                 * b.abs())).max().item())
        # Where the element-by-element bar is missed most: the leaf, the
        # element, |g| there and the leaf's largest, and both modes' values.
        worst = None
        for name_, a_, b_ in zip(leaf_names(g_s), pytree.tree_leaves(g_s),
                                 pytree.tree_leaves(g_n)):
            r_ = (a_ - b_).abs() / (NAIVE_ATOL + NAIVE_RTOL * b_.abs())
            i_ = int(r_.argmax())
            if worst is None or r_.reshape(-1)[i_].item() > worst[0]:
                worst = (r_.reshape(-1)[i_].item(), name_, a_, b_, i_)
        ratio_w, name_w, a_w, b_w, i_w = worst
        where = tuple(int(v) for v in torch.unravel_index(
            torch.tensor(i_w), a_w.shape))
        out["naive_vs_sparse_worst"] = dict(
            leaf=name_w, element=where, ratio=ratio_w,
            sparse=a_w.reshape(-1)[i_w].item(),
            naive=b_w.reshape(-1)[i_w].item(),
            leaf_max_abs=b_w.abs().max().item())
        print(f"[train] naive against sparse, the largest miss of the "
              f"element-by-element bar ({ratio_w:.3g} of it): leaf {name_w}"
              f"{list(where)}, sparse {out['naive_vs_sparse_worst']['sparse']!r}"
              f", naive {out['naive_vs_sparse_worst']['naive']!r} (|g| "
              f"{abs(out['naive_vs_sparse_worst']['naive']):.4g} there, "
              f"{out['naive_vs_sparse_worst']['leaf_max_abs']:.4g} the "
              f"leaf's largest)")
        require(naive_ratio <= 1.0, f"sparse against naive gradients: "
                f"{naive_ratio:.3g} of the bar atol {NAIVE_ATOL} of max(1, "
                f"|g|), rtol {NAIVE_RTOL}")
        loss_gap = max(abs(float(loss_c) - float(loss_s)),
                       abs(float(loss_n) - float(loss_s)))
        require(loss_gap <= TOL * max(1.0, abs(float(loss_s))),
                f"the modes' losses differ by {loss_gap:.3g}")
        del g_s, g_n
        torch.cuda.empty_cache()
        out["memory_groups_f64"] = [
            group_f64_check(f32, rec, seq, init_state, ops, ref)
            for rec in groups]
        del groups
        torch.cuda.empty_cache()
        out.update(chunked_vs_sparse_grad_err=chunk_err,
                   naive_vs_sparse_bar_ratio=naive_ratio,
                   naive_vs_sparse_elementwise_ratio=elementwise,
                   f32_loss=float(loss_s), f32_launches=f32_launches)
        print(f"[train] f32 compute, {n_params} parameters: gradients of "
              f"every leaf, chunked (C = {TRAIN_CHUNK}) against sparse "
              f"{chunk_err:.3g} of max(1, |g|) (bar {GRAD_ATOL}), naive "
              f"against sparse at {naive_ratio:.3g} of the bar (atol "
              f"{NAIVE_ATOL} of the leaf's max(1, |g|), rtol {NAIVE_RTOL}; "
              f"{elementwise:.3g} of it with an absolute atol); losses "
              f"{float(loss_s):.6f} "
              f"(gap {loss_gap:.3g}); the memory zero again after each "
              f"rollback, bit for bit; sparse launches "
              f"{ {k: v for k, v in f32_launches.items() if v} }")

        # (c) the train step's forward and backward (bf16 compute, sparse)
        # in lockstep: every kernel launch against its plain version. Before
        # the optimizer's moments exist: the f64 checks of the f32
        # attention launches need ~19 GB beside the step.
        want = {name: 0 for name in counts()}
        want.update({"flash_attention": 2 * L, "scatter_rows": 6 * n_steps,
                     **{name: n_steps for name in FORWARD}})

        def require_launches(launched, what):
            require(launched == want, f"{what} launches "
                    f"{ {k: v for k, v in launched.items() if v} }, expected "
                    f"{ {k: v for k, v in want.items() if v} }")

        zero_counts()
        with Intercept(ops, checker=checker), FlashCheck(ops, ref) as fc:
            lock_loss, _, lock_grads = steps.value_and_grad(params, cfg,
                                                            batch)
        torch.cuda.synchronize()
        require_launches(counts(), "the lockstep forward and backward")
        memory_back_to_zero("the lockstep forward and backward")
        del lock_grads
        torch.cuda.empty_cache()
        by_dtype = {str(dt)[6:]: sum(c["dtype"] == dt for c in fc.checks)
                    for dt in (torch.bfloat16, torch.float32)}
        require(by_dtype == {"bfloat16": 2 * m.every_n_layers,
                             "float32": 2 * (L - m.every_n_layers)},
                f"attention launches by dtype {by_dtype}")
        flash_err = {dt: max(c["err"] for c in fc.checks
                             if str(c["dtype"])[6:] == dt) for dt in by_dtype}

        # The main path: one `make_train_step`, the counters set to 0 just
        # before it and read just after.
        step_fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                        total_steps=TRAIN_STEPS)
        opt_state = opt.adamw_init(params)
        zero_counts()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        launched = counts()
        require_launches(launched, "the train step")
        memory_back_to_zero("the train step")
        losses = [float(metrics["loss"])]
        require(abs(losses[0] - float(lock_loss))
                <= TOL * max(1.0, abs(losses[0])), f"the train step's loss "
                f"{losses[0]} differs from the lockstep run's {lock_loss}")
        print(f"[train] train step (B={TRAIN_B}, S={TRAIN_S}, bf16 compute, "
              f"sparse): launches "
              f"{ {k: v for k, v in launched.items() if v} } (attention "
              f"bf16 {by_dtype['bfloat16']}, f32 {by_dtype['float32']}: the "
              f"forward and the blocks' recompute); its forward and backward "
              f"in lockstep: attention against plain: bf16 "
              f"{flash_err['bfloat16']:.3g}, f32 {flash_err['float32']:.3g}; "
              f"memory kernels: read err "
              f"{checker.err['fused_read_sweep']:.3g}, write err "
              f"{checker.err['sparse_write_update']:.3g}, scatters bit for "
              f"bit, near-ties {checker.near_ties}; loss {losses[0]:.4f}")

        # (d) times: whole steps, a step taken apart, the device's share.
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(TRAIN_STEPS - 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            memory_back_to_zero("a timed train step")
        peak = torch.cuda.max_memory_allocated()

        def parts():
            """One step with the forward, the backward and the optimizer
            timed apart (the train step's own code, in its order)."""
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            leaves, spec = pytree.tree_flatten(params)
            diff = [x.detach().requires_grad_() for x in leaves]
            loss, _ = lm.loss_fn(pytree.tree_unflatten(diff, spec), cfg,
                                 batch)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            grads = pytree.tree_unflatten(
                list(torch.autograd.grad(loss, diff)), spec)
            del diff
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            grads, _ = opt.clip_by_global_norm(grads, 1.0)
            lr = opt.cosine_schedule(opt_state.count, base_lr=TRAIN_LR,
                                     warmup=TRAIN_WARMUP,
                                     total=TRAIN_STEPS)
            state = opt.adamw_update_(params, grads, opt_state, lr=lr)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            memory_back_to_zero("the step taken apart")
            return float(loss.detach()), state, [(b - a) * 1e3 for a, b in
                                        zip(t, t[1:])]

        loss_p, opt_state, (fwd_ms, bwd_ms, opt_ms) = parts()
        losses.append(loss_p)
        dev_ms, on_dev = device_time(
            lambda: step_fn(params, opt_state, batch))
        memory_back_to_zero("the traced train step")
    finally:
        sam_layer.init_memory_state = init_state
    require(all(map(lambda x: x == x and abs(x) < float("inf"), losses))
            and losses[-1] < losses[0],
            f"the loss is not finite or does not fall: {losses}")
    ms = sorted(step_ms)[len(step_ms) // 2]
    tok_s = TRAIN_B * TRAIN_S / (ms / 1e3)
    reckoned = 16 * n_params
    out.update(params=n_params, launches=launched,
               attention_launches=by_dtype, attention_err=flash_err,
               losses=losses, step_ms=ms, step_ms_all=step_ms,
               fwd_ms=fwd_ms, bwd_ms=bwd_ms, opt_ms=opt_ms,
               tokens_per_s=tok_s, peak_bytes=peak, held_bytes=held,
               reckoned_state_bytes=reckoned, device_ms=dev_ms or None,
               busy_share=(dev_ms / ms) if dev_ms else None,
               top_kernels=[(k, t, c) for k, t, c in on_dev[:8]])
    print(f"[time] LM train step (B={TRAIN_B}, S={TRAIN_S}, {L} layers): "
          f"{ms:.1f} ms, median of {', '.join(f'{t:.1f}' for t in step_ms)}"
          f" ({tok_s:.0f} tokens/s); apart: forward {fwd_ms:.1f}, backward "
          f"{bwd_ms:.1f}, optimizer {opt_ms:.1f} ms; peak {peak} B against "
          f"the reckoned {reckoned} B of f32 parameters, gradients and two "
          f"moments (16 B a parameter; {held} B held before the step); "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}")
    if dev_ms:
        print(f"[time] the train step on the device (torch.profiler): "
              f"{dev_ms:.1f} ms of kernels, {dev_ms / ms:.1%} of the step; "
              f"by kernel (ms, launches): "
              + "; ".join(f"{k[:60]} {t:.2f} ({c})" for k, t, c in on_dev[:8]))
    else:
        print("[time] the train step on the device: not measured (the "
              "profiler recorded no device time)")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    return smi.stdout.strip().splitlines()[0]


# The row dtypes of phase 10's sharded rollouts and train steps.
MESH_DTYPES = ("float32", "bfloat16", "int8")


def _mesh_rank(rank: int, shards: int, path: str, payload: dict) -> None:
    """One rank of phase 10 (b), in a process of its own on cuda:0: the
    sharded f32 forward rollout in lockstep, its launches, the ranks'
    outputs against each other bit for bit, then its times; the bf16 and
    int8 rollouts in lockstep; a sparse train step on each row dtype in
    lockstep (a second one on f32 rows), the ranks' gradients and new
    weights against each other bit for bit, and each step timed bare;
    writes what the parent compares to ``path``/rank<r>.pt. A failed
    check raises, and `torch.multiprocessing.spawn` re-raises it in the
    parent."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils import _pytree as pytree

    from repro_torch.core import sam, training
    from repro_torch.core.types import ControllerConfig, MemoryConfig
    from repro_torch.distributed import mem_shard
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_read import fused_read_sweep
    from repro_torch.kernels.scatter_rows import scatter_rows
    from repro_torch.kernels.sparse_write import sparse_write_update
    from repro_torch.kernels.topk_read import topk_read
    from repro_torch.kernels.usage_argmin import lra_topn
    from repro_torch.optim import optimizers as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(payload["device"])
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("gloo", init_method=f"file://{path}/init",
                            rank=rank, world_size=shards)
    kernels = {"topk_read": topk_read, "lra_topn": lra_topn,
               "sparse_write_update": sparse_write_update,
               "fused_read_sweep": fused_read_sweep,
               "scatter_rows": scatter_rows}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0
            for dtype in getattr(fn, "launches_by_dtype", {}):
                fn.launches_by_dtype[dtype] = 0

    def counts():
        c = {name: fn.launches for name, fn in kernels.items()}
        for name, fn in kernels.items():
            for dtype, n in getattr(fn, "launches_by_dtype", {}).items():
                if dtype in SUFFIX:
                    c[name + SUFFIX[dtype]] = n
        return c

    def cfg_of(dtype):
        return sam.SAMConfig(
            MemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                         delta=DELTA, mem_dtype=dtype),
            ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                             output_size=BITS))

    def same_on_every_rank(what, tensors):
        """Every rank's ``tensors`` equal this rank's, bit for bit."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        parts = [torch.empty_like(flat) for _ in range(shards)]
        dist.all_gather(parts, flat)
        require(all(torch.equal(p.view(torch.int32), flat.view(torch.int32))
                    for p in parts), f"rank {rank}: the ranks' {what} differ")

    cfg = cfg_of("float32")
    params = pytree.tree_map(lambda a: torch.tensor(a, device=dev),
                             payload["params"])
    xs = torch.tensor(payload["xs"], device=dev)
    batch = [torch.tensor(a, device=dev) for a in payload["batch"]]
    checker = Checker(ref)
    with mem_shard.memory_mesh(N) as ctx:
        state = sam.init_state(B, cfg, device=dev)
        require(state.memory.shape == (B, ctx.local_rows, W),
                f"rank {rank}: block of shape {tuple(state.memory.shape)}")
        block_bytes = sum(t.numel() * t.element_size()
                          for t in (state.memory, state.last_access))
        # The main path, in lockstep: every top-K, LRA and write of this
        # rank's block against its plain version, the counts set to 0 just
        # before and read just after.
        zero_counts()
        with torch.inference_mode(), Intercept(ops, checker=checker):
            final, ys = sam.sam_unroll(params, cfg, state, xs)
        torch.cuda.synchronize()
        launches = counts()
        want = {"topk_read": T, "lra_topn": T, "sparse_write_update": T,
                "fused_read_sweep": 0, "scatter_rows": 0}
        require(all(launches[k_] == v for k_, v in want.items())
                and launches["topk_read_bf16"] == 0,
                f"rank {rank}: launches {launches}, expected {want}")
        # Lockstep: every rank's outputs equal, bit for bit.
        same_on_every_rank("ys, read words and indices",
                           (ys, final.read.words, final.read.indices))
        la = mem_shard.gather_blocks(ctx, final.last_access)
        out = dict(ys=ys.cpu(), memory=final.memory[:, :ctx.local_n].cpu(),
                   la=la.cpu() if rank == 0 else None,
                   read_idx=final.read.indices.cpu(),
                   read_words=final.read.words.cpu(), launches=launches,
                   err=checker.err["topk_read"],
                   write_err=checker.err["sparse_write_update"],
                   near_ties=checker.near_ties, block_bytes=block_bytes)
        del final, state, la

        # Times: host ms per step of a rollout from a fresh state and the
        # host ms inside the collectives (median of 3), the peak memory,
        # and rank 0's device time per step (torch.profiler).
        def rollout():
            s = sam.init_state(B, cfg, device=dev)
            torch.cuda.synchronize()
            ctx.collectives.reset()
            t0 = time.perf_counter()
            sam.sam_unroll(params, cfg, s, xs)
            torch.cuda.synchronize()
            return ((time.perf_counter() - t0) * 1e3 / T,
                    ctx.collectives.seconds * 1e3 / T)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = sorted(rollout() for _ in range(3))
        out["peak"] = torch.cuda.max_memory_allocated()
        out["host_ms"], out["coll_ms"] = times[1]
        out["host_all"] = [t[0] for t in times]
        out["bytes_per_step"] = {k: v // T for k, v in
                                 ctx.collectives.bytes.items()}
        # One bare all-gather of a read's (B, H, K) scores, of a CUDA
        # tensor and of a host tensor (median ms of 20, lockstep): what a
        # collective costs here without the rollout's kernels before it.
        for key, where in (("dev", dev), ("host", torch.device("cpu"))):
            x = torch.zeros((B, H, K), device=where)
            bare = []
            for _ in range(20):
                dist.barrier()
                t0 = time.perf_counter()
                mem_shard.all_gather(ctx, x)
                bare.append((time.perf_counter() - t0) * 1e3)
            out[f"bare_ms_{key}"] = sorted(bare)[10]
        s = sam.init_state(B, cfg, device=dev)
        torch.cuda.synchronize()
        if rank == 0:
            d_ms, on_dev = device_time(
                lambda: sam.sam_unroll(params, cfg, s, xs))
            out["device_ms"] = d_ms / T
            out["device_top"] = on_dev[:6]
        else:
            sam.sam_unroll(params, cfg, s, xs)
            torch.cuda.synchronize()
        del s

        # The bf16 and int8 rollouts, in lockstep: topk_read, the LRA and
        # the write on these rows, T launches of each, the ranks alike.
        out["rows"] = {}
        for dtype in MESH_DTYPES[1:]:
            c = cfg_of(dtype)
            sfx = SUFFIX[dtype]
            s = sam.init_state(B, c, device=dev)
            zero_counts()
            ctx.collectives.reset()
            with torch.inference_mode(), Intercept(ops, checker=checker):
                final, ys = sam.sam_unroll(params, c, s, xs)
            torch.cuda.synchronize()
            got = counts()
            require(all(got[name] == T for name in (
                "topk_read", "topk_read" + sfx, "lra_topn",
                "sparse_write_update", "sparse_write_update" + sfx))
                and got["fused_read_sweep"] == got["scatter_rows"] == 0,
                f"rank {rank}: {dtype} rollout launches {got}")
            same_on_every_rank(f"{dtype} ys, read words and indices",
                               (ys, final.read.words, final.read.indices))
            out["rows"][dtype] = dict(
                ys=ys.cpu(), memory=final.memory[:, :ctx.local_n].cpu(),
                scale=(None if final.mem_scale is None else
                       final.mem_scale[:, :ctx.local_n].cpu()),
                la=final.last_access[:, :ctx.local_n].cpu(),
                read_idx=final.read.indices.cpu(), launches=got,
                bytes_per_step={k: v // T for k, v in
                                ctx.collectives.bytes.items()})
            del s, final

        # One sparse train step (make_task_train_step) on each row dtype,
        # from the model's weights and phase 3's batch: its gradients (what
        # the clip sees), the collectives' bytes in the forward (up to the
        # loss) and in the backward, in lockstep with the counts set to 0
        # just before and read just after; then the step bare, timed.
        grads_seen, at_loss = [], {}
        clip, loss_fn = opt.clip_by_global_norm, training.bits_loss

        def seen_clip(grads, max_norm):
            grads_seen.append([g.clone() for g in pytree.tree_leaves(grads)])
            return clip(grads, max_norm)

        def timed_loss(*args):
            torch.cuda.synchronize()
            at_loss["t"] = time.perf_counter()
            at_loss["bytes"] = dict(ctx.collectives.bytes)
            return loss_fn(*args)

        opt.clip_by_global_norm, training.bits_loss = seen_clip, timed_loss
        out["train"] = {}
        try:
            for dtype in MESH_DTYPES:
                spec = training.ModelSpec("sam", cfg_of(dtype).memory,
                                          cfg.controller)
                _, _, step = training.make_task_train_step(spec, LR,
                                                           device=dev)
                p0 = pytree.tree_map(torch.clone, params)
                o0 = opt.rmsprop_init(p0)
                before = dict(checker.scatter_calls)
                grads_seen.clear()
                zero_counts()
                ctx.collectives.reset()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with Intercept(ops, checker=checker):
                    p1, o1, loss, err = step(p0, o0, *batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = counts()
                fwd_b = {k_: v // T for k_, v in at_loss["bytes"].items()}
                bwd_b = {k_: (v - at_loss["bytes"][k_]) // T
                         for k_, v in ctx.collectives.bytes.items()}
                grads = grads_seen[-1]
                require(torch.isfinite(loss).item() and all(
                    torch.isfinite(g).all().item() for g in grads),
                    f"rank {rank}: a {dtype} loss or gradient is not finite")
                same_on_every_rank(f"{dtype} gradients", grads)
                same_on_every_rank(f"{dtype} weights after a step",
                                   pytree.tree_leaves((p1, o1)))
                rec = dict(
                    loss=loss.item(), err=err.item(), launches=got,
                    grads=[g.cpu() for g in grads],
                    checked={m: n - before[m]
                             for m, n in checker.scatter_calls.items()},
                    fwd_bytes=fwd_b, bwd_bytes=bwd_b,
                    lockstep_ms=(t1 - t0) * 1e3,
                    peak=torch.cuda.max_memory_allocated())
                if dtype == "float32":
                    # A second step: the weights stay equal on every rank.
                    p2, o2, _, _ = step(p1, o1, *batch)
                    same_on_every_rank("weights after two steps",
                                       pytree.tree_leaves((p2, o2)))
                    del p2, o2
                # The same step bare: its host ms, the forward's share.
                p0 = pytree.tree_map(torch.clone, params)
                o0 = opt.rmsprop_init(p0)
                ctx.collectives.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(p0, o0, *batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                rec.update(ms=(t1 - t0) * 1e3,
                           fwd_ms=(at_loss["t"] - t0) * 1e3,
                           coll_ms=ctx.collectives.seconds * 1e3)
                out["train"][dtype] = rec
                del p0, o0, p1, o1, step
        finally:
            opt.clip_by_global_norm, training.bits_loss = clip, loss_fn
        out["topk_err"] = {k_: v for k_, v in checker.err.items()
                           if k_.startswith("topk_read")}
        out["near_ties_all"] = checker.near_ties
    torch.save(out, f"{path}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def mesh_phase(dev, ref, checker, flush, rec, mesh_ref, params, xs,
               step_ms, batch):
    """Phase 10: the slot-sharded memory. ``rec`` holds phase 2's recorded
    inputs, ``mesh_ref`` phase 3's single-device rollout (on the host),
    ``params`` the model's weights, ``step_ms`` phase 6's single-device
    exact step, ``batch`` the copy-task batch (inputs, targets, mask) of
    the train steps."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import sam, training
    from repro_torch.core.quant import quantize_rows
    from repro_torch.core.types import ControllerConfig, MemoryConfig
    from repro_torch.distributed import mem_shard
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_read import fused_read_sweep
    from repro_torch.kernels.topk_read import topk_read
    from repro_torch.optim import optimizers as opt
    S, ln = MESH_S, N // MESH_S
    step = max(RECORD_STEPS)
    q, mem, beta, _, _, _ = rec.records[("fused_read_sweep", step)]

    # (a) the kernel against its plain version and fused_read's selection
    # at full width, on f32, bf16 and int8 rows: step 21's memory whole
    # and as each rank's block, an all-zero memory, copies of row N-1
    # (written at step 1) in rows 7, ... (the best, straddling the blocks'
    # boundary: row 7 must come first) and a ragged valid_n.
    cpu = torch.Generator().manual_seed(10)
    dup = mem.clone()
    dup[:, [7, N // 3, N // 2, ln - 1, ln]] = mem[:, N - 1:N]
    q_dup = mem[:, N - 1][:, None, :] * (
        1.0 + 0.01 * torch.randn((B, H, W), generator=cpu).to(dev))

    def stored(m, dtype):
        """f32 rows as ``dtype``: (rows, scales or None)."""
        if dtype == "float32":
            return m, None
        if dtype == "bfloat16":
            return m.bfloat16(), None
        return quantize_rows(m)

    def block(t, r):
        return None if t is None else mem_shard.shard_block(t, N, S, r)

    topk_rows, mem_rows, f32_view = {}, {}, {}
    for dtype in MESH_DTYPES:
        m_all, s_all = stored(mem, dtype)
        mem_rows[dtype] = (m_all, s_all)
        cases = {f"step {step}": (q, m_all, s_all, N)}
        for r in range(S):
            cases[f"block {r}"] = (q, block(m_all, r), block(s_all, r), ln)
        cases.update({"all zero": (q, *stored(torch.zeros_like(mem), dtype),
                                   N),
                      "duplicate rows": (q_dup, *stored(dup, dtype), N),
                      "ragged": (q, m_all, s_all, 3 * N // 4 + 5)})
        name = "topk_read" + SUFFIX.get(dtype, "")
        with torch.inference_mode():
            for case, (q_, m_, s_, n_) in cases.items():
                out = topk_read(q_, m_, k=K, valid_n=n_, mem_scale=s_)
                checker.topk(q_, m_, K, n_, out, s_)
                f_idx = fused_read_sweep(q_, m_, beta, k=K, valid_n=n_,
                                         mem_scale=s_)[2]
                require(torch.equal(out[1], f_idx), f"{name} ({case}) "
                        f"picks other rows than fused_read_sweep")
                if case == "all zero":
                    require(torch.equal(out[1].cpu(), torch.arange(
                        K, dtype=torch.int32).expand(B, H, K)),
                        f"{name} on an all-zero memory must pick rows "
                        f"0..K-1")
                if case == "duplicate rows":
                    require(torch.equal(out[1][:, :, 0].cpu(), torch.full(
                        (B, H), 7, dtype=torch.int32)), f"{name}: row 7 "
                        f"first")
                if dtype == "int8":
                    # JAX's route: B9 on a dequantized f32 copy of the
                    # rows, whose arithmetic is not the int8 read's.
                    view = topk_read(q_, ref._deq_view(m_, s_), k=K,
                                     valid_n=n_)[1]
                    f32_view[case] = int((view != f_idx).sum())
            torch.cuda.synchronize()
        print(f"[mesh] {name} against its plain version at (B, H, W, K) = "
              f"({B}, {H}, {W}, {K}) on {', '.join(cases)}: indices equal "
              f"(near-ties {checker.near_ties} so far), scores err "
              f"{checker.err[name]:.3g}; indices equal fused_read_sweep's "
              f"on the same {dtype} rows bit for bit")

        def topk_row(m_, s_, n_, iters):
            # Each row read once (int8: its 4-byte scale too), q read and
            # the (B, H, K) scores and indices written once.
            nbytes = (B * n_ * W * m_.element_size()
                      + (4 * B * n_ if s_ is not None else 0)
                      + 4 * (B * H * W + 2 * B * H * K))
            return dict(
                ms=time_ms(lambda: topk_read(q, m_, k=K, valid_n=n_,
                                             mem_scale=s_), iters, flush),
                plain_ms=time_ms(lambda: ref.topk_read_ref(
                    q, m_, K, valid_n=n_, mem_scale=s_), 5, flush),
                library_ms=None,
                bound=bound(nbytes, B * n_ * W * (2 * H + 2)),
                rate=(nbytes, B * n_))

        blk = cases["block 0"]
        row = topk_row(blk[1], blk[2], ln, 50)
        row["full"] = topk_row(m_all, s_all, N, 20)
        topk_rows[dtype] = row
        if dtype == "int8":
            view = ref._deq_view(blk[1], blk[2])
            f32_view.update(
                dequantize_ms=time_ms(lambda: ref._deq_view(blk[1], blk[2]),
                                      20, flush),
                topk_ms=time_ms(lambda: topk_read(q, view, k=K, valid_n=ln),
                                50, flush))
            print(f"[mesh] JAX's int8 route, B9 on a block's dequantized "
                  f"f32 copy: picks other than the int8 read's "
                  f"{ {k_: v for k_, v in f32_view.items() if 'ms' not in k_} }"
                  f" of {B * H * K} a case; the copy "
                  f"{f32_view['dequantize_ms']:.4f} ms and its sweep "
                  f"{f32_view['topk_ms']:.4f} ms a step, against "
                  f"{row['ms']:.4f} ms for B9 on the int8 block")
            del view
        for what, r in ((f"a rank's block (B, 2^18+1, W) of {dtype} rows",
                         row),
                        (f"the whole memory (B, 2^20+1, W) of {dtype} rows",
                         row["full"])):
            print(f"[time] topk_read on {what}: {r['ms']:.4f} ms (bound "
                  f"{r['bound'][0]:.6f} ms by {r['bound'][1]}"
                  f"{sweep_rate(r)}), plain {r['plain_ms']:.4f} ms")
        del cases, blk
    del dup, q_dup, mem_rows

    # The single-device runs the sharded ones are held against, on this
    # card: the bf16 and int8 rollouts, and one sparse train step on each
    # row dtype (its gradients, as the clip sees them).
    base = sam.SAMConfig(
        MemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                     delta=DELTA),
        ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                         output_size=BITS))

    def cfg_of(dtype):
        return sam.SAMConfig(dataclasses.replace(base.memory,
                                                 mem_dtype=dtype),
                             base.controller)

    # Each twice: through B1 (the single-device read, its softmax tail in
    # the kernel), and with B1's picks but the plain tail on the picked
    # rows (`ref.sparse_read_tail`), the sharded read's own arithmetic.
    sweep = ops.fused_read_sweep

    def plain_tail(q_, m_, beta_, *, k, valid_n=None, mem_scale=None):
        idx = sweep(q_, m_, beta_, k=k, valid_n=valid_n,
                    mem_scale=mem_scale)[2]
        return (*ref.sparse_read_tail(q_, m_, beta_, idx, mem_scale), idx)

    single = {}
    with torch.inference_mode():
        for dtype in MESH_DTYPES[1:]:
            c = cfg_of(dtype)
            for key, read in ((dtype, sweep), (dtype + "/plain tail",
                                               plain_tail)):
                ops.fused_read_sweep = read
                try:
                    final, ys = sam.sam_unroll(
                        params, c, sam.init_state(B, c, device=dev), xs)
                finally:
                    ops.fused_read_sweep = sweep
                single[key] = dict(
                    ys=ys.cpu(), memory=final.memory[:, :N].cpu(),
                    scale=(None if final.mem_scale is None
                           else final.mem_scale[:, :N].cpu()),
                    la=final.last_access[:, :N].cpu(),
                    read_idx=final.read.indices.cpu())
                del final
    grads_seen, clip = [], opt.clip_by_global_norm

    def seen_clip(grads, max_norm):
        grads_seen.append([g.clone() for g in pytree.tree_leaves(grads)])
        return clip(grads, max_norm)

    single_train = {}
    opt.clip_by_global_norm = seen_clip
    try:
        for dtype in MESH_DTYPES:
            _, _, fn = training.make_task_train_step(
                training.ModelSpec("sam", cfg_of(dtype).memory,
                                   base.controller), LR, device=dev)
            p0 = pytree.tree_map(lambda t: t.detach().clone(), params)
            _, _, loss, _ = fn(p0, opt.rmsprop_init(p0), *batch)
            single_train[dtype] = (loss.item(),
                                   [g.cpu() for g in grads_seen[-1]])
            del fn, p0
    finally:
        opt.clip_by_global_norm = clip
    torch.cuda.synchronize()

    # (b) the sharded runs: S ranks on this card over gloo, from the
    # model's weights, phase 3's inputs and the copy-task batch.
    payload = {"params": {g: {n: t.detach().cpu().numpy() for n, t in
                              grp.items()} for g, grp in params.items()},
               "xs": xs.cpu().numpy(), "device": str(dev),
               "batch": [t.cpu().numpy() for t in batch]}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as path:
        mp.spawn(_mesh_rank, args=(S, path, payload), nprocs=S)
        runs = [torch.load(f"{path}/rank{r}.pt", weights_only=False)
                for r in range(S)]
    spawn_s = time.perf_counter() - t0
    for r, run in enumerate(runs):
        require(torch.equal(run["ys"], runs[0]["ys"]),
                f"rank {r}'s ys differ from rank 0's")
    memory = torch.cat([run["memory"] for run in runs], 1)   # (B, N, W)
    ys_err = rel_err(runs[0]["ys"], mesh_ref["ys"])
    mem_err = rel_err(memory, mesh_ref["memory"])
    words_err = rel_err(runs[0]["read_words"], mesh_ref["read_words"])
    not_bit_equal = int((memory != mesh_ref["memory"]).sum())
    require(max(ys_err, mem_err, words_err) <= TOL,
            f"the sharded rollout is not the single-device one: ys err "
            f"{ys_err:.3g}, memory err {mem_err:.3g}, read words err "
            f"{words_err:.3g}")
    require(torch.equal(runs[0]["la"], mesh_ref["la"]),
            "the sharded usage table differs from the single-device one")
    require(torch.equal(runs[0]["read_idx"], mesh_ref["read_idx"]),
            "the sharded read indices differ from the single-device ones")
    for name in topk_rows:
        key = "topk_read" + SUFFIX.get(name, "")
        checker.err[key] = max([checker.err[key]]
                               + [run["topk_err"][key] for run in runs])
    checker.near_ties += sum(run["near_ties_all"] for run in runs)
    print(f"[mesh] S={S} ranks on {dev} over gloo ({spawn_s:.1f} s with the "
          f"spawn): f32 rollout launches per rank {runs[0]['launches']} over "
          f"T={T} steps, every step checked against the plain versions "
          f"(top-K err {checker.err['topk_read']:.3g}, write err "
          f"{max(run['write_err'] for run in runs):.3g}); ys, read words "
          f"and indices bit-identical across ranks; against phase 3's "
          f"single-device rollout: ys err {ys_err:.3g}, memory err "
          f"{mem_err:.3g} ({not_bit_equal} of {memory.numel()} elements "
          f"not bit-equal), read words err {words_err:.3g}, usage table and "
          f"read indices exact")

    # The bf16 and int8 rollouts against the single-device ones: bit for
    # bit against the run with the sharded read's arithmetic (B1's picks,
    # the plain tail), and against the run through B1: read indices,
    # usage table and int8 codes exact, floats within the phase's bar
    # (1e-5 of max(1, |x|), bf16 rows BF16_GRAD_BAR: the two tails' last
    # bits move a bf16 rounding of the write). Every figure is printed
    # before any is held to its bar.
    rows_res, failed = {}, []
    for dtype in MESH_DTYPES[1:]:
        want, twin = single[dtype], single[dtype + "/plain tail"]
        keys = ("memory", "la") + (("scale",) if dtype == "int8" else ())
        got = {key: torch.cat([run["rows"][dtype][key] for run in runs], 1)
               for key in keys}
        r0 = runs[0]["rows"][dtype]
        got["ys"], got["read_idx"] = r0["ys"], r0["read_idx"]
        bar = BF16_GRAD_BAR if dtype == "bfloat16" else TOL
        res = dict(
            equal_to_plain_tail=all(torch.equal(got[key], twin[key])
                                    for key in got),
            ys_err=rel_err(got["ys"], want["ys"]),
            memory_err=rel_err(got["memory"], want["memory"]),
            memory_not_bit_equal=int((got["memory"]
                                      != want["memory"]).sum()),
            read_idx_equal=torch.equal(got["read_idx"], want["read_idx"]),
            la_equal=torch.equal(got["la"], want["la"]),
            plain_tail_ys_err=rel_err(twin["ys"], want["ys"]),
            launches=r0["launches"], bytes_per_step=r0["bytes_per_step"])
        if dtype == "int8":
            res["scale_err"] = rel_err(got["scale"], want["scale"])
        rows_res[dtype] = res
        print(f"[mesh] {dtype} rollout, S={S} ranks: launches per rank "
              f"{r0['launches']}, every step in lockstep, the ranks alike; "
              f"bit for bit the single-device rollout with B1's picks and "
              f"the plain tail: {res['equal_to_plain_tail']}; against the "
              f"single-device rollout through B1: ys err "
              f"{res['ys_err']:.3g} (the plain-tail run's "
              f"{res['plain_tail_ys_err']:.3g}), "
              f"{'codes' if dtype == 'int8' else 'rows'} err "
              f"{res['memory_err']:.3g} ({res['memory_not_bit_equal']} "
              f"elements not bit-equal)"
              + (f", scales err {res['scale_err']:.3g}" if dtype == "int8"
                 else "")
              + f", read indices equal {res['read_idx_equal']}, usage table "
              f"equal {res['la_equal']}; bytes per step per rank "
              f"{r0['bytes_per_step']}")
        if not res["equal_to_plain_tail"]:
            failed.append(f"the sharded {dtype} rollout is not the "
                          f"single-device one with its arithmetic")
        if not (res["read_idx_equal"] and res["la_equal"]):
            failed.append(f"the sharded {dtype} rollout's read indices or "
                          f"usage table differ from the single-device one's")
        if max(res["ys_err"], res.get("scale_err", 0.0)) > bar or (
                res["memory_not_bit_equal"] if dtype == "int8"
                else res["memory_err"] > bar):
            failed.append(f"the sharded {dtype} rollout against the "
                          f"single-device one: {res}")

    # The train steps against the single-device ones.
    train_res = {}
    for dtype in MESH_DTYPES:
        sfx = SUFFIX.get(dtype, "")
        r0 = runs[0]["train"][dtype]
        s_loss, s_grads = single_train[dtype]
        g_err = max(rel_err(a, b) for a, b in zip(r0["grads"], s_grads))
        bar = BF16_GRAD_BAR if dtype == "bfloat16" else GRAD_ATOL
        if g_err > bar:
            failed.append(f"the sharded {dtype} train step's gradients err "
                          f"{g_err:.3g} (bar {bar})")
        if abs(r0["loss"] - s_loss) > TOL * abs(s_loss):
            failed.append(f"the sharded {dtype} loss {r0['loss']} against "
                          f"{s_loss}")
        want = {"topk_read": T, "lra_topn": T, "fused_read_sweep": 0,
                "sparse_write_update": 2 * T if dtype == "int8" else T,
                "scatter_rows": (4 if dtype == "int8" else SAM_BWD_SCATTERS)
                * T}
        if sfx:
            want.update({"topk_read" + sfx: T,
                         "sparse_write_update" + sfx:
                         want["sparse_write_update"],
                         "scatter_rows" + sfx: 2 * T if dtype == "int8"
                         else SAM_BWD_SCATTERS * T})
        for run in runs:
            got = run["train"][dtype]["launches"]
            if not all(got[k_] == v for k_, v in want.items()):
                failed.append(f"the sharded {dtype} train step launched "
                              f"{got}, expected {want}")
        train_res[dtype] = dict(
            loss=r0["loss"], single_loss=s_loss, grad_err=g_err,
            launches=r0["launches"],
            scatter_checked=r0["checked"],
            fwd_bytes_per_step=r0["fwd_bytes"],
            bwd_bytes_per_step=r0["bwd_bytes"],
            ms=[run["train"][dtype]["ms"] for run in runs],
            fwd_ms=[run["train"][dtype]["fwd_ms"] for run in runs],
            coll_ms=[run["train"][dtype]["coll_ms"] for run in runs],
            lockstep_ms=[run["train"][dtype]["lockstep_ms"] for run in runs],
            peak=[run["train"][dtype]["peak"] for run in runs])
        t = train_res[dtype]
        print(f"[mesh-train] {dtype} rows, S={S}: one sparse train step "
              f"(T={T}) per rank in lockstep, launches {r0['launches']}, "
              f"scatter calls checked {r0['checked']}; gradients "
              f"bit-identical across ranks{' (and the weights after a '
              'second step)' if dtype == 'float32' else ''}, against the "
              f"single-device step err {g_err:.3g} (bar {bar}), loss "
              f"{r0['loss']:.6f} ({s_loss:.6f} on one device); bytes per step per rank forward "
              f"{r0['fwd_bytes']}, backward {r0['bwd_bytes']}")
        print(f"[mesh-train] {dtype} times ({MESH_LABEL}): host ms per "
              f"step per rank {[round(x, 1) for x in t['ms']]} (forward "
              f"{[round(x, 1) for x in t['fwd_ms']]}, in the collectives "
              f"{[round(x, 1) for x in t['coll_ms']]}); in lockstep "
              f"{[round(x, 1) for x in t['lockstep_ms']]}; peak per rank "
              f"{t['peak']} B")
    require(not failed, "; ".join(failed))
    card = card_line()
    print(f"[mesh] times ({MESH_LABEL}; {card}): host ms/step per rank "
          f"{[round(run['host_ms'], 4) for run in runs]} (median of 3), in "
          f"the collectives {[round(run['coll_ms'], 4) for run in runs]}; "
          f"single-device exact step (phase 6) {step_ms:.4f}; device "
          f"ms/step on rank 0 {runs[0]['device_ms']:.4f} "
          f"({', '.join(f'{k} {v:.3f}' for k, v, _ in runs[0]['device_top'][:4])}"
          f"); peak per rank {[run['peak'] for run in runs]} B beside a "
          f"block of {runs[0]['block_bytes']} B; bytes per step per rank "
          f"{runs[0]['bytes_per_step']}")
    row = topk_rows["float32"]
    print(f"[mesh] topk_read ({card}): " + "; ".join(
        f"{dtype} block (B, 2^18+1, W) {r['ms']:.4f} ms (bound "
        f"{r['bound'][0]:.4f}, plain {r['plain_ms']:.3f}), whole "
        f"(B, 2^20+1, W) {r['full']['ms']:.4f} ms (bound "
        f"{r['full']['bound'][0]:.4f}, plain {r['full']['plain_ms']:.3f})"
        for dtype, r in topk_rows.items())
        + f"; a bare all-gather of (B, H, K) f32 per rank: CUDA tensor "
        f"{[round(run['bare_ms_dev'], 4) for run in runs]} ms, host "
        f"tensor {[round(run['bare_ms_host'], 4) for run in runs]} ms")
    return {"row": row, "bf16_row": topk_rows["bfloat16"],
            "int8_row": topk_rows["int8"], "launches": runs[0]["launches"],
            "bf16_launches": train_res["bfloat16"]["launches"],
            "int8_launches": train_res["int8"]["launches"], "mesh": {
        "label": MESH_LABEL, "card": card, "shards": S,
        "launches_per_rank": [run["launches"] for run in runs],
        "ys_err": ys_err, "memory_err": mem_err, "read_words_err": words_err,
        "memory_not_bit_equal": not_bit_equal,
        "host_ms_per_step": [run["host_ms"] for run in runs],
        "host_ms_all": [run["host_all"] for run in runs],
        "collective_ms_per_step": [run["coll_ms"] for run in runs],
        "collective_bytes_per_step": runs[0]["bytes_per_step"],
        "bare_all_gather_ms": {"cuda": [run["bare_ms_dev"] for run in runs],
                               "host": [run["bare_ms_host"] for run in runs]},
        "device_ms_per_step_rank0": runs[0]["device_ms"],
        "peak_bytes": [run["peak"] for run in runs],
        "block_bytes": runs[0]["block_bytes"],
        "single_device_ms_per_step": step_ms,
        "rollouts": rows_res, "train": train_res,
        "int8_f32_view": f32_view,
        "topk_read": {dtype: {k_: v for k_, v in r.items() if k_ != "rate"}
                      for dtype, r in topk_rows.items()}}}


def dnc_bytes(n: int, batch: int, steps: int, cfg) -> int:
    """A bound on the device bytes of a dense-DNC forward and backward
    under autograd: the state (its (B, N, N) link and (B, N) rows), per
    step the link the read's products keep for the backward and the
    (B, N)-sized tensors the allocation and the dense reads keep, and
    three (B, N, N) temporaries of the link update."""
    mem = cfg.memory
    R, Wd = mem.num_heads, mem.word_size
    per_row = 8 * Wd + 24 * R + 24
    return 4 * batch * (n * n * (steps + 4)
                        + n * (steps + 1) * per_row)


def dnc_phase(dev, ops, ref, checker, zero_counts, counts):
    """Phase 11: the sparse DNC (exact and LSH read) and the dense DNC
    (`core/dnc.py`, `core/cell.py::SDNCCell`). Returns what was measured,
    with each kernel's launches per SDNC step."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import dnc, training
    from repro_torch.core import unroll as unroll_lib
    from repro_torch.core.cell import SDNCCell
    from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                        MemoryConfig, tree_bytes)
    from repro_torch.data.tasks import associative_recall_task
    from repro_torch.optim import optimizers as opt

    ctl = ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                           output_size=BITS)

    def sdnc_cfg(n, ann="exact", mem_dtype="float32", **kw):
        lsh = LSH if ann == "lsh" else {}
        return dnc.DNCConfig(MemoryConfig(num_slots=n, word_size=W,
                                          num_heads=H, k=K, delta=DELTA,
                                          mem_dtype=mem_dtype, **lsh),
                             ctl, k_l=DNC_KL, sparse=True, **kw)

    inputs, targets, mask = associative_recall_task(
        B, RECALL_ITEMS, RECALL_ITEMS, BITS, RECALL_LEN, device=dev,
        generator=torch.Generator().manual_seed(11))
    xs = inputs.transpose(0, 1).contiguous()
    ts, ms = targets.transpose(0, 1), mask.transpose(0, 1)
    require(xs.shape == (T, B, BITS + 2), f"the recall batch has shape "
            f"{tuple(xs.shape)}")

    def expect(per_step, steps, **extra):
        want = {name: 0 for name in counts()}
        for name, n in per_step.items():
            want[name] = n * steps
        want.update(extra)
        return want

    def buffers(s):
        return [s.memory, *s.n_mat, *s.p_mat]

    def clone(s):
        return pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, s)

    # (a) the forward rollouts, in lockstep.
    models, finals, fwd_launches = {}, {}, {}
    for ann, per in (("exact", SDNC_STEP), ("lsh", SDNC_LSH_STEP)):
        model = dnc.DNC(sdnc_cfg(N, ann), seed=0, device=dev)
        ties = checker.near_ties
        zero_counts()
        with Intercept(ops, checker=checker):
            state, ys = model(model.init_state(B), xs)
        torch.cuda.synchronize()
        launched = counts()
        require(launched == expect(per, T), f"the {ann} SDNC rollout "
                f"launched {launched}, expected {expect(per, T)}")
        require(ys.shape == (T, B, BITS) and torch.isfinite(ys).all().item(),
                f"{ann} SDNC outputs are not finite (T, B, bits) values")
        require(all(torch.isfinite(t).all().item() for t in
                    (state.memory, state.n_mat.vals, state.p_mat.vals)),
                f"{ann} SDNC memory or links not finite")
        require(state.memory[:, N].eq(0).all().item()
                and state.usage[:, N].eq(LA_SCRATCH).all().item(),
                f"the {ann} SDNC touched the scratch row")
        require(int(state.step) == T and all(
            ((m.cols >= -1) & (m.cols < N)).all().item()
            for m in (state.n_mat, state.p_mat)), f"{ann} SDNC state")
        models[ann], finals[ann], fwd_launches[ann] = model, state, launched
        print(f"[sdnc] {ann} rollout (N={N}, B={B}, T={T}, K_L={DNC_KL}) in "
              f"lockstep: launches {launched} ({per} a step, nothing else); "
              f"near-ties {checker.near_ties - ties}; state "
              f"{tree_bytes(state)} B")

    # (b) sparse-mode forward and backward from the rollout's final state.
    flat_p, p_spec = pytree.tree_flatten(pytree.tree_map(
        lambda v: v.detach(), models["exact"].params()))

    def fwd_bwd(ann, mode, chunk, lockstep):
        cell = SDNCCell(models[ann].cfg)
        f_leaves, f_spec = pytree.tree_flatten(pytree.tree_map(
            lambda v: v.detach(), models[ann].params()))
        s0 = clone(finals[ann])
        before = [t.clone() for t in buffers(s0)]
        leaves = [p.clone().requires_grad_() for p in f_leaves]
        params = pytree.tree_unflatten(leaves, f_spec)
        acct = unroll_lib.residual_accounting(cell, params, s0, xs,
                                              mode=mode, chunk=chunk)
        with Intercept(ops, checker=checker if lockstep else None):
            zero_counts()
            _, ys_t = unroll_lib.unroll(cell, params, s0, xs, mode=mode,
                                        chunk=chunk)
            loss = training.bits_loss(ys_t, ts, ms)
            torch.cuda.synchronize()
            fwd = counts()
            zero_counts()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            torch.cuda.synchronize()
            bwd = counts()
        restored = all(torch.equal(a, b) for a, b in zip(buffers(s0), before))
        return loss.detach(), grads, fwd, bwd, restored, acct

    train = {}
    for ann, per in (("exact", SDNC_STEP), ("lsh", SDNC_LSH_STEP)):
        loss, grads, fwd, bwd, restored, acct = fwd_bwd(ann, "sparse", None,
                                                        True)
        require(fwd == expect(per, T), f"{ann} sparse forward launched {fwd}")
        require(bwd == expect({}, T, scatter_rows=SDNC_BWD_SCATTERS * T),
                f"the {ann} SDNC backward launched {bwd}: no read, hash or "
                f"LRA, and {SDNC_BWD_SCATTERS} scatters a step")
        require(restored, f"the {ann} sparse backward did not give the "
                f"memory, N_t and P_t back bit for bit")
        require(torch.isfinite(loss).item() and all(
            torch.isfinite(g).all().item() for g in grads),
            f"an {ann} SDNC loss or gradient leaf is not finite")
        train[ann] = dict(loss=loss.item(), fwd_launches=fwd,
                          bwd_launches=bwd, residual_bytes=acct[
                              "residual_bytes"])
        print(f"[sdnc] {ann} sparse forward launches {fwd}; backward "
              f"launches {bwd} (every scatter checked in lockstep); memory, "
              f"N_t and P_t restored bit for bit; loss {loss.item():.6f}; "
              f"{len(grads)} gradient leaves finite")
        if ann == "exact":
            g_sparse = grads
    chunk = SDNC_CHUNK
    loss_c, g_chunk, _, _, restored_c, _ = fwd_bwd("exact", "chunked", chunk,
                                                   False)
    chunk_err = max((a - b).abs().max().item()
                    for a, b in zip(g_chunk, g_sparse))
    require(restored_c, "the chunked SDNC backward did not restore the "
            "buffers")
    require(all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in zip(g_chunk, g_sparse)),
            f"chunked SDNC gradients differ from sparse ones ({chunk_err:.3g})")
    require(abs(loss_c.item() - train["exact"]["loss"])
            <= TOL * abs(train["exact"]["loss"]), "chunked SDNC loss")
    print(f"[sdnc] chunked C={chunk}: gradients max err {chunk_err:.3g} "
          f"against sparse; buffers restored bit for bit")

    # The SDNC on bf16 rows (ROADMAP A6b), exact and LSH: the rollout in
    # lockstep, its two scatters and its read a step on their bf16
    # instantiations; then a sparse forward and backward from its final
    # state in lockstep, of whose 13 scatters a backward step the memory's
    # seven run on bf16 rows (two rollbacks, the replayed write's two, the
    # write's cotangent 'set', the two reads' 'add') and N_t's and P_t's
    # six on f32; the memory, N_t and P_t back bit for bit.
    bf16_runs = {}
    for ann, per in (("exact", SDNC_STEP), ("lsh", SDNC_LSH_STEP)):
        key = f"bf16-{ann}"
        model = dnc.DNC(sdnc_cfg(N, ann, mem_dtype="bfloat16"), seed=0,
                        device=dev)
        rname = ("fused_read_sweep" if ann == "exact"
                 else "fused_read_candidates") + SUFFIX["bfloat16"]
        want_f = expect(per, T, scatter_rows_bf16=2 * T, **{rname: T})
        zero_counts()
        with Intercept(ops, checker=checker):
            state, ys = model(model.init_state(B), xs)
        torch.cuda.synchronize()
        launched = counts()
        require(launched == want_f, f"the bf16 {ann} SDNC rollout launched "
                f"{launched}, expected {want_f}")
        require(state.memory.dtype == torch.bfloat16
                and ys.shape == (T, B, BITS)
                and torch.isfinite(ys).all().item()
                and torch.isfinite(state.memory).all().item()
                and state.memory[:, N].eq(0).all().item(),
                f"the bf16 {ann} SDNC's outputs or memory")
        models[key], finals[key] = model, state
        loss, grads, fwd, bwd, restored, acct = fwd_bwd(key, "sparse", None,
                                                        True)
        want_b = expect({}, T, scatter_rows=SDNC_BWD_SCATTERS * T,
                        scatter_rows_bf16=SDNC_BF16_BWD_SCATTERS * T)
        require(fwd == want_f, f"bf16 {ann} sparse forward launched {fwd}")
        require(bwd == want_b, f"the bf16 {ann} SDNC backward launched "
                f"{ {k: v for k, v in bwd.items() if v} }, expected "
                f"{ {k: v for k, v in want_b.items() if v} }")
        require(restored, f"the bf16 {ann} sparse backward did not give the "
                f"memory, N_t and P_t back bit for bit")
        require(torch.isfinite(loss).item() and all(
            torch.isfinite(g).all().item() for g in grads),
            f"a bf16 {ann} SDNC loss or gradient leaf is not finite")
        bf16_runs[ann] = dict(fwd_launches=launched, bwd_launches=bwd,
                              loss=loss.item(),
                              residual_bytes=acct["residual_bytes"],
                              state_bytes=tree_bytes(state))
        print(f"[sdnc] bf16 {ann} rollout in lockstep: launches "
              f"{ {k: v for k, v in launched.items() if v} }; sparse "
              f"backward in lockstep: launches "
              f"{ {k: v for k, v in bwd.items() if v} }; memory, N_t and "
              f"P_t restored bit for bit; loss {loss.item():.6f}; state "
              f"{tree_bytes(state)} B")
        del models[key], finals[key], model, state, ys, grads
        torch.cuda.empty_cache()

    # (c) the main path: one make_task_train_step step of kind sdnc.
    spec = training.ModelSpec("sdnc", sdnc_cfg(N).memory, ctl)
    _, _, step_fn = training.make_task_train_step(spec, LR, device=dev)
    p0 = pytree.tree_unflatten([p.clone() for p in flat_p], p_spec)
    o0 = opt.rmsprop_init(p0)
    zero_counts()
    with Intercept(ops, checker=checker):
        p1, o1, loss, err = step_fn(p0, o0, inputs, targets, mask)
    torch.cuda.synchronize()
    main_launches = counts()
    require(main_launches == expect(SDNC_STEP, T, scatter_rows=(
        SDNC_STEP["scatter_rows"] + SDNC_BWD_SCATTERS) * T),
        f"the sdnc train step launched {main_launches}")
    losses = [loss.item()]
    for _ in range(3):
        p1, o1, loss, _ = step_fn(p1, o1, inputs, targets, mask)
        losses.append(loss.item())
        require(torch.isfinite(loss).item() and all(
            torch.isfinite(p).all().item()
            for p in pytree.tree_leaves((p1, o1))),
            "an sdnc RMSProp step produced a NaN or an infinity")
    print(f"[sdnc] main path: one make_task_train_step step (sdnc, "
          f"associative recall: {RECALL_ITEMS} items of {RECALL_LEN}), "
          f"launches {main_launches}; loss {losses[0]:.6f}, bit error "
          f"{err.item():.4f}; four RMSProp steps, losses {losses}: all finite")
    del p1, o1, step_fn

    # A small step of each kind on the card against the CPU (N = 1000,
    # T = 12, a random initial memory; the DNC from a state of distinct
    # usages, whose allocation sort has no near-tie).
    small = training.ModelSpec("sdnc", sdnc_cfg(1000).memory, ctl)
    batch = associative_recall_task(2, 3, 3, BITS, 2, device="cpu",
                                    generator=torch.Generator().manual_seed(4))
    require(batch[0].shape[1] == 12, "the small batch is not T = 12")
    card_vs_cpu = {}
    for kind in ("sdnc", "dnc"):
        spec_k = dataclasses.replace(small, kind=kind)
        results = {}
        for device in ("cpu", dev):
            init_p, init_s, unroll_k = training.build_model(spec_k,
                                                            device=device)
            leaves, spec_s = pytree.tree_flatten(
                init_p(torch.Generator().manual_seed(5)))
            leaves = [p.requires_grad_() for p in leaves]
            s0 = small_state(init_s(2), kind, torch.Generator().manual_seed(6))
            b_in, b_tgt, b_mask = (t.to(device) for t in batch)
            _, ys_small = unroll_k(pytree.tree_unflatten(leaves, spec_s), s0,
                                   b_in.transpose(0, 1))
            l_small = training.bits_loss(ys_small, b_tgt.transpose(0, 1),
                                         b_mask.transpose(0, 1))
            grads = torch.autograd.grad(l_small, leaves, allow_unused=True)
            results[str(device)] = (l_small.item(), [
                torch.zeros_like(p).cpu() if g is None else g.cpu()
                for p, g in zip(leaves, grads)])
        (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(dev)]
        err_k = max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu))
        require(abs(l_gpu - l_cpu) <= TOL * abs(l_cpu),
                f"small {kind} step: loss {l_gpu} on the card, {l_cpu} on "
                f"the CPU")
        require(all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                    for a, b in zip(g_gpu, g_cpu)),
                f"small {kind} step: gradients differ (max err {err_k:.3g})")
        card_vs_cpu[kind] = err_k
        print(f"[sdnc] small {kind} step (N=1000, T=12) card vs CPU: loss "
              f"rel err {abs(l_gpu - l_cpu) / abs(l_cpu):.3g}, gradients max "
              f"err {err_k:.3g}")

    # (d) flat in N: the sparse backward's ms and peak, beside the
    # accounting.
    flat = []
    for n in FLAT_NS:
        cell = SDNCCell(sdnc_cfg(n))
        leaves = [p.clone().requires_grad_() for p in flat_p]
        params = pytree.tree_unflatten(leaves, p_spec)
        out = {}

        def forward(s0):
            out["loss"] = training.bits_loss(
                unroll_lib.unroll(cell, params, s0, xs)[1], ts, ms)
            return s0

        def backward(_):
            torch.autograd.grad(out["loss"], leaves)

        s0 = cell.init_state(B, device=dev)
        sb = tree_bytes(s0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        forward(s0)
        backward(None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        del s0
        f_med, _ = host_ms(forward, runs=3, setup=lambda: cell.init_state(
            B, device=dev))
        b_med, b_all = host_ms(backward, runs=3, setup=lambda: forward(
            cell.init_state(B, device=dev)))
        out.clear()
        acct = unroll_lib.residual_accounting(
            cell, params, cell.init_state(B, device=dev), xs, mode="sparse")
        cts = 4 * B * ((n + 1) * W + 2 * n * DNC_KL)
        flat.append(dict(n=n, fwd_ms=f_med, bwd_ms=b_med, bwd_all=b_all,
                         peak_above_state=peak, state_bytes=sb,
                         residual_bytes=acct["residual_bytes"],
                         res_step_bytes=acct["res_step_bytes"],
                         cotangent_bytes=cts))
        print(f"[sdnc-flat] N={n}: sparse forward {f_med:.1f} ms, backward "
              f"{b_med:.1f} ms (of {', '.join(f'{t:.1f}' for t in b_all)}), "
              f"T={T}; peak {peak} B above the {sb} B state, beside "
              f"residual_accounting(sparse) {acct['residual_bytes']} B "
              f"(state + T·{acct['res_step_bytes']} B) and the cotangent "
              f"buffers' {cts} B")
        torch.cuda.empty_cache()

    # (e) Fig. 7 (bench_sdnc.py's setup): forward + backward ms and peak,
    # the SDNC through its default engine against the dense DNC.
    ctl7 = ControllerConfig(input_size=10, hidden_size=64, output_size=8)
    xs7 = torch.randn((FIG7_T, FIG7_B, 10),
                      generator=torch.Generator().manual_seed(7)).to(dev)

    def fig7_runner(sparse, n):
        cfg7 = dnc.DNCConfig(MemoryConfig(num_slots=n, word_size=32,
                                          num_heads=2, k=4), ctl7,
                             sparse=sparse)
        m7 = dnc.DNC(cfg7, seed=0, device=dev)
        leaves7 = [p.detach().clone().requires_grad_()
                   for p in pytree.tree_leaves(m7.params())]
        p7 = pytree.tree_unflatten(leaves7,
                                   pytree.tree_flatten(m7.params())[1])
        cell7 = SDNCCell(cfg7) if sparse else None

        def run7(s):
            if sparse:
                _, ys7 = unroll_lib.unroll(cell7, p7, s, xs7)
            else:
                _, ys7 = dnc.dnc_unroll(p7, cfg7, s, xs7)
            torch.autograd.grad((ys7 ** 2).sum(), leaves7)

        if sparse:
            s_b = tree_bytes(m7.init_state(1)) * FIG7_B
            need = 3 * s_b + (1 << 28)
        else:
            need = dnc_bytes(n, FIG7_B, FIG7_T, cfg7)
        return run7, m7.init_state, need

    fig7 = []
    for n in FIG7_NS:
        row = {"n": n}
        for name, sparse in (("sdnc", True), ("dnc", False)):
            run7, new_state, need = fig7_runner(sparse, n)
            row[name] = measure(run7, new_state, need, batch=FIG7_B)
            torch.cuda.empty_cache()
        if "ms" in row["dnc"]:
            row["speedup"] = row["dnc"]["ms"] / row["sdnc"]["ms"]
        fig7.append(row)
        cells = []
        for name in ("sdnc", "dnc"):
            m = row[name]
            cells.append(f"{name} left out (needs {m['need']} B, "
                         f"{m['avail']} B available)" if "ms" not in m else
                         f"{name} {m['ms']:.2f} ms (of "
                         f"{', '.join(f'{t:.2f}' for t in m['all'])}), peak "
                         f"{m['peak']} B")
        print(f"[fig7] N={n} (B={FIG7_B}, R=2, K=4, W=32, hidden 64, "
              f"T={FIG7_T}, forward + backward): " + "; ".join(cells)
              + (f"; the DNC takes {row['speedup']:.2f}x the SDNC's time"
                 if "speedup" in row else ""))

    # (f) the rollouts' times: host ms and device ms per step, peaks.
    times = {}
    for ann in ("exact", "lsh"):
        model = models[ann]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        med, all_ms = host_ms(lambda s: model(s, xs),
                              setup=lambda: model.init_state(B))
        peak = torch.cuda.max_memory_allocated() - held
        d_ms, on_dev = device_time(lambda: model(model.init_state(B), xs))
        times[ann] = dict(ms_per_step=med / T, all=[t / T for t in all_ms],
                          device_ms_per_step=d_ms / T or None,
                          device_launches_per_step=sum(
                              r[2] for r in on_dev) / T,
                          top_kernels=[(k_, t_ / T, c_ / T)
                                       for k_, t_, c_ in on_dev[:6]],
                          peak_bytes=peak)
        print(f"[sdnc-time] {ann} rollout: {med / T:.3f} ms/step on the host "
              f"(of {', '.join(f'{t / T:.3f}' for t in all_ms)}), device "
              f"{d_ms / T:.4f} ms/step in "
              f"{times[ann]['device_launches_per_step']:.1f} launches; peak "
              f"{peak} B above what is held (a fresh state each: "
              f"{tree_bytes(finals[ann])} B); largest: "
              + ", ".join(f"{k_[:40]} {t_:.4f} ms x{c_:.1f}"
                          for k_, t_, c_ in times[ann]["top_kernels"][:4]))
    per_step = {"exact": dict(SDNC_STEP), "lsh": dict(SDNC_LSH_STEP),
                "backward_scatter_rows": SDNC_BWD_SCATTERS}
    return dict(per_step=per_step, forward_launches=fwd_launches,
                bf16=bf16_runs,
                train=train, chunk=chunk, chunk_err=chunk_err,
                main_path_launches=main_launches, main_losses=losses,
                card_vs_cpu_grad_err=card_vs_cpu, flat=flat, fig7=fig7,
                times=times)


def stream_bytes(tree) -> int:
    """Bytes of a tree's tensors on the host side of a checkpoint."""
    return sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def stream_phase(dev, ops, ref, checker, zero_counts, counts):
    """Phase 14: the streaming trainer (`core/training.py::
    train_task_streaming`, the carry kept live by `unroll.roll_forward`),
    its checkpoints and resume, and the ~100M LM under `ResilientLoop`
    (`launch/train.py`, `examples/train_lm_100m.py`). Its checkpoints go to
    a temporary directory that it removes. Returns what was measured."""
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.core import training
    from repro_torch.core import unroll as unroll_lib
    from repro_torch.core.cell import SAMCell
    from repro_torch.core.sam import SAMConfig
    from repro_torch.core.types import (ControllerConfig, MemoryConfig,
                                        tree_bytes)
    from repro_torch.data.tasks import copy_task
    from repro_torch.distributed import fault_tolerance
    from repro_torch.examples import train_lm_100m
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import optimizers as opt

    card = card_line()
    ctl = ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                           output_size=BITS)

    def spec(kind="sam", mem_dtype="float32"):
        lsh = LSH if kind == "sam_ann" else {}
        return training.ModelSpec(kind, MemoryConfig(
            num_slots=N, word_size=W, num_heads=H, k=K, delta=DELTA,
            mem_dtype=mem_dtype, **lsh), ctl)

    def since(before):
        return {k: v - before.get(k, 0) for k, v in counts().items()
                if v - before.get(k, 0)}

    out = {"card": card}
    root = Path(tempfile.mkdtemp(prefix="stream_ckpt_"))
    saves, restores = [], []
    save0 = ckpt_lib.save_checkpoint
    restore0 = ckpt_lib.restore_checkpoint
    forward, roll = unroll_lib.unroll, unroll_lib.roll_forward
    make_step = training.make_streaming_train_step
    probe = {"check": True, "chunks": [], "lockstep": 0}

    def timed_save(directory, step, tree, mem_layout=None):
        """The trainer's (or the writer thread's) save, timed; then all but
        the newest two steps of the directory removed: the streaming
        trainer keeps every checkpoint, as JAX's does, and (a) and (b)
        would leave 16 of 1.1 GB."""
        t0 = time.perf_counter()
        path = save0(directory, step, tree, mem_layout=mem_layout)
        ms = (time.perf_counter() - t0) * 1e3
        saves.append(dict(dir=Path(directory).name, step=step, ms=ms,
                          bytes=stream_bytes(tree)))
        for old in sorted((int(p.name[5:]) for p in Path(directory).iterdir()
                           if p.name.startswith("step_")))[:-2]:
            shutil.rmtree(Path(directory) / f"step_{old}")
        return path

    def timed_restore(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = restore0(*args, **kw)
        torch.cuda.synchronize()
        restores.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                             step=result[1]))
        return result

    def probed_unroll(cell, params, state, xs, **kw):
        torch.cuda.synchronize()
        c0, t0 = counts(), time.perf_counter()
        final, ys = forward(cell, params, state, xs, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probe["cur"] = dict(
            steps=xs.shape[0], fwd_ms=(t1 - t0) * 1e3, t1=t1, c1=counts(),
            fwd=since(c0), cell=cell,
            clone=[unroll_lib._get(final, p).clone()
                   for p in cell.dense_buffers] if probe["check"] else None)
        return final, ys

    def probed_roll(state):
        cur = probe["cur"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur["bwd_ms"] = (t0 - cur["t1"]) * 1e3
        cur["bwd"] = since(cur.pop("c1"))
        cur["log_bytes"] = tree_bytes([log for _, log in getattr(
            state.memory, "redo_logs", [])])
        c0 = counts()
        state = roll(state)
        torch.cuda.synchronize()
        cur["redo_ms"] = (time.perf_counter() - t0) * 1e3
        cur["redo"] = since(c0)
        if cur["clone"] is not None:
            for p, b in zip(cur["cell"].dense_buffers, cur.pop("clone")):
                require(torch.equal(unroll_lib._get(state, p), b),
                        f"after roll_forward the carry's {p} is not the "
                        f"chunk's forward's, bit for bit")
        return state

    def probed_make_step(*args, **kw):
        init_p, init_s, step = make_step(*args, **kw)

        def chunk_step(params, opt_state, carry, xs, ts, ms):
            lockstep = probe["lockstep"] > 0
            probe["lockstep"] -= lockstep
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            c0, t0 = counts(), time.perf_counter()
            if lockstep:
                with Intercept(ops, checker=checker):
                    res = step(params, opt_state, carry, xs, ts, ms)
            else:
                res = step(params, opt_state, carry, xs, ts, ms)
            torch.cuda.synchronize()
            cur = probe.pop("cur")
            cur.update(ms=(time.perf_counter() - t0) * 1e3, all=since(c0),
                       lockstep=lockstep, cell=None,
                       peak=torch.cuda.max_memory_allocated() - held)
            require(all(torch.isfinite(t).all().item() for t in
                        pytree.tree_leaves((res[0], res[1], res[3]))
                        if t.is_floating_point()) and all(
                torch.isfinite(t.float()).all().item()
                for t in pytree.tree_leaves(res[2])
                if isinstance(t, torch.Tensor) and t.is_floating_point()),
                "a chunk step produced a NaN or an infinity")
            probe["chunks"].append(cur)
            return res
        return init_p, init_s, chunk_step

    def want_chunk(kind, c, mem_dtype="float32"):
        """Launches of one chunk step of c steps: the forward's, the
        backward's and the redo's (one 'set' a step)."""
        if kind == "sdnc":
            fwd = {"lra_topn": c, "scatter_rows": 2 * c,
                   "fused_read_sweep": c}
            bwd = {"scatter_rows": SDNC_BWD_SCATTERS * c}
        elif mem_dtype == "int8":
            fwd = {"lra_topn": c, "fused_read_sweep": c,
                   "fused_read_sweep_int8": c, "sparse_write_update": c,
                   "sparse_write_update_int8": c}
            bwd = {"scatter_rows": 4 * c, "scatter_rows_int8": 2 * c,
                   "sparse_write_update": c, "sparse_write_update_int8": c}
        else:
            fwd = ({"lsh_hash": 2 * c, "fused_read_candidates": c}
                   if kind == "sam_ann" else {"fused_read_sweep": c})
            fwd.update(lra_topn=c, sparse_write_update=c)
            bwd = {"scatter_rows": 6 * c}
        redo = {"scatter_rows": c}
        if mem_dtype == "int8":
            redo["scatter_rows_int8"] = c
        return fwd, bwd, redo

    def check_chunk(cur, kind, mem_dtype="float32"):
        fwd, bwd, redo = want_chunk(kind, cur["steps"], mem_dtype)
        for what, want in (("forward", fwd), ("backward", bwd),
                           ("redo", redo)):
            got = cur[{"forward": "fwd", "backward": "bwd",
                       "redo": "redo"}[what]]
            require(got == want, f"{kind} ({mem_dtype} rows) chunk of "
                    f"{cur['steps']} steps: the {what} launched {got}, "
                    f"expected {want}")
        total = {}
        for part in (fwd, bwd, redo):
            for k_, v in part.items():
                total[k_] = total.get(k_, 0) + v
        require(cur["all"] == total, f"{kind} chunk step launched "
                f"{cur['all']}, expected {total}")

    def same_tree(a, b, what):
        for (name, x), (_, y) in zip(ckpt_lib.flatten_with_paths(a),
                                     ckpt_lib.flatten_with_paths(b)):
            require(torch.equal(x, y), f"{name} differs: {what}")

    def leaves_of(directory, step):
        path = Path(directory) / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        return manifest, [(e["path"], path / e["file"])
                          for e in manifest["leaves"]]

    def same_checkpoint(a, b, step):
        """The two directories' checkpoints of ``step`` leaf for leaf, bit
        for bit; the first leaf that differs fails the phase."""
        ma, la = leaves_of(a, step)
        mb, lb = leaves_of(b, step)
        require(ma == mb, f"the manifests of step {step} differ")
        import numpy as np
        for (p, fa), (_, fb) in zip(la, lb):
            xa, xb = np.load(fa), np.load(fb)
            require(xa.dtype == xb.dtype and np.array_equal(
                np.atleast_1d(xa).view(np.uint8),
                np.atleast_1d(xb).view(np.uint8)),
                f"checkpoint step {step}: leaf {p} differs between the "
                f"uninterrupted and the resumed run")
        return len(la)

    stream_kw = dict(episodes=STREAM_EPISODES, chunk=STREAM_CHUNK, batch=B,
                     level=STREAM_LEVEL, max_level=STREAM_LEVEL, bits=BITS,
                     lr=LR, seed=0, ckpt_every=STREAM_EVERY, device=dev)
    T_ep = 2 * STREAM_LEVEL + 2
    n_chunks = -(-T_ep // STREAM_CHUNK)
    final = STREAM_EPISODES * n_chunks
    # The steps the trainer saves: every STREAM_EVERY chunks and at each
    # episode's end.
    save_points = sorted({*range(STREAM_EVERY, final + 1, STREAM_EVERY),
                          *range(n_chunks, final + 1, n_chunks)})
    ckpt_lib.save_checkpoint = timed_save
    ckpt_lib.restore_checkpoint = timed_restore
    unroll_lib.unroll, unroll_lib.roll_forward = probed_unroll, probed_roll
    training.make_streaming_train_step = probed_make_step
    try:
        # (a) two episodes of the copy task, chunk by chunk, the first
        # chunk in lockstep, a checkpoint every STREAM_EVERY chunks.
        dir_a = root / "a"
        probe["lockstep"] = 1
        before = dict(checker.scatter_calls)
        zero_counts()
        t0 = time.perf_counter()
        params_a, hist_a = training.train_task_streaming(
            spec(), "copy", ckpt_dir=str(dir_a), **stream_kw)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launched_a = counts()
        chunks_a = probe["chunks"]
        probe["chunks"] = []
        require(len(hist_a) == len(chunks_a) == STREAM_EPISODES * n_chunks,
                f"{len(hist_a)} chunks trained, expected "
                f"{STREAM_EPISODES * n_chunks}")
        for cur in chunks_a:
            check_chunk(cur, "sam")
        require(launched_a["scatter_rows"] > 0 and all(
            launched_a[k_] > 0 for k_ in FORWARD), f"the stream launched "
            f"{launched_a}")
        steps_a = sum(c["steps"] for c in chunks_a)
        # Times and peaks of the chunks outside lockstep (the first's
        # plain versions copy the memory at every call).
        timed = [c for c in chunks_a if not c["lockstep"]]
        steps_t, ms_t = (sum(c[k_] for c in timed) for k_ in ("steps", "ms"))
        lock_ms = sum(c["ms"] for c in chunks_a if c["lockstep"])
        peak_a = max(c["peak"] for c in timed)
        body = [c for c in timed if c["steps"] == STREAM_CHUNK]
        med = {k_: sorted(c[k_] for c in body)[len(body) // 2]
               for k_ in ("ms", "fwd_ms", "bwd_ms", "redo_ms")}
        s_cell = SAMCell(SAMConfig(spec().memory, ctl))
        s_tmpl = s_cell.init_state(B, device=dev)
        acct = unroll_lib.residual_accounting(
            s_cell, None, s_tmpl,
            torch.zeros((STREAM_CHUNK, B, BITS + 2), device=dev),
            mode="sparse")
        clone_bytes = tree_bytes([unroll_lib._get(s_tmpl, p)
                                  for p in s_cell.dense_buffers])
        del s_tmpl
        ct_bytes = B * (N + 1) * W * 4
        log_bytes = max(c["log_bytes"] for c in chunks_a)
        res_bytes = acct["residual_bytes"] - acct["state_bytes"]
        reckoned = res_bytes + ct_bytes + log_bytes + clone_bytes
        saves_a = [s for s in saves if s["dir"] == "a"]
        print(f"[stream] (a) {STREAM_EPISODES} episodes of T={T_ep} (copy, "
              f"N={N}, B={B}, f32 rows, exact read) in {len(chunks_a)} "
              f"chunks of {STREAM_CHUNK} (the last of each episode "
              f"{T_ep - (n_chunks - 1) * STREAM_CHUNK}): chunk 1 in "
              f"lockstep (scatter_rows calls checked "
              f"{ {m: c - before[m] for m, c in checker.scatter_calls.items()} }"
              f"); after every chunk the carry's memory and usage table "
              f"equal a clone taken after its forward, bit for bit; "
              f"launches exact a chunk (read, write, LRA one a step; "
              f"scatter 6 a backward step and 1 a redo step, nothing else "
              f"in the redo); total {launched_a}; {card}")
        print(f"[stream] (a) chunk step {med['ms']:.2f} ms (median of "
              f"{len(body)} full chunks): forward {med['fwd_ms']:.2f}, "
              f"backward {med['bwd_ms']:.2f}, redo {med['redo_ms']:.2f} ms; "
              f"{steps_t / ms_t * 1e3:.1f} time steps trained a second "
              f"outside lockstep ({steps_t / (wall_a - lock_ms / 1e3):.1f} "
              f"with the saves; {wall_a:.2f} s in all, {lock_ms:.0f} ms of "
              f"it the lockstep chunk); a chunk step's peak above the held "
              f"carry {peak_a} B (the largest outside lockstep) against a "
              f"chunk's residuals (residual_accounting(mode='sparse') "
              f"without the state) {res_bytes} B + the cotangent "
              f"{ct_bytes} B + the redo log {log_bytes} B + this phase's "
              f"clone of the carry's buffers {clone_bytes} B = {reckoned} "
              f"B; {card}")
        for s in saves_a:
            print(f"[stream] (a) save of step {s['step']}: {s['ms']:.1f} ms "
                  f"blocking the loop (synchronous, as JAX's trainer: the "
                  f"copy to the host and the files); {s['bytes']} B")
        out["a"] = dict(
            chunks=len(chunks_a), steps=steps_a, wall_s=wall_a,
            lockstep_ms=lock_ms,
            chunk_ms=med["ms"], fwd_ms=med["fwd_ms"], bwd_ms=med["bwd_ms"],
            redo_ms=med["redo_ms"],
            all_chunk_ms=[c["ms"] for c in chunks_a],
            steps_per_s=steps_t / ms_t * 1e3,
            steps_per_s_with_saves=steps_t / (wall_a - lock_ms / 1e3),
            peak_bytes=peak_a, residual_bytes=res_bytes,
            cotangent_bytes=ct_bytes, log_bytes=log_bytes,
            clone_bytes=clone_bytes,
            launches=launched_a, chunk_launches=chunks_a[1]["all"],
            saves=saves_a, losses=[h["loss"] for h in hist_a])

        # (b) killed after STREAM_STOP chunks, then resumed: the same run.
        probe["check"] = False
        dir_b = root / "b"
        _, hist_b1 = training.train_task_streaming(
            spec(), "copy", ckpt_dir=str(dir_b),
            stop_after_chunks=STREAM_STOP, **stream_kw)
        require(len(hist_b1) == STREAM_STOP, f"the killed run trained "
                f"{len(hist_b1)} chunks")
        n_restores = len(restores)
        params_b, hist_b2 = training.train_task_streaming(
            spec(), "copy", ckpt_dir=str(dir_b), **stream_kw)
        restore = restores[n_restores]
        resumed_at = (hist_b2[0]["episode"], hist_b2[0]["chunk"])
        last = max(s for s in save_points if s <= STREAM_STOP)
        require(resumed_at == divmod(last, n_chunks), f"resumed at "
                f"{resumed_at}, expected {divmod(last, n_chunks)}")
        require(hist_b2 == hist_a[last:], "the resumed run's history differs "
                "from the uninterrupted run's")
        same_tree(params_a, params_b, "the uninterrupted and the resumed "
                  "run's parameters")
        compared = {step: same_checkpoint(dir_a, dir_b, step)
                    for step in save_points[-2:]}
        print(f"[stream] (b) killed after {STREAM_STOP} chunks (episode "
              f"{STREAM_STOP // n_chunks}, chunk {STREAM_STOP % n_chunks}), "
              f"resumed from step {restore['step']} at episode "
              f"{resumed_at[0]}, chunk {resumed_at[1]} in "
              f"{restore['ms']:.1f} ms (the restore); history, parameters "
              f"and the checkpoints of steps {sorted(compared)} (params, "
              f"RMSProp state, carry, loop: {compared} leaves) equal the "
              f"uninterrupted run's bit for bit; {card}")
        out["b"] = dict(stop=STREAM_STOP, resumed_step=restore["step"],
                        resumed_at=resumed_at, restore_ms=restore["ms"],
                        compared_steps=sorted(compared))
        del params_b, hist_b1, hist_b2
        probe["chunks"] = []

        # (c) two chunks each of sam_ann, sam on int8 rows and the SDNC.
        probe["check"] = True
        # A copy of 40 bits: the answer (steps 42-81) is the second chunk.
        inputs, targets, mask = copy_task(
            B, 40, STREAM_LEVEL, BITS, device=dev,
            generator=torch.Generator().manual_seed(21))
        xs_c, ts_c, ms_c = (t.transpose(0, 1) for t in (inputs, targets,
                                                         mask))
        out["c"] = {}
        for kind, mem_dtype in (("sam_ann", "float32"), ("sam", "int8"),
                                ("sdnc", "float32")):
            init_p, init_s, step = training.make_streaming_train_step(
                spec(kind, mem_dtype), LR, device=dev)
            p_c = init_p(torch.Generator().manual_seed(0))
            o_c, carry = opt.rmsprop_init(p_c), init_s(B)
            probe["lockstep"] = 1
            for c in range(2):
                sl = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
                p_c, o_c, carry, loss, _ = step(p_c, o_c, carry, xs_c[sl],
                                                ts_c[sl], ms_c[sl])
            for cur in probe["chunks"]:
                check_chunk(cur, kind, mem_dtype)
            cur = probe["chunks"][-1]
            print(f"[stream] (c) {kind} ({mem_dtype} rows), two chunks of "
                  f"{STREAM_CHUNK}, the first in lockstep: the carry after "
                  f"roll_forward equals its forward's, bit for bit; redo "
                  f"launches {cur['redo']} a chunk, forward {cur['fwd']}, "
                  f"backward {cur['bwd']}; chunk step {cur['ms']:.2f} ms "
                  f"(forward {cur['fwd_ms']:.2f}, backward "
                  f"{cur['bwd_ms']:.2f}, redo {cur['redo_ms']:.2f}); loss "
                  f"{loss.item():.6f}; {card}")
            out["c"][f"{kind}/{mem_dtype}"] = dict(
                redo=cur["redo"], fwd=cur["fwd"], bwd=cur["bwd"],
                ms=cur["ms"], fwd_ms=cur["fwd_ms"], bwd_ms=cur["bwd_ms"],
                redo_ms=cur["redo_ms"], log_bytes=cur["log_bytes"])
            probe["chunks"] = []
            del p_c, o_c, carry
            torch.cuda.empty_cache()
    finally:
        ckpt_lib.save_checkpoint = save0
        ckpt_lib.restore_checkpoint = restore0
        unroll_lib.unroll, unroll_lib.roll_forward = forward, roll
        training.make_streaming_train_step = make_step

    # (d) the ~100M LM under ResilientLoop: a clean run, and one with two
    # transient errors that is then stopped and resumed.
    cfg = train_lm_100m.config_100m(LM100_SLOTS)
    step_ms, run_checks, blocking = [], [], []
    saved, restored = {}, []
    hooks = []                  # each run's failure hook, in order
    make_train = train_mod.make_train_step
    loop0 = train_mod.ResilientLoop

    def timed_make_train(*args, **kw):
        fn = make_train(*args, **kw)

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return res
        return timed

    class Loop(loop0):
        """`launch.train`'s loop with the run's failure hook, the saves it
        hands its checkpointer timed and (at step LM100_EVERY) kept on the
        card, and its restore kept: to compare with, not part of the
        run."""

        def __post_init__(self):
            super().__post_init__()
            self.failure_hook = hooks.pop(0)
            save = self._ckpt.save

            def spied(step, tree):
                t0 = time.perf_counter()
                save(step, tree)
                blocking.append((time.perf_counter() - t0) * 1e3)
                if step == LM100_EVERY:
                    saved[self.ckpt_dir] = pytree.tree_map(
                        lambda t: t.clone(), tree)
            self._ckpt.save = spied

        def restore_or(self, template):
            state, start = super().restore_or(template)
            if start:
                restored.append((pytree.tree_map(lambda t: t.clone(), state),
                                 start))
            return state, start

        def run(self, *args, **kw):
            result = super().run(*args, **kw)
            run_checks.append(ckpt_lib.latest_step(self.ckpt_dir))
            return result

    def lm_run(name, hook=None):
        hooks.append(hook)
        return train_mod.train(
            cfg=cfg, steps=LM100_STEPS, batch=LM100_B, seq=LM100_S, lr=3e-4,
            ckpt_dir=str(root / name), ckpt_every=LM100_EVERY, log_every=1,
            seed=0, device=dev)

    flaky = {"left": 2}

    def flaky_then_stop(step):
        if step == LM100_FLAKY and flaky["left"]:
            flaky["left"] -= 1
            raise fault_tolerance.TransientError("injected")
        if step == LM100_STOP:
            raise RuntimeError("stopped")

    ckpt_lib.save_checkpoint = timed_save
    train_mod.make_train_step, train_mod.ResilientLoop = (timed_make_train,
                                                          Loop)
    try:
        n_saves = len(saves)
        clean, log_clean = lm_run("lm_clean")
        require(run_checks[-1] == LM100_STEPS - 1, f"the final save (step "
                f"{LM100_STEPS - 1}) was not on disk when run returned: "
                f"latest {run_checks[-1]}")
        ms_clean = list(step_ms)
        lm_saves = saves[n_saves:]
        try:
            lm_run("lm_stop", flaky_then_stop)
            raise SmokeFailure("the stopped run did not stop")
        except RuntimeError as e:
            require(str(e) == "stopped", f"the stopped run raised {e!r}")
        require(flaky["left"] == 0, "the transient errors were not raised")
        same_tree(saved[str(root / "lm_clean")], saved[str(root / "lm_stop")],
                  f"the state saved at step {LM100_EVERY} of the run with "
                  f"two transient errors and of the clean run")
        resumed, _ = lm_run("lm_stop")
        state_r, start = restored[-1]
        require(start == LM100_EVERY + 1, f"resumed at step {start}, "
                f"expected {LM100_EVERY + 1}")
        same_tree(saved[str(root / "lm_stop")], state_r,
                  f"the restored state is not the one saved at step "
                  f"{LM100_EVERY}")
        disk, at = ckpt_lib.restore_checkpoint(str(root / "lm_stop"),
                                               resumed)
        require(at == LM100_STEPS - 1, f"the resumed run's last save is "
                f"step {at}")
        same_tree(disk, resumed, "the resumed run's final save is not its "
                  "final state")
        n_params = sum(t.numel() for t in pytree.tree_leaves(clean[0]))
        ck_bytes = lm_saves[0]["bytes"]
        body_ms = sorted(ms_clean[1:])[len(ms_clean[1:]) // 2]
        block_s = ", ".join(f"{b:.1f}" for b in blocking[:len(lm_saves)])
        writer_s = ", ".join(f"{s['ms']:.1f}" for s in lm_saves)
        print(f"[stream] (d) {cfg.name} ({n_params} parameters, memory "
              f"{LM100_SLOTS} x {cfg.memory.word_size} every "
              f"{cfg.memory.every_n_layers} layers), B={LM100_B}, "
              f"S={LM100_S}, {LM100_STEPS} steps under ResilientLoop, a "
              f"checkpoint every {LM100_EVERY}: with two TransientErrors at "
              f"step {LM100_FLAKY} a run saves at step {LM100_EVERY} the "
              f"clean run's weights and AdamW state bit for bit; stopped at "
              f"step {LM100_STOP}, it resumed at step {start} with the state "
              f"saved at step {LM100_EVERY}, bit for bit; the final save was on disk when run returned; "
              f"step {body_ms:.2f} ms (median of {len(ms_clean) - 1} after "
              f"the first, first {ms_clean[0]:.1f}); saves: blocking "
              f"{block_s} ms, the writer {writer_s} ms; {ck_bytes} B a "
              f"checkpoint; {card}")
        out["d"] = dict(params=n_params, step_ms=body_ms,
                        all_step_ms=ms_clean, resumed_at=start,
                        blocking_ms=blocking[:len(lm_saves)],
                        writer_ms=[s["ms"] for s in lm_saves],
                        checkpoint_bytes=ck_bytes,
                        losses=[m["loss"] for _, m in log_clean])
    finally:
        ckpt_lib.save_checkpoint = save0
        train_mod.make_train_step, train_mod.ResilientLoop = make_train, loop0
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def attn_pairs(S: int, window=None, prefix=0) -> int:
    """The (query, key) pairs of causal attention over S positions within
    a window, and with every key below the prefix seen by every query:
    Σ_q |[max(0, q - window + 1), q] ∪ [0, min(prefix, S))| (S(S+1)/2
    with neither; Σ_q max(q + 1, prefix) with a prefix alone)."""
    q = torch.arange(S, dtype=torch.int64)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    P = min(prefix, S)
    overlap = ((q + 1).clamp(max=P) - lo.clamp(max=P)).clamp(min=0)
    return int((q - lo + 1 + P - overlap).sum())


def attn_visible(S: int, window, prefix, device) -> torch.Tensor:
    """(S, S) bool: query i sees key j where 0 <= i - j (< window, with
    one) or j < prefix: JAX's (causal & window) | key < prefix."""
    pos = torch.arange(S, device=device)
    gap = pos[:, None] - pos[None, :]
    mask = gap >= 0
    if window is not None:
        mask &= gap < window
    return mask | (pos[None, :] < prefix)


def attention_row(ref, kernel, q, k, v, flush, window=None, prefix=0,
                  tag="swa") -> dict:
    """The attention kernel's row at q, k, v: its ms, its plain version's,
    one PyTorch call's and the bound. The bound: q·kᵀ takes 2·D flop and
    p·v 2·DV a (query, key) pair of `attn_pairs` (DV = D but for MLA's
    (192, 128)). On f32 inputs both are f32 FMAs (no TF32). On bf16 inputs
    q·kᵀ is exact on the bf16 tensor cores (f32 sums), and p·v with p at
    f32 precision, as the TPU kernel keeps it, is two bf16 products (p_hi
    and p_lo; TF32 at half the rate gives the same time): q·kᵀ + 2·p·v at
    the bf16 rate. The library call is `scaled_dot_product_attention` with
    GQA: causal (where v is narrower than q·k, each fused backend in turn,
    the refusals printed and kept in ``library_refused``), or with the (S,
    S) mask of the window or the prefix (`attn_visible`) on the
    efficient-attention backend (k and v repeated to the query heads where
    it refuses GQA); a yardstick only, its call named in
    ``library_call``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    Bq, S_, Hq, D_ = q.shape
    DV = v.shape[-1]
    pairs = attn_pairs(S_, window, prefix) * Bq * Hq
    qk, pv = pairs * 2 * D_, pairs * 2 * DV
    on_tc = qk + 2 * pv if q.dtype == torch.bfloat16 else 0
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib, how, refused = None, "causal, enable_gqa", []
    try:
        if window is None and not prefix and DV == D_:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10, flush)
        elif window is None and not prefix:
            for backend in (SDPBackend.FLASH_ATTENTION,
                            SDPBackend.EFFICIENT_ATTENTION,
                            SDPBackend.CUDNN_ATTENTION):
                try:
                    with sdpa_kernel([backend]):
                        lib = time_ms(lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True), 10,
                            flush)
                    how = f"causal, enable_gqa, {backend.name}"
                    break
                except RuntimeError as e:
                    refused.append(backend.name)
                    print(f"[{tag}] scaled_dot_product_attention "
                          f"({backend.name}, v {DV} wide, q·k {D_}) refused: "
                          f"{str(e)[:120]}")
        else:
            mask = attn_visible(S_, window, prefix, q.device)
            what = "window" if window is not None else "prefix"
            G = Hq // kt.shape[1]
            kr, vr = kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1)
            tries = [(kt, vt, True, "enable_gqa"),
                     (kr, vr, False, "k and v repeated")]
            for k_, v_, gqa, name in tries:
                def call(k_=k_, v_=v_, gqa=gqa):
                    return F.scaled_dot_product_attention(
                        qt, k_, v_, attn_mask=mask, enable_gqa=gqa)
                try:
                    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                        lib = time_ms(call, 10, flush)
                    how = f"{what} mask, efficient attention, {name}"
                    break
                except RuntimeError as e:
                    print(f"[{tag}] scaled_dot_product_attention "
                          f"(efficient attention, {name}) refused: "
                          f"{str(e)[:120]}")
            del kr, vr
    except RuntimeError as e:             # a yardstick only
        print(f"[time] scaled_dot_product_attention not timed: {e}")
        lib = None
    del qt, kt, vt
    torch.cuda.empty_cache()
    return dict(
        ms=time_ms(lambda: kernel(q, k, v, window=window, prefix=prefix), 10,
                   flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, window,
                                                         prefix), 3, flush),
        library_ms=lib, library_call=how, library_refused=refused,
        bound=bound((q.numel() + k.numel() + v.numel() + Bq * S_ * Hq * DV)
                    * q.element_size(), 0 if on_tc else qk + pv, on_tc))


def first_stable(ops, ref, run, what, seeds=64):
    """(seed, run(generator)) for the first seed of 0 .. seeds - 1 whose
    reads (through ``ops.fused_read``) hold no near-tie at K
    (`stable_reads`): rows written from zero tie (ROADMAP §C)."""
    fused_read = ops.fused_read
    seen = []

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        seen.append((q.detach().clone(), mem.detach().clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    for seed in range(seeds):
        seen.clear()
        ops.fused_read = record
        try:
            got = run(torch.Generator().manual_seed(seed))
        finally:
            ops.fused_read = fused_read
        if stable_reads(ref, seen):
            return seed, got
    raise SmokeFailure(f"no token seed of 0-{seeds - 1} gives {what} no "
                       f"read near-tie at K")


def grads_close(p_cpu, cfg, batch, g_gpu, g_cpu, draws=1):
    """The card's `loss_fn` gradients against the CPU's, leaf by leaf:
    within atol NAIVE_ATOL / rtol NAIVE_RTOL, or, where a leaf is not, no
    further than twice the CPU's own move under a one-ulp perturbation of
    every weight (1 + 2^-24·N(0, 1)), the arbiter: the largest move over
    ``draws`` independent perturbations. Returns (max error, [(leaf,
    error, the CPU's own move)] of the arbitered leaves)."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map

    def spread():
        gen = torch.Generator().manual_seed(1)
        runs = []
        for _ in range(draws):
            p2 = tree_map(lambda t: t * (1 + torch.randn(
                t.shape, generator=gen) * 2 ** -24), p_cpu)
            runs.append(pytree.tree_leaves(
                steps.value_and_grad(p2, cfg, batch)[2]))
        return runs

    own, grad_err, arbitered = None, 0.0, []
    leaves_c = pytree.tree_leaves(g_cpu)
    for i, (a, b) in enumerate(zip(pytree.tree_leaves(g_gpu), leaves_c)):
        a = a.float().cpu()
        d = (a - b).abs()
        grad_err = max(grad_err, d.max().item())
        if bool((d <= NAIVE_ATOL + NAIVE_RTOL * b.abs()).all()):
            continue
        own = spread() if own is None else own
        cpu_own = max((run[i] - b).abs().max().item() for run in own)
        arbitered.append((i, d.max().item(), cpu_own))
        require(d.max().item() <= 2 * cpu_own, f"loss gradient leaf {i}: "
                f"card against CPU {d.max().item():.3g}, beyond atol "
                f"{NAIVE_ATOL} / rtol {NAIVE_RTOL} and twice the CPU's own "
                f"move under a one-ulp perturbation ({cpu_own:.3g})")
    return grad_err, arbitered


def swa_phase(dev, ops, ref, checker, zero_counts, counts, flush, ptxas):
    """Phase 15: the sliding-window LM (H2O-Danube3-4B + SAM) served at
    full width. ``ptxas`` is the attention library's `-Xptxas -v` report.
    Returns the D = 120 attention rows (f32 at layer 4's prefill inputs,
    bf16 at layer 0's), their prefill launches and the numbers."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.engine import Request, ServeEngine, SessionStore
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map

    cfg = get_config(SWA_ARCH)
    m = cfg.memory
    groups = cfg.num_layers // m.every_n_layers
    segments = SWA_S // m.segment
    per = m.every_n_layers
    require(cfg.window is not None and cfg.head_dim == 120
            and cfg.act == "silu", f"{SWA_ARCH}: window {cfg.window}, "
            f"head_dim {cfg.head_dim}, act {cfg.act}")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # The D = 120 instantiations: registers and spills from ptxas, and the
    # dynamic shared memory their launcher asks for (the D = 128 tile's:
    # f32 q, k, v and p; bf16 q and two k and v slots, rows padded by 8).
    lines = ptxas_summary(ptxas)
    d120 = {("bf16" if "bf16" in line else "f32"): lines[i + 1:i + 3]
            for i, line in enumerate(lines) if "ILi120E" in line}
    smem = {"f32": (3 * 64 * 128 + 64 * 64) * 4, "bf16": 5 * 64 * 136 * 2}
    require(sorted(d120) == ["bf16", "f32"] and not any(
        re.search(r"[1-9][0-9]* bytes spill", line)
        for r in d120.values() for line in r),
        f"flash_attention<120> (ptxas): {d120}")
    out["d120_ptxas"] = {k: " | ".join(v) for k, v in d120.items()}
    print("[swa] flash_attention at D = 120: " + "; ".join(
        f"{k}: {' | '.join(v)}, {smem[k]} B of dynamic shared memory"
        for k, v in sorted(d120.items())))

    # (e) first, at the reduced config in f32 with Danube's head_dim 120
    # (so that the D = 120 path itself is compared; window 32): the card
    # against the plain versions on the CPU. The tokens of the prefill and
    # of the loss: each the first seed of 0-63 whose CPU reads hold no
    # near-tie at K (rows written from zero tie: ROADMAP §C).
    small = dataclasses.replace(reduced(cfg), head_dim=120,
                                compute_dtype="float32")
    p_cpu = lm.init_params(small, seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    def prefill_case(gen):
        toks = torch.randint(0, small.vocab_size, (2, SWA_SMALL_S),
                             generator=gen)
        return toks, lm.prefill(p_cpu, small, {"tokens": toks})

    def loss_case(gen):
        batch = {k: torch.randint(0, small.vocab_size, (2, SWA_SMALL_S // 2),
                                  generator=gen)
                 for k in ("tokens", "targets")}
        return batch, steps.value_and_grad(p_cpu, small, batch)

    seed, (toks_s, want) = first_stable(ops, ref, prefill_case,
                                        "the reduced Danube's prefill")
    loss_seed, (batch_s, g_cpu) = first_stable(ops, ref, loss_case,
                                               "the reduced Danube's loss")
    zero_counts()
    got = lm.prefill(p_gpu, small, {"tokens": toks_s.to(dev)})
    errs = {"prefill": card_close(got, want, "prefill logits")}
    require(counts()["flash_attention"] == small.num_layers,
            "the reduced prefill did not run the attention kernel")
    res = {}
    for name, p_, d_ in (("cpu", p_cpu, "cpu"), ("cuda", p_gpu, dev)):
        cache = lm.init_cache(small, 2, SWA_SMALL_MAX_LEN, device=d_)
        res[name] = lm.decode_scan(p_, small, cache,
                                   toks_s[:, :SWA_SMALL_DECODE].to(d_))
    errs["decode"] = card_close(res["cuda"][0], res["cpu"][0], "decode logits")
    errs["ring"] = max(card_close(res["cuda"][1][kk], res["cpu"][1][kk], kk)
                       for kk in ("k", "v"))
    require(res["cuda"][1]["k"].shape[2] == small.window
            and int(res["cuda"][1]["pos"]) == SWA_SMALL_DECODE,
            "decode: the ring's size or the position is off")
    zero_counts()
    g_gpu = steps.value_and_grad(p_gpu, small,
                                 {k: v.to(dev) for k, v in batch_s.items()})
    require(counts()["flash_attention"] == small.num_layers,
            "the loss's forward did not run the attention kernel")
    errs["loss"] = card_close(g_gpu[0], g_cpu[0], "loss")
    grad_err, arbitered = grads_close(p_cpu, small, batch_s, g_gpu[2],
                                      g_cpu[2])
    errs["grad"] = grad_err
    out.update(card_vs_cpu_err=errs, card_vs_cpu_seeds=(seed, loss_seed),
               card_vs_cpu_grad_arbitered=arbitered)
    print(f"[swa] reduced {SWA_ARCH} at head_dim 120, window 32 (f32) on "
          f"the card against the CPU (token seeds {seed}, {loss_seed}): "
          f"prefill logits "
          f"{errs['prefill']:.3g}, decode_scan of {SWA_SMALL_DECODE} tokens "
          f"into a ring of {small.window} {errs['decode']:.3g}, the rings "
          f"{errs['ring']:.3g} (bar {SLICE_TOL} of max(1, |CPU|)); loss "
          f"{errs['loss']:.3g}, gradients max {grad_err:.3g} (atol "
          f"{NAIVE_ATOL} / rtol {NAIVE_RTOL}; leaves beyond, held to twice "
          f"the CPU's own one-ulp move: {arbitered})")
    del p_cpu, p_gpu, res, got, want, g_cpu, g_gpu
    torch.cuda.empty_cache()
    part("e")

    # (b) the prefill at full width, in lockstep: every attention launch
    # against its plain version with the window, the memory kernels too.
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    out.update(params=n_params, param_bytes=param_bytes)
    print(f"[swa] {SWA_ARCH}: {n_params} parameters, {param_bytes} B in "
          f"bf16, drawn on the card in {time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab_size, (SWA_B, SWA_S),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    zero_counts()
    with torch.inference_mode(), Intercept(ops, checker=checker), \
            FlashCheck(ops, ref, keep=(0, per)) as fc:
        logits = lm.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    launched = counts()
    want_counts = {name: 0 for name in launched}
    want_counts.update({"flash_attention": cfg.num_layers,
                        **{name: groups * segments for name in FORWARD}})
    require(launched == want_counts, f"prefill launches {launched}, expected "
            f"{want_counts}")
    by_dtype = [str(c["dtype"])[6:] for c in fc.checks]
    require(by_dtype == ["bfloat16"] * per
            + ["float32"] * (cfg.num_layers - per)
            and all(c["window"] == cfg.window for c in fc.checks),
            f"prefill attention launches by dtype {by_dtype}: expected "
            f"{per} bf16, then f32, each with the window")
    require(logits.dtype == torch.float32
            and logits.shape == (SWA_B, 1, cfg.vocab_size)
            and torch.isfinite(logits).all().item(),
            "prefill logits are not finite f32 of shape (B, 1, V)")
    conditioned = [c for c in fc.checks if "exact_err" in c]
    bf16_err = max(c["err"] for c in fc.checks[:per])
    f32_err = max(c["err"] for c in fc.checks[per:])
    out.update(prefill_launches=launched, flash_bf16_max_err=bf16_err,
               flash_f32_max_err=f32_err,
               flash_f32_above_tol=len(conditioned),
               flash_f32_exact_err=max((c["exact_err"] for c in conditioned),
                                       default=None),
               flash_f32_plain_exact_err=max(
                   (c["plain_exact_err"] for c in conditioned), default=None))
    print(f"[swa] prefill (B={SWA_B}, S={SWA_S}, window {cfg.window}) in "
          f"lockstep: launches { {k: v for k, v in launched.items() if v} } "
          f"({per} bf16 + {cfg.num_layers - per} f32 attention launches); "
          f"flash against plain: bf16 max err {bf16_err:.3g}, f32 "
          f"{f32_err:.3g}; {len(conditioned)} f32 launches above "
          f"{FLASH_TOL}, held against f64: kernel "
          f"{out['flash_f32_exact_err'] or 0:.3g}, plain "
          f"{out['flash_f32_plain_exact_err'] or 0:.3g}; memory kernels: read "
          f"err {checker.err['fused_read_sweep']:.3g}, write err "
          f"{checker.err['sparse_write_update']:.3g}, near-ties "
          f"{checker.near_ties}")

    part("b")

    # (a) the kernel at layer 0's (bf16) and layer 4's (f32) inputs.
    q0, k0, v0 = fc.kept[0]
    q4, k4, v4 = fc.kept[per]
    del fc
    require(q0.dtype == torch.bfloat16 and q4.dtype == torch.float32
            and q4.shape == (SWA_B, SWA_S, cfg.num_heads, 120),
            f"layer 0 ran {q0.dtype}, layer {per} {q4.dtype} "
            f"{tuple(q4.shape)}")
    row_f32 = attention_row(ref, flash_attention, q4, k4, v4, flush,
                            cfg.window)
    row_bf16 = attention_row(ref, flash_attention, q0, k0, v0, flush,
                             cfg.window)
    del q0, k0, v0, q4, k4, v4
    for name, r in (("f32 (layer 4)", row_f32), ("bf16 (layer 0)", row_bf16)):
        lib = "none" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms ({r['library_call']}; "
            f"{r['ms'] / r['library_ms']:.2f}x its time)")
        print(f"[time] flash_attention {name} at Danube's prefill (B={SWA_B},"
              f" S={SWA_S}, H={cfg.num_heads} over {cfg.num_kv_heads}, D=120,"
              f" window {cfg.window}): "
              f"{r['ms']:.4f} ms (bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}: {r['bound'][0] / r['ms']:.1%} of it), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}")

    part("a")

    # The prefill's host ms, peak and device-busy share.
    def prefill_run(_):
        lm.prefill(params, cfg, {"tokens": toks})

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, prefill_all = host_ms(prefill_run, runs=SWA_PREFILL_RUNS)
    prefill_peak = torch.cuda.max_memory_allocated() - held
    dev_ms, on_dev = device_time(lambda: prefill_run(None))
    out.update(prefill_ms=prefill_ms, prefill_ms_all=prefill_all,
               prefill_peak_bytes=prefill_peak, held_bytes=held,
               prefill_device_ms=dev_ms or None,
               prefill_busy_share=(dev_ms / prefill_ms) if dev_ms else None,
               prefill_tokens_per_s=SWA_B * SWA_S / prefill_ms * 1e3)
    print(f"[time] Danube prefill (B={SWA_B}, S={SWA_S}) {prefill_ms:.1f} ms"
          f", median of {', '.join(f'{t:.1f}' for t in prefill_all)} "
          f"({out['prefill_tokens_per_s']:.0f} tokens/s); peak {prefill_peak} "
          f"B above the {held} B held ({param_bytes} B of weights); "
          + (f"{dev_ms:.1f} ms of kernels ({dev_ms / prefill_ms:.1%} busy); "
             f"by kernel (ms, launches): "
             + "; ".join(f"{kk[:50]} {t:.1f} ({c})"
                         for kk, t, c in on_dev[:5])
             if dev_ms else "device time not measured (the profiler "
             "recorded none)"))
    del logits
    torch.cuda.empty_cache()
    part("b timed")

    # (c) the decode with memory states: a SWA_PROMPT-token prompt, then
    # SWA_GEN greedy tokens, into a ring of SWA_MAX_LEN slots (it wraps):
    # launches counted on every token, the memory kernels in lockstep on
    # the greedy ones, which cross the wrap (a checked write clones the
    # 134 MB memory: the prompt's 672 checks would take a minute).
    cache = lm.init_cache(cfg, SWA_B, SWA_MAX_LEN, device=dev)
    require(cache["k"].shape == (cfg.num_layers, SWA_B, SWA_MAX_LEN,
                                 cfg.num_kv_heads, 120),
            f"the ring has shape {tuple(cache['k'].shape)}")
    mem = lm.init_memory_states(cfg, SWA_B, device=dev)
    zero_counts()
    d_logits, cache, mem = lm.decode_scan(params, cfg, cache,
                                          toks[:, :SWA_PROMPT],
                                          mem_states=mem)
    after_prompt = counts()
    with torch.inference_mode(), Intercept(ops, checker=checker):
        per_token = []
        for _ in range(SWA_GEN):
            tok = d_logits[:, -1].float().argmax(-1).to(torch.int32)
            zero_counts()
            d_logits, cache, mem = lm.decode_step(params, cfg, cache,
                                                  tok[:, None],
                                                  mem_states=mem)
            per_token.append(counts())
    torch.cuda.synchronize()
    one = {name: 0 for name in after_prompt}
    one.update({name: groups for name in FORWARD})
    require(after_prompt == {kk: vv * SWA_PROMPT for kk, vv in one.items()},
            f"prompt launches {after_prompt}")
    require(all(c == one for c in per_token), f"a decode step launched "
            f"{[c for c in per_token if c != one][:1]}, expected {one}")
    n_tok = SWA_PROMPT + SWA_GEN
    require(d_logits.dtype == torch.bfloat16
            and torch.isfinite(d_logits).all().item()
            and int(cache["pos"]) == n_tok
            and all(int(st.step) == n_tok for st in mem),
            "decode: logits not finite bf16, or the position or the steps "
            "are off")
    state = {"cache": cache, "mem": mem}

    def rewind():
        state["cache"] = {**state["cache"], "pos": torch.tensor(
            SWA_PROMPT, dtype=torch.int32, device=dev)}

    def decode_window(_, steps=SWA_GEN):
        tok = torch.ones((SWA_B, 1), dtype=torch.int32, device=dev)
        for _ in range(steps):
            lg, state["cache"], state["mem"] = lm.decode_step(
                params, cfg, state["cache"], tok, mem_states=state["mem"])
            tok = lg[:, -1].float().argmax(-1).to(torch.int32)[:, None]

    window_ms, window_all = host_ms(decode_window, runs=1, setup=rewind)
    decode_ms = window_ms / SWA_GEN
    rewind()
    ddev_ms, _ = device_time(lambda: decode_window(None, PROFILE_STEPS))
    ddev_ms /= PROFILE_STEPS
    out.update(decode_ms_per_token=decode_ms,
               decode_ms_per_token_all=[t / SWA_GEN for t in window_all],
               decode_device_ms=ddev_ms or None,
               decode_busy_share=(ddev_ms / decode_ms) if ddev_ms else None)
    print(f"[swa] decode_scan with memory states: {SWA_PROMPT} prompt tokens "
          f"and {SWA_GEN} greedy ones (in lockstep) into a ring of "
          f"{SWA_MAX_LEN} slots (wrapped at {SWA_MAX_LEN}), "
          f"{one['fused_read_sweep']} read, write and LRA launches and no "
          f"attention launch a token")
    print(f"[time] Danube decode with memory (B={SWA_B}): {decode_ms:.3f} ms "
          f"a token on the host (windows of {SWA_GEN}: "
          f"{', '.join(f'{t / SWA_GEN:.3f}' for t in window_all)}); "
          + (f"{ddev_ms:.3f} ms of kernels ({ddev_ms / decode_ms:.1%} busy, "
             f"a profiled window of {PROFILE_STEPS} steps)"
             if ddev_ms else "device time not measured"))
    del cache, mem, state, d_logits
    torch.cuda.empty_cache()
    part("c")

    # The static serving driver, once (no memory op and, decoding only, no
    # attention kernel), past the end of its ring.
    zero_counts()
    served = serve(SWA_ARCH, use_reduced=False, batch=SWA_B,
                   prompt_len=SWA_PROMPT, gen_len=SWA_GEN,
                   max_len=SWA_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    tokens = served["tokens"]
    require(tokens.shape == (SWA_B, SWA_GEN)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
            and not any(counts().values()),
            "serve: tokens out of shape or range, or a kernel launched")
    out.update(serve_prefill_s=served["prefill_s"],
               serve_decode_tok_per_s=served["decode_tok_per_s"])
    print(f"[swa] serve(--full, max_len {SWA_MAX_LEN}): {tuple(tokens.shape)} "
          f"greedy tokens past the ring's end; prefill "
          f"{served['prefill_s']:.2f} s, decode "
          f"{served['decode_tok_per_s']:.1f} tok/s")
    del served, tokens
    torch.cuda.empty_cache()
    part("serve")

    # (d) the engine on SWA_LANES lanes of SWA_MAX_LEN: SWA_REQUESTS
    # requests and a returning user whose second request takes its session
    # past SWA_MAX_LEN (admitted: the cache is a ring), all at once and in
    # lockstep; then the same requests one by one through a store of one
    # hot session, the returning user spilled to disk and restored in
    # another engine: the same tokens, its session bit for bit.
    gen = torch.Generator().manual_seed(15)

    def draw(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    lens = torch.randint(SWA_REQ_PROMPT[0], SWA_REQ_PROMPT[1] + 1,
                         (SWA_REQUESTS,), generator=gen).tolist()
    reqs = [dict(user=f"user{i}", prompt=draw(n),
                 max_new_tokens=SWA_REQ_GEN) for i, n in enumerate(lens)]
    back = [dict(user="ret", prompt=draw(n), max_new_tokens=SWA_REQ_GEN)
            for n in SWA_RETURN]

    def engine(store=None):
        return ServeEngine(cfg, lanes=SWA_LANES, max_len=SWA_MAX_LEN,
                           params=params, device=dev, session_store=store)

    def by_user(results):
        require(all(len(r["tokens"]) == SWA_REQ_GEN and all(
                    0 <= t < cfg.vocab_size for t in r["tokens"])
                    for r in results), "engine: tokens out of count or range")
        return {r["user"]: r["tokens"] for r in results}

    eng = engine()
    for kw in [back[0], *reqs]:
        eng.submit(Request(**kw))
    got_a, steps_a, ms_a = {}, 0, []
    with Intercept(ops, checker=checker):
        for phase_reqs in ([], [back[1]]):
            for kw in phase_reqs:
                eng.submit(Request(**kw))
            while eng.scheduler.has_work:
                before = eng.steps
                zero_counts()
                t0 = time.perf_counter()
                done = eng.step()
                ms_a.append((time.perf_counter() - t0) * 1e3)
                launched = counts()
                want_counts = {name: 0 for name in launched}
                want_counts.update({name: groups * (eng.steps - before)
                                    for name in FORWARD})
                require(launched == want_counts, f"engine step {before}: "
                        f"launches "
                        f"{ {k: v for k, v in launched.items() if v} }")
                for r in done:
                    key = r["user"] + ("" if r["user"] not in got_a else "2")
                    got_a[key] = r["tokens"]
            steps_a = eng.steps
    by_user([{"user": k, "tokens": v} for k, v in got_a.items()])
    sess_a = eng.sessions.take("ret")
    ret_pos = int(sess_a["pos"][0])
    require(ret_pos == sum(SWA_RETURN) + 2 * SWA_REQ_GEN - 2
            and ret_pos > SWA_MAX_LEN, f"the returning user ended at "
            f"position {ret_pos}")
    del eng
    with tempfile.TemporaryDirectory() as tmp:
        store = SessionStore(num_slots=m.num_slots, capacity=1,
                             spill_dir=tmp)
        b1 = engine(store)
        got_b = by_user(b1.run([Request(**back[0])]))
        for kw in reqs:
            b1.submit(Request(**kw))
            got_b.update(by_user(b1.step()))
        got_b.update(by_user(b1.run()))
        require(store.spills >= 1 and store.restores == 0,
                f"{store.spills} spills, {store.restores} restores")
        del b1
        b2 = engine(store)
        got_b["ret2"] = by_user(b2.run([Request(**back[1])]))["ret"]
        require(store.restores == 1, "the returning user was not restored "
                "from disk")
        diff = session_diff(b2.sessions.take("ret"), sess_a)
        del b2, store
    require(got_b == got_a and diff is None, f"engine: one by one through "
            f"evictions and a disk spill against all at once: tokens equal "
            f"{got_b == got_a}, the returning user's first differing leaf "
            f"{diff}")
    ms_a.sort()
    out.update(engine_steps=steps_a, engine_ms_per_step=ms_a[len(ms_a) // 2],
               engine_returning_pos=ret_pos)
    print(f"[swa] engine ({SWA_LANES} lanes, max_len {SWA_MAX_LEN}): "
          f"{SWA_REQUESTS} requests and a returning user (prompts "
          f"{SWA_RETURN}, to position {ret_pos}, past max_len) at once in "
          f"{steps_a} steps in lockstep ({groups} read, write and LRA "
          f"launches a step; median {ms_a[len(ms_a) // 2]:.1f} ms a step "
          f"with the checks); one by one, the returning user spilled to disk "
          f"and restored in another engine: every token equal, its session "
          f"bit for bit")
    del params, toks
    torch.cuda.empty_cache()
    part("d")
    out["seconds"] = part_s
    print(f"[swa] seconds by part: {part_s}")
    return {"row": row_f32, "bf16_row": row_bf16,
            "launches": {"flash_attention_swa": cfg.num_layers - per,
                         "flash_attention_swa_bf16": per},
            "err": f32_err, "bf16_err": bf16_err, "swa": out}


def filled_memory_states(cfg, batch, gen):
    """Memory states as a served session leaves them, drawn on the CPU
    from ``gen``: random rows, a permuted usage table, distinct read rows
    with normalised weights, step 5 (a fresh memory's rows, written from
    zero by one head, tie: ROADMAP §C)."""
    from repro_torch.models import lm

    m = cfg.memory
    states = []
    for st in lm.init_memory_states(cfg, batch, device="cpu"):
        N = m.num_slots
        mem = torch.randn(st.memory.shape, generator=gen)
        mem[:, N] = 0.0
        la = st.last_access.clone()
        la[:, :N] = -torch.stack([torch.randperm(N, generator=gen)
                                  for _ in range(batch)]).to(la.dtype)
        idx = torch.stack([torch.randperm(N, generator=gen)[
            :m.num_heads * m.k].reshape(m.num_heads, m.k)
            for _ in range(batch)]).to(torch.int32)
        w = torch.rand(st.read_w.shape, generator=gen)
        states.append(st._replace(memory=mem, last_access=la, read_idx=idx,
                                  read_w=w / w.sum(-1, keepdim=True),
                                  step=st.step + 5))
    return tuple(states)


def vlm_phase(dev, ops, ref, checker, zero_counts, counts, flush, ptxas):
    """Phase 16: the vision-language LM (PaliGemma-3B + SAM) served at full
    width. ``ptxas`` is the attention library's `-Xptxas -v` report.
    Returns the D = 256 attention rows with the prefix (f32 at layer 4's
    prefill inputs, bf16 at layer 0's), their prefill launches and the
    numbers."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map

    cfg = get_config(VLM_ARCH)
    m = cfg.memory
    P = cfg.frontend_len
    groups = cfg.num_layers // m.every_n_layers
    per = cfg.num_layers // groups
    ran = groups * per            # the blocks a run with memory runs
    segments = VLM_S // m.segment
    require(cfg.head_dim == 256 and cfg.prefix_lm == P == 256
            and cfg.padded_heads == 16 and cfg.num_kv_heads == 1
            and cfg.act == "geglu" and cfg.tie_embeddings,
            f"{VLM_ARCH}: head_dim {cfg.head_dim}, prefix {cfg.prefix_lm}, "
            f"frontend_len {P}, heads {cfg.padded_heads} over "
            f"{cfg.num_kv_heads}, act {cfg.act}")
    require(ran < cfg.num_layers, f"{VLM_ARCH}: {groups} memory groups of "
            f"{per} run {ran} of {cfg.num_layers} blocks: JAX's grouping "
            f"leaves none out")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # The D = 256 instantiations: registers and spills from ptxas (phase 1
    # holds the whole library to no spill), and the dynamic shared memory
    # their launcher asks for: f32 q, k, v (64 × 256) and p (64 × 64) for
    # 256 threads; bf16 q and two k and v slots, rows padded by 8.
    lines = ptxas_summary(ptxas)
    d256 = {("bf16" if "bf16" in line else "f32"): lines[i + 1:i + 3]
            for i, line in enumerate(lines) if "ILi256E" in line}
    smem = {"f32": (3 * 64 * 256 + 64 * 64) * 4, "bf16": 5 * 64 * 264 * 2}
    require(sorted(d256) == ["bf16", "f32"] and not any(
        re.search(r"[1-9][0-9]* bytes spill", line)
        for r in d256.values() for line in r),
        f"flash_attention<256> (ptxas): {d256}")
    out["d256_ptxas"] = {k: " | ".join(v) for k, v in d256.items()}
    out["d256_smem_bytes"] = smem
    print("[vlm] flash_attention at D = 256: " + "; ".join(
        f"{k}: {' | '.join(v)}, {smem[k]} B of dynamic shared memory"
        for k, v in sorted(d256.items())))

    # (e) first, the reduced config in f32 on the card against the plain
    # versions on the CPU, in two variants: JAX's reduced config (head_dim
    # 32, 4 heads over 2), and the same at head_dim 256 over one kv head
    # with its 4 heads padded to 8 (4 dead heads), so that the D = 256,
    # MQA and pad-head paths themselves are compared. Each: a prefill on
    # patch embeddings, a decode_scan with filled memory states, one
    # loss_fn gradient; the token seeds the first of 0-63 whose CPU reads
    # hold no near-tie at K.
    small_runs = {}
    for variant, kw in (("jax", {}), ("mqa", dict(
            head_dim=256, num_kv_heads=1, pad_head_groups=8))):
        small = dataclasses.replace(reduced(cfg), compute_dtype="float32",
                                    **kw)
        p_cpu = lm.init_params(small, seed=0, device="cpu")
        p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
        Ps, d = small.frontend_len, small.d_model

        def vision_batch(gen, n, targets=False):
            b = {"tokens": torch.randint(0, small.vocab_size,
                                         (n, VLM_SMALL_S_T), generator=gen),
                 "patch_embeds": torch.randn((n, Ps, d), generator=gen)}
            if targets:
                b["targets"] = torch.randint(0, small.vocab_size,
                                             (n, VLM_SMALL_S_T), generator=gen)
            return b

        def prefill_case(gen):
            b = vision_batch(gen, 2)
            return b, lm.prefill(p_cpu, small, b)

        def decode_case(gen):
            toks = torch.randint(0, small.vocab_size, (2, VLM_SMALL_DECODE),
                                 generator=gen)
            states = filled_memory_states(small, 2, gen)
            start = pytree.tree_map(lambda t: t.clone(), states)
            cache = lm.init_cache(small, 2, VLM_SMALL_MAX_LEN, device="cpu")
            return (toks, start), lm.decode_scan(p_cpu, small, cache, toks,
                                                 mem_states=states)

        def loss_case(gen):
            b = vision_batch(gen, 2, targets=True)
            return b, steps.value_and_grad(p_cpu, small, b)

        what = f"the reduced PaliGemma ({variant})"
        seeds = []
        seed, (b_s, want) = first_stable(ops, ref, prefill_case,
                                         what + "'s prefill")
        seeds.append(seed)
        zero_counts()
        got = lm.prefill(p_gpu, small, tree_map(lambda t: t.to(dev), b_s))
        require(counts()["flash_attention"] == small.num_layers,
                "the reduced prefill did not run the attention kernel")
        errs = {"prefill": card_close(got, want, f"{variant} prefill logits")}
        seed, ((toks_d, start), want_d) = first_stable(
            ops, ref, decode_case, what + "'s decode")
        seeds.append(seed)
        cache = lm.init_cache(small, 2, VLM_SMALL_MAX_LEN, device=dev)
        got_d = lm.decode_scan(p_gpu, small, cache, toks_d.to(dev),
                               mem_states=pytree.tree_map(
                                   lambda t: t.to(dev), start))
        errs["decode"] = card_close(got_d[0], want_d[0],
                                    f"{variant} decode logits")
        errs["cache"] = max(card_close(got_d[1][kk], want_d[1][kk], kk)
                            for kk in ("k", "v"))
        errs["memory"] = max(card_close(a.memory, b.memory, "memory")
                             for a, b in zip(got_d[2], want_d[2]))
        require(all(torch.equal(a.last_access.cpu(), b.last_access)
                    and torch.equal(a.read_idx.cpu().sort(-1).values,
                                    b.read_idx.sort(-1).values)
                    for a, b in zip(got_d[2], want_d[2])),
                f"{variant} decode: usage or read rows differ, card against "
                f"CPU")
        seed, (batch_l, g_cpu) = first_stable(ops, ref, loss_case,
                                              what + "'s loss")
        seeds.append(seed)
        zero_counts()
        g_gpu = steps.value_and_grad(
            p_gpu, small, {k: v.to(dev) for k, v in batch_l.items()})
        require(counts()["flash_attention"] == small.num_layers,
                "the loss's forward did not run the attention kernel")
        errs["loss"] = card_close(g_gpu[0], g_cpu[0], f"{variant} loss")
        errs["grad"], arbitered = grads_close(p_cpu, small, batch_l,
                                              g_gpu[2], g_cpu[2],
                                              draws=VLM_SPREAD_DRAWS)
        small_runs[variant] = dict(err=errs, seeds=seeds,
                                   grad_arbitered=arbitered)
        print(f"[vlm] reduced {VLM_ARCH} ({variant}: head_dim "
              f"{small.head_dim}, {small.padded_heads} heads over "
              f"{small.num_kv_heads}, prefix {small.prefix_lm}; f32) on the "
              f"card against the CPU (token seeds {seeds}): prefill logits "
              f"{errs['prefill']:.3g}, decode_scan of {VLM_SMALL_DECODE} "
              f"tokens with memory states {errs['decode']:.3g}, caches "
              f"{errs['cache']:.3g}, memory {errs['memory']:.3g} (bar "
              f"{SLICE_TOL} of max(1, |CPU|); usage and read rows equal); "
              f"loss {errs['loss']:.3g}, gradients max {errs['grad']:.3g} "
              f"(atol {NAIVE_ATOL} / rtol {NAIVE_RTOL}; leaves beyond, held "
              f"to twice the CPU's largest own move over {VLM_SPREAD_DRAWS} "
              f"one-ulp perturbations: {arbitered})")
        del p_cpu, p_gpu, got, want, got_d, want_d, g_cpu, g_gpu
    out["card_vs_cpu"] = small_runs
    torch.cuda.empty_cache()
    part("e")

    # (b) the prefill at full width on 256 patch embeddings and S - 256
    # tokens, in lockstep: every attention launch against its plain
    # version with the prefix, the memory kernels too. The memory groups
    # run blocks 0-15 of 18 (JAX's grouping: ROADMAP §C).
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    out.update(params=n_params, param_bytes=param_bytes)
    print(f"[vlm] {VLM_ARCH}: {n_params} parameters (the head tied to the "
          f"embedding), {param_bytes} B in bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (VLM_B, VLM_S - P),
                                     generator=gen).to(dev),
             "patch_embeds": torch.randn((VLM_B, P, cfg.d_model),
                                         generator=gen).to(dev)}
    zero_counts()
    with torch.inference_mode(), Intercept(ops, checker=checker), \
            FlashCheck(ops, ref, keep=(0, per)) as fc:
        logits = lm.prefill(params, cfg, batch)
    torch.cuda.synchronize()
    launched = counts()
    want_counts = {name: 0 for name in launched}
    want_counts.update({"flash_attention": ran,
                        **{name: groups * segments for name in FORWARD}})
    require(launched == want_counts, f"prefill launches {launched}, expected "
            f"{want_counts}")
    by_dtype = [str(c["dtype"])[6:] for c in fc.checks]
    require(by_dtype == ["bfloat16"] * per + ["float32"] * (ran - per)
            and all(c["prefix"] == P and c["window"] is None
                    for c in fc.checks),
            f"prefill attention launches by dtype {by_dtype}: expected "
            f"{per} bf16, then f32, each with the prefix {P}")
    require(logits.dtype == torch.float32
            and logits.shape == (VLM_B, 1, cfg.vocab_size)
            and torch.isfinite(logits).all().item(),
            "prefill logits are not finite f32 of shape (B, 1, V)")
    conditioned = [c for c in fc.checks if "exact_err" in c]
    bf16_err = max(c["err"] for c in fc.checks[:per])
    f32_err = max(c["err"] for c in fc.checks[per:])
    out.update(prefill_launches=launched, flash_bf16_max_err=bf16_err,
               flash_f32_max_err=f32_err,
               flash_f32_above_tol=len(conditioned),
               flash_f32_exact_err=max((c["exact_err"] for c in conditioned),
                                       default=None),
               flash_f32_plain_exact_err=max(
                   (c["plain_exact_err"] for c in conditioned), default=None))
    print(f"[vlm] prefill (B={VLM_B}, S={VLM_S}: {P} patch embeddings and "
          f"{VLM_S - P} tokens, prefix {P}) in lockstep: launches "
          f"{ {k: v for k, v in launched.items() if v} } ({per} bf16 + "
          f"{ran - per} f32 attention launches: blocks 0-{ran - 1} of "
          f"{cfg.num_layers}, JAX's grouping); flash against plain: bf16 max "
          f"err {bf16_err:.3g}, f32 {f32_err:.3g}; {len(conditioned)} f32 "
          f"launches above {FLASH_TOL}, held against f64: kernel "
          f"{out['flash_f32_exact_err'] or 0:.3g}, plain "
          f"{out['flash_f32_plain_exact_err'] or 0:.3g}; memory kernels: read "
          f"err {checker.err['fused_read_sweep']:.3g}, write err "
          f"{checker.err['sparse_write_update']:.3g}, near-ties "
          f"{checker.near_ties}")
    part("b")

    # (a) the kernel at layer 0's (bf16) and layer 4's (f32) inputs.
    q0, k0, v0 = fc.kept[0]
    q4, k4, v4 = fc.kept[per]
    del fc
    require(q0.dtype == torch.bfloat16 and q4.dtype == torch.float32
            and q4.shape == (VLM_B, VLM_S, cfg.padded_heads, 256)
            and k4.shape == (VLM_B, VLM_S, 1, 256),
            f"layer 0 ran {q0.dtype}, layer {per} {q4.dtype} "
            f"{tuple(q4.shape)}")
    row_f32 = attention_row(ref, flash_attention, q4, k4, v4, flush,
                            prefix=P, tag="vlm")
    row_bf16 = attention_row(ref, flash_attention, q0, k0, v0, flush,
                             prefix=P, tag="vlm")
    out["pairs"] = attn_pairs(VLM_S, prefix=P)
    del q0, k0, v0, q4, k4, v4
    for name, r in (("f32 (layer 4)", row_f32), ("bf16 (layer 0)", row_bf16)):
        lib = "none" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms ({r['library_call']}; "
            f"{r['ms'] / r['library_ms']:.2f}x its time)")
        print(f"[time] flash_attention {name} at PaliGemma's prefill (B="
              f"{VLM_B}, S={VLM_S}, H={cfg.padded_heads} ({cfg.num_heads} "
              f"real) over {cfg.num_kv_heads}, D=256, prefix {P}: "
              f"{out['pairs']} (query, key) pairs a head): {r['ms']:.4f} ms "
              f"(bound {r['bound'][0]:.4f} ms by {r['bound'][1]}: "
              f"{r['bound'][0] / r['ms']:.1%} of it), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}")
    part("a")

    # The prefill's host ms, peak and device-busy share.
    def prefill_run(_):
        lm.prefill(params, cfg, batch)

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, prefill_all = host_ms(prefill_run, runs=VLM_PREFILL_RUNS)
    prefill_peak = torch.cuda.max_memory_allocated() - held
    dev_ms, on_dev = device_time(lambda: prefill_run(None))
    out.update(prefill_ms=prefill_ms, prefill_ms_all=prefill_all,
               prefill_peak_bytes=prefill_peak, held_bytes=held,
               prefill_device_ms=dev_ms or None,
               prefill_busy_share=(dev_ms / prefill_ms) if dev_ms else None,
               prefill_tokens_per_s=VLM_B * VLM_S / prefill_ms * 1e3)
    print(f"[time] PaliGemma prefill (B={VLM_B}, S={VLM_S}) {prefill_ms:.1f} "
          f"ms, median of {', '.join(f'{t:.1f}' for t in prefill_all)} "
          f"({out['prefill_tokens_per_s']:.0f} tokens/s); peak "
          f"{prefill_peak} B above the {held} B held ({param_bytes} B of "
          f"weights); "
          + (f"{dev_ms:.1f} ms of kernels ({dev_ms / prefill_ms:.1%} busy); "
             f"by kernel (ms, launches): "
             + "; ".join(f"{kk[:50]} {t:.1f} ({c})"
                         for kk, t, c in on_dev[:5])
             if dev_ms else "device time not measured (the profiler "
             "recorded none)"))
    del logits
    torch.cuda.empty_cache()
    part("b timed")

    # (c) the decode with memory states: a VLM_PROMPT-token prompt (token
    # prompts, as JAX serves PaliGemma: no image, causal from position 0),
    # then VLM_GEN greedy tokens in lockstep. Blocks 16 and 17 run nowhere
    # with memory states (JAX's grouping), so their cache stays zero.
    cache = lm.init_cache(cfg, VLM_B, VLM_MAX_LEN, device=dev)
    mem = lm.init_memory_states(cfg, VLM_B, device=dev)
    zero_counts()
    d_logits, cache, mem = lm.decode_scan(params, cfg, cache,
                                          batch["tokens"][:, :VLM_PROMPT],
                                          mem_states=mem)
    after_prompt = counts()
    with torch.inference_mode(), Intercept(ops, checker=checker):
        per_token = []
        for _ in range(VLM_GEN):
            tok = d_logits[:, -1].float().argmax(-1).to(torch.int32)
            zero_counts()
            d_logits, cache, mem = lm.decode_step(params, cfg, cache,
                                                  tok[:, None],
                                                  mem_states=mem)
            per_token.append(counts())
    torch.cuda.synchronize()
    one = {name: 0 for name in after_prompt}
    one.update({name: groups for name in FORWARD})
    require(after_prompt == {kk: vv * VLM_PROMPT for kk, vv in one.items()},
            f"prompt launches {after_prompt}")
    require(all(c == one for c in per_token), f"a decode step launched "
            f"{[c for c in per_token if c != one][:1]}, expected {one}")
    n_tok = VLM_PROMPT + VLM_GEN
    require(d_logits.dtype == torch.bfloat16
            and d_logits.shape == (VLM_B, 1, cfg.vocab_size)
            and torch.isfinite(d_logits).all().item()
            and int(cache["pos"]) == n_tok
            and all(int(st.step) == n_tok for st in mem),
            "decode: logits not finite bf16, or the position or the steps "
            "are off")
    require(bool(cache["k"][:ran, :, :n_tok].any())
            and not cache["k"][ran:].any() and not cache["v"][ran:].any(),
            f"decode with memory states: blocks {ran}-{cfg.num_layers - 1} "
            f"wrote their cache, or blocks 0-{ran - 1} did not")
    state = {"cache": cache, "mem": mem}

    def rewind():
        state["cache"] = {**state["cache"], "pos": torch.tensor(
            VLM_PROMPT, dtype=torch.int32, device=dev)}

    def decode_window(_, steps=VLM_GEN):
        tok = torch.ones((VLM_B, 1), dtype=torch.int32, device=dev)
        for _ in range(steps):
            lg, state["cache"], state["mem"] = lm.decode_step(
                params, cfg, state["cache"], tok, mem_states=state["mem"])
            tok = lg[:, -1].float().argmax(-1).to(torch.int32)[:, None]

    window_ms, window_all = host_ms(decode_window, runs=1, setup=rewind)
    decode_ms = window_ms / VLM_GEN
    rewind()
    ddev_ms, _ = device_time(lambda: decode_window(None, PROFILE_STEPS))
    ddev_ms /= PROFILE_STEPS
    out.update(decode_ms_per_token=decode_ms,
               decode_ms_per_token_all=[t / VLM_GEN for t in window_all],
               decode_device_ms=ddev_ms or None,
               decode_busy_share=(ddev_ms / decode_ms) if ddev_ms else None)
    print(f"[vlm] decode_scan with memory states: {VLM_PROMPT} prompt tokens "
          f"and {VLM_GEN} greedy ones (in lockstep), {one['fused_read_sweep']}"
          f" read, write and LRA launches and no attention launch a token; "
          f"the caches of blocks {ran}-{cfg.num_layers - 1} untouched (JAX's "
          f"grouping)")
    print(f"[time] PaliGemma decode with memory (B={VLM_B}): {decode_ms:.3f} "
          f"ms a token on the host (windows of {VLM_GEN}: "
          f"{', '.join(f'{t / VLM_GEN:.3f}' for t in window_all)}); "
          + (f"{ddev_ms:.3f} ms of kernels ({ddev_ms / decode_ms:.1%} busy, "
             f"a profiled window of {PROFILE_STEPS} steps)"
             if ddev_ms else "device time not measured"))
    del cache, mem, state, d_logits
    torch.cuda.empty_cache()
    part("c")

    # The static serving driver, once: no memory states, so all 18 blocks
    # run; no memory op and, decoding only, no attention kernel.
    zero_counts()
    served = serve(VLM_ARCH, use_reduced=False, batch=VLM_B,
                   prompt_len=VLM_PROMPT, gen_len=VLM_GEN,
                   max_len=VLM_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    tokens = served["tokens"]
    require(tokens.shape == (VLM_B, VLM_GEN)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
            and not any(counts().values()),
            "serve: tokens out of shape or range, or a kernel launched")
    out.update(serve_prefill_s=served["prefill_s"],
               serve_decode_tok_per_s=served["decode_tok_per_s"])
    print(f"[vlm] serve(--full, max_len {VLM_MAX_LEN}): {tuple(tokens.shape)} "
          f"greedy tokens; prefill {served['prefill_s']:.2f} s, decode "
          f"{served['decode_tok_per_s']:.1f} tok/s")
    del served, tokens
    torch.cuda.empty_cache()
    part("serve")

    # (d) the engine on VLM_LANES lanes of VLM_MAX_LEN: VLM_REQUESTS token
    # requests, in lockstep with exact launches a step.
    gen = torch.Generator().manual_seed(16)
    lens = torch.randint(VLM_REQ_PROMPT[0], VLM_REQ_PROMPT[1] + 1,
                         (VLM_REQUESTS,), generator=gen).tolist()
    eng = ServeEngine(cfg, lanes=VLM_LANES, max_len=VLM_MAX_LEN,
                      params=params, device=dev)
    for i, n in enumerate(lens):
        eng.submit(Request(user=f"user{i}", prompt=torch.randint(
            1, cfg.vocab_size, (n,), generator=gen).tolist(),
            max_new_tokens=VLM_REQ_GEN))
    results, ms_a = [], []
    with Intercept(ops, checker=checker):
        while eng.scheduler.has_work:
            before = eng.steps
            zero_counts()
            t0 = time.perf_counter()
            results += eng.step()
            ms_a.append((time.perf_counter() - t0) * 1e3)
            launched = counts()
            want_counts = {name: 0 for name in launched}
            want_counts.update({name: groups * (eng.steps - before)
                                for name in FORWARD})
            require(launched == want_counts, f"engine step {before}: launches "
                    f"{ {k: v for k, v in launched.items() if v} }")
    require(len(results) == VLM_REQUESTS and all(
        len(r["tokens"]) == VLM_REQ_GEN
        and all(0 <= t < cfg.vocab_size for t in r["tokens"])
        for r in results), "engine: requests or tokens out of count or range")
    ms_a.sort()
    out.update(engine_steps=eng.steps, engine_ms_per_step=ms_a[len(ms_a) // 2])
    print(f"[vlm] engine ({VLM_LANES} lanes, max_len {VLM_MAX_LEN}): "
          f"{VLM_REQUESTS} token requests (prompts of {VLM_REQ_PROMPT[0]}-"
          f"{VLM_REQ_PROMPT[1]}, {VLM_REQ_GEN} new) in {eng.steps} steps in "
          f"lockstep ({groups} read, write and LRA launches a step; median "
          f"{ms_a[len(ms_a) // 2]:.1f} ms a step with the checks)")
    del eng, params, batch
    torch.cuda.empty_cache()
    part("d")
    out["seconds"] = part_s
    print(f"[vlm] seconds by part: {part_s}")
    return {"row": row_f32, "bf16_row": row_bf16,
            "launches": {"flash_attention_vlm": ran - per,
                         "flash_attention_vlm_bf16": per},
            "err": f32_err, "bf16_err": bf16_err, "vlm": out}


def stable_routed(ops, ref, run, what, seeds=64):
    """(seed, run(generator)) for the first seed of 0 .. seeds - 1 whose
    CPU reads (through ``ops.fused_read``) hold no near-tie at K and whose
    routers (through `moe.top_k`) none at k: a token's k-th and (k+1)-th
    router probabilities more than ROUTER_NEAR_TIE apart."""
    from repro_torch.models import moe

    fused_read, top_k = ops.fused_read, moe.top_k
    reads, routes = [], []

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        reads.append((q.detach().clone(), mem.detach().clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    def route(probs, k):
        routes.append(probs.sort(-1, descending=True).values[:, k - 1:k + 1])
        return top_k(probs, k)

    for seed in range(seeds):
        reads.clear()
        routes.clear()
        ops.fused_read, moe.top_k = record, route
        try:
            got = run(torch.Generator().manual_seed(seed))
        finally:
            ops.fused_read, moe.top_k = fused_read, top_k
        if stable_reads(ref, reads) and all(
                (r[:, 0] - r[:, 1]).min().item() > ROUTER_NEAR_TIE
                for r in routes):
            return seed, got
    raise SmokeFailure(f"no token seed of 0-{seeds - 1} gives {what} no "
                       f"read near-tie at K and no router near-tie at k")


def engine_rescale(tag, cfg, params, dev, checker, zero_counts, counts,
                   groups, *, lanes, requests, req_prompt, req_gen, max_len,
                   cache_key):
    """The engine at full width on ``params`` (phases 17, 18): ``requests``
    token requests of ``req_prompt`` tokens and ``req_gen`` new ones on
    ``lanes`` lanes of ``max_len``, in lockstep with exact launches a step
    (``groups`` of each memory kernel); then a rescale 4 -> 2 -> 4 lanes
    mid-run against an uninterrupted run, bit for bit (tokens, the user's
    logits at every token counter, its session: memory states, the
    ``cache_key`` cache, position and counter). Returns the numbers."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine

    gen = torch.Generator().manual_seed(18)
    lens = torch.randint(req_prompt[0], req_prompt[1] + 1,
                         (requests,), generator=gen).tolist()
    eng = ServeEngine(cfg, lanes=lanes, max_len=max_len,
                      params=params, device=dev)
    for i, n in enumerate(lens):
        eng.submit(Request(user=f"user{i}", prompt=torch.randint(
            1, cfg.vocab_size, (n,), generator=gen).tolist(),
            max_new_tokens=req_gen))
    results, ms_a = [], []
    with Intercept(ops, checker=checker):
        while eng.scheduler.has_work:
            before = eng.steps
            zero_counts()
            t0 = time.perf_counter()
            results += eng.step()
            ms_a.append((time.perf_counter() - t0) * 1e3)
            launched = counts()
            want_counts = {name: 0 for name in launched}
            want_counts.update({name: groups * (eng.steps - before)
                                for name in FORWARD})
            require(launched == want_counts, f"engine step {before}: launches "
                    f"{ {k: v for k, v in launched.items() if v} }")
    require(len(results) == requests and all(
        len(r["tokens"]) == req_gen
        and all(0 <= t < cfg.vocab_size for t in r["tokens"])
        for r in results), "engine: requests or tokens out of count or range")
    ms_a.sort()
    out = dict(engine_steps=eng.steps, engine_ms_per_step=ms_a[len(ms_a) // 2])
    print(f"[{tag}] engine ({lanes} lanes, max_len {max_len}): "
          f"{requests} token requests (prompts of {req_prompt[0]}-"
          f"{req_prompt[1]}, {req_gen} new) in {eng.steps} steps in "
          f"lockstep ({groups} read, write and LRA launch a step; median "
          f"{ms_a[len(ms_a) // 2]:.1f} ms a step with the checks)")
    del eng

    rng = np.random.default_rng(19)
    P = rng.integers(1, cfg.vocab_size, 4).tolist()
    Pn = rng.integers(1, cfg.vocab_size, 4).tolist()

    def u(prompt, n):
        return Request(user="u", prompt=prompt, max_new_tokens=n,
                       greedy=False, sample_seed=42)

    def noise(n):
        return Request(user="noise", prompt=Pn, max_new_tokens=n,
                       greedy=False, sample_seed=7)

    def user_tokens(res):
        return [r for r in res if r["user"] == "u"][0]["tokens"]

    def logged(n_lanes, log):
        e = ServeEngine(cfg, lanes=n_lanes, max_len=max_len, params=params,
                        device=dev, replicas=2)
        inner = e.step

        def step():
            done = inner()
            for lane, req in e.scheduler.active.items():
                if req.user == "u":
                    log[int(e._counters[lane])] = e.last_logits[lane].clone()
            return done
        e.step = step
        return e

    log_ref, log_live = {}, {}
    ref_eng = logged(4, log_ref)
    tok_ref = user_tokens(ref_eng.run([u(P, 8), noise(6)]))
    tok_ref2 = user_tokens(ref_eng.run([u([5], 4)]))
    sess_ref = ref_eng.sessions.take("u")
    del ref_eng
    eng = logged(4, log_live)
    eng.submit(u(P, 8))
    eng.submit(noise(6))
    done = []
    for _ in range(6):
        done.extend(eng.step())
    eng.rescale(replicas=1)
    require(eng.lanes == 2, f"rescale left {eng.lanes} lanes")
    while eng.scheduler.has_work:
        done.extend(eng.step())
    tok_live = user_tokens(done)
    eng.rescale(replicas=2, lanes=4)
    tok_live2 = user_tokens(eng.run([u([5], 4)]))
    diff = session_diff(eng.sessions.take("u"), sess_ref)
    del eng
    first_step = next((c for c in sorted(log_ref) if c in log_live
                       and not torch.equal(log_ref[c], log_live[c])), None)
    exact = (tok_live == tok_ref and tok_live2 == tok_ref2 and diff is None
             and first_step is None)
    out.update(rescale_bit_exact=exact,
               rescale_first_differing_counter=first_step,
               rescale_first_differing_leaf=diff)
    require(exact, f"rescale 4 -> 2 -> 4 lanes is not bit-exact: tokens "
            f"{tok_live}, {tok_live2} against {tok_ref}, {tok_ref2}; u's "
            f"logits first differ at token counter {first_step}, first "
            f"differing leaf {diff}")
    print(f"[{tag}] engine rescale 4 -> 2 -> 4 lanes mid-run against an "
          "uninterrupted 4-lane run: tokens, u's logits at every token "
          f"counter, memory states, {cache_key} cache, position and counter "
          "bit for "
          "bit")
    # The logged engines hold themselves (their wrapped step), so only the
    # cycle collector frees them and the weights they hold.
    gc.collect()
    return out


def serve_full(tag, arch, layers, example_arch, dev, counts, zero_counts, *,
               batch, prompt, gen, max_len, vocab):
    """`serve` of ``arch`` at full width, its first ``layers`` layers (all
    of them where None), and `examples.serve_batched --arch example_arch
    --full [--layers]`, each once on weights of its own from seed 0
    (phases 17, 18, 20, 21): no memory states, so no memory op and,
    decoding only, no attention kernel."""
    from repro_torch.examples import serve_batched
    from repro_torch.launch.serve import serve

    zero_counts()
    served = serve(arch, use_reduced=False, num_layers=layers,
                   batch=batch, prompt_len=prompt, gen_len=gen,
                   max_len=max_len, device=dev)
    torch.cuda.synchronize()
    tokens = served["tokens"]
    require(tokens.shape == (batch, gen)
            and bool(((tokens >= 0) & (tokens < vocab)).all())
            and not any(counts().values()),
            "serve: tokens out of shape or range, or a kernel launched")
    out = dict(serve_prefill_s=served["prefill_s"],
               serve_decode_tok_per_s=served["decode_tok_per_s"])
    print(f"[{tag}] serve(--full, {layers or 'all'} layers, max_len "
          f"{max_len}): "
          f"{tuple(tokens.shape)} greedy tokens; prefill "
          f"{served['prefill_s']:.2f} s, decode "
          f"{served['decode_tok_per_s']:.1f} tok/s")
    del served, tokens
    torch.cuda.empty_cache()
    argv = sys.argv
    sys.argv = ["serve_batched", "--arch", example_arch, "--full",
                "--prompt-len", "8", "--gen-len", "8", "--device", str(dev)]
    if layers is not None:
        sys.argv += ["--layers", str(layers)]
    try:
        serve_batched.main()
    finally:
        sys.argv = argv
    torch.cuda.empty_cache()
    return out


def synced(fn, log):
    """``fn`` with each call timed between two synchronisations, its
    seconds appended to ``log`` (a plain loop's share of a run)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append(time.perf_counter() - t)
        return res
    return run


def draw_rwkv_zero_leaves(params, gen) -> None:
    """Draw, in place, the RWKV leaves that `init_params` (as JAX's) leaves
    at zero, so the lerp's and the decay's LoRAs and the bonus act (at
    zero a wrong split or ``mix_b`` block would pass): the lerp's μ in [0,
    1), the others N(0, 0.5²), from ``gen`` on the CPU."""
    for group, names in RWKV_ZERO_LEAVES.items():
        for name in names:
            t = params["blocks"][group][name]
            draw = torch.rand(t.shape, generator=gen) if name.startswith(
                "mu_") else 0.5 * torch.randn(t.shape, generator=gen)
            t.copy_(draw)


def draw_ssm_leaves(params, gen) -> None:
    """Draw, in place, every SSM leaf of a hybrid config from ``gen`` (a
    generator on the leaves' device), layer by layer: a projection N(0,
    1/fan_in) of its own input width, conv_w and the leaves `init_params`
    (as JAX's) sets to constants (a_log, conv_b and dt_bias to zero,
    d_skip to one: a wrong index into one would pass) N(0, 0.5²). The
    init's fan-in of the stacked axis (the layer count) makes Δ ~ 100 and
    the SSM's output ~ 1e9, whose writes swamp the memory and tie its
    reads at K."""
    for name, t in sorted(params["blocks"]["ssm"].items()):
        std = t.shape[-2] ** -0.5 if name in SSM_PROJECTIONS else 0.5
        for i in range(t.shape[0]):
            t[i] = torch.randn(t.shape[1:], generator=gen,
                               device=t.device) * std


def reduced_card_vs_cpu(small, dev, ops, ref, zero_counts, counts, *, S,
                        decode, max_len):
    """A reduced config (f32) on the card against the plain versions on the
    CPU (phases 17, 18, 20, 21), on the same weights from seed 0 (an RWKV
    config's zero leaves drawn: `draw_rwkv_zero_leaves`): a prefill of 2 ×
    ``S`` tokens, or frames of N(0, 1) for an audio config (one attention
    launch a layer, none in an RWKV config), and a `decode_scan` of
    ``decode`` tokens or frames with filled memory states into a cache of
    ``max_len``: the logits, every cache leaf and the memories within
    SLICE_TOL of max(1, |CPU|), usage and read rows equal; the token seeds
    the first of 0-63 whose CPU reads hold no near-tie at K and whose
    routers none at k. A hybrid config's SSM leaves are drawn
    (`draw_ssm_leaves`). Returns (errors, seeds, attention launches)."""
    from torch.utils import _pytree as pytree

    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map

    p_cpu = lm.init_params(small, seed=0, device="cpu")
    if small.block == "rwkv":
        draw_rwkv_zero_leaves(p_cpu, torch.Generator().manual_seed(5))
    if small.block == "hybrid":
        draw_ssm_leaves(p_cpu, torch.Generator().manual_seed(5))
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)

    def inputs(gen, n):
        if small.frontend == "audio":
            return torch.randn((2, n, small.d_model), generator=gen)
        return torch.randint(0, small.vocab_size, (2, n), generator=gen)

    def prefill_case(gen):
        key = "frame_embeds" if small.frontend == "audio" else "tokens"
        b = {key: inputs(gen, S)}
        return b, lm.prefill(p_cpu, small, b)

    def decode_case(gen):
        toks = inputs(gen, decode)
        states = filled_memory_states(small, 2, gen)
        start = pytree.tree_map(lambda t: t.clone(), states)
        cache = lm.init_cache(small, 2, max_len, device="cpu")
        return (toks, start), lm.decode_scan(p_cpu, small, cache, toks,
                                             mem_states=states)

    seeds = []
    seed, (b_s, want) = stable_routed(ops, ref, prefill_case,
                                      "the reduced prefill")
    seeds.append(seed)
    zero_counts()
    got = lm.prefill(p_gpu, small, tree_map(lambda t: t.to(dev), b_s))
    launches = counts()["flash_attention"]
    n_attn = 0 if small.block == "rwkv" else small.num_layers
    require(launches == n_attn, f"the reduced prefill launched the "
            f"attention kernel {launches} times, not {n_attn}")
    errs = {"prefill": card_close(got, want, "reduced prefill logits")}
    seed, ((toks_d, start), want_d) = stable_routed(
        ops, ref, decode_case, "the reduced decode")
    seeds.append(seed)
    cache = lm.init_cache(small, 2, max_len, device=dev)
    got_d = lm.decode_scan(p_gpu, small, cache, toks_d.to(dev),
                           mem_states=pytree.tree_map(lambda t: t.to(dev),
                                                      start))
    errs["decode"] = card_close(got_d[0], want_d[0], "reduced decode logits")
    for key in sorted(k for k in want_d[1] if k != "pos"):
        errs[key] = card_close(got_d[1][key], want_d[1][key], key)
    require(torch.equal(got_d[1]["pos"].cpu(), want_d[1]["pos"]),
            "reduced decode: the position differs, card against CPU")
    errs["memory"] = max(card_close(a.memory, b.memory, "memory")
                         for a, b in zip(got_d[2], want_d[2]))
    require(all(torch.equal(a.last_access.cpu(), b.last_access)
                and torch.equal(a.read_idx.cpu().sort(-1).values,
                                b.read_idx.sort(-1).values)
                for a, b in zip(got_d[2], want_d[2])),
            "reduced decode: usage or read rows differ, card against CPU")
    return errs, seeds, launches


def full_width_serving(tag, name_, cfg, params, dev, checker, zero_counts,
                       counts, flush, part, *, B, S, prompt, gen, max_len,
                       prefill_runs, heads, cache_ok, cache_what,
                       decode_dtype, prefill_context=contextlib.nullcontext):
    """Phases 17, 18, 20 and 21 at full width on ``params``: (b) a B × S
    prefill in lockstep (every attention launch against its plain
    version: bf16 up to the first memory group, f32 after it, where the
    stream is promoted; the memory kernels too); (a) the attention kernel
    at layer 0's inputs, bf16 as the prefill ran them and upcast to f32,
    against its plain version, with its `attention_row`; the prefill's
    host ms (its ``prefill_runs`` runs under ``prefill_context()``, or with
    none the lockstep prefill under it), peak and device-busy
    share (not for RWKV: its WKV loop's ~400,000 launches would take the
    profiler minutes); (c) a
    decode with memory states of a ``prompt``-token prompt and ``gen``
    greedy tokens into a cache of ``max_len`` in lockstep (each memory
    kernel once a group a token, no attention launch; ``cache_ok(cache,
    n)`` holds the cache written up to n and zero past it), and its ms a
    token on the host and the device. ``heads`` is (query heads, q·k
    width, v width). An audio config's prefill and prompt are frames of
    N(0, 1) and each chosen token is fed back as `serve.one_hot`; an RWKV
    config (``heads`` None) runs no attention, so no (a). Returns the
    numbers, the f32 and bf16 rows (None without attention) and the
    errors."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import one_hot
    from repro_torch.models import lm

    m = cfg.memory
    groups = max(1, cfg.num_layers // m.every_n_layers)
    segments = S // m.segment
    n_dense = cfg.moe.num_dense_layers if cfg.moe is not None else 0
    attention = heads is not None
    n_attn = cfg.num_layers if attention else 0
    # Launches before the first memory group's read run on the bf16 stream.
    n_bf16 = min(n_attn, n_dense + (cfg.num_layers - n_dense) // groups)
    audio = cfg.frontend == "audio"
    Hq, DQK, DV = heads or (0, 0, 0)
    pair = f"({DQK}, {DV})" if DQK != DV else f"D = {DQK}"

    def feed(tok):
        return one_hot(tok, cfg.d_model)[:, None] if audio else tok[:, None]

    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.tree_leaves(params))
    out = dict(params=n_params, param_bytes=param_bytes)
    print(f"[{tag}] {cfg.name} at {cfg.num_layers} layers: {n_params} "
          f"parameters, {param_bytes} B in {cfg.compute_dtype}")

    gen17 = torch.Generator().manual_seed(17)
    batch = {"frame_embeds": torch.randn((B, S, cfg.d_model),
                                         generator=gen17).to(dev)} \
        if audio else {"tokens": torch.randint(
            0, cfg.vocab_size, (B, S), generator=gen17).to(dev)}
    zero_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode(), Intercept(ops, checker=checker), \
            FlashCheck(ops, ref, keep=(0,)) as fc, \
            (contextlib.nullcontext() if prefill_runs else prefill_context()):
        logits = lm.prefill(params, cfg, batch)
    torch.cuda.synchronize()
    lockstep = dict(ms=(time.perf_counter() - t0) * 1e3, held=held,
                    peak=torch.cuda.max_memory_allocated() - held)
    launched = counts()
    want_counts = {name: 0 for name in launched}
    want_counts.update({"flash_attention": n_attn,
                        **{name: groups * segments for name in FORWARD}})
    require(launched == want_counts, f"prefill launches {launched}, expected "
            f"{want_counts}")
    by_dtype = [str(c["dtype"])[6:] for c in fc.checks]
    require(by_dtype == ["bfloat16"] * n_bf16
            + ["float32"] * (n_attn - n_bf16),
            f"prefill attention launches by dtype {by_dtype}: expected "
            f"{n_bf16} bf16, then {n_attn - n_bf16} f32")
    require(logits.dtype == torch.float32
            and logits.shape == (B, 1, cfg.vocab_size)
            and torch.isfinite(logits).all().item(),
            "prefill logits are not finite f32 of shape (B, 1, V)")
    out["flash_by_dtype"] = {d: by_dtype.count(d) for d in sorted(
        set(by_dtype))}
    bf16_err = max((c["err"] for c in fc.checks
                    if c["dtype"] == torch.bfloat16), default=None)
    f32_err = max((c["err"] for c in fc.checks
                   if c["dtype"] == torch.float32), default=None)
    out.update(prefill_launches=launched, flash_bf16_max_err=bf16_err,
               flash_f32_prefill_max_err=f32_err)
    attn_note = (f"{n_bf16} bf16 and {n_attn - n_bf16} f32 attention "
                 f"launches at {pair}" if attention
                 else "no attention launch")
    print(f"[{tag}] prefill (B={B}, S={S}) in lockstep: launches "
          f"{ {k: v for k, v in launched.items() if v} } ({attn_note}, "
          f"{groups * segments} of each memory kernel: {groups} groups of "
          f"{segments} segments); flash against plain: bf16 max err "
          f"{bf16_err}, f32 {f32_err}; memory kernels: read "
          f"err {checker.err['fused_read_sweep']:.3g}, write err "
          f"{checker.err['sparse_write_update']:.3g}, near-ties "
          f"{checker.near_ties}")
    part("b")

    del logits
    rest = dict(B=B, S=S, prompt=prompt, gen=gen, max_len=max_len,
                prefill_runs=prefill_runs, lockstep=lockstep, groups=groups,
                param_bytes=param_bytes, cache_ok=cache_ok,
                cache_what=cache_what, decode_dtype=decode_dtype,
                prefill_context=prefill_context)
    if not attention:
        serving_rest(tag, name_, cfg, params, dev, checker, zero_counts,
                     counts, part, out, batch, feed, **rest)
        return {"out": out}
    # (a) the kernel at layer 0's inputs: bf16 as the prefill ran it, and
    # f32 on the same values upcast, each held against its plain version.
    q0, k0, v0 = fc.kept[0]
    del fc
    require(q0.dtype == torch.bfloat16
            and q0.shape == (B, S, Hq, DQK)
            and k0.shape == (B, S, cfg.num_kv_heads, DQK)
            and v0.shape == (B, S, cfg.num_kv_heads, DV),
            f"layer 0 ran {q0.dtype} {tuple(q0.shape)}, k {tuple(k0.shape)}, "
            f"v {tuple(v0.shape)}")
    q4, k4, v4 = (t.float() for t in (q0, k0, v0))
    zero_counts()
    win = cfg.window
    f32_check = check_flash(ref, q4, k4, v4,
                            flash_attention(q4, k4, v4, window=win), win)
    require(counts()["flash_attention"] == 1, "the f32 check did not launch")
    row_bf16 = attention_row(ref, flash_attention, q0, k0, v0, flush,
                             window=win, tag=tag)
    row_f32 = attention_row(ref, flash_attention, q4, k4, v4, flush,
                            window=win, tag=tag)
    out["pairs"] = attn_pairs(S, win)
    out["flash_f32_check"] = f32_check
    del q0, k0, v0, q4, k4, v4
    torch.cuda.empty_cache()
    for name, r in (("f32", row_f32), ("bf16", row_bf16)):
        lib = "none (" + ", ".join(r["library_refused"]) + " refused)" \
            if r["library_ms"] is None else (
                f"{r['library_ms']:.4f} ms ({r['library_call']}; "
                f"{r['ms'] / r['library_ms']:.2f}x its time)")
        print(f"[time] flash_attention {name} at {name_}'s prefill (B="
              f"{B}, S={S}, H={Hq} over {cfg.num_kv_heads}, q·k {DQK}, "
              f"v {DV}, causal"
              + (f" within a window of {win}" if win else "")
              + f": {out['pairs']} (query, key) pairs a head): "
              f"{r['ms']:.4f} ms (bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}: {r['bound'][0] / r['ms']:.1%} of it), "
              f"plain {r['plain_ms']:.4f} ms, library {lib}")
    print(f"[{tag}] flash_attention f32 at {pair} against plain: "
          f"{f32_check}")
    part("a")
    serving_rest(tag, name_, cfg, params, dev, checker, zero_counts, counts,
                 part, out, batch, feed, **rest)
    return {"out": out, "row": row_f32, "bf16_row": row_bf16,
            "bf16_err": bf16_err, "f32_check": f32_check}


def serving_rest(tag, name_, cfg, params, dev, checker, zero_counts, counts,
                 part, out, batch, feed, *, B, S, prompt, gen, max_len,
                 prefill_runs, lockstep, groups, param_bytes, cache_ok,
                 cache_what, decode_dtype, prefill_context):
    """`full_width_serving`'s timed prefill and (c), its decode, feeding
    ``feed(token)``; adds their numbers to ``out``. With ``prefill_runs``
    0 the lockstep prefill's own host ms and peak (``lockstep``) stand for
    the timed ones: its checks of the memory kernels take ~0.1 s."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    # The prefill's host ms, peak and device-busy share.
    def prefill_run(_):
        lm.prefill(params, cfg, batch)

    if prefill_runs:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with prefill_context():
            prefill_ms, prefill_all = host_ms(prefill_run, runs=prefill_runs)
        prefill_peak = torch.cuda.max_memory_allocated() - held
    else:
        held, prefill_peak = lockstep["held"], lockstep["peak"]
        prefill_ms, prefill_all = lockstep["ms"], [lockstep["ms"]]
    profile_prefill = cfg.block != "rwkv"
    dev_ms, on_dev = device_time(lambda: prefill_run(None)) \
        if profile_prefill else (0.0, [])
    out.update(prefill_ms=prefill_ms, prefill_ms_all=prefill_all,
               prefill_peak_bytes=prefill_peak, held_bytes=held,
               prefill_device_ms=dev_ms or None,
               prefill_busy_share=(dev_ms / prefill_ms) if dev_ms else None,
               prefill_tokens_per_s=B * S / prefill_ms * 1e3,
               prefill_by_kernel=[(kk[:60], t, c) for kk, t, c in on_dev[:8]])
    print(f"[time] {name_} prefill (B={B}, S={S}, {cfg.num_layers} "
          f"layers) {prefill_ms:.1f} ms, median of "
          f"{', '.join(f'{t:.1f}' for t in prefill_all)} "
          f"({out['prefill_tokens_per_s']:.0f} tokens/s); peak "
          f"{prefill_peak} B above the {held} B held ({param_bytes} B of "
          f"weights); "
          + (f"{dev_ms:.1f} ms of kernels ({dev_ms / prefill_ms:.1%} busy); "
             f"by kernel (ms, launches): "
             + "; ".join(f"{kk[:50]} {t:.1f} ({c})"
                         for kk, t, c in on_dev[:6])
             if dev_ms else "device time not measured" + (
                 " (the profiler recorded none)" if profile_prefill
                 else " (not profiled)")))
    torch.cuda.empty_cache()
    part("b timed")

    # (c) the decode with memory states: a ``prompt``-token prompt, then
    # ``gen`` greedy tokens in lockstep; the decode's attention is plain
    # PyTorch, so a token launches the memory kernels and no attention.
    cache = lm.init_cache(cfg, B, max_len, device=dev)
    mem = lm.init_memory_states(cfg, B, device=dev)
    zero_counts()
    prompt_in = batch["frame_embeds"] if "frame_embeds" in batch \
        else batch["tokens"]
    d_logits, cache, mem = lm.decode_scan(params, cfg, cache,
                                          prompt_in[:, :prompt],
                                          mem_states=mem)
    after_prompt = counts()
    with torch.inference_mode(), Intercept(ops, checker=checker):
        per_token = []
        for _ in range(gen):
            tok = d_logits[:, -1].float().argmax(-1).to(torch.int32)
            zero_counts()
            d_logits, cache, mem = lm.decode_step(params, cfg, cache,
                                                  feed(tok),
                                                  mem_states=mem)
            per_token.append(counts())
    torch.cuda.synchronize()
    one = {name: 0 for name in after_prompt}
    one.update({name: groups for name in FORWARD})
    require(after_prompt == {kk: vv * prompt for kk, vv in one.items()},
            f"prompt launches {after_prompt}")
    require(all(c == one for c in per_token), f"a decode step launched "
            f"{[c for c in per_token if c != one][:1]}, expected {one}")
    n_tok = prompt + gen
    require(d_logits.dtype == decode_dtype
            and d_logits.shape == (B, 1, cfg.vocab_size)
            and torch.isfinite(d_logits).all().item()
            and int(cache["pos"]) == n_tok
            and all(int(st.step) == n_tok for st in mem)
            and cache_ok(cache, n_tok),
            f"decode: logits not finite bf16, the position or the steps are "
            f"off, or {cache_what} is not written at every layer up to the "
            f"position and zero past it")
    state = {"cache": cache, "mem": mem}

    def rewind():
        state["cache"] = {**state["cache"], "pos": torch.tensor(
            prompt, dtype=torch.int32, device=dev)}

    def decode_window(_, steps=gen):
        tok = torch.ones((B,), dtype=torch.int32, device=dev)
        for _ in range(steps):
            lg, state["cache"], state["mem"] = lm.decode_step(
                params, cfg, state["cache"], feed(tok),
                mem_states=state["mem"])
            tok = lg[:, -1].float().argmax(-1).to(torch.int32)

    window_ms, window_all = host_ms(decode_window, runs=1, setup=rewind)
    decode_ms = window_ms / gen
    rewind()
    ddev_ms, d_on_dev = device_time(lambda: decode_window(None,
                                                           PROFILE_STEPS))
    ddev_ms /= PROFILE_STEPS
    out.update(decode_ms_per_token=decode_ms,
               decode_ms_per_token_all=[t / gen for t in window_all],
               decode_device_ms=ddev_ms or None,
               decode_busy_share=(ddev_ms / decode_ms) if ddev_ms else None,
               decode_by_kernel=[(kk[:60], t / PROFILE_STEPS,
                                  c / PROFILE_STEPS)
                                 for kk, t, c in d_on_dev[:8]])
    print(f"[{tag}] decode_scan with memory states: {prompt} prompt tokens "
          f"and {gen} greedy ones (in lockstep), {one['fused_read_sweep']}"
          f" read, write and LRA launch and no attention launch a token (the "
          f"decode's blocks are plain PyTorch, as in JAX)")
    print(f"[time] {name_} decode with memory (B={B}): "
          f"{decode_ms:.3f} ms a token on the host (windows of {gen}: "
          f"{', '.join(f'{t / gen:.3f}' for t in window_all)}); "
          + (f"{ddev_ms:.3f} ms of kernels ({ddev_ms / decode_ms:.1%} busy, "
             f"a profiled window of {PROFILE_STEPS} steps); by kernel (ms a "
             f"token): " + "; ".join(f"{kk[:40]} {t / PROFILE_STEPS:.3f}"
                                     for kk, t, c in d_on_dev[:5])
             if ddev_ms else "device time not measured"))
    del cache, mem, state, d_logits
    torch.cuda.empty_cache()
    part("c")



def mla_phase(dev, ops, ref, checker, zero_counts, counts, flush, ptxas):
    """Phase 17: DeepSeek-V2 (+ SAM) served at full width, its depth cut to
    the first MLA_LAYERS of 60 layers. ``ptxas`` is the attention
    library's `-Xptxas -v` report. Returns the (192, 128) attention rows
    (bf16 at layer 0's prefill inputs, f32 at the same inputs upcast),
    their launches and the numbers."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm
    from repro_torch.models.config import MLAConfig

    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)
    m, mla = cfg.memory, cfg.mla
    n_dense = cfg.moe.num_dense_layers
    groups = cfg.num_layers // m.every_n_layers
    per = (cfg.num_layers - n_dense) // groups
    DQK, DV = mla.nope_head_dim + mla.rope_head_dim, mla.v_head_dim
    require((DQK, DV, n_dense, groups, per) == (192, 128, 1, 1, 3),
            f"{MLA_ARCH} at {MLA_LAYERS} layers: q·k {DQK}, v {DV}, "
            f"{n_dense} dense, {groups} groups of {per}: expected 192, 128, "
            f"1, 1 group of all 3 MoE blocks")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # The (192, 128) instantiations: registers and spills from ptxas (phase
    # 1 holds the whole library to no spill) and the dynamic shared memory
    # their launcher asks for: f32 q and k (64 × 192), v (64 × 128) and p
    # (64 × 64) for 256 threads; bf16 q and two k slots of rows of 192 + 8,
    # two v slots of 128 + 8.
    lines = ptxas_summary(ptxas)
    pair = {("bf16" if "bf16" in line else "f32"): lines[i + 1:i + 3]
            for i, line in enumerate(lines) if "ILi192ELi128E" in line}
    smem = {"f32": (2 * 64 * 192 + 64 * 128 + 64 * 64) * 4,
            "bf16": (3 * 64 * 200 + 2 * 64 * 136) * 2}
    require(sorted(pair) == ["bf16", "f32"] and not any(
        re.search(r"[1-9][0-9]* bytes spill", line)
        for r in pair.values() for line in r),
        f"flash_attention<192, 128> (ptxas): {pair}")
    out["pair_ptxas"] = {k: " | ".join(v) for k, v in pair.items()}
    out["pair_smem_bytes"] = smem
    print("[mla] flash_attention at (q·k 192, v 128): " + "; ".join(
        f"{k}: {' | '.join(v)}, {smem[k]} B of dynamic shared memory"
        for k, v in sorted(pair.items())))

    # (e) first, the reduced config at the kernel's (192, 128) heads (2
    # heads, kv_lora 64; 3 layers: the dense one and two MoE blocks, one
    # memory group every 2) in f32 on the card against the plain versions
    # on the CPU: a prefill and a decode_scan with filled memory states;
    # the token seeds the first of 0-63 whose CPU reads hold no near-tie at
    # K and whose routers none at k.
    kw = dict(MLA_SMALL)
    small = reduced(cfg)
    small = dataclasses.replace(
        small, compute_dtype="float32", num_layers=kw.pop("num_layers"),
        num_heads=kw.pop("num_heads"), num_kv_heads=kw.pop("num_kv_heads"),
        memory=dataclasses.replace(small.memory,
                                   every_n_layers=kw.pop("every")),
        mla=MLAConfig(**kw))
    errs, seeds, small_launches = reduced_card_vs_cpu(
        small, dev, ops, ref, zero_counts, counts, S=MLA_SMALL_S,
        decode=MLA_SMALL_DECODE, max_len=MLA_SMALL_MAX_LEN)
    out["card_vs_cpu"] = dict(err=errs, seeds=seeds,
                              f32_launches=small_launches)
    print(f"[mla] reduced {MLA_ARCH} (q·k {small.mla.nope_head_dim} + "
          f"{small.mla.rope_head_dim}, v {small.mla.v_head_dim}, "
          f"{small.num_heads} heads, {small.num_layers} layers; f32) on the "
          f"card against the CPU (token seeds {seeds}): prefill logits "
          f"{errs['prefill']:.3g} ({small_launches} f32 attention launches "
          f"at (192, 128)), decode_scan of {MLA_SMALL_DECODE} tokens with "
          f"memory states {errs['decode']:.3g}, ckv {errs['ckv']:.3g}, "
          f"memory {errs['memory']:.3g} (bar {SLICE_TOL} of max(1, |CPU|); "
          f"usage and read rows equal)")
    torch.cuda.empty_cache()
    part("e")

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"[mla] {MLA_ARCH} at {MLA_LAYERS} of 60 layers: drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    part("draw")

    def ckv_ok(cache, n_tok):
        return (cache["ckv"].shape == (MLA_LAYERS, MLA_B, MLA_MAX_LEN,
                                       mla.kv_lora + mla.rope_head_dim)
                and bool(cache["ckv"][:, :, :n_tok].abs().amax((1, 2, 3))
                         .gt(0).all())
                and not cache["ckv"][:, :, n_tok:].any())

    core = full_width_serving(
        "mla", "DeepSeek-V2", cfg, params, dev, checker, zero_counts, counts,
        flush, part, B=MLA_B, S=MLA_S, prompt=MLA_PROMPT, gen=MLA_GEN,
        max_len=MLA_MAX_LEN, prefill_runs=MLA_PREFILL_RUNS,
        heads=(cfg.num_heads, DQK, DV), cache_ok=ckv_ok,
        cache_what="the ckv cache", decode_dtype=torch.bfloat16)
    out.update(core["out"])

    # (d) the engine on MLA_LANES lanes in lockstep, the rescale 4 -> 2 ->
    # 4 bit for bit; then `serve` and the example.
    out.update(engine_rescale(
        "mla", cfg, params, dev, checker, zero_counts, counts, groups,
        lanes=MLA_LANES, requests=MLA_REQUESTS, req_prompt=MLA_REQ_PROMPT,
        req_gen=MLA_REQ_GEN, max_len=MLA_MAX_LEN, cache_key="ckv"))
    del params
    torch.cuda.empty_cache()
    part("d")
    out.update(serve_full(
        "mla", MLA_ARCH, MLA_LAYERS, "deepseek_v2_236b", dev, counts,
        zero_counts, batch=MLA_B, prompt=MLA_PROMPT, gen=MLA_GEN,
        max_len=MLA_MAX_LEN, vocab=cfg.vocab_size))
    part("serve")
    out["seconds"] = part_s
    print(f"[mla] seconds by part: {part_s}")
    return {"row": core["row"], "bf16_row": core["bf16_row"],
            "launches": {"flash_attention_mla": small_launches,
                         "flash_attention_mla_bf16": cfg.num_layers},
            "err": core["f32_check"]["err"], "bf16_err": core["bf16_err"],
            "mla": out}


def llama4_phase(dev, ops, ref, checker, zero_counts, counts, flush):
    """Phase 18: Llama-4 Maverick (+ SAM) served at full width, its depth
    cut to the first L4_LAYERS of 48 layers. Returns the D = 128 attention
    rows over 48 heads (bf16 at layer 0's prefill inputs, f32 at the same
    inputs upcast), their launches and the numbers."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm
    from repro_torch.models.layers import ParamDef

    cfg = dataclasses.replace(get_config(L4_ARCH), num_layers=L4_LAYERS)
    m, mo = cfg.memory, cfg.moe
    groups = max(1, cfg.num_layers // m.every_n_layers)
    per = (cfg.num_layers - mo.num_dense_layers) // groups
    got = (cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim, mo.num_experts,
           mo.top_k, mo.shared_experts, mo.num_dense_layers, groups, per)
    require(got == (48, 8, 128, 128, 1, 1, 0, 1, 2),
            f"{L4_ARCH} at {L4_LAYERS} layers: (heads, kv heads, head dim, "
            f"experts, top-k, shared, dense, groups, per group) {got}")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # (e) first, the reduced config with the full config's head groups (10
    # heads over 2 padded to 12: groups of 6, 5 real) and one memory group
    # after both layers, in f32 on the card against the CPU.
    small = reduced(cfg)
    small = dataclasses.replace(
        small, compute_dtype="float32", **L4_SMALL,
        memory=dataclasses.replace(small.memory,
                                   every_n_layers=m.every_n_layers))
    errs, seeds, small_launches = reduced_card_vs_cpu(
        small, dev, ops, ref, zero_counts, counts, S=L4_SMALL_S,
        decode=L4_SMALL_DECODE, max_len=L4_SMALL_MAX_LEN)
    out["card_vs_cpu"] = dict(err=errs, seeds=seeds,
                              f32_launches=small_launches)
    print(f"[llama4] reduced {L4_ARCH} ({small.num_heads} heads over "
          f"{small.num_kv_heads} padded to {small.padded_heads}, head dim "
          f"{small.head_dim}, {small.moe.num_experts} experts, top-"
          f"{small.moe.top_k}, {small.num_layers} layers, one memory group; "
          f"f32) on the card against the CPU (token seeds {seeds}): prefill "
          f"logits {errs['prefill']:.3g} ({small_launches} f32 attention "
          f"launches), decode_scan of {L4_SMALL_DECODE} tokens with memory "
          f"states {errs['decode']:.3g}, k {errs['k']:.3g}, v "
          f"{errs['v']:.3g}, memory {errs['memory']:.3g} (bar {SLICE_TOL} of "
          f"max(1, |CPU|); usage and read rows equal)")
    torch.cuda.empty_cache()
    part("e")

    # The weights, drawn on the card where they fit with the prefill's
    # spare; a routed-expert slice is drawn expert by expert (its layer's
    # (128, 5120, 8192) is 21.5 GB in f32: `layers.DRAW_LIMIT`).
    def leaves(defs):
        if isinstance(defs, ParamDef):
            return [defs.shape]
        return [x for v in defs.values() for x in leaves(v)]

    need = 2 * sum(int(torch.tensor(s).prod()) for s in
                   leaves(lm.param_defs(cfg)))
    _, avail = fits(0)
    require(need + L4_SPARE <= avail, f"{L4_ARCH} at {L4_LAYERS} layers "
            f"needs {need} B of bf16 weights and {L4_SPARE} B beside them; "
            f"{avail} B are free")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated() - held - need
    out.update(draw_s=draw_s, draw_transient_bytes=draw_peak,
               free_before_bytes=avail)
    print(f"[llama4] {L4_ARCH} at {L4_LAYERS} of 48 layers: {need} B of bf16 "
          f"weights drawn on the card in {draw_s:.1f} s, {draw_peak} B of "
          f"f32 draws above them at the peak; {avail} B were free")
    part("draw")

    def kv_ok(cache, n_tok):
        shape = (L4_LAYERS, L4_B, L4_MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
        return all(cache[key].shape == shape
                   and bool(cache[key][:, :, :n_tok].abs().amax((1, 2, 3, 4))
                            .gt(0).all())
                   and not cache[key][:, :, n_tok:].any()
                   for key in ("k", "v"))

    core = full_width_serving(
        "llama4", "Llama-4 Maverick", cfg, params, dev, checker, zero_counts,
        counts, flush, part, B=L4_B, S=L4_S, prompt=L4_PROMPT, gen=L4_GEN,
        max_len=L4_MAX_LEN, prefill_runs=L4_PREFILL_RUNS,
        heads=(cfg.padded_heads, cfg.head_dim, cfg.head_dim), cache_ok=kv_ok,
        cache_what="the k and v caches", decode_dtype=torch.bfloat16)
    out.update(core["out"])

    # (d) the engine on L4_LANES lanes in lockstep, the rescale 4 -> 2 ->
    # 4 bit for bit; then `serve` and the example.
    out.update(engine_rescale(
        "llama4", cfg, params, dev, checker, zero_counts, counts, groups,
        lanes=L4_LANES, requests=L4_REQUESTS, req_prompt=L4_REQ_PROMPT,
        req_gen=L4_REQ_GEN, max_len=L4_MAX_LEN, cache_key="k and v"))
    del params
    torch.cuda.empty_cache()
    part("d")
    out.update(serve_full(
        "llama4", L4_ARCH, L4_LAYERS, L4_ARCH, dev, counts, zero_counts,
        batch=L4_B, prompt=L4_PROMPT, gen=L4_GEN, max_len=L4_MAX_LEN,
        vocab=cfg.vocab_size))
    part("serve")
    out["seconds"] = part_s
    print(f"[llama4] seconds by part: {part_s}")
    return {"row": core["row"], "bf16_row": core["bf16_row"],
            "launches": {"flash_attention_llama4": small_launches,
                         "flash_attention_llama4_bf16": cfg.num_layers},
            "err": core["f32_check"]["err"], "bf16_err": core["bf16_err"],
            "llama4": out}


def musicgen_phase(dev, ops, ref, checker, zero_counts, counts, flush):
    """Phase 20: MusicGen-medium (+ SAM) served at full width and full
    depth on frame embeddings. Returns the D = 64 attention rows over 48
    heads (bf16 at layer 0's prefill inputs, f32 at the same inputs
    upcast), their launches in the prefill and the numbers."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import lm

    cfg = get_config(MG_ARCH)
    groups = cfg.num_layers // cfg.memory.every_n_layers
    got = (cfg.num_layers, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim,
           groups, cfg.frontend)
    require(got == (48, 48, 24, 64, 12, "audio"),
            f"{MG_ARCH}: (layers, padded heads, kv heads, head dim, memory "
            f"groups, frontend) {got}")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # (e) first, the reduced config with the full config's head groups (4
    # MHA heads padded to 8: groups of 2, 1 real), in f32 on the card
    # against the CPU, on frames.
    small = dataclasses.replace(reduced(cfg), compute_dtype="float32",
                                **MG_SMALL)
    errs, seeds, small_launches = reduced_card_vs_cpu(
        small, dev, ops, ref, zero_counts, counts, S=MG_SMALL_S,
        decode=MG_SMALL_DECODE, max_len=MG_SMALL_MAX_LEN)
    out["card_vs_cpu"] = dict(err=errs, seeds=seeds,
                              f32_launches=small_launches)
    print(f"[musicgen] reduced {MG_ARCH} ({small.num_heads} heads over "
          f"{small.num_kv_heads} padded to {small.padded_heads}, head dim "
          f"{small.head_dim}, {small.num_layers} layers; f32) on the card "
          f"against the CPU on frames (seeds {seeds}): prefill logits "
          f"{errs['prefill']:.3g} ({small_launches} f32 attention launches), "
          f"decode_scan of {MG_SMALL_DECODE} frames with memory states "
          f"{errs['decode']:.3g}, k {errs['k']:.3g}, v {errs['v']:.3g}, "
          f"memory {errs['memory']:.3g} (bar {SLICE_TOL} of max(1, |CPU|); "
          f"usage and read rows equal)")
    torch.cuda.empty_cache()
    part("e")

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    print(f"[musicgen] {MG_ARCH} at all 48 layers: drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    part("draw")

    def kv_ok(cache, n_tok):
        shape = (cfg.num_layers, MG_B, MG_MAX_LEN, cfg.num_kv_heads,
                 cfg.head_dim)
        return all(cache[key].shape == shape
                   and bool(cache[key][:, :, :n_tok].abs().amax((1, 2, 3, 4))
                            .gt(0).all())
                   and not cache[key][:, :, n_tok:].any()
                   for key in ("k", "v"))

    core = full_width_serving(
        "musicgen", "MusicGen-medium", cfg, params, dev, checker, zero_counts,
        counts, flush, part, B=MG_B, S=MG_S, prompt=MG_PROMPT, gen=MG_GEN,
        max_len=MG_MAX_LEN, prefill_runs=MG_PREFILL_RUNS,
        heads=(cfg.padded_heads, cfg.head_dim, cfg.head_dim), cache_ok=kv_ok,
        cache_what="the k and v caches", decode_dtype=torch.bfloat16)
    out.update(core["out"])

    # (d) the engine feeds token ids: it refuses audio, as JAX's does.
    try:
        ServeEngine(cfg, lanes=4, max_len=MG_MAX_LEN, params=params,
                    device=dev)
        refusal = None
    except NotImplementedError as e:
        refusal = str(e)
    require(refusal is not None and "audio frames" in refusal,
            f"the engine took an audio config ({refusal})")
    out["engine_refusal"] = refusal
    print(f"[musicgen] the engine refuses audio, as JAX's: {refusal}")
    del params
    torch.cuda.empty_cache()
    part("d")
    out.update(serve_full(
        "musicgen", MG_ARCH, None, "musicgen_medium", dev, counts,
        zero_counts, batch=MG_B, prompt=SERVE_PROMPT, gen=SERVE_GEN,
        max_len=MG_MAX_LEN, vocab=cfg.vocab_size))
    part("serve")
    out["seconds"] = part_s
    print(f"[musicgen] seconds by part: {part_s}")
    by_dtype = out["flash_by_dtype"]
    return {"row": core["row"], "bf16_row": core["bf16_row"],
            "launches": {"flash_attention_musicgen": by_dtype["float32"],
                         "flash_attention_musicgen_bf16":
                             by_dtype["bfloat16"]},
            "err": core["f32_check"]["err"], "bf16_err": core["bf16_err"],
            "musicgen": out}


def rwkv_phase(dev, ops, ref, checker, zero_counts, counts, flush):
    """Phase 21: RWKV-6 7B (+ SAM) served at full width and full depth.
    Returns the numbers (no attention: its WKV recurrence is plain PyTorch,
    as JAX's is plain JAX)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm, rwkv

    cfg = get_config(RW_ARCH)
    groups = cfg.num_layers // cfg.memory.every_n_layers
    H, D = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    got = (cfg.num_layers, cfg.d_model, H, D, cfg.d_ff, groups)
    require(got == (32, 4096, 64, 64, 14336, 8),
            f"{RW_ARCH}: (layers, d, heads, head size, d_ff, memory groups) "
            f"{got}")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # (e) first, the reduced config, its zero leaves drawn, in f32 on the
    # card against the CPU.
    small = dataclasses.replace(reduced(cfg), compute_dtype="float32")
    errs, seeds, _ = reduced_card_vs_cpu(
        small, dev, ops, ref, zero_counts, counts, S=RW_SMALL_S,
        decode=RW_SMALL_DECODE, max_len=RW_SMALL_MAX_LEN)
    out["card_vs_cpu"] = dict(err=errs, seeds=seeds)
    print(f"[rwkv] reduced {RW_ARCH} (head size {small.rwkv.head_size}, "
          f"{small.num_layers} layers, zero leaves drawn; f32) on the card "
          f"against the CPU (token seeds {seeds}): prefill logits "
          f"{errs['prefill']:.3g}, decode_scan of {RW_SMALL_DECODE} tokens "
          f"with memory states {errs['decode']:.3g}, tm_shift "
          f"{errs['tm_shift']:.3g}, wkv {errs['wkv']:.3g}, cm_shift "
          f"{errs['cm_shift']:.3g}, memory {errs['memory']:.3g} (bar "
          f"{SLICE_TOL} of max(1, |CPU|); usage and read rows equal)")
    torch.cuda.empty_cache()
    part("e")

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    draw_rwkv_zero_leaves(params, torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    print(f"[rwkv] {RW_ARCH} at all 32 layers: drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s, the zero leaves drawn")
    part("draw")

    def state_ok(cache, n_tok):
        want = {"tm_shift": ((cfg.num_layers, RW_B, cfg.d_model),
                             torch.bfloat16),
                "wkv": ((cfg.num_layers, RW_B, H, D, D), torch.float32),
                "cm_shift": ((cfg.num_layers, RW_B, cfg.d_model),
                             torch.bfloat16)}
        return set(cache) == {*want, "pos"} and all(
            cache[k].shape == shape and cache[k].dtype == dtype
            and bool(torch.isfinite(cache[k]).all())
            and bool(cache[k].flatten(1).abs().amax(1).gt(0).all())
            for k, (shape, dtype) in want.items())

    # The prefill (the lockstep one, timed) runs with each WKV loop timed
    # between synchronisations: the loop's host share (a few launches a
    # step).
    scan, wkv_s = rwkv.wkv_scan, []

    @contextlib.contextmanager
    def wkv_timed():
        rwkv.wkv_scan = synced(scan, wkv_s)
        try:
            yield
        finally:
            rwkv.wkv_scan = scan

    core = full_width_serving(
        "rwkv", "RWKV-6 7B", cfg, params, dev, checker, zero_counts, counts,
        flush, part, B=RW_B, S=RW_S, prompt=RW_PROMPT, gen=RW_GEN,
        max_len=RW_MAX_LEN, prefill_runs=0, heads=None,
        cache_ok=state_ok, cache_what="an RWKV state (wkv f32, the shifts "
        "bf16)", decode_dtype=torch.bfloat16, prefill_context=wkv_timed)
    out.update(core["out"])
    require(len(wkv_s) == cfg.num_layers, f"the timed prefill ran "
            f"{len(wkv_s)} WKV loops, not {cfg.num_layers}")
    total, loops = out["prefill_ms"], sum(wkv_s) * 1e3
    steps = cfg.num_layers * RW_S
    out.update(wkv_loop_ms=loops, wkv_host_share=loops / total,
               wkv_us_per_step=loops * 1e3 / steps)
    print(f"[time] RWKV-6 7B prefill (B={RW_B}, S={RW_S}): the "
          f"{cfg.num_layers} WKV loops ({steps} steps, each loop timed "
          f"between synchronisations) take {loops:.1f} ms of {total:.1f} "
          f"({loops / total:.1%}); {loops * 1e3 / steps:.1f} µs a step")

    # The decode's norms are lane-invariant: `layers.row_mean` gives a
    # row of 4 lanes the bits it gives it among 2, where `mean(-1)` splits
    # a long row across more thread blocks when there are fewer rows.
    from repro_torch.models.layers import row_mean
    gen = torch.Generator().manual_seed(21)
    apart = {"mean": 0, "row_mean": 0}
    for _ in range(ROW_SUM_DRAWS):     # a decode's rows, (B, 1, d)
        x = (torch.randn((4, 1, cfg.d_model), generator=gen) * 30).to(dev)
        apart["mean"] += not torch.equal(x.square().mean(-1)[:2],
                                         x[:2].square().mean(-1))
        apart["row_mean"] += not torch.equal(row_mean(x.square())[:2],
                                             row_mean(x[:2].square()))
    out["row_means_apart"] = apart
    require(apart["row_mean"] == 0, f"row_mean of 2 rows against 4: "
            f"{apart['row_mean']} of {ROW_SUM_DRAWS} draws apart")
    print(f"[rwkv] a row of d = {cfg.d_model} in 4 lanes against 2, over "
          f"{ROW_SUM_DRAWS} draws: mean(-1) of its squares apart in "
          f"{apart['mean']}, `layers.row_mean` in {apart['row_mean']}")

    # (d) the engine on RW_LANES lanes in lockstep, the rescale 4 -> 2 -> 4
    # bit for bit.
    out.update(engine_rescale(
        "rwkv", cfg, params, dev, checker, zero_counts, counts, groups,
        lanes=RW_LANES, requests=RW_REQUESTS, req_prompt=RW_REQ_PROMPT,
        req_gen=RW_REQ_GEN, max_len=RW_MAX_LEN,
        cache_key="tm_shift, wkv and cm_shift"))
    del params
    torch.cuda.empty_cache()
    part("d")
    out["seconds"] = part_s
    print(f"[rwkv] seconds by part: {part_s}")
    return {"rwkv": out}


def hymba_phase(dev, ops, ref, checker, zero_counts, counts, flush):
    """Phase 22: Hymba-1.5B (+ SAM) served at full width and full depth,
    then the sparse top-K decode (`sparse_decode_part`). Returns the D = 64
    windowed attention rows over 80 heads (bf16 at layer 0's prefill
    inputs, f32 at the same inputs upcast), their launches in the prefill
    and the numbers."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm, ssm

    cfg = get_config(HY_ARCH)
    groups = cfg.num_layers // cfg.memory.every_n_layers
    d_inner = cfg.ssm.expand * cfg.d_model // 2
    got = (cfg.num_layers, cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.window, d_inner, cfg.ssm.state_size, groups)
    require(got == (32, 1600, 80, 5, 64, 1024, 1600, 16, 8),
            f"{HY_ARCH}: (layers, d, padded heads, kv heads, head dim, "
            f"window, d_inner, state, memory groups) {got}")
    out, part_s, clock = {}, {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # (e) first, the reduced config with the full config's head groups (10
    # heads over 2 padded to 32: groups of 16, 5 real), its SSM leaves
    # drawn, in f32 on the card against the CPU.
    small = dataclasses.replace(reduced(cfg), compute_dtype="float32",
                                **HY_SMALL)
    errs, seeds, small_launches = reduced_card_vs_cpu(
        small, dev, ops, ref, zero_counts, counts, S=HY_SMALL_S,
        decode=HY_SMALL_DECODE, max_len=HY_SMALL_MAX_LEN)
    out["card_vs_cpu"] = dict(err=errs, seeds=seeds,
                              f32_launches=small_launches)
    print(f"[hymba] reduced {HY_ARCH} ({small.num_heads} heads over "
          f"{small.num_kv_heads} padded to {small.padded_heads}, head dim "
          f"{small.head_dim}, window {small.window}, SSM state "
          f"{small.ssm.state_size}, {small.num_layers} layers, SSM leaves "
          f"drawn; f32) on the card against the CPU (token seeds {seeds}): "
          f"prefill logits {errs['prefill']:.3g} ({small_launches} f32 "
          f"attention launches), decode_scan of {HY_SMALL_DECODE} tokens "
          f"with memory states {errs['decode']:.3g}, k {errs['k']:.3g}, v "
          f"{errs['v']:.3g}, conv {errs['conv']:.3g}, ssm "
          f"{errs['ssm']:.3g}, memory {errs['memory']:.3g} (bar "
          f"{SLICE_TOL} of max(1, |CPU|); usage and read rows equal)")
    torch.cuda.empty_cache()
    part("e")

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    draw_ssm_leaves(params, torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    print(f"[hymba] {HY_ARCH} at all 32 layers: drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s, the SSM leaves drawn")
    part("draw")

    def cache_ok(cache, n_tok):
        L = cfg.num_layers
        kv_shape = (L, HY_B, min(HY_MAX_LEN, cfg.window), cfg.num_kv_heads,
                    cfg.head_dim)
        kv = all(cache[key].shape == kv_shape
                 and cache[key].dtype == torch.bfloat16
                 and bool(cache[key][:, :, :n_tok].abs().amax((1, 2, 3, 4))
                          .gt(0).all())
                 and not cache[key][:, :, n_tok:].any()
                 for key in ("k", "v"))
        states = {"conv": ((L, HY_B, cfg.ssm.conv_width - 1, d_inner),
                           torch.bfloat16),
                  "ssm": ((L, HY_B, d_inner, cfg.ssm.state_size),
                          torch.float32)}
        return set(cache) == {"k", "v", *states, "pos"} and kv and all(
            cache[k].shape == shape and cache[k].dtype == dtype
            and bool(torch.isfinite(cache[k]).all())
            and bool(cache[k].flatten(1).abs().amax(1).gt(0).all())
            for k, (shape, dtype) in states.items())

    # The timed prefill runs with each SSM head and each scan timed between
    # synchronisations: their share of the prefill.
    scan, head, scan_s, head_s = ssm._scan_assoc, ssm.ssm_apply, [], []

    @contextlib.contextmanager
    def ssm_timed():
        ssm._scan_assoc = synced(scan, scan_s)
        ssm.ssm_apply = synced(head, head_s)
        try:
            yield
        finally:
            ssm._scan_assoc, ssm.ssm_apply = scan, head

    core = full_width_serving(
        "hymba", "Hymba-1.5B", cfg, params, dev, checker, zero_counts,
        counts, flush, part, B=HY_B, S=HY_S, prompt=HY_PROMPT, gen=HY_GEN,
        max_len=HY_MAX_LEN, prefill_runs=HY_PREFILL_RUNS,
        heads=(cfg.padded_heads, cfg.head_dim, cfg.head_dim),
        cache_ok=cache_ok, cache_what="the cache (k and v a ring, conv "
        "bf16, ssm f32)", decode_dtype=torch.bfloat16,
        prefill_context=ssm_timed)
    out.update(core["out"])
    runs = cfg.num_layers * HY_PREFILL_RUNS
    require(len(scan_s) == len(head_s) == runs, f"the timed prefills ran "
            f"{len(head_s)} SSM heads and {len(scan_s)} scans, not {runs}")
    total = sum(out["prefill_ms_all"])
    scans, heads = sum(scan_s) * 1e3, sum(head_s) * 1e3
    out.update(ssm_scan_ms=scans / HY_PREFILL_RUNS,
               ssm_scan_share=scans / total,
               ssm_head_ms=heads / HY_PREFILL_RUNS,
               ssm_head_share=heads / total)
    print(f"[time] Hymba-1.5B prefill (B={HY_B}, S={HY_S}): the "
          f"{cfg.num_layers} SSM heads (each timed between "
          f"synchronisations) take {heads / HY_PREFILL_RUNS:.1f} ms of "
          f"{total / HY_PREFILL_RUNS:.1f} ({heads / total:.1%}), their "
          f"scans {scans / HY_PREFILL_RUNS:.1f} ms ({scans / total:.1%})")

    # (d) the engine on HY_LANES lanes in lockstep, the rescale 4 -> 2 -> 4
    # bit for bit.
    out.update(engine_rescale(
        "hymba", cfg, params, dev, checker, zero_counts, counts, groups,
        lanes=HY_LANES, requests=HY_REQUESTS, req_prompt=HY_REQ_PROMPT,
        req_gen=HY_REQ_GEN, max_len=HY_MAX_LEN,
        cache_key="k, v, conv and ssm"))
    del params
    torch.cuda.empty_cache()
    part("d")
    out.update(serve_full(
        "hymba", HY_ARCH, None, HY_ARCH, dev, counts, zero_counts,
        batch=HY_B, prompt=SERVE_PROMPT, gen=SERVE_GEN, max_len=HY_MAX_LEN,
        vocab=cfg.vocab_size))
    part("serve")
    out["sparse"] = sparse_decode_part(dev, ops, ref, zero_counts, counts)
    part("s")
    out["seconds"] = part_s
    print(f"[hymba] seconds by part: {part_s}")
    by_dtype = out["flash_by_dtype"]
    return {"row": core["row"], "bf16_row": core["bf16_row"],
            "launches": {"flash_attention_hymba": by_dtype["float32"],
                         "flash_attention_hymba_bf16": by_dtype["bfloat16"]},
            "err": core["f32_check"]["err"], "bf16_err": core["bf16_err"],
            "hymba": out}


def sparse_decode_part(dev, ops, ref, zero_counts, counts):
    """Phase 22's sparse top-K decode (`attention.gqa_decode_sparse`, plain
    PyTorch as JAX's is plain JAX): the reduced `starcoder2_7b_sam` with
    SP_SMALL on the card against the CPU (`reduced_card_vs_cpu`: k, v and
    ksum among the cache leaves); then one call at StarCoder2-7B's
    attention widths with SP_BIG over a drawn cache of SP_SLOTS slots,
    ksum the sums of each block's written slots: at SP_EQUAL_POS, where
    every written block is read, equal to `gqa_decode` within SLICE_TOL
    of max(1, |dense|) (f32); both timed at the last slot, f32 and bf16:
    the ms of a call's kernels (`device_time`: each is a few dozen
    launches, so a window between two events would hold the host's gaps)
    and its host ms. Returns the numbers."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import init_from_defs

    small = dataclasses.replace(reduced(get_config(LM_ARCH)),
                                compute_dtype="float32", **SP_SMALL)
    errs, seeds, _ = reduced_card_vs_cpu(
        small, dev, ops, ref, zero_counts, counts, S=HY_SMALL_S,
        decode=HY_SMALL_DECODE, max_len=HY_SMALL_MAX_LEN)
    out = {"card_vs_cpu": dict(err=errs, seeds=seeds)}
    print(f"[sparse] reduced {LM_ARCH} with "
          f"{SP_SMALL['sparse_decode_blocks']} blocks of "
          f"{SP_SMALL['sparse_decode_block']} read "
          f"(f32) on the card against the CPU (token seeds {seeds}): "
          f"decode_scan of {HY_SMALL_DECODE} tokens with memory states "
          f"{errs['decode']:.3g}, k {errs['k']:.3g}, v {errs['v']:.3g}, "
          f"ksum {errs['ksum']:.3g}, memory {errs['memory']:.3g} (bar "
          f"{SLICE_TOL} of max(1, |CPU|))")

    big = dataclasses.replace(get_config("starcoder2_7b"), **SP_BIG)
    bs, Hkv, D = big.sparse_decode_block, big.num_kv_heads, big.head_dim
    gen = torch.Generator(device=dev).manual_seed(22)
    slot = torch.arange(SP_SLOTS, device=dev)[None, :, None, None]

    def ksum_below(kc, pos):
        return (kc.float() * (slot < pos)).reshape(
            SP_B, SP_SLOTS // bs, bs, Hkv, D).sum(2).to(kc.dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        p = init_from_defs(attn.attn_defs(big), gen, dtype, dev)
        x = torch.randn((SP_B, 1, big.d_model), generator=gen,
                        device=dev).to(dtype)
        kc, vc = (torch.randn((SP_B, SP_SLOTS, Hkv, D), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        if dtype == torch.float32:
            at = torch.tensor(SP_EQUAL_POS, dtype=torch.int32, device=dev)
            sparse = attn.gqa_decode_sparse(
                p, big, x, kc.clone(), vc.clone(),
                ksum_below(kc, SP_EQUAL_POS), at)[0]
            dense = attn.gqa_decode(p, big, x, kc.clone(), vc.clone(), at)[0]
            err = (sparse - dense).abs().max().item()
            scale = max(1.0, dense.abs().max().item())
            require(bool(torch.isfinite(sparse).all())
                    and err <= SLICE_TOL * scale,
                    f"gqa_decode_sparse at pos {SP_EQUAL_POS} (every written "
                    f"block read) differs from gqa_decode by {err:.3g}, "
                    f"above {SLICE_TOL} x {scale:.3g}")
            out["equal_to_dense_err"] = err
        last = torch.tensor(SP_SLOTS - 1, dtype=torch.int32, device=dev)
        ks = ksum_below(kc, SP_SLOTS - 1)

        def run_sparse(_=None):
            attn.gqa_decode_sparse(p, big, x, kc, vc, ks, last)

        def run_dense(_=None):
            attn.gqa_decode(p, big, x, kc, vc, last)

        run_sparse(), run_dense()
        row = dict(sparse_ms=device_time(run_sparse)[0],
                   dense_ms=device_time(run_dense)[0],
                   sparse_host_ms=host_ms(run_sparse, runs=10)[0],
                   dense_host_ms=host_ms(run_dense, runs=10)[0])
        out[name] = row
        print(f"[time] gqa_decode_sparse {name} at StarCoder2-7B's attention "
              f"(B={SP_B}, {big.padded_heads} heads over {Hkv}, D={D}, a "
              f"cache of {SP_SLOTS} slots, {SP_BIG['sparse_decode_blocks']}"
              f" blocks of {bs} read) at pos {SP_SLOTS - 1}: "
              f"{row['sparse_ms']:.4f} ms of kernels (host "
              f"{row['sparse_host_ms']:.4f}), gqa_decode "
              f"{row['dense_ms']:.4f} ms (host {row['dense_host_ms']:.4f})")
        del p, x, kc, vc, ks
    print(f"[sparse] gqa_decode_sparse at pos {SP_EQUAL_POS} (every written "
          f"block read) against gqa_decode, f32: "
          f"{out['equal_to_dense_err']:.3g}")
    torch.cuda.empty_cache()
    return out


def ft_small(arch):
    """The reduced config of ``arch`` (f32) with its FT_SMALL overrides:
    the serving phases' head groups, Danube's head dim 120, PaliGemma's
    head dim 256 over one kv head, DeepSeek-V2's (192, 128) heads over 3
    layers with a memory group every 2 (so its two MoE blocks run),
    Llama-4's one memory group after both layers."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.config import MLAConfig

    kw = dict(dict(FT_SMALL)[arch])
    small = dataclasses.replace(reduced(get_config(arch)),
                                compute_dtype="float32")
    if "every" in kw:
        small = dataclasses.replace(small, memory=dataclasses.replace(
            small.memory, every_n_layers=kw.pop("every")))
    if small.mla is not None:
        mla = {k: kw.pop(k) for k in ("kv_lora", "q_lora", "rope_head_dim",
                                      "nope_head_dim", "v_head_dim")}
        kw["mla"] = MLAConfig(**mla)
    return dataclasses.replace(small, **kw)


def train_launches(cfg, S) -> dict:
    """The kernel launches of one train step of ``cfg`` on S positions:
    the attention once a block that runs (JAX's grouping skips trailing
    blocks), twice under remat (the backward's recompute), none in an RWKV
    config, all in the forward (its backward is plain); a memory step per
    group and segment, each one read, write and LRA in the forward and
    SAM_BWD_SCATTERS scatters in the backward."""
    m = cfg.memory
    groups = max(1, cfg.num_layers // m.every_n_layers)
    n_dense = cfg.moe.num_dense_layers if cfg.moe is not None else 0
    ran = n_dense + groups * ((cfg.num_layers - n_dense) // groups)
    mem_steps = groups * (S // m.segment)
    attn = 0 if cfg.block == "rwkv" else ran * (2 if cfg.remat else 1)
    return {"flash_attention": attn, "scatter_rows":
            SAM_BWD_SCATTERS * mem_steps,
            **{name: mem_steps for name in FORWARD}}


def train_grads_close(p_cpu, cfg, batch, g_gpu, g_cpu):
    """The card's gradient tree against the CPU's, leaf by leaf: within
    GRAD_ATOL of max(1, max |g|) over the leaf, or, where a leaf is not,
    its largest miss within FT_SPREAD_FACTOR times the CPU's largest own
    move under FT_SPREAD_DRAWS one-ulp perturbations of every weight (1 +
    2^-24·N(0, 1)). Returns (the largest miss over max(1, max |g|), [(leaf,
    miss, the CPU's own move)] of the arbitrated leaves)."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map

    def spread():
        gen = torch.Generator().manual_seed(1)
        return [pytree.tree_leaves(steps.value_and_grad(tree_map(
            lambda t: t * (1 + torch.randn(t.shape, generator=gen)
                           * 2 ** -24), p_cpu), cfg, batch)[2])
                for _ in range(FT_SPREAD_DRAWS)]

    own, worst, arbitrated = None, 0.0, []
    names = leaf_names(g_cpu)
    for i, (a, b) in enumerate(zip(pytree.tree_leaves(g_gpu),
                                   pytree.tree_leaves(g_cpu), strict=True)):
        d = (a.float().cpu() - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        worst = max(worst, d / scale)
        if d <= GRAD_ATOL * scale:
            continue
        own = spread() if own is None else own
        cpu_own = max((run[i] - b).abs().max().item() for run in own)
        arbitrated.append((names[i], d, cpu_own))
        require(d <= FT_SPREAD_FACTOR * cpu_own, f"gradient {names[i]}: "
                f"card against CPU {d:.3g}, beyond {GRAD_ATOL} x {scale:.3g} "
                f"and {FT_SPREAD_FACTOR} times the CPU's own move under a "
                f"one-ulp perturbation ({cpu_own:.3g})")
    return worst, arbitrated


def family_train_phase(dev, ops, ref, zero_counts, counts):
    """Phase 23: the served LM families trained through `make_train_step`
    (module docstring, item 23). Returns its numbers."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.launch import specs, steps
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import optimizers as opt

    out = {"card_vs_cpu": {}, "attention_grad": {}, "full": {},
           "seconds": {}}
    clock = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        out["seconds"][name] = round(now - clock[0], 1)
        clock[0] = now

    def draw_leaves(params, cfg):
        """RWKV's zero leaves (from a CPU generator) or the SSM's leaves
        (from one on the weights' device), as phases 21 and 22 draw them."""
        if cfg.block == "rwkv":
            draw_rwkv_zero_leaves(params, torch.Generator().manual_seed(5))
        if cfg.block == "hybrid":
            device = pytree.tree_leaves(params)[0].device
            draw_ssm_leaves(params,
                            torch.Generator(device=device).manual_seed(5))

    # (a) each family's reduced config, two steps on the card against the
    # CPU from the same weights and batch; the batch seed the first of
    # 0-63 whose CPU reads hold no near-tie at K and whose routers none at
    # k through both steps.
    for arch, _ in FT_SMALL:
        small = ft_small(arch)
        p0 = lm.init_params(small, seed=0, device="cpu")
        draw_leaves(p0, small)
        step_fn = steps.make_train_step(small)
        vg = steps.value_and_grad

        def two_steps(params, batch):
            """Two steps in place -> ([(loss, grads)] a step, metrics)."""
            seen = []

            def capture(*a):
                seen.append(vg(*a))
                return seen[-1]

            state, ms = opt.adamw_init(params), []
            steps.value_and_grad = capture
            try:
                for _ in range(2):
                    params, state, m = step_fn(params, state, batch)
                    ms.append(m)
            finally:
                steps.value_and_grad = vg
            return [(s[0], s[2]) for s in seen], ms

        def cpu_case(gen):
            batch = specs.concrete_batch(small, 2, FT_SMALL_S, generator=gen,
                                         device="cpu")
            params = tree_map(lambda t: t.clone(), p0)
            return batch, params, two_steps(params, batch)

        seed, (batch, p_cpu, (g_cpu, m_cpu)) = stable_routed(
            ops, ref, cpu_case, f"{arch}'s reduced train steps")
        p_gpu = tree_map(lambda t: t.to(dev), p0)
        zero_counts()
        g_gpu, m_gpu = two_steps(p_gpu, tree_map(lambda t: t.to(dev), batch))
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
        want = {k: 2 * v for k, v in train_launches(small, FT_SMALL_S).items()
                if v}
        require(launched == want, f"{arch} (reduced): two train steps "
                f"launched {launched}, expected {want}")
        # The first step's rate is 0, so the second takes its gradients at
        # the same weights: the first's are compared.
        errs = {"loss": max(card_close(a[0], b[0], f"{arch} loss")
                            for a, b in zip(g_gpu, g_cpu))}
        errs["grad"], arbitrated = train_grads_close(
            p0, small, batch, g_gpu[0][1], g_cpu[0][1])
        errs["params"] = max(
            (a.float().cpu() - b).abs().max().item()
            / max(1.0, b.abs().max().item())
            for a, b in zip(pytree.tree_leaves(p_gpu),
                            pytree.tree_leaves(p_cpu)))
        require(errs["params"] <= TOL, f"{arch} (reduced): parameters after "
                f"two steps {errs['params']:.3g} apart, card against CPU")
        # (The gradient norm follows the leaves, some of them held to the
        # CPU's own spread above, so it is not held to SLICE_TOL.)
        card_close(m_gpu[1]["lr"], m_cpu[1]["lr"], f"{arch} lr")
        out["card_vs_cpu"][arch] = dict(seed=seed, err=errs,
                                        launches=launched,
                                        arbitrated=arbitrated)
        print(f"[train23] reduced {arch} (f32, {small.num_layers} layers, "
              f"head dim {small.head_dim}) two steps on the card against "
              f"the CPU (batch seed {seed}): loss {errs['loss']:.3g}, "
              f"gradients {errs['grad']:.3g} of max(1, max |g|) (bar "
              f"{GRAD_ATOL}"
              + (f"; arbitrated {[(n, f'{d:.3g}', f'{o:.3g}') for n, d, o in arbitrated]}"
                 if arbitrated else "")
              + f"), parameters {errs['params']:.3g}; launches {launched}")
        del p0, p_cpu, p_gpu, g_cpu, g_gpu
        part(f"a {arch}")

    # (b) the attention Function's gradient at each new full-width training
    # shape, unit normal, against autograd through the plain version.
    shapes = []
    for arch in ("hymba_1_5b_sam", "paligemma_3b_sam", "musicgen_medium_sam",
                 "deepseek_v2_236b_sam"):
        c = get_config(arch)
        if c.mla is not None:
            D = c.mla.nope_head_dim + c.mla.rope_head_dim
            shapes.append((arch, c.num_heads, c.num_heads, D,
                           c.mla.v_head_dim, None, 0, c.q_block))
        else:
            shapes.append((arch, c.padded_heads, c.num_kv_heads, c.head_dim,
                           c.head_dim, c.window, c.prefix_lm, c.q_block))
    Bf, Sf = FT_ATTN_B, FT_ATTN_S
    gen = torch.Generator().manual_seed(11)
    for arch, H, Hkv, D, DV, window, prefix, qb in shapes:
        row = {"shape": (Bf, Sf, H, Hkv, D, DV), "window": window,
               "prefix": prefix}
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((Bf, Sf, H, D), generator=gen).to(dev, dtype)
            k = torch.randn((Bf, Sf, Hkv, D), generator=gen).to(dev, dtype)
            v = torch.randn((Bf, Sf, Hkv, DV), generator=gen).to(dev, dtype)
            g = torch.randn((Bf, Sf, H, DV), generator=gen).to(dev, dtype)
            for t in (q, k, v):
                t.requires_grad_()
            zero_counts()
            got = torch.autograd.grad(ops.flash_attention(
                q, k, v, q_block=qb, window=window, prefix=prefix),
                (q, k, v), g)
            require(counts()["flash_attention"] == 1, f"{arch}: the "
                    f"attention Function did not launch its kernel once")
            plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(ref.flash_attention_ref(
                *plain, window=window, prefix=prefix), plain, g.float())
            errs = []
            for name, a, b in zip("qkv", got, want):
                if dtype == torch.bfloat16:
                    err = (a.float() - b).abs().max().item()
                    require(a.dtype == dtype and err <= bf16_ulp(b),
                            f"{arch}: attention d{name} (bf16) {err:.3g} "
                            f"above one bf16 ulp {bf16_ulp(b):.3g}")
                else:
                    err = rel_err(a, b)
                errs.append(err)
            del plain, want
            key = str(dtype)[6:]
            row[key] = max(errs)
            if dtype == torch.float32 and max(errs) > FLASH_TOL:
                # Two f32 orders over S·G terms: each gradient no further
                # from the f64 one than twice the plain version's.
                leaves = [t.detach().double().requires_grad_()
                          for t in (q, k, v)]
                exact = torch.autograd.grad(ref.flash_attention_ref(
                    *leaves, window=window, prefix=prefix), leaves,
                    g.double())
                del leaves
                plain = [t.detach().float().requires_grad_()
                         for t in (q, k, v)]
                want = torch.autograd.grad(ref.flash_attention_ref(
                    *plain, window=window, prefix=prefix), plain, g.float())
                row["f64"] = []
                for name, a, b, e in zip("qkv", got, want, exact):
                    got_err, plain_err = f64_err(a, e), f64_err(b, e)
                    require(got_err <= 2 * plain_err + FLASH_TOL,
                            f"{arch}: attention d{name} (f32) {got_err:.3g} "
                            f"from the f64 gradient, the plain version "
                            f"{plain_err:.3g}")
                    row["f64"].append((got_err, plain_err))
                del exact, plain, want
            del q, k, v, g, got
            torch.cuda.empty_cache()
        out["attention_grad"][arch] = row
        part(f"b {arch}")
        print(f"[train23] attention gradient at {arch}'s training shape "
              f"(B, S, H, Hkv, D, DV) = {row['shape']}, window {window}, "
              f"prefix {prefix}, blocks of {qb} query rows, against autograd "
              f"through the plain version: bf16 {row['bfloat16']:.3g} (one "
              f"bf16 ulp), f32 {row['float32']:.3g} of max(1, |g|) (bar "
              f"{FLASH_TOL}"
              + (f"; from f64: {[(f'{a:.3g}', f'{b:.3g}') for a, b in row['f64']]}"
                 if "f64" in row else "") + ")")

    # (c) full width, bf16 compute, sparse: steps of `make_train_step`
    # (the first with the counters set to 0 just before it and read just
    # after, traced by the profiler but for RWKV, whose WKV loops launch
    # too many kernels to trace), one taken apart (forward, backward,
    # optimizer), the rest timed whole.
    for arch, layers, B_, S_, n_steps in FT_FULL:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=0, device=dev)
        draw_leaves(params, cfg)
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        batch = specs.concrete_batch(
            cfg, B_, S_, generator=torch.Generator().manual_seed(0),
            device=dev)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        res = {"layers": cfg.num_layers, "B": B_, "S": S_,
               "params": n_params, "draw_s": draw_s, "adamw_steps": n_steps}
        want = {k: v for k, v in train_launches(cfg, S_).items() if v}
        step_fn = steps.make_train_step(cfg)
        st = [opt.adamw_init(params) if n_steps else None]
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def one():
            """A train step -> its metrics; a forward and backward only
            where n_steps is 0."""
            if n_steps:
                _, st[0], m = step_fn(params, st[0], batch)
                return m
            loss_, m, grads_ = steps.value_and_grad(params, cfg, batch)
            return {"loss": loss_, **m, "grad_norm": torch.sqrt(sum(
                (g_.float() ** 2).sum() for g_ in pytree.tree_leaves(grads_)))}

        zero_counts()
        t0 = time.perf_counter()
        if cfg.block == "rwkv":
            metrics, dev_ms, on_dev = one(), None, []
        else:
            metrics = {}
            dev_ms, on_dev = device_time(lambda: metrics.update(one()))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v for k, v in counts().items() if v}
        require(launched == want, f"{arch}: a train step launched "
                f"{launched}, expected {want}")
        losses = [float(metrics["loss"])]

        # A step taken apart (the train step's own code, in its order).
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        leaves, spec = pytree.tree_flatten(params)
        diff = [x.detach().requires_grad_() for x in leaves]
        loss, _ = lm.loss_fn(pytree.tree_unflatten(diff, spec), cfg, batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        grads = pytree.tree_unflatten(
            [torch.zeros_like(x) if g_ is None else g_ for x, g_ in zip(
                diff, torch.autograd.grad(loss, diff, allow_unused=True))],
            spec)
        del diff
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if n_steps:
            grads, _ = opt.clip_by_global_norm(grads, 1.0)
            lr = opt.cosine_schedule(st[0].count, base_lr=3e-4, warmup=100,
                                     total=10000)
            st[0] = opt.adamw_update_(params, grads, st[0], lr=lr)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        del grads, leaves
        losses.append(float(loss.detach()))
        parts_ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        step_ms = sum(parts_ms)
        whole_ms = []
        for _ in range(max(0, n_steps - 2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = one()
            torch.cuda.synchronize()
            whole_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        peak = torch.cuda.max_memory_allocated()
        require(all(x == x and abs(x) < float("inf") for x in losses),
                f"{arch}: a loss is not finite: {losses}")
        res.update(launches=launched, losses=losses, first_step_ms=first_ms,
                   fwd_ms=parts_ms[0], bwd_ms=parts_ms[1],
                   opt_ms=parts_ms[2] if n_steps else None, step_ms=step_ms,
                   whole_step_ms=whole_ms,
                   tokens_per_s=B_ * S_ / (step_ms / 1e3), peak_bytes=peak,
                   held_bytes=held, device_ms=dev_ms,
                   busy_share=dev_ms / step_ms if dev_ms else None,
                   top_kernels=[(k, t_, c) for k, t_, c in on_dev[:6]])
        out["full"][arch] = res
        busy = (f"{dev_ms:.1f} ms of kernels in the first step, "
                f"{dev_ms / step_ms:.1%} of the step taken apart"
                if dev_ms else "busy share not measured (the WKV loops' "
                "launches are too many to trace)")
        print(f"[train23] {arch} at full width, {cfg.num_layers} layers, "
              f"{n_params} f32 parameters (drawn in {draw_s:.1f} s), B = "
              f"{B_}, S = {S_}, bf16 compute, sparse, "
              + (f"{n_steps} AdamW steps" if n_steps else
                 "forward and backward only (no AdamW state)")
              + f": a step {step_ms:.1f} ms (forward {parts_ms[0]:.1f}, "
              f"backward {parts_ms[1]:.1f}"
              + (f", optimizer {parts_ms[2]:.1f}" if n_steps else "")
              + f"; the first, traced, {first_ms:.1f}"
              + (f"; whole {', '.join(f'{x:.1f}' for x in whole_ms)}"
                 if whole_ms else "")
              + f"), {B_ * S_ / (step_ms / 1e3):.0f} tokens/s; peak "
              f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held before); "
              f"{busy}; launches {launched}; losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}")
        if on_dev:
            print(f"[train23] {arch}: by kernel (ms, launches): "
                  + "; ".join(f"{k[:60]} {t_:.2f} ({c})"
                              for k, t_, c in on_dev[:6]))
        del params, st, batch, loss, metrics, one, step_fn
        part(f"c {arch}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train23] seconds: {out['seconds']}")
    return out


def task_batch(task, source, device):
    """One batch of ``task`` at the bench's widths as (time-major model
    inputs, the loss's tensors): a bAbI-lite batch from the numpy
    generator ``source`` (one-hot stories (L, B, 27), answers); an Omniglot
    episode of 2 to OMNI_CLASSES classes from the torch generator
    ``source``, padded to OMNI_LABELS label channels (inputs (T, B, 24),
    class ids, mask)."""
    import numpy as np

    from repro_torch.data.babi import BABI_VOCAB, babi_lite_batch
    from repro_torch.data.omniglot import omniglot_episode

    if task == "babi":
        toks, ans, _ = babi_lite_batch(source, BABI_B, BABI_LEN)
        xs = torch.as_tensor(np.eye(len(BABI_VOCAB), dtype=np.float32)[toks])
        return (xs.transpose(0, 1).contiguous().to(device),
                (torch.as_tensor(ans).long().to(device),))
    classes = int(torch.randint(2, OMNI_CLASSES + 1, (1,), generator=source))
    inputs, ids, mask = omniglot_episode(OMNI_B, classes, OMNI_P, OMNI_DIM,
                                         generator=source, device=device)
    inputs = torch.nn.functional.pad(inputs, (0, OMNI_LABELS - classes))
    return inputs.transpose(0, 1).contiguous(), (ids, mask)


def task_loss(task, ys, batch):
    """The benches' losses: bAbI's softmax cross-entropy of the last step's
    logits against the answer; Omniglot's cross-entropy of every step's
    logits against its class, masked."""
    if task == "babi":
        (ans,) = batch
        return -torch.log_softmax(ys[-1], -1).gather(1, ans[:, None]).mean()
    ids, mask = batch
    lp = torch.log_softmax(ys.transpose(0, 1), -1)
    picked = lp.gather(-1, ids[..., None])[..., 0]
    return -(picked * mask).sum() / mask.sum()


def tasks_phase(dev, ops, ref, checker, zero_counts, counts):
    """Phase 19: the paper's memory models trained on bAbI-lite and one-shot
    Omniglot at the benches' widths (TASK_RUNS). Returns, by run, the
    launches of the checked step, the card-against-CPU errors, the ms a
    step and the losses."""
    import numpy as np
    from torch.utils import _pytree as pytree

    from repro_torch.core import training
    from repro_torch.core.types import ControllerConfig, MemoryConfig
    from repro_torch.data.babi import BABI_VOCAB
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import optimizers as opt

    V = len(BABI_VOCAB)

    def spec(kind, task):
        if task == "babi":
            mem, ctl = BABI_MEM, dict(input_size=V, hidden_size=BABI_HIDDEN,
                                      output_size=V)
        else:
            mem, ctl = OMNI_MEM, dict(input_size=OMNI_DIM + OMNI_LABELS,
                                      hidden_size=OMNI_HIDDEN,
                                      output_size=OMNI_LABELS)
        return training.ModelSpec(kind, MemoryConfig(**mem),
                                  ControllerConfig(**ctl))

    def grads_of(unroll, init_s, task, params, xs, batch):
        """(loss, the gradients) of the bench's loss at ``params``."""
        leaves, tree = pytree.tree_flatten(params)
        with torch.enable_grad():
            p = [x.detach().requires_grad_() for x in leaves]
            _, ys = unroll(pytree.tree_unflatten(p, tree),
                           init_s(xs.shape[1]), xs)
            loss = task_loss(task, ys, batch)
            g = torch.autograd.grad(loss, p, allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi for x, gi in
             zip(leaves, g)]
        return loss.detach(), pytree.tree_unflatten(g, tree)

    def update(params, opt_state, grads):
        with torch.no_grad():
            g, _ = opt.clip_by_global_norm(grads, TASK_CLIP)
            return opt.rmsprop_update(params, g, opt_state, lr=TASK_LR)

    out = {}
    for kind, task in TASK_RUNS:
        name = f"{kind}/{task}"
        sp = spec(kind, task)
        init_p, init_s_c, unroll_c = training.build_model(sp, device="cpu")
        _, init_s, unroll = training.build_model(sp, device=dev)
        p_cpu = init_p(torch.Generator().manual_seed(0))
        params = tree_map(lambda t: t.to(dev), p_cpu)
        opt_state = opt.rmsprop_init(params)

        # The checked step's batch: the first source seed of 0-63 whose
        # CPU reads hold no near-tie at K (a near-tie could read other
        # rows on the card).
        def source(seed):
            return (np.random.default_rng(seed) if task == "babi"
                    else torch.Generator().manual_seed(seed))

        def cpu_rollout(gen):
            xs_c, _ = task_batch(task, source(gen.initial_seed()), "cpu")
            with torch.no_grad():
                unroll_c(p_cpu, init_s_c(xs_c.shape[1]), xs_c)

        seed, _ = first_stable(ops, ref, cpu_rollout, f"the {name} batch")
        xs_c, b_c = task_batch(task, source(seed), "cpu")
        src = source(seed)
        xs, b = task_batch(task, src, dev)
        T = xs.shape[0]
        loss_c, g_c = grads_of(unroll_c, init_s_c, task, p_cpu, xs_c, b_c)
        zero_counts()
        with Intercept(ops, checker=checker):
            loss_g, g_g = grads_of(unroll, init_s, task, params, xs, b)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
        want = {"sam": {"fused_read_sweep": T, "sparse_write_update": T,
                        "lra_topn": T, "scatter_rows": SAM_BWD_SCATTERS * T},
                "sdnc": {"fused_read_sweep": T, "lra_topn": T,
                         "scatter_rows": (SDNC_STEP["scatter_rows"]
                                          + SDNC_BWD_SCATTERS) * T},
                "lstm": {}}[kind]
        require(launched == want, f"{name}: a train step of T = {T} "
                f"launched {launched}, expected {want}")
        require(abs(loss_g.item() - loss_c.item())
                <= TOL * abs(loss_c.item()), f"{name}: loss card "
                f"{loss_g.item()} against CPU {loss_c.item()}")
        grad_err = 0.0
        for path, (a, c) in zip(leaf_names(g_c), zip(
                pytree.tree_leaves(g_g), pytree.tree_leaves(g_c))):
            d = (a.cpu() - c).abs()
            grad_err = max(grad_err, d.max().item())
            require(bool((d <= GRAD_ATOL * torch.clamp(c.abs(), min=1.0))
                         .all()), f"{name}: gradient {path} card against "
                    f"CPU {d.max().item():.3g}, beyond 1e-5 of max(1, |g|)")
        params, opt_state = update(params, opt_state, g_g)
        losses, step_ms = [loss_g.item()], []
        for _ in range(TASK_STEPS - 1):
            xs, b = task_batch(task, src, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = grads_of(unroll, init_s, task, params, xs, b)
            params, opt_state = update(params, opt_state, g)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        require(all(np.isfinite(losses)), f"{name}: a loss is not finite: "
                f"{losses}")
        med = sorted(step_ms)[len(step_ms) // 2]
        out[name] = dict(launches=launched, T=T, seed=seed,
                         card_vs_cpu_grad_err=grad_err, ms_per_step=med,
                         ms_per_step_all=step_ms, losses=losses)
        print(f"[tasks] {name} (N = {sp.memory.num_slots}, W = "
              f"{sp.memory.word_size}, H = {sp.memory.num_heads}, K = "
              f"{sp.memory.k}, hidden {sp.controller.hidden_size}): step 1 "
              f"(T = {T}, batch seed {seed}) in lockstep, launches "
              f"{launched}; card against CPU: loss {loss_g.item():.6f}, "
              f"gradients {grad_err:.3g} (bar {GRAD_ATOL} of max(1, |g|)); "
              f"{TASK_STEPS} steps at {med:.2f} ms a step (median of "
              f"{len(step_ms)}, host clock), losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; {card_line()}")
        del params, opt_state, p_cpu
    torch.cuda.empty_cache()
    return out


def small_state(s, kind, gen):
    """A small model's start state for the card-against-CPU step: an SDNC
    state with a random memory (written rows then are not parallel, so the
    reads hold no near-tie), or a dense-DNC state with distinct usages
    (its allocation sort holds none), drawn on the CPU from ``gen``."""
    dev = s.memory.device
    if kind == "sdnc":
        mem = torch.randn(s.memory.shape, generator=gen)
        mem[:, -1] = 0.0
        s.memory.copy_(mem)
        return s
    B_, N_ = s.usage.shape
    return s._replace(
        memory=torch.randn(s.memory.shape, generator=gen).to(dev),
        usage=torch.rand((B_, N_), generator=gen).to(dev),
        write_w=(0.5 * torch.rand((B_, N_), generator=gen) / N_).to(dev))


def run() -> None:
    require(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from torch.utils import _pytree as pytree

        from repro_torch.core import sam, training
        from repro_torch.core import unroll as unroll_lib
        from repro_torch.core.cell import SAMCell
        from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                            MemoryConfig, tree_bytes)
        from repro_torch.data.tasks import copy_task
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.fused_read import fused_read_sweep
        from repro_torch.kernels.fused_read_candidates import (
            cand_plan, fused_read_candidates)
        from repro_torch.kernels.lsh_hash import hash_plan, lsh_hash, streams
        from repro_torch.kernels.scatter_rows import scatter_rows
        from repro_torch.kernels.sparse_write import sparse_write_update
        from repro_torch.kernels.topk_read import topk_read
        from repro_torch.kernels.usage_argmin import lra_topn, usage_argmin
        from repro_torch.optim import optimizers as opt
    except ImportError as e:
        raise SmokeFailure(f"the port's sources are missing: {e}") from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32,
            "f32 products must not use TF32")
    dev = torch.device("cuda")
    kernels = {"flash_attention": flash_attention,
               "fused_read_sweep": fused_read_sweep,
               "sparse_write_update": sparse_write_update,
               "lra_topn": lra_topn, "scatter_rows": scatter_rows,
               "lsh_hash": lsh_hash,
               "fused_read_candidates": fused_read_candidates,
               "usage_argmin": usage_argmin, "topk_read": topk_read}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0
            for dtype in getattr(fn, "launches_by_dtype", {}):
                fn.launches_by_dtype[dtype] = 0

    def counts():
        """Launches per kernel; a kernel's count covers all its row dtypes,
        and each bf16 or int8 instantiation also has its own (REPLACES)."""
        c = {name: fn.launches for name, fn in kernels.items()}
        for name, fn in kernels.items():
            for dtype, n in getattr(fn, "launches_by_dtype", {}).items():
                if dtype in SUFFIX:
                    c[name + SUFFIX[dtype]] = n
        return c

    # Each phase's seconds, for the report (`phase_seconds`).
    phase_s, clock = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # ---- 1. build ----
    t0 = time.perf_counter()
    try:
        info = _build.build_all()
    except RuntimeError as e:
        raise SmokeFailure(f"the kernels did not build: {e}") from e
    print(f"[build] {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(info)} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, v in info.items():
        for line in ptxas_summary(v["ptxas"]):
            print(f"[build] {name}: {line}")
    for lib in NO_SPILL:
        spills = [line for line in ptxas_summary(info[lib]["ptxas"])
                  if re.search(r"[1-9][0-9]* bytes spill", line)]
        require(not spills, f"{lib}.cu spills registers: {spills}")
    hmma = hmma_counts(info["flash_attention"]["path"])
    if isinstance(hmma, str):
        print(f"[build] flash_attention: HMMA not counted ({hmma}); the "
              f"-Xptxas -v lines above are all there is")
    else:
        require(len(hmma) == 14 and all(
                    (n > 0) == k.startswith("flash_bf16") for k, n in
                    hmma.items()),
                f"flash_attention's SASS: HMMA counts {hmma}: the bf16 "
                f"kernels must run on the tensor cores, the f32 ones not")
        print(f"[build] flash_attention: HMMA instructions in the SASS "
              f"(cuobjdump -sass): {hmma}")
    checker = Checker(ref)

    mark("1")
    # ---- 13, run first: the LM's train step at StarCoder2-7B's width.
    # Its parameters, gradients and moments (37 GB) and the step's
    # transients (~10 GB, ~19 GB more for the f64 checks) need the card
    # empty; the later phases keep some 20 GB of their inputs and states.
    train_res = lm_train_phase(dev, ops, ref, checker, zero_counts, counts)

    mark("13")
    # ---- 18, run second: Llama-4 Maverick (MoE) at full width, 2 of 48
    # layers. Its 69.4 GB of weights need the card as empty as phase 13.
    flush = torch.empty(32 << 20, device=dev)
    llama4 = llama4_phase(dev, ops, ref, checker, zero_counts, counts, flush)

    mark("18")
    # ---- 23, run third: the served LM families trained, at full width;
    # Hymba-1.5B's 28.5 GB of f32 weights and AdamW state and DeepSeek-V2's
    # 43 GB of f32 weights and gradients need the card as empty.
    family_train = family_train_phase(dev, ops, ref, zero_counts, counts)

    mark("23")
    cfg = sam.SAMConfig(MemoryConfig(num_slots=N, word_size=W, num_heads=H,
                                     k=K, delta=DELTA),
                        ControllerConfig(input_size=BITS + 2,
                                         hidden_size=HIDDEN,
                                         output_size=BITS))
    model = sam.SAM(cfg, seed=0, device=dev)
    inputs, targets, mask = copy_task(
        B, MAX_LEN, MAX_LEN, BITS, device=dev,
        generator=torch.Generator().manual_seed(1))
    xs = inputs.transpose(0, 1).contiguous()              # (T, B, D)
    ts, ms = targets.transpose(0, 1), mask.transpose(0, 1)
    require(xs.shape == (T, B, BITS + 2), f"xs has shape {tuple(xs.shape)}")

    # ---- 2. each kernel against its plain version, at full width ----
    with torch.inference_mode():
        with Intercept(ops, record=True) as rec:
            model(model.init_state(B), xs[:max(RECORD_STEPS)])
        for step in RECORD_STEPS:
            q, mem, beta, k, valid_n, _ = rec.records[("fused_read_sweep",
                                                       step)]
            checker.read(q, mem, beta, k, valid_n,
                         fused_read_sweep(q, mem, beta, k=k, valid_n=valid_n))
            la, n, valid_n = rec.records[("lra_topn", step)]
            checker.lra(la, n, valid_n, lra_topn(la, n, valid_n=valid_n))
            before = rec.records[("sparse_write_update", step)]
            m, l = before[0].clone(), before[1].clone()
            checker.write(before, sparse_write_update(m, l, *before[2:7],
                                                      delta=before[7]))
            if step == 1:
                require(mem.abs().max().item() > 0.0 and
                        before[0].abs().max().item() == 0.0,
                        "step 1 should write into an all-zero memory")
            torch.cuda.synchronize()
            print(f"[kernels] step {step}: read err "
                  f"{checker.err['fused_read_sweep']:.3g}, write err "
                  f"{checker.err['sparse_write_update']:.3g}, lra exact, "
                  f"near-ties {checker.near_ties}")

        # scatter_rows on the inputs of a real backward at step 21.
        step = max(RECORD_STEPS)
        wr = rec.records[("sparse_write_update", step)]
        q21, mem21, beta21, _, _, _ = rec.records[("fused_read_sweep", step)]
        widx21 = wr[2]                       # the rows step 21 wrote ...
        old21 = ref.gather_rows(wr[0], widx21)       # ... and their old rows
        ridx21 = fused_read_sweep(q21, mem21, beta21, k=K,
                                  valid_n=N)[2].reshape(B, H * K)
        cpu = torch.Generator().manual_seed(2)
        dup_idx = torch.randint(0, 3, (B, widx21.shape[1]), generator=cpu,
                                dtype=torch.int32).to(dev)

        def randn(*shape):
            return torch.randn(shape, generator=cpu).to(dev)

        scatter_cases = {
            "rollback of step 21 (set)": (mem21, widx21, old21, "set"),
            "read cotangent (add)": (torch.zeros_like(mem21), ridx21,
                                     randn(B, H * K, W), "add"),
            "duplicates (add)": (mem21, dup_idx, randn(B, widx21.shape[1], W),
                                 "add"),
            "duplicates (set)": (mem21, dup_idx, randn(B, widx21.shape[1], W),
                                 "set"),
        }
        for name, (buf, idx, rows, mode) in scatter_cases.items():
            out = scatter_rows(buf.clone(), idx, rows, mode=mode)
            checker.scatter(buf.clone(), idx, rows, mode, out)
            if name.startswith("rollback"):
                require(torch.equal(out, wr[0]), "the rollback of step 21 "
                        "does not give back the memory before its write")
            del out
        torch.cuda.synchronize()
        print(f"[kernels] scatter_rows on backward inputs at full width: "
              f"{', '.join(scatter_cases)}; both modes bit for bit; the "
              f"rollback gives back the memory before step {step}'s write "
              f"bit for bit")

        # The bf16 and int8 instantiations on the inputs of a real backward
        # of each: a rollout of 21 steps on bf16 and on int8 rows, whose
        # step-21 write is rolled back ('set'; int8: codes and scales
        # together), whose step-21 read takes the cotangent 'add' (bf16
        # rows; the int8 scales' cotangent is the f32 kernel at W = 1), and
        # a case heavy in duplicates.
        for dtype in ("bfloat16", "int8"):
            d_model = sam.SAM(sam.SAMConfig(dataclasses.replace(
                cfg.memory, mem_dtype=dtype), cfg.controller), seed=0,
                device=dev)
            with Intercept(ops, record=True) as rec_d:
                d_model(d_model.init_state(B), xs[:step])
            wr_d = rec_d.records[("sparse_write_update", step)]
            q_d, mem_d, beta_d, _, _, s_d = rec_d.records[("fused_read_sweep",
                                                           step)]
            widx_d, J_d = wr_d[2], wr_d[2].shape[1]
            old_d = ref.gather_rows(wr_d[0], widx_d)
            ridx_d = fused_read_sweep(q_d, mem_d, beta_d, k=K, valid_n=N,
                                      mem_scale=s_d)[2].reshape(B, H * K)
            dup_d = torch.randint(0, 3, (B, J_d), generator=cpu,
                                  dtype=torch.int32).to(dev)
            if dtype == "bfloat16":
                cases = {
                    "rollback of step 21 (set)": (mem_d, widx_d, old_d, "set"),
                    "read cotangent (add)": (
                        torch.zeros_like(mem_d), ridx_d,
                        randn(B, H * K, W).bfloat16(), "add"),
                    "duplicates (add)": (mem_d, dup_d,
                                         randn(B, J_d, W).bfloat16(), "add"),
                    "duplicates (set)": (mem_d, dup_d,
                                         randn(B, J_d, W).bfloat16(), "set")}
                for name, (buf, idx, rows, mode) in cases.items():
                    out = scatter_rows(buf.clone(), idx, rows, mode=mode)
                    checker.scatter(buf.clone(), idx, rows, mode, out)
                    if name.startswith("rollback"):
                        require(torch.equal(out, wr_d[0]), "the bf16 "
                                "rollback of step 21 does not give back the "
                                "memory before its write")
                    del out
            else:
                scale0 = wr_d[8]
                old_s = ref.gather_rows(scale0[..., None], widx_d)[..., 0]
                codes = torch.randint(-127, 128, (B, J_d, W), generator=cpu,
                                      dtype=torch.int8).to(dev)
                cases = {
                    "rollback of step 21 (set)": (widx_d, old_d, old_s),
                    "duplicates (set)": (dup_d, codes, randn(B, J_d).abs())}
                for name, (idx, rows, rows_s) in cases.items():
                    buf, sc = mem_d.clone(), s_d.clone()
                    scatter_rows(buf, idx, rows, mode="set", mem_scale=sc,
                                 rows_scale=rows_s)
                    checker.scatter(mem_d.clone(), idx, rows, "set", buf,
                                    (s_d.clone(), rows_s, sc))
                    if name.startswith("rollback"):
                        require(torch.equal(buf, wr_d[0])
                                and torch.equal(sc, scale0), "the int8 "
                                "rollback of step 21 does not give back the "
                                "codes and scales before its write")
                    del buf, sc
                # The scales' cotangent, (B, N+1) f32 as a (B, N+1, 1) view:
                # the write's 'set' of the old scales' gradient at the
                # written rows, the read's 'add' at the read rows.
                ct = randn(B, N + 1)
                for name, idx, mode in (("scale cotangent (set)", widx_d,
                                         "set"),
                                        ("scale cotangent (add)", ridx_d,
                                         "add"),
                                        ("scale cotangent, duplicates (add)",
                                         dup_d, "add")):
                    rows = randn(B, idx.shape[1], 1)
                    out = scatter_rows(ct.clone()[..., None], idx, rows,
                                       mode=mode)
                    checker.scatter(ct.clone()[..., None], idx, rows, mode,
                                    out)
                    cases[name] = None
            torch.cuda.synchronize()
            print(f"[kernels] {kernel_name('scatter_rows', mem_d)} on a "
                  f"{dtype} backward's inputs at full width: "
                  f"{', '.join(cases)}; bit for bit against the plain "
                  f"version; the rollback gives back the "
                  f"{'codes and scales' if dtype == 'int8' else 'rows'} "
                  f"before step {step}'s write bit for bit")
            del d_model, rec_d, wr_d, q_d, mem_d, beta_d, s_d, old_d, cases
            torch.cuda.empty_cache()

    mark("2")
    # ---- 3. the forward path, in lockstep ----
    zero_counts()
    state = model.init_state(B)
    with torch.inference_mode(), Intercept(ops, checker=checker):
        state, ys = model(state, xs)
    torch.cuda.synchronize()
    fwd_launches = counts()
    print(f"[forward] launches {fwd_launches} over T={T} steps; near-ties "
          f"{checker.near_ties}")
    for name in FORWARD:
        require(fwd_launches[name] == T, f"{name} launched "
                f"{fwd_launches[name]} times, expected {T}")
    require(fwd_launches["lsh_hash"] == fwd_launches["fused_read_candidates"]
            == 0, "the exact-read rollout launched an LSH kernel")
    require(ys.shape == (T, B, BITS) and torch.isfinite(ys).all().item(),
            "outputs are not finite values of shape (T, B, bits)")
    require(torch.isfinite(state.memory).all().item(), "memory not finite")
    require(state.memory[:, N].eq(0).all().item()
            and state.last_access[:, N].eq(LA_SCRATCH).all().item(),
            "the scratch row was touched")
    require(int(state.step) == T, "step counter")
    require(fwd_launches["topk_read"] == 0, "the single-device rollout "
            "launched topk_read")
    # What phase 10 holds the sharded rollout against, kept on the host.
    mesh_ref = {"ys": ys.cpu(), "memory": state.memory[:, :N].cpu(),
                "la": state.last_access.cpu(),
                "read_idx": state.read.indices.cpu(),
                "read_words": state.read.words.cpu()}
    # The same cell on a small input: kernels on the card vs plain on the CPU.
    small = sam.SAMConfig(MemoryConfig(num_slots=1000, word_size=W,
                                       num_heads=H, k=K, delta=DELTA),
                          cfg.controller)
    small_cpu = sam.SAM(small, seed=3, device="cpu")
    small_gpu = sam.SAM(small, seed=3, device=dev)
    _, y_cpu = small_cpu(small_cpu.init_state(2), xs[:12, :2].cpu())
    _, y_gpu = small_gpu(small_gpu.init_state(2), xs[:12, :2])
    small_err = (y_gpu.cpu() - y_cpu).abs().max().item()
    require(small_err <= TOL, f"small rollout differs from the CPU ({small_err:.3g})")
    print(f"[forward] small rollout (N=1000, T=12) card vs CPU max err {small_err:.3g}")

    mark("3")
    # ---- 4. training ----
    cell = SAMCell(cfg)

    def flat_params(m):
        """The module's weights (and an LSH cell's planes), detached and
        flattened: (leaves, spec)."""
        return pytree.tree_flatten(pytree.tree_map(lambda v: v.detach(),
                                                   m.params()))

    flat_p, p_spec = flat_params(model)

    def start_state(c=cell, src=None):
        """A fresh state of cell ``c`` holding what a forward rollout left
        (``src``, by default the exact one's): a memory with 42 steps of
        writes, its usage table, read, controller and LSH index."""
        src = state if src is None else src
        s = c.init_state(B, device=dev)
        s.memory.copy_(src.memory)
        s.last_access.copy_(src.last_access)
        if src.mem_scale is not None:
            s.mem_scale.copy_(src.mem_scale)
        return s._replace(read=type(src.read)(*(t.clone() for t in src.read)),
                          ctrl=type(src.ctrl)(*(t.clone() for t in src.ctrl)),
                          step=src.step.clone(), ann=src.ann)

    def fwd_bwd(mode, chunk, lockstep, c=cell, src=None, flat=None):
        """One forward and backward of cell ``c`` through `unroll` from
        `start_state(c, src)` with the weights ``flat`` ((leaves, spec),
        by default the exact model's). Returns (loss, grads (a zero one
        for a leaf the loss does not reach), fwd counts, bwd counts,
        memory (and int8 scales) restored, residual accounting)."""
        s0 = start_state(c, src)
        m0 = s0.memory.clone()
        sc0 = None if s0.mem_scale is None else s0.mem_scale.clone()
        f_leaves, f_spec = (flat_p, p_spec) if flat is None else flat
        leaves = [p.clone().requires_grad_() for p in f_leaves]
        params = pytree.tree_unflatten(leaves, f_spec)
        acct = unroll_lib.residual_accounting(c, params, s0, xs, mode=mode,
                                              chunk=chunk)
        with Intercept(ops, checker=checker if lockstep else None):
            zero_counts()
            _, ys_t = unroll_lib.unroll(c, params, s0, xs, mode=mode,
                                        chunk=chunk)
            loss = training.bits_loss(ys_t, ts, ms)
            torch.cuda.synchronize()
            fwd = counts()
            zero_counts()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            torch.cuda.synchronize()
            bwd = counts()
        restored = torch.equal(s0.memory, m0) and (
            sc0 is None or torch.equal(s0.mem_scale, sc0))
        return loss.detach(), grads, fwd, bwd, restored, acct

    def checked_since(before):
        return {m: c - before[m] for m, c in checker.scatter_calls.items()}

    scatter_checked = dict(checker.scatter_calls)
    loss_s, g_sparse, fwd, bwd, restored, acct = fwd_bwd("sparse", None, True)
    print(f"[train] sparse forward launches {fwd}; backward launches {bwd}; "
          f"scatter_rows calls checked in lockstep "
          f"{checked_since(scatter_checked)}, each bit for bit")
    for name in FORWARD:
        require(fwd[name] == T, f"forward: {name} launched {fwd[name]} times")
        require(bwd[name] == 0, f"the backward launched {name} {bwd[name]} "
                f"times: it must launch no O(N) kernel")
    require(fwd["scatter_rows"] == 0 and bwd["scatter_rows"] >= T,
            f"scatter_rows launched {fwd['scatter_rows']} times in the "
            f"forward and {bwd['scatter_rows']} in the backward")
    require(restored, "the sparse backward did not restore the memory")
    require(torch.isfinite(loss_s).item(), "the loss is not finite")
    require(all(torch.isfinite(g).all().item() for g in g_sparse),
            "a gradient leaf is not finite")
    print(f"[train] sparse backward: memory restored bit for bit; loss "
          f"{loss_s.item():.6f}; {len(g_sparse)} gradient leaves finite")

    chunk = unroll_lib.suggest_chunk(cell, None, start_state(), xs)
    loss_c, g_chunk, fwd_c, bwd_c, restored_c, acct_c = fwd_bwd(
        "chunked", chunk, False)
    chunk_err = max((a - b).abs().max().item()
                    for a, b in zip(g_chunk, g_sparse))
    require(restored_c, "the chunked backward did not restore the memory")
    require(all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in zip(g_chunk, g_sparse)),
            f"chunked gradients differ from sparse ones (max err {chunk_err:.3g})")
    require(abs(loss_c.item() - loss_s.item()) <= TOL * abs(loss_s.item()),
            "chunked loss differs from the sparse loss")
    print(f"[train] chunked C={chunk}: gradients max err {chunk_err:.3g} "
          f"against sparse; backward launches {bwd_c} (the segment's "
          f"forward is recomputed once); memory restored bit for bit")

    def main_step(kind, flat, memory=None):
        """The main path of ``kind`` (on ``memory``'s rows, by default the
        exact f32 cell's): one `make_task_train_step` step, in lockstep,
        with every counter set to 0 just before it and read just after,
        then three more RMSProp steps; nothing may turn NaN. Returns
        (step_fn, params, opt_state, launches of the first step)."""
        memory = cfg.memory if memory is None else memory
        _, _, fn = training.make_task_train_step(
            training.ModelSpec(kind, memory, cfg.controller), LR,
            device=dev)
        p0 = pytree.tree_unflatten([p.clone() for p in flat[0]], flat[1])
        o0 = opt.rmsprop_init(p0)
        before = dict(checker.scatter_calls)
        zero_counts()
        with Intercept(ops, checker=checker):
            p1, o1, loss, err = fn(p0, o0, inputs, targets, mask)
        torch.cuda.synchronize()
        launched = counts()
        print(f"[train] main path ({kind}, {memory.mem_dtype} rows): one "
              f"make_task_train_step step, "
              f"launches {launched}; loss {loss.item():.6f}, bit error "
              f"{err.item():.4f}; scatter_rows calls checked in lockstep "
              f"{checked_since(before)}")
        if "lsh_planes" in p0:
            require(torch.equal(p1["lsh_planes"], p0["lsh_planes"]),
                    "an RMSProp step moved the fixed LSH planes")
        losses = [loss.item()]
        for _ in range(3):
            p1, o1, loss, _ = fn(p1, o1, inputs, targets, mask)
            losses.append(loss.item())
            require(torch.isfinite(loss).item() and all(
                torch.isfinite(p).all().item()
                for p in pytree.tree_leaves((p1, o1))),
                f"a {kind} RMSProp step produced a NaN or an infinity")
        print(f"[train] four {kind} RMSProp steps, losses {losses}: all "
              f"finite")
        return fn, p1, o1, launched

    step_fn, params, opt_state, launches = main_step("sam", (flat_p, p_spec))
    for name in FORWARD:
        require(launches[name] == T, f"train step: {name} launched "
                f"{launches[name]} times, expected {T} (forward only)")
    require(launches["scatter_rows"] >= T, "train step: scatter_rows "
            f"launched {launches['scatter_rows']} times")
    require(launches["lsh_hash"] == launches["fused_read_candidates"] == 0,
            "the exact-read train step launched an LSH kernel")

    def small_train(kind, dtype="float32", bar=None):
        """A small training step (N = 1000, T = 12) of ``kind`` on rows of
        ``dtype``: kernels on the card against the plain versions on the
        CPU; gradients within atol = rtol = GRAD_ATOL, or within ``bar``
        of max(1, |g|) where given. Returns the largest gradient error."""
        small_spec = training.ModelSpec(kind, dataclasses.replace(
            small.memory, mem_dtype=dtype), small.controller)
        batch = copy_task(2, 5, 5, BITS, device="cpu",
                          generator=torch.Generator().manual_seed(4))
        results = {}
        for device in ("cpu", dev):
            s_init_p, s_init_s, s_unroll = training.build_model(small_spec,
                                                                device=device)
            leaves, spec_s = pytree.tree_flatten(
                s_init_p(torch.Generator().manual_seed(5)))
            leaves = [p.requires_grad_() for p in leaves]
            b_in, b_tgt, b_mask = (t.to(device) for t in batch)
            _, ys_small = s_unroll(pytree.tree_unflatten(leaves, spec_s),
                                   s_init_s(2), b_in.transpose(0, 1))
            l_small = training.bits_loss(ys_small, b_tgt.transpose(0, 1),
                                         b_mask.transpose(0, 1))
            grads = torch.autograd.grad(l_small, leaves, allow_unused=True)
            results[str(device)] = (l_small.item(), [
                torch.zeros_like(p).cpu() if g is None else g.cpu()
                for p, g in zip(leaves, grads)])
        (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(dev)]
        grad_err = max((a - b).abs().max().item()
                       for a, b in zip(g_gpu, g_cpu))
        require(abs(l_gpu - l_cpu) <= TOL * abs(l_cpu),
                f"small {kind} train step: loss {l_gpu} on the card, "
                f"{l_cpu} on the CPU")
        if bar is None:
            ok = all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                     for a, b in zip(g_gpu, g_cpu))
        else:
            grad_err = max(rel_err(a, b) for a, b in zip(g_gpu, g_cpu))
            ok = grad_err <= bar
        require(ok, f"small {kind} train step ({dtype} rows): gradients "
                f"differ (max err {grad_err:.3g})")
        print(f"[train] small {kind} step ({dtype} rows, N=1000, T=12) card "
              f"vs CPU: loss "
              f"rel err {abs(l_gpu - l_cpu) / abs(l_cpu):.3g}, gradients max "
              f"err {grad_err:.3g}")
        return grad_err

    small_grad_err = small_train("sam")

    mark("4")
    # ---- 5. the LSH read (kind sam_ann) ----
    lsh_cfg = sam.SAMConfig(dataclasses.replace(cfg.memory, **LSH),
                            cfg.controller)
    lsh_model = sam.SAM(lsh_cfg, seed=0, device=dev)
    planes = lsh_model.lsh_planes
    C = lsh_cfg.memory.candidates + H * (K + 1)
    # The candidate read holds all C rows in one tile, for every row dtype,
    # so its sum reads no row from device memory a second time.
    for itemsize in (4, 2, 1):
        plan = cand_plan(C, W, 16 // itemsize, K)
        require(plan.tile == C, f"the candidate read's plan {plan} stages "
                                f"C={C} rows in more than one tile")
    # The hash streams its tiles through persistent blocks for an index
    # rebuild (all B·N rows), and gives the step's hashes (the queries,
    # R = B·H, and the written rows, R = B·J) a block per 8-row tile.
    sms, n_ins = _build.sm_count(dev), B * H * (K + 1)
    for R_ in (B * H, n_ins, B * N):
        plan = hash_plan(streams(R_, sms), W)
        require(plan.streamed == (R_ == B * N),
                f"the hash's plan at R={R_} is {plan}")
    print(f"[lsh] the hash's plans: R = {B * H} and {n_ins}: "
          f"{hash_plan(False, W)}, {hash_plan(False, W).blocks(n_ins, sms)} "
          f"blocks at R = {n_ins}; R = {B * N}: {hash_plan(True, W)}, "
          f"{hash_plan(True, W).blocks(B * N, sms)} blocks")
    # (a) the two new kernels on a real LSH rollout's inputs.
    with torch.inference_mode():
        with Intercept(ops, record=True) as rec_l:
            lsh_model(lsh_model.init_state(B), xs[:max(RECORD_STEPS)])
        for step in RECORD_STEPS:
            q, mem, beta, k, cand, _ = rec_l.records[("fused_read_candidates",
                                                      step)]
            require(cand.shape == (B, H, C), f"candidates {tuple(cand.shape)}")
            checker.read_cand(q, mem, beta, k, cand, fused_read_candidates(
                q, mem, beta, cand, k=k))
            for nth in (0, 1):                     # the query, the written rows
                x, pl = rec_l.records[("lsh_hash", step, nth)]
                x2 = x.reshape(-1, W).contiguous()
                checker.hash(x2, pl, lsh_hash(x2, pl))
            valid = int((cand >= 0).sum().item())
            if step == 1:
                require(bool((cand[..., :lsh_cfg.memory.candidates] < 0).all()),
                        "the first step's index should be empty")
            torch.cuda.synchronize()
            n_query = rec_l.records[("lsh_hash", step, 0)][0].numel() // W
            print(f"[lsh] step {step}: candidates (B, H, C) = "
                  f"{tuple(cand.shape)}, {valid} valid after dedup; "
                  f"candidate read err "
                  f"{checker.err['fused_read_candidates']:.3g}; hash of "
                  f"{n_query} query and {x2.shape[0]} written rows; "
                  f"near-ties {checker.near_ties}, near-zero bits "
                  f"{checker.near_zero_bits}")
        # The hash on every row of the exact rollout's final memory.
        bulk_x = state.memory[:, :N].reshape(-1, W).contiguous()
        checker.hash(bulk_x, planes, lsh_hash(bulk_x, planes))
        torch.cuda.synchronize()
        print(f"[lsh] hash of all {bulk_x.shape[0]} rows of the exact "
              f"rollout's memory: near-zero bits {checker.near_zero_bits}")

    # (b) the LSH forward rollout, in lockstep.
    zero_counts()
    with torch.inference_mode(), Intercept(ops, checker=checker):
        lsh_state, lsh_ys = lsh_model(lsh_model.init_state(B), xs)
    torch.cuda.synchronize()
    lsh_fwd_launches = counts()
    print(f"[lsh] forward launches {lsh_fwd_launches} over T={T} steps; "
          f"near-ties {checker.near_ties}, near-zero bits "
          f"{checker.near_zero_bits}")
    for name, per in LSH_STEP.items():
        require(lsh_fwd_launches[name] == per * T, f"LSH rollout: {name} "
                f"launched {lsh_fwd_launches[name]} times, expected {per * T}")
    require(lsh_ys.shape == (T, B, BITS) and torch.isfinite(lsh_ys).all().item(),
            "LSH outputs are not finite values of shape (T, B, bits)")
    require(torch.isfinite(lsh_state.memory).all().item()
            and lsh_state.memory[:, N].eq(0).all().item(),
            "LSH memory not finite, or its scratch row touched")
    d = lsh_cfg.memory.lsh_bucket_size
    filled = int((lsh_state.ann.buckets >= 0).sum().item())
    require(bool(((lsh_state.ann.buckets >= -1)
                  & (lsh_state.ann.buckets < N)).all())
            and bool(((lsh_state.ann.cursor >= 0)
                      & (lsh_state.ann.cursor < d)).all()),
            "the LSH index holds an id or a cursor out of range")
    print(f"[lsh] index after T={T} steps: {filled} of "
          f"{lsh_state.ann.buckets.numel()} bucket slots filled "
          f"({T * H * (K + 1)} inserts per table and batch row)")
    # The same LSH cell on a small input: the card against the CPU.
    small_lsh = sam.SAMConfig(dataclasses.replace(small.memory, **LSH),
                              cfg.controller)
    m_cpu = sam.SAM(small_lsh, seed=3, device="cpu")
    m_gpu = sam.SAM(small_lsh, seed=3, device=dev)
    s_cpu, y_cpu = m_cpu(m_cpu.init_state(2), xs[:12, :2].cpu())
    s_gpu, y_gpu = m_gpu(m_gpu.init_state(2), xs[:12, :2])
    small_lsh_err = (y_gpu.cpu() - y_cpu).abs().max().item()
    require(small_lsh_err <= TOL and torch.equal(s_gpu.ann.buckets.cpu(),
                                                 s_cpu.ann.buckets)
            and torch.equal(s_gpu.ann.cursor.cpu(), s_cpu.ann.cursor),
            f"small LSH rollout differs from the CPU ({small_lsh_err:.3g})")
    print(f"[lsh] small rollout (N=1000, T=12) card vs CPU max err "
          f"{small_lsh_err:.3g}; index bit for bit")

    # (c) training sam_ann.
    lsh_cell = SAMCell(lsh_cfg)
    flat_l = flat_params(lsh_model)
    i_planes = [i for i, p in enumerate(flat_l[0]) if p.dim() == 3]
    scatter_checked = dict(checker.scatter_calls)
    loss_ls, g_ls, fwd_l, bwd_l, restored_l, acct_l = fwd_bwd(
        "sparse", None, True, lsh_cell, lsh_state, flat_l)
    print(f"[lsh-train] sparse forward launches {fwd_l}; backward launches "
          f"{bwd_l}; scatter_rows calls checked in lockstep "
          f"{checked_since(scatter_checked)}, each bit for bit")
    for name, per in LSH_STEP.items():
        require(fwd_l[name] == per * T, f"sam_ann forward: {name} launched "
                f"{fwd_l[name]} times, expected {per * T}")
        require(bwd_l[name] == 0, f"the sam_ann backward launched {name} "
                f"{bwd_l[name]} times")
    require(fwd_l["scatter_rows"] == 0 and bwd_l["scatter_rows"] >= T,
            f"sam_ann: scatter_rows launched {fwd_l['scatter_rows']} times in "
            f"the forward and {bwd_l['scatter_rows']} in the backward")
    require(restored_l, "the sam_ann backward did not restore the memory")
    require(len(i_planes) == 1 and g_ls[i_planes[0]].eq(0).all().item(),
            "the LSH planes got a gradient")
    require(torch.isfinite(loss_ls).item() and all(
        torch.isfinite(g).all().item() for g in g_ls),
        "a sam_ann loss or gradient leaf is not finite")
    print(f"[lsh-train] sparse backward: memory restored bit for bit; loss "
          f"{loss_ls.item():.6f}; planes' gradient 0")
    # Chunked with several segments: each must start from its own index.
    chunk_l = 5
    loss_lc, g_lc, _, bwd_lc, restored_lc, acct_lc = fwd_bwd(
        "chunked", chunk_l, False, lsh_cell, lsh_state, flat_l)
    lsh_chunk_err = max((a - b).abs().max().item()
                        for a, b in zip(g_lc, g_ls))
    require(restored_lc, "the sam_ann chunked backward did not restore the "
            "memory")
    require(all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in zip(g_lc, g_ls)),
            f"sam_ann chunked gradients differ from sparse ones (max err "
            f"{lsh_chunk_err:.3g})")
    print(f"[lsh-train] chunked C={chunk_l}: gradients max err "
          f"{lsh_chunk_err:.3g} against sparse; backward launches {bwd_lc}")
    step_fn_l, params_l, opt_l, launches_l = main_step("sam_ann", flat_l)
    for name, per in LSH_STEP.items():
        require(launches_l[name] == per * T, f"sam_ann train step: {name} "
                f"launched {launches_l[name]} times, expected {per * T}")
    require(launches_l["scatter_rows"] >= T, "sam_ann train step: "
            f"scatter_rows launched {launches_l['scatter_rows']} times")
    small_lsh_grad_err = small_train("sam_ann")

    mark("5")
    # ---- 6. timing, on the step-21 inputs ----
    step = max(RECORD_STEPS)
    q, mem, beta, k, valid_n, _ = rec.records[("fused_read_sweep", step)]
    la, n, _ = rec.records[("lra_topn", step)]
    m_t, l_t = wr[0].clone(), wr[1].clone()
    neg_la = (-la[:, :N]).contiguous()
    widx = wr[2]
    uniq = unique_rows(widx)
    J = widx.shape[1]
    # scatter_rows: the rollback's 'set' of step 21 and the read
    # cotangent's 'add', on buffers of the full (B, N+1, W) size.
    buf_set, buf_add = mem21.clone(), torch.zeros_like(mem21)
    g_add = scatter_cases["read cotangent (add)"][2]
    uniq_add = unique_rows(ridx21)
    b_set = torch.arange(B, device=dev)[:, None].expand(B, J)
    b_add = torch.arange(B, device=dev)[:, None].expand(B, H * K)
    widx_l, ridx_l = widx.long(), ridx21.long()
    sweep_bytes = 4 * (B * N * W + 2 * B * H * W + B * H + 2 * B * H * K)
    rows = {
        "fused_read_sweep": dict(
            ms=time_ms(lambda: fused_read_sweep(q, mem, beta, k=k,
                                                valid_n=valid_n), 20, flush),
            plain_ms=time_ms(lambda: ref.fused_read_ref(q, mem, beta, k,
                                                        valid_n=valid_n),
                             5, flush),
            library_ms=None,
            bound=bound(sweep_bytes, B * N * W * (2 * H + 2)),
            rate=(sweep_bytes, B * N)),
        "sparse_write_update": dict(
            ms=time_ms(lambda: sparse_write_update(m_t, l_t, *wr[2:7],
                                                   delta=wr[7]), 50, flush),
            plain_ms=time_ms(lambda: ref.sparse_write_update_ref(
                m_t, l_t, *wr[2:7], wr[7]), 20, flush),
            library_ms=None,
            bound=bound(4 * (2 * uniq * W + 2 * uniq + 2 * B * J + B * H * W
                             + B * H + B), 2 * B * J * W)),
        "lra_topn": dict(
            ms=time_ms(lambda: lra_topn(la, n, valid_n=N), 50, flush),
            plain_ms=time_ms(lambda: ref.lra_topn_ref(la[:, :N], n), 20, flush),
            library_ms=time_ms(lambda: torch.topk(neg_la, n, dim=-1), 50, flush),
            bound=bound(4 * (B * N + B * n), B * N)),
        "scatter_rows": dict(
            ms=time_ms(lambda: scatter_rows(buf_set, widx, old21, mode="set"),
                       50, flush),
            plain_ms=time_ms(lambda: ref.scatter_rows_ref(buf_set, widx, old21,
                                                          "set"), 20, flush),
            library_ms=time_ms(lambda: buf_set.index_put_((b_set, widx_l),
                                                          old21), 50, flush),
            # 'set' reads only the row that wins each target (its last
            # column) and writes it once; every column's index is read.
            bound=bound(4 * (B * J + 2 * uniq * W), 0)),
    }
    # lra_topn on a rank's block of the sharded memory (phase 10): rank 0's
    # 2^18 entries of step 21's table and the scratch entry.
    blk_n = N // MESH_S
    la_blk = torch.cat([la[:, :blk_n], la[:, N:]], 1).contiguous()
    lra_block = dict(
        ms=time_ms(lambda: lra_topn(la_blk, n, valid_n=blk_n), 50, flush),
        plain_ms=time_ms(lambda: ref.lra_topn_ref(la_blk[:, :blk_n], n), 20,
                         flush),
        library_ms=time_ms(lambda: torch.topk(neg_la[:, :blk_n], n, dim=-1),
                           50, flush),
        bound=bound(4 * (B * blk_n + B * n), B * blk_n))
    # The floor under every single-launch time: an empty kernel in the
    # same timer.
    empty_ms = time_ms(lambda: torch.cuda._sleep(0), 50, flush)
    # A latency-bound kernel's time moves with where its buffers lie: the
    # write on step 21's inputs, its memory and usage table cloned after
    # pads of 0 to 3 MB.
    write_placed = []
    for pad_mb in range(4):
        pad = torch.empty((pad_mb << 18) + 256, device=dev)
        m_p, l_p = wr[0].clone(), wr[1].clone()
        write_placed.append(time_ms(lambda: sparse_write_update(
            m_p, l_p, *wr[2:7], delta=wr[7]), 50, flush))
        del pad, m_p, l_p
    # ... and with every row it touches folded into the first 2 MB of each
    # batch row's memory (row r -> r mod 2 MB / (4 W); the usage cells then
    # lie in 64 KB), the rows it writes and the work the same up to the
    # collisions the folding makes: whether the spread of its rows over
    # the gigabyte, and not its own trips, sets its time. Likewise the
    # candidate read, its candidates folded and deduped again.
    fold = (2 << 20) // (4 * W)
    m_f, l_f = wr[0].clone(), wr[1].clone()
    fw_idx, fw_lra = wr[2] % fold, wr[5] % fold
    write_folded = time_ms(lambda: sparse_write_update(
        m_f, l_f, fw_idx, wr[3], wr[4], fw_lra, wr[6], delta=wr[7]), 50,
        flush)
    del m_f, l_f
    scatter_add = dict(
        ms=time_ms(lambda: scatter_rows(buf_add, ridx21, g_add, mode="add"),
                   50, flush),
        plain_ms=time_ms(lambda: ref.scatter_rows_ref(buf_add, ridx21, g_add,
                                                      "add"), 20, flush),
        library_ms=time_ms(lambda: buf_add.index_put_(
            (b_add, ridx_l), g_add, accumulate=True), 50, flush),
        bound=bound(4 * (B * H * K + B * H * K * W + 2 * uniq_add * W),
                    B * H * K * W))
    # The new kernels at the LSH step-21 inputs: the candidate read, the
    # hash of the written rows (R = B·J) and of the queries (R = B·H), and
    # the hash of all B·N rows of a memory (an index rebuild).
    q_c, mem_c, beta_c, _, cand_c, _ = rec_l.records[
        ("fused_read_candidates", step)]
    x_q = rec_l.records[("lsh_hash", step, 0)][0].reshape(-1, W).contiguous()
    x_w = rec_l.records[("lsh_hash", step, 1)][0].reshape(-1, W).contiguous()
    TB = lsh_cfg.memory.lsh_tables * lsh_cfg.memory.lsh_bits

    def hash_row(x):
        R = x.shape[0]
        return dict(
            ms=time_ms(lambda: lsh_hash(x, planes), 50 if R < N else 20,
                       flush),
            plain_ms=time_ms(lambda: ref.lsh_hash_ref(x, planes),
                             20 if R < N else 5, flush),
            library_ms=None,
            bound=bound(4 * (R * W + TB * W + R * TB // lsh_cfg.memory.lsh_bits),
                        2 * R * W * TB))

    rows["lsh_hash"] = hash_row(x_w)
    hash_query, hash_bulk = hash_row(x_q), hash_row(bulk_x)
    # The candidate read needs each valid candidate's row once per batch
    # row (two heads may share one), the queries, betas and ids, and writes
    # the read, weights and indices; it scores each valid candidate (dot
    # and norm, 4W) and sums K rows (2KW) per head.
    cand_f = ref.dedup(torch.where(cand_c >= 0, cand_c % fold,
                                   torch.full_like(cand_c, -1)))
    cand_folded = time_ms(lambda: fused_read_candidates(
        q_c, mem_c, beta_c, cand_f, k=K), 50, flush)
    valid_c = cand_c >= 0
    uniq_c = len({(b, r) for b, row in enumerate(cand_c.reshape(B, -1).tolist())
                  for r in row if r >= 0})
    rows["fused_read_candidates"] = dict(
        ms=time_ms(lambda: fused_read_candidates(q_c, mem_c, beta_c, cand_c,
                                                 k=K), 50, flush),
        plain_ms=time_ms(lambda: ref.fused_read_candidates_ref(
            q_c, mem_c, beta_c, K, cand_c), 20, flush),
        library_ms=None,
        bound=bound(4 * (uniq_c * W + B * H * (W + 1 + C)
                         + B * H * (W + 2 * K)),
                    int(valid_c.sum().item()) * 4 * W + B * H * 2 * K * W))

    def rollout_ms(m):
        """Median host-clock ms per step of five synchronised T-step
        rollouts, each from a fresh state, and the peak memory above what
        the script already holds."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        times = []
        for _ in range(5):
            fresh = m.init_state(B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                m(fresh, xs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / T)
            del fresh
        return (sorted(times)[len(times) // 2], times,
                torch.cuda.max_memory_allocated() - held)

    def rollout_device(m, by_kernel=None):
        """Device ms and kernel launches per step of one traced rollout;
        the (kernel, ms, launches) per step, largest first, go into
        ``by_kernel`` if given."""
        with torch.inference_mode():
            d_ms, on_dev = device_time(lambda: m(m.init_state(B), xs))
        if by_kernel is not None:
            by_kernel += [(k_, t_ / T, c_ / T) for k_, t_, c_ in on_dev]
        return d_ms / T, sum(r[2] for r in on_dev) / T

    def train_timing(fn, p, o, c, flat, src):
        """The train step (five, host clock), then its forward and its
        backward apart, and its peak memory above what is held."""
        step_med, step_all = host_ms(lambda _: fn(p, o, inputs, targets, mask))
        leaves = [x.clone().requires_grad_() for x in flat[0]]
        p_train = pytree.tree_unflatten(leaves, flat[1])
        out = {}

        def forward(s0):
            out["loss"] = training.bits_loss(
                unroll_lib.unroll(c, p_train, s0, xs)[1], ts, ms)

        def setup_backward():
            s0 = start_state(c, src)
            forward(s0)
            return s0

        f_med, f_all = host_ms(forward, setup=lambda: start_state(c, src))
        b_med, b_all = host_ms(
            lambda _: torch.autograd.grad(out["loss"], leaves,
                                          allow_unused=True),
            setup=setup_backward)
        del out["loss"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn(p, o, inputs, targets, mask)
        torch.cuda.synchronize()
        return dict(ms=step_med, all=step_all, fwd_ms=f_med, fwd_all=f_all,
                    bwd_ms=b_med, bwd_all=b_all,
                    peak=torch.cuda.max_memory_allocated() - held)

    step_ms, rollouts, peak = rollout_ms(model)
    lsh_step_ms, lsh_rollouts, lsh_peak = rollout_ms(lsh_model)
    step_kernels = []
    (dev_step_ms, dev_step_n), (lsh_dev_step_ms, lsh_dev_step_n) = (
        rollout_device(model, step_kernels), rollout_device(lsh_model))
    tr = train_timing(step_fn, params, opt_state, cell, (flat_p, p_spec),
                      state)
    tr_l = train_timing(step_fn_l, params_l, opt_l, lsh_cell, flat_l,
                        lsh_state)
    train_ms, fwd_ms, bwd_ms, train_peak = (tr["ms"], tr["fwd_ms"],
                                            tr["bwd_ms"], tr["peak"])
    mem_ct_bytes = B * (N + 1) * W * 4
    # Where the train step's time goes: the device time of its kernels in
    # one step traced by torch.profiler, against the step's wall time.
    device_ms, on_device = device_time(
        lambda: step_fn(params, opt_state, inputs, targets, mask))
    lsh_device_ms, lsh_on_device = device_time(
        lambda: step_fn_l(params_l, opt_l, inputs, targets, mask))
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {name}: {r['ms']:.4f} ms (bound {r['bound'][0]:.6f} ms "
              f"by {r['bound'][1]}{sweep_rate(r)}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}")
    print(f"[time] scatter_rows 'set' above is the rollback of step {step} "
          f"(J={J}, {uniq} unique rows; library = index_put_); 'add' (read "
          f"cotangent, {H * K} columns, {uniq_add} unique rows): "
          f"{scatter_add['ms']:.4f} ms (bound {scatter_add['bound'][0]:.6f} ms "
          f"by {scatter_add['bound'][1]}), plain {scatter_add['plain_ms']:.4f} "
          f"ms, library index_put_(accumulate=True) "
          f"{scatter_add['library_ms']:.4f} ms; launches per train step "
          f"{launches['scatter_rows']}")
    print(f"[time] lra_topn on a rank's block ({B}, {blk_n + 1}), n={n}: "
          f"{lra_block['ms']:.4f} ms (bound {lra_block['bound'][0]:.6f} ms "
          f"by {lra_block['bound'][1]}), plain {lra_block['plain_ms']:.4f} "
          f"ms, library torch.topk {lra_block['library_ms']:.4f} ms")
    print(f"[time] sparse_write_update on its buffers cloned after pads of "
          f"0 to 3 MB: {', '.join(f'{t:.4f}' for t in write_placed)} ms "
          f"(spread {max(write_placed) - min(write_placed):.4f} ms); with "
          f"its rows folded into 2 MB of each batch row: "
          f"{write_folded:.4f} ms; fused_read_candidates with its "
          f"candidates so folded: {cand_folded:.4f} ms")
    for what, r in (("the written rows", rows["lsh_hash"]),
                    ("the queries", hash_query), ("all B·N rows", hash_bulk)):
        print(f"[time] lsh_hash of {what}: {r['ms']:.4f} ms (bound "
              f"{r['bound'][0]:.6f} ms by {r['bound'][1]}, "
              f"{r['bound'][0] / r['ms']:.1%} of it), plain "
              f"{r['plain_ms']:.4f} ms")
    print(f"[time] fused_read_candidates above: C={C} candidates per head, "
          f"{int(valid_c.sum().item())} valid, {uniq_c} unique rows")
    print(f"[time] rollout {step_ms:.3f} ms/step, median of "
          f"{', '.join(f'{r:.3f}' for r in rollouts)} (B={B}, N={N}, T={T}); "
          f"peak memory {peak / 2**30:.2f} GiB; write touches {uniq} unique "
          f"rows; device time {dev_step_ms:.4f} ms/step in "
          f"{dev_step_n:.1f} kernel launches")
    print(f"[time] rollout kernels a step (ms, launches): "
          + "; ".join(f"{k_[:48]} {t_:.4f} ({c_:g})"
                      for k_, t_, c_ in step_kernels))
    print(f"[time] LSH rollout {lsh_step_ms:.3f} ms/step, median of "
          f"{', '.join(f'{r:.3f}' for r in lsh_rollouts)}; peak memory "
          f"{lsh_peak / 2**30:.2f} GiB; device time {lsh_dev_step_ms:.4f} "
          f"ms/step in {lsh_dev_step_n:.1f} kernel launches")
    for kind, r in (("sam", tr), ("sam_ann", tr_l)):
        print(f"[time] {kind} train step {r['ms']:.2f} ms, median of "
              f"{', '.join(f'{t:.2f}' for t in r['all'])} (sparse, B={B}, "
              f"N={N}, T={T}); forward {r['fwd_ms']:.2f} ms (of "
              f"{', '.join(f'{t:.2f}' for t in r['fwd_all'])}), backward "
              f"{r['bwd_ms']:.2f} ms (of "
              f"{', '.join(f'{t:.2f}' for t in r['bwd_all'])}); peak memory "
              f"{r['peak']} B")
    print(f"[time] train step peak memory {train_peak / 2**30:.3f} GiB "
          f"({train_peak} B) against residual_accounting(mode='sparse') "
          f"{acct['residual_bytes']} B + one dense memory cotangent "
          f"{mem_ct_bytes} B = {acct['residual_bytes'] + mem_ct_bytes} B "
          f"(chunked C={chunk}: {acct_c['residual_bytes']} B); sam_ann "
          f"{acct_l['residual_bytes'] + mem_ct_bytes} B")
    for kind, d_ms, on_dev, r in (("sam", device_ms, on_device, tr),
                                  ("sam_ann", lsh_device_ms, lsh_on_device,
                                   tr_l)):
        if d_ms > 0:
            print(f"[time] {kind} train step on the device (torch.profiler, "
                  f"one step): {d_ms:.2f} ms of kernels, "
                  f"{d_ms / r['ms']:.1%} of the {r['ms']:.2f} ms step; by "
                  f"kernel (ms, launches): "
                  + "; ".join(f"{k[:60]} {t:.3f} ({c})"
                              for k, t, c in on_dev[:8]))
        else:
            print(f"[time] {kind} train step on the device: not measured "
                  f"(the profiler recorded no device time)")

    mark("6")
    # ---- 7. bf16 and int8 rows, exact and LSH reads ----
    def run_write(args):
        """The write kernel of ``args`` (a write's recorded arguments) on
        clones of its buffers."""
        scale = None if args[8] is None else args[8].clone()
        return sparse_write_update(args[0].clone(), args[1].clone(),
                                   *args[2:7], delta=args[7], mem_scale=scale)

    def timed_write(args):
        """(kernel ms, plain ms, bound) of the write of ``args``, repeated
        in place on copies of its buffers."""
        m, la_ = args[0].clone(), args[1].clone()
        scale = None if args[8] is None else args[8].clone()
        uniq_w = unique_rows(args[2])
        row_bytes = W * m.element_size() + (0 if scale is None else 4)
        ms_ = time_ms(lambda: sparse_write_update(
            m, la_, *args[2:7], delta=args[7], mem_scale=scale), 50, flush)
        if scale is None:
            plain = time_ms(lambda: ref.sparse_write_update_ref(
                m, la_, *args[2:7], args[7]), 20, flush)
        else:
            plain = time_ms(lambda: ref.sparse_write_update_q_ref(
                m, scale, la_, *args[2:7], args[7]), 20, flush)
        return dict(ms=ms_, plain_ms=plain, library_ms=None,
                    bound=bound(2 * uniq_w * (row_bytes + 4)
                                + 4 * (2 * B * J + B * H * W + B * H + B),
                                2 * B * J * W))

    dtype_runs, dtype_launches, dtype_train = {}, {}, {}
    cpu_gen = torch.Generator().manual_seed(6)
    for dtype in ("bfloat16", "int8"):
        for read in ("exact", "lsh"):
            pair = f"{dtype}/{read}"
            d_cfg = sam.SAMConfig(dataclasses.replace(
                cfg.memory, mem_dtype=dtype, **(LSH if read == "lsh" else {})),
                cfg.controller)
            d_model = sam.SAM(d_cfg, seed=0, device=dev)
            base = "fused_read_candidates" if read == "lsh" else \
                "fused_read_sweep"
            rname = base + SUFFIX[dtype]
            wname = "sparse_write_update" + SUFFIX[dtype]
            scaled = dtype == "int8"
            # (a) each kernel against its plain version on the inputs of a
            # real rollout: the cold first step and step 21, and a write
            # heavy in duplicates (every column on rows 0-2).
            with torch.inference_mode():
                with Intercept(ops, record=True) as rec_d:
                    d_model(d_model.init_state(B), xs[:max(RECORD_STEPS)])
                for step in RECORD_STEPS:
                    wr_d = rec_d.records[("sparse_write_update", step)]
                    checker.write(wr_d, run_write(wr_d))
                    r_args = rec_d.records[(base, step)]
                    q_, m_, b_, k_, x_, s_ = r_args
                    if read == "exact":
                        checker.read(q_, m_, b_, k_, x_, fused_read_sweep(
                            q_, m_, b_, k=k_, valid_n=x_, mem_scale=s_), s_)
                    else:
                        checker.read_cand(q_, m_, b_, k_, x_,
                                          fused_read_candidates(
                                              q_, m_, b_, x_, k=k_,
                                              mem_scale=s_), s_)
                    if step == 1:
                        require(wr_d[0].eq(0).all().item(),
                                f"{pair}: step 1 should write into an "
                                f"all-zero memory")
                dup_idx = torch.randint(0, 3, wr_d[2].shape, generator=cpu_gen,
                                        dtype=torch.int32).to(dev)
                dup_lra = dup_idx.reshape(B, H, K + 1)[..., K].contiguous()
                dup = (*wr_d[:2], dup_idx, *wr_d[3:5], dup_lra, *wr_d[6:])
                checker.write(dup, run_write(dup))
                torch.cuda.synchronize()
            print(f"[dtype] {pair}: {wname} bit for bit at steps "
                  f"{RECORD_STEPS} and on a duplicate-heavy write; {rname} "
                  f"err {checker.err[rname]:.3g}; near-ties "
                  f"{checker.near_ties}")
            # (b) the forward rollout, in lockstep, with exact launches.
            zero_counts()
            with torch.inference_mode(), Intercept(ops, checker=checker):
                d_state, d_ys = d_model(d_model.init_state(B), xs)
            torch.cuda.synchronize()
            launched = counts()
            want = {name: 0 for name in launched}
            want.update({"lra_topn": T, base: T, rname: T, wname: T,
                         "sparse_write_update": T})
            if read == "lsh":
                want["lsh_hash"] = 2 * T
            require(launched == want, f"{pair} rollout launched {launched}, "
                    f"expected {want}")
            dtype_launches[pair] = launched
            f32_ys = lsh_ys if read == "lsh" else ys
            require(d_ys.shape == (T, B, BITS)
                    and torch.isfinite(d_ys).all().item(),
                    f"{pair}: outputs are not finite values of shape "
                    f"(T, B, bits)")
            require(d_state.memory.dtype == getattr(torch, dtype)
                    and d_state.memory[:, N].eq(0).all().item()
                    and d_state.last_access[:, N].eq(LA_SCRATCH).all().item()
                    and int(d_state.step) == T,
                    f"{pair}: the memory changed dtype, or the scratch row "
                    f"was touched")
            if scaled:
                sc = d_state.mem_scale
                require(sc.shape == (B, N + 1) and sc[:, N].eq(0).all().item()
                        and torch.isfinite(sc).all().item()
                        and sc.ge(0).all().item() and sc.gt(0).any().item(),
                        f"{pair}: the scales are out of shape or range")
            if read == "lsh":
                bk = d_state.ann.buckets
                require(bool(((bk >= -1) & (bk < N)).all()),
                        f"{pair}: the LSH index holds an id out of range")
            y_gap = (d_ys - f32_ys).abs().max().item()
            print(f"[dtype] {pair} rollout (T={T}) in lockstep: launches "
                  f"{ {k: v for k, v in launched.items() if v} }; outputs "
                  f"finite; max |y - y(f32 rows)| {y_gap:.3g}")
            # (c) times.
            step21 = max(RECORD_STEPS)
            if read == "exact":
                rows[wname] = timed_write(
                    rec_d.records[("sparse_write_update", step21)])
                q_, m_, b_, k_, vn_, s_ = rec_d.records[(base, step21)]
                row_bytes = W * m_.element_size() + (4 if scaled else 0)
                read_bytes = (B * N * row_bytes
                              + 4 * (2 * B * H * W + B * H + 2 * B * H * K))
                rows[rname] = dict(
                    ms=time_ms(lambda: fused_read_sweep(
                        q_, m_, b_, k=k_, valid_n=vn_, mem_scale=s_), 20,
                        flush),
                    plain_ms=time_ms(lambda: ref.fused_read_ref(
                        q_, m_, b_, k_, valid_n=vn_, mem_scale=s_), 5, flush),
                    library_ms=None,
                    bound=bound(read_bytes,
                                B * N * W * (2 * H + 2 + int(scaled))),
                    rate=(read_bytes, B * N))
            else:
                q_, m_, b_, k_, c_, s_ = rec_d.records[(base, step21)]
                row_bytes = W * m_.element_size() + (4 if scaled else 0)
                uniq_d = len({(b, r) for b, row in
                              enumerate(c_.reshape(B, -1).tolist())
                              for r in row if r >= 0})
                rows[rname] = dict(
                    ms=time_ms(lambda: fused_read_candidates(
                        q_, m_, b_, c_, k=k_, mem_scale=s_), 50, flush),
                    plain_ms=time_ms(lambda: ref.fused_read_candidates_ref(
                        q_, m_, b_, k_, c_, s_), 20, flush),
                    library_ms=None,
                    bound=bound(uniq_d * row_bytes
                                + 4 * (B * H * (W + 1 + c_.shape[-1])
                                       + B * H * (W + 2 * K)),
                                int((c_ >= 0).sum().item()) * 4 * W
                                + B * H * 2 * K * W))
            d_ms, d_all, d_peak = rollout_ms(d_model)
            d_dev_ms, d_dev_n = rollout_device(d_model)
            dtype_runs[pair] = dict(
                ms_per_step=d_ms, device_ms_per_step=d_dev_ms or None,
                device_launches_per_step=d_dev_n, peak_bytes=d_peak,
                state_bytes=tree_bytes(d_state), y_gap_to_f32=y_gap)
            for name in (wname, rname) if read == "exact" else (rname,):
                r = rows[name]
                print(f"[time] {name}: {r['ms']:.4f} ms (bound "
                      f"{r['bound'][0]:.6f} ms by {r['bound'][1]}"
                      f"{sweep_rate(r)}), plain {r['plain_ms']:.4f} ms")
            print(f"[time] {pair} rollout {d_ms:.3f} ms/step, median of "
                  f"{', '.join(f'{r:.3f}' for r in d_all)}; device time "
                  f"{d_dev_ms:.4f} ms/step in {d_dev_n:.1f} kernel launches; "
                  f"peak memory {d_peak} B against the state's "
                  f"{tree_bytes(d_state)} B")
            # (d) training on these rows (ROADMAP A6b), from the rollout's
            # final state: the sparse forward and backward in lockstep with
            # the launches a backward step predicted in PERF.md §6 (bf16:
            # six bf16 scatters; int8: the rollback's two int8 restores,
            # the replay's int8 write, the scales' cotangent 'set' and
            # 'add' on the f32 kernel at W = 1), the memory (and scales)
            # back bit for bit; chunked against sparse; the main path;
            # a small step on the card against the CPU; times.
            d_cell = SAMCell(d_cfg)
            flat_d = flat_params(d_model)
            kind = "sam_ann" if read == "lsh" else "sam"
            want_bwd = {name: 0 for name in launched}
            if scaled:
                want_bwd.update({"scatter_rows": 4 * T,
                                 "scatter_rows_int8": 2 * T,
                                 "sparse_write_update": T, wname: T})
            else:
                want_bwd.update({"scatter_rows": SAM_BWD_SCATTERS * T,
                                 "scatter_rows_bf16": 6 * T})
            before = dict(checker.scatter_calls)
            loss_d, g_d, fwd_d, bwd_d, restored_d, acct_d = fwd_bwd(
                "sparse", None, True, d_cell, d_state, flat_d)
            require(fwd_d == want, f"{pair} sparse forward launched "
                    f"{fwd_d}, expected {want}")
            require(bwd_d == want_bwd, f"{pair} sparse backward launched "
                    f"{ {k: v for k, v in bwd_d.items() if v} }, expected "
                    f"{ {k: v for k, v in want_bwd.items() if v} }")
            require(restored_d, f"the {pair} sparse backward did not give "
                    f"the memory{' and scales' if scaled else ''} back bit "
                    f"for bit")
            require(torch.isfinite(loss_d).item() and all(
                torch.isfinite(g).all().item() for g in g_d),
                f"a {pair} loss or gradient leaf is not finite")
            print(f"[dtype-train] {pair} sparse forward and backward in "
                  f"lockstep: backward launches "
                  f"{ {k: v for k, v in bwd_d.items() if v} } (as "
                  f"predicted); scatter calls checked "
                  f"{checked_since(before)}, each bit for bit; memory"
                  f"{' and scales' if scaled else ''} restored bit for bit; "
                  f"loss {loss_d.item():.6f}")
            chunk_d = unroll_lib.suggest_chunk(d_cell, None, start_state(
                d_cell, d_state), xs) if read == "exact" else 5
            loss_dc, g_dc, _, _, restored_dc, acct_dc = fwd_bwd(
                "chunked", chunk_d, False, d_cell, d_state, flat_d)
            d_chunk_err = max((a - b).abs().max().item()
                              for a, b in zip(g_dc, g_d))
            require(restored_dc and all(
                torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in zip(g_dc, g_d)), f"{pair} chunked C={chunk_d} "
                f"against sparse: gradients max err {d_chunk_err:.3g}, "
                f"restored {restored_dc}")
            require(abs(loss_dc.item() - loss_d.item())
                    <= TOL * abs(loss_d.item()), f"{pair} chunked loss")
            print(f"[dtype-train] {pair} chunked C={chunk_d}: gradients max "
                  f"err {d_chunk_err:.3g} against sparse")
            fn_d, p_d, o_d, main_d = main_step(kind, flat_d, d_cfg.memory)
            want_main = {k_: want[k_] + want_bwd[k_] for k_ in want}
            require(main_d == want_main, f"{pair} train step launched "
                    f"{ {k: v for k, v in main_d.items() if v} }, expected "
                    f"{ {k: v for k, v in want_main.items() if v} }")
            d_small = small_train(kind, dtype, None if scaled
                                  else BF16_GRAD_BAR)
            tr_d = train_timing(fn_d, p_d, o_d, d_cell, flat_d, d_state)
            ct_bytes = (B * (N + 1) * 4 if scaled
                        else B * (N + 1) * W * 2)
            dtype_train[pair] = dict(
                loss=loss_d.item(), bwd_launches=bwd_d, main_launches=main_d,
                chunk=chunk_d, chunked_vs_sparse_grad_err=d_chunk_err,
                card_vs_cpu_grad_err=d_small, ms=tr_d["ms"],
                all=tr_d["all"], fwd_ms=tr_d["fwd_ms"],
                bwd_ms=tr_d["bwd_ms"], peak_bytes=tr_d["peak"],
                residual_bytes=acct_d["residual_bytes"],
                chunked_residual_bytes=acct_dc["residual_bytes"],
                cotangent_bytes=ct_bytes)
            dtype_launches[pair + "/train"] = main_d
            print(f"[time] {pair} train step {tr_d['ms']:.2f} ms, median of "
                  f"{', '.join(f'{t:.2f}' for t in tr_d['all'])} (sparse, "
                  f"B={B}, N={N}, T={T}); forward {tr_d['fwd_ms']:.2f} ms, "
                  f"backward {tr_d['bwd_ms']:.2f} ms; peak memory "
                  f"{tr_d['peak']} B against residual_accounting("
                  f"mode='sparse') {acct_d['residual_bytes']} B + the "
                  f"cotangent buffer {ct_bytes} B = "
                  f"{acct_d['residual_bytes'] + ct_bytes} B (chunked "
                  f"C={chunk_d}: {acct_dc['residual_bytes']} B)")
            del fn_d, p_d, o_d, g_d, g_dc
            # (e) the row scatter's instantiation on these rows, timed on
            # the step-21 inputs of a backward: the rollback ('set'), and
            # for bf16 the read cotangent's 'add'.
            if read == "exact":
                wr21 = rec_d.records[("sparse_write_update", step21)]
                sname = "scatter_rows" + SUFFIX[dtype]
                widx21d = wr21[2]
                old21d = ref.gather_rows(wr21[0], widx21d)
                uniq_d = unique_rows(widx21d)
                b_d = torch.arange(B, device=dev)[:, None].expand(B, J)
                wl_d = widx21d.long()
                buf = wr21[0].clone()
                elt = buf.element_size()
                if scaled:
                    sc_buf = wr21[8].clone()
                    old_sd = ref.gather_rows(wr21[8][..., None],
                                             widx21d)[..., 0]
                    rows[sname] = dict(
                        ms=time_ms(lambda: scatter_rows(
                            buf, widx21d, old21d, mode="set",
                            mem_scale=sc_buf, rows_scale=old_sd), 50, flush),
                        plain_ms=time_ms(lambda: ref.scatter_rows_q_ref(
                            buf, sc_buf, widx21d, old21d, old_sd, "set"), 20,
                            flush),
                        library_ms=None,
                        bound=bound(4 * B * J + 2 * uniq_d * (W * elt + 4),
                                    0))
                else:
                    q21d, m21d, b21d, _, _, _ = rec_d.records[(base, step21)]
                    ridx21d = fused_read_sweep(q21d, m21d, b21d, k=K,
                                               valid_n=N)[2].reshape(B, H * K)
                    uniq_ad = unique_rows(ridx21d)
                    g_bf = scatter_cases["read cotangent (add)"][2].bfloat16()
                    buf_a = torch.zeros_like(buf)
                    b_a = torch.arange(B, device=dev)[:, None].expand(B,
                                                                      H * K)
                    rl_d = ridx21d.long()
                    rows[sname] = dict(
                        ms=time_ms(lambda: scatter_rows(
                            buf, widx21d, old21d, mode="set"), 50, flush),
                        plain_ms=time_ms(lambda: ref.scatter_rows_ref(
                            buf, widx21d, old21d, "set"), 20, flush),
                        library_ms=time_ms(lambda: buf.index_put_(
                            (b_d, wl_d), old21d), 50, flush),
                        bound=bound(4 * B * J + 2 * uniq_d * W * elt, 0))
                    scatter_add_bf16 = dict(
                        ms=time_ms(lambda: scatter_rows(
                            buf_a, ridx21d, g_bf, mode="add"), 50, flush),
                        plain_ms=time_ms(lambda: ref.scatter_rows_ref(
                            buf_a, ridx21d, g_bf, "add"), 20, flush),
                        library_ms=time_ms(lambda: buf_a.index_put_(
                            (b_a, rl_d), g_bf, accumulate=True), 50, flush),
                        bound=bound(4 * B * H * K
                                    + B * H * K * W * elt
                                    + 2 * uniq_ad * W * elt, B * H * K * W))
                    del buf_a
                r = rows[sname]
                lib = ("none (no one PyTorch call restores the codes and "
                       "the scales)" if r["library_ms"] is None
                       else f"index_put_ {r['library_ms']:.4f} ms")
                print(f"[time] {sname} 'set' (the rollback of step {step21}, "
                      f"J={J}, {uniq_d} unique rows): {r['ms']:.4f} ms (bound "
                      f"{r['bound'][0]:.6f} ms by {r['bound'][1]}), plain "
                      f"{r['plain_ms']:.4f} ms, library {lib}")
                if not scaled:
                    r = scatter_add_bf16
                    print(f"[time] {sname} 'add' (read cotangent, {H * K} "
                          f"columns, {uniq_ad} unique rows): {r['ms']:.4f} "
                          f"ms (bound {r['bound'][0]:.6f} ms by "
                          f"{r['bound'][1]}), plain {r['plain_ms']:.4f} ms, "
                          f"library index_put_(accumulate=True) "
                          f"{r['library_ms']:.4f} ms")
                del buf
            del d_model, d_state, d_ys, rec_d, wr_d, dup, r_args
            q_ = m_ = b_ = s_ = None
            torch.cuda.empty_cache()

    mark("7")
    # ---- 8. the dense baselines: DAM, the NTM, the LSTM ----
    dense = dense_phase(dev, ops, ref, usage_argmin, checker, zero_counts,
                        counts, flush, small_train,
                        (inputs, targets, mask, xs))
    rows["usage_argmin"] = dense["row"]

    mark("8")
    # ---- 9. the SAM-augmented LM at StarCoder2-7B's width ----
    lmr = lm_phase(dev, ops, ref, checker, zero_counts, counts, flush)
    rows["flash_attention"] = lmr["row"]
    checker.err["flash_attention"] = lmr["err"]

    mark("9")
    # ---- 10. the slot-sharded memory: MESH_S ranks over gloo ----
    mesh = mesh_phase(dev, ref, checker, flush, rec, mesh_ref,
                      model.params(), xs, step_ms, (inputs, targets, mask))
    rows["topk_read"] = mesh["row"]
    rows["topk_read_bf16"] = mesh["bf16_row"]
    rows["topk_read_int8"] = mesh["int8_row"]

    mark("10")
    # ---- 11. the DNC and the SDNC ----
    dnc_res = dnc_phase(dev, ops, ref, checker, zero_counts, counts)

    mark("11")
    # ---- 12. the serving engine at StarCoder2-7B's width ----
    engine_res = engine_phase(dev, ops, ref, checker, zero_counts, counts,
                              lmr.pop("params"))

    mark("12")
    # ---- 14. the streaming trainer and the checkpointed training loop ----
    stream_res = stream_phase(dev, ops, ref, checker, zero_counts, counts)

    mark("14")
    # ---- 15. the sliding-window LM at H2O-Danube3-4B's width ----
    swa = swa_phase(dev, ops, ref, checker, zero_counts, counts, flush,
                    info["flash_attention"]["ptxas"])
    rows["flash_attention_swa"] = swa["row"]
    rows["flash_attention_swa_bf16"] = swa["bf16_row"]
    checker.err["flash_attention_swa"] = swa["err"]
    checker.err["flash_attention_swa_bf16"] = swa["bf16_err"]

    mark("15")
    # ---- 16. the vision-language LM at PaliGemma-3B's width ----
    vlm = vlm_phase(dev, ops, ref, checker, zero_counts, counts, flush,
                    info["flash_attention"]["ptxas"])
    rows["flash_attention_vlm"] = vlm["row"]
    rows["flash_attention_vlm_bf16"] = vlm["bf16_row"]
    checker.err["flash_attention_vlm"] = vlm["err"]
    checker.err["flash_attention_vlm_bf16"] = vlm["bf16_err"]

    mark("16")
    # ---- 17. DeepSeek-V2 (MLA, MoE) at full width, 4 of 60 layers ----
    mla = mla_phase(dev, ops, ref, checker, zero_counts, counts, flush,
                    info["flash_attention"]["ptxas"])
    rows["flash_attention_mla"] = mla["row"]
    rows["flash_attention_mla_bf16"] = mla["bf16_row"]
    checker.err["flash_attention_mla"] = mla["err"]
    checker.err["flash_attention_mla_bf16"] = mla["bf16_err"]
    rows["flash_attention_llama4"] = llama4["row"]
    rows["flash_attention_llama4_bf16"] = llama4["bf16_row"]
    checker.err["flash_attention_llama4"] = llama4["err"]
    checker.err["flash_attention_llama4_bf16"] = llama4["bf16_err"]

    mark("17")
    # ---- 20. MusicGen-medium (+ SAM) on frames, full width and depth ----
    mg = musicgen_phase(dev, ops, ref, checker, zero_counts, counts, flush)
    rows["flash_attention_musicgen"] = mg["row"]
    rows["flash_attention_musicgen_bf16"] = mg["bf16_row"]
    checker.err["flash_attention_musicgen"] = mg["err"]
    checker.err["flash_attention_musicgen_bf16"] = mg["bf16_err"]

    mark("20")
    # ---- 21. RWKV-6 7B (+ SAM), full width and depth ----
    rw = rwkv_phase(dev, ops, ref, checker, zero_counts, counts, flush)

    mark("21")
    # ---- 22. Hymba-1.5B (+ SAM), full width and depth; the sparse decode
    hy = hymba_phase(dev, ops, ref, checker, zero_counts, counts, flush)
    rows["flash_attention_hymba"] = hy["row"]
    rows["flash_attention_hymba_bf16"] = hy["bf16_row"]
    checker.err["flash_attention_hymba"] = hy["err"]
    checker.err["flash_attention_hymba_bf16"] = hy["bf16_err"]

    mark("22")
    # ---- 19. the paper's tasks: bAbI-lite and one-shot Omniglot ----
    tasks_res = tasks_phase(dev, ops, ref, checker, zero_counts, counts)

    mark("19")
    # ---- 24. report ----
    lm_write = lmr["lm"]["kernels_at_lm_shapes"]["sparse_write_update"]
    above = (("lra_topn", rows["lra_topn"]), ("block", lra_block),
             ("scatter_rows 'set'", rows["scatter_rows"]),
             ("'add'", scatter_add),
             ("sparse_write_update", rows["sparse_write_update"]),
             ("bf16", rows["sparse_write_update_bf16"]),
             ("int8", rows["sparse_write_update_int8"]),
             ("the LM's", lm_write),
             ("fused_read_candidates", rows["fused_read_candidates"]),
             ("bf16", rows["fused_read_candidates_bf16"]),
             ("int8", rows["fused_read_candidates_int8"]),
             ("lsh_hash R = B·J", rows["lsh_hash"]),
             ("R = B·H", hash_query),
             ("scatter_rows_bf16 'set'", rows["scatter_rows_bf16"]),
             ("'add'", scatter_add_bf16),
             ("scatter_rows_int8 'set'", rows["scatter_rows_int8"]),
             ("scatter_rows at the LM's shapes 'set'",
              lmr["lm"]["kernels_at_lm_shapes"]["scatter_rows"]),
             ("'add'", lmr["lm"]["kernels_at_lm_shapes"]["scatter_rows_add"]))
    print(f"[time] empty-launch floor (torch.cuda._sleep(0), same timer): "
          f"{empty_ms:.4f} ms; above it: "
          + ", ".join(f"{name} {r['ms'] - empty_ms:.4f} ms"
                      for name, r in above))
    print(f"[phases] seconds: {phase_s}, {sum(phase_s.values()):.1f} in "
          f"all")
    print(card_line())
    # Launches: each kernel's count in the main path of its own read, the
    # exact-read train step or (the hash, the candidate read) sam_ann's.
    path_of = {"lsh_hash": launches_l, "fused_read_candidates": launches_l,
               "sparse_write_update_bf16": dtype_launches["bfloat16/exact"],
               "fused_read_sweep_bf16": dtype_launches["bfloat16/exact"],
               "sparse_write_update_int8": dtype_launches["int8/exact"],
               "fused_read_sweep_int8": dtype_launches["int8/exact"],
               "fused_read_candidates_bf16": dtype_launches["bfloat16/lsh"],
               "fused_read_candidates_int8": dtype_launches["int8/lsh"],
               "scatter_rows_bf16": dtype_launches["bfloat16/exact/train"],
               "scatter_rows_int8": dtype_launches["int8/exact/train"],
               "usage_argmin": dense["launches"],
               "flash_attention": lmr["launches"],
               "flash_attention_swa": swa["launches"],
               "flash_attention_swa_bf16": swa["launches"],
               "flash_attention_vlm": vlm["launches"],
               "flash_attention_vlm_bf16": vlm["launches"],
               "flash_attention_mla": mla["launches"],
               "flash_attention_mla_bf16": mla["launches"],
               "flash_attention_llama4": llama4["launches"],
               "flash_attention_llama4_bf16": llama4["launches"],
               "flash_attention_musicgen": mg["launches"],
               "flash_attention_musicgen_bf16": mg["launches"],
               "flash_attention_hymba": hy["launches"],
               "flash_attention_hymba_bf16": hy["launches"],
               "topk_read": mesh["launches"],
               "topk_read_bf16": mesh["bf16_launches"],
               "topk_read_int8": mesh["int8_launches"]}
    report = []
    for name, r in rows.items():
        replaces, source = REPLACES[name]
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces,
                       "launches": path_of.get(name, launches)[name],
                       "max_abs_err": checker.err.get(name, 0.0),
                       "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                       "library_ms": r["library_ms"]})

    def sub(r):
        return {"ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]}

    by_name = {r["name"]: r for r in report}
    by_name["scatter_rows"]["add"] = sub(scatter_add)
    by_name["scatter_rows_bf16"]["add"] = sub(scatter_add_bf16)
    by_name["lra_topn"]["block"] = sub(lra_block)
    by_name["lsh_hash"]["query"] = sub(hash_query)
    by_name["lsh_hash"]["bulk"] = sub(hash_bulk)
    by_name["topk_read"]["full"] = sub(mesh["row"]["full"])
    by_name["topk_read_bf16"]["full"] = sub(mesh["bf16_row"]["full"])
    by_name["topk_read_int8"]["full"] = sub(mesh["int8_row"]["full"])
    by_name["flash_attention"]["bf16"] = dict(
        sub(lmr["row"]["bf16"]), max_abs_err=lmr["bf16_err"],
        launches=lmr["bf16_launches"])
    print(json.dumps({"kernels": report, "near_ties": checker.near_ties,
                      "near_zero_bits": checker.near_zero_bits,
                      "empty_launch_ms": empty_ms,
                      "write_placements_ms": write_placed,
                      "write_folded_ms": write_folded,
                      "cand_folded_ms": cand_folded,
                      "main_path_launches": {"sam": launches,
                                             "sam_ann": launches_l},
                      "ms_per_step": step_ms, "peak_bytes": peak,
                      "device_ms_per_step": dev_step_ms or None,
                      "device_launches_per_step": dev_step_n,
                      "forward_launches": fwd_launches,
                      "lsh_ms_per_step": lsh_step_ms,
                      "lsh_peak_bytes": lsh_peak,
                      "lsh_device_ms_per_step": lsh_dev_step_ms or None,
                      "lsh_device_launches_per_step": lsh_dev_step_n,
                      "lsh_forward_launches": lsh_fwd_launches,
                      "train_ms_per_step": train_ms, "train_fwd_ms": fwd_ms,
                      "train_bwd_ms": bwd_ms, "train_peak_bytes": train_peak,
                      "train_device_ms": device_ms or None,
                      "train_residual_bytes": acct["residual_bytes"],
                      "mem_ct_bytes": mem_ct_bytes,
                      "lsh_train_ms_per_step": tr_l["ms"],
                      "lsh_train_fwd_ms": tr_l["fwd_ms"],
                      "lsh_train_bwd_ms": tr_l["bwd_ms"],
                      "lsh_train_peak_bytes": tr_l["peak"],
                      "lsh_train_device_ms": lsh_device_ms or None,
                      "card_vs_cpu_grad_err": small_grad_err,
                      "lsh_card_vs_cpu_grad_err": small_lsh_grad_err,
                      "chunked_vs_sparse_grad_err": chunk_err,
                      "lsh_chunked_vs_sparse_grad_err": lsh_chunk_err,
                      "dtypes": dtype_runs, "dtype_train": dtype_train,
                      "dense": {k: v for k, v in dense.items()
                                if k != "row"},
                      "lm": lmr["lm"], "mesh": mesh["mesh"],
                      "dnc": dnc_res, "engine": engine_res,
                      "lm_train": train_res, "stream": stream_res,
                      "swa": swa["swa"], "vlm": vlm["vlm"],
                      "mla": mla["mla"], "llama4": llama4["llama4"],
                      "musicgen": mg["musicgen"], "rwkv": rw["rwkv"],
                      "hymba": hy["hymba"],
                      "family_train": family_train,
                      "tasks": tasks_res,
                      "phase_seconds": phase_s},
                     default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
