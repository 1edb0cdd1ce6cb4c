"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. The card (nvidia-smi name and power limit) and the build: nvcc compiles
   picotron_tpu_torch/csrc/flash_attention.cu and csrc/adamw.cu for sm_90a
   from the checkout, both at once (ptxas registers and spills per kernel
   printed, and the dynamic shared memory of the Hopper dq and dk/dv), and
   cuobjdump's SASS of the library must show HMMA (mma.sync tensor-core)
   instructions in both variants (D 64, 128) of the bf16 forward,
   fwd_mma_kernel, and in the D-128 dq and dk/dv, bwd_dq_mma_kernel and
   bwd_dkv_mma_kernel, and HGMMA (wgmma) in the D-64 dq and dk/dv,
   bwd_dq_wgmma_kernel and bwd_dkv_wgmma_kernel.
2. Each of the three flash-attention kernels against its plain PyTorch
   version on the card, in bf16: at the training shape (B 2, S 2048, H 32,
   D 64, fused RoPE, positions None), at a GQA shape with D 128 (Hq 32,
   Hkv 8), at a shifted-positions shape (a later q shard against the
   whole K/V) with a nonzero LSE cotangent, and at the per-rank heads of
   tp 4 (SmolLM-1.7B: B 2, Hq = Hkv = 8, D 64; Llama-3-8B: B 1, Hq 8,
   Hkv 2, D 128, and Hq 16, Hkv 4 under the 2d tp strategy at 2 x 2, the
   shape phase 15 runs). At each D-64 shape the wgmma kernels' rotation
   pre-pass (`rope_rows`, of q and of k) equals its plain version `_rot`
   bit for bit. Then each kernel's time at the
   training shape beside its plain version's, PyTorch's SDPA as a yardstick
   (SDPA does no RoPE: it gets pre-rotated inputs), and the bound (the
   D-64 dq timed on the rotated q and k that the backward shares with
   dk/dv, whose time holds the pre-pass); and each
   kernel's time, achieved TFLOP/s and share of its bound at the training
   and every other static shape, with and without RoPE (with RoPE, the
   D-64 dq and dk/dv each hold their own pre-pass).
3. The main path: `python -m picotron_tpu_torch.train --config
   picotron_tpu_torch/configs/smollm17-1gpu-seq2048.json` (its entry point,
   in process) on full-width, full-depth SmolLM-1.7B (24 layers), seq 2048, mbs 2, ga 2,
   constant lr 3e-4 with no warmup, 4 steps, synthetic data, remat and
   offload off. Checks: every loss finite; the last step's loss below the
   first's; each kernel launched 24 x ga x steps times, every launch on
   its tensor-core kernel (bf16; the dq's on bwd_dq_wgmma_kernel and the
   dk/dv's on bwd_dkv_wgmma_kernel, both reading the q and k that two
   launches of the rotation pre-pass per backward call rotated); the
   AdamW kernel launched once per parameter tensor per step (219 x
   steps); and the trained
   model's loss on the first step's batch (re-read from a fresh loader)
   below that step's loss. The synthetic tokens are uniform random, so a
   later step's fresh batch is learnable only down to the unigram law and
   its loss moves by little more than batch-to-batch noise; the seen batch
   is where a correct gradient must show, since Adam's first step follows
   that batch's gradient.
4. Checkpoint and resume on the same model and config, plus
   `checkpoint: {save_dir: build/smoke_ckpt, auto_resume: true}` and
   `training: {eval_frequency: 4, eval_steps: 2}`, through `train.run`.
   Run A: SIGTERM after step 2 must exit 75 with an emergency checkpoint
   of step 2 (~14.5 GB: fp32 params, bf16 moments) that verifies against
   its manifest. Run B: the same config auto-resumes at step 2 and trains
   steps 3-4. Gates: the state run B restored equals the state run A held
   at step 2, bit for bit (a device fingerprint of every param and moment,
   the AdamW count and the loader cursor); if run A's steps 1-2 equal
   phase 3's bit for bit, run B's steps 3-4 must equal phase 3's bit for
   bit, else they must agree within RESUME_SPREAD_FACTOR times the spread
   measured between run A and phase 3 (both printed); the val_loss at step
   4 (2 batches through the forward kernel under no_grad) within
   EVAL_ATOL of the same params' loss under `attn_impl: "reference"`;
   each kernel's launches in each run (eval's 24 x ga x 2 forward
   launches included), every one on its tensor-core kernel, and the
   AdamW kernel's (219 x 2 in each run). The save, verify and restore
   times are printed; the free disk is checked first and the directory
   is deleted at the end.
5. The fused grad engine, remat and chunked CE, on the same model:
   (a) engine parity: one step (ga 2) of the phase-3 config from one seed
   under the AD engine without remat and under the fused engine
   (`parallel/fused_bwd.py`, remat "dots_attn"): the same mean loss (bit
   for bit, else within LOSS_ATOL), every grad tensor within GRAD_RTOL in
   relative L2 of the AD engine's, and the fused engine's weight grads
   taken inside the GEMM (`torch.addmm(..., out_dtype=float32, out=acc)`,
   first checked to write in place) against its plain form (bf16 dW, then
   an fp32 add) at the same limit, and one step's grads by each form timed
   in turns; (b) the fused main path, `python -m
   picotron_tpu_torch.train --config
   picotron_tpu_torch/configs/smollm17-1gpu-seq2048-fused.json` (remat
   "dots_attn", grad_engine "auto", which must resolve to "fused"), with
   phase 3's checks: each kernel launched 24 x ga x steps times on its
   tensor-core kernel, so the forward kernel never re-runs in the
   backward; (c) two steps of the phase-3 config under the AD engine with
   each remat policy (two, so that the peak holds the AdamW moments the
   first update makes): the step-1 loss equal to phase 3's (bit for bit,
   else within LOSS_ATOL) and the step-2 loss within LOSS_ATOL of phase
   3's, the
   forward kernel launched twice per layer and microbatch under "full" and
   once otherwise, and each policy's peak memory and second step's time;
   "dots_offload" (every saved activation parked in pinned host memory,
   the lse on the card; `models/act_offload.py`) after "dots", held to
   its losses bit for bit and its launches, every copy timed: the peak
   and step-2 ms against "dots"', the bytes parked per step and each
   way's GB/s (bytes over the copies' own stream time) against the
   link's pinned-copy rates; then a planted fault (microbatch 2's first
   parked storage restored with microbatch 1's bytes, as from another
   microbatch's buffer), which must change its losses; (d) the chunked CE (chunk CE_CHUNK) against the unchunked one
   on one microbatch's hidden [2, 2048, 2048] and the head [49152, 2048]
   in bf16: the loss within CE_LOSS_RTOL, d hidden and d head within
   CE_GRAD_RTOL in relative L2, and each one's peak memory.
6. The AdamW kernel (`csrc/adamw.cu`) and the host-offloaded optimizer:
   (a) the kernel against its plain version (`optimizer.adamw_update_plain`)
   on the card, bit for bit, at ragged sizes (not multiples of its 8-wide
   vectors), both moment dtypes, clipping under and over the threshold,
   `grad_scale` with and without the clip, `ok` True and False (False
   must leave every tensor as it was) and with and without the bf16
   compute copy (which must equal p's cast); then its time for one
   update of every tensor at the phase-3 shape (SmolLM-1.7B's 219
   tensors, 1.812 B params, bf16 moments) beside its plain version's,
   its bound (20 B per param over the HBM rate) and
   `torch._fused_adamw_` on the same tensors with fp32 moments (the one
   PyTorch call that computes this update; the port never calls it);
   (b) offload against resident: 3 steps of the phase-3 config (constant
   lr 3e-4, ga 2) from one seed under `optimizer_offload`, the resident
   AdamW, and the resident AdamW computing as offload does
   (`offload_roundings`: offload's params are the bf16 cast of their
   masters, so its norm weights enter their products as that cast, and
   its norm and embedding grads round to bf16 as a bf16 param's do).
   Gates: offload's master at init equal to the resident params; the
   step-1 loss equal in all three runs; each streamed update equal bit
   for bit to `adamw_update_plain` run over whole tensors on card copies
   of the state before it (`replay_offload_steps`: master, mu, nu and the
   compute copy); offload equal to the rounded resident run bit for bit
   (losses, and every master after steps 1 and 3); and each tensor's
   update (master_t - master_0) against the plain resident run's, in
   relative L2: the matmul weights within OFFLOAD_RTOL after step 1, the
   norms and embedding within OFFLOAD_UPDATE_RTOL after step 1, and
   every tensor within OFFLOAD_UPDATE_RTOL after step 3; and the
   launches (each flash kernel 24 x ga per step, the AdamW kernel once
   per tensor, or streamed slice, per step). tests/test_torch_cuda.py
   plants three faults in the offloaded optimizer (the moments not
   copied back, the embedding's slices skipped, its grad lost) and checks
   that each fails the gates it must;
   (c) the offload configuration, `picotron_tpu_torch/configs/
   smollm17-1gpu-offload.json` (the JAX package's
   runs/smollm17-offload-1chip: full SmolLM-1.7B, seq 2048, mbs 2, ga 64,
   remat "dots_attn" so the fused engine, bf16 moments, cosine with 100
   warmup steps) at full width, depth and ga, 3 steps through `train.run`
   (`training.max_tokens` stops it, so the lr schedule is the file's):
   every loss finite, every flash launch on its tensor-core kernel (24 x
   64 x 3 each), the AdamW kernel once per slice per step, peak device
   memory, step time and tokens/s, and the update's seconds per step
   (CUDA events on the compute stream) and GB/s each way (8 B per param
   each way over the PCIe link), beside the link's own rate (1 GiB
   pinned copies, each way alone and both at once).
7. The parallel layouts' path (ZeRO-1, the data-group reduction) under a
   one-rank NCCL process group, each through the trainer's entry point in
   a child process, once as `python -m picotron_tpu_torch.train` and once
   under `python -m torch.distributed.run --standalone --nproc_per_node 1`
   (the card's machine has one GPU, and NCCL takes one rank per device):
   (a) `picotron_tpu_torch/configs/smollm17-1gpu-dp-zero1.json`
   (runs/smollm17-dp8 at full width and depth, mbs 4, ga 4, seq 2048,
   remat "dots", with zero1; dp 8 -> 1 and 3 steps); (b) the offload
   configuration with zero1 at ga 4 for 2 steps. Gates, for each: the
   losses under NCCL equal to those without a process group bit for bit
   (at world 1 every collective is a copy, tp 1 runs the single-device
   model and CE, ZeRO-1 owns every row); the collectives per step one
   all-reduce per grad tensor plus one of (NLL sum, count), one ZeRO-1
   all-gather per tensor and no reduce-scatter; in both runs each flash
   kernel launched 24 x ga x steps times on its tensor-core kernel and the
   AdamW kernel once per tensor (offload: per streamed slice) per step.
   Each run's step time, MFU and peak memory are printed.
8. Context parallelism (cp 4) in a thread world: the card has one GPU,
   so `ThreadWorld` runs one thread per cp rank, all on cuda:0, and
   their `ThreadComm`s exchange clones through a barrier and shared
   slots (a harness: NCCL's send/recv and all-to-all are not on this
   path); the schedules' code is the port's, unchanged, at the per-rank
   shapes of runs/llama2-7b-cp4-seq8192. Only the schedules and their
   `*_bwd_from_saved` run there (never `.backward()` through an
   exchange: a device's autograd nodes share one engine thread).
   (a) Attention at B 1, S 8192, Hq = Hkv = 32, D 128, bf16 (random
   q/k/v/dO from a seed): ring with the zigzag and the contiguous
   layout (per rank [1, 2048, 32, 128] blocks, 4 hops), Ulysses (inner
   [1, 8192, 8, 128], positions None after seq_sort) and mesh 2x2 (row
   domain [1, 4096, 16, 128], 2 hops), forward (merged lse) and backward
   from the saved (out, lse), over the flash kernels. Gates, phase 2's
   per-row limits: each rank's out, lse (merged, or in the inner or row
   domain) and dq/dk/dv against the rows of the whole sequence through
   the same kernels (`flash_attention` + `flash_attention_bwd_from_saved`
   at S 8192, static causal) after the layout's permutation, and against
   the schedule over the kernels' plain versions (`plain_flash`,
   `plain_flash_bwd`; the backward from the plain forward's (out, lse),
   so each kernel is held to its own plain version alone, as in phase
   2); each rank's launches per call (ring zigzag 4 of each kernel, ring
   contiguous r + 1 on rank r, whose blocks entirely in its future are
   skipped on the host, Ulysses 1, mesh 2 x 2 2), every one on the
   tensor-core kernel; and a planted fault, rank 1's zigzag chunks
   swapped in its positions, must fail. Each rank's kernel time (its
   recorded calls replayed one rank at a time, the visiting blocks
   prepared beforehand, CUDA events) beside the whole sequence's / 4 and
   its bound, and SDPA at the Ulysses inner shape.
   (b) The model's cp path: Llama-2-7B width (hidden 4096, 32 heads,
   intermediate 11008, vocab 32000) at CP_LAYERS = 2 layers (depth 32
   -> 2, so that four rank copies fit on the card), seq 8192, one
   microbatch, bf16 over fp32 params from one seed, through the fused
   engine (`fused_micro_grads`) for each of the four schedules. Gates:
   the ranks' NLL sums and token counts, summed by hand, against the
   same model at cp 1 on the card (the loss within CP_LOSS_RTOL
   relative, the count exactly), each grad tensor summed over the ranks
   within CP_GRAD_RTOL in relative L2 of the cp-1 grad; each kernel
   launched CP_LAYERS x the schedule's launches per rank, summed over
   the ranks, all tensor-core; no torch.distributed call (the
   communicator's exchanges only); and a planted fault, the zigzag
   positions off by one chunk, must fail.
9. Pipeline parallelism (pp 2) in a thread world: one thread per stage
   on cuda:0 (the card has one GPU, and NCCL takes one rank per device),
   exchanging through the same `ThreadComm`'s `exchange` and
   `all_reduce`; the walk, the stage ops and the optimizer are the
   port's (`parallel/pp.PipelineGrads`, `optimizer.AdamW` with the grad
   norm summed over the stages), the stages' ops taken one at a time so
   that each stage's launches and memory read off the card's counters.
   `picotron_tpu_torch/configs/llama2-7b-pp2-1gpu.json`:
   runs/llama2-7b-dp4tp2pp2-1f1b at its full width (hidden 4096,
   intermediate 11008, 32/32 heads, D 128, vocab 32000, seq 4096, mbs
   1, ga 8, bf16 over fp32 masters, bf16 moments, remat "dots"), dp 4
   -> 1, tp 2 -> 1, 32 layers -> 4 (2 per stage). Five walks, each on
   the same params (one seed) and batch as pp 1 on the card (the AD
   engine, the same remat): spmd afab, spmd 1f1b, mpmd 1f1b, mpmd gpipe
   and mpmd interleaved v 2 (one layer per virtual stage). Gates: each
   microbatch's loss within PP_LOSS_RTOL relative, every grad tensor
   within PP_GRAD_RTOL in relative L2, the same token count, the grad
   norm summed over the stages within PP_GRAD_RTOL; per stage its
   layers x n_micro forward launches (twice under remat "full") and its
   layers x n_micro of each backward kernel, all on the tensor cores,
   one AdamW launch per tensor it holds, and under the spmd 1f1b at
   most `pp_1f1b_ring_slots` graphs in flight; and a planted fault
   (stage 1 fed microbatch m+1's activation as m's) must fail. Printed
   per stage: its peak GiB (its state, the graphs it holds and an op's
   transient, read off the card around its own ops), the most graphs in
   flight against the ring slots, its launches and exchanges; each
   walk's wall time on the one card, with the stages serialised (not a
   pipeline's speed), beside `schedule_stats`'s predicted bubble; and a
   `pipeline` JSON line.
10. Generation and the serving engine (`generate.py`, `serve/`) on the
   main path's model, SmolLM-1.7B at full width and depth (CONFIG:
   24 layers, hidden 2048, 32/32 heads, D 64, vocab 49152), initialised
   on the card from SERVE_SEED (fp32, and a bf16 copy of the same
   params: the `--load-dtype bfloat16` load); decode is plain torch and
   launches no kernel of the port (asserted).
   (a) `generate` at batch 8, prompt 512, 128 new tokens, greedy, bf16:
   prefill ms, decode ms per step, tokens/s and the step's share of its
   bound (bf16 weight bytes plus the live K/V read, over 3.35 TB/s).
   Gates: the teacher-forced forward (`models/llama.forward` on prompt
   plus generated tokens, through the flash forward kernel: 24 launches,
   all tensor-core) puts each chosen token's logit within DECODE_MARGIN
   of its row's max; the cache-decode logits (the prompt prefilled, the
   generated tokens decoded one at a time: `generate`'s own steps) lie
   within DECODE_LOGIT_ATOL of the full forward's; and a planted fault,
   each token's K/V written one cache slot late, must fail.
   (b) In fp32 with TF32 off, the same 8 requests through `ServeEngine`
   (8 slots, block 16, prefill chunk 64, decode interval 4, a pool of
   SERVE_PARITY_BLOCKS blocks where the requests need 320 at their end,
   so at least one is preempted) and through `generate`: greedy tokens
   equal request by request, or, where a request parts, the offline
   logits' top-2 gap at that token below NEAR_TIE (the count printed);
   the n-gram speculative engine (draft_len 4) equal to the plain one;
   no block leaked.
   (c) bench.py's serve trace shape in bf16 (32 requests at t = 0,
   prompts 64-512, budgets 16-128; the same engine settings with the
   pool at its default): every decode dispatch runs under
   `torch.cuda.set_sync_debug_mode("error")`, so a host sync inside one
   fails the phase; no block leaked; the JSONL stream holds one
   serve_request per request and one serve_summary. Printed: TTFT and
   TPOT p50/p95, output tokens/s, ms per decode dispatch against its
   bound (and the capacity-sized view copy beside it), slot occupancy,
   pool utilisation, peak GiB, decode_compiles; and a `serving` JSON
   line.
11. Mixture of experts (`ops/moe.py`, the MoE model, ep) on
   `picotron_tpu_torch/configs/mixtral-8x7b-2l-1gpu.json`: the
   `mistralai/Mixtral-8x7B-v0.1` preset (hidden 4096, ffn 14336, 32/8
   heads, D 128, vocab 32000, 8 experts, top-2, rope theta 1e6) at
   bench.py's Mixtral row (seq 2048, mbs 2, remat "dots"), cut to 2 of
   its 32 layers, ga 64 -> 2, bf16 moments resident (no offload);
   weights from training.seed.
   (a) 3 steps through `train.run` with the counts from 0: ms/step,
   tokens/s, MFU (active params), peak GiB, `moe_drop_frac` per step,
   each flash kernel's launches (layers x ga x steps, all tensor-core)
   and the AdamW kernel's (one per tensor per step); the same 3 steps
   under the plain attention (`attn_impl: "reference"`), each step's
   loss within MOE_LOSS_ATOL; on the first microbatch, the share of
   (token, choice) assignments both paths route alike, at least
   MOE_ROUTE_AGREE; and a planted fault (the gates not renormalised over
   the k) must fail the loss limit.
   (b) The fused engine (remat "dots_attn") against the AD engine of
   (a) on its first step (the same params and batch; the AD loss must be
   (a)'s step-1 loss bit for bit), at phase 5's limits.
   (c) `moe_mlp` twice on one input at (a)'s shapes: out, expert_idx and
   slot bit for bit (the recompute contract of remat and the fused
   engine); its forward time.
   (d) ep 2 as a thread world of 2 ranks on the card (`ThreadEPComm`,
   `ThreadMean`: the ranks' graphs join at the exchanges, one backward
   over their summed losses), depth 1, capacity factor 8 (drop-free),
   against ep 1 on the same params and global batch (2 rows, one per
   rank): loss and grads at phase 8b's limits, 2 x layers all-to-alls
   per rank, the flash launches. It bypasses NCCL.
   (e) `generate` at B 8, prompt 512, 64 new tokens, greedy, capacity
   factor 8: prefill and decode ms, the bound share; in bf16 every
   chosen token within DECODE_MARGIN of the training forward's row max
   (flash) and the share of routes alike on the two paths; in fp32 with
   TF32 off the teacher-forced cache logits within MOE_DECODE_ATOL of
   the training forward's, and the planted fault of 10a past it.
   (f) The flash kernels alone at the Mixtral attention shape (B 2, S
   2048, Hq 32, Hkv 8, D 128, bf16, causal, fused RoPE): ms against the
   bound and SDPA's (phase 2 holds them to their plain versions there).
   A `moe` JSON line; the kernel JSON line gains each kernel's
   `moe_launches` and its `moe_shape` times.
12. The trainer as the JAX package runs it: telemetry, chaos, the packer.
   (a) Phase 3's config through the trainer's entry point (in process,
   the counts from 0) with the stream in `logging.telemetry_dir`, the
   span tracer (`trace_dir`), the sentinel, the flight recorder (8 steps)
   and two prefetch workers (`dataset.num_workers`). Gates: the losses
   are phase 3's bit for bit; each flash kernel launched 24 x ga x steps
   times on its tensor-core kernel and AdamW once per tensor per step;
   the stream holds run_start, each step's data/step/sync phases, the
   step records and run_summary; `tools/telemetry_report` accounts no
   more than the stream's wall (REPORT_SLACK_S); the trace holds one
   `step` span per step on the train lane; the median step (steps 2-4)
   within TELEMETRY_STEP_RTOL of phase 3's (both printed).
   (b) Chaos at full width and CHAOS_LAYERS layers, each run a child
   process of `python -m picotron_tpu_torch.train`, against one run
   without chaos: nan_grad@3 under guard "abort" exits 76 with a
   `divergence_abort` postmortem and steps 1-2 bit for bit; data_io@2x2
   with prefetch gives two `retry` events and the same losses;
   sigterm@3 exits 75 with a `preempted` postmortem and a restart under
   PICOTRON_CHAOS="" resumes at step 3 bit for bit; ckpt_io@2x1 with
   ckpt_corrupt_bitflip@4 (save_frequency 2) retries the step-2 save,
   and the restart reports `ckpt_corrupt` for step 4 and resumes from
   step 2 bit for bit; hang@3 under a WATCHDOG_S watchdog exits 77 with
   a `watchdog` postmortem. The save, retry, verify and load seconds are
   kept.
   (c) The native packer (csrc/packer.cpp, built with g++) against
   PyBlockPacker on PACKER_TOKENS tokens fed in ragged chunks: equal
   blocks; both throughputs (the host CPU's).
   A `telemetry` JSON line before the kernel line.
13. `logging.profile_dir`, elastic resize and the checkpoint tools.
   (a) Phase 3's config through the trainer's entry point (in process)
   with a torch.profiler window over steps PROFILE_WINDOW: the losses are
   phase 3's bit for bit; `tools.trace_summary` on its trace finds steps
   3-4 and, by `profile_step.kernel_class`, 24 x ga x 2 launches of each
   flash kernel and one AdamW launch per tensor per step (438); the top
   rows are printed.
   (b) CONFIG at ELASTIC_LAYERS layers (full width), mbs 2 x ga
   ELASTIC_GA, under a one-rank NCCL group with zero1 (phase 7a's
   layout), as child runs of the trainer: an uninterrupted run of 4
   steps; a run saved at step 2; `tools.elastic_resize --dp 2` then
   `--dp 1` (state/ byte for byte as before, meta.json back at mbs 2 x
   ga ELASTIC_GA, the step re-verified); step 2 restored without a
   process group and with zero1 off under checkpoint.elastic, and
   resumed under the group, each to step 4 with steps 3-4 bit for bit the
   uninterrupted run's. (One card: the multi-rank resizes stay in the
   CPU gloo tests, tests/test_torch_elastic.py.)
   (c) `tools.export_hf` of that store, read back with
   `load_hf_safetensors`: bit for bit `restore_params_only`'s params, and
   greedy `generate` (GEN_NEW tokens from a seeded prompt) equal from both.
   (d) `python -m picotron_tpu_torch.tools.chaos --device cuda --scenario
   ckpt_corrupt_bitflip` at the tool's own scenario config exits 0.
   An `elastic` JSON line with each sub-phase's seconds (the save, deep
   verify, re-split read/write and restore seconds among them).
14. Disaggregated serving and the serving fleet (`serve/disagg.py`,
   `serve/fleet.py`, `tools/serve_bench.py`) on phase 10's SmolLM-1.7B
   (full width and depth, the same seeded weights), every replica and
   both pools on the one card. (a) In fp32 with TF32 off, phase 10b's
   8 requests under its cut pool through `DisaggServeEngine` and
   `ServeEngine`: greedy tokens equal, both preempting, no block leaked;
   in bf16 the long-prefill burst (`serve_bench.make_burst_trace`, 8
   short and 8 long FLEET_BURST prompts) through both engines: the max
   consecutive decode-stall ticks of each (disagg below colocated), the
   handoffs, and each handoff's device ms by CUDA events around
   `_copy_blocks` against its bound; every decode dispatch and every
   handoff under `torch.cuda.set_sync_debug_mode("error")`. (b)
   `serve_bench.run_serve_fleet` at temperature 0.7 on FLEET_TRACE
   (Poisson arrivals on the virtual clock): a fleet of 2 with FLEET_KILL
   fired mid-burst against a fleet of 1: every request's token digest
   equal, 0 leaked blocks, the killed engine holding requests in flight,
   a `serve_engine_dead` postmortem, the peak GiB. (c) The
   `serve_overload` shape on the card (OVERLOAD: a burst into 1 slot
   under a deadline), twice: the shed ids and digests equal, completed +
   shed = submitted, the admitted queue wait within the deadline. No
   flash or AdamW kernel launches in the phase. A `serving_fleet` JSON
   line before the card line.
15. The tp strategies and the hierarchical dp reduction
   (`parallel/tp_strategies.py`, `parallel/hier_reduce.py`), each rank a
   thread on the one card (`GroupWorld`; NCCL takes one rank per card).
   The collectives are `ThreadGroup`s: clones handed between the threads
   (sums in rank order), reached through the port's communicator seam
   (`parallel/comm.GroupComm` and the process-group hooks of its module
   functions); the ones whose backward communicates join the ranks'
   graphs, so the AD twins run ONE backward from this thread over the
   ranks' summed losses, and the fused engine's ranks take their
   transposes on their own threads. (a) Llama-3-8B at full width
   (TP_RUN's model: 32/8 heads, D 128, vocab 128256), TP_LAYERS of 32
   layers, tp 4, dp/cp/pp 1, mbs 1, ga 1, flash attention, from one
   seeded init transplanted into every layout (TP_LAYOUTS): megatron,
   "2d" at 2 x 2, "row" and "qkv=2d,o=2d" without SP, megatron + SP and
   tp_sync "deferred" with it, and "adaptive" (resolved by the cost model
   on the h100 tier, its spec printed; its fp32 losses equal to the named
   layout of the same spec bit for bit), each under the fused engine
   (remat "dots_attn") and the two megatron twins also under AD. In fp32 at
   TP_SEQ_FP32 (TF32 off): 3 steps' losses and the step-1 grad norm
   within TP_LOSS_RTOL of the twin's AD run. In bf16 at the run's seq
   TP_SEQ: per rank the flash launches (TP_LAYERS per step per kernel,
   all at the layout's heads: 8/2, 16/4 or 32/8, all on the tensor-core
   kernels), one forward's collectives by kind equal to
   `tp_strategies.forward_collectives` (the JAX docstring's schedule),
   the step's collectives by kind, ms/step and the peak GiB of the world
   of 4 ranks (a thread world on one card: not a tp speed). (b) CONFIG's
   SmolLM-1.7B at HIER_LAYERS layers, fp32, seq 2048, a thread world of
   dp HIER_DP over HIER_SLICES slices (inner 2): one step's grads by the
   hierarchical reduction equal on every rank and within HIER_GRAD_RTOL
   (relative L2, per tensor) of the flat all-reduce's, the legs by kind
   (one reduce-scatter and one all-gather in the slice, one all-reduce
   across it), and the cross-slice leg's bytes 1/inner of the flat
   all-reduce's. A `tp_strategies` JSON line before the card line.
16. Shardcheck (`picotron_tpu_torch/analysis/`: one step recorded on
   `meta` through recording groups, audited): (a) phase 3's trainer ran
   with its preflight on: its `shardcheck preflight: ok` line, and the
   preflight's seconds at full SmolLM-1.7B (the phases after 3 run with
   PICOTRON_PREFLIGHT=0: the preflight is static analysis of a config,
   and phase 3's is the one this phase reads); (b) for each of phase
   15a's bf16 legs at tp 4, and for one train step of 15b's slice layout
   (dp HIER_DP over HIER_SLICES slices, the hierarchical reduction,
   `train_step.make_train_step` on each thread rank), the schedule every
   thread rank really issued on the card (each `ThreadGroup` call, by
   kind, the group's ranks and the bytes the rank handed in or took out)
   equals that rank's meta recording (`record_train_step(cfg, rank=r)`,
   times the steps run), and `run_shardcheck` is green on the recorded
   step; (c) `analysis/variants.check_engine_feed` on phase 10c's engine
   (CUDA tensors): proven, every persistent input on the card, no
   `variant_hazard` event. A `shardcheck` JSON line before the card line.
17. Numbers, then the device line last. The numbers include the cost
   model's (`cost_model_phase`): the h100 tier's predicted ms/step for
   each measured point of this run (phases 3, 5b, each 5c policy, 6c and
   11a) beside the measurement, their ratio (each within COST_RATIO),
   the Spearman rank agreement of tokens/s (the ordering result) and of
   ms/step, and the calibration these points fit (FIT_KEYS); a
   `cost_model` JSON line before the card line.

Tolerance (phase 2), per row of each output (a row is one token's D values
of out, dq, dk or dv): ||kernel - plain||_2 <= 1e-2 * ||plain||_2 (a row
whose RMS is below 1e-3 counts as RMS 1e-3), and |kernel - plain| <= 2e-3
on each fp32 lse entry. Both versions take bf16 inputs, multiply exactly
in fp32, and round the rotated q/k to bf16 at the same points; the
kernels also round P and dS to bf16 before their products, as the TPU
kernels do, where the plain version keeps them in fp32. They differ
besides in the order of fp32 sums (and the tensor cores' fp32
accumulation), in the forward normalising P after (the plain version
before) its bf16 rounding, and in exp (the tensor-core kernels take
ex2.approx of a shifted x log2 e; in the rotations and their inverses
they round each product as the plain version does), so a bf16 rounding
may land one ulp apart. A row then differs by a few bf16 half-ulps (2^-9
= 2e-3 relative each: the output's own rounding plus the P or dS
roundings of a row with few terms); the worst row over the three shapes
measures under 6e-3, and the worst lse entry of the tensor-core forward
about 1e-6 (NVIDIA H100 80GB HBM3 at 700 W; phase 2 prints both per
shape, PERF.md has the run's numbers). The limit is relative per row,
not against the largest value in the tensor, so a row of small values (a
long causal row's output, a late key's gradient) is held as tightly as
the largest row. tests/test_torch_cuda.py plants faults in copies of the
kernel source and checks that each fails this limit: a mask off by one
(in all rows, or only in rows at position 1024 and later), the diagonal
tile taken as full, the last tile of the inner loop skipped, and the LSE
cotangent left out of delta, in the tensor-core forward P packed from
the wrong S n-tile, in the tensor-core dq one row's delta taken for
another's, and in the tensor-core dk/dv the last GQA head of the inner
loop dropped.

Phase 4's limits: EVAL_ATOL = 5e-3 absolute on a loss near 11: the two
attention paths take the same bf16 q/k/v and differ by the kernels' bf16
rounding of P (the plain version keeps it in fp32) and the order of fp32
sums, which the per-row phase-2 limit bounds at 1e-2 relative per row of
out; averaged over 8192 tokens the loss moves by far less.

Phase 5's limits: GRAD_RTOL = 1e-2 per grad tensor, ||g_fused - g_ad||_2
<= 1e-2 * ||g_ad||_2. The engines run the same bf16 products, but the
fused engine accumulates each weight grad in fp32 inside the GEMM where
autograd rounds the microbatch's dW to bf16 (2^-9 relative per element)
before its fp32 add, and it sums the dX products of q/k/v and gate/up in
another order; the bf16 dW rounding alone is ~2e-3. LOSS_ATOL = 1e-3: the
forward ops are the same, so the loss is expected bit for bit. The chunked
CE runs the same bf16 head products as the unchunked CE and merges the
chunks' fp32 (max, sumexp) pairs: CE_LOSS_RTOL = 1e-3 on the loss and
CE_GRAD_RTOL = 1e-2 on the grads (its dlogits round to bf16 per chunk, as
the unchunked CE's do).

Phase 6's limits: the AdamW kernel is held to its plain version bit for
bit. Both take every fp32 operation in the same order, rounded on its
own (the kernel with the __f*_rn intrinsics, so nvcc cannot contract a
multiply-add into an FMA; the plain version in separate torch ops, its
divisions by c1 and c2 by 0-dim device tensors, which PyTorch divides,
where a Python-scalar divisor would be a multiplication by its
reciprocal), and round to bf16 to nearest even. Phase 6b holds the
streamed update (the replay) and offload against the rounded resident
run bit for bit. Against the plain resident run the matmul weights take
the same grads (both scaled by 1 / count in the update), so their step-1
updates are held to OFFLOAD_RTOL = 1e-5 (measured 0); the norm weights'
and embedding's grads round to bf16 under offload only, and from step 2
the offload forward uses bf16 norm weights, so OFFLOAD_UPDATE_RTOL = 0.1
holds their step-1 updates and every step-3 update. Measured (NVIDIA
H100 80GB HBM3, 700 W; PERF.md): step 1 norms 0.034 at worst, the
embedding 5.2e-4; step 3 0.024 at worst; the planted faults 1.0 (the
embedding's slices skipped or its grad lost, steps 1 and 3) and 0.46 to
0.50 on every tensor after step 3 (the moments not copied back).

Phase 8's limits: 8a uses phase 2's per-row limits. Against the whole
sequence the ring and mesh add the merge (each block's out rounded to
bf16, merged in fp32) and each block's grads rounded to bf16 before
their fp32 sum: measured worst rows 4.9e-3 (out) and 7.9e-3 (dq)
(NVIDIA H100 80GB HBM3, 700 W; PERF.md); Ulysses' inner call is the
whole sequence's own (0 measured). 8b: CP_LOSS_RTOL = 5e-6 and
CP_GRAD_RTOL = 2e-2, set between the measured readings (loss 1.3e-6,
grads 6.7e-3 relative L2 at worst, layers.1.k) and the planted fault's
(loss 1.1e-5, grads 1.24): the cp-1 model runs the same bf16 products
but its attention in one kernel call per layer, where cp rounds each
block's out and grads to bf16 before the fp32 merge or sum.

Phase 9's limits: the stages run the same bf16 products on the same
shapes as pp 1, and the boundary tensor keeps pp 1's dtype (bf16), so
the losses and grads are expected bit for bit where the schedule keeps
pp 1's order of the microbatches' grad sums (1f1b, gpipe, interleaved);
afab sums them in reverse. PP_LOSS_RTOL = 1e-6 and PP_GRAD_RTOL = 1e-3
bound what the order of fp32 sums can move; the actual errors print
beside them.

Phase 10's limits: the cache decode and the full forward take the same
bf16 params and tokens, and differ in their op order and shapes (the
einsum attention against the flash kernel, one token against 640 per
GEMM), so their bf16 logits (std ~0.6 on these random weights) differ
at round-off: measured 0.033 (logits) and 0.031 (margin), against the
planted fault's 0.236 and 0.141 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
DECODE_LOGIT_ATOL = 0.1 and DECODE_MARGIN = 0.07 sit between. In fp32
with TF32 off the engine's chunked prefill and the offline one-pass
prefill differ at fp32 round-off (~1e-5 on the logits): a request may
part from `generate` only where the offline top-2 gap is below
NEAR_TIE = 1e-3, 100 times that (none parted in the measured run).

Phase 11's limits: (a) MOE_LOSS_ATOL = 1e-4 on each step's loss, flash
against the plain attention: the same bf16 products but attention's
(the per-row limit of phase 2), and a route that flips on a near tie.
Measured 3.6e-5 at worst over 3 steps, the planted fault (gates not
renormalised) 2.4e-4 at step 1 (the loss of random weights near ln V
moves little with the MoE output's scale); routes alike on 0.99927 of
the assignments, MOE_ROUTE_AGREE = 0.99 (NVIDIA H100 80GB HBM3, 700 W;
PERF.md). (b), (d): phases 5 and 8b's limits (measured: fused against
AD 6.5e-3 at worst, layers.0.input_norm, the loss bit for bit; ep 2
against ep 1 the loss bit for bit, grads 2.4e-3 at worst). (e) In bf16
the cache and the forward route 0.13% of the assignments apart on near
ties, and a token routed elsewhere moves its logits by more than phase
10's limit (0.168 measured), so the logits are held in fp32 with TF32
off, where no route flips: MOE_DECODE_ATOL = 1e-4, measured 9.5e-6, the
planted fault 3.2e-3 over 16 tokens (2 layers of random weights attend
nearly uniformly over 512+ keys, so one missing key moves the logits
far less than phase 10's 24 layers do; phase 10's 0.1 could not see
it). The greedy tokens are held in bf16 by the margin (0.0 measured).

Phase 15's limits: TP_LOSS_RTOL = 1e-4 relative on each fp32 loss and the
step-1 grad norm against the twin's AD run. The strategies change only
which ranks sum which partial products (2d sums the row products over
tx, not tp; row-first sums the entry products and gathers the exit), so
in fp32 with TF32 off the losses move by reassociation alone: measured
0 (2d, SP, deferred) to 1.8e-7 (qkv=2d,o=2d) (NVIDIA H100 80GB HBM3, 700
W; PERF.md). The grad norm is in the check because Adam hides a grad
off by a constant factor (a tp_y too many) from the losses: the norm
would move by that factor. HIER_GRAD_RTOL = 1e-6 relative L2 per
tensor: the hierarchical and the flat schedule add the same four fp32
grads in another order (measured 4.4e-8 at worst).

Needs one card; exits non-zero with no result when CUDA is absent or when
run without the rest of the repository.

    python3 chip_smoke.py --main-path TREE [TREE ...]

runs only phase 3 of each tree's own chip_smoke.py (a checkout, or a
commit unpacked with `git archive`), in the order given, and fails
unless every tree's losses are equal bit for bit (a change that keeps
the main path's ops shows it against its parent: parent, change,
change, parent).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

ROW_RTOL = 1e-2               # per-row relative L2 error of out/dq/dk/dv
ROW_FLOOR = 1e-3              # row RMS below which the limit is absolute
LSE_ATOL = 2e-3               # absolute error of each fp32 lse entry
STEPS, GA, MBS, SEQ = 4, 2, 2, 2048
TP2D_LABEL = "llama3-8b 2d 2x2 B1 S2048 Hq16 Hkv4 D128 rope static"
# phase-2 shapes: (b, hq, hkv, sq, sk, d, q position shift); a nonzero
# shift makes explicit positions and a nonzero LSE cotangent
SLICE_SHAPE = (2, 32, 32, SEQ, SEQ, 64, 0)
SHAPES = {
    "slice B2 S2048 H32 D64 rope static": SLICE_SHAPE,
    "gqa B1 S2048 Hq32 Hkv8 D128 rope static": (1, 32, 8, SEQ, SEQ, 128, 0),
    "shifted B1 Sq1024 Sk2048 Hq8 Hkv2 D64 rope dlse": (1, 8, 2, 1024, SEQ,
                                                         64, 1024),
    # the per-rank heads of tp 4: SmolLM-1.7B (32/32 heads) and Llama-3-8B
    # (32/8 heads, D 128)
    "smollm17 tp4 B2 S2048 Hq8 Hkv8 D64 rope static": (2, 8, 8, SEQ, SEQ,
                                                       64, 0),
    "llama3-8b tp4 B1 S2048 Hq8 Hkv2 D128 rope static": (1, 8, 2, SEQ, SEQ,
                                                         128, 0),
    # the per-rank heads of Llama-3-8B under the 2d tp strategy at tp 4 =
    # 2 x 2 (phase 15: heads / tp_x)
    TP2D_LABEL: (1, 16, 4, SEQ, SEQ, 128, 0),
    # each pipeline stage of phase 9 (PP_CONFIG: Llama-2-7B, 32/32 heads)
    "llama2-7b pp B1 S4096 H32 D128 rope static": (1, 32, 32, 4096, 4096,
                                                   128, 0),
    # phase 11's attention (Mixtral-8x7B: 32/8 heads, D 128)
    "mixtral B2 S2048 Hq32 Hkv8 D128 rope static": (2, 32, 8, SEQ, SEQ,
                                                    128, 0),
}
# the head dim whose bf16 dq and dk/dv run bwd_dq_wgmma_kernel and
# bwd_dkv_wgmma_kernel (after their shared rotation pre-pass); the ops
# module's WGMMA_HEAD_DIMS, checked in main
WGMMA_D = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
KERNELS = [  # (counter name, TPU kernel it replaces)
    ("flash_fwd", "picotron_tpu/ops/flash_attention.py:139"),
    ("flash_bwd_dq", "picotron_tpu/ops/flash_attention.py:327"),
    ("flash_bwd_dkv", "picotron_tpu/ops/flash_attention.py:412"),
]
# each kernel's launches by variant (bf16 tensor-core, fp32 CUDA-core)
VARIANT_COUNTS = ("fwd_launches", "dq_launches", "dkv_launches")
SOURCE = "picotron_tpu_torch/csrc/flash_attention.cu"
ADAMW_SOURCE = "picotron_tpu_torch/csrc/adamw.cu"
# no Pallas kernel: the JAX package's AdamW is XLA's fusion of this math
ADAMW_REPLACES = ("no Pallas kernel: XLA-fused in the JAX package, "
                  "picotron_tpu/optimizer.py:208")
ADAMW_SIZES = (1, 7, 8, 13, 1000, 65536 + 3, 4 * 2 ** 20 + 5)
OFFLOAD_CONFIG = "picotron_tpu_torch/configs/smollm17-1gpu-offload.json"
OFFLOAD_STEPS = 3
OFFLOAD_RTOL = 1e-5            # step-1 matmul updates vs resident, rel L2
OFFLOAD_UPDATE_RTOL = 0.1      # the other updates vs resident, rel L2
OFFLOAD_FAULTS = ("moments_not_copied_back", "embedding_slices_skipped",
                  "embedding_grad_lost")
CONFIG = "picotron_tpu_torch/configs/smollm17-1gpu-seq2048.json"
CKPT_DIR = "build/smoke_ckpt"
EVAL_STEPS = 2
EVAL_ATOL = 5e-3               # val_loss: forward kernel vs plain attention
RESUME_SPREAD_FACTOR = 4       # resumed losses vs phase 3, if not bitwise
FUSED_CONFIG = "picotron_tpu_torch/configs/smollm17-1gpu-seq2048-fused.json"
REMAT_POLICIES = ("full", "dots", "dots_attn", "dots_lean", "dots_norms",
                  "dots_offload")
COST_RATIO = 2.0               # cost model: predicted vs measured step
GRAD_RTOL = 1e-2               # per grad tensor: fused vs AD engine
LOSS_ATOL = 1e-3               # step-1 loss across engines and policies
CE_CHUNK = 8192
CE_LOSS_RTOL = 1e-3            # chunked vs unchunked CE loss
CE_GRAD_RTOL = 1e-2            # chunked vs unchunked CE grads, relative L2
PARALLEL_CONFIG = "picotron_tpu_torch/configs/smollm17-1gpu-dp-zero1.json"
PARALLEL_STEPS = 3             # the config's max_tokens
PARALLEL_OFFLOAD_GA = 4        # phase 7b: the offload config at ga 4
PARALLEL_OFFLOAD_STEPS = 2
TRAIN_TIMEOUT_S = 300          # one child run of the trainer
# phase 8: runs/llama2-7b-cp4-seq8192's attention (B 1, S 8192, Hq = Hkv
# = 32, D 128) and model at depth CP_LAYERS, over CP ranks on one card
CP, CP_SEQ, CP_LAYERS = 4, 8192, 2
CP_SHAPE = (1, CP_SEQ, 32, 32, 128)
CP_SCHEDULES = {  # name: (cp flavor, cp_layout, cp_mesh)
    "ring zigzag": ("ring", "zigzag", ""),
    "ring contiguous": ("ring", "contiguous", ""),
    "ulysses zigzag": ("ulysses", "zigzag", ""),
    "mesh 2x2 zigzag": ("mesh", "zigzag", "2x2"),
}
# each kernel's launches per rank per call: the contiguous ring skips the
# blocks entirely in rank r's future on the host
CP_LAUNCHES = {"ring zigzag": lambda r: CP,
               "ring contiguous": lambda r: r + 1,
               "ulysses zigzag": lambda r: 1,
               "mesh 2x2 zigzag": lambda r: 2}
CP_MODEL_SEED = 10
CP_LOSS_RTOL = 5e-6            # phase 8b: loss, cp 4 vs cp 1, relative
CP_GRAD_RTOL = 2e-2            # phase 8b: each grad tensor, relative L2
THREAD_TIMEOUT_S = 600         # a thread world's barrier
# phase 9: runs/llama2-7b-dp4tp2pp2-1f1b at full width, 4 layers, pp 2 in
# a thread world, each walk against pp 1 on the same params and batch
PP_CONFIG = "picotron_tpu_torch/configs/llama2-7b-pp2-1gpu.json"
PP_WALKS = {  # name: config sections over PP_CONFIG's
    "spmd afab": {"distributed": {"pp_engine": "afab"}},
    "spmd 1f1b": {},
    "mpmd 1f1b": {"pipeline": {"executor": "mpmd", "schedule": "1f1b"}},
    "mpmd gpipe": {"pipeline": {"executor": "mpmd", "schedule": "gpipe"}},
    "mpmd interleaved v2": {"pipeline": {"executor": "mpmd",
                                         "schedule": "interleaved",
                                         "interleave": 2}},
}
PP_FAULT = "planted fault: spmd 1f1b, stage 1 fed microbatch m+1 as m"
PP_SEED = 11
PP_LOSS_RTOL = 1e-6            # phase 9: each microbatch's loss, relative
PP_GRAD_RTOL = 1e-3            # phase 9: each grad tensor, relative L2
# phase 10: serving on CONFIG's model (SmolLM-1.7B, full width and depth)
SERVE_SEED = 12
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 128
SERVE_SCFG = {"decode_slots": 8, "block_size": 16, "prefill_chunk": 64,
              "decode_interval": 4, "max_model_len": 640}
SERVE_PARITY_BLOCKS = 288      # 10b: the 8 requests need 320 at the end
SERVE_DRAFT_LEN = 4
SERVE_TRACE = (32, 512, 128)   # 10c: requests, most prompt, most budget
DECODE_MARGIN = 0.07           # 10a: chosen logit below its row's max
DECODE_LOGIT_ATOL = 0.1        # 10a: cache-decode vs full forward logits
NEAR_TIE = 1e-3                # 10b: top-2 gap where a request may part
# phase 11: Mixtral-8x7B's full-width layers (2 of 32), seq 2048, mbs 2
MOE_CONFIG = "picotron_tpu_torch/configs/mixtral-8x7b-2l-1gpu.json"
MOE_SHAPE = (2, 32, 8, SEQ, SEQ, 128, 0)  # its attention: GQA 32:8, D 128
MOE_SEED = 13
MOE_NEW = 64                   # 11e: new tokens
MOE_LOSS_ATOL = 1e-4           # 11a: flash vs plain attention, each step
MOE_ROUTE_AGREE = 0.99         # 11a: share of assignments alike
MOE_DECODE_ATOL = 1e-4         # 11e: fp32 cache vs forward logits
# phase 12: the trainer's telemetry, chaos and the native packer
TELEMETRY_DIR = "build/smoke_telemetry"
TELEMETRY_STEP_RTOL = 0.05     # 12a: median step vs phase 3's, relative
REPORT_SLACK_S = 1e-3          # 12a: the report's accounted <= its wall
CHAOS_DIR = "build/smoke_chaos"
CHAOS_LAYERS = 4               # 12b: CONFIG's model cut to 4 layers
WATCHDOG_S, HANG_S = 5.0, 120  # 12b: hang@3~HANG_S under this watchdog
PACKER_TOKENS = 100_000_000    # 12c: tokens through both packers
# phase 13: logging.profile_dir, elastic resize and the checkpoint tools
PROFILE_DIR = "build/smoke_profile"
PROFILE_WINDOW = (3, 2)        # 13a: the run-relative steps 3-4
ELASTIC_DIR = "build/smoke_elastic"
ELASTIC_LAYERS, ELASTIC_GA = 4, 4  # 13b: CONFIG at 4 layers, mbs 2 x ga 4
ELASTIC_SEED = 14              # 13c: the prompt
GEN_NEW = 16                   # 13c: greedy tokens from each load
# phase 14: disaggregated serving and the fleet on phase 10's model
FLEET_DIR = "build/smoke_fleet"
FLEET_BURST = (512, 128)       # 14a: the burst's long prompt, most budget
FLEET_TRACE = (16, 512, 64, 500.0)  # 14b: requests, most prompt, most
#                                     budget, arrivals/s (virtual clock)
FLEET_KILL = "engine_dead@5"   # 14b: request 5's engine dies as it routes
OVERLOAD = (10, 6.0)           # 14c: a burst into 1 slot, deadline ms
# phase 15: the tp strategies on runs/llama3-8b-4d-v5p64's model (full
# width, TP_LAYERS of 32 layers, tp 4 as a thread world on the one card)
# and the hierarchical dp reduction on CONFIG's model
TP_RUN = "runs/llama3-8b-4d-v5p64/config.json"
TP, TP_LAYERS, TP_STEPS = 4, 2, 3
TP_SEQ, TP_SEQ_FP32 = 8192, 2048  # the run's seq (bf16), the fp32 legs'
TP_SEED = 15
TP_LAYOUTS = {  # name: (distributed overrides, the twin it is held to)
    "megatron": ({}, None),
    "2d 2x2": ({"tp_strategy": "2d", "tp_mesh": "2x2"}, "megatron"),
    "row": ({"tp_strategy": "row"}, "megatron"),
    "qkv=2d,o=2d": ({"tp_strategy": "qkv=2d,o=2d", "tp_mesh": "2x2"},
                    "megatron"),
    "megatron sp": ({"sequence_parallel": True}, None),
    "deferred": ({"sequence_parallel": True, "tp_sync": "deferred"},
                 "megatron sp"),
    # resolved on the h100 tier by the cost model (`tp_adaptive`)
    "adaptive": ({"tp_strategy": "adaptive"}, "megatron"),
}
TP_HEADS = {  # each rank's (q heads, kv heads): Llama-3-8B's 32/8 under
    "megatron": (8, 2), "megatron sp": (8, 2), "deferred": (8, 2),
    "2d 2x2": (16, 4), "qkv=2d,o=2d": (16, 4), "row": (32, 8)}
TP_PAIR_HEADS = {"col": (8, 2), "2d": (16, 4), "row": (32, 8)}
TP_LOSS_RTOL = 1e-4            # 15a: fp32 losses and norm vs the twin's
HIER_DP, HIER_SLICES, HIER_LAYERS, HIER_SEED = 4, 2, 2, 16
HIER_GRAD_RTOL = 1e-6          # 15b: each grad tensor vs flat, rel L2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_case(fa, rope_tables, b, hq, hkv, sq, sk, d, shift, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    q, k, v = r(b, hq, sq, d), r(b, hkv, sk, d), r(b, hkv, sk, d)
    q = q * torch.tensor(d ** -0.5, dtype=torch.bfloat16)  # the wrapper's fold
    qpos = torch.arange(shift, shift + sq, device=dev, dtype=torch.int32)
    kpos = torch.arange(sk, device=dev, dtype=torch.int32)
    cos, sin = rope_tables(max(sk, shift + sq), d, device=dev)
    tabs = fa._tables((cos, sin), qpos, kpos)
    do = r(b, hq, sq, d)
    dlse = (torch.randn(b, hq, sq, generator=g, device=dev)
            if shift else torch.zeros(b, hq, sq, device=dev))
    return q, k, v, qpos, kpos, tabs, do, dlse, shift == 0


def row_errors(got, want, lse: bool = False) -> torch.Tensor:
    """Error of each row, flattened: |got - want| per fp32 lse entry, else
    ||got - want||_2 / ||want||_2 over the last axis, where a row whose RMS
    is below ROW_FLOOR counts as ROW_FLOOR (a row that cancels to ~0, such
    as dq of a row that sees one key, is held to an absolute limit)."""
    diff = got.float() - want.float()
    if lse:
        return diff.abs().flatten()
    floor = ROW_FLOOR * want.shape[-1] ** 0.5
    return (diff.norm(dim=-1) / want.float().norm(dim=-1).clamp_min(floor)
            ).flatten()


def bwd_fp64(fa, q, k, v, out, lse, do, dlse, qpos, kpos, tabs):
    """The backward kernels' function (`fa.bwd_plain`'s) in fp64, one
    (batch, q head) at a time: q and k rotated and rounded as the kernels
    and `fa.bwd_plain` rotate them, every product and the inverse rotation
    in fp64, nothing rounded after. The kernels' dq, dk and dv are held to
    it: `fa.bwd_plain` runs in fp32, and on a row whose exact dq is 0 (a
    row that sees one key, its dS = dO.v - dO.out cancels) its own fp32
    noise is as large as the kernel's, so that the two can differ by more
    than the row limit where neither is wrong. Returns fp64 [B, H, S, D]
    tensors."""
    if tabs is not None:
        q = fa._rot(q, tabs[0], tabs[1], 1.0)
        k = fa._rot(k, tabs[2], tabs[3], 1.0)
    q, k, v, do, out = (x.double() for x in (q, k, v, do, out))
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    visible = qpos[:, None].long() >= kpos[None, :].long()
    dq = torch.empty_like(q)
    dk = torch.zeros(b, hq, k.shape[2], d, dtype=torch.float64,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(b):
        for h in range(hq):
            kh, vh = k[i, h // rep], v[i, h // rep]
            lse_h = lse[i, h, :, None].double()
            p = torch.exp(torch.where(visible, q[i, h] @ kh.T,
                                      float("-inf")) - lse_h)
            p = torch.where(torch.isneginf(lse_h), 0.0, p)
            delta = ((do[i, h] * out[i, h]).sum(-1, keepdim=True)
                     - dlse[i, h, :, None].double())
            ds = p * (do[i, h] @ vh.T - delta)
            dq[i, h] = ds @ kh
            dk[i, h] = ds.T @ q[i, h]
            dv[i, h] = p.T @ do[i, h]
    dk = dk.view(b, hkv, rep, -1, d).sum(2)
    dv = dv.view(b, hkv, rep, -1, d).sum(2)
    if tabs is not None:
        def unrotate(x, c, sn):
            c, sn = c.double(), sn.double()
            x1, x2 = x[..., :d // 2], x[..., d // 2:]
            return torch.cat([x1 * c + x2 * sn, x2 * c - x1 * sn], dim=-1)

        dq = unrotate(dq, tabs[0], tabs[1])
        dk = unrotate(dk, tabs[2], tabs[3])
    return dq, dk, dv


def kernel_errors(fa, case) -> dict:
    """Each kernel output against its plain version on one case:
    {output: (kernel name, row errors, max abs error, max |plain|)}. The
    backward kernels start from the plain forward's (out, lse), so each
    kernel is held to its own plain version alone: the forward to
    `fa.fwd_plain`, the backward to its function in fp64 (`bwd_fp64`;
    `fa.bwd_plain`'s own worst row against it is logged beside)."""
    q, k, v, qpos, kpos, tabs, do, dlse, static = case
    out, lse = fa.fwd_kernel(q, k, v, qpos, kpos, tabs, True, static)
    out_p, lse_p = fa.fwd_plain(q, k, v, qpos, kpos, tabs, True)
    dq, dk, dv = fa._bwd(q, k, v, out_p, lse_p, do, dlse, qpos, kpos, tabs,
                         True, static)
    dq_p, dk_p, dv_p = bwd_fp64(fa, q, k, v, out_p, lse_p, do, dlse, qpos,
                                kpos, tabs)
    fp32 = fa.bwd_plain(q, k, v, out_p, lse_p, do, dlse, qpos, kpos, tabs,
                        True)
    log("  fa.bwd_plain against fp64, worst row: " + ", ".join(
        f"{key} {float(row_errors(g, w).max()):.4g}"
        for key, g, w in zip(("dq", "dk", "dv"), fp32, (dq_p, dk_p, dv_p))))
    del fp32
    res = {}
    for key, name, got, want in (
            ("out", "flash_fwd", out, out_p), ("lse", "flash_fwd", lse, lse_p),
            ("dq", "flash_bwd_dq", dq, dq_p), ("dk", "flash_bwd_dkv", dk, dk_p),
            ("dv", "flash_bwd_dkv", dv, dv_p)):
        res[key] = (name, row_errors(got, want, lse=key == "lse"),
                    float((got.float() - want.float()).abs().max()),
                    float(want.float().abs().max()))
    torch.cuda.synchronize()
    return res


def compare(fa, case, errs: dict, label: str) -> None:
    """Raise unless every row of every output is within its limit; `errs`
    keeps the largest absolute error per kernel."""
    for key, (name, rows, abs_err, scale) in kernel_errors(fa, case).items():
        limit = LSE_ATOL if key == "lse" else ROW_RTOL
        worst = float(rows.max())
        errs[name] = max(errs.get(name, 0.0), abs_err)
        errs[(label, name)] = max(errs.get((label, name), 0.0), abs_err)
        log(f"  {key}: worst row err {worst:.4g} (limit {limit:g}), max abs "
            f"err {abs_err:.4g}, max |plain| {scale:.4g}")
        if not worst <= limit:
            bad = int((rows > limit).sum())
            raise AssertionError(f"{label}: {key} of {name}: {bad} of "
                                 f"{rows.numel()} rows over {limit:g}, worst "
                                 f"{worst:.4g}")
    log(f"compare {label}: ok")


def bounds(b, hq, hkv, sq, sk, d, shift) -> dict:
    """Least time per kernel, (ms, what bounds it, FLOPs): max(bytes / HBM
    rate, FLOPs / bf16 peak), counting each input read once and each output
    written once, and only the (q, k) pairs these positions make visible."""
    return bounds_at(b, hq, hkv, d, range(shift, shift + sq), range(sk),
                     rope=True)


def bounds_at(b, hq, hkv, d, qpos, kpos, rope: bool) -> dict:
    """`bounds` at explicit q and kv positions (any order): the pairs
    with q position >= kv position, the RoPE tables' bytes only with
    `rope`."""
    import numpy as np

    qpos, kpos = np.asarray(qpos), np.sort(np.asarray(kpos))
    sq, sk = len(qpos), len(kpos)
    pairs = b * hq * int(np.searchsorted(kpos, qpos, side="right").sum())
    qb, kvb = b * hq * sq * d * 2, b * hkv * sk * d * 2
    tab = (2 * (sq + sk) * (d // 2) * 4 if rope else 0) + (sq + sk) * 4
    row = b * hq * sq * 4
    # the rotation pre-pass that the Hopper dq and dk/dv share writes
    # rotated q and k and the kernels read them back: its bytes join the
    # dk/dv's bound (the dq is timed on the rotated pair)
    prepass = 2 * (qb + kvb) if rope and d == WGMMA_D else 0
    work = {
        # S = QK^T and O = PV
        "flash_fwd": (4 * d * pairs, qb + 2 * kvb + tab + qb + row),
        # S, dP = dO V^T, dQ = dS K
        "flash_bwd_dq": (6 * d * pairs, 2 * qb + 2 * kvb + tab + 2 * row + qb),
        # S, dP, dV = P^T dO, dK = dS^T Q
        "flash_bwd_dkv": (8 * d * pairs, 2 * qb + 2 * kvb + tab + 2 * row
                          + 2 * kvb + prepass),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes", flops)
    return out


def time_kernels(fa, case) -> dict:
    import torch.nn.functional as F

    q, k, v, qpos, kpos, tabs, do, dlse, static = case
    out, lse = fa.fwd_kernel(q, k, v, qpos, kpos, tabs, True, static)
    delta = fa._delta(do, out, dlse)
    t = {}
    t["flash_fwd"] = cuda_ms(
        lambda: fa.fwd_kernel(q, k, v, qpos, kpos, tabs, True, static))
    # the D-64 dq on the rotated q and k that the backward call shares
    # with dk/dv (whose time holds the pre-pass)
    wg = tabs is not None and fa._wgmma(q)
    q_rot, k_rot = ((fa.rope_rows(q, *tabs[:2]), fa.rope_rows(k, *tabs[2:]))
                    if wg else (q, k))
    t["flash_bwd_dq"] = cuda_ms(lambda: fa.bwd_dq_kernel(
        q_rot, k_rot, v, do, lse, delta, qpos, kpos, tabs, True, static, wg))
    t["flash_bwd_dkv"] = cuda_ms(lambda: fa.bwd_dkv_kernel(
        q, k, v, do, lse, delta, qpos, kpos, tabs, True, static))
    plain_fwd = cuda_ms(lambda: fa.fwd_plain(q, k, v, qpos, kpos, tabs, True),
                        iters=3, warmup=1)
    # the plain backward computes dq, dk and dv together
    plain_bwd = cuda_ms(lambda: fa.bwd_plain(q, k, v, out, lse, do, dlse, qpos,
                                             kpos, tabs, True),
                        iters=3, warmup=1)
    # SDPA yardstick: pre-rotated inputs (it does no RoPE), its own scale
    qr = fa._rot(q, tabs[0], tabs[1], 1.0).requires_grad_()
    kr = fa._rot(k, tabs[2], tabs[3], 1.0).requires_grad_()
    vr = v.clone().requires_grad_()
    n_rep = q.shape[1] // k.shape[1]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qr, kr.repeat_interleave(n_rep, 1), vr.repeat_interleave(n_rep, 1),
        is_causal=True, scale=1.0)
    lib_fwd = cuda_ms(sdpa)
    o = sdpa()
    # one backward call of SDPA computes dq, dk and dv together
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), do,
                                                  retain_graph=True))
    return {
        "flash_fwd": (t["flash_fwd"], plain_fwd, lib_fwd),
        "flash_bwd_dq": (t["flash_bwd_dq"], plain_bwd, lib_bwd),
        "flash_bwd_dkv": (t["flash_bwd_dkv"], plain_bwd, lib_bwd),
    }


def check_rope_rows(fa, case, label: str) -> None:
    """Raise unless the wgmma kernels' rotation pre-pass gives q and k bit
    for bit as its plain version `_rot` does."""
    q, k, _, _, _, tabs, *_ = case
    for what, x, c, s in (("q", q, *tabs[:2]), ("k", k, *tabs[2:])):
        got, want = fa.rope_rows(x, c, s), fa._rot(x, c, s, 1.0)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{label}: rope_rows of {what} differs from "
                                 f"_rot in {bad} of {got.numel()} entries")
    log(f"  rope_rows of q and k: equal to _rot bit for bit")


def sass_mma(build) -> dict:
    """Tensor-core instructions per kernel in the built library's SASS, by
    cuobjdump from the toolkit that built it: {mangled name: (HMMA, HGMMA)}
    (mma.sync and wgmma)."""
    lib = build.build("flash_attention")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {block.split("\n", 1)[0].strip():
            (block.count("HMMA"), block.count("HGMMA"))
            for block in sass.split("Function : ")[1:]}


def bf16_variants(key: str, n: int, d: int) -> dict:
    """The by-variant launch counts `key` (VARIANT_COUNTS) of n bf16
    launches at head dim d: the dq and dk/dv at WGMMA_D on their wgmma
    kernels, every other on the mma.sync one."""
    if key == "fwd_launches":
        return {"tensor_core": n, "cuda_core": 0}
    wg = n if d == WGMMA_D else 0
    return {"wgmma": wg, "tensor_core": n - wg, "cuda_core": 0}


def check_prepass(counts: dict, d: int, label: str) -> None:
    """Raise unless the rotation pre-pass ran twice (q, k) per backward
    call on the wgmma kernels, which dq and dk/dv share (one dk/dv launch
    per call; every model here uses RoPE)."""
    want = 2 * bf16_variants("dkv_launches", counts["launches"][
        "flash_bwd_dkv"], d)["wgmma"]
    if counts["prepass_launches"] != {"rope_rows": want}:
        raise AssertionError(f"{label}: rotation pre-pass launches "
                             f"{counts['prepass_launches']}, want {want}")


@torch.no_grad()
def seen_batch_loss(cfg, model) -> float:
    """The trained model's token-mean loss on the first step's batch."""
    from picotron_tpu_torch.data import MicroBatchDataLoader
    from picotron_tpu_torch.models.llama import loss_sum_count

    ids, tgt = next(MicroBatchDataLoader(cfg, "cuda"))
    total = count = 0
    for i in range(ids.shape[0]):
        s, c, _ = loss_sum_count(model, ids[i], tgt[i])
        total, count = total + float(s), count + int(c)
    return total / count


def main_path(fa, here: str, config: str = CONFIG) -> dict:
    from picotron_tpu_torch import train
    from picotron_tpu_torch.config import load_config

    from picotron_tpu_torch import optimizer as topt

    path = os.path.join(here, config)
    t = load_config(path).training
    if (t.seq_length, t.micro_batch_size, t.gradient_accumulation_steps,
            t.total_train_steps) != (SEQ, MBS, GA, STEPS):
        raise AssertionError(f"{config} is not the smoke shape")
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    result = train.main(["--config", path])
    torch.cuda.synchronize()
    result["launches"] = {**fa.launches, **topt.launches}
    n_tensors = len(list(result["state"].model.parameters()))
    for key in VARIANT_COUNTS:
        result[key] = dict(getattr(fa, key))
    result["prepass_launches"] = dict(fa.prepass_launches)
    losses = result["losses"]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the last loss is not below the first: {losses}")
    result["seen_batch_loss"] = seen_batch_loss(load_config(path),
                                                result.pop("state").model)
    if not result["seen_batch_loss"] < losses[0]:
        raise AssertionError(
            f"loss on the first batch did not fall: {losses[0]} at step 1, "
            f"{result['seen_batch_loss']} after {STEPS} steps")
    want = 24 * GA * STEPS
    for name, _ in KERNELS:
        if result["launches"][name] != want:
            raise AssertionError(f"{name} launched {result['launches'][name]} "
                                 f"times on the main path, want {want}")
    for key in VARIANT_COUNTS:
        if result[key] != bf16_variants(key, want, WGMMA_D):
            raise AssertionError(f"{key} by variant {result[key]}: want all "
                                 f"{want} on the tensor-core kernel (the "
                                 f"dq's and dk/dv's on the wgmma ones)")
    check_prepass({"launches": result["launches"],
                   "prepass_launches": result["prepass_launches"]},
                  WGMMA_D, "main path")
    if result["launches"]["adamw"] != n_tensors * STEPS:
        raise AssertionError(f"adamw launched {result['launches']['adamw']} "
                             f"times on the main path, want one per tensor "
                             f"per step, {n_tensors * STEPS}")
    return result


def launch_counts(fa) -> dict:
    return {"launches": dict(fa.launches),
            **{key: dict(getattr(fa, key)) for key in VARIANT_COUNTS},
            "prepass_launches": dict(fa.prepass_launches)}


def check_launches(counts: dict, want: dict, label: str,
                   d: int = WGMMA_D) -> None:
    """Raise unless each kernel launched `want[name]` times, every launch
    on its tensor-core kernel for head dim d (`bf16_variants`), with the
    shared rotation pre-pass beside the wgmma ones."""
    for (name, _), key in zip(KERNELS, VARIANT_COUNTS):
        n = want[name]
        if counts["launches"][name] != n or counts[key] != bf16_variants(
                key, n, d):
            raise AssertionError(
                f"{label}: {name} launched {counts['launches'][name]} times "
                f"({key} {counts[key]}), want {n}, all on the tensor cores "
                f"(D {d})")
    check_prepass(counts, d, label)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def worst_grad(got: dict, want: dict):
    """(largest relative L2 error over the grad tensors, its name)."""
    errs = {n: rel_l2(got[n], want[n]) for n in want}
    name = max(errs, key=errs.get)
    return errs[name], name


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def gemm_accumulate_in_place(dev) -> float:
    """The fused engine's weight-grad GEMM writes into its fp32
    accumulator in place: relative L2 error against an fp32 reference."""
    from picotron_tpu_torch.parallel.fused_bwd import accumulate_weight_grad

    g = torch.Generator(device=dev).manual_seed(11)
    dy = torch.randn(2, 1024, 192, generator=g, device=dev).bfloat16()
    x = torch.randn(2, 1024, 320, generator=g, device=dev).bfloat16()
    acc = torch.randn(192, 320, generator=g, device=dev)
    want = acc + dy.reshape(-1, 192).double().t() @ x.reshape(-1, 320).double()
    ptr = acc.data_ptr()
    accumulate_weight_grad(acc, dy, x)
    err = rel_l2(acc, want)
    if acc.data_ptr() != ptr or not err <= 1e-5:
        raise AssertionError(f"GEMM-accumulate: in place "
                             f"{acc.data_ptr() == ptr}, error {err:.3g}")
    return err


def engine_parity(cfg, seed: int = 1234, dev: str = "cuda",
                  fused_cfg=None, label: str = "5a") -> dict:
    """Phase 5(a) on `cfg` (an AD config; its fused twin `fused_cfg`, by
    default the same config with remat "dots_attn" and grad_engine
    "fused"): one step's grads from one seed under both engines, and
    (phase 5a, not 11b) the fused engine's GEMM-accumulate against its
    plain form. Raises past the limits."""
    import dataclasses

    from picotron_tpu_torch.data import MicroBatchDataLoader
    from picotron_tpu_torch.models.llama import LlamaModel, init_params
    from picotron_tpu_torch.parallel.fused_bwd import (
        ComputeWeights, fused_accumulate_grads,
    )
    from picotron_tpu_torch.train_step import (
        make_grads_fn, resolved_grad_engine,
    )

    fused_cfg = fused_cfg or dataclasses.replace(
        cfg, training=dataclasses.replace(
            cfg.training, remat=True, remat_policy="dots_attn",
            grad_engine="fused"))
    if (resolved_grad_engine(cfg), resolved_grad_engine(fused_cfg)) != (
            "ad", "fused"):
        raise AssertionError("engine parity needs an AD config")
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(LlamaModel(cfg.model, device=dev), gen)
    batch = next(MicroBatchDataLoader(cfg, dev))
    loss_ad = float(make_grads_fn(cfg)(model, batch)[0])
    g_ad = grads_of(model)
    loss_fused = float(make_grads_fn(fused_cfg)(model, batch)[0])
    if label != "5a":
        err, name = worst_grad(grads_of(model), g_ad)
        del g_ad, model
        torch.cuda.empty_cache()
        log(f"phase {label} engine parity: loss AD {loss_ad}, fused "
            f"{loss_fused}; worst grad fused vs AD {err:.4g} ({name}) "
            f"(limit {GRAD_RTOL:g})")
        if not (abs(loss_ad - loss_fused) <= LOSS_ATOL and err <= GRAD_RTOL):
            raise AssertionError(f"{label}: engine losses {loss_ad} vs "
                                 f"{loss_fused}, grads {err} ({name})")
        return {"loss_ad": loss_ad, "loss_fused": loss_fused,
                "bitwise": loss_ad == loss_fused,
                "worst_grad_rel_l2": err, "worst_grad": name}
    g_fused = grads_of(model)
    err, name = worst_grad(g_fused, g_ad)
    del g_ad
    weights = ComputeWeights(model)
    weights.refresh()
    loss_plain = float(fused_accumulate_grads(model, weights, batch,
                                              plain=True)[0])
    err_plain, name_plain = worst_grad(grads_of(model), g_fused)
    times = {True: [], False: []}
    if dev.type == "cuda":  # one step's grads by each form, in turns
        for plain in (False, True, True, False):
            times[plain].append(cuda_ms(lambda: fused_accumulate_grads(
                model, weights, batch, plain=plain), iters=1, warmup=0))
    out = {"loss_ad": loss_ad, "loss_fused": loss_fused,
           "loss_fused_plain": loss_plain,
           "bitwise": loss_ad == loss_fused == loss_plain,
           "worst_grad_rel_l2": err, "worst_grad": name,
           "worst_gemm_vs_plain_rel_l2": err_plain,
           "worst_gemm_vs_plain": name_plain,
           "grads_ms_gemm": times[False], "grads_ms_plain": times[True]}
    del g_fused, weights, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"phase 5a engine parity: loss AD {loss_ad}, fused {loss_fused}, "
        f"fused plain {loss_plain}; worst grad fused vs AD {err:.4g} "
        f"({name}), GEMM-accumulate vs plain {err_plain:.4g} ({name_plain}) "
        f"(limit {GRAD_RTOL:g}); one step's grads GEMM-accumulate "
        f"{times[False]} ms, plain {times[True]} ms")
    for a, b in ((loss_ad, loss_fused), (loss_fused, loss_plain)):
        if not abs(a - b) <= LOSS_ATOL:
            raise AssertionError(f"engine losses {a} vs {b}")
    if not (err <= GRAD_RTOL and err_plain <= GRAD_RTOL):
        raise AssertionError(f"engine grads: fused vs AD {err} ({name}), "
                             f"GEMM vs plain {err_plain} ({name_plain})")
    return out


def chunked_ce_check(n=(MBS, SEQ), hidden=2048, vocab=49152,
                     chunk=CE_CHUNK, seed=5) -> dict:
    """Phase 5(d): the chunked CE against the unchunked one in bf16 on the
    card, loss and grads, with each one's peak memory (GiB above what was
    allocated before it)."""
    from picotron_tpu_torch.ops.losses import (
        IGNORE_INDEX, chunked_cross_entropy_sum_count, cross_entropy_sum_count,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(*n, hidden, generator=g, device=dev).bfloat16()
    bound = (1.0 / hidden) ** 0.5
    w = ((torch.rand(vocab, hidden, generator=g, device=dev) * 2 - 1)
         * bound).bfloat16()
    tgt = torch.randint(0, vocab, n, generator=g, device=dev)
    tgt[0, :64] = IGNORE_INDEX
    res = {}
    for name, fn in (
            ("unchunked", lambda h_, w_: cross_entropy_sum_count(
                h_ @ w_.t(), tgt)[0]),
            ("chunked", lambda h_, w_: chunked_cross_entropy_sum_count(
                h_, w_, tgt, chunk)[0])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        h_, w_ = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = fn(h_, w_)
        dh, dw = torch.autograd.grad(loss, (h_, w_))
        torch.cuda.synchronize()
        res[name] = (float(loss.detach()), dh, dw,
                     (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        del h_, w_, loss
    lu, dhu, dwu, mu = res["unchunked"]
    lc, dhc, dwc, mc = res["chunked"]
    out = {"loss": lc, "loss_unchunked": lu,
           "loss_rel_err": abs(lc - lu) / abs(lu),
           "d_hidden_rel_l2": rel_l2(dhc, dhu), "d_head_rel_l2": rel_l2(dwc, dwu),
           "peak_gb": mc, "peak_gb_unchunked": mu}
    del res, dhu, dwu, dhc, dwc
    torch.cuda.empty_cache()
    log(f"phase 5d chunked CE (chunk {chunk}, tokens {n[0] * n[1]}, vocab "
        f"{vocab}): loss {lc} vs {lu} (rel {out['loss_rel_err']:.3g}, limit "
        f"{CE_LOSS_RTOL:g}), d hidden {out['d_hidden_rel_l2']:.3g}, d head "
        f"{out['d_head_rel_l2']:.3g} (limit {CE_GRAD_RTOL:g}); peak "
        f"{mc:.3f} GiB chunked, {mu:.3f} GiB unchunked")
    if not (out["loss_rel_err"] <= CE_LOSS_RTOL
            and out["d_hidden_rel_l2"] <= CE_GRAD_RTOL
            and out["d_head_rel_l2"] <= CE_GRAD_RTOL):
        raise AssertionError(f"chunked CE out of its limits: {out}")
    return out


def remat_policies(fa, here: str, phase3_losses: list) -> dict:
    """Phase 5(c): two steps of the phase-3 config under the AD engine
    with each remat policy, through `train.run`: {policy: {losses, peak
    GiB, second step's seconds}}; "dots_offload" (after "dots") also
    with its parked bytes and copy rates (`offload_policy`)."""
    import dataclasses
    import gc

    from picotron_tpu_torch import train
    from picotron_tpu_torch.config import load_config

    base = load_config(os.path.join(here, CONFIG))
    out = {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(base, training=dataclasses.replace(
            base.training, remat=True, remat_policy=policy, grad_engine="ad",
            total_train_steps=2))
        if policy == "dots_offload":
            out[policy] = offload_policy(fa, cfg, out["dots"])
            continue
        fa.reset_launch_counts()
        result = train.run(cfg, "cuda")
        torch.cuda.synchronize()
        per_step = 24 * GA * 2
        check_launches(launch_counts(fa), {
            "flash_fwd": per_step * (2 if policy == "full" else 1),
            "flash_bwd_dq": per_step, "flash_bwd_dkv": per_step},
            f"phase 5c {policy}")
        losses = result["losses"]
        out[policy] = {"losses": losses,
                       "peak_memory_gb": result["peak_memory_gb"],
                       "step_2_s": result["step_seconds"][1],
                       "launches": dict(fa.launches)}
        want = phase3_losses[:2]
        same = "bit for bit" if losses == want else (
            f"max diff {max(abs(a - b) for a, b in zip(losses, want))!r}")
        log(f"phase 5c remat {policy}: losses {losses} (phase 3: {want}, "
            f"{same}), peak {result['peak_memory_gb']:.2f} "
            f"GiB, step 2 {result['step_seconds'][1] * 1e3:.1f} ms, forward "
            f"launches {fa.launches['flash_fwd']}")
        del result
        gc.collect()
        torch.cuda.empty_cache()
        if not all(abs(a - b) <= LOSS_ATOL for a, b in zip(losses, want)):
            raise AssertionError(f"remat {policy}: losses {losses}, phase 3 "
                                 f"{want}")
    return out


@contextlib.contextmanager
def offload_probes(ao, timed=None, stale=False):
    """Probes on the parker's two copy sites (`models/act_offload.py`),
    undone on exit. `timed` ({"d2h": [], "h2d": []}) gets each copy's
    (start, end, bytes), CUDA events on the copy's own stream: a D2H's
    start is recorded once its buffer is taken (pinning a new one is
    host time) and the stream has taken its waits, an H2D's after its
    waits. `stale` plants the fault: the first parked storage of the
    second forward restored with the first forward's bytes, as if its
    copy had gone to another microbatch's buffer."""
    init, take, fetch = (ao._Stored.__init__, ao.ActivationParker._take,
                         ao._Group.fetch)
    first, starts = [], []

    def event(stream):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def parker_take(self, n):
        buf, last = take(self, n)
        if timed is not None:
            self.d2h.wait_stream(torch.cuda.current_stream(self.device))
            if last is not None:
                self.d2h.wait_event(last)
            starts.append(event(self.d2h))
        return buf, last

    def stored_init(self, group, t):
        init(self, group, t)
        if timed is not None:
            timed["d2h"].append((starts.pop(), event(group.parker.d2h),
                                 self.nbytes))
        if stale and group.prev is None and not group.stored:
            self.event.synchronize()
            if not first:
                first.append(self.buf.clone())
            elif first[-1] is not None:
                self.buf.copy_(first[0])
                first.append(None)

    def group_fetch(self):
        if timed is None or self.fetched:
            return fetch(self)
        p = self.parker
        items = [s for s in self.stored.values() if s.buf is not None]
        p.h2d.wait_stream(torch.cuda.current_stream(p.device))
        for s in items:
            p.h2d.wait_event(s.event)
        start = event(p.h2d)
        fetch(self)
        timed["h2d"].append((start, event(p.h2d),
                             sum(s.nbytes for s in items)))

    ao._Stored.__init__, ao._Group.fetch = stored_init, group_fetch
    ao.ActivationParker._take = parker_take
    try:
        yield
    finally:
        ao._Stored.__init__, ao._Group.fetch = init, fetch
        ao.ActivationParker._take = take


def offload_policy(fa, cfg, dots: dict) -> dict:
    """5c's "dots_offload": two steps with every copy timed
    (`offload_probes`), held to "dots" bit for bit (losses) and launch for
    launch; the bytes parked per step and each way's GB/s (bytes over the
    copies' own stream time) against the link's pinned-copy rates; then
    the planted fault, which must break the equality."""
    import gc

    from picotron_tpu_torch import train
    from picotron_tpu_torch.models import act_offload as ao

    def run(stale=False):
        fa.reset_launch_counts()
        ao.reset_counts()
        timed = None if stale else {"d2h": [], "h2d": []}
        with offload_probes(ao, timed, stale):
            result = train.run(cfg, "cuda")
        torch.cuda.synchronize()
        parker = result.pop("state").model._parker
        res = {"losses": result["losses"],
               "peak_memory_gb": result["peak_memory_gb"],
               "step_2_s": result["step_seconds"][1],
               "launches": dict(fa.launches), "counts": dict(ao.counts),
               "pinned_bytes": parker.pinned_bytes}
        if timed is not None:
            res["copies"] = {
                way: (sum(n for _, _, n in ev),
                      sum(a.elapsed_time(b) for a, b, _ in ev) / 1e3)
                for way, ev in timed.items()}
        del result, parker, timed
        gc.collect()
        torch.cuda.empty_cache()
        return res

    res = run()
    steps = cfg.training.total_train_steps
    per_layer = steps * GA * cfg.model.num_hidden_layers
    c = res["counts"]
    (d2h_b, d2h_s), (h2d_b, h2d_s) = (res["copies"]["d2h"],
                                      res["copies"]["h2d"])
    link = link_rates(torch.device("cuda"))
    res.update({
        "bytes_parked_per_step": c["d2h_bytes"] / steps,
        "d2h_gb_per_s": d2h_b / d2h_s / 1e9 if d2h_s else None,
        "h2d_gb_per_s": h2d_b / h2d_s / 1e9 if h2d_s else None,
        "link_gb_per_s": link,
        "vs_dots": {"peak_memory_gb": dots["peak_memory_gb"],
                    "step_2_s": dots["step_2_s"]}})
    fault = run(stale=True)
    res["planted_stale_losses"] = fault["losses"]
    log(f"phase 5c remat dots_offload: losses {res['losses']} (dots: "
        f"{dots['losses']}, "
        f"{'bit for bit' if res['losses'] == dots['losses'] else 'DIFFER'}), "
        f"peak {res['peak_memory_gb']:.2f} GiB (dots "
        f"{dots['peak_memory_gb']:.2f}), step 2 {res['step_2_s'] * 1e3:.1f} "
        f"ms (dots {dots['step_2_s'] * 1e3:.1f}); per step "
        f"{res['bytes_parked_per_step'] / 1e9:.3f} GB parked each way "
        f"({c['storages'] // (steps * GA)} storages per microbatch, "
        f"{c['kept']} lse kept, pinned "
        f"{res['pinned_bytes'] / 2 ** 30:.2f} GiB); D2H "
        f"{res['d2h_gb_per_s']:.1f} GB/s, H2D {res['h2d_gb_per_s']:.1f} GB/s "
        f"on their streams (link: H2D {link['h2d_alone']:.1f}, D2H "
        f"{link['d2h_alone']:.1f}, both {link['both_each_way']:.1f} GB/s); "
        f"planted stale buffer: losses {fault['losses']}")
    fails = []
    if res["losses"] != dots["losses"]:
        fails.append(f"losses {res['losses']} vs dots {dots['losses']}")
    if res["launches"] != dots["launches"]:
        fails.append(f"launches {res['launches']} vs dots "
                     f"{dots['launches']}")
    if c["kept"] != per_layer or c["d2h_bytes"] != c["h2d_bytes"]:
        fails.append(f"counts {c}: want {per_layer} lse kept and the bytes "
                     f"fetched equal to those parked")
    if fault["losses"] == dots["losses"]:
        fails.append("the planted stale buffer was not caught")
    if fails:
        raise AssertionError("phase 5c dots_offload: " + "; ".join(fails))
    return res


def path_numbers(result: dict, m, peak_flops: float) -> dict:
    """Step ms (median of steps 2-4), tokens/s, MFU, peak GiB of a
    main-path run."""
    from picotron_tpu_torch.utils import flops_per_token

    steady = statistics.median(result["step_seconds"][1:])
    tps = result["tokens_per_step"] / steady
    return {"step_ms": steady * 1e3, "tokens_per_s": tps,
            "mfu": tps * flops_per_token(m, SEQ) / peak_flops,
            "peak_memory_gb": result["peak_memory_gb"]}


@torch.no_grad()
def fingerprint(state) -> list:
    """Two int64 sums over the bits of every param and AdamW moment (a
    plain sum and a position-weighted one), the count and the step: equal
    fingerprints mean bit-identical states but for a vanishing chance."""
    out = []
    for _, p in state.model.named_parameters():
        st = state.optimizer.moments(p)
        for t in (p, st["mu"], st["nu"]):
            bits = t.detach().reshape(-1).view(
                torch.int32 if t.element_size() == 4 else torch.int16)
            v = bits.to(torch.int64)
            w = torch.arange(v.numel(), device=v.device) % 65521 + 1
            out.append((int(v.sum()), int((v * w).sum())))
            del v, w
    return out + [state.optimizer.count, state.step]


def checkpoint_resume(cfg, device: str, phase3_losses: list,
                      on_launches=None) -> dict:
    """Phase 4 (the docstring says what it checks). `cfg` is the main-path
    config with save_dir, auto_resume and eval set; `on_launches(label)` is
    called after each run (the launch-count check)."""
    import shutil
    import signal

    from picotron_tpu_torch import train
    from picotron_tpu_torch.checkpoint import CheckpointManager
    from picotron_tpu_torch.ckpt_integrity import checkpoint_nbytes

    save_dir = cfg.checkpoint.save_dir
    shutil.rmtree(save_dir, ignore_errors=True)
    os.makedirs(save_dir)
    est = checkpoint_nbytes(cfg)
    free = shutil.disk_usage(save_dir).free
    log(f"phase 4: checkpoint ~{est / 1e9:.2f} GB, {free / 1e9:.1f} GB free "
        f"under {save_dir}")
    if free < 1.1 * est:
        raise AssertionError(f"not enough disk for one checkpoint: {free} "
                             f"bytes free, {est} needed")
    real_build = train.build_state
    held = {}

    def build(cfg, dev):
        out = real_build(cfg, dev)
        held["state"] = out[0]
        if out[0].step:  # resumed: the state as restored, before a step
            held["restored"] = fingerprint(out[0])
            held["meta"] = out[2]
        return out

    out = {}
    try:
        train.build_state = build
        # run A: preempted after step 2
        losses_a, clock = [], {}

        def on_step(step, metrics):
            losses_a.append(metrics["loss"])
            if step == 2:
                held["saved"] = fingerprint(held["state"])
                clock["t0"] = time.perf_counter()
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            train.run(cfg, device, on_step=on_step)
            raise AssertionError("run A was not preempted")
        except SystemExit as e:
            if e.code != 75:
                raise AssertionError(f"run A exited {e.code}, want 75")
        out["emergency_save_s"] = time.perf_counter() - clock["t0"]
        held.pop("state")
        if on_launches:
            on_launches("run A")
        mgr = CheckpointManager(cfg)
        t0 = time.perf_counter()
        res = mgr.verify_step(2)
        out["verify_s"] = time.perf_counter() - t0
        if mgr.durable_steps() != [2] or res.status != "verified":
            raise AssertionError(f"run A's checkpoint: durable steps "
                                 f"{mgr.durable_steps()}, step 2 {res.status} "
                                 f"{res.failures}")
        out["checkpoint_bytes"] = res.manifest["total_bytes"]
        out["digest"] = res.manifest["algo"]
        log(f"phase 4 run A: exit 75 after step 2, losses {losses_a}, "
            f"emergency save {out['emergency_save_s']:.2f} s (SIGTERM to "
            f"exit), {out['checkpoint_bytes'] / 1e9:.2f} GB, re-verify "
            f"({out['digest']}) {out['verify_s']:.2f} s")

        # run B: auto-resume, steps 3-4, eval at step 4
        result = train.run(cfg, device)
        if on_launches:
            on_launches("run B")
        if result["start_step"] != 2:
            raise AssertionError(f"run B resumed at {result['start_step']}")
        if held["restored"] != held["saved"]:
            bad = sum(a != b for a, b in zip(held["restored"], held["saved"]))
            raise AssertionError(f"restored state differs from the saved "
                                 f"state in {bad} fingerprints")
        if held["meta"]["dataloader"] != {"epoch": 0,
                                          "cursor": 2 * cfg.global_batch_size}:
            raise AssertionError(f"restored cursor {held['meta']}")
        out["restore_timings"] = result["restore_timings"]
        losses_b = result["losses"]
        bitwise = losses_a == phase3_losses[:2]
        spread = max(abs(a - b) for a, b in zip(losses_a, phase3_losses))
        diff = max(abs(a - b) for a, b in zip(losses_b, phase3_losses[2:]))
        log(f"phase 4 run B: resumed at step 2 (verify "
            f"{out['restore_timings']['verify_s']:.2f} s, load "
            f"{out['restore_timings']['load_s']:.2f} s), losses {losses_b}; "
            f"run A vs phase 3 steps 1-2 {'bit for bit' if bitwise else ''} "
            f"(max diff {spread}), run B vs phase 3 steps 3-4 max diff {diff}")
        if bitwise and losses_b != phase3_losses[2:]:
            raise AssertionError(f"resumed losses {losses_b} differ from "
                                 f"phase 3's {phase3_losses[2:]}")
        if not bitwise and not diff <= RESUME_SPREAD_FACTOR * spread:
            raise AssertionError(
                f"resumed losses {losses_b} differ from phase 3's "
                f"{phase3_losses[2:]} by {diff}, over {RESUME_SPREAD_FACTOR} x "
                f"the run-to-run spread {spread}")

        # eval gate: the forward kernel's val_loss vs the plain attention
        val = result["val_losses"][4]
        model = result.pop("state").model
        ref = reference_eval_loss(cfg, model, device)
        out.update(losses_a=losses_a, losses_b=losses_b, bitwise=bitwise,
                   spread=spread, val_loss=val, val_loss_reference=ref)
        log(f"phase 4 eval: val_loss {val} (forward kernel), {ref} (plain "
            f"attention), diff {abs(val - ref):.3g} (limit {EVAL_ATOL:g})")
        if not abs(val - ref) <= EVAL_ATOL:
            raise AssertionError(f"val_loss {val} vs plain attention {ref}")
    finally:
        train.build_state = real_build
        shutil.rmtree(save_dir, ignore_errors=True)
    return out


@torch.no_grad()
def reference_eval_loss(cfg, model, device) -> float:
    """The eval batches' mean loss with `attn_impl: "reference"` on the
    same params (model.cfg swapped for the call)."""
    import dataclasses

    from picotron_tpu_torch.data import MicroBatchDataLoader, build_eval_source
    from picotron_tpu_torch.train_step import make_eval_step

    eval_dl = MicroBatchDataLoader(cfg, device, source=build_eval_source(cfg))
    batches = [next(eval_dl) for _ in range(cfg.training.eval_steps)]
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, attn_impl="reference")
    try:
        fn = make_eval_step(cfg)
        return sum(float(fn(model, b)) for b in batches) / len(batches)
    finally:
        model.cfg = saved


def phase4_config(here: str):
    from picotron_tpu_torch.config import config_from_dict

    with open(os.path.join(here, CONFIG)) as f:
        raw = json.load(f)
    raw["checkpoint"] = {"save_dir": os.path.join(here, CKPT_DIR),
                         "auto_resume": True}
    raw["training"].update(eval_frequency=4, eval_steps=EVAL_STEPS)
    return config_from_dict(raw)


def _adamw_case(n, mdt, mode, out, dev, gen):
    """One phase-6a case: fresh operands and the keyword arguments."""
    r = lambda: torch.randn(n, generator=gen, device=dev)  # noqa: E731
    ops = [r(), 3 * r(), (0.1 * r()).to(mdt),
           torch.rand(n, generator=gen, device=dev).to(mdt)]
    def one(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    kw = {
        "none": {}, "clip_under": {"grad_norm": one(0.5)},
        "clip_over": {"grad_norm": one(4.0)},
        "scale": {"grad_scale": one(1 / 7)},
        "scale_clip_under": {"grad_scale": one(1 / 7),
                             "grad_norm": one(3.5)},
        "scale_clip_over": {"grad_scale": one(1 / 7), "grad_norm": one(70.0)},
        "ok_true": {"ok": torch.tensor(True, device=dev)},
        "ok_false": {"ok": torch.tensor(False, device=dev)},
    }[mode]
    if out:
        ops.append(torch.full((n,), 7.0, dtype=torch.bfloat16, device=dev))
    return ops, kw


ADAMW_MODES = ("none", "clip_under", "clip_over", "scale", "scale_clip_under",
               "scale_clip_over", "ok_true", "ok_false")


def adamw_vs_plain(dev) -> dict:
    """Phase 6a, the comparison: every case's p, mu, nu (and the compute
    copy) from the kernel equal to the plain version's bit for bit.
    Returns the number of cases, the largest absolute difference and the
    largest difference in fp32 ulps (both 0 when the gate holds)."""
    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch.config import TrainingConfig

    t = TrainingConfig(learning_rate=3e-4, weight_decay=0.1,
                       grad_clip_norm=1.0)
    h = topt.step_hyper(t, topt.make_lr(t), 5)
    gen = torch.Generator(device=dev).manual_seed(21)
    cases = worst_abs = worst_ulp = 0
    bad = []
    for n in ADAMW_SIZES:
        for mdt in (torch.bfloat16, torch.float32):
            for mode in ADAMW_MODES:
                for out in (False, True):
                    ops, kw = _adamw_case(n, mdt, mode, out, dev, gen)
                    before = [x.clone() for x in ops]
                    plain = [x.clone() for x in ops]
                    o = {"out": ops[4]} if out else {}
                    topt.adamw_update(*ops[:4], h, **kw, **o)
                    po = {"out": plain[4]} if out else {}
                    topt.adamw_update_plain(*plain[:4], h, **kw, **po)
                    torch.cuda.synchronize()
                    cases += 1
                    for a, b in zip(ops, plain):
                        d = (a.float() - b.float()).abs().max()
                        worst_abs = max(worst_abs, float(d))
                        if a.dtype == torch.float32:
                            u = (a.view(torch.int32).long()
                                 - b.view(torch.int32).long()).abs().max()
                            worst_ulp = max(worst_ulp, int(u))
                    label = f"n {n} {mdt} {mode} out {out}"
                    if not all(torch.equal(a, b) for a, b in zip(ops, plain)):
                        bad.append(label)
                    if mode == "ok_false" and not all(
                            torch.equal(a, b) for a, b in zip(ops, before)):
                        bad.append(label + " wrote under ok False")
                    if out and mode != "ok_false" and not torch.equal(
                            ops[4], ops[0].to(torch.bfloat16)):
                        bad.append(label + " compute copy is not p's cast")
    log(f"phase 6a adamw vs plain: {cases} cases, max abs diff {worst_abs}, "
        f"max fp32 ulp diff {worst_ulp}; {len(bad)} failed")
    if bad:
        raise AssertionError(f"adamw kernel vs plain: {bad[:6]}")
    return {"cases": cases, "max_abs_err": worst_abs, "max_ulp": worst_ulp}


def adamw_timing(cfg, dev) -> dict:
    """Phase 6a, the times: one update of every tensor of the phase-3
    model (resident, its moments dtype, no clip), the kernel, its plain
    version and `torch._fused_adamw_` (fp32 moments), and the bound."""
    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch.models.llama import LlamaModel

    shapes = [tuple(p.shape) for p in
              LlamaModel(cfg.model, device="meta").parameters()]
    n = sum(math.prod(s) for s in shapes)
    mdt = (torch.bfloat16 if cfg.training.adam_moments_dtype == "bfloat16"
           else torch.float32)
    gen = torch.Generator(device=dev).manual_seed(3)
    ps = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    gs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    ms = [torch.zeros(s, dtype=mdt, device=dev) for s in shapes]
    vs = [torch.zeros(s, dtype=mdt, device=dev) for s in shapes]
    h = topt.step_hyper(cfg.training, topt.make_lr(cfg.training), 5)

    def kernel():
        for args in zip(ps, gs, ms, vs):
            topt.adamw_update(*args, h)

    def plain():
        for args in zip(ps, gs, ms, vs):
            topt.adamw_update_plain(*args, h)

    ms_kernel = cuda_ms(kernel, iters=5, warmup=1)
    ms_plain = cuda_ms(plain, iters=2, warmup=1)
    del ms, vs
    m32 = [torch.zeros(s, device=dev) for s in shapes]
    v32 = [torch.zeros(s, device=dev) for s in shapes]
    steps = [torch.tensor(6.0, device=dev) for _ in shapes]
    t = cfg.training

    def library():
        torch._fused_adamw_(ps, gs, m32, v32, [], steps, lr=t.learning_rate,
                            beta1=t.adam_beta1, beta2=t.adam_beta2,
                            weight_decay=t.weight_decay, eps=t.adam_eps,
                            amsgrad=False, maximize=False)

    ms_lib = cuda_ms(library, iters=5, warmup=1)
    moment = torch.empty((), dtype=mdt).element_size()
    nbytes = n * (4 + 4 + 2 * moment + 4 + 2 * moment)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    del ps, gs, m32, v32
    torch.cuda.empty_cache()
    out = {"tensors": len(shapes), "params": n, "ms": ms_kernel,
           "plain_ms": ms_plain, "library_ms": ms_lib, "bound_ms": bound,
           "bytes": nbytes}
    log(f"phase 6a adamw timing ({len(shapes)} tensors, {n} params, "
        f"{mdt} moments): kernel {ms_kernel:.3f} ms, plain {ms_plain:.3f} "
        f"ms, torch._fused_adamw_ (fp32 moments) {ms_lib:.3f} ms, bound "
        f"{bound:.3f} ms ({nbytes / 1e9:.2f} GB), "
        f"{nbytes / ms_kernel / 1e6:.1f} GB/s, "
        f"{100 * bound / ms_kernel:.1f}% of bound")
    return out


def _host_masters(state) -> dict:
    """{name: fp32 CPU copy} of a state's master params: the resident
    model's params, or the offload state's host master."""
    opt = state.optimizer
    opt.synchronize()
    src = opt.state_tensors().get("master") or dict(
        state.model.named_parameters())
    return {n: t.detach().to("cpu", torch.float32, copy=True)
            for n, t in src.items()}


@torch.no_grad()
def _prints(tensors: dict) -> dict:
    """{name: two int64 sums over the tensor's bits} (as `fingerprint`):
    equal prints mean bit-identical tensors but for a vanishing chance."""
    out = {}
    for n, t in tensors.items():
        v = t.detach().to("cuda").reshape(-1).view(
            torch.int32 if t.element_size() == 4 else torch.int16).long()
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out[n] = (int(v.sum()), int((v * w).sum()))
    return out


@torch.no_grad()
def _update_errors(p0: dict, got: dict, want: dict) -> dict:
    """{name: ||(got - p0) - (want - p0)|| / ||want - p0||}: each
    tensor's update against the reference's, in relative L2."""
    out = {}
    for n, w in want.items():
        start = p0[n].to("cuda")
        out[n] = rel_l2(got[n].to("cuda") - start, w.to("cuda") - start)
    return out


@contextlib.contextmanager
def offload_roundings():
    """The resident model computing as the offload one does. Offload's
    params are the bf16 cast of their masters, so a norm weight enters
    its product as its bf16 cast and its grad is rounded to bf16; the
    embedding's rows are gathered from the bf16 table and repeated rows'
    grads summed in bf16. Every other use is a bf16 cast in both. Under
    this context the resident model's norms and embedding are used
    through that cast (`models/llama.py` looks both functions up at call
    time; the AD engine only)."""
    from picotron_tpu_torch.models import llama

    real_norm, real_embed = llama.rms_norm, llama.embed
    llama.rms_norm = lambda x, w, eps=1e-5: real_norm(
        x, w.to(torch.bfloat16), eps)
    llama.embed = lambda model, ids: model.embedding.to(
        torch.bfloat16)[ids].to(llama.compute_dtype(model.cfg))
    try:
        yield
    finally:
        llama.rms_norm, llama.embed = real_norm, real_embed


def replay_offload_steps(opt, record: list) -> None:
    """Wrap `opt.step` (an OffloadAdamW on the card) to hold each streamed
    update exactly: before the step, copy master, mu and nu to the card;
    after it, run `adamw_update_plain` over every whole tensor of those
    copies from the same grad buffers, scale and norm, and append
    {"step", "mismatched": {name: [what differs]}}: the master, mu, nu
    or the compute copy (the model's param) that differs from the
    streamed result in any bit. The kernel equals its plain version bit
    for bit (phase 6a), so this covers the slices, staging buffers,
    streams and events, and the copies back."""
    from picotron_tpu_torch import optimizer as topt

    real = opt.step
    dev = opt.grads[0].device

    def step(grad_scale, grad_norm=None, ok=None):
        opt.synchronize()
        before = [[t.to(dev, copy=True) for t in ts]
                  for ts in (opt.master, opt.mu, opt.nu)]
        count = opt.count
        real(grad_scale, grad_norm=grad_norm, ok=ok)
        opt.synchronize()
        h = topt.step_hyper(opt.t, opt.lr, count)
        clip = None
        if opt.t.grad_clip_norm > 0:
            clip = (grad_norm if grad_norm is not None
                    else topt.global_norm(opt.grads))
        bad = {}
        with torch.no_grad():
            for i, n in enumerate(opt.names):
                m, mu, nu = (ts[i] for ts in before)
                copy = torch.empty_like(m, dtype=torch.bfloat16)
                topt.adamw_update_plain(m, opt.grads[i], mu, nu, h,
                                        grad_norm=clip, grad_scale=grad_scale,
                                        ok=ok, out=copy)
                wrong = [what for what, a, b in (
                    ("master", m, opt.master[i]), ("mu", mu, opt.mu[i]),
                    ("nu", nu, opt.nu[i]), ("copy", copy, opt.params[i]))
                    if not torch.equal(a, b.detach().to(dev))]
                if wrong:
                    bad[n] = wrong
                for ts in before:
                    ts[i] = None
        record.append({"step": count + 1, "mismatched": bad})

    opt.step = step


def plant_offload_fault(opt, fault: str) -> None:
    """A planted fault in an OffloadAdamW (tests/test_torch_cuda.py checks
    that phase 6b fails each): "moments_not_copied_back" (the host mu and
    nu keep their old values), "embedding_slices_skipped" (the
    embedding's row groups never stream) or "embedding_grad_lost" (its
    grad buffer is zeroed before the update)."""
    if fault == "embedding_slices_skipped":
        e = opt.names.index("embedding")
        opt.slices = [s for s in opt.slices if s[0] != e]
        return
    if fault not in OFFLOAD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real = opt.step

    def step(grad_scale, grad_norm=None, ok=None):
        if fault == "embedding_grad_lost":
            opt.grads[opt.names.index("embedding")].zero_()
            real(grad_scale, grad_norm=grad_norm, ok=ok)
            return
        opt.synchronize()
        kept = [t.clone() for t in opt.mu + opt.nu]
        real(grad_scale, grad_norm=grad_norm, ok=ok)
        opt.synchronize()
        for t, k in zip(opt.mu + opt.nu, kept):
            t.copy_(k)

    opt.step = step


def _three_steps(fa, cfg, on_build, on_step) -> dict:
    """train.run of `cfg` with `on_build(state)` after the state is built
    and `on_step(state, step)` after each step; checks the launches: each
    flash kernel 24 x GA per step, the AdamW kernel once per tensor (or
    streamed slice) per step. Returns the losses."""
    import gc

    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch import train

    real_build = train.build_state
    held = {}

    def build(cfg, dev):
        out = real_build(cfg, dev)
        held["state"] = out[0]
        on_build(out[0])
        return out

    fa.reset_launch_counts()
    topt.reset_launch_counts()
    try:
        train.build_state = build
        result = train.run(cfg, "cuda", on_step=lambda step, metrics: on_step(
            held["state"], step))
    finally:
        train.build_state = real_build
    torch.cuda.synchronize()
    per = 24 * GA * OFFLOAD_STEPS
    label = f"phase 6b offload {cfg.training.optimizer_offload}"
    check_launches(launch_counts(fa), {
        "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per}, label)
    opt = held.pop("state").optimizer
    want = len(getattr(opt, "slices", opt.params)) * OFFLOAD_STEPS
    if topt.launches["adamw"] != want:
        raise AssertionError(f"{label}: adamw launched "
                             f"{topt.launches['adamw']} times, want {want}")
    losses = result["losses"]
    del result, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _offload_cfg(here: str, offload: bool):
    import dataclasses

    from picotron_tpu_torch.config import load_config

    base = load_config(os.path.join(here, CONFIG))
    return dataclasses.replace(base, training=dataclasses.replace(
        base.training, total_train_steps=OFFLOAD_STEPS,
        optimizer_offload=offload))


def offload_references(fa, here: str) -> dict:
    """Phase 6b's references, 3 steps each of the phase-3 config from its
    seed: the resident AdamW (losses; host copies of the params at steps
    0, 1 and 3), and the resident AdamW under `offload_roundings`
    (losses; prints of the params at steps 1 and 3)."""
    ref = {"masters": {}, "prints": {}}
    cfg = _offload_cfg(here, False)

    def keep(state, step):
        if step in (0, 1, OFFLOAD_STEPS):
            ref["masters"][step] = _host_masters(state)

    ref["losses"] = _three_steps(fa, cfg, lambda st: keep(st, 0), keep)

    def prints(state, step):
        if step in (1, OFFLOAD_STEPS):
            ref["prints"][step] = _prints(dict(state.model.named_parameters()))

    with offload_roundings():
        ref["rounded_losses"] = _three_steps(fa, cfg, lambda st: None,
                                             prints)
    return ref


def offload_vs_resident(fa, here: str, ref: Optional[dict] = None,
                        fault: Optional[str] = None) -> dict:
    """Phase 6b (the module docstring says what it checks); `ref` from
    `offload_references` (made here when None), `fault` one of
    OFFLOAD_FAULTS to plant. Raises with every gate that failed."""
    ref = offload_references(fa, here) if ref is None else ref
    p0 = ref["masters"][0]
    replays, errors, prints, init = [], {}, {}, {}

    def on_build(state):
        opt = state.optimizer
        init["equal"] = all(torch.equal(m, p0[n])
                            for n, m in zip(opt.names, opt.master))
        init["slices"] = len(opt.slices)
        if fault is not None:
            plant_offload_fault(opt, fault)
        replay_offload_steps(opt, replays)

    def on_step(state, step):
        if step in (1, OFFLOAD_STEPS):
            got = _host_masters(state)
            errors[step] = _update_errors(p0, got, ref["masters"][step])
            prints[step] = _prints(got)
            del got

    losses = _three_steps(fa, _offload_cfg(here, True), on_build, on_step)
    first, last = errors[1], errors[OFFLOAD_STEPS]
    norms = [n for n in first if n.endswith("norm")]
    matmul = [n for n in first if n not in norms and n != "embedding"]
    worst = lambda errs, names: max(names, key=errs.get)  # noqa: E731
    w1, w1n, w3 = (worst(first, matmul), worst(first, norms),
                   worst(last, list(last)))
    mismatched = {r["step"]: r["mismatched"] for r in replays}
    rounded = {step: sorted(n for n in prints[step]
                            if prints[step][n] != ref["prints"][step][n])
               for step in prints}
    out = {"fault": fault, "losses_offload": losses,
           "losses_resident": ref["losses"],
           "losses_resident_rounded": ref["rounded_losses"],
           "init_equal": init["equal"], "slices": init["slices"],
           "replay_mismatched_tensors": {k: len(v)
                                         for k, v in mismatched.items()},
           "rounded_mismatched_tensors": {k: len(v)
                                          for k, v in rounded.items()},
           "step1_update_worst_matmul": [w1, first[w1]],
           "step1_update_worst_norm": [w1n, first[w1n]],
           "step1_update_embedding": first["embedding"],
           f"step{OFFLOAD_STEPS}_update_worst": [w3, last[w3]],
           f"step{OFFLOAD_STEPS}_update_by_class": {
               cls: max(last[n] for n in names) for cls, names in (
                   ("matmul", matmul), ("norm", norms),
                   ("embedding", ["embedding"]))}}
    fails = []
    if not out["init_equal"]:
        fails.append("offload master at init differs from the resident "
                     "params")
    if not losses[0] == ref["losses"][0] == ref["rounded_losses"][0]:
        fails.append("step-1 losses differ")
    for step, bad in mismatched.items():
        if bad:
            fails.append(f"replay: step {step}, {len(bad)} tensors differ "
                         f"from the plain update (e.g. "
                         f"{next(iter(bad.items()))})")
    if losses != ref["rounded_losses"] or any(rounded.values()):
        fails.append(f"resident with offload's roundings: losses "
                     f"{ref['rounded_losses']} vs {losses}, tensors that "
                     f"differ {dict((k, v[:3]) for k, v in rounded.items())}")
    if not first[w1] <= OFFLOAD_RTOL:
        fails.append(f"resident update: step 1, {w1} {first[w1]}")
    for n in norms + ["embedding"]:
        if not first[n] <= OFFLOAD_UPDATE_RTOL:
            fails.append(f"resident update: step 1, {n} {first[n]}")
    for n, e in last.items():
        if not e <= OFFLOAD_UPDATE_RTOL:
            fails.append(f"resident update: step {OFFLOAD_STEPS}, {n} {e}")
    out["failures"] = fails
    log(f"phase 6b offload vs resident{f' (fault {fault})' if fault else ''}"
        f": losses {losses}, resident {ref['losses']}, resident with "
        f"offload's roundings {ref['rounded_losses']}; replay mismatched "
        f"tensors by step {out['replay_mismatched_tensors']}; vs the "
        f"rounded resident {out['rounded_mismatched_tensors']}; updates vs "
        f"resident (rel L2): step 1 worst matmul {first[w1]:.4g} ({w1}, "
        f"limit {OFFLOAD_RTOL:g}), norm {first[w1n]:.4g} ({w1n}), "
        f"embedding {first['embedding']:.4g} (limit "
        f"{OFFLOAD_UPDATE_RTOL:g}); step {OFFLOAD_STEPS} by class "
        f"{out[f'step{OFFLOAD_STEPS}_update_by_class']} (limit "
        f"{OFFLOAD_UPDATE_RTOL:g}); {len(fails)} gates failed")
    if fails:
        raise AssertionError("phase 6b: " + "; ".join(fails[:12]))
    return out


def link_rates(dev, nbytes: int = 2 ** 30) -> dict:
    """GB/s of one pinned-host copy of `nbytes` to the card, from it, and
    both at once on two streams: the PCIe link the offloaded update
    streams over."""
    host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    card = [torch.empty(nbytes, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]

    def timed(h2d: bool, d2h: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if h2d:
            with torch.cuda.stream(streams[0]):
                card[0].copy_(host[0], non_blocking=True)
        if d2h:
            with torch.cuda.stream(streams[1]):
                host[1].copy_(card[1], non_blocking=True)
        torch.cuda.synchronize()
        return nbytes / (time.perf_counter() - t0) / 1e9

    timed(True, True)
    out = {"h2d_alone": timed(True, False), "d2h_alone": timed(False, True),
           "both_each_way": timed(True, True)}
    del host, card
    torch.cuda.empty_cache()
    return out


def offload_config_run(fa, here: str, peak_flops: float) -> dict:
    """Phase 6c (the docstring says what it checks)."""
    import dataclasses
    import gc

    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch import train
    from picotron_tpu_torch.config import load_config
    from picotron_tpu_torch.train_step import resolved_grad_engine
    from picotron_tpu_torch.utils import flops_per_token

    cfg = load_config(os.path.join(here, OFFLOAD_CONFIG))
    t = cfg.training
    if not t.optimizer_offload or resolved_grad_engine(cfg) != "fused":
        raise AssertionError(f"{OFFLOAD_CONFIG}: offload "
                             f"{t.optimizer_offload}, engine "
                             f"{resolved_grad_engine(cfg)}")
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        t, max_tokens=OFFLOAD_STEPS * cfg.tokens_per_step))
    real_build = train.build_state
    held, timings = {}, []

    def build(cfg, dev):
        out = real_build(cfg, dev)
        held["opt"] = out[0].optimizer
        return out

    fa.reset_launch_counts()
    topt.reset_launch_counts()
    try:
        train.build_state = build
        result = train.run(cfg, "cuda", on_step=lambda step, m: timings.append(
            held["opt"].timings()))
    finally:
        train.build_state = real_build
    torch.cuda.synchronize()
    opt = held.pop("opt")
    losses = result["losses"]
    if len(losses) != OFFLOAD_STEPS or not all(
            x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"phase 6c losses {losses}")
    per = 24 * t.gradient_accumulation_steps * OFFLOAD_STEPS
    counts = launch_counts(fa)
    check_launches(counts, {"flash_fwd": per, "flash_bwd_dq": per,
                            "flash_bwd_dkv": per}, "phase 6c")
    if topt.launches["adamw"] != len(opt.slices) * OFFLOAD_STEPS:
        raise AssertionError(f"phase 6c: adamw launched "
                             f"{topt.launches['adamw']} times, want "
                             f"{len(opt.slices) * OFFLOAD_STEPS}")
    steady = statistics.median(result["step_seconds"][1:])
    tps = result["tokens_per_step"] / steady
    upd = statistics.median(x["update_ms"] for x in timings[1:]) / 1e3
    h2d = statistics.median(x["h2d_ms"] for x in timings[1:]) / 1e3
    d2h = statistics.median(x["d2h_ms"] for x in timings[1:]) / 1e3
    each_way = opt.host_bytes
    link = link_rates(torch.device("cuda"))
    out = {"ga": t.gradient_accumulation_steps, "losses": losses,
           "step_seconds": result["step_seconds"], "step_ms": steady * 1e3,
           "tokens_per_s": tps,
           "mfu": tps * flops_per_token(cfg.model, t.seq_length) / peak_flops,
           "peak_memory_gb": result["peak_memory_gb"],
           "update_s": upd, "h2d_s": h2d, "d2h_s": d2h,
           "bytes_each_way": each_way,
           "h2d_gb_per_s": each_way / h2d / 1e9,
           "d2h_gb_per_s": each_way / d2h / 1e9,
           "link_gb_per_s": link,
           "update_timings_ms": timings, "slices": len(opt.slices),
           "host_gib": opt.host_bytes / 2 ** 30,
           "launches": {**counts["launches"], **topt.launches}}
    log(f"phase 6c offload config (ga {out['ga']}): losses {losses}, step "
        f"{out['step_ms']:.1f} ms (median of steps 2-{OFFLOAD_STEPS}), "
        f"{tps:.1f} tokens/s, MFU {100 * out['mfu']:.2f}%, peak "
        f"{out['peak_memory_gb']:.2f} GiB; update {upd:.3f} s/step, H2D "
        f"{h2d:.3f} s ({out['h2d_gb_per_s']:.1f} GB/s), D2H {d2h:.3f} s "
        f"({out['d2h_gb_per_s']:.1f} GB/s) for {each_way / 1e9:.2f} GB "
        f"each way; pinned host {out['host_gib']:.2f} GiB; link (1 GiB "
        f"pinned copies) H2D {link['h2d_alone']:.1f}, D2H "
        f"{link['d2h_alone']:.1f}, both at once {link['both_each_way']:.1f} "
        f"GB/s each way")
    del result, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_trainer(here: str, config: str, report: str,
                torchrun: bool) -> dict:
    """One run of the trainer's entry point in a child process, `python
    -m picotron_tpu_torch.train` or the same under `python -m
    torch.distributed.run --standalone --nproc_per_node 1` (a one-rank
    NCCL group): its --report, with its stdout lines. The child's
    session is killed on timeout, so no rank outlives the run."""
    import signal

    cmd = [sys.executable]
    if torchrun:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    cmd += ["-m", "picotron_tpu_torch.train", "--config", config,
            "--report", report]
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    if os.path.exists(report):
        os.remove(report)
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TRAIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{' '.join(cmd[1:])}: no exit within "
                             f"{TRAIN_TIMEOUT_S} s")
    label = "torchrun" if torchrun else "plain"
    for line in out.splitlines():
        if line.startswith(("[step", "layout:", "collectives", "grad engine",
                            "optimizer:")):
            log(f"  {label}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}: {err[-3000:]}")
    with open(report) as f:
        return json.load(f)


def expected_adamw_launches(cfg) -> int:
    """AdamW launches per step: one per tensor, or under offload one per
    streamed slice (optimizer.OffloadAdamW's slicing, from the shapes)."""
    from picotron_tpu_torch.models.llama import LlamaModel
    from picotron_tpu_torch.optimizer import row_group

    model = LlamaModel(cfg.model, device="meta")
    if not cfg.training.optimizer_offload:
        return len(list(model.parameters()))
    n = 0
    for name, p in model.named_parameters():
        grp = 0 if name.startswith("layers.") else row_group(tuple(p.shape))
        n += -(-p.shape[0] // grp) if grp else 1
    return n


def parallel_pair(here: str, cfg_path: str, steps: int, label: str,
                  peak_flops: float) -> dict:
    """Phase 7a/7b: the config through the trainer without a process
    group and under a one-rank NCCL group; the gates of the docstring."""
    from picotron_tpu_torch.config import load_config
    from picotron_tpu_torch.models.llama import LlamaModel
    from picotron_tpu_torch.utils import flops_per_token

    cfg = load_config(cfg_path)
    t = cfg.training
    build = os.path.join(here, "build")
    plain = run_trainer(here, cfg_path, os.path.join(build, f"{label}_plain"
                                                     ".json"), False)
    ranks = run_trainer(here, cfg_path, os.path.join(build, f"{label}_nccl"
                                                     ".json"), True)
    per = 24 * t.gradient_accumulation_steps * steps
    adamw = expected_adamw_launches(cfg) * steps
    fails = []
    if len(ranks["losses"]) != steps or not all(
            x == x and abs(x) != float("inf") for x in ranks["losses"]):
        fails.append(f"losses {ranks['losses']}")
    if ranks["losses"] != plain["losses"]:
        fails.append(f"losses under NCCL {ranks['losses']} != without a "
                     f"process group {plain['losses']}")
    for name, run in (("plain", plain), ("nccl", ranks)):
        for k, v in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                     ("flash_bwd_dkv", "dkv")):
            if run["launches"][k] != per or run["flash_variants"][v] != (
                    bf16_variants(v + "_launches", per, WGMMA_D)):
                fails.append(f"{name}: {k} launched {run['launches'][k]} "
                             f"({run['flash_variants'][v]}), want {per} on "
                             f"the tensor cores")
        if run["launches"]["adamw"] != adamw:
            fails.append(f"{name}: adamw launched {run['launches']['adamw']}"
                         f" times, want {adamw}")
    coll = ranks["collectives_per_step"]
    if plain["collectives_per_step"] is not None or ranks["world_size"] != 1:
        fails.append(f"plain run collectives {plain['collectives_per_step']}"
                     f", NCCL world {ranks['world_size']}")
    tensors = len(list(LlamaModel(cfg.model, device="meta").parameters()))
    if coll is None or coll != {"all_reduce": tensors + 1,
                                "all_gather": tensors, "reduce_scatter": 0,
                                "send_recv": 0, "all_to_all": 0}:
        fails.append(f"collectives per step {coll}: want one all-reduce per "
                     f"grad tensor and one of (NLL, count), one ZeRO-1 "
                     f"all-gather per tensor, no reduce-scatter and no cp "
                     f"exchange")
    steady = statistics.median(ranks["step_seconds"][1:])
    tps = ranks["tokens_per_step"] / steady
    out = {"config": os.path.relpath(cfg_path, here), "steps": steps,
           "ga": t.gradient_accumulation_steps, "losses": ranks["losses"],
           "losses_without_group": plain["losses"],
           "bit_for_bit": ranks["losses"] == plain["losses"],
           "collectives_per_step": coll, "launches": ranks["launches"],
           "step_ms": steady * 1e3,
           "step_ms_without_group": statistics.median(
               plain["step_seconds"][1:]) * 1e3,
           "tokens_per_s": tps,
           "mfu": tps * flops_per_token(cfg.model, t.seq_length) / peak_flops,
           "peak_memory_gb": ranks["peak_memory_gb"],
           "peak_memory_gb_without_group": plain["peak_memory_gb"]}
    log(f"phase {label}: losses {out['losses']} under NCCL world 1, "
        f"{out['losses_without_group']} without a process group "
        f"({'bit for bit' if out['bit_for_bit'] else 'DIFFERENT'}); "
        f"collectives per step {coll}; step {out['step_ms']:.1f} ms "
        f"(without a group {out['step_ms_without_group']:.1f} ms), "
        f"{tps:.1f} tokens/s, MFU {100 * out['mfu']:.2f}%, peak "
        f"{out['peak_memory_gb']:.2f} GiB (without a group "
        f"{out['peak_memory_gb_without_group']:.2f} GiB); launches "
        f"{out['launches']}")
    if fails:
        raise AssertionError(f"phase {label}: " + "; ".join(fails))
    return out


def parallel_phase(here: str, card: str, peak_flops: float) -> dict:
    """Phase 7 (the docstring says what it checks)."""
    a = parallel_pair(here, os.path.join(here, PARALLEL_CONFIG),
                      PARALLEL_STEPS, "7a", peak_flops)
    with open(os.path.join(here, OFFLOAD_CONFIG)) as f:
        raw = json.load(f)
    raw["distributed"]["zero1"] = True
    raw["training"]["gradient_accumulation_steps"] = PARALLEL_OFFLOAD_GA
    t = raw["training"]
    raw["training"]["max_tokens"] = (PARALLEL_OFFLOAD_STEPS * t["seq_length"]
                                     * t["micro_batch_size"]
                                     * PARALLEL_OFFLOAD_GA)
    path = os.path.join(here, "build", "phase7b_offload_zero1.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    b = parallel_pair(here, path, PARALLEL_OFFLOAD_STEPS, "7b", peak_flops)
    return {"card": card, "zero1": a, "offload_zero1": b}


# ---------------------------------------------------------------------------
# phase 8: the cp schedules in a thread world
# ---------------------------------------------------------------------------


class ThreadWorld:
    """`n` threads standing for the n cp ranks of one process, all on one
    card, exchanging tensors through `ThreadComm`s (a barrier and one
    shared slot per rank). A harness for the card, which has one GPU:
    the schedules' own code runs unchanged at the per-rank shapes; the
    exchanges are clones on the one stream, not NCCL's send/recv and
    all-to-all. Drive only the schedules and their `*_bwd_from_saved`
    here, never `.backward()` through an exchange: a device's autograd
    nodes run on one engine thread shared by every thread of the
    process, and a node waiting at another thread's barrier would stall
    the world."""

    def __init__(self, n: int, timeout: float = THREAD_TIMEOUT_S):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n
        # for a harness that runs the ranks' work one at a time
        self.lock = threading.Lock()

    def comm(self, index: int) -> "ThreadComm":
        return ThreadComm(self, index)

    def abort(self) -> None:
        """Break every barrier a rank may wait at (a rank failed)."""
        self.barrier.abort()

    def run(self, fn) -> list:
        """fn(rank) on one thread per rank; the results in rank order. A
        failing rank aborts the barrier (so no rank waits forever) and its
        error is raised here."""
        out, errors = [None] * self.n, []

        def target(rank):
            try:
                out[rank] = fn(rank)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append((rank, e))
                self.abort()

        threads = [threading.Thread(target=target, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            errors.sort(key=lambda re: isinstance(re[1],
                                                  threading.BrokenBarrierError))
            rank, err = errors[0]
            raise AssertionError(f"thread world rank {rank}: {err!r}") from err
        return out


class ThreadComm:
    """The communicator of rank `index` of a `ThreadWorld`: the methods of
    `parallel.comm.CPComm`, handing over clones (every rank posts its
    part, all meet at the barrier, each takes copies of what it needs,
    all meet again). `counts` are this rank's calls by kind."""

    def __init__(self, world: ThreadWorld, index: int):
        self.world, self.index, self.size = world, index, world.n
        self.counts = {"send_recv": 0, "all_to_all": 0, "all_gather": 0,
                       "all_reduce": 0}

    def _swap(self, item, read):
        w = self.world
        w.slots[self.index] = item
        w.barrier.wait()
        try:
            return read(w.slots)
        finally:
            w.barrier.wait()

    def hop(self, tensors, dst: int, src: int) -> list:
        self.counts["send_recv"] += 1

        def read(slots):
            to, sent = slots[src]
            if to != self.index:
                raise AssertionError(f"rank {self.index} reads from {src}, "
                                     f"which sends to {to}")
            return [t.clone() for t in sent]

        return self._swap((dst, list(tensors)), read)

    def all_to_all(self, x, split_dim: int, concat_dim: int, members):
        from picotron_tpu_torch.parallel.comm import (
            concat_chunks, split_chunks,
        )

        self.counts["all_to_all"] += 1
        members = tuple(members)
        mine = members.index(self.index)
        got = self._swap(split_chunks(x, split_dim, len(members)),
                         lambda slots: torch.stack([slots[m][mine]
                                                    for m in members]))
        return concat_chunks(got, concat_dim)

    def all_gather(self, x, members):
        self.counts["all_gather"] += 1
        members = tuple(members)
        return self._swap(x.contiguous(), lambda slots: torch.cat(
            [slots[m] for m in members]))

    def exchange(self, sends, recvs) -> list:
        """`parallel.comm.PPComm.exchange` between the world's threads
        (one per pipeline stage): every rank meets at each tick boundary,
        whether it moves a tensor there or not; a receive takes a clone
        of what its source stage addressed to it, in list order, and must
        find the shape and dtype it expects."""
        if sends or recvs:
            self.counts["send_recv"] += 1

        def read(slots):
            out, taken = [], {}
            for src, shape, dtype in recvs:
                mine = [t for dst, t in slots[src] if dst == self.index]
                k = taken.get(src, 0)
                taken[src] = k + 1
                if k >= len(mine):
                    raise AssertionError(f"stage {self.index} expects a "
                                         f"tensor from stage {src}, which "
                                         f"sent it {len(mine)}")
                t = mine[k]
                if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                    raise AssertionError(
                        f"stage {self.index} expects {tuple(shape)} "
                        f"{dtype} from stage {src}, got "
                        f"{tuple(t.shape)} {t.dtype}")
                out.append(t.clone())
            return out

        return self._swap(list(sends), read)

    def all_reduce(self, t, ends: bool = False):
        """`parallel.comm.PPComm.all_reduce`: t summed in place over the
        world's ranks, in rank order (`ends`: a world of 2 stages, whose
        ends are all of it)."""
        if ends and self.size != 2:
            raise ValueError("a thread world sums over its ends only at "
                             "2 stages")
        self.counts["all_reduce"] += 1

        def read(slots):
            out = slots[0].clone()
            for s in slots[1:]:
                out += s
            return out

        t.copy_(self._swap(t, read))
        return t


class ThreadEPComm:
    """The ep communicator of rank `index` of a `ThreadWorld`
    (`parallel.comm.EPComm`'s `size`, `index` and `all_to_all`): chunk j
    of x goes to rank j. Where `EPComm` is an autograd node whose
    backward is the reverse exchange, this one is differentiable as it
    stands: each rank stacks the chunks the others posted, which keeps
    their autograd history, so the ranks' graphs join at the exchanges
    and ONE backward, from one thread, over the sum of the ranks' losses
    takes every rank's grads (a backward per thread would stall: a
    device's autograd nodes run on one engine thread). `counts` are this
    rank's calls."""

    def __init__(self, world: ThreadWorld, index: int):
        self.world, self.index, self.size = world, index, world.n
        self.counts = {"all_to_all": 0}
        self._comm = ThreadComm(world, index)

    def all_to_all(self, x):
        self.counts["all_to_all"] += 1
        me = self.index
        return self._comm._swap(x, lambda slots: torch.stack(
            [slots[m][me] for m in range(self.size)]))


class ThreadMean:
    """`parallel.comm.GroupMean` over the ranks of a `ThreadWorld`: the
    mean of every rank's tensor, summed in rank order, differentiable as
    `ThreadEPComm` is."""

    def __init__(self, world: ThreadWorld, index: int):
        self._comm = ThreadComm(world, index)

    def mean(self, t):
        def read(slots):
            out = slots[0]
            for s in slots[1:]:
                out = out + s
            return out / len(slots)

        return self._comm._swap(t, read)


def cp_raw(flavor: str = "", cp_layout: str = "zigzag", cp_mesh: str = "",
           cp: int = CP) -> dict:
    """Phase 8's configuration: runs/llama2-7b-cp4-seq8192 (and its mesh
    twin) at depth CP_LAYERS, one microbatch of one sequence."""
    d = {"cp_size": cp}
    if cp > 1:
        d.update(cp_layout=cp_layout, cp_flavor=flavor)
        if cp_mesh:
            d["cp_mesh"] = cp_mesh
    return {"model": {"name": "Llama-2-7B", "num_hidden_layers": CP_LAYERS,
                      "max_position_embeddings": CP_SEQ,
                      "dtype": "bfloat16"},
            "training": {"seq_length": CP_SEQ, "micro_batch_size": 1,
                         "gradient_accumulation_steps": 1, "remat": True,
                         "remat_policy": "dots_attn", "grad_engine": "fused"},
            "distributed": d}


def cp_layouts(seq: int = CP_SEQ) -> dict:
    """{name: (flavor, cp_mesh, CPLayout)} of the four schedules."""
    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.parallel.cp import layout_from_config

    out = {}
    for name, (flavor, lay, mesh) in CP_SCHEDULES.items():
        raw = cp_raw(flavor, lay, mesh)
        raw["training"]["seq_length"] = seq
        cfg = config_from_dict(raw)
        cp_mesh = (tuple(int(x) for x in mesh.split("x")) if mesh
                   else (CP, 1))
        out[name] = (flavor, cp_mesh, layout_from_config(cfg))
    return out


def zigzag_off_by_one_chunk(layout):
    """Phase 8b's planted fault: every zigzag chunk index one too high
    (mod 2cp), a permutation of the positions that is not the data's."""
    from picotron_tpu_torch.ops.ring_attention import CPLayout

    n, s_local = layout.positions.shape
    half = s_local // 2
    chunk = layout.positions // half
    return CPLayout(((chunk + 1) % (2 * n)) * half + layout.positions % half)


def zigzag_swapped_in_rank(layout, rank: int = 1):
    """Phase 8a's planted fault: rank `rank`'s two zigzag chunks swapped
    in its positions."""
    from picotron_tpu_torch.ops.ring_attention import CPLayout

    pos = layout.positions.copy()
    half = pos.shape[1] // 2
    pos[rank] = list(pos[rank, half:]) + list(pos[rank, :half])
    return CPLayout(pos)


class _Recorder:
    """A schedule's block function, counted: each call runs under the
    world's lock (so the flash wrappers' counts before and after it are
    this rank's launches) and keeps its arguments for the timing."""

    def __init__(self, fn, lock):
        self.fn, self.lock = fn, lock
        self.calls = []
        self.launches = {}

    def __call__(self, *args, **kw):
        from picotron_tpu_torch.ops import flash_attention as fa

        with self.lock:
            before = launch_counts(fa)
            res = self.fn(*args, **kw)
            after = launch_counts(fa)
        self.calls.append((args, kw))
        for key, counts in after.items():
            mine = self.launches.setdefault(key, {})
            for k, v in counts.items():
                mine[k] = mine.get(k, 0) + v - before[key][k]
        return res


def run_schedule(flavor, cp_mesh, layout, tensors, blocks, lock,
                 saved=None):
    """The schedule and its backward from the saved (out, lse) on every
    rank of a thread world: per rank (out, lse, dq, dk, dv, forward
    recorder, backward recorder, exchanges). `tensors[r]` is rank r's
    (q, k, v, dout) slice, `blocks` the (forward, backward) block
    functions; with `saved` (per rank (out, lse)) only the backward runs,
    from those."""
    from picotron_tpu_torch.ops import mesh_attention as ma
    from picotron_tpu_torch.ops import ring_attention as ra
    from picotron_tpu_torch.ops import ulysses as ul

    world = ThreadWorld(CP)

    def rank_fn(r):
        comm = world.comm(r)
        q, k, v, do = tensors[r]
        fwd, bwd = _Recorder(blocks[0], lock), _Recorder(blocks[1], lock)
        if flavor == "ulysses":
            full, seq_sort = ul.ulysses_static_layout(layout.full())
            kw = dict(seq_sort=seq_sort, full_positions=full,
                      positions_static=True)
            out, lse = saved[r] if saved else ul.ulysses_attention(
                q, k, v, comm, attn_fn=fwd, return_lse=True, **kw)
            grads = ul.ulysses_attention_bwd_from_saved(
                q, k, v, out, lse, do, comm, attn_bwd=bwd, **kw)
        else:
            sched, sched_bwd, kw = (
                (ra.ring_attention, ra.ring_attention_bwd_from_saved, {})
                if flavor == "ring" else
                (ma.mesh_attention, ma.mesh_attention_bwd_from_saved,
                 {"cp_mesh": cp_mesh}))
            out, lse = saved[r] if saved else sched(
                q, k, v, comm, layout=layout,
                attn_block=functools.partial(fwd, return_lse=True),
                return_lse=True, **kw)
            grads = sched_bwd(q, k, v, out, lse, do, comm, layout=layout,
                              block_bwd=bwd, **kw)
        return (out, lse, *grads, fwd, bwd, comm.counts)

    res = world.run(rank_fn)
    torch.cuda.synchronize()
    return res


def plain_flash(q, k, v, *, causal=True, q_positions=None,
                kv_positions=None, return_lse=False, sm_scale=None,
                rope=None):
    """`flash_attention` with the forward kernel's plain version in its
    place (`fwd_plain`), so that it rounds where the wrapper does (q
    scaled in its dtype)."""
    from picotron_tpu_torch.ops import flash_attention as fa

    qpos = fa._positions(q_positions, q.shape[1], q.device)
    kpos = fa._positions(kv_positions, k.shape[1], q.device)
    scale = torch.tensor(sm_scale or q.shape[-1] ** -0.5, dtype=q.dtype)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    out4, lse = fa.fwd_plain(t(q * scale), t(k), t(v), qpos, kpos,
                             fa._tables(rope, qpos, kpos), causal)
    return (t(out4), lse) if return_lse else t(out4)


def plain_flash_bwd(q, k, v, out, lse, dout, *, causal=True,
                    q_positions=None, kv_positions=None, sm_scale=None,
                    rope=None):
    """`flash_attention_bwd_from_saved` with the backward kernels' plain
    version in their place (`bwd_plain`)."""
    from picotron_tpu_torch.ops import flash_attention as fa

    qpos = fa._positions(q_positions, q.shape[1], q.device)
    kpos = fa._positions(kv_positions, k.shape[1], q.device)
    scale = torch.tensor(sm_scale or q.shape[-1] ** -0.5, dtype=q.dtype)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    dq4, dk4, dv4 = fa.bwd_plain(t(q * scale), t(k), t(v), t(out), lse,
                                 t(dout), None, qpos, kpos,
                                 fa._tables(rope, qpos, kpos), causal)
    return t(dq4) * scale, t(dk4), t(dv4)


def schedule_references(flavor, cp_mesh, layout, ref):
    """Per rank, the rows of the whole-sequence (out, lse, dq, dk, dv)
    that the schedule's outputs hold: out and the grads at the rank's
    positions; lse merged (ring), in the inner domain (Ulysses: the
    rank's heads, every position in order) or in the row domain (mesh:
    the rank's head block at its row's positions)."""
    out, lse, dq, dk, dv = ref
    h = out.shape[2]
    want = []
    for r in range(CP):
        idx = torch.as_tensor(layout.positions[r], device=out.device)
        if flavor == "ring":
            lse_r = lse[:, :, idx]
        elif flavor == "ulysses":
            lse_r = lse[:, r * h // CP:(r + 1) * h // CP]
        else:
            cp_x, cp_y = cp_mesh
            x, y = divmod(r, cp_y)
            rows = torch.as_tensor(layout.rows(cp_y).positions[x],
                                   device=out.device)
            lse_r = lse[:, y * h // cp_y:(y + 1) * h // cp_y][:, :, rows]
        want.append((out[:, idx], lse_r, dq[:, idx], dk[:, idx],
                     dv[:, idx]))
    return want


def schedule_errors(got, want) -> dict:
    """{output: worst row error over the ranks} (phase 2's measure)."""
    worst = {}
    for g, w in zip(got, want):
        for key, a, b in zip(("out", "lse", "dq", "dk", "dv"), g, w):
            err = float(row_errors(a, b, lse=key == "lse").max())
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def over_limits(worst: dict) -> list:
    return [f"{k} {v:.4g}" for k, v in worst.items()
            if not v <= (LSE_ATOL if k == "lse" else ROW_RTOL)]


def _kernel_operands(args, kw):
    """A recorded block call's kernel operands ([B,H,S,D], q scaled)."""
    from picotron_tpu_torch.ops import flash_attention as fa

    q = args[0]
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    qp, kp = kw.get("q_positions"), kw.get("kv_positions")
    static = qp is None and kp is None
    qpos = fa._positions(qp, q.shape[1], q.device)
    kpos = fa._positions(kp, args[1].shape[1], q.device)
    return (t(q * scale), t(args[1]), t(args[2]),
            *(t(x) for x in args[3:6] if x.dim() == 4)), qpos, kpos, static


def rank_kernel_times(fwd_calls, bwd_calls) -> dict:
    """One rank's kernel time per kernel (ms, CUDA events): its recorded
    block calls replayed on the kernels alone, the visiting blocks
    prepared beforehand; and their bound, summed over the calls."""
    from picotron_tpu_torch.ops import flash_attention as fa

    fwd_ops, bwd_ops, bound = [], [], {}
    for args, kw in fwd_calls:
        (q4, k4, v4), qpos, kpos, static = _kernel_operands(args, kw)
        fwd_ops.append((q4, k4, v4, qpos, kpos, static))
    for args, kw in bwd_calls:
        (q4, k4, v4, o4, do4), qpos, kpos, static = _kernel_operands(args, kw)
        lse = args[4]
        bwd_ops.append((q4, k4, v4, do4, lse, fa._delta(do4, o4, None), qpos,
                        kpos, static))
        b, hq, _, d = q4.shape
        for name, (ms, _, _) in bounds_at(b, hq, k4.shape[1], d,
                                          qpos.cpu().numpy(),
                                          kpos.cpu().numpy(),
                                          rope=False).items():
            bound[name] = bound.get(name, 0.0) + ms
    times = {
        "flash_fwd": cuda_ms(lambda: [fa.fwd_kernel(
            q4, k4, v4, qp, kp, None, True, st)
            for q4, k4, v4, qp, kp, st in fwd_ops]),
        "flash_bwd_dq": cuda_ms(lambda: [fa.bwd_dq_kernel(
            q4, k4, v4, do4, lse, dl, qp, kp, None, True, st)
            for q4, k4, v4, do4, lse, dl, qp, kp, st in bwd_ops]),
        "flash_bwd_dkv": cuda_ms(lambda: [fa.bwd_dkv_kernel(
            q4, k4, v4, do4, lse, dl, qp, kp, None, True, st)
            for q4, k4, v4, do4, lse, dl, qp, kp, st in bwd_ops]),
    }
    return {name: (times[name], bound[name]) for name in times}


def whole_sequence(q, k, v, do):
    """The whole sequence through the kernels (static causal): (out, lse,
    dq, dk, dv)."""
    from picotron_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    grads = fa.flash_attention_bwd_from_saved(q, k, v, out, lse, do,
                                              causal=True)
    torch.cuda.synchronize()
    return (out, lse, *grads)


def cp_schedules_phase(card: str, shape: tuple = CP_SHAPE) -> dict:
    """Phase 8a (the docstring says what it checks), at `shape` (B, S,
    Hq, Hkv, D)."""
    from picotron_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = shape
    g = torch.Generator(device="cuda").manual_seed(8)
    r = lambda *sh: torch.randn(*sh, generator=g,  # noqa: E731
                                device="cuda").to(torch.bfloat16)
    q, k, v, do = r(b, s, hq, d), r(b, s, hkv, d), r(b, s, hkv, d), r(b, s,
                                                                       hq, d)
    ref = whole_sequence(q, k, v, do)
    # the whole sequence's kernel times (the forward's operands as the
    # schedules' recorded calls would give them)
    whole = rank_kernel_times(
        [((q, k, v), {})], [((q, k, v, ref[0], ref[1], do), {})])
    lock = threading.Lock()
    flash = (fa.flash_attention, fa.flash_attention_bwd_from_saved)
    plain = (plain_flash, plain_flash_bwd)
    out = {"card": card, "shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv,
                                   "D": d, "cp": CP},
           "whole_sequence_ms": {n: t for n, (t, _) in whole.items()},
           "whole_sequence_bound_ms": {n: bd for n, (_, bd) in whole.items()},
           "schedules": {}}
    for name, (flavor, cp_mesh, layout) in cp_layouts(s).items():
        tensors = [tuple(x[:, torch.as_tensor(layout.positions[rk],
                                              device="cuda")].contiguous()
                         for x in (q, k, v, do)) for rk in range(CP)]
        want = schedule_references(flavor, cp_mesh, layout, ref)
        got = run_schedule(flavor, cp_mesh, layout, tensors, flash, lock)
        got_plain = run_schedule(flavor, cp_mesh, layout, tensors, plain,
                                 lock)
        # the backward kernels from the plain forward's (out, lse), as in
        # phase 2, so that each is held to its own plain version alone
        saved = [x[:2] for x in got_plain]
        got_bwd = run_schedule(flavor, cp_mesh, layout, tensors, flash,
                               lock, saved)
        vs_whole = schedule_errors([x[:5] for x in got], want)
        vs_plain = schedule_errors(
            [x[:2] + y[2:5] for x, y in zip(got, got_bwd)],
            [x[:5] for x in got_plain])
        # launches per rank and call: the forward recorder saw the
        # forward kernel only, the backward recorder dq and dk/dv
        per_rank = []
        for rk, res in enumerate(got):
            fwd_rec, bwd_rec = res[5], res[6]
            n_f, n_b = len(fwd_rec.calls), len(bwd_rec.calls)
            want_n = CP_LAUNCHES[name](rk)
            lf, lb = fwd_rec.launches, bwd_rec.launches
            ok = (n_f == n_b == want_n
                  and lf["launches"]["flash_fwd"] == want_n
                  and lf["fwd_launches"] == {"tensor_core": want_n,
                                             "cuda_core": 0}
                  and lb["launches"]["flash_bwd_dq"] == want_n
                  and lb["launches"]["flash_bwd_dkv"] == want_n
                  and lb["dq_launches"] == bf16_variants(
                      "dq_launches", want_n, CP_SHAPE[-1])
                  and lb["dkv_launches"] == bf16_variants(
                      "dkv_launches", want_n, CP_SHAPE[-1])
                  # no RoPE tables reach these blocks: no pre-pass
                  and lb["prepass_launches"] == {"rope_rows": 0}
                  and lf["launches"]["flash_bwd_dq"] == 0
                  and lb["launches"]["flash_fwd"] == 0)
            if not ok:
                raise AssertionError(
                    f"phase 8a {name} rank {rk}: {n_f} forward and {n_b} "
                    f"backward block calls, launches {lf} / {lb}; want "
                    f"{want_n} of each kernel, all on the tensor cores")
            per_rank.append(want_n)
        times = [rank_kernel_times(res[5].calls, res[6].calls)
                 for res in got]
        exchanges = got[0][7]
        entry = {"worst_row_vs_whole_sequence": vs_whole,
                 "worst_row_vs_plain_blocks": vs_plain,
                 "launches_per_rank": per_rank,
                 "exchanges_rank0": exchanges,
                 "rank_ms": [{n: t for n, (t, _) in tm.items()}
                             for tm in times],
                 "rank_bound_ms": [{n: bd for n, (_, bd) in tm.items()}
                                   for tm in times]}
        log(f"phase 8a {name}: worst row vs the whole sequence {vs_whole}, "
            f"vs the plain blocks {vs_plain}; launches per rank {per_rank} "
            f"(each kernel, all tensor-core); rank 0 exchanges {exchanges}")
        for rk, tm in enumerate(times):
            log(f"  rank {rk} kernels ({card}): " + ", ".join(
                f"{n} {t:.3f} ms (bound {bd:.3f}, whole sequence / {CP} "
                f"{whole[n][0] / CP:.3f})" for n, (t, bd) in tm.items()))
        fails = over_limits(vs_whole) + over_limits(vs_plain)
        if fails:
            raise AssertionError(f"phase 8a {name}: rows over the limits: "
                                 + ", ".join(fails))
        if name == "ulysses zigzag":
            entry["sdpa_ms"] = sdpa_times(*[x for x in got[0][5].calls[0][0]
                                            [:3]], got[0][6].calls[0][0][5])
        out["schedules"][name] = entry
        del got, got_plain, got_bwd, saved, tensors
        torch.cuda.empty_cache()
    # the planted fault: rank 1's zigzag chunks swapped in its positions
    flavor, cp_mesh, layout = cp_layouts(s)["ring zigzag"]
    bad = zigzag_swapped_in_rank(layout)
    tensors = [tuple(x[:, torch.as_tensor(layout.positions[rk],
                                          device="cuda")].contiguous()
                     for x in (q, k, v, do)) for rk in range(CP)]
    got = run_schedule(flavor, cp_mesh, bad, tensors, flash, lock)
    fault = schedule_errors([x[:5] for x in got],
                            schedule_references(flavor, cp_mesh, layout, ref))
    log(f"phase 8a planted fault (rank 1's zigzag chunks swapped): worst "
        f"rows {fault}")
    if not over_limits(fault):
        raise AssertionError(f"phase 8a: the planted fault passed the "
                             f"limits: {fault}")
    out["planted_fault"] = fault
    return out


def sdpa_times(q, k, v, do) -> dict:
    """PyTorch's SDPA at a Ulysses inner call's shape (static causal, no
    RoPE): forward, and one backward computing dq, dk and dv."""
    import torch.nn.functional as F

    t = lambda x: x.transpose(1, 2).detach().requires_grad_()  # noqa: E731
    qt, kt, vt = t(q), t(k), t(v)
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    o = fn()
    dot = do.transpose(1, 2)
    return {"fwd": cuda_ms(fn), "bwd": cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True))}


def cp_model_phase(card: str) -> dict:
    """Phase 8b (the docstring says what it checks)."""
    import numpy as np

    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.models.llama import LlamaModel, init_params
    from picotron_tpu_torch.ops import flash_attention as fa
    from picotron_tpu_torch.parallel import comm
    from picotron_tpu_torch.parallel.cp import CPContext
    from picotron_tpu_torch.parallel.fused_bwd import (
        ComputeWeights, fused_micro_grads,
    )

    cfg1 = config_from_dict(cp_raw(cp=1))
    gen = torch.Generator(device="cuda").manual_seed(CP_MODEL_SEED)
    model1 = init_params(LlamaModel(cfg1.model, device="cuda"), gen)
    toks = np.random.default_rng(CP_MODEL_SEED).integers(
        0, cfg1.model.vocab_size, (1, CP_SEQ + 1))
    ids = torch.from_numpy(toks[:, :-1]).cuda()
    tgt = torch.from_numpy(toks[:, 1:]).cuda()
    names = [n for n, _ in model1.named_parameters()]

    def micro(model, ids_, tgt_):
        weights = ComputeWeights(model)
        weights.refresh()
        acc = {p: torch.zeros_like(p) for p in model.parameters()}
        total, count = fused_micro_grads(model, weights, ids_, tgt_, acc)
        return float(total), int(count), {n: acc[p] for n, p in zip(
            names, model.parameters())}

    total1, count1, grads1 = micro(model1, ids, tgt)
    loss1 = total1 / count1
    state = model1.state_dict()
    out = {"card": card, "layers": CP_LAYERS, "seq": CP_SEQ,
           "cp1_loss": loss1, "layouts": {}}
    runs = dict(cp_layouts())
    flavor, cp_mesh, layout = runs["ring zigzag"]
    runs["planted fault: ring zigzag off by one chunk"] = (
        flavor, cp_mesh, zigzag_off_by_one_chunk(layout), layout)
    for name, spec in runs.items():
        flavor, cp_mesh, layout = spec[:3]
        data_layout = spec[3] if len(spec) > 3 else layout
        world = ThreadWorld(CP)
        ctxs = [CPContext(world.comm(r), flavor, layout, cp_mesh)
                for r in range(CP)]
        models = []
        for ctx in ctxs:
            m = LlamaModel(cfg1.model, device="cuda", cp=ctx)
            m.load_state_dict(state)
            models.append(m)
        sl = [torch.as_tensor(data_layout.positions[r], device="cuda")
              for r in range(CP)]
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        comm.reset_collective_counts()
        res = world.run(lambda r: micro(models[r], ids[:, sl[r]],
                                        tgt[:, sl[r]]))
        torch.cuda.synchronize()
        counts = launch_counts(fa)
        dist_calls = dict(comm.collectives)
        total = sum(x[0] for x in res)
        count = sum(x[1] for x in res)
        loss_err = abs(total / count - loss1) / abs(loss1)
        grad_errs = {n: rel_l2(sum(x[2][n] for x in res), grads1[n])
                     for n in names}
        worst = max(grad_errs, key=grad_errs.get)
        entry = {"loss": total / count, "count": count, "cp1_count": count1,
                 "loss_rel_err": loss_err,
                 "worst_grad_rel_l2": grad_errs[worst], "worst_grad": worst,
                 "grad_rel_l2": grad_errs, "launches": counts,
                 "exchanges_rank0": ctxs[0].comm.counts,
                 "torch_distributed_calls": dist_calls}
        log(f"phase 8b {name}: loss {total / count} (cp 1: {loss1}, rel "
            f"err {loss_err:.3g}), tokens {count} (cp 1: {count1}), worst "
            f"grad rel L2 {grad_errs[worst]:.3g} ({worst}); launches "
            f"{counts['launches']}; rank 0 exchanges {ctxs[0].comm.counts}")
        out["layouts"][name] = entry
        passed = (count == count1 and loss_err <= CP_LOSS_RTOL
                  and grad_errs[worst] <= CP_GRAD_RTOL)
        if name.startswith("planted fault"):
            if passed:
                raise AssertionError(f"phase 8b: the planted fault passed "
                                     f"the limits ({entry['loss_rel_err']}, "
                                     f"{grad_errs[worst]})")
        else:
            want = CP_LAYERS * sum(CP_LAUNCHES[name](r) for r in range(CP))
            fails = []
            if not passed:
                fails.append(f"loss rel err {loss_err:.3g} (limit "
                             f"{CP_LOSS_RTOL}), tokens {count} vs {count1}, "
                             f"grad {worst} rel L2 {grad_errs[worst]:.3g} "
                             f"(limit {CP_GRAD_RTOL})")
            try:
                check_launches(counts, {k: want for k, _ in KERNELS},
                               f"phase 8b {name}", d=128)
            except AssertionError as e:
                fails.append(str(e))
            if any(dist_calls.values()):
                fails.append(f"torch.distributed calls in the thread world: "
                             f"{dist_calls}")
            if fails:
                raise AssertionError(f"phase 8b {name}: " + "; ".join(fails))
        del models, ctxs, res
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the pipeline's walks in a thread world
# ---------------------------------------------------------------------------


def _pp_runner(lock, ledger: dict, fault: bool):
    """The pipeline's stage ops (`parallel.pp.StageRunner`) run one at a
    time under `lock`, so that each stage's kernel launches and memory
    can be read off the card's counters around its own ops: per stage,
    the flash launches of its ops, the bytes its ops leave allocated
    (the graphs it holds), and its peak (held bytes + an op's
    transient). With `fault`, the first virtual stage embeds microbatch
    m+1 in place of m (the last wraps to 0), so that stage 1 is fed
    microbatch m+1's activation as m's."""
    from picotron_tpu_torch.ops import flash_attention as fa
    from picotron_tpu_torch.parallel.pp import StageRunner

    class Serial(StageRunner):
        def _op(self, fn, *args):
            rec = ledger[self.model.stage.index]
            with lock:
                before = dict(fa.launches)
                m0 = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = fn(*args)
                peak = torch.cuda.max_memory_allocated() - m0
                rec["peak"] = max(rec["peak"], rec["held"] + peak)
                rec["held"] += torch.cuda.memory_allocated() - m0
                for k, v in fa.launches.items():
                    rec["launches"][k] = (rec["launches"].get(k, 0)
                                          + v - before[k])
            return out

        def _received(self, t):
            # a boundary tensor the exchange allocated for this stage
            if t is not None:
                with lock:
                    ledger[self.model.stage.index]["held"] += (
                        t.numel() * t.element_size())

        def forward(self, j, mb, x):
            self._received(x)
            if fault and j == 0:
                mb = (mb + 1) % self.ids.shape[0]
            return self._op(super().forward, j, mb, x)

        def backward(self, j, mb, graph, g):
            self._received(g)
            return self._op(super().backward, j, mb, graph, g)

    return Serial


def pp_launches(pipeline: dict, name: str) -> dict:
    """{walk: [launches of kernel `name` per stage]} of phase 9's walks."""
    return {walk: [st["adamw"] if name == "adamw" else st["flash"][name]
                   for st in entry["stages"]]
            for walk, entry in pipeline["walks"].items()
            if not walk.startswith("planted")}


def pp_walk(raw: dict, state: dict, batch, fault: bool = False) -> dict:
    """One step of the pipeline (`raw`, pp 2) in a thread world on the
    card: each stage built from `state` (a whole model's state dict),
    its walk (`parallel.pp.PipelineGrads` over a `ThreadComm`), its grad
    norm summed over the stages and its AdamW update; per stage the
    walk's stats, its grads before the update, its launches and memory."""
    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.models.llama import LlamaModel, pipeline_stage
    from picotron_tpu_torch.optimizer import AdamW
    from picotron_tpu_torch.parallel.pp import PipelineGrads
    from picotron_tpu_torch.weights import stage_params

    cfg = config_from_dict(raw)
    d = cfg.distributed
    world = ThreadWorld(d.pp_size)
    ledger = {r: {"held": 0, "peak": 0, "launches": {}}
              for r in range(d.pp_size)}
    stages = []
    for r in range(d.pp_size):
        m0 = torch.cuda.memory_allocated()
        model = LlamaModel(cfg.model, device="cuda", stage=pipeline_stage(
            cfg.model.num_hidden_layers, d.pp_size, r,
            cfg.pipeline.interleave))
        model.load_state_dict(stage_params(state, model))
        comm = world.comm(r)
        opt = AdamW(model, cfg.training, pp=comm)
        grads = PipelineGrads(cfg, comm=comm,
                              runner=_pp_runner(world.lock, ledger, fault))
        ledger[r]["state"] = torch.cuda.memory_allocated() - m0
        stages.append((model, opt, grads))
    adamw = [0] * d.pp_size

    def rank(r):
        model, opt, grads = stages[r]
        loss, scale = grads(model, batch, opt.grad_of, step=1)
        norm = opt.grad_norm()
        got = {n: opt.grad_of[p].detach().clone()
               for n, p in model.named_parameters()}
        with world.lock:
            before = topt.launches["adamw"]
            opt.step(scale, grad_norm=norm)
            adamw[r] = topt.launches["adamw"] - before
        return {"loss": float(loss), "count": int(round(1 / float(scale))),
                "grad_norm": float(norm) * float(scale), "grads": got,
                "stats": grads.stats, "layers": model.stage.layers}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = world.run(rank)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, res in enumerate(out):
        res.update(adamw=adamw[r], **{k: ledger[r][k] for k in (
            "launches", "state", "peak")})
    del stages
    torch.cuda.empty_cache()
    return {"stages": out, "wall_s": wall}


def pp_phase(card: str, raw: Optional[dict] = None) -> dict:
    """Phase 9: the pipeline's five walks (PP_WALKS) of PP_CONFIG, or of
    `raw`, in a thread world of 2 on the card, each against pp 1 on the
    same params and batch (AD, the config's remat policy): each
    microbatch's loss within PP_LOSS_RTOL, every grad tensor within
    PP_GRAD_RTOL in relative L2, the same token count, and the grad norm
    summed over the stages within PP_GRAD_RTOL; per stage its layers x
    n_micro forward launches (twice under remat "full") and its layers x
    n_micro of each backward kernel, all on the tensor cores, and one
    AdamW launch per tensor it holds; and the planted fault (PP_FAULT)
    must fail the limits."""
    import numpy as np

    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.models.llama import (
        LlamaModel, init_params, loss_sum_count,
    )
    from picotron_tpu_torch.ops import flash_attention as fa
    from picotron_tpu_torch.optimizer import global_norm
    from picotron_tpu_torch.parallel.mpmd import schedule_stats
    from picotron_tpu_torch.parallel.pp import pp_1f1b_ring_slots

    if raw is None:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               PP_CONFIG)) as f:
            raw = json.load(f)
    one = {**raw, "distributed": {**raw["distributed"], "pp_size": 1}}
    cfg1 = config_from_dict(one)
    t = cfg1.training
    remat = t.remat_policy if t.remat else None
    gen = torch.Generator(device="cuda").manual_seed(PP_SEED)
    model1 = init_params(LlamaModel(cfg1.model, device="cuda"), gen)
    n, mbs, seq = t.gradient_accumulation_steps, t.micro_batch_size, \
        t.seq_length
    toks = np.random.default_rng(PP_SEED).integers(
        0, cfg1.model.vocab_size, (n, mbs, seq + 1))
    batch = (torch.from_numpy(toks[..., :-1]).cuda(),
             torch.from_numpy(toks[..., 1:]).cuda())
    mb1 = []
    for i in range(n):
        total, count, _ = loss_sum_count(model1, batch[0][i], batch[1][i],
                                         remat, t.ce_chunk_size)
        total.backward()
        mb1.append((float(total.detach()), int(count)))
    grads1 = grads_of(model1)
    count1 = sum(c for _, c in mb1)
    norm1 = float(global_norm(list(grads1.values()))) / count1
    state = {k: v.detach().clone() for k, v in model1.state_dict().items()}
    del model1
    torch.cuda.empty_cache()
    recomputes = 1 if remat == "full" else 0
    out = {"card": card, "layers": cfg1.model.num_hidden_layers,
           "seq": seq, "n_micro": n, "remat": remat,
           "limits": {"loss_rtol": PP_LOSS_RTOL, "grad_rtol": PP_GRAD_RTOL},
           "walks": {}}
    walks = dict(PP_WALKS)
    walks[PP_FAULT] = {}
    for name, over in walks.items():
        wraw = {**raw, **{k: {**raw.get(k, {}), **v} for k, v in
                          over.items()}}
        cfg = config_from_dict(wraw)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        topt.reset_launch_counts()
        res = pp_walk(wraw, state, batch, fault=name == PP_FAULT)
        counts = launch_counts(fa)
        stages = res["stages"]
        last = stages[-1]["stats"].mb_losses
        mb_err = max(abs(float(last[m][0]) - mb1[m][0]) / abs(mb1[m][0])
                     for m in range(n))
        count = sum(int(last[m][1]) for m in range(n))
        got = {k: g for s in stages for k, g in s["grads"].items()}
        grad_errs = {k: rel_l2(got[k], grads1[k]) for k in grads1}
        worst = max(grad_errs, key=grad_errs.get)
        norm_err = abs(stages[0]["grad_norm"] - norm1) / norm1
        pl = cfg.pipeline
        kind = (pl.schedule if pl.executor == "mpmd" else "spmd")
        bubble = schedule_stats(kind, n, 2, pl.interleave)["bubble_fraction"]
        entry = {
            "loss_rel_err_max": mb_err, "count": count, "pp1_count": count1,
            "worst_grad_rel_l2": grad_errs[worst], "worst_grad": worst,
            "grad_norm_rel_err": norm_err,
            "bit_for_bit": (mb_err == 0.0 and grad_errs[worst] == 0.0),
            "wall_s_one_card_stages_serialised": res["wall_s"],
            "predicted_bubble_fraction": bubble,
            "ring_slots": pp_1f1b_ring_slots(n, 2),
            "stages": [{
                "layers": s["layers"],
                "peak_gib": (s["state"] + s["peak"]) / 2 ** 30,
                "state_gib": s["state"] / 2 ** 30,
                "max_in_flight": s["stats"].max_in_flight,
                "exchanges": s["stats"].exchanges,
                "flash": s["launches"], "adamw": s["adamw"]}
                for s in stages]}
        out["walks"][name] = entry
        st = entry["stages"]
        log(f"phase 9 {name}: loss rel err {mb_err:.3g} (limit "
            f"{PP_LOSS_RTOL}), tokens {count} (pp 1: {count1}), worst grad "
            f"rel L2 {grad_errs[worst]:.3g} ({worst}; limit "
            f"{PP_GRAD_RTOL}), grad norm rel err {norm_err:.3g}, bit for "
            f"bit {entry['bit_for_bit']}; wall {res['wall_s']:.3f} s on "
            f"one card with the stages serialised, not a pipeline's speed "
            f"(predicted bubble {bubble:.3f})")
        for r, s in enumerate(st):
            log(f"phase 9 {name} stage {r} (layers {s['layers']}): peak "
                f"{s['peak_gib']:.2f} GiB (state {s['state_gib']:.2f}), "
                f"graphs in flight {s['max_in_flight']} (1f1b ring slots "
                f"{entry['ring_slots']}), exchanges {s['exchanges']}, flash "
                f"{s['flash']}, adamw {s['adamw']} ({card})")
        passed = (count == count1 and mb_err <= PP_LOSS_RTOL
                  and grad_errs[worst] <= PP_GRAD_RTOL
                  and norm_err <= PP_GRAD_RTOL)
        if name == PP_FAULT:
            if passed:
                raise AssertionError(f"phase 9: the planted fault passed the "
                                     f"limits ({mb_err}, {grad_errs[worst]})")
            continue
        fails = []
        k_all = sum(len(x["layers"]) for x in stages) * n
        try:
            check_launches(counts, {"flash_fwd": k_all * (1 + recomputes),
                                    "flash_bwd_dq": k_all,
                                    "flash_bwd_dkv": k_all},
                           f"phase 9 {name}", d=cfg1.model.head_dim)
        except AssertionError as e:
            fails.append(str(e))
        if topt.launches["adamw"] != sum(x["adamw"] for x in stages):
            fails.append(f"adamw launched {topt.launches['adamw']} times, "
                         f"the stages counted "
                         f"{[x['adamw'] for x in stages]}")
        if not passed:
            fails.append(f"loss rel err {mb_err:.3g}, tokens {count} vs "
                         f"{count1}, grad {worst} rel L2 "
                         f"{grad_errs[worst]:.3g}, grad norm rel err "
                         f"{norm_err:.3g}")
        for r, s in enumerate(stages):
            k = len(s["layers"]) * n
            want = {"flash_fwd": k * (1 + recomputes), "flash_bwd_dq": k,
                    "flash_bwd_dkv": k}
            if s["launches"] != want:
                fails.append(f"stage {r} flash launches {s['launches']}, "
                             f"want {want}")
            if s["adamw"] != len(s["grads"]):
                fails.append(f"stage {r} adamw launched {s['adamw']} times, "
                             f"want {len(s['grads'])}")
            if (kind == "spmd" and cfg.distributed.pp_engine == "1f1b"
                    and s["stats"].max_in_flight > entry["ring_slots"]):
                fails.append(f"stage {r} held {s['stats'].max_in_flight} "
                             f"graphs, over the ring's "
                             f"{entry['ring_slots']}")
        if fails:
            raise AssertionError(f"phase 9 {name}: " + "; ".join(fails))
    return out


_MAIN_PATH_CHILD = """
import json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke
from picotron_tpu_torch.kernels import build
from picotron_tpu_torch.ops import flash_attention as fa
for name in ("flash_attention", "adamw"):
    build.build(name)
res = chip_smoke.main_path(fa, tree)
print("MAIN_PATH " + json.dumps({"tree": sys.argv[1], "losses": res["losses"],
                                 "step_seconds": res["step_seconds"]}))
"""


# ---------------------------------------------------------------------------
# phase 10: generation and the serving engine
# ---------------------------------------------------------------------------


def make_serve_trace(n_requests: int, prompt_len: int, max_new: int,
                     vocab: int, seed: int) -> list:
    """bench.py's `make_serve_trace` at rate 0 (every request arrives at
    t = 0): prompts of [prompt_len / 8, prompt_len] tokens, budgets of
    [max_new / 8, max_new], drawn from the seed with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        plen = int(rng.integers(max(prompt_len // 8, 1), prompt_len + 1))
        olen = int(rng.integers(max(max_new // 8, 1), max_new + 1))
        out.append((rng.integers(0, vocab, size=plen).tolist(), olen, 0.0))
    return out


def serve_models(seed: int, config: str, device: str):
    """(fp32 model, bf16 model) of the config's model (CONFIG: SmolLM-1.7B),
    initialised on `device` from the seed; the bf16 one holds the fp32
    one's params rounded (the `--load-dtype bfloat16` load)."""
    import dataclasses

    from picotron_tpu_torch.config import load_config
    from picotron_tpu_torch.generate import load_for_decode
    from picotron_tpu_torch.models.llama import LlamaModel, init_params

    here = os.path.dirname(os.path.abspath(__file__))
    cfg16 = load_config(os.path.join(here, config)).model
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    model32 = LlamaModel(cfg32, device=device)
    init_params(model32, torch.Generator(device=device).manual_seed(seed))
    model16 = load_for_decode({n: t.to(torch.bfloat16) for n, t in
                               model32.state_dict().items()}, cfg16, device)
    return model32, model16


def decode_bytes(model, batch: int, kv_tokens: int) -> int:
    """Least bytes one decode step moves: every weight the step reads once
    (the embedding only for its `batch` rows) and `kv_tokens` tokens of
    K and V per layer, read (plus the step's own K/V written)."""
    cfg = model.cfg
    el = next(model.parameters()).element_size()
    weights = sum(p.numel() for n, p in model.named_parameters()
                  if n != "embedding") * el
    if model.lm_head is None:  # tied: the head reads the embedding
        weights += model.embedding.numel() * el
    weights += batch * cfg.hidden_size * el
    per_token = (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
                 * cfg.head_dim * el)
    return weights + (kv_tokens + batch) * per_token


@torch.no_grad()
def cache_logits(model, prompt, tokens, cache_cls=None):
    """The logits the offline decode sees [B, N, V] fp32, teacher-forced:
    the prompt prefilled in one pass, then tokens[:, :N-1] decoded one
    at a time (the ops and shapes of `generate`'s steps). `cache_cls`
    wraps the cache (a planted fault)."""
    from picotron_tpu_torch import generate as gen
    from picotron_tpu_torch.models.llama import embed, model_rope_tables

    b, p = prompt.shape
    n = tokens.shape[1]
    cfg, dev = model.cfg, prompt.device
    cos, sin = model_rope_tables(cfg, max_len=p + n + 1, device=dev)
    cache = gen.init_cache(cfg, b, p + n + 1, device=dev,
                           heads=gen.kv_heads(model))
    if cache_cls is not None:
        cache = cache_cls(cache.k, cache.v)
    pos = torch.arange(p + n, device=dev)
    x = gen._decode_layers(model, embed(model, prompt), cache, pos[:p],
                           cos, sin)
    out = [gen._logits_last(model, x)]
    for i in range(n - 1):
        x = gen._decode_layers(model, embed(model, tokens[:, i:i + 1]),
                               cache, pos[p + i:p + i + 1], cos, sin)
        out.append(gen._logits_last(model, x))
    return torch.stack(out, dim=1)


def late_cache():
    """The planted fault of 10a: a cache that writes each token's K/V one
    slot late."""
    from picotron_tpu_torch.generate import KVCache

    class LateCache(KVCache):
        def slots(self, q_pos):
            return q_pos + 1

    return LateCache


def device_busy(fn) -> tuple:
    """(device-busy ms, kernels launched) of fn() under torch.profiler: the
    sum of its kernels' durations (one stream: they do not overlap),
    copies left out, as profile_step.py counts them."""
    from torch.profiler import ProfilerActivity, profile

    from picotron_tpu_torch.profile_step import device_kernels, kernel_class

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in device_kernels(prof.events())
               if kernel_class(e.name) != "memcpy"]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(e.device_time_total for e in kernels) / 1e3, len(kernels)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def offline_phase(fa, model16, prompt, card: str) -> dict:
    """10a: `generate` at batch 8, prompt 512, 128 new tokens, greedy,
    bf16; times, bound share, the teacher-forced checks through the
    flash forward kernel, and the planted fault."""
    from picotron_tpu_torch.generate import generate
    from picotron_tpu_torch.models.llama import forward

    from picotron_tpu_torch import optimizer as topt

    b, p, n = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    generate(model16, prompt, 2)  # warm-up (cuBLAS handles, allocator)
    _, prefill_s = timed(lambda: generate(model16, prompt, 1))
    out, total_s = timed(lambda: generate(model16, prompt, n))
    decode_launches = {**fa.launches, **topt.launches}
    if any(decode_launches.values()):
        raise AssertionError(f"10a: the decode path launched kernels: "
                             f"{decode_launches}")
    step_ms = 1e3 * (total_s - prefill_s) / (n - 1)
    # the device's share of a decode step: 16 steps traced, less prefill
    busy, launched = device_busy(lambda: generate(model16, prompt, 17))
    busy1, launched1 = device_busy(lambda: generate(model16, prompt, 1))
    busy_ms, kernels = (busy - busy1) / 16, (launched - launched1) / 16
    # step i attends to p + i tokens, i = 1 .. n - 1
    kv = sum(b * (p + i) for i in range(1, n)) / (n - 1)
    bound_ms = 1e3 * decode_bytes(model16, b, kv) / HBM_BYTES_PER_S
    gen_tokens = out[:, p:]

    with torch.no_grad():
        full = forward(model16, out)[:, p - 1:p - 1 + n].float()  # [B,N,V]
    fwd_launches = {**fa.launches, **topt.launches}
    check_launches(launch_counts(fa), {"flash_fwd": 24, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0}, "10a forward")
    chosen = full.gather(-1, gen_tokens[..., None])[..., 0]
    margin = float((full.max(dim=-1).values - chosen).max())
    dec = cache_logits(model16, prompt, gen_tokens)
    atol = float((dec - full).abs().max())
    # the fault shows from the first decoded token: 16 suffice
    fault = cache_logits(model16, prompt, gen_tokens[:, :16], late_cache())
    fault_atol = float((fault - full[:, :16]).abs().max())
    fault_tok = fault.argmax(dim=-1)[..., None]
    fault_margin = float((full[:, :16].max(dim=-1).values
                          - full[:, :16].gather(-1, fault_tok)[..., 0]).max())
    res = {"card": card, "batch": b, "prompt": p, "new_tokens": n,
           "prefill_ms": 1e3 * prefill_s, "decode_ms_per_step": step_ms,
           "decode_tokens_per_s": b * (n - 1) / (total_s - prefill_s),
           "decode_bound_ms": bound_ms, "decode_bound_share":
           bound_ms / step_ms, "decode_device_busy_ms": busy_ms,
           "decode_idle_share": 1 - busy_ms / step_ms,
           "decode_kernels_per_step": kernels,
           "forward_launches": fwd_launches,
           "margin": margin, "logit_atol": atol,
           "fault_margin": fault_margin, "fault_logit_atol": fault_atol,
           "limits": {"DECODE_MARGIN": DECODE_MARGIN,
                      "DECODE_LOGIT_ATOL": DECODE_LOGIT_ATOL}}
    log(f"phase 10a generate ({card}): prefill {res['prefill_ms']:.1f} ms "
        f"(B {b}, P {p}), decode {step_ms:.3f} ms/step, "
        f"{res['decode_tokens_per_s']:.1f} tokens/s, bound {bound_ms:.3f} "
        f"ms (bytes), {100 * bound_ms / step_ms:.1f}% of bound, device "
        f"busy {busy_ms:.3f} ms/step ({kernels:.0f} kernels), idle share "
        f"{1 - busy_ms / step_ms:.3f}; "
        f"teacher-forced margin {margin} (limit {DECODE_MARGIN}), cache vs "
        f"forward logits {atol} (limit {DECODE_LOGIT_ATOL}); planted fault "
        f"(K/V a slot late): margin {fault_margin}, logits {fault_atol}")
    if margin > DECODE_MARGIN or atol > DECODE_LOGIT_ATOL:
        raise AssertionError(f"10a: decode against the full forward: margin "
                             f"{margin}, logits {atol}")
    if fault_atol <= DECODE_LOGIT_ATOL:
        raise AssertionError(f"10a: the planted fault passed ({fault_atol})")
    return res


def first_part(a: list, b: list):
    """Index of the first token where two streams differ (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def parity_phase(model32, prompt, card: str) -> dict:
    """10b: in fp32 with TF32 off, the 8 requests through `ServeEngine`
    (a pool cut below their need, so requests are preempted) against
    offline `generate`, and the n-gram speculative engine against the
    plain one."""
    import dataclasses

    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.generate import generate
    from picotron_tpu_torch.serve import ServeEngine

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        n = SERVE_NEW
        offline, off_s = timed(lambda: generate(model32, prompt, n))
        offline = offline[:, SERVE_PROMPT:].tolist()
        reqs = [(row, n) for row in prompt.tolist()]
        scfg = ServeConfig(**SERVE_SCFG, num_blocks=SERVE_PARITY_BLOCKS)
        runs = {}
        for name, sc in (("engine", scfg), ("ngram", dataclasses.replace(
                scfg, speculator="ngram", draft_len=SERVE_DRAFT_LEN))):
            eng = ServeEngine(model32, sc, device=prompt.device)
            res, secs = timed(lambda: eng.run(reqs))
            eng.close()
            if eng.pool.in_use or eng.pool.free_blocks != eng.num_blocks:
                raise AssertionError(f"10b {name}: {eng.pool.in_use} blocks "
                                     f"leaked")
            runs[name] = {"tokens": [r["tokens"] for r in res], "s": secs,
                          "preemptions": eng.sched.n_preempted,
                          "summary": eng.summary}
        parts = {i: first_part(t, offline[i])
                 for i, t in enumerate(runs["engine"]["tokens"])}
        parts = {i: j for i, j in parts.items() if j is not None}
        gaps = {}
        if parts:
            logits = cache_logits(model32, prompt,
                                  torch.tensor(offline, device=prompt.device))
            for i, j in parts.items():
                top2 = logits[i, j].topk(2).values
                gaps[i] = float(top2[0] - top2[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    spec_equal = runs["ngram"]["tokens"] == runs["engine"]["tokens"]
    out = {"card": card, "offline_s": off_s,
           "engine_s": runs["engine"]["s"], "ngram_s": runs["ngram"]["s"],
           "preemptions": runs["engine"]["preemptions"],
           "ngram_preemptions": runs["ngram"]["preemptions"],
           "parted": len(parts), "parted_at": parts, "top2_gaps": gaps,
           "ngram_equal": spec_equal, "acceptance_rate":
           runs["ngram"]["summary"]["acceptance_rate"],
           "limits": {"NEAR_TIE": NEAR_TIE}}
    log(f"phase 10b fp32 parity ({card}): offline {off_s:.2f} s, engine "
        f"{out['engine_s']:.2f} s ({out['preemptions']} preemptions), "
        f"n-gram {out['ngram_s']:.2f} s (acceptance "
        f"{out['acceptance_rate']}); {len(parts)} of {len(reqs)} requests "
        f"part from generate {parts}, top-2 gaps there {gaps} (limit "
        f"{NEAR_TIE}); n-gram tokens equal to the engine's: {spec_equal}")
    if not out["preemptions"]:
        raise AssertionError("10b: the cut pool preempted nothing")
    if any(g >= NEAR_TIE for g in gaps.values()):
        raise AssertionError(f"10b: a request parts from generate away "
                             f"from a near tie: {gaps}")
    if not spec_equal:
        raise AssertionError("10b: n-gram speculation changed the tokens")
    return out


def trace_phase(model16, card: str) -> dict:
    """10c: bench.py's serve trace shape through `ServeEngine` in bf16,
    each decode dispatch under torch.cuda.set_sync_debug_mode("error"),
    its events in a JSONL stream."""
    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.serve import ServeEngine
    from picotron_tpu_torch.telemetry import JsonlSink, Telemetry

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    path = os.path.join(here, "build", "serve_telemetry.jsonl")
    if os.path.exists(path):
        os.remove(path)
    cfg = model16.cfg
    n_req, plen, budget = SERVE_TRACE
    trace = make_serve_trace(n_req, plen, budget, cfg.vocab_size,
                             SERVE_SEED)
    dev = model16.final_norm.device
    warm = ServeEngine(model16, ServeConfig(**SERVE_SCFG), device=dev)
    warm.run(trace[:2])  # the allocator and cuBLAS at these shapes
    warm.close()
    del warm
    torch.cuda.empty_cache()
    tel = Telemetry(sinks=[JsonlSink(path)])
    eng = ServeEngine(model16, ServeConfig(**SERVE_SCFG), telemetry=tel,
                      device=dev)
    inner = eng._decode_fn
    checked = [0]

    def no_host_sync(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            checked[0] += 1

    eng._decode_fn = no_host_sync
    torch.cuda.reset_peak_memory_stats()
    res = eng.run(trace)
    tel.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(path) as f:
        events = [json.loads(line) for line in f]
    kinds = [e["kind"] for e in events]
    decode = [e for e in events if e["kind"] == "phase"
              and e["phase"] == "decode"]
    s = eng.summary
    interval = SERVE_SCFG["decode_interval"]
    # least bytes of the run's decode: each dispatch's `interval` steps
    # read every weight; each decoded token reads its sequence's K/V
    steps = len(decode) * interval
    kv = sum(r["prompt_len"] + t for r in res
             for t in range(1, r["output_tokens"]))
    w = decode_bytes(model16, 0, 0)
    per_tok = decode_bytes(model16, 0, 1) - w
    bound_ms = (1e3 * (steps * w + kv * per_tok) / HBM_BYTES_PER_S
                / len(decode))
    cap = eng.max_blocks * eng.block_size
    view_ms = (1e3 * interval * eng.num_slots * cap * per_tok * 2
               / HBM_BYTES_PER_S)
    dispatch_ms = 1e3 * sum(e["secs"] for e in decode) / len(decode)
    out = {"card": card, "requests": s["requests"],
           "output_tokens": s["output_tokens"],
           "tokens_per_s": s["tokens_per_sec"], "wall_s": s["wall_s"],
           "ttft_p50_s": s["ttft_p50_s"], "ttft_p95_s": s["ttft_p95_s"],
           "tpot_p50_s": s["tpot_p50_s"], "tpot_p95_s": s["tpot_p95_s"],
           "decode_dispatches": len(decode), "ms_per_decode_dispatch":
           dispatch_ms, "decode_bound_ms": bound_ms, "decode_bound_share":
           bound_ms / dispatch_ms, "view_copy_ms": view_ms,
           "decode_bound_with_view_ms": bound_ms + view_ms,
           "slot_occupancy": s["slot_occupancy"],
           "pool_peak_utilization": s["pool_peak_utilization"],
           "preemptions": s["preemptions"], "peak_gib": peak,
           "decode_compiles": s["decode_compiles"],
           "sync_checked_dispatches": checked[0]}
    log(f"phase 10c serve trace ({card}): {s['requests']} requests, "
        f"{s['output_tokens']} tokens in {s['wall_s']:.2f} s, "
        f"{s['tokens_per_sec']} tokens/s; TTFT p50/p95 {s['ttft_p50_s']:.4f}"
        f"/{s['ttft_p95_s']:.4f} s, TPOT {s['tpot_p50_s']:.5f}/"
        f"{s['tpot_p95_s']:.5f} s; {dispatch_ms:.2f} ms per decode dispatch "
        f"of {interval} steps, bound {bound_ms:.3f} ms (bytes: weights and "
        f"live K/V), {100 * bound_ms / dispatch_ms:.1f}% of bound, the "
        f"capacity-sized view copies {view_ms:.3f} ms more; occupancy "
        f"{s['slot_occupancy']}, pool peak {s['pool_peak_utilization']}, "
        f"{s['preemptions']} preemptions, peak {peak:.2f} GiB, "
        f"decode_compiles {s['decode_compiles']}, {checked[0]} decode "
        f"dispatches under sync debug mode 'error'")
    from picotron_tpu_torch.analysis import check_engine_feed

    t_feed = time.perf_counter()
    feed = check_engine_feed(eng).info["variants"]
    out["variant_check"] = {
        **{k: feed[k] for k in ("proven", "uncommitted", "leaves",
                                "upload_device")},
        "seconds": time.perf_counter() - t_feed,
        "construction_proven": eng.variant_report.info["variants"]["proven"],
        "hazard_events": kinds.count("variant_hazard")}
    if eng.pool.in_use:
        raise AssertionError(f"10c: {eng.pool.in_use} blocks leaked")
    if (kinds.count("serve_request") != n_req
            or kinds.count("serve_summary") != 1 or len(res) != n_req):
        raise AssertionError(
            f"10c: {kinds.count('serve_request')} serve_request and "
            f"{kinds.count('serve_summary')} serve_summary events for "
            f"{n_req} requests")
    if sum(r["output_tokens"] for r in res) != sum(t[1] for t in trace):
        raise AssertionError("10c: a request stopped short of its budget")
    return out


def serve_phase(fa, card: str, config: str = CONFIG,
                device: str = "cuda") -> dict:
    """Phase 10: offline generation, fp32 engine parity and a serve trace
    on SmolLM-1.7B at full width and depth, random weights from the seed."""
    model32, model16 = serve_models(SERVE_SEED, config, device)
    g = torch.Generator().manual_seed(SERVE_SEED)
    prompt = torch.randint(0, model16.cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT), generator=g)
    prompt = prompt.to(device)
    from picotron_tpu_torch import optimizer as topt

    out = {"offline": offline_phase(fa, model16, prompt, card)}
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    out["parity"] = parity_phase(model32, prompt, card)
    del model32
    torch.cuda.empty_cache()
    out["trace"] = trace_phase(model16, card)
    out["engine_launches"] = {**fa.launches, **topt.launches}
    if any(out["engine_launches"].values()):
        raise AssertionError(f"10b-c: the engine launched kernels: "
                             f"{out['engine_launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 11: mixture of experts on Mixtral-8x7B's full-width layers
# ---------------------------------------------------------------------------


def moe_config(here: str, **sections):
    """MOE_CONFIG, each section of `sections` updated over the file's."""
    import dataclasses

    from picotron_tpu_torch.config import load_config

    cfg = load_config(os.path.join(here, MOE_CONFIG))
    for name, vals in sections.items():
        cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
            getattr(cfg, name), **vals)})
    cfg.validate()
    return cfg


def moe_model(cfg, dev, seed=None):
    """The config's model on `dev`, initialised as the trainer's
    `build_state` initialises it without a layout (training.seed)."""
    from picotron_tpu_torch.models.llama import LlamaModel, init_params

    gen = torch.Generator(device=dev).manual_seed(
        cfg.training.seed if seed is None else seed)
    return init_params(LlamaModel(cfg.model, device=dev), gen)


@contextlib.contextmanager
def unrenormalised_gates():
    """The planted fault of 11a: the top-k gates left as the router's
    probabilities, not renormalised over the k."""
    from picotron_tpu_torch.ops import moe

    real = moe.route_topk

    def fault(logits, k, stats=None):
        r = real(logits, k, stats)
        probs = torch.softmax(logits.float(), dim=-1)
        return r._replace(gate=probs.gather(-1, r.expert_idx))

    moe.route_topk = fault
    try:
        yield
    finally:
        moe.route_topk = real


@contextlib.contextmanager
def recorded_routes(out: list):
    """Each MoE block's chosen experts [N, k], appended to `out`."""
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.ops.moe import route_topk

    real = llama.moe_mlp

    def recording(x, router_w, *args, **kw):
        logits = kw.get("logits")
        if logits is None:
            logits = x.reshape(-1, x.shape[-1]).float() @ router_w.float()
        out.append(route_topk(logits, kw["top_k"]).expert_idx)
        return real(x, router_w, *args, **kw)

    llama.moe_mlp = recording
    try:
        yield
    finally:
        llama.moe_mlp = real


def _moe_run(cfg, on_step=None) -> dict:
    """`train.run` on cfg (the trainer's entry point), the state dropped."""
    from picotron_tpu_torch import train

    result = train.run(cfg, on_step=on_step)
    torch.cuda.synchronize()
    result.pop("state")
    torch.cuda.empty_cache()
    return result


def moe_train_phase(fa, here: str, card: str, peak_flops: float) -> dict:
    """11a: MOE_STEPS AD steps of MOE_CONFIG (remat "dots") through the
    trainer with its counts from 0, against the same steps under the
    plain attention, the route agreement of the two on one microbatch,
    and the planted fault."""
    import dataclasses

    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch.data import MicroBatchDataLoader
    from picotron_tpu_torch.models.llama import loss_sum_count

    cfg = moe_config(here)
    t = cfg.training
    drops = []
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    result = _moe_run(cfg, lambda step, m: drops.append(m["moe_drop_frac"]))
    counts = launch_counts(fa)
    adamw = topt.launches["adamw"]
    per = cfg.model.num_hidden_layers * t.gradient_accumulation_steps \
        * t.total_train_steps
    check_launches(counts, {name: per for name, _ in KERNELS}, "phase 11a",
                   d=cfg.model.head_dim)
    n_tensors = len(cfg_param_names(cfg))
    if adamw != n_tensors * t.total_train_steps:
        raise AssertionError(f"11a: adamw launched {adamw} times, want "
                             f"{n_tensors * t.total_train_steps}")
    losses = result["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        raise AssertionError(f"11a losses {losses}")
    nums = path_numbers(result, cfg.model, peak_flops)

    ref_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attn_impl="reference"))
    ref = _moe_run(ref_cfg)["losses"]
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    with unrenormalised_gates():
        fault = _moe_run(dataclasses.replace(cfg, training=dataclasses.replace(
            t, total_train_steps=1)))["losses"]
    fault_diff = abs(fault[0] - ref[0])

    # the routes of both attention paths on the first microbatch
    dev = torch.device("cuda")
    model = moe_model(cfg, dev)
    ids, tgt = next(MicroBatchDataLoader(cfg, dev))
    routes = {}
    for impl in ("auto", "reference"):
        model.cfg = dataclasses.replace(cfg.model, attn_impl=impl)
        rec = []
        with torch.no_grad(), recorded_routes(rec):
            loss_sum_count(model, ids[0], tgt[0])
        routes[impl] = torch.stack(rec)
    agree = float((routes["auto"] == routes["reference"]).float().mean())
    del model, routes
    torch.cuda.empty_cache()

    res = {"card": card, "losses": losses, "plain_attention_losses": ref,
           "loss_diffs": diffs, "fault_loss_diff": fault_diff,
           "moe_drop_frac": drops, "route_agreement": agree,
           "launches": {**counts["launches"], "adamw": adamw},
           "step_seconds": result["step_seconds"], **nums,
           "limits": {"MOE_LOSS_ATOL": MOE_LOSS_ATOL,
                      "MOE_ROUTE_AGREE": MOE_ROUTE_AGREE}}
    log(f"phase 11a Mixtral-8x7B 2 layers, AD, remat dots ({card}): step "
        f"{nums['step_ms']:.1f} ms (median of steps 2-{t.total_train_steps}), "
        f"{nums['tokens_per_s']:.1f} tokens/s, MFU {100 * nums['mfu']:.2f}% "
        f"(active params), peak {nums['peak_memory_gb']:.2f} GiB, "
        f"moe_drop_frac {drops}, launches {res['launches']}; losses "
        f"{losses}, plain attention {ref}, diffs {diffs} (limit "
        f"{MOE_LOSS_ATOL}); routes agree on {agree:.5f} of the assignments "
        f"(limit {MOE_ROUTE_AGREE}); planted fault (gates not "
        f"renormalised) step-1 diff {fault_diff}")
    if not max(diffs) <= MOE_LOSS_ATOL:
        raise AssertionError(f"11a: flash vs plain attention losses {diffs}")
    if not agree >= MOE_ROUTE_AGREE:
        raise AssertionError(f"11a: routes agree on {agree}")
    if fault_diff <= MOE_LOSS_ATOL:
        raise AssertionError(f"11a: the planted fault passed ({fault_diff})")
    return res


def cfg_param_names(cfg) -> list:
    """The parameter names of the config's model (built on meta)."""
    from picotron_tpu_torch.models.llama import LlamaModel

    return [n for n, _ in LlamaModel(cfg.model, device="meta")
            .named_parameters()]


def moe_determinism(cfg, dev, seed: int = MOE_SEED) -> dict:
    """11c: `moe_mlp` run twice on one input at 11a's shapes (layer 0's
    weights, bf16 tokens [MBS, SEQ, H] from a seed): out, expert_idx and
    slot bit for bit (the recompute contract remat and the fused engine
    rely on); and its forward time."""
    from picotron_tpu_torch.models.llama import mlp_act
    from picotron_tpu_torch.ops.moe import moe_mlp, route_topk

    m = cfg.model
    model = moe_model(cfg, dev)
    lp = model.layers[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(MBS, SEQ, m.hidden_size, generator=g,
                    device=dev).bfloat16()
    kw = dict(num_experts=m.num_experts, top_k=m.num_experts_per_token,
              capacity_factor=m.capacity_factor, act=mlp_act(m),
              router_aux_coef=m.router_aux_coef,
              router_z_coef=m.router_z_coef)
    with torch.no_grad():
        def once():
            logits = x.reshape(-1, m.hidden_size).float() @ lp.router.float()
            r = route_topk(logits, m.num_experts_per_token)
            out = moe_mlp(x, lp.router, lp.w_gate, lp.w_up, lp.w_down, **kw)
            return out[0], r.expert_idx, r.slot, out[2]

        a, b = once(), once()
        same = {name: bool(torch.equal(u, v)) for name, u, v in zip(
            ("out", "expert_idx", "slot"), a, b)}
        ms = cuda_ms(lambda: moe_mlp(x, lp.router, lp.w_gate, lp.w_up,
                                     lp.w_down, **kw), iters=5, warmup=1)
    res = {"bitwise": same, "drop_frac": float(a[3]), "moe_mlp_ms": ms}
    del model
    torch.cuda.empty_cache()
    log(f"phase 11c recompute determinism: {same}, drop frac "
        f"{res['drop_frac']}, moe_mlp forward {ms:.3f} ms at N "
        f"{MBS * SEQ}")
    if not all(same.values()):
        raise AssertionError(f"11c: moe_mlp twice differs: {same}")
    return res


def moe_ep_phase(fa, here: str, card: str, cfg=None, dev="cuda",
                 seq: int = SEQ) -> dict:
    """11d: ep 2 as a thread world of 2 ranks on the card (depth 1,
    capacity factor 8: drop-free) against ep 1 on the same params and
    global batch (MBS rows of SEQ, one per rank at ep 2): the loss within
    CP_LOSS_RTOL, every grad tensor (a bank's against ep 1's rows of the
    rank's experts, the others summed over the ranks) within CP_GRAD_RTOL
    in relative L2, 2 x layers all-to-alls per rank per forward, and the
    flash launches. The ranks' graphs join at the exchanges (the thread
    world's communicators are differentiable), so one backward over the
    ranks' summed losses takes every rank's grads. `cfg`, `dev` and
    `seq` replace the configuration (a tiny model on the CPU in the
    tests, where the launches are not counted)."""
    from picotron_tpu_torch.models.llama import LlamaModel, loss_sum_count
    from picotron_tpu_torch.parallel.ep import EPContext
    from picotron_tpu_torch.parallel.sharding import (
        ep_shard_dim, shard_state_dict,
    )

    cfg = cfg or moe_config(here, model={"num_hidden_layers": 1,
                                         "capacity_factor": 8.0})
    dev = torch.device(dev)
    n_ep = 2
    model1 = moe_model(cfg, dev, MOE_SEED)
    toks = torch.from_numpy(__import__("numpy").random.default_rng(
        MOE_SEED).integers(0, cfg.model.vocab_size, (n_ep, seq + 1))).to(dev)
    ids, tgt = toks[:, :-1], toks[:, 1:]
    fa.reset_launch_counts()
    total1, count1, _ = loss_sum_count(model1, ids, tgt)
    total1.backward()
    loss1 = float(total1) / int(count1)
    grads1 = {n: p.grad for n, p in model1.named_parameters()}
    sd = {n: p.detach() for n, p in model1.named_parameters()}

    world = ThreadWorld(n_ep)
    comms = [ThreadEPComm(world, r) for r in range(n_ep)]
    models = []
    for r in range(n_ep):
        m = LlamaModel(cfg.model, device="meta",
                       ep=EPContext(comms[r], ThreadMean(world, r)))
        m.load_state_dict(shard_state_dict(sd, 0, 1, r, n_ep), assign=True)
        m.rope_cos, m.rope_sin = model1.rope_cos, model1.rope_sin
        models.append(m)
    for m in models:  # leaves of their own: the ranks' grads apart
        for p in m.parameters():
            p.data = p.data.clone()
            p.requires_grad_(True)

    def rank(r):
        return loss_sum_count(models[r], ids[r:r + 1], tgt[r:r + 1])[:2]

    outs = world.run(rank)
    sum(t for t, _ in outs).backward()
    counts = launch_counts(fa)
    loss2 = sum(float(t) for t, _ in outs) / sum(int(c) for _, c in outs)
    errs = {}
    for n, g1 in grads1.items():
        if ep_shard_dim(n) is None:
            got = sum(dict(m.named_parameters())[n].grad for m in models)
        else:
            got = torch.cat([dict(m.named_parameters())[n].grad
                             for m in models])
        errs[n] = rel_l2(got, g1)
    worst = max(errs, key=errs.get)
    rel = abs(loss2 - loss1) / abs(loss1)
    a2a = [c.counts["all_to_all"] for c in comms]
    layers = cfg.model.num_hidden_layers
    res = {"card": card, "loss_ep1": loss1, "loss_ep2": loss2,
           "loss_rel_err": rel, "worst_grad_rel_l2": errs[worst],
           "worst_grad": worst, "all_to_all_per_rank": a2a,
           "launches": counts["launches"],
           "limits": {"CP_LOSS_RTOL": CP_LOSS_RTOL,
                      "CP_GRAD_RTOL": CP_GRAD_RTOL}}
    log(f"phase 11d ep 2 thread world ({card}): loss {loss2} (ep 1: "
        f"{loss1}, rel err {rel:.3g}, limit {CP_LOSS_RTOL:g}), worst grad "
        f"{errs[worst]:.4g} ({worst}, limit {CP_GRAD_RTOL:g}), all-to-alls "
        f"per rank {a2a}, launches {counts['launches']}")
    del model1, models, grads1, sd, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not rel <= CP_LOSS_RTOL or not errs[worst] <= CP_GRAD_RTOL:
        raise AssertionError(f"11d: ep 2 vs ep 1: loss {rel}, grads "
                             f"{errs[worst]} ({worst})")
    if a2a != [2 * layers] * n_ep:
        raise AssertionError(f"11d: all-to-alls per rank {a2a}, want "
                             f"{2 * layers} each")
    if dev.type == "cuda":
        check_launches(counts, {name: layers * (1 + n_ep)
                                for name, _ in KERNELS}, "phase 11d",
                       d=cfg.model.head_dim)
    return res


def moe_decode_phase(fa, here: str, card: str) -> dict:
    """11e: `generate` on MOE_CONFIG's model (params from a seed, capacity
    factor 8: drop-free at every call) at batch SERVE_BATCH, prompt
    SERVE_PROMPT, MOE_NEW new tokens, greedy, in bf16: decode ms/step and
    its bound share, each chosen token within DECODE_MARGIN of the
    training forward's row max (flash), and the share of routes alike on
    the two paths. The teacher-forced cache logits are held to the
    training forward in fp32 with TF32 off at MOE_DECODE_ATOL, tighter
    than phase 10's bf16 DECODE_LOGIT_ATOL: in bf16 the two paths'
    round-off flips near-tie routes (a different expert for a token
    moves its logits by more than phase 10's limit), in fp32 it does
    not; the planted fault (K/V a slot late) must fail there."""
    from picotron_tpu_torch.generate import generate, load_for_decode
    from picotron_tpu_torch.models.llama import forward

    cfg = moe_config(here, model={"capacity_factor": 8.0})
    dev = torch.device("cuda")
    # fp32 params and compute; the bf16 model holds their cast
    model32 = moe_model(moe_config(here, model={"capacity_factor": 8.0,
                                                "dtype": "float32"}),
                        dev, SERVE_SEED)
    model16 = load_for_decode({n: t.to(torch.bfloat16) for n, t in
                               model32.state_dict().items()}, cfg.model, dev)
    b, p, n = SERVE_BATCH, SERVE_PROMPT, MOE_NEW
    prompt = torch.from_numpy(__import__("numpy").random.default_rng(
        SERVE_SEED).integers(0, cfg.model.vocab_size, (b, p))).to(dev)
    generate(model16, prompt, 2)  # warm-up
    _, prefill_s = timed(lambda: generate(model16, prompt, 1))
    out, total_s = timed(lambda: generate(model16, prompt, n))
    step_ms = 1e3 * (total_s - prefill_s) / (n - 1)
    kv = sum(b * (p + i) for i in range(1, n)) / (n - 1)
    bound_ms = 1e3 * decode_bytes(model16, b, kv) / HBM_BYTES_PER_S
    gen_tokens = out[:, p:]
    fa.reset_launch_counts()
    routes_full, routes_dec = [], []
    with torch.no_grad(), recorded_routes(routes_full):
        full = forward(model16, out)[:, p - 1:p - 1 + n].float()
    check_launches(launch_counts(fa), {
        "flash_fwd": cfg.model.num_hidden_layers, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0}, "11e forward")
    chosen = full.gather(-1, gen_tokens[..., None])[..., 0]
    margin = float((full.max(dim=-1).values - chosen).max())
    with recorded_routes(routes_dec):
        atol16 = float((cache_logits(model16, prompt, gen_tokens) - full)
                       .abs().max())
    layers = cfg.model.num_hidden_layers
    k = cfg.model.num_experts_per_token
    agree = []
    for li in range(layers):  # the prefill's call, then one per token
        dec = torch.cat([r.reshape(b, -1, k)
                         for r in routes_dec[li::layers]], dim=1)
        agree.append(dec == routes_full[li].reshape(b, -1, k)[:, :dec.shape[1]])
    agree = float(torch.stack(agree).float().mean())
    del model16, full
    torch.cuda.empty_cache()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            full32 = forward(model32, out)[:, p - 1:p - 1 + n].float()
        atol = float((cache_logits(model32, prompt, gen_tokens) - full32)
                     .abs().max())
        fault = cache_logits(model32, prompt, gen_tokens[:, :16],
                             late_cache())
        fault_atol = float((fault - full32[:, :16]).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    res = {"card": card, "batch": b, "prompt": p, "new_tokens": n,
           "prefill_ms": 1e3 * prefill_s, "decode_ms_per_step": step_ms,
           "decode_tokens_per_s": b * (n - 1) / (total_s - prefill_s),
           "decode_bound_ms": bound_ms, "decode_bound_share":
           bound_ms / step_ms, "margin": margin, "bf16_logit_atol": atol16,
           "route_agreement": agree, "logit_atol_fp32": atol,
           "fault_logit_atol_fp32": fault_atol,
           "limits": {"DECODE_MARGIN": DECODE_MARGIN,
                      "MOE_DECODE_ATOL": MOE_DECODE_ATOL}}
    log(f"phase 11e generate Mixtral-8x7B 2 layers ({card}): prefill "
        f"{res['prefill_ms']:.1f} ms (B {b}, P {p}), decode {step_ms:.3f} "
        f"ms/step, {res['decode_tokens_per_s']:.1f} tokens/s, bound "
        f"{bound_ms:.3f} ms (bytes), {100 * bound_ms / step_ms:.1f}% of "
        f"bound; bf16: teacher-forced margin {margin} (limit "
        f"{DECODE_MARGIN}), cache vs forward logits {atol16}, routes alike "
        f"on {agree:.5f} of the assignments; fp32: cache vs forward logits "
        f"{atol} (limit {MOE_DECODE_ATOL}), planted fault (K/V a slot "
        f"late) {fault_atol}")
    del model32, full32, fault
    torch.cuda.empty_cache()
    if margin > DECODE_MARGIN or atol > MOE_DECODE_ATOL:
        raise AssertionError(f"11e: decode against the full forward: margin "
                             f"{margin}, fp32 logits {atol}")
    if fault_atol <= MOE_DECODE_ATOL:
        raise AssertionError(f"11e: the planted fault passed ({fault_atol})")
    return res


def moe_kernel_times(fa, card: str) -> dict:
    """11f: the flash kernels alone at the Mixtral attention shape
    (MOE_SHAPE: B 2, S 2048, Hq 32, Hkv 8, D 128, bf16, causal, fused
    RoPE): ms against the bound and SDPA's (phase 2 holds them to their
    plain versions at this shape)."""
    from picotron_tpu_torch.ops.rope import rope_tables

    case = make_case(fa, rope_tables, *MOE_SHAPE, dev=torch.device("cuda"),
                     seed=7)
    times = time_kernels(fa, case)
    bnd = bounds(*MOE_SHAPE)
    del case
    torch.cuda.empty_cache()
    res = {}
    for name, _ in KERNELS:
        ms, plain_ms, lib_ms = times[name]
        bound_ms, bound_by, flops = bnd[name]
        res[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "tflops": flops / ms / 1e9}
        log(f"phase 11f {name} at B2 S2048 Hq32 Hkv8 D128 ({card}): "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.1f}% of bound")
    return res


def moe_phase(fa, here: str, card: str, peak_flops: float) -> dict:
    """Phase 11: 11a-11f on MOE_CONFIG."""
    import dataclasses

    out = {"train": moe_train_phase(fa, here, card, peak_flops)}
    torch.cuda.empty_cache()
    cfg = moe_config(here)
    fused = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, remat=True, remat_policy="dots_attn",
        grad_engine="fused"))
    out["engines"] = engine_parity(cfg, seed=cfg.training.seed,
                                   fused_cfg=fused, label="11b")
    # the AD engine's loss there is 11a's first step's: the same params
    # (the trainer's init from training.seed) and batch
    if out["engines"]["loss_ad"] != out["train"]["losses"][0]:
        raise AssertionError(f"11b: the AD loss {out['engines']['loss_ad']} "
                             f"is not 11a's first step's "
                             f"{out['train']['losses'][0]}")
    torch.cuda.empty_cache()
    out["determinism"] = moe_determinism(cfg, torch.device("cuda"))
    out["ep"] = moe_ep_phase(fa, here, card)
    out["decode"] = moe_decode_phase(fa, here, card)
    out["kernels"] = moe_kernel_times(fa, card)
    return out


# ---------------------------------------------------------------------------
# phase 12: the trainer as the JAX package runs it
# ---------------------------------------------------------------------------


def read_events(path: str) -> list:
    """A JSONL stream's events, a torn last line (a killed run) dropped."""
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return out


def read_postmortem(save_dir: str) -> Optional[dict]:
    path = os.path.join(save_dir, "flightdeck_postmortem.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def telemetry_main_path(fa, here: str, phase3: dict) -> dict:
    """12a: the phase-3 config with the stream moved (telemetry_dir), the
    span tracer, the sentinel, the flight recorder and two prefetch
    workers, through the trainer's entry point in process, with the
    launch counts from 0."""
    import shutil

    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch import train
    from picotron_tpu_torch.tools import telemetry_report

    base = os.path.join(here, TELEMETRY_DIR)
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    with open(os.path.join(here, CONFIG)) as f:
        raw = json.load(f)
    raw["logging"] = {"telemetry_dir": os.path.join(base, "tel"),
                      "trace_dir": os.path.join(base, "trace"),
                      "sentinel": True, "flight_steps": 8}
    raw["dataset"] = {"num_workers": 2}
    raw["checkpoint"] = {"save_dir": os.path.join(base, "ckpt")}
    path = os.path.join(base, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    result = train.main(["--config", path])
    torch.cuda.synchronize()
    launches = {**fa.launches, **topt.launches}
    counts = launch_counts(fa)
    n_tensors = len(list(result.pop("state").model.parameters()))
    if result["losses"] != phase3["losses"]:
        raise AssertionError(f"12a losses {result['losses']} are not phase "
                             f"3's {phase3['losses']} bit for bit")
    want = 24 * GA * STEPS
    check_launches(counts, {name: want for name, _ in KERNELS}, "phase 12a")
    if launches["adamw"] != n_tensors * STEPS:
        raise AssertionError(f"12a: adamw launched {launches['adamw']} "
                             f"times, want {n_tensors * STEPS}")
    events = read_events(result["telemetry_path"])
    kinds = [e["kind"] for e in events]
    phases = [(e["phase"], e["step"]) for e in events
              if e["kind"] == "phase"]
    steps = [e["step"] for e in events if e["kind"] == "step"]
    want_phases = [(p, s) for s in range(1, STEPS + 1)
                   for p in ("data", "step", "sync")]
    if (kinds[0] != "run_start" or kinds[-1] != "run_summary"
            or phases != want_phases or steps != list(range(1, STEPS + 1))):
        raise AssertionError(f"12a stream: kinds {kinds}, phases {phases}")
    report = telemetry_report.summarize(events)
    if not (report["accounted_s"] <= report["wall_s"] + REPORT_SLACK_S
            and report["steps"]["count"] == STEPS):
        raise AssertionError(f"12a report: accounted "
                             f"{report['accounted_s']} s of a wall of "
                             f"{report['wall_s']} s, {report['steps']}")
    with open(result["trace_path"]) as f:
        trace = json.load(f)
    step_spans = [e["args"]["step"] for e in trace["traceEvents"]
                  if e.get("name") == "step" and e.get("ph") == "X"
                  and e.get("tid") == 0]
    if step_spans != list(range(1, STEPS + 1)):
        raise AssertionError(f"12a trace: step spans {step_spans}")
    ms = statistics.median(result["step_seconds"][1:]) * 1e3
    ms3 = statistics.median(phase3["step_seconds"][1:]) * 1e3
    wall = {p: sum(e["secs"] for e in events if e.get("phase") == p)
            for p in ("data", "step", "sync")}
    out = {"losses": result["losses"], "step_ms": ms, "phase3_step_ms": ms3,
           "overhead": ms / ms3 - 1.0, "launches": launches,
           "data_wait_share": wall["data"] / sum(wall.values()),
           "phase_seconds": wall, "goodput_pct": report["goodput_pct"],
           "accounted_s": report["accounted_s"], "wall_s": report["wall_s"],
           "unaccounted_s": report["unaccounted_s"],
           "sentinel": events[-1].get("sentinel"),
           "trace_events": len(trace["traceEvents"])}
    log(f"phase 12a telemetry main path: losses bit for bit phase 3's, "
        f"step {ms:.1f} ms (phase 3 {ms3:.1f} ms, {100 * out['overhead']:+.2f}"
        f"%), data wait {100 * out['data_wait_share']:.3f}% of the phases, "
        f"report accounted {report['accounted_s']:.3f} s of a "
        f"{report['wall_s']:.3f} s wall, {len(trace['traceEvents'])} trace "
        f"events, launches {launches}")
    if not ms <= (1 + TELEMETRY_STEP_RTOL) * ms3:
        raise AssertionError(f"12a step {ms:.1f} ms over phase 3's "
                             f"{ms3:.1f} ms by more than "
                             f"{100 * TELEMETRY_STEP_RTOL:.0f}%")
    shutil.rmtree(base, ignore_errors=True)
    return out


def chaos_trainer(here: str, name: str, sections: dict,
                  chaos_env: Optional[str] = None) -> dict:
    """One child run of `python -m picotron_tpu_torch.train` on the
    phase-12b config (CONFIG at CHAOS_LAYERS layers) with `sections`
    over it, PICOTRON_CHAOS set to `chaos_env` when given (else unset):
    its exit code, report (when it exits 0), stream, postmortem and the
    losses its stream logged, by step."""
    import signal

    base = os.path.join(here, CHAOS_DIR)
    with open(os.path.join(here, CONFIG)) as f:
        raw = json.load(f)
    raw["model"]["num_hidden_layers"] = CHAOS_LAYERS
    raw["checkpoint"] = {"save_dir": os.path.join(base, name)}
    for section, vals in sections.items():
        raw.setdefault(section, {}).update(vals)
    path = os.path.join(base, f"{name}.{len(os.listdir(base))}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    report = path + ".report"
    env = {k: v for k, v in os.environ.items() if k != "PICOTRON_CHAOS"}
    if chaos_env is not None:
        env["PICOTRON_CHAOS"] = chaos_env
    cmd = [sys.executable, "-m", "picotron_tpu_torch.train", "--config",
           path, "--report", report]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TRAIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"12b {name}: no exit within "
                             f"{TRAIN_TIMEOUT_S} s")
    save_dir = raw["checkpoint"]["save_dir"]
    events = read_events(os.path.join(save_dir, "telemetry.jsonl"))
    run = {"code": proc.returncode, "events": events,
           "seconds": time.perf_counter() - t0,
           "postmortem": read_postmortem(save_dir), "err": err[-3000:],
           "losses": {}, "report": None}
    # this run's part of an append-mode stream: after its run_start
    starts = [i for i, e in enumerate(events) if e["kind"] == "run_start"]
    for e in events[starts[-1] if starts else 0:]:
        if e["kind"] == "step":
            run["losses"][e["step"]] = e["loss"]
    if proc.returncode == 0:
        with open(report) as f:
            run["report"] = json.load(f)
    return run


def _expect(run: dict, name: str, code: int, reason: Optional[str] = None,
            step: Optional[int] = None) -> None:
    if run["code"] != code:
        raise AssertionError(f"12b {name}: exit {run['code']}, want {code}: "
                             f"{run['err']}")
    if reason is not None:
        pm = run["postmortem"]
        if pm is None or (pm["reason"], pm["step"]) != (reason, step):
            got = pm and (pm["reason"], pm["step"])
            raise AssertionError(f"12b {name}: postmortem {got}, want "
                                 f"{(reason, step)}")


def _kinds_after(run: dict, start: int) -> list:
    """The kinds of the stream from its `start`-th run_start on."""
    starts = [i for i, e in enumerate(run["events"])
              if e["kind"] == "run_start"]
    return [e["kind"] for e in run["events"][starts[start]:]]


def chaos_phase(here: str) -> dict:
    """12b: each chaos kind the trainer fires, at full width and
    CHAOS_LAYERS layers, against one run without chaos."""
    import shutil

    base = os.path.join(here, CHAOS_DIR)
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    out = {}
    try:
        clean = chaos_trainer(here, "clean", {})
        _expect(clean, "clean", 0)
        want = clean["losses"]
        if sorted(want) != list(range(1, STEPS + 1)):
            raise AssertionError(f"12b clean: losses {want}")
        out["clean"] = {"losses": want, "seconds": clean["seconds"]}

        nan = chaos_trainer(here, "nan_abort",
                            {"resilience": {"chaos": "nan_grad@3"}})
        _expect(nan, "nan_grad@3", 76, "divergence_abort", 3)
        if nan["losses"] != {s: want[s] for s in (1, 2)}:
            raise AssertionError(f"12b nan_grad@3: steps 1-2 "
                                 f"{nan['losses']}, want {want}")
        guard = [e for e in nan["events"] if e["kind"] == "guard"]
        out["nan_abort"] = {"guard": guard[-1]["why"] if guard else None,
                            "seconds": nan["seconds"]}

        data = chaos_trainer(here, "data_io", {
            "resilience": {"chaos": "data_io@2x2"},
            "dataset": {"num_workers": 2}})
        _expect(data, "data_io@2x2", 0)
        retries = [e for e in data["events"] if e["kind"] == "retry"]
        if len(retries) != 2 or data["losses"] != want:
            raise AssertionError(f"12b data_io@2x2: {len(retries)} retries, "
                                 f"losses {data['losses']} vs {want}")
        out["data_io"] = {"retry_backoff_s": sum(e["secs"] for e in retries),
                          "seconds": data["seconds"]}

        term = chaos_trainer(here, "sigterm",
                             {"resilience": {"chaos": "sigterm@3"},
                              "checkpoint": {"auto_resume": True}})
        _expect(term, "sigterm@3", 75, "preempted", 3)
        again = chaos_trainer(here, "sigterm",
                              {"resilience": {"chaos": "sigterm@3"},
                               "checkpoint": {"auto_resume": True}},
                              chaos_env="")
        _expect(again, "sigterm@3 restart", 0)
        if (term["losses"] != {s: want[s] for s in (1, 2, 3)}
                or again["report"]["start_step"] != 3
                or again["losses"] != {4: want[4]}):
            raise AssertionError(f"12b sigterm@3: {term['losses']}, restart "
                                 f"{again['losses']}, want {want}")
        save = [e["secs"] for e in term["events"]
                if e.get("phase") == "preempt-save"]
        out["sigterm"] = {"preempt_save_s": save,
                          "restore_timings": again["report"][
                              "restore_timings"],
                          "seconds": term["seconds"] + again["seconds"]}

        sections = {"resilience": {"chaos": "ckpt_io@2x1,"
                                            "ckpt_corrupt_bitflip@4"},
                    "checkpoint": {"save_frequency": 2, "auto_resume": True}}
        ckpt = chaos_trainer(here, "ckpt", sections)
        _expect(ckpt, "ckpt_io@2x1,ckpt_corrupt_bitflip@4", 0)
        kinds = _kinds_after(ckpt, 0)
        if kinds.count("retry") != 1 or ckpt["losses"] != want:
            raise AssertionError(f"12b ckpt run: kinds {kinds}, losses "
                                 f"{ckpt['losses']}")
        back = chaos_trainer(here, "ckpt", sections, chaos_env="")
        _expect(back, "ckpt restart", 0)
        kinds = _kinds_after(back, 1)
        corrupt = [e for e in back["events"] if e["kind"] == "ckpt_corrupt"]
        if (not corrupt or corrupt[-1]["step"] != 4
                or back["report"]["start_step"] != 2
                or back["losses"] != {s: want[s] for s in (3, 4)}):
            raise AssertionError(f"12b ckpt restart: kinds {kinds}, losses "
                                 f"{back['losses']}, start "
                                 f"{back['report']['start_step']}")
        out["ckpt"] = {
            "save_s": [e["secs"] for e in ckpt["events"]
                       if e.get("phase") == "save"],
            "retry_backoff_s": [e["secs"] for e in ckpt["events"]
                                if e["kind"] == "retry"],
            "restore_timings": back["report"]["restore_timings"],
            "corrupt": corrupt[-1]["failures"],
            "seconds": ckpt["seconds"] + back["seconds"]}

        hang = chaos_trainer(here, "hang", {"resilience": {
            "chaos": f"hang@3~{HANG_S}",
            "watchdog_timeout": WATCHDOG_S}})
        _expect(hang, f"hang@3~{HANG_S}", 77, "watchdog", 2)
        if hang["events"][-1]["kind"] != "watchdog_timeout":
            raise AssertionError(f"12b hang: last event "
                                 f"{hang['events'][-1]}")
        out["hang"] = {"stalled_s": hang["postmortem"]["extra"]["stalled_s"],
                       "seconds": hang["seconds"]}
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"phase 12b chaos at {CHAOS_LAYERS} layers: nan_grad@3 -> 76, "
        f"data_io@2x2 2 retries, sigterm@3 -> 75 and a bit-for-bit resume, "
        f"ckpt_io@2x1 retried and ckpt_corrupt_bitflip@4 -> resume from "
        f"step 2, hang@3 -> 77; {json.dumps(out)}")
    return out


def packer_phase() -> dict:
    """12c: the native packer (csrc/packer.cpp) against PyBlockPacker on
    PACKER_TOKENS tokens fed in ragged chunks, each feed followed by a
    take, as tokenize_and_chunk drives it."""
    from picotron_tpu_torch.native import PyBlockPacker, make_packer

    import numpy as np

    rng = np.random.default_rng(14)
    tokens = rng.integers(0, 49152, PACKER_TOKENS, dtype=np.int32)
    cuts = [0]
    while cuts[-1] < PACKER_TOKENS:
        cuts.append(min(PACKER_TOKENS,
                        cuts[-1] + int(rng.integers(1, 2_000_000))))
    out, secs = {}, {}
    for label, packer in (("native", make_packer(SEQ + 1)),
                          ("plain", PyBlockPacker(SEQ + 1))):
        blocks = []
        t0 = time.perf_counter()
        for a, b in zip(cuts, cuts[1:]):
            packer.feed(tokens[a:b])
            blocks.append(packer.take())
        secs[label] = time.perf_counter() - t0
        out[label] = (np.concatenate(blocks), packer.carry_len)
    if not (np.array_equal(out["native"][0], out["plain"][0])
            and out["native"][1] == out["plain"][1]):
        raise AssertionError("12c: the native packer's blocks differ from "
                             "PyBlockPacker's")
    n_blocks = out["native"][0].shape[0]
    if n_blocks != PACKER_TOKENS // (SEQ + 1):
        raise AssertionError(f"12c: {n_blocks} blocks")
    res = {"tokens": PACKER_TOKENS, "feeds": len(cuts) - 1,
           "blocks": n_blocks,
           "native_tokens_per_s": PACKER_TOKENS / secs["native"],
           "plain_tokens_per_s": PACKER_TOKENS / secs["plain"]}
    log(f"phase 12c packer: {n_blocks} blocks of {SEQ + 1} equal, native "
        f"{res['native_tokens_per_s'] / 1e6:.1f} M tokens/s, plain "
        f"{res['plain_tokens_per_s'] / 1e6:.1f} M tokens/s (host CPU)")
    return res


# ---------------------------------------------------------------------------
# phase 13: logging.profile_dir, elastic resize and the checkpoint tools
# ---------------------------------------------------------------------------


def profile_phase(fa, here: str, phase3: dict) -> dict:
    """13a: phase 3's config with logging.profile_dir over steps
    PROFILE_WINDOW, through the trainer's entry point in process: losses
    bit for bit phase 3's, and `tools.trace_summary` on the trace finds
    the window's steps and each kernel's launches in it."""
    import shutil

    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch import train
    from picotron_tpu_torch.profile_step import kernel_class
    from picotron_tpu_torch.tools import trace_summary

    base = os.path.join(here, PROFILE_DIR)
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    with open(os.path.join(here, CONFIG)) as f:
        raw = json.load(f)
    first, n = PROFILE_WINDOW
    raw["logging"] = {"profile_dir": os.path.join(base, "trace"),
                      "profile_start_step": first, "profile_num_steps": n}
    raw["checkpoint"] = {"save_dir": os.path.join(base, "ckpt")}
    path = os.path.join(base, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    t0 = time.perf_counter()
    result = train.main(["--config", path])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_tensors = len(list(result.pop("state").model.parameters()))
    if result["losses"] != phase3["losses"]:
        raise AssertionError(f"13a losses {result['losses']} are not phase "
                             f"3's {phase3['losses']} bit for bit")
    t1 = time.perf_counter()
    summary = trace_summary.summarize(trace_summary.load_events(
        trace_summary.newest_trace(os.path.join(base, "trace"))))
    summary_s = time.perf_counter() - t1
    by_class: dict = {}
    for name, k in summary["kernels"].items():
        c = by_class.setdefault(kernel_class(name), {"launches": 0, "ms": 0.0})
        c["launches"] += k["launches"]
        c["ms"] += k["us"] / 1e3
    want = {"flash:fwd_kernel": 24 * GA * n, "flash:bwd_dq_kernel": 24 * GA * n,
            "flash:bwd_dkv_kernel": 24 * GA * n, "adamw": n_tensors * n}
    got = {c: by_class.get(c, {}).get("launches") for c in want}
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["us"])[:8]
    for name, k in top:
        log(f"  13a trace: {k['us'] / 1e3 / n:9.3f} ms/step "
            f"{k['launches']:6d} launches  {name[:90]}")
    out = {"losses": result["losses"], "steps": summary["steps"],
           "device": summary["device"], "launches": got,
           "class_ms_per_step": {c: v["ms"] / n for c, v in by_class.items()},
           "step_seconds": result["step_seconds"],
           "trace": os.path.relpath(result["profile_path"], here),
           "trace_mb": os.path.getsize(result["profile_path"]) / 2 ** 20,
           "top": [{"name": nm[:120], "ms_per_step": k["us"] / 1e3 / n,
                    "launches": k["launches"]} for nm, k in top],
           "run_s": run_s, "summary_s": summary_s}
    log(f"phase 13a profile_dir: losses bit for bit phase 3's, trace steps "
        f"{summary['steps']} ({summary['device']}), launches {got} (want "
        f"{want}), {out['trace_mb']:.1f} MiB, step seconds "
        f"{result['step_seconds']}")
    if summary["steps"] != list(range(first, first + n)) or got != want:
        raise AssertionError(f"13a trace: steps {summary['steps']}, launches "
                             f"{got}, want {want}")
    shutil.rmtree(base, ignore_errors=True)
    return out


def _state_digests(step_dir: str) -> dict:
    import hashlib

    state = os.path.join(step_dir, "state")
    out = {}
    for name in sorted(os.listdir(state)):
        h = hashlib.sha256()
        with open(os.path.join(state, name), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out


def _restamp(save_dir: str, *flags: str) -> dict:
    """`tools.elastic_resize` in process: its seconds and its re-split's
    read and write seconds (parsed from its report)."""
    import contextlib
    import io
    import re

    from picotron_tpu_torch.tools import elastic_resize

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = elastic_resize.main([save_dir, *flags])
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  elastic_resize {' '.join(flags)}: {line}")
    if rc != 0:
        raise AssertionError(f"13b: elastic_resize {' '.join(flags)} exited "
                             f"{rc}")
    m = re.search(r"re-split in ([\d.]+)s read \+ ([\d.]+)s write", text)
    return {"seconds": secs, "read_s": float(m.group(1)),
            "write_s": float(m.group(2))}


def elastic_phase(here: str) -> dict:
    """13b and 13c: CONFIG at ELASTIC_LAYERS layers under a one-rank NCCL
    group with zero1 (mbs 2, ga ELASTIC_GA): an uninterrupted run, a run
    saved at step 2, the re-stamps --dp 2 and --dp 1 (state/ byte for byte
    as before, meta.json back at mbs 2 x ga ELASTIC_GA), a restore of step
    2 without a group and with zero1 off under checkpoint.elastic, and the
    resume under the group, both to step 4 bit for bit; then export_hf of
    the store against restore_params_only and greedy `generate` from
    both."""
    import shutil

    from picotron_tpu_torch.checkpoint import (
        load_hf_safetensors, restore_params_only,
    )
    from picotron_tpu_torch.ckpt_integrity import verify_step_dir
    from picotron_tpu_torch.config import load_config
    from picotron_tpu_torch.generate import generate, load_for_decode
    from picotron_tpu_torch.tools import export_hf

    base = os.path.join(here, ELASTIC_DIR)
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    with open(os.path.join(here, CONFIG)) as f:
        raw = json.load(f)
    raw["model"]["num_hidden_layers"] = ELASTIC_LAYERS
    raw["training"]["gradient_accumulation_steps"] = ELASTIC_GA
    ckpt = os.path.join(base, "ckpt")

    def config(name, save_dir, zero1=True, **ck):
        r = json.loads(json.dumps(raw))
        r["distributed"] = {"zero1": zero1}
        r["checkpoint"] = {"save_dir": save_dir, "async_save": False, **ck}
        if name == "a":
            t = r["training"]
            t["max_tokens"] = (2 * t["seq_length"] * t["micro_batch_size"]
                               * ELASTIC_GA)
        path = os.path.join(base, f"{name}.json")
        with open(path, "w") as f:
            json.dump(r, f)
        return path

    out = {}
    try:
        t0 = time.perf_counter()
        whole = run_trainer(here, config("u", os.path.join(base, "u")),
                            os.path.join(base, "u.report"), True)
        ta = time.perf_counter()
        a = run_trainer(here, config("a", ckpt, save_frequency=2),
                        os.path.join(base, "a.report"), True)
        out["runs_s"] = {"uninterrupted": ta - t0,
                         "saved_at_2": time.perf_counter() - ta}
        if a["losses"] != whole["losses"][:2]:
            raise AssertionError(f"13b run A {a['losses']} vs uninterrupted "
                                 f"{whole['losses']}")
        step_dir = os.path.join(ckpt, "step_00000002")
        before = _state_digests(step_dir)
        t1 = time.perf_counter()
        verify = verify_step_dir(step_dir, deep=True)
        verify_s = time.perf_counter() - t1
        there = _restamp(ckpt, "--dp", "2")
        mid = sorted(os.listdir(os.path.join(step_dir, "state")))
        back = _restamp(ckpt, "--dp", "1")
        with open(os.path.join(step_dir, "meta.json")) as f:
            tr = json.load(f)["config"]["training"]
        same = _state_digests(step_dir) == before
        if (verify.status != "verified" or not same
                or mid != ["opt_state.rank00000.pt", "opt_state.rank00001.pt",
                           "params.rank00000.pt"]
                or (tr["micro_batch_size"], tr["gradient_accumulation_steps"])
                != (2, ELASTIC_GA)):
            raise AssertionError(f"13b re-stamps: verify {verify.status}, "
                                 f"dp 2 files {mid}, state back byte for "
                                 f"byte {same}, meta mbs/ga "
                                 f"{tr['micro_batch_size']}/"
                                 f"{tr['gradient_accumulation_steps']}")
        t2 = time.perf_counter()
        c = run_trainer(here, config("c", ckpt, zero1=False, auto_resume=True,
                                     elastic=True),
                        os.path.join(base, "c.report"), False)
        t3 = time.perf_counter()
        b = run_trainer(here, config("b", ckpt, auto_resume=True),
                        os.path.join(base, "b.report"), True)
        t4 = time.perf_counter()
        for label, run in (("no group, zero1 off", c), ("resume", b)):
            if run["start_step"] != 2 or run["losses"] != whole["losses"][2:]:
                raise AssertionError(
                    f"13b {label}: start {run['start_step']}, losses "
                    f"{run['losses']}, uninterrupted {whole['losses']}")
        out.update({
            "losses": whole["losses"], "resumed": b["losses"],
            "no_group_zero1_off": c["losses"], "bit_for_bit": True,
            "state_back_byte_for_byte": same,
            "save_timings": a["save_timings"], "deep_verify_s": verify_s,
            "restamp_dp2": there, "restamp_dp1": back,
            "restore_no_group": c["restore_timings"],
            "restore_resume": b["restore_timings"],
            "checkpoint_gb": sum(
                os.path.getsize(os.path.join(step_dir, "state", f))
                for f in os.listdir(os.path.join(step_dir, "state"))) / 1e9})
        out["runs_s"].update(no_group=t3 - t2, resume=t4 - t3)
        log(f"phase 13b elastic: re-stamps dp 1 -> 2 ({there['seconds']:.2f}"
            f" s) -> 1 ({back['seconds']:.2f} s), state/ byte for byte, "
            f"resumed {b['losses']} and without a group, zero1 off "
            f"{c['losses']} = uninterrupted {whole['losses'][2:]}; save "
            f"{a['save_timings']}, deep verify {verify_s:.2f} s, restores "
            f"{c['restore_timings']} / {b['restore_timings']}")

        # 13c: export_hf of the store (step 2) against restore_params_only
        t5 = time.perf_counter()
        cfg_path = os.path.join(base, "b.json")
        hf = os.path.join(base, "hf")
        if export_hf.main(["--config", cfg_path, "--ckpt-dir", ckpt,
                           "--out", hf]) != 0:
            raise AssertionError("13c: export_hf failed")
        export_s = time.perf_counter() - t5
        cfg = load_config(cfg_path)
        params, step = restore_params_only(cfg, ckpt)
        loaded = load_hf_safetensors(hf, cfg.model)
        if step != 2 or sorted(loaded) != sorted(params) or not all(
                torch.equal(loaded[n], params[n]) for n in params):
            raise AssertionError(f"13c: the exported step {step} differs from "
                                 f"restore_params_only")
        gen = torch.Generator().manual_seed(ELASTIC_SEED)
        prompt = torch.randint(0, cfg.model.vocab_size, (2, 32),
                               generator=gen).cuda()
        tokens = []
        for sd in (params, loaded):
            model = load_for_decode({n: t.to(torch.bfloat16)
                                     for n, t in sd.items()}, cfg.model,
                                    "cuda")
            tokens.append(generate(model, prompt, GEN_NEW).cpu())
            del model
        torch.cuda.empty_cache()
        if not torch.equal(tokens[0], tokens[1]):
            raise AssertionError("13c: greedy tokens differ between the "
                                 "export and restore_params_only")
        out["export"] = {"seconds": export_s, "step": step,
                         "hf_gb": os.path.getsize(os.path.join(
                             hf, "model.safetensors")) / 1e9,
                         "tokens": tokens[0][:, 32:].tolist()}
        log(f"phase 13c export_hf: step {step}, {out['export']['hf_gb']:.2f} "
            f"GB in {export_s:.2f} s, params bit for bit "
            f"restore_params_only's, greedy tokens equal")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def chaos_tool_phase(here: str) -> dict:
    """13d: `python -m picotron_tpu_torch.tools.chaos --device cuda
    --scenario ckpt_corrupt_bitflip` at its own scenario config."""
    import shutil

    work = os.path.join(here, ELASTIC_DIR + "_chaos")
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, "-m", "picotron_tpu_torch.tools.chaos",
           "--device", "cuda", "--scenario", "ckpt_corrupt_bitflip",
           "--workdir", work]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                          timeout=3 * TRAIN_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[chaos-cli]")]
    for ln in lines:
        log(f"  13d {ln}")
    shutil.rmtree(work, ignore_errors=True)
    if proc.returncode != 0 or not any(
            "ckpt_corrupt_bitflip: OK" in ln for ln in lines):
        raise AssertionError(f"13d chaos exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    log(f"phase 13d chaos ckpt_corrupt_bitflip (cuda): ok in {secs:.1f} s")
    return {"seconds": secs, "lines": lines}


def compare_main_paths(trees: list) -> int:
    """`--main-path TREE...`: phase 3 of each tree's own chip_smoke.py
    (e.g. an unpacked parent commit and this checkout, in turns), one
    child process each on the one card; prints each tree's losses and
    fails unless they are equal bit for bit."""
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _MAIN_PATH_CHILD, tree],
                              capture_output=True, text=True,
                              timeout=TRAIN_TIMEOUT_S)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("MAIN_PATH ")]
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][len("MAIN_PATH "):]))
        log(json.dumps(runs[-1]))
    same = all(r["losses"] == runs[0]["losses"] for r in runs)
    log(json.dumps({"main_path_losses_equal": same, "trees": trees}))
    return 0 if same else 1


# ---------------------------------------------------------------------------
# phase 14: disaggregated serving and the serving fleet
# ---------------------------------------------------------------------------


def sync_checked(fn, counter: list):
    """fn under torch.cuda.set_sync_debug_mode("error"): a host sync
    inside it raises. counter[0] counts the calls."""
    def run(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            counter[0] += 1

    return run


def leaked(eng) -> int:
    return eng.pool.in_use + (eng.pool_p.in_use if hasattr(eng, "pool_p")
                              else 0)


def disagg_parity(model32, prompt, card: str) -> dict:
    """14a: in fp32 with TF32 off, phase 10b's 8 requests (its cut pool)
    through the disaggregated and the colocated engine: greedy tokens
    equal."""
    import dataclasses

    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.serve import DisaggServeEngine, ServeEngine

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        reqs = [(row, SERVE_NEW) for row in prompt.tolist()]
        scfg = ServeConfig(**SERVE_SCFG, num_blocks=SERVE_PARITY_BLOCKS)
        runs = {}
        for name, cls, sc in (
                ("colocated", ServeEngine, scfg),
                ("disagg", DisaggServeEngine,
                 dataclasses.replace(scfg, disagg=True))):
            eng = cls(model32, sc, device=prompt.device)
            res, secs = timed(lambda: eng.run(reqs))
            eng.close()
            if leaked(eng):
                raise AssertionError(f"14a {name}: {leaked(eng)} blocks "
                                     f"leaked")
            runs[name] = {"tokens": [r["tokens"] for r in res], "s": secs,
                          "preemptions": eng.sched.n_preempted,
                          "handoffs": eng.summary.get("handoffs", 0)}
            del eng
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    parts = {i: first_part(a, b) for i, (a, b) in enumerate(zip(
        runs["disagg"]["tokens"], runs["colocated"]["tokens"]))}
    parts = {i: j for i, j in parts.items() if j is not None}
    out = {"card": card, "colocated_s": runs["colocated"]["s"],
           "disagg_s": runs["disagg"]["s"],
           "preemptions": {k: r["preemptions"] for k, r in runs.items()},
           "handoffs": runs["disagg"]["handoffs"], "parted_at": parts,
           "tokens_equal": not parts}
    log(f"phase 14a fp32 parity ({card}): colocated {out['colocated_s']:.2f}"
        f" s, disagg {out['disagg_s']:.2f} s ({out['handoffs']} handoffs), "
        f"preemptions {out['preemptions']}; tokens equal: "
        f"{out['tokens_equal']} (parted {parts})")
    if parts:
        raise AssertionError(f"14a: disagg tokens part from colocated at "
                             f"{parts}")
    if min(out["preemptions"].values()) == 0:
        raise AssertionError(f"14a: the cut pool preempted nothing: "
                             f"{out['preemptions']}")
    if out["handoffs"] <= len(reqs):
        raise AssertionError("14a: no preempted request crossed the "
                             "boundary again")
    return out


def disagg_burst(model16, card: str) -> dict:
    """14a: the long-prefill burst in bf16 through the colocated and the
    disaggregated engine: stall ticks, handoffs and each handoff's device
    time against its bound, every decode dispatch and handoff checked for
    host syncs."""
    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.serve import DisaggServeEngine, ServeEngine
    from picotron_tpu_torch.tools.serve_bench import make_burst_trace

    dev = model16.final_norm.device
    plen, budget = FLEET_BURST
    burst = make_burst_trace(
        SERVE_SCFG["decode_slots"], plen, SERVE_SCFG["prefill_chunk"],
        SERVE_SCFG["decode_interval"], budget, model16.cfg.vocab_size,
        SERVE_SEED)
    out = {"card": card, "requests": len(burst), "long_prompt": plen}
    tokens = {}
    for name, cls, sc in (
            ("colocated", ServeEngine, ServeConfig(**SERVE_SCFG)),
            ("disagg", DisaggServeEngine,
             ServeConfig(**SERVE_SCFG, disagg=True))):
        warm = cls(model16, sc, device=dev)  # the allocator, cuBLAS
        warm.run([(burst[0][0], 2), (burst[-1][0], 2)])
        warm.close()
        del warm
        eng = cls(model16, sc, device=dev)
        checked = [0, 0]
        eng._decode_fn = sync_checked(eng._decode_fn, checked)
        copies = []
        if name == "disagg":
            inner = sync_checked(eng._copy_blocks, checked[1:])
            counter = checked

            def timed_copy(src, dst, inner=inner, counter=counter):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                inner(src, dst)
                b.record()
                copies.append((a, b, len(src)))
                counter[1] = len(copies)

            eng._copy_blocks = timed_copy
        res, secs = timed(lambda: eng.run(burst))
        eng.close()
        s = eng.summary
        tokens[name] = [r["tokens"] for r in res]
        out[name] = {"s": secs, "stall_ticks_max":
                     s["decode_stall_ticks_max"], "decode_steps":
                     s["decode_steps"], "ttft_p50_s": s["ttft_p50_s"],
                     "ttft_p95_s": s["ttft_p95_s"], "tpot_p50_s":
                     s["tpot_p50_s"], "sync_checked_dispatches": checked[0]}
        if leaked(eng):
            raise AssertionError(f"14a {name}: {leaked(eng)} blocks leaked")
        if name == "disagg":
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b, _ in copies]
            blocks = [n for _, _, n in copies]
            # one block of K and V over every layer
            block_bytes = 2 * eng._k[:, 0].numel() * eng._k.element_size()
            # least bytes: each real block read once and written once
            bound = [1e3 * 2 * n * block_bytes / HBM_BYTES_PER_S
                     for n in blocks]
            # as built: max_blocks rows gathered into the staging buffer
            # and written into the pool (read + write, twice)
            width_bound = (1e3 * 4 * eng.max_blocks * block_bytes
                           / HBM_BYTES_PER_S)
            out[name].update(
                handoffs=s["handoffs"], handoff_blocks=s["handoff_blocks"],
                handoff_enqueue_s=s["handoff_s"],
                handoff_ms_mean=sum(ms) / len(ms), handoff_ms_max=max(ms),
                handoff_bound_ms_mean=sum(bound) / len(bound),
                handoff_width_bound_ms=width_bound,
                handoff_block_mb=block_bytes / 1e6,
                max_blocks=eng.max_blocks,
                sync_checked_handoffs=checked[1])
        del eng
        torch.cuda.empty_cache()
    d, c = out["disagg"], out["colocated"]
    out["stall_drop"] = c["stall_ticks_max"] - d["stall_ticks_max"]
    out["tokens_equal"] = tokens["disagg"] == tokens["colocated"]
    log(f"phase 14a burst bf16 ({card}): {len(burst)} requests, stall "
        f"ticks max colocated {c['stall_ticks_max']} -> disagg "
        f"{d['stall_ticks_max']} (drop {out['stall_drop']}); colocated "
        f"{c['s']:.2f} s, disagg {d['s']:.2f} s; {d['handoffs']} handoffs "
        f"of {d['handoff_blocks']} blocks, device {d['handoff_ms_mean']:.4f}"
        f" ms mean ({d['handoff_ms_max']:.4f} max) per handoff against a "
        f"bound of {d['handoff_bound_ms_mean']:.4f} ms for its real blocks "
        f"and {d['handoff_width_bound_ms']:.4f} ms for the {d['max_blocks']}"
        f"-block-wide copy as built; host enqueue {d['handoff_enqueue_s']:.4f}"
        f" s in all; TTFT p50 colocated {c['ttft_p50_s']:.3f} s, disagg "
        f"{d['ttft_p50_s']:.3f} s; tokens equal: {out['tokens_equal']}; "
        f"{c['sync_checked_dispatches'] + d['sync_checked_dispatches']} "
        f"decode dispatches and {d['sync_checked_handoffs']} handoffs under "
        f"sync debug mode 'error'")
    if out["stall_drop"] <= 0:
        raise AssertionError(f"14a: disagg did not cut the decode stall "
                             f"({c['stall_ticks_max']} -> "
                             f"{d['stall_ticks_max']})")
    if d["handoffs"] < len(burst) or d["sync_checked_handoffs"] != \
            d["handoffs"]:
        raise AssertionError(f"14a: {d['handoffs']} handoffs for "
                             f"{len(burst)} requests")
    return out


def fleet_runs(model16, card: str) -> dict:
    """14b-c: `serve_bench.run_serve_fleet` on phase 10's bf16 weights: a
    fleet of 2 losing an engine mid-burst against a fleet of 1, and the
    serve_overload shape twice."""
    import shutil

    from picotron_tpu_torch.tools import chaos as chaos_tool
    from picotron_tpu_torch.tools import serve_bench

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, FLEET_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n, plen, budget, rate = FLEET_TRACE
    kw = dict(slots=SERVE_SCFG["decode_slots"],
              block_size=SERVE_SCFG["block_size"], num_blocks=0,
              prefill_chunk=SERVE_SCFG["prefill_chunk"], prompt_len=plen,
              max_new=budget, decode_interval=SERVE_SCFG["decode_interval"],
              seed=SERVE_SEED, temperature=0.7,
              device=model16.final_norm.device.type,
              state_dict=model16.state_dict())
    name = model16.cfg.name
    oracle, oracle_s = timed(lambda: serve_bench.run_serve_fleet(
        name, 0, fleet=1, n_requests=n, rate=rate, **kw))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tel = os.path.join(root, "telemetry.jsonl")
    fault, fault_s = timed(lambda: serve_bench.run_serve_fleet(
        name, 0, fleet=2, n_requests=n, rate=rate, chaos_spec=FLEET_KILL,
        telemetry=tel, **kw))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = read_events(tel)
    dead = [e for e in events if e["kind"] == "serve_engine_dead"]
    moved = [e for e in events if e["kind"] == "serve_redispatch"]
    pm = read_postmortem(root) or {}
    out = {"card": card, "oracle_s": oracle_s, "fault_s": fault_s,
           "requests": n, "completed": fault["completed"],
           "redispatched": fault["redispatched"],
           "engines_dead": fault["engines_dead"],
           "leaked_blocks": fault["leaked_blocks"],
           "inflight_at_death": [e["inflight"] for e in dead],
           "redispatched_tokens": [e["tokens"] for e in moved],
           "per_engine_requests": fault["per_engine_requests"],
           "postmortem_reason": pm.get("reason"), "peak_gib": peak,
           "digests_equal": fault["request_digests"]
           == oracle["request_digests"],
           "ttft_p50_ms": {"fleet1": oracle["ttft_p50_ms"],
                           "fleet2_killed": fault["ttft_p50_ms"]}}
    log(f"phase 14b fleet ({card}): fleet of 1 {oracle_s:.2f} s, fleet of 2 "
        f"with {FLEET_KILL} {fault_s:.2f} s; {out['completed']}/{n} "
        f"completed, digests equal: {out['digests_equal']}, engine death "
        f"with {out['inflight_at_death']} in flight, {out['redispatched']} "
        f"re-dispatched carrying {out['redispatched_tokens']} tokens, "
        f"leaked {out['leaked_blocks']}, postmortem "
        f"{out['postmortem_reason']!r}, peak {peak:.2f} GiB")
    err = chaos_tool.check_engine_dead(oracle, fault, n)
    if err:
        raise AssertionError(f"14b: {err}")
    if out["postmortem_reason"] != "serve_engine_dead" or not any(
            out["redispatched_tokens"]):
        raise AssertionError(f"14b: postmortem {out['postmortem_reason']!r}"
                             f", tokens carried {out['redispatched_tokens']}"
                             f" (the kill must land mid-decode)")

    count, deadline = OVERLOAD
    over = dict(kw, slots=1)
    legs = [timed(lambda: serve_bench.run_serve_fleet(
        name, 0, fleet=1, n_requests=count, rate=0.0, deadline_ms=deadline,
        **over)) for _ in range(2)]
    (a, a_s), (b, _) = legs
    out["overload"] = {"requests": count, "deadline_ms": deadline,
                       "shed_ids": a["shed_ids"], "completed":
                       a["completed"], "queue_wait_p95_ms":
                       a["queue_wait_p95_ms"], "s": a_s,
                       "repeat_equal": (a["shed_ids"], a["request_digests"])
                       == (b["shed_ids"], b["request_digests"])}
    o = out["overload"]
    log(f"phase 14c overload ({card}): {count} requests into 1 slot under "
        f"{deadline} ms: shed {o['shed_ids']}, completed {o['completed']}, "
        f"queue wait p95 {o['queue_wait_p95_ms']} ms, {a_s:.2f} s; the "
        f"repeat equal: {o['repeat_equal']}")
    if (not o["repeat_equal"] or not a["shed"]
            or a["completed"] + a["shed"] != count
            or a["queue_wait_p95_ms"] > deadline + 1e-6):
        raise AssertionError(f"14c: {o}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def fleet_phase(fa, card: str, config: str = CONFIG,
                device: str = "cuda") -> dict:
    """Phase 14: the disaggregated engine and the serving fleet on phase
    10's SmolLM-1.7B (full width and depth, the same seeded weights)."""
    from picotron_tpu_torch import optimizer as topt

    fa.reset_launch_counts()
    topt.reset_launch_counts()
    model32, model16 = serve_models(SERVE_SEED, config, device)
    g = torch.Generator().manual_seed(SERVE_SEED)
    prompt = torch.randint(0, model16.cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT), generator=g)
    out = {"parity": disagg_parity(model32, prompt.to(device), card)}
    del model32
    torch.cuda.empty_cache()
    out["burst"] = disagg_burst(model16, card)
    out["fleet"] = fleet_runs(model16, card)
    out["launches"] = {**fa.launches, **topt.launches}
    if any(out["launches"].values()):
        raise AssertionError(f"14: the serving path launched kernels: "
                             f"{out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the tp strategies and the hierarchical dp reduction
# ---------------------------------------------------------------------------


class GroupWorld(ThreadWorld):
    """A `ThreadWorld` whose ranks also meet in groups of their own
    (`group`: a tp group, the 2d subgroups, the dp cohorts), each with its
    own barrier and slots; a failing rank breaks them all."""

    def __init__(self, n: int, timeout: float = THREAD_TIMEOUT_S):
        super().__init__(n, timeout)
        self.timeout = timeout
        self.groups = []

    def group(self, n: int, ranks: tuple = ()) -> "GroupSlots":
        g = GroupSlots(n, self.timeout, ranks)
        self.groups.append(g)
        return g

    def abort(self) -> None:
        super().abort()
        for g in self.groups:
            g.barrier.abort()


class GroupSlots:
    """The barrier, one slot per member, the joined result and the
    members' communicators of one thread group; `ranks` its members'
    global ranks (phase 16 compares the calls by them)."""

    def __init__(self, n: int, timeout: float, ranks: tuple = ()):
        self.n = n
        self.ranks = tuple(ranks)
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n
        self.members = [None] * n
        self.result = None


@functools.lru_cache(maxsize=None)
def thread_group_class():
    """`ThreadGroup`: one rank's `parallel.comm.GroupComm` over a thread
    group (`GroupSlots`), built on first use (the port is imported only
    where the card runs). Its raw collectives hand clones between the
    threads (sums in rank order), and `parallel.comm`'s module functions
    reach them through the process-group hooks (`all_reduce_into`,
    `all_gather_into`, `reduce_scatter_into`), so that `GradSync`, the
    guard's norm and the fused engine's transposes run over it. The
    pairs whose backward communicates (`copy`, `gather`, `scatter`) are
    joined: one autograd node over every member's tensor, made by member
    0 once all have posted, whose backward takes every member's
    transpose at once. So the ranks' graphs join there, and ONE backward
    from one thread over the sum of the ranks' losses gives each rank the
    grads its own backward would (a backward per thread would stall: a
    device's autograd nodes run on one engine thread). `counts` and
    `nbytes` are this rank's calls and bytes by kind (the joined
    backwards' included), `log` each call's (kind, bytes)."""
    import torch.distributed as dist

    from picotron_tpu_torch.parallel.comm import GroupComm, own_slice

    def filled(gs, like):
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(gs, like)]

    def total(ts):
        out = ts[0].clone()
        for t in ts[1:]:
            out += t
        return out

    class JoinedCopy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sh, *xs):
            ctx.sh = sh
            ctx.save_for_backward(*xs)
            return tuple(x.clone() for x in xs)

        @staticmethod
        def backward(ctx, *gs):
            g = total(filled(gs, ctx.saved_tensors))
            for m in ctx.sh.members:
                m.count("all_reduce", g)
            return (None, *(g.clone() for _ in gs))

    class JoinedGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sh, dim, *xs):
            ctx.sh, ctx.dim = sh, dim
            ctx.save_for_backward(*xs)
            for m, x in zip(sh.members, xs):
                m.count("all_gather", x)
            full = torch.cat(xs, dim)
            return tuple(full.clone() for _ in xs)

        @staticmethod
        def backward(ctx, *gs):
            sh = ctx.sh
            xs = ctx.saved_tensors
            g = total([torch.zeros(
                xs[0].shape[:ctx.dim] + (sh.n * xs[0].shape[ctx.dim],)
                + xs[0].shape[ctx.dim + 1:], dtype=xs[0].dtype,
                device=xs[0].device) if g is None else g for g in gs])
            out = []
            for j, m in enumerate(sh.members):
                part = own_slice(g, ctx.dim, sh.n, j)
                m.count("reduce_scatter", part)
                out.append(part)
            return (None, None, *out)

    class JoinedScatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sh, dim, *xs):
            ctx.sh, ctx.dim = sh, dim
            s = total(list(xs))
            outs = tuple(own_slice(s, dim, sh.n, j) for j in range(sh.n))
            for m, o in zip(sh.members, outs):
                m.count("reduce_scatter", o)
            ctx.save_for_backward(*outs)
            return outs

        @staticmethod
        def backward(ctx, *gs):
            gs = filled(gs, ctx.saved_tensors)
            full = torch.cat(gs, ctx.dim)
            for m, g in zip(ctx.sh.members, gs):
                m.count("all_gather", g)
            return (None, None, *(full.clone() for _ in gs))

    class ThreadGroup(GroupComm):
        def __init__(self, sh: GroupSlots, index: int):
            # the group is this object: the module functions delegate
            super().__init__(self, sh.n, index)
            self.sh = sh
            sh.members[index] = self
            self.counts = {"all_reduce": 0, "all_gather": 0,
                           "reduce_scatter": 0}
            self.nbytes = dict.fromkeys(self.counts, 0)
            self.log = []

        def count(self, kind: str, t: torch.Tensor) -> None:
            self.counts[kind] += 1
            self.nbytes[kind] += t.numel() * t.element_size()
            self.log.append((kind, t.numel() * t.element_size()))

        def _swap(self, item, read):
            sh = self.sh
            sh.slots[self.index] = item
            sh.barrier.wait()
            try:
                return read(sh.slots)
            finally:
                sh.barrier.wait()

        def _joined(self, make, x):
            sh = self.sh
            sh.slots[self.index] = x
            sh.barrier.wait()
            try:
                if self.index == 0:
                    sh.result = make(*sh.slots)
                sh.barrier.wait()
                return sh.result[self.index]
            finally:
                sh.barrier.wait()

        # the process-group hooks of `parallel.comm`
        def all_reduce_into(self, t, op) -> None:
            self.count("all_reduce", t)

            def read(slots):
                out = slots[0].clone()
                for x in slots[1:]:
                    if op == dist.ReduceOp.MAX:
                        torch.maximum(out, x, out=out)
                    else:
                        out += x
                return out

            t.copy_(self._swap(t, read))

        def all_gather_into(self, out, inp) -> None:
            self.count("all_gather", inp)
            out.copy_(self._swap(inp.contiguous(), torch.cat))

        def reduce_scatter_into(self, out, inp) -> None:
            self.count("reduce_scatter", out)
            n, i = self.size, self.index

            def read(slots):
                c = slots[0].shape[0] // n
                return total([x[i * c:(i + 1) * c] for x in slots])

            out.copy_(self._swap(inp.contiguous(), read))

        # the joined differentiable pairs
        def copy(self, x):
            return self._joined(lambda *xs: JoinedCopy.apply(self.sh, *xs), x)

        def gather(self, x, dim: int):
            return self._joined(
                lambda *xs: JoinedGather.apply(self.sh, dim % x.dim(), *xs),
                x)

        def scatter(self, x, dim: int):
            return self._joined(
                lambda *xs: JoinedScatter.apply(self.sh, dim % x.dim(), *xs),
                x)

    return ThreadGroup


def solo_group(rank: int = 0):
    """A thread group of one rank (a data group at dp 1)."""
    return thread_group_class()(GroupSlots(1, THREAD_TIMEOUT_S, (rank,)), 0)


def rank_counts(groups) -> dict:
    """A rank's calls by kind over its distinct thread groups."""
    out = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    for g in {id(g): g for g in groups if g is not None}.values():
        for k, v in g.counts.items():
            out[k] += v
    return out


def reset_counts(groups) -> None:
    for g in groups:
        if g is not None:
            for d in (g.counts, g.nbytes):
                for k in d:
                    d[k] = 0
            g.log.clear()


def issued(groups) -> list:
    """A rank's calls over its distinct thread groups of more than one
    rank: sorted (kind, the group's ranks, bytes, calls)."""
    from collections import Counter

    c = Counter()
    for g in {id(g): g for g in groups if g is not None}.values():
        if len(g.sh.ranks) > 1:
            c.update((kind, g.sh.ranks, n) for kind, n in g.log)
    return sorted((*k, v) for k, v in c.items())


@contextlib.contextmanager
def flash_by_rank(table: dict, tls):
    """Count each flash kernel's launches by (thread world rank, kernel,
    q heads, kv heads) while inside (the rank from `tls.rank`; None on
    the autograd engine's thread), without touching the wrappers' own
    counts."""
    from picotron_tpu_torch.ops import flash_attention as fa

    names = {"fwd_kernel": "flash_fwd", "bwd_dq_kernel": "flash_bwd_dq",
             "bwd_dkv_kernel": "flash_bwd_dkv"}
    orig = {n: getattr(fa, n) for n in names}
    lock = threading.Lock()

    def wrap(attr):
        fn = orig[attr]

        def call(q4, k4, *args):
            key = (getattr(tls, "rank", None), names[attr], q4.shape[1],
                   k4.shape[1])
            with lock:
                table[key] = table.get(key, 0) + 1
            return fn(q4, k4, *args)

        return call

    for attr in names:
        setattr(fa, attr, wrap(attr))
    try:
        yield
    finally:
        for attr, fn in orig.items():
            setattr(fa, attr, fn)


def tp_raw(run: dict, dist_kw: dict, dtype: str, seq: int, engine: str,
           layers: int = TP_LAYERS) -> dict:
    """The run config's model (TP_RUN: runs/llama3-8b-4d-v5p64) at
    `layers` layers, flash attention (cp 1), tp TP and `dist_kw`, mbs 1,
    ga 1, under `engine` (the fused one with remat "dots_attn", AD
    without remat)."""
    t = run["training"]
    return {
        "model": {**run["model"], "num_hidden_layers": layers,
                  "attn_impl": "flash", "dtype": dtype},
        "training": {"seq_length": seq, "micro_batch_size": 1,
                     "gradient_accumulation_steps": 1,
                     "learning_rate": t["learning_rate"],
                     "lr_schedule": "constant", "lr_warmup_steps": 0,
                     "total_train_steps": TP_STEPS,
                     "adam_moments_dtype": t["adam_moments_dtype"],
                     "remat": engine == "fused", "remat_policy": "dots_attn",
                     "grad_engine": engine, "seed": TP_SEED},
        "distributed": {"tp_size": TP, **dist_kw},
    }


def tp_world(cfg, full_sd: dict, dev):
    """(world, per-rank ParallelEnv, TrainState, thread groups): cfg's tp
    layout as a thread world of TP ranks on the card, each rank's model
    its shards of `full_sd` (under the "row" strategy's flipped storage),
    the groups made as `mesh.init_parallel` makes them."""
    from picotron_tpu_torch import mesh
    from picotron_tpu_torch.models.llama import LlamaModel
    from picotron_tpu_torch.parallel.sharding import (
        shard_state_dict, tp_flips,
    )
    from picotron_tpu_torch.parallel.tp import tp_context
    from picotron_tpu_torch.train_step import init_train_state

    group = thread_group_class()
    world = GroupWorld(TP)
    tp_x, tp_y = mesh._tp_mesh(cfg)
    tp_sh = world.group(TP, tuple(range(TP)))
    ty_sh = [world.group(tp_y, tuple(ix * tp_y + iy for iy in range(tp_y)))
             for ix in range(tp_x)]
    tx_sh = [world.group(tp_x, tuple(ix * tp_y + iy for ix in range(tp_x)))
             for iy in range(tp_y)]
    sizes = mesh.layout_sizes(cfg)
    flips = tp_flips(cfg)
    pars, states, groups = [], [], []
    for r in range(TP):
        tg = group(tp_sh, r)
        ix, iy = divmod(r, tp_y)
        ty = tx = None
        if tp_y > 1 and tp_x > 1:
            ty, tx = group(ty_sh[ix], iy), group(tx_sh[iy], ix)
        elif tp_y > 1:
            ty = tg
        elif tp_x > 1:
            tx = tg
        par = mesh.ParallelEnv(
            sizes=sizes, rank=r, world_size=TP, device=dev, backend="thread",
            tp_group=tg, data_group=solo_group(r), host_group=None,
            coords=mesh.rank_coords(r, sizes), tp_mesh=(tp_x, tp_y),
            tp_ty_group=ty, tp_tx_group=tx)
        model = LlamaModel(cfg.model, device=dev, tp=tp_context(
            par, cfg.distributed.sequence_parallel, cfg))
        model.load_state_dict(shard_state_dict(full_sd, r, TP, flips=flips))
        pars.append(par)
        states.append(init_train_state(cfg, model, par))
        groups.append([tg, ty, tx])
    return world, pars, states, groups


def tp_steps(cfg, world, pars, states, batch, tls) -> dict:
    """TP_STEPS steps: under the fused engine each rank's own train step
    (`make_train_step`) on its thread; under AD each rank's forward on its
    thread, ONE backward over the ranks' summed NLL sums from this thread
    (the joined collectives take every rank's transposes), then each
    rank's seam (`GradSync`), guard norm and AdamW step on its thread.
    {"losses", "grad_norms" (the guard's, of the whole model; rank 0's,
    every rank's must agree), "walls" (s per step)}."""
    from picotron_tpu_torch.models.llama import loss_sum_count
    from picotron_tpu_torch.parallel.api import finish_grads, grad_seam
    from picotron_tpu_torch.parallel.sharding import seq_sharded
    from picotron_tpu_torch.train_step import (
        make_train_step, resolved_grad_engine,
    )

    fused = resolved_grad_engine(cfg) == "fused"
    steps = [make_train_step(cfg, p) for p in pars] if fused else None
    seams = [grad_seam(p, seq_sharded(cfg)) for p in pars]
    ids, tgt = batch

    def fused_step(r):
        tls.rank = r
        m = steps[r](states[r], batch)
        return float(m["loss"]), float(m["grad_norm"])

    def forward(r):
        tls.rank = r
        for buf in states[r].optimizer.grad_of.values():
            buf.zero_()
        total, count, _ = loss_sum_count(states[r].model, ids[0], tgt[0])
        return total, count

    def finish(r, total, count):
        tls.rank = r
        st = states[r]
        opt = st.optimizer
        loss, scale = finish_grads(cfg.model, opt.grad_of, total.detach(),
                                   count, [], seams[r](st.model))
        gnorm = opt.grad_norm()
        opt.step(scale, grad_norm=gnorm)
        st.step += 1
        return float(loss), float(gnorm * scale)

    sync = torch.cuda.synchronize if ids.is_cuda else (lambda: None)
    losses, norms, walls = [], [], []
    for _ in range(TP_STEPS):
        sync()
        t0 = time.perf_counter()
        if fused:
            got = world.run(fused_step)
        else:
            outs = world.run(forward)
            sum(t for t, _ in outs).backward()
            got = world.run(lambda r: finish(r, *outs[r]))
            del outs
        sync()
        walls.append(time.perf_counter() - t0)
        if len(set(got)) != 1:
            raise AssertionError(f"15a: the tp ranks' losses or grad norms "
                                 f"differ: {got}")
        losses.append(got[0][0])
        norms.append(got[0][1])
    return {"losses": losses, "grad_norms": norms, "walls": walls}


def tp_forward_counts(cfg, world, pars, states, groups, batch) -> list:
    """Each rank's tp collectives by kind over one forward (the eval
    step: no grad)."""
    from picotron_tpu_torch.train_step import make_eval_step

    for g in groups:
        reset_counts(g)
    evals = [make_eval_step(cfg, p) for p in pars]
    world.run(lambda r: evals[r](states[r].model, batch))
    return [rank_counts(g) for g in groups]


def tp_full_params(cfg, dev) -> dict:
    """The whole model's fp32 params from TP_SEED (what every layout
    transplants)."""
    from picotron_tpu_torch.models.llama import LlamaModel, init_params

    gen = torch.Generator(device=dev).manual_seed(TP_SEED)
    model = init_params(LlamaModel(cfg.model, device=dev), gen)
    return {n: p.detach() for n, p in model.named_parameters()}


def tp_batch(cfg, seq: int, dev):
    import numpy as np

    toks = torch.from_numpy(np.random.default_rng(TP_SEED).integers(
        0, cfg.model.vocab_size, (1, 1, seq + 1))).to(dev)
    return toks[..., :-1].contiguous(), toks[..., 1:].contiguous()


def tp_strategies_phase(here: str, card: str, run: Optional[dict] = None,
                        dev: str = "cuda", seqs=(TP_SEQ_FP32, TP_SEQ),
                        layers: int = TP_LAYERS) -> dict:
    """Phase 15a (module docstring): every TP_LAYOUTS entry in fp32 at
    TP_SEQ_FP32 (losses and the step-1 grad norm against its twin's) and
    in bf16 at TP_SEQ (flash launches per rank at the layout's heads,
    collectives by kind, ms/step, peak GiB). `run`, `dev`, `seqs` and
    `layers` replace the configuration (a tiny model on the CPU in the
    tests, where the launches are not counted)."""
    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.ops import flash_attention as fa
    from picotron_tpu_torch.parallel.tp_strategies import (
        forward_collectives,
    )

    if run is None:
        with open(os.path.join(here, TP_RUN)) as f:
            run = json.load(f)
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    out = {"card": card, "tp": TP, "layers": layers, "seq": seqs[1],
           "seq_fp32": seqs[0], "steps": TP_STEPS,
           "limits": {"TP_LOSS_RTOL": TP_LOSS_RTOL}, "layouts": {}}
    tls = threading.local()
    out["adaptive"] = tp_adaptive(run, seqs[0], layers)
    legs = [(name, engine) for name, (_, twin) in TP_LAYOUTS.items()
            for engine in (("fused", "ad") if twin is None else ("fused",))]
    for dtype, seq in zip(("float32", "bfloat16"), seqs):
        cfg0 = config_from_dict(tp_raw(run, {}, dtype, seq, "fused", layers))
        full = tp_full_params(cfg0, dev)
        batch = tp_batch(cfg0, seq, dev)
        for name, engine in legs:
            dist_kw, twin = TP_LAYOUTS[name]
            cfg = config_from_dict(tp_raw(run, dist_kw, dtype, seq, engine,
                                          layers))
            base = 0
            if cuda:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            world, pars, states, groups = tp_world(cfg, full, dev)
            key = name if engine == "fused" else f"{name} (AD)"
            entry = out["layouts"].setdefault(key, {})
            if dtype == "float32":
                res = tp_steps(cfg, world, pars, states, batch, tls)
                entry["losses_fp32"] = res["losses"]
                entry["grad_norms_fp32"] = res["grad_norms"]
            else:
                fwd = tp_forward_counts(cfg, world, pars, states, groups,
                                        batch)
                want = forward_collectives(cfg)
                for g in groups:
                    reset_counts(g)
                table: dict = {}
                fa.reset_launch_counts()
                with flash_by_rank(table, tls):
                    res = tp_steps(cfg, world, pars, states, batch, tls)
                # each rank's calls of the TP_STEPS steps, for phase 16
                out.setdefault("_issued", {})[key] = (
                    tp_raw(run, dist_kw, dtype, seq, engine, layers),
                    [issued(g) for g in groups])
                peak = None
                if cuda:
                    torch.cuda.synchronize()
                    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                variants = launch_counts(fa)
                step_counts = [{k: v // TP_STEPS for k, v in
                                rank_counts(g).items()} for g in groups]
                entry.update(
                    losses_bf16=res["losses"],
                    step_ms=statistics.median(res["walls"][1:]) * 1e3,
                    step_seconds=res["walls"], peak_gib=peak,
                    heads=TP_HEADS[name],
                    forward_collectives=fwd[0],
                    forward_collectives_promised=want,
                    collectives_per_step=step_counts[0],
                    launches_per_rank=tp_launches(table, name, engine,
                                                  layers),
                    variants=variants)
                check_tp_leg(key, entry, fwd, want, table, variants, name,
                             engine, layers, cuda)
            del world, pars, states, groups
            if cuda:
                torch.cuda.empty_cache()
        del full
        if cuda:
            torch.cuda.empty_cache()
    # the losses against the twin's AD run, in fp32
    for key, entry in out["layouts"].items():
        name = key.replace(" (AD)", "")
        twin = TP_LAYOUTS[name][1] or name
        ref = out["layouts"][f"{twin} (AD)"]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(entry["losses_fp32"] + entry["grad_norms_fp32"][:1],
                      ref["losses_fp32"] + ref["grad_norms_fp32"][:1]))
        ref = ref["losses_fp32"]
        entry["twin"] = f"{twin} (AD)"
        entry["rel_err_vs_twin"] = rel
        log(f"phase 15a {key} ({card}): fp32 losses {entry['losses_fp32']} "
            f"(twin {twin} AD: {ref}), step-1 grad norm "
            f"{entry['grad_norms_fp32'][0]}, rel err {rel:.3g} (limit "
            f"{TP_LOSS_RTOL:g}); bf16 {entry['step_ms']:.1f} ms/step over "
            f"the {TP} thread ranks, peak {entry['peak_gib']} GiB, "
            f"heads {entry['heads']}, collectives per step (rank 0) "
            f"{entry['collectives_per_step']}, forward "
            f"{entry['forward_collectives']}")
        if not rel <= TP_LOSS_RTOL:
            raise AssertionError(f"15a {key}: fp32 losses and step-1 grad "
                                 f"norm vs {twin} AD's: rel err {rel:.3g}")
    preset = out["adaptive"]["preset"]
    if preset is not None:
        got = out["layouts"]["adaptive"]["losses_fp32"]
        want = out["layouts"][preset]["losses_fp32"]
        out["adaptive"]["equal_to_preset"] = got == want
        log(f"phase 15a adaptive ({card}): resolved on the h100 tier to "
            f"{out['adaptive']['spec']} = {preset!r}; fp32 losses {got} "
            f"(the preset's {want}, "
            f"{'bit for bit' if got == want else 'DIFFER'})")
        if got != want:
            raise AssertionError(f"15a adaptive: losses {got} vs its preset "
                                 f"{preset}'s {want}")
    return out


def tp_adaptive(run: dict, seq: int, layers: int) -> dict:
    """15a's "adaptive" layout resolved by the cost model on the h100
    tier: its per-class spec, the named layout with the same spec (None
    for a mix no preset spells), and its per-rank heads (TP_HEADS, from
    the attention pair's kind)."""
    from picotron_tpu_torch.config import (
        config_from_dict, resolved_tp_strategy,
    )

    def spec(kw):
        return resolved_tp_strategy(config_from_dict(
            tp_raw(run, kw, "float32", seq, "fused", layers)))

    got = spec(TP_LAYOUTS["adaptive"][0])
    preset = next((name for name in ("megatron", "row", "2d 2x2",
                                     "qkv=2d,o=2d")
                   if spec(TP_LAYOUTS[name][0]) == got), None)
    TP_HEADS["adaptive"] = TP_PAIR_HEADS[got["qkv"]]
    return {"tier": "h100", "spec": got, "preset": preset}


def tp_launches(table: dict, name: str, engine: str,
                layers: int = TP_LAYERS) -> dict:
    """{kernel: [launches of rank r at the layout's heads]}; under AD the
    backward's run on the autograd engine's thread (rank None) and are
    given as their total."""
    hq, hkv = TP_HEADS[name]
    out = {}
    for kernel, _ in KERNELS:
        per = [table.get((r, kernel, hq, hkv), 0) for r in range(TP)]
        if engine == "ad" and kernel != "flash_fwd":
            per = [table.get((None, kernel, hq, hkv), 0)]
        out[kernel] = per
    return out


def check_tp_leg(key, entry, fwd, want, table, variants, name, engine,
                 layers: int = TP_LAYERS, cuda: bool = True):
    """15a's checks of one bf16 leg: every rank's forward collectives the
    promised schedule; on the card every flash launch at the layout's
    heads, on the tensor-core kernels, `layers` per rank per step for
    each kernel."""
    fails = []
    for r, got in enumerate(fwd):
        if got != want:
            fails.append(f"rank {r} forward collectives {got}, promised "
                         f"{want}")
    if not cuda:
        if fails:
            raise AssertionError(f"15a {key}: " + "; ".join(fails))
        return
    hq, hkv = TP_HEADS[name]
    stray = {k: v for k, v in table.items() if k[2:] != (hq, hkv)}
    if stray:
        fails.append(f"flash launches at other heads: {stray}")
    per = layers * TP_STEPS
    for kernel, launches in entry["launches_per_rank"].items():
        expect = ([per * TP] if engine == "ad" and kernel != "flash_fwd"
                  else [per] * TP)
        if launches != expect:
            fails.append(f"{kernel} launches {launches}, want {expect}")
    for vkey in VARIANT_COUNTS:
        if variants[vkey]["cuda_core"]:
            fails.append(f"{vkey} {variants[vkey]}: a bf16 leg ran the "
                         f"CUDA-core kernel")
    if fails:
        raise AssertionError(f"15a {key}: " + "; ".join(fails))


def hier_raw(here: str, raw: Optional[dict] = None, seq: int = SEQ) -> dict:
    """15b's configuration: CONFIG's model at HIER_LAYERS layers (or
    `raw`'s), fp32, mbs 1, ga 1, the AD engine without remat, dp HIER_DP
    over HIER_SLICES slices with dp crossing the cut."""
    if raw is None:
        with open(os.path.join(here, CONFIG)) as f:
            raw = json.load(f)
        raw["model"].update(num_hidden_layers=HIER_LAYERS)
    raw["model"]["dtype"] = "float32"
    raw["training"].update(seq_length=seq, micro_batch_size=1,
                           gradient_accumulation_steps=1, remat=False,
                           grad_engine="ad")
    raw["distributed"] = {"dp_size": HIER_DP, "slices": HIER_SLICES,
                          "dcn_axes": "dp"}
    raw.pop("checkpoint", None)
    return raw


def hier_world(cfg, full: dict, dev):
    """(world, per-rank ParallelEnv, per-rank [data, intra, cross] thread
    groups, per-rank models loaded from `full`): cfg's dp layout over
    its slices as a thread world, the cohorts as `mesh.init_parallel`
    makes them (the intra and cross groups only under the hierarchical
    reduction)."""
    from picotron_tpu_torch import mesh
    from picotron_tpu_torch.models.llama import LlamaModel
    from picotron_tpu_torch.parallel.hier_reduce import (
        _dp_groups, dp_granule, use_hier_dp,
    )

    group = thread_group_class()
    g_dp, inner = dp_granule(cfg)
    granule = (g_dp, inner) if use_hier_dp(cfg) else (1, HIER_DP)
    world = GroupWorld(HIER_DP)
    data = world.group(HIER_DP, tuple(range(HIER_DP)))
    intra, cross = _dp_groups(g_dp, inner)
    intra_sh = [world.group(len(m), tuple(m)) for m in intra]
    cross_sh = [world.group(len(m), tuple(m)) for m in cross]
    sizes = mesh.layout_sizes(cfg)
    pars, groups, models = [], [], []
    for r in range(HIER_DP):
        o, i = divmod(r, inner)
        gs = [group(data, r), None, None]
        if granule[0] > 1:
            gs[1] = group(intra_sh[o], i) if inner > 1 else None
            gs[2] = group(cross_sh[i], o)
        pars.append(mesh.ParallelEnv(
            sizes=sizes, rank=r, world_size=HIER_DP, device=dev,
            backend="thread", tp_group=None, data_group=gs[0],
            host_group=None, coords=mesh.rank_coords(r, sizes),
            dp_granule=granule, dp_intra_group=gs[1],
            dp_cross_group=gs[2]))
        model = LlamaModel(cfg.model, device=dev)
        model.load_state_dict(full)
        models.append(model)
        groups.append(gs)
    return world, pars, groups, models


def hier_phase(here: str, card: str, raw: Optional[dict] = None,
               dev: str = "cuda", seq: int = SEQ) -> dict:
    """Phase 15b (module docstring): one step's grads of CONFIG's model at
    HIER_LAYERS layers, fp32, as a thread world of dp HIER_DP over
    HIER_SLICES slices, by the hierarchical reduction and by the flat
    all-reduce. `raw`, `dev` and `seq` replace the configuration (a tiny
    model on the CPU in the tests)."""
    import numpy as np

    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.models.llama import LlamaModel, init_params
    from picotron_tpu_torch.optimizer import param_grads
    from picotron_tpu_torch.parallel.hier_reduce import dp_granule
    from picotron_tpu_torch.train_step import make_grads_fn

    dev = torch.device(dev)
    raw = hier_raw(here, raw, seq)
    gen = torch.Generator(device=dev).manual_seed(HIER_SEED)
    cfg = config_from_dict(raw)
    full = init_params(LlamaModel(cfg.model, device=dev), gen).state_dict()
    toks = torch.from_numpy(np.random.default_rng(HIER_SEED).integers(
        0, cfg.model.vocab_size, (HIER_DP, 1, 1, seq + 1))).to(dev)
    runs = {}
    for mode in ("hier", "flat"):
        raw["distributed"]["hier_dp_reduce"] = "auto" if mode == "hier" \
            else "off"
        cfg = config_from_dict(raw)
        world, pars, groups, models = hier_world(cfg, full, dev)
        fns = [make_grads_fn(cfg, p) for p in pars]
        # the AD engine sums into the params' .grad
        grads = [param_grads(m.parameters()) for m in models]

        def rank(r):
            loss, scale = fns[r](models[r], (toks[r, ..., :-1],
                                             toks[r, ..., 1:]), grads[r])
            return float(loss)

        losses = world.run(rank)
        names = [n for n, _ in models[0].named_parameters()]
        runs[mode] = {
            "loss": losses[0], "losses": losses,
            "grads": [dict(zip(names, g.values())) for g in grads],
            "counts": [{k: rank_counts([g]) for k, g in zip(
                ("data", "intra", "cross"), gs) if g is not None}
                for gs in groups],
            "cross_bytes": (groups[0][2].nbytes["all_reduce"]
                            if groups[0][2] is not None else 0),
            "data_bytes": groups[0][0].nbytes["all_reduce"]}
        del models, world, pars
    hier, flat = runs["hier"], runs["flat"]
    names = list(flat["grads"][0])
    errs = {n: rel_l2(hier["grads"][0][n], flat["grads"][0][n])
            for n in names}
    worst = max(errs, key=errs.get)
    numel = sum(flat["grads"][0][n].numel() for n in names)
    m = dp_granule(cfg)[1]
    flat_grad_bytes = 4 * numel
    fails = []
    for r in range(HIER_DP):
        for n in names:
            if not torch.equal(hier["grads"][r][n], hier["grads"][0][n]):
                fails.append(f"rank {r}'s {n} is not rank 0's")
                break
    want_hier = {"data": {"all_reduce": 1, "all_gather": 0,
                          "reduce_scatter": 0},
                 "intra": {"all_reduce": 0, "all_gather": 1,
                           "reduce_scatter": 1},
                 "cross": {"all_reduce": 1, "all_gather": 0,
                           "reduce_scatter": 0}}
    want_flat = {"data": {"all_reduce": len(names) + 1, "all_gather": 0,
                          "reduce_scatter": 0}}
    for r in range(HIER_DP):
        if hier["counts"][r] != want_hier:
            fails.append(f"rank {r} hier legs {hier['counts'][r]}, want "
                         f"{want_hier}")
        if flat["counts"][r] != want_flat:
            fails.append(f"rank {r} flat legs {flat['counts'][r]}, want "
                         f"{want_flat}")
    # the flat data group's all-reduces: every grad, then (NLL sum, count)
    if flat["data_bytes"] != flat_grad_bytes + 8:
        fails.append(f"flat all-reduce bytes {flat['data_bytes']}, want "
                     f"{flat_grad_bytes} + 8")
    padded = -(-numel // m) * m
    if hier["cross_bytes"] * m != 4 * padded:
        fails.append(f"cross-slice bytes {hier['cross_bytes']} x {m} != "
                     f"the padded flat buffer's {4 * padded}")
    if not errs[worst] <= HIER_GRAD_RTOL:
        fails.append(f"grad {worst} rel L2 {errs[worst]:.3g} (limit "
                     f"{HIER_GRAD_RTOL:g})")
    if hier["loss"] != flat["loss"]:
        fails.append(f"losses {hier['loss']} vs {flat['loss']}")
    res = {"card": card, "dp": HIER_DP, "slices": HIER_SLICES,
           "granule": list(dp_granule(cfg)),
           "layers": cfg.model.num_hidden_layers, "seq": seq,
           "loss": hier["loss"], "flat_loss": flat["loss"],
           "worst_grad_rel_l2": errs[worst], "worst_grad": worst,
           "legs_rank0": hier["counts"][0], "flat_legs_rank0":
           flat["counts"][0], "cross_slice_bytes": hier["cross_bytes"],
           "flat_allreduce_bytes": flat_grad_bytes,
           "cross_over_flat": hier["cross_bytes"] / flat_grad_bytes,
           "limits": {"HIER_GRAD_RTOL": HIER_GRAD_RTOL}}
    log(f"phase 15b hierarchical dp reduction ({card}): dp {HIER_DP} over "
        f"{HIER_SLICES} slices (inner {m}); worst grad vs flat rel L2 "
        f"{errs[worst]:.3g} ({worst}, limit {HIER_GRAD_RTOL:g}); legs (rank "
        f"0) {hier['counts'][0]}; cross-slice bytes {hier['cross_bytes']} = "
        f"{res['cross_over_flat']:.4f} of the flat all-reduce's "
        f"{flat_grad_bytes}")
    if fails:
        raise AssertionError("15b: " + "; ".join(fails))
    return res


# ---------------------------------------------------------------------------
# phase 16: shardcheck
# ---------------------------------------------------------------------------


def recorded_calls(cfg, rank: int, steps: int = 1) -> list:
    """Rank `rank`'s meta recording of one step of `cfg`, in `issued`'s
    form, each call `steps` times: the effective calls by (kind, group,
    bytes handed in or taken out)."""
    from collections import Counter

    from picotron_tpu_torch.analysis import record_train_step

    rec = record_train_step(cfg, rank=rank)
    c = Counter((op.kind, op.group, op.shard_bytes)
                for op in rec.programs[rank] if op.effective)
    return sorted((*k, v * steps) for k, v in c.items())


def schedules_vs_recorded(label: str, cfg, per_rank: list,
                          steps: int) -> dict:
    """16b for one layout: every thread rank's issued calls (`issued`)
    against its meta recording, and `run_shardcheck` on the recorded
    step. Raises on a difference or a finding."""
    from picotron_tpu_torch.analysis import record_train_step, run_shardcheck

    for r, got in enumerate(per_rank):
        want = recorded_calls(cfg, r, steps)
        if got != want:
            extra = sorted(set(map(tuple, got)) - set(map(tuple, want)))
            missing = sorted(set(map(tuple, want)) - set(map(tuple, got)))
            raise AssertionError(
                f"16b {label}: rank {r} issued {len(got)} kinds of call, "
                f"the recording {len(want)}; issued only {extra[:4]}, "
                f"recorded only {missing[:4]}")
    rep = run_shardcheck(cfg, checks=("spec", "collectives", "boundary",
                                      "provenance", "donation",
                                      "stability"),
                         recorded=record_train_step(cfg))
    if not rep.ok():
        raise AssertionError(f"16b {label}: " + rep.render())
    return {"ranks": len(per_rank), "steps": steps,
            "calls_per_rank": [sum(c[-1] for c in got) for got in per_rank],
            "kinds": sorted({c[0] for got in per_rank for c in got}),
            "audit_warnings": len(rep.warnings())}


def hier_step_issued(here: str, raw: Optional[dict] = None,
                     dev: str = "cuda", seq: int = SEQ) -> tuple:
    """(cfg, per-rank `issued`) of one train step of 15b's layout under
    the hierarchical reduction (`make_train_step` on each thread rank)."""
    import numpy as np

    from picotron_tpu_torch.config import config_from_dict
    from picotron_tpu_torch.models.llama import LlamaModel, init_params
    from picotron_tpu_torch.train_step import init_train_state, make_train_step

    dev = torch.device(dev)
    cfg = config_from_dict(hier_raw(here, raw, seq))
    gen = torch.Generator(device=dev).manual_seed(HIER_SEED)
    full = init_params(LlamaModel(cfg.model, device=dev), gen).state_dict()
    toks = torch.from_numpy(np.random.default_rng(HIER_SEED).integers(
        0, cfg.model.vocab_size, (HIER_DP, 1, 1, seq + 1))).to(dev)
    world, pars, groups, models = hier_world(cfg, full, dev)
    states = [init_train_state(cfg, m, p) for m, p in zip(models, pars)]
    steps = [make_train_step(cfg, p) for p in pars]
    world.run(lambda r: float(steps[r](states[r], (
        toks[r, ..., :-1], toks[r, ..., 1:]))["loss"]))
    return cfg, [issued(gs) for gs in groups]


def shardcheck_phase(here: str, card: str, phase3: dict, tp: dict,
                     serving: dict) -> dict:
    """Phase 16 (module docstring)."""
    from picotron_tpu_torch.config import config_from_dict

    t0 = time.perf_counter()
    pre = phase3.get("preflight")
    if not pre or not pre["line"].startswith("shardcheck preflight: ok"):
        raise AssertionError(f"16a: phase 3's trainer printed no "
                             f"'shardcheck preflight: ok' line: {pre}")
    out = {"card": card, "preflight": pre, "layouts": {}}
    log(f"phase 16a preflight ({card}): {pre['line']} on phase 3's full "
        f"SmolLM-1.7B config ({pre['recorded_ops']} recorded collectives)")
    for key, (raw, per_rank) in sorted(tp.pop("_issued").items()):
        out["layouts"][key] = schedules_vs_recorded(
            key, config_from_dict(raw), per_rank, TP_STEPS)
    torch.cuda.empty_cache()
    cfg, per_rank = hier_step_issued(here)
    out["layouts"]["hier dp over slices"] = schedules_vs_recorded(
        "hier dp over slices", cfg, per_rank, 1)
    torch.cuda.empty_cache()
    for key, entry in out["layouts"].items():
        log(f"phase 16b {key} ({card}): each of {entry['ranks']} thread "
            f"ranks issued its recording ({entry['calls_per_rank'][0]} "
            f"calls of {entry['kinds']} over {entry['steps']} step(s)); "
            f"shardcheck green")
    feed = serving["trace"]["variant_check"]
    if not (feed["proven"] and feed["uncommitted"] == []
            and feed["upload_device"].startswith("cuda")
            and feed["hazard_events"] == 0):
        raise AssertionError(f"16c: check_engine_feed on 10c's engine: "
                             f"{feed}")
    out["engine_feed"] = feed
    log(f"phase 16c engine feed ({card}): proven on 10c's engine, "
        f"{feed['leaves']} persistent inputs on {feed['upload_device']}, "
        f"0 variant_hazard events, {feed['seconds'] * 1e3:.2f} ms")
    out["seconds"] = time.perf_counter() - t0
    return out


def cost_points(here: str, result: dict, fused: dict, engines: dict,
                offload: dict, moe: dict) -> list:
    """The measured points of this run the h100 tier is fitted on: each
    a repo config with overrides (analysis/calibration.point_config) and
    its tokens/s: phase 3 (median of steps 2-4), 5b (fused), each 5c
    policy (its step 2), 6c (the offloaded optimizer at ga 64) and 11a
    (two Mixtral layers)."""
    pts = [
        {"label": "phase 3 (AD, no remat)", "config": CONFIG,
         "tokens_per_sec_per_chip": engines["ad"]["tokens_per_s"]},
        {"label": "phase 5b (fused, dots_attn)", "config": FUSED_CONFIG,
         "tokens_per_sec_per_chip": engines["fused"]["tokens_per_s"]},
    ]
    for policy, r in engines["remat"].items():
        pts.append({
            "label": f"phase 5c ({policy})", "config": CONFIG,
            "overrides": {"training": {
                "remat": True, "remat_policy": policy, "grad_engine": "ad",
                "total_train_steps": 2}},
            "tokens_per_sec_per_chip": GA * MBS * SEQ / r["step_2_s"]})
    pts.append({"label": "phase 6c (offload, ga 64)",
                "config": OFFLOAD_CONFIG,
                "tokens_per_sec_per_chip": offload["config"]["tokens_per_s"]})
    pts.append({"label": "phase 11a (Mixtral 2 layers)",
                "config": MOE_CONFIG,
                "tokens_per_sec_per_chip": moe["train"]["tokens_per_s"]})
    return pts


def cost_model_phase(here: str, card: str, points: list) -> dict:
    """The h100 tier's predicted ms/step for each measured point of this
    run (`cost_points`) beside the measurement and their ratio, under the
    committed calibration (analysis/h100_points.json's fit, an earlier
    run of these points); the ordering result, Spearman rank agreement
    over tokens/s (`rank_agreement`: the points' steps span 64x in
    tokens, so a ranking of ms/step mostly ranks step sizes), beside the
    ms/step one; the constants this run's points would fit; fails if a
    prediction is not within COST_RATIO of its measurement."""
    import dataclasses

    from picotron_tpu_torch.analysis.calibration import (
        FIT_KEYS, FIT_START, MeasuredPoint, fit_calibration, point_config,
        rank_agreement,
    )
    from picotron_tpu_torch.analysis.cost_model import (
        CostModel, h100_tier, spearman,
    )

    gen = h100_tier()
    model = CostModel(gen)
    rows, measured = [], []
    for p in points:
        cfg = point_config(p, here)
        tokens = cfg.tokens_per_step
        meas_ms = tokens / p["tokens_per_sec_per_chip"] * 1e3
        pred_ms = model.predict(cfg).total_s * 1e3
        rows.append({**p, "measured_ms": meas_ms, "predicted_ms": pred_ms,
                     "ratio": pred_ms / meas_ms})
        measured.append(MeasuredPoint(cfg, p["tokens_per_sec_per_chip"],
                                      p["label"], "chip_smoke"))
    rho = spearman([r["predicted_ms"] for r in rows],
                   [r["measured_ms"] for r in rows])
    rank = rank_agreement(measured, model)["pooled"]
    fitted = fit_calibration(measured, gen, start=FIT_START, keys=FIT_KEYS)
    res = {"card": card, "tier": dataclasses.asdict(gen), "points": rows,
           "spearman_tokens_per_s": rank, "spearman_ms_per_step": rho,
           "calibration": dataclasses.asdict(model.calib),
           "fitted": dataclasses.asdict(fitted),
           "fitted_rank": rank_agreement(measured, CostModel(gen, fitted)),
           "limits": {"COST_RATIO": COST_RATIO}}
    for r in rows:
        log(f"cost model [{gen.name}] {r['label']}: predicted "
            f"{r['predicted_ms']:.1f} ms/step, measured "
            f"{r['measured_ms']:.1f} ({card}), ratio {r['ratio']:.3f}")
    log(f"cost model: Spearman over {len(rows)} points {rank:.4f} of "
        f"tokens/s ({rho:.4f} of ms/step); this run's fit {res['fitted']}, "
        f"its rank agreement {res['fitted_rank']['pooled']}")
    bad = [r["label"] for r in rows
           if not 1 / COST_RATIO < r["ratio"] < COST_RATIO]
    if bad:
        raise AssertionError(f"cost model: predictions off by more than "
                             f"{COST_RATIO}x for {bad}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--main-path"]:
        return compare_main_paths(sys.argv[2:])
    # chaos is process-wide: only phase 12b's child runs get a spec
    os.environ.pop("PICOTRON_CHAOS", None)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from picotron_tpu_torch.kernels import build
    from picotron_tpu_torch.ops import flash_attention as fa
    from picotron_tpu_torch.ops.rope import rope_tables
    from picotron_tpu_torch.utils import H100_BF16_PEAK

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 1: build (one nvcc per source, started together)
    sources = ("flash_attention", "adamw")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "error" in line):
                log(f"ptxas: {line.strip()}")
    if fa.WGMMA_HEAD_DIMS != (WGMMA_D,):
        raise AssertionError(f"the ops module's wgmma head dims "
                             f"{fa.WGMMA_HEAD_DIMS} are not "
                             f"chip_smoke's {WGMMA_D}")
    log(f"bwd_dkv_wgmma_kernel: {fa._lib().pt_dkv_wgmma_smem()} bytes of "
        f"dynamic shared memory per block; bwd_dq_wgmma_kernel: "
        f"{fa._lib().pt_dq_wgmma_smem()}")
    mma = sass_mma(build)
    for fn, (n, ng) in mma.items():
        log(f"sass: {n} HMMA, {ng} HGMMA in {fn}")
    # (kernel, instruction, its instantiations: D 64 and 128, or one)
    for kernel, instr, n_fn in (("fwd_mma_kernel", 0, 2),
                                ("bwd_dq_mma_kernel", 0, 1),
                                ("bwd_dq_wgmma_kernel", 1, 1),
                                ("bwd_dkv_mma_kernel", 0, 1),
                                ("bwd_dkv_wgmma_kernel", 1, 1)):
        counts = [c[instr] for fn, c in mma.items() if kernel in fn]
        if len(counts) != n_fn or min(counts) == 0:
            raise AssertionError(f"{kernel}'s SASS holds no tensor-core "
                                 f"{('HMMA', 'HGMMA')[instr]}: {counts}")
    log("phase 1 build: ok")

    # phase 2: kernels against plain versions
    errs: dict = {}
    for i, (label, shp) in enumerate(SHAPES.items()):
        case = make_case(fa, rope_tables, *shp, dev=dev, seed=i)
        compare(fa, case, errs, label)
        if shp[5] == WGMMA_D:
            check_rope_rows(fa, case, label)
        del case
        torch.cuda.empty_cache()
    case = make_case(fa, rope_tables, *SLICE_SHAPE, dev=dev, seed=7)
    times = time_kernels(fa, case)
    bnd = bounds(*SLICE_SHAPE)
    del case
    torch.cuda.empty_cache()
    # the tensor-core kernels alone at each static shape: time, TFLOP/s,
    # share of bound; and without RoPE (the same products, no per-tile
    # rotation)
    shape_times: dict = {}
    for label, shp in ((k, v) for k, v in SHAPES.items() if not v[-1]):
        case = make_case(fa, rope_tables, *shp, dev=dev, seed=7)
        q, k, v, qpos, kpos, tabs, do, dlse, static = case
        bnd_shape = bounds(*shp)
        for rope, t in (("", tabs), (" without RoPE", None)):
            out, lse = fa.fwd_kernel(q, k, v, qpos, kpos, t, True, static)
            delta = fa._delta(do, out, dlse)
            runs = {
                "flash_fwd": lambda: fa.fwd_kernel(q, k, v, qpos, kpos, t,
                                                   True, static),
                "flash_bwd_dq": lambda: fa.bwd_dq_kernel(
                    q, k, v, do, lse, delta, qpos, kpos, t, True, static),
                "flash_bwd_dkv": lambda: fa.bwd_dkv_kernel(
                    q, k, v, do, lse, delta, qpos, kpos, t, True, static),
            }
            for name, fn in runs.items():
                bound_ms, bound_by, flops = bnd_shape[name]
                ms = cuda_ms(fn, iters=20, warmup=3)
                if not rope:
                    shape_times.setdefault(label, {})[name] = {
                        "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "share_of_bound": bound_ms / ms,
                        "max_abs_err": errs.get((label, name))}
                log(f"{name} {label}{rope} ({card}): {ms:.4f} ms, "
                    f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bound_ms:.4f} "
                    f"ms ({bound_by}), {100 * bound_ms / ms:.1f}% of bound")
        del case, q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("phase 2 kernels vs plain: ok")

    # phase 3: the main path (with the trainer's shardcheck preflight)
    result = main_path(fa, here)
    log(f"phase 3 main path: ok, losses {result['losses']}, first batch "
        f"after {STEPS} steps {result['seen_batch_loss']}")
    # the preflight is static analysis of a config: phase 16 reads phase
    # 3's, the later trainer runs (and their children) skip it
    os.environ["PICOTRON_PREFLIGHT"] = "0"

    # phase 4: checkpoint and resume
    per_step = 24 * GA
    expect = {"run A": {"flash_fwd": 2 * per_step, "flash_bwd_dq": 2 * per_step,
                        "flash_bwd_dkv": 2 * per_step},
              "run B": {"flash_fwd": 2 * per_step + 24 * GA * EVAL_STEPS,
                        "flash_bwd_dq": 2 * per_step,
                        "flash_bwd_dkv": 2 * per_step}}
    phase4_launches = {}

    from picotron_tpu_torch import optimizer as topt

    n_tensors = result["launches"]["adamw"] // STEPS

    def on_launches(label):
        counts = launch_counts(fa)
        check_launches(counts, expect[label], f"phase 4 {label}")
        if topt.launches["adamw"] != 2 * n_tensors:
            raise AssertionError(f"phase 4 {label}: adamw launched "
                                 f"{topt.launches['adamw']} times, want "
                                 f"{2 * n_tensors}")
        phase4_launches[label] = {**counts["launches"], **topt.launches}
        fa.reset_launch_counts()
        topt.reset_launch_counts()

    torch.cuda.empty_cache()
    fa.reset_launch_counts()
    topt.reset_launch_counts()
    ckpt = checkpoint_resume(phase4_config(here), "cuda", result["losses"],
                             on_launches)
    ckpt["launches"] = phase4_launches
    log(f"phase 4 checkpoint and resume: ok, launches {phase4_launches}")
    torch.cuda.empty_cache()

    # phase 5: the fused grad engine, remat and chunked CE
    from picotron_tpu_torch.config import config_from_dict, load_config
    from picotron_tpu_torch.train_step import resolved_grad_engine

    engines = {"card": card,
               "gemm_accumulate_in_place_rel_l2": gemm_accumulate_in_place(dev)}
    engines["parity"] = engine_parity(load_config(os.path.join(here, CONFIG)))
    engine = resolved_grad_engine(load_config(os.path.join(here,
                                                           FUSED_CONFIG)))
    if engine != "fused":
        raise AssertionError(f"{FUSED_CONFIG} resolves to {engine}")
    fused = main_path(fa, here, FUSED_CONFIG)
    log(f"phase 5b fused main path: ok, losses {fused['losses']}, first "
        f"batch after {STEPS} steps {fused['seen_batch_loss']}, launches "
        f"{fused['launches']}")
    torch.cuda.empty_cache()
    engines["remat"] = remat_policies(fa, here, result["losses"])
    engines["chunked_ce"] = chunked_ce_check()
    log("phase 5 engines, remat and chunked CE: ok")

    # phase 6: the AdamW kernel and the host-offloaded optimizer
    adamw = adamw_vs_plain(dev)
    adamw.update(adamw_timing(load_config(os.path.join(here, CONFIG)), dev))
    offload = {"card": card, "adamw": adamw,
               "vs_resident": offload_vs_resident(fa, here),
               "config": offload_config_run(fa, here, H100_BF16_PEAK)}
    log("phase 6 adamw kernel and offload: ok")

    # phase 7: the parallel layouts' path under a one-rank NCCL group
    torch.cuda.empty_cache()
    parallel = parallel_phase(here, card, H100_BF16_PEAK)
    log("phase 7 parallel path (one-rank NCCL): ok")

    # phase 8: the cp schedules and the model's cp path in a thread world
    torch.cuda.empty_cache()
    context_parallel = {"schedules": cp_schedules_phase(card)}
    log("phase 8a cp schedules: ok")
    torch.cuda.empty_cache()
    context_parallel["model"] = cp_model_phase(card)
    log("phase 8b the model's cp path (fused engine, thread world): ok")

    # phase 9: the pipeline's walks in a thread world
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    pipeline = pp_phase(card)
    log(f"phase 9 the pipeline's walks (thread world of 2 stages): ok in "
        f"{time.perf_counter() - t9:.1f} s")

    # phase 10: generation and the serving engine
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    serving = serve_phase(fa, card)
    serving["seconds"] = time.perf_counter() - t10
    log(f"phase 10 generation and serving: ok in {serving['seconds']:.1f} s")

    # phase 11: mixture of experts at Mixtral-8x7B's full width
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    moe = moe_phase(fa, here, card, H100_BF16_PEAK)
    moe["seconds"] = time.perf_counter() - t11
    log(f"phase 11 mixture of experts: ok in {moe['seconds']:.1f} s")

    # phase 12: the trainer as the JAX package runs it
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    telemetry = {"card": card,
                 "main_path": telemetry_main_path(fa, here, result)}
    telemetry["chaos"] = chaos_phase(here)
    telemetry["packer"] = packer_phase()
    telemetry["seconds"] = time.perf_counter() - t12
    log(f"phase 12 telemetry, chaos and the packer: ok in "
        f"{telemetry['seconds']:.1f} s")

    # phase 13: profile_dir, elastic resize and the checkpoint tools
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    elastic = {"card": card, "profile": profile_phase(fa, here, result)}
    torch.cuda.empty_cache()
    elastic.update(elastic_phase(here))
    torch.cuda.empty_cache()
    elastic["chaos"] = chaos_tool_phase(here)
    elastic["seconds"] = time.perf_counter() - t13
    log(f"phase 13 profile_dir, elastic resize and the tools: ok in "
        f"{elastic['seconds']:.1f} s")

    # phase 14: disaggregated serving and the serving fleet
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    fleet = fleet_phase(fa, card)
    fleet["seconds"] = time.perf_counter() - t14
    log(f"phase 14 disaggregated serving and the fleet: ok in "
        f"{fleet['seconds']:.1f} s")

    # phase 15: the tp strategies and the hierarchical dp reduction
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    tp = tp_strategies_phase(here, card)
    torch.cuda.empty_cache()
    tp["hier"] = hier_phase(here, card)
    tp["seconds"] = time.perf_counter() - t15
    log(f"phase 15 the tp strategies and the hierarchical dp reduction: ok "
        f"in {tp['seconds']:.1f} s")

    # phase 16: shardcheck on the card's runs
    torch.cuda.empty_cache()
    shard = shardcheck_phase(here, card, result, tp, serving)
    log(f"phase 16 shardcheck: ok in {shard['seconds']:.1f} s")

    # numbers
    m = config_from_dict({"model": {"name": "SmolLM-1.7B"}}).model
    for label, res in (("main path (AD, no remat)", result),
                       ("fused path (fused, dots_attn)", fused)):
        nums = path_numbers(res, m, H100_BF16_PEAK)
        engines["ad" if res is result else "fused"] = {
            **nums, "losses": res["losses"],
            **{key: res[key] for key in VARIANT_COUNTS}}
        log(f"{label} ({card}): step {nums['step_ms']:.1f} ms (median of "
            f"steps 2-{STEPS}), {nums['tokens_per_s']:.1f} tokens/s, MFU "
            f"{100 * nums['mfu']:.2f}% of {H100_BF16_PEAK / 1e12:.1f} "
            f"TFLOP/s, peak memory {nums['peak_memory_gb']:.2f} GiB, step "
            f"seconds {res['step_seconds']}")
    cost_model = cost_model_phase(here, card, cost_points(
        here, result, fused, engines, offload, moe))
    from picotron_tpu_torch.kernels.variants import ptxas_lines

    wgmma_ptxas = {name: [line for line in ptxas_lines(
        build.BUILD_LOGS.get("flash_attention", ""), fn)
        if "registers" in line or "spill" in line]
        for name, fn in (("flash_bwd_dq", "bwd_dq_wgmma_kernel"),
                         ("flash_bwd_dkv", "bwd_dkv_wgmma_kernel"))}
    kernels = []
    for name, replaces in KERNELS:
        ms, plain_ms, lib_ms = times[name]
        bound_ms, bound_by, _ = bnd[name]
        log(f"{name} at B2 S2048 H32 D64 ({card}): {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms, bound {bound_ms:.4f} "
            f"ms ({bound_by})")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": result["launches"][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "cp_launches": {
                lay: res["launches"]["launches"][name]
                for lay, res in context_parallel["model"]["layouts"].items()
                if not lay.startswith("planted")},
            "pp_launches": pp_launches(pipeline, name),
            "serve_launches": serving["offline"]["forward_launches"][name],
            "fleet_launches": fleet["launches"][name],
            "moe_launches": moe["train"]["launches"][name],
            "moe_shape": {k: moe["kernels"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "tp2d_shape": shape_times[TP2D_LABEL][name],
            "tp_launches": {lay: res["launches_per_rank"][name]
                            for lay, res in tp["layouts"].items()},
            "dots_offload_launches":
                engines["remat"]["dots_offload"]["launches"][name],
            # the dq's and dk/dv's variants on the main path (D 64: the
            # wgmma kernels), the rotation pre-pass launches they share
            # (inside the dk/dv's ms and bound_ms), and the wgmma
            # kernel's ptxas report
            **({"variants": result[
                    "dq_launches" if name == "flash_bwd_dq" else
                    "dkv_launches"],
                "prepass_launches": result["prepass_launches"]["rope_rows"],
                "ptxas": wgmma_ptxas[name]} if name in wgmma_ptxas else {}),
        })
    log(f"adamw over the phase-3 model ({card}): {adamw['ms']:.3f} ms, plain "
        f"{adamw['plain_ms']:.3f} ms, torch._fused_adamw_ "
        f"{adamw['library_ms']:.3f} ms, bound {adamw['bound_ms']:.3f} ms "
        f"(bytes)")
    kernels.append({
        "name": "adamw", "route": "cuda", "source": ADAMW_SOURCE,
        "replaces": ADAMW_REPLACES, "launches": result["launches"]["adamw"],
        "max_abs_err": adamw["max_abs_err"], "ms": adamw["ms"],
        "plain_ms": adamw["plain_ms"], "bound_ms": adamw["bound_ms"],
        "bound_by": "bytes", "library_ms": adamw["library_ms"],
        "pp_launches": pp_launches(pipeline, "adamw"),
        "serve_launches": serving["offline"]["forward_launches"]["adamw"],
        "fleet_launches": fleet["launches"]["adamw"],
        "moe_launches": moe["train"]["launches"]["adamw"],
    })
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {
        "card": card, **engines["ad"],
        "seen_batch_loss": result["seen_batch_loss"]}}))
    print(json.dumps({"checkpoint_resume": {"card": card, **ckpt}}))
    engines["remat_peak_gb"] = {p: r["peak_memory_gb"]
                                for p, r in engines["remat"].items()}
    print(json.dumps({"engines": engines}))
    print(json.dumps({"offload": offload}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"context_parallel": context_parallel}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"elastic": elastic}))
    print(json.dumps({"serving_fleet": fleet}))
    print(json.dumps({"tp_strategies": tp}))
    print(json.dumps({"shardcheck": shard}))
    print(json.dumps({"cost_model": cost_model}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
