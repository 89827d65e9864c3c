#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one output line each; any failure exits non-zero with no ``ok``
line:

1. device  - the card's name and power limit (nvidia-smi); TF32 off.
2. build   - nvcc builds the kernels from dc_tts_tpu_torch/csrc/.
3. K1      - the decode kernel against its plain PyTorch version at
             base_config width and the main path's shapes (B=20 Harvard
             sentences, N=180, T=210, seeded random weights), the plain
             version replayed on the kernel's own cursors (its
             fused_decode_plain(..., cursors=A.argmax(1))), so every one of
             the T steps is compared from the same cursor state: max|dY|,
             max|dA| <= 2e-5 over all T steps (compared_steps), and at every
             step the kernel's cursor is the replayed plain version's own
             argmax or a tie (its two largest probabilities differ by less
             than 1e-6). The free-running plain version's first flip, if any,
             is printed as information. With the kernel's grid (blocks, the
             blocks of a cluster, the exchange the plan took, grid barriers a
             step, µs a step and a layer-step) and the
             barrier floor: the ms of the decode's grid barriers alone
             (csrc/decode.cu barrier_kernel). Then (line K1-B1) one sentence,
             B=1, at the same gate, with the exchange it took (the flagged
             one), the grid exchange's ms at B=1 beside it, and the exchange
             floor: the ms of a B=1 decode's flagged exchanges alone
             (csrc/decode.cu exchange_kernel); (line K1-grid) the kernel's ms
             over 32, 64 and all blocks, for information; (line K1-B72)
             bench.py's chunk, B=72, and (line K1-win8) a window of 8 keys
             (past the 4 the kernel once took), at the same gate; K1-B72
             also prints its plan (slices resident and staged, the
             products' task shape, the cluster width and blocks) and µs a
             layer-step beside the barrier floor's, checks its clusters
             against clusters of 2 bit for bit, and prints the sha256 of Y
             and A at B=72, 20 and 1 (run it under --package on the parent
             in the same call: equal digests are bitwise equal outputs).
3a. TextEnc - (lines TextEnc-B1, TextEnc-B72) TextEnc at B=1 and B=72,
             N=180: the eager chain (gradients on) against the call
             synthesis makes (gradients off: each block's tail through K5's
             epilogue, one launch a block) within 1e-5 x max(1, max|K|),
             and that call against the Synthesizer's captured graph of it,
             K and V bitwise equal, one capture; device and host ms of a
             call of each (medians of 20, each started on an idle device),
             the graph's device ms by kind (epilogue, products, the rest)
             and its kernels (chiprun_out/textenc_kernels.json), the sha256
             of K and V.
3b. K1-<prec> - K1's reduced-precision bodies (high3, hybrid, default) on
             phase K1's inputs, each against the plain version of the same
             mode replayed on the kernel's cursors, over all T steps:
             max|dY|, max|dA| <= max(2e-5, 2 x the distance between the
             plain version with float32 sums and with float64 sums, both
             replayed on those cursors); at every step the kernel's cursor
             is the plain version's own or a tie below max(1e-6, that gate
             for A) (the split modes round x - bf16(x) to bf16, which a
             float32 ulp can flip; the tied steps are counted). CUDA-event
             ms, plain ms, the bound, the grid, the free run's first flip,
             and for information each mode's distance from the float32
             kernel (max|dY|, first cursor flip, rows flipped).
3c. K1-stamps - K1's stamped twins (ops/decode.py: launched while spans
             record) against the unstamped kernels at base_config, B = 72
             (wide, clusters of 8), 20 (common) and 1 (flag): Y and A bit
             for bit; CUDA-event ms of each, means of 10 launches in turns
             (unstamped, stamped, stamped, unstamped, twice), and the
             stamps' cost in per cent; one stamped launch's phases
             (k1.phase.*: ms a launch, µs a layer-step, the slowest and
             fastest block; the attention's µs a step) and their sum
             against its kernel ms; the unstamped launch's
             k1.attn_split.launches (1 where the plan splits the attention
             rows over the cluster's ranks: B = 72) and the sha256 of its Y
             and A (compare with another package's under --package); then
             ptxas's registers, spill bytes and static shared memory of
             every decode_kernel instantiation (lines K1-ptxas).
4. K2      - the Griffin-Lim kernels against their plain version at the
             production geometry (n_fft 2048, hop 275, win 1102, F=840,
             B=20): n_iter=1 and n_iter=3 waveforms within 1e-5 of the
             plain version run in float64 (the float32 plain version is
             itself further than that from it: the phase normalisation of
             near-zero bins amplifies rounding); n_iter=50 spectral
             convergence on a two-tone probe <= 1.10 x the plain version's
             + 0.01. With the ms of its frame and overlap-add kernels
             (torch.profiler), the frame kernel's grid, the round
             structure's bytes floors (frames of n_fft samples, or of the
             window's span), cuFFT's rfft + irfft of the same frames as a
             yardstick and the output's sha256 (two versions bitwise
             equal or not). Then (line K2-B72) bench.py's chunk, B=72,
             and (line K2-B1) the single cell's, B=1, each with every row
             equal to the B=20 run's, and (line K2-n1056) n_fft 1056 = 32 *
             33, hop 142, win 568, F=61 at the same 1e-5 gate ("skipped"
             under --package for a package that refuses it). Each timed
             line carries the frame kernel's launch: grid, threads a block
             (one item each), resident blocks a SM, registers a thread and
             items a SM a launch ("not reported" by a package that does not
             report them).
5. e2e     - Synthesizer(base_config(), random weights, pcm16=True) on the
             card: synthesize_ids_chunked over the 40 Harvard sentences in
             chunks of 20, with every launch counter set to 0 just before
             and read just after; int16 waveforms of shape (40, 230725);
             then the tiny config on the card against the CPU (Y 2e-5, Z
             1e-4) and the float64 plain vocoder (waveform 1e-4); and
             CUDA-event times of each stage of one chunk, whose output is
             held equal to synthesize_ids' on the same chunk. Every launch
             count is set to 0 before and read after the 40 sentences: K3's
             must stay 0 on this default (dft_pallas2) path, K5 launches
             twice for each of SSRN's 16 blocks a chunk, TextEnc's
             graph (captured in the warm-up) is replayed once a chunk,
             captured never (so K5's TextEnc epilogue, counted only while
             a graph is captured, reads 0), and the copy back's pinned
             staging pair
             (to_host.staging.allocs) and de-emphasis's tables
             (deemphasis.table_uploads), made in the warm-up, are made
             again never. Then (line
             e2e-ssrn) SSRN on that chunk's decoded mels under each
             ssrn_precision of the Synthesizer (highest, high - the
             default - and bf16): CUDA-event ms and Z's max and mean distance
             from highest; high within 1e-4 x max|Z| of it.
5b. e2e-<prec> - the 40 sentences through Synthesizer(base_config(),
             pcm16=True, decode_prec=p) for high3, hybrid and default, counts
             set to 0 just before and read just after: K1 launched twice, in
             that mode only, K2 twice, K3 never; int16 (40, 230725); wall
             and device audio-s/s and CUDA-event ms of each stage of one
             chunk (held equal to synthesize_ids' output).
5c. reference - decode_mode="reference": the TF goldens
             (tests/goldens/tf_reference_tiny.npz) through the port's own
             convert on the card at test_config(ln_eps=1e-12), cursors equal,
             Y rtol 1e-4 / atol 2e-5, Z rtol 1e-4 / atol 5e-5; then
             Synthesizer(base_config(), decode_mode="reference", pcm16=True)
             on one chunk of 20: K1 never launched, K2 once, every output
             finite, int16 (20, 230725), and the decode's CUDA-event ms.
5d. ssrn-block - SSRN in synthesis's "high" mode through kernel K5
             (ops/ssrn_block.py: a prologue and an epilogue launch a block
             around its three bf16 products) against the eager chain of
             blocks.apply_stack on the card (the path every call took
             before K5), at base_config with seeded weights whose biases,
             norm gains and shifts are moved by 0.1 x N(0, 1), Y uniform in
             [0, 1), at B=72 (the bulk cell's chunk) and B=1: Z within
             max(1e-5, 2 x the distance between the eager chain with
             float32 sums and its plain version with float64 sums; K1's
             gate) of the eager chain's, the prologue's halves bitwise
             its plain version's at every block, K5 launched twice a block;
             CUDA-event ms of both paths, host ms a call at B=1,
             torch.profiler's device ms of one call by kind (K5's two
             kernels, the products, the rest) and K5's bytes bound: each
             block's x, the taps' halves, the summed products and y moved
             once, at 3.35 TB/s. The kernels line's K5 row: B=72, its ms
             the two kernels' device ms a call, its plain ms the eager
             chain's kernels other than the products. The sha256 of K5's
             logits (two packages compared bit for bit under --package).
6. K3      - the Griffin-Lim round kernels K3a (inverse rDFT GEMM +
             overlap-add) and K3b (re-frame + forward rDFT GEMM + phase) at
             the production geometry (n_fft 2048, hop 275, win 1102, F=840,
             fp1=896, B=20), in each pass mode (1 and 3): K3a's signal
             within 1e-5 x its max of the plain version; K3b on the plain
             K3a's signal within max 2e-2 and mean 1e-5 of the plain
             version; the whole round within mean 1e-5 of the plain
             version, rows >= F exactly 0, and within max 2e-2 of it on
             every bin whose phase K3a's rounding cannot move by more than
             1e-2 (_k3_conditioned: a 1-ulp difference in K3a's signal can
             flip a bf16 rounding of K3b's operands, which the phase
             normalisation of a near-zero bin amplifies); the other bins,
             and those over 2e-2, are counted, and the distances of both
             rounds to the plain version run with float64 sums printed.
             CUDA-event ms of each kernel and of its plain version, the
             bound, and cuBLAS's time for the round's two GEMMs in bf16 as a
             yardstick (the port never calls it); beside them the tiles the
             kernels run (K3a's N tiles and K3b's k-tiles that meet the
             window's span, of all of them), the operations those tiles
             take against the dense GEMMs' and the function's, and
             torch.profiler's device ms of one call by kernel kind (the
             bf16 prep passes, the GEMMs, the overlap-add). Then the 50-round
             griffin_lim("dft_pallas") on K2's two-tone probe: spectral
             convergence <= 1.10 x the plain dft_mixed schedule's + 0.01 on
             the card, and the loop's ms beside its bound.
7. e2e-dft_pallas - the same 40 sentences through Synthesizer(base_config()
             .replace(stft_method="dft_pallas"), pcm16=True), counts set to
             0 just before and read just after: K1, K3a and K3b launched,
             K2 not; int16 (40, 230725); wall time and audio-s/s. Then for
             each utterance the Griffin-Lim of its Z under dft_pallas within
             1.10 x the default dft_pallas2's spectral convergence + 0.01,
             and the Synthesizer's pcm16 equal to that direct call's.
             CUDA-event times of each stage of one chunk (line
             e2e-dft_pallas-stages), and torch.profiler's device time by
             kernel over that chunk's Griffin-Lim (utils/profiling.trace;
             the Chrome trace goes to chiprun_out/trace_dft_pallas/): the
             kernels' summed time (device busy) beside the host clock.
8. K4      - the HC block's forward and backward kernels against their
             plain versions run in float64, at three full-width shapes of
             the trainer (TextEnc HC(3,9) B=32 T=180 C=512; AudioEnc
             HC(3,27) causal T=210 C=256; SSRN HC(3,1) T=840 C=1024): y and
             all 7 gradients for a seeded cotangent, each within max(2e-5 x
             its max |value|, 2 x the float32 plain version's own
             distance); gradients bitwise equal across two calls. Beside
             the CUDA-event ms: the cuBLAS yardstick (the same products as
             single torch.matmul calls on materialised taps, TF32 off:
             taps @ W forward; that, dh @ W^T and taps^T @ dh backward),
             the bound at the 3xTF32 rate the kernels use (3 x the float32
             operations at 495 TFLOP/s) and at the float32 FMA rate, and
             torch.profiler's device ms of one call by kernel kind: the
             GEMMs, the TF32 split copies and the row kernels.
8b. K4-bf16 - the same with bf16 operands (the TPU kernel's bf16 body,
             taken under compute_dtype="bfloat16"): against the plain
             version with the same bf16 rounding points run in float64, at
             the same gate (2 x the float32 plain bf16 version's distance
             covers the bf16 roundings of dh that float32 rounding flips),
             bitwise-equal gradients, bounds at 989 TFLOP/s. Its cuBLAS
             yardstick: the same three products as single torch.mm calls on
             operands already rounded to bf16, float32 outputs
             (out_dtype=torch.float32), only the products timed; its kinds
             the GEMMs, the bf16 copies of x and W (to_bf16) and the row
             kernels.
9. ct-fwd   - the forward-rDFT prototypes X1-X4 of scripts/ct_kernel_exp.py
             on seeded frames (numpy default_rng(0)), in bf16 and float32:
             X1 full_fwd and X3 fact_fwd (transpose modes swap and stack)
             at F=840, X2 fact_fwd_tiled at F=1024 (tiles of 512), X4
             ablate_fwd at F=840 with tiles of 512 (frames 0..511 covered,
             the rest exactly 0) for each of the script's 8 stage sets. Each
             against its plain version on the card (1e-5 of max|FFT|; 1e-3
             for the factored kernels' bf16 stage C) and, with every stage
             on, against numpy's float64 FFT (2e-6 float32, 5e-3 bf16). Per
             kernel: ms a launch inside a CUDA graph of 50 (the script's "in
             loop"), ms a call from the host, the plain version's graph ms,
             the bound (float32 also at three TF32 passes on the tensor
             cores, bound_3xtf32_ms), and the yardsticks the port never
             calls: cuFFT
             (torch.fft.rfft for X1, torch.fft.fft for the factored ones,
             which give all 2048 bins; for X4 also torch.fft.rfft of its
             covered frames, rfft_ms) and cuBLAS on X1's GEMM (line
             ct-fwd). Then the main path: python -m
             dc_tts_tpu_torch.scripts.ct_kernel_exp's main in this process
             for every variant and precision (iters 5; fact-tiled at
             CT_F=1024) and ablate, every launch count set to 0 just before
             and read just after: X1-X4 launched, nothing else (line
             ct-fwd-main; a CUDA graph's replays are counted apart). Then the
             same 9 runs as subprocesses: exit 0, the printed rel err within
             the float64-FFT gate (line ct-fwd-cli).
10. train-t2m  - a seeded synthetic corpus (64 utterances of 2-9 s at
             22050 Hz, the Harvard sentences as texts) through prepro on
             the card and TrainLoader with two length buckets (one holds
             the full 180x210 grid); 30 Text2Mel steps at base_config()
             (B=32, dropout 0.05, use_pallas=True) through the CLI's step,
             loader and prefetch, counters set to 0 just before and read
             just after: 28 forward and 28 backward K4 launches a step,
             every loss finite, and for each bucket shape the mean loss of
             its last (up to) 5 steps below its first 5 (like with like:
             the two buckets' losses differ by more than 30 steps of
             warm-up learning move them). Then ms/step with use_pallas on
             and off on one full-grid batch (three readings each of
             TIME_STEPS steps, alternated; the peak device memory each
             route allocates over its readings), K4's summed kernel time per
             step (every HC shape of a step replayed), and, on the first
             full-grid batch of the seeded shuffle (its ids, teacher-forced
             mels and zero pads) with fresh seeded parameters at dropout 0,
             use_pallas on against off: the loss equal (rtol 1e-5); every
             gradient within 1e-4 x its max |value| with each ReLU mask and
             L1 sign taken from the float64 run (see _equivalence; the
             distances to float64 with each route's own decisions, and how
             many decisions each switched, are printed beside it); and K4 at
             each of the 28 HC blocks, at the input and output cotangent of
             the float64 run, within phase K4's tolerance.
11. train-ssrn - the same for SSRN: 8 steps, 8 + 8 K4 launches a step, its
             losses finite and printed (at the warm-up learning rate a few
             steps move them less than dropout does, so no descent check),
             the same equivalence with its 8 HC blocks.
11b. train-float32, train-bfloat16, train-bfloat16_full, train-remat -
             both networks, float32 on torch matmuls (no K4), then with
             use_pallas under compute_dtype "bfloat16" (K4's bf16 body:
             28 / 8 bf16 forward and backward launches a step, no float32
             ones), "bfloat16_full" (no K4 launch) and float32 with remat
             (each K4 forward twice, the backward once), 8 Text2Mel and 4
             SSRN steps on full-grid batches, every count set to 0 just
             before and read just after, no other kernel launched, every
             loss finite; ms/step and the losses of those steps on one
             batch; one more step under torch.profiler (device busy ms and
             idle share); K4's bf16 time per step; for remat, one step's loss and
             gradients within 1e-5 x a leaf's max of the step without remat
             (the leaves that are bitwise equal counted).
12. train-cli  - python -m dc_tts_tpu_torch.train 1 and 2 on that corpus
             (--max-steps 4 --ckpt-every 2 --buckets 2) as
             subprocesses: exit 0, model_gs_000k.npz in the JAX package's
             key layout; a restart resumes at step 4 and ends at 6; then
             python -m dc_tts_tpu_torch.synthesize from both logdirs writes
             two wavs; train 1 --dtype bfloat16 --max-steps 2 writes a
             checkpoint and two finite losses, and synthesize
             --random-weights --ssrn-precision bf16 two wavs.
12b. synth-cli - python -m dc_tts_tpu_torch.synthesize --random-weights
             with --decode-precision hybrid, then with --mode reference: each
             exits 0 and writes the 40 wavs.
13. parallel - the parallel modes on torch.distributed. On NCCL, one rank
             (a file store in a temporary directory): Synthesizer(mesh=
             make_mesh(), pcm16=True) over the 40 sentences in chunks of 20,
             bitwise the single card's, K1 and K2 launched twice (line
             parallel-dp-synth); 3 Text2Mel and 3 SSRN data-parallel steps
             on one seeded full-grid batch (B=32, use_pallas), every leaf
             within 1e-6 x its max of the same steps without the group, with
             K4's launches and ms/step beside the plain steps' (lines
             parallel-dp-train-*); synthesize_time_sharded on one shard, 2
             sentences, within 1e-4 x max of the unsharded float32 SSRN and
             "dft" Griffin-Lim, K1 once, K2 never (line parallel-ts1). Then
             two gloo ranks spawned on cuda:0 (one card holds one NCCL rank;
             every exchange goes through the host): the same synthesis over
             two shards, Z within 2e-5 of one shard's and the time-sharded
             vocoder on one shard's Z within 2e-3 of its waveform
             (tests/test_sp_gl.py's gate; the end-to-end waveform distance is
             printed: SSRN's sums on half the frames differ by ~1e-6, which
             Griffin-Lim and de-emphasis amplify) (line parallel-ts2); the
             pipeline 1 + 1 at microbatch 2 on 4 sentences within 2e-3 of
             the single card in chunks of 2, K1 twice on rank 0 and K2 twice
             on rank 1 (line parallel-pipeline); then python -m
             torch.distributed.run --nproc-per-node 1 -m
             dc_tts_tpu_torch.synthesize --mesh writes the 40 wavs (line
             parallel-cli). Every count is set to 0 just before a path and
             read just after; a rank that fails fails the phase. The times
             are for information: two ranks time-slice one card.
13b. parallel-tp - tensor parallelism: two gloo ranks spawned on cuda:0
             over a data 1 x model 2 grid train at base_config() widths
             (B=8: every gather crosses the host), use_pallas, each from
             the same seeded whole parameters and batch: 2 Text2Mel and 2
             SSRN steps in float32 (K4 on the gathered weight) and 1 of
             each under bfloat16 (K4's bf16 body). Rank 0 first runs the
             one-rank steps and records every ReLU mask and L1 sign; both
             ranks replay them (the switched ones counted). Against the
             one-rank run: the loss within 1e-6 relative; float32, the
             step-1 gradients within 1e-5 x each leaf's max and the
             parameters after the steps within 1e-5 x a leaf's max + 0.1 x
             the steps' summed learning rates; bfloat16, the gradients'
             relative L2 within 3e-2 and each leaf within 5e-2 x its max,
             the parameters finite (lines parallel-tp-<net>-<dtype>). K4's
             launches on each rank, counts set to 0 just before the steps
             and read just after, equal the one-rank steps' (28 + 28 a
             Text2Mel step, 8 + 8 an SSRN step). ms/step per rank and of
             one rank, for information (line parallel-tp).
14. the entry points beside the package, each a line:
    bench    - python -m dc_tts_tpu_torch.bench as a subprocess, cut to
             BENCH_SENTENCES=144 BENCH_REPS=3 (chunks of 72): one JSON line
             with bench.py's keys and ``card`` (this card's nvidia-smi
             line), finite positive value, value_device and vs_baseline;
             phase e2e's device audio-s/s beside it for information.
    learn    - tests/test_learning.py's overfit on the card: test_config()
             (warm-up 50), 400 steps a network on its structured batch from
             seeded parameters with use_pallas (K4: every HC block's
             forward and backward each step, no other kernel), its
             calibrated gates (Text2Mel loss_mels < 0.07 and < a third of
             step 1's, loss_att < 0.01, diagonality at step 200 < 0.18 and
             < step 1's / 1.6, loss_mels there < 0.10; SSRN loss_mags < 0.07
             and < a third of step 1's); then scripts/overfit_demo.py's
             evaluate speaks the first row's text through the default
             Synthesizer (K1 "highest" and K2 twice each: the chunked pcm16
             path and synthesize_ids; K4 and K3 never), finite and audible.
             For information (line learn-info): the audio's mel correlation
             and L1 against the row's target (structured mels, not speech),
             the same trained nets on the CPU (max|dY|, max|dZ|, cursors
             equal) and each reduced decode precision's first cursor flip
             and rows flipped against "highest".
    bench-train - scripts/bench_train.py's 14 variants at base_config(), 2
             steps a span: ms/step and MFU in (0, 1); counts set to 0 just
             before a variant and read just after: float32 K4 in the float32
             use_pallas variants only, its bf16 body in the bf16 one, no
             other kernel.
    profile-stages - scripts/profile_stages.py's stage times of the 40
             sentences (CUDA events, best of 2), shares, MFU in (0, 1).
    bench-variants - scripts/bench_variants.py's dft_pallas2 (K2),
             dft_pallas (K3) and fft variants, one timed run each, counts
             set to 0 just before and read just after: K1 twice (warm-up
             and run), K2 under dft_pallas2 only, K3 under dft_pallas only.
    scaling  - torchrun --nproc-per-node 1 -m
             dc_tts_tpu_torch.scripts.scaling_bench (NCCL, one card): the
             size-1 line, batch 8, efficiency 100 %.
15. the kernels line, the nvidia-smi line, and the ``ok`` line.

``python3 chip_smoke.py --only K3,K4-bf16 [--package DIR]`` runs the named
phases alone (after device and build) and prints their results as one JSON
line instead of the kernels and ``ok`` lines; with ``--package`` the
kernels and wrappers come from DIR's dc_tts_tpu_torch (a ``git archive`` of
another commit), so two commits are timed in one call on one card. The
phases read launch counts from ``utils/profiling``'s store (``counts()``,
under its names: ``k1.launches``, ``k1.<prec>.launches``, ...), so DIR
must be a commit that counts its launches there.

Kernel times are CUDA-event means over repeated calls on the same inputs.
``bound_ms`` is the larger of (bytes each input read once + each output
written once) / 3.35 TB/s and (float32 operations) / 67 TFLOP/s, the
H100 SXM's published peaks at 700 W; K3's operations are those its
function needs, over 989 TFLOP/s of dense bf16: passes x 2*(B*F)*
win_length*(2*n_freq) per GEMM (griffin_lim_flops at the F frames that
carry data, times win_length/n_fft: the window is zero outside its
win_length samples of K3a's N and K3b's K; the dense GEMMs the kernels
run are printed beside it). K3a's and K3b's ``ms``, ``plain_ms`` and
``bound_ms`` in the kernels line are single-pass (the schedule's 40
middle rounds of 50), their ``launches`` both pass modes' in
e2e-dft_pallas, K3a's ``max_abs_err`` that of its signal. K2's
operations count each 2048-point transform as a real FFT (2.5 N log2 N):
every frame is real and every spectrum Hermitian; its ``library_ms`` is
the cuFFT yardstick (the transforms alone, 2*n_iter + 1 of the B*F
frames). K4's operations are its tap matmuls, 2*B*T*K*C*2C for
the forward and three times that for the backward (h recomputed, dx, dW);
its row passes (layer norms, gate) add under 1 % at these widths. K4's
``ms``, ``plain_ms`` and ``bound_ms`` in the kernels line are sums over
the three shapes, its ``launches`` the train-t2m and train-ssrn runs'; its
bf16 body's rows (hc_block_fwd_bf16, hc_block_bwd_bf16) the same at the
dense bf16 rate, their ``library_ms`` the bf16 cuBLAS yardstick, their
``launches`` those of train-bfloat16.
X1-X4's operations: X1 2*F*2048*2050 (its GEMM, on the bf16 tensor cores
in bf16 mode); the factored form per frame 2*2*16*16*128 for stage A and
6*16*128 for W (float32 in both modes), 4*2*16*128*128 + 2*16*128 for C
(bf16 tensor cores in bf16 mode), each stage at its own peak; their bytes
the covered frames of x, the constants the stages read and the whole
output. Their ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` in the
kernels line are bf16 (the script's default) graph times: X1 and X3 at
F=840, X2 at F=1024, X4 its every-stage set at F=840 (the other stage sets
and float32 are in line ct-fwd); ``launches`` those of the main path.
K1's reduced bodies (fused_decode[<prec>]) count their layer products'
passes (3 for the split, 1 for "default") at the dense bf16 rate and their
float32 parts (AudioEnc under "hybrid", the attention keys) at the float32
rate, the two summed; their bytes the arrays each mode reads (the
kernel's transposed copies, not the JAX-layout keys). Their ``launches``
are e2e-<prec>'s. K1's bound is far below what its dependent chain of 24
layer products a step, each behind a grid barrier, can reach; the line
gives the barrier floor beside it and does not replace it.
A summary also goes to ``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
PEAK_TF32 = 495e12     # H100 SXM dense TF32 tensor cores, FLOP/s
B_MAIN, CHUNK = 20, 20
# the training and parallel phases' device and batch, and the device of the
# parallel phase's two gloo ranks, both on the one card (a rehearsal on the
# CPU sets them)
DEV, B_TRAIN, RANKS_DEV = "cuda", 32, "cuda:0"
# steps per ms/step reading; a training gradient's gate against the other
# route, each leaf over its max |value|, with ReLU masks and L1 signs frozen
TIME_STEPS, EQUIV_GRAD_TOL = 10, 1e-4
# the forward-rDFT prototypes' wrappers (X1, X2, X3, X4), the TPU kernels
# they replace, and their CLI's variants
CT_KERNELS = ("full_fwd", "fact_fwd_tiled", "fact_fwd", "ablate_fwd")
# their launch counters (utils/profiling), in CT_KERNELS' order
CT_LAUNCHES = ("x1.launches", "x2.launches", "x3.launches", "x4.launches")
CT_REPLACES = dict(zip(CT_KERNELS, ("scripts/ct_kernel_exp.py:82",
                                    "scripts/ct_kernel_exp.py:131",
                                    "scripts/ct_kernel_exp.py:151",
                                    "scripts/ct_kernel_exp.py:284")))


# K4's launch counters: in all (float32 and bf16 operands), then the bf16
# body's alone
K4_LAUNCHES = ("k4.fwd.launches", "k4.bwd.launches", "k4.fwd.bf16.launches",
               "k4.bwd.bf16.launches")


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (after one warm-up
    call)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_flops: float, peak: float = PEAK_FP32):
    tb, tf = n_bytes / PEAK_BYTES * 1e3, n_flops / peak * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def harvard_ids(cfg, n):
    from dc_tts_tpu_torch import text
    sents = text.load_test_sentences(os.path.join(HERE,
                                                  "harvard_sentences.txt"))
    return text.encode_batch((sents * (-(-n // len(sents))))[:n], cfg)


# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    from dc_tts_tpu_torch.device import fp32_numerics
    fp32_numerics()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    line("device", name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), nvidia_smi=repr(smi),
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi.splitlines()[0]


def phase_build():
    from dc_tts_tpu_torch.ops import _build
    secs = _build.timed_build()
    log = _build.library_path() + ".log"
    report = []
    if os.path.exists(log):
        with open(log) as f:
            report = [ln.strip() for ln in f
                      if "registers" in ln or "spill" in ln]
    line("build", seconds=f"{secs:.1f}", library=os.path.basename(
        _build.library_path()))
    for ln in report:
        print("    ptxas " + ln, flush=True)


def _first_flip(A_k, A_p):
    """(step, row, margin) of the first cursor flip, or None. margin: the
    gap between the two largest probabilities of the plain version's row
    at that step."""
    ck, cp = A_k.argmax(1), A_p.argmax(1)          # (B, T)
    diff = ck != cp
    if not bool(diff.any()):
        return None
    t = int(diff.any(0).nonzero()[0])
    b = int(diff[:, t].nonzero()[0])
    top = A_p[b, :, t].topk(2).values
    return t, b, float(top[0] - top[1])


def _k1_plan(cfg, B, prec):
    """The decode kernel's plan at batch B on this card, as its launch takes
    it (a package from before the plan's cluster width: ``decode_plan``
    over ``decode_blocks``)."""
    from dc_tts_tpu_torch.ops import decode as K1
    dev = torch.device("cuda", 0)
    if hasattr(K1, "launch_plan"):
        return K1.launch_plan(cfg, B, prec, dev)
    return K1.decode_plan(cfg, B, K1.decode_blocks(dev), prec)


def _k1_grid(cfg, B, prec, ms, T):
    """The decode kernel's grid in this run: blocks (one per SM), the
    blocks of a cluster, the exchange the plan takes, grid barriers a step,
    and µs a step and a layer-step from the kernel's ``ms``."""
    plan = _k1_plan(cfg, B, prec)
    return dict(blocks=plan.blocks, cluster=getattr(plan, "cluster", 2),
                exchange=plan.exchange,
                barriers_per_step=plan.barriers_per_step,
                us_per_step=f"{ms * 1e3 / T:.2f}",
                us_per_layer_step=f"{ms * 1e3 / (T * len(plan.nmax)):.2f}")


def _digest(*ts):
    """sha256 of the tensors' bytes, 16 hex digits: two packages' Y and A
    compared bit for bit across runs (``--package``)."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _exchange_floor_ms(n, blocks, C):
    """ms of ``n`` flagged exchanges of an HC layer's pre-norm row (2 x C
    words) over ``blocks`` blocks alone, as the decode kernel runs them at
    B = 1 (csrc/decode.cu ``exchange_kernel``): the floor that the flagged
    exchange sets."""
    from dc_tts_tpu_torch.ops._build import check, load_library
    lib = load_library()
    words = torch.zeros(8 * C, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        words.zero_()
        check(lib.dctts_decode_exchanges(words.data_ptr(), n, C, blocks,
                                         stream), "exchange probe")

    return cuda_ms(run, 3)


def _barrier_floor_ms(n, blocks):
    """ms of ``n`` grid barriers over ``blocks`` blocks alone, as the decode
    kernel runs them (csrc/decode.cu ``barrier_kernel``): the floor that
    the decode's barriers set."""
    from dc_tts_tpu_torch.ops._build import check, load_library
    lib = load_library()
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        bar.zero_()
        check(lib.dctts_decode_barriers(bar.data_ptr(), n, blocks, stream),
              "barrier probe")

    return cuda_ms(run, 3)


def _k1_replay(packed, Kt, V, T, cfg, prec, A, sum_dtype=torch.float32):
    """The plain version of ``prec`` on the kernel's own cursors
    (``A.argmax(1)``): every step starts from the kernel's cursor state."""
    from dc_tts_tpu_torch.ops import decode as K1
    return K1.fused_decode_plain(packed, Kt, V, T, cfg, prec, sum_dtype,
                                 cursors=A.argmax(1))


def _k1_check(name, A, Ar, Y, Yr, free_flip, tie):
    """(max|dY|, max|dA|, note) of a decode kernel against its plain version
    replayed on the kernel's cursors (``_k1_replay``), over all T steps.
    At every step the kernel's cursor must be the replayed plain version's
    own argmax, or a tie: the two largest probabilities of the plain row
    differ by less than ``tie``. ``free_flip``: the first cursor flip of
    the free-running plain version, reported as information."""
    ck, cr = A.argmax(1), Ar.argmax(1)                 # (B, T)
    bs, ts = (ck != cr).nonzero(as_tuple=True)
    ties = [(int(t), int(b), float(Ar[b, :, t].topk(2).values.diff().abs()))
            for b, t in zip(bs.tolist(), ts.tolist())]
    worst = max((m for _, _, m in ties), default=0.0)
    if worst >= tie:
        t, b, m = max(ties, key=lambda x: x[2])
        raise AssertionError(f"{name}: cursor at step {t} row {b} differs "
                             f"from the plain version's with margin {m:.3e}"
                             f" >= {tie:.3e}: a bug")
    note = (f"{len(ties)} tied cursor steps (margins < {worst:.2e})"
            if ties else "every cursor the plain version's own")
    if free_flip is not None:
        note += (f"; free run flips at step {free_flip[0]} row "
                 f"{free_flip[1]} (margin {free_flip[2]:.2e})")
    dY = float((Y - Yr).abs().max())
    dA = float((A - Ar).abs().max())
    return dY, dA, note


def phase_k1(results):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import Text2Mel
    from dc_tts_tpu_torch.ops import decode as K1
    from dc_tts_tpu_torch.utils import profiling

    cfg = base_config()
    dev = torch.device("cuda")
    model = Text2Mel(cfg)
    params = model.init(torch.Generator().manual_seed(1), dev)
    ids = torch.as_tensor(harvard_ids(cfg, B_MAIN), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        packed = K1.pack_decode_params(cfg, params)
        T = cfg.max_T
        Y, A = K1.fused_decode(packed, Kt, V, T, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Yp, Ap = K1.fused_decode_plain(packed, Kt, V, T, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        Yr, Ar = _k1_replay(packed, Kt, V, T, cfg, "highest", A)
        ms = cuda_ms(lambda: K1.fused_decode(packed, Kt, V, T, cfg), 3)
    dY, dA, note = _k1_check("K1", A, Ar, Y, Yr, _first_flip(A, Ap), 1e-6)
    ok = dY <= 2e-5 and dA <= 2e-5 and bool(torch.isfinite(Y).all())
    digests = {B_MAIN: _digest(Y, A)}
    # operations: the layer matmuls per row per step plus the unmasked
    # attention keys (scores + context) the cursors of this run select
    enc, dec = K1._programs(cfg)
    mac_layers = sum(l.cin * l.cout if l.kind == "C" else 6 * l.cout ** 2
                     for l in enc + dec)
    prev = torch.cat([torch.zeros(B_MAIN, 1, dtype=torch.long, device=dev),
                      A.argmax(1)[:, :-1]], dim=1)
    keys = int(torch.clamp(cfg.max_N - prev, max=cfg.attention_win_size
                           ).sum())
    flops = 2.0 * (mac_layers * B_MAIN * T + keys * 2 * cfg.d)
    # what the kernel reads: the transposed copies and the norms' arrays
    reads = [v for k, v in packed.items() if k not in ("cw", "hcw")]
    b_ms, b_by = bound(nbytes(Kt, V, *reads, Y, A), flops)
    grid = _k1_grid(cfg, B_MAIN, "highest", ms, T)
    floor = _barrier_floor_ms(grid["barriers_per_step"] * T, grid["blocks"])
    line("K1", ok=ok, B=B_MAIN, N=cfg.max_N, T=T, max_dY=f"{dY:.3e}",
         max_dA=f"{dA:.3e}", tol="2e-5", compared_steps=T, note=repr(note),
         ms=f"{ms:.3f}",
         plain_ms=f"{plain_ms:.1f}", bound_ms=f"{b_ms:.4f}",
         bound_by=b_by, gflop=f"{flops / 1e9:.2f}", **grid,
         barrier_floor_ms=f"{floor:.3f}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"dY={dY} dA={dA}")
    results["K1"] = dict(max_abs_err=max(dY, dA), ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         barrier_floor_ms=floor, **grid)
    # one sentence, B = 1 (the interactive request): the plan's exchange at
    # the same gate, the grid exchange's ms beside it, and the floor of the
    # flagged exchanges alone
    ids = torch.as_tensor(harvard_ids(cfg, 1), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        before = profiling.counts()
        Y, A = K1.fused_decode(packed, Kt, V, T, cfg)
        torch.cuda.synchronize()
        n = profiling.counts() - before
        took = [x for x in K1.EXCHANGES if n[f"k1.{x}.launches"]]
        Yp, Ap = K1.fused_decode_plain(packed, Kt, V, T, cfg)
        Yr, Ar = _k1_replay(packed, Kt, V, T, cfg, "highest", A)
        ms1 = cuda_ms(lambda: K1.fused_decode(packed, Kt, V, T, cfg), 3)
        Yg, Ag = K1.launch_decode(packed, Kt, V, T, cfg, exchange="grid")
        ms1_grid = cuda_ms(lambda: K1.launch_decode(packed, Kt, V, T, cfg,
                                                    exchange="grid"), 3)
    dY, dA, note = _k1_check("K1-B1", A, Ar, Y, Yr, _first_flip(A, Ap), 1e-6)
    same = bool(torch.equal(Y, Yg) and torch.equal(A, Ag))
    digests[1] = _digest(Y, A)
    grid1 = _k1_grid(cfg, 1, "highest", ms1, T)
    ok = (dY <= 2e-5 and dA <= 2e-5 and bool(torch.isfinite(Y).all())
          and took == [grid1["exchange"]] and same)
    xfloor = _exchange_floor_ms(len(enc + dec) * T, grid1["blocks"], cfg.d)
    line("K1-B1", ok=ok, B=1, T=T, max_dY=f"{dY:.3e}", max_dA=f"{dA:.3e}",
         tol="2e-5", compared_steps=T, note=repr(note), ms=f"{ms1:.3f}",
         took=",".join(took), grid_exchange_ms=f"{ms1_grid:.3f}",
         bitwise_grid_exchange=same, exchange_floor_ms=f"{xfloor:.3f}",
         **grid1)
    if not ok:
        raise AssertionError(f"K1 at B=1 disagrees with its plain version or"
                             f" its grid exchange: dY={dY} dA={dA} took="
                             f"{took} bitwise={same}")
    results["K1_B1"] = dict(max_abs_err=max(dY, dA), ms=ms1,
                            grid_exchange_ms=ms1_grid, exchange=took[0],
                            exchange_floor_ms=xfloor)
    ids = torch.as_tensor(harvard_ids(cfg, B_MAIN), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
    # the grid sizes, for information (B_MAIN, the kernel's own time only)
    sweep = {g: cuda_ms(lambda: K1.launch_decode(packed, Kt, V, T, cfg,
                                                 blocks=g), 3)
             for g in (32, 64, grid["blocks"])}
    floors = {g: _barrier_floor_ms(grid["barriers_per_step"] * T, g)
              for g in (32, 64)}
    line("K1-grid", B=B_MAIN,
         **{f"ms_{g}_blocks": f"{m:.3f}" for g, m in sweep.items()},
         **{f"barrier_floor_ms_{g}_blocks": f"{m:.3f}"
            for g, m in floors.items()})
    results["K1_grid"] = sweep
    # bench.py's chunk: B = 72, same gate; its plan's cluster width against
    # clusters of CLUSTER, bit for bit (a package without the width: n/a)
    ids = torch.as_tensor(harvard_ids(cfg, 72), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        Y, A = K1.fused_decode(packed, Kt, V, T, cfg)
        Yp, Ap = K1.fused_decode_plain(packed, Kt, V, T, cfg)
        Yr, Ar = _k1_replay(packed, Kt, V, T, cfg, "highest", A)
        ms72 = cuda_ms(lambda: K1.fused_decode(packed, Kt, V, T, cfg), 3)
        narrow = "n/a"
        if hasattr(K1, "launch_plan"):
            Yn, An = K1.launch_decode(packed, Kt, V, T, cfg,
                                      cluster=K1.CLUSTER)
            narrow = bool(torch.equal(Y, Yn) and torch.equal(A, An))
    dY, dA, note = _k1_check("K1-B72", A, Ar, Y, Yr, _first_flip(A, Ap),
                             1e-6)
    digests[72] = _digest(Y, A)
    ok = (dY <= 2e-5 and dA <= 2e-5 and bool(torch.isfinite(Y).all())
          and narrow is not False)
    # the plan at B = 72: slices resident and staged, the products' task
    # shape (rows x virtual columns), and µs a layer-step beside the
    # barrier floor's (5040 grid barriers alone over its blocks); the
    # digests of Y and A at B = 72, 20 and 1, to compare with another
    # package's run
    plan72 = _k1_plan(cfg, 72, "highest")
    staged = sum(plan72.staged)
    layer_steps = T * len(enc + dec)
    floor72 = (floor if plan72.blocks == grid["blocks"] else
               _barrier_floor_ms(layer_steps, plan72.blocks))
    line("K1-B72", ok=ok, B=72, T=T, max_dY=f"{dY:.3e}", max_dA=f"{dA:.3e}",
         tol="2e-5", compared_steps=T, note=repr(note), ms=f"{ms72:.3f}",
         **_k1_grid(cfg, 72, "highest", ms72, T),
         resident_layers=sum(o >= 0 for o in plan72.woff) - staged,
         staged_layers=staged,
         task_shape=",".join(sorted({f"{r}x{K1.task_columns('f32')}"
                                     for r in plan72.task_rows})),
         barrier_floor_us_per_layer=f"{floor72 * 1e3 / layer_steps:.2f}",
         bitwise_cluster2=narrow,
         yA_sha256=",".join(f"B{b}:{digests[b]}" for b in (72, B_MAIN, 1)))
    if not ok:
        raise AssertionError(f"K1 at B=72 disagrees with its plain version "
                             f"or its clusters of 2: dY={dY} dA={dA} "
                             f"bitwise={narrow}")
    results["K1_B72"] = dict(max_abs_err=max(dY, dA), ms=ms72,
                             staged_layers=staged,
                             task_rows=sorted(set(plan72.task_rows)),
                             cluster=getattr(plan72, "cluster", 2),
                             blocks=plan72.blocks, yA_sha256=digests)
    # past one of the kernel's old limits at full width: a window of 8 keys
    # (it took 4), one register chunk of the attention's walk, same gate
    cfg8 = cfg.replace(attention_win_size=8)
    ids = torch.as_tensor(harvard_ids(cfg, B_MAIN), device=dev)
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        Y, A = K1.fused_decode(packed, Kt, V, T, cfg8)
        Yp, Ap = K1.fused_decode_plain(packed, Kt, V, T, cfg8)
        Yr, Ar = _k1_replay(packed, Kt, V, T, cfg8, "highest", A)
        ms8 = cuda_ms(lambda: K1.fused_decode(packed, Kt, V, T, cfg8), 3)
    dY, dA, note = _k1_check("K1-win8", A, Ar, Y, Yr, _first_flip(A, Ap),
                             1e-6)
    ok = dY <= 2e-5 and dA <= 2e-5 and bool(torch.isfinite(Y).all())
    keys = int((A > 0).sum(1).max())
    line("K1-win8", ok=ok, B=B_MAIN, T=T, win=8, most_keys_a_row=keys,
         max_dY=f"{dY:.3e}", max_dA=f"{dA:.3e}", tol="2e-5",
         compared_steps=T, note=repr(note), ms=f"{ms8:.3f}")
    if not ok:
        raise AssertionError(f"K1 at win=8 disagrees with its plain version:"
                             f" dY={dY} dA={dA}")
    results["K1_win8"] = dict(max_abs_err=max(dY, dA), ms=ms8)


def _call_ms(fn, reps: int = 20):
    """Medians over ``reps`` calls of fn(), each started on an idle device:
    (device ms between CUDA events around the call, host ms from the call's
    start until it returns)."""
    dev_ms, host_ms = [], []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b.record()
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b))
    return float(np.median(dev_ms)), float(np.median(host_ms))


# TextEnc's kernels by kind: K5's epilogue (the tails, where the package
# routes them), the float32 products, the rest (the eager tails, the taps'
# pad and concatenation, the embedding, K and V's copies)
TEXTENC_KINDS = {"epilogue": ("ssrn_epilogue",),
                 "products": ("gemm", "nvjet", "xmma", "cutlass", "splitK"),
                 "other": ("",)}
# replays of TextEnc's graph in one profiled window: its GEMMs' time moved
# by ~10 % from one replay to the next on the H100
REPLAYS = 5


def phase_textenc(results):
    """TextEnc at B = 1 and B = 72, N = max_N, base_config with seeded
    weights moved by 0.1 x N(0, 1) (biases and norm shifts away from 0):
    the eager chain (``Text2Mel.text_encode`` with gradients on, which no
    package routes) against the call synthesis makes (gradients off: each
    block's tail through K5's epilogue where the package has the route) and
    against its captured graph (``pipeline.text_encode_graphs``, the
    Synthesizer's on the card). The graph's K and V bitwise the routed
    call's, one capture; the routed call's within 1e-5 x max(1, max|K|)
    of the eager chain's, launching the epilogue once a block
    (``k5.textenc.launches``, 0 for a package without the route). Device
    and host ms of a call (``_call_ms``), torch.profiler's device ms of a
    replay (the mean of ``REPLAYS``) by kind (``TEXTENC_KINDS``) and by
    kernel (to ``chiprun_out/textenc_kernels.json``), and the sha256 of K
    and V (two packages' graphs compared bit for bit under
    ``--package``)."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import Text2Mel
    from dc_tts_tpu_torch.models import text2mel as t2m_mod
    from dc_tts_tpu_torch.pipeline import text_encode_graphs
    from dc_tts_tpu_torch.train.optimizer import tree_map
    from dc_tts_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    cfg = base_config()
    dev = torch.device("cuda")
    model = Text2Mel(cfg)
    gen = torch.Generator().manual_seed(1)
    params = tree_map(lambda t: (t + 0.1 * torch.randn(
        t.shape, generator=gen)).to(dev), model.init(gen))
    routes = hasattr(t2m_mod, "takes_k5")
    n_blocks = len(t2m_mod.text_enc_specs(cfg))
    listing = {}
    for B in (1, 72):
        graphs = text_encode_graphs(model, params)
        ids = torch.as_tensor(harvard_ids(cfg, B), device=dev)

        def chain():
            with torch.enable_grad():
                return model.text_encode(params, ids)

        def routed():
            with torch.no_grad():
                return model.text_encode(params, ids)

        Kc, Vc = chain()
        c0 = profiling.counts()
        Kr, Vr = routed()
        torch.cuda.synchronize()
        launches = (profiling.counts() - c0)["k5.textenc.launches"]
        c0 = profiling.counts()
        K, V = graphs(ids)
        captures = (profiling.counts() - c0)["textenc.graph.captures"]
        same = bool(torch.equal(K, Kr) and torch.equal(V, Vr))
        dK = float((Kr - Kc).abs().max())
        dV = float((Vr - Vc).abs().max())
        gate = 1e-5 * max(1.0, float(Kc.abs().max()), float(Vc.abs().max()))
        digest = _digest(K, V)
        eager = _call_ms(chain)
        direct = _call_ms(routed)
        graph = _call_ms(lambda: graphs(ids))
        graphs(ids)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPLAYS):
                graphs(ids)
            torch.cuda.synchronize()
        busy, by_name = device_busy(prof, None)
        busy /= REPLAYS
        listing[B] = {k: [round(t / REPLAYS, 4), n // REPLAYS] for k, (t, n)
                      in sorted(by_name.items(), key=lambda kv: -kv[1][0])}
        kinds = dict.fromkeys(TEXTENC_KINDS, 0.0)
        for name, (t, _) in listing[B].items():
            kinds[next(k for k, keys in TEXTENC_KINDS.items()
                       if any(key in name for key in keys))] += t
        ok = (same and captures == 1 and max(dK, dV) <= gate
              and launches == (n_blocks if routes else 0))
        line(f"TextEnc-B{B}", ok=ok, B=B, N=cfg.max_N, routes=routes,
             k5_textenc_launches=launches, max_dK=f"{dK:.3e}",
             max_dV=f"{dV:.3e}", gate=f"{gate:.3e}", graph_bitwise=same,
             captures=captures,
             eager_device_ms=f"{eager[0]:.3f}",
             eager_host_ms=f"{eager[1]:.3f}",
             routed_device_ms=f"{direct[0]:.3f}",
             routed_host_ms=f"{direct[1]:.3f}",
             graph_device_ms=f"{graph[0]:.3f}",
             graph_host_ms=f"{graph[1]:.3f}",
             graph_kinds_ms=json.dumps({
                 k: round(v, 3) for k, v in kinds.items()}).replace(" ", ""),
             graph_kernels=sum(n for _, n in listing[B].values()),
             graph_kernel_ms=f"{busy:.3f}", KV_sha256=digest)
        if not ok:
            raise AssertionError(
                f"TextEnc at B={B}: graph bitwise={same} captures={captures}"
                f" max|dK|={dK:.3e} max|dV|={dV:.3e} gate={gate:.3e} "
                f"launches={launches}")
        results[f"TextEnc_B{B}"] = dict(
            eager_ms=eager, routed_ms=direct, graph_ms=graph, kinds=kinds,
            max_dK=dK, max_dV=dV, launches=launches, digest=digest)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tag = "textenc_kernels" + ("" if routes else "_unrouted")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(listing, f, indent=1)


def _k1_bound(cfg, prec, B, T, A, tensors):
    """(ms, by, GFLOP bf16, GFLOP float32) of the decode in ``prec``: the
    layer products' passes (3 split, 1 for "default") at the dense bf16
    rate, the float32 products ("highest", AudioEnc under "hybrid") and the
    unmasked attention keys this run's cursors select at the float32 rate,
    the two summed; against each input read once and Y, A written once."""
    from dc_tts_tpu_torch.ops import decode as K1
    enc, dec = K1._programs(cfg)
    f_bf16 = f_fp32 = 0.0
    for is_dec, l in [(False, l) for l in enc] + [(True, l) for l in dec]:
        macs = l.cin * l.cout if l.kind == "C" else 6 * l.cout ** 2
        f = 2.0 * macs * B * T
        if prec == "highest" or (prec == "hybrid" and not is_dec):
            f_fp32 += f
        else:
            f_bf16 += f * (1 if prec == "default" else 3)
    prev = torch.cat([torch.zeros(B, 1, dtype=torch.long, device=A.device),
                      A.argmax(1)[:, :-1]], dim=1)
    keys = int(torch.clamp(cfg.max_N - prev, max=cfg.attention_win_size
                           ).sum())
    f_fp32 += 2.0 * keys * 2 * cfg.d
    t_ops = (f_bf16 / PEAK_BF16 + f_fp32 / PEAK_FP32) * 1e3
    t_bytes = nbytes(*tensors) / PEAK_BYTES * 1e3
    by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return (*by, f_bf16 / 1e9, f_fp32 / 1e9)


def phase_k1_prec(results):
    """K1's reduced-precision bodies against the plain version of the same
    mode, on phase K1's inputs."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import Text2Mel
    from dc_tts_tpu_torch.ops import decode as K1

    cfg = base_config()
    dev = torch.device("cuda")
    model = Text2Mel(cfg)
    params = model.init(torch.Generator().manual_seed(1), dev)
    ids = torch.as_tensor(harvard_ids(cfg, B_MAIN), device=dev)
    T = cfg.max_T
    with torch.no_grad():
        Kt, V = (x.contiguous() for x in model.text_encode(params, ids))
        Y_hi, A_hi = K1.fused_decode(K1.pack_decode_params(cfg, params), Kt,
                                     V, T, cfg)
        for prec in ("high3", "hybrid", "default"):
            packed = K1.pack_decode_params(cfg, params, prec)
            Y, A = K1.fused_decode(packed, Kt, V, T, cfg, prec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Yp, Ap = K1.fused_decode_plain(packed, Kt, V, T, cfg, prec)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            Yr, Ar = _k1_replay(packed, Kt, V, T, cfg, prec, A)
            Y64, A64 = _k1_replay(packed, Kt, V, T, cfg, prec, A,
                                  torch.float64)
            ms = cuda_ms(lambda: K1.fused_decode(packed, Kt, V, T, cfg, prec),
                         3)
            # the float32 plain version against float64 on the same
            # cursors: how far float32 rounding moves this mode (it flips
            # bf16 roundings of the activations), over all T steps
            dY64 = float((Y64 - Yr.double()).abs().max())
            dA64 = float((A64 - Ar.double()).abs().max())
            gate_y, gate_a = max(2e-5, 2 * dY64), max(2e-5, 2 * dA64)
            tie = max(1e-6, gate_a)
            flip = _first_flip(A, Ap)
            dY, dA, note = _k1_check(f"K1[{prec}]", A, Ar, Y, Yr, flip, tie)
            ok = (dY <= gate_y and dA <= gate_a
                  and bool(torch.isfinite(Y).all()))
            # what the kernel reads: the transposed copies (under "hybrid"
            # AudioEnc's float32 slices only) and the norms' arrays
            kern = {k: v for k, v in packed.items() if k.endswith("_t")
                    or k in ("cb", "cln", "hcb", "hcln")}
            if prec == "hybrid":
                nc, nhc = K1._enc_counts(cfg)
                kern.update(cw_t=packed["cw_t"][:nc],
                            hcw_t=packed["hcw_t"][:nhc])
            reads = list(kern.values())
            b_ms, b_by, g_bf16, g_fp32 = _k1_bound(cfg, prec, B_MAIN, T, A,
                                                   [Kt, V, *reads, Y, A])
            # for information: this mode's kernel against the float32 one
            fh = _first_flip(A, A_hi)
            rows = int((A.argmax(1) != A_hi.argmax(1)).any(1).sum())
            line(f"K1-{prec}", ok=ok, B=B_MAIN, N=cfg.max_N, T=T,
                 max_dY=f"{dY:.3e}", max_dA=f"{dA:.3e}",
                 gate_Y=f"{gate_y:.3e}", gate_A=f"{gate_a:.3e}",
                 plain_f32_vs_f64_dY=f"{dY64:.3e}",
                 plain_f32_vs_f64_dA=f"{dA64:.3e}", compared_steps=T,
                 tie=f"{tie:.3e}", note=repr(note),
                 kernel_flip=None if flip is None else
                 f"step{flip[0]}/row{flip[1]}/margin{flip[2]:.2e}",
                 ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.1f}",
                 bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                 gflop_bf16=f"{g_bf16:.2f}", gflop_fp32=f"{g_fp32:.2f}",
                 **_k1_grid(cfg, B_MAIN, prec, ms, T),
                 vs_highest_max_dY=f"{float((Y - Y_hi).abs().max()):.3e}",
                 vs_highest_first_flip_step=None if fh is None else fh[0],
                 vs_highest_rows_flipped=rows)
            if not ok:
                raise AssertionError(f"K1[{prec}] disagrees with its plain "
                                     f"version: dY={dY} dA={dA} (gates "
                                     f"{gate_y}, {gate_a})")
            results[f"K1_{prec}"] = dict(
                max_abs_err=max(dY, dA), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def _queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream, every launch
    enqueued while the stream sleeps (after one warm-up call), so that no
    host preparation shows in the events' time."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))          # ~0.2 s of the SM clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_k1_stamps(results, reps=10, rounds=2):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import Text2Mel
    from dc_tts_tpu_torch.ops import _build
    from dc_tts_tpu_torch.ops import decode as K1
    from dc_tts_tpu_torch.utils import profiling

    cfg = base_config()
    dev = torch.device("cuda")
    model = Text2Mel(cfg)
    params = model.init(torch.Generator().manual_seed(1), dev)
    packed = K1.pack_decode_params(cfg, params)
    T = cfg.max_T
    out = {}
    for B in (72, 20, 1):
        ids = torch.as_tensor(harvard_ids(cfg, B), device=dev)
        with torch.no_grad():
            Kt, V = (x.contiguous() for x in model.text_encode(params, ids))

        def plain():
            return K1.launch_decode(packed, Kt, V, T, cfg)

        def stamped():
            with profiling.collect():
                return plain()
        c0 = profiling.counts()
        Y, A = plain()
        split = (profiling.counts() - c0)["k1.attn_split.launches"]
        Ys, As = stamped()
        bitwise = bool(torch.equal(Y, Ys) and torch.equal(A, As))
        ms = {plain: [], stamped: []}
        for order in ((plain, stamped), (stamped, plain)) * rounds:
            for fn in order:
                ms[fn].append(_queued_ms(fn, reps))
        p_ms, s_ms = np.mean(ms[plain]), np.mean(ms[stamped])
        profiling.reset()
        one = _queued_ms(stamped, 1)    # the phases: of it and its warm-up
        s = profiling.summary()
        profiling.reset()
        plan = K1.launch_plan(cfg, B, "highest", dev)
        layer_steps = T * len(plan.nmax)
        ph = {k: s[f"k1.phase.{k}"] for k in K1.PHASES}
        total = sum(e["device_ms"] / e["count"] for e in ph.values())
        out[B] = dict(
            kernel=K1.kernel_name(cfg, plan), bitwise=bitwise,
            plain_ms=p_ms, stamped_ms=s_ms, cost_pct=100 * (s_ms / p_ms - 1),
            phases_ms={k: e["device_ms"] / e["count"] for k, e in ph.items()},
            phases_max_ms={k: e["device_ms_max"] / e["count"]
                           for k, e in ph.items()},
            phases_min_ms={k: e["device_ms_min"] / e["count"]
                           for k, e in ph.items()},
            phases_sum_ms=total, launch_ms=one, attn_split_launches=split,
            yA_sha256=_digest(Y, A))
        att_ms = out[B]["phases_ms"]["attention"]
        line(f"K1-stamps-B{B}", kernel=out[B]["kernel"], bitwise=bitwise,
             blocks=plan.blocks, cluster=plan.cluster,
             attn_split_launches=split,
             attention_us_per_step=f"{att_ms * 1e3 / T:.2f}",
             yA_sha256=out[B]["yA_sha256"],
             plain_ms=",".join(f"{v:.3f}" for v in ms[plain]),
             stamped_ms=",".join(f"{v:.3f}" for v in ms[stamped]),
             cost_pct=f"{out[B]['cost_pct']:.2f}",
             launch_ms=f"{one:.3f}", phases_sum_ms=f"{total:.3f}",
             **{f"{k}_ms": f"{v:.3f}" for k, v in
                out[B]["phases_ms"].items()},
             **{f"{k}_us_per_layer_step": f"{v * 1e3 / layer_steps:.3f}"
                for k, v in out[B]["phases_ms"].items()},
             **{f"{k}_max_min_ms": f"{out[B]['phases_max_ms'][k]:.3f}/"
                f"{out[B]['phases_min_ms'][k]:.3f}" for k in K1.PHASES})
        if not bitwise:
            raise AssertionError(f"K1's stamped twin at B={B} differs from "
                                 "the unstamped kernel")
    for f, v in sorted(_build.ptxas_report().items()):
        label = K1.instance_label(f)
        if label:
            line("K1-ptxas", kernel=repr(label), **v)
            out.setdefault("ptxas", {})[label] = v
    results["K1_stamps"] = out


def _k2_gate(K2, n_fft, hop, win, F, B, dev, seed=2):
    """Max |kernel - float64 plain version| over n_iter 1 and 3 on a seeded
    magnitude, with the float32 plain version's distances beside it: the
    phase normalisation of near-zero bins amplifies rounding, and the
    float32 plain version (torch.fft) is itself ~3e-5 from the float64 one
    at n_fft 2048, so the kernel is held to 1e-5 from the float64 result;
    three rounds catch a round dropped or state carried wrongly from one
    round to the next."""
    g = K2.gl2_geometry(n_fft, hop, win, F)
    consts = {k: torch.as_tensor(v, device=dev)
              for k, v in K2.gl2_consts(n_fft, hop, win, F).items()}
    gen = torch.Generator().manual_seed(seed)
    mag = torch.rand(B, F, n_fft // 2 + 1, generator=gen).to(dev) + 0.05
    scr = K2.scramble_mag(mag, g)
    errs = {}
    for it in (1, 3):
        yk = K2.gl2_run(scr, consts, g, it)
        y64 = K2.gl2_run_plain(scr.double(), consts, g, it)
        yp = K2.gl2_run_plain(scr, consts, g, it)
        errs[it] = (float((yk.double() - y64).abs().max()),
                    float((yp.double() - y64).abs().max()),
                    float((yk - yp).abs().max()))
        del yk, y64, yp
    return max(errs[1][0], errs[3][0]), {
        f"iter{it}_{k}": f"{e[i]:.3e}" for it, e in errs.items()
        for i, k in enumerate(("kernel_vs_plain_f64", "plain_f32_vs_f64",
                               "kernel_vs_plain_f32"))}


def phase_k2(results):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.dsp.stft import stft
    from dc_tts_tpu_torch.ops import gl2 as K2

    cfg = base_config()
    dev = torch.device("cuda")
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    F = cfg.max_T_full
    g = K2.gl2_geometry(n_fft, hop, win, F)
    consts = {k: torch.as_tensor(v, device=dev)
              for k, v in K2.gl2_consts(n_fft, hop, win, F).items()}
    err1, errs = _k2_gate(K2, n_fft, hop, win, F, B_MAIN, dev)

    # two-tone probe, tiled to the main path's batch
    pmag = _two_tone(cfg, dev)
    pscr = K2.scramble_mag(pmag.expand(B_MAIN, F, cfg.n_freq), g)

    def sc(wav):
        m = stft(wav, n_fft, hop, win).abs()[:, :F]
        return float(torch.linalg.norm(m - pmag) / torch.linalg.norm(
            pmag.expand_as(m)))

    n_iter = cfg.n_iter
    w = K2.gl2_run(pscr, consts, g, n_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wp = K2.gl2_run_plain(pscr, consts, g, n_iter)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    s_k, s_p = sc(w), sc(wp)
    # the output's bytes, to hold two versions of the kernel bitwise equal
    digest = _digest(w)
    ms = cuda_ms(lambda: K2.gl2_run(pscr, consts, g, n_iter), 3)
    ok = (err1 <= 1e-5 and np.isfinite(s_k) and s_k <= 1.10 * s_p + 0.01
          and w.shape == (B_MAIN, g.L_sig))
    # operations: real FFTs of the n_fft-point frames, 2.5 N log2 N each
    # (every frame is real and every spectrum Hermitian), 2*n_iter + 1 per
    # frame (n_iter forward/inverse pairs and the final inverse)
    flops = (2 * n_iter + 1) * F * B_MAIN * 2.5 * n_fft * np.log2(n_fft)
    b_ms, b_by = bound(nbytes(pscr, w), flops)
    # the round structure's bytes floor: every launch of the frame kernel
    # writes the frames and reads the n/2 + 1 distinct magnitude bins of
    # each, the next overlap-add reads the frames back (the signal, 18.6
    # MB, can stay in L2); frames of n_fft samples, or of the window's
    # nonzero span only
    nz = np.flatnonzero(K2.gl2_consts(n_fft, hop, win, F)["win"][0])
    span = int(nz[-1]) + 1 - int(nz[0])
    frame_len = {"full": n_fft, "span": span}
    floors = {k: ((n_iter + 1) * B_MAIN * F * 4 * (2 * L + cfg.n_freq)
                  + nbytes(w)) / PEAK_BYTES * 1e3
              for k, L in frame_len.items()}
    # a yardstick only, never called by the port: cuFFT's time for the
    # transforms alone, rfft + irfft of the same B*F frames, 2*n_iter + 1
    # transforms as the kernel runs them
    frames = torch.randn(B_MAIN * F, n_fft, generator=torch.Generator(
        ).manual_seed(5)).to(dev)
    spec = torch.fft.rfft(frames)

    def transforms():
        for _ in range(n_iter):
            torch.fft.irfft(spec, n_fft)
            torch.fft.rfft(frames)
        torch.fft.irfft(spec, n_fft)
    lib_ms = cuda_ms(transforms, 3)
    del frames, spec
    kinds = _kinds(lambda: K2.gl2_run(pscr, consts, g, n_iter), K2_KINDS)
    line("K2", ok=ok, B=B_MAIN, F=F, n_fft=n_fft, n_iter=n_iter,
         tol="1e-5", **errs, sc_kernel=f"{s_k:.5f}", sc_plain=f"{s_p:.5f}",
         ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.1f}", bound_ms=f"{b_ms:.4f}",
         bound_by=b_by, gflop=f"{flops / 1e9:.2f}",
         bytes_floor_ms_full_frames=f"{floors['full']:.3f}",
         bytes_floor_ms_span_frames=f"{floors['span']:.3f}",
         span=f"[{int(nz[0])},{int(nz[-1]) + 1})", out_sha256=digest,
         cufft_rfft_irfft_ms=f"{lib_ms:.3f}",
         **_k2_frame(K2, B_MAIN, F),
         **{f"{k}_ms": "not measured" if kinds is None else f"{kinds[k]:.3f}"
            for k in K2_KINDS})
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"err1={err1} sc={s_k} vs {s_p}")
    results["K2"] = dict(max_abs_err=err1, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         bytes_floor_ms=floors)
    # bench.py's chunk, B = 72, and the single cell's, B = 1: every row is
    # the probe, so every row must equal the B = 20 run's (an item's work
    # does not depend on the batch)
    for B in (72, 1):
        pscr_b = K2.scramble_mag(pmag.expand(B, F, cfg.n_freq), g)
        w_b = K2.gl2_run(pscr_b, consts, g, n_iter)
        same = bool((w_b == w[:1]).all())
        frame = _k2_frame(K2, B, F)
        ms_b = cuda_ms(lambda: K2.gl2_run(pscr_b, consts, g, n_iter),
                       3 if B > 1 else 20)
        kinds_b = _kinds(lambda: K2.gl2_run(pscr_b, consts, g, n_iter),
                         K2_KINDS)
        line(f"K2-B{B}", ok=same, B=B, rows_equal_B20=same, ms=f"{ms_b:.3f}",
             ratio_to_B20=f"{ms_b / ms:.3f}", **frame,
             **{f"{k}_ms": "not measured" if kinds_b is None
                else f"{kinds_b[k]:.3f}" for k in K2_KINDS})
        if not same:
            raise AssertionError(f"K2 at B={B} differs from its B=20 rows")
        results[f"K2_B{B}"] = dict(ms=ms_b)
        del pscr_b, w_b
    _k2_n1056(K2, dev, results)


def _k2_frame(K2, B, F):
    """The frame kernel's launch in gl2_run's last call: grid, threads a
    block, resident blocks a SM, registers a thread, and the items (frame
    pairs) a SM takes a launch."""
    frame = getattr(K2.gl2_run, "frame", None)
    items = (F + 1) // 2 * B
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if frame is None:
        return dict(grid=getattr(K2.gl2_run, "grid", "not reported"),
                    frame="not reported", items_per_sm=f"{items / sms:.1f}")
    return dict(**frame, items_per_sm=f"{items / sms:.1f}")


def _k2_n1056(K2, dev, results):
    """K2 at a non-power-of-two n_fft (32 * 33), hop and window in the base
    config's ratios, a small F: the same 1e-5 gate (line K2-n1056)."""
    n2, h2, w2, F2 = 1056, 142, 568, 61
    if not hasattr(K2, "fft_plan"):  # a package of power-of-two n_fft only
        line("K2-n1056", ok="skipped", reason="no mixed-radix plan")
        return
    err2, errs2 = _k2_gate(K2, n2, h2, w2, F2, B_MAIN, dev, seed=4)
    ok2 = err2 <= 1e-5
    line("K2-n1056", ok=ok2, B=B_MAIN, F=F2, n_fft=n2, hop=h2, win=w2,
         tol="1e-5", **errs2)
    if not ok2:
        raise AssertionError(f"K2 at n_fft={n2} disagrees with its plain "
                             f"version: {err2}")
    results["K2_n1056"] = dict(max_abs_err=err2)


def _two_tone(cfg, dev):
    """The Griffin-Lim probe of phases K2 and K3: |stft| of 440 + 660 Hz
    at the production geometry, (F, n_freq)."""
    from dc_tts_tpu_torch.dsp.stft import stft
    F = cfg.max_T_full
    t = torch.arange(cfg.hop_length * (F - 1) + cfg.n_fft,
                     dtype=torch.float64) / cfg.sr
    probe = (0.6 * torch.sin(2 * np.pi * 440 * t)
             + 0.4 * torch.sin(2 * np.pi * 660 * t)).float().to(dev)
    return stft(probe, cfg.n_fft, cfg.hop_length, cfg.win_length).abs()[:F]


def spectral_convergence(wav, mag, cfg):
    """Per row: || |stft(wav)| - mag || / || mag || over (F, n_freq)."""
    from dc_tts_tpu_torch.dsp.stft import stft
    m = stft(wav, cfg.n_fft, cfg.hop_length, cfg.win_length).abs()
    m = m[..., : mag.shape[-2], :]
    return (torch.linalg.norm((m - mag).flatten(-2), dim=-1)
            / torch.linalg.norm(mag.expand_as(m).flatten(-2), dim=-1))


def _diff(got, want):
    """(max, mean) of |got - want| over a pair of tensors (Xr, Xi)."""
    d = torch.cat([(a.double() - b.double()).abs().flatten()
                   for a, b in zip(got, want)])
    return float(d.max()), float(d.mean())


def _k3_conditioned(yk, yp, mag, consts, g, three):
    """The bins (B, F, n_freq) of a K3 round whose phase the kernel's K3a
    rounding cannot move by more than 1e-2. K3b's operands are the windowed
    frames of K3a's signal rounded to bf16 (hi, and lo with three_pass); a
    1-ulp difference between the kernel's signal yk and the plain version's
    yp can flip such a rounding, which moves each bin E of that frame by at
    most delta = sum over the frame of |d hi| + |d lo| (every C, S entry is
    at most 1 in size), and the phase E/|E| times mag by at most 2 mag
    delta / |E|. Those bins with 2 mag delta <= 1e-2 |E| (E: the plain
    version's spectrum before the phase normalisation)."""
    from dc_tts_tpu_torch.ops.gl import k3b_spectrum_plain

    def parts(y):
        x = y.unfold(-1, g.n_fft, g.hop) * consts["win"]
        hi = x.bfloat16().float()
        return hi, ((x - hi).bfloat16().float() if three
                    else torch.zeros_like(hi))
    (hk, lk), (hp, lp) = parts(yk), parts(yp)
    delta = ((hk - hp).abs() + (lk - lp).abs()).sum(-1, keepdim=True)
    del hk, lk, hp, lp
    er, ei = k3b_spectrum_plain(yp, consts, g, three)
    return 2 * mag[:, : g.F] * delta <= 1e-2 * torch.sqrt(er * er + ei * ei)


def phase_k3(results):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.dsp.griffin_lim import griffin_lim, gl_schedule
    from dc_tts_tpu_torch.ops import gl as K3
    from dc_tts_tpu_torch.utils.profiling import griffin_lim_flops

    cfg = base_config()
    dev = torch.device("cuda")
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    F = cfg.max_T_full
    g = K3.gl_geometry(n_fft, hop, win, F)
    consts = {k: v.to(dev) for k, v in
              K3.gl_fused_consts(n_fft, hop, win, F).items()}
    gen = torch.Generator().manual_seed(6)
    rows = (0, 0, 0, g.f2 - F)
    pad = torch.nn.functional.pad
    mag = pad(torch.rand(B_MAIN, F, g.n_freq, generator=gen), rows).to(dev)
    Xr, Xi = (pad(torch.randn(B_MAIN, F, g.n_freq, generator=gen), rows
                  ).to(dev) for _ in range(2))
    # one GEMM's operations per pass, from the JAX package's count of a
    # round's four real matmuls: dense, 2*M*N*K at M = B*F frames and N*K =
    # n_fft * 2*n_freq, as the kernels run it; and what the function needs,
    # the window's win_length samples of K3a's N and K3b's K
    dense1 = griffin_lim_flops(B_MAIN, F, n_fft, 0, "dft") / 2
    flops1 = dense1 * win / n_fft
    # the tiles the kernels run: K3a's N tiles of 128 and K3b's k-tiles of
    # 64 that meet the window's span (all of them on a package without
    # window_span), and the operations those tiles take a pass
    M = B_MAIN * F
    (na, ka), (nb, kb) = (tuple(consts[k].shape) for k in ("k3a_hi",
                                                          "k3b_hi"))
    span = getattr(K3, "window_span", None)
    ta = span(g, 128) if span else (0, na // 128)
    tb = span(g, 64) if span else (0, kb // 64)
    run_a = 2.0 * M * (ta[1] - ta[0]) * 128 * ka
    run_b = 2.0 * M * nb * (tb[1] - tb[0]) * 64
    modes = {}
    for three in (False, True):
        npass = 3 if three else 1
        # each kernel against its plain version on the same inputs (K3b on
        # the plain K3a's signal), then the whole round against the plain
        # version (and the plain version run with float64 sums)
        yk = K3.k3a(Xr, Xi, consts, g, three)
        yp = K3.k3a_plain(Xr, Xi, consts, g, three)
        d_a = float((yk - yp).abs().max())
        e_a = d_a / float(yp.abs().max())
        e_b = _diff(K3.k3b(yp, mag, consts, g, three),
                    K3.k3b_plain(yp, mag, consts, g, three))
        rk = K3.fused_gl_round(Xr, Xi, mag, consts, g, three)
        rp = K3.fused_gl_round_plain(Xr, Xi, mag, consts, g, three)
        r64 = K3.fused_gl_round_plain(Xr.double(), Xi.double(),
                                      mag.double(), consts, g, three)
        e_r, e_k64, e_p64 = _diff(rk, rp), _diff(rk, r64), _diff(rp, r64)
        # the round's max, bin by bin, where K3a's rounding cannot move the
        # phase by more than 1e-2 (_k3_conditioned); elsewhere it is a
        # chance event at near-zero bins, counted
        d = torch.maximum((rk[0] - rp[0]).abs(), (rk[1] - rp[1]).abs())[:, :F]
        cond = _k3_conditioned(yk, yp, mag, consts, g, three)
        d_cond = float(d[cond].max())
        n_ill, n_over = int((~cond).sum()), int((d > 2e-2).sum())
        pad_rows = max(float(rk[0][:, F:].abs().max()),
                       float(rk[1][:, F:].abs().max()))
        finite = bool(torch.isfinite(rk[0]).all() and torch.isfinite(
            rk[1]).all())
        del yk, rk, rp, r64, d, cond
        ms_a = cuda_ms(lambda: K3.k3a(Xr, Xi, consts, g, three), 10)
        ms_b = cuda_ms(lambda: K3.k3b(yp, mag, consts, g, three), 10)
        kinds_a = _kinds(lambda: K3.k3a(Xr, Xi, consts, g, three), K3_KINDS)
        kinds_b = _kinds(lambda: K3.k3b(yp, mag, consts, g, three), K3_KINDS)
        plain_a = cuda_ms(lambda: K3.k3a_plain(Xr, Xi, consts, g, three), 3)
        plain_b = cuda_ms(lambda: K3.k3b_plain(yp, mag, consts, g, three), 3)
        lo = ("_lo",) if three else ()
        # bytes: the F rows of spectrum and magnitude the kernels read, the
        # whole output they write
        b_a = bound(nbytes(Xr[:, :F], Xi[:, :F], consts["win"],
                           consts["wsq_seg"], yp,
                           *(consts["k3a" + s] for s in ("_hi",) + lo)),
                    npass * flops1, PEAK_BF16)
        b_b = bound(nbytes(yp, mag[:, :F], consts["win"], Xr, Xi,
                           *(consts["k3b" + s] for s in ("_hi",) + lo)),
                    npass * flops1, PEAK_BF16)
        ok = (finite and e_a <= 1e-5 and e_b[0] <= 2e-2 and e_b[1] <= 1e-5
              and d_cond <= 2e-2 and e_r[1] <= 1e-5 and pad_rows == 0.0)
        line("K3", ok=ok, passes=npass, B=B_MAIN, F=F, fp1=g.fp1,
             n_fft=n_fft, k3a_max=f"{d_a:.3e}", k3a_max_rel=f"{e_a:.3e}",
             k3b_max=f"{e_b[0]:.3e}", k3b_mean=f"{e_b[1]:.3e}",
             round_max_conditioned=f"{d_cond:.3e}",
             round_max=f"{e_r[0]:.3e}", round_mean=f"{e_r[1]:.3e}",
             bins_unconditioned=n_ill, bins_over_2e_2=n_over,
             bins=2 * B_MAIN * F * g.n_freq,
             round_vs_f64_max=f"{e_k64[0]:.3e}",
             round_vs_f64_mean=f"{e_k64[1]:.3e}",
             plain_f32_vs_f64_max=f"{e_p64[0]:.3e}",
             plain_f32_vs_f64_mean=f"{e_p64[1]:.3e}", pad_rows=pad_rows,
             tol="k3a 1e-5 x max|y|; k3b max 2e-2, mean 1e-5; round max "
                 "2e-2 on the conditioned bins, mean 1e-5 on all",
             k3a_ms=f"{ms_a:.3f}", k3b_ms=f"{ms_b:.3f}",
             k3a_plain_ms=f"{plain_a:.3f}", k3b_plain_ms=f"{plain_b:.3f}",
             k3a_bound_ms=f"{b_a[0]:.4f}", k3b_bound_ms=f"{b_b[0]:.4f}",
             bound_by=b_a[1], gflop_each=f"{npass * flops1 / 1e9:.1f}",
             dense_gemm_gflop_each=f"{npass * dense1 / 1e9:.1f}",
             k3a_n_tiles_run=f"{ta[0]}-{ta[1] - 1}/{na // 128}",
             k3b_k_tiles_run=f"{tb[0]}-{tb[1] - 1}/{kb // 64}",
             k3a_run_gflop=f"{npass * run_a / 1e9:.1f}",
             k3b_run_gflop=f"{npass * run_b / 1e9:.1f}",
             k3a_kinds_ms=kinds_a and {k: round(v, 4)
                                       for k, v in kinds_a.items()},
             k3b_kinds_ms=kinds_b and {k: round(v, 4)
                                       for k, v in kinds_b.items()})
        if not ok:
            raise AssertionError(f"K3 ({npass}-pass) disagrees with its "
                                 f"plain version: k3a {e_a}, k3b {e_b}, "
                                 f"round {e_r}, conditioned {d_cond}, pad "
                                 f"rows {pad_rows}")
        modes[npass] = dict(k3a_ms=ms_a, k3b_ms=ms_b, k3a_plain_ms=plain_a,
                            k3b_plain_ms=plain_b, k3a_bound_ms=b_a[0],
                            k3b_bound_ms=b_b[0], bound_by=b_a[1],
                            k3a_max_abs=d_a, k3a_max_rel=e_a, k3b_err=e_b,
                            round_err=e_r, round_max_conditioned=d_cond,
                            bins_unconditioned=n_ill, bins_over_2e_2=n_over,
                            round_vs_f64=e_k64, plain_vs_f64=e_p64,
                            k3a_kinds_ms=kinds_a, k3b_kinds_ms=kinds_b,
                            k3a_run_gflop=npass * run_a / 1e9,
                            k3b_run_gflop=npass * run_b / 1e9)

    # a yardstick only, never called by the port: cuBLAS's time for the
    # round's two GEMMs with bf16 operands (and a bf16 output)
    # on the kernels' B*F rows
    xa = torch.cat([Xr, Xi], -1)[:, :F].reshape(-1, 2 * g.n_freq).bfloat16()
    wa = consts["k3a_hi"][:n_fft, : 2 * g.n_freq].T
    fr = yp.unfold(-1, n_fft, hop).reshape(-1, n_fft).bfloat16()
    wb = consts["k3b_hi"][: 2 * g.n_freq, :n_fft].T
    cublas_ms = cuda_ms(lambda: (xa @ wa, fr @ wb), 10)
    del xa, fr, yp

    # the 50-round schedule on the two-tone probe, against the plain
    # dft_mixed schedule on the card
    pmag = _two_tone(cfg, dev).expand(B_MAIN, F, g.n_freq).contiguous()
    n_iter = cfg.n_iter
    w = griffin_lim(pmag, n_fft, hop, win, n_iter, method="dft_pallas")
    wm = griffin_lim(pmag, n_fft, hop, win, n_iter, method="dft_mixed")
    s_k = float(spectral_convergence(w, pmag[0], cfg).max())
    s_m = float(spectral_convergence(wm, pmag[0], cfg).max())
    loop_ms = cuda_ms(lambda: griffin_lim(pmag, n_fft, hop, win, n_iter,
                                          method="dft_pallas"), 3)
    mixed_ms = cuda_ms(lambda: griffin_lim(pmag, n_fft, hop, win, n_iter,
                                           method="dft_mixed"), 1)
    head, mid, tail = gl_schedule(n_iter)
    loop_bound = bound(nbytes(pmag, w), (mid + 3 * (head + tail)) * 2
                       * flops1, PEAK_BF16)
    ok = (bool(torch.isfinite(w).all()) and s_k <= 1.10 * s_m + 0.01
          and w.shape == (B_MAIN, g.L_sig))
    line("K3-loop", ok=ok, n_iter=n_iter, schedule=f"{head},{mid},{tail}",
         sc_dft_pallas=f"{s_k:.5f}", sc_dft_mixed_plain=f"{s_m:.5f}",
         tol="sc <= 1.10 x plain dft_mixed + 0.01", loop_ms=f"{loop_ms:.3f}",
         dft_mixed_plain_ms=f"{mixed_ms:.1f}",
         loop_bound_ms=f"{loop_bound[0]:.3f}", bound_by=loop_bound[1],
         cublas_bf16_round_gemms_ms=f"{cublas_ms:.3f}")
    if not ok:
        raise AssertionError(f"dft_pallas loop: sc {s_k} vs dft_mixed {s_m}")
    one = modes[1]
    results["K3a"] = dict(max_abs_err=max(m["k3a_max_abs"]
                                          for m in modes.values()),
                          ms=one["k3a_ms"], plain_ms=one["k3a_plain_ms"],
                          bound_ms=one["k3a_bound_ms"],
                          bound_by=one["bound_by"])
    results["K3b"] = dict(max_abs_err=max(m["k3b_err"][0]
                                          for m in modes.values()),
                          ms=one["k3b_ms"], plain_ms=one["k3b_plain_ms"],
                          bound_ms=one["k3b_bound_ms"],
                          bound_by=one["bound_by"])
    results["K3_modes"] = modes
    results["K3_loop"] = dict(sc_dft_pallas=s_k, sc_dft_mixed=s_m,
                              loop_ms=loop_ms, dft_mixed_ms=mixed_ms,
                              bound_ms=loop_bound[0],
                              cublas_bf16_round_gemms_ms=cublas_ms)


def device_busy(prof, n_top=6):
    """(summed kernel ms, {kernel: [ms, launches]} of the n_top longest, or
    of every kernel with n_top=None) from a torch.profiler trace's device
    events."""
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                   "").split("(")[0][:40]
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() / 1e3
        t[1] += 1
    if n_top is None:
        return sum(t for t, _ in by_name.values()), by_name
    top = {k: [round(t, 3), n] for k, (t, n) in
           sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]}
    return sum(t for t, _ in by_name.values()), top


def phase_e2e(results, smi):
    from dc_tts_tpu_torch import Synthesizer, base_config, test_config
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.dsp.griffin_lim import spectrogram_to_wav
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.scripts.profile_stages import stage_times
    from dc_tts_tpu_torch.utils import profiling

    cfg = base_config()
    synth = Synthesizer(cfg, *seeded_nets(cfg),
                        pcm16=True)
    ids = harvard_ids(cfg, 40)
    synth.synthesize_ids_chunked(ids[:CHUNK], CHUNK)      # warm-up
    profiling.reset_counts()
    t0 = time.perf_counter()
    wavs = synth.synthesize_ids_chunked(ids, CHUNK)
    wall = time.perf_counter() - t0
    launches = profiling.counts()
    n_samples = cfg.hop_length * (cfg.max_T_full - 1)
    chunks = launches["k1.launches"]
    ok = (wavs.dtype == np.int16 and wavs.shape == (40, n_samples)
          and chunks > 0 and launches["k2.launches"] > 0
          and launches["k3a.launches"] == launches["k3b.launches"] == 0
          and launches["k5.launches"] == 2 * 16 * chunks
          and launches["k5.textenc.launches"] == 0
          and launches["textenc.graph.captures"] == 0
          and launches["textenc.graph.replays"] == chunks
          and launches["to_host.staging.allocs"] == 0
          and launches["deemphasis.table_uploads"] == 0
          and int(np.abs(wavs).max()) > 0)
    audio_s = wavs.size / cfg.sr
    line("e2e", ok=ok, shape=wavs.shape, dtype=wavs.dtype,
         launches=json.dumps(launches).replace(" ", ""),
         staging_allocs=launches["to_host.staging.allocs"],
         table_uploads=launches["deemphasis.table_uploads"],
         wall_s=f"{wall:.3f}", audio_s=f"{audio_s:.1f}",
         audio_s_per_s=f"{audio_s / wall:.1f}", card=repr(smi))
    if not ok:
        raise AssertionError(f"end to end failed: {wavs.shape} {wavs.dtype} "
                             f"{launches}")
    stages, wav_st = stage_times(synth, ids[:CHUNK])
    # the span-timed call is held to an untimed one: recording changes
    # nothing
    wav_sy = synth.synthesize_ids(ids[:CHUNK])[0]
    d_st = int((wav_st.int() - wav_sy.int()).abs().max())
    dev_s = sum(stages.values()) / 1e3
    line("e2e-stages", ok=d_st == 0, chunk=CHUNK,
         **{k: f"{v:.3f}" for k, v in stages.items()},
         device_audio_s_per_s=f"{CHUNK * n_samples / cfg.sr / dev_s:.1f}",
         max_dpcm_vs_synthesize_ids=d_st)
    if d_st != 0:
        raise AssertionError(f"the stage-timed chain differs from "
                             f"synthesize_ids by {d_st} pcm steps")

    # a small input against the CPU reference (the plain versions): Y and Z
    # against the CPU run, the waveform against the float64 plain vocoder
    # on the card's own Z (see phase K2 for why float64)
    tc = test_config()
    gen = torch.Generator().manual_seed(3)
    p1, p2 = Text2Mel(tc).init(gen), SSRN(tc).init(gen)
    tids = harvard_ids(tc, 3)
    wav, Y, Z, A = (o.cpu() for o in
                    Synthesizer(tc, p1, p2).synthesize_ids(tids))
    cpu = Synthesizer(tc, p1, p2, device="cpu").synthesize_ids(tids)
    ref = spectrogram_to_wav(Z.double(), tc.replace(stft_method="fft"))
    dY = float((Y - cpu[1]).abs().max())
    dZ = float((Z - cpu[2]).abs().max())
    dW = float((wav.double() - ref).abs().max())
    same = bool(torch.equal(A.argmax(1), cpu[3].argmax(1)))
    ok = same and dY <= 2e-5 and dZ <= 1e-4 and dW <= 1e-4
    line("e2e-tiny", ok=ok, cursors_equal=same, max_dY=f"{dY:.3e}",
         max_dZ=f"{dZ:.3e}", max_dwav_vs_f64=f"{dW:.3e}",
         tol="Y 2e-5, Z 1e-4, wav 1e-4")
    if not ok:
        raise AssertionError("tiny synthesis on the card disagrees with the "
                             "CPU")
    results.setdefault("launches", {}).update(
        {k: launches[k] for k in ("k1.launches", "k2.launches",
                                  "k5.launches")})
    results["e2e"] = dict(wall_s=wall, audio_s=audio_s,
                          audio_s_per_s=audio_s / wall, stages_ms=stages,
                          ssrn_precision=_ssrn_precisions(synth,
                                                          ids[:CHUNK]))


def _ssrn_precisions(synth, ids):
    """SSRN of synthesis under each ssrn_precision on one chunk's decoded
    mels: CUDA-event ms and Z's max and mean distance from "highest";
    "high" must stay within 1e-4 x max|Z| of it (line e2e-ssrn)."""
    from dc_tts_tpu_torch import Synthesizer
    from dc_tts_tpu_torch.pipeline import SSRN_PRECISIONS

    with torch.no_grad():
        Y = synth.synthesize_ids(ids)[1]
        out, Z = {}, {}
        for prec in ("highest", "high", "bf16"):
            s = Synthesizer(synth.cfg, synth.t2m_params, synth.ssrn_params,
                            decode_mode="incremental", ssrn_precision=prec)
            packed = getattr(s, "ssrn_packed", None)
            kw = {} if packed is None else {"packed": packed}
            Z[prec] = s.ssrn.apply(s.ssrn_params, Y, **kw)[1]
            ms = cuda_ms(lambda: s.ssrn.apply(s.ssrn_params, Y, **kw), 5)
            d = (Z[prec] - Z["highest"]).abs()
            out[prec] = dict(ms=ms, max_dZ=float(d.max()),
                             mean_dZ=float(d.mean()),
                             finite=bool(torch.isfinite(Z[prec]).all()))
    z_max = float(Z["highest"].abs().max())
    ok = (out["high"]["max_dZ"] <= 1e-4 * z_max
          and all(r["finite"] for r in out.values()))
    line("e2e-ssrn", ok=ok, chunk=len(ids), max_Z=f"{z_max:.4f}",
         **{f"{p}_{k}": (f"{v:.3f}" if k == "ms" else f"{v:.3e}")
            for p, r in out.items() for k, v in r.items() if k != "finite"},
         compute_dtypes=json.dumps(SSRN_PRECISIONS).replace(" ", ""),
         tol="high within 1e-4 x max|Z| of highest")
    if not ok:
        raise AssertionError(f"SSRN precisions: {out}")
    return out


def phase_e2e_prec(results, smi):
    """The 40 sentences through the Synthesizer in each reduced decode
    precision: K1 launched in that mode only."""
    from dc_tts_tpu_torch import Synthesizer, base_config
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.scripts.profile_stages import stage_times
    from dc_tts_tpu_torch.utils import profiling

    cfg = base_config()
    p1, p2 = seeded_nets(cfg)
    ids = harvard_ids(cfg, 40)
    n_samples = cfg.hop_length * (cfg.max_T_full - 1)
    out = {}
    for prec in ("high3", "hybrid", "default"):
        synth = Synthesizer(cfg, p1, p2, pcm16=True, decode_prec=prec)
        synth.synthesize_ids_chunked(ids[:CHUNK], CHUNK)      # warm-up
        profiling.reset_counts()
        t0 = time.perf_counter()
        wavs = synth.synthesize_ids_chunked(ids, CHUNK)
        wall = time.perf_counter() - t0
        launches = profiling.counts()
        others = [p for p in ("highest", "high3", "hybrid", "default")
                  if p != prec]
        ok = (wavs.dtype == np.int16 and wavs.shape == (40, n_samples)
              and launches["k1.launches"] == 2
              and launches[f"k1.{prec}.launches"] == 2
              and all(launches[f"k1.{p}.launches"] == 0 for p in others)
              and launches["k2.launches"] == 2
              and launches["k3a.launches"] == launches["k3b.launches"] == 0
              and int(np.abs(wavs).max()) > 0)
        stages, wav_st = stage_times(synth, ids[:CHUNK])
        wav_sy = synth.synthesize_ids(ids[:CHUNK])[0]
        d_st = int((wav_st.int() - wav_sy.int()).abs().max())
        audio_s = wavs.size / cfg.sr
        dev_s = sum(stages.values()) / 1e3
        line(f"e2e-{prec}", ok=ok and d_st == 0, shape=wavs.shape,
             dtype=wavs.dtype, launches=json.dumps(
                 {k: v for k, v in launches.items() if v}).replace(" ", ""),
             wall_s=f"{wall:.3f}", audio_s=f"{audio_s:.1f}",
             audio_s_per_s=f"{audio_s / wall:.1f}",
             **{k: f"{v:.3f}" for k, v in stages.items()},
             device_audio_s_per_s=f"{CHUNK * n_samples / cfg.sr / dev_s:.1f}",
             max_dpcm_vs_synthesize_ids=d_st, card=repr(smi))
        if not ok or d_st != 0:
            raise AssertionError(f"e2e {prec} failed: {wavs.shape} "
                                 f"{wavs.dtype} {launches} dpcm {d_st}")
        key = f"k1.{prec}.launches"
        results.setdefault("launches", {})[key] = launches[key]
        out[prec] = dict(wall_s=wall, audio_s=audio_s,
                         audio_s_per_s=audio_s / wall, stages_ms=stages,
                         launches=launches)
        del synth
        torch.cuda.empty_cache()
    results["e2e-prec"] = out


def phase_reference(results, smi):
    """decode_mode="reference": the TF goldens through the port's own
    converter on the card, then one chunk at full width."""
    from dc_tts_tpu_torch import Synthesizer, base_config, test_config
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.convert import convert
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.params import to_device
    from dc_tts_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    with np.load(os.path.join(HERE, "tests", "goldens",
                              "tf_reference_tiny.npz")) as d:
        gold = {k: d[k] for k in d.files}
    tc = test_config().replace(ln_eps=1e-12)
    t2m_p, ssrn_p = (to_device(t, dev) for t in convert(
        {k[len("var/"):]: v for k, v in gold.items()
         if k.startswith("var/")}, tc))
    with torch.no_grad():
        Y, A = Text2Mel(tc).decode(t2m_p, torch.as_tensor(
            gold["in/L"], device=dev), mode="reference")
        Z = SSRN(tc).apply(ssrn_p, Y)[1]
    Y, A, Z = Y.cpu().numpy(), A.cpu().numpy(), Z.cpu().numpy()
    same = bool(np.array_equal(A.argmax(1), gold["synth/max_attentions"]))
    y_ok = bool(np.allclose(Y, gold["synth/Y"], rtol=1e-4, atol=2e-5))
    z_ok = bool(np.allclose(Z, gold["synth/Z"], rtol=1e-4, atol=5e-5))
    line("reference-tf", ok=same and y_ok and z_ok, cursors_equal=same,
         max_dY=f"{np.abs(Y - gold['synth/Y']).max():.3e}",
         max_dZ=f"{np.abs(Z - gold['synth/Z']).max():.3e}",
         tol="Y rtol 1e-4 atol 2e-5, Z rtol 1e-4 atol 5e-5")
    if not (same and y_ok and z_ok):
        raise AssertionError("the reference decode on the card misses the "
                             "TF goldens")

    cfg = base_config()
    synth = Synthesizer(cfg, *seeded_nets(cfg),
                        pcm16=True, decode_mode="reference")
    ids = harvard_ids(cfg, CHUNK)
    profiling.reset_counts()
    wav, Y, Z, A = synth.synthesize_ids(ids)
    torch.cuda.synchronize()
    launches = profiling.counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        tids = torch.as_tensor(ids, device=dev)
        ev[0].record()
        synth.text2mel.decode(synth.t2m_params, tids, mode="reference")
        ev[1].record()
        torch.cuda.synchronize()
    decode_ms = ev[0].elapsed_time(ev[1])
    n_samples = cfg.hop_length * (cfg.max_T_full - 1)
    ok = (wav.dtype == torch.int16 and tuple(wav.shape) == (CHUNK, n_samples)
          and launches["k1.launches"] == 0 and launches["k2.launches"] == 1
          and launches["k3a.launches"] == launches["k3b.launches"] == 0
          and all(bool(torch.isfinite(t).all()) for t in (Y, Z, A))
          and int(wav.abs().max()) > 0)
    line("reference", ok=ok, shape=tuple(wav.shape), dtype=wav.dtype,
         launches=json.dumps({k: v for k, v in launches.items() if v}
                             ).replace(" ", ""),
         decode_reference_ms=f"{decode_ms:.3f}",
         note="'decode ms includes TextEnc'", card=repr(smi))
    if not ok:
        raise AssertionError(f"reference synthesis failed: {wav.shape} "
                             f"{wav.dtype} {launches}")
    results["reference"] = dict(decode_ms=decode_ms, launches=launches)


def phase_e2e_dft_pallas(results, smi):
    """The synthesis path under stft_method="dft_pallas": every Griffin-Lim
    round through K3."""
    from dc_tts_tpu_torch import Synthesizer, base_config
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.dsp.features import deemphasis
    from dc_tts_tpu_torch.dsp.griffin_lim import denormalize_mag, griffin_lim
    from dc_tts_tpu_torch.scripts.profile_stages import stage_times
    from dc_tts_tpu_torch.utils import profiling

    cfg = base_config().replace(stft_method="dft_pallas")
    synth = Synthesizer(cfg, *seeded_nets(cfg),
                        pcm16=True)
    ids = harvard_ids(cfg, 40)
    synth.synthesize_ids_chunked(ids[:CHUNK], CHUNK)      # warm-up
    profiling.reset_counts()
    t0 = time.perf_counter()
    wavs = synth.synthesize_ids_chunked(ids, CHUNK)
    wall = time.perf_counter() - t0
    launches = profiling.counts()
    n_samples = cfg.hop_length * (cfg.max_T_full - 1)
    audio_s = wavs.size / cfg.sr
    # quality: each utterance's Griffin-Lim against its own Z, dft_pallas
    # against the default dft_pallas2; the Synthesizer's pcm16 output is
    # held equal to the direct call's
    gl = (cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.n_iter)
    s3, s2, d_pcm, first = [], [], 0, None
    for i in range(0, len(ids), CHUNK):
        wav_sy, _, Z, _ = synth.synthesize_ids(ids[i: i + CHUNK])
        mag = denormalize_mag(Z, cfg)
        first = (wav_sy, mag) if first is None else first
        w3 = griffin_lim(mag, *gl, method="dft_pallas")
        w2 = griffin_lim(mag, *gl, method="dft_pallas2")
        pcm = torch.round(torch.clamp(deemphasis(w3, cfg.preemphasis),
                                      -1.0, 1.0) * 32767.0).to(torch.int16)
        d_pcm = max(d_pcm, int((pcm.int() - wav_sy.int()).abs().max()))
        s3.append(spectral_convergence(w3, mag, cfg))
        s2.append(spectral_convergence(w2, mag, cfg))
    s3, s2 = torch.cat(s3), torch.cat(s2)
    ratio = float((s3 - 0.01).div(s2).max())
    ok = (wavs.dtype == np.int16 and wavs.shape == (40, n_samples)
          and launches["k1.launches"] > 0 and launches["k2.launches"] == 0
          and launches["k3a.launches"] > 0 and launches["k3b.launches"] > 0
          and int(np.abs(wavs).max()) > 0 and d_pcm == 0
          and bool(torch.isfinite(s3).all())
          and bool((s3 <= 1.10 * s2 + 0.01).all()))
    line("e2e-dft_pallas", ok=ok, shape=wavs.shape, dtype=wavs.dtype,
         launches=json.dumps(launches).replace(" ", ""),
         wall_s=f"{wall:.3f}", audio_s=f"{audio_s:.1f}",
         audio_s_per_s=f"{audio_s / wall:.1f}",
         sc_dft_pallas_mean=f"{float(s3.mean()):.5f}",
         sc_dft_pallas_max=f"{float(s3.max()):.5f}",
         sc_dft_pallas2_mean=f"{float(s2.mean()):.5f}",
         worst_sc_minus_0p01_over_dft_pallas2=f"{ratio:.4f}",
         tol="each sc <= 1.10 x dft_pallas2's + 0.01",
         max_dpcm_vs_direct=d_pcm, card=repr(smi))
    if not ok:
        raise AssertionError(f"dft_pallas end to end failed: {wavs.shape} "
                             f"{launches} sc {s3.tolist()} vs {s2.tolist()}"
                             f" dpcm {d_pcm}")

    # where the time goes: CUDA events per stage of one chunk (held equal to
    # synthesize_ids' output), and torch.profiler's kernel time by name over
    # that chunk's Griffin-Lim
    stages, wav_st = stage_times(synth, ids[:CHUNK])
    d_st = int((wav_st.int() - first[0].int()).abs().max())
    with profiling.trace(os.path.join(HERE, "chiprun_out",
                                      "trace_dft_pallas")) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        griffin_lim(first[1], *gl, method="dft_pallas")
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_busy(prof)
    dev_s = sum(stages.values()) / 1e3
    line("e2e-dft_pallas-stages", ok=d_st == 0 and busy_ms > 0, chunk=CHUNK,
         **{k: f"{v:.3f}" for k, v in stages.items()},
         device_audio_s_per_s=f"{CHUNK * n_samples / cfg.sr / dev_s:.1f}",
         max_dpcm_vs_synthesize_ids=d_st,
         gl_trace_device_busy_ms=f"{busy_ms:.3f}",
         gl_trace_wall_ms=f"{traced_ms:.3f}",
         gl_trace_top_kernels=json.dumps(top).replace(" ", ""))
    if d_st != 0 or busy_ms <= 0:
        raise AssertionError(f"the stage-timed dft_pallas chain differs from "
                             f"synthesize_ids by {d_st} pcm steps, or the "
                             f"trace holds no kernel ({busy_ms} ms)")
    results.setdefault("launches", {}).update(
        {k: launches[k] for k in ("k3a.launches", "k3b.launches")})
    results["e2e-dft_pallas"] = dict(
        wall_s=wall, audio_s=audio_s, audio_s_per_s=audio_s / wall,
        sc_mean=float(s3.mean()), sc_dft_pallas2_mean=float(s2.mean()),
        launches=launches, stages_ms=stages, gl_trace_busy_ms=busy_ms,
        gl_trace_wall_ms=traced_ms, gl_trace_top=top)


# ---------------------------------------------------------------------------
# K5: SSRN's blocks in synthesis

# K5's kernels, the products around them (cuBLAS), every other kernel
K5_KINDS = {"k5": ("ssrn_prologue", "ssrn_epilogue"),
            "products": ("gemm", "nvjet", "xmma", "cutlass", "splitK"),
            "other": ("",)}


def _biased_ssrn(cfg, dev, seed=11):
    """SSRN's initial weights with every bias, norm gain and shift moved by
    0.1 x N(0, 1), the convs kept (the benchmark's kind of weights)."""
    from dc_tts_tpu_torch.models import SSRN
    from dc_tts_tpu_torch.train.optimizer import tree_map
    gen = torch.Generator().manual_seed(seed)
    p = SSRN(cfg).init(gen)
    stack = [{k: {n: (t if n == "w" else
                      t + 0.1 * torch.randn(t.shape, generator=gen))
                  for n, t in v.items()} for k, v in blk.items()}
             for blk in p["stack"]]
    return tree_map(lambda t: t.to(dev), {"stack": stack})


def _k5_bytes(specs, params, B, T, cin):
    """Bytes K5 moves in one SSRN call, each read or written once: a
    block's x, the taps' bf16 halves, the summed products, y and the
    block's vectors."""
    from dc_tts_tpu_torch.models.blocks import D, HC
    from dc_tts_tpu_torch.ops.ssrn_block import _taps_width
    total = 0
    for spec, p in zip(specs, params):
        N = p["conv"]["b"].shape[0]
        M, K = B * T, _taps_width(spec, cin)
        rows = 2 * M if isinstance(spec, D) else M
        prods = 3 * M * N if isinstance(spec, D) else M * N
        out = N // 2 if isinstance(spec, HC) else N
        T = 2 * T if isinstance(spec, D) else T
        vecs = sum(t.numel() for k, v in p.items() if k != "conv"
                   for t in v.values()) + N
        total += 4 * M * cin + 2 * 2 * rows * K + 4 * prods \
            + 4 * B * T * out + 4 * vecs
        cin = out
    return total


def phase_ssrn_block(results):
    """Phase ssrn-block: SSRN through K5 against the eager chain on the
    card (module docstring, 5d)."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.models import SSRN
    from dc_tts_tpu_torch.models.blocks import apply_stack
    from dc_tts_tpu_torch.models.ssrn import ssrn_specs
    from dc_tts_tpu_torch.ops import ssrn_block as K5
    from dc_tts_tpu_torch.utils import profiling

    cfg = base_config().replace(compute_dtype="float32_high")
    dev = torch.device("cuda")
    model, specs = SSRN(cfg), ssrn_specs(cfg)
    params = _biased_ssrn(cfg, dev)
    packed = model.pack(params)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for B in (72, 1):
        Y = torch.rand(B, cfg.max_T, cfg.n_mels, generator=gen, device=dev)

        def fused():
            return model.apply(params, Y, packed=packed)[0]

        def plain():
            return apply_stack(params["stack"], specs, Y, ln_eps=cfg.ln_eps,
                               dtype="high")

        with torch.no_grad():
            # the prologue's halves at every block's input
            x, halves_equal = Y, True
            for p, spec, h in zip(params["stack"], specs, packed):
                got = K5.prologue(x, spec, h.hi.shape[-2])
                want = K5.prologue_plain(x, spec, h.hi.shape[-2])
                halves_equal &= all(torch.equal(g, w)
                                    for g, w in zip(got, want))
                x = apply_stack([p], [spec], x, ln_eps=cfg.ln_eps,
                                dtype="high")
            c0 = profiling.counts()
            lf = fused()
            torch.cuda.synchronize()
            launches = (profiling.counts() - c0)["k5.launches"]
            lp = plain()
            l64 = K5.ssrn_stack_plain(params["stack"], specs, Y, packed,
                                      cfg.ln_eps, torch.float64)
            Zf, Zp, Z64 = (torch.sigmoid(t) for t in (lf, lp, l64))
            dZ = float((Zf - Zp).abs().max())
            d64 = float((Zf - Z64).abs().max())
            gate = max(1e-5, 2 * float((Zp - Z64).abs().max()))
            dL = float((lf - lp).abs().max())
            reps = 10 if B > 1 else 50
            ms_f, ms_p = cuda_ms(fused, reps), cuda_ms(plain, reps)
            host_f = _call_ms(fused)[1] if B == 1 else None
            host_p = _call_ms(plain)[1] if B == 1 else None
            kf, kp = _kinds(fused, K5_KINDS), _kinds(plain, K5_KINDS)
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            peaks = []
            for fn in (fused, plain):
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peaks.append((torch.cuda.max_memory_allocated() - m0) / 1e9)
        n_bytes = _k5_bytes(specs, params["stack"], B, cfg.max_T, cfg.n_mels)
        bound_ms = n_bytes / PEAK_BYTES * 1e3
        ok = (dZ <= gate and halves_equal and launches == 2 * len(specs))
        r = dict(max_dZ=dZ, max_dZ_f64=d64, gate=gate, max_dlogits=dL,
                 fused_ms=ms_f, plain_ms=ms_p,
                 fused_host_ms=host_f, plain_host_ms=host_p, kinds=kf,
                 plain_kinds=kp, bound_ms=bound_ms, bytes=n_bytes,
                 launches=launches, peak_GB=peaks)
        line(f"ssrn-block-B{B}", ok=ok, B=B, max_dZ=f"{dZ:.3e}",
             max_dZ_vs_f64=f"{d64:.3e}", gate=f"{gate:.3e}",
             max_dlogits=f"{dL:.3e}", halves_bitwise=halves_equal,
             launches=launches, fused_ms=f"{ms_f:.3f}",
             plain_ms=f"{ms_p:.3f}",
             **({} if host_f is None else
                {"fused_host_ms": f"{host_f:.3f}",
                 "plain_host_ms": f"{host_p:.3f}"}),
             fused_kinds_ms=json.dumps(kf and {k: round(v, 3) for k, v in
                                                 kf.items()}).replace(" ", ""),
             plain_kinds_ms=json.dumps(kp and {k: round(v, 3) for k, v in
                                                 kp.items()}).replace(" ", ""),
             k5_bound_ms=f"{bound_ms:.3f}", k5_GB=f"{n_bytes / 1e9:.3f}",
             peak_GB=json.dumps([round(v, 3) for v in peaks]),
             logits_sha256=_digest(lf),
             tol="'Z max(1e-5, 2 x the eager chain float32-float64)'")
        if not ok:
            raise AssertionError(f"K5 at B={B}: {r}")
        out[B] = r
    r = out[72]
    results["K5"] = dict(max_abs_err=r["max_dZ"],
                         ms=r["kinds"] and r["kinds"]["k5"],
                         plain_ms=r["plain_kinds"] and
                         r["plain_kinds"]["other"],
                         bound_ms=r["bound_ms"], bound_by="bytes",
                         library_ms=None, by_batch=out)


# ---------------------------------------------------------------------------
# K4 and training


K4_SHAPES = (("TextEnc HC(3,9)", 32, 180, 512, 3, 9, False),
             ("AudioEnc HC(3,27)", 32, 210, 256, 3, 27, True),
             ("SSRN HC(3,1)", 32, 840, 1024, 3, 1, False))
K4_NAMES = ("y", "dx", "dw", "db", "dg1", "db1", "dg2", "db2")


def _hc_inputs(B, T, C, size, seed, dev):
    """x, w, b, g1, be1, g2, be2 and a cotangent dy, seeded, float32."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g)
    w = torch.randn(size, C, 2 * C, generator=g) * (2.0 / (size * C)) ** 0.5
    vecs = [torch.randn(n, generator=g) * 0.3 + (1.0 if i in (1, 3) else 0.0)
            for i, n in enumerate([2 * C, C, C, C, C])]
    dy = torch.randn(B, T, C, generator=g)
    return [t.to(dev) for t in (x, w, *vecs)], dy.to(dev)


def _k4_distances(args, dy, geo):
    """{name: (kernel's distance, float32 plain version's distance,
    tolerance)} for y and the 7 gradients, each distance the max |.| from
    the plain version run in float64 (in geo's operand mode: with bf16 the
    same bf16 rounding points), the tolerance max(2e-5 x the max
    |value|, 2 x the float32 plain version's distance). A non-finite output
    gets an infinite distance."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4

    outs = (K4.hc_block_fwd(*args, *geo), *K4.hc_block_bwd(*args, dy, *geo))
    p32 = (K4.hc_block_fwd_plain(*args, *geo),
           *K4.hc_block_bwd_plain(*args, dy, *geo))
    a64 = [a.double() for a in args]
    ref = (K4.hc_block_fwd_plain(*a64, *geo),
           *K4.hc_block_bwd_plain(*a64, dy.double(), *geo))
    dist = {}
    for name, o, p, r in zip(K4_NAMES, outs, p32, ref):
        dk = float((o.double() - r).abs().max())
        dk = dk if bool(torch.isfinite(o).all()) else float("inf")
        dp = float((p.double() - r).abs().max())
        dist[name] = (dk, dp, max(2e-5 * float(r.abs().max()), 2 * dp))
    return dist


def _k4_bounds(B, T, C, K, peak=PEAK_FP32, passes=1):
    """(forward bound, backward bound, forward operations) of one HC block:
    the inputs read once and the outputs written once (float32, in either
    operand mode), and the tap matmuls, 2*B*T*K*C*2C operations forward and
    three times that backward (h recomputed, dx, dW), each done ``passes``
    times (3 for the 3xTF32 split) at ``peak``."""
    act, params = 4 * B * T * C, 4 * (K * C * 2 * C + 6 * C)
    flops = 2.0 * B * T * K * C * 2 * C
    return (bound(act + params + act, passes * flops, peak),
            bound(2 * act + params + act + params, 3 * passes * flops, peak),
            flops)


def _k4_kernel_bounds(B, T, C, K, bf16):
    """_k4_bounds at the rate the kernels use: dense bf16 for the bf16
    operand body, 3xTF32 (three TF32 passes) for the float32 one."""
    return (_k4_bounds(B, T, C, K, PEAK_BF16) if bf16 else
            _k4_bounds(B, T, C, K, PEAK_TF32, passes=3))


def _k4_library(args, dy, size, rate, causal, bf16=False):
    """CUDA-event ms of the tap products as single cuBLAS calls on
    materialised operands: (forward: taps @ W, backward: that, dh @ W^T and
    taps^T @ dh). float32 with TF32 off, or with ``bf16`` operands already
    rounded to bf16 and float32 outputs (torch.mm(..., out_dtype=float32),
    the bf16 tensor cores). Only the products are timed. dh is the
    cotangent's shape widened to 2C, seeded."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4

    x, w = args[0], args[1]
    B, T, C = x.shape
    taps = K4._taps(x, size, rate, causal).reshape(B * T, size * C)
    wm = w.reshape(size * C, 2 * C)
    dh = torch.cat([dy, dy.flip(-1)], -1).reshape(B * T, 2 * C)
    if bf16:
        taps, wm, dh = (t.bfloat16().contiguous() for t in (taps, wm, dh))

        def mm(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    else:
        mm = torch.matmul

    def bwd():
        mm(taps, wm)
        mm(dh, wm.T)
        mm(taps.T, dh)

    return (cuda_ms(lambda: mm(taps, wm), 5), cuda_ms(bwd, 3))


def _kinds(fn, table):
    """torch.profiler's device ms of one fn() call by kernel kind: table
    maps each kind to the substrings of its kernels' names; None where the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = dict.fromkeys(table, 0.0)
    for name, (ms, _) in device_busy(prof, None)[1].items():
        for kind, keys in table.items():
            if any(k in name for k in keys):
                kinds[kind] += ms
                break
    return kinds if sum(kinds.values()) > 0 else None


# K4's kernels by kind: the GEMMs (tc_gemm, the bf16 core's wg::gemm), the
# TF32 split copies, the bf16 copies of x and W (to_bf16) and the row
# kernels
K4_KINDS = {"gemm": ("gemm",), "split": ("tf32_parts",), "bf16": ("to_bf16",),
            "rows": ("_rows", "col_sum")}
# K2's: the frame kernel (both transforms), the overlap-add
K2_KINDS = {"frame": ("gl_frame",), "ola": ("_ola",)}
# K3's: the bf16 prep passes, the GEMMs, the overlap-add
K3_KINDS = {"prep": ("_prep",), "gemm": ("gemm",), "ola": ("gl_ola",)}


def phase_k4(results, bf16=False):
    """Phase K4, or with ``bf16`` phase K4-bf16: the kernels' bf16-operand
    body against the plain version with the same rounding points (run in
    float64 for the reference), bounded at the dense bf16 rate."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4

    dev = torch.device("cuda")
    phase, suffix = ("K4-bf16", "_bf16") if bf16 else ("K4", "")
    fmt = lambda v: "None" if v is None else f"{v:.3f}"  # noqa: E731
    per_shape = []
    for label, B, T, C, size, rate, causal in K4_SHAPES:
        args, dy = _hc_inputs(B, T, C, size, 4, dev)
        geo = (size, rate, causal, 1e-5, bf16)
        grads = K4.hc_block_bwd(*args, dy, *geo)
        again = K4.hc_block_bwd(*args, dy, *geo)
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        del grads, again
        dist = _k4_distances(args, dy, geo)
        ok = bitwise and all(d[0] <= d[2] for d in dist.values())
        ms_f = cuda_ms(lambda: K4.hc_block_fwd(*args, *geo), 5)
        ms_b = cuda_ms(lambda: K4.hc_block_bwd(*args, dy, *geo), 3)
        plain_f = cuda_ms(lambda: K4.hc_block_fwd_plain(*args, *geo), 3)
        plain_b = cuda_ms(lambda: K4.hc_block_bwd_plain(*args, dy, *geo), 3)
        bf, bb, flops = _k4_kernel_bounds(B, T, C, size, bf16)
        fma_f, fma_b, _ = _k4_bounds(B, T, C, size, PEAK_FP32)
        lib_f, lib_b = _k4_library(args, dy, size, rate, causal, bf16)
        kinds_f = _kinds(lambda: K4.hc_block_fwd(*args, *geo), K4_KINDS)
        kinds_b = _kinds(lambda: K4.hc_block_bwd(*args, dy, *geo), K4_KINDS)
        line(phase, ok=ok, shape=repr(label), B=B, T=T, C=C, rate=rate,
             causal=causal, bitwise_equal_grads=bitwise,
             **{f"{n}_kernel_vs_f64": f"{d[0]:.3e}" for n, d in dist.items()},
             **{f"{n}_plain_f32_vs_f64": f"{d[1]:.3e}"
                for n, d in dist.items()},
             fwd_ms=f"{ms_f:.3f}", bwd_ms=f"{ms_b:.3f}",
             plain_fwd_ms=f"{plain_f:.3f}", plain_bwd_ms=f"{plain_b:.3f}",
             library_fwd_ms=fmt(lib_f), library_bwd_ms=fmt(lib_b),
             fwd_bound_ms=f"{bf[0]:.4f}", bwd_bound_ms=f"{bb[0]:.4f}",
             bound_by=bf[1], fma_fwd_bound_ms=f"{fma_f[0]:.4f}",
             fma_bwd_bound_ms=f"{fma_b[0]:.4f}",
             fwd_gflop=f"{flops / 1e9:.2f}",
             bwd_gflop=f"{3 * flops / 1e9:.2f}",
             fwd_kinds_ms=kinds_f and {k: round(v, 4)
                                       for k, v in kinds_f.items()},
             bwd_kinds_ms=kinds_b and {k: round(v, 4)
                                       for k, v in kinds_b.items()})
        if not ok:
            raise AssertionError(f"{phase} disagrees with its plain version "
                                 f"at {label}: {dist} bitwise={bitwise}")
        per_shape.append(dict(shape=label, fwd_ms=ms_f, bwd_ms=ms_b,
                              plain_fwd_ms=plain_f, plain_bwd_ms=plain_b,
                              library_fwd_ms=lib_f, library_bwd_ms=lib_b,
                              fwd_bound_ms=bf[0], bwd_bound_ms=bb[0],
                              fma_fwd_bound_ms=fma_f[0],
                              fma_bwd_bound_ms=fma_b[0],
                              fwd_kinds_ms=kinds_f, bwd_kinds_ms=kinds_b,
                              bound_by=bf[1],
                              fwd_err=dist["y"][0],
                              bwd_err=max(d[0] for n, d in dist.items()
                                          if n != "y")))
        del args, dy
        torch.cuda.empty_cache()
    s = lambda k: (None if per_shape[0][k] is None  # noqa: E731
                   else sum(r[k] for r in per_shape))
    results["K4_shapes" + suffix] = per_shape
    results["hc_block_fwd" + suffix] = dict(
        max_abs_err=max(r["fwd_err"] for r in per_shape), ms=s("fwd_ms"),
        plain_ms=s("plain_fwd_ms"), bound_ms=s("fwd_bound_ms"),
        bound_by=per_shape[0]["bound_by"], library_ms=s("library_fwd_ms"))
    results["hc_block_bwd" + suffix] = dict(
        max_abs_err=max(r["bwd_err"] for r in per_shape), ms=s("bwd_ms"),
        plain_ms=s("plain_bwd_ms"), bound_ms=s("bwd_bound_ms"),
        bound_by=per_shape[0]["bound_by"], library_ms=s("library_bwd_ms"))
    line(phase + "-sum", fwd_ms=f"{s('fwd_ms'):.3f}",
         bwd_ms=f"{s('bwd_ms'):.3f}",
         library_fwd_ms=fmt(s("library_fwd_ms")),
         library_bwd_ms=fmt(s("library_bwd_ms")),
         fwd_bound_ms=f"{s('fwd_bound_ms'):.4f}",
         bwd_bound_ms=f"{s('bwd_bound_ms'):.4f}",
         fma_fwd_bound_ms=f"{s('fma_fwd_bound_ms'):.4f}",
         fma_bwd_bound_ms=f"{s('fma_bwd_bound_ms'):.4f}")


def make_corpus_and_features(root):
    """2 x B_TRAIN utterances (half of 2-5 s, half of 6-9 s, so that each of
    two length buckets holds one full batch) with the Harvard sentences as
    texts, and prepro's features computed on the card."""
    from dc_tts_tpu_torch import text
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.data.dataset import prepro_corpus
    from dc_tts_tpu_torch.data.synthetic import make_corpus

    cfg = base_config()
    rng = np.random.default_rng(0)
    secs = np.concatenate([rng.uniform(2.0, 5.0, B_TRAIN),
                           rng.uniform(6.0, 9.0, B_TRAIN)])
    sents = text.load_test_sentences(os.path.join(HERE,
                                                  "harvard_sentences.txt"))
    data = make_corpus(os.path.join(root, "corpus"),
                       [sents[i % len(sents)] for i in range(2 * B_TRAIN)],
                       secs, cfg.sr, seed=0)
    feats = os.path.join(root, "feats")
    t0 = time.perf_counter()
    n = prepro_corpus(cfg.replace(data=data), feats, progress=False,
                      device=DEV)
    torch.cuda.synchronize()
    line("corpus", utterances=n, audio_s=f"{secs.sum():.1f}",
         prepro_s=f"{time.perf_counter() - t0:.2f}", device=DEV)
    return data, feats


def _k4_step_ms(specs_shapes, B, bf16=False):
    """(CUDA-event ms, bound ms, GFLOP) of K4's forward + backward over
    every HC block of one step, replayed at the step's shapes with seeded
    inputs (in bf16 operands with ``bf16``)."""
    from dc_tts_tpu_torch.ops import hc_vjp as K4

    dev = torch.device(DEV)
    total = b_ms = gflop = 0.0
    for spec, T, C in specs_shapes:
        args, dy = _hc_inputs(B, T, C, spec.size, 5, dev)
        geo = (spec.size, spec.rate, spec.causal, 1e-5, bf16)
        total += cuda_ms(lambda: (K4.hc_block_fwd(*args, *geo),
                                  K4.hc_block_bwd(*args, dy, *geo)), 2)
        bf, bb, flops = _k4_kernel_bounds(B, T, C, spec.size, bf16)
        b_ms += bf[0] + bb[0]
        gflop += 4 * flops / 1e9
    return total, b_ms, gflop


def _hc_shapes(net, cfg):
    from dc_tts_tpu_torch.models.blocks import HC, D, stack_in_channels
    from dc_tts_tpu_torch.models.ssrn import ssrn_specs
    from dc_tts_tpu_torch.models.text2mel import (audio_dec_specs,
                                                  audio_enc_specs,
                                                  text_enc_specs)
    out = []
    if net == "t2m":
        for specs, T, cin in ((text_enc_specs(cfg), cfg.max_N, cfg.e),
                              (audio_enc_specs(cfg), cfg.max_T, cfg.n_mels),
                              (audio_dec_specs(cfg), cfg.max_T, 2 * cfg.d)):
            out += [(sp, T, c) for sp, c in zip(specs,
                                                stack_in_channels(specs, cin))
                    if isinstance(sp, HC)]
    else:
        T = cfg.max_T
        specs = ssrn_specs(cfg)
        for sp, c in zip(specs, stack_in_channels(specs, cfg.n_mels)):
            if isinstance(sp, D):
                T *= 2
            elif isinstance(sp, HC):
                out.append((sp, T, c))
    return out


def _equivalence(net, cfg, params, batch):
    """The training loss and its gradients with use_pallas on and off at
    dropout 0 on one real batch (Text2Mel: its ids and teacher-forced mels,
    zero pads included; SSRN: its mels and magnitudes), each also against
    the plain route run in float64, and K4 at every HC block of that float64
    run.

    The training gradient is not a smooth function of the forward values:
    every ReLU's mask and the L1 term's sign(pred - target) switch where a
    value lies within rounding of the kink, and one switched element moves a
    weight gradient by up to ~1e-2 of its size. Two float32 routes that round
    the forward differently therefore differ at such elements by chance, and
    so does either of them from float64. The leaves are held to each other
    with those decisions frozen: each float32 route is run again with every
    ReLU mask and L1 sign taken from the float64 run (the forward changes
    only at the switched elements, by their rounding), which leaves the
    smooth rest, K4 included, to compare tightly. The runs with their own
    decisions are printed beside it: their distances to float64 and the
    number of decisions each switched.

    Returns a dict: loss (relative loss difference, on against off, own
    decisions), leaves (rows of (on - off, leaf, on - f64, off - f64), each
    max |.| over the leaf's max |value| in float64, decisions frozen), own
    (the same rows with each route's own decisions), flips ({route: its own
    decisions that differ from the float64 run's}), blocks (rows of (worst distance / tolerance, block) of K4
    at the float64 run's HC inputs and output cotangents, as phase K4)."""
    from dc_tts_tpu_torch.models import SSRN, Text2Mel
    from dc_tts_tpu_torch.models import blocks as BL
    from dc_tts_tpu_torch.train import losses
    from dc_tts_tpu_torch.train import steps as TS
    from dc_tts_tpu_torch.train.optimizer import tree_leaves, tree_map

    p64 = tree_map(lambda p: p.detach().double().requires_grad_(True),
                   params)
    act, l1_loss, apply_block = BL._act, losses.l1_loss, BL.apply_block
    decisions, seen = [], []
    run = {"mode": "f64", "i": 0, "flips": 0}

    def decide(d):
        """This kink's decision in the float64 run; counts the elements where
        the current run's own decision ``d`` differs from it."""
        if run["mode"] == "f64":
            decisions.append(d)
            return d
        ref = decisions[run["i"]]
        run["i"] += 1
        run["flips"] += int((ref != d).sum())
        return ref

    def relu(x, name):
        if name != "relu":
            return act(x, name)
        mask = decide(x.detach() > 0)
        return x * mask.to(x.dtype) if run["mode"] == "frozen" else act(x,
                                                                        name)

    def l1(pred, target):
        sign = decide(torch.sign((pred - target).detach()).to(torch.int8))
        if run["mode"] == "frozen":
            return torch.mean((pred - target) * sign.to(pred.dtype))
        return l1_loss(pred, target)

    def spy(p, spec, h, **kw):
        """apply_block, keeping each HC block's input and output in the
        float64 run."""
        y = apply_block(p, spec, h, **kw)
        if isinstance(spec, BL.HC) and run["mode"] == "f64":
            seen.append((spec, p, h.detach(), y))
        return y

    def loss_grads(use_pallas, p, dt, mode):
        run.update(mode=mode, i=0, flips=0)
        c = cfg.replace(use_pallas=use_pallas, dropout_rate=0.0)
        if net == "t2m":
            S = TS.teacher_forcing_shift(batch["mels"]).to(dt)
            logits, Y, align, _ = Text2Mel(c).apply(p, batch["texts"], S,
                                                    train=True)
            loss = losses.text2mel_loss(
                logits, Y, align, batch["mels"].to(dt), c,
                batch["text_lens"], batch["mel_lens"])[0]
        else:
            logits, Z = SSRN(c).apply(p, batch["mels"].to(dt), train=True)
            loss = losses.ssrn_loss(logits, Z, batch["mags"].to(dt), c)[0]
        leaves = tree_leaves(p)
        outs = [y for *_, y in seen] if mode == "f64" else []
        grads = torch.autograd.grad(loss, leaves + outs)
        return (loss.item(), [t.double() for t in grads[:len(leaves)]],
                grads[len(leaves):], run["flips"])

    BL._act, losses.l1_loss, BL.apply_block = relu, l1, spy
    try:
        ref = loss_grads(False, p64, torch.float64, "f64")
        own = {u: loss_grads(u, params, torch.float32, "own")
               for u in (True, False)}
        frozen = {u: loss_grads(u, params, torch.float32, "frozen")
                  for u in (True, False)}
    finally:
        BL._act, losses.l1_loss, BL.apply_block = act, l1_loss, apply_block

    def rows(on, off):
        out = []
        for n, a, b, r in zip(_leaf_names(params), on, off, ref[1]):
            m = max(float(r.abs().max()), 1e-30)
            out.append((float((a - b).abs().max()) / m, n,
                        float((a - r).abs().max()) / m,
                        float((b - r).abs().max()) / m))
        return out

    block_rows = []
    for i, ((spec, p, h, _), dy) in enumerate(zip(seen, ref[2])):
        args = [t.detach().float() for t in (
            h, p["conv"]["w"], p["conv"]["b"], p["ln1"]["gamma"],
            p["ln1"]["beta"], p["ln2"]["gamma"], p["ln2"]["beta"])]
        dist = _k4_distances(args, dy.float(),
                             (spec.size, spec.rate, spec.causal, cfg.ln_eps))
        block_rows.append((max(d[0] / d[2] for d in dist.values()),
                           f"{i}:HC({spec.size},{spec.rate})"))
    return dict(
        loss=abs(own[True][0] - own[False][0]) / abs(own[False][0]),
        leaves=rows(frozen[True][1], frozen[False][1]),
        own=rows(own[True][1], own[False][1]),
        flips={"on": own[True][3], "off": own[False][3]},
        blocks=block_rows)


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix.lstrip("/")]


def phase_train(results, net, data, feats, n_steps):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.data.dataset import (TrainLoader,
                                               compute_bucket_shapes,
                                               load_dataset_index)
    from dc_tts_tpu_torch.train import steps as TS
    from dc_tts_tpu_torch.train.__main__ import prefetch_to_device
    from dc_tts_tpu_torch.utils import profiling

    dev = torch.device(DEV)
    cfg = base_config().replace(data=data, use_pallas=True, B=B_TRAIN)
    examples = load_dataset_index(cfg, feats, data)
    buckets = compute_bucket_shapes(cfg, examples, feats, 2)
    loader = TrainLoader(cfg, examples, feats, seed=0, buckets=buckets)
    init, make = ((TS.init_text2mel_state, TS.make_text2mel_step)
                  if net == "t2m" else
                  (TS.init_ssrn_state, TS.make_ssrn_step))
    state = init(cfg, torch.Generator().manual_seed(0), dev)
    step = make(cfg, seed=1)
    gen = torch.Generator(device=dev)
    per_step = 28 if net == "t2m" else 8
    batches = prefetch_to_device(loader, dev)

    losses, shapes, full = [], [], None
    profiling.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        batch = next(batches)
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        shapes.append(tuple(batch["mels"].shape[1:2]))
        if batch["mels"].shape[1] == cfg.max_T:
            full = batch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = profiling.counts()
    launches = {k: n[k] for k in K4_LAUNCHES[:2]}
    loader.stop()
    by_shape = {}
    for sh, lo in zip(shapes, losses):
        by_shape.setdefault(sh, []).append(lo)
    # the loader's threads hand batches out in the order they finish, so a
    # bucket's share of the steps varies by a few from run to run: up to 5
    # of each bucket's first and last steps are compared
    descent = {str(sh[0]): (float(np.mean(v[:min(5, len(v) // 2)])),
                            float(np.mean(v[-min(5, len(v) // 2):])))
               for sh, v in by_shape.items() if len(v) >= 2}
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    ok = (launches["k4.fwd.launches"] == launches["k4.bwd.launches"]
          == per_step * n_steps
          and all(np.isfinite(losses)) and full is not None)
    if net == "t2m":
        # SSRN's few steps at the warm-up learning rate (~1e-6) move its
        # loss less than dropout does: only Text2Mel's descent is checked
        ok = ok and all(len(v) >= 4 for v in by_shape.values()) and all(
            b < a for a, b in descent.values())

    # ms/step on one full-grid batch, each reading the mean of TIME_STEPS
    # steps after one warm-up step, in the order on, off, off, on, on, off
    # and the peak device memory allocated over a reading's steps (MiB)
    times, peak = {True: [], False: []}, {True: 0.0, False: 0.0}
    for use_pallas in (True, False, False, True, True, False):
        s_ = make(cfg.replace(use_pallas=use_pallas), seed=1)
        state, _ = s_(state, full, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for _ in range(TIME_STEPS):
            state, _ = s_(state, full, gen)
        torch.cuda.synchronize()
        times[use_pallas].append((time.perf_counter() - t1) / TIME_STEPS
                                 * 1e3)
        peak[use_pallas] = max(peak[use_pallas],
                               torch.cuda.max_memory_allocated() / 2 ** 20)
    k4_ms, k4_bound, k4_gflop = _k4_step_ms(_hc_shapes(net, cfg), cfg.B)
    # the equivalence's batch and parameters follow from the seeds alone (one
    # loader thread hands batches out in the shuffle's order), so every run
    # compares the same numbers: the first full-grid batch, fresh parameters
    one = TrainLoader(cfg, examples, feats, seed=0, buckets=buckets,
                      num_threads=1)
    eq_batch = next(b for b in one if b["mels"].shape[1] == cfg.max_T)
    one.stop()
    eq = _equivalence(net, cfg,
                      init(cfg, torch.Generator().manual_seed(0), dev).params,
                      {k: torch.from_numpy(v).to(dev)
                       for k, v in eq_batch.items()})
    d_grad, worst = max(eq["leaves"])[:2]
    o_grad, o_worst = max(eq["own"])[:2]
    b_ratio, b_worst = max(eq["blocks"])
    ok = (ok and eq["loss"] <= 1e-5 and d_grad <= EQUIV_GRAD_TOL
          and b_ratio <= 1.0 and len(eq["blocks"]) == per_step)
    ms_on, ms_off = float(np.mean(times[True])), float(np.mean(times[False]))
    med = lambda rows, j: f"{np.median([r[j] for r in rows]):.2e}"  # noqa
    top = lambda rows, j: f"{max(r[j] for r in rows):.2e}"  # noqa
    line(f"train-{net}", ok=ok, steps=n_steps, B=cfg.B,
         buckets=json.dumps(buckets).replace(" ", ""),
         launches=json.dumps(launches).replace(" ", ""),
         launches_per_step=f"{launches['k4.fwd.launches'] / n_steps:g}",
         loss_first5=f"{first:.5f}", loss_last5=f"{last:.5f}",
         per_bucket_first_last=json.dumps(
             {k_: [round(a, 5), round(b, 5)] for k_, (a, b)
              in descent.items()}).replace(" ", ""),
         wall_s=f"{wall:.2f}", ms_per_step_pallas=f"{ms_on:.2f}",
         ms_per_step_plain=f"{ms_off:.2f}",
         ms_pallas_readings=",".join(f"{t:.2f}" for t in times[True]),
         ms_plain_readings=",".join(f"{t:.2f}" for t in times[False]),
         peak_mib_pallas=f"{peak[True]:.1f}",
         peak_mib_plain=f"{peak[False]:.1f}",
         k4_ms_per_step=f"{k4_ms:.2f}",
         k4_bound_ms_per_step=f"{k4_bound:.2f}",
         k4_gflop_per_step=f"{k4_gflop:.1f}",
         equiv_loss_rel=f"{eq['loss']:.2e}",
         frozen_grad_on_vs_off=f"{d_grad:.2e}", frozen_worst_leaf=worst,
         frozen_worst_on_vs_f64=top(eq["leaves"], 2),
         frozen_worst_off_vs_f64=top(eq["leaves"], 3),
         frozen_median_on_vs_f64=med(eq["leaves"], 2),
         frozen_median_off_vs_f64=med(eq["leaves"], 3),
         own_grad_on_vs_off=f"{o_grad:.2e}", own_worst_leaf=o_worst,
         own_worst_on_vs_f64=top(eq["own"], 2),
         own_worst_off_vs_f64=top(eq["own"], 3),
         own_median_on_vs_f64=med(eq["own"], 2),
         own_median_off_vs_f64=med(eq["own"], 3),
         switched_on=eq["flips"]["on"], switched_off=eq["flips"]["off"],
         leaves=len(eq["leaves"]), blocks_checked=len(eq["blocks"]),
         block_worst_dist_over_tol=f"{b_ratio:.2f}", block_worst=b_worst,
         tol=f"loss 1e-5, grads {EQUIV_GRAD_TOL:g} x max with the float64 "
             "run's decisions, each block as phase K4")
    if not ok:
        raise AssertionError(f"train-{net} failed: launches={launches} "
                             f"losses={losses} equiv={eq['loss']},{d_grad}"
                             f" blocks={b_ratio}")
    results[f"train-{net}"] = dict(
        losses=losses, launches=launches, ms_per_step_pallas=ms_on,
        ms_per_step_plain=ms_off, peak_mib_pallas=peak[True],
        peak_mib_plain=peak[False], k4_ms_per_step=k4_ms,
        k4_bound_ms_per_step=k4_bound,
        ms_pallas_readings=times[True], ms_plain_readings=times[False],
        equiv_loss_rel=eq["loss"], frozen_grad_on_vs_off=d_grad,
        own_grad_on_vs_off=o_grad, switched=eq["flips"],
        block_worst_dist_over_tol=b_ratio, wall_s=wall)
    total = results.setdefault("launches", {})
    for key, n in launches.items():
        total[key] = total.get(key, 0) + n
    del state
    torch.cuda.empty_cache()


# the training routes: float32 on torch matmuls (the baseline of the trace),
# then the reduced-precision and remat routes with use_pallas set (K4 takes
# bf16 operands under "bfloat16", never runs under "bfloat16_full"), and
# their steps per network
TRAIN_ROUTES = (("float32", dict(use_pallas=False)),
                ("bfloat16", dict(compute_dtype="bfloat16")),
                ("bfloat16_full", dict(compute_dtype="bfloat16_full")),
                ("remat", dict(remat=True)))
ROUTE_STEPS = {"t2m": 8, "ssrn": 4}


def _grads_close(a, b):
    """(worst max |a - b| over a leaf's max |b|, leaves bitwise equal)."""
    worst = max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                 1e-30)
                for x, y in zip(a, b))
    return worst, sum(bool(torch.equal(x, y)) for x, y in zip(a, b))


def phase_train_routes(results, data, feats):
    """Each route of TRAIN_ROUTES for both networks through the trainer's
    step, loader and prefetch on the full 180x210 grid: every launch count
    set to 0 just before the route's steps and read just after; every loss
    finite; ms/step on one batch, and one more step under torch.profiler
    (traces in chiprun_out/trace_train_*): its summed kernel time, and the
    device's idle share, 1 - that time over the untraced ms/step (the
    profiler slows the host, not the kernels); and for remat, one step's
    loss and gradients against the same step without remat (1e-5 x a
    leaf's max, the JAX package's bar; the leaves that come out bitwise
    equal are counted)."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.data.dataset import TrainLoader, load_dataset_index
    from dc_tts_tpu_torch.train import steps as TS
    from dc_tts_tpu_torch.train.__main__ import prefetch_to_device
    from dc_tts_tpu_torch.utils import profiling

    dev = torch.device(DEV)
    base = base_config().replace(data=data, use_pallas=True, B=B_TRAIN)
    examples = load_dataset_index(base, feats, data)
    per_block = {"t2m": 28, "ssrn": 8}
    for route, kw in TRAIN_ROUTES:
        cfg = base.replace(**kw)
        for net in ("t2m", "ssrn"):
            init, make, grads_fn = (
                (TS.init_text2mel_state, TS.make_text2mel_step,
                 TS.text2mel_grads) if net == "t2m" else
                (TS.init_ssrn_state, TS.make_ssrn_step, TS.ssrn_grads))
            loader = TrainLoader(cfg, examples, feats, seed=0)
            state = init(cfg, torch.Generator().manual_seed(0), dev)
            step = make(cfg, seed=1)
            gen = torch.Generator(device=dev)
            batches = prefetch_to_device(loader, dev)
            n = ROUTE_STEPS[net]
            losses = []
            torch.cuda.synchronize()
            profiling.reset_counts()
            for _ in range(n):
                batch = next(batches)
                state, metrics = step(state, batch, gen)
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            launches = profiling.counts()
            loader.stop()
            want = per_block[net] * n
            k4 = {k: launches.pop(k, 0) for k in K4_LAUNCHES}
            expect = {"float32": (0, 0, 0, 0),
                      "bfloat16": (want, want, want, want),
                      "bfloat16_full": (0, 0, 0, 0),
                      # the forward runs again in the recompute
                      "remat": (2 * want, want, 0, 0)}[route]
            ok = (tuple(k4.values()) == expect
                  and not any(launches.values())
                  and all(np.isfinite(losses)))
            # ms/step on the last batch, after a warm-up step on it; the
            # losses of these steps on one batch show whether it descends
            state, m0 = step(state, batch, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            same = [m0["loss"]]
            for _ in range(TIME_STEPS // 2):
                state, m = step(state, batch, gen)
                same.append(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / (TIME_STEPS // 2) * 1e3
            same = [float(v) for v in same]
            ok = ok and all(np.isfinite(same))
            # one more step under torch.profiler: the device's busy share
            with profiling.trace(os.path.join(
                    HERE, "chiprun_out",
                    f"trace_train_{route}_{net}")) as prof:
                t0 = time.perf_counter()
                state, _ = step(state, batch, gen)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            busy_ms, top = device_busy(prof, 4)
            ok = ok and busy_ms > 0
            extra = {}
            if route == "bfloat16":
                k4_ms, k4_bound = _k4_step_ms(_hc_shapes(net, cfg), cfg.B,
                                              True)[:2]
                extra["k4_bf16_ms_per_step"] = f"{k4_ms:.2f}"
                extra["k4_bf16_bound_ms_per_step"] = f"{k4_bound:.3f}"
                total = results.setdefault("launches", {})
                for key in K4_LAUNCHES[2:]:
                    total[key] = total.get(key, 0) + k4[key]
            if route == "remat":
                params = state.params
                runs = []
                for c in (cfg, cfg.replace(remat=False)):
                    gen.manual_seed(123)
                    m, g = grads_fn(c, params, batch, gen)
                    runs.append((float(m["loss"]), g))
                (l_r, g_r), (l_p, g_p) = runs
                worst, n_equal = _grads_close(g_r, g_p)
                ok = ok and abs(l_r - l_p) <= 1e-5 * abs(l_p) and \
                    worst <= 1e-5
                extra.update(loss_remat=f"{l_r:.6f}", loss_plain=f"{l_p:.6f}",
                             grad_remat_vs_plain=f"{worst:.2e}",
                             leaves_bitwise_equal=f"{n_equal}/{len(g_p)}")
            line(f"train-{route}", ok=ok, net=net, steps=n, B=cfg.B,
                 launches=json.dumps(k4).replace(" ", ""),
                 others_launched=sum(launches.values()),
                 losses=",".join(f"{v:.5f}" for v in losses),
                 one_batch_losses=",".join(f"{v:.5f}" for v in same),
                 one_batch_descending=bool(same[-1] < same[0]),
                 ms_per_step=f"{ms:.2f}", traced_step_ms=f"{traced_ms:.2f}",
                 device_busy_ms=f"{busy_ms:.2f}",
                 idle_share=f"{1 - busy_ms / ms:.3f}",
                 top_kernels=json.dumps(top).replace(" ", ""), **extra)
            if not ok:
                raise AssertionError(f"train-{route} {net}: launches {k4} "
                                     f"(want {expect}), {launches}, losses "
                                     f"{losses}, {extra}")
            results.setdefault("train-routes", {})[f"{route}-{net}"] = dict(
                losses=losses, one_batch_losses=same, launches=k4,
                ms_per_step=ms, traced_step_ms=traced_ms,
                device_busy_ms=busy_ms, top_kernels=top, **extra)
            del state, batch, batches
            torch.cuda.empty_cache()


def _package_env(**env_vars):
    """(working directory, environment) of a subprocess that imports the
    dc_tts_tpu_torch this run imported (``--package``'s, else this
    checkout's): ``python -m`` puts its working directory first on the
    path, and PYTHONPATH carries it to torchrun's workers."""
    import dc_tts_tpu_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        dc_tts_tpu_torch.__file__)))
    return root, dict(os.environ, PYTHONPATH=root + os.pathsep
                      + os.environ.get("PYTHONPATH", ""), **env_vars)


def _run(args, timeout=600, **env_vars):
    cwd, env = _package_env(**env_vars)
    r = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{' '.join(args[:2])} exited {r.returncode}:\n"
                             + r.stdout[-3000:] + r.stderr[-3000:])
    return r.stdout


def phase_train_cli(results, data, feats, root):
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.train import checkpoint as ckpt
    from dc_tts_tpu_torch.train import steps as TS

    cfg = base_config()
    t0 = time.perf_counter()
    logdirs = {n: os.path.join(root, f"logdir-{n}") for n in (1, 2)}
    for n in (1, 2):
        common = ["dc_tts_tpu_torch.train", str(n), "--data", data,
                  "--features", feats, "--logdir", logdirs[n],
                  "--ckpt-every", "2", "--log-every", "2", "--buckets", "2",
                  "--device", DEV, "--batch-size",
                  str(B_TRAIN)]
        _run(common + ["--max-steps", "4"])
        init = (TS.init_text2mel_state if n == 1 else TS.init_ssrn_state)(
            cfg, torch.Generator().manual_seed(0))
        want = set(ckpt._flatten({"params": init.params,
                                  "opt_state": init.opt_state})) | {
                                      "__step__"}
        path = os.path.join(logdirs[n], "model_gs_000k.npz")
        with np.load(path) as d:
            keys, step = set(d.files), int(d["__step__"])
        if keys != want or step != 4:
            raise AssertionError(f"train {n}: checkpoint keys/step wrong "
                                 f"({len(keys ^ want)} keys differ, step "
                                 f"{step})")
        out = _run(common + ["--max-steps", "6"])
        with np.load(path) as d:
            step = int(d["__step__"])
        if "resumed from step 4 (full checkpoint)" not in out or step != 6:
            raise AssertionError(f"train {n}: restart did not resume: "
                                 f"step {step}\n{out[-2000:]}")
    sent = os.path.join(root, "two.txt")
    with open(sent, "w") as f:
        f.write("header\n1. The birch canoe slid on the smooth planks.\n"
                "2. Glue the sheet to the dark blue background.\n")
    out_dir = os.path.join(root, "samples")
    _run(["dc_tts_tpu_torch.synthesize", "--sentences", sent, "--logdir1",
          logdirs[1], "--logdir2", logdirs[2], "--out", out_dir, "--device",
          DEV])
    wavs = sorted(os.listdir(out_dir))
    # the reduced precisions through the CLIs: bf16 training, bf16 SSRN
    bf_log = os.path.join(root, "logdir-bf16")
    _run(["dc_tts_tpu_torch.train", "1", "--data", data, "--features", feats,
          "--logdir", bf_log, "--dtype", "bfloat16", "--max-steps", "2",
          "--ckpt-every", "2", "--log-every", "1", "--buckets", "2",
          "--device", DEV, "--batch-size", str(B_TRAIN)])
    with open(os.path.join(bf_log, "metrics.jsonl")) as f:
        bf_losses = [json.loads(r)["loss"] for r in f if r.strip()]
    bf_dir = os.path.join(root, "samples-bf16")
    _run(["dc_tts_tpu_torch.synthesize", "--sentences", sent,
          "--random-weights", "--ssrn-precision", "bf16", "--out", bf_dir,
          "--device", DEV])
    bf_wavs = sorted(os.listdir(bf_dir))
    ok = (wavs == ["1.wav", "2.wav"] and bf_wavs == wavs
          and len(bf_losses) == 2 and all(np.isfinite(bf_losses))
          and os.path.exists(os.path.join(bf_log, "model_gs_000k.npz")))
    line("train-cli", ok=ok, wavs=wavs, keys=len(want),
         bf16_train_losses=",".join(f"{v:.5f}" for v in bf_losses),
         bf16_ssrn_wavs=bf_wavs, seconds=f"{time.perf_counter() - t0:.1f}")
    if not ok:
        raise AssertionError(f"synthesize wrote {wavs}, {bf_wavs}; bf16 "
                             f"train losses {bf_losses}")


def phase_synth_cli(root):
    """The synthesis CLI with the new flags, as subprocesses: each exits 0
    and writes the 40 wavs."""
    t0 = time.perf_counter()
    wrote = {}
    for name, flags in (("hybrid", ["--decode-precision", "hybrid"]),
                        ("reference", ["--mode", "reference"])):
        out_dir = os.path.join(root, f"samples-{name}")
        _run(["dc_tts_tpu_torch.synthesize", "--random-weights", "--out",
              out_dir, "--device", DEV, *flags])
        wrote[name] = len([f for f in os.listdir(out_dir)
                           if f.endswith(".wav")])
    ok = all(n == 40 for n in wrote.values())
    line("synth-cli", ok=ok, wavs=json.dumps(wrote).replace(" ", ""),
         seconds=f"{time.perf_counter() - t0:.1f}")
    if not ok:
        raise AssertionError(f"synthesize wrote {wrote}")


# ---------------------------------------------------------------------------
# the parallel modes (torch.distributed)


def _timed(fn):
    """(fn(), host seconds, every launch count) with the counts set to 0
    just before and the card synchronised on both sides."""
    from dc_tts_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    profiling.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, profiling.counts()


def _k12(launches):
    return {k: launches[k] for k in ("k1.launches", "k2.launches")}


def _parallel_rank(rank, n, ts_ids, pipe_ids, Z1):
    """One of two gloo ranks on cuda:0: synthesize_time_sharded over both,
    the time-sharded vocoder on the one-shard run's Z (Z1), then
    PipelinedSynthesizer 1 + 1 at microbatch 2 (one warm-up microbatch
    first)."""
    from dc_tts_tpu_torch import base_config
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.parallel.mesh import make_mesh
    from dc_tts_tpu_torch.parallel.sp_gl import (time_sharded_vocoder,
                                                 time_slice)
    from dc_tts_tpu_torch.pipeline import (PipelinedSynthesizer,
                                           synthesize_time_sharded)
    cfg = base_config()
    p1, p2 = seeded_nets(cfg)
    (wav, _, Z, _), ts_s, ts_n = _timed(
        lambda: synthesize_time_sharded(cfg, p1, p2, ts_ids, device=DEV))
    mesh = make_mesh()
    voc = time_sharded_vocoder(time_slice(torch.as_tensor(Z1, device=DEV),
                                          mesh), cfg, mesh)
    pipe = PipelinedSynthesizer(cfg, p1, p2, microbatch=2, device=DEV)
    pipe.synthesize_ids(pipe_ids[:2])
    pw, pipe_s, pipe_n = _timed(lambda: pipe.synthesize_ids(pipe_ids))
    return {"ts_wav": wav.cpu().numpy(), "ts_s": ts_s, "ts": _k12(ts_n),
            "ts_Z": Z.cpu().numpy() if rank == 0 else None,
            "voc_wav": voc.cpu().numpy(),
            "pipe_wav": pw, "pipe_s": pipe_s, "pipe": _k12(pipe_n)}


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _dp_train(mesh):
    """3 Text2Mel and 3 SSRN steps on one seeded full-grid batch (B=32,
    use_pallas), through the one-rank NCCL group and without it, from the
    same initial parameters: every leaf within 1e-6 x its max (bitwise
    expected: one rank's sum is its own value)."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.train import steps as TS
    from dc_tts_tpu_torch.train.optimizer import tree_leaves

    cfg = base_config().replace(use_pallas=True)
    rng = np.random.default_rng(0)
    B, N, T = B_TRAIN, cfg.max_N, cfg.max_T
    batches = {
        "t2m": {"texts": rng.integers(1, cfg.vocab_size, (B, N)),
                "mels": rng.uniform(size=(B, T, cfg.n_mels)),
                "text_lens": np.full((B,), N), "mel_lens": np.full((B,), T)},
        "ssrn": {"mels": rng.uniform(size=(B, T, cfg.n_mels)),
                 "mags": rng.uniform(size=(B, T * cfg.r, cfg.n_freq))}}
    out = {}
    for net, (init, make) in (
            ("t2m", (TS.init_text2mel_state, TS.make_text2mel_step)),
            ("ssrn", (TS.init_ssrn_state, TS.make_ssrn_step))):
        batch = {k: torch.as_tensor(v, device=DEV).to(
            torch.long if v.dtype.kind == "i" else torch.float32)
            for k, v in batches[net].items()}
        # one step first, so that neither timed run pays the first launch
        warm = init(cfg, torch.Generator().manual_seed(0), DEV)
        make(cfg, seed=1)(warm, batch, torch.Generator(device=DEV))
        runs = {}
        for name, group in (("plain", None), ("dp", mesh.groups["data"])):
            state = init(cfg, torch.Generator().manual_seed(0), DEV)
            if group is not None:
                TS.replicate_state(state, mesh)
            step = make(cfg, seed=1, group=group)
            drop = torch.Generator(device=DEV)

            def steps():
                nonlocal state
                for _ in range(3):
                    state, m = step(state, batch, drop)
                return float(m["loss"])

            loss, secs, n = _timed(steps)
            runs[name] = dict(loss=loss, ms_step=secs / 3 * 1e3,
                              k4=n["k4.fwd.launches"] + n["k4.bwd.launches"],
                              leaves=[t.detach().clone() for t in
                                      tree_leaves(state.params)])
        a, b = runs["dp"].pop("leaves"), runs["plain"].pop("leaves")
        worst = max(_max_rel(x, y) for x, y in zip(a, b))
        bitwise = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
        ok = worst <= 1e-6 and runs["dp"]["loss"] == runs["plain"]["loss"] \
            and runs["dp"]["k4"] == runs["plain"]["k4"] > 0
        line(f"parallel-dp-train-{net}", ok=ok, steps=3, batch=B,
             max_rel_vs_plain=f"{worst:.3e}", tol="1e-6 x max",
             bitwise_leaves=f"{bitwise}/{len(a)}",
             loss=f"{runs['dp']['loss']:.6f}",
             ms_step=f"{runs['dp']['ms_step']:.2f}",
             plain_ms_step=f"{runs['plain']['ms_step']:.2f}",
             k4_launches=runs["dp"]["k4"])
        if not ok:
            raise AssertionError(f"data-parallel {net} steps differ from "
                                 f"the plain ones: {worst:.3e}, {runs}")
        out[net] = dict(runs, max_rel=worst, bitwise=bitwise,
                        leaves=len(a))
    return out


def phase_parallel(results, smi):
    """The parallel modes: on NCCL, one rank (a file store in a temporary
    directory), data-parallel synthesis of the 40 sentences (bitwise the
    single-card pcm16), data-parallel training steps, and the time-sharded
    synthesis over one shard; then two gloo ranks spawned on cuda:0 (NCCL
    takes one rank a card), the time-sharded synthesis over two shards and
    the pipeline 1 + 1; then the CLI under torchrun, one rank. Times are
    for information: two ranks share one card."""
    import torch.distributed as dist
    from dc_tts_tpu_torch import Synthesizer, base_config
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.parallel import distributed as D
    from dc_tts_tpu_torch.parallel.mesh import make_mesh
    from dc_tts_tpu_torch.pipeline import synthesize_time_sharded

    t_phase = time.perf_counter()
    cfg = base_config()
    p1, p2 = seeded_nets(cfg)
    ids = harvard_ids(cfg, 40)
    want = Synthesizer(cfg, p1, p2, pcm16=True, device=DEV
                       ).synthesize_ids_chunked(ids, CHUNK)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        assert D.initialize(num_processes=1, process_id=0, device=DEV,
                            init_method="file://" + os.path.join(tmp, "s"))
        try:
            mesh = make_mesh()
            backend = dist.get_backend(mesh.groups["data"])
            dp = Synthesizer(cfg, p1, p2, pcm16=True, mesh=mesh, device=DEV)
            dp.synthesize_ids_chunked(ids[:CHUNK], CHUNK)        # warm-up
            got, wall, n = _timed(
                lambda: dp.synthesize_ids_chunked(ids, CHUNK))
            ok = (backend == ("nccl" if DEV == "cuda" else "gloo")
                  and got.dtype == want.dtype
                  and np.array_equal(got, want) and n["k1.launches"] == 2
                  and n["k2.launches"] == 2)
            line("parallel-dp-synth", ok=ok, backend=backend, ranks=1,
                 equal_to_single_card=np.array_equal(got, want),
                 launches=json.dumps(_k12(n)).replace(" ", ""),
                 wall_s=f"{wall:.3f}",
                 audio_s_per_s=f"{got.size / cfg.sr / wall:.1f}")
            if not ok:
                raise AssertionError(f"data-parallel synthesis: {backend}, "
                                     f"{_k12(n)}, equal "
                                     f"{np.array_equal(got, want)}")
            out["dp_synth"] = dict(wall_s=wall, launches=_k12(n))
            out["dp_train"] = _dp_train(mesh)
            ts_ids = ids[:2]
            (w1, _, Z1, _), ts_s, n = _timed(
                lambda: synthesize_time_sharded(cfg, p1, p2, ts_ids,
                                                device=DEV))
            rw = Synthesizer(cfg.replace(stft_method="dft"), p1, p2,
                             ssrn_precision="highest", device=DEV
                             ).synthesize_ids(ts_ids)[0]
            d1 = _max_rel(w1, rw)
            ok = d1 <= 1e-4 and n["k1.launches"] == 1 \
                and n["k2.launches"] == 0
            line("parallel-ts1", ok=ok, shards=1, max_rel_vs_unsharded=
                 f"{d1:.3e}", tol="1e-4 x max (float32 SSRN, dft GL)",
                 launches=json.dumps(_k12(n)).replace(" ", ""),
                 seconds=f"{ts_s:.3f}")
            if not ok:
                raise AssertionError(f"one-shard time-sharded synthesis: "
                                     f"{d1:.3e}, {_k12(n)}")
            out["ts1"] = dict(max_rel=d1, seconds=ts_s, launches=_k12(n))
        finally:
            dist.destroy_process_group()
    Z1 = Z1.cpu().numpy()
    ranks = D.run_ranks(_parallel_rank, 2, (ids[:2], ids[:4], Z1),
                        backend="gloo", device=RANKS_DEV, timeout=600)
    w1 = w1.cpu().numpy()
    # the vocoder's gate (tests/test_sp_gl.py's) holds on the same
    # magnitudes: SSRN's products on half the frames reduce in another
    # order, and Griffin-Lim and de-emphasis amplify Z's ~1e-6 about 1000x
    d_voc = max(float(np.abs(r["voc_wav"] - w1).max()) for r in ranks)
    dw = max(float(np.abs(r["ts_wav"] - w1).max()) for r in ranks)
    dz = float(np.abs(ranks[0]["ts_Z"] - Z1).max())
    ok = (d_voc <= 2e-3 and dz <= 2e-5
          and ranks[0]["ts"] == {"k1.launches": 1, "k2.launches": 0}
          and ranks[1]["ts"] == {"k1.launches": 0, "k2.launches": 0})
    line("parallel-ts2", ok=ok, shards=2, backend="gloo", device=RANKS_DEV,
         max_dwav_same_Z=f"{d_voc:.3e}", max_dZ=f"{dz:.3e}",
         tol="wav on the same Z 2e-3, Z 2e-5",
         max_dwav_end_to_end=f"{dw:.3e}",
         launches=json.dumps([r["ts"] for r in ranks]).replace(" ", ""),
         seconds=f"{ranks[0]['ts_s']:.3f}")
    if not ok:
        raise AssertionError(f"two-shard time-sharded synthesis: "
                             f"{d_voc:.3e}, {dz:.3e}, "
                             f"{[r['ts'] for r in ranks]}")
    # like for like: the single card on the pipeline's microbatches
    single = Synthesizer(cfg, p1, p2, device=DEV).synthesize_ids_chunked(
        ids[:4], 2)
    dp_ = max(float(np.abs(r["pipe_wav"] - single).max()) for r in ranks)
    ok = (dp_ <= 2e-3
          and ranks[0]["pipe"] == {"k1.launches": 2, "k2.launches": 0}
          and ranks[1]["pipe"] == {"k1.launches": 0, "k2.launches": 2})
    line("parallel-pipeline", ok=ok, stages="1+1", microbatch=2,
         sentences=4, max_dwav_vs_single_card=f"{dp_:.3e}", tol="2e-3",
         launches=json.dumps([r["pipe"] for r in ranks]).replace(" ", ""),
         seconds=f"{ranks[0]['pipe_s']:.3f}")
    if not ok:
        raise AssertionError(f"pipeline: {dp_:.3e}, "
                             f"{[r['pipe'] for r in ranks]}")
    out["ts2"] = dict(max_dwav_same_Z=d_voc, max_dwav=dw, max_dZ=dz,
                      seconds=ranks[0]["ts_s"],
                      launches=[r["ts"] for r in ranks])
    out["pipeline"] = dict(max_dwav=dp_, seconds=ranks[0]["pipe_s"],
                           launches=[r["pipe"] for r in ranks])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cwd, env = _package_env()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "dc_tts_tpu_torch.synthesize",
             "--random-weights", "--mesh", "--device", DEV, "--out", tmp],
            cwd=cwd, env=env,
            capture_output=True, text=True, timeout=600)
        wavs = len([f for f in os.listdir(tmp) if f.endswith(".wav")])
        cli_s = time.perf_counter() - t0
    ok = r.returncode == 0 and wavs == 40
    line("parallel-cli", ok=ok, command="torchrun --nproc-per-node 1 -m "
         "dc_tts_tpu_torch.synthesize --mesh", wavs=wavs,
         seconds=f"{cli_s:.1f}")
    if not ok:
        raise AssertionError(f"torchrun synthesize --mesh exited "
                             f"{r.returncode}, {wavs} wavs:\n"
                             + r.stdout[-3000:] + r.stderr[-3000:])
    secs = time.perf_counter() - t_phase
    line("parallel", ok=True, seconds=f"{secs:.1f}", card=repr(smi),
         note="times for information: two ranks time-slice one card")
    results["parallel"] = dict(out, cli_s=cli_s, seconds=secs)


# ---------------------------------------------------------------------------
# tensor parallelism: two model ranks on the one card

# (network, compute_dtype, steps) of phase parallel-tp, all with use_pallas
TP_RUNS = (("t2m", "float32", 2), ("ssrn", "float32", 2),
           ("t2m", "bfloat16", 1), ("ssrn", "bfloat16", 1))
B_TP = 8         # every gather of the two gloo ranks crosses the host


def _tp_batch(net, cfg):
    """A seeded full-grid batch of B_TP rows on the card."""
    rng = np.random.default_rng(0)
    B, N, T = B_TP, cfg.max_N, cfg.max_T
    if net == "t2m":
        b = {"texts": rng.integers(1, cfg.vocab_size, (B, N)),
             "mels": rng.uniform(size=(B, T, cfg.n_mels)),
             "text_lens": np.full((B,), N), "mel_lens": np.full((B,), T)}
    else:
        b = {"mels": rng.uniform(size=(B, T, cfg.n_mels)),
             "mags": rng.uniform(size=(B, T * cfg.r, cfg.n_freq))}
    return {k: torch.as_tensor(v, device=DEV).to(
        torch.long if v.dtype.kind == "i" else torch.float32)
        for k, v in b.items()}


@contextlib.contextmanager
def _kinks(mode, seq):
    """Within it every ReLU mask and L1 sign of the networks and losses is
    recorded into the list ``seq`` (mode "record") or replayed from it in
    the same order ("replay"); yields {"flips": the elements where a
    replaying run's own decision differs}. Two runs that round the forward
    differently switch such decisions where a value lies within rounding of
    its kink (see _equivalence); with them replayed the rest compares
    tightly. A replayed ReLU is x * mask and a replayed L1 term mean((pred -
    target) * sign): the same values and gradients where the decisions
    agree."""
    from dc_tts_tpu_torch.models import blocks as BL
    from dc_tts_tpu_torch.train import losses
    act, l1_loss = BL._act, losses.l1_loss
    state = {"i": 0, "flips": 0}

    def decide(d):
        if mode == "record":
            seq.append(d)
            return None
        ref = seq[state["i"]]
        state["i"] += 1
        state["flips"] += int((ref != d).sum())
        return ref

    def relu(x, name):
        if name != "relu":
            return act(x, name)
        mask = decide(x.detach() > 0)
        return act(x, name) if mask is None else x * mask.to(x.dtype)

    def l1(pred, target):
        sign = decide(torch.sign((pred - target).detach()).to(torch.int8))
        if sign is None:
            return l1_loss(pred, target)
        return torch.mean((pred - target) * sign.to(pred.dtype))

    BL._act, losses.l1_loss = relu, l1
    try:
        yield state
    finally:
        BL._act, losses.l1_loss = act, l1_loss


def _tp_train(net, cfg, params_cpu, batch, steps, mesh=None):
    """The step-1 loss and gradients, then ``steps`` steps from the given
    whole parameters (on one rank without a mesh, else tensor-parallel over
    its model group), the counts set to 0 just before the steps and read
    just after -> (loss, whole gradients, whole parameters, K4's launches
    by key, ms/step on the host clock). Call it under ``_kinks``."""
    from dc_tts_tpu_torch.params import requires_grad
    from dc_tts_tpu_torch.parallel.tp import gather_params
    from dc_tts_tpu_torch.train import steps as TS
    from dc_tts_tpu_torch.train.optimizer import (init_opt_state,
                                                  tree_leaves, tree_map,
                                                  tree_unflatten)
    params = tree_map(lambda t: t.to(DEV, copy=True), params_cpu)
    requires_grad(params)
    state = TS.TrainState(params, init_opt_state(params), 0)
    mg = None
    if mesh is not None:
        state, mg = TS.shard_state(state, mesh), mesh.groups["model"]
    grads_fn, make = ((TS.text2mel_grads, TS.make_text2mel_step)
                      if net == "t2m" else (TS.ssrn_grads, TS.make_ssrn_step))
    gen = torch.Generator(device=DEV).manual_seed(TS.step_seed(1, 0))
    m, grads = grads_fn(cfg, state.params, batch, gen, None, mg)
    grads = tree_unflatten(state.params, [g.detach() for g in grads])
    step = make(cfg, seed=1, model_group=mg)

    def run():
        nonlocal state
        for _ in range(steps):
            state, _ = step(state, batch, gen)

    _, secs, n = _timed(run)
    k4 = {k: n[k] for k in K4_LAUNCHES}
    if mesh is not None:
        grads = gather_params(grads, mesh)
        params = gather_params(state.params, mesh)
    else:
        params = state.params
    return (float(m["loss"]), tree_leaves(grads),
            [t.detach() for t in tree_leaves(params)], k4,
            secs / steps * 1e3)


def _tp_gaps(got, want, lr_sum):
    """The distances tests/test_torch_tp.py gates: the loss's relative; the
    step-1 gradients' worst max |d| over a leaf's max |value| and their
    relative L2 over all leaves; the parameters' worst max |d| over
    (1e-5 x a leaf's max + 0.1 x the steps' summed learning rates), and
    how many gradient leaves are bitwise equal."""
    (loss, g, p), (wloss, wg, wp) = got, want
    num = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(g, wg))
    den = sum(float((b.double() ** 2).sum()) for b in wg)
    gl = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
          for a, b in zip(g, wg)]
    pl = [float((a - b).abs().max())
          / (1e-5 * float(b.abs().max()) + 0.1 * lr_sum)
          for a, b in zip(p, wp)]
    i, k = int(np.argmax(gl)), int(np.argmax(pl))
    return dict(
        loss_rel=abs(loss - wloss) / abs(wloss),
        grad_leaf=gl[i], grad_leaf_at=(i, float(wg[i].abs().max())),
        grad_l2=(num / den) ** 0.5,
        grad_bitwise=sum(bool(torch.equal(a, b)) for a, b in zip(g, wg)),
        leaves=len(wg), param=pl[k], param_at=k,
        grad_max=max(float(b.abs().max()) for b in wg),
        params_finite=all(bool(torch.isfinite(a).all()) for a in p))


def _tp_rank(rank, n):
    """One of two gloo ranks on cuda:0, a data 1 x model 2 grid: each run
    of TP_RUNS from the same seeded whole parameters (base_config(), B_TP,
    use_pallas), rank 0 first on its own as the one-rank reference, then
    both ranks tensor-parallel; rank 0 measures the distances."""
    from dc_tts_tpu_torch.bench import seeded_nets
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.parallel.mesh import make_mesh
    from dc_tts_tpu_torch.train.optimizer import noam_lr
    import torch.distributed as dist
    mesh = make_mesh(data=1, model=2)
    init = dict(zip(("t2m", "ssrn"), seeded_nets(base_config())))
    out = {}
    for net, dtype, steps in TP_RUNS:
        cfg = base_config().replace(use_pallas=True, B=B_TP,
                                    compute_dtype=dtype)
        batch = _tp_batch(net, cfg)
        ref, seq = None, [None]
        if rank == 0:
            seq[0] = []
            with _kinks("record", seq[0]):
                ref = _tp_train(net, cfg, init[net], batch, steps)
            seq[0] = [d.cpu() for d in seq[0]]
        # the one-rank run's decisions, replayed on both ranks
        dist.broadcast_object_list(seq, src=mesh.ranks["model"][0],
                                   group=mesh.groups["model"])
        with _kinks("replay", [d.to(DEV) for d in seq[0]]) as kinks:
            tp = _tp_train(net, cfg, init[net], batch, steps, mesh)
        r = dict(loss=tp[0], k4=tp[3], ms_step=tp[4], flips=kinks["flips"],
                 decisions=sum(d.numel() for d in seq[0]))
        if ref is not None:
            lr_sum = sum(float(noam_lr(s, cfg.lr, cfg.warmup_steps))
                         for s in range(steps))
            r.update(_tp_gaps(tp[:3], ref[:3], lr_sum), ref_k4=ref[3],
                     ref_ms_step=ref[4])
            names = _leaf_names(init[net])
            r["grad_leaf_at"] = (names[r["grad_leaf_at"][0]],
                                 r["grad_leaf_at"][1])
            r["param_at"] = names[r["param_at"]]
        out[f"{net}-{dtype}"] = r
        del ref, tp
        torch.cuda.empty_cache()
    return out


def phase_parallel_tp(results, smi):
    """Tensor parallelism: two gloo ranks spawned on cuda:0 (NCCL takes
    one rank a card) train both networks over a model axis of 2 at
    base_config() widths, use_pallas: 2 float32 steps (K4) and 1 bfloat16
    step (K4's bf16 body) each, held against the one-rank steps on the same
    card and batch, with the one-rank run's ReLU masks and L1 signs
    replayed (_kinks; the switched ones counted), at tests/test_torch_tp.py's
    gates but for the bf16 gradients' relative L2, 3e-2 here: on the card a
    half-width product takes another cuBLAS kernel, so the forward too
    rounds differently in float32 and flips bf16 roundings of the next
    block's operands (on the CPU the forward is bitwise one rank's). K4's
    launches per rank equal the one-rank steps'. The ms/step are for
    information: two ranks time-slice one card and every gather crosses
    the host."""
    from dc_tts_tpu_torch.parallel import distributed as D
    t0 = time.perf_counter()
    ranks = D.run_ranks(_tp_rank, 2, (), backend="gloo", device=RANKS_DEV,
                        timeout=600)
    per_step = {"t2m": 28, "ssrn": 8}
    out = {}
    for net, dtype, steps in TP_RUNS:
        key = f"{net}-{dtype}"
        r0, r1 = ranks[0][key], ranks[1][key]
        bf16 = dtype == "bfloat16"
        on = K4_LAUNCHES[:4 if bf16 else 2]
        want = {k: per_step[net] * steps if k in on else 0
                for k in K4_LAUNCHES}
        if bf16:
            close = r0["grad_l2"] <= 3e-2 and r0["grad_leaf"] <= 5e-2 \
                and r0["params_finite"]
        else:
            close = r0["grad_leaf"] <= 1e-5 and r0["param"] <= 1.0
        ok = (close and r0["loss_rel"] <= 1e-6 and r0["ref_k4"] == want
              and r0["k4"] == want and r1["k4"] == want)
        line(f"parallel-tp-{key}", ok=ok, model=2, backend="gloo",
             device=RANKS_DEV, batch=B_TP, steps=steps,
             loss=f"{r0['loss']:.6f}", loss_rel=f"{r0['loss_rel']:.3e}",
             grad_leaf=f"{r0['grad_leaf']:.3e}",
             grad_l2=f"{r0['grad_l2']:.3e}",
             grad_bitwise=f"{r0['grad_bitwise']}/{r0['leaves']}",
             grad_leaf_at=r0["grad_leaf_at"][0],
             flips=f"{r0['flips']}/{r0['decisions']}",
             param_over_gate=f"{r0['param']:.3e}",
             tol=("loss 1e-6 rel, grads l2 3e-2 and 5e-2 x leaf max" if bf16
                  else "loss 1e-6 rel, grads 1e-5 x leaf max, params "
                  "1e-5 x leaf max + 0.1 x the steps' lr"),
             k4_launches=json.dumps([r0["k4"], r1["k4"]]).replace(" ", ""),
             one_rank_k4=json.dumps(r0["ref_k4"]).replace(" ", ""),
             ms_step=f"{r0['ms_step']:.1f},{r1['ms_step']:.1f}",
             one_rank_ms_step=f"{r0['ref_ms_step']:.1f}")
        out[key] = dict(rank0=r0, rank1=r1, ok=ok)
    bad = {k: v for k, v in out.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"tensor-parallel runs off their gates: {bad}")
    secs = time.perf_counter() - t0
    line("parallel-tp", ok=True, seconds=f"{secs:.1f}", card=repr(smi),
         note="times for information: two ranks time-slice one card")
    results["parallel-tp"] = dict(out, seconds=secs)


# ---------------------------------------------------------------------------
# X1-X4: the forward-rDFT prototypes of scripts/ct_kernel_exp.py


CT_F, CT_F_TILED, CT_TF = 840, 1024, 512
# operations a frame, by stage: A (the 16-point DFT of the real frame), W
# (the twiddles: 4 multiplies and 2 adds a complex product), C (four
# 128-deep products and two adds per output pair); T moves data only
CT_STAGE_FLOPS = {"A": 2 * 2 * 16 * 16 * 128, "W": 6 * 16 * 128,
                  "C": 4 * 2 * 16 * 128 * 128 + 2 * 16 * 128}
CT_STAGE_CONSTS = {"A": ("C16", "S16"), "W": ("Tc", "Ts"),
                   "C": ("C128", "S128")}
_CT_ERR = re.compile(r"^\[(\S+)/(\S+)\] rel err (\S+)$", re.M)
_CT_MS = re.compile(r"^\[(\S+)/(\S+)\] (\S+) ms/call  (\S+) ms/call in-loop$",
                    re.M)
_CT_ABLATE = re.compile(r"^stages=(\S+)\s+(\S+) ms/call$", re.M)


def _ct_bound(kernel, x, m, outs, bf16, covered, stages, peak=None):
    """(ms, by): each input read once (the covered frames of x, the
    constants the stages read) and each output written once, against the
    operations of each stage at its own peak (X1's GEMM and stage C on the
    bf16 tensor cores in bf16 mode, the rest at the float32 rate). ``peak``:
    the rate of those two stages' operations instead (float32's three TF32
    passes: PEAK_TF32 / 3)."""
    peak = peak or (PEAK_BF16 if bf16 else PEAK_FP32)
    if kernel == "full_fwd":
        n_bytes = nbytes(x, m["CF"], m["SF"], *outs)
        t_ops = 2.0 * x.shape[0] * 2048 * 2 * 1025 / peak
    else:
        n_bytes = nbytes(x[:covered], *outs, *(
            m[k] for s in stages for k in CT_STAGE_CONSTS.get(s, ())))
        t_ops = covered * sum(CT_STAGE_FLOPS[s] / (peak if s == "C" else
                                                   PEAK_FP32)
                              for s in stages if s in CT_STAGE_FLOPS)
    tb, to = n_bytes / PEAK_BYTES * 1e3, t_ops * 1e3
    return (to, "operations") if to >= tb else (tb, "bytes")


def _ct_cli(argv, F):
    """The CLI's main in this process (CT_F = F); its printed lines."""
    import contextlib
    import io
    from dc_tts_tpu_torch.scripts import ct_kernel_exp as CLI
    buf, old = io.StringIO(), os.environ.get("CT_F")
    os.environ["CT_F"] = str(F)
    try:
        with contextlib.redirect_stdout(buf):
            rc = CLI.main(argv)
    finally:
        if old is None:
            del os.environ["CT_F"]
        else:
            os.environ["CT_F"] = old
    if rc != 0:
        raise AssertionError(f"ct_kernel_exp {argv} returned {rc}")
    return buf.getvalue()


def _ct_cli_check(out, variant, prec):
    """The rel err and times a CLI run printed; raises unless it printed
    them once each, the rel err within the float64-FFT gate."""
    errs = [e for v, p, e in _CT_ERR.findall(out) if (v, p) == (variant,
                                                                prec)]
    ms = [t[2:] for t in _CT_MS.findall(out) if t[:2] == (variant, prec)]
    gate = 5e-3 if prec == "bf16" else 2e-6
    if len(errs) != 1 or len(ms) != 1 or float(errs[0]) > gate:
        raise AssertionError(f"ct_kernel_exp {variant} {prec}: rel err "
                             f"{errs} (gate {gate}), times {ms}:\n{out}")
    return float(errs[0]), float(ms[0][0]), float(ms[0][1])


def _ct_ablate_check(out):
    from dc_tts_tpu_torch.ops.ct_fwd import STAGE_SETS
    got = dict(_CT_ABLATE.findall(out))
    want = [s or "-" for s in STAGE_SETS]
    if sorted(got) != sorted(want):
        raise AssertionError(f"ct_kernel_exp ablate printed {got}:\n{out}")
    return {s: float(t) for s, t in got.items()}


def phase_ct_fwd(results):
    """X1-X4 against their plain versions and float64 FFT, their times,
    then the CLI: in this process with the counts reset (the main path),
    and as subprocesses."""
    from dc_tts_tpu_torch.ops import ct_fwd as X
    from dc_tts_tpu_torch.scripts import ct_kernel_exp as CLI
    from dc_tts_tpu_torch.utils import profiling

    dev = torch.device(DEV)
    # milliseconds a launch inside a CUDA graph of 50 (the device's time),
    # and a call from the host
    looped = lambda fn, x, m: CLI.timeit_looped(fn, x, m) * 1e3  # noqa
    call = lambda fn: CLI.timeit(fn, 20) * 1e3  # noqa: E731
    cases, libs = [], {}
    for F in (CT_F, CT_F_TILED):
        x_np = CLI.frames(F)
        ref = np.fft.fft(x_np.astype(np.float64), axis=-1)
        x = torch.from_numpy(x_np).to(dev)
        # yardsticks, never called by the port: cuFFT on these frames (and
        # on X4's covered ones), cuBLAS on X1's GEMM
        libs[F] = lib = {
            "rfft": looped(lambda x_, m_: torch.fft.rfft(x_), x, None),
            "fft": looped(lambda x_, m_: torch.fft.fft(x_), x, None)}
        covered = F // CT_TF * CT_TF      # X4's whole tiles
        if F == CT_F:
            xc = x[:covered].contiguous()
            lib["fft_covered"] = looped(lambda x_, m_: torch.fft.fft(x_),
                                        xc, None)
            lib["rfft_covered"] = looped(lambda x_, m_: torch.fft.rfft(x_),
                                         xc, None)
        for bf16 in (True, False):
            m = X.consts(bf16, dev)
            prec = "bf16" if bf16 else "f32"
            if F == CT_F:
                xa = x.bfloat16() if bf16 else x
                # the GEMM x @ [CF, SF] interleaved, (2048, npad)
                w = torch.zeros(2048, X._NPAD, device=dev, dtype=xa.dtype)
                w[:, 0:2 * X.NF:2], w[:, 1:2 * X.NF:2] = m["CF"], m["SF"]
                lib["cublas_" + prec] = looped(lambda x_, m_: x_ @ w, xa,
                                               None)
                todo = [("full_fwd", "full", F, "TAWC",
                         lambda x_, m_: X.full_fwd(x_, m_, bf16),
                         lambda x_, m_: X.full_fwd_plain(x_, m_, bf16))]
                for mode in ("swap", "stack"):
                    todo.append(("fact_fwd", mode, F, "TAWC",
                                 lambda x_, m_, t=mode: X.fact_fwd(
                                     x_, m_, bf16, t),
                                 lambda x_, m_: X.fact_fwd_plain(x_, m_,
                                                                 bf16)))
                for st in X.STAGE_SETS:
                    todo.append(("ablate_fwd", st or "-", covered, st,
                                 lambda x_, m_, s=st: X.ablate_fwd(
                                     x_, m_, bf16, s, CT_TF),
                                 lambda x_, m_, s=st: X.ablate_fwd_plain(
                                     x_, m_, bf16, s, CT_TF)))
            else:
                todo = [("fact_fwd_tiled", f"tf{CT_TF}", F, "TAWC",
                         lambda x_, m_: X.fact_fwd_tiled(x_, m_, bf16,
                                                         CT_TF),
                         lambda x_, m_: X.fact_fwd_tiled_plain(
                             x_, m_, bf16, CT_TF))]
            for kernel, label, covered, stages, kfn, pfn in todo:
                got, want = kfn(x, m), pfn(x, m)
                scale = float(np.abs(ref[:covered]).max())
                # both outputs, on the covered frames (rows of X1's (F,
                # 1025), the middle axis of the (16, F, 128) layout)
                d = max(float((g[..., :covered, :] - w_[..., :covered, :])
                              .abs().max()) for g, w_ in zip(got, want))
                gate = 1e-3 if (bf16 and kernel != "full_fwd"
                                and "C" in stages) else 1e-5
                # the CLI's rel err, on the covered frames
                rel_fft = (CLI.rel_err(
                    "full" if kernel == "full_fwd" else "fact",
                    [g[..., :covered, :] for g in got], ref[:covered])
                    if stages == "TAWC" else None)
                gate_fft = 5e-3 if bf16 else 2e-6
                zero = kernel != "ablate_fwd" or max(
                    float(g[:, covered:].abs().max()) for g in got) == 0.0
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                b_ms, b_by = _ct_bound(kernel, x, m, got, bf16, covered,
                                       stages)
                # float32 on the tensor cores: three TF32 passes
                b_tc = None if bf16 else _ct_bound(
                    kernel, x, m, got, bf16, covered, stages,
                    PEAK_TF32 / 3)[0]
                del got, want
                row = dict(kernel=kernel, case=label, prec=prec, F=F,
                           covered=covered, max_abs=d, rel_plain=d / scale,
                           gate_plain=gate, rel_fft=rel_fft,
                           gate_fft=gate_fft if rel_fft is not None else None,
                           ms=looped(kfn, x, m),
                           ms_call=call(lambda: kfn(x, m)),
                           plain_ms=looped(pfn, x, m), bound_ms=b_ms,
                           bound_by=b_by, bound_3xtf32_ms=b_tc)
                row["library_ms"] = (lib["rfft"] if kernel == "full_fwd"
                                     else lib["fft_covered"]
                                     if kernel == "ablate_fwd"
                                     else lib["fft"])
                if kernel == "full_fwd":
                    row["cublas_ms"] = lib["cublas_" + prec]
                if kernel == "ablate_fwd":  # cuFFT rfft of the same frames
                    row["rfft_ms"] = lib["rfft_covered"]
                row["ok"] = ok = (finite and zero and d / scale <= gate and (
                    rel_fft is None or rel_fft <= gate_fft))
                line("ct-fwd", **{k: (f"{v:.4g}" if isinstance(v, float)
                                      else v) for k, v in row.items()})
                if not ok:
                    raise AssertionError(f"{kernel} {label} {prec} F={F}: "
                                         f"{row} (finite {finite}, rows "
                                         f"past the tiles zero {zero})")
                cases.append(row)
        del x

    # the main path: the CLI's main in this process, every launch count set
    # to 0 just before and read just after
    profiling.reset_counts()
    cli = {}
    for variant in CLI.VARIANTS:
        F = CT_F_TILED if variant == "fact-tiled" else CT_F
        for prec in ("bf16", "f32"):
            out = _ct_cli([variant, prec, "5"], F)
            cli[f"{variant}/{prec}"] = _ct_cli_check(out, variant, prec)
    out = _ct_cli(["ablate"], CT_F)
    ablate = _ct_ablate_check(out)
    launches = profiling.counts()
    # each run's CUDA graph replays its 50 captured launches 6 times, none of
    # which a wrapper counts
    replayed = 6 * 50 * (2 * len(CLI.VARIANTS) + len(X.STAGE_SETS))
    ct = {k: launches.pop(k, 0) for k in CT_LAUNCHES}
    ok = all(ct.values()) and not any(launches.values())
    line("ct-fwd-main", ok=ok, launches=json.dumps(ct).replace(" ", ""),
        graph_replayed_launches=replayed,
        other_kernels=json.dumps(launches).replace(" ", ""),
        **{k.replace("/", "_"): "{:.2e},{:.3f},{:.4f}".format(*v)
           for k, v in cli.items()},
        ablate_ms=json.dumps(ablate).replace(" ", ""))
    if not ok:
        raise AssertionError(f"ct_kernel_exp's main path launched {ct}, "
                             f"and besides {launches}")

    # the CLI as a user runs it: every variant and ablate as subprocesses
    t0 = time.perf_counter()
    sub = {}
    for variant in CLI.VARIANTS:
        F = CT_F_TILED if variant == "fact-tiled" else CT_F
        for prec in ("bf16", "f32"):
            out = _run(["dc_tts_tpu_torch.scripts.ct_kernel_exp", variant,
                        prec, "5"], timeout=300, CT_F=str(F))
            sub[f"{variant}/{prec}"] = _ct_cli_check(out, variant, prec)
    sub["ablate"] = _ct_ablate_check(_run(
        ["dc_tts_tpu_torch.scripts.ct_kernel_exp", "ablate"], timeout=300,
        CT_F=str(CT_F)))
    line("ct-fwd-cli", ok=True, runs=len(sub),
         seconds=f"{time.perf_counter() - t0:.1f}",
         **{k.replace("/", "_"): ("{:.2e},{:.3f},{:.4f}".format(*v)
                                  if k != "ablate" else json.dumps(v)
                                  .replace(" ", "")) for k, v in sub.items()})

    results.setdefault("launches", {}).update(ct)
    for kernel in CT_KERNELS:
        rows = [r for r in cases if r["kernel"] == kernel]
        head = next(r for r in rows if r["prec"] == "bf16" and (
            r["case"] in ("full", "swap", f"tf{CT_TF}", "TAWC")))
        results[kernel] = dict(
            max_abs_err=max(r["max_abs"] for r in rows), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"])
    results["ct-fwd"] = dict(cases=cases, library=libs, cli_main=cli,
                             cli_ablate_ms=ablate, cli_subprocess=sub,
                             launches=ct,
                             graph_replayed_launches=replayed)


# ---------------------------------------------------------------------------
# the entry points beside the package (bench, the learning demo, scripts/)

# the bench phase's cut of dc_tts_tpu_torch.bench's workload (720 sentences,
# 5 reps; the chunk of 72 kept)
BENCH_CUT = {"BENCH_SENTENCES": "144", "BENCH_REPS": "3"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "delivery",
              "value_device", "rep_times_device_s", "stft_method",
              "sentences", "chunk", "reps", "rep_times_s", "rep_spread",
              "card"}
# steps a network of the learn phase and the step of its diagonality gate:
# tests/test_learning.py's overfit gates (the 1500-step quality check,
# tests/test_quality_e2e.py's, takes over 100 s of host-paced steps on the
# card; it stays a slow CPU test)
LEARN_STEPS, LEARN_DIAG_STEP = 400, 200


def phase_bench(results, smi):
    """python -m dc_tts_tpu_torch.bench as a subprocess at BENCH_CUT: one
    JSON line with bench.py's keys and the card, finite positive values."""
    t0 = time.perf_counter()
    out = _run(["dc_tts_tpu_torch.bench"], **BENCH_CUT)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    r = json.loads(lines[-1])
    times = r.get("rep_times_s", []) + r.get("rep_times_device_s", [])
    ok = (len(lines) == 1 and set(r) == BENCH_KEYS
          and r["sentences"] == int(BENCH_CUT["BENCH_SENTENCES"])
          and r["chunk"] == 72 and r["reps"] == int(BENCH_CUT["BENCH_REPS"])
          and r["delivery"] == "pcm16" and r["stft_method"] == "dft_pallas2"
          and r["card"] == smi
          and all(np.isfinite(r[k]) and r[k] > 0
                  for k in ("value", "value_device", "vs_baseline"))
          and len(times) == 2 * r["reps"] and min(times) > 0)
    # for information: phase e2e's device audio-s/s (one chunk of 20)
    stages = results.get("e2e", {}).get("stages_ms")
    e2e_dev = "not run"
    if stages:
        from dc_tts_tpu_torch.config import base_config
        cfg = base_config()
        audio_s = CHUNK * cfg.hop_length * (cfg.max_T_full - 1) / cfg.sr
        e2e_dev = f"{audio_s / (sum(stages.values()) / 1e3):.1f}"
    line("bench", ok=ok, cut=" ".join(f"{k}={v}" for k, v in
                                      BENCH_CUT.items()),
         value=r.get("value"), value_device=r.get("value_device"),
         rep_spread=r.get("rep_spread"),
         e2e_stages_device_audio_s_per_s=e2e_dev,
         seconds=f"{time.perf_counter() - t0:.1f}", card=repr(smi))
    if not ok:
        raise AssertionError(f"dc_tts_tpu_torch.bench printed {lines}")
    results["bench"] = r


def structured_batches(cfg, dev):
    """tests/test_learning.py's batches: smooth mel trajectories a row and
    seeded random ids at full length for Text2Mel; for SSRN, mags that are
    a function of the mels (frame repeat, channel tile)."""
    t = np.arange(cfg.max_T)
    mels = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (i + 1) * t / cfg.max_T)[:, None]
        * np.cos(np.linspace(0, np.pi, cfg.n_mels))[None, :]
        for i in range(cfg.B)]).astype(np.float32).clip(1e-8, 1)
    reps = -(-cfg.n_freq // cfg.n_mels)
    mags = np.tile(np.repeat(mels, cfg.r, axis=1),
                   (1, 1, reps))[:, :, :cfg.n_freq]
    texts = np.random.default_rng(1).integers(1, cfg.vocab_size,
                                              (cfg.B, cfg.max_N))

    def full(n):
        return torch.full((cfg.B,), n, dtype=torch.int32, device=dev)

    return ({"texts": torch.as_tensor(texts, device=dev),
             "mels": torch.as_tensor(mels, device=dev),
             "text_lens": full(cfg.max_N), "mel_lens": full(cfg.max_T)},
            {"mels": torch.as_tensor(mels, device=dev),
             "mags": torch.as_tensor(mags, device=dev)})


def overfit_runs(cfg, dev):
    """LEARN_STEPS steps of each network on its structured batch from
    seeded parameters (tests/test_learning.py's keys 0 and 3) -> (Text2Mel
    state, SSRN state, each network's metrics (floats) at step 1,
    LEARN_DIAG_STEP and LEARN_STEPS, the Text2Mel batch)."""
    from dc_tts_tpu_torch.train import steps as TS

    b1, b2 = structured_batches(cfg, dev)
    gen = torch.Generator(device=dev)
    states, runs = [], {}
    for net, init, make, key, batch in (
            ("t2m", TS.init_text2mel_state, TS.make_text2mel_step, 0, b1),
            ("ssrn", TS.init_ssrn_state, TS.make_ssrn_step, 3, b2)):
        state = init(cfg, torch.Generator().manual_seed(key), dev)
        step, runs[net] = make(cfg), {}
        for i in range(1, LEARN_STEPS + 1):
            state, m = step(state, batch, gen)
            if i in (1, LEARN_DIAG_STEP, LEARN_STEPS):
                runs[net][i] = {k: float(v) for k, v in m.items()}
        states.append(state)
    return states[0], states[1], runs, b1


def learn_misses(runs) -> list:
    """tests/test_learning.py's calibrated gates that ``runs`` misses."""
    t, s, n, d = runs["t2m"], runs["ssrn"], LEARN_STEPS, LEARN_DIAG_STEP
    gates = {
        "loss_mels < 0.07": t[n]["loss_mels"] < 0.07,
        "loss_mels < first / 3": t[n]["loss_mels"] < t[1]["loss_mels"] / 3,
        "loss_att < 0.01": t[n]["loss_att"] < 0.01,
        f"diag@{d} < 0.18": t[d]["attention_diagonality"] < 0.18,
        f"diag@{d} < first / 1.6": t[d]["attention_diagonality"]
        < t[1]["attention_diagonality"] / 1.6,
        f"loss_mels@{d} < 0.10": t[d]["loss_mels"] < 0.10,
        "loss_mags < 0.07": s[n]["loss_mags"] < 0.07,
        "loss_mags < first / 3": s[n]["loss_mags"] < s[1]["loss_mags"] / 3}
    return [k for k, ok in gates.items() if not ok]


def phase_learn(results, smi):
    """tests/test_learning.py's overfit on the card: test_config(),
    LEARN_STEPS steps a network with use_pallas (K4), its calibrated gates;
    then the default Synthesizer (K1 "highest", K2, pcm16, chunked) speaks
    the first row's text through scripts/overfit_demo.py's evaluate."""
    from dc_tts_tpu_torch import Synthesizer, test_config
    from dc_tts_tpu_torch.scripts import overfit_demo as demo
    from dc_tts_tpu_torch.train.optimizer import tree_map

    cfg, dev = test_config().replace(warmup_steps=50.0), torch.device(DEV)
    (s1, s2, runs, b1), train_s, train_n = _timed(
        lambda: overfit_runs(cfg.replace(use_pallas=True), dev))
    misses = learn_misses(runs)
    per_step = len(_hc_shapes("t2m", cfg)) + len(_hc_shapes("ssrn", cfg))
    data = {"ids": b1["texts"][:1].cpu().numpy(), "t": cfg.max_T,
            "mels": b1["mels"][:1].cpu().numpy()}
    r, synth_s, synth_n = _timed(
        lambda: demo.evaluate(cfg, data, s1.params, s2.params, dev))
    k4_ok = (train_n["k4.fwd.launches"] == train_n["k4.bwd.launches"]
             == per_step * LEARN_STEPS and train_n["k1.launches"] == 0)
    synth_ok = (synth_n["k1.launches"] == synth_n["k1.highest.launches"] == 2
                and synth_n["k2.launches"] == 2
                and synth_n["k4.fwd.launches"] == 0
                and synth_n["k3a.launches"] == 0
                and np.isfinite(r["wav"]).all()
                and np.abs(r["wav"]).max() > 1e-3)
    # for information: the same trained nets on the CPU (plain versions)
    cpu = demo.evaluate(cfg, data, s1.params, s2.params, "cpu")
    dY = float(np.abs(r["Y"] - cpu["Y"]).max())
    dZ = float(np.abs(r["Z"] - cpu["Z"]).max())
    same = bool((r["align"].argmax(1) == cpu["align"].argmax(1)).all())
    # and the reduced decode precisions on the trained Text2Mel
    p1 = tree_map(torch.Tensor.detach, s1.params)
    p2 = tree_map(torch.Tensor.detach, s2.params)
    A = {p: Synthesizer(cfg, p1, p2, decode_prec=p).synthesize_ids(
        data["ids"])[3] for p in ("highest", "high3", "hybrid", "default")}
    flips = {}
    for p in ("high3", "hybrid", "default"):
        rows = int((A[p].argmax(1) != A["highest"].argmax(1)).any(1).sum())
        flips[p] = {"first_flip": _first_flip(A[p], A["highest"]),
                    "rows_flipped": rows}
    ok = k4_ok and synth_ok and not misses
    t, s = runs["t2m"], runs["ssrn"]
    n, d = LEARN_STEPS, LEARN_DIAG_STEP
    line("learn", ok=ok, steps=n, train_s=f"{train_s:.1f}",
         loss_mels=f"{t[1]['loss_mels']:.4f}->{t[n]['loss_mels']:.4f}",
         loss_att=f"{t[n]['loss_att']:.4f}",
         diag=f"{t[1]['attention_diagonality']:.4f}->"
              f"{t[d]['attention_diagonality']:.4f}@{d}",
         loss_mags=f"{s[1]['loss_mags']:.4f}->{s[n]['loss_mags']:.4f}",
         gates="tests/test_learning.py's", missed=misses,
         k4=f"{train_n['hc_block_fwd']}+{train_n['hc_block_bwd']}",
         synth_launches=json.dumps(_k12(synth_n)).replace(" ", ""),
         synth_s=f"{synth_s:.2f}", card=repr(smi))
    line("learn-info", corr=f"{r['corr']:.4f}", l1=f"{r['l1']:.4f}",
         mel_l1_free=f"{r['mel_l1']:.4f}", monotonic=f"{r['monotonic']:.3f}",
         card_vs_cpu_max_dY=f"{dY:.3e}", card_vs_cpu_max_dZ=f"{dZ:.3e}",
         cursors_equal=same,
         reduced_precisions=json.dumps(flips).replace(" ", ""))
    if not ok:
        raise AssertionError(f"learn failed: gates missed {misses}, K4 "
                             f"{train_n}, synthesis {synth_n}, {runs}")
    results["learn"] = dict(steps=n, train_s=train_s, runs=runs,
                            corr=r["corr"], l1=r["l1"], mel_l1=r["mel_l1"],
                            monotonic=r["monotonic"],
                            card_vs_cpu=dict(dY=dY, dZ=dZ, cursors=same),
                            reduced_precisions=flips)


def phase_bench_train(results, smi):
    """scripts/bench_train.py's variants at base_config(), 2 steps a span,
    every launch count set to 0 just before a variant and read just after:
    K4 (float32) in the float32 use_pallas variants only, its bf16 body in
    the bf16 use_pallas variants only, no other kernel."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.scripts import bench_train as BT

    cfg, dev = base_config(), torch.device(DEV)
    full = BT.synth_batch(cfg, 7, dev)
    rows, bad = {}, []
    for label, which, vcfg, bucket in BT.variants(cfg):
        batch = full if bucket is None else BT.synth_batch(
            cfg, 7, dev, n=bucket[0], t=bucket[1])
        r, _, n = _timed(lambda: BT.bench_step(label, vcfg, which, batch,
                                               dev, iters=2))
        bf16 = vcfg.compute_dtype == "bfloat16"
        want = set(K4_LAUNCHES[:4 if bf16 else 2]) if vcfg.use_pallas \
            else set()
        # with bf16 operands every K4 launch is the bf16 body's
        body = not bf16 or all(n[k] == n[k16] for k, k16 in
                               zip(K4_LAUNCHES[:2], K4_LAUNCHES[2:]))
        if {k for k, v in n.items() if v} != want or not body or not (
                0 < r["mfu"] < 1):
            bad.append((label, n, r["mfu"]))
        rows[label] = dict(ms_per_step=r["ms_per_step"],
                           fenced_ms=r["fenced_ms"], mfu=r["mfu"],
                           launches={k: v for k, v in n.items() if v})
    line("bench-train", ok=not bad, iters=2, variants=len(rows),
         ms_per_step=json.dumps({k: round(v["ms_per_step"], 2)
                                 for k, v in rows.items()}).replace(" ", ""),
         card=repr(smi))
    if bad:
        raise AssertionError(f"bench_train variants failed: {bad}")
    results["bench-train"] = rows


def phase_profile_stages(results, smi):
    """scripts/profile_stages.py on the card: the 40 sentences' stage times
    (CUDA events, the best of 2), shares and MFU, every stage timed."""
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.scripts import profile_stages as PS

    r = PS.profile(base_config(), torch.device(DEV), reps=2)
    ok = (r["batch"] == 40 and all(v > 0 for v in r["ms"].values())
          and all(0 < v < 1 for v in r["mfu"].values()))
    line("profile-stages", ok=ok, batch=r["batch"],
         **{k: f"{v:.3f}" for k, v in r["ms"].items()},
         shares=json.dumps({k: round(v, 4) for k, v in r["share"].items()}
                           ).replace(" ", ""),
         mfu=json.dumps({k: round(v, 5) for k, v in r["mfu"].items()}
                        ).replace(" ", ""),
         device_audio_s_per_s=f"{r['audio_s_per_s']:.1f}", card=repr(smi))
    if not ok:
        raise AssertionError(f"profile_stages: {r}")
    results["profile-stages"] = r


# bench-variants' cut: the methods of kernels K2 and K3, and cuFFT's
BENCH_VARIANTS = "dft_pallas2,dft_pallas,fft GL"


def phase_bench_variants(results, smi):
    """scripts/bench_variants.py on the card: the BENCH_VARIANTS variants
    over the 40 sentences, one timed run after a warm-up; K2 launched under
    dft_pallas2 only, K3 under dft_pallas only."""
    from dc_tts_tpu_torch.bench import bench_ids
    from dc_tts_tpu_torch.config import base_config
    from dc_tts_tpu_torch.scripts import bench_variants as BV

    base, dev = base_config(), torch.device(DEV)
    ids = bench_ids(base, 40)
    rows, ok = {}, True
    for label, cfg in BV.chosen(BV.variants(base), BENCH_VARIANTS):
        r, _, n = _timed(lambda: BV.bench(cfg, ids, dev, reps=1))
        m = cfg.stft_method
        ok = ok and r["audio_s_per_s"] > 0 and n["k1.launches"] == 2 and (
            n["k2.launches"] > 0) == (m == "dft_pallas2") and (
            n["k3a.launches"] > 0) == (m == "dft_pallas")
        rows[m] = dict(r, launches={k: v for k, v in n.items() if v})
    ok = ok and len(rows) == 3
    line("bench-variants", ok=ok, reps=1, variants=BENCH_VARIANTS,
         audio_s_per_s=json.dumps({k: round(v["audio_s_per_s"], 1)
                                   for k, v in rows.items()}
                                  ).replace(" ", ""), card=repr(smi))
    if not ok:
        raise AssertionError(f"bench_variants: {rows}")
    results["bench-variants"] = rows


def phase_scaling(results, smi):
    """scripts/scaling_bench.py under torchrun --nproc-per-node 1 (NCCL, one
    card): a line for size 1 at 100 % efficiency."""
    t0 = time.perf_counter()
    out = _run(["torch.distributed.run", "--standalone", "--nproc-per-node",
                "1", "-m", "dc_tts_tpu_torch.scripts.scaling_bench"])
    sizes = re.findall(r"^devices=\s*(\d+)\s+batch=\s*(\d+)\s+(\S+)s\s+(\S+) "
                       r"audio-s/s\s+scaling-eff\s+(\S+)%$", out, re.M)
    ok = len(sizes) == 1 and sizes[0][:2] == ("1", "8") and \
        float(sizes[0][3]) > 0 and sizes[0][4] == "100.0"
    line("scaling", ok=ok, command="torchrun --nproc-per-node 1 -m "
         "dc_tts_tpu_torch.scripts.scaling_bench",
         sizes=json.dumps(sizes).replace(" ", ""),
         seconds=f"{time.perf_counter() - t0:.1f}", card=repr(smi))
    if not ok:
        raise AssertionError(f"scaling_bench printed:\n{out[-2000:]}")
    results["scaling"] = sizes


ENTRY_PHASES = (("bench", phase_bench), ("learn", phase_learn),
                ("bench-train", phase_bench_train),
                ("profile-stages", phase_profile_stages),
                ("bench-variants", phase_bench_variants),
                ("scaling", phase_scaling))


# phases that use the package's bench.py (seeded weights) or
# scripts/profile_stages.py (stage timing): refused under ``--only`` for a
# package that predates them
NEEDS_ENTRY_POINTS = {"e2e", "e2e-dft_pallas", "parallel", "parallel-tp",
                      *(name for name, _ in ENTRY_PHASES)}


def _only(names, smi) -> int:
    """Run the named phases alone after device and build (``--only``):
    their lines, then their results as one JSON line (no ``ok`` line)."""
    import importlib.util
    results = {}
    phases = {"K1": phase_k1, "TextEnc": phase_textenc,
              "K1-prec": phase_k1_prec, "K1-stamps": phase_k1_stamps,
              "K2": phase_k2,
              "e2e": lambda r: phase_e2e(r, smi), "K3": phase_k3,
              "e2e-dft_pallas": lambda r: phase_e2e_dft_pallas(r, smi),
              "ssrn-block": phase_ssrn_block,
              "K4": phase_k4, "K4-bf16": lambda r: phase_k4(r, bf16=True),
              "ct-fwd": phase_ct_fwd,
              "parallel": lambda r: phase_parallel(r, smi),
              "parallel-tp": lambda r: phase_parallel_tp(r, smi),
              **{name: functools.partial(fn, smi=smi)
                 for name, fn in ENTRY_PHASES}}
    unknown = [n for n in names if n not in phases and n != "train-routes"]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; known: "
                         f"{sorted(phases) + ['train-routes']}")
    newer = sorted(NEEDS_ENTRY_POINTS.intersection(names))
    if newer and importlib.util.find_spec(
            "dc_tts_tpu_torch.scripts.profile_stages") is None:
        raise SystemExit(f"chip_smoke: phases {newer} need a package with "
                         "dc_tts_tpu_torch.bench and scripts/"
                         "profile_stages.py; this one predates them")
    for name in names:
        if name in phases:
            phases[name](results)
    if "train-routes" in names:
        with tempfile.TemporaryDirectory() as root:
            data, feats = make_corpus_and_features(root)
            phase_train_routes(results, data, feats)
    print(json.dumps({"card": smi, "only": names, "results": results},
                     default=str), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated phases to "
                    "run alone (K1, TextEnc, K1-prec, K1-stamps, K2, "
                    "e2e, "
                    "ssrn-block, K3, "
                    "e2e-dft_pallas, K4, K4-bf16, ct-fwd, train-routes, "
                    "parallel, "
                    "parallel-tp, bench, learn, bench-train, "
                    "profile-stages, bench-variants, scaling), e.g. to "
                    "time them on another commit's package in the same "
                    "call; a package without dc_tts_tpu_torch.bench and "
                    "scripts/profile_stages.py is refused for e2e, "
                    "e2e-dft_pallas, parallel, parallel-tp and the entry "
                    "points' phases")
    ap.add_argument("--package", default="", help="import dc_tts_tpu_torch "
                    "from this directory (a checkout of another commit, "
                    "e.g. from git archive) instead of this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import dc_tts_tpu_torch
    line("package", path=os.path.dirname(dc_tts_tpu_torch.__file__))
    smi = phase_device()
    phase_build()
    if args.only:
        return _only(args.only.split(","), smi)
    results = {}
    phase_k1(results)
    phase_textenc(results)
    phase_k1_prec(results)
    phase_k1_stamps(results)
    phase_k2(results)
    phase_e2e(results, smi)
    phase_e2e_prec(results, smi)
    phase_reference(results, smi)
    phase_ssrn_block(results)
    phase_k3(results)
    phase_e2e_dft_pallas(results, smi)
    phase_k4(results)
    phase_k4(results, bf16=True)
    phase_ct_fwd(results)
    with tempfile.TemporaryDirectory() as root:
        data, feats = make_corpus_and_features(root)
        phase_train(results, "t2m", data, feats, 30)
        phase_train(results, "ssrn", data, feats, 8)
        phase_train_routes(results, data, feats)
        phase_train_cli(results, data, feats, root)
        phase_synth_cli(root)
    phase_parallel(results, smi)
    phase_parallel_tp(results, smi)
    entry_s = {}
    for name, fn in ENTRY_PHASES:
        t0 = time.perf_counter()
        fn(results, smi)
        entry_s[name] = round(time.perf_counter() - t0, 1)
    line("entry-points", seconds=json.dumps(entry_s).replace(" ", ""),
         total_s=f"{sum(entry_s.values()):.1f}")
    kernels = []
    for key, name, counter, src, rep in (
            ("K1", "fused_decode", "k1.launches",
             "dc_tts_tpu_torch/csrc/decode.cu",
             "dc_tts_tpu/ops/pallas_decode.py:274"),
            *((f"K1_{p}", f"fused_decode[{p}]", f"k1.{p}.launches",
               "dc_tts_tpu_torch/csrc/decode.cu",
               f"dc_tts_tpu/ops/pallas_decode.py:274 (prec={p})")
              for p in ("high3", "hybrid", "default")),
            ("K2", "gl2_run", "k2.launches", "dc_tts_tpu_torch/csrc/gl2.cu",
             "dc_tts_tpu/ops/pallas_gl2.py:407"),
            ("K3a", "k3a", "k3a.launches", "dc_tts_tpu_torch/csrc/gl.cu",
             "dc_tts_tpu/ops/pallas_gl.py:141"),
            ("K3b", "k3b", "k3b.launches", "dc_tts_tpu_torch/csrc/gl.cu",
             "dc_tts_tpu/ops/pallas_gl.py:192"),
            *((k, k, counter, "dc_tts_tpu_torch/csrc/hc_vjp.cu",
               f"dc_tts_tpu/ops/pallas_hc_vjp.py:{at}")
              for k, counter, at in zip(
                  ("hc_block_fwd", "hc_block_bwd", "hc_block_fwd_bf16",
                   "hc_block_bwd_bf16"), K4_LAUNCHES, (236, 269) * 2)),
            *((k, k, counter, "dc_tts_tpu_torch/csrc/ct_fwd.cu",
               CT_REPLACES[k])
              for k, counter in zip(CT_KERNELS, CT_LAUNCHES)),
            ("K5", "ssrn_block", "k5.launches",
             "dc_tts_tpu_torch/csrc/ssrn_block.cu",
             "none (XLA fused this chain on the TPU)")):
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": results["launches"][counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "e2e": results["e2e"],
                   "e2e-prec": results["e2e-prec"],
                   "reference": results["reference"],
                   "e2e-dft_pallas": results["e2e-dft_pallas"],
                   "K3_modes": results["K3_modes"],
                   "K3_loop": results["K3_loop"],
                   "K4_shapes": results["K4_shapes"],
                   "K4_shapes_bf16": results["K4_shapes_bf16"],
                   "ct-fwd": results["ct-fwd"],
                   "train": {k: results[k] for k in ("train-t2m",
                                                     "train-ssrn",
                                                     "train-routes")},
                   "parallel": results["parallel"],
                   "parallel-tp": results["parallel-tp"],
                   **{name: results[name] for name, _ in ENTRY_PHASES}},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
