#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one CUDA
device; exits non-zero without one). It

1. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` for sm_90a per source, all at once) and prints
   each build's time and ``ptxas`` lines;
2. holds each kernel against its plain PyTorch version on the card at
   the shapes of Spikingformer-4-256 (T=4, B=64, L=64, D=256, H=8,
   hd=32, F=1024), bitwise in bf16 and fp32 on dyadic weights, and times
   both with CUDA events:
   * the fused layer program (eval), also on random-normal weights (as
     information), with several L-blocks per sequence (``l_block <
     L``, one L-block of a sequence dark), and at Spikingformer-8-512's
     widths (T=4, B=32 as the main path's requests, L=196, D=512, 8
     heads of 64, F=2048, l_block 128; and a ragged L=50); past the
     earlier shared-memory launch A (which took L up to 1408 in bf16 and
     480 in fp32 there): L=1600 in bf16 and 500 in fp32 at B=2; at head_dim 128 (T=4, B=4, L=100, D=256, 2 heads, F=512: four
     words a row of q or k bits), tile, decoded and analog; past the
     earlier launch B's bounds: T=6 at 4-256's widths (B=16; launch B's
     timesteps in two groups, the membranes carried across) and 40
     heads of 8 (T=4, B=4, L=100, D=256, F=640), tile, decoded and
     analog, and an F no multiple of 8 (3 heads, F=21: w1's rows copied
     element by element);
   * ``spike_matmul`` (#2) at the six products of a training layer (q,
     k, v, wo on integer counts, w1, w2; M = 16384) with dark tiles, at
     Spikingformer-8-512's three product shapes (M = 25088; 512→512 on
     counts up to 196, 512→2048, 2048→512), at ragged shapes with and
     without bias, on an all-dark input with a bias and with s and w
     offset by one element (the element-by-element copies): bitwise on
     dyadic weights; on an analog context (non-integer, negative, -0.0)
     at the wo shape, bitwise on dyadic weights where the operands'
     least set bits prove the sums exact, else, and on random-normal
     weights, within two fp32 orders' bound (``matmul_bound``), the
     share of equal entries logged; timed per product with the
     profiler's device time beside ``torch.matmul``;
   * ``spike_attention`` at BH = 2048, L = 64, d = 32, at an L that is
     not a multiple of the query block with ``causal=True``, at an 8-512
     training step's BH = 1024, L = 196, d = 64, at the bf16 LM
     prefill's causal BH = 256, L = 512, and with analog scores
     (bitwise: both sum them over the keys in ascending order) at a
     ragged shape and at the analog paths' shapes (the 4-256 train
     step's, an 8-512 request's at d = 64); at long L
     (``LONG_ATTENTION``): L = 2049 causal and not, L = 4608 causal in
     bf16 and fp32, L = 4100 at d = 64 and 128, analog scores at L =
     3000; at head dims the earlier kernel refused or that are no
     multiple of 16 (``WIDE_ATTENTION``, bf16 and fp32: d = 160, 256 and
     300 in column slices and depth chunks, d = 24, causal past 2048
     keys, analog); timed (cuda_ms and the profiler's device us) at the
     first, the 8-512 and the LM's shape, at L = 4608 causal and with
     analog scores at both analog shapes;
   * ``gather_spike_matmul`` (#4, the decoded datapath) at the six
     products of a training layer, on ragged fine-grained spikes (rows
     from empty to dense, all-zero groups), random-normal and dyadic
     weights, at ragged shapes with and without bias, on analog values
     (non-integer, negative and -0.0) at the wo shape, on an all-dark
     input, and at Spikingformer-8-512's three product shapes (M = 25088;
     512→512 on counts up to 196, 512→2048, 2048→512); on dyadic weights
     also bitwise against ``spike_matmul``; its device staging
     (``gather_stage``) each time: the order and sorted occupancies ==
     ``stage_rows``, the all-ones flags == PyTorch's; timed split into
     staging, kernel alone and whole, with the profiler's device time of
     each kernel, at bf16 and at every dtype the train paths pass it,
     beside the contract's floor (its live adds at the fp32 pipe's rate
     and their bf16 weights at the feed's);
   * the fused layer's decoded variant, as the tile one, and on dyadic
     weights bitwise against the tile variant;
   * the fused layer's rope family (the token family's layer) at the
     int8 spikingformer-lm prefill's shape (T=4, B=8, S=512, D=256,
     H=8, hd=32, F=1024), at a ragged S=200, at S=64 and at SMOKE width,
     on int8 codes with random per-channel fp32 scales: counts equal and
     outputs bitwise equal, bf16 and fp32; and the bundle's rope family
     (``fused_ssa`` with family 'rope', causal) on the ln1 output of the
     same shape and of S=200, on int8 codes: context and (H, 4) counts
     bitwise; both rope kernels also at long prompts (``ROPE_LONG``):
     S=3072 in bf16 and 1408 in fp32 at B=2, and past the old launch A's
     bound of 3744 / 2827 tokens, S=4096 in bf16 and 3000 in fp32 at
     B=1; the layer's rope family also at T=6 (B=2, S=200) and at D=1536
     (B=2, S=300, 8 heads of 32, F=1024: past the earlier ln2's 1024
     columns in registers);
   * ``quant_spike_matmul`` and ``quant_gather_spike_matmul`` (int8
     codes, random per-channel scales) at the three products of a mixed
     layer (wo on integer counts up to 512, w1, w2; M = 16384) and of an
     8-512 mixed layer (M = 25088; wo 512→512 on counts up to 196, w1
     512→2048, w2 2048→512) on spikes with dark tiles and on ragged
     fine-grained spikes, and at ragged shapes with and without bias,
     bf16 and fp32: each bitwise equal to its plain version, to the
     other and to ``dense_quant_linear``; #5's device staging (order and
     sorted occupancies) bitwise equal to ``stage_rows`` on the lanes,
     with each block's union of live lanes (its k-steps) logged beside
     JAX's executed chunks; and #5 at count values the main paths do not
     give it (128-255, above 65535, past 2^23, negative, an analog
     context, all dark; a ragged M, K and N; with and without bias),
     bitwise with its plain version and #3 (and ``dense_quant_linear``
     where that reference is exact); both timed on fp32 activations, as
     ``spike_linear`` passes them, and on bf16 ones, each product with
     the profiler's device time (#3 casts s to its lanes in the kernel:
     its bound counts s in the dtype read, the lanes' figure beside it);
     #5's time split
     into its device staging, its kernel alone and the whole, beside the
     earlier design's host staging (``quant_lanes`` and ``stage_rows``);
   * ``fused_ssa`` (the SSA bundle, bn family) at full width, at a
     ragged L=50 and at 8-512's widths, on dyadic fp weights and on int8
     codes with ``scale3``, and on an all-zero input, bf16 and fp32:
     context and (H, 4) counts bitwise; random-normal weights as
     information;
   * ``popcount_scores`` (#8, the binary engine's AND-PopCount mode) on
     packed spikes at the three popcount paths' shapes (BH = 2048, L =
     64, d = 32; BH = 1024, L = 196, d = 64; BH = 256, L = 512, d = 32),
     at a ragged Lq=50 x Lk=70, at d = 80 (three words, the last
     zero-padded), on all-zero and all-one words, and where its groups
     of 4 counts wrap rows and heads or a head starts off a 16-byte
     boundary (``POPCOUNT_SHAPES``): int32 counts bitwise; its time, with
     the profiler's device us, beside
     ``torch.bmm`` of the unpacked bf16 spikes and of the unpacked fp32
     ones (TF32 off, the same bytes written), and the whole popcount
     forward of ``ops.binary_attention`` beside #7's
     ``spike_attention`` at the same three shapes;
   * ``lif_forward`` (#9, the fused LIF entry ``ops.lif``) at the layer
     inputs of 4-256 (4, 4096, 256) and 8-512 (4, 6272, 512), at a
     ragged (4, 300, 200), at a plane no multiple of the 16-byte vector
     and on a misaligned view, bf16 and fp32, hard and soft reset, decay
     0.5 and 2/3: spikes bitwise;
   * the analog-score instantiations (``binarize_scores=False``,
     Spikingformer's own SSA): the bundle (#6 bn at full width, ragged
     L=50 and 8-512's widths; #6b rope at S=512 and 200) and the layer
     program (#1 tile and #1b decoded at full width, several L-blocks and
     8-512's widths; #1c rope at the four rope shapes; #1d at full width,
     rope S=512 and T=6), bf16 and fp32, each against its plain version:
     outputs and counts bitwise, every score block counted; each timed
     beside its binarized twin (in turns) with its plain version and the
     bound of its work (the analog context at the fp32 peak); and the
     layer program's analog variants once each through the public
     ``fused_layer`` (the kernel API, the only entry that reaches them);
   * the pipelined layer program (#1d, ``overlap='pipeline'``: #1's
     launches once a timestep, T times ``FL.LAUNCHES_PER_CALL`` a call)
     at every shape #1 is checked at (full width tile and decoded, bf16
     and fp32, several L-blocks, 8-512, the rope shapes and S=3072), at
     T=6, at 40 heads of 8 and past the old launch A's one-timestep
     bound (8-512's widths, L=2000, fp32): outputs and counts bitwise
     equal to its plain version and to #1's kernel (at T=6 too, where
     the earlier #1 could not run); timed beside #1 at 4-256 and 8-512
     with the membrane bytes it adds and ``core.dual_engine``'s
     ``fused_step_metrics`` of one call's counts, pipelined or not;
3. drives the main paths, each with every launch count and every
   ``sparse='auto'`` decision count set to 0 just before and read just
   after, each three times: with the published ``sparse='auto'`` (its
   launches checked against the decisions it recorded), with
   ``sparse='tile'`` and with ``sparse='decoded'``:
   * inference: the published config, seeded random weights,
     ``build_prefill_step`` answering 4 requests of 64 images (5 fused
     layer launches a layer: launch A's two and launch B's wo, up and
     down, the tile or the decoded variant);
   * training: ``build_train_step`` with AdamW under a warmup-cosine
     schedule, 6 steps of 64 synthetic images (per step 24 sparse
     products, ``spike_matmul`` or ``gather_spike_matmul``, one
     ``gather_stage`` with each decoded one, and ``spike_attention`` 4
     times; the fused kernel never);
   * the mixed-precision int8 Spikingformer-4-256 (the published config
     with the BN-bias raise of ``dyadic_params``, so layers fire; int8
     wo, w1, w2 and head, bf16 wq, wk, wv; ``quantize_tree`` with a
     selector): 4 requests of 64 images through ``build_prefill_step``
     for each sparse setting, per layer call 2 ``fused_ssa`` launches and
     3 ``quant_spike_matmul`` / ``quant_gather_spike_matmul`` launches
     (split by the 'auto' decisions, with one ``quant_gather_stage`` a
     decoded product), no fused layer; the requests' logits with 'auto'
     and 'decoded' == with 'tile', bitwise; the fire rate at
     every layer's input (the path fails if one is all dark); and one
     request of the complementary tree (int8 wq, wk, wv: ``fused_ssa``
     on codes and scales, ``spike_matmul`` / ``gather_spike_matmul``
     for the rest);
   * Spikingformer-8-512 (the paper's ImageNet workload, 224x224
     images, 8 layers at full width; seeded weights with the BN-bias
     raise of ``dyadic_params``, so layers fire): ``build_prefill_step``
     answering 3 requests of 32 images for each sparse setting (5 fused
     layer launches a layer call) and the fire rate at every layer's
     input (the path fails if one is all dark);
   * the popcount mode (``binary='popcount'``), once each: 6 train steps
     of 4-256 (``sparse='tile'``: 24 ``spike_matmul`` and 4
     ``popcount_scores`` a step, no ``spike_attention``); 3 requests of
     32 images of 8-512's mixed int8 tree under ``overlap='off'`` (its
     layers are not eligible for the layer program and take the
     sequential composition: per layer call 1 ``popcount_scores``, 3 fp
     and 3 int8 spike products split as 'auto' decides; no fused layer
     or bundle); 3 requests of the bf16 spikingformer-lm prefill (1
     ``popcount_scores`` a layer call);
   * the LIF entry ``ops.lif`` on the layer-input currents (the stem's
     output) of one 4-256 and one 8-512 request, bf16 and fp32 (1
     ``lif_forward`` launch a call);
   * spikingformer-lm, once each: the int8 tree through
     ``build_prefill_step`` for 3 requests of 8 x 512 tokens (6
     ``fused_layer_rope`` launches a layer call, ln2 a kernel of its own;
     'auto' decides 'tile'
     on every analog ln1 output), the bf16 tree likewise (1 causal
     ``spike_attention`` launch a layer call), the mixed int8 tree (int8
     wq, wk, wv, the rest bf16: its layers are not eligible for the
     layer program, its bundles run ``fused_ssa``'s rope family, 2
     ``fused_ssa_rope`` launches a layer call), the int8 server (8 slots,
     16 requests of 100-500 prompt tokens, 32 new tokens each, tokens
     per second; its decode step and chunked prefill are plain PyTorch and
     launch no kernel) and one int8 Spikingformer-4-256 request; one
     prompt of 4096 tokens each of the bf16, int8 and mixed int8 trees
     through ``build_prefill_step`` (past #7's 2048-key chunk: 1 causal
     ``spike_attention`` a layer; past the old launch A's bound: 6
     ``fused_layer_rope`` a layer, 2 ``fused_ssa_rope`` a layer), their
     logits == through the plain versions, bitwise; an eval layer at
     head_dim 160, which launch A does not take, through
     ``core/engine.layer_step`` (4-256's widths) and
     ``layer_step_causal`` (the LM's, fp32): the sequential composition,
     1 ``spike_attention`` at d = 160 each (and the vision layer's 6
     spike products), no fused layer or bundle, == the plain versions
     bitwise;
   * ``overlap='pipeline'`` through ``build_prefill_step``, each beside
     the same requests under 'fused' in the same run: 4 requests of 64
     images of 4-256 on dyadic weights that fire, 'tile' and 'decoded';
     3 requests of 32 images of 8-512; 3 int8 LM prefills of 8 x 512
     tokens (5 T #1d launches a layer call, rope 6 T: 80 a 4-256
     request, 96 an LM prefill, 160 an 8-512 request; no other launch);
     logits equal to
     'fused' on every request and, on one, to the plain versions and
     (dyadic weights) to ``overlap='off'``, bitwise; the mixed int8
     4-256 and LM trees under 'pipeline' launch ``fused_ssa`` /
     ``fused_ssa_rope`` as under 'fused', with equal logits;
   * analog scores (the shipped configs with ``binarize_scores=False``,
     whose layers the layer program does not take, as in JAX): 3
     requests of 32 images of 8-512 ('auto') and 4 of 64 images of 4-256
     ('tile', 'decoded') through ``build_prefill_step``, 1
     ``fused_ssa_analog`` and 3 spike products a layer call, each beside
     the same requests with binarized scores; 6 AdamW train steps of
     4-256 (#7's analog mode, #2 / #4), the loss falling; 3 int8 LM
     prefills of 8 x 512 tokens, 2 ``fused_ssa_rope_analog`` launches
     a layer call;
4. checks the outputs: finite logits of the right shape and, with
   dyadic weights, the fused path of Spikingformer-4-256 (8 images) and
   of Spikingformer-8-512 (one request of 32 images; 'auto', 'tile' and
   'decoded'), through the
   kernels and through their plain versions, equal bitwise to the
   sequential oracle (``overlap='off'``); the mixed int8
   tree with dyadic scales, through the kernels (tile and decoded) ==
   through their plain versions == the sequential oracle
   (``overlap='off'``, ``mode='dense'``), bitwise; finite losses
   and grad norms, the last loss below the first, every param moved; and, for each sparse setting, one
   train step through the kernels equal bitwise (loss, every gradient,
   the new BN state) to the same step with the kernels swapped for their
   plain versions; the LM prefills (int8, bf16 and mixed int8, one 8 x
   512 request) through the kernels equal bitwise to them through the
   plain versions, the mixed tree's also to ``overlap='off'``; an
   eval-mode forward under autograd of Spikingformer-4-256 (8 images,
   dyadic weights) and of the fp32 spikingformer-lm (2 x 64 tokens,
   weights on the 2^-8 grid) with ``overlap='fused'``, and of 4-256
   with ``overlap='pipeline'``, the layer program through the kernels:
   logits and every layer parameter's gradient equal bitwise to
   ``overlap='off'``;
   with analog scores, on one request of 8-512 and of 4-256 for each
   sparse setting, the logits under 'fused' == 'off' (#7's analog mode)
   bitwise, and through the kernels == through the plain versions
   within a derived tolerance (0 wherever every #2 wo product on the
   analog context is provably exact or equal bitwise to its plain
   version on the same operands, which the script checks; each such
   product within its bound of the plain version); 4-256's eval
   gradients with analog scores under 'fused' (the bundle) == 'off'; the
   analog int8 LM prefill through the kernels == the plain versions;
   each server request's first token equal to the argmax of the prefill
   step's last-position logits wherever their top-2 margin exceeds
   SERVE_MARGIN; the popcount mode: one 4-256 train step (tile) equal
   bitwise to the same step through the plain versions and to the step
   with ``binary='mxu_kernel'`` (loss, every gradient, the new BN
   state); the 8-512 mixed tree's logits on one request through the
   kernels == through the plain versions == ``binary='mxu_kernel'`` ==
   ``overlap='fused'`` (the bundle kernel), bitwise; the bf16 LM
   prefill's == plain == the #7 path's, bitwise; the LIF entry's spikes
   == its plain version's, and in fp32 == ``lif_scan``'s, bitwise. It
   prints ``layer_sparsities`` of one request;
5. drives the paper's third network and the quantization toolchain
   through the entry points, each with the counts set to 0 just before
   and read just after:
   * CIFAR-Net at its published config (T=4, 32x32 images, the
     1024-channel top, bf16; weights on the 2^-8 grid with BN biases
     raised by CIFAR_BIAS so every conv fires): ``build_prefill_step``
     answering 4 requests of 64 images, then 6 AdamW steps of 64 images
     from random weights (the loss falls, every param leaf moves); it has
     no engine and launches none of the port's kernels (every count 0,
     as JAX reaches no Pallas kernel there); its layer sparsities; one
     request's logits on the card against the port's CPU run: bitwise
     with cuDNN off and a BN state whose inverse std is exactly 1 (every
     sum exact), and as the prefill step runs it (cuDNN's rounding
     algorithms, the devices' rsqrt an ulp apart) within a derived
     tolerance (the head-input rates' difference through |W|, plus two
     bf16 roundings) with the argmax equal;
   * quantization-aware training of Spikingformer-4-256: 6 AdamW steps
     of 64 images with ``qat='int8'`` ('tile': 24 ``spike_matmul`` and 4
     ``spike_attention`` a step) and 6 with ``qat='int4'`` ('decoded':
     24 ``gather_spike_matmul`` with their staging and 4
     ``spike_attention``), the loss falling; one QAT step of each
     (loss, every gradient, the new BN state) through the kernels ==
     through their plain versions, bitwise, on masters whose per-column
     amax is ``qmax * 2^-e`` (dyadic fake-quantized weights);
   * PTQ calibration (``quant.calibrate``: one unquantized forward and
     one per clip ratio) of Spikingformer-4-256 (dyadic weights with the
     BN-bias raise, 64 images; int8 and int4: 5 fused-layer launches a
     layer call, every forward) and of the bf16 spikingformer-lm (int8,
     8 prompts of 512 tokens: 1 causal ``spike_attention`` a layer in
     the unquantized forward, 6 ``fused_layer_rope`` a layer in each
     int8 one), each report (the chosen ratio, every candidate's
     distances) equal through the kernels and through their plain
     versions.

6. trains spikingformer-lm and Spikingformer-8-512 through the entry
   points, each with the counts set to 0 just before and read just after:
   * the published bf16 LM (T=4, D=256, 8 heads of 32, 4 layers, vocab
     32000) on ``SyntheticLM`` batches of 8 x 512 tokens through
     ``build_train_step``: 6 AdamW steps, 6 with ``qat='int8'`` and 6
     with ``compress=True`` (its layers are not eligible for the layer
     program and take the sequential composition: 1 causal
     ``spike_attention`` a layer, 4 a step; no fused layer), 6 with
     ``binary='popcount'`` (4 ``popcount_scores`` a step), and 6 of the
     LM with ``dtype='float32'`` (eligible: 6 ``fused_layer_rope``
     launches a layer call, 24 a step, no ``spike_attention``); the loss
     falling and every param leaf moving in each run; the compressed
     run's loss gap to the uncompressed one logged;
   * one LM train step of each route (bf16, fp32, popcount, int8 QAT on
     masters with power-of-two scales; 2 x 64 tokens, weights on the
     2^-8 grid) through the kernels == through their plain versions,
     bitwise (loss and every gradient; deterministic algorithms on, so
     the embedding's backward adds repeated tokens' rows in one order);
   * ``launch.train.train`` of the published LM at a small batch with
     checkpoints in a temporary directory and a failure injected: one
     restart from the latest checkpoint, the steps after it replayed (as
     JAX replays them), every restored tree equal bitwise to the tree
     saved at its step;
   * Spikingformer-8-512 at published width and depth: 6 AdamW steps of
     32 images through ``train_path`` ('auto': 6 spike products of the
     datapath 'auto' picks and 1 ``spike_attention`` a layer; finite
     metrics and every param leaf moving, the loss logged: with 1000
     classes and 32 images a batch, the first steps raise it), and one
     train step through the kernels == through their plain versions,
     bitwise.

7. serves and trains the dense decoder family and the spiking LM's window
   attention through the entry points (seeded random weights), each
   phase logged with its host-clock seconds and peak device memory, the
   last model's memory freed before it, the counts set to 0 just before
   each path and read just after:
   * h2o-danube-3-4b at published width and depth (24 layers, bf16,
     sliding window 4096) through ``BatchedServer``: 4 slots, 6 requests
     of 4200-5200 prompt tokens (the first of 5200), 16 new tokens each,
     in bites of 1024, so its rings of 4096 + 1023 entries wrap; tokens
     per second; no kernel launched; then one int8 request of 4500
     tokens (``quantize_tree``, every linear through
     ``dense_quant_linear``);
   * gemma3-12b at published width and depth (48 layers, 5:1
     local:global, vocab 262144, tied embeddings, bf16): a prefill of 4
     prompts of 1536 tokens, then a server of 4 slots and 4 requests of
     1100-1600 tokens, 16 new each, in bites of 512 (local rings of 1535
     entries, which wrap);
   * each server request's first token equal to the argmax of the
     prefill step's last-position logits wherever their top-2 margin
     exceeds SERVE_MARGIN;
   * fp32 at full width, h2o-danube-3-4b cut to 2 layers (2 prompts of
     4600 tokens in bites of 1024, across the window) and gemma3-12b cut
     to one local/global group (2 prompts of 1600 in bites of 512, its
     local rings wrapping): the server's first-token logits against the
     whole-prompt forward's within the derived tolerance of
     :func:`tight_check`;
   * nemotron-4-15b and granite-20b at full width, depth cut to 4
     layers: one 8 x 512 prefill and a 2-slot server with the
     first-token check;
   * 3 AdamW steps of h2o-danube-3-4b at full width, 2 layers, on 4 x
     512 tokens of the token stream: finite losses and grad norms, every
     param leaf moving, no kernel launched;
   * spikingformer-lm at published width with ``attn_type='swa'`` (window
     256) and ``'local_global'`` (window 256, a full layer every 2), bf16,
     int8 and fp32 (weights on the 2^-8 grid): 3 prefills of 8 x 512
     tokens (window layers launch nothing; local_global's full layers 1
     causal ``spike_attention`` each in bf16 and int8, whose 4-D group
     weights ``quantize_tree`` leaves unquantized as JAX's does, 6
     ``fused_layer_rope`` launches each in fp32), one request's logits
     through the kernels == through the plain versions bitwise, and a
     server (4 slots, 6 requests of 300-500 tokens in bites of 64, rings
     of 319 entries) with the first-token check.

8. serves, checks and trains the MoE family through the entry points
   (seeded random weights; the expert products ``torch.bmm`` in the
   activation dtype), each phase logged with its host-clock seconds and
   peak device memory, the counts set to 0 just before each path and read
   just after:
   * deepseek-moe-16b at published width and depth (28 layers, 64 experts
     top-6 + 2 shared, bf16, 16.4B parameters): two prefills of 4 x 512
     tokens through ``build_prefill_step`` (finite logits, bitwise equal:
     the combine adds no float atomically; ``moe_aux`` finite), then 4
     prompts of 64 tokens fed a token a step through ``build_serve_step``
     and 32 greedy tokens each (ms a step, tokens/s); no kernel launched;
   * fp32 at deepseek's width, 2 layers, the capacity factor raised to
     num_experts / top_k: 2 prompts of 64 tokens decoded token by token
     against the forward at every position within a derived tolerance
     (:func:`moe_tight_check`), routing ids equal wherever the margin
     clears MOE_MARGIN, and the dispatch against the per-token expert
     mixture on 64 tokens (:func:`moe_oracle_check`);
   * the spiking deepseek-moe-16b (T=4, 28 layers, bf16): a prefill of 2 x
     256 tokens, one causal ``spike_attention`` (#7) a layer, and with
     ``binary='popcount'`` one ``popcount_scores`` (#8) a layer; logits
     through the kernels == through the plain versions, and the #8 run's
     == the #7 run's, bitwise;
   * kimi-k2-1t-a32b at published width cut to 2 layers (one dense, one
     MoE of 384 experts; 19.9B parameters): two prefills of 2 x 512
     tokens, 16 decode steps;
   * deepseek-moe-16b at full width, 2 layers: 3 AdamW steps of 4 x 512
     tokens (loss, ``moe_aux``, grad norm; every leaf moves), one
     ``qat='int8'`` step, one int8 PTQ request (``quantize_tree``: 15 int8
     leaves; expert stacks and router fp).

9. serves, checks and trains the rwkv, hybrid, encoder-decoder and
   vision-language families through the entry points at published width
   and depth (seeded random weights, bf16; no kernel launched), each
   phase logged with its seconds and peak device memory:
   * rwkv6-3b (32 layers): two prefills of 4 x 1024 tokens (the chunked
     WKV), then 4 rows decoded 32 steps through ``build_serve_step``;
   * hymba-1.5b (32 layers): two prefills of 2 x 512 tokens, then 32
     decode steps of 2 rows;
   * whisper-small (12 + 12 layers): two prefills of 2 x (1500 stub
     frames + 64 tokens), then 64 decode steps against the cross K / V
     that ``init_cache`` computed (positions under 448);
   * llava-next-mistral-7b (32 layers): a prefill of 2880 stub patches +
     128 tokens, then a 4-slot ``BatchedServer`` serving 8 text
     continuations of 64-256 prompt tokens, 16 new tokens each;
   * fp32 at each family's width cut to 2 layers: token-by-token decode
     against the forward within a derived tolerance
     (:func:`family_tight_check`);
   * 2 AdamW steps of each at its width cut to 2 layers (llava with
     patches, whisper with frames) on one batch: finite losses, the
     second not above the first.

10. runs the distributed layer on ranks that ``launch.mesh.launch``
    starts (the kernels built here first, so the ranks only load them):
    * the int8 spikingformer-lm server (published config, the 16
      requests and 8 slots of ``serve_path``) on (data x model) meshes
      1x1 (one NCCL rank), 1x2, 2x1 and 2x2 (gloo ranks sharing the card,
      their collectives through host memory): every mesh generates the
      unsharded server's tokens, request by request; no rank launches a
      kernel; logged: tokens/s, each rank's bytes of params and KV
      against the totals, each rank's peak memory, its collectives;
    * deepseek-moe-16b at published width and depth on (data 1, model 2),
      sharded as ``_MOE``'s specs say (``moe.mesh_specs``: attention
      heads, the dense layer's and the shared experts' d_ff, the vocab
      and the routed experts over 'model'; a rank draws only its slices,
      each expert stack cut as it is drawn), the routed experts
      expert-parallel (``use_ep_mesh``): a 4 x 512 prefill and 32 decode
      steps of 4 rows through ``build_serve_step``, at the published
      capacity factor and at E / K; here first the unsharded run, the EP
      arithmetic (``ep_emulation``: each MoE call within its bound of the
      unsharded combine, from the bf16 roundings of each rank's partial
      and of their sum) and the sharded ranks' arithmetic on threads of
      this process (``thread_ranks``), then the ranks, whose logits equal
      the threads' bitwise (sha256); the spiking deepseek prefill (T=4)
      on each rank: one #7 a layer on its 8 heads (one #8 under
      ``binary='popcount'``), == the plain versions bitwise, #8 == #7.

``spike_matmul``'s analog mode (``analog=True``: wo on the
analog context of an analog-score layer, summed in ascending k on CUDA
cores) is held bitwise against its plain version at the wo shape and
ragged shapes, timed beside ``torch.matmul``, and
``check_analog_outputs`` asserts the analog models' logits through the
kernels equal the plain versions' bitwise.

It prints the card's name and power limit, a JSON line of per-kernel
numbers (``spike_matmul``'s row also with the 4-256 'tile' train steps'
and analog 'tile' requests' ms, ``quant_spike_matmul``'s with the mixed
'tile' requests' ms; the rows of #1, #1b, #1c, #2, #4 and #7 with the
QAT and calibration paths' launches), the ms of the new paths beside
the fp train steps (the LM's and 8-512's steps beside 4-256's; the rows
of #1c, #2, #4, #7 and #8 with the LM and 8-512 train runs' launches;
those of #7 and #8 with the spiking MoE prefill's and each EP rank's;
the row of #2's analog mode with the analog requests' launches),
the whole run's seconds, and last a JSON line
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dual_engine  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.engine import use_engine  # noqa: E402
from repro_torch.core.spiking import SpikingConfig, lif_scan  # noqa: E402
from repro_torch.core.bitpack import pack_bits  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fused_layer as FL  # noqa: E402
from repro_torch.kernels import fused_ssa as FS  # noqa: E402
from repro_torch.kernels import lif as LF  # noqa: E402
from repro_torch.kernels import popcount_attention as PA  # noqa: E402
from repro_torch.kernels import spike_attention as SA  # noqa: E402
from repro_torch.kernels import spike_decode as SD  # noqa: E402
from repro_torch.kernels import spike_matmul as SM  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore_tree  # noqa
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_loop  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.launch.train import make_batch_fn  # noqa: E402
from repro_torch.models import nn, registry  # noqa: E402
from repro_torch.models import spikingformer as SF  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.spikingformer import layer_sparsities  # noqa: E402
from repro_torch.models.nn import rmsnorm, rope_table  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.optim import (adamw, compress_state_init,  # noqa: E402
                               warmup_cosine)
from repro_torch.quant import (DEFAULT_RATIOS, INT_BITS,  # noqa: E402
                               calibrate, map_param_dicts, quantize_tree,
                               quantize_weight)
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                               tree_unflatten)

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8 = 1979e12         # int8 tensor cores, dense operations/s
PEAK_BYTES = 3.35e12
# full width of Spikingformer-4-256 at a 64-image batch
T, B, L, D, H, HD, FF = 4, 64, 64, 256, 8, 32, 1024
FULL = (T, B, L, D, H, HD, FF)
# (what, (T, B, L, D, H, hd, F), l_block) with several L-blocks a sequence:
# the SMOKE width, the full width with a ragged last block, and an L that
# is not a multiple of the block
MULTI_BLOCK = [("SMOKE width", (2, 8, 16, 64, 4, 16, 128), 8),
               ("full width, ragged blocks", (4, 16, 64, 256, 8, 32, 1024), 24),
               ("SMOKE width, L=13", (2, 8, 13, 64, 4, 16, 128), 8)]
REQUESTS, REQUEST_BATCH = 4, 64
# the six spike products of a training layer: (what, K, N, counts on the
# left); M = T * B * L
M_TRAIN = T * B * L
MATMULS = [("q", D, H * HD, False), ("k", D, H * HD, False),
           ("v", D, H * HD, False), ("wo", H * HD, D, True),
           ("w1", D, FF, False), ("w2", FF, D, False)]
# ragged (M, K, N): scalar loads (K, N not multiples of the 16-byte
# vector) and vector loads with ragged tiles
MATMUL_RAGGED = [(1000, 100, 70), (1000, 264, 200)]
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR = 6, 64, 2e-3
# spikingformer-lm at full width (T=4, D=256, H=8, hd=32, F=1024): the
# rope family of the fused layer at a prefill of 8 x 512 tokens, a ragged
# S=200 (a partial L-block) and S=64; l_block is the engine's block_m
LM_FULL = (4, 8, 512, 256, 8, 32, 1024)
ROPE_CASES = [("S=512", LM_FULL, 128),
              ("ragged S=200", (4, 8, 200, 256, 8, 32, 1024), 128),
              ("S=64", (4, 8, 64, 256, 8, 32, 1024), 128),
              ("SMOKE width, S=13", (2, 2, 13, 64, 4, 16, 128), 8)]
LM_REQUESTS, LM_BATCH, LM_PROMPT = 3, 8, 512
# spike_attention (BH, L, d, causal): the training shape, an L that is not
# a multiple of the 64-query block, an 8-512 training step's shape (T x 32
# images x 8 heads, L 196, d 64) and the bf16 LM prefill's causal shape
ATTENTION = [(T * B * H, L, HD, False), (64, 77, HD, True),
             (T * 32 * 8, 196, 64, False),
             (T * LM_BATCH * H, LM_PROMPT, HD, True)]
# spike_attention past its 2048-key chunk (dtype, BH, L, d, causal,
# binarize): one key past a chunk, several chunks under causal, d 64 and
# 128 (the shared memory's widest chunk), analog scores
LONG_ATTENTION = [(torch.bfloat16, 8, 2049, HD, False, True),
                  (torch.bfloat16, 8, 2049, HD, True, True),
                  (torch.bfloat16, 8, 4608, HD, True, True),
                  (torch.float32, 8, 4608, HD, True, True),
                  (torch.bfloat16, 4, 4100, 64, False, True),
                  (torch.bfloat16, 2, 4100, 128, True, True),
                  (torch.float32, 4, 3000, HD, False, False),
                  (torch.bfloat16, 4, 3000, HD, True, False)]
# spike_attention at head dims past 128 (in column slices; 256 with the
# query tile resident, 300 streamed in depth chunks) or no multiple of 16
# (24: zero-padded), at ragged L, causal past the key length that takes
# two warp groups, both dtypes
WIDE_ATTENTION = [(dt, *case) for dt in (torch.bfloat16, torch.float32)
                  for case in ((4, 300, 160, True, True),
                               (2, 2100, 256, False, True),
                               (2, 2300, 160, True, True),
                               (6, 333, 24, True, True),
                               (6, 130, 24, False, True),
                               (3, 100, 300, True, True),
                               (4, 300, 160, True, False),
                               (6, 333, 24, True, False))]
# one bf16 spikingformer-lm prompt past the chunk, through the prefill step
LONG_PROMPT = 4096
# an eval layer that launch A does not take: head_dim 160 (its bound is
# 128) at 4-256's other widths and T = 4, vision (B images of L = 64) and
# LM (B x S tokens, fp32 activations, eligible but for that bound)
WIDE_HEAD = dict(num_heads=8, num_kv_heads=8, head_dim=160)
WIDE_VISION_B, WIDE_LM_B, WIDE_LM_S = 16, 2, 256
# the server: slots, requests, prompt lengths, new tokens, cache length
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_LEN = 8, 16, 32, 1024
SERVE_PROMPTS = (100, 500)
# a first token is held to the prefill step's argmax only where the
# prefill logits' top-2 margin exceeds this (the decode path sums its
# products in another order than the fused kernel)
SERVE_MARGIN = 0.1
# the three quantized spike products of a mixed-precision layer (int8
# wo on the attention's counts, w1 and w2 on spikes): (what, K, N,
# counts on the left); M = T * B * L
QUANT_PRODUCTS = [("wo", H * HD, D, True), ("w1", D, FF, False),
                  ("w2", FF, D, False)]
QUANT_COUNT_MAX = 512
# the SSA bundle (fused_ssa) at full width, and at a ragged L
SSA_FULL = (T, B, L, D, H, HD)
SSA_RAGGED = ("ragged L=50", (T, 16, 50, D, H, HD))
# Spikingformer-8-512, the paper's ImageNet workload (T=4, L=196 from
# 224x224 images through 4 SPS stages, D=512, 8 heads of 64, d_ff=2048):
# the layer program checked and timed at the batch of the main path's
# requests with the engine's l_block (128: a ragged second L-block), and
# checked at a ragged L=50; the bundle (bn) likewise
EIGHT_REQUESTS, EIGHT_BATCH = 3, 32
EIGHT = (4, EIGHT_BATCH, 196, 512, 8, 64, 2048)
EIGHT_CASES = [("8-512 width", EIGHT, 128),
               ("8-512 width, ragged L=50", (4, 8, 50, 512, 8, 64, 2048), 32)]
SSA_EIGHT = [("8-512 width", EIGHT[:6]),
             ("8-512 width, ragged L=50", (4, 8, 50, 512, 8, 64))]
# #5 (and #3) also at Spikingformer-8-512's three int8 products of a mixed
# layer (M = T * B * L at the main path's batch, wo on counts up to
# L = 196), and #5 at count values the main paths do not give it, at a
# ragged (M, K, N): (what, K, N, counts) and the values' names
M_EIGHT, EIGHT_L = 4 * EIGHT_BATCH * 196, 196
QUANT_EIGHT = [("wo", 512, 512, True), ("w1", 512, 2048, False),
               ("w2", 2048, 512, False)]
QUANT_VALUES = ("counts 128-255", "counts above 65535", "counts past 2^23",
                "negative counts", "analog context", "all dark")
QUANT_VALUES_SHAPE = (2000, 260, 200)
# the bundle's rope family (#6b, causal) at the LM prefill's shape and a
# ragged S: (what, (T, B, S, D, H, hd))
ROPE_SSA_CASES = [("S=512", (4, LM_BATCH, LM_PROMPT, 256, 8, 32)),
                  ("ragged S=200", (4, LM_BATCH, 200, 256, 8, 32))]
# the rope family (#1c, #6b) at long prompts: S=3072 (bf16) and 1408
# (fp32), where the earlier shared-memory launch A streamed w3, and past
# its bound of 3744 / 2827 tokens: B=1, S=4096 (bf16) and 3000 (fp32)
ROPE_LONG = {torch.bfloat16: [(4, 2, 3072, 256, 8, 32, 1024),
                              (4, 1, 4096, 256, 8, 32, 1024)],
             torch.float32: [(4, 2, 1408, 256, 8, 32, 1024),
                             (4, 1, 3000, 256, 8, 32, 1024)]}
# the bn layer (#1 tile, #1b decoded) past the old launch A's bound at
# 8-512's widths (L 1408 in bf16, 480 in fp32), and at head_dim 128 (four
# words a row of q or k bits): (what, shape, l_block)
EIGHT_LONG = {torch.bfloat16: ("8-512 width, L=1600",
                               (4, 2, 1600, 512, 8, 64, 2048), 128),
              torch.float32: ("8-512 width, L=500",
                              (4, 2, 500, 512, 8, 64, 2048), 128)}
HD128 = ("head_dim 128", (4, 4, 100, 256, 2, 128, 512), 64)
# #1d past the old one-timestep bound (L 1952 in fp32 at 8-512's widths)
PIPE_LONG = ("8-512 width, L=2000", (4, 2, 2000, 512, 8, 64, 2048), 128)
# the eval-mode gradient check of the fp32 LM: a batch of prompts
LM_GRAD_BATCH, LM_GRAD_PROMPT = 2, 64
# the popcount mode (#8): popcount_scores at the three popcount paths'
# shapes, (what, BH, L, d): the 4-256 train step's attention, an 8-512
# request's (B = 32, hd 64: two words a row) and the bf16 LM prefill's
POPCOUNT_PATHS = [("4-256 train", T * B * H, L, HD),
                  ("8-512 eval", 4 * EIGHT_BATCH * 8, 196, 64),
                  ("bf16 LM", T * LM_BATCH * H, LM_PROMPT, HD)]
# #8 where its groups of 4 counts wrap rows and heads (Lk % 4 != 0), where
# a head's counts start off a 16-byte boundary (Lq Lk odd), Lq != Lk, and
# Lk past a block's round of 1024 counts: (what, BH, Lq, Lk, d)
POPCOUNT_SHAPES = [("5 x 7", 3, 5, 7, HD), ("50 x 70, W=3", 4, 50, 70, 80),
                   ("Lq != Lk, W=1", 8, 100, 36, HD),
                   ("Lq != Lk, W=2", 8, 37, 98, 64),
                   ("heads off 16 bytes", 7, 9, 13, HD),
                   ("Lk past a round", 2, 5, 2051, 64),
                   ("Lk past a round, Lk % 4 == 0", 2, 3, 2500, HD)]
# LIF currents (T, M, D) (#9): the layer inputs of 4-256 (B = 64) and of
# 8-512 (B = 32), a ragged shape, and one whose plane is no multiple of
# the 16-byte vector (the kernel's element-wise path)
LIF_CASES = [("4-256 layer input", (4, B * L, D)),
             ("8-512 layer input", (4, EIGHT_BATCH * 196, 512)),
             ("ragged", (4, 300, 200)), ("odd plane", (3, 37, 201))]
# the layer program at T = 6 (launch B's timesteps in two groups, the
# membranes carried across), fused (#1 tile, #1b decoded, #1c) and
# pipelined (#1d, also held against #1's kernel): (what, (T, B, L, D, H,
# hd, F), l_block) for the bn family and for the rope family
PIPE_T6 = ("T=6", (6, 16, 64, 256, 8, 32, 1024), 64)
PIPE_T6_ROPE = ("T=6", (6, 2, 200, 256, 8, 32, 1024), 128)
# launch B past its earlier bounds: 40 heads of 8 (its flags are a word a
# head; F / H = 16) and a rope layer at D = 1536 (ln2's tree streams a
# row of any length)
HEADS40 = ("40 heads of 8", (4, 4, 100, 256, 40, 8, 640), 64)
# an F that is no multiple of 8 (3 heads, F / H = 7): w1's rows are not
# whole 16-byte vectors, so launch B copies them element by element
ODD_F = ("F=21, 3 heads", (2, 4, 20, 64, 3, 16, 21), 8)
ROPE_D1536 = ("D=1536", (4, 2, 300, 1536, 8, 32, 1024), 128)
# spike_attention's analog mode (#7) at the shapes the analog paths give
# it: the 4-256 train step's (BH, L, d) and an 8-512 request's
ANALOG_ATTENTION = [(T * B * H, L, HD), (4 * EIGHT_BATCH * 8, 196, 64)]
KERNEL_MODULES = (FL, SM, SA, SD, FS, PA, LF)
# CIFAR-Net at its published config (T=4, 32x32 images, the 1024-channel
# top, bf16): requests and the batch of each; its inference weights sit on
# the 2^-8 grid with BN biases raised by CIFAR_BIAS (on the random weights
# alone the convs from the third on are dark on init_state)
CIFAR_REQUESTS, CIFAR_BATCH, CIFAR_BIAS = 4, 64, 0.5
# quantization-aware training of Spikingformer-4-256: each qat dtype with
# the sparse datapath its steps take (so both #2 and #4 run QAT steps)
QAT_PATHS = (("int8", "tile"), ("int4", "decoded"))
# spikingformer-lm training at published width on the token stream's
# LM_BATCH x LM_PROMPT batches: AdamW steps of each run (bf16, int8 QAT,
# compressed gradients, popcount, fp32; the first step, at the peak rate,
# raises the loss, so fewer steps do not show it fall); the supervised
# loop at a small batch: steps, batch, tokens, checkpoint interval and
# the step that fails
LM_TRAIN_STEPS = 6
LM_CKPT = dict(total_steps=8, batch=2, seq=128, ckpt_every=3,
               inject_failure_at=5)
# the dense decoder family at published width (seeded random weights, no
# engine, plain PyTorch: no kernel of the port). Servers: slots, requests,
# prompt lengths, new tokens, a fixed prefill chunk (the policy's bites of
# 4-16 tokens would take thousands of waves at these prompts). h2o's
# prompts pass its 4096 window and its rings of 4096 + 1023 entries wrap;
# gemma3's local rings hold 1024 + 511
H2O_SERVE = dict(slots=4, requests=6, prompts=(4200, 5200), new=16,
                 chunk=1024)
H2O_INT8_PROMPT = 4500
GEMMA_PREFILL = (4, 1536)
GEMMA_SERVE = dict(slots=4, requests=4, prompts=(1100, 1600), new=16,
                   chunk=512)
# nemotron-4-15b and granite-20b at full width, depth cut to 4 layers: one
# 8 x 512 prefill and a 2-slot server
CUT_LAYERS = 4
CUT_SERVE = dict(slots=2, requests=2, prompts=(300, 500), new=8, chunk=256)
# the fp32 checks of the window rings against the whole-prompt forward,
# at full width: h2o-danube-3-4b cut to 2 layers, 2 prompts of 4600
# tokens served in bites of 1024 (they cross the window); gemma3-12b cut
# to one local/global group (6 layers), 2 prompts of 1600 tokens in bites
# of 512 (its local rings of 1535 entries wrap). The tolerance's
# probabilistic rounding bound takes lambda = 8 (Higham and Mary: a sum
# of n fp32 terms lies within lambda sqrt(n) u of the sum of their
# magnitudes with probability >= 1 - 2 exp(-lambda^2 / 2))
TIGHT = {"h2o-danube-3-4b": dict(layers=2, prompts=2, length=4600,
                                 chunk=1024),
         "gemma3-12b": dict(layers=6, prompts=2, length=1600, chunk=512)}
TIGHT_LAMBDA = 8.0
# AdamW steps of h2o-danube-3-4b at full width, 2 layers, on the token
# stream: (steps, batch, tokens)
DENSE_TRAIN = (3, 4, 512)
# spikingformer-lm at published width with window attention: its layers
# as sliding windows of 256, or local / global with a full layer every 2
# (layers 2 and 4, the layer program's or #7's); a server in bites of 64
# (rings of 256 + 63 entries wrap)
WINDOW_LM = {"swa": dict(attn_type="swa", window=256),
             "local_global": dict(attn_type="local_global", window=256,
                                  global_every=2)}
WINDOW_SERVE = dict(slots=4, requests=6, prompts=(300, 500), new=8,
                    chunk=64)


def log(msg):
    print(msg, flush=True)


def dyadic(gen, shape, bits=8):
    k = torch.randint(-(1 << bits), 1 << bits, shape, generator=gen)
    return k.float() * 2.0 ** -bits


def layer_operands(seed, dtype, dyadic_weights, shape=FULL, l_block=64,
                   sparse="tile", raw=False):
    """Fused-layer operands (the layout layer_step builds): one dark
    (t=0, b=0) slab and, with several L-blocks, the first L-block of
    batch row 1 dark at every t. Returns ``FL.prepare``'s (args, kwargs),
    or with ``raw`` the operands and keywords of the public
    ``FL.fused_layer``."""
    T, B, L, D, H, HD, FF = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-64, 224, (T, B, L, D), generator=gen).float() / 128
    x[0, 0] = 0.0
    if l_block < L:
        x[:, 1, :l_block] = 0.0
    x = x.to(dtype)
    s = lif_scan(x, SpikingConfig(time_steps=T))[0]

    def weight(shape, fan_in):
        if dyadic_weights:
            return dyadic(gen, shape) * 0.25
        return torch.randn(shape, generator=gen) / math.sqrt(fan_in)

    def rows(n):
        return torch.stack([dyadic(gen, (n,)) * 0.5,
                            torch.rand((n,), generator=gen) + 0.5,
                            1.0 + dyadic(gen, (n,)) * 0.5,
                            dyadic(gen, (n,)) * 0.5])

    ops = (x, s, weight((3, D, H * HD), D), weight((H * HD, D), H * HD),
           weight((D, FF), D), weight((FF, D), FF),
           tuple(1.0 + dyadic(gen, shape, bits=4) * 0.5
                 for shape in ((3, H * HD), (D,), (FF,), (D,))),
           torch.stack([rows(H * HD) for _ in range(3)]), rows(D), rows(FF),
           rows(D), torch.tensor(0.3))
    ops = tree_map(lambda a: a.cuda(), ops)
    ops = ops[:2] + tuple(w.to(dtype) for w in ops[2:6]) + ops[6:]
    kw = dict(num_heads=H, head_dim=HD, scale=1.0 / math.sqrt(HD),
              decay=0.5, v_th=1.0, soft_reset=False, eps=1e-5,
              l_block=l_block, sparse=sparse)
    return (ops, dict(kw, family="bn")) if raw else FL.prepare(*ops, **kw)


def cuda_ms(fn, warmup=3, calls=20, repeats=5):
    """Time per call of ``fn`` in ms: CUDA events around ``calls`` calls
    back to back, so the host's per-call work overlaps the device's
    wherever the device is the slower; the median of ``repeats`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def layer_bound_ms(args, counts, dtype, l_block=64, decoded=False,
                   shape=FULL, causal=False, analog=False):
    """Least time for the layer on the card: the executed multiply-adds
    at the dtype's peak, or each input read once and each output written
    once at the memory rate, whichever is larger. The executed work is
    that of the executed sub-blocks (a causal score or context block
    counts only its (query, key) pairs on or below the diagonal); a
    decoded projection's is one multiply-add per live spike and output
    column. ``analog``: the context's multiply-adds take fp32 scores,
    which no bf16 tensor-core product holds, so they count at the fp32
    CUDA-core peak."""
    _, _, L, D, H, HD, FF = shape
    x, s = args[0], args[1]
    nlb = counts.shape[-1]
    rows = torch.tensor([min(L, (lb + 1) * l_block) - lb * l_block
                         for lb in range(nlb)], dtype=torch.float64)
    pairs = rows * L
    if causal:              # keys j of the block meet queries j .. L-1
        pairs = torch.tensor([sum(L - j for j in range(
            lb * l_block, min(L, (lb + 1) * l_block))) for lb in range(nlb)],
            dtype=torch.float64)
    c = counts.double().cpu()
    ffc = FF // H
    per_block = torch.stack([rows * D * HD] * 3 + [pairs * HD, pairs * HD]
                            + [rows * HD * D, rows * D * ffc, rows * ffc * D])
    per_phase = (c * per_block[None]).sum(dim=(0, 2))
    if decoded:
        per_phase[:3] = float((s != 0).sum()) * H * HD
    ops_s = 2 * float(per_phase.sum()) / PEAK_FLOPS[dtype]
    if analog:
        ops_s += 2 * float(per_phase[4]) * (1 / PEAK_FLOPS[torch.float32]
                                            - 1 / PEAK_FLOPS[dtype])
    es = x.element_size()
    n_bytes = (3 * x.numel() * es
               + sum(w.numel() for w in args[2:6]) * es
               + sum(a.numel() * 4 for a in (*args[6], *args[7:12])
                     if a is not None)
               + counts.numel() * 4)
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def rope_operands(seed, dtype, shape=LM_FULL, l_block=128, raw=False):
    """Rope-family operands as ``layer_step_causal`` builds them for an
    int8 layer: a residual stream with one all-zero token, its ln1 output
    (a random norm scale), int8 codes of random-normal weights with their
    per-channel fp32 scales, the RoPE table, a random ln2 scale. Returns
    ``FL.prepare``'s (args, kwargs), or with ``raw`` those of
    ``FL.fused_layer``."""
    T, B, L, D, H, HD, FF = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((T, B, L, D), generator=gen) * 0.5
    x[:, :, min(3, L - 1)] = 0.0
    s = rmsnorm({"scale": 1.0 + 0.1 * torch.randn((D,), generator=gen)}, x)

    def quant(k, n):
        q = quantize_weight(torch.randn((k, n), generator=gen) / math.sqrt(k))
        return q["qw"].float(), q["scale"]
    (wq, sq), (wk, sk), (wv, sv) = (quant(D, H * HD) for _ in range(3))
    (wo, so), (w1, s1), (w2, s2) = quant(H * HD, D), quant(D, FF), quant(FF, D)
    cos, sin = rope_table(torch.arange(L), HD, 10000.0)
    ops = (x.to(dtype), s.to(dtype), torch.stack([wq, wk, wv]).to(dtype),
           wo.to(dtype), w1.to(dtype), w2.to(dtype),
           (torch.stack([sq, sk, sv]), so, s1, s2), torch.stack([cos, sin]),
           (1.0 + 0.1 * torch.randn((1, D), generator=gen)), None, None,
           torch.tensor(0.3))
    ops = tree_map(lambda a: None if a is None else a.cuda(), ops)
    kw = dict(num_heads=H, head_dim=HD, scale=1.0 / math.sqrt(HD),
              decay=0.5, v_th=1.0, soft_reset=False, eps=1e-5,
              l_block=l_block, family="rope", causal=True)
    return (ops, kw) if raw else FL.prepare(*ops, **kw)


def check_rope_kernel(dtype, what, shape, l_block):
    """The rope family, kernel vs plain version on int8 codes: counts
    equal and outputs bitwise equal (the analog products are summed in
    one order by both; the spike and count products are exact)."""
    args, kw = rope_operands(11, dtype, shape, l_block)
    out_k, cnt_k = FL.fused_layer_cuda(*args, **kw)
    out_p, cnt_p = FL.fused_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    name = f"fused_layer_rope {dtype} {what} {tuple(shape)}"
    if not (torch.equal(out_k, out_p) and torch.equal(cnt_k, cnt_p)):
        cfg_s = SpikingConfig(time_steps=shape[0])
        flips = int((lif_scan(out_k, cfg_s)[0]
                     != lif_scan(out_p, cfg_s)[0]).sum())
        raise AssertionError(f"{name}: kernel != plain version (max abs diff "
                             f"{err}, counts equal "
                             f"{torch.equal(cnt_k, cnt_p)}, LIF(out) spikes "
                             f"that differ {flips})")
    log(f"{name}, l_block {kw['l_block']}: bitwise equal to the plain "
        f"version; counts per phase {cnt_k.sum(dim=(0, 2)).tolist()}, "
        f"output std {float(out_k.float().std()):.4f}")
    return err


def check_layer_kernel(dtype, what="full width", shape=FULL, l_block=64,
                       sparse="tile"):
    """Kernel vs plain version on the card, dyadic weights: bitwise; the
    decoded variant also bitwise against the tile variant."""
    args, kw = layer_operands(1, dtype, True, shape, l_block, sparse)
    out_k, cnt_k = FL.fused_layer_cuda(*args, **kw)
    out_p, cnt_p = FL.fused_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    name = f"fused_layer {sparse} {dtype} {what}"
    if not (torch.equal(out_k, out_p) and torch.equal(cnt_k, cnt_p)):
        raise AssertionError(f"{name}: kernel != plain version (max abs diff "
                             f"{err}, counts equal "
                             f"{torch.equal(cnt_k, cnt_p)})")
    extra = ""
    if kw["decoded"]:
        out_t, _ = FL.fused_layer_cuda(*args, **dict(kw, decoded=False))
        if not torch.equal(out_k, out_t):
            raise AssertionError(f"{name}: decoded kernel != tile kernel on "
                                 f"dyadic weights")
        extra = " and to the tile variant"
    log(f"{name}, l_block {kw['l_block']}, dyadic: bitwise equal to the "
        f"plain version{extra}; counts per phase and L-block "
        f"{cnt_k.sum(dim=0).t().tolist()}")
    return err


def reset_counts():
    """Every launch count and every sparse='auto' decision count to 0."""
    for mod in KERNEL_MODULES:
        mod.reset_launches()
    E.reset_sparse_decisions()


def launches():
    counts = {}
    for mod in KERNEL_MODULES:
        counts.update(mod.LAUNCHES)
    return counts


def fold_analog(counts, engine, n_wo, what):
    """The launch counts with #2's analog-mode launches (the wo products
    of an analog-score layer) folded into ``spike_matmul``'s: the tile
    datapath's calls, checked against ``sparse_split``. The analog mode
    must have run on exactly the wo products the tile path took: all
    ``n_wo`` of them under sparse='tile', none under 'decoded', at most
    ``n_wo`` under 'auto'."""
    out = dict(counts)
    analog = out.pop("spike_matmul_analog")
    bad = {"tile": analog != n_wo, "decoded": analog != 0,
           "auto": analog > n_wo}[engine.sparse]
    if bad:
        raise AssertionError(f"{what}: {analog} analog-mode launches for "
                             f"{n_wo} wo products (sparse="
                             f"{engine.sparse!r})")
    out["spike_matmul"] += analog
    return out


def sparse_split(engine, n):
    """(tile, decoded) datapath calls among ``n``: from the engine's
    explicit path, or for 'auto' from the decisions it recorded, which
    must number ``n``."""
    if engine.sparse != "auto":
        return (n, 0) if engine.sparse == "tile" else (0, n)
    tile, dec = E.SPARSE_DECISIONS["tile"], E.SPARSE_DECISIONS["decoded"]
    if tile + dec != n:
        raise AssertionError(f"sparse='auto' decided {E.SPARSE_DECISIONS} "
                             f"for {n} calls")
    return tile, dec


def spikes(gen, shape, density, counts=False, count_max=L):
    """{0,1} spikes (or integer counts up to ``count_max``) with dark
    tiles: the first 256 rows, and columns [0, 64) of rows [256, 1024)."""
    s = (torch.rand(shape, generator=gen) < density).float()
    if counts:
        s = s * torch.randint(1, count_max + 1, shape, generator=gen).float()
    s[:256] = 0.0
    s[256:1024, :64] = 0.0
    return s


def ragged_spikes(gen, shape, counts=False, count_max=L):
    """Ragged, fine-grained spikes (or integer counts up to
    ``count_max``): each row's density uniform in [0, 0.6), the first
    256 rows dark (whole dark groups) and rows [256, 272) dense, so the
    groups get different pow2 capacities and chunks are skipped."""
    s = (torch.rand(shape, generator=gen)
         < torch.rand((shape[0], 1), generator=gen) * 0.6).float()
    s[:256] = 0.0
    s[256:272] = 1.0
    if counts:
        s = s * torch.randint(1, count_max + 1, shape, generator=gen).float()
    return s


def analog_values(gen, shape, normal=False):
    """An analog context as the wo product of an analog-score layer gets
    it: ragged rows (``ragged_spikes``' liveness) of non-integer and
    negative values, multiples of 1/16 in (-4, 4) (or, with ``normal``,
    standard normal), with -0.0 at every dark entry of rows [1024, 2048)
    and at columns [0, 8), where a live test on the raw value sees no
    entry."""
    live = ragged_spikes(gen, shape) != 0
    v = (torch.randn(shape, generator=gen) if normal else
         torch.randint(-63, 64, shape, generator=gen).float() / 16)
    s = torch.where(live, v, torch.zeros(()))
    s[1024:2048] = torch.where(live[1024:2048], s[1024:2048],
                               torch.full((), -0.0))
    s[:, :8] = -0.0
    return s


def matmul_operands(seed, m, k, n, dtype, counts=False, bias=False,
                    ragged=False, weights="dyadic", values="spikes",
                    count_max=L):
    """(s, w, bias) on the card. ``values``: 'spikes' ({0,1}, or counts
    up to ``count_max``; ragged or with dark tiles), 'analog' /
    'analog normal' (``analog_values``) or 'dark' (zeros and -0.0)."""
    gen = torch.Generator().manual_seed(seed)
    if values == "spikes":
        s = (ragged_spikes(gen, (m, k), counts, count_max) if ragged
             else spikes(gen, (m, k), 0.2, counts, count_max))
    elif values == "dark":
        s = torch.where(torch.rand((m, k), generator=gen) < 0.5,
                        torch.zeros(()), torch.full((), -0.0))
    else:
        s = analog_values(gen, (m, k), normal=values == "analog normal")
    w = (dyadic(gen, (k, n)) * 0.25 if weights == "dyadic"
         else torch.randn((k, n), generator=gen) / math.sqrt(k))
    b = dyadic(gen, (n,)) if bias else None
    ops = (s.to(dtype), w.to(dtype), b)
    return tuple(None if a is None else a.cuda() for a in ops)


def offset_by_one(a):
    """A copy of ``a`` whose data starts one element past a 16-byte
    boundary, so a kernel takes its element-by-element copies."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def matmul_bound(s, w, want):
    """#2's per-entry bound on a sum taken in another order than the plain
    version's: 2 (K - 1) 2^-24 sum_k |s_k w_kn| (two fp32 orders of a
    K-term sum), plus, in bf16, one bf16 ulp of the output, 2^-7 |y| (the
    two sums may round to neighbouring bf16 values)."""
    mag = s.double().abs() @ w.double().abs()
    tol = 2 * (s.shape[1] - 1) * 2.0 ** -24 * mag
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.double().abs()
    return tol, mag


def check_matmul(dtype, what, m, k, n, counts=False, bias=False,
                 values="spikes", weights="dyadic", count_max=L,
                 misaligned=False):
    """spike_matmul kernel vs plain version on ``matmul_operands``' values
    (spikes or counts with dark tiles, analog contexts, all dark).
    Bitwise on dyadic weights, where every partial sum is exact: spikes,
    counts and dark inputs always, an analog context wherever its least
    set bits prove the sums exact (else within ``matmul_bound``). On
    random-normal weights within ``matmul_bound``, with the share of
    equal entries logged. ``misaligned``: s and w offset by one element
    (the kernel's element-by-element copies)."""
    s, w, b = matmul_operands(4, m, k, n, dtype, counts, bias,
                              weights=weights, values=values,
                              count_max=count_max)
    if misaligned:
        s, w = offset_by_one(s), offset_by_one(w)
    got = SM.spike_matmul_cuda(s, w, b)
    want = SM.spike_matmul_plain(s, w, b)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    name = (f"spike_matmul {dtype} {what} M={m} K={k} N={n} {weights}"
            f"{' ' + values if values != 'spikes' else ''}"
            f"{' counts' if counts else ''}{' bias' if bias else ''}"
            f"{' misaligned' if misaligned else ''}")
    exact = weights == "dyadic"
    if exact and values.startswith("analog"):
        room = 2.0 ** (24 + least_bit(s) + least_bit(w))
        exact = float((s.double().abs() @ w.double().abs()).max()) < room
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain version (max abs "
                                 f"diff {err})")
        how = "bitwise equal to the plain version"
    else:
        tol, _ = matmul_bound(s, w, want)
        diff = (got.double() - want.double()).abs()
        if bool((diff > tol).any()):
            raise AssertionError(f"{name}: kernel outside its bound of the "
                                 f"plain version (max abs diff {err})")
        how = (f"within its bound of the plain version (max abs diff {err}, "
               f"entries equal {float((got == want).float().mean()):.6f})")
    tm, tk = SM.SKIP_TILE
    occ = SM.block_occupancy(F.pad(s, (0, -k % tk, 0, -m % tm)), tm, tk)
    log(f"{name}: {how}; live skip tiles {int(occ.sum())}/{occ.numel()}")
    return err


def check_matmul_analog(dtype, what, m, k, n, bias=False, values="analog",
                        weights="normal", misaligned=False):
    """spike_matmul's analog mode (``analog=True``: every output summed in
    ascending k on CUDA cores) against its plain version on the same
    operands: bitwise on any weights and values, the mode's contract."""
    s, w, b = matmul_operands(9, m, k, n, dtype, bias=bias, weights=weights,
                              values=values)
    if misaligned:
        s, w = offset_by_one(s), offset_by_one(w)
    got = SM.spike_matmul_cuda(s, w, b, analog=True)
    want = SM.spike_matmul_plain(s, w, b, analog=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    name = (f"spike_matmul analog mode {dtype} {what} M={m} K={k} N={n} "
            f"{weights} {values}{' bias' if bias else ''}"
            f"{' misaligned' if misaligned else ''}")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain version (max abs "
                             f"diff {err})")
    log(f"{name}: bitwise equal to the plain version")
    return err


def matmul_analog_bound_ms(s, w, out):
    """Bytes: s and w read once, the output written once; operations: the
    multiply-adds of the live chunks (64 rows x 32 k) at the fp32 CUDA
    cores' peak, where the analog mode runs in any dtype."""
    m, k = s.shape
    occ = SM.block_occupancy(F.pad(s, (0, -k % 32, 0, -m % 64)), 64, 32)
    ops_s = 2 * float(occ.sum()) * 64 * 32 * w.shape[1] / \
        PEAK_FLOPS[torch.float32]
    n_bytes = (s.numel() * s.element_size() + w.numel() * w.element_size()
               + out.numel() * out.element_size())
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def time_matmul_analog():
    """The analog mode at the wo product of a 4-256 analog-score layer
    (M = 16384, K = N = 256, bf16, analog context), timed (cuda_ms):
    kernel, plain version (a PyTorch add a k), ``torch.matmul``."""
    s, w, _ = matmul_operands(9, M_TRAIN, H * HD, D, torch.bfloat16,
                              weights="normal", values="analog")
    out = SM.spike_matmul_cuda(s, w, analog=True)
    row = dict(ms=cuda_ms(lambda: SM.spike_matmul_cuda(s, w, analog=True)),
               plain_ms=cuda_ms(lambda: SM.spike_matmul_plain(
                   s, w, analog=True), calls=3, repeats=3),
               library_ms=cuda_ms(lambda: torch.matmul(s, w)))
    row["bound_ms"], row["bound_by"] = matmul_analog_bound_ms(s, w, out)
    row["device_us"] = device_us(lambda: SM.spike_matmul_cuda(s, w,
                                                              analog=True))
    log(f"spike_matmul analog mode, bf16 wo M={M_TRAIN} K={H * HD} N={D} "
        f"on an analog context: {row}")
    return row


def gather_schedule(s, block_m=128, c_block=128):
    """The decoded schedule of s as the wrapper builds it."""
    m, k = s.shape
    bm = min(block_m, m)
    occ = (SD.pad_to_multiple(s, 0, bm) != 0).sum(-1, dtype=torch.int32)
    return SD.build_schedule(occ, bm, min(c_block, k), cap=k)


def check_gather_stage(name, s):
    """#4's device staging (``gather_stage``) against PyTorch on the same
    s: the order and sorted occupancies == ``stage_rows`` (a value live
    where it is not zero), and each row's flag == every non-zero of the
    row is 1; bitwise."""
    bm = min(128, s.shape[0])
    order, sorted_occ, ones, _ = SD.gather_stage(s, bm)
    want_order, want_occ = SD.stage_rows(s, bm)
    want_ones = ((s == 0) | (s == 1)).all(dim=1).int()
    torch.cuda.synchronize()
    for what, got, want in (("order", order, want_order),
                            ("sorted occupancies", sorted_occ, want_occ),
                            ("all-ones flags", ones, want_ones)):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: staged {what} != PyTorch's")
    return int(want_ones.sum())


def check_gather(dtype, what, m, k, n, counts=False, bias=False,
                 weights="dyadic", values="spikes", count_max=L):
    """gather_spike_matmul kernel vs plain version (on ragged spikes, or
    the ``values`` of ``matmul_operands``): bitwise for any weights (both
    sum each row's live products in ascending k, one rounded product and
    sum at a time); on dyadic weights also bitwise against spike_matmul.
    Its staging == PyTorch's (``check_gather_stage``)."""
    s, w, b = matmul_operands(8, m, k, n, dtype, counts, bias, ragged=True,
                              weights=weights, values=values,
                              count_max=count_max)
    got = SD.gather_spike_matmul_cuda(s, w, b)
    want = SD.gather_spike_matmul_plain(s, w, b)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    name = (f"gather_spike_matmul {dtype} {what} M={m} K={k} N={n} "
            f"{weights}{' ' + values if values != 'spikes' else ''}"
            f"{' counts' if counts else ''}{' bias' if bias else ''}")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain version (max abs "
                             f"diff {err})")
    spike_rows = check_gather_stage(name, s)
    extra = ""
    if weights == "dyadic":
        if not torch.equal(got, SM.spike_matmul_cuda(s, w, b)):
            raise AssertionError(f"{name}: != spike_matmul on dyadic weights")
        extra = " and to spike_matmul"
    sched = gather_schedule(s)
    log(f"{name}: bitwise equal to the plain version{extra}; staged order, "
        f"occupancies and flags == PyTorch's ({spike_rows} of {m} rows "
        f"all-ones); executed chunks {int(sched['executed'])}/"
        f"{sched['total']}, group capacities "
        f"{sorted(set(sched['caps'].tolist()))}")
    return err


def matmul_bound_ms(s, w, out):
    """Bytes: s and w read once, the output written once; operations: the
    multiply-adds of the live skip tiles at the operands' peak."""
    tm, tk = SM.SKIP_TILE
    m, k = s.shape
    occ = SM.block_occupancy(F.pad(s, (0, -k % tk, 0, -m % tm)), tm, tk)
    ops_s = 2 * float(occ.sum()) * tm * tk * w.shape[1] / PEAK_FLOPS[s.dtype]
    n_bytes = (s.numel() * s.element_size() + w.numel() * w.element_size()
               + out.numel() * out.element_size())
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def gather_bound_ms(s, w, out):
    """Bytes: s, w, the output and the staged schedule (row order int64,
    sorted occupancies int32) once each; operations: one multiply-add
    per live entry and output column, at the operands' peak."""
    m, k = s.shape
    mp = -(-m // min(128, m)) * min(128, m)
    ops_s = 2 * float((s != 0).sum()) * w.shape[1] / PEAK_FLOPS[s.dtype]
    n_bytes = (s.numel() * s.element_size() + w.numel() * w.element_size()
               + out.numel() * out.element_size() + 12 * mp)
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


@contextlib.contextmanager
def gather_dtypes():
    """Within the scope, the (s, w) dtypes of every call of #4's CUDA
    wrapper, collected into the set it yields."""
    seen, real = set(), SD.gather_spike_matmul_cuda

    def spy(s, w, bias=None, **kw):
        seen.add((s.dtype, w.dtype))
        return real(s, w, bias, **kw)
    SD.gather_spike_matmul_cuda = spy
    try:
        yield seen
    finally:
        SD.gather_spike_matmul_cuda = real


def gather_floor_ms():
    """The least time #4's contract (one rounded fp32 add a live entry and
    output column, on the CUDA cores) allows for the six products of
    time_products' operands: the live adds at the fp32 pipe's 128 a clock
    an SM, and the bf16 weights they read at 64 widened (or read from
    shared memory) a clock an SM, at the card's SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e3 * int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True
    ).stdout.split()[0]) * 1e3
    adds = 0.0
    for _, k, n, counts in MATMULS:
        s, w, _ = matmul_operands(5, M_TRAIN, k, n, torch.bfloat16, counts)
        adds += float((s != 0).sum()) * n
    floor = dict(live_adds=adds, sm_clock_mhz=clock_hz / 1e6,
                 fp32_adds_ms=1e3 * adds / (128 * sms * clock_hz),
                 bf16_feed_ms=1e3 * adds / (64 * sms * clock_hz))
    log(f"gather_spike_matmul, the six products' contract floor: {floor}")
    return floor


def time_products(name, kernel, plain, bound):
    """The six products of one training layer, bf16 as the engine calls
    them, on the spikes of the spike_matmul timing, each timed (cuda_ms):
    kernel, plain version, torch.matmul on the same operands; and the
    device us a call of each kernel the wrapper launches (``device_us``).
    Returns the totals, with each product's ms and device us."""
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by, per_product = set(), {}
    for what, k, n, counts in MATMULS:
        s, w, _ = matmul_operands(5, M_TRAIN, k, n, torch.bfloat16, counts)
        row = dict(ms=cuda_ms(lambda: kernel(s, w)),
                   plain_ms=cuda_ms(lambda: plain(s, w)),
                   library_ms=cuda_ms(lambda: torch.matmul(s, w)))
        row["bound_ms"], by = bound(s, w, kernel(s, w))
        bound_by.add(by)
        for key in total:
            total[key] += row[key]
        dev = device_us(lambda: kernel(s, w))
        per_product[what] = dict(ms=row["ms"], device_us=dev)
        log(f"{name} bf16 {what} M={M_TRAIN} K={k} N={n}: kernel "
            f"{row['ms']:.4f} ms (device us a call {dev}), plain "
            f"{row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.5f} ms ({by})")
    total["bound_by"] = "/".join(sorted(bound_by))
    total["products"] = per_product
    log(f"{name}, the six products of a layer: {total}")
    return total


def device_us(fn, calls=10):
    """The device us a call of each kernel (or memset) ``fn`` launches, by
    kernel name: torch.profiler over ``calls`` calls."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        name = re.search(r"gather_walk|quant_gather_mma|stage_row_pass|"
                         r"stage_counting_sort|tile_product|"
                         r"popcount_scores_kernel|spike_attention_kernel|"
                         r"Memset", e.key)
        if name and e.device_time_total > 0:
            us[name.group(0)] = round(
                us.get(name.group(0), 0.0) + e.device_time_total / calls, 2)
    return us


def time_gather_parts(dtype):
    """Where #4's time goes on the six products of a training layer (the
    operands of time_products, in ``dtype``): by cuda_ms its staging alone
    (``gather_stage``), its kernel alone on a staged workspace
    (``launch_gather``) and the whole wrapper, and the device us a call
    of each of the wrapper's kernels (``device_us``). Returns the totals
    over the six products, the device us under ``device_us``."""
    parts, device_total = {}, {}
    for what, k, n, counts in MATMULS:
        s, w, _ = matmul_operands(5, M_TRAIN, k, n, dtype, counts)
        staged = SD.gather_stage(s, min(128, M_TRAIN))
        out = torch.empty((M_TRAIN, n), dtype=dtype, device=s.device)
        fns = dict(staging=lambda: SD.gather_stage(s, min(128, M_TRAIN)),
                   kernel=lambda: SD.launch_gather(s, w, None, staged,
                                                   out=out),
                   whole=lambda: SD.gather_spike_matmul_cuda(s, w))
        row = {name: cuda_ms(fn) for name, fn in fns.items()}
        for name, ms in row.items():
            parts[name] = parts.get(name, 0.0) + ms
        dev = device_us(fns["whole"])
        for name, us in dev.items():
            device_total[name] = round(device_total.get(name, 0.0) + us, 2)
        log(f"gather_spike_matmul {dtype} {what} K={k} N={n}: "
            + ", ".join(f"{name} {ms:.4f} ms" for name, ms in row.items())
            + f"; device us a call {dev}")
    parts["device_us"] = device_total
    log(f"gather_spike_matmul {dtype}, the six products of a layer: {parts}")
    return parts


def attention_operands(seed, bh, l, d, dtype):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = ((torch.rand((bh, l, d), generator=gen) < p).float()
               for p in (0.15, 0.15, 0.2))
    k[0, :16] = 0.0                     # a dark key block
    return tuple(a.to(dtype).cuda() for a in (q, k, v))


def check_attention(dtype, bh, l, d, causal, binarize=True):
    """spike_attention kernel vs plain version: bitwise, on binarized
    scores and on analog ones (both sum the analog scores over the keys
    in ascending order)."""
    q, k, v = attention_operands(6, bh, l, d, dtype)
    kw = dict(scale=1.0 / math.sqrt(d), delta=0.3, causal=causal,
              binarize_scores=binarize)
    got = SA.spike_attention_cuda(q, k, v, **kw)
    want = SA.spike_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"spike_attention {dtype} BH={bh} L={l} d={d} "
                             f"causal={causal} binarize={binarize}: kernel "
                             f"!= plain version (max abs diff {err})")
    log(f"spike_attention {dtype} BH={bh} L={l} d={d} causal={causal} "
        f"binarize={binarize}: bitwise equal to the plain version, context "
        f"mean {float(got.float().mean()):.4f}")
    return err


def time_attention(bh, l, d, causal, binarize=True):
    """bf16: cuda_ms and the profiler's device us of the kernel. No single
    PyTorch call computes binary attention (scaled_dot_product_attention
    applies a softmax), so there is no library time. Bound: q, k, v read
    once and the context written once, or the multiply-adds at their
    peak: both products at the bf16 tensor peak, an analog context's at
    the fp32 one (with ``causal``, only the query-key pairs on or below
    the diagonal). Analog scores also get the floor of their ascending
    sums on the CUDA cores: one fp32 add a set value bit and query row
    that sees its key, at the fp32 pipe's 128 a clock an SM (132 SMs at
    1980 MHz)."""
    q, k, v = attention_operands(7, bh, l, d, torch.bfloat16)
    kw = dict(scale=1.0 / math.sqrt(d),
              delta=torch.tensor(0.3, device=q.device), causal=causal,
              binarize_scores=binarize)
    ms = cuda_ms(lambda: SA.spike_attention_cuda(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: SA.spike_attention_plain(q, k, v, **kw),
                       calls=5 if l > 1024 or not binarize else 20)
    pairs = l * (l + 1) // 2 if causal else l * l
    context = PEAK_FLOPS[torch.bfloat16 if binarize else torch.float32]
    ops_s = 2 * bh * pairs * d * (1 / PEAK_FLOPS[torch.bfloat16]
                                  + 1 / context)
    bytes_s = 4 * q.numel() * q.element_size() / PEAK_BYTES
    bound = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                 bound_ms=1e3 * max(ops_s, bytes_s),
                 bound_by="operations" if ops_s >= bytes_s else "bytes",
                 device_us=device_us(
                     lambda: SA.spike_attention_cuda(q, k, v, **kw)))
    if not binarize:
        sets = v.float().sum(-1)                       # (BH, L) a key's
        rows = (l - torch.arange(l, device=v.device)) if causal else l
        adds = float((sets * rows).sum())
        bound["floor_ms"] = 1e3 * adds / (132 * 128 * 1.98e9)
    log(f"spike_attention bf16 BH={bh} L={l} d={d} causal={causal} "
        f"binarize={binarize}: {bound}")
    return bound


class plain_kernels:
    """Within the scope, the CUDA launchers of the kernels run their plain
    versions on the card's tensors instead (and count nothing)."""

    LAUNCHERS = ((SM, "spike_matmul"), (SA, "spike_attention"),
                 (SD, "gather_spike_matmul"), (FL, "fused_layer"),
                 (FL, "fused_layer_pipeline"),
                 (SM, "quant_spike_matmul"),
                 (SD, "quant_gather_spike_matmul"),
                 (FS, "fused_ssa"), (PA, "popcount_scores"),
                 (LF, "lif_forward"))

    def __enter__(self):
        self.saved = [getattr(mod, f"{name}_cuda")
                      for mod, name in self.LAUNCHERS]
        for mod, name in self.LAUNCHERS:
            setattr(mod, f"{name}_cuda", getattr(mod, f"{name}_plain"))

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.LAUNCHERS, self.saved):
            setattr(mod, f"{name}_cuda", fn)


def dyadic_grid(params):
    """Every float param rounded to the 2^-8 grid: a layer's spike and
    count products (q/k/v of the vision family, wo, w1 / up, w2 / down)
    are then exact fp32 sums in any order."""
    return tree_map(lambda a: torch.round(a * 256) / 256
                    if a.is_floating_point() else a, params)


def dyadic_params(params):
    """Params on the 2^-8 grid, BN biases raised by 1/4 so layers fire."""
    dy = dyadic_grid(params)
    for bn in [p["bn"] for p in dy["sps"]] + [
            v for k, v in dy["blocks"].items() if k.startswith("bn_")]:
        bn["bias"] = bn["bias"] + 0.25
    return dy


def timed_requests(step, params, requests):
    """(logits, ms) of ``step`` on each request, synchronised."""
    outs, req_ms = [], []
    for batch in requests:
        t0 = time.perf_counter()
        outs.append(step(params, batch))
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
    return outs, req_ms


def inference_path(cfg, params, requests):
    """``build_prefill_step`` answering ``requests``: per-request times,
    the launch counts of the whole run (3 fused-layer launches a layer,
    of the variant the sparse datapath names), finite logits."""
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts = launches()
    tile, dec = sparse_split(cfg.engine, cfg.num_layers * len(requests))
    n_img = len(requests[0]["images"])
    what = f"inference path, {cfg.name}, sparse={cfg.engine.sparse!r}"
    log(f"{what}: {len(requests)} requests x {n_img} images, per-request ms "
        f"{[round(m, 3) for m in req_ms]}, sparse decisions "
        f"{dict(E.SPARSE_DECISIONS)}, launches {counts}")
    want = dict.fromkeys(counts, 0)
    want["fused_layer"] = FL.LAUNCHES_PER_CALL["bn"] * tile
    want["fused_layer_decoded"] = FL.LAUNCHES_PER_CALL["bn"] * dec
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    for logits in outs:
        if logits.shape != (n_img, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
    return counts


def train_path(cfg, qat=None, batch=TRAIN_BATCH, falls=True):
    """A training main path: 6 AdamW steps of ``batch`` images, with the
    launch counts of the whole run (6 sparse products a layer, through
    the kernel of the datapath each took; 1 binary attention a layer,
    ``spike_attention`` or, with ``binary='popcount'``,
    ``popcount_scores``; with ``qat`` the same, on the fake-quantized
    weights; CIFAR-Net, which has no engine, none at all); with
    ``falls`` the last loss must be below the first (not asked of a
    config with many more classes than a batch has images: each batch
    then holds mostly classes that no earlier step saw and that every
    earlier step pushed down, so the first steps raise the loss); the
    metrics must be finite and every param leaf must move."""
    dev = torch.device("cuda")
    opt = adamw(warmup_cosine(TRAIN_LR, max(1, TRAIN_STEPS // 20),
                              TRAIN_STEPS))
    step_fn = steps.build_train_step(cfg, opt, qat=qat)
    params = registry.init(cfg, seed=0)
    opt_state = opt.init(params)
    model_state = registry.init_state(cfg)
    batch_fn = make_batch_fn(cfg, batch)
    batches = [batch_fn(i) for i in range(TRAIN_STEPS)]
    p = params
    torch.cuda.synchronize()
    reset_counts()
    step_ms, metrics = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        p, opt_state, _, m, model_state = step_fn(p, opt_state, i, b,
                                                  model_state)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    counts = launches()
    want = dict.fromkeys(counts, 0)
    if cfg.engine is None:
        what = f"train path, {cfg.name}"
    else:
        what = (f"train path, {cfg.name}, sparse={cfg.engine.sparse!r}, "
                f"binary={cfg.engine.binary!r}"
                f"{'' if cfg.spiking.binarize_scores else ', analog scores'}"
                f"{f', qat={qat!r}' if qat else ''}")
        tile, dec = sparse_split(cfg.engine,
                                 6 * cfg.num_layers * TRAIN_STEPS)
        want.update(spike_matmul=tile, gather_spike_matmul=dec,
                    gather_stage=dec)
        want[attention_kernel(cfg)] = cfg.num_layers * TRAIN_STEPS
    log(f"{what}: {TRAIN_STEPS} steps x {batch} images on {dev}, "
        f"ms per step {[round(x, 3) for x in step_ms]}, sparse decisions "
        f"{dict(E.SPARSE_DECISIONS)}, launches {counts}")
    log(f"{what}: losses {[round(m['loss'], 4) for m in metrics]}, "
        f"grad norms {[round(m['grad_norm'], 4) for m in metrics]}, "
        f"fire rates {[round(m['fire_rate'], 4) for m in metrics]}")
    if cfg.engine is not None:
        counts_tile = fold_analog(counts, cfg.engine,
                                  0 if cfg.spiking.binarize_scores
                                  else cfg.num_layers * TRAIN_STEPS, what)
        want.pop("spike_matmul_analog")
    else:
        counts_tile = counts
    if counts_tile != want:
        raise AssertionError(f"{what} launches {counts}, expected {want}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        raise AssertionError(f"non-finite train metrics {metrics}")
    if falls and not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError(f"{what}: the loss did not fall "
                             f"{[m['loss'] for m in metrics]}")
    still = [i for i, (a, b) in enumerate(zip(tree_leaves(params),
                                              tree_leaves(p)))
             if torch.equal(a, b)]
    if still:
        raise AssertionError(f"param leaves {still} did not move")
    log(f"{what}: every one of {len(tree_leaves(p))} param leaves moved, "
        f"max abs param {max(float(a.abs().max()) for a in tree_leaves(p))}")
    return counts, step_ms


def attention_kernel(cfg):
    """The kernel a binary attention of ``cfg``'s engine launches on the
    card."""
    return ("popcount_scores" if cfg.engine.binary == "popcount"
            else "spike_attention")


def check_train_gradients(cfg, binary="mxu_kernel", qat=None):
    """One train step's loss, gradients and new BN state through the
    kernels (mode='sparse', the given binary mode, the config's sparse
    datapath) against the same step with the kernels swapped for their
    plain versions, on 8 images with dyadic params: bitwise, since every
    kernel sums in its plain version's order or over exact terms, and
    the backward is the same PyTorch code on the same forward values.
    With ``qat`` the step fake-quantizes the linears, on masters whose
    per-column amax is ``qmax * 2^-e`` (:func:`qat_masters`), so the
    weights the kernels see are dyadic too. Returns the kernels' run:
    [loss, gradients..., BN state...]."""
    cfg = cfg.replace(engine=cfg.engine.replace(mode="sparse",
                                                binary=binary))
    params = dyadic_params(registry.init(cfg, seed=2))
    if qat is not None:
        params = qat_masters(params, qat)
    gen = torch.Generator().manual_seed(3)
    v = cfg.vision
    batch = {"images": (torch.randint(0, 256, (8, v.img_size, v.img_size,
                                               v.in_channels),
                                      generator=gen) / 256.0).cuda(),
             "labels": torch.randint(0, cfg.vocab_size, (8,),
                                     generator=gen).cuda()}
    state = registry.init_state(cfg)
    torch.backends.cudnn.deterministic = True
    runs = []
    for plain in (False, True):
        reset_counts()
        with (plain_kernels() if plain else contextlib.nullcontext()):
            loss, aux, grads = steps.value_and_grad(cfg, params, batch,
                                                    state, qat=qat)
        runs.append([loss] + tree_leaves(grads) + tree_leaves(aux["state"]))
        tile, dec = sparse_split(cfg.engine, 6 * cfg.num_layers)
        want = dict.fromkeys(launches(), 0)
        if not plain:
            want.update(spike_matmul=tile, gather_spike_matmul=dec,
                        gather_stage=dec)
            want[attention_kernel(cfg)] = cfg.num_layers
        if launches() != want:
            what = "plain versions" if plain else "kernels"
            raise AssertionError(f"gradient check through the {what} "
                                 f"launched {launches()}, expected {want}")
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(*runs))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"train step through the kernels != through the "
                             f"plain versions at leaves {differ} (0 = loss)")
    log(f"check, sparse={cfg.engine.sparse!r}, binary={binary!r}"
        f"{f', qat={qat!r}' if qat else ''}: one train "
        f"step through the kernels == through the plain versions, bitwise "
        f"(loss {float(runs[0][0]):.6f}, {len(tree_leaves(grads))} "
        f"gradients, {len(tree_leaves(aux['state']))} BN state leaves; "
        f"sparse decisions {tile} tile, {dec} decoded)")
    return runs[0]


def time_rope_kernel():
    """#1c at the prefill's shape (LM_FULL), bf16 int8 codes: kernel and
    plain version (cuda_ms; the plain version, ~1000 sequential k-steps,
    over fewer calls) and the bound of its executed work."""
    args, kw = rope_operands(3, torch.bfloat16)
    ms = cuda_ms(lambda: FL.fused_layer_cuda(*args, **kw))
    plain_ms = cuda_ms(lambda: FL.fused_layer_plain(*args, **kw), warmup=1,
                       calls=2, repeats=3)
    _, counts = FL.fused_layer_cuda(*args, **kw)
    bound_ms, bound_by = layer_bound_ms(args, counts, torch.bfloat16,
                                        kw["l_block"], shape=LM_FULL,
                                        causal=True)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    log(f"fused_layer_rope bf16 {LM_FULL}: {row}")
    return row


def lm_config(quantize, select=None):
    """The published spikingformer-lm with seeded random weights; with
    ``quantize`` the int8 tree and the int8 weights declaration, as
    ``launch/serve.py --quantize int8`` loads it; with ``select`` too,
    the mixed tree of the linears it selects (the rest bf16, the
    declaration left fp32, as for the mixed vision tree)."""
    cfg = get_config("spikingformer-lm")
    params = registry.init(cfg, seed=0)
    if quantize:
        params = quantize_tree(params, "int8", select=select)
        if select is None:
            cfg = cfg.replace(engine=cfg.engine.replace(weights="int8"))
    return cfg, params


def lm_prefill_path(cfg, params, requests, what):
    """``build_prefill_step`` answering ``requests`` of LM_BATCH x
    LM_PROMPT tokens, the counts reset just before: the int8 model runs
    6 ``fused_layer_rope`` launches a layer call and 'auto' decides
    'tile' on every analog ln1 output; the bf16 model's layers are not
    eligible for the layer program and run 1 causal ``spike_attention``
    a layer call; the mixed int8 tree's (int8 wq, wk, wv) are not either,
    and run the bundle kernel's rope family, 2 ``fused_ssa_rope`` launches
    a layer call, with no 'auto' decision; with ``binary='popcount'`` the bf16
    model's attention is 1 ``popcount_scores`` a layer call; with analog
    scores ('analog int8') the int8 model's layers are not eligible for
    the layer program and run the rope bundle's analog instantiation, 1
    ``fused_ssa_rope_analog`` a layer call, with no 'auto' decision.
    Per-request times, finite logits."""
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts, decisions = launches(), dict(E.SPARSE_DECISIONS)
    n = cfg.num_layers * len(requests)
    log(f"lm prefill path, {what}: {len(requests)} requests x {LM_BATCH} x "
        f"{LM_PROMPT} tokens, per-request ms {[round(m, 3) for m in req_ms]}"
        f", sparse decisions {decisions}, launches {counts}")
    want = dict.fromkeys(counts, 0)
    want_dec = {"tile": 0, "decoded": 0}
    if what == "int8":
        want["fused_layer_rope"] = FL.LAUNCHES_PER_CALL["rope"] * n
        want_dec["tile"] = n
    elif what == "mixed int8":
        want["fused_ssa_rope"] = FS.LAUNCHES_PER_CALL * n
    elif what == "analog int8":
        want["fused_ssa_rope_analog"] = FS.LAUNCHES_PER_CALL * n
    else:
        want[attention_kernel(cfg)] = n
    if counts != want or decisions != want_dec:
        raise AssertionError(f"lm prefill path {what}: launches {counts}, "
                             f"decisions {decisions}; expected {want}, "
                             f"{want_dec}")
    for logits in outs:
        if logits.shape != (LM_BATCH, LM_PROMPT, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad lm logits {tuple(logits.shape)}")
    return counts, req_ms


def check_lm_prefill(cfg, params, batch, what, oracle=False):
    """The prefill of one main-path request (LM_BATCH x LM_PROMPT tokens)
    through the kernels == through their plain versions, bitwise; with
    ``oracle`` also == the same prefill under overlap='off'."""
    step = steps.build_prefill_step(cfg)
    got = step(params, batch)
    with plain_kernels():
        want = step(params, batch)
    off = steps.build_prefill_step(cfg.replace(
        engine=cfg.engine.replace(overlap="off")))(params, batch) \
        if oracle else got
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, off)):
        raise AssertionError(
            f"lm prefill {what}: through the kernels == through the plain "
            f"versions {torch.equal(got, want)} (max abs diff "
            f"{float((got - want).abs().max())}), == overlap='off' "
            f"{torch.equal(got, off)} (max abs diff "
            f"{float((got - off).abs().max())})")
    log(f"check, lm prefill {what}: logits through the kernels == through "
        f"the plain versions{' == overlap=off' if oracle else ''} bitwise "
        f"on {LM_BATCH} x {LM_PROMPT} tokens, logit std "
        f"{float(got.std()):.4f}")


def long_prompt_path(cfg, params, what="bf16"):
    """One spikingformer-lm prompt of LONG_PROMPT tokens through
    ``build_prefill_step``, the counts reset just before: bf16 (past #7's
    2048-key chunk), 1 causal ``spike_attention`` a layer; int8 (past
    launch A's former shared-memory bound of 3744 tokens), 3
    ``fused_layer_rope`` launches a layer; mixed int8, 2 ``fused_ssa_rope``
    launches a layer; no other launch; finite logits of the right shape,
    == the same prompt through the plain versions, bitwise. Returns (ms
    of the kernels' run, counts)."""
    gen = torch.Generator().manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                                     generator=gen).cuda()}
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    (got,), (ms,) = timed_requests(step, params, [batch])
    counts = launches()
    want = dict.fromkeys(counts, 0)
    if what == "int8":
        want["fused_layer_rope"] = FL.LAUNCHES_PER_CALL["rope"] * \
            cfg.num_layers
    elif what == "mixed int8":
        want["fused_ssa_rope"] = FS.LAUNCHES_PER_CALL * cfg.num_layers
    else:
        want["spike_attention"] = cfg.num_layers
    if counts != want:
        raise AssertionError(f"long prompt: launches {counts}, expected "
                             f"{want}")
    with plain_kernels():
        plain = step(params, batch)
    torch.cuda.synchronize()
    if got.shape != (1, LONG_PROMPT, cfg.vocab_size) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"bad long-prompt logits {tuple(got.shape)}")
    if not torch.equal(got, plain):
        raise AssertionError(f"long prompt: logits through the kernels != "
                             f"through the plain versions (max abs diff "
                             f"{float((got - plain).abs().max())})")
    log(f"long prompt, {what} spikingformer-lm, 1 x {LONG_PROMPT} tokens: "
        f"{ms:.3f} ms (first call), launches "
        f"{ {k: v for k, v in counts.items() if v} }; logits through "
        f"the kernels == through the plain versions bitwise, logit std "
        f"{float(got.float().std()):.4f}")
    return ms, counts


def wide_head_path():
    """An eval layer at head_dim 160 (WIDE_HEAD), which launch A does not
    take, through ``core/engine.layer_step`` (Spikingformer-4-256's widths,
    bf16, dyadic firing weights) and ``layer_step_causal``
    (spikingformer-lm's, fp32), each under its config's engine ('auto',
    so the kernels), the counts reset just before: the engine routes both
    to the sequential composition, whose attention is #7 at d = 160:
    ``layer_step`` 1 ``spike_attention`` and its 6 spike products
    (``spike_matmul`` or ``gather_spike_matmul`` as 'auto' decides, with
    their staging), ``layer_step_causal`` 1 ``spike_attention`` (its
    projections are dense), no layer program and no bundle kernel; each
    output finite, == the same layer through the plain versions,
    bitwise. Returns {what: (ms, counts)}."""
    gen = torch.Generator().manual_seed(12)
    cfg = get_config("spikingformer-4-256").replace(**WIDE_HEAD)
    params = dyadic_params(registry.init(cfg, seed=5))
    layer = tree_map(lambda a: a[0], params["blocks"])
    state = tree_map(lambda a: a[0], registry.init_state(cfg)["blocks"])
    x = (torch.randint(-64, 224, (T, WIDE_VISION_B, L, D), generator=gen)
         / 128.0).to(layer["wq"]["w"].dtype).cuda()
    lcfg = get_config("spikingformer-lm").replace(dtype="float32",
                                                  **WIDE_HEAD)
    lm_layer = tree_map(lambda a: a[0], registry.init(lcfg, seed=6)["layers"])
    h = (torch.randn((T, WIDE_LM_B, WIDE_LM_S, lcfg.d_model), generator=gen)
         * 0.5).cuda()
    pos = torch.arange(WIDE_LM_S).cuda()
    runs = {"layer_step": (cfg, lambda: E.layer_step(layer, state, cfg,
                                                     x)[0]),
            "layer_step_causal": (lcfg, lambda: E.layer_step_causal(
                lm_layer, lcfg, h, pos))}
    out = {}
    for what, (c, fn) in runs.items():
        with use_engine(c.engine):
            act = x if what == "layer_step" else h
            if FL.launch_a_takes(act.element_size(), c.d_model, c.num_heads,
                                 c.head_dim, rope=what != "layer_step"):
                raise AssertionError(f"{what}: launch A takes head_dim "
                                     f"{c.head_dim}")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = launches()
            want = dict.fromkeys(counts, 0)
            want["spike_attention"] = 1
            if what == "layer_step":
                tile, dec = sparse_split(c.engine, 6)
                want.update(spike_matmul=tile, gather_spike_matmul=dec,
                            gather_stage=dec)
            if counts != want:
                raise AssertionError(f"head_dim 160 {what}: launches "
                                     f"{counts}, expected {want}")
            with plain_kernels():
                plain = fn()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or got.shape != plain.shape:
            raise AssertionError(f"head_dim 160 {what}: bad output")
        if not torch.equal(got, plain):
            raise AssertionError(
                f"head_dim 160 {what}: through the kernels != through the "
                f"plain versions (max abs diff "
                f"{float((got.float() - plain.float()).abs().max())})")
        log(f"head_dim 160 eval layer through {what} ({c.name} widths, "
            f"{tuple(got.shape)} {got.dtype}): the sequential composition, "
            f"{ms:.3f} ms (first call), launches "
            f"{ {k: v for k, v in counts.items() if v} }; == the plain "
            f"versions bitwise, output std {float(got.float().std()):.4f}")
        out[what] = (ms, counts)
    return out


def first_token_check(cfg, params, completed, what):
    """Each request's first generated token == the argmax of the prefill
    step's last-position logits on its prompt wherever their top-2
    margin exceeds SERVE_MARGIN. Returns (checked, max abs diff of the
    first-token logits, decode path against the prefill step). A vlm's
    text prompts take its backbone's prefill (the dense family's)."""
    if cfg.family == "vlm":
        cfg = cfg.replace(family="dense")
    prefill = steps.build_prefill_step(cfg)
    checked, max_diff = 0, 0.0
    for r in completed:
        want = prefill(params, {"tokens": torch.from_numpy(r.prompt)[None]
                                .cuda()})[0, -1]
        got = torch.from_numpy(r.logit_trace[0]).cuda()
        max_diff = max(max_diff, float((got - want).abs().max()))
        top2 = want.topk(2).values
        if float(top2[0] - top2[1]) > SERVE_MARGIN:
            checked += 1
            if r.generated[0] != int(want.argmax()):
                raise AssertionError(f"{what}, request {r.rid}: first token "
                                     f"{r.generated[0]} != prefill argmax "
                                     f"{int(want.argmax())}")
    log(f"check, {what}: {checked} of {len(completed)} requests with a "
        f"top-2 margin above {SERVE_MARGIN}: first token == the prefill "
        f"step's argmax; max abs diff of the first-token logits, decode "
        f"path vs prefill step: {max_diff}")
    return checked, max_diff


def serve_requests(cfg):
    """SERVE_REQUESTS requests with random prompts of SERVE_PROMPTS tokens,
    SERVE_NEW new tokens each (seed 5)."""
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(SERVE_PROMPTS[0],
                                            SERVE_PROMPTS[1] + 1))
    ).astype(np.int32), max_new_tokens=SERVE_NEW)
        for i in range(SERVE_REQUESTS)]


def serve_path(cfg, params):
    """The int8 server at full width: ``serve_requests`` over SERVE_SLOTS
    slots, cache SERVE_MAX_LEN. Tokens per second on the host clock
    around the synchronised run; the run launches no kernel and makes no
    'auto' decision. Each request's first generated token
    equals the argmax of the prefill step's last-position logits on its
    prompt wherever their top-2 margin exceeds SERVE_MARGIN. Returns
    (the row, {rid: generated tokens})."""
    reqs = serve_requests(cfg)
    server = BatchedServer(cfg, params, SERVE_SLOTS, SERVE_MAX_LEN,
                           trace_logits=True)
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    waves = server.run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launches()
    n_gen = sum(len(r.generated) for r in server.completed)
    n_pre = sum(len(r.prompt) for r in server.completed)
    row = dict(seconds=sec, waves=waves, generated=n_gen, prompt=n_pre,
               tokens_per_s=(n_gen + n_pre) / sec,
               generated_per_s=n_gen / sec, kv=server.kv_cache_stats())
    decisions = dict(E.SPARSE_DECISIONS)
    log(f"serve path, int8: {row}; launches {counts}, sparse decisions "
        f"{decisions}")
    if counts != dict.fromkeys(counts, 0) or any(decisions.values()):
        raise AssertionError(f"serve path: launches {counts}, decisions "
                             f"{decisions}; the decode step and its chunked "
                             f"prefill are plain PyTorch and launch nothing")
    if len(server.completed) != SERVE_REQUESTS or \
            any(len(r.generated) != SERVE_NEW for r in server.completed):
        raise AssertionError("the server did not complete every request")
    first_token_check(cfg, params, server.completed, "serve")
    return row, {r.rid: r.generated for r in server.completed}


def vision_int8_path():
    """One int8 Spikingformer-4-256 request of 64 images: every layer is
    all-quantized, so eligible for the layer program: 3 fused-layer
    launches a layer, the variant the 'auto' decisions name."""
    cfg = get_config("spikingformer-4-256")
    params = quantize_tree(registry.init(cfg, seed=0), "int8")
    cfg = cfg.replace(engine=cfg.engine.replace(weights="int8"))
    gen = torch.Generator().manual_seed(6)
    v = cfg.vision
    batch = {"images": torch.rand((REQUEST_BATCH, v.img_size, v.img_size,
                                   v.in_channels), generator=gen)}
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = launches()
    tile, dec = sparse_split(cfg.engine, cfg.num_layers)
    want = dict.fromkeys(counts, 0)
    want["fused_layer"] = FL.LAUNCHES_PER_CALL["bn"] * tile
    want["fused_layer_decoded"] = FL.LAUNCHES_PER_CALL["bn"] * dec
    log(f"vision int8 request: {ms:.3f} ms (first call), launches {counts}")
    if counts != want or logits.shape != (REQUEST_BATCH, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"vision int8 request: launches {counts} "
                             f"(expected {want}), logits "
                             f"{tuple(logits.shape)}")


def quant_operands(seed, m, k, n, dtype, counts=False, bias=False,
                   ragged=False, count_max=QUANT_COUNT_MAX):
    """A quantized product's operands on the card: spikes with dark tiles
    (or ragged fine-grained spikes), times integer counts up to
    ``count_max`` with ``counts``, in the activation dtype; int8 codes;
    random fp32 scales and biases."""
    gen = torch.Generator().manual_seed(seed)
    s = (ragged_spikes(gen, (m, k)) if ragged
         else spikes(gen, (m, k), 0.2))
    if counts:
        s = s * torch.randint(1, count_max + 1, (m, k), generator=gen)
    qw = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
    scale = torch.rand((n,), generator=gen) * 0.02 + 1e-3
    b = torch.randn((n,), generator=gen) if bias else None
    ops = (s.to(dtype), qw, scale, b)
    return tuple(None if a is None else a.cuda() for a in ops)


def union_steps(lanes, order):
    """#5's work on a staged order: each block's union width (the lanes
    any of its QUANT_BLOCK_ROWS sorted rows holds; padding rows dark),
    computed in PyTorch. Returns (k-steps it runs, k-steps of the dense
    product, the mean union width over K)."""
    m, k = lanes.shape
    rows = SD.QUANT_BLOCK_ROWS
    live = torch.zeros((-(-order.numel() // rows) * rows, k),
                       dtype=torch.bool, device=lanes.device)
    real = order < m
    live[:order.numel()][real] = lanes[order[real]] != 0
    widths = live.reshape(-1, rows, k).any(dim=1).sum(dim=1)
    k = max(k, 1)
    steps = int((-(-widths // SD.QUANT_KSTEP)).sum())
    dense = widths.numel() * -(-k // SD.QUANT_KSTEP)
    return steps, dense, float(widths.float().mean()) / k


def hold_quant(name, s, qw, sc, b, counts, out_dtype,
               require_dense=False):
    """#5 on one set of operands: its device staging's order and sorted
    occupancies == ``stage_rows`` on the lanes, bitwise; its output ==
    its plain version == #3's kernel == #3's plain version, bitwise, and
    == ``dense_quant_linear`` wherever that reference is exact (integer
    values whose fp32 sums stay below 2^24, the output in s's dtype);
    with ``require_dense`` the operands must be such a case. Logs the
    byte planes, the union's k-steps beside the dense ones and JAX's
    executed chunks (``gather_schedule``). Returns the largest
    difference from the plain version (0)."""
    kw = dict(counts=counts, out_dtype=out_dtype)
    bm = min(128, s.shape[0])
    lanes = SM.quant_lanes(s, counts)
    order, sorted_occ, _ = SD.quant_stage(s, bm, counts)
    want_order, want_occ = SD.stage_rows(lanes, bm)
    dec = SD.quant_gather_spike_matmul_cuda(s, qw, sc, b, **kw)
    dec_p = SD.quant_gather_spike_matmul_plain(s, qw, sc, b, **kw)
    tile = SM.quant_spike_matmul_cuda(s, qw, sc, b, **kw)
    tile_p = SM.quant_spike_matmul_plain(s, qw, sc, b, **kw)
    torch.cuda.synchronize()
    checks = [("staged order != stage_rows", order, want_order),
              ("staged occupancies != stage_rows", sorted_occ, want_occ),
              ("quant_gather_spike_matmul kernel != plain", dec, dec_p),
              ("quant_spike_matmul kernel != plain", tile, tile_p),
              ("gather kernel != tile kernel", dec, tile)]
    exact = (out_dtype == s.dtype and bool((s == torch.trunc(s)).all())
             and float((lanes.double().abs() @ qw.double().abs()).max())
             < 2.0 ** 24)
    if require_dense and not exact:
        raise AssertionError(f"{name}: dense_quant_linear is not exact on "
                             f"these operands, so it cannot be compared")
    if exact:
        checks.append(("gather kernel != dense_quant_linear", dec,
                       E.dense_quant_linear(
                           {"qw": qw, "scale": sc,
                            **({} if b is None else {"b": b})}, s)))
    for label, x, y in checks:
        if not torch.equal(x, y):
            diff = float((x.double() - y.double()).abs().max())
            raise AssertionError(f"{name}: {label} (max abs diff {diff})")
    steps, dense, width = union_steps(lanes, order)
    sched = gather_schedule(s)
    log(f"{name}: staged order and occupancies == stage_rows; #5 == its "
        f"plain version == #3 (kernel, plain)"
        f"{' == dense_quant_linear' if exact else ''}, bitwise; byte "
        f"planes {SD.lane_planes(lanes.min(), lanes.max())}; union k-steps "
        f"{steps}/{dense} dense (mean union {width:.4f} of K); JAX "
        f"executed chunks {int(sched['executed'])}/{sched['total']}")
    return float((dec.float() - dec_p.float()).abs().max())


def check_quant(dtype, what, m, k, n, counts=False, bias=False,
                ragged=False, count_max=QUANT_COUNT_MAX):
    """quant_spike_matmul and quant_gather_spike_matmul on random scales:
    ``hold_quant`` (kernels == plain versions == each other == the dense
    quantized reference, bitwise; the staged order == stage_rows)."""
    s, qw, sc, b = quant_operands(9, m, k, n, dtype, counts, bias, ragged,
                                  count_max)
    name = (f"quant products {dtype} {what} M={m} K={k} N={n}"
            f"{' counts' if counts else ''}{' bias' if bias else ''}"
            f"{' ragged spikes' if ragged else ''}")
    return hold_quant(name, s, qw, sc, b, counts, dtype, require_dense=True)


def quant_value_operands(seed, m, k, n, dtype, what, bias):
    """#5's operands at the values of QUANT_VALUES on ragged fine-grained
    spikes (rows from dark to dense, the first 256 dark): counts of
    128-255 (one unsigned byte plane), above 65535 (three planes), a lane
    past 2^23 in some rows (four planes), of either sign (two planes), an
    analog non-integer context (truncated on the lanes), or all dark."""
    gen = torch.Generator().manual_seed(seed)
    live = ragged_spikes(gen, (m, k))
    if what == "counts 128-255":
        s = live * torch.randint(128, 256, (m, k), generator=gen)
    elif what == "counts above 65535":
        s = live * torch.randint(65536, 100001, (m, k), generator=gen)
    elif what == "counts past 2^23":
        s = live * torch.randint(1, 301, (m, k), generator=gen)
        rows = torch.arange(300, m, 7)
        s[rows, rows % k] = (2.0 ** 23 + 5) * (1 - 2 * (rows % 2)).float()
    elif what == "negative counts":
        s = live * torch.randint(-300, 301, (m, k), generator=gen)
    elif what == "analog context":
        s = live * torch.rand((m, k), generator=gen) * 300
    else:
        s = torch.zeros((m, k))
    qw = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
    sc = torch.rand((n,), generator=gen) * 0.02 + 1e-3
    b = torch.randn((n,), generator=gen) if bias else None
    ops = (s.to(dtype), qw, sc, b)
    return tuple(None if a is None else a.cuda() for a in ops)


def check_quant_values(dtype, what, m, k, n, bias):
    """``hold_quant`` at one of QUANT_VALUES (count lanes)."""
    s, qw, sc, b = quant_value_operands(12, m, k, n, dtype, what, bias)
    return hold_quant(f"#5 {dtype} {what} M={m} K={k} N={n}"
                      f"{' bias' if bias else ''}", s, qw, sc, b, True,
                      dtype)


def quant_parts(k, n, counts, dtype):
    """One product of a mixed layer as time_quant_products times it (spikes
    of density 0.2 with dark tiles, counts up to L, in ``dtype``; bf16
    output) and #5 on it in parts: ``staging`` (``quant_stage``, the lane
    cast inside it), ``kernel`` (``launch_quant_gather`` alone on a staged
    schedule), ``whole`` (the wrapper); and the earlier design's host-side
    staging of the same operands: ``cast`` (``quant_lanes``) and
    ``sort`` (``stage_rows`` on the lanes). Returns (operands, parts)."""
    s, qw, sc, _ = quant_operands(10, M_TRAIN, k, n, dtype, counts)
    if counts:                  # a layer's counts are at most L
        s = torch.clamp(s, max=L)
    bm = min(128, M_TRAIN)
    lanes = SM.quant_lanes(s, counts)
    staged = SD.quant_stage(s, bm, counts)
    out = torch.empty((M_TRAIN, n), dtype=torch.bfloat16, device="cuda")
    sc32 = sc.float().contiguous()
    ops = dict(s=s, qw=qw, sc=sc, lanes=lanes, staged=staged, out=out)
    return ops, dict(
        staging=lambda: SD.quant_stage(s, bm, counts),
        kernel=lambda: SD.launch_quant_gather(s, qw, sc32, None, staged,
                                              counts=counts, out=out),
        whole=lambda: SD.quant_gather_spike_matmul_cuda(
            s, qw, sc, None, counts=counts, out_dtype=torch.bfloat16),
        cast=lambda: SM.quant_lanes(s, counts),
        sort=lambda: SD.stage_rows(lanes, bm))


def time_quant_gather_parts(dtype):
    """Where #5's time goes on the three products of a mixed layer with
    ``dtype`` activations, each part of ``quant_parts`` by cuda_ms (the
    earlier design's cast and sort, which the wrapper no longer runs,
    beside this one's), and the device time of each of the wrapper's
    kernels (torch.profiler, 10 calls). Logs each block's union k-steps.
    Returns the totals over the three products, and the device us of a
    call of each kernel summed over them under ``device_us``."""
    parts, device_total = {}, {}
    for what, k, n, counts in QUANT_PRODUCTS:
        ops, fns = quant_parts(k, n, counts, dtype)
        row = {name: cuda_ms(fn) for name, fn in fns.items()}
        for name, ms in row.items():
            parts[name] = parts.get(name, 0.0) + ms
        steps, dense, width = union_steps(ops["lanes"], ops["staged"][0])
        dev = device_us(fns["whole"])
        for name, us in dev.items():
            device_total[name] = device_total.get(name, 0.0) + us
        log(f"quant_gather_spike_matmul {dtype} {what} K={k} N={n}: "
            + ", ".join(f"{name} {ms:.4f} ms" for name, ms in row.items())
            + f"; device us a call {dev}; union k-steps "
            f"{steps}/{dense} dense (mean union {width:.4f} of K)")
    parts["device_us"] = device_total
    log(f"quant_gather_spike_matmul {dtype}, the three products of a mixed "
        f"layer: {parts}")
    return parts


def quant_bound_ms(left, lanes, qw, out, gather):
    """Bytes: ``left``, the left operand as the kernel reads it (#3 reads
    s in its own dtype, fp32 as the engine passes it; #5 its lanes, int8
    spikes or int32 counts, as the lanes' figure counts #3's), the codes,
    the scale and the output once each (the gather also its staged order
    and occupancies); operations: the multiply-adds of the live skip tiles
    (gather: one per live entry and output column) at the int8
    tensor-core peak."""
    m, k = lanes.shape
    n = qw.shape[1]
    if gather:
        macs = float((lanes != 0).sum()) * n
        extra = 12 * (-(-m // min(128, m)) * min(128, m))
    else:
        tm, tk = SM.SKIP_TILE
        occ = SM.block_occupancy(F.pad(lanes, (0, -k % tk, 0, -m % tm)), tm,
                                 tk)
        macs, extra = float(occ.sum()) * tm * tk * n, 0
    ops_s = 2 * macs / PEAK_INT8
    n_bytes = (left.numel() * left.element_size() + qw.numel() + 4 * n
               + out.numel() * out.element_size() + extra)
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def time_quant_products(name, kernel, plain, gather, dtype):
    """The three quantized products of a mixed layer on ``dtype``
    activations (``spike_linear`` passes fp32 ones; spikes of density 0.2
    with dark tiles, wo on counts up to L) and a bf16 output, each timed
    (cuda_ms): kernel, plain version (fewer calls: the gather's loops
    over the compacted slots) and ``torch._int_mm`` on the int8 lanes and
    codes (cuBLASLt's int8 product: the same integer sums, without the
    scale); and the device us a call of each kernel the wrapper launches
    (``device_us``). Returns the totals, with each product's ms and
    device us."""
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by, per_product = set(), {}
    for what, k, n, counts in QUANT_PRODUCTS:
        s, qw, sc, _ = quant_operands(10, M_TRAIN, k, n, dtype, counts)
        if counts:              # a layer's counts are at most L
            s = torch.clamp(s, max=L)
        kw = dict(counts=counts, out_dtype=torch.bfloat16)
        lanes8 = s.to(torch.int8)
        row = dict(ms=cuda_ms(lambda: kernel(s, qw, sc, None, **kw)),
                   plain_ms=cuda_ms(lambda: plain(s, qw, sc, None, **kw),
                                    warmup=1, calls=3, repeats=3),
                   library_ms=cuda_ms(lambda: torch._int_mm(lanes8, qw)))
        lanes, out = SM.quant_lanes(s, counts), kernel(s, qw, sc, None, **kw)
        row["bound_ms"], by = quant_bound_ms(lanes if gather else s, lanes,
                                             qw, out, gather)
        if not gather:      # the bound on the lanes, beside it
            row["lanes_bound_ms"] = quant_bound_ms(lanes, lanes, qw, out,
                                                   gather)[0]
        bound_by.add(by)
        for key in row:
            total[key] = total.get(key, 0.0) + row[key]
        dev = device_us(lambda: kernel(s, qw, sc, None, **kw))
        per_product[what] = dict(ms=row["ms"], device_us=dev)
        log(f"{name} {dtype} {what} M={M_TRAIN} K={k} N={n}"
            f"{' counts' if counts else ''}: kernel {row['ms']:.4f} ms "
            f"(device us a call {dev}), plain {row['plain_ms']:.4f} ms, "
            f"torch._int_mm {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({by})")
    total["bound_by"] = "/".join(sorted(bound_by))
    total["products"] = per_product
    log(f"{name} {dtype}, the three products of a mixed layer: {total}")
    return total


def ssa_operands(seed, dtype, quant, weights="dyadic", shape=SSA_FULL,
                 zero=False):
    """Bundle operands as ssa_step builds them: LIF spikes of dyadic
    currents with a dark (t=0, b=0) slab (or all zero); dyadic weights,
    random-normal ones, or int8 codes with per-channel fp32 scales
    (``quant``), in the activation dtype; BN rows; delta."""
    T, B, L, D, H, HD = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-64, 224, (T, B, L, D), generator=gen).float() / 128
    x[0, 0] = 0.0
    s = lif_scan(x, SpikingConfig(time_steps=T))[0]
    if zero:
        s.zero_()
    scale3 = None
    if quant:
        w3 = torch.randint(-127, 128, (3, D, H * HD), generator=gen).float()
        scale3 = (1.0 + dyadic(gen, (3, H * HD), bits=4) * 0.5) * 2.0 ** -9
    elif weights == "dyadic":
        w3 = dyadic(gen, (3, D, H * HD)) * 0.25
    else:
        w3 = torch.randn((3, D, H * HD), generator=gen) / math.sqrt(D)

    def rows(n):
        return torch.stack([dyadic(gen, (n,)) * 0.5,
                            torch.rand((n,), generator=gen) + 0.5,
                            1.0 + dyadic(gen, (n,)) * 0.5,
                            dyadic(gen, (n,)) * 0.5])
    ops = (s.to(dtype), w3.to(dtype), scale3,
           torch.stack([rows(H * HD) for _ in range(3)]), torch.tensor(0.3))
    kw = dict(num_heads=H, head_dim=HD, scale=1.0 / math.sqrt(HD))
    return tuple(None if a is None else a.cuda() for a in ops), kw


def check_ssa_kernel(dtype, quant, what="full width", shape=SSA_FULL,
                     zero=False):
    """fused_ssa kernel vs plain version: context and (H, 4) counts
    bitwise (dyadic weights or int8 codes: exact projection sums)."""
    ops, kw = ssa_operands(12, dtype, quant, shape=shape, zero=zero)
    out_k, cnt_k = FS.fused_ssa_cuda(*ops, **kw)
    out_p, cnt_p = FS.fused_ssa_plain(*ops, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    name = (f"fused_ssa {dtype} {'int8 + scale3' if quant else 'fp'} {what}"
            f"{' all-zero input' if zero else ''} {tuple(shape)}")
    if not (torch.equal(out_k, out_p) and torch.equal(cnt_k, cnt_p)):
        raise AssertionError(f"{name}: kernel != plain version (max abs diff "
                             f"{err}, counts {cnt_k[0].tolist()} vs "
                             f"{cnt_p[0].tolist()})")
    if zero and int(cnt_k[:, :3].sum()) != 0:
        raise AssertionError(f"{name}: projections counted on a dark input")
    log(f"{name}: bitwise equal to the plain version; counts of head 0 "
        f"{cnt_k[0].tolist()}, context mean {float(out_k.float().mean()):.4f}")
    return err


def ssa_bound_ms(ops, counts, shape=SSA_FULL, causal=False, analog=False):
    """Operations: the executed projections (q, k, v: L x D x hd
    multiply-adds per head and live slab) and every score and context
    product (2 T B H L^2 hd; causal: the pairs on or below the diagonal)
    at the dtype's peak (``analog``: the context's at the fp32 CUDA-core
    peak, its scores being fp32); bytes: the input, w3, scale3, the BN
    rows (rope: the table) and delta in, context and counts out."""
    T, B, L, D, H, HD = shape
    x, w3, scale3, aux, _ = ops
    pairs = L * (L + 1) // 2 if causal else L * L
    context = T * B * H * pairs * HD
    macs = 3 * float(counts[:, 0].sum()) * L * D * HD + context
    ops_s = 2 * macs / PEAK_FLOPS[x.dtype] + 2 * context / PEAK_FLOPS[
        torch.float32 if analog else x.dtype]
    es = x.element_size()
    n_bytes = (x.numel() * es + w3.numel() * es + 3 * H * HD * 4
               + aux.numel() * 4 + 4                          # in
               + T * B * L * H * HD * es + counts.numel() * 4)  # out
    bytes_s = n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def time_ssa_kernel(shape=SSA_FULL):
    """#6 at ``shape``, bf16, random-normal fp weights (cuda_ms): kernel,
    plain version, bound; no single PyTorch call computes the bundle."""
    ops, kw = ssa_operands(13, torch.bfloat16, False, weights="normal",
                           shape=shape)
    return time_bundle("fused_ssa", ops, kw, shape)


def time_bundle(name, ops, kw, shape):
    """A bundle kernel (cuda_ms): kernel, plain version (fewer calls) and
    the bound of its executed work."""
    ms = cuda_ms(lambda: FS.fused_ssa_cuda(*ops, **kw))
    plain_ms = cuda_ms(lambda: FS.fused_ssa_plain(*ops, **kw), warmup=1,
                       calls=3, repeats=3)
    _, counts = FS.fused_ssa_cuda(*ops, **kw)
    bound_ms, bound_by = ssa_bound_ms(ops, counts, shape,
                                      kw.get("causal", False))
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    log(f"{name} bf16 {tuple(shape)}: {row}")
    return row


def rope_ssa_operands(seed, dtype, shape):
    """The rope bundle's operands as ``ssa_step_causal`` builds them for
    the mixed LM tree: the ln1 output of a residual stream with one
    all-zero token and a dark (t=0, b=0) slab (a random norm scale), the
    int8 codes of random-normal q/k/v weights cast to the activation
    dtype with their per-channel fp32 scales, the RoPE table, delta."""
    T, B, S, D, H, HD = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((T, B, S, D), generator=gen) * 0.5
    x[:, :, min(3, S - 1)] = 0.0
    x[0, 0] = 0.0
    h = rmsnorm({"scale": 1.0 + 0.1 * torch.randn((D,), generator=gen)}, x)
    qs = [quantize_weight(torch.randn((D, H * HD), generator=gen)
                          / math.sqrt(D)) for _ in range(3)]
    cos, sin = rope_table(torch.arange(S), HD, 10000.0)
    ops = (h.to(dtype), torch.stack([q["qw"] for q in qs]).to(dtype),
           torch.stack([q["scale"] for q in qs]), torch.stack([cos, sin]),
           torch.tensor(0.3))
    kw = dict(num_heads=H, head_dim=HD, scale=1.0 / math.sqrt(HD),
              family="rope", causal=True)
    return tuple(a.cuda() for a in ops), kw


def check_rope_ssa_kernel(dtype, what, shape):
    """#6b, kernel vs plain version on int8 codes: context and (H, 4)
    counts bitwise (both sum the analog projections in ascending k)."""
    ops, kw = rope_ssa_operands(15, dtype, shape)
    out_k, cnt_k = FS.fused_ssa_cuda(*ops, **kw)
    out_p, cnt_p = FS.fused_ssa_plain(*ops, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    name = f"fused_ssa_rope {dtype} int8 + scale3 {what} {tuple(shape)}"
    if not (torch.equal(out_k, out_p) and torch.equal(cnt_k, cnt_p)):
        raise AssertionError(f"{name}: kernel != plain version (max abs diff "
                             f"{err}, counts {cnt_k[0].tolist()} vs "
                             f"{cnt_p[0].tolist()})")
    T, B = shape[:2]
    if cnt_k[0].tolist() != [T * B - 1] * 3 + [2 * T * B]:
        raise AssertionError(f"{name}: counts {cnt_k[0].tolist()} (one dark "
                             f"slab of {T * B})")
    log(f"{name}: bitwise equal to the plain version; counts of head 0 "
        f"{cnt_k[0].tolist()}, context mean {float(out_k.float().mean()):.4f}")
    return err


def time_layer_kernel(sparse, dtype, shape=FULL, l_block=64):
    """The layer program at ``shape`` on random-normal weights (cuda_ms):
    kernel, plain version and the bound of its executed work."""
    args, kw = layer_operands(3, dtype, False, shape, l_block, sparse)
    ms = cuda_ms(lambda: FL.fused_layer_cuda(*args, **kw))
    plain_ms = cuda_ms(lambda: FL.fused_layer_plain(*args, **kw), warmup=1,
                       calls=3, repeats=3)
    _, counts = FL.fused_layer_cuda(*args, **kw)
    bound_ms, bound_by = layer_bound_ms(args, counts, dtype, kw["l_block"],
                                        decoded=kw["decoded"], shape=shape)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    log(f"fused_layer {sparse} {dtype} {tuple(shape)}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return row


def select_mixed(path):
    """The slice's mixed tree: int8 wo, w1, w2 and head; fp wq, wk, wv."""
    return path.rsplit("/", 1)[-1] not in ("wq", "wk", "wv")


def select_qkv(path):
    """The complementary tree: int8 wq, wk, wv; the rest bf16."""
    return path.rsplit("/", 1)[-1] in ("wq", "wk", "wv")


def mixed_path(cfg, params, requests, tree):
    """``build_prefill_step`` answering ``requests`` with a mixed tree,
    the counts reset just before: per layer call 2 ``fused_ssa`` launches
    and 3 spike products (the int8 kernels for the 'mixed' tree, the fp
    ones for the complementary 'qkv' tree), split tile / decoded as the
    engine's sparse datapath or its 'auto' decisions say; no fused layer.
    Finite logits. Returns the counts, per-request times and logits."""
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts = launches()
    n = cfg.num_layers * len(requests)
    tile, dec = sparse_split(cfg.engine, 3 * n)
    what = f"mixed int8 path ({tree} tree), sparse={cfg.engine.sparse!r}"
    log(f"{what}: {len(requests)} requests x {REQUEST_BATCH} images, "
        f"per-request ms {[round(m, 3) for m in req_ms]}, sparse decisions "
        f"{dict(E.SPARSE_DECISIONS)}, launches {counts}")
    want = dict.fromkeys(counts, 0)
    want["fused_ssa"] = FS.LAUNCHES_PER_CALL * n
    prefix = "quant_" if tree == "mixed" else ""
    want[f"{prefix}spike_matmul"] = tile
    want[f"{prefix}gather_spike_matmul"] = dec
    want[f"{prefix}gather_stage"] = dec     # one staging a decoded product
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    for logits in outs:
        if logits.shape != (REQUEST_BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
    return counts, req_ms, outs


def check_mixed_outputs(cfg, params, images):
    """8 images, dyadic weights and dyadic scales, the mixed tree: logits
    through the kernels (each sparse datapath) == through their plain
    versions == the sequential oracle (overlap='off', mode='dense'),
    bitwise."""
    q = quantize_tree(dyadic_params(params), "int8", dyadic=True,
                      select=select_mixed)
    batch = {"images": images}
    with use_engine(cfg.engine.replace(overlap="off", mode="dense")), \
            torch.inference_mode():
        oracle, _ = registry.forward(q, cfg, batch)
    for sparse in ("tile", "decoded"):
        with use_engine(cfg.engine.replace(sparse=sparse)), \
                torch.inference_mode():
            reset_counts()
            got, aux = registry.forward(q, cfg, batch)
            counts = launches()
            with plain_kernels():
                plain, _ = registry.forward(q, cfg, batch)
        torch.cuda.synchronize()
        prefix = "quant_" + ("" if sparse == "tile" else "gather_")
        want = dict.fromkeys(counts, 0)
        want.update({"fused_ssa": FS.LAUNCHES_PER_CALL * cfg.num_layers,
                     f"{prefix}spike_matmul": 3 * cfg.num_layers})
        if sparse == "decoded":
            want["quant_gather_stage"] = 3 * cfg.num_layers
        if counts != want:
            raise AssertionError(f"mixed output check, sparse={sparse!r}: "
                                 f"launches {counts}, expected {want}")
        if not (torch.equal(got, plain) and torch.equal(got, oracle)):
            raise AssertionError(
                f"mixed logits, sparse={sparse!r}: kernels == plain "
                f"{torch.equal(got, plain)}, == oracle "
                f"{torch.equal(got, oracle)} (max abs diff to the oracle "
                f"{float((got - oracle).abs().max())})")
        log(f"check, mixed int8 tree, sparse={sparse!r}: logits through the "
            f"kernels == plain versions == sequential oracle, bitwise, on 8 "
            f"images (fire rate {float(aux['fire_rate']):.4f}, logit std "
            f"{float(got.std()):.4f})")


def check_vision_outputs(cfg, params, images, what):
    """Dyadic weights (exact sums in the layer program): the fused logits
    with sparse 'auto', 'tile' and 'decoded', through the kernels
    (``FL.LAUNCHES_PER_CALL`` a layer call) and through their plain
    versions, equal to
    the sequential oracle's (overlap='off'), bitwise."""
    batch = {"images": images}
    with use_engine(cfg.engine.replace(overlap="off")), \
            torch.inference_mode():
        oracle, _ = registry.forward(params, cfg, batch)
    for sparse in ("auto", "tile", "decoded"):
        eng = cfg.engine.replace(overlap="fused", sparse=sparse)
        with use_engine(eng), torch.inference_mode():
            reset_counts()
            got, aux = registry.forward(params, cfg, batch)
            counts = launches()
            tile, dec = sparse_split(eng, cfg.num_layers)
            with plain_kernels():
                plain, _ = registry.forward(params, cfg, batch)
        torch.cuda.synchronize()
        want = dict.fromkeys(counts, 0)
        want["fused_layer"] = FL.LAUNCHES_PER_CALL["bn"] * tile
        want["fused_layer_decoded"] = FL.LAUNCHES_PER_CALL["bn"] * dec
        if counts != want:
            raise AssertionError(f"{what} output check, sparse={sparse!r}: "
                                 f"launches {counts}, expected {want}")
        if not (torch.equal(got, plain) and torch.equal(got, oracle)):
            raise AssertionError(
                f"{what} fused logits, sparse={sparse!r}: kernels == plain "
                f"{torch.equal(got, plain)}, == oracle "
                f"{torch.equal(got, oracle)} (max abs diff to the oracle "
                f"{float((got - oracle).abs().max())})")
        log(f"check, {what}, sparse={sparse!r}: logits through the kernels "
            f"== plain versions == sequential oracle, bitwise, on "
            f"{len(images)} images (fire rate {float(aux['fire_rate']):.4f}, "
            f"logit std {float(got.std()):.4f})")


def fire_rates(cfg, params, images, what):
    """The fire rate at every layer's input on one request; fails if any
    layer's input is all dark (the kernels would skip everything)."""
    with use_engine(cfg.engine):
        sp = layer_sparsities(params, cfg, {"images": images.cuda()})
    rates = [(name, 1.0 - s) for name, s in sp]
    log(f"{what}: fire rate per layer input "
        f"{[(n, round(r, 4)) for n, r in rates]}")
    dark = [n for n, r in rates if r <= 0.0]
    if dark:
        raise AssertionError(f"{what}: all-dark inputs at {dark}")


def leaf_paths(tree, prefix=""):
    """The '/'-joined key paths of a dict tree's leaves, in the order of
    ``tree_leaves``."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def check_eval_gradients(cfg, params, batch, what, state=None,
                         overlap="fused", bundle=None):
    """An eval-mode forward under autograd with ``overlap`` 'fused' or
    'pipeline' (the layer program through the kernels, behind
    ``_FusedLayer``: ``FL.LAUNCHES_PER_CALL`` a layer call, T times as
    many pipelined; or, for a
    model whose layers the layer program does not take, the ``bundle``
    kernel behind ``_FusedBundle``, 2 launches a layer call, and the spike
    products) against the same forward with overlap='off': the logits and
    every layer parameter's gradient of one seeded cotangent, bitwise;
    each layer parameter gets a gradient."""
    layers = "blocks" if "blocks" in params else "layers"
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for ov in (overlap, "off"):
        leaves = [a.detach().requires_grad_(a.is_floating_point())
                  for a in tree_leaves(params[layers])]
        tree = dict(params, **{layers: tree_unflatten(params[layers],
                                                      leaves)})
        kw = {} if state is None else {"state": state}
        reset_counts()
        with use_engine(cfg.engine.replace(overlap=ov)), torch.enable_grad():
            logits, _ = registry.forward(tree, cfg, batch, **kw)
            cot = torch.randn(logits.shape, generator=torch.Generator(
            ).manual_seed(17)).to(logits.device)
            grads = torch.autograd.grad((logits * cot).sum(), leaves,
                                        allow_unused=True)
        torch.cuda.synchronize()
        runs[ov] = (logits.detach(), grads, launches())
    torch.backends.cudnn.deterministic = deterministic
    counts = runs[overlap][2]
    pipelined = overlap == "pipeline"
    layer = {k: n for k, n in counts.items() if k.startswith("fused_layer")}
    mine = sum(n for k, n in layer.items()
               if k.startswith("fused_layer_pipeline") == pipelined)
    family = "rope" if "tokens" in batch else "bn"
    per_call = FL.LAUNCHES_PER_CALL[family] * (cfg.spiking.time_steps
                                               if pipelined else 1)
    if bundle:              # the bundle, and off runs the spike kernels
        bad = counts[bundle] != FS.LAUNCHES_PER_CALL * cfg.num_layers or \
            any(layer.values()) or \
            any(n for k, n in runs["off"][2].items() if k.startswith("fused"))
    else:
        bad = mine != per_call * cfg.num_layers or \
            sum(layer.values()) != mine or any(runs["off"][2].values())
    if bad:
        raise AssertionError(f"{what} gradient check: launches {overlap} "
                             f"{counts}, off {runs['off'][2]}")
    fused, off = runs[overlap], runs["off"]
    if not torch.equal(fused[0], off[0]):
        raise AssertionError(f"{what} gradient check: {overlap} logits != "
                             f"off logits (max abs diff "
                             f"{float((fused[0] - off[0]).abs().max())})")
    names = leaf_paths(params[layers])
    # analog scores read no threshold: delta gets no gradient either way
    unused = set() if cfg.spiking.binarize_scores else {"delta"}
    missing = [n for n, g in zip(names, fused[1])
               if g is None and n not in unused]
    differ = [n for n, a, b in zip(names, fused[1], off[1])
              if (a is None) != (b is None)
              or a is not None and not torch.equal(a, b)]
    if missing or differ:
        raise AssertionError(f"{what} gradient check: no gradient through the "
                             f"kernels for {missing}; gradients that differ "
                             f"from overlap='off': {differ}")
    norms = {n: float(g.norm()) for n, g in zip(names, runs[overlap][1])
             if g is not None}
    log(f"check, {what}: eval forward under autograd, overlap={overlap!r} "
        f"(launches { {k: v for k, v in counts.items() if v} }) == 'off' "
        f"bitwise: logits and the gradients of all {len(norms)} layer "
        f"parameters that take one{f' (not {sorted(unused)})' if unused else ''}"
        f"; gradient norms {dict((n, round(v, 6)) for n, v in norms.items())}")


# --- the pipelined layer program (#1d) ------------------------------------


def check_pipeline_kernel(dtype, what, shape, l_block, sparse="tile",
                          family="bn"):
    """#1d on dyadic weights (rope: int8 codes) against its plain version
    and against #1's kernel on the same operands, at any T: outputs and
    counts bitwise; the call launches T times ``FL.LAUNCHES_PER_CALL``
    kernels."""
    if family == "rope":
        args, kw = rope_operands(11, dtype, shape, l_block)
    else:
        args, kw = layer_operands(1, dtype, True, shape, l_block, sparse)
    t = shape[0]
    reset_counts()
    out_k, cnt_k = FL.fused_layer_pipeline_cuda(*args, **kw)
    n_launch = sum(launches().values())
    out_p, cnt_p = FL.fused_layer_pipeline_plain(*args, **kw)
    out_f, cnt_f = FL.fused_layer_cuda(*args, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    name = (f"fused_layer_pipeline {family} {sparse} {dtype} {what} "
            f"{tuple(shape)}")
    per_call = FL.LAUNCHES_PER_CALL[family] * t
    checks = {"== plain": torch.equal(out_k, out_p),
              "counts == plain": torch.equal(cnt_k, cnt_p),
              "== #1": torch.equal(out_k, out_f),
              "counts == #1": torch.equal(cnt_k, cnt_f),
              f"{per_call} launches": n_launch == per_call}
    if not all(checks.values()):
        raise AssertionError(f"{name}: {checks} (max abs diff to the plain "
                             f"version {err}, launches {launches()})")
    log(f"{name}, l_block {kw['l_block']}: bitwise equal to its plain "
        f"version and to #1's kernel (outputs and counts), {n_launch} "
        f"launches; counts per phase "
        f"{cnt_k.sum(dim=(0, 2)).tolist()}")
    return err


def time_pipeline_kernel(shape=FULL, l_block=64):
    """#1d beside #1 on the same random-normal operands (bf16, cuda_ms, in
    turns: #1d, #1, #1, #1d), its plain version (fewer calls), the bound
    of the executed work (#1's: the same sub-blocks), the membrane bytes
    it moves beyond #1, and ``dual_engine.fused_step_metrics`` of one
    call's counts with and without ``pipeline``."""
    T, B, L, D, H, HD, FF = shape
    args, kw = layer_operands(3, torch.bfloat16, False, shape, l_block)
    pipe = lambda: FL.fused_layer_pipeline_cuda(*args, **kw)  # noqa: E731
    fused = lambda: FL.fused_layer_cuda(*args, **kw)  # noqa: E731
    runs = [cuda_ms(pipe), cuda_ms(fused), cuda_ms(fused), cuda_ms(pipe)]
    plain_ms = cuda_ms(lambda: FL.fused_layer_pipeline_plain(*args, **kw),
                       warmup=1, calls=3, repeats=3)
    _, counts = pipe()
    bound_ms, bound_by = layer_bound_ms(args, counts, torch.bfloat16,
                                        kw["l_block"], shape=shape)
    extra = FL.membrane_bytes(2, T, B, L, D, H * HD, FF)
    row = dict(ms=(runs[0] + runs[3]) / 2, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               fused_ms=(runs[1] + runs[2]) / 2)
    log(f"fused_layer_pipeline bf16 {tuple(shape)}: #1d {runs[0]:.4f} / "
        f"{runs[3]:.4f} ms, #1 {runs[1]:.4f} / {runs[2]:.4f} ms (in turns), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
        f"membranes {extra} bytes beyond #1 "
        f"({1e3 * extra / PEAK_BYTES:.5f} ms at {PEAK_BYTES:.3g} B/s)")
    for pipelined in (False, True):
        m = dual_engine.fused_step_metrics(
            counts.cpu(), seq=L, k_dim=D, head_dim=HD, t_steps=T, batch=B,
            d_model=D, d_ff=FF, l_block=kw["l_block"], pipeline=pipelined)
        log(f"dual_engine.fused_step_metrics, pipeline={pipelined}, "
            f"{tuple(shape)}: " + json.dumps(
                {k: m[k] for k in ("pipeline_iters", "executed_steps",
                                   "possible_steps", "hidden_fraction",
                                   "qkt_hidden_fraction",
                                   "qktv_hidden_fraction", "sparse_util",
                                   "binary_util")}))
    return row


def pipeline_path(cfg, params, requests, what, oracle=False):
    """``build_prefill_step`` with overlap='pipeline' answering
    ``requests``, the counts reset just before: T times
    ``FL.LAUNCHES_PER_CALL`` #1d launches a layer call (the variant the
    sparse datapath or the rope family names) and
    no other launch; the same requests under overlap='fused' timed in the
    same run, with equal logits on every request, bitwise; on one
    request the logits also == through the plain versions and, with
    ``oracle`` (dyadic weights), == overlap='off'. Returns (counts,
    pipelined ms per request, fused ms per request)."""
    overlap = lambda ov: cfg.replace(  # noqa: E731
        engine=cfg.engine.replace(overlap=ov))
    pipe = steps.build_prefill_step(overlap("pipeline"))
    fused = steps.build_prefill_step(overlap("fused"))
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(pipe, params, requests)
    counts, decisions = launches(), dict(E.SPARSE_DECISIONS)
    n = cfg.num_layers * len(requests)
    tile, dec = sparse_split(cfg.engine, n)
    family = "rope" if "tokens" in requests[0] else "bn"
    per_call = FL.LAUNCHES_PER_CALL[family] * cfg.spiking.time_steps
    want = dict.fromkeys(counts, 0)
    if family == "rope":
        want["fused_layer_pipeline_rope"] = per_call * n
    else:
        want["fused_layer_pipeline"] = per_call * tile
        want["fused_layer_pipeline_decoded"] = per_call * dec
    name = f"pipeline path, {what}, sparse={cfg.engine.sparse!r}"
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    fused_outs, fused_ms = timed_requests(fused, params, requests)
    differ = [i for i, (a, b) in enumerate(zip(outs, fused_outs))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"{name}: logits != overlap='fused' on "
                             f"requests {differ}")
    with plain_kernels():
        plain = pipe(params, requests[0])
    off = steps.build_prefill_step(overlap("off"))(params, requests[0]) \
        if oracle else outs[0]
    torch.cuda.synchronize()
    if not (torch.equal(outs[0], plain) and torch.equal(outs[0], off)):
        raise AssertionError(
            f"{name}: == plain versions {torch.equal(outs[0], plain)}, == "
            f"overlap='off' {torch.equal(outs[0], off)} (max abs diff to "
            f"off {float((outs[0] - off).abs().max())})")
    for logits in outs:
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: non-finite logits")
    rounded = lambda ms: [round(m, 3) for m in ms]  # noqa: E731
    log(f"{name}: {len(requests)} requests, launches {counts}, sparse "
        f"decisions {decisions}; ms per request pipelined "
        f"{rounded(req_ms)}, fused {rounded(fused_ms)}; logits == "
        f"overlap='fused' on every request and, on one, == plain versions"
        f"{' == overlap=off' if oracle else ''}, bitwise (logit std "
        f"{float(outs[0].std()):.4f})")
    return counts, req_ms, fused_ms


def check_mixed_pipeline(cfg, params, batch, what, bundle):
    """A mixed tree's prefill under overlap='pipeline' == under 'fused':
    its layers are not eligible for the layer program, its bundles run
    ``bundle`` (2 launches a layer call) under both, as in JAX; the same
    launches and logits, bitwise."""
    runs = {}
    for ov in ("fused", "pipeline"):
        step = steps.build_prefill_step(cfg.replace(
            engine=cfg.engine.replace(overlap=ov)))
        reset_counts()
        logits = step(params, batch)
        torch.cuda.synchronize()
        runs[ov] = (logits, launches())
    (got, counts), (want, want_counts) = runs["pipeline"], runs["fused"]
    if counts != want_counts or \
            counts[bundle] != FS.LAUNCHES_PER_CALL * cfg.num_layers or \
            any(counts[k] for k in counts if k.startswith("fused_layer")):
        raise AssertionError(f"mixed {what} under 'pipeline': launches "
                             f"{counts}, under 'fused' {want_counts}")
    if not torch.equal(got, want):
        raise AssertionError(f"mixed {what}: 'pipeline' logits != 'fused' "
                             f"(max abs diff "
                             f"{float((got - want).abs().max())})")
    log(f"check, mixed {what} under overlap='pipeline': launches {counts} "
        f"== under 'fused', logits bitwise equal (std "
        f"{float(got.std()):.4f})")


# --- the popcount mode (#8) and the LIF entry (#9) -------------------------


def check_popcount(what, bh, lq, lk, d, words=None):
    """popcount_scores kernel vs plain version: int32 counts, bitwise, on
    packed spikes with dark keys, or with ``words`` 'zeros' / 'ones'
    (queries of all-zero or all-one words against all-one keys)."""
    gen = torch.Generator().manual_seed(bh + lq + lk + d)
    if words is None:
        q = torch.rand((bh, lq, d), generator=gen) < 0.3
        k = torch.rand((bh, lk, d), generator=gen) < 0.3
        k[0, :16] = False
        qp, kp = (pack_bits(a.cuda()) for a in (q, k))
    else:
        w = -(-d // 32)
        qp = torch.full((bh, lq, w), 0 if words == "zeros" else -1,
                        dtype=torch.int32, device="cuda")
        kp = torch.full((bh, lk, w), -1, dtype=torch.int32, device="cuda")
    got = PA.popcount_scores_cuda(qp, kp)
    want = PA.popcount_scores_plain(qp, kp)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"popcount_scores {what} BH={bh} Lq={lq} Lk={lk}"
                             f" d={d}: kernel != plain version (max abs "
                             f"diff {err})")
    log(f"popcount_scores {what} BH={bh} Lq={lq} Lk={lk} d={d} (W="
        f"{qp.shape[-1]}): bitwise equal to the plain version, count mean "
        f"{float(got.float().mean()):.4f}")
    return err


def time_popcount(what, bh, l, d):
    """popcount_scores at a path's shape (cuda_ms; the plain version over
    fewer calls), bf16 spikes at density 0.15, with the profiler's device
    us. Library: ``torch.bmm`` of the unpacked bf16
    spikes, whose counts are exact (checked equal), and, writing the same
    bytes as #8, of the unpacked fp32 spikes with TF32 off
    (``library_fp32_ms``; exact counts too). Bound: the words read once
    and the int32 counts written once, or an AND, a popcount and an add a
    word pair at the CUDA-core rate."""
    gen = torch.Generator().manual_seed(9)
    q, k = ((torch.rand((bh, l, d), generator=gen) < 0.15)
            .to(torch.bfloat16).cuda() for _ in range(2))
    qp, kp = pack_bits(q), pack_bits(k)
    kt = k.transpose(1, 2)
    counts = PA.popcount_scores_cuda(qp, kp)
    q32, kt32 = q.float(), kt.float()
    if not (torch.equal(torch.bmm(q, kt).int(), counts) and
            torch.equal(torch.bmm(q32, kt32).int(), counts)):
        raise AssertionError(f"torch.bmm of the spikes != popcount_scores "
                             f"at {what}")
    ms = cuda_ms(lambda: PA.popcount_scores_cuda(qp, kp))
    plain_ms = cuda_ms(lambda: PA.popcount_scores_plain(qp, kp), warmup=1,
                       calls=3, repeats=3)
    library_ms = cuda_ms(lambda: torch.bmm(q, kt))
    library_fp32_ms = cuda_ms(lambda: torch.bmm(q32, kt32))
    w = qp.shape[-1]
    bytes_s = 4 * (qp.numel() + kp.numel() + counts.numel()) / PEAK_BYTES
    ops_s = 3 * bh * l * l * w / PEAK_FLOPS[torch.float32]
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               library_fp32_ms=library_fp32_ms,
               bound_ms=1e3 * max(ops_s, bytes_s),
               bound_by="operations" if ops_s > bytes_s else "bytes",
               device_us=device_us(lambda: PA.popcount_scores_cuda(qp, kp)))
    log(f"popcount_scores {what} BH={bh} L={l} d={d}: {row}")
    return row


def time_popcount_attention(what, bh, l, d, causal):
    """The whole popcount forward of ``ops.binary_attention`` (pack q and
    k, ``popcount_scores``, threshold, mask, fp32 context product) against
    #7's fused ``spike_attention`` kernel at the same shape, bf16; both
    bitwise equal first."""
    q, k, v = attention_operands(7, bh, l, d, torch.bfloat16)
    kw = dict(scale=1.0 / math.sqrt(d),
              delta=torch.tensor(0.3, device=q.device), causal=causal)
    pop = ops.binary_attention(q, k, v, use_popcount=True, **kw)
    if not torch.equal(pop, SA.spike_attention_cuda(q, k, v, **kw)):
        raise AssertionError(f"popcount binary_attention != spike_attention "
                             f"at {what}")
    pop_ms = cuda_ms(lambda: ops.binary_attention(q, k, v, use_popcount=True,
                                                  **kw))
    mxu_ms = cuda_ms(lambda: SA.spike_attention_cuda(q, k, v, **kw))
    log(f"binary_attention forward {what} BH={bh} L={l} d={d} causal="
        f"{causal}: popcount mode {pop_ms:.4f} ms, spike_attention (#7) "
        f"{mxu_ms:.4f} ms, ratio {pop_ms / mxu_ms:.2f}")
    return dict(popcount_ms=pop_ms, spike_attention_ms=mxu_ms)


def lif_currents(seed, shape, dtype, misaligned=False):
    """Normal currents around the threshold; with ``misaligned`` a view
    one element past a 16-byte boundary (the kernel's element path)."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 0.8 + 0.3).to(dtype).cuda()
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        x = buf[1:].view(shape).copy_(x)
    return x


def check_lif(what, shape, dtype, soft, decay, misaligned=False):
    """lif_forward kernel vs plain version: spikes bitwise."""
    x = lif_currents(len(what) + int(soft), shape, dtype, misaligned)
    kw = dict(decay=decay, v_th=1.0, soft_reset=soft)
    got = LF.lif_forward_cuda(x, **kw)
    want = LF.lif_forward_plain(x, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"lif_forward {what} {shape} {dtype} soft={soft}"
                             f" decay={decay:.4f}: kernel != plain version "
                             f"(max abs diff {err})")
    return err


def time_lif(shape, dtype=torch.bfloat16):
    """lif_forward at a layer input's shape (cuda_ms; the plain version
    over fewer calls). No one PyTorch call computes it. Bound: the
    currents read once and the spikes written once, or ~6 operations an
    element a step (the update, the compare, the reset) at the CUDA-core
    rate."""
    x = lif_currents(5, shape, dtype)
    ms = cuda_ms(lambda: LF.lif_forward_cuda(x, decay=0.5))
    plain_ms = cuda_ms(lambda: LF.lif_forward_plain(x, decay=0.5), warmup=1,
                       calls=5, repeats=3)
    bytes_s = 2 * x.numel() * x.element_size() / PEAK_BYTES
    ops_s = 6 * x.numel() / PEAK_FLOPS[torch.float32]
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=1e3 * max(ops_s, bytes_s),
               bound_by="operations" if ops_s > bytes_s else "bytes")
    log(f"lif_forward {dtype} {shape}: {row}")
    return row


def sequential_vision_path(cfg, params, requests):
    """``build_prefill_step`` answering ``requests`` with the mixed int8
    tree under overlap='off', the counts reset just before. The mixed
    layers are not eligible for the layer program, so each takes the
    sequential composition: per layer call 1 binary attention
    (``popcount_scores``, or ``spike_attention`` with 'mxu_kernel'), 3 fp
    spike products (q, k, v) and 3 int8 products (wo, w1, w2), split tile
    / decoded as 'auto' decides; no fused layer or bundle. Per-request
    times, finite logits."""
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts = launches()
    n = cfg.num_layers * len(requests)
    tile, dec = sparse_split(cfg.engine, 6 * n)
    what = (f"sequential path, {cfg.name} mixed int8 tree, overlap='off', "
            f"binary={cfg.engine.binary!r}, sparse={cfg.engine.sparse!r}")
    n_img = len(requests[0]["images"])
    log(f"{what}: {len(requests)} requests x {n_img} images, per-request ms "
        f"{[round(m, 3) for m in req_ms]}, sparse decisions "
        f"{dict(E.SPARSE_DECISIONS)}, launches {counts}")
    products = ("spike_matmul", "gather_spike_matmul", "gather_stage",
                "quant_spike_matmul", "quant_gather_spike_matmul",
                "quant_gather_stage")
    attn = attention_kernel(cfg)
    ok = (counts[attn] == n
          and counts["spike_matmul"] + counts["gather_spike_matmul"] == 3 * n
          and counts["quant_spike_matmul"]
          + counts["quant_gather_spike_matmul"] == 3 * n
          and counts["spike_matmul"] + counts["quant_spike_matmul"] == tile
          and counts["gather_spike_matmul"]
          + counts["quant_gather_spike_matmul"] == dec
          and counts["gather_stage"] == counts["gather_spike_matmul"]
          and counts["quant_gather_stage"]
          == counts["quant_gather_spike_matmul"]
          and not any(v for k, v in counts.items()
                      if k not in products + (attn,)))
    if not ok:
        raise AssertionError(f"{what}: launches {counts}, expected {n} "
                             f"{attn}, 3 x {n} fp and 3 x {n} int8 "
                             f"products ({tile} tile, {dec} decoded)")
    for logits in outs:
        if logits.shape != (n_img, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
    return counts, req_ms


def check_popcount_logits(cfg, params, batch, what, **alternatives):
    """One request through ``build_prefill_step`` with the popcount
    engine: logits through the kernels == through their plain versions
    == under each alternative engine (fields replaced), bitwise."""
    step = steps.build_prefill_step(cfg)
    got = step(params, batch)
    with plain_kernels():
        runs = {"the plain versions": step(params, batch)}
    for name, fields in alternatives.items():
        runs[name] = steps.build_prefill_step(cfg.replace(
            engine=cfg.engine.replace(**fields)))(params, batch)
    torch.cuda.synchronize()
    differ = {name: float((got.float() - r.float()).abs().max())
              for name, r in runs.items() if not torch.equal(got, r)}
    if differ:
        raise AssertionError(f"{what}: popcount logits differ from "
                             f"(max abs diff) {differ}")
    log(f"check, {what}: logits with binary='popcount' through the kernels "
        f"== {' == '.join(runs)}, bitwise, logit std "
        f"{float(got.float().std()):.4f}")


def lif_path(models):
    """The kernel API's LIF entry ``ops.lif`` on the layer-input currents
    of one request of each vision model (the SPS stem's output, (T, B, L,
    D)), in bf16 (the published configs' dtype) and in fp32, the counts
    reset just before: 1 ``lif_forward`` launch a call. Spikes == the
    plain version bitwise; in fp32 == ``lif_scan`` (decay 0.5: the
    product is exact) bitwise; the bf16 agreement with ``lif_scan``'s
    bf16 membrane is printed."""
    currents = []
    for cfg, params, images in models:
        with torch.inference_mode():
            x, _ = SF._sps(params, registry.init_state(cfg), cfg,
                           images.cuda().to(SF.dtype_of(cfg)), False)
        currents += [(cfg, x.bfloat16()), (cfg, x.float())]
    torch.cuda.synchronize()
    reset_counts()
    call_ms, outs = [], []
    for cfg, x in currents:
        sc = cfg.spiking
        t0 = time.perf_counter()
        outs.append(ops.lif(x, decay=sc.decay, v_th=sc.v_threshold,
                            soft_reset=sc.soft_reset))
        torch.cuda.synchronize()
        call_ms.append(1e3 * (time.perf_counter() - t0))
    counts = launches()
    want = dict.fromkeys(counts, 0)
    want["lif_forward"] = len(currents)
    log(f"lif path: ops.lif on {[tuple(x.shape) for _, x in currents]}, "
        f"ms per call {[round(m, 3) for m in call_ms]}, launches {counts}")
    if counts != want:
        raise AssertionError(f"lif path: launches {counts}, expected {want}")
    for (cfg, x), got in zip(currents, outs):
        sc = cfg.spiking
        t, d = x.shape[0], x.shape[-1]
        plain = LF.lif_forward_plain(x.reshape(t, -1, d), decay=sc.decay,
                                     v_th=sc.v_threshold,
                                     soft_reset=sc.soft_reset)
        scan = lif_scan(x, sc)[0]
        agree = float((scan == got).float().mean())
        if not torch.equal(got, plain.reshape(x.shape)) or (
                x.dtype == torch.float32 and agree != 1.0):
            raise AssertionError(f"lif path {cfg.name} {x.dtype}: == plain "
                                 f"{torch.equal(got, plain.reshape(x.shape))}"
                                 f", agreement with lif_scan {agree}")
        log(f"check, lif path {cfg.name} {x.dtype} {tuple(x.shape)}: spikes "
            f"== the plain version bitwise, fire rate "
            f"{float(got.float().mean()):.4f}, agreement with lif_scan "
            f"{agree:.6f}")
    return counts



# --- analog scores (binarize_scores=False): #6 / #6b / #1 analog ---------


def analog_cfg(cfg):
    """``cfg`` with Spikingformer's own analog SSA: its spiking config
    with ``binarize_scores=False`` (for the shipped configs,
    ``SpikingConfig(time_steps=4, binarize_scores=False)``, the
    replacement JAX takes)."""
    return cfg.replace(spiking=dataclasses.replace(cfg.spiking,
                                                   binarize_scores=False))


def check_ssa_analog(dtype, what, shape, family="bn"):
    """#6 (bn, dyadic weights) or #6b (rope, causal, int8 codes) with
    analog scores, kernel vs plain version: context and (H, 4) counts
    bitwise (both sum the scores over the keys in ascending order), the
    counts those of the binarized kernel, the context not; 2 launches,
    counted under the ``_analog`` name."""
    rope = family == "rope"
    if rope:
        ops, kw = rope_ssa_operands(15, dtype, shape)
    else:
        ops, kw = ssa_operands(12, dtype, False, shape=shape)
    name = "fused_ssa_rope_analog" if rope else "fused_ssa_analog"
    reset_counts()
    out_k, cnt_k = FS.fused_ssa_cuda(*ops, **kw, binarize_scores=False)
    n = launches()
    out_p, cnt_p = FS.fused_ssa_plain(*ops, **kw, binarize_scores=False)
    out_b, cnt_b = FS.fused_ssa_cuda(*ops, **kw)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    label = f"{name} {dtype} {what} {tuple(shape)}"
    checks = {"== plain": torch.equal(out_k, out_p),
              "counts == plain": torch.equal(cnt_k, cnt_p),
              "counts == binarized": torch.equal(cnt_k, cnt_b),
              "!= binarized": not torch.equal(out_k, out_b),
              f"{FS.LAUNCHES_PER_CALL} launches":
                  n[name] == FS.LAUNCHES_PER_CALL
                  and sum(n.values()) == FS.LAUNCHES_PER_CALL}
    if not all(checks.values()):
        raise AssertionError(f"{label}: {checks} (max abs diff {err})")
    log(f"{label}: bitwise equal to the plain version (context and "
        f"counts); counts of head 0 {cnt_k[0].tolist()}, context mean "
        f"{float(out_k.float().mean()):.4f} (binarized "
        f"{float(out_b.float().mean()):.4f})")
    return err


def analog_variant(kw, pipeline=False):
    """The launch-count name of an analog layer-program call's variant
    (``kw``: the keywords of ``FL.prepare`` or of ``FL.fused_layer``)."""
    return ("fused_layer" + ("_pipeline" if pipeline else "")
            + ("_rope" if kw["family"] == "rope" else
               "_decoded" if kw.get("decoded", kw.get("sparse") == "decoded")
               else "") + "_analog")


def check_layer_analog(dtype, what, shape, l_block, sparse="tile",
                       family="bn", pipeline=False):
    """#1 / #1b (bn, dyadic weights), #1c (rope, int8 codes) and, with
    ``pipeline``, #1d with analog scores, kernel vs plain version:
    outputs and counts bitwise (both sum the context over the keys in
    ascending order and wo in ascending k); every score block counted (T
    B a head and L-block); ``FL.LAUNCHES_PER_CALL`` a call (#1d: T times
    as many) under the variant's ``_analog`` name; #1d also == #1's
    kernel at any T."""
    if family == "rope":
        args, kw = rope_operands(11, dtype, shape, l_block)
    else:
        args, kw = layer_operands(1, dtype, True, shape, l_block, sparse)
    kw = dict(kw, binarize_scores=False)
    T, B = shape[:2]
    launch = FL.fused_layer_pipeline_cuda if pipeline else FL.fused_layer_cuda
    plain = FL.fused_layer_pipeline_plain if pipeline else FL.fused_layer_plain
    name = analog_variant(kw, pipeline)
    per_call = FL.LAUNCHES_PER_CALL[family] * (T if pipeline else 1)
    reset_counts()
    out_k, cnt_k = launch(*args, **kw)
    n = launches()
    out_p, cnt_p = plain(*args, **kw)
    checks = {"== plain": torch.equal(out_k, out_p),
              "counts == plain": torch.equal(cnt_k, cnt_p),
              f"{per_call} launches": n[name] == per_call
              and sum(n.values()) == per_call,
              "every score block": bool((cnt_k[:, 3] == T * B).all())}
    if pipeline:
        out_f, cnt_f = FL.fused_layer_cuda(*args, **kw)
        checks.update({"== #1": torch.equal(out_k, out_f),
                       "counts == #1": torch.equal(cnt_k, cnt_f)})
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    label = f"{name} {dtype} {what} {tuple(shape)}, l_block {kw['l_block']}"
    if not all(checks.values()):
        raise AssertionError(f"{label}: {checks} (max abs diff {err})")
    log(f"{label}: bitwise equal to the plain version{' and #1' if pipeline else ''} "
        f"(outputs and counts), {per_call} launches; counts per phase "
        f"{cnt_k.sum(dim=(0, 2)).tolist()}, output std "
        f"{float(out_k.float().std()):.4f}")
    return err


def time_analog_twin(name, analog, binary, plain, bound):
    """An analog variant beside its binarized twin on the same operands
    (cuda_ms, in turns: analog, binarized, binarized, analog), its plain
    version (fewer calls) and ``bound()`` -> (ms, bound_by)."""
    runs = [cuda_ms(analog), cuda_ms(binary), cuda_ms(binary),
            cuda_ms(analog)]
    plain_ms = cuda_ms(plain, warmup=1, calls=2, repeats=3)
    bound_ms, bound_by = bound()
    row = dict(ms=(runs[0] + runs[3]) / 2, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               binarized_ms=(runs[1] + runs[2]) / 2)
    log(f"{name}: analog {runs[0]:.4f} / {runs[3]:.4f} ms, binarized "
        f"{runs[1]:.4f} / {runs[2]:.4f} ms (in turns), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return row


def time_layer_analog(sparse="tile", shape=FULL, l_block=64, family="bn",
                      pipeline=False):
    """#1 / #1b / #1c / #1d with analog scores at ``shape``, bf16
    (random-normal weights; rope: int8 codes), beside the binarized
    variant; the bound of its executed work (the context at the fp32
    peak)."""
    if family == "rope":
        args, kw = rope_operands(3, torch.bfloat16, shape, l_block)
    else:
        args, kw = layer_operands(3, torch.bfloat16, False, shape, l_block,
                                  sparse)
    akw = dict(kw, binarize_scores=False)
    launch = FL.fused_layer_pipeline_cuda if pipeline else FL.fused_layer_cuda
    plain = FL.fused_layer_pipeline_plain if pipeline else FL.fused_layer_plain

    def bound():
        _, counts = launch(*args, **akw)
        return layer_bound_ms(args, counts, torch.bfloat16, kw["l_block"],
                              decoded=kw["decoded"], shape=shape,
                              causal=family == "rope", analog=True)
    return time_analog_twin(
        f"{analog_variant(akw, pipeline)} bf16 {tuple(shape)}",
        lambda: launch(*args, **akw), lambda: launch(*args, **kw),
        lambda: plain(*args, **akw), bound)


def time_ssa_analog(shape, family="bn"):
    """#6 / #6b with analog scores at ``shape``, bf16 (random-normal
    weights; rope: int8 codes), beside the binarized kernel."""
    if family == "rope":
        ops, kw = rope_ssa_operands(16, torch.bfloat16, shape)
    else:
        ops, kw = ssa_operands(13, torch.bfloat16, False, weights="normal",
                               shape=shape)
    akw = dict(kw, binarize_scores=False)

    def bound():
        _, counts = FS.fused_ssa_cuda(*ops, **akw)
        return ssa_bound_ms(ops, counts, shape, kw.get("causal", False),
                            analog=True)
    name = "fused_ssa_rope_analog" if family == "rope" else "fused_ssa_analog"
    return time_analog_twin(
        f"{name} bf16 {tuple(shape)}", lambda: FS.fused_ssa_cuda(*ops, **akw),
        lambda: FS.fused_ssa_cuda(*ops, **kw),
        lambda: FS.fused_ssa_plain(*ops, **akw), bound)


def kernel_api_analog_path():
    """The layer program's analog variants through the kernel API, the
    only entry that reaches them (the layer program's eligibility
    requires binarized scores, in JAX and in the port): the public
    ``FL.fused_layer(..., binarize_scores=False)`` once each for bn tile
    and bn decoded at 4-256's layer shape and rope at the LM prefill's,
    fused and pipelined, the counts reset just before:
    ``FL.LAUNCHES_PER_CALL`` a fused call and T times as many a pipelined
    one, under the variant's ``_analog``
    name, and no other; finite outputs. Returns the counts."""
    torch.cuda.synchronize()
    reset_counts()
    want, outs = {}, []
    for family, sparse in (("bn", "tile"), ("bn", "decoded"),
                           ("rope", "tile")):
        if family == "rope":
            ops, kw = rope_operands(5, torch.bfloat16, raw=True)
        else:
            ops, kw = layer_operands(5, torch.bfloat16, True, sparse=sparse,
                                     raw=True)
        for pipeline in (False, True):
            out, _ = FL.fused_layer(*ops, **kw, pipeline=pipeline,
                                    binarize_scores=False)
            outs.append(out)
            want[analog_variant(kw, pipeline)] = \
                FL.LAUNCHES_PER_CALL[kw["family"]] * (
                    ops[0].shape[0] if pipeline else 1)
    torch.cuda.synchronize()
    counts = launches()
    full = dict(dict.fromkeys(counts, 0), **want)
    if counts != full or not all(bool(torch.isfinite(o).all())
                                 for o in outs):
        raise AssertionError(f"kernel API analog path: launches {counts}, "
                             f"expected {full}")
    log(f"kernel API path, the layer program with analog scores (bn tile "
        f"and decoded {FULL}, rope {LM_FULL}; fused and pipelined): "
        f"launches { {k: v for k, v in counts.items() if v} }")
    return counts


def analog_vision_path(cfg, params, requests, what):
    """Spikingformer with analog scores (``analog_cfg``) through
    ``build_prefill_step`` answering ``requests``, the counts reset just
    before: its layers are not eligible for the layer program (as in
    JAX) and take the sequential composition, whose SSA bundle runs #6's
    analog instantiation (2 ``fused_ssa_analog`` launches a layer call) and whose
    wo, w1 and w2 run the spike products (3 a layer call,
    ``spike_matmul`` or ``gather_spike_matmul`` as the sparse datapath
    or its 'auto' decisions say), and no other kernel; finite logits.
    Then the same requests with binarized scores (the shipped config: the
    layer program), timed in the same run. Returns (counts, analog ms
    per request, binarized ms per request)."""
    step = steps.build_prefill_step(analog_cfg(cfg))
    binary = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts, decisions = launches(), dict(E.SPARSE_DECISIONS)
    n = cfg.num_layers * len(requests)
    tile, dec = sparse_split(cfg.engine, 3 * n)
    name = f"analog path, {what}, sparse={cfg.engine.sparse!r}"
    folded = fold_analog(counts, cfg.engine, n, name)
    want = dict.fromkeys(folded, 0)
    want.update(fused_ssa_analog=FS.LAUNCHES_PER_CALL * n, spike_matmul=tile,
                gather_spike_matmul=dec, gather_stage=dec)
    if folded != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    n_img = len(requests[0]["images"])
    for logits in outs:
        if logits.shape != (n_img, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: bad logits "
                                 f"{tuple(logits.shape)}")
    bin_outs, bin_ms = timed_requests(binary, params, requests)
    rounded = lambda ms: [round(m, 3) for m in ms]  # noqa: E731
    agree = float((outs[0].argmax(-1) == bin_outs[0].argmax(-1)
                   ).float().mean())
    log(f"{name}: {len(requests)} requests x {n_img} images, launches "
        f"{ {k: v for k, v in counts.items() if v} }, sparse decisions "
        f"{decisions}; ms per request analog {rounded(req_ms)}, binarized "
        f"(the layer program) {rounded(bin_ms)}; logit std "
        f"{float(outs[0].std()):.4f}, argmax agreement with the binarized "
        f"model on the first request {agree:.4f}")
    return counts, req_ms, bin_ms


def least_bit(a):
    """The exponent of the least set bit among the non-zero values of a
    (every one of them a multiple of 2 to that power)."""
    m, e = torch.frexp(a[a != 0].float())
    mi = (m.abs() * 2.0 ** 24).to(torch.int64)       # 24-bit significands
    low = (mi & -mi).double().log2()
    return int((e.double() - 24 + low).min())


def check_analog_outputs(cfg, params, batch, what):
    """One request with analog scores on dyadic weights, for each sparse
    setting ('auto', 'tile', 'decoded'):

    * the logits under overlap='fused' (the bundle #6-analog, then wo,
      w1, w2 on the spike products) == under 'off' (q / k / v on the
      spike products, #7's analog mode, the same wo, w1, w2), bitwise:
      the projections of spikes on dyadic weights are exact, and both
      attention kernels sum the same rounded scores in the same order;
    * the logits through the kernels == through their plain versions,
      bitwise. Every product but wo is exact in any order on dyadic
      weights; wo on the analog context is exact in none, and takes one
      order on both sides: #2's analog mode (``analog=True``, chosen from
      the config's ``binarize_scores=False``) and #4 sum it in ascending
      k, as their plain versions do. Each #2 call on a non-integer left
      operand is checked to be an analog-mode call, and held against its
      plain version bitwise."""
    acfg = analog_cfg(cfg)
    for sparse in ("auto", "tile", "decoded"):
        eng = acfg.engine.replace(sparse=sparse)
        with use_engine(eng.replace(overlap="off")), torch.inference_mode():
            off, _ = registry.forward(params, acfg, batch)
        calls = []
        real = SM.spike_matmul_cuda

        def spy(s, w, bias=None, *, analog=False):
            out = real(s, w, bias, analog=analog)
            # the analog mode's calls, and any call on a non-integer context
            if analog or not bool((s == s.round()).all()):
                calls.append((s, w, bias, analog, out))
            return out
        with use_engine(eng.replace(overlap="fused")), \
                torch.inference_mode():
            reset_counts()
            SM.spike_matmul_cuda = spy
            try:
                got, aux = registry.forward(params, acfg, batch)
            finally:
                SM.spike_matmul_cuda = real
            counts = launches()
            with plain_kernels():
                plain, _ = registry.forward(params, acfg, batch)
        torch.cuda.synchronize()
        name = f"{what} analog, sparse={sparse!r}"
        if counts["fused_ssa_analog"] != FS.LAUNCHES_PER_CALL * \
                cfg.num_layers or \
                any(n for k, n in counts.items() if k.startswith("fused_layer")):
            raise AssertionError(f"{name}: launches {counts}")
        if counts["spike_matmul_analog"] != len(calls) or \
                not all(c[3] for c in calls) or \
                (sparse == "tile" and len(calls) != cfg.num_layers):
            raise AssertionError(f"{name}: {len(calls)} #2 products on the "
                                 f"analog context, analog-mode launches "
                                 f"{counts['spike_matmul_analog']}")
        if not torch.equal(got, off):
            raise AssertionError(f"{name}: 'fused' logits != 'off' (max abs "
                                 f"diff {float((got - off).abs().max())})")
        for s, w, bias, _, out in calls:
            if not torch.equal(out, SM.spike_matmul_plain(s, w, bias,
                                                          analog=True)):
                raise AssertionError(f"{name}: an analog-mode wo product != "
                                     f"its plain version")
        if not torch.equal(got, plain):
            raise AssertionError(
                f"{name}: logits through the kernels != through the plain "
                f"versions (max abs diff {float((got - plain).abs().max())})")
        log(f"check, {name}: logits under 'fused' (launches "
            f"{ {k: v for k, v in counts.items() if v} }) == 'off', bitwise; "
            f"{len(calls)} #2 wo products on the analog context, each in "
            f"the analog mode and equal to its plain version bitwise; the "
            f"logits through the kernels == through the plain versions, "
            f"bitwise (fire rate {float(aux['fire_rate']):.4f}, logit std "
            f"{float(got.std()):.4f})")


def qat_masters(params, qat):
    """Params whose linear weights have, in every column, an amax of
    ``qmax * 2^-e`` (e per leaf, the largest that keeps the leaf's own
    amax inside): every per-column scale of ``fake_quant`` is then
    ``2^-e`` exactly and the fake-quantized weights are dyadic, so every
    sum a kernel makes of them is exact."""
    qmax = {8: 127, 4: 7}[INT_BITS[qat]]

    def fix(path, node):
        w = node["w"].float()
        k, n = w.shape[-2:]
        e = math.floor(math.log2(qmax / float(w.abs().max())))
        amax = qmax * 2.0 ** -e
        w = w.clamp(-amax, amax)
        cols = torch.arange(n, device=w.device)
        w[..., (cols * 7) % k, cols] = torch.where(cols % 2 == 0, amax,
                                                   -amax)
        return dict(node, w=w.to(node["w"].dtype))
    return map_param_dicts(params, lambda node: isinstance(node, dict)
                           and "w" in node and node["w"].ndim in (2, 3),
                           fix)


def cifarnet_params(cfg, seed=0):
    """CIFAR-Net params on the 2^-8 grid with BN biases raised by
    CIFAR_BIAS, so every conv fires on init_state."""
    params = dyadic_grid(registry.init(cfg, seed=seed))
    for conv in params["convs"]:
        conv["bn"]["bias"] = conv["bn"]["bias"] + CIFAR_BIAS
    return params


def cifarnet_rate(params, cfg, images):
    """The head's input of an eval forward on init_state: each conv's
    spikes (``SF._conv_bn_lif``) pooled, averaged over T in fp32."""
    state = registry.init_state(cfg, device=images.device)
    x = images.to(SF.dtype_of(cfg))[None].expand(cfg.spiking.time_steps,
                                                 *images.shape)
    for (_, pool), p, st in zip(SF.CIFARNET_SPEC, params["convs"],
                                state["convs"]):
        x = SF._pool(SF._conv_bn_lif(p, st, cfg, x, False)[0], pool)
    return x.float().mean(dim=0)


def exact_bn_state(cfg):
    """CIFAR-Net's init_state with every running variance set to the
    float v next to 1 - 1e-5 for which ``v + 1e-5 == 1`` in fp32 on the
    card and on the CPU: BN's inverse std is then exactly 1 on both
    devices (the card's rsqrt of 1 + 1e-5 is an ulp off the CPU's)."""
    v = torch.tensor(1.0 - 1e-5, dtype=torch.float32)
    for _ in range(8):
        if all(bool(torch.rsqrt(v.to(dev) + 1e-5) == 1.0)
               for dev in ("cpu", "cuda")):
            break
        v = torch.nextafter(v, torch.tensor(1.0))
    else:
        raise AssertionError("no variance with an exact inverse std")
    state = registry.init_state(cfg, device="cpu")
    for st in state["convs"]:
        st["var"].fill_(float(v))
    return state


def check_cifarnet_outputs(cfg, params, images):
    """One CIFAR-Net request's logits on the card against the port's CPU
    run of the same request (params, images and state copied over), on
    dyadic weights and k/256 images, twice:

    * provably exact: cuDNN off on the card (PyTorch's own convolution,
      im2col and a GEMM) and the BN state of :func:`exact_bn_state`. Every
      convolution is then an exact fp32 sum in any order (below 2^24
      units of the products' grid), BN is exact, and LIF, the pools and
      the head are elementwise IEEE operations or exact sums: the logits
      must be equal bitwise;
    * as ``build_prefill_step`` runs it (cuDNN, whose FFT and Winograd
      algorithms round, and init_state, whose rsqrt differs by an ulp
      between the devices): bitwise if so, else within a derived
      tolerance. The head is ``rate @ W + b`` with the rate's entries in
      [0, 1], so a logit moves by at most ``sum_c |delta rate_c| |W_cn|``
      plus two bf16 roundings (the product and the bias add) of its
      size; the rates are measured on both devices. The argmax must
      agree.

    Returns the CPU seconds of one forward."""
    cpu_params = tree_map(lambda a: a.cpu(), params)
    exact = exact_bn_state(cfg)
    with torch.inference_mode():
        with torch.backends.cudnn.flags(enabled=False):
            got, _ = registry.forward(params, cfg, {"images": images.cuda()},
                                      state=tree_map(lambda a: a.cuda(),
                                                     exact))
        want, _ = registry.forward(cpu_params, cfg,
                                   {"images": images.cpu()}, state=exact)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(
            f"cifarnet: the provably exact request on the card != the CPU "
            f"run (max abs diff {float((got.cpu() - want).abs().max())})")
    log(f"check, cifarnet: one request's logits ({len(images)} images) on "
        f"the card (cuDNN off, inverse std exactly 1) == the port's CPU "
        f"run, bitwise; logit std {float(want.std()):.4f}")
    with torch.inference_mode():
        got, _ = registry.forward(params, cfg, {"images": images.cuda()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = registry.forward(cpu_params, cfg, {"images": images.cpu()})
        cpu_s = time.perf_counter() - t0
        rate_gpu = cifarnet_rate(params, cfg, images.cuda()).cpu()
        rate_cpu = cifarnet_rate(cpu_params, cfg, images.cpu())
    got = got.cpu()
    w = cpu_params["head"]["w"].float()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.pow(2.0, torch.floor(torch.log2(big.clamp_min(2 ** -126)))
                    - 7)
    tol = (rate_gpu - rate_cpu).abs() @ w.abs() + 2 * ulp
    err = (got - want).abs()
    log(f"check, cifarnet: the same request as the prefill step runs it "
        f"(cuDNN, init_state) on the card vs the CPU run: bitwise "
        f"{torch.equal(got, want)}; head-input rates differ in "
        f"{int((rate_gpu != rate_cpu).sum())} of {rate_gpu.numel()} entries "
        f"(max {float((rate_gpu - rate_cpu).abs().max())}); logit error max "
        f"{float(err.max())}, derived tolerance min {float(tol.min())} max "
        f"{float(tol.max())}; argmax equal "
        f"{torch.equal(got.argmax(-1), want.argmax(-1))}; CPU {cpu_s:.2f} s")
    if not bool((err <= tol).all()):
        raise AssertionError("cifarnet logits outside the derived tolerance")
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("cifarnet: the argmax differs card vs CPU")
    return cpu_s


def cifarnet_path():
    """CIFAR-Net (the paper's third network, Table IV) at its published
    config through the entry points: ``build_prefill_step`` answering
    CIFAR_REQUESTS requests of CIFAR_BATCH images (k/256) on firing
    weights, then ``train_path``'s 6 AdamW steps from random weights. It
    has no engine and reaches no kernel, as JAX reaches no Pallas kernel
    there: every launch count stays 0. Logs ms per request, the layer
    sparsities and the CPU check (:func:`check_cifarnet_outputs`)."""
    cfg = get_config("cifarnet")
    params = cifarnet_params(cfg)
    gen = torch.Generator().manual_seed(12)
    v = cfg.vision
    requests = [{"images": torch.randint(
        0, 256, (CIFAR_BATCH, v.img_size, v.img_size, v.in_channels),
        generator=gen) / 256.0} for _ in range(CIFAR_REQUESTS)]
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts = launches()
    log(f"cifarnet inference path: {CIFAR_REQUESTS} requests x {CIFAR_BATCH} "
        f"images, per-request ms {[round(m, 3) for m in req_ms]}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if any(counts.values()):
        raise AssertionError(f"cifarnet launched kernels: {counts}")
    for logits in outs:
        if logits.shape != (CIFAR_BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad cifarnet logits {tuple(logits.shape)}")
    sp = layer_sparsities(params, cfg,
                          {"images": requests[0]["images"].cuda()})
    log(f"cifarnet layer sparsities of one request: "
        f"{[(n, round(x, 4)) for n, x in sp]}")
    if any(x >= 1.0 for _, x in sp):
        raise AssertionError(f"cifarnet: an all-dark conv {sp}")
    cpu_s = check_cifarnet_outputs(cfg, params, requests[0]["images"])
    train_counts, step_ms = train_path(cfg)
    if any(train_counts.values()):
        raise AssertionError(f"cifarnet training launched kernels: "
                             f"{train_counts}")
    return dict(request_ms=req_ms, step_ms=step_ms, sparsities=sp,
                cpu_check_s=cpu_s)


def calibrate_path(cfg, params, batch, qdtype, what):
    """``quant.calibrate`` (one unquantized forward and one per clip
    ratio) through the kernels, then through their plain versions: the
    reports (the chosen ratio and every candidate's distances) equal.
    Launches, counted in the kernels' run: the vision model's every
    forward runs the layer program (``FL.LAUNCHES_PER_CALL['bn']`` a layer,
    the variant 'auto' decides); the LM's unquantized bf16 forward is not
    eligible (1 causal ``spike_attention`` a layer) and each int8 one runs
    the rope family (6 ``fused_layer_rope`` a layer, 'auto' deciding
    'tile'). Returns (ms, counts, report)."""
    ratios = len(DEFAULT_RATIOS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, report = calibrate(cfg, params, batch, qdtype)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts, decisions = launches(), dict(E.SPARSE_DECISIONS)
    want = dict.fromkeys(counts, 0)
    if cfg.family == "dense":
        n = cfg.num_layers * ratios
        want["spike_attention"] = cfg.num_layers
        want["fused_layer_rope"] = FL.LAUNCHES_PER_CALL["rope"] * n
        want_dec = {"tile": n, "decoded": 0}
    else:
        tile, dec = sparse_split(cfg.engine, cfg.num_layers * (ratios + 1))
        want["fused_layer"] = FL.LAUNCHES_PER_CALL["bn"] * tile
        want["fused_layer_decoded"] = FL.LAUNCHES_PER_CALL["bn"] * dec
        want_dec = decisions
    with plain_kernels():
        _, plain = calibrate(cfg, params, batch, qdtype)
    log(f"calibrate, {what} {qdtype}: {ms:.3f} ms, launches "
        f"{ {k: v for k, v in counts.items() if v} }, sparse decisions "
        f"{decisions}; chosen {report['chosen']}; candidates "
        f"{[(c['clip_ratio'], c['logit_mae']) for c in report['candidates']]}")
    if counts != want or decisions != want_dec:
        raise AssertionError(f"calibrate {what}: launches {counts}, "
                             f"decisions {decisions}; expected {want}, "
                             f"{want_dec}")
    if plain != report:
        raise AssertionError(f"calibrate {what} {qdtype}: the report "
                             f"through the kernels {report} != through the "
                             f"plain versions {plain}")
    log(f"check, calibrate {what} {qdtype}: the report through the kernels "
        f"== through the plain versions")
    return ms, counts, report


# --- spikingformer-lm training ----------------------------------------


def lm_kernel(cfg):
    """(the kernel, its launches a layer call) of an LM train step: the
    layer program's rope family where the layers are eligible (fp32
    activations), else the sequential composition's binary attention."""
    if cfg.dtype == "float32":
        return "fused_layer_rope", FL.LAUNCHES_PER_CALL["rope"]
    return attention_kernel(cfg), 1


def lm_train_path(cfg, what, n_steps=LM_TRAIN_STEPS, qat=None,
                  compress=False):
    """A token-family training main path: ``n_steps`` AdamW steps of the
    published LM from seeded random weights on the token stream's
    LM_BATCH x LM_PROMPT batches through ``build_train_step``, with the
    launch counts of the whole run (:func:`lm_kernel` a layer call, no
    other kernel); the last loss must be below the first and every param
    leaf must move. Returns (counts, ms per step, losses)."""
    opt = adamw(warmup_cosine(TRAIN_LR, max(1, n_steps // 20), n_steps))
    step_fn = steps.build_train_step(cfg, opt, qat=qat, compress=compress)
    params = registry.init(cfg, seed=0)
    opt_state = opt.init(params)
    if compress:
        opt_state["compress_err"] = compress_state_init(params)
    batch_fn = make_batch_fn(cfg, LM_BATCH, LM_PROMPT)
    batches = [batch_fn(i) for i in range(n_steps)]
    p = params
    torch.cuda.synchronize()
    reset_counts()
    step_ms, metrics = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        p, opt_state, _, m = step_fn(p, opt_state, i, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    counts = launches()
    kernel, per_call = lm_kernel(cfg)
    want = dict.fromkeys(counts, 0)
    want[kernel] = per_call * cfg.num_layers * n_steps
    what = f"LM train path, {what}"
    losses = [m["loss"] for m in metrics]
    log(f"{what}: {n_steps} steps x {LM_BATCH} x {LM_PROMPT} tokens, ms per "
        f"step {[round(x, 3) for x in step_ms]}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"{what}: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in metrics]}")
    if counts != want:
        raise AssertionError(f"{what} launches {counts}, expected {want}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        raise AssertionError(f"non-finite train metrics {metrics}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall {losses}")
    still = [n for n, a, b in zip(leaf_paths(params), tree_leaves(params),
                                  tree_leaves(p)) if torch.equal(a, b)]
    if still:
        raise AssertionError(f"{what}: param leaves {still} did not move")
    return counts, step_ms, losses


class deterministic_algorithms:
    """Within the scope, ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: ops with a deterministic variant take it (the
    embedding's backward, an indexed add of the rows of repeated tokens);
    the rest warn."""

    def __enter__(self):
        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.saved[0],
                                           warn_only=self.saved[1])


def check_lm_train_gradients(cfg, what, qat=None):
    """One LM train step's loss and gradients (``value_and_grad`` on
    LM_GRAD_BATCH x LM_GRAD_PROMPT tokens of the token stream, params on
    the 2^-8 grid; with ``qat`` the masters of :func:`qat_masters`)
    through the kernels against the same with the kernels swapped for
    their plain versions: bitwise, since each kernel equals its plain
    version on these operands and the backward is the same PyTorch code
    on the same forward values. Returns the kernels' run."""
    params = dyadic_grid(registry.init(cfg, seed=2))
    if qat is not None:
        params = qat_masters(params, qat)
    batch = {k: torch.as_tensor(v).cuda() for k, v in make_batch_fn(
        cfg, LM_GRAD_BATCH, LM_GRAD_PROMPT)(3).items()}
    kernel, per_call = lm_kernel(cfg)
    runs = []
    with deterministic_algorithms():
        for plain in (False, True):
            reset_counts()
            with (plain_kernels() if plain else contextlib.nullcontext()):
                loss, _, grads = steps.value_and_grad(cfg, params, batch,
                                                      qat=qat)
            torch.cuda.synchronize()
            runs.append([loss] + tree_leaves(grads))
            want = dict.fromkeys(launches(), 0)
            if not plain:
                want[kernel] = per_call * cfg.num_layers
            if launches() != want:
                raise AssertionError(
                    f"LM gradient check {what} through the "
                    f"{'plain versions' if plain else 'kernels'} launched "
                    f"{launches()}, expected {want}")
    names = ["loss"] + leaf_paths(params)
    differ = [n for n, a, b in zip(names, *runs) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"LM train step {what} through the kernels != "
                             f"through the plain versions at {differ}")
    log(f"check, LM {what}: one train step through the kernels ({kernel}, "
        f"{per_call * cfg.num_layers} launches) == through the plain "
        f"versions, bitwise (loss {float(runs[0][0]):.6f}, "
        f"{len(names) - 1} gradients)")
    return runs[0]


def checkpoint_path():
    """``launch.train.train`` of the published LM at LM_CKPT's small batch,
    checkpoints in a temporary directory under ``build/``, one failure
    injected: it must restart once, from the latest checkpoint before the
    failure, and replay the steps after it, as JAX's loop does; every
    tree the loop restores equals bitwise the tree it saved at that step
    (each save's tree recorded on the card when ``save`` is called).
    Returns (losses, seconds)."""
    saved, restored = {}, []

    class Recording(CheckpointManager):
        def save(self, step, tree, extra=None, blocking=False):
            saved[step] = tree_map(torch.clone, tree)
            super().save(step, tree, extra, blocking)

        def restore(self, template=None, step=None, *, device=None):
            out = super().restore(template, step, device=device)
            restored.append(out)
            return out

    kw = dict(LM_CKPT)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    real = train_loop.CheckpointManager
    train_loop.CheckpointManager = Recording
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) \
                as ckpt_dir:
            losses = train_loop.train(
                "spikingformer-lm", False, kw.pop("total_steps"),
                kw.pop("batch"), TRAIN_LR, ckpt_dir=ckpt_dir, **kw)
            final = Recording(ckpt_dir).restore(device="cuda")
    finally:
        train_loop.CheckpointManager = real
    seconds = time.perf_counter() - t0
    total, every, fail = (LM_CKPT[k] for k in ("total_steps", "ckpt_every",
                                                "inject_failure_at"))
    resume = fail // every * every
    if [r[1] for r in restored] != [resume, total] or \
            len(losses) != total + fail - resume:
        raise AssertionError(
            f"checkpoint path: restored steps {[r[1] for r in restored]}, "
            f"{len(losses)} losses; expected a restore at {resume} (and the "
            f"final read at {total}), {total + fail - resume} losses")
    for tree, step, _ in restored:
        got, want = tree_leaves(tree), tree_leaves(saved[step])
        if len(got) != len(want) or not all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want)):
            raise AssertionError(f"checkpoint path: the tree restored at "
                                 f"step {step} != the tree saved there")
    replay = losses[fail:]
    log(f"checkpoint path: spikingformer-lm {LM_CKPT}: restarted once from "
        f"step {resume}, replayed steps {resume}-{fail - 1} (losses "
        f"{[round(x, 4) for x in losses[resume:fail]]} then "
        f"{[round(x, 4) for x in replay[:fail - resume]]}), the restored "
        f"trees ({len(tree_leaves(final[0]))} leaves each, steps "
        f"{[r[1] for r in restored]}) == the saved ones bitwise; "
        f"{seconds:.1f} s")
    return losses, seconds


PHASES = {}


class phase:
    """A phase of the dense family: device memory freed before it (the
    last model's tensors are gone once its function returns), its
    host-clock seconds and peak device memory logged after, beside the
    card."""

    def __init__(self, what, card):
        self.what, self.card = what, card

    def __enter__(self):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        sec = time.perf_counter() - self.t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"phase {self.what}: {sec:.1f} s, peak device memory "
            f"{peak:.2f} GiB ({self.card})")
        PHASES[self.what] = dict(seconds=sec, peak_gib=peak)



def dense_requests(cfg, spec, seed):
    """spec['requests'] random prompts, the first of the longest length
    spec['prompts'] allows (so a window ring shorter than the cache
    wraps), the rest drawn between its bounds."""
    rng = np.random.default_rng(seed)
    lo, hi = spec["prompts"]
    lengths = [hi] + [int(rng.integers(lo, hi + 1))
                      for _ in range(spec["requests"] - 1)]
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=spec["new"]) for i, n in enumerate(lengths)]


def dense_serve(cfg, params, spec, seed, what):
    """``BatchedServer`` answering :func:`dense_requests` (cache length the
    longest prompt + new tokens, ``spec['chunk']`` a bite), the counts
    set to 0 just before and read just after: no kernel launches and no
    'auto' decision. Tokens per second on the host clock; the rings'
    shapes; the first-token check. Returns the row."""
    reqs = dense_requests(cfg, spec, seed)
    max_len = max(len(r.prompt) for r in reqs) + spec["new"]
    server = BatchedServer(cfg, params, spec["slots"], max_len,
                           chunk=spec["chunk"], trace_logits=True)
    rings = {g: tuple(c["k"].shape) for g, c in server.cache.items()}
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    waves = server.run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts, decisions = launches(), dict(E.SPARSE_DECISIONS)
    n_gen = sum(len(r.generated) for r in server.completed)
    n_pre = sum(len(r.prompt) for r in server.completed)
    row = dict(seconds=sec, waves=waves, generated=n_gen, prompt=n_pre,
               tokens_per_s=(n_gen + n_pre) / sec,
               generated_per_s=n_gen / sec, max_len=max_len,
               chunk=spec["chunk"], rings=rings,
               kv_bytes=server.kv_cache_stats()["kv_bytes"])
    log(f"serve path, {what}: {row}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if any(counts.values()) or any(decisions.values()):
        raise AssertionError(f"serve path {what}: launches {counts}, "
                             f"decisions {decisions}; expected none")
    if len(server.completed) != len(reqs) or any(
            len(r.generated) != spec["new"] for r in server.completed):
        raise AssertionError(f"serve path {what}: not every request was "
                             f"completed")
    server.cache = None
    row["checked"], row["first_token_max_diff"] = first_token_check(
        cfg, params, server.completed, what)
    return row


def dense_prefill(cfg, params, shape, seed, what):
    """``build_prefill_step`` on one batch of ``shape`` tokens, the counts
    set to 0 just before: no launch, finite fp32 logits of the right
    shape. Returns the ms of the call."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                     generator=gen).cuda()}
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    (logits,), (ms,) = timed_requests(step, params, [batch])
    counts = launches()
    if any(counts.values()):
        raise AssertionError(f"{what} prefill: launches {counts}")
    if logits.shape != (*shape, cfg.vocab_size) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what} prefill: bad logits "
                             f"{tuple(logits.shape)} {logits.dtype}")
    log(f"{what} prefill, {shape[0]} x {shape[1]} tokens: {ms:.3f} ms "
        f"(first call), no launch, logit std {float(logits.std()):.4f}")
    return ms


def h2o_path():
    """h2o-danube-3-4b at published width and depth (24 layers, bf16)
    through ``BatchedServer``: H2O_SERVE (prompts past the 4096 window, a
    fixed chunk of 1024, so the rings hold 4096 + 1023 entries and wrap),
    then one int8 request (``quantize_tree``, the weights declaration as
    ``launch/serve.py --quantize int8``: every linear through
    ``dense_quant_linear``)."""
    cfg = get_config("h2o-danube-3-4b")
    params = registry.init(cfg, seed=0)
    row = dense_serve(cfg, params, H2O_SERVE, 21, "h2o-danube-3-4b bf16")
    params = quantize_tree(params, "int8")
    qcfg = cfg.replace(engine=E.EngineConfig(weights="int8"))
    n_q = sum(1 for leaf in tree_leaves(params) if leaf.dtype == torch.int8)
    spec = dict(H2O_SERVE, requests=1, slots=1,
                prompts=(H2O_INT8_PROMPT, H2O_INT8_PROMPT))
    row["int8"] = dense_serve(qcfg, params, spec, 22,
                              f"h2o-danube-3-4b int8 ({n_q} int8 leaves)")
    return row


def gemma_path():
    """gemma3-12b at published width and depth (48 layers, 5:1
    local:global, vocab 262144, tied embeddings, bf16): a prefill of
    GEMMA_PREFILL tokens (past the 1024 window), then GEMMA_SERVE."""
    cfg = get_config("gemma3-12b")
    params = registry.init(cfg, seed=0)
    ms = dense_prefill(cfg, params, GEMMA_PREFILL, 23, "gemma3-12b bf16")
    row = dense_serve(cfg, params, GEMMA_SERVE, 24, "gemma3-12b bf16")
    row["prefill_ms"] = ms
    return row


def cut_path(arch):
    """``arch`` at full width, depth cut to CUT_LAYERS (bf16): one
    LM_BATCH x LM_PROMPT prefill and CUT_SERVE."""
    cfg = get_config(arch).replace(num_layers=CUT_LAYERS)
    params = registry.init(cfg, seed=0)
    ms = dense_prefill(cfg, params, (LM_BATCH, LM_PROMPT), 25,
                       f"{arch} ({CUT_LAYERS} layers)")
    row = dense_serve(cfg, params, CUT_SERVE, 26,
                      f"{arch} ({CUT_LAYERS} layers)")
    row["prefill_ms"] = ms
    return row


def tight_check(arch):
    """``arch`` at full width, TIGHT[arch]['layers'] layers, fp32: the
    server's first-token logits (bites of TIGHT[arch]['chunk'] over window
    rings of window + chunk - 1 entries) against the whole-prompt
    forward's last position (the banded attention), on
    TIGHT[arch]['prompts'] prompts of TIGHT[arch]['length'] tokens.

    The tolerance: both paths compute the same function in fp32 with
    their sums in other orders. A sum of n products in fp32 lies within
    lambda sqrt(n) u of the sum of their magnitudes (probabilistic
    bound, u = 2^-24, lambda = TIGHT_LAMBDA); n is the longest reduction
    on the path (d_ff, d_model or the keys a query sees). The head's
    logit v sums S_v = sum_i |h_i W_iv| (h the forward's final hidden
    state, measured here); each of the 4 * layers reductions before it
    (attention, wo, the MLP's two) moves h by at most the same relative
    amount, which reaches logit v through the same |W_iv|. Two
    evaluations, each within that of the exact value:
    tol_v = 2 (1 + 4 layers) lambda sqrt(n) u S_v."""
    layers, n_prompts, length, chunk = (TIGHT[arch][k] for k in (
        "layers", "prompts", "length", "chunk"))
    cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
    params = registry.init(cfg, seed=3)
    gen = torch.Generator().manual_seed(27)
    tokens = torch.randint(0, cfg.vocab_size, (n_prompts, length),
                           generator=gen)
    server = BatchedServer(cfg, params, n_prompts, length + 1, chunk=chunk,
                           trace_logits=True)
    rings = {g: tuple(c["k"].shape) for g, c in server.cache.items()}
    for i in range(n_prompts):
        server.submit(Request(rid=i, prompt=tokens[i].numpy().astype(
            np.int32), max_new_tokens=1))
    reset_counts()
    server.run()
    counts = launches()
    got = torch.stack([torch.from_numpy(r.logit_trace[0]) for r in sorted(
        server.completed, key=lambda r: r.rid)]).cuda()
    server.cache = None
    want = steps.build_prefill_step(cfg)(params, {"tokens": tokens.cuda()}
                                         )[:, -1]
    with torch.inference_mode():
        x = nn.embed(params["embed"], tokens.cuda())
        pos = torch.arange(length).cuda()
        for kind, lp in TT._layers(params, cfg):
            x = TT.apply_layer(lp, cfg, x, pos, kind, False)
        h = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
        head = params["embed"]["table"].t() if cfg.tie_embeddings \
            else params["lm_head"]["w"]
        mag = h.abs() @ head.abs()
    n = max(cfg.d_ff, cfg.d_model, length)
    tol = (2 * (1 + 4 * layers) * TIGHT_LAMBDA * math.sqrt(n) * 2.0 ** -24
           * mag)
    diff = (got - want).abs()
    ratio = float((diff / tol).max())
    log(f"check, fp32 window rings ({arch} width, {layers} "
        f"layers, rings {rings}, bites of {chunk}, {n_prompts} x {length} "
        f"tokens): first-token logits vs the whole-prompt forward max abs "
        f"diff {float(diff.max())}, tolerance {float(tol.min())}.."
        f"{float(tol.max())} (max diff / tolerance {ratio:.2e}); argmax "
        f"equal {bool((got.argmax(-1) == want.argmax(-1)).all())}; "
        f"launches {sum(counts.values())}")
    if ratio > 1 or any(counts.values()):
        raise AssertionError(f"fp32 window rings, {arch}: diff / "
                             f"tolerance {ratio}, launches {counts}")
    return dict(max_abs_diff=float(diff.max()), ratio=ratio, rings=rings)


def dense_train_path():
    """DENSE_TRAIN AdamW steps of h2o-danube-3-4b at full width, 2 layers
    (bf16), on the token stream through ``build_train_step``, the counts
    set to 0 just before: no launch, finite losses and grad norms, every
    param leaf moved. Returns (ms per step, losses)."""
    n_steps, batch, seq = DENSE_TRAIN
    cfg = get_config("h2o-danube-3-4b").replace(num_layers=2)
    opt = adamw(warmup_cosine(TRAIN_LR, 1, n_steps))
    step_fn = steps.build_train_step(cfg, opt)
    params = registry.init(cfg, seed=0)
    p, opt_state = params, opt.init(params)
    batch_fn = make_batch_fn(cfg, batch, seq)
    torch.cuda.synchronize()
    reset_counts()
    step_ms, metrics = [], []
    for i in range(n_steps):
        b = batch_fn(i)
        t0 = time.perf_counter()
        p, opt_state, _, m = step_fn(p, opt_state, i, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    counts = launches()
    losses = [m["loss"] for m in metrics]
    log(f"dense train path, h2o-danube-3-4b (2 layers, bf16): {n_steps} "
        f"steps x {batch} x {seq} tokens, ms per step "
        f"{[round(x, 3) for x in step_ms]}, losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in metrics]}")
    if any(counts.values()):
        raise AssertionError(f"dense train path: launches {counts}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        raise AssertionError(f"dense train path: non-finite {metrics}")
    still = [n for n, a, b in zip(leaf_paths(params), tree_leaves(params),
                                  tree_leaves(p)) if torch.equal(a, b)]
    if still:
        raise AssertionError(f"dense train path: {still} did not move")
    return step_ms, losses


def window_lm_path(kind, dtype):
    """The published spikingformer-lm with WINDOW_LM[kind] attention,
    ``dtype`` 'bf16', 'fp32' (weights on the 2^-8 grid, as the fp32 LM's
    other kernel checks take them: the layer program's fp32 products then
    sum as its plain version's) or 'int8' (the bf16 tree through
    ``quantize_tree``; local_global's 4-D group leaves stay unquantized,
    in JAX too), through ``build_prefill_step`` on LM_REQUESTS requests
    of LM_BATCH x LM_PROMPT tokens, the counts set to 0 just before: the
    window layers launch nothing; local_global's full layers run the
    layer program's rope family (6 ``fused_layer_rope`` launches a layer
    call, 'auto' deciding 'tile') where eligible (fp32 or quantized),
    else 1 causal ``spike_attention``. One request's logits through the
    kernels == through their plain versions, bitwise. Then WINDOW_SERVE
    with the first-token check. Returns (counts, ms per request, the
    server's row)."""
    cfg = get_config("spikingformer-lm").replace(**WINDOW_LM[kind])
    if dtype == "fp32":
        cfg = cfg.replace(dtype="float32")
    params = registry.init(cfg, seed=0)
    if dtype == "fp32":
        params = dyadic_grid(params)
    if dtype == "int8":
        params = quantize_tree(params, "int8")
        cfg = cfg.replace(engine=cfg.engine.replace(weights="int8"))
    layers = params["groups" if kind == "local_global" else "layers"]
    quantized = any(leaf.dtype == torch.int8 for leaf in tree_leaves(layers))
    what = f"spikingformer-lm {kind} {dtype}"
    gen = torch.Generator().manual_seed(28)
    requests = [{"tokens": torch.randint(0, cfg.vocab_size,
                                         (LM_BATCH, LM_PROMPT),
                                         generator=gen)}
                for _ in range(LM_REQUESTS)]
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, req_ms = timed_requests(step, params, requests)
    counts, decisions = launches(), dict(E.SPARSE_DECISIONS)
    n_full = cfg.num_layers // cfg.global_every \
        if kind == "local_global" else 0
    n = n_full * len(requests)
    want = dict.fromkeys(counts, 0)
    want_dec = {"tile": 0, "decoded": 0}
    if cfg.dtype == "float32" or quantized:
        want["fused_layer_rope"] = FL.LAUNCHES_PER_CALL["rope"] * n
        want_dec["tile"] = n
    else:
        want["spike_attention"] = n
    log(f"{what} prefill: {len(requests)} requests x {LM_BATCH} x "
        f"{LM_PROMPT} tokens, quantized layer linears {quantized}, per-request "
        f"ms {[round(m, 3) for m in req_ms]}, launches "
        f"{ {k: v for k, v in counts.items() if v} }, sparse decisions "
        f"{decisions}")
    if counts != want or decisions != want_dec:
        raise AssertionError(f"{what}: launches {counts}, decisions "
                             f"{decisions}; expected {want}, {want_dec}")
    for logits in outs:
        if logits.shape != (LM_BATCH, LM_PROMPT, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{what}: bad logits")
    batch = {"tokens": requests[0]["tokens"].cuda()}
    got = step(params, batch)
    with plain_kernels():
        plain = step(params, batch)
    if not torch.equal(got, plain):
        raise AssertionError(f"{what}: logits through the kernels != "
                             f"through the plain versions (max abs diff "
                             f"{float((got - plain).abs().max())})")
    log(f"check, {what}: logits through the kernels == through the plain "
        f"versions bitwise on {LM_BATCH} x {LM_PROMPT} tokens, logit std "
        f"{float(got.std()):.4f}")
    row = dense_serve(cfg, params, WINDOW_SERVE, 29, what)
    return counts, req_ms, row


def dense_family(card):
    """The dense family's phases, each with its time and peak memory."""
    out = {}
    with phase("h2o-danube-3-4b server (24 layers, bf16; int8)", card):
        out["h2o"] = h2o_path()
    with phase("gemma3-12b prefill and server (48 layers, bf16)", card):
        out["gemma"] = gemma_path()
    for arch in TIGHT:
        with phase(f"fp32 window rings, {arch} width", card):
            out["tight", arch] = tight_check(arch)
    for arch in ("nemotron-4-15b", "granite-20b"):
        with phase(f"{arch} ({CUT_LAYERS} layers, bf16)", card):
            out[arch] = cut_path(arch)
    with phase("h2o-danube-3-4b train steps (2 layers, bf16)", card):
        out["train"] = dense_train_path()
    for kind in WINDOW_LM:
        for dtype in ("bf16", "int8", "fp32"):
            with phase(f"spikingformer-lm {kind} {dtype}", card):
                out[kind, dtype] = window_lm_path(kind, dtype)
    return out


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-moe-16b"
KIMI = "kimi-k2-1t-a32b"
# deepseek-moe-16b at published width and depth: a prefill of 4 x 512
# tokens, then 4 prompts of 64 tokens fed token by token and 32 new
# tokens each, greedy, through build_serve_step
MOE_PREFILL = (4, 512)
MOE_SERVE = dict(rows=4, prompt=64, new=32)
# the fp32 decode-against-forward check at deepseek's width, 2 layers (one
# dense, one MoE), the capacity factor raised to num_experts / top_k so
# that no choice drops: 2 prompts of 64 tokens; routing ids compared
# wherever the forward's K-th and (K+1)-th probabilities differ by more
# than MOE_MARGIN; the dispatch against the per-token mixture on
# MOE_ORACLE tokens. Reductions a layer on the chain to the head:
# attention's scores and context, wo, the experts' up / gate and down, the
# router's weights, the combine, the shared experts' sum beside them
MOE_TIGHT = dict(layers=2, rows=2, length=64)
MOE_TIGHT_REDUCTIONS = 8
MOE_MARGIN = 1e-5
MOE_ORACLE = 64
# the spiking deepseek-moe-16b (T=4, the engine's defaults: #7 on the
# card; #8 with binary='popcount'): a prefill of 2 x 256 tokens
SPIKING_MOE = dict(t=4, shape=(2, 256))
# kimi-k2-1t-a32b at published width, cut to 2 layers (1 dense + 1 MoE of
# 384 experts: 19.9B parameters, 39.9 GB in bf16; a third layer does not
# fit beside the activations): a prefill of 2 x 512 tokens, then 16 decode
# steps of 2 rows
KIMI_CUT = dict(layers=2, prefill=(2, 512), steps=16)
# AdamW steps of deepseek-moe-16b at full width, 2 layers, on the token
# stream: (steps, batch, tokens)
MOE_TRAIN = (3, 4, 512)


class route_recorder:
    """Within the scope, every ``moe.router_topk`` call records its
    expert ids and each token's margin between the K-th and (K+1)-th
    probabilities (``moe_ffn`` calls it through the module)."""

    def __enter__(self):
        self.real, self.calls = TM.router_topk, []

        def record(x2d, router_w, m):
            out = self.real(x2d, router_w, m)
            probs = torch.softmax(x2d.float() @ router_w, dim=-1)
            top = probs.topk(m.top_k + 1, dim=-1).values
            self.calls.append((out[1].clone(),
                               top[:, m.top_k - 1] - top[:, m.top_k]))
            return out
        TM.router_topk = record
        return self

    def __exit__(self, *exc):
        TM.router_topk = self.real


def decode_tokens(cfg, params, prompts, new, what, batch=None):
    """``build_serve_step`` from an empty cache (with ``batch``, the one
    ``init_cache`` fills from it: whisper's cross K / V): ``prompts`` (B,
    P) fed a token a step, then ``new`` greedy tokens, the counts set to
    0 just before: no launch, finite logits. Returns (logits of every
    step (B, P + new, V), ms a step, tokens/s)."""
    b, p = prompts.shape
    n = p + new
    serve = steps.build_serve_step(cfg)
    cache = registry.init_cache(cfg, b, n, batch=batch,
                                params=None if batch is None else params)
    torch.cuda.synchronize()
    reset_counts()
    outs, tok = [], prompts[:, :1]
    t0 = time.perf_counter()
    for pos in range(n):
        logits, cache = serve(params, cache, tok, pos)
        outs.append(logits)
        tok = prompts[:, pos + 1:pos + 2] if pos + 1 < p else \
            logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launches()
    logits = torch.cat(outs, dim=1)
    if any(counts.values()):
        raise AssertionError(f"{what} decode: launches {counts}")
    if logits.shape != (b, n, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what} decode: bad logits")
    ms, rate = 1e3 * sec / n, b * n / sec
    log(f"{what} decode: {b} rows x {n} steps ({p} prompt tokens fed a "
        f"step, {new} greedy), {ms:.3f} ms a step, {rate:.1f} tokens/s, "
        f"no launch, cache {tree_map(lambda a: tuple(a.shape), cache)}")
    return logits, ms, rate


def moe_prefill(cfg, params, shape, seed, what):
    """``build_prefill_step`` twice on one batch of ``shape`` tokens, the
    counts set to 0 just before: no launch, finite fp32 logits of the
    right shape, the two calls bitwise equal (the combine adds no float
    atomically); ``registry.forward``'s ``moe_aux`` finite. Returns (ms of
    each call, moe_aux, the tokens, the logits)."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen).cuda()
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, ms = timed_requests(step, params, [{"tokens": tokens}] * 2)
    counts = launches()
    if any(counts.values()):
        raise AssertionError(f"{what} prefill: launches {counts}")
    for logits in outs:
        if logits.shape != (*shape, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{what} prefill: bad logits "
                                 f"{tuple(logits.shape)} {logits.dtype}")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{what} prefill: two calls differ (max abs "
                             f"diff {float((outs[0] - outs[1]).abs().max())})")
    with torch.inference_mode():
        _, aux = registry.forward(params, cfg, {"tokens": tokens})
    moe_aux = float(aux["moe_aux"])
    if not math.isfinite(moe_aux):
        raise AssertionError(f"{what}: moe_aux {moe_aux}")
    log(f"{what} prefill, {shape[0]} x {shape[1]} tokens: ms "
        f"{[round(m, 3) for m in ms]}, no launch, two calls bitwise equal, "
        f"logit std {float(outs[0].std()):.4f}, moe_aux {moe_aux:.6f}")
    return ms, moe_aux, tokens, outs[0]


def deepseek_path():
    """deepseek-moe-16b at published width and depth (28 layers, bf16):
    MOE_PREFILL through ``build_prefill_step`` (twice, bitwise equal),
    then MOE_SERVE through ``build_serve_step``."""
    cfg = get_config(DEEPSEEK)
    params = registry.init(cfg, seed=0)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    log(f"{DEEPSEEK}: {n_params / 1e9:.3f} B parameters on the card")
    ms, moe_aux, _, _ = moe_prefill(cfg, params, MOE_PREFILL, 41,
                                    f"{DEEPSEEK} bf16")
    gen = torch.Generator().manual_seed(42)
    prompts = torch.randint(0, cfg.vocab_size, (MOE_SERVE["rows"],
                                                MOE_SERVE["prompt"]),
                            generator=gen).cuda()
    _, step_ms, rate = decode_tokens(cfg, params, prompts, MOE_SERVE["new"],
                                     f"{DEEPSEEK} bf16")
    return dict(params=n_params, prefill_ms=ms, moe_aux=moe_aux,
                decode_step_ms=step_ms, decode_tokens_per_s=rate)


def moe_oracle_check(cfg, lp):
    """``_dispatch_local`` on MOE_ORACLE random tokens at ``cfg``'s width
    (fp32, every choice held) against the explicit per-token mixture of
    JAX's ``tests/test_models.py`` (each choice's expert FFN on its token,
    weighted, summed). Tolerance: both compute the same sums in other
    orders; a sum of n fp32 terms lies within lambda sqrt(n) u of the sum
    of their magnitudes (TIGHT_LAMBDA); the magnitude of an output is the
    weighted mixture of |h| @ |down| with h's own error bound (|u| |x| @
    |gate| silu's slope 1.1 + |silu(g)| |x| @ |up|) in |h|'s place; two
    evaluations, and the combine's k terms."""
    m = cfg.moe
    gen = torch.Generator().manual_seed(43)
    x = torch.randn((MOE_ORACLE, cfg.d_model), generator=gen).cuda()
    w, idx, _, _ = TM.router_topk(x, lp["router"], m)
    got = TM._dispatch_local(x, w, idx, lp["up"], lp["gate"], lp["down"], m,
                             cfg.act, m.num_experts, 0)
    want = torch.zeros_like(got)
    mag = torch.zeros_like(got)
    act = nn.activation(cfg.act)
    for j in range(m.top_k):
        e = idx[:, j]
        up, gate, down = lp["up"][e], lp["gate"][e], lp["down"][e]
        xr = x[:, None, :]
        u, g = torch.bmm(xr, up), torch.bmm(xr, gate)
        h = act(g) * u
        bound = (h.abs() + 1.1 * u.abs() * torch.bmm(xr.abs(), gate.abs())
                 + act(g).abs() * torch.bmm(xr.abs(), up.abs()))
        want = want + w[:, j, None] * torch.bmm(h, down)[:, 0]
        mag = mag + w[:, j, None] * torch.bmm(bound, down.abs())[:, 0]
    n = max(cfg.d_model, m.d_ff_expert)
    tol = 2 * TIGHT_LAMBDA * (math.sqrt(n) + m.top_k) * 2.0 ** -24 * mag
    diff = (got - want).abs()
    ratio = float((diff / tol).max())
    log(f"check, {DEEPSEEK} dispatch against the per-token mixture "
        f"({MOE_ORACLE} tokens at width {cfg.d_model}, {m.num_experts} "
        f"experts, top-{m.top_k}, fp32): max abs diff {float(diff.max())}, "
        f"max diff / tolerance {ratio:.2e}")
    if ratio > 1:
        raise AssertionError(f"dispatch vs per-token mixture: diff / "
                             f"tolerance {ratio}")
    return ratio


def moe_tight_check():
    """deepseek-moe-16b at full width, MOE_TIGHT['layers'] layers, fp32,
    capacity factor num_experts / top_k (no choice drops): the decode
    steps' logits of MOE_TIGHT prompts fed token by token against the
    forward's at every position, within the derived tolerance of
    :func:`tight_check` with MOE_TIGHT_REDUCTIONS reductions a layer and
    n the longest reduction; the routing ids equal wherever the forward's
    margin clears MOE_MARGIN; two prefill calls bitwise equal; the
    dispatch against the per-token mixture (:func:`moe_oracle_check`)."""
    base = get_config(DEEPSEEK)
    m = base.moe
    layers, rows, length = (MOE_TIGHT[k] for k in ("layers", "rows",
                                                   "length"))
    cfg = base.replace(num_layers=layers, dtype="float32",
                       moe=dataclasses.replace(
                           m, capacity_factor=m.num_experts / m.top_k))
    params = registry.init(cfg, seed=3)
    with route_recorder() as fwd:
        ms, _, tokens, want = moe_prefill(
            cfg, params, (rows, length), 44,
            f"{DEEPSEEK} fp32 ({layers} layers)")
    with route_recorder() as dec:
        got, _, _ = decode_tokens(cfg, params, tokens, 0,
                                  f"{DEEPSEEK} fp32 ({layers} layers)")
    with torch.inference_mode():
        x = nn.embed(params["embed"], tokens)
        pos = torch.arange(length).cuda()
        for i in range(m.first_k_dense):
            x = TM._dense_layer(TM._stack_layer(params["dense_layers"], i),
                                cfg, x, pos, False)
        for i in range(layers - m.first_k_dense):
            x, _ = TM._moe_layer(TM._stack_layer(params["layers"], i), cfg,
                                 x, pos, False)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        mag = h.abs() @ params["lm_head"]["w"].abs()
    n = max(m.first_dense_ff, cfg.d_model, m.d_ff_expert, length)
    tol = (2 * (1 + MOE_TIGHT_REDUCTIONS * layers) * TIGHT_LAMBDA
           * math.sqrt(n) * 2.0 ** -24 * mag)
    diff = (got - want).abs()
    ratio = float((diff / tol).max())
    # routing: forward call i (MoE layer i) row b * length + s == decode
    # step s's call i row b
    n_moe = layers - m.first_k_dense
    compared = differ = 0
    for i in range(n_moe):
        f_idx, f_margin = fwd.calls[-n_moe + i]
        for s in range(length):
            d_idx, _ = dec.calls[s * n_moe + i]
            rows_f = torch.arange(rows).cuda() * length + s
            clear = f_margin[rows_f] > MOE_MARGIN
            compared += int(clear.sum())
            differ += int((f_idx[rows_f][clear] != d_idx[clear]).any(-1).sum())
    log(f"check, {DEEPSEEK} fp32 decode against forward ({layers} layers, "
        f"capacity factor {cfg.moe.capacity_factor:.3f}, {rows} x {length} "
        f"tokens): max abs diff {float(diff.max())}, tolerance "
        f"{float(tol.min())}..{float(tol.max())} (max diff / tolerance "
        f"{ratio:.2e}); argmax equal "
        f"{bool((got.argmax(-1) == want.argmax(-1)).all())}; routing ids "
        f"equal on {compared - differ} of {compared} tokens whose margin "
        f"clears {MOE_MARGIN}")
    if ratio > 1 or differ:
        raise AssertionError(f"fp32 MoE decode vs forward: diff / tolerance "
                             f"{ratio}, {differ} tokens routed apart")
    oracle = moe_oracle_check(cfg, TM._stack_layer(params["layers"]["moe"],
                                                   0))
    return dict(max_abs_diff=float(diff.max()), ratio=ratio,
                routed_compared=compared, oracle_ratio=oracle,
                prefill_ms=ms)


def spiking_moe_path():
    """The spiking deepseek-moe-16b at published width and depth (T =
    SPIKING_MOE['t'], bf16, the engine's defaults) through
    ``build_prefill_step`` on SPIKING_MOE['shape'] tokens, the counts set
    to 0 just before: one causal ``spike_attention`` (#7) a layer (dense
    and MoE), no other launch; then with ``binary='popcount'``: one
    ``popcount_scores`` (#8) a layer. Logits through the kernels ==
    through the plain versions, and the #8 run's == the #7 run's,
    bitwise. Returns {mode: (counts, ms)}."""
    base = get_config(DEEPSEEK)
    cfg = base.replace(spiking=SpikingConfig(time_steps=SPIKING_MOE["t"]),
                       engine=E.EngineConfig())
    params = registry.init(cfg, seed=0)
    gen = torch.Generator().manual_seed(45)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, SPIKING_MOE["shape"],
                                     generator=gen).cuda()}
    out, logits = {}, {}
    for binary, kernel in (("mxu_kernel", "spike_attention"),
                           ("popcount", "popcount_scores")):
        c = cfg.replace(engine=cfg.engine.replace(binary=binary))
        step = steps.build_prefill_step(c)
        what = f"spiking {DEEPSEEK} (T={SPIKING_MOE['t']}, binary={binary!r})"
        torch.cuda.synchronize()
        reset_counts()
        (got,), (ms,) = timed_requests(step, params, [batch])
        counts = launches()
        want = dict.fromkeys(counts, 0)
        want[kernel] = cfg.num_layers
        log(f"{what} prefill, {SPIKING_MOE['shape'][0]} x "
            f"{SPIKING_MOE['shape'][1]} tokens: {ms:.3f} ms, launches "
            f"{ {k: v for k, v in counts.items() if v} } (one a layer)")
        if counts != want:
            raise AssertionError(f"{what}: launches {counts}; expected "
                                 f"{want}")
        if got.shape != (*SPIKING_MOE["shape"], cfg.vocab_size) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: bad logits")
        with plain_kernels():
            plain = step(params, batch)
        if not torch.equal(got, plain):
            raise AssertionError(f"{what}: logits through the kernels != "
                                 f"through the plain versions (max abs diff "
                                 f"{float((got - plain).abs().max())})")
        log(f"check, {what}: logits through the kernels == through the "
            f"plain versions bitwise, logit std {float(got.std()):.4f}")
        out[binary], logits[binary] = (counts, ms), got
    if not torch.equal(logits["popcount"], logits["mxu_kernel"]):
        raise AssertionError("spiking MoE prefill: binary='popcount' != "
                             "binary='mxu_kernel'")
    log(f"check, spiking {DEEPSEEK}: the #8 run's logits == the #7 run's, "
        f"bitwise")
    return out


def kimi_path():
    """kimi-k2-1t-a32b at published width, KIMI_CUT['layers'] layers
    (bf16): a prefill of KIMI_CUT['prefill'] tokens (twice, bitwise
    equal), then KIMI_CUT['steps'] decode steps of its rows (the first
    tokens of its prompts, fed a step)."""
    cfg = get_config(KIMI).replace(num_layers=KIMI_CUT["layers"])
    params = registry.init(cfg, seed=0)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    log(f"{KIMI} ({KIMI_CUT['layers']} layers): {n_params / 1e9:.3f} B "
        f"parameters on the card")
    what = f"{KIMI} bf16 ({KIMI_CUT['layers']} layers)"
    ms, moe_aux, tokens, _ = moe_prefill(cfg, params, KIMI_CUT["prefill"],
                                         46, what)
    _, step_ms, rate = decode_tokens(cfg, params,
                                     tokens[:, :KIMI_CUT["steps"]], 0, what)
    return dict(params=n_params, prefill_ms=ms, moe_aux=moe_aux,
                decode_step_ms=step_ms, decode_tokens_per_s=rate)


def moe_train_path():
    """MOE_TRAIN AdamW steps of deepseek-moe-16b at full width, 2 layers
    (bf16), on the token stream through ``build_train_step``, then one
    ``qat='int8'`` step, the counts set to 0 just before each: no launch,
    finite losses, ``moe_aux`` and grad norms, every param leaf moved by
    the plain steps; then one int8 PTQ request (``quantize_tree``: 15 int8
    leaves, the expert stacks and the router fp) through
    ``build_prefill_step``."""
    n_steps, batch, seq = MOE_TRAIN
    cfg = get_config(DEEPSEEK).replace(num_layers=2)
    opt = adamw(warmup_cosine(TRAIN_LR, 1, n_steps))
    params = registry.init(cfg, seed=0)
    batch_fn = make_batch_fn(cfg, batch, seq)
    rows = {}
    for qat, count in ((None, n_steps), ("int8", 1)):
        step_fn = steps.build_train_step(cfg, opt, qat=qat)
        p, opt_state = params, opt.init(params)
        torch.cuda.synchronize()
        reset_counts()
        step_ms, metrics = [], []
        for i in range(count):
            t0 = time.perf_counter()
            p, opt_state, _, m = step_fn(p, opt_state, i, batch_fn(i))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            metrics.append({k: float(v) for k, v in m.items()})
        counts = launches()
        what = f"{DEEPSEEK} (2 layers, bf16{', qat=int8' if qat else ''})"
        log(f"MoE train path, {what}: {count} steps x {batch} x {seq} "
            f"tokens, ms per step {[round(x, 3) for x in step_ms]}, losses "
            f"{[round(m['loss'], 4) for m in metrics]}, moe_aux "
            f"{[round(m['moe_aux'], 5) for m in metrics]}, grad norms "
            f"{[round(m['grad_norm'], 4) for m in metrics]}")
        if any(counts.values()):
            raise AssertionError(f"MoE train path: launches {counts}")
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"MoE train path: non-finite {metrics}")
        if qat is None:
            still = [n for n, a, b in zip(leaf_paths(params),
                                          tree_leaves(params),
                                          tree_leaves(p)) if torch.equal(a, b)]
            if still:
                raise AssertionError(f"MoE train path: {still} did not move")
        rows[qat or "bf16"] = dict(step_ms=step_ms, metrics=metrics)
        del p, opt_state
    q = quantize_tree(params, "int8")
    n_q = sum(1 for leaf in tree_leaves(q) if leaf.dtype == torch.int8)
    if n_q != 15 or q["layers"]["moe"]["up"].dtype == torch.int8 or \
            q["layers"]["moe"]["router"].dtype != torch.float32:
        raise AssertionError(f"int8 MoE tree: {n_q} int8 leaves")
    gen = torch.Generator().manual_seed(47)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=gen).cuda()
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    (got,), (ms,) = timed_requests(step, q, [{"tokens": tokens}])
    counts = launches()
    ref = step(params, {"tokens": tokens})
    log(f"int8 PTQ request, {DEEPSEEK} (2 layers, {n_q} int8 leaves): "
        f"{batch} x {seq} tokens, {ms:.3f} ms, no launch, max abs diff to "
        f"the bf16 tree's logits {float((got - ref).abs().max()):.4f} "
        f"(information)")
    if any(counts.values()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"int8 MoE request: launches {counts} or "
                             f"non-finite logits")
    rows["int8_request_ms"] = ms
    return rows


def moe_family(card):
    """The MoE family's phases, each with its time and peak memory."""
    out = {}
    with phase(f"{DEEPSEEK} prefill and decode (28 layers, bf16)", card):
        out["deepseek"] = deepseek_path()
    with phase(f"{DEEPSEEK} fp32 decode against forward (2 layers, full "
               f"width)", card):
        out["tight"] = moe_tight_check()
    with phase(f"spiking {DEEPSEEK} prefill (28 layers, bf16, "
               f"T={SPIKING_MOE['t']})", card):
        out["spiking"] = spiking_moe_path()
    with phase(f"{KIMI} prefill and decode ({KIMI_CUT['layers']} layers, "
               f"bf16)", card):
        out["kimi"] = kimi_path()
    with phase(f"{DEEPSEEK} train and int8 (2 layers, bf16)", card):
        out["train"] = moe_train_path()
    return out


# ---------------------------------------------------------------------------
# the rwkv, hybrid, encoder-decoder and vision-language families
# ---------------------------------------------------------------------------

RWKV, HYMBA, WHISPER, LLAVA = ("rwkv6-3b", "hymba-1.5b", "whisper-small",
                               "llava-next-mistral-7b")
# published width and depth, bf16: (rows, prompt tokens) of each prefill
# (twice; whisper's tokens follow its 1500 stub frames, llava's its 2880
# stub patches, once), then (prompt tokens fed a step, greedy tokens) of
# the decode loop through build_serve_step on the prefill's first rows
OTHER_PREFILL = {RWKV: (4, 1024), HYMBA: (2, 512), WHISPER: (2, 64),
                 LLAVA: (1, 128)}
OTHER_DECODE = {RWKV: (16, 16), HYMBA: (16, 16), WHISPER: (32, 32)}
# llava's server: text continuations over 4 slots in bites of 64
LLAVA_SERVE = dict(slots=4, requests=8, prompts=(64, 256), new=16, chunk=64)
# the fp32 decode-against-forward check at each width, 2 layers: 2 rows
# of 64 tokens; reductions a layer on the chain to the head (see
# family_tight_check) and the longest reduction n
OTHER_TIGHT = dict(layers=2, rows=2, length=64)
OTHER_REDUCTIONS = {RWKV: 10, HYMBA: 10, WHISPER: 8, LLAVA: 4}
# 2 AdamW steps at each width, 2 layers, on one batch of (rows, tokens)
OTHER_TRAIN = {RWKV: (2, 512), HYMBA: (2, 512), WHISPER: (2, 64),
               LLAVA: (1, 128)}
OTHER_TRAIN_LR = 1e-4


def cut(cfg, layers):
    """``cfg`` at its width with ``layers`` layers (whisper: encoder and
    decoder alike)."""
    out = cfg.replace(num_layers=layers)
    return out.replace(encoder_layers=layers) if cfg.encoder_layers else out


def stub_batch(cfg, rows, tokens, seed):
    """Tokens and the family's stub embeddings (normal, std 0.02, in the
    model's dtype), made on the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, tokens),
                                     generator=gen, device="cuda")}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        fr = cfg.frontend
        batch["patch_embeds"] = 0.02 * torch.randn(
            (rows, fr.num_embeds, fr.embed_dim), generator=gen,
            device="cuda").to(dt)
    if cfg.family == "encdec":
        batch["audio_embeds"] = 0.02 * torch.randn(
            (rows, cfg.encoder_seq, cfg.d_model), generator=gen,
            device="cuda").to(dt)
    return batch


def other_prefill(cfg, params, batch, what, calls=2):
    """``build_prefill_step`` ``calls`` times on ``batch``, the counts set
    to 0 just before: no launch, finite fp32 logits of the right shape.
    Returns (ms of each call, the logits)."""
    step = steps.build_prefill_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    outs, ms = timed_requests(step, params, [batch] * calls)
    counts = launches()
    rows, s = batch["tokens"].shape
    if cfg.family == "vlm":
        s += batch["patch_embeds"].shape[1]
    for logits in outs:
        if logits.shape != (rows, s, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{what} prefill: bad logits "
                                 f"{tuple(logits.shape)} {logits.dtype}")
    if any(counts.values()):
        raise AssertionError(f"{what} prefill: launches {counts}")
    tokens = rows * s
    log(f"{what} prefill, {rows} x {s} positions: ms "
        f"{[round(m, 3) for m in ms]} ({tokens / min(ms) * 1e3:.1f} "
        f"positions/s), no launch, logit std {float(outs[0].std()):.4f}")
    return ms, outs[0]


def other_path(arch):
    """``arch`` at published width and depth (bf16): OTHER_PREFILL, then
    the decode loop of OTHER_DECODE (llava: LLAVA_SERVE through
    ``BatchedServer``)."""
    cfg = get_config(arch)
    params = registry.init(cfg, seed=0)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    log(f"{arch}: {n_params / 1e9:.3f} B parameters on the card")
    what = f"{arch} bf16 ({cfg.num_layers} layers)"
    batch = stub_batch(cfg, *OTHER_PREFILL[arch], 61)
    ms, _ = other_prefill(cfg, params, batch, what,
                          calls=1 if arch == LLAVA else 2)
    row = dict(params=n_params, prefill_ms=ms)
    if arch == LLAVA:
        row["serve"] = dense_serve(cfg, params, LLAVA_SERVE, 62,
                                   f"{arch} bf16 (text continuations)")
        return row
    fed, new = OTHER_DECODE[arch]
    _, row["decode_step_ms"], row["decode_tokens_per_s"] = decode_tokens(
        cfg, params, batch["tokens"][:, :fed], new, what,
        batch=batch if cfg.family == "encdec" else None)
    return row


class head_input:
    """Within the scope, records the LM head's input (the final norm's
    output): the ``x`` of ``nn.linear`` on ``params['lm_head']`` or of
    ``nn.unembed`` (whisper's tied head)."""

    def __init__(self, params):
        self.head = params.get("lm_head")

    def __enter__(self):
        self.linear, self.unembed, self.x = nn.linear, nn.unembed, None

        def linear(p, x, **kw):
            if p is self.head:
                self.x = x
            return self.linear(p, x, **kw)

        def unembed(p, x):
            self.x = x
            return self.unembed(p, x)
        nn.linear, nn.unembed = linear, unembed
        return self

    def __exit__(self, *exc):
        nn.linear, nn.unembed = self.linear, self.unembed


def family_tight_check(arch):
    """``arch`` at its width, OTHER_TIGHT['layers'] layers, fp32: the
    decode steps' logits of OTHER_TIGHT prompts fed token by token
    against the forward's at every position (llava: text prompts against
    its backbone's forward; whisper: frames of std 0.02, positions under
    448, the cross K / V of ``init_cache``), within the tolerance of
    :func:`tight_check` with OTHER_REDUCTIONS[arch] reductions a layer on
    the chain to the head and n the longest reduction (d_ff, d_model,
    d_inner, the prompt or whisper's 1500 frames). The reductions a
    layer: rwkv the token shift's two LoRA products, r / k / v / g, the
    decay's LoRA, the WKV sums over the head and over the tokens, wo,
    the channel mix's three; hymba attention's scores and context, wo,
    in_proj, x_proj, dt_proj, the scan over the tokens and its C sum,
    out_proj, the MLP; whisper self attention's two, its wo, cross
    attention's two (1500 frames), its wo, the MLP's two; llava the dense
    family's four. The two paths' WKV differ in form as well (the
    forward's chunks of 32, the decode's scan), exact in real numbers."""
    layers, rows, length = (OTHER_TIGHT[k] for k in ("layers", "rows",
                                                      "length"))
    cfg = cut(get_config(arch), layers).replace(dtype="float32")
    params = registry.init(cfg, seed=3)
    batch = stub_batch(cfg, rows, length, 63)
    fwd_cfg = cfg.replace(family="dense") if arch == LLAVA else cfg
    fwd_batch = {"tokens": batch["tokens"]} if arch == LLAVA else batch
    with head_input(params) as rec:
        _, want = other_prefill(fwd_cfg, params, fwd_batch,
                                f"{arch} fp32 ({layers} layers)", calls=1)
    head = params["lm_head"]["w"] if "lm_head" in params else \
        params["embed"]["table"].t()
    mag = rec.x.abs().float() @ head.abs().float()
    got, _, _ = decode_tokens(cfg, params, batch["tokens"], 0,
                              f"{arch} fp32 ({layers} layers)",
                              batch=batch if arch == WHISPER else None)
    di = cfg.ssm.expand * cfg.d_model if cfg.ssm else 0
    n = max(cfg.d_ff, cfg.d_model, di, length,
            cfg.encoder_seq if cfg.encoder_layers else 0)
    tol = (2 * (1 + OTHER_REDUCTIONS[arch] * layers) * TIGHT_LAMBDA
           * math.sqrt(n) * 2.0 ** -24 * mag)
    diff = (got - want).abs()
    ratio = float((diff / tol).max())
    log(f"check, {arch} fp32 decode against forward ({layers} layers, "
        f"{rows} x {length} tokens, n {n}): max abs diff "
        f"{float(diff.max())}, tolerance {float(tol.min())}.."
        f"{float(tol.max())} (max diff / tolerance {ratio:.2e}); argmax "
        f"equal {bool((got.argmax(-1) == want.argmax(-1)).all())}")
    if ratio > 1:
        raise AssertionError(f"fp32 {arch} decode vs forward: diff / "
                             f"tolerance {ratio}")
    return dict(max_abs_diff=float(diff.max()), ratio=ratio)


def other_train_path(arch):
    """2 AdamW steps of ``arch`` at its width, 2 layers (bf16), on one
    batch of OTHER_TRAIN[arch] (``make_batch_fn``'s: tokens and the
    family's fp32 stub embeddings), through ``build_train_step``, the
    counts set to 0 just before: no launch, finite losses and grad
    norms, the second loss not above the first (the same batch after one
    step at OTHER_TRAIN_LR). Returns (ms per step, losses)."""
    rows, seq = OTHER_TRAIN[arch]
    cfg = cut(get_config(arch), 2)
    opt = adamw(warmup_cosine(OTHER_TRAIN_LR, 1, 2))
    step_fn = steps.build_train_step(cfg, opt)
    params = registry.init(cfg, seed=0)
    p, opt_state = params, opt.init(params)
    batch = make_batch_fn(cfg, rows, seq)(0)
    torch.cuda.synchronize()
    reset_counts()
    step_ms, metrics = [], []
    for i in range(2):
        t0 = time.perf_counter()
        p, opt_state, _, m = step_fn(p, opt_state, i, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    counts = launches()
    losses = [m["loss"] for m in metrics]
    log(f"train path, {arch} (2 layers, bf16): 2 steps x {rows} x {seq} "
        f"tokens{' + stub embeddings' if arch in (WHISPER, LLAVA) else ''}"
        f", ms per step {[round(x, 3) for x in step_ms]}, losses "
        f"{[round(x, 5) for x in losses]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in metrics]}")
    if any(counts.values()):
        raise AssertionError(f"{arch} train path: launches {counts}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{arch} train path: non-finite {metrics}")
    if losses[1] > losses[0]:
        raise AssertionError(f"{arch} train path: loss rose {losses}")
    return step_ms, losses


def other_families(card):
    """The rwkv, hybrid, encdec and vlm families' phases, each with its
    time and peak memory."""
    out = {}
    for arch in (RWKV, HYMBA, WHISPER, LLAVA):
        depth = get_config(arch).num_layers
        with phase(f"{arch} prefill and decode ({depth} layers, bf16)",
                   card):
            out[arch] = other_path(arch)
    for arch in (RWKV, HYMBA, WHISPER, LLAVA):
        with phase(f"{arch} fp32 decode against forward (2 layers, full "
                   f"width)", card):
            out["tight", arch] = family_tight_check(arch)
        with phase(f"{arch} train steps (2 layers, bf16)", card):
            out["train", arch] = other_train_path(arch)
    return out


# ---------------------------------------------------------------------------
# the distributed layer: the mesh server and expert parallelism, on ranks
# that launch.mesh starts (NCCL for one rank on the card, gloo for ranks
# that share it: their collectives go through host memory, so their times
# say nothing of NVLink)
# ---------------------------------------------------------------------------

# (data, model) meshes of the int8 spikingformer-lm server
MESH_SERVE = ((1, 1), (1, 2), (2, 1), (2, 2))
# deepseek-moe-16b expert-parallel over (data 1, model 2): a prefill of
# MOE_PREFILL tokens, then EP_DECODE_STEPS decode steps of its rows fed
# fixed tokens, at the published capacity factor and at E / K (nothing
# drops)
EP_MESH = (1, 2)
EP_DECODE_STEPS = 32


def gathered(mesh, info):
    """Every rank's ``info`` (a small dict), in rank order."""
    import torch.distributed as dist
    every = [None] * int(np.prod(mesh.devices.shape))
    dist.all_gather_object(every, info)
    return every


def mesh_serve_rank(mesh, cfg, host):
    """One rank of the int8 spikingformer-lm server on ``mesh``: the
    published config's tree (``lm_config``) handed over in host memory,
    of which the rank copies only its slices to the card;
    ``serve_requests`` over SERVE_SLOTS slots, the counts set to 0 just
    before the run. ``peak_gib``: the rank's peak device memory over its
    whole life (its slices, its cache, the run)."""
    from repro_torch.parallel import collectives as PC
    server = BatchedServer(cfg, host, SERVE_SLOTS, SERVE_MAX_LEN, mesh=mesh)
    for r in serve_requests(cfg):
        server.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    PC.reset_counts()
    t0 = time.perf_counter()
    waves = server.run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n_tok = sum(len(r.generated) + len(r.prompt) for r in server.completed)
    info = dict(rank=mesh.rank, coords=mesh.coords, seconds=sec,
                waves=waves, tokens_per_s=n_tok / sec,
                launches={k: v for k, v in launches().items() if v},
                params=server.param_bytes(), kv=server.kv_cache_stats(),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                collectives=dict(PC.COUNTS),
                collective_bytes=dict(PC.BYTES))
    return dict(backend=mesh.backend, ranks=gathered(mesh, info),
                generated={r.rid: r.generated for r in server.completed})


def mesh_serve_path(serve_gen, card):
    """The int8 spikingformer-lm server on MESH_SERVE: the 1x1 mesh on one
    NCCL rank, the others on gloo ranks sharing the card. Each generates
    what the unsharded server (``serve_path``) generated, request by
    request; no rank launches a kernel (the decode step is plain
    PyTorch); each rank holds 1 / (data x model) of the KV cache and its
    params' spec share. The tree is drawn here, as ``serve_path`` draws
    it, and handed to the ranks in host memory. Logged: tokens/s (host
    clock; gloo ranks share the card and reach each other through host
    memory), the bytes a rank holds against the totals, each rank's peak
    device memory over its life."""
    from repro_torch.launch.mesh import launch
    cfg, params = lm_config(quantize=True)
    host = tree_map(lambda a: a.cpu(), params)
    del params
    torch.cuda.empty_cache()
    out = {}
    for d, m in MESH_SERVE:
        t0 = time.perf_counter()
        run = launch(mesh_serve_rank, d, m, cfg, host)
        wall = time.perf_counter() - t0
        name = f"mesh server {d}x{m} ({run['backend']})"
        if run["generated"] != serve_gen:
            bad = [rid for rid in serve_gen
                   if run["generated"].get(rid) != serve_gen[rid]]
            raise AssertionError(f"{name}: requests {bad} generated other "
                                 f"tokens than the unsharded server")
        for r in run["ranks"]:
            if r["launches"]:
                raise AssertionError(f"{name} rank {r['rank']}: launches "
                                     f"{r['launches']}")
            if r["kv"]["kv_bytes_rank"] * d * m != r["kv"]["kv_bytes"]:
                raise AssertionError(f"{name} rank {r['rank']}: kv {r['kv']}")
        out[d, m] = dict(run, wall_s=wall)
        r0 = run["ranks"][0]
        log(f"check, {name}: {len(serve_gen)} requests generated the "
            f"unsharded server's tokens, request by request; no launch; "
            f"tokens/s {[round(r['tokens_per_s'], 1) for r in run['ranks']]}"
            f" ({r0['waves']} waves, {r0['seconds']:.2f} s), kv "
            f"{r0['kv']['kv_bytes_rank']} of {r0['kv']['kv_bytes']} bytes a "
            f"rank, params {[r['params']['rank'] for r in run['ranks']]} of "
            f"{r0['params']['total']} bytes, peak GiB "
            f"{[round(r['peak_gib'], 3) for r in run['ranks']]}, rank 0's "
            f"collectives {r0['collectives']} ({r0['collective_bytes']} "
            f"bytes sent), launch and run {wall:.1f} s ({card})")
    return out


def half_ulp_bf16(v):
    """Half a bf16 ulp of each fp32 value (0 at 0): the largest error of
    rounding it to bf16."""
    _, e = torch.frexp(v.float())
    return torch.where(v == 0, torch.zeros_like(v.float()),
                       torch.ldexp(torch.ones_like(v.float()), e - 9))


class ep_emulation:
    """Within the scope, ``moe.moe_ffn`` computes in one process what
    ``ep`` expert-parallel ranks compute (each rank's ``_dispatch_local``
    on its E / ep experts, its fp32 combine rounded to the activation
    dtype, the ranks' results added in rank order in that dtype), and
    holds it against the unsharded combine (all experts, one fp32 sum
    rounded once) on the same input, element by element, within the
    bound that those roundings give: half a bf16 ulp of each rank's
    partial P_r, of their sum and of the unsharded result, plus 2^-20 of
    sum_r |P_r| + |S| for the fp32 sums taken in two groupings (at most
    K = 6 terms a token, each rounding within 2^-24 of its partial)."""

    def __init__(self, ep):
        self.ep, self.calls, self.worst = ep, 0, 0.0

    def __enter__(self):
        self.real = TM.moe_ffn

        def emulated(p, x, cfg):
            m = cfg.moe
            x2d = x.reshape(-1, x.shape[-1])
            w, idx, aux_lb, aux_z = TM.router_topk(x2d, p["router"], m)
            e_loc = m.num_experts // self.ep
            parts = [TM._dispatch_local(
                x2d, w, idx, p["up"][o:o + e_loc], p["gate"][o:o + e_loc],
                p["down"][o:o + e_loc], m, cfg.act, e_loc, o,
                out_dtype=torch.float32)
                for o in range(0, m.num_experts, e_loc)]
            y = parts[0].to(x.dtype)
            for part in parts[1:]:
                y = y + part.to(x.dtype)
            full = TM._dispatch_local(x2d, w, idx, p["up"], p["gate"],
                                      p["down"], m, cfg.act, m.num_experts,
                                      0, out_dtype=torch.float32)
            un = full.to(x.dtype).float()
            bound = sum(half_ulp_bf16(t) for t in parts) + \
                half_ulp_bf16(y.float()) + half_ulp_bf16(un) + \
                2.0 ** -20 * (sum(t.abs() for t in parts) + full.abs())
            diff = (y.float() - un).abs()
            ratio = float((diff / bound.clamp(min=1e-30)).max())
            self.calls += 1
            self.worst = max(self.worst, ratio)
            if bool((diff > bound).any()):
                raise AssertionError(f"EP combine outside its bound of the "
                                     f"unsharded one (worst ratio {ratio})")
            aux = m.router_aux_weight * aux_lb + m.router_z_weight * aux_z
            y = y.reshape(x.shape)
            if m.num_shared:
                y = y + nn.mlp(p["shared"], x, cfg.act)
            return y, aux
        TM.moe_ffn = emulated
        return self

    def __exit__(self, *exc):
        TM.moe_ffn = self.real


class thread_ranks:
    """The ranks of a (1, n) mesh as ``n`` threads of this process on the
    card, each with a ``launch.mesh.Mesh`` of its own coordinates, and
    the collectives (``parallel.collectives``) exchanged through process
    memory in rank order: each thread runs what the gloo rank of its
    coordinates runs (the same operations on the same shapes, its
    params the views of its slices of one whole tree, a copy where a
    slice is not contiguous, as the rank's own copy is), so the ranks'
    results can be held against it bitwise."""

    def __init__(self, n):
        import itertools
        import threading
        from repro_torch.launch.mesh import Mesh
        self.n = n
        self.meshes = []
        for rank in range(n):
            mesh = Mesh.__new__(Mesh)
            mesh.axis_names, mesh.shape = ("data", "model"), {"data": 1,
                                                              "model": n}
            mesh.devices = np.arange(n).reshape(1, n)
            mesh.rank, mesh.coords = rank, {"data": 0, "model": rank}
            mesh.device, mesh.backend = torch.device("cuda"), "threads"
            mesh.device_mesh = None
            mesh._groups = {axes: axes for k in (1, 2) for axes in
                            itertools.combinations(mesh.axis_names, k)}
            self.meshes.append(mesh)
        self.barrier = threading.Barrier(n)
        self.slots, self.seq = {}, [0] * n

    def _gather_list(self, x, mesh, axes):
        _, n = mesh.group(axes)
        if n == 1:
            return None
        key = self.seq[mesh.rank]
        self.seq[mesh.rank] += 1
        self.slots[key, mesh.rank] = x.detach().contiguous().clone()
        self.barrier.wait()
        parts = [self.slots[key, r] for r in range(n)]
        self.barrier.wait()
        del self.slots[key, mesh.rank]
        return parts

    def run(self, fn, *args):
        """[fn(mesh of rank r, *args) for every rank r], run together."""
        import threading
        from repro_torch.parallel import collectives as PC
        out, errors = [None] * self.n, []

        def body(rank):
            try:
                out[rank] = fn(self.meshes[rank], *args)
            except BaseException as e:      # noqa: BLE001 - re-raised
                errors.append(e)
                self.barrier.abort()
        real = PC._gather_list
        PC._gather_list = self._gather_list
        try:
            threads = [threading.Thread(target=body, args=(r,))
                       for r in range(self.n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            PC._gather_list = real
        if errors:
            raise errors[0]
        return out


def ep_sharded_thread(mesh, cfg, params, prefill, fed):
    """``ep_rank``'s prefill and decode on one ``thread_ranks`` rank:
    digests of the logits (rank 0: the logits too)."""
    from repro_torch.parallel.sharding import local_slice
    specs = TM.mesh_specs(cfg, mesh)

    def mine(a, spec):
        v = local_slice(a, spec, mesh)
        return v if v.is_contiguous() else v.clone()
    local = tree_map(mine, params, specs)
    with TM.use_ep_mesh(mesh, token_axes=("data",)), \
            spmd.use_mesh(spmd.MeshScope(mesh, cfg, specs)):
        pre, dec, _, _ = ep_run(cfg, local, prefill, fed)
    return dict(prefill=digest(pre), decode=digest(dec),
                logits=(pre, dec) if mesh.rank == 0 else None)


def digest(t):
    """sha256 of a tensor's bytes (bitwise identity across processes)."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def ep_cfgs():
    """deepseek-moe-16b at the published capacity factor and at E / K."""
    base = get_config(DEEPSEEK)
    ek = base.moe.num_experts / base.moe.top_k
    return {cf: base.replace(moe=dataclasses.replace(base.moe,
                                                     capacity_factor=cf))
            for cf in (base.moe.capacity_factor, ek)}


def ep_tokens(cfg):
    gen = torch.Generator().manual_seed(48)
    prefill = torch.randint(0, cfg.vocab_size, MOE_PREFILL, generator=gen)
    fed = torch.randint(0, cfg.vocab_size, (MOE_PREFILL[0],
                                            EP_DECODE_STEPS), generator=gen)
    return prefill.cuda(), fed.cuda()


def ep_run(cfg, params, prefill, fed):
    """(prefill logits, decode logits (rows, steps, V), prefill ms, ms a
    decode step) through ``build_prefill_step`` and ``build_serve_step``
    (fixed tokens fed a step from an empty cache)."""
    step = steps.build_prefill_step(cfg)
    serve = steps.build_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": prefill})
    torch.cuda.synchronize()
    pre_ms = 1e3 * (time.perf_counter() - t0)
    cache = registry.init_cache(cfg, fed.shape[0], fed.shape[1])
    outs = []
    t0 = time.perf_counter()
    for pos in range(fed.shape[1]):
        lg, cache = serve(params, cache, fed[:, pos:pos + 1], pos)
        outs.append(lg)
    torch.cuda.synchronize()
    dec_ms = 1e3 * (time.perf_counter() - t0) / fed.shape[1]
    return logits, torch.cat(outs, dim=1), pre_ms, dec_ms


def ep_reference():
    """In this process, at published width and depth: for each capacity
    factor, the unsharded run, the EP arithmetic (``ep_emulation``) and
    the sharded ranks' arithmetic (``thread_ranks``). The gates: each
    MoE layer's EP combine within its derived bound of the unsharded
    combine on the same input, and, in ``ep_path``, the ranks' logits
    equal to the threads' bitwise. Through 28 layers of random weights
    no bound on the logits follows from the per-call one (a routing
    choice flips on a rounding), so the runs' logits apart (max abs
    difference, argmax agreement) are logged as information only.
    Returns {cf: the threads' digests and the unsharded run's times}."""
    cfgs = ep_cfgs()
    any_cfg = next(iter(cfgs.values()))
    params = registry.init(any_cfg, seed=0)
    prefill, fed = ep_tokens(any_cfg)
    out = {}
    for cf, cfg in cfgs.items():
        un = ep_run(cfg, params, prefill, fed)
        with ep_emulation(EP_MESH[1]) as emu:
            em = ep_run(cfg, params, prefill, fed)
        sharded = thread_ranks(EP_MESH[1]).run(ep_sharded_thread, cfg,
                                               params, prefill, fed)
        sh = sharded[0].pop("logits")
        if any(r["prefill"] != sharded[0]["prefill"] or
               r["decode"] != sharded[0]["decode"] for r in sharded):
            raise AssertionError(f"{DEEPSEEK} sharded threads: the ranks' "
                                 f"gathered logits differ")
        stats = []
        for run, got in (("EP arithmetic", em), ("sharded", sh)):
            for what, a, b in (("prefill", un[0], got[0]),
                               ("decode", un[1], got[1])):
                d = (a - b).abs().amax(-1)
                same = a.argmax(-1) == b.argmax(-1)
                stats.append(f"{run} {what} max abs diff "
                             f"{float(d.max()):.4g}, argmax equal at "
                             f"{float(same.float().mean()):.4f} of "
                             f"{same.numel()} positions")
        log(f"check, {DEEPSEEK} EP arithmetic (ep={EP_MESH[1]}, capacity "
            f"{cf:.4g}) in one process: {emu.calls} MoE calls, each within "
            f"its bound of the unsharded combine (worst ratio "
            f"{emu.worst:.3g}); against the unsharded run (information): "
            + "; ".join(stats) + f"; unsharded prefill {un[2]:.1f} ms, "
            f"{un[3]:.3f} ms a decode step")
        out[cf] = dict(sharded[0], unsharded_prefill_ms=un[2],
                       unsharded_step_ms=un[3])
        del un, em, sh, sharded
    del params
    return out


def ep_rank(mesh):
    """One rank of deepseek-moe-16b sharded as ``_MOE``'s specs say
    (``moe.mesh_specs``: attention heads, the dense layer's and the
    shared experts' d_ff, the vocab and the routed experts over 'model'),
    under a ``MeshScope`` and ``use_ep_mesh`` (token axes ('data',)):
    params drawn with ``ep_keep`` (this rank's slice of every leaf, each
    expert stack cut as it is drawn); for each capacity factor the
    prefill and decode run (digests, times); then the spiking deepseek
    prefill (T = SPIKING_MOE['t']) under #7 and under #8, the counts set
    to 0 just before each: one launch a layer on this rank's 8 heads,
    logits == through ``plain_kernels()`` bitwise, #8 == #7."""
    scfg = get_config(DEEPSEEK).replace(
        spiking=SpikingConfig(time_steps=SPIKING_MOE["t"]),
        engine=E.EngineConfig())
    specs = TM.mesh_specs(scfg, mesh)
    params = TM.init(scfg, 0, keep=TM.ep_keep(scfg, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    info = dict(rank=mesh.rank, experts=tuple(params["layers"]["moe"]["up"]
                                              .shape),
                param_gib=sum(a.numel() * a.element_size()
                              for a in tree_leaves(params)) / 2 ** 30,
                init_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    torch.cuda.reset_peak_memory_stats()
    with TM.use_ep_mesh(mesh, token_axes=("data",)), \
            spmd.use_mesh(spmd.MeshScope(mesh, scfg, specs)):
        for cf, cfg in ep_cfgs().items():
            prefill, fed = ep_tokens(cfg)
            reset_counts()
            pre, dec, pre_ms, dec_ms = ep_run(cfg, params, prefill, fed)
            info[cf] = dict(prefill=digest(pre), decode=digest(dec),
                            prefill_ms=pre_ms, step_ms=dec_ms,
                            launches={k: v for k, v in launches().items()
                                      if v})
            del pre, dec
        gen = torch.Generator().manual_seed(45)
        batch = {"tokens": torch.randint(0, scfg.vocab_size,
                                         SPIKING_MOE["shape"],
                                         generator=gen).cuda()}
        spiking = {}
        for binary, kernel in (("mxu_kernel", "spike_attention"),
                               ("popcount", "popcount_scores")):
            c = scfg.replace(engine=scfg.engine.replace(binary=binary))
            step = steps.build_prefill_step(c)
            torch.cuda.synchronize()
            reset_counts()
            (got,), (ms,) = timed_requests(step, params, [batch])
            counts = {k: v for k, v in launches().items() if v}
            with plain_kernels():
                plain = step(params, batch)
            spiking[binary] = dict(ms=ms, launches=counts,
                                   plain_equal=bool(torch.equal(got, plain)),
                                   finite=bool(torch.isfinite(got).all()),
                                   digest=digest(got))
        info["spiking"] = spiking
    info["run_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return gathered(mesh, info)


def ep_path(card):
    """deepseek-moe-16b at published width and depth, sharded over
    EP_MESH (gloo ranks sharing the card): ``ep_reference`` here first
    (freed before the ranks start), then the ranks, whose prefill and
    decode logits must equal the thread ranks' bitwise on every rank,
    and whose spiking prefill launches #7 (and #8 under popcount) once a
    layer on each rank, equal to the plain versions bitwise."""
    from repro_torch.launch.mesh import launch
    ref = ep_reference()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(ep_rank, *EP_MESH)
    wall = time.perf_counter() - t0
    layers = get_config(DEEPSEEK).num_layers
    for r in ranks:
        name = f"{DEEPSEEK} EP rank {r['rank']}"
        for cf, want in ref.items():
            got = r[cf]
            if got["prefill"] != want["prefill"] or \
                    got["decode"] != want["decode"]:
                raise AssertionError(f"{name}, capacity {cf}: logits != the "
                                     f"thread ranks'")
            if got["launches"]:
                raise AssertionError(f"{name}: launches {got['launches']}")
        sp = r["spiking"]
        for binary, kernel in (("mxu_kernel", "spike_attention"),
                               ("popcount", "popcount_scores")):
            if sp[binary]["launches"] != {kernel: layers} or \
                    not sp[binary]["plain_equal"] or \
                    not sp[binary]["finite"]:
                raise AssertionError(f"{name} spiking {binary}: "
                                     f"{sp[binary]}")
        if sp["popcount"]["digest"] != sp["mxu_kernel"]["digest"]:
            raise AssertionError(f"{name}: spiking #8 logits != #7's")
    spiking_ms = [{b: round(v["ms"], 1) for b, v in r["spiking"].items()}
                  for r in ranks]
    log(f"check, {DEEPSEEK} sharded over {EP_MESH} (gloo ranks on "
        f"{card}): every rank's prefill and {EP_DECODE_STEPS} decode steps "
        f"== the thread ranks' bitwise at capacity "
        f"{[round(cf, 4) for cf in ref]}; experts a rank "
        f"{[r['experts'] for r in ranks]}, params GiB a rank "
        f"{[round(r['param_gib'], 3) for r in ranks]}, peak GiB while "
        f"drawing (a whole expert stack before its slice is kept) "
        f"{[round(r['init_peak_gib'], 3) for r in ranks]} and after "
        f"{[round(r['run_peak_gib'], 3) for r in ranks]}; prefill ms "
        f"{[[round(r[cf]['prefill_ms'], 1) for cf in ref] for r in ranks]}, "
        f"ms a decode step "
        f"{[[round(r[cf]['step_ms'], 2) for cf in ref] for r in ranks]}; "
        f"spiking prefill: {layers} #7 and {layers} #8 launches a rank, "
        f"logits == plain bitwise, #8 == #7, ms {spiking_ms}; launch and "
        f"run {wall:.1f} s")
    return dict(ranks=ranks, reference=ref, wall_s=wall)


def distributed_layer(serve_gen, card):
    """The distributed layer's phases, each with its time and peak memory
    (the parent's; the ranks log their own)."""
    out = {}
    with phase("mesh server, int8 spikingformer-lm (1x1 NCCL; 1x2, 2x1, "
               "2x2 gloo)", card):
        out["serve"] = mesh_serve_path(serve_gen, card)
    with phase(f"{DEEPSEEK} expert-parallel over {EP_MESH} (28 layers)",
               card):
        out["ep"] = ep_path(card)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (the MoE experts) sum in fp32, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, (sec, text) in _build.BUILD_LOG.items():
        lines = [ln for ln in text.splitlines() if "ptxas info" in ln]
        log(f"nvcc {name}.cu {sec:.1f} s\n  " + "\n  ".join(lines))

    # --- fused layer against its plain version ---------------------------
    dtypes = (torch.bfloat16, torch.float32)
    layer_err = {}
    for sparse in ("tile", "decoded"):
        layer_err[sparse] = max(
            [check_layer_kernel(dt, sparse=sparse) for dt in dtypes]
            + [check_layer_kernel(dt, *case, sparse=sparse)
               for case in MULTI_BLOCK + EIGHT_CASES
               + [HD128, PIPE_T6, HEADS40, ODD_F] for dt in dtypes]
            + [check_layer_kernel(dt, *EIGHT_LONG[dt], sparse=sparse)
               for dt in dtypes])
    for sparse in ("tile", "decoded"):
        for dt in dtypes:
            args, kw = layer_operands(2, dt, False, sparse=sparse)
            out_k, _ = FL.fused_layer_cuda(*args, **kw)
            out_p, _ = FL.fused_layer_plain(*args, **kw)
            cfg_s = SpikingConfig(time_steps=T)
            agree = (lif_scan(out_k, cfg_s)[0] == lif_scan(out_p, cfg_s)[0]
                     ).float().mean()
            diff = float((out_k.float() - out_p.float()).abs().max())
            log(f"fused_layer {sparse} {dt} random-normal weights "
                f"(information only): max abs diff {diff}, spike agreement "
                f"of LIF(out) {float(agree):.6f}")
    layer_timing = {(sparse, dt): time_layer_kernel(sparse, dt)
                    for sparse in ("tile", "decoded") for dt in dtypes}
    eight_timing = {sparse: time_layer_kernel(sparse, torch.bfloat16,
                                              EIGHT, 128)
                    for sparse in ("tile", "decoded")}

    # --- the rope family (#1c, #6b) against its plain versions ---------
    rope_err = max(check_rope_kernel(dt, *case) for dt in dtypes
                   for case in ROPE_CASES + [PIPE_T6_ROPE, ROPE_D1536])
    rope_timing = time_rope_kernel()
    rope_ssa_err = max(check_rope_ssa_kernel(dt, *case) for dt in dtypes
                       for case in ROPE_SSA_CASES)
    for dt, shapes in ROPE_LONG.items():
        for shape in shapes:
            what = f"long prompt, S={shape[2]}"
            rope_err = max(rope_err, check_rope_kernel(dt, what, shape, 128))
            rope_ssa_err = max(rope_ssa_err,
                               check_rope_ssa_kernel(dt, what, shape[:6]))
    rope_ssa_timing = time_bundle(
        "fused_ssa_rope", *rope_ssa_operands(16, torch.bfloat16,
                                             ROPE_SSA_CASES[0][1]),
        ROPE_SSA_CASES[0][1])

    # --- the pipelined layer program (#1d) against its plain version and
    # #1 -------------------------------------------------------------------
    pipe_err = max(
        [check_pipeline_kernel(dt, "full width", FULL, 64, sparse)
         for sparse in ("tile", "decoded") for dt in dtypes]
        + [check_pipeline_kernel(dt, what, shape, lb, sparse)
           for what, shape, lb in MULTI_BLOCK + EIGHT_CASES
           for sparse in ("tile", "decoded") for dt in dtypes]
        + [check_pipeline_kernel(dt, what, shape, lb, family="rope")
           for what, shape, lb in ROPE_CASES for dt in dtypes]
        + [check_pipeline_kernel(torch.bfloat16, "S=3072",
                                 ROPE_LONG[torch.bfloat16][0], 128,
                                 family="rope")]
        + [check_pipeline_kernel(torch.float32, *PIPE_LONG, sparse)
           for sparse in ("tile", "decoded")]
        + [check_pipeline_kernel(torch.bfloat16, *case, sparse)
           for sparse in ("tile", "decoded")
           for case in (PIPE_T6, HEADS40, ODD_F)]
        + [check_pipeline_kernel(torch.bfloat16, *ROPE_D1536,
                                 family="rope")]
        + [check_pipeline_kernel(torch.bfloat16, *PIPE_T6_ROPE,
                                 family="rope")])
    pipe_timing = time_pipeline_kernel()
    pipe_eight_timing = time_pipeline_kernel(EIGHT, 128)

    # --- spike kernels against their plain versions ---------------------
    matmul_err = max(
        [check_matmul(dt, what, M_TRAIN, k, n, counts)
         for dt in dtypes for what, k, n, counts in MATMULS[2:]]
        + [check_matmul(dt, "ragged", m, k, n, bias=bias)
           for dt in dtypes for m, k, n in MATMUL_RAGGED
           for bias in (False, True)]
        + [check_matmul(dt, f"8-512 {what}", M_EIGHT, k, n, counts,
                        count_max=EIGHT_L)
           for dt in dtypes for what, k, n, counts in QUANT_EIGHT]
        + [check_matmul(dt, "wo", M_TRAIN, H * HD, D, weights=wk, values=v)
           for dt in dtypes for wk, v in (("dyadic", "analog"),
                                          ("normal", "spikes"),
                                          ("normal", "analog"),
                                          ("normal", "analog normal"))]
        + [check_matmul(dt, "all dark", M_TRAIN, H * HD, D, bias=True,
                        values="dark") for dt in dtypes]
        + [check_matmul(dt, "ragged", m, k, n, bias=True, misaligned=True)
           for dt in dtypes for m, k, n in MATMUL_RAGGED])
    matmul_analog_err = max(
        [check_matmul_analog(dt, "wo", M_TRAIN, H * HD, D, values=v,
                             weights=wk)
         for dt in dtypes for wk in ("normal", "dyadic")
         for v in ("analog", "analog normal", "spikes", "dark")]
        + [check_matmul_analog(dt, "ragged", m, k, n, bias=True,
                               misaligned=mis)
           for dt in dtypes for m, k, n in MATMUL_RAGGED
           for mis in (False, True)])
    matmul_analog_timing = time_matmul_analog()
    attn_err = max([check_attention(dt, *case) for dt in dtypes
                    for case in ATTENTION]
                   + [check_attention(torch.float32, 16, 40, HD, causal,
                                      binarize=False)
                      for causal in (False, True)]
                   + [check_attention(dt, *case, False, binarize=False)
                      for dt in dtypes for case in ANALOG_ATTENTION]
                   + [check_attention(*case)
                      for case in LONG_ATTENTION + WIDE_ATTENTION])
    gather_err = max(
        [check_gather(dt, what, M_TRAIN, k, n, counts, weights=wk)
         for dt in dtypes for what, k, n, counts in MATMULS
         for wk in ("normal", "dyadic")]
        + [check_gather(dt, "ragged", m, k, n, bias=bias)
           for dt in dtypes for m, k, n in MATMUL_RAGGED
           for bias in (False, True)]
        + [check_gather(dt, "wo", M_TRAIN, H * HD, D, weights=wk, values=v)
           for dt in dtypes for wk, v in (("dyadic", "analog"),
                                          ("normal", "analog"),
                                          ("normal", "analog normal"))]
        + [check_gather(dt, "all dark", M_TRAIN, H * HD, D, bias=True,
                        values="dark") for dt in dtypes]
        + [check_gather(dt, f"8-512 {what}", M_EIGHT, k, n, counts,
                        weights=wk, count_max=EIGHT_L)
           for dt in dtypes for what, k, n, counts in QUANT_EIGHT
           for wk in ("normal", "dyadic")])
    matmul_timing = time_products("spike_matmul", SM.spike_matmul_cuda,
                                  SM.spike_matmul_plain, matmul_bound_ms)
    gather_timing = time_products("gather_spike_matmul",
                                  SD.gather_spike_matmul_cuda,
                                  SD.gather_spike_matmul_plain,
                                  gather_bound_ms)
    attn_timing = time_attention(*ATTENTION[0])
    attn_lm_timing = time_attention(*ATTENTION[-1])
    attn_long_timing = time_attention(*LONG_ATTENTION[2][1:5])
    attn_8_512_timing = time_attention(*ATTENTION[2])
    attn_analog_timing = [time_attention(*case, False, binarize=False)
                          for case in ANALOG_ATTENTION]

    # --- the mixed slice's kernels against their plain versions ---------
    quant_err = max(
        [check_quant(dt, what, M_TRAIN, k, n, counts, ragged=rg)
         for dt in dtypes for what, k, n, counts in QUANT_PRODUCTS
         for rg in (False, True)]
        + [check_quant(dt, "ragged", m, k, n, counts=c, bias=bias)
           for dt in dtypes for m, k, n in MATMUL_RAGGED
           for bias, c in ((False, False), (True, True))]
        + [check_quant(dt, f"8-512 {what}", M_EIGHT, k, n, counts,
                       ragged=rg, count_max=EIGHT_L)
           for dt in dtypes for what, k, n, counts in QUANT_EIGHT
           for rg in (False, True)]
        + [check_quant_values(dt, what, *QUANT_VALUES_SHAPE, bias)
           for dt in dtypes for what in QUANT_VALUES
           for bias in (False, True)])
    ssa_err = max(
        [check_ssa_kernel(dt, quant) for dt in dtypes
         for quant in (False, True)]
        + [check_ssa_kernel(dt, quant, *case) for dt in dtypes
           for quant in (False, True) for case in [SSA_RAGGED] + SSA_EIGHT]
        + [check_ssa_kernel(dt, False, zero=True) for dt in dtypes])
    for dt in dtypes:
        ops, kw = ssa_operands(14, dt, False, weights="normal")
        out_k, _ = FS.fused_ssa_cuda(*ops, **kw)
        out_p, _ = FS.fused_ssa_plain(*ops, **kw)
        agree = float((out_k == out_p).float().mean())
        diff = float((out_k.float() - out_p.float()).abs().max())
        log(f"fused_ssa {dt} random-normal weights (information only): "
            f"context entries equal {agree:.6f}, max abs diff {diff}")
    # fp32 activations, as spike_linear passes them (the kernels line),
    # and bf16 ones (the rows of PRs 15-19)
    quant_timing = {
        (path, dt): time_quant_products(name, *fns, dt)
        for path, name, fns in (
            ("tile", "quant_spike_matmul",
             (SM.quant_spike_matmul_cuda, SM.quant_spike_matmul_plain,
              False)),
            ("decoded", "quant_gather_spike_matmul",
             (SD.quant_gather_spike_matmul_cuda,
              SD.quant_gather_spike_matmul_plain, True)))
        for dt in (torch.float32, torch.bfloat16)}
    quant_part_ms = {dt: time_quant_gather_parts(dt)
                     for dt in (torch.float32, torch.bfloat16)}
    ssa_timing = time_ssa_kernel()
    ssa_eight_timing = time_ssa_kernel(SSA_EIGHT[0][1])

    # --- analog scores (#6 / #6b / #1 / #1b / #1c / #1d analog) against
    # their plain versions, timed beside their binarized twins ---------
    analog_err = {
        "ssa": max(check_ssa_analog(dt, what, shape) for dt in dtypes
                   for what, shape in [("full width", SSA_FULL), SSA_RAGGED]
                   + SSA_EIGHT),
        "ssa_rope": max(check_ssa_analog(dt, what, shape, family="rope")
                        for dt in dtypes for what, shape in ROPE_SSA_CASES)}
    for sparse in ("tile", "decoded"):
        analog_err[sparse] = max(
            check_layer_analog(dt, what, shape, lb, sparse) for dt in dtypes
            for what, shape, lb in [("full width", FULL, 64)] + MULTI_BLOCK
            + EIGHT_CASES + [HD128, PIPE_T6, HEADS40])
    analog_err["rope"] = max(check_layer_analog(dt, *case, family="rope")
                             for dt in dtypes
                             for case in ROPE_CASES + [PIPE_T6_ROPE])
    analog_err["pipeline"] = max(
        [check_layer_analog(dt, "full width", FULL, 64, sparse, pipeline=True)
         for sparse in ("tile", "decoded") for dt in dtypes]
        + [check_layer_analog(dt, *ROPE_CASES[0], family="rope",
                              pipeline=True) for dt in dtypes]
        + [check_layer_analog(torch.bfloat16, *PIPE_T6, sparse,
                              pipeline=True) for sparse in ("tile", "decoded")]
        + [check_layer_analog(torch.bfloat16, *PIPE_T6_ROPE, family="rope",
                              pipeline=True)])
    analog_timing = {
        "ssa": time_ssa_analog(SSA_FULL),
        "ssa_8_512": time_ssa_analog(SSA_EIGHT[0][1]),
        "ssa_rope": time_ssa_analog(ROPE_SSA_CASES[0][1], family="rope"),
        "tile": time_layer_analog(),
        "tile_8_512": time_layer_analog(shape=EIGHT, l_block=128),
        "decoded": time_layer_analog("decoded"),
        "decoded_8_512": time_layer_analog("decoded", EIGHT, 128),
        "rope": time_layer_analog(shape=LM_FULL, l_block=128, family="rope"),
        "pipeline": time_layer_analog(pipeline=True)}
    api_counts = kernel_api_analog_path()

    # --- popcount_scores (#8) and lif_forward (#9) against their plain
    # versions -----------------------------------------------------------
    pop_err = max(
        [check_popcount(what, bh, l, l, d) for what, bh, l, d in POPCOUNT_PATHS]
        + [check_popcount("ragged", 16, 50, 70, HD),
           check_popcount("padded word", 8, 100, 90, 80),
           check_popcount("zero words", 4, 64, 64, 80, words="zeros"),
           check_popcount("one words", 4, 64, 64, 80, words="ones")]
        + [check_popcount(*case) for case in POPCOUNT_SHAPES])
    lif_err = max(check_lif(what, shape, dt, soft, decay)
                  for what, shape in LIF_CASES for dt in dtypes
                  for soft in (False, True) for decay in (0.5, 2.0 / 3.0))
    lif_err = max([lif_err] + [check_lif("misaligned", LIF_CASES[2][1], dt,
                                         False, 2.0 / 3.0, misaligned=True)
                               for dt in dtypes])
    log(f"lif_forward: bitwise equal to the plain version at "
        f"{[s for _, s in LIF_CASES]} and a misaligned view, bf16 and fp32, "
        f"hard and soft reset, decay 0.5 and 2/3")
    pop_timing = {what: time_popcount(what, bh, l, d)
                  for what, bh, l, d in POPCOUNT_PATHS}
    lif_timing = {what: time_lif(shape) for what, shape in LIF_CASES[:2]}
    attn_vs = {what: time_popcount_attention(what, bh, l, d,
                                             what == "bf16 LM")
               for what, bh, l, d in POPCOUNT_PATHS}
    log(f"binary_attention forward, popcount mode vs #7: {attn_vs}")

    # --- the inference main paths ----------------------------------------
    cfg = get_config("spikingformer-4-256")
    params = registry.init(cfg, seed=0)
    gen = torch.Generator().manual_seed(1)
    v = cfg.vision
    requests = [{"images": torch.rand((REQUEST_BATCH, v.img_size, v.img_size,
                                       v.in_channels), generator=gen)}
                for _ in range(REQUESTS)]
    engines = {sp: cfg.replace(engine=cfg.engine.replace(sparse=sp))
               for sp in ("auto", "tile", "decoded")}
    eval_counts = {sp: inference_path(c, params, requests)
                   for sp, c in engines.items()}
    with use_engine(cfg.engine):
        sparsities = layer_sparsities(params, cfg,
                                      {"images": requests[0]["images"].cuda()})
    log(f"layer sparsities of one request: "
        f"{[(n, round(s, 4)) for n, s in sparsities]}")

    # --- output check: fused == sequential oracle on a small batch ------
    dy = dyadic_params(params)
    small = (torch.randint(0, 256, (8, v.img_size, v.img_size, v.in_channels),
                           generator=gen) / 256.0).cuda()
    check_vision_outputs(cfg, dy, small, "spikingformer-4-256")

    # --- the mixed-precision int8 path (fused_ssa + int8 products) -----
    firing = dyadic_params(params)
    mixed = quantize_tree(firing, "int8", select=select_mixed)
    mixed_runs = {sp: mixed_path(c, mixed, requests, "mixed")
                  for sp, c in engines.items()}
    mixed_counts = {sp: run[0] for sp, run in mixed_runs.items()}
    for sp in ("auto", "decoded"):   # #5 == #3 bitwise on any weights
        if not all(torch.equal(a, b) for a, b in zip(mixed_runs[sp][2],
                                                     mixed_runs["tile"][2])):
            raise AssertionError(f"mixed int8 requests: sparse={sp!r} "
                                 f"logits != 'tile' logits")
    log("mixed int8 path: the requests' logits with sparse 'auto' and "
        "'decoded' == with 'tile', bitwise")
    fire_rates(cfg, mixed, requests[0]["images"], "mixed int8 path")
    mixed_path(engines["auto"], quantize_tree(firing, "int8",
                                              select=select_qkv),
               requests[:1], "qkv")
    check_mixed_outputs(cfg, params, small)

    # --- Spikingformer-8-512 (the paper's ImageNet workload) -------------
    cfg8 = get_config("spikingformer-8-512")
    params8 = dyadic_params(registry.init(cfg8, seed=0))
    v8 = cfg8.vision
    gen8 = torch.Generator().manual_seed(8)
    requests8 = [{"images": torch.rand((EIGHT_BATCH, v8.img_size,
                                        v8.img_size, v8.in_channels),
                                       generator=gen8)}
                 for _ in range(EIGHT_REQUESTS)]
    engines8 = {sp: cfg8.replace(engine=cfg8.engine.replace(sparse=sp))
                for sp in ("auto", "tile", "decoded")}
    eight_counts = {sp: inference_path(c, params8, requests8)
                    for sp, c in engines8.items()}
    fire_rates(cfg8, params8, requests8[0]["images"], "spikingformer-8-512")
    check_vision_outputs(cfg8, params8, requests8[0]["images"].cuda(),
                         "spikingformer-8-512")

    # --- the popcount paths (#8): 8-512 (b) ------------------------------
    mixed8 = quantize_tree(params8, "int8", dyadic=True, select=select_mixed)
    pop8 = cfg8.replace(engine=cfg8.engine.replace(
        binary="popcount", overlap="off", sparse="auto"))
    pop8_counts, pop8_ms = sequential_vision_path(pop8, mixed8, requests8)
    sequential_vision_path(pop8.replace(engine=pop8.engine.replace(
        binary="mxu_kernel")), mixed8, requests8)
    fire_rates(pop8, mixed8, requests8[0]["images"],
               "spikingformer-8-512 mixed int8, popcount")
    check_popcount_logits(pop8, mixed8, {"images": requests8[0]["images"]},
                          "spikingformer-8-512 mixed int8, overlap='off'",
                          **{"binary='mxu_kernel'": dict(binary="mxu_kernel"),
                             "overlap='fused'": dict(overlap="fused")})

    # --- spikingformer-lm: int8 and bf16 prefill, the int8 server -------
    lm_q = lm_config(quantize=True)
    lm_bf16 = lm_config(quantize=False)
    gen = torch.Generator().manual_seed(7)
    lm_requests = [{"tokens": torch.randint(0, lm_q[0].vocab_size,
                                            (LM_BATCH, LM_PROMPT),
                                            generator=gen)}
                   for _ in range(LM_REQUESTS)]
    lm_mixed = lm_config(quantize=True, select=select_qkv)
    lm_counts, lm_ms = lm_prefill_path(*lm_q, lm_requests, "int8")
    lm_prefill_path(*lm_bf16, lm_requests, "bf16")
    lm_mixed_counts, _ = lm_prefill_path(*lm_mixed, lm_requests,
                                         "mixed int8")
    lm_pop = (lm_bf16[0].replace(engine=lm_bf16[0].engine.replace(
        binary="popcount")), lm_bf16[1])
    lm_pop_counts, lm_pop_ms = lm_prefill_path(*lm_pop, lm_requests,
                                               "bf16 popcount")
    lm_check = {"tokens": lm_requests[0]["tokens"].cuda()}
    check_lm_prefill(*lm_q, lm_check, "int8")
    check_lm_prefill(*lm_bf16, lm_check, "bf16")
    check_lm_prefill(*lm_mixed, lm_check, "mixed int8", oracle=True)
    check_popcount_logits(*lm_pop, lm_check, "spikingformer-lm bf16",
                          **{"the #7 path (binary='mxu_kernel')":
                             dict(binary="mxu_kernel")})
    long_ms, long_counts = long_prompt_path(*lm_bf16)
    long_int8 = long_prompt_path(*lm_q, what="int8")
    long_mixed = long_prompt_path(*lm_mixed, what="mixed int8")
    wide = wide_head_path()
    serve_row, serve_gen = serve_path(*lm_q)
    vision_int8_path()

    # --- overlap='pipeline' (#1d) through build_prefill_step ------------
    pipe_counts = {sp: pipeline_path(engines[sp], dy, requests,
                                     "spikingformer-4-256", oracle=True)
                   for sp in ("tile", "decoded")}
    pipe8 = pipeline_path(cfg8, params8, requests8, "spikingformer-8-512",
                          oracle=True)
    pipe_lm = pipeline_path(lm_q[0], lm_q[1], lm_requests, "int8 LM")
    check_mixed_pipeline(engines["auto"], mixed,
                         {"images": requests[0]["images"]},
                         "int8 spikingformer-4-256", "fused_ssa")
    check_mixed_pipeline(lm_mixed[0], lm_mixed[1], lm_check, "int8 LM",
                         "fused_ssa_rope")

    # --- eval-mode gradients through the layer program ----------------
    check_eval_gradients(cfg, dy, {"images": small},
                         "spikingformer-4-256 (bn)")
    lm32 = get_config("spikingformer-lm").replace(dtype="float32")
    check_eval_gradients(lm32, dyadic_grid(registry.init(lm32, seed=0)), {
        "tokens": torch.randint(0, lm32.vocab_size,
                                (LM_GRAD_BATCH, LM_GRAD_PROMPT),
                                generator=gen).cuda()},
        "spikingformer-lm fp32 (rope)")
    check_eval_gradients(cfg, dy, {"images": small},
                         "spikingformer-4-256 (bn), pipelined",
                         overlap="pipeline")

    # --- analog scores (binarize_scores=False) through the entry points:
    # 8-512 and 4-256 requests (#6-analog), the 4-256 train step (#7's
    # analog mode), the int8 LM prefill (#6b-analog) ---------------------
    analog8 = analog_vision_path(engines8["auto"], params8, requests8,
                                 "spikingformer-8-512")
    check_analog_outputs(cfg8, params8,
                         {"images": requests8[0]["images"].cuda()},
                         "spikingformer-8-512")
    analog4 = {sp: analog_vision_path(engines[sp], dy, requests,
                                      "spikingformer-4-256")
               for sp in ("tile", "decoded")}
    check_analog_outputs(cfg, dy, {"images": requests[0]["images"].cuda()},
                         "spikingformer-4-256")
    analog_train_counts, analog_step_ms = train_path(
        analog_cfg(engines["auto"]))
    check_eval_gradients(analog_cfg(cfg), dy, {"images": small},
                         "spikingformer-4-256 analog (the bundle)",
                         bundle="fused_ssa_analog")
    analog_lm_counts, analog_lm_ms = lm_prefill_path(
        analog_cfg(lm_q[0]), lm_q[1], lm_requests, "analog int8")
    check_lm_prefill(analog_cfg(lm_q[0]), lm_q[1], lm_check, "analog int8")

    # --- the LIF entry (#9) on the layer inputs of one request each -----
    lif_counts = lif_path([(cfg, dy, requests[0]["images"]),
                           (cfg8, params8, requests8[0]["images"])])

    # --- the training main paths, then their gradient checks ------------
    with gather_dtypes() as train_dtypes:
        train_runs = {sp: train_path(c) for sp, c in engines.items()}
    train_counts = {sp: run[0] for sp, run in train_runs.items()}
    log(f"gather_spike_matmul operands of the train paths (s, w): "
        f"{sorted(train_dtypes)}")
    # #4 split at bf16 (the configs' dtype) and at every other dtype the
    # train paths passed it
    gather_parts = {dt: time_gather_parts(dt) for dt in
                    [torch.bfloat16] + sorted({d for d, _ in train_dtypes}
                                              - {torch.bfloat16}, key=str)}
    mxu_runs = {sp: check_train_gradients(c) for sp, c in engines.items()}
    # the popcount path (a): tile datapath, binary='popcount'
    pop_cfg = engines["tile"].replace(engine=engines["tile"].engine.replace(
        binary="popcount"))
    pop_train_counts, pop_step_ms = train_path(pop_cfg)
    pop_run = check_train_gradients(pop_cfg, binary="popcount")
    differ = [i for i, (a, b) in enumerate(zip(pop_run, mxu_runs["tile"]))
              if not torch.equal(a, b)]
    if differ or len(pop_run) != len(mxu_runs["tile"]):
        raise AssertionError(f"train step with binary='popcount' != with "
                             f"'mxu_kernel' at leaves {differ} (0 = loss)")
    log(f"check: one train step with binary='popcount' == with "
        f"binary='mxu_kernel' (#7), bitwise: loss, every gradient and the "
        f"new BN state ({len(pop_run)} tensors)")

    # --- CIFAR-Net; quantization-aware training and PTQ calibration -----
    t_new = time.perf_counter()
    cifar = cifarnet_path()
    qat_runs = {qat: train_path(engines[sp], qat=qat)
                for qat, sp in QAT_PATHS}
    for qat, sp in QAT_PATHS:
        check_train_gradients(engines[sp], qat=qat)
    calib = {q: calibrate_path(cfg, dy, {"images": requests[0]["images"]},
                               q, "spikingformer-4-256")
             for q in ("int8", "int4")}
    calib_lm = calibrate_path(*lm_bf16, lm_requests[0], "int8",
                              "spikingformer-lm")
    log(f"cifarnet, qat and calibration phases: "
        f"{time.perf_counter() - t_new:.1f} s")

    # --- training spikingformer-lm and Spikingformer-8-512 --------------
    t_new = time.perf_counter()
    lm_train = {
        "bf16": lm_train_path(lm_bf16[0], "bf16"),
        "qat int8": lm_train_path(lm_bf16[0], "bf16, qat='int8'",
                                  qat="int8"),
        "compressed": lm_train_path(lm_bf16[0], "bf16, compressed gradients",
                                    compress=True),
        "popcount": lm_train_path(lm_pop[0], "bf16, binary='popcount'"),
        "fp32": lm_train_path(lm32, "fp32")}
    gap = [c - u for c, u in zip(lm_train["compressed"][2],
                                 lm_train["bf16"][2])]
    log(f"LM train path: the compressed run's loss minus the uncompressed "
        f"one's, step by step: {[round(x, 5) for x in gap]}")
    lm_grads = {what: check_lm_train_gradients(c, what, qat=q)
                for what, c, q in (("bf16", lm_bf16[0], None),
                                   ("fp32", lm32, None),
                                   ("bf16, binary='popcount'", lm_pop[0],
                                    None),
                                   ("bf16, qat='int8'", lm_bf16[0], "int8"))}
    if not all(torch.equal(a, b) for a, b in zip(
            lm_grads["bf16, binary='popcount'"], lm_grads["bf16"])):
        raise AssertionError("LM train step with binary='popcount' != with "
                             "'mxu_kernel'")
    log("check: one LM train step with binary='popcount' == with "
        "binary='mxu_kernel' (#7), bitwise: loss and every gradient")
    _, ckpt_s = checkpoint_path()
    # 1000 classes, 32 images a batch: the loss need not fall in 6 steps
    eight_train = train_path(engines8["auto"], batch=EIGHT_BATCH,
                             falls=False)
    check_train_gradients(engines8["auto"])
    log(f"training phases (LM, checkpoints, 8-512): "
        f"{time.perf_counter() - t_new:.1f} s")

    # --- the dense decoder family and the spiking LM's window attention --
    t_dense = time.perf_counter()
    dense = dense_family(smi)
    log(f"dense family phases: {time.perf_counter() - t_dense:.1f} s")

    # --- the MoE family ---------------------------------------------------
    t_moe = time.perf_counter()
    moe = moe_family(smi)
    log(f"MoE family phases: {time.perf_counter() - t_moe:.1f} s")

    # --- the rwkv, hybrid, encdec and vlm families ------------------------
    t_other = time.perf_counter()
    other = other_families(smi)
    log(f"rwkv, hybrid, encdec and vlm phases: "
        f"{time.perf_counter() - t_other:.1f} s")

    # --- the distributed layer: the mesh server and expert parallelism --
    t_dist = time.perf_counter()
    dist_out = distributed_layer(serve_gen, smi)
    log(f"distributed layer phases: {time.perf_counter() - t_dist:.1f} s")
    ep_ranks = dist_out["ep"]["ranks"]

    csrc = "src/repro_torch/kernels/csrc/"
    bf16 = torch.bfloat16

    def at_8_512(timing, counts, name):
        """A kernel's numbers at Spikingformer-8-512's shapes: its time,
        plain time and bound at EIGHT (or SSA_EIGHT's first shape) and its
        launches on the 8-512 path ('tile')."""
        return dict(timing, launches=counts[name])

    rows = [dict(name="fused_layer", source=csrc + "fused_layer.cu",
                 replaces="src/repro/kernels/fused_layer.py:420",
                 launches=eval_counts["tile"]["fused_layer"],
                 max_abs_err=layer_err["tile"],
                 at_calibrate={q: dict(launches=run[1]["fused_layer"],
                                       ms=run[0])
                               for q, run in calib.items()},
                 at_8_512=at_8_512(eight_timing["tile"], eight_counts["tile"],
                                   "fused_layer"),
                 **layer_timing["tile", bf16]),
            dict(name="spike_matmul", source=csrc + "spike_matmul.cu",
                 replaces="src/repro/kernels/spike_matmul.py:128",
                 launches=train_counts["tile"]["spike_matmul"],
                 max_abs_err=matmul_err,
                 at_qat=dict(qat="int8",
                             launches=qat_runs["int8"][0]["spike_matmul"],
                             step_ms=qat_runs["int8"][1]),
                 train_step_ms=train_runs["tile"][1],
                 at_8_512_train=dict(launches=eight_train[0]["spike_matmul"]),
                 analog_request_ms=analog4["tile"][1], **matmul_timing),
            dict(name="spike_matmul_analog", source=csrc + "spike_matmul.cu",
                 replaces="src/repro/kernels/spike_matmul.py:128 (an analog "
                          "left operand: binarize_scores=False's wo)",
                 launches=analog4["tile"][0]["spike_matmul_analog"],
                 max_abs_err=matmul_analog_err,
                 at_train=dict(launches=analog_train_counts[
                     "spike_matmul_analog"], sparse="auto"),
                 **matmul_analog_timing),
            dict(name="spike_attention", source=csrc + "spike_attention.cu",
                 replaces="src/repro/kernels/spike_attention.py:78",
                 launches=train_counts["tile"]["spike_attention"],
                 max_abs_err=attn_err,
                 at_qat=dict(launches={q: run[0]["spike_attention"]
                                       for q, run in qat_runs.items()}),
                 at_calibrate=dict(launches=calib_lm[1]["spike_attention"]),
                 at_lm=attn_lm_timing,
                 at_long=dict(attn_long_timing, shape=LONG_ATTENTION[2][1:5],
                              prompt_ms=long_ms,
                              launches=long_counts["spike_attention"]),
                 at_8_512=dict(attn_8_512_timing, shape=ATTENTION[2]),
                 analog=[dict(t, shape=case) for t, case in
                         zip(attn_analog_timing, ANALOG_ATTENTION)],
                 at_head_dim_160={what: dict(
                     ms=ms, launches=counts["spike_attention"])
                     for what, (ms, counts) in wide.items()},
                 at_lm_train={what: dict(launches=run[0]["spike_attention"],
                                         step_ms=run[1])
                              for what, run in lm_train.items()
                              if what in ("bf16", "qat int8", "compressed")},
                 at_8_512_train=dict(
                     launches=eight_train[0]["spike_attention"],
                     step_ms=eight_train[1]),
                 at_moe=dict(launches=moe["spiking"]["mxu_kernel"][0][
                     "spike_attention"], request_ms=moe["spiking"][
                         "mxu_kernel"][1]),
                 at_ep=dict(mesh=EP_MESH, launches_per_rank=[
                     r["spiking"]["mxu_kernel"]["launches"]["spike_attention"]
                     for r in ep_ranks], request_ms_per_rank=[
                         r["spiking"]["mxu_kernel"]["ms"] for r in ep_ranks]),
                 **attn_timing),
            dict(name="gather_spike_matmul",
                 source=csrc + "gather_spike_matmul.cu",
                 replaces="src/repro/kernels/spike_decode.py:294",
                 launches=train_counts["decoded"]["gather_spike_matmul"],
                 max_abs_err=gather_err,
                 at_qat=dict(qat="int4", launches=qat_runs["int4"][0][
                     "gather_spike_matmul"], step_ms=qat_runs["int4"][1]),
                 staging_launches=train_counts["decoded"]["gather_stage"],
                 split={str(dt): parts for dt, parts in gather_parts.items()},
                 floor_ms=gather_floor_ms(),
                 train_step_ms=train_runs["decoded"][1],
                 at_8_512_train=dict(
                     launches=eight_train[0]["gather_spike_matmul"]),
                 analog_request_ms=analog4["decoded"][1],
                 **gather_timing),
            dict(name="fused_layer_decoded", source=csrc + "fused_layer.cu",
                 replaces="src/repro/kernels/fused_layer.py:420",
                 launches=eval_counts["decoded"]["fused_layer_decoded"],
                 max_abs_err=layer_err["decoded"],
                 at_calibrate={q: dict(launches=run[1][
                     "fused_layer_decoded"]) for q, run in calib.items()},
                 at_8_512=at_8_512(eight_timing["decoded"],
                                   eight_counts["decoded"],
                                   "fused_layer_decoded"),
                 **layer_timing["decoded", bf16]),
            dict(name="fused_layer_rope", source=csrc + "fused_layer.cu",
                 replaces="src/repro/kernels/fused_layer.py:420",
                 launches=lm_counts["fused_layer_rope"], max_abs_err=rope_err,
                 at_calibrate=dict(launches=calib_lm[1]["fused_layer_rope"],
                                   ms=calib_lm[0]),
                 at_long=dict(prompt_ms=long_int8[0], tokens=LONG_PROMPT,
                              launches=long_int8[1]["fused_layer_rope"]),
                 at_lm_train=dict(
                     launches=lm_train["fp32"][0]["fused_layer_rope"],
                     step_ms=lm_train["fp32"][1]),
                 **rope_timing),
            dict(name="quant_spike_matmul", source=csrc + "spike_matmul.cu",
                 replaces="src/repro/kernels/spike_matmul.py:182",
                 launches=mixed_counts["tile"]["quant_spike_matmul"],
                 max_abs_err=quant_err,
                 request_ms=mixed_runs["tile"][1],
                 bf16=quant_timing["tile", torch.bfloat16],
                 **quant_timing["tile", torch.float32]),
            dict(name="quant_gather_spike_matmul",
                 source=csrc + "gather_spike_matmul.cu",
                 replaces="src/repro/kernels/spike_decode.py:392",
                 launches=mixed_counts["decoded"]["quant_gather_spike_matmul"],
                 max_abs_err=quant_err,
                 split=quant_part_ms[torch.float32],
                 staging_launches=mixed_counts["decoded"][
                     "quant_gather_stage"],
                 bf16=dict(quant_timing["decoded", torch.bfloat16],
                           split=quant_part_ms[torch.bfloat16]),
                 **quant_timing["decoded", torch.float32]),
            dict(name="fused_ssa", source=csrc + "fused_layer.cu",
                 replaces="src/repro/kernels/fused_ssa.py:166",
                 launches=mixed_counts["tile"]["fused_ssa"],
                 max_abs_err=ssa_err,
                 at_8_512=at_8_512(ssa_eight_timing, eight_counts["tile"],
                                   "fused_ssa"),
                 **ssa_timing),
            dict(name="fused_ssa_rope", source=csrc + "fused_layer.cu",
                 replaces="src/repro/kernels/fused_ssa.py:166",
                 launches=lm_mixed_counts["fused_ssa_rope"],
                 max_abs_err=rope_ssa_err,
                 at_long=dict(prompt_ms=long_mixed[0], tokens=LONG_PROMPT,
                              launches=long_mixed[1]["fused_ssa_rope"]),
                 **rope_ssa_timing),
            dict(name="popcount_scores",
                 source=csrc + "popcount_attention.cu",
                 replaces="src/repro/kernels/popcount_attention.py:35",
                 launches=pop_train_counts["popcount_scores"],
                 max_abs_err=pop_err,
                 at_8_512=dict(pop_timing["8-512 eval"],
                               launches=pop8_counts["popcount_scores"]),
                 at_lm=dict(pop_timing["bf16 LM"],
                            launches=lm_pop_counts["popcount_scores"]),
                 at_lm_train=dict(
                     launches=lm_train["popcount"][0]["popcount_scores"],
                     step_ms=lm_train["popcount"][1]),
                 at_moe=dict(launches=moe["spiking"]["popcount"][0][
                     "popcount_scores"], request_ms=moe["spiking"][
                         "popcount"][1]),
                 at_ep=dict(mesh=EP_MESH, launches_per_rank=[
                     r["spiking"]["popcount"]["launches"]["popcount_scores"]
                     for r in ep_ranks], request_ms_per_rank=[
                         r["spiking"]["popcount"]["ms"] for r in ep_ranks]),
                 **pop_timing["4-256 train"]),
            dict(name="lif_forward", source=csrc + "lif.cu",
                 replaces="src/repro/kernels/lif.py:38",
                 launches=lif_counts["lif_forward"], max_abs_err=lif_err,
                 at_8_512=lif_timing["8-512 layer input"],
                 **lif_timing["4-256 layer input"]),
            dict(name="fused_layer_pipeline", source=csrc + "fused_layer.cu",
                 replaces="src/repro/kernels/fused_layer.py:420 "
                          "(pipeline=True)",
                 launches=pipe_counts["tile"][0]["fused_layer_pipeline"],
                 max_abs_err=pipe_err,
                 at_8_512=at_8_512(pipe_eight_timing, pipe8[0],
                                   "fused_layer_pipeline"),
                 at_lm=dict(launches=pipe_lm[0]["fused_layer_pipeline_rope"]),
                 **pipe_timing)]
    ssa_src = "src/repro/kernels/fused_ssa.py:166 (binarize_scores=False)"
    layer_src = "src/repro/kernels/fused_layer.py:420 (binarize_scores=False)"
    rows += [
        dict(name="fused_ssa_analog", source=csrc + "fused_layer.cu",
             replaces=ssa_src,
             launches=analog4["tile"][0]["fused_ssa_analog"],
             max_abs_err=analog_err["ssa"],
             at_8_512=dict(analog_timing["ssa_8_512"],
                           launches=analog8[0]["fused_ssa_analog"]),
             **analog_timing["ssa"]),
        dict(name="fused_ssa_rope_analog", source=csrc + "fused_layer.cu",
             replaces=ssa_src,
             launches=analog_lm_counts["fused_ssa_rope_analog"],
             max_abs_err=analog_err["ssa_rope"], **analog_timing["ssa_rope"]),
        dict(name="fused_layer_analog", source=csrc + "fused_layer.cu",
             replaces=layer_src, launches=api_counts["fused_layer_analog"],
             max_abs_err=analog_err["tile"],
             at_8_512=analog_timing["tile_8_512"], **analog_timing["tile"]),
        dict(name="fused_layer_decoded_analog",
             source=csrc + "fused_layer.cu", replaces=layer_src,
             launches=api_counts["fused_layer_decoded_analog"],
             max_abs_err=analog_err["decoded"],
             at_8_512=analog_timing["decoded_8_512"],
             **analog_timing["decoded"]),
        dict(name="fused_layer_rope_analog", source=csrc + "fused_layer.cu",
             replaces=layer_src,
             launches=api_counts["fused_layer_rope_analog"],
             max_abs_err=analog_err["rope"], **analog_timing["rope"]),
        dict(name="fused_layer_pipeline_analog",
             source=csrc + "fused_layer.cu",
             replaces=layer_src + " (pipeline=True)",
             launches=api_counts["fused_layer_pipeline_analog"],
             max_abs_err=analog_err["pipeline"],
             at_decoded=dict(launches=api_counts[
                 "fused_layer_pipeline_decoded_analog"]),
             at_lm=dict(launches=api_counts[
                 "fused_layer_pipeline_rope_analog"]),
             **analog_timing["pipeline"])]
    rounded = lambda ms: [round(m, 3) for m in ms]
    log(f"popcount paths: train ms per step {rounded(pop_step_ms)}, 8-512 "
        f"ms per request {rounded(pop8_ms)}, bf16 LM ms per request "
        f"{rounded(lm_pop_ms)}")
    log(f"pipeline paths, ms per request pipelined / fused: 4-256 tile "
        f"{rounded(pipe_counts['tile'][1])} / "
        f"{rounded(pipe_counts['tile'][2])}, decoded "
        f"{rounded(pipe_counts['decoded'][1])} / "
        f"{rounded(pipe_counts['decoded'][2])}; 8-512 "
        f"{rounded(pipe8[1])} / {rounded(pipe8[2])}; int8 LM "
        f"{rounded(pipe_lm[1])} / {rounded(pipe_lm[2])}")
    log(f"analog paths, ms per request analog / binarized: 8-512 "
        f"{rounded(analog8[1])} / {rounded(analog8[2])}; 4-256 tile "
        f"{rounded(analog4['tile'][1])} / {rounded(analog4['tile'][2])}, "
        f"decoded {rounded(analog4['decoded'][1])} / "
        f"{rounded(analog4['decoded'][2])}; int8 LM prefill "
        f"{rounded(analog_lm_ms)} / {rounded(lm_ms)}; 4-256 train ms per "
        f"step (analog, sparse='auto') {rounded(analog_step_ms)}, launches "
        f"{ {k: v for k, v in analog_train_counts.items() if v} }")
    log(f"cifarnet: ms per request {rounded(cifar['request_ms'])}, ms per "
        f"step {rounded(cifar['step_ms'])}; qat ms per step: "
        + "; ".join(f"{q} ({sp}) {rounded(qat_runs[q][1])} against fp "
                    f"{rounded(train_runs[sp][1])}" for q, sp in QAT_PATHS)
        + "; calibrate ms: "
        + ", ".join(f"4-256 {q} {run[0]:.3f}" for q, run in calib.items())
        + f", LM int8 {calib_lm[0]:.3f}")
    log("train ms per step beside 4-256's at 64 images ('tile' "
        f"{rounded(train_runs['tile'][1])}): 8-512 at {EIGHT_BATCH} images "
        f"('auto') {rounded(eight_train[1])}; spikingformer-lm at "
        f"{LM_BATCH} x {LM_PROMPT} tokens: "
        + "; ".join(f"{what} {rounded(run[1])}"
                    for what, run in lm_train.items())
        + f"; the checkpointed LM run ({LM_CKPT}) {ckpt_s:.1f} s")
    log("dense family: tokens/s " + "; ".join(
        f"{what} {dense[key]['tokens_per_s']:.1f} ({dense[key]['waves']} "
        f"waves)" for what, key in (("h2o-danube-3-4b", "h2o"),
                                    ("gemma3-12b", "gemma"),
                                    ("nemotron-4-15b", "nemotron-4-15b"),
                                    ("granite-20b", "granite-20b")))
        + f"; h2o int8 {dense['h2o']['int8']['tokens_per_s']:.1f}; "
        f"prefill ms: gemma3-12b {GEMMA_PREFILL} "
        f"{dense['gemma']['prefill_ms']:.3f}, nemotron / granite "
        f"({CUT_LAYERS} layers) {dense['nemotron-4-15b']['prefill_ms']:.3f}"
        f" / {dense['granite-20b']['prefill_ms']:.3f}; h2o train ms per "
        f"step {[round(m, 3) for m in dense['train'][0]]}; spiking window "
        f"LM prefill ms per request: " + "; ".join(
            f"{k} {d} {[round(m, 3) for m in dense[k, d][1]]}"
            for k in WINDOW_LM for d in ("bf16", "int8", "fp32")))
    log("MoE family: " + "; ".join(
        f"{what} prefill ms {[round(m, 3) for m in moe[key]['prefill_ms']]}"
        f", decode {moe[key]['decode_step_ms']:.3f} ms a step, "
        f"{moe[key]['decode_tokens_per_s']:.1f} tokens/s"
        for what, key in ((DEEPSEEK, "deepseek"), (KIMI, "kimi")))
        + f"; fp32 decode vs forward {moe['tight']['ratio']:.2e} of its "
        f"tolerance, dispatch vs mixture {moe['tight']['oracle_ratio']:.2e}; "
        f"spiking prefill ms #7 {moe['spiking']['mxu_kernel'][1]:.3f}, #8 "
        f"{moe['spiking']['popcount'][1]:.3f}; train ms per step "
        f"{[round(m, 3) for m in moe['train']['bf16']['step_ms']]}, qat "
        f"{[round(m, 3) for m in moe['train']['int8']['step_ms']]}, int8 "
        f"request {moe['train']['int8_request_ms']:.3f}")
    log("rwkv, hybrid, encdec and vlm families: " + "; ".join(
        f"{arch} prefill ms "
        f"{[round(m, 3) for m in other[arch]['prefill_ms']]}"
        + (f", decode {other[arch]['decode_step_ms']:.3f} ms a step, "
           f"{other[arch]['decode_tokens_per_s']:.1f} tokens/s"
           if "decode_step_ms" in other[arch] else
           f", server {other[arch]['serve']['tokens_per_s']:.1f} tokens/s")
        + f"; fp32 decode vs forward {other['tight', arch]['ratio']:.2e} of "
        f"its tolerance; train ms per step "
        f"{[round(m, 3) for m in other['train', arch][0]]}"
        for arch in (RWKV, HYMBA, WHISPER, LLAVA)))
    log(f"family phases: {json.dumps(PHASES)}")
    log(json.dumps({"kernels": [dict(route="cuda", **r) for r in rows]}))
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
