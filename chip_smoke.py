#!/usr/bin/env python3
"""Drive deeplearning4j_tpu_torch's main paths on one CUDA card: serving
ResNet-50, training ResNet-50 (ComputationGraph, with and without remat
segments) and training LeNet-5 (MultiLayerNetwork), BERT-base inference
and pretraining (with and without remat), generative serving of a
GPT-2-small-width decoder, serving and training SqueezeNet (dropout on,
a learning-rate schedule, gradient accumulation), the bundled
checkpoints held to their quality gates, training the GravesLSTM
char-RNN (BASELINE config #3), BERT-base imported from a frozen
TensorFlow GraphDef into SameDiff (BASELINE config #4), ResNet-50
through the data-parallel entry points, staged by the device prefetcher
(BASELINE config #5 on one card), a masked attention classifier at
BERT-base widths built from DL4J layers in a ComputationGraph, and a
2 x LSTM(512) character model imported from a frozen TF GraphDef with
its loops (functional While and v1 frames) and trained in SameDiff, and
the frozen Keras ResNet-50 imported, served and fine-tuned in SameDiff
with the seven op domains of slice 18 swept on the card, and the
serving fleet: ResNet-50 and the GPT-2-small-width decoder on two
replicas behind a ServingRouter, with the request observatory, and the
imported Keras ResNet-50 served through the registry, and the
distributed Transformer LM at GPT-2 small's widths trained on four gloo
ranks of the card in its megatron-SP and ring-CP layouts.

Run from the root of a checkout, with no arguments, on a machine with
one NVIDIA H100 (it fails without a card, and without the package):

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1) when its check fails:

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, all at once; prints
   the build times and ``-Xptxas -v``;
3. kernels: the epilogue (kernel 1) against its plain PyTorch version
   (f32, bf16 and f16, relu and identity, a ragged M, a C off the
   vector width, NaN inputs), bitwise, at every BatchNormalization site
   shape of the batch-8 and batch-32 serving buckets; then CUDA-graph
   timings of the kernel, the plain version and the one-call library
   yardstick over the 53 sites of a batch-32 forward, beside the bound;
4. training kernels: the epilogue backward (2), channel sums (3) and
   the BN backward passes (5, 6) against their plain versions at every
   (M, C) site shape of a batch-32 ResNet-50 step and LeNet-5's two
   conv shapes, f32/bf16/f16: elementwise outputs bitwise, sums within
   ``SUM_RTOL`` of sum|terms| per channel, sums bitwise equal across two
   launches; the body (vector width, block, grid) kernels 6 and 5 take
   at each site shape, and one device kernel a site for kernel 5 (the
   profiler over the 53 sites); then their timings over the 53 sites of
   a batch-32 step;
5. serving: a full-width ResNet-50 (224x224x3, 1000 classes, seeded
   random weights, BatchNormalization stats set from the generator)
   registered and served over HTTP, kernel counts reset just before and
   read just after; answers against ``net.output`` at the bucket they
   were served at (bitwise) and the card against the CPU (TF32 off);
   one bf16 and one f16 forward;
6. train ResNet-50: 224x224x3, 1000 classes, batch 32, f32, the zoo's
   Nesterovs(0.1, 0.9) and l2 1e-4, seeded weights, 10 ``fit`` steps on
   one seeded batch (8 classes, each a fixed random image plus noise)
   with the counts reset before and read after (53 launches each of
   kernels 3, 1, 5 and 6 a step, none of 2); the last loss below the
   first (10 steps, not 5: from its initial loss of ~11 this
   configuration overshoots for its first three to five steps and
   settles below its first loss by step 10); step time, img/s and the
   device's busy/idle share; four steps with the fused BN backward
   killed (kernel 2, and kernel 1 twice a site); one step with
   ``remat_segments=4`` against the same step without, on copies: the
   same loss, parameters and running statistics (the first forward's)
   norm-wise, kernels 3 and 1 once more for each BatchNormalization in
   the three checkpointed segments, the peak memory lower; two in bf16;
   card against CPU (and a float64 CPU step) for one step at 64x64, TF32
   off;
7. train LeNet-5: 28x28x1, batch 64, Adam(1e-3), 20 steps through
   ``fit(iterator)`` on the synthetic MNIST surrogate; the loss falls,
   kernels 1 and 2 launch twice a step;
8. weights across: the bundled ``resnet_cifar.zip`` (the port's copy
   of the JAX package's) restored on the card and on the CPU, outputs
   compared;
9. flash kernels: the attention forward (7), dq (8) and dk/dv (9)
   against their plain versions at BERT-base's sites (batch 32, 12
   heads of 64; t=128 with padded key masks and one fully masked
   sequence, t=512), two causal cases (t=256, and t=512 with padded
   masks), an odd one (t=200, d=32) and two causal ones with padded
   masks over several tiles (tq=200 > tk=130 at d=64; t=190 at d=96),
   and the attention layers' few queries (tq = 1 and 4 against 128 keys,
   ragged masks with one fully masked sequence), f32, bf16 and f16;
   past d = 256 (d = 768, an unprojected attention layer's head, and a
   causal d = 300) in those and f64, and f64 at a BERT-base site (the
   wide bodies): within the reference's bars (f64: 1e-10), bitwise
   across two launches, fully masked rows exactly 0, no NaN; then each
   kernel's time over the 12 sites of a step (CUDA-graph replay) in
   each dtype, over 12 sites at tq = 1 and 4, and over 12 sites of head
   dim 768 (f32, bf16, f64), beside its bound, its plain version and
   one library call (``F.scaled_dot_product_attention`` for 7;
   ``_scaled_dot_product_efficient_attention_backward``, which computes
   8 and 9 together, for the pair);
10. BERT serving: full-width BERT-base (seeded weights) at batch 32,
    ``Bert.output`` and ``BertForSequenceClassification.predict`` at
    t=128 with padded masks and ``Bert.output`` at t=512, counts reset
    before and read after (12 launches of kernel 7 a forward, none of 8
    or 9); padding isolated bitwise; ms a forward, sequences/s, the idle
    share and kernel 7's share of the busy time; bf16 ``compute_dtype``
    forwards at t=128 and t=512, timed and profiled the same way;
11. BERT pretraining: batch 32, t=128, 20 predictions a sequence, NSP,
    hidden dropout 0.1, attention dropout 0, Adam(1e-4), 10 ``fit_batch``
    steps on one seeded batch (12 launches each of kernels 7, 8, 9 a
    step; the loss falls), the same 10 steps from the same weights
    with ``compute_dtype="bfloat16"`` (the same checks), each step timed
    and profiled with kernels 8 + 9's share of the busy time, then 3
    classifier fine-tuning steps; then ``remat`` False, True and "dots"
    from the same weights, batch and step keys (Sgd(0.05), 3 steps
    each): kernel 7 twice a layer a step with remat (its forward
    recomputed), 8 and 9 once, the losses and updates equal to False's
    (bitwise or within ``REMAT_RTOL``), "dots" no more matrix products
    than False and True 6 a layer more (a dispatch-mode count), True's
    peak memory below False's; card against CPU at 2 layers (forward,
    and one SGD step norm-wise against a float64 step);
12. paged kernel: paged decode attention (kernel 10) against its plain
    version at GPT-2-small's decode sites (batch 8 and 32, 12 heads of
    64, blocks of 16, a 64-block table; lengths 1..1024, every partition
    edge of the staged body's cluster split +-1, dead slots, a length
    past the table), an odd shape (h=5, d=80, blocks of 8) and d = 32,
    128, 256, f32, bf16 and f16 pools, the batch-32 sites also on pools
    one element off alignment (the general body): within 2e-5, bitwise
    across two launches, no NaN, the body each takes printed; then its
    time over the 12 sites of a batch-32 decode step at L=512 and 1024
    on each body beside the bytes bound and the plain version;
13. generate: a GPT-2-small-width DecoderLM (openai-community/gpt2's
    widths, seeded weights) registered with a paged KV pool of 1024
    blocks of 16 tokens and served over HTTP to 32 concurrent streaming
    greedy requests (prompts of 16..256 tokens, 64 new tokens each),
    counts reset before the registration and read after the last stream
    (12 launches of kernel 10 a decode step, nothing else); 8 requests
    (the longest prompt among them) against ``reference_decode`` (a
    divergence only at a logged tie), one decode step against the full
    forward, zero retraces, the pool freed; TTFT, inter-token gaps,
    tokens/s, the decode step's time and device profile; then the same
    with a bf16 pool; card against CPU at 2 layers (prefill and a paged
    decode step, TF32 off);
14. pointwise: the matmul with bias and activation (kernel 4) against
    its plain version at every pointwise conv site shape of SqueezeNet's
    batch-8 and batch-32 buckets plus a ragged M, an N off the tile and
    K = 16, f32/bf16/f16, relu and identity, NaN rows: per element
    within ``2e-5 * (sum_k |x_k w_k| + |b|)`` of the plain f32 result
    (plus one ulp of bf16 or f16), bitwise across two launches; the
    body (wgmma + TMA, mma.sync or f32 SIMT, with its tile) each of the
    17 sites takes in each dtype, and the host cost of encoding the
    Hopper body's tensor maps; then its
    time over the 17 sites of a batch-32 forward (CUDA-graph replay)
    beside the bound, the plain version and ``torch._addmm_activation``,
    and one f32 backward through its autograd Function against the
    plain one;
15. squeezenet: a full-width SqueezeNet (224x224x3, 1000 classes,
    seeded weights and biases) registered and served over HTTP as
    ResNet-50 is in phase 5, counts reset before and read after (17
    launches of kernel 4 and 9 of kernel 1 a forward, nothing else);
    answers == ``net.output`` bitwise; card against CPU (TF32 off); a
    bf16 forward; img/s at batch 32 and the device's busy/idle share;
15b. squeezenet training: the same full-width SqueezeNet (seeded, the
    zoo's output layer) trained through ``fit`` at batch 32 with its
    DropoutLayer(0.5) active, masks drawn on the card, the zoo's
    Adam(1e-3), 10 steps on one seeded batch, counts reset before and
    read after (17 launches of kernel 4, 9 of kernel 1 and 9 of kernel 2
    a step, nothing else; the loss falls); the keep share of a step's
    mask within 4 sigma of 0.5; a WarmupSchedule(3,
    ExponentialSchedule(1e-3, 0.9)) run, every rate the updater is asked
    for against the schedule's formula; ``set_accumulation_steps(2)``
    over two batch-16 halves against one batch-32 step (retain 1.0,
    Sgd, TF32 off, within ``ACCUM_RTOL`` norm-wise); ms a step, img/s,
    idle share, device kernels a step and peak memory; card against CPU
    for one Sgd step at 64x64 (retain 1.0, TF32 off, norm-wise against
    a float64 step);
15c. kernel paths: a batch-32 SqueezeNet forward in f32 and in bf16
    (17 launches of kernel 4 each), a batch-32 bf16 ResNet-50 training
    step (53 launches each of kernels 5 and 6 a step) and a batch-32
    GPT-2-small decode step at L=480 with f32 and bf16 pools (12
    launches of kernel 10): ms, device busy time and idle share
    (profiler), the share of busy time in kernel 4, in kernels 5 and 6,
    and in kernel 10;
16. pretrained: ``lenet.zip``, ``resnet_cifar.zip`` and ``charrnn.zip``
    restored onto the card by ``restore_model`` (through the zoo's
    shortcuts) and held to their gates: LeNet-5 >= 0.99 on 2000
    synthetic MNIST test images, ResNet-CIFAR >= 0.90 on 1000 synthetic
    CIFAR test images and its hard split inside ``HARD_GATE``, the
    char-RNN's next-character accuracy within 0.001 of ``meta.json``'s
    on ``scripts/train_pretrained.py``'s windows; counts reset before
    and read after each: kernel 1 twice a LeNet-5 forward and once a
    BatchNormalization site of ResNet-CIFAR, nothing else;
17. char-RNN (BASELINE config #3, ``benchmarks/bench_charrnn.py``'s
    configuration): 2 x GravesLSTM(512, tanh) + RnnOutputLayer(80),
    Adam(5e-3), seed 12345, batch 64 of 64 one-hot timesteps from
    ``RandomState(0)``; 20 ``fit`` steps in f32 and in bf16
    ``compute_dtype`` (the loss falls; no ported kernel launches; step
    ms, chars/s, device busy/idle share and device kernels a step);
    ``fit_steps``; a TRUNCATED_BPTT copy (segments of 32: 2 iterations
    a batch, its first segment's outputs within 1e-5 of the STANDARD
    forward's first 32 steps); ``rnn_time_step`` over the 64 steps
    against ``output`` (1e-5, f32); 64 greedy characters at batch 64
    through ``rnn_time_step`` (chars/s; the choices equal the
    whole-sequence forward's but at ties); one f32 step at H=64 card
    against CPU (matmul TF32 off), with ``train_card_vs_cpu``'s bars;
18. SameDiff BERT (BASELINE config #4): the frozen BERT-base GraphDef
    (L=12, H=768, A=12, vocab 30522; batch 32, t=128, seed 0) written
    without TensorFlow by ``modelimport/tensorflow/bert_graph.py``,
    imported onto the card with the GraphOptimizer (12 attention
    fusions, 24 LayerNorm and 12 GELU re-fusions, no softmax left on
    the output's walk); ``SameDiff.output`` with padded key masks (12
    launches of kernel 7 a forward, nothing else), within
    ``SD_FWD_RTOL`` / ``SD_FWD_ATOL`` of the same bytes imported with
    ``optimize=False`` (TF32 off); ms a forward, idle share, kernel 7's
    share of busy; the weight-tied MLM head (32 gathered predictions,
    Adam(5e-4)): 10 ``fit_steps`` in f32 then bf16 (12 launches each of
    kernels 7, 8, 9 a step; the loss falls), ms a step, tokens/s, idle
    share, beside the native ``Bert``'s forward and step from phases 10
    and 11; the trained graph saved and restored by ``restore_model``
    (output bitwise equal); card against CPU at 2 layers and batch 2
    (forward, and one SGD step norm-wise against a float64 step).

19. data-parallel ResNet-50 (BASELINE #5 on one card): the seeded
    ResNet-50 of phase 6 (224x224x3, 1000 classes, Nesterovs(0.1, 0.9),
    f32, TF32 convolutions) on a ``ListDataSetIterator`` of its batch of
    32: (a) 10 ``fit(iterator)`` steps with the device prefetcher on and
    then off (``DL4J_TORCH_DEVICE_PREFETCH``), parameters and running
    statistics bitwise equal, 53 launches each of kernels 3, 1, 5 and 6
    a step, ms a step, the idle share and the share of the
    host-to-device copies' time that overlaps compute (profiler);
    (b) ``ParallelWrapper`` with one worker on the card: the exchange
    resolves to dense, the run bitwise equal to (a), the same launches;
    (c) ``SharedTrainingMaster`` over two processes on this card in a
    gloo group (16 rows each, the exchange ``auto``, which resolves to
    ZeRO-1 sharded), 3 steps, at 224x224 and at 64x64, TF32 off:
    after step 1 each rank's update within ``UPDATE_FACTOR`` x the
    one-process batch-32 step's distance from a float64 CPU step (+
    ``UPDATE_FLOOR``), its loss within ``LOSS_RTOL`` and its running
    statistics within ``STATE_RTOL`` of the one-process step's (one f32
    step of this net is ill-conditioned: two f32 routes of it differ by
    about 2e-2 of its update in norm, so the parameters are held
    against float64, not elementwise); each rank holding half of the
    padded flat updater state; 53 launches of each kernel a step on each
    rank; the ranks bitwise equal after 3 steps (gloo stages through the
    host: its step time is no DP rate); (d) a
    one-rank NCCL group through ``SharedTrainingMaster``, 10 steps,
    bitwise equal to (b), ms a step and img/s; in the two rank processes
    of (c), on the same weights and rows at 224x224 (TF32 off; the rank
    processes run the deterministic algorithms, so that (f) can be held
    bit for bit to (c)), 3 steps each of (e) the encoded exchange, once per scheme (threshold with
    ``threshold_algorithm(AdaptiveThresholdAlgorithm())``, int8, 1-bit)
    and (f) fsdp: the exchange resolved as asked, 53 launches each of
    kernels 3, 1, 5, 6 a step on each rank, the ranks bitwise equal,
    (f) bitwise equal to (c) with half the padded flat parameters and
    (c)'s half of the updater state on each rank, (e) half the residual
    on each; the encoded tail replayed on the two ranks' recorded step-1
    slices of three groups, on the card and on the CPU (threshold and
    int8 bitwise, 1-bit within ``ONEBIT_RTOL``; the ranks' outputs equal
    the replay; ``residual + decoded`` within an f32 ulp of the
    corrected gradient (or of the decoded value, where larger) where the
    step-1 clip left it); τ replayed on
    the host from the recorded fractions; the transmitted fraction and
    τ of each step, resident bytes, the analytic exchange bytes of the
    three schemes and three modes, step ms (gloo, host-staged: no DP
    rate).
20. attention graph: (a) a masked text classifier at BERT-base widths
    built with ``GraphBuilder`` (seeded): tokens [32, 128] ->
    EmbeddingSequenceLayer(30522 -> 768) -> 2 x (SelfAttentionLayer(768,
    12 heads) + a residual ElementWiseVertex add) ->
    LearnedSelfAttentionLayer(768, 12 heads, 1 query) -> OutputLayer(2)
    behind an RnnToFeedForwardPreProcessor, 30.5 M parameters; features
    masks from lengths in [16, 128] (one of 128, one of 16); 10 masked
    ``fit`` steps, Adam(1e-3), in f32 and then with bf16
    ``compute_dtype`` from the same weights (3 launches each of kernels
    7, 8 and 9 a step; the loss falls; ms a step, sequences/s, the idle
    share and device kernels a step); ``fit_steps(ds, 10)`` on the
    unmasked batch == 10 ``fit`` calls bit for bit (deterministic
    algorithms on: the embedding's backward accumulates with atomics
    otherwise); ``output(..., mask=)`` against the plain route
    (``flash_attention`` gate 0) within ``ATTN_FWD_RTOL`` /
    ``ATTN_FWD_ATOL``, ``score``, ``evaluate`` and ``predict`` on the
    masked batch, a padded row's answer bitwise independent of its
    padded tokens; one f32 Sgd step at 2 attention layers, batch 2, card
    against CPU (TF32 off), each parameter's update held to
    ``train_card_vs_cpu``'s bars against its own CPU reading; (b)
    RecurrentAttentionLayer(768, 12 heads) over the same embedded batch:
    one masked forward (128 launches of kernel 7), one training step
    (128 each of 7, 8 and 9), its activations and the head's logits
    within ``ATTN_FWD_RTOL`` / ``RATT_ATOL`` of the plain route; (b')
    SelfAttentionLayer(project_input=False) over the batch's 768
    features, a head dim of 768 (the kernels' wide bodies): one masked
    forward and backward, one launch of each kernel, output and input
    gradient against the plain route; (c) the char-RNN of phase 17 as a ComputationGraph with
    TRUNCATED_BPTT segments of 16 (4 iterations a batch), within
    ``GRAPH_MLN_ATOL`` of the layer stack of the same configuration and
    weights, and ``rnn_time_step`` over its 64 steps against ``output``
    (1e-5).
21. TF-imported LSTM: ``lstm_lm``, 2 x LSTM(512) + a head to 80
    characters (phase 17's widths; batch 64 x 64, weights from
    ``lstm_graph.lstm_weights(80, 512, 0)``, the batch from
    ``charrnn_batch``), written as TF's frozen GraphDef by
    ``modelimport/tensorflow/lstm_graph.py`` in both export forms and
    imported with ``run_import(..., while_max_iterations=64,
    device=None)``, TF32 off: (a) the functional form's logits within
    ``TF_LSTM_FWD`` (max |d| / max |ref|) of two ``lstm_layer`` ops and
    the head, and of the same import on the CPU; (b) the v1 form
    deframed to the same op list (its Exit identities aside) and the
    same logits bit for bit; (c) 10 Adam(5e-3) ``fit_steps`` on the
    attached softmax cross-entropy (the loss falls; no kernel of
    ``csrc/`` launches), steps 1-3 with every weight's gradient within
    ``TF_LSTM_GRAD`` of the ``lstm_layer`` route's (stepped alongside);
    (d) ``sd.while_loop`` (bounded, a list written a trip), ``sd.scan``
    and ``sd.cond`` over both (each branch nesting one) around
    ``lstm_cell`` give (a)'s logits; (e) the import without a bound
    serves the forward (130 host reads) and a gradient through it
    raises; (f) forward and step ms, host reads a step (0), device
    kernels and the idle share (profiler), peak memory of a step beside
    the ``lstm_layer`` route's and the masked loops' list storage.
22. TF-imported ResNet-50: the frozen Keras ``ResNet50`` (224x224x3,
    1000 classes, batch 32, 25.6 M parameters, weights from
    ``resnet_graph.resnet50_weights(1000, 0)``) written without
    TensorFlow by ``modelimport/tensorflow/resnet_graph.py``, imported
    with ``run_import(device=None)``, TF32 off for cuBLAS and cuDNN:
    served (probabilities finite, rows summing to 1), against the same
    bytes imported on the CPU in float64 (``TF_RESNET_RTOL`` in norm),
    bitwise repeatable under the deterministic algorithms, its 214
    promoted weights' gradients against float64 at the card's own ReLU
    and max-pool choices, 10 Adam(1e-3) ``fit_steps`` (the loss falls; no
    kernel of ``csrc/`` launches); the 60 ops of the linalg, bitwise,
    segment, convolution, image, random and compression domains and the
    31 methods of ``sd.cnn`` / ``sd.image`` / ``sd.bitwise`` /
    ``sd.linalg`` / ``sd.random`` on the card against the CPU (the
    random ops by their bits for one key and their moments over 10^6
    draws); forward and step ms, device kernels, the idle share and peak
    memory.

23. fleet: ``ServingRouter(n_replicas=2)`` on the card, each replica its
    own registry, admission controller and server, a ``latency_slo_ms``
    on version 2 of (b) and on the decoder of (c): (a) full-width
    ResNet-50 (phase 5's seeded
    weights, buckets 8 and 32) rolled out from a zero-argument factory,
    64 concurrent ``:predict`` requests through the router (16 JSON
    single images, 48 npy batches of 1..8), every answer ``net.output``
    at a bucket bit for bit, both replicas serving, no retrace, 53
    launches of kernel 1 a forward of either replica (counts reset
    before the rollout, read after the last answer); single-image latency
    through the router and direct, img/s of a burst of 32; (b) a second
    version (another seed) rolled out while two clients send: no request
    fails, each answer bitwise version 1's or 2's, then only version 2's,
    ``dl4j_serving_rollouts_total`` one more, 53 launches a forward;
    (c) phase 13's decoder rolled out on both replicas, 32 streaming greedy
    requests through the router, the same 32 direct to one replica and
    the same 32 direct, half to each replica (12 launches of kernel 10 a
    decode step of either engine; 8 routed streams against
    ``reference_decode``; each stream's first chunk at the client before
    its replica emitted the last token); TTFT and inter-token gaps of
    each load; (d) a client's trace id echoed
    by the router and by a replica, one connected span tree a trace id
    in the exported chrome trace (``request``, ``req.route``,
    ``req.admit``, ``req.queue``, ``req.batch_wait``, ``req.device``,
    ``req.serialize``; ``req.ttft``, ``req.inter_token`` and
    ``req.stream`` for a generate), ``GET /api/slo`` on the router and a
    replica reporting both models, ``POST /api/reqrec/dump`` holding one
    record a request completed in the phase, the access log sampled at
    0.5 keeping one line in two, each with its trace id; (e) the server
    of the replica a lone client reaches stopped while it sends: every
    request answered (rerouted), ``/v1/replicas`` showing it out of
    rotation;
    (f) phase 22's imported graph through ``ModelRegistry.register(...,
    input_name="x")`` over HTTP at 1 and 32 images, bitwise equal to
    ``sd.output`` of the same padded batch (deterministic algorithms, TF32
    off; no kernel of ``csrc/``).

Phase 24 (``phase_sd_rest``) finishes SameDiff on BASELINE #4's
imported BERT-base (``SD_BERT``, batch 32, t=128, Adam(5e-4)): (a)
``fit_steps(mesh=)`` on two gloo ranks (one process each, 16 rows each)
under the dense, fsdp and encoded (threshold) exchanges, 3 steps each,
on a batch whose ignored MLM labels differ by shard, then a one-rank
NCCL group: 12 launches of kernels 7-9 a step on each rank, the ranks
bitwise equal, step 1's loss the one-process global loss within 1e-5,
the dense and fsdp step-1 updates held against a float64 step as
``_hold_rank`` holds phase 19's, the NCCL rank bitwise the one-process
``fit_steps``; ms a step and bytes a rank by exchange; (b) the forward
exported (``to_stablehlo``: 12 calls of ``dl4j::flash_fwd``, no
softmax; ``export_serialized`` / ``deserialize_and_call``: 12 launches
of kernel 7, equal to ``output``; a dropout program reseeded per call
equal to the walk's ``RngKey(s)``); (c) an attention ``SameDiffLayer``
in a ComputationGraph trained 10 steps (one launch of kernels 7-9 a
step, the loss falls, a step within the card-vs-CPU bars, the zip
round trip bitwise).

Phase 26 (``phase_transformer_lm``): ``DistributedTransformerLM`` at
GPT-2 small's widths (d_model 768, 12 heads, d_ff 3072, 12 blocks, vocab
50304, f32, TF32 off; a batch of 8 x 1024 random ids from the seed) on
four gloo rank processes of the card, one ``ProcessGroupMesh`` world laid
out twice (``with_axes``): (a) megatron-SP, ``{data: 1, pipe: 2, model:
2}``, 6 blocks a stage, 4 microbatches, dense MLPs; (b) ring-CP,
``{data: 2, pipe: 1, seq: 2, model: 1}``, 2 microbatches, 8 experts
(top-2, no token dropped, the aux loss at the JAX model's weight 0.01)
on block 11. Three Sgd(0.1) ``train_step``s each: every loss within
``LM_LOSS_RTOL`` of the float64 plain single-process forward over the
ranks' gathered global parameters at that step, steps 1 and 2's
gradients leaf by leaf within ``LM_GRAD_RTOL`` (norm-wise) of that
reference's, the loss falls, and kernels 7, 8 and 9 launch 12 x 2 x
(seq index + 1) times a rank a step in (b) and never in (a); then one
ring step's ``flash_attention_with_lse`` ([2, 12, 512, 64], f32, both
``causal``) against its plain version with a non-zero LSE cotangent;
each layout's ms a step a rank.

After phase 24, ``ticket_pool_check``: kernels 3 and 5 captured into
CUDA graphs that take 1.5 x their ticket pool, each graph destroyed
after it, then launched eagerly and under a new graph to the same bits.

Then one JSON line of kernel records (each kernel's times from its own
timing phase, its launches from the path that carries it), the
``nvidia-smi`` line, and the last line ``{"ok": true, "device": {...}}``.

TF32: the served and trained paths run with PyTorch's defaults (cuDNN
convolutions in TF32, matmuls in full f32: BERT's matmuls run in full
f32, and the run prints the precision); each comparison states its
setting.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
#: H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BATCH = 32
PRETRAINED = ROOT / "deeplearning4j_tpu_torch" / "models" / "pretrained"
CIFAR_ZIP = PRETRAINED / "resnet_cifar.zip"

class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {name} count={count}")
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return {"kind": name, "count": count, "nvidia_smi": smi}


def phase_build() -> None:
    """One nvcc for each source, all started together."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    names = sorted(src.stem for src in cuda_build.CSRC_DIR.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.build, names))
    secs = time.perf_counter() - t0
    info = cuda_build.build_info
    print(f"[build] {len(info)} source(s) in {secs:.2f}s")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.2f}s -> {rec['path']}")
        print(rec["log"])


def _time_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph and replayed back to back, so the host's launch overhead
    leaves no gaps between the kernels (``_time_ms`` keeps them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def bn_sites(conf, batch: int):
    """(M, C, act) of every BatchNormalization site of a forward."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    types = conf.resolve_shapes()
    sites = []
    for name in conf.topo_order():
        v = conf.vertices[name]
        if isinstance(v.content, BatchNormalization):
            t = types[name]
            sites.append((batch * t.height * t.width, t.channels,
                          v.content.activation.value))
    return sites


DTYPES = ("float32", "bfloat16", "float16")


def _compare(torch, ce, x, s, b, act: str, what: str) -> float:
    """Kernel against plain version on the same inputs, bitwise: both
    round the multiply, then the add, in f32, and round to x's dtype the
    same way; NaN in the same places. Returns max |kernel - plain|."""
    y = ce.scale_shift_act(x, s, b, act)
    r = ce.scale_shift_act_plain(x, s, b, act)
    torch.cuda.synchronize()
    same_nan = torch.equal(torch.isnan(y), torch.isnan(r))
    err = float((y.float() - r.float()).abs().nan_to_num(0.0).max())
    check(y.dtype == x.dtype and same_nan and err == 0.0,
          f"scale_shift_act {what}: max err {err}, NaN positions equal: "
          f"{same_nan}")
    return err


def phase_kernels(torch) -> dict:
    """Kernel against plain version, then timings at the slice's
    shapes. Tolerance: bitwise (max |kernel - plain| == 0)."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    g = torch.Generator(device="cuda").manual_seed(11)
    max_err = 0.0
    shapes = [(401408, 64), (100352, 256), (1568, 2048), (100353, 64),
              (12345, 6)]
    for M, C in shapes:
        for dt in DTYPES:
            for act in ("relu", "identity"):
                x = torch.randn(M, C, device="cuda", generator=g).to(
                    getattr(torch, dt))
                x.view(-1)[::9973] = float("nan")
                s = torch.randn(C, device="cuda", generator=g)
                b = torch.randn(C, device="cuda", generator=g)
                max_err = max(max_err, _compare(
                    torch, ce, x, s, b, act, f"[{M},{C}] {dt} {act}"))
    print(f"[kernels] scale_shift_act == plain (bitwise) at "
          f"{len(shapes)} shapes x {'/'.join(DTYPES)} x relu/identity, "
          f"NaN propagated; max_abs_err {max_err}")

    # every site shape of the batch-8 bucket (the batch-32 ones are
    # compared in the timing loop below, on the buffers it times)
    conf = ResNet50().conf()
    sites8 = sorted(set(bn_sites(conf, 8)))
    for M, C, act in sites8:
        for dt in DTYPES:
            x = torch.randn(M, C, device="cuda", generator=g).to(
                getattr(torch, dt))
            s = torch.rand(C, device="cuda", generator=g) + 0.5
            b = torch.randn(C, device="cuda", generator=g)
            max_err = max(max_err, _compare(
                torch, ce, x, s, b, act, f"batch-8 site [{M},{C}] {dt} "
                                         f"{act}"))
    print(f"[kernels] scale_shift_act == plain (bitwise) at the "
          f"{len(sites8)} (M, C, act) site shapes of a batch-8 forward, "
          f"{'/'.join(DTYPES)}")

    # timings over the 53 sites of a batch-32 forward, grouped by shape;
    # each shape cycles through enough buffers to exceed the 50 MB L2
    sites = bn_sites(conf, BATCH)
    check(len(sites) == 53, f"ResNet-50 has {len(sites)} BN sites, "
                            f"expected 53")
    groups: dict = {}
    for site in sites:
        groups[site] = groups.get(site, 0) + 1
    timing = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        esize = torch.tensor([], dtype=dt).element_size()
        tot = {"kernel": 0.0, "plain": 0.0, "library": 0.0,
               "kernel_eager": 0.0}
        bytes_moved = 0
        flops = 0
        per_shape = []
        for (M, C, act), n in sorted(groups.items()):
            n_buf = max(1, int(-(-100e6 // (M * C * esize))))
            xs = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(n_buf)]
            s = torch.rand(C, device="cuda", generator=g) + 0.5
            b = torch.randn(C, device="cuda", generator=g)
            s_l, b_l = s.to(dt), b.to(dt)
            max_err = max(max_err, _compare(
                torch, ce, xs[0], s, b, act, f"batch-{BATCH} site "
                                             f"[{M},{C}] {dt} {act}"))
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % n_buf
                return xs[it["i"]]
            def kern():
                return ce.scale_shift_act(nxt(), s, b, act)

            def plain():
                return ce.scale_shift_act_plain(nxt(), s, b, act)

            def lib():
                return torch.addcmul(b_l, nxt(), s_l)
            k_ms, p_ms, l_ms = (_graph_ms(torch, f)
                                for f in (kern, plain, lib))
            host_ms = _time_ms(torch, kern)
            site_bytes = M * C * esize * 2 + 2 * C * 4
            tot["kernel"] += n * k_ms
            tot["plain"] += n * p_ms
            tot["library"] += n * l_ms
            tot["kernel_eager"] += n * host_ms
            bytes_moved += n * site_bytes
            flops += n * 2 * M * C
            bound = site_bytes / HBM_BYTES_PER_S * 1e3
            per_shape.append({"M": M, "C": C, "act": act, "sites": n,
                              "kernel_ms": k_ms, "plain_ms": p_ms,
                              "addcmul_ms": l_ms, "eager_ms": host_ms,
                              "bound_ms": bound,
                              "achieved_GBps": site_bytes / k_ms / 1e6})
            del xs
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                       flops / F32_FLOPS) * 1e3
        timing[str(dt).split(".")[-1]] = {
            "kernel_ms": tot["kernel"], "plain_ms": tot["plain"],
            "library_ms": tot["library"], "bound_ms": bound_ms,
            "kernel_eager_ms": tot["kernel_eager"],
            "bytes": bytes_moved, "flops": flops, "per_shape": per_shape}
        print(f"[kernels] {dt} batch-{BATCH} forward, 53 sites: kernel "
              f"{tot['kernel']:.4f} ms, plain {tot['plain']:.4f} ms, "
              f"addcmul {tot['library']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bytes_moved / 1e9:.3f} GB); device time (CUDA graph "
              f"replay); eager launches {tot['kernel_eager']:.4f} ms")
        for r in per_shape:
            print(f"[kernels]   [{r['M']},{r['C']}] {r['act']} x{r['sites']}"
                  f": kernel {r['kernel_ms']:.4f} plain {r['plain_ms']:.4f}"
                  f" addcmul {r['addcmul_ms']:.4f} eager "
                  f"{r['eager_ms']:.4f} bound "
                  f"{r['bound_ms']:.4f} ms, {r['achieved_GBps']:.0f} GB/s")
    print(f"[kernels] scale_shift_act == plain (bitwise) at the "
          f"{len(groups)} (M, C, act) site shapes of a batch-{BATCH} "
          f"forward, {'/'.join(DTYPES)}; max_abs_err over all {max_err}")
    return {"max_abs_err": max_err, "timing": timing}


# ---------------------------------------------------------------------------
def seeded_resnet(torch, device: str, seed: int = 7, **kw):
    """Full-width ResNet-50 with weights from a seeded generator, and
    BatchNormalization stats set from the same generator around the
    statistics of a calibration batch, so each site folds to a scale and
    shift far from the identity while activations stay O(1)."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    g = torch.Generator().manual_seed(seed)
    net = ResNet50(**kw).init(device, generator=g)
    x = torch.randn(8, net.conf.input_types[0].height,
                    net.conf.input_types[0].width, 3, generator=g)
    acts = {"input": x.to(device)}
    with torch.inference_mode():
        for name in net._topo:
            v = net.conf.vertices[name]
            xs = [acts[i] for i in v.inputs]
            if not v.is_layer:
                acts[name] = v.content.forward(xs)
                continue
            if isinstance(v.content, BatchNormalization):
                h = xs[0].float()
                dims = tuple(range(h.dim() - 1))
                mean, var = h.mean(dims).cpu(), h.var(dims).cpu()
                C = mean.numel()
                p, st = net.params[name], net.states[name]
                p["gamma"] = (1 + 0.2 * torch.randn(C, generator=g)
                              ).to(device)
                p["beta"] = (0.2 * torch.randn(C, generator=g)).to(device)
                st["mean"] = (mean + 0.1 * var.sqrt() * torch.randn(
                    C, generator=g)).to(device)
                st["var"] = (var * (0.5 + torch.rand(C, generator=g))
                             ).to(device)
            acts[name], _ = v.content.forward(
                net.params[name], xs[0], training=False,
                state=net.states[name] or None)
    return net


def _post(url: str, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        data = resp.read()
        code = resp.status
    return code, data, (time.perf_counter() - t0) * 1e3


def _npy(a) -> bytes:
    import numpy as np
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def serve_burst(torch, net, name: str, image: int, device: str,
                tag: str, label: str) -> dict:
    """The main path of a served image model: every kernel count set to
    0, ``net`` registered at buckets (8, 32) and served over HTTP (one
    JSON request, one npy batch of 8, 32 concurrent single requests),
    the counts read just after; then every answer held to
    ``net.output`` bitwise at the bucket it can have been served at."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import telemetry
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.serving import (InferenceServer,
                                                  ModelRegistry)

    rs = np.random.RandomState(3)
    x1 = rs.randn(1, image, image, 3).astype(np.float32)
    x8 = rs.randn(8, image, image, 3).astype(np.float32)
    x32 = rs.randn(32, image, image, 3).astype(np.float32)
    forwards = telemetry.counter("dl4j_inference_forwards_total")
    copies = telemetry.counter("dl4j_conv_layout_copies_total")
    fused = telemetry.counter("dl4j_conv_fused_steps_total")
    sites = ("conv", "conv_matmul", "bn_infer")

    # ---- the main path: counts to 0, register + serve, counts read ----
    fwd0, copies0 = forwards.value(), copies.value()
    sites0 = {s: fused.value(site=s) for s in sites}
    for k in cuda_build.KERNELS.values():
        k.launches = 0
    registry = ModelRegistry(device, default_buckets=(8, 32))
    ver = registry.register(name, net, warmup_shape=(image, image, 3))
    server = InferenceServer(registry).start(port=0)
    url = f"{server.url}/v1/models/{name}:predict"
    lat = {}
    try:
        code, data, lat["json_1"] = _post(
            url, json.dumps({"inputs": x1.tolist()}).encode(),
            "application/json")
        check(code == 200, f"JSON predict returned {code}")
        out1 = np.asarray(json.loads(data)["outputs"], np.float32)
        code, data, lat["npy_8"] = _post(url, _npy(x8),
                                         "application/octet-stream")
        check(code == 200, f"npy predict returned {code}")
        out8 = np.load(io.BytesIO(data))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            futs = [pool.submit(_post, url, _npy(x32[i:i + 1]),
                                "application/octet-stream")
                    for i in range(32)]
            res = [f.result() for f in futs]
        wall32 = time.perf_counter() - t0
        check(all(r[0] == 200 for r in res), "a concurrent predict failed")
        out32 = np.concatenate([np.load(io.BytesIO(r[1])) for r in res])
        lat["concurrent_32_ms"] = [r[2] for r in res]
        try:
            _post(f"{server.url}/v1/models/nope:predict", b"{}",
                  "application/json")
            unknown = 200
        except urllib.error.HTTPError as e:
            unknown = e.code
        check(unknown == 404, f"unknown model returned {unknown}")
    finally:
        launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        n_fwd = forwards.value() - fwd0
        dispatches = {s: fused.value(site=s) - sites0[s] for s in sites}
        retraces = ver.retraces_since_warmup()
        with urllib.request.urlopen(f"{server.url}/metrics") as r:
            metrics_ok = b"dl4j_serving_requests_total" in r.read()
        server.stop()
        registry.shutdown()
    n_copies = copies.value() - copies0
    print(f"[{tag}] main path: {n_fwd} forwards, launches {launches}, "
          f"conv-epilogue dispatches {dispatches}, layout copies "
          f"{n_copies}, retraces_since_warmup {retraces}")
    check(metrics_ok, "/metrics lacks dl4j_serving_requests_total")
    check(retraces == 0, f"retraces_since_warmup = {retraces}")
    c32 = lat["concurrent_32_ms"]
    print(f"[{tag}] latency ms: json_1 {lat['json_1']:.2f}, npy_8 "
          f"{lat['npy_8']:.2f}, 32 concurrent p50 "
          f"{np.percentile(c32, 50):.2f} max {max(c32):.2f}, 32-image wall "
          f"{wall32 * 1e3:.2f} ({32 / wall32:.1f} img/s over HTTP) "
          f"[{label}]")
    print(f"[{tag}] each concurrent request, ms: "
          f"{[round(v, 1) for v in c32]}")

    # ---- answers against net.output, bitwise, at the served bucket ----
    # (same TF32 setting: the default). The batcher pads a flush to its
    # bucket by repeating the last row; a row's answer depends only on
    # the row and the batch shape, so each request is held to
    # net.output at the bucket it can have been served at.
    def ref(x):
        return net.output(x).float().cpu().numpy()

    def bitwise(got, want, what):
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        check(got.shape == want.shape and np.isfinite(got).all()
              and np.array_equal(got, want),
              f"{what}: served answer differs from net.output by {err}")
    bitwise(out1, ref(np.repeat(x1, 8, axis=0))[:1], "json_1 (bucket 8)")
    bitwise(out8, ref(x8), "npy_8 (bucket 8)")
    ref32 = ref(x32)
    ref8 = np.concatenate([ref(x32[i:i + 8]) for i in range(0, 32, 8)])
    at8 = (out32 == ref8).all(-1)
    at32 = (out32 == ref32).all(-1)
    bad = [i for i in range(32) if not (at8[i] or at32[i])]
    check(not bad, f"concurrent_32: rows {bad} match net.output at "
                   f"neither bucket (max |d| vs bucket 32 "
                   f"{float(np.abs(out32 - ref32).max())})")
    # the rows differ from each other, so a row handed to the wrong
    # request would fail the bitwise check above
    pair = np.abs(ref32[:, None, :] - ref32[None, :, :]).max(-1)
    np.fill_diagonal(pair, np.inf)
    check(float(pair.min()) > 0.0,
          f"two of the 32 reference rows agree to {float(pair.min())}")
    print(f"[{tag}] served == net.output bitwise: json_1, npy_8, and all "
          f"32 burst rows ({int(at32.sum())} match bucket 32, "
          f"{int(at8.sum())} bucket 8); rows differ pairwise by >= "
          f"{float(pair.min()):.3e}, {len(set(ref32.argmax(-1)))} distinct "
          f"top-1 in 32")
    check(np.allclose(out32.sum(-1), 1.0, atol=1e-4),
          "softmax rows do not sum to 1")
    return {"latency_ms": lat, "forwards": n_fwd, "launches": launches,
            "dispatches": dispatches, "layout_copies": n_copies,
            "http_img_per_s": 32 / wall32, "x8": x8, "x32": x32}


def card_vs_cpu(torch, net, x, tag: str) -> float:
    """``net.output`` on the card with cuDNN's TF32 off (matmuls are
    full f32 by default) against a CPU copy of the net; rtol 1e-3,
    atol 1e-5 on softmax outputs (sums in other orders)."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = net.output(x).float().cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    cpu_net = ComputationGraph(net.conf).set_params(
        {k: {n: t.cpu() for n, t in sub.items()}
         for k, sub in net.params.items()},
        {k: {n: t.cpu() for n, t in sub.items()}
         for k, sub in net.states.items()}, "cpu")
    cpu = cpu_net.output(x).numpy()
    err = float(np.abs(card - cpu).max())
    check(np.allclose(card, cpu, rtol=1e-3, atol=1e-5),
          f"card vs CPU (TF32 off): max |d| {err}")
    print(f"[{tag}] card == CPU (f32, cuDNN TF32 off, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}), max |d| {err:.3e}, "
          f"top-1 {card.argmax(-1).tolist()}")
    return err


def phase_slice(torch, device: str = "cuda", image: int = 224,
                label: str = "cpu") -> dict:
    """``label`` names the card and its power limit on every timing."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.models.zoo import ResNet50

    kw = {} if image == 224 else {"height": image, "width": image}
    t0 = time.perf_counter()
    net = seeded_resnet(torch, device, **kw)
    print(f"[slice] ResNet-50 {image}x{image}x3 -> 1000, "
          f"{net.num_params()} params on {device}, built in "
          f"{time.perf_counter() - t0:.2f}s")
    result = serve_burst(torch, net, "resnet50", image, device, "slice",
                         label)
    x8, x32 = result.pop("x8"), result.pop("x32")
    launches, n_fwd = result["launches"], result["forwards"]
    if device == "cuda":
        # serving runs the inference forward: of the kernels, only the
        # epilogue is on its path
        check(launches["scale_shift_act"] == 53 * n_fwd,
              f"scale_shift_act launches {launches['scale_shift_act']} "
              f"!= 53 x {n_fwd} forwards")

    # ---- card against CPU, TF32 off ----
    if device == "cuda":
        result["card_vs_cpu_max_abs"] = card_vs_cpu(torch, net, x8[:4],
                                                    "slice")

        # device throughput at batch 32, input resident on the card
        xb = torch.from_numpy(x32).cuda()
        runs = sorted(_time_ms(torch, lambda: net.output(xb), reps=10)
                      for _ in range(3))
        ms = runs[1]
        result["fwd32_f32_ms"] = runs
        print(f"[slice] batch-32 f32 forward {ms:.3f} ms (median of "
              f"{[round(r, 3) for r in runs]}) = {32e3 / ms:.1f} img/s "
              f"(TF32 convs, device-resident input) [{label}]")
        # bf16 and f16: the same weights under compute_dtype
        p32 = net.output(xb).float()
        for cd, short in (("bfloat16", "bf16"), ("float16", "f16")):
            conf16 = ResNet50(compute_dtype=cd).conf()
            net16 = ComputationGraph(conf16).set_params(net.params,
                                                        net.states, device)
            n0 = cuda_build.KERNELS["scale_shift_act"].launches
            p16 = net16.output(xb).float()
            torch.cuda.synchronize()
            check(cuda_build.KERNELS["scale_shift_act"].launches - n0 == 53,
                  f"{short} forward did not run 53 epilogue launches")
            check(bool(torch.isfinite(p16).all()),
                  f"{short} output not finite")
            agree = float((p16.argmax(-1) == p32.argmax(-1)).float().mean())
            d16 = float((p16 - p32).abs().max())
            ms16 = _time_ms(torch, lambda: net16.output(xb), reps=10)
            result.update({f"fwd32_{short}_ms": ms16,
                           f"{short}_top1_agree": agree,
                           f"{short}_max_abs": d16})
            print(f"[slice] batch-32 {short} forward {ms16:.3f} ms = "
                  f"{32e3 / ms16:.1f} img/s; top-1 agreement with f32 "
                  f"{agree:.3f}, max |d prob| {d16:.3e} [{label}]")
            check(agree >= 0.75,
                  f"{short} top-1 agrees with f32 on {agree:.2f}")
        result["profile"] = profile_device(
            torch, lambda: net.output(xb), ms, "batch-32 f32 forward")
    return result


def profile_device(torch, fn, wall_ms: float, what: str,
                   shares=()) -> dict:
    """Device time by kernel over 3 calls of ``fn`` (profiler), and the
    idle share against the unprofiled wall time of one call; ``shares``
    names substrings of kernel names whose share of the busy time is
    reported."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows, scopes = [], {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        if e.key.startswith("dl4j."):
            # a layerprof scope, kept apart from the busy sum (which
            # counts each kernel once): its host row carries the device
            # time of the kernels launched inside it, its device row the
            # span from its first kernel's start to its last one's end
            sc = scopes.setdefault(e.key, {"kernels_ms": 0.0,
                                           "span_ms": 0.0})
            sc["span_ms" if on_device else "kernels_ms"] += dev_us / 3e3
        elif dev_us and on_device:
            rows.append((e.key, dev_us / 3e3, e.count // 3))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if not rows:
        print("[profile] device time: not measured (no CUDA events)")
        return {}
    idle = 1.0 - busy_ms / wall_ms
    print(f"[profile] per {what}: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms, idle share {idle:.3f}")
    for key, ms, n in rows[:12]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<4d} {key[:90]}")
    for key, sc in sorted(scopes.items(),
                          key=lambda kv: -kv[1]["kernels_ms"]):
        print(f"[profile]   scope {key}: kernels {sc['kernels_ms']:.3f} ms"
              f", device span {sc['span_ms']:.3f} ms")
    if scopes:
        scoped = sum(sc["kernels_ms"] for sc in scopes.values())
        print(f"[profile]   outside the scopes (autograd's backward, ...): "
              f"{busy_ms - scoped:.3f} ms")
    share = {}
    for name in shares:
        ms = sum(r[1] for r in rows if name in r[0])
        share[name] = {"ms": ms, "share_of_busy": ms / busy_ms}
        print(f"[profile]   kernels named *{name}*: {ms:.3f} ms, "
              f"{ms / busy_ms:.3f} of busy")
    return {"device_busy_ms": busy_ms, "idle_share": idle,
            "kernel_calls": sum(n for _, _, n in rows),
            "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                    for k, ms, n in rows[:20]], "scopes": scopes,
            "shares": share}


# ---------------------------------------------------------------------------
#: |kernel - plain| <= SUM_RTOL * sum|terms| per channel for the column
#: sums: both add the same f32 terms in different orders; at these
#: shapes the kernel's summation depth is under ~200 additions (worst
#: case 200 * 2^-24 = 1.2e-5 of sum|terms|), and torch's reduction adds
#: its own
SUM_RTOL = 2e-5
LENET_BATCH = 64
#: LeNet-5's two conv-epilogue sites at batch 64: 24x24x20 and 8x8x50
LENET_SITES = [(LENET_BATCH * 24 * 24, 20, "identity"),
               (LENET_BATCH * 8 * 8, 50, "identity")]
TRAIN_KERNELS = ("epilogue_backward", "channel_sums", "bn_bwd_sums",
                 "bn_bwd_dx")


def _sums_err(torch, got, want, terms, what) -> float:
    err = (got - want).abs()
    bound = SUM_RTOL * terms
    check(bool((err <= bound).all()),
          f"{what}: max err {float(err.max()):.3e} beyond "
          f"{SUM_RTOL} x sum|terms|")
    return float(err.max())


def _check_train_kernels(torch, M, C, act, dt, g, errs) -> None:
    """Kernels 2, 3, 5, 6 against their plain versions on one (M, C)."""
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    x = torch.randn(M, C, device="cuda", generator=g).to(dt)
    dy = torch.randn(M, C, device="cuda", generator=g).to(dt)
    s = torch.randn(C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    what = f"[{M},{C}] {str(dt)[6:]} {act}"
    # kernel 2
    dx, ds, dsh = ce.epilogue_backward(x, dy, s, b, act)
    _, ds2, dsh2 = ce.epilogue_backward(x, dy, s, b, act)
    rdx, rds, rdsh = ce.epilogue_backward_plain(x, dy, s, b, act)
    check(torch.equal(dx, rdx), f"epilogue_backward dx {what} not bitwise")
    check(torch.equal(ds, ds2) and torch.equal(dsh, dsh2),
          f"epilogue_backward sums {what} differ across two launches")
    xf, ga = x.float(), dy.float().abs()
    if act == "relu":
        ga = torch.where(xf * s + b > 0, ga, 0.0)
    errs["epilogue_backward"] = max(
        errs["epilogue_backward"],
        _sums_err(torch, dsh, rdsh, ga.sum(0), f"dshift {what}"),
        _sums_err(torch, ds, rds, (ga * xf.abs()).sum(0), f"dscale {what}"))
    # kernel 3
    xs = x + 0.5
    got, again = ce.channel_sums(xs), ce.channel_sums(xs)
    check(torch.equal(got, again),
          f"channel_sums {what} differ across two launches")
    errs["channel_sums"] = max(errs["channel_sums"], _sums_err(
        torch, got, ce.channel_sums_plain(xs),
        ce.channel_sums_plain(xs.abs()), f"channel_sums {what}"))
    # kernels 5 and 6
    mean = 0.1 * torch.randn(C, device="cuda", generator=g)
    rstd = torch.rand(C, device="cuda", generator=g) + 0.5
    sdy, sdyx = bt.bn_bwd_sums(x, dy, mean, rstd)
    sdy2, sdyx2 = bt.bn_bwd_sums(x, dy, mean, rstd)
    check(torch.equal(sdy, sdy2) and torch.equal(sdyx, sdyx2),
          f"bn_bwd_sums {what} differ across two launches")
    rsdy, rsdyx = bt.bn_bwd_sums_plain(x, dy, mean, rstd)
    t_dy, t_dyx = bt.bn_bwd_sums_plain((xf - mean).abs(), dy.abs(),
                                       torch.zeros_like(mean), rstd)
    errs["bn_bwd_sums"] = max(
        errs["bn_bwd_sums"],
        _sums_err(torch, sdy, rsdy, t_dy, f"sum dy {what}"),
        _sums_err(torch, sdyx, rsdyx, t_dyx, f"sum dy*xhat {what}"))
    a, d, e = (torch.randn(C, device="cuda", generator=g) for _ in range(3))
    dx6 = bt.bn_bwd_dx(x, dy, a, d, e)
    check(torch.equal(dx6, bt.bn_bwd_dx_plain(x, dy, a, d, e)),
          f"bn_bwd_dx {what} not bitwise")
    torch.cuda.synchronize()


def _site_costs(name: str, M: int, C: int, esize: int, act: str):
    """(bytes, operations) the function must move and do at one site:
    each input read once, each output written once."""
    n = M * C
    if name == "channel_sums":
        return n * esize + 2 * C * 4, 3 * n
    if name == "epilogue_backward":
        return 3 * n * esize + 4 * C * 4, (7 if act == "relu" else 4) * n
    if name == "bn_bwd_sums":
        return 2 * n * esize + 4 * C * 4, 5 * n
    return 3 * n * esize + 3 * C * 4, 4 * n                 # bn_bwd_dx


def _one_launch_device_kernels(torch, sites, g) -> dict:
    """The device kernels the profiler sees under the wrappers of kernels
    5 (``bn_bwd_sums``) and 3 (``channel_sums``), each over the 53 sites
    of a bf16 step: one a site, none of them the two-launch body's
    partials or finalize kernel."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import bn_train as bt
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    ins = {}
    for M, C, _ in sorted(set(sites)):
        ins[(M, C)] = (
            torch.randn(M, C, device="cuda", generator=g).to(torch.bfloat16),
            torch.randn(M, C, device="cuda", generator=g).to(torch.bfloat16),
            torch.rand(C, device="cuda", generator=g) - 0.5,
            torch.rand(C, device="cuda", generator=g) + 0.5)
    calls = {"bn_bwd_sums": lambda a: bt.bn_bwd_sums(*a),
             "channel_sums": lambda a: ce.channel_sums(a[0])}
    out = {}
    for name, call in calls.items():
        for a in ins.values():
            call(a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for M, C, _ in sites:
                call(ins[(M, C)])
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if "CUDA" in str(getattr(e, "device_type", "")) and e.count:
                kernels[e.key[:100]] = e.count
        launched = sum(kernels.values())
        check(launched == len(sites) and not any(
            "column_finalize" in k or "column_partials" in k
            for k in kernels),
            f"{name} over {len(sites)} sites ran device kernels {kernels}, "
            f"expected one a site and no partials or finalize kernel")
        print(f"[train-kernels] {name} over the {len(sites)} sites of a "
              f"bf16 step: {launched} device kernels ({kernels})")
        out[name] = kernels
    del ins
    return out


#: ``csrc/column_reduce_sm90.cuh``'s ticket pool (``kTicketPool``), per
#: library and device
TICKET_POOL = 1 << 20


def tickets_per_launch(body: str) -> int:
    """The tickets one launch of kernel 3 or 5 takes (the header's
    ``ticket_count``), from the geometry its ``*_body`` names: one a
    (channel tile, group), and one a channel tile over several groups."""
    import re
    m = re.search(r"grid \d+x(\d+) \(chunks of \d+ rows x channel tiles\), "
                  r"(\d+) ticket group", body)
    check(m is not None, f"no ticket geometry in {body!r}")
    ctiles, groups = int(m.group(1)), int(m.group(2))
    return ctiles * (groups + (1 if groups > 1 else 0))


def ticket_pool_check(torch, launches_per_graph: int = 64,
                      share: float = 1.5) -> dict:
    """Kernels 3 and 5 at the ResNet-50 site with the most tickets a
    launch (1568 x 2048, f32) captured into CUDA graphs
    (``launches_per_graph`` launches each), each graph instantiated,
    replayed now and then and destroyed, until the graphs have taken
    ``share`` x ``TICKET_POOL`` tickets: a captured launch's range goes
    back to the pool with its graph, so none fails. Then an eager launch
    and a new graph's replay still give the bits of the first eager
    launch, within ``SUM_RTOL`` x sum|terms| of the plain version."""
    import math

    from deeplearning4j_tpu_torch.ops import bn_train as bt
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    g = torch.Generator(device="cuda").manual_seed(23)
    M, C = 1568, 2048
    x = torch.randn(M, C, device="cuda", generator=g)
    dy = torch.randn(M, C, device="cuda", generator=g)
    mean = 0.1 * torch.randn(C, device="cuda", generator=g)
    rstd = torch.rand(C, device="cuda", generator=g) + 0.5
    kernels = {
        "channel_sums": (lambda: ce.channel_sums(x),
                         ce.channel_sums_body(x)),
        "bn_bwd_sums": (lambda: torch.stack(bt.bn_bwd_sums(x, dy, mean,
                                                           rstd)),
                        bt.bn_bwd_sums_body(x, dy))}
    out = {}
    for name, (call, body) in kernels.items():
        per = tickets_per_launch(body)
        graphs = math.ceil(share * TICKET_POOL / (per * launches_per_graph))
        want = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        for i in range(graphs):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                got = [call() for _ in range(launches_per_graph)]
            if i % 32 == 0:
                graph.replay()
                torch.cuda.synchronize()
                check(all(torch.equal(t, want) for t in got),
                      f"{name}: graph {i}'s replay changed the bits")
            del got
            graph.reset()
        seconds = time.perf_counter() - t0
        eager = call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            replayed = call()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(eager, want) and torch.equal(replayed, want),
              f"{name}: after {graphs} graphs the bits changed")
        if name == "channel_sums":
            _sums_err(torch, eager, ce.channel_sums_plain(x),
                      ce.channel_sums_plain(x.abs()), name)
        else:
            want_p = torch.stack(bt.bn_bwd_sums_plain(x, dy, mean, rstd))
            terms = torch.stack(bt.bn_bwd_sums_plain(
                (x - mean).abs(), dy.abs(), torch.zeros_like(mean), rstd))
            _sums_err(torch, eager, want_p, terms, name)
        out[name] = {"tickets_per_launch": per, "graphs": graphs,
                     "launches_per_graph": launches_per_graph,
                     "tickets_captured": graphs * launches_per_graph * per,
                     "seconds": seconds}
        print(f"[ticket-pool] {name}: {graphs} graphs x "
              f"{launches_per_graph} launches x {per} tickets = "
              f"{out[name]['tickets_captured']} tickets captured, "
              f"instantiated and destroyed ({share} x the pool of "
              f"{TICKET_POOL}) in {seconds:.1f}s; then an eager launch and "
              f"a new graph's replay bitwise equal to the first launch")
    return out


def phase_train_kernels(torch) -> dict:
    """Kernels 2, 3, 5 and 6 against their plain versions at every site
    shape, then timings over the 53 sites of a batch-32 training step."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    g = torch.Generator(device="cuda").manual_seed(13)
    sites = bn_sites(ResNet50().conf(), BATCH)
    check(len(sites) == 53, f"ResNet-50 has {len(sites)} BN sites")
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    shapes = sorted(set(sites)) + LENET_SITES
    for M, C, act in shapes:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            _check_train_kernels(torch, M, C, act, dt, g, errs)
    print(f"[train-kernels] epilogue_backward/channel_sums/bn_bwd_sums/"
          f"bn_bwd_dx == plain at {len(shapes)} (M, C, act) shapes (the "
          f"batch-{BATCH} ResNet-50 step's and LeNet-5's), f32/bf16/f16: "
          f"dx bitwise, sums within {SUM_RTOL} x sum|terms|, sums bitwise "
          f"across two launches; max |kernel - plain| {errs}")

    groups: dict = {}
    for site in sites:
        groups[site] = groups.get(site, 0) + 1
    dx_bodies = {}
    for M, C, _ in sorted(groups):
        row = {}
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.empty(M, C, device="cuda", dtype=dt)
            row[str(dt).split(".")[-1]] = bt.bn_bwd_dx_body(x, x)
        dx_bodies[f"[{M},{C}]"] = row
    print("[train-kernels] bn_bwd_dx bodies at the 9 site shapes (f32 | "
          "bf16 | f16): " + "; ".join(
              f"{k} {r['float32']} | {r['bfloat16']} | {r['float16']}"
              for k, r in dx_bodies.items()))
    sums_bodies = {"bn_bwd_sums": {}, "channel_sums": {}}
    for M, C, _ in sorted(groups):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.empty(M, C, device="cuda", dtype=dt)
            key = f"[{M},{C}] {str(dt)[6:]}"
            sums_bodies["bn_bwd_sums"][key] = bt.bn_bwd_sums_body(x, x)
            sums_bodies["channel_sums"][key] = ce.channel_sums_body(x)
    for name, bodies in sums_bodies.items():
        print(f"[train-kernels] {name} bodies at the 9 site shapes (f32, "
              f"bf16): " + "; ".join(f"{k} {v}" for k, v in bodies.items()))
    sums_kernels = _one_launch_device_kernels(torch, sites, g)
    timing = {k: {} for k in TRAIN_KERNELS}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        esize = torch.tensor([], dtype=dt).element_size()
        short = str(dt).split(".")[-1]
        tot = {k: {"kernel": 0.0, "plain": 0.0, "library": 0.0,
                   "eager": 0.0, "bytes": 0, "ops": 0, "shapes": []}
               for k in TRAIN_KERNELS}
        for (M, C, act), n in sorted(groups.items()):
            n_buf = max(1, int(-(-100e6 // (M * C * esize))))
            xs = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(n_buf)]
            dys = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                   for _ in range(n_buf)]
            v = [torch.rand(C, device="cuda", generator=g) + 0.5
                 for _ in range(3)]
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % n_buf
                return xs[it["i"]], dys[it["i"]]

            def nbb():
                x, dy = nxt()
                return torch.ops.aten.native_batch_norm_backward(
                    dy, x, v[0], None, None, v[1], v[2], True, 1e-5,
                    [True, True, True])

            fns = {
                "channel_sums": (lambda: ce.channel_sums(nxt()[0]),
                                 lambda: ce.channel_sums_plain(nxt()[0]),
                                 lambda: torch.var_mean(nxt()[0], 0,
                                                        correction=0)),
                "epilogue_backward": (
                    lambda: ce.epilogue_backward(*nxt(), v[0], v[1], act),
                    lambda: ce.epilogue_backward_plain(*nxt(), v[0], v[1],
                                                       act),
                    None),
                "bn_bwd_sums": (
                    lambda: bt.bn_bwd_sums(*nxt(), v[1], v[2]),
                    lambda: bt.bn_bwd_sums_plain(*nxt(), v[1], v[2]),
                    nbb),
                "bn_bwd_dx": (
                    lambda: bt.bn_bwd_dx(*nxt(), *v),
                    lambda: bt.bn_bwd_dx_plain(*nxt(), *v),
                    nbb),
            }
            for name, (kern, plain, lib) in fns.items():
                t = tot[name]
                k_ms = _graph_ms(torch, kern)
                t["kernel"] += n * k_ms
                t["plain"] += n * _graph_ms(torch, plain)
                t["eager"] += n * _time_ms(torch, kern)
                if lib is not None and t["library"] is not None:
                    try:
                        t["library"] += n * _graph_ms(torch, lib)
                    except RuntimeError as exc:
                        print(f"[train-kernels] library call for {name} "
                              f"[{M},{C}] {short} failed: {exc}")
                        t["library"] = None
                b_, o_ = _site_costs(name, M, C, esize, act)
                t["bytes"] += n * b_
                t["ops"] += n * o_
                t["shapes"].append(f"[{M},{C}]x{n} {k_ms * 1e3:.1f}us "
                                   f"{b_ / k_ms / 1e6:.0f}GB/s")
            del xs, dys
        for name, t in tot.items():
            bound = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["ops"] / F32_FLOPS) * 1e3
            lib = (t["library"] if name != "epilogue_backward" else None)
            timing[name][short] = {
                "kernel_ms": t["kernel"], "plain_ms": t["plain"],
                "library_ms": lib, "eager_ms": t["eager"],
                "bound_ms": bound, "bytes": t["bytes"],
                "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_PER_S >=
                             t["ops"] / F32_FLOPS else "operations")}
            lib_s = f"{lib:.4f}" if lib is not None else "none"
            print(f"[train-kernels] {name} {short}, 53 sites of a "
                  f"batch-{BATCH} step: kernel {t['kernel']:.4f} ms, "
                  f"plain {t['plain']:.4f} ms, library {lib_s} ms, bound "
                  f"{bound:.4f} ms ({t['bytes'] / 1e9:.3f} GB), eager "
                  f"{t['eager']:.4f} ms")
            print(f"[train-kernels]   per site: {'; '.join(t['shapes'])}")
    return {"max_abs_err": errs, "timing": timing, "dx_bodies": dx_bodies,
            "sums_bodies": sums_bodies, "sums_device_kernels": sums_kernels}


# ---------------------------------------------------------------------------
def _counts():
    from deeplearning4j_tpu_torch.ops import cuda_build
    return {k.name: k.launches for k in cuda_build.KERNELS.values()}


def _zero_counts():
    from deeplearning4j_tpu_torch.ops import cuda_build
    for k in cuda_build.KERNELS.values():
        k.launches = 0


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _timed_steps(torch, net, x, y, n: int):
    """``n`` fit steps; returns (losses, wall ms of each step)."""
    losses, ms = [], []
    for _ in range(n):
        _sync(torch, x.device.type)
        t0 = time.perf_counter()
        net.fit(x, y)
        _sync(torch, x.device.type)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score())
    return losses, ms


def _copy_net(torch, net, conf, device):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return ComputationGraph(conf).set_params(
        {k: {n: t.detach().clone().to(device) for n, t in sub.items()}
         for k, sub in net.params.items()},
        {k: {n: t.clone().to(device) for n, t in sub.items()}
         for k, sub in net.states.items()}, device)


def learnable_batch(torch, g, batch: int, image: int, classes: int = 8):
    """A seeded batch the net can learn: ``classes`` of the 1000 labels,
    each a fixed random NHWC image plus noise at half its scale."""
    templates = torch.randn(classes, image, image, 3, generator=g)
    cls = torch.arange(batch) % classes
    x = templates[cls] + 0.5 * torch.randn(batch, image, image, 3,
                                           generator=g)
    labels = torch.randperm(1000, generator=g)[:classes][cls]
    return x, torch.eye(1000)[labels]


def phase_train_resnet(torch, label: str, device: str = "cuda",
                       image: int = 224, batch: int = BATCH) -> dict:
    """``device="cpu"`` with a small ``image`` and ``batch`` rehearses
    the phase without a card (launch counts, profile and the card-CPU
    comparison are the card's)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    kw = dict(seed=21, height=image, width=image)
    g = torch.Generator().manual_seed(21)
    t0 = time.perf_counter()
    net = ResNet50(**kw).init(device, generator=g)
    x, y = learnable_batch(torch, g, batch, image)
    x, y = x.to(device), y.to(device)
    stem0 = net.states["stem_bn"]["mean"].clone()
    on_card = device == "cuda"
    print(f"[train] ResNet-50 {image}x{image}x3 -> 1000, batch {batch} "
          f"f32 on {device}, "
          f"{net.num_params()} params, updater {net.conf.updater}, l2 "
          f"{net.conf.l2}; built in {time.perf_counter() - t0:.2f}s")

    # ---- the main path: counts to 0, ten fit steps, counts read ----
    steps = 10
    _zero_counts()
    losses, ms = _timed_steps(torch, net, x, y, steps)
    launches = _counts()
    print(f"[train] losses {losses}; step ms {[round(m, 3) for m in ms]}; "
          f"launches {launches}")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {"channel_sums": 53, "scale_shift_act": 53, "bn_bwd_sums": 53,
            "bn_bwd_dx": 53, "epilogue_backward": 0}
    for k, per_step in want.items():
        check(launches[k] == per_step * steps * on_card,
              f"{k}: {launches[k]} launches in {steps} steps, expected "
              f"{per_step} a step")
    moved = float((net.states["stem_bn"]["mean"] - stem0).abs().max())
    check(moved > 0, "running stats did not move")
    step_ms = float(np.median(ms[1:]))
    print(f"[train] batch-{batch} f32 step {step_ms:.3f} ms (median of "
          f"steps 2-{steps}) = {batch * 1e3 / step_ms:.1f} img/s; running "
          f"mean moved by up to {moved:.3e} [{label}]")
    result = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
              "img_per_s": batch * 1e3 / step_ms, "launches": launches}
    if on_card:
        result["profile"] = profile_device(
            torch, lambda: net.fit(x, y), step_ms,
            f"batch-{batch} f32 train step")

    # ---- the fused BN backward killed: kernel 2, kernel 1 twice ----
    off_steps = 4
    os.environ["DL4J_TORCH_FUSED_BN_BWD"] = "0"
    try:
        _zero_counts()
        l_off, ms_off = _timed_steps(torch, net, x, y, off_steps)
        off = _counts()
    finally:
        del os.environ["DL4J_TORCH_FUSED_BN_BWD"]
    per_step = {"channel_sums": 53, "scale_shift_act": 106,
                "epilogue_backward": 53, "bn_bwd_sums": 0, "bn_bwd_dx": 0}
    for k, n in per_step.items():
        check(off[k] == n * off_steps * on_card,
              f"fused_bn_bwd=0: {k} {off[k]} launches in {off_steps} "
              f"steps, expected {n} a step")
    check(all(np.isfinite(l_off)), f"fused_bn_bwd=0 loss {l_off}")
    off_ms = float(np.median(ms_off[1:]))
    print(f"[train] DL4J_TORCH_FUSED_BN_BWD=0: step {off_ms:.3f} ms "
          f"(median of steps 2-{off_steps} of "
          f"{[round(m, 3) for m in ms_off]}; fused backward "
          f"{step_ms:.3f}); launches {off} [{label}]")
    result.update(step_ms_bn_bwd_off=ms_off, launches_bn_bwd_off=off)

    # ---- remat_segments=4: one step against the same step without ----
    result["remat"] = resnet_remat_step(torch, net, kw, x, y, label)

    # ---- one bf16 step on a copy ----
    net16 = _copy_net(torch, net, ResNet50(compute_dtype="bfloat16",
                                           **kw).conf(), device)
    l16, ms16 = _timed_steps(torch, net16, x, y, 2)
    check(all(np.isfinite(l16)), f"bf16 losses {l16}")
    print(f"[train] bf16 compute_dtype: losses {l16}, steps "
          f"{[round(m, 3) for m in ms16]} ms [{label}]")
    result.update(bf16_losses=l16, bf16_step_ms=ms16)
    del net16, net
    if on_card:
        torch.cuda.empty_cache()
        result["card_vs_cpu"] = train_card_vs_cpu(torch)
    return result


def _peak_mb(torch, device: str, fn):
    """``fn()``'s result and the peak device memory (MB) while it ran
    (None on the CPU)."""
    if device != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 20


def resnet_remat_step(torch, net, kw: dict, x, y, label: str) -> dict:
    """One fit step of ``net``'s weights and states with
    ``remat_segments=4`` against the same step without, on copies (fresh
    updater state each): the same loss; parameters norm-wise within
    UPDATE_FLOOR of the plain step's update; the running statistics of
    the first forward (not the recompute's) within STATE_RTOL. The
    recompute launches kernels 3 and 1 once more for every
    BatchNormalization in the three checkpointed segments; 5 and 6 run
    once a site, as without remat."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    device = x.device.type
    on_card = device == "cuda"
    plain = _copy_net(torch, net, ResNet50(**kw).conf(), device)
    seg = _copy_net(torch, net, ResNet50(remat_segments=4, **kw).conf(),
                    device)
    p0 = {k: {n: t.clone() for n, t in sub.items()}
          for k, sub in plain.params.items()}
    out = {}
    for tag, n in (("plain", plain), ("remat", seg)):
        _sync(torch, device)
        _zero_counts()
        t0 = time.perf_counter()
        _, peak = _peak_mb(torch, device, lambda: n.fit(x, y))
        out[tag] = {"loss": n.score(), "launches": _counts(),
                    "first_ms": (time.perf_counter() - t0) * 1e3,
                    "peak_mb": peak}
    wrapped = [name for lo, hi, wrap, _, _ in seg._segments() if wrap
               for name in seg._topo[lo:hi]]
    r = sum(isinstance(seg.conf.vertices[v].content, BatchNormalization)
            for v in wrapped)
    sites = sum(isinstance(v.content, BatchNormalization)
                for v in seg.conf.vertices.values())
    want = {"plain": {"channel_sums": sites, "scale_shift_act": sites,
                      "bn_bwd_sums": sites, "bn_bwd_dx": sites},
            "remat": {"channel_sums": sites + r,
                      "scale_shift_act": sites + r,
                      "bn_bwd_sums": sites, "bn_bwd_dx": sites}}
    for tag, w in want.items():
        got = out[tag]["launches"]
        expect = {k: w.get(k, 0) * on_card for k in got}
        check(got == expect, f"ResNet-50 {tag} step launches {got} != "
                             f"{expect} ({r} BN sites recomputed)")
    check(out["remat"]["loss"] == out["plain"]["loss"],
          f"remat loss {out['remat']['loss']} != {out['plain']['loss']}")
    e_par = 0.0
    for k, sub in p0.items():
        for n_, t0 in sub.items():
            d = (plain.params[k][n_] - t0).double()
            e = float((seg.params[k][n_] - plain.params[k][n_]).double()
                      .norm() / d.norm().clamp_min(1e-30))
            e_par = max(e_par, e if float(d.norm()) > 0 else 0.0)
    e_state = max(float((seg.states[k][n_] - t).double().norm() /
                        t.double().norm().clamp_min(1e-30))
                  for k, sub in plain.states.items()
                  for n_, t in sub.items())
    check(e_par <= UPDATE_FLOOR, f"remat params differ from the plain step "
                                 f"by {e_par:.3e} of its update in norm")
    check(e_state <= STATE_RTOL, f"remat running stats {e_state:.3e}")
    for tag, n in (("plain", plain), ("remat", seg)):
        # a second step each, timed (the first carries one-off costs)
        _, out[tag]["ms"] = _timed_steps(torch, n, x, y, 2)
    if on_card:
        check(out["remat"]["peak_mb"] < out["plain"]["peak_mb"],
              f"remat peak {out['remat']['peak_mb']:.1f} MB not below "
              f"{out['plain']['peak_mb']:.1f} MB")
    print(f"[train] remat_segments=4 ({r} of {sites} BN sites in the 3 "
          f"checkpointed segments): loss {out['remat']['loss']} == plain;"
          f" params within {e_par:.3e} of the plain update in norm, "
          f"running stats {e_state:.3e}; steps "
          f"{[round(out['remat']['first_ms'], 3)] + [round(m, 3) for m in out['remat']['ms']]} ms vs "
          f"{[round(out['plain']['first_ms'], 3)] + [round(m, 3) for m in out['plain']['ms']]} ms "
          f"(three each, after the main path), peak "
          f"{out['remat']['peak_mb']} MB vs "
          f"{out['plain']['peak_mb']} MB; launches "
          f"{out['remat']['launches']} [{label}]")
    out.update(recomputed_bn_sites=r, bn_sites=sites,
               param_err=e_par, state_err=e_state)
    del plain, seg
    return out


#: card against CPU after one step at 64x64 (TF32 off). One float32
#: step of this network is ill-conditioned: its BatchNormalization
#: gamma/beta gradients are sums that cancel, and rounding alone moves
#: a parameter's update by a few percent in norm against the float64
#: step. So the updates are held norm-wise against a float64 step on
#: the CPU: the card's distance from it may be at most UPDATE_FACTOR
#: times the CPU float32 step's own (plus UPDATE_FLOOR). The loss and the
#: running stats are forward quantities and are held directly.
LOSS_RTOL, STATE_RTOL = 1e-5, 1e-3
UPDATE_FACTOR, UPDATE_FLOOR = 2.0, 1e-3


def train_card_vs_cpu(torch, image: int = 64, batch: int = 8,
                      device: str = "cuda") -> dict:
    """One fit step on the card and on the CPU from the same weights,
    the CPU on the card's route (both kernel gates forced: the kernels'
    plain versions) in float32 and in float64. ``device="cpu"``
    rehearses it without a card."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = torch.Generator().manual_seed(23)
    base = ResNet50(height=image, width=image, seed=23).init(
        "cpu", generator=g)
    x, y = learnable_batch(torch, g, batch, image)
    p0 = {k: {n: t.double() for n, t in sub.items()}
          for k, sub in base.params.items()}
    card = _copy_net(torch, base, base.conf, device)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card.fit(x.to(device), y.to(device))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    conf64 = ResNet50(height=image, width=image, seed=23).conf()
    conf64.dtype = "float64"
    cpu64 = ComputationGraph(conf64).set_params(
        {k: {n: t.clone() for n, t in sub.items()} for k, sub in p0.items()},
        {k: {n: t.double() for n, t in sub.items()}
         for k, sub in base.states.items()}, "cpu")
    extra = Environment.get().extra
    saved = {k: extra.get(k) for k in ("fused_conv", "fused_bn_bwd")}
    extra.update(fused_conv="1", fused_bn_bwd="1")
    try:
        base.fit(x, y)
        cpu64.fit(x.double(), y.double())
    finally:
        for k, v in saved.items():
            if v is None:
                extra.pop(k, None)
            else:
                extra[k] = v
    check(abs(card.score() - base.score()) <= LOSS_RTOL * abs(base.score()),
          f"loss card {card.score()} vs cpu {base.score()}")

    def dist(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    e_card = e_cpu = e_pair = 0.0
    for k, sub in p0.items():
        for n, t0 in sub.items():
            d64 = cpu64.params[k][n] - t0
            dcard = card.params[k][n].detach().cpu().double() - t0
            dcpu = base.params[k][n].detach().double() - t0
            e_card = max(e_card, dist(dcard, d64))
            e_cpu = max(e_cpu, dist(dcpu, d64))
            e_pair = max(e_pair, dist(dcard, dcpu))
    check(e_card <= UPDATE_FACTOR * e_cpu + UPDATE_FLOOR,
          f"card updates {e_card:.3e} from the float64 step, the CPU "
          f"float32 step's {e_cpu:.3e}")
    e_state = 0.0
    for k, sub in base.states.items():
        for n, t in sub.items():
            e = dist(card.states[k][n].cpu().double(), t.double())
            e_state = max(e_state, e)
            check(e <= STATE_RTOL, f"running stat {k}/{n}: card vs cpu "
                                   f"{e:.3e} in norm")
    out = {"loss_card": card.score(), "loss_cpu": base.score(),
           "loss_cpu64": cpu64.score(), "update_card_vs_f64": e_card,
           "update_cpu32_vs_f64": e_cpu, "update_card_vs_cpu32": e_pair,
           "states_card_vs_cpu32": e_state}
    print(f"[train] card vs CPU, one step at {image}x{image}, batch {batch}"
          f" (TF32 off; CPU on the card's route): loss {card.score():.7f} "
          f"vs {base.score():.7f} (f64 {cpu64.score():.7f}); worst update "
          f"in norm: card vs f64 {e_card:.3e}, CPU f32 vs f64 {e_cpu:.3e},"
          f" card vs CPU f32 {e_pair:.3e}; running stats {e_state:.3e}")
    return out


def phase_train_lenet(torch, label: str, device: str = "cuda") -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

    class Timed(TrainingListener):
        def __init__(self):
            self.scores, self.ms = [], []
            self.t = time.perf_counter()

        def iteration_done(self, model, iteration, epoch):
            self.scores.append(model.score())     # syncs on the loss
            now = time.perf_counter()
            self.ms.append((now - self.t) * 1e3)
            self.t = now

    steps = 20
    net = LeNet().init(device, generator=torch.Generator().manual_seed(5))
    it = MnistDataSetIterator(LENET_BATCH, num_examples=LENET_BATCH * steps)
    lis = Timed()
    net.set_listeners(lis)
    _zero_counts()
    lis.t = time.perf_counter()
    net.fit(it)
    _sync(torch, device)
    launches = _counts()
    s = lis.scores
    print(f"[lenet] {steps} steps of batch {LENET_BATCH}, Adam(1e-3), "
          f"synthetic MNIST: losses {[round(v, 4) for v in s]}; launches "
          f"{launches}")
    check(all(np.isfinite(s)), "LeNet loss not finite")
    check(np.mean(s[-5:]) < np.mean(s[:5]),
          f"LeNet loss did not fall: first five {s[:5]}, last five "
          f"{s[-5:]}")
    for k in ("scale_shift_act", "epilogue_backward"):
        check(launches[k] == 2 * steps * (device == "cuda"),
              f"LeNet {k}: {launches[k]} launches in {steps} steps, "
              f"expected 2 a step")
    step_ms = float(np.median(lis.ms[1:]))
    print(f"[lenet] step {step_ms:.3f} ms (median of steps 2-{steps}, "
          f"host batches through fit(iterator)) = "
          f"{LENET_BATCH * 1e3 / step_ms:.1f} img/s [{label}]")
    return {"losses": s, "step_ms": lis.ms, "median_step_ms": step_ms,
            "launches": launches}


def phase_weights_across(torch) -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.utils import ModelSerializer
    check(CIFAR_ZIP.exists(), f"{CIFAR_ZIP} missing")
    card = ModelSerializer.restore_model(CIFAR_ZIP, "cuda")
    cpu = ModelSerializer.restore_model(CIFAR_ZIP, "cpu")
    x = np.random.RandomState(5).rand(16, 32, 32, 3).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        a = card.output(x).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    b = cpu.output(x).numpy()
    err = float(np.abs(a - b).max())
    check(np.allclose(a, b, rtol=1e-4, atol=1e-5),
          f"resnet_cifar.zip card vs CPU: max |d| {err}")
    print(f"[weights] resnet_cifar.zip restored on cuda == cpu (TF32 off)"
          f", max |d| {err:.3e}, top-1 {a.argmax(-1)[:8].tolist()}")
    return {"max_abs": err}


# ---------------------------------------------------------------------------
#: the bundled char-RNN's training text (scripts/train_pretrained.py,
#: ``CHARRNN_TEXT``; a CPU test holds this copy equal to it)
CHARRNN_TEXT = ("the quick brown fox jumps over the lazy dog. "
                "pack my box with five dozen liquor jugs. ") * 50


def charrnn_windows(chars: str, seq_len: int = 32):
    """The windows ``scripts/train_pretrained.py`` trains and gates the
    bundled char-RNN on: one-hot ``x`` and next-character ``y``,
    ``[n, seq_len, len(chars)]``."""
    import numpy as np
    idx = {c: i for i, c in enumerate(chars)}
    ids = np.asarray([idx[c] for c in CHARRNN_TEXT], np.int32)
    starts = np.arange(0, len(ids) - seq_len - 1, seq_len)
    eye = np.eye(len(chars), dtype=np.float32)
    return (np.stack([eye[ids[s:s + seq_len]] for s in starts]),
            np.stack([eye[ids[s + 1:s + seq_len + 1]] for s in starts]))


def phase_pretrained(torch, label: str, device: str = "cuda") -> dict:
    """The bundled checkpoints restored onto ``device`` and held to their
    quality gates (``meta.json``, ``models/pretrained_gates.py``), with
    kernel 1's launches counted per restored forward (2 a LeNet-5
    forward, one per BatchNormalization site of ResNet-CIFAR)."""
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.datasets.vision import \
        Cifar10DataSetIterator
    from deeplearning4j_tpu_torch.models import (char_rnn, lenet,
                                                 pretrained_meta,
                                                 resnet_cifar)
    from deeplearning4j_tpu_torch.models.pretrained_gates import (
        HARD_GATE, eval_resnet_cifar_hard)
    on_card = device == "cuda"
    meta = pretrained_meta()
    out = {}

    def counted(fn):
        _sync(torch, device)
        _zero_counts()
        t0 = time.perf_counter()
        value = fn()
        _sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        others = {k: n for k, n in launches.items()
                  if k != "scale_shift_act" and n}
        check(not others, f"kernels off this path launched: {others}")
        return value, launches["scale_shift_act"], ms

    net = lenet(pretrained=True, device=device)
    acc, n, ms = counted(lambda: net.evaluate(MnistDataSetIterator(
        512, train=False, num_examples=2000)).accuracy())
    fwd = 4
    print(f"[pretrained] lenet.zip on {device}: accuracy {acc:.4f} on 2000 "
          f"synthetic MNIST test images (gate 0.99; meta "
          f"{meta['lenet']['accuracy']}), kernel 1 launches {n} in {fwd} "
          f"forwards, {ms:.1f} ms [{label}]")
    check(acc >= 0.99, f"lenet.zip accuracy {acc} < 0.99")
    check(n == 2 * fwd * on_card, f"lenet.zip: {n} kernel 1 launches in "
                                  f"{fwd} forwards, expected 2 each")
    out["lenet"] = {"accuracy": acc, "launches": n, "forwards": fwd}

    net = resnet_cifar(device=device)
    sites = len(bn_sites(net.conf, 1))
    (acc, hard), n, ms = counted(lambda: (
        net.evaluate(Cifar10DataSetIterator(
            512, train=False, num_examples=1000)).accuracy(),
        eval_resnet_cifar_hard(net, n=2000)))
    fwd = 3
    print(f"[pretrained] resnet_cifar.zip on {device}: accuracy {acc:.4f} on "
          f"1000 synthetic CIFAR test images (gate 0.90), hard split "
          f"{hard:.4f} (gate {HARD_GATE}; meta "
          f"{meta['resnet_cifar']['hard_split_accuracy']}), kernel 1 "
          f"launches {n} in {fwd} forwards of {sites} BN sites, {ms:.1f} ms "
          f"[{label}]")
    check(acc >= 0.90, f"resnet_cifar.zip accuracy {acc} < 0.90")
    check(HARD_GATE[0] <= hard < HARD_GATE[1],
          f"resnet_cifar.zip hard split {hard} outside {HARD_GATE}")
    check(n == sites * fwd * on_card,
          f"resnet_cifar.zip: {n} kernel 1 launches in {fwd} forwards, "
          f"expected {sites} each")
    out["resnet_cifar"] = {"accuracy": acc, "hard": hard, "launches": n,
                           "forwards": fwd, "sites": sites}

    net, chars = char_rnn(device=device)
    x, y = charrnn_windows(chars)
    probs, n, ms = counted(lambda: net.output(x).cpu().numpy())
    acc = float((probs.argmax(-1) == y.argmax(-1)).mean())
    want = meta["charrnn"]["next_char_accuracy"]
    print(f"[pretrained] charrnn.zip on {device}: next-character accuracy "
          f"{acc:.5f} over {x.shape[0]} windows of {x.shape[1]} (meta "
          f"{want}, bar 0.001), {ms:.1f} ms [{label}]")
    check(abs(acc - want) <= 0.001,
          f"charrnn.zip accuracy {acc} vs meta {want}")
    out["charrnn"] = {"accuracy": acc}
    out["launches"] = out["lenet"]["launches"] + \
        out["resnet_cifar"]["launches"]
    return out


#: BASELINE config #3 (benchmarks/bench_charrnn.py:31-55): 2 x
#: GravesLSTM(512, tanh) + RnnOutputLayer(80), Adam(5e-3), seed 12345,
#: batch 64 of 64 timesteps
CHARRNN = dict(hidden=512, vocab=80, batch=64, seq_len=64)


def charrnn_conf(hidden: int, vocab: int, seq_len: int,
                 compute: Optional[str] = None, tbptt: int = 0):
    from deeplearning4j_tpu_torch.activations import Activation
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.lossfunctions import LossFunction
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        BackpropType, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import GravesLSTM
    b = (NeuralNetConfiguration.Builder().seed(12345).updater(Adam(5e-3))
         .compute_data_type(compute).list()
         .layer(GravesLSTM(n_out=hidden, activation=Activation.TANH))
         .layer(GravesLSTM(n_out=hidden, activation=Activation.TANH))
         .layer(RnnOutputLayer(n_out=vocab,
                               loss_function=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX)))
    if tbptt:
        b = b.backprop_type(BackpropType.TRUNCATED_BPTT).t_bptt_length(tbptt)
    return b.set_input_type(InputType.recurrent(vocab, seq_len)).build()


def charrnn_batch(vocab: int, batch: int, seq_len: int):
    """One-hot ids from ``RandomState(0)``, as the JAX benchmark makes."""
    import numpy as np
    ids = np.random.RandomState(0).randint(0, vocab, (batch, seq_len + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _clone_params(params, device):
    return {k: {n: t.detach().clone().to(device) for n, t in sub.items()}
            for k, sub in params.items()}


def _charrnn_train(torch, net, x, y, steps, what, label, on_card):
    """``steps`` fit steps, counts to 0 before and read after; the loss
    falls; step ms, chars/s and the device profile."""
    import numpy as np
    _zero_counts()
    losses, ms = _timed_steps(torch, net, x, y, steps)
    launches = _counts()
    check(all(np.isfinite(losses)), f"{what}: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")
    check(not any(launches.values()),
          f"{what}: a ported kernel launched on the recurrent path: "
          f"{launches}")
    step_ms = float(np.median(ms[1:]))
    chars = int(x.shape[0]) * int(x.shape[1])
    print(f"[charrnn] {what}: losses {[round(v, 4) for v in losses]}; step "
          f"{step_ms:.3f} ms (median of steps 2-{steps}) = "
          f"{chars * 1e3 / step_ms:.1f} chars/s [{label}]")
    out = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
           "chars_per_s": chars * 1e3 / step_ms, "launches": launches}
    if on_card:
        out["profile"] = profile_device(torch, lambda: net.fit(x, y),
                                        step_ms, f"{what} step")
        print(f"[charrnn] {what}: {out['profile'].get('kernel_calls')} "
              f"device kernels a step [{label}]")
    return out


def phase_charrnn(torch, label: str, device: str = "cuda",
                  hidden: int = CHARRNN["hidden"], steps: int = 20) -> dict:
    """BASELINE config #3 trained on ``device``: f32 and bf16 ``fit``,
    ``fit_steps``, truncated BPTT, the ``rnn_time_step`` stream against
    ``output``, greedy sampling, and (on the card) one step card vs CPU.
    ``device="cpu"`` with a small ``hidden`` rehearses it."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    on_card = device == "cuda"
    vocab, batch, T = CHARRNN["vocab"], CHARRNN["batch"], CHARRNN["seq_len"]
    conf = charrnn_conf(hidden, vocab, T)
    net = MultiLayerNetwork(conf).init(
        device, generator=torch.Generator().manual_seed(12345))
    p0 = _clone_params(net.params, device)
    xn, yn = charrnn_batch(vocab, batch, T)
    x, y = torch.from_numpy(xn).to(device), torch.from_numpy(yn).to(device)
    print(f"[charrnn] 2 x GravesLSTM({hidden}) + RnnOutputLayer({vocab}), "
          f"batch {batch} x {T} steps on {device}, {net.num_params()} "
          f"params, Adam(5e-3)")
    out = {"f32": _charrnn_train(torch, net, x, y, steps, "f32 fit", label,
                                 on_card)}

    net16 = MultiLayerNetwork(charrnn_conf(
        hidden, vocab, T, compute="bfloat16")).set_params(
        _clone_params(p0, device), {}, device)
    out["bf16"] = _charrnn_train(torch, net16, x, y, steps,
                                 "bf16 compute_dtype fit", label, on_card)
    del net16

    # ---- fit_steps: the same steps as one call ----
    fs = MultiLayerNetwork(conf).set_params(_clone_params(p0, device), {},
                                            device)
    fs.fit_steps(DataSet(x, y), 2)                       # warm
    _sync(torch, device)
    t0 = time.perf_counter()
    fs.fit_steps(DataSet(x, y), steps)
    _sync(torch, device)
    fs_ms = (time.perf_counter() - t0) * 1e3 / steps
    check(fs.iteration_count == steps + 2 and np.isfinite(fs.score()),
          f"fit_steps: iterations {fs.iteration_count}, loss {fs.score()}")
    check(fs.score() < out["f32"]["losses"][0],
          f"fit_steps loss {fs.score()} not below the first step's")
    print(f"[charrnn] fit_steps({steps}): {fs_ms:.3f} ms a step, last loss "
          f"{fs.score():.4f} (state carried across its steps) [{label}]")
    out["fit_steps_ms"] = fs_ms
    del fs

    # ---- truncated BPTT, segments of 32 ----
    L = T // 2
    tb = MultiLayerNetwork(charrnn_conf(hidden, vocab, T, tbptt=L)
                           ).set_params(_clone_params(p0, device), {}, device)
    std = MultiLayerNetwork(conf).set_params(_clone_params(p0, device), {},
                                             device)
    d_seg = float((tb.output(x[:, :L]) - std.output(x)[:, :L]).abs().max())
    check(d_seg <= 1e-5, f"tBPTT first segment vs STANDARD forward: max "
                         f"|d| {d_seg}")
    _sync(torch, device)
    t0 = time.perf_counter()
    tb.fit(x, y)
    _sync(torch, device)
    tb_ms = (time.perf_counter() - t0) * 1e3
    check(tb.iteration_count == 2, f"tBPTT: {tb.iteration_count} "
                                   f"iterations a batch, expected 2")
    check(np.isfinite(tb.score()), f"tBPTT loss {tb.score()}")
    print(f"[charrnn] tBPTT({L}): 2 iterations a batch, {tb_ms:.3f} ms for "
          f"the batch (first call); its first segment vs the STANDARD "
          f"forward's first {L} steps: max |d| {d_seg:.3e} [{label}]")
    out.update(tbptt_ms=tb_ms, tbptt_first_segment_max_abs=d_seg)
    del tb, std

    # ---- rnn_time_step over the sequence against output ----
    net.rnn_clear_previous_state()
    stream = torch.stack([net.rnn_time_step(x[:, t]) for t in range(T)], 1)
    d_stream = float((stream - net.output(x)).abs().max())
    check(d_stream <= 1e-5, f"rnn_time_step vs output: max |d| {d_stream}")
    print(f"[charrnn] rnn_time_step over {T} steps vs output: max |d| "
          f"{d_stream:.3e} (f32)")
    out["stream_max_abs"] = d_stream

    # ---- greedy sampling through rnn_time_step ----
    def sample(n):
        net.rnn_clear_previous_state()
        cur, ids = x[:, 0], []
        for _ in range(n):
            nxt = net.rnn_time_step(cur).argmax(-1)
            ids.append(nxt)
            cur = torch.nn.functional.one_hot(nxt, vocab).to(x.dtype)
        return torch.stack(ids, 1)

    sample(4)                                            # warm
    _sync(torch, device)
    t0 = time.perf_counter()
    ids = sample(T)
    _sync(torch, device)
    secs = time.perf_counter() - t0
    # the stream's greedy choices are the whole-sequence forward's
    seq = torch.cat([x[:, :1], torch.nn.functional.one_hot(
        ids[:, :-1], vocab).to(x.dtype)], 1)
    full = net.output(seq)
    top2 = full.topk(2, -1).values
    off = full.argmax(-1) != ids
    gap = float((top2[..., 0] - top2[..., 1])[off].max()) if off.any() \
        else 0.0
    check(gap <= 1e-4, f"greedy stream differs from output beyond a tie "
                       f"(gap {gap})")
    rate = batch * T / secs
    print(f"[charrnn] greedy sampling: {T} characters at batch {batch} in "
          f"{secs * 1e3:.1f} ms = {rate:.1f} chars/s; {int(off.sum())} "
          f"choices differ from output's, at ties <= {gap:.1e} [{label}]")
    out["sample_chars_per_s"] = rate
    if on_card:
        torch.cuda.empty_cache()
        out["card_vs_cpu"] = charrnn_card_vs_cpu(torch)
    return out


def charrnn_card_vs_cpu(torch, hidden: int = 64, device: str = "cuda"
                        ) -> dict:
    """One f32 fit step of the char-RNN at ``hidden`` on the card and on
    the CPU from the same weights (matmul TF32 off), against a float64
    CPU step, with ``train_card_vs_cpu``'s bars."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    vocab, batch, T = CHARRNN["vocab"], CHARRNN["batch"], CHARRNN["seq_len"]
    conf = charrnn_conf(hidden, vocab, T)
    base = MultiLayerNetwork(conf).init(
        "cpu", generator=torch.Generator().manual_seed(31))
    xn, yn = charrnn_batch(vocab, batch, T)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    p0 = {k: {n: t.double() for n, t in sub.items()}
          for k, sub in base.params.items()}
    card = MultiLayerNetwork(conf).set_params(_clone_params(base.params,
                                                            device), {},
                                              device)
    conf64 = charrnn_conf(hidden, vocab, T)
    conf64.dtype = "float64"
    cpu64 = MultiLayerNetwork(conf64).set_params(_clone_params(p0, "cpu"),
                                                 {}, "cpu")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card.fit(x.to(device), y.to(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    base.fit(x, y)
    cpu64.fit(x.double(), y.double())
    check(abs(card.score() - base.score()) <= LOSS_RTOL * abs(base.score()),
          f"char-RNN loss card {card.score()} vs cpu {base.score()}")

    def dist(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    e_card = e_cpu = e_pair = 0.0
    for k, sub in p0.items():
        for n, t0 in sub.items():
            d64 = cpu64.params[k][n] - t0
            dcard = card.params[k][n].detach().cpu().double() - t0
            dcpu = base.params[k][n].detach().double() - t0
            e_card = max(e_card, dist(dcard, d64))
            e_cpu = max(e_cpu, dist(dcpu, d64))
            e_pair = max(e_pair, dist(dcard, dcpu))
    check(e_card <= UPDATE_FACTOR * e_cpu + UPDATE_FLOOR,
          f"char-RNN card updates {e_card:.3e} from the float64 step, the "
          f"CPU float32 step's {e_cpu:.3e}")
    print(f"[charrnn] card vs CPU, one f32 step at H={hidden}, batch "
          f"{batch} x {T} (matmul TF32 off): loss {card.score():.7f} vs "
          f"{base.score():.7f} (f64 {cpu64.score():.7f}); worst update in "
          f"norm: card vs f64 {e_card:.3e}, CPU f32 vs f64 {e_cpu:.3e}, "
          f"card vs CPU f32 {e_pair:.3e}")
    return {"loss_card": card.score(), "loss_cpu": base.score(),
            "update_card_vs_f64": e_card, "update_cpu32_vs_f64": e_cpu,
            "update_card_vs_cpu32": e_pair}


# ---------------------------------------------------------------------------
#: BERT-base's attention sites: one per layer, 12 heads of 64
BERT_LAYERS, BERT_HEADS, HEAD_DIM = 12, 12, 64
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOPS = 989e12
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: kernel against plain version: the reference's own bars in f32
#: (tests/test_attention_pallas.py:38,75: forward 2e-5, gradients rtol
#: 2e-4 / atol 2e-5); bf16 and f16 outputs may differ by a rounding of
#: their type (2^-8 for bf16), as in tests/test_torch_gpu.py
FLASH_TOL = {"float32": ((2e-5, 2e-5), (2e-4, 2e-5)),
             "bfloat16": ((2e-2, 2e-2), (2e-2, 2e-2)),
             "float16": ((2e-2, 2e-2), (2e-2, 2e-2)),
             # f64 sums against the plain version's f64 chain, as in
             # tests/test_torch_gpu.py
             "float64": ((1e-10, 1e-12), (1e-10, 1e-12))}
FLASH_DTYPES = ("float32", "bfloat16", "float16")
#: H100 SXM published FP64 tensor-core peak (NVIDIA data sheet): the
#: bound of the wide bodies' float64 sites
F64_FLOPS = 67e12


def _key_mask(torch, g, b: int, t: int, kind: str, device: str):
    """``padded``: lengths from t/2 to t, the first sequence full and the
    second fully masked; ``ragged``: lengths from 16 to t (the attention
    classifier's), the first full and the second fully masked; ``full``:
    every key kept; ``none``: no mask."""
    if kind == "none":
        return None
    if kind == "full":
        return torch.ones(b, t, device=device)
    low = t // 2 if kind == "padded" else min(16, t)
    lengths = torch.randint(low, t + 1, (b,), generator=g, device=g.device)
    lengths[0] = t
    if b > 1:
        lengths[1] = 0
    return (torch.arange(t, device=g.device)[None] < lengths[:, None]
            ).float().to(device)


def _flash_check(torch, sq, b, h, tq, tk, d, dt, causal, kind, g, errs):
    """Kernels 7, 8, 9 against their plain versions on one shape:
    tolerances FLASH_TOL, bitwise equal across two launches, no NaN, and
    the fully masked sequence's output and gradients exactly 0; the
    largest difference of each kernel goes to ``errs[dtype name]`` where
    ``errs`` has that dtype."""
    what = f"[{b},{h},{tq},{tk},{d}] {str(dt)[6:]} causal={causal} {kind}"
    q, do = (torch.randn(b, h, tq, d, device="cuda", generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, device="cuda", generator=g).to(dt)
            for _ in range(2))
    mask = _key_mask(torch, g, b, tk, kind, "cuda")
    out, lse = sq.flash_forward(q, k, v, mask, causal)
    out2, lse2 = sq.flash_forward(q, k, v, mask, causal)
    delta = sq.flash_delta(out, do)
    dq = sq.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal)
    dk, dv = sq.flash_bwd_dkv(q, k, v, do, lse, delta, mask, causal)
    dq2 = sq.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal)
    dk2, dv2 = sq.flash_bwd_dkv(q, k, v, do, lse, delta, mask, causal)
    r_out, r_lse = sq.flash_forward_plain(q, k, v, mask, causal)
    r_dq = sq.flash_dq_plain(q, k, v, do, lse, delta, mask, causal)
    r_dk, r_dv = sq.flash_dkv_plain(q, k, v, do, lse, delta, mask, causal)
    torch.cuda.synchronize()
    for nm, a, a2 in (("out", out, out2), ("lse", lse, lse2),
                      ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        check(torch.equal(a, a2), f"{nm} {what}: two launches differ")
    (f_rtol, f_atol), (g_rtol, g_atol) = FLASH_TOL[str(dt)[6:]]
    acc = torch.promote_types(dt, torch.float32)
    for name, pairs, rtol, atol in (
            ("flash_fwd", (("out", out, r_out), ("lse", lse, r_lse)),
             f_rtol, f_atol),
            ("flash_bwd_dq", (("dq", dq, r_dq),), g_rtol, g_atol),
            ("flash_bwd_dkv", (("dk", dk, r_dk), ("dv", dv, r_dv)),
             g_rtol, g_atol)):
        for nm, got, want in pairs:
            got, want = got.to(acc), want.to(acc)
            check(not bool(torch.isnan(got).any()), f"{nm} {what}: NaN")
            err = float((got - want).abs().max())
            check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
                  f"{nm} {what}: max |kernel - plain| {err:.3e} beyond "
                  f"rtol {rtol} atol {atol}")
            if str(dt)[6:] in errs:
                errs[str(dt)[6:]][name] = max(errs[str(dt)[6:]][name], err)
    if kind in ("padded", "ragged") and b > 1:
        for nm, t in (("out", out[1]), ("dq", dq[1]), ("dk", dk[1]),
                      ("dv", dv[1])):
            check(not bool(t.any()),
                  f"{nm} {what}: the fully masked sequence is not 0")


def _flash_costs(name: str, bh: int, tq: int, tk: int, d: int, esize: int,
                 heads: int = BERT_HEADS):
    """(bytes, operations) of one non-causal site of ``name``: each input
    read once and each output written once (the f32 key mask and the
    lse/delta rows, f64 for f64 inputs, included); 2 operations a
    multiply-add."""
    q_side, k_side = bh * tq * d * esize, bh * tk * d * esize
    mask, rows = bh // heads * tk * 4, bh * tq * max(4, esize)
    ops = bh * tq * tk * d
    if name == "flash_fwd":           # q, k, v -> out, lse
        return 2 * q_side + 2 * k_side + mask + rows, 4 * ops
    if name == "flash_bwd_dq":        # q, k, v, dO, lse, delta -> dq
        return 3 * q_side + 2 * k_side + mask + 2 * rows, 6 * ops
    # q, k, v, dO, lse, delta -> dk, dv
    return 2 * q_side + 4 * k_side + mask + 2 * rows, 8 * ops


def _bound(bytes_: int, ops: int, peak: float):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_flash_sites(torch, sq, dt, tq: int, tk: int, kind: str, g,
                      names=FLASH_KERNELS, plain: bool = True,
                      what: str = "", heads: int = BERT_HEADS,
                      d: int = HEAD_DIM) -> dict:
    """Each kernel of ``names`` over ``BERT_LAYERS`` distinct sites of
    ``[BATCH, heads, tq, d]`` queries against ``tk`` keys (CUDA-graph
    replay), beside its bound, its plain version (with ``plain``) and
    ``F.scaled_dot_product_attention`` for 7; with the backward kernels,
    SDPA forward + backward (eager) and, in 16 bit and f32 at d <= 256,
    ``_scaled_dot_product_efficient_attention_backward`` (8 and 9
    together), which takes no f64 and which this script does not hold
    to wider heads."""
    import torch.nn.functional as F
    n, short = BERT_LAYERS, str(dt)[6:]
    esize = torch.tensor([], dtype=dt).element_size()
    bh = BATCH * heads
    sites = []
    for _ in range(n):
        q, do = (torch.randn(BATCH, heads, tq, d, device="cuda",
                             generator=g).to(dt) for _ in range(2))
        k, v = (torch.randn(BATCH, heads, tk, d, device="cuda",
                            generator=g).to(dt) for _ in range(2))
        mask = _key_mask(torch, g, BATCH, tk, kind, "cuda")
        out, lse = sq.flash_forward(q, k, v, mask)
        sites.append((q, k, v, do, mask, out, lse, sq.flash_delta(out, do),
                      mask.bool()[:, None, None, :]))

    def run(fn):
        return lambda: [fn(*s) for s in sites]

    fns = {
        "flash_fwd": (run(lambda q, k, v, do, m, o, l, dl, bm:
                          sq.flash_forward(q, k, v, m)),
                      run(lambda q, k, v, do, m, o, l, dl, bm:
                          sq.flash_forward_plain(q, k, v, m)),
                      run(lambda q, k, v, do, m, o, l, dl, bm:
                          F.scaled_dot_product_attention(
                              q, k, v, attn_mask=bm))),
        "flash_bwd_dq": (run(lambda q, k, v, do, m, o, l, dl, bm:
                             sq.flash_bwd_dq(q, k, v, do, l, dl, m)),
                         run(lambda q, k, v, do, m, o, l, dl, bm:
                             sq.flash_dq_plain(q, k, v, do, l, dl, m)),
                         None),
        "flash_bwd_dkv": (run(lambda q, k, v, do, m, o, l, dl, bm:
                              sq.flash_bwd_dkv(q, k, v, do, l, dl, m)),
                          run(lambda q, k, v, do, m, o, l, dl, bm:
                              sq.flash_dkv_plain(q, k, v, do, l, dl, m)),
                          None),
    }
    peak = {torch.float32: F32_FLOPS, torch.float64: F64_FLOPS}.get(
        dt, BF16_FLOPS)
    res = {}
    for name in names:
        kern, plain_fn, lib = fns[name]
        b_, o_ = _flash_costs(name, bh, tq, tk, d, esize, heads)
        bound, by = _bound(n * b_, n * o_, peak)
        k_ms = _graph_ms(torch, kern, reps=3)
        p_ms = _graph_ms(torch, plain_fn, reps=1) if plain else None
        l_ms = _graph_ms(torch, lib, reps=3) if lib else None
        res[name] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": bound, "bound_by": by,
                     "bytes": n * b_, "ops": n * o_, "peak": peak,
                     "eager_ms": _time_ms(torch, kern, reps=3)}
        ps = f"{p_ms:.4f}" if p_ms is not None else "not timed"
        ls = f"{l_ms:.4f}" if l_ms is not None else "none"
        print(f"[flash] {name} {short} tq={tq} tk={tk} d={d}, {n} sites "
              f"{what}: kernel {k_ms:.4f} ms, plain {ps} ms, SDPA {ls} ms, "
              f"bound {bound:.4f} ms ({by}; {n * o_ / 1e9:.2f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s, {n * b_ / 1e9:.4f} GB), eager "
              f"{res[name]['eager_ms']:.4f} ms, "
              f"{n * o_ / k_ms / 1e9:.2f} TFLOP/s achieved")
    if "flash_bwd_dq" in names and dt != torch.float64 and d <= 256:
        # one library call for rows 8 + 9 together: the memory-efficient
        # attention backward on the same inputs (its own forward's out and
        # log-sum-exp, the key mask as a zero/-inf bias), its forward
        # excluded
        eff = torch.ops.aten._scaled_dot_product_efficient_attention
        eff_bwd = \
            torch.ops.aten._scaled_dot_product_efficient_attention_backward
        lib_sites = []
        for q, k, v, do, m, *_ in sites:
            bias = torch.zeros_like(m, dtype=dt).masked_fill(
                m == 0, float("-inf"))[:, None, None, :].expand(
                    -1, heads, tq, -1)
            o, lse_e, seed, off = eff(q, k, v, bias, True)
            lib_sites.append((do, q, k, v, bias, o, lse_e, seed, off))

        def eff_backward():
            for a in lib_sites:
                eff_bwd(*a, 0.0, [True, True, True, False])
        pair_ms = _graph_ms(torch, eff_backward, reps=3)
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            res[name]["library_ms"] = pair_ms
            res[name]["library_covers"] = "flash_bwd_dq + flash_bwd_dkv"
        k89 = sum(res[nm]["kernel_ms"] for nm in FLASH_KERNELS[1:])
        print(f"[flash] _scaled_dot_product_efficient_attention_backward "
              f"{short} tq={tq} tk={tk}, {n} sites (dq, dk, dv together): "
              f"{pair_ms:.4f} ms; kernels 8+9 {k89:.4f} ms")
        del lib_sites
    if "flash_bwd_dq" in names:
        # the yardstick's backward: SDPA forward + backward, eager
        leaves = [[x.detach().clone().requires_grad_(True)
                   for x in s[:3]] for s in sites]

        def sdpa_fwd_bwd():
            for (q, k, v), s in zip(leaves, sites):
                F.scaled_dot_product_attention(
                    q, k, v, attn_mask=s[8]).backward(s[3])
        fb = _time_ms(torch, sdpa_fwd_bwd, reps=3)
        res["sdpa_fwd_bwd_ms"] = fb
        print(f"[flash] SDPA forward+backward {short} tq={tq} tk={tk}, {n} "
              f"sites: {fb:.4f} ms (eager); kernels 7+8+9 "
              f"{sum(res[nm]['kernel_ms'] for nm in FLASH_KERNELS):.4f} ms")
    del sites
    torch.cuda.empty_cache()
    return res


#: the attention classifier's and RecurrentAttentionLayer's query counts
#: against its 128 keys (phase 20)
FLASH_TQ = (1, 4)
#: an unprojected SelfAttentionLayer's head over BERT-base's 768 features
#: (phase 20): past the 256 of the tiled bodies
WIDE_HEAD_DIM = 768


def phase_flash_kernels(torch) -> dict:
    """Kernels 7, 8 and 9 against their plain versions at BERT-base's
    site shapes, the attention classifier's (t_q = 1 and 4 against 128
    ragged keys) and five more, f32, bf16 and f16, then past d = 256 and
    in f64 (the wide bodies); then the times of each over the 12 sites of
    a batch-32 BERT-base step, over 12 sites of each t_q and over 12
    unprojected-layer sites of head dim 768 (CUDA-graph replay), beside
    the bound, the plain version and ``F.scaled_dot_product_attention``."""
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    g = torch.Generator(device="cuda").manual_seed(17)
    errs = {n: {k: 0.0 for k in FLASH_KERNELS}
            for n in ("float32", "float64")}
    shapes = [(BATCH, BERT_HEADS, 128, 128, HEAD_DIM, False, "padded"),
              (BATCH, BERT_HEADS, 512, 512, HEAD_DIM, False, "padded"),
              (4, BERT_HEADS, 256, 256, HEAD_DIM, True, "none"),
              (4, BERT_HEADS, 512, 512, HEAD_DIM, True, "padded"),
              (4, 4, 200, 200, 32, False, "padded"),
              # several query and key tiles with tq > tk, and d = 96
              # (padded to 128 inside the kernels), both causal
              (2, 2, 200, 130, HEAD_DIM, True, "padded"),
              (2, 2, 190, 190, 96, True, "padded")]
    # one query tile padded from 1 or 4 rows (LearnedSelfAttentionLayer,
    # RecurrentAttentionLayer's step) against the classifier's ragged keys
    shapes += [(BATCH, BERT_HEADS, tq, 128, HEAD_DIM, False, "ragged")
               for tq in FLASH_TQ]
    for shape in shapes:
        for dt in FLASH_DTYPES:
            _flash_check(torch, sq, *shape[:5], getattr(torch, dt),
                         shape[5], shape[6], g, errs)
        torch.cuda.empty_cache()
    # past d = 256, the wide bodies: an unprojected SelfAttentionLayer's
    # head of 768 over the classifier's ragged keys, and a causal width
    # off the 128-column output chunk; float64 (the wide bodies at every
    # d) at those and at BERT-base's site
    wide = [(BATCH, 1, 128, 128, WIDE_HEAD_DIM, False, "ragged"),
            (2, 2, 70, 45, 300, True, "padded")]
    for shape in wide:
        for dt in FLASH_DTYPES + ("float64",):
            _flash_check(torch, sq, *shape[:5], getattr(torch, dt),
                         shape[5], shape[6], g, errs)
        torch.cuda.empty_cache()
    _flash_check(torch, sq, 4, BERT_HEADS, 128, 128, HEAD_DIM,
                 torch.float64, False, "padded", g, errs)
    print(f"[flash] flash_fwd/flash_bwd_dq/flash_bwd_dkv == plain at "
          f"{len(shapes) + len(wide)} shapes x f32/bf16/f16 and "
          f"{len(wide) + 1} x f64 (f32 fwd rtol/atol 2e-5, grads rtol 2e-4 "
          f"atol 2e-5; bf16 and f16 2e-2; f64 rtol 1e-10 atol 1e-12), "
          f"bitwise across two launches, fully masked sequences exactly 0, "
          f"no NaN; max |kernel - plain| {errs}")

    # timings over 12 distinct sets of inputs, so the replay reads what a
    # step reads (a BERT t=128 site's q, k, v are 38 MB in f32)
    timing = {}
    for n in FLASH_DTYPES:
        dt = getattr(torch, n)
        timing[f"{n}_t128"] = _time_flash_sites(
            torch, sq, dt, 128, 128, "full", g,
            what=f"of a batch-{BATCH} BERT-base step")
        # the t=512 site is served, not trained
        timing[f"{n}_t512"] = _time_flash_sites(
            torch, sq, dt, 512, 512, "full", g, names=("flash_fwd",),
            plain=False, what=f"of a batch-{BATCH} BERT-base forward")
        for tq in FLASH_TQ:
            timing[f"{n}_tq{tq}"] = _time_flash_sites(
                torch, sq, dt, tq, 128, "ragged", g,
                what="against ragged keys")
    for n in ("float32", "bfloat16", "float64"):
        timing[f"{n}_d{WIDE_HEAD_DIM}"] = _time_flash_sites(
            torch, sq, getattr(torch, n), 128, 128, "ragged", g,
            what="of an unprojected layer against ragged keys", heads=1,
            d=WIDE_HEAD_DIM)
    return {"max_abs_err": errs["float32"], "max_abs_err_f64":
            errs["float64"], "timing": timing}


# ---------------------------------------------------------------------------
def bert_batch(torch, g, batch: int, t: int, vocab: int, device: str,
               mask_id: int = 4) -> dict:
    """A seeded pretraining batch: random ids, padded key masks (lengths
    t/2..t, the first full), segment B over the second half of each
    sequence, 15 % of the real tokens masked for MLM, random NSP
    labels."""
    ids = torch.randint(5, vocab, (batch, t), generator=g)
    lengths = torch.randint(t // 2, t + 1, (batch,), generator=g)
    lengths[0] = t
    pos = torch.arange(t)[None]
    am = (pos < lengths[:, None])
    masked = (torch.rand(batch, t, generator=g) < 0.15) & am
    masked[:, 0] = False
    out = {"input_ids": torch.where(masked, mask_id, ids),
           "token_type_ids": ((pos >= lengths[:, None] // 2) & am).long(),
           "attention_mask": am.float(),
           "mlm_labels": torch.where(masked, ids, -1),
           "nsp_labels": torch.randint(0, 2, (batch,), generator=g)}
    return {k: v.to(device) for k, v in out.items()}


def _flash_counts():
    c = _counts()
    return {k: c[k] for k in FLASH_KERNELS}


def phase_bert_serve(torch, label: str, device: str = "cuda", conf=None,
                     batch: int = BATCH) -> dict:
    """Full-width BERT-base inference. ``device="cpu"`` with a small
    ``conf`` rehearses the phase without a card (launch counts, timings
    and the profile are the card's)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import (
        Bert, BertConfig, BertForSequenceClassification)
    conf = conf or BertConfig.base()
    on_card = device == "cuda"
    g = torch.Generator().manual_seed(31)
    t0 = time.perf_counter()
    bert = Bert(conf, seed=31).init(device, generator=g)
    cls = BertForSequenceClassification(bert, 2, seed=32)
    t_long = min(512, conf.max_position_embeddings)
    b128 = bert_batch(torch, g, batch, 128, conf.vocab_size, device)
    b512 = bert_batch(torch, g, batch, t_long, conf.vocab_size, device)
    args = (b128["input_ids"], b128["token_type_ids"],
            b128["attention_mask"])
    L = conf.num_hidden_layers
    print(f"[bert-serve] BERT L={L} H={conf.hidden_size} "
          f"A={conf.num_attention_heads} vocab {conf.vocab_size}, "
          f"{bert.num_params()} params on {device}, built in "
          f"{time.perf_counter() - t0:.2f}s")

    # ---- the main path: counts to 0, three forwards, counts read ----
    _zero_counts()
    seq, pooled = bert.output(*args)
    preds = cls.predict(*args)
    seq_l, pooled_l = bert.output(b512["input_ids"], None,
                                  b512["attention_mask"])
    _sync(torch, device)
    launches = _flash_counts()
    print(f"[bert-serve] main path: Bert.output t=128, "
          f"BertForSequenceClassification.predict t=128, Bert.output "
          f"t={t_long}; launches {launches}")
    want = {"flash_fwd": 3 * L * on_card, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    check(launches == want, f"serving launches {launches}, expected "
                            f"{want} (12 forward launches a forward)")
    H = conf.hidden_size
    check(seq.shape == (batch, 128, H) and pooled.shape == (batch, H)
          and seq_l.shape == (batch, t_long, H) and preds.shape == (batch,),
          "BERT output shapes")
    for nm, t in (("seq", seq), ("pooled", pooled), ("seq512", seq_l)):
        check(bool(torch.isfinite(t).all()), f"BERT {nm} not finite")
    # padding is isolated: other ids at masked positions change nothing
    # in the real ones (their probabilities are exactly 0)
    am = b128["attention_mask"].bool()
    ids2 = torch.where(am, b128["input_ids"], 7)
    seq2, _ = bert.output(ids2, b128["token_type_ids"],
                          b128["attention_mask"])
    check(torch.equal(seq2[am], seq[am]),
          "padded tokens changed the real tokens' outputs")
    result = {"launches": launches}
    print(f"[bert-serve] outputs finite; padding isolated bitwise; "
          f"classifier predicts {np.bincount(preds, minlength=2).tolist()}")
    if not on_card:
        return result

    for nm, fn in (("f32_t128", lambda: bert.output(*args)),
                   (f"f32_t{t_long}", lambda: bert.output(
                       b512["input_ids"], None, b512["attention_mask"])),
                   ("cls_predict_t128", lambda: cls.predict(*args))):
        runs = sorted(_time_ms(torch, fn, reps=5) for _ in range(3))
        result[f"{nm}_ms"] = runs
        print(f"[bert-serve] {nm}: {runs[1]:.3f} ms a forward (median of "
              f"{[round(r, 3) for r in runs]}) = {batch * 1e3 / runs[1]:.1f}"
              f" sequences/s [{label}]")
    result["profile_f32_t128"] = profile_device(
        torch, lambda: bert.output(*args), result["f32_t128_ms"][1],
        "batch-32 t=128 f32 BERT-base forward", shares=("flash_fwd",))
    result[f"profile_f32_t{t_long}"] = profile_device(
        torch, lambda: bert.output(b512["input_ids"], None,
                                   b512["attention_mask"]),
        result[f"f32_t{t_long}_ms"][1],
        f"batch-32 t={t_long} f32 BERT-base forward", shares=("flash_fwd",))

    bert16 = Bert(dataclasses.replace(conf, compute_dtype="bfloat16")).set_params(
        bert.params, device)
    n0 = _flash_counts()["flash_fwd"]
    s16, p16 = bert16.output(*args)
    torch.cuda.synchronize()
    check(_flash_counts()["flash_fwd"] - n0 == L,
          "bf16 forward did not run 12 flash launches")
    check(bool(torch.isfinite(s16).all()), "bf16 BERT output not finite")
    rel = float((s16[am] - seq[am]).norm() / seq[am].norm())
    runs = sorted(_time_ms(torch, lambda: bert16.output(*args), reps=5)
                  for _ in range(3))
    result.update(bf16_t128_ms=runs, bf16_rel_err=rel)
    print(f"[bert-serve] bf16 compute_dtype t=128: {runs[1]:.3f} ms "
          f"({batch * 1e3 / runs[1]:.1f} sequences/s); sequence output "
          f"within {rel:.3e} of f32 in norm [{label}]")
    check(rel < 0.1, f"bf16 sequence output {rel:.3e} from f32 in norm")
    result["profile_bf16_t128"] = profile_device(
        torch, lambda: bert16.output(*args), runs[1],
        "batch-32 t=128 bf16 BERT-base forward", shares=("flash_fwd",))

    def long16():
        return bert16.output(b512["input_ids"], None, b512["attention_mask"])
    n0 = _flash_counts()["flash_fwd"]
    s16l, _ = long16()
    torch.cuda.synchronize()
    check(_flash_counts()["flash_fwd"] - n0 == L,
          f"bf16 t={t_long} forward did not run 12 flash launches")
    am_l = b512["attention_mask"].bool()
    rel_l = float((s16l[am_l] - seq_l[am_l]).norm() / seq_l[am_l].norm())
    check(rel_l < 0.1, f"bf16 t={t_long} sequence output {rel_l:.3e} from "
                       f"f32 in norm")
    runs = sorted(_time_ms(torch, long16, reps=5) for _ in range(3))
    result.update({f"bf16_t{t_long}_ms": runs,
                   f"bf16_t{t_long}_rel_err": rel_l})
    print(f"[bert-serve] bf16 compute_dtype t={t_long}: {runs[1]:.3f} ms "
          f"({batch * 1e3 / runs[1]:.1f} sequences/s); sequence output "
          f"within {rel_l:.3e} of f32 in norm [{label}]")
    result[f"profile_bf16_t{t_long}"] = profile_device(
        torch, long16, runs[1],
        f"batch-32 t={t_long} bf16 BERT-base forward", shares=("flash_fwd",))
    return result


def phase_bert_train(torch, label: str, device: str = "cuda", conf=None,
                     batch: int = BATCH, steps: int = 10) -> dict:
    """BERT-base pretraining, phase-1 recipe: t=128, 20 predictions a
    sequence, NSP, hidden dropout 0.1, attention dropout 0 (the route
    through the kernels), Adam(1e-4); ``steps`` fit_batch calls on one
    seeded batch in f32, then the same from the same weights and batch
    with ``compute_dtype="bfloat16"``, then 3 classifier fine-tuning
    steps of the f32 model."""
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models import (
        Bert, BertConfig, BertForSequenceClassification)
    conf = dataclasses.replace(
        conf or BertConfig.base(), max_predictions_per_seq=20, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.0)
    on_card = device == "cuda"
    L = conf.num_hidden_layers

    def pretrain(dtype: str):
        g = torch.Generator().manual_seed(41)
        bert = Bert(dataclasses.replace(conf, compute_dtype=dtype),
                    Adam(1e-4), seed=41).init(device, generator=g)
        b = bert_batch(torch, g, batch, 128, conf.vocab_size, device)
        np.random.seed(41)        # fit_batch seeds each step's generator

        # ---- the main path: counts to 0, ten steps, counts read ----
        _zero_counts()
        losses, ms = [], []
        for _ in range(steps):
            _sync(torch, device)
            t0 = time.perf_counter()
            losses.append(bert.fit_batch(b))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _flash_counts()
        print(f"[bert-train] {dtype} losses {[round(v, 5) for v in losses]};"
              f" step ms {[round(m, 3) for m in ms]}; launches {launches}")
        check(all(np.isfinite(losses)),
              f"BERT {dtype} loss not finite: {losses}")
        check(losses[-1] < losses[0], f"BERT {dtype} loss did not fall: "
                                      f"{losses}")
        for k in FLASH_KERNELS:
            check(launches[k] == L * steps * on_card,
                  f"{dtype} {k}: {launches[k]} launches in {steps} steps, "
                  f"expected {L} a step")
        step_ms = float(np.median(ms[1:]))
        print(f"[bert-train] batch-{batch} t=128 {dtype} step {step_ms:.3f} "
              f"ms (median of steps 2-{steps}) = "
              f"{batch * 1e3 / step_ms:.1f} sequences/s [{label}]")
        res = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
               "seq_per_s": batch * 1e3 / step_ms, "launches": launches}
        if on_card:
            prof = profile_device(
                torch, lambda: bert.fit_batch(b), step_ms,
                f"batch-{batch} t=128 {dtype} BERT-base train step",
                shares=("flash_bwd_dq", "flash_bwd_dkv"))
            res["profile"] = prof
            if prof:
                k89 = sum(v["share_of_busy"]
                          for v in prof["shares"].values())
                print(f"[bert-train] {dtype} step: kernels 8 + 9 "
                      f"{k89:.4f} of busy [{label}]")
        return bert, b, res

    bert, b, result = pretrain("float32")
    result["bfloat16"] = pretrain("bfloat16")[2]

    cls = BertForSequenceClassification(bert, 2, Adam(2e-5), seed=42)
    cb = {"input_ids": b["input_ids"], "token_type_ids":
          b["token_type_ids"], "attention_mask": b["attention_mask"],
          "labels": b["nsp_labels"]}
    _zero_counts()
    c_losses = [cls.fit_batch(cb) for _ in range(3)]
    c_launches = _flash_counts()
    print(f"[bert-train] classifier fine-tune losses {c_losses}; launches "
          f"{c_launches}")
    check(all(np.isfinite(c_losses)), f"classifier loss {c_losses}")
    for k in FLASH_KERNELS:
        check(c_launches[k] == L * 3 * on_card,
              f"classifier {k}: {c_launches[k]} launches in 3 steps")
    check(bert.params is cls.params["bert"],
          "fit_batch did not write the encoder back")
    result.update(cls_losses=c_losses, cls_launches=c_launches)
    del cls, bert
    result["remat"] = bert_remat(torch, label, device, conf, batch)
    return result


def _product_counter(torch):
    """A dispatch mode counting the matrix products (mm, addmm, bmm,
    baddbmm) that run, forward, recompute and backward; a product that
    selective checkpointing hands back from its cache does not run."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    ops = (aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in ops
            return func(*args, **(kwargs or {}))
    return Count()


#: remat against no remat, where not bitwise: the losses and the
#: updates (norm-wise over all parameters)
REMAT_RTOL = 1e-6


def bert_remat(torch, label: str, device: str, conf, batch: int,
               steps: int = 3) -> dict:
    """BERT pretraining (``conf``: hidden dropout 0.1, attention dropout
    0, so the flash kernels carry attention) with ``remat`` False, True
    and "dots" from the same weights, batch and step keys: ``steps``
    fit_batch steps each, counts set to 0 before and read after (kernel
    7 twice a layer a step under True and "dots", since its forward is
    recomputed, once without; kernels 8 and 9 once), the peak memory
    of the steps (True's below False's), then one more step under a
    product counter ("dots" runs no more products than False, True one
    forward's more: 6 a layer). The losses and the updates equal
    False's, bit for bit or within REMAT_RTOL (the updates norm-wise
    over all parameters at once). The updater is Sgd: its update is
    linear in the gradient, so the comparison sees the gradients' own
    rounding (the embedding and gather backwards add with atomics, in
    no fixed order, with remat or without), where Adam would turn an
    entry whose exact gradient is 0 (the key bias) into a step of the
    full rate."""
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.models import Bert
    from deeplearning4j_tpu_torch.models.bert import flatten_tree
    on_card = device == "cuda"
    L = conf.num_hidden_layers
    out, ref, p0 = {}, None, None
    for mode in (False, True, "dots"):
        g = torch.Generator().manual_seed(41)
        bert = Bert(dataclasses.replace(conf, remat=mode), Sgd(0.05),
                    seed=41).init(device, generator=g)
        if p0 is None:
            p0 = {n: t.clone() for n, t in flatten_tree(bert.params)
                  .items()}
        b = bert_batch(torch, g, batch, 128, conf.vocab_size, device)
        np.random.seed(43)        # the same step keys for every mode
        _zero_counts()

        def run():
            losses, ms = [], []
            for _ in range(steps):
                _sync(torch, device)
                t0 = time.perf_counter()
                losses.append(bert.fit_batch(b))
                ms.append((time.perf_counter() - t0) * 1e3)
            return losses, ms
        (losses, ms), peak = _peak_mb(torch, device, run)
        launches = _flash_counts()
        flat = {n: t.detach() - p0[n] for n, t in
                flatten_tree(bert.params).items()}
        count = _product_counter(torch)
        with count:
            bert.fit_batch(b)
        _sync(torch, device)
        r = {"losses": losses, "step_ms": ms, "peak_mb": peak,
             "launches": launches, "products_a_step": count.n}
        for k in FLASH_KERNELS:
            per = 2 * L if (mode and k == "flash_fwd") else L
            check(launches[k] == per * steps * on_card,
                  f"remat={mode!r} {k}: {launches[k]} launches in {steps} "
                  f"steps, expected {per} a step")
        if ref is None:
            ref = (losses, flat, count.n)
        else:
            same = losses == ref[0] and all(
                torch.equal(t, ref[1][n]) for n, t in flat.items())
            num = sum(float((t - ref[1][n]).double().pow(2).sum())
                      for n, t in flat.items())
            den = sum(float(t.double().pow(2).sum())
                      for t in ref[1].values())
            err = (num / den) ** 0.5
            l_err = max(abs(a - b_) / abs(b_) for a, b_ in
                        zip(losses, ref[0]))
            check(same or (err <= REMAT_RTOL and l_err <= REMAT_RTOL),
                  f"remat={mode!r}: losses {losses} vs {ref[0]}, updates "
                  f"{err:.3e} in norm")
            # 6 products a layer on the card (q, k, v, o and the FFN's
            # two; kernel 7 is none), 8 where the attention's plain
            # version computes its two as products
            per_layer = 6 if on_card else 8
            extra = L * per_layer if mode is True else 0
            check(count.n == ref[2] + extra,
                  f"remat={mode!r}: {count.n} products a step, remat=False"
                  f" {ref[2]}, expected {extra} more")
            r.update(bitwise=same, param_rel_err=err, loss_rel_err=l_err)
        out[str(mode)] = r
        print(f"[bert-remat] remat={mode!r}: losses "
              f"{[round(v, 6) for v in losses]}; step ms "
              f"{[round(m, 3) for m in ms]}; peak {peak} MB; launches "
              f"{launches}; {count.n} matrix products a step"
              + (f"; equal to remat=False: bitwise {r['bitwise']}, "
                 f"updates {r['param_rel_err']:.3e} in norm, losses "
                 f"{r['loss_rel_err']:.3e}" if "bitwise" in r else "")
              + f" [{label}]")
        del bert, flat
        if on_card:
            torch.cuda.empty_cache()
    if on_card:
        check(out["True"]["peak_mb"] < out["False"]["peak_mb"],
              f"remat=True peak {out['True']['peak_mb']:.1f} MB not below "
              f"remat=False's {out['False']['peak_mb']:.1f} MB")
    return out


#: card against CPU for BERT (TF32 off): the forward as a forward, and
#: one SGD step, whose update is lr x the gradient, so kernels 8 and 9
#: are held norm-wise against a float64 CPU step as train_card_vs_cpu
#: holds ResNet-50's
BERT_FWD_RTOL, BERT_FWD_ATOL = 1e-3, 1e-5
BERT_UPDATE_FLOOR = 1e-4


def _with_flash_gate(gate: Optional[str], fn):
    """``fn()`` with ``Environment.extra["flash_attention"]`` set to
    ``gate`` (None: unset), restored after."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    extra = Environment.get().extra
    saved = extra.get("flash_attention")
    if gate is None:
        extra.pop("flash_attention", None)
    else:
        extra["flash_attention"] = gate
    try:
        return fn()
    finally:
        if saved is None:
            extra.pop("flash_attention", None)
        else:
            extra["flash_attention"] = saved


def bert_card_vs_cpu(torch, device: str = "cuda", layers: int = 2,
                     batch: int = 4) -> dict:
    """Full-width BERT at reduced depth on the card and on the CPU (the
    CPU on the card's route: the flash gate forced, so it runs the
    kernels' plain versions) in float32 and float64. ``device="cpu"``
    rehearses it without a card."""
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.models import Bert, BertConfig
    from deeplearning4j_tpu_torch.models.bert import flatten_tree
    conf = dataclasses.replace(
        BertConfig.base(), num_hidden_layers=layers, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, max_predictions_per_seq=20)
    g = torch.Generator().manual_seed(43)
    cpu = Bert(conf, Sgd(0.1), seed=43).init("cpu", generator=g)
    b = bert_batch(torch, g, batch, 128, conf.vocab_size, "cpu")
    p0 = {n: t.clone() for n, t in flatten_tree(cpu.params).items()}
    card = Bert(conf, Sgd(0.1)).set_params(cpu.params, device)
    cpu64 = Bert(dataclasses.replace(conf, compute_dtype="float64"), Sgd(0.1)
                 ).set_params({n: t.double() for n, t in p0.items()}, "cpu")
    args = (b["input_ids"], b["token_type_ids"], b["attention_mask"])
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        s_card, p_card = card.output(*args)
        s_card, p_card = s_card.cpu(), p_card.cpu()
        l_card = card.fit_batch(b)
        (s_cpu, p_cpu), l_cpu, l_64 = _with_flash_gate(
            "1", lambda: (cpu.output(*args), cpu.fit_batch(b),
                          cpu64.fit_batch(b)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    err = float((s_card - s_cpu).abs().max())
    check(bool(torch.allclose(s_card, s_cpu, rtol=BERT_FWD_RTOL,
                              atol=BERT_FWD_ATOL))
          and bool(torch.allclose(p_card, p_cpu, rtol=BERT_FWD_RTOL,
                                  atol=BERT_FWD_ATOL)),
          f"BERT forward card vs CPU: max |d| {err}")
    check(abs(l_card - l_cpu) <= LOSS_RTOL * abs(l_cpu),
          f"BERT loss card {l_card} vs cpu {l_cpu}")

    f_card, f_cpu = flatten_tree(card.params), flatten_tree(cpu.params)
    f_64 = flatten_tree(cpu64.params)
    # a leaf whose exact gradient is 0 or nearly (the key bias: softmax
    # is invariant to it) is held against a floor, BERT_UPDATE_FLOOR of
    # the largest leaf update, not against its own rounding noise
    floor = BERT_UPDATE_FLOOR * max(float((f_64[n] - t.double()).norm())
                                    for n, t in p0.items())

    def dist(a, b_):
        return float((a - b_).norm() / b_.norm().clamp_min(floor))

    e_card = e_cpu = e_pair = 0.0
    worst = ""
    for n, t0 in p0.items():
        d64 = f_64[n] - t0.double()
        dcard = f_card[n].detach().cpu().double() - t0.double()
        dcpu = f_cpu[n].double() - t0.double()
        ec = dist(dcard, d64)
        if ec > e_card:
            e_card, worst = ec, n
        e_cpu = max(e_cpu, dist(dcpu, d64))
        e_pair = max(e_pair, dist(dcard, dcpu))
    check(e_card <= UPDATE_FACTOR * e_cpu + UPDATE_FLOOR,
          f"BERT card updates {e_card:.3e} from the float64 step ({worst}),"
          f" the CPU float32 step's {e_cpu:.3e}")
    print(f"[bert-vs-cpu] BERT L={layers} H={conf.hidden_size}, batch "
          f"{batch}, t=128 (TF32 off; CPU on the card's route): forward max"
          f" |d| {err:.3e}; SGD step loss {l_card:.7f} vs {l_cpu:.7f} (f64 "
          f"{l_64:.7f}); worst update in norm: card vs f64 {e_card:.3e} "
          f"({worst}), CPU f32 vs f64 {e_cpu:.3e}, card vs CPU f32 "
          f"{e_pair:.3e}")
    return {"fwd_max_abs": err, "loss_card": l_card, "loss_cpu": l_cpu,
            "loss_cpu64": l_64, "update_card_vs_f64": e_card,
            "update_cpu32_vs_f64": e_cpu, "update_card_vs_cpu32": e_pair}


# ---------------------------------------------------------------------------
#: BERT-base's widths, the dimensions of BASELINE config #4's TF graph
SD_BERT = dict(vocab=30522, hidden=768, heads=12, layers=12,
               intermediate=3072)
#: optimized import (flash kernel 7, F.layer_norm, fused GELU) against
#: the same bytes imported with optimize=False (the TF graph's dense
#: op-by-op chain), both on the card, TF32 off: full-f32 sums in other
#: orders through 12 layers, each ending in a LayerNorm (outputs ~1)
SD_FWD_RTOL, SD_FWD_ATOL = 1e-4, 1e-4
SD_PREDICTIONS = 32


def sd_bert_batch(torch, g, batch: int, t: int, vocab: int, device: str,
                  predictions: int = SD_PREDICTIONS) -> dict:
    """The imported graph's placeholders (int32, as TF feeds them):
    random ids, padded key masks (lengths t/2..t, the first full, so
    every row keeps its keys), segment B over the second half, and
    ``predictions`` MLM positions a sequence among its real tokens."""
    lengths = torch.randint(t // 2, t + 1, (batch,), generator=g)
    lengths[0] = t
    pos = torch.arange(t)[None]
    mask = (pos < lengths[:, None]).int()
    positions = torch.stack([
        torch.sort(torch.randperm(int(n), generator=g)[:predictions])[0]
        for n in lengths])
    out = {"ids": torch.randint(5, vocab, (batch, t), generator=g),
           "seg": ((pos >= lengths[:, None] // 2) & (mask > 0)).int(),
           "mask": mask, "mlm_positions": positions,
           "mlm_labels": torch.randint(5, vocab, (batch, predictions),
                                       generator=g)}
    return {k: v.to(torch.int32).to(device) for k, v in out.items()}


def _encoder_feeds(b: dict) -> dict:
    return {k: b[k] for k in ("ids", "seg", "mask")}


def phase_sd_bert(torch, label: str, device: str = "cuda", dims=None,
                  batch: int = BATCH, t: int = 128, steps: int = 10,
                  native: Optional[dict] = None) -> dict:
    """BASELINE config #4: the TF-free writer's frozen BERT GraphDef at
    BERT-base's widths, imported and optimized (``run_import``), served
    through ``SameDiff.output`` and trained with the weight-tied MLM
    head through ``fit_steps`` (Adam(5e-4), f32 then bf16), saved and
    restored. ``device="cpu"`` with small ``dims`` rehearses the phase
    without a card (counts, timings and profiles are the card's).
    ``native``: ``phase_serve``/``phase_bert_train`` results to print
    beside."""
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        TensorflowFrameworkImporter
    from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import (
        build_frozen_bert, import_and_attach_mlm)
    from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
        parse_graphdef
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer
    dims = dict(dims or SD_BERT)
    L, H, V = dims["layers"], dims["hidden"], dims["vocab"]
    n_pred = min(SD_PREDICTIONS, t // 2)
    on_card = device == "cuda"
    shapes = {n: (batch, t) for n in ("ids", "seg", "mask")}
    res: dict = {}

    t0 = time.perf_counter()
    gd = build_frozen_bert(t, batch, seed=0, **dims)
    res["build_s"] = time.perf_counter() - t0
    res["graphdef_bytes"] = len(gd)
    t0 = time.perf_counter()
    nodes = parse_graphdef(gd)
    res["decode_s"] = time.perf_counter() - t0
    res["graphdef_nodes"] = len(nodes)
    print(f"[sd-bert] frozen GraphDef L={L} H={H} A={dims['heads']} vocab "
          f"{V}, batch {batch}, t={t}: {res['graphdef_bytes']} bytes, "
          f"{res['graphdef_nodes']} nodes, written without TF in "
          f"{res['build_s']:.2f}s, decoded in {res['decode_s']:.2f}s")
    t0 = time.perf_counter()
    sd = TensorflowFrameworkImporter.run_import(gd, shapes, device=device)
    _sync(torch, device)
    res["import_s"] = time.perf_counter() - t0
    counts = dict(sd.graphopt_counts)
    walk = [sd.ops[i].op_name for i in sd._ancestors(["Identity"])]
    res.update(graphopt=counts, ops_walked=len(walk))
    print(f"[sd-bert] imported onto {device} in {res['import_s']:.2f}s "
          f"(decode + import + GraphOptimizer); counts {counts}; "
          f"{len(walk)} ops walked a forward")
    want = {"attention_fuse": L, "layernorm_refuse": 2 * L,
            "gelu_refuse": L, "mask_strength_reduce": L}
    check(all(counts.get(k) == v for k, v in want.items()),
          f"GraphOptimizer counts {counts}, expected {want}")
    check("softmax" not in walk and walk.count("sdpa_core") == L,
          f"the output's walk holds {walk.count('softmax')} softmax and "
          f"{walk.count('sdpa_core')} sdpa_core ops")

    g = torch.Generator().manual_seed(53)
    b = sd_bert_batch(torch, g, batch, t, V, device, n_pred)
    enc = _encoder_feeds(b)

    # ---- the main path: counts to 0, one forward, counts read ----
    _zero_counts()
    out = sd.output(enc, ["Identity"])["Identity"]
    _sync(torch, device)
    launches = _flash_counts()
    print(f"[sd-bert] main path: SameDiff.output t={t}; launches "
          f"{launches}")
    check(launches == {"flash_fwd": L * on_card, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0},
          f"imported forward launches {launches}, expected {L} of kernel 7")
    check(tuple(out.shape) == (batch, t, H)
          and bool(torch.isfinite(out).all()), "imported output")
    res["fwd_launches"] = launches

    # the later imports start from the decoded nodes
    raw = TensorflowFrameworkImporter.run_import(nodes, shapes,
                                                 optimize=False,
                                                 device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        opt_out = sd.output(enc, ["Identity"])["Identity"]
        raw_out = raw.output(enc, ["Identity"])["Identity"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del raw
    err = float((opt_out - raw_out).abs().max())
    res["opt_vs_dense_max_abs"] = err
    print(f"[sd-bert] optimized vs optimize=False (dense op-by-op chain, "
          f"-1e9 additive mask), TF32 off: max |d| {err:.3e}")
    check(bool(torch.allclose(opt_out, raw_out, rtol=SD_FWD_RTOL,
                              atol=SD_FWD_ATOL)),
          f"optimized import vs the dense chain: max |d| {err:.3e}")
    del opt_out, raw_out

    def fwd():
        return sd.output(enc, ["Identity"])

    if on_card:
        runs = sorted(_time_ms(torch, fwd, reps=5) for _ in range(3))
        res["fwd_ms"] = runs
        nat = (native or {}).get("serve", {}).get("f32_t128_ms")
        print(f"[sd-bert] f32 forward t={t}: {runs[1]:.3f} ms (median of "
              f"{[round(r, 3) for r in runs]}) = {batch * 1e3 / runs[1]:.1f}"
              f" sequences/s; native Bert.output "
              f"{nat[1] if nat else float('nan'):.3f} ms [{label}]")
        res["fwd_profile"] = profile_device(
            torch, fwd, runs[1], f"batch-{batch} t={t} imported BERT "
            f"forward (SameDiff.output)", shares=("flash_fwd",))
    del sd

    def train(dtype):
        sdt, _ = import_and_attach_mlm(
            nodes, batch, t, vocab=V, hidden=H, updater=Adam(5e-4),
            dtype=dtype, max_predictions=n_pred, device=device)
        name = dtype or "float32"
        # ---- the main path: counts to 0, ten steps, counts read ----
        _zero_counts()
        losses, ms = [], []
        for _ in range(steps):
            _sync(torch, device)
            t0 = time.perf_counter()
            losses.append(sdt.fit_steps(b, 1))
            ms.append((time.perf_counter() - t0) * 1e3)
        tl = _flash_counts()
        print(f"[sd-bert] {name} fit_steps losses "
              f"{[round(v, 5) for v in losses]}; step ms "
              f"{[round(m, 3) for m in ms]}; launches {tl}")
        check(all(np.isfinite(losses)), f"{name} loss not finite")
        check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
        for k in FLASH_KERNELS:
            check(tl[k] == L * steps * on_card,
                  f"{name} {k}: {tl[k]} launches in {steps} steps, "
                  f"expected {L} a step")
        step_ms = float(np.median(ms[1:]))
        nat = (native or {}).get("train", {})
        nat = nat if dtype is None else nat.get("bfloat16", {})
        r = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
             "tokens_per_s": batch * t * 1e3 / step_ms, "launches": tl}
        print(f"[sd-bert] batch-{batch} t={t} {name} imported MLM step "
              f"{step_ms:.3f} ms (median of steps 2-{steps}) = "
              f"{r['tokens_per_s']:.1f} tokens/s; native Bert.fit_batch "
              f"{nat.get('median_step_ms', float('nan')):.3f} ms [{label}]")
        if on_card:
            r["profile"] = profile_device(
                torch, lambda: sdt.fit_steps(b, 1), step_ms,
                f"batch-{batch} t={t} {name} imported MLM step",
                shares=FLASH_KERNELS)
        return sdt, r

    sdt, res["f32"] = train(None)
    # ---- the zip round trip, from the trained f32 graph ----
    zdir = ROOT / "build" / "sd_bert"
    zdir.mkdir(parents=True, exist_ok=True)
    path = zdir / "sd_bert.zip"
    t0 = time.perf_counter()
    sdt.save(str(path))
    back = ModelSerializer.restore_model(path, device)
    res["zip_s"] = time.perf_counter() - t0
    res["zip_bytes"] = path.stat().st_size
    a = sdt.output(enc, ["Identity"])["Identity"]
    z = back.output(enc, ["Identity"])["Identity"]
    check(torch.equal(a, z) and back.iteration_count
          == sdt.iteration_count, "restored SameDiff output is not bitwise "
                                  "equal")
    print(f"[sd-bert] zip round trip ({res['zip_bytes']} bytes with Adam's "
          f"moments, {res['zip_s']:.2f}s): restore_model output bitwise "
          f"equal, iteration {back.iteration_count}")
    path.unlink()
    del sdt, back, a, z
    res["bf16"] = train("bfloat16")[1]
    return res


def sd_bert_card_vs_cpu(torch, device: str = "cuda", layers: int = 2,
                        batch: int = 2, t: int = 128) -> dict:
    """The imported BERT at full width and reduced depth on the card and
    on the CPU (the CPU on the card's route: the flash gate forced, so
    it runs the kernels' plain versions), TF32 off: the forward, and one
    SGD step of the MLM head held norm-wise against a float64 CPU step
    as ``train_card_vs_cpu`` holds ResNet-50's. ``device="cpu"``
    rehearses it without a card."""
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import (
        build_frozen_bert, import_and_attach_mlm)
    dims = dict(SD_BERT, layers=layers)
    n_pred = min(SD_PREDICTIONS, t // 2)
    gd = build_frozen_bert(t, batch, seed=1, **dims)
    g = torch.Generator().manual_seed(59)
    b = sd_bert_batch(torch, g, batch, t, dims["vocab"], "cpu", n_pred)

    def make(dev, dtype=None):
        return import_and_attach_mlm(
            gd, batch, t, vocab=dims["vocab"], hidden=dims["hidden"],
            updater=Sgd(0.1), dtype=dtype, max_predictions=n_pred,
            device=dev)[0]

    card, cpu, cpu64 = make(device), make("cpu"), make("cpu", "float64")
    names = [n for n, v in cpu.vars.items() if v.var_type.value == "VARIABLE"]
    p0 = {n: cpu._arrays[n].double().clone() for n in names}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f_card = card.output(_encoder_feeds(b), ["Identity"])["Identity"]
        l_card = card.fit_steps(b, 1)
        f_cpu, l_cpu, l_64 = _with_flash_gate(
            "1", lambda: (cpu.output(_encoder_feeds(b),
                                     ["Identity"])["Identity"],
                          cpu.fit_steps(b, 1), cpu64.fit_steps(b, 1)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = float((f_card.cpu() - f_cpu).abs().max())
    check(bool(torch.allclose(f_card.cpu(), f_cpu, rtol=BERT_FWD_RTOL,
                              atol=BERT_FWD_ATOL)),
          f"imported BERT forward card vs CPU: max |d| {err}")
    check(abs(l_card - l_cpu) <= LOSS_RTOL * abs(l_cpu),
          f"imported BERT loss card {l_card} vs cpu {l_cpu}")
    # the key bias has an exactly-zero gradient: held against a floor
    floor = BERT_UPDATE_FLOOR * max(
        float((cpu64._arrays[n] - p0[n]).norm()) for n in names)

    def dist(a, b_):
        return float((a - b_).norm() / b_.norm().clamp_min(floor))

    e_card = e_cpu = e_pair = 0.0
    worst = ""
    for n in names:
        d64 = cpu64._arrays[n].double() - p0[n]
        dcard = card._arrays[n].cpu().double() - p0[n]
        dcpu = cpu._arrays[n].double() - p0[n]
        ec = dist(dcard, d64)
        if ec > e_card:
            e_card, worst = ec, n
        e_cpu = max(e_cpu, dist(dcpu, d64))
        e_pair = max(e_pair, dist(dcard, dcpu))
    check(e_card <= UPDATE_FACTOR * e_cpu + UPDATE_FLOOR,
          f"imported BERT card updates {e_card:.3e} from the float64 step "
          f"({worst}), the CPU float32 step's {e_cpu:.3e}")
    print(f"[sd-bert-vs-cpu] imported BERT L={layers} H={dims['hidden']}, "
          f"batch {batch}, t={t} (TF32 off; CPU on the card's route): "
          f"forward max |d| {err:.3e}; SGD step loss {l_card:.7f} vs "
          f"{l_cpu:.7f} (f64 {l_64:.7f}); worst update in norm: card vs "
          f"f64 {e_card:.3e} ({worst}), CPU f32 vs f64 {e_cpu:.3e}, card vs"
          f" CPU f32 {e_pair:.3e}")
    return {"fwd_max_abs": err, "loss_card": l_card, "loss_cpu": l_cpu,
            "loss_cpu64": l_64, "update_card_vs_f64": e_card,
            "update_cpu32_vs_f64": e_cpu, "update_card_vs_cpu32": e_pair}


# ---------------------------------------------------------------------------
#: GPT-2 small's published widths (openai-community/gpt2 config.json:
#: n_layer 12, n_head 12, n_embd 768, n_inner 4 x 768, vocab_size 50257,
#: n_positions 1024, eos_token_id 50256) as a DecoderLM configuration
GPT2_SMALL = dict(vocab_size=50257, n_layers=12, n_heads=12, d_model=768,
                  d_ff=3072, max_len=1024, eos_id=50256)
#: the README's generate configuration, with a pool for 32 live sequences
GEN_CONFIG = {"kv_blocks": 1024, "kv_block_size": 16,
              "prompt_buckets": (64, 256), "decode_buckets": (8, 32),
              "max_seq_len": 1024}
GEN_REQUESTS, GEN_MAX_TOKENS = 32, 64
#: kernel 10 against its plain version on unit-normal inputs: the
#: reference's forward bar (tests/test_attention_pallas.py:38)
PAGED_ATOL = 2e-5
#: a greedy divergence from reference_decode is a tie only where the
#: reference's top-2 logit gap is below this
TIE_GAP = 1e-4
#: decode-step logits against the full forward's last position (f32,
#: full-f32 matmuls): float association only
DECODE_ATOL = 1e-4


def _paged_case(torch, b, h, d, block, max_blocks, lengths, pool_dtype, g,
                dead=0):
    """Inputs of one decode site: q [b, h, d] f32, pools holding every
    sequence's blocks at random places (block 0 scratch), tables padded
    with 0, ``dead`` trailing dead slots (zero table, length 1)."""
    nb = b * max_blocks + 1
    q = torch.randn(b, h, d, device="cuda", generator=g)
    k, v = (torch.randn(nb, block, h, d, device="cuda", generator=g
                        ).to(pool_dtype) for _ in range(2))
    perm = torch.randperm(nb - 1, device="cuda", generator=g) + 1
    tables = torch.zeros(b, max_blocks, dtype=torch.int32, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        used = min(max_blocks, -(-n // block))
        tables[i, :used] = perm[i * max_blocks:i * max_blocks + used]
    if dead:
        tables[b - dead:] = 0
        lens[b - dead:] = 1
    return q, k, v, tables, lens


def _paged_costs(b, h, d, lengths, block, max_blocks, esize):
    """(bytes, operations) of one site: the valid tokens' K and V rows,
    q and out (f32), the table entries the kernel reads and the lengths;
    2 operations a multiply-add (q.k and p.v)."""
    tok = sum(min(n, block * max_blocks) for n in lengths)
    blocks = sum(min(max_blocks, -(-n // block)) for n in lengths)
    return (2 * tok * h * d * esize + 2 * b * h * d * 4 + 4 * blocks
            + 4 * b), 4 * tok * h * d


def _misaligned_pools(torch, k, v):
    """Copies of the pools one element off 16-byte alignment (contiguous
    views into a longer buffer): the same shape on kernel 10's general
    body, to time it beside the staged one."""
    out = []
    for t in (k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        out.append(buf[1:].view(t.shape))
    return out


#: lengths around kernel 10's cluster split at GPT-2-small's 64-block
#: tables (P = 2 ranks, rank r folding valid blocks [r n / 2, (r + 1) n /
#: 2)): the edge of the full table +-1, 2 blocks (one a rank) +-1, 3
#: blocks, and 1 block (a rank with no valid token)
PAGED_EDGES = [511, 512, 513, 31, 32, 33, 48, 1, 15, 16, 17, 1023, 1024]


def phase_paged_kernel(torch) -> dict:
    """Kernel 10 against its plain version at GPT-2-small's decode sites
    and more shapes, naming the body each takes; then its time over the
    12 sites of a batch-32 decode step at L=512 and 1024 (CUDA-graph
    replay), f32 and bf16 pools, beside the bytes bound and the plain
    version, on the staged body (the path) and on the general body (the
    same shape with the pools one element off alignment)."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    g = torch.Generator(device="cuda").manual_seed(23)
    mixed = [1, 15, 16, 17, 511, 1024]
    cases = []
    for b in (8, 32):
        lens = [mixed[i % len(mixed)] for i in range(b)]
        lens[-3] = 64 * 16 + 6               # past the table: clamped
        cases.append((b, 12, 64, 16, 64, lens, 2))
    cases += [(len(PAGED_EDGES) + 2, 12, 64, 16, 64,
               PAGED_EDGES + [64 * 16 + 6, 1], 1),
              (6, 5, 80, 8, 9, [1, 7, 8, 9, 40, 72], 1),
              (4, 4, 32, 16, 8, [3, 16, 33, 128], 1),
              (4, 4, 128, 16, 8, [3, 16, 33, 128], 1),
              (4, 2, 256, 16, 8, [3, 16, 33, 128], 1)]
    err = 0.0
    bodies = {}
    for b, h, d, block, mb, lens, dead in cases:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            what = f"b={b} h={h} d={d} block={block} {str(dt)[6:]} pool"
            args = _paged_case(torch, b, h, d, block, mb, lens, dt, g, dead)
            variants = [("aligned", args)]
            if d == 64 and b == 32:
                variants.append(("misaligned", (args[0], *_misaligned_pools(
                    torch, args[1], args[2]), *args[3:])))
            for tag, a in variants:
                body = ak.paged_decode_body(*a[:4])
                bodies[f"{what} {tag}"] = body
                out = ak.paged_decode_attention(*a)
                out2 = ak.paged_decode_attention(*a)
                ref = ak.paged_attention_reference(*a)
                torch.cuda.synchronize()
                check(torch.equal(out, out2), f"{what} {tag} ({body}): two "
                                              f"launches differ")
                check(not bool(torch.isnan(out).any()), f"{what}: NaN")
                e = float((out - ref).abs().max())
                check(e <= PAGED_ATOL, f"{what} {tag} ({body}): max |kernel"
                                       f" - plain| {e:.3e} beyond "
                                       f"{PAGED_ATOL}")
                err = max(err, e)
    print(f"[paged] paged_decode == plain within {PAGED_ATOL} at "
          f"{len(cases)} shapes x f32/bf16/f16 pools (lengths 1..1024, "
          f"every partition edge of the cluster split +-1, dead slots, a "
          f"length past the table; d 32..256, h=5 d=80 block 8; the "
          f"batch-32 sites also on misaligned pools), bitwise across two "
          f"launches, no NaN; max |kernel - plain| {err:.3e}")
    for k, v in bodies.items():
        print(f"[paged]   {k}: {v}")

    timing = {}
    b, h, d, block, mb = BATCH, 12, 64, 16, 64
    for L in (512, 1024):
        for dt in (torch.float32, torch.bfloat16):
            short = str(dt)[6:]
            esize = torch.tensor([], dtype=dt).element_size()
            sites = [_paged_case(torch, b, h, d, block, mb, [L] * b, dt, g)
                     for _ in range(12)]
            general = [(s_[0], *_misaligned_pools(torch, s_[1], s_[2]),
                        *s_[3:]) for s_ in sites]
            kern = lambda: [ak.paged_decode_attention(*s) for s in sites]  # noqa: E731
            gen = lambda: [ak.paged_decode_attention(*s) for s in general]  # noqa: E731
            plain = lambda: [ak.paged_attention_reference(*s)  # noqa: E731
                             for s in sites]
            by, ops = _paged_costs(b, h, d, [L] * b, block, mb, esize)
            bound, bound_by = _bound(12 * by, 12 * ops, F32_FLOPS)
            k_ms = _graph_ms(torch, kern, reps=5)
            g_ms = _graph_ms(torch, gen, reps=5)
            p_ms = _graph_ms(torch, plain, reps=1)
            timing[f"{short}_L{L}"] = {
                "kernel_ms": k_ms, "general_body_ms": g_ms, "plain_ms": p_ms,
                "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
                "bytes": 12 * by, "body": ak.paged_decode_body(*sites[0][:4]),
                "eager_ms": _time_ms(torch, kern, reps=5)}
            print(f"[paged] {short} pool, L={L}, 12 sites of a batch-{b} "
                  f"GPT-2-small decode step: kernel {k_ms:.4f} ms "
                  f"({100 * bound / k_ms:.0f} % of the bound; general body "
                  f"{g_ms:.4f} ms), plain {p_ms:.4f} ms, library none, bound "
                  f"{bound:.4f} ms ({bound_by}; {12 * by / 1e9:.3f} GB), "
                  f"{12 * by / k_ms / 1e6:.0f} GB/s achieved, eager "
                  f"{timing[f'{short}_L{L}']['eager_ms']:.4f} ms")
            del sites, general
            torch.cuda.empty_cache()
    return {"max_abs_err": err, "timing": timing, "bodies": bodies}


def _gen_client(url: str, prompt, max_tokens: int) -> dict:
    """One streaming greedy request; token arrival times on the client's
    clock."""
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_tokens": max_tokens}).encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    toks, times, done = [], [], None
    with urllib.request.urlopen(req, timeout=300) as resp:
        code = resp.status
        for line in resp:
            rec = json.loads(line)
            if "token" in rec:
                toks.append(rec["token"])
                times.append(time.perf_counter() - t0)
            else:
                done = rec
    return {"code": code, "tokens": toks, "times": times, "done": done,
            "t0": t0, "t_end": time.perf_counter()}


def _gen_load(url: str, prompts, max_tokens: int) -> list:
    """Every prompt as a concurrent streaming request, one thread each;
    run in a process of its own, so the clients do not share the server's
    interpreter. One ``GET /healthz`` first: a fresh process's first
    urllib calls, made by 32 threads at once, cost up to a second that
    would be counted as time to first token."""
    with urllib.request.urlopen(url.split("/v1/")[0] + "/healthz",
                                timeout=60) as resp:
        resp.read()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        return list(ex.map(lambda p: _gen_client(url, p, max_tokens),
                           prompts))


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def _check_against_reference(torch, model, params, prompt, got, what):
    """``got`` against ``model.reference_decode``; a divergence passes
    only where the reference's top-2 logit gap is below TIE_GAP (a tie:
    the comparison stops there). Returns the tokens compared."""
    ref = model.reference_decode(params, prompt, len(got))
    for i, (a, r) in enumerate(zip(got, ref)):
        if a == r:
            continue
        with torch.inference_mode():
            ids = torch.tensor([list(prompt) + ref[:i]], device=model.device)
            logits, _, _ = model.forward_with_kv(params, ids)
        top2 = torch.topk(logits[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        check(gap < TIE_GAP, f"{what}: token {i} is {a}, reference_decode "
                             f"says {r} (top-2 gap {gap:.3e})")
        print(f"[generate] {what}: tie at token {i} (served {a}, reference "
              f"{r}, top-2 gap {gap:.3e}); comparison stops there")
        return i
    check(len(ref) == len(got) or ref[-1] == model.conf.eos_id,
          f"{what}: reference_decode gave {len(ref)} tokens, served "
          f"{len(got)}")
    return len(got)


def _decode_vs_forward(torch, model, pool, params, prompt, max_blocks: int,
                       paged: bool):
    """One decode step's logits (the last prompt token, batch padded to 8
    with dead slots) against the full forward's last position: max |d|."""
    import numpy as np
    n = len(prompt)
    seq = "decode-vs-forward"
    table = pool.alloc(seq, n)
    try:
        with torch.inference_mode():
            _, k, v = model.prefill(params, np.asarray([prompt[:-1]]),
                                    np.asarray([n - 1]))
            bs = pool.block_size
            slots = torch.tensor([table[t // bs] * bs + t % bs
                                  for t in range(n - 1)], device=pool.device)
            nl, nb = pool.k.shape[:2]
            pool.k.view(nl, nb * bs, *pool.k.shape[3:])[:, slots] = \
                k[:, 0].to(pool.k.dtype)
            pool.v.view(nl, nb * bs, *pool.v.shape[3:])[:, slots] = \
                v[:, 0].to(pool.v.dtype)
            tables = np.zeros((8, max_blocks), np.int32)
            tables[0] = pool.padded_table(seq, tables.shape[1])
            tokens = np.zeros(8, np.int32)
            positions = np.zeros(8, np.int32)
            tokens[0], positions[0] = prompt[-1], n - 1
            step, _, _ = model.decode_step(params, tokens, positions,
                                           pool.k, pool.v, tables,
                                           paged=paged)
            full, _, _ = model.forward_with_kv(params, np.asarray([prompt]))
        return float((step[0] - full[0, -1]).abs().max())
    finally:
        pool.free(seq)


def _synthetic_step(torch, engine, L: int, b: int):
    """A decode step's host arrays for ``b`` sequences at length ``L``
    (blocks allocated, contents whatever the pool holds): for timing."""
    import numpy as np
    args = engine._decode_args(b)
    for i in range(b):
        engine.pool.alloc(("synthetic", i), L)
        args[1][i] = L - 1
        args[2][i] = engine.pool.padded_table(("synthetic", i),
                                              engine.max_blocks)
        args[0][i] = 7
    return args


def phase_generate(torch, label: str, device: str = "cuda", conf=None,
                   gen=None, kv_dtype: str = "float32",
                   requests: int = GEN_REQUESTS,
                   max_tokens: int = GEN_MAX_TOKENS, checked: int = 8,
                   tokens_f32=None) -> dict:
    """Generative serving at GPT-2-small width: a seeded DecoderLM
    registered with ``gen`` (default GEN_CONFIG) and served over HTTP,
    ``requests`` concurrent streaming greedy requests. TF32 off (the
    model's matmuls in full f32). ``device="cpu"`` with a small ``conf``
    and ``gen`` rehearses the phase without a card (launch counts,
    timings and the profile are the card's)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving import (AdmissionController,
                                                  InferenceServer,
                                                  ModelRegistry)
    conf = conf or DecoderConfig(**GPT2_SMALL)
    gen = dict(gen or GEN_CONFIG, kv_dtype=kv_dtype)
    on_card = device == "cuda"
    tag = f"[generate {kv_dtype}]"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DecoderLM(conf)
    t0 = time.perf_counter()
    params = model.init(device, seed=41)
    print(f"{tag} DecoderLM L={conf.n_layers} d={conf.d_model} "
          f"h={conf.n_heads} ff={conf.d_ff} vocab {conf.vocab_size}, "
          f"{model.num_params()} params seeded on {device} in "
          f"{time.perf_counter() - t0:.2f}s; generate={gen}")
    rs = np.random.RandomState(43)
    lo, hi = min(gen["prompt_buckets"]) // 4, max(gen["prompt_buckets"])
    lens = rs.randint(lo, hi + 1, size=requests)
    lens[0] = hi                                  # the longest prompt
    prompts = [rs.randint(0, conf.vocab_size - 1, size=n).tolist()
               for n in lens]
    reg = ModelRegistry(device)
    srv = None
    try:
        # ---- the main path: counts to 0, register (warmup), serve ----
        _zero_counts()
        t_reg = time.perf_counter()
        ver = reg.register("lm", model, generate=gen)
        t_reg = time.perf_counter() - t_reg
        engine = ver.batcher.engine
        # generate admission is by token cost (KV blocks of prompt and
        # completion): the budget is the pool's usable blocks
        srv = InferenceServer(reg, AdmissionController(
            max_queue=gen["kv_blocks"] - 1)).start(0)
        url = f"{srv.url}/v1/models/lm:generate"
        since_us = time.time() * 1e6          # this run's trace spans
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as ex:
            results = ex.submit(_gen_load, url, prompts, max_tokens
                                ).result()
        # the serving window on the clients' clock (perf_counter is the
        # system's monotonic clock, shared by both processes)
        t_serve = (max(r["t_end"] for r in results)
                   - min(r["t0"] for r in results))
        _sync(torch, device)
        launches = _counts()
        steps = engine.decode_steps
        print(f"{tag} main path: register (warmup {t_reg:.2f}s) + "
              f"{requests} concurrent streaming requests, prompts "
              f"{int(lens.min())}..{int(lens.max())} tokens, max_tokens "
              f"{max_tokens}; decode steps {steps}; launches {launches}")
        want = {k: 0 for k in launches}
        want["paged_decode"] = conf.n_layers * steps * on_card
        check(launches == want, f"launches {launches}, expected {want} "
                                f"({conf.n_layers} a decode step)")
        check(engine.retraces_since_warmup() == 0,
              f"{engine.retraces_since_warmup()} retraces after warmup")
        for r in results:
            check(r["code"] == 200 and r["done"] is not None
                  and r["done"]["tokens"] == len(r["tokens"]),
                  f"a stream ended badly: {r['code']} {r['done']}")
            check(len(r["tokens"]) == max_tokens
                  or r["done"]["reason"] == "eos",
                  f"a stream stopped early: {r['done']}")
        pool = engine.pool
        check(pool.live_blocks == 0 and pool.free_blocks
              == pool.usable_blocks, f"pool not freed: {pool.report()}")
        result = {"launches": launches, "decode_steps": steps,
                  "tokens": [r["tokens"] for r in results]}

        # ---- greedy tokens against reference_decode ----
        if tokens_f32 is None:
            n_cmp = 0
            for i in range(min(checked, requests)):
                n_cmp += _check_against_reference(
                    torch, model, params, prompts[i], results[i]["tokens"],
                    f"request {i} ({len(prompts[i])}-token prompt)")
            print(f"{tag} {min(checked, requests)} requests (the longest "
                  f"prompt among them) == reference_decode over {n_cmp} "
                  f"tokens")
            d_paged = _decode_vs_forward(torch, model, pool, params,
                                         prompts[1], engine.max_blocks,
                                         paged=on_card)
            check(d_paged <= DECODE_ATOL, f"decode step vs forward: max "
                                          f"|d| {d_paged:.3e}")
            print(f"{tag} one decode step's logits (route "
                  f"{'kernel 10' if on_card else 'plain'}) vs the full "
                  f"forward's last position: max |d| {d_paged:.3e} "
                  f"(bar {DECODE_ATOL})")
            result.update(compared_tokens=n_cmp, decode_vs_forward=d_paged)
        else:
            # the prefill never reads the pool: first tokens are the f32
            # run's; later tokens read bf16 K/V
            same = sum(a == b for r, f in zip(results, tokens_f32)
                       for a, b in zip(r["tokens"], f))
            total = sum(len(f) for f in tokens_f32)
            check(all(r["tokens"][0] == f[0]
                      for r, f in zip(results, tokens_f32)),
                  "bf16 pool changed a first token")
            print(f"{tag} tokens equal to the f32-pool run's: {same} of "
                  f"{total} (first tokens all equal)")
            result["agree_with_f32"] = same / max(1, total)
        pool_bytes = pool.pool_bytes

        # ---- serving numbers (client clock) ----
        ttft = [r["times"][0] * 1e3 for r in results if r["times"]]
        gaps = [(b_ - a) * 1e3 for r in results
                for a, b_ in zip(r["times"], r["times"][1:])]
        n_tok = sum(len(r["tokens"]) for r in results)
        spans = [e for e in _trace_events() if e["ts"] >= since_us]
        steps32 = [e["dur"] / 1e3 for e in spans
                   if e["name"] == "generate.decode_step"
                   and e["args"].get("bucket") == max(gen["decode_buckets"])]
        prefills = [e["dur"] / 1e3 for e in spans
                    if e["name"] == "generate.prefill"]
        result.update(
            ttft_ms_p50=_pct(ttft, 50), ttft_ms_max=max(ttft),
            intertoken_ms_p50=_pct(gaps, 50), intertoken_ms_p99=_pct(gaps,
                                                                     99),
            tokens_per_s=n_tok / t_serve, serve_s=t_serve,
            decode_step_ms_p50=_pct(steps32, 50),
            prefill_ms_p50=_pct(prefills, 50), pool_bytes=pool_bytes)
        print(f"{tag} TTFT p50 {result['ttft_ms_p50']:.3f} ms max "
              f"{result['ttft_ms_max']:.3f} ms; inter-token p50 "
              f"{result['intertoken_ms_p50']:.3f} ms p99 "
              f"{result['intertoken_ms_p99']:.3f} ms; {n_tok} tokens in "
              f"{t_serve:.3f}s = {result['tokens_per_s']:.1f} tokens/s; "
              f"decode step at bucket {max(gen['decode_buckets'])}: median "
              f"{result['decode_step_ms_p50']:.3f} ms over {len(steps32)} "
              f"steps; prefill (bucket-padded prompt + K/V scatter + first "
              f"token) median {result['prefill_ms_p50']:.3f} ms over "
              f"{len(prefills)}; pool {pool_bytes / 1e9:.3f} GB [{label}]")
        if on_card:
            b = max(gen["decode_buckets"])
            # the served run's mean length, and 480: the longest a batch
            # of 32 fits in the 1023 usable blocks at 16 tokens a block
            for L in (int(np.mean(lens)) + max_tokens // 2, 480):
                args = _synthetic_step(torch, engine, L, b)
                try:
                    fn = lambda: engine._decode(*args)  # noqa: E731
                    fn()
                    ms = sorted(_host_ms(torch, fn) for _ in range(3))[1]
                    prof = profile_device(
                        torch, fn, ms, f"batch-{b} decode step at L={L}")
                    k_ms = sum(t["ms"] for t in prof.get("top", [])
                               if "paged_decode" in t["kernel"])
                    share = k_ms / prof["device_busy_ms"] if prof else None
                    print(f"{tag} synthetic decode step, batch {b}, L={L}: "
                          f"{ms:.3f} ms; kernel 10 {k_ms:.3f} ms = "
                          f"{share:.3f} of device busy [{label}]")
                    result[f"step_L{L}"] = {"ms": ms, "profile": prof,
                                            "kernel10_ms": k_ms,
                                            "kernel10_share": share}
                finally:
                    for i in range(b):
                        engine.pool.free(("synthetic", i))
        return result
    finally:
        if srv is not None:
            srv.stop()
        reg.shutdown()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _trace_events():
    from deeplearning4j_tpu_torch.common import telemetry
    return telemetry.trace_events()


def _host_ms(torch, fn, reps: int = 5) -> float:
    """Host wall time of one ``fn()`` that ends in a synchronising copy."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def decoder_card_vs_cpu(torch, device: str = "cuda", layers: int = 2
                        ) -> dict:
    """GPT-2-small widths at 2 layers (vocab 50257), TF32 off: the
    prefill of two padded prompts and one paged decode step (kernel 10 on
    the card, its plain version on the CPU) on the card and on the CPU;
    logits and K/V within DECODE_ATOL."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
    conf = DecoderConfig(**dict(GPT2_SMALL, n_layers=layers))
    cpu = DecoderLM(conf)
    cpu.init("cpu", seed=47)
    card = DecoderLM(conf)
    card.set_params(cpu.params, device)
    rs = np.random.RandomState(47)
    prompts = [rs.randint(0, conf.vocab_size - 1, size=n).tolist()
               for n in (40, 64)]
    tokens = np.zeros((2, 64), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = np.asarray([40, 64], np.int32)
    nb, bs = 16, 16
    tables = np.asarray([[1, 2, 3, 0, 0, 0, 0, 0],
                         [5, 6, 7, 8, 9, 0, 0, 0]], np.int32)
    step_tok = np.asarray([11, 12], np.int32)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, m in (("card", card), ("cpu", cpu)):
            with torch.inference_mode():
                last, k, v = m.prefill(m.params, tokens, lengths)
                shape = (layers, nb, bs, conf.n_heads, conf.head_dim)
                kp = torch.zeros(shape, device=m.device)
                vp = torch.zeros(shape, device=m.device)
                for i, n in enumerate(lengths):
                    for t in range(n):
                        kp[:, tables[i, t // bs], t % bs] = k[:, i, t]
                        vp[:, tables[i, t // bs], t % bs] = v[:, i, t]
                logits, kp, vp = m.decode_step(m.params, step_tok, lengths,
                                               kp, vp, tables, paged=True)
            out[name] = [t.cpu() for t in (last, k, v, logits, kp, vp)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    errs = {}
    for i, nm in enumerate(("prefill logits", "prefill k", "prefill v",
                            "decode logits", "pool k", "pool v")):
        e = float((out["card"][i] - out["cpu"][i]).abs().max())
        check(e <= DECODE_ATOL, f"decoder card vs CPU {nm}: max |d| {e:.3e}")
        errs[nm] = e
    print(f"[decoder-vs-cpu] GPT-2-small widths at {layers} layers, prefill "
          f"of 40- and 64-token prompts (bucket 64) and one paged decode "
          f"step, card (kernel 10) vs CPU (plain), TF32 off: max |d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
#: kernel 4 beyond SqueezeNet's own shapes: a ragged M with N off the
#: tile, K = 16 with N = 16, a K and N below every tile width, and the
#: head with one more row
POINTWISE_EXTRA = ((1001, 40, 37), (777, 16, 16), (129, 7, 3),
                   (6273, 512, 1000))


def pointwise_sites(conf, batch: int):
    """(M, K, N, act) of every pointwise conv site of a forward."""
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    from deeplearning4j_tpu_torch.ops.conv_epilogue import _is_pointwise
    types = conf.resolve_shapes()
    sites = []
    for name in conf.topo_order():
        v = conf.vertices[name]
        c = v.content
        if isinstance(c, ConvolutionLayer) and _is_pointwise(
                (c.n_out, c.n_in) + c.kernel_size, c.stride, c.dilation,
                c._pad_cfg()):
            t = types[name]
            sites.append((batch * t.height * t.width,
                          types[v.inputs[0]].channels, t.channels,
                          c.activation.value))
    return sites


def _mba_check(torch, ce, x, w, b, act: str, what: str) -> dict:
    """Kernel 4 against its plain version: per element
    ``|kernel - plain| <= 2e-5 * (sum_k |x_k w_k| + |b|)`` against the
    plain f32 result (f32 FMAs summed in another order), plus one ulp
    of the output dtype for bf16 and f16 (the kernel rounds its own f32
    sum); NaN in the same places; bitwise equal across two launches.
    Returns the max |kernel - plain f32| and the max err / bar."""
    dt = x.dtype
    y = ce.matmul_bias_act_forward(x, w, b, act)
    y2 = ce.matmul_bias_act_forward(x, w, b, act)
    ref = ce.matmul_bias_act_plain(x.float(), w.float(), b, act)
    bar = 2e-5 * (x.float().abs() @ w.float().abs().t() + b.abs())
    if dt != torch.float32:
        _, e = torch.frexp(ref.abs().nan_to_num(0.0))
        bar = bar + torch.ldexp(torch.full_like(ref, torch.finfo(dt).eps),
                                e - 1)
    torch.cuda.synchronize()
    bits = torch.int32 if dt == torch.float32 else torch.int16
    same_nan = torch.equal(torch.isnan(y), torch.isnan(ref))
    err = (y.float() - ref).abs().nan_to_num(0.0)
    ratio = float((err / bar.nan_to_num(0.0).clamp_min(1e-30)).max())
    check(y.dtype == dt and tuple(y.shape) == tuple(ref.shape)
          and torch.equal(y.view(bits), y2.view(bits)) and same_nan
          and ratio <= 1.0,
          f"matmul_bias_act {what}: max err/bar {ratio}, NaN positions "
          f"equal: {same_nan}, repeatable: "
          f"{torch.equal(y.view(bits), y2.view(bits))}")
    return {"max_abs_err": float(err.max()), "ratio": ratio}


def phase_pointwise(torch) -> dict:
    """Kernel 4 against its plain version at every pointwise site shape
    of SqueezeNet's batch-8 and batch-32 buckets and ``POINTWISE_EXTRA``,
    f32/bf16/f16, relu and identity, NaN rows; then CUDA-graph timings
    of the kernel, the plain version and ``_addmm_activation`` over the
    17 sites of a batch-32 forward, beside the bound; then one backward
    through the autograd Function against the plain one. Matmuls of the
    plain versions run in full f32 (TF32 off)."""
    from deeplearning4j_tpu_torch.models import SqueezeNet
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _pointwise(torch, ce, SqueezeNet().conf())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _pointwise(torch, ce, conf) -> dict:
    g = torch.Generator(device="cuda").manual_seed(17)
    sites = pointwise_sites(conf, BATCH)
    check(len(sites) == 17, f"SqueezeNet has {len(sites)} pointwise "
                            f"sites, expected 17")
    shapes = sorted({s[:3] for s in pointwise_sites(conf, 8) + sites}
                    | set(POINTWISE_EXTRA))
    errs = {d: {"max_abs_err": 0.0, "ratio": 0.0} for d in DTYPES}
    for M, K, N in shapes:
        for dname in DTYPES:
            dt = getattr(torch, dname)
            for act in ("relu", "identity"):
                x = torch.randn(M, K, device="cuda", generator=g).to(dt)
                x[::997, K // 2] = float("nan")
                w = (torch.randn(N, K, device="cuda", generator=g)
                     / K ** 0.5).to(dt)
                b = 0.1 * torch.randn(N, device="cuda", generator=g)
                r = _mba_check(torch, ce, x, w, b, act,
                               f"[{M},{K}]x[{N},{K}] {dname} {act}")
                for k in r:
                    errs[dname][k] = max(errs[dname][k], r[k])
    print(f"[pointwise] matmul_bias_act within its bar at {len(shapes)} "
          f"(M, K, N) shapes x {'/'.join(DTYPES)} x relu/identity, NaN "
          f"rows propagated, bitwise across two launches; "
          + ", ".join(f"{d} max |d| {e['max_abs_err']:.3e} (err/bar "
                      f"{e['ratio']:.3f})" for d, e in errs.items()))

    groups: dict = {}
    for site in sites:
        groups[site] = groups.get(site, 0) + 1
    bodies = _pointwise_bodies(torch, ce, sorted(groups))

    timing = {}
    for dname in DTYPES:
        dt = getattr(torch, dname)
        esize = torch.tensor([], dtype=dt).element_size()
        peak = F32_FLOPS if dt == torch.float32 else BF16_FLOPS
        tot = {"kernel": 0.0, "plain": 0.0, "library": 0.0,
               "kernel_eager": 0.0, "bound": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0}
        per_shape = []
        for (M, K, N, act), n in sorted(groups.items()):
            n_buf = max(1, int(-(-100e6 // (M * K * esize))))
            xs = [torch.randn(M, K, device="cuda", generator=g).to(dt)
                  for _ in range(n_buf)]
            w = (torch.randn(N, K, device="cuda", generator=g)
                 / K ** 0.5).to(dt)
            b = 0.1 * torch.randn(N, device="cuda", generator=g)
            b_l, w_t = b.to(dt), w.t()
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % n_buf
                return xs[it["i"]]

            def kern():
                return ce.matmul_bias_act_forward(nxt(), w, b, act)

            def plain():
                return ce.matmul_bias_act_plain(nxt(), w, b, act)

            def lib():
                if act == "relu":
                    return torch._addmm_activation(b_l, nxt(), w_t)
                return torch.addmm(b_l, nxt(), w_t)
            k_ms, p_ms, l_ms = (_graph_ms(torch, f)
                                for f in (kern, plain, lib))
            host_ms = _time_ms(torch, kern)
            site_bytes = (M * K + N * K + M * N) * esize + N * 4
            ops = 2 * M * K * N
            bound, by = _bound(site_bytes, ops, peak)
            tot["kernel"] += n * k_ms
            tot["plain"] += n * p_ms
            tot["library"] += n * l_ms
            tot["kernel_eager"] += n * host_ms
            tot["bound"] += n * bound
            tot["bytes_ms" if by == "bytes" else "ops_ms"] += n * bound
            per_shape.append({"M": M, "K": K, "N": N, "act": act,
                              "sites": n, "kernel_ms": k_ms,
                              "plain_ms": p_ms, "library_ms": l_ms,
                              "eager_ms": host_ms, "bound_ms": bound,
                              "bound_by": by,
                              "TFLOPs": ops / k_ms / 1e9,
                              "GBps": site_bytes / k_ms / 1e6})
            del xs
        bound_by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] \
            else "operations"
        timing[dname] = {
            "kernel_ms": tot["kernel"], "plain_ms": tot["plain"],
            "library_ms": tot["library"], "bound_ms": tot["bound"],
            "bound_by": bound_by, "eager_ms": tot["kernel_eager"],
            "bytes_bound_sites_ms": tot["bytes_ms"],
            "ops_bound_sites_ms": tot["ops_ms"], "per_shape": per_shape}
        print(f"[pointwise] {dname} batch-{BATCH} forward, 17 sites: kernel "
              f"{tot['kernel']:.4f} ms, plain {tot['plain']:.4f} ms, "
              f"_addmm_activation {tot['library']:.4f} ms, bound "
              f"{tot['bound']:.4f} ms (sum of per-site bounds: "
              f"{tot['bytes_ms']:.4f} ms bytes-bound, {tot['ops_ms']:.4f} "
              f"ms operations-bound); device time (CUDA graph replay); "
              f"eager launches {tot['kernel_eager']:.4f} ms")
        for r in per_shape:
            print(f"[pointwise]   [{r['M']},{r['K']}]x[{r['N']}] "
                  f"{r['act']} x{r['sites']}: kernel {r['kernel_ms']:.4f} "
                  f"plain {r['plain_ms']:.4f} lib {r['library_ms']:.4f} "
                  f"eager {r['eager_ms']:.4f} bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), {r['TFLOPs']:.1f} TFLOP/s, "
                  f"{r['GBps']:.0f} GB/s")

    # one backward over the 17 sites, f32: the Function (kernel forward,
    # the JAX package's _mba_bwd products) against autograd through the
    # plain version
    fn_ms = plain_ms = 0.0
    for (M, K, N, act), n in sorted(groups.items()):
        x = torch.randn(M, K, device="cuda", generator=g).requires_grad_()
        w = (torch.randn(N, K, device="cuda", generator=g)
             / K ** 0.5).requires_grad_()
        b = (0.1 * torch.randn(N, device="cuda", generator=g)
             ).requires_grad_()
        dy = torch.randn(M, N, device="cuda", generator=g)
        y_fn = ce.matmul_bias_act(x, w, b, act)
        y_pl = ce.matmul_bias_act_plain(x, w, b, act)
        fn_ms += n * _time_ms(torch, lambda: torch.autograd.grad(
            y_fn, (x, w, b), dy, retain_graph=True), reps=5)
        plain_ms += n * _time_ms(torch, lambda: torch.autograd.grad(
            y_pl, (x, w, b), dy, retain_graph=True), reps=5)
    print(f"[pointwise] f32 backward over the 17 sites: Function "
          f"{fn_ms:.4f} ms, autograd through the plain version "
          f"{plain_ms:.4f} ms (eager, CUDA events)")
    return {"max_abs_err": errs["float32"]["max_abs_err"], "errs": errs,
            "timing": timing, "bodies": bodies,
            "backward_ms": {"function": fn_ms, "plain": plain_ms}}


def _pointwise_bodies(torch, ce, sites) -> dict:
    """The body kernel 4 takes at each (M, K, N, act) site of a batch-32
    SqueezeNet forward in each dtype (one line), and the host cost of
    the Hopper body's tensor-map encoding at the classifier site."""
    bodies = {}
    for M, K, N, _ in sites:
        row = {}
        for dname in DTYPES:
            dt = getattr(torch, dname)
            x = torch.empty(M, K, device="cuda", dtype=dt)
            w = torch.empty(N, K, device="cuda", dtype=dt)
            row[dname] = ce.matmul_bias_act_body(x, w)
        bodies[f"[{M},{K}]x[{N}]"] = row
    print("[pointwise] bodies at the 17 sites (f32 | bf16 | f16): "
          + "; ".join(f"{site} {r['float32']} | {r['bfloat16']} | "
                      f"{r['float16']}" for site, r in bodies.items()))
    M, K, N, _ = max(sites, key=lambda s: s[1] * s[2])
    x = torch.empty(M, K, device="cuda", dtype=torch.bfloat16)
    w = torch.empty(N, K, device="cuda", dtype=torch.bfloat16)
    ns = ce.matmul_tensor_map_ns(x, w)
    print(f"[pointwise] tensor-map encoding (host, x's and W's maps) at "
          f"[{M},{K}]x[{N}]: {ns:.1f} ns a launch (mean of 1000)")
    bodies["tensor_map_ns"] = ns
    return bodies


def seeded_squeezenet(torch, device: str, seed: int = 9,
                      calibrate: bool = True, **kw):
    """Full-width SqueezeNet with weights from a seeded generator (the
    zoo's ReLU init) and every bias set from the same generator, so the
    epilogues add a bias that is not 0. The pooled features of random
    weights are nearly the same for every image (averages of relu
    outputs), so the output layer is calibrated on a batch from the same
    generator: its bias takes away the mean feature's logits and its
    weights are scaled to logits of standard deviation 2, which gives
    each image its own top class. ``calibrate=False`` keeps the zoo's
    output layer (a training start: the calibrated scale gives images
    unlike the calibration batch logits in the hundreds)."""
    from deeplearning4j_tpu_torch.models import SqueezeNet
    g = torch.Generator().manual_seed(seed)
    net = SqueezeNet(**kw).init(device, generator=g)
    for sub in net.params.values():
        if "b" in sub:
            sub["b"] = (0.05 * torch.randn(sub["b"].shape, generator=g)
                        ).to(device)
    if not calibrate:
        return net
    conf = net.conf
    x = torch.randn(8, conf.input_types[0].height,
                    conf.input_types[0].width, 3, generator=g)
    acts = {"input": x.to(device)}
    with torch.inference_mode():
        for name in net._topo:
            if name == "output":
                break
            v = conf.vertices[name]
            xs = [acts[i] for i in v.inputs]
            acts[name] = (v.content.forward(xs) if not v.is_layer else
                          v.content.forward(net.params[name], xs[0],
                                            training=False)[0])
        f = acts["gap"].float()
        w = net.params["output"]["W"]
        w = w * (2.0 / float(((f - f.mean(0)) @ w).std()))
    # clones made outside inference mode: parameters a fit can train
    net.params["output"]["W"] = w.clone()
    net.params["output"]["b"] = -(f.mean(0) @ w).clone()
    return net


def phase_squeezenet(torch, device: str = "cuda", image: int = 224,
                     label: str = "cpu") -> dict:
    """Serve a full-width SqueezeNet (seeded weights) over HTTP through
    the registry and batcher: 17 launches of kernel 4 and 9 of kernel 1
    a forward and nothing else; answers == ``net.output`` bitwise; card
    against CPU (TF32 off); a bf16 forward; img/s at batch 32, latencies
    and the device's busy/idle share."""
    from deeplearning4j_tpu_torch.models import SqueezeNet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import cuda_build

    kw = {} if image == 224 else {"height": image, "width": image}
    t0 = time.perf_counter()
    net = seeded_squeezenet(torch, device, **kw)
    print(f"[squeezenet] SqueezeNet {image}x{image}x3 -> 1000, "
          f"{net.num_params()} params on {device}, built in "
          f"{time.perf_counter() - t0:.2f}s")
    result = serve_burst(torch, net, "squeezenet", image, device,
                         "squeezenet", label)
    x8, x32 = result.pop("x8"), result.pop("x32")
    launches, n_fwd = result["launches"], result["forwards"]
    ds = result["dispatches"]
    if device == "cuda":
        want = {k: {"matmul_bias_act": 17 * n_fwd,
                    "scale_shift_act": 9 * n_fwd}.get(k, 0)
                for k in launches}
        check(n_fwd > 0 and launches == want,
              f"launches {launches} != 17 x kernel 4 and 9 x kernel 1 "
              f"for each of {n_fwd} forwards, and nothing else")
        check(ds == {"conv": 9 * n_fwd, "conv_matmul": 17 * n_fwd,
                     "bn_infer": 0},
              f"conv-epilogue dispatches {ds} for {n_fwd} forwards")
    if device != "cuda":
        return result

    result["card_vs_cpu_max_abs"] = card_vs_cpu(torch, net, x8[:4],
                                                "squeezenet")
    xb = torch.from_numpy(x32).cuda()
    runs = sorted(_time_ms(torch, lambda: net.output(xb), reps=10)
                  for _ in range(3))
    ms = runs[1]
    result["fwd32_f32_ms"] = runs
    result["img_per_s"] = 32e3 / ms
    print(f"[squeezenet] batch-32 f32 forward {ms:.3f} ms (median of "
          f"{[round(r, 3) for r in runs]}) = {32e3 / ms:.1f} img/s "
          f"(TF32 convs, device-resident input) [{label}]")
    p32 = net.output(xb).float()
    net16 = ComputationGraph(SqueezeNet(compute_dtype="bfloat16").conf()
                             ).set_params(net.params, net.states, device)
    n0 = {k: v.launches for k, v in cuda_build.KERNELS.items()}
    p16 = net16.output(xb).float()
    torch.cuda.synchronize()
    d16 = {k: v.launches - n0[k] for k, v in cuda_build.KERNELS.items()}
    check(d16["matmul_bias_act"] == 17 and d16["scale_shift_act"] == 9,
          f"bf16 forward launches {d16}")
    check(bool(torch.isfinite(p16).all()), "bf16 output not finite")
    # the calibrated output layer subtracts the mean image's logits (its
    # bias), so top-1 turns on differences far below bf16's rounding of
    # the features; the logits (log-probabilities less their row mean)
    # are held to the size of the logits before that subtraction
    b_out = net.params["output"]["b"].float()

    def logits(p):
        lp = p.clamp_min(1e-38).log()
        return lp - lp.mean(-1, keepdim=True)
    l32, l16 = logits(p32), logits(p16)
    raw = float((l32 - (b_out - b_out.mean())).abs().max())
    rel = float((l16 - l32).abs().max()) / raw
    agree = float((p16.argmax(-1) == p32.argmax(-1)).float().mean())
    ms16 = _time_ms(torch, lambda: net16.output(xb), reps=10)
    result.update({"fwd32_bf16_ms": ms16, "bf16_top1_agree": agree,
                   "bf16_logit_rel_err": rel})
    print(f"[squeezenet] batch-32 bf16 forward {ms16:.3f} ms = "
          f"{32e3 / ms16:.1f} img/s; logits within {rel:.3e} of the f32 "
          f"ones (relative to the uncalibrated logits' max {raw:.1f}), "
          f"top-1 agreement {agree:.3f} [{label}]")
    check(rel <= 0.05, f"bf16 logits differ from f32 by {rel:.3e} of "
                       f"their scale")
    result["profile"] = profile_device(
        torch, lambda: net.output(xb), ms, "batch-32 f32 SqueezeNet forward")
    return result


def phase_kernel_paths(torch, label: str) -> dict:
    """Device busy time and idle share (profiler) of the paths that carry
    the redesigned kernels: a batch-32 SqueezeNet forward (seeded,
    224x224) in f32 and in bf16 ``compute_dtype``, 17 launches of kernel
    4 each; a batch-32, 224x224 ResNet-50 training step in bf16
    ``compute_dtype``, 53 launches each of kernels 3, 5 and 6 a step,
    with kernels 3 and 5 as shares of its busy time; a
    batch-32 GPT-2-small decode step at L=480 (``decode_step_paths``),
    12 launches of kernel 10. It touches only entry points that every
    tree of the port has, so the same function reads a parent checkout's
    package on the same card."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import SqueezeNet
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    result = {}
    net = seeded_squeezenet(torch, "cuda")
    g = torch.Generator().manual_seed(5)
    xb = torch.randn(BATCH, 224, 224, 3, generator=g).cuda()
    nets = {"float32": net, "bfloat16": ComputationGraph(
        SqueezeNet(compute_dtype="bfloat16").conf()).set_params(
            net.params, net.states, "cuda")}
    for dname, model in nets.items():
        _zero_counts()
        model.output(xb)
        torch.cuda.synchronize()
        n = _counts()["matmul_bias_act"]
        check(n == 17, f"{dname} SqueezeNet forward: {n} launches of "
                       f"kernel 4, expected 17")
        runs = sorted(_time_ms(torch, lambda: model.output(xb), reps=10)
                      for _ in range(3))
        prof = profile_device(torch, lambda: model.output(xb), runs[1],
                              f"batch-{BATCH} {dname} SqueezeNet forward",
                              shares=("mba_",))
        result[f"squeezenet_{dname}"] = {"ms": runs, "profile": prof}
        print(f"[paths] batch-{BATCH} {dname} SqueezeNet forward "
              f"{runs[1]:.3f} ms (median of "
              f"{[round(r, 3) for r in runs]}), device busy "
              f"{prof.get('device_busy_ms', float('nan')):.3f} ms, idle "
              f"share {prof.get('idle_share', float('nan')):.3f} [{label}]")
    del nets, net, model
    kw = dict(seed=21, height=224, width=224)
    gr = torch.Generator().manual_seed(21)
    rn = ResNet50(compute_dtype="bfloat16", **kw).init("cuda", generator=gr)
    x, y = learnable_batch(torch, gr, BATCH, 224)
    x, y = x.cuda(), y.cuda()
    steps = 5
    _zero_counts()
    losses, ms = _timed_steps(torch, rn, x, y, steps)
    n = _counts()
    check(all(np.isfinite(losses)), f"bf16 ResNet-50 losses {losses}")
    for k in ("channel_sums", "bn_bwd_sums", "bn_bwd_dx"):
        check(n[k] == 53 * steps, f"bf16 ResNet-50: {n[k]} launches of {k} "
                                  f"in {steps} steps, expected 53 a step")
    step_ms = float(np.median(ms[1:]))
    prof = profile_device(torch, lambda: rn.fit(x, y), step_ms,
                          f"batch-{BATCH} bf16 ResNet-50 train step",
                          shares=("bn_dx_kernel", "BnSumsOp", "StatsOp",
                                  "column_finalize"))
    result["resnet50_bf16_step"] = {"ms": ms, "profile": prof}
    # kernels 3 and 5 by the Op in the demangled name (both are
    # column_sums_sm90_kernel instantiations; a tree whose kernel 3 is
    # the two-launch body adds its finalize kernel, which nothing else of
    # this step launches)
    sh = prof.get("shares", {})
    busy = prof.get("device_busy_ms", float("nan"))
    k3 = sum(sh.get(n, {}).get("ms", 0.0)
             for n in ("StatsOp", "column_finalize"))
    k5 = sh.get("BnSumsOp", {}).get("ms", float("nan"))
    print(f"[paths] batch-{BATCH} bf16 ResNet-50 step {step_ms:.3f} ms "
          f"(median of steps 2-{steps}), device busy {busy:.3f} ms, idle "
          f"share {prof.get('idle_share', float('nan')):.3f}; kernel 3 "
          f"{k3:.3f} ms ({k3 / busy:.3f} of busy), kernel 5 {k5:.3f} ms "
          f"({k5 / busy:.3f}) [{label}]")
    del rn
    torch.cuda.empty_cache()
    result.update(decode_step_paths(torch, label))
    return result


def decode_step_paths(torch, label: str, L: int = 480) -> dict:
    """A batch-32 decode step of the GPT-2-small-width decoder (seeded
    weights, a pool of 1024 blocks of 16, f32 and bf16) at length ``L``
    (480: the longest a batch of 32 fits in the pool's 1023 usable
    blocks): 12 launches of kernel 10 a step, host time, device busy and
    idle share, and kernel 10's share of busy (profiler). Only entry
    points every tree of the port has."""
    from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
    from deeplearning4j_tpu_torch.serving.generative import DecodeEngine
    from deeplearning4j_tpu_torch.serving.kvcache import KVBlockPool
    conf = DecoderConfig(**GPT2_SMALL)
    model = DecoderLM(conf)
    params = model.init("cuda", seed=41)
    hd = conf.d_model // conf.n_heads
    result = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for kv in ("float32", "bfloat16"):
            pool = KVBlockPool(conf.n_layers, GEN_CONFIG["kv_blocks"],
                               GEN_CONFIG["kv_block_size"], conf.n_heads,
                               hd, dtype=kv, device="cuda")
            engine = DecodeEngine(
                model, params, pool,
                prompt_buckets=GEN_CONFIG["prompt_buckets"],
                decode_buckets=GEN_CONFIG["decode_buckets"],
                max_seq_len=GEN_CONFIG["max_seq_len"])
            args = _synthetic_step(torch, engine, L, BATCH)
            fn = lambda: engine._decode(*args)  # noqa: E731
            fn()
            _zero_counts()
            fn()
            n = _counts()["paged_decode"]
            check(n == conf.n_layers, f"decode step ({kv} pool): {n} "
                                      f"launches of kernel 10")
            runs = sorted(_host_ms(torch, fn) for _ in range(3))
            prof = profile_device(torch, fn, runs[1],
                                  f"batch-{BATCH} decode step at L={L}, "
                                  f"{kv} pool", shares=("paged_decode",))
            share = prof.get("shares", {}).get("paged_decode", {})
            result[f"decode_L{L}_{kv}"] = {"ms": runs, "profile": prof}
            print(f"[paths] batch-{BATCH} GPT-2-small decode step at L={L}, "
                  f"{kv} pool: {runs[1]:.3f} ms (median of "
                  f"{[round(r, 3) for r in runs]}), device busy "
                  f"{prof.get('device_busy_ms', float('nan')):.3f} ms, idle "
                  f"share {prof.get('idle_share', float('nan')):.3f}, "
                  f"kernel 10 {share.get('ms', float('nan')):.3f} ms = "
                  f"{share.get('share_of_busy', float('nan')):.3f} of busy "
                  f"[{label}]")
            del engine, pool
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del model, params
    return result


def _squeezenet_conf(image: int, retain=None, updater=None):
    """SqueezeNet's configuration at ``image``; ``retain`` sets the
    dropout layer's retain probability, ``updater`` every layer's
    updater."""
    from deeplearning4j_tpu_torch.models import SqueezeNet
    kw = {} if image == 224 else {"height": image, "width": image}
    conf = SqueezeNet(**kw).conf()
    if retain is not None:
        conf.vertices["drop"].content.dropout = retain
    if updater is not None:
        conf.updater = updater
        for v in conf.vertices.values():
            if v.is_layer:
                v.content.updater = updater
    return conf


def _update_dist(a: dict, b: dict, p0: dict) -> float:
    """``||(a - p0) - (b - p0)|| / ||b - p0||`` over every parameter at
    once (norm-wise, float64)."""
    num = den = 0.0
    for k, sub in p0.items():
        for n, t in sub.items():
            db = (b[k][n].double().cpu() - t.double().cpu())
            num += float(((a[k][n].double().cpu() - t.double().cpu()) - db)
                         .pow(2).sum())
            den += float(db.pow(2).sum())
    return (num / max(den, 1e-300)) ** 0.5


#: the schedule the SqueezeNet phase trains with: 3 warmup steps into
#: 1e-3 * 0.9^t (the JAX package's WarmupSchedule/ExponentialSchedule)
SQ_WARMUP, SQ_LR0, SQ_GAMMA = 3, 1e-3, 0.9
#: accumulation of two halves against the whole batch, norm-wise
ACCUM_RTOL = 1e-5


def _schedule_formula(t: int) -> float:
    peak = SQ_LR0 * SQ_GAMMA ** t
    return peak * t / SQ_WARMUP if t < SQ_WARMUP else peak


def phase_train_squeezenet(torch, label: str, device: str = "cuda",
                           image: int = 224, batch: int = BATCH,
                           steps: int = 10) -> dict:
    """Training full-width SqueezeNet through ``ComputationGraph.fit``
    with its DropoutLayer(0.5) active, masks drawn on the card: the
    main path is ``steps`` fit steps on one seeded batch (the zoo's
    Adam(1e-3), TF32 convolutions), counts set to 0 before and read
    after: 17 launches of kernel 4 (the pointwise convs' forward; their
    backward is plain matmuls), 9 of kernel 1 and 9 of kernel 2 (the
    other convs' epilogue forward and backward) a step, nothing else;
    the loss falls. Then the masks' keep share (within 4 sigma of 0.5),
    a learning-rate schedule run (the rate the updater was asked for at
    every step against the schedule's formula), gradient accumulation
    of two halves against one whole-batch step (retain 1.0, Sgd, TF32
    off, norm-wise within ACCUM_RTOL), and one step card against CPU at
    64x64. ``device="cpu"`` with a small ``image`` rehearses it. The
    accumulated update is held within ACCUM_RTOL of the whole batch's,
    or, failing that, as near a float64 CPU step of the whole batch as
    UPDATE_FACTOR times the whole batch's own f32 distance from it
    (plus ACCUM_RTOL)."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import telemetry
    from deeplearning4j_tpu_torch.learning import schedules
    from deeplearning4j_tpu_torch.learning.updaters import Adam, Sgd
    from deeplearning4j_tpu_torch.nn.conf import dropout as dmod
    kw = {} if image == 224 else {"height": image, "width": image}
    on_card = device == "cuda"
    t0 = time.perf_counter()
    net = seeded_squeezenet(torch, device, calibrate=False, **kw)
    g = torch.Generator().manual_seed(31)
    x, y = learnable_batch(torch, g, batch, image)
    x, y = x.to(device), y.to(device)
    print(f"[sq-train] SqueezeNet {image}x{image}x3 -> 1000, batch {batch} "
          f"f32 on {device}, {net.num_params()} params, updater "
          f"{net.conf.updater}, dropout retain "
          f"{net.conf.vertices['drop'].content.dropout}; built in "
          f"{time.perf_counter() - t0:.2f}s")

    # ---- the main path: counts to 0, the fit steps, counts read ----
    fused = telemetry.counter("dl4j_conv_fused_steps_total")
    sites = ("conv", "conv_matmul", "bn_infer")
    d0 = {s_: fused.value(site=s_) for s_ in sites}
    _zero_counts()
    losses, ms = _timed_steps(torch, net, x, y, steps)
    launches = _counts()
    ds = {s_: fused.value(site=s_) - d0[s_] for s_ in sites}
    print(f"[sq-train] losses {[round(v, 5) for v in losses]}; step ms "
          f"{[round(m, 3) for m in ms]}; launches {launches}; dispatches "
          f"{ds}")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    per_step = {"matmul_bias_act": 17, "scale_shift_act": 9,
                "epilogue_backward": 9}
    want = {k: per_step.get(k, 0) * steps * on_card for k in launches}
    check(launches == want, f"launches {launches} != {want}")
    if on_card:
        check(ds == {"conv": 9 * steps, "conv_matmul": 17 * steps,
                     "bn_infer": 0}, f"dispatches {ds} in {steps} steps")
    step_ms = float(np.median(ms[1:]))
    result = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
              "img_per_s": batch * 1e3 / step_ms, "launches": launches,
              "dispatches": ds}
    print(f"[sq-train] batch-{batch} f32 step {step_ms:.3f} ms (median of "
          f"steps 2-{steps}) = {batch * 1e3 / step_ms:.1f} img/s [{label}]")

    # ---- the card's masks: the keep share of every mask one step drew --
    drawn = []
    noise = dmod.Dropout.noise

    def spy(self, x_, rng):
        m = noise(self, x_, rng)
        drawn.append((m.device.type, m.numel(), float(m.float().mean())))
        return m
    dmod.Dropout.noise = spy
    try:
        _, peak = _peak_mb(torch, device, lambda: net.fit(x, y))
    finally:
        dmod.Dropout.noise = noise
    check(len(drawn) == 1, f"{len(drawn)} masks drawn in a step")
    dev_type, n, keep = drawn[0]
    sigma = (0.25 / n) ** 0.5
    check(dev_type == device, f"mask drawn on {dev_type}")
    check(abs(keep - 0.5) <= 4 * sigma,
          f"keep share {keep} off 0.5 by more than 4 sigma ({sigma:.2e})")
    result.update(keep_share=keep, mask_elems=n, peak_mb=peak)
    print(f"[sq-train] dropout mask on {dev_type}: {n} elements, keep "
          f"share {keep:.6f} (0.5 +- {4 * sigma:.2e} at 4 sigma); peak "
          f"memory {peak} MB a step [{label}]")
    if on_card:
        result["profile"] = profile_device(
            torch, lambda: net.fit(x, y), step_ms,
            f"batch-{batch} f32 SqueezeNet train step")

    # ---- a learning-rate schedule: the rate asked for at every step ----
    sched = schedules.WarmupSchedule(
        SQ_WARMUP, schedules.ExponentialSchedule(SQ_LR0, SQ_GAMMA))
    up = Adam(sched)
    snet = _copy_net(torch, net, _squeezenet_conf(image, updater=up),
                     device)
    asked = []
    lr_at = up.lr_at

    def logged(iteration, epoch=0):
        v = lr_at(iteration, epoch)
        asked.append((iteration, epoch, v))
        return v
    up.lr_at = logged
    s_losses = [float(snet.fit(x, y).score()) for _ in range(5)]
    layers = sum(1 for k in snet._keys() if snet.params.get(k))
    check(len(asked) == 5 * layers,
          f"{len(asked)} rate lookups in 5 steps of {layers} layers")
    worst = 0.0
    for i, (it, ep, v) in enumerate(asked):
        check(it == i // layers and ep == 0,
              f"lookup {i}: iteration {it}, epoch {ep}")
        want_v = _schedule_formula(it)
        worst = max(worst, abs(v - want_v) / max(want_v, 1e-30))
    check(worst <= 1e-6, f"scheduled lr off the formula by {worst:.2e}")
    check(all(np.isfinite(s_losses)), f"schedule run losses {s_losses}")
    result["schedule"] = {"lr": [asked[i * layers][2] for i in range(5)],
                          "losses": s_losses, "max_rel_err": worst}
    print(f"[sq-train] WarmupSchedule(3, ExponentialSchedule(1e-3, 0.9)) "
          f"on Adam: lr per step {result['schedule']['lr']} (within "
          f"{worst:.2e} of the formula, asked by all {layers} layers); "
          f"losses {[round(v, 5) for v in s_losses]}")
    del snet

    # ---- gradient accumulation: two halves against the whole batch ----
    # (the card's two f32 updates are also held to a float64 CPU step of
    # the whole batch: at full width their own rounding, cuDNN's
    # algorithms for batch 16 and 32 and the relu units it moves across
    # 0, parts them by more than ACCUM_RTOL)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf_a = _squeezenet_conf(image, retain=1.0, updater=Sgd(0.01))
    full = _copy_net(torch, net, conf_a, device)
    acc = _copy_net(torch, net, conf_a, device)
    p0 = {k: {n_: t.clone() for n_, t in sub.items()}
          for k, sub in full.params.items()}
    conf64 = _squeezenet_conf(image, retain=1.0, updater=Sgd(0.01))
    conf64.dtype = "float64"
    cpu64 = ComputationGraph(conf64).set_params(
        {k: {n_: t.detach().double().cpu() for n_, t in sub.items()}
         for k, sub in p0.items()}, {}, "cpu")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        full.fit(x, y)
        acc.set_accumulation_steps(2)
        h = batch // 2
        acc.fit(x[:h], y[:h])
        applied_after_one = acc._updates_applied
        acc.fit(x[h:], y[h:])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    cpu64.fit(x.double().cpu(), y.double().cpu())
    e_acc = _update_dist(acc.params, full.params, p0)
    e_acc64 = _update_dist(acc.params, cpu64.params, p0)
    e_full64 = _update_dist(full.params, cpu64.params, p0)
    check(applied_after_one == 0 and acc._updates_applied == 1,
          "accumulation applied the wrong number of updates")
    check(e_acc <= ACCUM_RTOL or e_acc64 <= UPDATE_FACTOR * e_full64
          + ACCUM_RTOL,
          f"2 x {batch // 2} accumulated: {e_acc:.3e} from 1 x {batch} and "
          f"{e_acc64:.3e} from the float64 step, 1 x {batch} "
          f"{e_full64:.3e} from it")
    result.update(accumulation_rel_err=e_acc, accumulation_vs_f64=e_acc64,
                  full_batch_vs_f64=e_full64)
    print(f"[sq-train] set_accumulation_steps(2), 2 x {batch // 2} vs 1 x "
          f"{batch} (retain 1.0, Sgd(0.01), TF32 off): updates "
          f"{e_acc:.3e} apart in norm; from a float64 CPU step of the "
          f"whole batch: accumulated {e_acc64:.3e}, whole batch "
          f"{e_full64:.3e}")
    del full, acc, cpu64
    if on_card:
        torch.cuda.empty_cache()
        result["card_vs_cpu"] = squeezenet_train_card_vs_cpu(torch)
    return result


def squeezenet_train_card_vs_cpu(torch, image: int = 64, batch: int = 8,
                                 device: str = "cuda") -> dict:
    """One Sgd step of SqueezeNet at ``image`` with the dropout layer at
    retain 1.0, on the card and on the CPU (on the card's route, the
    conv gate forced) in float32 and float64, TF32 off: the loss within
    LOSS_RTOL, the card's update norm-wise as near the float64 step as
    UPDATE_FACTOR times the CPU float32 step's distance (plus
    UPDATE_FLOOR), as ``train_card_vs_cpu`` holds ResNet-50's."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = _squeezenet_conf(image, retain=1.0, updater=Sgd(0.05))
    g = torch.Generator().manual_seed(33)
    base = ComputationGraph(conf).init("cpu", generator=g)
    x, y = learnable_batch(torch, g, batch, image)
    p0 = {k: {n: t.clone() for n, t in sub.items()}
          for k, sub in base.params.items()}
    card = _copy_net(torch, base, conf, device)
    conf64 = _squeezenet_conf(image, retain=1.0, updater=Sgd(0.05))
    conf64.dtype = "float64"
    cpu64 = ComputationGraph(conf64).set_params(
        {k: {n: t.double() for n, t in sub.items()} for k, sub in p0.items()},
        {}, "cpu")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    extra = Environment.get().extra
    saved = extra.get("fused_conv")
    try:
        card.fit(x.to(device), y.to(device))
        extra["fused_conv"] = "1"
        base.fit(x, y)
        cpu64.fit(x.double(), y.double())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        if saved is None:
            extra.pop("fused_conv", None)
        else:
            extra["fused_conv"] = saved
    check(abs(card.score() - base.score()) <= LOSS_RTOL * abs(base.score()),
          f"SqueezeNet loss card {card.score()} vs cpu {base.score()}")
    e_card = _update_dist(card.params, cpu64.params, p0)
    e_cpu = _update_dist(base.params, cpu64.params, p0)
    e_pair = _update_dist(card.params, base.params, p0)
    check(e_card <= UPDATE_FACTOR * e_cpu + UPDATE_FLOOR,
          f"SqueezeNet card update {e_card:.3e} from the float64 step, the "
          f"CPU float32 step's {e_cpu:.3e}")
    print(f"[sq-train] card vs CPU, one Sgd step at {image}x{image}, batch "
          f"{batch}, retain 1.0 (TF32 off; CPU on the card's route): loss "
          f"{card.score():.7f} vs {base.score():.7f} (f64 "
          f"{cpu64.score():.7f}); update in norm: card vs f64 {e_card:.3e},"
          f" CPU f32 vs f64 {e_cpu:.3e}, card vs CPU f32 {e_pair:.3e}")
    return {"loss_card": card.score(), "loss_cpu": base.score(),
            "loss_cpu64": cpu64.score(), "update_card_vs_f64": e_card,
            "update_cpu32_vs_f64": e_cpu, "update_card_vs_cpu32": e_pair}


# ---------------------------------------------------------------------------
#: BASELINE #5 on one card: ResNet-50 through the data-parallel entry
#: points. DP_STEPS staged steps, DP_RANK_STEPS on the two-rank group,
#: at full width and at DP_SMALL x DP_SMALL (both with TF32 off).
DP_STEPS, DP_RANK_STEPS, DP_RANKS = 10, 3, 2
DP_SMALL = 64
DP_WORK = ROOT / "build" / "dp_resnet"
DP_KERNELS = ("channel_sums", "scale_shift_act", "bn_bwd_sums", "bn_bwd_dx")
#: the encoded exchange's codecs, each run in (e)
DP_SCHEMES = ("threshold", "int8", "1bit")
#: the 1-bit codec's scale, card against CPU: mean|c| sums in another
#: order on each
ONEBIT_RTOL = 1e-6


class _StepClock:
    """A training listener: the time at the end of each step (the
    compute stream synchronised, the staging stream left running), and
    CPU snapshots of the parameters and running statistics after the
    steps in ``keep``."""

    def __init__(self, torch, device: str, keep=()):
        self.torch, self.on_card = torch, device == "cuda"
        self.keep, self.snaps, self.marks = set(keep), {}, []
        self.state_bytes, self.losses = [], []
        # the exchange as the model ran it: its mode, the parameter and
        # residual bytes it held, and each group's (tau, sparsity, step)
        self.modes, self.param_bytes, self.residual_bytes = [], [], []
        self.encoded, self.encoding = [], None

    def start(self):
        self.marks = [time.perf_counter()]

    def iteration_done(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.learning.updaters import ENCODED_KEY
        from deeplearning4j_tpu_torch.parallel import zero
        if self.on_card:
            self.torch.cuda.current_stream().synchronize()
        self.marks.append(time.perf_counter())
        self.losses.append(model.score())
        # the updater state this replica holds during the step
        self.state_bytes.append(
            zero.sharded_state_bytes(model.updater_states) +
            zero.dense_state_bytes(model.updater_states))
        self.modes.append(getattr(model._dp_mode, "value", None))
        self.param_bytes.append(
            zero.fsdp_param_bytes(model.params) if model._params_are_fsdp()
            else sum(t.numel() * t.element_size()
                     for sub in model.params.values()
                     for t in sub.values()))
        self.residual_bytes.append(
            zero.encoded_residual_bytes(model.updater_states))
        enc = [s_[ENCODED_KEY] for s_ in model.updater_states.values()
               if ENCODED_KEY in s_]
        if enc:
            self.encoding = model._dp_encoding
            self.encoded.append(self.torch.stack([self.torch.stack(
                [e["tau"], e["sparsity"], e["step"].float()])
                for e in enc]).cpu())
        if iteration + 1 in self.keep:
            self.snaps[iteration + 1] = _cpu_snapshot(model)

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def step_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _cpu_snapshot(net) -> dict:
    return {"params": {k: {n: t.detach().cpu().clone()
                           for n, t in sub.items()}
                       for k, sub in net.params.items()},
            "states": {k: {n: t.detach().cpu().clone()
                           for n, t in sub.items()}
                       for k, sub in net.states.items()}}


def _dp_net(torch, image: int, device: str, batch: int = BATCH):
    """``phase_train_resnet``'s seeded ResNet-50 and learnable batch (as
    numpy, for the iterator to stage)."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    g = torch.Generator().manual_seed(21)
    net = ResNet50(seed=21, height=image, width=image).init(device,
                                                           generator=g)
    x, y = learnable_batch(torch, g, batch, image)
    return net, x.numpy(), y.numpy()


def _dp_iterator(x, y, steps: int):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    return ListDataSetIterator([DataSet(x, y) for _ in range(steps)])


def _bitwise(torch, a: dict, b: dict, what: str) -> None:
    for part in ("params", "states"):
        for k, sub in a[part].items():
            for n, t in sub.items():
                check(torch.equal(t, b[part][k][n]),
                      f"{what}: {part} {k}/{n} differ")


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() /
                 b.double().norm().clamp_min(1e-30))


def _update_err(got: dict, ref: dict, p0: dict) -> float:
    """The worst parameter's distance from ``ref`` in norm, over the
    norm of ``ref``'s update from ``p0``."""
    return max(float((got[k][n].double() - ref[k][n].double()).norm() /
                     (ref[k][n].double() - p0[k][n].double()).norm()
                     .clamp_min(1e-30))
               for k in p0 for n in p0[k])


def dp_rank_main(work: str, rank: int, world: int, backend: str,
                 images: str, device: str = "cuda") -> None:
    """One rank of the ``SharedTrainingMaster`` group of
    ``phase_dp_resnet`` (run as its own process): each image size's
    seeded ResNet-50 takes DP_RANK_STEPS steps on this rank's rows of
    the global batch; the results go to ``work``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.parallel import zero
    from deeplearning4j_tpu_torch.parallel.sharedtraining import \
        SharedTrainingMaster
    out = {}
    # held against float64: convolutions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # (f) is held bit for bit to (c): with TF32 off cuDNN's heuristics
    # took a weight-gradient algorithm that is not repeatable for the
    # stem convolution (the two runs' stem_conv/W differed), so both
    # run the deterministic algorithms, as phase 20 does
    torch.use_deterministic_algorithms(True, warn_only=True)
    master = (SharedTrainingMaster.Builder(BATCH // world)
              .coordinator(f"file://{work}/store", world, rank, backend)
              .collective_timeout(300).build())
    try:
        for image in (int(s) for s in images.split(",")):
            net, x, y = _dp_net(torch, image, device)
            k = BATCH // world
            shard = slice(rank * k, (rank + 1) * k)
            whole = zero.sharded_state_bytes(zero.states_to_sharded(
                net.params, net.updater_states, world))
            dense = zero.dense_state_bytes(net.updater_states)
            clock = _StepClock(torch, device, keep=(1, DP_RANK_STEPS))
            net.set_listeners(clock)
            _zero_counts()
            clock.start()
            master.fit(net, _dp_iterator(x[shard], y[shard],
                                         DP_RANK_STEPS))
            out[image] = {"launches": _counts(), "score": net.score(),
                          "step_ms": clock.step_ms(),
                          "losses": clock.losses,
                          "snaps": clock.snaps,
                          "state_bytes": clock.state_bytes,
                          "state_bytes_whole_padded": whole,
                          "state_bytes_dense": dense,
                          "last_batch_size": net.last_batch_size}
            del net
        out["exchanges"] = _rank_exchanges(
            torch, master, work, rank, world,
            int(images.split(",")[0]), device)
    finally:
        master.shutdown()
    torch.save(out, f"{work}/rank{rank}.pt")


class _TailRecorder:
    """While entered, records ``zero.encoded_tail``'s inputs and outputs
    on its first step for three parameter groups of ``net`` (the first,
    the middle and the last in the update order): the mean-gradient and
    residual slices, τ and step, the decoded slice, the new residual, τ
    and the transmitted fraction, on the CPU."""

    def __init__(self, net):
        order = [k for k in net._keys() if net.params[k]]
        picks = (0, len(order) // 2, len(order) - 1)
        self.idx = {i: order[i] for i in picks}
        self.calls, self.rec = 0, {}

    def __enter__(self):
        from deeplearning4j_tpu_torch.parallel import zero
        self.orig = orig = zero.encoded_tail

        def cpu(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}

        def tail(g, residual, tau, step, encoding, replica=None):
            out = orig(g, residual, tau, step, encoding, replica)
            i, self.calls = self.calls, self.calls + 1
            if i in self.idx:
                self.rec[self.idx[i]] = {
                    "g": cpu(g), "residual": cpu(residual),
                    "tau": tau.cpu(), "step": step.cpu(),
                    "decoded": cpu(out[0]), "new_residual": cpu(out[1]),
                    "new_tau": out[2].cpu(), "sparsity": out[3].cpu()}
            return out
        zero.encoded_tail = tail
        return self

    def __exit__(self, *exc):
        from deeplearning4j_tpu_torch.parallel import zero
        zero.encoded_tail = self.orig


def _rank_exchanges(torch, master, work: str, rank: int, world: int,
                    image: int, device: str) -> dict:
    """Phase 19 (e) and (f) on this rank, in the group of ``master``:
    the seeded ResNet-50 of (c) at ``image`` takes DP_RANK_STEPS steps
    through ``SharedTrainingMaster`` under the encoded exchange, once per
    scheme (threshold through ``threshold_algorithm``, int8 and 1-bit
    through ``encoding``), then under fsdp, each from the same weights
    and rows as (c)."""
    import contextlib

    from deeplearning4j_tpu_torch.parallel.encoding import \
        AdaptiveThresholdAlgorithm
    from deeplearning4j_tpu_torch.parallel.sharedtraining import \
        SharedTrainingMaster
    k = BATCH // world
    shard = slice(rank * k, (rank + 1) * k)
    out = {}
    for name in DP_SCHEMES + ("fsdp",):
        b = (SharedTrainingMaster.Builder(k)
             .coordinator(f"file://{work}/store", world, rank)
             .collective_timeout(300))
        algo = None
        if name == "fsdp":
            b.update_exchange("fsdp")
        elif name == "threshold":
            # the reference's knob, live under the encoded exchange
            algo = AdaptiveThresholdAlgorithm()
            b.update_exchange("encoded").threshold_algorithm(algo)
        else:
            b.update_exchange("encoded").encoding(name)
        run = b.build()
        run._mesh = master._mesh        # this process's one group
        net, x, y = _dp_net(torch, image, device)
        clock = _StepClock(torch, device)
        net.set_listeners(clock)
        rec = _TailRecorder(net) if name != "fsdp" else \
            contextlib.nullcontext()
        _zero_counts()
        clock.start()
        with rec:
            run.fit(net, _dp_iterator(x[shard], y[shard], DP_RANK_STEPS))
        r = {"launches": _counts(), "step_ms": clock.step_ms(),
             "losses": clock.losses, "score": net.score(),
             "modes": clock.modes, "param_bytes": clock.param_bytes,
             "state_bytes": clock.state_bytes,
             "residual_bytes": clock.residual_bytes,
             "final": _cpu_snapshot(net)}
        if name != "fsdp":
            r["tails"] = rec.rec
            r["encoded"] = clock.encoded
            r["scheme"] = clock.encoding.scheme
            r["algorithm"] = type(clock.encoding.algorithm).__name__
            r["knob_reached"] = (algo is None or
                                 clock.encoding.algorithm is algo)
        out[name] = r
        del net
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _run_ranks(world: int, backend: str, images: str,
               device: str = "cuda") -> list:
    """The ranks of a ``SharedTrainingMaster`` group on this card, each
    its own process, waited for with a limit."""
    import shutil
    import torch
    shutil.rmtree(DP_WORK, ignore_errors=True)
    DP_WORK.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.dp_rank_main({str(DP_WORK)!r}, {r}, "
         f"{world}, {backend!r}, {images!r}, {device!r})"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of the {backend} group exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    res = [torch.load(DP_WORK / f"rank{r}.pt") for r in range(world)]
    shutil.rmtree(DP_WORK, ignore_errors=True)
    return res


def h2d_overlap(torch, fn) -> dict:
    """Host-to-device copies under ``fn()`` (profiler) and the share of
    their time during which a kernel of another stream runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies, kernels = [], []
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        span = (e.time_range.start, e.time_range.end)
        if "HtoD" in e.name:
            copies.append(span)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(span)
    if not copies or not kernels:
        print("[dp] H2D overlap: not measured (no CUDA copy events)")
        return {}
    merged = []
    for s, e in sorted(kernels):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = sum(e - s for s, e in copies)
    covered = sum(max(0.0, min(e, me) - max(s, ms))
                  for s, e in copies for ms, me in merged)
    first = min(s for s, _ in merged + [list(c) for c in copies])
    return {"h2d_copies": len(copies), "h2d_ms": total / 1e3,
            "h2d_overlapped_ms": covered / 1e3,
            "h2d_overlap_share": covered / total if total else 0.0,
            # where the copies fall in the window, and the device's
            # busy share of it
            "copy_starts_ms": [round((s - first) / 1e3, 3)
                               for s, _ in sorted(copies)],
            "window_ms": (max(e for _, e in merged) - first) / 1e3,
            "kernel_busy_ms": sum(e - s for s, e in merged) / 1e3}


def _f64_step(torch, size: int, p0: dict, x, y):
    """One float64 CPU fit step of the seeded ResNet-50 at ``size`` from
    ``p0`` on ``(x, y)``: its parameters, and the seconds it took."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf64 = ResNet50(seed=21, height=size, width=size).conf()
    conf64.dtype = "float64"
    f64 = ComputationGraph(conf64).set_params(
        {k: {n: t.double() for n, t in sub.items()}
         for k, sub in p0["params"].items()},
        {k: {n: t.double() for n, t in sub.items()}
         for k, sub in p0["states"].items()}, "cpu")
    t0 = time.perf_counter()
    f64.fit(torch.from_numpy(x).double(), torch.from_numpy(y).double())
    return ({k: dict(sub) for k, sub in f64.params.items()},
            time.perf_counter() - t0)


def _hold_rank(torch, rank: int, size: int, res: dict, p0: dict,
               ref_snaps: dict, ref_losses: list, f64_p: dict) -> dict:
    """One rank of the two-rank group at one image size against the
    one-process batch-32 run from the same weights: step 1's update in
    norm within UPDATE_FACTOR x the one-process step's distance from a
    float64 CPU step (``f64_p``, + UPDATE_FLOOR), as
    ``train_card_vs_cpu`` holds the card to the CPU; the step-1 loss
    within LOSS_RTOL and the running statistics within STATE_RTOL of the
    one-process step's. After DP_RANK_STEPS steps the parameters'
    distance from the one-process run is reported."""
    e_ref = _update_err(ref_snaps[1]["params"], f64_p, p0["params"])
    e_dp = _update_err(res["snaps"][1]["params"], f64_p, p0["params"])
    check(e_dp <= UPDATE_FACTOR * e_ref + UPDATE_FLOOR,
          f"rank {rank} at {size}x{size}: step-1 update {e_dp:.3e} from "
          f"float64, the one-process step's {e_ref:.3e}")
    e_loss = abs(res["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    check(e_loss <= LOSS_RTOL, f"rank {rank} at {size}x{size}: loss "
                               f"{res['losses'][0]} vs {ref_losses[0]}")
    e_state = max(_rel(res["snaps"][1]["states"][k][n],
                       ref_snaps[1]["states"][k][n])
                  for k in p0["states"] for n in p0["states"][k])
    check(e_state <= STATE_RTOL, f"rank {rank} at {size}x{size}: running "
                                 f"stats after step 1 {e_state:.3e}")
    e_pair = _update_err(res["snaps"][1]["params"], ref_snaps[1]["params"],
                         p0["params"])
    e3 = _update_err(res["snaps"][DP_RANK_STEPS]["params"],
                     ref_snaps[DP_RANK_STEPS]["params"], p0["params"])
    print(f"[dp] (c) rank {rank} at {size}x{size} (TF32 off): step 1 update "
          f"{e_dp:.3e} from float64 (the one-process step {e_ref:.3e}; "
          f"bar {UPDATE_FACTOR} x + {UPDATE_FLOOR}), {e_pair:.3e} from the "
          f"one-process step; loss {res['losses'][0]:.7f} vs "
          f"{ref_losses[0]:.7f} ({e_loss:.2e}); running stats "
          f"{e_state:.3e}; after {DP_RANK_STEPS} steps {e3:.3e} from the "
          f"one-process run")
    return {"update_vs_f64": e_dp, "one_process_vs_f64": e_ref,
            "update_vs_one_process": e_pair, "loss_rel": e_loss,
            "states_rel": e_state, "params_vs_one_process_step3": e3}


def _replay_tails(torch, name: str, tails: list, device: str) -> dict:
    """The encoded tail of scheme ``name`` replayed on one whole flat
    (the two ranks' recorded step-1 slices concatenated, no replica: the
    reductions then span the flat as the ranks' collectives did), on
    ``device`` and on the CPU. Held: card against CPU bitwise for
    threshold and int8 and within ONEBIT_RTOL for 1-bit; the ranks'
    recorded outputs against the replay the same way; the error-feedback
    identity, ``residual + decoded`` within one f32 ulp of ``corrected``
    (of the larger of it and ``decoded``) wherever the step-1 clip left
    the residual (elsewhere the residual sits at ±5τ)."""
    from deeplearning4j_tpu_torch.parallel import zero
    from deeplearning4j_tpu_torch.parallel.encoding import EncodingSpec
    spec = EncodingSpec() if name == "threshold" else EncodingSpec(name)

    def close(a, b, what, scale=None):
        """Bitwise, or for 1-bit within ONEBIT_RTOL of the decoded
        magnitude ``scale`` (a residual moves by the scale's difference
        and one rounding of its own)."""
        if name == "1bit":
            err = float((a.double() - b.double()).abs().max())
            bar = ONEBIT_RTOL * float(b.double().abs().max()
                                      if scale is None else scale)
            if scale is not None:
                bar += float(torch.finfo(torch.float32).eps *
                             b.double().abs().max())
            check(err <= bar, f"{what}: {err:.3e} > {bar:.3e}")
            return err
        check(torch.equal(a, b), f"{what}: not bitwise equal")
        return 0.0

    worst, out = 0.0, {}
    for key in tails[0]:
        a, b = tails[0][key], tails[1][key]
        g = {dt: torch.cat([a["g"][dt], b["g"][dt]]) for dt in a["g"]}
        r = {dt: torch.cat([a["residual"][dt], b["residual"][dt]])
             for dt in a["residual"]}
        runs = {}
        for dev in dict.fromkeys((device, "cpu")):
            res = zero.encoded_tail(
                {dt: t.to(dev) for dt, t in g.items()},
                {dt: t.to(dev) for dt, t in r.items()},
                a["tau"].to(dev), a["step"].to(dev), spec, None)
            runs[dev] = (_tree_cpu(res[0]), _tree_cpu(res[1]),
                         res[2].cpu(), res[3].cpu())
        (dec, res_, tau, sp), cpu = runs[device], runs["cpu"]
        for dt in g:
            scale = float(cpu[0][dt].abs().max())
            worst = max(worst, close(dec[dt], cpu[0][dt],
                                     f"{name} {key} decoded, card vs CPU"),
                        close(res_[dt], cpu[1][dt],
                              f"{name} {key} residual, card vs CPU",
                              scale))
            half = a["decoded"][dt].numel()
            for rk, (lo, hi) in enumerate(((0, half),
                                           (half, 2 * half))):
                rec = tails[rk][key]
                close(rec["decoded"][dt], dec[dt][lo:hi],
                      f"{name} {key} rank {rk} decoded vs the replay")
                close(rec["new_residual"][dt], res_[dt][lo:hi],
                      f"{name} {key} rank {rk} residual vs the replay",
                      scale)
            corrected = g[dt] + r[dt]
            lim = spec.residual_post.max_multiple * cpu[2]
            free = cpu[1][dt].abs() < lim
            # the subtraction rounds at the larger operand's ulp (1-bit
            # decodes every element to ±scale, small ones too)
            big = torch.maximum(corrected.abs(), cpu[0][dt].abs())
            ulp = torch.nextafter(big, torch.tensor(float("inf"))) - big
            err = (cpu[1][dt] + cpu[0][dt] - corrected).abs()
            check(bool(((err <= ulp) | ~free).all()),
                  f"{name} {key}: residual + decoded misses corrected by "
                  f"{float((err - ulp)[free].max()):.3e} over an ulp")
            check(bool((cpu[1][dt][~free].abs() == lim).all()),
                  f"{name} {key}: a clipped residual off ±5τ")
            out[key] = {"elements": int(corrected.numel()),
                        "clipped": int((~free).sum()),
                        "sparsity": float(sp), "tau": float(tau)}
        check(torch.equal(tau, cpu[2]) and torch.equal(sp, cpu[3]),
              f"{name} {key}: τ or the fraction, card vs CPU")
        for rk in range(2):
            check(torch.equal(tails[rk][key]["new_tau"], cpu[2]) and
                  torch.equal(tails[rk][key]["sparsity"], cpu[3]),
                  f"{name} {key} rank {rk}: τ or the fraction vs the "
                  f"replay")
    return {"groups": out, "card_vs_cpu_max_abs": worst}


def _tree_cpu(d: dict) -> dict:
    return {k: v.cpu() for k, v in d.items()}


def _check_exchanges(torch, ranks: list, image: int, params: dict,
                     launches_ok, label: str, device: str) -> dict:
    """Phase 19 (e) and (f): the ranks' encoded and fsdp runs (from
    ``_rank_exchanges``) against each other, (c) and the host."""
    import numpy as np

    from deeplearning4j_tpu_torch.parallel import zero
    from deeplearning4j_tpu_torch.parallel.encoding import (
        AdaptiveThresholdAlgorithm, EncodingSpec)
    order = [k for k in params if params[k]]
    sizes = np.array([sum(-(-t.numel() // DP_RANKS) * DP_RANKS
                          for t in params[k].values()) for k in order],
                     dtype=np.float64)
    whole = zero.fsdp_param_bytes(zero.params_to_fsdp(params, DP_RANKS)[0])
    report = {"padded_flat_param_bytes": whole, "bytes": {}}
    for name in DP_SCHEMES + ("fsdp",):
        runs = [r["exchanges"][name] for r in ranks]
        want = "fsdp" if name == "fsdp" else "encoded"
        for rk, run in enumerate(runs):
            check(len(run["modes"]) == DP_RANK_STEPS and
                  all(m == want for m in run["modes"]),
                  f"{name} rank {rk}: the exchange ran as {run['modes']}")
            launches_ok(run["launches"], DP_RANK_STEPS,
                        f"{name} rank {rk}")
            check(all(np.isfinite(run["losses"])),
                  f"{name} rank {rk}: loss {run['losses']}")
        _bitwise(torch, runs[0]["final"], runs[1]["final"],
                 f"{name}: rank 0 vs rank 1 after {DP_RANK_STEPS} steps")
        rep = {"step_ms": [r["step_ms"] for r in runs],
               "losses": runs[0]["losses"],
               "launches": [r["launches"] for r in runs],
               "param_bytes": runs[0]["param_bytes"][-1],
               "state_bytes": runs[0]["state_bytes"][-1],
               "residual_bytes": runs[0]["residual_bytes"][-1]}
        if name == "fsdp":
            for rk, run in enumerate(runs):
                ref = ranks[rk][image]["snaps"][DP_RANK_STEPS]
                off = {f"{part} {k}/{n}": float((t - ref[part][k][n])
                                                .abs().max())
                       for part in ("params", "states")
                       for k, sub in run["final"][part].items()
                       for n, t in sub.items()
                       if not torch.equal(t, ref[part][k][n])}
                check(not off, f"fsdp rank {rk} vs the ZeRO-1 run (c): "
                               f"{len(off)} tensors differ: {off}")
                check(all(b * DP_RANKS == whole
                          for b in run["param_bytes"]),
                      f"fsdp rank {rk}: parameters {run['param_bytes']} "
                      f"bytes a step, the padded flats {whole}")
                check(run["state_bytes"] == ranks[rk][image]["state_bytes"],
                      f"fsdp rank {rk}: updater state "
                      f"{run['state_bytes']} bytes, (c)'s "
                      f"{ranks[rk][image]['state_bytes']}")
            print(f"[dp] (f) fsdp, 2 gloo ranks at {image}x{image}: "
                  f"bitwise equal to the ZeRO-1 run (c) and to each other "
                  f"after {DP_RANK_STEPS} steps; resident a rank: "
                  f"parameters {rep['param_bytes']} bytes = 1/{DP_RANKS} "
                  f"of the padded flats {whole}, updater state "
                  f"{rep['state_bytes']}; loss {runs[0]['losses']}; steps "
                  f"{[[round(m, 3) for m in r] for r in rep['step_ms']]} ms"
                  f" (gloo, host-staged: no DP rate); launches "
                  f"{runs[0]['launches']} [{label}]")
            report["fsdp"] = rep
            continue
        for rk, run in enumerate(runs):
            check(run["scheme"] == name and run["knob_reached"],
                  f"{name} rank {rk}: the tail ran {run['scheme']} / "
                  f"{run['algorithm']}")
            check(all(b * DP_RANKS == whole
                      for b in run["residual_bytes"]),
                  f"{name} rank {rk}: residual {run['residual_bytes']} "
                  f"bytes, the padded flats {whole}")
        rep["tail"] = _replay_tails(torch, name,
                                    [r["tails"] for r in runs], device)
        # τ's trajectory against next_tau replayed on the host from the
        # fractions the ranks recorded
        enc = runs[0]["encoded"]
        algo = AdaptiveThresholdAlgorithm()
        tau = torch.full((len(order),), algo.initial(), dtype=torch.float32)
        steps = []
        for i, st in enumerate(enc):
            check(st.shape[0] == len(order) and
                  torch.equal(enc[i], runs[1]["encoded"][i]),
                  f"{name}: the ranks' τ / fraction differ at step {i + 1}")
            tau = algo.next_tau(tau, st[:, 1])
            check(torch.equal(tau, st[:, 0]),
                  f"{name}: τ at step {i + 1} off the host replay")
            sp = st[:, 1].double().numpy()
            steps.append({"fraction_weighted": float(
                (sp * sizes).sum() / sizes.sum()),
                "fraction_min": float(sp.min()),
                "fraction_max": float(sp.max()),
                "tau_min": float(st[:, 0].min()),
                "tau_max": float(st[:, 0].max())})
        rep["steps"] = steps
        rep["bytes"] = {
            "encoded_exchange_planned": zero.encoded_exchange_bytes(
                params, DP_RANKS, name),
            "encoded_exchange_observed": zero.encoded_exchange_bytes(
                params, DP_RANKS, name,
                sparsity=steps[-1]["fraction_weighted"])}
        print(f"[dp] (e) encoded {name} ({runs[0]['algorithm']}), 2 gloo "
              f"ranks at {image}x{image}: the ranks bitwise equal after "
              f"{DP_RANK_STEPS} steps; per step transmitted fraction "
              f"(size-weighted, min..max over {len(order)} groups) and τ "
              f"(min..max): "
              + "; ".join(f"{i + 1}: {st_['fraction_weighted']:.6f} "
                          f"({st_['fraction_min']:.6f}.."
                          f"{st_['fraction_max']:.6f}), τ "
                          f"{st_['tau_min']:.9g}..{st_['tau_max']:.9g}"
                          for i, st_ in enumerate(steps))
              + f"; τ == next_tau replayed on the host; step-1 tail card "
              f"vs CPU {rep['tail']['card_vs_cpu_max_abs']:.3e} (groups "
              f"{rep['tail']['groups']}); resident a rank: residual "
              f"{rep['residual_bytes']} bytes, updater state "
              f"{rep['state_bytes']}, parameters {rep['param_bytes']}; "
              f"wire a rank a step: {rep['bytes']}; loss "
              f"{runs[0]['losses']}; steps "
              f"{[[round(m, 3) for m in r] for r in rep['step_ms']]} ms "
              f"(gloo, host-staged: no DP rate) [{label}]")
        report[name] = rep
    for mode in ("dense", "sharded", "fsdp"):
        report["bytes"][mode] = zero.update_exchange_bytes(params,
                                                           DP_RANKS, mode)
    for name in DP_SCHEMES:
        report["bytes"][f"encoded_{name}"] = zero.encoded_exchange_bytes(
            params, DP_RANKS, EncodingSpec(name))
    print(f"[dp] (e)/(f) update-exchange bytes a rank a step (analytic, "
          f"{DP_RANKS} ranks, ring model; planning sparsity for threshold): "
          f"{report['bytes']}")
    return report


def phase_dp_resnet(torch, label: str, device: str = "cuda",
                    image: int = 224) -> dict:
    """BASELINE #5 on one card (see the module docstring, phase 19).
    ``device="cpu"`` with a small ``image`` rehearses (a), (b), (c), (e)
    and (f) without a card (the launch counts and the profile are the
    card's); the NCCL run (d) needs one."""
    import numpy as np

    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.parallel import zero
    from deeplearning4j_tpu_torch.parallel.sharedtraining import \
        SharedTrainingMaster
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    on_card = device == "cuda"
    base, x, y = _dp_net(torch, image, device)
    p0 = _cpu_snapshot(base)
    want = {k: 53 * on_card for k in DP_KERNELS}
    out = {}

    def launches_ok(got, steps, what):
        for k, n in want.items():
            check(got[k] == n * steps, f"{what}: {k} {got[k]} launches in "
                                       f"{steps} steps, expected {n} a step")
        check(got["epilogue_backward"] == 0, f"{what}: kernel 2 launched")

    def timed_run(net, fit, what, keep=()):
        clock = _StepClock(torch, device, keep)
        net.set_listeners(clock)
        _sync(torch, device)
        _zero_counts()
        clock.start()
        fit()
        got = _counts()
        launches_ok(got, DP_STEPS, what)
        ms = clock.step_ms()
        med = float(np.median(ms[1:]))
        net.set_listeners()
        return {"launches": got, "step_ms": ms, "median_step_ms": med,
                "img_per_s": BATCH * 1e3 / med, "snaps": clock.snaps,
                "losses": clock.losses,
                "final": _cpu_snapshot(net), "score": net.score()}

    # ---- (a) staging: fit(iterator) with the prefetcher on, then off ----
    nets = {}
    for flag in ("1", "0"):
        os.environ["DL4J_TORCH_DEVICE_PREFETCH"] = flag
        Environment.reset()
        try:
            net = _copy_net(torch, base, base.conf, device)
            out[f"prefetch_{flag}"] = timed_run(
                net, lambda: net.fit(_dp_iterator(x, y, DP_STEPS)),
                f"fit(iterator), prefetch {flag}")
            nets[flag] = net
        finally:
            del os.environ["DL4J_TORCH_DEVICE_PREFETCH"]
            Environment.reset()
    staged = out["prefetch_1"]
    _bitwise(torch, staged["final"], out["prefetch_0"]["final"],
             "staged vs unstaged fit")
    print(f"[dp] (a) ResNet-50 {image}x{image}, batch {BATCH}, "
          f"{DP_STEPS} fit(iterator) steps: staged "
          f"{staged['median_step_ms']:.3f} ms/step "
          f"({staged['img_per_s']:.1f} img/s), unstaged "
          f"{out['prefetch_0']['median_step_ms']:.3f} ms/step; parameters "
          f"and running stats bitwise equal; launches "
          f"{staged['launches']} [{label}]")
    if on_card:
        prof_net = nets["1"]
        one = _dp_iterator(x, y, 3)
        staged["profile"] = profile_device(
            torch, lambda: prof_net.fit(one), 3 * staged["median_step_ms"],
            "3 staged fit(iterator) steps")
        staged["overlap"] = h2d_overlap(torch, lambda: prof_net.fit(one))
        print(f"[dp] (a) host-to-device copies of 3 staged steps: "
              f"{staged['overlap']} [{label}]")
    del nets

    # ---- (b) ParallelWrapper, workers=1 ----
    net_b = _copy_net(torch, base, base.conf, device)
    pw = ParallelWrapper.Builder(net_b).workers(1).build()
    out["wrapper"] = res_b = timed_run(
        net_b, lambda: pw.fit(_dp_iterator(x, y, DP_STEPS)),
        "ParallelWrapper workers=1")
    check(pw.update_exchange is zero.UpdateExchange.DENSE,
          f"workers=1 resolved to {pw.update_exchange}")
    _bitwise(torch, res_b["final"], staged["final"],
             "ParallelWrapper workers=1 vs fit")
    check(res_b["score"] == staged["score"],
          f"wrapper score {res_b['score']} != fit's {staged['score']}")
    print(f"[dp] (b) ParallelWrapper workers=1 on {pw.mesh.devices}: "
          f"exchange {pw.update_exchange.value}, "
          f"{res_b['median_step_ms']:.3f} ms/step "
          f"({res_b['img_per_s']:.1f} img/s); bitwise equal to fit; "
          f"launches {res_b['launches']} [{label}]")
    del pw, net_b

    # ---- (c) SharedTrainingMaster, two gloo ranks on this card ----
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_ranks(DP_RANKS, "gloo", f"{image},{DP_SMALL}", device)
    out["gloo_wall_s"] = time.perf_counter() - t0
    # the one-process references, TF32 off as on the ranks
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    refs = {}
    try:
        for size in (image, DP_SMALL):
            one, qx, qy = _dp_net(torch, size, device)
            q0 = _cpu_snapshot(one)
            clock = _StepClock(torch, device, keep=(1, DP_RANK_STEPS))
            one.set_listeners(clock)
            one.fit(_dp_iterator(qx, qy, DP_RANK_STEPS))
            del one
            f64_p, secs = _f64_step(torch, size, q0, qx, qy)
            out[f"f64_step_s_{size}"] = secs
            refs[size] = (q0, clock.snaps, clock.losses, f64_p)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    print(f"[dp] (c) float64 CPU steps: "
          f"{[round(out[f'f64_step_s_{z}'], 1) for z in refs]} s")
    gloo = []
    for r, res in enumerate(ranks):
        rec = {}
        for size in (image, DP_SMALL):
            rec[size] = _hold_rank(torch, r, size, res[size], *refs[size])
        full = res[image]
        launches_ok(full["launches"], DP_RANK_STEPS, f"gloo rank {r}")
        check(full["last_batch_size"] == BATCH,
              f"rank {r}: global batch {full['last_batch_size']}")
        # ZeRO-1: this rank held half of the padded flat state
        held = full["state_bytes"]
        whole = full["state_bytes_whole_padded"]
        check(held and all(b * DP_RANKS == whole for b in held),
              f"rank {r}: updater state {held} bytes a step, the padded "
              f"flat state {whole}")
        gloo.append({"launches": full["launches"],
                     "step_ms": full["step_ms"], "score": full["score"],
                     "checks": rec, "state_bytes": held[0],
                     "state_bytes_whole_padded": whole,
                     "state_bytes_dense": full["state_bytes_dense"]})
        print(f"[dp] (c) gloo rank {r}/{DP_RANKS} on {device}, "
              f"{BATCH // DP_RANKS} rows each, exchange sharded: "
              f"updater state {held[0]} bytes = 1/{DP_RANKS} of the padded "
              f"flat {whole} (dense {full['state_bytes_dense']}); steps "
              f"{[round(m, 3) for m in full['step_ms']]} ms (gloo stages "
              f"through the host: a correctness run, no DP rate); launches "
              f"{full['launches']} [{label}]")
    for size in (image, DP_SMALL):
        for k in p0["params"]:
            for n in p0["params"][k]:
                check(torch.equal(
                    ranks[0][size]["snaps"][DP_RANK_STEPS]["params"][k][n],
                    ranks[1][size]["snaps"][DP_RANK_STEPS]["params"][k][n]),
                    f"ranks differ at {size}x{size} {k}/{n}")
    out["gloo"] = gloo
    print(f"[dp] (c) the ranks agree bitwise after {DP_RANK_STEPS} steps; "
          f"{DP_RANKS} rank processes {out['gloo_wall_s']:.1f}s")
    out["exchanges"] = _check_exchanges(torch, ranks, image, p0["params"],
                                        launches_ok, label, device)
    if not on_card:
        return out

    # ---- (d) a one-rank NCCL group through SharedTrainingMaster ----
    import shutil
    shutil.rmtree(DP_WORK, ignore_errors=True)
    DP_WORK.mkdir(parents=True)
    net_d = _copy_net(torch, base, base.conf, device)
    master = (SharedTrainingMaster.Builder(BATCH)
              .coordinator(f"file://{DP_WORK}/nccl", 1, 0)
              .collective_timeout(300).build())
    try:
        out["nccl"] = res_d = timed_run(
            net_d, lambda: master.fit(net_d, _dp_iterator(x, y, DP_STEPS)),
            "one-rank NCCL group")
        backend = master._mesh.backend
    finally:
        master.shutdown()
        shutil.rmtree(DP_WORK, ignore_errors=True)
    check(backend == "nccl", f"the one-rank group ran {backend}")
    _bitwise(torch, res_d["final"], res_b["final"],
             "one-rank NCCL group vs ParallelWrapper workers=1")
    print(f"[dp] (d) one-rank {backend} group: "
          f"{res_d['median_step_ms']:.3f} ms/step "
          f"({res_d['img_per_s']:.1f} img/s); bitwise equal to (b); "
          f"launches {res_d['launches']} [{label}]")
    del net_d, base
    torch.cuda.empty_cache()
    for r in out.values():
        if isinstance(r, dict):
            r.pop("snaps", None)
            r.pop("final", None)
    return out


# ---------------------------------------------------------------------------
#: the masked attention classifier at BERT-base widths (phase 20)
ATTN = dict(vocab=30522, hidden=768, heads=12, t=128)
#: flash route against the plain route (the dense chain) on the
#: classifier's attention outputs, logits and probabilities: the kernels'
#: f32 forward bar, its atol cut to 2e-6 for activations of ~1e-2
ATTN_FWD_RTOL, ATTN_FWD_ATOL = 2e-5, 2e-6
#: RecurrentAttentionLayer over 128 steps, flash against plain, on its
#: activations and the head's logits (with ATTN_FWD_RTOL): each step's
#: attention differs by the kernels' f32 rounding, and the tanh
#: recurrence carries it on (an H100 read 8.0e-7 on activations up to
#: 0.63 and 6.4e-7 on logits up to 0.47)
RATT_ATOL = 2e-6
#: the char-RNN as a graph against the same network as a layer stack
GRAPH_MLN_ATOL = 1e-6


def attention_classifier_conf(vocab: int, hidden: int, heads: int, t: int,
                              updater, compute: Optional[str] = None,
                              blocks: int = 2, dtype: str = "float32"):
    """Token embedding, ``blocks`` self-attention blocks with residual
    adds, learned-query pooling (one query) and a 2-class softmax head
    behind an RnnToFeedForwardPreProcessor, built with GraphBuilder."""
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_attention import (
        LearnedSelfAttentionLayer, SelfAttentionLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
        RnnToFeedForwardPreProcessor
    g = (NeuralNetConfiguration.Builder().seed(20).updater(updater)
         .data_type(dtype).compute_data_type(compute).graph_builder()
         .add_inputs("tokens").set_input_types(InputType.recurrent(1, t))
         .add_layer("emb", EmbeddingSequenceLayer(n_in=vocab, n_out=hidden),
                    "tokens"))
    prev = "emb"
    for i in range(1, blocks + 1):
        g = (g.add_layer(f"sa{i}", SelfAttentionLayer(n_out=hidden,
                                                      n_heads=heads), prev)
             .add_vertex(f"add{i}", ElementWiseVertex(op="Add"), prev,
                         f"sa{i}"))
        prev = f"add{i}"
    return (g.add_layer("pool", LearnedSelfAttentionLayer(
                n_out=hidden, n_heads=heads, n_queries=1), prev)
             .add_layer("out", OutputLayer(n_out=2),
                        RnnToFeedForwardPreProcessor(), "pool")
             .set_outputs("out").build())


def attention_batch(torch, g, batch: int, t: int, vocab: int):
    """Seeded token ids, a features mask from lengths in [16, t] (one row
    of t and one of 16) and one-hot labels, on the CPU."""
    ids = torch.randint(0, vocab, (batch, t), generator=g)
    lengths = torch.randint(16, t + 1, (batch,), generator=g)
    lengths[0], lengths[1] = t, 16
    mask = (torch.arange(t)[None] < lengths[:, None]).float()
    labels = torch.nn.functional.one_hot(
        torch.randint(0, 2, (batch,), generator=g), 2).float()
    return ids, mask, labels


def _attention_steps(torch, net, ds, steps: int, what: str, label: str,
                     on_card: bool) -> dict:
    """``steps`` masked fit steps, counts to 0 before and read after: 3
    launches each of kernels 7, 8 and 9 a step on the card; the loss
    falls; step ms, sequences/s and the device profile."""
    import numpy as np
    _zero_counts()
    losses, ms = [], []
    for _ in range(steps):
        _sync(torch, "cuda" if on_card else "cpu")
        t0 = time.perf_counter()
        net.fit(ds)
        _sync(torch, "cuda" if on_card else "cpu")
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score())
    launches = _flash_counts()
    print(f"[attn-graph] {what}: losses {[round(v, 5) for v in losses]}; "
          f"launches {launches}")
    check(all(np.isfinite(losses)), f"{what}: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")
    for k in FLASH_KERNELS:
        check(launches[k] == 3 * steps * on_card,
              f"{what} {k}: {launches[k]} launches in {steps} steps, "
              f"expected 3 a step")
    batch = int(ds.features.shape[0])
    step_ms = float(np.median(ms[1:]))
    print(f"[attn-graph] {what}: step {step_ms:.3f} ms (median of steps "
          f"2-{steps}) = {batch * 1e3 / step_ms:.1f} sequences/s [{label}]")
    res = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
           "seq_per_s": batch * 1e3 / step_ms, "launches": launches}
    if on_card:
        res["profile"] = profile_device(
            torch, lambda: net.fit(ds), step_ms, f"{what} step",
            shares=FLASH_KERNELS)
        print(f"[attn-graph] {what}: "
              f"{res['profile'].get('kernel_calls')} device kernels a step "
              f"[{label}]")
    return res


def phase_attention_graph(torch, label: str, device: str = "cuda",
                          dims=None, batch: int = BATCH, steps: int = 10,
                          charrnn_hidden: int = CHARRNN["hidden"]) -> dict:
    """(a) the masked attention classifier trained and held against its
    plain route, (b) RecurrentAttentionLayer through kernels 7-9 a step
    at a time, (c) the char-RNN as a ComputationGraph under truncated
    BPTT. ``device="cpu"`` with small ``dims`` rehearses it (launch
    counts, timings and the profile are the card's)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    d = dict(ATTN, **(dims or {}))
    on_card = device == "cuda"
    V, Hd, heads, t = d["vocab"], d["hidden"], d["heads"], d["t"]
    g = torch.Generator().manual_seed(20)
    ids, mask, labels = attention_batch(torch, g, batch, t, V)
    ids, mask, labels = ids.to(device), mask.to(device), labels.to(device)
    ds = DataSet(ids, labels, features_mask=mask)
    out = {}

    # ---- (a) the classifier: f32, then bf16 compute, from one init ----
    conf = attention_classifier_conf(V, Hd, heads, t, Adam(1e-3))
    net = ComputationGraph(conf).init(
        device, generator=torch.Generator().manual_seed(20))
    p0 = _clone_params(net.params, "cpu")
    print(f"[attn-graph] masked attention classifier: vocab {V}, hidden "
          f"{Hd}, {heads} heads, 2 x SelfAttentionLayer + "
          f"LearnedSelfAttentionLayer(1 query) + OutputLayer(2), "
          f"{net.num_params()} params; batch {batch} x {t}, lengths "
          f"{int(mask.sum(1).min())}..{int(mask.sum(1).max())}; Adam(1e-3) "
          f"on {device}")
    out["f32"] = _attention_steps(torch, net, ds, steps, "f32 masked fit",
                                  label, on_card)
    net16 = ComputationGraph(attention_classifier_conf(
        V, Hd, heads, t, Adam(1e-3), compute="bfloat16")).set_params(
        _clone_params(p0, device), {}, device)
    out["bf16"] = _attention_steps(torch, net16, ds, steps,
                                   "bf16 compute_dtype masked fit", label,
                                   on_card)
    del net16

    # ---- fit_steps on the unmasked batch == as many fit calls ----
    plain_ds = DataSet(ids, labels)
    a, b = (ComputationGraph(conf).set_params(_clone_params(p0, device), {},
                                              device) for _ in range(2))
    prev = torch.are_deterministic_algorithms_enabled()
    # the embedding's backward accumulates with atomics unless the
    # deterministic algorithms are on
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a.fit_steps(plain_ds, steps)
        for _ in range(steps):
            b.fit(plain_ds)
    finally:
        torch.use_deterministic_algorithms(prev)
    _sync(torch, device)
    for k in a.params:
        for n, t_ in a.params[k].items():
            check(torch.equal(t_, b.params[k][n]),
                  f"fit_steps({steps}) vs {steps} fit calls: {k}/{n} differs")
    check(a.score() == b.score() and a.iteration_count == steps,
          f"fit_steps loss {a.score()} vs fit {b.score()}")
    print(f"[attn-graph] fit_steps(ds, {steps}) == {steps} fit calls bit "
          f"for bit (unmasked batch, deterministic algorithms on), last "
          f"loss {a.score():.6f}")
    del a, b

    # ---- flash route against the plain route, from the initial weights
    # (the trained net's softmax is saturated on its one batch) ----
    del net
    net = ComputationGraph(conf).set_params(_clone_params(p0, device), {},
                                            device)
    def attention_acts():
        # every attention layer's output and the head's logits (2-class
        # probabilities near 0.5 would hide differences below their ulp)
        with torch.inference_mode():
            acts, _ = net._forward(net.params, net.states, [ids],
                                   want_logits=True, fmask=mask)
        return {k: acts[k] for k in ("sa1", "sa2", "pool", "out")}

    flash = _with_flash_gate(None, lambda: net.output(ids, mask=mask))
    plain = _with_flash_gate("0", lambda: net.output(ids, mask=mask))
    a_flash = _with_flash_gate(None, attention_acts)
    a_plain = _with_flash_gate("0", attention_acts)
    errs = {k: float((a_flash[k] - a_plain[k]).abs().max()) for k in a_flash}
    for k in a_flash:
        check(bool(torch.allclose(a_flash[k], a_plain[k], rtol=ATTN_FWD_RTOL,
                                  atol=ATTN_FWD_ATOL)),
              f"classifier {k} flash vs plain route: max |d| {errs[k]}")
    err = float((flash - plain).abs().max())
    check(bool(torch.allclose(flash, plain, rtol=ATTN_FWD_RTOL,
                              atol=ATTN_FWD_ATOL)),
          f"classifier output flash vs plain route: max |d| {err}")
    s_flash = _with_flash_gate(None, lambda: net.score(ds))
    s_plain = _with_flash_gate("0", lambda: net.score(ds))
    check(abs(s_flash - s_plain) <= ATTN_FWD_RTOL * abs(s_plain) + 1e-7,
          f"score flash {s_flash} vs plain {s_plain}")
    ev_f = _with_flash_gate(None, lambda: net.evaluate([ds]))
    ev_p = _with_flash_gate("0", lambda: net.evaluate([ds]))
    check((ev_f.confusion_matrix() == ev_p.confusion_matrix()).all(),
          "evaluate flash vs plain route: confusion matrices differ")
    pred = net.predict(ids)
    check(pred.shape == (batch,) and set(pred.tolist()) <= {0, 1},
          f"predict: {pred}")
    # a padded row's answer does not depend on its padded tokens
    other = torch.where(mask > 0, ids, (ids + 7) % V)
    moved = net.output(other, mask=mask)
    check(torch.equal(flash, moved),
          "padded tokens changed a row's answer")
    print(f"[attn-graph] initial classifier, flash route vs plain route: "
          f"max |d| by vertex {errs} (largest |value| "
          f"{ {k: float(v.abs().max()) for k, v in a_plain.items()} }), "
          f"probabilities {err:.3e}, score {s_flash:.7f} vs "
          f"{s_plain:.7f}, evaluate accuracy {ev_f.accuracy():.4f} == "
          f"{ev_p.accuracy():.4f}; padded tokens changed nothing "
          f"(bitwise)")
    out.update(flash_vs_plain_max_abs=max(errs.values()),
               flash_vs_plain_by_vertex=errs, score_flash=s_flash,
               score_plain=s_plain)
    del net

    # ---- (b) RecurrentAttentionLayer over the embedded batch ----
    out["recurrent"] = recurrent_attention_check(torch, label, device, ds,
                                                 d, batch)
    # ---- (b') a head dim of 768: an unprojected self-attention ----
    out["unprojected"] = unprojected_attention_check(torch, label, device,
                                                     mask, Hd)
    # ---- (c) the char-RNN as a graph under truncated BPTT ----
    out["charrnn_graph"] = charrnn_graph_check(torch, label, device,
                                               charrnn_hidden)
    if on_card:
        torch.cuda.empty_cache()
        out["card_vs_cpu"] = attention_card_vs_cpu(torch)
    return out


def recurrent_attention_check(torch, label: str, device: str, ds, d: dict,
                              batch: int) -> dict:
    """tokens -> embedding -> RecurrentAttentionLayer -> last step ->
    OutputLayer(2): one masked forward (one launch of kernel 7 a step of
    the sequence), one masked training step (one of 7, 8 and 9 a step),
    the output held against the plain route."""
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_attention import \
        RecurrentAttentionLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import (
        EmbeddingSequenceLayer, LastTimeStepLayer)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    on_card = device == "cuda"
    V, Hd, heads, t = d["vocab"], d["hidden"], d["heads"], d["t"]
    conf = (NeuralNetConfiguration.Builder().seed(21).updater(Adam(1e-3))
            .graph_builder().add_inputs("tokens")
            .set_input_types(InputType.recurrent(1, t))
            .add_layer("emb", EmbeddingSequenceLayer(n_in=V, n_out=Hd),
                       "tokens")
            .add_layer("ratt", RecurrentAttentionLayer(n_out=Hd,
                                                       n_heads=heads), "emb")
            .add_layer("last", LastTimeStepLayer(), "ratt")
            .add_layer("out", OutputLayer(n_out=2), "last")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(
        device, generator=torch.Generator().manual_seed(21))
    ids, mask = ds.features, ds.features_mask
    _zero_counts()
    _sync(torch, device)
    t0 = time.perf_counter()
    y = net.output(ids, mask=mask)
    _sync(torch, device)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = _flash_counts()
    check(bool(torch.isfinite(y).all()), "RecurrentAttentionLayer output "
                                         "not finite")

    def acts():
        # the layer's activations and the head's logits (2-class
        # probabilities near 0.5 would hide differences below their ulp)
        with torch.inference_mode():
            a, _ = net._forward(net.params, net.states, [ids],
                                want_logits=True, fmask=mask)
        return {k: a[k] for k in ("ratt", "out")}

    a_flash = _with_flash_gate(None, acts)
    a_plain = _with_flash_gate("0", acts)
    errs = {k: float((a_flash[k] - a_plain[k]).abs().max()) for k in a_flash}
    for k in a_flash:
        check(bool(torch.allclose(a_flash[k], a_plain[k], rtol=ATTN_FWD_RTOL,
                                  atol=RATT_ATOL)),
              f"RecurrentAttentionLayer {k} flash vs plain route: max |d| "
              f"{errs[k]}")
    _zero_counts()
    _sync(torch, device)
    t0 = time.perf_counter()
    net.fit(ds)
    _sync(torch, device)
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches = _flash_counts()
    check(np.isfinite(net.score()), f"RecurrentAttentionLayer loss "
                                    f"{net.score()}")
    check(fwd_launches["flash_fwd"] == t * on_card
          and fwd_launches["flash_bwd_dq"] == 0,
          f"RecurrentAttentionLayer forward: launches {fwd_launches}, "
          f"expected {t} of flash_fwd")
    for k in FLASH_KERNELS:
        check(step_launches[k] == t * on_card,
              f"RecurrentAttentionLayer step {k}: {step_launches[k]} "
              f"launches, expected {t}")
    print(f"[attn-graph] RecurrentAttentionLayer({Hd}, {heads} heads) over "
          f"{batch} x {t} masked: forward {fwd_ms:.3f} ms (first call), "
          f"launches {fwd_launches}; one step {step_ms:.3f} ms, launches "
          f"{step_launches}, loss {net.score():.6f}; flash vs plain route "
          f"max |d| by vertex {errs} (largest |value| "
          f"{ {k: float(v.abs().max()) for k, v in a_plain.items()} }) "
          f"[{label}]")
    return {"fwd_ms": fwd_ms, "step_ms": step_ms,
            "fwd_launches": fwd_launches, "step_launches": step_launches,
            "flash_vs_plain_by_vertex": errs}


def unprojected_attention_check(torch, label: str, device: str, mask,
                                hidden: int) -> dict:
    """SelfAttentionLayer(project_input=False) over ``hidden`` seeded
    features under the classifier's features mask: one head of
    ``hidden`` (768: the kernels' wide bodies). One masked forward and
    backward, one launch of each kernel, the output within the flash
    bar and the input gradient within the kernels' f32 gradient bar of
    the plain route."""
    from deeplearning4j_tpu_torch.nn.conf.layers_attention import \
        SelfAttentionLayer
    on_card = device == "cuda"
    batch, t = mask.shape
    g = torch.Generator().manual_seed(24)
    x0 = (0.1 * torch.randn(batch, t, hidden, generator=g)).to(device)
    dy = torch.randn(batch, t, hidden, generator=g).to(device)
    layer = SelfAttentionLayer(n_in=hidden, n_out=hidden, n_heads=1,
                               project_input=False)

    def run():
        x = x0.clone().requires_grad_(True)
        y, _ = layer.forward({}, x, training=True, mask=mask)
        y.backward(dy)
        return y.detach(), x.grad

    _zero_counts()
    _sync(torch, device)
    t0 = time.perf_counter()
    y, gx = run()
    _sync(torch, device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = _flash_counts()
    y_p, gx_p = _with_flash_gate("0", run)
    for k in FLASH_KERNELS:
        check(launches[k] == on_card, f"unprojected SelfAttentionLayer {k}: "
                                      f"{launches[k]} launches, expected 1")
    (_, _), (g_rtol, g_atol) = FLASH_TOL["float32"]
    e_y = float((y - y_p).abs().max())
    e_g = float((gx - gx_p).abs().max())
    check(bool(torch.allclose(y, y_p, rtol=ATTN_FWD_RTOL,
                              atol=ATTN_FWD_ATOL)),
          f"unprojected SelfAttentionLayer output flash vs plain: max |d| "
          f"{e_y}")
    check(bool(torch.allclose(gx, gx_p, rtol=g_rtol, atol=g_atol)),
          f"unprojected SelfAttentionLayer input gradient flash vs plain: "
          f"max |d| {e_g}")
    print(f"[attn-graph] SelfAttentionLayer(project_input=False) over "
          f"{batch} x {t} x {hidden} masked (head dim {hidden}): forward + "
          f"backward {ms:.3f} ms (first call), launches {launches}; flash "
          f"vs plain route max |d| output {e_y:.3e} (largest |value| "
          f"{float(y_p.abs().max()):.3e}), input gradient {e_g:.3e} "
          f"(largest {float(gx_p.abs().max()):.3e}) [{label}]")
    return {"ms": ms, "launches": launches, "output_max_abs": e_y,
            "grad_max_abs": e_g}


def charrnn_graph_check(torch, label: str, device: str, hidden: int
                        ) -> dict:
    """BASELINE #3's char-RNN (2 x GravesLSTM + RnnOutputLayer(80), batch
    64 x 64, Adam(5e-3)) as a ComputationGraph with TRUNCATED_BPTT
    segments of 16: 4 iterations a batch, equal to the layer stack of
    the same configuration and weights within ``GRAPH_MLN_ATOL``; then
    ``rnn_time_step`` one step at a time against ``output``."""
    from deeplearning4j_tpu_torch.activations import Activation
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.lossfunctions import LossFunction
    from deeplearning4j_tpu_torch.nn.conf.builders import (
        BackpropType, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import GravesLSTM
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    vocab, batch, T = CHARRNN["vocab"], CHARRNN["batch"], CHARRNN["seq_len"]
    L = 16
    conf = (NeuralNetConfiguration.Builder().seed(12345).updater(Adam(5e-3))
            .graph_builder().add_inputs("chars")
            .set_input_types(InputType.recurrent(vocab, T))
            .add_layer("lstm0", GravesLSTM(n_out=hidden,
                                           activation=Activation.TANH),
                       "chars")
            .add_layer("lstm1", GravesLSTM(n_out=hidden,
                                           activation=Activation.TANH),
                       "lstm0")
            .add_layer("out", RnnOutputLayer(
                n_out=vocab, loss_function=LossFunction.MCXENT,
                activation=Activation.SOFTMAX), "lstm1")
            .set_outputs("out").backprop_type(BackpropType.TRUNCATED_BPTT)
            .t_bptt_length(L).build())
    graph = ComputationGraph(conf).init(
        device, generator=torch.Generator().manual_seed(12345))
    names = {"layer_0": "lstm0", "layer_1": "lstm1", "layer_2": "out"}
    stack = MultiLayerNetwork(charrnn_conf(hidden, vocab, T, tbptt=L)
                              ).set_params(
        {k: {n: t_.detach().clone() for n, t_ in graph.params[v].items()}
         for k, v in names.items()}, {}, device)
    xn, yn = charrnn_batch(vocab, batch, T)
    x, y = torch.from_numpy(xn).to(device), torch.from_numpy(yn).to(device)
    _sync(torch, device)
    t0 = time.perf_counter()
    graph.fit(x, y)
    _sync(torch, device)
    graph_ms = (time.perf_counter() - t0) * 1e3
    stack.fit(x, y)
    check(graph.iteration_count == stack.iteration_count == T // L,
          f"tBPTT graph: {graph.iteration_count} iterations a batch "
          f"(stack {stack.iteration_count}), expected {T // L}")
    worst = max(float((t_ - graph.params[v][n]).abs().max())
                for k, v in names.items()
                for n, t_ in stack.params[k].items())
    dl = abs(graph.score() - stack.score())
    check(worst <= GRAPH_MLN_ATOL and dl <= GRAPH_MLN_ATOL,
          f"tBPTT graph vs layer stack: params max |d| {worst}, loss |d| "
          f"{dl}")
    graph.rnn_clear_previous_state()
    stream = torch.stack([graph.rnn_time_step(x[:, i]) for i in range(T)],
                         1)
    d_stream = float((stream - graph.output(x)).abs().max())
    check(d_stream <= 1e-5, f"graph rnn_time_step vs output: max |d| "
                            f"{d_stream}")
    print(f"[attn-graph] char-RNN as a graph (2 x GravesLSTM({hidden}), "
          f"batch {batch} x {T}, TRUNCATED_BPTT {L}): {T // L} iterations "
          f"a batch in {graph_ms:.3f} ms (first call); vs the layer stack "
          f"params max |d| {worst:.3e}, loss |d| {dl:.3e}; rnn_time_step "
          f"over {T} steps vs output max |d| {d_stream:.3e} [{label}]")
    return {"tbptt_batch_ms": graph_ms, "vs_stack_max_abs": worst,
            "vs_stack_loss_abs": dl, "stream_max_abs": d_stream}


def attention_card_vs_cpu(torch, device: str = "cuda", batch: int = 2
                          ) -> dict:
    """One f32 Sgd step of the classifier at full width and 2 attention
    layers (one self-attention block and the pooling) on the card and on
    the CPU (on the card's route: the flash gate forced, so the kernels'
    plain versions), against a float64 CPU step, TF32 off."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    V, Hd, heads, t = (ATTN[k] for k in ("vocab", "hidden", "heads", "t"))
    conf = attention_classifier_conf(V, Hd, heads, t, Sgd(0.1), blocks=1)
    cpu = ComputationGraph(conf).init(
        "cpu", generator=torch.Generator().manual_seed(22))
    p0 = _clone_params(cpu.params, "cpu")
    card = ComputationGraph(conf).set_params(_clone_params(p0, device), {},
                                             device)
    cpu64 = ComputationGraph(attention_classifier_conf(
        V, Hd, heads, t, Sgd(0.1), blocks=1, dtype="float64")).set_params(
        {k: {n: v.double() for n, v in sub.items()} for k, sub in
         p0.items()}, {}, "cpu")
    ids, mask, labels = attention_batch(
        torch, torch.Generator().manual_seed(23), batch, t, V)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card.fit(DataSet(ids.to(device), labels.to(device),
                         features_mask=mask.to(device)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    _with_flash_gate("1", lambda: cpu.fit(DataSet(ids, labels,
                                                  features_mask=mask)))
    cpu64.fit(DataSet(ids, labels, features_mask=mask))
    check(abs(card.score() - cpu.score()) <= LOSS_RTOL * abs(cpu.score()),
          f"classifier loss card {card.score()} vs cpu {cpu.score()}")
    floor = BERT_UPDATE_FLOOR * max(
        float((cpu64.params[k][n] - t0.double()).norm())
        for k, sub in p0.items() for n, t0 in sub.items())

    def dist(a, b_):
        return float((a - b_).norm() / b_.norm().clamp_min(floor))

    # each parameter's update against its own CPU reading: an ill-
    # conditioned leaf (the pooling query's keys, whose gradient is near
    # zero at initialisation) must not set the bar of the others
    leaves = {}
    for k, sub in p0.items():
        for n, t0 in sub.items():
            d64 = cpu64.params[k][n] - t0.double()
            dcard = card.params[k][n].detach().cpu().double() - t0.double()
            dcpu = cpu.params[k][n].double() - t0.double()
            ec, eu = dist(dcard, d64), dist(dcpu, d64)
            leaves[f"{k}/{n}"] = {"card_vs_f64": ec, "cpu32_vs_f64": eu,
                                  "card_vs_cpu32": dist(dcard, dcpu)}
            check(ec <= UPDATE_FACTOR * eu + UPDATE_FLOOR,
                  f"classifier card update of {k}/{n} {ec:.3e} from the "
                  f"float64 step, the CPU float32 step's {eu:.3e}")
    worst = max(leaves, key=lambda n: leaves[n]["card_vs_f64"])
    e_card = leaves[worst]["card_vs_f64"]
    e_cpu = max(v["cpu32_vs_f64"] for v in leaves.values())
    e_pair = max(v["card_vs_cpu32"] for v in leaves.values())
    print(f"[attn-graph] card vs CPU, one f32 Sgd step at 2 attention "
          f"layers, batch {batch} x {t} (TF32 off; CPU on the card's "
          f"route): loss {card.score():.7f} vs {cpu.score():.7f} (f64 "
          f"{cpu64.score():.7f}); update in norm by parameter (card vs "
          f"f64, CPU f32 vs f64, card vs CPU f32): "
          + ", ".join(f"{n} {v['card_vs_f64']:.3e} {v['cpu32_vs_f64']:.3e} "
                      f"{v['card_vs_cpu32']:.3e}" for n, v in leaves.items()))
    return {"loss_card": card.score(), "loss_cpu": cpu.score(),
            "update_card_vs_f64": e_card, "update_cpu32_vs_f64": e_cpu,
            "update_card_vs_cpu32": e_pair, "worst": worst,
            "by_parameter": leaves}


# ---------------------------------------------------------------------------
#: phase 21: the char-RNN widths of BASELINE #3 (phase 17), imported as the
#: frozen TF GraphDef of ``lstm_graph.lstm_lm``
TF_LSTM_STEPS = 10
#: relative bars (max |a - b| / max |b|): forwards at the roadmap's
#: default 2e-5, gradients at 2e-4
TF_LSTM_FWD = 2e-5
TF_LSTM_GRAD = 2e-4


def _rel_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _lstm_layer_route(torch, w: dict, batch: int, time_: int, vocab: int,
                      hidden: int, device):
    """The in-port oracle: two ``lstm_layer`` ops and the head in a
    SameDiff of trainable variables, with the same softmax cross-entropy
    and Adam(5e-3) as ``import_and_attach_loss``."""
    import numpy as np

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    sd = SameDiff(device)
    h = sd.placeholder("x", shape=(batch, time_, vocab))
    labels = sd.placeholder("labels", shape=(batch, time_, vocab))
    z = sd.constant("zeros", np.zeros((batch, hidden), np.float32))
    for layer in range(2):
        ws = [sd.var(f"l{layer}_{k}", array=w[f"l{layer}_{k}"])
              for k in ("w", "rw", "b")]
        h = sd._op("lstm_layer", [h, z, z] + ws, n_out=3)[0]
    logits = sd._op("add", [sd._op("matmul", [h, sd.var(
        "out_w", array=w["out_w"])]), sd.var("out_b", array=w["out_b"])],
        name="logits")
    sd._op("softmax_cross_entropy", [labels, logits], name="loss")
    sd.set_loss_variables(["loss"])
    sd.set_training_config(TrainingConfig.Builder().updater(Adam(5e-3))
                           .data_set_feature_mapping("x")
                           .data_set_label_mapping("labels").build())
    return sd


def _api_layer(g, xs, W: dict, layer: int, route: str, batch: int,
               time_: int, hidden: int):
    """One LSTM layer over ``xs`` [t, b, f] through SameDiff's own
    control flow, in the graph ``g`` that ``xs`` lives in: a ``scan`` of
    ``lstm_cell``, or a bounded ``while_loop`` writing a list."""
    import numpy as np
    z = g.constant(np.zeros((batch, hidden), np.float32))
    ws = [W[f"l{layer}_{k}"] for k in ("w", "rw", "b")]
    if route == "scan":
        def step(h, c, xt):
            hn, cn = xt.sd._op("lstm_cell", [xt, h, c] + ws, n_out=2)
            return [hn, cn, hn]
        return g.scan(step, [z, z], [xs])[2]

    def body(t, h, c, acc):
        s = t.sd
        hn, cn = s._op("lstm_cell", [s._op("gather", [xs, t], {"axis": 0}),
                                     h, c] + ws, n_out=2)
        return [s._op("add", [t, s.constant(np.int32(1))]), hn, cn,
                s._op("tensor_list_set_item", [acc, t, hn])]

    return g.while_loop(
        [g.constant(np.int32(0)), z, z,
         g.constant(np.zeros((time_, batch, hidden), np.float32))],
        lambda t, h, c, acc: t.sd._op("lt", [t, t.sd.constant(
            np.int32(time_))]), body, max_iterations=time_)[3]


def _api_model(g, xs, W: dict, route: str, batch: int, time_: int,
               hidden: int):
    h = xs
    for layer in range(2):
        h = _api_layer(g, h, W, layer, route, batch, time_, hidden)
    h = g._op("permute", [h], {"axes": [1, 0, 2]})
    return g._op("add", [g._op("matmul", [h, W["out_w"]]), W["out_b"]])


def phase_tf_lstm(torch, label: str, device: str = "cuda",
                  hidden: int = CHARRNN["hidden"],
                  steps: int = TF_LSTM_STEPS) -> dict:
    """Phase 21: the 2 x LSTM(512) character model (vocab 80, batch 64 x
    64) written as TF's frozen GraphDef by ``lstm_graph``, imported
    through ``TensorflowFrameworkImporter.run_import`` (``device=None``
    on the card), served by ``SameDiff.output`` and trained by
    ``fit_steps``: (a) the bounded functional import's logits against two
    ``lstm_layer`` ops and the head, and card against CPU; (b) the v1
    form's op list and logits (bitwise) against the functional form's;
    (c) 10 Adam steps, the first 3 with gradients held to the
    ``lstm_layer`` route's; (d) ``sd.while_loop`` (bounded), ``sd.scan``
    and ``sd.cond`` around them over ``lstm_cell`` give (a)'s logits;
    (e) the unbounded import serves the forward and refuses a gradient;
    (f) forward and step ms, host reads and device kernels a step, the
    idle share, peak memory beside the TensorList storage. TF32 off.
    ``device="cpu"`` with a small ``hidden`` rehearses it."""
    import numpy as np

    from deeplearning4j_tpu_torch.autodiff import registry
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        TensorflowFrameworkImporter, lstm_graph)
    on_card = device == "cuda"
    vocab, batch, T = CHARRNN["vocab"], CHARRNN["batch"], CHARRNN["seq_len"]
    H = hidden
    t_phase = time.perf_counter()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w = lstm_graph.lstm_weights(vocab, H, seed=0)
        t0 = time.perf_counter()
        gd = {f: lstm_graph.build_lstm_graph(batch, T, vocab, H, form=f)
              for f in ("functional", "v1")}
        build_s = time.perf_counter() - t0
        shapes = {"x": (batch, T, vocab)}
        imp_dev = None if on_card else device
        xn, yn = charrnn_batch(vocab, batch, T)
        x = torch.from_numpy(xn).to(device)
        feed = {"x": x, "labels": torch.from_numpy(yn).to(device)}
        out = {"graphdef_bytes": {f: len(b) for f, b in gd.items()},
               "build_s": build_s}
        print(f"[tf-lstm] lstm_lm: 2 x LSTM({H}) + head({vocab}), batch "
              f"{batch} x {T}; GraphDef functional "
              f"{len(gd['functional'])} / v1 {len(gd['v1'])} bytes, "
              f"written in {build_s:.2f}s")

        # ---- (a) the bounded functional import against the oracle ----
        _zero_counts()
        t0 = time.perf_counter()
        sd = TensorflowFrameworkImporter.run_import(
            gd["functional"], shapes, while_max_iterations=T,
            device=imp_dev)
        out["import_s"] = time.perf_counter() - t0
        check(sd.device.type == device,
              f"run_import(device=None) landed on {sd.device}")
        logits = sd.output({"x": x}, ["Identity"])["Identity"]
        oracle = _lstm_layer_route(torch, w, batch, T, vocab, H, device)
        want = oracle.output({"x": x}, ["logits"])["logits"]
        check(tuple(logits.shape) == (batch, T, vocab)
              and bool(torch.isfinite(logits).all()),
              f"(a) logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        err_a = _rel_max(logits, want)
        check(err_a <= TF_LSTM_FWD, f"(a) imported logits vs lstm_layer "
                                    f"route: {err_a:.3e} > {TF_LSTM_FWD}")
        out["fwd_vs_lstm_layer"] = err_a
        if on_card:
            cpu = TensorflowFrameworkImporter.run_import(
                gd["functional"], shapes, while_max_iterations=T,
                device="cpu")
            got = cpu.output({"x": xn}, ["Identity"])["Identity"]
            out["card_vs_cpu"] = _rel_max(logits.cpu(), got)
            check(out["card_vs_cpu"] <= TF_LSTM_FWD,
                  f"(a) card vs CPU {out['card_vs_cpu']:.3e}")
            del cpu
        print(f"[tf-lstm] (a) imported in {out['import_s']:.2f}s; logits vs "
              f"2 x lstm_layer + head: {err_a:.3e} (max |d| / max |ref|), "
              f"card vs CPU {out.get('card_vs_cpu', float('nan')):.3e} "
              f"[{label}]")

        out["section_s"] = {"a": time.perf_counter() - t_phase}
        # ---- (b) the v1 frame form: the same program, the same bits ----
        v1 = TensorflowFrameworkImporter.run_import(
            gd["v1"], shapes, while_max_iterations=T, device=imp_dev)
        ops = {k: [o.op_name for o in g.ops if o.op_name != "identity"]
               for k, g in (("functional", sd), ("v1", v1))}
        check(ops["v1"] == ops["functional"],
              f"(b) op lists differ: {ops}")
        v1_logits = v1.output({"x": x}, ["Identity"])["Identity"]
        check(torch.equal(v1_logits, logits),
              f"(b) v1 logits differ by {_rel_max(v1_logits, logits):.3e}")
        out["ops"] = ops["functional"]
        print(f"[tf-lstm] (b) v1 form deframed to the same {len(ops['v1'])} "
              f"ops ({', '.join(ops['v1'])}; identities aside), logits "
              f"bitwise equal [{label}]")
        del v1

        out["section_s"]["b"] = time.perf_counter() - t_phase
        # ---- (c) training: 10 Adam steps, 3 against the oracle ----
        tr, _ = lstm_graph.import_and_attach_loss(
            gd["functional"], batch, T, vocab, updater=Adam(5e-3),
            while_max_iterations=T, device=imp_dev)
        names = lstm_graph.weight_names("functional")
        grad_errs, losses, step_ms = [], [], []
        for i in range(steps):
            if i < 3:
                gi = tr.calculate_gradients(feed, list(names.values()))
                go = oracle.calculate_gradients(feed, list(names))
                grad_errs.append(max(_rel_max(gi[names[k]], go[k])
                                     for k in names))
                check(grad_errs[-1] <= TF_LSTM_GRAD,
                      f"(c) step {i + 1} gradients vs lstm_layer route: "
                      f"{grad_errs[-1]:.3e}")
                oracle.fit_steps(feed, 1)
            _sync(torch, device)
            t0 = time.perf_counter()
            losses.append(tr.fit_steps(feed, 1))
            _sync(torch, device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"(c) loss did not fall: {losses}")
        med = float(np.median(step_ms[1:]))
        out.update(losses=losses, grad_vs_lstm_layer=grad_errs,
                   step_ms=step_ms, median_step_ms=med,
                   chars_per_s=batch * T * 1e3 / med)
        print(f"[tf-lstm] (c) losses {[round(v, 4) for v in losses]}; "
              f"steps 1-3 gradients vs lstm_layer route "
              f"{[f'{e:.3e}' for e in grad_errs]}; step {med:.3f} ms "
              f"(median of steps 2-{steps}) = {out['chars_per_s']:.1f} "
              f"chars/s [{label}]")
        out["launches"] = _counts()
        check(not any(out["launches"].values()),
              f"a ported kernel launched on the LSTM path: "
              f"{out['launches']}")

        out["section_s"]["c"] = time.perf_counter() - t_phase
        # ---- (d) SameDiff's own while_loop / scan / cond ----
        api = SameDiff(device)
        xph = api.placeholder("x", shape=(batch, T, vocab))
        flag = api.placeholder("flag", shape=(), dtype="bool")
        W = {k: api.constant(k, v) for k, v in w.items()}
        xs = api._op("permute", [xph], {"axes": [1, 0, 2]})
        routes = {r: _api_model(api, xs, W, r, batch, T, H).name
                  for r in ("while_loop", "scan")}
        routes["cond"] = api.cond(
            flag, lambda v: _api_model(v.sd, v, W, "scan", batch, T, H),
            lambda v: _api_model(v.sd, v, W, "while_loop", batch, T, H),
            [xs]).name
        out["api_vs_import"] = {}
        for f in (True, False):
            res = api.output({"x": x, "flag": np.asarray(f)},
                             list(routes.values()))
            for r, n in routes.items():
                key = r if r != "cond" else f"cond_{str(f).lower()}"
                out["api_vs_import"][key] = _rel_max(res[n], logits)
        bad = {k: v for k, v in out["api_vs_import"].items()
               if not v <= TF_LSTM_FWD}
        check(not bad, f"(d) SameDiff control flow vs (a): {bad}")
        print(f"[tf-lstm] (d) sd.while_loop / sd.scan / sd.cond (both "
              f"branches) vs (a): "
              f"{ {k: f'{v:.3e}' for k, v in out['api_vs_import'].items()} }"
              f" [{label}]")
        del api

        out["section_s"]["d"] = time.perf_counter() - t_phase
        # ---- (e) the unbounded import ----
        ub, _ = lstm_graph.import_and_attach_loss(
            gd["functional"], batch, T, vocab, device=imp_dev)
        reads = registry.HOST_READS["while_loop"]
        ub_logits = ub.output({"x": x}, ["Identity"])["Identity"]
        out["unbounded_host_reads_per_forward"] = \
            registry.HOST_READS["while_loop"] - reads
        check(out["unbounded_host_reads_per_forward"] == 2 * (T + 1),
              f"(e) {out['unbounded_host_reads_per_forward']} host reads")
        out["unbounded_bitwise"] = bool(torch.equal(ub_logits, logits))
        check(_rel_max(ub_logits, logits) <= TF_LSTM_FWD,
              f"(e) unbounded logits vs bounded {_rel_max(ub_logits, logits)}")
        try:
            ub.calculate_gradients(feed, [names["l0_w"]])
            raised = ""
        except NotImplementedError as e:
            raised = str(e)
        check("max_iterations" in raised,
              f"(e) a gradient through the unbounded loop did not raise "
              f"({raised!r})")
        print(f"[tf-lstm] (e) unbounded: {2 * (T + 1)} host reads a forward,"
              f" logits bitwise equal to the bounded import's: "
              f"{out['unbounded_bitwise']}; a gradient raises: "
              f"{raised[:60]}... [{label}]")

        out["section_s"]["e"] = time.perf_counter() - t_phase
        # ---- (f) costs ----
        def fwd():
            return sd.output({"x": x}, ["Identity"])["Identity"]

        fwd_ms = []
        for _ in range(6):
            _sync(torch, device)
            t0 = time.perf_counter()
            fwd()
            _sync(torch, device)
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        out["fwd_ms"] = fwd_ms
        out["median_fwd_ms"] = float(np.median(fwd_ms[1:]))
        reads = dict(registry.HOST_READS)
        tr.fit_steps(feed, 1)
        out["host_reads_per_step"] = sum(
            registry.HOST_READS[k] - reads[k] for k in reads)
        check(out["host_reads_per_step"] == 0,
              f"(f) the bounded step read the host "
              f"{out['host_reads_per_step']} times")
        # the masked loop's TensorList storage, one [t, b, H] f32 tensor
        # a trip a layer
        out["storage_bytes"] = 2 * T * T * batch * H * 4
        if on_card:
            def step_peak(g):
                """A step's peak memory, and its rise over what was
                allocated before the step (the earlier phases' too)."""
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated() / 2 ** 20
                _, peak = _peak_mb(torch, device, lambda: g.fit_steps(feed, 1))
                return peak, peak - base

            out["peak_mb"], out["step_rise_mb"] = step_peak(tr)
            out["lstm_layer_peak_mb"], out["lstm_layer_step_rise_mb"] = \
                step_peak(oracle)
            out["fwd_profile"] = profile_device(
                torch, fwd, out["median_fwd_ms"], "imported LSTM forward")
            out["profile"] = profile_device(
                torch, lambda: tr.fit_steps(feed, 1), med,
                "imported LSTM step")
            out["ub_fwd_ms"] = _host_ms(
                torch, lambda: ub.output({"x": x}, ["Identity"]))
            print(f"[tf-lstm] (f) forward {out['median_fwd_ms']:.3f} ms "
                  f"(unbounded {out['ub_fwd_ms']:.3f} ms, "
                  f"{2 * (T + 1)} host reads), step {med:.3f} ms, "
                  f"{out['host_reads_per_step']} host reads a step, "
                  f"{out['profile'].get('kernel_calls')} device kernels a "
                  f"step ({out['fwd_profile'].get('kernel_calls')} a "
                  f"forward), idle share "
                  f"{out['profile'].get('idle_share', float('nan')):.3f} "
                  f"(forward "
                  f"{out['fwd_profile'].get('idle_share', float('nan')):.3f}"
                  f"), peak {out['peak_mb']:.1f} MB a step, "
                  f"{out['step_rise_mb']:.1f} MB over what was allocated "
                  f"before it (lstm_layer route {out['lstm_layer_peak_mb']:.1f}"
                  f" / {out['lstm_layer_step_rise_mb']:.1f} MB; the masked "
                  f"loops' TensorList storage, 2 x {T} x [{T}, {batch}, "
                  f"{H}] f32, {out['storage_bytes'] / 2 ** 20:.1f} MB) "
                  f"[{label}]")
        del ub
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"[tf-lstm] phase 21 in {out['phase_s']:.1f}s (from its start:"
              f" { {k: round(v, 1) for k, v in out['section_s'].items()} })")
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


# ---------------------------------------------------------------------------
#: phase 22: the frozen Keras ResNet-50 at full width
TF_RESNET = dict(image=224, classes=1000, batch=32, seed=0)
TF_RESNET_STEPS = 10
#: card f32 (TF32 off) against the CPU in float64, relative in norm
TF_RESNET_RTOL = 1e-4
#: the domain sweep, card against the CPU: floats (the card's own
#: algorithms and summation orders, TF32 off), exact for the rest
SWEEP_TOL = dict(rtol=1e-4, atol=1e-5)
#: draws of each random op for its moments
SWEEP_DRAWS = 10 ** 6


class _Seeded:
    """Seeded numpy inputs for one op's cases: ``RandomState`` from the
    op's name."""

    def __init__(self, name: str):
        import zlib

        import numpy as np
        self.np = np
        self.rs = np.random.RandomState(zlib.crc32(name.encode()))

    def f(self, *shape, lo=-1.0, hi=1.0):
        return self.rs.uniform(lo, hi, shape).astype(self.np.float32)

    def n(self, *shape):
        return self.rs.randn(*shape).astype(self.np.float32)

    def i(self, lo, hi, *shape):
        return self.rs.randint(lo, hi, shape).astype(self.np.int32)

    def b(self, *shape):
        return self.rs.rand(*shape) < 0.5


def domain_cases() -> dict:
    """op -> [(inputs, attrs), ...] for the 60 ops of the linalg,
    bitwise, segment, convolution, image, random and compression
    domains, at small shapes: strides 1 and 2, ``SAME`` / ``VALID`` /
    explicit padding, even and odd sizes, up- and downscaling, empty
    segments, ties and dropped ids, shift amounts 0, bits-1, bits and
    bits+3. ``tests/test_torch_sd_registry.py`` holds each against the
    JAX package; phase 22 runs each on the card against the CPU."""
    import numpy as np
    c = {}

    def add(name, fn):
        c[name] = fn(_Seeded(name))

    seg = lambda *v: np.asarray(v, np.int32)
    spd = lambda r, n: (lambda a: (a @ a.T + n * np.eye(n)).astype(
        np.float32))(r.n(n, n))
    well = lambda r, *s: (r.n(*s) + 3 * np.eye(s[-1])).astype(np.float32)
    lower = lambda r, n: (np.tril(r.n(n, n)) + 3 * np.eye(n)).astype(
        np.float32)
    # linalg (well-conditioned inputs)
    add("lu", lambda r: [([well(r, 4, 4)], {}), ([r.n(3, 3)], {})])
    add("qr", lambda r: [([r.n(5, 3)], {}), ([well(r, 3, 3)], {})])
    add("cholesky", lambda r: [([spd(r, 4)], {})])
    add("svd", lambda r: [([r.n(5, 3)], {}),
                          ([r.n(3, 4)], {"full_matrices": False})])
    add("matrix_inverse", lambda r: [([well(r, 3, 3)], {}),
                                     ([well(r, 2, 3, 3)], {})])
    add("matrix_determinant", lambda r: [([well(r, 3, 3)], {}),
                                         ([well(r, 2, 3, 3)], {})])
    add("triangular_solve", lambda r: [
        ([lower(r, 4), r.n(4, 2)], {}),
        ([lower(r, 4).T.copy(), r.n(4, 2)], {"lower": False}),
        ([lower(r, 4), r.n(4)], {"lower": True})])
    add("solve", lambda r: [([well(r, 3, 3), r.n(3, 2)], {}),
                            ([well(r, 3, 3), r.n(3)], {})])
    add("trace", lambda r: [([r.n(3, 4)], {}), ([r.n(2, 3, 3)], {}),
                            ([r.i(-5, 5, 3, 3)], {})])
    add("diag", lambda r: [([r.n(4)], {}), ([r.n(3, 3)], {})])
    for nm in ("diag_part", "matrix_diag_part"):
        add(nm, lambda r: [([r.n(2, 3, 4)], {}), ([r.n(4, 3)], {})])
    add("eye", lambda r: [([], {"rows": 3}),
                          ([], {"rows": 2, "cols": 4, "dtype": "int32"})])
    add("matrix_diag", lambda r: [([r.n(2, 3)], {}), ([r.n(4)], {})])
    # bitwise: shift amounts 0, bits-1, bits, bits+3 and one more
    u8 = lambda r: r.rs.randint(0, 256, 6).astype(np.uint8)
    for nm in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(nm, lambda r: [([r.i(-99, 99, 3, 4), r.i(-99, 99, 4)], {}),
                           ([u8(r), u8(r)], {}),
                           ([r.b(3, 4), r.b(3, 4)], {})])
    add("bitwise_not", lambda r: [([r.i(-99, 99, 3, 4)], {}),
                                  ([u8(r)], {})])
    shifts = {np.int32: [0, 31, 32, 35, 3, -1], np.uint8: [0, 7, 8, 11, 3, 1],
              np.int16: [0, 15, 16, 19, 5, -2], np.int8: [0, 7, 8, 11, 2, 1]}

    def shift_cases(r):
        out = []
        for dt, s in shifts.items():
            info = np.iinfo(dt)
            x = r.rs.randint(info.min, int(info.max) + 1, 6).astype(dt)
            x[0], x[1] = info.min, -1 if info.min < 0 else info.max
            out.append(([x, np.asarray(s, dt)], {}))
        return out
    for nm in ("left_shift", "right_shift", "cyclic_shift_left",
               "cyclic_shift_right"):
        add(nm, shift_cases)
    # segment: an empty segment, ties, dropped ids (negative, too large)
    tied = np.asarray([[1, 2], [1, 5], [3, 3], [0, 3], [2, 2], [2, -1]],
                      np.float32)
    for nm in ("segment_sum", "unsorted_segment_sum"):
        add(nm, lambda r: [
            ([r.n(6, 3), seg(0, 0, 1, 3, 3, 3)], {}),
            ([r.n(6, 3), seg(2, -1, 0, 7, 2, 1)], {"num_segments": 5}),
            ([r.i(-9, 9, 6), seg(3, 0, 1, 0, 3, 3)], {})])
    for nm in ("segment_max", "segment_min", "unsorted_segment_max",
               "unsorted_segment_min"):
        add(nm, lambda r: [
            ([r.n(6, 3), seg(1, 0, 2, 0, 1, 2)], {}),
            ([tied, seg(0, 0, 1, 1, 4, 4)], {"num_segments": 6}),
            ([r.n(6, 3), seg(2, -1, 0, 7, 2, 1)], {"num_segments": 5}),
            ([r.i(-9, 9, 6), seg(3, 0, 1, 0, 3, 3)], {})])
    for nm in ("segment_prod", "unsorted_segment_prod"):
        add(nm, lambda r: [
            ([r.f(6, 3, lo=0.5, hi=1.5), seg(0, 0, 1, 3, 3, 3)], {}),
            ([r.i(-3, 4, 6), seg(2, -1, 0, 7, 2, 1)], {"num_segments": 5})])
    for nm in ("segment_mean", "unsorted_segment_mean",
               "unsorted_segment_sqrt_n"):
        add(nm, lambda r: [
            ([r.n(6, 3), seg(0, 0, 1, 3, 3, 3)], {}),
            ([r.n(6, 3), seg(2, -1, 0, 7, 2, 1)], {"num_segments": 5}),
            ([r.i(-9, 9, 6), seg(3, 0, 1, 0, 3, 3)], {})])
    # convolution (TF's SAME pads more at the end when the total is odd)
    add("conv2d", lambda r: [
        ([r.n(2, 5, 5, 3), r.n(3, 3, 3, 4) * 0.3], {"stride": (1, 1),
                                                    "padding": "SAME"}),
        ([r.n(2, 6, 6, 3), r.n(3, 3, 3, 4) * 0.3, r.n(4)],
         {"stride": (2, 2), "padding": "SAME"}),
        ([r.n(2, 7, 7, 3), r.n(3, 3, 3, 4) * 0.3], {"stride": (2, 2),
                                                    "padding": "SAME"}),
        ([r.n(2, 6, 5, 3), r.n(2, 3, 3, 4) * 0.3], {"stride": (2, 1),
                                                    "padding": "VALID"}),
        ([r.n(1, 5, 6, 2), r.n(3, 2, 2, 3) * 0.3],
         {"stride": (1, 2), "padding": [(1, 2), (0, 1)]}),
        ([r.n(1, 7, 7, 2), r.n(3, 3, 2, 3) * 0.3],
         {"padding": "SAME", "dilation": (2, 2)}),
        ([r.n(1, 8, 8, 3), r.n(1, 1, 3, 4) * 0.3], {"stride": (2, 2),
                                                    "padding": "VALID"})])
    add("conv1d", lambda r: [
        ([r.n(2, 7, 3), r.n(3, 3, 4) * 0.3], {"stride": 2}),
        ([r.n(2, 8, 3), r.n(2, 3, 4) * 0.3, r.n(4)], {"padding": "VALID"}),
        ([r.n(1, 6, 2), r.n(3, 2, 3) * 0.3], {"padding": [(2, 0)],
                                              "dilation": 2})])
    add("conv3d", lambda r: [
        ([r.n(1, 4, 5, 5, 2), r.n(3, 3, 3, 2, 3) * 0.3], {}),
        ([r.n(1, 5, 4, 6, 2), r.n(2, 2, 2, 2, 3) * 0.3, r.n(3)],
         {"stride": (2, 2, 2)}),
        ([r.n(1, 4, 4, 4, 2), r.n(2, 2, 2, 2, 3) * 0.3],
         {"stride": (1, 2, 1), "padding": "VALID"})])
    add("depthwise_conv2d", lambda r: [
        ([r.n(2, 6, 6, 3), r.n(3, 3, 3, 2) * 0.3], {"stride": (2, 2)}),
        ([r.n(2, 5, 5, 3), r.n(3, 3, 3, 2) * 0.3, r.n(6)],
         {"padding": "VALID"}),
        ([r.n(1, 5, 6, 2), r.n(2, 2, 2, 1) * 0.3],
         {"padding": [(0, 1), (1, 1)]})])
    add("separable_conv2d", lambda r: [
        ([r.n(1, 5, 5, 2), r.n(3, 3, 2, 2) * 0.3, r.n(1, 1, 4, 3) * 0.3,
          r.n(3)], {"stride": (2, 2)}),
        ([r.n(1, 6, 6, 2), r.n(3, 3, 2, 1) * 0.3, r.n(1, 1, 2, 3) * 0.3],
         {"padding": "VALID"})])
    add("deconv2d", lambda r: [
        ([r.n(1, 4, 4, 3), r.n(3, 3, 3, 2) * 0.3], {"stride": (2, 2)}),
        ([r.n(1, 5, 5, 3), r.n(3, 3, 3, 2) * 0.3, r.n(2)],
         {"stride": (2, 2), "padding": "VALID"}),
        ([r.n(2, 3, 4, 3), r.n(3, 3, 2, 3) * 0.3],
         {"stride": (2, 1), "padding": "SAME", "transpose_kernel": True}),
        ([r.n(1, 4, 4, 2), r.n(2, 2, 2, 3) * 0.3],
         {"stride": (2, 2), "padding": [(1, 1), (0, 2)]}),
        ([r.n(1, 5, 5, 2), r.n(3, 3, 2, 2) * 0.3],
         {"stride": (1, 1), "dilation": (2, 2)}),
        ([r.n(1, 3, 3, 2), r.n(1, 1, 2, 2) * 0.3], {"stride": (2, 2)})])
    for nm in ("max_pool2d", "avg_pool2d"):
        add(nm, lambda r: [
            ([r.n(2, 5, 5, 3)], {"kernel": (3, 3), "stride": (2, 2),
                                 "padding": "SAME"}),
            ([r.n(2, 6, 6, 3)], {}),
            ([r.n(2, 6, 7, 2)], {"kernel": (3, 2), "stride": (1, 2),
                                 "padding": "SAME"}),
            ([r.n(1, 5, 5, 2)], {"kernel": (3, 3), "stride": (2, 2),
                                 "padding": [(0, 0), (1, 1), (1, 0),
                                             (0, 0)]})])
    for nm in ("max_pool1d", "avg_pool1d"):
        add(nm, lambda r: [([r.n(2, 7, 3)], {"kernel": 3, "stride": 2,
                                             "padding": "SAME"}),
                           ([r.n(2, 8, 3)], {})])
    for nm in ("max_pool3d", "avg_pool3d"):
        add(nm, lambda r: [([r.n(1, 5, 4, 4, 2)], {"padding": "SAME"}),
                           ([r.n(1, 4, 4, 6, 2)], {"kernel": (2, 2, 3),
                                                   "stride": (1, 2, 3)})])
    add("upsampling2d", lambda r: [([r.n(2, 3, 4, 2)], {}),
                                   ([r.n(1, 2, 3, 2)], {"scale": (2, 3)})])
    for nm in ("im2col", "extract_image_patches"):
        add(nm, lambda r: [([r.n(2, 6, 5, 3)], {"kernel": (2, 3),
                                                "stride": (2, 1)}),
                           ([r.n(1, 4, 4, 2)], {"kernel": (2, 2)})])
    # image: up- and downscaling (jax.image.resize antialiases down)
    add("resize_bilinear", lambda r: [
        ([r.n(1, 4, 5, 2)], {"size": (7, 9)}),
        ([r.n(2, 9, 8, 2)], {"size": (4, 3)}),
        ([r.n(1, 5, 6, 2)], {"size": (5, 3)}),
        ([r.i(0, 255, 1, 4, 4, 1)], {"size": (6, 2)})])
    add("resize_nearest", lambda r: [
        ([r.n(1, 4, 5, 2)], {"size": (7, 9)}),
        ([r.n(2, 9, 8, 2)], {"size": (4, 3)}),
        ([r.n(1, 5, 6, 2)], {"size": (7, 4),
                             "coordinate_mode": "asymmetric"})])
    add("resize_bicubic", lambda r: [
        ([r.n(1, 5, 6, 2)], {"size": (8, 4)}),
        ([r.n(1, 5, 6, 2)], {"size": (3, 9), "cubic_coeff_a": -0.75,
                             "boundary": "clamp"})])
    add("resize_area", lambda r: [([r.n(1, 6, 8, 2)], {"size": (3, 5)}),
                                  ([r.n(1, 4, 3, 2)], {"size": (6, 5)})])
    # crops whose samples miss integer pixel positions (where the
    # bilinear weights are not differentiable), one extrapolating
    add("crop_and_resize", lambda r: [
        ([r.n(2, 6, 7, 3),
          np.asarray([[0.05, 0.12, 0.83, 0.91], [0.02, 0.03, 0.97, 0.98],
                      [-0.1, 0.3, 1.23, 0.6]], np.float32),
          seg(0, 1, 1)], {"crop_size": (4, 5)}),
        ([r.n(1, 5, 5, 2), np.asarray([[0.2, 0.2, 0.6, 0.7]], np.float32),
          seg(0)], {"crop_size": (1, 3)})])

    def nms_case(r):
        boxes = np.asarray([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                            [0, 10, 1, 11], [0, 10.1, 1, 11.1],
                            [0, 100, 1, 101]], np.float32)
        scores = np.asarray([0.9, 0.75, 0.6, 0.95, 0.5, 0.3], np.float32)
        tie = scores.copy()
        tie[3] = 0.9                       # a tie: the first index wins
        return [([boxes, scores], {"max_output_size": 4}),
                ([boxes, tie], {"max_output_size": 8,
                                "iou_threshold": 0.3}),
                ([boxes, scores], {"max_output_size": 6,
                                   "iou_threshold": 0.95})]
    add("non_max_suppression", nms_case)
    # random: the key comes from the caller (SameDiff: the op's own)
    add("random_normal", lambda r: [([], {"shape": (3, 4), "mean": 1.0,
                                          "stddev": 2.0})])
    add("random_uniform", lambda r: [([], {"shape": (5,), "min": -2.0,
                                           "max": 3.0})])
    add("random_bernoulli", lambda r: [([], {"shape": (2, 3),
                                             "prob": 0.3})])
    add("dropout", lambda r: [([r.n(4, 5)], {"rate": 0.3}),
                              ([r.n(4, 5)], {"rate": 0.3,
                                             "training": False}),
                              ([r.n(4, 5)], {"rate": 0.5, "rng": None})])
    # compression
    add("encode_threshold", lambda r: [([r.n(4, 5) * 0.01],
                                        {"threshold": 0.01}),
                                       ([r.n(6)], {})])
    add("decode_threshold", lambda r: [([r.n(3, 2)], {})])
    return c


def namespace_graph(sd, seed: int = 0) -> dict:
    """Every method of ``sd.cnn``, ``sd.image``, ``sd.bitwise``,
    ``sd.linalg`` and ``sd.random`` once, on constants drawn from
    ``RandomState(seed)``, through the surface both packages share;
    returns ``{"namespace.method": [output names]}``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    f = lambda *s: sd.constant((rs.randn(*s) * 0.5).astype(np.float32))
    i32 = lambda v: sd.constant(np.asarray(v, np.int32))
    out = {}

    def put(key, v):
        out[key] = [t.name for t in (v if isinstance(v, tuple) else (v,))]

    img = f(2, 6, 6, 3)
    cnn, im, bw, la, rnd = sd.cnn, sd.image, sd.bitwise, sd.linalg, \
        sd.random
    put("cnn.conv2d", cnn.conv2d(img, f(3, 3, 3, 4), f(4), stride=(2, 2)))
    put("cnn.conv1d", cnn.conv1d(f(2, 7, 3), f(3, 3, 4), stride=2))
    put("cnn.depthwise_conv2d", cnn.depthwise_conv2d(img, f(3, 3, 3, 2),
                                                     padding="VALID"))
    put("cnn.separable_conv2d", cnn.separable_conv2d(
        img, f(3, 3, 3, 2), f(1, 1, 6, 4), f(4), stride=(2, 2)))
    put("cnn.deconv2d", cnn.deconv2d(img, f(3, 3, 3, 2), stride=(2, 2)))
    put("cnn.max_pooling2d", cnn.max_pooling2d(img, (3, 3), (2, 2), "SAME"))
    put("cnn.avg_pooling2d", cnn.avg_pooling2d(img, (3, 3), (2, 2), "SAME"))
    put("cnn.upsampling2d", cnn.upsampling2d(img, 2))
    put("cnn.im2col", cnn.im2col(img, (2, 3), (2, 1)))
    put("image.resize_bilinear", im.resize_bilinear(img, (9, 4)))
    put("image.resize_nearest", im.resize_nearest(img, (4, 9)))
    boxes = sd.constant(np.asarray([[0.05, 0.12, 0.83, 0.91],
                                    [0.02, 0.03, 0.97, 0.98]], np.float32))
    put("image.crop_and_resize", im.crop_and_resize(img, boxes,
                                                    i32([1, 0]), (3, 4)))
    nms_boxes = sd.constant(np.asarray(
        [[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, 10, 1, 11], [0, 10.1, 1, 11.1]],
        np.float32))
    put("image.non_max_suppression", im.non_max_suppression(
        nms_boxes, sd.constant(np.asarray([0.9, 0.8, 0.7, 0.95],
                                          np.float32)), 3, 0.3))
    put("image.extract_image_patches", im.extract_image_patches(
        img, (2, 2), (2, 2)))
    a, b = i32(rs.randint(-99, 99, 6)), i32(rs.randint(-99, 99, 6))
    s = i32([0, 31, 32, 35, 3, 1])
    put("bitwise.and_", bw.and_(a, b))
    put("bitwise.or_", bw.or_(a, b))
    put("bitwise.xor", bw.xor(a, b))
    put("bitwise.left_shift", bw.left_shift(a, s))
    put("bitwise.right_shift", bw.right_shift(a, s))
    m = sd.constant((rs.randn(3, 3) + 3 * np.eye(3)).astype(np.float32))
    lo = sd.constant((np.tril(rs.randn(3, 3)) + 3 * np.eye(3)).astype(
        np.float32))
    g = rs.randn(3, 3)
    spd = sd.constant((g @ g.T + 3 * np.eye(3)).astype(np.float32))
    put("linalg.matmul", la.matmul(m, f(3, 2)))
    put("linalg.cholesky", la.cholesky(spd))
    put("linalg.qr", la.qr(f(4, 3)))
    put("linalg.svd", la.svd(f(4, 3)))
    put("linalg.lu", la.lu(m))
    put("linalg.solve", la.solve(m, f(3, 2)))
    put("linalg.triangular_solve", la.triangular_solve(lo, f(3, 2)))
    put("linalg.inverse", la.inverse(m))
    put("linalg.det", la.det(m))
    put("random.normal", rnd.normal(0.0, 1.0, (3, 4)))
    put("random.uniform", rnd.uniform(-1.0, 2.0, (5,)))
    put("random.bernoulli", rnd.bernoulli(0.3, (2, 3)))
    return out


def _outs_of(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _same_up_to_sign(torch, got, want, dim: int) -> bool:
    """Factors equal up to the sign of each vector along ``dim``."""
    sign = torch.sign((got * want).sum(dim, keepdim=True))
    return bool(torch.allclose(got * sign, want, **SWEEP_TOL))


def _card_matches_cpu(torch, name: str, ins, got: list, want: list,
                      what: str) -> None:
    """A card result against the CPU's: floats within ``SWEEP_TOL``,
    integers, booleans and indices exactly; ``qr`` and ``svd`` factors
    (whose signs cuSOLVER and LAPACK may choose apart) by |R| and the
    singular values, vectors up to sign and the reconstruction."""
    check(len(got) == len(want), f"{what}: {len(got)} outputs")
    got = [g.cpu() for g in got]
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: {g.dtype}{tuple(g.shape)} vs {w.dtype}"
              f"{tuple(w.shape)}")
    x = torch.as_tensor(ins[0]) if ins else None
    if name == "qr":
        q, r = got
        check(bool(torch.allclose(q @ r, x, **SWEEP_TOL))
              and bool(torch.allclose(r.abs(), want[1].abs(), **SWEEP_TOL))
              and _same_up_to_sign(torch, q, want[0], 0),
              f"{what}: Q R vs x, |R| or Q up to sign")
        return
    if name == "svd":
        u, s, vh = got
        check(bool(torch.allclose(s, want[1], **SWEEP_TOL))
              and bool(torch.allclose((u * s) @ vh, x, **SWEEP_TOL))
              and _same_up_to_sign(torch, u, want[0], 0)
              and _same_up_to_sign(torch, vh, want[2], -1),
              f"{what}: singular values, U S Vh vs x or vectors up to sign")
        return
    for k, (g, w) in enumerate(zip(got, want)):
        ok = (bool(torch.allclose(g, w, equal_nan=True, **SWEEP_TOL))
              if g.dtype.is_floating_point else bool(torch.equal(g, w)))
        check(ok, f"{what} output {k}: max |d| "
                  f"{(g.double() - w.double()).abs().max():.3e}")


def _random_on_card(torch, name: str, attrs: dict, ins, device: str,
                    what: str) -> dict:
    """A random op on the card: the same key draws the same bits, the
    next key other bits; over ``SWEEP_DRAWS`` draws the mean and the
    standard deviation (dropout: the keep share, and ``where(keep, x /
    (1 - p), 0)``) within 5 sigma of the distribution's."""
    import math

    from deeplearning4j_tpu_torch.autodiff.registry import get_op
    from deeplearning4j_tpu_torch.common.rng import RngKey
    fn = get_op(name)
    key = RngKey(1234)
    x = [torch.as_tensor(a).to(device) for a in ins]

    def run(k, shape=None):
        a = {"_device": device, "rng": k, **attrs}
        if shape is not None and name != "dropout":
            a["shape"] = shape
        args = ([torch.ones(shape, device=device)] if shape is not None
                and name == "dropout" else x)
        return fn(args, a)

    first, again, other = run(key), run(key), run(key.fold_in(1))
    if name == "dropout" and (attrs.get("rng", True) is None
                              or not attrs.get("training", True)):
        check(torch.equal(first, x[0]), f"{what}: not the identity")
        return {}
    check(torch.equal(first, again), f"{what}: one key, two draws differ")
    check(not torch.equal(first, other), f"{what}: two keys, one draw")
    n = SWEEP_DRAWS
    big = run(key.fold_in(2), (n,)).double()
    if name == "random_normal":
        mu, sd = attrs["mean"], attrs["stddev"]
    elif name == "random_uniform":
        lo, hi = attrs["min"], attrs["max"]
        mu, sd = (lo + hi) / 2, (hi - lo) / math.sqrt(12)
        check(bool((big >= lo).all() and (big < hi).all()),
              f"{what}: a draw outside [{lo}, {hi})")
    else:
        p = (attrs["prob"] if name == "random_bernoulli"
             else 1.0 - attrs["rate"])
        keep = big != 0
        if name == "dropout":
            check(bool(torch.allclose(big[keep], torch.full_like(
                big[keep], 1.0 / p), rtol=1e-6, atol=0)),
                f"{what}: a kept value is not x / (1 - p)")
            want = torch.where(first != 0, x[0] / p, torch.zeros_like(x[0]))
            check(torch.equal(first, want),
                  f"{what}: not where(keep, x / (1 - p), 0)")
        big = keep.double()
        mu, sd = p, math.sqrt(p * (1 - p))
    mean, std = float(big.mean()), float(big.std())
    check(abs(mean - mu) <= 5 * sd / math.sqrt(n),
          f"{what}: mean {mean:.5f} vs {mu:.5f}")
    check(abs(std - sd) <= 5 * sd / math.sqrt(2 * n) + 1e-12,
          f"{what}: std {std:.5f} vs {sd:.5f}")
    return {"mean": mean, "std": std}


def sweep_domains(torch, device: str = "cuda") -> dict:
    """Every op of :func:`domain_cases` on ``device`` against the port's
    CPU result (the random ops by their own bits and moments), then
    :func:`namespace_graph` built on ``device`` against the same graph on
    the CPU. Returns the ops and methods run and the random moments."""
    from deeplearning4j_tpu_torch.autodiff.registry import OP_DOMAINS, get_op
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    ran, moments = [], {}
    for name, variants in domain_cases().items():
        for k, (ins, attrs) in enumerate(variants):
            what = f"(f) {name} variant {k}"
            if OP_DOMAINS[name] == "random":
                moments[f"{name}/{k}"] = _random_on_card(
                    torch, name, attrs, ins, device, what)
                continue
            want = _outs_of(get_op(name)(
                [torch.as_tensor(a) for a in ins], {**attrs,
                                                    "_device": "cpu"}))
            got = _outs_of(get_op(name)(
                [torch.as_tensor(a).to(device) for a in ins],
                {**attrs, "_device": device}))
            check(all(g.device.type == device for g in got),
                  f"{what}: an output off the card")
            _card_matches_cpu(torch, name, ins, got, want, what)
        ran.append(name)
    check(len(ran) == 60 and len(set(ran)) == 60,
          f"(f) the sweep ran {len(set(ran))} ops, not 60")
    graphs = {}
    for dev in (device, "cpu"):
        sd = SameDiff(dev)
        graphs[dev] = (sd, namespace_graph(sd))
    (card, names), (cpu, _) = graphs[device], graphs["cpu"]
    flat = [n for v in names.values() for n in v]
    got, want = card.output({}, flat), cpu.output({}, flat)
    for method, outs in names.items():
        op = card.ops[card._producer[outs[0]]]
        g, w = [got[n] for n in outs], [want[n] for n in outs]
        if method.startswith("random."):
            check(all(a.shape == b.shape and a.dtype == b.dtype
                      for a, b in zip(g, w)), f"(f) sd.{method}")
            continue
        _card_matches_cpu(torch, op.op_name, [
            cpu._arrays[cpu.ops[cpu._producer[outs[0]]].inputs[0]]
            .numpy()], g, w, f"(f) sd.{method}")
    return {"ops": ran, "methods": sorted(names), "moments": moments}


#: the segment ops whose repeatability on the card phase 22 reports
SEGMENT_OPS = ("segment_sum", "segment_mean", "unsorted_segment_sqrt_n",
               "segment_max", "segment_min", "segment_prod")


def segment_repeatability(torch, device: str = "cuda") -> dict:
    """Each segment op twice over 2^20 rows of 8 values in 16 segments
    (so the scatters' atomics collide), with PyTorch's deterministic
    algorithms off and on: whether the two results are bitwise equal, or
    ``"refused"`` where the deterministic algorithms say the op has no
    deterministic implementation (any other error fails the phase). max
    and min are exact, so they must repeat either way; sum, mean and
    sqrt_n must repeat under the deterministic algorithms."""
    from deeplearning4j_tpu_torch.autodiff.registry import get_op
    g = torch.Generator(device=device).manual_seed(5)
    n = 1 << 20
    data = torch.randn(n, 8, device=device, generator=g)
    ids = torch.randint(0, 16, (n,), device=device, generator=g).to(
        torch.int32)
    near_one = 1.0 + 1e-4 * data          # a product that stays finite
    prev = torch.are_deterministic_algorithms_enabled()
    out = {}
    try:
        for mode in ("default", "deterministic"):
            torch.use_deterministic_algorithms(mode == "deterministic")
            for name in SEGMENT_OPS:
                x = near_one if name == "segment_prod" else data
                attrs = {"num_segments": 16}
                try:
                    a = get_op(name)([x, ids], attrs)
                    b = get_op(name)([x, ids], attrs)
                except RuntimeError as e:
                    if mode == "default" or \
                            "does not have a deterministic" not in str(e):
                        raise
                    out[f"{name} {mode}"] = "refused"
                    continue
                out[f"{name} {mode}"] = bool(torch.equal(a, b))
    finally:
        torch.use_deterministic_algorithms(prev)
    check(all(isinstance(out[f"{n} default"], bool) for n in SEGMENT_OPS),
          f"(f) segment ops: {out}")
    for name in ("segment_max", "segment_min"):
        check(all(out[f"{name} {m}"] is True
                  for m in ("default", "deterministic")),
              f"(f) {name} did not repeat: {out}")
    for name in ("segment_sum", "segment_mean", "unsorted_segment_sqrt_n"):
        check(out[f"{name} deterministic"] is True,
              f"(f) {name} did not repeat under the deterministic "
              f"algorithms: {out}")
    return out


def _cast_f64(torch, sd) -> None:
    """Every float32 array of ``sd`` (weights and constants) in float64."""
    for n, a in sd._arrays.items():
        if a.dtype == torch.float32:
            sd._arrays[n] = a.double()


def _pin_kinks(torch, ref, sd, x) -> int:
    """Make the float64 graph ``ref`` take ``sd``'s choices at its kinks
    on input ``x``: each ``relu`` becomes a product with the mask of
    ``sd``'s own pre-activations (> 0), each VALID ``max_pool2d`` a gather
    of ``sd``'s argmax. Where a value rounds across a kink the two
    precisions would otherwise differentiate different functions (one
    ReLU moves a weight's gradient by about ``1 / sqrt(C * N)``, 4e-4 in
    norm at C = 64 channels over N = 32 x 56 x 56 positions). Returns the
    number of ops pinned."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.autodiff.samediff import OpNode
    kinks = [o for o in ref.ops if o.op_name in ("relu", "max_pool2d")]
    vals = sd.output({"x": x}, sorted({o.inputs[0] for o in kinks}))
    ops = []
    for o in ref.ops:
        if o.op_name not in ("relu", "max_pool2d"):
            ops.append(o)
            continue
        z, y = o.inputs[0], o.outputs[0]
        if o.op_name == "relu":
            m = ref.constant(f"{y}/pin", (vals[z] > 0).double().cpu())
            ops.append(OpNode("mul", [z, m.name], [y], {}))
            continue
        check(o.attrs.get("padding") == "VALID", f"pin: {y} is not VALID")
        b, h, w, c = vals[z].shape
        _, idx = F.max_pool2d(vals[z].permute(0, 3, 1, 2),
                              tuple(o.attrs["kernel"]),
                              tuple(o.attrs["stride"]), return_indices=True)
        oh, ow = idx.shape[2:]
        flat = (idx.permute(0, 2, 3, 1) * c
                + torch.arange(c, device=idx.device)).reshape(b, -1)
        at = ref.constant(f"{y}/pin", flat.cpu())
        ops += [OpNode("reshape", [z], [f"{y}/pin_rows"],
                       {"shape": [b, h * w * c]}),
                OpNode("gather", [f"{y}/pin_rows", at.name],
                       [f"{y}/pin_picked"], {"axis": 1, "batch_dims": 1}),
                OpNode("reshape", [f"{y}/pin_picked"], [y],
                       {"shape": [b, oh, ow, c]})]
    ref.ops = ops
    ref._producer = {n: i for i, op in enumerate(ops) for n in op.outputs}
    ref._exec_cache.clear()
    return len(kinks)


def _rel_norm(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def phase_tf_resnet(torch, label: str, device: str = "cuda",
                    image: int = TF_RESNET["image"],
                    classes: int = TF_RESNET["classes"],
                    batch: int = TF_RESNET["batch"],
                    steps: int = TF_RESNET_STEPS) -> dict:
    """Phase 22: the frozen Keras ResNet-50 (``keras.applications.
    ResNet50(weights=None)`` at 224x224x3 and 1000 classes, frozen by
    TensorFlow's ``convert_variables_to_constants_v2`` at batch 32)
    written without TensorFlow by ``resnet_graph``, TF32 off for cuBLAS
    and cuDNN: (a) imported by ``run_import`` with ``device=None`` onto
    the card; (b) served by ``sd.output``: logits and probabilities
    finite, each row of probabilities summing to 1 within 1e-5; (c)
    against the same bytes imported on the CPU in float64 within
    ``TF_RESNET_RTOL`` in norm (the logits' scale printed: a saturated
    softmax would prove nothing); (d) two card forwards under the
    deterministic algorithms bitwise equal; (e) every promoted weight's
    gradient at the start within ``TF_RESNET_RTOL`` of the float64 CPU
    gradient taken at the card forward's ReLU and max-pool choices
    (:func:`_pin_kinks`; the unpinned distance is printed beside it),
    then 10 Adam(1e-3) ``fit_steps`` (the loss finite, the last
    below the first; no kernel of ``csrc/`` launches); (f) every op of
    the seven domains ported in this slice and every method of their
    namespaces on the card against the CPU (:func:`sweep_domains`), and
    which segment ops repeat bit for bit (:func:`segment_repeatability`);
    (g)
    forward and step ms, device kernels, the idle share and peak memory.
    ``device="cpu"`` with a small ``image`` and ``batch`` rehearses it
    ((c) and (e) then hold the CPU's f32 against its float64). The
    imported graph is returned under ``"sd"`` for phase 23."""
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        TensorflowFrameworkImporter, resnet_graph)
    on_card = device == "cuda"
    imp_dev = None if on_card else device
    t_phase = time.perf_counter()
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        gd = resnet_graph.build_resnet50_graph(image, classes, batch,
                                               seed=TF_RESNET["seed"])
        out = {"graphdef_bytes": len(gd), "build_s": time.perf_counter() - t0}
        shapes = {"x": (batch, image, image, 3)}
        rs = np.random.RandomState(11)
        xn = rs.randn(batch, image, image, 3).astype(np.float32)
        yn = rs.randint(0, classes, batch).astype(np.int32)
        x = torch.from_numpy(xn).to(device)
        feed = {"x": x, "labels": torch.from_numpy(yn).to(device)}
        # ---- (a) import onto the card ----
        _zero_counts()
        t0 = time.perf_counter()
        sd = TensorflowFrameworkImporter.run_import(gd, shapes,
                                                    device=imp_dev)
        out["import_s"] = time.perf_counter() - t0
        check(sd.device.type == device,
              f"(a) run_import(device=None) landed on {sd.device}")
        out["ops_walked"] = len(sd.ops)
        print(f"[tf-resnet] Keras ResNet-50 {image}x{image}x3 -> {classes}, "
              f"batch {batch}: GraphDef {len(gd)} bytes written in "
              f"{out['build_s']:.2f}s, imported in {out['import_s']:.2f}s "
              f"onto {sd.device}, {out['ops_walked']} ops walked [{label}]")
        # ---- (b) serve ----
        names = ["Identity", resnet_graph.LOGITS]
        res = sd.output({"x": x}, names)
        probs, logits = res["Identity"], res[resnet_graph.LOGITS]
        check(tuple(probs.shape) == (batch, classes)
              and bool(torch.isfinite(probs).all())
              and bool(torch.isfinite(logits).all()),
              f"(b) probabilities {tuple(probs.shape)} not finite")
        row_err = float((probs.double().sum(1) - 1).abs().max())
        check(row_err <= 1e-5, f"(b) a row sums to 1 +- {row_err:.3e}")
        out.update(row_sum_err=row_err,
                   logits_std=float(logits.std()),
                   max_prob=float(probs.max()))
        print(f"[tf-resnet] (b) served {batch} images: rows of probabilities "
              f"sum to 1 within {row_err:.3e}; logits std "
              f"{out['logits_std']:.3f}, largest probability "
              f"{out['max_prob']:.4f} [{label}]")
        # ---- (c) against float64 on the CPU ----
        ref, _ = resnet_graph.import_and_attach_loss(gd, batch, image,
                                                     device="cpu")
        _cast_f64(torch, ref)
        feed64 = {"x": torch.from_numpy(xn).double(),
                  "labels": torch.from_numpy(yn)}
        want = ref.output(feed64, [resnet_graph.LOGITS])[resnet_graph.LOGITS]
        out["logits_vs_f64"] = _rel_norm(logits, want)
        check(out["logits_vs_f64"] <= TF_RESNET_RTOL,
              f"(c) logits vs float64 {out['logits_vs_f64']:.3e}")
        print(f"[tf-resnet] (c) logits vs the CPU's float64 import: "
              f"{out['logits_vs_f64']:.3e} (relative, in norm) [{label}]")
        # ---- (d) the deterministic algorithms: bitwise repeatable ----
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            a = sd.output({"x": x}, ["Identity"])["Identity"]
            b = sd.output({"x": x}, ["Identity"])["Identity"]
        finally:
            torch.use_deterministic_algorithms(prev[2])
        out["deterministic_bitwise"] = bool(torch.equal(a, b))
        check(out["deterministic_bitwise"], "(d) two deterministic forwards "
                                            "differ")
        del a, b
        # ---- (e) gradients and fine-tuning ----
        tr, loss = resnet_graph.import_and_attach_loss(
            gd, batch, image, updater=Adam(1e-3), device=imp_dev)
        wnames = resnet_graph.trainable_names(tr)
        check(len(wnames) == 214, f"(e) {len(wnames)} promoted weights")
        g = tr.calculate_gradients(feed, wnames)

        def worst_vs_f64():
            g64 = ref.calculate_gradients(feed64, wnames)
            errs = {n: _rel_norm(g[n], g64[n]) for n in wnames}
            return max(errs.items(), key=lambda kv: kv[1])

        _, out["grad_vs_f64_unpinned"] = worst_vs_f64()
        out["kinks_pinned"] = _pin_kinks(torch, ref, sd, x)
        worst, out["grad_vs_f64_max"] = worst_vs_f64()
        check(out["grad_vs_f64_max"] <= TF_RESNET_RTOL,
              f"(e) gradient of {worst} vs float64 "
              f"{out['grad_vs_f64_max']:.3e}")
        del g, ref
        losses, step_ms = [], []
        for _ in range(steps):
            _sync(torch, device)
            t0 = time.perf_counter()
            losses.append(tr.fit_steps(feed, 1))
            _sync(torch, device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"(e) loss did not fall: {losses}")
        med = float(np.median(step_ms[1:]))
        out.update(losses=losses, step_ms=step_ms, median_step_ms=med,
                   img_per_s=batch * 1e3 / med)
        out["launches"] = _counts()
        check(not any(out["launches"].values()),
              f"(e) a kernel of csrc/ launched on this path: "
              f"{out['launches']}")
        print(f"[tf-resnet] (e) {len(wnames)} promoted weights' gradients vs "
              f"float64 at the card's ReLU and max-pool choices "
              f"({out['kinks_pinned']} ops pinned): worst "
              f"{out['grad_vs_f64_max']:.3e} ({worst}); unpinned "
              f"{out['grad_vs_f64_unpinned']:.3e}; "
              f"Adam(1e-3) losses {[round(v, 4) for v in losses]}; step "
              f"{med:.3f} ms (median of steps 2-{steps}) = "
              f"{out['img_per_s']:.1f} img/s [{label}]")
        # ---- (f) the seven domains ----
        t0 = time.perf_counter()
        out["sweep"] = sweep_domains(torch, device)
        out["sweep_s"] = time.perf_counter() - t0
        out["segment_repeatable"] = segment_repeatability(torch, device)
        print(f"[tf-resnet] (f) {len(out['sweep']['ops'])} ops of the linalg,"
              f" bitwise, segment, convolution, image, random and "
              f"compression domains and {len(out['sweep']['methods'])} "
              f"namespace methods on {device} vs the CPU in "
              f"{out['sweep_s']:.1f}s; random moments "
              f"{ {k: {m: round(v, 5) for m, v in d.items()} for k, d in out['sweep']['moments'].items() if d} }"
              f" [{label}]")
        print(f"[tf-resnet] (f) segment ops run twice over 2^20 rows in 16 "
              f"segments, bitwise equal (or refused) with PyTorch's "
              f"default and deterministic algorithms: "
              f"{out['segment_repeatable']} [{label}]")

        # ---- (g) costs ----
        def fwd():
            return sd.output({"x": x}, ["Identity"])["Identity"]

        fwd_ms = []
        for _ in range(6):
            _sync(torch, device)
            t0 = time.perf_counter()
            fwd()
            _sync(torch, device)
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        out["fwd_ms"] = fwd_ms
        out["median_fwd_ms"] = float(np.median(fwd_ms[1:]))
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() / 2 ** 20
            _, out["peak_mb"] = _peak_mb(torch, device,
                                         lambda: tr.fit_steps(feed, 1))
            out["step_rise_mb"] = out["peak_mb"] - base
            out["fwd_profile"] = profile_device(
                torch, fwd, out["median_fwd_ms"], "imported ResNet-50 forward")
            out["profile"] = profile_device(
                torch, lambda: tr.fit_steps(feed, 1), med,
                "imported ResNet-50 step")
            print(f"[tf-resnet] (g) forward {out['median_fwd_ms']:.3f} ms "
                  f"({batch * 1e3 / out['median_fwd_ms']:.1f} img/s), step "
                  f"{med:.3f} ms, {out['profile'].get('kernel_calls')} device"
                  f" kernels a step ({out['fwd_profile'].get('kernel_calls')}"
                  f" a forward), idle share "
                  f"{out['profile'].get('idle_share', float('nan')):.3f} "
                  f"(forward "
                  f"{out['fwd_profile'].get('idle_share', float('nan')):.3f})"
                  f", peak {out['peak_mb']:.1f} MB a step, "
                  f"{out['step_rise_mb']:.1f} MB over what was allocated "
                  f"before it [{label}]")
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"[tf-resnet] phase 22 in {out['phase_s']:.1f}s")
        # phase 23 serves this import through the registry
        out["sd"] = sd
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.use_deterministic_algorithms(prev[2])
        if prev[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[3]


# ---------------------------------------------------------------------------
#: phase 23: two replicas of each model behind one ServingRouter
FLEET_REPLICAS = 2
#: (a): single-image JSON requests, then npy requests of 1..8 images
FLEET_JSON, FLEET_NPY = 16, 48
#: latency_slo_ms of ResNet-50's version 2 (single requests) and of the
#: decoder (the first token of a stream in a burst of 32); version 1
#: serves (a)'s bursts without one, whose JSON bodies alone take seconds
#: of host time: under an SLO the admission budget would shed them
FLEET_SLO_MS = {"resnet50": 1000.0, "lm": 5000.0}
#: sequential single-image requests timed through the router and direct
FLEET_LAT_REPS = 20
#: (d): requests through the access log sampled at 0.5
FLEET_LOGGED = 8


def _fleet_post(url: str, body: bytes, ctype: str, headers=None):
    """One ``:predict``: (status, body, headers, client ms); an HTTP error
    returns its status."""
    h = {"Content-Type": ctype}
    h.update(headers or {})
    req = urllib.request.Request(url, data=body, headers=h)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            data, code, hdrs = resp.read(), resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        data, code, hdrs = e.read(), e.code, dict(e.headers)
    return code, data, hdrs, (time.perf_counter() - t0) * 1e3


def _fleet_answer(data: bytes, ctype: str):
    import numpy as np
    if ctype == "application/json":
        return np.asarray(json.loads(data)["outputs"], np.float32)
    return np.load(io.BytesIO(data))


def _padded_ref(net_output, x, bucket: int):
    """``net_output`` of ``x`` in chunks of ``bucket`` rows, each padded
    to the bucket by repeating its last row as the batcher pads."""
    import numpy as np
    outs = []
    for i in range(0, x.shape[0], bucket):
        c = x[i:i + bucket]
        pad = np.concatenate([c, np.repeat(c[-1:], bucket - c.shape[0], 0)])
        outs.append(net_output(pad)[:c.shape[0]])
    return np.concatenate(outs)


def _fleet_gen_client(url: str, prompt, max_tokens: int, tid: str) -> dict:
    """One streaming greedy request carrying trace id ``tid``; each token's
    arrival on the client's wall clock."""
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_tokens": max_tokens}).encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json", "X-Dl4j-Trace-Id": tid})
    t0 = time.time()
    toks, walls, done = [], [], None
    with urllib.request.urlopen(req, timeout=300) as resp:
        code, echoed = resp.status, resp.headers.get("X-Dl4j-Trace-Id")
        replica = resp.headers.get("X-Dl4j-Replica")
        for line in resp:
            rec = json.loads(line)
            if "token" in rec:
                toks.append(rec["token"])
                walls.append(time.time())
            else:
                done = rec
    return {"code": code, "tokens": toks, "times": [w - t0 for w in walls],
            "walls": walls, "done": done, "tid": tid, "echoed": echoed,
            "replica": replica}


def _fleet_gen_load(urls, prompts, max_tokens: int, tids) -> list:
    """Every prompt as a concurrent stream to its url (``urls``: one, or
    one a prompt), in a process of its own (see ``_gen_load``)."""
    urls = [urls] * len(prompts) if isinstance(urls, str) else list(urls)
    for u in sorted(set(urls)):
        with urllib.request.urlopen(u.split("/v1/")[0] + "/healthz",
                                    timeout=60) as resp:
            resp.read()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
        return list(ex.map(
            lambda a: _fleet_gen_client(a[0], a[1], max_tokens, a[2]),
            zip(urls, prompts, tids)))


def _span_tree(events, tid: str, want) -> dict:
    """Check that ``tid``'s spans form one tree: one ``request`` root, the
    names in ``want`` present, every ``req.*`` span of the replica inside
    the root and the router's ``req.route`` begun before it (1 ms of
    slack for the format's integer microseconds). Returns the names."""
    mine = [e for e in events if e.get("args", {}).get("trace") == tid]
    names = {e["name"] for e in mine}
    roots = [e for e in mine if e["name"] == "request"]
    check(len(roots) == 1, f"(d) {tid}: {len(roots)} request roots")
    missing = set(want) - names
    check(not missing, f"(d) {tid}: spans {sorted(missing)} missing")
    r0 = roots[0]["ts"]
    r1 = r0 + roots[0]["dur"]
    for e in mine:
        if e.get("ph") != "X" or e["name"] in ("request", "req.route"):
            continue
        check(r0 - 1000 <= e["ts"] and e["ts"] + e["dur"] <= r1 + 1000,
              f"(d) {tid}: {e['name']} lies outside its request span")
    for e in mine:
        if e["name"] == "req.route":
            check(e["ts"] <= r0 + 1000,
                  f"(d) {tid}: the request began before req.route")
    return sorted(names)


def phase_fleet(torch, label: str, device: str = "cuda", image: int = 224,
                conf=None, gen=None, requests: int = GEN_REQUESTS,
                max_tokens: int = GEN_MAX_TOKENS, checked: int = 8,
                sd=None, sd_image: Optional[int] = None,
                slo_ms: Optional[dict] = None) -> dict:
    """Phase 23: the serving fleet and its request observatory.
    ``ServingRouter(n_replicas=2)`` on the card (both replicas share it),
    each replica its own registry, admission controller (budget: the KV
    pool's blocks) and server; version 2 and the decoder carry
    ``latency_slo_ms`` (``slo_ms``, default ``FLEET_SLO_MS``):
    (a) full-width ResNet-50 rolled out from a zero-argument factory
    (buckets 8 and 32), 64 concurrent ``:predict`` requests through the
    router (16 JSON single images, 48 npy batches of 1..8 images), each
    answer equal to ``net.output`` at a bucket bit for bit, both replicas
    serving, no retrace, 53 launches of kernel 1 a forward; single-request
    latency through the router and direct, img/s of a burst of 32;
    (b) a second version rolled out while two clients keep sending: every
    answer version 1's or version 2's, none failed, then only version 2;
    (c) the GPT-2-small-width decoder of phase 13 on both replicas, 32
    streaming greedy requests through the router (12 launches of kernel 10
    a decode step; ``checked`` of them against ``reference_decode``; each
    first chunk at the client before the replica emitted the stream's
    last token), the same 32 direct to one replica and the same 32
    direct, half to each replica; (d) trace ids
    echoed by the router and a replica, one connected span tree per id in
    the exported chrome trace, ``GET /api/slo`` on both, ``POST
    /api/reqrec/dump`` (one record per completed request), the access log
    at 0.5 keeping one line in two, each with its trace id; (e) the
    server of the replica a lone client reaches stopped while it sends:
    nothing fails, and ``/v1/replicas`` shows it out of rotation; (f)
    ``sd`` (phase 22's
    imported Keras ResNet-50) through ``ModelRegistry.register(...,
    input_name="x")`` over HTTP at 1 and 32 images, equal to
    ``sd.output`` of the same padded batch bit for bit under the
    deterministic algorithms (no kernel of ``csrc/``). ``device="cpu"``
    with a small ``image``, ``conf`` and ``gen`` rehearses it."""
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.common import httputil, telemetry
    from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
    from deeplearning4j_tpu_torch.serving import (AdmissionController,
                                                  ServingRouter, reqrec)
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    slo_ms = slo_ms or FLEET_SLO_MS
    conf = conf or DecoderConfig(**GPT2_SMALL)
    gen = dict(gen or GEN_CONFIG)
    kw = {} if image == 224 else {"height": image, "width": image}
    npy, js = "application/octet-stream", "application/json"
    out = {}
    def n_served():
        return sum(telemetry.MetricsRegistry.get().snapshot().get(
            "dl4j_serving_requests_total", {}).values())

    rec0, served0 = len(reqrec.get().records()), n_served()
    router = ServingRouter(
        FLEET_REPLICAS, device=device, default_buckets=(8, 32),
        admission_factory=lambda: AdmissionController(
            max_queue=gen["kv_blocks"] - 1)).start(0)
    base = router.url
    r0, r1 = router.replicas
    try:
        # ---- (a) the fleet: ResNet-50 on both replicas ----
        # built before the counts go to 0 (the calibration's forward
        # runs kernel 1); the factory hands each replica its own
        nets = [seeded_resnet(torch, device, **kw)
                for _ in router.replicas]
        _zero_counts()
        versions = router.rollout(
            "resnet50", lambda: nets.pop(0),
            warmup_shape=(image, image, 3))
        check(versions[0].model is not versions[1].model,
              "(a) the replicas share one model instance")
        rs = np.random.RandomState(23)
        sizes = [1] * FLEET_JSON + list(rs.randint(1, 9, FLEET_NPY))
        xs = [rs.randn(n, image, image, 3).astype(np.float32)
              for n in sizes]
        bodies = [(json.dumps({"inputs": x.tolist()}).encode(), js)
                  if i < FLEET_JSON else (_npy(x), npy)
                  for i, x in enumerate(xs)]
        url = f"{base}/v1/models/resnet50:predict"
        with concurrent.futures.ThreadPoolExecutor(len(xs)) as pool:
            res = list(pool.map(lambda b: _fleet_post(url, *b), bodies))
        _sync(torch, device)
        launches = _counts()
        forwards = [v.batcher.forwards for v in versions]
        check(all(r[0] == 200 for r in res),
              f"(a) statuses {sorted({r[0] for r in res})}")
        got = np.concatenate([_fleet_answer(r[1], b[1])
                              for r, b in zip(res, bodies)])
        allx = np.concatenate(xs)
        net = versions[0].model

        def out_of(m):
            return lambda a: m.output(a).float().cpu().numpy()
        ref8 = _padded_ref(out_of(net), allx, 8)
        ref32 = _padded_ref(out_of(net), allx, 32)
        at8, at32 = (got == ref8).all(-1), (got == ref32).all(-1)
        bad = np.flatnonzero(~(at8 | at32))
        check(not len(bad), f"(a) rows {bad.tolist()[:8]} equal net.output "
                            f"at neither bucket (max |d| "
                            f"{float(np.abs(got - ref32).max()):.3e})")
        per_replica = {r.name: telemetry.counter(
            "dl4j_serving_router_requests_total").value(
                replica=r.name, code="200") for r in router.replicas}
        check(all(v > 0 for v in per_replica.values())
              and all(f > len(versions[0].batcher.buckets)
                      for f in forwards),
              f"(a) a replica served nothing: {per_replica}, forwards "
              f"{forwards}")
        retraces = [v.retraces_since_warmup() for v in versions]
        check(retraces == [0, 0], f"(a) retraces_since_warmup {retraces}")
        want = {k: 0 for k in launches}
        want["scale_shift_act"] = 53 * sum(forwards) * on_card
        check(launches == want, f"(a) launches {launches}, expected {want} "
                                f"(53 a forward, forwards {forwards})")
        out["a"] = {"launches": launches, "forwards": forwards,
                    "requests_per_replica": per_replica,
                    "rows": int(allx.shape[0]),
                    "rows_at_bucket_32": int(at32.sum()),
                    "rows_at_bucket_8": int(at8.sum())}
        print(f"[fleet] (a) {len(xs)} concurrent predicts ({FLEET_JSON} JSON "
              f"single images, {FLEET_NPY} npy of 1..8; {allx.shape[0]} "
              f"rows) through the router: all == net.output bitwise "
              f"({int(at32.sum())} rows at bucket 32, {int(at8.sum())} at "
              f"8); per replica {per_replica}, forwards {forwards}, "
              f"launches {launches}, retraces {retraces}")
        # latency: single requests through the router and direct
        x1 = xs[FLEET_JSON][:1]
        lat = {"router": [], "direct": []}
        for _ in range(FLEET_LAT_REPS):
            for key, u in (("router", url), ("direct", f"{r0.server.url}"
                                             f"/v1/models/resnet50:predict")):
                code, _, _, ms = _fleet_post(u, _npy(x1), npy)
                check(code == 200, f"(a) single predict {key}: {code}")
                lat[key].append(ms)
        x32 = np.concatenate(xs)[:32]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            burst = list(pool.map(
                lambda i: _fleet_post(url, _npy(x32[i:i + 1]), npy),
                range(32)))
        wall = time.perf_counter() - t0
        check(all(r[0] == 200 for r in burst), "(a) a burst request failed")
        out["a"].update(
            single_ms={k: {"p50": _pct(v, 50), "max": max(v)}
                       for k, v in lat.items()},
            burst32_img_per_s=32 / wall)
        print(f"[fleet] (a) single-image npy predict, ms: through the router "
              f"p50 {_pct(lat['router'], 50):.3f} max "
              f"{max(lat['router']):.3f}; direct to a replica p50 "
              f"{_pct(lat['direct'], 50):.3f} max {max(lat['direct']):.3f} "
              f"({FLEET_LAT_REPS} each, in turns); a burst of 32 through the "
              f"router {32 / wall:.1f} img/s [{label}]")

        # ---- (b) a rollout under load ----
        xb = xs[FLEET_JSON + 1][:1]
        ref1 = _padded_ref(out_of(net), xb, 8)
        made = [seeded_resnet(torch, device, seed=8, **kw)
                for _ in router.replicas]
        fresh = list(made)

        stop, answers = threading.Event(), []

        def client():
            while not stop.is_set():
                answers.append(_fleet_post(url, _npy(xb), npy))

        f1_0 = [v.batcher.forwards for v in versions]
        _zero_counts()
        # two clients: a lone one would always find both replicas idle
        # and go to the first (least-loaded, ties to the first)
        ths = [threading.Thread(target=client) for _ in range(2)]
        for th in ths:
            th.start()
        rolled0 = telemetry.counter("dl4j_serving_rollouts_total").value(
            model="resnet50")
        try:
            v2 = router.rollout("resnet50", lambda: fresh.pop(0),
                                warmup_shape=(image, image, 3),
                                latency_slo_ms=slo_ms["resnet50"])
        finally:
            stop.set()
            for th in ths:
                th.join(timeout=300)
        after = [_fleet_post(url, _npy(xb), npy) for _ in range(4)]
        _sync(torch, device)
        launches = _counts()
        rolled = telemetry.counter("dl4j_serving_rollouts_total").value(
            model="resnet50") - rolled0
        ref2 = _padded_ref(out_of(made[0]), xb, 8)
        check(not np.array_equal(ref1, ref2), "(b) versions 1 and 2 agree")
        check(answers and all(a[0] == 200 for a in answers + after),
              f"(b) a request failed during the rollout: "
              f"{sorted({a[0] for a in answers + after})}")
        seen = {"1": 0, "2": 0}
        for a in answers:
            o = _fleet_answer(a[1], npy)
            ver = a[2].get("X-Model-Version")
            check((ver == "1" and np.array_equal(o, ref1))
                  or (ver == "2" and np.array_equal(o, ref2)),
                  f"(b) an answer of version {ver} equals neither version")
            seen[ver] += 1
        check(all(a[2].get("X-Model-Version") == "2"
                  and np.array_equal(_fleet_answer(a[1], npy), ref2)
                  for a in after), "(b) version 1 answered after the rollout")
        check(rolled == 1, f"(b) dl4j_serving_rollouts_total moved by "
                           f"{rolled}")
        fwd_b = sum(v.batcher.forwards for v in versions) - sum(f1_0) \
            + sum(v.batcher.forwards for v in v2)
        want = {k: 0 for k in launches}
        want["scale_shift_act"] = 53 * fwd_b * on_card
        check(launches == want, f"(b) launches {launches}, expected {want}")
        check([v.retraces_since_warmup() for v in v2] == [0, 0],
              "(b) version 2 retraced")
        out["b"] = {"answers": len(answers), "by_version": seen,
                    "launches": launches, "forwards": fwd_b,
                    "rollouts": rolled}
        print(f"[fleet] (b) rollout of version 2 under load: {len(answers)} "
              f"answers during it ({seen['1']} of version 1, {seen['2']} of "
              f"2), none failed, each bitwise one version's; then only "
              f"version 2; rollouts +{rolled}; launches {launches}")

        # ---- (c) generate through the router ----
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            def lm():
                m = DecoderLM(conf)
                m.init(device, seed=41)
                return m

            _zero_counts()
            lms = router.rollout("lm", lm, generate=gen,
                                 latency_slo_ms=slo_ms["lm"])
            engines = [v.batcher.engine for v in lms]
            grs = np.random.RandomState(43)
            lo, hi = min(gen["prompt_buckets"]) // 4, max(
                gen["prompt_buckets"])
            lens = grs.randint(lo, hi + 1, size=requests)
            lens[0] = hi
            prompts = [grs.randint(0, conf.vocab_size - 1, size=n).tolist()
                       for n in lens]
            tids = [f"fleet-gen-{i}" for i in range(requests)]
            dtids = [f"fleet-direct-gen-{i}" for i in range(requests)]
            stids = [f"fleet-split-gen-{i}" for i in range(requests)]
            gpath = "/v1/models/lm:generate"
            with concurrent.futures.ProcessPoolExecutor(
                    1, mp_context=multiprocessing.get_context("spawn")) as ex:
                routed = ex.submit(_fleet_gen_load, base + gpath, prompts,
                                   max_tokens, tids).result()
                direct = ex.submit(_fleet_gen_load, r0.server.url + gpath,
                                   prompts, max_tokens, dtids).result()
                # half to each replica's own port: the router's relay
                # taken out, two engines sharing the card left in
                split = ex.submit(_fleet_gen_load, [
                    (r0, r1)[i % 2].server.url + gpath
                    for i in range(requests)], prompts, max_tokens,
                    stids).result()
            _sync(torch, device)
            launches = _counts()
            steps = [e.decode_steps for e in engines]
            want = {k: 0 for k in launches}
            want["paged_decode"] = conf.n_layers * sum(steps) * on_card
            check(launches == want, f"(c) launches {launches}, expected "
                                    f"{want} ({conf.n_layers} a decode "
                                    f"step, steps {steps})")
            for r in routed + direct + split:
                check(r["code"] == 200 and r["done"] is not None
                      and r["done"]["tokens"] == len(r["tokens"])
                      and (len(r["tokens"]) == max_tokens
                           or r["done"]["reason"] == "eos"),
                      f"(c) a stream ended badly: {r['code']} {r['done']}")
                check(r["echoed"] == r["tid"], f"(c) trace id {r['tid']} "
                                               f"came back {r['echoed']}")
            by_rep = {n: sum(r["replica"] == n for r in routed)
                      for n in (r0.name, r1.name)}
            check(all(by_rep.values()), f"(c) streams per replica {by_rep}")
            model, n_cmp = lms[0].model, 0
            for i in range(min(checked, requests)):
                n_cmp += _check_against_reference(
                    torch, model, model.params, prompts[i],
                    routed[i]["tokens"], f"routed request {i}")
            same = sum(a == b for r, d in zip(routed, direct)
                       for a, b in zip(r["tokens"], d["tokens"]))
            # relay, not buffering: each stream's first chunk reached the
            # client before its replica emitted the stream's last token
            events = telemetry.trace_events()
            last_emit = {}
            for e in events:
                if e["name"] == "req.inter_token":
                    t = e["args"].get("trace")
                    last_emit[t] = max(last_emit.get(t, 0), e["ts"] / 1e6)
            early = [r["tid"] for r in routed if len(r["tokens"]) > 1
                     and not r["walls"][0] < last_emit.get(r["tid"], 0)]
            check(not early, f"(c) streams {early[:4]} reached the client "
                             f"only after their last token: buffered")
            check([e.retraces_since_warmup() for e in engines] == [0, 0],
                  "(c) a decode engine retraced")
            check(all(e.pool.live_blocks == 0 for e in engines),
                  "(c) a KV pool was not freed")

            def stats(rs_):
                ttft = [r["times"][0] * 1e3 for r in rs_ if r["times"]]
                gaps = [(b_ - a_) * 1e3 for r in rs_
                        for a_, b_ in zip(r["times"], r["times"][1:])]
                return {"ttft_ms_p50": _pct(ttft, 50),
                        "ttft_ms_max": max(ttft),
                        "intertoken_ms_p50": _pct(gaps, 50),
                        "intertoken_ms_p99": _pct(gaps, 99)}
            out["c"] = {"launches": launches, "decode_steps": steps,
                        "streams_per_replica": by_rep,
                        "compared_tokens": n_cmp,
                        "routed_equal_direct_tokens": same,
                        "routed": stats(routed), "direct": stats(direct),
                        "split_direct": stats(split)}
            s, d = out["c"]["routed"], out["c"]["direct"]
            h = out["c"]["split_direct"]
            print(f"[fleet] (c) {requests} streams through the router "
                  f"({by_rep}), {requests} direct to {r0.name} and "
                  f"{requests} direct, half to each replica: decode "
                  f"steps {steps}, launches {launches}; {min(checked, requests)}"
                  f" routed == reference_decode over {n_cmp} tokens; routed "
                  f"tokens equal to direct: {same} of "
                  f"{sum(len(r['tokens']) for r in direct)}; every first chunk "
                  f"at the client before its last token was emitted")
            print(f"[fleet] (c) TTFT p50 / max ms: routed "
                  f"{s['ttft_ms_p50']:.3f} / {s['ttft_ms_max']:.3f}, direct "
                  f"{d['ttft_ms_p50']:.3f} / {d['ttft_ms_max']:.3f}; "
                  f"inter-token p50 / p99 ms: routed "
                  f"{s['intertoken_ms_p50']:.3f} / {s['intertoken_ms_p99']:.3f}"
                  f", direct {d['intertoken_ms_p50']:.3f} / "
                  f"{d['intertoken_ms_p99']:.3f}; half to each replica "
                  f"without the router: TTFT {h['ttft_ms_p50']:.3f} / "
                  f"{h['ttft_ms_max']:.3f}, inter-token "
                  f"{h['intertoken_ms_p50']:.3f} / "
                  f"{h['intertoken_ms_p99']:.3f} [{label}]")
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = prev

        # ---- (d) the observatory ----
        tid = "fleet-predict-1"
        code, _, hdrs, _ = _fleet_post(url, _npy(x1), npy,
                                       {"X-Dl4j-Trace-Id": tid})
        check(code == 200 and hdrs.get("X-Dl4j-Trace-Id") == tid
              and hdrs.get("X-Dl4j-Replica"),
              f"(d) router echoed {hdrs.get('X-Dl4j-Trace-Id')!r}")
        code, _, hdrs, _ = _fleet_post(
            f"{r1.server.url}/v1/models/resnet50:predict", _npy(x1), npy,
            {"X-Dl4j-Trace-Id": "fleet-direct-1"})
        check(code == 200 and hdrs.get("X-Dl4j-Trace-Id") == "fleet-direct-1",
              f"(d) the replica echoed {hdrs.get('X-Dl4j-Trace-Id')!r}")
        os.makedirs("flightrec", exist_ok=True)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any(
                e["name"] == "request" and e["args"].get("trace") == tid
                for e in telemetry.trace_events()):
            time.sleep(0.02)
        trace = telemetry.export_chrome_trace("flightrec/fleet_trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names_p = _span_tree(events, tid, (
            "request", "req.route", "req.admit", "req.queue",
            "req.batch_wait", "req.device", "req.serialize"))
        names_g = _span_tree(events, tids[1], (
            "request", "req.route", "req.admit", "req.queue", "req.device",
            "req.ttft", "req.inter_token", "req.stream", "req.serialize"))
        slo = {}
        for where, u in (("router", base), ("replica", r0.server.url)):
            with urllib.request.urlopen(f"{u}/api/slo", timeout=60) as resp:
                slo[where] = json.loads(resp.read())
            check({"resnet50", "lm"} <= set(slo[where]["models"]),
                  f"(d) /api/slo on the {where}: "
                  f"{sorted(slo[where]['models'])}")
        # the dump: one record a completed request since the phase began
        # (as many as the ring holds)
        expected = min(reqrec.get().capacity, rec0 + n_served() - served0)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and len(reqrec.get().records()) < expected:
            time.sleep(0.02)
        req = urllib.request.Request(f"{base}/api/reqrec/dump", data=b"")
        with urllib.request.urlopen(req, timeout=60) as resp:
            path = json.loads(resp.read())["path"]
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        recs = lines[1:]
        check(lines[0]["record"] == "meta"
              and lines[0]["n_requests"] == len(recs) == expected,
              f"(d) the dump holds {len(recs)} records "
              f"(meta {lines[0].get('n_requests')}), {expected} requests "
              f"completed")
        mine = [r for r in recs if r["trace_id"] in set(tids) | {tid}]
        check(len(mine) == len(tids) + 1
              and all(r["verdict"] == "200" for r in mine),
              f"(d) {len(mine)} records of this phase's traced requests")
        check(os.path.exists(path.replace(".jsonl", ".trace.json")),
              "(d) the dump has no chrome trace beside it")
        # the access log at 0.5; the health poller paused for the window
        logp = os.path.abspath("flightrec/fleet_access.jsonl")
        if os.path.exists(logp):
            os.remove(logp)
        prev_env = {k: os.environ.get(k) for k in (
            "DL4J_TORCH_ACCESS_LOG", "DL4J_TORCH_ACCESS_LOG_SAMPLE")}
        router.health_interval_s = 3600.0
        router._health_wake.set()
        time.sleep(0.5)
        os.environ["DL4J_TORCH_ACCESS_LOG"] = logp
        os.environ["DL4J_TORCH_ACCESS_LOG_SAMPLE"] = "0.5"
        httputil._reset_access_conf()
        logged = [f"fleet-log-{i}" for i in range(FLEET_LOGGED)]

        def log_lines():
            if not os.path.exists(logp):
                return []
            with open(logp) as f:
                return [json.loads(ln) for ln in f]
        try:
            for t in logged:
                code, _, _, _ = _fleet_post(url, _npy(x1), npy,
                                            {"X-Dl4j-Trace-Id": t})
                check(code == 200, f"(d) logged request {t}: {code}")
            # a handler writes its line after the client has its answer
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline \
                    and len(log_lines()) < FLEET_LOGGED:
                time.sleep(0.02)
        finally:
            for k, v in prev_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            httputil._reset_access_conf()
            router.health_interval_s = 1.0
            router._health_wake.set()
        time.sleep(0.2)
        kept = log_lines()
        # each request is handled twice (router, replica): 2 x 8 at 0.5
        check(len(kept) == FLEET_LOGGED
              and all(ln["trace_id"] in logged for ln in kept),
              f"(d) access log kept {len(kept)} lines of "
              f"{2 * FLEET_LOGGED}: {[ln['trace_id'] for ln in kept]}")
        out["d"] = {"predict_spans": names_p, "generate_spans": names_g,
                    "slo_models": sorted(slo["router"]["models"]),
                    "dump_records": len(recs),
                    "access_log_lines": len(kept)}
        print(f"[fleet] (d) trace ids echoed by the router and a replica; "
              f"one tree a trace id: predict {names_p}, generate {names_g}; "
              f"/api/slo (router and replica) reports "
              f"{out['d']['slo_models']} (fast burn rate resnet50 "
              f"{slo['router']['models']['resnet50']['windows']['fast']['burn_rate']:.3f}"
              f", lm {slo['router']['models']['lm']['windows']['fast']['burn_rate']:.3f}"
              f"); dump {path}: {len(recs)} records, one a completed "
              f"request; access log at 0.5: {len(kept)} lines of "
              f"{2 * FLEET_LOGGED} handled requests, each with its trace id")

        # ---- (e) failover: the replica a lone client reaches stops ----
        stop, answers = threading.Event(), []

        def failover_client():
            while not stop.is_set():
                answers.append(_fleet_post(url, _npy(xb), npy))

        th = threading.Thread(target=failover_client)
        th.start()
        try:
            while len(answers) < 5 and th.is_alive():
                time.sleep(0.01)
            r0.server.stop(drain=False)
            n_at_stop = len(answers)
            while len(answers) < n_at_stop + 10 and th.is_alive():
                time.sleep(0.01)
        finally:
            stop.set()
            th.join(timeout=300)
        with urllib.request.urlopen(f"{base}/v1/replicas", timeout=60) as resp:
            reps = {r["name"]: r for r in json.loads(resp.read())["replicas"]}
        check(all(a[0] == 200 and np.array_equal(
            _fleet_answer(a[1], npy), ref2) for a in answers),
            f"(e) a request failed or changed across the failover: "
            f"{sorted({a[0] for a in answers})}")
        check(not reps[r0.name]["healthy"] and reps[r1.name]["healthy"],
              f"(e) /v1/replicas after the stop: {reps}")
        served_by = telemetry.counter("dl4j_serving_router_requests_total")
        out["e"] = {"answers": len(answers), "after_stop":
                    len(answers) - n_at_stop}
        print(f"[fleet] (e) {r0.name} stopped after {n_at_stop} of "
              f"{len(answers)} requests: every one 200 and bitwise version "
              f"2's ({r1.name} has answered "
              f"{served_by.value(replica=r1.name, code='200'):g} in the "
              f"phase); /v1/replicas shows {r0.name} out of rotation")
    finally:
        router.stop(drain=False, timeout=30)

    # ---- (f) a SameDiff graph through the registry ----
    if sd is not None:
        out["f"] = _fleet_samediff(torch, sd, sd_image or image, device)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[fleet] phase 23 in {out['phase_s']:.1f}s [{label}]")
    return out


def _fleet_samediff(torch, sd, image: int, device: str) -> dict:
    """(f): the imported graph served at 1 and 32 images, against
    ``sd.output`` of the same padded batch, TF32 off and the deterministic
    algorithms on; no kernel of ``csrc/`` launches."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import (InferenceServer,
                                                  ModelRegistry)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    reg = ModelRegistry(device, default_buckets=(8, 32))
    srv = None
    try:
        _zero_counts()
        ver = reg.register("keras_resnet50", sd, input_name="x",
                           warmup_shape=(image, image, 3))
        check(ver.model.output_name == "Identity",
              f"(f) inferred output {ver.model.output_name!r}")
        srv = InferenceServer(reg).start(0)
        url = f"{srv.url}/v1/models/keras_resnet50:predict"
        rs = np.random.RandomState(29)
        x32 = rs.randn(32, image, image, 3).astype(np.float32)
        got = {}
        for n in (1, 32):
            code, data, _, ms = _fleet_post(url, _npy(x32[:n]),
                                            "application/octet-stream")
            check(code == 200, f"(f) {n} images: {code}")
            got[n] = (np.load(io.BytesIO(data)), ms)
        _sync(torch, device)
        launches = _counts()

        def direct(a):
            return sd.output({"x": a}, ["Identity"])["Identity"] \
                .float().cpu().numpy()
        for n in (1, 32):
            ref = _padded_ref(direct, x32[:n], 8 if n == 1 else 32)
            err = float(np.abs(got[n][0] - ref).max())
            check(np.array_equal(got[n][0], ref),
                  f"(f) {n} served images differ from sd.output by {err}")
        check(not any(launches.values()),
              f"(f) a kernel of csrc/ launched: {launches}")
        check(ver.retraces_since_warmup() == 0, "(f) retraced")
        print(f"[fleet] (f) the imported Keras ResNet-50 through "
              f"ModelRegistry.register(input_name='x'): 1 image "
              f"({got[1][1]:.1f} ms) and 32 ({got[32][1]:.1f} ms) over HTTP "
              f"== sd.output of the same padded batch bit for bit "
              f"(deterministic algorithms, TF32 off); launches {launches}")
        return {"ms_1": got[1][1], "ms_32": got[32][1], "launches": launches}
    finally:
        if srv is not None:
            srv.stop(drain=False)
        reg.shutdown()
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.use_deterministic_algorithms(prev[2])
        if prev[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[3]


# ---------------------------------------------------------------------------
#: phase 24: the rest of SameDiff on the imported BERT-base (SD_BERT): two
#: gloo ranks and a one-rank NCCL group, the exported program, and an
#: attention SameDiffLayer inside a ComputationGraph
SD_DP_WORLD = 2
SD_DP_STEPS = 3
SD_DP_EXCHANGES = ("dense", "fsdp", "encoded")
SD_DP_WORK = ROOT / "build" / "sd_dp"
#: an exported program's output against SameDiff.output on the same
#: inputs (bitwise expected: the same kernels on the same operands)
SD_EXPORT_RTOL, SD_EXPORT_ATOL = 2e-5, 1e-6
SD_LAYER_STEPS = 10
SD_DROPOUT_SEEDS = (5, 6)


def sd_dp_batch(torch, batch: int, t: int, vocab: int, n_pred: int,
                device: str) -> dict:
    """``sd_bert_batch``'s MLM batch with ignored labels (-1) that differ
    by shard: the first half of the rows keeps a quarter of its
    predictions, the second half all of them, so the mean of the
    shards' loss ratios is not the global ratio."""
    b = sd_bert_batch(torch, torch.Generator().manual_seed(61), batch, t,
                      vocab, "cpu", n_pred)
    labels = b["mlm_labels"].clone()
    labels[:batch // 2, max(1, n_pred // 4):] = -1
    b["mlm_labels"] = labels
    return {k: v.to(device) for k, v in b.items()}


def _sd_import(nodes, batch: int, t: int, n_pred: int, dims: dict,
               device: str, dtype=None):
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import \
        import_and_attach_mlm
    return import_and_attach_mlm(
        nodes, batch, t, vocab=dims["vocab"], hidden=dims["hidden"],
        updater=Adam(5e-4), dtype=dtype, max_predictions=n_pred,
        device=device)[0]


def _sd_var_names(sd) -> list:
    return [n for n, v in sd.vars.items() if v.var_type.value == "VARIABLE"]


def _sd_digest(torch, sd, names) -> str:
    """A digest of the variables' bits, in name order: each variable's
    32-bit words summed plain and weighted by position, on the device."""
    import hashlib
    h = hashlib.sha256()
    for n in sorted(names):
        t = sd._arrays[n].detach().contiguous().reshape(-1)
        w = t.view(torch.int32).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        h.update(f"{n}:{int(w.sum())}:{int((w * pos).sum())};".encode())
    return h.hexdigest()


def _sd_reset(sd, p0: dict, device: str) -> None:
    """The graph back at its imported weights, with no updater state,
    iteration 0 and its first random key: a fresh import's state."""
    from deeplearning4j_tpu_torch.common.rng import RngKey
    for n, t in p0.items():
        sd._arrays[n] = t.to(device, copy=True)
    sd._updater_state = None
    sd.iteration_count = 0
    sd._rng = RngKey(0)


def _sd_rank_bytes(sd, names, mode: str, world: int, sparsity=None
                   ) -> dict:
    """A rank's resident parameter and updater-state bytes under the
    exchange (Adam: two moments; the encoded residual beside them), and
    its wire bytes a step (``zero.exchange_report``, the ring model)."""
    from deeplearning4j_tpu_torch.parallel import zero
    params = {n: sd._arrays[n] for n in names}
    p = sum(t.numel() * t.element_size() for t in params.values())
    flat = mode != "dense"
    rep = zero.exchange_report(params, world, mode,
                               encoding="threshold" if mode == "encoded"
                               else None, observed_sparsity=sparsity)
    return {"param_bytes": p // world if mode == "fsdp" else p,
            "state_bytes": (2 * p) // (world if flat else 1)
            + (p // world if mode == "encoded" else 0),
            "wire_bytes_per_step": rep["wire_bytes_per_replica"]}


def sd_dp_rank_main(work: str, rank: int, world: int, backend: str,
                    dims_json: str, batch: int, t: int,
                    device: str = "cuda") -> None:
    """One rank of phase 24 (a), its own process: the imported BERT
    takes SD_DP_STEPS ``fit_steps(mesh=)`` steps on the global batch
    under each of SD_DP_EXCHANGES, from the same weights each time; the
    launches, losses, step times, digests of the variables after each
    step and bytes go to ``work``, and rank 0's variables after step 1
    of the dense and fsdp runs too."""
    import torch
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
        parse_graphdef
    from deeplearning4j_tpu_torch.parallel.mesh import ProcessGroupMesh
    dims = json.loads(dims_json)
    nodes = parse_graphdef(Path(work, "bert.pb").read_bytes())
    b = {k: v.to(device) for k, v in
         torch.load(Path(work, "batch.pt")).items()}
    n_pred = int(b["mlm_labels"].shape[1])
    mesh = ProcessGroupMesh(f"file://{work}/store", world, rank,
                            device=device, backend=backend, timeout_s=300)
    out = {"backend": mesh.backend}
    sd = _sd_import(nodes, batch, t, n_pred, dims, device)
    names = _sd_var_names(sd)
    p0 = {n: sd._arrays[n].clone() for n in names}
    try:
        for ex in SD_DP_EXCHANGES:
            _sd_reset(sd, p0, device)
            r = {"losses": [], "step_ms": [], "digests": []}
            _zero_counts()
            for s in range(SD_DP_STEPS):
                _sync(torch, device)
                t0 = time.perf_counter()
                r["losses"].append(sd.fit_steps(
                    b, 1, mesh=mesh, update_exchange=ex,
                    encoding="threshold" if ex == "encoded" else None))
                _sync(torch, device)
                r["step_ms"].append((time.perf_counter() - t0) * 1e3)
                if s == 0:
                    r["launches_step1"] = _flash_counts()
                r["digests"].append(_sd_digest(torch, sd, names))
                if s == 0 and rank == 0 and ex != "encoded":
                    torch.save({n: sd._arrays[n].cpu() for n in names},
                               Path(work, f"step1_{ex}.pt"))
            r["launches"] = _flash_counts()
            sparsity = None
            from deeplearning4j_tpu_torch.learning.updaters import \
                ENCODED_KEY
            enc = (sd._updater_state or {}).get(ENCODED_KEY)
            if enc is not None:
                sparsity = float(enc["sparsity"])
                r["tau"] = float(enc["tau"])
            r["sparsity"] = sparsity
            r["bytes"] = _sd_rank_bytes(sd, names, ex, world, sparsity)
            out[ex] = r
        if world > 1:
            out["phase25"] = phase25_rank(torch, mesh, sd, b, p0, names,
                                          device)
    finally:
        mesh.shutdown()
    torch.save(out, Path(work, f"rank{rank}.pt"))


def _run_sd_ranks(world: int, backend: str, dims: dict, batch: int, t: int,
                  device: str) -> list:
    """The ranks of phase 24 (a), each its own process, waited for with
    a limit."""
    import torch
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.sd_dp_rank_main("
         f"{str(SD_DP_WORK)!r}, {r}, {world}, {backend!r}, "
         f"{json.dumps(dims)!r}, {batch}, {t}, {device!r})"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of the {backend} group exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return [torch.load(SD_DP_WORK / f"rank{r}.pt") for r in range(world)]


def _sd_update_err(torch, got: dict, ref: dict, p0: dict) -> tuple:
    """The worst variable's distance from ``ref`` in norm over the norm
    of ``ref``'s update from ``p0`` (floored at BERT_UPDATE_FLOOR of the
    largest update: the key bias's gradient is exactly zero), and its
    name."""
    floor = BERT_UPDATE_FLOOR * max(
        float((ref[n].double() - p0[n].double()).norm()) for n in p0)
    errs = {n: float((got[n].double() - ref[n].double()).norm()
                     / (ref[n].double() - p0[n].double()).norm()
                     .clamp_min(floor)) for n in p0}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def sd_attention_layer_conf(vocab: int, hidden: int, heads: int, t: int,
                            updater, classes: int = 8,
                            dtype: str = "float32"):
    """Token embedding -> an attention SameDiffLayer (its graph
    ``sd.nn.multi_head_dot_product_attention`` with the features mask as
    the key mask) -> a mean-pooling SameDiffOutputLayer with a softmax
    head, built with GraphBuilder."""
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import \
        EmbeddingSequenceLayer
    return (NeuralNetConfiguration.Builder().seed(24).updater(updater)
            .data_type(dtype).graph_builder()
            .add_inputs("tokens").set_input_types(InputType.recurrent(1, t))
            .add_layer("emb", EmbeddingSequenceLayer(n_in=vocab,
                                                     n_out=hidden),
                       "tokens")
            .add_layer("att", SDSelfAttention(heads=heads), "emb")
            .add_layer("out", SDPooledHead(n_out=classes), "att")
            .set_outputs("out").build())


def _sd_layer_classes():
    """The phase's SameDiff layer classes, registered for the zip round
    trip (defined once, at first use)."""
    global SDSelfAttention, SDPooledHead
    if "SDSelfAttention" in globals():
        return
    from dataclasses import dataclass

    from deeplearning4j_tpu_torch.activations import Activation
    from deeplearning4j_tpu_torch.lossfunctions import LossFunction
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import register_layer
    from deeplearning4j_tpu_torch.nn.conf.layers_samediff import (
        SameDiffLayer, SameDiffOutputLayer)

    @register_layer
    @dataclass
    class SDSelfAttention(SameDiffLayer):
        """Projected self-attention over ``[b, t, n_in]``, the features
        mask as the key mask."""

        heads: int = 12

        def define_parameters(self):
            return {k: (self.n_in, self.n_in)
                    for k in ("Wq", "Wk", "Wv", "Wo")}

        def define_layer(self, sd, layer_input, params, mask):
            return sd.nn.multi_head_dot_product_attention(
                layer_input, params["Wq"], params["Wk"], params["Wv"],
                params["Wo"], self.heads, mask)

        def set_n_in(self, input_type, override):
            if override or not self.n_in:
                self.n_in = self.n_out = input_type.size

        def get_output_type(self, input_type):
            return InputType.recurrent(self.n_out, input_type.timesteps)

    @register_layer
    @dataclass
    class SDPooledHead(SameDiffOutputLayer):
        """The mean over time, then a dense softmax head."""

        loss_function: LossFunction = LossFunction.MCXENT
        activation: Activation = Activation.SOFTMAX

        def define_parameters(self):
            return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

        def define_layer(self, sd, layer_input, params):
            pooled = sd.math.reduce_mean(layer_input, axis=1)
            return pooled.mmul(params["W"]) + params["b"]

        def set_n_in(self, input_type, override):
            if override or not self.n_in:
                self.n_in = input_type.size

    globals().update(SDSelfAttention=SDSelfAttention,
                     SDPooledHead=SDPooledHead)


def sd_layer_batch(torch, g, batch: int, t: int, vocab: int,
                   classes: int = 8):
    ids, mask, _ = attention_batch(torch, g, batch, t, vocab)
    labels = torch.nn.functional.one_hot(
        torch.randint(0, classes, (batch,), generator=g), classes).float()
    return ids, mask, labels


def sd_layer_card_vs_cpu(torch, device: str = "cuda", batch: int = 2
                         ) -> dict:
    """One Sgd(0.1) step of phase 24 (c)'s network at full width on the
    card and on the CPU (the flash gate forced: the kernels' plain
    versions), against a float64 CPU step, TF32 off: the bars of
    ``sd_bert_card_vs_cpu`` (loss LOSS_RTOL; each variable's update
    within UPDATE_FACTOR x the CPU float32 step's distance from float64
    + UPDATE_FLOOR, floored at BERT_UPDATE_FLOOR of the largest
    update)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    _sd_layer_classes()
    V, Hd, heads, t = (ATTN[k] for k in ("vocab", "hidden", "heads", "t"))
    conf = sd_attention_layer_conf(V, Hd, heads, t, Sgd(0.1))
    cpu = ComputationGraph(conf).init(
        "cpu", generator=torch.Generator().manual_seed(25))
    p0 = _clone_params(cpu.params, "cpu")
    card = ComputationGraph(conf).set_params(_clone_params(p0, device), {},
                                             device)
    cpu64 = ComputationGraph(sd_attention_layer_conf(
        V, Hd, heads, t, Sgd(0.1), dtype="float64")).set_params(
        {k: {n: v.double() for n, v in sub.items()} for k, sub in
         p0.items()}, {}, "cpu")
    ids, mask, labels = sd_layer_batch(
        torch, torch.Generator().manual_seed(26), batch, t, V)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card.fit(DataSet(ids.to(device), labels.to(device),
                         features_mask=mask.to(device)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    _with_flash_gate("1", lambda: cpu.fit(DataSet(ids, labels,
                                                  features_mask=mask)))
    cpu64.fit(DataSet(ids, labels, features_mask=mask))
    check(abs(card.score() - cpu.score()) <= LOSS_RTOL * abs(cpu.score()),
          f"SameDiff layer loss card {card.score()} vs cpu {cpu.score()}")
    floor = BERT_UPDATE_FLOOR * max(
        float((cpu64.params[k][n] - t0.double()).norm())
        for k, sub in p0.items() for n, t0 in sub.items())

    def dist(a, b_):
        return float((a - b_).norm() / b_.norm().clamp_min(floor))

    e_card = e_cpu = e_pair = 0.0
    worst = ""
    for k, sub in p0.items():
        for n, t0 in sub.items():
            d64 = cpu64.params[k][n] - t0.double()
            dcard = card.params[k][n].detach().cpu().double() - t0.double()
            dcpu = cpu.params[k][n].double() - t0.double()
            ec, eu = dist(dcard, d64), dist(dcpu, d64)
            check(ec <= UPDATE_FACTOR * eu + UPDATE_FLOOR,
                  f"SameDiff layer card update of {k}/{n} {ec:.3e} from "
                  f"the float64 step, the CPU float32 step's {eu:.3e}")
            if ec > e_card:
                e_card, worst = ec, f"{k}/{n}"
            e_cpu = max(e_cpu, eu)
            e_pair = max(e_pair, dist(dcard, dcpu))
    print(f"[sd-rest] (c) card vs CPU, one f32 Sgd step, batch {batch} x "
          f"{t} (TF32 off; CPU on the card's route): loss "
          f"{card.score():.7f} vs {cpu.score():.7f} (f64 "
          f"{cpu64.score():.7f}); worst update in norm: card vs f64 "
          f"{e_card:.3e} ({worst}), CPU f32 vs f64 {e_cpu:.3e}, card vs "
          f"CPU f32 {e_pair:.3e}")
    return {"loss_card": card.score(), "loss_cpu": cpu.score(),
            "update_card_vs_f64": e_card, "update_cpu32_vs_f64": e_cpu,
            "update_card_vs_cpu32": e_pair, "worst": worst}


def phase_sd_rest(torch, label: str, device: str = "cuda", dims=None,
                  batch: int = BATCH, t: int = 128,
                  layer_dims=None) -> dict:
    """Phase 24: the rest of SameDiff on BASELINE #4's imported BERT-base
    (``SD_BERT``, batch 32, t=128, weights from the seed), Adam(5e-4):

    (a) ``fit_steps(mesh=)`` on two gloo ranks (16 rows each, one process
    each) under the dense, fsdp and encoded (threshold) exchanges,
    SD_DP_STEPS steps each, on a batch whose ignored labels differ by
    shard; then a one-rank NCCL group in this process. Held: 12 launches
    of kernels 7-9 a step on each rank; the ranks bitwise equal; step 1's
    loss within LOSS_RTOL of the one-process step (the global loss); the
    dense and fsdp step-1 updates within UPDATE_FACTOR x the one-process
    step's distance from a float64 step (+ UPDATE_FLOOR); the NCCL rank
    bitwise the one-process ``fit_steps``.
    (b) the forward exported: ``to_stablehlo``'s program calls the
    ``dl4j::flash_fwd`` op once a layer and holds no softmax;
    ``deserialize_and_call`` on the card launches kernel 7 once a layer
    and equals ``output`` (bitwise expected; SD_EXPORT_RTOL the bar); a
    dropout program called with seed s equals the walk with ``RngKey(s)``
    and another seed draws another mask.
    (c) an attention SameDiffLayer inside a ComputationGraph trained
    SD_LAYER_STEPS steps: one launch of kernels 7-9 a step, the loss
    falls, one step within ``sd_layer_card_vs_cpu``'s bars, and the zip
    round trip gives bitwise-equal outputs.

    ``device="cpu"`` with small ``dims`` and ``layer_dims`` rehearses it
    (gloo in place of NCCL; counts, timings and bytes are the card's)."""
    t_phase = time.perf_counter()
    # the one-process reference and the one-rank group are held bit for
    # bit: the embedding's gradient (an index_put with accumulation) is
    # summed by atomics unless the deterministic algorithms are on
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _sd_rest(torch, label, device, dims, batch, t, layer_dims,
                        t_phase)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _sd_rest(torch, label, device, dims, batch, t, layer_dims, t_phase):
    import shutil

    import numpy as np

    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.common.rng import RngKey
    from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import \
        build_frozen_bert
    from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import \
        parse_graphdef
    from deeplearning4j_tpu_torch.parallel.mesh import ProcessGroupMesh
    dims = dict(dims or SD_BERT)
    L, V = dims["layers"], dims["vocab"]
    n_pred = min(SD_PREDICTIONS, t // 2)
    on_card = device == "cuda"
    res: dict = {}
    gd = build_frozen_bert(t, batch, seed=0, **dims)
    nodes = parse_graphdef(gd)
    b = sd_dp_batch(torch, batch, t, V, n_pred, device)
    valid = (b["mlm_labels"] >= 0).reshape(SD_DP_WORLD, -1).sum(1)
    check(len(set(valid.tolist())) > 1,
          f"the shards keep {valid.tolist()} labels: not uneven")
    shutil.rmtree(SD_DP_WORK, ignore_errors=True)
    SD_DP_WORK.mkdir(parents=True)
    (SD_DP_WORK / "bert.pb").write_bytes(gd)
    torch.save({k: v.cpu() for k, v in b.items()}, SD_DP_WORK / "batch.pt")
    del gd

    # ---- the one-process reference: 3 steps, and a float64 step 1 ----
    sd = _sd_import(nodes, batch, t, n_pred, dims, device)
    names = _sd_var_names(sd)
    p0 = {n: sd._arrays[n].cpu().clone() for n in names}
    one_losses, one_ms = [], []
    for s in range(SD_DP_STEPS):
        _sync(torch, device)
        t0 = time.perf_counter()
        one_losses.append(sd.fit_steps(b, 1))
        _sync(torch, device)
        one_ms.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            one_step1 = {n: sd._arrays[n].cpu().clone() for n in names}
    one_final = {n: sd._arrays[n].clone() for n in names}
    sd64 = _sd_import(nodes, batch, t, n_pred, dims, device, "float64")
    loss64 = sd64.fit_steps(b, 1)
    p64 = {n: sd64._arrays[n].cpu() for n in names}
    del sd64
    if on_card:
        torch.cuda.empty_cache()
    e_ref, ref_worst = _sd_update_err(torch, one_step1, p64, p0)
    print(f"[sd-rest] one process: losses "
          f"{[round(v, 6) for v in one_losses]}, step ms "
          f"{[round(m, 1) for m in one_ms]}; float64 step-1 loss "
          f"{loss64:.7f}; f32 step 1 {e_ref:.3e} from float64 "
          f"({ref_worst}) [{label}]")

    # ---- (a) two gloo ranks, then a one-rank NCCL group ----
    t0 = time.perf_counter()
    ranks = _run_sd_ranks(SD_DP_WORLD, "gloo", dims, batch, t, device)
    res["gloo_wall_s"] = time.perf_counter() - t0
    dp = {}
    for ex in SD_DP_EXCHANGES:
        rr = [r[ex] for r in ranks]
        for i, r in enumerate(rr):
            for k in FLASH_KERNELS:
                check(r["launches"][k] == L * SD_DP_STEPS * on_card
                      and r["launches_step1"][k] == L * on_card,
                      f"(a) {ex} rank {i} {k}: {r['launches'][k]} launches "
                      f"in {SD_DP_STEPS} steps, expected {L} a step")
        check(rr[0]["digests"] == rr[1]["digests"]
              and rr[0]["losses"] == rr[1]["losses"],
              f"(a) {ex}: the ranks' variables or losses differ")
        e_loss = abs(rr[0]["losses"][0] - one_losses[0]) / abs(one_losses[0])
        check(e_loss <= LOSS_RTOL, f"(a) {ex}: step-1 loss "
              f"{rr[0]['losses'][0]} vs one process {one_losses[0]}")
        d = {"losses": rr[0]["losses"], "loss_rel": e_loss,
             "step_ms": [r["step_ms"] for r in rr],
             "median_step_ms": float(np.median(
                 [m for r in rr for m in r["step_ms"][1:]])),
             "launches": [r["launches"] for r in rr],
             "bytes": rr[0]["bytes"], "sparsity": rr[0]["sparsity"],
             "tau": rr[0].get("tau")}
        if ex != "encoded":
            step1 = torch.load(SD_DP_WORK / f"step1_{ex}.pt")
            e_dp, worst = _sd_update_err(torch, step1, p64, p0)
            e_pair, _ = _sd_update_err(torch, step1, one_step1, p0)
            check(e_dp <= UPDATE_FACTOR * e_ref + UPDATE_FLOOR,
                  f"(a) {ex}: step-1 update {e_dp:.3e} from float64 "
                  f"({worst}), the one-process step's {e_ref:.3e}")
            d.update(update_vs_f64=e_dp, update_vs_one_process=e_pair)
            del step1
        dp[ex] = d
        print(f"[sd-rest] (a) {ex}, 2 gloo ranks x 16 rows: losses "
              f"{[round(v, 6) for v in d['losses']]} (step 1 "
              f"{e_loss:.2e} from one process); step ms "
              f"{[[round(m, 1) for m in s] for s in d['step_ms']]}; "
              f"update vs f64 {d.get('update_vs_f64', float('nan')):.3e} "
              f"(one process {e_ref:.3e}), vs one process "
              f"{d.get('update_vs_one_process', float('nan')):.3e}; bytes a "
              f"rank {d['bytes']}; sparsity {d['sparsity']}; ranks bitwise "
              f"equal; launches a rank {d['launches'][0]} [{label}]")
    res["gloo"] = dp
    # phase 25 (d) and (e) ran in these ranks (phase_observatory reads them)
    res["phase25"] = [r["phase25"] for r in ranks]
    # a one-rank NCCL group in this process (gloo on the CPU)
    backend = "nccl" if on_card else "gloo"
    mesh = ProcessGroupMesh(f"file://{SD_DP_WORK}/nccl", 1, 0,
                            device=device, backend=backend, timeout_s=300)
    try:
        _sd_reset(sd, p0, device)
        _zero_counts()
        n_ms, n_losses = [], []
        for _ in range(SD_DP_STEPS):
            _sync(torch, device)
            t0 = time.perf_counter()
            n_losses.append(sd.fit_steps(b, 1, mesh=mesh,
                                         update_exchange="dense"))
            _sync(torch, device)
            n_ms.append((time.perf_counter() - t0) * 1e3)
        n_launches = _flash_counts()
    finally:
        mesh.shutdown()
    for k in FLASH_KERNELS:
        check(n_launches[k] == L * SD_DP_STEPS * on_card,
              f"(a) one-rank {backend} {k}: {n_launches[k]} launches")
    check(n_losses == one_losses and all(
        torch.equal(sd._arrays[n], one_final[n]) for n in names),
        f"(a) one-rank {backend} group is not bitwise the one-process "
        f"fit_steps: losses {n_losses} vs {one_losses}")
    res["nccl"] = {"backend": backend, "step_ms": n_ms,
                   "median_step_ms": float(np.median(n_ms[1:])),
                   "launches": n_launches}
    print(f"[sd-rest] (a) one-rank {backend} group: step ms "
          f"{[round(m, 1) for m in n_ms]} (one process "
          f"{[round(m, 1) for m in one_ms]}); bitwise the one-process "
          f"fit_steps; launches {n_launches} [{label}]")
    del one_final
    shutil.rmtree(SD_DP_WORK, ignore_errors=True)

    # ---- (b) the forward exported and called back ----
    enc = _encoder_feeds(b)
    t0 = time.perf_counter()
    txt = sd.to_stablehlo(enc, ["Identity"])
    res["to_stablehlo_s"] = time.perf_counter() - t0
    n_ops = txt.count("torch.ops.dl4j.flash_fwd.default")
    want_ops = L if on_card else 0
    check(n_ops == want_ops and (not on_card or "softmax" not in txt),
          f"(b) the program calls dl4j::flash_fwd {n_ops} times (expected "
          f"{want_ops}), softmax {'softmax' in txt}")
    t0 = time.perf_counter()
    blob = sd.export_serialized(enc, ["Identity"])
    res["export_s"] = time.perf_counter() - t0
    res["blob_bytes"] = len(blob)
    _zero_counts()
    t0 = time.perf_counter()
    got = SameDiff.deserialize_and_call(blob, enc)[0]
    _sync(torch, device)
    res["load_and_call_s"] = time.perf_counter() - t0
    x_launches = _flash_counts()
    check(x_launches == {"flash_fwd": L * on_card, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0},
          f"(b) one call launched {x_launches}")
    want = sd.output(enc, ["Identity"])["Identity"]
    res["export_bitwise"] = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=SD_EXPORT_RTOL,
                              atol=SD_EXPORT_ATOL)),
          f"(b) the loaded program vs output: max |d| {err:.3e}")
    res["export_launches"] = x_launches
    if on_card:
        program = torch.export.load(io.BytesIO(blob)).module()
        key = torch.tensor(0, dtype=torch.int64)
        ph = {k: enc[k] for k in ("ids", "seg", "mask")}
        with torch.no_grad():
            res["call_ms"] = _time_ms(torch, lambda: program(ph, key),
                                      reps=5)
        res["output_ms"] = _time_ms(
            torch, lambda: sd.output(enc, ["Identity"]), reps=5)
        del program
    del blob
    print(f"[sd-rest] (b) to_stablehlo {res['to_stablehlo_s']:.2f}s "
          f"({n_ops} dl4j::flash_fwd calls, no softmax); export "
          f"{res['export_s']:.2f}s, {res['blob_bytes']} bytes; load + call "
          f"{res['load_and_call_s']:.2f}s, launches {x_launches}; vs output"
          f" max |d| {err:.3e} (bitwise {res['export_bitwise']}); call "
          f"{res.get('call_ms', float('nan')):.3f} ms vs output "
          f"{res.get('output_ms', float('nan')):.3f} ms [{label}]")
    # a dropout program over the embeddings' sum (the encoder's first
    # activations): a few ops of the same graph, so its export is quick
    check("add_1" in sd.vars and tuple(sd.vars["add_1"].shape or ()) in (
        (), (batch, t, dims["hidden"])), "(b) no embeddings' sum 'add_1'")
    drop = sd._op("dropout", [sd.vars["add_1"]], {"rate": 0.1},
                  name="export_dropout")
    blob = sd.export_serialized(enc, [drop.name], training=True)
    plan = sd._plan((drop.name,), tuple(enc))
    var = {n: sd._arrays[n] for n in plan.variables}
    masks = []
    for s in SD_DROPOUT_SEEDS:
        got = SameDiff.deserialize_and_call(blob, enc, seed=s)[0]
        with torch.no_grad():
            want = sd._run(plan, var, sd._placeholders(enc), [drop.name],
                           training=True, rng=RngKey(s))[0]
        check(bool(torch.allclose(got, want, rtol=SD_EXPORT_RTOL,
                                  atol=SD_EXPORT_ATOL))
              and torch.equal(got == 0, want == 0),
              f"(b) dropout program at seed {s} vs the walk's RngKey({s})")
        masks.append(got == 0)
    check(not torch.equal(masks[0], masks[1]),
          "(b) two seeds drew the same dropout mask")
    res["dropout_bitwise"] = True
    print(f"[sd-rest] (b) dropout 0.1 over the embeddings' sum, exported "
          f"({len(blob)} bytes), called at seeds {SD_DROPOUT_SEEDS}: each "
          f"the walk's RngKey(s) masks, the two masks differ")
    del blob, sd, masks, got, want
    if on_card:
        torch.cuda.empty_cache()

    # ---- (c) an attention SameDiffLayer inside a ComputationGraph ----
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer
    _sd_layer_classes()
    ld = dict(layer_dims or ATTN)
    conf = sd_attention_layer_conf(ld["vocab"], ld["hidden"], ld["heads"],
                                   ld["t"], Adam(1e-4))
    net = ComputationGraph(conf).init(
        device, generator=torch.Generator().manual_seed(24))
    ids, mask, labels = sd_layer_batch(
        torch, torch.Generator().manual_seed(27), batch, ld["t"],
        ld["vocab"])
    ds = DataSet(ids.to(device), labels.to(device),
                 features_mask=mask.to(device))
    _zero_counts()
    losses, ms = [], []
    for _ in range(SD_LAYER_STEPS):
        _sync(torch, device)
        t0 = time.perf_counter()
        net.fit(ds)
        _sync(torch, device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score())
    l_launches = _flash_counts()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(c) the SameDiff layer network's loss did not fall: {losses}")
    for k in FLASH_KERNELS:
        check(l_launches[k] == SD_LAYER_STEPS * on_card,
              f"(c) {k}: {l_launches[k]} launches in {SD_LAYER_STEPS} "
              f"steps, expected 1 a step (one site)")
    zdir = ROOT / "build" / "sd_layers"
    zdir.mkdir(parents=True, exist_ok=True)
    path = zdir / "sd_layers.zip"
    ModelSerializer.write_model(net, str(path))
    back = ModelSerializer.restore_model(path, device)
    a = net.output(ids.to(device), mask=mask.to(device))
    z = back.output(ids.to(device), mask=mask.to(device))
    check(torch.equal(a, z), "(c) the restored SameDiff layer network's "
                             "output is not bitwise equal")
    path.unlink()
    step_ms = float(np.median(ms[1:]))
    res["layer"] = {"losses": losses, "step_ms": ms,
                    "median_step_ms": step_ms,
                    "seq_per_s": batch * 1e3 / step_ms,
                    "launches": l_launches}
    print(f"[sd-rest] (c) SameDiffLayer attention (H={ld['hidden']}, "
          f"{ld['heads']} heads) in a ComputationGraph, batch {batch} x "
          f"{ld['t']}: losses {[round(v, 5) for v in losses]}; step "
          f"{step_ms:.3f} ms (median of steps 2-{SD_LAYER_STEPS}) = "
          f"{res['layer']['seq_per_s']:.1f} sequences/s; launches "
          f"{l_launches}; zip round trip bitwise [{label}]")
    del net, back, a, z
    if on_card:
        res["layer"]["card_vs_cpu"] = sd_layer_card_vs_cpu(torch, device)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[sd-rest] phase 24 in {res['phase_s']:.1f}s (gloo ranks "
          f"{res['gloo_wall_s']:.1f}s) [{label}]")
    return res


#: phase 25: the training observatory on the card's training path, and
#: the repaired data-parallel SameDiff walk (fault C5) with remat under a
#: mesh (the two-rank parts run in phase 24's gloo rank processes)
OBS_STEPS = 10
OBS_CAPTURE_STEPS = 3
OBS_WORK = ROOT / "build" / "observatory"
#: the C5 table: ops along the batch axis (rows of an x of C5_SHAPE)
C5_SHAPE = (256, 1024)
C5_GATHERED = ("softmax", "log_softmax", "cumsum", "standardize", "concat",
               "reverse", "argmax", "clip_by_norm", "cosine_distance")
C5_COMBINED = ("reduce_max", "reduce_min")
#: the all-reduced max / min against the one-device answer
C5_EXTREME_ATOL = 1e-6
C5_FIT_STEPS = 3
#: the remat segments of phase 25 (e)
OBS_REMAT_SEGMENTS = 2
#: the SameDiff ops that launch kernel 7 once a call on the card
ATTENTION_OPS = ("sdpa_core", "dot_product_attention",
                 "multi_head_dot_product_attention")


def recomputed_attention_sites(sd, segments: int) -> int:
    """The attention ops in the checkpointed segments of ``sd``'s remat
    plan at ``segments`` segments: each is recomputed once a step."""
    counts = set()
    for key, plan in sd._exec_cache.items():
        if isinstance(key, tuple) and key[:1] == ("remat",) \
                and key[3] == segments:
            ops = key[1]
            counts.add(sum(sd.ops[i].op_name in ATTENTION_OPS
                           for lo, hi, wrap in plan if wrap
                           for i in ops[lo:hi]))
    if len(counts) != 1:
        raise RuntimeError(f"remat plans at {segments} segments: recomputed "
                           f"attention sites {sorted(counts)}")
    return counts.pop()


def c5_graph(name: str, device: str):
    """One op of the C5 table on placeholder ``x`` (axis 0, the batch),
    its output named ``o``."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    sd = SameDiff(device)
    x = sd.placeholder("x", shape=(None, C5_SHAPE[1]))
    build = {
        "softmax": lambda: sd.nn.softmax(x, 0, name="o"),
        "log_softmax": lambda: sd.nn.log_softmax(x, 0, name="o"),
        "cumsum": lambda: sd.math.cumsum(x, 0, name="o"),
        "standardize": lambda: sd.math.standardize(x, 0, name="o"),
        "concat": lambda: sd.math.concat([x, x * 2.0], 0, name="o"),
        "reverse": lambda: sd.math.reverse(x, axes=[0], name="o"),
        "argmax": lambda: sd.math.argmax(x, axis=0, name="o"),
        # element by element in their domains, but over the whole
        # tensor / along the batch axis
        "clip_by_norm": lambda: sd.math.clip_by_norm(x, clip_norm=1.0,
                                                     name="o"),
        "cosine_distance": lambda: sd.loss.cosine_distance(
            x, sd.math.tanh(x), axis=0, name="o"),
        "reduce_max": lambda: sd.math.reduce_max(x, axis=0, name="o"),
        "reduce_min": lambda: sd.math.reduce_min(x, axis=0, name="o"),
    }
    build[name]()
    return sd


def c5_input(torch):
    return torch.randn(*C5_SHAPE, generator=torch.Generator().manual_seed(25))


def c5_softmax_fit(torch, device: str, mesh=None) -> float:
    """Three Sgd(0.5) steps of an MSE loss over ``softmax(x @ w, 0)``
    (the re-anchor's probe of fault C5), from seeded inputs."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    g = torch.Generator().manual_seed(26)
    xv = torch.randn(C5_SHAPE[0], 64, generator=g)
    yv = torch.rand(C5_SHAPE[0], 16, generator=g) / C5_SHAPE[0]
    w0 = 0.1 * torch.randn(64, 16, generator=g)
    sd = SameDiff(device)
    x = sd.placeholder("x", shape=(None, 64))
    y = sd.placeholder("y", shape=(None, 16))
    w = sd.var("w", array=w0.numpy())
    sd.loss.mean_squared_error(y, sd.nn.softmax(x @ w, 0), name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(
        TrainingConfig.Builder().updater(Sgd(0.5))
        .data_set_feature_mapping("x").data_set_label_mapping("y").build())
    return float(sd.fit_steps({"x": xv.numpy(), "y": yv.numpy()},
                              C5_FIT_STEPS, mesh=mesh))


def phase25_rank(torch, mesh, sd, b, p0: dict, names, device: str) -> dict:
    """Phase 25 (d) and (e) on one rank of phase 24's gloo group: the C5
    table's ops and the softmax ``fit_steps`` under the mesh, and the
    imported BERT-base under the dense exchange with and without
    ``set_remat_segments(OBS_REMAT_SEGMENTS)`` (the deterministic
    algorithms on for both, so the two runs can be held bit for bit)."""
    out = {"c5": {}}
    x = c5_input(torch).numpy()
    for name in C5_GATHERED + C5_COMBINED:
        o = c5_graph(name, device).output({"x": x}, ["o"], mesh=mesh)["o"]
        out["c5"][name] = o.cpu()
    out["c5_fit_loss"] = c5_softmax_fit(torch, device, mesh)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for segs in (0, OBS_REMAT_SEGMENTS):
            _sd_reset(sd, p0, device)
            sd.set_remat_segments(segs)
            _zero_counts()
            losses = [sd.fit_steps(b, 1, mesh=mesh, update_exchange="dense")
                      for _ in range(SD_DP_STEPS)]
            out[f"remat_{segs}"] = {
                "losses": losses, "launches": _flash_counts(),
                "digest": _sd_digest(torch, sd, names)}
        out["remat_recomputed_sites"] = recomputed_attention_sites(
            sd, OBS_REMAT_SEGMENTS)
        sd.set_remat_segments(0)
    finally:
        torch.use_deterministic_algorithms(prev)
    return out


def _obs_gates(torch, on: bool) -> None:
    """Step spans, the step breakdown, the flight recorder and the
    numerics watchdog (every step) all on, or all off."""
    from deeplearning4j_tpu_torch.common import diagnostics, stepstats
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.telemetry import MetricsRegistry
    env = Environment.get()
    env.numerics_watchdog, env.numerics_sample = on, 1
    env.extra["layerprof"] = on
    MetricsRegistry.get().set_enabled(on)
    stepstats.collector().set_enabled(on)
    diagnostics.FlightRecorder.get().enabled = on


def _obs_reset(dump_dir: Path) -> None:
    from deeplearning4j_tpu_torch.common import (diagnostics, layerprof,
                                                 stepstats)
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.telemetry import MetricsRegistry
    Environment.get().flight_recorder_dir = str(dump_dir)
    MetricsRegistry._reset_for_tests()
    stepstats.StepStats._reset_for_tests()
    stepstats.ProfileCapture._reset_for_tests()
    diagnostics.FlightRecorder._reset_for_tests()
    layerprof.reset()


def resnet_conv_dot_flops(net, batch: int) -> int:
    """The analytic conv + dot FLOPs of one ResNet-50 train step, from
    the configuration's shapes alone: a convolution 2·N·Ho·Wo·Cout·Cin·
    kh·kw forward, as much for its weight gradient, and 2·N·H·W·Cin·kh·
    kw·Cout for its input gradient (at the input's size; not for the
    stem, whose input needs none); the dense head 2·N·nIn·nOut three
    times."""
    types = net.conf.resolve_shapes()
    total = 0
    for name in net._topo:
        v = net.conf.vertices[name]
        if not v.is_layer:
            continue
        W = net.params.get(name, {}).get("W")
        if W is None:
            continue
        if W.dim() == 4:
            cout, cin, kh, kw = (int(d) for d in W.shape)
            o, i = types[name], types[v.inputs[0]]
            fwd = 2 * batch * o.height * o.width * cout * cin * kh * kw
            total += 2 * fwd
            if v.inputs[0] not in net.conf.network_inputs:
                total += 2 * batch * i.height * i.width * cin * kh * kw \
                    * cout
        else:
            total += 3 * 2 * batch * int(W.shape[0]) * int(W.shape[1])
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


#: the analytic bytes of one launch of each kernel on a ResNet-50
#: BatchNormalization site [M, C]: each input read once, each output
#: written once
def _resnet_site_bytes(kernel: str, M: int, C: int, esize: int) -> int:
    if kernel == "scale_shift_act":
        return 2 * M * C * esize + 2 * C * 4
    return _site_costs(kernel, M, C, esize, "relu")[0]


def resnet_kernel_bytes(net, report: dict, batch: int, esize: int) -> dict:
    """Each scope of ``report`` whose step launched kernels: the bytes
    ``layer_report`` charged them, their analytic count from the vertex's
    output shape ([batch·H·W, C]) and the scope's own bytes; and the
    launches of each kernel over the step."""
    from deeplearning4j_tpu_torch.common import layerprof
    types = net.conf.resolve_shapes()
    vertex = {layerprof.sanitize(n): n for n in net._topo}
    layers, launches = {}, {}
    for scope, ent in report["layers"].items():
        kl = ent.get("kernel_launches")
        if not kl:
            continue
        analytic = None            # a launch charged outside a layer
        if scope in vertex:
            o = types[vertex[scope]]
            M, C = batch * o.height * o.width, o.channels
            analytic = sum(n * _resnet_site_bytes(k, M, C, esize)
                           for k, n in kl.items())
        layers[scope] = (ent["kernel_bytes"], analytic, ent["bytes"])
        for k, n in kl.items():
            launches[k] = launches.get(k, 0) + n
    return {"layers": layers, "launches": launches}


def phase_observatory(torch, label: str, device: str = "cuda",
                      image: int = 224, batch: int = BATCH,
                      steps: int = OBS_STEPS, sdr=None) -> dict:
    """Phase 25. (a) ResNet-50 trains ``steps`` steps through ``fit``
    with step spans, the step breakdown, the flight recorder and the
    watchdog (every step) on, then the same steps from the same weights
    with all of them off: the step wall times, ``dl4j_train_step_seconds``'
    count, ``steps`` breakdowns and flight-recorder records, kernels 1,
    2, 3, 5 and 6 launched alike, and the losses bit for bit (the
    deterministic algorithms). (b) A NaN in one input row: the next step
    raises ``NumericsEvent`` naming the first bad leaf, and the flight
    recorder's JSONL is on disk. (c) ``layer_report``: its conv + dot
    FLOPs against :func:`resnet_conv_dot_flops`; a ``ProfileCapture`` of
    OBS_CAPTURE_STEPS steps joined into it (per-layer ms, the share of
    busy time in a scope); ``memory_report`` against
    ``torch.cuda.max_memory_allocated``. (d) and (e) read phase 24's
    gloo ranks (``phase25_rank``): the C5 ops against the one-device
    answers, and remat under the mesh. ``device="cpu"`` with a small
    ``image`` rehearses (a)-(c)."""
    import gc
    import shutil

    import numpy as np

    from deeplearning4j_tpu_torch.common import (diagnostics, layerprof,
                                                 stepstats, telemetry)
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    shutil.rmtree(OBS_WORK, ignore_errors=True)
    OBS_WORK.mkdir(parents=True)
    out: dict = {}
    kw = dict(seed=25, height=image, width=image)
    x, y = learnable_batch(torch, torch.Generator().manual_seed(25), batch,
                           image)
    x, y = x.to(device), y.to(device)
    from deeplearning4j_tpu_torch.common.environment import Environment
    env = Environment.get()
    prev_env = (env.numerics_watchdog, env.numerics_sample,
                env.flight_recorder_dir)
    prev_det = torch.are_deterministic_algorithms_enabled()
    prev_cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # ---- (a) the same steps with the observatory on, then off ----
        runs = {}
        for on in (True, False):
            _obs_reset(OBS_WORK / "flightrec")
            _obs_gates(torch, on)
            # earlier phases' garbage freed first, and none while init
            # runs, so the allocator's growth is what init left
            m_gc = torch.cuda.memory_allocated() if on_card else 0
            gc.collect()
            gc.disable()
            try:
                m0 = torch.cuda.memory_allocated() if on_card else 0
                net = ResNet50(**kw).init(device,
                                          generator=torch.Generator()
                                          .manual_seed(25))
                m1 = torch.cuda.memory_allocated() if on_card else 0
            finally:
                gc.enable()
            if on:
                # what init left on the card, by the allocator alone
                init_bytes = m1 - m0 if on_card else None
                gc_freed = m_gc - m0
                init_attr = diagnostics.memory_report(net)["models"][
                    "ComputationGraph"]
                init_sizes = [
                    t.numel() * t.element_size()
                    for tree in (net.params, net.states,
                                 net.updater_states)
                    for t in _leaves(tree) if isinstance(t, torch.Tensor)]
            _zero_counts()
            losses, ms = _timed_steps(torch, net, x, y, steps)
            runs[on] = {
                "losses": losses, "step_ms": ms,
                "median_step_ms": float(np.median(ms[1:])),
                "launches": _counts(),
                "step_count": telemetry.histogram(
                    "dl4j_train_step_seconds").count_of(
                        model="ComputationGraph"),
                "breakdowns": stepstats.collector().records(),
                "summary": stepstats.collector().summary(),
                "recorded": diagnostics.FlightRecorder.get().records()}
            if on:
                net_on = net
        _obs_gates(torch, True)
        a_on, a_off = runs[True], runs[False]
        check(a_on["step_count"] == steps,
              f"(a) dl4j_train_step_seconds count {a_on['step_count']}, "
              f"expected {steps}")
        check(len(a_on["breakdowns"]) == steps and all(
            set(r["phases"]) == set(stepstats.PHASES)
            for r in a_on["breakdowns"]),
            f"(a) {len(a_on['breakdowns'])} step breakdowns")
        check(len(a_on["recorded"]) == steps and all(
            "phases" in r for r in a_on["recorded"]),
            f"(a) {len(a_on['recorded'])} flight-recorder records")
        check(a_off["step_count"] == 0 and not a_off["breakdowns"]
              and not a_off["recorded"], "(a) the gates off recorded")
        for k in ("scale_shift_act", "epilogue_backward", "channel_sums",
                  "bn_bwd_sums", "bn_bwd_dx"):
            per = 0 if k == "epilogue_backward" else 53
            check(a_on["launches"][k] == a_off["launches"][k]
                  == per * steps * on_card,
                  f"(a) {k}: {a_on['launches'][k]} launches on, "
                  f"{a_off['launches'][k]} off, expected {per} a step")
        check(a_on["losses"] == a_off["losses"],
              f"(a) losses on {a_on['losses']} != off {a_off['losses']}")
        out["a"] = {
            "losses": a_on["losses"], "bitwise": True,
            "step_ms_on": a_on["step_ms"], "step_ms_off": a_off["step_ms"],
            "median_step_ms_on": a_on["median_step_ms"],
            "median_step_ms_off": a_off["median_step_ms"],
            "launches": a_on["launches"],
            "step_breakdown": a_on["summary"],
            "record_keys": sorted(a_on["recorded"][0])}
        print(f"[obs] (a) ResNet-50 {image}x{image}, batch {batch}, {steps} "
              f"fit steps: ms a step observed {a_on['median_step_ms']:.3f} "
              f"(steps {[round(m, 3) for m in a_on['step_ms']]}), plain "
              f"{a_off['median_step_ms']:.3f} (steps "
              f"{[round(m, 3) for m in a_off['step_ms']]}); losses bitwise "
              f"equal; launches {a_on['launches']}; "
              f"{len(a_on['breakdowns'])} breakdowns, "
              f"{len(a_on['recorded'])} records, keys "
              f"{out['a']['record_keys']} [{label}]")
        bd = a_on["breakdowns"][-1]
        print(f"[obs] (a) last step's breakdown: "
              f"{ {k: round(v, 6) for k, v in bd['phases'].items()} }, "
              f"total {bd['total_seconds']:.6f}s")

        # ---- (c) attribution, on the observed net ----
        report = net_on.layer_report(x, y)
        convs = sum(e.get("conv_dot_flops_fwd", 0)
                    + e.get("conv_dot_flops_bwd", 0)
                    for e in report["layers"].values())
        want = resnet_conv_dot_flops(net_on, batch)
        check(convs == want, f"(c) layer_report conv + dot FLOPs {convs} "
                             f"!= analytic {want}")
        check(layerprof.reconcile_error_pct(report) < 1e-6,
              "(c) the report's layers do not sum to its totals")
        kb = resnet_kernel_bytes(net_on, report, batch, x.element_size())
        for k in ("scale_shift_act", "channel_sums", "bn_bwd_sums",
                  "bn_bwd_dx"):
            check(kb["launches"].get(k, 0) == 53 * on_card,
                  f"(c) layer_report: {kb['launches'].get(k, 0)} launches "
                  f"of {k} in the step's scopes, expected {53 * on_card}")
        for name, (got, analytic, total) in kb["layers"].items():
            check(got == analytic and total >= got,
                  f"(c) layer {name}: kernel bytes {got}, analytic "
                  f"{analytic}, layer bytes {total}")
        out["c"] = {"conv_dot_flops": convs, "analytic": want,
                    "totals": report["totals"],
                    "layers": len(report["layers"]),
                    "kernel_bytes": kb,
                    "top_layer": layerprof.top_layer()}
        if kb["layers"]:
            bn, (got, analytic, total) = next(iter(kb["layers"].items()))
            print(f"[obs] (c) layer_report kernel bytes == analytic in "
                  f"{len(kb['layers'])} scopes; {bn}: kernels "
                  f"{report['layers'][bn]['kernel_launches']} {got} bytes "
                  f"(analytic {analytic}), the layer {total} bytes "
                  f"[{label}]")
        stepstats.ProfileCapture.start(
            OBS_CAPTURE_STEPS, out_dir=str(OBS_WORK / "profile"),
            expire_seconds=600)
        for _ in range(OBS_CAPTURE_STEPS):
            net_on.fit(x, y)
        _sync(torch, device)
        st = stepstats.ProfileCapture.current_status()
        check(not st.get("active", True) and st["last"]["reason"]
              == "complete", f"(c) capture status {st}")
        trace = OBS_WORK / "profile" / "device.trace.json"
        events = telemetry._load_trace(str(trace)).get("traceEvents", [])
        layer_ms = layerprof.attribute_trace(events)
        layerprof.join_dynamic(
            report, layer_ms, time_source="trace" if
            layerprof.trace_has_device_kernels(events) else
            "host_op_proxy")
        busy = sum(float(e.get("dur", 0) or 0) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
        scoped = sum(d["fwd_ms"] + d["bwd_ms"] for d in layer_ms.values())
        top = sorted(layer_ms.items(),
                     key=lambda kv: -(kv[1]["fwd_ms"] + kv[1]["bwd_ms"]))
        out["c"].update(busy_ms=busy, scoped_ms=scoped,
                        scoped_share=scoped / busy if busy else None,
                        time_source=report["time_source"],
                        layer_ms={k: v for k, v in top})
        print(f"[obs] (c) layer_report: {len(report['layers'])} scopes, "
              f"conv + dot FLOPs {convs} == analytic {want}; totals "
              f"{report['totals']}; profile of {OBS_CAPTURE_STEPS} steps "
              f"({report['time_source']}): busy {busy:.3f} ms, in a scope "
              f"{scoped:.3f} ms (share "
              f"{out['c']['scoped_share'] if busy else float('nan'):.4f});"
              f" heaviest {[(k, round(v['fwd_ms'], 3), round(v['bwd_ms'], 3)) for k, v in top[:8]]}"
              f" [{label}]")
        mem = diagnostics.memory_report(net_on)
        out["c"]["memory"] = {
            k: mem[k] for k in ("live_bytes_total", "peak_bytes_total",
                                "accounted_bytes", "models")}
        attr = (init_attr["params_bytes"] + init_attr["model_state_bytes"]
                + init_attr["updater_state_bytes"])
        # the allocator's rounding: a block of 512-byte units, and a
        # large one (over 1 MiB) may keep up to 1 MiB of its cached
        # block unsplit
        slack = sum(512 if n <= 2 ** 20 else 2 ** 20 for n in init_sizes)
        out["c"]["memory"].update(init_allocated=init_bytes,
                                  init_attributed=attr,
                                  init_tensors=len(init_sizes),
                                  init_slack=slack,
                                  gc_freed_before_init=gc_freed)
        if on_card:
            # the independent sum: what init left on the allocator holds
            # the attributed buffers, each rounded up by the allocator
            check(attr <= init_bytes <= attr + slack,
                  f"(c) memory_report attributes {attr} bytes to the "
                  f"model at init; the allocator grew {init_bytes} for "
                  f"{len(init_sizes)} tensors (slack {slack}; a gc before "
                  f"it freed {gc_freed})")
            # the same counter both sides: this checks the card it reads
            peak = torch.cuda.max_memory_allocated()
            check(mem["peak_bytes_total"] == peak,
                  f"(c) memory_report peak {mem['peak_bytes_total']} != "
                  f"max_memory_allocated {peak}")
            out["c"]["memory"]["max_memory_allocated"] = peak
        print(f"[obs] (c) memory_report: live {mem['live_bytes_total']}, "
              f"peak {mem['peak_bytes_total']} (max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() if on_card else 'n/a'}),"
              f" models {mem['models']}; at init {attr} bytes attributed, "
              f"the allocator grew {init_bytes} for {len(init_sizes)} "
              f"tensors (rounding slack {slack}; {gc_freed} bytes freed by "
              f"a gc before it) [{label}]")

        # ---- (b) a NaN in one input row trips the watchdog ----
        xb = x.clone()
        xb[batch - 1, 0, 0, 0] = float("nan")
        dumps = OBS_WORK / "flightrec"
        event = None
        try:
            net_on.fit(xb, y)
        except diagnostics.NumericsEvent as e:
            event = e
        check(event is not None, "(b) no NumericsEvent on a NaN input")
        check(event.first_bad is not None and event.first_bad["leaf"],
              f"(b) the event names no leaf: {event}")
        jsonl = sorted(dumps.glob("flightrec_*_numerics.jsonl"))
        check(bool(jsonl), f"(b) no numerics dump in {dumps}")
        lines = jsonl[0].read_text().splitlines()
        meta = json.loads(lines[0])
        check(meta["reason"] == "numerics" and meta["event"]["first_bad"]
              == event.first_bad, f"(b) dump meta {meta}")
        out["b"] = {"event": event.to_dict(), "dump_lines": len(lines)}
        print(f"[obs] (b) NumericsEvent at step {event.step}: "
              f"{event.tensor_group} = {event.value}, first bad leaf "
              f"{event.first_bad}; {jsonl[0].name} holds {len(lines)} "
              f"lines [{label}]")
    finally:
        torch.use_deterministic_algorithms(prev_det)
        if prev_cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_cublas
        _obs_gates(torch, True)
        env.extra.pop("layerprof", None)
        (env.numerics_watchdog, env.numerics_sample,
         env.flight_recorder_dir) = prev_env
    if sdr is not None:
        out.update(observatory_mesh_checks(torch, sdr["phase25"], device,
                                           label))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[obs] phase 25 in {out['phase_s']:.1f}s [{label}]")
    return out


def observatory_mesh_checks(torch, ranks: list, device: str,
                            label: str) -> dict:
    """Phase 25 (d) and (e) from phase 24's gloo ranks: each C5 op's
    mesh output against the one-device answer (bitwise for the gathered
    ops, within C5_EXTREME_ATOL for the all-reduced max / min), the
    softmax ``fit_steps`` loss against the one-device loss, and remat
    under the mesh against the unsegmented mesh run (losses and
    variables bitwise) with its kernel 7-9 launches."""
    out = {"d": {}, "e": {}}
    x = c5_input(torch).numpy()
    for name in C5_GATHERED + C5_COMBINED:
        want = c5_graph(name, device).output({"x": x}, ["o"])["o"].cpu()
        for r, rr in enumerate(ranks):
            got = rr["c5"][name]
            if name in C5_GATHERED:
                ok = torch.equal(got, want)
                err = 0.0 if ok else float(
                    (got.double() - want.double()).abs().max())
            else:
                err = float((got.double() - want.double()).abs().max())
                ok = err <= C5_EXTREME_ATOL
            check(ok, f"(d) {name} rank {r}: mesh vs one device {err}")
        out["d"][name] = err
    one = c5_softmax_fit(torch, device)
    for r, rr in enumerate(ranks):
        rel = abs(rr["c5_fit_loss"] - one) / abs(one)
        check(rel <= 1e-6, f"(d) softmax fit_steps rank {r}: loss "
                           f"{rr['c5_fit_loss']} vs one device {one}")
    out["d"]["softmax_fit_steps"] = {"mesh": ranks[0]["c5_fit_loss"],
                                     "one_device": one}
    print(f"[obs] (d) C5 on 2 gloo ranks: max |mesh - one device| "
          f"{ {k: v for k, v in out['d'].items() if k != 'softmax_fit_steps'} }"
          f"; softmax fit_steps loss mesh {ranks[0]['c5_fit_loss']:.9f}, "
          f"one device {one:.9f} [{label}]")
    on_card = device == "cuda"
    for r, rr in enumerate(ranks):
        plain, remat = rr["remat_0"], rr[f"remat_{OBS_REMAT_SEGMENTS}"]
        check(remat["losses"] == plain["losses"]
              and remat["digest"] == plain["digest"],
              f"(e) rank {r}: remat losses {remat['losses']} vs "
              f"{plain['losses']}, or the variables differ")
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            check(remat["launches"][k] == plain["launches"][k],
                  f"(e) rank {r} {k}: {remat['launches'][k]} with remat, "
                  f"{plain['launches'][k]} without")
        sites = rr["remat_recomputed_sites"]
        want = plain["launches"]["flash_fwd"] + SD_DP_STEPS * sites * on_card
        check(sites >= 1 and remat["launches"]["flash_fwd"] == want,
              f"(e) rank {r}: {remat['launches']['flash_fwd']} launches of "
              f"flash_fwd with remat, expected {want} ({sites} attention "
              f"sites recomputed a step)")
    out["e"] = {"losses": ranks[0]["remat_0"]["losses"],
                "recomputed_sites": ranks[0]["remat_recomputed_sites"],
                "launches_plain": ranks[0]["remat_0"]["launches"],
                "launches_remat": [
                    rr[f"remat_{OBS_REMAT_SEGMENTS}"]["launches"]
                    for rr in ranks]}
    print(f"[obs] (e) imported BERT-base, dense exchange, 2 gloo ranks, "
          f"{SD_DP_STEPS} steps: set_remat_segments({OBS_REMAT_SEGMENTS}) "
          f"losses {ranks[0]['remat_0']['losses']} bitwise the unsegmented"
          f" run's, variables too; kernel 7-9 launches a rank "
          f"{out['e']['launches_remat']} (unsegmented "
          f"{out['e']['launches_plain']}; "
          f"{out['e']['recomputed_sites']} attention sites recomputed a "
          f"step) [{label}]")
    return out


#: phase 26: the distributed Transformer LM at GPT-2 small's widths
#: (vocab 50257 padded to a multiple of 128, as Megatron-LM's
#: --make-vocab-size-divisible-by 128 does), 12 blocks, f32, TF32 off
LM_DIMS = dict(vocab_size=50304, max_len=1024, d_model=768, n_heads=12,
               d_ff=3072, layers=12, batch=8, t=1024, real_vocab=50257)
#: each layout: its mesh over the same four gloo ranks, microbatches and
#: experts (on the JAX model's placement: the last block of each stage)
LM_LAYOUTS = {
    "megatron_sp": dict(axes={"data": 1, "pipe": 2, "model": 2},
                        n_micro=4, n_experts=0),
    "ring_cp": dict(axes={"data": 2, "pipe": 1, "seq": 2, "model": 1},
                    n_micro=2, n_experts=8),
}
LM_WORLD, LM_STEPS, LM_SEED, LM_LR = 4, 3, 22, 0.1
LM_WORK = ROOT / "build" / "transformer_lm"
LM_LOSS_RTOL = 1e-5
#: the gradient of every step but the last, leaf by leaf against the
#: float64 plain reference at the same parameters: the norm of the
#: difference within LM_GRAD_RTOL of the reference's norm
LM_GRAD_RTOL = 1e-4
#: one ring step of the ring-CP layout: [b, heads, t / seq, head dim]
LM_RING_STEP = (2, 12, 512, 64)


def lm_conf(dims: dict, layout: str):
    """The port's config of one layout: the widths of ``dims``, the
    blocks split over the layout's pipeline stages, no token dropped by
    the experts (capacity: a rank's tokens of a microbatch), the JAX
    model's default aux-loss weight."""
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerLMConfig
    lay = LM_LAYOUTS[layout]
    ax = lay["axes"]
    mb = dims["batch"] // ax["data"] // lay["n_micro"]
    t_local = dims["t"] // ax.get("seq", 1)
    return TransformerLMConfig(
        vocab_size=dims["vocab_size"], max_len=dims["max_len"],
        d_model=dims["d_model"], n_heads=dims["n_heads"],
        d_ff=dims["d_ff"], layers_per_stage=dims["layers"] // ax["pipe"],
        n_experts=lay["n_experts"], moe_top_k=2, moe_capacity=mb * t_local)


def lm_batch(dims: dict, seed: int = LM_SEED):
    """Random ids and next-token labels [batch, t] from the seed, inside
    the unpadded vocabulary."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, dims["real_vocab"], (dims["batch"], dims["t"] + 1))
    return ids[:, :-1].copy(), ids[:, 1:].copy()


def _lm_model(dims: dict, layout: str, mesh, updater=None):
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.models.transformer import \
        DistributedTransformerLM
    return DistributedTransformerLM(lm_conf(dims, layout), mesh,
                                    updater or Sgd(LM_LR),
                                    n_micro=LM_LAYOUTS[layout]["n_micro"])


def _lm_recording_sgd():
    """Sgd(LM_LR) that keeps the reduced gradients the model hands it
    (``.grads``, flat), so a step's gradient is read without running it
    again."""
    from deeplearning4j_tpu_torch.learning.updaters import IUpdater

    class RecordingSgd(IUpdater):
        def __init__(self):
            super().__init__("Sgd", learning_rate=LM_LR)
            self.grads = None

        def apply(self, grads, state, iteration, epoch=0):
            self.grads = grads
            return super().apply(grads, state, iteration, epoch)
    return RecordingSgd()


def _lm_first_copies(model, flat: dict, rank: int) -> dict:
    """The leaves of a rank's flat tree of which it holds the first copy
    (on the CPU); the others are None."""
    from deeplearning4j_tpu_torch.models.transformer import flatten_tree
    from deeplearning4j_tpu_torch.parallel.mesh import first_copy
    specs = flatten_tree(model.param_specs())
    return {k: (v.detach().cpu() if first_copy(specs[k], model.mesh, rank)
                else None) for k, v in flat.items()}


def lm_rank_main(work: str, rank: int, world: int,
                 device: str = "cuda") -> None:
    """One rank of phase 26, its own process: both layouts over one
    four-process gloo world (``ProcessGroupMesh.with_axes``), LM_STEPS
    ``train_step``s each from the seeded global weights; each step's
    loss, wall ms and kernel launches (counts zeroed just before the
    step, read just after), and, for every step but the last, the first
    copies of its reduced gradient and of the parameters it leaves go to
    ``work``. Then phase 27's layouts on the same world
    (``pp_rank_layouts``), their records under ``"pp"``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.models.transformer import flatten_tree
    from deeplearning4j_tpu_torch.parallel.mesh import ProcessGroupMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = json.loads((Path(work) / "dims.json").read_text())
    ids, labels = lm_batch(dims)
    names = list(LM_LAYOUTS)
    world_mesh = ProcessGroupMesh(
        f"file://{work}/store", world, rank, device=device, backend="gloo",
        timeout_s=600, axes=LM_LAYOUTS[names[0]]["axes"])
    # wall-clock stamps the parent sets against its spawn
    out = {"stamps": {"mesh_ready": time.time()}}
    try:
        for i, name in enumerate(names):
            t_layout = time.perf_counter()
            mesh = world_mesh if i == 0 else world_mesh.with_axes(
                LM_LAYOUTS[name]["axes"])
            sgd = _lm_recording_sgd()
            model = _lm_model(dims, name, mesh, sgd)
            t0 = time.perf_counter()
            params, opt = model.init(seed=LM_SEED)
            _sync(torch, device)
            res = {"init_s": time.perf_counter() - t0, "losses": [],
                   "step_ms": [], "launches": [], "grads": [],
                   "params": [],
                   "coords": dict(zip(mesh.axes, mesh.coords(rank)))}
            for it in range(LM_STEPS):
                _sync(torch, device)
                _zero_counts()
                t0 = time.perf_counter()
                params, opt, loss = model.train_step(params, opt, ids,
                                                     labels, it)
                _sync(torch, device)
                res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                res["launches"].append(_flash_counts())
                res["losses"].append(loss)
                if it < LM_STEPS - 1:
                    res["grads"].append(_lm_first_copies(model, sgd.grads,
                                                         rank))
                    res["params"].append(_lm_first_copies(
                        model, flatten_tree(params[0]), rank))
                sgd.grads = None
            if device == "cuda":
                res["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
                torch.cuda.reset_peak_memory_stats()
            res["layout_s"] = time.perf_counter() - t_layout
            out[name] = res
            del params, opt, model
            if device == "cuda":
                torch.cuda.empty_cache()
        # phase 27 on the same world: its layouts are new axis groups
        t_pp = time.perf_counter()
        out["pp"] = pp_rank_layouts(torch, world_mesh, work, rank, device,
                                    dims["pp"])
        out["pp_s"] = time.perf_counter() - t_pp
    finally:
        world_mesh.shutdown()
    out["stamps"]["saving"] = time.time()
    torch.save(out, f"{work}/rank{rank}.pt")


def _run_lm_ranks(dims: dict, device: str) -> list:
    """The LM_WORLD ranks of phase 26, each its own process, waited for
    with a limit."""
    import shutil
    import torch
    shutil.rmtree(LM_WORK, ignore_errors=True)
    LM_WORK.mkdir(parents=True)
    (LM_WORK / "dims.json").write_text(json.dumps(
        {"pp": PP_DIMS, **dims}))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    t_spawn = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.lm_rank_main({str(LM_WORK)!r}, {r}, "
         f"{LM_WORLD}, {device!r})"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(LM_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of phase 26's gloo world "
                                 f"exited {p.returncode}:\n{log[-4000:]}")
    t_done = time.time()
    res = [torch.load(LM_WORK / f"rank{r}.pt") for r in range(LM_WORLD)]
    shutil.rmtree(LM_WORK, ignore_errors=True)
    st = [r["stamps"] for r in res]
    print(f"[lm] rank processes: spawn to mesh ready "
          f"{max(x['mesh_ready'] for x in st) - t_spawn:.1f}s, to their "
          f"results saved {t_done - t_spawn:.1f}s (saving "
          f"{t_done - min(x['saving'] for x in st):.1f}s), loaded in "
          f"{time.time() - t_done:.1f}s; phase 27 on the ranks "
          f"{[round(r_['pp_s'], 1) for r_ in res]}s; a layout on rank 0 (s: "
          f"init, steps, all) " + ", ".join(
              f"{n} {res[0][n]['init_s']:.1f} / "
              f"{sum(res[0][n]['step_ms']) / 1e3:.1f} / "
              f"{res[0][n]['layout_s']:.1f}" for n in LM_LAYOUTS))
    return res


def lm_plain_ce_sum(torch, g: dict, conf, pp: int, ids, labels,
                    t_shard: int):
    """The plain single-process forward of the distributed LM over its
    global tree (the port's counterpart of ``ref_loss`` in
    ``tests/test_transformer_5d.py``) on the rows given: ``(summed
    cross-entropy, summed gating aux loss)``. Dense causal attention; the
    experts route each token to its top-2 with no capacity (nothing
    drops); the aux loss (Switch's E * sum_e f_e p_e) is taken over each
    ``t_shard`` steps of the rows, as each rank takes it over its
    microbatch's tokens, and summed over those shards and the expert
    blocks."""
    import torch.nn.functional as F
    b, t = ids.shape
    d, h = conf.d_model, conf.n_heads
    dh = d // h

    def ln(x, gg, bb):
        m = x.mean(-1, keepdim=True)
        v = (x - m).square().mean(-1, keepdim=True)
        return (x - m) * torch.rsqrt(v + 1e-5) * gg + bb

    def gelu(x):
        return F.gelu(x, approximate="tanh")

    x = g["embed"][ids] + g["pos"][:t]
    aux = x.new_zeros(())
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                   device=x.device))
    for s in range(pp):
        for l in range(conf.layers_per_stage):
            p = _lm_index(g["stages"][l], s)
            hh = ln(x, p["ln1_g"], p["ln1_b"])
            a = p["attn"]

            def heads(z):
                return z.reshape(b, t, h, dh).transpose(1, 2)

            sc = heads(hh @ a["Wq"]) @ heads(hh @ a["Wk"]).transpose(-1, -2)
            sc = torch.where(causal, sc / dh ** 0.5, -1e9)
            o = torch.softmax(sc, -1) @ heads(hh @ a["Wv"])
            x = x + o.transpose(1, 2).reshape(b, t, d) @ a["Wo"] + a["bo"]
            hh = ln(x, p["ln2_g"], p["ln2_b"])
            if "moe" in p:
                m = p["moe"]
                n_e = m["Wi"].shape[0]
                hf = hh.reshape(b * t, d)
                probs = torch.softmax(hf @ m["Wg"], -1)
                for pr in probs.reshape(b, t // t_shard, t_shard,
                                        n_e).unbind(1):
                    pr = pr.reshape(-1, n_e)
                    top1 = F.one_hot(pr.argmax(-1), n_e).to(pr.dtype)
                    aux = aux + n_e * (top1.mean(0) * pr.mean(0)).sum()
                top = probs.topk(2, -1)
                gate = top.values / top.values.sum(-1, keepdim=True)
                y = torch.zeros_like(hf)
                for e in range(n_e):
                    rows, slot = (top.indices == e).nonzero(as_tuple=True)
                    if rows.numel():
                        ye = gelu(hf[rows] @ m["Wi"][e]) @ m["Wo"][e]
                        y = y.index_add(0, rows,
                                        ye * gate[rows, slot, None])
                x = x + y.reshape(b, t, d)
            else:
                m = p["mlp"]
                x = x + gelu(hh @ m["Wi"] + m["bi"]) @ m["Wo"] + m["bo"]
    hh = ln(x, g["ln_f_g"], g["ln_f_b"])
    logits = hh @ g["head"]
    return F.cross_entropy(logits.reshape(b * t, -1), labels.reshape(-1),
                           reduction="sum"), aux


def _lm_index(tree, s: int):
    if isinstance(tree, dict):
        return {k: _lm_index(v, s) for k, v in tree.items()}
    return tree[s]


def lm_reference(torch, g: dict, conf, layout: str, ids, labels, dtype,
                 grads: bool):
    """(loss, gradient tree or None) of the plain forward in ``dtype``,
    one rank's microbatch of rows at a time: the mean cross-entropy over
    every token plus ``aux_coef`` x the aux loss averaged over the ranks'
    microbatches and time shards, as the layout's step takes it."""
    from deeplearning4j_tpu_torch.models.transformer import (flatten_tree,
                                                             unflatten_tree)
    lay = LM_LAYOUTS[layout]
    ax = lay["axes"]
    sp = ax.get("seq", 1)
    rows = ids.shape[0] // ax["data"] // lay["n_micro"]
    t_shard = ids.shape[1] // (sp if sp > 1 else ax["model"])
    n_groups = (ids.shape[0] // rows) * (ids.shape[1] // t_shard)
    flat = {k: v.detach().to(dtype).requires_grad_(grads)
            for k, v in flatten_tree(g).items()}
    tree = unflatten_tree(g, flat)
    n = ids.numel()
    total = 0.0
    acc = None
    for r0 in range(0, ids.shape[0], rows):
        with torch.set_grad_enabled(grads):
            ce, aux = lm_plain_ce_sum(
                torch, tree, conf, ax["pipe"], ids[r0:r0 + rows],
                labels[r0:r0 + rows], t_shard)
            part = ce / n + conf.aux_coef * aux / n_groups
        total += float(part.detach())
        if grads:
            got = torch.autograd.grad(part, list(flat.values()),
                                      allow_unused=True)
            got = [x if x is not None else torch.zeros_like(v)
                   for x, v in zip(got, flat.values())]
            acc = got if acc is None else [a + b for a, b in zip(acc, got)]
    return total, (None if acc is None else dict(zip(flat, acc)))


def lm_ring_step_check(torch, device: str = "cuda") -> dict:
    """One ring step of the ring-CP layout on the card: kernels 7, 8 and
    9 through ``flash_attention_with_lse`` with a non-zero cotangent on
    the output and the log-sum-exp (as the ring's merge gives), against
    autograd through the plain forward, both ``causal`` values, f32;
    within ``FLASH_TOL``."""
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    g = torch.Generator(device=device).manual_seed(LM_SEED)
    out = {}
    (f_rtol, f_atol), (g_rtol, g_atol) = FLASH_TOL["float32"]
    for causal in (False, True):
        q, k, v, do = (torch.randn(*LM_RING_STEP, device=device,
                                   generator=g) for _ in range(4))
        g_lse = torch.randn(*LM_RING_STEP[:3], device=device, generator=g)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = sq.flash_attention_with_lse(*ins, causal)
        got = torch.autograd.grad((o, lse), ins, (do, g_lse))
        o, lse = o.detach(), lse.detach()
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        r_o, r_lse = sq.flash_forward_plain(*ref, None, causal)
        want = torch.autograd.grad((r_o, r_lse), ref, (do, g_lse))
        r_o, r_lse = r_o.detach(), r_lse.detach()
        errs = {"out": float((o - r_o).abs().max()),
                "lse": float((lse - r_lse).abs().max())}
        for name, a, b in (("out", o, r_o), ("lse", lse, r_lse)):
            check(bool(torch.allclose(a, b, rtol=f_rtol, atol=f_atol)),
                  f"ring step (causal={causal}): {name} off its plain "
                  f"version by {errs[name]:.3e}")
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            errs[name] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, rtol=g_rtol, atol=g_atol)),
                  f"ring step (causal={causal}): {name} off its plain "
                  f"version by {errs[name]:.3e}")
        out[f"causal_{causal}"] = errs
    print(f"[lm] ring step {LM_RING_STEP} f32 flash_attention_with_lse vs "
          f"plain, with an lse cotangent: {out}")
    return out


def phase_transformer_lm(torch, label: str, device: str = "cuda",
                         dims: Optional[dict] = None) -> dict:
    """Phase 26: ``DistributedTransformerLM`` at GPT-2 small's widths on
    LM_WORLD gloo rank processes of this card, in its megatron-SP and
    ring-CP layouts (``LM_LAYOUTS``): LM_STEPS Sgd(0.1) ``train_step``s
    each; every step's loss against the float64 plain single-process
    forward over the ranks' gathered global parameters at that step
    (LM_LOSS_RTOL), the gradient of every step but the last leaf by leaf
    against that reference's (LM_GRAD_RTOL, norm-wise), a falling loss,
    and kernels 7-9's launches a rank a step: blocks x microbatches x
    (seq index + 1) in ring-CP, 0 in megatron-SP (the per-query causal
    mask takes the dense path); then one ring step's kernels against
    their plain versions (``lm_ring_step_check``). ``device="cpu"`` with
    small ``dims`` rehearses it (no kernel to count there)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.transformer import (flatten_tree,
                                                             unflatten_tree)
    from deeplearning4j_tpu_torch.parallel.mesh import gather_leaf, make_mesh
    t_phase = time.perf_counter()
    dims = dict(LM_DIMS, **(dims or {}))
    if device == "cuda":
        torch.cuda.empty_cache()
    ranks = _run_lm_ranks(dims, device)
    t_ranks = time.perf_counter() - t_phase
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ids_np, labels_np = lm_batch(dims)
    ids = torch.from_numpy(ids_np).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    out = {"dims": dims, "ranks_s": t_ranks}
    try:
        for name, lay in LM_LAYOUTS.items():
            t_ref = time.perf_counter()
            # the layout's shapes and specs, on a CPU mesh of its axes
            model = _lm_model(dims, name, make_mesh(
                lay["axes"], ["cpu"] * LM_WORLD))
            conf = model.conf
            specs = flatten_tree(model.param_specs())
            like = model.init_global_params(LM_SEED)

            def gathered(what, step):
                return {k: gather_leaf([r[name][what][step][k]
                                        for r in ranks], specs[k],
                                       model.mesh).to(device)
                        for k in specs}

            # the parameters each step starts from: the seeded global
            # tree, then what the ranks' steps left
            snaps = [{k: v.to(device) for k, v in
                      flatten_tree(like).items()}]
            snaps += [gathered("params", i) for i in range(LM_STEPS - 1)]
            ref_losses, worst = [], {}
            for step, snap in enumerate(snaps):
                check_grad = step < LM_STEPS - 1
                loss, g64 = lm_reference(
                    torch, unflatten_tree(like, snap), conf, name, ids,
                    labels, torch.float64, grads=check_grad)
                ref_losses.append(loss)
                if not check_grad:
                    continue
                got = gathered("grads", step)
                for k, ref in g64.items():
                    e = float((got[k].double() - ref).norm()) / max(
                        float(ref.norm()), 1e-30)
                    check(e <= LM_GRAD_RTOL,
                          f"{name} step-{step + 1} gradient {k}: {e:.3e} "
                          f"from the float64 reference")
                    worst[k] = max(worst.get(k, 0.0), e)
                del got, g64
            ref_s = time.perf_counter() - t_ref
            losses = [r[name]["losses"] for r in ranks]
            for r, ls in enumerate(losses):
                for step, (got, want) in enumerate(zip(ls, ref_losses)):
                    e = abs(got - want) / abs(want)
                    check(e <= LM_LOSS_RTOL,
                          f"{name} rank {r} step {step + 1}: loss {got!r} "
                          f"vs the plain forward's {want!r} ({e:.2e})")
            check(losses[0][-1] < losses[0][0],
                  f"{name}: the loss did not fall {losses[0]}")
            kmax = max(worst, key=worst.get)
            # kernels 7-9 a rank a step
            launches = [[st for st in r[name]["launches"]] for r in ranks]
            want_l = []
            for r in ranks:
                s_idx = r[name]["coords"].get("seq", 0)
                n = (dims["layers"] * lay["n_micro"] * (s_idx + 1)
                     if lay["axes"].get("seq", 1) > 1 else 0)
                want_l.append({k: n for k in FLASH_KERNELS})
            if device == "cuda":
                for r, (got, want) in enumerate(zip(launches, want_l)):
                    for step, c in enumerate(got):
                        check(c == want,
                              f"{name} rank {r} step {step + 1}: kernels "
                              f"7-9 launched {c}, derived {want}")
            step_ms = [float(np.median(r[name]["step_ms"])) for r in ranks]
            out[name] = {
                "losses": losses[0], "ref_losses": ref_losses,
                "loss_rel_err": max(abs(a - b) / abs(b) for ls in losses
                                    for a, b in zip(ls, ref_losses)),
                "grad_vs_f64_worst": {"leaf": kmax, "rel": worst[kmax]},
                "reference_s": ref_s,
                "launches_per_rank_per_step": launches,
                "launches_derived": want_l,
                "median_step_ms_per_rank": step_ms,
                "step_ms_rank0": ranks[0][name]["step_ms"],
                "init_s_rank0": ranks[0][name]["init_s"],
                "peak_mb_per_rank": [r[name].get("peak_mb") for r in ranks],
                "coords": [r[name]["coords"] for r in ranks]}
            print(f"[lm] {name} {lay['axes']} n_micro {lay['n_micro']} "
                  f"experts {lay['n_experts']}: losses {losses[0]} vs plain "
                  f"{ref_losses} (worst rel {out[name]['loss_rel_err']:.2e}"
                  f"); steps 1-{LM_STEPS - 1} gradients' worst leaf {kmax} "
                  f"{worst[kmax]:.3e} from float64; reference "
                  f"{ref_s:.1f}s; kernels 7-9 a step per rank "
                  f"{[l_[0] for l_ in launches]}; median ms a step per "
                  f"rank {[round(x, 3) for x in step_ms]}; peak MB per "
                  f"rank {out[name]['peak_mb_per_rank']} [{label}]")
            del snaps, like
        if device == "cuda":
            out["ring_step"] = lm_ring_step_check(torch, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out["pp_ranks"] = [r["pp"] for r in ranks]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[lm] phase 26 in {out['phase_s']:.1f}s (rank processes "
          f"{t_ranks:.1f}s); median ms a step: megatron-SP "
          f"{out['megatron_sp']['median_step_ms_per_rank']}, ring-CP "
          f"{out['ring_cp']['median_step_ms_per_rank']} [{label}]")
    return out


# ---------------------------------------------------------------------------
# phase 27: the pipeline fit path on four gloo ranks (inside phase 26's)
# ---------------------------------------------------------------------------
#: each layout: tensor and pipeline degrees over the four ranks, the update
#: exchange, and what a row of its batch is
PP_LAYOUTS = {
    "resnet50": dict(tp=1, pp=2, exchange="sharded", rows="images"),
    "attention": dict(tp=2, pp=2, exchange="dense", rows="sequences"),
}
PP_WORLD, PP_MICRO, PP_STEPS = 4, 4, 3
#: full width: ResNet-50 at 224x224x3 (1000 classes), the attention
#: classifier at BERT-base widths (``ATTN``)
PP_DIMS = dict(image=224, **ATTN)
PP_SEED = 27
#: ResNet-50's learning rate (Sgd): at 0.1, and under phase 19's
#: Nesterovs(0.1, 0.9), this batch's loss rises again at step 3 with
#: 8-row microbatch statistics, the one-process run's as much (f32 on the
#: CPU at 224x224: 10.40, 5.50, 26.85)
PP_RESNET_LR = 0.02
PP_WORK = ROOT / "build" / "pipeline_fit"


def pp_inputs(torch, name: str, device: str, dims: dict):
    """A layout's seeded network on ``device`` and its global batch of
    BATCH rows, as numpy: ``(net, x, y, features mask or None)``. The
    ranks and the references build it alike."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam, Sgd
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    if name == "resnet50":
        # phase 19's seeded network and learnable batch, under Sgd
        g = torch.Generator().manual_seed(21)
        image = dims["image"]
        net = ResNet50(seed=21, height=image, width=image,
                       updater=Sgd(PP_RESNET_LR)).init(device, generator=g)
        x, y = learnable_batch(torch, g, BATCH, image)
        return net, x.numpy(), y.numpy(), None
    conf = attention_classifier_conf(dims["vocab"], dims["hidden"],
                                     dims["heads"], dims["t"], Adam(1e-3))
    net = ComputationGraph(conf).init(
        device, generator=torch.Generator().manual_seed(PP_SEED))
    ids, mask, labels = attention_batch(
        torch, torch.Generator().manual_seed(PP_SEED), BATCH, dims["t"],
        dims["vocab"])
    return net, ids.numpy(), labels.numpy(), mask.numpy()


def _cpu_tree(tree) -> dict:
    return {k: {n: t.detach().cpu().clone() for n, t in sub.items()}
            for k, sub in tree.items()}


class _PpRecorder:
    """A rank's listener for phase 27: each step's wall ms (the card
    synchronised), its kernel launches (counts read, then zeroed), its
    loss, the trainer's report, and CPU copies of this rank's stage's
    parameters and states; step 1's gradient as the rank hands it to the
    update tail (its own rows' mean over the microbatches, its slices of
    the tensor-parallel leaves)."""

    def __init__(self, torch, net, device: str):
        self.torch, self.on_card = torch, device == "cuda"
        self.steps, self.grads1 = [], None
        self.master = None
        # whole shapes, before the ranks hold shards
        self.whole = {k: {n: t.numel() for n, t in sub.items()}
                      for k, sub in net.params.items()}
        self.resident_ok = None
        tail = net._update_tail

        def recording_tail(grads, iteration):
            if self.grads1 is None:
                self.grads1 = _cpu_tree(grads)
            return tail(grads, iteration)
        net._update_tail = recording_tail

    def start(self):
        self.mark = time.perf_counter()

    def iteration_done(self, model, iteration, epoch):
        if self.on_card:
            self.torch.cuda.synchronize()
        now = time.perf_counter()
        launches = _counts()
        _zero_counts()
        tr = self.master.trainer
        rank = self.master._mesh.rank
        s = tr.stage_of_rank(rank)
        names = tr.part.stage_entries(s)
        specs = tr._tp_specs[s]
        if self.resident_ok is None:
            # each tensor-parallel leaf held at 1/tp of its whole shape
            self.resident_ok = all(
                model.params[k][n].numel() * tr.tp == self.whole[k][n]
                for k, sub in specs.items() for n in sub)
        rep = {k: v for k, v in tr.last_report.items()}
        self.steps.append({
            "ms": (now - self.mark) * 1e3, "launches": launches,
            "loss": model.score(), "report": rep,
            "params": _cpu_tree({k: model.params[k] for k in names}),
            "states": _cpu_tree({k: model.states[k] for k in names
                                 if model.states.get(k)})})
        self.mark = time.perf_counter()

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def pp_rank_layouts(torch, world_mesh, work: str, rank: int, device: str,
                    dims: dict) -> dict:
    """Phase 27 on this rank of a PP_WORLD-process gloo world: each
    layout of PP_LAYOUTS through ``SharedTrainingMaster`` (its
    ``tensor_parallel`` / ``pipeline_stages`` / ``microbatches`` /
    ``pipeline_schedule`` builders) on the world laid out as ``{data,
    model, pipe}`` (``world_mesh.with_axes``), PP_STEPS steps of 1F1B
    over PP_MICRO microbatches, this process feeding its data index's
    shard of the global batch. Returns each layout's record."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import zero
    from deeplearning4j_tpu_torch.parallel.sharedtraining import \
        SharedTrainingMaster
    from deeplearning4j_tpu_torch.parallel.wrapper import fit_mesh_axes
    out = {}
    for name, lay in PP_LAYOUTS.items():
        t_layout = time.perf_counter()
        tp, pp = lay["tp"], lay["pp"]
        axes = fit_mesh_axes(PP_WORLD, tp, pp)
        mesh = world_mesh.with_axes(axes)
        net, x, y, m = pp_inputs(torch, name, device, dims)
        dense = net.params
        dp = axes["data"]
        d, k = rank // (tp * pp), BATCH // dp
        rows = slice(d * k, (d + 1) * k)
        ds = DataSet(x[rows], y[rows],
                     features_mask=None if m is None else m[rows])
        rec = _PpRecorder(torch, net, device)
        net.set_listeners(rec)
        master = (SharedTrainingMaster.Builder(k)
                  .coordinator(f"file://{work}/store", PP_WORLD, rank,
                               "gloo")
                  .tensor_parallel(tp).pipeline_stages(pp)
                  .microbatches(PP_MICRO).pipeline_schedule("1f1b")
                  .update_exchange(lay["exchange"])
                  .collective_timeout(600).build())
        master._mesh = mesh             # this world, laid out anew
        rec.master = master
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(torch, device)
        _zero_counts()
        rec.start()
        master.fit(net, ListDataSetIterator([ds] * PP_STEPS))
        tr = master.trainer
        s = tr.stage_of_rank(rank)
        specs = tr._tp_specs[s]
        out[name] = {
            "coords": dict(zip(mesh.axes, mesh.coords(rank))), "stage": s,
            "boundaries": tr.part.boundaries,
            "steps": rec.steps, "grads1": rec.grads1,
            "tp_dims": {e: {n: [i for i, a in enumerate(ls.compute)
                                if a == "model"][0]
                            for n, ls in sub.items()}
                        for e, sub in specs.items()},
            "resident_ok": rec.resident_ok,
            "axis_bytes": zero.update_exchange_axis_bytes(
                dense, dp, tp, {e: v for st in tr._tp_specs
                                for e, v in st.items()}),
            "peak_mb": (torch.cuda.max_memory_allocated() / 2**20
                        if device == "cuda" else None),
            "layout_s": time.perf_counter() - t_layout}
        del net, master, rec, dense
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def pp_rank_main(work: str, rank: int, device: str = "cuda") -> None:
    """Phase 27 alone on one rank (its own process and world): what
    ``lm_rank_main`` runs after phase 26, for a rehearsal or a short
    call on the card."""
    import torch
    sys.path.insert(0, str(ROOT))
    from deeplearning4j_tpu_torch.parallel.mesh import ProcessGroupMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = json.loads((Path(work) / "dims.json").read_text())
    world = ProcessGroupMesh(f"file://{work}/store", PP_WORLD, rank,
                             device=device, backend="gloo", timeout_s=600)
    try:
        out = {"pp": pp_rank_layouts(torch, world, work, rank, device,
                                     dims["pp"])}
    finally:
        world.shutdown()
    torch.save(out, f"{work}/rank{rank}.pt")


def _run_pp_ranks(dims: dict, device: str) -> list:
    """Phase 27's ranks on their own (``pp_rank_main``), waited for with
    a limit."""
    import shutil
    import torch
    shutil.rmtree(PP_WORK, ignore_errors=True)
    PP_WORK.mkdir(parents=True)
    (PP_WORK / "dims.json").write_text(json.dumps({"pp": dims}))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.pp_rank_main({str(PP_WORK)!r}, {r}, "
         f"{device!r})"], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PP_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of phase 27's gloo world "
                                 f"exited {p.returncode}:\n{log[-4000:]}")
    res = [torch.load(PP_WORK / f"rank{r}.pt")["pp"]
           for r in range(PP_WORLD)]
    shutil.rmtree(PP_WORK, ignore_errors=True)
    return res


def pp_reference(torch, net, x, y, m, steps: int, n_micro: int,
                 loss_only: bool = False) -> dict:
    """The one-process run with the pipeline's semantics: microbatch mi
    is rows [mi·mb, (mi+1)·mb) of the batch, each microbatch from the
    step's states, the gradients summed in microbatch order (1F1B) and
    scaled by 1/M, the model's own update tail once a step, the states
    kept the last microbatch's, the loss the microbatches' mean. Each
    step's loss, parameters and states (CPU), and step 1's gradient;
    ``loss_only``: the first step's loss without an update."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import tree_map
    inputs, labels, _, fmask = net._split(
        DataSet(x, y, features_mask=m), None)
    mb = int(inputs[0].shape[0]) // n_micro
    out = {"losses": [], "params": [], "states": [], "grads1": None}
    for step in range(steps):
        states0 = dict(net.states)
        gsum, losses, ns_last = None, [], None
        for mi in range(n_micro):
            sl = slice(mi * mb, (mi + 1) * mb)
            if loss_only:
                with torch.no_grad():
                    loss, _ = net._loss(
                        net.params, states0, [t[sl] for t in inputs],
                        [t[sl] for t in labels], None,
                        fmask[sl] if fmask is not None else None,
                        training=True, rng=None)
                losses.append(float(loss))
                continue
            loss, grads, ns = net._grads(
                states0, [t[sl] for t in inputs], [t[sl] for t in labels],
                None, fmask[sl] if fmask is not None else None)
            gsum = grads if gsum is None else tree_map(
                lambda a, b: a + b, gsum, grads)
            losses.append(float(loss))
            ns_last = ns
        out["losses"].append(sum(losses) / n_micro)
        if loss_only:
            return out
        g = tree_map(lambda t: t * (1.0 / n_micro), gsum)
        if step == 0:
            out["grads1"] = _cpu_tree(g)
        with torch.no_grad():
            net._update_tail(g, net.iteration_count)
        net._keep_states(ns_last)
        net.iteration_count += 1
        out["params"].append(_cpu_tree(net.params))
        out["states"].append(_cpu_tree(net.states))
    return out


def _pp_assemble(recs: list, pick, data: int) -> dict:
    """One data index's whole tree from its ranks' stage slices
    (``pick(rec)``): each stage's entries from its model rank 0, the
    tensor-parallel leaves concatenated over the model ranks."""
    import torch
    out = {}
    for rec in recs:
        c = rec["coords"]
        if c.get("data", 0) != data or c.get("model", 0) != 0:
            continue
        for k, sub in pick(rec).items():
            out[k] = dict(sub)
            for n, dim in rec["tp_dims"].get(k, {}).items():
                shards = sorted(
                    (r2["coords"]["model"], pick(r2)[k][n]) for r2 in recs
                    if r2["stage"] == rec["stage"]
                    and r2["coords"].get("data", 0) == data)
                out[k][n] = torch.cat([t for _, t in shards], dim)
    return out


def _rel_norm_t(a, b) -> float:
    return float((a.double() - b.double()).norm() /
                 b.double().norm().clamp_min(1e-30))


def _pp_f64(torch, name: str, params: dict, states: dict, dims: dict):
    """The layout's network in float64 on the CPU from ``params`` and
    ``states``."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam, Sgd
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    if name == "resnet50":
        conf = ResNet50(seed=21, height=dims["image"], width=dims["image"],
                        updater=Sgd(PP_RESNET_LR)).conf()
        conf.dtype = "float64"
    else:
        conf = attention_classifier_conf(
            dims["vocab"], dims["hidden"], dims["heads"], dims["t"],
            Adam(1e-3), dtype="float64")
    return ComputationGraph(conf).set_params(
        {k: {n: t.double() for n, t in sub.items()}
         for k, sub in params.items()},
        {k: {n: t.double() for n, t in sub.items()}
         for k, sub in states.items()}, "cpu")


def _pp_derived_launches(name: str, net, boundaries) -> list:
    """Each stage's launches a rank a step, derived from the partition
    before the run: a non-last stage runs its forward twice (the forward
    op, and the recompute inside its backward) and its backward once a
    microbatch, the last stage each once (its forward inside the loss's
    backward). ResNet-50: kernels 1 and 3 a BatchNormalization site a
    forward, 5 and 6 a backward; the classifier: kernel 7 an attention
    site a forward, 8 and 9 a backward."""
    topo = net._topo
    kinds = ({"BatchNormalization"} if name == "resnet50" else
             {"SelfAttentionLayer", "LearnedSelfAttentionLayer"})
    fwd_k, bwd_k = ((("scale_shift_act", "channel_sums"),
                     ("bn_bwd_sums", "bn_bwd_dx")) if name == "resnet50"
                    else (("flash_fwd",), ("flash_bwd_dq",
                                           "flash_bwd_dkv")))
    n_st = len(boundaries) - 1
    out = []
    for s in range(n_st):
        sites = sum(1 for v in topo[boundaries[s]:boundaries[s + 1]]
                    if type(net.conf.vertices[v].content).__name__ in kinds)
        fwd = (1 if s == n_st - 1 else 2) * sites * PP_MICRO
        want = {k: fwd for k in fwd_k}
        want.update({k: sites * PP_MICRO for k in bwd_k})
        out.append({"sites": sites, "want": want})
    return out


def phase_pipeline_fit(torch, label: str, device: str = "cuda",
                       dims: Optional[dict] = None,
                       ranks: Optional[list] = None) -> dict:
    """Phase 27: the pipeline fit path (``PipelineTrainer`` through
    ``SharedTrainingMaster``'s ``tensor_parallel`` / ``pipeline_stages``)
    at full width on PP_WORLD gloo ranks of the card, from ``ranks``
    (phase 26's rank processes ran it after their own layouts) or from
    ranks of its own. (a) ResNet-50, ``{data: 2, pipe: 2}``, per-stage
    ZeRO-1, Sgd(PP_RESNET_LR), l2 1e-4; (b) the masked attention classifier at BERT-base
    widths, ``{data: 1, model: 2, pipe: 2}``, dense tail, Adam(1e-3);
    each f32 with TF32 off, global batch BATCH in PP_MICRO microbatches,
    1F1B, PP_STEPS steps. Held: each step's loss within LOSS_RTOL of the
    one-process forward with the pipeline's semantics over the ranks'
    gathered parameters at that step; step 1's gradient leaf by leaf,
    and its update, within UPDATE_FACTOR x the one-process card run's
    distance from a float64 CPU step (+ UPDATE_FLOOR), as ``_hold_rank``
    holds phase 19's ranks; the running statistics after step 1 within
    STATE_RTOL of the one-process run's; a falling loss; each rank's
    kernel launches a step equal to the counts derived from the
    partition; peak residency [2, 1]; the pipe wire bytes forward equal
    to PP_MICRO x a rank's bytes of stage 0's outgoing activations;
    nothing of the update exchange across ``model``; each rank's
    tensor-parallel leaves at half their shape. ``device="cpu"`` with
    small ``dims`` rehearses it (no kernel to count there)."""
    import numpy as np
    from deeplearning4j_tpu_torch.parallel.pipeline import \
        make_stage_adapter
    t_phase = time.perf_counter()
    dims = dict(PP_DIMS, **(dims or {}))
    on_card = device == "cuda"
    if ranks is None:
        ranks = _run_pp_ranks(dims, device)
    t_ranks = time.perf_counter() - t_phase
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"ranks_s": t_ranks}
    try:
        for name, lay in PP_LAYOUTS.items():
            t0 = time.perf_counter()
            recs = [r[name] for r in ranks]
            net, x, y, m = pp_inputs(torch, name, device, dims)
            p0, s0 = _cpu_tree(net.params), _cpu_tree(net.states)
            ad = make_stage_adapter(net)
            from deeplearning4j_tpu_torch.parallel.pipeline import \
                StagePartition
            part = StagePartition.build(ad.entries(), net.params, 2)
            ad.part = part
            ad.finalize()
            check(all(r["boundaries"] == part.boundaries for r in recs),
                  f"{name}: the ranks' partition "
                  f"{recs[0]['boundaries']} vs {part.boundaries}")
            derived = _pp_derived_launches(name, net, part.boundaries)
            print(f"[pp] {name}: partition {part.boundaries} "
                  f"({part.entries[part.boundaries[1] - 1]} | "
                  f"{part.entries[part.boundaries[1]]}), stage bytes "
                  f"{part.stage_param_bytes(net.params)}, handoff "
                  f"{ad.outgoing[0] if hasattr(ad, 'outgoing') else 'h'}; "
                  f"derived launches a rank a step: stage 0 "
                  f"{derived[0]['sites']} sites -> {derived[0]['want']}, "
                  f"stage 1 {derived[1]['sites']} sites -> "
                  f"{derived[1]['want']}")
            # stage 0's outgoing activations a rank: a microbatch's rows
            # of one data index through stage 0
            dp = PP_WORLD // (lay["tp"] * lay["pp"])
            rows = BATCH // PP_MICRO // dp
            from deeplearning4j_tpu_torch.datasets.dataset import DataSet
            inputs, _, _, fm = net._split(DataSet(
                x[:rows], y[:rows],
                features_mask=None if m is None else m[:rows]), None)
            with torch.no_grad():
                acts, _ = net._forward(net.params, net.states, inputs,
                                       training=True, fmask=fm,
                                       topo_slice=(0, part.boundaries[1]))
            out_bytes = sum(acts[n].numel() * acts[n].element_size()
                            for n in ad.outgoing[0])
            # the one-process reference on the card, and float64 on the
            # CPU for step 1
            ref = pp_reference(torch, net, x, y, m, PP_STEPS, PP_MICRO)
            net64 = _pp_f64(torch, name, p0, s0, dims)
            t64 = time.perf_counter()
            m64 = None if m is None else m.astype(np.float64)
            ref64 = pp_reference(torch, net64, x.astype(np.float64),
                                 y.astype(np.float64), m64, 1, PP_MICRO)
            f64_s = time.perf_counter() - t64
            del net64
            # the ranks' parameters at each step (data index 0) and
            # step 1's gradient, the data group's mean
            steps = [_pp_assemble(recs, lambda r, i=i: r["steps"][i]
                                  ["params"], 0) for i in range(PP_STEPS)]
            states1 = {}
            for r in recs:
                if r["coords"].get("data", 0) == 0:
                    states1.update(r["steps"][0]["states"])
            g_by_d = [_pp_assemble(recs, lambda r: r["grads1"], d)
                      for d in range(dp)]
            grads = {k: {n: sum(g[k][n] for g in g_by_d) / dp
                         for n in sub} for k, sub in g_by_d[0].items()}
            losses = recs[0]["steps"]
            losses = [st["loss"] for st in losses]
            # each step's loss against the plain forward over the ranks'
            # parameters at that step
            ref_losses = [ref["losses"][0]]
            chk = type(net)(net.conf)
            for i in range(1, PP_STEPS):
                chk.set_params(steps[i - 1], s0, device)
                ref_losses.append(pp_reference(
                    torch, chk, x, y, m, 1, PP_MICRO,
                    loss_only=True)["losses"][0])
            del chk
            for r, rec in enumerate(recs):
                for i, (got, want) in enumerate(
                        zip([st["loss"] for st in rec["steps"]],
                            ref_losses)):
                    e = abs(got - want) / abs(want)
                    check(e <= LOSS_RTOL, f"{name} rank {r} step {i + 1}: "
                                          f"loss {got!r} vs the plain "
                                          f"forward's {want!r} ({e:.2e})")
            check(losses[-1] < losses[0], f"{name}: the loss did not fall "
                                          f"{losses}")
            # step 1's gradient, leaf by leaf, against float64
            worst_g = (0.0, None)
            for k, sub in ref64["grads1"].items():
                for n, g64 in sub.items():
                    e_pp = _rel_norm_t(grads[k][n], g64)
                    e_ref = _rel_norm_t(ref["grads1"][k][n], g64)
                    check(e_pp <= UPDATE_FACTOR * e_ref + UPDATE_FLOOR,
                          f"{name} step-1 gradient {k}/{n}: {e_pp:.3e} "
                          f"from float64, the one-process run's "
                          f"{e_ref:.3e}")
                    worst_g = max(worst_g, (e_pp, f"{k}/{n}"))
            p1_64 = ref64["params"][0]
            e_upd = _update_err(steps[0], p1_64, p0)
            e_ref_upd = _update_err(ref["params"][0], p1_64, p0)
            check(e_upd <= UPDATE_FACTOR * e_ref_upd + UPDATE_FLOOR,
                  f"{name} step-1 update {e_upd:.3e} from float64, the "
                  f"one-process run's {e_ref_upd:.3e}")
            e_state = max((_rel_norm_t(states1[k][n],
                                       ref["states"][0][k][n])
                           for k in states1 for n in states1[k]),
                          default=0.0)
            check(e_state <= STATE_RTOL, f"{name}: running stats after "
                                         f"step 1 {e_state:.3e}")
            e_final = _update_err(steps[-1], ref["params"][-1], p0)
            # launches, accounting
            launches = [[st["launches"] for st in r["steps"]] for r in recs]
            if on_card:
                zero_k = (("epilogue_backward", "matmul_bias_act",
                           "paged_decode") + FLASH_KERNELS
                          if name == "resnet50" else ())
                for r, rec in enumerate(recs):
                    want = derived[rec["stage"]]["want"]
                    for i, c in enumerate(launches[r]):
                        got = {k: c[k] for k in want}
                        check(got == want, f"{name} rank {r} (stage "
                                           f"{rec['stage']}) step {i + 1}: "
                                           f"launches {got}, derived {want}")
                        check(all(c[k] == 0 for k in zero_k),
                              f"{name} rank {r} step {i + 1}: "
                              f"{ {k: c[k] for k in zero_k} } not 0")
            for r, rec in enumerate(recs):
                for st in rec["steps"]:
                    rp = st["report"]
                    check(rp["peak_residency_microbatches"] == [2, 1],
                          f"{name} rank {r}: peak residency "
                          f"{rp['peak_residency_microbatches']}")
                    check(rp["pipe_wire_fwd_bytes"] == PP_MICRO * out_bytes,
                          f"{name} rank {r}: pipe wire forward "
                          f"{rp['pipe_wire_fwd_bytes']} bytes, "
                          f"{PP_MICRO} x {out_bytes} derived")
                check(rec["axis_bytes"]["model"] == 0,
                      f"{name} rank {r}: exchange bytes across model "
                      f"{rec['axis_bytes']}")
                check(rec["resident_ok"], f"{name} rank {r}: a "
                                          f"tensor-parallel leaf not at "
                                          f"1/tp")
            step_ms = [float(np.median([st["ms"] for st in r["steps"]]))
                       for r in recs]
            ms = max(step_ms)
            rep = recs[0]["steps"][-1]["report"]
            res = {
                "losses": losses, "ref_losses": ref_losses,
                "loss_rel_err": max(abs(a - b) / abs(b) for r in recs
                                    for a, b in zip(
                                        [st["loss"] for st in r["steps"]],
                                        ref_losses)),
                "grad_vs_f64_worst": worst_g, "update_vs_f64": e_upd,
                "one_process_update_vs_f64": e_ref_upd,
                "states_rel": e_state, "params_vs_one_process_final":
                    e_final, "f64_s": f64_s,
                "launches_per_rank_per_step": launches,
                "launches_derived": [d_["want"] for d_ in derived],
                "stage_sites": [d_["sites"] for d_ in derived],
                "median_step_ms_per_rank": step_ms,
                "rows_per_s": BATCH * 1e3 / ms,
                "bubble_seconds": [r["steps"][-1]["report"]["bubble_seconds"]
                                   for r in recs],
                "exchange_seconds": [r["steps"][-1]["report"].get(
                    "exchange_seconds") for r in recs],
                "pipe_wire_fwd_bytes": rep["pipe_wire_fwd_bytes"],
                "pipe_wire_bwd_bytes": rep["pipe_wire_bwd_bytes"],
                "stage_out_bytes": out_bytes,
                "axis_bytes": recs[0]["axis_bytes"],
                "peak_mb_per_rank": [r["peak_mb"] for r in recs],
                "coords": [r["coords"] for r in recs],
                "boundaries": part.boundaries,
                "layout_s_per_rank": [r["layout_s"] for r in recs],
                "check_s": time.perf_counter() - t0}
            out[name] = res
            print(f"[pp] {name} {fit_axes_str(lay)} {lay['exchange']}: "
                  f"losses {losses} vs plain {ref_losses} (worst rel "
                  f"{res['loss_rel_err']:.2e}); step-1 gradient worst "
                  f"{worst_g[1]} {worst_g[0]:.3e} from float64, update "
                  f"{e_upd:.3e} (one process {e_ref_upd:.3e}); running "
                  f"stats {e_state:.3e}; after {PP_STEPS} steps "
                  f"{e_final:.3e} from the one-process run; launches a "
                  f"step per rank {[l_[0] for l_ in launches]}; median ms "
                  f"a step per rank {[round(v, 3) for v in step_ms]} = "
                  f"{res['rows_per_s']:.1f} {lay['rows']}/s; bubble s "
                  f"{[round(v, 4) for v in res['bubble_seconds']]}, pipe "
                  f"exchange s {res['exchange_seconds']}; wire fwd / bwd "
                  f"{res['pipe_wire_fwd_bytes']} / "
                  f"{res['pipe_wire_bwd_bytes']} bytes a rank; peak MB "
                  f"{res['peak_mb_per_rank']}; float64 step "
                  f"{f64_s:.1f}s [{label}]")
            del net, ref, ref64, steps, grads
            if on_card:
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[pp] phase 27 in {out['phase_s']:.1f}s (rank processes "
          f"{t_ranks:.1f}s); median ms a step: ResNet-50 "
          f"{out['resnet50']['median_step_ms_per_rank']} "
          f"({out['resnet50']['rows_per_s']:.1f} images/s), attention "
          f"{out['attention']['median_step_ms_per_rank']} "
          f"({out['attention']['rows_per_s']:.1f} sequences/s) [{label}]")
    return out


def fit_axes_str(lay: dict) -> str:
    from deeplearning4j_tpu_torch.parallel.wrapper import fit_mesh_axes
    return str(fit_mesh_axes(PP_WORLD, lay["tp"], lay["pp"]))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import deeplearning4j_tpu_torch  # noqa: F401  fails outside a checkout
    t_start = time.perf_counter()

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        print(f"[time] {name} {time.perf_counter() - t0:.1f}s")
        return out

    dev = phase_device(torch)
    timed("build", phase_build)
    label = dev["nvidia_smi"]
    kern = timed("kernels", phase_kernels, torch)
    tk = timed("train-kernels", phase_train_kernels, torch)
    fk = timed("flash", phase_flash_kernels, torch)
    pw = timed("pointwise", phase_pointwise, torch)
    sl = timed("slice", phase_slice, torch, label=label)
    sq = timed("squeezenet", phase_squeezenet, torch, label=label)
    timed("kernel-paths", phase_kernel_paths, torch, label)
    st = timed("squeezenet-train", phase_train_squeezenet, torch, label)
    tr = timed("train", phase_train_resnet, torch, label)
    dp = timed("dp-resnet", phase_dp_resnet, torch, label)
    ln = timed("lenet", phase_train_lenet, torch, label)
    timed("weights", phase_weights_across, torch)
    pre = timed("pretrained", phase_pretrained, torch, label)
    cr = timed("charrnn", phase_charrnn, torch, label)
    bs = timed("bert-serve", phase_bert_serve, torch, label)
    bt = timed("bert-train", phase_bert_train, torch, label)
    timed("bert-vs-cpu", bert_card_vs_cpu, torch)
    sdb = timed("sd-bert", phase_sd_bert, torch, label,
                native={"serve": bs, "train": bt})
    timed("sd-bert-vs-cpu", sd_bert_card_vs_cpu, torch)
    pk = timed("paged", phase_paged_kernel, torch)
    gf = timed("generate", phase_generate, torch, label)
    gb = timed("generate-bf16", phase_generate, torch, label,
               kv_dtype="bf16", tokens_f32=gf["tokens"])
    timed("decoder-vs-cpu", decoder_card_vs_cpu, torch)
    ag = timed("attention-graph", phase_attention_graph, torch, label)
    tl = timed("tf-lstm", phase_tf_lstm, torch, label)
    tr50 = timed("tf-resnet", phase_tf_resnet, torch, label)
    fl = timed("fleet", phase_fleet, torch, label, sd=tr50.pop("sd"))
    sdr = timed("sd-rest", phase_sd_rest, torch, label)
    ob = timed("observatory", phase_observatory, torch, label, sdr=sdr)
    # phase 26: the distributed Transformer LM on four gloo ranks
    lm = timed("transformer-lm", phase_transformer_lm, torch, label)
    # phase 27: the pipeline fit path, run by phase 26's rank processes
    pf = timed("pipeline-fit", phase_pipeline_fit, torch, label,
               ranks=lm.pop("pp_ranks"))
    # last: past three quarters of the pool, every capture's graph holds
    # a user object
    pool = timed("ticket-pool", ticket_pool_check, torch)

    from deeplearning4j_tpu_torch.ops import cuda_build
    f32 = kern["timing"]["float32"]
    # each kernel's launches come from the path that carries it
    paths = {"scale_shift_act": ("serving ResNet-50", sl["launches"]),
             "epilogue_backward": ("training LeNet-5, 20 steps",
                                   ln["launches"]),
             "channel_sums": ("training ResNet-50, 10 steps",
                              tr["launches"]),
             "bn_bwd_sums": ("training ResNet-50, 10 steps",
                             tr["launches"]),
             "bn_bwd_dx": ("training ResNet-50, 10 steps", tr["launches"])}
    for name in FLASH_KERNELS:
        paths[name] = ("training BERT-base, 10 steps, f32",
                       bt["launches"])
    paths["matmul_bias_act"] = (
        f"serving SqueezeNet, {sq['forwards']} forwards (17 / forward)",
        sq["launches"])
    paths["paged_decode"] = (
        f"generative serving, GPT-2-small width, {GEN_REQUESTS} requests x "
        f"{GEN_MAX_TOKENS} tokens, f32 pool ({gf['decode_steps']} decode "
        f"steps)", gf["launches"])
    records = []
    for k in cuda_build.KERNELS.values():
        path, launches = paths[k.name]
        extra = {}
        if k.name in FLASH_KERNELS:
            ft = fk["timing"]
            t = ft["float32_t128"][k.name]
            err = fk["max_abs_err"][k.name]
            shapes = (f"the {BERT_LAYERS} attention sites of a batch-{BATCH}"
                      f" t=128 BERT-base step, f32")
            by_dtype = {d: ft[f"{d}_t128"][k.name]["kernel_ms"]
                        for d in FLASH_DTYPES}
            extra = {"bound_ms_by_dtype": {
                d: ft[f"{d}_t128"][k.name]["bound_ms"]
                for d in FLASH_DTYPES},
                "plain_ms_by_dtype": {
                d: ft[f"{d}_t128"][k.name]["plain_ms"]
                for d in FLASH_DTYPES},
                "library_ms_by_dtype": {
                d: ft[f"{d}_t128"][k.name]["library_ms"]
                for d in FLASH_DTYPES}}
            if k.name == "flash_fwd":
                for key in ("kernel_ms", "bound_ms", "library_ms"):
                    extra[f"t512_{key}_by_dtype"] = {
                        d: ft[f"{d}_t512"]["flash_fwd"][key]
                        for d in FLASH_DTYPES}
            else:
                # one library call computes dq, dk and dv together: its
                # time stands in both rows, beside kernels 8 + 9
                extra["library_covers"] = t["library_covers"]
                extra["sdpa_fwd_bwd_ms"] = ft["float32_t128"][
                    "sdpa_fwd_bwd_ms"]
            extra["launches_bf16_training"] = \
                bt["bfloat16"]["launches"][k.name]
            # the attention classifier and RecurrentAttentionLayer
            # (phase 20), and the kernels at their query counts
            extra["launches_attention_graph"] = {
                "classifier_f32_10_steps": ag["f32"]["launches"][k.name],
                "classifier_bf16_10_steps": ag["bf16"]["launches"][k.name],
                "recurrent_attention_forward":
                    ag["recurrent"]["fwd_launches"][k.name],
                "recurrent_attention_step":
                    ag["recurrent"]["step_launches"][k.name],
                "unprojected_head_dim_768_step":
                    ag["unprojected"]["launches"][k.name]}
            for tq in FLASH_TQ:
                for key in ("kernel_ms", "bound_ms", "plain_ms",
                            "library_ms"):
                    extra[f"tq{tq}_tk128_{key}_by_dtype"] = {
                        d: ft[f"{d}_tq{tq}"][k.name][key]
                        for d in FLASH_DTYPES}
            # the wide bodies: 12 unprojected sites of head dim 768
            for key in ("kernel_ms", "bound_ms", "plain_ms", "library_ms"):
                extra[f"d{WIDE_HEAD_DIM}_t128_{key}_by_dtype"] = {
                    d: ft[f"{d}_d{WIDE_HEAD_DIM}"][k.name][key]
                    for d in ("float32", "bfloat16", "float64")}
            # the SameDiff path: the imported BERT-base (BASELINE #4)
            extra["launches_samediff_forward"] = \
                sdb["fwd_launches"][k.name]
            extra["launches_samediff_training_f32"] = \
                sdb["f32"]["launches"][k.name]
            extra["launches_samediff_training_bf16"] = \
                sdb["bf16"]["launches"][k.name]
            # phase 24: SameDiff data-parallel, exported, and as a layer
            extra["launches_samediff_phase24"] = {
                **{f"fit_steps_gloo_{ex}_{SD_DP_STEPS}_steps_per_rank": [
                    r_[k.name] for r_ in sdr["gloo"][ex]["launches"]]
                   for ex in SD_DP_EXCHANGES},
                f"fit_steps_nccl_1_rank_{SD_DP_STEPS}_steps":
                    sdr["nccl"]["launches"][k.name],
                "exported_forward_1_call": sdr["export_launches"][k.name],
                f"samediff_layer_graph_{SD_LAYER_STEPS}_steps":
                    sdr["layer"]["launches"][k.name]}
        elif k.name == "paged_decode":
            pt = pk["timing"]
            t = pt["float32_L512"]
            err = pk["max_abs_err"]
            shapes = (f"the 12 decode-attention sites of a batch-{BATCH} "
                      f"GPT-2-small decode step at L=512, f32 pool")
            by_dtype = {d: pt[f"{d}_L512"]["kernel_ms"]
                        for d in ("float32", "bfloat16")}
            extra = {"bound_ms_by_dtype": {
                d: pt[f"{d}_L512"]["bound_ms"]
                for d in ("float32", "bfloat16")},
                "L1024_ms_by_dtype": {
                    d: pt[f"{d}_L1024"]["kernel_ms"]
                    for d in ("float32", "bfloat16")},
                "L1024_bound_ms_by_dtype": {
                    d: pt[f"{d}_L1024"]["bound_ms"]
                    for d in ("float32", "bfloat16")},
                "general_body_ms_by_dtype_and_L": {
                    k_: v_["general_body_ms"] for k_, v_ in pt.items()},
                "body": t["body"],
                "launches_bf16_pool": gb["launches"]["paged_decode"],
                # phase 23: the decoder on two replicas behind the router
                "launches_fleet": {
                    "routed_and_direct_64_streams":
                        fl["c"]["launches"][k.name],
                    "decode_steps_per_replica": fl["c"]["decode_steps"]}}
        elif k.name == "matmul_bias_act":
            t = pw["timing"]["float32"]
            err = pw["max_abs_err"]
            shapes = (f"the 17 pointwise conv sites of a batch-{BATCH} f32 "
                      f"SqueezeNet forward")
            by_dtype = {d: v["kernel_ms"] for d, v in pw["timing"].items()}
            extra = {"bound_ms_by_dtype": {
                d: v["bound_ms"] for d, v in pw["timing"].items()},
                "library_ms_by_dtype": {
                d: v["library_ms"] for d, v in pw["timing"].items()},
                "plain_ms_by_dtype": {
                d: v["plain_ms"] for d, v in pw["timing"].items()},
                "max_err_over_bar": {
                d: v["ratio"] for d, v in pw["errs"].items()},
                "backward_ms": pw["backward_ms"]}
        elif k.name == "scale_shift_act":
            t = {"kernel_ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
                 "bound_ms": f32["bound_ms"], "library_ms":
                 f32["library_ms"], "eager_ms": f32["kernel_eager_ms"],
                 "bound_by": "bytes"}
            err = kern["max_abs_err"]
            shapes = f"the 53 BatchNormalization sites of a batch-{BATCH} " \
                     f"f32 ResNet-50 forward"
            by_dtype = {d: v["kernel_ms"] for d, v in kern["timing"].items()}
            extra = {"library_ms_by_dtype": {
                d: v["library_ms"] for d, v in kern["timing"].items()},
                "launches_pretrained": pre["launches"],
                # phase 23: ResNet-50 on two replicas behind the router
                "launches_fleet": {
                    "routed_64_predicts": fl["a"]["launches"][k.name],
                    "routed_forwards_per_replica": fl["a"]["forwards"],
                    "rollout_under_load": fl["b"]["launches"][k.name],
                    "rollout_under_load_forwards": fl["b"]["forwards"]}}
        else:
            t = tk["timing"][k.name]["float32"]
            err = tk["max_abs_err"][k.name]
            if k.name in tk["sums_device_kernels"]:
                extra = {"device_kernels_53_sites_bf16":
                         tk["sums_device_kernels"][k.name],
                         "bodies": tk["sums_bodies"][k.name]}
            shapes = f"the 53 BatchNormalization sites of a batch-{BATCH} " \
                     f"f32 ResNet-50 training step"
            by_dtype = {d: v["kernel_ms"]
                        for d, v in tk["timing"][k.name].items()}
        # the launches on this slice's paths: SqueezeNet training (10
        # steps), the ResNet-50 remat step, BERT-base remat (3 steps a
        # mode)
        if k.name in DP_KERNELS:
            extra["launches_dp_resnet"] = {
                "fit_iterator_staged_10_steps":
                    dp["prefetch_1"]["launches"][k.name],
                "parallel_wrapper_workers_1_10_steps":
                    dp["wrapper"]["launches"][k.name],
                "shared_training_gloo_3_steps_per_rank": [
                    r["launches"][k.name] for r in dp["gloo"]],
                "shared_training_nccl_1_rank_10_steps":
                    dp["nccl"]["launches"][k.name],
                **{f"shared_training_gloo_{n}_3_steps_per_rank": [
                    r_[k.name] for r_ in dp["exchanges"][n]["launches"]]
                   for n in ("fsdp",) + DP_SCHEMES}}
        extra["launches_squeezenet_training"] = st["launches"][k.name]
        # phase 25: ResNet-50's observed fit (a), remat under the mesh (e)
        if k.name in DP_KERNELS + ("epilogue_backward",):
            extra[f"launches_observatory_{OBS_STEPS}_steps"] = \
                ob["a"]["launches"][k.name]
        if k.name in FLASH_KERNELS:
            extra[f"launches_samediff_remat_{OBS_REMAT_SEGMENTS}_mesh_"
                  f"{SD_DP_STEPS}_steps_per_rank"] = [
                r_[k.name] for r_ in ob["e"]["launches_remat"]]
        if k.name in FLASH_KERNELS:
            # phase 26: each rank's launches in each of its train steps
            extra[f"launches_transformer_lm_{LM_STEPS}_steps"] = {
                name: [[st[k.name] for st in r_] for r_ in
                       lm[name]["launches_per_rank_per_step"]]
                for name in LM_LAYOUTS}
            extra["ring_step_lse_cotangent_max_abs_err"] = {
                c_: e_["dq" if k.name == "flash_bwd_dq" else
                       "dk" if k.name == "flash_bwd_dkv" else "out"]
                for c_, e_ in lm["ring_step"].items()}
        # phase 27: each rank's launches in each pipeline step
        for name_, pp_ in pf.items():
            if not isinstance(pp_, dict) or "launches_per_rank_per_step" \
                    not in pp_:
                continue
            if k.name in (DP_KERNELS if name_ == "resnet50" else
                          FLASH_KERNELS):
                extra[f"launches_pipeline_{name_}_{PP_STEPS}_steps"] = [
                    [st[k.name] for st in r_]
                    for r_ in pp_["launches_per_rank_per_step"]]
        if k.name in pool:
            extra["ticket_pool_check"] = pool[k.name]
        extra["launches_resnet_remat_step"] = \
            tr["remat"]["remat"]["launches"][k.name]
        if k.name in FLASH_KERNELS:
            extra["launches_bert_remat"] = {
                m: r["launches"][k.name] for m, r in bt["remat"].items()}
        records.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "launches_path": path, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "ms_by_dtype": by_dtype, "shapes": shapes, **extra})
    print(f"[done] ResNet-50 train step {tr['median_step_ms']:.3f} ms "
          f"({tr['img_per_s']:.1f} img/s), LeNet-5 step "
          f"{ln['median_step_ms']:.3f} ms, BERT-base train step "
          f"{bt['median_step_ms']:.3f} ms ({bt['seq_per_s']:.1f} "
          f"sequences/s), bf16 {bt['bfloat16']['median_step_ms']:.3f} ms, "
          f"forward t=128 {bs['f32_t128_ms'][1]:.3f} ms, "
          f"t=512 f32 {bs['f32_t512_ms'][1]:.3f} ms, bf16 "
          f"{bs['bf16_t512_ms'][1]:.3f} ms [{label}]")
    rm = bt["remat"]
    print(f"[done] SqueezeNet training (dropout 0.5 on the card): batch-32 "
          f"f32 step {st['median_step_ms']:.3f} ms ({st['img_per_s']:.1f} "
          f"img/s, idle share "
          f"{st.get('profile', {}).get('idle_share', float('nan')):.3f}, "
          f"{st.get('profile', {}).get('kernel_calls', 0)} device kernels a "
          f"step, peak {st['peak_mb']:.1f} MB), accumulation 2 x 16 vs 1 x "
          f"32 {st['accumulation_rel_err']:.3e}; BERT-base remat step ms / "
          f"peak MB: False {np.median(rm['False']['step_ms'][1:]):.3f} / "
          f"{rm['False']['peak_mb']:.1f}, True "
          f"{np.median(rm['True']['step_ms'][1:]):.3f} / "
          f"{rm['True']['peak_mb']:.1f}, dots "
          f"{np.median(rm['dots']['step_ms'][1:]):.3f} / "
          f"{rm['dots']['peak_mb']:.1f}; ResNet-50 remat_segments=4 peak "
          f"{tr['remat']['remat']['peak_mb']:.1f} MB vs "
          f"{tr['remat']['plain']['peak_mb']:.1f} MB [{label}]")
    ov = dp["prefetch_1"].get("overlap", {})
    print(f"[done] data-parallel ResNet-50 (BASELINE #5 on one card): "
          f"staged fit {dp['prefetch_1']['median_step_ms']:.3f} ms/step "
          f"(unstaged {dp['prefetch_0']['median_step_ms']:.3f}, idle share "
          f"{dp['prefetch_1'].get('profile', {}).get('idle_share', float('nan')):.3f}, "
          f"H2D overlap share {ov.get('h2d_overlap_share', float('nan')):.3f}), "
          f"ParallelWrapper workers=1 "
          f"{dp['wrapper']['median_step_ms']:.3f} ms/step, one-rank NCCL "
          f"{dp['nccl']['median_step_ms']:.3f} ms/step "
          f"({dp['nccl']['img_per_s']:.1f} img/s); 2 gloo ranks: step 1 "
          f"{max(c['update_vs_f64'] for r in dp['gloo'] for c in r['checks'].values()):.3e} "
          f"from float64, updater state {dp['gloo'][0]['state_bytes']} of "
          f"{dp['gloo'][0]['state_bytes_whole_padded']} bytes a rank; "
          f"fsdp == ZeRO-1 bitwise with {dp['exchanges']['fsdp']['param_bytes']}"
          f" parameter bytes a rank; encoded threshold / int8 / 1bit step-3 "
          f"fraction "
          f"{[dp['exchanges'][n]['steps'][-1]['fraction_weighted'] for n in DP_SCHEMES]}"
          f" [{label}]")
    print(f"[done] SqueezeNet serving: batch-32 f32 forward "
          f"{sq['fwd32_f32_ms'][1]:.3f} ms ({sq['img_per_s']:.1f} img/s), "
          f"bf16 {sq['fwd32_bf16_ms']:.3f} ms, {sq['http_img_per_s']:.1f} "
          f"img/s over HTTP [{label}]")
    print(f"[done] GPT-2-small generate: {gf['tokens_per_s']:.1f} tokens/s,"
          f" TTFT p50 {gf['ttft_ms_p50']:.3f} ms, inter-token p50 "
          f"{gf['intertoken_ms_p50']:.3f} ms, decode step (bucket 32) "
          f"{gf['decode_step_ms_p50']:.3f} ms; bf16 pool "
          f"{gb['tokens_per_s']:.1f} tokens/s [{label}]")
    print(f"[done] char-RNN (2 x GravesLSTM(512), batch 64 x 64): f32 step "
          f"{cr['f32']['median_step_ms']:.3f} ms "
          f"({cr['f32']['chars_per_s']:.1f} chars/s, idle share "
          f"{cr['f32']['profile'].get('idle_share', float('nan')):.3f}), "
          f"bf16 {cr['bf16']['median_step_ms']:.3f} ms, fit_steps "
          f"{cr['fit_steps_ms']:.3f} ms a step, greedy sampling "
          f"{cr['sample_chars_per_s']:.1f} chars/s; bundled gates lenet "
          f"{pre['lenet']['accuracy']:.4f}, resnet_cifar "
          f"{pre['resnet_cifar']['accuracy']:.4f} (hard "
          f"{pre['resnet_cifar']['hard']:.4f}), charrnn "
          f"{pre['charrnn']['accuracy']:.5f} [{label}]")
    print(f"[done] SameDiff + TF import, BERT-base (BASELINE #4): GraphDef "
          f"{sdb['graphdef_bytes']} bytes written in {sdb['build_s']:.2f}s, "
          f"imported in {sdb['import_s']:.2f}s; forward "
          f"{sdb['fwd_ms'][1]:.3f} ms, MLM step f32 "
          f"{sdb['f32']['median_step_ms']:.3f} ms "
          f"({sdb['f32']['tokens_per_s']:.1f} tokens/s), bf16 "
          f"{sdb['bf16']['median_step_ms']:.3f} ms [{label}]")
    print(f"[done] masked attention classifier (BERT-base widths, batch "
          f"{BATCH} x {ATTN['t']}): f32 step "
          f"{ag['f32']['median_step_ms']:.3f} ms "
          f"({ag['f32']['seq_per_s']:.1f} sequences/s, idle share "
          f"{ag['f32'].get('profile', {}).get('idle_share', float('nan')):.3f}"
          f", {ag['f32'].get('profile', {}).get('kernel_calls', 0)} device "
          f"kernels a step), bf16 {ag['bf16']['median_step_ms']:.3f} ms; "
          f"flash vs plain route {ag['flash_vs_plain_max_abs']:.3e}; "
          f"RecurrentAttentionLayer step {ag['recurrent']['step_ms']:.3f} "
          f"ms; char-RNN graph tBPTT vs layer stack "
          f"{ag['charrnn_graph']['vs_stack_max_abs']:.3e} [{label}]")
    print(f"[done] TF-imported 2 x LSTM(512) char model (batch 64 x 64, "
          f"while_max_iterations=64): forward {tl['median_fwd_ms']:.3f} "
          f"ms, Adam step {tl['median_step_ms']:.3f} ms "
          f"({tl['chars_per_s']:.1f} chars/s, idle share "
          f"{tl.get('profile', {}).get('idle_share', float('nan')):.3f}, "
          f"{tl.get('profile', {}).get('kernel_calls', 0)} device kernels "
          f"a step, peak {tl['peak_mb']:.1f} MB, {tl['step_rise_mb']:.1f} "
          f"MB over the step's start); vs lstm_layer route "
          f"{tl['fwd_vs_lstm_layer']:.3e}, card vs CPU "
          f"{tl['card_vs_cpu']:.3e} [{label}]")
    print(f"[done] TF-imported Keras ResNet-50 (224x224x3, 1000 classes, "
          f"batch {TF_RESNET['batch']}, TF32 off): forward "
          f"{tr50['median_fwd_ms']:.3f} ms, Adam step "
          f"{tr50['median_step_ms']:.3f} ms ({tr50['img_per_s']:.1f} img/s, "
          f"idle share "
          f"{tr50.get('profile', {}).get('idle_share', float('nan')):.3f}, "
          f"{tr50.get('profile', {}).get('kernel_calls', 0)} device kernels "
          f"a step, peak {tr50['peak_mb']:.1f} MB); logits vs float64 "
          f"{tr50['logits_vs_f64']:.3e}, gradients "
          f"{tr50['grad_vs_f64_max']:.3e}; {len(tr50['sweep']['ops'])} ops "
          f"swept [{label}]")
    fa, fc = fl["a"], fl["c"]
    print(f"[done] serving fleet (2 replicas on one card): single-image "
          f"predict p50 / max ms through the router "
          f"{fa['single_ms']['router']['p50']:.3f} / "
          f"{fa['single_ms']['router']['max']:.3f}, direct "
          f"{fa['single_ms']['direct']['p50']:.3f} / "
          f"{fa['single_ms']['direct']['max']:.3f}; burst of 32 "
          f"{fa['burst32_img_per_s']:.1f} img/s; 32 streams TTFT p50 routed "
          f"{fc['routed']['ttft_ms_p50']:.3f} ms, direct "
          f"{fc['direct']['ttft_ms_p50']:.3f} ms, inter-token p50 routed "
          f"{fc['routed']['intertoken_ms_p50']:.3f} ms, direct "
          f"{fc['direct']['intertoken_ms_p50']:.3f} ms; SameDiff Keras "
          f"ResNet-50 served at 1 / 32 images in {fl['f']['ms_1']:.1f} / "
          f"{fl['f']['ms_32']:.1f} ms; phase {fl['phase_s']:.1f}s [{label}]")
    g24 = sdr["gloo"]
    print(f"[done] SameDiff phase 24 (imported BERT-base, batch {BATCH} x "
          f"128): 2 gloo ranks ms a step dense / fsdp / encoded "
          f"{g24['dense']['median_step_ms']:.1f} / "
          f"{g24['fsdp']['median_step_ms']:.1f} / "
          f"{g24['encoded']['median_step_ms']:.1f}, one-rank NCCL "
          f"{sdr['nccl']['median_step_ms']:.1f}; export "
          f"{sdr['export_s']:.2f}s ({sdr['blob_bytes']} bytes), a call "
          f"{sdr.get('call_ms', float('nan')):.3f} ms vs output "
          f"{sdr.get('output_ms', float('nan')):.3f} ms; SameDiffLayer "
          f"attention step {sdr['layer']['median_step_ms']:.3f} ms; phase "
          f"{sdr['phase_s']:.1f}s [{label}]")
    oa, oc = ob["a"], ob["c"]
    print(f"[done] observatory (phase 25): ResNet-50 fit ms a step observed "
          f"{oa['median_step_ms_on']:.3f} vs plain "
          f"{oa['median_step_ms_off']:.3f}, losses bitwise; layer_report "
          f"conv + dot FLOPs {oc['conv_dot_flops']} (analytic "
          f"{oc['analytic']}); profiled busy {oc['busy_ms']:.3f} ms, "
          f"{oc['scoped_ms']:.3f} in a scope; C5 mesh == one device; "
          f"remat under the mesh bitwise; phase {ob['phase_s']:.1f}s "
          f"[{label}]")
    print(f"[done] distributed Transformer LM (phase 26, GPT-2-small "
          f"widths, {LM_WORLD} gloo ranks on one card): megatron-SP "
          f"median ms a step per rank "
          f"{lm['megatron_sp']['median_step_ms_per_rank']}, ring-CP "
          f"{lm['ring_cp']['median_step_ms_per_rank']}; losses vs the "
          f"plain forward {lm['megatron_sp']['loss_rel_err']:.2e} / "
          f"{lm['ring_cp']['loss_rel_err']:.2e}; phase "
          f"{lm['phase_s']:.1f}s [{label}]")
    print(f"[done] pipeline fit path (phase 27, {PP_WORLD} gloo ranks on "
          f"one card, 1F1B, {PP_MICRO} microbatches of a batch of {BATCH}):"
          f" ResNet-50 dp2 x pp2 median ms a step per rank "
          f"{pf['resnet50']['median_step_ms_per_rank']} "
          f"({pf['resnet50']['rows_per_s']:.1f} images/s), attention "
          f"classifier tp2 x pp2 "
          f"{pf['attention']['median_step_ms_per_rank']} "
          f"({pf['attention']['rows_per_s']:.1f} sequences/s); phase "
          f"{pf['phase_s']:.1f}s [{label}]")
    print(f"[done] matmul precision: "
          f"{torch.get_float32_matmul_precision()}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": records}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
