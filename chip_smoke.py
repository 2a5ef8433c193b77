#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases, all of them on every run, in order; any failure raises and exits
non-zero. Each phase prints its wall seconds on a line of its own as it
ends ("phase N: S s"; the report's ``phase_seconds``), and a line before
the card's names the total and the longest phases. Some earlier paths run
cut to keep the whole run inside its time budget (MOE_SERVE_LAYERS,
FP8_RUNG_LAYERS, MOE_FP8_LAYERS, CURVE_STEPS, PREDICTOR_LAYERS,
PREDICTOR_REQUESTS, COLD_LAYERS, TIMED_ITERS, HAPI_CARD_ROWS); each is
driven as before and its launch checks are computed from the cut depth:
 1. the card: nvidia-smi name and power limit, torch's device name/count;
 2. build every kernel of the port from the sources in the checkout, one
    nvcc (sm_90a) for each source, all started together, and beside them
    the DataLoader's native worker pool (native/dataloader.cpp, g++); print
    the build time and ptxas report;
 3. each kernel against its plain PyTorch twin on the card, at the shapes
    its main path gives it, plus GQA, float32 and other head-dim cases;
    max abs error against the stated tolerance (scaled to each output
    row's size in bfloat16), kernel / plain / library times and the bound;
    for every kernel, which instance ran, failing when a case took another
    than the library's rule gives (kernel 1: tensor-core for bfloat16;
    kernels 2 and 3: tensor-core for bfloat16 at head dim 64 or 128;
    kernels 4-7: split-K for T <= 16, tensor-core for bfloat16 at head dim
    64 or 128 over pages (kernels 4 and 5: S_max) a multiple of 64 rows,
    CUDA-core otherwise):
    paged_decode and paged_decode_int8 (the engine's decode T=1 at ragged
    positions, prefill T=1024, and with 200 real rows; the prefix cache's
    tail prefills, 1024 rows from start 640, 700 and 1000 with the tail
    real, the slot owning only the pages its real rows reach and its trash
    page NaN; T 1-1024 at page-edge positions, GQA 4 and 2, head dims
    64/128/256, f32 q, pages of 512 and 1024 rows, prefills with valid <
    T whose padding rows must come out zero),
    flash_decode and flash_decode_int8
    (generate()'s decode step and prefill; every instance of kernel 4 with
    its bound and library time: split-K at T 1, 2, 16, tensor-core at T
    128, 300, 1000, CUDA-core for f32 at T > 16, S_max 1000 and head dim
    256; kernel 5's other instances),
    flash_fwd (forward() over
    [8, 1024], and with dropout 0.1), flash_bwd_dq and flash_bwd_dkv (the
    train step's backward over [8, 1024], and with dropout 0.1; library:
    PyTorch's own flash backward, for the two together); and the sp ring's
    hops (phase 38's sp2, [8, 512] a hop, 16 heads of 64): kernel 1 on a
    past kv block (dense) and on the diagonal block (causal), kernels 2
    and 3 on both fed the MERGED lse of the two hops and the delta of the
    merged output, as the ring's backward feeds them;
 4. the serving path at full width: the bench GPT (vocab 32768, hidden
    1024, 24 layers, 16 heads, bf16, random weights from a seed) as a
    GPTForCausalLM in GenerationEngine(model, num_slots=8, page_size=128)
    answering 8 greedy requests with ragged prompts, first eager (a
    private switch, for the comparison only), then on its captured CUDA
    graphs (the prefill and the step, two captures at warmup and none from
    traffic); tokens/s, TTFT p50 and mean step of both, and their streams
    equal; every launch counter is set to 0 just before each run and read
    just after: paged_decode must equal 24 x (prefills + steps) under
    replay too, the 24 x prefills on the tensor-core instance and the
    24 x steps on the split-K one; the share of prefill q tiles the kernel
    skipped as padding; a profiled rerun of each;
 5. card against CPU at reduced depth (hidden 1024, 2 layers, float32), the
    engine at its default 1024-row prefill on both: prefill logits agree
    and greedy streams are equal;
 6. dense generate() at full width: the same bench GPT, 8 prompts of 128
    tokens (numpy seed), 128 greedy tokens, with the bf16 cache and with
    the int8 cache, each eager and on captured graphs (the prefill and one
    step replayed per token, captured by a warm-up call); tokens/s,
    prefill ms, mean step ms, a profiled window of decode steps for each;
    launches == 24 x 128 per run (kernels 4 and 5: the 24 prefill launches
    on the tensor-core instance, the 24 x 127 steps on the split-K one),
    captured and eager tokens equal, and the int8 run's prefill logits
    within cosine 0.999 of the bf16 run's;
 7. forward() on [8, 1024] (flash_fwd launches == 24), then generate() on
    8 prompts of 1000 tokens with 32 new, on graphs captured by a warm-up
    call: 25 cached tokens and 7 on the sliding window (flash_decode
    24 x 25, the 24 prefill launches tensor-core and the 24 x 24 steps
    split-K; flash_fwd 24 x 7 launches); every flash_fwd launch of both
    on the tensor-core instance;
 8. card against CPU at 2 layers in float32: greedy generate() streams
    equal on the dense, int8 and window-crossing paths, forward() logits
    within 1e-3;
 9. the engine over the int8 page pool (kv_cache_int8) at full width, the
    requests of phase 4, eager and captured as in phase 4:
    paged_decode_int8 launches == 24 x (prefills + steps), the
    24 x prefills on the tensor-core instance and the 24 x steps on the
    split-K instance; a profiled rerun's device time; int8 prefill logits
    within cosine 0.999 of a bf16 pool's;
10. the int8 engine card against CPU at 2 layers in float32: streams
    equal, or held to phase 8's int8 rule;
11. the single-device train step at full width (the bench rung: [8, 1024],
    bf16 over f32 params, AdamW(2e-4, weight_decay=0.01), remat 'dots',
    xent_chunk 8192, targets = tokens): 2 warm-up and 8 timed steps on one
    batch; tokens/s, step ms, MFU, peak memory, a profiled step; launches
    per step flash_fwd 48 (24 + 24 recomputed under remat), flash_bwd_dq
    24, flash_bwd_dkv 24, every flash_fwd, flash_bwd_dq and flash_bwd_dkv
    launch on the tensor-core instance; the loss finite and falling;
12. the train step card against CPU at 2 layers in float32: the first
    step's gradients and a 3-step loss curve, dropout 0 and 0.1;
13. GenerationEngine(model, precision='int8_wo') at full width with the
    requests of phase 4, on captured graphs, over the bf16 pool and then
    the int8 pool: paged_decode / paged_decode_int8 launches == 24 x
    (prefills + steps), prefills tensor-core and steps split-K; the served
    weights' bytes against the bf16 engine's; the full-width prefill
    logits' cosine against the bf16 engine's (printed, not held: the
    weights are random); the device time of the int8 -> bf16 converts a
    step runs, beside phase 4's step;
14. generate() after enable_int8_decode() at phase 6's shape (B=8, T0=128,
    128 greedy tokens), bf16 then int8 cache, on graphs: launches 24 x 128
    a run split as in phase 6; a second enable_int8_decode() after an
    in-place weight change takes a new snapshot whose tokens are those of
    a fresh model over the new weights; then generate() past the window
    over the int8 weights (flash_decode 24 x 25, flash_fwd 24 x 7);
15. the prefix cache at full width (bf16 pool, page 128, 8 slots, 32 new
    tokens a request, submitted one at a time, numpy seed 0):
    tools/prefix_cache_check.py's workload and gates at this size: 12
    prompts of a 640-token system prefix + a unique 64-255-token suffix,
    cold and warm waves and the cold wave on a cache-off engine (streams
    equal, warm == cold, >= 70% of the warm wave's prompt tokens skipped,
    warm TTFT p99 <= 0.25 x cold's, _trace_count 2 throughout, every warm
    request a full hit); 8 two-turn conversations (turn 2 = turn 1's
    200-500-token prompt + its 32 tokens + 48 new: copy-on-write and a tail
    prefill that starts mid-page; streams equal cache-off's, or split only
    at near-ties); the same prompt under two tenants on disjoint pages; no
    page leaked after drain + clear_prefix_cache(); paged_decode launches
    == 24 x (device prefills + steps), full hits adding none; then the
    waves again over the int8 pool (kernel 7);
16. this slice card against CPU at 2 layers in float32 (block matrices
    x10): the int8_wo engine's and int8 generate()'s greedy streams equal,
    the prefix-cache engine's cold and warm waves equal.
17. the MoE GPT at MoEConfig()'s full width (vocab 50304, hidden 768, 12
    heads, 8 experts, FFN 3072, bf16 over f32 params) cut to 4 of its 12
    layers (random weights from a seed): GenerationEngine((params,
    cfg), num_slots=8, page_size=128) with phase 4's requests, all queued
    before the scheduler starts (a MoE step routes its slots together),
    eager then on its two captured graphs, streams equal, over the bf16
    pool, the int8 pool and with precision='int8_wo': paged_decode /
    paged_decode_int8 launches == 4 x (prefills + steps), prefills
    tensor-core and steps split-K; tokens/s, TTFT p50, mean step, a
    profiled rerun's busy share; then moe_gpt.generate() at B=8, T0=128,
    128 greedy tokens, bf16 and int8 cache, captured and eager:
    flash_decode / flash_decode_int8 launches == 4 x 128 (4 prefill
    launches tensor-core, 4 x 127 steps split-K), tokens equal;
18. the MoE train step at full width: [8, 1024], AdamW(2e-4,
    weight_decay=0.01), remat on, dropout 0, the full-logits loss (50304
    is not a multiple of xent_chunk 8192); 2 warm-up and 6 timed steps:
    flash_fwd 24, flash_bwd_dq 12, flash_bwd_dkv 12 a step, all
    tensor-core; the loss finite and falling; tokens/s, step ms, peak
    memory, MFU over 181.1M active parameters (attention, embeddings, 2
    of 8 experts) and 989 TFLOP/s;
19. MoE card against CPU at 2 layers in f32: engine streams equal at the
    default capacity with prompts that fill the prefill width and with
    ragged prompts at capacity factor 8, generate() streams equal, the
    first train step's gradients and a 3-step loss curve within phase
    12's tolerances, and the gather-form moe_ffn on the card within 1e-5
    of the reference's einsum form on the card at [8, 1024] rows;
20. the eager Paddle API (``import paddle_tpu_torch as paddle``) on the
    card, no kernel of the seven on its path: (a) every case of
    tests/torch_op_cases.py (the table the CPU tests hold against the JAX
    package) card against CPU, integer and bool outputs equal, f32 within
    1e-5 / 1e-6 elementwise and 1e-4 for reductions, matmul and linalg,
    the random ops' dtype, range and moments on the card and equal streams
    under one seed; (b) bench.py _child_eager's chain, 64x64 f32 x 300,
    eager_ops_per_sec through the port and the same torch ops raw (the gap
    is the wrapper's cost per op); (c) an eager SGD loop at the bench
    GPT's MLP widths (x [8192, 1024], W1 [1024, 4096], W2 [4096, 1024],
    loss.backward(), set_value under no_grad, clear_grad), 2 warm-up and
    10 timed steps: step ms, busy share, peak memory, the loss falling;
    at hidden 64 two steps card against CPU within 1e-4; (d) a
    gradient-penalty step (paddle.grad(create_graph=True)) card against
    CPU within 1e-5;
21. fp8_matmul on the card (torch._scaled_mm on the fp8 tensor cores:
    forward e4m3 x e4m3, dx e5m2 x e4m3, dw e4m3 x e5m2) against its twin
    (the reference's quantize-dequantize product) at the bench GPT's four
    block products over [8192, 1024] rows in bf16 from a warm meta: out,
    dx and dw per row within 2^-6, the new scales and histories equal;
    times of the product alone, a bf16 torch.matmul of the same shape, the
    forward's quantize ops, the fp8 forward and the twin's, with TFLOP/s
    and the bound (flops / 1,979 TFLOP/s or bytes / 3.35 TB/s);
22. bench.py _child_fp8_train with the bench GPT (bf16, flash, remat
    'dots', xent_chunk 8192) cut to 8 of its 24 layers, [8, 1024],
    AdamW(1e-4), matmul_precision 'none' then 'fp8', 2 warm-up and 8 timed
    steps each:
    base_tokens_per_sec, fp8_tokens_per_sec, fp8_speedup; step ms, peak
    memory, a profiled window's busy share and device ms by kind (fp8
    GEMMs, bf16 GEMMs, attention, the rest), host syncs a step (the fp8
    step no more than the plain one); flash_fwd 16, flash_bwd_dq 8,
    flash_bwd_dkv 8 a step, all tensor-core; 12 x 8 fp8 products a step
    launch a kernel (4 matmuls x forward, dx, dw; the profiler's
    aten::_scaled_mm calls) and 16 x 8 are requested (fp8.scaled_mm_calls:
    the 'dots' recompute's forward products, answered by its cache);
    losses finite and falling;
23. phase 18's MoE train step with matmul_precision='fp8', cut to 4 of its
    12 layers: flash_fwd 8, flash_bwd_dq 4, flash_bwd_dkv 4 a step, 8 x 4
    fp8 products a step (qkv and proj: forward, the whole-block
    recompute, dx, dw), the loss falling; tokens/s, step ms;
24. fp8 training card against CPU at 2 layers in f32 (GPT as phase 12,
    MoE as phase 19) from a warm fp8 state (warmed on the card, given to
    both devices): each fp8 product of the first
    step run again from its recorded inputs on the card and by the CPU
    twin, out, dx, dw and the step's gradient of that weight within 5e-3
    of the largest value, the product's and the step's new scales and
    histories equal to the twin's; end to end the first loss within 1e-3
    (relative), the new w scales 1e-5, each gradient's cosine >= 0.9 and
    norm ratio <= 1.25, each of 3 steps' losses against the CPU's at the
    card's parameters and state within 1e-3 (MoE 2e-3); the fp8 and
    full-width curves of tests/test_precision.py's _gpt_curve setup on the
    card within 5e-3 (at hidden 1024 the gap printed); auto_cast(dtype=
    'float8') over paddle.matmul card against CPU, GradScaler.check_fp8 a
    CUDA bool with no sync (sync debug mode 'error');
25. an ERNIE-base masked-LM program written in paddle.nn
    (tests/torch_nn_cases.py: ErnieConfig's widths, vocab 30522, hidden
    768, 12 layers of 12 heads, FFN 3072, 132M parameters, random weights
    from paddle.seed(0)) trained on one [8, 512] batch (lengths 256-512,
    a bool key-padding mask, 15% of real positions masked) with
    loss.backward(); opt.step(); opt.clear_grad(); sched.step() under
    auto_cast(bfloat16), AdamW over LinearWarmup(PolynomialDecay(1e-4)),
    weight decay 0.01, ClipGradByGlobalNorm(1.0), dropout 0.1: 2 warm-up
    and 8 timed steps, each launching flash_fwd, flash_bwd_dq and
    flash_bwd_dkv 12 times (scaled_dot_product_attention's kernel route,
    with attention dropout), all tensor-core; step ms, tokens/s, MFU (6 x
    parameters x tokens over 989 TFLOP/s), peak memory, a profiled step's
    busy share, the loss falling;
26. the same program at 2 layers in f32 (dropout 0, [2, 128]) card
    against CPU from the same weights: the first loss, every gradient and
    the parameters after two opt.step()s within 1e-4; then every case of
    tests/torch_nn_cases.py (the table the CPU tests hold against the JAX
    package) card against CPU: outputs within 2e-5, gradients 1e-4;
27. phase 25's program as hapi's paddle.Model(net), prepare(the same
    AdamW, schedule and clip; the masked-LM cross entropy on float32
    logits), fed by paddle.io.DataLoader over a map dataset of 32 rows
    [., 512] (batch 8, shuffle, num_workers=2: the native pool;
    prefetch_to_device), fit 2 epochs (8 steps) under auto_cast(bfloat16)
    with save_dir in a temp dir and log_freq 4; evaluate and predict on 8
    rows; <save_dir>/final read into a fresh Model whose predict logits
    equal the first's bit for bit: each train step launches flash_fwd,
    flash_bwd_dq, flash_bwd_dkv 12 times, all tensor-core, each eval or
    predict batch flash_fwd 12 times and no backward, a non-logging step
    makes no host sync; step ms against phase 25's, the data wait, the
    checkpoint's bytes, save and load ms;
28. that Model at 2 layers in f32 ([2, 128]) card against CPU from the
    same weights: 2 shuffled fit steps' losses and parameters within 1e-4
    (mlm_agreement), .pdparams / .pdopt written on either device loading on
    the other bit-exact, evaluate's Accuracy equal;
29. ResNet-50 (vision.models.resnet50(num_classes=1000), 25.6M
    parameters) through hapi as examples/train_resnet.py trains it:
    paddle.Model(net).prepare(AdamW(1e-3) with ClipGradByGlobalNorm(1.0),
    CrossEntropyLoss, Accuracy), fit under auto_cast(bfloat16) over a
    TensorDataset of 256 rows [3, 224, 224] (numpy seed 0), batch 64, 2
    epochs (8 steps), num_workers=0: ms a step between step ends,
    images/s, MFU (3 x the forward FLOPs of each conv's and the fc's
    output shapes x images/s over 989 TFLOP/s), peak memory, a profiled
    step's busy share, launches and device ms by kind (convs, BatchNorm,
    GEMMs, the rest, the optimizer), host syncs (none in train_batch; the
    loop reads Accuracy's count every step, as the reference's fit does,
    and the loss at log points), every BatchNorm's running statistics
    moved, no kernel of the seven launched; evaluate and predict on 64
    held rows,
    Model.save / Model.load into a fresh Model with equal predict logits;
    resnet18's predict ms at batch 1 and 32;
30. float32 with torch's default TF32 flags (cuDNN's allow_tf32 on):
    every case of tests/torch_nn_cases.py's J3_CASES (conv, pooling, the
    functional extensions, RNNs, dynamic_decode, quantization) card
    against CPU, outputs within 2e-5 and gradients 1e-4 (bfloat16 cases
    at their own tolerance); LeNet, resnet18 and mobilenet_v2(scale=0.5)
    through 3 hapi fit steps from the same weights, losses, parameters
    (beyond Adam's epsilon gaps) and the first step's running statistics
    within 2e-5;
    a resnet18 .pdparams written on either device loading on the other
    bit-exact;
31. ERNIE-base served (models.ernie.ErnieModel(ErnieConfig()): vocab
    30522, hidden 768, 12 layers of 12 heads, FFN 3072, bf16 over f32,
    110.1M parameters, random weights from paddle.seed(0)):
    InferenceEngine(max_batch_size=64, max_delay_ms=2.0) warmed with
    'all_buckets' over [((128,), 'int64')] x 3 (7 captures), then 160
    requests of 1-17 rows shaped as tools/serve_bench.py shapes them (ids
    in [5, 30522), real lengths 32-128, the mask 1 up to them, id 0 after;
    numpy seed 0) submitted from one thread and awaited: 0 captures and
    12 kernel-1 launches a batch, all tensor-core; requests/s, rows/s,
    latency p50/p99, queue wait, rows a batch, the padded share, the
    traffic's busy share (profiled), peak memory, one bucket-64 forward's
    device ms by kind (GEMMs, kernel 1, casts, the readback, the rest);
    outputs against the Layer's within 2^-6 a row; the Predictor over
    jit.save's weights with attach_layer, one request at a time
    (requests/s); the layer-free Predictor over the .pt2 program of ERNIE
    at full width and 2 layers (jit.save timed) at batch 1 and 16 (within
    2^-6 a row of its Layer, 2 kernel-1 launches a call) and its p50 at
    batch 1; bench.py's _child_predictor (resnet18
    layer-free p50, a chain's device ms at batch 1, 8, 32) and
    _child_serve_int8wo (f32 against int8_wo p50, captures within the
    ladder); tools/warmup_check.py's cold start over ERNIE at
    max_batch_size 8 in two fresh processes (this script with
    --warmup-child): times to first response, the prebuild report, 0
    captures during the warm process's traffic; each part's seconds
    printed. Cut for the time budget: the attach_layer Predictor serves
    the first PREDICTOR_REQUESTS (40) of the 160 requests, and the
    cold-start processes serve ERNIE at full width and COLD_LAYERS (2) of
    its 12 layers, the warm process started beside the cold one (it
    imports, then waits for the manifest before it touches the card);
32. ERNIE-base pretrained: pretrain_loss at [8, 512] (real lengths
    256-512, ~15% of the real positions as MLM labels, NSP labels), remat,
    dropout 0.1 through kernel 1's dropout, AdamW(1e-4, weight_decay
    0.01), 10 steps (2 untimed): kernel 1 24 launches a step (remat reruns
    it), kernels 2 and 3 12, all tensor-core; step ms, tokens/s, MFU (6 x
    110.1M, embeddings included, x tokens/s over 989 TFLOP/s), peak
    memory, busy share, device ms by kind; the losses finite and the last
    3's mean below the first;
33. ERNIE at 2 layers in f32 (hidden 256, 4 heads of 64, vocab 1024), card
    against CPU: the engine's outputs per request against each device's
    Layer and across the devices; the layer-free Predictor, its .pt2 and
    .pdparams saved on either device and run on both; pretrain_loss and
    its gradients (dropout 0 and 0.1) and one TranslatedLayer fine-tuning
    step against the same step on the Layer, within 2e-5 a row;
34. the telemetry plane, over phase 31's model and requests (built once):
    a span's host cost outside and inside a torch.profiler capture;
    InferenceEngine(max_batch_size=64, max_delay_ms=2.0,
    telemetry_port=0): /healthz 200 at once, /readyz 503 before warmup and
    200 after; perf.flops{fn=serving.bucket64}, counted on the bucket's
    warm-up run, within 20% of the analytic count; the traffic without
    and with a scraper GETting /metrics every 100 ms (each scrape parsed
    by the port's promparse, the serve_* series present, the request
    counter never falling), requests/s of both printed; /debug/trace?ms=50
    inside traffic holds serve.batch spans; /debug/requests?id= an ok
    timeline; /debug/slo a p99 rule on serve.queue_wait_ms;
    /debug/profile?ms=300 during traffic: categories plus idle within 5%
    of the window, matmul time above 0, every port kernel in the capture
    classified as known, perf.mfu_measured finite, the busy share beside
    phase 31's, perf.mfu{fn=serving.bucket64} in (0, 1]; kernel 1 12
    launches a batch, all tensor-core; then Model.fit(telemetry_port=0) of
    an MLP, 20 steps with one paddle.save in a callback: /debug/goodput's
    ratio in (0, 1], checkpoint badput >= 80% of ckpt.save_ms,
    perf.hbm_used_bytes{device=cuda:0} equal to torch.cuda.memory_stats'
    allocated bytes at the sweep, the StepTimer's phases within the wall
    time;
35. the control planes at phase 4's bench GPT (8 slots, page 128,
    prefill width 1024; the params built once, shared by every factory
    call): 16 greedy requests of phase 4's prompts() (seed 0) with 32 new
    tokens each, first through a single engine; (a) ReplicaSet(initial=2)
    behind a FleetRouter, each replica warmed: every stream equal to the
    single engine's, both replicas served, no capture from traffic;
    requests/s, latency p50/p99, requests a replica; (b) the same
    requests with fleet.failover armed once while the streams decode: 0
    lost, 0 duplicate token indices, exactly 1 replica killed, streams
    equal to (a)'s, the failover p99 over (a)'s (tools/fleet_drill.py's
    limit 5, printed); (c) one replica with an Autoscaler (queue-wait p99
    above 50 ms, debounce 1) under a 12-request burst: a second replica
    spawns, warm (2 captures) before it is routable, its first request
    adds no capture and builds no kernel (ops/_build's load count),
    fleet.scale_up_ms; then a third engine warms up (its eager runs on
    the capture stream) while the two replicas decode the 16 requests:
    the replicas step during that warm-up, every stream equals the
    single engine's, and so does the third engine's first; (d) ModelHost:
    the footprints of a bench-GPT engine and of ERNIE-base's (phase 31's
    model, one captured bucket of 64) read from the engines by a host at
    its default watermark, each at least the allocator's growth across
    its deploy on the otherwise idle card, then a host whose
    watermark fits any two of two bench GPTs and ERNIE: deploying the
    third evicts the LRU, ERNIE answers a 64-row batch (12 kernel-1
    launches, tensor-core, within 2^-6 a row of the Layer), a submit to
    the evicted model swaps it in with its earlier output, 0 captures
    past the swap-in and no kernel build, the allocator's bytes over the
    baseline at or under the watermark after every step, an explicit
    eviction freeing at least the pool's bytes; swap-in ms, bytes freed;
    (e) FleetObs over (a)-(b)'s router and the host, served on port 0:
    each federated counter equal to its replicas' sum, /debug/fleet
    listing the replicas and the hosted models, /debug/requests?id= of a
    request moved in (b) stitched over two attempts. Launch counters are
    zeroed before each of (a)-(d) and read after: kernel 6 launches ==
    24 x (the engines' prefills + steps) + 24 x 6 for each warm-up
    (2 eager runs and a replay for each of the two captures), kernel 1
    in (d) 12 x (the batch + 3 for the bucket's warm-up);
36. detection and OCR at full width (the reference classes' defaults,
    random weights from paddle.seed(0), each part's seconds printed): (a)
    PPYOLOE() (80 classes, width 32, reg_max 16, 8,400 anchors) at [8, 3,
    640, 640] f32 with TF32 off, 5 Adam steps of net.loss(net(x), ...) on
    synthetic boxes (up to 16 an image, examples/train_detection.py's),
    the loss finite: step ms, images/s, peak memory, a profiled step's
    device ms by kind (convs, BatchNorm, the TAL assign, the rest); (b)
    the served detector (decode, the best score, nms_static(iou 0.5,
    max_out 100, unroll=True)) through jit.save at [1, 3, 640, 640]:
    the export's seconds (under 30), exactly one nms_static node in the
    program, the layer-free Predictor's keep and valid equal to the
    Layer's and its boxes and scores within 2e-5, its p50 at batch 1;
    nms_static launches 1 for the Layer and 1 a Predictor run; (c) the
    NMS kernel (csrc/nms.cu) against its twin exactly, at the served
    decode's 8,400 boxes, a dense-overlap case and with category_idxs:
    the kernel's device ms, the operator's, the twin's and the bound; (d)
    SVTRLite() and CRNN() at [64, 1, 32, 320] (80 time steps), 5 Adam
    steps of nn.CTCLoss on glyph strips (examples/train_ocr.py's), the
    loss finite and falling, step ms, peak memory, an eval forward at
    batch 1 and 64;
37. this slice card against CPU in float32 (TF32 off): PPYOLOE(
    num_classes=4, width=8, reg_max=8) at [2, 3, 64, 64] with its decode,
    SVTRLite(num_classes=12, dim=32, num_heads=2) and CRNN(num_classes=
    11) at [2, 1, 32, 64] with nn.CTCLoss from the same weights: eval
    outputs, the train-mode loss and every gradient within 2e-5 of the
    part's largest value beyond 4 x the card's own move under a 1e-7
    nudge of the input; the vision-op table of tests/torch_vision_cases.py
    and the detection losses within 2e-5; nms_static and nms over its NMS
    cases (ties, categories, max_out below and above the count, dense
    overlap, 2,100 boxes) exactly equal;
38. the hybrid-parallel train step (models/gpt.py's mesh path) with 2
    ranks on the one card: the bench GPT's width (vocab 32768, hidden
    1024, 16 heads, S 1024, global batch 8, bf16 over f32 params, flash,
    remat 'dots', AdamW(2e-4, weight_decay=0.01)) at 4 layers, first one
    rank (make_train_step(cfg, opt), no mesh: the yardstick), then 2 ranks
    spawned by paddle.distributed.spawn (backend 'gloo': NCCL refuses two
    ranks of one communicator on one device; gloo carries all-reduce and
    broadcast on CUDA tensors, and the port stages its point-to-point ops
    and gathers through pinned host buffers), each layout 2 steps: dp2,
    dp2 with grad_quant='int8', mp2, sp2 (ring flash attention, S_local
    512), pp2 GPipe and pp2 1F1B (4 microbatches, 2 layers a stage). Per
    layout and rank: the step ms, the bytes and calls staged a step, the
    launches of kernels 1-3 a step held exactly to mesh_launches_want (a
    dp or mp rank 8 / 4 / 4; sp2's rank 0 8 / 4 / 4 and rank 1 16 / 8 / 8,
    its one and two hops a layer; a pp2 stage 16 / 8 / 8) and all
    tensor-core; step 1's loss within MESH_BF16_TOL (2^-8, relative) of
    the single rank's; then the same layouts in f32 at 2 layers (one a
    stage), AdamW epsilon 1e-6: step 1's loss and the gathered parameters
    after 2 steps within 1e-4 of the single rank's (int8: its step-2 loss
    within 5e-3 of the full-width one, the reference's bound);
39. the MoE GPT's mesh step (models/moe_gpt.py's, step K2) with 2 ranks
    on the one card over gloo: MoEConfig()'s width (vocab 50304, hidden
    768, 12 heads of 64, 8 experts of FFN 3072, top-2, capacity 1.25) at 2
    layers, [8, 1024], bf16 over f32, remat, AdamW(2e-4, 0.01); one rank,
    then dp2 (routing global over the ranks), ep2 (4 experts a rank) and
    mp2 (heads and each expert's FFN width), 2 steps each: kernels 1-3 a
    step 4 / 2 / 2 on every rank, all tensor-core, step 1's loss within
    1e-3 (relative) of one rank's; in f32 the parameters after 2 steps
    within 1e-5 (dp2, ep2) or 1e-4 (mp2) of one rank's; then GPT fp8
    (matmul_precision='fp8') at phase 38's depth-4 config over dp2 and
    mp2: kernels 1-3 8 / 4 / 4 a step, every step's fp8 scales and amax
    histories equal on both ranks, step 1's first qkv product's x and w
    state within 2^-5 of one rank's (every other gap printed: see
    FP8_MESH_TOL). Per
    layout and rank: step ms, the bytes and calls staged a step;
40. mesh-sharded serving (step K3) on a virtual mesh: 2 shards on the one
    card, driven by one process (mesh=MeshContext.build(2, devices=
    ['cuda:0'] * 2)): GenerationEngine at 2 layers in f32 (phase 5's config
    and prompts) with greedy streams equal to the mp=1 engine's and 2
    captures; the bench GPT at full width, 8 requests of phase 4's prompts,
    bf16 pool then int8 pool: first each prompt's prefill and one step over
    the 8 slots through the mp=2 engine's forward and the mp=1 engine's on
    the same inputs, logits within 2^-5 of max |logits| (MESH_SERVE_TOL);
    then 32 tokens a request on captured graphs: kernels 6 / 7 launched
    exactly 24 layers x 2 shards x (prefills + steps), tokens/s, TTFT p50
    and step ms beside phases 4 and 9's mp=1 numbers;
    sharded_inference_engine(mp=2) of an MLP equal to the mp=1 engine's
    outputs; ModelHost.deploy(mp=2) of a 2-layer GPT admitted and
    serving, its footprint the bytes on its device.
Phase 3 also holds every kernel at the MoE paths' shapes (12 heads of 64),
at the shard shapes of phases 39 and 40 (kernels 1-3 at 6 and 8 heads
for mp2 and at B=4 for dp2; kernels 6 and 7 over both pools at 8 heads,
the mp2 shard of the bench GPT, and 6, of the MoE GPT),
kernels 1-3 at phase 25's (B=8, S=512, 12 heads of 64, its key-padding
mask, dropout 0 and 0.1), and kernel 1 at phase 31's serving shapes (B 64
and 1, S 128, 12 heads of 64, key lengths 32-128). Every launch counter is
set to 0 just before each main-path run (phases 4, 6, 7, 9, 11, 13, 14,
15, 17, 18, 22, 23, 31, 32, 34, 35; in 25, 27, 29 and 32 before each step,
in 38 and 39 before each step on each rank, in 40 before each engine's
traffic,
in 27 also before evaluate and each predict, in 31 before the engine's
traffic, the Predictor's and each layer-free call, in 33 before the
TranslatedLayer step, in 34 before the engine's traffic and before the
profiled traffic, in 35 before each of (a)-(d), in 36 before the served
Layer's call and the Predictor's runs) and read just after. Then one line of kernel records
(JSON), and the last line ``{"ok": true, "device": {...}}``.

Without a CUDA card, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # f32 outside the tensor cores
# kernel vs twin: the largest |got - want| of each output row (b, t, h) over
# that row's max |want|. The kernel repeats the twin's arithmetic and only
# sums in another order, so a bfloat16 output may land one rounding step
# away; 2**-6 is two bfloat16 ulps at the row's largest value. Rows that
# see hundreds of keys read ~0.05 while pos-0 rows read ~3, so one flat
# absolute limit would be loose for the first and tight for the second.
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-5}
TIMED_ITERS = 40                   # launches per kernel timing (cut from
                                   # 240, then 60, for the time budget)
LAYERS = 24                        # timing rotates over one pool per layer,
                                   # as the engine does (each call finds its
                                   # pages cold in L2)


# Cuts that keep the whole run inside its time budget (<= 700 s on one
# H100): every path is still driven and every kernel held against
# its twin, at a smaller depth or with fewer steps; each launch check is
# computed from the cut depth.
MOE_SERVE_LAYERS = 4       # phase 17's MoE serving (MoEConfig(): 12)
FP8_RUNG_LAYERS = 8        # phase 22's fp8 rung (the bench GPT: 24)
MOE_FP8_LAYERS = 4         # phase 23's MoE fp8 train step (12)
CURVE_STEPS = 3            # phases 12, 19, 24: card-vs-CPU loss curves (6)
PREDICTOR_LAYERS = 2       # phase 31's layer-free Predictor program (12)

SOURCES = ('paged_decode', 'flash_decode', 'flash_fwd', 'flash_bwd', 'nms')
SOURCE_OF = {   # kernel -> its source; kernels sharing a template share one
    'paged_decode': 'paddle_tpu_torch/csrc/paged_decode.cu',
    'paged_decode_int8': 'paddle_tpu_torch/csrc/paged_decode.cu',
    'flash_decode': 'paddle_tpu_torch/csrc/flash_decode.cu',
    'flash_decode_int8': 'paddle_tpu_torch/csrc/flash_decode.cu',
    'flash_fwd': 'paddle_tpu_torch/csrc/flash_fwd.cu',
    'flash_bwd_dq': 'paddle_tpu_torch/csrc/flash_bwd.cu',
    'flash_bwd_dkv': 'paddle_tpu_torch/csrc/flash_bwd.cu',
    'nms_static': 'paddle_tpu_torch/csrc/nms.cu',
}
REPLACES = {    # the TPU kernel each one ports
    'paged_decode': 'paddle_tpu/ops/paged_attention.py:70',
    'paged_decode_int8': 'paddle_tpu/ops/paged_attention.py:119',
    'flash_decode': 'paddle_tpu/ops/flash_attention.py:825',
    'flash_decode_int8': 'paddle_tpu/ops/flash_attention.py:861',
    'flash_fwd': 'paddle_tpu/ops/flash_attention.py:236',
    'flash_bwd_dq': 'paddle_tpu/ops/flash_attention.py:427',
    'flash_bwd_dkv': 'paddle_tpu/ops/flash_attention.py:479',
    'nms_static': 'paddle_tpu/vision/ops.py:22 nms_static (XLA fori_loop; '
                  'not a Pallas kernel)',
}


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn(i) over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# profiler sessions device_ms runs before it gives up on one that records
# no device time
PROFILE_ATTEMPTS = 3


def device_ms(fn, iters, warmup=3):
    """Mean device time of fn(i) over ``iters`` calls: the summed duration
    of every kernel and copy the calls put on the card, from
    torch.profiler's CUDA activity. Unlike CUDA events around back-to-back
    calls it leaves out the gaps while the host prepares the next launch,
    which for a kernel of tens of microseconds can take longer than the
    kernel itself. A profiler session that records no device activity at
    all (CUPTI drops one now and then) is run again, up to
    ``PROFILE_ATTEMPTS`` sessions."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in p.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
        print('  (a profiler session saw no device time; profiling again)',
              flush=True)
    raise AssertionError('the profiler saw no device time in '
                         f'{PROFILE_ATTEMPTS} sessions')


# ---------------------------------------------------------------------------
# phase 3: paged-decode kernel against its twin
# ---------------------------------------------------------------------------

def make_case(b, t, h, h_kv, d, pos, dtype, ps=128, p_max=8, seed=0,
              int8=False, layers=LAYERS, valid=None, tail=False):
    """q, ``layers`` page pools (int8 banks with ``int8``), a table of
    scattered pages, ``pos`` and ``valid`` (real rows per slot, or None),
    on the card. Entries past a slot's needed pages stay 0 (the trash
    page), as the engine leaves them. ``tail``: a prefix-cache tail
    prefill, whose slot owns only the pages its real rows reach (pos +
    valid), while its padding rows run further; the trash page then holds
    NaN (int8: NaN scales) in every layer, so a real row that read it
    would come out NaN."""
    from paddle_tpu_torch.ops.weight_only import quantize_kv
    g = torch.Generator(device='cuda').manual_seed(seed)
    n = b * p_max + 1
    q = torch.randn((b, t, h, d), generator=g, device='cuda').to(dtype)

    def pool():
        x = torch.randn((layers, n, ps, h_kv, d), generator=g, device='cuda')
        if int8:
            bank = dict(zip(('int8', 'scale'), quantize_kv(x)))
            if tail:
                bank['scale'][:, 0] = float('nan')
            return bank
        if tail:
            x[:, 0] = float('nan')
        return x.to(dtype)

    kp, vp = pool(), pool()
    perm = np.random.RandomState(seed).permutation(np.arange(1, n))
    table = np.zeros((b, p_max), np.int32)
    for i, p0 in enumerate(pos):
        need = min(-(-(p0 + (valid[i] if tail else t)) // ps), p_max)
        table[i, :need] = perm[i * p_max:i * p_max + need]
    return dict(q=q, k=kp, v=vp, int8=int8,
                table=torch.from_numpy(table).cuda(),
                pos=torch.tensor(pos, dtype=torch.int32, device='cuda'),
                valid=(None if valid is None else torch.tensor(
                    valid, dtype=torch.int32, device='cuda')),
                ps=ps, p_max=p_max)


def bound(c):
    """Least time for the call: each input byte read once (the KV rows the
    slots' real rows can see, int8: a byte a value and an f32 scale a row,
    the real q rows, table, pos, valid), the output written once, and 4*D
    flops per (real row, visible key, head); the larger of bytes / HBM rate
    and operations / peak rate for the dtype."""
    q = c['q']
    b, t, h, d = q.shape
    kv = c['k']['int8'] if c['int8'] else c['k']
    h_kv = kv.shape[3]
    es = q.element_size()
    row = d * kv.element_size() + (4 if c['int8'] else 0)
    cap = c['p_max'] * c['ps']
    real = (c['valid'].tolist() if c['valid'] is not None else [t] * b)
    real = [min(max(n, 0), t) for n in real]
    keys = [min(p0 + n, cap) for p0, n in zip(c['pos'].tolist(), real)]
    kv_bytes = 2 * sum(keys) * h_kv * row
    nbytes = (kv_bytes + (sum(real) + b * t) * h * d * es
              + c['table'].numel() * 4 + b * 4 * (1 + (c['valid'] is not None)))
    ops = 0
    for p0, n in zip(c['pos'].tolist(), real):
        vis = sum(min(p0 + j + 1, cap) for j in range(n))
        ops += 4 * d * h * vis
    return bound_of(nbytes, ops, q.dtype)


def bound_of(nbytes, ops, dtype):
    """(ms, 'bytes' or 'operations', bytes, ops): the larger of bytes / HBM
    rate and operations / peak rate for the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops
            else 'operations', nbytes, ops)


def sdpa_ms(c, iters):
    """Yardstick only (never called by the port): one
    F.scaled_dot_product_attention over the cache gathered through the
    table (the gather, and for int8 the dequantization, done beforehand
    and not timed)."""
    from paddle_tpu_torch.ops.paged_kv import gather_virtual
    from paddle_tpu_torch.ops.weight_only import dequantize_kv, kv_layer
    import torch.nn.functional as F
    q = c['q']
    b, t, h, d = q.shape
    rot = 8

    def dense(bank):
        g = gather_virtual(bank, c['table'])               # [B,S,Hkv,D]
        return (dequantize_kv(g['int8'], g['scale'], q.dtype)
                if c['int8'] else g)

    ks, vs = [], []
    for layer in range(rot):
        kg = dense(kv_layer(c['k'], layer))
        vg = dense(kv_layer(c['v'], layer))
        ks.append(kg.permute(0, 2, 1, 3).contiguous())
        vs.append(vg.permute(0, 2, 1, 3).contiguous())
    s = ks[0].shape[2]
    if c['valid'] is not None:          # the real rows only (one slot)
        n = int(c['valid'][0])
        q, t = q[:, :n], n
    qpos = c['pos'].long()[:, None, None] + torch.arange(
        t, device='cuda')[None, :, None]
    mask = (torch.arange(s, device='cuda')[None, None, :] <= qpos)[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    return device_ms(lambda i: F.scaled_dot_product_attention(
        qt, ks[i % rot], vs[i % rot], attn_mask=mask), iters)


def kernel_err(got, want, floor=0.0):
    """(max |got - want|, max over output rows of that row's largest
    |got - want| / its largest |want|). ``floor``: each row's scale is at
    least that share of the tensor's largest |want| (gradients: a row can
    be pure cancellation, rounding noise on both sides)."""
    w = want.float()
    d = (got.float() - w).abs().amax(-1)
    scale = w.abs().amax(-1).clamp_min(floor * w.abs().max().item() + 1e-30)
    return d.max().item(), (d / scale).max().item()


GRAD_FLOOR = 0.01   # gradients: rows scaled by at least 1% of the tensor


# instance counters a kernel wrapper may carry beside ``launches``
INSTANCE_COUNTERS = (('split_launches', 'split-k'),
                     ('tc_launches', 'tensor-core'))


def instance_counts(kernel):
    return {attr: getattr(kernel, attr) for attr, _ in INSTANCE_COUNTERS
            if hasattr(kernel, attr)}


def hold_kernel(kname, name, kernel, call, twin, tol, timing=None,
                lse=False, floor=0.0, instance=None, check=None):
    """Hold one kernel call against its twin on the same inputs, and on a
    main-path shape (``timing``: dict of ``iters``, ``bound`` as
    ``bound_of`` returns it, ``library(iters)``) time it. ``call(i)`` and
    ``twin(i)`` run on the inputs of layer i; with ``lse`` they return
    (out, lse). ``instance``: the instance the call must take
    ('tensor-core', 'split-k' or 'cuda-core'), read from the wrapper's
    instance counters. The launches made here only compare and time, so
    the kernel's counters are put back. Raises when the two disagree or
    the wrong instance ran; ``check(out)`` may raise on the call's output
    too."""
    before = kernel.launches
    inst_before = instance_counts(kernel)
    got = call(0)
    torch.cuda.synchronize()
    if check is not None:
        check(got)
    want = twin(0)
    rec = {}
    if instance is not None:
        took = 'cuda-core'
        for attr, label in INSTANCE_COUNTERS:
            if getattr(kernel, attr, 0) > inst_before.get(attr, 0):
                took = label
        rec['instance'] = took
        if took != instance:
            raise AssertionError(f'{kname} {name}: ran the {took} instance, '
                                 f'want {instance}')
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        rec['lse_err'] = (got_lse - want_lse).abs().max().item()
    if isinstance(got, tuple):          # several outputs: the worst of them
        errs = [kernel_err(a, b, floor) for a, b in zip(got, want)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    else:
        err, rel = kernel_err(got, want, floor)
    rec.update(max_abs_err=err, max_row_rel_err=rel, tol=tol)
    if timing:
        it = timing['iters']
        b_ms, b_by, nbytes, ops = timing['bound']
        rec.update(ms=device_ms(call, it), ms_events=cuda_ms(call, it),
                   plain_ms=cuda_ms(twin, max(4, it // 10), warmup=1),
                   library_ms=timing['library'](it), bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes, ops=ops)
    kernel.launches = before
    for attr, n in inst_before.items():
        setattr(kernel, attr, n)
    ok = math.isfinite(err) and rel <= tol
    extra = f'; {rec["instance"]} instance' if instance is not None else ''
    if lse:
        ok = ok and rec['lse_err'] <= LSE_TOL
        extra += f'; lse {rec["lse_err"]:.3e} (tol {LSE_TOL:g})'
    if timing:
        extra += (f'; kernel {rec["ms"]:.4f} ms (events '
                  f'{rec["ms_events"]:.4f}), plain {rec["plain_ms"]:.4f} ms,'
                  f' sdpa {rec["library_ms"]:.4f} ms, bound '
                  f'{rec["bound_ms"]:.4f} ms ({rec["bound_by"]})')
    print(f'  kernel {kname} {name}: max_abs_err {err:.3e}, row-scaled '
          f'{rel:.3e} (tol {tol:g}) {"OK" if ok else "FAIL"}{extra}',
          flush=True)
    if not ok:
        raise AssertionError(f'{kname} {name}: kernel and twin differ '
                             f'({rec})')
    return rec


# kernels 6 and 7 beyond the engine's shapes, one case per instance and
# edge: pos at page edges (0, 127, 128, 1023), the table shuffled with its
# unused entries on the trash page, GQA groups of 4 and 2, head dims
# 64/128/256, f32 q; T 1, 2, 16 (split-K), 17-1024 (tensor-core in bf16 at D
# 64/128); kernel 6 over pages of the pool's dtype, kernel 7 over int8 banks
BF, FP = torch.bfloat16, torch.float32
EDGES = [0, 127, 128, 1023]
PAGED_CASES = [
    ('T1_edges', dict(b=4, t=1, h=16, h_kv=16, d=64, pos=EDGES, dtype=BF)),
    ('T1_gqa4', dict(b=4, t=1, h=16, h_kv=4, d=64, pos=EDGES, dtype=BF)),
    ('T2_gqa4_d128', dict(b=4, t=2, h=8, h_kv=2, d=128,
                          pos=[0, 127, 128, 1000], dtype=BF)),
    ('T16_gqa4_d256', dict(b=2, t=16, h=8, h_kv=2, d=256, pos=[127, 900],
                           dtype=BF)),
    ('T1_f32_edges', dict(b=4, t=1, h=16, h_kv=16, d=64, pos=EDGES,
                          dtype=FP)),
    ('T16_f32_d128', dict(b=2, t=16, h=4, h_kv=4, d=128, pos=[128, 1000],
                          dtype=FP)),
    ('T17_gqa4', dict(b=2, t=17, h=16, h_kv=4, d=64, pos=[0, 127],
                      dtype=BF)),
    ('T64_gqa4_d128', dict(b=2, t=64, h=8, h_kv=2, d=128, pos=[128, 900],
                           dtype=BF)),
    ('T65', dict(b=2, t=65, h=8, h_kv=8, d=64, pos=[127, 300], dtype=BF)),
    ('T300_gqa4', dict(b=2, t=300, h=16, h_kv=4, d=64, pos=[0, 517],
                       dtype=BF)),
    ('T1024_gqa2_d128', dict(b=1, t=1024, h=4, h_kv=2, d=128, pos=[0],
                             dtype=BF)),
    ('T300_gqa2_d256', dict(b=2, t=300, h=4, h_kv=2, d=256, pos=[0, 517],
                            dtype=BF)),
    ('T65_f32_gqa4', dict(b=2, t=65, h=8, h_kv=2, d=64, pos=[127, 128],
                          dtype=FP)),
    ('T1024_f32', dict(b=1, t=1024, h=4, h_kv=4, d=64, pos=[0], dtype=FP)),
    # pages of 512 and 1024 rows (ROADMAP Q3.2): the CUDA-core kernel's
    # shared memory no longer grows with the page size
    ('T300_f32_ps512_d128', dict(b=2, t=300, h=4, h_kv=2, d=128,
                                 pos=[0, 600], dtype=FP, ps=512, p_max=2)),
    ('T300_f32_ps1024', dict(b=2, t=300, h=4, h_kv=2, d=64, pos=[0, 700],
                             dtype=FP, ps=1024, p_max=1)),
    ('T200_ps512_d128', dict(b=2, t=200, h=4, h_kv=2, d=128, pos=[0, 700],
                             dtype=BF, ps=512, p_max=2)),
    ('T3_ps1024', dict(b=2, t=3, h=4, h_kv=2, d=64, pos=[5, 1020], dtype=BF,
                       ps=1024, p_max=1)),
    # prefill padding: rows at or past valid come out zero, their q tiles
    # skipped (tensor-core, CUDA-core)
    ('T1024_valid', dict(b=3, t=1024, h=4, h_kv=2, d=64, pos=[0, 0, 0],
                         dtype=BF, valid=[5, 129, 1000])),
    ('T300_f32_valid', dict(b=2, t=300, h=4, h_kv=2, d=64, pos=[0, 0],
                            dtype=FP, valid=[1, 250])),
]
# the engine's prefill at its real rows: one prompt of 200 padded to 1024
ENGINE_VALID = 200
# the prefix cache's tail prefills (phase 15): 1024 rows from a nonzero
# start, the uncached tail real. A page edge (a shared system prompt of 5
# pages), mid-page (after copy-on-write: a turn's written rows end
# anywhere), and so late that the padding rows' positions run past
# max_seq_len. Timed as main-path shapes.
TAIL_CASES = [
    ('prefill_T1024_start640_valid192', dict(
        b=1, t=1024, h=16, h_kv=16, d=64, pos=[640], dtype=BF, valid=[192],
        tail=True)),
    ('prefill_T1024_start700_valid124', dict(
        b=1, t=1024, h=16, h_kv=16, d=64, pos=[700], dtype=BF, valid=[124],
        tail=True)),
    ('prefill_T1024_start1000_valid24', dict(
        b=1, t=1024, h=16, h_kv=16, d=64, pos=[1000], dtype=BF, valid=[24],
        tail=True)),
]


def moe_paged_cases(ragged):
    """Kernels 6 and 7 at the MoE engine's shapes (phase 17: MoEConfig()'s
    12 heads of 64): the step over 8 slots and a 1024-row prefill with 200
    real rows; and at the shapes of an mp=2 shard of the MoE engine (6
    heads) and of the bench GPT's (phase 40: 8 heads)."""
    return [(f'{pre}decode_T1{post}', dict(b=8, t=1, h=h, h_kv=h, d=64,
                                            pos=ragged, dtype=BF))
            for pre, h, post in MESH_SHARD_HEADS] + [
        (f'{pre}prefill_T1024_valid200{post}', dict(
            b=1, t=1024, h=h, h_kv=h, d=64, pos=[0], dtype=BF,
            valid=[ENGINE_VALID]))
        for pre, h, post in MESH_SHARD_HEADS]


# (name prefix, heads, name suffix): the MoE engine (12 heads of 64), an
# mp=2 shard of it, an mp=2 shard of the bench GPT (16 heads)
MESH_SHARD_HEADS = [('moe_', 12, ''), ('moe_', 6, '_mp2'), ('', 8, '_mp2')]


def kernel_cases(pa, timed_iters):
    """Kernels 6 and 7 (paged decode over bf16/f32 and int8 pools)."""
    from paddle_tpu_torch.ops.weight_only import kv_layer
    rng = np.random.RandomState(1)
    ragged = [int(x) for x in rng.randint(16, 1023, size=8)]
    ragged[0], ragged[1] = 0, 1023          # both ends of the window
    engine = [
        ('decode_T1', dict(b=8, t=1, h=16, h_kv=16, d=64, pos=ragged,
                           dtype=BF), True),
        ('prefill_T1024', dict(b=1, t=1024, h=16, h_kv=16, d=64, pos=[0],
                               dtype=BF), True),
        ('prefill_T1024_valid200', dict(b=1, t=1024, h=16, h_kv=16, d=64,
                                        pos=[0], dtype=BF,
                                        valid=[ENGINE_VALID]), True),
        ('decode_T1_gqa_hkv4', dict(b=8, t=1, h=16, h_kv=4, d=64,
                                    pos=ragged, dtype=BF), False),
        ('decode_T1_d128', dict(b=8, t=1, h=8, h_kv=8, d=128, pos=ragged,
                                dtype=BF), False),
        ('decode_T1_d256', dict(b=8, t=1, h=4, h_kv=4, d=256, pos=ragged,
                                dtype=BF), False),
        ('decode_T1_f32', dict(b=8, t=1, h=16, h_kv=16, d=64, pos=ragged,
                               dtype=FP), False),
        ('prefill_T300_f32_gqa', dict(b=2, t=300, h=16, h_kv=4, d=64,
                                      pos=[0, 517], dtype=FP), False),
    ]
    moe = [(name, kw, False) for name, kw in moe_paged_cases(ragged)]
    tails = [(name, kw, True) for name, kw in TAIL_CASES]
    cases = (engine + tails + moe
             + [(name, kw, False) for name, kw in PAGED_CASES]
             + [(name, dict(kw, int8=True), timed)
                for name, kw, timed in engine[:3] + tails + moe]
             + [(name, dict(kw, int8=True), False)
                for name, kw in PAGED_CASES])
    results = {'paged_decode': {}, 'paged_decode_int8': {}}
    for name, kw, engine_shape in cases:
        c = make_case(layers=LAYERS if engine_shape else 1, **kw)
        kname = 'paged_decode_int8' if c['int8'] else 'paged_decode'
        kern = (pa.paged_flash_decode_int8 if c['int8']
                else pa.paged_flash_decode)
        twin = (pa.paged_decode_int8_reference if c['int8']
                else pa.paged_decode_reference)
        n_layers = (c['k']['int8'] if c['int8'] else c['k']).shape[0]
        args = lambda i: (c['q'], kv_layer(c['k'], i % n_layers),  # noqa: E731
                          kv_layer(c['v'], i % n_layers), c['table'],
                          c['pos'])
        timing = (dict(iters=timed_iters, bound=bound(c),
                       library=lambda it: sdpa_ms(c, it))
                  if engine_shape else None)
        # the library's instance for the case: split-K, tensor-core or
        # CUDA-core, by T, dtype, head dim and page size
        inst = pa.paged_instance(kw['dtype'], kw['t'], kw['d'], c['ps'],
                                 torch.int8 if c['int8'] else kw['dtype'])
        results[kname][name] = hold_kernel(
            kname, name, kern,
            lambda i: kern(*args(i), valid=c['valid']),
            lambda i: twin(*args(i), valid=c['valid']), TOL[kw['dtype']],
            timing, instance=inst,
            check=(None if c['valid'] is None else
                   lambda out: expect_zero_past_valid(kname, name, out,
                                                      c['valid'])))
        del c
        torch.cuda.empty_cache()
    return results


def expect_zero_past_valid(kname, name, out, valid):
    """Rows at or past valid[b] of a kernel's output are exactly zero."""
    for b, n in enumerate(valid.tolist()):
        if out[b, n:].any():
            raise AssertionError(f'{kname} {name}: slot {b} has nonzero rows '
                                 f'past valid {n}')


# ---------------------------------------------------------------------------
# phase 3 (continued): the dense decode kernels and the forward kernel
# ---------------------------------------------------------------------------

GEN_POS = 191      # mean position of phase 6's decode steps (128 .. 254)
PF_TILE = 128      # q rows a block of the tensor-core prefill
BF16, F32 = torch.bfloat16, torch.float32
# (name, case arguments, timing: 'main' for a main-path shape, timed over
# LAYERS rotating caches; 'shape' for kernel 4's other instances, timed
# lightly; None untimed)
DECODE_CASES = [
    # kernel 4, one case per instance and edge: split-K at T 1, 2, 16 (GQA,
    # head dims 64-256, f32, S_max 1000), tensor-core at T 128 (generate()'s
    # prefill), 300 and 1000 (the prefill past the window), CUDA-core for
    # f32 at T > 16, S_max 1000 and head dim 256
    ('decode_T1', dict(b=8, t=1, h=16, h_kv=16, d=64, s_max=1024,
                       pos=GEN_POS, dtype=BF16), 'main'),
    ('prefill_T128', dict(b=8, t=128, h=16, h_kv=16, d=64, s_max=1024,
                          pos=0, dtype=BF16), 'main'),
    ('decode_T2_gqa_hkv4_d128', dict(b=8, t=2, h=16, h_kv=4, d=128,
                                     s_max=1024, pos=700, dtype=BF16),
     'shape'),
    ('decode_T16_gqa_d256_smax1000', dict(b=2, t=16, h=8, h_kv=4, d=256,
                                          s_max=1000, pos=984, dtype=BF16),
     'shape'),
    ('decode_T3_f32_d256', dict(b=2, t=3, h=4, h_kv=4, d=256, s_max=512,
                                pos=300, dtype=F32), 'shape'),
    ('decode_T1_f32_smax1000', dict(b=4, t=1, h=8, h_kv=2, d=64,
                                    s_max=1000, pos=128, dtype=F32),
     'shape'),
    ('prefill_T300_gqa_d128', dict(b=2, t=300, h=8, h_kv=2, d=128,
                                   s_max=512, pos=100, dtype=BF16), 'shape'),
    ('prefill_T1000', dict(b=8, t=1000, h=16, h_kv=16, d=64, s_max=1024,
                           pos=0, dtype=BF16), 'shape'),
    ('prefill_T128_f32', dict(b=2, t=128, h=4, h_kv=4, d=64, s_max=1024,
                              pos=0, dtype=F32), 'shape'),
    ('prefill_T128_smax1000', dict(b=2, t=128, h=4, h_kv=4, d=64,
                                   s_max=1000, pos=0, dtype=BF16), 'shape'),
    ('prefill_T70_d256', dict(b=2, t=70, h=4, h_kv=2, d=256, s_max=512,
                              pos=30, dtype=BF16), 'shape'),
    ('decode_T1_int8', dict(b=8, t=1, h=16, h_kv=16, d=64, s_max=1024,
                            pos=GEN_POS, dtype=BF16, int8=True), 'main'),
    ('prefill_T128_int8', dict(b=8, t=128, h=16, h_kv=16, d=64, s_max=1024,
                               pos=0, dtype=BF16, int8=True), 'main'),
    ('decode_T2_int8_f32_gqa', dict(b=4, t=2, h=8, h_kv=2, d=64, s_max=512,
                                    pos=400, dtype=F32, int8=True), None),
    # kernel 5's instances beyond generate()'s shapes: S_max not a
    # multiple of the split-K's 128-row pages, T 16 at D 256, the
    # tensor-core prefill at D 128 and GQA, the CUDA-core tile
    ('decode_T16_int8_d256_smax200', dict(b=2, t=16, h=8, h_kv=2, d=256,
                                          s_max=200, pos=150, dtype=BF16,
                                          int8=True), None),
    ('prefill_T300_int8_gqa_d128', dict(b=2, t=300, h=8, h_kv=2, d=128,
                                        s_max=512, pos=100, dtype=BF16,
                                        int8=True), None),
    ('prefill_T128_int8_smax1000', dict(b=2, t=128, h=4, h_kv=4, d=64,
                                        s_max=1000, pos=0, dtype=BF16,
                                        int8=True), None),
    ('prefill_T128_int8_f32', dict(b=2, t=128, h=4, h_kv=4, d=64, s_max=1024,
                                   pos=0, dtype=F32, int8=True), None),
    # the MoE generate()'s shapes (phase 17: 12 heads of 64)
    ('moe_decode_T1', dict(b=8, t=1, h=12, h_kv=12, d=64, s_max=1024,
                           pos=GEN_POS, dtype=BF16), None),
    ('moe_prefill_T128', dict(b=8, t=128, h=12, h_kv=12, d=64, s_max=1024,
                              pos=0, dtype=BF16), None),
    ('moe_decode_T1_int8', dict(b=8, t=1, h=12, h_kv=12, d=64, s_max=1024,
                                pos=GEN_POS, dtype=BF16, int8=True), None),
    ('moe_prefill_T128_int8', dict(b=8, t=128, h=12, h_kv=12, d=64,
                                   s_max=1024, pos=0, dtype=BF16, int8=True),
     None),
]
# (name prefix, layout, b / h / h_kv) of one rank of phases 38-39's meshes
MESH_RANK_SHAPES = [
    ('', 'mp2', dict(b=8, h=8, h_kv=8)), ('', 'dp2', dict(b=4, h=16, h_kv=16)),
    ('moe_', 'mp2', dict(b=8, h=6, h_kv=6)),
    ('moe_', 'dp2', dict(b=4, h=12, h_kv=12))]
# phase 25's attention: B=8, S=512, 12 heads of 64, the batch's
# key-padding mask (lens='ernie': tests/torch_nn_cases.mlm_batch's lengths)
ERNIE_ATTN = dict(b=8, s=512, h=12, h_kv=12, d=64, dtype=BF16, causal=False,
                  lens='ernie')
# phase 31's attention: 12 heads of 64 over S=128, row lengths 32-128
ERNIE_SERVE_ATTN = dict(s=128, h=12, h_kv=12, d=64, dtype=BF16, causal=False)
SERVE_LENS = [int(n) for n in np.random.RandomState(1).randint(32, 129, 64)]
# one hop of the sp ring at phase 38's sp2: B 8, S_local 512, 16 heads of 64
RING_HOP = dict(b=8, s=512, h=16, h_kv=16, d=64, dtype=BF16)
FWD_CASES = [
    ('fwd_S1024', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16), True),
    ('fwd_S300_gqa_d128_f32', dict(b=2, s=300, h=8, h_kv=4, d=128,
                                   dtype=F32), False),
    ('fwd_S300_gqa_d128', dict(b=2, s=300, h=8, h_kv=4, d=128, dtype=BF16),
     False),
    ('fwd_S200_mask_noncausal', dict(b=2, s=200, h=4, h_kv=4, d=64,
                                     dtype=BF16, causal=False, masked=True),
     False),
    ('fwd_S130_d256', dict(b=1, s=130, h=2, h_kv=2, d=256, dtype=BF16),
     False),
    # attention dropout (training): the forward's shape at rate 0.1
    ('fwd_S1024_drop0.1', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16,
                               drop=0.1), True),
    # the MoE train step's shape (phase 18: 12 heads of 64)
    ('moe_fwd_S1024', dict(b=8, s=1024, h=12, h_kv=12, d=64, dtype=BF16),
     False),
] + [
    # a rank's shapes in phases 38-39's meshes: mp2 (half the heads) and
    # dp2 (half the batch), of the bench GPT and of the MoE GPT
    (f'{pre}fwd_S1024_{lay}', dict(kw, s=1024, d=64, dtype=BF16), False)
    for pre, lay, kw in MESH_RANK_SHAPES
] + [
    # the ERNIE-base masked-LM program's shape (phase 25): 12 heads of 64,
    # bidirectional, its key-padding mask (lengths 256-512)
    ('ernie_fwd_S512', dict(ERNIE_ATTN), True),
    ('ernie_fwd_S512_drop0.1', dict(ERNIE_ATTN, drop=0.1), True),
    # ERNIE-base served (phase 31): the engine's buckets 64 and 1 at S=128,
    # bidirectional, a key-padding mask of row lengths 32-128
    ('ernie_serve_B64_S128', dict(ERNIE_SERVE_ATTN, b=64,
                                  lens=SERVE_LENS), True),
    ('ernie_serve_B1_S128', dict(ERNIE_SERVE_ATTN, b=1, lens=SERVE_LENS[:1]),
     True),
    # the sp ring's hops (phase 38's sp2: S_local 512 of the bench GPT's
    # 1024): a past kv block (dense) and the diagonal block (causal)
    ('ring_hop_fwd_S512_past', dict(RING_HOP, causal=False), True),
    ('ring_hop_fwd_S512_diag', dict(RING_HOP), True),
]
DROP_SEED = 2 ** 31 + 12345     # a u32 past the int32 range
# kernels 2 and 3 (the flash backward): the train step's shape first
BWD_CASES = [
    ('bwd_S1024', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16), True),
    ('bwd_S1024_drop0.1', dict(b=8, s=1024, h=16, h_kv=16, d=64, dtype=BF16,
                               drop=0.1), True),
    ('bwd_S300_gqa_d128_f32', dict(b=2, s=300, h=8, h_kv=4, d=128,
                                   dtype=F32), False),
    ('bwd_S300_gqa_d128', dict(b=2, s=300, h=8, h_kv=4, d=128, dtype=BF16),
     False),
    ('bwd_S512_f32', dict(b=2, s=512, h=4, h_kv=4, d=64, dtype=F32), False),
    ('bwd_S200_mask_noncausal_drop0.25', dict(b=2, s=200, h=4, h_kv=2, d=64,
                                              dtype=BF16, causal=False,
                                              masked=True, drop=0.25),
     False),
    ('bwd_S130_d256', dict(b=1, s=130, h=2, h_kv=2, d=256, dtype=BF16),
     False),
    ('moe_bwd_S1024', dict(b=8, s=1024, h=12, h_kv=12, d=64, dtype=BF16),
     False),
] + [
    (f'{pre}bwd_S1024_{lay}', dict(kw, s=1024, d=64, dtype=BF16), False)
    for pre, lay, kw in MESH_RANK_SHAPES
] + [
    ('ernie_bwd_S512', dict(ERNIE_ATTN), True),
    ('ernie_bwd_S512_drop0.1', dict(ERNIE_ATTN, drop=0.1), True),
]
LSE_TOL = 1e-4     # lse is f32 from the same scores: order of sums only


def dense_case(b, t, h, h_kv, d, s_max, pos, dtype, int8=False, layers=1,
               seed=0):
    """q, ``layers`` dense caches [B, S_max, H_kv, D] (int8 banks with
    ``int8``) and pos as the int32 [1] tensor generate() passes. q is a
    strided view of a packed [B, T, H_kv, g + 2, D] projection, as
    ``_block_qkv`` hands it over (MHA: a view; GQA: a copy)."""
    from paddle_tpu_torch.ops.weight_only import quantize_kv
    g = torch.Generator(device='cuda').manual_seed(seed)
    grp = h // h_kv
    packed = torch.randn((b, t, h_kv, grp + 2, d), generator=g,
                         device='cuda').to(dtype)
    q = packed[..., :grp, :].reshape(b, t, h, d)

    def plane():
        out = []
        for _ in range(layers):
            x = torch.randn((b, s_max, h_kv, d), generator=g, device='cuda')
            if int8:
                qx, sx = quantize_kv(x)
                out.append({'int8': qx, 'scale': sx})
            else:
                out.append(x.to(dtype))
        return out

    return dict(q=q, k=plane(), v=plane(), s_max=s_max, int8=int8,
                pos=torch.tensor([pos], dtype=torch.int32, device='cuda'))


def decode_bound(c):
    """Each K/V row the rows can see read once (int8: its byte per value
    and its f32 scale), q, out and pos once; 4*D flops per (row, visible
    key, head)."""
    q = c['q']
    b, t, h, d = q.shape
    kv = c['k'][0]['int8'] if c['int8'] else c['k'][0]
    h_kv = kv.shape[2]
    pos, s_max = int(c['pos']), c['s_max']
    row = d * kv.element_size() + (4 if c['int8'] else 0)
    nbytes = (2 * b * min(pos + t, s_max) * h_kv * row
              + 2 * q.numel() * q.element_size() + 4)
    ops = 4 * d * h * b * sum(min(pos + j + 1, s_max) for j in range(t))
    return bound_of(nbytes, ops, q.dtype)


def decode_sdpa_ms(c, iters):
    """Yardstick only: one F.scaled_dot_product_attention over the keys the
    rows can see, the cache transposed (and int8 dequantized) beforehand,
    not timed."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.weight_only import dequantize_kv
    q = c['q']
    b, t, h, d = q.shape
    pos = int(c['pos'])
    keys = min(pos + t, c['s_max'])
    rot = min(8, len(c['k']))

    def dense(x):
        if c['int8']:
            x = dequantize_kv(x['int8'], x['scale'], q.dtype)
        return x[:, :keys].transpose(1, 2).contiguous()

    ks = [dense(c['k'][i]) for i in range(rot)]
    vs = [dense(c['v'][i]) for i in range(rot)]
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(keys, device='cuda')[None, :]
            <= pos + torch.arange(t, device='cuda')[:, None])
    gqa = ks[0].shape[1] != h
    return device_ms(lambda i: F.scaled_dot_product_attention(
        qt, ks[i % rot], vs[i % rot], attn_mask=mask, enable_gqa=gqa), iters)


def tests_module(name):
    """A numpy-only case module of tests/ (shared with the CPU tests)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def nn_cases():
    """tests/torch_nn_cases.py: the nn case table and the ERNIE-width
    program."""
    return tests_module('torch_nn_cases')


ERNIE_BATCH = dict(b=8, s=512, lo=256, hi=512, seed=0)


def ernie_lens():
    """The key lengths of phase 25's batch (numpy seed 0, 256-512)."""
    C = nn_cases()
    return [int(n) for n in C.mlm_batch(
        C.ERNIE_BASE['vocab'], **ERNIE_BATCH)[4]]


def fwd_case(b, s, h, h_kv, d, dtype, causal=True, masked=False, layers=1,
             seed=0, drop=0.0, lens=None):
    """q, k, v as ``_block_qkv`` gives them, per layer: strided views of
    one packed projection [B, S, H_kv, g+2, D] (q is copied when g > 1),
    and dO per layer. ``lens``: each batch row's key count ('ernie':
    phase 25's), as an additive key-padding mask."""
    g = h // h_kv
    gen = torch.Generator(device='cuda').manual_seed(seed)
    parts = []
    for _ in range(layers):
        x = torch.randn((b, s, h_kv, g + 2, d), generator=gen,
                        device='cuda').to(dtype)
        parts.append((x[..., :g, :].reshape(b, s, h, d), x[..., g, :],
                      x[..., g + 1, :]))
    dos = [torch.randn((b, s, h, d), generator=gen, device='cuda').to(dtype)
           for _ in range(layers)]
    kmask = None
    if lens == 'ernie':
        lens = ernie_lens()
    if masked and lens is None:
        lens = [s, s - 77][:b]
    if lens is not None:
        valid = torch.tensor(lens, device='cuda')[:, None]
        kmask = torch.where(torch.arange(s, device='cuda')[None] < valid,
                            0.0, -1e30)
    return dict(parts=parts, dos=dos, causal=causal, kmask=kmask, drop=drop,
                seed=DROP_SEED if drop else None, lens=lens)


def visible(c):
    """(keys each query row sees summed over the batch, [rows], key rows
    read per batch row)."""
    q, k, _ = c['parts'][0]
    b, s = q.shape[:2]
    keys = c['lens'] or [s] * b
    if c['causal']:
        return b * (s * (s + 1) // 2), keys
    return s * sum(keys), keys


def fwd_bound(c):
    """q and out moved once, the visible rows of k and v read once (a
    masked batch row's keys past its length are not needed), the mask
    read and lse written once; 4*D flops per (row, visible key, head)."""
    q, k, _ = c['parts'][0]
    b, s, h, d = q.shape
    es = q.element_size()
    vis, keys = visible(c)
    kv = 2 * sum(keys) * k.shape[2] * d * es
    mask = 0 if c['kmask'] is None else b * s * 4
    nbytes = 2 * q.numel() * es + kv + mask + b * h * s * 4
    return bound_of(nbytes, 4 * d * h * vis, q.dtype)


def sdpa_mask(c):
    """The case's key-padding mask as SDPA takes it (bool [B, 1, 1, S])."""
    if c['kmask'] is None:
        return None
    return (c['kmask'] == 0)[:, None, None, :]


def fwd_sdpa_ms(c, iters):
    """Yardstick only: one F.scaled_dot_product_attention (the case's
    causality, key-padding mask and dropout rate, its own random mask)
    over q, k, v made contiguous in [B, H, S, D] beforehand, not
    timed."""
    import torch.nn.functional as F
    rot = min(8, len(c['parts']))
    qkv = [[x.transpose(1, 2).contiguous() for x in c['parts'][i]]
           for i in range(rot)]
    mask = sdpa_mask(c)
    return device_ms(lambda i: F.scaled_dot_product_attention(
        *qkv[i % rot], attn_mask=mask, is_causal=c['causal'],
        dropout_p=c['drop']), iters)


def dense_kernel_cases(fa, pa, timed_iters):
    """The dense decode kernels (4, 5) and the forward kernel (1) against
    their twins; the main-path shapes are timed over LAYERS rotating
    caches or projections, as generate() and forward() find them."""
    results = {'flash_decode': {}, 'flash_decode_int8': {}, 'flash_fwd': {}}
    for name, kw, timed in DECODE_CASES:
        layers = {'main': LAYERS, 'shape': 4}.get(timed, 1)
        c = dense_case(layers=layers, **kw)
        kname = 'flash_decode_int8' if c['int8'] else 'flash_decode'
        kern = getattr(fa, kname)
        twin = getattr(fa, kname + '_reference')
        n = len(c['k'])
        args = lambda i: (c['q'], c['k'][i % n], c['v'][i % n], c['pos'])  # noqa: E731
        iters = timed_iters if timed == 'main' else max(8, timed_iters // 5)
        timing = (dict(iters=iters, bound=decode_bound(c),
                       library=lambda it: decode_sdpa_ms(c, it))
                  if timed else None)
        # kernels 4 and 5 take kernel 6 and 7's rule over their implicit
        # pages, S_max for the page size
        inst = pa.paged_instance(kw['dtype'], kw['t'], kw['d'], kw['s_max'],
                                 torch.int8 if c['int8'] else kw['dtype'])
        results[kname][name] = hold_kernel(
            kname, name, kern, lambda i: kern(*args(i)),
            lambda i: twin(*args(i)), TOL[kw['dtype']], timing,
            instance=inst)
        del c
        torch.cuda.empty_cache()
    for name, kw, timed in FWD_CASES:
        c = fwd_case(layers=LAYERS if timed else 1, **kw)
        n = len(c['parts'])
        # self-attention: q_off = S_k - S_q = 0
        args = lambda i: (*c['parts'][i % n], c['causal'])  # noqa: E731
        timing = (dict(iters=max(4, timed_iters // 4), bound=fwd_bound(c),
                       library=lambda it: fwd_sdpa_ms(c, it))
                  if timed else None)
        extra = dict(kmask=c['kmask'], drop_rate=c['drop'], seed=c['seed'])
        results['flash_fwd'][name] = hold_kernel(
            'flash_fwd', name, fa.flash_fwd,
            lambda i: fa.flash_fwd(*args(i), **extra),
            lambda i: fa.flash_fwd_reference(*args(i), **extra),
            TOL[kw['dtype']], timing, lse=True,
            instance='tensor-core' if kw['dtype'] == BF16 else 'cuda-core')
        del c
        torch.cuda.empty_cache()
    return results


def bwd_bound(c, dots):
    """q, k, v, dO, lse and delta read once and the kernel's outputs (dq;
    or dk and dv) written once; ``dots`` dots of 2*D flops per (row,
    visible key, head): 3 for dq (s, dp, ds.K), 4 for dk/dv."""
    q, k, _ = c['parts'][0]
    b, s, h, d = q.shape
    es = q.element_size()
    vis, keys = visible(c)
    kv = 2 * sum(keys) * k.shape[2] * d * es
    mask = 0 if c['kmask'] is None else b * s * 4
    ins = 2 * q.numel() * es + kv + mask + 2 * b * h * s * 4
    outs = q.numel() * es if dots == 3 else 2 * k.numel() * es
    return bound_of(ins + outs, dots * 2 * d * h * vis, q.dtype)


def sdpa_bwd_ms(c, iters):
    """Yardstick only (the port never calls it): PyTorch's own flash
    backward, ``aten._scaled_dot_product_flash_attention_backward``, which
    computes dq, dk and dv together (kernels 2 and 3 at once), on q, k, v
    and dO made contiguous in [B, H, S, D] and its own forward's out and
    lse, all made beforehand and not timed."""
    rot = min(8, len(c['parts']))
    if c['kmask'] is not None:
        return sdpa_masked_bwd_ms(c, iters)
    ops = torch.ops.aten
    args = []
    for i in range(rot):
        q, k, v = (x.transpose(1, 2).contiguous() for x in c['parts'][i])
        o = ops._scaled_dot_product_flash_attention(q, k, v, c['drop'],
                                                    c['causal'])
        g = c['dos'][i].transpose(1, 2).contiguous()
        args.append((g, q, k, v, o[0], o[1], o[2], o[3], o[4], o[5],
                     c['drop'], c['causal'], o[6], o[7]))
    return device_ms(lambda i: ops._scaled_dot_product_flash_attention_backward(
        *args[i % rot]), iters)


def sdpa_masked_bwd_ms(c, iters):
    """Yardstick for a masked case (PyTorch's flash backward takes no
    mask): the backward of one F.scaled_dot_product_attention with the
    case's key-padding mask and dropout (its memory-efficient kernel),
    dq, dk and dv together, the forward run beforehand and not timed."""
    import torch.nn.functional as F
    rot = min(8, len(c['parts']))
    mask = sdpa_mask(c)
    runs = []
    for i in range(rot):
        q, k, v = (x.transpose(1, 2).contiguous().requires_grad_()
                   for x in c['parts'][i])
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=c['drop'])
        runs.append((out, (q, k, v), c['dos'][i].transpose(1, 2)
                     .contiguous()))
    return device_ms(lambda i: torch.autograd.grad(
        runs[i % rot][0], runs[i % rot][1], runs[i % rot][2],
        retain_graph=True), iters)


def bwd_kernel_cases(fa, timed_iters):
    """Kernels 2 and 3 against their twin on the same inputs (q, k, v,
    dO, and kernel 1's own out and lse), each kernel timed alone at the
    train step's shape over LAYERS rotating inputs; the twin computes
    dq, dk and dv together, so its time stands for both."""
    results = {'flash_bwd_dq': {}, 'flash_bwd_dkv': {}}
    for name, kw, timed in BWD_CASES:
        c = fwd_case(layers=LAYERS if timed else 1, **kw)
        n = len(c['parts'])
        extra = dict(kmask=c['kmask'], drop_rate=c['drop'], seed=c['seed'])
        fwd = [fa.flash_fwd(*c['parts'][i], c['causal'], **extra)
               for i in range(n)]
        delta = [fa.bwd_delta(fwd[i][0], c['dos'][i]) for i in range(n)]

        def inputs(i):
            j = i % n
            return (*c['parts'][j], c['dos'][j], fwd[j][1], delta[j],
                    c['causal'])

        library = {}

        def lib_ms(it):
            if 'ms' not in library:
                library['ms'] = sdpa_bwd_ms(c, it)
            return library['ms']

        for kname, dots, pick in (('flash_bwd_dq', 3, lambda r: r[0]),
                                  ('flash_bwd_dkv', 4, lambda r: r[1:])):
            kern = getattr(fa, kname)
            timing = (dict(iters=max(4, timed_iters // 4),
                           bound=bwd_bound(c, dots), library=lib_ms)
                      if timed else None)
            # kernels 2 and 3 run their tensor-core instances for bf16 at
            # head dim 64 and 128
            tc = kw['dtype'] == BF16 and kw['d'] in (64, 128)
            results[kname][name] = hold_kernel(
                kname, name, kern,
                lambda i: kern(*inputs(i), **extra),
                lambda i: pick(fa.flash_bwd_reference(*inputs(i), **extra)),
                TOL[kw['dtype']], timing, floor=GRAD_FLOOR,
                instance='tensor-core' if tc else 'cuda-core')
        del c, fwd, delta
        torch.cuda.empty_cache()
    return results


def ring_bwd_cases(fa, timed_iters):
    """Kernels 2 and 3 as the sp ring runs them (rank 1 of phase 38's sp2):
    one q block against a past kv block (dense) and its own (causal), fed
    the MERGED lse of both hops and delta = rowsum(out * dO) of the merged
    output (``parallel.ring_attention.merge``), each held to its twin on
    the same inputs; the dense hop timed over LAYERS rotating inputs."""
    from paddle_tpu_torch.parallel.ring_attention import merge
    results = {'flash_bwd_dq': {}, 'flash_bwd_dkv': {}}
    c = fwd_case(layers=LAYERS, causal=False, **RING_HOP)
    n = len(c['parts'])
    hops = []
    for i in range(n):
        q, kp, vp = c['parts'][i]
        _, kd, vd = c['parts'][(i + 1) % n]
        o = torch.zeros(q.shape, device='cuda')
        lse = torch.full(q.shape[:1] + q.shape[2:3] + q.shape[1:2],
                         -math.inf, device='cuda')
        for k, v, causal in ((kp, vp, False), (kd, vd, True)):
            o, lse = merge(o, lse, *fa.flash_fwd(q, k, v, causal))
        out = o.to(q.dtype)
        hops.append(((kp, vp), (kd, vd), lse,
                     fa.bwd_delta(out, c['dos'][i])))
    for hop, causal in (('past', False), ('diag', True)):
        def inputs(i, _hop=hop, _causal=causal):
            j = i % n
            kv = hops[j][0] if _hop == 'past' else hops[j][1]
            return (c['parts'][j][0], *kv, c['dos'][j], hops[j][2],
                    hops[j][3], _causal)
        for kname, dots, pick in (('flash_bwd_dq', 3, lambda r: r[0]),
                                  ('flash_bwd_dkv', 4, lambda r: r[1:])):
            kern = getattr(fa, kname)
            timing = None
            if hop == 'past':
                timing = dict(iters=max(4, timed_iters // 4),
                              bound=bwd_bound(c, dots),
                              library=lambda it: sdpa_bwd_ms(c, it))
            results[kname][f'ring_hop_bwd_S512_{hop}'] = hold_kernel(
                kname, f'ring_hop_bwd_S512_{hop} (merged lse)', kern,
                lambda i, _k=kern, _in=inputs: _k(*_in(i)),
                lambda i, _in=inputs, _p=pick: _p(
                    fa.flash_bwd_reference(*_in(i))),
                TOL[BF16], timing, floor=GRAD_FLOOR, instance='tensor-core')
    del c, hops
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the engine
# ---------------------------------------------------------------------------

def bench_config(gpt, **over):
    kw = dict(vocab_size=32768, hidden_size=1024, num_layers=24,
              num_heads=16, max_seq_len=1024, dtype='bfloat16')
    kw.update(over)
    return gpt.GPTConfig(**kw)


def prompts(n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=int(t)).astype(np.int32)
            for t in rng.randint(lo, hi + 1, size=n)]


def prefill_pad_share(lens, width, ps, tq=64):
    """Share of the kernel's prefill work spent on q tiles that hold only
    padding rows. The engine pads every prompt to ``width`` rows at pos 0;
    a tile of ``tq`` rows works rows x the keys of every page up to its
    last row's, and the tiles at or past the prompt's length are the ones
    a kernel told the prompt's length could skip."""
    total = pad = 0
    for n in lens:
        for q0 in range(0, width, tq):
            rows = min(tq, width - q0)
            work = rows * ps * -(-(q0 + rows) // ps)
            total += work
            pad += work if q0 >= n else 0
    return pad / total


def prefill_tiles_skipped(lens, width, tq):
    """Share of the prefills' q tiles of ``tq`` rows that start at or past
    the prompt's length: the tiles the kernel, given valid, skips."""
    tiles = -(-width // tq)
    return sum(sum(q0 >= n for q0 in range(0, width, tq))
               for n in lens) / (tiles * len(lens))


def serve(engine, reqs, max_new, hold=False):
    """Submit ``reqs`` and wait for their tokens. ``hold``: the engine was
    built with autostart=False and starts only once every request is
    queued, so each step's batch is the same on every run (a MoE step
    routes its slots together: which requests share a step decides which
    tokens keep their experts)."""
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=max_new) for p in reqs]
    if hold:
        engine.start()
    out = [f.result(timeout=600) for f in futs]
    return out, time.perf_counter() - t0


MODES = (('eager', False), ('captured', True))


def engine_run(GenerationEngine, net, config, kname, kernels, reqs, new,
               capture, card, what, inspect=None, hold=False, shards=1,
               **engine_kw):
    """One engine over the bench GPT (8 slots, page 128, ``engine_kw``),
    eager (a private switch, for this comparison only) or on captured CUDA
    graphs: warmed up, every launch counter set to 0, then the requests
    served. Checks the tokens, the exact launches (kernel ``kname``: 24 x
    (prefills + steps), the prefills on the tensor-core instance and the
    steps on the split-K one), two captures at warmup and none from
    traffic; then a profiled rerun, and ``inspect(engine)`` (its result
    in the record's 'inspect'). ``hold``: the requests are all queued
    before the scheduler starts (``serve``). ``shards``: a mesh engine's
    (``mp=``), whose every call launches the kernel once a shard a layer.
    -> (record, the streams)."""
    args = (net,) if config is None else (net, config)
    eng = GenerationEngine(*args, num_slots=8, page_size=128,
                           autostart=not hold, **engine_kw)
    eng._capture = capture
    try:
        w = eng.warmup()
        traces = eng._trace_count
        zero_launches(kernels)
        out, wall = serve(eng, reqs, new, hold)
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        k = kernels[kname]
        inst = {'tensor-core': k.tc_launches, 'split-k': k.split_launches}
        st = eng.stats()
        after = eng._trace_count
        graphs = [f.captured for f in eng._fns.values()]
        prof = profile_serving(eng, reqs, new)
        width, ps = eng.prefill_width, eng.page_size
        extra = inspect(eng) if inspect is not None else None
    finally:
        eng.shutdown()
    mode = 'captured' if capture else 'eager'
    vocab = (config or net.config).vocab_size
    L = (config or net.config).num_layers
    for i, toks in enumerate(out):
        if len(toks) != new or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f'{what} {mode}, request {i}: {len(toks)} '
                                 f'tokens, want {new} in [0, {vocab})')
    if graphs != [capture] * 2:
        raise AssertionError(f'{what} {mode}: captured {graphs}')
    if (w['prebuilt'], traces, after) != (2, 2, 2):
        raise AssertionError(f'{what} {mode}: {w["prebuilt"]} built at '
                             f'warmup, _trace_count {traces} after warmup '
                             f'and {after} after traffic, want 2, 2, 2')
    expect_launches(f'{what} {mode} ({st["prefills"]} prefills + '
                    f'{st["steps"]} steps)', counts,
                    {kname: shards * L * (st['prefills'] + st['steps'])})
    if counts[kname] == 0:
        raise AssertionError('the main path launched no kernel')
    want = {'tensor-core': shards * L * st['prefills'],
            'split-k': shards * L * st['steps']}
    if inst != want:
        raise AssertionError(f'{what} {mode}: {kname} instances {inst}, '
                             f'want {want}')
    res = {'mode': mode, 'requests': len(out), 'new_tokens': new,
           'wall_s': wall, 'tokens_per_s': len(out) * new / wall,
           'ttft_ms_p50': st['ttft_ms_p50'], 'ttft_ms_p99': st['ttft_ms_p99'],
           'step_ms_mean': st['decode_step_ms_mean'],
           'prefill_ms_mean': st['prefill_ms_mean'],
           'prefills': st['prefills'], 'steps': st['steps'],
           'launches': counts[kname], 'instances': inst,
           'warmup_s': w['seconds'], 'traces': after,
           'prefill_width': width, 'page_size': ps,
           'kernel_device_ms': {
               'split-k': kernel_ms(prof, 'split_kernel'),
               'tensor-core': kernel_ms(prof, 'prefill_tc_kernel'),
               'cuda-core': kernel_ms(prof, 'paged_decode_kernel')},
           'profile': prof, 'inspect': extra}
    print(f'  {what} {mode}: {len(out)} requests x {new} tokens in '
          f'{wall:.3f} s; {res["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
          f'{res["ttft_ms_p50"]:.1f} ms, mean step {res["step_ms_mean"]:.2f}'
          f' ms, mean prefill {res["prefill_ms_mean"]:.2f} ms; {kname} '
          f'instances {inst}; captures {after} [{card}]', flush=True)
    return res, out


def print_profiles(what, runs, kname):
    for mode, _ in MODES:
        prof, r = runs[mode]['profile'], runs[mode]
        print(f'  {what} {mode}, profiled rerun: window '
              f'{prof["window_ms"]:.1f} ms, device busy '
              f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%),'
              f' {prof["kernels"]} kernel launches; {kname} device ms by '
              f'instance {r["kernel_device_ms"]}', flush=True)
        for name, ms in prof['top']:
            print(f'    {ms:9.3f} ms  {name}', flush=True)


def phase_engine(gpt, GenerationEngine, kernels, card):
    cfg = bench_config(gpt)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = gpt.init_params(cfg, gen, 'cuda')
    n_params = sum(v.numel() for k, v in params.items() if k != 'blocks')
    n_params += sum(v.numel() for v in params['blocks'].values())
    # the engine takes the model object (ROADMAP Q3.1)
    model = gpt.GPTForCausalLM(cfg, params, device='cuda')
    reqs = prompts(8, 16, 400, cfg.vocab_size, seed=0)
    new = 32
    runs, streams = {}, {}
    for mode, capture in MODES:
        runs[mode], streams[mode] = engine_run(
            GenerationEngine, model, None, 'paged_decode', kernels, reqs, new,
            capture, card, f'engine ({n_params / 1e6:.1f}M params)')
    if streams['captured'] != streams['eager']:
        raise AssertionError('engine: captured and eager greedy streams '
                             'differ')
    print('  engine greedy streams, captured against eager: equal',
          flush=True)
    res = dict(runs['captured'], eager=runs['eager'], params=n_params,
               prompt_lens=[len(p) for p in reqs])
    lens = res['prompt_lens']
    width, ps = res['prefill_width'], res['page_size']
    res.update(prefill_pad_share=prefill_pad_share(lens, width, ps),
               prefill_work_skipped=prefill_pad_share(lens, width, ps,
                                                      PF_TILE),
               prefill_tiles_skipped=prefill_tiles_skipped(lens, width,
                                                           PF_TILE),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f'  prefill attention work on padding-only q tiles (prompts '
          f'{min(lens)}-{max(lens)} rows padded to {width}): '
          f'{100 * res["prefill_pad_share"]:.1f}% of 64-row tiles; the '
          f'tensor-core prefill skipped {100 * res["prefill_tiles_skipped"]:.1f}'
          f'% of its {PF_TILE}-row q tiles, '
          f'{100 * res["prefill_work_skipped"]:.1f}% of its work', flush=True)
    print_profiles('engine', runs, 'kernel 6')
    return res


def profile_serving(eng, reqs, new):
    return profile_window(lambda: serve(eng, reqs, new))


def profile_window(fn):
    """fn() once under torch.profiler: the window's wall time (to a
    synchronize), the device time summed over every kernel and copy, the
    kernels that took most of it, the device ms each op's own kernels
    took and how many calls of each op launched any (a call the
    selective-checkpoint cache answers launches none). The profiler adds
    host time of its own, so the busy share it gives is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, by_op, ran, n = {}, {}, {}, 0
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = (dev.get(e.name, 0.0)
                          + e.time_range.elapsed_us() / 1e3)
            n += 1
        else:      # the device time of the kernels each op launched itself
            us = e.self_device_time_total
            if us:
                by_op[e.name] = by_op.get(e.name, 0.0) + us / 1e3
                ran[e.name] = ran.get(e.name, 0) + 1
    total = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {'window_ms': wall * 1e3, 'device_ms': total,
            'busy_share': total / (wall * 1e3), 'kernels': n,
            'top': [(k[:90], v) for k, v in top], 'by_name': dev,
            'by_op': by_op, 'ops_run': ran}


def kernel_ms(prof, *names):
    """Device ms of a profiled window in the kernels whose names contain
    one of ``names`` (the port's __global__ functions)."""
    return sum(v for k, v in prof['by_name'].items()
               if any(n in k for n in names))


def phase_card_vs_cpu(gpt, GenerationEngine):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_config(gpt, num_layers=2, dtype='float32')
    gen = torch.Generator(device='cpu').manual_seed(1)
    params = gpt.init_params(cfg, gen, 'cpu')
    reqs = prompts(4, 16, 200, cfg.vocab_size, seed=1)

    # prefill logits, one prompt, both devices
    logits = {}
    for dev in ('cuda', 'cpu'):
        p = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                 if k == 'blocks' else v.to(dev)) for k, v in params.items()}
        pool = gpt.init_paged_kv_cache(cfg, 9, 128, dev)
        table = torch.arange(1, 9, dtype=torch.int32, device=dev)[None]
        t = len(reqs[0])
        cache = dict(pool, page_table=table,
                     valid=torch.tensor([t], dtype=torch.int32, device=dev))
        with torch.no_grad():
            lg, _ = gpt.forward_with_cache(
                p, torch.from_numpy(reqs[0][None]).to(dev), cache,
                torch.zeros(1, dtype=torch.int32, device=dev), cfg,
                last_only=True)
        logits[dev] = lg.float().cpu()
    if not torch.isfinite(logits['cuda']).all():
        raise AssertionError('non-finite prefill logits on the card')
    err = (logits['cuda'] - logits['cpu']).abs().max().item()
    print(f'  prefill logits card vs cpu (2 layers, f32): max abs err '
          f'{err:.3e} (tol 1e-3)', flush=True)
    if not err <= 1e-3:
        raise AssertionError(f'card and CPU prefill logits differ by {err}')

    streams = {}
    for dev in ('cuda', 'cpu'):
        eng = GenerationEngine(params, cfg, device=dev, num_slots=8,
                               page_size=128)
        try:
            streams[dev], _ = serve(eng, reqs, 8)
        finally:
            eng.shutdown()
    same = streams['cuda'] == streams['cpu']
    print(f'  greedy streams card vs cpu ({len(reqs)} requests x 8 tokens):'
          f' {"equal" if same else "DIFFERENT"}', flush=True)
    if not same:
        raise AssertionError(f'greedy streams differ: card {streams["cuda"]}'
                             f' cpu {streams["cpu"]}')
    return {'prefill_logits_max_abs_err': err, 'streams_equal': same}


# ---------------------------------------------------------------------------
# phases 6-8: dense generate(), forward() and the sliding window
# ---------------------------------------------------------------------------

def zero_launches(kernels):
    for k in kernels.values():
        k.launches = 0
        for attr in instance_counts(k):
            setattr(k, attr, 0)


def launch_counts(kernels):
    return {name: k.launches for name, k in kernels.items()}


# kernels whose every launch on a bf16 main path is tensor-core
TC_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')


def expect_tensor_core(what, kernels):
    """Every launch of kernels 1, 2 and 3 since their counters were zeroed
    took the tensor-core instance (the bf16 main paths). -> the counts."""
    got = {name: (kernels[name].tc_launches, kernels[name].launches)
           for name in TC_KERNELS}
    bad = {k: v for k, v in got.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f'{what}: CUDA-core launches of the bf16 '
                             f'path (tensor-core, all): {bad}')
    tc = {k: v[0] for k, v in got.items()}
    print(f'  tensor-core launches {what}: {tc}', flush=True)
    return tc


def expect_launches(what, got, want):
    """Every counter of ``got`` must equal ``want`` (0 where unnamed)."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f'{what}: launches {got}, want {full}')
    print(f'  launches {what}: {got}', flush=True)


def check_tokens(out, shape, vocab, what):
    if tuple(out.shape) != shape or out.dtype != torch.int32:
        raise AssertionError(f'{what}: tokens {tuple(out.shape)} '
                             f'{out.dtype}, want {shape} int32')
    if not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f'{what}: a token outside [0, {vocab})')


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cosine(a, b):
    return float((a * b).sum() / (a.norm() * b.norm()))


def generate_run(gpt, m, prompt, new, kname, kernels, card, what):
    """generate() of ``new`` greedy tokens on model ``m`` (eager or
    captured, as ``m._capture`` says) after a warm-up call that captures:
    every launch counter set to 0, then the run, its launches checked
    exactly (kernel ``kname``: 24 prefill launches on the tensor-core
    instance, 24 x (new - 1) steps on the split-K one); a second run; the
    same run in its two parts, each timed to a synchronize; a profiled
    window of 16 steps. -> (record, tokens, prefill logits)."""
    c = m.config
    b, t0 = prompt.shape
    L = c.num_layers
    mode = 'captured' if m._capture else 'eager'
    m.generate(prompt, max_new_tokens=2, temperature=0)     # warm-up
    zero_launches(kernels)
    out, wall = timed(lambda: m.generate(prompt, max_new_tokens=new,
                                         temperature=0))
    launches = launch_counts(kernels)
    check_tokens(out, (b, t0 + new), c.vocab_size, f'generate {what}')
    expect_launches(f'generate {what} {mode} (prefill + {new - 1} steps)',
                    launches, {kname: L * new})
    inst = instance_counts(kernels[kname])
    want = {'tc_launches': L, 'split_launches': L * (new - 1)}
    if inst != want:
        raise AssertionError(f'generate {what} {mode}: {kname} instances '
                             f'{inst}, want {want}')
    # once more, uncounted: how far one run's time is from the next (on
    # graphs only: an eager run takes ~4 s at full width)
    wall2 = None
    if m._capture:
        again, wall2 = timed(lambda: m.generate(prompt, max_new_tokens=new,
                                                temperature=0))
        if not torch.equal(again, out):
            raise AssertionError(f'generate {what} {mode}: a second run gave '
                                 'other tokens')
    # the same run in its two parts: the model's prefill and loop, each
    # timed to a synchronize
    entry = m._decode_entry(b, t0, 0, None, None, False)
    first, pre_s = timed(lambda: entry['prefill'].replay(
        prompt=prompt).clone())
    pos0 = torch.full((1,), t0, dtype=torch.int32, device='cuda')
    (rest, _), loop_s = timed(lambda: entry['loop'](
        entry['params'], first, pos0, entry['cache'], None, new - 1))
    if not torch.equal(torch.cat([first[:, None], rest], 1), out[:, t0:]):
        raise AssertionError(f'generate {what} {mode}: the timed prefill + '
                             'loop gave other tokens than generate()')
    # the prefill's logits, eagerly over a cache of its own
    prefill, _ = gpt.make_decode_fns(c)
    lg, _ = prefill(entry['params'], prompt, gpt.init_kv_cache(c, b, 'cuda'))
    rec = {'mode': mode, 'wall_s': wall, 'tokens_per_s': b * new / wall,
           'wall_s_second_run': wall2, 'prefill_ms': pre_s * 1e3,
           'step_ms_mean': loop_s * 1e3 / (new - 1),
           'launches': launches[kname], 'instances': inst,
           'distinct_tokens': int(out[:, t0:].unique().numel())}
    prof = rec['profile'] = profile_window(lambda: entry['loop'](
        entry['params'], first, pos0, entry['cache'], None, 16))
    prof['kernel_ms'] = kernel_ms(prof, 'split_kernel', 'attn_tile_kernel')
    again_s = '' if wall2 is None else f' (again: {wall2:.3f} s)'
    print(f'  generate {what} {mode}: {b} x {new} tokens in {wall:.3f} s'
          f'{again_s}; {rec["tokens_per_s"]:.1f} tokens/s, '
          f'prefill {rec["prefill_ms"]:.2f} ms, mean step '
          f'{rec["step_ms_mean"]:.2f} ms; {kname} instances {inst} '
          f'[{card}]', flush=True)
    return rec, out, lg.float()


def phase_generate(gpt, kernels, card):
    """generate() at full width, bf16 cache then int8 cache, each eager
    and on captured graphs."""
    cfg = bench_config(gpt)
    torch.cuda.reset_peak_memory_stats()
    model = gpt.GPTForCausalLM(cfg, device='cuda', seed=0)
    b, t0, new = 8, 128, 128
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, t0)).astype(np.int32)).cuda()
    res, prefill_logits = {}, {}
    for label, kname in (('bf16', 'flash_decode'),
                         ('int8', 'flash_decode_int8')):
        c = cfg if label == 'bf16' else bench_config(gpt, kv_cache_int8=True)
        runs, outs = {}, {}
        for mode, capture in MODES:
            m = (model if label == 'bf16' and capture else
                 gpt.GPTForCausalLM(c, model.param_dict(), device='cuda'))
            m._capture = capture
            runs[mode], outs[mode], lg = generate_run(
                gpt, m, prompt, new, kname, kernels, card,
                f'{label} cache')
            if capture:
                prefill_logits[label] = lg
            if m is not model:
                del m
            torch.cuda.empty_cache()
        if not torch.equal(outs['captured'], outs['eager']):
            raise AssertionError(f'generate {label}: captured and eager '
                                 'tokens differ')
        print(f'  generate {label} cache, captured against eager: equal '
              'tokens', flush=True)
        res[label] = dict(runs['captured'], eager=runs['eager'])
    a, c8 = prefill_logits['bf16'], prefill_logits['int8']
    cos = cosine(a, c8)
    if not (torch.isfinite(a).all() and torch.isfinite(c8).all()):
        raise AssertionError('non-finite prefill logits')
    print(f'  prefill logits int8 vs bf16 cache: cosine {cos:.6f} '
          f'(want > 0.999)', flush=True)
    if not cos > 0.999:
        raise AssertionError(f'int8 cache prefill logits cosine {cos}')
    for label in ('bf16', 'int8'):
        for mode, _ in MODES:
            r = res[label] if mode == 'captured' else res[label]['eager']
            prof = r['profile']
            print(f'  profiled 16 decode steps, {label} cache, {mode}: '
                  f'window {prof["window_ms"]:.1f} ms, device busy '
                  f'{prof["device_ms"]:.1f} ms '
                  f'({100 * prof["busy_share"]:.1f}%), {prof["kernels"]} '
                  f'kernel launches; attention {prof["kernel_ms"]:.3f} ms',
                  flush=True)
            for name, ms in prof['top']:
                print(f'    {ms:9.3f} ms  {name}', flush=True)
    res['int8_prefill_cosine'] = cos
    res['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    return model, res


def phase_forward_sliding(gpt, model, kernels, card):
    """forward() on [8, 1024], then generate() past the window."""
    cfg = model.config
    b, s = 8, cfg.max_seq_len
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    zero_launches(kernels)
    logits, fwd_s = timed(lambda: model(toks))
    fwd_launches = launch_counts(kernels)
    expect_launches('forward [8, 1024]', fwd_launches,
                    {'flash_fwd': cfg.num_layers})
    fwd_tc = expect_tensor_core('forward [8, 1024]', kernels)
    if (tuple(logits.shape) != (b, s, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f'forward logits {tuple(logits.shape)}, '
                             'finite?')
    del logits
    prof = profile_window(lambda: model(toks))
    t0, new = 1000, 32
    cached = s - t0 + 1
    # the warm-up call captures this prompt length's prefill and loop
    model.generate(toks[:, :t0], max_new_tokens=2, temperature=0)
    zero_launches(kernels)
    out, wall = timed(lambda: model.generate(toks[:, :t0], max_new_tokens=new,
                                             temperature=0))
    launches = launch_counts(kernels)
    check_tokens(out, (b, t0 + new), cfg.vocab_size, 'generate past window')
    expect_launches(f'generate T0={t0} +{new} ({cached} cached, '
                    f'{new - cached} sliding)', launches,
                    {'flash_decode': cfg.num_layers * cached,
                     'flash_fwd': cfg.num_layers * (new - cached)})
    # kernel 4: the prefill (T 1000, bf16) tensor-core, the steps split-K
    inst = instance_counts(kernels['flash_decode'])
    want = {'tc_launches': cfg.num_layers,
            'split_launches': cfg.num_layers * (cached - 1)}
    if inst != want:
        raise AssertionError(f'generate past the window: kernel 4 instances '
                             f'{inst}, want {want}')
    print(f'  kernel 4 instances past the window: {inst}', flush=True)
    slide_tc = expect_tensor_core('generate past the window', kernels)
    # one sliding step as generate() runs it, over the serving parameters
    # it already holds
    sp = model._serving_params()
    _, slide_s = timed(lambda: model._generate_sliding(
        out[:, -s:], 1, 0, None, params=sp))
    res = {'forward_ms': fwd_s * 1e3, 'wall_s': wall,
           'tokens_per_s': b * new / wall, 'sliding_step_ms': slide_s * 1e3,
           'forward_launches': fwd_launches, 'launches': launches,
           'tensor_core_launches': {'forward': fwd_tc, 'sliding': slide_tc},
           'forward_profile': prof}
    print(f'  forward [8, 1024]: {res["forward_ms"]:.2f} ms; generate '
          f'{b} x {new} past the window in {wall:.3f} s '
          f'({res["tokens_per_s"]:.1f} tokens/s), one sliding step '
          f'{res["sliding_step_ms"]:.2f} ms [{card}]', flush=True)
    print(f'  profiled forward [8, 1024]: window {prof["window_ms"]:.1f} ms, '
          f'device busy {prof["device_ms"]:.1f} ms '
          f'({100 * prof["busy_share"]:.1f}%), {prof["kernels"]} kernel '
          'launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    return res


INT8_SHARE = 0.25    # see phase_generate_card_vs_cpu


def int8_split(lg_cpu, lg_card, lg_f32, took):
    """Phase 8's rule for int8 streams that split (see
    phase_generate_card_vs_cpu): given the card's tokens ``took`` [R, new],
    the two devices' int8 logits [R, new, V] differ by at most INT8_SHARE
    of what the int8 cache itself changes (the CPU's logits over an f32
    cache, ``lg_f32``), and each card token is the CPU's best up to twice
    that difference. -> (ok, record, message)."""
    disc = (lg_cpu - lg_card).abs().max().item()
    quant = (lg_f32 - lg_cpu).abs().max().item()
    got = lg_cpu.gather(-1, took[..., None].long())[..., 0]
    gap = (lg_cpu.amax(-1) - got).max().item()
    rec = dict(teacher_forced_logit_diff=disc,
               int8_vs_f32_cache_logit_diff=quant, card_gap_under_cpu=gap)
    msg = (f"given the card's tokens the logits differ by {disc:.2e} (int8 "
           f'vs f32 cache: {quant:.2e}; tol {INT8_SHARE:g} of it) and each '
           f"card token is within {gap:.2e} of the CPU's best (<= 2 x "
           f'{disc:.2e})')
    return disc <= INT8_SHARE * quant and gap <= 2 * disc, rec, msg


def teacher_forced_logits(gpt, model, stream, t0):
    """``model``'s logits for every new token of ``stream`` given the
    stream's own prefix: one cached prefill over the stream (each row
    quantizes as the decode steps quantized it) -> [B, new, V] f32 on the
    CPU."""
    cfg = model.config
    params = gpt.serving_params(model.param_dict(), cfg)
    cache = gpt.init_kv_cache(cfg, stream.shape[0], model.device)
    zero = torch.zeros(1, dtype=torch.int32, device=model.device)
    with torch.no_grad():
        lg, _ = gpt.forward_with_cache(params, stream[:, :-1].to(
            model.device), cache, zero, cfg)
    return lg[:, t0 - 1:].float().cpu()


def phase_generate_card_vs_cpu(gpt):
    """Greedy generate() card vs CPU at 2 layers in f32 (block matrices
    x10, so streams depend on their context), and forward() logits.

    The dense and window-crossing streams must be equal. The int8 cache
    quantizes each row as it is written, and a value that lands within f32
    noise of a rounding boundary quantizes one step apart on the two
    devices (it moves by a 127th of its row's largest), so a near-tie late
    in a stream may break the other way. Where the int8 streams differ,
    both devices compute the logits of every token of the card's stream
    given its own prefix. Their largest difference must stay within
    INT8_SHARE of what the int8 cache itself changes (the CPU's logits
    with the int8 cache against the f32 cache, on the same tokens): a
    wrong int8 kernel errs by as much as the quantization or more. And
    each token the card took must be the CPU's best up to twice that
    difference, which is all a near-tie between the two can explain.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    cases = [('dense', dict(), (4, 100, 24)),
             ('int8', dict(kv_cache_int8=True), (4, 100, 24)),
             ('window', dict(max_seq_len=256), (2, 240, 24))]
    for label, over, (b, t0, new) in cases:
        cfg = bench_config(gpt, num_layers=2, dtype='float32', **over)
        params = gpt.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
        for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
            params['blocks'][k] = params['blocks'][k] * 10
        prompt = np.random.RandomState(3).randint(
            0, cfg.vocab_size, (b, t0)).astype(np.int32)
        streams, models = {}, {}
        for dev in ('cuda', 'cpu'):
            m = models[dev] = gpt.GPTForCausalLM(cfg, params, device=dev)
            streams[dev] = m.generate(torch.from_numpy(prompt),
                                      max_new_tokens=new,
                                      temperature=0).cpu()
            if label == 'window':
                toks = torch.from_numpy(np.random.RandomState(4).randint(
                    0, cfg.vocab_size, (2, cfg.max_seq_len)).astype(
                        np.int32))
                res.setdefault('logits', {})[dev] = m(toks).float().cpu()
        same = torch.equal(streams['cuda'], streams['cpu'])
        distinct = int(streams['cpu'][:, t0:].unique().numel())
        rec = {'streams_equal': same, 'distinct_tokens': distinct}
        msg = 'equal' if same else 'DIFFERENT'
        if not same and label == 'int8':
            diff = (streams['cuda'] != streams['cpu']).nonzero()[0]
            card = streams['cuda']
            lg_cpu = teacher_forced_logits(gpt, models['cpu'], card, t0)
            lg_card = teacher_forced_logits(gpt, models['cuda'], card, t0)
            f32_cache = gpt.GPTForCausalLM(
                bench_config(gpt, num_layers=2, dtype='float32'), params,
                device='cpu')
            lg_f32 = teacher_forced_logits(gpt, f32_cache, card, t0)
            same, split, msg = int8_split(lg_cpu, lg_card, lg_f32,
                                          card[:, t0:])
            rec.update(first_difference=[int(x) for x in diff], **split)
            msg = f'equal up to row {diff[0]} token {diff[1]}; ' + msg
        print(f'  greedy generate() card vs cpu, {label} ({b} x {t0} + '
              f'{new}): {msg} ({distinct} distinct new tokens)', flush=True)
        if not same:
            raise AssertionError(f'{label}: card {streams["cuda"].tolist()}'
                                 f' cpu {streams["cpu"].tolist()}')
        res[label] = rec
    lg = res.pop('logits')
    err = (lg['cuda'] - lg['cpu']).abs().max().item()
    print(f'  forward() logits card vs cpu (2 layers, f32, [2, 256]): max '
          f'abs err {err:.3e} (tol 1e-3)', flush=True)
    if not (torch.isfinite(lg['cuda']).all() and err <= 1e-3):
        raise AssertionError(f'forward logits card vs cpu differ by {err}')
    res['forward_logits_max_abs_err'] = err
    return res


# ---------------------------------------------------------------------------
# phases 9 and 10: the engine over the int8 page pool (kernel 7)
# ---------------------------------------------------------------------------

def paged_prefill_logits(gpt, params, cfg, reqs, dev, rows=None):
    """Logits of a paged prefill over a fresh pool of ``cfg``'s kind (bf16 /
    f32, or int8 banks), one slot per request padded to the longest:
    [R, 1, V] at each request's last row, or with ``rows`` (one count per
    request) the last ``rows[i]`` rows of each as [R, max rows, V] f32 on
    the CPU."""
    ps = 128
    width = max(len(r) for r in reqs)
    per = -(-cfg.max_seq_len // ps)
    pool = gpt.init_paged_kv_cache(cfg, 1 + per * len(reqs), ps, dev)
    table = (torch.arange(per * len(reqs), dtype=torch.int32, device=dev)
             .reshape(len(reqs), per) + 1)
    toks = np.zeros((len(reqs), width), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r)] = r
    valid = torch.tensor([len(r) for r in reqs], dtype=torch.int32,
                         device=dev)
    cache = dict(pool, page_table=table, valid=valid)
    with torch.no_grad():
        lg, _ = gpt.forward_with_cache(
            params, torch.from_numpy(toks).to(dev), cache,
            torch.zeros(len(reqs), dtype=torch.int32, device=dev), cfg,
            last_only=rows is None)
    if rows is None:
        return lg.float().cpu()
    n = max(rows)
    return torch.stack([lg[i, len(r) - n:len(r)].float().cpu()
                        for i, r in enumerate(reqs)])


def phase_engine_int8(gpt, GenerationEngine, kernels, card):
    """The bench GPT in GenerationEngine(kv_cache_int8=True) answering the
    requests of phase 4, eager and captured; then the prefill logits of an
    int8 pool against a bf16 pool's, both through the paged forward the
    engine runs."""
    cfg = bench_config(gpt, kv_cache_int8=True)
    params = gpt.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    reqs = prompts(8, 16, 400, cfg.vocab_size, seed=0)
    new = 32
    runs, streams = {}, {}
    for mode, capture in MODES:
        runs[mode], streams[mode] = engine_run(
            GenerationEngine, params, cfg, 'paged_decode_int8', kernels,
            reqs, new, capture, card, 'int8 engine')
    if streams['captured'] != streams['eager']:
        raise AssertionError('int8 engine: captured and eager greedy '
                             'streams differ')
    print('  int8 engine greedy streams, captured against eager: equal',
          flush=True)
    print_profiles('int8 engine', runs, 'kernel 7')
    sp = gpt.serving_params(params, cfg)
    lg8 = paged_prefill_logits(gpt, sp, cfg, reqs, 'cuda')
    lgb = paged_prefill_logits(gpt, sp, bench_config(gpt), reqs, 'cuda')
    if not (torch.isfinite(lg8).all() and torch.isfinite(lgb).all()):
        raise AssertionError('non-finite int8 / bf16 prefill logits')
    cos = cosine(lg8, lgb)
    res = dict(runs['captured'], eager=runs['eager'],
               prefill_cosine_vs_bf16=cos)
    print(f'  prefill logits int8 vs bf16 pool: cosine {cos:.6f} (want > '
          '0.999)', flush=True)
    if not cos > 0.999:
        raise AssertionError(f'int8 pool prefill logits cosine {cos}')
    return res


def phase_engine_int8_card_vs_cpu(gpt, GenerationEngine):
    """The int8 engine at 2 layers in f32 (block matrices x10, as phase 8)
    on the card and on the CPU: greedy streams equal, or where they split
    at a near-tie, held to phase 8's int8 rule on teacher-forced logits
    through the paged forward."""
    cfg = bench_config(gpt, num_layers=2, dtype='float32',
                       kv_cache_int8=True)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
    for k in ('qkv_w', 'proj_w', 'fc_w', 'out_w'):
        params['blocks'][k] = params['blocks'][k] * 10
    reqs = prompts(4, 16, 200, cfg.vocab_size, seed=1)
    new = 16
    streams = {}
    for dev in ('cuda', 'cpu'):
        eng = GenerationEngine(params, cfg, device=dev, num_slots=8,
                               page_size=128)
        try:
            streams[dev], _ = serve(eng, reqs, new)
        finally:
            eng.shutdown()
    same = streams['cuda'] == streams['cpu']
    rec = {'streams_equal': same}
    msg = 'equal'
    if not same:
        full = [np.concatenate([r, np.asarray(c[:-1], np.int32)])
                for r, c in zip(reqs, streams['cuda'])]
        rows = [new] * len(reqs)

        def tf(c, dev):
            p = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                     if k == 'blocks' else v.to(dev))
                 for k, v in params.items()}
            return paged_prefill_logits(gpt, gpt.serving_params(p, c), c,
                                        full, dev, rows)

        f32 = bench_config(gpt, num_layers=2, dtype='float32')
        took = torch.tensor(streams['cuda'])
        same, split, msg = int8_split(tf(cfg, 'cpu'), tf(cfg, 'cuda'),
                                      tf(f32, 'cpu'), took)
        rec.update(split)
        msg = 'DIFFERENT; ' + msg
    print(f'  int8 engine greedy streams card vs cpu ({len(reqs)} requests x'
          f' {new} tokens): {msg}', flush=True)
    if not same:
        raise AssertionError(f'int8 engine streams: card {streams["cuda"]} '
                             f'cpu {streams["cpu"]}')
    return rec


# ---------------------------------------------------------------------------
# phases 11 and 12: the single-device train step
# ---------------------------------------------------------------------------

PEAK_BF16 = PEAK_OPS_PER_S[torch.bfloat16]


def phase_train(gpt, topt, kernels, card):
    """The bench rung (bench.py _child_train rung 1): the bench GPT, B=8,
    S=1024, bf16 compute over f32 params, AdamW(2e-4, weight_decay=0.01),
    remat 'dots', xent_chunk 8192, targets = tokens, one numpy-seeded
    batch; 2 warm-up steps (the first counted alone), then 8 timed."""
    cfg = bench_config(gpt, remat=True, remat_policy='dots', xent_chunk=8192)
    b, s = 8, cfg.max_seq_len
    torch.cuda.reset_peak_memory_stats()
    params = gpt.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    n_params = sum(v.numel() for k, v in params.items() if k != 'blocks')
    n_params += sum(v.numel() for v in params['blocks'].values())
    opt = topt.AdamW(learning_rate=2e-4, weight_decay=0.01)
    state = opt.functional_init(params)
    step = gpt.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    losses = []

    def one():
        nonlocal params, state
        loss, params, state = step(params, state, 0, 2e-4, toks, toks)
        losses.append(loss)

    L = cfg.num_layers
    # kernel 1 runs 2 x L a step: once in the forward, once more when the
    # backward recomputes each block under remat (the reference recomputes
    # its custom call the same way); kernels 2 and 3 once a layer
    per_step = {'flash_fwd': 2 * L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    zero_launches(kernels)
    one()
    torch.cuda.synchronize()
    expect_launches('one train step', launch_counts(kernels), per_step)
    one()
    n = 8
    zero_launches(kernels)
    _, wall = timed(lambda: [one() for _ in range(n)])
    launches = launch_counts(kernels)
    expect_launches(f'{n} timed train steps', launches,
                    {k: n * v for k, v in per_step.items()})
    train_tc = expect_tensor_core(f'{n} timed train steps', kernels)
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f'non-finite train loss {vals}')
    if not vals[-1] < vals[0]:
        raise AssertionError(f'the train loss did not fall: {vals}')
    tok_s = b * s * n / wall
    prof = profile_window(one)
    attn_ms = {name: kernel_ms(prof, kern) for name, kern in (
        ('flash_fwd', 'flash_fwd_tc_kernel'),
        ('flash_bwd_dq', 'flash_bwd_dq_tc_kernel'),
        ('flash_bwd_dkv', 'flash_bwd_dkv_tc_kernel'))}
    res = {'params': n_params, 'losses': vals, 'step_ms': wall * 1e3 / n,
           'tokens_per_s': tok_s,
           'mfu': 6 * n_params * tok_s / PEAK_BF16,
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'launches': launches, 'tensor_core_launches': train_tc,
           'profile': prof, 'attention_device_ms': attn_ms}
    print(f'  train step at full width ({n_params / 1e6:.1f}M params, '
          f'[{b}, {s}], bf16, remat dots): {res["step_ms"]:.1f} ms a step, '
          f'{tok_s:.0f} tokens/s, MFU {100 * res["mfu"]:.2f}% of 989 '
          f'TFLOP/s, peak {res["peak_mem_gb"]:.2f} GB [{card}]', flush=True)
    print(f'  losses {" ".join(f"{x:.4f}" for x in vals)}', flush=True)
    print(f'  profiled step: window {prof["window_ms"]:.1f} ms, device busy '
          f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%), '
          f'{prof["kernels"]} kernel launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    print('  attention kernels in the profiled step, device ms: '
          + ', '.join(f'{k} {v:.3f}' for k, v in attn_ms.items()),
          flush=True)
    del params, state
    torch.cuda.empty_cache()
    return res


# card vs CPU train step, f32 at 2 layers: gradients and losses sum in
# other orders (cuBLAS, the kernels' tiles) but in f32 throughout
TRAIN_GRAD_TOL = 1e-3      # each gradient's largest error / its largest value
TRAIN_LOSS_TOL = 1e-4      # relative, each of 6 losses


def phase_train_card_vs_cpu(gpt, topt):
    """The train step at 2 layers in f32 (hidden 1024, vocab 32768, [2,
    256]) on the card and on the CPU, from the same weights and tokens:
    the first step's gradients and a 6-step AdamW loss curve, without
    dropout and with dropout 0.1 under the same u32 seeds."""
    res = {}
    for drop in (0.0, 0.1):
        cfg = bench_config(gpt, num_layers=2, dtype='float32',
                           max_seq_len=256, dropout=drop)
        params = gpt.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
        rng = np.random.RandomState(5)
        toks = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
        tgts = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
        seeds = [2 ** 31 + 7919 * i for i in range(7)]
        grads, curves = {}, {}
        for dev in ('cuda', 'cpu'):
            p = {k: ({bk: bv.to(dev).clone() for bk, bv in v.items()}
                     if k == 'blocks' else v.to(dev).clone())
                 for k, v in params.items()}
            t, y = (torch.from_numpy(x).to(dev) for x in (toks, tgts))
            leaves = gpt._leaves(p)
            live = [x.detach().clone().requires_grad_() for x in leaves]
            loss = gpt.loss_fn(gpt._rebuild(p, live), t, y, cfg, seeds[0])
            grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, live)]
            opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01)
            state = opt.functional_init(p)
            step = gpt.make_train_step(cfg, opt)
            curve = []
            for i in range(CURVE_STEPS):
                loss, p, state = step(p, state, seeds[i + 1], 1e-3, t, y)
                curve.append(float(loss))
            curves[dev] = curve
        g_err = max((a - b).abs().max().item() / b.abs().max().clamp_min(
            1e-30).item() for a, b in zip(grads['cuda'], grads['cpu']))
        l_err = max(abs(a - b) / abs(b) for a, b in zip(curves['cuda'],
                                                        curves['cpu']))
        ok = (g_err <= TRAIN_GRAD_TOL and l_err <= TRAIN_LOSS_TOL
              and curves['cpu'][-1] < curves['cpu'][0])
        print(f'  train card vs cpu (2 layers, f32, dropout {drop}): grads '
              f'{g_err:.2e} (tol {TRAIN_GRAD_TOL:g}), {CURVE_STEPS}-step '
              f'losses '
              f'{l_err:.2e} (tol {TRAIN_LOSS_TOL:g}): card '
              f'{" ".join(f"{x:.5f}" for x in curves["cuda"])} '
              f'{"OK" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'train card vs cpu, dropout {drop}: grads '
                                 f'{g_err}, losses {curves}')
        res[f'dropout_{drop}'] = {'grad_rel_err': g_err,
                                  'loss_rel_err': l_err, 'curves': curves}
    return res


# ---------------------------------------------------------------------------
# phases 13-16: int8 weight-only serving and the prefix cache
# ---------------------------------------------------------------------------

WO_MATS = ('qkv_w', 'proj_w', 'fc_w', 'out_w')


def tree_bytes(tree):
    """Bytes of every tensor of a parameter dict (int8 banks included)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def dequant_ms(params, cfg, cdt, iters=20):
    """Device ms of the int8 -> ``cdt`` converts one forward over the
    weight-only ``params`` runs before its products (each layer's four
    banks, and the tied embedding for the LM head: ``wo_matmul`` and
    ``wo_lm_head`` convert them whole), summed; torch.profiler."""
    from paddle_tpu_torch.ops.weight_only import kv_layer
    banks = [params['wte']] + [kv_layer(params['blocks'][k], layer)
                               for k in WO_MATS
                               for layer in range(cfg.num_layers)]

    def run(_):
        for bank in banks:
            bank['int8'].to(cdt)
    return device_ms(run, iters, warmup=1)


def phase_engine_int8_wo(gpt, GenerationEngine, kernels, card, bf16_run):
    """GenerationEngine(model, precision='int8_wo') over the bench GPT with
    phase 4's requests on its captured graphs, over the bf16 pool and then
    the int8 pool: launches exact, the served weights' bytes against the
    bf16 engine's, the full-width prefill logits' cosine against the bf16
    engine's (printed, not held: the weights are random), the device time
    of the converts a step runs, and phase 4's captured step beside it."""
    cfg = bench_config(gpt)
    model = gpt.GPTForCausalLM(cfg, device='cuda', seed=0)   # phase 4's
    reqs = prompts(8, 16, 400, cfg.vocab_size, seed=0)
    new = 32
    bf16_params = gpt.serving_params(model.param_dict(), cfg)
    bf16_bytes = tree_bytes(bf16_params)
    lg_bf16 = paged_prefill_logits(gpt, bf16_params, cfg, reqs, 'cuda')

    def inspect(eng):
        p = eng._params
        return {'weight_bytes': tree_bytes(p),
                'logits': paged_prefill_logits(gpt, p, eng.config, reqs,
                                               'cuda'),
                'dequant_ms': dequant_ms(p, eng.config,
                                         gpt.torch_dtype(eng.config.dtype))}

    res = {'bf16_weight_bytes': bf16_bytes,
           'bf16_engine_step_ms': bf16_run['step_ms_mean'],
           'bf16_engine_tokens_per_s': bf16_run['tokens_per_s'],
           'bf16_engine_window_device_ms': bf16_run['profile']['device_ms']}
    for label, kname, c, net in (
            ('bf16 pool', 'paged_decode', None, model),
            ('int8 pool', 'paged_decode_int8',
             bench_config(gpt, kv_cache_int8=True), model.param_dict())):
        r, _ = engine_run(GenerationEngine, net, c, kname, kernels, reqs, new,
                          True, card, f'int8_wo engine, {label}',
                          inspect=inspect, precision='int8_wo')
        info = r.pop('inspect')
        lg = info.pop('logits')
        if not torch.isfinite(lg).all():
            raise AssertionError(f'int8_wo engine, {label}: non-finite '
                                 'prefill logits')
        r.update(info, prefill_cosine_vs_bf16=cosine(lg, lg_bf16))
        prof = r['profile']
        print(f'  int8_wo engine, {label}: served weights '
              f'{info["weight_bytes"] / 1e6:.1f} MB against the bf16 '
              f"engine's {bf16_bytes / 1e6:.1f} MB; prefill logits cosine "
              f'against the bf16 engine {r["prefill_cosine_vs_bf16"]:.6f} '
              f'(printed only); int8 -> bf16 converts of one step '
              f'{info["dequant_ms"]:.3f} ms device; mean step '
              f'{r["step_ms_mean"]:.3f} ms (bf16 engine, phase 4: '
              f'{bf16_run["step_ms_mean"]:.3f} ms); profiled rerun device '
              f'{prof["device_ms"]:.1f} ms of {prof["window_ms"]:.1f} ms '
              f'(bf16 engine: {bf16_run["profile"]["device_ms"]:.1f} ms) '
              f'[{card}]', flush=True)
        for name, ms in prof['top']:
            print(f'    {ms:9.3f} ms  {name}', flush=True)
        res['int8_pool' if 'int8' in label else 'bf16_pool'] = r
    del model
    torch.cuda.empty_cache()
    return res


def phase_generate_int8_wo(gpt, kernels, card):
    """generate() after enable_int8_decode() at phase 6's shape, bf16 then
    int8 cache, on captured graphs; then a re-snapshot after an in-place
    weight change, and generate() past the window over the int8 weights
    (kernel 1 on the sliding steps)."""
    cfg = bench_config(gpt)
    model = gpt.GPTForCausalLM(cfg, device='cuda', seed=0)
    b, t0, new = 8, 128, 128
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, t0)).astype(np.int32)).cuda()
    res, outs = {}, {}
    for label, kname in (('bf16', 'flash_decode'),
                         ('int8', 'flash_decode_int8')):
        m = (model if label == 'bf16' else gpt.GPTForCausalLM(
            bench_config(gpt, kv_cache_int8=True), model.param_dict(),
            device='cuda'))
        m.enable_int8_decode()
        res[label], outs[label], _ = generate_run(
            gpt, m, prompt, new, kname, kernels, card,
            f'int8 weights, {label} cache')
        prof = res[label]['profile']
        print(f'  profiled 16 decode steps, int8 weights, {label} cache: '
              f'window {prof["window_ms"]:.1f} ms, device busy '
              f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%)'
              f'; attention {prof["kernel_ms"]:.3f} ms', flush=True)
        for name, ms in prof['top']:
            print(f'    {ms:9.3f} ms  {name}', flush=True)
        if m is not model:
            del m
        torch.cuda.empty_cache()
    res['weight_bytes'] = tree_bytes(model._serving_params())

    # a re-snapshot: the weights change in place (a block matrix, and the
    # final LayerNorm's bias moved along one token's embedding, so that the
    # new weights pick that token every step); the frozen snapshot keeps the
    # old tokens until enable_int8_decode() takes a new one
    n, target = 16, 1234
    snap = model._decode_params()
    with torch.no_grad():
        model.blocks.fc_w.mul_(-1.0)
        w = model.wte[target]
        model.lnf_b.add_(w * (50.0 / w.square().sum()))
    frozen = model.generate(prompt, max_new_tokens=n, temperature=0)
    if not torch.equal(frozen, outs['bf16'][:, :t0 + n]):
        raise AssertionError('int8 decode: the frozen snapshot changed its '
                             'tokens after an in-place weight change')
    model.enable_int8_decode()
    fresh = model.generate(prompt, max_new_tokens=n, temperature=0)
    ref = gpt.GPTForCausalLM(cfg, model.param_dict(), device='cuda')
    want = ref.enable_int8_decode().generate(prompt, max_new_tokens=n,
                                             temperature=0)
    del ref
    ok = (model._decode_params() is not snap and torch.equal(fresh, want)
          and bool((fresh[:, t0:] == target).all())
          and not bool((frozen[:, t0:] == target).all()))
    print(f'  int8 decode re-snapshot after an in-place weight change: the '
          f'frozen snapshot kept its tokens; a new snapshot, whose tokens '
          f'are those of a fresh model over the new weights (all {target}): '
          f'{"OK" if ok else "FAIL"}', flush=True)
    if not ok:
        raise AssertionError('int8 decode re-snapshot: stale graph or '
                             'snapshot')
    res['resnapshot_ok'] = ok

    # past the window over the int8 weights: 25 cached steps, 7 sliding
    s = cfg.max_seq_len
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, (b, 1000)).astype(np.int32)).cuda()
    cached, more = s - 1000 + 1, 32
    model.generate(toks, max_new_tokens=2, temperature=0)     # captures
    zero_launches(kernels)
    out, wall = timed(lambda: model.generate(toks, max_new_tokens=more,
                                             temperature=0))
    launches = launch_counts(kernels)
    check_tokens(out, (b, 1000 + more), cfg.vocab_size,
                 'int8 weights past the window')
    L = cfg.num_layers
    expect_launches(f'int8 weights, generate T0=1000 +{more} ({cached} '
                    f'cached, {more - cached} sliding)', launches,
                    {'flash_decode': L * cached,
                     'flash_fwd': L * (more - cached)})
    expect_tensor_core('int8 weights past the window', kernels)
    res['window'] = {'wall_s': wall, 'tokens_per_s': b * more / wall,
                     'launches': launches}
    print(f'  int8 weights, generate {b} x {more} past the window in '
          f'{wall:.3f} s ({b * more / wall:.1f} tokens/s) [{card}]',
          flush=True)
    del model
    torch.cuda.empty_cache()
    return res


# the prefix cache at full width: tools/prefix_cache_check.py's workload and
# gates, at the bench GPT's size
PFX_SYSTEM = 640        # shared system prompt: 5 full pages of 128
PFX_REQUESTS = 12
PFX_NEW = 32
PFX_TURNS = 8
PFX_USER = 48           # turn 2's new user tokens
SKIP_FLOOR = 0.70       # warm wave: share of prompt tokens not prefilled
TTFT_RATIO_MAX = 0.25   # warm TTFT p99 over cold TTFT p99


def p99(xs):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))]


def wave(eng, reqs, tenant='default', new=PFX_NEW):
    """Submit each (prompt, seed) after the previous one's stream ended,
    as tools/prefix_cache_check.py does. -> (streams, TTFTs ms: submit to
    the first streamed token)."""
    streams, ttfts = [], []
    for p, seed in reqs:
        t0 = time.perf_counter()
        it = eng.submit(p, max_new_tokens=new, seed=seed,
                        tenant=tenant).stream(timeout=600)
        first = next(it)
        ttfts.append((time.perf_counter() - t0) * 1e3)
        streams.append([first] + list(it))
    return streams, ttfts


def bf16_ulps(x, n=2):
    """n bfloat16 rounding steps at the size of |x|'s largest element."""
    top = float(x.abs().max())
    return n * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def near_ties(gpt, params, cfg, reqs, got, want):
    """Where a cache-on stream ``got`` leaves the cache-off stream ``want``
    (multi-turn: the reused rows were written by decode steps, the cache-off
    engine writes them in its prefill, and bf16 rounds the two apart), the
    two tokens at the first difference must be a near-tie: their logits
    within two bf16 rounding steps at that row's largest logit, in a
    cache-off prefill over the common prefix. -> (ok, [(request, index,
    gap, limit)])."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        prefix = np.concatenate([reqs[i][0], np.asarray(b[:j], np.int32)])
        lg = paged_prefill_logits(gpt, params, cfg, [prefix], 'cuda')[0, 0]
        gap = abs(float(lg[b[j]]) - float(lg[a[j]]))
        out.append((i, j, gap, bf16_ulps(lg)))
    return all(g <= lim for _, _, g, lim in out), out


def phase_prefix_cache(gpt, GenerationEngine, kernels, card):
    """The prefix cache at full width (8 slots, page 128, numpy seed 0):
    tools/prefix_cache_check.py's shared-system-prompt waves (cold, warm,
    and the cold wave on a cache-off engine) and multi-turn conversations
    over the bf16 pool, then the waves again over the int8 pool; the
    reference tool's gates, exact launches, two captures throughout."""
    rng = np.random.RandomState(0)
    cfg = bench_config(gpt)
    vocab = cfg.vocab_size
    system = rng.randint(1, vocab, PFX_SYSTEM).astype(np.int32)
    shared = [(np.concatenate([system, rng.randint(
        1, vocab, int(n)).astype(np.int32)]), i)
        for i, n in enumerate(rng.randint(64, 256, PFX_REQUESTS))]
    turn1 = [(rng.randint(1, vocab, int(n)).astype(np.int32), 100 + i)
             for i, n in enumerate(rng.randint(200, 501, PFX_TURNS))]
    users = [rng.randint(1, vocab, PFX_USER).astype(np.int32)
             for _ in range(PFX_TURNS)]
    params = gpt.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    L = cfg.num_layers
    res = {}
    for label, kname, c in (('bf16', 'paged_decode', cfg),
                            ('int8', 'paged_decode_int8',
                             bench_config(gpt, kv_cache_int8=True))):
        what = f'prefix cache, {label} pool'
        off = GenerationEngine(params, c, num_slots=8, page_size=128)
        on = GenerationEngine(params, c, num_slots=8, page_size=128,
                              prefix_cache=True)
        try:
            off.warmup()
            on.warmup()
            traces = [on._trace_count]
            # the cache-off engine first: the reference streams
            want, off_ttft = wave(off, shared)
            if label == 'bf16':
                # multi-turn: turn 2 = turn 1's prompt + its 32 tokens + a
                # new user turn; on the cache-on engine its cached rows end
                # mid-page
                t1_off, _ = wave(off, turn1)
                turn2 = [(np.concatenate([p, np.asarray(g, np.int32), u]), s)
                         for (p, s), g, u in zip(turn1, t1_off, users)]
                t2_off, t2_off_ttft = wave(off, turn2)
            zero_launches(kernels)
            cold, cold_ttft = wave(on, shared)
            mid = on.stats()
            traces.append(on._trace_count)
            warm, warm_ttft = wave(on, shared)
            st = on.stats()
            traces.append(on._trace_count)
            rec = {'cold_ttft_ms_p50': float(np.median(cold_ttft)),
                   'cold_ttft_ms_p99': p99(cold_ttft),
                   'warm_ttft_ms_p50': float(np.median(warm_ttft)),
                   'warm_ttft_ms_p99': p99(warm_ttft),
                   'off_ttft_ms_p50': float(np.median(off_ttft)),
                   'off_ttft_ms_p99': p99(off_ttft)}
            saved = st['prefix_tokens_saved'] - mid['prefix_tokens_saved']
            rec['warm_skipped_share'] = saved / sum(len(p) for p, _ in shared)
            rec['cold_skipped_share'] = (mid['prefix_tokens_saved']
                                         / sum(len(p) for p, _ in shared))
            rec['ttft_ratio'] = rec['warm_ttft_ms_p99'] / rec['cold_ttft_ms_p99']
            rec['warm_full_hits'] = (st['prefix_full_hits']
                                     - mid['prefix_full_hits'])
            if label == 'bf16':
                t1_on, _ = wave(on, turn1)
                before = on.stats()
                t2_on, t2_ttft = wave(on, turn2)
                after = on.stats()
                traces.append(on._trace_count)
            # tenants: the same prompt under two tenants, disjoint pages
            a, _ = wave(on, [shared[0]], tenant='alpha')
            b, _ = wave(on, [shared[0]], tenant='beta')
            pages = on.prefix_cache.debug_pages()
            overlap = len(set(pages.get('alpha', ())) & set(pages.get('beta', ())))
            torch.cuda.synchronize()
            counts = launch_counts(kernels)
            k = kernels[kname]
            inst = {'tensor-core': k.tc_launches, 'split-k': k.split_launches}
            fin = on.stats()
            traces.append(on._trace_count)
            on.clear_prefix_cache()
            leaked = (on.num_pages - 1) - on._alloc.free_pages
        finally:
            on.shutdown()
            off.shutdown()
        rec.update(prefills=fin['prefills'], steps=fin['steps'],
                   launches=counts[kname], instances=inst, traces=traces,
                   cross_tenant_shared_pages=overlap, pages_leaked=leaked,
                   prefix=fin['prefix'])
        if label == 'bf16':
            # (after the launches are read: near_ties runs prefills of its
            # own)
            ties_ok, ties = near_ties(gpt, on._params, c, turn2, t2_on,
                                      t2_off)
            starts = [len(p) + PFX_NEW - 1 for p, _ in turn1]
            mt = rec['multi_turn'] = {
                'turn1_equal': t1_on == t1_off,
                'turn2_equal': t2_on == t2_off, 'near_ties': ties,
                'tokens_saved': (after['prefix_tokens_saved']
                                 - before['prefix_tokens_saved']),
                'starts': starts,
                'mid_page_starts': sum(x % 128 != 0 for x in starts),
                'turn2_ttft_ms_p50': float(np.median(t2_ttft)),
                'turn2_off_ttft_ms_p50': float(np.median(t2_off_ttft))}
            split = ('equal' if mt['turn2_equal']
                     else f'split only at near-ties {ties}')
            print(f'  {what}, multi-turn ({PFX_TURNS} conversations, turn 2 '
                  f'starts {starts}, {mt["mid_page_starts"]} mid-page): turn '
                  f'1 cache-on vs cache-off equal {mt["turn1_equal"]}; turn 2 '
                  f'{split}; {mt["tokens_saved"]} prompt tokens reused; turn '
                  f'2 TTFT p50 {mt["turn2_ttft_ms_p50"]:.2f} ms (cache off '
                  f'{mt["turn2_off_ttft_ms_p50"]:.2f})', flush=True)
            if not (mt['turn1_equal'] and ties_ok):
                raise AssertionError(f'{what}: multi-turn streams {mt}')
            if mt['tokens_saved'] != sum(starts):
                raise AssertionError(f'{what}: turn 2 reused '
                                     f'{mt["tokens_saved"]} tokens, want '
                                     f'{sum(starts)}')
        expect_launches(f'{what} ({fin["prefills"]} device prefills + '
                        f'{fin["steps"]} steps)', counts,
                        {kname: L * (fin['prefills'] + fin['steps'])})
        want_inst = {'tensor-core': L * fin['prefills'],
                     'split-k': L * fin['steps']}
        checks = {
            'cache-on cold == cache-off': cold == want,
            'warm == cold': warm == cold,
            'tenants stream the same': a[0] == b[0] == want[0],
            f'warm prefill tokens skipped >= {SKIP_FLOOR:.0%}':
                rec['warm_skipped_share'] >= SKIP_FLOOR,
            f'warm TTFT p99 <= {TTFT_RATIO_MAX} x cold':
                rec['ttft_ratio'] <= TTFT_RATIO_MAX,
            'every warm request a full hit':
                rec['warm_full_hits'] == PFX_REQUESTS,
            '_trace_count 2 throughout': set(traces) == {2},
            'no page shared across tenants': overlap == 0,
            'no page leaked after drain + clear': leaked == 0,
            'instances': inst == want_inst,
        }
        rec['checks'] = checks
        print(f'  {what}: cold TTFT p50/p99 {rec["cold_ttft_ms_p50"]:.2f}/'
              f'{rec["cold_ttft_ms_p99"]:.2f} ms, warm '
              f'{rec["warm_ttft_ms_p50"]:.2f}/{rec["warm_ttft_ms_p99"]:.2f} '
              f'ms, cache off {rec["off_ttft_ms_p50"]:.2f}/'
              f'{rec["off_ttft_ms_p99"]:.2f} ms (ratio {rec["ttft_ratio"]:.4f}'
              f'); prompt tokens skipped cold {rec["cold_skipped_share"]:.1%},'
              f' warm {rec["warm_skipped_share"]:.1%}; {kname} instances '
              f'{inst} [{card}]', flush=True)
        bad = [name for name, ok in checks.items() if not ok]
        print(f'  {what} checks: ' + ('all hold' if not bad else
                                      'FAILED ' + ', '.join(bad)), flush=True)
        if bad:
            raise AssertionError(f'{what}: {bad} ({rec})')
        res[label] = rec
    del params
    torch.cuda.empty_cache()
    return res


def phase_slice_card_vs_cpu(gpt, GenerationEngine):
    """This slice's paths at 2 layers in f32 (block matrices x10, as phases
    8 and 10) on the card and on the CPU: the int8_wo engine's and int8
    generate()'s greedy streams equal, and a prefix-cache engine's cold and
    warm waves equal the CPU's."""
    cfg = bench_config(gpt, num_layers=2, dtype='float32')
    params = gpt.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
    for k in WO_MATS:
        params['blocks'][k] = params['blocks'][k] * 10
    reqs = prompts(4, 16, 200, cfg.vocab_size, seed=1)
    rng = np.random.RandomState(4)
    head = rng.randint(1, cfg.vocab_size, 256).astype(np.int32)
    shared = [(np.concatenate([head, rng.randint(
        1, cfg.vocab_size, int(n)).astype(np.int32)]), i)
        for i, n in enumerate(rng.randint(16, 100, 4))]
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 100)).astype(np.int32))
    out = {}
    for dev in ('cuda', 'cpu'):
        p = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                 if k == 'blocks' else v.to(dev)) for k, v in params.items()}
        eng = GenerationEngine(p, cfg, device=dev, num_slots=8, page_size=128,
                               precision='int8_wo')
        try:
            wo, _ = serve(eng, reqs, 8)
        finally:
            eng.shutdown()
        m = gpt.GPTForCausalLM(cfg, p, device=dev).enable_int8_decode()
        gen = m.generate(prompt, max_new_tokens=16, temperature=0).cpu()
        eng = GenerationEngine(p, cfg, device=dev, num_slots=8, page_size=128,
                               prefix_cache=True)
        try:
            cold, _ = wave(eng, shared, new=8)
            warm, _ = wave(eng, shared, new=8)
            hits = eng.stats()['prefix_full_hits']
        finally:
            eng.shutdown()
        out[dev] = {'int8_wo': wo, 'generate': gen, 'cold': cold,
                    'warm': warm, 'full_hits': hits}
    c, h = out['cuda'], out['cpu']
    res = {'int8_wo_engine_equal': c['int8_wo'] == h['int8_wo'],
           'int8_generate_equal': bool(torch.equal(c['generate'],
                                                   h['generate'])),
           'prefix_cold_equal': c['cold'] == h['cold'],
           'prefix_warm_equal': c['warm'] == h['warm'] == h['cold'],
           'full_hits': [c['full_hits'], h['full_hits']]}
    print(f'  card vs cpu (2 layers, f32): int8_wo engine streams '
          f'{res["int8_wo_engine_equal"]}, int8 generate() '
          f'{res["int8_generate_equal"]}, prefix cache cold '
          f'{res["prefix_cold_equal"]}, warm {res["prefix_warm_equal"]} '
          f'(full hits card/cpu {res["full_hits"]})', flush=True)
    if not all(v for k, v in res.items() if k != 'full_hits'):
        raise AssertionError(f'card vs cpu, this slice: {res}')
    return res

# ---------------------------------------------------------------------------
# phases 17-19: the MoE GPT (models/moe_gpt.py) at MoEConfig()'s width
# ---------------------------------------------------------------------------

def moe_active_params(params, cfg):
    """Parameters a token's forward multiplies by: attention, norms,
    embeddings and 2 of the E experts' banks (the router not counted)."""
    blocks = params['blocks']
    total = sum(v.numel() for k, v in params.items() if k != 'blocks')
    total += sum(v.numel() for k, v in blocks.items()
                 if k not in ('gate_w', 'w_in', 'w_out'))
    experts = blocks['w_in'].numel() + blocks['w_out'].numel()
    return total + experts * 2 // cfg.n_experts


def moe_generate_run(moe, params, cfg, prompt, new, kname, kernels, capture,
                     card, what):
    """moe_gpt.generate() of ``new`` greedy tokens (eager or on graphs)
    after a warm-up call: every launch counter set to 0, the run, its
    launches checked exactly (kernel ``kname``: L prefill launches on the
    tensor-core instance, L x (new - 1) steps on the split-K one).
    -> (record, tokens)."""
    b, t0 = prompt.shape
    L = cfg.num_layers
    mode = 'captured' if capture else 'eager'
    moe.generate(params, cfg, prompt, 2, capture=capture)      # warm-up
    zero_launches(kernels)
    out, wall = timed(lambda: moe.generate(params, cfg, prompt, new,
                                           capture=capture))
    launches = launch_counts(kernels)
    check_tokens(out, (b, t0 + new), cfg.vocab_size, f'moe generate {what}')
    expect_launches(f'moe generate {what} {mode} (prefill + {new - 1} '
                    'steps)', launches, {kname: L * new})
    inst = instance_counts(kernels[kname])
    want = {'tc_launches': L, 'split_launches': L * (new - 1)}
    if inst != want:
        raise AssertionError(f'moe generate {what} {mode}: {kname} '
                             f'instances {inst}, want {want}')
    rec = {'mode': mode, 'wall_s': wall, 'tokens_per_s': b * new / wall,
           'launches': launches[kname], 'instances': inst,
           'distinct_tokens': int(out[:, t0:].unique().numel())}
    print(f'  moe generate {what} {mode}: {b} x {new} tokens in {wall:.3f} s;'
          f' {rec["tokens_per_s"]:.1f} tokens/s; {kname} instances {inst} '
          f'[{card}]', flush=True)
    return rec, out


def phase_moe_serving(moe, GenerationEngine, kernels, card):
    """MoEConfig()'s full width (vocab 50304, hidden 768, 12 layers, 12
    heads, 8 experts, bf16 over f32 params, random weights from a seed) in
    GenerationEngine((params, cfg), num_slots=8, page_size=128) with phase
    4's requests: eager, then on its two captured graphs, streams equal;
    over the bf16 pool, the int8 pool and with precision='int8_wo'. Then
    moe_gpt.generate() at B=8, T0=128, 128 greedy tokens, bf16 and int8
    cache, captured and eager, tokens equal."""
    from paddle_tpu_torch.models.decode_cache import clear_decode_caches
    cfg = moe.MoEConfig(num_layers=MOE_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = moe.init_params(cfg, torch.Generator(device='cuda').manual_seed(
        0), 'cuda')
    n_params = tree_bytes(params) // 4
    reqs = prompts(8, 16, 400, 32768, seed=0)       # phase 4's requests
    new = 32
    res = {'params': n_params, 'active_params': moe_active_params(params,
                                                                  cfg)}
    for label, kname, c, kw in (
            ('bf16 pool', 'paged_decode', cfg, {}),
            ('int8 pool', 'paged_decode_int8',
             dataclasses.replace(cfg, kv_cache_int8=True), {}),
            ('int8_wo', 'paged_decode', cfg, {'precision': 'int8_wo'})):
        runs, streams = {}, {}
        for mode, capture in MODES:
            runs[mode], streams[mode] = engine_run(
                GenerationEngine, params, c, kname, kernels, reqs, new,
                capture, card, f'moe engine {label} '
                f'({n_params / 1e6:.1f}M params)', hold=True, **kw)
            torch.cuda.empty_cache()
        if streams['captured'] != streams['eager']:
            raise AssertionError(f'moe engine {label}: captured and eager '
                                 'greedy streams differ')
        print(f'  moe engine {label} greedy streams, captured against eager:'
              ' equal', flush=True)
        print_profiles(f'moe engine {label}', runs, kname)
        res[label] = dict(runs['captured'], eager=runs['eager'])
    b, t0, gnew = 8, 128, 128
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, t0)).astype(np.int32)).cuda()
    for label, kname, c in (
            ('bf16 cache', 'flash_decode', cfg),
            ('int8 cache', 'flash_decode_int8',
             dataclasses.replace(cfg, kv_cache_int8=True))):
        runs, outs = {}, {}
        for mode, capture in reversed(MODES):
            runs[mode], outs[mode] = moe_generate_run(
                moe, params, c, prompt, gnew, kname, kernels, capture, card,
                label)
        if not torch.equal(outs['captured'], outs['eager']):
            raise AssertionError(f'moe generate {label}: captured and eager '
                                 'tokens differ')
        print(f'  moe generate {label}, captured against eager: equal '
              'tokens', flush=True)
        res[f'generate {label}'] = dict(runs['captured'],
                                        eager=runs['eager'])
        clear_decode_caches()
        torch.cuda.empty_cache()
    res['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return res


def phase_moe_train(moe, topt, kernels, card):
    """moe_gpt.make_train_step at MoEConfig()'s width: [8, 1024], bf16
    over f32 params, AdamW(2e-4, weight_decay=0.01), remat on (the whole
    block), dropout 0, targets = tokens, one numpy-seeded batch; 2 warm-up
    steps (the first counted alone), then 6 timed. 50304 is not a
    multiple of xent_chunk 8192, so the loss takes the full-logits
    branch, as the reference's."""
    cfg = moe.MoEConfig(remat=True)
    b, s = 8, cfg.max_seq_len
    torch.cuda.reset_peak_memory_stats()
    params = moe.init_params(cfg, torch.Generator(device='cuda').manual_seed(
        0), 'cuda')
    n_active = moe_active_params(params, cfg)
    opt = topt.AdamW(learning_rate=2e-4, weight_decay=0.01)
    state = opt.functional_init(params)
    step = moe.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    losses = []

    def one():
        nonlocal params, state
        loss, params, state = step(params, state, 0, 2e-4, toks, toks)
        losses.append(loss)

    L = cfg.num_layers
    per_step = {'flash_fwd': 2 * L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    zero_launches(kernels)
    one()
    torch.cuda.synchronize()
    expect_launches('one moe train step', launch_counts(kernels), per_step)
    one()
    n = 6
    zero_launches(kernels)
    _, wall = timed(lambda: [one() for _ in range(n)])
    launches = launch_counts(kernels)
    expect_launches(f'{n} timed moe train steps', launches,
                    {k: n * v for k, v in per_step.items()})
    tc = expect_tensor_core(f'{n} timed moe train steps', kernels)
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f'non-finite moe train loss {vals}')
    if not vals[-1] < vals[0]:
        raise AssertionError(f'the moe train loss did not fall: {vals}')
    tok_s = b * s * n / wall
    prof = profile_window(one)
    res = {'active_params': n_active, 'losses': vals,
           'step_ms': wall * 1e3 / n, 'tokens_per_s': tok_s,
           'mfu': 6 * n_active * tok_s / PEAK_BF16,
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'launches': launches, 'tensor_core_launches': tc,
           'profile': prof}
    print(f'  moe train step at full width ({n_active / 1e6:.1f}M active '
          f'params, [{b}, {s}], bf16, remat): {res["step_ms"]:.1f} ms a '
          f'step, {tok_s:.0f} tokens/s, MFU {100 * res["mfu"]:.2f}% of 989 '
          f'TFLOP/s, peak {res["peak_mem_gb"]:.2f} GB [{card}]', flush=True)
    print(f'  losses {" ".join(f"{x:.4f}" for x in vals)}', flush=True)
    print(f'  profiled step: window {prof["window_ms"]:.1f} ms, device busy '
          f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%), '
          f'{prof["kernels"]} kernel launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    del params, state
    torch.cuda.empty_cache()
    return res


MOE_FFN_TOL = 1e-5      # gather form vs einsum twin, f32, over max |y|


def phase_moe_card_vs_cpu(moe, GenerationEngine, topt):
    """MoE at 2 layers in f32 (MoEConfig()'s widths, block matrices x4)
    on the card and on the CPU: engine streams equal at the default
    capacity with prompts that fill the prefill width and with ragged
    prompts at capacity factor 8, generate() streams equal, the first
    train step's gradients and a 6-step loss curve within phase 12's
    tolerances; then the gather-form moe_ffn on the card against the
    einsum twin on the card at the train shape."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import moe as pmoe
    cfg = moe.MoEConfig(num_layers=2, dtype='float32')
    params = moe.init_params(cfg, torch.Generator().manual_seed(2), 'cpu')
    for k in ('qkv_w', 'proj_w', 'w_in', 'w_out'):
        params['blocks'][k] = params['blocks'][k] * 4
    full = prompts(4, 128, 128, cfg.vocab_size, seed=5)
    ragged = prompts(4, 16, 200, cfg.vocab_size, seed=1)
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 100)).astype(np.int32))
    wide = dataclasses.replace(cfg, capacity_factor=8.0)
    out = {}
    for dev in ('cuda', 'cpu'):
        p = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                 if k == 'blocks' else v.to(dev)) for k, v in params.items()}
        eng = GenerationEngine(p, cfg, device=dev, num_slots=8, page_size=128,
                               prefill_width=128, autostart=False)
        try:
            a, _ = serve(eng, full, 8, hold=True)
        finally:
            eng.shutdown()
        eng = GenerationEngine(p, wide, device=dev, num_slots=8,
                               page_size=128, autostart=False)
        try:
            bb, _ = serve(eng, ragged, 8, hold=True)
        finally:
            eng.shutdown()
        gen = moe.generate(p, cfg, prompt.to(dev), 16).cpu()
        out[dev] = {'a': a, 'b': bb, 'generate': gen}
    c, h = out['cuda'], out['cpu']
    res = {'engine_full_width_cf1.25_equal': c['a'] == h['a'],
           'engine_ragged_cf8_equal': c['b'] == h['b'],
           'generate_equal': bool(torch.equal(c['generate'],
                                              h['generate']))}
    print(f'  moe card vs cpu (2 layers, f32): engine (a) '
          f'{res["engine_full_width_cf1.25_equal"]}, (b) '
          f'{res["engine_ragged_cf8_equal"]}, generate() '
          f'{res["generate_equal"]}', flush=True)
    if not all(res.values()):
        raise AssertionError(f'moe card vs cpu streams: {res}')

    # the train step: gradients of the first, then a 6-step curve
    tcfg = dataclasses.replace(cfg, max_seq_len=256)
    tparams = moe.init_params(tcfg, torch.Generator().manual_seed(3), 'cpu')
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    tgts = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    grads, curves = {}, {}
    for dev in ('cuda', 'cpu'):
        p = {k: ({bk: bv.to(dev).clone() for bk, bv in v.items()}
                 if k == 'blocks' else v.to(dev).clone())
             for k, v in tparams.items()}
        t, y = (torch.from_numpy(x).to(dev) for x in (toks, tgts))
        live = [x.detach().clone().requires_grad_() for x in gpt._leaves(p)]
        loss = moe.loss_fn(gpt._rebuild(p, live), t, y, tcfg)
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, live)]
        opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01)
        state = opt.functional_init(p)
        step = moe.make_train_step(tcfg, opt)
        curve = []
        for i in range(CURVE_STEPS):
            loss, p, state = step(p, state, 0, 1e-3, t, y)
            curve.append(float(loss))
        curves[dev] = curve
    g_err = max((a - b).abs().max().item() / b.abs().max().clamp_min(
        1e-30).item() for a, b in zip(grads['cuda'], grads['cpu']))
    l_err = max(abs(a - b) / abs(b) for a, b in zip(curves['cuda'],
                                                    curves['cpu']))
    ok = (g_err <= TRAIN_GRAD_TOL and l_err <= TRAIN_LOSS_TOL
          and curves['cpu'][-1] < curves['cpu'][0])
    print(f'  moe train card vs cpu (2 layers, f32): grads {g_err:.2e} (tol '
          f'{TRAIN_GRAD_TOL:g}), {CURVE_STEPS}-step losses {l_err:.2e} '
          f'(tol '
          f'{TRAIN_LOSS_TOL:g}): card '
          f'{" ".join(f"{x:.5f}" for x in curves["cuda"])} '
          f'{"OK" if ok else "FAIL"}', flush=True)
    if not ok:
        raise AssertionError(f'moe train card vs cpu: grads {g_err}, losses '
                             f'{curves}')
    res.update(grad_rel_err=g_err, loss_rel_err=l_err, curves=curves)

    # the gather form against the reference's einsum form, on the card, at
    # the train step's [8, 1024] rows, f32
    g = torch.Generator(device='cuda').manual_seed(4)
    bp = {k: v[0].cuda() for k, v in params['blocks'].items()}
    x = torch.randn((8, 1024, cfg.hidden_size), generator=g, device='cuda')
    args = (x, bp['gate_w'], bp['w_in'], bp['w_out'], cfg.capacity_factor)
    y, aux = pmoe.moe_ffn(*args)
    ey, eaux = pmoe.moe_ffn_einsum(*args)
    err = ((y - ey).abs().max() / ey.abs().max()).item()
    aerr = abs(aux.item() - eaux.item())
    print(f'  moe_ffn gather form vs einsum twin on the card ([8, 1024] rows, '
          f'f32): {err:.2e} of max |y| (tol {MOE_FFN_TOL:g}), aux {aerr:.1e}',
          flush=True)
    if not (err <= MOE_FFN_TOL and aerr <= 1e-6):
        raise AssertionError(f'moe_ffn gather vs einsum on the card: {err}, '
                             f'aux {aerr}')
    res.update(moe_ffn_rel_err=err, moe_ffn_aux_err=aerr)
    return res


# ---------------------------------------------------------------------------
# phase 20: the eager Paddle API on the card
# ---------------------------------------------------------------------------
EAGER_ITERS = 300                  # bench.py _child_eager's chain length
MLP = dict(hidden=1024, ffn=4096, rows=8192)   # the bench GPT's MLP widths
MLP_LR = 2.0
MLP_STEPS = 10


def eager_op_sweep(paddle, cases):
    """Every case of tests/torch_op_cases.py (the table the CPU tests hold
    against the JAX package) through the port on the card and on the CPU:
    integer and bool outputs equal, f32 within the case's tolerance
    (elementwise 1e-5 / 1e-6, reductions, matmul and linalg 1e-4); then
    every random op on the card: dtype, range and moments of 10^5 draws,
    and the same values again under the same seed."""
    worst = {'ew': 0.0, 'red': 0.0}
    for c in cases.C:
        paddle.set_device('gpu')
        card = cases.flatten(c.run(paddle))
        paddle.set_device('cpu')
        host = cases.flatten(c.run(paddle))
        try:
            worst[c.kind] = max(worst[c.kind], cases.compare(c, card, host))
        except AssertionError as e:
            raise AssertionError(f'phase 20 case {c.name}: card vs CPU: '
                                 f'{e}') from None
    paddle.set_device('gpu')
    for name, (call, *_) in cases.RANDOM.items():
        paddle.seed(5)
        first = cases.check_random(name, call(paddle))
        if first._value.device.type != 'cuda':
            raise AssertionError(f'phase 20 random {name} left the card')
        paddle.seed(5)
        if not np.array_equal(call(paddle).numpy(), first.numpy()):
            raise AssertionError(f'phase 20 random {name}: another stream '
                                 'under the same seed')
    return {'cases': len(cases.C), 'random_ops': len(cases.RANDOM),
            'max_abs_err': worst}


def eager_rung(paddle):
    """bench.py _child_eager's chain, (x.matmul(b) + x).multiply(b).tanh()
    over 64x64 f32, 300 iterations, through the port and as raw torch ops
    on the same tensors, in turns (port, raw, raw, port): ops/s of each
    and the wrapper's cost per op; the two chains' results equal."""
    rng = np.random.RandomState(0)
    a = paddle.to_tensor(rng.rand(64, 64).astype('float32'))
    b = paddle.to_tensor(rng.rand(64, 64).astype('float32'))
    bv = b._value

    def chain(x):
        return (x.matmul(b) + x).multiply(b).tanh()

    def raw(x):
        return torch.tanh(torch.mul(torch.add(torch.matmul(x, bv), x), bv))

    def run(step, x, read):
        read(step(x))                    # warm caches
        t0 = time.perf_counter()
        for _ in range(EAGER_ITERS):
            x = step(x)
        out = read(x)
        return out, 4 * EAGER_ITERS / (time.perf_counter() - t0)

    rates = {'port': [], 'raw': []}
    outs = {}
    for who in ('port', 'raw', 'raw', 'port'):
        if who == 'port':
            out, rate = run(chain, a, lambda t: t.numpy())
        else:
            out, rate = run(raw, a._value, lambda t: t.cpu().numpy())
        outs[who] = out
        rates[who].append(rate)
    if not np.array_equal(outs['port'], outs['raw']):
        raise AssertionError('phase 20: the eager chain through the port '
                             'differs from the same torch ops')
    port_rate, raw_rate = (float(np.median(rates['port'])),
                           float(np.median(rates['raw'])))
    return {'eager_ops_per_sec': port_rate, 'raw_torch_ops_per_sec':
            raw_rate, 'runs': rates,
            'wrapper_us_per_op': 1e6 / port_rate - 1e6 / raw_rate}


def busy_over_steps(fn, n=3):
    """The device's busy share over n calls of fn, from torch.profiler: one
    call first, outside the window (a window's first launches can go
    missing: one full run of phase 20 lost the forward of a one-step
    window, 20 kernels of 36), then the window, marked by record_function
    and closed by a synchronize. Device time: the kernels and copies that
    start inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
        with record_function('busy_window'):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    events = p.events()
    win = next(e for e in events if e.name == 'busy_window')
    t0, t1 = win.time_range.start, win.time_range.end
    dev, kernels = {}, 0
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != 'busy_window'      # its own device range
                and t0 <= e.time_range.start <= t1):
            dev[e.name] = (dev.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
            kernels += 1
    total = sum(dev.values())
    if total <= 0:
        raise AssertionError('the profiler saw no device time')
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {'window_ms': (t1 - t0) / 1e3, 'device_ms': total,
            'busy_share': total / ((t1 - t0) / 1e3), 'steps': n,
            'kernels_per_step': kernels / n,
            'top': [(k[:90], v / n) for k, v in top]}


def eager_mlp(paddle, cases, card):
    """An eager training loop at the bench GPT's MLP widths: x [8192, 1024]
    f32, W1 [1024, 4096], W2 [4096, 1024] with biases; each step the loss
    in paddle ops, loss.backward(), an SGD update under paddle.no_grad()
    through set_value, clear_grad(); 2 warm-up and 10 timed steps, the
    loss falling; then the same at hidden 64, two steps on the card and on
    the CPU within 1e-4."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    weights, x, y = cases.mlp_data(**MLP)
    paddle.set_device('gpu')
    params = [paddle.to_tensor(w, stop_gradient=False) for w in weights]
    tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
    losses = [cases.mlp_step(paddle, params, tx, ty, MLP_LR)
              for _ in range(2)]
    timed_losses, wall = timed(lambda: [
        cases.mlp_step(paddle, params, tx, ty, MLP_LR)
        for _ in range(MLP_STEPS)])
    vals = [float(v) for v in losses + timed_losses]
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f'phase 20: the MLP loss did not fall: {vals}')
    prof = busy_over_steps(lambda: cases.mlp_step(paddle, params, tx, ty,
                                                  MLP_LR))
    h, f, r = MLP['hidden'], MLP['ffn'], MLP['rows']
    flops = 2 * r * h * f * 5         # 2 forward products, 3 backward
    res = {'step_ms': wall * 1e3 / MLP_STEPS, 'losses': vals,
           'peak_mem_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
           'tflops': flops * MLP_STEPS / wall / 1e12, 'profile': prof}
    del params, tx, ty
    torch.cuda.empty_cache()

    small = {}
    weights, x, y = cases.mlp_data(64, 256, 512, seed=1)
    for dev in ('gpu', 'cpu'):
        paddle.set_device(dev)
        params = [paddle.to_tensor(w, stop_gradient=False) for w in weights]
        tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
        ls = [float(cases.mlp_step(paddle, params, tx, ty, MLP_LR))
              for _ in range(2)]
        small[dev] = ls + [v for p in params for v in p.numpy().ravel()]
    err = np.abs(np.subtract(small['gpu'], small['cpu'])).max() / max(
        1.0, np.abs(small['cpu']).max())
    if not err <= 1e-4:
        raise AssertionError(f'phase 20: MLP at hidden 64, card vs CPU '
                             f'after two steps {err:.3e} > 1e-4')
    res['hidden64_card_vs_cpu'] = float(err)
    paddle.set_device('gpu')
    return res


def eager_penalty(paddle, cases):
    """tests/test_double_grad.py:51-68's gradient-penalty step through
    paddle.grad(create_graph=True) on the card and on the CPU: the input
    gradient, the penalty and the weight's gradient within 1e-5."""
    out = {}
    for dev in ('gpu', 'cpu'):
        paddle.set_device(dev)
        out[dev] = [t.numpy() for t in cases.gradient_penalty(paddle)]
    err = max(float(np.abs(a - b).max()) for a, b in zip(out['gpu'],
                                                         out['cpu']))
    if not err <= 1e-5:
        raise AssertionError(f'phase 20: gradient penalty card vs CPU '
                             f'{err:.3e} > 1e-5')
    paddle.set_device('gpu')
    return {'max_abs_err': err, 'penalty': float(out['gpu'][1])}


def phase_eager(card):
    """Phase 20: the eager Paddle API (``import paddle_tpu_torch as
    paddle``) on the card: (a) the op sweep card against CPU, (b) the
    eager rung, (c) an eager training loop at the MLP widths, (d) a
    gradient-penalty step."""
    import paddle_tpu_torch as paddle
    cases = tests_module('torch_op_cases')
    t0 = time.perf_counter()
    res = {'sweep': eager_op_sweep(paddle, cases)}
    sw = res['sweep']
    print(f'  (a) op sweep: {sw["cases"]} cases card against CPU, largest '
          f'error elementwise {sw["max_abs_err"]["ew"]:.3e} (tol 1e-5 rel '
          f'/ 1e-6 abs), reductions/matmul/linalg '
          f'{sw["max_abs_err"]["red"]:.3e} (tol 1e-4); {sw["random_ops"]} '
          'random ops held on the card', flush=True)
    res['rung'] = rung = eager_rung(paddle)
    print(f'  (b) eager rung (64x64 f32 chain, {EAGER_ITERS} iterations): '
          f'eager_ops_per_sec {rung["eager_ops_per_sec"]:.0f}, raw torch '
          f'{rung["raw_torch_ops_per_sec"]:.0f} ops/s, wrapper '
          f'{rung["wrapper_us_per_op"]:.2f} us per op [{card}]', flush=True)
    res['mlp'] = mlp = eager_mlp(paddle, cases, card)
    prof = mlp['profile']
    print(f'  (c) eager MLP step [{MLP["rows"]}, {MLP["hidden"]}] x '
          f'[{MLP["hidden"]}, {MLP["ffn"]}] f32: {mlp["step_ms"]:.2f} ms a '
          f'step ({mlp["tflops"]:.1f} TFLOP/s), busy '
          f'{100 * prof["busy_share"]:.1f}% ({prof["device_ms"]:.2f} of '
          f'{prof["window_ms"]:.2f} ms over {prof["steps"]} steps, '
          f'{prof["kernels_per_step"]:.0f} kernels a step), peak '
          f'{mlp["peak_mem_gb"]:.2f} GB above the phase\'s start, loss '
          f'{mlp["losses"][0]:.5f} -> {mlp["losses"][-1]:.5f}; hidden 64 '
          f'card vs CPU {mlp["hidden64_card_vs_cpu"]:.2e} [{card}]',
          flush=True)
    print('    device ms a step by kernel:', flush=True)
    for name, ms in prof['top'][:5]:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    res['penalty'] = pen = eager_penalty(paddle, cases)
    res['seconds'] = time.perf_counter() - t0
    print(f'  (d) gradient penalty card vs CPU {pen["max_abs_err"]:.2e} '
          f'(tol 1e-5); phase 20 took {res["seconds"]:.1f} s', flush=True)
    return res


# ---------------------------------------------------------------------------
# phases 21-24: fp8 training
# ---------------------------------------------------------------------------
PEAK_FP8 = 1979e12          # dense fp8 tensor-core rate, H100 SXM
FP8_ROWS = 8 * 1024         # the bench rung's [8, 1024] batch
FP8_PRODUCTS = (('qkv', 1024, 3072), ('proj', 1024, 1024),
                ('fc', 1024, 4096), ('out', 4096, 1024))
FP8_ITERS = 20


def fp8_run(fn, x, w, gy, meta):
    """out, dx, dw and the new meta leaves of one fp8 product and its
    backward from the output gradient ``gy``."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    m = {r: {k: t.detach().clone().requires_grad_() for k, t in v.items()}
         for r, v in meta.items()}
    leaves = [m[r][k] for r in 'xwg' for k in ('scale', 'ahist')]
    out = fn(x, w, m)
    grads = torch.autograd.grad(out, [x, w] + leaves, gy)
    return [out.detach()] + list(grads)


def rate(flops, ms):
    return flops / (ms * 1e-3) / 1e12


def phase_fp8_matmul(card):
    """Phase 21: fp8_matmul on the card (torch._scaled_mm) against its twin
    (the reference's quantize-dequantize product, run on the card) at the
    bench GPT's four block products over [8192, 1024] rows, bf16, from a
    warm meta: out, dx and dw per output row within 2^-6, the new (scale,
    ahist) of x, w and g equal; then the times of one product."""
    from paddle_tpu_torch.quantization import fp8
    g = torch.Generator(device='cuda').manual_seed(21)
    res = {}
    for name, k, n in FP8_PRODUCTS:
        x = torch.randn((8, 1024, k), generator=g, device='cuda').to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device='cuda') * 0.02).to(
            torch.bfloat16)
        gy = (torch.randn((8, 1024, n), generator=g, device='cuda')
              * 1e-4).to(torch.bfloat16)
        # a warm meta: one twin step from a cold one
        cold = fp8.init_matmul_meta(device='cuda')
        new = iter(fp8_run(fp8.fp8_matmul_reference, x, w, gy, cold)[3:])
        meta = {r: {kk: next(new).detach() for kk in ('scale', 'ahist')}
                for r in 'xwg'}
        calls = fp8.scaled_mm_calls
        got = fp8_run(fp8.fp8_matmul, x, w, gy, meta)
        if fp8.scaled_mm_calls - calls != 3:
            raise AssertionError(f'{name}: {fp8.scaled_mm_calls - calls} '
                                 '_scaled_mm calls, want 3')
        want = fp8_run(fp8.fp8_matmul_reference, x, w, gy, meta)
        errs = {o: kernel_err(a, b, 0.0 if o == 'out' else GRAD_FLOOR)[1]
                for o, a, b in zip(('out', 'dx', 'dw'), got[:3], want[:3])}
        state_equal = all(torch.equal(a, b) for a, b in zip(got[3:],
                                                              want[3:]))
        # times: the product alone, bf16 matmul, the forward's quantize
        # ops, the fp8 forward and the twin's forward
        x2 = x.reshape(-1, k)
        sx, sw = meta['x']['scale'], meta['w']['scale']
        qx = fp8._quantize(x2, fp8.E4M3, sx)
        qw_t = fp8._quantize(w, fp8.E4M3, sw).t().contiguous()

        def prep(_):
            fp8._quantize(x2, fp8.E4M3, sx)
            fp8._quantize(w, fp8.E4M3, sw).t().contiguous()
            fp8.compute_scale(fp8.update_history(meta['x']['ahist'], x),
                              fp8.E4M3)
            fp8.compute_scale(fp8.update_history(meta['w']['ahist'], w),
                              fp8.E4M3)
        with torch.no_grad():
            t = {'scaled_mm': cuda_ms(lambda _: torch._scaled_mm(
                    qx, qw_t.t(), scale_a=sx, scale_b=sw,
                    out_dtype=torch.bfloat16, use_fast_accum=False),
                    FP8_ITERS),
                 'bf16_matmul': cuda_ms(lambda _: torch.matmul(x2, w),
                                        FP8_ITERS),
                 'quantize_ops': cuda_ms(prep, FP8_ITERS),
                 'fp8_forward': cuda_ms(
                     lambda _: fp8.fp8_matmul(x, w, meta), FP8_ITERS),
                 'twin_forward': cuda_ms(
                     lambda _: fp8.fp8_matmul_reference(x, w, meta),
                     FP8_ITERS)}
        flops = 2.0 * FP8_ROWS * k * n
        mm_bytes = FP8_ROWS * k + k * n + 2 * FP8_ROWS * n
        bound = max(flops / PEAK_FP8, mm_bytes / HBM_BYTES_PER_S) * 1e3
        bf16_bound = max(flops / PEAK_OPS_PER_S[torch.bfloat16],
                         2 * mm_bytes / HBM_BYTES_PER_S) * 1e3
        res[name] = {'k': k, 'n': n, 'gflop': flops / 1e9, 'errors': errs,
                     'state_equal': state_equal, 'ms': t,
                     'tflops': {kk: rate(flops, v) for kk, v in t.items()},
                     'bound_ms': bound, 'bf16_bound_ms': bf16_bound}
        print(f'  {name} [{FP8_ROWS}, {k}] x [{k}, {n}] ({flops / 1e9:.1f} '
              f'GFLOP): out {errs["out"]:.2e}, dx {errs["dx"]:.2e}, dw '
              f'{errs["dw"]:.2e} (tol {TOL[torch.bfloat16]:.4g}), new state '
              f'{"equal" if state_equal else "DIFFERENT"}', flush=True)
        print('    ms (TFLOP/s): ' + ', '.join(
            f'{kk} {v:.4f} ({rate(flops, v):.0f})' for kk, v in t.items())
            + f'; fp8 bound {bound:.4f} ms, bf16 bound {bf16_bound:.4f} ms '
            f'[{card}]', flush=True)
        if not (max(errs.values()) <= TOL[torch.bfloat16] and state_equal):
            raise AssertionError(f'fp8_matmul {name} card vs twin: {errs}, '
                                 f'state equal {state_equal}')
        del x, w, gy, x2, qx, qw_t
    torch.cuda.empty_cache()
    return res


def count_syncs(fn):
    """Host syncs fn() makes, counted by torch's sync debug mode."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def device_ms_by_kind(prof):
    """A profiled window's device ms split into the fp8 GEMMs (the kernels
    aten::_scaled_mm launched), the other GEMMs (aten::mm / addmm / bmm:
    bf16 products, the f32 LM-head loss), the attention kernels and the
    rest (elementwise, reductions, copies: the quantize ops). cuBLAS's
    kernel names do not all say their dtype, so the GEMMs go by the op
    that launched them."""
    ops = prof['by_op']
    out = {'fp8_gemm': ops.get('aten::_scaled_mm', 0.0),
           'other_gemm': sum(ops.get(o, 0.0) for o in (
               'aten::mm', 'aten::addmm', 'aten::bmm', 'aten::baddbmm')),
           'attention': sum(ms for name, ms in prof['by_name'].items()
                            if 'flash_' in name)}
    out['rest'] = prof['device_ms'] - sum(out.values())
    return out


def fp8_train_run(mod, cfg, topt, kernels, per_step, fp8_per_step, b, s,
                  lr, n_timed, what, card):
    """One train rung: ``mod.make_train_step`` at ``cfg`` from seed-0
    weights, one counted step, one more warm-up, ``n_timed`` timed steps;
    launches of kernels 1-3 and the fp8 products requested
    (``fp8.scaled_mm_calls``) held per step; then a profiled window of 2
    steps, in which the ``aten::_scaled_mm`` calls that launched a kernel
    are held, and the syncs of one step. ``fp8_per_step``: (launched,
    requested) a step."""
    from paddle_tpu_torch.quantization import fp8
    torch.cuda.reset_peak_memory_stats()
    params = mod.init_params(cfg, torch.Generator(device='cuda').manual_seed(
        0), 'cuda')
    opt = topt.AdamW(learning_rate=lr)
    st = {'p': params, 's': opt.functional_init(params),
          'f8': (mod.init_fp8_state(cfg, 'cuda')
                 if cfg.matmul_precision == 'fp8' else None)}
    step = mod.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to('cuda')
    losses = []

    def one():
        if st['f8'] is None:
            loss, st['p'], st['s'] = step(st['p'], st['s'], 0, lr, toks, toks)
        else:
            loss, st['p'], st['s'], st['f8'] = step(
                st['p'], st['s'], st['f8'], 0, lr, toks, toks)
        losses.append(loss)

    zero_launches(kernels)
    calls = fp8.scaled_mm_calls
    one()
    torch.cuda.synchronize()
    expect_launches(f'one {what} step', launch_counts(kernels), per_step)
    launched, requested = fp8_per_step
    got = fp8.scaled_mm_calls - calls
    if got != requested:
        raise AssertionError(f'{what}: {got} fp8 products requested a step, '
                             f'want {requested}')
    one()
    zero_launches(kernels)
    calls = fp8.scaled_mm_calls
    _, wall = timed(lambda: [one() for _ in range(n_timed)])
    launches = launch_counts(kernels)
    expect_launches(f'{n_timed} timed {what} steps', launches,
                    {k: n_timed * v for k, v in per_step.items()})
    tc = expect_tensor_core(f'{n_timed} timed {what} steps', kernels)
    products = fp8.scaled_mm_calls - calls
    if products != n_timed * requested:
        raise AssertionError(f'{what}: {products} fp8 products requested in '
                             f'{n_timed} steps, want {n_timed * requested}')
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f'{what}: losses {vals}')
    prof = profile_window(lambda: [one() for _ in range(2)])
    ran = prof['ops_run'].get('aten::_scaled_mm', 0)
    if ran != 2 * launched:
        raise AssertionError(f'{what}: {ran} aten::_scaled_mm calls launched '
                             f'a kernel in 2 profiled steps, want '
                             f'{2 * launched}')
    syncs = count_syncs(one)
    torch.cuda.synchronize()
    res = {'losses': vals, 'step_ms': wall * 1e3 / n_timed,
           'tokens_per_s': b * s * n_timed / wall,
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'launches': launches, 'tensor_core_launches': tc,
           'fp8_launched_per_step': ran / 2,
           'fp8_requested_per_step': requested, 'syncs_per_step': syncs,
           'profile': {k: v for k, v in prof.items()
                       if k not in ('by_name', 'by_op', 'ops_run')},
           'device_ms_by_kind': {k: v / 2 for k, v in
                                 device_ms_by_kind(prof).items()}}
    kinds = res['device_ms_by_kind']
    print(f'  {what}: {res["step_ms"]:.1f} ms a step, '
          f'{res["tokens_per_s"]:.0f} tokens/s, peak '
          f'{res["peak_mem_gb"]:.2f} GB, {syncs} syncs a step, fp8 products '
          f'{ran // 2} launched and {requested} requested a step [{card}]',
          flush=True)
    print(f'    profiled 2 steps: {prof["window_ms"] / 2:.1f} ms a step, '
          f'device {prof["device_ms"] / 2:.1f} ms '
          f'({100 * prof["busy_share"]:.1f}% busy); device ms a step: '
          + ', '.join(
              f'{k} {v:.2f}' for k, v in kinds.items()), flush=True)
    print(f'    losses {" ".join(f"{x:.4f}" for x in vals)}', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms / 2:9.3f} ms a step  {name}', flush=True)
    del st
    torch.cuda.empty_cache()
    return res


def phase_fp8_train(gpt, topt, kernels, card):
    """Phase 22: bench.py _child_fp8_train as it is: the bench GPT (bf16,
    flash, remat 'dots', xent_chunk 8192), B=8, S=1024, AdamW(1e-4),
    matmul_precision 'none' then 'fp8', 2 warm-up and 8 timed steps
    each: base_tokens_per_sec, fp8_tokens_per_sec, fp8_speedup. fp8
    launches 12 x L products a step (4 matmuls x forward, dx, dw); the
    'dots' recompute requests the 4 forward ones again and the policy's
    cache answers them: 16 x L requested."""
    res = {}
    for prec in ('none', 'fp8'):
        cfg = bench_config(gpt, remat=True, matmul_precision=prec,
                           num_layers=FP8_RUNG_LAYERS)
        L = cfg.num_layers
        per_step = {'flash_fwd': 2 * L, 'flash_bwd_dq': L,
                    'flash_bwd_dkv': L}
        res[prec] = fp8_train_run(
            gpt, cfg, topt, kernels, per_step,
            (12 * L, 16 * L) if prec == 'fp8' else (0, 0), 8,
            cfg.max_seq_len, 1e-4, 8,
            f"train rung, matmul_precision='{prec}'", card)
    none, f8 = res['none'], res['fp8']
    rung = {'base_tokens_per_sec': none['tokens_per_s'],
            'fp8_tokens_per_sec': f8['tokens_per_s'],
            'fp8_speedup': f8['tokens_per_s'] / none['tokens_per_s']}
    res['rung'] = rung
    kf, kn = f8['device_ms_by_kind'], none['device_ms_by_kind']
    quant = kf['rest'] - kn['rest']
    res['quantize_device_ms_per_step'] = quant
    print('  ' + json.dumps(rung), flush=True)
    print(f'  device ms a step, fp8 against none: fp8 GEMMs {kf["fp8_gemm"]:.2f}'
          f', other GEMMs {kf["other_gemm"]:.2f} against '
          f'{kn["other_gemm"]:.2f} (the LM-head loss stays), the rest '
          f'{kf["rest"]:.2f} against {kn["rest"]:.2f} (the quantize ops '
          f'~{quant:.2f}); syncs a step {f8["syncs_per_step"]} against '
          f'{none["syncs_per_step"]}', flush=True)
    if f8['syncs_per_step'] > none['syncs_per_step']:
        raise AssertionError(f'the fp8 step syncs {f8["syncs_per_step"]} '
                             f'times, the plain one {none["syncs_per_step"]}')
    return res


def phase_moe_fp8_train(moe, topt, kernels, card):
    """Phase 23: phase 18's MoE train step with matmul_precision='fp8':
    qkv and proj on the fp8 tensor cores, each run forward, again in the
    whole-block recompute, dx and dw: 8 x L products a step."""
    cfg = moe.MoEConfig(remat=True, matmul_precision='fp8',
                        num_layers=MOE_FP8_LAYERS)
    L = cfg.num_layers
    per_step = {'flash_fwd': 2 * L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    return fp8_train_run(moe, cfg, topt, kernels, per_step, (8 * L, 8 * L),
                         8, cfg.max_seq_len, 2e-4, 4, 'moe fp8 train step',
                         card)


def to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev).clone()


def fp8_grads(mod, cfg, params, f8, t, y):
    """One fp8 backward as the train step takes it: (the loss, the
    parameters' gradients, the new fp8 state's leaves)."""
    from paddle_tpu_torch.models import gpt
    live = [x.detach().clone().requires_grad_() for x in gpt._leaves(params)]
    live_m = [x.detach().clone().requires_grad_() for x in gpt._leaves(f8)]
    loss = mod.loss_fn(gpt._rebuild(params, live), t, y, cfg,
                       fp8_state=gpt._rebuild(f8, live_m))
    grads = torch.autograd.grad(loss, live + live_m)
    return (loss.item(), [g.cpu() for g in grads[:len(live)]],
            [g.cpu() for g in grads[len(live):]])


def rel_err(a, b):
    """max |a - b| over the largest |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def grad_agreement(got, want):
    """Each gradient against its reference: (the least cosine, the least
    and the largest norm ratio) over the leaves; an all-zero or flipped
    gradient gives a cosine of 0 or below."""
    import torch.nn.functional as F
    cos = [F.cosine_similarity(a.flatten().double(), b.flatten().double(),
                               0).item() for a, b in zip(got, want)]
    ratio = [(a.norm() / b.norm().clamp_min(1e-30)).item()
             for a, b in zip(got, want)]
    return min(cos), min(ratio), max(ratio)


def noised(tree, seed):
    """``tree``'s leaves times (1 + FP8_NOISE x a unit normal)."""
    from paddle_tpu_torch.models import gpt
    g = torch.Generator().manual_seed(seed)
    return gpt._rebuild(tree, [
        x * (1 + FP8_NOISE * torch.randn(x.shape, generator=g))
        for x in gpt._leaves(tree)])


def fp8_products(fn):
    """fn() with every fp8_matmul call recorded: its x, w and meta as
    they came in, and the output gradient its backward was handed. A
    call whose output takes no gradient (a remat recompute's) is
    dropped; -> (fn()'s result, the records in call order)."""
    from paddle_tpu_torch.quantization import fp8
    recs, orig = [], fp8.fp8_matmul

    def record(x, w, meta):
        out = orig(x, w, meta)
        r = {'x': x.detach().clone(), 'w': w.detach().clone(),
             'meta': {k: {kk: t.detach().clone() for kk, t in v.items()}
                      for k, v in meta.items()}}
        recs.append(r)
        if out.requires_grad:
            out.register_hook(lambda g: r.__setitem__('gy',
                                                      g.detach().clone()))
        return out
    fp8.fp8_matmul = record
    try:
        res = fn()
    finally:
        fp8.fp8_matmul = orig
    return res, [r for r in recs if 'gy' in r]


def fp8_product_checks(recs, params, grads, new_state):
    """Each recorded product of the card's step, run again on the card
    and by the CPU twin from its recorded inputs: out, dx and dw against
    the twin (of each one's largest value), its new (scale, ahist) of x,
    w and g equal to the twin's; and the step's plumbing: the model's
    gradient of that weight against the twin's dw, the model's new state
    of that layer and matmul equal to the twin's. -> {(name, layer):
    errors}."""
    from paddle_tpu_torch.quantization import fp8
    out = {}
    for r in recs:
        wc = r['w'].cpu()
        (name, layer), = [(n, l) for n in new_state['blocks']
                          for l, w in enumerate(params['blocks'][f'{n}_w'])
                          if torch.equal(w, wc)]
        got = fp8_run(fp8.fp8_matmul, r['x'], r['w'], r['gy'], r['meta'])
        want = fp8_run(fp8.fp8_matmul_reference, r['x'].cpu(), wc,
                       r['gy'].cpu(), to_dev(r['meta'], 'cpu'))
        model = [new_state['blocks'][name][role][k][layer]
                 for role in 'xwg' for k in ('scale', 'ahist')]
        out[(name, layer)] = {
            **{o: rel_err(a.cpu(), b) for o, a, b in zip(
                ('out', 'dx', 'dw'), got[:3], want[:3])},
            'state_equal': all(torch.equal(a.cpu(), b)
                               for a, b in zip(got[3:], want[3:])),
            'model_dw': rel_err(grads['blocks'][f'{name}_w'][layer],
                                want[2]),
            'model_state_equal': all(torch.equal(a, b)
                                     for a, b in zip(model, want[3:]))}
    return out


# phase 24's bars, card against CPU. Held per product from the same
# inputs (the first step's): out, dx, dw and the step's gradient of each
# fp8 weight within 5e-3 of the largest value, the new state exact.
# Held end to end: the first loss 1e-3 relative, the new w scales 1e-5
# (amaxes of the same weights); the first step's gradients by cosine and
# norm ratio; each of 6 steps' loss against the CPU's loss at the card's
# parameters and state (the CPU follows the card: an fp8 forward turns
# one ulp into an e4m3 step, so free-running curves part). MoE's top-k
# routing flips on ties, so its step losses take twice GPT's bar. The
# x and g scales end to end are printed only: each product's are exact.
FP8_BARS = {'product': 5e-3, 'loss': 1e-3, 'w_scale': 1e-5,
            'grad_cosine': 0.9, 'grad_norm_ratio': 1.25,
            'step_loss': {'gpt': 1e-3, 'moe': 2e-3}}
# relative noise on the CPU's parameters, the yardstick printed beside
# each end-to-end error: the size of the card's fp8 products' own error
# against exact products (2.5e-4 to 5e-4 a row at K 128-4096 in f32 on
# the H100: the tensor cores' fp8 accumulation)
FP8_NOISE = 2.0 ** -12


def fp8_card_vs_cpu(mod, cfg, params, topt, toks, tgts, what):
    """From a warm fp8 state: the first step's products, gradients and
    new state, and the steps' losses, card against CPU (FP8_BARS); the
    CPU at noised parameters (FP8_NOISE) is printed beside each of the
    first step's end-to-end errors. The warm state is the card's after one backward a
    matmul the gradient crosses, plus one, handed to both sides (warmed
    on the card: the CPU's backward passes took most of the phase): from
    the cold state (every scale 1) e5m2 flushes gradients below 2^-16 to
    zero and each matmul's recorded g amax is wrong until the one above
    it was scaled."""
    from paddle_tpu_torch.models import gpt
    t_cpu, y_cpu = torch.from_numpy(toks), torch.from_numpy(tgts)
    t, y = t_cpu.to('cuda'), y_cpu.to('cuda')
    cold = warm = mod.init_fp8_state(cfg, 'cpu')
    n_products = len(cold['blocks']) * cfg.num_layers
    on_card = to_dev(params, 'cuda')
    for _ in range(n_products + 1):
        _, _, new = fp8_grads(mod, cfg, on_card, to_dev(warm, 'cuda'), t, y)
        warm = gpt._rebuild(cold, new)
    del on_card
    card, recs = fp8_products(lambda: fp8_grads(
        mod, cfg, to_dev(params, 'cuda'), to_dev(warm, 'cuda'), t, y))
    if len(recs) != n_products:
        raise AssertionError(f'{what}: {len(recs)} fp8 products recorded, '
                             f'want {n_products}')
    cpu = fp8_grads(mod, cfg, params, warm, t_cpu, y_cpu)
    noisy = fp8_grads(mod, cfg, noised(params, 11), warm, t_cpu, y_cpu)
    prods = fp8_product_checks(recs, params, gpt._rebuild(params, card[1]),
                               gpt._rebuild(cold, card[2]))

    def end_to_end(got):
        st, ref = gpt._rebuild(cold, got[2]), gpt._rebuild(cold, cpu[2])
        cos, lo, hi = grad_agreement(got[1], cpu[1])
        return {'loss': abs(got[0] - cpu[0]) / abs(cpu[0]),
                'grad_cosine': cos,
                'grad_norm_ratio': max(hi, 1 / max(lo, 1e-30)),
                **{f'{r}_scale': max(rel_err(st['blocks'][n][r]['scale'],
                                             ref['blocks'][n][r]['scale'])
                                     for n in ref['blocks'])
                   for r in 'xwg'}}
    errs, spread = end_to_end(card), end_to_end(noisy)

    p, f8 = to_dev(params, 'cuda'), to_dev(warm, 'cuda')
    opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01)
    state = opt.functional_init(p)
    step = mod.make_train_step(cfg, opt)
    curve, step_err = [], []
    for i in range(CURVE_STEPS):
        pc, fc = to_dev(p, 'cpu'), to_dev(f8, 'cpu')
        loss, p, state, f8 = step(p, state, f8, 0, 1e-3, t, y)
        with torch.no_grad():
            want = mod.loss_fn(pc, t_cpu, y_cpu, cfg, fp8_state=fc).item()
        curve.append(float(loss))
        step_err.append(abs(curve[-1] - want) / abs(want))

    worst = {k: max(e[k] for e in prods.values())
             for k in ('out', 'dx', 'dw', 'model_dw')}
    exact = all(e['state_equal'] and e['model_state_equal']
                for e in prods.values())
    bars = FP8_BARS
    ok = (max(worst.values()) <= bars['product'] and exact
          and errs['loss'] <= bars['loss']
          and errs['w_scale'] <= bars['w_scale']
          and errs['grad_cosine'] >= bars['grad_cosine']
          and errs['grad_norm_ratio'] <= bars['grad_norm_ratio']
          and max(step_err) <= bars['step_loss'][what]
          and curve[-1] < curve[0])
    res = {'products': {f'{n}[{l}]': e for (n, l), e in prods.items()},
           'products_worst': worst, 'products_state_exact': exact,
           'errors': errs, 'cpu_noise_spread': spread,
           'step_loss_errors': step_err, 'curve': curve,
           'bars': dict(bars, step_loss=bars['step_loss'][what])}
    print(f'  {what} fp8 card vs cpu (2 layers, f32, warm state): '
          f'{n_products} products from their recorded inputs: out '
          f'{worst["out"]:.2e}, dx {worst["dx"]:.2e}, dw {worst["dw"]:.2e}, '
          f'the step\'s weight gradients {worst["model_dw"]:.2e} (bar '
          f'{bars["product"]:.0e}), new state and the step\'s '
          f'{"exact" if exact else "DIFFERENT"}', flush=True)
    print(f'    end to end (cpu at {FP8_NOISE:.2e} parameter noise in '
          f'brackets): loss {errs["loss"]:.2e} [{spread["loss"]:.2e}] (bar '
          f'{bars["loss"]:.0e}), w scales {errs["w_scale"]:.2e} (bar '
          f'{bars["w_scale"]:.0e}), grads cosine >= '
          f'{errs["grad_cosine"]:.4f} [{spread["grad_cosine"]:.4f}] (bar '
          f'{bars["grad_cosine"]}), norm ratio <= '
          f'{errs["grad_norm_ratio"]:.4f} [{spread["grad_norm_ratio"]:.4f}] '
          f'(bar {bars["grad_norm_ratio"]}); x scales {errs["x_scale"]:.2e} '
          f'[{spread["x_scale"]:.2e}], g scales {errs["g_scale"]:.2e} '
          f'[{spread["g_scale"]:.2e}] (printed only)', flush=True)
    print(f'    {CURVE_STEPS} steps: card '
          f'{" ".join(f"{x:.5f}" for x in curve)}; each '
          f'against the cpu at its parameters '
          f'{" ".join(f"{x:.1e}" for x in step_err)} (bar '
          f'{bars["step_loss"][what]:.0e}) {"OK" if ok else "FAIL"}',
          flush=True)
    if not ok:
        raise AssertionError(f'{what} fp8 card vs cpu: {res}')
    return res


def gpt_curve(gpt, topt, precision, dev, steps=6, **over):
    """tests/test_precision.py's _gpt_curve on the port: vocab 64, hidden
    32, 2 layers, 4 heads, f32, no flash, no remat, AdamW(1e-3), one
    [8, 16] batch from a seed, 6 steps."""
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=32, dtype='float32', use_flash=False, remat=False)
    kw.update(over)
    cfg = gpt.GPTConfig(matmul_precision=precision, **kw)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(0),
                             'cpu')
    params = {k: ({bk: bv.to(dev) for bk, bv in v.items()}
                  if k == 'blocks' else v.to(dev))
              for k, v in params.items()}
    opt = topt.AdamW(learning_rate=1e-3)
    state = opt.functional_init(params)
    step = gpt.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (8, min(16, cfg.max_seq_len))).astype(
            np.int32)).to(dev)
    f8 = gpt.init_fp8_state(cfg, dev) if precision == 'fp8' else None
    out = []
    for _ in range(steps):
        if f8 is None:
            loss, params, state = step(params, state, 0, 1e-3, toks, toks)
        else:
            loss, params, state, f8 = step(params, state, f8, 0, 1e-3,
                                           toks, toks)
        out.append(float(loss))
    return out


def phase_fp8_card_vs_cpu(gpt, moe, topt):
    """Phase 24: fp8 training card against CPU at 2 layers in f32 (GPT as
    phase 12, MoE as phase 19); test_precision.py's fp8-vs-full-width
    curve on the card; auto_cast(dtype='float8') and GradScaler.check_fp8
    on the card."""
    import paddle_tpu_torch as paddle
    res = {}
    cfg = bench_config(gpt, num_layers=2, dtype='float32', max_seq_len=256,
                       matmul_precision='fp8')
    params = gpt.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    tgts = rng.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    res['gpt'] = fp8_card_vs_cpu(gpt, cfg, params, topt, toks, tgts, 'gpt')
    mcfg = moe.MoEConfig(num_layers=2, dtype='float32', max_seq_len=256,
                         matmul_precision='fp8')
    mparams = moe.init_params(mcfg, torch.Generator().manual_seed(3), 'cpu')
    mt = rng.randint(0, mcfg.vocab_size, (2, 256)).astype(np.int32)
    my = rng.randint(0, mcfg.vocab_size, (2, 256)).astype(np.int32)
    res['moe'] = fp8_card_vs_cpu(moe, mcfg, mparams, topt, mt, my, 'moe')

    fp8c, base = (gpt_curve(gpt, topt, p, 'cuda') for p in ('fp8', 'none'))
    gap = max(abs(a - b) for a, b in zip(fp8c, base))
    wide = [gpt_curve(gpt, topt, p, 'cuda', 3, vocab_size=32768,
                      hidden_size=1024, num_heads=16, max_seq_len=256)
            for p in ('fp8', 'none')]
    wide_gap = max(abs(a - b) for a, b in zip(*wide))
    res['curve'] = {'fp8': fp8c, 'none': base, 'gap': gap,
                    'hidden1024_gap': wide_gap}
    print(f'  test_precision curve on the card (hidden 32, 6 steps): fp8 '
          f'{" ".join(f"{x:.5f}" for x in fp8c)}, none '
          f'{" ".join(f"{x:.5f}" for x in base)}, gap {gap:.2e} (tol 5e-3);'
          f' at hidden 1024, 3 steps: gap {wide_gap:.2e} (printed only)',
          flush=True)
    if not (gap <= 5e-3 and base[-1] < base[0]):
        raise AssertionError(f'fp8 curve on the card: {res["curve"]}')

    # amp on the card: float8 auto_cast against the CPU, check_fp8 no sync
    x = np.random.RandomState(7).randn(64, 96).astype('float32')
    y = np.random.RandomState(8).randn(96, 48).astype('float32')
    outs = {}
    prev = paddle.device._current
    try:
        for dev in ('gpu', 'cpu'):
            paddle.set_device(dev)
            with paddle.amp.auto_cast(dtype='float8'):
                o = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(y))
            if str(o.dtype) != 'torch.bfloat16':
                raise AssertionError(f'auto_cast float8 on {dev}: {o.dtype}')
            outs[dev] = torch.from_numpy(o.numpy())
    finally:
        paddle.device._current = prev
    amp_err = kernel_err(outs['gpu'], outs['cpu'])[1]
    state = gpt.init_fp8_state(cfg, 'cuda')
    state['blocks']['fc']['g']['ahist'][1, 0] = float('inf')
    torch.cuda.synchronize()
    scaler = paddle.amp.GradScaler()
    torch.cuda.set_sync_debug_mode('error')
    try:
        flag = scaler.check_fp8(state)
        flag = flag | flag
    finally:
        torch.cuda.set_sync_debug_mode('default')
    on_card = flag.is_cuda and flag.dtype == torch.bool and bool(flag)
    res['amp'] = {'float8_matmul_card_vs_cpu': amp_err,
                  'check_fp8_cuda_bool_no_sync': on_card}
    print(f'  amp on the card: auto_cast(float8) matmul card vs cpu '
          f'{amp_err:.2e} of each row (tol {TOL[torch.bfloat16]:.4g}); '
          f'check_fp8 a CUDA bool with no sync: {on_card}', flush=True)
    if not (amp_err <= TOL[torch.bfloat16] and on_card):
        raise AssertionError(f'amp on the card: {res["amp"]}')
    return res


# ---------------------------------------------------------------------------
# phases 25-26: the ERNIE-base masked-LM program in paddle.nn
# ---------------------------------------------------------------------------
ERNIE_WARMUP, ERNIE_TIMED = 2, 8
NN_CARD_OUT_TOL = 2e-5      # card vs CPU, f32: kernel 1's f32 tolerance
NN_CARD_GRAD_TOL = 1e-4


def phase_ernie_train(kernels, card):
    """Phase 25: tests/torch_nn_cases.py's ERNIE-width masked-LM program
    (ErnieConfig's defaults written in paddle.nn, 132M parameters, random
    weights from paddle.seed(0)) trained on one numpy-seeded batch [8,
    512] (lengths 256-512, a bool [8, 1, 1, 512] key-padding mask, 15% of
    the real positions masked) with loss.backward(); opt.step();
    opt.clear_grad(); sched.step() under auto_cast(bfloat16): AdamW(
    LinearWarmup(PolynomialDecay(1e-4, 100), 10), weight decay 0.01,
    ClipGradByGlobalNorm(1.0)). 2 warm-up and 8 timed steps, then a
    profiled one, one with the optimizer profiled alone and one counting
    host syncs (fewer than one a parameter); every step must launch
    flash_fwd, flash_bwd_dq and flash_bwd_dkv once a layer (12 each), all
    on the tensor-core instance."""
    import paddle_tpu_torch as paddle
    C = nn_cases()
    paddle.set_device('gpu')
    paddle.seed(0)
    dims = C.ERNIE_BASE
    L = dims['layers']
    torch.cuda.reset_peak_memory_stats()
    model = C.ernie_mlm(paddle, **dims)
    n_params = sum(p.size for p in model.parameters())
    toks, types_, mask, labels, lens = C.mlm_batch(dims['vocab'],
                                                   **ERNIE_BATCH)
    batch = [paddle.to_tensor(a) for a in (toks, types_, mask, labels)]
    opt, sched = C.mlm_optimizer(paddle, model)
    per_step = {'flash_fwd': L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    losses, totals = [], {k: 0 for k in kernels}

    def one(opt_profile=None):
        """One step (mlm_step); with ``opt_profile`` (a dict) the
        optimizer's part (step, clear_grad, the scheduler) runs alone in
        a profiled window, whose record fills the dict."""
        zero_launches(kernels)
        if opt_profile is None:
            losses.append(C.mlm_step(paddle, model, opt, sched, batch,
                                     amp='bfloat16'))
        else:
            with paddle.amp.auto_cast(dtype='bfloat16'):
                loss = model.loss(*batch)
            loss.backward()
            torch.cuda.synchronize()
            opt_profile.update(profile_window(
                lambda: (opt.step(), opt.clear_grad(), sched.step())))
            losses.append(loss)
        got = launch_counts(kernels)
        want = {k: per_step.get(k, 0) for k in got}
        tc = {k: kernels[k].tc_launches for k in TC_KERNELS}
        if got != want or any(tc[k] != got[k] for k in TC_KERNELS):
            raise AssertionError(f'ERNIE step {len(losses)}: launches '
                                 f'{got}, tensor-core {tc}; want {want}, '
                                 'all tensor-core')
        for k, n in got.items():
            totals[k] += n

    for _ in range(ERNIE_WARMUP):
        one()
    _, wall = timed(lambda: [one() for _ in range(ERNIE_TIMED)])
    prof = profile_window(one)
    prof_opt = {}
    one(prof_opt)
    # the global-norm clip and the step read nothing back to the host
    syncs = count_syncs(one)
    n_tensors = len(model.parameters())
    vals = [float(x) for x in losses]
    if syncs >= n_tensors:
        raise AssertionError(f'ERNIE: {syncs} host syncs in a step, one a '
                             f'parameter or more ({n_tensors})')
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f'ERNIE: a non-finite loss {vals}')
    if not vals[-1] < vals[0]:
        raise AssertionError(f'ERNIE: the loss did not fall: {vals}')
    b, s = toks.shape
    tok_s = b * s * ERNIE_TIMED / wall
    attn_ms = {name: kernel_ms(prof, kern) for name, kern in (
        ('flash_fwd', 'flash_fwd_tc_kernel'),
        ('flash_bwd_dq', 'flash_bwd_dq_tc_kernel'),
        ('flash_bwd_dkv', 'flash_bwd_dkv_tc_kernel'))}
    res = {'params': n_params, 'losses': vals,
           'step_ms': wall * 1e3 / ERNIE_TIMED, 'tokens_per_s': tok_s,
           'real_tokens_per_step': int(lens.sum()),
           'mfu': 6 * n_params * tok_s / PEAK_BF16,
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'launches': totals, 'steps': len(losses), 'profile': prof,
           'attention_device_ms': attn_ms,
           'device_ms_by_kind': device_ms_by_kind(prof),
           'syncs_per_step': syncs,
           'optimizer': {k: prof_opt[k] for k in (
               'window_ms', 'device_ms', 'busy_share', 'kernels')}}
    print(f'  ERNIE-base MLM ({n_params / 1e6:.1f}M params, [{b}, {s}], '
          f'bf16 amp O1, dropout 0.1): {res["step_ms"]:.1f} ms a step, '
          f'{tok_s:.0f} tokens/s ({res["real_tokens_per_step"]} real a '
          f'step), MFU {100 * res["mfu"]:.2f}% of 989 TFLOP/s, peak '
          f'{res["peak_mem_gb"]:.2f} GB [{card}]', flush=True)
    print(f'  launches over {len(losses)} steps: {totals} ({L} each a '
          f'step, all tensor-core); host syncs in a step {syncs} (over '
          f'{n_tensors} parameters)', flush=True)
    print(f'  losses {" ".join(f"{x:.4f}" for x in vals)}', flush=True)
    print(f'  profiled step: window {prof["window_ms"]:.1f} ms, device busy '
          f'{prof["device_ms"]:.1f} ms ({100 * prof["busy_share"]:.1f}%), '
          f'{prof["kernels"]} kernel launches', flush=True)
    for name, ms in prof['top']:
        print(f'    {ms:9.3f} ms  {name}', flush=True)
    print('  attention kernels in the profiled step, device ms: '
          + ', '.join(f'{k} {v:.3f}' for k, v in attn_ms.items()),
          flush=True)
    kinds = res['device_ms_by_kind']
    print('  device ms by kind: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in kinds.items() if k != 'fp8_gemm'),
        flush=True)
    po = res['optimizer']
    print(f'  the optimizer alone (opt.step(), clear_grad, sched.step()): '
          f'window {po["window_ms"]:.1f} ms, device {po["device_ms"]:.2f} '
          f'ms, {po["kernels"]} kernel launches', flush=True)
    del model, opt, batch
    paddle.set_device('cpu')
    torch.cuda.empty_cache()
    return res


def phase_ernie_card_vs_cpu():
    """Phase 26: the program at 2 layers in f32 (ERNIE-base widths,
    dropout 0, [2, 128], lengths 64-128) from the same weights on the
    card and on the CPU: both losses, every first gradient, and the
    parameters after two opt.step()s within 1e-4, each device's taken
    less what AdamW in float64 makes of its own gradients
    (torch_nn_cases.mlm_agreement: near AdamW's epsilon the update
    amplifies a gradient's last bits by lr / eps); then every case of
    the nn table card against CPU, outputs within 2e-5 and gradients
    within 1e-4 of the part's largest value (at least 1)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fa
    C = nn_cases()
    dims = dict(C.ERNIE_BASE, layers=2, dropout=0.0)
    arrays = C.mlm_batch(dims['vocab'], 2, 128, 64, 128, seed=1)[:4]
    paddle.set_device('cpu')
    paddle.seed(0)
    cpu_model = C.ernie_mlm(paddle, **dims)
    sd = C.state_of(cpu_model)
    want = C.mlm_two_steps(paddle, cpu_model, arrays)
    paddle.set_device('gpu')
    card_model = C.ernie_mlm(paddle, **dims)
    card_model.set_state_dict(sd)
    before = fa.flash_fwd.launches
    got = C.mlm_two_steps(paddle, card_model, arrays)
    kernel_runs = fa.flash_fwd.launches - before
    fa.flash_fwd.launches = before
    agree = C.mlm_agreement(got, want, sd)
    print(f'  program card vs CPU (2 layers, f32, kernel 1 x '
          f'{kernel_runs}): losses {agree["loss"]:.2e}, first gradients '
          f'{agree["grad"]:.2e}, parameters after 2 steps beyond the '
          f'gradients\' gaps {agree["param"]:.2e} (tol 1e-4); before '
          f'taking the gaps out {agree["param_raw"]:.2e}, '
          f'{agree["raw_beyond"]} entries over 1e-4, largest first '
          f'gradient among them {agree["raw_beyond_grad_max"]:.2e} '
          f'{"OK" if agree["ok"] else "FAIL"}', flush=True)
    # two forwards (one a step) of 2 layers
    if not agree['ok'] or kernel_runs != 2 * dims['layers']:
        raise AssertionError(f'ERNIE card vs CPU: {agree}, kernel 1 ran '
                             f'{kernel_runs} times (want '
                             f'{2 * dims["layers"]})')
    worst = {'out': 0.0, 'grad': 0.0, 'state': 0.0}
    bad = []
    for case in C.CASES:
        paddle.set_device('cpu')
        cpu = C.run(paddle, case)
        paddle.set_device('gpu')
        card_res = C.run(paddle, case, state=cpu['before'])
        r = C.compare(card_res, cpu, case, out_tol=NN_CARD_OUT_TOL,
                      grad_tol=NN_CARD_GRAD_TOL)
        for k in worst:
            worst[k] = max(worst[k], r[k])
        if not r['ok']:
            bad.append((case.name, r))
    paddle.set_device('cpu')
    print(f'  nn case table card vs CPU: {len(C.CASES)} cases, largest '
          f'output {worst["out"]:.2e}, state {worst["state"]:.2e} (tol '
          f'{NN_CARD_OUT_TOL:g}), gradient {worst["grad"]:.2e} (tol '
          f'{NN_CARD_GRAD_TOL:g}) {"OK" if not bad else "FAIL"}',
          flush=True)
    if bad:
        raise AssertionError(f'nn cases card vs CPU: {bad[:5]}')
    return {'program': agree, 'cases': len(C.CASES), 'case_errors': worst}


# ---------------------------------------------------------------------------
# phases 27-28: hapi's Model over the ERNIE program, fed by paddle.io
# ---------------------------------------------------------------------------
HAPI_ROWS, HAPI_BATCH, HAPI_EPOCHS, HAPI_LOG_FREQ = 32, 8, 2, 4
HAPI_INPUTS = ['tokens', 'types', 'mask']


class _StepProbe:
    """A hapi callback that zeroes the launch counters as each train step
    begins and reads them, the host syncs torch's sync debug mode caught
    and the in-flight window's waits (``train.inflight_waits``) as it
    ends; and the host times of step begins and ends."""

    def __init__(self, paddle, kernels, caught):
        from paddle_tpu_torch import observability as obs
        waits = obs.counter('train.inflight_waits')
        probe = self
        self.steps, self.begins, self.ends, self.losses = [], [], [], []

        class CB(paddle.callbacks.Callback):
            def on_train_batch_begin(self, step, logs=None):
                probe.begins.append(time.perf_counter())
                zero_launches(kernels)
                probe._at = (len(caught), waits.value)

            def on_train_batch_end(self, step, logs=None):
                probe.ends.append(time.perf_counter())
                probe.losses.append(logs['loss'])
                probe.steps.append({
                    'step': step,
                    'launches': launch_counts(kernels),
                    'tc': {k: kernels[k].tc_launches for k in TC_KERNELS},
                    'syncs': sum('synchroniz' in str(w.message)
                                 for w in caught[probe._at[0]:]),
                    'window_waits': waits.value - probe._at[1],
                    'logged': isinstance(logs['loss'], float)})
        self.cb = CB()


def _hist(name):
    from paddle_tpu_torch import observability as obs
    h = obs.histogram(name)
    return h.count, h.sum


def _hapi_feeds(paddle, C, model, arrays, kernels, per_step):
    """The data wait of phase 27's fit with the native pool
    (``num_workers=2``) against the producer thread alone (0), both under
    fit's prefetch: one epoch each, in the order 0, 2, 2, 0. The wait of a
    step is the host time from the previous step's end (the epoch's
    begin, for the first) to its begin. Returns {workers: [runs]} and the
    launches, 12 of each of kernels 1-3 a step, all held."""
    from paddle_tpu_torch import observability as obs
    pooled = obs.counter('data.native_batches')
    feeds, launched = {0: [], 2: []}, {k: 0 for k in kernels}
    for workers in (0, 2, 2, 0):
        loader = paddle.io.DataLoader(C.mlm_rows(paddle, arrays),
                                      batch_size=HAPI_BATCH, shuffle=True,
                                      num_workers=workers)
        marks = []

        class Marks(paddle.callbacks.Callback):
            def on_epoch_begin(self, epoch, logs=None):
                marks.append(('end', time.perf_counter()))

            def on_train_batch_begin(self, step, logs=None):
                marks.append(('begin', time.perf_counter()))

            def on_train_batch_end(self, step, logs=None):
                marks.append(('end', time.perf_counter()))
        zero_launches(kernels)
        p0 = pooled.value
        with paddle.amp.auto_cast(dtype='bfloat16'):
            _, secs = timed(lambda: model.fit(
                loader, epochs=1, log_freq=HAPI_LOG_FREQ, verbose=0,
                callbacks=[Marks()]))
        got = launch_counts(kernels)
        n = HAPI_ROWS // HAPI_BATCH
        want = {k: n * per_step.get(k, 0) for k in got}
        if got != want or any(kernels[k].tc_launches != want[k]
                              for k in TC_KERNELS):
            raise AssertionError(f'hapi feed num_workers={workers}: '
                                 f'launches {got}, want {want}')
        if pooled.value - p0 != (n if workers else 0):
            raise AssertionError(f'hapi feed num_workers={workers}: '
                                 f'{pooled.value - p0} pool batches')
        waits = [1e3 * (b[1] - a[1]) for a, b in zip(marks, marks[1:])
                 if a[0] == 'end' and b[0] == 'begin']
        feeds[workers].append({'first_wait_ms': waits[0],
                               'later_wait_ms': sum(waits[1:])
                               / len(waits[1:]),
                               'fit_ms_per_step': 1e3 * secs / n})
        for k in got:
            launched[k] += got[k]
    return feeds, launched


def phase_hapi(kernels, card, bare_step_ms):
    """Phase 27: phase 25's ERNIE-base program as paddle.Model(net):
    prepare(AdamW over mlm_optimizer's schedule and clip, the masked-LM
    cross entropy on float32 logits), fed by paddle.io.DataLoader over a
    map dataset of 32 rows of mlm_batch at [., 512] (lengths 256-512),
    batch 8, shuffle, num_workers=2 (the native pool), prefetch_to_device
    (fit's own); fit 2 epochs (8 steps) under auto_cast(bfloat16) with
    save_dir in a temp dir, log_freq 4 and the LRScheduler callback by
    step; then evaluate and predict on 8 rows; then <save_dir>/final read
    into a fresh Model whose predict logits must equal the first's bit for
    bit. Each train step launches flash_fwd, flash_bwd_dq, flash_bwd_dkv
    12 times, all tensor-core; each eval or predict batch flash_fwd 12
    times and no backward; a non-logging step makes no host sync (sync
    debug mode; the in-flight window's event waits are counted apart); the
    losses finite; every fit batch from the native pool
    (``data.native_batches``), with no warned degrade and no failed save.
    Then the data wait with the pool against without it
    (``_hapi_feeds``)."""
    import shutil
    import tempfile
    import warnings
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observability as obs
    C = nn_cases()
    paddle.set_device('gpu')
    paddle.seed(0)
    np.random.seed(0)
    dims = C.ERNIE_BASE
    L, V = dims['layers'], dims['vocab']
    arrays = C.mlm_batch(V, HAPI_ROWS, 512, 256, 512, seed=0)[:4]
    held = C.mlm_batch(V, HAPI_BATCH, 512, 256, 512, seed=1)[:4]
    net = C.ernie_mlm(paddle, **dims)
    opt, sched = C.mlm_optimizer(paddle, net)
    model = paddle.Model(net, inputs=HAPI_INPUTS, labels=['labels'])
    model.prepare(opt, C.mlm_loss(paddle, V))
    loader = paddle.io.DataLoader(C.mlm_rows(paddle, arrays),
                                  batch_size=HAPI_BATCH, shuffle=True,
                                  num_workers=2)
    held_loader = paddle.io.DataLoader(C.mlm_rows(paddle, held),
                                       batch_size=HAPI_BATCH)
    save_dir = tempfile.mkdtemp(prefix='chip_smoke_hapi_')
    per_step = {'flash_fwd': L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    # host time of the step's two parts, enqueue only (no sync): the
    # forward and backward, and the update (functional_apply)
    host = {'_loss_and_grads': [], '_apply': []}

    def host_timed(name):
        inner = getattr(model, name)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = inner(*a, **k)
            host[name].append(time.perf_counter() - t0)
            return out
        setattr(model, name, run)
    for name in host:
        host_timed(name)
    per_eval = {'flash_fwd': L}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            probe = _StepProbe(paddle, kernels, caught)
            waits0, saves0 = _hist('train.data_wait_ms'), _hist(
                'ckpt.save_ms')
            pooled = obs.counter('data.native_batches')
            pooled0 = pooled.value
            torch.cuda.set_sync_debug_mode('warn')
            try:
                with paddle.amp.auto_cast(dtype='bfloat16'):
                    _, fit_s = timed(lambda: model.fit(
                        loader, epochs=HAPI_EPOCHS, log_freq=HAPI_LOG_FREQ,
                        save_dir=save_dir, save_freq=HAPI_EPOCHS,
                        verbose=0, callbacks=[
                            probe.cb,
                            paddle.callbacks.LRScheduler(by_step=True)]))
            finally:
                torch.cuda.set_sync_debug_mode('default')
        steps = probe.steps
        if len(steps) != HAPI_EPOCHS * HAPI_ROWS // HAPI_BATCH:
            raise AssertionError(f'hapi fit ran {len(steps)} steps')
        # every batch from the native pool, and no warned degrade or
        # failed save behind a passing fit; other warnings are shown
        fit_warnings = [f'{w.category.__name__}: {w.message}' for w in caught
                        if 'synchroniz' not in str(w.message)]
        if pooled.value - pooled0 != len(steps) or any(
                'native DataLoader worker pool' in m or 'checkpoint' in m
                for m in fit_warnings):
            raise AssertionError(
                f'hapi fit: {pooled.value - pooled0} of {len(steps)} batches '
                f'from the native pool; warnings {fit_warnings}')
        for m in dict.fromkeys(fit_warnings):
            print(f'  warning during fit: {m}', flush=True)
        for s in steps:
            want = {k: per_step.get(k, 0) for k in s['launches']}
            if s['launches'] != want or any(s['tc'][k] != want[k]
                                            for k in TC_KERNELS):
                raise AssertionError(f'hapi step {s}: want {want}, all '
                                     'tensor-core')
        logged = [s['syncs'] for s in steps if s['logged']]
        quiet = [s['syncs'] for s in steps if not s['logged']]
        if not quiet or max(quiet) >= 1 or min(logged) < 1:
            raise AssertionError(f'hapi host syncs: logging steps {logged}, '
                                 f'the others {quiet} (want none)')
        n_w, s_w = (a - b for a, b in zip(_hist('train.data_wait_ms'),
                                          waits0))
        n_s, s_s = (a - b for a, b in zip(_hist('ckpt.save_ms'), saves0))
        if n_s != 4:                   # <save_dir>/0 and final, two files
            raise AssertionError(f'hapi fit saved {n_s} files, want 4')
        # host time between step ends inside an epoch: the loop's pace
        per_epoch = len(steps) // HAPI_EPOCHS
        inner = [i for i in range(len(steps)) if i % per_epoch]
        step_ms = 1e3 * sum(probe.ends[i] - probe.ends[i - 1]
                            for i in inner) / len(inner)
        # of which inside the step (train_batch, the loss read at a log
        # point, the callbacks' ends) and between steps (the data wait,
        # the loop, the callbacks' begins)
        in_step_ms = 1e3 * sum(probe.ends[i] - probe.begins[i]
                               for i in inner) / len(inner)
        grads_ms, update_ms = (1e3 * sum(host[n][i] for i in inner)
                               / len(inner)
                               for n in ('_loss_and_grads', '_apply'))

        def held_run(fn):
            zero_launches(kernels)
            with paddle.amp.auto_cast(dtype='bfloat16'):
                out, secs = timed(fn)
            got = launch_counts(kernels)
            want = {k: per_eval.get(k, 0) for k in got}
            if got != want or kernels['flash_fwd'].tc_launches != L:
                raise AssertionError(f'hapi eval/predict batch: launches '
                                     f'{got}, want {want}, tensor-core')
            return out, secs, got

        ev, ev_s, ev_n = held_run(lambda: model.evaluate(held_loader,
                                                         verbose=0))
        pred, pred_s, pred_n = held_run(lambda: model.predict(held_loader))
        final = os.path.join(save_dir, 'final')
        sizes = {ext: os.path.getsize(final + ext)
                 for ext in ('.pdparams', '.pdopt')}
        paddle.seed(1)
        fresh = C.ernie_mlm(paddle, **dims)
        opt2, _ = C.mlm_optimizer(paddle, fresh)
        model2 = paddle.Model(fresh, inputs=HAPI_INPUTS, labels=['labels'])
        model2.prepare(opt2, C.mlm_loss(paddle, V))
        _, load_s = timed(lambda: model2.load(final))
        pred2, _, pred2_n = held_run(lambda: model2.predict(held_loader))
        logits, logits2 = pred[0][0], pred2[0][0]
        # phase 25's bare loop on this model and batch shape, in this
        # phase: its host time split as hapi's
        batch = [paddle.to_tensor(a[:HAPI_BATCH]) for a in arrays]
        bare = []

        def bare_step():
            t0 = time.perf_counter()
            with paddle.amp.auto_cast(dtype='bfloat16'):
                loss = net.loss(*batch)
            loss.backward()
            t1 = time.perf_counter()
            opt.step()
            opt.clear_grad()
            sched.step()
            bare.append((t1 - t0, time.perf_counter() - t1))
        net.train()                    # predict left it in eval mode
        for _ in range(2):
            bare_step()
        bare.clear()
        _, bare_s = timed(lambda: [bare_step() for _ in range(5)])
        bare_here = {'step_ms': 1e3 * bare_s / 5,
                     'forward_backward_host_ms':
                     1e3 * sum(b[0] for b in bare) / 5,
                     'update_host_ms': 1e3 * sum(b[1] for b in bare) / 5}
        same = bool(np.array_equal(logits, logits2))
        opt_same = all(torch.equal(a, model2._opt_state[n][k])
                       for n, st in model._opt_state.items()
                       for k, a in st.items())
        feeds, feed_n = _hapi_feeds(paddle, C, model, arrays, kernels,
                                    per_step)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    losses = [float(x) for x in probe.losses]
    eval_loss = ev.get('loss')
    if not all(map(math.isfinite, losses + [eval_loss])) or logits.shape != (
            HAPI_BATCH, 512, V) or not np.isfinite(logits).all():
        raise AssertionError(f'hapi: losses {losses}, eval loss '
                             f'{eval_loss}, logits {logits.shape}')
    if not same or not opt_same:
        raise AssertionError(f'hapi: the reloaded model\'s logits equal '
                             f'{same}, optimizer state equal {opt_same}')
    totals = {k: sum(s['launches'][k] for s in steps) + ev_n[k] + pred_n[k]
              + pred2_n[k] + feed_n[k] for k in kernels}
    res = {'steps': len(steps), 'fit_s': fit_s, 'step_ms': step_ms,
           'in_step_ms': in_step_ms, 'between_steps_ms': step_ms - in_step_ms,
           'forward_backward_host_ms': grads_ms, 'update_host_ms': update_ms,
           'bare_here': bare_here,
           'bare_step_ms': bare_step_ms,
           'overhead_ms': step_ms - bare_step_ms,
           'data_wait_ms': s_w / max(n_w, 1), 'data_waits': n_w,
           'data_wait_p50_ms': obs.histogram('train.data_wait_ms')
           .percentile(50),
           'syncs_logged': logged, 'syncs_quiet': quiet,
           'window_waits': [s['window_waits'] for s in steps],
           'losses': losses, 'eval': ev, 'eval_s': ev_s,
           'predict_s': pred_s, 'bytes': sizes,
           'save_ms_per_file': s_s / max(n_s, 1), 'saves': n_s,
           'load_ms': 1e3 * load_s, 'launches': totals,
           'reload_logits_equal': same, 'feeds': feeds,
           'fit_warnings': fit_warnings}
    print(f'  hapi fit: {len(steps)} steps in {fit_s:.2f} s (two saves of '
          f'<save_dir>/0 and final included); {step_ms:.1f} ms a step '
          f'between step ends against phase 25\'s bare loop '
          f'{bare_step_ms:.1f} ms (hapi over it {step_ms - bare_step_ms:+.1f}'
          f' ms); data wait {res["data_wait_ms"]:.3f} ms a step over '
          f'{n_w} waits (median {res["data_wait_p50_ms"]:.3f}); of a step '
          f'{in_step_ms:.1f} ms inside it, {step_ms - in_step_ms:.1f} ms '
          f'between steps [{card}]', flush=True)
    print(f'  inside a step, host time: forward and backward '
          f'{grads_ms:.1f} ms, the update (functional_apply) {update_ms:.1f}'
          f' ms, the rest {in_step_ms - grads_ms - update_ms:.1f} ms; '
          f'phase 25\'s loop on this model in this phase '
          f'{bare_here["step_ms"]:.1f} ms a step (5 steps, host: loss and '
          f'backward {bare_here["forward_backward_host_ms"]:.1f} ms, '
          f'opt.step, clear_grad, sched.step '
          f'{bare_here["update_host_ms"]:.1f} ms)', flush=True)
    print(f'  host syncs a step (sync debug mode): logging steps {logged}, '
          f'the others {quiet}; in-flight window waits a step '
          f'{res["window_waits"]}', flush=True)
    print(f'  losses {" ".join(f"{x:.4f}" for x in losses)}', flush=True)
    for w, runs in feeds.items():
        first, later, fit_ms = (' / '.join(f'{r[k]:.3f}' for r in runs)
                                for k in ('first_wait_ms', 'later_wait_ms',
                                          'fit_ms_per_step'))
        print(f'  data wait under prefetch, num_workers={w} (runs in the '
              f'order 0 2 2 0): first batch {first} ms, later batches '
              f'{later} ms each; fit {fit_ms} ms a step [{card}]',
              flush=True)
    print(f'  launches a train step {per_step} (all tensor-core), a held '
          f'batch evaluate {ev_n["flash_fwd"]} / predict '
          f'{pred_n["flash_fwd"]} flash_fwd; eval loss {eval_loss:.4f} '
          f'({1e3 * ev_s:.1f} ms), predict {1e3 * pred_s:.1f} ms', flush=True)
    print(f'  checkpoint: .pdparams {sizes[".pdparams"]} B, .pdopt '
          f'{sizes[".pdopt"]} B; {n_s} file saves at '
          f'{res["save_ms_per_file"]:.1f} ms each; Model.load '
          f'{res["load_ms"]:.1f} ms; reloaded predict logits equal bit for '
          f'bit: {same}', flush=True)
    del model, model2, net, fresh, opt, opt2, pred, pred2, batch
    paddle.set_device('cpu')
    torch.cuda.empty_cache()
    return res


HAPI_CARD_ROWS = 4          # phase 28's rows: 2 fit steps of 2 (cut from
                            # 6 rows, 3 steps, for the time budget)


def phase_hapi_card_vs_cpu():
    """Phase 28: the program at 2 layers in f32 (dropout 0, [2, 128],
    lengths 64-128) as a hapi Model from the same weights on the card and
    on the CPU, fit 2 shuffled steps under one np.random.seed (AdamW at
    peak 1e-2): the losses and the parameters after the steps within 1e-4
    through torch_nn_cases.mlm_agreement, as phase 26; a .pdparams /
    .pdopt pair written on the card loads on the CPU bit-exact, and the
    reverse; evaluate's Accuracy equal on both devices from the same
    weights."""
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fa
    C = nn_cases()
    dims = dict(C.ERNIE_BASE, layers=2, dropout=0.0)
    V = dims['vocab']
    arrays = C.mlm_batch(V, HAPI_CARD_ROWS, 128, 64, 128, seed=1)[:4]
    before = {k: getattr(fa, k).launches for k in TC_KERNELS}

    def hapi_model(net):
        opt, _ = C.mlm_optimizer(paddle, net, peak=1e-2, warmup=0)
        calls = C.record_applies(opt)
        model = paddle.Model(net, inputs=HAPI_INPUTS, labels=['labels'])
        model.prepare(opt, C.mlm_loss(paddle, V),
                      metrics=paddle.metric.Accuracy())
        return model, calls

    def fit(net):
        model, calls = hapi_model(net)
        loader = paddle.io.DataLoader(C.mlm_rows(paddle, arrays),
                                      batch_size=2, shuffle=True)
        np.random.seed(3)
        return model, C.fit_record(paddle, model, loader, 1, calls)

    paddle.set_device('cpu')
    paddle.seed(0)
    cpu_net = C.ernie_mlm(paddle, **dims)
    sd = C.state_of(cpu_net)
    cpu_model, want = fit(cpu_net)
    paddle.set_device('gpu')
    card_net = C.ernie_mlm(paddle, **dims)
    card_net.set_state_dict(sd)
    card_model, got = fit(card_net)
    agree = C.mlm_agreement(got, want, sd)
    d = tempfile.mkdtemp(prefix='chip_smoke_hapi_')
    try:
        exact = {}
        for src, dst_dev, tag in ((card_model, 'cpu', 'card->cpu'),
                                  (cpu_model, 'gpu', 'cpu->card')):
            src.save(os.path.join(d, tag))
            paddle.set_device(dst_dev)
            paddle.seed(5)
            dst, _ = hapi_model(C.ernie_mlm(paddle, **dims))
            dst.load(os.path.join(d, tag))
            exact[tag] = all(torch.equal(
                v._value.cpu(), dst.network.state_dict()[k]._value.cpu())
                for k, v in src.network.state_dict().items()) and all(
                torch.equal(a.cpu(), dst._opt_state[n][k].cpu())
                for n, st in src._opt_state.items() for k, a in st.items())
            if tag == 'cpu->card':
                card_copy = dst
        held = paddle.io.DataLoader(C.mlm_rows(paddle, arrays), batch_size=2)
        ev_card = card_copy.evaluate(held, verbose=0)
        paddle.set_device('cpu')
        ev_cpu = cpu_model.evaluate(held, verbose=0)
    finally:
        shutil.rmtree(d, ignore_errors=True)
        paddle.set_device('cpu')
        for k, n in before.items():
            getattr(fa, k).launches = n
    print(f'  hapi card vs CPU (2 layers, f32, {HAPI_CARD_ROWS // 2} steps): '
          f'losses {agree["loss"]:.2e}, first gradients {agree["grad"]:.2e}, '
          f'parameters beyond the gradients\' gaps {agree["param"]:.2e} '
          f'(tol 1e-4; raw {agree["param_raw"]:.2e}); checkpoints '
          f'bit-exact {exact}; evaluate card {ev_card} CPU {ev_cpu} '
          f'{"OK" if agree["ok"] else "FAIL"}', flush=True)
    if not agree['ok'] or not all(exact.values()) or \
            ev_card['acc'] != ev_cpu['acc'] or \
            len(got[0]) != HAPI_CARD_ROWS // 2:
        raise AssertionError(f'hapi card vs CPU: {agree}, checkpoints '
                             f'{exact}, evaluate {ev_card} / {ev_cpu}')
    return {'program': agree, 'checkpoints_exact': exact,
            'evaluate': {'card': ev_card, 'cpu': ev_cpu}}


# ---------------------------------------------------------------------------
# phases 29-30: the vision model zoo (conv, pooling, BatchNorm) through hapi
# ---------------------------------------------------------------------------
RESNET_ROWS, RESNET_BATCH, RESNET_EPOCHS, RESNET_LOG_FREQ = 256, 64, 2, 2
RESNET_IMAGE = (3, 224, 224)
# the autograd nodes BatchNorm's forward makes (port nn/functional/norm.py)
BN_NODES = ('MeanBackward', 'SubBackward', 'PowBackward', 'RsqrtBackward',
            'AddBackward', 'MulBackward', 'ViewBackward',
            'UnsafeViewBackward', 'ReshapeAliasBackward')


def conv_fc_flops(paddle, net, image):
    """Forward FLOPs of one image through ``net``, from each Conv2D's and
    Linear's real output shape: 2 a multiply-add."""
    nn = paddle.nn
    total = [0]

    def hook(layer, inputs, out):
        n_out = int(np.prod(out.shape))
        if isinstance(layer, nn.Conv2D):
            k = layer._kernel_size
            total[0] += (2 * n_out * (layer._in_channels // layer._groups)
                         * k[0] * k[1])
        else:
            total[0] += 2 * n_out * layer.weight.shape[0]
    hooks = [l.register_forward_post_hook(hook) for l in net.sublayers()
             if isinstance(l, (nn.Conv2D, nn.Linear))]
    was = net.training
    net.eval()
    with paddle.no_grad():
        net(paddle.zeros([1] + list(image)))
    for h in hooks:
        h.remove()
    if was:
        net.train()
    return total[0]


def _events_device_ms(events, pick):
    return sum(e.device_time_total for e in events if pick(e)) / 1e3


@contextlib.contextmanager
def tagged_profile(paddle, tags=()):
    """torch.profiler over the body, with every BatchNorm layer's forward
    in a ``paddle::batch_norm`` range and each (module, name) of ``tags``
    wrapped in a ``paddle::<name>`` range. Yields (the profiler, the start
    time); the profiler's ``kernels`` are the device events, set on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function
    bn_cls = paddle.nn.layer_norm_layers._BatchNormBase
    saved = [(bn_cls, 'forward', bn_cls.forward)] + [
        (mod, name, getattr(mod, name)) for mod, name in tags]

    def ranged(fn, label):
        def run(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return run
    bn_cls.forward = ranged(bn_cls.forward, 'paddle::batch_norm')
    for mod, name, fn in saved[1:]:
        setattr(mod, name, ranged(fn, f'paddle::{name}'))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            yield p, time.perf_counter()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    p.kernels = [e for e in p.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def tagged_device_ms(events):
    """(device ms of every kernel, device ms by op (each op's own
    kernels), BatchNorm's device ms: its forward ranges and the backward
    nodes of the ops inside them, matched by autograd sequence number, the
    events)."""
    seqs = set()
    for e in events:
        a = e.cpu_parent
        while a is not None and a.name != 'paddle::batch_norm':
            a = a.cpu_parent
        if a is not None and e.sequence_nr >= 0:
            seqs.add(e.sequence_nr)
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    by_op = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total:
            by_op[e.name] = by_op.get(e.name, 0.0) + \
                e.self_device_time_total / 1e3
    bn = _events_device_ms(events, lambda e: e.name == 'paddle::batch_norm')
    bn += _events_device_ms(events, lambda e: e.name.startswith(
        'autograd::engine::evaluate_function') and e.sequence_nr in seqs
        and any(n in e.name for n in BN_NODES))
    return total, by_op, bn, events


def profile_vision_step(paddle, model, inputs, labels):
    """One hapi train step of ``model`` (under the caller's amp), its two
    parts profiled apart: the forward and backward (``_loss_and_grads``)
    and the update (``_apply``, the optimizer). Device ms by kind: cuDNN's
    convolutions (the kernels of ``aten::cudnn_convolution`` and
    ``aten::convolution_backward``), BatchNorm (its layers' forward, in
    record_function ranges, and the backward nodes of the ops inside them,
    matched by autograd sequence number), the GEMMs (the fc), the rest of
    the forward and backward (ReLU, the residual adds, pooling, the loss),
    and the optimizer's window."""
    with tagged_profile(paddle) as (p, t0):
        _, _, grads = model._loss_and_grads(inputs, labels)
        torch.cuda.synchronize()
        grads_wall = time.perf_counter() - t0
    total, by_op, bn, _ = tagged_device_ms(p.events())
    kernels = p.kernels
    conv = sum(by_op.get(o, 0.0) for o in (
        'aten::cudnn_convolution', 'aten::convolution_backward'))
    gemm = sum(by_op.get(o, 0.0) for o in ('aten::mm', 'aten::addmm'))
    out = {}
    out['forward_backward'] = {
        'window_ms': grads_wall * 1e3, 'device_ms': total,
        'kernels': len(kernels), 'busy_share': total / (grads_wall * 1e3)}
    opt = profile_window(lambda: model._apply(grads))
    out['optimizer'] = {k: opt[k] for k in ('window_ms', 'device_ms',
                                            'kernels', 'busy_share')}
    out['device_ms_by_kind'] = {
        'conv': conv, 'batch_norm': bn, 'gemm': gemm,
        'rest': total - conv - bn - gemm, 'optimizer': opt['device_ms']}
    out['launches_per_step'] = len(kernels) + opt['kernels']
    out['device_ms'] = total + opt['device_ms']
    out['window_ms'] = out['forward_backward']['window_ms'] + opt['window_ms']
    out['busy_share'] = out['device_ms'] / out['window_ms']
    return out


def bn_statistics(net):
    return {k: v._value.detach().clone() for k, v in net.state_dict().items()
            if k.endswith(('_mean', '_variance'))}


def phase_resnet_hapi(kernels, card):
    """Phase 29: ResNet-50 (vision.models.resnet50(num_classes=1000),
    25.6M parameters, random weights from paddle.seed(0)) through hapi as
    examples/train_resnet.py trains it: paddle.Model(net).prepare(AdamW(
    1e-3, grad_clip=ClipGradByGlobalNorm(1.0)), CrossEntropyLoss(),
    Accuracy(), amp_configs='O1'), fit under auto_cast(bfloat16) over a
    TensorDataset of 256 rows [3, 224, 224] (numpy seed 0, labels in [0,
    1000)), batch 64, 2 epochs (8 steps), num_workers=0, log_freq 2.
    Prints ms a step between step ends and images/s, MFU (3 x forward
    FLOPs counted from each conv's and the fc's output shapes x images/s
    over 989 TFLOP/s), peak memory, a profiled step's busy share, device
    ms by kind and launches, host syncs (train_batch must make none; the
    loop reads Accuracy's count each step and the loss at log points);
    then evaluate and predict on 64 held rows (seed 1), and
    Model.save / Model.load into a fresh Model whose predict logits must
    equal; then predict of resnet18 at batch 1 and 32. Fails on a
    non-finite loss, a BatchNorm whose running statistics did not move in
    fit, a kernel of the seven launched, or unequal reloaded logits."""
    import shutil
    import tempfile
    import warnings
    import paddle_tpu_torch as paddle
    nn = paddle.nn
    paddle.set_device('gpu')
    paddle.seed(0)
    np.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    net = paddle.vision.models.resnet50(num_classes=1000)
    n_params = sum(p.size for p in net.parameters())
    flops_img = conv_fc_flops(paddle, net, RESNET_IMAGE)
    rs = np.random.RandomState(0)
    data = paddle.io.TensorDataset([
        paddle.to_tensor(rs.randn(RESNET_ROWS, *RESNET_IMAGE)
                         .astype('float32'), place='cpu'),
        paddle.to_tensor(rs.randint(0, 1000, (RESNET_ROWS, 1))
                         .astype('int64'), place='cpu')])
    hs = np.random.RandomState(1)
    held = paddle.io.TensorDataset([
        paddle.to_tensor(hs.randn(RESNET_BATCH, *RESNET_IMAGE)
                         .astype('float32'), place='cpu'),
        paddle.to_tensor(hs.randint(0, 1000, (RESNET_BATCH, 1))
                         .astype('int64'), place='cpu')])

    def hapi_model(network):
        model = paddle.Model(network)
        model.prepare(paddle.optimizer.AdamW(
            1e-3, parameters=model.parameters(),
            grad_clip=nn.ClipGradByGlobalNorm(1.0)), nn.CrossEntropyLoss(),
            paddle.metric.Accuracy(), amp_configs='O1')
        return model
    model = hapi_model(net)
    stats0 = bn_statistics(net)
    save_dir = tempfile.mkdtemp(prefix='chip_smoke_resnet_')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            probe = _StepProbe(paddle, kernels, caught)
            # the syncs of train_batch itself, apart from the loop's reads
            # (the loss at log points, Accuracy's count every step)
            in_step, train_batch = [], model.train_batch

            def counted(*a, **k):
                n0 = len(caught)
                out = train_batch(*a, **k)
                in_step.append(sum('synchroniz' in str(w.message)
                                   for w in caught[n0:]))
                return out
            model.train_batch = counted
            torch.cuda.set_sync_debug_mode('warn')
            try:
                with paddle.amp.auto_cast(dtype='bfloat16'):
                    _, fit_s = timed(lambda: model.fit(
                        data, batch_size=RESNET_BATCH, epochs=RESNET_EPOCHS,
                        num_workers=0, log_freq=RESNET_LOG_FREQ, verbose=0,
                        callbacks=[probe.cb]))
            finally:
                torch.cuda.set_sync_debug_mode('default')
                model.train_batch = train_batch
        steps = probe.steps
        per_epoch = RESNET_ROWS // RESNET_BATCH
        if len(steps) != RESNET_EPOCHS * per_epoch:
            raise AssertionError(f'resnet fit ran {len(steps)} steps')
        launched = [s for s in steps if any(s['launches'].values())]
        if launched:
            raise AssertionError(f'resnet fit launched a kernel of the '
                                 f'seven: {launched[0]}')
        logged = [s['syncs'] for s in steps if s['logged']]
        quiet = [s['syncs'] for s in steps if not s['logged']]
        # train_batch none; the loop reads Accuracy's count every step (one
        # sync, as the reference's fit does) and the loss at log points
        if len(in_step) != len(steps) or any(in_step) or not quiet or \
                set(quiet) != {1} or set(logged) != {2}:
            raise AssertionError(f'resnet host syncs: in train_batch '
                                 f'{in_step} (want none), whole steps: '
                                 f'logging {logged} (want 2: the loss and '
                                 f'Accuracy), the others {quiet} (want 1)')
        stats1 = bn_statistics(net)
        still = [k for k, v in stats0.items() if torch.equal(v, stats1[k])]
        if still or len(stats0) != 2 * 53:
            raise AssertionError(f'resnet fit: {len(still)} of '
                                 f'{len(stats0)} BatchNorm statistics did '
                                 f'not move ({still[:4]})')
        # host time between step ends, each epoch's first step left out
        inner = [i for i in range(len(steps)) if i % per_epoch]
        gaps = [probe.ends[i] - probe.ends[i - 1] for i in inner]
        warm = [probe.ends[i] - probe.ends[i - 1] for i in inner
                if i >= per_epoch]
        step_ms = 1e3 * sum(warm) / len(warm)
        images_s = RESNET_BATCH * 1e3 / step_ms
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        x, y = (paddle.to_tensor(t.numpy()[:RESNET_BATCH])._value
                for t in data.tensors)
        with paddle.amp.auto_cast(dtype='bfloat16'):
            prof = profile_vision_step(paddle, model, [x], [y])
        ev, ev_s = timed(lambda: model.evaluate(held, batch_size=RESNET_BATCH,
                                                verbose=0))
        pred, pred_s = timed(lambda: model.predict(
            held, batch_size=RESNET_BATCH))
        path = os.path.join(save_dir, 'resnet50')
        _, save_s = timed(lambda: model.save(path))
        paddle.seed(7)
        model2 = hapi_model(paddle.vision.models.resnet50(num_classes=1000))
        _, load_s = timed(lambda: model2.load(path))
        pred2 = model2.predict(held, batch_size=RESNET_BATCH)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    losses = [float(v) for v in probe.losses]
    logits, logits2 = pred[0][0], pred2[0][0]
    same = bool(np.array_equal(logits, logits2))
    if not all(map(math.isfinite, losses + [ev['loss']])) or \
            logits.shape != (RESNET_BATCH, 1000) or \
            not np.isfinite(logits).all():
        raise AssertionError(f'resnet: losses {losses}, eval {ev}, logits '
                             f'{logits.shape}')
    if not same:
        raise AssertionError('resnet: the reloaded model\'s logits differ')
    # resnet18 served: predict at batch 1 and 32 (bench.py _child_predictor
    # serves batch 1), f32, after two warm-up calls
    paddle.seed(3)
    small = paddle.Model(paddle.vision.models.resnet18())
    small.prepare()
    serve = {}
    for b in (1, 32):
        xb = np.random.RandomState(b).randn(b, *RESNET_IMAGE).astype(
            'float32')
        for _ in range(2):
            small.predict_batch([xb])
        reps = 10
        _, secs = timed(lambda: [small.predict_batch([xb])
                                 for _ in range(reps)])
        serve[b] = 1e3 * secs / reps
    kinds = prof['device_ms_by_kind']
    res = {'params': n_params, 'forward_flops_per_image': flops_img,
           'losses': losses, 'fit_s': fit_s, 'step_ms': step_ms,
           'step_ms_all_inner': [1e3 * g for g in gaps],
           'images_per_s': images_s,
           'mfu': 3 * flops_img * images_s / PEAK_BF16,
           'peak_mem_gb': peak_gb, 'profile': prof,
           'syncs_in_train_batch': in_step, 'syncs_logged': logged,
           'syncs_quiet': quiet,
           'bn_statistics_moved': len(stats0), 'eval': ev,
           'eval_ms': 1e3 * ev_s, 'predict_ms': 1e3 * pred_s,
           'save_s': save_s, 'load_s': load_s, 'reload_logits_equal': same,
           'resnet18_predict_ms': serve,
           'launches': {k: 0 for k in kernels}}
    print(f'  ResNet-50 ({n_params / 1e6:.2f}M params, '
          f'{flops_img / 1e9:.3f} GFLOP a forward image) through '
          f'Model.fit, {[RESNET_BATCH, *RESNET_IMAGE]}, bf16 amp O1, AdamW + '
          f'global-norm clip: {step_ms:.1f} ms a step (epoch 2, between '
          f'step ends), {images_s:.1f} images/s, MFU '
          f'{100 * res["mfu"]:.2f}% of 989 TFLOP/s, peak {peak_gb:.2f} GB '
          f'[{card}]', flush=True)
    print(f'  every inner step, ms: '
          + ' '.join(f'{1e3 * g:.1f}' for g in gaps)
          + f'; fit {fit_s:.2f} s for {len(steps)} steps', flush=True)
    print(f'  profiled step: forward+backward window '
          f'{prof["forward_backward"]["window_ms"]:.1f} ms, device '
          f'{prof["forward_backward"]["device_ms"]:.1f} ms; update window '
          f'{prof["optimizer"]["window_ms"]:.1f} ms, device '
          f'{prof["optimizer"]["device_ms"]:.2f} ms; busy '
          f'{100 * prof["busy_share"]:.1f}%, {prof["launches_per_step"]} '
          f'launches a step', flush=True)
    print('  device ms by kind: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in kinds.items()), flush=True)
    print(f'  host syncs: in train_batch {in_step}; whole steps (the loop '
          f'reads Accuracy each step, the loss at log points) logging '
          f'{logged}, the others {quiet}; {len(stats0)} BatchNorm statistics '
          f'all moved', flush=True)
    print(f'  losses {" ".join(f"{v:.4f}" for v in losses)}; evaluate '
          f'{ev} in {1e3 * ev_s:.1f} ms, predict {1e3 * pred_s:.1f} ms; save '
          f'{save_s:.2f} s, load {load_s:.2f} s, reloaded logits equal: '
          f'{same}', flush=True)
    print(f'  resnet18 predict (f32): batch 1 {serve[1]:.2f} ms, batch 32 '
          f'{serve[32]:.2f} ms [{card}]', flush=True)
    del model, model2, net, small, pred, pred2, x, y, data, held
    paddle.set_device('cpu')
    torch.cuda.empty_cache()
    return res


VISION_CARD_TOL = 2e-5      # card vs CPU, f32, a part's largest value
VISION_CARD_STEPS = 3
NUDGE = 1e-7                # the input's relative move that sets the floor
NUDGE_SLACK = 4


def nudged(x):
    """``x`` moved by ``NUDGE`` relative, from a fixed seed."""
    return (x * (1 + NUDGE * np.random.RandomState(5).randn(
        *x.shape))).astype('float32')


def within_nudge_floor(gaps, floor, limits):
    """Phases 30 and 37: a train-mode BatchNorm over few values turns a
    1e-7 change of the input into ~1e-5 of the result, so each gap (card
    against CPU) is held within its tolerance beyond ``NUDGE_SLACK`` x
    ``floor``, what the card's own result moves when its input is
    ``nudged``."""
    return all(gaps[k] <= t + NUDGE_SLACK * floor[k]
               for k, t in limits.items())


def _vision_fit(paddle, C, make, start, dev, xs, ys):
    """``VISION_CARD_STEPS`` hapi fit steps (Adam 1e-4, batch 2, in
    order) of ``make(paddle)`` from the weights ``start`` on ``dev``,
    dropout at p 0 (its mask is each device's draw) -> (the running
    statistics after the first step, ``fit_record``'s tuple)."""
    paddle.set_device(dev)
    paddle.seed(0)
    net = make(paddle)
    for layer in net.sublayers():
        if isinstance(layer, paddle.nn.Dropout):
            layer.p = 0.0
    net.set_state_dict(start)
    model = paddle.Model(net)
    opt = paddle.optimizer.Adam(1e-4, parameters=net.parameters())
    calls = C.record_applies(opt)
    model.prepare(opt, paddle.nn.CrossEntropyLoss())
    loader = paddle.io.DataLoader(paddle.io.TensorDataset(
        [paddle.to_tensor(xs, place='cpu'),
         paddle.to_tensor(ys, place='cpu')]), batch_size=2)
    first, train_batch = {}, model.train_batch

    def record_first(*a, **k):
        out = train_batch(*a, **k)
        if not first:
            first.update(C.state_of(net))
        return out
    model.train_batch = record_first
    return first, C.fit_record(paddle, model, loader, 1, calls)


def _vision_agreement(got, want, start, stats):
    """mlm_agreement (plain Adam) over the parameters of two
    ``_vision_fit`` runs, and the largest gap of the running statistics
    over each one's largest value (at least 1) after the first step and
    after the last."""
    (got_first, got), (want_first, want) = got, want
    params = [k for k in start if k not in stats]
    agree = nn_cases().mlm_agreement(
        got[:3] + ({k: got[3][k] for k in params},),
        want[:3] + ({k: want[3][k] for k in params},),
        {k: start[k] for k in params}, coeff=0.0, clip_norm=None)

    def gap(a, b):
        return max([float(np.abs(a[k] - b[k]).max())
                    / max(1.0, float(np.abs(b[k]).max()))
                    for k in stats] + [0.0])
    agree['stats_first'] = gap(got_first, want_first)
    agree['stats_last'] = gap(got[3], want[3])
    return agree


def phase_vision_card_vs_cpu():
    """Phase 30, float32 with torch's default TF32 flags (cuDNN's
    allow_tf32 on: the port's float32 convs must turn it off themselves):
    every case of torch_nn_cases.J3_CASES card against CPU (outputs
    within 2e-5 and gradients within 1e-4 of the part's largest value,
    bfloat16 cases within their own tolerance); LeNet [2, 1, 28, 28],
    resnet18 and mobilenet_v2(scale=0.5) [2, 3, 64, 64] through 3 hapi
    fit steps (Adam 1e-4, dropout at p 0) from the same weights on both:
    losses within 2e-5 (relative), the parameters within 2e-5 beyond what
    float64 Adam makes of each device's own gradients
    (torch_nn_cases.mlm_agreement, as phase 28), the first gradients
    within 1e-4, the running statistics after the first step within 2e-5
    of each one's largest value (later steps' statistics come from weights
    that Adam's epsilon gaps part: printed); each gap beyond 4 x what the
    card's own run moves when its input moves by 1e-7 (train-mode
    BatchNorm over 8 values: ~5e-5 for mobilenet_v2); a resnet18
    .pdparams written on the card loads on the CPU bit-exact, and the
    reverse."""
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    C = nn_cases()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True          # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst, bad = {'out': 0.0, 'grad': 0.0, 'state': 0.0}, []
        for case in C.J3_CASES:
            paddle.set_device('cpu')
            cpu = C.run(paddle, case)
            paddle.set_device('gpu')
            card_res = C.run(paddle, case, state=cpu['before'])
            r = C.compare(card_res, cpu, case, *(
                case.tol or (NN_CARD_OUT_TOL, NN_CARD_GRAD_TOL)))
            if case.tol is None:
                for k in worst:
                    worst[k] = max(worst[k], r[k])
            if not r['ok']:
                bad.append((case.name, r))
        print(f'  J3 case table card vs CPU (cudnn.allow_tf32 True): '
              f'{len(C.J3_CASES)} cases, largest f32 output '
              f'{worst["out"]:.2e}, state {worst["state"]:.2e} (tol '
              f'{NN_CARD_OUT_TOL:g}), gradient {worst["grad"]:.2e} (tol '
              f'{NN_CARD_GRAD_TOL:g}) {"OK" if not bad else "FAIL"}',
              flush=True)
        if bad:
            raise AssertionError(f'J3 cases card vs CPU: {bad[:5]}')
        models = {
            'lenet': (lambda P: P.vision.models.LeNet(), (1, 28, 28)),
            'resnet18': (lambda P: P.vision.models.resnet18(num_classes=10),
                         (3, 64, 64)),
            'mobilenet_v2': (lambda P: P.vision.models.mobilenet_v2(
                scale=0.5, num_classes=10), (3, 64, 64))}
        agreement = {}
        for name, (make, image) in models.items():
            rs = np.random.RandomState(4)
            xs = rs.randn(2 * VISION_CARD_STEPS, *image).astype('float32')
            ys = rs.randint(0, 10, (2 * VISION_CARD_STEPS, 1)).astype('int64')
            paddle.set_device('cpu')
            paddle.seed(0)
            start = C.state_of(make(paddle))
            runs = {run: _vision_fit(paddle, C, make, start, dev, data, ys)
                    for run, dev, data in (('cpu', 'cpu', xs),
                                           ('card', 'gpu', xs),
                                           ('nudged', 'gpu', nudged(xs)))}
            stats = [k for k in start if k.endswith(('_mean', '_variance'))]
            agree = _vision_agreement(runs['card'], runs['cpu'], start,
                                      stats)
            floor = _vision_agreement(runs['nudged'], runs['card'], start,
                                      stats)
            agree['floor'] = floor
            agreement[name] = agree
            limits = {'loss': VISION_CARD_TOL, 'param': VISION_CARD_TOL,
                      'grad': 1e-4, 'stats_first': VISION_CARD_TOL}
            ok = within_nudge_floor(agree, floor, limits) \
                and len(runs['card'][1][0]) == VISION_CARD_STEPS
            print(f'  {name} hapi card vs CPU ({VISION_CARD_STEPS} steps, '
                  f'f32): losses {agree["loss"]:.2e}, first gradients '
                  f'{agree["grad"]:.2e}, parameters beyond Adam\'s gaps '
                  f'{agree["param"]:.2e} (raw {agree["param_raw"]:.2e}), '
                  f'running statistics after step 1 '
                  f'{agree["stats_first"]:.2e} (after step '
                  f'{VISION_CARD_STEPS}, from weights the raw gaps part, '
                  f'{agree["stats_last"]:.2e}); the card against itself '
                  f'with the input moved by 1e-7: losses {floor["loss"]:.2e},'
                  f' gradients {floor["grad"]:.2e}, parameters '
                  f'{floor["param"]:.2e}, statistics '
                  f'{floor["stats_first"]:.2e} (tol {VISION_CARD_TOL:g}, '
                  f'gradients 1e-4, each beyond 4 x that move) '
                  f'{"OK" if ok else "FAIL"}', flush=True)
            if not ok:
                raise AssertionError(f'{name} hapi card vs CPU: {agree}')
        d = tempfile.mkdtemp(prefix='chip_smoke_vision_')
        try:
            exact = {}
            for src_dev, dst_dev in (('gpu', 'cpu'), ('cpu', 'gpu')):
                paddle.set_device(src_dev)
                paddle.seed(5)
                src = paddle.vision.models.resnet18()
                src.train()
                src(paddle.to_tensor(np.random.RandomState(8).randn(
                    2, 3, 64, 64).astype('float32')))   # the stats move
                path = os.path.join(d, f'{src_dev}.pdparams')
                paddle.save(src.state_dict(), path)
                paddle.set_device(dst_dev)
                dst = paddle.vision.models.resnet18()
                dst.set_state_dict(paddle.load(path))
                exact[f'{src_dev}->{dst_dev}'] = all(
                    torch.equal(v._value.cpu(),
                                dst.state_dict()[k]._value.cpu())
                    for k, v in src.state_dict().items())
        finally:
            shutil.rmtree(d, ignore_errors=True)
        print(f'  resnet18 .pdparams across devices bit-exact: {exact}',
              flush=True)
        if not all(exact.values()):
            raise AssertionError(f'resnet18 checkpoints: {exact}')
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
        paddle.set_device('cpu')
    return {'cases': len(C.J3_CASES), 'case_errors': worst,
            'models': agreement, 'checkpoints_exact': exact}


# ---------------------------------------------------------------------------
# phases 31-33: ERNIE-base served (InferenceEngine, the Predictor, warmup)
# and pretrained
# ---------------------------------------------------------------------------

SERVE = dict(requests=160, lo=1, hi=17, s=128, len_lo=32, len_hi=128,
             seed=0)
SERVE_MAX_BATCH, SERVE_DELAY_MS = 64, 2.0
SERVE_TOL = 2.0 ** -6       # bf16 outputs against the Layer's, a row
PREDICTOR_P50_CALLS = 30
COLD_MAX_BATCH = 8
# cut for the time budget: the attach_layer Predictor serves the first 40
# of the 160 requests one at a time, and the cold-start processes serve
# ERNIE at full width and 2 of its 12 layers
PREDICTOR_REQUESTS = 40
COLD_LAYERS = 2


def serve_requests(vocab, requests, lo, hi, s, len_lo, len_hi, seed):
    """tools/serve_bench.py's stream shaped for ERNIE: ``requests``
    requests of lo-hi rows (numpy seed), each row ``s`` ids in [5, vocab),
    a real length drawn from len_lo-len_hi, the mask 1 up to it and the id
    0 after; token types 0. -> [(ids, types, mask)] int64."""
    rs = np.random.RandomState(seed)
    out = []
    for rows in rs.randint(lo, hi + 1, size=requests):
        ids = rs.randint(5, vocab, (rows, s)).astype(np.int64)
        lens = rs.randint(len_lo, len_hi + 1, rows)
        mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
        out.append((np.where(mask > 0, ids, 0), np.zeros_like(ids), mask))
    return out


def row_err(got, want):
    """The largest |got - want| of each output row (the last dim) over
    that row's largest |want|, the worst row; host arrays or tensors."""
    g = torch.as_tensor(np.asarray(got, dtype=np.float32))
    w = torch.as_tensor(np.asarray(want, dtype=np.float32))
    return kernel_err(g, w)[1]


def layer_outputs(paddle, net, req):
    """The Layer's direct forward of one request on its device, as host
    float32 arrays."""
    with paddle.no_grad():
        outs = net(*[paddle.to_tensor(a) for a in req])
    return [o.astype('float32').numpy() for o in outs]


def serving_kinds(prof):
    """A profiled forward's device ms by kind: the GEMMs (by the ops that
    launched them), kernel 1, the casts (weights to bf16 each forward, and
    activations), the readback (device to host copies) and the rest
    (LayerNorm, GELU, embeddings, elementwise)."""
    ops, names = prof['by_op'], prof['by_name']
    out = {'gemm': sum(ops.get(o, 0.0) for o in (
               'aten::mm', 'aten::addmm', 'aten::bmm', 'aten::baddbmm')),
           'kernel1': sum(ms for n, ms in names.items() if 'flash_' in n),
           'readback': sum(ms for n, ms in names.items()
                           if 'DtoH' in n or 'Device -> ' in n)}
    # aten::copy_ launched the casts and the readback's copy
    out['casts'] = max(0.0, ops.get('aten::copy_', 0.0) - out['readback'])
    out['rest'] = prof['device_ms'] - sum(out.values())
    return out


def phase_ernie_serving(kernels, card):
    """Phase 31: ERNIE-base served (see the module docstring)."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit, serving
    from paddle_tpu_torch.models import ernie
    from paddle_tpu_torch.static import InputSpec
    paddle.set_device('gpu')
    paddle.seed(0)
    marks = [('start', time.perf_counter())]
    cfg = ernie.ErnieConfig()
    torch.cuda.reset_peak_memory_stats()
    net = ernie.ErnieModel(cfg)
    n_params = sum(p.size for p in net.parameters())
    reqs = serve_requests(cfg.vocab_size, **SERVE)
    rows = sum(r[0].shape[0] for r in reqs)
    res = {'params': n_params, 'requests': len(reqs), 'rows': rows}
    L = cfg.num_layers

    # the engine: 7 captures at warmup, none from traffic
    eng = serving.InferenceEngine(net, max_batch_size=SERVE_MAX_BATCH,
                                  max_delay_ms=SERVE_DELAY_MS,
                                  queue_capacity=4 * len(reqs))
    t0 = time.perf_counter()
    report = eng.warmup('all_buckets',
                        input_spec=[((SERVE['s'],), 'int64')] * 3)
    res['warmup_s'] = time.perf_counter() - t0
    n_buckets = len(serving.bucket_sizes(SERVE_MAX_BATCH))
    if eng._trace_count != n_buckets or report['prebuilt'] != n_buckets:
        raise AssertionError(f'engine warmup: {eng._trace_count} captures, '
                             f'report {report}; want {n_buckets}')

    def traffic():
        eng._stats.reset()
        zero_launches(kernels)
        t0 = time.perf_counter()
        futs = [eng.submit(*r) for r in reqs]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        return outs, wall, eng.stats(), launch_counts(kernels)

    outs, wall, st, got = traffic()
    if eng._trace_count != n_buckets:
        raise AssertionError(f'engine: {eng._trace_count - n_buckets} '
                             'captures during traffic, want 0')
    expect_launches('engine traffic', got, {'flash_fwd': L * st['batches']})
    expect_tensor_core('engine traffic', kernels)
    res['launches'] = got
    for (h, p), r in zip(outs, reqs):
        n = r[0].shape[0]
        if h.shape != (n, SERVE['s'], cfg.hidden_size) or \
                p.shape != (n, cfg.hidden_size) or h.dtype != np.float32:
            raise AssertionError(f'engine output shapes {h.shape} '
                                 f'{p.shape} {h.dtype} for {n} rows')
        if not (np.isfinite(h).all() and np.isfinite(p).all()):
            raise AssertionError('engine: a non-finite output')
    errs = [max(row_err(o, w) for o, w in zip(
        outs[i], layer_outputs(paddle, net, reqs[i]))) for i in range(8)]
    res['vs_layer_row_err'] = max(errs)
    if not res['vs_layer_row_err'] <= SERVE_TOL:
        raise AssertionError(f'engine outputs against the Layer\'s: row '
                             f'error {errs} (tol {SERVE_TOL:g})')
    res.update(requests_per_s=len(reqs) / wall, rows_per_s=rows / wall,
               wall_s=wall,
               **{k: st[k] for k in (
                   'latency_ms_p50', 'latency_ms_p99', 'queue_wait_ms_p50',
                   'queue_wait_ms_p99', 'avg_batch_size', 'pad_waste_pct',
                   'batches', 'exec_ms_p50', 'compiles')})
    # a second pass profiled: the busy share over the whole traffic
    prof = profile_window(lambda: traffic())
    res['busy_share'] = prof['busy_share']
    res['traffic_profile'] = {k: prof[k] for k in (
        'window_ms', 'device_ms', 'busy_share', 'kernels', 'top')}
    # one full bucket's forward, eager, profiled by kind with its readback
    padded = [torch.as_tensor(serving.pad_rows(np.concatenate(
        [r[i] for r in reqs])[:SERVE_MAX_BATCH], SERVE_MAX_BATCH),
        device='cuda') for i in range(3)]

    def one_batch():
        with torch.no_grad():
            return serving.engine.host_outputs(eng._forward(*padded))
    one_batch()
    bprof = profile_window(one_batch)
    res['bucket64_ms_by_kind'] = serving_kinds(bprof)
    res['bucket64_device_ms'] = bprof['device_ms']
    res['readback_bytes'] = SERVE_MAX_BATCH * SERVE['s'] * \
        cfg.hidden_size * 4
    res['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    eng.shutdown()
    print(f'  ERNIE-base ({n_params / 1e6:.1f}M params, bf16 over f32) in '
          f'InferenceEngine(max_batch_size={SERVE_MAX_BATCH}, max_delay_ms='
          f'{SERVE_DELAY_MS}): {n_buckets} captures at warmup '
          f'({res["warmup_s"]:.2f} s), 0 from traffic [{card}]', flush=True)
    print(f'  {len(reqs)} requests ({rows} rows of {SERVE["s"]}): '
          f'{res["requests_per_s"]:.1f} requests/s, {res["rows_per_s"]:.1f} '
          f'rows/s; latency p50 {st["latency_ms_p50"]} ms p99 '
          f'{st["latency_ms_p99"]} ms, queue wait p50 '
          f'{st["queue_wait_ms_p50"]} ms; {st["batches"]} batches, '
          f'{st["avg_batch_size"]} rows a batch, padded share '
          f'{st["pad_waste_pct"]}%; kernel 1 {got["flash_fwd"]} launches '
          f'({L} a batch); outputs vs the Layer row error '
          f'{res["vs_layer_row_err"]:.3e}', flush=True)
    print(f'  traffic profiled: window {prof["window_ms"]:.1f} ms, device '
          f'{prof["device_ms"]:.1f} ms (busy {100 * prof["busy_share"]:.1f}'
          f'%); peak memory {res["peak_mem_gb"]:.2f} GB', flush=True)
    print('  one bucket-64 forward, eager, device ms by kind: ' + ', '.join(
        f'{k} {v:.3f}' for k, v in res['bucket64_ms_by_kind'].items())
        + f' (total {bprof["device_ms"]:.3f}; readback '
        f'{res["readback_bytes"] / 1e6:.1f} MB of float32)', flush=True)

    marks.append(('engine', time.perf_counter()))
    # the Predictor: jit.save's weights, then attach_layer one request at a
    # time (no program: attach_layer runs the Layer on graphs)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_ernie_')
    path = os.path.join(tmp, 'ernie')
    jit.save(net, path)
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    pred.attach_layer(ernie.ErnieModel(cfg))
    for n in sorted({r[0].shape[0] for r in reqs}):     # every shape warm
        pred.run([np.repeat(a[:1], n, axis=0) for a in reqs[0]])
    zero_launches(kernels)
    t0 = time.perf_counter()
    preqs = reqs[:PREDICTOR_REQUESTS]
    for r in preqs:
        pred.run(list(r))
    pwall = time.perf_counter() - t0
    got = launch_counts(kernels)
    expect_launches('Predictor.run (attach_layer) traffic', got,
                    {'flash_fwd': L * len(preqs)})
    res['predictor'] = {'requests_per_s': len(preqs) / pwall,
                        'captures': pred._trace_count, 'launches': got}
    print(f'  Predictor.run + attach_layer, one request at a time: '
          f'{len(preqs) / pwall:.1f} requests/s ({pred._trace_count} '
          f'captures, one a row count); the engine '
          f'{res["requests_per_s"] / (len(preqs) / pwall):.2f}x', flush=True)
    del pred
    marks.append(('predictor', time.perf_counter()))
    # the layer-free Predictor over the .pt2 program of ERNIE at full width
    # and PREDICTOR_LAYERS layers (the export's trace time grows with the
    # depth: 43.5-76.0 s at 12 layers)
    paddle.seed(1)
    lcfg = ernie.ErnieConfig(num_layers=PREDICTOR_LAYERS)
    lnet = ernie.ErnieModel(lcfg)
    lnet.eval()
    lpath = os.path.join(tmp, 'ernie_lf')
    t0 = time.perf_counter()
    jit.save(lnet, lpath, input_spec=[InputSpec([-1, SERVE['s']],
                                                'int64')] * 3)
    res['jit_save_s'] = time.perf_counter() - t0
    with open(lpath + '.pdmodel') as f:
        meta = json.load(f)
    if not (meta.get('exported') and meta.get('poly_batch')):
        raise AssertionError(f'jit.save: no dynamic program {meta}')
    LL = lcfg.num_layers
    lf = inference.create_predictor(inference.Config(lpath + '.pdmodel'))
    lf_launches = 0
    for n in (1, 16):
        req = serve_requests(cfg.vocab_size, 1, n, n, SERVE['s'], 32, 128,
                             seed=7 + n)[0]
        zero_launches(kernels)
        out = lf.run(list(req))
        got = launch_counts(kernels)
        expect_launches(f'layer-free Predictor at batch {n}', got,
                        {'flash_fwd': LL})
        expect_tensor_core(f'layer-free Predictor at batch {n}', kernels)
        lf_launches += got['flash_fwd']
        err = max(row_err(o, w) for o, w in zip(
            out, layer_outputs(paddle, lnet, req)))
        res[f'layer_free_b{n}_row_err'] = err
        if not err <= SERVE_TOL:
            raise AssertionError(f'layer-free Predictor at batch {n}: row '
                                 f'error {err} against the Layer')
    req1 = [a[:1] for a in reqs[0]]
    lat = []
    for _ in range(PREDICTOR_P50_CALLS):
        zero_launches(kernels)
        t0 = time.perf_counter()
        lf.run(req1)
        lat.append(time.perf_counter() - t0)
        lf_launches += kernels['flash_fwd'].launches
    lat.sort()
    res['layer_free'] = {'p50_ms_b1': lat[len(lat) // 2] * 1e3,
                         'launches': lf_launches}
    print(f'  layer-free Predictor (.pt2, torch.export, ERNIE at hidden '
          f'{lcfg.hidden_size}, {LL} layers): batch 1 and 16 vs '
          f'the Layer row errors {res["layer_free_b1_row_err"]:.3e}, '
          f'{res["layer_free_b16_row_err"]:.3e}; {LL} kernel-1 launches a '
          f'call; p50 {res["layer_free"]["p50_ms_b1"]:.2f} ms at batch 1 '
          f'over {PREDICTOR_P50_CALLS} calls; jit.save '
          f'{res["jit_save_s"]:.1f} s', flush=True)
    del lf, lnet
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)

    marks.append(('layer_free', time.perf_counter()))
    res['bench_predictor'] = bench_predictor_rung(paddle, card)
    marks.append(('bench_predictor', time.perf_counter()))
    res['bench_int8wo'] = bench_int8wo_rung(paddle, card)
    marks.append(('bench_int8wo', time.perf_counter()))
    res['cold_start'] = cold_start(card)
    marks.append(('cold_start', time.perf_counter()))
    res['part_seconds'] = {n: t - marks[i][1]
                           for i, (n, t) in enumerate(marks[1:])}
    print('  phase 31 parts (s): ' + ', '.join(
        f'{n} {v:.1f}' for n, v in res['part_seconds'].items()), flush=True)
    del eng
    paddle.set_device('cpu')
    torch.cuda.empty_cache()
    # the model and its traffic serve phase 34 too (built once)
    return res, (net, cfg, reqs)


def bench_predictor_rung(paddle, card):
    """bench.py _child_predictor as it is: resnet18 saved with
    InputSpec([1, 3, 224, 224]), served layer-free, p50 over 30 calls;
    device ms at batch 1, 8 and 32 from a chain of 40 dependent forwards
    timed once."""
    import tempfile

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.nn.layer_base import (buffer_arrays,
                                                functional_call,
                                                param_arrays)
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision import models as vmodels
    paddle.seed(0)
    net = vmodels.resnet18()
    net.eval()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_resnet18_')
    path = os.path.join(tmp, 'resnet18')
    jit.save(net, path, input_spec=[InputSpec([1, 3, 224, 224],
                                              'float32')])
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    if pred._exec is None:
        raise AssertionError('resnet18: jit.save exported no program')
    x = np.random.RandomState(0).rand(1, 3, 224, 224).astype('float32')
    out = pred.run([x])
    with paddle.no_grad():
        want = net(paddle.to_tensor(x)).numpy()
    err = row_err(out[0], want)
    if not err <= TOL[torch.float32] * 10:
        raise AssertionError(f'resnet18 layer-free vs the Layer: {err}')
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        out = pred.run([x])
        lat.append(time.perf_counter() - t0)
    lat.sort()
    res = {'p50_ms': lat[len(lat) // 2] * 1e3, 'vs_layer_row_err': err}
    params, bufs = param_arrays(net), buffer_arrays(net)

    def chain_ms(batch, k=40):
        xx = torch.rand((batch, 3, 224, 224), device='cuda')
        with torch.no_grad():
            y = functional_call(net, params, bufs, xx)[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(k):
                # output -> input: the chain serializes on the device
                y = functional_call(net, params, bufs, xx + y.sum() * 0)[0]
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3
    for b in (1, 8, 32):
        res[f'device_ms_b{b}'] = chain_ms(b)
    print(f'  bench _child_predictor: resnet18 layer-free p50 '
          f'{res["p50_ms"]:.2f} ms (vs the Layer {err:.2e}); device ms '
          f'batch 1 {res["device_ms_b1"]:.2f}, 8 {res["device_ms_b8"]:.2f}, '
          f'32 {res["device_ms_b32"]:.2f} [{card}]', flush=True)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def bench_int8wo_rung(paddle, card):
    """bench.py _child_serve_int8wo as it is: an MLP (256 -> 512 -> 64)
    served by InferenceEngine in float32 and in int8_wo over 64 requests
    of 1-8 rows: per-request p50, captures within ceil(log2 8) + 1."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.serving import InferenceEngine

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(256, 512)
            self.fc2 = nn.Linear(512, 64)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))

    paddle.seed(0)
    net = Net()
    rng = np.random.RandomState(0)
    max_batch = 8
    sizes = [int(rng.randint(1, max_batch + 1)) for _ in range(64)]
    out = {}
    for name, kw in (('f32', {}), ('int8wo', {'precision': 'int8_wo'})):
        eng = InferenceEngine(net, max_batch_size=max_batch,
                              autostart=False, **kw)
        eng.start()
        try:
            for b in (1, 2, 4, 8):   # warm every pow2 bucket
                eng.submit(rng.randn(b, 256).astype('float32')) \
                   .result(timeout=120)
            lats = []
            for n in sizes:
                x = rng.randn(n, 256).astype('float32')
                t0 = time.perf_counter()
                eng.submit(x).result(timeout=120)
                lats.append((time.perf_counter() - t0) * 1e3)
            out[f'serve_{name}_p50_ms'] = sorted(lats)[len(lats) // 2]
            out[f'{name}_compiles'] = eng.stats()['compiles']
        finally:
            eng.shutdown(drain=False)
    bound = math.ceil(math.log2(max_batch)) + 1
    if out['int8wo_compiles'] > bound:
        raise AssertionError(f'int8_wo engine: {out["int8wo_compiles"]} '
                             f'captures > {bound}')
    print(f'  bench _child_serve_int8wo: p50 f32 '
          f'{out["serve_f32_p50_ms"]:.3f} ms, int8_wo '
          f'{out["serve_int8wo_p50_ms"]:.3f} ms; captures '
          f'{out["int8wo_compiles"]} (<= {bound}) [{card}]', flush=True)
    return out


def _cold_traffic(vocab):
    """tools/warmup_check.py's traffic at ERNIE's shapes: a first request
    of 3 rows, then 1, 2, 4, 5, 8, 7 and 3 rows."""
    first = serve_requests(vocab, 1, 3, 3, SERVE['s'], 32, 128, seed=11)[0]
    rest = [serve_requests(vocab, 1, n, n, SERVE['s'], 32, 128,
                           seed=12 + i)[0]
            for i, n in enumerate((1, 2, 4, 5, COLD_MAX_BATCH,
                                   COLD_MAX_BATCH - 1, 3))]
    return first, rest


def warmup_child(mode, tmp):
    """One process of the cold-start check (run by ``cold_start``): ERNIE
    (full width, COLD_LAYERS layers) at max_batch_size 8 served cold
    inside ``warmup.capture()`` (saving the manifest), or warm from it.
    The two processes start at once and make their one-time start side by
    side; then the cold one waits for the warm one's (so nothing else runs
    on the card while it serves) and the warm one for the manifest. Prints
    one JSON line."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import serving, warmup
    from paddle_tpu_torch.models import ernie
    manifest_path = os.path.join(tmp, 'manifest.json')
    ready_path = os.path.join(tmp, 'warm_started')
    paddle.set_device('gpu')
    paddle.seed(0)
    net = ernie.ErnieModel(ernie.ErnieConfig(num_layers=COLD_LAYERS))
    first, rest = _cold_traffic(net.config.vocab_size)
    out = {'mode': mode}
    # the process's one-time start (CUDA context, cuBLAS, the kernels'
    # libraries, the operator's first dispatch), paid by both processes
    # alike, outside what is compared
    t0 = time.perf_counter()
    with paddle.no_grad():
        net(*[paddle.to_tensor(a) for a in first])
    torch.cuda.synchronize()
    out['process_start_ms'] = 1e3 * (time.perf_counter() - t0)
    if mode == 'warm':
        write_file(ready_path, '1')
    wait_file(manifest_path if mode == 'warm' else ready_path, timeout=600)

    def drive(engine):
        t0 = time.perf_counter()
        engine.submit(*first).result(timeout=300)
        first_ms = 1e3 * (time.perf_counter() - t0)
        for f in [engine.submit(*r) for r in rest]:
            f.result(timeout=300)
        return first_ms
    if mode == 'cold':
        with warmup.capture() as manifest:
            engine = serving.InferenceEngine(
                net, max_batch_size=COLD_MAX_BATCH, max_delay_ms=0.5)
            out['first_request_ms'] = drive(engine)
            engine.shutdown()
        manifest.save(manifest_path)
        out['manifest_entries'] = len(manifest)
        out['captures'] = engine._trace_count
    else:
        t0 = time.perf_counter()
        engine = serving.InferenceEngine(
            net, max_batch_size=COLD_MAX_BATCH, max_delay_ms=0.5,
            warmup=manifest_path)
        out['prebuild_ms'] = 1e3 * (time.perf_counter() - t0)
        out['prebuilt'] = engine._cache.prebuilt
        before = engine._trace_count
        out['first_request_ms'] = drive(engine)
        out['captures_during_traffic'] = engine._trace_count - before
        out['misses'] = engine._cache.misses
        engine.shutdown()
    print(json.dumps(out), flush=True)


def cold_start(card):
    """tools/warmup_check.py's protocol over ERNIE (full width,
    COLD_LAYERS layers): two fresh processes, the first serving cold
    inside warmup.capture() and saving the manifest, the second building
    its engine with warmup=<manifest>; the warm process must capture
    nothing during traffic. Both start at once and make their one-time
    start side by side; the cold one serves once the warm one's is done,
    the warm one once the manifest is saved."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix='chip_smoke_warmup_')
    res = {}
    t0 = time.perf_counter()
    procs = {mode: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--warmup-child', mode,
         '--dir', tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for mode in ('cold', 'warm')}
    try:
        for mode, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f'{mode} process failed:\n'
                                     f'{out[-2000:]}\n{err[-4000:]}')
            res[mode] = json.loads(out.strip().splitlines()[-1])
            res[mode]['process_s'] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    cold, warm = res['cold'], res['warm']
    if warm['captures_during_traffic'] != 0 or warm['misses'] != 0:
        raise AssertionError(f'warm process captured during traffic: '
                             f'{warm}')
    if warm['prebuilt'] != cold['manifest_entries']:
        raise AssertionError(f'warm process prebuilt {warm["prebuilt"]} of '
                             f'{cold["manifest_entries"]} entries')
    print(f'  cold start (tools/warmup_check.py protocol, max_batch_size '
          f'{COLD_MAX_BATCH}): first response cold '
          f'{cold["first_request_ms"]:.1f} ms, warm '
          f'{warm["first_request_ms"]:.1f} ms; the manifest\'s '
          f'{cold["manifest_entries"]} entries prebuilt in '
          f'{warm["prebuild_ms"]:.1f} ms; 0 captures during the warm '
          f'process\'s traffic; each process\'s start (one eager forward '
          f'first) {cold["process_start_ms"]:.0f} / '
          f'{warm["process_start_ms"]:.0f} ms [{card}]', flush=True)
    return res


PRETRAIN = dict(b=8, s=512, lo=256, hi=512, mlm_share=0.15, seed=0)
PRETRAIN_STEPS, PRETRAIN_WARMUP = 10, 2
MASK_ID = 3


def pretrain_batch(vocab, b, s, lo, hi, mlm_share, seed):
    """A pretraining batch [b, s] (numpy seed): real lengths lo-hi, the
    second half of each row token type 1, ~mlm_share of the real positions
    after [CLS] masked (input id MASK_ID, label the original id; -100
    elsewhere), NSP labels 0/1. -> (ids, types, mask, mlm, nsp, lens)."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(lo, hi + 1, b)
    pos = np.arange(s)[None]
    mask = (pos < lens[:, None]).astype(np.int64)
    ids = np.where(mask > 0, rs.randint(5, vocab, (b, s)), 0)
    types = ((pos >= (lens[:, None] // 2)) & (mask > 0)).astype(np.int64)
    pick = (rs.rand(b, s) < mlm_share) & (mask > 0) & (pos > 0)
    mlm = np.where(pick, ids, -100)
    ids = np.where(pick, MASK_ID, ids)
    nsp = rs.randint(0, 2, b)
    return ids, types, mask, mlm, nsp, lens


def ernie_train_step(ernie, cfg, topt):
    """(params, state, step(seed) -> loss): ERNIE's pretrain_loss, the
    gradients by torch.autograd.grad and AdamW's functional update in
    place."""
    def make(params, batch, lr=1e-4):
        opt = topt.AdamW(learning_rate=lr, weight_decay=0.01)
        names = ['p%d' % i for i in range(len(ernie.leaves(params)))]
        leaves = [t.requires_grad_() for t in ernie.leaves(params)]
        named = dict(zip(names, leaves))
        state = opt.functional_init(named)

        def step(seed):
            p = ernie.from_leaves(leaves)
            loss = ernie.pretrain_loss(p, *batch, cfg, dropout_seed=seed)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                opt.functional_apply(named, dict(zip(names, grads)), state,
                                     lr)
            return loss.detach()
        return step
    return make


def phase_ernie_pretrain(kernels, card):
    """Phase 32: ERNIE-base pretrained (see the module docstring)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import ernie
    cfg = ernie.ErnieConfig(dropout=0.1)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = ernie.init_params(cfg, gen, 'cuda')
    n_params = ernie.num_params(cfg)
    ids, types, mask, mlm, nsp, lens = pretrain_batch(cfg.vocab_size,
                                                      **PRETRAIN)
    batch = [torch.as_tensor(a, device='cuda')
             for a in (ids, types, mask, mlm, nsp)]
    step = ernie_train_step(ernie, cfg, topt)(params, batch)
    L = cfg.num_layers
    # remat reruns kernel 1 in the backward
    per_step = {'flash_fwd': 2 * L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    losses, totals = [], {k: 0 for k in kernels}

    def one():
        zero_launches(kernels)
        losses.append(step(DROP_SEED + len(losses)))
        got = launch_counts(kernels)
        want = {k: per_step.get(k, 0) for k in got}
        tc = {k: kernels[k].tc_launches for k in TC_KERNELS}
        if got != want or any(tc[k] != got[k] for k in TC_KERNELS):
            raise AssertionError(f'pretrain step {len(losses)}: launches '
                                 f'{got}, tensor-core {tc}; want {want}, '
                                 'all tensor-core')
        for k, n in got.items():
            totals[k] += n

    for _ in range(PRETRAIN_WARMUP):
        one()
    _, wall = timed(lambda: [one() for _ in range(PRETRAIN_STEPS
                                                  - PRETRAIN_WARMUP)])
    n_timed = PRETRAIN_STEPS - PRETRAIN_WARMUP
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f'pretrain: a non-finite loss {vals}')
    if not np.mean(vals[-3:]) < vals[0]:
        raise AssertionError(f'pretrain: the loss did not fall {vals}')
    prof = profile_window(one)
    busy = busy_over_steps(one, n=2)
    b, s = ids.shape
    tok_s = b * s * n_timed / wall
    res = {'params': n_params, 'losses': vals,
           'step_ms': wall * 1e3 / n_timed, 'tokens_per_s': tok_s,
           'real_tokens_per_step': int(lens.sum()),
           'mfu': 6 * n_params * tok_s / PEAK_BF16,
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
           'launches': totals, 'launches_per_step': per_step,
           'busy_share': busy['busy_share'],
           'device_ms_by_kind': device_ms_by_kind(prof),
           'profile': {k: prof[k] for k in ('window_ms', 'device_ms',
                                             'busy_share', 'kernels',
                                             'top')}}
    print(f'  ERNIE-base pretrain_loss ({n_params / 1e6:.1f}M params, '
          f'[{b}, {s}], remat, dropout 0.1, AdamW(1e-4, wd 0.01)): '
          f'{res["step_ms"]:.1f} ms a step, {tok_s:.0f} tokens/s '
          f'({res["real_tokens_per_step"]} real a step), MFU '
          f'{100 * res["mfu"]:.2f}% (6 x {n_params / 1e6:.1f}M, embeddings '
          f'included, x tokens/s over 989 TFLOP/s), peak '
          f'{res["peak_mem_gb"]:.2f} GB, busy {100 * busy["busy_share"]:.1f}'
          f'% [{card}]', flush=True)
    print(f'  launches a step {per_step} (kernel 1 twice: remat), all '
          f'tensor-core; losses {" ".join(f"{x:.4f}" for x in vals)}',
          flush=True)
    print('  device ms by kind (a profiled step): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in res['device_ms_by_kind'].items()
        if k != 'fp8_gemm'), flush=True)
    del params, batch, step
    torch.cuda.empty_cache()
    return res


# 4 heads of 64: the kernels take head dims 64, 128 and 256
ERNIE_SMALL = dict(vocab_size=1024, hidden_size=256, num_layers=2,
                   num_heads=4, max_seq_len=128, dtype='float32')
ERNIE_CARD_TOL = 2e-5       # f32, card against CPU, a row (outputs, grads)


def _ernie_pair(paddle, ernie, cfg):
    """The same random ErnieModel weights on the card and on the CPU."""
    paddle.set_device('cpu')
    paddle.seed(0)
    cpu = ernie.ErnieModel(cfg)
    paddle.set_device('gpu')
    card = ernie.ErnieModel(cfg)
    card.set_state_dict(cpu.state_dict())
    return card, cpu


def phase_ernie_serving_card_vs_cpu(kernels):
    """Phase 33: ERNIE at 2 layers in f32 (hidden 256, 4 heads of 64,
    vocab 1024), card against CPU (see the module docstring). -> the launches
    of the TranslatedLayer fine-tuning step."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit, optimizer as topt, serving
    from paddle_tpu_torch.models import ernie
    from paddle_tpu_torch.static import InputSpec
    cfg = ernie.ErnieConfig(**ERNIE_SMALL)
    net_card, net_cpu = _ernie_pair(paddle, ernie, cfg)
    reqs = serve_requests(cfg.vocab_size, 12, 1, 9, 64, 16, 64, seed=3)
    res = {}

    def held(what, err, tol=ERNIE_CARD_TOL):
        res[what] = err
        if not err <= tol:
            raise AssertionError(f'{what}: {err} > {tol}')

    # the engine on each device against that device's Layer
    sides = (('card', 'gpu', net_card), ('cpu', 'cpu', net_cpu))
    served = {}
    for label, dev, net in sides:
        paddle.set_device(dev)
        eng = serving.InferenceEngine(net, max_batch_size=8)
        served[label] = [f.result(timeout=300)
                         for f in [eng.submit(*r) for r in reqs]]
        eng.shutdown()
        held(f'engine_vs_layer_{label}', max(
            row_err(o, w) for out, r in zip(served[label], reqs)
            for o, w in zip(out, layer_outputs(paddle, net, r))))
    held('engine_card_vs_cpu', max(
        row_err(a, b) for x, y in zip(served['card'], served['cpu'])
        for a, b in zip(x, y)))
    # .pt2 and .pdparams saved on one device, served on the other
    tmp = tempfile.mkdtemp(prefix='chip_smoke_ernie_small_')
    spec = [InputSpec([-1, 64], 'int64')] * 3
    try:
        for src, sdev, net in sides:
            paddle.set_device(sdev)
            path = os.path.join(tmp, f'ernie_{src}')
            jit.save(net, path, input_spec=spec)
            for dst, ddev, ref in sides:
                config = inference.Config(path + '.pdmodel')
                if ddev == 'cpu':
                    config.disable_gpu()
                else:
                    config.enable_use_gpu()
                paddle.set_device(ddev)
                pred = inference.create_predictor(config)
                held(f'layer_free_saved_on_{src}_run_on_{dst}', max(
                    row_err(o, w) for r in reqs[:4]
                    for o, w in zip(pred.run(list(r)),
                                    layer_outputs(paddle, ref, r))))
        # one TranslatedLayer fine-tuning step against the Layer's
        paddle.set_device('gpu')
        tl = jit.load(os.path.join(tmp, 'ernie_card'))
        if type(tl).__name__ != 'TranslatedLayer':
            raise AssertionError(f'jit.load gave a {type(tl).__name__}')
        req = [paddle.to_tensor(a) for a in reqs[1]]
        got = {}
        for what, layer in (('translated', tl), ('layer', net_card)):
            layer.eval()
            opt = topt.SGD(learning_rate=0.5, parameters=layer.parameters())
            zero_launches(kernels)
            h, pooled = layer(*req)
            loss = (h * h).mean() + pooled.sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            got[what] = ({n: p.numpy() for n, p in
                          layer.state_dict().items()},
                         launch_counts(kernels))
        launches = got['translated'][1]
        expect_launches('TranslatedLayer fine-tuning step', launches,
                        {'flash_fwd': cfg.num_layers,
                         'flash_bwd_dq': cfg.num_layers,
                         'flash_bwd_dkv': cfg.num_layers})
        held('translated_step_vs_layer', max(
            row_err(got['translated'][0][n], got['layer'][0][n])
            for n in got['layer'][0]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # pretrain_loss and its gradients, card against CPU, dropout 0 and 0.1
    for drop in (0.0, 0.1):
        c = ernie.ErnieConfig(**dict(ERNIE_SMALL, dropout=drop))
        gen = torch.Generator().manual_seed(1)
        p_cpu = ernie.init_params(c, gen, 'cpu')
        batch = pretrain_batch(c.vocab_size, 2, 128, 64, 128, 0.15, seed=5)
        vals = {}
        for label, dev in (('card', 'cuda'), ('cpu', 'cpu')):
            leaves = [t.to(dev).requires_grad_() for t in
                      ernie.leaves(p_cpu)]
            b = [torch.as_tensor(a, device=dev) for a in batch[:5]]
            loss = ernie.pretrain_loss(ernie.from_leaves(leaves), *b, c,
                                       dropout_seed=DROP_SEED)
            grads = torch.autograd.grad(loss, leaves)
            vals[label] = (float(loss.detach()), [g.cpu() for g in grads])
        held(f'pretrain_loss_drop{drop}',
             abs(vals['card'][0] - vals['cpu'][0]) / abs(vals['cpu'][0]))
        held(f'pretrain_grads_drop{drop}', max(
            kernel_err(g.reshape(-1, g.shape[-1]) if g.dim() > 1
                       else g[None], w.reshape(-1, w.shape[-1])
                       if w.dim() > 1 else w[None], GRAD_FLOOR)[1]
            for g, w in zip(vals['card'][1], vals['cpu'][1])))
    print('  ERNIE at 2 layers f32, card against CPU: ' + ', '.join(
        f'{k} {v:.2e}' for k, v in res.items())
        + f' (tol {ERNIE_CARD_TOL:g} a row)', flush=True)
    paddle.set_device('cpu')
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 34: the telemetry plane on the card
# ---------------------------------------------------------------------------

SCRAPE_EVERY_S = 0.1        # the scraper's period during traffic
PROFILE_MS = 300            # /debug/profile's window
TRACE_MS = 50               # /debug/trace's window
FLOPS_TOL = 0.2             # perf.flops{fn=serving.bucket64} vs analytic
DEVTIME_SUM_TOL = 0.05      # categories + idle against the window
CKPT_BOOKED = 0.8           # checkpoint badput over ckpt.save_ms
SPAN_ITERS = 20000
FIT_STEPS, FIT_BATCH, FIT_SAVE_AT = 20, 64, 10


def http_get(url, timeout=120):
    """(status, body) of a GET, an error status included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def span_us(obs, forward=True):
    """Host microseconds a span costs (enter and exit, into the ring), with
    or without its record_function range."""
    from paddle_tpu_torch.observability import trace
    saved = (trace._profiler_mod, trace._profiler_checked)
    if not forward:
        trace._profiler_mod, trace._profiler_checked = None, True
    try:
        t0 = time.perf_counter()
        for _ in range(SPAN_ITERS):
            with obs.span('chip_smoke.span'):
                pass
        return (time.perf_counter() - t0) / SPAN_ITERS * 1e6
    finally:
        trace._profiler_mod, trace._profiler_checked = saved
        obs.reset_trace()


def span_costs(obs, rounds=3):
    """A span's host cost outside a capture (as it runs, and with ranges
    off: the least of ``rounds`` alternating measurements each) and
    inside a torch.profiler capture."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.observability import trace
    off, on = [], []
    for _ in range(rounds):
        off.append(span_us(obs, forward=False))
        on.append(span_us(obs))
    out = {'host_only_us': min(off), 'ranged_us': min(on),
           # False: outside a capture a span opens no range
           'range_outside_capture': trace._capturing()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out['in_capture_us'] = span_us(obs)
    return out


def bucket64_flops(cfg, rows):
    """Analytic FLOPs of one ERNIE forward over ``rows`` sequences: 2 x the
    12·H² weights of a layer's products x tokens, and the dense attention
    4·B·S²·H a layer (kernel 1's formula), plus the pooler."""
    h, s, L = cfg.hidden_size, SERVE['s'], cfg.num_layers
    return (2 * rows * s * 12 * h * h * L + 4 * rows * s * s * h * L
            + 2 * rows * h * h)


def scrape_loop(url, engine_label, stop, out):
    """GET /metrics every SCRAPE_EVERY_S until ``stop``: each body parsed
    by the port's promparse, the serve_* series present, and the request
    counter never falling."""
    from paddle_tpu_torch.observability import promparse
    key = f'serve_requests_submitted{{engine={engine_label}}}'
    last = -1
    while not stop.is_set():
        t0 = time.perf_counter()
        code, body = http_get(url + '/metrics')
        if code != 200:
            raise AssertionError(f'/metrics answered {code}')
        snap = promparse.parse_text(body.decode())
        n = snap['counters'].get(key)
        if n is None or n < last:
            raise AssertionError(f'scrape {len(out)}: {key} = {n} after '
                                 f'{last}')
        if not any(k.startswith('serve_latency_ms')
                   for k in snap['histograms']):
            raise AssertionError('a scrape without serve_latency_ms')
        last = n
        out.append((time.perf_counter() - t0) * 1e3)
        stop.wait(SCRAPE_EVERY_S)


def in_thread(fn):
    """fn() on a thread -> (thread, result dict); the thread re-raises
    nothing: ``result['error']`` holds what fn raised."""
    res = {}

    def run():
        try:
            res['value'] = fn()
        except BaseException as e:       # reported by the caller
            res['error'] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, res


def joined(t, res, what):
    t.join()
    if 'error' in res:
        raise AssertionError(f'{what}: {res["error"]!r}') from res['error']
    return res.get('value')


def telemetry_serving(obs, serving, net, cfg, reqs, kernels, card,
                      busy31):
    """Phase 34 (a) and (b): the plane during ERNIE-base traffic, and a
    live profile."""
    from paddle_tpu_torch.observability import devtime, perf
    L = cfg.num_layers
    res = {}
    eng = serving.InferenceEngine(net, max_batch_size=SERVE_MAX_BATCH,
                                  max_delay_ms=SERVE_DELAY_MS,
                                  queue_capacity=4 * len(reqs),
                                  telemetry_port=0)
    base = eng.telemetry.url
    label = eng._stats.labels['engine']
    try:
        t0 = time.perf_counter()
        code_h, _ = http_get(base + '/healthz')
        res['healthz_ms'] = (time.perf_counter() - t0) * 1e3
        code_r, _ = http_get(base + '/readyz')
        if (code_h, code_r) != (200, 503):
            raise AssertionError(f'before warmup /healthz {code_h}, '
                                 f'/readyz {code_r}; want 200, 503')
        t0 = time.perf_counter()
        eng.warmup('all_buckets', input_spec=[((SERVE['s'],), 'int64')] * 3)
        res['warmup_s'] = time.perf_counter() - t0
        code_r, body = http_get(base + '/readyz')
        if code_r != 200 or not json.loads(body)['checks'][
                eng._probe_name]['ready']:
            raise AssertionError(f'after warmup /readyz {code_r} {body!r}')
        # perf.flops of the bucket-64 graph, counted on its warm-up run
        rec = perf.analyzed('serving.bucket64')
        want = bucket64_flops(cfg, SERVE_MAX_BATCH)
        res['bucket64_flops'] = rec['flops']
        res['bucket64_flops_analytic'] = want
        res['bucket64_hbm'] = rec['hbm']
        if abs(rec['flops'] / want - 1) > FLOPS_TOL:
            raise AssertionError(f'perf.flops{{fn=serving.bucket64}} '
                                 f'{rec["flops"]:.4g}, analytic '
                                 f'{want:.4g}')

        def traffic():
            t0 = time.perf_counter()
            futs = [eng.submit(*r) for r in reqs]
            outs = [f.result(timeout=300) for f in futs]
            return futs, outs, time.perf_counter() - t0

        eng._stats.reset()
        zero_launches(kernels)
        # the traffic without and with a scraper: plain, scraped, scraped,
        # plain, after one unscored pass (the first after warmup runs
        # slower)
        walls, scrapes = {'plain': [], 'scraped': []}, []
        traffic()
        for mode in ('plain', 'scraped', 'scraped', 'plain'):
            if mode == 'scraped':
                stop = threading.Event()
                st, sres = in_thread(lambda: scrape_loop(
                    base, label, stop, scrapes))
                time.sleep(2 * SCRAPE_EVERY_S)
            futs, outs, wall = traffic()
            walls[mode].append(wall)
            if mode == 'scraped':
                stop.set()
                joined(st, sres, 'the scraper')
        wall_plain = sum(walls['plain']) / 2
        wall_scraped = sum(walls['scraped']) / 2
        # a /debug/trace window inside traffic: passes until it answers
        tt, tres = in_thread(lambda: http_get(
            base + f'/debug/trace?ms={TRACE_MS}'))
        while tt.is_alive():
            traffic()
        joined(tt, tres, '/debug/trace')
        got = launch_counts(kernels)
        batches = eng.stats()['batches']
        expect_launches('phase 34 traffic (four passes and the trace\'s)',
                        got,
                        {'flash_fwd': L * batches})
        expect_tensor_core('phase 34 traffic', kernels)
        res['launches'] = got
        for (h, p), r in zip(outs, reqs):
            if h.shape != (r[0].shape[0], SERVE['s'], cfg.hidden_size) or \
                    not np.isfinite(h).all():
                raise AssertionError('phase 34: an engine output')
        if len(scrapes) < 2:
            raise AssertionError(f'{len(scrapes)} scrapes during traffic')
        res.update(requests_per_s_plain=len(reqs) / wall_plain,
                   requests_per_s_scraped=len(reqs) / wall_scraped,
                   walls_s=walls,
                   scrapes=len(scrapes), scrape_ms_p50=sorted(scrapes)[
                       len(scrapes) // 2], scrape_ms_max=max(scrapes))
        code, body = tres['value']
        doc = json.loads(body)
        n_batch = sum(1 for e in doc['traceEvents']
                      if e.get('name') == 'serve.batch')
        if code != 200 or n_batch == 0:
            raise AssertionError(f'/debug/trace?ms={TRACE_MS}: {code}, '
                                 f'{n_batch} serve.batch spans')
        res['trace_serve_batch_spans'] = n_batch
        rid = futs[0].request_id
        code, body = http_get(base + f'/debug/requests?id={rid}')
        recs = json.loads(body)['requests']
        evs = [e['ev'] for e in recs[0]['timeline']] if recs else []
        if code != 200 or recs[0]['outcome'] != 'ok' or not (
                evs.index('enqueue') < evs.index('admit')
                < evs.index('retire')):
            raise AssertionError(f'/debug/requests?id={rid}: {code} {evs}')
        w = obs.slo.watcher()
        w.rule('queue_wait_p99', 'serve.queue_wait_ms', 250.0,
               labels={'engine': label}, stat='p99')
        w.evaluate()
        code, body = http_get(base + '/debug/slo')
        slo_doc = json.loads(body)
        if code != 200 or [r['rule'] for r in slo_doc['rules']] != [
                'queue_wait_p99'] or slo_doc['rules'][0]['last_value'] \
                is None:
            raise AssertionError(f'/debug/slo: {code} {slo_doc}')
        res['slo'] = slo_doc['rules'][0]

        # (b) a live profile during traffic: passes until the capture ends
        zero_launches(kernels)
        b0 = eng.stats()['batches']
        pt, pres = in_thread(lambda: http_get(
            base + f'/debug/profile?ms={PROFILE_MS}'))
        passes = 0
        while pt.is_alive():
            traffic()
            passes += 1
        code, body = joined(pt, pres, '/debug/profile')
        summary = json.loads(body)
        if code != 200:
            raise AssertionError(f'/debug/profile: {code} {summary}')
        got = launch_counts(kernels)
        expect_launches('phase 34 profiled traffic', got,
                        {'flash_fwd': L * (eng.stats()['batches'] - b0)})
        for k, v in got.items():
            res['launches'][k] += v
        dv = summary['devtime']
        cats = dv['categories_ms']
        total = sum(cats.values())
        if abs(total / dv['window_ms'] - 1) > DEVTIME_SUM_TOL or \
                abs(dv['window_ms'] / PROFILE_MS - 1) > DEVTIME_SUM_TOL:
            raise AssertionError(f'devtime: categories + idle {total} ms '
                                 f'over a {dv["window_ms"]} ms window')
        if not cats['matmul'] > 0:
            raise AssertionError(f'devtime: no matmul time {cats}')
        trace = devtime.load_trace(os.path.join(summary['artifact_dir'],
                                                'capture.pt.trace.json'))
        port_names = {e['name'] for e in trace['traceEvents']
                      if e.get('cat') == 'kernel' and any(
                          n in e['name'] for n in devtime.PORT_KERNELS)}
        cls = devtime.classifier()
        unknown = [n for n in port_names
                   if not cls.classify(n, cat='kernel')[1]]
        if not port_names or unknown:
            raise AssertionError(f'devtime: port kernels in the capture '
                                 f'{sorted(port_names)}, unknown {unknown}')
        graph_launches = sum(1 for e in trace['traceEvents']
                             if e.get('name') == 'cudaGraphLaunch')
        g = obs.snapshot()['gauges']
        mfu_measured = g.get('perf.mfu_measured')
        mfu = g.get('perf.mfu{fn=serving.bucket64}')
        if mfu_measured is None or not math.isfinite(mfu_measured):
            raise AssertionError(f'perf.mfu_measured {mfu_measured}; '
                                 f'{dv["mfu_measured"]}')
        if mfu is None or not 0 < mfu <= 1:
            raise AssertionError(f'perf.mfu{{fn=serving.bucket64}} {mfu}')
        res.update(profile={k: dv[k] for k in (
            'window_ms', 'busy_ms', 'idle_pct', 'categories_ms',
            'unknown_events', 'unknown_names', 'mfu_measured', 'events')},
            profile_wall_ms=summary['wall_ms'],
            profile_dir=summary['artifact_dir'],
            profile_all_threads=summary['all_threads'],
            profile_passes=passes, port_kernel_names=sorted(port_names),
            graph_launches=graph_launches, mfu_measured=mfu_measured,
            mfu_bucket64=mfu, busy_share_profile=dv['busy_ms']
            / dv['window_ms'], busy_share_phase31=busy31)
    finally:
        eng.shutdown()
    print(f'  InferenceEngine(max_batch_size={SERVE_MAX_BATCH}, '
          f'telemetry_port=0): /healthz 200 in {res["healthz_ms"]:.1f} ms, '
          f'/readyz 503 -> 200 across warmup ({res["warmup_s"]:.2f} s) '
          f'[{card}]', flush=True)
    print(f'  {len(reqs)} requests: {res["requests_per_s_plain"]:.1f} '
          f'requests/s without a scraper, '
          f'{res["requests_per_s_scraped"]:.1f} with /metrics scraped every '
          f'{SCRAPE_EVERY_S * 1e3:.0f} ms (two passes each, in the order '
          f'plain, scraped, scraped, plain: ' + ', '.join(
              f'{k} {[round(len(reqs) / w, 1) for w in v]}'
              for k, v in res['walls_s'].items())
          + f'; {res["scrapes"]} scrapes, p50 '
          f'{res["scrape_ms_p50"]:.2f} ms, max {res["scrape_ms_max"]:.2f} '
          f'ms); kernel 1 {res["launches"]["flash_fwd"]} launches ({L} a '
          f'batch, all tensor-core); /debug/trace?ms={TRACE_MS}: '
          f'{res["trace_serve_batch_spans"]} serve.batch spans; /debug/slo '
          f'queue_wait_p99 = {res["slo"]["last_value"]} ms', flush=True)
    print(f'  perf.flops{{fn=serving.bucket64}} {res["bucket64_flops"]:.4g} '
          f'against analytic {res["bucket64_flops_analytic"]:.4g}; hbm '
          f'bytes {res["bucket64_hbm"]}; perf.mfu{{fn=serving.bucket64}} '
          f'{res["mfu_bucket64"]:.4f}', flush=True)
    p = res['profile']
    print(f'  /debug/profile?ms={PROFILE_MS} over {res["profile_passes"]} '
          f'traffic passes (all threads: {res["profile_all_threads"]}; '
          f'wall {res["profile_wall_ms"]:.0f} ms, {p["events"]} events, '
          f'{res["graph_launches"]} cudaGraphLaunch): window '
          f'{p["window_ms"]} ms, ' + ', '.join(
              f'{k} {v}' for k, v in p['categories_ms'].items())
          + f' ms; busy {100 * res["busy_share_profile"]:.1f}% (phase 31\'s '
          f'hand-wired window: {100 * busy31:.1f}%); unknown kernels '
          f'{p["unknown_events"]} {p["unknown_names"]}; perf.mfu_measured '
          f'{res["mfu_measured"]:.4f}; port kernels '
          f'{res["port_kernel_names"]}', flush=True)
    return res


def telemetry_hapi(paddle, obs, card):
    """Phase 34 (c): Model.fit(telemetry_port=0) of a small MLP with one
    paddle.save in a callback: goodput, checkpoint badput, the memory
    sweep and the StepTimer."""
    import tempfile
    from paddle_tpu_torch.observability import perf
    from paddle_tpu_torch.profiler import StepTimer
    rs = np.random.RandomState(0)
    xs = rs.randn(FIT_STEPS * FIT_BATCH, 512).astype(np.float32)
    ys = rs.randint(0, 10, (FIT_STEPS * FIT_BATCH, 1)).astype(np.int64)

    class Data(paddle.io.Dataset):
        def __len__(self):
            return len(xs)

        def __getitem__(self, i):
            return xs[i], ys[i]

    tmp = tempfile.mkdtemp(prefix='chip_smoke_fit_')
    paddle.seed(0)
    net = paddle.nn.Sequential(paddle.nn.Linear(512, 2048), paddle.nn.ReLU(),
                               paddle.nn.Linear(2048, 10))

    class SaveOnce(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == FIT_SAVE_AT:
                paddle.save(net.state_dict(), os.path.join(tmp, 'mid'))

    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                        parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss())
    model._step_timer = timer = StepTimer()
    obs.goodput.reset_goodput()
    model.fit(Data(), epochs=1, batch_size=FIT_BATCH, verbose=0,
              shuffle=False, log_freq=5, telemetry_port=0,
              callbacks=[SaveOnce()])
    res = {}
    try:
        code, body = http_get(model.telemetry.url + '/debug/goodput')
        gp = json.loads(body)
        if code != 200 or not 0 < gp['ratio'] <= 1 or \
                gp['steps'] != FIT_STEPS:
            raise AssertionError(f'/debug/goodput: {code} {gp}')
        save_ms = obs.find('ckpt.save_ms').sum
        booked = 1e3 * gp['badput_s']['checkpoint']
        if not booked >= CKPT_BOOKED * save_ms:
            raise AssertionError(f'checkpoint badput {booked} ms of '
                                 f'ckpt.save_ms {save_ms}')
        during = obs.find('perf.hbm_used_bytes', {'device': 'cuda:0'})
        if during is None or not during.value > 0:
            raise AssertionError('fit swept no device memory')
        used = perf.sweep_hbm()['cuda:0']
        stats = torch.cuda.memory_stats()['allocated_bytes.all.current']
        gauge = obs.find('perf.hbm_used_bytes', {'device': 'cuda:0'}).value
        if not used == gauge == stats:
            raise AssertionError(f'perf.hbm_used_bytes {gauge} (sweep '
                                 f'{used}), memory_stats {stats}')
        s = timer.summary()
        phases_ms = sum(s.get(f'{p}_ms_mean', 0.0) * s['steps']
                        for p in StepTimer.PHASES)
        if s['steps'] != FIT_STEPS or not phases_ms <= s['wall_s'] * 1e3:
            raise AssertionError(f'StepTimer: {s}')
        res.update(goodput=gp, ckpt_save_ms=save_ms,
                   checkpoint_badput_ms=booked, hbm_used_bytes=gauge,
                   timer=s, phases_ms=phases_ms,
                   train_step_flops=perf.analyzed('hapi.train_step')['flops'])
    finally:
        model.telemetry.stop()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    print(f'  Model.fit(telemetry_port=0), MLP 512-2048-10, {FIT_STEPS} '
          f'steps of {FIT_BATCH}, one paddle.save: goodput ratio '
          f'{res["goodput"]["ratio"]} (badput s {res["goodput"]["badput_s"]}'
          f'); checkpoint badput {res["checkpoint_badput_ms"]:.2f} ms of '
          f'ckpt.save_ms {res["ckpt_save_ms"]:.2f}; perf.hbm_used_bytes'
          f'{{device=cuda:0}} {res["hbm_used_bytes"]} = memory_stats; '
          f'StepTimer phases {res["phases_ms"]:.1f} ms of '
          f'{res["timer"]["wall_s"] * 1e3:.1f} ms [{card}]', flush=True)
    return res


def phase_telemetry(kernels, card, served, busy31):
    """Phase 34: the telemetry plane on the card (see the module
    docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    net, cfg, reqs = served
    paddle.set_device('gpu')
    obs.reset()
    res = {'span': span_costs(obs)}
    print(f'  a span: {res["span"]["ranged_us"]:.2f} us as it runs '
          f'(a range outside a capture: '
          f'{res["span"]["range_outside_capture"]}), '
          f'{res["span"]["host_only_us"]:.2f} us with ranges off, '
          f'{res["span"]["in_capture_us"]:.2f} us inside a torch.profiler '
          f'capture (its record_function range open) [{card}]', flush=True)
    res.update(telemetry_serving(obs, serving, net, cfg, reqs, kernels,
                                 card, busy31))
    res['hapi'] = telemetry_hapi(paddle, obs, card)
    paddle.set_device('cpu')
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 35: the control planes (fleet router, model host, fleet plane)
# ---------------------------------------------------------------------------

FLEET = dict(requests=16, lo=16, hi=400, seed=0)   # phase 4's prompts()
FLEET_NEW = 32
FLEET_BURST = 12                 # (c): the burst that must scale up
FLEET_QWAIT_MS = 50.0            # (c): the scale-up rule's p99 threshold
DRILL_P99_RATIO = 5.0            # tools/fleet_drill.py's failover limit


def fleet_wave(router, reqs, new, arm=None):
    """Submit every request through ``router`` at once and wait for all.
    ``arm()`` runs once the first token of any stream is out (mid-decode).
    -> (streams, latencies ms: submit to the stream's end)."""
    done = {}
    t0 = time.perf_counter()
    futs = [router.submit(p, max_new_tokens=new) for p in reqs]
    for i, f in enumerate(futs):
        f._subscribe(lambda kind, *a, i=i: kind == 'finish'
                     and done.setdefault(i, time.perf_counter()))
    if arm is not None:
        while not any(f._count() for f in futs):
            time.sleep(0.001)
        arm()
    streams = [f.result(timeout=600) for f in futs]
    lat = [(done[i] - t0) * 1e3 for i in range(len(futs))]
    return streams, lat, futs


def device_bytes():
    return torch.cuda.memory_stats()['allocated_bytes.all.current']


def warmup_runs(captured):
    """A warm-up's runs of one captured function: WARMUP_RUNS eager runs
    before the capture, then one replay (the capture launches nothing)."""
    from paddle_tpu_torch.models.decode_cache import WARMUP_RUNS
    return (WARMUP_RUNS if captured else 0) + 1


def served_calls(engines):
    """Each engine's prefills and steps so far, by id."""
    return {id(e): e.stats()['prefills'] + e.stats()['steps']
            for e in engines}


def fleet_launch_want(L, engines, builds, since=None):
    """Kernel 6's launches over ``engines`` (their prefills and steps,
    past ``since``: ``served_calls`` before) and ``builds`` warm-ups (each
    the prefill's and the step's) since the counters were zeroed."""
    since = since or {}
    served = sum(n - since.get(k, 0)
                 for k, n in served_calls(engines).items())
    return L * (served + builds * 2 * warmup_runs(
        engines[0]._fns['step'].captured))


def phase_control_planes(kernels, card, served):
    """Phase 35: the fleet router, the model host and the fleet plane at
    full width (see the module docstring)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import fault, serving
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import warmup
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import fleetobs, promparse
    from paddle_tpu_torch.ops import _build
    ernie_net, ernie_cfg, _ = served
    paddle.set_device('gpu')
    obs.set_enabled(True)
    obs.reset()
    cfg = bench_config(gpt)
    L = cfg.num_layers
    params = gpt.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    reqs = prompts(FLEET['requests'], FLEET['lo'], FLEET['hi'],
                   cfg.vocab_size, FLEET['seed'])
    new = FLEET_NEW
    lens = [len(p) for p in reqs]

    def gen_factory():
        # the closure holds the params; each engine casts its own
        # serving copy and owns its pool and graphs
        return serving.GenerationEngine(params, cfg, num_slots=8,
                                        page_size=128, prefill_width=1024)

    res = {'prompt_lens': [min(lens), max(lens)], 'requests': len(reqs)}
    print(f'  {len(reqs)} greedy requests of {min(lens)}-{max(lens)}-token '
          f'prompts, {new} new tokens each; bench GPT, 8 slots, page 128, '
          f'prefill width 1024 [{card}]', flush=True)

    # a single engine's streams: what every replica must equal
    single = gen_factory()
    try:
        single.warmup()
        want = [f.result(timeout=600) for f in
                [single.submit(p, max_new_tokens=new) for p in reqs]]
    finally:
        single.shutdown()
    del single

    # (a) two replicas behind the router
    rs = serving.ReplicaSet(gen_factory, initial=2)
    for rep in rs.snapshot():
        rep.engine.warmup()
    router = serving.FleetRouter(rs)
    fobs = fleetobs.FleetObs(name='smoke').watch_router(router)
    host = None
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        streams, lat, _ = fleet_wave(router, reqs, new)
        wall = time.perf_counter() - t0
        got = launch_counts(kernels)
        engines = [r.engine for r in rs.snapshot()]
        per_rep = {r.name: r.engine.stats()['submitted']
                   for r in rs.snapshot()}
        if streams != want:
            bad = [i for i, (a, b) in enumerate(zip(streams, want)) if a != b]
            raise AssertionError(f'(a) fleet streams differ from the single '
                                 f'engine\'s for requests {bad}')
        expect_launches('(a) fleet', got, {'paged_decode': fleet_launch_want(
            L, engines, 0)})
        if any(e.stats()['traces'] != 2 for e in engines):
            raise AssertionError('(a) a replica captured during traffic')
        if sorted(per_rep.values())[0] == 0:
            raise AssertionError(f'(a) routing left a replica idle: '
                                 f'{per_rep}')
        res['fleet'] = {'requests_per_s': len(reqs) / wall,
                        'latency_ms_p50': float(np.percentile(lat, 50)),
                        'latency_ms_p99': p99(lat), 'wall_s': wall,
                        'per_replica': per_rep,
                        'launches': got['paged_decode']}
        print(f'  (a) fleet of 2: {res["fleet"]["requests_per_s"]:.2f} '
              f'requests/s, latency p50 {res["fleet"]["latency_ms_p50"]:.1f}'
              f' ms, p99 {res["fleet"]["latency_ms_p99"]:.1f} ms, requests '
              f'a replica {per_rep}, kernel 6 launches '
              f'{got["paged_decode"]}; streams equal the single engine\'s '
              f'[{card}]', flush=True)
        fobs.federator.collect()       # both replicas seen fresh

        # (b) the same requests, one replica killed mid-decode
        since = served_calls(engines)
        zero_launches(kernels)
        killed0 = obs.find('fleet.replicas_killed', {'fleet': rs.name})
        killed0 = killed0.value if killed0 is not None else 0

        def arm():
            fault.configure('fleet.failover:1.0', seed=7, max_faults=1)

        try:
            streams_b, lat_b, futs_b = fleet_wave(router, reqs, new, arm=arm)
        finally:
            fault.configure(None)
        got = launch_counts(kernels)
        killed = obs.find('fleet.replicas_killed', {'fleet': rs.name})
        killed = (killed.value if killed is not None else 0) - killed0
        states = sorted(r.state for r in rs.snapshot())
        # a stream short of its tokens lost some; one past them emitted a
        # token index twice
        lost = sum(len(s) < new for s in streams_b)
        dups = sum(max(0, len(s) - new) for s in streams_b)
        if lost or dups or killed != 1 or states != ['dead', 'ready']:
            raise AssertionError(f'(b) failover: {lost} lost, {dups} '
                                 f'duplicate tokens, {killed} killed, '
                                 f'states {states}')
        if streams_b != streams:
            bad = [i for i, (a, b) in enumerate(zip(streams_b, streams))
                   if a != b]
            raise AssertionError(f'(b) failed-over streams differ from '
                                 f'(a)\'s for requests {bad}')
        # the killed replica's calls before it died, the survivor's after
        expect_launches('(b) failover', got, {'paged_decode':
                        fleet_launch_want(L, engines, 0, since)})
        failover = obs.find('fleet.failover', {'fleet': rs.name})
        rids = [f.request_id for f in futs_b]
        recs = [obs.recorder().lookup(rid) for rid in rids]
        moved = [r['id'] for r in recs if r is not None and any(
            e['ev'] == 'failover' for e in r['timeline'])]
        if not moved:
            raise AssertionError('(b) no request records a failover')
        ratio = p99(lat_b) / p99(lat)
        res['failover'] = {'lost': lost, 'duplicates': dups,
                           'killed': killed,
                           'failovers': failover.value if failover else 0,
                           'latency_ms_p99': p99(lat_b),
                           'p99_ratio': ratio,
                           'launches': got['paged_decode'],
                           'moved': len(moved)}
        print(f'  (b) failover: 0 lost, {dups} duplicate token indices, '
              f'{killed} replica killed, {len(moved)} requests moved '
              f'({res["failover"]["failovers"]} failovers), streams equal '
              f'(a)\'s; p99 {p99(lat_b):.1f} ms, {ratio:.2f} x the healthy '
              f'p99 (the drill\'s limit: {DRILL_P99_RATIO:g}); kernel 6 '
              f'launches {got["paged_decode"]} [{card}]', flush=True)

        # (c) warm scale-up
        res['scale_up'] = scale_up_run(serving, obs, _build, gen_factory,
                                       kernels, reqs, want, L, card)

        # (d) the model host
        host, res['host'] = host_run(serving, obs, warmup, _build,
                                     gen_factory, ernie_net, ernie_cfg,
                                     kernels, reqs, L, card)

        # (e) the fleet plane over the router of (a)-(b) and the host
        fobs.watch_host(host)
        res['fleetobs'] = fleetobs_run(fobs, promparse, rs, host, moved[0],
                                       card)
    finally:
        router.close(drain=False)
        if host is not None:
            host.close(drain=False)
        obs.shutdown_telemetry()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device('cpu')
    return res


def scale_up_run(serving, obs, _build, gen_factory, kernels, reqs, want, L,
                 card):
    """Phase 35 (c): one replica, an Autoscaler on the queue-wait p99; a
    burst must spawn a second replica, warm before it is routable, whose
    first request adds no capture and builds no kernel."""
    rs = serving.ReplicaSet(gen_factory, initial=1, min_replicas=1,
                            max_replicas=2)
    rs.snapshot()[0].engine.warmup()
    asc = serving.Autoscaler(qwait_p99_ms=FLEET_QWAIT_MS, idle_s=60.0,
                             cooldown_s=0.5, debounce=1)
    router = serving.FleetRouter(rs, autoscaler=asc)
    try:
        zero_launches(kernels)
        loads = _build.loads
        futs = [router.submit(p, max_new_tokens=FLEET_NEW)
                for p in reqs[:FLEET_BURST]]
        deadline = time.perf_counter() + 120
        while len(rs.snapshot()) < 2:
            if time.perf_counter() > deadline:
                raise AssertionError('(c) the queue-wait breach never '
                                     'scaled up')
            time.sleep(0.005)
        spawned = rs.snapshot()[1].engine
        traces = spawned.stats()['traces']
        first = spawned.submit(reqs[0], max_new_tokens=FLEET_NEW).result(
            timeout=600)
        out = [f.result(timeout=600) for f in futs]
        got = launch_counts(kernels)
        engines = [r.engine for r in rs.snapshot()]
        if (traces, spawned.stats()['traces']) != (2, 2) or \
                not spawned._warmed:
            raise AssertionError(f'(c) spawned replica: {traces} captures '
                                 f'when it joined, '
                                 f'{spawned.stats()["traces"]} after its '
                                 'first request; want 2, 2')
        if _build.loads != loads:
            raise AssertionError('(c) the scale-up built a kernel')
        if first != want[0] or out != want[:FLEET_BURST]:
            raise AssertionError('(c) streams differ from the single '
                                 'engine\'s')
        expect_launches('(c) scale-up', got, {'paged_decode':
                        fleet_launch_want(L, engines, 1)})
        h = obs.find('fleet.scale_up_ms', {'fleet': rs.name})
        res = {'scale_up_ms': h.percentile(50), 'spawns': h.count,
               'spawned_requests': spawned.stats()['submitted'],
               'launches': got['paged_decode']}
        res['beside'] = warm_beside_decode(router, engines, gen_factory,
                                           kernels, reqs, want, L)
    finally:
        router.close(drain=False)
    print(f'  (c) scale-up under a {FLEET_BURST}-request burst (queue-wait '
          f'p99 > {FLEET_QWAIT_MS:g} ms): fleet.scale_up_ms '
          f'{res["scale_up_ms"]:.1f} (factory + 2 captures); the new '
          f'replica served {res["spawned_requests"]} requests, 0 captures '
          f'and no kernel build from its first; kernel 6 launches '
          f'{res["launches"]}; a third engine\'s warm-up ('
          f'{res["beside"]["warmup_ms"]:.1f} ms) beside the replicas\' '
          f'decode of {len(reqs)} requests ({res["beside"]["steps"]} '
          f'steps meanwhile): every stream and its first equal the single '
          f'engine\'s; kernel 6 launches {res["beside"]["launches"]} '
          f'[{card}]', flush=True)
    return res


def warm_beside_decode(router, engines, gen_factory, kernels, reqs, want,
                       L):
    """Phase 35 (c), second part: a new engine's warm-up runs (eager, on
    the capture stream) while ``router``'s replicas replay their graphs
    on the default stream; the streams must not notice."""
    extra = gen_factory()
    try:
        seen = {}

        def warm():
            steps0 = sum(e.stats()['steps'] for e in engines)
            t0 = time.perf_counter()
            extra.warmup()
            seen['warmup_ms'] = (time.perf_counter() - t0) * 1e3
            seen['steps'] = sum(e.stats()['steps'] for e in engines) - steps0

        since = served_calls(engines)
        zero_launches(kernels)
        streams, _, _ = fleet_wave(router, reqs, FLEET_NEW, arm=warm)
        first = extra.submit(reqs[0], max_new_tokens=FLEET_NEW).result(
            timeout=600)
        got = launch_counts(kernels)
        if not seen['steps']:
            raise AssertionError('(c) the replicas took no step during the '
                                 'third engine\'s warm-up')
        if streams != want or first != want[0]:
            bad = [i for i, (a, b) in enumerate(zip(streams, want)) if a != b]
            raise AssertionError(f'(c) beside a warm-up: streams {bad} '
                                 f'(first equal: {first == want[0]}) differ '
                                 f'from the single engine\'s')
        if extra.stats()['traces'] != 2:
            raise AssertionError(f'(c) the third engine captured '
                                 f'{extra.stats()["traces"]}, want 2')
        want_l = (fleet_launch_want(L, engines, 0, since)
                  + fleet_launch_want(L, [extra], 1))
        expect_launches('(c) beside a warm-up', got,
                        {'paged_decode': want_l})
    finally:
        extra.shutdown()
    return {**seen, 'launches': got['paged_decode']}


def host_run(serving, obs, warmup, _build, gen_factory, ernie_net,
             ernie_cfg, kernels, reqs, L, card):
    """Phase 35 (d): three models on one host whose watermark fits two."""
    import gc

    import paddle_tpu_torch as paddle
    entry = warmup.manifest.serving_bucket_entry(
        SERVE_MAX_BATCH, (((SERVE['s'],), 'int64'),) * 3, 'float32',
        max_batch=SERVE_MAX_BATCH)

    def ernie_factory():
        return serving.InferenceEngine(
            ernie_net, max_batch_size=SERVE_MAX_BATCH,
            max_delay_ms=SERVE_DELAY_MS, warmup=warmup.Manifest([entry]))

    # 64 rows of phase 31's request shape: bucket 64 in one batch
    batch = serve_requests(ernie_cfg.vocab_size, 1, SERVE_MAX_BATCH,
                           SERVE_MAX_BATCH, SERVE['s'], SERVE['len_lo'],
                           SERVE['len_hi'], 3)[0]
    want = layer_outputs(paddle, ernie_net, batch)
    # the footprints, read from the engines by a host at its default
    # watermark (what the allocator could hand out); on this otherwise
    # idle card each must cover the allocator's growth across its deploy
    probe = serving.ModelHost(name='probe')
    grown = {}
    try:
        for name, factory in (('gen', gen_factory),
                              ('ernie', ernie_factory)):
            b0 = device_bytes()
            probe.deploy(name, factory)
            grown[name] = device_bytes() - b0
        fp = {k: d['footprint_bytes'] for k, d in probe.models().items()}
        default_wm = probe.watermark_bytes
    finally:
        probe.close()
    del probe
    gc.collect()
    for name in fp:
        if fp[name] < grown[name]:
            raise AssertionError(f'(d) {name}: footprint {fp[name]} bytes, '
                                 f'below the allocator\'s growth '
                                 f'{grown[name]} across its deploy')
    f_gen, f_e = fp['gen'], fp['ernie']
    wm = max(2 * f_gen, f_gen + f_e) + min(f_gen, f_e) // 2
    base = device_bytes()
    res = {'footprint_gen': f_gen, 'footprint_ernie': f_e,
           'growth_gen': grown['gen'], 'growth_ernie': grown['ernie'],
           'default_watermark': default_wm, 'watermark': wm, 'steps': []}
    host = serving.ModelHost(wm, name='smokehost')

    def step(what):
        used = device_bytes() - base
        states = {k: d['state'] for k, d in host.models().items()}
        res['steps'].append((what, used, states))
        if used > wm or host.stats()['hbm_used_bytes'] > wm:
            raise AssertionError(f'(d) {what}: {used} bytes allocated over '
                                 f'the baseline, host accounts '
                                 f'{host.stats()["hbm_used_bytes"]}; '
                                 f'watermark {wm}')
        return states

    zero_launches(kernels)
    loads = _build.loads
    gen_reqs, gen_builds, ernie_batches = 0, 0, 0
    host.deploy('g1', gen_factory, footprint_bytes=f_gen)
    gen_builds += 1
    before = host.submit('g1', reqs[1], max_new_tokens=FLEET_NEW).result(
        timeout=600)
    gen_reqs += 1
    step('deploy g1')
    host.deploy('g2', gen_factory, footprint_bytes=f_gen)
    gen_builds += 1
    host.submit('g2', reqs[2], max_new_tokens=FLEET_NEW).result(timeout=600)
    gen_reqs += 1
    step('deploy g2')
    host.deploy('ernie', ernie_factory, footprint_bytes=f_e)
    states = step('deploy ernie')
    if states != {'g1': 'evicted', 'g2': 'live', 'ernie': 'live'}:
        raise AssertionError(f'(d) deploying the third model: {states}, '
                             'want the LRU g1 evicted')
    h, p = host.submit('ernie', *batch).result(timeout=600)
    ernie_batches += 1
    err = max(row_err(h, want[0]), row_err(p, want[1]))
    if not err <= SERVE_TOL:
        raise AssertionError(f'(d) ERNIE through the host: row error {err}')
    step('ernie batch')
    t0 = time.perf_counter()
    after = host.submit('g1', reqs[1], max_new_tokens=FLEET_NEW).result(
        timeout=600)
    res['swap_in_submit_ms'] = (time.perf_counter() - t0) * 1e3
    gen_reqs += 1
    gen_builds += 1
    states = step('swap-in g1')
    eng = host._models['g1'].engine
    if states != {'g1': 'live', 'g2': 'evicted', 'ernie': 'live'}:
        raise AssertionError(f'(d) swap-in of g1: {states}, want the LRU '
                             'g2 evicted')
    if after != before:
        raise AssertionError('(d) g1\'s output after its swap-in differs '
                             'from before its eviction')
    if eng.stats()['traces'] != 2 or _build.loads != loads:
        raise AssertionError(f'(d) swapped-in g1: {eng.stats()["traces"]} '
                             f'captures (want 2, all at swap-in), '
                             f'{_build.loads - loads} kernel builds')
    pool = sum(t.numel() * t.element_size() for t in eng._pool.values())
    runs = warmup_runs(eng._fns['step'].captured)
    del eng
    used0 = device_bytes()
    host.evict('g1')
    freed = used0 - device_bytes()
    step('evict g1')
    if freed < pool:
        raise AssertionError(f'(d) evicting g1 freed {freed} bytes, less '
                             f'than its pool\'s {pool}')
    got = launch_counts(kernels)
    want_l = {'paged_decode': L * (gen_reqs * FLEET_NEW
                                   + gen_builds * 2 * runs),
              'flash_fwd': ernie_cfg.num_layers * (ernie_batches + runs)}
    expect_launches('(d) host', got, want_l)
    expect_tensor_core('(d) host', kernels)
    swap = obs.find('host.swap_in_ms', {'host': host.name})
    res.update(swap_in_ms=swap.percentile(50), freed_bytes=freed,
               pool_bytes=pool, ernie_row_err=err, launches=got,
               swap_ins=host.stats()['swap_ins'],
               evictions=host.stats()['evictions'])
    print(f'  (d) host: footprints bench GPT {f_gen / 1e9:.3f} GB, ERNIE-base '
          f'{f_e / 1e9:.3f} GB (read from the engines; the allocator grew '
          f'{grown["gen"] / 1e9:.3f} and {grown["ernie"] / 1e9:.3f} GB '
          f'across their deploys), watermark '
          f'{wm / 1e9:.3f} GB (default {default_wm / 1e9:.1f} GB); deploying '
          f'the third evicted the LRU; swap-in {res["swap_in_ms"]:.1f} ms '
          f'(the submit {res["swap_in_submit_ms"]:.1f} ms), output equal to '
          f'before; evicting g1 freed {freed / 1e9:.3f} GB (its pool '
          f'{pool / 1e9:.3f} GB); at most '
          f'{max(s[1] for s in res["steps"]) / 1e9:.3f} GB over the '
          f'baseline; ERNIE row error {err:.2e}; launches {got} [{card}]',
          flush=True)
    return host, res


def fleetobs_run(fobs, promparse, rs, host, moved_rid, card):
    """Phase 35 (e): FleetObs serving the router's replicas and the host."""
    srv = fobs.serve(port=0)
    try:
        code, body = http_get(srv.url + '/metrics')
        if code != 200:
            raise AssertionError(f'(e) /metrics {code}')
        snap = promparse.parse_text(body.decode())
        rows = {}           # (family, labels but replica) -> replica values
        for key, val in snap['counters'].items():
            labels = dict(snap['labels'][key])
            rep = labels.pop('replica', None)
            row = rows.setdefault((key.split('{')[0],
                                   tuple(sorted(labels.items()))), {})
            row[rep] = val
        checked = 0
        for (name, _), row in sorted(rows.items()):
            val = row.pop(None, None)
            parts = list(row.values())
            if parts and val is not None:
                if val != sum(parts):
                    raise AssertionError(f'(e) {name} {val}, replicas sum '
                                         f'{sum(parts)}')
                checked += 1
        tok = snap['counters'].get('gen_tokens')
        if not checked or not tok:
            raise AssertionError('(e) no federated counter to check')
        code, body = http_get(srv.url + '/debug/fleet')
        table = json.loads(body)
        reps = sorted(r['replica'] for r in table['replicas'])
        if reps != sorted(r.name for r in rs.snapshot()) or \
                sorted(table['hosts'][0]['models']) != ['ernie', 'g1', 'g2']:
            raise AssertionError(f'(e) /debug/fleet {table}')
        code, body = http_get(srv.url + '/debug/requests?id=' + moved_rid)
        st = json.loads(body)['stitched']
        if len(st['attempts']) < 2 or st['attempts'][0]['outcome'] != \
                'failover':
            raise AssertionError(f'(e) stitched {st}')
    finally:
        srv.stop()
    res = {'counters_checked': checked, 'gen_tokens': tok,
           'attempts': len(st['attempts']),
           'replicas': [a['replica'] for a in st['attempts']]}
    print(f'  (e) FleetObs: {checked} federated counters each equal their '
          f'replicas\' sum (gen_tokens {tok}); /debug/fleet lists '
          f'{len(reps)} replicas and the host\'s 3 models; the moved '
          f'request {moved_rid} stitched over {len(st["attempts"])} '
          f'attempts {res["replicas"]} [{card}]', flush=True)
    return res



# ---------------------------------------------------------------------------
# phases 36-37: detection and OCR (PP-YOLOE, SVTR-lite, CRNN), NMS
# ---------------------------------------------------------------------------

DET = dict(batch=8, size=640, classes=80, max_boxes=16, steps=5, lr=2e-3)
DET_MAX_OUT = 100            # COCO's detections-per-image cap
DET_IOU = 0.5
OCR = dict(batch=64, width=320, steps=5, lr=1e-3)
PREDICT_ITERS = 20
NMS_ITERS = 20
EXPORT_MAX_S = 30.0
NMS_OPS_PER_PAIR = 14        # the IoU and its compare, f32, csrc/nms.cu


def served_detector(paddle, det, max_out=DET_MAX_OUT):
    """The reference's served detector (examples/train_detection.py,
    tests/test_detection_train.py): decode, the best score a box,
    nms_static(unroll=True) over the first image."""
    class Served(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.det = det

        def forward(self, x):
            boxes, scores = self.det.decode(self.det(x))
            best = scores[0].max(axis=-1)
            keep, valid = paddle.vision.ops.nms_static(
                boxes[0], best, iou_threshold=DET_IOU, max_out=max_out,
                unroll=True)
            return boxes, scores, keep, valid
    return Served()


def profile_detection_step(paddle, step):
    """One train step under torch.profiler. Device ms by kind: cuDNN's
    convolutions (``aten::cudnn_convolution``, ``aten::convolution_
    backward``), BatchNorm (its layers' forward in record_function ranges
    and the backward nodes of the ops inside them, matched by autograd
    sequence number, as phase 29), the TAL assignment (its own range; it
    runs on detached scores, so it has no backward) and the rest (SiLU,
    the heads' reshapes, the losses, the optimizer)."""
    from paddle_tpu_torch.vision import detection
    with tagged_profile(paddle, [(detection, 'task_aligned_assign')]) as (
            p, t0):
        loss = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, by_op, bn, events = tagged_device_ms(p.events())
    kernels = p.kernels
    tal = _events_device_ms(
        events, lambda e: e.name == 'paddle::task_aligned_assign')
    conv = sum(by_op.get(o, 0.0) for o in (
        'aten::cudnn_convolution', 'aten::convolution_backward'))
    return float(loss), {
        'window_ms': wall * 1e3, 'device_ms': total, 'kernels': len(kernels),
        'busy_share': total / (wall * 1e3),
        'device_ms_by_kind': {'conv': conv, 'batch_norm': bn,
                              'tal_assign': tal,
                              'rest': total - conv - bn - tal}}


def detection_train(paddle, V, card):
    """(a): PPYOLOE() at [8, 3, 640, 640] f32, 5 Adam steps on one batch of
    synthetic boxes; steps 1-3 timed, step 4 profiled."""
    from paddle_tpu_torch.models import PPYOLOE
    paddle.seed(0)
    net = PPYOLOE()
    n_params = sum(int(np.prod(p.shape)) for p in net.parameters())
    opt = paddle.optimizer.Adam(learning_rate=DET['lr'],
                                parameters=net.parameters())
    batch = V.synth_detection_batch(np.random.RandomState(0), DET['batch'],
                                    DET['size'], DET['classes'],
                                    max_boxes=DET['max_boxes'])
    x, gb, gl, gm = (paddle.to_tensor(a) for a in batch)

    def step():
        loss = net.loss(net(x), gb, gl, gm)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(DET['steps'] - 1):
        loss, s = timed(lambda: float(step()))
        losses.append(loss)
        secs.append(s)
    loss, prof = profile_detection_step(paddle, step)
    losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f'PP-YOLOE losses not finite: {losses}')
    step_ms = 1e3 * float(np.mean(secs[1:]))
    k = prof['device_ms_by_kind']
    print(f'  (a) PPYOLOE() ({n_params / 1e6:.2f}M parameters, 80 classes, '
          f'width 32, reg_max 16, 8,400 anchors) at [8, 3, 640, 640] f32, '
          f'TF32 off, {int(batch[3].sum())} boxes: {DET["steps"]} Adam '
          f'steps, step {step_ms:.1f} ms (steps 1-3; step 0 '
          f'{1e3 * secs[0]:.1f}), {DET["batch"] / step_ms * 1e3:.1f} '
          f'images/s, peak {peak:.2f} GB, losses '
          f'{[round(v, 3) for v in losses]}; profiled step '
          f'{prof["window_ms"]:.1f} ms, device {prof["device_ms"]:.1f} ms '
          f'(busy {prof["busy_share"]:.1%}, {prof["kernels"]} kernels): '
          f'conv {k["conv"]:.1f}, BatchNorm {k["batch_norm"]:.1f}, TAL '
          f'assign {k["tal_assign"]:.1f}, rest {k["rest"]:.1f} ms [{card}]',
          flush=True)
    return net, {'params': n_params, 'step_ms': step_ms,
                 'step0_ms': 1e3 * secs[0],
                 'images_per_s': DET['batch'] / step_ms * 1e3,
                 'peak_gb': peak, 'losses': losses, 'profile': prof}


def served_export(paddle, net, V, kernels, card, tmp):
    """(b): the served detector through jit.save at [1, 3, 640, 640]: one
    nms_static node, the layer-free Predictor equal to the Layer, its p50
    at batch 1."""
    from paddle_tpu_torch import inference
    net.eval()
    served = served_detector(paddle, net)
    served.eval()
    path = os.path.join(tmp, 'ppyoloe')
    spec = [paddle.static.InputSpec([1, 3, DET['size'], DET['size']],
                                    'float32')]
    t0 = time.perf_counter()
    paddle.jit.save(served, path, input_spec=spec)
    export_s = time.perf_counter() - t0
    ep = torch.export.load(path + '.pt2')
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    n_nms = targets.count('paddle_tpu_torch.nms_static.default')
    if n_nms != 1:
        raise AssertionError(f'the served program holds {n_nms} nms_static '
                             'nodes, not 1')
    if export_s > EXPORT_MAX_S:
        raise AssertionError(f'jit.save of the served detector took '
                             f'{export_s:.1f} s (over {EXPORT_MAX_S:g})')
    xq = V.synth_detection_batch(np.random.RandomState(1), 1, DET['size'],
                                 DET['classes'])[0]
    nms_k = kernels['nms_static']
    nms_k.launches = 0
    with paddle.no_grad():
        want = [t._value for t in served(paddle.to_tensor(xq))]
    layer_launches, nms_k.launches = nms_k.launches, 0
    pred = inference.create_predictor(inference.Config(path + '.pdmodel'))
    got = pred.run([xq])
    pred_launches = nms_k.launches
    if (layer_launches, pred_launches) != (1, 1):
        raise AssertionError(f'nms_static launches: the Layer '
                             f'{layer_launches}, the Predictor\'s run '
                             f'{pred_launches}; want 1 and 1')
    keep_w, keep_g = want[2].cpu().numpy(), np.asarray(got[2])
    valid_w, valid_g = int(want[3]), int(np.asarray(got[3]))
    if not (np.array_equal(keep_w, keep_g) and valid_w == valid_g):
        raise AssertionError(f'Predictor keep/valid differ from the Layer: '
                             f'{valid_g} vs {valid_w}')
    errs = [float(np.abs(np.asarray(g) - w.cpu().numpy()).max())
            / max(1.0, float(w.abs().max())) for g, w in zip(got[:2],
                                                             want[:2])]
    if max(errs) > VISION_CARD_TOL:
        raise AssertionError(f'Predictor boxes/scores off the Layer: {errs}')
    times = []
    for _ in range(PREDICT_ITERS):
        t0 = time.perf_counter()
        pred.run([xq])
        times.append(time.perf_counter() - t0)
    p50 = 1e3 * float(np.median(times))
    launches = layer_launches + nms_k.launches
    expect_launches('served PP-YOLOE (the Layer, the Predictor)',
                    {'nms_static': launches},
                    {'nms_static': 2 + PREDICT_ITERS})
    print(f'  (b) served PP-YOLOE (decode, best score, nms_static(iou 0.5, '
          f'max_out {DET_MAX_OUT}, unroll=True)): jit.save {export_s:.1f} s, '
          f'{len(targets)} nodes, 1 nms_static; Predictor keep/valid equal '
          f'to the Layer ({valid_g} kept of 8,400), boxes/scores within '
          f'{max(errs):.1e}; layer-free p50 at batch 1 {p50:.2f} ms '
          f'[{card}]', flush=True)
    boxes, scores = want[0][0], want[1][0].amax(-1)
    return (boxes, scores), {'export_s': export_s, 'nodes': len(targets),
                             'valid': valid_g, 'predictor_p50_ms': p50,
                             'box_err': max(errs), 'launches': launches}


def nms_pairs_needed(scores, keep, valid, max_out):
    """The (box, kept box) IoU tests greedy NMS needs on this data: each
    box in score order is tested against the boxes kept before it, up to
    the box that fills ``max_out`` (or the last box)."""
    s = scores.float().cpu().numpy()
    n = s.shape[0]
    rank = np.empty(n, np.int64)
    rank[np.argsort(-s, kind='stable')] = np.arange(n)
    kept = np.sort(rank[keep.cpu().numpy()[:int(valid)]])
    stop = int(kept[-1]) + 1 if int(valid) == max_out else n
    return int(np.sum(stop - 1 - kept))


def nms_bound(n, max_out, pairs):
    """The least time of the mask pass and the sweep together: the sorted
    boxes and the order read once, keep and valid written once (the
    bitmask is this design's own, not the function's), and the IoU and
    its compare for the ``pairs`` tests this run's data needs."""
    nbytes = 16 * n + 4 * n + 4 * max_out + 4
    ops = NMS_OPS_PER_PAIR * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def nms_against_twin(V, served_boxes, card):
    """(c): the kernel against its twin, exactly: the served decode's 8,400
    boxes, a dense overlap case and categories; the kernel's device ms and
    the twin's."""
    from paddle_tpu_torch.ops import nms as nms_mod
    rng = np.random.RandomState(3)
    boxes, scores = served_boxes
    n = boxes.shape[0]
    base = V.random_boxes(rng, 40, size=640.0, lo=60.0, hi=200.0)
    dense = torch.from_numpy((base[rng.randint(0, 40, 4000)] + rng.normal(
        0, 6.0, (4000, 4))).astype('f4')).cuda()
    cases = {
        'served_8400': (boxes, scores, None),
        'dense_4000': (dense, torch.rand(4000, generator=torch.Generator()
                                         .manual_seed(0)).cuda(), None),
        'categories_8400': (boxes, scores, torch.from_numpy(
            rng.randint(0, 80, n).astype('i4')).cuda()),
    }
    recs = {}
    for name, (b, s, cat) in cases.items():
        got = nms_mod.nms_static_cuda(b, s, DET_IOU, DET_MAX_OUT, cat)
        want = nms_mod.nms_static_reference(b, s, DET_IOU, DET_MAX_OUT, cat)
        torch.cuda.synchronize()
        equal = (torch.equal(got[0].cpu(), want[0].cpu())
                 and int(got[1]) == int(want[1]))
        if not equal:
            raise AssertionError(f'nms kernel vs twin ({name}): keep/valid '
                                 f'differ ({int(got[1])} vs {int(want[1])})')
        recs[name] = {'n': int(b.shape[0]), 'valid': int(got[1]),
                      'max_abs_err': 0}
    b, s, _ = cases['served_8400']
    prof = profile_window(lambda: [nms_mod.nms_static_cuda(
        b, s, DET_IOU, DET_MAX_OUT) for _ in range(NMS_ITERS)])
    mask_ms = kernel_ms(prof, 'nms_mask_kernel') / NMS_ITERS
    sweep_ms = kernel_ms(prof, 'nms_sweep_kernel') / NMS_ITERS
    ms = mask_ms + sweep_ms
    op_ms = prof['device_ms'] / NMS_ITERS
    want, plain_s = timed(lambda: nms_mod.nms_static_reference(
        b, s, DET_IOU, DET_MAX_OUT))
    pairs = nms_pairs_needed(s, want[0], want[1], DET_MAX_OUT)
    bound_ms, bound_by = nms_bound(n, DET_MAX_OUT, pairs)
    rec = dict(recs['served_8400'], ms=ms, mask_ms=mask_ms,
               sweep_ms=sweep_ms, op_ms=op_ms, pairs_needed=pairs,
               plain_ms=plain_s * 1e3, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None)
    recs['served_8400'] = rec
    print(f'  (c) nms kernel vs twin, exactly equal: ' + ', '.join(
        f'{k} (n {r["n"]}, {r["valid"]} kept)' for k, r in recs.items())
        + f'; n {n}: kernel {ms:.4f} ms (mask pass {mask_ms:.4f}, sweep '
        f'{sweep_ms:.4f}; the operator with its sort {op_ms:.4f}), twin '
        f'{plain_s * 1e3:.2f} ms, bound {bound_ms:.6f} ms ({bound_by}; '
        f'{pairs:,} IoU tests needed of {n * (n - 1) // 2:,} pairs) '
        f'[{card}]', flush=True)
    return recs


def ocr_train(paddle, V, name, make, classes, card):
    """(d): SVTRLite() / CRNN() at [64, 1, 32, 320] (80 time steps), 5 Adam
    steps of nn.CTCLoss on glyph strips: step ms, finite and falling loss;
    eval forwards at batch 1 and 64."""
    paddle.seed(0)
    net = make()
    opt = paddle.optimizer.Adam(learning_rate=OCR['lr'],
                                parameters=net.parameters())
    ctc = paddle.nn.CTCLoss(blank=0)
    x, labels, in_len, lab_len = (paddle.to_tensor(a) for a in V.ocr_batch(
        np.random.RandomState(2), OCR['batch'], OCR['width'], classes))

    def step():
        logits = net(x)
        loss = ctc(paddle.transpose(logits, [1, 0, 2]), labels, in_len,
                   lab_len)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(OCR['steps']):
        loss, s = timed(lambda: float(step()))
        losses.append(loss)
        secs.append(s)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f'{name} CTC losses not finite and falling: '
                             f'{losses}')
    net.eval()
    evals = {}
    with paddle.no_grad():
        for b in (1, OCR['batch']):
            xb = paddle.to_tensor(x.numpy()[:b])
            logits, _ = timed(lambda: net(xb))
            _, s = timed(lambda: net(xb))
            if list(logits.shape) != [b, OCR['width'] // 4, classes]:
                raise AssertionError(f'{name} logits {logits.shape}')
            evals[b] = s * 1e3
    step_ms = 1e3 * float(np.mean(secs[1:]))
    print(f'  (d) {name} at [64, 1, 32, 320] (T 80, {classes} classes): '
          f'step {step_ms:.1f} ms (steps 1-4; step 0 {secs[0] * 1e3:.1f}), '
          f'peak {peak:.2f} GB, CTC losses {[round(v, 3) for v in losses]}; '
          f'eval forward batch 1 {evals[1]:.2f} ms, batch 64 '
          f'{evals[OCR["batch"]]:.2f} ms [{card}]', flush=True)
    return {'step_ms': step_ms, 'step0_ms': secs[0] * 1e3, 'peak_gb': peak,
            'losses': losses, 'eval_ms': evals}


def phase_detection_ocr(kernels, card):
    """Phase 36: detection and OCR at full width (the reference classes'
    defaults, random weights from seed 0): (a) PP-YOLOE training, (b) the
    served PP-YOLOE through jit.save and the layer-free Predictor, (c) the
    NMS kernel against its twin, (d) SVTR-lite and CRNN training and eval.
    Each part prints its seconds."""
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import CRNN, SVTRLite
    V = tests_module('torch_vision_cases')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device('gpu')
    out, secs = {}, {}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_det_')
    try:
        t0 = time.perf_counter()
        net, out['train'] = detection_train(paddle, V, card)
        secs['train'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served_boxes, out['served'] = served_export(paddle, net, V, kernels,
                                                    card, tmp)
        secs['served'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['nms'] = nms_against_twin(V, served_boxes, card)
        secs['nms'] = time.perf_counter() - t0
        del net, served_boxes
        torch.cuda.empty_cache()
        for name, make, classes in (('SVTRLite()', SVTRLite, 96),
                                    ('CRNN()', CRNN, 96)):
            t0 = time.perf_counter()
            out[name] = ocr_train(paddle, V, name, make, classes, card)
            secs[name] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print('  parts: ' + ', '.join(f'{k} {v:.1f} s' for k, v in secs.items()),
          flush=True)
    out['part_seconds'] = secs
    out['launches'] = out['served']['launches']
    return out


def _card_cpu_gap(card_vals, cpu_vals):
    """The largest |card - cpu| of each part over its largest value (at
    least 1), over matching lists of arrays."""
    return max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
               for a, b in zip(card_vals, cpu_vals))


def _slice_model_run(paddle, make, start, dev, x, loss_of):
    """(eval outputs, train loss, gradients by name) of ``make(paddle)``
    from the state ``start`` on ``dev``."""
    paddle.set_device(dev)
    net = make(paddle)
    net.set_state_dict(start)
    net.eval()
    with paddle.no_grad():
        outs = net(paddle.to_tensor(x))
        if hasattr(net, 'decode'):     # the detector: its heads and decode
            outs = [t for pair in outs for t in pair] + list(
                net.decode(outs, conf_thresh=0.1))
        elif not isinstance(outs, (list, tuple)):
            outs = [outs]
    outs = [t.numpy() for t in outs]
    net.train()
    loss = loss_of(paddle, net, paddle.to_tensor(x))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()
             if p.grad is not None}
    return outs, float(loss), grads


def phase_detection_card_vs_cpu():
    """Phase 37: this slice card against CPU in float32 (TF32 off): the
    reference tests' small models (PPYOLOE(num_classes=4, width=8,
    reg_max=8) at [2, 3, 64, 64] with decode, SVTRLite(num_classes=12,
    dim=32, num_heads=2) and CRNN(num_classes=11) at [2, 1, 32, 64] with
    nn.CTCLoss) from the same weights: eval outputs, the train-mode loss
    and every gradient within 2e-5 of the part's largest value beyond 4 x
    what the card's own result moves when the input moves by 1e-7 (phase
    30's rule for train-mode BatchNorm); the vision-op table
    (torch_vision_cases.op_cases) and the detection losses within 2e-5;
    nms_static and nms over torch_vision_cases.nms_cases exactly equal."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import detection as D
    V = tests_module('torch_vision_cases')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, bad = {}, []
    det_batch = V.synth_detection_batch(np.random.RandomState(0), 2, 64, 4)
    ocr = V.ocr_batch(np.random.RandomState(2), 2, 64, 12)

    def det_loss(P, net, x):
        gb, gl, gm = (P.to_tensor(a) for a in det_batch[1:])
        return net.loss(net(x), gb, gl, gm)

    def det_make(P):
        return P.models.PPYOLOE(num_classes=4, width=8, reg_max=8)

    def ctc_loss(P, net, x):
        logits = net(x)
        return P.nn.CTCLoss(blank=0)(
            P.transpose(logits, [1, 0, 2]), P.to_tensor(ocr[1]),
            P.to_tensor(ocr[2]), P.to_tensor(ocr[3]))
    models = {
        'PPYOLOE': (det_make, det_batch[0], det_loss),
        'SVTRLite': (lambda P: P.models.SVTRLite(num_classes=12, dim=32,
                                                 num_heads=2), ocr[0],
                     ctc_loss),
        'CRNN': (lambda P: P.models.CRNN(num_classes=11), ocr[0], ctc_loss),
    }
    for name, (make, x, loss_of) in models.items():
        paddle.set_device('cpu')
        paddle.seed(0)
        start = {k: v.numpy() for k, v in make(paddle).state_dict().items()}
        cpu = _slice_model_run(paddle, make, start, 'cpu', x, loss_of)
        card = _slice_model_run(paddle, make, start, 'gpu', x, loss_of)
        moved = _slice_model_run(paddle, make, start, 'gpu', nudged(x),
                                 loss_of)
        names = sorted(cpu[2])
        gaps = {'out': _card_cpu_gap(card[0], cpu[0]),
                'loss': abs(card[1] - cpu[1]) / max(1.0, abs(cpu[1])),
                'grad': _card_cpu_gap([card[2][k] for k in names],
                                      [cpu[2][k] for k in names])}
        floor = {'out': _card_cpu_gap(moved[0], card[0]),
                 'loss': abs(moved[1] - card[1]) / max(1.0, abs(card[1])),
                 'grad': _card_cpu_gap([moved[2][k] for k in names],
                                       [card[2][k] for k in names])}
        ok = within_nudge_floor(gaps, floor, dict.fromkeys(
            gaps, VISION_CARD_TOL))
        out[name] = {'gaps': gaps, 'floor': floor, 'ok': ok}
        print(f'  {name}: eval out {gaps["out"]:.1e}, loss '
              f'{gaps["loss"]:.1e}, gradients {gaps["grad"]:.1e} (tol '
              f'{VISION_CARD_TOL:g} beyond 4 x the card\'s move under a '
              f'1e-7 nudge: {floor["out"]:.1e} / {floor["loss"]:.1e} / '
              f'{floor["grad"]:.1e}) {"OK" if ok else "FAIL"}', flush=True)
        if not ok:
            bad.append((name, gaps, floor))
    worst = 0.0
    for case, (fn_name, args, kw) in V.op_cases().items():
        fn = getattr(paddle.vision.ops, fn_name)
        res = []
        for dev in ('cpu', 'gpu'):
            paddle.set_device(dev)
            t = (lambda a: paddle.to_tensor(a) if isinstance(a, np.ndarray)
                 and a.dtype == np.float32 else a)
            r = fn(*[t(a) for a in args], **{k: t(v) for k, v in kw.items()})
            res.append([v.numpy() for v in (r if isinstance(r, (list, tuple))
                                             else [r])])
        gap = _card_cpu_gap(res[1], res[0])
        worst = max(worst, gap)
        if gap > VISION_CARD_TOL:
            bad.append((case, gap))
    rng = np.random.RandomState(6)
    pred, tgt = V.random_boxes(rng, 64), V.random_boxes(rng, 64)
    logits = rng.randn(64, 6).astype('f4')
    score = np.where(rng.rand(64, 6) < 0.2, rng.rand(64, 6), 0).astype('f4')
    dist = rng.randn(64, 4, 9).astype('f4')
    t = (rng.rand(64, 4) * 8).astype('f4')
    losses = {'pairwise_iou': (D.pairwise_iou, pred, tgt),
              'giou_loss': (D.giou_loss, pred, tgt),
              'varifocal_loss': (D.varifocal_loss, logits, score),
              'distribution_focal_loss': (D.distribution_focal_loss, dist,
                                          t),
              'dfl_decode': (D.dfl_decode, dist)}
    for lname, (fn, *args) in losses.items():
        res = [fn(*[torch.from_numpy(a).to(dev) for a in args]).cpu().numpy()
               for dev in ('cpu', 'cuda')]
        gap = _card_cpu_gap([res[1]], [res[0]])
        worst = max(worst, gap)
        if gap > VISION_CARD_TOL:
            bad.append((lname, gap))
    out['ops_and_losses_worst'] = worst
    n_nms = 0
    for name, boxes, scores, cats, thr, max_out in V.nms_cases():
        res = []
        for dev in ('cpu', 'gpu'):
            paddle.set_device(dev)
            k, v = paddle.vision.ops.nms_static(boxes, scores, thr, max_out,
                                                category_idxs=cats)
            e = paddle.vision.ops.nms(boxes, thr, scores, category_idxs=cats,
                                      top_k=max_out)
            res.append((k.numpy(), int(v.numpy()), e.numpy()))
        if not (np.array_equal(res[0][0], res[1][0])
                and res[0][1] == res[1][1]
                and np.array_equal(res[0][2], res[1][2])):
            bad.append(('nms ' + name, res[0][1], res[1][1]))
        n_nms += 1
    print(f'  the vision-op table ({len(V.op_cases())} cases) and the '
          f'detection losses: largest gap {worst:.1e} (tol '
          f'{VISION_CARD_TOL:g}); nms_static and nms over {n_nms} cases '
          f'(up to 2,100 boxes): card equal to CPU '
          f'{"OK" if not any(str(b[0]).startswith("nms") for b in bad) else "FAIL"}',
          flush=True)
    paddle.set_device('gpu')
    if bad:
        raise AssertionError(f'phase 37: card against CPU: {bad[:6]}')
    return out


# ---------------------------------------------------------------------------
# phase 38: the hybrid-parallel train step, 2 ranks on the one card
# ---------------------------------------------------------------------------

MESH_B, MESH_S = 8, 1024   # the global batch of the phase (bench GPT)
MESH_LAYERS = 4            # the bf16 run's depth: pp2 has 2 layers a stage
MESH_F32_LAYERS = 2        # the f32 run held to the single rank: 1 a stage
MESH_STEPS = 2
MESH_LR = 2e-4
# (name, HybridTopology degrees, GPTConfig overrides) of the 2 ranks
MESH_LAYOUTS = [
    ('dp2', dict(dp=2), {}),
    ('dp2_int8', dict(dp=2), dict(grad_quant='int8')),
    ('mp2', dict(mp=2), dict(mp=2)),
    ('sp2', dict(sp=2), dict(sp=2)),
    ('pp2_gpipe', dict(pp=2), dict(pp=2, n_microbatches=4)),
    ('pp2_1f1b', dict(pp=2), dict(pp=2, n_microbatches=4,
                                  pp_schedule='1f1b')),
]
# step 1's loss of a bf16 layout against the single rank's, relative: the
# layouts sum the same bf16 products in other orders (mp: two half-width
# partial sums meet in a bf16 all-reduce; sp: the hops' bf16 outputs merge
# in f32; pp: 4 microbatches), so they agree with one rank to the rounding
# of the bf16 activations, which the mean over 8,192 tokens averages down:
# 2**-8 is one bf16 rounding step of the loss itself
MESH_BF16_TOL = 2.0 ** -8
MESH_F32_TOL = 1e-4        # the CPU tests' tolerance, f32 (TF32 off)
# the f32 run's AdamW epsilon: at 1e-8 a gradient that is zero but for f32
# rounding moves its weight by up to lr / 2 whatever the layout
MESH_F32_EPS = 1e-6
INT8_CURVE_TOL = 5e-3      # the reference's bound of int8 against f32 wire


def mesh_config(gpt, dtype, layers, **over):
    return bench_config(gpt, num_layers=layers, dtype=dtype, remat=True,
                        remat_policy='dots', use_flash=True, **over)


def mesh_params(gpt, cfg):
    """The global parameters from a CPU generator of seed 0 (every process
    draws the same), on the card."""
    p = gpt.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    return {k: ({b: t.cuda() for b, t in v.items()} if k == 'blocks'
                else v.cuda()) for k, v in p.items()}


def mesh_batch(vocab):
    rs = np.random.RandomState(38)
    toks = rs.randint(0, vocab, (MESH_B, MESH_S)).astype(np.int32)
    tgts = rs.randint(0, vocab, (MESH_B, MESH_S)).astype(np.int32)
    return torch.from_numpy(toks).cuda(), torch.from_numpy(tgts).cuda()


def mesh_launches_want(over, rank, layers):
    """Kernels 1-3 a step on one rank of a layout, remat on. One rank (dp,
    mp): kernel 1 twice a layer (the forward and the backward's
    recompute), kernels 2 and 3 once. sp2 (causal ring, S_local 512): rank
    r runs r + 1 hops a layer (rank 0 the diagonal only, rank 1 the past
    block and the diagonal), each hop once in the forward and once in the
    recompute, kernels 2 and 3 once a hop: rank 0 2L / L / L, rank 1 4L /
    2L / 2L. pp2 (GPipe or 1F1B, m = 4 microbatches, L / 2 layers a
    stage): each microbatch's stage runs once without autograd and once
    recomputed in its backward tick: kernel 1 2 x (L / 2) x m, kernels 2
    and 3 (L / 2) x m."""
    if over.get('sp', 1) > 1:
        hops = rank + 1
        return {'flash_fwd': 2 * layers * hops,
                'flash_bwd_dq': layers * hops,
                'flash_bwd_dkv': layers * hops}
    if over.get('pp', 1) > 1:
        n = (layers // 2) * over['n_microbatches']
        return {'flash_fwd': 2 * n, 'flash_bwd_dq': n, 'flash_bwd_dkv': n}
    return {'flash_fwd': 2 * layers, 'flash_bwd_dq': layers,
            'flash_bwd_dkv': layers}


def mesh_steps(step, params, state, toks, tgts, kernels, mesh=None, f8=None):
    """MESH_STEPS steps: each one's loss, ms (host clock to a sync),
    kernels 1-3's launches and tensor-core launches, and the bytes and
    calls the one-card transport staged; with an fp8 state ``f8`` (the
    fp8 step), each step's new state too, as lists."""
    recs = []
    for i in range(MESH_STEPS):
        zero_launches(kernels)
        if mesh is not None:
            mesh.reset_staged()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if f8 is None:
            loss, params, state = step(params, state, 1000 + i, MESH_LR,
                                       toks, tgts)
        else:
            loss, params, state, f8 = step(params, state, f8, 1000 + i,
                                           MESH_LR, toks, tgts)
        loss = loss.item()
        torch.cuda.synchronize()
        recs.append({'loss': loss, 'ms': (time.perf_counter() - t0) * 1e3,
                     'launches': {n: kernels[n].launches
                                  for n in TC_KERNELS},
                     'tc': {n: kernels[n].tc_launches for n in TC_KERNELS},
                     'staged': (mesh.staged() if mesh is not None
                                else {'calls': 0, 'bytes': 0})})
        if f8 is not None:
            recs[-1]['fp8'] = {n: {r: {k: t.tolist() for k, t in m.items()}
                                   for r, m in meta.items()}
                               for n, meta in f8['blocks'].items()}
    return recs, params


def mesh_f32_err(got, want):
    """The largest element gap of two parameter dicts (stacked blocks
    and the rest)."""
    return max([(got['blocks'][b] - want['blocks'][b]).abs().max().item()
                for b in got['blocks']]
               + [(got[k] - want[k]).abs().max().item()
                  for k in got if k != 'blocks'])


def mesh_rank(tmp):
    """One rank of phase 38 (run by paddle.distributed.spawn): every
    layout in bf16 at MESH_LAYERS and in f32 at MESH_F32_LAYERS; the f32
    parameters after the steps, gathered, against the single rank's that
    the parent saved. Writes rank<r>.json in ``tmp``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import flash_attention as fa
    dist.init_parallel_env()
    rank = dist.get_rank()
    kernels = {n: getattr(fa, n) for n in TC_KERNELS}
    out = {'rank': rank, 'bf16': {}, 'f32': {}}
    yard = torch.load(os.path.join(tmp, 'single_f32.pt'), map_location='cuda')
    for dtype, layers, key in (('bfloat16', MESH_LAYERS, 'bf16'),
                               ('float32', MESH_F32_LAYERS, 'f32')):
        full = mesh_params(gpt, mesh_config(gpt, dtype, layers))
        toks, tgts = mesh_batch(full['wte'].shape[0])
        for name, deg, over in MESH_LAYOUTS:
            topo = dist.HybridTopology(**deg)
            cfg = mesh_config(gpt, dtype, layers, **over)
            params = gpt.place_params(full, cfg, topo.mesh)
            opt = topt.AdamW(learning_rate=MESH_LR, weight_decay=0.01,
                             **({'epsilon': MESH_F32_EPS} if key == 'f32'
                                else {}))
            state = opt.functional_init(params)
            step = gpt.make_train_step(cfg, opt, topo.mesh)
            recs, params = mesh_steps(step, params, state, toks, tgts,
                                      kernels, topo.mesh)
            rec = {'steps': recs}
            if key == 'f32':
                rec['param_err'] = mesh_f32_err(
                    gpt.gather_params(params, cfg, topo.mesh), yard)
            out[key][name] = rec
            del params, state, step
            torch.cuda.empty_cache()
        del full
        torch.cuda.empty_cache()
    write_file(os.path.join(tmp, f'rank{rank}.json'), json.dumps(out))
    # the same two ranks take phase 39 once the parent has its yardstick
    # (a process of its own a phase paid ~20 s: the start and gloo's first
    # all-reduce of CUDA tensors)
    if wait_file(os.path.join(tmp, 'next')) == 'go':
        moe_mesh_rank(tmp)


def write_file(path, text):
    """Write ``text`` to ``path`` whole: to a name of its own first, then
    renamed into place, so a file that ``wait_file`` sees is complete."""
    part = f'{path}.part{os.getpid()}'
    with open(part, 'w') as f:
        f.write(text)
    os.replace(part, path)


def wait_file(path, procs=(), timeout=900):
    """The text of ``path`` once it exists (written by ``write_file``);
    raises if one of ``procs`` (processes) ends first or ``timeout``
    seconds pass."""
    t0 = time.time()
    while not os.path.exists(path):
        if any(p.exitcode not in (None, 0) for p in procs):
            raise RuntimeError(f'a rank ended before writing {path}')
        if time.time() - t0 > timeout:
            raise TimeoutError(f'no {path} after {timeout} s')
        time.sleep(0.05)
    with open(path) as f:
        return f.read()


def phase_mesh_train(kernels, card):
    """Phase 38 (see the module docstring): the single rank's steps here,
    then 2 ranks spawned on the one card over gloo with the host-staged
    transport, every layout against the single rank. The ranks stay for
    phase 39: -> (the record, (the ranks' context, their directory)),
    which ``phase_moe_mesh`` takes; on a failure here they are stopped."""
    import tempfile
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_mesh_')
    single, ctx = {}, None
    try:
        for dtype, layers, key in (('bfloat16', MESH_LAYERS, 'bf16'),
                                   ('float32', MESH_F32_LAYERS, 'f32')):
            cfg = mesh_config(gpt, dtype, layers)
            params = mesh_params(gpt, cfg)
            opt = topt.AdamW(learning_rate=MESH_LR, weight_decay=0.01,
                             **({'epsilon': MESH_F32_EPS} if key == 'f32'
                                else {}))
            state = opt.functional_init(params)
            toks, tgts = mesh_batch(cfg.vocab_size)
            recs, params = mesh_steps(gpt.make_train_step(cfg, opt), params,
                                      state, toks, tgts, kernels)
            single[key] = recs
            if key == 'bf16':
                expect_launches('single rank, a step', recs[-1]['launches'],
                                mesh_launches_want({}, 0, layers))
            else:
                torch.save({k: ({b: t.cpu() for b, t in v.items()}
                                if k == 'blocks' else v.cpu())
                            for k, v in params.items()},
                           os.path.join(tmp, 'single_f32.pt'))
            print(f'  single rank {key} ({layers} layers): losses '
                  f'{[round(r["loss"], 6) for r in recs]}, step ms '
                  f'{[round(r["ms"], 1) for r in recs]}', flush=True)
            del params, state
            torch.cuda.empty_cache()
        # gloo's two ranks meet over the loopback interface
        os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
        t0 = time.perf_counter()
        ctx = dist.spawn(mesh_rank, (tmp,), nprocs=2, backend='gloo',
                         join=False)
        ranks = [json.loads(wait_file(os.path.join(tmp, f'rank{r}.json'),
                                      ctx.processes)) for r in range(2)]
        spawn_s = time.perf_counter() - t0
        res = mesh_train_checks(single, ranks, spawn_s, card)
    except BaseException:
        stop_ranks(ctx, tmp)
        raise
    return res, (ctx, tmp)


def stop_ranks(ctx, tmp):
    """Tell the kept ranks there is no phase 39 (unless it was given
    them), end them, drop their directory."""
    import shutil
    nxt = os.path.join(tmp, 'next')
    if ctx is not None:
        if not os.path.exists(nxt):
            write_file(nxt, 'stop')
        for p in ctx.processes:
            p.join(30)
            if p.is_alive():
                p.terminate()
    shutil.rmtree(tmp, ignore_errors=True)


def mesh_train_checks(single, ranks, spawn_s, card):
    """Phase 38's checks and record from the single rank's and the 2
    ranks' results."""
    res = {'single': single, 'spawn_s': spawn_s, 'layouts': {},
           'launches': {n: 0 for n in TC_KERNELS}}
    print(f'  2 ranks spawned on {card!r} (gloo, host-staged p2p and '
          f'gathers): {spawn_s:.1f} s with both runs', flush=True)
    base = single['bf16'][0]['loss']
    base32 = [r['loss'] for r in single['f32']]
    for name, _, over in MESH_LAYOUTS:
        lay = {}
        for r, out in enumerate(ranks):
            recs = out['bf16'][name]['steps']
            want = mesh_launches_want(over, r, MESH_LAYERS)
            for i, rec in enumerate(recs):
                expect_launches(f'{name} rank {r} step {i + 1}',
                                rec['launches'], want)
                if rec['tc'] != rec['launches']:
                    raise AssertionError(f'{name} rank {r}: CUDA-core '
                                         f'launches {rec}')
                for n in TC_KERNELS:
                    res['launches'][n] += rec['launches'][n]
            gap = abs(recs[0]['loss'] - base) / abs(base)
            if not gap <= MESH_BF16_TOL:
                raise AssertionError(f'{name} rank {r}: bf16 step-1 loss '
                                     f'{recs[0]["loss"]} vs one rank\'s '
                                     f'{base} ({gap:.3e} > '
                                     f'{MESH_BF16_TOL:g})')
            f32 = out['f32'][name]
            l32 = [s['loss'] for s in f32['steps']]
            if not abs(l32[0] - base32[0]) <= MESH_F32_TOL:
                raise AssertionError(f'{name} rank {r}: f32 step-1 loss '
                                     f'{l32[0]} vs {base32[0]}')
            if name == 'dp2_int8':
                # the int8 wire rounds the gradients: its curve is held
                # to the full-width one within the reference's bound
                if not abs(l32[1] - base32[1]) <= INT8_CURVE_TOL:
                    raise AssertionError(f'{name}: f32 step-2 loss '
                                         f'{l32[1]} vs {base32[1]}')
            elif not f32['param_err'] <= MESH_F32_TOL:
                raise AssertionError(f'{name} rank {r}: f32 parameters '
                                     f'after {MESH_STEPS} steps off by '
                                     f'{f32["param_err"]:.3e}')
            lay[r] = {'loss': [s['loss'] for s in recs],
                      'ms': [s['ms'] for s in recs],
                      'staged': recs[-1]['staged'], 'launches': want,
                      'bf16_loss_gap': gap, 'f32_losses': l32,
                      'f32_param_err': f32['param_err']}
            print(f'  {name} rank {r}: step ms '
                  f'{[round(s["ms"], 1) for s in recs]}, staged a step '
                  f'{recs[-1]["staged"]["bytes"]} B in '
                  f'{recs[-1]["staged"]["calls"]} calls, kernels 1-3 a '
                  f'step {want}; bf16 step-1 loss {recs[0]["loss"]:.6f} '
                  f'(one rank {base:.6f}, gap {gap:.2e} <= '
                  f'{MESH_BF16_TOL:g}); f32 losses '
                  f'{[round(x, 6) for x in l32]} (one rank '
                  f'{[round(x, 6) for x in base32]}), params off by '
                  f'{f32["param_err"]:.2e}', flush=True)
        res['layouts'][name] = lay
    return res


# ---------------------------------------------------------------------------
# phase 39: the MoE GPT's mesh step (dp2, ep2, mp2) and fp8 over dp2 / mp2,
# 2 ranks on the one card
# ---------------------------------------------------------------------------

MOE_MESH_LAYERS = 2        # MoEConfig()'s width at 2 of its 12 layers
MOE_MESH_LAYOUTS = [
    ('dp2', dict(dp=2), {}),
    ('ep2', dict(ep=2), {}),
    ('mp2', dict(mp=2), dict(mp=2)),
]
MOE_MESH_BF16_TOL = 1e-3   # step 1's loss against one rank's, relative
# f32 parameters after the steps against one rank's: dp and ep split the
# batch or the experts and sum the same products; mp also splits the
# products' sums (the CPU tests' tolerances)
MOE_MESH_F32_TOL = {'dp2': 1e-5, 'ep2': 1e-5, 'mp2': 1e-4}
FP8_MESH_LAYOUTS = [
    ('fp8_dp2', dict(dp=2), {}),
    ('fp8_mp2', dict(mp=2), dict(mp=2)),
]
# step 1's first qkv product's x and w scales and amaxes against one
# rank's, relative: their operands (the first LayerNorm's rows, the whole
# weight) are one rank's exactly, and the amaxes the global tensors' (each
# rank's reduced over the operand's ranks). Past it the layouts' bf16 sums
# in other orders feed e4m3 / e5m2 roundings (3 / 2 mantissa bits), which
# an input one bf16 ulp apart can move a step: the other products' states,
# the g roles and step 2's (which also carry step 1's gradients through
# AdamW's first, sign-like update) are printed; the CPU tests hold every
# one to the reference's in f32 (tests/test_torch_moe_parallel.py)
FP8_MESH_TOL = 2.0 ** -5


def moe_mesh_config(moe, dtype, **over):
    return moe.MoEConfig(num_layers=MOE_MESH_LAYERS, dtype=dtype, remat=True,
                         **over)


def moe_mesh_rank(tmp):
    """One rank's phase 39, in phase 38's ranks (``mesh_rank``): the MoE
    layouts in bf16 and in f32 (the f32 parameters after the steps,
    gathered, against the single rank's), then GPT fp8 over dp2 and mp2
    with each step's state. Writes moe_rank<r>.json in ``tmp``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models import moe_gpt as moe
    from paddle_tpu_torch.ops import flash_attention as fa
    rank = dist.get_rank()
    kernels = {n: getattr(fa, n) for n in TC_KERNELS}
    out = {'rank': rank, 'bf16': {}, 'f32': {}, 'fp8': {}}
    yard = torch.load(os.path.join(tmp, 'moe_single_f32.pt'),
                      map_location='cuda')
    for dtype, key in (('bfloat16', 'bf16'), ('float32', 'f32')):
        full = to_dev(moe.init_params(moe_mesh_config(moe, dtype),
                                      torch.Generator().manual_seed(0),
                                      'cpu'), 'cuda')
        toks, tgts = mesh_batch(full['wte'].shape[0])
        for name, deg, over in MOE_MESH_LAYOUTS:
            topo = dist.HybridTopology(**deg)
            cfg = moe_mesh_config(moe, dtype, **over)
            params = moe.place_params(full, cfg, topo.mesh)
            opt = topt.AdamW(learning_rate=MESH_LR, weight_decay=0.01,
                             **({'epsilon': MESH_F32_EPS} if key == 'f32'
                                else {}))
            state = opt.functional_init(params)
            step = moe.make_train_step(cfg, opt, topo.mesh)
            recs, params = mesh_steps(step, params, state, toks, tgts,
                                      kernels, topo.mesh)
            rec = {'steps': recs}
            if key == 'f32':
                rec['param_err'] = mesh_f32_err(
                    moe.gather_params(params, cfg, topo.mesh), yard)
            out[key][name] = rec
            del params, state, step
            torch.cuda.empty_cache()
        del full
        torch.cuda.empty_cache()
    fcfg = mesh_config(gpt, 'bfloat16', MESH_LAYERS, matmul_precision='fp8')
    full = mesh_params(gpt, fcfg)
    toks, tgts = mesh_batch(fcfg.vocab_size)
    for name, deg, over in FP8_MESH_LAYOUTS:
        topo = dist.HybridTopology(**deg)
        cfg = mesh_config(gpt, 'bfloat16', MESH_LAYERS,
                          matmul_precision='fp8', **over)
        params = gpt.place_params(full, cfg, topo.mesh)
        opt = topt.AdamW(learning_rate=MESH_LR, weight_decay=0.01)
        state = opt.functional_init(params)
        step = gpt.make_train_step(cfg, opt, topo.mesh)
        recs, params = mesh_steps(step, params, state, toks, tgts, kernels,
                                  topo.mesh, gpt.init_fp8_state(cfg, 'cuda'))
        out['fp8'][name] = {'steps': recs}
        del params, state, step
        torch.cuda.empty_cache()
    write_file(os.path.join(tmp, f'moe_rank{rank}.json'), json.dumps(out))


def fp8_state_gap(got, want, roles='xwg'):
    """The largest relative gap of two fp8 states (lists) over every
    matmul, role of ``roles``, scale and amax history: max |a - b| / max
    |b| a tensor."""
    gap = 0.0
    for n, meta in want.items():
        for r, m in meta.items():
            if r not in roles:
                continue
            for k, w in m.items():
                a = torch.tensor(got[n][r][k])
                b = torch.tensor(w)
                gap = max(gap, rel_err(a, b))
    return gap


def phase_moe_mesh(kernels, card, ranks38):
    """Phase 39 (see the module docstring): one rank's MoE steps here in
    bf16 and f32 and GPT's fp8 steps, then phase 38's 2 ranks on the one
    card over gloo (``ranks38``: their context and directory): the MoE
    step over dp2, ep2 and mp2 and GPT fp8 over dp2 and mp2, each against
    the single rank."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models import moe_gpt as moe
    torch.cuda.empty_cache()
    L = MOE_MESH_LAYERS
    want = {'flash_fwd': 2 * L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L}
    want8 = mesh_launches_want({}, 0, MESH_LAYERS)
    ctx, tmp = ranks38
    single = {}
    try:
        for dtype, key in (('bfloat16', 'bf16'), ('float32', 'f32')):
            cfg = moe_mesh_config(moe, dtype)
            params = to_dev(moe.init_params(
                cfg, torch.Generator().manual_seed(0), 'cpu'), 'cuda')
            opt = topt.AdamW(learning_rate=MESH_LR, weight_decay=0.01,
                             **({'epsilon': MESH_F32_EPS} if key == 'f32'
                                else {}))
            state = opt.functional_init(params)
            toks, tgts = mesh_batch(cfg.vocab_size)
            recs, params = mesh_steps(moe.make_train_step(cfg, opt), params,
                                      state, toks, tgts, kernels)
            single[key] = recs
            if key == 'bf16':
                expect_launches('MoE single rank, a step',
                                recs[-1]['launches'], want)
            else:
                torch.save(to_dev(params, 'cpu'),
                           os.path.join(tmp, 'moe_single_f32.pt'))
            print(f'  MoE single rank {key} ({L} layers): losses '
                  f'{[round(r["loss"], 6) for r in recs]}, step ms '
                  f'{[round(r["ms"], 1) for r in recs]}', flush=True)
            del params, state
            torch.cuda.empty_cache()
        fcfg = mesh_config(gpt, 'bfloat16', MESH_LAYERS,
                           matmul_precision='fp8')
        params = mesh_params(gpt, fcfg)
        opt = topt.AdamW(learning_rate=MESH_LR, weight_decay=0.01)
        toks, tgts = mesh_batch(fcfg.vocab_size)
        single['fp8'], _ = mesh_steps(
            gpt.make_train_step(fcfg, opt), params,
            opt.functional_init(params), toks, tgts, kernels, None,
            gpt.init_fp8_state(fcfg, 'cuda'))
        expect_launches('GPT fp8 single rank, a step',
                        single['fp8'][-1]['launches'], want8)
        print(f'  GPT fp8 single rank ({MESH_LAYERS} layers): losses '
              f'{[round(r["loss"], 6) for r in single["fp8"]]}, step ms '
              f'{[round(r["ms"], 1) for r in single["fp8"]]}', flush=True)
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        write_file(os.path.join(tmp, 'next'), 'go')
        ctx.join()
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f'moe_rank{r}.json')) as f:
                ranks.append(json.load(f))
    finally:
        stop_ranks(ctx, tmp)
    res = {'single': single, 'ranks_s': ranks_s, 'layouts': {},
           'launches': {n: 0 for n in TC_KERNELS}}
    print(f'  phase 38\'s 2 ranks on {card!r} (gloo): {ranks_s:.1f} s for '
          f'both runs', flush=True)
    base, base32 = single['bf16'][0]['loss'], single['f32'][0]['loss']
    layouts = ([(n, 'moe', want) for n, _, _ in MOE_MESH_LAYOUTS]
               + [(n, 'fp8', want8) for n, _, _ in FP8_MESH_LAYOUTS])
    for name, kind, per_step in layouts:
        lay = {}
        recs_of = [out['bf16' if kind == 'moe' else 'fp8'][name]['steps']
                   for out in ranks]
        ref = single['bf16' if kind == 'moe' else 'fp8']
        for r, recs in enumerate(recs_of):
            for i, rec in enumerate(recs):
                expect_launches(f'{name} rank {r} step {i + 1}',
                                rec['launches'], per_step)
                if rec['tc'] != rec['launches']:
                    raise AssertionError(f'{name} rank {r}: CUDA-core '
                                         f'launches {rec}')
                for n in TC_KERNELS:
                    res['launches'][n] += rec['launches'][n]
            gap = abs(recs[0]['loss'] - ref[0]['loss']) / abs(ref[0]['loss'])
            if not gap <= MOE_MESH_BF16_TOL:
                raise AssertionError(f'{name} rank {r}: step-1 loss '
                                     f'{recs[0]["loss"]} vs one rank\'s '
                                     f'{ref[0]["loss"]} ({gap:.3e})')
            rec = {'loss': [s['loss'] for s in recs],
                   'ms': [s['ms'] for s in recs],
                   'staged': recs[-1]['staged'], 'launches': per_step,
                   'loss_gap': gap}
            if kind == 'moe':
                f32 = ranks[r]['f32'][name]
                l32 = [s['loss'] for s in f32['steps']]
                if not (abs(l32[0] - base32) <= MOE_MESH_F32_TOL[name]
                        * abs(base32)
                        and f32['param_err'] <= MOE_MESH_F32_TOL[name]):
                    raise AssertionError(
                        f'{name} rank {r}: f32 losses {l32} vs '
                        f'{base32}, parameters off by {f32["param_err"]:.3e}'
                        f' (tol {MOE_MESH_F32_TOL[name]:g})')
                rec.update(f32_losses=l32, f32_param_err=f32['param_err'])
                tail = (f'f32 params off by {f32["param_err"]:.2e} (tol '
                        f'{MOE_MESH_F32_TOL[name]:g})')
            else:
                states = [[s['fp8'] for s in rr] for rr in recs_of]
                if states[r] != states[0]:
                    raise AssertionError(f'{name}: the ranks\' fp8 states '
                                         f'differ')
                xw = fp8_state_gap(
                    {'qkv': {k: {q: v[:1] for q, v in m.items()}
                             for k, m in states[r][0]['qkv'].items()}},
                    {'qkv': {k: {q: v[:1] for q, v in m.items()}
                             for k, m in ref[0]['fp8']['qkv'].items()}},
                    'xw')
                sgap = [fp8_state_gap(g, w['fp8'])
                        for g, w in zip(states[r], ref)]
                if not xw <= FP8_MESH_TOL:
                    raise AssertionError(f'{name} rank {r}: step 1\'s first '
                                         f'qkv x / w state vs one rank\'s '
                                         f'off by {xw:.3e}')
                rec['fp8_state_gap'] = {'step1_qkv0_xw': xw,
                                        'steps_all': sgap}
                tail = (f'fp8 scales and histories equal on both ranks; '
                        f'from one rank\'s: step 1\'s first qkv x, w '
                        f'{xw:.2e} (tol {FP8_MESH_TOL:g}); every product '
                        f'and role, steps 1 and 2: {sgap[0]:.2e}, '
                        f'{sgap[1]:.2e} (printed)')
            lay[r] = rec
            print(f'  {name} rank {r}: step ms '
                  f'{[round(s["ms"], 1) for s in recs]}, staged a step '
                  f'{recs[-1]["staged"]["bytes"]} B in '
                  f'{recs[-1]["staged"]["calls"]} calls, kernels 1-3 a step '
                  f'{per_step} (tensor-core); step-1 loss '
                  f'{recs[0]["loss"]:.6f} (one rank {ref[0]["loss"]:.6f}, '
                  f'gap {gap:.2e} <= {MOE_MESH_BF16_TOL:g}); {tail}',
                  flush=True)
        res['layouts'][name] = lay
    return res


# ---------------------------------------------------------------------------
# phase 40: mesh-sharded serving, a virtual mesh of 2 shards on the card
# ---------------------------------------------------------------------------

MESH_SERVE_MP = 2
# the mp=2 engine's prefill and step logits against mp=1's, bf16 at full
# width: max |mp2 - mp1| over max |mp1| (the row-parallel partials are
# rounded to bf16 before they are summed)
MESH_SERVE_TOL = 2.0 ** -5


def mesh_logits_gaps(GenerationEngine, params, cfg, ctx, reqs):
    """Each of 8 requests prefilled into its own slot's pages (the
    engine's width, ``valid`` its length), then one step over the 8 slots
    on the mp=1 prefills' greedy tokens, through an mp=1 engine's forward
    and through the mesh engine's (``ctx``) on the same inputs, eager.
    -> (prefill gap, step gap), each max |mp2 - mp1| / max |mp1| over
    every slot's logits."""
    dev = torch.device('cuda')
    i32 = dict(dtype=torch.int32, device=dev)
    out, nxt = [], None
    for kw in ({'device': 'cuda'}, {'mesh': ctx}):
        eng = GenerationEngine(params, cfg, num_slots=8, page_size=128,
                               autostart=False, **kw)
        try:
            table = (1 + torch.arange(8 * eng.p_max, **i32)).reshape(8, -1)
            pool = {'k': eng._pool['k'], 'v': eng._pool['v']}
            pre = []
            with torch.no_grad():
                for i, r in enumerate(reqs):
                    tok = torch.zeros(1, eng.prefill_width, **i32)
                    tok[0, :len(r)] = torch.as_tensor(r, **i32)
                    lg, _ = eng._forward_fn(
                        eng._params, tok,
                        dict(pool, page_table=table[i:i + 1],
                             valid=torch.tensor([len(r)], **i32)),
                        torch.zeros(1, **i32), cfg, last_only=True)
                    pre.append(lg[:, 0].float())
                pre = torch.cat(pre)
                if nxt is None:
                    nxt = pre.argmax(-1).to(torch.int32)
                pos = torch.tensor([len(r) for r in reqs], **i32)
                lg, _ = eng._forward_fn(eng._params, nxt[:, None],
                                        dict(pool, page_table=table), pos,
                                        cfg)
            out.append((pre, lg[:, 0].float()))
        finally:
            eng.shutdown()
    return tuple(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(out[1], out[0]))


def phase_mesh_serving(gpt, GenerationEngine, kernels, card, mp1):
    """Phase 40 (see the module docstring). ``mp1``: phase 4's and 9's
    captured mp=1 records, printed beside."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, serving
    from paddle_tpu_torch.parallel import mesh_engine
    n = MESH_SERVE_MP
    devs = ['cuda:0'] * n

    def virtual():
        # a fresh context an engine: it records its placement's fallbacks
        return mesh_engine.MeshContext.build(n, devices=devs)
    res = {}
    # (a) f32 at 2 layers: mp=2 against mp=1, greedy
    cfg = bench_config(gpt, num_layers=2, dtype='float32')
    params = gpt.init_params(cfg, torch.Generator().manual_seed(1), 'cpu')
    reqs = prompts(4, 16, 200, cfg.vocab_size, seed=1)
    streams, stats = {}, {}
    for mp in (1, n):
        eng = GenerationEngine(params, cfg, num_slots=8, page_size=128,
                               **({'mesh': virtual()} if mp > 1
                                  else {'device': 'cuda'}))
        try:
            eng.warmup()
            streams[mp], _ = serve(eng, reqs, 8)
            stats[mp] = eng.stats()
        finally:
            eng.shutdown()
    same = streams[1] == streams[n]
    traces = [stats[m]['traces'] for m in (1, n)]
    print(f'  f32, 2 layers: mp={n} greedy streams against mp=1 '
          f'({len(reqs)} requests x 8 tokens): '
          f'{"equal" if same else "DIFFERENT"}; captures {traces}; mesh '
          f'{stats[n]["mesh"]}', flush=True)
    if not same or traces != [2, 2]:
        raise AssertionError(f'mp={n} f32 streams {streams[n]} vs '
                             f'{streams[1]}, captures {traces}')
    res['f32'] = {'streams_equal': same, 'traces': traces}
    del params
    # (b) the bench GPT at full width, bf16 and int8 pools, mp=2
    full = bench_config(gpt)
    params = gpt.init_params(full, torch.Generator(device='cuda')
                             .manual_seed(0), 'cuda')
    reqs = prompts(8, 16, 400, full.vocab_size, seed=0)
    for pool, kname, over, base in (
            ('bf16', 'paged_decode', {}, mp1['bf16']),
            ('int8', 'paged_decode_int8', dict(kv_cache_int8=True),
             mp1['int8'])):
        gaps = mesh_logits_gaps(GenerationEngine, params,
                                bench_config(gpt, **over), virtual(), reqs)
        print(f'  mp={n} against mp=1, {pool} pool, the same inputs: '
              f'prefill logits {gaps[0]:.2e}, step logits {gaps[1]:.2e} '
              f'of max |logits| (tol {MESH_SERVE_TOL:g})', flush=True)
        if max(gaps) > MESH_SERVE_TOL:
            raise AssertionError(f'mp={n} {pool} pool: logits gaps {gaps} '
                                 f'> {MESH_SERVE_TOL}')
        run, _ = engine_run(GenerationEngine, params,
                            bench_config(gpt, **over), kname, kernels, reqs,
                            32, True, card, f'mp={n} engine, {pool} pool',
                            shards=n, mesh=virtual())
        res[pool] = {k: run[k] for k in (
            'tokens_per_s', 'ttft_ms_p50', 'step_ms_mean', 'prefill_ms_mean',
            'prefills', 'steps', 'launches', 'instances', 'traces',
            'kernel_device_ms')}
        res[pool]['logits_gap'] = {'prefill': gaps[0], 'step': gaps[1]}
        res[pool]['mp1'] = {k: base[k] for k in (
            'tokens_per_s', 'ttft_ms_p50', 'step_ms_mean')}
        print(f'    beside mp=1 (phase {4 if pool == "bf16" else 9}): '
              f'{base["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
              f'{base["ttft_ms_p50"]:.1f} ms, mean step '
              f'{base["step_ms_mean"]:.2f} ms', flush=True)
    del params
    torch.cuda.empty_cache()
    # (c) an InferenceEngine over the mesh, and a host's deploy(mp=2)
    prev = paddle.device._current
    try:
        paddle.set_device('gpu')
        paddle.seed(0)
        net = nn.Sequential(nn.Linear(256, 1024), nn.GELU(),
                            nn.Linear(1024, 256))
        x = np.random.RandomState(2).randn(5, 256).astype('float32')
        e1 = serving.InferenceEngine(net, max_batch_size=8)
        y1 = np.asarray(e1.submit(x).result(timeout=120))
        e1.shutdown()
        e2 = serving.sharded_inference_engine(net, mp=n, devices=devs,
                                              max_batch_size=8)
        try:
            y2 = np.asarray(e2.submit(x).result(timeout=120))
            inf_mesh = e2.stats()['mesh']
        finally:
            e2.shutdown()
    finally:
        paddle.device._current = prev
    inf_err = float(np.abs(y1 - y2).max())
    small = bench_config(gpt, num_layers=2, hidden_size=256, num_heads=4)
    sp = gpt.init_params(small, torch.Generator(device='cuda')
                         .manual_seed(4), 'cuda')

    def factory(mp):
        return serving.sharded_generation_engine(
            sp, small, mp=mp, devices=['cuda:0'] * mp, num_slots=2,
            page_size=128, prefill_width=256)

    with serving.ModelHost(name='mesh40') as host:
        m = host.deploy('gpt_mp2', factory, mp=n)
        toks = host.submit('gpt_mp2', [1, 2, 3], max_new_tokens=4).result(
            timeout=120)
        eng = host._models['gpt_mp2'].engine
        host_rec = {'footprint_bytes': m.footprint_bytes,
                    'mesh_size': mesh_engine.mesh_size(eng),
                    'traces': eng._trace_count, 'tokens': len(toks)}
    print(f'  sharded_inference_engine (mp={n}, an MLP 256-1024-256, 5 rows):'
          f' {inf_err:.2e} from the mp=1 engine, mesh {inf_mesh}; '
          f'ModelHost.deploy(mp={n}) of a 2-layer GPT (hidden 256): footprint'
          f' {host_rec["footprint_bytes"]} B on its device, mesh size '
          f'{host_rec["mesh_size"]}, captures {host_rec["traces"]}, '
          f'{host_rec["tokens"]} tokens', flush=True)
    if not (inf_err == 0.0 and inf_mesh['mp'] == n
            and host_rec['mesh_size'] == n and host_rec['traces'] == 2
            and host_rec['tokens'] == 4):
        raise AssertionError(f'phase 40 (c): {inf_err}, {inf_mesh}, '
                             f'{host_rec}')
    res['inference'] = {'max_abs_err': inf_err, 'mesh': inf_mesh}
    res['host'] = host_rec
    return res


class PhaseClock:
    """``with phase(n, title):`` prints the phase's title as it starts and
    its wall seconds on a line of their own as it ends, and keeps them in
    ``seconds`` (phase number -> seconds) for the report."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, n, title):
        print(f'phase {n}: {title}', flush=True)
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            secs = time.perf_counter() - t0
            self.seconds[str(n)] = secs
            print(f'phase {n}: {secs:.1f} s' + ('' if ok else ', failed'),
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--report', default=None,
                    help='also write the full report (JSON) to this path')
    ap.add_argument('--warmup-child', choices=('cold', 'warm'),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument('--dir', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.warmup_child:
        # one process of phase 31's cold-start check
        if not torch.cuda.is_available():
            return 2
        warmup_child(args.warmup_child, args.dir)
        return 0

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    # the port itself: absent when this script stands alone
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models import moe_gpt as moe
    from paddle_tpu_torch.io import native_loader
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import nms as nms_mod
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.serving import GenerationEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {'paged_decode': pa.paged_flash_decode,
                'paged_decode_int8': pa.paged_flash_decode_int8,
                'flash_decode': fa.flash_decode,
                'flash_decode_int8': fa.flash_decode_int8,
                'flash_fwd': fa.flash_fwd,
                'flash_bwd_dq': fa.flash_bwd_dq,
                'flash_bwd_dkv': fa.flash_bwd_dkv,
                'nms_static': nms_mod.nms_static_cuda}

    t_start = time.perf_counter()
    phase = PhaseClock()
    with phase(1, 'the card'):
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        print(f'  card {card!r}; torch {torch.__version__} cuda '
              f'{torch.version.cuda}; device {kind!r} x {count}', flush=True)

    report = {'card': card, 'phase_seconds': phase.seconds}
    with phase(2, 'build the kernels and the native DataLoader pool'):
        t0 = time.perf_counter()
        # the DataLoader's native pool (g++) builds beside the nvcc builds
        pool = threading.Thread(target=native_loader.get_lib)
        pool.start()
        _build.build(SOURCES)
        pool.join(timeout=600)
        native_loader.get_lib()        # raises if the pool's build failed
        secs = time.perf_counter() - t0
        print(f'  built {", ".join(SOURCES)} (nvcc sm_90a, in parallel) and '
              f'the native DataLoader pool '
              f'({native_loader.lib_path().name}, g++) in {secs:.1f} s',
              flush=True)
        for name in SOURCES:
            log = _build.build_log[name]
            print(f'  {name}: nvcc {log["seconds"]:.1f} s', flush=True)
            for line in log['ptxas'].splitlines():
                if 'registers' in line or 'spill' in line:
                    print(f'    ptxas: {line.strip()}', flush=True)
        report['build_s'] = secs
    with phase(3, 'kernels against their plain twins on the card'):
        report['kernel'] = kr = kernel_cases(pa, TIMED_ITERS)
        report['dense_kernels'] = dk = dense_kernel_cases(fa, pa,
                                                          TIMED_ITERS)
        report['bwd_kernels'] = bk = bwd_kernel_cases(fa, TIMED_ITERS)
        for kname, recs in ring_bwd_cases(fa, TIMED_ITERS).items():
            bk[kname].update(recs)
    with phase(4, 'GenerationEngine at full width'):
        report['engine'] = phase_engine(gpt, GenerationEngine, counters,
                                        card)
    with phase(5, 'card against CPU at 2 layers'):
        report['card_vs_cpu'] = phase_card_vs_cpu(gpt, GenerationEngine)
    with phase(6, 'dense generate() at full width'):
        model, report['generate'] = phase_generate(gpt, counters, card)
    with phase(7, 'forward() and the sliding window at full width'):
        report['forward'] = phase_forward_sliding(gpt, model, counters,
                                                  card)
        del model
        torch.cuda.empty_cache()
    with phase(8, 'generate() card against CPU at 2 layers'):
        report['generate_card_vs_cpu'] = phase_generate_card_vs_cpu(gpt)
    with phase(9, 'GenerationEngine over the int8 page pool at full width'):
        report['engine_int8'] = phase_engine_int8(gpt, GenerationEngine,
                                                  counters, card)
    with phase(10, 'int8 engine card against CPU at 2 layers'):
        report['engine_int8_card_vs_cpu'] = phase_engine_int8_card_vs_cpu(
            gpt, GenerationEngine)
    with phase(11, 'the train step at full width'):
        report['train'] = phase_train(gpt, topt, counters, card)
    with phase(12, 'the train step card against CPU at 2 layers'):
        report['train_card_vs_cpu'] = phase_train_card_vs_cpu(gpt, topt)
    with phase(13, 'GenerationEngine(precision=\'int8_wo\') at full width'):
        report['engine_int8_wo'] = phase_engine_int8_wo(
            gpt, GenerationEngine, counters, card, report['engine'])
    with phase(14, 'generate() over int8 weights (enable_int8_decode) at '
                   'full width'):
        report['generate_int8_wo'] = phase_generate_int8_wo(gpt, counters,
                                                            card)
    with phase(15, 'the prefix cache at full width'):
        report['prefix'] = phase_prefix_cache(gpt, GenerationEngine,
                                              counters, card)
    with phase(16, 'int8 weights and the prefix cache, card against CPU at '
                   '2 layers'):
        report['slice_card_vs_cpu'] = phase_slice_card_vs_cpu(
            gpt, GenerationEngine)
    with phase(17, f'MoE serving at full width, {MOE_SERVE_LAYERS} layers '
                   '(GenerationEngine and generate())'):
        report['moe_serving'] = phase_moe_serving(moe, GenerationEngine,
                                                  counters, card)
    with phase(18, 'the MoE train step at full width'):
        report['moe_train'] = phase_moe_train(moe, topt, counters, card)
    with phase(19, 'MoE card against CPU at 2 layers'):
        report['moe_card_vs_cpu'] = phase_moe_card_vs_cpu(
            moe, GenerationEngine, topt)
    with phase(20, 'the eager Paddle API on the card'):
        report['eager'] = phase_eager(card)
    with phase(21, 'fp8_matmul (torch._scaled_mm) against its twin at the '
                   'bench GPT\'s products'):
        report['fp8_matmul'] = phase_fp8_matmul(card)
    with phase(22, f'the fp8 train rung at full width, {FP8_RUNG_LAYERS} '
                   'layers'):
        report['fp8_train'] = phase_fp8_train(gpt, topt, counters, card)
    with phase(23, f'the MoE fp8 train step at full width, '
                   f'{MOE_FP8_LAYERS} layers'):
        report['moe_fp8_train'] = phase_moe_fp8_train(moe, topt, counters,
                                                      card)
    with phase(24, 'fp8 training card against CPU at 2 layers, and amp'):
        report['fp8_card_vs_cpu'] = phase_fp8_card_vs_cpu(gpt, moe, topt)
    with phase(25, 'the ERNIE-base masked-LM program (paddle.nn, '
                   'opt.step()) at full width'):
        report['ernie_train'] = phase_ernie_train(counters, card)
    with phase(26, 'the ERNIE program and the nn case table, card against '
                   'CPU'):
        report['ernie_card_vs_cpu'] = phase_ernie_card_vs_cpu()
    with phase(27, 'hapi Model.fit / evaluate / predict of the ERNIE '
                   'program at full width, fed by paddle.io'):
        report['hapi'] = phase_hapi(counters, card,
                                    report['ernie_train']['step_ms'])
    with phase(28, 'hapi card against CPU, and checkpoints across devices'):
        report['hapi_card_vs_cpu'] = phase_hapi_card_vs_cpu()
    with phase(29, 'ResNet-50 through hapi Model.fit at full width'):
        report['resnet_hapi'] = phase_resnet_hapi(counters, card)
    with phase(30, 'conv, pooling, RNN, decoding, quantization and the '
                   'vision models, card against CPU'):
        report['vision_card_vs_cpu'] = phase_vision_card_vs_cpu()
    with phase(31, 'ERNIE-base served: InferenceEngine, the Predictor '
                   '(attach_layer and layer-free over jit.save\'s program), '
                   'the bench rungs and the cold start'):
        report['ernie_serving'], served = phase_ernie_serving(counters,
                                                              card)
    with phase(32, 'ERNIE-base pretrained (pretrain_loss, [8, 512])'):
        report['ernie_pretrain'] = phase_ernie_pretrain(counters, card)
    with phase(33, 'ERNIE serving and pretraining, card against CPU'):
        report['ernie_serving_card_vs_cpu'], tl_launches = \
            phase_ernie_serving_card_vs_cpu(counters)
        report['ernie_serving_card_vs_cpu']['translated_launches'] = \
            tl_launches
    with phase(34, 'the telemetry plane on the card: ERNIE-base served, '
                   'scraped and profiled live; hapi fit with telemetry'):
        report['telemetry'] = phase_telemetry(
            counters, card, served, report['ernie_serving']['busy_share'])
    with phase(35, 'the control planes on the card: the bench GPT over two '
                   'replicas through failover and warm scale-up, a model '
                   'host\'s LRU swap-in, the fleet plane'):
        report['control_planes'] = cp = phase_control_planes(counters, card,
                                                             served)
        del served
    with phase(36, 'detection and OCR at full width: PP-YOLOE trained and '
                   'served through jit.save with NMS as one operator, the '
                   'NMS kernel against its twin, SVTR-lite and CRNN'):
        report['detection'] = det = phase_detection_ocr(counters, card)
    with phase(37, 'detection and OCR, the vision ops and NMS, card against '
                   'CPU'):
        report['detection_card_vs_cpu'] = phase_detection_card_vs_cpu()
    with phase(38, 'the hybrid-parallel train step: 2 ranks on the card '
                   '(dp2, dp2 int8, mp2, sp2 ring, pp2 GPipe and 1F1B) '
                   'against one rank'):
        report['mesh_train'], ranks38 = phase_mesh_train(counters, card)
        mt38 = report['mesh_train']
    with phase(39, 'the MoE GPT\'s mesh step (dp2, ep2, mp2) and GPT fp8 '
                   'over dp2 and mp2: phase 38\'s 2 ranks on the card '
                   'against one'):
        report['moe_mesh'] = mt39 = phase_moe_mesh(counters, card, ranks38)
    with phase(40, f'mesh-sharded serving: GenerationEngine(mp='
                   f'{MESH_SERVE_MP}) on a virtual mesh of the card, '
                   f'sharded_inference_engine, ModelHost.deploy(mp='
                   f'{MESH_SERVE_MP})'):
        report['mesh_serving'] = ms40 = phase_mesh_serving(
            gpt, GenerationEngine, counters, card,
            {'bf16': report['engine'], 'int8': report['engine_int8']})

    gen, fwd = report['generate'], report['forward']
    train = report['train']['launches']
    wo, gwo = report['engine_int8_wo'], report['generate_int8_wo']
    pfx = report['prefix']
    ms, mt = report['moe_serving'], report['moe_train']['launches']
    # kernels 1-3's other training runs: the fp8 rung, MoE fp8, ERNIE, and
    # hapi's fit, evaluate and predicts
    es = report['ernie_serving']
    f8t = [report['fp8_train']['none']['launches'],
           report['fp8_train']['fp8']['launches'],
           report['moe_fp8_train']['launches'],
           report['ernie_train']['launches'],
           report['hapi']['launches'],
           # this slice: the engine's traffic, the Predictor's, the
           # layer-free program's, pretraining, the TranslatedLayer step
           es['launches'], es['predictor']['launches'],
           {'flash_fwd': es['layer_free']['launches']},
           report['ernie_pretrain']['launches'], tl_launches,
           # phase 34: the engine's traffic under the telemetry plane
           report['telemetry']['launches'],
           # phase 35: the host's ERNIE model (its warm-up and batch)
           {'flash_fwd': cp['host']['launches']['flash_fwd']}]
    main_path = {
        'paged_decode': report['engine']['launches']
        + wo['bf16_pool']['launches'] + pfx['bf16']['launches']
        + ms['bf16 pool']['launches'] + ms['int8_wo']['launches']
        # phase 35: the fleet, its failover, the scale-up and the host
        + cp['fleet']['launches'] + cp['failover']['launches']
        + cp['scale_up']['launches'] + cp['scale_up']['beside']['launches']
        + cp['host']['launches']['paged_decode']
        # phase 40: the mp=2 engine, every shard's launches
        + ms40['bf16']['launches'],
        'paged_decode_int8': report['engine_int8']['launches']
        + wo['int8_pool']['launches'] + pfx['int8']['launches']
        + ms['int8 pool']['launches'] + ms40['int8']['launches'],
        'flash_decode': gen['bf16']['launches']
        + fwd['launches']['flash_decode'] + gwo['bf16']['launches']
        + gwo['window']['launches']['flash_decode']
        + ms['generate bf16 cache']['launches'],
        'flash_decode_int8': gen['int8']['launches']
        + gwo['int8']['launches'] + ms['generate int8 cache']['launches'],
        'flash_fwd': fwd['forward_launches']['flash_fwd']
        + fwd['launches']['flash_fwd'] + train['flash_fwd']
        + gwo['window']['launches']['flash_fwd'] + mt['flash_fwd']
        + sum(r['flash_fwd'] for r in f8t)
        # phases 38-39: both ranks' steps of every bf16 layout
        + mt38['launches']['flash_fwd'] + mt39['launches']['flash_fwd'],
        'flash_bwd_dq': train['flash_bwd_dq'] + mt['flash_bwd_dq']
        + sum(r.get('flash_bwd_dq', 0) for r in f8t)
        + mt38['launches']['flash_bwd_dq'] + mt39['launches']['flash_bwd_dq'],
        'flash_bwd_dkv': train['flash_bwd_dkv'] + mt['flash_bwd_dkv']
        + sum(r.get('flash_bwd_dkv', 0) for r in f8t)
        + mt38['launches']['flash_bwd_dkv']
        + mt39['launches']['flash_bwd_dkv'],
    }
    timed_shape = {'paged_decode': 'decode_T1',
                   'paged_decode_int8': 'decode_T1',
                   'flash_decode': 'decode_T1',
                   'flash_decode_int8': 'decode_T1_int8',
                   'flash_fwd': 'fwd_S1024', 'flash_bwd_dq': 'bwd_S1024',
                   'flash_bwd_dkv': 'bwd_S1024'}
    main_path['nms_static'] = det['launches']
    cases = dict(dk, **kr, **bk, nms_static={
        f'nms_{k}': v for k, v in det['nms'].items()})
    timed_shape['nms_static'] = 'nms_served_8400'
    kernels = []
    for name in SOURCE_OF:
        recs = cases[name]
        main_rec = recs[timed_shape[name]]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': SOURCE_OF[name],
            'replaces': REPLACES[name],
            'launches': main_path[name],
            'max_abs_err': max(r['max_abs_err'] for r in recs.values()),
            'ms': main_rec['ms'], 'plain_ms': main_rec['plain_ms'],
            'bound_ms': main_rec['bound_ms'],
            'bound_by': main_rec['bound_by'],
            'library_ms': main_rec['library_ms'],
            'shapes': {k: v for k, v in recs.items() if 'ms' in v},
        })
    report['seconds'] = time.perf_counter() - t_start
    print(f'phases: {len(phase.seconds)} in {report["seconds"]:.1f} s '
          f'(longest: ' + ', '.join(
              f'{n} {s:.1f} s' for n, s in sorted(
                  phase.seconds.items(), key=lambda kv: -kv[1])[:8]) + ')',
          flush=True)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': kind, 'count': count}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
