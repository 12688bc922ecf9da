#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero before the last line):
  1. device   — a CUDA device must be present; prints nvidia-smi's name
                and power limit.
  2. build    — compiles every kernel source (mxnet_tpu_torch/ops/csrc/)
                at once, one nvcc per source, and prints each build's
                seconds and ptxas register and spill counts.
  3. kernels  — holds each kernel against its plain PyTorch version on the
                card at the main paths' shapes (and, for the paged kernel,
                the edges of its cluster split and query tile over every
                pool type, PAGED_EDGE_CASES; for its int8 variant, q
                float32 and bfloat16 over an int8 pool at the decode,
                prefill-chunk and spec-score shapes; for flash attention,
                ragged, head_dim 128 and non-causal cases), checks that
                the paged kernel and both flash directions repeat bit for
                bit, and times the kernel, the plain version, one library
                call as a yardstick (naming the kernels SDPA's forward
                and backward run), and the least time the card could take
                (bound; for flash attention also over the split-TF32 rate
                its float32 products run at). The attention rows are
                timed with and without the card asleep while the host
                enqueues the call.
  4. serving main path — serves the transformer LM at the full width of
                the repo's serving benchmark config (vocab 8192, d_model
                512, 4 heads x 128, 4 layers, d_ff 2048, max_len 1024;
                random weights from a numpy seed) through `serving.serve(
                ..., paged=True)`: 8 concurrent in-process requests plus
                one HTTP POST /v1/generate, 64-token prompts, 128 new
                tokens each. Checks every result, the engine-failure
                count, the kernel's launch count, and the greedy tokens
                against the port's own gather path on the card. Then
                profiles 16 steady paged decode steps on a fresh engine
                and checks its tokens against the same gather path.
  5. training main path — trains the transformer LM at the full width of
                the repo's flash-attention training benchmark
                (bench.py's non-smoke `bench_transformer_flash`: vocab
                8192, d_model 512, 8 heads x 64, 6 layers, d_ff 2048,
                max_len 1024; batch 8 x 1024 tokens from numpy seed 0, SGD
                at lr 0.1) with MXNET_FLASH_ATTENTION=1 through
                `make_transformer_train_step`: first the first step's loss
                and every gradient against the same step with the flag
                off, then one warm-up and 10 timed steps (finite, falling
                loss; both flash kernels launched n_layers times a step),
                then a profiled step.
  6. quantized serving path — `serving.serve(..., kv_quant=True,
                weight_quant="int8", paged=True, block_size=32)` at phase
                4's config and traffic (8 in-process requests + 1 HTTP,
                64-token prompts, 128 new tokens): the int8 KV pool read
                by the paged kernel's int8 variant, int8 weights. Checks
                results, failures, int8 launches = n_layers x (decode
                steps + prefill chunks) and no float launch, greedy
                tokens against the float paged engine up to each
                request's first near-tie (top-2 margin under 0.1), and a
                teacher-forced logit probe of one request against the
                float engine; then profiles 16 quantized decode steps.
  7. spec + prefix path — a server with a 2-layer self-draft
                (`spec_k=3`) and the prefix cache: 8 sequential requests
                sharing a 272-token prefix (off the 32-token block
                boundary, so every later request copies-on-write the
                part-shared block), each with its own 32-token suffix, 64
                new tokens. Run over the float pool first, its tokens
                held to the float paged engine's at phase 4's margin,
                then over the int8 pool with int8 weights, held as in
                phase 6. Each run checks spec passes, prefix hits, COW
                copies >= 7, and its kernel variant's launches = n_layers
                x (plain decode steps + prefill chunks + spec passes).
                Then profiles 8 speculative steps over the int8 pool.
  8. fused BatchNorm kernels — K3a-d (stats, apply, backward reduce,
                backward dx) against their plain versions, float32 and
                bfloat16, at each of the 13 BatchNorm shapes and epilogue
                variants of a batch-256 ResNet-50 v1 step, the variant
                the network does not use, and two ragged shapes (C=3 with
                an odd S; S=1) in all four variants; in float32 also at
                batch 128, phase 14's, each of those 13 variants and the
                plain BatchNorm (the hybridized graph's) at all 9
                shapes; then each kernel
                timed beside its plain version, its bound and the library
                yardsticks (the one call that computes its function where
                there is one: torch.var_mean, torch.batch_norm_elemt,
                torch.batch_norm_backward_reduce and
                torch.batch_norm_backward_elemt; cuDNN batch norm forward
                and backward for the kernel pairs) at the step's shapes
                in bfloat16, one row a shape and kernel, summed over the
                step's 53 calls.
  9. ResNet-50 training path — the framework core (NDArray, autograd,
                Gluon, TrainStep) trains the model zoo's resnet50_v1 at
                bench.py's non-smoke bench_resnet50 config (1000 classes,
                batch 256, 224x224 NCHW, Xavier weights, RandomState(0)
                inputs, SGD lr 0.05 momentum 0.9 wd 1e-4) with
                MXNET_FUSED_BN_EPILOGUE=1: the first step's loss and
                gradients in float32 against the flag off, beside the
                flag-off step's own floor; one warm-up and 10 timed
                bfloat16 steps (finite, falling loss, K3a-d launched 53
                times a step each); the same steps with the flag off for
                comparison (no launch); a profiled step.
  10. fused RNN kernels — K4a (the persistent forward scan) and K4b (the
                reverse-time backward scan with dWh) against their plain
                versions, float32 and bfloat16, lstm, rnn_relu and
                rnn_tanh, forward and reverse layers, at the word LM's
                shape (T 35, N 32, H 200), bench_lstm_sweep's H 256,
                ragged shapes (T 1, N 1, an odd N, H 203 off the vector
                width, a tiny layer), N 33 and both sides of the design
                boundary (the largest H of the cluster design and the next
                one up, by mode and dtype), each output within
                ops/fused_rnn.py PLAIN_TOL, both designs launched (counts
                by design), and faults planted into the kernels' results
                must fail those limits; a shape just outside the gate must
                raise; then both kernels timed at the path's shape beside
                their plain versions, their bound, the cluster design's
                serial floor (35 cluster barriers with K4a's exchange, no
                arithmetic) and cuDNN's LSTM layer (torch.nn.LSTM, its
                input projection included) forward and backward.
  11. word-LM training path — bench.py's non-smoke bench_lstm_lm
                (RNNModel lstm, vocab 10000, embed 200, hidden 200, 2
                layers, dropout 0, Xavier weights; bptt 35 x batch 32
                tokens from RandomState(0); TrainStep SGD lr 0.1) with
                MXNET_FUSED_RNN=1: the first step's loss and gradients in
                float32 against the flag off, beside a second flag-off run;
                one warm-up and 10 timed bfloat16 steps (finite, falling
                loss; K4a and K4b launched 2 a step each, all through
                the cluster design); the same steps
                with the flag off (no launch); a profiled step; then 20
                steps of examples/word_lm.py's imperative loop (record,
                backward, clip_global_norm, gluon.Trainer adam, dropout
                0.5, hidden state carried) on its synthetic corpus at
                vocab 10000: finite losses, 2 launches of each kernel a
                step, and the eval loss over those batches (dropout off)
                lower after the steps than before.
  12. Module path — BASELINE config 1 (BASELINE.md:57) at the width of
                examples/train_mnist.py: get_mlp and get_lenet trained by
                Module.fit on the synthetic MNIST (6000 training, 1000
                test images; batch 100, SGD lr 0.1 momentum 0.9, Xavier,
                kvstore "local", 2 epochs, Speedometer, do_checkpoint into
                a temporary directory): accuracy > 0.9 each, and
                load_checkpoint + Module.load give the trained module's
                validation outputs bit for bit; step ms over the second
                epoch and a profiled step.
  12b. executor BatchNorm path — bn_convnet (get_lenet with a BatchNorm
                after each Convolution) through Module at batch 100,
                float32, MXNET_FUSED_BN_EPILOGUE=1: the first step's
                outputs, gradients and moving statistics flag on against
                flag off; test_utils.check_consistency over [cpu,
                gpu(0)] at batch CONSIST_BN_BATCH, outputs and gradients
                within its tol 1e-3, K3a-d launched twice each on the
                card; 5 steps with K3a-d launched 2 x 5 times each, none
                in score; a profiled step.
  13. Gluon path — SKILL.md drive flow 2: LeNet on gluon.data's MNIST
                (ToTensor, DataLoader batch 100, shuffle, 2 worker
                threads, pinned batches) with gluon.Trainer sgd lr 0.1
                inside autograd.record(), one epoch eager and one after
                hybridize(): accuracy > 0.9 each; a profiled step.
  14. Gluon ResNet-50 path — BASELINE config 2's single-device half:
                the model zoo's resnet50_v1 at its published widths (1000
                classes, 224x224 NCHW) in float32 at batch 128 (float32
                activations take twice phase 9's bfloat16 memory a
                batch), gluon.Trainer sgd lr 0.05 momentum 0.9 wd 1e-4,
                MXNET_FUSED_BN_EPILOGUE=1, on seeded synthetic
                class-prototype images; an eager net and a hybridized one
                (the traced, cached graph) from the same weights, stepped
                in turns, 2 warm-up and 10 timed steps each: finite,
                falling losses, K3a-d launched 53 times each a step in
                both modes, step ms, img/s, peak memory and a profiled
                step's device busy share each; first the hybridized
                graph against the eager forward on a resnet18_v1 step
                (64x64, batch 32, cuDNN off): outputs within 1e-5,
                gradients within 1e-4.
  14b. export and reload — phase 14's trained net exported, loaded back
                through gluon.SymbolBlock.imports(ctx=gpu) and through
                load_checkpoint + Module(bind for_training=False): eval
                logits on the batch within 1e-5 of the largest |logit|.
  14c. word LM hybridized — RNNModel at phase 11's width in float32,
                hybridized, MXNET_FUSED_RNN=1: the first step's loss and
                gradients against the eager step within ops/fused_rnn.py
                PLAIN_TOL, then 5 gluon.Trainer sgd steps with K4a and
                K4b launched 2 a step each and finite, falling losses.
  15. bucketed LSTM LM — upstream example/rnn/bucketing/
                cudnn_lstm_bucketing.py's defaults (vocab 10000, embed
                and hidden 200, 2 layers, batch 32, buckets 10-60,
                float32) on examples/lstm_bucketing.py's arithmetic
                progressions (3200 sentences, lengths 5-60, numpy seed
                0, token 0 the padding and the ignored label) through
                mx.rnn.BucketSentenceIter, FusedRNNCell (its begin
                states' batch left to the bound data) and
                BucketingModule.fit (Adam lr 0.01, the example's Mixed
                initializer) with MXNET_FUSED_RNN=1, one epoch: (a) the
                first step's outputs and gradients at buckets 10 and 60
                flag on against flag off within ops/fused_rnn.py
                PLAIN_TOL; (b) finite losses, the last 10 batches'
                perplexity below the first 10's, K4a and K4b launched 2
                a step each, all six buckets bound, each bucket's
                parameters bit equal to the current one's after a
                switch; (c) a Monitor's statistics finite; (d)
                save_rnn_checkpoint / load_rnn_checkpoint and a legacy
                .params file read back onto the card bit equal; step ms
                by bucket, tokens/s, peak memory, the switch's parameter
                copy timed alone, a profiled bucket-60 step.
  15b. the unrolled cells — phase 15's width as a SequentialRNNCell of
                two LSTMCells at buckets 10 and 20, 5 Adam steps each:
                finite losses, no K4 launch, step ms beside phase 15's.
  15c. the other Module types — phase 12's MLP, one epoch each, as a
                SequentialModule (features, then a head taking the
                labels) and through DataParallelExecutorManager over
                [gpu(0), gpu(0)] with a caller-side update: accuracy >
                0.9 each.
  16. Inception-v3's BatchNorm shapes — the (C, H, W) each of the
                model zoo's inception_v3's BatchNorm blocks sees at
                299x299 (forward hooks over one batch-1 forward; 94 a
                step, 18 distinct, most with an odd S), then K3a-d
                against their plain versions in float32 at batch 128 at
                each, relu off (each BatchNorm feeds an Activation of its
                own), each kernel timed there beside its plain version,
                its bound and the library yardsticks, one row a shape and
                kernel, and the sums over the step's 94 calls.
  16b. Inception-v3 training path — BASELINE.md's anchor: the model zoo's
                inception_v3 at its published width (1000 classes,
                299x299 NCHW), float32, batch 128, TF32 off, on seeded
                class-prototype images with MXNET_FUSED_BN_EPILOGUE=1:
                the first step flag on against flag off beside the
                flag-off step's own floor (phase 9's check), then phase
                14's run (gluon.Trainer sgd, eager and hybridized from
                the same weights in turns, 2 + 10 steps each): finite,
                falling losses, K3a-d launched once a step for each of
                the net's BatchNorm blocks in both modes, the cached
                graph in use, step ms, img/s, peak memory and a profiled
                step's busy share each.
  16c. the other model-zoo families — alexnet, vgg16_bn, squeezenet1.1,
                densenet121, mobilenet1.0 and mobilenetv2_1.0 by their
                registry names at 224x224, 1000 classes, batch 32: an
                inference forward eager and hybridized (the hybridized
                logits within 1e-5 of the largest eager |logit|) and
                img/s of each; one flag-on training step of densenet121
                and mobilenetv2_1.0, K3a-d launched once for each of the
                net's BatchNorms.
  16d. Gluon cells and losses — a SequentialRNNCell of two LSTMCells
                unrolled over 35 steps at the word LM's width (embed and
                hidden 200, batch 32, float32) against gluon.rnn.LSTM
                with the same weights under MXNET_FUSED_RNN=1 (K4a once a
                layer): outputs and final states within ops/fused_rnn.py
                PLAIN_TOL; every Gluon loss on the card against the CPU.
  17. the optimizers — every registered optimizer (16) on the word LM at
                phase 11's width in float32 (MXNET_FUSED_RNN=1), 5 steps
                through TrainStep and 5 through gluon.Trainer from the
                same weights and batches: parameters within rtol 2e-4 /
                atol 2e-5 (SGLD: finite and moved), K4a and K4b 2 a step
                on both paths, step ms of each beside SGD's.
  17b. the update ops — each nd.*_update op (states in place, out=)
                against its optimizer rule on one 25.6M-element float32
                tensor (ResNet-50's parameter count), within 1e-5 of the
                largest value, timed beside the rule.
  18. remat on ResNet-50 — phase 9's config under remat none, "full" and
                "io" from the same weights: the first float32 step of
                each against none beside none's own floor; the running
                stats after 3 deterministic float32 steps within 1e-5 of
                none's; bf16 timed runs (2 + 10 steps) with K3a 53 / 106
                / 53 and K3b 53 / 106 / 106 launches a step (K3c, K3d 53),
                step ms, peak memory and temp bytes ("full" and "io"
                below none); functionalize(net) against net(x).
  19. guard, probe, resume — guard=True on ResNet-50: a finite step
                equal to the unguarded one, a NaN batch dropped with the
                parameters, momentum and running stats bit-equal; two
                probes of the word LM (dropout 0.5, Adam) bit-identical
                and changing nothing; the word LM resumed from step 3's
                state_dict bit-equal at step 5.
  20. data on the card — get_mlp through Module.fit on a 10,000-row CSV
                of the synthetic MNIST read by CSVIter inside
                DevicePrefetchIter(depth=2): accuracy > 0.9, step ms with
                and without the prefetch; an autograd.Function (sigmoid)
                on the card against the CPU.
  21. ROADMAP item 2 on the card — (a) every dense op name the slice
                adds (and once each, its aliases) through mx.nd on the
                card at a user's size (ITEM2_*: 2^24 float32 elements
                elementwise, dot at 4096^2, batch_dot at (64, 512, 512),
                sort / argsort / topk over (64, 32000) logits with and
                without ties, linalg on 64 128 x 128 matrices, ROIPooling
                with 128 ROIs on (8, 256, 38, 50), Correlation on (4, 256,
                48, 64), BilinearSampler and SpatialTransformer on (32, 3,
                224, 224)) against the same call on the CPU, and its
                gradients where it has them, within ITEM2_TOL; gelqf and
                syevd by reconstruction and up to each row's sign; per
                family the count, the largest error and the card ms;
                then test_utils.check_consistency over [cpu, gpu(0)] of
                sym.RNN lstm at the word LM's layer, MXNET_FUSED_RNN=1,
                outputs and gradients within tol 1e-3, K4a-b launched
                LM_LAYERS times each on the card.
                (b) K1 through nd.contrib.PagedAttention with
                MXNET_PAGED_ATTENTION=1 (decode B 8, a 32-row chunk;
                float32 and bfloat16) and a bound sym.contrib.
                PagedAttention: one launch a call, each output within TOL
                of the flag-off composite. (c) examples/nce_word_
                embeddings.py at its defaults on the card (its `mx` the
                port) passing its own check. (d) examples/stochastic_
                depth.py's net hybridized on the card: fresh (1, 1, 1, 1)
                gates each step, repeated under a reseed, losses equal to
                the eager net's.
  22. the serving front door — phase 4's config and width on K1 (block
                16, max_batch 8, token_budget 256, 64-token prompts, 128
                new tokens, weights from phase 4's seed): (a) tenant
                `batch` 8 requests at priority 0, then `interactive` 4 at
                priority 1, under tenant_budget 128: no batch request
                admitted while an interactive one enqueued before it
                waits, greedy tokens against the gather oracle, K1
                launches = n_layers x (decode steps + prefill chunks);
                (b) over HTTP on the warm server `deadline_ms: 1` gets 503
                with Retry-After >= 1 and 10x the solo latency gets 200
                with oracle tokens and its traceparent echoed, and on a
                fresh server a request behind a full batch with a 200 ms
                deadline gets 504 with no prefill chunk on its trace; (c)
                brownout (after 0.2 s at >= 12 of max_queue 16): the
                priority-0 class shed (BrownoutShed; 503 over HTTP),
                requests admitted while it is on clamped, those admitted
                before it full length, all tokens the oracle's; (d) one
                Perfetto row for the traced request, the text/plain
                /metrics under the Prometheus grammar with counters equal
                to snapshot()'s, /statusz's token identity overall and per
                tenant (MXNET_SLO_TTFT_MS set), every MXNET_REQUEST_LOG
                line with the required keys, flight().dump in
                MXNET_FLIGHT_RECORDER_DIR, tools/postmortem.py and
                tools/fleet_top.py --once --plain exiting 0; (e) phase 4's
                traffic on fresh servers with MXNET_TELEMETRY=0 and =1,
                a warm-up and then 4 ABBA blocks: the step period, the
                decode call and the gap between calls (p50s), tokens/s
                and TTFT p50 per run, and the paired on - off medians
                (no limit).
  23. the multi-replica door — phase 4's config and width on K1, every
                replica on the one card (cuda:(i % device_count)): (a)
                24 requests (prompts 32-256, 16-128 new tokens, seed 23)
                from 6 client threads through serve(replicas=3), greedy
                tokens against the gather oracle, every replica serving,
                K1 launches = n_layers x (decode steps + prefill chunks)
                over the replicas; the same traffic through one LMServer
                after it (FLEET_TURNS: tokens/s, TTFT p50); 60 POSTs at once over queues of 2 get 200s with
                oracle tokens and 503s with Retry-After; (b)
                tools/chaos_serve.py's five faults in sequence under a
                client stream (replica 1 wedged, drained and restored;
                replica 0 killed mid-decode, its request failed over and
                the replica respawned; replica 2's decode poisoned and
                its pool exhausted; replica 1 crash-looping until its
                circuit opens): every request completed with oracle
                tokens, audit_quiescent on every pool and retired
                corpse, the faults and the victims' failover and finish
                in the flight dumps, tools/postmortem.py and
                tools/fleet_top.py --once rc 0, the token and request
                ledgers' identities; (c) roles="prefill:1,decode:2" with
                the prefix cache, 12 requests (4 on a 256-token prefix):
                each migrates once with oracle tokens on one trace, the
                decode replicas' prefix hits save bytes, K1's launches
                match; with the decode replicas retired the prefill
                replica decodes locally; (d) serve(autoscale=
                AutoscaleConfig(min 1, max 3)) with 1 and 2 s SLO windows
                and a 10 ms TTFT objective: step() by hand over real
                burns scales up, holds in its cooldown, scales down once
                idle and cool, no request lost, oracle tokens.
  24. distributed training on the one card (ROADMAP item 12's first
                half), each world in child processes on cuda:0 started
                through parallel.launch.run_world after the kernels are
                built (so no rank builds): (a) a world of one rank over
                NCCL: kv.create("nccl") push and pull, one
                make_train_step step under {'dp': 1} at phase 5's width
                held to the single-device step, NCCL's kernels in the
                profiler's names; (b) a world of 2 ranks sharing the card
                over gloo at phase 5's config and batch (flash on): meshes
                {'dp': 2}, {'tp': 2} and {'sp': 2}, 3 SGD steps each from
                the same seeded weights, losses and the update held to
                the single process's (DIST_LOSS_RTOL; the update within
                max(2 x floor, DIST_UPDATE_TOL), the floor the single
                process stepping on two half batches' mean gradient),
                K2 / K2-bwd launched n_layers x steps a rank under dp and
                tp and not under sp; (c) ResNet-50 at phase 9's config,
                TrainStep(mesh={'dp': 2}, sharded_update=True): the
                float32 first step's loss and gradients held to the
                single process's within max(2 x floor, 1e-4), the floor
                the larger of phase 9's and the single process's own
                under deterministic cuDNN with the input moved one ulp,
                one float32 step's change of the BatchNorm running
                statistics to the global batch's (DIST_BN_STATS_TOL),
                then 2 bfloat16 steps with K3a-d launched 53 times a
                step a rank; (d)
                tools/launch.py -n 2 --launcher local running the port's
                dist LeNet worker (tests/test_torch_dist_kvstore.py
                --check lenet --compress) on the card: dist_sync with
                2-bit compression, the loss halves, both ranks hold the
                same bits; (e) the word LM at phase 11's width (batch-
                major, DIST_LM_STEPS SGD steps in float32, MXNET_FUSED_RNN=1)
                under {'dp': 2}: the float32 collective run and the
                MXNET_QUANTIZED_COLLECTIVES=int8 run from the same
                weights, both falling, their losses within the
                reference's 0.05 of each other
                (tests/test_serving_quant.py:499) and the int8 run's
                parameter update within DIST_INT8_UPDATE_TOL of the
                float32 run's, K4a-b
                launched LM_LAYERS times a step a rank. Each prints the
                backend and world, step ms beside the single process,
                the bytes through the collectives and those staged
                through host memory, and per-rank launches, beside the
                card's name and power limit.
  25. training resilience (ROADMAP item 12's training side) on the word
                LM at phase 11's width (vocab 10000, embed and hidden
                200, 2 layers, bptt 35 x batch 32, float32, fused RNN)
                with dropout 0.5 and adam, through K4a-b: (a) in process,
                12 steps through ResilientLoop(TrainStep,
                CheckpointManager(async_save=True)) against 5 steps, a
                fresh net and step, restore() and the other 7: the
                parameters bit-identical and K4a-b launched LM_LAYERS
                times a step in both; (b) the subprocess drill
                (`python -m mxnet_tpu_torch.tools.chaos_train --device
                cuda`): SIGTERM exits 83, a kill during the save exits 43
                with the last published step intact, a NaN step rolls
                back, and the faulted run's final line and parameter
                sha256 equal the clean run's; (c) the pod drill
                (`--multihost`): a world of 2 ranks sharing cuda:0 over
                gloo, {'dp': 2}, sharded_update, per-rank sharded
                checkpoints, no dropout (each rank draws its own slice's
                masks): rank 1 SIGKILLed and then killed mid-save, the
                survivor ending within its grace window each time (83,
                or gloo's error about the dead peer), a same-shape
                relaunch from the newest complete step bit-identical to
                an undisturbed world (step losses included), an elastic
                relaunch onto a world of one whose step losses,
                parameter sums of squares and eval loss lie within
                chaos_train.ELASTIC_RTOL, and a rank that hangs
                (SIGSTOP): its survivor ended by gloo's timeout within
                MXNET_WORLD_TIMEOUT, or, under SIGTERM with the world's
                timeout far off, by the grace timer with 83; (d) the
                supervised campaign (`--multihost --supervised`, an
                emulated pod of 3 hosts, each a world of one,
                relaunched through tools/train_supervise.py): a slow
                host cordoned and the pod finishing at 2 hosts equal to
                the undisturbed run, a truncated step demoted by the
                audit before restore, and an SDC digest flip naming the
                armed host. (b), (c) and (d) run at the same time,
                sharing the card ((d)'s legs in one campaign, after one
                clean reference run). (b)-(d) launch K4a-b
                once a layer for each step and SDC probe their
                finishing workers ran. Prints the
                save latency (the caller's host copy against the
                writer's write + fsync), checkpoint bytes a rank, restore
                ms and each leg's wall time beside the card's name and
                power limit.
  26. rollout and tensor-parallel serving (ROADMAP item 12's serving
                side) at phase 4's width on K1, random weights from seed
                26: (a) `serve(replicas=2, rollout=<dir>)` under a
                stream of 4 clients (prompts 32-128, 16-64 new tokens)
                while the port's CheckpointManager publishes sharded
                steps: step 1 with one host's shard first (incomplete,
                skipped), then whole — gated, canaried, up the default
                ladder and promoted (the TTFT objective, the slow
                canary's sleep and the stage window, at least 0.5 s,
                calibrated from the healthy fleet's first tokens, so a
                slow canary's first token lands inside the windows that
                judge it); step 2 bit-flipped
                by serve_rollout_corrupt and quarantined by the digest
                probe before any canary; step 3's canary slowed by
                serve_rollout_slow_canary and rolled back after
                `max_bad` bad windows of its TTFT burn; step 4 rolled
                back by an operator through POST /v1/rollout; step 5,
                step 1's weights but for positional rows no parity
                prompt reaches, rejected by the divergence probe. Zero
                requests lost or failed, the fleet back at 2 replicas
                on version 1, whose greedy tokens on the 4 pinned
                prompts equal a fresh server's on step 1's weights.
                (b) tp=2 and tp=4 engines over the emulated windows
                [cuda:0] * k: every prefill and decode logit row within
                rtol 1e-4 / atol 1e-5 of the tp=1 paged engine's over
                64 steps of 8 requests and every greedy token equal (a
                request's comparison ends at a near-tie), each shard's
                pool (L, NB, bs, H/k, Dh), contiguous, on its device,
                K1 launched layers x shards x (chunks + steps) times;
                the int8 tp=2 engine (int8 KV + int8 weights, block 32)
                with every shard's scales its own block's and,
                teacher-forced, within twice the reference's own int8
                tp=2 vs tp=1 error (REF_TP_QUANT_LOGIT_ERR); an LMServer
                at tp=2 serving phase 4's 9 requests with phase 4's
                tokens; tp=2 with no window falling back with the
                reference's reason and still on K1. (c) the tp != tp
                hop: roles prefill:1,decode:1 with the decode role at
                tp=2, greedy tokens equal to one server's. Prints the
                rollout's transitions and times, gate ms, K1 launches
                and step ms at tp 1, 2 and 4 beside the card's name and
                power limit.
  27. BASELINE config 4, SSD (ROADMAP item 13), seed 27,
                MXNET_FUSED_BN_EPILOGUE=1: (a) SSDLite at bench.py's
                non-smoke width (20 classes, batch 32, 3 x 256 x 256,
                4032 anchors; 1-4 boxes an image) trained through Gluon
                with examples/train_ssd.py's loss and Adam at lr 0.005:
                the first step's loss and gradients in float32 against
                the flag off beside the floor (phase 9's check; targets
                from the flag-off forward held fixed, the flag-on
                forward's positives and loc targets identical), 2
                warm-up and 10 timed steps (falling loss) with K3a-d
                launched 5 times a step each (one a BatchNorm), a
                profiled step; (b) the inference forward in float32 and
                bfloat16 (img/s; bf16 class scores within SSD_BF16_TOL),
                MultiBoxTarget (hard mining) and MultiBoxDetection on the
                card at the full batch: every detection row what greedy
                NMS gives (a vectorised oracle of the scan), each op's
                ms; (c) examples/train_ssd.py's loop at its own size (64
                images of 48 x 48, batch 16, 12 epochs) through
                ImageDetIter fed decoded arrays by its read_image /
                imdecode hooks, no OpenCV: the epoch loss falls, the
                detections are well formed and the example's IoU lies in
                [0, 1], K3a-d 5 a step; (d) the slice's 15 op names and
                their aliases on the card against the port on the CPU
                (phase 21a's check, their gradients where
                differentiable), and gluon's CTCLoss forward and
                backward; (e) examples/custom_op.py at its defaults with
                its context on the card: its own check passes. Prints
                whether OpenCV imports, step ms, img/s, peak memory, the
                busy share, the ops' ms and errors beside their limits,
                with the card's name and power limit.
  28. BASELINE config 5 and int8 quantization (the rest of ROADMAP
                item 13), seed 28; runs none of the kernels line's
                kernels: (a) SparseLinear at bench.py's non-smoke
                bench_sparse_linear width (batch 512, 2,000,000
                features, 60 stored values a row, SGD at lr 0.1) on a
                CSR batch built as CSR: the first step against the port
                on the CPU (loss, touched rows and updated rows within
                SPARSE_TOL, every other row bit-equal), the transposed
                product's run-to-run spread (0: segment sums without
                atomics), 1 warm-up and 15 timed steps, the syncs of a
                step (PyTorch's sync debug mode), peak memory above the
                phase's start under SPARSE_PEAK_LIMIT (the dense batch
                would be 4.1 GB), a profiled step; (b) the same model
                through kv.create("local") (row-sparse push, the store's
                optimizer, pull) against no store, bit-equal weights
                after 3 steps, row_sparse_pull of the batch's rows equal
                to the weight's, lazy Adam against the CPU; (c) the
                factorization machine (8 factors) at that width, 5 steps
                with a falling loss; (d) examples/sparse_linear_
                classification.py at its defaults on the card (its
                accuracy against the CPU's), LibSVMIter over a file of
                4096 lines at the example's width, whole (its batches
                trained as CSR on the card) and in 2 parts; (e) the
                dist_sync row-sparse init / push / row_sparse_pull of
                two ranks over gloo on cuda:0 against the one-process
                sum, run inside phase 24d's launch; (f) resnet50_v1
                quantized as bench_resnet50_int8_infer does it (Gluon
                export, model.load_checkpoint, quantize_model with
                calib "none": 53 int8 convolutions and the int8 FC),
                bound with grad_req "null": 2 warm-up and 20 timed
                forwards at batch 256 of 224 x 224 beside the float
                executor's, top-1 agreement and the largest relative
                logit error against the float net, each layer's int32
                accumulators against the CPU fed the card's own int8
                inputs on 2 images (within Q_INT32_TOL), peak memory;
                (g) examples/quantize_int8.py at its defaults with its
                context on the card (its own check: rc 0); (h) the 13
                names and their aliases on the card against the port on
                the CPU (integer outputs exact), each error beside its
                limit and the card's ms.
  29. deployment (ROADMAP item 14's first half), seed 29: (a)
                resnet50_v1 (1000 classes, random Xavier weights) in
                float32 at batch 32 of 224 x 224 exported by
                predict.export_model on the card (torch.export) and
                replayed by load_exported, and a Predictor built from
                the net's own symbol JSON and params (phase 14b's
                route): both within EXPORT_RTOL of the net's eval
                logits; batch_predict over 45 single images (a ragged
                last batch); the export and load seconds and img/s of
                each route beside the eager and hybridized net; (b) the
                word LM at phase 11's width exported with
                MXNET_FUSED_RNN=1: LM_LAYERS `mxnet_tpu_torch::rnn_fwd`
                nodes in the graph, one replay launching K4a LM_LAYERS
                times and K4b none, logits within LM_EXPORT_RTOL of the
                eager net with the flag off; the artifact reloaded in a
                fresh process (torch and the op's registration) on the
                card (the same launches) and on the CPU (the plain
                version, within LM_EXPORT_CPU_RTOL); (c) K5: three user
                kernels (RTC_SOURCE: the reference test's doubling, a
                saxpy on 2^26 float32, a block sum over a 2-D grid with
                64 KB of dynamic shared memory) compiled by
                rtc.CudaModule (NVRTC, sm_90a) and launched through
                CudaKernel.launch, each held to its plain version
                (doubling bit for bit, saxpy within RTC_SAXPY_ULPS, the sum
                within RTC_SUM_RTOL) and timed beside its bytes bound
                and the one PyTorch call computing it, with the NVRTC
                compile ms; (d) a torch.nn conv + BatchNorm + linear
                module inside a Gluon net (TorchBlock) trained 5 SGD
                steps by gluon.Trainer against the same module under
                torch.optim.SGD, within TORCHBLOCK_TOL, and its
                BatchNorm buffers through save_params / load_params;
                (e) tests/test_onnx.py:125's residual block,
                hand-encoded through the port's wire codec, imported
                and run on the card against the CPU.
  30. the C++ deployment half (ROADMAP item 14 (a)), seed 30: (a) the
                C++ tree (mxnet_tpu_torch/cpp_package/) built with g++
                against torch's libraries and fused_rnn.cu's library, its
                seconds, and its rnn_design against fused_rnn.rnn_design
                at CPP_DESIGN_CASES (both designs), asked in a process
                that imports neither torch nor the port; (b) phase 29b's
                word LM compiled for the card by predict.compile_for_cpp
                (AOTInductor) and run by mxtpu_predict: the C++ op
                `mxnet_tpu_torch::rnn_fwd` launching K4a LM_LAYERS times
                a forward, logits within LM_EXPORT_RTOL of the Python
                replay, C++ ms a forward beside it; then the Gluon LeNet
                at batch 100 through libmxtpu_predict.so's C API
                (C_API_CLIENT, ctypes in a fresh process), within
                EXPORT_RTOL, with its -1 returns; then phase 29a's
                ResNet-50 artifact (kept from phase 29) compiled for the
                card in a process of its own (R50_COMPILE) beside the
                word LM's compile, run by mxtpu_predict (--repeat
                CPP_R50_TIMED) and one batch through the C API, logits
                within EXPORT_RTOL of the Python replay; (c) export_train_step
                of get_mlp's MLP (batch 100, SGD lr 0.1 momentum 0.9) and
                50 steps of mxtpu_train on the card, falling, the first 5
                losses within CPP_TRAIN_RTOL of TrainStep fed the same
                LCG batches; (d) the native runtime where it builds
                (engine order, 10,000 records each way), else that
                finding and every native object raising; ImageRecordIter
                over 512 JPEGs at (3, 224, 224), batch 256, onto the card,
                with img/s.
  31. the compile watchdog and the AOT cache (ROADMAP item 11), seed 31;
                main() configures the AOT cache to a temporary directory
                before the build, so every compile of the run flows
                through it: (a) the watchdog's record of the run per
                site (the nvcc builds kernels.*, predict.export,
                predict.compile_for_cpp, rtc.compile_cubin,
                cpp_package.build, the steps' first runs): compiles,
                seconds, duplicates, warm loads; (b) phase 11's word LM
                (bench width, float32, MXNET_FUSED_RNN=1) through
                serve(net, vocab=, max_len=WATCH_MAX_LEN,
                time_major=True) (BlockLM), WATCH_PROMPTS prompts of
                WATCH_PROMPT_LEN and WATCH_GEN new tokens: greedy tokens
                equal to a plain flag-off loop's (or split at a near-tie,
                the logits within LM_EXPORT_RTOL), K4a LM_LAYERS times a
                full forward, serving.step_full's first runs carrying
                their signature diffs; (c) a batch-major twin on the same
                weights exported at batch WATCH_EXPORT_BATCH with the flag
                on and served from its .mxtpu (ExportedLM): BlockLM's
                tokens, K4a LM_LAYERS times a replay; (d) a fresh process
                with MXNET_AOT_CACHE_DIR on the run's cache (WARM_CACHE):
                an Engine(aot_cache=) over (b)'s weights serves a prompt
                with warm loads and zero nvcc builds, compile_for_cpp of
                30b's artifact with its package taken out runs zero
                AOTInductor compiles (the package's sha256 30b's), and
                mxtpu_predict on it gives logits bit-equal to 30b's, K4a
                through the C++ op; (e) a word-LM TrainStep on the card
                refused by MXNET_HBM_BUDGET_GB=1e-9 with its parameters
                unchanged, then admitted once the budget is lifted.
  32. the kernels line (K2's, K3a-d's, K4a-b's and K5's launches summed
     over every path that runs them, split in `launches_by_path`; K3a-d's
     sums over an Inception-v3 step under `inception_v3_step`; K4a's
     through phase 29b's exported replay, phase 30b's C++ op and phase
     31's adapters, warm process and C++ op), nvidia-smi's line, and the
     last line {"ok": true, "device": {...}}.

Parity settings: TF32 is off for matmuls and cuDNN, so float32 products
run in full float32 (the reference suite forces highest matmul
precision). Imports nothing of JAX or of the JAX package. Each phase
prints `phase time: <function> <s> s (<s> s since the start)` as it ends.
"""
import concurrent.futures
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

#: H100 SXM data-sheet peaks (dense): device-memory bytes/s, and
#: float32 (CUDA cores) / bf16 (tensor cores) operations/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
#: kernel-vs-plain tolerances (atol = rtol). float32: the two sum the
#: scores and the PV product in different orders (online softmax over
#: blocks vs one softmax over the gathered row), a few ulps of a sum of
#: up to ~200 terms. bfloat16: the output is rounded to bf16 (8 bits of
#: mantissa, ~4e-3 relative) after float32 accumulation in both.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: greedy-token comparison stops at a step whose top-2 logit margin is
#: under this (10x the float32 tolerance): batch composition changes the
#: matmul shapes, so such near-ties may legitimately flip
MARGIN = 10 * TOL["float32"]
#: the serving benchmark's full-width config (bench.py's non-smoke
#: serving config) and its traffic: 64-token prompts, 128 new tokens,
#: 8 in-process requests plus one over HTTP
BENCH_CFG = dict(vocab=8192, d_model=512, n_heads=4, n_layers=4,
                 d_ff=2048, max_len=1024)
PROMPT_LEN, GEN, N_REQ = 64, 128, 9
#: the training benchmark's full-width config (bench.py's non-smoke
#: bench_transformer_flash) and its batch, steps and learning rate
TRAIN_CFG = dict(vocab=8192, d_model=512, n_heads=8, n_layers=6,
                 d_ff=2048, max_len=1024)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 10, 0.1
#: flash kernel vs plain tolerances (atol = rtol), (forward, backward).
#: float32: the forward sums by 64-key tiles with an online softmax, the
#: plain version in one dense softmax; the backward sums products over
#: up to T = 1024 rows in another order. bfloat16: outputs rounded to 8
#: mantissa bits after float32 arithmetic in both. m and l are float32
#: in both dtypes and take the float32 forward tolerance.
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
#: flag-on vs flag-off training step (float32, TF32 off): the loss to
#: this relative error, each gradient to this relative Frobenius error
#: ||g_flash - g_ref|| / ||g_ref||. The flash kernels and dense attention
#: sum in other orders (~1e-6 relative). Where that flips the sign of a
#: ReLU pre-activation within ~1e-6 of zero (some 15 of a layer's 16.7 M
#: at this width), one token's term moves a whole gradient column: a
#: relative Frobenius error near sqrt(15 / 16.7e6) ~ 1e-3, and larger
#: elementwise. The bound leaves a tenfold margin; a kernel fault moves
#: it to O(0.1). The reference against itself in another summation order
#: (two half batches) is printed beside it, as the noise floor.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-2
SOURCES = ("paged_attention.cu", "flash_attention.cu", "fused_bn.cu",
           "fused_rnn.cu")
#: quantized serving (phases 6 and 7): bench.py's bench_serving_quant
#: block size (int8 blocks of 32 tokens, bench.py:2563), the greedy-token
#: near-tie margin (twice the reference's 0.05 logit budget for int8 KV +
#: int8 weights, tests/test_serving_quant.py:218), and the logit probe's
#: bound. At this config's full width the JAX reference's own quantized
#: engine, teacher-forced on its float engine's tokens, is off by up to
#: 0.0511 (tools/quant_logit_probe.py --impl reference, CPU), above the
#: tiny config's 0.05 budget; the probe is held to twice that.
QUANT_BLOCK = 32
QUANT_MARGIN = 0.1
REF_QUANT_LOGIT_ERR = 0.0511
PROBE_BOUND = 2 * REF_QUANT_LOGIT_ERR
#: phase 7's traffic (bench.py:1439-1442's shared-prompt shape, with the
#: shared length moved off the block boundary: 272 = 8.5 x 32)
SHARED_LEN, SUFFIX_LEN, SPEC_GEN, N_SPEC_REQ = 272, 32, 64, 8
SPEC_K, DRAFT_LAYERS = 3, 2
#: phases 8-9: ResNet-50 v1 training at bench.py's non-smoke
#: bench_resnet50 config (batch 256, 224x224 NCHW, 1000 classes, SGD lr
#: 0.05 momentum 0.9 wd 1e-4, inputs uniform(-1, 1) and labels from
#: RandomState(0)), timed in bfloat16 mixed precision as the bench runs it
R50_BATCH, R50_IMAGE, R50_CLASSES, R50_STEPS = 256, 224, 1000, 10
R50_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
#: the 53 BatchNorms of one ResNet-50 v1 step at batch 256: (C, H, W, relu,
#: residual, count). The stem's BN (its relu is a layer of its own); in
#: each stage the mid-body BN+ReLU pairs, the tail BN+residual+ReLU and
#: the downsample BN (bottleneck stride on the first 1x1 conv)
R50_BNS = [(64, 112, 112, False, False, 1),
           (64, 56, 56, True, False, 6), (256, 56, 56, True, True, 3),
           (256, 56, 56, False, False, 1),
           (128, 28, 28, True, False, 8), (512, 28, 28, True, True, 4),
           (512, 28, 28, False, False, 1),
           (256, 14, 14, True, False, 12), (1024, 14, 14, True, True, 6),
           (1024, 14, 14, False, False, 1),
           (512, 7, 7, True, False, 6), (2048, 7, 7, True, True, 3),
           (2048, 7, 7, False, False, 1)]
#: K3a-d kernel-vs-plain checks beyond the main path's: the variant the
#: network does not use (no relu, with residual), and two ragged shapes
#: (C=3 with an odd S, and S=1) in all four variants: (N, C, H, W, relu,
#: residual)
BN_EXTRA = [(256, 256, 56, 56, False, True)] + [
    (n, c, h, w, relu, res) for (n, c, h, w) in ((7, 3, 5, 7),
                                                 (256, 2048, 1, 1))
    for relu in (False, True) for res in (False, True)]
#: K3 kernel vs plain (tests/test_pallas.py:92-98, :185-186): outputs
#: atol = rtol, float32 1e-5 (float32 arithmetic in another order, one
#: FMA where the plain version rounds twice) and bfloat16 3e-2 (one
#: rounding to 8 mantissa bits of float32 values that may differ in the
#: last bit); the statistics 1e-5 in both (float32 accumulation of the
#: same values); the channel sums of K3c rtol 1e-4 with atol 1e-4 x
#: sqrt(N S), the size of a sum of N S unit terms
BN_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
BN_STATS_TOL, BN_SUM_RTOL = 1e-5, 1e-4
#: first-step check (float32, TF32 off): the loss to this relative error;
#: each gradient's relative Frobenius error to max(2 x floor, 1e-4). At
#: Xavier init ResNet-50's gradients move by ~2% (relative Frobenius)
#: under a rounding-level change of the step: a ReLU whose input sits
#: within an ulp of 0 flips its mask, and the BatchNorm backward's
#: near-cancelling channel sums carry the change along. The floor is the
#: worst of two such changes of the flag-off step: a second run of it
#: (cuDNN's run-to-run differences) and a run with the input moved by one
#: ulp. A conv bias that feeds a BatchNorm has a gradient of exactly 0 in
#: exact arithmetic (held to an absolute bound instead, relative to the
#: step's largest gradient element).
R50_LOSS_RTOL, R50_GRAD_MIN_TOL, R50_ZERO_GRAD = 1e-5, 1e-4, 1e-3
#: phases 10-11: the word-LM LSTM at bench.py's non-smoke bench_lstm_lm
#: (bench.py:675-733: vocab 10000, embed and hidden 200, 2 layers, dropout
#: 0, bptt 35 x batch 32 tokens from RandomState(0), SGD lr 0.1), timed in
#: bfloat16 as the bench runs it; and examples/word_lm.py's imperative
#: loop at that width (adam lr 0.003, dropout 0.5, clip 0.25 x bptt x
#: batch) on the example's synthetic corpus
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS = 10000, 200, 200, 2
LM_BPTT, LM_BATCH, LM_STEPS, LM_LR = 35, 32, 10, 0.1
LM_LOOP_STEPS, LM_LOOP_LR, LM_LOOP_DROPOUT = 20, 0.003, 0.5
#: K4 kernel-vs-plain shapes (T, N, H): the path's, bench_lstm_sweep's
#: widening to 256 (bench.py:748), and ragged ones: T 1, N 1, an odd N,
#: an H off the 16-byte vector width, a tiny layer
RNN_SHAPES = [(35, 32, 200), (35, 32, 256), (1, 32, 200), (35, 1, 200),
              (35, 7, 200), (35, 32, 203), (5, 3, 13)]
#: the design boundary's cases beyond RNN_SHAPES, (T, N, H) with the design
#: each must take: N 33 (a ragged last cluster), N 300 (several waves of
#: clusters, a ragged last one), "edge" the largest H of the cluster design
#: at that (T, N) and "past" the next one up (fused_rnn.cluster_limit, by
#: mode and dtype), which streams at a ragged N, T 1 and N 300 too, as
#: does H 1024
RNN_BOUNDARY = [((35, 33, 200), "cluster"), ((35, 300, 203), "cluster"),
                ((35, 32, "edge"), "cluster"), ((35, 32, "past"), "stream"),
                ((35, 7, "past"), "stream"), ((1, 32, "past"), "stream"),
                ((35, 300, "past"), "stream"), ((35, 5, 1024), "stream")]
#: K4 kernel vs plain: ops/fused_rnn.py PLAIN_TOL (shared with the card
#: tests), a relative Frobenius error and a largest error over the largest
#: |plain| value per output; phase 10 also checks that the limits reject
#: faults planted at the path's shape (tools/rnn_tol_probe.py measures
#: both)
#: the first word-LM step in float32 (TF32 off), flag on against flag off:
#: the loss to this relative error, each gradient to this relative
#: Frobenius error (the two sum in other orders; an LSTM has no ReLU kinks
#: to flip, so the differences stay near float32 rounding)
LM_LOSS_RTOL, LM_GRAD_TOL = 1e-5, 1e-4


#: phases 12-13: BASELINE config 1 (LeNet / MLP on MNIST) at the width of
#: examples/train_mnist.py: batch 100 over the 6000 synthetic training
#: and 1000 test images, SGD lr 0.1 (momentum 0.9 for Module), Xavier
#: phase 14: ResNet-50 through Gluon, eager and hybridized, float32 at
#: batch 128 (phase 9's 256 is bfloat16 compute over float32 masters;
#: float32 activations take twice the memory a batch)
G50_BATCH, G50_WARMUP, G50_STEPS = 128, 2, 10
G50_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
#: the on-card parity check of the hybridized graph against the eager
#: forward (resnet18_v1, cuDNN off): outputs, then gradients (numpy's
#: allclose rule, rtol = atol)
HYB_NET_BATCH, HYB_NET_IMAGE, HYB_OUT_TOL, HYB_GRAD_TOL = 32, 64, 1e-5, 1e-4
#: phase 14b: export and reload, the logits' largest error over the
#: largest |logit|
EXPORT_RTOL = 1e-5
#: phase 14c: the word LM hybridized
LMH_STEPS = 5

MNIST_BATCH, MNIST_EPOCHS, MNIST_LR, MNIST_MOMENTUM = 100, 2, 0.1, 0.9
#: the accuracy each phase 12-13 net must pass on the 1000 test images
#: (chance is 0.10)
MNIST_ACC = 0.9
#: phase 12b: training steps of the BatchNorm conv net through Module
BN_NET_STEPS = 5
#: phase 12b: flag on against flag off, the first step's outputs and
#: gradients (tests/test_torch_fused_bn.py's tolerance for the BatchNorm
#: ops' float32 gradients), and the moving statistics
BN_NET_TOL = 1e-4
#: test_utils.check_consistency over [cpu, gpu(0)] at its default tol
#: (1e-3, relative and absolute): phase 12b's bn_convnet at batch
#: CONSIST_BN_BATCH, MXNET_FUSED_BN_EPILOGUE=1 (each BatchNorm node
#: launches each K3 kernel once on the card: K3a-b in the forward, K3c-d
#: in the backward), and phase 21a's sym.RNN lstm at the word LM's layer,
#: MXNET_FUSED_RNN=1 (K4a and K4b once a layer); the CPU side runs the
#: plain versions
CONSIST_BN_BATCH = 8
#: check_consistency's scale (the parameters' and inputs' normal draws):
#: at 1.0 the word LM's LSTM is chaotic and bn_convnet's logits reach
#: ~20, so a one-ulp change of every input moves the LSTM's outputs by
#: 1000x the tolerance and bn_convnet's gradients by 1.73x; at 0.1 by
#: 0.11x (gradients) and 0.017x (tools/consistency_probe.py, on the CPU)
CONSIST_SCALE = 0.1


#: phases 16-16b: Inception-v3 through Gluon at its published width (1000
#: classes, 299x299 NCHW), float32 at batch 128, BASELINE.md's anchor
#: (batch 128 on one K80 with mirroring; example/image-classification/
#: README.md), trained as phase 14 trains ResNet-50 (G50_OPT, class-
#: prototype images, MXNET_FUSED_BN_EPILOGUE=1, eager and hybridized in
#: turns)
INC_BATCH, INC_IMAGE, INC_CLASSES = 128, 299, 1000
INC_WARMUP, INC_STEPS = 2, 10
#: the BatchNorm shapes of a float32 Inception-v3 step at INC_IMAGE, which
#: phase 16 finds by forward hooks (inception_bn_shapes) and checks
#: against this list: (C, H, W, count), 18 shapes, 94 calls
INC_BNS = [(32, 149, 149, 1), (32, 147, 147, 1), (64, 147, 147, 1),
           (80, 73, 73, 1), (192, 71, 71, 1),
           (64, 35, 35, 12), (48, 35, 35, 3), (96, 35, 35, 7),
           (32, 35, 35, 1),
           (384, 17, 17, 1), (96, 17, 17, 1), (192, 17, 17, 26),
           (128, 17, 17, 6), (160, 17, 17, 12),
           (320, 8, 8, 3), (192, 8, 8, 3), (384, 8, 8, 12), (448, 8, 8, 2)]
#: the first Inception step, flag on against flag off: the loss to this
#: relative error; each gradient's relative Frobenius error to max(2 x
#: floor, INC_GRAD_MIN_TOL), the floor the flag-off step's own (a second
#: run, the input moved one ulp), as phase 9's
INC_LOSS_RTOL, INC_GRAD_MIN_TOL = 1e-5, 1e-4
#: phase 16c: the model zoo's other families at their published widths
#: (224x224, 1000 classes) by their registry names, batch 32: a forward
#: eager against hybridized (largest logit error over the largest logit)
#: and img/s; one flag-on training step of the two with BatchNorm layers
#: that no other phase reaches (depthwise, concat-grown channels)
ZOO_FAMILIES = ("alexnet", "vgg16_bn", "squeezenet1.1", "densenet121",
                "mobilenet1.0", "mobilenetv2_1.0")
ZOO_TRAINED = ("densenet121", "mobilenetv2_1.0")
ZOO_BATCH, ZOO_IMAGE, ZOO_TIMED, ZOO_HYB_RTOL = 32, 224, 5, 1e-5
#: phase 16d: a SequentialRNNCell of two LSTMCells unrolled at the word
#: LM's width (bptt 35, batch 32, embed and hidden 200, float32) against
#: gluon.rnn.LSTM on K4a with the same weights; each Gluon loss on the
#: card against the CPU within LOSS_CARD_RTOL of its largest |value|
CELL_T, CELL_N, CELL_C, CELL_H = 35, 32, 200, 200
LOSS_CARD_RTOL = 1e-5


#: phase 15: the bucketed LSTM LM at upstream example/rnn/bucketing/
#: cudnn_lstm_bucketing.py's defaults (vocab 10000 as PTB's, num_embed and
#: num_hidden 200, 2 layers, batch 32, buckets 10-60), float32, Adam at
#: lr 0.01 with examples/lstm_bucketing.py's Mixed initializer, one epoch
#: over BUCKET_SENTENCES arithmetic progressions of uniform lengths
#: BUCKET_LENGTHS (numpy seed 0); token 0 pads and is the ignored label
#: (upstream's invalid_label 0: an id of -1 would read a NaN embedding row,
#: as jnp.take's fill gives it, and carry it into every gradient)
BUCKET_VOCAB, BUCKET_EMBED, BUCKET_HIDDEN, BUCKET_LAYERS = 10000, 200, 200, 2
BUCKET_BATCH, BUCKETS = 32, [10, 20, 30, 40, 50, 60]
BUCKET_SENTENCES, BUCKET_LENGTHS, BUCKET_LR = 3200, (5, 60), 0.01
BUCKET_PAD = 0
#: the buckets of the first-step check against the composite
BUCKET_CHECKED = (10, 60)
#: the perplexity windows compared over the epoch (first and last batches)
BUCKET_WINDOW = 10
#: phase 15b: SequentialRNNCell of LSTMCells at these buckets, steps each
UNROLLED_BUCKETS, UNROLLED_STEPS = (10, 20), 5


def bucketing_sym_gen(mx, vocab, embed, hidden, layers, cell="fused",
                      batch_size=0):
    """upstream cudnn_lstm_bucketing.py's sym_gen for either package
    (`mx`): Embedding, a 2-layer LSTM stack unrolled over the bucket
    (`cell` "fused": one FusedRNNCell, the `RNN` op; "unrolled":
    examples/lstm_bucketing.py's counterpart, a SequentialRNNCell of
    LSTMCells, one graph node a step), Reshape(-1, hidden),
    FullyConnected(vocab) and SoftmaxOutput ignoring BUCKET_PAD. The cell
    is made once, so every bucket shares its parameter names.
    `batch_size` 0 leaves the begin states' batch to the bound data."""
    if cell == "fused":
        stack = mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm",
                                    prefix="lstm_")
    else:
        stack = mx.rnn.SequentialRNNCell()
        for i in range(layers):
            stack.add(mx.rnn.LSTMCell(hidden, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                               name="embed")
        stack.reset()
        out, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True,
                              batch_size=batch_size)
        pred = mx.sym.Reshape(out, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax",
                                    use_ignore=True,
                                    ignore_label=BUCKET_PAD)
        return pred, ("data",), ("softmax_label",)
    sym_gen.cell = stack
    return sym_gen


def bucketing_corpus(np, n, vocab, lengths, seed=0):
    """examples/lstm_bucketing.py's learnable corpus at `vocab`: n
    sequences t, t+s, t+2s, ... (stride s in 1-3) of uniform lengths in
    `lengths`, the tokens in 1..vocab-1 (0 pads)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = rng.randint(lengths[0], lengths[1] + 1)
        start, stride = rng.randint(vocab - 1), rng.randint(1, 4)
        out.append([1 + (start + i * stride) % (vocab - 1)
                    for i in range(length)])
    return out


def bn_convnet(sym, num_classes=10):
    """The executor's BatchNorm path: get_lenet's layers with a BatchNorm
    (gamma trained) after each Convolution, ending in SoftmaxOutput.
    `sym` is either package's symbol module; both have every op here."""
    data = sym.Variable("data")
    net = data
    for i, nf in ((1, 20), (2, 50)):
        net = sym.Convolution(net, name="conv%d" % i, kernel=(5, 5),
                              num_filter=nf)
        net = sym.BatchNorm(net, name="bn%d" % i, fix_gamma=False)
        net = sym.Activation(net, name="tanh%d" % i, act_type="tanh")
        net = sym.Pooling(net, name="pool%d" % i, pool_type="max",
                          kernel=(2, 2), stride=(2, 2))
    net = sym.Flatten(net, name="flatten")
    net = sym.FullyConnected(net, name="fc1", num_hidden=500)
    net = sym.Activation(net, name="tanh3", act_type="tanh")
    net = sym.FullyConnected(net, name="fc2", num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name="softmax")


def mlp_halves(sym, num_classes=10):
    """get_mlp (128-64-classes, relu) cut in two for a SequentialModule:
    the features (data -> relu2) and the head (its data -> fc3 ->
    SoftmaxOutput, the module that takes the labels). `sym` is either
    package's symbol module."""
    net = sym.Flatten(sym.Variable("data"), name="flatten")
    for i, width in ((1, 128), (2, 64)):
        net = sym.FullyConnected(net, name="fc%d" % i, num_hidden=width)
        net = sym.Activation(net, name="relu%d" % i, act_type="relu")
    head = sym.FullyConnected(sym.Variable("data"), name="fc3",
                              num_hidden=num_classes)
    return net, sym.SoftmaxOutput(head, name="softmax")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


#: device cycles the card sleeps before each timed call (~0.5 ms at the
#: H100's 1.98 GHz), longer than the host takes to enqueue the call
SLEEP_CYCLES = 1_000_000


def time_ms(torch, fn, n=50, flush=None, sleep=True):
    """Mean device time of one call in ms: CUDA events around each call,
    with `flush` (an L2 eviction) run between calls outside the timed
    span, as the real caller finds the pool cold. Before each call the
    card sleeps (torch.cuda._sleep) while the host enqueues the call, so
    the span is the call's device time, not the host's enqueue: a call of
    a few microseconds behind a flush would otherwise wait tens of
    microseconds for the host between the first event and its kernel.
    `sleep=False` gives the span without the sleep, which then holds the
    host's enqueue of a call that is shorter than it (the attention rows
    report both)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        if flush is not None:
            flush()
        if sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / n


def paged_case(torch, np, dev, B, Tq, w, q_starts, dtype, seed, H=4,
               Dh=128, bs=16):
    """Random pool, distinct non-null table ids and queries for one
    paged_attention call."""
    rng = np.random.RandomState(seed)
    nb = B * w + 8
    k = torch.from_numpy(rng.standard_normal((nb, bs, H, Dh))
                         .astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal((nb, bs, H, Dh))
                         .astype(np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.standard_normal((B, Tq, H, Dh))
                         .astype(np.float32)).to(dev, dtype)
    tab = rng.permutation(np.arange(1, nb))[:B * w].reshape(B, w)
    tables = torch.from_numpy(tab.astype(np.int32)).to(dev)
    q_start = torch.tensor(q_starts, dtype=torch.int32, device=dev)
    return q, k, v, tables, q_start


def bound(pa, B, Tq, H, Dh, bs, w, q_starts, dtype_name, itemsize,
          kv_itemsize=None, scale_blocks=0):
    """Least time (ms) of one call on these inputs: each live block read
    once, q read and out written once, over the memory rate, against the
    flops over the peak rate for the input type. Only live blocks count:
    the kernel never reads a dead one. An int8 pool passes
    kv_itemsize=1 and its scales' num_blocks, counted whole as the
    reference's paged_call_cost counts them (the kernel reads only the
    live blocks' scales)."""
    flops = nbytes = 0
    for qs in q_starts:
        live = min(w, (qs + Tq - 1) // bs + 1)
        f, b = pa.paged_call_cost(1, Tq, H, Dh, live, bs,
                                  kv_itemsize=kv_itemsize or itemsize,
                                  q_itemsize=itemsize)
        flops += f
        nbytes += b
    nbytes += 2 * scale_blocks * H * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


#: K1's timed shapes over float pools, H=4, Dh=128: (label, B, Tq, w,
#: q_starts, block_size) — the last and a middle decode step of phase 4,
#: its second 32-row prefill chunk, and a k+1 = 4 scoring pass at phase
#: 7's lengths and block
PAGED_TIMED = [("decode", 8, 1, 16, [190] * 8, 16),
               ("decode_mid", 8, 1, 8, [127] * 8, 16),
               ("prefill_chunk", 1, 32, 4, [32], 16),
               ("spec_score", 8, 4, 16, [300, 310, 320, 330, 340, 350, 355,
                                         360], QUANT_BLOCK)]
#: K1 cases at the edges of its cluster split and query tile: (label, B,
#: Tq, w, q_starts) at H=4, Dh=128, bs=16, every pool type (the cluster
#: is min(8, w) blocks; a block's share of the live slots can be empty)
PAGED_EDGE_CASES = [
    ("one_live_slot", 4, 1, 16, [0, 3, 9, 15]),
    ("live_eq_cluster", 2, 1, 16, [127, 120]),        # 8 live slots
    ("live_cluster_minus_1", 2, 1, 16, [111, 100]),   # 7
    ("live_cluster_plus_1", 2, 1, 16, [128, 140]),    # 9
    ("w64_1024_tokens", 2, 1, 64, [1023, 777]),
    ("chunk64_mid_block", 1, 64, 8, [39]),
    ("ragged_live_counts", 4, 1, 64, [5, 1000, 40, 700]),   # 1, 63, 3, 44
    ("spec_ragged_live", 4, 4, 64, [0, 1016, 60, 500])]


def paged_check(torch, out, ref, dname, what):
    """Hold one K1 output to its plain version within TOL; return the
    largest error."""
    check(bool(torch.isfinite(out).all()),
          "kernel output not finite (%s)" % what)
    try:
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOL[dname], rtol=TOL[dname])
    except AssertionError as e:
        raise SmokeFailure("kernel != plain (%s): %s" % (what, e))
    return float((out.float() - ref.float()).abs().max())


def paged_repeat(torch, pa, args, kw, what):
    """Two calls of K1 on the same inputs must give the same bits (the
    cluster merges its partials in a fixed order, no atomics)."""
    a = pa.paged_attention(*args, **kw)
    b = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "K1 does not repeat bit for bit (%s)" % what)


def phase_kernels(torch, np, dev, card):
    """Hold the CUDA kernel against the plain version (the main path's
    shapes and PAGED_EDGE_CASES) and check that it repeats bit for bit;
    time both at the main path's shapes."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    H, Dh, bs = 4, 128, 16
    errs = {"float32": 0.0, "bfloat16": 0.0}
    ncases = 0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for w in (4, 16):
            top = w * bs
            cases = [  # decode B=8: ragged, incl. 0, mid-block, last slot
                (8, 1, [0, 5, bs + 5, 2 * bs, top // 2 + 3, top - bs - 1,
                        top - 2, top - 1]),
                # prefill chunk B=1, Tq=32: from 0 and from mid-block
                (1, 32, [0]), (1, 32, [top - 32 - 11]),
                # spec score B=8, Tq=k+1=4: ragged, incl. the last rows
                (8, 4, [0, 3, bs - 2, bs + 7, top // 2, top - bs - 3,
                        top - 5, top - 4])]
            for B, Tq, qst in cases:
                q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                              dtype, seed=ncases)
                out = pa.paged_attention(q, k, v, tab, qs, bs)
                ref = pa.paged_attention_plain(q, k, v, tab, qs, bs)
                torch.cuda.synchronize()
                errs[dname] = max(errs[dname], paged_check(
                    torch, out, ref, dname, "%s B=%d Tq=%d w=%d q_start=%s"
                    % (dname, B, Tq, w, qst)))
                ncases += 1
        for label, B, Tq, w, qst in PAGED_EDGE_CASES:
            q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                          dtype, seed=ncases)
            out = pa.paged_attention(q, k, v, tab, qs, bs)
            ref = pa.paged_attention_plain(q, k, v, tab, qs, bs)
            torch.cuda.synchronize()
            errs[dname] = max(errs[dname], paged_check(
                torch, out, ref, dname, "%s %s" % (dname, label)))
            paged_repeat(torch, pa, (q, k, v, tab, qs, bs), {},
                         "%s %s" % (dname, label))
            ncases += 1
    # the gate's shared-memory size is the one the kernel launches with
    from mxnet_tpu_torch.ops import _cuda
    lib = _cuda.library("paged_attention.cu")
    for d in range(16, 257, 16):
        for tbs in (1, 3, 16, 32, 48):
            for tq in (1, 4, 5, 16, 17, 64, 65):
                for isz in (4, 2, 1):
                    check(pa._smem_bytes(d, tbs, tq, isz)
                          == lib.mxtt_paged_smem_bytes(tq, d, tbs, isz),
                          "paged_limit's shared memory differs from the "
                          "kernel's at head_dim %d, block %d, %d rows, "
                          "itemsize %d" % (d, tbs, tq, isz))
    print("kernel check: %d cases (%d at the cluster and tile edges, each "
          "repeated bit for bit), max |kernel - plain| float32 %.3g (tol "
          "%g), bfloat16 %.3g (tol %g)"
          % (ncases, 2 * len(PAGED_EDGE_CASES), errs["float32"],
             TOL["float32"], errs["bfloat16"], TOL["bfloat16"]))

    # timing at the shapes the main path gives the kernel
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    for label, B, Tq, w, qst, tbs in PAGED_TIMED:
        for dname, dtype, itemsize in (("float32", torch.float32, 4),
                                       ("bfloat16", torch.bfloat16, 2)):
            q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                          dtype, seed=99, bs=tbs)
            t_k = time_ms(torch, lambda: pa.paged_attention(
                q, k, v, tab, qs, tbs), flush=flush)
            t_p = time_ms(torch, lambda: pa.paged_attention_plain(
                q, k, v, tab, qs, tbs), flush=flush)
            # yardstick only: SDPA over the already-gathered dense K/V
            # with the ragged mask (the port never calls it)
            idx = tab.long()
            kd = k[idx].reshape(B, w * tbs, H, Dh).transpose(1, 2)
            vd = v[idx].reshape(B, w * tbs, H, Dh).transpose(1, 2)
            qd = q.transpose(1, 2)
            kp = torch.arange(w * tbs, device=dev)
            qp = qs.long()[:, None] + torch.arange(Tq, device=dev)
            mask = (kp[None, None, :] <= qp[:, :, None])[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_l = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                          flush=flush)
            # the same two calls timed without the sleep (the span of PRs
            # 1-5, which holds the host's enqueue)
            t_k0 = time_ms(torch, lambda: pa.paged_attention(
                q, k, v, tab, qs, tbs), flush=flush, sleep=False)
            t_l0 = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                           flush=flush, sleep=False)
            b_ms, b_by, nbytes, flops = bound(pa, B, Tq, H, Dh, tbs, w, qst,
                                              dname, itemsize)
            rows.append({"card": card, "shape": label, "dtype": dname,
                         "B": B, "Tq": Tq,
                         "w": w, "bs": tbs, "q_start": qst[0], "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "ms_no_sleep": t_k0, "library_ms_no_sleep": t_l0,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound_bytes": nbytes, "bound_flops": flops})
    for r in rows:
        print("kernel timing: " + json.dumps(r))
    del flush_buf
    return errs, rows


def quantize_pool(torch, pool):
    """Per-(block, head) symmetric int8 of an (NB, bs, H, Dh) float pool
    (the reference's tests/test_serving_quant.py:87)."""
    s = pool.abs().amax(dim=(1, 3)).clamp(min=1e-12) / 127.0
    q = torch.clamp(torch.round(pool / s[:, None, :, None]), -127, 127)
    return q.to(torch.int8).contiguous(), s.contiguous()


#: int8 cases: (label, B, Tq, w, q_starts) at H=4, Dh=128, bs=32 — the
#: quantized decode step, the second 64-token prefill chunk, and a
#: speculative scoring pass (k+1 = 4 rows) of phase 7's lengths
INT8_CASES = [("decode", 8, 1, 8, [0, 5, 37, 64, 131, 200, 254, 255]),
              ("prefill_chunk", 1, 64, 4, [64]),
              ("spec_score", 8, 4, 8, [0, 33, 64, 100, 160, 200, 250, 252])]


def phase_kernels_int8(torch, np, dev, card):
    """The paged kernel's int8 variant against its plain version, q
    float32 and bfloat16 over int8 pools quantized from seeded float
    data; then the same shapes timed four ways."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    H, Dh, bs = 4, 128, QUANT_BLOCK
    errs = {"float32": 0.0, "bfloat16": 0.0}
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    nedge = 0
    for n, (label, B, Tq, w, qst) in enumerate(PAGED_EDGE_CASES):
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                          torch.float32, seed=200 + n)
            q = q.to(dtype)
            kq, ks = quantize_pool(torch, k)
            vq, vs = quantize_pool(torch, v)
            sc = dict(k_scale=ks, v_scale=vs)
            out = pa.paged_attention(q, kq, vq, tab, qs, 16, **sc)
            ref = pa.paged_attention_plain(q, kq, vq, tab, qs, 16, **sc)
            torch.cuda.synchronize()
            check(out.dtype == dtype, "int8 kernel output dtype %s"
                  % out.dtype)
            errs[dname] = max(errs[dname], paged_check(
                torch, out, ref, dname, "int8 %s q %s" % (label, dname)))
            paged_repeat(torch, pa, (q, kq, vq, tab, qs, 16), sc,
                         "int8 %s q %s" % (label, dname))
            nedge += 1
    rows = []
    for n, (label, B, Tq, w, qst) in enumerate(INT8_CASES):
        for dname, dtype, itemsize in (("float32", torch.float32, 4),
                                       ("bfloat16", torch.bfloat16, 2)):
            q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                          torch.float32, seed=100 + n,
                                          H=H, Dh=Dh, bs=bs)
            q = q.to(dtype)
            kq, ks = quantize_pool(torch, k)
            vq, vs = quantize_pool(torch, v)
            del k, v
            sc = dict(k_scale=ks, v_scale=vs)
            out = pa.paged_attention(q, kq, vq, tab, qs, bs, **sc)
            ref = pa.paged_attention_plain(q, kq, vq, tab, qs, bs, **sc)
            torch.cuda.synchronize()
            check(out.dtype == dtype, "int8 kernel output dtype %s"
                  % out.dtype)
            errs[dname] = max(errs[dname], paged_check(
                torch, out, ref, dname, "int8 %s, q %s, B=%d Tq=%d w=%d"
                % (label, dname, B, Tq, w)))
            t_k = time_ms(torch, lambda: pa.paged_attention(
                q, kq, vq, tab, qs, bs, **sc), flush=flush)
            t_p = time_ms(torch, lambda: pa.paged_attention_plain(
                q, kq, vq, tab, qs, bs, **sc), flush=flush)
            # yardstick only: SDPA over K/V gathered and dequantized
            # beforehand, with the ragged mask (the port never calls it)
            idx = tab.long()
            kd = (kq[idx].float() * ks[idx][:, :, None, :, None]).to(dtype)
            vd = (vq[idx].float() * vs[idx][:, :, None, :, None]).to(dtype)
            kd = kd.reshape(B, w * bs, H, Dh).transpose(1, 2)
            vd = vd.reshape(B, w * bs, H, Dh).transpose(1, 2)
            kp = torch.arange(w * bs, device=dev)
            qp = qs.long()[:, None] + torch.arange(Tq, device=dev)
            mask = (kp[None, None, :] <= qp[:, :, None])[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qd = q.transpose(1, 2)
            t_l = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                          flush=flush)
            t_k0 = time_ms(torch, lambda: pa.paged_attention(
                q, kq, vq, tab, qs, bs, **sc), flush=flush, sleep=False)
            t_l0 = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                           flush=flush, sleep=False)
            b_ms, b_by, nbytes, flops = bound(
                pa, B, Tq, H, Dh, bs, w, qst, dname, itemsize,
                kv_itemsize=1, scale_blocks=kq.shape[0])
            rows.append({"card": card, "shape": label, "q_dtype": dname,
                         "pool": "int8", "B": B, "Tq": Tq, "w": w,
                         "bs": bs, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "ms_no_sleep": t_k0,
                         "library_ms_no_sleep": t_l0, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_bytes": nbytes,
                         "bound_flops": flops})
    print("kernel check int8: %d cases (decode, prefill chunk, spec "
          "score, and %d at the cluster and tile edges, each repeated bit "
          "for bit), max |kernel - plain| q float32 %.3g (tol %g), q "
          "bfloat16 %.3g (tol %g)"
          % (2 * len(INT8_CASES) + nedge, nedge, errs["float32"],
             TOL["float32"], errs["bfloat16"], TOL["bfloat16"]))
    for r in rows:
        print("kernel timing int8: " + json.dumps(r))
    del flush_buf
    return errs, rows


def bench_params(np, cfg, seed=0):
    """Random weights of the full-width config from a numpy seed, in the
    reference's initialization (N(0, 0.02), unit/zero layer norms)."""
    from mxnet_tpu_torch.models.transformer import param_shapes
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_g"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("_b"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (0.02 * rng.standard_normal(shape)).astype(
                np.float32)
    return out


def gather_oracle(torch, np, serving, params, cfg, prompts, gen, dev,
                  paged=False, block_size=16, logits=None):
    """Greedy tokens and per-token top-2 logit margins from the port's
    float engine on the card: the gather path (Engine(paged=False)), or
    the float paged engine. With `logits` (a list) each request's logit
    rows are appended to it."""
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         block_size=block_size, paged=paged,
                         keep_logits=True, device=dev)
    toks, margins = [], []
    for lo in range(0, len(prompts), 8):
        seqs = [eng.start(list(p), max_new=gen) for p in prompts[lo:lo + 8]]
        while any(not s.done for s in seqs):
            eng.decode_step(seqs)
        for s in seqs:
            toks.append(s.generated)
            if logits is not None:
                logits.append(np.stack(s.token_logits))
            m = []
            for row in s.token_logits:
                top2 = np.partition(row, -2)[-2:]
                m.append(float(top2[1] - top2[0]))
            margins.append(m)
            eng.release(s)
    eng.close()
    return toks, margins


def compare_tokens(what, got, ref, margins, margin=MARGIN, quiet=False):
    """Greedy tokens `got` (one list per request) against the oracle's
    `ref`, stopping a request at its first near-tie (top-2 margin under
    `margin`). Returns how many tokens were compared."""
    compared = 0
    for i, toks in enumerate(got):
        for t, tok in enumerate(toks):
            if margins[i][t] < margin:
                if not quiet:
                    print("token check (%s): request %d stops at token %d "
                          "(top-2 margin %.3g < %.3g)"
                          % (what, i, t, margins[i][t], margin))
                break
            check(tok == ref[i][t],
                  "%s: request %d token %d: %d != oracle %d (margin %.3g)"
                  % (what, i, t, tok, ref[i][t], margins[i][t]))
            compared += 1
    return compared


def profile_decode(torch, serving, params, cfg, prompts, dev, steps=16,
                   label="profile", max_new=None, **engine_kw):
    """Where a steady paged decode step's time goes: device time by
    kernel from torch.profiler over `steps` steps of a batch of 8, beside
    the host wall time of the same (profiled) steps, on a paged engine
    (block 16 unless `engine_kw` says otherwise; its options too).
    Returns the greedy tokens the engine generated, for the caller to
    check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine_kw.setdefault("block_size", 16)
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         paged=True, device=dev, **engine_kw)
    seqs = [eng.start(list(p), max_new=max_new or steps + 8)
            for p in prompts]
    for _ in range(4):
        eng.decode_step(seqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode_step(seqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    toks = [list(s.generated) for s in seqs]
    for s in seqs:
        eng.release(s)
    eng.close()
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev_us[e.key] = e.self_device_time_total
    total = sum(dev_us.values())
    if total <= 0:
        print("%s: not measured (no device time recorded)" % label)
        return toks
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    print(label + ": " + json.dumps({
        "decode_steps": steps, "batch": len(seqs),
        "host_ms_per_step_profiled": 1e3 * wall / steps,
        "device_busy_ms_per_step": total / 1e3 / steps,
        "device_busy_share": total / 1e6 / wall,
        "kernels_us_per_step": {k: v / steps for k, v in top}}))
    return toks


def serve_traffic(serving, pa, params, cfg, prompts, gen, kw):
    """Phases 4 and 6's traffic through `serving.serve((params, cfg),
    **kw)`: a warm-up server (CUDA context, cuBLAS handles) closed first,
    then 8 in-process requests plus one HTTP POST /v1/generate at once.
    The kernel counters are set to 0 just before the requests and read
    just after. Checks every result and the request counters; returns
    (outs, wall_s, (float launches, int8 launches), snapshot, requests,
    engine)."""
    warm = serving.serve((params, cfg), **kw)
    try:
        warm.generate(prompts[0], max_new_tokens=4, timeout=300)
    finally:
        warm.close()

    srv = serving.serve((params, cfg), **kw)
    try:
        host, port = srv.serve_http(port=0, block=False)
        http_out = {}

        def post():
            body = json.dumps({"tokens": prompts[8],
                               "max_new_tokens": gen}).encode()
            req = urllib.request.Request(
                "http://%s:%d/v1/generate" % (host, port), data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    http_out["status"] = resp.status
                    http_out["body"] = json.loads(resp.read())
            except Exception as e:  # reported by the check below
                http_out["error"] = "%s: %s" % (type(e).__name__, e)

        pa.paged_attention.launches = 0
        pa.paged_attention.launches_int8 = 0
        t0 = time.perf_counter()
        client = threading.Thread(target=post, daemon=True)
        client.start()
        reqs = [srv.submit(p, max_new_tokens=gen) for p in prompts[:8]]
        outs = [r.result(timeout=600) for r in reqs]
        client.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = (pa.paged_attention.launches,
                    pa.paged_attention.launches_int8)
        check(not client.is_alive(), "HTTP request did not finish")
        snap = srv.snapshot()
    finally:
        srv.close()

    check("error" not in http_out, "HTTP request failed: %s"
          % http_out.get("error"))
    check(http_out.get("status") == 200, "HTTP status %r"
          % http_out.get("status"))
    outs.append(http_out["body"]["tokens"])
    for i, o in enumerate(outs):
        check(len(o) == gen, "request %d returned %d tokens, wanted %d"
              % (i, len(o), gen))
    req_snap = snap["requests"]
    check(req_snap["engine_failures"] == 0, "engine failures: %d"
          % req_snap["engine_failures"])
    check(req_snap["completed"] == len(prompts) and req_snap["failed"] == 0,
          "requests: %r" % req_snap)
    return outs, wall, launches, snap, reqs, srv.engine


def decode_step_mean_ms(snap):
    """Mean decode-step wall time (ms) out of a server snapshot, whose
    key tree is the reference's: the per-token mean times tokens over
    steps."""
    per_token = snap["latency_ms"]["decode_per_token_mean"]
    steps = snap["throughput"]["decode_steps"]
    if per_token is None or not steps:
        return None
    return per_token * snap["throughput"]["tokens_generated"] / steps


def phase_main_path(torch, np, dev, card):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    prompt_len, gen, n_req = PROMPT_LEN, GEN, N_REQ
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, prompt_len)]
               for _ in range(n_req)]
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
    outs, wall, (launches, _), snap, reqs, _ = serve_traffic(
        serving, pa, params, cfg, prompts, gen, kw)
    paths = snap["paths"]
    want = cfg.n_layers * (paths["paged_decode_steps"]
                           + paths["prefill_chunks"])
    check(launches == want and launches > 0,
          "paged kernel launched %d times, expected n_layers x (decode "
          "steps + prefill chunks) = %d x (%d + %d) = %d"
          % (launches, cfg.n_layers, paths["paged_decode_steps"],
             paths["prefill_chunks"], want))
    check(paths["gather_decode_steps"] == 0, "gather path ran on a paged "
          "server")

    # greedy tokens against the gather path on the card
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 gen, dev)
    compared = compare_tokens("served", outs, ref, margins)
    print("token check: %d of %d greedy tokens compared, all equal to the "
          "gather path" % (compared, n_req * gen))
    # a failure of this second paged engine fails the smoke like any other
    try:
        prof_toks = profile_decode(torch, serving, params, cfg, prompts[:8],
                                   dev)
    except SmokeFailure:
        raise
    except Exception as e:
        raise SmokeFailure("profiled paged decode failed: %s: %s"
                           % (type(e).__name__, e))
    compared = compare_tokens("profiled", prof_toks, ref, margins)
    check(compared > 0, "profiled decode: no token compared")
    print("token check (profiled): %d greedy tokens compared, all equal to "
          "the gather path" % compared)

    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs)
    lat = snap["latency_ms"]
    main = {"card": card, "requests": n_req, "tokens": n_req * gen,
            "wall_s": wall, "tokens_per_s": n_req * gen / wall,
            "ttft_p50_ms_inproc": 1e3 * float(np.median(ttfts)),
            "ttft_p95_ms_hist": lat["time_to_first_token_p95"],
            "decode_step_mean_ms": decode_step_mean_ms(snap),
            "decode_step_p50_ms": lat["decode_step_p50"],
            "decode_steps": paths["paged_decode_steps"],
            "prefill_chunks": paths["prefill_chunks"],
            "kernel_launches": launches}
    print("main path: " + json.dumps(main))
    return launches, main


def quant_logit_rows(np, serving, params, cfg, prompt, gen, dev):
    """One request's greedy tokens and logit rows on a quantized engine
    (int8 KV + int8 weights, one device): the baseline of the tp probe."""
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         block_size=QUANT_BLOCK, paged=True,
                         keep_logits=True, kv_quant=True,
                         weight_quant="int8", device=dev)
    seq = eng.start(list(prompt), gen)
    while not seq.done:
        eng.decode_step([seq])
    out = list(seq.generated), np.stack(seq.token_logits)
    eng.release(seq)
    eng.close()
    return out


def quant_logit_probe(np, serving, params, cfg, prompt, gen, dev,
                      ref_tokens, ref_logits, tp=1):
    """Max |logit - baseline| of one request on a fresh quantized engine
    (int8 KV + int8 weights; with `tp` > 1 sharded over the window
    [dev] * tp), TEACHER-FORCED on the baseline's tokens `ref_tokens`:
    before each decode step the input token is set to the baseline's, so
    every logit row is compared at the same context. Returns (max error,
    rows compared, argmax agreements)."""
    window = dict(tp=tp, devices=[dev] * tp) if tp > 1 else {}
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         block_size=QUANT_BLOCK, paged=True,
                         keep_logits=True, kv_quant=True,
                         weight_quant="int8", device=dev, **window)
    seq = eng.start(list(prompt), gen)
    i = 0
    while not seq.done:
        seq.tokens[-1] = int(ref_tokens[i])
        i += 1
        eng.decode_step([seq])
    rows = np.stack(seq.token_logits)
    eng.release(seq)
    eng.close()
    err = float(np.abs(rows - ref_logits).max())
    agree = int((rows.argmax(1) == ref_logits.argmax(1)).sum())
    return err, len(rows), agree


def phase_quant(torch, np, dev, card):
    """Phase 6: the quantized serving path at phase 4's config and
    traffic; int8 launches counted, tokens and logits against the float
    paged engine."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    gen, n_req = GEN, N_REQ
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, PROMPT_LEN)]
               for _ in range(n_req)]
    kw = dict(max_batch=8, paged=True, block_size=QUANT_BLOCK,
              token_budget=256, kv_quant=True, weight_quant="int8")
    outs, wall, (f32_launches, launches), snap, reqs, eng = serve_traffic(
        serving, pa, params, cfg, prompts, gen, kw)
    check(eng.kv_quant and eng.weight_quant == "int8",
          "quantized server: kv_quant %r, weight_quant %r"
          % (eng.kv_quant, eng.weight_quant))
    paths = snap["paths"]
    want = cfg.n_layers * (paths["paged_decode_steps"]
                           + paths["prefill_chunks"])
    check(launches == want and launches > 0,
          "int8 kernel launched %d times, expected n_layers x (decode "
          "steps + prefill chunks) = %d x (%d + %d) = %d"
          % (launches, cfg.n_layers, paths["paged_decode_steps"],
             paths["prefill_chunks"], want))
    check(f32_launches == 0 and paths["gather_decode_steps"] == 0,
          "the quantized server ran %d float paged launches and %d gather "
          "steps" % (f32_launches, paths["gather_decode_steps"]))

    ref_logits = []
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 gen, dev, paged=True,
                                 block_size=QUANT_BLOCK, logits=ref_logits)
    compared = compare_tokens("quantized", outs, ref, margins,
                              margin=QUANT_MARGIN, quiet=True)
    print("token check (quantized): %d of %d greedy tokens compared, each "
          "request up to its first top-2 margin under %g, all equal to the "
          "float paged engine" % (compared, n_req * gen, QUANT_MARGIN))
    err, nrows, agree = quant_logit_probe(np, serving, params, cfg,
                                          prompts[0], gen, dev, ref[0],
                                          ref_logits[0])
    print("logit probe (quantized, teacher-forced, %d rows): max |logit - "
          "float| %.5f (reference budget 0.05; bound %.4f = twice the JAX "
          "reference's own %.4f at this config); argmax equal on %d of %d "
          "rows" % (nrows, err, PROBE_BOUND, REF_QUANT_LOGIT_ERR, agree,
                    nrows))
    check(err <= PROBE_BOUND, "quantized logit error %.5f > %.4f"
          % (err, PROBE_BOUND))
    prof_toks = profile_decode(torch, serving, params, cfg, prompts[:8],
                               dev, label="profile (quantized)",
                               block_size=QUANT_BLOCK, kv_quant=True,
                               weight_quant="int8")
    n = compare_tokens("quantized, profiled", prof_toks, ref, margins,
                       margin=QUANT_MARGIN, quiet=True)
    print("token check (quantized, profiled): %d greedy tokens compared, "
          "all equal to the float paged engine" % n)
    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs)
    lat = snap["latency_ms"]
    main = {"card": card, "requests": n_req, "tokens": n_req * gen,
            "wall_s": wall, "tokens_per_s": n_req * gen / wall,
            "ttft_p50_ms_inproc": 1e3 * float(np.median(ttfts)),
            "decode_step_mean_ms": decode_step_mean_ms(snap),
            "decode_step_p50_ms": lat["decode_step_p50"],
            "decode_steps": paths["paged_decode_steps"],
            "prefill_chunks": paths["prefill_chunks"],
            "int8_kernel_launches": launches,
            "kv_bytes_per_token": snap["quant"][
                "serving_kv_quant_bytes_per_token"],
            "max_logit_err": err, "tokens_compared": compared}
    print("quant path: " + json.dumps(main))
    return launches, main


def serve_spec_prefix(serving, pa, params, cfg, prompts, quant):
    """Phase 7's traffic, requests one after another, through a server
    with a 2-layer self-draft (spec_k=3) and the prefix cache, over the
    int8 pool with int8 weights (`quant`) or the float pool. The kernel
    counters are set to 0 just before the requests and read just after.
    Checks every result, spec passes, prefix hits, COW copies, and that
    the pool's kernel variant ran n_layers x (plain decode steps +
    prefill chunks + spec passes) times and the other variant never.
    Returns (outs, wall_s, launches, snapshot)."""
    what = "int8" if quant else "float"
    kw = dict(kv_quant=True, weight_quant="int8") if quant else {}
    srv = serving.serve(
        (params, cfg), max_batch=8, paged=True, block_size=QUANT_BLOCK,
        token_budget=256, draft=serving.self_draft(params, cfg, DRAFT_LAYERS),
        spec_k=SPEC_K, prefix_cache=True, **kw)
    try:
        eng = srv.engine
        check(eng.spec and eng.prefix_cache is not None
              and eng.kv_quant == quant,
              "%s pool: spec %r (fallback %r), prefix cache %r, kv_quant %r"
              % (what, eng.spec, eng.spec_fallback, eng.prefix_cache,
                 eng.kv_quant))
        pa.paged_attention.launches = 0
        pa.paged_attention.launches_int8 = 0
        t0 = time.perf_counter()
        outs = [srv.generate(p, max_new_tokens=SPEC_GEN, timeout=600)
                for p in prompts]
        wall = time.perf_counter() - t0
        launches = (pa.paged_attention.launches_int8,
                    pa.paged_attention.launches)
        if not quant:
            launches = launches[::-1]
        snap = srv.snapshot()
    finally:
        srv.close()
    for i, o in enumerate(outs):
        check(len(o) == SPEC_GEN, "%s pool: request %d returned %d tokens, "
              "wanted %d" % (what, i, len(o), SPEC_GEN))
    paths, sp, pre = snap["paths"], snap["spec"], snap["cache"]["prefix"]
    check(snap["requests"]["engine_failures"] == 0, "%s pool: engine "
          "failures: %d" % (what, snap["requests"]["engine_failures"]))
    check(sp["passes"] > 0 and pre["hit_tokens"] > 0
          and pre["cow_copies"] >= N_SPEC_REQ - 1,
          "%s pool: spec passes %d, prefix hit tokens %d, COW copies %d "
          "(want > 0, > 0, >= %d)" % (what, sp["passes"], pre["hit_tokens"],
                                      pre["cow_copies"], N_SPEC_REQ - 1))
    plain = paths["paged_decode_steps"] - sp["passes"]
    want = cfg.n_layers * (plain + paths["prefill_chunks"] + sp["passes"])
    check(launches[0] == want and launches[1] == 0,
          "%s kernel launched %d times (the other variant %d), expected "
          "n_layers x (plain decode steps + prefill chunks + spec passes) "
          "= %d x (%d + %d + %d) = %d"
          % (what, launches[0], launches[1], cfg.n_layers, plain,
             paths["prefill_chunks"], sp["passes"], want))
    return outs, wall, launches[0], snap


def phase_spec_prefix(torch, np, dev, card):
    """Phase 7: speculative decoding and the prefix cache, 8 sequential
    requests sharing a 272-token prefix: first over the float pool, whose
    greedy tokens must equal the float paged engine's at phase 4's
    margin (the scoring pass, verification and COW copies switch speed,
    never tokens), then over the int8 pool with int8 weights, held to
    the quantized margin."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(2)
    shared = [int(t) for t in rng.randint(1, cfg.vocab, SHARED_LEN)]
    prompts = [shared + [int(t) for t in rng.randint(1, cfg.vocab,
                                                     SUFFIX_LEN)]
               for _ in range(N_SPEC_REQ)]
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 SPEC_GEN, dev, paged=True,
                                 block_size=QUANT_BLOCK)
    f_outs, f_wall, f_launches, f_snap = serve_spec_prefix(
        serving, pa, params, cfg, prompts, quant=False)
    f_compared = compare_tokens("spec+prefix, float pool", f_outs, ref,
                                margins)
    check(f_compared > 0, "spec+prefix, float pool: no token compared")
    print("token check (spec+prefix, float pool): %d of %d greedy tokens "
          "compared, all equal to the float paged engine"
          % (f_compared, N_SPEC_REQ * SPEC_GEN))

    outs, wall, launches, snap = serve_spec_prefix(
        serving, pa, params, cfg, prompts, quant=True)
    compared = compare_tokens("spec+prefix", outs, ref, margins,
                              margin=QUANT_MARGIN, quiet=True)
    print("token check (spec+prefix): %d of %d greedy tokens compared, each "
          "request up to its first top-2 margin under %g, all equal to the "
          "float paged engine" % (compared, N_SPEC_REQ * SPEC_GEN,
                                  QUANT_MARGIN))
    prof_toks = profile_decode(
        torch, serving, params, cfg, prompts, dev, steps=8,
        label="profile (spec+prefix)", max_new=SPEC_GEN,
        block_size=QUANT_BLOCK, kv_quant=True, weight_quant="int8",
        draft=serving.self_draft(params, cfg, DRAFT_LAYERS), spec_k=SPEC_K,
        prefix_cache=True)
    n = compare_tokens("spec+prefix, profiled", prof_toks, ref, margins,
                       margin=QUANT_MARGIN, quiet=True)
    print("token check (spec+prefix, profiled): %d greedy tokens compared, "
          "all equal to the float paged engine" % n)
    paths, sp, pre = snap["paths"], snap["spec"], snap["cache"]["prefix"]
    main = {"card": card, "requests": N_SPEC_REQ,
            "tokens": N_SPEC_REQ * SPEC_GEN, "wall_s": wall,
            "tokens_per_s": N_SPEC_REQ * SPEC_GEN / wall,
            "spec_k": sp["k"], "spec_passes": sp["passes"],
            "acceptance_rate": sp["acceptance_rate"],
            "accepted_per_pass": sp["accepted_per_pass"],
            "spec_fallbacks": sp["fallbacks"],
            "prefix_hit_tokens": pre["hit_tokens"],
            "prefix_hits": pre["hits"], "cow_copies": pre["cow_copies"],
            "plain_decode_steps": paths["paged_decode_steps"] - sp["passes"],
            "prefill_chunks": paths["prefill_chunks"],
            "int8_kernel_launches": launches,
            "decode_step_mean_ms": decode_step_mean_ms(snap),
            "tokens_compared": compared,
            "float_pool": {
                "tokens_per_s": N_SPEC_REQ * SPEC_GEN / f_wall,
                "spec_passes": f_snap["spec"]["passes"],
                "acceptance_rate": f_snap["spec"]["acceptance_rate"],
                "kernel_launches": f_launches,
                "decode_step_mean_ms": decode_step_mean_ms(f_snap),
                "tokens_compared": f_compared}}
    print("spec+prefix path: " + json.dumps(main))
    return launches, main


def ptxas_summary(log_path):
    """One entry per kernel of a build log: 'name<type,D,...>: N regs,
    S bytes spilled' from nvcc's -Xptxas -v lines."""
    out, name, spill = [], None, "0"
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                raw = m.group(1)
                k = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", raw)
                name = raw if k is None else "%s<%s>" % (
                    k.group(1), k.group(2).replace("13__nv_bfloat16", "bf16")
                    .replace("E", "").replace("Li", ","))
                continue
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out.append("%s: %s regs, %s B spill stores"
                           % (name, m.group(1), spill))
                name, spill = None, "0"
    return out


def build_kernels(_cuda):
    """Build every kernel source at once, one nvcc per source, each in a
    thread of its own; print each build's seconds and ptxas lines."""
    done = {}

    def one(src):
        t0 = time.perf_counter()
        try:
            _cuda.library(src)
            done[src] = (time.perf_counter() - t0, None)
        except Exception as e:  # reported below, per source
            done[src] = (time.perf_counter() - t0, e)

    threads = [threading.Thread(target=one, args=(src,)) for src in SOURCES]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for src in SOURCES:
        secs, err = done[src]
        check(err is None, "build of %s failed: %s" % (src, err))
        info = ptxas_summary(_cuda.target(src)[1])
        print("build %s: %.1f s; %d kernels" % (src, secs, len(info)))
        for line in info:
            print("  ptxas %s" % line)
    print("build: all sources in %.1f s" % (time.perf_counter() - t0))


def flash_bound(fa, BH, T, D, dtype_name, itemsize, backward):
    """Least time (ms) of one causal call at [BH, T, D]: each input read
    once and each output written once over the memory rate, against the
    flops of the live (query, key) pairs, T (T + 1) / 2 a row, over the
    peak rate for the input type."""
    flops, nbytes, _ = fa.flash_call_cost(BH, T, T, D, itemsize, nq=1,
                                          pairs=T * (T + 1) // 2,
                                          backward=backward)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_inputs(torch, np, dev, BH, T, Tk, D, dtype, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, dtype) for s in ((BH, T, D), (BH, Tk, D), (BH, Tk, D),
                                      (BH, T, D))]


#: flash kernel checks: (label, BH, T, Tk, D, causal); "main" is the
#: training path's shape (batch 8 x 8 heads, 1024 tokens, head_dim 64)
FLASH_CASES = [("main", 64, 1024, 1024, 64, True),
               ("ragged_1000", 8, 1000, 1000, 64, True),
               ("ragged_37", 8, 37, 37, 64, True),
               ("head_dim_128", 8, 512, 512, 128, True),
               ("ragged_d128", 4, 777, 777, 128, True),
               ("non_causal_tk", 8, 300, 517, 64, False)]
#: the TF32 tensor cores' dense peak (H100 SXM data sheet), over three:
#: the backward's products run as three TF32 products each (3xTF32)
TF32X3_OPS_S = 495e12 / 3


def library_kernels(torch, fn):
    """The names of the device kernels one call of `fn` runs
    (torch.profiler), so a yardstick's backend is on record."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.key[:80] for ev in prof.key_averages()
                   if ev.device_time_total > 0})


def flash_checks(torch, np, dev, cases):
    """Hold the flash forward (out, m, l) and backward (dq, dk, dv) against
    their plain versions over `cases` in float32 and bfloat16, and check
    that each direction repeats bit for bit; returns the largest errors,
    by (dtype, output)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    outputs = ("out", "m", "l", "dq", "dk", "dv")
    errs = {(d, w): 0.0 for d in FLASH_TOL for w in outputs}
    ncases = 0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol_f, tol_b = FLASH_TOL[dname]
        f32_tol = FLASH_TOL["float32"][0]
        for label, BH, T, Tk, D, causal in cases:
            q, k, v, g = flash_inputs(torch, np, dev, BH, T, Tk, D, dtype,
                                      seed=ncases)
            scale = D ** -0.5
            got = fa.flash_attention_fwd(q, k, v, scale, causal)
            againf = fa.flash_attention_fwd(q, k, v, scale, causal)
            want = fa.flash_fwd_plain(q, k, v, scale, causal)
            gotb = fa.flash_attention_bwd(q, k, v, got[0], got[1], got[2], g,
                                          scale, causal)
            wantb = fa.flash_bwd_plain(q, k, v, got[0], got[1], got[2], g,
                                       scale, causal)
            again = fa.flash_attention_bwd(q, k, v, got[0], got[1], got[2],
                                           g, scale, causal)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for kind, a, b in (("forward", got, againf),
                               ("backward", gotb, again)):
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      "flash %s does not repeat bit for bit (%s %s)"
                      % (kind, dname, label))
            for what, a, b, tol in (
                    ("out", got[0], want[0], tol_f),
                    ("m", got[1], want[1], f32_tol),
                    ("l", got[2], want[2], f32_tol),
                    ("dq", gotb[0], wantb[0], tol_b),
                    ("dk", gotb[1], wantb[1], tol_b),
                    ("dv", gotb[2], wantb[2], tol_b)):
                check(bool(torch.isfinite(a).all()),
                      "flash %s not finite (%s %s)" % (what, dname, label))
                err = float((a.float() - b.float()).abs().max())
                errs[dname, what] = max(errs[dname, what], err)
                try:
                    torch.testing.assert_close(a.float(), b.float(),
                                               atol=tol, rtol=tol)
                except AssertionError as e:
                    raise SmokeFailure("flash %s kernel != plain (%s %s "
                                       "BH=%d T=%d Tk=%d D=%d causal=%s): %s"
                                       % (what, dname, label, BH, T, Tk, D,
                                          causal, e))
            ncases += 1
    for dname in FLASH_TOL:
        print("flash kernel check %s: %d cases (forward and backward each "
              "repeated bit for bit), max |kernel - plain| %s; "
              "tol (atol = rtol) out %g, m and l %g, grads %g"
              % (dname, len(cases), ", ".join(
                  "%s %.3g" % (w, errs[dname, w]) for w in outputs),
                 FLASH_TOL[dname][0], FLASH_TOL["float32"][0],
                 FLASH_TOL[dname][1]))
    return errs


def phase_flash(torch, np, dev, card):
    """Hold the flash forward (out, m, l) and backward (dq, dk, dv)
    kernels against their plain versions, in float32 and bfloat16; time
    both directions at the training path's shape."""
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import flash_attention as fa
    errs = flash_checks(torch, np, dev, FLASH_CASES)
    # the shared memory the gate counts is the one the forward launches
    # with
    lib = _cuda.library("flash_attention.cu")
    for dtype, code in fa._DTYPE_CODE.items():
        for D in fa._HEAD_DIMS:
            check(fa.flash_fwd_smem_bytes(D, dtype)
                  == lib.mxtt_flash_fwd_smem_bytes(code, D),
                  "flash_fwd_smem_bytes differs from the kernel's at "
                  "head_dim %d, %s" % (D, dtype))

    # timing at the training path's shape; no L2 flush: the kernels are
    # bound by operations, and the step hands them fresh q/k/v
    _, BH, T, _, D, _ = FLASH_CASES[0]
    B, H = TRAIN_BATCH, BH // TRAIN_BATCH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dname, dtype, itemsize in (("float32", torch.float32, 4),
                                   ("bfloat16", torch.bfloat16, 2)):
        q, k, v, g = flash_inputs(torch, np, dev, BH, T, T, D, dtype,
                                  seed=99)
        scale = D ** -0.5
        out, m, l = fa.flash_attention_fwd(q, k, v, scale, True)
        t_f = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, scale, True), n=20)
        t_fp = time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, scale, True), n=20)
        t_b = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, m, l, g, scale, True), n=20)
        t_bp = time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, out, m, l, g, scale, True), n=20)
        # yardsticks only (the port never calls them): SDPA's causal
        # forward, and its autograd backward
        q4, k4, v4 = (t.view(B, H, T, D).detach().clone()
                      .requires_grad_(True) for t in (q, k, v))
        g4 = g.view(B, H, T, D)
        t_fl = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True),
                       n=20)
        o4 = sdpa(q4, k4, v4, is_causal=True)
        t_bl = time_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g4, retain_graph=True), n=20)
        del o4
        for kind, t_k, t_p, t_l in (("fwd", t_f, t_fp, t_fl),
                                    ("bwd", t_b, t_bp, t_bl)):
            b_ms, b_by = flash_bound(fa, BH, T, D, dname, itemsize,
                                     kind == "bwd")
            row = {"card": card, "kernel": "flash_attention_" + kind,
                   "dtype": dname, "BH": BH, "T": T, "D": D,
                   "causal": True, "ms": t_k, "plain_ms": t_p,
                   "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by}
            # both calls again without the sleep (a span that holds the
            # host's enqueue), and the library's kernels by name
            if kind == "fwd":
                row["ms_no_sleep"] = time_ms(
                    torch, lambda: fa.flash_attention_fwd(
                        q, k, v, scale, True), n=20, sleep=False)
                row["library_ms_no_sleep"] = time_ms(
                    torch, lambda: sdpa(q4, k4, v4, is_causal=True), n=20,
                    sleep=False)
                row["library_kernels"] = library_kernels(
                    torch, lambda: sdpa(q4, k4, v4, is_causal=True))
            else:
                row["ms_no_sleep"] = time_ms(
                    torch, lambda: fa.flash_attention_bwd(
                        q, k, v, out, m, l, g, scale, True), n=20,
                    sleep=False)
                o4 = sdpa(q4, k4, v4, is_causal=True)
                row["library_ms_no_sleep"] = time_ms(
                    torch, lambda: torch.autograd.grad(
                        o4, (q4, k4, v4), g4, retain_graph=True), n=20,
                    sleep=False)
                row["library_kernels"] = library_kernels(
                    torch, lambda: torch.autograd.grad(
                        o4, (q4, k4, v4), g4, retain_graph=True))
                del o4
            if dname == "float32" or kind == "bwd":
                # the same flops over the split-TF32 rate the products
                # run at (the backward's in both dtypes)
                flops = fa.flash_call_cost(BH, T, T, D, itemsize,
                                           pairs=T * (T + 1) // 2,
                                           backward=kind == "bwd")[0]
                row["bound_tf32x3_ms"] = flops / TF32X3_OPS_S * 1e3
            rows.append(row)
    # the layout copy the training path pays before the forward: the
    # (B, S, 3D) projection split into contiguous [B*H, S, Dh] q, k, v
    qkv = torch.randn(B, T, 3 * H * D, device=dev)

    def layout():
        for t in torch.split(qkv, H * D, dim=-1):
            t.reshape(B, T, H, D).transpose(1, 2).reshape(B * H, T, D)

    copy_ms = time_ms(torch, layout, n=20)
    for r in rows:
        print("flash timing: " + json.dumps(r))
    print("flash layout copy: %s" % json.dumps({
        "card": card, "what": "q, k, v views -> contiguous [BH, T, D], "
        "float32", "ms": copy_ms}))
    return errs, rows


def phase_train(torch, np, dev, card):
    """The training main path: make_transformer_train_step at the full
    width, flash on; oracle against the flag-off step, then the timed
    steps with the flash kernels' launches counted, then a profile."""
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        make_transformer_train_step)
    from mxnet_tpu_torch.models.transformer import lm_loss_and_grads
    from mxnet_tpu_torch.ops import flash_attention as fa
    cfg = TransformerConfig(dtype=torch.float32, **TRAIN_CFG)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab, (TRAIN_BATCH, cfg.max_len))
    run, params = make_transformer_train_step(cfg, lr=TRAIN_LR, seed=0,
                                              device=dev)
    tokens = torch.as_tensor(toks, dtype=torch.long, device=dev)
    prior = os.environ.get("MXNET_FLASH_ATTENTION")
    try:
        # oracle: the first step's loss and gradients, flag off vs on
        os.environ["MXNET_FLASH_ATTENTION"] = "0"
        ref_loss, ref_grads = lm_loss_and_grads(params, tokens, cfg)
        # noise floor: the same reference step as the mean of two half
        # batches (each half has the same number of targets)
        half = TRAIN_BATCH // 2
        _, ga = lm_loss_and_grads(params, tokens[:half], cfg)
        _, gb = lm_loss_and_grads(params, tokens[half:], cfg)
        floor = max(float(((ga[n] + gb[n]) / 2 - gr).norm())
                    / max(float(gr.norm()), 1e-30)
                    for n, gr in ref_grads.items())
        del ga, gb
        os.environ["MXNET_FLASH_ATTENTION"] = "1"
        n_f = fa.flash_attention_fwd.launches
        loss1, grads1 = lm_loss_and_grads(params, tokens, cfg)
        check(fa.flash_attention_fwd.launches > n_f,
              "flag on: the flash forward kernel did not launch")
        loss_err = abs(float(loss1) - float(ref_loss)) / abs(float(ref_loss))
        check(loss_err <= TRAIN_LOSS_RTOL,
              "first-step loss flash %r != reference %r (rel err %.3g > %g)"
              % (float(loss1), float(ref_loss), loss_err, TRAIN_LOSS_RTOL))
        worst, worst_name, worst_el, worst_el_name = 0.0, None, 0.0, None
        for name, gr in ref_grads.items():
            gf = grads1[name]
            check(bool(torch.isfinite(gf).all()), "grad %s not finite" % name)
            diff = gf - gr
            rel = float(diff.norm()) / max(float(gr.norm()), 1e-30)
            rel_el = float(diff.abs().max()) / max(
                float(gr.abs().max()), 1e-30)
            if rel >= worst:
                worst, worst_name = rel, name
            if rel_el >= worst_el:
                worst_el, worst_el_name = rel_el, name
        check(worst <= TRAIN_GRAD_TOL,
              "first-step grad %s: flash vs reference relative Frobenius "
              "error %.3g > %g" % (worst_name, worst, TRAIN_GRAD_TOL))
        print("train oracle: loss flash %.7f reference %.7f (rel err %.3g, "
              "tol %g); %d gradients, worst relative Frobenius error %.3g "
              "(%s, tol %g); largest element error %.3g of the tensor's "
              "largest element (%s); noise floor, the reference against "
              "itself over two half batches: worst relative Frobenius "
              "error %.3g"
              % (float(loss1), float(ref_loss), loss_err, TRAIN_LOSS_RTOL,
                 len(ref_grads), worst, worst_name, TRAIN_GRAD_TOL, worst_el,
                 worst_el_name, floor))
        del ref_grads, grads1

        # the main path: one warm-up step, then the timed steps
        fa.flash_attention_fwd.launches = 0
        fa.flash_attention_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        params, loss = run(params, toks)
        losses, times = [float(loss)], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = run(params, toks)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        want = cfg.n_layers * (TRAIN_STEPS + 1)
        check(launches == (want, want),
              "flash kernels launched %d (forward) and %d (backward) times, "
              "expected n_layers x steps = %d x %d = %d each"
              % (launches[0], launches[1], cfg.n_layers, TRAIN_STEPS + 1,
                 want))
        check(all(np.isfinite(losses)), "losses not finite: %r" % losses)
        check(losses[-1] < losses[0], "loss did not fall: %r" % losses)
        print("train repeat: the warm-up step's loss %.7f, the oracle's "
              "flag-on loss %.7f" % (losses[0], float(loss1)))
        try:
            profile_step(torch, "train", lambda: run(params, toks)[1])
        except SmokeFailure:
            raise
        except Exception as e:
            raise SmokeFailure("profiled training step failed: %s: %s"
                               % (type(e).__name__, e))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FLASH_ATTENTION", None)
        else:
            os.environ["MXNET_FLASH_ATTENTION"] = prior
    ms = sorted(1e3 * t for t in times)
    mean_ms = sum(ms) / len(ms)
    main = {"card": card, "steps_timed": TRAIN_STEPS,
            "grad_rel_err": worst, "grad_rel_err_noise_floor": floor,
            "batch": TRAIN_BATCH, "seq": cfg.max_len,
            "step_ms_mean": mean_ms, "step_ms_p50": float(np.median(ms)),
            "tokens_per_s": TRAIN_BATCH * cfg.max_len / (mean_ms / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "max_memory_allocated": peak,
            "flash_fwd_launches": launches[0],
            "flash_bwd_launches": launches[1]}
    print("train path: " + json.dumps(main))
    return launches, main


def bn_inputs(torch, dev, N, C, S, dtype, seed):
    """x (with per-channel offsets), dy, a residual, gamma and beta for
    one fused BatchNorm call on an [N, C, S] view, drawn on the device
    from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = (2 * randn(N, C, S) + randn(1, C, 1)).to(dtype)
    dy, res = randn(N, C, S).to(dtype), randn(N, C, S).to(dtype)
    gamma = torch.rand(C, generator=g, device=dev) + 0.5
    return x, dy, res, gamma, randn(C)


def bn_chain(torch, fb, x, dy, res, gamma, beta, relu, eps=1e-5):
    """The four kernels as the fused BatchNorm runs them, with the
    per-channel coefficients computed between them as the autograd
    Function computes them. Returns every kernel's inputs and outputs."""
    N, C, S = x.shape
    mean, var = fb.bn_stats(x)
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    offset = beta - mean * scale
    y = fb.bn_apply(x, scale, offset, res, relu)
    dz, sdz, sdx = fb.bn_bwd_reduce(dy, y, x, mean, inv, relu)
    c1, c2, c3 = fb.bn_coefficients(gamma, mean, var, sdz, sdx, None, None,
                                    eps, N * S)
    dx = fb.bn_bwd_dx(dz, x, c1, c2, c3)
    return dict(mean=mean, var=var, inv=inv, scale=scale, offset=offset,
                y=y, dz=dz, sdz=sdz, sdx=sdx, c=(c1, c2, c3), dx=dx)


def bn_check(torch, fb, x, dy, res, gamma, beta, relu, dname, errs, label):
    """Hold each kernel against its plain version on the same inputs (the
    kernel chain's own intermediates); record the largest errors."""
    N, C, S = x.shape
    k = bn_chain(torch, fb, x, dy, res, gamma, beta, relu)
    pm, pv = fb.bn_stats_plain(x)
    py = fb.bn_apply_plain(x, k["scale"], k["offset"], res, relu)
    pdz, psdz, psdx = fb.bn_bwd_reduce_plain(dy, k["y"], x, k["mean"],
                                             k["inv"], relu)
    pdx = fb.bn_bwd_dx_plain(k["dz"], x, *k["c"])
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    tol = BN_TOL[dname]
    sum_atol = BN_SUM_RTOL * (N * S) ** 0.5
    for kern, what, a, b, atol, rtol in (
            ("stats", "mean", k["mean"], pm, BN_STATS_TOL, BN_STATS_TOL),
            ("stats", "var", k["var"], pv, BN_STATS_TOL, BN_STATS_TOL),
            ("apply", "y", k["y"], py, tol, tol),
            ("bwd_reduce", "dz", k["dz"], pdz, 0.0, 0.0),
            ("bwd_reduce", "sum dz", k["sdz"], psdz, sum_atol, BN_SUM_RTOL),
            ("bwd_reduce", "sum dz xhat", k["sdx"], psdx, sum_atol,
             BN_SUM_RTOL),
            ("bwd_dx", "dx", k["dx"], pdx, tol, tol)):
        check(bool(torch.isfinite(a).all()),
              "fused_bn %s %s not finite (%s %s)" % (kern, what, dname, label))
        err = float((a.float() - b.float()).abs().max())
        for key in ((kern, dname), (kern, dname, N, C, S)):  # the shape's
            errs[key] = max(errs.get(key, 0.0), err)         # for its rows
        try:
            torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                       rtol=rtol)
        except AssertionError as e:
            raise SmokeFailure("fused_bn %s %s: kernel != plain (%s %s): %s"
                               % (kern, what, dname, label, e))


def bn_bound(fb, kind, N, C, S, itemsize, relu, res):
    """Least time (ms) of one call: the reference's declared bytes over
    the memory rate against its flops over the float32 peak (the kernels
    compute in float32 whatever the activation type)."""
    flops, nbytes = fb.fused_bn_call_cost(kind, N, C, S, itemsize, relu=relu,
                                          residual=res)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bn_library_calls(torch, x, dy, res, relu, gamma, beta, k):
    """{kind: (call, error)} for each kernel whose function one PyTorch
    call computes on these inputs, the calls SyncBatchNorm makes (the
    port never calls them): torch.var_mean for K3a;
    torch.batch_norm_elemt for K3b without residual or relu;
    torch.batch_norm_backward_reduce for K3c without relu (its
    sum dy (x - mean), times inv, is K3c's sum dz xhat);
    torch.batch_norm_backward_elemt for K3d (the mean and var cotangents
    zero). `error()` is the largest |call - kernel| over the kernel's
    outputs (k, bn_chain's); a kind without such a call is absent."""
    N, C, S = x.shape
    mean, inv = k["mean"], k["inv"]
    count = torch.tensor([N * S], dtype=torch.int32, device=x.device)
    xmu = k["sdx"] / inv

    def err(pairs):
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in pairs)

    def var_mean():
        return torch.var_mean(x, dim=(0, 2), correction=0)

    def bwd_dx():
        return torch.batch_norm_backward_elemt(k["dz"], x, mean, inv, gamma,
                                               k["sdz"], xmu, count)
    calls = {"stats": (var_mean, lambda: err(zip(var_mean(),
                                                  (k["var"], k["mean"])))),
             "bwd_dx": (bwd_dx, lambda: err([(bwd_dx(), k["dx"])]))}
    if res is None and not relu:
        def apply():
            return torch.batch_norm_elemt(x, gamma, beta, mean, inv, 1e-5)
        calls["apply"] = (apply, lambda: err([(apply(), k["y"])]))
    if not relu:
        def bwd_reduce():
            return torch.batch_norm_backward_reduce(dy, x, mean, inv, gamma,
                                                    True, False, False)
        calls["bwd_reduce"] = (bwd_reduce, lambda: err(zip(
            bwd_reduce()[:2], (k["sdz"], k["sdx"] / inv))))
    return calls


def bn_time(torch, fb, dev, C, H, W, relu, res, dtype, flush, n=10,
            N=R50_BATCH):
    """Times (ms) at one of the main path's BatchNorm shapes (batch N):
    each kernel, its plain version, and the library yardsticks the port
    never calls: the one call that computes a kernel's function
    (bn_library_calls; None where there is none), and cuDNN's batch norm
    (+ add + relu) forward against K3a + K3b, its autograd backward
    against K3c + K3d. Returns ({kind: (ms, plain_ms, library_ms,
    library_max_abs_err)}, pair_fwd, pair_bwd)."""
    F = torch.nn.functional
    S = H * W
    x, dy, r, gamma, beta = bn_inputs(torch, dev, N, C, S, dtype, seed=C + S)
    r = r if res else None
    k = bn_chain(torch, fb, x, dy, r, gamma, beta, relu)
    c = k["c"]
    lib = bn_library_calls(torch, x, dy, r, relu, gamma, beta, k)
    kernel = {
        "stats": (lambda: fb.bn_stats(x), lambda: fb.bn_stats_plain(x)),
        "apply": (lambda: fb.bn_apply(x, k["scale"], k["offset"], r, relu),
                  lambda: fb.bn_apply_plain(x, k["scale"], k["offset"], r,
                                            relu)),
        "bwd_reduce": (lambda: fb.bn_bwd_reduce(dy, k["y"], x, k["mean"],
                                                k["inv"], relu),
                       lambda: fb.bn_bwd_reduce_plain(
                           dy, k["y"], x, k["mean"], k["inv"], relu)),
        "bwd_dx": (lambda: fb.bn_bwd_dx(k["dz"], x, *c),
                   lambda: fb.bn_bwd_dx_plain(k["dz"], x, *c))}
    t = {}
    for kind, (fn, plain) in kernel.items():
        call, err = lib.get(kind, (None, None))
        t[kind] = (time_ms(torch, fn, n, flush), time_ms(torch, plain, n, flush),
                   None if call is None else time_ms(torch, call, n, flush),
                   None if call is None else err())
    x4 = x.view(N, C, H, W).detach().requires_grad_(True)
    w4 = gamma.to(dtype).requires_grad_(True)
    b4 = beta.to(dtype).requires_grad_(True)
    r4 = None if r is None else r.view(N, C, H, W)

    def bn_fwd():
        out = F.batch_norm(x4, None, None, w4, b4, training=True, eps=1e-5)
        if r4 is not None:
            out = out + r4
        return F.relu(out) if relu else out

    pair_fwd = time_ms(torch, bn_fwd, n, flush)
    out = bn_fwd()
    dy4 = dy.view(N, C, H, W)
    pair_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (x4, w4, b4), dy4, retain_graph=True), n, flush)
    return t, pair_fwd, pair_bwd


def bn_time_row(fb, t, kind, N, C, S, itemsize, relu, res):
    """One kernel's entry of a timing row: its time, its plain version's,
    the library call's (and its largest |call - kernel|) where there is
    one, and its bound."""
    b_ms, b_by = bn_bound(fb, kind, N, C, S, itemsize, relu, res)
    ms, plain_ms, lib_ms, lib_err = t[kind]
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_max_abs_err": lib_err, "bound_ms": b_ms,
            "bound_by": b_by}


def bn_add_total(total, one, count):
    """Add one shape's entry (count calls a step) to a kernel's step sums:
    the library call's over the calls it covers, beside the kernel's over
    the same calls."""
    total["ms"] += count * one["ms"]
    total["plain_ms"] += count * one["plain_ms"]
    total["bound_ms"] += count * one["bound_ms"]
    if one["bound_by"] == "bytes":
        total["bytes_bound_ms"] += count * one["bound_ms"]
    if one["library_ms"] is not None:
        total["library_ms"] = (total["library_ms"] or 0.0) \
            + count * one["library_ms"]
        total["library_calls"] += count
        total["ms_library_calls"] += count * one["ms"]


def bn_totals(kinds):
    return {kind: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_bound_ms": 0.0, "library_ms": None,
                   "library_calls": 0, "ms_library_calls": 0.0}
            for kind in kinds}


def phase_kernels_bn(torch, np, dev, card):
    """K3a-d against their plain versions at every BatchNorm shape of a
    batch-256 ResNet-50 step and the extra cases, in float32 and
    bfloat16, and at every BatchNorm of phase 14's float32 batch-128 step
    (with and without the epilogue); then times at the main path's shapes in bfloat16 (the timed
    run's type), summed over one step's 53 BatchNorms, and the stem's
    shape in float32."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    errs, ncases = {}, 0
    cases = [(R50_BATCH, C, H, W, relu, res)
             for C, H, W, relu, res, _ in R50_BNS] + BN_EXTRA
    # phase 14's float32 step at batch G50_BATCH: each variant of R50_BNS
    # (the eager step's fused epilogue) and the plain BatchNorm at every
    # shape (the hybridized graph's BatchNorm nodes)
    g50 = sorted({(C, H, W, relu, res) for C, H, W, relu, res, _ in R50_BNS}
                 | {(C, H, W, False, False) for C, H, W, *_ in R50_BNS})
    by_dtype = {"float32": cases + [(G50_BATCH,) + c for c in g50],
                "bfloat16": cases}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for N, C, H, W, relu, res in by_dtype[dname]:
            x, dy, r, gamma, beta = bn_inputs(torch, dev, N, C, H * W,
                                              dtype, seed=ncases)
            bn_check(torch, fb, x, dy, r if res else None, gamma, beta, relu,
                     dname, errs, "N=%d C=%d H=%d W=%d relu=%s residual=%s"
                     % (N, C, H, W, relu, res))
            del x, dy, r
            ncases += 1
    print("fused_bn K3c clusters the card runs at once, by cluster size: "
          + json.dumps({"%s relu=%d" % (dname, relu): fb.reduce_clusters_at_once(
              dev, dtype, relu) for dname, dtype in (
                  ("float32", torch.float32), ("bfloat16", torch.bfloat16))
              for relu in (0, 1)}))
    for dname in ("float32", "bfloat16"):
        print("fused_bn kernel check %s: %d cases, max |kernel - plain| %s; "
              "tol (atol = rtol) stats %g, y and dx %g, dz exact, channel "
              "sums rtol %g atol %g x sqrt(N S)"
              % (dname, len(by_dtype[dname]), ", ".join(
                  "%s %.3g" % (kern, errs[kern, dname]) for kern in
                  ("stats", "apply", "bwd_reduce", "bwd_dx")),
                 BN_STATS_TOL, BN_TOL[dname], BN_SUM_RTOL, BN_SUM_RTOL))

    # timings, the L2 flushed between calls: the step finds each
    # activation cold, as it was written a whole layer earlier
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()

    kinds = ("stats", "apply", "bwd_reduce", "bwd_dx")
    total = bn_totals(kinds)
    pairs = {"fwd_kernels_ms": 0.0, "fwd_library_ms": 0.0,
             "bwd_kernels_ms": 0.0, "bwd_library_ms": 0.0}
    rows = []
    for dname, dtype, itemsize, configs in (
            ("bfloat16", torch.bfloat16, 2, R50_BNS),
            ("float32", torch.float32, 4, R50_BNS[:1])):
        for C, H, W, relu, res, count in configs:
            t, pair_fwd, pair_bwd = bn_time(torch, fb, dev, C, H, W, relu,
                                            res, dtype, flush)
            row = {"card": card, "dtype": dname, "N": R50_BATCH, "C": C,
                   "H": H, "W": W, "relu": relu, "residual": res,
                   "per_step": count, "library_pair_fwd_ms": pair_fwd,
                   "library_pair_bwd_ms": pair_bwd}
            for kind in kinds:
                row[kind] = bn_time_row(fb, t, kind, R50_BATCH, C, H * W,
                                        itemsize, relu, res)
                if dname == "bfloat16":
                    bn_add_total(total[kind], row[kind], count)
            if dname == "bfloat16":
                pairs["fwd_kernels_ms"] += count * (t["stats"][0]
                                                    + t["apply"][0])
                pairs["bwd_kernels_ms"] += count * (t["bwd_reduce"][0]
                                                    + t["bwd_dx"][0])
                pairs["fwd_library_ms"] += count * pair_fwd
                pairs["bwd_library_ms"] += count * pair_bwd
            rows.append(row)
            print("fused_bn timing: " + json.dumps(row))
    del scratch
    for kind in SHAPE_ROW_KINDS:
        for r in bn_shape_rows(rows, errs, kind):
            print("fused_bn %s per shape: %s" % (kind, json.dumps(r)))
    print("fused_bn step totals (bfloat16, one batch-256 ResNet-50 step's "
          "53 calls of each kernel): " + json.dumps(
              {"card": card, "kernels": total, "pairs_vs_cudnn": pairs}))
    return errs, total


#: the kernels phase 8 prints a row a shape for: all four, each with the
#: library call beside it where one computes its function
SHAPE_ROW_KINDS = ("stats", "apply", "bwd_reduce", "bwd_dx")


def bn_shape_rows(rows, errs, kind):
    """One kernel's per-shape rows from phase 8's timing rows: every
    BatchNorm shape of the step in bfloat16 (S = 196 and 49 among them,
    rows that are not a whole number of 8-element vectors) and the stem's
    in float32, each with its time, bound, their ratio, the library
    call's time where there is one (bn_library_calls) and the largest
    |kernel - plain| at that shape in phase 8's check."""
    out = []
    for r in rows:
        S, t = r["H"] * r["W"], r[kind]
        out.append({"card": r["card"], "kernel": "fused_bn_" + kind,
                    "dtype": r["dtype"], "N": r["N"], "C": r["C"], "S": S,
                    "per_step": r["per_step"], "ms": t["ms"],
                    "bound_ms": t["bound_ms"],
                    "over_bound": t["ms"] / t["bound_ms"],
                    "library_ms": t["library_ms"],
                    "library_over_kernel": (None if t["library_ms"] is None
                                            else t["library_ms"] / t["ms"]),
                    "library_max_abs_err": t.get("library_max_abs_err"),
                    "max_abs_err": errs.get((kind, r["dtype"], r["N"],
                                             r["C"], S))})
    return out


def profile_step(torch, what, fn):
    """Where one step's time goes: device time by kernel from
    torch.profiler over one call of `fn`, beside its host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(bool(torch.isfinite(loss)), "%s profile: loss not finite" % what)
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev_us[e.key] = e.self_device_time_total
    total = sum(dev_us.values())
    if total <= 0:
        print("%s profile: not measured (no device time recorded)" % what)
        return None
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    summary = {"steps": 1, "host_ms_profiled": 1e3 * wall,
               "device_busy_ms": total / 1e3,
               "device_busy_share": total / 1e6 / wall,
               "kernels_us": dict(top)}
    print("%s profile: %s" % (what, json.dumps(summary)))
    return summary


def rel_frobenius(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def resnet_first_step_check(torch, fb, step, x, y, what="resnet50"):
    """The first step's loss and gradients in float32 (TF32 off), flag on
    against flag off, beside the flag-off step's own floor: a second run
    of it, and a run with the input moved by one ulp. `step` has
    `loss_and_grads(x, y)` -> (loss, {name: gradient}): a TrainStep, or
    a GluonGrads."""
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "0"
    n0 = fb.launch_counts()
    loss_off, g_off = step.loss_and_grads(x, y)
    _, g_again = step.loss_and_grads(x, y)
    x_ulp = torch.nextafter(x, torch.full_like(x, float("inf")))
    _, g_ulp = step.loss_and_grads(x_ulp, y)
    check(fb.launch_counts() == n0, "flag off: a fused kernel launched")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    loss_on, g_on = step.loss_and_grads(x, y)
    check(all(b > a for a, b in zip(n0, fb.launch_counts())),
          "flag on: a fused kernel did not launch")
    loss_err = abs(float(loss_on) - float(loss_off)) / abs(float(loss_off))
    check(loss_err <= R50_LOSS_RTOL,
          "first-step loss flag on %r != flag off %r (rel err %.3g > %g)"
          % (float(loss_on), float(loss_off), loss_err, R50_LOSS_RTOL))
    top = max(float(g.abs().max()) for g in g_off.values())
    zero = [n for n in g_off if "conv2d" in n and n.endswith("_bias")]
    worst, floor, worst_zero = (0.0, ""), (0.0, ""), 0.0
    for n, g in g_off.items():
        check(bool(torch.isfinite(g_on[n]).all()), "grad %s not finite" % n)
        if n in zero:
            worst_zero = max(worst_zero, float(g_on[n].abs().max()) / top,
                             float(g.abs().max()) / top)
            continue
        worst = max(worst, (rel_frobenius(g_on[n], g), n))
        floor = max(floor, (rel_frobenius(g_again[n], g), n),
                    (rel_frobenius(g_ulp[n], g), n))
    tol = max(2 * floor[0], R50_GRAD_MIN_TOL)
    check(worst[0] <= tol,
          "first-step grad %s: flag on vs off relative Frobenius error "
          "%.3g > max(2 x floor %.3g, %g)" % (worst[1], worst[0], floor[0],
                                              R50_GRAD_MIN_TOL))
    check(worst_zero <= R50_ZERO_GRAD,
          "a conv bias feeding a BatchNorm has a gradient of %.3g of the "
          "largest gradient element (> %g)" % (worst_zero, R50_ZERO_GRAD))
    again = max(rel_frobenius(g_again[n], g) for n, g in g_off.items()
                if n not in zero)
    ulp = max(rel_frobenius(g_ulp[n], g) for n, g in g_off.items()
              if n not in zero)
    print(what + " oracle: loss flag on %.7f off %.7f (rel err %.3g, tol "
          "%g); %d gradients, worst relative Frobenius error %.3g (%s), tol "
          "max(2 x floor, %g) = %.3g; floor %.3g (%s): flag off against a "
          "second run %.3g, against the input moved one ulp %.3g; the %d "
          "conv biases feeding a BatchNorm at most %.3g of the largest "
          "gradient element"
          % (float(loss_on), float(loss_off), loss_err, R50_LOSS_RTOL,
             len(g_off), worst[0], worst[1], R50_GRAD_MIN_TOL, tol, floor[0],
             floor[1], again, ulp, len(zero), worst_zero))
    return {"grad_rel_err": worst[0], "grad_floor": floor[0],
            "grad_floor_second_run": again, "grad_floor_one_ulp": ulp,
            "loss_rel_err": loss_err}


def resnet_timed_run(torch, np, step, x, y, dev):
    """One warm-up step and R50_STEPS timed ones: (losses, step seconds,
    peak bytes)."""
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [float(step(x, y))], []
    for _ in range(R50_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), "losses not finite: %r" % losses)
    return losses, times, torch.cuda.max_memory_allocated(dev)


def phase_resnet(torch, np, dev, card):
    """The framework core's main path: model-zoo ResNet-50 v1 trained
    through TrainStep with MXNET_FUSED_BN_EPILOGUE=1 at bench.py's
    config. The first step in float32 against the flag off; then one
    warm-up and R50_STEPS timed bfloat16 steps, each K3 kernel launched
    53 times a step; the same steps with the flag off, for comparison;
    a profiled step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.parallel import TrainStep
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    try:
        net = vision.resnet50_v1(classes=R50_CLASSES)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 3, R50_IMAGE, R50_IMAGE)))   # on the card
        params = net.collect_params()
        check(all(p.data()._data.device == dev for p in params.values()),
              "the net's parameters are not on %s" % dev)
        saved = {n: p.data()._data.detach().clone()
                 for n, p in params.items()}
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.uniform(
            -1, 1, (R50_BATCH, 3, R50_IMAGE, R50_IMAGE)).astype(
                np.float32)).to(dev)
        y = torch.from_numpy(rng.randint(0, R50_CLASSES, (R50_BATCH,))
                             .astype(np.int32)).to(dev)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        oracle = resnet_first_step_check(
            torch, fb, TrainStep(net, loss_fn, "sgd", dict(R50_OPT)), x, y)

        # the main path: bf16 mixed precision, the flag on
        os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
        step = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                         dtype="bfloat16")
        fb.reset_launch_counts()
        losses, times, peak = resnet_timed_run(torch, np, step, x, y, dev)
        launches = fb.launch_counts()
        want = 53 * (R50_STEPS + 1)
        check(launches == (want,) * 4,
              "K3a-d launched %r times over %d steps, expected 53 x %d = %d "
              "each" % (launches, R50_STEPS + 1, R50_STEPS + 1, want))
        check(losses[-1] < losses[0], "loss did not fall: %r" % losses)

        # the same steps from the same weights with the flag off
        for n, p in params.items():
            p.set_data(saved[n])
        os.environ["MXNET_FUSED_BN_EPILOGUE"] = "0"
        step_off = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                             dtype="bfloat16")
        fb.reset_launch_counts()
        losses_off, times_off, peak_off = resnet_timed_run(
            torch, np, step_off, x, y, dev)
        check(fb.launch_counts() == (0,) * 4,
              "flag off: fused kernels launched %r" % (fb.launch_counts(),))
        os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
        try:
            profile_step(torch, "resnet50 train", lambda: step(x, y))
        except SmokeFailure:
            raise
        except Exception as e:
            raise SmokeFailure("profiled ResNet-50 step failed: %s: %s"
                               % (type(e).__name__, e))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior

    def summary(ts, ls, pk):
        ms = sorted(1e3 * t for t in ts)
        mean_ms = sum(ms) / len(ms)
        return {"step_ms_mean": mean_ms, "step_ms_p50": float(np.median(ms)),
                "img_per_s": R50_BATCH / (mean_ms / 1e3),
                "loss_first": ls[0], "loss_last": ls[-1],
                "max_memory_allocated": pk}

    main = {"card": card, "model": "resnet50_v1", "batch": R50_BATCH,
            "image": R50_IMAGE, "dtype": "bfloat16", "steps_timed": R50_STEPS,
            "fused_bn_epilogue": summary(times, losses, peak),
            "flag_off": summary(times_off, losses_off, peak_off),
            "first_step_float32": oracle,
            "k3_launches": dict(zip(("stats", "apply", "bwd_reduce",
                                     "bwd_dx"), launches))}
    print("resnet50 train path: " + json.dumps(main))
    return launches, main


def bn_kernel_rows(errs, totals, by_path, inception_totals):
    """K3a-d's entries of the kernels line: the per-step sums over one
    bf16 batch-256 ResNet-50 step's 53 calls (phase 8's timings at the
    main path's shapes), the launches of every path that runs them (phase
    9's TrainStep, phase 12b's executor, phase 14's and phase 16b's eager
    and hybridized Gluon steps, phase 16c's steps), summed and split in
    `launches_by_path`, the largest float32 kernel-vs-plain error (phases
    8 and 16), and under `inception_v3_step` phase 16's sums over a
    float32 batch-128 Inception-v3 step's 94 calls. `library_ms` sums the
    library call (bn_library_calls) over the `library_calls` of the 53
    it covers, beside the kernel's `ms_library_calls` over the same."""
    rows = []
    for i, (kind, line) in enumerate((("stats", 134), ("apply", 183),
                                      ("bwd_reduce", 233), ("bwd_dx", 320))):
        tot = totals[kind]
        split = {path: counts[i] for path, counts in by_path.items()}
        rows.append({
            "name": "fused_bn_" + kind,
            "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/fused_bn.cu",
            "replaces": "mxnet_tpu/ops/pallas_fused.py:%d" % line,
            "launches": sum(split.values()),
            "launches_by_path": split,
            "max_abs_err": errs[kind, "float32"],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            # what bounds most of the step's calls of this kernel
            "bound_by": ("bytes" if 2 * tot["bytes_bound_ms"]
                         >= tot["bound_ms"] else "operations"),
            "library_ms": tot["library_ms"],
            "library_calls": tot["library_calls"],
            "ms_library_calls": tot["ms_library_calls"],
            "inception_v3_step": inception_totals[kind],
        })
    return rows


def rnn_check(torch, fr, mode, a, reverse, dname, errs, label):
    """Hold K4a, then K4b on K4a's outputs, to the plain versions fed with
    the kernels' own previous outputs (fr.fed_plain), within
    fr.PLAIN_TOL; record the largest errors (absolute, and relative
    Frobenius) and return the kernels' outputs, by name."""
    got = fr.chain(mode, a, reverse)
    want = fr.fed_plain(mode, a, got, reverse)
    torch.cuda.synchronize()
    for what in fr.OUTPUTS:
        x, y = got[what], want[what]
        if x is None:
            check(y is None, "fused_rnn %s: the kernel returned none, "
                  "the plain version one" % what)
            continue
        check(bool(torch.isfinite(x).all()),
              "fused_rnn %s not finite (%s %s)" % (what, dname, label))
        kern = "fwd" if what in fr.OUTPUTS[:4] else "bwd"
        fro, _, err = fr.plain_error(x, y)
        errs[kern, dname] = max(errs.get((kern, dname), 0.0), err)
        errs["fro", dname] = max(errs.get(("fro", dname), 0.0), fro)
        bad = fr.plain_mismatch(x, y)
        check(bad is None, "fused_rnn %s %s: kernel != plain (%s %s): %s"
              % (kern, what, dname, label, bad))
    return got


def rnn_planted_faults(torch, fr, a, got):
    """The limits must reject a wrong kernel: faults planted into the
    kernels' results at the path's shape, each held to the plain versions
    fed with the faulty results as phase 10 holds the kernels: dWh
    zeroed, dh0 halved, dc0's sign flipped, dpx halved; in bf16 also the
    forward without h's rounding before its product and the backward
    without dpre's (the plain versions in float32 on the same values,
    rounded at the end)."""
    dtype = a["px"].dtype
    planted = {"dwh zeroed": {"dwh": got["dwh"] * 0},
               "dh0 halved": {"dh0": got["dh0"] * 0.5},
               "dc0 flipped": {"dc0": -got["dc0"]},
               "dpx halved": {"dpx": got["dpx"] * 0.5}}
    if dtype == torch.bfloat16:
        f32 = {k: v.float() for k, v in a.items()}
        ys, cs, hT, cT = fr.rnn_fwd_plain("lstm", f32["px"], f32["h0"],
                                          f32["c0"], f32["wh"])
        planted["h unrounded"] = {"ys": ys.to(dtype), "cs": cs.to(dtype),
                                  "hT": hT.to(dtype), "cT": cT.to(dtype)}
        hprev = fr._shift_prev(a["h0"], got["ys"], False).float()
        cprev = fr._shift_prev(a["c0"], got["cs"], False).float()
        dpx, dh0, dc0, dwh = fr.rnn_bwd_plain(
            "lstm", f32["px"], got["ys"].float(), hprev, cprev,
            got["cs"].float(), f32["wh"], f32["dys"], f32["dhT"], f32["dcT"])
        planted["dpre unrounded"] = {"dpx": dpx.to(dtype),
                                     "dh0": dh0.to(dtype),
                                     "dc0": dc0.to(dtype), "dwh": dwh}
    for fault, outs in planted.items():
        bad = dict(got, **outs)
        want = fr.fed_plain("lstm", a, bad)
        check(any(fr.plain_mismatch(x, want[n]) is not None
                  for n, x in outs.items()),
              "fused_rnn limits pass a planted fault: %s (%s)"
              % (fault, dtype))
    return sorted(planted)


def rnn_bound(fr, kind, T, N, H, dname, itemsize_dtype):
    """Least time (ms) of one call: the reference's declared bytes over
    the memory rate against its flops over the dtype's peak."""
    cost = fr.fwd_declared_cost if kind == "fwd" else fr.bwd_declared_cost
    flops, nbytes, _ = cost("lstm", T, N, H, itemsize_dtype)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S[dname] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def cudnn_lstm_ms(torch, dev, a, dtype, n=20):
    """(forward ms, backward ms) of cuDNN's LSTM layer (torch.nn.LSTM) on
    the path's layer: the same recurrent weights, an input x [T, N, H]
    and its projection included (the kernels get px pre-projected);
    None where cuDNN refuses the dtype."""
    T, N, H = a["dys"].shape
    layer = torch.nn.LSTM(H, H, 1).to(device=dev, dtype=dtype)
    with torch.no_grad():
        layer.weight_hh_l0.copy_(a["wh"])
    layer.flatten_parameters()
    x = torch.randn(T, N, H, device=dev).to(dtype).requires_grad_(True)
    state = (a["h0"][None].contiguous(), a["c0"][None].contiguous())
    try:
        fwd = time_ms(torch, lambda: layer(x, state), n)
        out, _ = layer(x, state)
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, [x] + list(layer.parameters()), a["dys"],
            retain_graph=True), n)
    except RuntimeError as e:
        print("cudnn LSTM %s: not measured (%s)" % (dtype, e))
        return None, None
    return fwd, bwd


def phase_kernels_rnn(torch, np, dev, card):
    """K4a and K4b against their plain versions at RNN_SHAPES and at
    RNN_BOUNDARY's cases, each of those through its design, float32 and
    bfloat16, three modes, both directions, both designs launched; the
    gate raising just outside; then the timings at the path's shape with
    the serial floor."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import fused_rnn as fr
    errs, ncases = {}, 0
    fr.reset_launch_counts()
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for mode in ("lstm", "rnn_relu", "rnn_tanh"):
            for (T, N, H), design in ([(shape, None) for shape in RNN_SHAPES]
                                      + RNN_BOUNDARY):
                if isinstance(H, str):
                    H = fr.cluster_limit(mode, N, dtype) + (H == "past")
                took = fr.rnn_design(mode, N, H, dtype).name
                check(design in (None, took), "fused_rnn %s T=%d N=%d H=%d "
                      "%s takes the %s design, not %s"
                      % (mode, T, N, H, dname, took, design))
                for reverse in (False, True):
                    a = fr.check_inputs(mode, T, N, H, dtype, seed=ncases,
                                        device=dev)
                    rnn_check(torch, fr, mode, a, reverse, dname, errs,
                              "%s T=%d N=%d H=%d reverse=%s"
                              % (mode, T, N, H, reverse))
                    ncases += 1
        a = fr.check_inputs("lstm", LM_BPTT, LM_BATCH, LM_HIDDEN, dtype,
                            seed=999, device=dev)
        got = rnn_check(torch, fr, "lstm", a, False, dname, errs,
                        "planted-fault base")
        faults = rnn_planted_faults(torch, fr, a, got)
        print("fused_rnn kernel check %s: %d cases, max |kernel - plain| "
              "forward %.3g, backward %.3g, worst relative Frobenius %.3g; "
              "limits by output dtype %s (relative Frobenius, largest "
              "error / largest |plain|); planted faults rejected: %s"
              % (dname, 6 * (len(RNN_SHAPES) + len(RNN_BOUNDARY)),
                 errs["fwd", dname],
                 errs["bwd", dname], errs["fro", dname],
                 {str(k): v for k, v in fr.PLAIN_TOL.items()},
                 ", ".join(faults)))
    by_design = fr.design_launch_counts()
    print("fused_rnn checks' launches (K4a, K4b) by design: %s"
          % json.dumps(by_design))
    check(all(min(c) > 0 for c in by_design.values()),
          "fused_rnn checks did not launch both designs: %r" % by_design)
    # just outside the gate: H = MAX_HIDDEN + 1 raises on the card
    H = fr.MAX_HIDDEN + 1
    a = fr.check_inputs("rnn_tanh", 2, 2, H, torch.float32, device=dev)
    for what, call in (
            ("rnn_fwd", lambda: fr.rnn_fwd("rnn_tanh", a["px"], a["h0"], None,
                                           a["wh"])),
            ("fused_scan_layer", lambda: fr.fused_scan_layer(
                "rnn_tanh", a["px"], a["h0"], a["c0"], a["wh"]))):
        try:
            call()
        except MXNetError as e:
            print("fused_rnn gate: %s at H=%d raises: %s" % (what, H, e))
        else:
            raise SmokeFailure("fused_rnn %s at H=%d did not raise" % (what,
                                                                       H))

    rows = {}
    T, N, H = LM_BPTT, LM_BATCH, LM_HIDDEN
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        a = fr.check_inputs("lstm", T, N, H, dtype, seed=1234, device=dev)
        got = fr.chain("lstm", a)
        ys, cs = got["ys"], got["cs"]
        hprev = fr._shift_prev(a["h0"], ys, False)
        cprev = fr._shift_prev(a["c0"], cs, False)
        k_fwd = time_ms(torch, lambda: fr.rnn_fwd("lstm", a["px"], a["h0"],
                                                  a["c0"], a["wh"]), 20)
        k_bwd = time_ms(torch, lambda: fr.rnn_bwd(
            "lstm", a["px"], None, hprev, cprev, cs, a["wh"], a["dys"],
            a["dhT"], a["dcT"]), 20)
        p_fwd = time_ms(torch, lambda: fr.rnn_fwd_plain(
            "lstm", a["px"], a["h0"], a["c0"], a["wh"]), 5)
        p_bwd = time_ms(torch, lambda: fr.rnn_bwd_plain(
            "lstm", a["px"], ys, hprev, cprev, cs, a["wh"], a["dys"],
            a["dhT"], a["dcT"]), 5)
        lib_fwd, lib_bwd = cudnn_lstm_ms(torch, dev, a, dtype)
        design = fr.rnn_design("lstm", N, H, dtype)
        check(design.name == "cluster", "the path's shape takes the %s "
              "design" % design.name)
        floor = time_ms(torch, fr.serial_floor("lstm", T, N, H, dtype, dev),
                        20)
        for kind, ms, plain_ms, lib_ms in (("fwd", k_fwd, p_fwd, lib_fwd),
                                           ("bwd", k_bwd, p_bwd, lib_bwd)):
            b_ms, b_by = rnn_bound(fr, kind, T, N, H, dname, dtype)
            row = {"card": card, "kernel": "fused_rnn_" + kind,
                   "dtype": dname, "T": T, "N": N, "H": H,
                   "design": design.name, "P": design.P,
                   "rows": design.rows, "ms": ms,
                   "step_ms": ms / T, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "serial_floor_ms": floor, "library_ms": lib_ms,
                   "library": "cuDNN LSTM layer (torch.nn.LSTM), input "
                              "projection included, " + (
                                  "forward" if kind == "fwd" else
                                  "backward (autograd.grad)")}
            rows[kind, dname] = row
            print("fused_rnn timing: " + json.dumps(row))
    print("fused_rnn serial chain: %d dependent steps; bf16 K4a %.2f us a "
          "step, K4b %.2f us a step, against a whole-call bytes bound of "
          "%.2f and %.2f us and the cluster design's serial floor of %.2f "
          "us a step"
          % (T, 1e3 * rows["fwd", "bfloat16"]["step_ms"],
             1e3 * rows["bwd", "bfloat16"]["step_ms"],
             1e3 * rows["fwd", "bfloat16"]["bound_ms"],
             1e3 * rows["bwd", "bfloat16"]["bound_ms"],
             1e3 * rows["fwd", "bfloat16"]["serial_floor_ms"] / T))
    return errs, rows


def word_lm_net(torch, mx, dev, dropout):
    """RNNModel at the bench's width, Xavier weights, materialized on the
    card."""
    with mx.name.NameManager():
        net = mx.models.RNNModel(mode="lstm", vocab_size=LM_VOCAB,
                                 num_embed=LM_EMBED, num_hidden=LM_HIDDEN,
                                 num_layers=LM_LAYERS, dropout=dropout)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((LM_BPTT, LM_BATCH)))
    check(all(p.data()._data.device == dev
              for p in net.collect_params().values()),
          "the word LM's parameters are not on %s" % dev)
    return net


def word_lm_first_step(torch, fr, step, x, y):
    """The first step's loss and gradients in float32, flag on against
    flag off, beside a second flag-off run (the floor)."""
    os.environ["MXNET_FUSED_RNN"] = "0"
    n0 = fr.launch_counts()
    loss_off, g_off = step.loss_and_grads(x, y)
    _, g_again = step.loss_and_grads(x, y)
    check(fr.launch_counts() == n0, "flag off: a fused RNN kernel launched")
    os.environ["MXNET_FUSED_RNN"] = "1"
    loss_on, g_on = step.loss_and_grads(x, y)
    check(fr.launch_counts() == tuple(c + LM_LAYERS for c in n0),
          "flag on: K4a/K4b launched %r times from %r, expected %d more "
          "each" % (fr.launch_counts(), n0, LM_LAYERS))
    loss_err = abs(float(loss_on) - float(loss_off)) / abs(float(loss_off))
    check(loss_err <= LM_LOSS_RTOL,
          "first-step loss flag on %r != flag off %r (rel err %.3g > %g)"
          % (float(loss_on), float(loss_off), loss_err, LM_LOSS_RTOL))
    worst, floor = (0.0, ""), (0.0, "")
    for n, g in g_off.items():
        check(bool(torch.isfinite(g_on[n]).all()), "grad %s not finite" % n)
        worst = max(worst, (rel_frobenius(g_on[n], g), n))
        floor = max(floor, (rel_frobenius(g_again[n], g), n))
    check(worst[0] <= LM_GRAD_TOL,
          "first-step grad %s: flag on vs off relative Frobenius error %.3g "
          "> %g" % (worst[1], worst[0], LM_GRAD_TOL))
    print("word_lm oracle: loss flag on %.7f off %.7f (rel err %.3g, tol "
          "%g); %d gradients, worst relative Frobenius error %.3g (%s), tol "
          "%g; floor, flag off against a second run: %.3g (%s)"
          % (float(loss_on), float(loss_off), loss_err, LM_LOSS_RTOL,
             len(g_off), worst[0], worst[1], LM_GRAD_TOL, floor[0],
             floor[1]))
    return {"loss_rel_err": loss_err, "grad_rel_err": worst[0],
            "grad_floor_second_run": floor[0]}


def word_lm_timed_run(torch, np, step, x, y, dev):
    """One warm-up step and LM_STEPS timed ones: (losses, step seconds,
    peak bytes)."""
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [float(step(x, y))], []
    for _ in range(LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), "losses not finite: %r" % losses)
    return losses, times, torch.cuda.max_memory_allocated(dev)


def word_lm_corpus(np, n):
    """examples/word_lm.py's synthetic Markov corpus at vocab LM_VOCAB,
    batchified [T, N]."""
    rng = np.random.RandomState(0)
    tokens = [0]
    for _ in range(n):
        tokens.append((tokens[-1] * 7 + rng.randint(0, 3)) % LM_VOCAB)
    m = len(tokens) // LM_BATCH
    return np.asarray(tokens[:m * LM_BATCH]).reshape(LM_BATCH, m).T


def word_lm_loop(torch, np, mx, fr, dev):
    """examples/word_lm.py's loop at the bench's width, LM_LOOP_STEPS
    batches, the dropout masks from a seeded generator: (training losses,
    step seconds, (K4a, K4b) launches, the eval loss over the same
    batches before and after). At Xavier init the logits are near uniform
    over 10000 words and dropout moves each training loss by more than 20
    adam steps at the example's lr move their mean, so "falling" is
    checked on the eval loss (dropout off, the same carried-state walk),
    which is deterministic."""
    mx.random.seed(0)
    net = word_lm_net(torch, mx, dev, LM_LOOP_DROPOUT)
    data = word_lm_corpus(np, LM_BATCH * (LM_BPTT * LM_LOOP_STEPS + 2))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LM_LOOP_LR})
    lossfn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    batches = [(mx.nd.array(data[i:i + LM_BPTT].astype(np.float32)),
                mx.nd.array(data[i + 1:i + 1 + LM_BPTT].astype(np.float32))
                .reshape((-1,)))
               for i in range(0, LM_LOOP_STEPS * LM_BPTT, LM_BPTT)]

    def eval_loss():
        hidden, total = net.begin_state(batch_size=LM_BATCH), 0.0
        for x, y in batches:
            out, hidden = net(x, hidden)
            total += float(lossfn(out, y).mean().asnumpy())
        return total / len(batches)

    before = eval_loss()
    hidden = net.begin_state(batch_size=LM_BATCH)
    losses, times = [], []
    fr.reset_launch_counts()
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden = [h.detach() for h in hidden]
        with mx.autograd.record():
            out, hidden = net(x, hidden)
            L = lossfn(out, y).mean()
        L.backward()
        mx.gluon.utils.clip_global_norm([p.grad() for p in params],
                                        0.25 * LM_BPTT * LM_BATCH)
        trainer.step(LM_BATCH)
        losses.append(float(L.asnumpy()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = fr.launch_counts()
    by_design = fr.design_launch_counts()
    after = eval_loss()
    check(all(np.isfinite(losses + [before, after])),
          "loop losses not finite: %r, eval %r -> %r" % (losses, before,
                                                        after))
    check(after < before, "loop: the eval loss did not fall: %.7f -> %.7f"
          % (before, after))
    want = LM_LAYERS * LM_LOOP_STEPS
    check(launches == (want, want) and by_design["cluster"] == launches,
          "loop: K4a/K4b launched %r times over %d steps (by design %r), "
          "expected %d each, all through the cluster design"
          % (launches, LM_LOOP_STEPS, by_design, want))
    return losses, times, launches, (before, after)


def phase_word_lm(torch, np, dev, card):
    """The word-LM main path: RNNModel through TrainStep with
    MXNET_FUSED_RNN=1 at bench.py's config; the first step in float32
    against the flag off; one warm-up and LM_STEPS timed bfloat16 steps,
    K4a and K4b launched LM_LAYERS times a step each; the same steps with
    the flag off; a profiled step; then the imperative Trainer loop."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel import TrainStep
    prior = os.environ.get("MXNET_FUSED_RNN")
    try:
        net = word_lm_net(torch, mx, dev, 0.0)
        params = net.collect_params()
        saved = {n: p.data()._data.detach().clone()
                 for n, p in params.items()}
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                             .astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.randint(0, LM_VOCAB, (LM_BPTT * LM_BATCH,))
                             .astype(np.int32)).to(dev)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        opt = {"learning_rate": LM_LR}
        oracle = word_lm_first_step(
            torch, fr, TrainStep(net, loss_fn, "sgd", dict(opt)), x, y)

        # the main path: bf16 mixed precision, the flag on
        os.environ["MXNET_FUSED_RNN"] = "1"
        step = TrainStep(net, loss_fn, "sgd", dict(opt), dtype="bfloat16")
        fr.reset_launch_counts()
        losses, times, peak = word_lm_timed_run(torch, np, step, x, y, dev)
        launches = fr.launch_counts()
        by_design = fr.design_launch_counts()
        want = LM_LAYERS * (LM_STEPS + 1)
        check(launches == (want, want),
              "K4a/K4b launched %r times over %d steps, expected %d x %d = "
              "%d each" % (launches, LM_STEPS + 1, LM_LAYERS, LM_STEPS + 1,
                           want))
        check(by_design["cluster"] == (want, want),
              "K4a/K4b launches by design %r: expected all %d through the "
              "cluster design" % (by_design, want))
        check(losses[-1] < losses[0], "loss did not fall: %r" % losses)

        # the same steps from the same weights with the flag off
        for n, p in params.items():
            p.set_data(saved[n])
        os.environ["MXNET_FUSED_RNN"] = "0"
        step_off = TrainStep(net, loss_fn, "sgd", dict(opt),
                             dtype="bfloat16")
        fr.reset_launch_counts()
        losses_off, times_off, peak_off = word_lm_timed_run(
            torch, np, step_off, x, y, dev)
        check(fr.launch_counts() == (0, 0),
              "flag off: K4a/K4b launched %r" % (fr.launch_counts(),))
        os.environ["MXNET_FUSED_RNN"] = "1"
        try:
            profile_step(torch, "word_lm train", lambda: step(x, y))
        except SmokeFailure:
            raise
        except Exception as e:
            raise SmokeFailure("profiled word-LM step failed: %s: %s"
                               % (type(e).__name__, e))
        del net, step, step_off, saved
        loop_losses, loop_times, loop_launches, loop_eval = word_lm_loop(
            torch, np, mx, fr, dev)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior

    def summary(ts, ls, pk):
        ms = sorted(1e3 * t for t in ts)
        mean_ms = sum(ms) / len(ms)
        return {"step_ms_mean": mean_ms, "step_ms_p50": float(np.median(ms)),
                "tokens_per_s": LM_BPTT * LM_BATCH / (mean_ms / 1e3),
                "loss_first": ls[0], "loss_last": ls[-1],
                "max_memory_allocated": pk}

    loop_ms = sorted(1e3 * t for t in loop_times)
    main = {"card": card, "model": "RNNModel lstm", "vocab": LM_VOCAB,
            "hidden": LM_HIDDEN, "layers": LM_LAYERS, "bptt": LM_BPTT,
            "batch": LM_BATCH, "dtype": "bfloat16", "steps_timed": LM_STEPS,
            "fused_rnn": summary(times, losses, peak),
            "flag_off": summary(times_off, losses_off, peak_off),
            "first_step_float32": oracle,
            "k4_launches": {"fwd": launches[0], "bwd": launches[1]},
            "k4_launches_by_design": by_design,
            "imperative_loop": {
                "steps": LM_LOOP_STEPS, "optimizer": "adam",
                "dropout": LM_LOOP_DROPOUT, "dtype": "float32",
                "step_ms_mean": sum(loop_ms) / len(loop_ms),
                "step_ms_p50": float(np.median(loop_ms)),
                "losses": loop_losses, "eval_loss_before": loop_eval[0],
                "eval_loss_after": loop_eval[1],
                "k4_launches": list(loop_launches)}}
    print("word_lm train path: " + json.dumps(main))
    return launches, main


def step_summary(np, times, batch):
    """Step ms (mean, p50) and images/s of host-clock step times."""
    ms = [1e3 * t for t in times]
    mean_ms = sum(ms) / len(ms)
    return {"steps_timed": len(ms), "step_ms_mean": mean_ms,
            "step_ms_p50": float(np.median(ms)),
            "img_per_s": batch / (mean_ms / 1e3)}


class StepClock:
    """A batch-end callback: the host-clock time between consecutive
    batch ends of one epoch, the card synchronized at each."""

    def __init__(self, torch):
        self.torch = torch
        self.times = {}
        self._last = None

    def __call__(self, param):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        if param.nbatch > 0 and self._last is not None:
            self.times.setdefault(param.epoch, []).append(now - self._last)
        self._last = now


def module_step(mod, batch):
    """One Module training step; its first output's sum (to profile)."""
    mod.forward_backward(batch)
    mod.update()
    return mod.get_outputs()[0]._data.sum()


def phase_module(torch, np, dev, card):
    """BASELINE config 1 through the Module API (examples/train_mnist.py):
    get_mlp and get_lenet trained by Module.fit on the synthetic MNIST at
    batch 100 (SGD lr 0.1 momentum 0.9, Xavier, kvstore "local", 2
    epochs, Speedometer and do_checkpoint), each held to accuracy > 0.9
    and to a bit-equal checkpoint round trip; a profiled step."""
    import mxnet_tpu_torch as mx
    out = {}
    for name, make, shape in (("mlp", mx.models.get_mlp, (784,)),
                              ("lenet", mx.models.get_lenet, (1, 28, 28))):
        np.random.seed(0)
        train, val = mx.test_utils.get_mnist_iterator(
            batch_size=MNIST_BATCH, input_shape=shape)
        mod = mx.mod.Module(make(), context=mx.gpu(dev.index or 0))
        clock = StepClock(torch)
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, name)
            t0 = time.perf_counter()
            mod.fit(train, eval_data=val, optimizer="sgd",
                    initializer=mx.init.Xavier(), kvstore="local",
                    optimizer_params={"learning_rate": MNIST_LR,
                                      "momentum": MNIST_MOMENTUM},
                    num_epoch=MNIST_EPOCHS,
                    batch_end_callback=[
                        mx.callback.Speedometer(MNIST_BATCH, 20), clock],
                    epoch_end_callback=mx.callback.do_checkpoint(prefix))
            fit_s = time.perf_counter() - t0
            acc = mod.score(val, "acc")[0][1]
            check(acc > MNIST_ACC, "%s Module accuracy %.4f <= %g"
                  % (name, acc, MNIST_ACC))
            check(all(a._data.device == dev
                      for a in mod._exec.arg_dict.values()),
                  "%s: the executor's arrays are not on %s" % (name, dev))
            want = mod.predict(val)
            loaded = mx.mod.Module.load(prefix, MNIST_EPOCHS,
                                        context=mx.gpu(dev.index or 0))
            loaded.bind(data_shapes=val.provide_data,
                        label_shapes=val.provide_label, for_training=False)
            got = loaded.predict(val)
            check(got._data.device == dev and
                  torch.equal(got._data, want._data),
                  "%s: load_checkpoint + Module.load outputs differ from "
                  "the trained module's" % name)
        train.reset()
        batch = next(iter(train))
        prof = profile_step(torch, "%s module train" % name,
                            lambda: module_step(mod, batch))
        out[name] = dict(step_summary(np, clock.times[MNIST_EPOCHS - 1],
                                      MNIST_BATCH),
                         val_acc=acc, fit_s=fit_s,
                         checkpoint_round_trip="bit-equal",
                         profile=prof)
    main = {"card": card, "batch": MNIST_BATCH, "epochs": MNIST_EPOCHS,
            "timed_epoch": MNIST_EPOCHS - 1, **out}
    print("module path (phase 12): " + json.dumps(main))
    return main


def grad_violation(torch, a, b, rtol, atol):
    """max |a - b| / (atol + rtol |b|): at most 1 passes
    (numpy.allclose's rule)."""
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def consistency_check(torch, mx, dev, what, sym, shapes, counts, want,
                      cudnn=True):
    """test_utils.check_consistency of `sym` over [cpu, gpu(dev)] at
    `shapes` and CONSIST_SCALE (grad_req "write": outputs and gradients
    held at tol 1e-3), with cuDNN on or off; `counts()` reads the path's
    launch counters, which must move by `want` (the card's launches; the
    CPU's plain versions launch nothing). Prints and returns the largest
    violations (fractions of the tolerance), the launches and the
    seconds."""
    from mxnet_tpu_torch import test_utils as tu
    ctx_list = [dict(shapes, ctx=mx.cpu()),
                dict(shapes, ctx=mx.gpu(dev.index or 0))]
    errors = {}
    n0 = counts()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=cudnn):
        tu.check_consistency(sym, ctx_list, scale=CONSIST_SCALE,
                             errors=errors)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = tuple(b - a for a, b in zip(n0, counts()))
    out = {"shapes": {k: list(v) for k, v in shapes.items()},
           "scale": CONSIST_SCALE, "tol": 1e-3, "cudnn": cudnn,
           "worst_fraction_of_tol": errors,
           "launches": launched, "expected_launches": want, "wall_s": wall}
    print("check_consistency %s cpu vs %s: %s" % (what, dev,
                                                 json.dumps(out)))
    check(launched == want or dev.type == "cpu",
          "check_consistency %s: the card launched %r, expected %r"
          % (what, launched, want))
    return out


def phase_executor_bn(torch, np, dev, card):
    """The executor's BatchNorm on K3a-d: bn_convnet bound through Module
    at batch 100, float32, MXNET_FUSED_BN_EPILOGUE=1. The first step's
    outputs, every gradient and the moving statistics, flag on against
    flag off; then BN_NET_STEPS timed steps, each K3 kernel launched
    twice a step (two BatchNorm nodes, one forward and one backward
    each), and none in score; a profiled step. Before the timed steps,
    check_consistency over [cpu, gpu(0)] at batch CONSIST_BN_BATCH."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_bn as fb
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    try:
        np.random.seed(1)
        train, val = mx.test_utils.get_mnist_iterator(
            batch_size=MNIST_BATCH, input_shape=(1, 28, 28))
        mod = mx.mod.Module(bn_convnet(mx.sym),
                            context=mx.gpu(dev.index or 0))
        mod.bind(data_shapes=train.provide_data,
                 label_shapes=train.provide_label)
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params={"learning_rate": MNIST_LR,
                                             "momentum": MNIST_MOMENTUM})
        args0, aux0 = mod.get_params()
        batch = next(iter(train))

        def first_step(flag):
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = flag
            mod.set_params(args0, aux0)
            n0 = fb.launch_counts()
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            launched = fb.launch_counts() != n0
            ex = mod._exec
            return (ex.outputs[0]._data.clone(),
                    {n: g._data.clone() for n, g in ex.grad_dict.items()},
                    {n: a._data.clone() for n, a in ex.aux_dict.items()},
                    launched)
        # the check runs the convolutions without cuDNN: its algorithms
        # for this net's gradients (FFT among them) are inexact, so the
        # same BatchNorm gradients, differently rounded, move the conv
        # weights' gradients past the tolerance (the line below prints by
        # how much, relative). Without cuDNN only the BatchNorm path
        # differs between the two runs.
        with torch.backends.cudnn.flags(enabled=False):
            out_off, g_off, aux_off, l_off = first_step("0")
            out_on, g_on, aux_on, l_on = first_step("1")
        cudnn_g_off = first_step("0")[1]
        cudnn_g_on = first_step("1")[1]
        cudnn_worst = max(rel_frobenius(cudnn_g_on[n], cudnn_g_off[n])
                          for n in cudnn_g_off if n in ("conv1_weight",
                                                        "conv2_weight"))
        check(l_on and not l_off, "flag on launched %s, flag off launched "
              "%s" % (l_on, l_off))
        # a conv bias feeding a BatchNorm has a zero gradient (the batch
        # mean removes it): both flag states' values are rounding noise,
        # held below R50_ZERO_GRAD of the largest gradient element
        zero = [n for n in g_off if n.startswith("conv")
                and n.endswith("_bias")]
        top = max(float(g.abs().max()) for g in g_off.values())
        worst = {
            "outputs": grad_violation(torch, out_on, out_off, 1e-5, 1e-5),
            "grads": max(grad_violation(torch, g_on[n], g_off[n],
                                        BN_NET_TOL, BN_NET_TOL)
                         for n in g_off if n not in zero),
            "moving_stats": max(grad_violation(torch, aux_on[n], aux_off[n],
                                               BN_NET_TOL, BN_NET_TOL)
                                for n in aux_off),
            "zero_grads": max(float(g[n].abs().max()) / top
                              / R50_ZERO_GRAD
                              for g in (g_on, g_off) for n in zero)}
        print("bn_convnet first step, flag on vs off (convolutions without "
              "cuDNN): worst fraction of the tolerance %s over %d gradients "
              "(%d conv biases feeding a BatchNorm held near zero) and %d "
              "moving statistics; with cuDNN the conv weights' gradients "
              "differ by %.3g relative (Frobenius, not checked)"
              % (json.dumps(worst), len(g_off), len(zero), len(aux_off),
                 cudnn_worst))
        for what, v in worst.items():
            check(v <= 1.0, "bn_convnet first step flag on vs off: %s off "
                  "by %.3g of the tolerance" % (what, v))

        # check_consistency over [cpu, gpu(0)] with the flag on, the
        # convolutions without cuDNN as above (on an H100 80GB HBM3 at
        # 700 W its algorithms moved this net's outputs by 10.8x the
        # tolerance at scale 1.0, where a one-ulp change of the inputs
        # moves them by 0.018x on the CPU)
        os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
        consistency = consistency_check(
            torch, mx, dev, "bn_convnet", bn_convnet(mx.sym),
            {"data": (CONSIST_BN_BATCH, 1, 28, 28)}, fb.launch_counts,
            (2,) * 4, cudnn=False)

        # the timed steps with the flag on, launches counted
        mod.set_params(args0, aux0)
        train.reset()
        batches = [b for _, b in zip(range(BN_NET_STEPS), train)]
        fb.reset_launch_counts()
        times = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            module_step(mod, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = fb.launch_counts()
        want = 2 * BN_NET_STEPS
        check(launches == (want,) * 4,
              "executor K3a-d launched %r times over %d steps, expected 2 x "
              "%d = %d each" % (launches, BN_NET_STEPS, BN_NET_STEPS, want))
        fb.reset_launch_counts()
        acc = mod.score(val, "acc")[0][1]
        check(fb.launch_counts() == (0,) * 4,
              "score launched K3 kernels %r" % (fb.launch_counts(),))
        prof = profile_step(torch, "bn_convnet module train",
                            lambda: module_step(mod, batches[0]))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    main = {"card": card, "batch": MNIST_BATCH, "dtype": "float32",
            **step_summary(np, times[1:], MNIST_BATCH),
            "first_step_flag_on_vs_off": worst,
            "first_step_cudnn_conv_grad_rel_frobenius": cudnn_worst,
            "k3_launches": dict(zip(("stats", "apply", "bwd_reduce",
                                     "bwd_dx"), launches)),
            "val_acc_after_steps": acc, "profile": prof,
            "check_consistency": consistency}
    print("executor BatchNorm path (phase 12b): " + json.dumps(main))
    return launches, main


def gluon_lenet_epoch(torch, np, mx, dev, hybridize):
    """One epoch of LeNet on the synthetic MNIST through DataLoader (2
    worker threads, pinned batches) and Trainer inside autograd.record();
    (step seconds, validation accuracy, the net, a batch)."""
    T = mx.gluon.data.vision.transforms
    train = mx.gluon.data.vision.MNIST(train=True).transform_first(
        T.ToTensor())
    val = mx.gluon.data.vision.MNIST(train=False).transform_first(
        T.ToTensor())
    ctx = mx.gpu(dev.index or 0)
    net = mx.models.LeNet()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": MNIST_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loader = mx.gluon.data.DataLoader(train, batch_size=MNIST_BATCH,
                                      shuffle=True, num_workers=2,
                                      pin_memory=True)
    times = []
    last = None
    for x, y in loader:
        check(x._data.is_pinned(), "DataLoader(pin_memory=True) gave an "
              "unpinned batch")
        x, y = x.as_in_context(ctx), y.as_in_context(ctx)
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        torch.cuda.synchronize()
        now = time.perf_counter()
        if last is not None:
            times.append(now - last)
        last = now
    metric = mx.metric.Accuracy()
    for x, y in mx.gluon.data.DataLoader(val, batch_size=MNIST_BATCH):
        metric.update([y], [net(x.as_in_context(ctx))])
    return times, metric.get()[1], net, (x.as_in_context(ctx),
                                          y.as_in_context(ctx))


def phase_gluon_lenet(torch, np, dev, card):
    """SKILL.md drive flow 2 on the card: LeNet through gluon.data and
    Trainer, one epoch eager and one after hybridize() (the traced,
    cached graph), each held to accuracy > 0.9, with the epoch's peak
    memory and a profiled step of each."""
    import mxnet_tpu_torch as mx
    np.random.seed(2)
    out = {}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for mode in ("eager", "hybridized"):
        torch.cuda.reset_peak_memory_stats(dev)
        times, acc, net, (x, y) = gluon_lenet_epoch(
            torch, np, mx, dev, hybridize=mode == "hybridized")
        peak = torch.cuda.max_memory_allocated(dev)
        check(acc > MNIST_ACC, "Gluon LeNet (%s) accuracy %.4f <= %g"
              % (mode, acc, MNIST_ACC))
        check((net._cached_graph is not None) == (mode == "hybridized"),
              "Gluon LeNet (%s): cached graph %r" % (mode,
                                                      net._cached_graph))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": MNIST_LR})
        prof = profile_step(
            torch, "gluon lenet %s train" % mode,
            lambda net=net, trainer=trainer, x=x, y=y: gluon_step(
                mx, net, trainer, loss_fn, x, y))
        out[mode] = dict(step_summary(np, times, MNIST_BATCH), val_acc=acc,
                         max_memory_allocated=peak, profile=prof)
    main = {"card": card, "batch": MNIST_BATCH, "epochs_each": 1, **out}
    print("gluon LeNet path (phase 13): " + json.dumps(main))
    return main


def prototype_batch(torch, dev, n, classes, image, seed):
    """n synthetic class-prototype images (NCHW, float32, on the card) and
    their labels: each label's prototype, uniform in [-1, 1], plus
    Gaussian noise of 0.25, all from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randint(0, classes, (n,), generator=g, device=dev)
    labels, inverse = torch.unique(y, return_inverse=True)
    protos = torch.rand((len(labels), 3, image, image), generator=g,
                        device=dev) * 2 - 1
    x = protos[inverse] + 0.25 * torch.randn(
        (n, 3, image, image), generator=g, device=dev)
    return x, y.to(torch.int32)


def gluon_step(mx, net, trainer, loss_fn, x, y):
    """One Gluon training step (record, backward, Trainer.step over the
    loss's entries); the mean loss as a tensor."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(y.shape[0])
    return loss._data.detach().mean()


def hybrid_parity_check(torch, np, mx, dev):
    """The first training step of resnet18_v1 (64x64, batch 32, float32,
    MXNET_FUSED_BN_EPILOGUE=1, cuDNN off so the convolutions repeat)
    eager and hybridized from the same weights: outputs within
    HYB_OUT_TOL, every gradient within HYB_GRAD_TOL (numpy's allclose
    rule), the moving statistics within HYB_OUT_TOL."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.name.NameManager():
        net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier())
    x, y = prototype_batch(torch, dev, HYB_NET_BATCH, 10, HYB_NET_IMAGE, 3)
    x, y = mx.nd.NDArray(x), mx.nd.NDArray(y)
    net(x)
    params = net.collect_params()
    start = {n: p.data()._data.clone() for n, p in params.items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    res = {}
    with torch.backends.cudnn.flags(enabled=False):
        for mode in ("eager", "hybridized"):
            for n, p in params.items():
                p.set_data(start[n].clone())
            net.hybridize(mode == "hybridized")
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out, y).mean()
            loss.backward()
            torch.cuda.synchronize()
            res[mode] = (out._data.detach().clone(), float(loss.asscalar()),
                         {n: p.grad()._data.clone() for n, p in
                          params.items() if p.grad_req != "null"},
                         {n: p.data()._data.clone() for n, p in
                          params.items() if p.grad_req == "null"})
    check(net._cached_graph is not None, "parity check: no cached graph")
    (o_e, l_e, g_e, a_e), (o_h, l_h, g_h, a_h) = res["eager"], \
        res["hybridized"]
    worst = {
        "outputs": grad_violation(torch, o_h, o_e, HYB_OUT_TOL,
                                  HYB_OUT_TOL),
        "grads": max(grad_violation(torch, g_h[n], g_e[n], HYB_GRAD_TOL,
                                    HYB_GRAD_TOL) for n in g_e),
        "moving_stats": max(grad_violation(torch, a_h[n], a_e[n],
                                           HYB_OUT_TOL, HYB_OUT_TOL)
                            for n in a_e)}
    print("hybridize parity (resnet18_v1, %dx%d, batch %d, cuDNN off): "
          "loss eager %.7f hybridized %.7f; worst fraction of the "
          "tolerance %s over %d gradients and %d moving statistics"
          % (HYB_NET_IMAGE, HYB_NET_IMAGE, HYB_NET_BATCH, l_e, l_h,
             json.dumps(worst), len(g_e), len(a_e)))
    for what, v in worst.items():
        check(v <= 1.0, "hybridized vs eager first step: %s off by %.3g of "
              "the tolerance" % (what, v))
    return dict(worst, loss_eager=l_e, loss_hybridized=l_h)


def phase_gluon_resnet(torch, np, dev, card):
    """BASELINE config 2's single-device half: the model zoo's
    resnet50_v1 at its published widths (1000 classes, 224x224 NCHW,
    float32, batch G50_BATCH) trained through gluon.Trainer (sgd, G50_OPT)
    with MXNET_FUSED_BN_EPILOGUE=1 on synthetic class-prototype images,
    eager and hybridized: two nets from the same weights, stepped in
    turns (G50_WARMUP warm-up then G50_STEPS timed steps each). Holds
    finite, falling losses, K3a-d launched 53 times each a step in both
    modes (the hybridized graph's BatchNorm nodes; the eager blocks'
    fused epilogues), and the hybridized graph against the eager forward
    on a resnet18_v1 step; a profiled step each. Returns (the hybridized
    net, a batch, its timed launches by mode, the summary)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    try:
        parity = hybrid_parity_check(torch, np, mx, dev)
        nets = {}
        for mode in ("eager", "hybridized"):
            with mx.name.NameManager():
                nets[mode] = vision.resnet50_v1(classes=R50_CLASSES)
            nets[mode].initialize(mx.init.Xavier())
            nets[mode](mx.nd.zeros((1, 3, R50_IMAGE, R50_IMAGE)))
        src = nets["eager"].collect_params()
        for n, p in nets["hybridized"].collect_params().items():
            p.set_data(src[n].data()._data.clone())
        nets["hybridized"].hybridize()
        x, y = prototype_batch(torch, dev, G50_BATCH, R50_CLASSES,
                               R50_IMAGE, 0)
        x, y = mx.nd.NDArray(x), mx.nd.NDArray(y)
        out, timed = train_in_turns(torch, np, mx, dev, "resnet50", nets,
                                    x, y, G50_WARMUP, G50_STEPS, 53)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    main = {"card": card, "model": "resnet50_v1", "batch": G50_BATCH,
            "image": R50_IMAGE, "dtype": "float32",
            "warmup": G50_WARMUP, **out,
            "hybridize_parity_resnet18": parity,
            "k3_launches_a_step": 53}
    print("resnet50 gluon path (phase 14): " + json.dumps(main))
    return nets["hybridized"], (x, y), timed, main


def train_in_turns(torch, np, mx, dev, what, nets, x, y, warmup, steps,
                   k3_a_step):
    """Phase 14's training run, shared with phase 16b: the nets of
    {mode: net} (eager and hybridized, from the same weights) stepped in
    turns through gluon.Trainer (sgd, G50_OPT, SoftmaxCrossEntropyLoss),
    `warmup` then `steps` timed steps each. Holds finite, falling losses,
    the hybridized net's cached graph in use, and K3a-d launched
    `k3_a_step` times each a step in both modes; profiles a step each.
    Returns ({mode: summary}, {mode: the timed steps' launches})."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainers = {m: mx.gluon.Trainer(net.collect_params(), "sgd",
                                    dict(G50_OPT))
                for m, net in nets.items()}
    losses = {m: [] for m in nets}
    times = {m: [] for m in nets}
    peaks = {m: 0 for m in nets}
    launches = {m: [] for m in nets}
    for i in range(warmup + steps):
        for m, net in nets.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fb.reset_launch_counts()
            t0 = time.perf_counter()
            loss = gluon_step(mx, net, trainers[m], loss_fn, x, y)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[m].append(fb.launch_counts())
            peaks[m] = max(peaks[m], torch.cuda.max_memory_allocated(dev))
            losses[m].append(float(loss))
            if i >= warmup:
                times[m].append(dt)
    check(nets["hybridized"]._cached_graph is not None,
          "hybridized %s ran without its cached graph" % what)
    for m in nets:
        check(all(np.isfinite(losses[m])), "%s %s losses not finite: %r"
              % (what, m, losses[m]))
        check(losses[m][-1] < losses[m][0], "%s %s loss did not fall: %r"
              % (what, m, losses[m]))
        check(all(c == (k3_a_step,) * 4 for c in launches[m]),
              "%s %s: K3a-d launched %r a step, expected %d each"
              % (what, m, launches[m], k3_a_step))
    profiles = {m: profile_step(
        torch, "%s gluon %s train" % (what, m),
        lambda net=net, m=m: gluon_step(mx, net, trainers[m], loss_fn,
                                        x, y))
        for m, net in nets.items()}
    out = {}
    for m in nets:
        busy = profiles[m]["device_busy_share"] if profiles[m] else None
        out[m] = dict(step_summary(np, times[m], y.shape[0]),
                      loss_first=losses[m][0], loss_last=losses[m][-1],
                      max_memory_allocated=peaks[m],
                      device_busy_share=busy)
    timed = {m: tuple(sum(c[i] for c in launches[m][warmup:])
                      for i in range(4)) for m in nets}
    return out, timed


def phase_export(torch, np, dev, card, net, batch):
    """Phase 14's trained, hybridized ResNet-50 exported, then loaded back
    on the card through SymbolBlock.imports(ctx=gpu) and through
    load_checkpoint + Module(bind for_training=False): both give the
    net's own eval logits on one batch within EXPORT_RTOL of the largest
    |logit|."""
    import mxnet_tpu_torch as mx
    x = batch[0]
    ctx = mx.gpu(dev.index or 0)
    want = net(x)._data
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50")
        t0 = time.perf_counter()
        net.export(prefix, epoch=0)
        export_s = time.perf_counter() - t0
        check(net._active, "export left the net un-hybridized")
        blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                           prefix + "-0000.params", ctx=ctx)
        check(all(p.data()._data.device == dev
                  for p in blk.collect_params().values()),
              "SymbolBlock.imports(ctx=gpu) left a parameter off the card")
        got_blk = blk(x)._data
        sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
        mod = mx.mod.Module(sym, context=ctx, label_names=())
        mod.bind(data_shapes=[("data", tuple(x.shape))], for_training=False)
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.forward(mx.io.DataBatch(data=[x]), is_train=False)
        got_mod = mod.get_outputs()[0]._data
    scale = float(want.abs().max())
    errs = {"symbol_block": float((got_blk - want).abs().max()) / scale,
            "module": float((got_mod - want).abs().max()) / scale}
    for what, e in errs.items():
        check(e <= EXPORT_RTOL, "export reloaded through %s: logits off "
              "by %.3g of the largest |logit| (> %g)" % (what, e,
                                                         EXPORT_RTOL))
    main = {"card": card, "model": "resnet50_v1", "batch": int(x.shape[0]),
            "logit_err_over_max": errs, "export_s": export_s,
            "aux_states": len(sym.list_auxiliary_states()),
            "arguments": len(sym.list_arguments())}
    print("export + reload (phase 14b): " + json.dumps(main))
    return main


def phase_word_lm_hybrid(torch, np, dev, card):
    """The word LM at phase 11's width (lstm, vocab LM_VOCAB, embed and
    hidden 200, 2 layers, dropout 0, bptt 35 x batch 32, float32)
    hybridized with MXNET_FUSED_RNN=1, trained LMH_STEPS steps through
    gluon.Trainer (sgd, LM_LR) on RandomState(0) tokens: K4a and K4b
    launched LM_LAYERS times a step each, finite and falling losses, and
    the first step's loss and gradients against the eager step's within
    ops/fused_rnn.py PLAIN_TOL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    try:
        net = word_lm_net(torch, mx, dev, 0.0)
        params = net.collect_params()
        start = {n: p.data()._data.clone() for n, p in params.items()}
        rng = np.random.RandomState(0)
        x = mx.nd.array(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                        .astype(np.float32))
        y = mx.nd.array(rng.randint(0, LM_VOCAB, (LM_BPTT * LM_BATCH,))
                        .astype(np.int32))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        first = {}
        for mode in ("eager", "hybridized"):
            for n, p in params.items():
                p.set_data(start[n].clone())
            net.hybridize(mode == "hybridized")
            with mx.autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            first[mode] = (loss._data.detach().clone(),
                           {n: p.grad()._data.clone()
                            for n, p in params.items()})
        errs = {"loss": fr.plain_mismatch(first["hybridized"][0],
                                          first["eager"][0])}
        for n, g in first["eager"][1].items():
            errs[n] = fr.plain_mismatch(first["hybridized"][1][n], g)
        bad = {n: e for n, e in errs.items() if e is not None}
        check(not bad, "hybridized word LM's first step against the eager "
              "one: %r" % bad)
        for n, p in params.items():
            p.set_data(start[n].clone())
        trainer = mx.gluon.Trainer(params, "sgd",
                                   {"learning_rate": LM_LR})
        losses, times, launches = [], [], []
        for _ in range(LMH_STEPS):
            torch.cuda.synchronize()
            fr.reset_launch_counts()
            t0 = time.perf_counter()
            loss = gluon_step(mx, net, trainer, loss_fn, x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(fr.launch_counts())
            losses.append(float(loss))
        check(net._cached_graph is not None,
              "hybridized word LM ran without its cached graph")
        check(all(np.isfinite(losses)), "losses not finite: %r" % losses)
        check(losses[-1] < losses[0], "loss did not fall: %r" % losses)
        check(all(c == (LM_LAYERS, LM_LAYERS) for c in launches),
              "K4a/K4b launched %r a step, expected %d each"
              % (launches, LM_LAYERS))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    ms = sorted(1e3 * t for t in times)
    main = {"card": card, "model": "RNNModel lstm", "vocab": LM_VOCAB,
            "hidden": LM_HIDDEN, "layers": LM_LAYERS, "bptt": LM_BPTT,
            "batch": LM_BATCH, "dtype": "float32", "steps": LMH_STEPS,
            "step_ms_mean": sum(ms) / len(ms),
            "step_ms_p50": float(np.median(ms)),
            "losses": losses,
            "first_step_vs_eager": "within PLAIN_TOL",
            "k4_launches_a_step": LM_LAYERS}
    print("word_lm gluon hybridized path (phase 14c): " + json.dumps(main))
    return tuple(sum(c[i] for c in launches) for i in range(2)), main


def bucket_iter(np, mx, buckets=None):
    """phase 15's corpus through mx.rnn.BucketSentenceIter (Python's
    random and numpy's global generator seeded 0, as the reference's
    iterator shuffles with both)."""
    import random
    random.seed(0)
    np.random.seed(0)
    sentences = bucketing_corpus(np, BUCKET_SENTENCES, BUCKET_VOCAB,
                                 BUCKET_LENGTHS)
    return mx.rnn.BucketSentenceIter(sentences, BUCKET_BATCH,
                                     buckets=buckets or BUCKETS,
                                     invalid_label=BUCKET_PAD)


def bucket_nll(torch, probs, label):
    """(summed negative log-likelihood of the targets, their count), the
    padding left out, on the card: no host copy a batch."""
    label = label.to(probs.device).reshape(-1).long()
    keep = label != BUCKET_PAD
    p = probs.gather(1, label[:, None])[:, 0]
    return -(torch.log(p.clamp(min=1e-30)) * keep).sum(), keep.sum()


def bucket_metric(torch, mx):
    """An EvalMetric keeping each batch's (nll sum, token count) on the
    card, read once at the end."""
    class DeviceNLL(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("nll")

        def reset(self):
            super().reset()
            self.batches = []

        def update(self, labels, preds):
            self.batches.append(bucket_nll(torch, preds[0]._data,
                                           labels[0]._data))

        def losses(self):
            """[(nll sum, count)] a batch, as Python numbers."""
            flat = torch.stack([torch.stack([s.float(), c.float()])
                                for s, c in self.batches]).cpu().tolist()
            return [(s, int(c)) for s, c in flat]

        def get(self):
            if not self.batches:
                return (self.name, float("nan"))
            losses = self.losses()
            return (self.name, sum(s for s, _ in losses)
                    / sum(c for _, c in losses))
    return DeviceNLL()


class BucketClock:
    """A batch-end callback: the host-clock time between consecutive batch
    ends, the card synchronized at each, by the batch's bucket."""

    def __init__(self, torch):
        self.torch = torch
        self.times = {}
        self.keys = []
        self._last = None

    def __call__(self, param):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        key = param.locals["batch"].bucket_key
        self.keys.append(key)
        if self._last is not None:
            self.times.setdefault(key, []).append(now - self._last)
        self._last = now


def bucket_params(np, mx, sym_gen, T):
    """Numpy parameters for phase 15's graph from seed 1: the flat LSTM
    vector uniform in +-0.1, the rest Xavier-uniform bounds."""
    sym = sym_gen(T)[0]
    shapes, _, _ = sym.infer_shape(data=(BUCKET_BATCH, T),
                                   softmax_label=(BUCKET_BATCH, T))
    rng = np.random.RandomState(1)
    out = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        bound = 0.1 if len(s) == 1 else np.sqrt(6.0 / (s[0] + s[1]))
        out[n] = rng.uniform(-bound, bound, s).astype(np.float32)
    return out


def bucketing_first_step(torch, np, mx, fr, dev, sym_gen, batches):
    """(a): at each of BUCKET_CHECKED, one training step's outputs and
    every gradient with MXNET_FUSED_RNN=1 against =0, within
    ops/fused_rnn.py PLAIN_TOL; the flag-on step launches K4a and K4b
    once a layer, the flag-off one not at all."""
    from mxnet_tpu_torch.models import module_params_from_numpy
    errs = {}
    for T in BUCKET_CHECKED:
        batch = batches[T]
        mod = mx.mod.Module(sym_gen(T)[0], context=mx.gpu(dev.index or 0))
        mod.bind(batch.provide_data, batch.provide_label)
        module_params_from_numpy(mod, bucket_params(np, mx, sym_gen, T))
        got = {}
        for flag in ("0", "1"):
            os.environ["MXNET_FUSED_RNN"] = flag
            before = fr.launch_counts()
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            want = (0, 0) if flag == "0" else (BUCKET_LAYERS,) * 2
            moved = tuple(a - b for a, b in zip(fr.launch_counts(), before))
            check(moved == want, "bucket %d flag %s: K4a/K4b launched %r, "
                  "expected %r" % (T, flag, moved, want))
            got[flag] = {"softmax_output": mod.get_outputs()[0]._data.clone()}
            got[flag].update({n: g._data.clone() for n, g in
                              mod._exec.grad_dict.items()
                              if n in mod._param_names})
        for n, want in got["0"].items():
            check(bool(torch.isfinite(got["1"][n]).all()),
                  "bucket %d: %s not finite" % (T, n))
            bad = fr.plain_mismatch(got["1"][n], want)
            check(bad is None, "bucket %d first step, %s flag on vs off: %s"
                  % (T, n, bad))
            errs["%d:%s" % (T, n)] = fr.plain_error(got["1"][n], want)[0]
    os.environ["MXNET_FUSED_RNN"] = "1"
    return errs


def switch_copy_ms(torch, np, mod, dev, n=5):
    """The parameter copy of a bucket switch, timed alone: the current
    bucket's get_params into another bucket's init_params(force_init),
    synchronized, n times; (median ms, bytes of one copy). Every
    parameter must stay on the card."""
    cur = mod._curr_module
    other = next(m for k, m in mod._buckets.items()
                 if k != mod._curr_bucket_key)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arg, aux = cur.get_params()
        other.init_params(arg_params=arg, aux_params=aux, force_init=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(all(a._data.device == dev
              for a in list(arg.values()) + list(other._exec.arg_dict.values())),
          "a bucket switch's parameter copy left the card")
    nbytes = sum(a._data.numel() * a._data.element_size()
                 for a in arg.values())
    return 1e3 * float(np.median(times)), nbytes


def bucketing_checkpoints(torch, mx, mod, sym_gen, dev):
    """(d): save_rnn_checkpoint / load_rnn_checkpoint and a legacy-format
    .params file written by utils.legacy and read back by nd.load onto
    the card, both bit equal to the module's parameters."""
    from mxnet_tpu_torch.utils import legacy
    arg, aux = mod.get_params()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "bucketing_lm")
        mx.rnn.save_rnn_checkpoint([sym_gen.cell], prefix, 1, mod.symbol,
                                   arg, aux)
        sym, arg2, aux2 = mx.rnn.load_rnn_checkpoint([sym_gen.cell], prefix,
                                                     1)
        check(sym.tojson() == mod.symbol.tojson(),
              "load_rnn_checkpoint's symbol differs from the saved one")
        path = os.path.join(tmp, "bucketing_lm-legacy.params")
        legacy.save_legacy_ndarrays(path, {"arg:" + n: a
                                           for n, a in arg.items()})
        back = mx.nd.load(path, ctx=mx.gpu(dev.index or 0))
    check(sorted(arg2) == sorted(arg) and sorted(back) ==
          sorted("arg:" + n for n in arg), "checkpoint names differ")
    for n, a in arg.items():
        for what, got in (("rnn checkpoint", arg2[n]),
                          ("legacy .params", back["arg:" + n])):
            check(got._data.device == dev and torch.equal(got._data,
                                                          a._data),
                  "%s: %s is not bit equal on the card" % (what, n))
    return {"rnn_checkpoint": "bit-equal", "legacy_params": "bit-equal",
            "params": len(arg)}


def phase_bucketing(torch, np, dev, card):
    """Phase 15: the bucketed LSTM LM (upstream cudnn_lstm_bucketing.py's
    defaults) through mx.rnn.BucketSentenceIter, FusedRNNCell and
    BucketingModule.fit on the card with MXNET_FUSED_RNN=1, one epoch:
    (a) the first step against the composite at buckets 10 and 60, (b)
    finite losses, a falling perplexity, K4a and K4b launched once a layer
    a step, all six buckets bound, every bucket's parameters bit equal to
    the current one's after a switch, (c) a Monitor's statistics finite,
    (d) checkpoints bit equal; step ms by bucket, tokens/s, peak memory,
    the switch copy's time and a profiled bucket-60 step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    ctx = mx.gpu(dev.index or 0)
    try:
        sym_gen = bucketing_sym_gen(mx, BUCKET_VOCAB, BUCKET_EMBED,
                                    BUCKET_HIDDEN, BUCKET_LAYERS)
        it = bucket_iter(np, mx)
        first = {}
        for b in it:
            first.setdefault(b.bucket_key, b)
        it.reset()
        oracle = bucketing_first_step(torch, np, mx, fr, dev, sym_gen, first)
        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=max(BUCKETS),
                                     context=ctx)
        metric = bucket_metric(torch, mx)
        clock = BucketClock(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        mod.fit(it, eval_metric=metric, optimizer="adam",
                optimizer_params={"learning_rate": BUCKET_LR},
                initializer=mx.init.Mixed(
                    [".*lstm_parameters", ".*"],
                    [mx.init.Uniform(0.1), mx.init.Xavier()]),
                num_epoch=1, batch_end_callback=clock)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = fr.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        steps = len(clock.keys)
        losses = metric.losses()
        check(all(np.isfinite(s) for s, _ in losses),
              "bucketing losses not finite")
        ppl = [float(np.exp(sum(s for s, _ in w) / sum(c for _, c in w)))
               for w in (losses[:BUCKET_WINDOW], losses[-BUCKET_WINDOW:])]
        check(ppl[1] < ppl[0], "perplexity did not fall over the epoch: "
              "first %d batches %.2f, last %.2f" % (BUCKET_WINDOW, *ppl))
        want = BUCKET_LAYERS * steps
        check(launches == (want, want), "K4a/K4b launched %r over %d steps, "
              "expected %d each" % (launches, steps, want))
        check(sorted(mod._buckets) == sorted(BUCKETS),
              "bound buckets %r, expected %r" % (sorted(mod._buckets),
                                                 BUCKETS))
        # every bucket, switched to by a forward, holds the current
        # parameters bit for bit
        current, _ = mod.get_params()
        for key in BUCKETS:
            mod.forward(first[key], is_train=False)
            got, _ = mod.get_params()
            check(all(torch.equal(got[n]._data, current[n]._data)
                      for n in current),
                  "bucket %d's parameters differ from the current "
                  "bucket's after the switch" % key)
        copy_ms, copy_bytes = switch_copy_ms(torch, np, mod, dev)
        # (c) a Monitor on one batch
        mon = mx.mon.Monitor(1, pattern=".*")
        mod.install_monitor(mon)
        mon.tic()
        mod.forward_backward(first[max(BUCKETS)])
        mod.update()
        stats = mon.toc()
        check(stats and all(np.isfinite(float(v)) for _, _, v in stats),
              "monitor statistics: %r" % (stats[:4],))
        ckpt = bucketing_checkpoints(torch, mx, mod, sym_gen, dev)
        b60 = first[max(BUCKETS)]

        def step60():
            mod.forward_backward(b60)
            mod.update()
            s, c = bucket_nll(torch, mod.get_outputs()[0]._data,
                              b60.label[0]._data)
            return s / c
        prof = profile_step(torch, "bucketing lm T=%d" % max(BUCKETS),
                            step60)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    by_bucket = {}
    tokens, seconds = 0, 0.0
    for key in sorted(clock.times):
        ms = [1e3 * t for t in clock.times[key]]
        by_bucket[key] = {"steps": len(ms), "mean": sum(ms) / len(ms),
                          "p50": float(np.median(ms))}
        tokens += BUCKET_BATCH * key * len(ms)
        seconds += sum(clock.times[key])
    valid = sum(c for _, c in losses[1:])
    main = {"card": card, "model": "FusedRNNCell lstm bucketing",
            "vocab": BUCKET_VOCAB, "embed": BUCKET_EMBED,
            "hidden": BUCKET_HIDDEN, "layers": BUCKET_LAYERS,
            "batch": BUCKET_BATCH, "buckets": BUCKETS, "dtype": "float32",
            "steps": steps, "fit_s": fit_s, "step_ms_by_bucket": by_bucket,
            "tokens_per_s_padded": tokens / seconds,
            "tokens_per_s_valid": valid / seconds,
            "peak_memory_bytes": peak,
            "perplexity_first_last": ppl,
            "first_step_rel_frobenius": max(oracle.values()),
            "switch_copy_ms": copy_ms, "switch_copy_bytes": copy_bytes,
            "monitor_stats": len(stats), "checkpoints": ckpt,
            "k4_launches": {"fwd": launches[0], "bwd": launches[1]},
            "profile": prof}
    print("bucketing lm path (phase 15): " + json.dumps(main))
    return launches, main


def phase_bucketing_unrolled(torch, np, dev, card, fused_ms):
    """Phase 15b: examples/lstm_bucketing.py's counterpart, phase 15's width
    as a SequentialRNNCell of two LSTMCells (one graph node a step, no
    RNN op), BucketingModule at buckets UNROLLED_BUCKETS, UNROLLED_STEPS
    Adam steps each: finite losses, no K4 launch; step ms beside phase
    15's at the same buckets (`fused_ms`)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    sym_gen = bucketing_sym_gen(mx, BUCKET_VOCAB, BUCKET_EMBED,
                                BUCKET_HIDDEN, BUCKET_LAYERS, cell="unrolled")
    it = bucket_iter(np, mx, buckets=list(UNROLLED_BUCKETS))
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, []).append(b)
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=max(UNROLLED_BUCKETS),
                                 context=mx.gpu(dev.index or 0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": BUCKET_LR})
    fr.reset_launch_counts()
    out = {}
    for key in UNROLLED_BUCKETS:
        times, losses = [], []
        for batch in batches[key][:UNROLLED_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            s, c = bucket_nll(torch, mod.get_outputs()[0]._data,
                              batch.label[0]._data)
            losses.append(float(s / c))
            times.append(time.perf_counter() - t0)
        check(all(np.isfinite(losses)), "unrolled bucket %d losses %r"
              % (key, losses))
        ms = [1e3 * t for t in times[1:]]
        out[key] = {"steps_timed": len(ms), "step_ms_mean": sum(ms) / len(ms),
                    "step_ms_p50": float(np.median(ms)),
                    "first_step_ms": 1e3 * times[0], "losses": losses,
                    "fused_step_ms_p50": fused_ms.get(key, {}).get("p50")}
    check(fr.launch_counts() == (0, 0), "the unrolled cells launched K4: %r"
          % (fr.launch_counts(),))
    main = {"card": card, "model": "SequentialRNNCell(LSTMCell x 2)",
            "buckets": list(UNROLLED_BUCKETS), "by_bucket": out,
            "graph_nodes": len(sym_gen(max(UNROLLED_BUCKETS))[0]._topo())}
    print("bucketing unrolled path (phase 15b): " + json.dumps(main))
    return main


def phase_module_family(torch, np, dev, card):
    """Phase 15c: phase 12's MLP on its synthetic MNIST, one epoch each,
    as a SequentialModule (chip_smoke.mlp_halves: a feature Module, then a
    Module taking the labels) and through DataParallelExecutorManager
    over [gpu(0), gpu(0)] with tests/test_module.py's caller-side update
    (the slices' gradients summed over the batch, SGD lr MNIST_LR, here
    with momentum MNIST_MOMENTUM): validation accuracy > MNIST_ACC each."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.executor_manager import DataParallelExecutorManager
    ctx = mx.gpu(dev.index or 0)
    np.random.seed(0)
    train, val = mx.test_utils.get_mnist_iterator(batch_size=MNIST_BATCH,
                                                  input_shape=(784,))
    features, head = mlp_halves(mx.sym)
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(features, label_names=None, context=ctx))
    seq.add(mx.mod.Module(head, context=ctx), take_labels=True,
            auto_wiring=True)
    t0 = time.perf_counter()
    seq.fit(train, optimizer="sgd", initializer=mx.init.Xavier(),
            optimizer_params={"learning_rate": MNIST_LR,
                              "momentum": MNIST_MOMENTUM}, num_epoch=1)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    seq_acc = seq.score(val, "acc")[0][1]
    check(seq_acc > MNIST_ACC, "SequentialModule accuracy %.4f <= %g"
          % (seq_acc, MNIST_ACC))
    # the executor manager: two slices of each batch on one card
    sym = mx.models.get_mlp()
    names = sym.list_arguments()
    params = [n for n in names if n not in ("data", "softmax_label")]
    mgr = DataParallelExecutorManager(sym, [ctx, ctx], train, names, params,
                                      sym.list_auxiliary_states())
    init = mx.init.Xavier()
    arg = {n: mx.nd.zeros(a[0].shape, ctx=ctx)
           for n, a in zip(params, mgr.param_arrays)}
    for n, a in arg.items():
        init(mx.init.InitDesc(n), a)
    mgr.set_params(arg, {})
    moms = [torch.zeros_like(p[0]._data) for p in mgr.param_arrays]
    train.reset()
    t0 = time.perf_counter()
    for batch in train:
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        for i, (p_devs, g_devs) in enumerate(zip(mgr.param_arrays,
                                                 mgr.grad_arrays)):
            total = sum(g._data for g in g_devs) / MNIST_BATCH
            moms[i] = MNIST_MOMENTUM * moms[i] - MNIST_LR * total
            for p in p_devs:
                p._data = p._data + moms[i]
    torch.cuda.synchronize()
    mgr_s = time.perf_counter() - t0
    check(all(p._data.device == dev for devs in mgr.param_arrays
              for p in devs), "the manager's parameters left the card")
    metric = mx.metric.Accuracy()
    val.reset()
    for batch in val:
        mgr.load_data_batch(batch)
        mgr.forward(is_train=False)
        mgr.update_metric(metric, batch.label)
    mgr_acc = metric.get()[1]
    check(mgr_acc > MNIST_ACC, "DataParallelExecutorManager accuracy %.4f "
          "<= %g" % (mgr_acc, MNIST_ACC))
    main = {"card": card, "sequential_module": {"val_acc": seq_acc,
                                                "fit_s": seq_s},
            "executor_manager": {"contexts": 2, "val_acc": mgr_acc,
                                 "epoch_s": mgr_s}}
    print("module family (phase 15c): " + json.dumps(main))
    return main


def gluon_batchnorms(mx, block):
    """Every nn.BatchNorm block of a Gluon net, in order."""
    if isinstance(block, mx.gluon.nn.BatchNorm):
        yield block
    for child in block._children.values():
        yield from gluon_batchnorms(mx, child)


def inception_bn_shapes(torch, mx):
    """{(C, H, W): count} of the inputs Inception-v3's BatchNorm layers
    see at INC_IMAGE: forward hooks on the net's nn.BatchNorm blocks over
    one batch-1 forward on the card, held to INC_BNS."""
    from collections import Counter
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.name.NameManager():
        net = vision.inception_v3(classes=INC_CLASSES)
    net.initialize(mx.init.Xavier())
    bns = list(gluon_batchnorms(mx, net))
    seen = []
    for bn in bns:
        bn.register_forward_hook(
            lambda blk, args, out: seen.append(tuple(args[0].shape[1:])))
    net(mx.nd.zeros((1, 3, INC_IMAGE, INC_IMAGE)))
    check(len(seen) == len(bns), "Inception's %d BatchNorms ran %d times"
          % (len(bns), len(seen)))
    want = {(C, H, W): n for C, H, W, n in INC_BNS}
    check(Counter(seen) == want, "Inception's BatchNorm shapes %r, "
          "expected INC_BNS %r" % (dict(Counter(seen)), want))
    return Counter(seen)


def phase_kernels_bn_inception(torch, np, dev, card, shapes):
    """Phase 16: K3a-d against their plain versions at each distinct
    BatchNorm shape of a float32 Inception-v3 step at batch INC_BATCH
    (relu off: each of its BatchNorms feeds an Activation of its own),
    then each kernel timed there beside its plain version, its bound and
    the library yardsticks (bn_library_calls, each of which computes its
    kernel's function at every shape here; cuDNN's batch norm forward
    and backward for the kernel pairs), one row a shape and kernel, and
    the sums over the step's calls. Returns (errs, totals)."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    errs = {}
    order = sorted(shapes, key=lambda c: (-c[1] * c[2], c[0]))
    for i, (C, H, W) in enumerate(order):
        x, dy, _, gamma, beta = bn_inputs(torch, dev, INC_BATCH, C, H * W,
                                          torch.float32, seed=100 + i)
        bn_check(torch, fb, x, dy, None, gamma, beta, False, "float32",
                 errs, "Inception N=%d C=%d H=%d W=%d" % (INC_BATCH, C, H,
                                                          W))
        del x, dy
    print("fused_bn Inception-v3 check float32: %d shapes (%d BatchNorms "
          "a step), max |kernel - plain| %s; tol as phase 8's"
          % (len(order), sum(shapes.values()), ", ".join(
              "%s %.3g" % (kern, errs[kern, "float32"]) for kern in
              ("stats", "apply", "bwd_reduce", "bwd_dx"))))
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()

    kinds = ("stats", "apply", "bwd_reduce", "bwd_dx")
    total = bn_totals(kinds)
    pairs = {"fwd_kernels_ms": 0.0, "fwd_library_ms": 0.0,
             "bwd_kernels_ms": 0.0, "bwd_library_ms": 0.0}
    rows = []
    for C, H, W in order:
        count = shapes[C, H, W]
        t, pair_fwd, pair_bwd = bn_time(torch, fb, dev, C, H, W, False,
                                        False, torch.float32, flush,
                                        N=INC_BATCH)
        row = {"card": card, "dtype": "float32", "N": INC_BATCH, "C": C,
               "H": H, "W": W, "relu": False, "residual": False,
               "per_step": count, "library_pair_fwd_ms": pair_fwd,
               "library_pair_bwd_ms": pair_bwd}
        for kind in kinds:
            row[kind] = bn_time_row(fb, t, kind, INC_BATCH, C, H * W, 4,
                                    False, False)
            bn_add_total(total[kind], row[kind], count)
        pairs["fwd_kernels_ms"] += count * (t["stats"][0] + t["apply"][0])
        pairs["bwd_kernels_ms"] += count * (t["bwd_reduce"][0]
                                            + t["bwd_dx"][0])
        pairs["fwd_library_ms"] += count * pair_fwd
        pairs["bwd_library_ms"] += count * pair_bwd
        rows.append(row)
    del scratch
    for kind in kinds:
        for r in bn_shape_rows(rows, errs, kind):
            print("fused_bn %s per Inception shape: %s"
                  % (kind, json.dumps(r)))
    for kind in kinds:
        total[kind]["over_bound"] = total[kind]["ms"] / total[kind][
            "bound_ms"]
    print("fused_bn Inception-v3 step totals (float32, batch %d, %d calls "
          "of each kernel): %s" % (INC_BATCH, sum(shapes.values()),
                                   json.dumps({"card": card,
                                               "kernels": total,
                                               "pairs_vs_cudnn": pairs})))
    return errs, total


class GluonGrads:
    """`loss_and_grads(x, y)` of a Gluon net at fixed starting weights:
    one recorded forward and backward of the mean
    SoftmaxCrossEntropyLoss from the generators seeded alike (so each
    call draws the same dropout masks), after which the parameters (the
    moving statistics too) are put back; the loss and {name: gradient}
    as tensors. Lets resnet_first_step_check hold a Gluon step."""

    def __init__(self, mx, net):
        self.mx, self.net = mx, net
        self.params = net.collect_params()
        self.start = {n: p.data()._data.clone()
                      for n, p in self.params.items()}
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_and_grads(self, x, y):
        mx = self.mx
        mx.random.seed(0)
        with mx.autograd.record():
            loss = self.loss_fn(self.net(mx.nd.NDArray(x)),
                                mx.nd.NDArray(y)).mean()
        loss.backward()
        grads = {n: p.grad()._data.clone() for n, p in self.params.items()
                 if p.grad_req != "null"}
        for n, p in self.params.items():
            p.set_data(self.start[n].clone())
        return loss._data.detach(), grads


def phase_inception(torch, np, dev, card):
    """Phase 16b: Inception-v3 at its published width (INC_CLASSES
    classes, INC_IMAGE x INC_IMAGE NCHW, float32, batch INC_BATCH)
    trained as phase 14 trains ResNet-50, with MXNET_FUSED_BN_EPILOGUE=1:
    first the first step flag on against flag off beside the flag-off
    step's own floor (phase 9's check), then an eager and a hybridized
    net from the same weights stepped in turns (INC_WARMUP then
    INC_STEPS timed steps each) with K3a-d launched once a step for each
    of the net's BatchNorm blocks (counted from the net) in both modes.
    Returns ({mode: the timed steps' launches}, the summary)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_bn as fb
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    try:
        nets = {}
        for mode in ("eager", "hybridized"):
            with mx.name.NameManager():
                nets[mode] = vision.inception_v3(classes=INC_CLASSES)
            nets[mode].initialize(mx.init.Xavier())
            nets[mode](mx.nd.zeros((1, 3, INC_IMAGE, INC_IMAGE)))
        src = nets["eager"].collect_params()
        for n, p in nets["hybridized"].collect_params().items():
            p.set_data(src[n].data()._data.clone())
        n_bn = len(list(gluon_batchnorms(mx, nets["eager"])))
        x, y = prototype_batch(torch, dev, INC_BATCH, INC_CLASSES,
                               INC_IMAGE, 0)
        first = resnet_first_step_check(
            torch, fb, GluonGrads(mx, nets["eager"]), x, y,
            what="inception_v3")
        os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
        nets["hybridized"].hybridize()
        out, timed = train_in_turns(
            torch, np, mx, dev, "inception_v3", nets, mx.nd.NDArray(x),
            mx.nd.NDArray(y), INC_WARMUP, INC_STEPS, n_bn)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    main = {"card": card, "model": "inception_v3", "batch": INC_BATCH,
            "image": INC_IMAGE, "dtype": "float32", "warmup": INC_WARMUP,
            **out, "first_step_flag_on_vs_off": first,
            "k3_launches_a_step": n_bn}
    print("inception_v3 gluon path (phase 16b): " + json.dumps(main))
    return timed, main


def time_forward(torch, net, x, n):
    """(the logits of an inference forward, its mean ms over n more,
    host clock between synchronizes)."""
    out = net(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        net(x)
    torch.cuda.synchronize()
    return out._data.detach().clone(), 1e3 * (time.perf_counter() - t0) / n


def phase_zoo_families(torch, np, dev, card):
    """Phase 16c: each of ZOO_FAMILIES at its published width (1000
    classes, ZOO_IMAGE x ZOO_IMAGE, float32, batch ZOO_BATCH, Xavier
    weights): an inference forward eager, then hybridized (the cached
    graph) within ZOO_HYB_RTOL of the largest |logit|, and img/s of each;
    then for ZOO_TRAINED one eager gluon.Trainer step (sgd, G50_OPT) with
    MXNET_FUSED_BN_EPILOGUE=1: a finite loss and K3a-d launched once for
    each of the net's BatchNorm blocks. Returns ({path: launches}, the
    summary)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_bn as fb
    x, y = prototype_batch(torch, dev, ZOO_BATCH, 1000, ZOO_IMAGE, 5)
    x, y = mx.nd.NDArray(x), mx.nd.NDArray(y)
    out, launches = {}, {}
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    try:
        for name in ZOO_FAMILIES:
            with mx.name.NameManager():
                net = vision.get_model(name, classes=1000)
            net.initialize(mx.init.Xavier())
            eager, eager_ms = time_forward(torch, net, x, ZOO_TIMED)
            net.hybridize()
            hybrid, hybrid_ms = time_forward(torch, net, x, ZOO_TIMED)
            check(net._cached_graph is not None,
                  "%s: hybridized without its cached graph" % name)
            check(bool(torch.isfinite(eager).all()), "%s: logits not "
                  "finite" % name)
            err = float((hybrid - eager).abs().max()) / max(
                float(eager.abs().max()), 1e-30)
            check(err <= ZOO_HYB_RTOL, "%s: hybridized logits off the eager "
                  "ones by %.3g of the largest (> %g)" % (name, err,
                                                          ZOO_HYB_RTOL))
            rec = {"hybrid_vs_eager": err, "eager_ms": eager_ms,
                   "hybridized_ms": hybrid_ms,
                   "eager_img_per_s": ZOO_BATCH / (eager_ms / 1e3),
                   "hybridized_img_per_s": ZOO_BATCH / (hybrid_ms / 1e3)}
            if name in ZOO_TRAINED:
                net.hybridize(False)
                n_bn = len(list(gluon_batchnorms(mx, net)))
                trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                           dict(G50_OPT))
                fb.reset_launch_counts()
                loss = gluon_step(mx, net, trainer,
                                  mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                  x, y)
                torch.cuda.synchronize()
                counts = fb.launch_counts()
                check(bool(torch.isfinite(loss)), "%s: training loss not "
                      "finite" % name)
                check(counts == (n_bn,) * 4, "%s: K3a-d launched %r in a "
                      "step, expected %d each (its BatchNorms)"
                      % (name, counts, n_bn))
                launches[name + "_gluon_step"] = counts
                rec.update(train_loss=float(loss), batchnorms=n_bn)
            out[name] = rec
            del net
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    main = {"card": card, "batch": ZOO_BATCH, "image": ZOO_IMAGE,
            "dtype": "float32", "families": out}
    print("model zoo families (phase 16c): " + json.dumps(main))
    return launches, main


def gluon_loss_cases(np, L):
    """(name, loss, [inputs as numpy]) for each Gluon loss the port has,
    from a seeded generator."""
    rng = np.random.RandomState(0)
    pred = rng.uniform(-2, 2, (64, 10)).astype(np.float32)
    real = rng.uniform(-2, 2, (64, 10)).astype(np.float32)
    binary = (rng.uniform(0, 1, (64, 10)) > 0.5).astype(np.float32)
    prob = rng.uniform(0.05, 0.95, (64, 10)).astype(np.float32)
    dist = np.exp(real) / np.exp(real).sum(-1, keepdims=True)
    counts = rng.poisson(2.0, (64, 10)).astype(np.float32)
    sw = rng.uniform(0, 2, (64, 1)).astype(np.float32)
    classes = rng.randint(0, 10, (64,)).astype(np.float32)
    return [
        ("L2Loss", L.L2Loss(), [pred, real]),
        ("L1Loss", L.L1Loss(weight=0.5), [pred, real, sw]),
        ("SigmoidBCELoss", L.SigmoidBinaryCrossEntropyLoss(),
         [pred, binary]),
        ("SigmoidBCELoss_from_sigmoid",
         L.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True), [prob, binary]),
        ("SoftmaxCELoss", L.SoftmaxCrossEntropyLoss(), [pred, classes]),
        ("KLDivLoss", L.KLDivLoss(from_logits=False), [pred, dist]),
        ("HuberLoss", L.HuberLoss(rho=0.5), [pred, real]),
        ("HingeLoss", L.HingeLoss(), [pred, 2 * binary - 1]),
        ("SquaredHingeLoss", L.SquaredHingeLoss(), [pred, 2 * binary - 1]),
        ("LogisticLoss", L.LogisticLoss(), [pred, 2 * binary - 1]),
        ("TripletLoss", L.TripletLoss(), [pred, real, prob]),
        ("PoissonNLLLoss", L.PoissonNLLLoss(compute_full=True),
         [pred, counts])]


def phase_gluon_cells(torch, np, dev, card):
    """Phase 16d: a SequentialRNNCell of two gluon.rnn.LSTMCells unrolled
    over CELL_T steps (TNC, batch CELL_N, input CELL_C, hidden CELL_H,
    float32; the cells compose FullyConnected, SliceChannel and the gate
    activations) against gluon.rnn.LSTM with the same weights under
    MXNET_FUSED_RNN=1, whose forward is K4a once a layer: outputs and
    final states within ops/fused_rnn.py PLAIN_TOL. Then each Gluon loss
    evaluated on the card against the same loss on the CPU. Returns
    (the K4a/K4b launches of the layer's forward, the summary)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    rnn = mx.gluon.rnn
    with mx.name.NameManager():
        stack = rnn.SequentialRNNCell()
        with stack.name_scope():
            stack.add(rnn.LSTMCell(CELL_H, input_size=CELL_C))
            stack.add(rnn.LSTMCell(CELL_H, input_size=CELL_H))
        layer = rnn.LSTM(CELL_H, num_layers=2, input_size=CELL_C)
    stack.initialize(mx.init.Xavier())
    layer.initialize(mx.init.Xavier())
    lp = layer.collect_params()
    for i, cell in enumerate(stack._children.values()):
        for part in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            value = getattr(cell, part).data()._data
            if part.endswith("bias"):   # Xavier leaves biases at zero
                value = 0.1 * torch.randn(value.shape, device=dev,
                                          generator=torch.Generator(
                                              device=dev).manual_seed(i))
                getattr(cell, part).set_data(value)
            lp["%sl%d_%s" % (layer.prefix, i, part)].set_data(value.clone())
    g = torch.Generator(device=dev).manual_seed(16)
    x = mx.nd.NDArray(torch.rand((CELL_T, CELL_N, CELL_C), generator=g,
                                 device=dev) * 2 - 1)
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    try:
        outs, states = stack.unroll(CELL_T, x, layout="TNC",
                                    merge_outputs=True)
        fr.reset_launch_counts()
        fused_out, (h, c) = layer(x, layer.begin_state(CELL_N))
        torch.cuda.synchronize()
        launches = fr.launch_counts()
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    check(launches == (2, 0), "gluon.rnn.LSTM's forward launched K4a/K4b "
          "%r times, expected (2, 0)" % (launches,))
    pairs = {"outputs": (fused_out, outs), "h0": (h[0], states[0]),
             "c0": (c[0], states[1]), "h1": (h[1], states[2]),
             "c1": (c[1], states[3])}
    errs = {}
    for what, (got, want) in pairs.items():
        bad = fr.plain_mismatch(got._data, want._data)
        check(bad is None, "LSTMCell stack against gluon.rnn.LSTM on K4a, "
              "%s: %s" % (what, bad))
        errs[what] = fr.plain_error(got._data, want._data)[:2]
    loss_errs = {}
    for name, fn, arrays in gluon_loss_cases(np, mx.gluon.loss):
        want, got = [fn(*[mx.nd.array(a, ctx=ctx) for a in arrays])
                     .asnumpy() for ctx in (mx.cpu(),
                                            mx.gpu(dev.index or 0))]
        err = float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
        check(np.isfinite(got).all() and err <= LOSS_CARD_RTOL,
              "%s on the card off the CPU by %.3g of the largest value "
              "(> %g)" % (name, err, LOSS_CARD_RTOL))
        loss_errs[name] = err
    main = {"card": card, "T": CELL_T, "N": CELL_N, "hidden": CELL_H,
            "layers": 2, "dtype": "float32",
            "cells_vs_k4a": {k: {"rel_frobenius": v[0], "rel_max": v[1]}
                             for k, v in errs.items()},
            "k4_launches": launches, "losses_card_vs_cpu": loss_errs}
    print("gluon cells and losses (phase 16d): " + json.dumps(main))
    return launches, main


def rnn_kernel_rows(errs, rows, by_path):
    """K4a-b's entries of the kernels line: phase 10's timings at the
    path's shape in bfloat16 (the timed run's type) with their design and
    its serial floor, the launches of phase 11's timed TrainStep run,
    phase 14c's hybridized Gluon steps and phase 15's bucketed epoch
    through BucketingModule, summed and split in `launches_by_path`, and
    the largest float32 kernel-vs-plain error."""
    out = []
    for i, (kind, line) in enumerate((("fwd", 209), ("bwd", 323))):
        r = rows[kind, "bfloat16"]
        split = {path: counts[i] for path, counts in by_path.items()}
        out.append({
            "name": "fused_rnn_" + kind,
            "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/fused_rnn.cu",
            "replaces": "mxnet_tpu/ops/pallas_rnn.py:%d" % line,
            "launches": sum(split.values()),
            "launches_by_path": split,
            "max_abs_err": errs[kind, "float32"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "design": r["design"],
            "serial_floor_ms": r["serial_floor_ms"],
        })
    return out


#: phase 17: the optimizers on the word LM at phase 11's width in float32,
#: with the hyper-parameters of tests/test_trainstep_optimizers.py:22-41;
#: TrainStep against gluon.Trainer from the same weights and batches,
#: held to that test's rtol / atol after OPT_STEPS steps
OPT_PARAMS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
    "ccsgd": {"learning_rate": 0.1, "momentum": 0.9},
    "signum": {"learning_rate": 0.05, "momentum": 0.9, "wd_lh": 1e-3},
    "ftml": {"learning_rate": 0.02},
    "lbsgd": {"learning_rate": 0.1, "momentum": 0.9},
    "dcasgd": {"learning_rate": 0.05, "momentum": 0.9},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "sgld": {"learning_rate": 0.01},
    "adam": {"learning_rate": 0.01},
    "adagrad": {"learning_rate": 0.1},
    "rmsprop": {"learning_rate": 0.01, "centered": True},
    "adadelta": {},
    "ftrl": {"learning_rate": 0.1, "lamda1": 1e-4},
    "adamax": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "test": {},
}
OPT_STEPS, OPT_RTOL, OPT_ATOL = 5, 2e-4, 2e-5
#: phase 17b: each nd.*_update op against its optimizer rule on one
#: float32 tensor of ResNet-50 v1's parameter count, the largest error
#: over the largest |rule value| within UPDATE_OP_TOL (the same float32
#: elementwise ops, grouped otherwise)
UPDATE_OP_NUMEL, UPDATE_OP_TOL = 25_557_032, 1e-5
#: phase 18: remat on phase 9's ResNet-50 (bf16 over float32 masters,
#: batch 256); K3a-d launches a step for none, full and io
REMAT_MODES = ("none", "full", "io")
REMAT_LAUNCHES = {"none": (53, 53, 53, 53), "full": (106, 106, 53, 53),
                  "io": (53, 106, 53, 53)}
REMAT_WARMUP, REMAT_STEPS, REMAT_STATS_STEPS = 2, 10, 3
#: the running stats after REMAT_STATS_STEPS float32 steps (cuDNN's
#: deterministic algorithms), each mode's against none's: the largest
#: error over the largest |value|
REMAT_STATS_TOL = 1e-5
#: functionalize's output against the net's own (predict mode)
FUNC_TOL, FUNC_BATCH = 1e-5, 32
#: phase 20: the CSV MLP (BASELINE config 1's get_mlp on a CSV of the
#: synthetic MNIST through CSVIter + DevicePrefetchIter)
CSV_ROWS, CSV_BATCH, CSV_PREFETCH = 10000, 100, 2


def restore_params(params, start):
    """Put the saved tensors back (copies: the steps update in place)."""
    for n, p in params.items():
        p.set_data(start[n].clone())


def param_violation(torch, got, want, rtol, atol):
    """max over tensors of max (|got - want| - atol - rtol |want|): at
    most 0 passes (numpy.allclose's rule)."""
    return max(float(((got[n] - w).abs() - atol - rtol * w.abs()).max())
               for n, w in want.items())


def phase_optimizers(torch, np, dev, card):
    """Phase 17: every registered optimizer on the word LM at bench width
    (phase 11's config, float32, MXNET_FUSED_RNN=1): OPT_STEPS steps
    through TrainStep and through gluon.Trainer (record, backward,
    step) from the same weights and batches, the parameters held to
    OPT_RTOL / OPT_ATOL (SGLD: finite and moved), K4a and K4b launched
    LM_LAYERS times a step on both paths, step ms of each. Returns the
    (K4a, K4b) launches and the summary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel import TrainStep
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    try:
        net = word_lm_net(torch, mx, dev, 0.0)
        params = net.collect_params()
        start = {n: p.data()._data.detach().clone()
                 for n, p in params.items()}
        rng = np.random.RandomState(1)
        batches = [(torch.from_numpy(rng.randint(0, LM_VOCAB, (
            LM_BPTT, LM_BATCH)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randint(0, LM_VOCAB, (
                LM_BPTT * LM_BATCH,)).astype(np.int32)).to(dev))
            for _ in range(OPT_STEPS)]
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        want_k4 = (LM_LAYERS * OPT_STEPS,) * 2
        rows, total = {}, [0, 0]

        def timed(one):
            times = []
            fr.reset_launch_counts()
            for x, y in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one(x, y)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            k4 = fr.launch_counts()
            return 1e3 * sum(times[1:]) / len(times[1:]), k4

        for name in sorted(OPT_PARAMS):
            kw = OPT_PARAMS[name]
            restore_params(params, start)
            mx.random.seed(0)
            step = TrainStep(net, loss_fn, name, dict(kw))
            fused_ms, k4_f = timed(step)
            fused = {n: p.data()._data.detach().clone()
                     for n, p in params.items()}
            restore_params(params, start)
            mx.random.seed(0)
            trainer = mx.gluon.Trainer(params, name, dict(kw),
                                       kvstore=None)

            def eager(x, y):
                with mx.autograd.record():
                    L = loss_fn(net(mx.nd.NDArray(x)), mx.nd.NDArray(y))
                L.backward()
                trainer.step(y.shape[0])

            eager_ms, k4_e = timed(eager)
            got = {n: p.data()._data.detach().clone()
                   for n, p in params.items()}
            check(k4_f == want_k4 and k4_e == want_k4,
                  "%s: K4a/K4b launched %r (TrainStep) and %r (Trainer) "
                  "times over %d steps, expected %r" % (
                      name, k4_f, k4_e, OPT_STEPS, want_k4))
            viol = param_violation(torch, got, fused, OPT_RTOL, OPT_ATOL)
            moved = min(float((fused[n] - start[n]).abs().max())
                        for n in fused)
            check(all(bool(torch.isfinite(v).all()) for v in fused.values())
                  and moved > 0, "%s: parameters not finite or unmoved"
                  % name)
            diff = max(float((got[n] - w).abs().max())
                       for n, w in fused.items())
            floor = None
            if name != "sgld" and viol > 0:
                # beyond the reference test's tolerance: hold the two to
                # twice the Trainer's own floor, the same Trainer steps
                # with the loss's 1/N taken before the backward (as
                # TrainStep takes it) instead of in the update. At Xavier
                # init the word LM's gradients sit near 1e-8, where FTML
                # and Nadam divide by sqrt(v) + 1e-8 with v bias-corrected,
                # so their trajectories carry the gradients' rounding
                restore_params(params, start)
                mx.random.seed(0)
                trainer = mx.gluon.Trainer(params, name, dict(kw),
                                           kvstore=None)
                for x, y in batches:
                    with mx.autograd.record():
                        L = loss_fn(net(mx.nd.NDArray(x)),
                                    mx.nd.NDArray(y)).mean()
                    L.backward()
                    trainer.step(1)
                floor = max(float((p.data()._data.detach() - got[n])
                                  .abs().max()) for n, p in params.items())
                check(diff <= 2 * floor, "%s: TrainStep and Trainer "
                      "parameters differ beyond rtol %g atol %g (by %.3g) "
                      "and by %.3g > twice the Trainer's own floor %.3g"
                      % (name, OPT_RTOL, OPT_ATOL, viol, diff, floor))
            total[0] += k4_f[0] + k4_e[0]
            total[1] += k4_f[1] + k4_e[1]
            rows[name] = {"trainstep_ms": fused_ms, "trainer_ms": eager_ms,
                          "allclose_excess": viol, "max_abs_diff": diff,
                          "trainer_mean_loss_floor": floor}
            del step, trainer
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    sgd = rows["sgd"]
    for r in rows.values():
        r["trainstep_vs_sgd"] = r["trainstep_ms"] / sgd["trainstep_ms"]
        r["trainer_vs_sgd"] = r["trainer_ms"] / sgd["trainer_ms"]
    slowest = max(rows, key=lambda n: rows[n]["trainstep_ms"])
    main = {"card": card, "model": "RNNModel lstm", "vocab": LM_VOCAB,
            "hidden": LM_HIDDEN, "layers": LM_LAYERS, "bptt": LM_BPTT,
            "batch": LM_BATCH, "dtype": "float32", "steps": OPT_STEPS,
            "step_ms_over": "steps 2-%d" % OPT_STEPS,
            "slowest_trainstep": slowest, "by_optimizer": rows,
            "k4_launches": total}
    print("optimizers on the word LM (phase 17): " + json.dumps(main))
    return tuple(total), main


def update_op_cases(torch, rules, w, g, st, wbf):
    """(op name, nd arguments, keyword arguments, rule (name, hyper,
    state, lr, wd, t, weight, grad)) for each update op: the op's
    contract equals its rule's at these arguments (adam_update takes the
    bias-corrected lr; adagrad's epsilon sits outside the square root,
    1e-7 against histories of at least 0.25)."""
    lr, wd, b1, b2 = 0.01, 1e-4, 0.9, 0.999
    lr_t = lr * math.sqrt(1 - b2) / (1 - b1)
    g32 = wbf[1].float()
    return [
        ("sgd_update", (w, g), dict(lr=lr, wd=wd),
         ("sgd", {}, (), lr, wd, 1, w, g)),
        ("sgd_mom_update", (w, g, st[0]), dict(lr=lr, momentum=0.9, wd=wd),
         ("sgd", {"momentum": 0.9}, (st[0],), lr, wd, 1, w, g)),
        ("mp_sgd_update", (wbf[0], wbf[1], w), dict(lr=lr, wd=wd),
         ("sgd", {}, (), lr, wd, 1, w, g32)),
        ("mp_sgd_mom_update", (wbf[0], wbf[1], st[0], w),
         dict(lr=lr, momentum=0.9, wd=wd),
         ("sgd", {"momentum": 0.9}, (st[0],), lr, wd, 1, w, g32)),
        ("signsgd_update", (w, g), dict(lr=lr, wd=wd),
         ("signum", {"momentum": 0.0}, (), lr, wd, 1, w, g)),
        ("signum_update", (w, g, st[0]),
         dict(lr=lr, momentum=0.9, wd=wd, wd_lh=1e-3),
         ("signum", {"momentum": 0.9, "wd_lh": 1e-3}, (st[0],), lr, wd, 1,
          w, g)),
        ("adam_update", (w, g, st[0], st[1]), dict(lr=lr_t, wd=wd),
         ("adam", {}, (st[0], st[1]), lr, wd, 1, w, g)),
        ("rmsprop_update", (w, g, st[0]), dict(lr=lr, gamma1=0.9, wd=wd),
         ("rmsprop", {"gamma1": 0.9}, (st[0],), lr, wd, 1, w, g)),
        ("rmspropalex_update", (w, g, st[0], st[1], st[2]),
         dict(lr=lr, gamma1=0.9, gamma2=0.9, wd=wd),
         ("rmsprop", {"centered": True}, (st[0], st[1], st[2]), lr, wd, 1,
          w, g)),
        ("ftml_update", (w, g, st[3], st[1], st[2]), dict(lr=lr, wd=wd, t=1),
         ("ftml", {}, (st[3], st[1], st[2]), lr, wd, 1, w, g)),
        ("ftrl_update", (w, g, st[2], st[1]), dict(lr=lr, wd=wd),
         ("ftrl", {}, (st[2], st[1]), lr, wd, 1, w, g)),
        ("_sparse_adagrad_update", (w, g, st[1]), dict(lr=lr, wd=wd),
         ("adagrad", {}, (st[1],), lr, wd, 1, w, g)),
        ("adagrad_update", (w, g, st[1]), dict(lr=lr, wd=wd),
         ("adagrad", {}, (st[1],), lr, wd, 1, w, g)),
    ]


def phase_update_ops(torch, np, dev, card):
    """Phase 17b: each nd.*_update op (its state arguments written in
    place, the weight through `out=`) against its optimizer rule on one
    UPDATE_OP_NUMEL-element float32 tensor, within UPDATE_OP_TOL; the
    op's device ms (time_ms) beside the rule's and the bytes it must
    move over the card's memory rate."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer_rules as rules
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(lo, hi):
        return torch.rand(UPDATE_OP_NUMEL, generator=gen,
                          device=dev) * (hi - lo) + lo

    w, g = uniform(-1, 1), uniform(-1, 1)
    st = [uniform(0.25, 0.5) for _ in range(3)] + [uniform(1.0, 1.5)]
    wbf = (w.to(torch.bfloat16), g.to(torch.bfloat16))
    rows = {}
    for name, args, kw, rule in update_op_cases(torch, rules, w, g, st,
                                                wbf):
        rname, hyper, rstate, lr, wd, t, rw, rg = rule
        _, apply_rule = rules.get(rname)
        want_w, want_s = apply_rule(rw, rg, tuple(rstate), lr, wd, t, hyper)
        nds = [mx.nd.NDArray(a.clone()) for a in args]
        out = mx.nd.NDArray(args[0].clone())
        res = getattr(mx.nd, name)(*nds, out=out, **kw)
        check(res is out, "%s: out= not honoured" % name)
        got_w = (nds[-1] if name.startswith("mp_") else out)._data
        err = float((got_w.float() - want_w).abs().max()) / float(
            want_w.abs().max())
        n_state = 1 if name.startswith("mp_") else 0
        got_s = [a._data for a in nds[2:len(nds) - n_state]]
        for a, b in zip(got_s, want_s):
            err = max(err, float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30))
        check(err <= UPDATE_OP_TOL, "%s against the %s rule: %.3g > %g"
              % (name, rname, err, UPDATE_OP_TOL))
        fresh = [mx.nd.NDArray(a.clone()) for a in args]
        op = getattr(mx.nd, name)
        ms = time_ms(torch, lambda: op(*fresh, out=fresh[0], **kw), n=10,
                     sleep=False)
        rule_ms = time_ms(torch, lambda: apply_rule(
            rw, rg, tuple(rstate), lr, wd, t, hyper), n=10, sleep=False)
        moved = sum(a.numel() * a.element_size() for a in args) + sum(
            a.numel() * a.element_size() for a in args
            if a is not args[1])
        rows[name] = {"rule": rname, "rel_err": err, "ms": ms,
                      "rule_ms": rule_ms,
                      "bytes_bound_ms": 1e3 * moved / HBM_BYTES_S}
    main = {"card": card, "numel": UPDATE_OP_NUMEL, "dtype": "float32",
            "tol": UPDATE_OP_TOL, "by_op": rows}
    print("update ops (phase 17b): " + json.dumps(main))
    return main


def phase_remat(torch, np, dev, card):
    """Phase 18: remat on phase 9's ResNet-50 (MXNET_FUSED_BN_EPILOGUE=1).
    (a) the first float32 step of "full" and "io" against none: the loss
    and every gradient to phase 9's floor (none against a second run of
    itself, cuDNN's nondeterminism, printed beside); (b) the running
    stats after REMAT_STATS_STEPS float32 steps with cuDNN's
    deterministic algorithms, each mode against none within
    REMAT_STATS_TOL; (c) bf16 timed runs, REMAT_WARMUP + REMAT_STEPS
    steps a mode from the same weights: K3a-d launches a step
    (REMAT_LAUNCHES), step ms, peak memory and memory_analysis's
    temp bytes, "full" and "io" below none; (d) functionalize(net) on
    the step's values against net(x) in predict mode. Returns {mode:
    K3a-d launches of its timed run} and the summary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.parallel import TrainStep, functionalize
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    cudnn = torch.backends.cudnn
    try:
        net = vision.resnet50_v1(classes=R50_CLASSES)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 3, R50_IMAGE, R50_IMAGE)))
        params = net.collect_params()
        start = {n: p.data()._data.detach().clone()
                 for n, p in params.items()}
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.uniform(
            -1, 1, (R50_BATCH, 3, R50_IMAGE, R50_IMAGE)).astype(
                np.float32)).to(dev)
        y = torch.from_numpy(rng.randint(0, R50_CLASSES, (R50_BATCH,))
                             .astype(np.int32)).to(dev)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        # (a) the first float32 step
        first = {}
        for run in ("none", "none_again", "full", "io"):
            restore_params(params, start)
            step = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                             remat=run.split("_")[0])
            loss, grads = step.loss_and_grads(x, y)
            first[run] = (float(loss), grads)
            del step
        base_loss, base = first["none"]
        zero = [n for n in base if "conv2d" in n and n.endswith("_bias")]
        top = max(float(g.abs().max()) for g in base.values())
        floor = max(rel_frobenius(first["none_again"][1][n], g)
                    for n, g in base.items() if n not in zero)
        tol = max(2 * floor, R50_GRAD_MIN_TOL)
        oracle = {"grad_floor_second_run": floor, "grad_tol": tol}
        for mode in ("full", "io"):
            loss, grads = first[mode]
            loss_err = abs(loss - base_loss) / abs(base_loss)
            worst = max((rel_frobenius(grads[n], g), n)
                        for n, g in base.items() if n not in zero)
            worst_zero = max([float(grads[n].abs().max()) / top
                              for n in zero] + [0.0])
            check(loss_err <= R50_LOSS_RTOL, "remat %s first-step loss "
                  "%r against none %r (rel err %.3g > %g)"
                  % (mode, loss, base_loss, loss_err, R50_LOSS_RTOL))
            check(worst[0] <= tol, "remat %s first-step grad %s: relative "
                  "Frobenius error %.3g > max(2 x floor %.3g, %g)"
                  % (mode, worst[1], worst[0], floor, R50_GRAD_MIN_TOL))
            check(worst_zero <= R50_ZERO_GRAD, "remat %s: a conv bias "
                  "feeding a BatchNorm has a gradient of %.3g of the "
                  "largest" % (mode, worst_zero))
            oracle[mode] = {"loss_rel_err": loss_err,
                            "grad_rel_err": worst[0], "worst": worst[1]}
        del first, base
        print("resnet50 remat oracle (phase 18a): cuDNN's convolution "
              "gradients move by %.3g (relative Frobenius) between two "
              "identical none steps; %s" % (floor, json.dumps(oracle)))

        # (b) the running stats after REMAT_STATS_STEPS deterministic steps
        aux = [n for n, p in params.items() if p.grad_req == "null"]
        stats = {}
        prior_det = (cudnn.deterministic, cudnn.benchmark)
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            for mode in REMAT_MODES:
                restore_params(params, start)
                step = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                                 remat=mode)
                for _ in range(REMAT_STATS_STEPS):
                    step(x, y)
                stats[mode] = {n: params[n].data()._data.detach().clone()
                               for n in aux}
                del step
        finally:
            cudnn.deterministic, cudnn.benchmark = prior_det
        stats_err = {}
        for mode in ("full", "io"):
            stats_err[mode] = max(
                float((stats[mode][n] - v).abs().max())
                / max(float(v.abs().max()), 1e-30)
                for n, v in stats["none"].items())
            check(stats_err[mode] <= REMAT_STATS_TOL,
                  "remat %s: running stats after %d steps differ from "
                  "none's by %.3g > %g" % (mode, REMAT_STATS_STEPS,
                                           stats_err[mode], REMAT_STATS_TOL))
        moved = max(float((stats["none"][n] - start[n]).abs().max())
                    for n in aux)
        check(moved > 0, "the running stats did not move")
        del stats

        # (c) the bf16 timed runs
        runs, launches = {}, {}
        for mode in REMAT_MODES:
            restore_params(params, start)
            step = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                             dtype="bfloat16", remat=mode)
            fb.reset_launch_counts()
            losses = [float(step(x, y))]
            one = fb.launch_counts()
            check(one == REMAT_LAUNCHES[mode],
                  "remat %s: K3a-d launched %r times in a step, expected "
                  "%r" % (mode, one, REMAT_LAUNCHES[mode]))
            for _ in range(REMAT_WARMUP - 1):
                losses.append(float(step(x, y)))
            times = []
            for _ in range(REMAT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step(x, y)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(loss))
            launches[mode] = fb.launch_counts()
            check(launches[mode] == tuple(
                c * (REMAT_WARMUP + REMAT_STEPS) for c in one),
                "remat %s: K3a-d launched %r over %d steps"
                % (mode, launches[mode], REMAT_WARMUP + REMAT_STEPS))
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  "remat %s: losses not finite or not falling: %r"
                  % (mode, losses))
            ma = step.memory_analysis()
            ms = sorted(1e3 * t for t in times)
            runs[mode] = {"step_ms_mean": sum(ms) / len(ms),
                          "step_ms_p50": float(np.median(ms)),
                          "img_per_s": R50_BATCH / (sum(ms) / len(ms) / 1e3),
                          "peak_bytes": ma.peak_bytes,
                          "temp_size_in_bytes": ma.temp_size_in_bytes,
                          "loss_first": losses[0], "loss_last": losses[-1],
                          "k3_launches_a_step": list(one)}
            del step
        for mode in ("full", "io"):
            check(runs[mode]["peak_bytes"] < runs["none"]["peak_bytes"],
                  "remat %s: peak memory %d not below none's %d"
                  % (mode, runs[mode]["peak_bytes"],
                     runs["none"]["peak_bytes"]))
            check(runs[mode]["temp_size_in_bytes"]
                  < runs["none"]["temp_size_in_bytes"],
                  "remat %s: temp bytes %d not below none's %d"
                  % (mode, runs[mode]["temp_size_in_bytes"],
                     runs["none"]["temp_size_in_bytes"]))

        # (d) functionalize against the net itself
        apply_fn, names, values = functionalize(net)
        xs = x[:FUNC_BATCH]
        with torch.no_grad():
            got = apply_fn(values, xs)
            want = net(mx.nd.NDArray(xs))._data
        func_err = float((got - want).abs().max()) / float(
            want.abs().max())
        check(func_err <= FUNC_TOL, "functionalize(net) against net(x): "
              "%.3g > %g" % (func_err, FUNC_TOL))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    main = {"card": card, "model": "resnet50_v1", "batch": R50_BATCH,
            "image": R50_IMAGE, "dtype": "bfloat16",
            "steps_timed": REMAT_STEPS, "first_step_float32": oracle,
            "running_stats_rel_err": stats_err, "by_mode": runs,
            "functionalize_rel_err": func_err}
    print("resnet50 remat (phase 18): " + json.dumps(main))
    return launches, main


def phase_guard_probe_resume(torch, np, dev, card):
    """Phase 19: (a) guard=True on ResNet-50 (phase 9's bf16 config,
    cuDNN's deterministic algorithms so that two steps can be compared
    bit for bit): a finite step equals the unguarded step, a batch with
    one NaN leaves the parameters, the momentum and the running stats
    bit-equal to before with last_step_ok False; (b) two probes of the
    word LM (dropout 0.5, Adam) bit-identical, nothing changed; (c) the
    word LM resumed from step 3's state_dict to step 5 bit-equal to the
    straight run. Returns the K3a-d and K4a-b launches and the
    summary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel import TrainStep
    prior = {k: os.environ.get(k) for k in ("MXNET_FUSED_BN_EPILOGUE",
                                            "MXNET_FUSED_RNN")}
    os.environ.update(MXNET_FUSED_BN_EPILOGUE="1", MXNET_FUSED_RNN="1")
    cudnn = torch.backends.cudnn
    prior_det = (cudnn.deterministic, cudnn.benchmark)
    out = {"card": card}
    try:
        # (a) the guard
        net = vision.resnet50_v1(classes=R50_CLASSES)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 3, R50_IMAGE, R50_IMAGE)))
        params = net.collect_params()
        start = {n: p.data()._data.detach().clone()
                 for n, p in params.items()}
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.uniform(
            -1, 1, (R50_BATCH, 3, R50_IMAGE, R50_IMAGE)).astype(
                np.float32)).to(dev)
        y = torch.from_numpy(rng.randint(0, R50_CLASSES, (R50_BATCH,))
                             .astype(np.int32)).to(dev)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        cudnn.deterministic, cudnn.benchmark = True, False
        fb.reset_launch_counts()
        plain = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                          dtype="bfloat16")
        plain(x, y)
        want = {n: p.data()._data.detach().clone()
                for n, p in params.items()}
        del plain
        restore_params(params, start)
        step = TrainStep(net, loss_fn, "sgd", dict(R50_OPT),
                         dtype="bfloat16", guard=True)
        step(x, y)
        check(bool(step.last_step_ok), "guard: a finite step was dropped")
        check(all(torch.equal(p.data()._data, want[n])
                  for n, p in params.items()),
              "guard: the finite guarded step differs from the unguarded")
        before = {n: p.data()._data.detach().clone()
                  for n, p in params.items()}
        mom = [[s.clone() for s in st] for st in step._opt_state]
        x_bad = x.clone()
        x_bad[3, 1, 17, 29] = float("nan")
        step(x_bad, y)
        check(not bool(step.last_step_ok), "guard: the NaN step was kept")
        check(all(torch.equal(p.data()._data, before[n])
                  for n, p in params.items())
              and all(torch.equal(a, b) for sa, sb in zip(step._opt_state,
                                                          mom)
                      for a, b in zip(sa, sb)),
              "guard: the NaN step changed the parameters, the momentum "
              "or the running stats")
        out["guard"] = {"finite_step": "bit-equal to unguarded",
                        "nan_step": "dropped, state bit-equal",
                        "grad_norm_nan_step": float(step.last_grad_norm)}
        k3 = fb.launch_counts()
        cudnn.deterministic, cudnn.benchmark = prior_det
        del net, step, params, start, want, before, mom, x, x_bad

        # (b) the probe and (c) resume, on the word LM
        mx.random.seed(0)
        lm = word_lm_net(torch, mx, dev, 0.5)
        lparams = lm.collect_params()
        rng = np.random.RandomState(2)
        batches = [(torch.from_numpy(rng.randint(0, LM_VOCAB, (
            LM_BPTT, LM_BATCH)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randint(0, LM_VOCAB, (
                LM_BPTT * LM_BATCH,)).astype(np.int32)).to(dev))
            for _ in range(5)]
        fr.reset_launch_counts()
        step = TrainStep(lm, loss_fn, "adam", {"learning_rate": 0.001})
        for xb, yb in batches[:3]:
            step(xb, yb)
        snap = {n: p.data()._data.detach().clone()
                for n, p in lparams.items()}
        opt = [[s.clone() for s in st] for st in step._opt_state]
        gens = mx.random.get_state()
        p1 = step.probe(*batches[3], seed=5)
        p2 = step.probe(*batches[3], seed=5)
        check(p1 == p2, "probe: two probes differ: %r %r" % (p1, p2))
        gens_after = mx.random.get_state()
        check(step.t == 3
              and all(torch.equal(p.data()._data, snap[n])
                      for n, p in lparams.items())
              and all(torch.equal(a, b) for sa, sb in zip(step._opt_state,
                                                          opt)
                      for a, b in zip(sa, sb))
              and sorted(gens) == sorted(gens_after)
              and all(np.array_equal(gens[k], gens_after[k]) for k in gens),
              "probe: it changed the parameters, the state, t or the "
              "generators")
        out["probe"] = {"loss": p1[0], "grad_norm": p1[1],
                        "repeat": "bit-identical"}
        state = step.state_dict()
        straight = [float(step(xb, yb)) for xb, yb in batches[3:]]
        want = {n: p.data()._data.detach().clone()
                for n, p in lparams.items()}
        step.load_state_dict(state)
        again = [float(step(xb, yb)) for xb, yb in batches[3:]]
        check(again == straight and all(
            torch.equal(p.data()._data, want[n])
            for n, p in lparams.items()),
            "resume: steps 4-5 after load_state_dict differ from the "
            "straight run (losses %r against %r)" % (again, straight))
        out["resume"] = {"losses_4_5": straight,
                         "parameters": "bit-equal"}
        k4 = fr.launch_counts()
        check(k4[0] > 0 and k4[1] > 0, "K4a/K4b did not launch")
    finally:
        cudnn.deterministic, cudnn.benchmark = prior_det
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print("guard, probe and resume (phase 19): " + json.dumps(out))
    return k3, k4, out


def phase_data(torch, np, dev, card):
    """Phase 20: BASELINE config 1's MLP through Module.fit, one epoch,
    reading a CSV_ROWS-row CSV of the synthetic MNIST (784 columns, and
    a label CSV) through CSVIter wrapped in DevicePrefetchIter(depth
    CSV_PREFETCH): accuracy on the 1000 test images > MNIST_ACC; step ms
    with and without the prefetch. Then an autograd.Function (the
    reference doc's sigmoid) on the card against the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data.vision.datasets import _synthetic
    raw, lab = _synthetic(CSV_ROWS, (28, 28, 1), 10, seed=42)
    data = raw.reshape(CSV_ROWS, -1).astype(np.float32) / 255.0
    vraw, vlab = _synthetic(1000, (28, 28, 1), 10, seed=43)
    val = mx.io.NDArrayIter(vraw.reshape(1000, -1).astype(np.float32)
                            / 255.0, vlab.astype(np.float32),
                            batch_size=CSV_BATCH)
    out = {"card": card, "rows": CSV_ROWS, "batch": CSV_BATCH}
    with tempfile.TemporaryDirectory() as tmp:
        f, lf = os.path.join(tmp, "d.csv"), os.path.join(tmp, "l.csv")
        t0 = time.perf_counter()
        np.savetxt(f, data, delimiter=",", fmt="%.4f")
        np.savetxt(lf, lab, delimiter=",", fmt="%d")
        out["csv_write_s"] = time.perf_counter() - t0
        for prefetch in (True, False):
            np.random.seed(0)
            mx.random.seed(0)
            t0 = time.perf_counter()
            it = mx.io.CSVIter(data_csv=f, data_shape=(784,), label_csv=lf,
                               batch_size=CSV_BATCH)
            read_s = time.perf_counter() - t0
            if prefetch:
                it = mx.io.DevicePrefetchIter(it, depth=CSV_PREFETCH)
                b = it.next()
                check(b.data[0]._data.device == dev,
                      "DevicePrefetchIter staged on %s, not %s"
                      % (b.data[0]._data.device, dev))
                it.reset()
            mod = mx.mod.Module(mx.models.get_mlp(),
                                context=mx.gpu(dev.index or 0))
            clock = StepClock(torch)
            mod.fit(it, optimizer="sgd", initializer=mx.init.Xavier(),
                    optimizer_params={"learning_rate": MNIST_LR,
                                      "momentum": MNIST_MOMENTUM},
                    num_epoch=1, batch_end_callback=[clock])
            val.reset()
            acc = mod.score(val, "acc")[0][1]
            check(acc > MNIST_ACC, "CSV MLP (prefetch %s): accuracy %.4f "
                  "<= %g" % (prefetch, acc, MNIST_ACC))
            key = "prefetch" if prefetch else "no_prefetch"
            out[key] = dict(step_summary(np, clock.times[0], CSV_BATCH),
                            val_acc=acc, csv_read_s=read_s)
    out["prefetch_step_ms_ratio"] = (out["prefetch"]["step_ms_mean"]
                                     / out["no_prefetch"]["step_ms_mean"])

    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    xs = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    res = []  # the card's, then the CPU's (output, gradient)
    for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
        with ctx:
            x = mx.nd.array(xs)
            x.attach_grad()
            with mx.autograd.record():
                yv = Sigmoid()(x)
                loss = mx.nd.sum(yv * yv)
            loss.backward()
            res.append((yv.asnumpy(), x.grad.asnumpy()))
    ferr = max(float(np.abs(a - b).max()) for a, b in zip(*res))
    check(ferr <= 1e-6, "autograd.Function on the card against the CPU: "
          "%.3g > 1e-6" % ferr)
    out["function_max_abs_err"] = ferr
    print("data on the card (phase 20): " + json.dumps(out))
    return out


#: phase 21a's tolerances by kind, each on max |card - CPU| / max(1,
#: max |CPU|): index, shape and ordering results exact; elementwise
#: arithmetic 1e-6; transcendental functions (CUDA's libm against the
#: CPU's) and sums over thousands of terms in another order (the
#: reductions, the products' contractions, scatter-adds) 1e-5;
#: factorizations and solves 1e-4. A gradient takes its op's tolerance,
#: and arithmetic's where the op is exact (it sums cotangents).
ITEM2_TOL = {"exact": 0.0, "arith": 1e-6, "trans": 1e-5, "sum": 1e-5,
             "linalg": 1e-4}
#: phase 21a's user sizes: 2^24 float32 elements for the elementwise
#: ops, dot at 4096^2, batch_dot at (64, 512, 512), the ordering ops over
#: (64, 32000) logits, linalg on 64 128 x 128 matrices, the image ops on
#: batches of 32 (BilinearSampler and SpatialTransformer on (32, 3, 224,
#: 224)), ROIPooling with 128 ROIs on a (8, 256, 38, 50) feature map,
#: Correlation on (4, 256, 48, 64)
ITEM2_N = (4096, 4096)
#: the shape, index and assignment ops on 2^22 elements
ITEM2_M = (2048, 2048)
#: where each output row comes from the same input rows alone (the
#: elementwise ops, the reductions along axis 1), the CPU computes every
#: ITEM2_ROW_STRIDE-th row of the card's full-size call, and those rows
#: are compared
ITEM2_ROW_STRIDE = 16
ITEM2_LOGITS = (64, 32000)
ITEM2_BATCH = (64, 128, 128)
ITEM2_MM = (64, 512, 512)
ITEM2_IMAGES = 32
ITEM2_ROIS = 128
ITEM2_CORR = (4, 256, 48, 64)
#: phase 21b: K1 through the op at the serving main path's widths (H 4,
#: Dh 128, block 16): (label, B, Tq, w, q_starts)
PAGED_OP_CASES = [("decode", 8, 1, 16, [190, 17, 64, 100, 33, 5, 240, 150]),
                  ("chunk", 2, 32, 8, [32, 96])]
#: phase 21d: examples/stochastic_depth.py's net at its defaults (4
#: blocks, p_last 0.5, Adam lr 0.001) on seeded (64, 1, 28, 28) batches
SD_BATCH, SD_STEPS, SD_BLOCKS, SD_P_LAST = 64, 4, 4, 0.5


def item2_cases(torch, dev):
    """Phase 21a's cases: (family, name, make inputs, params, kind, rows),
    the inputs made on `dev` from one seeded generator when called inside
    `with torch.device(dev)`; `rows`: each output row depends on the same
    input rows alone."""
    g = torch.Generator(device=dev).manual_seed(0)

    def u(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    def away(*shape, lo=0.2, hi=3.0):
        sign = torch.randint(0, 2, shape, generator=g).float() * 2 - 1
        return u(*shape, lo=lo, hi=hi) * sign

    def choice(values, *shape):
        v = torch.tensor(values)
        return v[torch.randint(0, len(values), shape, generator=g)]

    def specials():
        x = u(*ITEM2_N, lo=-2, hi=2)
        x.view(-1)[::97] = float("nan")
        x.view(-1)[1::101] = float("inf")
        x.view(-1)[2::103] = float("-inf")
        x.view(-1)[3::89] = 0.0
        return [x]

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g).float()

    B = ITEM2_BATCH

    def spd():
        m = u(*B)
        return [m @ m.transpose(1, 2) + B[-1] * torch.eye(B[-1])]

    def spd_separated():
        """Q diag(w) Q^T with eigenvalues at least 0.5 apart, so the
        eigenvectors are well conditioned."""
        q = torch.linalg.qr(torch.randn(B, generator=g))[0]
        w = torch.linspace(1.0, float(B[-1]), B[-1]) + u(B[0], B[-1],
                                                          lo=0, hi=0.5)
        a = q @ (w[:, :, None] * q.transpose(1, 2))
        return [(a + a.transpose(1, 2)) / 2]

    def lower():
        """Diagonally dominant lower-triangular matrices (well
        conditioned at any size)."""
        m = torch.tril(u(*B)) * (0.5 / B[-1])
        d = torch.arange(B[-1])
        m[:, d, d] = 1.0 + u(B[0], B[-1], lo=0, hi=1)
        return m

    def unique_points(n, shape):
        flat = torch.randperm(shape[0] * shape[1], generator=g)[:n]
        return torch.stack([flat // shape[1], flat % shape[1]]).float()

    N, L = ITEM2_N, ITEM2_LOGITS
    cases = []

    def add(family, name, make, params=None, kind="arith", rows=None):
        if rows is None:
            rows = family == "elementwise"
        cases.append((family, name, make, params or {}, kind, rows))

    domains = {"sin": (-3, 3), "cos": (-3, 3), "tan": (-1.2, 1.2),
               "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
               "arctan": (-3, 3), "sinh": (-3, 3), "cosh": (-3, 3),
               "arcsinh": (-3, 3), "arccosh": (1.1, 4),
               "arctanh": (-0.9, 0.9), "degrees": (-3, 3),
               "radians": (-200, 200), "erf": (-2, 2),
               "erfinv": (-0.9, 0.9), "gamma": (0.2, 5),
               "gammaln": (0.2, 5), "log10": (0.1, 5), "log2": (0.1, 5),
               "log1p": (-0.5, 5), "expm1": (-2, 2)}
    for name, (lo, hi) in domains.items():
        add("elementwise", name, lambda lo=lo, hi=hi: [u(*N, lo=lo, hi=hi)],
            kind="trans")
    for name in ("floor", "ceil", "round", "rint", "fix", "trunc"):
        # half-way values included: k / 2 for integers k
        add("elementwise", name,
            lambda: [torch.round(u(*N, lo=-20, hi=20)) / 2], kind="exact")
    for name in ("cbrt", "rcbrt"):
        add("elementwise", name, lambda: [away(*N)], kind="trans")
    for name in ("isnan", "isinf", "logical_not"):
        add("elementwise", name, specials, kind="exact")
    for op in ("and", "or", "xor"):
        add("elementwise", "_logical_" + op,
            lambda: [choice([0.0, 1.5, -2.0], *N), choice([0.0, 3.0], *N)],
            kind="exact")
        add("elementwise", "broadcast_logical_" + op,
            lambda: [choice([0.0, 1.5, -2.0], *N),
                     choice([0.0, 3.0], 1, N[1])], kind="exact")
        add("elementwise", "_logical_%s_scalar" % op,
            lambda: [choice([0.0, 1.5, -2.0], *N)], {"scalar": 2.0},
            kind="exact")
    add("elementwise", "_mod", lambda: [away(*N, hi=9), away(*N)],
        kind="trans")
    # its rhs's gradient sums over every row: compared whole
    add("elementwise", "broadcast_mod",
        lambda: [away(*N, hi=9), away(1, N[1])], kind="trans", rows=False)
    add("elementwise", "_mod_scalar", lambda: [away(*N, hi=9)],
        {"scalar": -2.5}, kind="trans")
    add("elementwise", "_rmod_scalar", lambda: [away(*N)], {"scalar": 7.0},
        kind="trans")
    add("elementwise", "_hypot", lambda: [u(*N), u(*N)], kind="trans")
    add("elementwise", "broadcast_hypot", lambda: [u(*N), u(N[0], 1)],
        kind="trans")
    add("elementwise", "_hypot_scalar", lambda: [u(*N)], {"scalar": 1.5},
        kind="trans")
    add("elementwise", "quadratic", lambda: [u(*N)],
        {"a": 2.0, "b": -3.0, "c": 1.0})
    # reductions over 4096 terms a row
    add("reductions", "prod", lambda: [u(*N, lo=0.99, hi=1.01)],
        {"axis": 1}, kind="sum", rows=True)
    add("reductions", "nansum", lambda: [
        torch.where(torch.rand(N, generator=g) < 0.01,
                    torch.tensor(float("nan")), u(*N))], {"axis": 1},
        kind="sum", rows=True)
    add("reductions", "nanprod", lambda: [
        torch.where(torch.rand(N, generator=g) < 0.01,
                    torch.tensor(float("nan")), u(*N, lo=0.99, hi=1.01))],
        {"axis": 1, "keepdims": True}, kind="sum", rows=True)
    add("reductions", "square_sum", lambda: [u(*N)], {"axis": 1},
        kind="sum", rows=True)
    IM = ITEM2_IMAGES
    add("reductions", "L2Normalization", lambda: [u(IM, 256, 32, 32)],
        {"mode": "channel"}, kind="sum")
    # products
    add("products", "dot", lambda: [u(*N), u(*N)], kind="sum")
    MM = ITEM2_MM
    add("products", "batch_dot", lambda: [u(*MM), u(*MM)],
        {"transpose_b": True}, kind="sum")
    add("products", "_matmul", lambda: [u(*MM), u(*MM)], kind="sum")
    add("products", "add_n", lambda: [u(*N), u(*N), u(*N)], rows=True)
    add("products", "khatri_rao", lambda: [u(*MM[:2]), u(*MM[:2])])
    # ordering over logits, tie-free (normal) and with ties (few values)
    for tag, make in (("", lambda: [torch.randn(L, generator=g)]),
                      ("ties", lambda: [ints(50, *L)])):
        add("ordering", "sort", make, {"axis": -1}, kind="exact")
        add("ordering", "argsort", make, {"is_ascend": False},
            kind="exact")
        add("ordering", "topk", make, {"k": 10, "ret_typ": "both"},
            kind="exact")
        add("ordering", "topk", make, {"k": 10, "ret_typ": "mask",
                                       "is_ascend": True}, kind="exact")
    add("ordering", "argmin", lambda: [torch.randn(L, generator=g)],
        {"axis": 1}, kind="exact")
    add("ordering", "argmax_channel", lambda: [torch.randn(L, generator=g)],
        kind="exact")
    add("losses", "smooth_l1", lambda: [u(*N, lo=-2, hi=2)], {"scalar": 1.5})
    add("losses", "softmax_cross_entropy",
        lambda: [torch.randn(L, generator=g) * 3, ints(L[1], L[0])],
        kind="sum")
    # shape and index, assignment
    M = ITEM2_M
    P = M[0] * M[1] // 16    # the index ops' points
    add("shape_index", "slice", lambda: [u(*M)],
        {"begin": (M[0] - 96, None), "end": (None, M[1] // 40),
         "step": (-3, 2)},
        kind="exact")
    add("shape_index", "slice_like", lambda: [u(*M), u(M[0] // 2,
                                                      M[1] // 4)],
        kind="exact")
    add("shape_index", "broadcast_axis", lambda: [u(M[0], 1)],
        {"axis": 1, "size": M[1]}, kind="exact")
    add("shape_index", "broadcast_like", lambda: [u(1, M[1]), u(*M)],
        kind="exact")
    add("shape_index", "repeat", lambda: [u(M[0] // 2, M[1])],
        {"repeats": 2, "axis": 0}, kind="exact")
    add("shape_index", "flip", lambda: [u(*M)], {"axis": (0, 1)},
        kind="exact")
    add("shape_index", "gather_nd",
        lambda: [u(*M), unique_points(P, M)], kind="exact")
    add("shape_index", "scatter_nd",
        lambda: [u(P), ints(M[0], 2, P)], {"shape": M},
        kind="sum")
    add("shape_index", "batch_take", lambda: [u(*L), ints(L[1], L[0])],
        kind="exact")
    add("shape_index", "shape_array", lambda: [u(*M)], kind="exact")
    add("shape_index", "size_array", lambda: [u(*M)], kind="exact")
    add("shape_index", "diag", lambda: [u(*M)], {"k": 3}, kind="exact")
    add("shape_index", "depth_to_space", lambda: [u(IM, 256, 32, 32)],
        {"block_size": 2}, kind="exact")
    add("shape_index", "space_to_depth", lambda: [u(IM, 64, 64, 64)],
        {"block_size": 2}, kind="exact")
    add("shape_index", "SequenceLast",
        lambda: [u(35, 64, 1024), ints(35, 64) + 1],
        {"use_sequence_length": True}, kind="exact")
    add("shape_index", "SequenceReverse",
        lambda: [u(35, 64, 1024), ints(35, 64) + 1],
        {"use_sequence_length": True}, kind="exact")
    # assignment
    add("assignment", "_slice_assign", lambda: [u(*M), u(M[0] // 2,
                                                         M[1] // 2)],
        {"begin": (None, 1), "end": (None, None), "step": (-2, 2)},
        kind="exact")
    add("assignment", "_slice_assign_scalar", lambda: [u(*M)],
        {"scalar": 2.5, "begin": (M[0] // 40, 0), "end": (M[0] * 3 // 4,
                                                          None),
         "step": (3, -1)}, kind="exact")
    add("assignment", "_scatter_set_nd",
        lambda: [u(*M), u(P), unique_points(P, M)],
        {"shape": M}, kind="exact")
    add("assignment", "_scatter_plus_scalar", lambda: [u(*M)],
        {"scalar": 1.5})
    add("assignment", "_scatter_minus_scalar", lambda: [u(*M)],
        {"scalar": 1.5})
    add("assignment", "_scatter_elemwise_div", lambda: [u(*M), away(*M)])
    add("assignment", "choose_element_0index",
        lambda: [u(*L), ints(L[1], L[0])], kind="exact")
    add("assignment", "fill_element_0index",
        lambda: [u(*L), u(L[0]), ints(L[1], L[0])], kind="exact")
    add("assignment", "_grad_add", lambda: [u(*M), u(*M)])
    add("assignment", "_identity_with_attr_like_rhs",
        lambda: [u(*M), u(*M)], kind="exact")
    # linalg on 64 128 x 128 matrices
    add("linalg", "linalg_gemm", lambda: [u(*B), u(*B), u(*B)],
        {"transpose_b": True, "alpha": 2.0, "beta": 0.5}, kind="linalg")
    add("linalg", "linalg_gemm2", lambda: [u(*B), u(*B)],
        {"transpose_a": True}, kind="linalg")
    add("linalg", "linalg_potrf", spd, kind="linalg")
    add("linalg", "linalg_potri", lambda: [lower()], kind="linalg")
    for transpose in (False, True):
        for rightside in (False, True):
            for low in (False, True):
                add("linalg", "linalg_trsm",
                    lambda low=low: [lower() if low
                                     else lower().transpose(1, 2)
                                     .contiguous(), u(*B)],
                    {"transpose": transpose, "rightside": rightside,
                     "lower": low, "alpha": 1.5}, kind="linalg")
    add("linalg", "linalg_trmm", lambda: [lower(), u(*B)],
        {"rightside": True}, kind="linalg")
    add("linalg", "linalg_sumlogdiag", spd, kind="linalg")
    add("linalg", "linalg_syrk", lambda: [u(*B)], {"alpha": 0.5},
        kind="linalg")
    add("linalg", "linalg_gelqf", lambda: [u(*B)], kind="signed")
    add("linalg", "linalg_syevd", spd_separated, kind="signed")
    # nn
    add("nn", "hard_sigmoid", lambda: [u(*N, lo=-4, hi=4)])
    add("nn", "softmin", lambda: [u(*L, lo=-3, hi=3)], kind="trans")
    add("nn", "SoftmaxActivation", lambda: [u(IM, 256, 32, 32)],
        {"mode": "channel"}, kind="trans")
    add("nn", "LRN", lambda: [u(IM, 96, 55, 55)], {"nsize": 5},
        kind="trans")
    add("nn", "UpSampling", lambda: [u(IM, 256, 28, 28)], {"scale": 2},
        kind="exact")
    add("nn", "UpSampling", lambda: [u(IM, 256, 28, 28)],
        {"scale": 2, "sample_type": "bilinear"}, kind="trans")
    add("nn", "Crop", lambda: [u(IM, 3, 224, 224)],
        {"h_w": (200, 200), "center_crop": True}, kind="exact")

    def theta():
        return torch.tensor([[1.0, 0, 0, 0, 1, 0]]) + u(IM, 6, lo=-0.3,
                                                        hi=0.3)

    add("nn", "GridGenerator", lambda: [theta()],
        {"target_shape": (224, 224)}, kind="trans")
    add("nn", "BilinearSampler",
        lambda: [u(IM, 3, 224, 224), u(IM, 2, 224, 224, lo=-1.1, hi=1.1)],
        kind="trans")
    add("nn", "SpatialTransformer", lambda: [u(IM, 3, 224, 224), theta()],
        {"target_shape": (224, 224)}, kind="trans")
    add("nn", "ROIPooling", lambda: [u(8, 256, 38, 50), roi_boxes(
        torch, g, ITEM2_ROIS, 8, 600, 800)],
        {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}, kind="exact")
    add("nn", "Correlation", lambda: [u(*ITEM2_CORR), u(*ITEM2_CORR)],
        {"max_displacement": 4}, kind="sum")
    add("nn", "IdentityAttachKLSparseReg", lambda: [u(256, N[1], lo=0.05,
                                                      hi=0.95)],
        {"sparseness_target": 0.2, "penalty": 0.01}, kind="trans")
    add("nn", "_contrib_AdaptiveAvgPooling2D", lambda: [u(IM, 2048, 14, 14)],
        {"output_size": 7}, kind="sum")
    add("nn", "_contrib_BilinearResize2D", lambda: [u(IM, 256, 28, 28)],
        {"height": 56, "width": 56}, kind="trans")
    add("nn", "_contrib_BilinearResize2D", lambda: [u(IM, 256, 28, 28)],
        {"height": 13, "width": 9}, kind="trans")
    add("nn", "_image_to_tensor", lambda: [
        torch.randint(0, 256, (IM, 224, 224, 3), generator=g).to(
            torch.uint8)], kind="arith")
    add("nn", "_image_normalize", lambda: [u(IM, 3, 224, 224, lo=0, hi=1)],
        {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)},
        kind="trans")
    add("contrib", "_contrib_div_sqrt_dim", lambda: [u(IM, 8, 256, 128)],
        kind="trans")
    return cases


#: the aliases phase 21a runs once each, with their op's first case
ITEM2_ALIASES = {
    "crop": "slice", "reverse": "flip", "broadcast_axes": "broadcast_axis",
    "ElementWiseSum": "add_n", "_sum": "add_n", "_square_sum": "square_sum",
    "make_loss_identity": None, "_contrib_quadratic": "quadratic",
    "_crop_assign": "_slice_assign",
    "_crop_assign_scalar": "_slice_assign_scalar"}
ITEM2_ALIASES.update({"_linalg_" + n: "linalg_" + n for n in (
    "gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "sumlogdiag",
    "syrk", "gelqf", "syevd")})


def roi_boxes(torch, g, R, N, H, W):
    """R ROIs (batch, x1, y1, x2, y2) over N images of H x W pixels."""
    b = torch.randint(0, N, (R, 1), generator=g).float()
    xy = torch.rand(R, 2, generator=g) * torch.tensor([W * 0.8, H * 0.8])
    wh = torch.rand(R, 2, generator=g) * torch.tensor([W * 0.5, H * 0.5]) \
        + 16
    x2y2 = torch.minimum(xy + wh, torch.tensor([W - 1.0, H - 1.0]))
    return torch.cat([b, xy, x2y2], dim=1)


def item2_err(torch, got, want):
    """max |got - want| / max(1, max |want|) over the finite entries;
    inf where the non-finite entries or the shapes and dtypes differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    got = got.cpu()
    if not got.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]):
        return float("inf")
    diff = (got[fin].float() - want[fin].float()).abs()
    if not diff.numel():
        return 0.0
    return float(diff.max()) / max(1.0, float(want[fin].abs().max()))


def item2_signed(torch, name, a, outs):
    """gelqf / syevd on the card by reconstruction (L Q = A with Q Q^T = I
    and L lower; A V^T^T = V^T^T diag(w)), relative to max |A|."""
    a = a.double()
    if name == "linalg_gelqf":
        L, Q = (o.double() for o in outs)
        eye = torch.eye(Q.shape[-2], dtype=torch.float64, device=Q.device)
        err = max(float((L @ Q - a).abs().max()),
                  float((Q @ Q.transpose(1, 2) - eye).abs().max()),
                  float(torch.triu(L, 1).abs().max()))
    else:
        Vt, w = (o.double() for o in outs)
        V = Vt.transpose(1, 2)
        err = float((a @ V - V * w[:, None, :]).abs().max())
    return err / max(1.0, float(a.abs().max()))


def item2_up_to_sign(torch, got, want, axis):
    """got against want with each row (axis -2) or column (axis -1) of
    want flipped to got's sign."""
    got = got.cpu()
    dots = (got.double() * want.double()).sum(dim=-1 if axis == -2 else -2,
                                              keepdim=True)
    return item2_err(torch, got, (want.double() * torch.sign(dots)).to(
        want.dtype))


def item2_grads(torch, fn, ins, params, signed, cts):
    """Gradients of the op's float inputs under the cotangents `cts` (one
    per output; for gelqf / syevd the weights of the sign-free sum(c1
    X^2) + sum(c2 Y^2))."""
    ins = [t.detach().clone().requires_grad_(t.is_floating_point())
           for t in ins]
    outs = fn(*ins, **params)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    pairs = [(o, c.to(o.device, o.dtype)) for o, c in zip(outs, cts)
             if o.requires_grad]
    leaves = [t for t in ins if t.requires_grad]
    if not pairs:
        return []
    if signed:
        grads = torch.autograd.grad(sum((c * o * o).sum() for o, c in pairs),
                                    leaves)
    else:
        grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [c for _, c in pairs], allow_unused=True)
    return [torch.zeros_like(t) if gr is None else gr.detach()
            for t, gr in zip(leaves, grads)]


def item2_eig_tol(torch, a, w):
    """The tolerance syevd's eigenvectors (and the gradients through
    them) are held to against the CPU: ITEM2_TOL's linalg, or where the
    problem allows no better, 4 float32 epsilons of ||A||_F over the
    smallest eigenvalue gap (an eigenvector moves by about the solver's
    backward error over the gap; the card's Jacobi solver stops at a
    backward error near eps ||A||_F, the CPU's LAPACK well below it)."""
    gaps = (w[..., 1:] - w[..., :-1]).double().clamp_min(1e-30)
    fro = torch.linalg.matrix_norm(a.double())
    bound = 4 * torch.finfo(torch.float32).eps * float(
        (fro / gaps.min(dim=-1).values).max())
    return max(ITEM2_TOL["linalg"], bound)


def phase_item2_ops(torch, np, dev, card):
    """Phase 21a: every name of ROADMAP item 2 (and once each, its
    aliases) on the card at a user's size (item2_cases), through
    mx.nd.<name> on NDArrays of the card, held against the same call on
    the CPU, and where the reference differentiates it, its gradients
    against the CPU's, within ITEM2_TOL; gelqf and syevd by
    reconstruction and against the CPU up to each row's sign. Prints,
    per family, the count, the largest error and the card ms (time_ms)
    of its calls. Then check_consistency of sym.RNN (consistency_rnn)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    families, first_case, names, walls, card_ms = {}, {}, set(), [], {}
    for i, (family, name, make, params, kind, rows) in enumerate(
            item2_cases(torch, dev)):
        first_case.setdefault(name, (make, params, kind, rows))
        names.add(name)
        t0 = time.perf_counter()
        with torch.device(dev):
            inputs = make()
        err, gerr, ms, tol, gtol = item2_one(
            torch, mx, registry, name, inputs, params, kind, dev, i,
            grads=True, rows=rows)
        walls.append((time.perf_counter() - t0, name))
        key = name if name not in card_ms else "%s#%d" % (name, i)
        card_ms[key] = ms
        fam = families.setdefault(family, {"count": 0, "max_err": 0.0,
                                           "max_grad_err": 0.0,
                                           "card_ms": 0.0, "wall_s": 0.0,
                                           "tol": 0.0, "grad_tol": 0.0,
                                           "names": set()})
        fam["wall_s"] += walls[-1][0]
        fam["tol"] = max(fam["tol"], tol)
        fam["grad_tol"] = max(fam["grad_tol"], gtol)
        fam["count"] += 1
        fam["names"].add(name)
        fam["max_err"] = max(fam["max_err"], err)
        fam["max_grad_err"] = max(fam["max_grad_err"], gerr)
        fam["card_ms"] += ms
    aliases = {"count": 0, "max_err": 0.0, "card_ms": 0.0}
    for alias, op in ITEM2_ALIASES.items():
        if op is None:   # make_loss_identity: BlockGrad's alias
            make, params, kind, rows = (lambda: [torch.randn(ITEM2_N)], {},
                                        "exact", True)
        else:
            make, params, kind, rows = first_case[op]
        with torch.device(dev):
            inputs = make()
        err, _, ms, _, _ = item2_one(torch, mx, registry, alias, inputs,
                                     params, kind, dev, 0, grads=False,
                                     rows=rows)
        aliases["count"] += 1
        aliases["max_err"] = max(aliases["max_err"], err)
        aliases["card_ms"] += ms
    out = {"card": card, "cases": sum(f["count"] for f in
                                      families.values()),
           "names": len(names), "aliases": aliases, "tol": ITEM2_TOL,
           "slowest_cases_s": sorted(walls, reverse=True)[:8],
           "card_ms_by_case": card_ms, "by_family": {}}
    for family, f in families.items():
        f["names"] = len(f["names"])
        out["by_family"][family] = f
        print("item 2 ops, %s (phase 21a): %d cases over %d names, max err "
              "%.3g (tol %g), max grad err %.3g (tol %.3g), card %.3f ms, "
              "%.1f s with the CPU's (%s)"
              % (family, f["count"], f["names"], f["max_err"], f["tol"],
                 f["max_grad_err"], f["grad_tol"], f["card_ms"],
                 f["wall_s"], card))
    print("item 2 ops (phase 21a): " + json.dumps(out))
    out["check_consistency_rnn"] = consistency_rnn(torch, mx, dev)
    return out


def consistency_rnn(torch, mx, dev):
    """check_consistency over [cpu, gpu(0)] of sym.RNN lstm at the word
    LM's layer (LM_BPTT x LM_BATCH x LM_EMBED in, LM_HIDDEN units,
    LM_LAYERS layers), MXNET_FUSED_RNN=1: K4a and K4b launched once a
    layer on the card."""
    from mxnet_tpu_torch.ops import fused_rnn as fr
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    try:
        with mx.name.NameManager():
            rnn = mx.sym.RNN(mx.sym.Variable("data"), mode="lstm",
                             state_size=LM_HIDDEN, num_layers=LM_LAYERS,
                             name="lstm")
        return consistency_check(
            torch, mx, dev, "sym.RNN lstm", rnn,
            {"data": (LM_BPTT, LM_BATCH, LM_EMBED)}, fr.launch_counts,
            (LM_LAYERS, LM_LAYERS))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior


def item2_one(torch, mx, registry, name, card_in, params, kind, dev, seed,
              grads, rows=False):
    """One case of phase 21a on inputs made on the card: (largest error,
    largest gradient error, card ms of the mx.nd call, the tolerances
    held); fails the phase past a tolerance. With `rows` the CPU computes
    every ITEM2_ROW_STRIDE-th row of the inputs whose first axis is the
    data's."""
    opdef = registry.get(name)
    nd_fn = getattr(mx.nd, name)
    R = ITEM2_ROW_STRIDE if rows else 1
    sliced = [R > 1 and t.dim() > 0 and t.shape[0] == card_in[0].shape[0]
              for t in card_in]
    ref_in = [(t[::R] if s else t).cpu() for t, s in zip(card_in, sliced)]
    with mx.cpu():
        want = nd_fn(*[mx.nd.NDArray(t) for t in ref_in], **params)
    card_nds = [mx.nd.NDArray(t) for t in card_in]
    got = nd_fn(*card_nds, **params)
    want = [w._data for w in (want if isinstance(want, tuple) else (want,))]
    got = [o._data for o in (got if isinstance(got, tuple) else (got,))]
    check(all(o.device == dev for o in got), "%s: output not on %s"
          % (name, dev))
    signed = kind == "signed"
    tol = gtol = ITEM2_TOL["linalg" if signed else kind]
    if signed:
        lq = opdef.name == "linalg_gelqf"
        vec_tol = tol if lq else item2_eig_tol(torch, ref_in[0], want[1])
        vec_err = item2_up_to_sign(torch, got[0], want[0], -1 if lq else -2)
        check(vec_err <= vec_tol, "%s's %s on the card against the CPU up to "
              "sign: %.3g > %.3g" % (name, "L" if lq else "V^T", vec_err,
                                     vec_tol))
        err = max(item2_signed(torch, opdef.name, card_in[0], got),
                  item2_up_to_sign(torch, got[1], want[1], -2) if lq
                  else item2_err(torch, got[1], want[1]))
        gtol = vec_tol
    else:
        err = max(item2_err(torch, o[::R], w) for o, w in zip(got, want))
    check(len(got) == len(want) and err <= tol,
          "%s on the card against the CPU (%s): %.3g > %g"
          % (name, params, err, tol))
    gerr = 0.0
    if grads and opdef.differentiable:
        g = torch.Generator(device=dev).manual_seed(seed)
        cts = [torch.randn(o.shape, generator=g, device=dev) for o in got]
        gc = item2_grads(torch, opdef.fn, ref_in, params, signed,
                         [c[::R].cpu() for c in cts])
        gg = item2_grads(torch, opdef.fn, card_in, params, signed, cts)
        fl = [s for t, s in zip(card_in, sliced) if t.is_floating_point()]
        gerr = max([item2_err(torch, a[::R] if s else a, b)
                    for a, b, s in zip(gg, gc, fl)] or [0])
        gtol = gtol or ITEM2_TOL["arith"]
        check(gerr <= gtol, "%s gradient on the card against the CPU (%s): "
              "%.3g > %g" % (name, params, gerr, gtol))
    ms = time_ms(torch, lambda: nd_fn(*card_nds, **params), n=5,
                 sleep=False)
    return err, gerr, ms, tol, gtol


def phase_paged_op(torch, np, dev, card):
    """Phase 21b: K1 through `nd.contrib.PagedAttention` with
    MXNET_PAGED_ATTENTION=1 at PAGED_OP_CASES (float32 and bfloat16),
    and through `sym.contrib.PagedAttention` bound in an executor on the
    card: paged_attention.launches rises by exactly the op calls; each
    output within TOL of the flag-off composite on the same inputs.
    Returns the op's launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import paged_attention as pa
    H, Dh, bs = 4, 128, 16
    saved = os.environ.get("MXNET_PAGED_ATTENTION")
    rows, calls, errs = [], 0, {}
    pa.paged_attention.launches = 0
    try:
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            for i, (label, B, Tq, w, q_starts) in enumerate(PAGED_OP_CASES):
                args = paged_case(torch, np, dev, B, Tq, w, q_starts, dtype,
                                  seed=300 + i, H=H, Dh=Dh, bs=bs)
                nds = [mx.nd.NDArray(a) for a in args]
                os.environ["MXNET_PAGED_ATTENTION"] = "0"
                ref = mx.nd.contrib.PagedAttention(*nds, block_size=bs)
                before = pa.paged_attention.launches
                os.environ["MXNET_PAGED_ATTENTION"] = "1"
                out = mx.nd.contrib.PagedAttention(*nds, block_size=bs)
                torch.cuda.synchronize()
                calls += 1
                check(pa.paged_attention.launches == before + 1,
                      "nd.contrib.PagedAttention (%s, %s) launched K1 %d "
                      "times, not once" % (label, dname,
                                           pa.paged_attention.launches
                                           - before))
                e = paged_check(torch, out._data, ref._data, dname,
                                "PagedAttention op %s %s" % (label, dname))
                errs[dname] = max(errs.get(dname, 0.0), e)
                rows.append({"case": label, "dtype": dname, "B": B, "Tq": Tq,
                             "w": w, "max_abs_err": e})
        # the Symbol op bound on the card (float32 decode)
        label, B, Tq, w, q_starts = PAGED_OP_CASES[0]
        args = paged_case(torch, np, dev, B, Tq, w, q_starts, torch.float32,
                          seed=310, H=H, Dh=Dh, bs=bs)
        names = ["query", "k_pool", "v_pool", "block_table", "q_start"]
        s = mx.sym.contrib.PagedAttention(
            *[mx.sym.Variable(n, dtype=str(a.dtype).replace("torch.", ""))
              for n, a in zip(names, args)], block_size=bs)
        check(s.infer_shape(**{n: tuple(a.shape) for n, a in
                               zip(names, args)})[1] == [tuple(args[0].shape)],
              "sym.contrib.PagedAttention's inferred shape")
        ex = s.bind(mx.gpu(dev.index or 0),
                    {n: mx.nd.NDArray(a) for n, a in zip(names, args)},
                    grad_req="null")
        before = pa.paged_attention.launches
        sym_out = ex.forward()[0]._data
        torch.cuda.synchronize()
        calls += 1
        check(pa.paged_attention.launches == before + 1,
              "the bound sym.contrib.PagedAttention launched K1 %d times"
              % (pa.paged_attention.launches - before))
        os.environ["MXNET_PAGED_ATTENTION"] = "0"
        ref = mx.nd.contrib.PagedAttention(
            *[mx.nd.NDArray(a) for a in args], block_size=bs)._data
        e = paged_check(torch, sym_out, ref, "float32", "bound Symbol op")
        errs["float32"] = max(errs["float32"], e)
        rows.append({"case": "symbol_" + label, "dtype": "float32",
                     "max_abs_err": e})
        launches = pa.paged_attention.launches
    finally:
        if saved is None:
            os.environ.pop("MXNET_PAGED_ATTENTION", None)
        else:
            os.environ["MXNET_PAGED_ATTENTION"] = saved
    check(launches == calls, "K1 launches %d != the op's %d calls"
          % (launches, calls))
    out = {"card": card, "calls": calls, "launches": launches,
           "max_abs_err": errs, "tol": TOL, "cases": rows}
    print("paged attention op (phase 21b): " + json.dumps(out))
    return launches


def load_example(fname, pkg=None):
    """examples/<fname> as a fresh module whose `import mxnet_tpu` (and
    every submodule: `mxnet_tpu.gluon`, `mxnet_tpu.models.ssd`,
    `mxnet_tpu.operator`, ...) resolve to `pkg` and its submodules while
    it imports, by default `mxnet_tpu_torch`: the example runs on the
    port unchanged, and nothing of the JAX package loads (the CPU tests
    pass the reference itself for the other side)."""
    import importlib.util
    if pkg is None:
        import mxnet_tpu_torch as pkg
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", fname)
    spec = importlib.util.spec_from_file_location(
        "%s_%s" % (fname[:-3], pkg.__name__), path)
    module = importlib.util.module_from_spec(spec)
    prefix = pkg.__name__
    aliases = {"mxnet_tpu" + k[len(prefix):]: m
               for k, m in list(sys.modules.items())
               if k == prefix or k.startswith(prefix + ".")}
    saved = {k: sys.modules.get(k) for k in aliases}
    before = set(sys.modules)
    sys.modules.update(aliases)
    try:
        spec.loader.exec_module(module)
    finally:
        if prefix != "mxnet_tpu":
            # a submodule the package had not loaded would have been
            # imported again under the alias: drop any such copy
            for k in set(sys.modules) - before:
                if k == "mxnet_tpu" or k.startswith("mxnet_tpu."):
                    sys.modules.pop(k)
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return module


def phase_nce_example(torch, np, dev, card):
    """Phase 21c: examples/nce_word_embeddings.py at its defaults (400
    Adam steps, vocab 50, dim 16, 8 noise words, batch 128) on the port,
    the default context gpu(0): its own final check must pass (main()
    returns 0: the loss falls and the true successor wins > 75 %)."""
    import mxnet_tpu_torch as mx
    module = load_example("nce_word_embeddings.py")
    check("mxnet_tpu_torch" in module.mx.__name__,
          "the example did not load the port")
    mx.random.seed(0)
    argv = sys.argv
    sys.argv = ["nce_word_embeddings.py"]
    t0 = time.perf_counter()
    try:
        with mx.gpu(dev.index or 0):
            rc = module.main()
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(rc == 0, "examples/nce_word_embeddings.py failed its own check "
          "on the card (rc %s)" % rc)
    out = {"card": card, "steps": 400, "seconds": secs, "rc": rc}
    print("nce example (phase 21c): " + json.dumps(out))
    return out


def sd_run(torch, np, mx, module, dev, hybridize, batches, seed):
    """SD_STEPS Adam steps of the stochastic-depth net from one set of
    seeded weights, under generator seed `seed`: the losses and each
    step's uniform draws (shape, value, device)."""
    import functools
    from mxnet_tpu_torch.ops import registry
    ctx = mx.gpu(dev.index or 0)
    opdef = registry.get("_random_uniform")
    orig = opdef.fn
    draws = []

    @functools.wraps(orig)
    def recorded(*args, **kwargs):
        out = orig(*args, **kwargs)
        if out.device.type != "meta" and draws:
            draws[-1].append((tuple(out.shape), float(out.reshape(-1)[0]),
                              str(out.device)))
        return out

    with ctx:
        mx.random.seed(0)
        net = module.build(SD_BLOCKS, SD_P_LAST)
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(batches[0][0]))  # deferred shapes
        for i, (_, p) in enumerate(sorted(net.collect_params().items())):
            p.set_data(mx.nd.array(np.random.RandomState(i).uniform(
                -0.1, 0.1, p.shape).astype(np.float32)))
        if hybridize:
            net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.001})
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        mx.random.seed(seed)
        losses = []
        opdef.fn = recorded
        try:
            for x, y in batches:
                draws.append([])
                with mx.autograd.record():
                    loss = ce(net(mx.nd.array(x)), mx.nd.array(y))
                loss.backward()
                trainer.step(x.shape[0])
                losses.append(float(loss.mean().asscalar()))
        finally:
            opdef.fn = orig
    return losses, draws, net


def phase_stochastic_depth(torch, np, dev, card):
    """Phase 21d: examples/stochastic_depth.py's net (build(), 4 blocks)
    hybridized on the card, SD_STEPS Adam steps on seeded (SD_BATCH, 1,
    28, 28) batches with cuDNN deterministic: each step draws 4 fresh
    (1, 1, 1, 1) gates on the card (no two steps alike), a reseeded run
    repeats the draws and the losses, and the eager net under the same
    seed gives the same losses within 1e-5."""
    import mxnet_tpu_torch as mx
    module = load_example("stochastic_depth.py")
    rs = np.random.RandomState(9)
    batches = [(rs.rand(SD_BATCH, 1, 28, 28).astype(np.float32),
                rs.randint(0, 10, SD_BATCH).astype(np.float32))
               for _ in range(SD_STEPS)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        hyb, draws, net = sd_run(torch, np, mx, module, dev, True, batches,
                                 seed=1)
        hyb_s = time.perf_counter() - t0
        again, draws2, _ = sd_run(torch, np, mx, module, dev, True, batches,
                                  seed=1)
        eager, draws_e, _ = sd_run(torch, np, mx, module, dev, False,
                                   batches, seed=1)
    finally:
        torch.backends.cudnn.deterministic = det
    check(net._cached_graph is not None, "the hybridized net ran eagerly")
    check([len(d) for d in draws] == [SD_BLOCKS] * SD_STEPS,
          "gates drawn per step: %s" % [len(d) for d in draws])
    check(all(s == (1, 1, 1, 1) and dv.startswith(dev.type)
              for d in draws for s, _, dv in d),
          "gate draws not (1, 1, 1, 1) on the card: %s" % draws[0])
    vals = [tuple(v for _, v, _ in d) for d in draws]
    check(len(set(vals)) == SD_STEPS, "two steps drew the same gates")
    check(draws2 == draws and again == hyb,
          "a reseeded run did not repeat the gates and losses")
    check(draws_e == draws, "the eager net drew other gates")
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(hyb, eager))
    check(err <= 1e-5, "hybridized losses against eager: %.3g > 1e-5" % err)
    check(all(math.isfinite(v) for v in hyb), "non-finite loss")
    out = {"card": card, "batch": SD_BATCH, "steps": SD_STEPS,
           "losses": hyb, "eager_losses": eager, "max_rel_err": err,
           "gate_shape": [1, 1, 1, 1], "hybridized_s": hyb_s}
    print("stochastic depth hybridized (phase 21d): " + json.dumps(out))
    return out


#: phase 22: the serving front door at phase 4's width and config;
#: tenants (a), deadlines (b), brownout (c), telemetry's cost (e)
FD_PROMPTS = 12
FD_TENANT_BUDGET = 128
FD_BROWNOUT_AFTER_S = 0.2
FD_MAX_QUEUE = 16
FD_DEADLINE_504_MS = 200.0
FD_COST_BLOCKS = 4
#: the Prometheus sample-line grammar of tests/test_telemetry.py:92-93
PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)\{[^}]*\} "
                         r"(NaN|[+-]?(Inf|[0-9.e+-]+))$")
#: exposition counters and the snapshot() field each must equal
PROM_VS_SNAPSHOT = (
    ("serving_requests_submitted_total", ("requests", "submitted")),
    ("serving_requests_completed_total", ("requests", "completed")),
    ("serving_requests_failed_total", ("requests", "failed")),
    ("serving_deadline_shed_total", ("requests", "deadline_shed")),
    ("serving_tokens_generated_total", ("throughput", "tokens_generated")),
    ("serving_decode_steps_total", ("throughput", "decode_steps")),
    ("serving_decode_steps_paged_total", ("paths", "paged_decode_steps")),
    ("serving_prefill_chunks_total", ("paths", "prefill_chunks")),
    ("serving_goodput_tokens_total", ("tokens", "goodput")),
    ("serving_slow_tokens_total", ("tokens", "slow")),
    ("serving_shed_tokens_total", ("tokens", "shed")),
    ("serving_expired_tokens_total", ("tokens", "expired")),
    ("serving_failed_tokens_total", ("tokens", "failed")),
    ("serving_submitted_tokens_total", ("tokens", "submitted")))


def http_json(url, payload=None, headers=None, timeout=600):
    """(status, JSON body, headers) of one GET (payload None) or POST;
    an HTTP error status is returned, not raised."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def token_identity(tok, what):
    check(tok["submitted"] == tok["goodput"] + tok["slow"] + tok["shed"]
          + tok["expired"] + tok["failed"],
          "%s: submitted != goodput + slow + shed + expired + failed: %r"
          % (what, tok))


def front_door_tenants(pa, srv, cfg, prompts):
    """22a: tenant `batch` submits 8 requests at priority 0, then tenant
    `interactive` 4 at priority 1, under a per-tenant token budget. No
    batch request may be admitted while an interactive one enqueued
    before that admission (`t_enqueue`, stamped under the scheduler's
    lock, as `t_admit` is) is still queued. Returns the requests and the
    kernel's launches, checked against n_layers x (decode steps + prefill
    chunks)."""
    n0 = srv.snapshot()["paths"]
    pa.paged_attention.launches = 0
    reqs = []
    for i, p in enumerate(prompts):
        inter = i >= 8
        reqs.append(srv.submit(p, max_new_tokens=GEN,
                               tenant="interactive" if inter else "batch",
                               priority=int(inter)))
    outs = [r.result(timeout=600) for r in reqs]
    launches = pa.paged_attention.launches
    paths = srv.snapshot()["paths"]
    steps = paths["paged_decode_steps"] - n0["paged_decode_steps"]
    chunks = paths["prefill_chunks"] - n0["prefill_chunks"]
    want = cfg.n_layers * (steps + chunks)
    check(launches == want and launches > 0,
          "22a: paged kernel launched %d times, expected n_layers x "
          "(decode steps + prefill chunks) = %d x (%d + %d) = %d"
          % (launches, cfg.n_layers, steps, chunks, want))
    for b in reqs[:8]:
        for i in reqs[8:]:
            check(not (i.t_enqueue < b.t_admit and i.t_admit > b.t_admit),
                  "22a: batch request %d admitted at %.6f while interactive "
                  "request %d (enqueued %.6f) waited until %.6f"
                  % (b.id, b.t_admit, i.id, i.t_enqueue, i.t_admit))
    return outs, reqs, launches


def front_door_deadlines(serving, params, cfg, srv, prompts, ref, margins,
                         kw):
    """22b over HTTP: `deadline_ms: 1` on the warm server gets 503 with a
    Retry-After; a deadline of 10x the solo latency gets 200 with oracle
    tokens and its traceparent echoed; on a fresh server, a request
    queued behind a full batch of 8 whose deadline is shorter than the
    batch's remaining time gets 504 and no prefill chunk carries its
    trace. Returns the traced request's trace id and the numbers."""
    from mxnet_tpu_torch import telemetry
    check(srv.metrics.decode_steps >= 8, "22b: the server ran only %d "
          "decode steps" % srv.metrics.decode_steps)
    host, port = srv.serve_http(port=0, block=False)
    url = "http://%s:%d/v1/generate" % (host, port)
    code, body, hdr = http_json(url, {"tokens": prompts[0],
                                      "max_new_tokens": GEN,
                                      "deadline_ms": 1})
    check(code == 503 and int(hdr.get("Retry-After", 0)) >= 1,
          "22b: deadline 1 ms: status %d, Retry-After %r (want 503, >= 1)"
          % (code, hdr.get("Retry-After")))
    retry_after = int(hdr["Retry-After"])
    t0 = time.perf_counter()
    srv.generate(prompts[1], max_new_tokens=GEN, timeout=600)
    solo_ms = 1e3 * (time.perf_counter() - t0)
    tid = telemetry.new_trace_id()
    code, body, hdr = http_json(
        url, {"tokens": prompts[2], "max_new_tokens": GEN,
              "deadline_ms": 10 * solo_ms, "tenant": "http"},
        headers={"traceparent": "00-%s-00f067aa0ba902b7-01" % tid})
    check(code == 200, "22b: deadline %.0f ms (10x solo): status %d: %r"
          % (10 * solo_ms, code, body))
    check(body["trace"] == tid and telemetry.parse_traceparent(
        hdr.get("traceparent")) == tid,
          "22b: traceparent not echoed: body %r, header %r"
          % (body["trace"], hdr.get("traceparent")))
    compare_tokens("22b deadline 10x solo", [body["tokens"]], [ref[2]],
                   [margins[2]], quiet=True)

    cold = serving.serve((params, cfg), **kw)
    try:
        cold_url = "http://%s:%d/v1/generate" % cold.serve_http(
            port=0, block=False)
        # the cold server has no observed rate yet, so its admission gate
        # lets the request in; the batch of 8 ahead of it is full
        fillers = [cold.submit(p, max_new_tokens=GEN, priority=1)
                   for p in prompts[:8]]
        tid504 = telemetry.new_trace_id()
        out = {}

        def post():
            out["r"] = http_json(
                cold_url,
                {"tokens": prompts[8], "max_new_tokens": GEN,
                 "deadline_ms": FD_DEADLINE_504_MS},
                headers={"traceparent": "00-%s-00f067aa0ba902b7-01"
                         % tid504})

        t = threading.Thread(target=post, daemon=True)
        t.start()
        t.join(timeout=600)
        check("r" in out, "22b: the 504 request never returned")
        code504, body504, _ = out["r"]
        for r in fillers:
            r.result(timeout=600)
        shed = cold.metrics.deadline_shed
    finally:
        cold.close()
    check(code504 == 504, "22b: a %.0f ms deadline behind a full batch: "
          "status %d: %r (want 504)" % (FD_DEADLINE_504_MS, code504,
                                        body504))
    check(shed == 1, "22b: deadline sheds %d, want 1" % shed)
    names = [s["name"] for s in telemetry.spans(trace=tid504)]
    check("serving.submit" in names, "22b: the expired request's trace "
          "holds no submit span: %r" % names)
    check("serving.prefill" not in names, "22b: %d prefill chunks carry "
          "the expired request's trace" % names.count("serving.prefill"))
    return tid, {"retry_after_s": retry_after, "solo_ms": solo_ms,
                 "deadline_200_ms": 10 * solo_ms,
                 "deadline_504_ms": FD_DEADLINE_504_MS}


def front_door_brownout(serving, params, cfg, prompts, ref, margins, kw):
    """22c: brownout on (after 0.2 s of a queue at >= 3/4 of max_queue
    16). A first wave of 8 priority-1 requests fills the batch; a second
    wave of 16 (8 at priority 1, 8 at priority 0, one of them over HTTP)
    fills the queue. The priority-0 class is shed (BrownoutShed; 503 over
    HTTP), requests admitted while brownout is on are clamped to
    brownout_max_new and those admitted before keep their length; every
    token equals the oracle's."""
    srv = serving.serve((params, cfg), brownout=True,
                        max_queue=FD_MAX_QUEUE, **kw)
    # the server takes the reference's arguments; the saturation time is
    # the scheduler's (read at every admission)
    srv.scheduler.brownout_after_s = FD_BROWNOUT_AFTER_S
    clamp = srv.scheduler.brownout_max_new
    try:
        host, port = srv.serve_http(port=0, block=False)
        first = [srv.submit(p, max_new_tokens=GEN, priority=1)
                 for p in prompts[:8]]
        t_wait = time.perf_counter()
        while any(r.t_admit is None for r in first):
            check(time.perf_counter() - t_wait < 60, "22c: first wave "
                  "not admitted in 60 s")
            time.sleep(0.001)
        idx = [i % len(prompts) for i in range(8, 24)]
        second, out = [], {}

        def post():
            out["r"] = http_json(
                "http://%s:%d/v1/generate" % (host, port),
                {"tokens": prompts[idx[-1]], "max_new_tokens": GEN,
                 "priority": 0})

        for k, i in enumerate(idx[:-1]):
            second.append(srv.submit(prompts[i], max_new_tokens=GEN,
                                     priority=int(k < 8)))
        t = threading.Thread(target=post, daemon=True)
        t.start()
        first_out = [r.result(timeout=600) for r in first]
        results = []
        for r in second:
            try:
                results.append(r.result(timeout=600))
            except serving.BrownoutShed:
                results.append(None)
        t.join(timeout=600)
        sheds = srv.metrics.brownout_shed
        stz = srv.statusz()
    finally:
        srv.close()
    check("r" in out and out["r"][0] == 503
          and int(out["r"][2].get("Retry-After", 0)) >= 1,
          "22c: priority-0 request over HTTP: %r (want 503 + Retry-After)"
          % (out.get("r", (None,))[:2],))
    check(all(len(o) == GEN for o in first_out), "22c: a request admitted "
          "before brownout lost tokens: %r" % [len(o) for o in first_out])
    compare_tokens("22c before brownout", first_out,
                   [ref[i] for i in range(8)], [margins[i] for i in range(8)],
                   quiet=True)
    high = [(r, o) for r, o in zip(second[:8], results[:8])]
    low = results[8:]
    check(all(o is None for o in low) and sheds == 8,
          "22c: priority-0 class: %d of 7 in-process shed, %d sheds "
          "counted (want all, 8)" % (sum(o is None for o in low), sheds))
    check(all(o is not None for _, o in high), "22c: a priority-1 request "
          "was shed")
    clamped = [r for r, o in high if len(o) == clamp]
    full = [r for r, o in high if len(o) == GEN]
    check(clamped and len(clamped) + len(full) == 8
          and max(r.t_admit for r in clamped)
          <= min([r.t_admit for r in full] or [float("inf")]),
          "22c: second-wave lengths %r: want clamped (%d) ones first, "
          "then full ones once brownout disengaged"
          % ([len(o) for _, o in high], clamp))
    compare_tokens("22c during brownout", [o for _, o in high],
                   [ref[i] for i in idx[:8]], [margins[i] for i in idx[:8]],
                   quiet=True)
    token_identity(stz["tokens"], "22c /statusz")
    return {"brownout_sheds": sheds, "clamped": len(clamped),
            "clamped_to": clamp, "unclamped_after": len(full),
            "shed_tokens": stz["tokens"]["shed"]}


def front_door_observability(srv, tid, tmp):
    """22d on the warm server after 22a-b: the traced request's spans on
    one Perfetto row; the text/plain /metrics under the Prometheus
    grammar with its counters equal to snapshot()'s; /statusz's token
    identity overall and per tenant; the request log's required keys;
    a flight dump; tools/postmortem.py and tools/fleet_top.py rendering
    the dump and the live server."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import slo
    doc = telemetry.export_perfetto(os.path.join(tmp, "trace.json"))
    evs = [e for e in doc["traceEvents"]
           if e["ph"] == "X" and e["args"].get("trace") == tid]
    names = {e["name"] for e in evs}
    check({"serving.submit", "serving.queue", "serving.prefill",
           "serving.decode"} <= names and len({e["tid"] for e in evs}) == 1,
          "22d: the traced request's spans %r on rows %r"
          % (sorted(names), sorted({e["tid"] for e in evs})))
    host, port = srv._httpd.server_address
    base = "http://%s:%d" % (host, port)
    snap = srv.snapshot()
    rq = urllib.request.Request(base + "/metrics",
                                headers={"Accept": "text/plain"})
    with urllib.request.urlopen(rq, timeout=60) as r:
        check(r.headers["Content-Type"].startswith("text/plain"),
              "22d: /metrics content type %r" % r.headers["Content-Type"])
        text = r.read().decode()
    samples = {}
    for ln in text.splitlines():
        if ln.startswith("#"):
            continue
        m = PROM_SAMPLE.match(ln)
        check(m is not None, "22d: /metrics line off the Prometheus "
              "grammar: %r" % ln)
        samples.setdefault(m.group(1), float(m.group(2)))
    for name, (a, b) in PROM_VS_SNAPSHOT:
        check(samples.get(name) == snap[a][b], "22d: %s = %r, snapshot "
              "%s.%s = %r" % (name, samples.get(name), a, b, snap[a][b]))
    code, stz, _ = http_json(base + "/statusz")
    check(code == 200 and any(o["objective"] == "ttft" for o in stz["slo"]),
          "22d: /statusz %d without the ttft objective" % code)
    token_identity(stz["tokens"], "22d /statusz")
    for name, t in stz["tenants"].items():
        token_identity(t["tokens"], "22d /statusz tenant %s" % name)
    with open(os.environ["MXNET_REQUEST_LOG"]) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    check(recs and all(all(k in r for k in slo.REQUEST_LOG_REQUIRED)
                       and r["event"] in slo.REQUEST_LOG_EVENTS
                       for r in recs),
          "22d: request log: %d lines, some without %r"
          % (len(recs), slo.REQUEST_LOG_REQUIRED))
    flight_dir = os.environ["MXNET_FLIGHT_RECORDER_DIR"]
    dump = telemetry.flight().dump("smoke")
    check(dump is not None and os.path.dirname(dump) == flight_dir,
          "22d: flight dump %r not in %r" % (dump, flight_dir))
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools")
    pm = subprocess.run([sys.executable, os.path.join(tools, "postmortem.py"),
                         flight_dir], capture_output=True, text=True,
                        timeout=120)
    check(pm.returncode == 0 and "smoke" in pm.stdout,
          "22d: postmortem.py rc %d: %s" % (pm.returncode, pm.stderr[-500:]))
    ft = subprocess.run([sys.executable, os.path.join(tools, "fleet_top.py"),
                         "--url", base, "--once", "--plain"],
                        capture_output=True, text=True, timeout=120)
    check(ft.returncode == 0 and "server: OK" in ft.stdout,
          "22d: fleet_top.py rc %d: %s" % (ft.returncode,
                                           (ft.stdout + ft.stderr)[-500:]))
    return {"prometheus_samples": len(samples), "request_log_lines":
            len(recs), "tenants": sorted(stz["tenants"]),
            "goodput_tokens": stz["tokens"]["goodput"],
            "slow_tokens": stz["tokens"]["slow"],
            "perfetto_spans_of_trace": len(evs)}


def front_door_cost_run(serving, params, cfg, prompts, kw, flag):
    """One run of phase 4's traffic (8 in-process requests and one HTTP
    POST) on a fresh server under MXNET_TELEMETRY=`flag`. A wrapper on
    the engine's decode_step stamps each call's start and end: the step
    period (start to next start) holds the loop's whole iteration, the
    per-token accounting after the call included; the call alone is
    the engine's share, and the gap from a call's end to the next
    call's start the loop's own."""
    os.environ["MXNET_TELEMETRY"] = flag
    srv = serving.serve((params, cfg), **kw)
    starts, calls = [], []
    real = srv.engine.decode_step

    def timed(seqs):
        t0 = time.perf_counter()
        out = real(seqs)
        starts.append(t0)
        calls.append(time.perf_counter() - t0)
        return out

    srv.engine.decode_step = timed
    try:
        host, port = srv.serve_http(port=0, block=False)
        out = {}

        def post():
            out["r"] = http_json("http://%s:%d/v1/generate" % (host, port),
                                 {"tokens": prompts[8],
                                  "max_new_tokens": GEN})

        t0 = time.perf_counter()
        client = threading.Thread(target=post, daemon=True)
        client.start()
        reqs = [srv.submit(p, max_new_tokens=GEN) for p in prompts[:8]]
        outs = [r.result(timeout=600) for r in reqs]
        client.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        srv.close()
    check("r" in out and out["r"][0] == 200
          and all(len(o) == GEN for o in outs),
          "22e: a run under MXNET_TELEMETRY=%s failed" % flag)
    periods = sorted(b - a for a, b in zip(starts, starts[1:]))
    gaps = sorted(b - a - c for a, b, c in zip(starts, starts[1:], calls))
    ttft = sorted(r.t_first_token - r.t_submit for r in reqs)
    return {"telemetry": int(flag),
            "step_period_p50_ms": 1e3 * periods[len(periods) // 2],
            "decode_call_p50_ms": 1e3 * sorted(calls)[len(calls) // 2],
            "between_calls_p50_ms": 1e3 * gaps[len(gaps) // 2],
            "tokens_per_s": 9 * GEN / wall,
            "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2]}


def front_door_cost(serving, params, cfg, prompts, kw):
    """22e: phase 4's traffic on fresh servers with MXNET_TELEMETRY=0 and
    =1 in ABBA blocks (off, on, on, off), FD_COST_BLOCKS of them, after
    one warm-up run that is reported apart. Returns the warm-up, the
    runs in order, and for each metric the medians off and on and the
    median of the on - off differences over the 2 x FD_COST_BLOCKS
    pairs."""
    prev = os.environ.get("MXNET_TELEMETRY")
    try:
        warm = front_door_cost_run(serving, params, cfg, prompts, kw, "1")
        runs = [front_door_cost_run(serving, params, cfg, prompts, kw, f)
                for _ in range(FD_COST_BLOCKS) for f in "0110"]
    finally:
        if prev is None:
            os.environ.pop("MXNET_TELEMETRY", None)
        else:
            os.environ["MXNET_TELEMETRY"] = prev

    def med(xs):
        xs = sorted(xs)
        n = len(xs)
        return (xs[(n - 1) // 2] + xs[n // 2]) / 2

    summary = {}
    for key in ("step_period_p50_ms", "decode_call_p50_ms",
                "between_calls_p50_ms", "tokens_per_s", "ttft_p50_ms"):
        off = [r[key] for r in runs if not r["telemetry"]]
        on = [r[key] for r in runs if r["telemetry"]]
        # a block's pairs are (run 0, run 1) and (run 3, run 2)
        diffs = [runs[4 * b + j][key] - runs[4 * b + i][key]
                 for b in range(FD_COST_BLOCKS)
                 for i, j in ((0, 1), (3, 2))]
        summary[key] = {"off": med(off), "on": med(on),
                        "on_minus_off": med(diffs),
                        "on_minus_off_range": [min(diffs), max(diffs)]}
    return {"warm_up": warm, "runs": runs, "median": summary}


def phase_front_door(torch, np, dev, card):
    """Phase 22: the serving front door's contract at phase 4's width on
    K1 — tenants and priorities (a), deadlines over HTTP (b), brownout
    (c), observability (d) and telemetry's cost (e). Returns K1's
    launches in 22a and the printed numbers."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(22)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, PROMPT_LEN)]
               for _ in range(FD_PROMPTS)]
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 GEN, dev)
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
    env = {k: os.environ.get(k) for k in (
        "MXNET_SLO_TTFT_MS", "MXNET_REQUEST_LOG",
        "MXNET_FLIGHT_RECORDER_DIR")}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MXNET_SLO_TTFT_MS"] = "1000"
        os.environ["MXNET_REQUEST_LOG"] = os.path.join(tmp, "requests.jsonl")
        os.environ["MXNET_FLIGHT_RECORDER_DIR"] = os.path.join(tmp,
                                                               "flight")
        try:
            srv = serving.serve((params, cfg),
                                tenant_budget=FD_TENANT_BUDGET, **kw)
            try:
                outs, reqs, launches = front_door_tenants(pa, srv, cfg,
                                                          prompts)
                n = compare_tokens("22a", outs, ref, margins, quiet=True)
                tid, dl = front_door_deadlines(serving, params, cfg, srv,
                                               prompts, ref, margins, kw)
                obs = front_door_observability(srv, tid, tmp)
            finally:
                srv.close()
            brown = front_door_brownout(serving, params, cfg, prompts, ref,
                                        margins, kw)
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    cost = front_door_cost(serving, params, cfg, prompts, kw)
    out = {"card": card, "tenants": {
        "kernel_launches": launches, "tokens_compared": n,
        "interactive_admit_ms_after_submit": [
            1e3 * (r.t_admit - r.t_submit) for r in reqs[8:]],
        "batch_admit_ms_after_submit": [
            1e3 * (r.t_admit - r.t_submit) for r in reqs[:8]]},
        "deadlines": dl, "brownout": brown, "observability": obs,
        "telemetry_cost": cost}
    print("front door path (phase 22): " + json.dumps(out))
    return launches, out



#: phase 23: the multi-replica door at phase 4's width and config on K1;
#: routing (a), the chaos drill (b), prefill/decode roles (c), autoscale
#: (d). Prompt lengths and new-token counts are (low, high) ranges drawn
#: from seed 23; the rehearsal on the CPU shrinks them with BENCH_CFG.
FLEET_REPLICAS = 3
FLEET_REQUESTS = 24
#: 23a's runs of the traffic, in order (one pair, for the run's time
#: limit: a second pair in turns added ~35 s)
FLEET_TURNS = ("fleet", "single")
FLEET_CLIENTS = 6
FLEET_PROMPT = (32, 256)
FLEET_GEN = (16, 128)
FLEET_BURST = 60
FLEET_BURST_QUEUE = 2
DRILL_REQUESTS = 24
DRILL_PROMPT = (32, 128)
DRILL_GEN = (16, 64)
DRILL_PIN_GEN = 128
DRILL_BEAT_AGE_S = 1.5
DRILL_WEDGE_S = 3.5
DRILL_FAULTS = ("chaos.serve_wedge", "chaos.serve_kill",
                "chaos.serve_poison", "chaos.serve_exhaust",
                "chaos.serve_crash_loop")
ROLES_SHARED = 256
ROLES_SUFFIX = 32
ROLES_UNSHARED = 8
ROLES_PROMPT = (32, 128)
ROLES_GEN = (16, 64)
SCALE_TTFT_MS = "10"
SCALE_WINDOWS = "1,2"
SCALE_BURST = 16
#: bound on every wait of phase 23 (s)
FLEET_WAIT_S = 120
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")


def fleet_work(np, rng, n, lens, gens, vocab):
    """`n` (prompt, new tokens) pairs, lengths drawn in the given ranges."""
    out = []
    for _ in range(n):
        plen = int(rng.randint(lens[0], lens[1] + 1))
        out.append(([int(t) for t in rng.randint(1, vocab, plen)],
                    int(rng.randint(gens[0], gens[1] + 1))))
    return out


def wait_for(pred, what, timeout=FLEET_WAIT_S, poll=None):
    """Poll `pred` until it holds; a timeout fails the check (and returns
    False where a fault-recording check lets the phase go on)."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 >= timeout:
            check(False, "timed out after %.0f s waiting for %s"
                  % (timeout, what))
            return False
        if poll is not None:
            poll()
        time.sleep(0.02)
    return True


def fleet_clients(srv, work, clients, stop=None):
    """Serve `work` from `clients` threads, client c taking requests c,
    c + clients, ...; backpressure (QueueFull, NoHealthyReplicas) is
    retried. With `stop` (an Event) each client cycles through its share
    until it is set. Returns (results {i: [tokens lists]}, requests,
    errors, wall s)."""
    from mxnet_tpu_torch import serving
    results, reqs, errors = {}, [], []
    lock = threading.Lock()

    def client(c):
        rnd = 0
        while True:
            for i in range(c, len(work), clients):
                if stop is not None and stop.is_set() and rnd > 0:
                    return
                prompt, gen = work[i]
                for attempt in range(50):
                    try:
                        req = srv.submit(list(prompt), max_new_tokens=gen)
                        break
                    except (serving.QueueFull, serving.NoHealthyReplicas):
                        time.sleep(0.05 * min(attempt + 1, 10))
                else:
                    with lock:
                        errors.append((i, "never admitted"))
                    continue
                try:
                    out = req.result(timeout=FLEET_WAIT_S)
                except Exception as e:  # reported by the caller's check
                    with lock:
                        errors.append((i, "%s: %s" % (type(e).__name__, e)))
                    continue
                with lock:
                    results.setdefault(i, []).append(out)
                    reqs.append(req)
            rnd += 1
            if stop is None or stop.is_set():
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10 * FLEET_WAIT_S)
    check(not any(t.is_alive() for t in threads), "a client never returned")
    return results, reqs, errors, time.perf_counter() - t0


def check_fleet_tokens(what, results, idx, ref, margins):
    """Every result of work item i against the oracle row idx[i]; returns
    how many tokens were compared."""
    n = 0
    for i, outs in results.items():
        for out in outs:
            n += compare_tokens(what, [out], [ref[idx[i]]],
                                [margins[idx[i]]], quiet=True)
    return n


def k1_want(cfg, snaps):
    """K1's launches on a paged fleet: n_layers x (decode steps + prefill
    chunks), summed over the replicas' snapshots."""
    return cfg.n_layers * sum(s["paths"]["paged_decode_steps"]
                              + s["paths"]["prefill_chunks"] for s in snaps)


def fleet_run(serving, pa, params, cfg, work, kw, replicas):
    """One timed run of `work` from FLEET_CLIENTS threads through
    `serve(replicas=...)` (a single LMServer at replicas=1). Returns the
    results, the numbers, K1's launches and the replicas' snapshots."""
    srv = serving.serve((params, cfg), replicas=replicas, **kw)
    try:
        pa.paged_attention.launches = 0
        results, reqs, errors, wall = fleet_clients(srv, work,
                                                    FLEET_CLIENTS)
        launches = pa.paged_attention.launches
        reps = srv.replicas if replicas > 1 else [srv]
        snaps = [r.snapshot() for r in reps]
        devices = sorted({str(r.engine.device) for r in reps})
    finally:
        srv.close(timeout=FLEET_WAIT_S)
    check(not errors, "fleet traffic failed: %r" % errors[:4])
    tokens = sum(len(o[0]) for o in results.values())
    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs)
    return results, {"tokens_per_s": tokens / wall, "wall_s": wall,
                     "ttft_p50_ms": 1e3 * ttfts[len(ttfts) // 2],
                     "completed_by_replica": [
                         s["requests"]["completed"] for s in snaps]}, \
        launches, snaps, devices


def fleet_burst(serving, params, cfg, work, idx, ref, margins, kw):
    """23a's burst past capacity over HTTP: each replica's queue cut to
    FLEET_BURST_QUEUE, FLEET_BURST POSTs at once, no retry at the door.
    Returns (statuses, Retry-After values of the 503s, 200s checked)."""
    srv = serving.serve((params, cfg), replicas=FLEET_REPLICAS, **kw)
    try:
        for rep in srv.replicas:
            rep.scheduler.max_queue = FLEET_BURST_QUEUE
        srv.submit_retries = 1
        host, port = srv.serve_http(port=0, block=False)
        url = "http://%s:%d/v1/generate" % (host, port)
        out = {}

        def post(j):
            i = j % len(work)
            out[j] = (i, http_json(url, {"tokens": work[i][0],
                                         "max_new_tokens": work[i][1]}))

        threads = [threading.Thread(target=post, args=(j,), daemon=True)
                   for j in range(FLEET_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=FLEET_WAIT_S)
        rejected = srv.snapshot()["router"]["metrics"][
            "serving_router_rejected_total"]["value"]
    finally:
        srv.close(timeout=FLEET_WAIT_S)
    check(len(out) == FLEET_BURST, "23a burst: %d of %d POSTs returned"
          % (len(out), FLEET_BURST))
    codes = [code for _, (code, _, _) in out.values()]
    retry = [int(hdr.get("Retry-After", 0))
             for _, (code, _, hdr) in out.values() if code == 503]
    check(set(codes) <= {200, 503} and retry and min(retry) >= 1,
          "23a burst: statuses %r, Retry-After %r (want 200s and 503s "
          "with Retry-After >= 1)" % (sorted(set(codes)), retry[:4]))
    check(rejected == len(retry), "23a burst: the router counted %d "
          "rejections for %d 503s" % (rejected, len(retry)))
    ok = {i: [body["tokens"]] for i, (code, body, _) in out.values()
          if code == 200}
    n = check_fleet_tokens("23a burst", ok, idx, ref, margins)
    return {"posts": FLEET_BURST, "ok_200": codes.count(200),
            "rejected_503": len(retry), "retry_after_s": max(retry),
            "tokens_compared": n}


def fleet_routing(serving, pa, params, cfg, work, idx, ref, margins, kw):
    """23a: FLEET_REQUESTS mixed-length requests from FLEET_CLIENTS
    threads through serve(replicas=3), then one LMServer on the same
    traffic (FLEET_TURNS); the first fleet run's
    tokens against the oracle, every replica serving, K1's launches equal
    to n_layers x (decode steps + prefill chunks) over the replicas; then
    the burst past capacity. Returns (K1 launches, numbers)."""
    runs, launches = {"fleet": [], "single": []}, None
    for turn in FLEET_TURNS:
        n = FLEET_REPLICAS if turn == "fleet" else 1
        results, nums, lch, snaps, devices = fleet_run(
            serving, pa, params, cfg, work, kw, n)
        runs[turn].append(nums)
        if turn == "fleet" and launches is None:
            launches = lch
            want = k1_want(cfg, snaps)
            check(launches == want and launches > 0,
                  "23a: K1 launched %d times, expected n_layers x (decode "
                  "steps + prefill chunks) over the replicas = %d"
                  % (launches, want))
            check(all(c > 0 for c in nums["completed_by_replica"]),
                  "23a: a replica served nothing: %r"
                  % nums["completed_by_replica"])
            weights = str(next(iter(params.values())).device)
            check(devices == [weights], "23a: replicas on %r, the weights "
                  "on %s" % (devices, weights))
            compared = check_fleet_tokens("23a", results, idx, ref,
                                          margins)
    burst = fleet_burst(serving, params, cfg, work, idx, ref, margins, kw)
    return launches, {"kernel_launches": launches,
                      "tokens_compared": compared, "runs": runs,
                      "burst": burst}


def busy_with_tokens(rep, min_generated=1):
    """Does the replica hold a running sequence with generated tokens?"""
    for seq in list(rep.scheduler.running):
        if seq.request is not None and \
                len(seq.tokens) - seq.prompt_len >= min_generated:
            return True
    return False


def fleet_drill(serving, pa, params, cfg, work, idx, pins, ref, margins,
                kw):
    """23b: tools/chaos_serve.py's five faults in sequence on a 3-replica
    fleet under a client stream, through the port's chaos seams: replica
    1 wedged (drained, restored), replica 0 killed mid-decode (failover,
    respawn, serving again), replica 2's decode poisoned (local resume),
    replica 2's pool exhausted, replica 1 crash-looping until its circuit
    opens. Checks availability 100 %, oracle tokens, audit_quiescent on
    survivors and corpses, the faults and victims in the flight dumps,
    postmortem.py and fleet_top.py rc 0, and the ledger identities."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.utils import chaos
    (pk_prompt, pk_gen, pk_row), (pp_prompt, pp_gen, pp_row) = pins
    flight_dir = os.environ["MXNET_FLIGHT_RECORDER_DIR"]
    srv = serving.serve((params, cfg), replicas=FLEET_REPLICAS,
                        max_beat_age=DRILL_BEAT_AGE_S, respawn_max=2,
                        respawn_backoff=0.05, **kw)
    stop_sweep, stop = threading.Event(), threading.Event()
    faults, t_fault = [], {}
    try:
        host, port = srv.serve_http(port=0, block=False)
        url = "http://%s:%d" % (host, port)

        def sweeper():             # drives drain / restore / respawn
            while not stop_sweep.is_set():
                try:
                    srv.health()
                except Exception:
                    pass
                time.sleep(0.05)

        threading.Thread(target=sweeper, daemon=True).start()
        pa.paged_attention.launches = 0
        stream = {}
        runner = threading.Thread(target=lambda: stream.update(zip(
            ("results", "reqs", "errors", "wall"),
            fleet_clients(srv, work, FLEET_CLIENTS - 2, stop))),
            daemon=True)
        t0 = time.perf_counter()
        runner.start()
        # 1. wedge replica 1: stale beat -> drain + failover -> restore
        wait_for(lambda: srv.replicas[1].scheduler.running,
                 "replica 1 under load")
        # the flight ring holds the last spans only (every decode step
        # records one): each fault is dumped as soon as it has happened
        chaos.configure(serve_wedge=(1, 1, DRILL_WEDGE_S))
        wait_for(lambda: "serve_wedge" in chaos.fired(), "the wedge")
        telemetry.flight().dump("fleet_wedge")
        wait_for(lambda: srv._drained[1], "the wedged replica drained")
        telemetry.flight().dump("fleet_wedge_drained")
        wait_for(lambda: not srv._drained[1], "the wedged replica restored")
        t_fault["wedge_to_restore_s"] = time.perf_counter() - t0
        faults.append("wedge")
        # 2. kill replica 0 mid-decode: in-flight failover, respawn
        victim0 = srv.replicas[0]
        req_kill = victim0.submit(list(pk_prompt), max_new_tokens=pk_gen)
        wait_for(lambda: busy_with_tokens(victim0),
                 "replica 0 decoding the pinned request")
        t1 = time.perf_counter()
        chaos.configure(serve_kill=(0, 1))
        # the dying thread re-homes its work before it exits
        wait_for(lambda: not victim0._thread.is_alive(), "the kill")
        telemetry.flight().dump("fleet_kill")
        got_kill = req_kill.result(timeout=FLEET_WAIT_S)
        telemetry.flight().dump("fleet_kill_finished")
        wait_for(lambda: srv.replicas[0] is not victim0,
                 "replica 0 respawned")
        t_fault["kill_to_respawn_s"] = time.perf_counter() - t1
        again = srv.replicas[0].generate(list(pk_prompt),
                                         max_new_tokens=pk_gen,
                                         timeout=FLEET_WAIT_S)
        faults.append("kill")
        # 3. poison one decode step on replica 2 (local resume)
        req_poison = srv.replicas[2].submit(list(pp_prompt),
                                            max_new_tokens=pp_gen)
        wait_for(lambda: busy_with_tokens(srv.replicas[2]),
                 "replica 2 decoding the pinned request")
        resumes = srv.replicas[2].metrics.failovers
        chaos.configure(serve_poison=(2, 1))
        wait_for(lambda: srv.replicas[2].metrics.failovers > resumes,
                 "the poisoned batch resumed")
        telemetry.flight().dump("fleet_poison")
        got_poison = req_poison.result(timeout=FLEET_WAIT_S)
        telemetry.flight().dump("fleet_poison_finished")
        faults.append("poison")
        # 4. transient pool exhaustion on replica 2
        chaos.configure(serve_exhaust=(2, 1, 10))
        wait_for(lambda: "serve_exhaust" in chaos.fired(), "the exhaustion")
        telemetry.flight().dump("fleet_exhaust")
        faults.append("exhaust")
        stop.set()
        runner.join(timeout=10 * FLEET_WAIT_S)
        check(not runner.is_alive() and "results" in stream,
              "23b: the client stream never finished")
        storm_s = time.perf_counter() - t0
        storm_launches = pa.paged_attention.launches
        wait_for(lambda: srv.health()["replicas_healthy"] == 3,
                 "the respawned replica back in rotation")
        # 5. crash loop on replica 1: the circuit opens, the fleet serves
        t2 = time.perf_counter()
        chaos.configure(serve_crash_loop=(1, 1))
        wait_for(lambda: srv.health()["replicas_circuit_open"] == 1,
                 "the crash-loop circuit opening")
        telemetry.flight().dump("fleet_crash_loop")
        chaos.configure(serve_crash_loop=None)
        t_fault["crash_loop_to_open_s"] = time.perf_counter() - t2
        h = srv.health()
        check(h["ok"] and h["degraded"] and h["replicas"][1]["circuit_open"],
              "23b: after the crash loop /healthz says %r"
              % {k: h[k] for k in ("ok", "degraded",
                                   "replicas_circuit_open")})
        after = {i: [srv.generate(list(work[i][0]),
                                  max_new_tokens=work[i][1],
                                  timeout=FLEET_WAIT_S)]
                 for i in range(6)}
        faults.append("crash_loop")
        ft = subprocess.run(
            [sys.executable, os.path.join(TOOLS, "fleet_top.py"), "--url",
             url, "--once", "--plain"], capture_output=True, text=True,
            timeout=FLEET_WAIT_S)
        check(ft.returncode == 0 and "fleet:" in ft.stdout
              and "CIRCUIT" in ft.stdout,
              "23b: fleet_top.py rc %d: %s"
              % (ft.returncode, (ft.stdout + ft.stderr)[-800:]))
        stop_sweep.set()
        # leak audit on every replica's pool and every retired corpse
        engines = [r.engine for r in srv.replicas] + list(
            srv._retired_engines)
        wait_for(lambda: not any(e.cache.pool.in_use for e in engines),
                 "every pool quiescent")
        for e in engines:
            e.audit_quiescent()
        stz = srv.statusz()
        agg = srv.snapshot()["aggregate"]
        token_identity(stz["fleet"]["tokens"], "23b fleet /statusz")
        for name, t in stz["fleet"]["tenants"].items():
            token_identity(t["tokens"], "23b tenant %s" % name)
        rq = agg["requests"]
        check(rq["submitted"] == rq["completed"] + rq["failed"]
              + rq["expired"] and rq["failed"] == 0,
              "23b: request ledger %r" % rq)
    finally:
        stop.set()
        stop_sweep.set()
        chaos.reset()
        srv.close(timeout=FLEET_WAIT_S)
    check(not stream["errors"], "23b: %d stream requests failed: %r"
          % (len(stream["errors"]), stream["errors"][:4]))
    n_done = sum(len(v) for v in stream["results"].values())
    compared = check_fleet_tokens("23b stream", stream["results"], idx, ref,
                                  margins)
    compared += check_fleet_tokens("23b survivors", after, idx, ref, margins)
    for what, got, row in (("killed", [got_kill, again], pk_row),
                           ("poisoned", [got_poison], pp_row)):
        for g in got:
            compared += compare_tokens("23b " + what, [g], [ref[row]],
                                       [margins[row]], quiet=True)
    check(storm_launches > 0, "23b: K1 never launched in the storm")
    check(agg["failovers"] >= 1 and agg["respawns"] >= 1,
          "23b: failovers %d, respawns %d" % (agg["failovers"],
                                               agg["respawns"]))
    # the faults and the victims' lifecycles on the postmortem timeline
    telemetry.flight().dump("fleet_drill_end")
    pm = subprocess.run([sys.executable, os.path.join(TOOLS,
                                                      "postmortem.py"),
                         flight_dir], capture_output=True, text=True,
                        timeout=FLEET_WAIT_S)
    check(pm.returncode == 0, "23b: postmortem.py rc %d: %s"
          % (pm.returncode, pm.stderr[-800:]))
    missing = [f for f in DRILL_FAULTS if f not in pm.stdout]
    check(not missing, "23b: the postmortem timeline lacks %r" % missing)
    for ev in ("request.failover", "request.finish"):
        check(ev in pm.stdout, "23b: no %s on the postmortem timeline" % ev)
    for victim in (req_kill, req_poison):
        check(("request=%d" % victim.id) in pm.stdout
              and victim.trace in pm.stdout,
              "23b: victim %d's failover is not on the timeline" % victim.id)
    return storm_launches, {
        "faults": faults, "availability": 1.0,
        "stream_requests": n_done, "tokens_compared": compared,
        "storm_s": storm_s, "failovers": agg["failovers"],
        "respawns": agg["respawns"], "orphaned": agg["orphaned"],
        "retired_engines_audited": len(srv._retired_engines),
        "kernel_launches_storm": storm_launches, **t_fault}


def fleet_roles(serving, pa, params, cfg, work, idx, ref, margins, kw):
    """23c: roles="prefill:1,decode:2" with the prefix cache: ROLES_UNSHARED
    requests at once, then the ROLES_SHARED-prefix ones one after another.
    Every request migrates exactly once with oracle tokens and one trace
    across the hop, the decode replicas' prefix hits save bytes, K1's
    launches match the replicas' steps and chunks; then, with the decode
    replicas retired, the prefill replica finishes requests locally."""
    from mxnet_tpu_torch import telemetry
    srv = serving.serve((params, cfg), roles="prefill:1,decode:2",
                        prefix_cache=True, **kw)
    retired = []
    try:
        pa.paged_attention.launches = 0
        unshared = [i for i in range(len(work)) if i < ROLES_UNSHARED]
        reqs = {i: srv.submit(list(work[i][0]), max_new_tokens=work[i][1])
                for i in unshared}
        outs = {i: [r.result(timeout=FLEET_WAIT_S)] for i, r in
                reqs.items()}
        for i in range(ROLES_UNSHARED, len(work)):
            reqs[i] = srv.submit(list(work[i][0]),
                                 max_new_tokens=work[i][1])
            outs[i] = [reqs[i].result(timeout=FLEET_WAIT_S)]
        launches = pa.paged_attention.launches
        snaps = [r.snapshot() for r in srv.replicas]
        want = k1_want(cfg, snaps)
        check(launches == want and launches > 0,
              "23c: K1 launched %d times, expected %d" % (launches, want))
        stz = srv.statusz()["fleet"]
        decs = srv.replicas[1:]
        check(stz["migrations"] == len(work)
              and srv.replicas[0].metrics.migrations == 0,
              "23c: %d migrations for %d requests"
              % (stz["migrations"], len(work)))
        hops = []
        for i, r in reqs.items():
            names = [s["name"] for s in telemetry.spans(trace=r.trace)]
            hops.append(names.count("serving.migration_hop"))
            check({"serving.prefill", "serving.decode"} <= set(names),
                  "23c: request %d's trace holds %r" % (i, sorted(set(names))))
        check(hops == [1] * len(work), "23c: migration hops per request %r"
              % hops)
        saved = sum(d.metrics.migration_bytes_saved for d in decs)
        check(saved > 0, "23c: no bytes saved on the decode replicas' "
              "prefix hits")
        token_identity(stz["tokens"], "23c fleet /statusz")
        # the decode replicas go: the prefill replica decodes locally
        for _ in decs:
            retired.append(srv.scale_down())
        check(None not in retired, "23c: a decode replica was not retired")
        check([r.role for r in srv.replicas] == ["prefill"],
              "23c: replicas left %r" % [r.role for r in srv.replicas])
        local = {i: [srv.generate(list(work[i][0]),
                                  max_new_tokens=work[i][1],
                                  timeout=FLEET_WAIT_S)]
                 for i in range(3)}
        check(srv.replicas[0].metrics.migrations == 0
              and srv.statusz()["fleet"]["migrations"] == 0,
              "23c: migrations after the decode replicas went")
        for e in [srv.replicas[0].engine] + [r.engine for r in retired]:
            e.audit_quiescent()
    finally:
        srv.close(timeout=FLEET_WAIT_S)
    n = check_fleet_tokens("23c migrated", outs, idx, ref, margins)
    n += check_fleet_tokens("23c local", local, idx, ref, margins)
    return launches, {"requests": len(work), "migrations":
                      stz["migrations"], "migration_tokens":
                      stz["migration_tokens"],
                      "migration_bytes_saved": saved,
                      "tokens_compared": n, "kernel_launches": launches}


def fleet_autoscale(serving, pa, params, cfg, work, idx, ref, margins, kw):
    """23d: a fleet at 1 replica with AutoscaleConfig(min 1, max 3),
    MXNET_SLO_WINDOWS=SCALE_WINDOWS and MXNET_SLO_TTFT_MS=SCALE_TTFT_MS;
    step() driven by hand over real burns: a burst burns -> "up", a
    second step inside the cooldown holds, the windows cool and the fleet
    idles -> "down". No request lost, every output the oracle's, K1's
    launches match the replicas' steps and chunks (the retiree's too)."""
    from mxnet_tpu_torch.serving import AutoscaleConfig
    env = {k: os.environ.get(k) for k in ("MXNET_SLO_TTFT_MS",
                                          "MXNET_SLO_WINDOWS")}
    os.environ["MXNET_SLO_TTFT_MS"] = SCALE_TTFT_MS
    os.environ["MXNET_SLO_WINDOWS"] = SCALE_WINDOWS
    srv = None
    try:
        srv = serving.serve((params, cfg), autoscale=AutoscaleConfig(
            min_replicas=1, max_replicas=3, cooldown_s=5.0,
            idle_retire_s=1.0, interval_s=3600.0), **kw)
        sc = srv.autoscaler
        check(type(srv).__name__ == "ReplicatedLMServer"
              and srv.replica_count() == 1,
              "23d: serve(autoscale=) built %s of %d"
              % (type(srv).__name__, len(getattr(srv, "replicas", []))))
        pa.paged_attention.launches = 0
        steps = [sc.step(now=0.0)]           # the burn baseline
        burst = [(i, srv.submit(list(work[i][0]), max_new_tokens=work[i][1]))
                 for i in range(SCALE_BURST)]
        # a burn is a window delta over the trackers' samples: keep one
        # sample in each short window while the burst's first tokens land
        wait_for(lambda: all(r.t_first_token is not None for _, r in burst),
                 "the burst's first tokens", poll=sc.burn_rates)
        burns = sc.burn_rates()
        steps.append(sc.step(now=1.0))       # burning: up
        n_up = srv.replica_count()
        steps.append(sc.step(now=2.0))       # inside the cooldown: hold
        more = [(i, srv.submit(list(work[i][0]), max_new_tokens=work[i][1]))
                for i in range(SCALE_BURST, len(work))]
        outs = {i: [r.result(timeout=FLEET_WAIT_S)] for i, r in burst + more}
        served_by_new = srv.replicas[-1].metrics.completed
        # the windows cool on the wall clock; the idle clock is injected
        time.sleep(float(SCALE_WINDOWS.split(",")[-1]) + 0.5)
        steps.append(sc.step(now=10.0))      # idle starts
        snaps = [r.snapshot() for r in srv.replicas]
        steps.append(sc.step(now=12.0))      # idle + cold: down
        n_down = srv.replica_count()
        launches = pa.paged_attention.launches
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if srv is not None:
            srv.close(timeout=FLEET_WAIT_S)
    check(steps == [None, "up", None, None, "down"] and n_up == 2
          and n_down == 1,
          "23d: decisions %r, replicas %d after up, %d after down "
          "(burns %r)" % (steps, n_up, n_down, burns))
    check(served_by_new > 0, "23d: the new replica served nothing")
    check(sc.scale_ups == 1 and sc.scale_downs == 1,
          "23d: %d ups, %d downs" % (sc.scale_ups, sc.scale_downs))
    want = k1_want(cfg, snaps)
    check(launches == want and launches > 0,
          "23d: K1 launched %d times, expected %d" % (launches, want))
    n = check_fleet_tokens("23d", outs, idx, ref, margins)
    check(len(outs) == len(work), "23d: %d of %d requests answered"
          % (len(outs), len(work)))
    return launches, {"decisions": steps, "burn_at_up": {
        str(w): b["rate"] for w, b in burns.items()},
        "served_by_new_replica": served_by_new, "tokens_compared": n,
        "kernel_launches": launches, "decode_steps_by_replica": [
            s["paths"]["paged_decode_steps"] for s in snaps]}


def phase_fleet(torch, np, dev, card):
    """Phase 23: the multi-replica door at phase 4's width on K1, every
    replica's loop launching onto one card — routing in turns with one
    server (a), the chaos drill (b), prefill/decode roles (c) and
    autoscale (d). One gather oracle for the whole phase. Returns K1's
    launches over 23a-d and the printed numbers."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(23)
    route = fleet_work(np, rng, FLEET_REQUESTS, FLEET_PROMPT, FLEET_GEN,
                       cfg.vocab)
    drill = fleet_work(np, rng, DRILL_REQUESTS, DRILL_PROMPT, DRILL_GEN,
                       cfg.vocab)
    pins = fleet_work(np, rng, 2, (DRILL_PROMPT[0], DRILL_PROMPT[0]),
                      (DRILL_PIN_GEN, DRILL_PIN_GEN), cfg.vocab)
    roles = fleet_work(np, rng, ROLES_UNSHARED, ROLES_PROMPT, ROLES_GEN,
                       cfg.vocab)
    shared = [int(t) for t in rng.randint(1, cfg.vocab, ROLES_SHARED)]
    roles += [(shared + [int(t) for t in rng.randint(1, cfg.vocab,
                                                     ROLES_SUFFIX)],
               int(rng.randint(ROLES_GEN[0], ROLES_GEN[1] + 1)))
              for _ in range(4)]
    rows = route + drill + pins + roles
    gen = max(g for _, g in rows)
    t0 = time.perf_counter()
    ref, margins = gather_oracle(torch, np, serving, params, cfg,
                                 [p for p, _ in rows], gen, dev)
    oracle_s = time.perf_counter() - t0
    base = {"route": 0, "drill": len(route),
            "pins": len(route) + len(drill),
            "roles": len(route) + len(drill) + 2}
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
    out = {"card": card, "replicas": FLEET_REPLICAS, "oracle_s": oracle_s}
    launches = {}
    t0 = time.perf_counter()
    launches["a"], out["routing"] = fleet_routing(
        serving, pa, params, cfg, route,
        [base["route"] + i for i in range(len(route))], ref, margins, kw)
    out["routing_s"] = time.perf_counter() - t0
    env = {k: os.environ.get(k) for k in ("MXNET_FLIGHT_RECORDER_DIR",)}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MXNET_FLIGHT_RECORDER_DIR"] = os.path.join(tmp, "flight")
        try:
            t0 = time.perf_counter()
            pin_rows = [(p, g, base["pins"] + j)
                        for j, (p, g) in enumerate(pins)]
            launches["b"], out["drill"] = fleet_drill(
                serving, pa, params, cfg, drill,
                [base["drill"] + i for i in range(len(drill))], pin_rows,
                ref, margins, kw)
            out["drill_s"] = time.perf_counter() - t0
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    t0 = time.perf_counter()
    launches["c"], out["roles"] = fleet_roles(
        serving, pa, params, cfg, roles,
        [base["roles"] + i for i in range(len(roles))], ref, margins, kw)
    out["roles_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["d"], out["autoscale"] = fleet_autoscale(
        serving, pa, params, cfg, route[:SCALE_BURST + 8],
        list(range(SCALE_BURST + 8)), ref, margins, kw)
    out["autoscale_s"] = time.perf_counter() - t0
    out["kernel_launches"] = launches
    print("fleet path (phase 23): " + json.dumps(out))
    return sum(launches.values()), out


#: phase 24: distributed training on the one card. The world of 2 ranks
#: shares cuda:0 over gloo (NCCL refuses two ranks of one communicator on
#: one device); the world of one runs NCCL itself.
DIST_MESHES = ({"dp": 2}, {"tp": 2}, {"sp": 2})
DIST_STEPS, DIST_WORLD, DIST_LM_STEPS = 3, 2, 5
#: a mesh step against the single process (float32, TF32 off): each loss
#: to phase 5's first-step tolerance, and the 3 steps' update (final -
#: initial parameters) in relative Frobenius error to max(2 x floor,
#: phase 5's gradient tolerance): each rank's GEMMs see half the batch
#: (dp), half the heads and vocabulary (tp) or half the positions (sp),
#: so cuBLAS sums in another order, and a ReLU pre-activation within
#: rounding of 0 may flip, which moves a whole gradient column (phase 5's
#: note). The floor is the single process against itself stepping on the
#: mean of two half batches' gradients (dp's arithmetic in one process)
DIST_LOSS_RTOL, DIST_UPDATE_TOL = TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL
#: phase 24a: the world of one against the single-device step: the same
#: kernels on the same shapes, the loss a sum over the global count where
#: the single device takes a mean (one rounding)
DIST_ONE_RTOL = 1e-6
#: phase 24c: one float32 step's change of the BatchNorm running
#: statistics (after - before) against the single process's, relative
#: Frobenius error over all of them. The limit lies between the sound
#: run's reading, 7.1e-7, and that of a planted fault (each rank's own
#: K3a statistics, not reduced over dp), 9.8e-3, both taken on an H100
#: 80GB HBM3 at 700 W by chip_smoke_faults.py (PERF.md, PR 19)
DIST_BN_STATS_TOL = 1e-4
#: phase 24e: the reference's loss-curve tolerance between the int8 and
#: the float32 collective (tests/test_serving_quant.py:499)
DIST_INT8_TOL = 0.05
#: phase 24e: the int8 run's parameter update (final - initial) against
#: the float32 run's, relative Frobenius error over every parameter: the
#: loss moves too little in DIST_LM_STEPS steps to tell the runs apart.
#: The limit lies between the sound int8 run's reading, 2.7e-3, and
#: those of two planted faults: the error-feedback residuals dropped,
#: 3.3e-2, and the dequantized sum doubled, 1.0 (an H100 80GB HBM3 at
#: 700 W, chip_smoke_faults.py; PERF.md, PR 19)
DIST_INT8_UPDATE_TOL = 1e-2
TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def dist_world(target, nprocs, args=(), device="cuda", timeout=600):
    """Run chip_smoke.<target>(*args) on `nprocs` ranks on `device` (the
    card; the CPU only in a rehearsal); a failed rank fails the phase
    with the ranks' output tails."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.launch import run_world
    try:
        return run_world("chip_smoke:" + target, nprocs, args=args,
                         device=device, timeout=timeout)
    except MXNetError as e:
        raise SmokeFailure(str(e)[-6000:])


def _rank_setup():
    """A rank's torch and device: TF32 off, as the parent; the card, or
    the CPU in a rehearsal of a world started with device="cpu"."""
    import torch
    from mxnet_tpu_torch.parallel import world_info
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if world_info()["device_type"] == "cpu":
        return torch, torch.device("cpu")
    return torch, torch.device("cuda", torch.cuda.current_device())


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _ctx(mx, dev):
    return mx.gpu(dev.index or 0) if dev.type == "cuda" else mx.cpu()


def _dist_counts():
    from mxnet_tpu_torch.parallel import collectives as coll
    c = coll.counters()
    return {"bytes": sum(c["bytes"].values()), "by_op": c["bytes"],
            "staged_bytes": c["staged_bytes"], "calls": c["calls"]}


def _update_err(torch, got, want, init):
    """max over tensors of ||got - want|| / ||want - init||."""
    worst = (0.0, "")
    for n, w in want.items():
        num = float((got[n].float() - w.float()).norm())
        den = max(float((w.float() - init[n].float()).norm()), 1e-30)
        worst = max(worst, (num / den, n))
    return worst


def _update_err_total(got, want, init):
    """||got - want|| / ||want - init|| over every tensor at once: how far
    one update (from `init`) strays from another."""
    num = sum(float((got[n].float() - w.float()).norm()) ** 2
              for n, w in want.items())
    den = sum(float((w.float() - init[n].float()).norm()) ** 2
              for n, w in want.items())
    return (num / max(den, 1e-60)) ** 0.5


def rank_24a(path):
    """24a on the world of one: NCCL under the kvstore and the mesh
    step, with the profiler's kernel names."""
    torch, dev = _rank_setup()
    import numpy as np
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.models import TransformerConfig
    from mxnet_tpu_torch.models import transformer as T
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import build_mesh, world_info
    info = world_info()
    want = "nccl" if dev.type == "cuda" else "gloo"
    check(info["backend"] == want and info["world_size"] == 1,
          "24a: world %r, expected one rank over %s" % (info, want))
    ref = torch.load(path)
    cfg = TransformerConfig(dtype=torch.float32, **ref["cfg"])
    os.environ["MXNET_FLASH_ATTENTION"] = "1"
    mesh = build_mesh({"dp": 1})
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with _ctx(mx, dev):
        kv = mx.kv.create("nccl")
        with profile(activities=acts) as prof:
            kv.init("w", mx.nd.ones((1024, 1024)))
            kv.push("w", [mx.nd.ones((1024, 1024)),
                          mx.nd.ones((1024, 1024))])
            out = mx.nd.zeros((1024, 1024))
            kv.pull("w", out=out)
            check(bool((out._data == 3.0).all()),
                  "24a: kv nccl push/pull gave %r" % float(out._data[0, 0]))
            if dev.type == "cuda":
                # a communicator of one rank turns an in-place sum into a
                # no-op (no kernel); an average still launches NCCL's
                # one-rank kernel, which shows the library on the card
                import torch.distributed as dist
                avg = torch.ones(1 << 20, device=dev)
                dist.all_reduce(avg, op=dist.ReduceOp.AVG)
                check(bool((avg == 1.0).all()), "24a: NCCL average wrong")
            run, params = T.make_train_step(mesh, cfg, ref["lr"], 0)
            n0 = (fa.flash_attention_fwd.launches,
                  fa.flash_attention_bwd.launches)
            _sync(torch, dev)
            t0 = time.perf_counter()
            params, loss = run(params, ref["tokens"])
            _sync(torch, dev)
            ms = 1e3 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # c10d's NCCL calls (the store's and the step's collectives) and
    # NCCL's kernels: ncclDevKernel_* across ranks, oneRankReduce in a
    # communicator of one rank
    ranges = sorted({e.key for e in events if e.key.startswith("nccl:")})
    nccl = sorted({e.key for e in events
                   if e.device_type == DeviceType.CUDA
                   and ("nccl" in e.key.lower()
                        or "onerankreduce" in e.key.lower())})
    if dev.type == "cuda":
        check(bool(ranges) and bool(nccl),
              "24a: NCCL calls %r, NCCL kernels %r: expected both"
              % (ranges, nccl))
    loss_err = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    worst = max((float((params[n].float().cpu() - w).abs().max())
                 / max(float(w.abs().max()), 1e-30), n)
                for n, w in ref["params"].items())
    check(loss_err <= DIST_ONE_RTOL and worst[0] <= DIST_ONE_RTOL,
          "24a: the world-of-one step differs from the single device: loss "
          "rel err %.3g, params %.3g (%s), tol %g"
          % (loss_err, worst[0], worst[1], DIST_ONE_RTOL))
    return {"backend": info["backend"], "world": 1, "nccl_kernels": nccl,
            "nccl_calls": ranges,
            "loss": float(loss), "loss_rel_err": loss_err,
            "param_rel_err": worst[0], "step_ms_incl_first_call": ms,
            "flash_launches": (fa.flash_attention_fwd.launches - n0[0],
                               fa.flash_attention_bwd.launches - n0[1]),
            "collectives": _dist_counts()}


def rank_24b(path):
    """24b on each rank of the world of 2: phase 5's model under each
    mesh, 3 steps from the seeded weights, held to the single process."""
    torch, dev = _rank_setup()
    from mxnet_tpu_torch.models import TransformerConfig
    from mxnet_tpu_torch.models import transformer as T
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import build_mesh, world_info
    from mxnet_tpu_torch.parallel import collectives as coll
    ref = torch.load(path)
    cfg = TransformerConfig(dtype=torch.float32, **ref["cfg"])
    os.environ["MXNET_FLASH_ATTENTION"] = "1"
    out = {"world": world_info()}
    for axes in DIST_MESHES:
        name = "x".join("%s%d" % kv for kv in axes.items())
        mesh = build_mesh(axes)
        run, params = T.make_train_step(mesh, cfg, ref["lr"], 0)
        fa.flash_attention_fwd.launches = 0
        fa.flash_attention_bwd.launches = 0
        coll.reset_counters()
        losses, times = [], []
        for _ in range(len(ref["losses"])):
            _sync(torch, dev)
            t0 = time.perf_counter()
            params, loss = run(params, ref["tokens"])
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        counts = _dist_counts()
        launches = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches)
        full = {n: v.cpu() for n, v in
                T.gather_transformer_params(params, cfg, mesh).items()}
        del params
        upd = _update_err(torch, full, ref["params"], ref["init"])
        del full
        loss_err = max(abs(x - y) / abs(y) for x, y in
                       zip(losses, ref["losses"]))
        tol = max(2 * ref["floor"], DIST_UPDATE_TOL)
        if dev.type == "cuda":
            want = 0 if "sp" in axes else cfg.n_layers * len(losses)
            check(launches == (want, want),
                  "24b %s: flash kernels launched %r on rank %d, expected "
                  "%d each" % (name, launches, mesh.rank, want))
        check(loss_err <= DIST_LOSS_RTOL,
              "24b %s: losses %r against the single process's %r (rel err "
              "%.3g > %g)" % (name, losses, ref["losses"], loss_err,
                              DIST_LOSS_RTOL))
        check(upd[0] <= tol,
              "24b %s: the update of %s differs from the single process's "
              "by %.3g (relative Frobenius) > max(2 x floor %.3g, %g)"
              % (name, upd[1], upd[0], ref["floor"], DIST_UPDATE_TOL))
        out[name] = {"losses": losses, "loss_rel_err": loss_err,
                     "update_rel_err": upd[0], "update_worst": upd[1],
                     "update_tol": tol,
                     "step_ms": [1e3 * t for t in times],
                     "flash_launches": launches, "collectives": counts}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _r50(torch, np, mx, dev, shape):
    """Phase 9's ResNet-50 and batch at `shape` (batch, image, classes),
    on `dev`."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    batch, image, classes = shape
    with _ctx(mx, dev):
        with mx.name.NameManager():
            net = vision.resnet50_v1(classes=classes)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 3, image, image)))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, 3, image, image))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, classes, (batch,))
                         .astype(np.int32)).to(dev)
    return net, x, y


def _running_stats(net):
    return {n: p.data()._data.detach().float().cpu().clone()
            for n, p in net.collect_params().items()
            if "running" in n}


def rank_24c(path, floor):
    """24c on each rank: ResNet-50 under {'dp': 2} with the sharded
    update, the float32 first step and one step's running statistics
    held to the single process's, then 2 timed bfloat16 steps."""
    torch, dev = _rank_setup()
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.parallel import TrainStep, build_mesh
    from mxnet_tpu_torch.parallel import collectives as coll
    ref = torch.load(path)
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = build_mesh({"dp": DIST_WORLD})
    net, x, y = _r50(torch, np, mx, dev, ref["shape"])
    with _ctx(mx, dev):
        for n, p in net.collect_params().items():
            p.set_data(ref["init"][n].to(dev))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        step = TrainStep(net, loss_fn, "sgd", dict(ref["opt"]), mesh=mesh,
                         sharded_update=True)
        loss, grads = step.loss_and_grads(x, y)
        loss_err = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        zero = [n for n in grads if "conv2d" in n and n.endswith("_bias")]
        worst, worst_zero = (0.0, ""), 0.0
        for n, g in ref["grads"].items():
            got = grads[n].cpu()
            if n in zero:
                worst_zero = max(worst_zero, float(got.abs().max()) / top)
                continue
            worst = max(worst, (rel_frobenius(got, g), n))
        del grads
        tol = max(2 * floor, R50_GRAD_MIN_TOL)
        check(loss_err <= R50_LOSS_RTOL,
              "24c: first-step loss %r against the single process's %r "
              "(rel err %.3g > %g)" % (float(loss), ref["loss"], loss_err,
                                       R50_LOSS_RTOL))
        check(worst[0] <= tol,
              "24c: first-step grad %s against the single process's: "
              "relative Frobenius error %.3g > max(2 x floor %.3g, %g)"
              % (worst[1], worst[0], floor, R50_GRAD_MIN_TOL))
        check(worst_zero <= R50_ZERO_GRAD,
              "24c: a conv bias feeding a BatchNorm has a gradient of %.3g "
              "of the largest (> %g)" % (worst_zero, R50_ZERO_GRAD))
        step(x, y)
        stats = _running_stats(net)
        stats_err = _update_err_total(
            stats, ref["stats"], {n: ref["init"][n].float()
                                  for n in ref["stats"]})
        check(stats_err <= DIST_BN_STATS_TOL,
              "24c: one step's change of the BatchNorm running statistics "
              "differs from the global batch's by %.3g (relative "
              "Frobenius) > %g" % (stats_err, DIST_BN_STATS_TOL))
        torch.backends.cudnn.deterministic = False
        step16 = TrainStep(net, loss_fn, "sgd", dict(ref["opt"]), mesh=mesh,
                           sharded_update=True, dtype="bfloat16")
        fb.reset_launch_counts()
        coll.reset_counters()
        losses, times = [], []
        for _ in range(2):
            _sync(torch, dev)
            t0 = time.perf_counter()
            losses.append(float(step16(x, y)))
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
        launches = fb.launch_counts()
        if dev.type == "cuda":
            check(launches == (106,) * 4,
                  "24c: K3a-d launched %r on rank %d over 2 steps, expected "
                  "53 x 2 = 106 each" % (launches, mesh.rank))
        check(all(np.isfinite(losses)), "24c: losses %r" % losses)
        local = sum(int(np.prod(s.shape)) for st in step16._opt_state
                    for s in st)
        whole = sum(int(np.prod(p.shape)) for p in
                    net.collect_params().values() if p.grad_req != "null")
    return {"loss_rel_err": loss_err, "grad_rel_err": worst[0],
            "grad_worst": worst[1], "grad_tol": tol, "floor": floor,
            "bn_running_stats_rel_err": stats_err,
            "bf16_losses": losses, "bf16_step_ms": [1e3 * t for t in times],
            "k3_launches": launches, "collectives": _dist_counts(),
            "momentum_elements_this_rank": local,
            "momentum_elements_unsharded": whole}


def _lm(torch, mx, dev, sizes):
    """Phase 11's word LM (RNNModel lstm) at `sizes` (vocab, embed,
    hidden, layers, bptt, batch), batch-major: it takes (N, T) tokens and
    returns (N*T, V) logits, so the batch shards along dim 0 over the
    data axis."""
    vocab, embed, hidden, layers, bptt, batch = sizes

    class BatchMajor(mx.gluon.Block):
        def __init__(self):
            super().__init__(prefix="bm_")
            with self.name_scope():
                self.lm = mx.models.RNNModel(
                    mode="lstm", vocab_size=vocab, num_embed=embed,
                    num_hidden=hidden, num_layers=layers, dropout=0.0)

        def forward(self, x):
            N, T = x.shape
            out = self.lm(x.T)
            return out.reshape((T, N, -1)).transpose((1, 0, 2)) \
                .reshape((N * T, -1))

    with _ctx(mx, dev):
        with mx.name.NameManager():
            net = BatchMajor()
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((batch, bptt)))
    return net


def rank_24e(path):
    """24e on each rank: the word LM under {'dp': 2}, the float32 and the
    int8 collective from the same weights."""
    torch, dev = _rank_setup()
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel import TrainStep, build_mesh
    from mxnet_tpu_torch.parallel import collectives as coll
    ref = torch.load(path)
    os.environ["MXNET_FUSED_RNN"] = "1"
    mesh = build_mesh({"dp": DIST_WORLD})
    vocab, _, _, layers, bptt, batch = ref["sizes"]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, vocab, (batch, bptt))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, vocab, (batch * bptt,))
                         .astype(np.int32)).to(dev)
    out, final = {}, {}
    for mode in (None, "int8"):
        net = _lm(torch, mx, dev, ref["sizes"])
        with _ctx(mx, dev):
            for n, p in net.collect_params().items():
                p.set_data(ref["init"][n].to(dev))
            step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": ref["lr"]}, mesh=mesh,
                             quantized_collectives=mode)
            fr.reset_launch_counts()
            coll.reset_counters()
            losses, times = [], []
            for _ in range(ref["steps"]):
                _sync(torch, dev)
                t0 = time.perf_counter()
                losses.append(float(step(x, y)))
                _sync(torch, dev)
                times.append(time.perf_counter() - t0)
        launches = fr.launch_counts()
        if dev.type == "cuda":
            want = layers * ref["steps"]
            check(launches == (want, want),
                  "24e %s: K4a/K4b launched %r on rank %d, expected %d each"
                  % (mode or "float32", launches, mesh.rank, want))
        check(step.collective_quant == mode,
              "24e: collective %r, asked for %r (fallback: %s)"
              % (step.collective_quant, mode,
                 step.collective_quant_fallback))
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "24e %s: losses %r" % (mode or "float32", losses))
        final[mode] = {n: p.data()._data.detach().float().cpu()
                       for n, p in net.collect_params().items()}
        out[mode or "float32"] = {
            "losses": losses, "step_ms": [1e3 * t for t in times],
            "k4_launches": launches, "collectives": _dist_counts()}
    gap = max(abs(a - b) for a, b in zip(out["int8"]["losses"],
                                         out["float32"]["losses"]))
    check(gap < DIST_INT8_TOL,
          "24e: int8 losses %r stray %.3g from the float32 run's %r (> %g)"
          % (out["int8"]["losses"], gap, out["float32"]["losses"],
             DIST_INT8_TOL))
    upd = _update_err_total(final["int8"], final[None], ref["init"])
    check(upd <= DIST_INT8_UPDATE_TOL,
          "24e: the int8 run's update strays %.3g (relative Frobenius) from "
          "the float32 run's (> %g)" % (upd, DIST_INT8_UPDATE_TOL))
    out["int8_gap"] = gap
    out["int8_update_rel_err"] = upd
    return out


def prep_24c(torch, np, mx, dev, tmp):
    """The single process's ResNet-50 for 24c under deterministic cuDNN
    (MXNET_FUSED_BN_EPILOGUE=1, which the caller restores): the float32
    first step's loss and gradients, one step's running statistics,
    saved under `tmp`; (path, the gradients' floor with the input moved
    one ulp)."""
    from mxnet_tpu_torch.parallel import TrainStep
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    cudnn = torch.backends.cudnn
    cudnn_prior = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    path = os.path.join(tmp, "r50.pt")
    try:
        shape = (R50_BATCH, R50_IMAGE, R50_CLASSES)
        net, x, y = _r50(torch, np, mx, dev, shape)
        start = {n: p.data()._data.detach().clone().cpu()
                 for n, p in net.collect_params().items()}
        with _ctx(mx, dev):
            step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", dict(R50_OPT))
            loss, grads = step.loss_and_grads(x, y)
            grads = {n: g.cpu() for n, g in grads.items()}
            # this cuDNN setting's own floor: the input moved one ulp
            _, g_ulp = step.loss_and_grads(
                torch.nextafter(x, torch.full_like(x, float("inf"))), y)
            ulp_floor = max(
                rel_frobenius(g_ulp[n].cpu(), g) for n, g in grads.items()
                if not ("conv2d" in n and n.endswith("_bias")))
            del g_ulp
            step(x, y)
        torch.save({"init": start, "loss": float(loss), "grads": grads,
                    "stats": _running_stats(net), "shape": shape,
                    "opt": dict(R50_OPT)}, path)
    finally:
        cudnn.deterministic, cudnn.benchmark = cudnn_prior
    return path, ulp_floor


def prep_24e(torch, mx, dev, tmp):
    """The word LM's initial weights for 24e, saved under `tmp`; the
    path."""
    sizes = (LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS, LM_BPTT, LM_BATCH)
    lm = _lm(torch, mx, dev, sizes)
    path = os.path.join(tmp, "lm.pt")
    torch.save({"init": {n: p.data()._data.detach().clone().cpu()
                         for n, p in lm.collect_params().items()},
                "sizes": sizes, "lr": LM_LR, "steps": DIST_LM_STEPS}, path)
    return path


def _print_ranks(what, results, card, keys):
    for r, res in enumerate(results):
        print("%s rank %d (%s): %s" % (what, r, card, json.dumps(
            {k: res[k] for k in keys if k in res})))


def phase_distributed(torch, np, dev, card, r50_floor):
    """Phase 24 (module docstring). Returns the launches of K2, K3a-d and
    K4a-b on rank 0 and a summary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import TransformerConfig
    from mxnet_tpu_torch.models import make_transformer_train_step
    tmp = tempfile.mkdtemp(prefix="mxtt_phase24_")
    device = dev.type
    summary = {"card": card}
    prior = {k: os.environ.get(k) for k in
             ("MXNET_FLASH_ATTENTION", "MXNET_FUSED_BN_EPILOGUE",
              "MXNET_FUSED_RNN")}

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    launch_d = None
    try:
        # the single process's transformer: 1 step (24a) and 3 (24b)
        os.environ["MXNET_FLASH_ATTENTION"] = "1"
        cfg = TransformerConfig(dtype=torch.float32, **TRAIN_CFG)
        toks = np.random.RandomState(0).randint(
            0, cfg.vocab, (TRAIN_BATCH, cfg.max_len))
        run, params = make_transformer_train_step(cfg, lr=TRAIN_LR, seed=0,
                                                  device=dev)
        init = {n: p.detach().cpu().clone() for n, p in params.items()}
        losses, times = [], []
        common = {"cfg": dict(TRAIN_CFG), "lr": TRAIN_LR,
                  "tokens": torch.from_numpy(toks)}
        for i in range(DIST_STEPS):
            _sync(torch, dev)
            t0 = time.perf_counter()
            params, loss = run(params, toks)
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0:
                torch.save(dict(common, loss=losses[0], params={
                    n: p.detach().float().cpu() for n, p in params.items()}),
                    os.path.join(tmp, "one.pt"))
        final = {n: p.detach().cpu() for n, p in params.items()}
        single_ms = [1e3 * t for t in times]
        del run, params
        # the floor: the same 3 steps on the mean of two half batches'
        # gradients
        from mxnet_tpu_torch.models.transformer import lm_loss_and_grads
        params = {n: v.to(dev).clone() for n, v in init.items()}
        tokens = torch.as_tensor(toks, dtype=torch.long, device=dev)
        half = TRAIN_BATCH // 2
        for _ in range(DIST_STEPS):
            _, ga = lm_loss_and_grads(params, tokens[:half], cfg)
            _, gb = lm_loss_and_grads(params, tokens[half:], cfg)
            with torch.no_grad():
                for n, p in params.items():
                    p.sub_(TRAIN_LR * (ga[n] + gb[n]) / 2)
            del ga, gb
        floor = _update_err(torch, {n: p.detach().cpu()
                                    for n, p in params.items()},
                            final, init)
        del params, tokens
        torch.save(dict(common, losses=losses, init=init, params=final,
                        floor=floor[0]), os.path.join(tmp, "three.pt"))
        del init, final
        free()

        # 24d: tools/launch.py and the port's dist kvstore flows (dense,
        # row-sparse init / push / row_sparse_pull against the
        # one-process sum (phase 28e), 2-bit, the server-side optimizer)
        # and dist LeNet worker. It shares nothing with 24a's world of
        # one but the card, so it runs beside it and is read after it
        t0_d = time.perf_counter()
        launch_d = subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, "launch.py"), "-n",
             str(DIST_WORLD), "--launcher", "local", sys.executable,
             os.path.join(TESTS, "test_torch_dist_kvstore.py"), "--check",
             "kvstore", "--check", "lenet", "--device", device,
             "--compress"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        t0 = time.perf_counter()
        a = dist_world("rank_24a", 1, (os.path.join(tmp, "one.pt"),),
                       device)[0]
        a["wall_s"] = time.perf_counter() - t0
        print("distributed 24a (%s): %s" % (card, json.dumps(a)))
        out_d, err_d = launch_d.communicate(
            timeout=max(1.0, 600 - (time.perf_counter() - t0_d)))
        wall_d = time.perf_counter() - t0_d
        check(launch_d.returncode == 0 and
              out_d.count("DIST_LENET_OK") == DIST_WORLD and
              out_d.count("DIST_KVSTORE_OK") == DIST_WORLD,
              "24d: tools/launch.py dist kvstore + LeNet rc %d:\n%s\n%s"
              % (launch_d.returncode, out_d[-3000:], err_d[-3000:]))
        print("distributed 24d (%s): tools/launch.py -n %d dist_sync "
              "kvstore flows (row-sparse included) and 2-bit LeNet, "
              "read %.1f s after its start beside 24a: %s"
              % (card, DIST_WORLD, wall_d, out_d.strip()))
        summary["24d_kvstore"] = {
            "ranks": DIST_WORLD, "wall_s_with_lenet": wall_d,
            "row_sparse_sum_equal_to_one_process": True,
            "lines": [ln for ln in out_d.splitlines()
                      if "DIST_KVSTORE_OK" in ln]}

        t0 = time.perf_counter()
        b = dist_world("rank_24b", DIST_WORLD,
                       (os.path.join(tmp, "three.pt"),), device)
        wall_b = time.perf_counter() - t0
        print("distributed 24b world (%s): %s; single-process step ms %s; "
              "update floor (two half batches) %.3g (%s)"
              % (card, json.dumps(b[0]["world"]), json.dumps(single_ms),
                 floor[0], floor[1]))
        names = ["x".join("%s%d" % kv for kv in axes.items())
                 for axes in DIST_MESHES]
        _print_ranks("distributed 24b", b, card, names)

        r50_path, ulp_floor = prep_24c(torch, np, mx, dev, tmp)
        free()
        t0 = time.perf_counter()
        c = dist_world("rank_24c", DIST_WORLD,
                       (r50_path, max(r50_floor, ulp_floor)), device)
        wall_c = time.perf_counter() - t0
        print("distributed 24c floor (%s): phase 9's %.3g, the input moved "
              "one ulp under deterministic cuDNN %.3g" % (card, r50_floor,
                                                          ulp_floor))
        _print_ranks("distributed 24c", c, card, list(c[0]))


        lm_path = prep_24e(torch, mx, dev, tmp)
        free()
        t0 = time.perf_counter()
        e = dist_world("rank_24e", DIST_WORLD, (lm_path,), device)
        wall_e = time.perf_counter() - t0
        _print_ranks("distributed 24e", e, card, ["float32", "int8",
                                                  "int8_gap",
                                                  "int8_update_rel_err"])
    finally:
        if launch_d is not None and launch_d.poll() is None:
            os.killpg(launch_d.pid, signal.SIGKILL)
            launch_d.communicate()
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    k2 = tuple(sum(b[0][n]["flash_launches"][i] for n in names)
               + a["flash_launches"][i] for i in range(2))
    summary.update({
        "24a": {k: a[k] for k in ("backend", "nccl_kernels", "loss_rel_err",
                                  "param_rel_err", "wall_s")},
        "24b": {n: {"step_ms_after_first_rank0":
                    float(np.mean(b[0][n]["step_ms"][1:])),
                    "loss_rel_err": max(r[n]["loss_rel_err"] for r in b),
                    "update_rel_err": max(r[n]["update_rel_err"] for r in b),
                    "collective_bytes_rank0": b[0][n]["collectives"]["bytes"],
                    "staged_bytes_rank0":
                        b[0][n]["collectives"]["staged_bytes"]}
                for n in names},
        "24b_single_step_ms_after_first": float(np.mean(single_ms[1:])),
        "24b_update_floor": floor[0],
        "24b_wall_s": wall_b, "24c_wall_s": wall_c, "24d_wall_s": wall_d,
        "24e_wall_s": wall_e,
        "24c_ulp_floor": ulp_floor,
        "24c": {k: c[0][k] for k in ("grad_rel_err", "floor",
                                     "bn_running_stats_rel_err",
                                     "bf16_step_ms")},
        "24e_int8_gap": e[0]["int8_gap"],
        "24e_int8_update_rel_err": e[0]["int8_update_rel_err"]})
    print("distributed path (%s): %s" % (card, json.dumps(summary)))
    launches = {"k2": k2, "k3": c[0]["k3_launches"],
                "k4": tuple(x + y for x, y in zip(
                    e[0]["float32"]["k4_launches"],
                    e[0]["int8"]["k4_launches"]))}
    return launches, summary

#: phase 25: training resilience on the word LM at phase 11's width.
#: 25a trains RES_STEPS steps straight and RES_SPLIT + restore + the rest
RES_STEPS, RES_SPLIT, RES_SAVE_EVERY = 12, 5, 4
RES_DROPOUT, RES_LR = 0.5, 0.001
#: the subprocess drills: steps of 25b-c and of 25d's campaign (whose
#: healthy hosts must still be training when the slow one's windows
#: arrive), and the seconds any one drill may take
RES_DRILL_STEPS, RES_SUP_STEPS, RES_DRILL_TIMEOUT = 12, 48, 600
#: 25d's straggler sleeps this long a step: 33 times a healthy host's
#: unloaded step (0.0149 s on an H100 80GB HBM3 at 700 W, phase 25's
#: A_straggler_flags), so its ratio to the pod's median stays past the
#: factor of 3 with the other drills running beside it
RES_SLOW_S = 0.5


def res_batch(torch, np, dev, step):
    """25a's time-major batch of `step`: a function of the step only."""
    rng = np.random.RandomState(20_000 + step)
    tok = rng.randint(0, LM_VOCAB, (LM_BPTT + 1, LM_BATCH))
    return (torch.from_numpy(tok[:-1].astype(np.float32)).to(dev),
            torch.from_numpy(tok[1:].reshape(-1).astype(np.float32))
            .to(dev))


def res_run(torch, np, mx, fr, dev, ckpt, start, stop, restore):
    """A fresh seeded word LM (dropout RES_DROPOUT) and adam step in a
    ResilientLoop over CheckpointManager(ckpt, async_save=True): restore
    first when asked, then train to step `stop`, publish, and return the
    parameters, the K4a-b launches a step, the restore ms and the
    manager."""
    from mxnet_tpu_torch.parallel import ResilientLoop, TrainStep
    from mxnet_tpu_torch.utils.recovery import CheckpointManager
    mx.random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    with _ctx(mx, dev):
        net = word_lm_net(torch, mx, dev, RES_DROPOUT)
        step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "adam", {"learning_rate": RES_LR})
        mgr = CheckpointManager(ckpt, keep=3, async_save=True)
        loop = ResilientLoop(step, mgr, save_every=RES_SAVE_EVERY,
                             policy="skip", watch_preemption=False,
                             verbose=False, metrics_port=False)
        restore_ms = None
        if restore:
            t0 = time.perf_counter()
            got = loop.restore()
            _sync(torch, dev)
            restore_ms = 1e3 * (time.perf_counter() - t0)
            check(got == start, "25a: restored step %d, expected %d"
                  % (got, start))
        per_step = []
        while loop.t < stop:
            n0 = fr.launch_counts()
            loop.step(*res_batch(torch, np, dev, loop.t))
            n1 = fr.launch_counts()
            per_step.append((n1[0] - n0[0], n1[1] - n0[1]))
        loop.finish()
    params = {n: p.data()._data.detach().clone()
              for n, p in net.collect_params().items()}
    return params, per_step, restore_ms, mgr


def res_drill(what, dev, argv, timeout=RES_DRILL_TIMEOUT, env=None):
    """Run `python -m mxnet_tpu_torch.tools.chaos_train` with `argv` on
    the word LM at phase 11's width on `dev` (the card; the CPU only in a
    rehearsal); fail the phase unless it passes. Returns (its
    DRILL_STATS, wall seconds, its stdout)."""
    t0 = time.perf_counter()
    lm = ",".join(str(v) for v in (LM_VOCAB, LM_EMBED, LM_HIDDEN,
                                   LM_LAYERS, LM_BPTT, LM_BATCH))
    with tempfile.TemporaryDirectory(prefix="mxtt_drill_") as work:
        try:
            out = subprocess.run(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_train",
                 "--device", dev.type, "--net", "lm", "--lm", lm,
                 "--work-dir", work] + argv, capture_output=True,
                text=True, timeout=timeout,
                env=None if env is None else dict(os.environ, **env),
                cwd=os.path.dirname(os.path.abspath(__file__)))
        except subprocess.TimeoutExpired as e:
            raise SmokeFailure("%s: the drill ran past %ds:\n%s"
                               % (what, timeout, (e.stdout or "")[-4000:]))
    wall = time.perf_counter() - t0
    check(out.returncode == 0, "%s: the drill failed (rc %d):\n%s\n%s"
          % (what, out.returncode, out.stdout[-6000:], out.stderr[-3000:]))
    stats = None
    for line in out.stdout.splitlines():
        if line.startswith("DRILL_STATS "):
            stats = json.loads(line[len("DRILL_STATS "):])
    check(stats is not None, "%s: no DRILL_STATS line" % what)
    return stats, wall, out.stdout


def res_inproc(torch, np, mx, fr, dev, tmp):
    """25a: RES_STEPS steps straight against RES_SPLIT, a fresh net and
    step, restore() and the rest; the parameters must be bit-identical
    and K4a-b launched LM_LAYERS times a step both ways. Returns its
    summary (with the launches of both runs)."""
    t0 = time.perf_counter()
    fr.reset_launch_counts()
    want, per_straight, _, mgr = res_run(
        torch, np, mx, fr, dev, os.path.join(tmp, "straight"), 0, RES_STEPS,
        False)
    _, per_first, _, _ = res_run(torch, np, mx, fr, dev,
                                 os.path.join(tmp, "split"), 0, RES_SPLIT,
                                 False)
    got, per_rest, restore_ms, mgr2 = res_run(
        torch, np, mx, fr, dev, os.path.join(tmp, "split"), RES_SPLIT,
        RES_STEPS, True)
    launches = fr.launch_counts()
    differ = [n for n in want if not torch.equal(got[n], want[n])]
    check(not differ, "25a: after restore() the parameters differ from the "
          "straight run's in %d tensors (%s)" % (len(differ), differ[:3]))
    expect = [(LM_LAYERS, LM_LAYERS)] * RES_STEPS
    check(per_straight == expect and per_first + per_rest == expect,
          "25a: K4a/K4b launches a step %r straight, %r resumed; expected "
          "%r" % (per_straight, per_first + per_rest, expect[0]))
    log = list(mgr.save_log) + list(mgr2.save_log)
    return {"steps": RES_STEPS, "split_at": RES_SPLIT,
            "tensors_differing": len(differ),
            "max_abs_diff": max(float((got[n] - want[n]).abs().max())
                                for n in want),
            "k4_per_step": expect[0], "k4_launches": list(launches),
            "save_copy_ms": [1e3 * r["copy_s"] for r in log],
            "save_write_fsync_ms": [1e3 * r["write_s"] for r in log
                                    if r["write_s"] is not None],
            "ckpt_bytes": mgr._metrics["bytes"].value,
            "restore_ms": restore_ms, "wall_s": time.perf_counter() - t0}


def res_pod_drill(dev, env=None):
    """25c: the pod drill over a world of 2 on `dev`; (its DRILL_STATS,
    wall seconds, stdout), failing the phase unless it passes."""
    stats, wall, out = res_drill("25c", dev, [
        "--multihost", "--steps", str(RES_DRILL_STEPS),
        "--save-every", str(RES_SAVE_EVERY)], env=env)
    check("same-shape relaunch: bit-identical on all 2 hosts" in out,
          "25c: no bit-identical same-shape relaunch line")
    return stats, wall, out


def res_supervised(dev, legs):
    """25d: the supervised campaign's `legs` over an emulated pod of 3
    hosts on `dev`; (its DRILL_STATS, wall seconds, stdout), failing the
    phase unless every leg passes."""
    stats, wall, out = res_drill("25d " + legs, dev, [
        "--multihost", "--supervised", "--legs", legs,
        "--steps", str(RES_SUP_STEPS), "--save-every", str(RES_SAVE_EVERY),
        "--dropout", str(RES_DROPOUT), "--slow-s", str(RES_SLOW_S)])
    for leg in legs.split(","):
        check("leg %s OK" % leg in out, "25d: 'leg %s OK' missing" % leg)
    stats["legs_s"]["clean " + legs] = stats["legs_s"].pop("clean")
    return stats, wall, out


def phase_resilience(torch, np, dev, card):
    """Phase 25 (module docstring). Returns the K4a-b launches of the
    phase's paths and a summary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.tools.chaos_train import ELASTIC_RTOL
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    tmp = tempfile.mkdtemp(prefix="mxtt_phase25_")
    summary = {"card": card}
    launches = {}
    try:
        summary["25a"] = res_inproc(torch, np, mx, fr, dev, tmp)
        launches["25a"] = tuple(summary["25a"]["k4_launches"])
        print("resilience 25a (%s): %s" % (card, json.dumps(summary["25a"])))
        sys.stdout.flush()
        # 25b, 25c and 25d's campaign share nothing but the card: run
        # them at once (their leg times then include each other's load;
        # 25a's save and restore times above are the phase's unloaded
        # readings). Leg A's straggler flag compares the slow host's
        # step times with the pod's median, a healthy host's, so the
        # load slows both sides of the ratio and flags no healthy host
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(3) as pool:
            b = pool.submit(res_drill, "25b", dev, [
                "--steps", str(RES_DRILL_STEPS),
                "--save-every", str(RES_SAVE_EVERY),
                "--dropout", str(RES_DROPOUT)])
            c = pool.submit(res_pod_drill, dev)
            d = pool.submit(res_supervised, dev, "A,B,C")
            runs = {"25b": b.result(), "25c": c.result(),
                    "25d": d.result()}
        for leg, what in (("25b", "drill"), ("25c", "pod drill"),
                          ("25d", "supervised")):
            stats, wall, _ = runs[leg]
            summary[leg] = dict(stats, wall_s=wall)
            print("resilience %s %s (%s): %s"
                  % (leg, what, card, json.dumps(summary[leg])))
        summary["25c"]["elastic_rtol"] = ELASTIC_RTOL
        sys.stdout.flush()
        for leg in ("25b", "25c", "25d"):
            launches[leg] = tuple(summary[leg]["k4_launches"])
            # one K4a and one K4b launch a layer for each step and SDC
            # probe the drill's finishing workers ran (on the CPU the
            # plain versions run and launch nothing)
            want = tuple(summary[leg]["k4_expected"])
            check(launches[leg] == want and want[0] > 0
                  or dev.type == "cpu",
                  "phase %s: K4a/K4b launched %r, the workers' steps and "
                  "probes call for %r" % (leg, launches[leg], want))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    total = tuple(sum(v[i] for v in launches.values()) for i in (0, 1))
    summary["k4_launches"] = {k: list(v) for k, v in launches.items()}
    return total, summary


#: phase 26: ROADMAP item 12's serving side at phase 4's width on K1,
#: random weights from seed 26 (ROLL_SEED). 26a: a live rollout on
#: serve(replicas=2, rollout=) under a stream of ROLL_CLIENTS clients
#: (prompts and new tokens drawn in ROLL_PROMPT / ROLL_GEN); its
#: checkpoints come seconds apart (a training run publishes hours apart).
#: The judge reads a canary's TTFT burn, and a first token is seen only
#: once it lands, so the objective, the slow canary's sleep and the stage
#: window come from the healthy fleet's own first tokens, timed before
#: step 1 (ROLL_CALIBRATE requests): the objective ROLL_TTFT_FACTOR x
#: their largest TTFT, the slow canary's sleep ROLL_SLOW_FACTOR x the
#: objective an iteration (every first token it serves breaks it), and
#: the window ROLL_WINDOW_S (MXNET_ROLLOUT_WINDOW_S) unless a slow
#: canary's first token, placed half a second into stage 0 and taking
#: 1 + ROLL_PROMPT[1] / chunk slow iterations, would land after the
#: second window: then long enough for it to land by then. The SLO's
#: burn window spans three stage windows. 26b: tp engines over the
#: emulated windows [cuda:0] * k (TP_DEGREES) against the tp=1 paged
#: engine, TP_PROMPTS prompts of PROMPT_LEN tokens and TP_STEPS decode
#: steps; 26c: the tp != tp migration hop.
ROLL_SEED = 26
ROLL_NOISE = 0.002
ROLL_WINDOW_S = "0.5"
ROLL_INTERVAL_S = 0.25
ROLL_CLIENTS = 4
ROLL_REQUESTS = 24
ROLL_PROMPT = (32, 128)
ROLL_GEN = (16, 64)
ROLL_CALIBRATE = 12
ROLL_TTFT_FACTOR = 8.0
ROLL_TTFT_FLOOR_S = 0.05
ROLL_SLOW_FACTOR = 1.5
ROLL_PINNED = 4
ROLL_PINNED_GEN = 16
#: the first positional row no pinned parity prompt reaches (4 prompts
#: of at most 7 tokens plus 6 decoded)
ROLL_UNPROBED = 32
ROLL_WAIT_S = 120
TP_DEGREES = (2, 4)
TP_PROMPTS = 8
TP_STEPS = 64
TP_RTOL, TP_ATOL = 1e-4, 1e-5
#: the JAX reference's own int8 tp=2 engine (int8 KV + int8 weights,
#: block 32) against its int8 tp=1 engine, teacher-forced over GEN
#: tokens of one PROMPT_LEN prompt at this config's width:
#: tools/quant_logit_probe.py --impl reference --tp 2 (CPU, 2 virtual
#: devices). 26b holds the port's int8 tp=2 engine to twice that against
#: its int8 tp=1 engine; the shards' own scales are checked apart.
REF_TP_QUANT_LOGIT_ERR = 0.05504
TP_QUANT_BOUND = 2 * REF_TP_QUANT_LOGIT_ERR


def roll_tree(np, base, step):
    """Step `step`'s published weights: step 0's (the fleet's boot
    weights) plus N(0, ROLL_NOISE) noise drawn from the step."""
    rng = np.random.RandomState(ROLL_SEED * 1000 + step)
    return {k: (v + ROLL_NOISE * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in base.items()}


def roll_publish(directory, step, tree, hosts=1, only=None):
    """Publish `tree` at `step` as a sharded checkpoint of an emulated
    pod of `hosts` writers (the port's CheckpointManager): every host
    writes its shard file and sidecar, host 0 the global manifest last.
    `only` writes just that host's part."""
    from mxnet_tpu_torch.utils.recovery import CheckpointManager
    for i in (reversed(range(hosts)) if only is None else (only,)):
        CheckpointManager(directory, keep=0, async_save=False,
                          sharded=True, process_index=i,
                          process_count=hosts).save(step, tree)


class RolloutLog:
    """The controller's transitions and gates, timed: its `step` and
    `_gate` are wrapped on the instance, so the watcher thread's own
    calls are recorded."""

    def __init__(self, ro):
        self.t0 = time.perf_counter()
        self.passes = 0
        self.events = []
        self.gates = []
        self.spawned = []
        self.judged = []
        step, gate, spawn = ro.step, ro._gate, ro._spawn_canary
        judge = ro.judge

        def logged_step(now=None):
            out = step(now)
            self.passes += 1
            if out in ("rejected", "rollback"):
                which = ro.last_rejection["step"]
            elif out == "promoted":
                which = ro.last_promotion["step"]
            else:
                which = ro.candidate
            if out:
                self.events.append((round(time.perf_counter() - self.t0, 3),
                                    out, which))
            return out

        def timed_gate(s, now):
            t = time.perf_counter()
            try:
                return gate(s, now)
            finally:
                self.gates.append((int(s), 1e3 * (time.perf_counter() - t)))

        def spawn_canary(s, model, now):
            self.spawned.append(int(s))
            return spawn(s, model, now)

        def logged_judge():
            ok = judge()
            self.judged.append((round(time.perf_counter() - self.t0, 3),
                                ro.candidate, ro.stage,
                                round(ro.canary_burn(), 3), ok))
            return ok

        ro.step, ro._gate, ro._spawn_canary, ro.judge = (
            logged_step, timed_gate, spawn_canary, logged_judge)

    def seen(self, what, step):
        return any(e[1] == what and e[2] == step for e in self.events)

    def transitions(self, step):
        return [e[1] for e in self.events if e[2] == step]


def roll_pinned(srv, cfg):
    from mxnet_tpu_torch.serving.rollout import pinned_prompts
    return [srv.generate(p, max_new_tokens=ROLL_PINNED_GEN,
                         timeout=ROLL_WAIT_S)
            for p in pinned_prompts(cfg.vocab, ROLL_PINNED, cfg.max_len)]


def roll_calibrate(srv, work):
    """The healthy fleet's largest TTFT over ROLL_CALIBRATE requests
    from ROLL_CLIENTS threads, and the objective (s), the slow canary's
    sleep (s), the stage window (s) and the SLO burn window (s) derived
    from it (the constants' comment above). A first round warms the
    replicas' threads."""
    fleet_clients(srv, work[:ROLL_CLIENTS], ROLL_CLIENTS)
    _, reqs, errors, _ = fleet_clients(srv, work[:ROLL_CALIBRATE],
                                       ROLL_CLIENTS)
    check(not errors, "26a: the healthy fleet failed requests: %r"
          % errors[:4])
    healthy = max(r.t_first_token - r.t_submit for r in reqs)
    ttft = max(ROLL_TTFT_FLOOR_S, ROLL_TTFT_FACTOR * healthy)
    slow = ROLL_SLOW_FACTOR * ttft
    chunks = -(-ROLL_PROMPT[1] // srv.replicas[0].engine.prefill_chunk)
    window = max(float(ROLL_WINDOW_S), (0.5 + slow * (1 + chunks)) / 2)
    return healthy, ttft, slow, window, math.ceil(3 * window)


def phase_rollout(torch, np, serving, pa, cfg, base, dev, tmp, card):
    """26a (module docstring); prints its line before its checks. Returns
    (K1 launches, summary)."""
    from mxnet_tpu_torch.models import params_from_numpy
    from mxnet_tpu_torch.utils import chaos
    rng = np.random.RandomState(ROLL_SEED)
    work = fleet_work(np, rng, ROLL_REQUESTS, ROLL_PROMPT, ROLL_GEN,
                      cfg.vocab)
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256,
              device=dev)
    ckpt = os.path.join(tmp, "ckpts")
    env = {k: os.environ.get(k) for k in (
        "MXNET_ROLLOUT_WINDOW_S", "MXNET_SLO_TTFT_MS", "MXNET_SLO_WINDOWS")}
    os.environ["MXNET_ROLLOUT_WINDOW_S"] = ROLL_WINDOW_S
    srv = None
    stop = threading.Event()
    stream = {}
    try:
        srv = serving.serve((params_from_numpy(base, cfg, dev), cfg),
                            replicas=2, rollout=ckpt, **kw)
        ro = srv.rollout
        ro.interval_s = ROLL_INTERVAL_S
        log = RolloutLog(ro)
        host, port = srv.serve_http(port=0, block=False)
        pa.paged_attention.launches = 0
        # the objective and the windows, read by the canaries built from
        # here on (an SLO is read when a replica's metrics are made)
        healthy, ttft, slow, ro.window_s, burn = roll_calibrate(srv, work)
        os.environ["MXNET_SLO_TTFT_MS"] = "%.1f" % (1e3 * ttft)
        os.environ["MXNET_SLO_WINDOWS"] = str(burn)

        def run_stream():
            stream["out"] = fleet_clients(srv, work, ROLL_CLIENTS, stop)
        client = threading.Thread(target=run_stream, daemon=True)
        client.start()
        # step 1: host 1's shard lands first; the step is incomplete and
        # the watcher passes over it
        roll_publish(ckpt, 1, roll_tree(np, base, 1), hosts=2, only=1)
        seen = log.passes
        wait_for(lambda: log.passes >= seen + 3, "3 watcher passes")
        check(ro.state == "idle" and ro.candidate is None
              and not ro.roster.steps(),
              "26a: an incomplete step was judged (state %r, roster %r)"
              % (ro.state, ro.roster.steps()))
        roll_publish(ckpt, 1, roll_tree(np, base, 1), hosts=2, only=0)
        wait_for(lambda: log.seen("promoted", 1), "step 1's promotion",
                 timeout=ROLL_WAIT_S)
        # step 2: bitrot after the publish, caught before any traffic
        chaos.configure(serve_rollout_corrupt=(2, 0))
        roll_publish(ckpt, 2, roll_tree(np, base, 2))
        wait_for(lambda: log.seen("rejected", 2), "step 2's quarantine",
                 timeout=ROLL_WAIT_S)
        rej2 = dict(ro.last_rejection or {})
        # step 3: a healthy-but-slow canary (it will be replica 2)
        chaos.configure(serve_rollout_slow_canary=(2, 1, slow))
        roll_publish(ckpt, 3, roll_tree(np, base, 3))
        wait_for(lambda: log.seen("rollback", 3) or log.seen("promoted", 3),
                 "step 3's verdict", timeout=ROLL_WAIT_S)
        rej3 = dict(ro.last_rejection or {})
        chaos.configure(serve_rollout_slow_canary=None)
        # step 4: the operator rolls it back through POST /v1/rollout
        roll_publish(ckpt, 4, roll_tree(np, base, 4))
        wait_for(lambda: ro.state == "staging" and ro.candidate == 4,
                 "step 4's canary", timeout=ROLL_WAIT_S)
        code, body, _ = http_json(
            "http://%s:%d/v1/rollout" % (host, port),
            {"cmd": "rollback", "reason": "operator drill"})
        check(code == 200 and body.get("candidate") == 4,
              "26a: POST /v1/rollout rollback answered %r %r" % (code, body))
        wait_for(lambda: log.seen("rollback", 4), "step 4's rollback",
                 timeout=ROLL_WAIT_S)
        # step 5: the serving weights with only positional rows past the
        # pinned probes' positions changed: the digest moves, every probe
        # output stays bit-identical, so the divergence probe rejects it
        tree5 = dict(roll_tree(np, base, 1))
        tree5["pos_embed"] = tree5["pos_embed"].copy()
        tree5["pos_embed"][ROLL_UNPROBED:] += ROLL_NOISE
        roll_publish(ckpt, 5, tree5)
        wait_for(lambda: log.seen("rejected", 5) or 5 in log.spawned,
                 "step 5's gate", timeout=ROLL_WAIT_S)
        rej5 = dict(ro.last_rejection or {})
        code, status, _ = http_json("http://%s:%d/v1/rollout" % (host, port),
                                    {"cmd": "status"})
        stop.set()
        client.join(timeout=10 * FLEET_WAIT_S)
        check(not client.is_alive(), "26a: the client stream never ended")
        launches = pa.paged_attention.launches
        pinned = roll_pinned(srv, cfg)
        versions, weights = list(srv._version), srv.weights_version
        n_reps = len(srv.replicas)
        tok = srv.statusz()["fleet"]["tokens"]
    finally:
        stop.set()
        chaos.configure(serve_rollout_corrupt=None,
                        serve_rollout_slow_canary=None)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if srv is not None:
            srv.close(timeout=FLEET_WAIT_S)
    results, reqs, errors, wall = stream["out"]
    # a request rehomed off a retired canary before its first token
    # stamps that token on its replay, not on itself
    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs
                   if r.t_first_token is not None)
    out = {"healthy_ttft_max_ms": 1e3 * healthy,
           "objective_ttft_ms": 1e3 * ttft, "slow_canary_sleep_s": slow,
           "window_s": ro.window_s, "slo_burn_window_s": burn,
           "transitions": log.events, "gate_ms": log.gates,
           "judged": log.judged, "canaries": log.spawned,
           "requests": len(reqs), "requests_lost_or_failed": len(errors),
           "wall_s": wall,
           "requests_without_own_first_token": len(reqs) - len(ttfts),
           "ttft_p50_ms": 1e3 * ttfts[len(ttfts) // 2],
           "ttft_p90_ms": 1e3 * ttfts[int(0.9 * (len(ttfts) - 1))],
           "ttft_max_ms": 1e3 * ttfts[-1], "k1_launches": launches,
           "rejections": {"2": rej2, "3": rej3, "5": rej5}}
    print("rollout 26a (%s): %s" % (card, json.dumps(out)))
    sys.stdout.flush()
    check(not errors, "26a: requests lost or failed: %r" % errors[:4])
    check(tok["failed"] == 0 and tok["submitted"] == tok["goodput"]
          + tok["slow"] + tok["shed"] + tok["expired"] + tok["failed"],
          "26a: token ledger %r" % tok)
    check(n_reps == 2 and weights == 1 and versions == [1, 1],
          "26a: fleet ends at %d replicas, versions %r, serving %r"
          % (n_reps, versions, weights))
    want1 = ["canary", "stage", "stage", "promoting", "promote_one",
             "promote_one", "promoted"]
    check(log.transitions(1) == want1,
          "26a: step 1 went %r, expected %r" % (log.transitions(1), want1))
    check(log.transitions(2) == ["rejected"] and 2 not in log.spawned
          and rej2.get("step") == 2 and rej2.get("probe") == "digest",
          "26a: step 2 went %r (spawned %r), rejection %r"
          % (log.transitions(2), log.spawned, rej2))
    check(log.transitions(3)[-1:] == ["rollback"]
          and "promoting" not in log.transitions(3)
          and rej3.get("probe") == "judge" and "%d consecutive bad "
          "windows" % ro.max_bad in rej3.get("detail", ""),
          "26a: step 3 went %r, rejection %r" % (log.transitions(3), rej3))
    check(log.transitions(4)[-1:] == ["rollback"]
          and (ro.roster.entry(4) or {}).get("reason") == "operator drill",
          "26a: step 4 went %r, roster %r"
          % (log.transitions(4), ro.roster.entry(4)))
    check(log.transitions(5) == ["rejected"] and 5 not in log.spawned
          and rej5.get("probe") == "divergence",
          "26a: step 5 went %r (spawned %r), rejection %r"
          % (log.transitions(5), log.spawned, rej5))
    check(code == 200 and status.get("rejected_steps") == [2, 3, 4, 5]
          and status.get("incumbent") == 1,
          "26a: /v1/rollout status %r %r" % (code, status))
    check(launches > 0, "26a: K1 never launched")
    fresh = serving.serve((params_from_numpy(roll_tree(np, base, 1), cfg,
                                             dev), cfg), **kw)
    try:
        want = roll_pinned(fresh, cfg)
    finally:
        fresh.close(timeout=FLEET_WAIT_S)
    check(pinned == want, "26a: the promoted fleet's greedy tokens on the "
          "pinned prompts differ from a fresh server on step 1's weights")
    out["pinned_tokens_equal_fresh_server"] = True
    return launches, out


def tp_drive(torch, np, eng, prompts, steps):
    """Prefill every prompt, then `steps` batched decode steps on `eng`
    (keep_logits). Returns (greedy tokens, logit rows per request,
    prefill chunks, decode-step ms)."""
    seqs = [eng.start(list(p), max_new=steps + 1) for p in prompts]
    chunks = sum(-(-len(p) // eng.prefill_chunk) for p in prompts)
    rows = [[np.asarray(s.last_logits)] for s in seqs]
    sync = torch.cuda.synchronize if eng.device.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode_step(seqs)
        for r, s in zip(rows, seqs):
            r.append(np.asarray(s.last_logits))
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    toks = [list(s.generated) for s in seqs]
    for s in seqs:
        eng.release(s)
    eng.close()
    return toks, rows, chunks, ms


def tp_compare(np, what, got, ref):
    """tp logits `got` against the tp=1 engine's `ref` (tp_drive's
    tokens and rows): every row within TP_RTOL / TP_ATOL and every greedy
    token equal, a request's comparison ending at a near-tie (top-2
    margin under MARGIN) whose pick differs. Returns (largest |error|,
    rows compared, near-ties)."""
    err, n, ties = 0.0, 0, 0
    for i, (toks, rows) in enumerate(zip(*got)):
        for t, (a, b) in enumerate(zip(rows, ref[1][i])):
            bad = np.abs(a - b) > TP_ATOL + TP_RTOL * np.abs(b)
            check(not bad.any(), "%s: request %d row %d: |logit - tp=1| "
                  "%.3g over rtol %g / atol %g"
                  % (what, i, t, float(np.abs(a - b).max()), TP_RTOL,
                     TP_ATOL))
            err = max(err, float(np.abs(a - b).max()))
            n += 1
            if toks[t] != ref[0][i][t]:
                top2 = np.partition(b, -2)[-2:]
                check(top2[1] - top2[0] < MARGIN,
                      "%s: request %d token %d: %d != tp=1's %d"
                      % (what, i, t, toks[t], ref[0][i][t]))
                ties += 1
                break
    return err, n, ties


def tp_pool_check(torch, eng, cfg, k, dev):
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    for name, plane in (("k", eng.cache.k), ("v", eng.cache.v)):
        check(len(plane) == k, "26b: %d %s pool shards at tp=%d"
              % (len(plane), name, k))
        for t in plane:
            check(tuple(t.shape) == (cfg.n_layers, eng.cache.num_blocks,
                                     eng.cache.block_size, H // k, Dh)
                  and t.device == dev and t.is_contiguous(),
                  "26b: a tp=%d %s pool shard is %s on %s (contiguous %s)"
                  % (k, name, tuple(t.shape), t.device, t.is_contiguous()))


def tp_scale_check(torch, eng, cfg):
    """Every row-parallel shard's int8 scales are its own rows' (the
    shard's f32 block's per-column amax / 127), and each column-parallel
    shard's are its columns'."""
    from mxnet_tpu_torch.ops.quantization import int8_scale
    from mxnet_tpu_torch.serving import tp as ttp
    f32 = ttp.place_tp_params(eng.model.params_f32, cfg, eng.mesh)
    for i in range(cfg.n_layers):
        for name in ("wqkv", "wo", "w1", "w2"):
            key = "layer%d_%s" % (i, name)
            for j, sh in enumerate(eng.model.tp_params):
                want = int8_scale(f32[j][key].float().abs().amax(0))
                check(torch.equal(sh[key]["s"], want),
                      "26b: shard %d's %s scales are not its own block's"
                      % (j, key))


def phase_tp(torch, np, serving, pa, cfg, params, dev, card):
    """26b (module docstring). Returns (K1 float launches, K1 int8
    launches, summary)."""
    rng = np.random.RandomState(ROLL_SEED + 1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, PROMPT_LEN)]
               for _ in range(TP_PROMPTS)]
    ekw = dict(max_batch=8, block_size=16, paged=True, keep_logits=True,
               device=dev)
    out = {"card": card}
    ref = tp_drive(torch, np, serving.Engine(
        serving.TransformerLM(params, cfg), **ekw), prompts, TP_STEPS)
    out["step_ms"] = {"1": ref[3]}
    float_launches = 0
    for k in TP_DEGREES:
        eng = serving.Engine(serving.TransformerLM(params, cfg), tp=k,
                             devices=[dev] * k, **ekw)
        check(eng.tp == k, "26b: tp=%d fell back: %s" % (k, eng.tp_fallback))
        tp_pool_check(torch, eng, cfg, k, dev)
        pa.paged_attention.launches = 0
        got = tp_drive(torch, np, eng, prompts, TP_STEPS)
        launches = pa.paged_attention.launches
        want = cfg.n_layers * k * (got[2] + TP_STEPS)
        check(launches == want, "26b: tp=%d launched K1 %d times, expected "
              "layers x shards x (chunks + steps) = %d x %d x (%d + %d) = %d"
              % (k, launches, cfg.n_layers, k, got[2], TP_STEPS, want))
        float_launches += launches
        err, rows, ties = tp_compare(np, "26b tp=%d" % k, got[:2], ref[:2])
        out["tp%d" % k] = {"max_abs_err_vs_tp1": err, "rows_compared": rows,
                           "near_ties": ties, "k1_launches": launches,
                           "tp_cache_variant": serving.tp_cache_variant(
                               eng.mesh)}
        out["step_ms"][str(k)] = got[3]
    # int8 weights over an int8 pool, block 32, teacher-forced against
    # the int8 tp=1 engine on the probe tool's weights and prompt (phase
    # 4's, tools/quant_logit_probe.py)
    p4 = phase4_params(np, cfg, dev)
    rng = np.random.RandomState(1)
    p4_prompts = [[int(t) for t in rng.randint(1, cfg.vocab, PROMPT_LEN)]
                  for _ in range(N_REQ)]
    base_toks, base_rows = quant_logit_rows(np, serving, p4, cfg,
                                            p4_prompts[0], GEN, dev)
    qeng = serving.Engine(serving.TransformerLM(p4, cfg), tp=2,
                          devices=[dev] * 2, max_batch=8,
                          block_size=QUANT_BLOCK, paged=True,
                          kv_quant=True, weight_quant="int8", device=dev)
    check(qeng.tp == 2 and qeng.kv_quant, "26b: the int8 tp engine fell "
          "back: %s" % qeng.tp_fallback)
    tp_pool_check(torch, qeng, cfg, 2, dev)
    tp_scale_check(torch, qeng, cfg)
    qeng.close()
    pa.paged_attention.launches_int8 = 0
    qerr, qrows, qagree = quant_logit_probe(
        np, serving, p4, cfg, p4_prompts[0], GEN, dev, base_toks,
        base_rows, tp=2)
    int8_launches = pa.paged_attention.launches_int8
    qwant = cfg.n_layers * 2 * (-(-PROMPT_LEN // (2 * QUANT_BLOCK))
                                + GEN - 1)
    check(int8_launches == qwant, "26b: the int8 tp engine launched K1 "
          "%d times, expected %d" % (int8_launches, qwant))
    check(qerr <= TP_QUANT_BOUND, "26b: int8 tp=2 is %.4g off int8 tp=1, "
          "over twice the reference's own %.4g"
          % (qerr, REF_TP_QUANT_LOGIT_ERR))
    out["int8_tp2"] = {"max_abs_err_vs_int8_tp1": qerr, "rows": qrows,
                       "argmax_equal": qagree, "bound": TP_QUANT_BOUND,
                       "k1_int8_launches": int8_launches}
    # the server at phase 4's config, weights and requests, tp=2
    ref4, margins = gather_oracle(torch, np, serving, p4, cfg, p4_prompts,
                                  GEN, dev)
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256,
              tp=2, devices=[dev] * 2)
    outs, wall, (launches, _), snap, _, eng = serve_traffic(
        serving, pa, p4, cfg, p4_prompts, GEN, kw)
    check(eng.tp == 2, "26b: the tp server fell back: %s" % eng.tp_fallback)
    paths = snap["paths"]
    want = cfg.n_layers * 2 * (paths["paged_decode_steps"]
                               + paths["prefill_chunks"])
    check(launches == want, "26b: the tp=2 server launched K1 %d times, "
          "expected %d" % (launches, want))
    float_launches += launches
    n = compare_tokens("26b tp=2 server", outs, ref4, margins, quiet=True)
    out["server_tp2"] = {"tokens_compared": n, "wall_s": wall,
                         "decode_step_mean_ms": decode_step_mean_ms(snap),
                         "k1_launches": launches}
    # no window on this machine: tp=2 serves at tp=1, on K1
    from mxnet_tpu_torch.serving.tp import serving_devices
    have = len(serving_devices()) if dev.type == "cuda" else 0
    eng = serving.Engine(serving.TransformerLM(params, cfg), tp=2,
                         max_batch=8, block_size=16, device=dev)
    if have < 2:
        check(eng.tp == 1 and eng.tp_fallback
              == "tp=2 needs 2 devices, have %d" % have,
              "26b: tp=2 without a window: tp %d, %r"
              % (eng.tp, eng.tp_fallback))
    pa.paged_attention.launches = 0
    seq = eng.start(prompts[0], max_new=4)
    while not seq.done:
        eng.decode_step([seq])
    eng.release(seq)
    eng.close()
    fb = pa.paged_attention.launches
    check(fb > 0 or dev.type == "cpu", "26b: the fallback never ran K1")
    float_launches += fb
    out["fallback"] = {"tp": eng.tp, "reason": eng.tp_fallback,
                       "k1_launches": fb}
    return float_launches, int8_launches, out


def phase4_params(np, cfg, dev):
    """Phase 4's weights (bench_params, seed 0) on `dev`."""
    from mxnet_tpu_torch.models import params_from_numpy
    return params_from_numpy(bench_params(np, cfg), cfg, dev)


def phase_tp_hop(torch, np, serving, pa, cfg, dev):
    """26c: prefill:1,decode:1 with the decode role at tp=2 on the
    emulated window; its greedy tokens against one server's (the gather
    oracle, as phase 4's). Returns (K1 launches, summary)."""
    p4 = phase4_params(np, cfg, dev)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, PROMPT_LEN)]
               for _ in range(4)]
    ref, margins = gather_oracle(torch, np, serving, p4, cfg, prompts, GEN,
                                 dev)
    srv = serving.serve((p4, cfg), roles="prefill:1,decode:1",
                        role_kwargs={"decode": {"tp": 2,
                                                "devices": [dev] * 2}},
                        max_batch=8, paged=True, block_size=16, device=dev)
    try:
        pre, dec = srv.replicas
        check(pre.engine.tp == 1 and dec.engine.tp == 2,
              "26c: replicas at tp %d / %d (%s)" % (
                  pre.engine.tp, dec.engine.tp, dec.engine.tp_fallback))
        pa.paged_attention.launches = 0
        outs = [r.result(timeout=FLEET_WAIT_S) for r in
                [srv.submit(list(p), max_new_tokens=GEN) for p in prompts]]
        launches = pa.paged_attention.launches
        hops = dec.metrics.migrations
        snaps = [r.snapshot() for r in srv.replicas]
    finally:
        srv.close(timeout=FLEET_WAIT_S)
    check(hops == len(prompts), "26c: %d of %d requests hopped"
          % (hops, len(prompts)))
    want = cfg.n_layers * sum(
        tp * (s["paths"]["paged_decode_steps"] + s["paths"]["prefill_chunks"])
        for tp, s in zip((1, 2), snaps))
    check(launches == want, "26c: K1 launched %d times, expected %d"
          % (launches, want))
    n = compare_tokens("26c", outs, ref, margins, quiet=True)
    return launches, {"migrations": hops, "tokens_compared": n,
                      "k1_launches": launches}


def phase_tp_rollout(torch, np, dev, card):
    """Phase 26: live rollout (a), tp on an emulated window (b), the
    tp != tp hop (c), at phase 4's width on K1 (module docstring).
    Returns (K1 float launches, K1 int8 launches, summary)."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    base = bench_params(np, cfg, seed=ROLL_SEED)
    out = {"card": card}
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxtt_phase26_")
    try:
        a, out["26a"] = phase_rollout(torch, np, serving, pa, cfg, base, dev,
                                      tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["26a"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = params_from_numpy(base, cfg, dev)
    b, b8, out["26b"] = phase_tp(torch, np, serving, pa, cfg, params, dev,
                                 card)
    out["26b"]["s"] = time.perf_counter() - t0
    print("tp 26b (%s): %s" % (card, json.dumps(out["26b"])))
    sys.stdout.flush()
    t0 = time.perf_counter()
    c, out["26c"] = phase_tp_hop(torch, np, serving, pa, cfg, dev)
    out["26c"]["s"] = time.perf_counter() - t0
    print("tp hop 26c (%s): %s" % (card, json.dumps(out["26c"])))
    out["k1_launches"] = {"26a": a, "26b": b, "26c": c, "26b_int8": b8}
    return a + b + c, b8, out


# ---------------------------------------------------------------------------
# phase 27: BASELINE config 4, SSDLite on the multibox ops (ROADMAP item 13)
# ---------------------------------------------------------------------------

#: bench.py's non-smoke bench_ssd_forward width: SSDLite(num_classes=20)
#: at batch 32 of 3 x 256 x 256 (4032 anchors: 256 / 4 = 64, then 32, 16,
#: 8 cells a side, 3 anchors a cell); examples/train_ssd.py's loss and
#: Adam at lr 0.005; 1-4 boxes an image; seed 27
SSD_SEED = 27
SSD_BATCH, SSD_IMAGE, SSD_CLASSES = 32, 256, 20
#: the three feature maps' sides (after the stem's two pools and each
#: block's stride 2) and their sizes, 3 anchors a cell
SSD_MAPS = ((8, 0.2), (16, 0.4), (32, 0.7))
SSD_MAX_BOXES = 4
SSD_LR = 0.005
SSD_WARMUP, SSD_STEPS = 2, 10
SSD_FORWARD_STEPS = 20
#: 27b: bf16 class scores against float32 (relative Frobenius)
SSD_BF16_TOL = 5e-2
#: 27c: examples/train_ssd.py at its own size: 64 images of 48 x 48,
#: 2 classes, batch 16, 12 epochs
SSD_EX_IMAGES, SSD_EX_SIZE, SSD_EX_BATCH, SSD_EX_EPOCHS = 64, 48, 16, 12
#: 27d's sizes: a detection batch of 8 at the full 4032 anchors, the RPN
#: on a 24 x 24 map (6912 anchors, 2000 before NMS, 300 after), CTC at
#: T 50, N 16, C 20, L 10
SSD_OP_DET_BATCH = 8
SSD_OP_MEAN = (123.68, 116.28, 103.53)
SSD_OP_STD = (58.395, 57.12, 57.375)


def ssd_anchor_count():
    return 3 * sum((SSD_IMAGE // f) ** 2 for f, _ in SSD_MAPS)


def ssd_batch(np, rs, n, size, classes, max_boxes):
    """n images uniform in [-1, 1) and their labels [n, max_boxes, 5]:
    1..max_boxes boxes (class, x1, y1, x2, y2) an image, -1 rows after."""
    x = rs.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    lab = -np.ones((n, max_boxes, 5), np.float32)
    for i in range(n):
        for j in range(rs.randint(1, max_boxes + 1)):
            w, h = rs.uniform(0.1, 0.6, 2)
            x0, y0 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            lab[i, j] = [rs.randint(classes), x0, y0, x0 + w, y0 + h]
    return x, lab


class SSDGrads:
    """`loss_and_grads(x, y)` of SSDLite at fixed starting weights: one
    recorded forward of examples/train_ssd.py's loss against targets
    computed once, from the first flag-off training forward, and its
    backward; then the parameters (moving statistics too) are put back.
    Fixed targets keep a hard-negative rank that a last-bit change of the
    class scores would move out of the comparison of the two BatchNorm
    paths (`mining_moves` counts such moves). Lets
    resnet_first_step_check hold the SSD step."""

    def __init__(self, mx, net, ssd_loss, x, y):
        self.mx, self.net, self.ssd_loss = mx, net, ssd_loss
        self.params = net.collect_params()
        self.start = {n: p.data()._data.clone()
                      for n, p in self.params.items()}
        self.y = y
        self.targets = self.fresh_targets(x)

    def fresh_targets(self, x):
        mx = self.mx
        with mx.autograd.record():
            anchors, cls_preds, _ = self.net(mx.nd.NDArray(x))
        targets = self.net.targets(anchors, mx.nd.NDArray(self.y), cls_preds)
        self.restore()
        return targets

    def restore(self):
        for n, p in self.params.items():
            p.set_data(self.start[n].clone())

    def loss_and_grads(self, x, y):
        mx = self.mx
        with mx.autograd.record():
            _, cls_preds, loc_preds = self.net(mx.nd.NDArray(x))
            loss = self.ssd_loss(cls_preds, loc_preds, *self.targets)
        loss.backward()
        grads = {n: p.grad()._data.clone() for n, p in self.params.items()
                 if p.grad_req != "null"}
        self.restore()
        return loss._data.detach(), grads


def nms_violations(torch, probs, det, nms_threshold, threshold=0.01):
    """Rows of MultiBoxDetection's output `det` [N, A, 6] (clip on,
    background 0, per-class NMS) that greedy NMS would not give: from
    probs [N, C, A] the score order and each anchor's class, then row i
    must be kept exactly when its class is not background, its score is
    above threshold, and no kept row before it of its class overlaps it
    by more than nms_threshold (IoU of the output boxes). Vectorised on
    the card, no loop: an oracle of the op's sequential scan."""
    from mxnet_tpu_torch.ops.contrib import _iou_corner
    score, cls_id = probs.amax(dim=1), probs.argmax(dim=1)
    valid = (cls_id != 0) & (score > threshold)
    order = torch.argsort(-torch.where(valid, score, torch.zeros_like(
        score)), dim=1, stable=True)
    scls = torch.where(valid, cls_id - 1, -1).gather(1, order)
    kept = det[..., 0] >= 0
    A = det.shape[1]
    earlier = torch.ones(A, A, dtype=torch.bool,
                         device=det.device).tril(-1)          # j < i
    hit = (_iou_corner(det[..., 2:], det[..., 2:]) > nms_threshold) \
        & (scls[:, :, None] == scls[:, None, :]) & kept[:, None, :] \
        & earlier
    want = (scls >= 0) & ~hit.any(dim=2)
    wrong_cls = kept & (det[..., 0] != scls)
    return int((want != kept).sum()) + int(wrong_cls.sum())


def ssd_train(mx, net, trainer, ssd_loss, x, y, batch):
    """One step of examples/train_ssd.py: forward, targets, loss,
    backward, Adam; the loss NDArray."""
    with mx.autograd.record():
        anchors, cls_preds, loc_preds = net(x)
        loc_t, loc_m, cls_t = net.targets(anchors, y, cls_preds)
        loss = ssd_loss(cls_preds, loc_preds, loc_t, loc_m, cls_t)
    loss.backward()
    trainer.step(batch)
    return loss


def phase_ssd_train(torch, np, mx, fb, dev, card, module):
    """27a: SSDLite at bench width trained through gluon with the flag
    on: the first step against the flag off beside the floor, warm-up and
    timed steps with K3a-d launched once a BatchNorm a step, a profiled
    step. Returns (the net, the batch, K3a-d launches, summary)."""
    mx.random.seed(SSD_SEED)
    np.random.seed(SSD_SEED)
    net = module.SSDLite(num_classes=SSD_CLASSES)
    net.initialize(mx.init.Xavier())
    rs = np.random.RandomState(SSD_SEED)
    xs, ys = ssd_batch(np, rs, SSD_BATCH, SSD_IMAGE, SSD_CLASSES,
                       SSD_MAX_BOXES)
    x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    net(mx.nd.NDArray(x[:1]))
    n_bn = sum(1 for n in net.collect_params() if n.endswith("_gamma"))
    check(n_bn == 5, "SSDLite has %d BatchNorms, not 5" % n_bn)
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "0"
    grads = SSDGrads(mx, net, module.ssd_loss, x, y)
    oracle = resnet_first_step_check(torch, fb, grads, x, y, "ssdlite")
    # the targets themselves: positives (matching alone) identical with
    # the flag on, negatives mined from the flag-on scores counted
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    on = grads.fresh_targets(x)
    off = grads.targets
    pos_on, pos_off = on[2]._data > 0, off[2]._data > 0
    check(torch.equal(pos_on, pos_off) and torch.equal(
        on[1]._data, off[1]._data), "the positive anchors moved with the "
          "BatchNorm path")
    check(bool((on[0]._data - off[0]._data).abs().max() == 0),
          "the loc targets moved with the BatchNorm path")
    oracle["mining_moves"] = int((on[2]._data != off[2]._data).sum())
    oracle["positives"] = int(pos_off.sum())

    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": SSD_LR})
    xn, yn = mx.nd.NDArray(x), mx.nd.NDArray(y)
    fb.reset_launch_counts()
    losses = [float(ssd_train(mx, net, trainer, module.ssd_loss, xn, yn,
                              SSD_BATCH).asnumpy())
              for _ in range(SSD_WARMUP)]
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(SSD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ssd_train(mx, net, trainer, module.ssd_loss, xn, yn,
                         SSD_BATCH)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.asnumpy()))
    peak = torch.cuda.max_memory_allocated(dev)
    launches = fb.launch_counts()
    steps = SSD_WARMUP + SSD_STEPS
    check(launches == (5 * steps,) * 4,
          "K3a-d launched %r times over %d SSD steps, expected 5 x %d = %d "
          "each" % (launches, steps, steps, 5 * steps))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "SSD losses not finite or not falling: %r" % losses)
    prof = profile_step(torch, "ssdlite train", lambda: ssd_train(
        mx, net, trainer, module.ssd_loss, xn, yn, SSD_BATCH)._data)
    ms = sorted(1e3 * t for t in times)
    mean_ms = sum(ms) / len(ms)
    out = {"card": card, "batch": SSD_BATCH, "image": SSD_IMAGE,
           "classes": SSD_CLASSES, "anchors": ssd_anchor_count(),
           "steps_timed": SSD_STEPS, "step_ms_mean": mean_ms,
           "step_ms_p50": float(np.median(ms)),
           "img_per_s": SSD_BATCH / (mean_ms / 1e3),
           "loss_first": losses[0], "loss_last": losses[-1],
           "max_memory_allocated": peak, "first_step_float32": oracle,
           "k3_launches": dict(zip(("stats", "apply", "bwd_reduce",
                                    "bwd_dx"), launches)),
           "profile": prof}
    print("ssd 27a train (%s): %s" % (card, json.dumps(out)))
    return net, (x, y), launches, out


def phase_ssd_infer(torch, np, mx, dev, card, module, batch):
    """27b: a freshly initialized SSDLite's inference forward in float32
    and bfloat16, as bench.py's bench_ssd_forward runs it (img/s, bf16
    class scores near float32's), then MultiBoxTarget and
    MultiBoxDetection on the card at the full batch on its predictions
    (untrained, so most anchors are candidates and NMS has work): targets
    with hard mining, detections well formed and every row what greedy
    NMS gives (nms_violations), each op's ms."""
    x, y = batch
    xn = mx.nd.NDArray(x)
    mx.random.seed(SSD_SEED)
    net = module.SSDLite(num_classes=SSD_CLASSES)
    net.initialize(mx.init.Xavier())
    net(mx.nd.NDArray(x[:1]))

    def forward_rate(model, inp):
        for _ in range(3):
            outs = model(inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SSD_FORWARD_STEPS):
            outs = model(inp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return outs, SSD_BATCH * SSD_FORWARD_STEPS / dt

    A = ssd_anchor_count()
    (anchors, cls_preds, loc_preds), f32_rate = forward_rate(net, xn)
    check(tuple(anchors.shape) == (1, A, 4)
          and tuple(cls_preds.shape) == (SSD_BATCH, SSD_CLASSES + 1, A)
          and tuple(loc_preds.shape) == (SSD_BATCH, 4 * A),
          "SSD forward shapes %s %s %s" % (anchors.shape, cls_preds.shape,
                                           loc_preds.shape))
    net16 = module.SSDLite(num_classes=SSD_CLASSES)
    net16.initialize(mx.init.Xavier())
    net16(mx.nd.NDArray(x[:1]))
    for p16, p in zip(net16.collect_params().values(),
                      net.collect_params().values()):
        p16.set_data(p.data()._data.clone())
    net16.cast("bfloat16")
    (_, cls16, _), bf16_rate = forward_rate(
        net16, mx.nd.NDArray(x.to(torch.bfloat16)))
    bf16_err = rel_frobenius(cls16._data.float(), cls_preds._data)
    check(bool(torch.isfinite(cls16._data).all())
          and bf16_err <= SSD_BF16_TOL,
          "bf16 SSD class scores %.3g from float32 (> %g)"
          % (bf16_err, SSD_BF16_TOL))
    yn = mx.nd.NDArray(y)
    loc_t, loc_m, cls_t = net.targets(anchors, yn, cls_preds)
    npos = int((cls_t._data > 0).sum())
    nneg = int((cls_t._data == 0).sum())
    check(npos > 0 and 0 < nneg <= 3 * npos and
          bool((loc_m._data.reshape(SSD_BATCH, -1, 4)[..., 0] > 0).eq(
              cls_t._data > 0).all()),
          "MultiBoxTarget: %d positives, %d mined negatives" % (npos, nneg))
    target_ms = time_ms(torch, lambda: net.targets(anchors, yn, cls_preds),
                        n=5, sleep=False)
    probs = mx.nd.softmax(cls_preds, axis=1)
    det = net.detect(cls_preds, loc_preds, anchors)
    d = det._data
    check(tuple(d.shape) == (SSD_BATCH, A, 6)
          and bool(((d[..., 0] >= -1) & (d[..., 0] < SSD_CLASSES)).all())
          and bool(((d[..., 2:] >= 0) & (d[..., 2:] <= 1)).all())
          and bool(((d[..., 1] >= 0) & (d[..., 1] <= 1)).all()),
          "MultiBoxDetection's rows are not well formed")
    bad = nms_violations(torch, probs._data, d, 0.45)
    kept = int((d[..., 0] >= 0).sum())
    check(bad == 0 and kept > 0, "MultiBoxDetection: %d rows differ from "
          "greedy NMS (%d kept)" % (bad, kept))
    detect_ms = time_ms(torch, lambda: net.detect(cls_preds, loc_preds,
                                                  anchors), n=2, sleep=False)
    out = {"card": card, "forward_img_per_s_float32": f32_rate,
           "forward_img_per_s_bfloat16": bf16_rate,
           "bf16_cls_rel_frobenius": bf16_err, "bf16_tol": SSD_BF16_TOL,
           "multibox_target_ms": target_ms, "positives": npos,
           "mined_negatives": nneg, "multibox_detection_ms": detect_ms,
           "detections_kept": kept,
           "nms_rows_checked": SSD_BATCH * A}
    print("ssd 27b inference (%s): %s" % (card, json.dumps(out)))
    return out


def phase_ssd_example(torch, np, mx, fb, dev, card, module):
    """27c: examples/train_ssd.py's loop at its own size on the card,
    through ImageDetIter fed decoded arrays by its read_image / imdecode
    hooks (no OpenCV) with the example's mirror and normalization and no
    resize: the epoch loss falls, the detections are well formed and the
    example's top-detection IoU lies in [0, 1]. Returns (K3a-d launches,
    summary)."""
    images, imglist = mx.test_utils.synthetic_det_images(
        SSD_EX_IMAGES, SSD_EX_SIZE)

    class ArrayDetIter(mx.image.ImageDetIter):
        def read_image(self, fname):
            return images[int(fname[3:7])]

        def imdecode(self, s):
            return mx.nd.array(s, ctx=mx.cpu(), dtype="uint8")

    augs = [mx.image.DetHorizontalFlipAug(0.5),
            mx.image.DetBorrowAug(mx.image.CastAug()),
            mx.image.DetBorrowAug(mx.image.ColorNormalizeAug(
                np.array(SSD_OP_MEAN), np.array(SSD_OP_STD)))]
    import random
    random.seed(SSD_SEED)         # the iterator's shuffle and mirror draws
    it = ArrayDetIter(batch_size=SSD_EX_BATCH,
                      data_shape=(3, SSD_EX_SIZE, SSD_EX_SIZE),
                      imglist=imglist, shuffle=True, aug_list=augs)
    mx.random.seed(SSD_SEED)
    net = module.SSDLite(num_classes=2)
    net.initialize(mx.init.Xavier())
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": SSD_LR})
    ctx = _ctx(mx, dev)
    fb.reset_launch_counts()
    epochs, steps = [], 0
    t0 = time.perf_counter()
    for _ in range(SSD_EX_EPOCHS):
        it.reset()
        losses = []
        for b in it:
            loss = ssd_train(mx, net, trainer, module.ssd_loss,
                             b.data[0].as_in_context(ctx),
                             b.label[0].as_in_context(ctx), SSD_EX_BATCH)
            losses.append(float(loss.asnumpy()))
            steps += 1
        epochs.append(float(np.mean(losses)))
    secs = time.perf_counter() - t0
    launches = fb.launch_counts()
    check(launches == (5 * steps,) * 4, "27c: K3a-d launched %r over %d "
          "steps, not 5 a step" % (launches, steps))
    check(all(np.isfinite(epochs)) and epochs[-1] < epochs[0],
          "27c: the example's epoch loss did not fall: %r" % epochs)
    it.reset()
    b = next(it)
    batch = mx.io.DataBatch(data=[b.data[0].as_in_context(ctx)],
                            label=[b.label[0].as_in_context(ctx)])
    anchors, cls_preds, loc_preds = net(batch.data[0])
    det = net.detect(cls_preds, loc_preds, anchors)._data
    check(tuple(det.shape) == (SSD_EX_BATCH, anchors.shape[1], 6)
          and bool(((det[..., 0] >= -1) & (det[..., 0] < 2)).all())
          and bool(((det[..., 2:] >= 0) & (det[..., 2:] <= 1)).all()),
          "27c: detections not well formed")
    iou = module.evaluate(net, batch)
    check(0.0 <= iou <= 1.0, "27c: top-detection IoU %r" % iou)
    out = {"card": card, "steps": steps, "epoch_loss": epochs,
           "top_detection_iou": iou, "seconds": secs,
           "k3_launches": launches[0]}
    print("ssd 27c example (%s): %s" % (card, json.dumps(out)))
    return launches, out


def ssd_op_cases(torch, dev):
    """27d's cases, made on the card: (name, make, params, kind).
    Decoded box sizes are exact (their log-space deltas 0), so a box's
    IoU is the same float on both devices and the discrete NMS decisions
    cannot part on an exp's last bit."""
    g = torch.Generator().manual_seed(SSD_SEED)

    def rn(*s, lo=-1.0, hi=1.0):
        return (torch.rand(*s, generator=g) * (hi - lo) + lo).to(dev)

    def corner(*lead):
        a, b = torch.rand(*lead, 2, generator=g), torch.rand(*lead, 2,
                                                             generator=g)
        return torch.cat([torch.minimum(a, b), torch.maximum(a, b) + 0.02],
                         -1).to(dev)

    def anchors():
        from mxnet_tpu_torch.ops.contrib import MultiBoxPrior
        cells = [MultiBoxPrior(torch.zeros(1, 1, SSD_IMAGE // f,
                                           SSD_IMAGE // f, device=dev),
                               sizes=(z,), ratios=(1.0, 2.0, 0.5))
                 for f, z in SSD_MAPS]
        return torch.cat(cells, dim=1)

    def labels(n):
        lab = -torch.ones(n, SSD_MAX_BOXES, 5)
        for i in range(n):
            k = int(torch.randint(1, SSD_MAX_BOXES + 1, (1,), generator=g))
            lab[i, :k, 0] = torch.randint(0, SSD_CLASSES, (k,), generator=g)
            lab[i, :k, 1:] = corner(k).cpu() * 0.8
        return lab.to(dev)

    def det_inputs(n):
        A = ssd_anchor_count()
        p = torch.softmax(rn(n, SSD_CLASSES + 1, A, lo=-3, hi=3), dim=1)
        loc = rn(n, A, 4)
        loc[..., 2:] = 0
        return [p, loc.reshape(n, -1), anchors()]

    def nms_rows(B, n):
        rows = torch.cat([torch.randint(0, 4, (B, n, 1), generator=g)
                          .float().to(dev), rn(B, n, 1, lo=0, hi=1),
                          corner(B, n) * 0.7], -1)
        rows[:, 1::5, 1] = rows[:, 0:-1:5, 1]          # tied scores
        return rows

    def proposal_inputs():
        A, H = 12, 24
        d = rn(2, 4 * A, H, H, lo=-0.2, hi=0.2).reshape(2, A, 4, H, H)
        d[:, :, 2:] = 0
        return [rn(2, 2 * A, H, H, lo=0, hi=1), d.reshape(2, 4 * A, H, H),
                torch.tensor([[384.0, 384.0, 1.0], [360.0, 300.0, 1.0]],
                             device=dev)]

    def ctc_inputs(blank):
        T, N, C, L = 50, 16, 20, 10
        lens = torch.randint(1, L + 1, (N,), generator=g)
        lo, pad = (1, 0.0) if blank == "first" else (0, -1.0)
        lab = torch.full((N, L), pad)
        for i, k in enumerate(lens.tolist()):
            lab[i, :k] = torch.randint(lo, C - 1, (k,), generator=g).float()
        return [rn(T, N, C, lo=-2, hi=2), lab.to(dev),
                torch.randint(30, T + 1, (N,), generator=g).float().to(dev),
                lens.float().to(dev)]

    def rois(R, N, H, W):
        return roi_boxes(torch, g, R, N, H, W).to(dev)

    def dpsroi():
        return [rn(4, 8 * 3 * 3, 32, 32), rois(32, 4, 128, 128),
                rn(32, 4, 3, 3, lo=-0.5, hi=0.5)]

    det_n = SSD_OP_DET_BATCH
    return [
        ("_contrib_MultiBoxPrior", lambda: [rn(SSD_BATCH, 64, 32, 32)],
         dict(sizes=(0.2, 0.3), ratios=(1.0, 2.0, 0.5)), "arith"),
        ("_contrib_MultiBoxTarget",
         lambda: [anchors(), labels(SSD_BATCH),
                  rn(SSD_BATCH, SSD_CLASSES + 1, ssd_anchor_count(),
                     lo=-3, hi=3)],
         dict(overlap_threshold=0.5, negative_mining_ratio=3.0), "trans"),
        ("_contrib_MultiBoxDetection", lambda: det_inputs(det_n),
         dict(nms_threshold=0.45), "trans"),
        ("_contrib_box_iou", lambda: [corner(4096), corner(1024)], {},
         "arith"),
        ("_contrib_box_nms", lambda: [nms_rows(8, 1000)],
         dict(overlap_thresh=0.5, id_index=0, topk=400), "exact"),
        ("_contrib_ctc_loss", lambda: ctc_inputs("first")[:2], {}, "trans"),
        ("_contrib_ctc_loss", lambda: ctc_inputs("last"),
         dict(use_data_lengths=True, use_label_lengths=True,
              blank_label="last"), "trans"),
        ("_contrib_count_sketch",
         lambda: [rn(64, 1024),
                  torch.randint(0, 256, (1024,), generator=g).float()
                  .to(dev),
                  (torch.randint(0, 2, (1024,), generator=g) * 2 - 1)
                  .float().to(dev)], dict(out_dim=256), "sum"),
        ("_contrib_fft", lambda: [rn(64, 1024)], {}, "sum"),
        ("_contrib_ifft", lambda: [rn(64, 2048)], {}, "sum"),
        ("_contrib_Proposal", proposal_inputs,
         dict(rpn_pre_nms_top_n=2000, rpn_post_nms_top_n=300,
              output_score=True), "trans"),
        ("_contrib_MultiProposal", proposal_inputs,
         dict(rpn_pre_nms_top_n=2000, rpn_post_nms_top_n=300), "trans"),
        ("_contrib_DeformableConvolution",
         lambda: [rn(8, 64, 32, 32), rn(8, 2 * 9, 32, 32, lo=-2, hi=2),
                  rn(64, 64, 3, 3, lo=-0.1, hi=0.1), rn(64)],
         dict(kernel=(3, 3), pad=(1, 1), num_filter=64), "trans"),
        ("_contrib_PSROIPooling",
         lambda: [rn(4, 8 * 3 * 3, 32, 32), rois(32, 4, 64, 64)],
         dict(spatial_scale=0.5, output_dim=8, pooled_size=3), "trans"),
        ("_contrib_DeformablePSROIPooling", dpsroi,
         dict(spatial_scale=0.25, output_dim=8, group_size=3,
              pooled_size=3, sample_per_part=4, trans_std=0.1), "trans"),
        ("_contrib_bipartite_matching", lambda: [rn(8, 100, 200, lo=0,
                                                    hi=1)],
         dict(threshold=0.2), "exact"),
    ]


#: phase 27d's aliases: alias -> its primary name
SSD_OP_ALIASES = {
    "MultiBoxPrior": "_contrib_MultiBoxPrior",
    "MultiBoxTarget": "_contrib_MultiBoxTarget",
    "MultiBoxDetection": "_contrib_MultiBoxDetection",
    "_contrib_nms": "_contrib_box_nms", "ctc_loss": "_contrib_ctc_loss",
    "CTCLoss": "_contrib_ctc_loss", "_contrib_CTCLoss": "_contrib_ctc_loss",
    "Proposal": "_contrib_Proposal", "MultiProposal": "_contrib_MultiProposal",
    "DeformableConvolution": "_contrib_DeformableConvolution",
    "PSROIPooling": "_contrib_PSROIPooling",
    "DeformablePSROIPooling": "_contrib_DeformablePSROIPooling"}


def phase_ssd_ops(torch, np, mx, dev, card):
    """27d: the 15 names of ops/contrib.py this slice ports (and once
    each, their aliases) on the card, through mx.nd.<name> on NDArrays of
    the card, held against the same call on the CPU (item2_one), and
    where the op is differentiable its gradients; then gluon's CTCLoss
    forward and backward on both. Prints each largest error beside its
    limit and the card's ms."""
    from mxnet_tpu_torch.ops import registry
    rows, first = [], {}
    for i, (name, make, params, kind) in enumerate(ssd_op_cases(torch,
                                                                 dev)):
        first.setdefault(name, (make, params, kind))
        t0 = time.perf_counter()
        inputs = make()
        err, gerr, ms, tol, gtol = item2_one(
            torch, mx, registry, name, inputs, params, kind, dev, 2700 + i,
            grads=True)
        row = {"name": name, "max_err": err, "tol": tol, "card_ms": ms,
               "wall_s": time.perf_counter() - t0}
        if registry.get(name).differentiable:
            row.update(max_grad_err=gerr, grad_tol=gtol)
        rows.append(row)
    for alias, op in SSD_OP_ALIASES.items():
        make, params, kind = first[op]
        err, _, ms, tol, _ = item2_one(torch, mx, registry, alias, make(),
                                       params, kind, dev, 0, grads=False)
        rows.append({"name": alias, "max_err": err, "tol": tol,
                     "card_ms": ms})
    # gluon's CTCLoss (blank last, NTC) forward and backward
    g = torch.Generator().manual_seed(SSD_SEED)
    pred = torch.rand(16, 50, 20, generator=g) * 4 - 2
    label = torch.randint(0, 19, (16, 10), generator=g).float()
    label[:, 7:] = -1
    res = {}
    for where, ctx in (("card", _ctx(mx, dev)), ("cpu", mx.cpu())):
        p = mx.nd.array(pred.numpy(), ctx=ctx)
        p.attach_grad()
        with mx.autograd.record():
            loss = mx.gluon.loss.CTCLoss()(p, mx.nd.array(label.numpy(),
                                                          ctx=ctx))
        loss.backward()
        res[where] = (loss._data.detach(), p.grad._data)
    tol = ITEM2_TOL["trans"]
    err = item2_err(torch, res["card"][0], res["cpu"][0])
    gerr = item2_err(torch, res["card"][1], res["cpu"][1])
    check(err <= tol and gerr <= tol, "gluon CTCLoss on the card against "
          "the CPU: loss %.3g, grad %.3g (tol %g)" % (err, gerr, tol))
    rows.append({"name": "gluon.loss.CTCLoss", "max_err": err, "tol": tol,
                 "max_grad_err": gerr, "grad_tol": tol})
    for r in rows:
        print("ssd op 27d %-32s max err %.3g (tol %g)%s%s" % (
            r["name"], r["max_err"], r["tol"],
            ", grad %.3g (tol %g)" % (r["max_grad_err"], r["grad_tol"])
            if r.get("max_grad_err") is not None else "",
            ", card %.3f ms" % r["card_ms"] if "card_ms" in r else ""))
    out = {"card": card, "cases": len(rows), "rows": rows}
    print("ssd ops 27d (%s): %s" % (card, json.dumps(out)))
    return out


class _OnCard:
    """A package whose `cpu()` is the card: runs an example that builds
    its Module with `context=mx.cpu()` on the card unchanged."""

    def __init__(self, pkg, dev):
        self._pkg, self._dev = pkg, dev

    def __getattr__(self, name):
        return getattr(self._pkg, name)

    def cpu(self, device_id=0):
        return self._pkg.gpu(self._dev.index or 0)


def phase_custom_example(torch, np, mx, dev, card):
    """27e: examples/custom_op.py at its defaults (the NumpySoftmax head
    through Module, 2 epochs of the synthetic MNIST) with its context on
    the card: main() returns 0 (validation accuracy >= 0.9)."""
    module = load_example("custom_op.py")
    check(module.operator is mx.operator, "the example did not load the "
          "port's operator module")
    module.mx = _OnCard(mx, dev)
    np.random.seed(SSD_SEED)
    mx.random.seed(SSD_SEED)
    argv = sys.argv
    sys.argv = ["custom_op.py"]
    t0 = time.perf_counter()
    try:
        rc = module.main()
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    check(rc == 0, "examples/custom_op.py failed its own check on the "
          "card (rc %s)" % rc)
    out = {"card": card, "rc": rc, "seconds": time.perf_counter() - t0}
    print("custom op example 27e (%s): %s" % (card, json.dumps(out)))
    return out


def phase_ssd(torch, np, dev, card):
    """Phase 27 (module docstring): SSDLite at bench width (27a-b), the
    example's loop through ImageDetIter (27c), the slice's ops on the card
    against the CPU (27d), the custom-op example (27e). Returns ({path:
    K3a-d launches}, summary)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_bn as fb
    module = load_example("train_ssd.py")
    check(module.SSDLite is mx.models.SSDLite, "the example did not load "
          "the port's SSDLite")
    try:
        import cv2
        cv2_found = cv2.__version__
    except ImportError:
        cv2_found = None
    print("ssd 27: cv2 importable on this machine: %s" % (
        "yes (%s)" % cv2_found if cv2_found else "no"))
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    out = {"card": card, "cv2": cv2_found}
    t0 = time.perf_counter()
    try:
        with mx.gpu(dev.index or 0):
            net, batch, a_launches, out["27a"] = phase_ssd_train(
                torch, np, mx, fb, dev, card, module)
            out["27b"] = phase_ssd_infer(torch, np, mx, dev, card, module,
                                         batch)
            del net, batch
            c_launches, out["27c"] = phase_ssd_example(torch, np, mx, fb,
                                                       dev, card, module)
            out["27d"] = phase_ssd_ops(torch, np, mx, dev, card)
            out["27e"] = phase_custom_example(torch, np, mx, dev, card)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    out["s"] = time.perf_counter() - t0
    print("ssd phase 27 (%s): %.1f s" % (card, out["s"]))
    return {"ssdlite_phase27a": a_launches,
            "ssd_example_phase27c": c_launches}, out


# ---------------------------------------------------------------------------
# phase 28: BASELINE config 5 (sparse linear, FM) and int8 post-training
# quantization (the rest of ROADMAP item 13)
# ---------------------------------------------------------------------------

#: bench.py's non-smoke bench_sparse_linear width: batch 512, 2,000,000
#: features, 60 stored values a row (30,720 a batch; columns drawn with
#: repeats, as the bench draws them), 2 classes, SGD at lr 0.1; seed 28
SPARSE_SEED = 28
SPARSE_BATCH, SPARSE_FEATURES, SPARSE_NNZ_ROW = 512, 2000000, 60
SPARSE_LR = 0.1
SPARSE_WARMUP, SPARSE_STEPS, SPARSE_STORE_STEPS = 1, 15, 3
#: 28a: the step's peak device memory above the phase's start: the dense
#: batch alone would be 512 x 2,000,000 x 4 B = 4.1 GB
SPARSE_PEAK_LIMIT = 1 << 30
#: 28a-c: card against the port on the CPU (float32 segment sums in
#: another order: relative to the largest value, as phase 21a's "sum")
SPARSE_TOL = 1e-5
#: 28c: the factorization machine on the same data, 8 factors
FM_FACTORS, FM_STEPS = 8, 5
#: 28d: LibSVMIter over a file the phase writes at
#: examples/sparse_linear_classification.py's width (1000 features,
#: density 0.05, batch 64)
SPARSE_EX_LINES, SPARSE_EX_FEATURES = 4096, 1000
SPARSE_EX_DENSITY, SPARSE_EX_BATCH = 0.05, 64
#: 28f: bench.py's non-smoke bench_resnet50_int8_infer: resnet50_v1
#: exported from Gluon, model.load_checkpoint, quantize_model with
#: calib_mode "none", batch 256 of 3 x 224 x 224, 2 warm-up and 20 timed
#: forwards; the int32 accumulators against the port's CPU path on 2
#: images
Q_BATCH, Q_IMAGE, Q_WARMUP, Q_STEPS, Q_CPU_IMAGES = 256, 224, 2, 20, 2
#: 28f: largest |int32 accumulator on the card - on the CPU| of one layer
#: over the same int8 inputs (the quantized convolution computes in
#: float32, exact while each partial sum stays below 2^24; cuDNN may pick
#: another algorithm than the CPU's)
Q_INT32_TOL = 0
#: 28h: the 13 names on the card against the CPU
Q_OP_TOL = {"exact": 0.0, "sum": 1e-5}


def count_syncs(torch, fn):
    """(fn(), the device-to-host synchronisations it made, the source
    lines that made them): PyTorch's sync debug mode warns at each one."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = ["%s:%d" % (os.path.relpath(w.filename), w.lineno)
             for w in caught if "synchroniz" in str(w.message)]
    return out, len(where), where


def sparse_batch(np, mx, ctx):
    """bench_sparse_linear's CSR batch and random labels, built as CSR
    (never dense) on `ctx`."""
    n, d, nnz_row = SPARSE_BATCH, SPARSE_FEATURES, SPARSE_NNZ_ROW
    rs = np.random.RandomState(SPARSE_SEED)
    cols = rs.randint(0, d, n * nnz_row).astype(np.int32)
    indptr = np.arange(0, n * nnz_row + 1, nnz_row).astype(np.int32)
    vals = rs.rand(n * nnz_row).astype(np.float32)
    y = (rs.rand(n) > 0.5).astype(np.float32)
    return (mx.nd.sparse.CSRNDArray(vals, cols, indptr, (n, d), ctx=ctx),
            mx.nd.array(y, ctx=ctx))


def rows_err(torch, got, want, rows):
    """item2_err over the given rows of two weights (card and CPU)."""
    return item2_err(torch, got.index_select(0, rows.to(got.device)).cpu(),
                     want.index_select(0, rows.cpu()))


def phase_sparse_linear(torch, np, mx, dev, card):
    """28a: SparseLinear at bench width on the card: the first step
    against the port on the CPU (loss, touched rows, updated rows; every
    other row bit-equal), the transposed product's spread over two runs,
    1 warm-up and 15 timed steps, syncs a step, peak memory above the
    phase's start, a profiled step."""
    ctx = _ctx(mx, dev)
    with mx.cpu():
        xc, yc = sparse_batch(np, mx, mx.cpu())
        cpu = mx.models.SparseLinear(SPARSE_FEATURES, 2,
                                     learning_rate=SPARSE_LR)
        cpu_loss = cpu.step(xc, yc)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with ctx:
        x, y = sparse_batch(np, mx, ctx)
        model = mx.models.SparseLinear(SPARSE_FEATURES, 2,
                                       learning_rate=SPARSE_LR)
    w0 = model.weight._data.clone()
    touched = mx.nd.sparse.touched_rows(x)
    check(torch.equal(touched.cpu(), mx.nd.sparse.touched_rows(xc)),
          "28a: the touched rows differ from the CPU's")
    loss0 = model.step(x, y)
    rows = touched.long()
    untouched = torch.ones(SPARSE_FEATURES, dtype=torch.bool, device=dev)
    untouched[rows] = False
    w1 = model.weight._data
    loss_err = abs(loss0 - cpu_loss) / abs(cpu_loss)
    w_err = rows_err(torch, w1, cpu.weight._data, rows)
    check(loss_err <= SPARSE_TOL and w_err <= SPARSE_TOL,
          "28a: the first step on the card against the CPU: loss %.3g, "
          "updated rows %.3g (tol %g)" % (loss_err, w_err, SPARSE_TOL))
    check(torch.equal(w1[untouched], w0[untouched]),
          "28a: a row the batch does not touch moved")
    # the transposed product (the weight gradient) twice: its segment
    # sums run without atomics, so the spread must be 0
    g = torch.randn(SPARSE_BATCH, 2, device=dev)
    a = mx.nd.sparse.dot(x, mx.nd.NDArray(g), transpose_a=True)._data
    b = mx.nd.sparse.dot(x, mx.nd.NDArray(g), transpose_a=True)._data
    spread = float((a - b).abs().max())
    check(spread == 0.0, "28a: csr^T . dense differs run to run by %g"
          % spread)
    del a, b
    losses = [loss0] + [model.step(x, y) for _ in range(SPARSE_WARMUP)]
    times = []
    for _ in range(SPARSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(model.step(x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    loss, syncs, sync_lines = count_syncs(torch, lambda: model.step(x, y))
    losses.append(loss)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "28a: losses not finite or not falling: %r" % losses)
    check(peak - base < SPARSE_PEAK_LIMIT,
          "28a: the sparse step's peak memory %d B above the phase's start "
          "passes %d B" % (peak - base, SPARSE_PEAK_LIMIT))
    prof = profile_step(torch, "sparse linear 28a", lambda: torch.tensor(
        model.step(x, y)))
    ms = sorted(1e3 * t for t in times)
    mean_ms = sum(ms) / len(ms)
    out = {"card": card, "batch": SPARSE_BATCH,
           "features": SPARSE_FEATURES, "nnz": SPARSE_BATCH * SPARSE_NNZ_ROW,
           "touched_rows": int(rows.numel()), "steps_timed": SPARSE_STEPS,
           "step_ms_mean": mean_ms, "step_ms_p50": float(np.median(ms)),
           "samples_per_s": SPARSE_BATCH / (mean_ms / 1e3),
           "syncs_per_step": syncs, "sync_lines": sync_lines,
           "loss_first": losses[0],
           "loss_last": losses[-1], "first_step_loss_rel_err": loss_err,
           "first_step_rows_err": w_err, "csrT_dot_run_to_run": spread,
           "peak_bytes": peak, "peak_bytes_above_start": peak - base,
           "dense_batch_bytes": SPARSE_BATCH * SPARSE_FEATURES * 4,
           "profile": prof}
    print("sparse linear 28a (%s): %s" % (card, json.dumps(out)))
    return out


def phase_sparse_store(torch, np, mx, dev, card):
    """28b: the same model through kv.create("local") (row-sparse push,
    the store's optimizer, pull) against no store, 3 steps, equal
    weights; row_sparse_pull of the batch's rows against the weight;
    lazy Adam on the card against the CPU."""
    ctx = _ctx(mx, dev)
    with ctx:
        x, y = sparse_batch(np, mx, ctx)
        kv_model = mx.models.SparseLinear(
            SPARSE_FEATURES, 2, kvstore=mx.kv.create("local"),
            learning_rate=SPARSE_LR)
        plain = mx.models.SparseLinear(SPARSE_FEATURES, 2,
                                       learning_rate=SPARSE_LR)
    for _ in range(SPARSE_STORE_STEPS):
        kv_model.step(x, y)
        plain.step(x, y)
    diff = float((kv_model.weight._data - plain.weight._data).abs().max())
    check(diff == 0.0, "28b: the store's weights differ from the plain "
          "model's by %g" % diff)
    rows = mx.nd.sparse.touched_rows(x)
    pulled = kv_model.row_sparse_pull(mx.nd.NDArray(rows))
    check(torch.equal(pulled._indices, rows) and torch.equal(
        pulled._values, kv_model.weight._data[rows.long()]),
        "28b: row_sparse_pull's rows differ from the weight's")
    adam = {}
    for where, c in (("card", ctx), ("cpu", mx.cpu())):
        with c:
            xa, ya = sparse_batch(np, mx, c)
            m = mx.models.SparseLinear(SPARSE_FEATURES, 2, optimizer="adam",
                                       learning_rate=0.01)
            for _ in range(2):
                m.step(xa, ya)
            adam[where] = m.weight._data
    adam_err = rows_err(torch, adam["card"], adam["cpu"], rows.long())
    check(adam_err <= SPARSE_TOL, "28b: lazy Adam on the card against the "
          "CPU: %.3g > %g" % (adam_err, SPARSE_TOL))
    out = {"card": card, "store_vs_plain_max_diff": diff,
           "pulled_rows": int(rows.numel()), "lazy_adam_rows_err": adam_err}
    print("sparse store 28b (%s): %s" % (card, json.dumps(out)))
    return out


def phase_fm(torch, np, mx, dev, card):
    """28c: the factorization machine at bench width, 8 factors: 5 steps
    on one batch, step ms, a falling loss."""
    ctx = _ctx(mx, dev)
    with ctx:
        x, y = sparse_batch(np, mx, ctx)
        fm = mx.models.FactorizationMachine(SPARSE_FEATURES, FM_FACTORS,
                                            learning_rate=SPARSE_LR,
                                            seed=SPARSE_SEED)
    losses, times = [], []
    for _ in range(FM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(fm.step(x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "28c: FM losses not finite or not falling: %r" % losses)
    ms = [1e3 * t for t in times]
    out = {"card": card, "factors": FM_FACTORS, "steps": FM_STEPS,
           "step_ms": ms, "step_ms_after_first": float(np.mean(ms[1:])),
           "losses": losses}
    print("factorization machine 28c (%s): %s" % (card, json.dumps(out)))
    return out


def run_example(module, argv):
    """module.main() under `argv`, its stdout captured: (rc, text)."""
    import contextlib
    import io
    saved = sys.argv
    sys.argv = argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = module.main()
    finally:
        sys.argv = saved
    return rc, buf.getvalue()


def write_libsvm(np, path, lines, features, density, seed):
    """A LibSVM file of `lines` rows at `density`, labels from a planted
    weight."""
    rs = np.random.RandomState(seed)
    w = rs.uniform(-1, 1, features)
    with open(path, "w") as f:
        for _ in range(lines):
            cols = np.nonzero(rs.rand(features) < density)[0]
            vals = rs.uniform(-1, 1, cols.size)
            f.write("%d %s\n" % (int(vals @ w[cols] > 0), " ".join(
                "%d:%.6f" % kv for kv in zip(cols, vals))))


def phase_sparse_example(torch, np, mx, dev, card):
    """28d: examples/sparse_linear_classification.py at its defaults on
    the card (its printed figures against the port on the CPU), then
    LibSVMIter over a file of 4096 lines at the example's width, whole
    and in 2 parts, its batches trained as CSR on the card."""
    module = load_example("sparse_linear_classification.py")
    check(module.mx.models.SparseLinear is mx.models.SparseLinear,
          "the example did not load the port's SparseLinear")
    with mx.cpu():
        rc_cpu, text_cpu = run_example(module, ["x"])
    module.mx = _OnCard(mx, dev)
    t0 = time.perf_counter()
    with _ctx(mx, dev):
        rc, text = run_example(module, ["x"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = float(text.strip().splitlines()[-1].split()[-1])
    acc_cpu = float(text_cpu.strip().splitlines()[-1].split()[-1])
    check(abs(acc - acc_cpu) <= 0.02, "28d: the example's accuracy on the "
          "card %.3f against %.3f on the CPU" % (acc, acc_cpu))
    tmp = tempfile.mkdtemp(prefix="mxtt_phase28_")
    try:
        path = os.path.join(tmp, "data.libsvm")
        write_libsvm(np, path, SPARSE_EX_LINES, SPARSE_EX_FEATURES,
                     SPARSE_EX_DENSITY, SPARSE_SEED)
        parts = [sum(1 for _ in mx.io.LibSVMIter(
            path, (SPARSE_EX_FEATURES,), batch_size=SPARSE_EX_BATCH,
            num_parts=2, part_index=i)) for i in range(2)]
        check(parts == [SPARSE_EX_LINES // 2 // SPARSE_EX_BATCH] * 2,
              "28d: LibSVMIter parts gave %r batches" % parts)
        it = mx.io.LibSVMIter(path, (SPARSE_EX_FEATURES,),
                              batch_size=SPARSE_EX_BATCH)
        ctx = _ctx(mx, dev)
        with ctx:
            model = mx.models.SparseLinear(SPARSE_EX_FEATURES, 2,
                                           learning_rate=0.5)
        losses = []
        t1 = time.perf_counter()
        for batch in it:
            xb = batch.data[0].as_in_context(ctx).tostype("csr")
            losses.append(model.step(xb, batch.label[0].as_in_context(ctx)))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(len(losses) == SPARSE_EX_LINES // SPARSE_EX_BATCH and
          np.mean(losses[-8:]) < np.mean(losses[:8]),
          "28d: LibSVMIter training: %d batches, losses %r"
          % (len(losses), losses[::8]))
    out = {"card": card, "example_rc": rc, "example_accuracy": acc,
           "example_accuracy_cpu": acc_cpu, "example_s": wall,
           "example_lines": text.strip().splitlines(),
           "libsvm_batches": len(losses), "libsvm_parts_batches": parts,
           "libsvm_samples_per_s": SPARSE_EX_LINES / loop_s,
           "libsvm_loss_first8": float(np.mean(losses[:8])),
           "libsvm_loss_last8": float(np.mean(losses[-8:]))}
    print("sparse example 28d (%s): %s" % (card, json.dumps(out)))
    return out


def quantized_layers(qsym):
    """The quantized FullyConnected / Convolution nodes of a graph."""
    return [n for n in qsym._topo() if n.op is not None and n.op.name in (
        "_contrib_quantized_conv", "_contrib_quantized_fully_connected")]


def int32_against_cpu(torch, mx, qsym, qargs, qaux, x, dev):
    """Each quantized layer's int32 accumulator on the card against the
    same layer on the CPU fed the card's own int8 inputs and ranges:
    (largest |difference|, layers differing, largest |accumulator|)."""
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.symbol import Symbol
    layers = quantized_layers(qsym)
    outs = []
    for n in layers:
        outs += list(n.inputs) + [(n, 0)]
    group = Symbol(outs)
    ctx = _ctx(mx, dev)
    args = {k: v for k, v in qargs.items()
            if k in group.list_arguments()}
    exe = group.bind(ctx, args=dict(args, data=mx.nd.NDArray(x)),
                     aux_states={k: qaux[k] for k in
                                 group.list_auxiliary_states()},
                     grad_req="null")
    vals = [o._data for o in exe.forward(is_train=False)]
    worst, differing, largest, at = 0, 0, 0, 0
    for n in layers:
        k = len(n.inputs)
        ins, card_acc = vals[at:at + k], vals[at + k]
        at += k + 1
        want = registry.get(n.op.name).fn(*[t.cpu() for t in ins],
                                          **n.kwargs)[0]
        d = int((card_acc.cpu().long() - want.long()).abs().max())
        worst = max(worst, d)
        differing += d > 0
        largest = max(largest, int(want.long().abs().max()))
    return worst, differing, largest, len(layers)


def phase_quantized_resnet(torch, np, mx, dev, card):
    """28f: ResNet-50 v1 quantized as bench_resnet50_int8_infer does it
    (Gluon export, model.load_checkpoint, quantize_model calib "none")
    and bound with grad_req "null": 2 warm-up and 20 timed forwards at
    batch 256 beside the float executor's; top-1 agreement and the
    largest relative logit error against the float net; each layer's
    int32 accumulators against the CPU on 2 images; peak memory."""
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ctx = _ctx(mx, dev)
    mx.random.seed(SPARSE_SEED)
    tmp = tempfile.mkdtemp(prefix="mxtt_phase28f_")
    try:
        with ctx:
            net = vision.resnet50_v1()
            net.initialize(mx.init.Xavier())
            net(mx.nd.zeros((1, 3, Q_IMAGE, Q_IMAGE)))
            net.export(os.path.join(tmp, "r50"))
            sym, args, aux = mx.model.load_checkpoint(
                os.path.join(tmp, "r50"), 0)
        del net
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    qsym, qargs, qaux = quantize_model(sym, args, aux, ctx=ctx)
    quantize_s = time.perf_counter() - t0
    layers = quantized_layers(qsym)
    n_conv = sum(n.op.name == "_contrib_quantized_conv" for n in layers)
    check((n_conv, len(layers) - n_conv) == (53, 1),
          "28f: %d int8 convolutions and %d int8 FC, not 53 and 1"
          % (n_conv, len(layers) - n_conv))
    rs = np.random.RandomState(SPARSE_SEED)
    x = torch.from_numpy(rs.uniform(-1, 1, (Q_BATCH, 3, Q_IMAGE, Q_IMAGE))
                         .astype(np.float32)).to(dev)
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for what, s, a in (("float32", sym, args), ("int8", qsym, qargs)):
        exe = s.bind(ctx, args=dict(a, data=mx.nd.NDArray(x)),
                     aux_states=dict(qaux if what == "int8" else aux),
                     grad_req="null")
        for _ in range(Q_WARMUP):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(Q_STEPS):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t1) / Q_STEPS
        res[what] = {"ms": 1e3 * sec, "img_per_s": Q_BATCH / sec,
                     "logits": exe.outputs[0]._data.float(),
                     "profile": profile_step(
                         torch, "%s resnet50 forward 28f" % what,
                         lambda: exe.forward(is_train=False)[0]._data
                         .float().sum())}
        del exe
    peak = torch.cuda.max_memory_allocated(dev)
    f, q = res["float32"].pop("logits"), res["int8"].pop("logits")
    check(bool(torch.isfinite(q).all()), "28f: int8 logits not finite")
    agree = float((f.argmax(1) == q.argmax(1)).float().mean())
    rel = float((q - f).abs().max()) / max(float(f.abs().max()), 1e-30)
    worst, differing, largest, n_layers = int32_against_cpu(
        torch, mx, qsym, qargs, qaux, x[:Q_CPU_IMAGES], dev)
    check(worst <= Q_INT32_TOL, "28f: an int32 accumulator on the card "
          "differs from the CPU's by %d (limit %d; %d of %d layers differ)"
          % (worst, Q_INT32_TOL, differing, n_layers))
    out = {"card": card, "batch": Q_BATCH, "image": Q_IMAGE,
           "int8_layers": {"conv": n_conv, "fc": len(layers) - n_conv},
           "quantize_model_s": quantize_s, "forwards_timed": Q_STEPS,
           "float32": res["float32"], "int8": res["int8"],
           "top1_agreement": agree, "max_rel_logit_err": rel,
           "int32_max_abs_diff_vs_cpu": worst,
           "int32_layers_differing": differing,
           "int32_largest_abs_acc": largest, "int32_limit": Q_INT32_TOL,
           "peak_bytes": peak}
    print("quantized resnet50 28f (%s): %s" % (card, json.dumps(out)))
    return out


def phase_quantize_example(torch, np, mx, dev, card):
    """28g: examples/quantize_int8.py at its defaults with its context on
    the card: rc 0 (int8 within 5 points of fp32), both accuracies."""
    module = load_example("quantize_int8.py")
    module.mx = _OnCard(mx, dev)
    np.random.seed(SPARSE_SEED)
    mx.random.seed(SPARSE_SEED)
    t0 = time.perf_counter()
    rc, text = run_example(module, ["quantize_int8.py"])
    torch.cuda.synchronize()
    check(rc == 0, "examples/quantize_int8.py failed its own check on the "
          "card (rc %s): %s" % (rc, text))
    out = {"card": card, "rc": rc, "seconds": time.perf_counter() - t0,
           "lines": text.strip().splitlines()}
    print("quantize example 28g (%s): %s" % (card, json.dumps(out)))
    return out


def item13_op_cases(torch, dev):
    """(name, inputs made on the card, params, kind) at the phase's
    sizes: the sparse ops at 28a's batch, the quantized ops at a ResNet
    layer's shapes (batch 2), the FC at ResNet-50's head and at
    num_hidden 10."""
    g = torch.Generator(device=dev).manual_seed(SPARSE_SEED)
    nnz = SPARSE_BATCH * SPARSE_NNZ_ROW

    def r(v):
        return torch.tensor(float(v), device=dev)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def un(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2 - 1
    indptr = torch.arange(0, nnz + 1, SPARSE_NNZ_ROW, device=dev,
                          dtype=torch.int32)
    cols = torch.randint(0, SPARSE_FEATURES, (nnz,), generator=g,
                         device=dev, dtype=torch.int32)
    vals = torch.rand(nnz, generator=g, device=dev)
    ids = torch.unique(cols)[:4096].int()
    rows = un(ids.numel(), 8)
    csr = [indptr, cols, vals]
    big = dict(num_rows=SPARSE_BATCH, num_cols=SPARSE_FEATURES)
    return [
        ("_rsp_to_dense", [ids, rows], dict(num_rows=SPARSE_FEATURES),
         "exact"),
        ("_dense_to_rsp", [un(4096, 8)], {}, "exact"),
        ("_csr_to_dense", [indptr[:65], cols[:64 * 60], vals[:64 * 60]],
         dict(num_rows=64, num_cols=SPARSE_FEATURES), "sum"),
        ("sparse_retain", [ids, rows, ids[::3]], {}, "exact"),
        ("_csr_dot_dense", csr + [un(SPARSE_FEATURES, 2)], big, "sum"),
        ("_csr_dot_dense", csr + [un(SPARSE_BATCH, 2)],
         dict(big, transpose_lhs=True), "sum"),
        ("_rsp_dot_dense", [ids, rows, un(8, 16)], {}, "sum"),
        ("_contrib_quantize", [un(2, 256, 56, 56) * 3, r(-2.5), r(3.0)],
         {}, "exact"),
        ("_contrib_dequantize", [i8(2, 256, 56, 56), r(-2.5), r(3.0)], {},
         "exact"),
        ("_contrib_requantize",
         [torch.randint(-40000, 40000, (256, 1000), generator=g,
                        device=dev, dtype=torch.int32), r(-3), r(3)], {},
         "exact"),
        ("_contrib_quantized_fully_connected",
         [i8(256, 2048), i8(1000, 2048), r(-1), r(1), r(-0.2), r(0.2),
          i8(1000), r(-0.1), r(0.1)], dict(num_hidden=1000), "exact"),
        ("_contrib_quantized_fully_connected",
         [i8(64, 36), i8(10, 36), r(-1), r(1), r(-0.2), r(0.2)],
         dict(num_hidden=10, no_bias=True), "exact"),
        ("_contrib_quantized_conv",
         [i8(2, 64, 56, 56), i8(64, 64, 3, 3), r(-1), r(1), r(-0.2),
          r(0.2)], dict(kernel=(3, 3), pad=(1, 1), num_filter=64,
                        no_bias=True), "exact"),
        ("_contrib_quantized_pooling", [i8(32, 64, 112, 112), r(-1), r(1)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
         "exact"),
        ("_contrib_quantized_flatten", [i8(256, 2048, 1, 1), r(-1), r(1)],
         {}, "exact"),
    ]


#: phase 28h's aliases: alias -> its primary name
ITEM13_ALIASES = {
    "_sparse_retain": "sparse_retain", "quantize": "_contrib_quantize",
    "dequantize": "_contrib_dequantize",
    "requantize": "_contrib_requantize",
    "quantized_fully_connected": "_contrib_quantized_fully_connected",
    "quantized_conv": "_contrib_quantized_conv",
    "quantized_pooling": "_contrib_quantized_pooling",
    "quantized_flatten": "_contrib_quantized_flatten"}


def item13_one(torch, mx, name, card_in, params, tol):
    """One op through mx.nd.<name> on the card and on the CPU: (largest
    error, the card's ms). Integer outputs count their largest
    |difference|; float ones item2_err."""
    fn = getattr(mx.nd, name)
    with mx.cpu():
        want = fn(*[mx.nd.NDArray(t.cpu()) for t in card_in], **params)
    card_nds = [mx.nd.NDArray(t) for t in card_in]
    got = fn(*card_nds, **params)
    want = [w._data for w in (want if isinstance(want, tuple) else (want,))]
    got = [o._data for o in (got if isinstance(got, tuple) else (got,))]
    check(len(got) == len(want) and all(
        o.dtype == w.dtype and o.shape == w.shape and o.device ==
        card_in[0].device for o, w in zip(got, want)),
        "%s: the card's outputs differ in number, dtype, shape or device"
        % name)
    err = 0.0
    for o, w in zip(got, want):
        if o.is_floating_point():
            err = max(err, item2_err(torch, o, w))
        else:
            err = max(err, float((o.cpu().long() - w.long()).abs().max())
                      if w.numel() else 0.0)
    check(err <= tol, "%s on the card against the CPU (%s): %.3g > %g"
          % (name, {k: v for k, v in params.items()}, err, tol))
    ms = time_ms(torch, lambda: fn(*card_nds, **params), n=5, sleep=False)
    return err, ms


def phase_item13_ops(torch, np, mx, dev, card):
    """28h: the 13 names this slice ports (and once each, their aliases)
    on the card against the port on the CPU, each largest error beside
    its limit and the card's ms."""
    rows, first = [], {}
    for name, card_in, params, kind in item13_op_cases(torch, dev):
        first.setdefault(name, (card_in, params, kind))
        err, ms = item13_one(torch, mx, name, card_in, params,
                             Q_OP_TOL[kind])
        rows.append({"name": name, "max_err": err, "tol": Q_OP_TOL[kind],
                     "card_ms": ms})
    for alias, op in ITEM13_ALIASES.items():
        card_in, params, kind = first[op]
        err, ms = item13_one(torch, mx, alias, card_in, params,
                             Q_OP_TOL[kind])
        rows.append({"name": alias, "max_err": err, "tol": Q_OP_TOL[kind],
                     "card_ms": ms})
    for r in rows:
        print("item 13 op 28h %-36s max err %.3g (tol %g), card %.3f ms"
              % (r["name"], r["max_err"], r["tol"], r["card_ms"]))
    out = {"card": card, "cases": len(rows),
           "names": len({ITEM13_ALIASES.get(r["name"], r["name"])
                         for r in rows}), "rows": rows}
    print("item 13 ops 28h (%s): %s" % (card, json.dumps(out)))
    return out


def phase_sparse_quant(torch, np, dev, card, dist_summary):
    """Phase 28 (module docstring): sparse linear at bench width (28a),
    through the store (28b), the FM (28c), the sparse example and
    LibSVMIter (28d), phase 24d's row-sparse world (28e), quantized
    ResNet-50 at bench width (28f), the quantization example (28g), the
    slice's ops (28h). Runs no kernel of the kernels line. Returns its
    summary."""
    import mxnet_tpu_torch as mx
    out = {"card": card}
    t0 = time.perf_counter()
    out["28a"] = phase_sparse_linear(torch, np, mx, dev, card)
    out["28b"] = phase_sparse_store(torch, np, mx, dev, card)
    out["28c"] = phase_fm(torch, np, mx, dev, card)
    torch.cuda.empty_cache()
    out["28d"] = phase_sparse_example(torch, np, mx, dev, card)
    out["28e"] = dist_summary.get("24d_kvstore")
    print("sparse world 28e (%s, folded into 24d's launch): %s"
          % (card, json.dumps(out["28e"])))
    out["28f"] = phase_quantized_resnet(torch, np, mx, dev, card)
    torch.cuda.empty_cache()
    out["28g"] = phase_quantize_example(torch, np, mx, dev, card)
    out["28h"] = phase_item13_ops(torch, np, mx, dev, card)
    out["s"] = time.perf_counter() - t0
    print("sparse + int8 phase 28 (%s): %.1f s" % (card, out["s"]))
    return out


# ---------------------------------------------------------------------------
# phase 29: deployment (ROADMAP item 14's first half): Predictor and
# export on torch.export, K4a in the exported graph, rtc.CudaModule (K5),
# TorchBlock, ONNX import
# ---------------------------------------------------------------------------

#: 29a: resnet50_v1 served from an artifact in float32 at this batch of
#: 3 x 224 x 224 images (R50_IMAGE), random Xavier weights from seed 29;
#: batch_predict over this many single images (one full batch and a
#: ragged one); each route's forward timed this many times
DEPLOY_SEED = 29
DEPLOY_BATCH, DEPLOY_SAMPLES, DEPLOY_TIMED = 32, 45, 10
#: 29b: the exported word LM's logits against the eager net with the flag
#: off (K4a's float32 products against the composite scan's, through 2
#: layers and the decoder), largest error over the largest |logit|; from
#: readings (chip_smoke_faults.py --phase 29, H100 80GB HBM3 at 700 W):
#: on the card the sound replays read 4.17e-7 in every run, K4a given wh
#: rounded to bf16 7.55e-4 and a reversed scan 1.21. The fresh process's
#: replay on the CPU (the plain scan) read 4.59e-7 in 19 fresh processes
#: on the card's host and 2.33e-5 in one, for a cause not found: its bits
#: are the same at every torch thread count from 1 to 8 and in every
#: fresh process at the default count or at one thread
#: (tools/lm_replay_probe.py); given wh rounded to bf16 it reads 7.55e-4.
#: Its limit lies between those readings
LM_EXPORT_RTOL = 1e-5
LM_EXPORT_CPU_RTOL = 1e-4
#: 29c: user kernels through rtc.CudaModule, on RTC_N float32 elements
#: (the saxpy's 2^26); the block sum over a [RTC_ROWS, RTC_N / RTC_ROWS]
#: matrix in tiles of RTC_TILE floats (64 KB of dynamic shared memory a
#: block, so the launch opts in past 48 KB) on a 2-D grid
RTC_N, RTC_ROWS, RTC_TILE = 1 << 26, 64, 16384
#: the block sum against the float64 sum of its tile: within this share of
#: the tile's sum of |x| (each thread adds 16 values in order, then a
#: 10-level tree: about 26 roundings of float32 on the way)
RTC_SUM_RTOL = 1e-5
RTC_SOURCE = r"""
extern "C" __global__ void double_it(const float *x, float *y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

extern "C" __global__ void saxpy(const float *x, float *y, float a,
                                 int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = a * x[i] + y[i];
}

// out[row, tile]: the sum of one tile of `tile` floats of row blockIdx.y,
// staged through dynamic shared memory, then a tree over the threads
extern "C" __global__ void block_sum(const float *x, float *out, int cols,
                                     int tile) {
  extern __shared__ float buf[];
  const float *src = x + (long long)blockIdx.y * cols
                       + (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) buf[i] = src[i];
  __syncthreads();
  float s = 0.f;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s += buf[i];
  __syncthreads();
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = buf[0];
}
"""
#: (kernel, C signature) of RTC_SOURCE, in the kernels line's order
RTC_KERNELS = (("double_it", "const float *x, float *y, int n"),
               ("saxpy", "const float *x, float *y, float a, int n"),
               ("block_sum", "const float *x, float *out, int cols, "
                             "int tile"))
RTC_SAXPY_A = 0.75
#: the saxpy against its plain version y + a * x: within this many eps of
#: |a x| + |y|. The kernel's fused multiply-add rounds once and the plain
#: version twice (the product, then the sum), so the two differ by at most
#: (eps/2)(2 |a x + y| + |a x|) <= 1.5 eps (|a x| + |y|)
RTC_SAXPY_ULPS = 1.5
#: 29d: a torch.nn conv + BatchNorm + linear module inside a Gluon net,
#: trained this many SGD steps (lr) at this batch of 3 x 32 x 32 images
#: against the same module trained by torch.optim.SGD: every parameter
#: and buffer within TORCHBLOCK_TOL of the largest |value|
TORCHBLOCK_STEPS, TORCHBLOCK_LR, TORCHBLOCK_BATCH = 5, 0.1, 64
TORCHBLOCK_TOL = 1e-5
#: 29e: the ONNX residual block on the card against the CPU (cuDNN's
#: float32 convolutions, TF32 off, in another order than the CPU's)
ONNX_CARD_RTOL = 1e-5


def deploy_forward_ms(torch, fn, n=DEPLOY_TIMED):
    """Mean host ms of `fn()` over n calls, each ending in a synchronize,
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * sum(times) / n


def max_rel(torch, got, want):
    """Largest |got - want| over the largest |want|."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def phase_deploy_resnet(torch, np, mx, dev, card, tmp, keep=None):
    """29a: resnet50_v1 (1000 classes, random Xavier weights from seed 29)
    exported with predict.export_model on the card and replayed with
    load_exported; a Predictor built from the net's own export
    (phase 14b's route: symbol JSON + params); both held to the net's
    eval logits within EXPORT_RTOL of the largest |logit|;
    batch_predict over DEPLOY_SAMPLES single images; img/s of each route
    beside the eager and the hybridized net. With `keep` (a directory)
    the artifact, its input and the replay's logits are copied there for
    phase 30b, whose paths and export seconds `out["carry"]` gives."""
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ctx = mx.gpu(dev.index or 0)
    mx.random.seed(DEPLOY_SEED)
    torch.manual_seed(DEPLOY_SEED)
    with mx.name.NameManager():
        net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier())
    shape = (DEPLOY_BATCH, 3, R50_IMAGE, R50_IMAGE)
    rng = np.random.RandomState(DEPLOY_SEED)
    x_np = rng.standard_normal(shape).astype(np.float32)
    x = mx.nd.array(x_np)
    want = net(x)._data
    art = os.path.join(tmp, "resnet50.mxtpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict.export_model(net, [("data", shape)], art)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = predict.load_exported(art, ctx=ctx)
    load_s = time.perf_counter() - t0
    check(served.device == dev, "load_exported put the program on %s"
          % served.device)
    got_art = served.forward(data=x)[0]._data
    check(got_art.device == dev, "the artifact's logits are on %s"
          % got_art.device)
    net.hybridize()
    net(x)
    prefix = os.path.join(tmp, "resnet50")
    net.export(prefix, epoch=0)
    with open(prefix + "-symbol.json") as f:
        pred = mx.Predictor(f.read(), prefix + "-0000.params",
                            {"data": shape}, ctx=ctx)
    got_pred = pred.forward(data=x)[0]._data
    errs = {"artifact": max_rel(torch, got_art, want),
            "predictor": max_rel(torch, got_pred, want)}
    for what, e in errs.items():
        check(e <= EXPORT_RTOL, "29a %s: logits off by %.3g of the largest "
              "|logit| (> %g)" % (what, e, EXPORT_RTOL))
    samples = [x_np[i % DEPLOY_BATCH] for i in range(DEPLOY_SAMPLES)]
    t0 = time.perf_counter()
    outs = served.predict(samples)
    torch.cuda.synchronize()
    batch_predict_s = time.perf_counter() - t0
    check(len(outs) == DEPLOY_SAMPLES and outs[0].shape == (1000,),
          "batch_predict gave %d rows of %s" % (len(outs), outs[0].shape))
    want_np = want.float().cpu().numpy()
    bp_err = max(float(np.abs(o - want_np[i % DEPLOY_BATCH]).max())
                 for i, o in enumerate(outs)) / float(np.abs(want_np).max())
    check(bp_err <= EXPORT_RTOL, "29a batch_predict: rows off by %.3g"
          % bp_err)
    net.hybridize(False)
    routes = {"eager": lambda: net(x),
              "artifact": lambda: served.forward(data=x),
              "predictor": lambda: pred.forward(data=x)}
    ms = {k: deploy_forward_ms(torch, fn) for k, fn in routes.items()}
    net.hybridize()
    ms["hybridized"] = deploy_forward_ms(torch, lambda: net(x))
    out = {"card": card, "model": "resnet50_v1", "batch": DEPLOY_BATCH,
           "image": R50_IMAGE, "dtype": "float32",
           "logit_err_over_max": errs, "export_s": export_s,
           "load_s": load_s, "artifact_bytes": os.path.getsize(art),
           "batch_predict": {"samples": DEPLOY_SAMPLES,
                             "calls": -(-DEPLOY_SAMPLES // DEPLOY_BATCH),
                             "s": batch_predict_s,
                             "img_per_s": DEPLOY_SAMPLES / batch_predict_s,
                             "err_over_max": bp_err},
           "forward_ms": ms,
           "img_per_s": {k: DEPLOY_BATCH / (v / 1e3)
                         for k, v in ms.items()}}
    print("deploy 29a resnet50 artifact (%s): %s" % (card, json.dumps(out)))
    if keep is not None:
        carry = {"art": os.path.join(keep, "resnet50.mxtpu"),
                 "x": os.path.join(keep, "x.npy"),
                 "replay": os.path.join(keep, "replay.npy"),
                 "export_s": export_s, "replay_ms": ms["artifact"]}
        shutil.copyfile(art, carry["art"])
        np.save(carry["x"], x_np)
        np.save(carry["replay"], got_art.float().cpu().numpy())
        out["carry"] = carry
    return out


#: run in a fresh process by phase 29b (argv: artifact, input .npy,
#: output .npz, the card's device, torch's CPU threads or 0 for its
#: default): load the artifact with torch and the op's registration only,
#: replay on the card (counting K4a) and on the CPU (K4a's plain
#: version), save both
LM_REPLAY = r"""
import io, json, sys, zipfile
import numpy as np
import torch
import torch.export.passes
from mxnet_tpu_torch.ops import fused_rnn
art, x_path, out_path, card, threads = sys.argv[1:6]
if int(threads):
    torch.set_num_threads(int(threads))
blob = zipfile.ZipFile(art).read("model.pt2")
x = torch.from_numpy(np.load(x_path))
res = {}
for where, dev in (("card", card), ("cpu", "cpu")):
    prog = torch.export.passes.move_to_device_pass(
        torch.export.load(io.BytesIO(blob)), dev)
    fused_rnn.reset_launch_counts()
    with torch.no_grad():
        y = prog.module()(x.to(dev))[0].float().cpu().numpy()
    res[where] = (y, fused_rnn.launch_counts())
np.savez(out_path, card=res["card"][0], cpu=res["cpu"][0])
print(json.dumps({"launches": {d: r[1] for d, r in res.items()},
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith(("mxnet", "jax"))
                                    and m.count(".") == 0)}))
"""


def lm_export(torch, np, mx, dev, tmp):
    """29b's word LM (phase 11's width, Xavier weights from DEPLOY_SEED,
    no dropout) on `dev` and its input, exported with export_model under
    the caller's MXNET_FUSED_RNN: (net, input as numpy, the artifact's
    path, export seconds)."""
    from mxnet_tpu_torch import predict
    mx.random.seed(DEPLOY_SEED)
    net = word_lm_net(torch, mx, dev, 0.0)
    rng = np.random.RandomState(DEPLOY_SEED)
    x_np = rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH)).astype(np.float32)
    art = os.path.join(tmp, "word_lm.mxtpu")
    _sync(torch, dev)
    t0 = time.perf_counter()
    predict.export_model(net, [("data", (LM_BPTT, LM_BATCH))], art)
    return net, x_np, art, time.perf_counter() - t0


def lm_fresh_replay(np, art, x_np, tmp, dev, threads=0):
    """LM_REPLAY in a fresh process on artifact `art` and input `x_np`
    (torch's CPU threads `threads`, 0 for its default): (its JSON line,
    its logits {"card", "cpu"}). Fails the phase if the process does."""
    x_path, out_path = (os.path.join(tmp, n) for n in ("x.npy", "y.npz"))
    np.save(x_path, x_np)
    proc = subprocess.run(
        [sys.executable, "-c", LM_REPLAY, art, x_path, out_path, str(dev),
         str(threads)], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, "29b fresh-process replay failed (rc %d): "
          "%s" % (proc.returncode, proc.stderr[-2000:]))
    ys = np.load(out_path)
    return (json.loads(proc.stdout.strip().splitlines()[-1]),
            {d: ys[d] for d in ("card", "cpu")})


def lm_err(np, got, want):
    """Largest |got - want| over the largest |want| (numpy arrays)."""
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def phase_deploy_word_lm(torch, np, mx, dev, card, tmp):
    """29b: the word LM at phase 11's width (vocab 10000, embed and hidden
    200, 2 layers, bptt 35 x batch 32, float32) exported with
    MXNET_FUSED_RNN=1: its graph holds LM_LAYERS `mxnet_tpu_torch::
    rnn_fwd` nodes, one replay launches K4a LM_LAYERS times (and K4b
    none), its logits lie within LM_EXPORT_RTOL of the eager net's with
    the flag off; the artifact reloads in a fresh process (torch and the
    op's registration), on the card with the same K4a launches and on the
    CPU through the plain version (within LM_EXPORT_CPU_RTOL). Returns
    (the replay's (K4a, K4b) launches, the summary)."""
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.ops import fused_rnn as fr
    ctx = mx.gpu(dev.index or 0)
    prior = os.environ.get("MXNET_FUSED_RNN")
    try:
        os.environ["MXNET_FUSED_RNN"] = "1"
        net, x_np, art, export_s = lm_export(torch, np, mx, dev, tmp)
        x = mx.nd.array(x_np)
        served = predict.load_exported(art, ctx=ctx)
        nodes = sum(1 for n in served.program.graph.nodes if n.target is
                    torch.ops.mxnet_tpu_torch.rnn_fwd.default)
        check(nodes == LM_LAYERS, "29b: the exported graph holds %d "
              "rnn_fwd nodes, expected %d" % (nodes, LM_LAYERS))
        torch.cuda.synchronize()
        fr.reset_launch_counts()
        got = served.forward(data=x)[0]._data
        torch.cuda.synchronize()
        launches = fr.launch_counts()
        check(launches == (LM_LAYERS, 0), "29b: one replay launched K4a/"
              "K4b %r, expected (%d, 0)" % (launches, LM_LAYERS))
        replay_ms = deploy_forward_ms(torch, lambda: served.forward(data=x))
        eager_on_ms = deploy_forward_ms(torch, lambda: net(x))
        os.environ["MXNET_FUSED_RNN"] = "0"
        want = net(x)._data
        eager_off_ms = deploy_forward_ms(torch, lambda: net(x))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    errs = {"replay": max_rel(torch, got, want)}
    t0 = time.perf_counter()
    fresh, ys = lm_fresh_replay(np, art, x_np, tmp, dev)
    fresh_s = time.perf_counter() - t0
    check(tuple(fresh["launches"]["card"]) == (LM_LAYERS, 0),
          "29b fresh process launched K4a/K4b %r on the card"
          % (fresh["launches"]["card"],))
    check(tuple(fresh["launches"]["cpu"]) == (0, 0),
          "29b fresh process launched a kernel on the CPU: %r"
          % (fresh["launches"]["cpu"],))
    check(fresh["modules"] == ["mxnet_tpu_torch"], "29b fresh process "
          "imported %r" % (fresh["modules"],))
    want_np = want.float().cpu().numpy()
    for d in ("card", "cpu"):
        errs["fresh_" + d] = lm_err(np, ys[d], want_np)
    for what, e in errs.items():
        limit = LM_EXPORT_CPU_RTOL if what == "fresh_cpu" else \
            LM_EXPORT_RTOL
        check(e <= limit, "29b %s: logits off by %.3g of the largest "
              "|logit| (> %g)" % (what, e, limit))
    out = {"card": card, "model": "RNNModel lstm", "vocab": LM_VOCAB,
           "hidden": LM_HIDDEN, "layers": LM_LAYERS, "bptt": LM_BPTT,
           "batch": LM_BATCH, "dtype": "float32", "export_s": export_s,
           "rnn_fwd_nodes": nodes, "k4_launches_a_replay": launches,
           "logit_err_over_max": errs, "limit": LM_EXPORT_RTOL,
           "cpu_limit": LM_EXPORT_CPU_RTOL,
           "forward_ms": {"artifact": replay_ms, "eager_fused": eager_on_ms,
                          "eager_composite": eager_off_ms},
           "fresh_process": {"s": fresh_s,
                             "launches": fresh["launches"],
                             "packages": fresh["modules"]}}
    print("deploy 29b word LM through K4a (%s): %s" % (card, json.dumps(out)))
    return launches, out


def rtc_inputs(torch, dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(n, device=dev, generator=g),
            torch.randn(n, device=dev, generator=g))


def rtc_run(torch, mx, dev, n=RTC_N, rows=RTC_ROWS, tile=RTC_TILE,
            kernels=None):
    """The three RTC_KERNELS compiled by rtc.CudaModule (or given as
    `kernels`) and launched once each on n float32 elements through
    CudaKernel.launch: ({name: (launch closure, plain closure, library
    closure, bytes moved)}, {name: error against the plain version beside
    its limit}, compile ms). Raises on a disagreement: double_it bit for
    bit, saxpy within RTC_SAXPY_ULPS eps of |a x| + |y| (the kernel fuses
    the multiply-add), block_sum within RTC_SUM_RTOL of each tile's sum of
    |x| against the float64 sum."""
    from mxnet_tpu_torch import rtc
    ctx = mx.gpu(dev.index or 0)
    compile_ms = None
    if kernels is None:
        t0 = time.perf_counter()
        module = rtc.CudaModule(RTC_SOURCE)
        compile_ms = 1e3 * (time.perf_counter() - t0)
        kernels = {name: module.get_kernel(name, sig)
                   for name, sig in RTC_KERNELS}
    x, y = rtc_inputs(torch, dev, n, DEPLOY_SEED)
    X, Y = mx.nd.NDArray(x), mx.nd.NDArray(y.clone())
    out2 = mx.nd.NDArray(torch.empty_like(x))
    cols = n // rows
    sums = mx.nd.NDArray(torch.empty((rows, cols // tile), device=dev))
    lin = (-(-n // 256),), (256,)
    grid2 = (cols // tile, rows)
    a = RTC_SAXPY_A
    calls = {
        "double_it": (lambda: kernels["double_it"].launch(
            [X, out2, n], ctx, *lin),
            lambda: x + x, lambda: torch.mul(x, 2.0), 8 * n),
        "saxpy": (lambda: kernels["saxpy"].launch([X, Y, a, n], ctx, *lin),
                  lambda: y + a * x, lambda: torch.add(y, x, alpha=a),
                  12 * n),
        "block_sum": (lambda: kernels["block_sum"].launch(
            [X, sums, cols, tile], ctx, grid2, (1024,), shared_mem=4 * tile),
            lambda: x.view(rows, -1, tile).double().sum(-1),
            lambda: torch.sum(x.view(rows, -1, tile), dim=-1),
            4 * n + 4 * rows * (cols // tile)),
    }
    for fn, _, _, _ in calls.values():
        fn()
    torch.cuda.synchronize()
    # name: (largest |kernel - plain|, the checked measure, its limit)
    diff = (out2._data - (x + x)).abs()
    errs = {"double_it": (float(diff.max()), float(diff.max()), 0.0)}
    diff = (Y._data - (y + a * x)).abs()
    ulp = torch.finfo(torch.float32).eps * ((a * x).abs() + y.abs())
    errs["saxpy"] = (float(diff.max()), float((diff / ulp).max()),
                     RTC_SAXPY_ULPS)
    tiles = x.view(rows, -1, tile).double()
    diff = (sums._data.double() - tiles.sum(-1)).abs()
    errs["block_sum"] = (float(diff.max()), float(
        (diff / tiles.abs().sum(-1)).max()), RTC_SUM_RTOL)
    for name, (_, e, limit) in errs.items():
        check(e <= limit, "rtc %s against its plain version: %.3g (limit "
              "%g)" % (name, e, limit))
    return calls, kernels, errs, compile_ms


def phase_rtc(torch, np, mx, dev, card):
    """29c: K5, user CUDA kernels through rtc.CudaModule (NVRTC for
    sm_90a, launched through libcuda on torch's stream): the three RTC_KERNELS
    launched once each and held to their plain versions (rtc_run), each
    kernel's launches counted over that run; then each timed beside its
    bytes bound, its plain version and the one PyTorch call computing the
    same function (torch.mul, torch.add with alpha, torch.sum). Returns
    the kernels line's rows."""
    calls, kernels, errs, compile_ms = rtc_run(torch, mx, dev)
    launches = {name: k.launches for name, k in kernels.items()}
    check(all(c == 1 for c in launches.values()),
          "rtc kernels launched %r in the checked run, expected 1 each"
          % launches)
    rows = []
    for name, (fn, plain, library, nbytes) in calls.items():
        bound = 1e3 * nbytes / HBM_BYTES_S
        rows.append({
            "name": "rtc_" + name, "route": "cuda",
            "source": "chip_smoke.py (RTC_SOURCE, compiled by "
                      "mxnet_tpu_torch/rtc.py)",
            "replaces": "mxnet_tpu/rtc.py:46",
            "launches": launches[name],
            "launches_by_path": {"rtc_phase29c": launches[name]},
            "max_abs_err": errs[name][0], "checked_err": errs[name][1],
            "limit": errs[name][2],
            "ms": time_ms(torch, fn, n=20),
            "plain_ms": time_ms(torch, plain, n=20),
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": time_ms(torch, library, n=20)})
    out = {"card": card, "compile_ms": compile_ms,
           "n": RTC_N, "rows": {r["name"]: {k: r[k] for k in (
               "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
               "checked_err", "limit")} for r in rows}}
    print("rtc 29c K5 (%s): %s" % (card, json.dumps(out)))
    return rows, out


def torchblock_module(torch):
    """The conv + BatchNorm + linear torch module of phase 29d."""
    torch.manual_seed(DEPLOY_SEED)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.BatchNorm2d(16),
        torch.nn.ReLU(), torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(16, 32))


def phase_torchblock(torch, np, mx, dev, card, tmp):
    """29d: the torch module inside a Gluon net (TorchBlock, then a Gluon
    Dense(10)), trained TORCHBLOCK_STEPS steps by gluon.Trainer SGD on a
    mean squared error, against the same module and a torch Linear with
    the Dense's weights trained by torch.optim.SGD: losses, parameters and
    BatchNorm buffers within TORCHBLOCK_TOL; the Parameters live on the
    card and are the module's tensors; the trained block's BatchNorm
    buffers round-trip save_params / load_params into a fresh block with
    the same eval output."""
    import copy
    from mxnet_tpu_torch.plugin import TorchBlock
    ctx = mx.gpu(dev.index or 0)
    tmod = torchblock_module(torch).to(dev)
    twin = copy.deepcopy(tmod)
    with mx.name.NameManager():
        net = mx.gluon.nn.Sequential()
        tb = TorchBlock(tmod, ctx=ctx)
        net.add(tb, mx.gluon.nn.Dense(10, in_units=32))
    net[1].initialize(mx.init.Xavier(), ctx=ctx)
    check(all(p.data()._data.device == dev
              for p in net.collect_params().values()),
          "29d: a Parameter is off the card")
    head = torch.nn.Linear(32, 10).to(dev)
    with torch.no_grad():
        head.weight.copy_(net[1].weight.data()._data)
        head.bias.copy_(net[1].bias.data()._data)
    ref = torch.nn.Sequential(twin, head)
    g = torch.Generator(device=dev).manual_seed(DEPLOY_SEED)
    x = torch.randn(TORCHBLOCK_BATCH, 3, 32, 32, device=dev, generator=g)
    y = torch.randn(TORCHBLOCK_BATCH, 10, device=dev, generator=g)
    X, Y = mx.nd.NDArray(x), mx.nd.NDArray(y)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TORCHBLOCK_LR})
    opt = torch.optim.SGD(ref.parameters(), lr=TORCHBLOCK_LR)
    losses, ref_losses = [], []
    t0 = time.perf_counter()
    for _ in range(TORCHBLOCK_STEPS):
        with mx.autograd.record():
            L = mx.nd.mean(mx.nd.square(net(X) - Y))
        L.backward()
        trainer.step(1)
        losses.append(float(L.asnumpy()))
    torch.cuda.synchronize()
    gluon_s = time.perf_counter() - t0
    ref.train()
    for _ in range(TORCHBLOCK_STEPS):
        opt.zero_grad()
        loss = ((ref(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        ref_losses.append(float(loss.detach()))
    errs = {"loss": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses))}
    state = dict(ref.state_dict())
    names = dict(tb._names)
    for pname, p in tb.collect_params().items():
        key = "0." + names[pname[len(tb.prefix):]]
        errs[pname] = max_rel(torch, p.data()._data, state[key])
    for p, key in ((net[1].weight, "1.weight"), (net[1].bias, "1.bias")):
        errs[p.name] = max_rel(torch, p.data()._data, state[key])
    bad = {k: e for k, e in errs.items() if not e <= TORCHBLOCK_TOL}
    check(not bad, "29d TorchBlock against torch.optim.SGD: %r (limit %g)"
          % (bad, TORCHBLOCK_TOL))
    path = os.path.join(tmp, "torchblock.params")
    tb.save_params(path)
    tb2 = TorchBlock(torchblock_module(torch), ctx=ctx)
    tb2.load_params(path, ctx=ctx)
    for pname, p in tb2.collect_params().items():
        src = tb.collect_params()[tb.prefix + pname[len(tb2.prefix):]]
        check(torch.equal(p.data()._data, src.data()._data),
              "29d: %s did not round-trip the checkpoint" % pname)
    check(torch.equal(tb2(X)._data, tb(X)._data),
          "29d: the reloaded block's eval output differs")
    out = {"card": card, "steps": TORCHBLOCK_STEPS, "batch":
           TORCHBLOCK_BATCH, "losses": losses, "torch_losses": ref_losses,
           "largest_err": max(errs.values()), "limit": TORCHBLOCK_TOL,
           "gluon_loop_s": gluon_s,
           "buffers_checkpointed": sorted(n for n in names.values()
                                          if "running" in n
                                          or "num_batches" in n)}
    print("torchblock 29d (%s): %s" % (card, json.dumps(out)))
    return out


def onnx_tensor(wire, name, arr):
    """An ONNX TensorProto (float32 or int64, raw data), encoded as
    tests/test_onnx.py's t_proto does."""
    code = {"float32": 1, "int64": 7}[str(arr.dtype)]
    return (wire.packed_varints(1, list(arr.shape)) +
            wire.field_varint(2, code) + wire.field_bytes(8, name) +
            wire.field_bytes(9, arr.tobytes()))


def onnx_node(wire, op_type, inputs, outputs, **attrs):
    """An ONNX NodeProto with int, float and int-list attributes."""
    out = b"".join(wire.field_bytes(1, i) for i in inputs)
    out += b"".join(wire.field_bytes(2, o) for o in outputs)
    out += wire.field_bytes(4, op_type)
    for k, v in attrs.items():
        a = wire.field_bytes(1, k)
        if isinstance(v, float):
            a += wire.field_fixed32(2, v) + wire.field_varint(20, 1)
        elif isinstance(v, int):
            a += wire.field_varint(3, v) + wire.field_varint(20, 2)
        else:
            a += wire.packed_varints(8, list(v)) + wire.field_varint(20, 7)
        out += wire.field_bytes(5, a)
    return out


def onnx_model(wire, nodes, initializers, inputs, outputs, opset=13):
    """An ONNX ModelProto: the graph's nodes, initializers and typed
    (float32) inputs and outputs."""
    def vinfo(name, shape):
        dims = b"".join(wire.field_bytes(1, wire.field_varint(1, d))
                        for d in shape)
        tensor = wire.field_varint(1, 1) + wire.field_bytes(2, dims)
        return wire.field_bytes(1, name) + \
            wire.field_bytes(2, wire.field_bytes(1, tensor))
    graph = b"".join(wire.field_bytes(1, n) for n in nodes)
    graph += b"".join(wire.field_bytes(5, onnx_tensor(wire, k, v))
                      for k, v in initializers.items())
    graph += b"".join(wire.field_bytes(11, vinfo(n, s)) for n, s in inputs)
    graph += b"".join(wire.field_bytes(12, vinfo(n, s)) for n, s in outputs)
    opset_msg = wire.field_bytes(1, "") + wire.field_varint(2, opset)
    return (wire.field_varint(1, 8) + wire.field_bytes(7, graph) +
            wire.field_bytes(8, opset_msg))


def onnx_resnet_block(np, wire, C=4, seed=3):
    """tests/test_onnx.py:125's residual unit, hand-encoded: Conv-Relu,
    Conv-BatchNorm-Relu, Conv, the identity add, Relu, global average
    pool, Flatten, Gemm to 10 classes, over a (2, 3, 8, 8) input. Returns
    (model bytes, a seeded input)."""
    rng = np.random.RandomState(seed)
    inits = {"c0w": (rng.randn(C, 3, 3, 3) * 0.2).astype(np.float32),
             "c1w": (rng.randn(C, C, 3, 3) * 0.2).astype(np.float32),
             "c2w": (rng.randn(C, C, 3, 3) * 0.2).astype(np.float32),
             "g": rng.rand(C).astype(np.float32) + 0.5,
             "be": rng.randn(C).astype(np.float32),
             "mu": rng.randn(C).astype(np.float32) * 0.1,
             "va": rng.rand(C).astype(np.float32) + 0.5,
             "fw": rng.randn(10, C).astype(np.float32),
             "fb": rng.randn(10).astype(np.float32)}
    conv = dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    nodes = [onnx_node(wire, "Conv", ["x", "c0w"], ["t0"], **conv),
             onnx_node(wire, "Relu", ["t0"], ["r0"]),
             onnx_node(wire, "Conv", ["r0", "c1w"], ["t1"], **conv),
             onnx_node(wire, "BatchNormalization",
                       ["t1", "g", "be", "mu", "va"], ["bn1"],
                       epsilon=1e-5),
             onnx_node(wire, "Relu", ["bn1"], ["r1"]),
             onnx_node(wire, "Conv", ["r1", "c2w"], ["t2"], **conv),
             onnx_node(wire, "Add", ["t2", "r0"], ["sum"]),
             onnx_node(wire, "Relu", ["sum"], ["r2"]),
             onnx_node(wire, "GlobalAveragePool", ["r2"], ["gap"]),
             onnx_node(wire, "Flatten", ["gap"], ["flat"]),
             onnx_node(wire, "Gemm", ["flat", "fw", "fb"], ["y"], transB=1)]
    blob = onnx_model(wire, nodes, inits, [("x", (2, 3, 8, 8))],
                      [("y", (2, 10))])
    return blob, rng.randn(2, 3, 8, 8).astype(np.float32)


def onnx_run(mx, path, x, ctx):
    """The imported model bound on `ctx` and run on `x`: its output."""
    from mxnet_tpu_torch.contrib import onnx
    sym, args, auxs = onnx.import_model(path)
    ex = sym.bind(ctx, dict({k: v.as_in_context(ctx)
                             for k, v in args.items()},
                            x=mx.nd.array(x, ctx=ctx)),
                  aux_states={k: v.as_in_context(ctx)
                              for k, v in auxs.items()})
    return ex.forward(is_train=False)[0]._data


def phase_onnx(torch, np, mx, dev, card, tmp):
    """29e: the residual block of tests/test_onnx.py:125, hand-encoded
    through the port's wire codec, imported by contrib.onnx.import_model
    and run on the card against the same import run on the CPU, within
    ONNX_CARD_RTOL of the largest |output|."""
    from mxnet_tpu_torch.contrib.onnx import wire
    blob, x = onnx_resnet_block(np, wire)
    path = os.path.join(tmp, "block.onnx")
    with open(path, "wb") as f:
        f.write(blob)
    got = onnx_run(mx, path, x, mx.gpu(dev.index or 0))
    check(got.device == dev, "29e: the output is on %s" % got.device)
    with mx.cpu():
        want = onnx_run(mx, path, x, mx.cpu())
    err = max_rel(torch, got.cpu(), want)
    check(err <= ONNX_CARD_RTOL, "29e: the card's output is off the CPU's "
          "by %.3g of the largest |output| (> %g)" % (err, ONNX_CARD_RTOL))
    out = {"card": card, "model": "onnx residual block", "bytes": len(blob),
           "err_over_max": err, "limit": ONNX_CARD_RTOL}
    print("onnx 29e (%s): %s" % (card, json.dumps(out)))
    return out


def phase_deploy(torch, np, dev, card, keep=None):
    """Phase 29 (module docstring): ResNet-50 served from an artifact
    (29a; kept in `keep` for phase 30b when given), the word LM exported
    through K4a (29b), user kernels through rtc (29c, K5), TorchBlock
    (29d), ONNX import (29e). Returns (29b's K4a and K4b launches, 29c's
    kernels-line rows, the summary)."""
    import mxnet_tpu_torch as mx
    out = {"card": card}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, mx.gpu(dev.index or 0):
        out["29a"] = phase_deploy_resnet(torch, np, mx, dev, card, tmp,
                                         keep)
        torch.cuda.empty_cache()
        lm_launches, out["29b"] = phase_deploy_word_lm(torch, np, mx, dev,
                                                       card, tmp)
        rtc_rows, out["29c"] = phase_rtc(torch, np, mx, dev, card)
        torch.cuda.empty_cache()
        out["29d"] = phase_torchblock(torch, np, mx, dev, card, tmp)
        out["29e"] = phase_onnx(torch, np, mx, dev, card, tmp)
    out["s"] = time.perf_counter() - t0
    print("deployment phase 29 (%s): %.1f s" % (card, out["s"]))
    return lm_launches, rtc_rows, out


# ---------------------------------------------------------------------------
# phase 30: the C++ deployment half (ROADMAP item 14 (a)): the C++ tree on
# libtorch, K4a as a C++ op inside an AOTInductor package, the C predict
# API, export_train_step driven by mxtpu_train, the native runtime
# ---------------------------------------------------------------------------

CPP_SEED = 30
#: 30a: the C++ rnn_design against fused_rnn.rnn_design: the word LM's
#: layer in both dtypes, then layers that take the cluster design (several
#: waves, the largest H) and the streaming one (tiny layers, past the
#: cluster limit, H 1024)
CPP_DESIGN_CASES = (
    ("lstm", LM_BATCH, LM_HIDDEN, "float32"),
    ("lstm", LM_BATCH, LM_HIDDEN, "bfloat16"),
    ("lstm", 300, 256, "bfloat16"), ("rnn_tanh", 300, 128, "float32"),
    ("lstm", 33, 128, "bfloat16"), ("rnn_relu", 64, 512, "float32"),
    ("lstm", 8, 16, "float32"), ("rnn_tanh", 4, 64, "bfloat16"),
    ("lstm", LM_BATCH, 272, "float32"), ("rnn_relu", 7, 1024, "float32"))
#: 30b: C++ forwards timed (after one), and the LeNet batch through the
#: C API
CPP_TIMED, CPP_LENET_BATCH = 20, 100
#: 30b's ResNet-50 (phase 29a's artifact): C++ forwards timed (after one)
CPP_R50_TIMED = 10
#: 30c: BASELINE config 1's MLP (models/lenet.py get_mlp: 784 -> 128 relu
#: -> 64 relu -> 10) at batch 100, SGD lr 0.1 momentum 0.9, CPP_STEPS
#: steps in C++; the first CPP_HELD losses held to TrainStep's within
#: CPP_TRAIN_RTOL (relative)
CPP_MLP_BATCH, CPP_STEPS, CPP_HELD, CPP_TRAIN_LR = 100, 50, 5, 0.1
CPP_TRAIN_RTOL = 1e-5
#: 30d: NativeEngine tasks, RecWriter -> RecReader records, and the
#: ImageRecordIter pack: JPEGs of CPP_IMG_SIDE at data_shape (3, 224, 224),
#: batch 256
CPP_ENGINE_TASKS, CPP_RECORDS = 200, 10000
CPP_JPEGS, CPP_IMG_SIDE, CPP_IMG_BATCH = 512, 256, 256

#: run in a fresh process by phase 30a (argv: libmxtpu_torch_ops.so, JSON
#: cases [mode code, N, H, dtype code]): the C++ rnn_design of each, asked
#: through ctypes with nothing of torch or the port imported
CPP_DESIGN_QUERY = r"""
import ctypes, json, sys
lib = ctypes.CDLL(sys.argv[1])
lib.mxtpu_rnn_design.argtypes = [ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
lib.mxtpu_rnn_last_error.restype = ctypes.c_char_p
out = []
for mode, N, H, dtype in json.loads(sys.argv[2]):
    P, rows, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if lib.mxtpu_rnn_design(dtype, mode, N, H, ctypes.byref(P),
                            ctypes.byref(rows), ctypes.byref(blocks)) != 0:
        sys.exit("mxtpu_rnn_design failed: %s"
                 % lib.mxtpu_rnn_last_error().decode())
    out.append([P.value, rows.value, blocks.value])
print(json.dumps({"designs": out,
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith(("torch", "mxnet")))}))
"""

#: run in a fresh process by phase 30b and the CPU tests (argv:
#: libmxtpu_predict.so, artifact, device, raw float32 input, output path,
#: timed forwards): the C API's calls in the reference's order, through
#: ctypes with nothing of torch or the port imported; a bad size and a bad
#: index must return -1 with a message; prints one JSON line
C_API_CLIENT = r"""
import ctypes, json, sys, time
lib_path, art, device, x_path, out_path, timed = sys.argv[1:7]
lib = ctypes.CDLL(lib_path)
lib.MXTPUPredGetLastError.restype = ctypes.c_char_p
H, I64P = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)

def ok(rc, what):
    if rc != 0:
        sys.exit("%s failed: %s"
                 % (what, lib.MXTPUPredGetLastError().decode()))

def shape(fn, h, i):
    data, nd, dt = I64P(), ctypes.c_int(), ctypes.c_char_p()
    ok(fn(h, i, ctypes.byref(data), ctypes.byref(nd), ctypes.byref(dt)),
       "shape")
    return [data[k] for k in range(nd.value)], dt.value.decode()

h = H()
ok(lib.MXTPUPredCreate(art.encode(), device.encode(), None, 0,
                       ctypes.byref(h)), "MXTPUPredCreate")
plat = ctypes.c_char_p()
ok(lib.MXTPUPredGetPlatform(h, ctypes.byref(plat)), "platform")
n_in, n_out = ctypes.c_int(), ctypes.c_int()
ok(lib.MXTPUPredGetInputCount(h, ctypes.byref(n_in)), "inputs")
ok(lib.MXTPUPredGetOutputCount(h, ctypes.byref(n_out)), "outputs")
ishape, idt = shape(lib.MXTPUPredGetInputShape, h, 0)
oshape, odt = shape(lib.MXTPUPredGetOutputShape, h, 0)
n = 1
for d in ishape:
    n *= d
raw = open(x_path, "rb").read()
x = (ctypes.c_float * n).from_buffer_copy(raw)
errors = {}
for what, call in (
        ("short_input", lambda: lib.MXTPUPredSetInput(
            h, 0, x, ctypes.c_uint64(n - 1))),
        ("input_index", lambda: lib.MXTPUPredSetInput(
            h, n_in.value, x, ctypes.c_uint64(n))),
        ("forward_before_input", lambda: lib.MXTPUPredForward(h))):
    rc = call()
    errors[what] = [rc, lib.MXTPUPredGetLastError().decode()]
ok(lib.MXTPUPredSetInput(h, 0, x, ctypes.c_uint64(n)), "MXTPUPredSetInput")
ok(lib.MXTPUPredForward(h), "MXTPUPredForward")
m = 1
for d in oshape:
    m *= d
y = (ctypes.c_float * m)()
rc = lib.MXTPUPredGetOutput(h, 0, y, ctypes.c_uint64(m + 1))
errors["output_size"] = [rc, lib.MXTPUPredGetLastError().decode()]
ok(lib.MXTPUPredGetOutput(h, 0, y, ctypes.c_uint64(m)), "MXTPUPredGetOutput")
open(out_path, "wb").write(bytes(y))
times = []
for _ in range(int(timed)):
    t0 = time.perf_counter()
    ok(lib.MXTPUPredForward(h), "MXTPUPredForward")
    ok(lib.MXTPUPredGetOutput(h, 0, y, ctypes.c_uint64(m)), "GetOutput")
    times.append(time.perf_counter() - t0)
ok(lib.MXTPUPredFree(h), "MXTPUPredFree")
print(json.dumps({"platform": plat.value.decode(), "inputs": n_in.value,
                  "outputs": n_out.value, "input_shape": ishape,
                  "input_dtype": idt, "output_shape": oshape,
                  "output_dtype": odt, "errors": errors,
                  "forward_ms": 1e3 * sum(times) / max(1, len(times)),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith(("torch", "mxnet")))}))
"""


def run_cpp(argv, what, timeout=300):
    """Run one of the C++ tree's binaries or clients; its stdout. Fails the
    phase with its stderr when it exits non-zero."""
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, "%s failed (rc %d): %s"
          % (what, proc.returncode, (proc.stderr or proc.stdout)[-3000:]))
    return proc.stdout


def cpp_line(stdout, prefix):
    """The first number after `prefix` on its line of a C++ binary's
    output."""
    for line in stdout.splitlines():
        if line.startswith(prefix):
            return float(line[len(prefix):].split()[0].rstrip(","))
    raise SmokeFailure("no %r line in: %s" % (prefix, stdout[-2000:]))


def cpp_counts(stdout):
    """(the C++ op's calls, K4a's launches) of an --verbose run."""
    for line in stdout.splitlines():
        m = re.match(r"rnn_fwd calls: (\d+), K4a launches: (\d+)", line)
        if m:
            return int(m.group(1)), int(m.group(2))
    raise SmokeFailure("no rnn_fwd counts in: %s" % stdout[-2000:])


def cpp_build_timed():
    """(the C++ tree built for the card, its seconds)."""
    from mxnet_tpu_torch import cpp_package
    t0 = time.perf_counter()
    tree = cpp_package.build("cuda")
    return tree, time.perf_counter() - t0


def phase_cpp_build(torch, np, dev, card, built=None):
    """30a: the C++ tree built for the card (its seconds; `built` is
    `cpp_build_timed()`'s result when the caller built it), and the C++
    rnn_design against fused_rnn.rnn_design at CPP_DESIGN_CASES, asked in
    a fresh process that imports neither torch nor the port."""
    from mxnet_tpu_torch.ops import fused_rnn as fr
    tree, build_s = built or cpp_build_timed()
    cases = [(fr._MODE_CODE[m], N, H, fr._DTYPE_CODE[getattr(torch, d)])
             for m, N, H, d in CPP_DESIGN_CASES]
    got = json.loads(run_cpp([sys.executable, "-c", CPP_DESIGN_QUERY,
                              tree.ops_lib, json.dumps(cases)],
                             "30a C++ rnn_design").strip().splitlines()[-1])
    check(got["modules"] == [], "30a design query imported %r"
          % got["modules"])
    rows = []
    with torch.cuda.device(dev):
        for (m, N, H, d), cpp in zip(CPP_DESIGN_CASES, got["designs"]):
            py = fr.rnn_design(m, N, H, getattr(torch, d))
            rows.append({"mode": m, "N": N, "H": H, "dtype": d,
                         "design": py.name, "python": [py.P, py.rows,
                                                       py.blocks],
                         "cpp": cpp})
            check([py.P, py.rows, py.blocks] == cpp, "30a: rnn_design of "
                  "%s N=%d H=%d %s: Python %r, C++ %r"
                  % (m, N, H, d, (py.P, py.rows, py.blocks), cpp))
    names = {r["design"] for r in rows}
    check(names == {"cluster", "stream"}, "30a: the cases took %r" % names)
    out = {"card": card, "build_s": build_s, "dir": tree.dir,
           "designs": rows}
    print("cpp 30a build and rnn_design (%s): %s" % (card, json.dumps(out)))
    return tree, out


def cpp_lm_artifact(torch, np, mx, dev, tmp):
    """30b's word LM (phase 29b's export, MXNET_FUSED_RNN=1) compiled for
    the card by compile_for_cpp: (its input as numpy, the artifact, export
    seconds, compile seconds)."""
    from mxnet_tpu_torch import predict
    prior = os.environ.get("MXNET_FUSED_RNN")
    try:
        os.environ["MXNET_FUSED_RNN"] = "1"
        _, x_np, art, export_s = lm_export(torch, np, mx, dev, tmp)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    t0 = time.perf_counter()
    predict.compile_for_cpp(art, ctx=mx.gpu(dev.index or 0))
    return x_np, art, export_s, time.perf_counter() - t0


def cpp_lenet_artifact(np, mx, dev, tmp):
    """30b's Gluon LeNet (Xavier weights, seed CPP_SEED) exported and
    compiled for the card: (its input, the artifact, compile seconds)."""
    from mxnet_tpu_torch import predict
    ctx = mx.gpu(dev.index or 0)
    mx.random.seed(CPP_SEED)
    with mx.name.NameManager():
        lenet = mx.models.LeNet()
    lenet.initialize(mx.init.Xavier(), ctx=ctx)
    shape = (CPP_LENET_BATCH, 1, 28, 28)
    xl = np.random.RandomState(CPP_SEED).standard_normal(shape).astype(
        np.float32)
    lenet(mx.nd.array(xl))
    lart = os.path.join(tmp, "lenet.mxtpu")
    predict.export_model(lenet, [("data", shape)], lart)
    t0 = time.perf_counter()
    predict.compile_for_cpp(lart, ctx=ctx)
    return xl, lart, time.perf_counter() - t0


def phase_cpp_predict(torch, np, mx, tree, dev, card, tmp, lm_art=None):
    """30b: the word LM at phase 11's width (`cpp_lm_artifact`, or
    `lm_art` when the caller made it) run by mxtpu_predict: logits within
    LM_EXPORT_RTOL of the Python load_exported replay, the C++ op called
    and K4a launched LM_LAYERS times a forward, C++ ms a forward beside
    the replay's; then phase 13's Gluon LeNet at batch CPP_LENET_BATCH
    (`cpp_lenet_artifact`) through libmxtpu_predict.so's C API
    (C_API_CLIENT) against its replay within EXPORT_RTOL, with the C
    API's error returns. Returns (K4a's launches in the C++ forward, the
    summary)."""
    from mxnet_tpu_torch import predict
    ctx = mx.gpu(dev.index or 0)
    x_np, art, export_s, compile_s = lm_art or cpp_lm_artifact(
        torch, np, mx, dev, tmp)
    served = predict.load_exported(art, ctx=ctx)
    x = mx.nd.array(x_np)
    want = served.forward(data=x)[0]._data.float().cpu().numpy()
    replay_ms = deploy_forward_ms(torch, lambda: served.forward(data=x))
    x_path, out_dir = os.path.join(tmp, "lm_x.bin"), os.path.join(tmp, "lm")
    os.makedirs(out_dir, exist_ok=True)
    x_np.astype(np.float32).tofile(x_path)
    t0 = time.perf_counter()
    stdout = run_cpp([tree.mxtpu_predict, art, "--device", str(dev),
                      "--input", "0=" + x_path, "--output-dir", out_dir,
                      "--repeat", str(CPP_TIMED), "--verbose"],
                     "30b mxtpu_predict")
    proc_s = time.perf_counter() - t0
    calls, launches = cpp_counts(stdout)
    check((calls, launches) == (LM_LAYERS, LM_LAYERS), "30b: the C++ "
          "forward called the op %d times and launched K4a %d times, "
          "expected %d" % (calls, launches, LM_LAYERS))
    got = np.fromfile(os.path.join(out_dir, "out0.bin"),
                      np.float32).reshape(want.shape)
    lm_err_cpp = lm_err(np, got, want)
    check(lm_err_cpp <= LM_EXPORT_RTOL, "30b: C++ logits off by %.3g of "
          "the largest |logit| (> %g)" % (lm_err_cpp, LM_EXPORT_RTOL))
    lm = {"model": "RNNModel lstm", "vocab": LM_VOCAB, "hidden": LM_HIDDEN,
          "layers": LM_LAYERS, "bptt": LM_BPTT, "batch": LM_BATCH,
          "export_s": export_s, "compile_for_cpp_s": compile_s,
          "op_calls": calls, "k4a_launches": launches,
          "logit_err_over_max": lm_err_cpp, "limit": LM_EXPORT_RTOL,
          "cpp_forward_ms": cpp_line(stdout, "forward ms:"),
          "python_replay_ms": replay_ms, "cpp_process_s": proc_s,
          "artifact_bytes": os.path.getsize(art)}
    xl, lart, lcompile_s = cpp_lenet_artifact(np, mx, dev, tmp)
    shape = xl.shape
    lserved = predict.load_exported(lart, ctx=ctx)
    lwant = lserved.forward(data=mx.nd.array(xl))[0]._data.cpu().numpy()
    lreplay_ms = deploy_forward_ms(
        torch, lambda: lserved.forward(data=mx.nd.array(xl))[0].asnumpy())
    xl_path, yl_path = (os.path.join(tmp, n) for n in ("lx.bin", "ly.bin"))
    xl.tofile(xl_path)
    capi = json.loads(run_cpp(
        [sys.executable, "-c", C_API_CLIENT, tree.predict_lib, lart,
         str(dev), xl_path, yl_path, str(CPP_TIMED)],
        "30b C API client").strip().splitlines()[-1])
    check(capi["platform"] == "gpu" and capi["modules"] == [] and
          capi["input_shape"] == list(shape) and
          capi["output_shape"] == [CPP_LENET_BATCH, 10],
          "30b C API: %r" % capi)
    check(all(rc == -1 and msg for rc, msg in capi["errors"].values()),
          "30b C API error returns: %r" % capi["errors"])
    lgot = np.fromfile(yl_path, np.float32).reshape(lwant.shape)
    lerr = lm_err(np, lgot, lwant)
    check(lerr <= EXPORT_RTOL, "30b: C API LeNet logits off by %.3g of the "
          "largest |logit| (> %g)" % (lerr, EXPORT_RTOL))
    out = {"card": card, "word_lm": lm,
           "lenet_c_api": {"batch": CPP_LENET_BATCH,
                           "compile_for_cpp_s": lcompile_s,
                           "logit_err_over_max": lerr, "limit": EXPORT_RTOL,
                           "c_api_forward_ms": capi["forward_ms"],
                           "python_replay_ms": lreplay_ms,
                           "errors": {k: v[1] for k, v in
                                      capi["errors"].items()}}}
    print("cpp 30b predict (%s): %s" % (card, json.dumps(out)))
    return launches, out


#: phase 29a's ResNet-50 artifact compiled for the card by compile_for_cpp
#: in a process of its own (argv: artifact, device index), beside 30a's
#: g++ tree and 30b's word LM; prints the compile's seconds
R50_COMPILE = r"""
import sys, time
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import predict
t0 = time.perf_counter()
predict.compile_for_cpp(sys.argv[1], ctx=mx.gpu(int(sys.argv[2])))
print(time.perf_counter() - t0)
"""


def cpp_r50_compile(dev, r50):
    """Start R50_COMPILE on `r50["art"]` (through the run's AOT cache when
    one is configured); returns the process, which `cpp_r50_wait`
    reads."""
    from mxnet_tpu_torch import aot
    env = dict(os.environ)
    if aot.cache_dir():
        env["MXNET_AOT_CACHE_DIR"] = aot.cache_dir()
    return subprocess.Popen(
        [sys.executable, "-c", R50_COMPILE, r50["art"], str(dev.index or 0)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cpp_r50_wait(proc):
    """The compile's seconds from R50_COMPILE's process; fails the phase
    when it did."""
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, "30b: ResNet-50's compile_for_cpp failed "
          "(rc %d): %s" % (proc.returncode, err[-3000:]))
    return float(out.strip().splitlines()[-1])


def phase_cpp_resnet(np, tree, dev, card, tmp, r50, compile_s):
    """30b's ResNet-50: phase 29a's artifact (resnet50_v1 at its published
    widths, batch DEPLOY_BATCH of 224 x 224, float32, Xavier weights from
    DEPLOY_SEED) as compiled by `cpp_r50_compile`, run by mxtpu_predict
    (--repeat CPP_R50_TIMED), then one batch through the C API
    (C_API_CLIENT); both held to the Python replay of the artifact within
    EXPORT_RTOL of the largest |logit|. Prints and returns the export and
    compile seconds, the C++ and replay ms a forward and the errors."""
    want = np.load(r50["replay"])
    x_path = os.path.join(tmp, "r50_x.bin")
    np.load(r50["x"]).astype(np.float32).tofile(x_path)
    out_dir = os.path.join(tmp, "r50")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    stdout = run_cpp([tree.mxtpu_predict, r50["art"], "--device", str(dev),
                      "--input", "0=" + x_path, "--output-dir", out_dir,
                      "--repeat", str(CPP_R50_TIMED)],
                     "30b mxtpu_predict resnet50")
    proc_s = time.perf_counter() - t0
    got = np.fromfile(os.path.join(out_dir, "out0.bin"),
                      np.float32).reshape(want.shape)
    err = lm_err(np, got, want)
    check(err <= EXPORT_RTOL, "30b: C++ ResNet-50 logits off by %.3g of "
          "the largest |logit| (> %g)" % (err, EXPORT_RTOL))
    y_path = os.path.join(tmp, "r50_y.bin")
    capi = json.loads(run_cpp(
        [sys.executable, "-c", C_API_CLIENT, tree.predict_lib, r50["art"],
         str(dev), x_path, y_path, "0"],
        "30b C API client resnet50").strip().splitlines()[-1])
    check(capi["platform"] == "gpu" and capi["modules"] == [] and
          capi["output_shape"] == list(want.shape),
          "30b C API resnet50: %r" % capi)
    cerr = lm_err(np, np.fromfile(y_path, np.float32).reshape(want.shape),
                  want)
    check(cerr <= EXPORT_RTOL, "30b: C API ResNet-50 logits off by %.3g of "
          "the largest |logit| (> %g)" % (cerr, EXPORT_RTOL))
    out = {"card": card, "model": "resnet50_v1", "batch": DEPLOY_BATCH,
           "image": R50_IMAGE, "dtype": "float32",
           "export_s": r50["export_s"], "compile_for_cpp_s": compile_s,
           "cpp_forward_ms": cpp_line(stdout, "forward ms:"),
           "python_replay_ms": r50["replay_ms"], "cpp_process_s": proc_s,
           "logit_err_over_max": err, "c_api_logit_err_over_max": cerr,
           "limit": EXPORT_RTOL}
    print("cpp 30b resnet50 (%s): %s" % (card, json.dumps(out)))
    return out


def cpp_mlp(mx, ctx):
    """BASELINE config 1's MLP (get_mlp's widths) as a Gluon net."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(128, in_units=784, activation="relu"))
    net.add(mx.gluon.nn.Dense(64, in_units=128, activation="relu"))
    net.add(mx.gluon.nn.Dense(10, in_units=64))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def cpp_mlp_step(mx, ctx):
    """30c's TrainStep: the MLP (seed CPP_SEED), SGD lr CPP_TRAIN_LR,
    momentum 0.9; the same weights in any process."""
    from mxnet_tpu_torch.parallel.trainer import TrainStep
    mx.random.seed(CPP_SEED)
    with mx.name.NameManager():
        net = cpp_mlp(mx, ctx)
    return TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": CPP_TRAIN_LR, "momentum": 0.9})


def cpp_mlp_artifact(mx, dev, tmp):
    """30c's TrainStep written by export_train_step for the card, before
    any step: (the artifact, export seconds)."""
    from mxnet_tpu_torch import cpp_package, predict
    step = cpp_mlp_step(mx, mx.gpu(dev.index or 0))
    x0, y0 = cpp_package.lcg_batch(1, (CPP_MLP_BATCH, 784),
                                   (CPP_MLP_BATCH,), "int32", 10)
    art = os.path.join(tmp, "mlp_train.mxtpu")
    t0 = time.perf_counter()
    predict.export_train_step(step, x0, y0, art)
    return art, time.perf_counter() - t0


def phase_cpp_train(torch, np, mx, tree, dev, card, tmp):
    """30c: the MLP's export_train_step artifact (`cpp_mlp_artifact`), its
    initial state the step's weights (bit for bit) and zero momenta,
    CPP_STEPS steps of mxtpu_train (falling), its first CPP_HELD losses
    within CPP_TRAIN_RTOL of TrainStep fed the same LCG batches from the
    same state; C++ step ms beside TrainStep's."""
    import zipfile
    from mxnet_tpu_torch import cpp_package
    ctx = mx.gpu(dev.index or 0)
    art, export_s = cpp_mlp_artifact(mx, dev, tmp)
    step = cpp_mlp_step(mx, ctx)
    xs, ys = (CPP_MLP_BATCH, 784), (CPP_MLP_BATCH,)
    params = [p.data()._data.detach().cpu().numpy()
              for p in step._net.collect_params().values()]
    with zipfile.ZipFile(art) as z:
        state = [z.read("state/%d.bin" % i) for i in range(2 * len(params))]
    check([w.tobytes() for w in params] + [bytes(w.nbytes) for w in params]
          == state, "30c: the artifact's initial state is not the step's "
          "weights and zero momenta")
    stdout = run_cpp([tree.mxtpu_train, art, "--device", str(dev),
                      "--steps", str(CPP_STEPS), "--lr", str(CPP_TRAIN_LR),
                      "--num-classes", "10", "--expect-decreasing"],
                     "30c mxtpu_train")
    cpp_losses = [float(m.group(1)) for m in re.finditer(
        r"step +\d+  loss (\S+)", stdout)]
    check(len(cpp_losses) == CPP_STEPS, "30c: %d loss lines"
          % len(cpp_losses))
    py_losses, times = [], []
    for t in range(1, CPP_HELD + 1):
        x, y = cpp_package.lcg_batch(t, xs, ys, "int32", 10)
        xb, yb = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx,
                                                      dtype="int32")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        py_losses.append(float(step(xb, yb)))
        times.append(time.perf_counter() - t0)
    errs = [abs(a - b) / abs(b) for a, b in zip(cpp_losses, py_losses)]
    worst = max(errs) if errs else math.inf
    check(worst <= CPP_TRAIN_RTOL, "30c: C++ losses %r against "
          "TrainStep's %r (relative %.3g > %g)"
          % (cpp_losses[:CPP_HELD], py_losses, worst, CPP_TRAIN_RTOL))
    check(cpp_losses[-1:] < cpp_losses[:1], "30c: the loss did not fall")
    out = {"card": card, "model": "get_mlp 784-128-64-10",
           "batch": CPP_MLP_BATCH, "optimizer": "sgd lr 0.1 momentum 0.9",
           "export_train_step_s": export_s, "steps": CPP_STEPS,
           "losses_first": cpp_losses[:CPP_HELD],
           "trainstep_losses": py_losses, "max_rel_err": worst,
           "limit": CPP_TRAIN_RTOL,
           "loss_last": cpp_losses[-1] if cpp_losses else None,
           "cpp_step_ms": cpp_line(stdout, "step ms:"),
           "trainstep_step_ms": 1e3 * sum(times[1:]) / (len(times) - 1)}
    print("cpp 30c train (%s): %s" % (card, json.dumps(out)))
    return out


def write_jpeg_rec(np, mx, path, n, side, seed):
    """A RecordIO pack (and its .idx) of n JPEGs of side x side that PIL
    encodes, labels i % 10."""
    import io as pyio
    from PIL import Image
    rng = np.random.RandomState(seed)
    w = mx.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    for i in range(n):
        arr = rng.randint(0, 255, (side, side, 3)).astype(np.uint8)
        buf = pyio.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i % 10), i, 0), buf.getvalue()))
    w.close()


def phase_cpp_native(torch, np, mx, dev, card, tmp):
    """30d: the native runtime. Where it built: NativeEngine's ordering,
    a RecWriter -> RecReader round trip of CPP_RECORDS records read back by
    the port's recordio too, and ImageRecordIter's native route over
    CPP_JPEGS JPEGs into batches on the card, with img/s. Where it did
    not (a host without libjpeg's headers), that finding on a line of its
    own, every native object raising, and ImageRecordIter over the same
    pack by its Python route, on the card, with img/s."""
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.base import MXNetError
    out = {"card": card, "native_built": native.available()}
    rec = os.path.join(tmp, "jpegs.rec")
    write_jpeg_rec(np, mx, rec, CPP_JPEGS, CPP_IMG_SIDE, CPP_SEED)
    if out["native_built"]:
        eng = native.NativeEngine(8)
        var = eng.new_var()
        seq = []
        for i in range(CPP_ENGINE_TASKS):
            eng.push(lambda i=i: seq.append(i), write_vars=[var])
        eng.wait_all()
        eng.close()
        check(seq == list(range(CPP_ENGINE_TASKS)), "30d: a write chain "
              "ran out of order")
        path = os.path.join(tmp, "n.rec")
        w = native.RecWriter(path)
        for i in range(CPP_RECORDS):
            w.write(b"record-%06d" % i)
        w.close()
        r = native.RecReader(path)
        back = [r.read() for _ in range(CPP_RECORDS)]
        check(r.read() is None and back == [b"record-%06d" % i for i in
                                            range(CPP_RECORDS)],
              "30d: the native round trip lost records")
        r.close()
        pr = mx.recordio.MXRecordIO(path, "r")
        check(pr.read() == b"record-000000", "30d: recordio.py cannot read "
              "the native pack")
        pr.close()
        out["engine_tasks"], out["records"] = CPP_ENGINE_TASKS, CPP_RECORDS
    else:
        why = (native.build_error() or "").strip().splitlines()
        print("native runtime (30d, %s): not built on this host: %s"
              % (card, next((ln for ln in why if "error" in ln),
                            why[0] if why else "?")))
        for make in (lambda: native.NativeEngine(2),
                     lambda: native.RecReader(rec)):
            try:
                make()
            except MXNetError:
                continue
            raise SmokeFailure("30d: a native object was made without the "
                               "library")
    ctx = mx.gpu(dev.index or 0)
    it = mx.io.ImageRecordIter(path_imgrec=rec, batch_size=CPP_IMG_BATCH,
                               data_shape=(3, 224, 224), ctx=ctx)
    route = type(it.iters[0]).__name__
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        d = batch.data[0]._data
        check(d.device == dev and tuple(d.shape) == (CPP_IMG_BATCH, 3, 224,
                                                     224),
              "30d: a batch of %s on %s" % (tuple(d.shape), d.device))
        n += CPP_IMG_BATCH - batch.pad
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    it.close()
    check(n == CPP_JPEGS, "30d: %d images of %d" % (n, CPP_JPEGS))
    out["image_record_iter"] = {"route": route, "images": n,
                                "image_side": CPP_IMG_SIDE,
                                "data_shape": [3, 224, 224],
                                "batch": CPP_IMG_BATCH, "s": secs,
                                "img_per_s": n / secs}
    print("cpp 30d native (%s): %s" % (card, json.dumps(out)))
    return out


def phase_cpp(torch, np, dev, card, r50=None, keep=None):
    """Phase 30 (module docstring): the C++ tree and its rnn_design (30a),
    mxtpu_predict and the C API (30b; with `r50`, phase 29a's kept
    ResNet-50 too), mxtpu_train (30c), the native runtime (30d). Returns
    (30b's K4a launches from C++, the summary). With `keep` (a directory)
    30b's word-LM artifact, its input and its C++ logits are copied there
    for phase 31, named in the summary's "carry" with mxtpu_predict."""
    import mxnet_tpu_torch as mx
    out = {"card": card}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, mx.gpu(dev.index or 0):
        # g++ builds the tree in its own processes, and a process of its
        # own compiles ResNet-50, while this one exports and compiles the
        # word LM
        proc = cpp_r50_compile(dev, r50) if r50 else None
        try:
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                built = pool.submit(cpp_build_timed)
                lm_art = cpp_lm_artifact(torch, np, mx, dev, tmp)
                r50_s = cpp_r50_wait(proc) if r50 else None
                built = built.result()
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        tree, out["30a"] = phase_cpp_build(torch, np, dev, card, built)
        launches, out["30b"] = phase_cpp_predict(torch, np, mx, tree, dev,
                                                 card, tmp, lm_art)
        if keep:
            out["carry"] = {"mxtpu_predict": tree.mxtpu_predict}
            for k, src in (("art", lm_art[1]),
                           ("x", os.path.join(tmp, "lm_x.bin")),
                           ("y", os.path.join(tmp, "lm", "out0.bin"))):
                out["carry"][k] = os.path.join(keep, "30b_" + os.path.
                                               basename(src))
                shutil.copy(src, out["carry"][k])
        if r50:
            out["30b"]["resnet50"] = phase_cpp_resnet(np, tree, dev, card,
                                                      tmp, r50, r50_s)
        out["30c"] = phase_cpp_train(torch, np, mx, tree, dev, card, tmp)
        out["30d"] = phase_cpp_native(torch, np, mx, dev, card, tmp)
    out["s"] = time.perf_counter() - t0
    print("C++ deployment phase 30 (%s): %.1f s" % (card, out["s"]))
    return launches, out


# ---------------------------------------------------------------------------
# phase 31: the compile watchdog and the AOT cache (ROADMAP item 11), and
# the full-forward serving adapters on K4a
# ---------------------------------------------------------------------------

WATCH_SEED = 31
#: 31b-c: prompts of the word LM's vocabulary, their lengths, new tokens
WATCH_PROMPTS, WATCH_PROMPT_LEN, WATCH_GEN = 4, 12, 12
WATCH_MAX_LEN = 32
#: 31c's exported batch: the decode batch of WATCH_PROMPTS runs in chunks
WATCH_EXPORT_BATCH = 2

#: 31d, a fresh process on the run's cache: the BlockLM engine over 31b's
#: weights with `aot_cache=`, then compile_for_cpp of 30b's artifact with
#: its package taken out, then mxtpu_predict on it (K4a as the C++ op).
#: Prints one JSON line.
WARM_CACHE = r"""
import json, os, subprocess, sys, time, zipfile
t0 = time.perf_counter()
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import aot, predict, serving
from mxnet_tpu_torch.ops import fused_rnn
from mxnet_tpu_torch.telemetry import introspect
cfg, params, cache, bare, tool, x_path, out_dir = sys.argv[1:8]
cfg = json.loads(cfg)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
os.environ["MXNET_FUSED_RNN"] = "1"
out = {"import_s": time.perf_counter() - t0}
ctx = mx.gpu(0) if cfg["device"].startswith("cuda") else mx.cpu()
with ctx:
    with mx.name.NameManager():
        net = mx.models.RNNModel(
            mode="lstm", vocab_size=cfg["vocab"], num_embed=cfg["embed"],
            num_hidden=cfg["hidden"], num_layers=cfg["layers"], dropout=0.0)
    net.load_params(params, ctx=ctx)
    eng = serving.Engine(serving.BlockLM(net, cfg["vocab"], cfg["max_len"],
                                         time_major=True),
                         max_batch=1, aot_cache=cache)
    n0 = fused_rnn.launch_counts()[0]
    seq = eng.start(cfg["prompt"], max_new=cfg["gen"])
    while not seq.done:
        eng.decode_step([seq])
    out["tokens"] = list(seq.generated)
    out["k4a"] = fused_rnn.launch_counts()[0] - n0
    out["warm_loads"] = eng.warm_loads
    out["first_runs"] = eng.prefill_compilations + eng.decode_compilations
    t1 = time.perf_counter()
    predict.compile_for_cpp(bare, ctx=ctx)
    out["compile_for_cpp_s"] = time.perf_counter() - t1
with zipfile.ZipFile(bare) as z:
    pkg = z.read("aoti/%s.pt2" % cfg["device"].split(":")[0])
out["package_sha256"] = __import__("hashlib").sha256(pkg).hexdigest()
wd = introspect.watchdog()
out["sites"] = {n: {"compiles": s.compiles, "cache_hits": s.cache_hits}
                for n, s in wd.sites().items()}
p = subprocess.run([tool, bare, "--device", cfg["device"], "--input",
                    "0=" + x_path, "--output-dir", out_dir, "--verbose"],
                   capture_output=True, text=True, timeout=300)
out["mxtpu_predict_rc"] = p.returncode
out["mxtpu_predict_stdout"] = p.stdout[-4000:]
out["mxtpu_predict_stderr"] = p.stderr[-2000:]
out["s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def watch_record():
    """(a) The watchdog's record of the run so far, per site: compiles
    (builds, exports, AOTInductor, NVRTC, g++, and the framework steps'
    first runs), their seconds, first runs of a seen signature
    (duplicates) and warm loads."""
    from mxnet_tpu_torch.telemetry import introspect
    return {name: {"compiles": s.compiles, "seconds": round(s.seconds, 3),
                   "duplicates": s.duplicates, "warm_loads": s.cache_hits}
            for name, s in sorted(introspect.watchdog().sites().items())}


def watch_plain_greedy(torch, np, mx, net, prompt, gen):
    """Greedy tokens of `net` (time-major) with MXNET_FUSED_RNN=0, one
    full forward a token, and each step's float32 logits."""
    from mxnet_tpu_torch import autograd
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "0"
    toks, rows = list(prompt), []
    try:
        with autograd.pause(train_mode=False), torch.no_grad():
            for _ in range(gen):
                x = mx.nd.array(np.asarray(toks, np.float32)[:, None])
                logits = net(x)._data[-1].float()
                rows.append(logits)
                toks.append(int(logits.argmax()))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    return toks[len(prompt):], rows


def watch_tokens_agree(torch, np, what, got, want, rows, adapter,
                       prompt):
    """`got` equals the plain loop's `want`, or they split at a near-tie:
    the flag-on logits at the split within LM_EXPORT_RTOL of the plain
    ones, whose top-2 margin is under twice their distance."""
    if got == want:
        return None
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    hist = list(prompt) + want[:i]
    on = adapter.step_full(np.asarray([hist]), np.asarray([len(hist)]))[0]
    off = rows[i]
    err = float((on - off).abs().max() / off.abs().max())
    top2 = torch.topk(off, 2).values
    margin = float(top2[0] - top2[1])
    check(err <= LM_EXPORT_RTOL and margin <= 2 * float((on - off).abs()
                                                         .max()),
          "%s: tokens split from the plain loop at step %d (err %.3g, "
          "margin %.3g)" % (what, i, err, margin))
    return {"split_at": i, "err": err, "margin": margin}


def watch_batch_major(mx):
    """31c's exported LM: (N, T) token ids -> (N, T, V) logits over a
    time-major RNNModel at phase 11's width (the Block subclass is made
    here: it needs the port imported)."""
    class BatchMajor(mx.gluon.Block):
        def __init__(self):
            super().__init__(prefix="wbm_")
            with self.name_scope():
                self.lm = mx.models.RNNModel(
                    mode="lstm", vocab_size=LM_VOCAB, num_embed=LM_EMBED,
                    num_hidden=LM_HIDDEN, num_layers=LM_LAYERS, dropout=0.0)

        def forward(self, x):
            N, T = x.shape
            out = self.lm(x.T)
            return out.reshape((T, N, -1)).transpose((1, 0, 2))

    with mx.name.NameManager():
        return BatchMajor()


def watch_serve(serving, fr, model, prompts, wrap, **kw):
    """Serve `prompts` through `serving.serve(model, ...)`, counting K4a's
    launches and the adapter's calls (`wrap` names the adapter method a
    call is): (tokens per prompt, K4a launches, calls, the engine)."""
    srv = serving.serve(model, max_batch=WATCH_PROMPTS, **kw)
    ad = srv.engine.model
    calls = [0]
    orig = getattr(ad, wrap)

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    setattr(ad, wrap, counted)
    try:
        n0 = fr.launch_counts()[0]
        futs = [srv.submit(list(p), max_new_tokens=WATCH_GEN)
                for p in prompts]
        toks = [f.result(600) for f in futs]
        k4a = fr.launch_counts()[0] - n0
    finally:
        srv.close()
    return toks, k4a, calls[0], srv.engine


def watch_bare(art, bare):
    """A copy of `art` without its AOTInductor package(s)."""
    import zipfile
    with zipfile.ZipFile(art) as z:
        entries = {n: z.read(n) for n in z.namelist()
                   if not n.startswith("aoti/")}
    meta = json.loads(entries["meta.json"])
    meta.pop("aoti", None)
    entries["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(bare, "w", zipfile.ZIP_STORED) as z:
        for n, data in entries.items():
            z.writestr(n, data)


def watch_warm(torch, np, aot, cpp, tmp, params, prompt, plain, adapter,
               dev):
    """(d): WARM_CACHE in a fresh process on the run's cache: zero nvcc
    builds and a warm load for the BlockLM engine over 31b's weights (its
    tokens 31b's plain loop's, up to a near-tie), zero AOTInductor
    compiles for 30b's artifact with its package taken out (the package
    bytes 30b's), and mxtpu_predict's logits bit-equal to 30b's through
    the C++ op. Returns (the summary, {path: (K4a, K4b)})."""
    import hashlib
    import zipfile
    bare = os.path.join(tmp, "word_lm_bare.mxtpu")
    watch_bare(cpp["art"], bare)
    with zipfile.ZipFile(cpp["art"]) as z:
        want_sha = hashlib.sha256(z.read("aoti/%s.pt2" % dev.type)).hexdigest()
    out_dir = os.path.join(tmp, "warm")
    os.makedirs(out_dir)
    cfg = {"vocab": LM_VOCAB, "embed": LM_EMBED, "hidden": LM_HIDDEN,
           "layers": LM_LAYERS, "max_len": WATCH_MAX_LEN,
           "prompt": prompt, "gen": WATCH_GEN, "device": str(dev)}
    proc = subprocess.run(
        [sys.executable, "-c", WARM_CACHE, json.dumps(cfg), params,
         aot.cache_dir(), bare, cpp["mxtpu_predict"], cpp["x"],
         out_dir], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, MXNET_AOT_CACHE_DIR=aot.cache_dir()))
    check(proc.returncode == 0, "31d: the warm process failed (rc %d): "
          "%s" % (proc.returncode, proc.stderr[-3000:]))
    warm = json.loads(proc.stdout.strip().splitlines()[-1])
    check(warm["mxtpu_predict_rc"] == 0, "31d: mxtpu_predict failed: "
          "%s" % warm["mxtpu_predict_stderr"])
    nvcc = {n: s["compiles"] for n, s in warm["sites"].items()
            if n.startswith("kernels.") and s["compiles"]}
    aoti = warm["sites"].get("predict.compile_for_cpp", {})
    check(warm["warm_loads"] >= 1 and not nvcc,
          "31d: warm loads %d, nvcc builds %r" % (warm["warm_loads"],
                                                   nvcc))
    check(aoti.get("compiles") == 0 and aoti.get("cache_hits") == 1
          and warm["package_sha256"] == want_sha,
          "31d: compile_for_cpp %r, package %s against 30b's %s"
          % (aoti, warm["package_sha256"], want_sha))
    split = watch_tokens_agree(torch, np, "31d", warm["tokens"], plain[0],
                               plain[1], adapter, prompt)
    calls, cpp_k4a = cpp_counts(warm["mxtpu_predict_stdout"])
    got = np.fromfile(os.path.join(out_dir, "out0.bin"), np.float32)
    want = np.fromfile(cpp["y"], np.float32)
    check(got.shape == want.shape and np.array_equal(got, want),
          "31d: mxtpu_predict's logits differ from 30b's (max %.3g)"
          % (float(np.abs(got - want).max()) if got.shape == want.shape
             else float("nan")))
    check((calls, cpp_k4a) == (LM_LAYERS, LM_LAYERS),
          "31d: the C++ op ran %d times, K4a %d" % (calls, cpp_k4a))
    # one full forward a token: the prefill's, then WATCH_GEN - 1 steps
    check(warm["k4a"] == LM_LAYERS * WATCH_GEN,
          "31d: the warm engine launched K4a %d times" % warm["k4a"])
    summary = {k: warm[k] for k in ("import_s", "k4a", "warm_loads",
                                    "first_runs", "compile_for_cpp_s", "s")}
    summary.update(nvcc_builds=0, aoti_compiles=0, split=split,
                   cpp_k4a_launches=cpp_k4a, logits_bit_equal_to_30b=True,
                   sites=warm["sites"])
    return summary, {"blocklm_warm_process_phase31d": (warm["k4a"], 0),
                     "rnn_fwd_via_cpp_warm_phase31d": (cpp_k4a, 0)}


def phase_watchdog(torch, np, dev, card, cpp):
    """Phase 31 (module docstring): (a) the watchdog's record of the run,
    (b) BlockLM through serve() on K4a against the plain greedy loop, (c)
    ExportedLM on the same weights, (d) a fresh process on the run's AOT
    cache, (e) the HBM gate on a card TrainStep. `cpp` is phase 30's
    carry (30b's word-LM artifact, input, C++ logits and mxtpu_predict).
    Returns ({path: (K4a, K4b)}, the summary)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import aot, serving
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.telemetry import introspect
    t0 = time.perf_counter()
    out = {"card": card}
    # (a)
    rec = watch_record()
    out["31a"] = rec
    for site in ["kernels.%s" % os.path.splitext(s)[0] for s in SOURCES] + \
            ["predict.export", "predict.compile_for_cpp",
             "rtc.compile_cubin", "cpp_package.build", "train.step",
             "serving.decode", "serving.prefill"]:
        r = rec.get(site, {})
        check(r.get("compiles", 0) + r.get("warm_loads", 0) >= 1,
              "31a: the watchdog recorded nothing at %s: %r" % (site, r))
    check(aot.cache() is not None and len(aot.cache().entries()) >= 4,
          "31a: the run's AOT cache holds %r"
          % (aot.cache().entries() if aot.cache() else None))
    print("watchdog 31a (%s): %s" % (card, json.dumps(rec)))
    rng = np.random.RandomState(WATCH_SEED)
    prompts = [[int(t) for t in rng.randint(1, LM_VOCAB, WATCH_PROMPT_LEN)]
               for _ in range(WATCH_PROMPTS)]
    launches = {}
    with mx.gpu(dev.index or 0), tempfile.TemporaryDirectory() as tmp:
        mx.random.seed(WATCH_SEED)
        net = word_lm_net(torch, mx, dev, 0.0)
        # (b)
        plain = [watch_plain_greedy(torch, np, mx, net, p, WATCH_GEN)
                 for p in prompts]
        prior = os.environ.get("MXNET_FUSED_RNN")
        os.environ["MXNET_FUSED_RNN"] = "1"
        try:
            mark = introspect.watchdog().mark()
            toks, k4a, calls, eng = watch_serve(
                serving, fr, net, prompts, "step_full", vocab=LM_VOCAB,
                max_len=WATCH_MAX_LEN, time_major=True)
            ad = eng.model
            splits = [watch_tokens_agree(torch, np, "31b", t, p[0], p[1],
                                         ad, q)
                      for t, p, q in zip(toks, plain, prompts)]
            check(k4a == LM_LAYERS * calls and calls > 0,
                  "31b: K4a launched %d times over %d full forwards, "
                  "expected %d" % (k4a, calls, LM_LAYERS * calls))
            evs = [e for e in introspect.compile_events("serving.step_full")
                   if e["seq"] > mark]
            check(len(evs) >= 2 and evs[0]["reason"].startswith(
                "first compilation at this site") and any(
                "tokens: shape" in e["reason"] for e in evs[1:]),
                "31b: serving.step_full events %r"
                % [e["reason"] for e in evs])
            check(eng.prefill_compilations + eng.decode_compilations
                  == len(evs), "31b: the engine counted %d first runs, "
                  "the watchdog %d" % (eng.prefill_compilations
                                       + eng.decode_compilations, len(evs)))
            launches["blocklm_serve_phase31b"] = (k4a, 0)
            out["31b"] = {"k4a_launches": k4a, "forwards": calls,
                          "tokens_equal_plain": all(s is None
                                                    for s in splits),
                          "splits": splits, "step_full_events": len(evs),
                          "first_run_reasons": [e["reason"]
                                                for e in evs][:4]}
            # (c)
            bm = watch_batch_major(mx)
            bm.initialize(mx.init.Xavier())
            bm(mx.nd.zeros((WATCH_EXPORT_BATCH, WATCH_MAX_LEN)))
            for p, q in zip(bm.collect_params().values(),
                            net.collect_params().values()):
                p.set_data(q.data())
            art = os.path.join(tmp, "lm_bm.mxtpu")
            te = time.perf_counter()
            mx.predict.export_model(
                bm, [("data", (WATCH_EXPORT_BATCH, WATCH_MAX_LEN))], art,
                input_dtypes={"data": "int32"})
            export_s = time.perf_counter() - te
            etoks, ek4a, ecalls, _ = watch_serve(serving, fr, art, prompts,
                                                 "_call")
            check(etoks == toks, "31c: ExportedLM's tokens %r differ from "
                  "BlockLM's %r" % (etoks, toks))
            check(ek4a == LM_LAYERS * ecalls and ecalls > 0,
                  "31c: K4a launched %d times over %d replays, expected %d"
                  % (ek4a, ecalls, LM_LAYERS * ecalls))
            launches["exportedlm_serve_phase31c"] = (ek4a, 0)
            out["31c"] = {"k4a_launches": ek4a, "replays": ecalls,
                          "export_s": export_s,
                          "exported_call_first_runs": len(
                              introspect.compile_events(
                                  "serving.exported_call"))}
            params = os.path.join(tmp, "lm.params")
            net.save_params(params)
            out["31d"], dl = watch_warm(torch, np, aot, cpp, tmp, params,
                                        prompts[0], plain[0], ad, dev)
            launches.update(dl)
            # (e)
            step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": LM_LR})
            x = mx.nd.array(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                            .astype(np.float32))
            y = mx.nd.array(rng.randint(0, LM_VOCAB, (LM_BPTT * LM_BATCH,))
                            .astype(np.float32))
            before = [p.data()._data.clone()
                      for p in net.collect_params().values()]
            os.environ["MXNET_HBM_BUDGET_GB"] = "1e-9"
            try:
                try:
                    step(x, y)
                    refused = None
                except introspect.HbmBudgetExceeded as e:
                    refused = str(e)
            finally:
                os.environ.pop("MXNET_HBM_BUDGET_GB", None)
            check(refused is not None, "31e: the 1e-9 GB budget admitted "
                  "the step")
            check(step.t == 0 and all(
                torch.equal(a, p.data()._data) for a, p in
                zip(before, net.collect_params().values())),
                "31e: the refused step changed the parameters")
            ev = introspect.compile_events("train.step")[-1]
            loss = float(step(x, y))
            check(step.t == 1 and math.isfinite(loss) and any(
                not torch.equal(a, p.data()._data) for a, p in
                zip(before, net.collect_params().values())),
                "31e: the admitted step did not update")
            out["31e"] = {"refused": refused[:200],
                          "hbm_bytes": ev.get("hbm_bytes"),
                          "admitted_loss": loss}
        finally:
            if prior is None:
                os.environ.pop("MXNET_FUSED_RNN", None)
            else:
                os.environ["MXNET_FUSED_RNN"] = prior
    out["s"] = time.perf_counter() - t0
    print("watchdog phase 31 (%s): %s" % (card, json.dumps(out)))
    return launches, out

class PhaseClock:
    """Runs one of main()'s phases and prints its wall seconds and the
    run's so far when it ends: the run's limit is shared by all of them,
    and host time varies between machines."""

    def __init__(self):
        self.start = time.perf_counter()

    def __call__(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            now = time.perf_counter()
            print("phase time: %s %.1f s (%.1f s since the start)"
                  % (fn.__name__, now - t0, now - self.start), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np
    try:
        from mxnet_tpu_torch.ops import _cuda
    except ImportError as e:
        print("FAIL: cannot import the port (run from the repository "
              "root): %s" % e, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # every compile of the run flows through one AOT cache (phase 31
    # reads it from a fresh process)
    from mxnet_tpu_torch import aot
    aot_dir = tempfile.mkdtemp(prefix="mxtt_aot_")
    aot.configure(aot_dir)
    try:
        smi = nvidia_smi()
        run = PhaseClock()
        print("device: %s (%s), torch %s, CUDA %s"
              % (torch.cuda.get_device_name(0), smi, torch.__version__,
                 torch.version.cuda))
        run(build_kernels, _cuda)
        errs, rows = run(phase_kernels, torch, np, dev, smi)
        int8_errs, int8_rows = run(phase_kernels_int8, torch, np, dev, smi)
        flash_errs, flash_rows = run(phase_flash, torch, np, dev, smi)
        launches, main_path = run(phase_main_path, torch, np, dev, smi)
        train_launches, train_path = run(phase_train, torch, np, dev, smi)
        int8_launches, quant_path = run(phase_quant, torch, np, dev, smi)
        spec_launches, spec_path = run(phase_spec_prefix, torch, np, dev, smi)
        bn_errs, bn_totals = run(phase_kernels_bn, torch, np, dev, smi)
        r50_launches, r50_path = run(phase_resnet, torch, np, dev, smi)
        rnn_errs, rnn_rows = run(phase_kernels_rnn, torch, np, dev, smi)
        lm_launches, lm_path = run(phase_word_lm, torch, np, dev, smi)
        run(phase_module, torch, np, dev, smi)
        exec_launches, exec_path = run(phase_executor_bn, torch, np, dev,
                                       smi)
        run(phase_gluon_lenet, torch, np, dev, smi)
        g50_net, g50_batch, g50_launches, _ = run(
            phase_gluon_resnet, torch, np, dev, smi)
        run(phase_export, torch, np, dev, smi, g50_net, g50_batch)
        del g50_net, g50_batch
        lmh_launches, _ = run(phase_word_lm_hybrid, torch, np, dev, smi)
        bucket_launches, bucket_path = run(phase_bucketing, torch, np, dev,
                                           smi)
        run(phase_bucketing_unrolled, torch, np, dev, smi,
            bucket_path["step_ms_by_bucket"])
        run(phase_module_family, torch, np, dev, smi)
        import mxnet_tpu_torch as mx
        inc_shapes = inception_bn_shapes(torch, mx)
        inc_errs, inc_totals = run(phase_kernels_bn_inception, torch, np,
                                   dev, smi, inc_shapes)
        inc_launches, _ = run(phase_inception, torch, np, dev, smi)
        zoo_launches, _ = run(phase_zoo_families, torch, np, dev, smi)
        cell_launches, _ = run(phase_gluon_cells, torch, np, dev, smi)
        opt_launches, _ = run(phase_optimizers, torch, np, dev, smi)
        run(phase_update_ops, torch, np, dev, smi)
        remat_launches, _ = run(phase_remat, torch, np, dev, smi)
        guard_k3, resume_k4, _ = run(phase_guard_probe_resume, torch, np,
                                     dev, smi)
        run(phase_data, torch, np, dev, smi)
        item2 = run(phase_item2_ops, torch, np, dev, smi)
        op_launches = run(phase_paged_op, torch, np, dev, smi)
        run(phase_nce_example, torch, np, dev, smi)
        run(phase_stochastic_depth, torch, np, dev, smi)
        fd_launches, _ = run(phase_front_door, torch, np, dev, smi)
        fleet_launches, _ = run(phase_fleet, torch, np, dev, smi)
        dist_launches, dist_summary = run(
            phase_distributed, torch, np, dev, smi,
            r50_path["first_step_float32"]["grad_floor"])
        res_launches, _ = run(phase_resilience, torch, np, dev, smi)
        tp_launches, tp_int8_launches, _ = run(phase_tp_rollout, torch, np,
                                               dev, smi)
        ssd_launches, _ = run(phase_ssd, torch, np, dev, smi)
        run(phase_sparse_quant, torch, np, dev, smi, dist_summary)
        # phase 29a's ResNet-50 artifact is kept for phase 30b
        keep = tempfile.mkdtemp(prefix="mxtt_r50_")
        try:
            export_launches, rtc_rows, deploy = run(phase_deploy, torch, np,
                                                    dev, smi, keep)
            cpp_launches, cpp = run(phase_cpp, torch, np, dev, smi,
                                    deploy["29a"]["carry"], keep)
            watch_launches, _ = run(phase_watchdog, torch, np, dev, smi,
                                    cpp["carry"])
        finally:
            shutil.rmtree(keep, ignore_errors=True)
    except SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(aot_dir, ignore_errors=True)
    top = next(r for r in rows if r["shape"] == "decode"
               and r["dtype"] == "float32")
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged.py:108",
        # the serving main path's (phase 4), the contrib op's (21b), the
        # front door's tenants-and-priorities traffic (22a), the
        # multi-replica door's (23a-d) and the rollout and tp paths'
        # (26a-c)
        "launches": launches + op_launches + fd_launches + fleet_launches
        + tp_launches,
        "launches_by_path": {"serving_main_path": launches,
                             "contrib_paged_attention_op": op_launches,
                             "front_door_phase22": fd_launches,
                             "fleet_phase23": fleet_launches,
                             "rollout_tp_phase26": tp_launches},
        "max_abs_err": errs["float32"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
    }]
    top8 = next(r for r in int8_rows if r["shape"] == "decode"
                and r["q_dtype"] == "float32")
    kernels.append({
        "name": "paged_attention_int8",
        "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged.py:119",
        # the quantized path's decode steps and chunks (phase 6), the
        # spec+prefix path's scoring passes and chunks (phase 7) and the
        # int8 tp engine's (26b)
        "launches": int8_launches + spec_launches + tp_int8_launches,
        "launches_by_path": {"quant_phase6": int8_launches,
                             "spec_prefix_phase7": spec_launches,
                             "int8_tp_phase26": tp_int8_launches},
        "max_abs_err": int8_errs["float32"],
        "ms": top8["ms"],
        "plain_ms": top8["plain_ms"],
        "bound_ms": top8["bound_ms"],
        "bound_by": top8["bound_by"],
        "library_ms": top8["library_ms"],
    })
    for i, (kind, line) in enumerate((("fwd", 32), ("bwd", 138))):
        r = next(r for r in flash_rows if r["dtype"] == "float32"
                 and r["kernel"] == "flash_attention_" + kind)
        kernels.append({
            "name": r["kernel"],
            "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_attention.py:%d" % line,
            # the training main path's (phase 5) and the distributed
            # paths' on rank 0 (24a's world of one, 24b's dp and tp)
            "launches": train_launches[i] + dist_launches["k2"][i],
            "launches_by_path": {"train_main_path": train_launches[i],
                                 "distributed_phase24_rank0":
                                     dist_launches["k2"][i]},
            # out for the forward (m and l are printed above; l grows
            # with T), the largest of dq, dk, dv for the backward
            "max_abs_err": (flash_errs["float32", "out"] if kind == "fwd"
                            else max(flash_errs["float32", w]
                                     for w in ("dq", "dk", "dv"))),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    for key, err in inc_errs.items():
        if len(key) == 2:
            bn_errs[key] = max(bn_errs[key], err)
    kernels += bn_kernel_rows(bn_errs, bn_totals, dict({
        "resnet50_trainstep": r50_launches,
        "executor_bn_convnet": exec_launches,
        "resnet50_gluon_eager": g50_launches["eager"],
        "resnet50_gluon_hybridized": g50_launches["hybridized"],
        "inception_v3_gluon_eager": inc_launches["eager"],
        "inception_v3_gluon_hybridized": inc_launches["hybridized"],
        "resnet50_remat_none": remat_launches["none"],
        "resnet50_remat_full": remat_launches["full"],
        "resnet50_remat_io": remat_launches["io"],
        "resnet50_guard": guard_k3,
        "resnet50_mesh_dp2_zero1_rank0": dist_launches["k3"],
        "check_consistency_bn_convnet_phase12b":
            exec_path["check_consistency"]["launches"]},
        **zoo_launches, **ssd_launches), inc_totals)
    kernels += rnn_kernel_rows(rnn_errs, rnn_rows, {
        "word_lm_trainstep": lm_launches,
        "word_lm_gluon_hybridized": lmh_launches,
        "bucketing_lm_module": bucket_launches,
        "gluon_lstm_layer_vs_cells": cell_launches,
        "word_lm_16_optimizers": opt_launches,
        "word_lm_probe_resume": resume_k4,
        "word_lm_mesh_dp2_f32_and_int8_rank0": dist_launches["k4"],
        "word_lm_resilience_phase25": res_launches,
        "word_lm_exported_phase29b": export_launches,
        "rnn_fwd_via_cpp_phase30b": (cpp_launches, 0),
        "check_consistency_sym_rnn_phase21a":
            item2["check_consistency_rnn"]["launches"], **watch_launches})
    kernels += rtc_rows
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
