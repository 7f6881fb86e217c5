"""Drive the PyTorch/CUDA port's splash, serving (a decode mesh, the
runtime's serve plane, a one-host gang and a thin client on a two-node
cluster among them), training (Llama, through the runtime's train and
tune planes, fed by its Dataset API and through its pipeline plane too,
and ViT), RL (its distributed plane too), mesh and compiled-DAG paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (``{"phase": ..., "ok": ...}``):

1. env: torch, CUDA and nvcc versions, and the card (nvidia-smi).
2. build: every kernel of the path from ``ray_tpu_torch/ops/csrc``, one
   nvcc per source, all started together.
3. lint: the port's own analyzer (``python -m ray_tpu_torch.analysis
   --strict``, every family, in a fresh interpreter that loads no torch)
   finds no unbaselined finding, runs every family and rule of its
   tables, and ``--gen-stubs`` reproduces ``core/rpc_stubs.py`` byte for
   byte. It starts no GPU process and launches no kernel.
4. kernels: each flash kernel against its plain PyTorch version on the
   card at the main paths' shapes and at edge cases (the forward at the
   7B prefill and 1B training shapes and at the edges of its 128 x 128
   tiles, each case naming the kernel the C entry counted itself
   launching, which must be ``wgmma`` for bf16 and ``mma_sync_f32`` for
   float32; the two backward kernels at the 1B training shape and at
   the edges of their tiles, each case naming the kernels the C entries
   counted, ``dkv_wgmma+dq_wgmma`` for bf16 and the ``mma_sync_f32`` pair
   for float32), then timed with CUDA events beside the plain version,
   the PyTorch library call that computes the same function, and the
   card's bound for the work (the forward at both shapes, launch-only and
   through its wrapper, with the wrapper's host time a call; the backward
   at the 1B shape with the delta pre-pass, the unit delta + dK/dV + dQ,
   SDPA's backward on each backend that takes it, and the host time a
   call); then the delta pre-pass kernel (``delta.cu``) against its plain
   version on the shapes and layouts both backward paths hand it (the 1B
   training and splash shapes, S=129, D=64, D=80, float32, a (B, H, S, D)
   view), timed at the 1B and splash shapes beside its bound.
5. splash: ``splash_attention`` forward and backward at the 1B preset's
   attention width (16 q heads on 8 kv heads, head_dim 128), B=1,
   S=8192, bf16, default 256 blocks, on a GQA-aligned head stack (heads
   0-7 ``LocalMask(1024)``, 8-11 ``ChunkedMask(2048)``, 12-13
   ``CausalMask``, 14-15 ``FullMask``): four head groups, so exactly one
   forward, one dK/dV and one dQ launch over all groups (each on its
   wgmma kernel, by the C entries' own counts) and one delta launch,
   counted between a reset right before and a read right after. Out and
   gradients against the plain version (one kv head at a time) and, on
   the local, causal and full heads, against the flash kernels; twelve
   edge cases
   (float32, D=64, D=80 padded, ragged S=100, 129 and 255, rows that see
   nothing, Sq != Sk, GQA 1, 2 and 4, B=2, eight alternating head groups),
   each with the kernels it launched; then each kernel timed launch-only
   beside the plain version, SDPA with the dense boolean mask and the
   bound over the call's 297,824,256 live pairs (dQ also with its rate),
   the host time a call (C entries and wrappers, beside the per-group dQ
   design's),
   and on each head group alone beside the flash kernel on the same
   heads.
6. serve: Llama-2-7B (``PRESETS["7b"]``, full width and depth, random
   weights from seed 0, ``attention_impl="flash"``) behind
   ``LlamaDecodeDeployment`` answers six requests from several threads,
   one of them a prefix-cache hit. Launch counters are zeroed right before
   and read right after; every kernel of the path must have run. Greedy
   outputs are held against solo runs under the margin rule.
7. serve_paged: a fresh deployment of the same model and weights, cut to
   its first ``CUT_LAYERS`` layers (as every later serve phase), with a
   paged KV pool (``kv_page_tokens=64``, ``kv_pool_pages=64``: 4096
   tokens of KV for 8 slots of 2048), ``prefill_chunk_tokens=512`` and
   the device sampler answers eight requests sent before the first can
   finish (1100 tokens, a sharer of its first 1061 plus 200 sent after
   its first token, 1500, 900, 800, 700 sampled at temperature 0.8, 300
   and 20; every prompt over 512 tokens prefills in chunks, the 1500 one
   in three), on one schedule in every run: the loop's steps wait for
   the source alone before the first step, the six others (queued in
   this order) before the second, and the sharer before the step after
   the source's first token. It must preempt at least once, run at
   least three prefill chunks, hit the prefix cache, return every page
   (free or pinned by the prefix index) and launch the flash forward once
   a layer per full prefill wave, all on wgmma. Greedy streams are held
   against solo contiguous runs under the margin rule, and the paged
   paths' logit drift against the contiguous ones must stay under it.
8. serve_spec: a fresh speculative deployment of the same model and
   weights with the 1B preset as its draft (random weights from seed 1),
   ``spec_k=4``, 8 slots of 2048 tokens on 128 pages of 64, a draft pool
   of 48 pages (3072 tokens, too few to seat every prompt), the device
   sampler and warmup. Before any request the warmup's step keys must be
   marked and both pools idle. Seven requests, all queued (in this
   order) before the loop's first step: greedy
   prompts of 20, 300, 700, 900, 1100 and 1500 tokens with 32 new tokens
   each, and 400 tokens at temperature 0.8 with 16 (rounds fall back to
   plain steps while it is active). It must run spec rounds, demote or
   evict a draft seat, resync a lagging draft, return every page of both
   pools and launch the flash forward 32 times per target full prefill
   wave, all on wgmma; the timeline must hold draft and verify phases.
   Greedy streams are held against solo runs under the margin rule. Then
   one slot's verify logits against k + 1 decode steps (drift under the
   margin tolerance), and a draft equal to the target (4 slots, four of
   the greedy prompts) against a plain paged engine: accept rate at
   least 0.5, at most half the plain engine's steps in rounds, streams
   under the margin rule.
9. serve_disagg: two deployments of the same model, prefill and decode,
   seven requests through the handoff (prefill, capture, lease, adopt),
   the payloads through the runtime's object store (``rt.init()`` for the
   phase, each put and get timed). The prefix sharer goes once the
   source's descriptor is back, the long prompt once the sharer's is.
10. serve_runtime: ``rt.init()`` on the host (its node must advertise
   ``GPU: 1``), the median host latency of 200 noop tasks and of 200
   actor method round trips, the store's put and get rates for a 1 GiB
   bf16 tensor on the card and a 256 MB one passed as a task argument;
   then ``serve.run`` of a ``LlamaDecodeDeployment`` subclass at the
   7B preset with ``attention_impl="flash"`` (full width, its first
   ``CUT_LAYERS`` layers, ``slots=4``, ``capacity=2048``, seed 0;
   every later runtime phase serves this config) holding ``num_gpus=1`` in a
   replica actor of its own process, its start time, the serve phase's
   six prompts one at a time through ``handle.remote``, ``handle.stream``
   and the HTTP proxy (each equal, token for token, to an in-process
   deployment on the same seed and config replaying the same order), a
   burst of the six over HTTP at once (client TTFT p50 / p99 and tokens/s
   beside the replica's ``slo_summary``), flash #1's launches read in the
   replica's process (one a layer per full prefill wave, all on wgmma),
   and a
   teardown that leaves no process of the node and no store file. Before
   the teardown, against the live cluster: ``python -m ray_tpu_torch
   --address H:P`` with ``status`` (``GPU`` 1.0), ``list nodes``, ``list
   actors`` (the replica's ``ReplicaActor`` alive), ``memory``,
   ``metrics`` (the deployment's TTFT histogram counts every request of
   the phase), ``doctor --interval 2 --json`` (parses, no ``slo-burn``)
   and ``timeline --serve -o <tmp>`` (the replica's engine-step events),
   each in a process of its own that must exit 0, each timed; then
   ``dashboard.start`` in this process, whose ``/``, ``/api/nodes``,
   ``/api/actors``, ``/api/serve`` (naming the deployment), ``/api/core``
   and ``/metrics`` must answer 200, each timed.
11. serve_mesh: the serve_paged geometry and requests served by one
   ``DecodeEngine`` replica over a (1, 1) decode mesh at world size 1
   (one NCCL process group of one rank, in process) beside the mesh-less
   engine on the same weights from seed 0, both driven through
   ``step()`` on one schedule (seven requests before the first step, the
   prefix sharer after the source's first token) so both see the same
   waves. Every stream must equal the mesh-less engine's token for
   token, the waves, chunks and steps must be the same, and each run
   must launch the flash forward once a layer per full prefill wave, all
   on wgmma. Prints each run's mean and decode step time, tokens/s, TTFT
   and ``slo_summary``, and the lockstep's control messages.
12. train: the 1B Llama (``PRESETS["1b"]``, full width and depth, fp32
   masters from seed 0, ``attention_impl="flash"``, full remat,
   ``loss_chunk=512``) takes four AdamW steps through ``build_train_step``
   with two microbatches of 4 x 2048 tokens. Launch counters are zeroed
   before each step and read after it; each step must launch each
   backward kernel and the delta pre-pass once per layer and microbatch
   and the forward twice (the remat recompute). Losses must be finite
   and falling. A 2-layer model of the same width then holds the flash
   gradients against the plain-attention ones.
13. train_runtime: the train phase's model cut to its first
   ``TRAIN_RUNTIME["layers"]`` (4) layers at full width, with its tokens
   and steps, through the train and tune planes. First the train phase's
   setup at that depth in this process (``phase_train``: the reference
   losses). Then ``rt.init()`` (its node must advertise ``GPU: 1``) and
   ``TorchTrainer`` with ``ScalingConfig(num_workers=1, use_gpu=True,
   torch_config=TorchConfig(distributed=True))`` and
   ``FailureConfig(max_failures=1)``: one GPU-leased worker (its own
   process) joins a one-rank NCCL group through the gang registry's
   bootstrap barrier and a tcp rendezvous and takes the 4 steps, each
   reporting its loss, gradient norm, time, peak memory and the launch
   counts (zeroed before the step, read after it in the worker's
   process). After step 2 ``save_pytree`` writes params and AdamW state
   (3.84 GB at 4 layers, the free bytes of the storage path printed
   first) and reports it as the checkpoint (copied into the run's
   storage); the first attempt then raises an injected error, and the
   second restores it through ``train.get_checkpoint()`` and
   ``restore_pytree`` and takes steps 3-4. Checks: one restart, the four
   losses equal to the reference's within ``TRAIN_RUNTIME_REL_TOL``,
   exact launches a step, all on wgmma. Prints the card's memory before
   ``fit()``, the worker's start time, save / persist / restore seconds
   and GB/s, the restart time and the step times beside the reference's.
   Then a ``Tuner`` over the same trainer with ``lr`` in
   ``grid_search([3e-4, 3e-5])``, 2 steps a trial, one trial at a time
   (``max_concurrent_trials=1``): each trial's gang holds the one
   ``GPU`` in turn; both finish, with equal first losses and the same
   launches, and the best result is the lower final loss. (Run
   together, the second trial's reservation would be refused after 60
   s and requeued; ``tests/test_torch_tune_requeue.py`` holds that path
   on the CPU.) Teardown: no gang record, no process
   of the node, no store file and no checkpoint directory left, ``GPU``
   available again.
14. vit: ViT-B/16 (``vit.PRESETS["vit_b16"]``, full width and depth, fp32
   masters from seed 0, bf16 compute, full remat) takes six AdamW(3e-4,
   weight decay 0.1) steps through ``build_train_step`` at batch 256, fed
   by ``device_prefetch(prefetch=2)`` from seeded numpy batches of float32
   NHWC images and int64 labels (made before the loop); the first step is
   the warm-up. Then six steps on the same batches placed on the card
   beforehand (the yardstick for whether the copy is hidden). It prints
   step time (host clock after a sync), images/s, MFU from
   ``flops_per_image``, peak memory, the consumer's wait per step on the
   prefetch queue and the copies' rate. Checks: finite losses and params,
   the params moved, each device batch's checksum equals its host
   batch's, the host buffers were pinned and the copies ran on a side
   stream, the port on the card equals the port on the CPU at the debug
   size in float32 (random head), ``pad_tokens_to=256`` logits equal the
   unpadded ones at B=4, and none of the seven hand-written kernels
   launched (ViT attention is the plain path, as in the JAX package).
15. data_train: the Dataset API on the runtime feeding both train steps
   (``rt.init()``; its node must advertise ``GPU: 1``). (a) The train
   phase's tokens, drawn as it draws them ((8, 2049) from a generator
   seeded 0 on the card), copied to the host and repeated for its 4
   steps (32 rows) through ``data.from_numpy(num_blocks=8)``, a
   ``map_batches`` task adding each row's checksum (run on CPU workers
   by ``materialize``, the blocks in the shared-memory store), then
   ``TorchTrainer(datasets={"train": ds})`` with one GPU-leased worker in
   a one-rank NCCL group: the train phase's setup stepping on
   ``train.get_dataset_shard("train").iter_device_batches(batch_size=8)``
   (two microbatches of 4 x 2048, AdamW(3e-4, wd 0.1)). Checks: the four
   losses equal the train phase's within ``TRAIN_RUNTIME_REL_TOL``; each
   device batch's row sums equal the host rows' and the map task's
   column; the batches land on the worker's card; each step launches
   88 / 44 / 44 / 44 (forward, dK/dV, dQ, delta), all on wgmma, read in
   the worker; the shard ends after 4 batches. It prints the worker's
   wait on the iterator for each step, each step time beside the train
   phase's, and the bytes put into the store. (b) ViT-B/16 in process:
   4 batches of 256 uint8 NHWC 224x224x3 images and int64 labels from a
   numpy seed, one block a batch, a ``map_batches`` task casting them to
   float32 / 255 (154 MB a batch out of the store), streamed by
   ``ds.iter_device_batches(batch_size=256)`` into ``build_train_step``.
   Checks: finite losses, each device batch's checksum equals the same
   cast done in numpy in this process, all 4 batches, no hand-written
   kernel launched. It prints images/s from the second step on beside
   the vit phase's and the consumer's wait for each step. Teardown: no
   process of the node, no store file, ``GPU`` available again.
16. rl: the RL plane with the learner on the card (``rt.init()``; its node
   must advertise ``GPU: 1``); it prints whether ``gymnasium`` and
   ``pyarrow`` are found and installs nothing. (a) Multi-agent PPO through
   its entry point: ``MultiAgentPPOConfig(seed=0, num_env_runners=2,
   episodes_per_sample=16, device="cuda").build().train()`` until the
   guide's best return reaches 5.5 and the follower's 5.0 (the
   reference's bar), within 60 iterations. Checks: both policies' params
   and Adam state on the card after every iteration; the runners are CPU
   workers (``GPU`` stays free) and no process of the node holds a card's
   device file open (this process does); ``save``, one more iteration and
   ``restore`` give back the saved params exactly, on the card. Prints
   iterations, env steps/s, sample and learn time an iteration and the
   learner's ms per update (CUDA events). (b) Every algorithm's update at
   its JAX defaults, from one CPU generator's params, on seeded numpy
   batches and the same draws: PPO on CartPole shapes (MLP 64x64,
   minibatch 256) and through the Nature-DQN torso (84x84x4 uint8,
   minibatch 256, with its FLOP count and rate), IMPALA and APPO (V-trace
   over a (64, 8) rollout with dones and autoreset rows; APPO's target
   interval 2, so it syncs), DQN (double Q, batch 128, priority weights),
   SAC and CQL at Pendulum's shapes ((256, 256), batch 256; CQL's BC warm
   start for 2 updates, then its SAC loss) and BC (batch 256). 5 updates
   on the card against the same 5 on the CPU: each loss within
   ``RL_LOSS_REL_TOL``, each param within ``RL_ADAM_BOUND`` x lr x 5, all
   finite and on the card; then 20 more, each between CUDA events. (c)
   4096 Pendulum-shaped transitions through ``data.from_numpy`` (and,
   with pyarrow, ``save_transitions`` / ``load_transitions``) into
   ``offline.dataset_to_buffer``, then 200 CQL updates on the card from
   buffer samples: every row held, the critic loss finite, the params on
   the card. (d) Only with gymnasium: PPO on ``ray_tpu/MiniCatch-v0`` at
   84x84 with 4 stacked frames for 3 iterations, one iteration each of
   IMPALA, APPO, DQN and SAC, and BC fed by ``collect_dataset``;
   without it the phase prints ``"gymnasium": false`` and what it
   skipped. No hand-written kernel may launch; teardown leaves no process
   of the node, no store file, and ``GPU`` available again.
17. mesh: the mesh plane at world size 1: one NCCL process group of one
   rank, rendezvoused in process (``parallel.mesh.init_distributed``).
   The train phase's 1B setup (2 steps of 2 microbatches of 4 x 2048)
   mesh-less, then through ``build_train_step`` on
   ``MeshSpec(fsdp=-1).build()`` (DTensor params, state and batch) and
   through ``build_zero1_train_step``, from the same weights and tokens:
   losses and gradient norms within ``MESH_REL_TOL`` of the mesh-less
   step's, exact launches a step, each variant's step time, tokens/s,
   peak memory and state bytes. ``ring_attention(impl="flash")`` forward
   and backward and ``ulysses_attention(impl="flash")`` on the 1-rank
   mesh at the 1B attention width (B=1, S=8192, 16 q on 8 kv heads,
   D=128, bf16, causal), and the 1B width with 8 experts (top-2,
   capacity 1.25) cut to ``MOE_LAYERS`` layers trained 3 steps on
   1 x 2048 tokens on an ``expert`` mesh of one (finite loss and aux,
   the loss falls). Counters are zeroed before the mesh, ZeRO-1, ring,
   Ulysses and MoE runs and read after them: the exact launches, all on
   wgmma. Then the comparisons, against the plain flash forward and
   backward on the ring's inputs: the path's ring output and gradients,
   Ulysses' output, the 1-rank ring run again, and a loopback ring of 4
   virtual shards of 2048 (the package's ``ring_flash_attention_local``
   for each virtual rank, K/V rotated by indexing through its ``ring``
   argument), which is also held against one full ``flash_attention``
   call; out and gradients within ``RING_BF16_TOL``. The loopback
   launches 10 forwards and 10 of each backward kernel (4 diagonal and 6
   visible hops; the 6 dead hops launch nothing), and each is timed
   beside the full call. Its hops' shapes (B=1, 2048, 16 on 8 heads,
   full and causal, with an lse cotangent) are kernel cases too.
18. rl_dist: the RL distributed plane with the learner on the card
   (``rt.init()``; its node must advertise ``GPU: 1``); it prints whether
   ``gymnasium`` is found and installs nothing. (a) The policy inference
   service on the card: for CartPole's shapes (MLP 64x64, 2 actions) in
   categorical mode and the Nature torso's (84x84x4 uint8, 6 actions) in
   epsilon-greedy mode (two services, two fresh GPU processes; it ran
   each shape in both modes before this cut), a ``WeightFanout``
   publishes version 1 (params
   from one CPU generator, seed 1; epsilon 0.5 in the greedy service), a
   ``PolicyInference`` actor takes the ``GPU`` lease, and eight CPU
   actors each send 50 ``infer((obs, seed))`` requests of 4 seeded rows,
   one after another, all eight at once; version 2 (seed 2; epsilon 0)
   is published once the service has served 100 requests, before the
   second half of each caller's requests. Checks: coalescing (``max_batch
   >= 2``, fewer forwards than requests), each caller's reply versions
   never go down and both versions were served, every value and log-prob
   of a returned action within ``RL_LOSS_REL_TOL`` of a CPU forward of
   that version's params on the same rows (max |difference| over max
   |CPU|), and at epsilon 0 every action equal to the CPU's argmax where
   its top-2 margin exceeds ``RL_DIST_MARGIN``. Prints the service's
   start, forward calls, mean coalesced batch, request p50 / p99 (host
   clock) and forward ms (CUDA events, read in the service). (b) Four CPU
   tasks each put a seeded (64, 4) CartPole-shaped rollout into the store
   and return a ``collect()``-style descriptor; each becomes a
   ``TrajectoryShard`` through a ``ShardQueue(2)`` (a third put times out
   while it is full) into a ``LearnerState`` on the card, which runs
   ``make_impala_update`` on each under ``timed_update`` (CUDA events
   around each) and publishes. Checks: descriptors under
   ``DESCRIPTOR_BYTE_BUDGET``, ``plane_stats`` with staleness, update
   time, descriptor bytes and env steps, losses within
   ``RL_LOSS_REL_TOL`` of the same four updates on the CPU and params
   within ``RL_ADAM_BOUND`` x lr x 4, params on the card, the fan-out at
   version 5, its hub key gone after ``close()``. (c) Only with
   gymnasium: ``IMPALAConfig().distributed_rollouts(4,
   num_envs_per_actor=4)`` until the best return reaches 100 within 100
   iterations, and ``DistributedDQN`` in inference mode for 3 iterations
   (monotonic versions, descriptors in budget, a leak report with queue
   depth 0 and no intake thread, the ``GPU`` lease back after stop);
   without it the phase prints ``"gymnasium": false`` and what it
   skipped. No hand-written kernel may launch; teardown leaves no
   process of the node, no store file, and ``GPU`` available again.
19. gang: ``HostGroup(1, worker_options={"num_gpus": 1})`` on
   ``rt.init()``, whose node advertises a one-host slice of its one card.
   (a) Formation (timed): the member is process 0 of 1 with one chip a
   host and holds the ``GPU`` lease, ``form_mesh()`` forms a one-rank
   NCCL group (``[1]``), a program barrier passes. (b) Through
   ``broadcast`` the member builds the serve phase's engine on its card
   (``PRESETS["7b"]``, full width, ``CUT_LAYERS`` layers, bf16,
   seed 0, ``slots=4``, ``capacity=2048``, flash) and serves the serve
   phase's six requests one at a time: the streams must equal
   serve_runtime's sequential handle streams (the same engine, requests
   and order) token for token; flash #1's launches, read in the member,
   must be one a layer per full prefill wave, all on wgmma. Prints TTFT,
   decode tokens/s per request and tokens/s. (c) The member is killed:
   the monitor reconciles the gang
   under the next epoch, releasing the sub-slice once; the ``GPU`` lease
   passes to the new member, a new coordinator is elected, and the
   re-formed member serves the first request again with the same
   stream. Prints the time from the kill to ``ALIVE`` and to the first
   token. (d) Shutdown leaves no reservation, no group record, ``GPU``
   available, no process of the node and no store file.
20. cluster: two nodes on this machine through
   ``cluster_utils.Cluster(initialize_head=False)``: a CPU node
   (``add_node(num_cpus=4)``) and a node holding the card
   (``add_node(num_cpus=2, resources={"GPU": 1}, labels={"gpu_name":
   ...})``), each with a 4 GiB store, ``rt.init(address=...)`` and a
   ``ClientServer`` in this process (the time to form printed). (a) A thin
   client in its own process (``CLUSTER_CLIENT``, written to a temp file
   and run with this interpreter) connects with
   ``rt.init("ray-tpu://...")`` and creates the named actor ``smoke-llm``
   with ``num_gpus=1`` and a ``runtime_env`` of a marker variable and a
   working_dir holding a module the actor imports by name. The actor
   builds serve_runtime's deployment in its constructor
   (``LlamaDecodeDeployment`` at ``PRESETS["7b"]``, full width,
   ``CUT_LAYERS`` layers, flash, seed 0, ``slots=4``,
   ``capacity=2048``) and serves the serve
   phase's six requests one at a time; the client uploads 256 MiB of
   seeded random bytes, which the actor copies to its card and sums, then
   disconnects and prints whether it created a CUDA context. (b) A task
   pinned to the CPU node returns 1 GiB of seeded random bytes, and the
   actor ``get``s them (a pull between the two nodes' stores), copies
   them to its card and sums them. (c) ``JobSubmissionClient`` submits an
   entrypoint (``CLUSTER_JOB``) with a ``runtime_env`` of a working_dir
   and the cluster's address; it attaches to the cluster, looks up the
   named actor (it outlived the client's session) and prints one
   request's stream (``r5_prefix_hit``, whose repeat on the same engine
   takes its first pass's prefix-hit path); the phase waits for
   ``SUCCEEDED`` and reads the stream from ``get_job_logs``. Checks: the
   client's and the job's streams equal serve_runtime's handle streams
   token for token; the actor ran on the GPU node, on the card, saw the
   marker and had the working_dir as its cwd; flash #1 launched 32 times
   per full prefill wave in the actor's process, all on wgmma, and
   nothing in the driver; both sums right; no CUDA context in the client;
   the job ``SUCCEEDED``; after the kill, the actor's process and then
   every process of both nodes gone. Prints the upload's and the pull's
   GB/s, the actor's start, the TTFTs and each step's seconds.
21. pipeline: the train phase's model and weights cut to their first
   ``PIPELINE["layers"]`` (4) layers at full width (``PRESETS["1b"]``,
   flash, full remat, fp32 masters from seed 0, kept on the host) through
   the pipeline plane
   (``PipelinePlane``: a ``HostGroup`` of ``StageActor`` processes,
   driver-side 1F1B, tensors through the object store and descriptors
   through the RPCs), Adam at lr 3e-4, 3 steps, each on the same batch
   of 4 microbatches of 2 x 2048 numpy-seeded tokens (so a falling loss
   reads learning, not another batch's noise). (a) One stage on the card's own one-host
   slice (``rt.init()``, ``snapshot_every=5``, the member holding
   ``num_gpus=1``): losses equal to the last bit to
   ``single_process_baseline(n_stages=1)`` run in this process on the
   card, and within ``PIPELINE_FULL_REL_TOL`` of the full model's
   (``n_stages=None``, ``llama.loss_fn``). (b) Two stages sharing the
   card on a virtual slice of two one-chip hosts
   (``RAY_TPU_VIRTUAL_SLICE=1x2/1`` before init, each member holding
   ``num_gpus=0.5``), window 2: losses equal to the in-process
   ``n_stages=2`` chain; prints each step's wall time, each stage's busy
   seconds, the bubble (``1 - sum(busy) / (stages x wall)``),
   ``model_tflops``, the tensor bytes moved and the
   ``pipeline_desc_bytes`` p99 (at most 8192). In (a) and (b) the counts
   are zeroed in the stages' processes before the steps and read there
   after them: each run launches the flash forward 3 times per layer and
   microbatch (the stage forward, the backward's forward and its remat
   recompute) and each backward kernel and delta once, all on wgmma,
   and nothing in the driver. (c) (a)'s plane, once (a)'s counts are
   read, trains the 3 steps again: its stage's process is SIGKILLed
   after the second of them commits (the fifth step, the plane's one
   snapshot); the gang reconciles under epoch 2,
   the registry's epoch bumps, the third replays, the losses equal the
   uninterrupted in-process chain's (its steps 4-6), and ``stop()``
   leaves no ref and no record after all 6 steps; then
   ``python -m ray_tpu_torch --address H:P doctor --post-mortem --json``
   against the live cluster must name ``gang-death`` for the killed
   member and the stage it hosted. The in-process baselines are freed
   before each plane starts.
22. dag: one ``rt.init()``. (a) Llama-2-7B (``PRESETS["7b"]``, full
   width and its first ``CUT_LAYERS`` layers, flash, bf16, random
   weights from seed 0) split in half by ``split_llama_stages`` into two
   stage functions, each
   bound with ``num_gpus=0.5`` (two stages share the card) and run by
   ``experimental_compile(max_in_flight=4)``: two stage actors joined by
   a mutable shared-memory channel. Each stage draws the whole model from
   seed 0 on the card at its first call and keeps its own half (no
   weights travel in its function). This process first runs the
   reference on the card: the same two stage functions chained, and
   ``llama.forward``, on the same items. Then two warm-up items, the
   window (six (1, 512) microbatches, whose 4 MiB hidden state fits the
   8 MiB slot, and two (2, 1024), whose 16 MiB take the RPC push; which
   path an item takes is ``serialization.build_frame(item)[0]`` against
   the slot, the rule ``_PipeStage`` applies), all in flight at once,
   then the same items one at a time. Checks: the logits equal to the
   last bit to the chained stage functions (both runs) and within
   ``DAG_FORWARD_REL_TOL`` of ``llama.forward``; a flash forward launch
   a layer in each stage's process for each item of the window, read
   there by the stage functions around each call, all on wgmma, and
   none in this process; each stage in its own process, every call of
   the channel's reader on one thread; the stages' windows interleave
   (stage 0 starts item i+1 before stage 1 ends item i, for some i, in
   the window and never one at a time: the ordering half of
   ``tests/test_dag.py``'s proof, since two processes time-sliced on one
   card do not compute at once); both paths carry items, and the
   channel's own header counts the items it carried; no ``.chan`` file
   left after ``teardown()``. Prints items/s pipelined and one at a
   time, compile to the first result, each stage's first-call setup and
   ms an item, and the bytes that took each path. (b) A durable workflow
   on CPU workers: three steps and a continuation under a temp dir, its
   third step raising on its first run (a marker file guards it), then
   ``resume``: no finished step runs again (marker-file counts) and the
   result equals an uninterrupted run's. (c) ``ActorPool.map`` and
   ``get_next_unordered`` over 4 CPU actors, a ``Queue(maxsize=4)``
   between a producer task and a consumer task, and ``allreduce``,
   ``allgather``, ``broadcast`` and ``barrier`` over 4 CPU actors on a
   1 MiB array, each checked and timed. Then no process, store or
   channel file left.
23. launcher_mesh: the launcher and autopilot family and the mesh
   replica, as an operator runs them. ``python -m ray_tpu_torch up`` on a
   fake_multinode cluster YAML (``LAUNCH_YAML``: a CPU head, one ``gpu``
   node type of ``{CPU: 4, GPU: 1}``, min 0, max 1, idle 6 s) parks in a
   process of its own, which holds the controller, the head and every
   node the autoscaler adds. This process joins it
   (``rt.init(address=...)``) and ``serve.run``s serve_runtime's 7B
   (``_replica_cls``, 4 slots x 2048) with ``mesh_shape=(1, 1)`` and
   ``num_gpus=1``: the sub-slice reservation is refused until the
   autoscaler, seeing the ``{chips: 1}`` demand, launches the ``gpu``
   node, whose one card is a one-chip slice; the serve controller then
   spawns the replica's one rank, which joins an NCCL world of one. The
   serve phase's six requests go through the HTTP proxy one at a time and
   must equal serve_runtime's streams token for token; the replica's
   process reads flash #1's launches (one a layer a full prefill wave,
   all on wgmma). Then ``serve/trace_demo.py``'s ``run_demo(init=False)``
   with its two debug replicas on CPU workers (the trace must validate)
   and, beside it, ``autopilot --dry-run`` (its plan printed, nothing
   applied) and ``autopilot --status``, ``serve.delete`` (the idle ``gpu`` node must be
   terminated) and ``python -m ray_tpu_torch down`` on the YAML, which
   stops the ``up`` process. Prints ``up``, the ``gpu`` node's launch,
   the replica's start, ``serve.run`` to the first streamed token, the
   demo, the autopilot's two commands, the node's termination and
   ``down``, in seconds. Its GPU process is counted by the card files
   the ``up`` process's children hold.

Depth, steps and schedule cut to keep the smoke near half its 1200 s
limit: the pipeline and train_runtime run the 1B width at 4 layers
(they ran (a), (b) and train_runtime at the full 22), data_train's ViT
half takes 4 batches (it took 8), and the tune sweep of train_runtime
runs one trial at a time (its second trial waited out a refused 60 s
reservation). rl_dist starts two inference services, not four, to pay
for the dag phase's two stage processes, and the pipeline's (c) kills and
resumes one stage, not one of two (which re-formed both: four processes,
now two), to pay for launcher_mesh's replica. Every width and kernel of
each path stays.

Serve, serve_paged, serve_spec and train also read the forward's C
entry's own launch count of each of its kernels over the same window:
every forward launch there must have taken the wgmma kernel; train reads
the backward's entries the same way, and every backward launch must have
taken a wgmma kernel.

Each main path (splash, serve, serve_paged, serve_spec, serve_disagg,
serve_runtime, serve_mesh, train, train_runtime, data_train, mesh, gang,
cluster, pipeline, dag, launcher_mesh) must have launched each of its kernels at least
once. Every phase line carries ``gpu_processes_started``: the GPU worker
processes the runtime spawned during it (``count_gpu_processes``), and a
``{"gpu_processes": ...}`` line sums them. Then a
``{"kernels": [...]}`` line with all seven kernels (the six attention
kernels with their main-path launches by kernel, and each with its ptxas
lines: registers, shared memory and spills of each instantiation), the
nvidia-smi
name/power-limit line, and, last, ``{"ok": true, "device": {...}}``.
Any failed phase exits 1 without that last line; so does a machine
without a card.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

# The bounds' peaks: H100 SXM (NVIDIA data sheet). MFU reads the card's
# own bf16 peak from ``ray_tpu_torch.gpu`` (``_mfu_peak``).
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
# Greedy-agreement margin for bf16 7B logits: tokens are compared while
# the solo run's top-2 logit margin exceeds it. The serve phase measures
# how far batch shape and the prefix-hit path move logits and fails if
# any drift reaches it.
MARGIN_TOL = 0.1
REQUEST_TIMEOUT_S = 300.0
# Every serve phase after the first (serve_paged, serve_spec, serve_disagg,
# serve_mesh) and the runtime phases (serve_runtime, gang, cluster, dag,
# launcher_mesh) serve the 7B at full width and its first 4 of 32 layers:
# their checks read the engine's paths, the kernels' launches and the
# runtime's host paths, none of which needs the depth, and their time is
# fresh processes and decode steps. The serve phase keeps all 32 layers.
CUT_LAYERS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _mfu_peak() -> float:
    """The card's dense bf16 peak, by its name (``gpu.py``'s table)."""
    from ray_tpu_torch import gpu

    return gpu.peak_flops_per_chip(torch.cuda.get_device_name(0))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ env


def phase_env() -> dict:
    from ray_tpu_torch.ops import cuda_build

    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc.stdout.strip().splitlines()[-1],
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi": smi_line()}


# ---------------------------------------------------------------- build


KERNELS = {
    # name -> what the kernels line needs besides measurements
    "flash_fwd": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:109",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:223",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:281",
    },
    "splash_fwd": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/splash.cu",
        "replaces": "ray_tpu/ops/splash_attention.py:204",
    },
    "splash_bwd_dq": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/splash.cu",
        "replaces": "ray_tpu/ops/splash_attention.py:311",
    },
    "splash_bwd_dkv": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/splash.cu",
        "replaces": "ray_tpu/ops/splash_attention.py:350",
    },
    # Not a TPU kernel: the JAX package leaves this expression to XLA.
    "attention_delta": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/delta.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:343",
    },
}
# The kernels each main path must launch at least once.
PATH_KERNELS = {
    "serve": ["flash_fwd"],
    "serve_paged": ["flash_fwd"],
    "serve_spec": ["flash_fwd"],
    "serve_disagg": ["flash_fwd"],
    "serve_runtime": ["flash_fwd"],
    "serve_mesh": ["flash_fwd"],
    "train": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
              "attention_delta"],
    "train_runtime": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                      "attention_delta"],
    "data_train": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                   "attention_delta"],
    "splash": ["splash_fwd", "splash_bwd_dq", "splash_bwd_dkv",
               "attention_delta"],
    "mesh": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
             "attention_delta"],
    "gang": ["flash_fwd"],
    "cluster": ["flash_fwd"],
    "pipeline": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "attention_delta"],
    "dag": ["flash_fwd"],
    "launcher_mesh": ["flash_fwd"],
}
# The sources to build: one library (and one nvcc) per .cu file.
SOURCES = sorted({Path(k["source"]).stem for k in KERNELS.values()})


def _counters() -> dict:
    """Kernel name -> (wrapper, attribute) of its launch counter."""
    from ray_tpu_torch.ops.flash_attention import (attention_delta,
                                                   flash_attention,
                                                   flash_backward)
    from ray_tpu_torch.ops.splash_attention import (splash_attention,
                                                    splash_backward)

    return {"flash_fwd": (flash_attention, "launches"),
            "flash_bwd_dkv": (flash_backward, "dkv_launches"),
            "flash_bwd_dq": (flash_backward, "dq_launches"),
            "splash_fwd": (splash_attention, "launches"),
            "splash_bwd_dq": (splash_backward, "dq_launches"),
            "splash_bwd_dkv": (splash_backward, "dkv_launches"),
            "attention_delta": (attention_delta, "launches")}


def launch_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def fwd_kernel_counts(device="cuda") -> dict:
    """Launches of each kernel behind ``flash_fwd.cu``'s entry, as the C
    entry counts them (none off the card)."""
    if torch.device(device).type != "cuda":
        return {}
    from ray_tpu_torch.ops.flash_attention import forward_kernel_launches

    return forward_kernel_launches()


def fwd_kernels_since(before: dict, device="cuda") -> dict:
    return {k: n - before.get(k, 0)
            for k, n in fwd_kernel_counts(device).items()}


def all_on_wgmma(by_kernel: dict, flash_launches: int, device) -> bool:
    """Every forward launch of a bf16 path took the wgmma kernel (off the
    card nothing launches)."""
    if torch.device(device).type != "cuda":
        return True
    return by_kernel == {"wgmma": flash_launches, "mma_sync_f32": 0}


def bwd_kernel_counts(device="cuda") -> dict:
    """Launches of each kernel behind ``flash_bwd.cu``'s two entries, as
    the C entries count them (none off the card)."""
    if torch.device(device).type != "cuda":
        return {}
    from ray_tpu_torch.ops.flash_attention import backward_kernel_launches

    return backward_kernel_launches()


def bwd_kernels_since(before: dict, device="cuda") -> dict:
    return {k: n - before.get(k, 0)
            for k, n in bwd_kernel_counts(device).items()}


def all_bwd_on_wgmma(by_kernel: dict, dkv_launches: int, dq_launches: int,
                     device) -> bool:
    """Every backward launch of a bf16 path took a wgmma kernel (off the
    card nothing launches)."""
    if torch.device(device).type != "cuda":
        return True
    return by_kernel == {"dkv_wgmma": dkv_launches, "dq_wgmma": dq_launches,
                         "dkv_mma_sync_f32": 0, "dq_mma_sync_f32": 0}


def _route(by_kernel: dict) -> str:
    """The kernels a window launched, joined by "+"."""
    return "+".join(k for k, n in by_kernel.items() if n)


def cuda_build_rows(cuda_build, name: str) -> list:
    """One line per kernel instantiation in the build log of ``name``: its
    name, registers and shared memory, and spills."""
    log = cuda_build.build_log(name).splitlines()
    rows = []
    for i, line in enumerate(log):
        if "Function properties for" in line:
            fn = line.split("for")[-1].strip()
            # The kernel's name and template arguments, past the mangled
            # anonymous namespace (which names the file).
            m = re.search(r"(?:(?:splash|flash)_(?:fwd|bwd_dq|bwd_dkv)"
                          r"(?:_wgmma|_f32)?|attention_delta)_kernel\w*", fn)
            fn = m.group(0) if m else fn
            spill = log[i + 1].strip() if i + 1 < len(log) else ""
            used = next((x.strip() for x in log[i + 2:i + 4]
                         if "registers" in x), "")
            rows.append(f"{fn}: {used}; {spill}")
    return rows


def phase_build() -> dict:
    from ray_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build(SOURCES)
    out = {"seconds": round(time.perf_counter() - t0, 3),
           "libraries": [p.name for p in libs]}
    for name in SOURCES:
        out[f"{name}_ptxas"] = cuda_build_rows(cuda_build, name)
    return out


# ----------------------------------------------------------------- lint


class LintRun:
    """The port's analyzer over this checkout in two subprocesses (a strict
    run of every family; the RPC stubs regenerated into a temporary file),
    started before the kernel build so that they run beside it, and read
    by the lint phase right after it."""

    def __init__(self):
        import tempfile

        self.root = Path(__file__).resolve().parent
        self.tmp = tempfile.TemporaryDirectory()
        self.stats_path = Path(self.tmp.name) / "stats.json"
        self.stubs_path = Path(self.tmp.name) / "rpc_stubs.py"
        env = {**os.environ, "PYTHONPATH": str(self.root)}
        cmd = [sys.executable, "-m", "ray_tpu_torch.analysis"]
        self.t0 = time.perf_counter()
        self.procs = {
            "strict": subprocess.Popen(
                cmd + ["--strict", "--format", "json", "--stats-json",
                       str(self.stats_path)],
                cwd=self.root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
            "stubs": subprocess.Popen(
                cmd + ["--gen-stubs", str(self.stubs_path)],
                cwd=self.root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)}

    def wait(self) -> dict:
        """{name: (exit code, stdout, stderr, seconds since the start)}."""
        out = {}
        for name, proc in self.procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            out[name] = (proc.returncode, stdout, stderr,
                         time.perf_counter() - self.t0)
        return out

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.tmp.cleanup()


def phase_lint(lint: LintRun) -> dict:
    """The analyzer's verdicts: no unbaselined finding, every family and
    rule of its tables run, the checked-in stubs reproduced."""
    from ray_tpu_torch.analysis import rules

    t0 = time.perf_counter()
    done = lint.wait()
    waited_s = time.perf_counter() - t0
    rc, stdout, stderr, lint_s = done["strict"]
    gen_rc, _gen_out, gen_err, stubs_s = done["stubs"]
    report = json.loads(stdout) if stdout.startswith("{") else {}
    stats = json.loads(lint.stats_path.read_text()) \
        if lint.stats_path.exists() else {}
    stubs_equal = gen_rc == 0 and lint.stubs_path.read_bytes() == (
        lint.root / rules.RPC_STUBS_PATH).read_bytes()
    lint.close()
    family_rules = {r for fam in rules.FAMILIES.values() for r in fam}
    families_ran = sorted(stats.get("sites", {}))
    checks = {
        "strict_exit_0": rc == 0,
        "no_unbaselined_findings": report.get("findings") == [],
        "no_stale_baseline_entries":
            report.get("stale_baseline_entries") == 0,
        "every_family_ran": families_ran == sorted(rules.FAMILIES),
        "every_rule_counted": sorted(stats.get("rules", {}))
            == sorted(rules.ALL_RULES),
        "families_cover_all_rules":
            family_rules | {rules.STALE_PRAGMA} == set(rules.ALL_RULES),
        "stubs_reproduced": stubs_equal,
    }
    return {"ok": all(checks.values()), "checks": checks,
            "families": len(families_ran), "rules": len(rules.ALL_RULES),
            "files": stats.get("files"),
            # seconds from the start (before the build) until each exit
            # was read, and what this phase waited after the build
            "lint_s": round(lint_s, 3), "stubs_s": round(stubs_s, 3),
            "waited_s": round(waited_s, 3),
            "analysis_total_s": stats.get("total_s"),
            "analysis_cpu_s": stats.get("cpu_s"),
            "sites": stats.get("sites"),
            "findings": report.get("findings"),
            "stderr": (stderr + gen_err)[-2000:]}


# -------------------------------------------------------------- kernels


def _inputs(g, b, sq, sk, h, hkv, d, dtype, dev="cuda"):
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device=dev).to(dtype)
    return q, k, v


def _off_grid_segments():
    """(2, 512) segment ids whose boundaries fall off every tile grid."""
    seg = torch.zeros(2, 512, dtype=torch.int32, device="cuda")
    seg[:, 77:] = 1
    seg[:, 200:] = 2
    seg[0, 450:] = 3
    seg[1, 333:] = 4
    return seg


def _bhsd(x):
    """(B, S, H, D) views of a (B, H, S, D) tensor, as
    ``flash_attention_stats`` passes them."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _flash_cases(g):
    """(name, tensors, kwargs) at the slice's prefill and training shapes
    and the edges (of the bf16 kernel's 128-row q tiles and 128-key kv
    tiles among them)."""
    bf = torch.bfloat16
    seg = torch.zeros(2, 1024, dtype=torch.int32, device="cuda")
    seg[:, 300:] = 1
    seg[1, 700:] = 2
    dead_q = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    dead_q[:, 128:] = 5          # segment 5 has no keys: dead rows
    dead_k = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    off_grid = _off_grid_segments()
    return [
        ("prefill_7b_b4_s2048", _inputs(g, 4, 2048, 2048, 32, 32, 128, bf),
         dict(causal=True)),
        ("train_1b_b4_s2048_gqa16_8",
         _inputs(g, 4, 2048, 2048, 16, 8, 128, bf), dict(causal=True)),
        ("gqa_h32_kv8", _inputs(g, 1, 2048, 2048, 32, 8, 128, bf),
         dict(causal=True)),
        ("d64", _inputs(g, 2, 512, 512, 16, 16, 64, bf), dict(causal=True)),
        ("window256", _inputs(g, 1, 2048, 2048, 8, 8, 128, bf),
         dict(causal=True, window=256)),
        ("q_offset512", _inputs(g, 2, 512, 1024, 8, 8, 128, bf),
         dict(causal=True, q_offset=512)),
        ("segment_ids", _inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=True, seg_q=seg, seg_k=seg)),
        ("non_causal", _inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=False)),
        ("fully_masked_rows", _inputs(g, 1, 256, 256, 4, 4, 128, bf),
         dict(causal=False, seg_q=dead_q, seg_k=dead_k)),
        ("s384", _inputs(g, 2, 384, 384, 8, 8, 128, bf), dict(causal=True)),
        ("s400_ragged_d80", _inputs(g, 2, 400, 400, 8, 4, 80, bf),
         dict(causal=True)),
        ("s129_ragged", _inputs(g, 2, 129, 129, 4, 4, 128, bf),
         dict(causal=True)),
        ("s255_ragged", _inputs(g, 2, 255, 255, 4, 2, 128, bf),
         dict(causal=True)),
        ("sq200_sk328_q_offset128", _inputs(g, 2, 200, 328, 4, 4, 128, bf),
         dict(causal=True, q_offset=128)),
        ("window100", _inputs(g, 1, 1024, 1024, 4, 4, 128, bf),
         dict(causal=True, window=100)),
        ("window100_non_causal", _inputs(g, 1, 512, 512, 4, 4, 128, bf),
         dict(causal=False, window=100)),
        ("segments_off_grid", _inputs(g, 2, 512, 512, 4, 2, 128, bf),
         dict(causal=True, seg_q=off_grid, seg_k=off_grid)),
        ("gqa32_8_s300", _inputs(g, 1, 300, 300, 32, 8, 128, bf),
         dict(causal=True)),
        ("d64_s200", _inputs(g, 2, 200, 200, 4, 4, 64, bf),
         dict(causal=True)),
        ("bhsd_views", tuple(_bhsd(x) for x in _inputs(
            g, 2, 256, 256, 4, 2, 128, bf)), dict(causal=True)),
        ("f32_s320", _inputs(g, 1, 320, 320, 4, 4, 128, torch.float32),
         dict(causal=True)),
        # A visible off-diagonal hop of the mesh phase's loopback ring.
        ("ring_hop_full_b1_s2048_gqa16_8",
         _inputs(g, 1, 2048, 2048, 16, 8, 128, bf), dict(causal=False)),
    ]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _live_pairs(sq, sk, q_offset=0, causal=True) -> int:
    """(q, k) pairs per (batch, head) that the causal mask leaves live."""
    if not causal:
        return sq * sk
    return int(np.clip(q_offset + np.arange(sq) + 1, 0, sk).sum())


def _flash_bound(b, sq, sk, h, hkv, d, q_offset=0, causal=True,
                 itemsize=2, head_pairs=None):
    """Least time for the forward on this card: each input read once and
    each output written once over HBM bandwidth, against the QK^T and PV
    flops of the (q, k) pairs this call's masks leave live (``head_pairs``,
    summed over the heads; by default the causal mask's on every head)
    over the bf16 tensor-core peak. Returns (ms, "bytes" | "operations")."""
    if head_pairs is None:
        head_pairs = h * _live_pairs(sq, sk, q_offset, causal)
    flops = 4.0 * b * d * head_pairs
    nbytes = (itemsize * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
              + 4 * b * h * sq)
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _flash_bwd_bounds(b, sq, sk, h, hkv, d, causal=True, itemsize=2,
                      head_pairs=None, prefix="flash"):
    """Least time for each backward kernel on this card: the larger of its
    bytes (each input read once, each output written once) over HBM
    bandwidth and its matrix products over the live (q, k) pairs (as in
    ``_flash_bound``) over the bf16 tensor-core peak. dK/dV does 4 products
    (S, dP, dV, dK), dQ 3 (S, dP, dQ). Returns {kernel: (ms, "bytes" |
    "operations")}, the kernels named ``<prefix>_bwd_dkv`` and
    ``<prefix>_bwd_dq``."""
    if head_pairs is None:
        head_pairs = h * _live_pairs(sq, sk, causal=causal)
    q_bytes = itemsize * b * sq * h * d          # q, dO or dq
    kv_bytes = itemsize * b * sk * hkv * d       # k, v, dk or dv
    stats = 4 * b * h * sq                       # lse or delta (fp32)
    work = {
        f"{prefix}_bwd_dkv": (8.0 * b * d * head_pairs,
                              2 * q_bytes + 4 * kv_bytes + 2 * stats),
        f"{prefix}_bwd_dq": (6.0 * b * d * head_pairs,
                             3 * q_bytes + 2 * kv_bytes + 2 * stats),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _bwd_inputs(g, b, sq, sk, h, hkv, d, dtype, dev="cuda"):
    q, k, v = _inputs(g, b, sq, sk, h, hkv, d, dtype, dev)
    do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    return q, k, v, do


def _flash_bwd_cases(g):
    """(name, (q, k, v, dO), kwargs, with_dlse) at the training path's
    shape and the edges."""
    bf = torch.bfloat16
    seg = torch.zeros(2, 1024, dtype=torch.int32, device="cuda")
    seg[:, 300:] = 1
    seg[1, 700:] = 2
    dead_q = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    dead_q[:, 128:] = 5          # segment 5 has no keys: dead rows
    dead_k = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    off_grid = _off_grid_segments()
    return [
        ("train_1b_b4_s2048", _bwd_inputs(g, 4, 2048, 2048, 16, 8, 128, bf),
         dict(causal=True), False),
        ("gqa_h32_kv8", _bwd_inputs(g, 1, 1024, 1024, 32, 8, 128, bf),
         dict(causal=True), False),
        ("mha_h8", _bwd_inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=True), False),
        ("d64", _bwd_inputs(g, 2, 512, 512, 16, 8, 64, bf),
         dict(causal=True), False),
        ("d80_padded", _bwd_inputs(g, 2, 512, 512, 8, 4, 80, bf),
         dict(causal=True), False),
        ("window256", _bwd_inputs(g, 1, 2048, 2048, 8, 4, 128, bf),
         dict(causal=True, window=256), False),
        ("q_offset512", _bwd_inputs(g, 2, 512, 1024, 8, 8, 128, bf),
         dict(causal=True, q_offset=512), False),
        ("segment_ids", _bwd_inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=True, seg_q=seg, seg_k=seg), False),
        ("non_causal", _bwd_inputs(g, 2, 1024, 1024, 8, 4, 128, bf),
         dict(causal=False), False),
        ("fully_masked_rows", _bwd_inputs(g, 1, 256, 256, 4, 4, 128, bf),
         dict(causal=False, seg_q=dead_q, seg_k=dead_k), False),
        ("s400_ragged", _bwd_inputs(g, 2, 400, 400, 8, 4, 128, bf),
         dict(causal=True), False),
        ("lse_cotangent_stats", _bwd_inputs(g, 2, 512, 512, 8, 8, 128, bf),
         dict(causal=True), True),
        ("f32_s320", _bwd_inputs(g, 1, 320, 320, 4, 2, 128, torch.float32),
         dict(causal=True), False),
        # Edges of the bf16 kernels' tiles: 128-row dQ tiles, 64-key
        # dK/dV tiles and their 64-row q tiles.
        ("s129_ragged", _bwd_inputs(g, 2, 129, 129, 4, 4, 128, bf),
         dict(causal=True), False),
        ("s255_ragged", _bwd_inputs(g, 2, 255, 255, 4, 2, 128, bf),
         dict(causal=True), False),
        ("sq200_sk328_q_offset128",
         _bwd_inputs(g, 2, 200, 328, 4, 4, 128, bf),
         dict(causal=True, q_offset=128), False),
        ("window100", _bwd_inputs(g, 1, 1024, 1024, 4, 4, 128, bf),
         dict(causal=True, window=100), False),
        ("segments_off_grid", _bwd_inputs(g, 2, 512, 512, 4, 2, 128, bf),
         dict(causal=True, seg_q=off_grid, seg_k=off_grid), False),
        ("gqa32_8_s300", _bwd_inputs(g, 1, 300, 300, 32, 8, 128, bf),
         dict(causal=True), False),
        ("d64_s200", _bwd_inputs(g, 2, 200, 200, 4, 4, 64, bf),
         dict(causal=True), False),
        ("lse_cotangent_gqa8_2", _bwd_inputs(g, 2, 512, 512, 8, 2, 128, bf),
         dict(causal=True), True),
        ("bhsd_views", tuple(_bhsd(x) for x in _bwd_inputs(
            g, 2, 256, 256, 4, 2, 128, bf)), dict(causal=True), False),
        # The mesh phase's loopback ring hops: off-diagonal (full) and
        # diagonal (causal), each with the lse cotangent of the merge.
        ("ring_hop_full_dlse_b1_s2048_gqa16_8",
         _bwd_inputs(g, 1, 2048, 2048, 16, 8, 128, bf),
         dict(causal=False), True),
        ("ring_hop_diag_dlse_b1_s2048_gqa16_8",
         _bwd_inputs(g, 1, 2048, 2048, 16, 8, 128, bf),
         dict(causal=True), True),
    ]


def _stats_grads(q, k, v, do, dlse, causal):
    """Gradients through ``flash_attention_stats`` ((B, H, S, D) layout)
    under cotangents for both outputs: the path ring attention uses."""
    from ray_tpu_torch.ops import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out, lse = fa.flash_attention_stats(qt, kt, vt, q.shape[-1] ** -0.5,
                                        causal, None, 0, 64, 64)
    dq, dk, dv = torch.autograd.grad((out, lse), (qt, kt, vt),
                                     (do.transpose(1, 2), dlse))
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _check_flash_bwd(g) -> list:
    """Each backward case: the kernels' dq, dk, dv against the plain
    version on the same (q, k, v, out, lse, dO). Errors are max |error|
    relative to the plain gradient's max |value|: at most 2e-2 in bf16
    (P and dS round to bf16 after sums in another order), 1e-4 in float32
    (bf16 hi + lo split operands, ~2^-16)."""
    from ray_tpu_torch.ops import flash_attention as fa

    results = []
    for name, (q, k, v, do), kw, with_dlse in _flash_bwd_cases(g):
        out, lse = fa.flash_forward(q, k, v, **kw)
        dlse = None
        before = bwd_kernel_counts()
        if with_dlse:
            dlse = torch.randn(lse.shape, generator=g, device="cuda")
            got = _stats_grads(q, k, v, do, dlse, kw["causal"])
        else:
            got = fa.flash_backward(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        # The kernels the C entries launched, read from their own counts.
        route = _route(bwd_kernels_since(before))
        want = fa.flash_backward_reference(q, k, v, out, lse, do, dlse, **kw)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        errs, ok = {}, True
        for gname, a, r in zip(("dq", "dk", "dv"), got, want):
            scale = float(r.float().abs().max())
            err = float((a.float() - r.float()).abs().max())
            errs[gname] = err / max(scale, 1e-30)
            ok = ok and a.dtype == r.dtype and a.shape == r.shape and (
                bool(torch.isfinite(a.float()).all())
                and err <= tol * scale)
        ok = ok and route == ("dkv_wgmma+dq_wgmma" if q.dtype == torch.bfloat16
                              else "dkv_mma_sync_f32+dq_mma_sync_f32")
        if name == "fully_masked_rows":
            ok = ok and not got[0][:, 128:].any()
        results.append({"case": f"bwd_{name}", "route": route, "ok": ok,
                        "rel_max_abs_err": errs, "tol": tol})
        del q, k, v, do, out, lse, got, want
    torch.cuda.empty_cache()
    return results


def _time_flash_bwd(g, record: dict) -> dict:
    """Time each backward kernel at the 1B training shape beside the plain
    version and the library yardstick (the backward of PyTorch's SDPA,
    timed only, on each backend that takes the call, the fastest used),
    with the delta pre-pass and the unit (delta + dK/dV + dQ, what SDPA's
    backward computes), the host time a call, and each kernel's bound."""
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.tools.flash_ab import sdpa_backward_ms

    b, s, h, hkv, d = 4, 2048, 16, 8, 128
    q, k, v, do = _bwd_inputs(g, b, s, s, h, hkv, d, torch.bfloat16)
    scale = d ** -0.5
    out, lse = fa.flash_forward(q, k, v, causal=True)
    delta = fa.attention_delta(out, do)
    want = fa.flash_backward_reference(q, k, v, out, lse, do, causal=True)
    got = fa.flash_backward(q, k, v, out, lse, do, causal=True)
    errs = [float((a.float() - r.float()).abs().max())
            for a, r in zip(got, want)]
    del got, want

    # Timed through the launcher alone: validation and allocation happen
    # once, so the wrapper's host work does not enter the kernel time.
    launch, _ = fa._backward_launcher(q, k, v, do, lse, delta, None, None,
                                      None, scale, True, None, 0)

    def pair():
        launch("dkv")
        launch("dq")

    ms = {"flash_bwd_dkv": _time_ms(lambda: launch("dkv"), iters=20),
          "flash_bwd_dq": _time_ms(lambda: launch("dq"), iters=20)}
    pair_ms = _time_ms(pair, iters=20)
    delta_ms = _time_ms(fa._delta_launcher(out, do)[0], iters=20)
    delta_plain_ms = _time_ms(lambda: fa.attention_delta_reference(out, do),
                              iters=20)
    plain_ms = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, out, lse, do, causal=True), iters=3, warmup=1)
    lib = sdpa_backward_ms(q, k, v, do)
    # Host time a backward call: the two C entries alone (seven and four
    # tensor maps encoded, two launches) and the whole wrapper (delta,
    # validation, allocation).
    launch_host_ms = _host_ms(pair)
    wrapper_host_ms = _host_ms(lambda: fa.flash_backward(
        q, k, v, out, lse, do, causal=True))
    bounds = _flash_bwd_bounds(b, s, s, h, hkv, d)
    max_err = {"flash_bwd_dkv": max(errs[1], errs[2]),
               "flash_bwd_dq": errs[0]}
    ptxas = cuda_build_rows(cuda_build, "flash_bwd")
    for name, kernel in (("flash_bwd_dkv", "flash_bwd_dkv_wgmma_kernel"),
                         ("flash_bwd_dq", "flash_bwd_dq_wgmma_kernel")):
        record[name] = {"max_abs_err": max_err[name], "ms": ms[name],
                        "plain_ms": plain_ms, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "library_ms": lib["sdpa_bwd_ms"],
                        "ptxas": [r for r in ptxas if r.startswith(kernel)]}
    del q, k, v, do, out, lse, delta, launch
    torch.cuda.empty_cache()
    return {"bwd_timing_shape": {"B": b, "S": s, "H": h, "Hkv": hkv,
                                 "D": d, "causal": True,
                                 "dtype": "bfloat16"},
            "bwd_pair_ms": pair_ms, "bwd_delta_ms": delta_ms,
            "bwd_delta_plain_ms": delta_plain_ms,
            "bwd_unit_ms": delta_ms + pair_ms,
            "bwd_launch_host_ms": launch_host_ms,
            "bwd_wrapper_host_ms": wrapper_host_ms,
            "bwd_library_is": f"SDPA backward ({lib['sdpa_backend']}, the "
                              "fastest backend that takes the call; dq, dk, "
                              "dv together)",
            "bwd_sdpa_ms_by_backend": lib["sdpa_bwd_ms_by_backend"],
            "bwd_plain_is": "flash_backward_reference (dq, dk, dv together)"}


def _delta_cases(g):
    """(name, (out, dO)) at the shapes and layouts the two backward paths
    hand the delta pre-pass, before D is padded: the 1B training and the
    splash shapes, a ragged S, D 64 and 80, float32, and the (B, S, H, D)
    view of a (B, H, S, D) tensor that ``flash_attention_stats`` passes."""
    def pair(b, s, h, d, dtype=torch.bfloat16):
        return tuple(torch.randn(b, s, h, d, generator=g, device="cuda")
                     .to(dtype) for _ in range(2))

    return [("train_1b_b4_s2048", pair(4, 2048, 16, 128)),
            ("splash_b1_s8192", pair(1, 8192, 16, 128)),
            ("s129", pair(2, 129, 4, 128)),
            ("d64", pair(2, 512, 16, 64)),
            ("d80_unpadded", pair(2, 512, 8, 80)),
            ("f32_s320", pair(1, 320, 4, 128, torch.float32)),
            ("bhsd_view", tuple(_bhsd(x) for x in pair(2, 256, 4, 128)))]


def _delta_bound(out):
    """Least time for the delta pre-pass on this card: O and dO read once
    and delta written once over HBM bandwidth, against its 2 fp32 flops an
    element over the fp32 peak outside the tensor cores."""
    b, s, h, _ = out.shape
    t_bytes = (2 * out.numel() * out.element_size() + 4 * b * h * s) \
        / PEAK_BYTES
    t_ops = 2.0 * out.numel() / PEAK_F32_FLOPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check_delta(g, record) -> list:
    """Each delta case: ``delta.cu``'s kernel (one launch) against
    ``attention_delta_reference``, within 1e-5 of the largest |delta| (the
    same fp32 products summed in another order); at the 1B training and
    splash shapes also timed (launch only) beside the plain version and
    the bound. No single PyTorch call computes it (an fp32 sum of bf16
    products into (B, H, S)), so it has no library time."""
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops import flash_attention as fa

    results = []
    for name, (out, do) in _delta_cases(g):
        before = fa.attention_delta.launches
        got = fa.attention_delta(out, do)
        torch.cuda.synchronize()
        launched = fa.attention_delta.launches - before
        want = fa.attention_delta_reference(out, do)
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        res = {"case": f"delta_{name}",
               "ok": launched == 1 and got.shape == want.shape
               and got.is_contiguous() and err <= tol,
               "max_abs_err": err, "tol": tol}
        if name in ("train_1b_b4_s2048", "splash_b1_s8192"):
            launch, _ = fa._delta_launcher(out, do)
            res["ms"] = _time_ms(launch, iters=50)
            res["plain_ms"] = _time_ms(
                lambda: fa.attention_delta_reference(out, do), iters=20)
            res["bound_ms"], res["bound_by"] = _delta_bound(out)
        results.append(res)
        del out, do, got, want
    torch.cuda.empty_cache()
    train, splash = results[0], results[1]
    record["attention_delta"] = {
        **{k: train[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
        "library_ms": None,
        "at_splash": {k: splash[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "max_abs_err")},
        "ptxas": cuda_build_rows(cuda_build, "delta")}
    return results


def _host_ms(fn, iters: int = 20) -> float:
    """Host time a call of ``fn``: ``iters`` calls enqueued, no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def _time_flash_fwd(g, b, s, h, hkv, d, plain=True) -> dict:
    """The forward at one causal bf16 shape: the kernel timed through the
    launcher alone (the wrapper's host work per call can exceed the
    kernel's time), the full wrapper per call, the plain version, SDPA on
    the same call (``enable_gqa`` where hkv < h) and the card's bound."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(g, b, s, s, h, hkv, d, torch.bfloat16)
    launch, _ = fa._forward_launcher(q, k, v, None, None, d ** -0.5, True,
                                     None, 0)
    res = {"shape": {"B": b, "S": s, "H": h, "Hkv": hkv, "D": d,
                     "causal": True, "dtype": "bfloat16"},
           "ms": _time_ms(launch, iters=20),
           "wrapper_ms": _time_ms(
               lambda: fa.flash_forward(q, k, v, causal=True), iters=20)}
    # Host time a call: the C entry alone (three tensor maps encoded and
    # the launch) and the whole wrapper.
    res["launch_host_ms"] = _host_ms(launch)
    res["wrapper_host_ms"] = _host_ms(
        lambda: fa.flash_forward(q, k, v, causal=True))
    if plain:
        res["plain_ms"] = _time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=True),
            iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    res["library_ms"] = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=hkv != h), iters=20)
    res["bound_ms"], res["bound_by"] = _flash_bound(b, s, s, h, hkv, d)
    del q, k, v, qt, kt, vt, launch
    torch.cuda.empty_cache()
    return res


def phase_kernels(record: dict) -> dict:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    errs = {}
    for name, (q, k, v), kw in _flash_cases(g):
        before = fwd_kernel_counts()
        out, lse = fa.flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        # The kernel the C entry launched, read from its own counts.
        route = _route(fwd_kernels_since(before))
        ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
              and torch.allclose(lse, ref_lse, rtol=1e-3, atol=1e-3)
              and bool(torch.isfinite(out.float()).all())
              and route == ("wgmma" if q.dtype == torch.bfloat16
                            else "mma_sync_f32"))
        if name == "fully_masked_rows":
            ok = ok and not out[:, 128:].any() and bool(
                (lse[:, :, 128:] == -1e30).all())
        results.append({"case": name, "route": route,
                        "ok": ok, "max_abs_err": err,
                        "lse_max_abs_err": lse_err, "tol": tol})
        errs[name] = err
        del out, lse, ref, ref_lse
    torch.cuda.empty_cache()

    # Through the model at a small size: flash vs plain attention logits
    # (fp32 debug preset; its head dim 16 pads to the kernel's 64).
    cfg = replace(llama.PRESETS["debug"], dtype=torch.float32)
    params = llama.init_params(cfg, device="cuda", seed=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                         device="cuda")
    plain = llama.forward(params, toks, replace(cfg, attention_impl="xla"))
    before = fwd_kernel_counts()
    flash = llama.forward(params, toks, replace(cfg, attention_impl="flash"))
    by_kernel = fwd_kernels_since(before)
    model_err = float((plain - flash).abs().max())
    results.append({"case": "debug_model_logits_f32",
                    "route": _route(by_kernel),
                    "ok": model_err < 1e-3 and by_kernel["wgmma"] == 0
                    and by_kernel["mma_sync_f32"] > 0,
                    "max_abs_err": model_err, "tol": 1e-3})

    # Timing at the serving path's largest prefill shape (the kernels
    # line's numbers) and at the 1B training shape.
    prefill = _time_flash_fwd(g, 4, 2048, 32, 32, 128)
    train = _time_flash_fwd(g, 4, 2048, 16, 8, 128, plain=False)
    train["max_abs_err"] = errs["train_1b_b4_s2048_gqa16_8"]
    record["flash_fwd"] = {
        "max_abs_err": errs["prefill_7b_b4_s2048"],
        **{key: prefill[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        "wrapper_ms": prefill["wrapper_ms"],
        "wrapper_host_ms": prefill["wrapper_host_ms"],
        "launch_host_ms": prefill["launch_host_ms"],
        "at_train_1b": {key: train[key] for key in (
            "shape", "ms", "wrapper_ms", "wrapper_host_ms", "launch_host_ms",
            "bound_ms", "bound_by", "library_ms", "max_abs_err")},
        "ptxas": cuda_build_rows(cuda_build, "flash_fwd")}

    results += _check_flash_bwd(g)
    bwd = _time_flash_bwd(g, record)
    results += _check_delta(g, record)
    ok = all(r["ok"] for r in results)
    return {"ok": ok, "cases": results,
            "timing_shape": prefill["shape"],
            **bwd,
            **{f"{name}_{key}": val for name in PATH_KERNELS["train"]
               for key, val in record[name].items()}}


# --------------------------------------------------------------- splash

# The splash path: splash attention forward and backward at the 1B
# preset's attention width (16 q heads on 8 kv heads, head_dim 128) on a
# GQA-aligned local / chunked / causal / global head stack. Live (q, k)
# pairs per head at S = 8192: local 7,864,832, chunked 8,392,704, causal
# 33,558,528, full 67,108,864; 297,824,256 for the call.
SPLASH_SHAPE = dict(b=1, s=8192, h=16, hkv=8, d=128)
SPLASH_PAIRS = 297_824_256
# Launches of each kernel a splash forward + backward call over the four
# head groups: each splash kernel once over all groups, after one delta.
SPLASH_LAUNCHES = {"splash_fwd": 1, "splash_bwd_dkv": 1, "splash_bwd_dq": 1,
                   "attention_delta": 1}
# The splash wrappers' host time a forward + backward call when dQ launched
# once per head group (six kernel-argument sets a call): 0.461 ms, read by
# this script on an NVIDIA H100 80GB HBM3 at 700 W. The phase prints this
# run's beside it.
SPLASH_WRAPPER_HOST_MS_PER_GROUP_DQ = 0.461


def _splash_masks():
    from ray_tpu_torch.ops import splash_attention as ss

    return ([ss.LocalMask(1024)] * 8 + [ss.ChunkedMask(2048)] * 4
            + [ss.CausalMask()] * 2 + [ss.FullMask()] * 2)


def _rel_err(got, want) -> float:
    """max |got - want| relative to max |want|."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


def _kv_head_slices(q, k):
    """(query-head slice, kv-head slice) of each kv head."""
    group = q.shape[2] // k.shape[2]
    return [(slice(i * group, (i + 1) * group), slice(i, i + 1))
            for i in range(k.shape[2])]


def _splash_plain(q, k, v, do, masks):
    """The plain forward and backward of the splash call, one kv head (and
    its query heads) at a time to keep the (S, S) scores small: ((out,
    lse), (dq, dk, dv)) in the kernels' layouts."""
    from ray_tpu_torch.ops import splash_attention as ss

    outs, lses, grads = [], [], []
    for qs, ks in _kv_head_slices(q, k):
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        out, lse = ss.splash_attention_reference(*args, masks[qs])
        grads.append(ss.splash_backward_reference(*args, out, lse,
                                                  do[:, :, qs], masks[qs]))
        outs.append(out)
        lses.append(lse)
    return ((torch.cat(outs, 2), torch.cat(lses, 1)),
            tuple(torch.cat(g, 2) for g in zip(*grads)))


def _splash_cases(g, dev):
    """(name, (q, k, v, dO), masks) at the edges of the splash kernels."""
    from ray_tpu_torch.ops import splash_attention as ss

    def inputs(*shape, dtype=torch.bfloat16):
        return _bwd_inputs(g, *shape, dtype, dev)

    return [
        ("f32_mixed", inputs(1, 512, 512, 4, 2, 128, dtype=torch.float32),
         [ss.LocalMask(100)] * 2 + [ss.ChunkedMask(192)] * 2),
        ("d64", inputs(2, 1024, 1024, 8, 4, 64),
         [ss.CausalMask()] * 4 + [ss.LocalMask(256)] * 2
         + [ss.FullMask()] * 2),
        ("d80_padded", inputs(1, 512, 512, 4, 2, 80),
         [ss.ChunkedMask(128)] * 2 + [ss.FullMask()] * 2),
        ("s100_ragged", inputs(2, 100, 100, 8, 4, 128),
         [ss.LocalMask(30)] * 2 + [ss.ChunkedMask(40)] * 2
         + [ss.CausalMask()] * 2 + [ss.FullMask()] * 2),
        # Queries 95.. see no key within the window: out 0, lse -1e30,
        # zero gradients; q tiles 2-3 have no live kv tile at all.
        ("degenerate_rows", inputs(1, 256, 64, 2, 1, 128),
         [ss.LocalMask(32)] * 2),
        ("sq200_sk328_full", inputs(1, 200, 328, 4, 2, 128),
         [ss.FullMask()] * 4),
        # Edges of the wgmma kernels' tiles (128-row q tiles in the
        # forward, 64-key tiles and 64-row q tiles in dK/dV, statistics
        # rows that start off a multiple of 4) and their one launch over
        # every head group: GQA 1, 2 and 4, B=2, D 64 and 128.
        ("s129_gqa1", inputs(2, 129, 129, 4, 4, 128),
         [ss.LocalMask(70)] * 2 + [ss.CausalMask()] * 2),
        ("s255_gqa4_d64", inputs(2, 255, 255, 8, 2, 64),
         [ss.ChunkedMask(100)] * 4 + [ss.FullMask()] * 4),
        ("sq200_sk328_gqa2_b2", inputs(2, 200, 328, 4, 2, 128),
         [ss.CausalMask()] * 2 + [ss.LocalMask(64)] * 2),
        ("degenerate_rows_d64_gqa2", inputs(2, 256, 64, 4, 2, 64),
         [ss.LocalMask(32)] * 4),
        ("alternating_8_groups", inputs(1, 512, 512, 8, 8, 128),
         [ss.LocalMask(96), ss.FullMask()] * 4),
        ("f32_s129_gqa2", inputs(1, 129, 129, 4, 2, 64, dtype=torch.float32),
         [ss.CausalMask()] * 2 + [ss.LocalMask(40)] * 2),
    ]


def splash_kernel_counts(device="cuda") -> dict:
    """Launches of each kernel behind ``splash.cu``'s entries, as the C
    entries count them (none off the card)."""
    if torch.device(device).type != "cuda":
        return {}
    from ray_tpu_torch.ops.splash_attention import kernel_launches

    return kernel_launches()


def splash_kernels_since(before: dict, device="cuda") -> dict:
    return {k: n - before.get(k, 0)
            for k, n in splash_kernel_counts(device).items()}


def splash_calls_on(by_kernel: dict, calls: int, dtype, device) -> bool:
    """``calls`` forward + backward splash calls launched one forward, one
    dK/dV and one dQ kernel a call, over all their head groups, on wgmma
    for bf16 and mma.sync for float32 (off the card nothing launches)."""
    if torch.device(device).type != "cuda":
        return True
    route = "wgmma" if dtype == torch.bfloat16 else "mma_sync_f32"
    want = {k: 0 for k in by_kernel}
    want.update({f"{kind}_{route}": calls for kind in ("fwd", "dkv", "dq")})
    return by_kernel == want


def _check_splash_cases(g, dev) -> list:
    """Each edge case: the forward kernel's out and lse against the plain
    forward, and the backward kernels' dq, dk, dv against the plain
    backward on the same (out, lse), with the kernels the C entries
    counted (one forward, one dK/dV and one dQ launch, on wgmma for bf16
    and mma.sync for float32; ``dq_kernel`` names dQ's). Tolerances as the
    flash checks: out at rtol = atol = 2e-2 in bf16 and 1e-4 in float32,
    gradients by max |error| relative to the plain gradient's max at the
    same two."""
    from ray_tpu_torch.ops import splash_attention as ss

    results = []
    for name, (q, k, v, do), masks in _splash_cases(g, dev):
        before = splash_kernel_counts(dev)
        out, lse = ss.splash_forward(q, k, v, masks)
        got = ss.splash_backward(q, k, v, out, lse, do, masks)
        _sync(dev)
        by_kernel = splash_kernels_since(before, dev)
        ref, ref_lse = ss.splash_attention_reference(q, k, v, masks)
        want = ss.splash_backward_reference(q, k, v, out, lse, do, masks)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        live = ref_lse > -1e29
        ok = (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
              and torch.allclose(lse[live], ref_lse[live], rtol=1e-3,
                                 atol=1e-3)
              and bool((lse[~live] == -1e30).all()))
        errs = {"out": float((out.float() - ref.float()).abs().max())}
        for gname, a, r in zip(("dq", "dk", "dv"), got, want):
            errs[gname] = _rel_err(a, r)
            ok = ok and a.dtype == r.dtype and a.shape == r.shape and (
                bool(torch.isfinite(a.float()).all()) and errs[gname] <= tol)
        if name.startswith("degenerate_rows"):
            ok = ok and not out[:, 95:].any() and not got[0][:, 95:].any() \
                and bool((lse[:, :, 95:] == -1e30).all())
        ok = ok and splash_calls_on(by_kernel, 1, q.dtype, dev)
        results.append({"case": f"splash_{name}", "ok": ok,
                        "route": _route(by_kernel),
                        "dq_kernel": _route({k_: n for k_, n in
                                             by_kernel.items()
                                             if k_.startswith("dq_")}),
                        "max_abs_err_out": errs.pop("out"),
                        "rel_max_abs_err": errs, "tol": tol})
    torch.cuda.empty_cache()
    return results


def _sdpa_backend(qt, kt, vt, mask):
    """The first SDPA backend that takes this boolean mask, forward and
    backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)
                torch.autograd.grad(out, (qt, kt, vt), torch.ones_like(out),
                                    retain_graph=True)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes a boolean mask here")


def _splash_keep(masks, s, dev):
    """Each distinct mask's (S, S) boolean keep matrix, from its own
    ``apply``."""
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    return {m: m.apply(torch.zeros(s, s, device=dev), rows, cols) == 0
            for m in set(masks)}


def _time_splash(q, k, v, do, masks, keep, errs, record) -> dict:
    """Time each splash kernel at the path's shape (launches alone, all
    head groups per call) beside the plain version, SDPA with the dense
    boolean mask ``keep`` gives, and the card's bound over this call's
    live pairs."""
    from torch.nn.attention import sdpa_kernel

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as ss

    b, s, h, d = q.shape[0], q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[2]
    scale = d ** -0.5
    head_pairs = sum(int(keep[m].sum()) for m in masks)
    launch, (out, lse) = ss._splash_forward_launcher(q, k, v, masks, scale)
    ms = {"splash_fwd": _time_ms(launch, iters=20)}
    delta = fa.attention_delta(out, do)
    launch_b, _ = ss._splash_backward_launcher(q, k, v, do, lse, delta,
                                               masks, scale)
    ms["splash_bwd_dkv"] = _time_ms(lambda: launch_b("dkv"), iters=20)
    ms["splash_bwd_dq"] = _time_ms(lambda: launch_b("dq"), iters=20)

    def launches():
        launch()
        launch_b("dkv")
        launch_b("dq")

    def wrapper():
        o, l_ = ss.splash_forward(q, k, v, masks)
        ss.splash_backward(q, k, v, o, l_, do, masks)

    # Host time a forward + backward call: the C entries alone (one
    # launch each) and the whole wrappers (delta, validation, allocation,
    # the cached schedules' lookup), beside the per-group dQ design's.
    host = {"launch_host_ms": _host_ms(launches),
            "wrapper_host_ms": _host_ms(wrapper),
            "wrapper_host_ms_per_group_dq":
                SPLASH_WRAPPER_HOST_MS_PER_GROUP_DQ,
            "fwd_bwd_ms": _time_ms(wrapper, iters=10)}
    heads = _kv_head_slices(q, k)
    plain_fwd_ms = _time_ms(lambda: [ss.splash_attention_reference(
        q[:, :, qs], k[:, :, ks], v[:, :, ks], masks[qs])
        for qs, ks in heads], iters=2, warmup=1)
    plain_bwd_ms = _time_ms(lambda: [ss.splash_backward_reference(
        q[:, :, qs], k[:, :, ks], v[:, :, ks], out[:, :, qs], lse[:, qs],
        do[:, :, qs], masks[qs]) for qs, ks in heads], iters=2, warmup=1)
    del launch, launch_b, delta

    # Library yardstick: SDPA with the dense (H, S, S) boolean mask, k and
    # v expanded to the 16 query heads.
    dense = torch.stack([keep[m] for m in masks])[None]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // hkv, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    backend = _sdpa_backend(qt, kt, vt, dense)
    dot = do.transpose(1, 2)
    with sdpa_kernel([backend]):
        lib_fwd_ms = _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=dense), iters=10)
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=dense)
        lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del dense, qt, kt, vt, lib_out
    torch.cuda.empty_cache()

    bound_fwd = _flash_bound(b, s, s, h, hkv, d, head_pairs=head_pairs)
    bounds = {"splash_fwd": bound_fwd,
              **_flash_bwd_bounds(b, s, s, h, hkv, d, head_pairs=head_pairs,
                                  prefix="splash")}
    plain = {"splash_fwd": plain_fwd_ms, "splash_bwd_dkv": plain_bwd_ms,
             "splash_bwd_dq": plain_bwd_ms}
    lib = {"splash_fwd": lib_fwd_ms, "splash_bwd_dkv": lib_bwd_ms,
           "splash_bwd_dq": lib_bwd_ms}
    from ray_tpu_torch.ops import cuda_build

    ptxas = cuda_build_rows(cuda_build, "splash")
    for name in ms:
        record[name] = {"max_abs_err": errs[name], "ms": ms[name],
                        "plain_ms": plain[name], "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1], "library_ms": lib[name],
                        "ptxas": [r for r in ptxas if r.startswith(name)]}
    dq_flops = 6.0 * b * d * head_pairs
    return {"bwd_pair_ms": ms["splash_bwd_dkv"] + ms["splash_bwd_dq"],
            "dq_ms": ms["splash_bwd_dq"],
            "dq_bound_ms": bounds["splash_bwd_dq"][0],
            "dq_tflops": dq_flops / ms["splash_bwd_dq"] / 1e9,
            "dq_share_of_bound_rate": bounds["splash_bwd_dq"][0]
            / ms["splash_bwd_dq"],
            **host,
            "library_is": f"SDPA ({backend.name}) with a dense ({h}, S, S) "
                          f"boolean mask, k/v expanded to {h} heads; "
                          "backward gives dq, dk, dv together",
            "plain_is": "splash_attention_reference / "
                        "splash_backward_reference, one kv head at a time"}


# The head groups of the splash stack that a flash mask also describes:
# (name, q heads, flash_forward's keywords).
FLASH_TWINS = (("local", (0, 8), dict(causal=True, window=1024)),
               ("causal", (12, 14), dict(causal=True)),
               ("full", (14, 16), dict(causal=False)))


def _time_groups(q, k, v, do, masks) -> dict:
    """Launch-only times (CUDA events, 20 launches after warm-up) of each
    splash kernel on each head group alone, beside the flash kernel on the
    same heads where a flash mask describes the group: where the call's
    time goes, and the cost of walking a tile list instead of a range."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as ss

    scale = q.shape[-1] ** -0.5
    group = q.shape[2] // k.shape[2]
    twins = {heads: kw for _, heads, kw in FLASH_TWINS}
    res = {}
    for a, c, m in ss._group_heads(masks):
        qs, ks = slice(a, a + c), slice(a // group, (a + c) // group)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        s_fwd, (out, lse) = ss._splash_forward_launcher(*args, masks[qs],
                                                        scale)
        s_fwd()
        delta = fa.attention_delta(out, do[:, :, qs])
        s_bwd, _ = ss._splash_backward_launcher(*args, do[:, :, qs], lse,
                                                delta, masks[qs], scale)
        times = {"fwd_ms": {"splash": _time_ms(s_fwd, 20)},
                 "bwd_dkv_ms": {"splash": _time_ms(lambda: s_bwd("dkv"), 20)},
                 "bwd_dq_ms": {"splash": _time_ms(lambda: s_bwd("dq"), 20)}}
        kw = twins.get((a, a + c))
        if kw is not None:
            mask_args = (kw["causal"], kw.get("window"), 0)
            f_fwd, _ = fa._forward_launcher(*args, None, None, scale,
                                            *mask_args)
            f_bwd, _ = fa._backward_launcher(*args, do[:, :, qs], lse, delta,
                                             None, None, None, scale,
                                             *mask_args)
            times["fwd_ms"]["flash"] = _time_ms(f_fwd, 20)
            times["bwd_dkv_ms"]["flash"] = _time_ms(lambda: f_bwd("dkv"), 20)
            times["bwd_dq_ms"]["flash"] = _time_ms(lambda: f_bwd("dq"), 20)
        res[f"{type(m).__name__} heads {a}-{a + c - 1}"] = times
    return res


def _against_flash(q, k, v, do, out, grads) -> dict:
    """The splash kernels' out and gradients on the local, causal and full
    heads against the flash kernels on the same heads (window=1024,
    causal, non-causal): two hand-written kernels agree or one is wrong.
    Max |error| relative to the flash value's max; at most 2e-2 (bf16)."""
    from ray_tpu_torch.ops import flash_attention as fa

    res = {}
    for name, heads, kw in FLASH_TWINS:
        qs, ks = slice(*heads), slice(heads[0] // 2, heads[1] // 2)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        f_out, f_lse = fa.flash_forward(*args, **kw)
        f_grads = fa.flash_backward(*args, f_out, f_lse, do[:, :, qs], **kw)
        errs = {"out": _rel_err(out[:, :, qs], f_out)}
        for gname, a, r, sl in zip(("dq", "dk", "dv"), grads, f_grads,
                                   (qs, ks, ks)):
            errs[gname] = _rel_err(a[:, :, sl], r)
        res[name] = {"rel_max_abs_err": errs,
                     "ok": max(errs.values()) <= 2e-2}
    return res


def phase_splash(record: dict, device="cuda", shape=None) -> dict:
    """The splash path: ``splash_attention`` forward and backward through
    the autograd Function at the 1B attention width, S = 8192, bf16, the
    default 256 blocks, with exact launch counts; the result against the
    plain version and against the flash kernels; the edge cases; on the
    card, the timings. ``shape`` (a ``SPLASH_SHAPE`` dict) shrinks it for
    a rehearsal on the CPU, where the kernels' plain versions run."""
    from ray_tpu_torch.ops import splash_attention as ss

    shape = shape or SPLASH_SHAPE
    b, s, h, hkv, d = (shape[x] for x in ("b", "s", "h", "hkv", "d"))
    cuda = torch.device(device).type == "cuda"
    g = torch.Generator(device=device).manual_seed(3)
    q, k, v, do = _bwd_inputs(g, b, s, s, h, hkv, d, torch.bfloat16, device)
    masks = _splash_masks()
    keep = _splash_keep(masks, s, device)
    head_pairs = sum(int(keep[m].sum()) for m in masks)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    reset_counts()
    before = splash_kernel_counts(device)
    t0 = time.perf_counter()
    out = ss.splash_attention(*leaves, mask=masks)
    out.backward(do)
    _sync(device)
    wall_s = [time.perf_counter() - t0]
    counts = launch_counts()
    by_kernel = splash_kernels_since(before, device)
    grads = tuple(x.grad for x in leaves)
    out = out.detach()
    # A second call: the schedules come from the cache and the kernels are
    # loaded, so its wall time is the op's steady cost on the host clock.
    t0 = time.perf_counter()
    torch.autograd.grad(ss.splash_attention(*leaves, mask=masks), leaves,
                        do)
    _sync(device)
    wall_s.append(time.perf_counter() - t0)
    del leaves

    (ref, _), ref_grads = _splash_plain(q, k, v, do, masks)
    tol = 2e-2
    errs = {"out": float((out.float() - ref.float()).abs().max())}
    errs.update({n: _rel_err(a, r) for n, a, r in
                 zip(("dq", "dk", "dv"), grads, ref_grads)})
    checks = {
        # One forward, one dK/dV and one dQ launch over all four head
        # groups, after one delta; bf16, so all three on wgmma.
        "launches_1_1_1": counts == {
            k_: SPLASH_LAUNCHES.get(k_, 0) for k_ in KERNELS},
        "splash_on_wgmma": splash_calls_on(by_kernel, 1, torch.bfloat16,
                                           device),
        "out_matches_plain": torch.allclose(out.float(), ref.float(),
                                            rtol=tol, atol=tol),
        "grads_match_plain": max(errs["dq"], errs["dk"], errs["dv"]) <= tol,
        "finite": all(bool(torch.isfinite(t.float()).all())
                      for t in (out, *grads)),
    }
    if shape == SPLASH_SHAPE:
        checks["live_pairs_297824256"] = head_pairs == SPLASH_PAIRS
    del ref, ref_grads
    flash = _against_flash(q, k, v, do, out, grads)
    checks["matches_flash_kernels"] = all(r["ok"] for r in flash.values())
    cases = _check_splash_cases(g, device)
    checks["edge_cases"] = all(r["ok"] for r in cases)
    res = {"shape": {**shape, "dtype": "bfloat16", "block_q": 256,
                     "block_k": 256,
                     "masks": "heads 0-7 LocalMask(1024), 8-11 "
                              "ChunkedMask(2048), 12-13 CausalMask, "
                              "14-15 FullMask"},
           "launches": counts, "splash_by_kernel": by_kernel,
           "fwd_bwd_wall_s_first_second": wall_s,
           "live_pairs_per_head": {type(m).__name__: int(keep[m].sum())
                                   for m in keep},
           "live_pairs": head_pairs, "max_err_vs_plain": errs, "tol": tol,
           "vs_flash": flash, "cases": cases}
    if cuda:
        torch.cuda.empty_cache()
        res.update(_time_splash(
            q, k, v, do, masks, keep,
            {"splash_fwd": errs["out"], "splash_bwd_dq": errs["dq"],
             "splash_bwd_dkv": max(errs["dk"], errs["dv"])}, record))
        res["group_ms"] = _time_groups(q, k, v, do, masks)
        for name, prefix in (("splash_fwd", "fwd_"),
                             ("splash_bwd_dkv", "dkv_"),
                             ("splash_bwd_dq", "dq_")):
            record[name]["launches_by_kernel"] = {
                k_: n for k_, n in by_kernel.items() if k_.startswith(prefix)}
        res.update({f"{name}_{key}": val for name in PATH_KERNELS["splash"]
                    if name.startswith("splash")
                    for key, val in record[name].items()})
        res["device"] = smi_line()
    del q, k, v, do, out, grads, keep
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


# ---------------------------------------------------------------- serve


def _solo_greedy(engine, prompt, n):
    """Solo greedy decode of one prompt on the deployment's weights, its
    prompt padded to the engine's bucket: (tokens, top-2 margins)."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, params, dev = engine.config, engine.params, engine.device
    s = len(prompt)
    cache = ld.init_cache(cfg, 1, ld.cache_bucket(s + n), device=dev)
    padded = torch.zeros(1, ld.cache_bucket(s, engine.prefill_bucket),
                         dtype=torch.long, device=dev)
    padded[0, :s] = torch.as_tensor(prompt, device=dev)
    logits, cache = ld.prefill(params, padded, cache, cfg,
                               lengths=torch.tensor([s], device=dev))
    out, margins = [], []
    for _ in range(n):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        logits, cache = ld.decode_step(
            params, cache, torch.tensor([tok], dtype=torch.int32,
                                        device=dev), cfg)
    del cache
    return out, margins


def _path_drift(engine, batch_prompts, src, sharer, prefix_len) -> dict:
    """Max |logit| differences between the ways the engine may compute the
    same next-token logits: a prompt prefilled alone vs in a batch of four
    (cut to the first prompt's length), one decode step after each, and a
    prefix-hit suffix prefill over ``src``'s cached K/V vs a full prefill
    of ``sharer``. The margin rule's tolerance must cover all of them."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, dev, params = engine.config, engine.device, engine.params
    s = len(batch_prompts[0])
    bucket = ld.cache_bucket(s, engine.prefill_bucket)
    n = len(batch_prompts)
    rows = torch.zeros(n, bucket, dtype=torch.long, device=dev)
    for i, p in enumerate(batch_prompts):
        rows[i, :s] = torch.as_tensor(p[:s], device=dev)
    lengths = torch.full((n,), s, device=dev)
    c1 = ld.init_cache(cfg, 1, bucket * 2, device=dev)
    cn = ld.init_cache(cfg, n, bucket * 2, device=dev)
    solo, c1 = ld.prefill(params, rows[:1], c1, cfg, lengths=lengths[:1])
    batch, cn = ld.prefill(params, rows, cn, cfg, lengths=lengths)
    out = {"prefill_batch": float((solo[0] - batch[0]).abs().max())}
    tok = torch.argmax(solo, dim=-1).to(torch.int32)
    solo, c1 = ld.decode_step(params, c1, tok, cfg)
    batch, cn = ld.decode_step(params, cn, tok.repeat(n), cfg)
    out["decode_batch"] = float((solo[0] - batch[0]).abs().max())
    del c1, cn

    def padded(p, b):
        t = torch.zeros(1, b, dtype=torch.long, device=dev)
        t[0, :len(p)] = torch.as_tensor(p, device=dev)
        return t

    cap = engine.capacity
    full, _ = ld.prefill(
        params, padded(sharer, ld.cache_bucket(len(sharer))),
        ld.init_cache(cfg, 1, cap, device=dev), cfg,
        lengths=torch.tensor([len(sharer)], device=dev))
    cache = ld.init_cache(cfg, 1, cap, device=dev)
    ld.prefill(params, padded(src, ld.cache_bucket(len(src))), cache, cfg,
               lengths=torch.tensor([len(src)], device=dev))
    suffix = sharer[prefix_len:]
    hit, _ = ld.prefill_suffix(
        params, padded(suffix, ld.cache_bucket(len(suffix), 16)), cache,
        cfg, torch.tensor([prefix_len], device=dev),
        torch.tensor([len(sharer)], device=dev))
    out["suffix_vs_full"] = float((hit[0] - full[0]).abs().max())
    return out


def _agrees(got, want, margins, tol):
    """Margin rule: equal tokens while the solo top-2 margin exceeds tol;
    stop at the first position within tol. Returns positions compared,
    or -1 on a disagreement outside the rule."""
    for i, (a, b) in enumerate(zip(got, want)):
        if margins[i] <= tol:
            return i
        if a != b:
            return -1
    return len(got)


def slo(deployment: str) -> dict:
    """``slo_summary`` of one deployment's serve metrics, read from this
    process's registry."""
    from ray_tpu_torch.serve.metrics import slo_summary
    from ray_tpu_torch.util.metrics import _Registry

    return slo_summary({"local": _Registry.get().snapshot()}).get(
        deployment, {})


def slo_line(summary: dict) -> dict:
    """TTFT p50/p99, inter-token p50, queue-wait p50 (seconds, bucket-
    interpolated by ``histogram_quantile``) and the outcomes."""
    def q(field, key):
        return summary.get(field, {}).get(key)

    return {"ttft_p50_s": q("ttft_s", "p50"), "ttft_p99_s": q("ttft_s", "p99"),
            "ttft_count": q("ttft_s", "count"),
            "inter_token_p50_s": q("inter_token_s", "p50"),
            "queue_wait_p50_s": q("queue_wait_s", "p50"),
            "outcomes": summary.get("outcomes", {})}


def _serve_plan(cfg) -> dict:
    """The serve phase's six requests: name -> (prompt, max_new_tokens,
    streamed). ``r5_prefix_hit`` shares the first 1061 tokens of
    ``r1_shared_src``."""
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    shared = prompt(1100)
    return {
        "r1_shared_src": (shared, 32, True),
        "r2_short": (prompt(20), 16, False),
        "r3": (prompt(300), 24, False),
        "r4": (prompt(700), 32, True),
        "r5_prefix_hit": (shared[:1061] + prompt(200), 24, False),
        "r6_long": (prompt(1500), 16, False),
    }


def phase_serve(cfg, device="cuda") -> dict:
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    t0 = time.perf_counter()
    dep = LlamaDecodeDeployment(config=cfg, slots=4, capacity=2048, seed=0,
                                metrics_deployment="serve", device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = dep.engine
    plan = _serve_plan(cfg)
    shared = plan["r1_shared_src"][0]
    results, errors, token_times = {}, {}, {}
    first_token = threading.Event()

    def run(name):
        toks, n, streamed = plan[name]
        try:
            t_sub = time.perf_counter()
            if streamed:
                got, times = [], []
                for tok in dep({"tokens": toks, "max_new_tokens": n,
                                "stream": True}):
                    times.append(time.perf_counter())
                    got.append(tok)
                    if name == "r1_shared_src":
                        first_token.set()
                token_times[name] = times
                results[name] = {"tokens": got,
                                 "ttft_s": times[0] - t_sub}
            else:
                results[name] = dep({"tokens": toks, "max_new_tokens": n})
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"
            first_token.set()

    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,))
               for n in ("r1_shared_src", "r2_short", "r3", "r4")]
    for t in threads:
        t.start()
    # Prefix entries are inserted at admission: submit the sharer only
    # after the source request has produced its first token.
    first_token.wait(REQUEST_TIMEOUT_S)
    later = [threading.Thread(target=run, args=(n,))
             for n in ("r5_prefix_hit", "r6_long")]
    for t in later:
        t.start()
    for t in threads + later:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    stats = eng.stats()
    hung = [t.name for t in threads + later if t.is_alive()]
    out = {"init_s": init_s, "wall_s": t_end - t_start,
           "launches": counts, "flash_fwd_by_kernel": by_kernel,
           "engine": stats, "errors": errors, "hung_threads": hung}
    checks = {}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]["tokens"]) == plan[n][1] for n in plan)
    checks["tokens_in_vocab"] = checks["all_answered"] and all(
        0 <= t < cfg.vocab_size for n in plan for t in results[n]["tokens"])
    checks["prefix_hit"] = stats.get("prefix", {}).get("hits", 0) >= 1
    checks["flash_launches_32_per_miss_wave"] = (
        stats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * stats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel, counts["flash_fwd"],
                                                device)
    if checks["all_answered"]:
        out["ttft_s"] = {n: results[n]["ttft_s"] for n in plan}
        out["stream_decode_tok_s"] = {
            n: (len(ts) - 1) / (ts[-1] - ts[0])
            for n, ts in token_times.items() if len(ts) > 1}
        out["engine_tok_s"] = stats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, k, _) in plan.items():
            want, margins = _solo_greedy(eng, toks, k)
            agree[n] = _agrees(results[n]["tokens"], want, margins,
                               MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        drift = _path_drift(
            eng, [plan[n][0] for n in ("r3", "r4", "r6_long",
                                       "r1_shared_src")],
            shared, plan["r5_prefix_hit"][0],
            stats["prefix"]["prefill_tokens_saved"])
        out["logit_drift"] = drift
        checks["greedy_agrees_with_solo"] = (
            all(v >= 0 for v in agree.values())
            and max(drift.values()) < MARGIN_TOL)
    out["slo"] = slo_line(slo("serve"))
    checks["slo_completed"] = (
        out["slo"]["outcomes"].get("completed") == len(plan))
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 8
    dep.shutdown()
    return out


# The serve_paged phase's pool and requests (see the module docstring).
PAGED_SERVE = dict(slots=8, capacity=2048, page_tokens=64, pool_pages=64,
                   chunk=512)


def _paged_drift(engine, plan, src, sharer, prefix_len) -> dict:
    """Max |logit| differences between the paged and the contiguous paths
    on the deployment's weights, each through a fresh pool with shuffled
    page ids: a full paged prefill and one paged decode step after it
    against the contiguous ones; the longest prompt prefilled in
    engine-sized chunks (paged suffix prefills) against its full
    contiguous prefill; and a prefix hit's paged suffix prefill over the
    source's pages against the sharer's full contiguous prefill. The
    margin rule's tolerance must cover all of them."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, dev, params = engine.config, engine.device, engine.params
    T, chunk = engine.page_tokens, engine.prefill_chunk_tokens
    pages = engine.slot_pages_max
    ids = torch.as_tensor(np.random.default_rng(1).permutation(
        np.arange(1, pages + 1)), dtype=torch.int32, device=dev)[None]

    def padded(p, b):
        t = torch.zeros(1, b, dtype=torch.long, device=dev)
        t[0, :len(p)] = torch.as_tensor(p, device=dev)
        return t

    def contiguous(p):
        cache = ld.init_cache(cfg, 1, engine.capacity, device=dev)
        logits, cache = ld.prefill(
            params, padded(p, ld.cache_bucket(len(p), engine.prefill_bucket)),
            cache, cfg, lengths=torch.tensor([len(p)], device=dev))
        return logits, cache

    out = {}
    p = plan["p3"][0]
    bucket = ld.cache_bucket(len(p), engine.prefill_bucket)
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    lengths = torch.tensor([len(p)], dtype=torch.int32, device=dev)
    paged, pool = ld.paged_prefill(params, padded(p, bucket), pool,
                                   ids[:, :-(-bucket // T)], cfg,
                                   lengths=lengths)
    full, cache = contiguous(p)
    out["prefill"] = float((paged - full).abs().max())
    tok = torch.argmax(full, dim=-1).to(torch.int32)
    paged, pool, _ = ld.paged_decode_step(
        params, pool, ids[:, :-(-(len(p) + 1) // T)], lengths, tok, cfg)
    full, cache = ld.decode_step(params, cache, tok, cfg)
    out["decode"] = float((paged - full).abs().max())
    del cache
    p = plan["p2_chunked"][0]
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    for start in range(0, len(p), chunk):
        end = min(len(p), start + chunk)
        b = min(ld.cache_bucket(end - start, engine._suffix_bucket_min),
                chunk)
        paged, pool = ld.paged_prefill_suffix(
            params, padded(p[start:end], b), pool,
            ids[:, :min(pages, -(-(start + b) // T))], cfg,
            torch.tensor([start], device=dev),
            torch.tensor([end], device=dev))
    full, _ = contiguous(p)
    out["chunked_vs_full"] = float((paged - full).abs().max())
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    bucket = ld.cache_bucket(len(src), engine.prefill_bucket)
    ld.paged_prefill(params, padded(src, bucket), pool,
                     ids[:, :-(-bucket // T)], cfg,
                     lengths=torch.tensor([len(src)], device=dev))
    suffix = sharer[prefix_len:]
    b = ld.cache_bucket(len(suffix), engine._suffix_bucket_min)
    paged, pool = ld.paged_prefill_suffix(
        params, padded(suffix, b), pool,
        ids[:, :min(pages, -(-(prefix_len + b) // T))], cfg,
        torch.tensor([prefix_len], device=dev),
        torch.tensor([len(sharer)], device=dev))
    full, _ = contiguous(sharer)
    out["suffix_vs_full"] = float((paged - full).abs().max())
    del pool
    return out


def _paged_plan(cfg) -> dict:
    """serve_paged's eight requests, name -> (prompt, max_new_tokens,
    temperature): a 1100-token prefix source, a 1500-token prompt (3
    chunks), prompts of 900, 800, 700 (sampled at 0.8), 300 and 20 tokens,
    and a sharer of the source's first 1061 tokens plus 200."""
    rng = np.random.default_rng(1)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    shared = prompt(1100)
    return {
        "p1_shared_src": (shared, 32, 0.0),
        "p2_chunked": (prompt(1500), 16, 0.0),
        "p3": (prompt(900), 24, 0.0),
        "p4": (prompt(800), 24, 0.0),
        "p5_sampled": (prompt(700), 24, 0.8),
        "p6": (prompt(300), 32, 0.0),
        "p7_short": (prompt(20), 32, 0.0),
        "p8_prefix_hit": (shared[:1061] + prompt(200), 24, 0.0),
    }


def _gate_steps(eng, need, after=None) -> list:
    """Hold each step of the decode loop until ``need(submitted)`` requests
    have been submitted (``submitted``: the engine's requests in order),
    so a phase's requests reach the engine at the same steps in every run;
    the checks that need a pool to run dry depend on it. ``after()`` runs
    on the loop's thread after every step. Returns ``submitted``."""
    submitted = []
    submit, step = eng.submit, eng._step_logged

    def counted_submit(*args, **kwargs):
        req = submit(*args, **kwargs)
        submitted.append(req)
        return req

    def gated():
        deadline = time.monotonic() + REQUEST_TIMEOUT_S
        while (len(submitted) < need(submitted)
               and time.monotonic() < deadline):
            time.sleep(0.001)
        stepped = step()
        if after is not None:
            after()
        return stepped

    eng.submit, eng._step_logged = counted_submit, gated
    return submitted


def _start_in_order(threads, submitted, timeout_s=REQUEST_TIMEOUT_S):
    """Start ``threads`` one at a time, each once the one before it has
    submitted its request: the engine's queue holds them in this order."""
    for t in threads:
        n = len(submitted)
        t.start()
        deadline = time.monotonic() + timeout_s
        while len(submitted) == n and time.monotonic() < deadline:
            time.sleep(0.001)


def phase_serve_paged(cfg, device="cuda") -> dict:
    """Llama-2-7B behind a paged ``LlamaDecodeDeployment``: 8 slots of
    2048 tokens on a pool of 64 pages of 64 tokens (4096 tokens for
    requests that want far more), 512-token prefill chunks, the device
    sampler. Eight requests, all sent before the first can finish: a
    1100-token prefix source; a sharer of its first 1061 tokens plus 200,
    sent after the source's first token; a 1500-token prompt (3 chunks);
    prompts of 900, 800, 700, 300 and 20 tokens, the 700 one sampled at
    temperature 0.8. The loop's steps follow one schedule in every run
    (``_gate_steps``), so the pool runs dry the same way each time."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    geo = PAGED_SERVE
    t0 = time.perf_counter()
    dep = LlamaDecodeDeployment(
        config=cfg, slots=geo["slots"], capacity=geo["capacity"], seed=0,
        kv_page_tokens=geo["page_tokens"], kv_pool_pages=geo["pool_pages"],
        prefill_chunk_tokens=geo["chunk"], device_sampler=True,
        metrics_deployment="serve_paged", device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = dep.engine
    plan = _paged_plan(cfg)
    shared = plan["p1_shared_src"][0]
    results, errors, token_times, submitted = {}, {}, {}, {}
    first_token = threading.Event()

    def run(name):
        toks, n, temp = plan[name]
        try:
            got, times = [], []
            submitted[name] = time.perf_counter()
            for tok in dep({"tokens": toks, "max_new_tokens": n,
                            "temperature": temp, "stream": True}):
                times.append(time.perf_counter())
                got.append(tok)
                if name == "p1_shared_src":
                    first_token.set()
            token_times[name] = times
            results[name] = got
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"
            first_token.set()

    # Page stats at every step boundary, read on the decode loop's own
    # thread: a read from another thread could land inside an admission,
    # whose pages are taken before its prefill has filled them.
    samples = []

    def sample():
        s = eng.stats()
        if s["active"] or s["prefilling"]:
            samples.append((s["kv_fragmentation"], s["pages_free"]))

    # The schedule every run sees: the source alone in the first step,
    # the six others (in plan order) before the second, the sharer before
    # the step after the source's first token.
    stepped = threading.Event()

    def need(sub):
        if not stepped.is_set():
            return 1
        if sub[0].first_token_at is not None:
            return len(plan)
        return len(plan) - 1

    def after():
        stepped.set()
        sample()

    queued = _gate_steps(eng, need, after=after)
    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,))
               for n in plan if n != "p8_prefix_hit"]
    _start_in_order(threads[:1], queued)
    stepped.wait(REQUEST_TIMEOUT_S)
    _start_in_order(threads[1:], queued)
    # The prefix index takes the source's pages at its admission: send the
    # sharer after the source's first token.
    first_token.wait(REQUEST_TIMEOUT_S)
    later = threading.Thread(target=run, args=("p8_prefix_hit",))
    later.start()
    for t in threads + [later]:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    stats = eng.stats()
    hung = [t.name for t in threads + [later] if t.is_alive()]
    out = {"init_s": init_s, "wall_s": t_end - t_start,
           "geometry": geo, "launches": counts,
           "flash_fwd_by_kernel": by_kernel, "engine": stats,
           "errors": errors, "hung_threads": hung}
    checks = {}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]) == plan[n][1] for n in plan)
    checks["tokens_in_vocab"] = checks["all_answered"] and all(
        0 <= t < cfg.vocab_size for n in plan for t in results[n])
    checks["preempted"] = stats["preempted"] >= 1
    checks["prefill_chunks_3"] = stats["prefill_chunks"] >= 3
    checks["prefix_hit"] = stats.get("prefix", {}).get("hits", 0) >= 1
    checks["pages_returned"] = (
        stats["active"] == stats["prefilling"] == stats["queued"] == 0
        and stats["pages_free"] + stats["pages_pinned"]
        == geo["pool_pages"])
    checks["flash_launches_per_full_wave"] = (
        stats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * stats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel,
                                                counts["flash_fwd"], device)
    if samples:
        frag = [f for f, _ in samples]
        out["kv_fragmentation"] = {"mean": sum(frag) / len(frag),
                                   "max": max(frag), "steps": len(frag)}
        out["pages_free_min"] = min(p for _, p in samples)
    if checks["all_answered"]:
        out["ttft_s"] = {n: token_times[n][0] - submitted[n] for n in plan}
        out["stream_decode_tok_s"] = {
            n: (len(ts) - 1) / (ts[-1] - ts[0])
            for n, ts in token_times.items() if len(ts) > 1}
        out["engine_tok_s"] = stats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, k, temp) in plan.items():
            if temp > 0:
                continue
            want, margins = _solo_greedy(eng, toks, k)
            agree[n] = _agrees(results[n], want, margins, MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        # The source's prefix entry: the largest power of two <= 1100
        # tokens, whole 64-token pages.
        drift = _paged_drift(eng, plan, shared, plan["p8_prefix_hit"][0],
                             1024)
        out["logit_drift"] = drift
        checks["greedy_agrees_with_solo"] = (
            all(v >= 0 for v in agree.values())
            and max(drift.values()) < MARGIN_TOL)
    out["slo"] = slo_line(slo("serve_paged"))
    checks["slo_completed"] = (
        out["slo"]["outcomes"].get("completed") == len(plan))
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 11
    dep.shutdown()
    return out


# The serve_spec phase's pools, draft and requests (see the module
# docstring). The draft pool holds 3072 tokens for prompts of 4920.
SPEC_SERVE = dict(slots=8, capacity=2048, page_tokens=64, pool_pages=128,
                  draft="1b", k=4, draft_pool_pages=48)


def _verify_drift(engine, prompt, k) -> float:
    """Max |logit| difference between one slot's ``paged_verify`` logits
    at its k + 1 positions and k + 1 sequential ``paged_decode_step``s of
    the same tokens, on the deployment's weights, through one pool with
    shuffled page ids (the decode steps rewrite each position before they
    read it)."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, dev, params = engine.config, engine.device, engine.params
    T, pages = engine.page_tokens, engine.slot_pages_max
    bt = torch.as_tensor(np.random.default_rng(2).permutation(
        np.arange(1, pages + 1)), dtype=torch.int32, device=dev)[None]
    s = len(prompt)
    bucket = ld.cache_bucket(s, engine.prefill_bucket)
    toks = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    toks[0, :s] = torch.as_tensor(prompt, device=dev)
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    lengths = torch.tensor([s], dtype=torch.int32, device=dev)
    logits, pool = ld.paged_prefill(params, toks, pool,
                                    bt[:, :-(-bucket // T)], cfg,
                                    lengths=lengths)
    row = [int(torch.argmax(logits[0]))]
    row += np.random.default_rng(3).integers(1, cfg.vocab_size, k).tolist()
    row = torch.tensor([row], dtype=torch.int32, device=dev)
    width = bt[:, :-(-(s + k + 1) // T)]
    verify, pool = ld.paged_verify(params, row, pool, width, cfg, lengths)
    drift = 0.0
    for j in range(k + 1):
        step, pool, lengths = ld.paged_decode_step(params, pool, width,
                                                   lengths, row[:, j], cfg)
        drift = max(drift, float((step[0] - verify[0, j]).abs().max()))
    del pool
    return drift


def _drive_engine(engine, plan) -> dict:
    """Submit every request of ``plan`` to an engine and step it by hand
    until all end: name -> request."""
    reqs = {n: engine.submit(toks, max_new_tokens=m)
            for n, (toks, m, _) in plan.items()}
    for _ in range(100_000):
        if all(r.done.is_set() for r in reqs.values()):
            break
        engine.step()
    return reqs


def _perfect_draft(cfg, params, plan, solo, device) -> dict:
    """A DecodeEngine whose draft is the target itself (k = 4, 4 slots)
    against a plain paged engine on the same requests and weights."""
    from ray_tpu_torch.serve.decode import DecodeEngine

    geo = SPEC_SERVE
    kw = dict(slots=4, capacity=geo["capacity"],
              page_tokens=geo["page_tokens"], pool_pages=64, device=device)
    out, streams = {}, {}
    for mode, extra in (("plain", {}),
                        ("spec", dict(spec_draft_params=params,
                                      spec_draft_config=cfg,
                                      spec_k=geo["k"]))):
        engine = DecodeEngine(params, cfg, **kw, **extra)
        _sync(device)
        t0 = time.perf_counter()
        reqs = _drive_engine(engine, plan)
        _sync(device)
        wall = time.perf_counter() - t0
        s = engine.stats()
        out[mode] = {"wall_s": wall, "steps": engine.steps,
                     "tokens_out": s["tokens_out"],
                     "engine_tok_s": s["tokens_out"] / wall,
                     "completed": all(r.status == "completed"
                                      for r in reqs.values())}
        if mode == "spec":
            out[mode]["spec"] = s["spec"]
        streams[mode] = {n: r.output for n, r in reqs.items()}
        del engine
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out["greedy_positions_compared"] = {
        mode: {n: _agrees(streams[mode][n], *solo[n], MARGIN_TOL)
               for n in plan} for mode in streams}
    return out


def phase_serve_spec(cfg, device="cuda", draft=None) -> dict:
    """Llama-2-7B behind a speculative ``LlamaDecodeDeployment`` with the
    1B preset as its draft (seed 1, random weights like the target's),
    k = 4, 8 slots of 2048 tokens on 128 pages of 64, a draft pool of 48
    pages, the device sampler and warmup. Seven requests sent before the
    first can finish: greedy prompts of 20, 300, 700, 900, 1100 and 1500
    tokens with 32 new tokens each and a 400-token prompt at temperature
    0.8 with 16. Then the verify's drift against decode steps, and a
    draft equal to the target against a plain paged engine."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    geo = SPEC_SERVE
    k = geo["k"]
    t0 = time.perf_counter()
    dep = LlamaDecodeDeployment(
        config=cfg, slots=geo["slots"], capacity=geo["capacity"], seed=0,
        kv_page_tokens=geo["page_tokens"], kv_pool_pages=geo["pool_pages"],
        spec_draft_model=draft or geo["draft"], spec_k=k,
        spec_draft_pool_pages=geo["draft_pool_pages"], device_sampler=True,
        warmup=True, metrics_deployment="serve_spec", device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = dep.engine
    checks = {}
    checks["warmup_keys"] = {
        ("decode",), ("decode_sampled",), ("spec_draft", k),
        ("spec_verify", k), ("paged_prefill", 1, 128)} <= eng._compiled
    checks["warmup_idle_pools"] = (
        not eng.cache["length"].any() and not eng._draft_cache["length"].any()
        and eng.stats()["pages_free"] == geo["pool_pages"]
        and eng.stats()["spec"]["draft_pages_free"]
        == geo["draft_pool_pages"])
    rng = np.random.default_rng(2)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    plan = {  # name -> (prompt, max_new_tokens, temperature)
        "s1_short": (prompt(20), 32, 0.0),
        "s2": (prompt(300), 32, 0.0),
        "s3": (prompt(700), 32, 0.0),
        "s4": (prompt(900), 32, 0.0),
        "s5": (prompt(1100), 32, 0.0),
        "s6_long": (prompt(1500), 32, 0.0),
        "s7_sampled": (prompt(400), 16, 0.8),
    }
    results, errors, token_times, submitted = {}, {}, {}, {}

    def run(name):
        toks, n, temp = plan[name]
        try:
            got, times = [], []
            submitted[name] = time.perf_counter()
            for tok in dep({"tokens": toks, "max_new_tokens": n,
                            "temperature": temp, "stream": True}):
                times.append(time.perf_counter())
                got.append(tok)
            token_times[name] = times
            results[name] = got
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"

    resyncs = []
    resync = eng._draft_resync

    def counted_resync(slot, req):
        resyncs.append(slot)
        return resync(slot, req)

    eng._draft_resync = counted_resync
    # All seven reach the queue, in plan order, before the first step.
    queued = _gate_steps(eng, lambda sub: len(plan))
    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,)) for n in plan]
    _start_in_order(threads, queued)
    for t in threads:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    # Stop the loop before reading its state: a request's stream ends
    # before the loop records the step that finished it.
    dep.shutdown()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    stats = eng.stats()
    spec = stats["spec"]
    timeline = eng.timeline()
    hung = [t.name for t in threads if t.is_alive()]
    phases = [p for row in timeline["rows"] for p in row["phases"]]
    host_ms = {name: sorted(1e3 * (p["t1"] - p["t0"]) for p in phases
                            if p["phase"] == name)
               for name in ("draft", "verify", "decode", "draft-prefill")}
    out = {"init_s": init_s, "wall_s": t_end - t_start, "geometry": geo,
           "launches": counts, "flash_fwd_by_kernel": by_kernel,
           "engine": stats, "resyncs": len(resyncs), "errors": errors,
           "hung_threads": hung,
           "timeline_rows": len(timeline["rows"]),
           "timeline_dropped": timeline["dropped"],
           "phase_host_ms_median": {n: v[len(v) // 2] if v else None
                                    for n, v in host_ms.items()},
           "phase_count": {n: len(v) for n, v in host_ms.items()}}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]) == plan[n][1] for n in plan)
    checks["tokens_in_vocab"] = checks["all_answered"] and all(
        0 <= t < cfg.vocab_size for n in plan for t in results[n])
    checks["spec_rounds"] = spec["rounds"] > 0
    checks["draft_demoted_or_evicted"] = spec["draft_demotions"] >= 1
    checks["resynced"] = len(resyncs) >= 1
    checks["pages_returned"] = (
        stats["active"] == stats["prefilling"] == stats["queued"] == 0
        and stats["pages_free"] + stats["pages_pinned"]
        == geo["pool_pages"]
        and spec["draft_pages_free"] == geo["draft_pool_pages"])
    checks["flash_launches_per_full_wave"] = (
        stats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * stats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel,
                                                counts["flash_fwd"], device)
    verify = [p for p in phases if p["phase"] == "verify"]
    checks["timeline_draft_verify"] = (
        bool(host_ms["draft"]) and bool(verify)
        and all("accepted" in p for p in verify))
    solo = {}
    if checks["all_answered"]:
        out["ttft_s"] = {n: token_times[n][0] - submitted[n] for n in plan}
        out["engine_tok_s"] = stats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, m, temp) in plan.items():
            if temp > 0:
                continue
            solo[n] = _solo_greedy(eng, toks, m)
            agree[n] = _agrees(results[n], *solo[n], MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        checks["greedy_agrees_with_solo"] = all(
            v >= 0 for v in agree.values())
    out["slo"] = slo_line(slo("serve_spec"))
    checks["slo_completed"] = (
        out["slo"]["outcomes"].get("completed") == len(plan))
    drift = _verify_drift(eng, plan["s5"][0], k)
    out["verify_drift"] = drift
    checks["verify_drift_under_tol"] = drift < MARGIN_TOL
    # (c) A draft equal to the target, on four of the greedy requests.
    params = eng.params
    del dep, eng, resync
    sub = {n: plan[n] for n in ("s1_short", "s2", "s3", "s5")}
    if all(n in solo for n in sub):
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        perfect = _perfect_draft(cfg, params, sub, solo, device)
        out["perfect_draft"] = perfect
        pspec = perfect["spec"]["spec"]
        checks["perfect_accept_rate"] = (pspec["accept_rate"] or 0) >= 0.5
        checks["perfect_rounds_half_of_plain_steps"] = (
            2 * pspec["rounds"] <= perfect["plain"]["steps"])
        checks["perfect_streams_agree"] = (
            perfect["plain"]["completed"] and perfect["spec"]["completed"]
            and all(v >= 0 for m in perfect["greedy_positions_compared"]
                    .values() for v in m.values()))
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 18
    return out


# The serve_disagg phase's two deployments (see the module docstring): the
# prefill side's pool is serve_paged's, the decode side's serve_spec's.
DISAGG_SERVE = dict(slots=8, capacity=2048, page_tokens=64,
                    prefill_pool_pages=64, decode_pool_pages=128, chunk=512,
                    ttl_s=1.0)
# PCIe Gen5 x16, nominal rate a direction: what a host-staged handoff
# between two cards would cross (this phase's two deployments share one).
PCIE5_X16_NOMINAL_GBS = 64.0


def phase_serve_disagg(cfg, device="cuda") -> dict:
    """Disaggregated prefill/decode at Llama-2-7B: a prefill deployment
    (64 pages of 64 tokens, 512-token chunks) and a decode deployment (8
    slots of 2048 tokens on 128 pages), both from seed 0 with the device
    sampler. Seven requests from threads, each through ``prefill_handoff``
    then ``decode_adopted`` (one sampled stream through
    ``stream_adopted``), the lease discharged after the adopt as the
    JAX router does: greedy prompts of 20, 300, 700, 1100 and 1500 tokens
    with 32 new tokens, a sharer of the 1100 prompt's first 1061 tokens
    plus 200 sent after that prompt's descriptor returns (a prefix hit on
    the prefill side), and 400 tokens at temperature 0.8 with 16. Then a
    descriptor whose adopt is refused (page_tokens altered) and aborted,
    and one lease left to expire through the TTL sweep. The payloads go
    through the runtime's object store (``rt.init`` for the phase), with
    each put and get timed."""
    import ray_tpu_torch as rt

    _runtime_init(device)
    try:
        return _serve_disagg(cfg, device)
    finally:
        rt.shutdown()


def _serve_disagg(cfg, device) -> dict:
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.config import config as rt_config
    from ray_tpu_torch.core.errors import HandoffAdoptError
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    geo = DISAGG_SERVE
    common = dict(config=cfg, slots=geo["slots"], capacity=geo["capacity"],
                  seed=0, kv_page_tokens=geo["page_tokens"],
                  device_sampler=True, device=device)
    objects0 = _live_objects()
    store_put, store_get = [], []
    put_fn, get_fn = api.put, api.get

    def timed_put(value):
        t = time.perf_counter()
        ref = put_fn(value)
        store_put.append((value.nbytes, time.perf_counter() - t))
        return ref

    def timed_get(refs, timeout=None):
        t = time.perf_counter()
        got = get_fn(refs, timeout)
        store_get.append((sum(v.nbytes for v in got),
                          time.perf_counter() - t))
        return got

    t0 = time.perf_counter()
    # The prefill side's ledger takes a 1 s TTL (read at construction) so
    # the phase can let one lease expire; the sweep runs only when
    # replica_metrics is read, after every other lease is discharged.
    ttl = rt_config.serve_handoff_ttl_s
    rt_config.serve_handoff_ttl_s = geo["ttl_s"]
    try:
        pre = LlamaDecodeDeployment(
            **common, kv_pool_pages=geo["prefill_pool_pages"],
            prefill_chunk_tokens=geo["chunk"], metrics_deployment="prefill")
    finally:
        rt_config.serve_handoff_ttl_s = ttl
    dec = LlamaDecodeDeployment(**common,
                                kv_pool_pages=geo["decode_pool_pages"],
                                metrics_deployment="decode")
    _sync(device)
    init_s = time.perf_counter() - t0
    peng, deng = pre.engine, dec.engine
    rng = np.random.default_rng(3)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    shared = prompt(1100)
    plan = {  # name -> (prompt, max_new_tokens, temperature)
        "d1_short": (prompt(20), 32, 0.0),
        "d2": (prompt(300), 32, 0.0),
        "d3": (prompt(700), 32, 0.0),
        "d4_shared_src": (shared, 32, 0.0),
        "d5_long": (prompt(1500), 32, 0.0),
        "d6_sampled_stream": (prompt(400), 16, 0.8),
        "d7_prefix_hit": (shared[:1061] + prompt(200), 32, 0.0),
    }
    check_pages_of = "d3"
    capture, adopt, pages_equal = {}, {}, {}
    capture_fn, seat_fn = peng._capture_handoff, deng._seat_adopted

    def timed_capture(req, slot, first_token):
        # On the prefill loop's thread: the copy to the host, by the card.
        _sync(device)
        t = time.perf_counter()
        capture_fn(req, slot, first_token)
        _sync(device)
        capture[req.request_id] = (req.handoff["nbytes"],
                                   time.perf_counter() - t)

    def timed_seat(req):
        # On the decode loop's thread: the copy to the card and the
        # scatter into the pool; then one slot's pages against its payload.
        payload = req.adopt
        _sync(device)
        t = time.perf_counter()
        seated = seat_fn(req)
        _sync(device)
        if seated:
            adopt[req.request_id] = (payload["k"].nbytes
                                     + payload["v"].nbytes,
                                     time.perf_counter() - t)
            if req.request_id == f"dc-{check_pages_of}":
                ids = torch.as_tensor(deng._slot_pages[req.slot],
                                      device=deng.device)
                pages_equal[req.request_id] = all(
                    torch.equal(deng.cache[n][:, ids],
                                payload[n].to(deng.device))
                    for n in ("k", "v"))
        return seated

    peng._capture_handoff = timed_capture
    deng._seat_adopted = timed_seat
    api.put, api.get = timed_put, timed_get
    results, descs, errors, times = {}, {}, {}, {}
    src_published, sharer_published = threading.Event(), threading.Event()

    def run(name):
        toks, n, temp = plan[name]
        req = {"tokens": toks, "max_new_tokens": n, "temperature": temp}
        desc = None
        if name == "d5_long":
            # Its 24 pages would evict the source's prefix entries from
            # the full pool before the sharer's lookup, as soon as the
            # leases of the others free pages: it goes once the sharer's
            # descriptor is back.
            sharer_published.wait(REQUEST_TIMEOUT_S)
        try:
            t = time.perf_counter()
            desc = pre.prefill_handoff({**req, "request_id": f"pf-{name}"})
            descs[name] = desc
            t_desc = time.perf_counter() - t
            if name == "d4_shared_src":
                src_published.set()
            if name == "d7_prefix_hit":
                sharer_published.set()
            dreq = {**req, "request_id": f"dc-{name}"}
            if temp > 0:
                got, t_first = [], None
                for tok in dec.stream_adopted(dreq, desc):
                    if t_first is None:
                        t_first = time.perf_counter() - t
                        pre.discharge_handoff(desc["handoff_id"])
                    got.append(tok)
            else:
                got = dec.decode_adopted(dreq, desc)["tokens"]
                t_first = None
                pre.discharge_handoff(desc["handoff_id"])
            times[name] = {"descriptor_s": t_desc,
                           "first_stream_token_s": t_first,
                           "done_s": time.perf_counter() - t}
            results[name] = got
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"
            if desc is not None:
                pre.abort_handoff(desc["handoff_id"])
            src_published.set()
            sharer_published.set()

    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,))
               for n in plan if n != "d7_prefix_hit"]
    for t in threads:
        t.start()
    # The prefill side's prefix index takes the source's pages when it
    # prefills: send the sharer once the source's descriptor is back.
    src_published.wait(REQUEST_TIMEOUT_S)
    later = threading.Thread(target=run, args=("d7_prefix_hit",))
    later.start()
    for t in threads + [later]:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    hung = [t.name for t in threads + [later] if t.is_alive()]
    # (a) An adopt the decode side must refuse, then the abort.
    refused = None
    req = {"tokens": prompt(100), "max_new_tokens": 4}
    desc = pre.prefill_handoff(req)
    try:
        dec.decode_adopted(req, {**desc,
                                 "page_tokens": geo["page_tokens"] // 2})
    except HandoffAdoptError as e:
        refused = str(e)
    pre.abort_handoff(desc["handoff_id"])
    # (b) A lease nobody discharges: expired by the sweep replica_metrics
    # runs once the TTL has passed.
    pre.prefill_handoff({"tokens": prompt(60), "max_new_tokens": 4})
    time.sleep(geo["ttl_s"] + 0.2)
    rm = pre.replica_metrics()
    # Stop both loops before reading their state.
    pre.shutdown()
    dec.shutdown()
    api.put, api.get = put_fn, get_fn
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    pstats, dstats = peng.stats(), deng.stats()
    summary = {"prefill": slo("prefill"), "decode": slo("decode")}
    books = summary["prefill"].get("handoffs", {})
    handoff = {}
    for name in plan:
        key = (f"pf-{name}", f"dc-{name}")
        if key[0] in capture and key[1] in adopt:
            (nb, tc), (_, ta) = capture[key[0]], adopt[key[1]]
            handoff[name] = {"payload_bytes": nb,
                             "capture_ms": 1e3 * tc,
                             "capture_gb_s": nb / tc / 1e9,
                             "adopt_ms": 1e3 * ta,
                             "adopt_gb_s": nb / ta / 1e9}
    out = {"init_s": init_s, "wall_s": t_end - t_start, "geometry": geo,
           "launches": counts, "flash_fwd_by_kernel": by_kernel,
           "prefill_engine": pstats, "decode_engine": dstats,
           "replica_metrics_prefill": rm, "errors": errors,
           "hung_threads": hung, "handoff": handoff,
           "pcie5_x16_nominal_gb_s_per_direction": PCIE5_X16_NOMINAL_GBS,
           "host_clock_s": times, "refused_adopt": refused,
           "handoff_latency_s": summary["prefill"].get("handoff_latency_s"),
           "handoff_descriptor_bytes": summary["prefill"].get(
               "handoff_bytes"),
           "handoff_events": books,
           "object_store": {
               "puts": len(store_put), "gets": len(store_get),
               "put_gb_s_median": _median_rate(store_put),
               "get_gb_s_median": _median_rate(store_get),
               "put_bytes_max": max((b for b, _ in store_put), default=0),
               "config": _store_config(device)},
           "slo": {dep: slo_line(v) for dep, v in summary.items()}}
    checks = {}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]) == plan[n][1] for n in plan)
    checks["first_token_from_prefill"] = checks["all_answered"] and all(
        results[n][0] == descs[n]["first_token"] for n in plan)
    checks["adopted_pages_equal_payload"] = (
        pages_equal.get(f"dc-{check_pages_of}") is True)
    checks["decode_ran_no_prefill"] = (
        dstats["prefill_waves"] == dstats["suffix_waves"]
        == dstats["prefill_chunks"] == 0)
    checks["prefill_prefix_hit"] = (
        pstats.get("prefix", {}).get("hits", 0) >= 1)
    checks["flash_launches_per_full_wave"] = (
        pstats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * pstats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel,
                                                counts["flash_fwd"], device)
    checks["adopt_refused"] = refused is not None and "page_tokens" in refused
    checks["handoff_books_close"] = (
        books.get("published", 0) == len(plan) + 2
        and books.get("published") == books.get("adopted", 0)
        + books.get("aborted", 0) + books.get("expired", 0)
        and books.get("aborted") == 1 and books.get("expired") == 1)
    checks["ledger_drained"] = (
        rm["handoffs_live"] == 0 and rm["handoff_live_bytes"] == 0
        and pre._handoffs.live() == 0 and pre._handoffs.live_bytes() == 0)
    checks["refs_freed"] = _live_objects() == objects0
    checks["pages_returned"] = all(
        s["active"] == s["prefilling"] == s["queued"] == 0
        and s["pages_free"] + s["pages_pinned"] == s["pages_total"]
        for s in (pstats, dstats))
    dsum = summary["decode"]
    checks["slo_decode"] = (
        dsum.get("ttft_s", {}).get("count") == len(plan)
        and dsum.get("inter_token_s", {}).get("count") == len(plan)
        and dsum.get("outcomes", {}).get("completed") == len(plan))
    if checks["all_answered"]:
        out["engine_tok_s"] = dstats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, m, temp) in plan.items():
            if temp > 0:
                continue
            agree[n] = _agrees(results[n], *_solo_greedy(deng, toks, m),
                               MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        checks["greedy_agrees_with_solo"] = all(
            v >= 0 for v in agree.values())
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 15
    return out


# Flash vs plain-attention gradients of the 2-layer check: the relative L2
# norm of their difference, per parameter. Both round P (and the flash path
# dS) to bf16, at other points of the sums, through two layers of bf16
# activations.
GRAD_REL_TOL = 5e-2


# ------------------------------------------------------------ serve_mesh


def _drive_steps(engine, plan, device) -> dict:
    """serve_paged's requests through ``engine.step()`` on one schedule:
    seven submitted before the first step, the prefix sharer before the
    first step after the source's first token, then steps until all end.
    Each step is timed on the host clock (a step ends on a device-to-host
    copy of its tokens, so the clock covers its device work); a decode
    step is one that ran no prefill wave or chunk."""
    reqs = {n: engine.submit(plan[n][0], max_new_tokens=plan[n][1],
                             temperature=plan[n][2], request_id=n)
            for n in plan if n != "p8_prefix_hit"}
    steps, decode_steps = [], []
    t_start = time.perf_counter()
    for _ in range(2000):
        if "p8_prefix_hit" not in reqs and reqs["p1_shared_src"].output:
            n = "p8_prefix_hit"
            reqs[n] = engine.submit(plan[n][0], max_new_tokens=plan[n][1],
                                    temperature=plan[n][2], request_id=n)
        if len(reqs) == len(plan) and all(r.done.is_set()
                                          for r in reqs.values()):
            break
        s0 = engine.stats()
        t0 = time.perf_counter()
        engine.step()
        dt = time.perf_counter() - t0
        s1 = engine.stats()
        steps.append(dt)
        if all(s1[k] == s0[k] for k in ("prefill_waves", "suffix_waves",
                                        "prefill_chunks")):
            decode_steps.append(dt)
    _sync(device)
    wall = time.perf_counter() - t_start
    stats = engine.stats()
    return {"streams": {n: list(r.output) for n, r in reqs.items()},
            "status": {n: r.status for n, r in reqs.items()},
            "ttft_s": {n: r.first_token_at - r.submitted_at
                       for n, r in reqs.items()
                       if r.first_token_at is not None},
            "wall_s": wall, "steps": len(steps),
            "step_ms_mean": 1e3 * sum(steps) / max(1, len(steps)),
            "decode_step_ms_median": (
                1e3 * sorted(decode_steps)[len(decode_steps) // 2]
                if decode_steps else None),
            "decode_steps": len(decode_steps),
            "tokens_out": stats["tokens_out"],
            "tok_s": stats["tokens_out"] / wall, "engine": stats}


def _first_difference(got: dict, want: dict) -> dict:
    """Each request's first position where two runs' streams differ."""
    out = {}
    for n in want:
        a, b = got.get(n, []), want[n]
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff or len(a) != len(b):
            out[n] = diff[0] if diff else min(len(a), len(b))
    return out


# The serve_mesh phase's runs, in turns so that neither engine always
# runs first on a warmer card.
MESH_RUN_ORDER = ("meshless", "mesh", "mesh", "meshless")


def phase_serve_mesh(cfg, device="cuda") -> dict:
    """Llama-2-7B served by one ``DecodeEngine`` replica over a (1, 1)
    decode mesh at world size 1 (NCCL on the card, in process), beside the
    mesh-less engine on the same weights, serve_paged's geometry (8 slots
    of 2048 on 64 pages of 64 tokens, 512-token chunks, the device
    sampler) and serve_paged's eight requests on one step schedule
    (``_drive_steps``), so every run sees the same waves. Four runs in
    turns (``MESH_RUN_ORDER``). Every stream must equal the first
    mesh-less run's token for token (the mesh's functions run on local
    shards, which at (1, 1) are the whole weights: the same launches);
    every run launches the flash forward once a layer per full prefill
    wave, all on wgmma. Prints each run's mean and decode step time, tokens/s
    and ``slo_summary``, and the mesh's lockstep messages; the path's
    launches are the first mesh run's."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import init_distributed
    from ray_tpu_torch.serve.decode import DecodeEngine

    gc.collect()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    geo = PAGED_SERVE
    t0 = time.perf_counter()
    params = llama.init_params(cfg, device=device, seed=0)
    _sync(device)
    init_s = time.perf_counter() - t0
    plan = _paged_plan(cfg)
    init_distributed(0, 1, device_type=device)
    runs = []
    try:
        for i, name in enumerate(MESH_RUN_ORDER):
            tag = f"serve_mesh_{name}_{i}"
            eng = DecodeEngine(
                params, cfg, slots=geo["slots"], capacity=geo["capacity"],
                page_tokens=geo["page_tokens"], pool_pages=geo["pool_pages"],
                prefill_chunk_tokens=geo["chunk"], device_sampler=True,
                metrics_deployment=tag, device=device,
                **({"mesh_shape": (1, 1)} if name == "mesh" else {}))
            reset_counts()
            fwd0 = fwd_kernel_counts(device)
            run = _drive_steps(eng, plan, device)
            run.update(name=name, launches=launch_counts(),
                       flash_fwd_by_kernel=fwd_kernels_since(fwd0, device),
                       slo=slo_line(slo(tag)))
            if name == "mesh":
                run["lockstep_messages"] = eng._ctl.sent
                run["backend"] = dist.get_backend()
            runs.append(run)
            eng.shutdown()
            del eng
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del params
    base = runs[0]
    mesh = [r for r in runs if r["name"] == "mesh"]
    diffs = [_first_difference(r["streams"], base["streams"])
             for r in runs[1:]]

    def median(name, key):
        xs = sorted(r[key] for r in runs if r["name"] == name)
        return (xs[0] + xs[-1]) / 2

    out = {"init_s": init_s, "geometry": geo, "mesh_shape": [1, 1],
           "world_size": 1, "order": list(MESH_RUN_ORDER),
           "runs": [{k: v for k, v in r.items() if k != "streams"}
                    for r in runs],
           "first_difference": diffs,
           "launches": mesh[0]["launches"],
           "flash_fwd_by_kernel": mesh[0]["flash_fwd_by_kernel"]}
    out["mesh_vs_meshless"] = {
        key: median("mesh", key) / median("meshless", key)
        for key in ("decode_step_ms_median", "step_ms_mean", "tok_s")}
    checks = {}
    checks["all_completed"] = all(
        set(r["status"]) == set(plan)
        and all(v == "completed" for v in r["status"].values())
        and all(len(r["streams"][k]) == plan[k][1] for k in plan)
        and r["slo"]["outcomes"].get("completed") == len(plan)
        for r in runs)
    checks["flash_launches_per_full_wave"] = all(
        r["engine"]["prefill_waves"] > 0
        and r["launches"]["flash_fwd"]
        == cfg.n_layers * r["engine"]["prefill_waves"] for r in runs)
    checks["flash_fwd_on_wgmma"] = all(
        all_on_wgmma(r["flash_fwd_by_kernel"], r["launches"]["flash_fwd"],
                     device) for r in runs)
    checks["streams_equal"] = not any(diffs)
    checks["same_waves"] = all(
        r["engine"][k] == base["engine"][k] for r in runs
        for k in ("prefill_waves", "suffix_waves", "prefill_chunks",
                  "preempted", "steps"))
    checks["mesh_stats"] = all(r["engine"]["chips"] == 1
                               and r["engine"]["mesh_shape"] == [1, 1]
                               for r in mesh)
    checks["lockstep_a_message_a_step"] = all(
        r["lockstep_messages"] == r["steps"] for r in mesh)
    checks["backend"] = all(r["backend"] == ("nccl" if cuda else "gloo")
                            for r in mesh)
    if cuda:
        out["device"] = smi_line()
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


def _grad_check(cfg, device, b, s) -> dict:
    """The same width at 2 layers: gradients of ``loss_fn`` with
    ``attention_impl="flash"`` against ``"xla"`` (plain PyTorch)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import tree_leaves
    from ray_tpu_torch.parallel.train_step import value_and_grad

    cfg2 = replace(cfg, n_layers=2)
    params = llama.init_params(cfg2, device=device, dtype=torch.float32,
                               seed=1)
    g = torch.Generator(device=device).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                     generator=g, device=device)}
    def run(impl):
        c = replace(cfg2, attention_impl=impl)
        return value_and_grad(lambda p, b_: llama.loss_fn(p, b_, c), params,
                              batch)

    loss_f, grads_f = run("flash")
    loss_x, grads_x = run("xla")
    rel = [float((a - b_).norm() / b_.norm().clamp_min(1e-30))
           for a, b_ in zip(tree_leaves(grads_f), tree_leaves(grads_x))]
    return {"shape": {"B": b, "S": s, "n_layers": 2},
            "loss_flash": float(loss_f), "loss_xla": float(loss_x),
            "max_grad_rel_norm_diff": max(rel), "tol": GRAD_REL_TOL,
            "ok": max(rel) <= GRAD_REL_TOL and math.isfinite(sum(rel))}


def phase_train(cfg, device="cuda", batch=8, seq=2048, steps=4,
                accum_steps=2, check_batch=1, check_seq=1024,
                grad_check=True) -> dict:
    """``steps`` AdamW steps of ``cfg`` through ``build_train_step`` on one
    fixed batch of ``batch`` x (``seq`` + 1) random tokens, in
    ``accum_steps`` microbatches, with per-step launch counts; then, with
    ``grad_check``, the flash-vs-plain gradient check."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = train_step.init_sharded_params(
        lambda seed: llama.init_params(cfg, device=device,
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(cfg), key=0)
    opt = adamw(3e-4, weight_decay=0.1)
    opt_state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt, accum_steps=accum_steps)
    g = torch.Generator(device=device).manual_seed(0)
    data = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                    generator=g, device=device)}
    _sync(device)
    init_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    want = {**{k: 0 for k in KERNELS},
            "flash_fwd": 2 * cfg.n_layers * accum_steps,
            "flash_bwd_dkv": cfg.n_layers * accum_steps,
            "flash_bwd_dq": cfg.n_layers * accum_steps,
            "attention_delta": cfg.n_layers * accum_steps}
    losses, norms, times, per_step = [], [], [], []
    total = {k: 0 for k in want}
    by_kernel: dict = {}
    bwd_by_kernel: dict = {}
    on_wgmma = bwd_on_wgmma = True
    for _ in range(steps):
        reset_counts()
        fwd0 = fwd_kernel_counts(device)
        bwd0 = bwd_kernel_counts(device)
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, data)
        _sync(device)
        times.append(time.perf_counter() - t)
        counts = launch_counts()
        step_by_kernel = fwd_kernels_since(fwd0, device)
        step_bwd = bwd_kernels_since(bwd0, device)
        on_wgmma = on_wgmma and all_on_wgmma(step_by_kernel,
                                             counts["flash_fwd"], device)
        bwd_on_wgmma = bwd_on_wgmma and all_bwd_on_wgmma(
            step_bwd, counts["flash_bwd_dkv"], counts["flash_bwd_dq"],
            device)
        per_step.append(counts)
        for k in total:
            total[k] += counts[k]
        for k, n in step_by_kernel.items():
            by_kernel[k] = by_kernel.get(k, 0) + n
        for k, n in step_bwd.items():
            bwd_by_kernel[k] = bwd_by_kernel.get(k, 0) + n
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() if cuda else None
    del params, opt_state, step, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    tokens = batch * seq
    out = {"config": {"preset_width": {"dim": cfg.dim,
                                       "n_layers": cfg.n_layers,
                                       "n_heads": cfg.n_heads,
                                       "n_kv_heads": cfg.n_kv_heads,
                                       "mlp_dim": cfg.mlp_dim},
                      "num_params": cfg.num_params(),
                      "attention_impl": cfg.attention_impl,
                      "remat_policy": cfg.remat_policy if cfg.remat
                      else None, "loss_chunk": cfg.loss_chunk,
                      "batch": batch, "seq": seq,
                      "accum_steps": accum_steps},
           "init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_s": times, "launches": total,
           "flash_fwd_by_kernel": by_kernel,
           "flash_bwd_by_kernel": bwd_by_kernel,
           "launches_per_step": per_step, "launches_want": want}
    checks = {
        "finite": all(math.isfinite(x) for x in losses + norms),
        "loss_falls": losses[-1] < losses[0],
        "launches_per_step_exact": all(c == want for c in per_step),
        "flash_fwd_on_wgmma": on_wgmma,
        "flash_bwd_on_wgmma": bwd_on_wgmma,
    }
    if cuda:
        out["device"] = smi_line()
        out["steady_step_s"] = step_s
        out["tokens_per_s"] = tokens / step_s
        out["mfu_bf16_peak"] = (llama.flops_per_token(cfg, seq) * tokens
                                / (step_s * _mfu_peak()))
        out["peak_memory_bytes"] = peak
    if grad_check:
        check = _grad_check(cfg, device, check_batch, check_seq)
        checks["flash_grads_match_plain"] = check.pop("ok")
        out["grad_check"] = check
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


# ----------------------------------------------------- the train runtime

# The worker's losses against the train phase's, step for step: the
# largest relative difference allowed. The step is deterministic on the
# card (the flash kernels issue no atomics, the embedding's gradient is a
# matmul, and the train phase's losses repeat to the last bit between two
# runs), so the worker, a fresh process on the same card, must reproduce
# them exactly.
TRAIN_RUNTIME_REL_TOL = 0.0
# The train phase's schedule, run by the worker: steps, the step after
# which the first attempt checkpoints and then fails once; then each tune
# trial's steps, and the trials' learning rates; the depth every run is
# cut to at full width (a 1B checkpoint is 14.03 GB, 3.84 GB at 4
# layers).
TRAIN_RUNTIME = dict(steps=4, ckpt_after=2, tune_steps=2,
                     tune_lrs=(3e-4, 3e-5), layers=4)


def _state_bytes(tree) -> int:
    from ray_tpu_torch.ops.optim import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _train_runtime_loop(config):
    """The train phase's setup and steps inside a ``TorchTrainer`` worker:
    each step reports its loss, gradient norm, time, peak memory and the
    kernels' launch counts read in this process. With ``ckpt_after`` the
    params and AdamW state are saved and reported as the checkpoint after
    that step, and the first attempt (no marker file yet) then fails; a
    later attempt restores from ``train.get_checkpoint()``."""
    t_enter = time.time()
    import shutil

    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.core import multihost
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cfg, device = config["cfg"], config["device"]
    cuda = torch.device(device).type == "cuda"
    params = train_step.init_sharded_params(
        lambda seed: llama.init_params(cfg, device=device,
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(cfg), key=0)
    opt = adamw(config["lr"], weight_decay=0.1)
    opt_state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt,
        accum_steps=config["accum_steps"])
    g = torch.Generator(device=device).manual_seed(0)
    data = {"tokens": torch.randint(0, cfg.vocab_size,
                                    (config["batch"], config["seq"] + 1),
                                    generator=g, device=device)}
    start, extra = 0, {}
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        _sync(device)
        t = time.perf_counter()
        tree, meta = train.restore_pytree(ckpt, {"params": params,
                                                 "opt": opt_state})
        _sync(device)
        restore_s = time.perf_counter() - t
        params, opt_state, start = tree["params"], tree["opt"], meta["step"]
        del tree
        nbytes = _dir_bytes(os.path.join(ckpt.path, "state"))
        extra = {"restore_s": restore_s, "restore_bytes": nbytes,
                 "restore_gb_s": nbytes / restore_s / 1e9,
                 "resumed_from": start, "restored_count": opt_state.count}
    _sync(device)
    t_ready = time.time()
    where = {"pid": os.getpid(), "device": str(torch.device(
        device, torch.cuda.current_device()) if cuda else device),
        "card": torch.cuda.get_device_name() if cuda else None,
        "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "world": dist.get_world_size() if dist.is_initialized() else 0,
        "groups": [(r["owner"], r["num_hosts"], r["epoch"])
                   for r in multihost.registry_state().values()],
        "state_bytes": _state_bytes({"p": params, "mu": opt_state.mu,
                                     "nu": opt_state.nu})}
    for s in range(start, config["steps"]):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        fwd0, bwd0 = fwd_kernel_counts(device), bwd_kernel_counts(device)
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, data)
        _sync(device)
        metrics = {"step": s + 1, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "step_s": time.perf_counter() - t,
                   "launches": launch_counts(),
                   "fwd_by_kernel": fwd_kernels_since(fwd0, device),
                   "bwd_by_kernel": bwd_kernels_since(bwd0, device),
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if cuda else None),
                   "t_enter": t_enter, "t_ready": t_ready, **where, **extra}
        extra = {}
        if s + 1 != config.get("ckpt_after"):
            metrics["t_report"] = time.time()
            train.report(metrics)
            continue
        staging = os.path.join(config["staging"], f"step{s + 1}")
        t = time.perf_counter()
        saved = train.save_pytree(staging, {"params": params,
                                            "opt": opt_state}, step=s + 1)
        save_s = time.perf_counter() - t
        nbytes = _dir_bytes(os.path.join(staging, "state"))
        metrics.update(save_s=save_s, save_bytes=nbytes,
                       save_gb_s=nbytes / save_s / 1e9,
                       t_report=time.time())
        t = time.perf_counter()
        train.report(metrics, checkpoint=saved)  # copies it into storage
        persist_s = time.perf_counter() - t
        shutil.rmtree(staging)
        if not os.path.exists(config["marker"]):
            with open(config["marker"], "w") as f:
                json.dump({"t_error": time.time(), "persist_s": persist_s,
                           "persist_gb_s": nbytes / persist_s / 1e9}, f)
            raise RuntimeError("injected failure after the step-"
                               f"{s + 1} checkpoint")


def _step_checks(history, want, device) -> dict:
    """Each reported step launched ``want``, the forward on wgmma and the
    backward on its wgmma kernels."""
    return {"launches_per_step_exact": all(
                m["launches"] == want for m in history),
            "flash_fwd_on_wgmma": all(all_on_wgmma(
                m["fwd_by_kernel"], m["launches"]["flash_fwd"], device)
                for m in history),
            "flash_bwd_on_wgmma": all(all_bwd_on_wgmma(
                m["bwd_by_kernel"], m["launches"]["flash_bwd_dkv"],
                m["launches"]["flash_bwd_dq"], device) for m in history)}


def _sum_counts(history, key) -> dict:
    total: dict = {}
    for m in history:
        for k, n in m[key].items():
            total[k] = total.get(k, 0) + n
    return total


def phase_train_runtime(cfg, device="cuda", batch=8, seq=2048,
                        accum_steps=2) -> dict:
    """The train phase's model, cut to ``TRAIN_RUNTIME["layers"]`` at full
    width, and steps through the train and tune planes on the runtime:
    ``rt.init()``, a ``TorchTrainer`` whose one GPU-leased worker joins a
    one-rank NCCL group through the gang registry, a checkpoint of params
    and AdamW state after step 2, an injected failure, a restart restored
    from the checkpoint, then a ``Tuner`` of two learning rates over the
    same trainer, each trial's gang on the one card in turn. The worker's
    losses are held against the train phase's steps run in this process
    at the cut depth. See the module docstring."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    cuda = torch.device(device).type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cfg = replace(cfg, n_layers=TRAIN_RUNTIME["layers"])
    ref = phase_train(cfg, device, batch, seq, TRAIN_RUNTIME["steps"],
                      accum_steps, grad_check=False)
    train = {"losses": ref["losses"], "step_s": ref["step_s"]}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"card_memory_before_fit": (
        dict(zip(("free", "total"), torch.cuda.mem_get_info()))
        if cuda else None)}
    storage = tempfile.mkdtemp(prefix="train_runtime_")
    # Params and AdamW's two moments in fp32: staged and persisted copies.
    need = 2 * 3 * 4 * cfg.num_params()
    out["storage"] = {"path": storage, "free_bytes":
                      shutil.disk_usage(storage).free, "need_bytes": need}
    print(json.dumps({"train_runtime_storage": out["storage"]}),
          flush=True)
    try:
        if out["storage"]["free_bytes"] < need:
            raise RuntimeError(
                f"the storage path {storage} has "
                f"{out['storage']['free_bytes']} bytes free; the 1B "
                f"checkpoint's staged and persisted copies need {need}")
        _runtime_init(device)
        try:
            return _train_runtime(cfg, train, device, batch, seq,
                                  accum_steps, storage, out)
        finally:
            if rt.is_initialized():  # a failure before the teardown
                rt.shutdown()
    finally:
        shutil.rmtree(storage, ignore_errors=True)


def _train_runtime(cfg, train, device, batch, seq, accum_steps, storage,
                   out) -> dict:
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.core import multihost
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)
    from ray_tpu_torch.train.torch_backend import TorchConfig

    cuda = torch.device(device).type == "cuda"
    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    resources = rt.cluster_resources()
    gpus = rt.available_resources().get("GPU")
    checks = {"gpu_resource": resources.get("GPU") == 1.0 and gpus == 1.0}
    marker = os.path.join(storage, "failed_once")
    loop_config = dict(cfg=cfg, device=device, batch=batch, seq=seq,
                       accum_steps=accum_steps, lr=3e-4,
                       steps=TRAIN_RUNTIME["steps"],
                       ckpt_after=TRAIN_RUNTIME["ckpt_after"],
                       staging=os.path.join(storage, "staging"),
                       marker=marker)
    scaling = ScalingConfig(num_workers=1, use_gpu=True,
                            torch_config=TorchConfig(
                                distributed=True,
                                device_type=None if cuda else "cpu"))
    arrivals = []
    trainer = TorchTrainer(
        _train_runtime_loop, train_loop_config=loop_config,
        scaling_config=scaling,
        run_config=RunConfig(name="train_runtime", storage_path=storage,
                             failure_config=FailureConfig(max_failures=1)),
        result_callback=lambda r: arrivals.append(time.time()))
    t_fit = time.time()
    result = trainer.fit()
    fit_s = time.time() - t_fit
    if result.error is not None:
        raise RuntimeError(f"TorchTrainer.fit failed: {result.error}")
    hist = [r["metrics"] for r in result.metrics_history]
    with open(marker) as f:
        failed = json.load(f)
    by_step = {m["step"]: m for m in hist}
    steps = [by_step[s]["step_s"] for s in sorted(by_step)]
    losses = [by_step[s]["loss"] for s in sorted(by_step)]
    first_after = min((m for m in hist if m["t_enter"] > failed["t_error"]),
                      key=lambda m: m["t_report"])
    saved = by_step[TRAIN_RUNTIME["ckpt_after"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    w = hist[0]
    out.update({
        "resources": resources, "fit_s": fit_s, "error": result.error,
        "worker": {k: w[k] for k in ("pid", "device", "card", "backend",
                                     "world", "groups", "cuda_visible",
                                     "state_bytes")},
        "losses": losses, "train_losses": train["losses"],
        "loss_max_rel_diff": max(rel) if rel else None,
        "tol": TRAIN_RUNTIME_REL_TOL,
        "grad_norms": [by_step[s]["grad_norm"] for s in sorted(by_step)],
        "step_s": steps, "median_step_s": _median(steps),
        "train_step_s": train["step_s"],
        "train_median_step_s": _median(train["step_s"]),
        # Past each process's first step (its warm-up), as train's 2-4.
        "steady_median_step_s": _median(
            [m["step_s"] for m in hist
             if m["step"] != min(x["step"] for x in hist
                                 if x["pid"] == m["pid"])]),
        "train_steady_median_step_s": _median(train["step_s"][1:]),
        "peak_bytes": [by_step[s]["peak_bytes"] for s in sorted(by_step)],
        "worker_start_s": w["t_enter"] - t_fit,
        "worker_ready_s": w["t_ready"] - t_fit,
        "fit_to_first_report_s": arrivals[0] - t_fit if arrivals else None,
        "checkpoint": {
            "bytes": saved["save_bytes"], "save_s": saved["save_s"],
            "save_gb_s": saved["save_gb_s"],
            "persist_s": failed["persist_s"],
            "persist_gb_s": failed["persist_gb_s"],
            "restore_s": first_after["restore_s"],
            "restore_gb_s": first_after["restore_gb_s"],
            "path": (os.path.relpath(result.checkpoint.path, storage)
                     if result.checkpoint else None)},
        "restart": {"error_to_first_report_s":
                    first_after["t_report"] - failed["t_error"],
                    "error_to_loop_s":
                    first_after["t_enter"] - failed["t_error"],
                    "loop_to_ready_s":
                    first_after["t_ready"] - first_after["t_enter"]}})
    # Every kernel of the train path once per layer and microbatch (the
    # forward twice, for the remat recompute).
    want = {**{k: 0 for k in KERNELS},
            "flash_fwd": 2 * cfg.n_layers * accum_steps,
            "flash_bwd_dkv": cfg.n_layers * accum_steps,
            "flash_bwd_dq": cfg.n_layers * accum_steps,
            "attention_delta": cfg.n_layers * accum_steps}
    checks.update(_step_checks(hist, want, device))
    checks.update({
        "one_restart": (len({m["pid"] for m in hist}) == 2
                        and first_after["resumed_from"]
                        == TRAIN_RUNTIME["ckpt_after"]
                        and first_after["restored_count"]
                        == TRAIN_RUNTIME["ckpt_after"]),
        "four_steps": sorted(by_step) == list(
            range(1, TRAIN_RUNTIME["steps"] + 1)),
        "losses_match_train": (len(rel) == TRAIN_RUNTIME["steps"]
                               and max(rel) <= TRAIN_RUNTIME_REL_TOL),
        "checkpoint_holds_the_state": (saved["save_bytes"]
                                       >= w["state_bytes"]),
        "nccl_group_of_one_through_the_registry": all(
            m["backend"] == ("nccl" if cuda else "gloo") and m["world"] == 1
            and m["groups"] == [("train-worker-group", 1, 1)]
            for m in hist),
        "worker_on_the_card": all(
            m["pid"] != os.getpid() and m["device"].startswith(device)
            and (not cuda or bool(m["card"])) for m in hist),
    })
    # Tune: two learning rates over the same trainer, each trial's gang
    # holding the one GPU in turn. One trial at a time: run together, the
    # second waits out a refused 60 s reservation before its requeue, a
    # path tests/test_torch_tune_requeue.py holds on the CPU.
    tune_config = {**loop_config, "steps": TRAIN_RUNTIME["tune_steps"],
                   "ckpt_after": None}
    t_tune = time.time()
    grid = tune.Tuner(
        TorchTrainer(_train_runtime_loop, train_loop_config=tune_config,
                     scaling_config=scaling,
                     run_config=RunConfig(storage_path=storage)),
        param_space={"lr": tune.grid_search(
            list(TRAIN_RUNTIME["tune_lrs"]))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1)).fit()
    tune_s = time.time() - t_tune
    trials = sorted(grid, key=lambda r: r.config["lr"], reverse=True)
    th = [r.metrics_history for r in trials]
    best = grid.get_best_result()
    out["tune"] = {
        "wall_s": tune_s,
        "trials": [{"lr": r.config["lr"], "error": r.error,
                    "losses": [m["loss"] for m in h],
                    "step_s": [m["step_s"] for m in h],
                    "start_s": h[0]["t_enter"] - t_tune if h else None,
                    "end_s": h[-1]["t_report"] - t_tune if h else None,
                    "pid": h[0]["pid"] if h else None}
                   for r, h in zip(trials, th)],
        "best_lr": best.config["lr"]}
    tune_steps = [m for h in th for m in h]
    checks.update({
        "tune_trials_finish": all(r.error is None and len(h)
                                  == TRAIN_RUNTIME["tune_steps"]
                                  for r, h in zip(trials, th)),
        "tune_first_losses_equal": len({h[0]["loss"] for h in th
                                        if h}) == 1,
        "tune_best_is_lowest_final_loss": best.config["lr"] == min(
            trials, key=lambda r: r.metrics["loss"]).config["lr"],
        "tune_trials_in_turn_on_the_card": (
            len(th) == 2 and all(th) and th[1][0]["t_enter"]
            > th[0][-1]["t_report"]),
        **{f"tune_{k}": v for k, v in _step_checks(
            tune_steps, want, device).items()}})
    all_steps = hist + tune_steps
    out.update({"launches": {k: sum(m["launches"][k] for m in all_steps)
                             for k in KERNELS},
                "launches_want_per_step": want,
                "flash_fwd_by_kernel": _sum_counts(all_steps,
                                                   "fwd_by_kernel"),
                "flash_bwd_by_kernel": _sum_counts(all_steps,
                                                   "bwd_by_kernel")})
    out["gpu_returned"] = _poll_until(
        lambda: rt.available_resources().get("GPU"), lambda v: v == gpus)
    out["groups_left"] = multihost.registry_state()
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                      lambda v: not v, 15.0)
    shutil.rmtree(storage)
    checks["teardown_clean"] = (out["gpu_returned"] == gpus
                                and not out["groups_left"]
                                and not out["store_file_left"]
                                and not out["processes_left"]
                                and not os.path.exists(storage))
    out["checks"] = checks
    if cuda:
        out["device"] = smi_line()
    out["ok"] = all(checks.values())
    return out


# The ViT-B/16 train loop (``bench.py``'s ViT workload): batch, steps (the
# first a warm-up), the prefetch depth.
VIT_TRAIN = dict(batch=256, steps=6, prefetch=2)
# Port on the card against port on the CPU at the debug size in float32,
# TF32 off: logits and gradients within this share of their max |value|
# (the same math, fp32 sums in another order).
VIT_F32_TOL = 1e-4
# pad_tokens_to against no padding on the card, ViT-B/16 width, B = 4:
# float32 at the tolerance above, bf16 at the JAX package's test's 2e-2
# (cuBLAS picks its kernels by shape, so the bf16 roundings differ).
VIT_PAD_BF16_TOL = 2e-2


def _steady(xs: list) -> float:
    """The mean past the first (warm-up) entry."""
    xs = xs[1:] or xs
    return sum(xs) / len(xs)


def _vit_host_batches(cfg, batch: int, n: int, seed: int) -> list:
    """``n`` host batches of float32 NHWC images and int64 labels, made
    with numpy from ``seed`` before the loop (set-up, not ingest)."""
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.channels)
    return [{"images": rng.standard_normal(shape, dtype=np.float32),
             "labels": rng.integers(0, cfg.num_classes, batch)}
            for _ in range(n)]


def _checksum(images, labels):
    """Integer sums of the images' bits and of the labels, exact on the
    host (numpy) and on the card (torch) alike."""
    if isinstance(images, np.ndarray):
        return (int(images.view(np.int32).sum(dtype=np.int64)),
                int(labels.sum()))
    return torch.stack([images.view(torch.int32).sum(dtype=torch.int64),
                        labels.sum()])


def _max_rel(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _vit_cpu_check(device) -> dict:
    """The debug preset in float32 with a random head: logits and every
    gradient on ``device`` against the CPU."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops.optim import tree_leaves, tree_map
    from ray_tpu_torch.parallel.train_step import value_and_grad

    cfg = replace(vit.PRESETS["debug"], dtype=torch.float32)
    params = vit.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    params["head"].normal_(std=cfg.dim ** -0.5,
                           generator=torch.Generator().manual_seed(1))
    host = _vit_host_batches(cfg, 8, 1, seed=2)[0]
    batch = {k: torch.from_numpy(v) for k, v in host.items()}

    def run(p, b):
        with torch.no_grad():
            logits = vit.forward(p, b["images"], cfg)
        loss, grads = value_and_grad(lambda p_, b_: vit.loss_fn(
            p_, b_, cfg)[0], p, b)
        return logits, loss, tree_leaves(grads)

    want = run(params, batch)
    got = run(tree_map(lambda t: t.to(device), params),
              tree_map(lambda t: t.to(device), batch))
    logits = _max_rel(got[0], want[0])
    grads = max(_max_rel(a, b) for a, b in zip(got[2], want[2]))
    return {"logits_max_rel": logits, "grads_max_rel": grads,
            "loss": float(got[1]), "loss_cpu": float(want[1]),
            "tol": VIT_F32_TOL,
            "ok": max(logits, grads) <= VIT_F32_TOL
            and abs(float(got[1]) - float(want[1]))
            <= VIT_F32_TOL * abs(float(want[1]))}


def _vit_pad_check(cfg, params, device, b=4) -> dict:
    """``pad_tokens_to=256`` logits against the unpadded ones at the
    config's width and depth, B = ``b``, with a random head, in float32 and
    in the config's dtype."""
    from ray_tpu_torch.models import vit

    g = torch.Generator(device=device).manual_seed(3)
    head = torch.randn(params["head"].shape, generator=g, device=device)
    p = dict(params, head=head * cfg.dim ** -0.5)
    images = torch.randn(b, cfg.image_size, cfg.image_size, cfg.channels,
                         generator=g, device=device)
    out = {"pad_tokens_to": 256, "tokens": cfg.num_patches, "batch": b}
    ok = True
    for name, dt, tol in (("f32", torch.float32, VIT_F32_TOL),
                          ("bf16", cfg.dtype, VIT_PAD_BF16_TOL)):
        c = replace(cfg, dtype=dt)
        with torch.no_grad():
            base = vit.forward(p, images, c)
            pad = vit.forward(p, images, replace(c, pad_tokens_to=256))
        err = _max_rel(pad, base)
        out[f"{name}_max_rel"] = err
        out[f"{name}_tol"] = tol
        ok = ok and err <= tol and bool(torch.isfinite(pad).all())
    out["ok"] = ok
    return out


def phase_vit(cfg, device="cuda", batch=None, steps=None,
              prefetch=None) -> dict:
    """ViT-B/16 (``cfg``) trained from fp32 masters (seed 0) with AdamW
    through ``build_train_step``, fed by ``device_prefetch`` from host
    batches; then the same number of steps on the same batches placed on
    the card beforehand, the port on the card against the CPU at the debug
    size, and ``pad_tokens_to`` against no padding."""
    from ray_tpu_torch.data import device_prefetch
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops.optim import adamw, tree_leaves
    from ray_tpu_torch.parallel import train_step

    batch = batch or VIT_TRAIN["batch"]
    steps = steps or VIT_TRAIN["steps"]
    prefetch = prefetch or VIT_TRAIN["prefetch"]
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = vit.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    before = {k: params[k].clone() for k in ("patch_embed", "head")}
    before["wqkv"] = params["layers"]["wqkv"].clone()
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: vit.loss_fn(p, b, cfg)[0], opt)
    host = _vit_host_batches(cfg, batch, steps, seed=1)
    want_sums = [_checksum(h["images"], h["labels"]) for h in host]
    _sync(device)
    init_s = time.perf_counter() - t0

    def run(batches):
        nonlocal params, state
        losses, times, sums = [], [], []
        t = time.perf_counter()
        for b in batches:
            params, state, m = step(params, state, b)
            sums.append(_checksum(b["images"], b["labels"]))
            _sync(device)
            now = time.perf_counter()
            times.append(now - t)
            t = now
            losses.append(float(m["loss"]))
        return losses, times, [tuple(int(x) for x in s) for s in sums]

    reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    it = device_prefetch(iter(host), prefetch=prefetch, device=device)
    losses, times, got_sums = run(it)
    stats = it.stats()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # The yardstick: the same batches, already on the card.
    placed = [{k: torch.from_numpy(v).to(device) for k, v in h.items()}
              for h in host]
    _sync(device)
    placed_losses, placed_times, _ = run(placed)
    launches = launch_counts()
    moved = {k: not torch.equal(v, params["layers"]["wqkv"] if k == "wqkv"
                                else params[k]) for k, v in before.items()}
    finite = all(math.isfinite(x) for x in losses + placed_losses) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    del before, placed, it
    cpu_check = _vit_cpu_check(device)
    pad_check = _vit_pad_check(cfg, params, device)
    del params, state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    step_s, placed_s = _steady(times), _steady(placed_times)
    waits = stats["wait_s"]
    out = {"config": {"image_size": cfg.image_size,
                      "patch_size": cfg.patch_size, "dim": cfg.dim,
                      "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                      "mlp_dim": cfg.mlp_dim,
                      "num_classes": cfg.num_classes,
                      "num_params": vit.num_params(cfg),
                      "dtype": str(cfg.dtype), "remat": cfg.remat,
                      "remat_policy": cfg.remat_policy, "batch": batch,
                      "steps": steps, "prefetch": prefetch,
                      "optimizer": "adamw(3e-4, weight_decay=0.1)"},
           "init_s": init_s, "losses": losses, "step_s": times,
           "placed_losses": placed_losses, "placed_step_s": placed_times,
           "prefetch_wait_s": waits,
           "prefetch": {k: v for k, v in stats.items() if k != "wait_s"},
           "cpu_check": cpu_check, "pad_check": pad_check,
           "launches": launches}
    checks = {
        "finite": finite,
        "params_moved": all(moved.values()),
        "device_batches_equal_host": got_sums == want_sums,
        "host_buffers_pinned": bool(stats.get("pinned")) or not cuda,
        "copies_on_side_stream": bool(stats.get("side_stream")) or not cuda,
        "card_matches_cpu_debug_f32": cpu_check.pop("ok"),
        "pad_tokens_to_matches": pad_check.pop("ok"),
        "no_hand_written_kernel_launched": not any(launches.values()),
    }
    if cuda:
        out["device"] = smi_line()
        out["steady_step_s"] = step_s
        out["images_per_s"] = batch / step_s
        out["mfu_bf16_peak"] = (vit.flops_per_image(cfg) * batch
                                / (step_s * _mfu_peak()))
        out["placed_steady_step_s"] = placed_s
        out["placed_images_per_s"] = batch / placed_s
        out["steady_prefetch_wait_s_mean"] = _steady(waits)
        out["h2d_gb_per_s"] = stats["h2d_gb_per_s"]
        out["peak_memory_bytes"] = peak
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


# ----------------------------------------------------------- data_train

# The Dataset feeds: (a) the train phase's tokens repeated for its steps,
# in ``blocks`` blocks, to a ``TorchTrainer`` worker; (b) ``vit_steps``
# batches of ``vit_batch`` uint8 images, one block a batch, cast to float
# by a map task, to ViT-B/16 in process (``seed`` makes them).
DATA_TRAIN = dict(steps=4, blocks=8, vit_batch=256, vit_steps=4, seed=4)


def _row_sums(block):
    """data_train (a)'s map task (numpy, in a CPU worker): the tokens and
    each row's checksum."""
    return {"tokens": block["tokens"],
            "row_sum": block["tokens"].sum(axis=1, dtype=np.int64)}


def _unit_images(block):
    """data_train (b)'s map task (numpy, in a CPU worker): uint8 images as
    float32 in [0, 1]. The check in this process runs the same
    function."""
    return {"images": block["images"].astype(np.float32) / np.float32(255),
            "labels": block["labels"]}


def _data_train_loop(config):
    """The train phase's setup in a ``TorchTrainer`` worker, stepping on
    ``train.get_dataset_shard("train").iter_device_batches``: each step
    reports its wait on the iterator, its loss, time and launch counts,
    and the batch's row checksums on the card against the map task's; the
    last also whether the shard is exhausted and the copies' stats."""
    t_enter = time.time()
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cfg, device = config["cfg"], config["device"]
    cuda = torch.device(device).type == "cuda"
    params = train_step.init_sharded_params(
        lambda seed: llama.init_params(cfg, device=device,
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(cfg), key=0)
    opt = adamw(3e-4, weight_decay=0.1)
    opt_state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt,
        accum_steps=config["accum_steps"])
    # The card the runner thread set (this worker's local rank), unless
    # the rehearsal asks for the CPU.
    it = train.get_dataset_shard("train").iter_device_batches(
        batch_size=config["batch"], device=None if cuda else "cpu")
    _sync(device)
    where = {"pid": os.getpid(), "batch_device": str(it.device),
             "current_device": (torch.cuda.current_device() if cuda
                                else None),
             "t_enter": t_enter, "t_ready": time.time()}
    for s in range(config["steps"]):
        t = time.perf_counter()
        batch = next(it)
        wait_s = time.perf_counter() - t
        sums = batch["tokens"].sum(dim=1)
        metrics = {"step": s + 1, "wait_s": wait_s,
                   "row_sums": sums.tolist(),
                   "row_sums_match_task": bool(torch.equal(
                       sums, batch["row_sum"])),
                   "on": str(batch["tokens"].device), **where}
        reset_counts()
        fwd0, bwd0 = fwd_kernel_counts(device), bwd_kernel_counts(device)
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state,
                                    {"tokens": batch["tokens"]})
        _sync(device)
        metrics.update(loss=float(m["loss"]),
                       step_s=time.perf_counter() - t,
                       launches=launch_counts(),
                       fwd_by_kernel=fwd_kernels_since(fwd0, device),
                       bwd_by_kernel=bwd_kernels_since(bwd0, device))
        if s + 1 == config["steps"]:
            metrics["exhausted"] = next(it, None) is None
            metrics["prefetch"] = {k: v for k, v in it.stats().items()
                                   if k != "wait_s"}
        train.report(metrics)


def phase_data_train(cfg, train: dict, vit_cfg, vit_rate=None,
                     device="cuda", batch=8, seq=2048, accum_steps=2,
                     vit_batch=None, vit_steps=None) -> dict:
    """The Dataset API on the runtime feeding the train steps: (a) the
    train phase's tokens through ``from_numpy`` -> a ``map_batches`` task
    -> ``TorchTrainer(datasets=...)`` -> ``get_dataset_shard`` ->
    ``iter_device_batches`` into the 1B step in a GPU-leased worker; (b)
    uint8 images through a casting ``map_batches`` task, streamed by
    ``Dataset.iter_device_batches`` into the ViT step in process. ``train``
    is the train phase's result, ``vit_rate`` the vit phase's images/s.
    See the module docstring."""
    import ray_tpu_torch as rt

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _runtime_init(device)
    try:
        return _data_train(cfg, train, vit_cfg, vit_rate, device, batch,
                           seq, accum_steps,
                           vit_batch or DATA_TRAIN["vit_batch"],
                           vit_steps or DATA_TRAIN["vit_steps"])
    finally:
        if rt.is_initialized():  # a failure before the phase's teardown
            rt.shutdown()


def _data_train(cfg, train, vit_cfg, vit_rate, device, batch, seq,
                accum_steps, vit_batch, vit_steps) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch_backend import TorchConfig

    cuda = torch.device(device).type == "cuda"
    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    resources = rt.cluster_resources()
    gpus = rt.available_resources().get("GPU")
    checks = {"gpu_resource": resources.get("GPU") == 1.0 and gpus == 1.0}
    steps = DATA_TRAIN["steps"]
    # The train phase's tokens, drawn as it draws them, then on the host.
    g = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=g, device=device).cpu().numpy()
    rows = np.concatenate([tokens] * steps)
    t = time.perf_counter()
    ds = data.from_numpy({"tokens": rows}, num_blocks=DATA_TRAIN["blocks"]
                         ).map_batches(_row_sums).materialize()
    materialize_s = time.perf_counter() - t
    stages = ds.stats()
    result = TorchTrainer(
        _data_train_loop,
        train_loop_config=dict(cfg=cfg, device=device, batch=batch,
                               accum_steps=accum_steps, steps=steps),
        scaling_config=ScalingConfig(
            num_workers=1, use_gpu=True, torch_config=TorchConfig(
                distributed=True, device_type=None if cuda else "cpu")),
        run_config=RunConfig(name="data_train"),
        datasets={"train": ds}).fit()
    if result.error is not None:
        raise RuntimeError(f"TorchTrainer.fit failed: {result.error}")
    hist = [r["metrics"] for r in result.metrics_history]
    losses = [m["loss"] for m in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    want = {**{k: 0 for k in KERNELS},
            "flash_fwd": 2 * cfg.n_layers * accum_steps,
            "flash_bwd_dkv": cfg.n_layers * accum_steps,
            "flash_bwd_dq": cfg.n_layers * accum_steps,
            "attention_delta": cfg.n_layers * accum_steps}
    host_sums = tokens.sum(axis=1).tolist()
    last = hist[-1] if hist else {}
    card = f"{device}:0" if cuda else device
    step_s = [m["step_s"] for m in hist]
    out = {"resources": resources,
           "a": {"config": {"batch": batch, "seq": seq,
                            "accum_steps": accum_steps, "steps": steps,
                            "blocks": DATA_TRAIN["blocks"]},
                 "materialize_s": materialize_s,
                 "stages": stages.splitlines(),
                 "store_bytes": {"put": rows.nbytes,
                                 "task_out": rows.nbytes + 8 * len(rows)},
                 "worker": {k: hist[0][k] for k in (
                     "pid", "batch_device", "current_device")}
                 if hist else None,
                 "wait_s": [m["wait_s"] for m in hist],
                 "losses": losses, "train_losses": train["losses"],
                 "loss_max_rel_diff": max(rel) if rel else None,
                 "tol": TRAIN_RUNTIME_REL_TOL,
                 "step_s": step_s, "train_step_s": train["step_s"],
                 "train_median_step_s": _median(train["step_s"]),
                 "prefetch": last.get("prefetch")}}
    checks.update(_step_checks(hist, want, device))
    checks.update({
        "four_steps": [m["step"] for m in hist] == list(range(1, steps + 1)),
        "losses_match_train": (len(rel) == steps
                               and max(rel) <= TRAIN_RUNTIME_REL_TOL),
        "device_batches_match_host_rows": all(
            m["row_sums"] == host_sums and m["row_sums_match_task"]
            for m in hist),
        "batches_on_the_workers_card": all(
            m["on"] == card and m["batch_device"] == card
            and m["pid"] != os.getpid() for m in hist),
        "shard_exhausted": bool(last.get("exhausted")),
    })
    out["a"]["launches_want_per_step"] = want
    out.update({"launches": {k: sum(m["launches"][k] for m in hist)
                             for k in KERNELS},
                "flash_fwd_by_kernel": _sum_counts(hist, "fwd_by_kernel"),
                "flash_bwd_by_kernel": _sum_counts(hist, "bwd_by_kernel")})
    b, b_checks = _data_train_vit(vit_cfg, vit_rate, device, vit_batch,
                                  vit_steps)
    out["b"] = b
    checks.update({f"vit_{k}": v for k, v in b_checks.items()})
    out["gpu_returned"] = _poll_until(
        lambda: rt.available_resources().get("GPU"), lambda v: v == gpus)
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                        lambda v: not v, 15.0)
    checks["teardown_clean"] = (out["gpu_returned"] == gpus
                                and not out["store_file_left"]
                                and not out["processes_left"])
    out["checks"] = checks
    if cuda:
        out["device"] = smi_line()
    out["ok"] = all(checks.values())
    return out


def _data_train_vit(cfg, vit_rate, device, batch, steps):
    """data_train (b): seeded uint8 NHWC images and int64 labels, one
    block a batch, cast by a ``map_batches`` task and streamed through
    ``Dataset.iter_device_batches`` into ViT's step (fp32 masters from
    seed 0, AdamW(3e-4, wd 0.1)) on this process's card."""
    from ray_tpu_torch import data
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    rng = np.random.default_rng(DATA_TRAIN["seed"])
    n = batch * steps
    images = rng.integers(0, 256, (n, cfg.image_size, cfg.image_size,
                                   cfg.channels), dtype=np.uint8)
    labels = rng.integers(0, cfg.num_classes, n)
    want_sums = []
    for i in range(steps):
        host = _unit_images({"images": images[i * batch:(i + 1) * batch],
                             "labels": labels[i * batch:(i + 1) * batch]})
        want_sums.append(_checksum(host["images"], host["labels"]))
    ds = data.from_numpy({"images": images, "labels": labels},
                         num_blocks=steps).map_batches(_unit_images)
    params = vit.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: vit.loss_fn(p, b, cfg)[0], opt)
    _sync(device)
    reset_counts()
    it = ds.iter_device_batches(batch_size=batch, device=device)
    losses, times, waits, got_sums = [], [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        b = next(it)
        waits.append(time.perf_counter() - t)
        params, state, m = step(params, state, b)
        got_sums.append(_checksum(b["images"], b["labels"]))
        _sync(device)
        times.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
    exhausted = next(it, None) is None
    got_sums = [tuple(int(x) for x in t) for t in got_sums]
    stats = it.stats()
    launches = launch_counts()
    del params, state, step, b, it
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"config": {"batch": batch, "steps": steps,
                      "image_size": cfg.image_size, "dtype_in": "uint8",
                      "dtype_out": "float32",
                      "store_bytes_per_batch_out":
                      batch * cfg.image_size ** 2 * cfg.channels * 4},
           "losses": losses, "step_s": times, "wait_s": waits,
           "prefetch": {k: v for k, v in stats.items() if k != "wait_s"},
           "launches": launches}
    if torch.device(device).type == "cuda":
        out["images_per_s"] = batch / _steady(times)
        out["vit_phase_images_per_s"] = vit_rate
    checks = {"finite": all(math.isfinite(x) for x in losses),
              "device_batches_equal_host": (
                  got_sums == [tuple(s) for s in want_sums]),
              "all_batches": len(losses) == steps and exhausted,
              "no_hand_written_kernel_launched": not any(launches.values())}
    return out, checks


# ------------------------------------------------------------------- rl

# The rl phase. (a) multi-agent PPO to the reference's thresholds; (b)
# every algorithm's update at the JAX defaults, ``updates`` of them on the
# card against the same on the CPU, then ``timed`` more on the card; (c)
# ``offline_rows`` Pendulum-shaped transitions through the Dataset into a
# replay buffer, then ``offline_updates`` CQL updates (BC warm start for
# the first ``offline_bc``); (d) with gymnasium, the env-driven algorithms.
RL = dict(ma_iters=60, guide=5.5, follower=5.0, updates=5, timed=20,
          offline_rows=4096, offline_updates=200, offline_bc=100,
          gym_ppo_iters=3)
# Card against CPU after ``updates`` updates: each loss within
# RL_LOSS_REL_TOL relative; each param within RL_ADAM_BOUND x lr x updates
# (Adam's early steps are near sign(g): an entry whose gradient is near
# zero may step either way on two correct devices).
RL_LOSS_REL_TOL = 1e-4
RL_LOSS_FLOOR = 1e-3       # the relative difference's least denominator
RL_ADAM_BOUND = 3.0


def _agent_policy(agent: str) -> str:
    return f"{agent}_policy"


def _nvidia_fds(pid: int) -> list:
    """The card device files (``/dev/nvidia<N>``) a process holds open:
    a CUDA context on a card keeps its file open."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return []
    out = []
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            out.append(target)
    return sorted(set(out))


def _on(tree, device) -> bool:
    from ray_tpu_torch.rl.tree import tree_leaves

    dev = torch.device(device).type
    return all(t.device.type == dev for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _rl_tree_equal(a, b) -> bool:
    from ray_tpu_torch.rl.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _timed_calls(fn, events: list, cuda: bool):
    """``fn`` with a pair of CUDA events recorded around each call."""
    def run(*args):
        if not cuda:
            return fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        events.append((start, end))
        return out

    return run


def _event_ms(events: list) -> list:
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def phase_rl(device="cuda") -> dict:
    """The RL plane with the learner on the card: multi-agent PPO through
    its entry point on the runtime, every algorithm's update against the
    CPU, the offline chain, and (with gymnasium) the env-driven
    algorithms. See the module docstring."""
    import importlib.util

    import ray_tpu_torch as rt

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("gymnasium", "pyarrow")}
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _runtime_init(device)
    try:
        return _rl(device, found)
    finally:
        if rt.is_initialized():  # a failure before the phase's teardown
            rt.shutdown()


def _rl(device, found) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker

    cuda = torch.device(device).type == "cuda"
    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    resources = rt.cluster_resources()
    gpus = rt.available_resources().get("GPU")
    checks = {"gpu_resource": resources.get("GPU") == 1.0 and gpus == 1.0}
    out = {"gymnasium": found["gymnasium"], "pyarrow": found["pyarrow"],
           "resources": resources}
    reset_counts()
    for key, part in (("a", lambda: _rl_multi_agent(device, node_hex)),
                      ("b", lambda: _rl_updates(device)),
                      ("c", lambda: _rl_offline(device, found["pyarrow"])),
                      ("d", lambda: _rl_gym(device, found["gymnasium"]))):
        res, part_checks = part()
        out[key] = res
        checks.update({f"{key}_{k}": v for k, v in part_checks.items()})
    launches = launch_counts()
    out["kernel_launches"] = launches
    checks["no_hand_written_kernel_launched"] = not any(launches.values())
    out["gpu_returned"] = _poll_until(
        lambda: rt.available_resources().get("GPU"), lambda v: v == gpus)
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                        lambda v: not v, 15.0)
    checks["teardown_clean"] = (out["gpu_returned"] == gpus
                                and not out["store_file_left"]
                                and not out["processes_left"])
    out["checks"] = checks
    if cuda:
        out["device"] = smi_line()
    out["ok"] = all(checks.values())
    return out


def _rl_multi_agent(device, node_hex):
    """(a) ``MultiAgentPPOConfig(...).build().train()`` until the guide's
    best return reaches ``RL["guide"]`` and the follower's
    ``RL["follower"]``, then save, one more iteration, restore."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import MultiAgentPPOConfig
    from ray_tpu_torch.rl.tree import host

    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    algo = MultiAgentPPOConfig(
        seed=0, num_env_runners=2, episodes_per_sample=16,
        policy_mapping_fn=_agent_policy, device=device).build()
    build_s = time.perf_counter() - t0
    events: list = []
    algo._updates = {pid: _timed_calls(fn, events, cuda)
                     for pid, fn in algo._updates.items()}
    # Sample time ends where the first policy batch is built; learn time
    # ends where the weights broadcast starts.
    marks: dict = {}

    def mark(name, fn):
        def run(*args):
            marks.setdefault(name, time.perf_counter())
            return fn(*args)
        return run

    algo._policy_batch = mark("sampled", algo._policy_batch)
    algo._broadcast_weights = mark("learned", algo._broadcast_weights)
    best, rows, on_card = {}, [], True
    try:
        node_pids = sorted(set(_live_node_pids(node_hex)))
        gpu_free = rt.available_resources().get("GPU")
        for _ in range(RL["ma_iters"]):
            marks.clear()
            t = time.perf_counter()
            m = algo.train()
            wall = time.perf_counter() - t
            on_card &= _on(algo.params, device) and _on(algo.opt_state,
                                                        device)
            for a, v in (m.get("agent_return_mean") or {}).items():
                best[a] = max(best.get(a, -math.inf), v)
            rows.append({
                "iter": m["training_iteration"],
                "env_steps": m["env_steps_this_iter"],
                "wall_s": wall,
                "sample_s": marks["sampled"] - t,
                "learn_s": marks["learned"] - marks["sampled"],
                "returns": m.get("agent_return_mean")})
            if (best.get("guide", 0) >= RL["guide"]
                    and best.get("follower", 0) >= RL["follower"]):
                break
        update_ms = _event_ms(events) if cuda else []
        node_fds = {pid: _nvidia_fds(pid) for pid in node_pids}
        own_fds = _nvidia_fds(os.getpid())
        ckpt = tempfile.mkdtemp()
        try:
            saved = host(algo.params)
            algo.save(ckpt)
            algo.train()
            moved = not _rl_tree_equal(algo.params, saved)
            algo.restore(ckpt)
            restored = _rl_tree_equal(algo.params, saved)
            restored_on = _on(algo.params, device) and _on(algo.opt_state,
                                                           device)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        algo.stop()
    steps = sum(r["env_steps"] for r in rows)
    wall = sum(r["wall_s"] for r in rows)
    res = {"config": {"seed": 0, "num_env_runners": 2,
                      "episodes_per_sample": 16, "lr": algo.config.lr,
                      "num_sgd_epochs": algo.config.num_sgd_epochs},
           "build_s": build_s, "iterations": len(rows), "best": best,
           "env_steps": steps, "env_steps_per_s": steps / wall,
           "sample_s_mean": float(np.mean([r["sample_s"] for r in rows])),
           "learn_s_mean": float(np.mean([r["learn_s"] for r in rows])),
           "iterations_log": rows,
           "node_pids": node_pids, "node_card_files": node_fds,
           "own_card_files": own_fds}
    if cuda:
        res["update_ms_median"] = _median(update_ms)
        res["updates"] = len(update_ms)
    checks = {
        "thresholds_met": (best.get("guide", 0) >= RL["guide"]
                           and best.get("follower", 0) >= RL["follower"]),
        "params_on_device_every_iteration": on_card,
        "runners_are_cpu_workers": gpu_free == 1.0 and len(node_pids) >= 3,
        "no_runner_cuda_context": not any(node_fds.values()),
        "own_context_visible": bool(own_fds) or not cuda,
        "restore_gives_saved_params": moved and restored,
        "restore_on_device": restored_on,
    }
    return res, checks


def _rl_cases() -> dict:
    """(b)'s cases: name -> (fresh(dev) -> state, step(state, batch, draw)
    -> the update's losses, trees(state) -> {name: (tree, lr)}, batches, draws,
    extra). Params come from one CPU generator per case."""
    from ray_tpu_torch.rl import appo, bc, cql, dqn, impala, ppo, sac
    from ray_tpu_torch.rl.models import (build_policy,
                                         build_squashed_gaussian_actor,
                                         build_twin_q)
    from ray_tpu_torch.rl.tree import adam, clone, to_device

    n = RL["updates"]

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def on(tree, dev):
        return to_device(clone(tree), dev)

    def obs(shape, dtype, b, rng):
        if dtype == np.uint8:
            return rng.integers(0, 256, (b,) + shape).astype(np.uint8)
        return rng.normal(size=(b,) + shape).astype(np.float32)

    cases = {}

    def policy_case(name, shape, n_actions, lr, make_update, make_batch,
                    bundle=None):
        init, fwd = build_policy(shape, n_actions, (64, 64))
        p0 = init(gen(0))
        opt = adam(lr)
        upd = make_update(fwd, opt)

        def fresh(dev):
            p = on(p0, dev)
            s = opt.init(p)
            return {"p": p, "s": bundle(p, s) if bundle else s,
                    "t": clone(p)}

        batches = [make_batch(np.random.default_rng(10 + i))
                   for i in range(n)]
        cases[name] = (fresh, upd, lambda s: {"params": (s["p"], lr)},
                       batches, [None] * n)

    def ppo_batch(shape, n_actions, dtype, b=256):
        def make(rng):
            return {"obs": obs(shape, dtype, b, rng),
                    "actions": rng.integers(0, n_actions, b),
                    "logp": rng.normal(-1.0, 0.3, b).astype(np.float32),
                    "advantages": rng.normal(0.3, 1.5, b).astype(
                        np.float32),
                    "returns": rng.normal(size=b).astype(np.float32)}
        return make

    pcfg = ppo.PPOConfig()

    def ppo_update(fwd, opt):
        u = ppo.make_ppo_update(fwd, opt, pcfg.clip_eps, pcfg.vf_coeff,
                                pcfg.entropy_coeff)

        def step(s, batch, _draw):
            s["p"], s["s"], aux = u(s["p"], s["s"], batch)
            return aux["total_loss"][None]
        return step

    policy_case("ppo_mlp", (4,), 2, pcfg.lr, ppo_update,
                ppo_batch((4,), 2, np.float32))
    policy_case("ppo_nature_cnn", (84, 84, 4), 6, pcfg.lr, ppo_update,
                ppo_batch((84, 84, 4), 6, np.uint8))

    def rollout(rng, T=64, N=8):
        dones = (rng.random((T, N)) < 0.05).astype(np.float32)
        valids = np.ones((T, N), np.float32)
        valids[1:][dones[:-1] > 0] = 0.0    # the autoreset rows
        return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, (T, N)),
                "logp": rng.normal(-0.7, 0.1, (T, N)).astype(np.float32),
                "rewards": np.where(valids > 0, 1.0, 0.0).astype(
                    np.float32),
                "dones": dones, "valids": valids,
                "last_value": rng.normal(size=N).astype(np.float32)}

    icfg = impala.IMPALAConfig()

    def impala_update(fwd, opt):
        u = impala.make_impala_update(fwd, opt, icfg)

        def step(s, batch, _draw):
            s["p"], s["s"], aux = u(s["p"], s["s"], batch)
            return aux["total_loss"][None]
        return step

    policy_case("impala", (4,), 2, icfg.lr, impala_update, rollout)
    acfg = appo.APPOConfig(target_update_interval=2)

    def appo_update(fwd, opt):
        u = appo.make_appo_update(fwd, opt, acfg)

        def step(s, batch, _draw):
            s["p"], s["s"], aux = u(s["p"], s["s"], batch)
            s.setdefault("syncs", 0)
            s["syncs"] += s["s"][2] == 0
            return aux["total_loss"][None]
        return step

    policy_case("appo", (4,), 2, acfg.lr, appo_update, rollout,
                bundle=lambda p, s: (s, clone(p), 0))
    dcfg = dqn.DQNConfig()

    def dqn_batch(rng, b=dcfg.batch_size):
        return {"obs": rng.normal(size=(b, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, b).astype(np.int32),
                "rewards": rng.normal(size=b).astype(np.float32),
                "next_obs": rng.normal(size=(b, 4)).astype(np.float32),
                "dones": (rng.random(b) < 0.1).astype(np.float32),
                "weights": rng.uniform(0.3, 1.0, b).astype(np.float32)}

    def dqn_update(fwd, opt):
        u = dqn.make_dqn_update(fwd, opt, dcfg.gamma, dcfg.double_q)

        def step(s, batch, _draw):
            s["p"], s["s"], loss, _aux = u(s["p"], s["t"], s["s"], batch)
            return loss[None]
        return step

    policy_case("dqn", (4,), 2, dcfg.lr, dqn_update, dqn_batch)
    bcfg = bc.BCConfig()

    def bc_batch(rng, b=bcfg.batch_size):
        return {"obs": rng.normal(size=(b, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, b)}

    def bc_update(fwd, opt):
        u = bc.make_bc_update(fwd, opt)

        def step(s, batch, _draw):
            s["p"], s["s"], loss, _acc = u(s["p"], s["s"], batch)
            return loss[None]
        return step

    policy_case("bc", (4,), 2, bcfg.lr, bc_update, bc_batch)

    # SAC and CQL at Pendulum's shapes (obs 3, action 1).
    def transitions(rng, b=256):
        return {"obs": rng.normal(size=(b, 3)).astype(np.float32),
                "actions": rng.uniform(-1, 1, (b, 1)).astype(np.float32),
                "rewards": rng.normal(-3.0, 1.0, b).astype(np.float32),
                "next_obs": rng.normal(size=(b, 3)).astype(np.float32),
                "terminateds": np.zeros(b, np.float32)}

    def continuous_case(name, cfg, make_update, draw_fn, log_alpha0):
        ai, af = build_squashed_gaussian_actor(3, 1, cfg.hidden)
        ci, cf = build_twin_q(3, 1, cfg.hidden)
        g = gen(0)
        a0, c0 = ai(g), ci(g)
        opts = (adam(cfg.actor_lr), adam(cfg.critic_lr), adam(cfg.alpha_lr))
        upd = make_update(af, cf, *opts)

        def fresh(dev):
            a, c = on(a0, dev), on(c0, dev)
            la = torch.full((), log_alpha0, device=dev)
            return {"a": a, "c": c, "t": clone(c), "la": la, "i": 0,
                    "s": tuple(o.init(x) for o, x in zip(opts, (a, c, la)))}

        def step(s, batch, draw):
            (s["a"], s["c"], s["t"], s["la"], s["s"], aux) = upd(
                s, batch, draw)
            s["i"] += 1
            return torch.stack([aux["critic_loss"], aux["actor_loss"]])

        def trees(s):
            return {"actor": (s["a"], cfg.actor_lr),
                    "critic": (s["c"], cfg.critic_lr),
                    "target_critic": (s["t"], cfg.critic_lr),
                    "log_alpha": (s["la"], cfg.alpha_lr)}

        batches = [transitions(np.random.default_rng(20 + i))
                   for i in range(n)]
        draws = [draw_fn(gen(30 + i)) for i in range(n)]
        cases[name] = (fresh, step, trees, batches, draws)

    scfg = sac.SACConfig()

    def sac_update(af, cf, ao, co, lo):
        u = sac.make_sac_update(af, cf, ao, co, lo, scfg.gamma, scfg.tau,
                                -1.0)
        return lambda s, batch, draw: u(s["a"], s["c"], s["t"], s["la"],
                                        s["s"], batch, draw)

    continuous_case("sac", scfg, sac_update,
                    lambda g: sac.sac_draws(g, scfg.batch_size, 1, "cpu"),
                    0.0)
    ccfg = cql.CQLConfig(bc_iters=2)

    def cql_update(af, cf, ao, co, lo):
        u = cql.make_cql_update(af, cf, ao, co, lo, ccfg, -1.0)
        return lambda s, batch, draw: u(
            s["a"], s["c"], s["t"], s["la"], s["s"], batch, draw,
            s["i"] < ccfg.bc_iters)

    continuous_case("cql", ccfg, cql_update,
                    lambda g: cql.cql_draws(g, ccfg.batch_size, 1,
                                            ccfg.cql_n_actions, "cpu"),
                    math.log(ccfg.initial_alpha))
    return cases


def _nature_flops(obs_shape=(84, 84, 4), n_actions=6) -> int:
    """Multiply-adds x 2 of one Nature-torso forward of one frame."""
    from ray_tpu_torch.rl.models import _CNN_SPEC

    h, w, c = obs_shape
    flops = 0
    for out_ch, k, stride in _CNN_SPEC:
        h, w = (h - k) // stride + 1, (w - k) // stride + 1
        flops += 2 * h * w * out_ch * k * k * c
        c = out_ch
    flops += 2 * h * w * c * 512 + 2 * 512 * (n_actions + 1)
    return flops


def _rl_updates(device):
    """(b) Each case's updates on ``device`` against the same on the CPU,
    then ``RL["timed"]`` more on the card, each between CUDA events."""
    from ray_tpu_torch.rl.tree import batch_to, tree_leaves

    cuda = torch.device(device).type == "cuda"
    n = RL["updates"]
    res, checks = {}, {}
    for name, (fresh, step, trees, batches, draws) in _rl_cases().items():
        runs = {}
        for dev in ("cpu", device):
            s = fresh(dev)
            losses = [step(s, batch_to(b, dev), None if d is None else
                           {k: v.to(dev) for k, v in d.items()})
                      for b, d in zip(batches, draws)]
            runs[dev] = (s, torch.stack(losses).cpu())
        (cs, cl), (ds, dl) = runs["cpu"], runs[device]
        rel = float(((dl - cl).abs() / cl.abs().clamp_min(
            RL_LOSS_FLOOR)).max())
        param = {}
        for tname, (tree, lr) in trees(ds).items():
            ctree = trees(cs)[tname][0]
            diff = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(tree_leaves(tree),
                                       tree_leaves(ctree)))
            param[tname] = {"max_abs_diff": diff,
                            "bound": RL_ADAM_BOUND * lr * n}
        finite = bool(torch.isfinite(dl).all()) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(
                [t for t, _ in trees(ds).values()]))
        row = {"losses": dl.tolist(), "cpu_losses": cl.tolist(),
               "loss_max_rel_diff": rel, "params": param}
        if "syncs" in ds:
            row["target_syncs"] = int(ds["syncs"])
        if cuda:
            events: list = []
            timed = _timed_calls(step, events, True)
            b = batch_to(batches[-1], device)
            d = None if draws[-1] is None else {
                k: v.to(device) for k, v in draws[-1].items()}
            for _ in range(RL["timed"]):
                timed(ds, b, d)
            row["update_ms_median"] = _median(_event_ms(events))
        res[name] = row
        checks[f"{name}_matches_cpu"] = (rel <= RL_LOSS_REL_TOL and all(
            p["max_abs_diff"] <= p["bound"] for p in param.values()))
        checks[f"{name}_finite"] = finite
        checks[f"{name}_on_device"] = _on(
            [t for t, _ in trees(ds).values()], device)
    checks["appo_target_synced"] = res["appo"].get("target_syncs", 0) >= 1
    flops = 3 * 256 * _nature_flops()
    res["ppo_nature_cnn"]["flops_per_update"] = flops
    res["ppo_nature_cnn"]["flops_per_frame_forward"] = _nature_flops()
    if cuda:
        ms = res["ppo_nature_cnn"]["update_ms_median"]
        res["ppo_nature_cnn"]["tflop_per_s"] = flops / (ms * 1e-3) / 1e12
    return res, checks


def _rl_offline(device, pyarrow: bool):
    """(c) Pendulum-shaped transitions (seeded numpy) -> ``from_numpy`` ->
    (with pyarrow: ``save_transitions`` / ``load_transitions``) ->
    ``dataset_to_buffer`` -> CQL updates on the card from buffer
    samples."""
    import shutil
    import tempfile

    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.rl import cql
    from ray_tpu_torch.rl.models import (build_squashed_gaussian_actor,
                                         build_twin_q)
    from ray_tpu_torch.rl.offline import (dataset_to_buffer,
                                          load_transitions,
                                          save_transitions)
    from ray_tpu_torch.rl.tree import adam, batch_to, clone, to_device

    rng = np.random.default_rng(6)
    n = RL["offline_rows"]
    theta = rng.uniform(-np.pi, np.pi, n)
    cols = {"obs": np.stack([np.cos(theta), np.sin(theta),
                             rng.uniform(-8, 8, n)], 1).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
            "rewards": -(theta ** 2).astype(np.float32),
            "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
            "terminateds": np.zeros(n, np.float32)}
    t = time.perf_counter()
    ds = rdata.from_numpy(cols, num_blocks=8)
    tmp = None
    if pyarrow:
        tmp = tempfile.mkdtemp()
        save_transitions(ds, tmp)
        ds = load_transitions(tmp)
    try:
        buf = dataset_to_buffer(ds, seed=0)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    ingest_s = time.perf_counter() - t
    held = buf._storage["rewards"][:len(buf)]
    cfg = cql.CQLConfig(bc_iters=RL["offline_bc"])
    ai, af = build_squashed_gaussian_actor(3, 1, cfg.hidden)
    ci, cf = build_twin_q(3, 1, cfg.hidden)
    g = torch.Generator().manual_seed(cfg.seed)
    actor, critic = to_device(ai(g), device), to_device(ci(g), device)
    target = clone(critic)
    log_alpha = torch.full((), math.log(cfg.initial_alpha), device=device)
    opts = (adam(cfg.actor_lr), adam(cfg.critic_lr), adam(cfg.alpha_lr))
    states = tuple(o.init(x) for o, x in zip(opts, (actor, critic,
                                                    log_alpha)))
    upd = cql.make_cql_update(af, cf, *opts, cfg, -1.0)
    draw_gen = torch.Generator().manual_seed(cfg.seed + 1)
    _sync(device)
    t = time.perf_counter()
    losses = []
    for i in range(RL["offline_updates"]):
        batch, _idx, _w = buf.sample(cfg.batch_size)
        draws = cql.cql_draws(draw_gen, cfg.batch_size, 1,
                              cfg.cql_n_actions, device)
        actor, critic, target, log_alpha, states, aux = upd(
            actor, critic, target, log_alpha, states,
            batch_to(batch, device), draws, i < cfg.bc_iters)
        losses.append(aux["critic_loss"])
    _sync(device)
    learn_s = time.perf_counter() - t
    losses = torch.stack(losses).cpu()
    res = {"rows": n, "pyarrow_round_trip": pyarrow, "ingest_s": ingest_s,
           "updates": RL["offline_updates"], "bc_updates": cfg.bc_iters,
           "learn_s": learn_s,
           "ms_per_update": 1e3 * learn_s / RL["offline_updates"],
           "critic_loss_first_last": [float(losses[0]), float(losses[-1])]}
    checks = {"buffer_holds_every_row": len(buf) == n and np.array_equal(
        np.sort(held), np.sort(cols["rewards"])),
        "critic_loss_finite": bool(torch.isfinite(losses).all()),
        "params_on_device": _on([actor, critic, target, log_alpha],
                                device)}
    return res, checks


def _rl_gym(device, have_gym: bool):
    """(d) With gymnasium: PPO on MiniCatch at 84x84 with 4 stacked
    frames (the Nature torso through env runners), one iteration each of
    IMPALA, APPO, DQN and SAC, and BC fed by ``collect_dataset``."""
    skipped = ["ppo_minicatch_84", "impala", "appo", "dqn", "sac",
               "bc_collect_dataset"]
    if not have_gym:
        return {"gymnasium": False, "skipped": skipped}, {}
    from ray_tpu_torch.rl import (APPOConfig, BCConfig, DQNConfig,
                                  IMPALAConfig, PPOConfig, SACConfig,
                                  collect_dataset)

    res, checks = {"gymnasium": True}, {}

    def finite(m):
        return all(math.isfinite(v) for v in m.values()
                   if isinstance(v, float))

    t = time.perf_counter()
    algo = PPOConfig(device=device).environment(
        "ray_tpu/MiniCatch-v0", size=84).env_runners(
        2, num_envs_per_runner=4).training(
        rollout_length=32, frame_stack=4, seed=0).build()
    try:
        ms = [algo.train() for _ in range(RL["gym_ppo_iters"])]
        ds = collect_dataset(algo, num_rollouts=1)
        on_card = _on(algo.params, device)
    finally:
        algo.stop()
    res["ppo_minicatch_84"] = {"s": time.perf_counter() - t, "metrics": ms}
    checks["ppo_minicatch_84"] = all(finite(m) for m in ms) and on_card
    for name, cfg, kw in (
            ("impala", IMPALAConfig(device=device), {"min_rollouts": 2}),
            ("appo", APPOConfig(device=device), {"min_rollouts": 2}),
            ("dqn", DQNConfig(device=device, learning_starts=32,
                              train_batches_per_iter=4), {}),
            ("sac", SACConfig(device=device, warmup_steps=32,
                              updates_per_iteration=4), {})):
        t = time.perf_counter()
        algo = cfg.build()
        try:
            m = algo.train(**kw)
            tree = algo.actor if name == "sac" else algo.params
            checks[name] = finite(m) and _on(tree, device)
        finally:
            algo.stop()
        res[name] = {"s": time.perf_counter() - t, "metrics": m}
    t = time.perf_counter()
    bc_algo = BCConfig(device=device).environment(
        "ray_tpu/MiniCatch-v0", size=84).training(
        frame_stack=4, epochs=1).build(ds)
    m = bc_algo.train()
    res["bc_collect_dataset"] = {"s": time.perf_counter() - t, "metrics": m,
                                 "rows": ds.count()}
    checks["bc_collect_dataset"] = (m["rows_trained"] > 0
                                    and math.isfinite(m["loss"])
                                    and _on(bc_algo.params, device))
    return res, checks


# ----------------------------------------------------- the distributed plane

# (a): eight caller actors, each sending its requests one after another
# (as a rollout actor steps), all eight at once; the fan-out publishes
# version 2 once the service has served ``flip_after`` requests, and the
# second half of each caller's requests starts after that publish.
RL_DIST = dict(callers=8, requests=50, rows=4, flip_after=100, shards=4,
               T=64, N=4, impala_iters=100, impala_bar=100.0, dqn_iters=3)
RL_DIST_SHAPES = {"mlp": ((4,), 2), "cnn": ((84, 84, 4), 6)}
# The inference services (a) starts, each a fresh GPU process: each shape
# in one mode, so each shape and each mode is served once.
RL_DIST_SERVICES = (("mlp", "categorical"), ("cnn", "epsilon_greedy"))
# The greedy check compares actions where the CPU's top-2 Q margin
# exceeds this (float32 on both sides, TF32 off).
RL_DIST_MARGIN = 1e-4


def _rl_dist_obs(obs_shape, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if len(obs_shape) == 3:
        return rng.integers(0, 256, (rows,) + tuple(obs_shape),
                            dtype=np.uint8)
    return rng.normal(size=(rows,) + tuple(obs_shape)).astype(np.float32)


def _inference_cls():
    """``PolicyInference`` plus the forward's device time (CUDA events
    around each forward, read in the service's process) and float32
    products (TF32 off, as in this process). Defined in a function, so it
    travels to the service's worker by value."""
    from ray_tpu_torch.rl.distributed.inference import PolicyInference

    class SmokeInference(PolicyInference):
        def __init__(self, *args, **kwargs):
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            super().__init__(*args, **kwargs)
            sample, self._events = self._sample_fn, []

            def timed(*a):
                if self.device.type != "cuda":
                    return sample(*a)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = sample(*a)
                end.record()
                self._events.append((start, end))
                return out

            self._sample_fn = timed

        def probe(self) -> dict:
            import os

            import torch

            ms = []
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                ms = [s.elapsed_time(e) for s, e in self._events]
            return {"forward_ms": ms, "device": str(self.device),
                    "pid": os.getpid(),
                    "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    return SmokeInference


class _InferCaller:
    """A CPU actor that sends inference requests one after another, as a
    rollout actor steps."""

    def run(self, svc, obs_shape, seeds, rows):
        import ray_tpu_torch as rt

        out = []
        for seed in seeds:
            obs = _rl_dist_obs(obs_shape, rows, seed)
            t = time.perf_counter()
            action, logp, value, version = rt.get(
                svc.infer.remote((obs, seed)))
            out.append({"seed": seed, "s": time.perf_counter() - t,
                        "version": int(version), "action": action,
                        "logp": logp, "value": value})
        return out


def phase_rl_dist(device="cuda") -> dict:
    """The distributed RL plane with the learner on the card: the policy
    inference service on the card behind eight CPU callers, the learner
    host fed through the object plane and a shard queue, and (with
    gymnasium) the distributed IMPALA and DQN entry points. See the
    module docstring."""
    import importlib.util

    import ray_tpu_torch as rt

    found = importlib.util.find_spec("gymnasium") is not None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _runtime_init(device)
    try:
        return _rl_dist(device, found)
    finally:
        if rt.is_initialized():  # a failure before the phase's teardown
            rt.shutdown()


def _rl_dist(device, found) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker

    cuda = torch.device(device).type == "cuda"
    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    resources = rt.cluster_resources()
    gpus = rt.available_resources().get("GPU")
    checks = {"gpu_resource": resources.get("GPU") == 1.0 and gpus == 1.0}
    out = {"gymnasium": found, "resources": resources}
    reset_counts()
    for key, part in (("a", lambda: _rl_dist_inference(device, gpus)),
                      ("b", lambda: _rl_dist_learner(device)),
                      ("c", lambda: _rl_dist_gym(device, found, gpus))):
        res, part_checks = part()
        out[key] = res
        checks.update({f"{key}_{k}": v for k, v in part_checks.items()})
    launches = launch_counts()
    out["kernel_launches"] = launches
    checks["no_hand_written_kernel_launched"] = not any(launches.values())
    out["gpu_returned"] = _poll_until(
        lambda: rt.available_resources().get("GPU"), lambda v: v == gpus)
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                        lambda v: not v, 15.0)
    checks["teardown_clean"] = (out["gpu_returned"] == gpus
                                and not out["store_file_left"]
                                and not out["processes_left"])
    out["checks"] = checks
    if cuda:
        out["device"] = smi_line()
    out["ok"] = all(checks.values())
    return out


def _rel_diff(got, want) -> float:
    """Elementwise relative difference, its denominator at least
    ``RL_LOSS_FLOOR`` (losses)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), RL_LOSS_FLOOR)).max())


def _rel_to_max(got, want) -> float:
    """max |got - want| over max |want| (a forward's outputs: values near
    zero carry the rounding of sums of O(1) terms)."""
    return _max_rel(torch.as_tensor(np.asarray(got, np.float64)),
                    torch.as_tensor(np.asarray(want, np.float64)))


def _rl_dist_inference(device, gpus):
    """(a) For CartPole's MLP in categorical mode and the Nature torso in
    epsilon-greedy mode (``RL_DIST_SERVICES``): a ``PolicyInference``
    actor holding the ``GPU`` lease, ``RL_DIST["callers"]`` CPU callers,
    version 2 published mid-run (epsilon 0 in the greedy service), every
    reply held against a CPU forward of the version's params."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl.distributed import WeightFanout, new_plane_key
    from ray_tpu_torch.rl.models import build_policy, take_logp

    cuda = torch.device(device).type == "cuda"
    n, rows, flip = (RL_DIST["requests"], RL_DIST["rows"],
                     RL_DIST["flip_after"])
    caller_cls = rt.remote(_InferCaller).options(num_cpus=0.5)
    callers = [caller_cls.remote() for _ in range(RL_DIST["callers"])]
    res, checks = {}, {}
    try:
        for shape, mode in RL_DIST_SERVICES:
            obs_shape, n_actions = RL_DIST_SHAPES[shape]
            init_fn, forward = build_policy(obs_shape, n_actions)
            params = {v: init_fn(torch.Generator().manual_seed(v))
                      for v in (1, 2)}
            name = f"{shape}_{mode}"
            greedy = mode == "epsilon_greedy"
            key = new_plane_key(f"smoke-{name}")
            fan = WeightFanout(key)
            fan.publish(params[1], {"epsilon": 0.5} if greedy else {})
            t = time.perf_counter()
            svc = rt.remote(_inference_cls()).options(
                num_cpus=0, num_gpus=1,
                max_concurrency=RL_DIST["callers"] + 1).remote(
                    obs_shape, n_actions, key, mode, (64, 64), device)
            try:
                probe0 = rt.get(svc.probe.remote(), timeout=300)
                start_s = time.perf_counter() - t
                held = _poll_until(
                    lambda: rt.available_resources().get("GPU"),
                    lambda v: v == gpus - 1)
                halves = [[(c * 1000 + j) for j in range(n)]
                          for c in range(len(callers))]
                t = time.perf_counter()
                first = [c.run.remote(svc, obs_shape, s[:n // 2], rows)
                         for c, s in zip(callers, halves)]
                _poll_until(lambda: rt.get(svc.stats.remote())[
                    "requests"], lambda v: v >= flip, 60.0)
                fan.publish(params[2], {"epsilon": 0.0} if greedy
                            else {})
                replies = rt.get(first, timeout=REQUEST_TIMEOUT_S)
                second = [c.run.remote(svc, obs_shape, s[n // 2:], rows)
                          for c, s in zip(callers, halves)]
                replies = [a + b for a, b in zip(
                    replies, rt.get(second, timeout=REQUEST_TIMEOUT_S))]
                wall = time.perf_counter() - t
                stats = rt.get(svc.stats.remote())
                probe = rt.get(svc.probe.remote())
            finally:
                rt.kill(svc)
                fan.close()
            lat = sorted(r["s"] for rs in replies for r in rs)
            flat = [r for rs in replies for r in rs]
            # The CPU's forward of each version's params on the same
            # rows, in chunks.
            logp_err = value_err = 0.0
            compared = greedy_rows = mismatched = 0
            for v in (1, 2):
                mine = [r for r in flat if r["version"] == v]
                for i in range(0, len(mine), 256):
                    chunk = mine[i:i + 256]
                    obs = torch.from_numpy(np.concatenate(
                        [_rl_dist_obs(obs_shape, rows, r["seed"])
                         for r in chunk]))
                    with torch.no_grad():
                        q, value = forward(params[v], obs)
                    act = torch.from_numpy(np.concatenate(
                        [np.asarray(r["action"]) for r in chunk]))
                    got_v = np.concatenate([r["value"] for r in chunk])
                    got_l = np.concatenate([r["logp"] for r in chunk])
                    if greedy:
                        value_err = max(value_err, _rel_to_max(
                            got_v, q.max(-1).values.numpy()))
                        logp_err = max(logp_err, float(np.abs(
                            got_l).max()))
                        if v == 2:
                            top2 = torch.topk(q, 2).values
                            clear = (top2[:, 0] - top2[:, 1]
                                     ) > RL_DIST_MARGIN
                            greedy_rows += len(act)
                            compared += int(clear.sum())
                            mismatched += int((act[clear] != q.argmax(
                                -1)[clear]).sum())
                    else:
                        value_err = max(value_err, _rel_to_max(
                            got_v, value.numpy()))
                        want_l = take_logp(torch.log_softmax(q, -1),
                                           act)
                        logp_err = max(logp_err, _rel_to_max(
                            got_l, want_l.numpy()))
            versions = [[r["version"] for r in rs] for rs in replies]
            row = {"service_start_s": start_s, "wall_s": wall,
                   "requests": stats["requests"],
                   "forward_calls": stats["forward_calls"],
                   "max_batch": stats["max_batch"],
                   "mean_batch": stats["requests"]
                   / max(1, stats["forward_calls"]),
                   "request_ms_p50": 1e3 * lat[len(lat) // 2],
                   "request_ms_p99": 1e3 * lat[
                       min(len(lat) - 1, int(0.99 * len(lat)))],
                   "replies_v1": sum(v == 1 for vs in versions
                                     for v in vs),
                   "replies_v2": sum(v == 2 for vs in versions
                                     for v in vs),
                   "logp_max_rel_diff": logp_err,
                   "value_max_rel_diff": value_err,
                   "service": {k: probe0[k] for k in
                               ("device", "pid", "cuda_visible")},
                   "gpu_available_while_serving": held}
            if cuda:
                row["forward_ms_median"] = _median(probe["forward_ms"])
                row["forward_ms_max"] = max(probe["forward_ms"])
            if greedy:
                row["greedy_rows"] = greedy_rows
                row["greedy_rows_compared"] = compared
                row["greedy_rows_mismatched"] = mismatched
            res[name] = row
            checks[f"{name}_coalesced"] = (
                stats["max_batch"] >= 2
                and stats["forward_calls"] < stats["requests"]
                == len(flat))
            checks[f"{name}_versions_monotonic"] = all(
                a <= b for vs in versions for a, b in zip(vs, vs[1:]))
            checks[f"{name}_both_versions"] = (
                row["replies_v1"] > 0 and row["replies_v2"] > 0)
            checks[f"{name}_matches_cpu"] = (
                value_err <= RL_LOSS_REL_TOL
                and logp_err <= RL_LOSS_REL_TOL)
            checks[f"{name}_holds_gpu_lease"] = (
                held == gpus - 1 and probe0["pid"] != os.getpid()
                and probe0["device"].startswith(
                    torch.device(device).type))
            if greedy:
                checks[f"{name}_greedy_actions"] = (
                    mismatched == 0 and compared >= greedy_rows // 2)
    finally:
        for c in callers:
            rt.kill(c)
    return res, checks


def _put_rollout(seed: int, index: int, T: int, N: int) -> dict:
    """A CPU task: one seeded CartPole-shaped (T, N) rollout with the
    fields the IMPALA update reads, put into the object store; returns a
    ``collect()``-style descriptor."""
    import ray_tpu_torch as rt

    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.05).astype(np.float32)
    valids = np.ones((T, N), np.float32)
    valids[1:] = 1.0 - dones[:-1]
    ro = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
          "actions": rng.integers(0, 2, (T, N)).astype(np.int64),
          "logp": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32),
          "rewards": valids.copy(), "dones": dones, "valids": valids,
          "last_value": rng.normal(size=(N,)).astype(np.float32),
          "weights_version": 1}
    return {"ref": rt.put(ro), "weights_version": 1,
            "env_steps": int(valids.sum()), "actor_index": index,
            "seq": 1, "episodes": {"episodes": 0}}


def _rl_dist_learner(device):
    """(b) Four CPU tasks' rollouts through the object plane and a
    ``ShardQueue(2)`` into a ``LearnerState`` on the card: four IMPALA
    updates under ``timed_update`` (each between CUDA events), each
    published, against the same four on the CPU."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.rpc_stubs import ControllerStub
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.core.serialization import serialized_size
    from ray_tpu_torch.rl import IMPALAConfig
    from ray_tpu_torch.rl.distributed import (DESCRIPTOR_BYTE_BUDGET,
                                              WEIGHTS_CHANNEL, LearnerState,
                                              ShardQueue, TrajectoryShard,
                                              new_plane_key, plane_stats)
    from ray_tpu_torch.rl.distributed.learner import RL_DESC_BYTES
    from ray_tpu_torch.rl.impala import make_impala_update
    from ray_tpu_torch.rl.models import build_policy
    from ray_tpu_torch.rl.tree import (adam, batch_to, clone, to_device,
                                       tree_leaves)

    cuda = torch.device(device).type == "cuda"
    cfg = IMPALAConfig(device=device)
    init_fn, forward = build_policy((4,), 2, cfg.hidden)
    p0 = init_fn(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", device):
        params = to_device(clone(p0), dev)
        opt = adam(cfg.lr)
        runs[dev] = {"params": params, "opt": opt,
                     "state": opt.init(params),
                     "update": make_impala_update(forward, opt, cfg),
                     "losses": []}
    key = new_plane_key("smoke-learner")
    state = LearnerState(key, device)
    state.publish(runs[device]["params"], version=1)
    put = rt.remote(_put_rollout).options(num_cpus=1)
    n = RL_DIST["shards"]
    descs = rt.get([put.remote(100 + i, i, RL_DIST["T"], RL_DIST["N"])
                    for i in range(n)], timeout=120)
    sizes = [serialized_size(d) for d in descs]
    shards = [TrajectoryShard(ref=d["ref"], weights_version=1,
                              env_steps=d["env_steps"], actor_index=i,
                              seq=d["seq"], desc_bytes=b,
                              episodes=d["episodes"])
              for i, (d, b) in enumerate(zip(descs, sizes))]
    for b in sizes:
        RL_DESC_BYTES.observe(b, {"plane": key})
    queue = ShardQueue(2)
    pending = list(shards)
    queued = [queue.put(pending.pop(0), timeout=0.1) for _ in range(2)]
    t = time.perf_counter()
    full_put = queue.put(pending[0], timeout=0.2)
    full_wait = time.perf_counter() - t
    events: list = []
    updates = 0
    while updates < n:
        shard = queue.get(timeout=10.0)
        if pending:
            queue.put(pending.pop(0), timeout=0.1)
        ro = rt.get(shard.ref)
        state.record_staleness(shard)
        keys = ("obs", "actions", "logp", "rewards", "dones", "valids",
                "last_value")
        for dev, run in runs.items():
            batch = (state.shard_batch({k: ro[k] for k in keys})
                     if dev == device else
                     batch_to({k: ro[k] for k in keys}, "cpu"))

            def step(run=run, batch=batch):
                return run["update"](run["params"], run["state"], batch)

            if dev == device:
                run["params"], run["state"], aux = state.timed_update(
                    _timed_calls(step, events, cuda))
            else:
                run["params"], run["state"], aux = step()
            run["losses"].append(float(aux["total_loss"]))
        updates += 1
        state.publish(runs[device]["params"], version=updates + 1)
    stats = plane_stats(key, queue)
    version = state.version
    dl, cl = runs[device]["losses"], runs["cpu"]["losses"]
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(runs[device]["params"]),
        tree_leaves(runs["cpu"]["params"])))
    bound = RL_ADAM_BOUND * cfg.lr * n
    state.close()
    snap = ControllerStub(get_core_worker().controller).psub_snapshot(
        WEIGHTS_CHANNEL)
    res = {"descriptor_bytes": sizes, "full_put_wait_s": full_wait,
           "losses": dl, "cpu_losses": cl,
           "loss_max_rel_diff": _rel_diff(dl, cl),
           "param_max_abs_diff": diff, "param_bound": bound,
           "fanout_version": version, "plane_stats": stats}
    if cuda:
        res["update_ms"] = _event_ms(events)
    checks = {
        "descriptors_under_budget": max(sizes) <= DESCRIPTOR_BYTE_BUDGET,
        "queue_full_put_timed_out": all(queued) and not full_put,
        "plane_stats_fields": all(k in stats for k in (
            "staleness", "learner_update_s", "shard_desc_bytes",
            "env_steps")) and stats["shards"] == n,
        "losses_match_cpu": res["loss_max_rel_diff"] <= RL_LOSS_REL_TOL,
        "params_match_cpu": diff <= bound,
        "params_on_device": _on(runs[device]["params"], device),
        "fanout_version_5": version == n + 1,
        "hub_key_gone_after_close": key not in snap,
    }
    return res, checks


def _rl_dist_gym(device, have_gym: bool, gpus):
    """(c) With gymnasium: ``IMPALAConfig().distributed_rollouts(4, ...)``
    to the reference's bar, and ``DistributedDQN`` in inference mode for
    ``RL_DIST["dqn_iters"]`` iterations."""
    skipped = ["impala_distributed_to_100", "dqn_inference_mode"]
    if not have_gym:
        return {"gymnasium": False, "skipped": skipped}, {}
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import DQNConfig, IMPALAConfig
    from ray_tpu_torch.rl.distributed import DESCRIPTOR_BYTE_BUDGET

    res, checks = {"gymnasium": True}, {}
    t = time.perf_counter()
    algo = IMPALAConfig().environment("CartPole-v1").distributed_rollouts(
        4, num_envs_per_actor=4).training(
        rollout_length=64, entropy_coeff=0.01, seed=1,
        device=device).build()
    best, rows = 0.0, []
    try:
        for _ in range(RL_DIST["impala_iters"]):
            m = algo.train(min_rollouts=4)
            best = max(best, m.get("episode_return_mean", 0.0))
            rows.append({"iter": m["training_iteration"],
                         "return": m.get("episode_return_mean"),
                         "lag": m["mean_policy_lag"],
                         "env_steps_per_s": m["env_steps_per_sec"]})
            if best >= RL_DIST["impala_bar"]:
                break
        violations = algo.plane.monotonic_violations
        desc_p99 = m["rl"]["shard_desc_bytes"]["p99"]
        on_card = _on(algo.params, device)
    finally:
        algo.stop()
    report = algo.last_leak_report
    res["impala"] = {"s": time.perf_counter() - t, "best": best,
                     "iterations": len(rows), "log": rows,
                     "desc_p99": desc_p99, "leak_report": report}
    checks["impala_reaches_bar"] = best >= RL_DIST["impala_bar"]
    checks["impala_monotonic"] = violations == 0
    checks["impala_descriptors_in_budget"] = desc_p99 <= \
        DESCRIPTOR_BYTE_BUDGET
    checks["impala_params_on_device"] = on_card
    checks["impala_leak_report"] = (report["queue_depth"] == 0
                                    and report["intake_alive"] is False)
    t = time.perf_counter()
    algo = DQNConfig(device=device).environment(
        "CartPole-v1").distributed_rollouts(
        3, num_envs_per_actor=2, mode="inference").training(
        rollout_length=8, learning_starts=32, batch_size=32,
        train_batches_per_iter=2).build()
    try:
        ms = [algo.train() for _ in range(RL_DIST["dqn_iters"])]
        stats = rt.get(algo.plane.inference.stats.remote())
        held = rt.available_resources().get("GPU")
    finally:
        algo.stop()
    report = algo.last_leak_report
    back = _poll_until(lambda: rt.available_resources().get("GPU"),
                       lambda v: v == gpus)
    res["dqn"] = {"s": time.perf_counter() - t, "inference": stats,
                  "leak_report": report,
                  "metrics": [{k: v for k, v in m.items() if k != "rl"}
                              for m in ms]}
    checks["dqn_ran"] = all(m["env_steps_this_iter"] > 0 for m in ms)
    checks["dqn_inference_coalesced"] = (
        stats["requests"] > 0
        and stats["forward_calls"] <= stats["requests"])
    checks["dqn_leak_report"] = (report["queue_depth"] == 0
                                 and report["intake_alive"] is False)
    cuda = torch.device(device).type == "cuda"
    checks["dqn_gpu_lease_held_then_back"] = (
        back == gpus and (held == gpus - 1 or not cuda))
    return res, checks


# ----------------------------------------------------------------- mesh

# Mesh step against the mesh-less step on one card, bf16 compute: losses
# and gradient norms of the same two steps from the same weights and
# batches, relative. At world size 1 the DTensor step runs the same local
# products in the same order, so the numbers agree to the last bit; 1e-6
# leaves room for one rounding and still catches a step that drops one of
# its two microbatches (its loss is then the mean over other tokens) or
# scales the accumulated gradient by a factor off 1 by more than 1e-6.
MESH_REL_TOL = 1e-6
# The ring (1-rank, in the path and again timed), the loopback ring (4
# virtual shards, each hop's bf16 partial output merged in fp32) and
# Ulysses against the plain flash forward and backward, and the loopback
# against one full flash call, bf16: max |error| relative to max |value|
# for out, dq, dk and dv.
RING_BF16_TOL = 2e-2
# The 1B MoE model's depth cut for the mesh phase (see MOE_* below).
MOE_LAYERS = 4


def _mesh_train_run(cfg, variant, device, tokens, steps, accum_steps, mesh):
    """``steps`` AdamW(3e-4, wd 0.1) steps of ``cfg`` from seed-0 fp32
    masters on ``tokens``: mesh-less (``"plain"``), through
    ``build_train_step(mesh=...)`` (``"mesh"``) or through
    ``build_zero1_train_step`` (``"zero1"``); per-step losses, grad norms,
    times after a sync, launches, peak memory."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step as ts

    cuda = torch.device(device).type == "cuda"
    opt = adamw(3e-4, weight_decay=0.1)
    lf = lambda p, b: llama.loss_fn(p, b, cfg)  # noqa: E731
    init = lambda seed: llama.init_params(  # noqa: E731
        cfg, device=device, dtype=torch.float32, seed=seed)
    if variant == "plain":
        params = init(0)
        state = ts.init_optimizer_state(opt, params)
        step = ts.build_train_step(lf, opt, accum_steps=accum_steps)
        batch = {"tokens": tokens}
    elif variant == "mesh":
        params = ts.init_sharded_params(init, llama.param_axes(cfg), mesh, 0)
        state = ts.init_optimizer_state(opt, params)
        step = ts.build_train_step(lf, opt, mesh, accum_steps=accum_steps)
        batch = ts.shard_batch({"tokens": tokens}, mesh)
    else:
        params = init(0)
        state = ts.init_zero1_opt_state(opt, params, mesh)
        step = ts.build_zero1_train_step(lf, opt, mesh, params,
                                         accum_steps=accum_steps)
        batch = ts.shard_batch({"tokens": tokens}, mesh)
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "step_s": [],
           "launches_per_step": []}
    for _ in range(steps):
        before = launch_counts()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        _sync(device)
        out["step_s"].append(time.perf_counter() - t)
        now = launch_counts()
        out["launches_per_step"].append(
            {k: now[k] - before[k] for k in now})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    if variant != "plain":
        out["state_bytes_per_rank"] = ts.per_replica_state_bytes(state)
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        tok = tokens.shape[0] * (tokens.shape[1] - 1)
        last = out["step_s"][-1]
        out["tokens_per_s"] = tok / last
    del params, state, step, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _ring_inputs(shape, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    b, s, h, hkv, d = (shape[k] for k in ("b", "s", "h", "hkv", "d"))
    dt = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    mk = lambda *sh: torch.randn(sh, generator=g, device=device,  # noqa
                                 dtype=torch.float32).to(dt)
    return mk(b, s, h, d), mk(b, s, hkv, d), mk(b, s, hkv, d), mk(b, s, h, d)


def _with_grads(fn, q, k, v, do):
    """``fn(q, k, v)``'s output and the q/k/v gradients of sum(out * do)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(do)
    return [out.detach(), q.grad, k.grad, v.grad]


def _loopback_ring(q, k, v, n):
    """The package's ``ring_flash_attention_local`` run for each of ``n``
    virtual ranks in one process, K/V rotated by indexing (its ``ring``
    argument) instead of collectives. Returns the full (B, S, H, D)
    output."""
    import torch.nn.functional as F

    from ray_tpu_torch.parallel.ring_attention import (
        ring_flash_attention_local)

    sl = q.shape[1] // n
    pad = (-q.shape[-1]) % 128
    shard = lambda t, r: t[:, r * sl:(r + 1) * sl]  # noqa: E731

    def ring_of(rank):
        src = [rank]

        def rotate_fn(kv):
            src[0] = (src[0] - 1) % n
            kv = torch.stack([shard(k, src[0]), shard(v, src[0])])
            return F.pad(kv, (0, pad)).transpose(2, 3)

        return rank, n, rotate_fn

    return torch.cat([ring_flash_attention_local(
        shard(q, r), shard(k, r), shard(v, r), None, ring=ring_of(r))
        for r in range(n)], dim=1)


def _plain_attention(q, k, v, do):
    """[out, dq, dk, dv] of causal attention by the plain flash forward and
    backward (``flash_attention_reference``, ``flash_backward_reference``)."""
    from ray_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention_reference(q, k, v, causal=True)
    return [out, *fa.flash_backward_reference(q, k, v, out, lse, do,
                                              causal=True)]


def _errs(got, want) -> dict:
    return {n: _rel_err(g, w) for n, g, w in
            zip(("out", "dq", "dk", "dv"), got, want)}


def _ring_checks(q, k, v, do, mesh, n_virtual, plain) -> dict:
    """(a) ``ring_attention(impl="flash")`` on the 1-rank mesh and (b) the
    loopback ring of ``n_virtual`` shards, forward and backward, each
    against ``plain`` (``_plain_attention`` on the same inputs); the
    loopback also against one full ``flash_attention`` call; with the
    launches of each and their times."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    cuda = q.is_cuda
    full = lambda q_, k_, v_: flash_attention(q_, k_, v_)  # noqa: E731
    ring = lambda q_, k_, v_: ring_attention(  # noqa: E731
        q_, k_, v_, mesh, impl="flash")
    loop = lambda q_, k_, v_: _loopback_ring(q_, k_, v_, n_virtual)  # noqa
    flash = _with_grads(full, q, k, v, do)
    res = {"full_flash_rel_err_vs_plain": _errs(flash, plain)}
    for name, fn in (("ring_1rank", ring), ("loopback", loop)):
        before = launch_counts()
        fwd0, bwd0 = fwd_kernel_counts(q.device), bwd_kernel_counts(q.device)
        got = _with_grads(fn, q, k, v, do)
        _sync(q.device)
        now = launch_counts()
        res[name] = {"rel_err_vs_plain": _errs(got, plain),
                     "launches": {k_: now[k_] - before[k_] for k_ in now},
                     "fwd_by_kernel": fwd_kernels_since(fwd0, q.device),
                     "bwd_by_kernel": bwd_kernels_since(bwd0, q.device)}
        if name == "loopback":
            res[name]["rel_err_vs_flash"] = _errs(got, flash)
        if cuda:
            res[name]["fwd_bwd_ms"] = _time_ms(
                lambda: _with_grads(fn, q, k, v, do), 3, 1)
    if cuda:
        res["full_flash_fwd_bwd_ms"] = _time_ms(
            lambda: _with_grads(full, q, k, v, do), 3, 1)
    return res


def phase_mesh(cfg, device="cuda", batch=8, seq=2048, steps=2,
               accum_steps=2, ring_shape=None, moe_seq=2048,
               moe_steps=3) -> dict:
    """The mesh plane on one card: a process group of one rank (NCCL, or
    gloo on the CPU), ``cfg`` trained through the mesh step on
    ``MeshSpec(fsdp=-1)`` and through ZeRO-1 against the mesh-less step,
    ``ring_attention(impl="flash")`` and ``ulysses_attention`` on the
    1-rank mesh, and the MoE model at ``cfg``'s width cut to
    ``MOE_LAYERS`` layers on an ``expert`` mesh of one; then the
    comparisons: the ring, Ulysses and a loopback ring of 4 virtual
    shards against the plain flash forward and backward, and the loopback
    against one full flash call."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    cuda = torch.device(device).type == "cuda"
    dtype_name = "cuda" if cuda else "cpu"
    ring_shape = ring_shape or dict(b=1, s=8192, h=cfg.n_heads,
                                    hkv=cfg.n_kv_heads, d=cfg.head_dim)
    mesh = MeshSpec(fsdp=-1).build(device_type=dtype_name)
    g = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g,
                           device=device)
    per_step = {"flash_fwd": 2 * cfg.n_layers * accum_steps,
                "flash_bwd_dkv": cfg.n_layers * accum_steps,
                "flash_bwd_dq": cfg.n_layers * accum_steps,
                "attention_delta": cfg.n_layers * accum_steps}
    want_step = {**{k: 0 for k in KERNELS}, **per_step}
    runs = {"plain": _mesh_train_run(cfg, "plain", device, tokens, steps,
                                     accum_steps, mesh)}
    q, k, v, do = _ring_inputs(ring_shape, device)

    # The main path: counts zeroed right before, read right after.
    reset_counts()
    fwd0, bwd0 = fwd_kernel_counts(device), bwd_kernel_counts(device)
    for variant in ("mesh", "zero1"):
        runs[variant] = _mesh_train_run(cfg, variant, device, tokens, steps,
                                        accum_steps, mesh)
    ring_out = _with_grads(lambda *a: ring_attention(*a, mesh, impl="flash"),
                           q, k, v, do)
    uly_out = ulysses_attention(q, k, v, mesh, impl="flash")
    moe_cfg = replace(cfg, n_layers=MOE_LAYERS, moe_experts=8, moe_top_k=2,
                      moe_capacity_factor=1.25)
    moe_mesh = MeshSpec(expert=-1, fsdp=1).build(device_type=dtype_name)
    moe_params = ts.init_sharded_params(
        lambda seed: llama.init_params(moe_cfg, device=device,
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(moe_cfg), moe_mesh, 1)
    opt = adamw(3e-4, weight_decay=0.1)
    moe_state = ts.init_optimizer_state(opt, moe_params)

    def aux_metric(p, b):
        _, aux = llama.hidden_states_aux(p, b["tokens"][:, :-1], moe_cfg)
        return {"aux": ts._full(aux)}

    moe_step = ts.build_train_step(lambda p, b: llama.loss_fn(p, b, moe_cfg),
                                   opt, moe_mesh, extra_metrics=aux_metric)
    moe_batch = ts.shard_batch({"tokens": tokens[:1, :moe_seq + 1]},
                               moe_mesh)
    moe = {"losses": [], "aux": [], "step_s": []}
    for _ in range(moe_steps):
        t = time.perf_counter()
        moe_params, moe_state, m = moe_step(moe_params, moe_state, moe_batch)
        _sync(device)
        moe["step_s"].append(time.perf_counter() - t)
        moe["losses"].append(float(m["loss"]))
        moe["aux"].append(float(m["aux"]))
    del moe_params, moe_state, moe_step
    _sync(device)
    launches = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    bwd_by_kernel = bwd_kernels_since(bwd0, device)

    # The comparisons (their launches are not the path's), against the
    # plain forward and backward at the ring's shape.
    plain_attn = _plain_attention(q, k, v, do)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ring = _ring_checks(q, k, v, do, mesh, 4, plain_attn)
    uly_err = _rel_err(uly_out, plain_attn[0])
    ring_err = _errs(ring_out, plain_attn)
    del q, k, v, do, ring_out, uly_out, plain_attn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    plain, mesh_r, z1 = runs["plain"], runs["mesh"], runs["zero1"]
    rel = lambda a, b: max(abs(x - y) / max(abs(y), 1e-30)  # noqa: E731
                           for x, y in zip(a, b))
    n_virtual = 4
    live = n_virtual * (n_virtual + 1) // 2    # diagonal + visible hops
    loop_want = {**{k_: 0 for k_ in KERNELS}, "flash_fwd": live,
                 "flash_bwd_dkv": live, "flash_bwd_dq": live,
                 "attention_delta": live}
    ring1_want = {**{k_: 0 for k_ in KERNELS}, "flash_fwd": 1,
                  "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
                  "attention_delta": 1}
    # The path: the mesh and ZeRO-1 steps, the ring's forward and
    # backward, Ulysses' forward, and per MoE step each layer's forward,
    # remat recompute and aux-metric forward, backward and delta.
    moe_want = {k_: moe_steps * MOE_LAYERS * (3 if k_ == "flash_fwd"
                                              else 1 if k_ in per_step
                                              else 0) for k_ in KERNELS}
    path_want = {k_: 2 * steps * want_step[k_] + ring1_want[k_]
                 + (k_ == "flash_fwd") + moe_want[k_] for k_ in KERNELS}
    out = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "config": {"preset_width": {"dim": cfg.dim,
                                       "n_layers": cfg.n_layers,
                                       "n_heads": cfg.n_heads,
                                       "n_kv_heads": cfg.n_kv_heads,
                                       "mlp_dim": cfg.mlp_dim},
                      "batch": batch, "seq": seq,
                      "accum_steps": accum_steps, "steps": steps,
                      "ring_shape": ring_shape,
                      "moe": {"n_layers": MOE_LAYERS, "experts": 8,
                              "top_k": 2, "capacity_factor": 1.25,
                              "batch": 1, "seq": moe_seq,
                              "cut": "depth 22 -> 4 layers"}},
           "train": runs, "moe": moe, "ring": ring,
           "ring_1rank_in_path_rel_err_vs_plain": ring_err,
           "ulysses_rel_err_vs_plain": uly_err,
           "launches": launches, "launches_want": path_want,
           "flash_fwd_by_kernel": by_kernel,
           "flash_bwd_by_kernel": bwd_by_kernel,
           "tol": {"mesh_rel": MESH_REL_TOL, "ring_bf16": RING_BF16_TOL}}
    ring_tol = RING_BF16_TOL if cuda else 1e-5
    checks = {
        "world_size_1": out["world_size"] == 1,
        "backend": out["backend"] == ("nccl" if cuda else "gloo"),
        "mesh_losses_match_plain": rel(mesh_r["losses"], plain["losses"])
        <= MESH_REL_TOL,
        "mesh_grad_norms_match_plain": rel(mesh_r["grad_norms"],
                                           plain["grad_norms"])
        <= MESH_REL_TOL,
        "zero1_losses_match_plain": rel(z1["losses"], plain["losses"])
        <= MESH_REL_TOL,
        "zero1_grad_norms_match_plain": rel(z1["grad_norms"],
                                            plain["grad_norms"])
        <= MESH_REL_TOL,
        "mesh_launches_per_step_exact": all(
            c == want_step for r in (mesh_r, z1)
            for c in r["launches_per_step"]),
        "ring_1rank_in_path_matches_plain": max(ring_err.values())
        <= ring_tol,
        "ring_1rank_matches_plain": max(
            ring["ring_1rank"]["rel_err_vs_plain"].values()) <= ring_tol,
        "ring_1rank_launches": ring["ring_1rank"]["launches"] == ring1_want,
        "loopback_matches_plain": max(
            ring["loopback"]["rel_err_vs_plain"].values()) <= ring_tol,
        "loopback_matches_flash": max(
            ring["loopback"]["rel_err_vs_flash"].values()) <= ring_tol,
        "loopback_launches_skip_dead_hops":
            ring["loopback"]["launches"] == loop_want,
        "ulysses_matches_plain": uly_err <= ring_tol,
        "moe_finite": all(math.isfinite(x)
                          for x in moe["losses"] + moe["aux"]),
        "moe_loss_falls": moe["losses"][-1] < moe["losses"][0],
        "path_launches_exact": launches == path_want,
        "flash_fwd_on_wgmma": all_on_wgmma(by_kernel, launches["flash_fwd"],
                                           device),
        "flash_bwd_on_wgmma": all_bwd_on_wgmma(
            bwd_by_kernel, launches["flash_bwd_dkv"],
            launches["flash_bwd_dq"], device),
        "loopback_on_wgmma": all_on_wgmma(
            ring["loopback"]["fwd_by_kernel"], live, device)
        and all_bwd_on_wgmma(ring["loopback"]["bwd_by_kernel"], live, live,
                             device),
    }
    if cuda:
        out["device"] = smi_line()
        for r in runs.values():
            r["steady_step_s"] = r["step_s"][-1]
    out["checks"] = checks
    out["ok"] = all(checks.values())
    dist.destroy_process_group()
    return out


# ----------------------------------------------------------- the runtime

# The object store's size on the card's host: room for the handoff's
# concurrent payloads (805 MB for a 1500-token 7B prompt) and the 1 GiB
# put below. A CPU rehearsal takes a small one.
STORE_BYTES = {"cuda": 8 << 30, "cpu": 1 << 30}
RUNTIME_ROUND_TRIPS = 200
PUT_BYTES = {"cuda": 1 << 30, "cpu": 64 << 20}     # bf16 tensor put / get
ARG_BYTES = {"cuda": 256 << 20, "cpu": 16 << 20}   # tensor task argument


def _store_config(device, sizes=STORE_BYTES, stores: int = 1) -> dict:
    """The runtime's store size (each of ``stores`` nodes'), and its
    directory: ``/dev/shm`` when it has room for every store, else the
    temp directory (a store file past a full tmpfs would fault on
    write)."""
    import shutil
    import tempfile

    want = sizes[torch.device(device).type]
    cfg = {"object_store_memory_bytes": want}
    try:
        free = shutil.disk_usage("/dev/shm").free
    except OSError:
        free = 0
    if free < stores * want * 5 // 4:
        cfg["object_store_fallback_dir"] = tempfile.gettempdir()
    return cfg


def _runtime_init(device):
    """``rt.init()`` as a user calls it on this host, with the store sized
    for the phase; off the card the node is told of one GPU so the GPU
    lease path still runs."""
    import ray_tpu_torch as rt

    kw = {"_system_config": _store_config(device)}
    if torch.device(device).type != "cuda":
        kw["resources"] = {"GPU": 1}
    return rt.init(**kw)


def _live_objects() -> int:
    """Objects the driver's store holds a value for (a freed object
    leaves a tombstone, not a value)."""
    from ray_tpu_torch.core.runtime import get_core_worker

    store = get_core_worker().store
    with store._lock:
        return sum(1 for e in store._entries.values() if not e.freed
                   and (e.data is not None or e.shm_ref is not None))


def _median(xs):
    """The upper median (None for no values)."""
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _median_rate(samples) -> float:
    """Median GB/s of (bytes, seconds) samples (None without any)."""
    return _median(b / t / 1e9 for b, t in samples if t > 0)


def _noop():
    return None


def _tensor_bytes(t):
    return t.numel() * t.element_size()


class _Pinger:
    def ping(self):
        return None


def _median_ms(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * _median(times)


def _runtime_rates(device) -> dict:
    """Host latency of a noop task and of an actor method round trip
    (median of ``RUNTIME_ROUND_TRIPS`` after a warm-up), and the store's
    rates: put and get of a bf16 tensor on the card (staged to the host
    on put; the get is a view of the store's mapping, then copied back to
    the card), and a tensor passed as a task argument (median of 3)."""
    import ray_tpu_torch as rt

    kind = torch.device(device).type
    noop = rt.remote(_noop)
    pinger = rt.remote(_Pinger).remote()
    for _ in range(10):
        rt.get([noop.remote(), pinger.ping.remote()])
    out = {"noop_task_ms": _median_ms(lambda: rt.get(noop.remote()),
                                      RUNTIME_ROUND_TRIPS),
           "actor_call_ms": _median_ms(lambda: rt.get(
               pinger.ping.remote()), RUNTIME_ROUND_TRIPS)}
    rt.kill(pinger)
    g = torch.Generator(device=device).manual_seed(0)
    n = PUT_BYTES[kind]
    big = torch.randn(n // 2, generator=g, device=device,
                      dtype=torch.float32).to(torch.bfloat16)
    put_s, get_s, back_s, ok = [], [], [], True
    for _ in range(3):
        _sync(device)
        t = time.perf_counter()
        ref = rt.put(big)
        put_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        got = rt.get(ref)
        get_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        dev_copy = got.to(device)
        _sync(device)
        back_s.append(time.perf_counter() - t)
        ok = ok and got.device.type == "cpu" and torch.equal(dev_copy, big)
        del got, dev_copy
        rt.free(ref)
    arg = big[: ARG_BYTES[kind] // 2]
    sized = rt.remote(_tensor_bytes)
    arg_s, arg_ok = [], True
    for _ in range(3):
        t = time.perf_counter()
        arg_ok = arg_ok and rt.get(sized.remote(arg)) == arg.nbytes
        arg_s.append(time.perf_counter() - t)
    out.update({
        "put_bytes": n, "put_gb_s": n / _median(put_s) / 1e9,
        "get_view_gb_s": n / _median(get_s) / 1e9,
        "get_to_card_gb_s": n / (_median(get_s) + _median(back_s)) / 1e9,
        "put_get_equal": ok,
        "task_arg_bytes": arg.nbytes,
        "task_arg_gb_s": arg.nbytes / _median(arg_s) / 1e9,
        "task_arg_ok": arg_ok})
    del big, arg
    return out


def _replica_cls():
    """The 7B deployment the phase serves: ``LlamaDecodeDeployment`` plus
    one method that reads, in the replica's own process, the flash
    forward's launch counts, the engine's full prefill waves and where it
    runs. Defined in a function, so it travels to the replica by value."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    class SmokeReplica(LlamaDecodeDeployment):
        def flash_window(self, reset: bool = False) -> dict:
            import os

            from ray_tpu_torch.ops import flash_attention as fa

            card = self.engine.device.type == "cuda"
            out = {"launches": fa.flash_attention.launches,
                   "by_kernel": fa.forward_kernel_launches() if card
                   else {},
                   "prefill_waves": self.engine.stats()["prefill_waves"],
                   "device": str(self.engine.device), "pid": os.getpid(),
                   "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "card": torch.cuda.get_device_name(0) if card else None}
            if reset:
                fa.flash_attention.launches = 0
            return out

    return SmokeReplica


def _http_stream(addr, route, req, timeout):
    """POST a streaming request: (tokens, seconds to the first chunk,
    seconds to the end)."""
    import http.client

    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    t = time.perf_counter()
    try:
        conn.request("POST", f"/{route}", body=json.dumps(
            {**req, "stream": True}), headers={"X-Serve-Stream": "1"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:200]}")
        toks, first, buf = [], None, b""
        while True:
            chunk = resp.read1(65536) if hasattr(resp, "read1") \
                else resp.read(1)
            if not chunk:
                break
            if first is None:
                first = time.perf_counter() - t
            buf += chunk
            *lines, buf = buf.split(b"\n")
            toks += [json.loads(x) for x in lines if x.strip()]
        if buf.strip():
            toks.append(json.loads(buf))
        return toks, first, time.perf_counter() - t
    finally:
        conn.close()


def _live_node_pids(node_hex: str) -> list:
    """Pids of processes whose command line names this node (its
    forkserver and workers)."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if node_hex.encode() in f.read():
                    pids.append(int(pid))
        except OSError:
            continue
    return pids


def phase_serve_runtime(cfg, device="cuda") -> dict:
    """Llama-2-7B served the way a user serves it: ``rt.init()``, then
    ``serve.run`` of a ``LlamaDecodeDeployment`` subclass holding the
    ``GPU`` lease in a replica actor (its own process), reached through
    ``handle.remote``, ``handle.stream`` and the HTTP proxy. See the module
    docstring."""
    import ray_tpu_torch as rt

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _runtime_init(device)
    init_s = time.perf_counter() - t0
    try:
        return _serve_runtime(cfg, device, init_s)
    finally:
        if rt.is_initialized():  # a failure before the phase's teardown
            from ray_tpu_torch import serve

            try:
                serve.shutdown()
            finally:
                rt.shutdown()


def _serve_runtime(cfg, device, init_s) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    out = {"init_s": init_s, "resources": rt.cluster_resources(),
           "runtime": _runtime_rates(device)}
    checks = {"gpu_resource": out["resources"].get("GPU") == 1.0,
              "store_round_trip": out["runtime"]["put_get_equal"]
              and out["runtime"]["task_arg_ok"]}
    geo = dict(config=cfg, slots=4, capacity=2048, seed=0)
    t = time.perf_counter()
    serve.run(serve.deployment(_replica_cls()).options(
        ray_actor_options={"num_gpus": 1}, max_concurrency=8).bind(
            **geo, device=device), name="llm", ready_timeout_s=900.0)
    out["serve_run_s"] = time.perf_counter() - t
    h = serve.get_deployment_handle("llm")
    window = h.options(method_name="flash_window", timeout_s=900.0)
    # The first reply comes once the replica's constructor (the 7B
    # weights, the engine) has run: that is the replica's start.
    w0 = window.remote(True).result(timeout=900)
    out["replica_start_s"] = time.perf_counter() - t
    addr = serve.start_http()
    plan = _serve_plan(cfg)
    out["replica"] = {k: w0[k] for k in ("device", "pid", "cuda_visible",
                                         "card")}
    kind = torch.device(device).type
    checks["replica_on_card"] = (
        w0["pid"] != os.getpid() and w0["device"].startswith(kind)
        and w0["cuda_visible"] != "" and (kind != "cuda" or bool(w0["card"])))
    # One at a time: each prompt through the handle, the handle's stream
    # and HTTP, in this order; the solo engine below replays the order.
    order = [(path, name) for path in ("handle", "stream", "http")
             for name in plan]
    got, client = {}, {}
    t_seq = time.perf_counter()
    for path, name in order:
        toks, n, _ = plan[name]
        req = {"tokens": toks, "max_new_tokens": n}
        t = time.perf_counter()
        if path == "handle":
            reply = h.remote(req).result(timeout=REQUEST_TIMEOUT_S)
            got[path, name] = reply["tokens"]
            client[path, name] = reply["ttft_s"]
        elif path == "stream":
            stream, first = [], None
            for tok in h.stream({**req, "stream": True}):
                if first is None:
                    first = time.perf_counter() - t
                stream.append(tok)
            got[path, name], client[path, name] = stream, first
        else:
            got[path, name], client[path, name], _ = _http_stream(
                addr, "llm", req, REQUEST_TIMEOUT_S)
    out["sequential_s"] = time.perf_counter() - t_seq
    # The burst: all six at once over HTTP.
    burst, errors = {}, {}

    def fire(name):
        toks, n, _ = plan[name]
        try:
            burst[name] = _http_stream(addr, "llm", {
                "tokens": toks, "max_new_tokens": n}, REQUEST_TIMEOUT_S)
        except Exception as e:  # reported as a failed check below
            errors[name] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=fire, args=(n,)) for n in plan]
    t_burst = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(REQUEST_TIMEOUT_S)
    burst_s = time.perf_counter() - t_burst
    w1 = window.remote(False).result(timeout=60)
    launches = w1["launches"]
    waves = w1["prefill_waves"] - w0["prefill_waves"]
    by_kernel = {k: n - w0["by_kernel"].get(k, 0)
                 for k, n in w1["by_kernel"].items()}
    out.update({"launches": {"flash_fwd": launches},
                "flash_fwd_by_kernel": by_kernel,
                "replica_full_prefill_waves": waves})
    checks["flash_launches_32_per_full_wave"] = (
        waves > 0 and launches == cfg.n_layers * waves)
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel, launches, device)
    checks["burst_complete"] = (not errors and set(burst) == set(plan)
                                and all(len(burst[n][0]) == plan[n][1]
                                        for n in plan))
    ttft = sorted(b[1] for b in burst.values())
    tokens = sum(len(b[0]) for b in burst.values())
    out["burst"] = {"wall_s": burst_s, "tokens": tokens,
                    "tokens_per_s": tokens / burst_s,
                    "client_ttft_p50_s": ttft[len(ttft) // 2]
                    if ttft else None,
                    "client_ttft_p99_s": ttft[-1] if ttft else None,
                    "errors": errors}
    out["client_ttft_s"] = {f"{p}/{n}": v for (p, n), v in client.items()}
    want = len(order) + len(plan)
    summary = _poll_until(lambda: serve.status()["llm"].get("slo", {}),
                        lambda v: v.get("ttft_s", {}).get("count") == want)
    out["replica_slo"] = slo_line(summary)
    checks["replica_slo_counts"] = (
        summary.get("outcomes", {}).get("completed") == want)
    # The CLI and the dashboard against the live cluster.
    cli, cli_checks = _serve_cli(core.controller_addr, "llm", want)
    out["cli"] = cli
    checks.update(cli_checks)
    # The solo in-process engine on the same seed and config, replaying
    # the sequential order one request at a time.
    t_solo = time.perf_counter()
    solo = LlamaDecodeDeployment(**geo, device=device)
    try:
        for path, name in order:
            toks, n, _ = plan[name]
            req = {"tokens": toks, "max_new_tokens": n}
            want_toks = (solo(req)["tokens"] if path == "handle"
                         else list(solo.stream({**req, "stream": True})))
            if got[path, name] != want_toks:
                out.setdefault("mismatch", []).append(
                    {"path": path, "request": name,
                     "first_difference": _first_difference(
                         {name: got[path, name]}, {name: want_toks})[name]})
    finally:
        solo.shutdown()
        del solo
        gc.collect()
    out["solo_replay_s"] = time.perf_counter() - t_solo
    checks["streams_equal_solo_engine"] = "mismatch" not in out
    # The gang phase's member replays these, on a fresh engine, in order.
    out["handle_streams"] = {name: got["handle", name] for name in plan}
    checks["token_counts"] = all(len(got[k]) == plan[k[1]][1]
                                 for k in order)
    t_down = time.perf_counter()
    serve.shutdown()
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                      lambda v: not v, 15.0)
    out["teardown_s"] = time.perf_counter() - t_down
    checks["teardown_clean"] = (not out["store_file_left"]
                                and not out["processes_left"])
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 18
    return out


def _cli(addr, *argv, timeout: float = 300.0):
    """``python -m ray_tpu_torch --address H:P <argv>`` in a process of
    its own, from this checkout: (exit code, stdout, stderr, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "--address",
         f"{addr[0]}:{addr[1]}", *argv], capture_output=True, text=True,
        timeout=timeout, cwd=root,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(path)})
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t)


def _serve_cli(addr, deployment: str, requests: int):
    """The CLI's subcommands, each in its own process, then the dashboard
    in this one, against the cluster serving ``deployment``: the seconds
    of each subcommand and route, and the checks of what each shows."""
    import tempfile
    import urllib.request

    from ray_tpu_torch import dashboard

    out, runs = {"seconds": {}, "exit": {}}, {}
    tmp = tempfile.mkdtemp(prefix="smoke_cli_")
    trace_path = os.path.join(tmp, "timeline.json")
    done = {}

    def run(key, argv):
        done[key] = _cli(addr, *argv)

    # The light subcommands one at a time; then doctor (two snapshots
    # 2 s apart) and the serve timeline, the two that load torch, at
    # once: each is a process of its own, timed from its own start.
    for key, argv in (("status", ["status"]),
                      ("list nodes", ["list", "nodes"]),
                      ("list actors", ["list", "actors"]),
                      ("memory", ["memory"]), ("metrics", ["metrics"])):
        run(key, argv)
    pair = [threading.Thread(target=run, args=(key, argv)) for key, argv in (
        ("doctor", ["doctor", "--interval", "2", "--json"]),
        ("timeline", ["timeline", "--serve", "-o", trace_path]))]
    for th in pair:
        th.start()
    for th in pair:
        th.join()
    for key in ("status", "list nodes", "list actors", "memory", "metrics",
                "doctor", "timeline"):
        rc, stdout, stderr, secs = done[key]
        runs[key] = stdout
        out["seconds"][key] = secs
        out["exit"][key] = rc
        if rc:
            out.setdefault("stderr", {})[key] = stderr[-2000:]
    checks = {"cli_exit_0": all(rc == 0 for rc in out["exit"].values())}
    checks["cli_status_gpu_1"] = "'GPU': 1.0" in runs["status"]
    checks["cli_list_actors_names_replica"] = any(
        "ReplicaActor" in line and "ALIVE" in line
        for line in runs["list actors"].splitlines())
    counts = [int(m.group(1)) for m in re.finditer(
        r"serve_ttft_s\{deployment=" + re.escape(deployment)
        + r"\}\s+n=(\d+)", runs["metrics"])]
    out["metrics_ttft_count"] = counts[0] if counts else None
    checks["cli_metrics_deployment_count"] = bool(counts) and \
        counts[0] >= requests
    try:
        with open(trace_path) as f:
            trace = json.load(f)
    except (OSError, ValueError):
        trace = []
    steps = [e for e in trace if e.get("cat") == "engine-step"]
    out["timeline_events"], out["timeline_engine_steps"] = (
        len(trace), len(steps))
    checks["cli_timeline_engine_steps"] = bool(steps) and all(
        str(e.get("pid", "")).startswith(f"engine:{deployment}")
        for e in steps)
    try:
        findings = json.loads(runs["doctor"])
    except ValueError:
        findings = None
    out["doctor_findings"] = ([f["signature"] for f in findings]
                              if findings is not None else None)
    checks["cli_doctor_json_no_slo_burn"] = findings is not None and not [
        f for f in findings if f["signature"] == "slo-burn"]
    # The dashboard, started in this process.
    server, (host, port) = dashboard.start(addr)
    codes, bodies = {}, {}
    try:
        for route in ("/", "/api/nodes", "/api/actors", "/api/serve",
                      "/api/core", "/metrics"):
            t = time.perf_counter()
            try:
                with urllib.request.urlopen(f"http://{host}:{port}{route}",
                                            timeout=60) as resp:
                    codes[route], bodies[route] = resp.status, resp.read()
            except Exception as e:  # a failed route fails the check
                codes[route], bodies[route] = repr(e), b""
            out["seconds"][f"dashboard {route}"] = time.perf_counter() - t
    finally:
        server._history.stop()
        server.shutdown()
        server.server_close()
    out["dashboard_codes"] = codes
    checks["dashboard_routes_200"] = all(c == 200 for c in codes.values())
    try:
        serve_view = json.loads(bodies["/api/serve"])
    except ValueError:
        serve_view = {}
    checks["dashboard_serve_names_deployment"] = deployment in serve_view
    return out, checks


# ----------------------------------------------------------------- gang

GANG_NAME = "smoke-gang"
GANG_AGAIN = "r1_shared_src"      # the request served after the reconcile


def _gang_serve(member, cfg, device, requests) -> dict:
    """Run in the gang's member (through ``HostGroup.broadcast``): the
    serve phase's engine (``LlamaDecodeDeployment``, ``slots=4``,
    ``capacity=2048``, seed 0) built on the member's card, ``requests``
    served one at a time, and flash #1's launches read in this
    process."""
    import gc
    import os
    import time

    import torch

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    t = time.perf_counter()
    dep = LlamaDecodeDeployment(config=cfg, slots=4, capacity=2048, seed=0,
                                device=device)
    card = dep.engine.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t, "pid": os.getpid(),
           "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "device": str(dep.engine.device),
           "card": torch.cuda.get_device_name(0) if card else None,
           "process_id": member.process_id,
           "num_processes": member.num_processes, "requests": {}}
    try:
        fa.flash_attention.launches = 0
        fwd0 = fa.forward_kernel_launches() if card else {}
        waves0 = dep.engine.stats()["prefill_waves"]
        for name, toks, n in requests:
            start_at, t = time.time(), time.perf_counter()
            reply = dep({"tokens": toks, "max_new_tokens": n})
            wall = time.perf_counter() - t
            out["requests"][name] = {
                "tokens": reply["tokens"], "ttft_s": reply["ttft_s"],
                "first_token_at": start_at + reply["ttft_s"],
                "wall_s": wall,
                "decode_tok_s": (len(reply["tokens"]) - 1)
                / max(1e-9, wall - reply["ttft_s"])}
        out["launches"] = {"flash_fwd": fa.flash_attention.launches}
        out["flash_fwd_by_kernel"] = {
            k: v - fwd0.get(k, 0)
            for k, v in fa.forward_kernel_launches().items()} if card \
            else {}
        out["full_prefill_waves"] = (dep.engine.stats()["prefill_waves"]
                                     - waves0)
    finally:
        dep.shutdown()
        del dep
        gc.collect()
        if card:
            torch.cuda.empty_cache()
    return out


def phase_gang(cfg, want: dict, device="cuda") -> dict:
    """A one-host gang on the card's node serving Llama-2-7B in its
    member, its reconcile after the member is killed, and its shutdown.
    ``want``: the serve_runtime phase's sequential handle streams. See
    the module docstring."""
    import ray_tpu_torch as rt

    cuda = torch.device(device).type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    saved = os.environ.get("RAY_TPU_VIRTUAL_SLICE")
    if not cuda:
        # Off the card: a virtual one-host slice of one chip.
        os.environ["RAY_TPU_VIRTUAL_SLICE"] = "1x1"
    try:
        _runtime_init(device)
        try:
            return _gang(cfg, want, device)
        finally:
            if rt.is_initialized():  # a failure before the teardown
                rt.shutdown()
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_VIRTUAL_SLICE", None)
        else:
            os.environ["RAY_TPU_VIRTUAL_SLICE"] = saved


def _gang(cfg, want, device) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.multihost import (HostGroup,
                                              program_fingerprint,
                                              registry_state)
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.placement import cluster_topology
    from ray_tpu_torch.core.runtime import get_core_worker

    cuda = torch.device(device).type == "cuda"
    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    resources = rt.cluster_resources()
    gpus = rt.available_resources().get("GPU")
    out = {"resources": resources}
    checks = {"gpu_resource": resources.get("GPU") == 1.0 and gpus == 1.0}
    plan = _serve_plan(cfg)
    reset_counts()

    def gpu_now():
        return rt.available_resources().get("GPU")

    # (a) formation
    t = time.perf_counter()
    g = HostGroup(1, name=GANG_NAME, worker_options={"num_gpus": 1}).start()
    out["formation_s"] = time.perf_counter() - t
    try:
        [info] = g.call_all("member_info", timeout=60.0)
        held = _poll_until(gpu_now, lambda v: v == gpus - 1)
        t = time.perf_counter()
        mesh = g.form_mesh(timeout=300.0)
        out["form_mesh_s"] = time.perf_counter() - t
        fp = program_fingerprint(text=f"serve|{cfg}|slots=4|capacity=2048")
        barrier = g.call_all("program_barrier", "smoke-serve", fp, 60.0,
                             timeout=120.0)
        st = g.status()
        out["formation"] = {k: info.get(k) for k in (
            "process_id", "num_processes", "chips_per_host", "slice_id",
            "device_type", "coordinator_address", "pid")}
        out["formation"]["sub_slice"] = st["sub_slice"]
        checks["a_formed_one_host"] = (
            st["state"] == "ALIVE" and st["epoch"] == 1
            and info["process_id"] == 0 and info["num_processes"] == 1
            and info["chips_per_host"] == 1)
        checks["a_one_rank_group"] = mesh == [1]
        checks["a_program_barrier"] = barrier == [{"host-0": fp}]
        checks["a_member_holds_gpu"] = held == gpus - 1

        # (b) serving in the member
        requests = [(n, plan[n][0], plan[n][1]) for n in plan]
        t = time.perf_counter()
        [served] = g.broadcast(_gang_serve, cfg, device, requests,
                               timeout=900.0)
        out["serve_s"] = time.perf_counter() - t
        got = {n: served["requests"][n]["tokens"] for n in plan}
        mismatch = {n: _first_difference({n: got[n]}, {n: want[n]})[n]
                    for n in plan if got[n] != want[n]}
        tokens = sum(len(v) for v in got.values())
        serve_wall = sum(r["wall_s"] for r in served["requests"].values())
        out["member"] = {k: served[k] for k in (
            "build_s", "pid", "cuda_visible", "device", "card",
            "launches", "flash_fwd_by_kernel", "full_prefill_waves")}
        out["ttft_s"] = {n: served["requests"][n]["ttft_s"] for n in plan}
        out["decode_tok_s"] = {n: served["requests"][n]["decode_tok_s"]
                               for n in plan}
        out["tokens_per_s"] = tokens / serve_wall
        if mismatch:
            out["mismatch"] = mismatch
        launches = served["launches"]["flash_fwd"]
        waves = served["full_prefill_waves"]
        checks["b_streams_equal_serve_runtime"] = not mismatch
        checks["b_member_on_card"] = (
            served["pid"] != os.getpid() and served["cuda_visible"] != ""
            and served["device"].startswith(torch.device(device).type)
            and (not cuda or bool(served["card"])))
        checks["b_flash_launches_32_per_full_wave"] = (
            waves > 0 and launches == cfg.n_layers * waves)
        checks["b_flash_fwd_on_wgmma"] = all_on_wgmma(
            served["flash_fwd_by_kernel"], launches, device)

        # (c) reconcile: kill the member
        epoch0, coord0 = g.epoch, g.coordinator()
        kill_at, t = time.time(), time.perf_counter()
        rt.kill(g.members[0])
        st = _poll_until(g.status, lambda s: s["epoch"] == epoch0 + 1
                         and s["state"] == "ALIVE", 180.0)
        out["kill_to_alive_s"] = time.perf_counter() - t
        [info2] = g.call_all("member_info", timeout=60.0)
        held2 = _poll_until(gpu_now, lambda v: v == gpus - 1)
        coord = g.coordinator()
        again = [(GANG_AGAIN, plan[GANG_AGAIN][0], plan[GANG_AGAIN][1])]
        [served2] = g.broadcast(_gang_serve, cfg, device, again,
                                timeout=900.0)
        reply = served2["requests"][GANG_AGAIN]
        out["kill_to_first_token_s"] = reply["first_token_at"] - kill_at
        out["reconcile"] = {
            "epoch": st["epoch"], "restarts": st["restarts"],
            "releases": st["releases"], "death_cause": st["death_cause"],
            "old_pid": info["pid"], "new_pid": info2["pid"],
            "coordinator": coord, "old_coordinator": coord0,
            "member_build_s": served2["build_s"],
            "ttft_s": reply["ttft_s"], "launches": served2["launches"],
            "full_prefill_waves": served2["full_prefill_waves"]}
        checks["c_reconciled_under_next_epoch"] = (
            st["epoch"] == epoch0 + 1 and st["state"] == "ALIVE"
            and st["restarts"] == 1 and info2["epoch"] == epoch0 + 1)
        checks["c_subslice_released_once"] = st["releases"] == 1
        checks["c_lease_passed_to_new_member"] = (
            info2["pid"] != info["pid"] and held2 == gpus - 1)
        checks["c_new_coordinator_elected"] = (
            coord["epoch"] == epoch0 + 1
            and coord["address"] != coord0["address"])
        checks["c_same_stream_again"] = reply["tokens"] == want[GANG_AGAIN]
        checks["c_flash_launches_32_per_full_wave"] = (
            served2["full_prefill_waves"] > 0
            and served2["launches"]["flash_fwd"]
            == cfg.n_layers * served2["full_prefill_waves"])
    finally:
        g.shutdown()

    # (d) shutdown
    out["reservations_left"] = {
        rid: owner for sl in cluster_topology()["slices"].values()
        for rid, owner in sl["reservations"].items()}
    out["group_record_left"] = registry_state(GANG_NAME)
    out["gpu_returned"] = _poll_until(gpu_now, lambda v: v == gpus)
    out["releases"] = g.status()["releases"]
    driver = launch_counts()
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                        lambda v: not v, 15.0)
    checks["d_shutdown_clean"] = (
        not out["reservations_left"] and out["group_record_left"] is None
        and out["gpu_returned"] == gpus and out["releases"] == 2
        and not out["store_file_left"] and not out["processes_left"])
    # Flash #1 ran in the members only (counted in their processes).
    checks["no_kernel_in_driver"] = not any(driver.values())
    out["launches"] = {"flash_fwd": served["launches"]["flash_fwd"]
                       + served2["launches"]["flash_fwd"]}
    out["flash_fwd_by_kernel"] = {
        k: served["flash_fwd_by_kernel"].get(k, 0)
        + served2["flash_fwd_by_kernel"].get(k, 0)
        for k in set(served["flash_fwd_by_kernel"])
        | set(served2["flash_fwd_by_kernel"])}
    out["checks"] = checks
    if cuda:
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 17
    return out


# ------------------------------------------------------------ the cluster

CLUSTER_ACTOR = "smoke-llm"
CLUSTER_MARKER = "RTT_SMOKE_MARKER"
# The job's request. Repeated on the actor's engine after the client's
# pass, it splices the same cached prefix (r1's) as its first pass did, so
# its stream is the first pass's; a repeat of r1 or r2 would hit its own
# cached prefix and take another path.
CLUSTER_JOB_REQUEST = "r5_prefix_hit"
# Each node's store, the client's upload and the pull across nodes.
CLUSTER_STORE_BYTES = {"cuda": 4 << 30, "cpu": 512 << 20}
CLUSTER_UPLOAD_BYTES = {"cuda": 256 << 20, "cpu": 16 << 20}
CLUSTER_PULL_BYTES = {"cuda": 1 << 30, "cpu": 64 << 20}

# The thin client: its own process, written to a file and run with this
# interpreter. It creates the named 7B actor on the GPU node with a
# runtime_env, has it serve the serve phase's six requests one at a time,
# uploads an array that the actor copies to its card, and reports whether
# it created a CUDA context itself. Its actor class travels by value.
CLUSTER_CLIENT = r'''
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

import ray_tpu_torch as rt


class SmokeLLM:
    """The 7B deployment in the actor's process, as the gang's member
    builds it."""

    def __init__(self, cfg, device):
        import smoke_env_mod  # imported by name from the working_dir

        from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

        t = time.perf_counter()
        self.dep = LlamaDecodeDeployment(config=cfg, slots=4, capacity=2048,
                                         seed=0, device=device)
        self.card = self.dep.engine.device.type == "cuda"
        if self.card:
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t
        self.module = {"value": smoke_env_mod.VALUE, "dir": os.path.dirname(
            os.path.abspath(smoke_env_mod.__file__))}

    def info(self):
        from ray_tpu_torch.core.runtime import get_core_worker

        return {"node": get_core_worker().node_id.hex(), "pid": os.getpid(),
                "cwd": os.getcwd(), "marker": os.environ.get("{marker}"),
                "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self.dep.engine.device),
                "card": torch.cuda.get_device_name(0) if self.card else None,
                "build_s": self.build_s, "module": self.module}

    def window(self, reset):
        from ray_tpu_torch.ops import flash_attention as fa

        out = {"launches": fa.flash_attention.launches,
               "by_kernel": fa.forward_kernel_launches() if self.card
               else {},
               "prefill_waves": self.dep.engine.stats()["prefill_waves"]}
        if reset:
            fa.flash_attention.launches = 0
        return out

    def serve(self, requests):
        out = {}
        for name, toks, n in requests:
            t = time.perf_counter()
            reply = self.dep({"tokens": toks, "max_new_tokens": n})
            out[name] = {"tokens": reply["tokens"],
                         "ttft_s": reply["ttft_s"],
                         "wall_s": time.perf_counter() - t}
        return out

    def one(self, toks, n):
        return self.dep({"tokens": toks, "max_new_tokens": n})["tokens"]

    def checksum(self, arr):
        import warnings

        t = time.perf_counter()
        with warnings.catch_warnings():  # the store's view is read-only
            warnings.simplefilter("ignore")
            dev = torch.from_numpy(arr).to(self.dep.engine.device)
        total = int(dev.sum(dtype=torch.int64))
        return {"checksum": total, "bytes": int(arr.nbytes),
                "on": str(dev.device), "to_card_s": time.perf_counter() - t}

    def pull(self, refs):
        t = time.perf_counter()
        arr = rt.get(refs[0])
        pull_s = time.perf_counter() - t
        return {"pull_s": pull_s, **self.checksum(arr)}


def main():
    args = json.loads(sys.argv[1])
    with open(args["cfg"], "rb") as f:
        cfg = pickle.load(f)
    out = {}
    t = time.perf_counter()
    rt.init(address=args["address"])
    out["connect_s"] = time.perf_counter() - t
    t = time.perf_counter()
    actor = rt.remote(SmokeLLM).options(
        name=args["name"], num_gpus=1,
        runtime_env={"env_vars": {"{marker}": args["marker"]},
                     "working_dir": args["working_dir"]},
    ).remote(cfg, args["device"])
    out["info"] = rt.get(actor.info.remote(), timeout=900)
    out["actor_ready_s"] = time.perf_counter() - t
    out["window0"] = rt.get(actor.window.remote(True), timeout=60)
    t = time.perf_counter()
    out["served"] = rt.get(actor.serve.remote(args["requests"]), timeout=900)
    out["serve_s"] = time.perf_counter() - t
    arr = np.frombuffer(np.random.default_rng(1).bytes(
        args["upload_bytes"]), np.uint8)
    t = time.perf_counter()
    ref = rt.put(arr)
    out["upload_s"] = time.perf_counter() - t
    out["upload"] = rt.get(actor.checksum.remote(ref), timeout=300)
    out["upload"]["want"] = int(arr.sum(dtype=np.int64))
    out["handle_class"] = type(actor).__name__
    del ref, arr
    rt.shutdown()  # disconnects; the named actor outlives the session
    out["cuda_initialized"] = torch.cuda.is_initialized()
    with open(args["out"], "w") as f:
        json.dump(out, f)
    print("client cuda initialized:", out["cuda_initialized"], flush=True)


main()
'''.replace("{marker}", CLUSTER_MARKER)

# The submitted job's entrypoint: attach to the cluster as a driver, find
# the named actor and print one request's stream.
CLUSTER_JOB = r'''
import json
import os

import ray_tpu_torch as rt

host, port = os.environ["SMOKE_CLUSTER_ADDRESS"].rsplit(":", 1)
rt.init(address=(host, int(port)))
with open("job_request.json") as f:
    req = json.load(f)
actor = rt.get_actor(req["actor"])
tokens = rt.get(actor.one.remote(req["tokens"], req["max_new_tokens"]),
                timeout=600)
print("JOB_STREAM " + json.dumps(tokens), flush=True)
rt.shutdown()
'''


def _cluster_big(n: int):
    """The ``n`` random bytes the pull moves: made by a task on the CPU
    node, so its return lands in that node's store."""
    return np.frombuffer(np.random.default_rng(2).bytes(n), np.uint8)


def phase_cluster(cfg, want: dict, device="cuda") -> dict:
    """Two nodes on this machine, a thin client in its own process that
    deploys a 7B serving actor with a ``runtime_env`` onto the node holding
    the card, a pull across the nodes' stores, and a submitted job that
    reaches the actor. ``want``: the serve_runtime phase's sequential
    handle streams. See the module docstring."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.client import ClientServer
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import detect_gpus
    from ray_tpu_torch.core.config import config

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    saved = config.snapshot()
    config.update(_store_config(device, CLUSTER_STORE_BYTES, stores=2))
    tmp = tempfile.mkdtemp(prefix="smoke_cluster_")
    cluster = server = None
    try:
        t = time.perf_counter()
        cluster = Cluster(initialize_head=False)
        cpu_node = cluster.add_node(num_cpus=4)
        gpu_node = cluster.add_node(
            num_cpus=2, resources={"GPU": 1},
            labels={"gpu_name": detect_gpus()[1] or "none"})
        cluster.wait_for_nodes(30)
        rt.init(address=cluster.address)
        server = ClientServer(host="127.0.0.1")
        form_s = time.perf_counter() - t
        out = _cluster(cfg, want, device, cluster, cpu_node, gpu_node,
                       server, form_s, tmp)
        t = time.perf_counter()
    finally:
        if server is not None:
            server.stop()
        if rt.is_initialized():
            rt.shutdown()
        if cluster is not None:
            cluster.shutdown()
        config.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    # Teardown: every process of both nodes has exited.
    nodes = out["nodes"]
    out["processes_left"] = _poll_until(
        lambda: _live_node_pids(nodes["cpu"]) + _live_node_pids(
            nodes["gpu"]), lambda v: not v, 15.0)
    out["step_seconds"]["teardown"] = (
        out["step_seconds"]["actor_exit"] + time.perf_counter() - t)
    checks = out["checks"]
    checks["no_worker_left"] = (out["actor_exited"]
                                and not out["processes_left"])
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 16
    return out


def _cluster(cfg, want, device, cluster, cpu_node, gpu_node, server, form_s,
             tmp) -> dict:
    import pickle

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.placement import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.job_submission import JobSubmissionClient

    kind = torch.device(device).type
    cuda = kind == "cuda"
    plan = _serve_plan(cfg)
    nodes = {"cpu": cpu_node.node_id.hex(), "gpu": gpu_node.node_id.hex()}
    resources = rt.cluster_resources()
    out = {"form_s": form_s, "nodes": nodes, "resources": resources,
           "step_seconds": {"form": form_s}}
    checks = {"two_nodes_one_gpu": (
        len([n for n in rt.nodes() if n["alive"]]) == 2
        and resources.get("GPU") == 1.0 and resources.get("CPU") == 6.0)}
    reset_counts()

    # (a) The thin client in its own process.
    env_dir = os.path.join(tmp, "env")
    os.makedirs(env_dir)
    with open(os.path.join(env_dir, "smoke_env_mod.py"), "w") as f:
        f.write("VALUE = 'from-the-working-dir'\n")
    paths = {k: os.path.join(tmp, k) for k in ("cfg.pkl", "client.py",
                                                 "client.json")}
    with open(paths["cfg.pkl"], "wb") as f:
        pickle.dump(cfg, f)
    with open(paths["client.py"], "w") as f:
        f.write(CLUSTER_CLIENT)
    marker = f"smoke-{os.getpid()}"
    args = {"address": f"ray-tpu://{server.address[0]}:{server.address[1]}",
            "cfg": paths["cfg.pkl"], "out": paths["client.json"],
            "name": CLUSTER_ACTOR, "marker": marker, "device": device,
            "working_dir": env_dir,
            "requests": [(n, plan[n][0], plan[n][1]) for n in plan],
            "upload_bytes": CLUSTER_UPLOAD_BYTES[kind]}
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, paths["client.py"],
                           json.dumps(args)], capture_output=True, text=True,
                          env=env, timeout=1000)
    out["step_seconds"]["client"] = time.perf_counter() - t
    if proc.returncode != 0:
        raise RuntimeError(f"the thin client exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    with open(paths["client.json"]) as f:
        got = json.load(f)
    info = got["info"]
    served = got["served"]
    up = got["upload"]
    streams = {n: served[n]["tokens"] for n in plan}
    mismatch = {n: _first_difference({n: streams[n]}, {n: want[n]})[n]
                for n in plan if streams[n] != want[n]}
    if mismatch:
        out["mismatch"] = mismatch
    out["client"] = {
        "connect_s": got["connect_s"], "actor_ready_s": got["actor_ready_s"],
        "serve_s": got["serve_s"], "handle_class": got["handle_class"],
        "cuda_initialized": got["cuda_initialized"],
        "upload_bytes": up["bytes"], "upload_s": got["upload_s"],
        "upload_gb_s": up["bytes"] / got["upload_s"] / 1e9,
        "upload_to_card_s": up["to_card_s"]}
    out["actor"] = {k: info[k] for k in ("node", "pid", "cwd", "device",
                                         "cuda_visible", "card", "build_s",
                                         "module")}
    out["ttft_s"] = {n: served[n]["ttft_s"] for n in plan}
    out["decode_tok_s"] = {
        n: (len(served[n]["tokens"]) - 1)
        / max(1e-9, served[n]["wall_s"] - served[n]["ttft_s"])
        for n in plan}
    checks.update({
        "client_streams_equal_serve_runtime": not mismatch,
        "client_holds_no_cuda_context": got["cuda_initialized"] is False,
        "client_handle_is_thin": got["handle_class"] == "ClientActorHandle",
        "actor_on_gpu_node": info["node"] == nodes["gpu"],
        "actor_on_card": (info["pid"] != os.getpid()
                          and info["cuda_visible"] != ""
                          and info["device"].startswith(kind)
                          and (not cuda or bool(info["card"]))),
        "actor_sees_marker": info["marker"] == marker,
        "actor_cwd_is_working_dir": (
            info["cwd"] == info["module"]["dir"]
            and info["module"]["value"] == "from-the-working-dir"),
        "upload_checksum": (up["checksum"] == up["want"]
                            and up["on"].startswith(kind)),
    })

    # (b) A pull across the nodes: a task on the CPU node makes the array,
    # the GPU node's actor gets it.
    actor = rt.get_actor(CLUSTER_ACTOR)
    n = CLUSTER_PULL_BYTES[kind]
    t = time.perf_counter()
    big = rt.remote(_cluster_big).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(nodes["cpu"]),
        ).remote(n)
    rt.wait([big], num_returns=1, timeout=300)
    out["step_seconds"]["pull_source"] = time.perf_counter() - t
    t = time.perf_counter()
    pulled = rt.get(actor.pull.remote([big]), timeout=600)
    out["step_seconds"]["pull"] = time.perf_counter() - t
    del big
    pull_want = int(_cluster_big(n).sum(dtype=np.int64))
    out["pull"] = {"bytes": pulled["bytes"], "pull_s": pulled["pull_s"],
                   "pull_gb_s": pulled["bytes"] / pulled["pull_s"] / 1e9,
                   "to_card_s": pulled["to_card_s"]}
    checks["pull_checksum"] = (pulled["checksum"] == pull_want
                               and pulled["bytes"] == n
                               and pulled["on"].startswith(kind))

    # (c) A submitted job reaches the named actor, which outlived the
    # client's session.
    job_dir = os.path.join(tmp, "job")
    os.makedirs(job_dir)
    with open(os.path.join(job_dir, "job_entry.py"), "w") as f:
        f.write(CLUSTER_JOB)
    toks, max_new, _ = plan[CLUSTER_JOB_REQUEST]
    with open(os.path.join(job_dir, "job_request.json"), "w") as f:
        json.dump({"actor": CLUSTER_ACTOR, "tokens": toks,
                   "max_new_tokens": max_new}, f)
    host, port = cluster.address
    jobs = JobSubmissionClient(cluster.address)
    t = time.perf_counter()
    job_id = jobs.submit_job(
        entrypoint=f"{sys.executable} job_entry.py",
        runtime_env={"working_dir": job_dir,
                     "env_vars": {"SMOKE_CLUSTER_ADDRESS":
                                  f"{host}:{port}"}})
    status = jobs.wait_until_finished(job_id, timeout=600)
    out["step_seconds"]["job"] = time.perf_counter() - t
    logs = jobs.get_job_logs(job_id)
    lines = [x for x in logs.splitlines() if x.startswith("JOB_STREAM ")]
    job_stream = json.loads(lines[-1].split(" ", 1)[1]) if lines else None
    out["job"] = {"id": job_id, "status": status,
                  "stream_equal": job_stream == want[CLUSTER_JOB_REQUEST]}
    if status != "SUCCEEDED" or not lines:
        out["job"]["logs_tail"] = logs[-2000:]
    checks["job_succeeded"] = status == "SUCCEEDED"
    checks["job_stream_equals_serve_runtime"] = (
        job_stream == want[CLUSTER_JOB_REQUEST])

    # The actor's launches over the client's and the job's requests, read
    # in its own process.
    w0 = got["window0"]
    w1 = rt.get(actor.window.remote(False), timeout=60)
    launches = w1["launches"]
    waves = w1["prefill_waves"] - w0["prefill_waves"]
    by_kernel = {k: v - w0["by_kernel"].get(k, 0)
                 for k, v in w1["by_kernel"].items()}
    out.update({"launches": {"flash_fwd": launches},
                "flash_fwd_by_kernel": by_kernel,
                "actor_full_prefill_waves": waves})
    checks["flash_launches_32_per_full_wave"] = (
        waves > 0 and launches == cfg.n_layers * waves)
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel, launches, device)
    driver = launch_counts()
    checks["no_kernel_in_driver"] = not any(driver.values())

    # (d) Teardown, first the named actor: its process exits (the caller
    # stops the rest).
    t = time.perf_counter()
    rt.kill(actor)
    out["actor_exited"] = info["pid"] not in _poll_until(
        lambda: _live_node_pids(nodes["gpu"]), lambda v: info["pid"] not in v,
        30.0)
    out["step_seconds"]["actor_exit"] = time.perf_counter() - t
    out["checks"] = checks
    return out


# ------------------------------------------------------- the pipeline

# The train cell's model through the pipeline plane: each step is
# ``n_micro`` microbatches of ``micro_batch`` x ``seq`` tokens; every run
# keeps the first ``layers`` layers of the 1B weights at full width (a 1B
# stage state is 4.68 GB to push, 1.28 GB at 4 layers).
PIPELINE = dict(steps=3, n_micro=4, micro_batch=2, seq=2048, lr=3e-4,
                window=2, layers=4, seed=0)
# (a)'s losses against the full-model baseline (``llama.loss_fn``, whose
# CE this config chunks in 512 tokens) at each step: one bf16 ulp. The two
# paths compute the same bf16 activations; they differ in the fp32 head
# and CE (the whole (2, 2048, 32000) logits against 512-token chunks:
# another reduction order, ~1e-6 relative on a loss) and, through it, in
# which backward values round to the next bf16 neighbour. Adam's first
# steps move every weight by about lr whatever its gradient's size, so a
# rounding flip changes an update only where the gradient's sign is
# itself within rounding of zero, and the loss then moves by less than
# one bf16 rounding (2^-8 relative) of its own value.
PIPELINE_FULL_REL_TOL = 2.0 ** -8
# Two stages share the one card (each holds half of its GPU lease).
PIPE_SHARE = {"num_gpus": 0.5}


def _pipe_steps(cfg, device_type: str) -> list:
    """The phase's token batches: one batch from a numpy generator, split
    into ``microbatches``' inputs and targets, for every step (as the
    train phase steps on one fixed batch), so a falling loss reads
    learning and not the next batch's noise."""
    from ray_tpu_torch.train.pipeline_plane import microbatches

    p = PIPELINE
    seq = p["seq"] if device_type == "cuda" else 32
    rng = np.random.default_rng(p["seed"])
    tokens = rng.integers(0, cfg.vocab_size,
                          (p["n_micro"] * p["micro_batch"], seq + 1))
    return [microbatches({"tokens": tokens.astype(np.int32)}, p["n_micro"])
            for _ in range(p["steps"])]


def _pipe_member_counts(member, device, reset: bool) -> dict:
    """Run in a stage's process (``HostGroup.broadcast``): zero its launch
    counters, or read them with the C entries' per-kernel counts (which
    count from the process's start)."""
    import os

    if reset:
        reset_counts()
    return {"pid": os.getpid(), "stage_host": member.process_id,
            "launches": launch_counts(),
            "fwd_by_kernel": fwd_kernel_counts(device),
            "bwd_by_kernel": bwd_kernel_counts(device)}


def _pipe_baseline(cfg, params, steps, device, n_stages) -> list:
    """The in-process reference on the card (its params freed after)."""
    from ray_tpu_torch.train.pipeline_plane import single_process_baseline

    losses, _params = single_process_baseline(
        cfg, params, PIPELINE["lr"], steps, n_stages=n_stages,
        device=device)
    del _params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return losses


def _pipe_run(cfg, params, steps, device, n_stages, name, worker_options,
              snapshot_every=0, resumed=None) -> dict:
    """One plane on the runtime: formation, ``steps`` train steps (each
    timed, with every stage's busy seconds), the launch counts read in the
    stages' processes, ``stop()``. ``resumed``: after ``steps`` and their
    counts, the same plane trains these further steps, the last stage's
    process SIGKILLed once two of them committed; their record is
    ``out["resumed"]``."""
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    out = {"n_stages": n_stages, "worker_options": worker_options}
    t = time.perf_counter()
    plane = PipelinePlane(
        cfg, params, n_stages=n_stages, n_microbatches=PIPELINE["n_micro"],
        lr=PIPELINE["lr"], window=PIPELINE["window"], name=name,
        snapshot_every=snapshot_every, device=device,
        worker_options=worker_options).start()
    out["start_s"] = time.perf_counter() - t
    try:
        before = plane.group.broadcast(_pipe_member_counts, device, True,
                                       timeout=120.0)
        reset_counts()
        record = _pipe_steps_timed(plane, steps, n_stages)
        out["driver_launches"] = launch_counts()
        after = plane.group.broadcast(_pipe_member_counts, device,
                                      False, timeout=120.0)
        out["stage_pids"] = [a["pid"] for a in after]
        out["launches"] = {k: sum(a["launches"][k] for a in after)
                           for k in KERNELS}
        out["stage_launches"] = [a["launches"] for a in after]
        for key, field in (("flash_fwd_by_kernel", "fwd_by_kernel"),
                           ("flash_bwd_by_kernel", "bwd_by_kernel")):
            out[key] = {k: sum(a[field].get(k, 0) - b[field].get(k, 0)
                               for a, b in zip(after, before))
                        for k in after[0][field]}
        out.update(_pipe_record(plane, name, record))
        if resumed is not None:
            infos = plane.group.call_all("member_info", timeout=60.0)
            victim = infos[-1]
            killed = {"member": victim["member"], "pid": victim["pid"]}
            rec = _pipe_steps_timed(plane, resumed, n_stages,
                                    kill=(2, victim["pid"]))
            out["resumed"] = {"killed": killed,
                              **_pipe_record(plane, name, rec)}
            out["resumed"]["losses"] = \
                out["resumed"]["losses"][len(steps):]
    finally:
        t = time.perf_counter()
        out["report"] = plane.stop()
        out["stop_s"] = time.perf_counter() - t
    out["registry_after"] = plane.registry_state()
    return out


def _pipe_steps_timed(plane, steps, n_stages, kill=None) -> dict:
    """Train ``steps`` on ``plane``: each step's wall and the stages'
    busy seconds. ``kill``: (i, pid), SIGKILL ``pid`` before step i."""
    import signal

    walls, busy, breakdowns = [], [], []
    for i, mbs in enumerate(steps):
        if kill is not None and i == kill[0]:
            os.kill(kill[1], signal.SIGKILL)
        busy0 = plane.stats()["stage_busy_s"]
        t = time.perf_counter()
        plane.train_step(mbs)
        walls.append(time.perf_counter() - t)
        st = plane.stats()
        busy.append([b - a for a, b in zip(busy0, st["stage_busy_s"])])
        breakdowns.append(st["step_breakdown"])
    return {"walls": walls, "busy": busy, "breakdowns": breakdowns,
            "n_stages": n_stages}


def _pipe_record(plane, name, rec) -> dict:
    """The plane's state after some steps: losses, timings, bubble, the
    registry and the descriptor histogram."""
    from ray_tpu_torch.util import flightrec
    from ray_tpu_torch.util import metrics as um

    walls, busy, n = rec["walls"], rec["busy"], rec["n_stages"]
    st = plane.stats()
    out = {"losses": plane.losses(), "step_s": walls, "stage_busy_s": busy,
           "bubble": [1.0 - sum(b) / (n * w) for b, w in zip(busy, walls)],
           "model_tflops": [bd["model_tflops"] for bd in rec["breakdowns"]],
           "step_breakdown": rec["breakdowns"][-1],
           "tensor_bytes_moved": st["tensor_bytes_moved"],
           "ledger_refs": st["ledger_refs"],
           "gang_epoch": st["gang_epoch"], "epoch": st["epoch"],
           "restarts": st["group"]["restarts"],
           "registry": plane.registry_state()}
    snap = {"local": um._Registry.get().snapshot()}
    entry = um.merge_histograms(snap, "pipeline_desc_bytes").get(
        (("pipeline", name),))
    out["desc_bytes_p99"] = (um.histogram_quantile(entry, 0.99)
                             if entry else None)
    out["desc_count"] = entry["count"] if entry else 0
    out["disrupted_steps"] = [
        e["step"] for e in flightrec.dump()
        if e.get("ev") == "pipe.disrupted" and e.get("pipeline") == name]
    return out


def phase_pipeline(cfg, device="cuda") -> dict:
    """The pipeline plane on the runtime, ``cfg`` cut to its first
    ``PIPELINE["layers"]`` layers at full width: (a) one stage on the
    card's own slice, then (c) the same plane's stage killed and resumed,
    (b) two stages sharing the card on a virtual two-host slice. See the
    module docstring."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.pipeline_plane import host_copies

    cuda = torch.device(device).type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out, checks = {}, {}
    t0 = time.perf_counter()
    # The train phase's weights (fp32 masters from seed 0), their first
    # layers kept on the host: the plane pushes them to its stages, the
    # baselines copy them.
    on_card = llama.init_params(cfg, device=device, dtype=torch.float32,
                                seed=0)
    full_depth = host_copies(on_card)
    del on_card
    cfg = replace(cfg, n_layers=PIPELINE["layers"])
    params = {**full_depth, "layers": {
        k: v[:cfg.n_layers].clone()
        for k, v in full_depth["layers"].items()}}
    del full_depth
    steps = _pipe_steps(cfg, torch.device(device).type)
    out["init_s"] = time.perf_counter() - t0

    # (a) one stage on the card's own slice, snapshotting every step;
    # (c) the same plane, after (a)'s steps and counts, trains the steps
    # again with its stage's process SIGKILLed after the second commits;
    # then the doctor's post-mortem, through the CLI, against the live
    # cluster
    t = time.perf_counter()
    chain1 = _pipe_baseline(cfg, params, steps + steps, device, 1)
    full = _pipe_baseline(cfg, params, steps, device, None)
    out["baseline_s"] = time.perf_counter() - t
    _runtime_init(device)
    try:
        # One snapshot, after the fifth step: the state the kill before
        # the sixth resumes from.
        a = _pipe_post_mortem(_pipe_run(
            cfg, params, steps, device, 1, "smoke-pipe-kill", None,
            snapshot_every=2 * len(steps) - 1, resumed=steps),
            "smoke-pipe-kill")
    finally:
        rt.shutdown()
    c = a.pop("resumed")
    c["post_mortem"] = a.pop("post_mortem")
    for key in ("report", "stop_s", "registry_after"):
        c[key] = a[key]
    a["chain_losses"], a["full_losses"] = chain1[:len(steps)], full
    c["chain_losses"] = chain1[len(steps):]
    a["full_rel_diff"] = [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                            full)]
    a["seconds"] = c["seconds"] = time.perf_counter() - t
    out["a"], out["c"] = a, c

    # (b) two stages sharing the card
    t = time.perf_counter()
    chain2 = _pipe_baseline(cfg, params, steps, device, 2)
    b = _pipe_virtual_slice(lambda: _pipe_run(
        cfg, params, steps, device, 2, "smoke-pipe-2", PIPE_SHARE), device)
    b["chain_losses"] = chain2
    b["seconds"] = time.perf_counter() - t
    out["b"] = b

    n_steps, n_micro = PIPELINE["steps"], PIPELINE["n_micro"]
    want = {**{k: 0 for k in KERNELS},
            "flash_fwd": 3 * cfg.n_layers * n_micro * n_steps,
            "flash_bwd_dkv": cfg.n_layers * n_micro * n_steps,
            "flash_bwd_dq": cfg.n_layers * n_micro * n_steps,
            "attention_delta": cfg.n_layers * n_micro * n_steps}
    out["launches_want_per_run"] = want
    # (a)'s plane ran (c)'s steps too before it stopped
    steps_run = {"a": 2 * n_steps, "b": n_steps}
    for key, run in (("a", a), ("b", b)):
        checks[f"{key}_losses_equal_chain"] = run["losses"] == \
            run["chain_losses"]
        checks[f"{key}_finite_and_falling"] = (
            all(math.isfinite(x) for x in run["losses"])
            and run["losses"][-1] < run["losses"][0])
        checks[f"{key}_launches_exact"] = run["launches"] == want
        checks[f"{key}_flash_fwd_on_wgmma"] = all_on_wgmma(
            run["flash_fwd_by_kernel"], run["launches"]["flash_fwd"],
            device)
        checks[f"{key}_flash_bwd_on_wgmma"] = all_bwd_on_wgmma(
            run["flash_bwd_by_kernel"], run["launches"]["flash_bwd_dkv"],
            run["launches"]["flash_bwd_dq"], device)
        checks[f"{key}_no_kernel_in_driver"] = not any(
            run["driver_launches"].values())
        checks[f"{key}_stages_in_own_processes"] = (
            os.getpid() not in run["stage_pids"]
            and len(set(run["stage_pids"])) == run["n_stages"])
        checks[f"{key}_clean_stop"] = (
            run["report"] == {"inflight_refs_dropped": 0, "ledger_refs": 0,
                              "steps_completed": steps_run[key]}
            and run["registry_after"] is None and run["ledger_refs"] == 0)
    checks["a_within_full_baseline"] = all(
        d <= PIPELINE_FULL_REL_TOL for d in a["full_rel_diff"])
    checks["b_desc_p99_in_budget"] = (
        b["desc_count"] > 0 and b["desc_bytes_p99"] is not None
        and b["desc_bytes_p99"] <= 8192)
    checks["b_tensors_moved"] = b["tensor_bytes_moved"] > 0
    checks["c_reconciled_next_epoch"] = (
        c["gang_epoch"] == 2 and c["restarts"] == 1)
    checks["c_registry_epoch_bumped"] = (
        c["registry"]["epoch"] == 2 and c["registry"]["last_step"]
        == 2 * n_steps - 1)
    # (c)'s third step is the plane's (n_steps + 3)-th (index n_steps + 2)
    checks["c_step_3_replayed"] = (
        bool(c["disrupted_steps"])
        and set(c["disrupted_steps"]) == {n_steps + 2})
    checks["c_losses_equal_uninterrupted"] = c["losses"] == \
        c["chain_losses"]
    checks["c_clean_stop"] = (
        c["report"] == {"inflight_refs_dropped": 0, "ledger_refs": 0,
                        "steps_completed": 2 * n_steps}
        and c["registry_after"] is None)
    pm = c["post_mortem"]
    checks["c_post_mortem_names_killed_stage"] = (
        pm["exit"] == 0 and pm["first_dying"] == c["killed"]["member"]
        and pm["stage"] == "pipeline 'smoke-pipe-kill' stage s"
        + c["killed"]["member"][len("host-"):])
    # The kernels line counts (a)'s and (b)'s launches, read in the stages.
    out["launches"] = {k: a["launches"][k] + b["launches"][k]
                       for k in KERNELS}
    for key in ("flash_fwd_by_kernel", "flash_bwd_by_kernel"):
        out[key] = {k: a[key].get(k, 0) + b[key].get(k, 0)
                    for k in set(a[key]) | set(b[key])}
    out["config"] = {"n_layers": cfg.n_layers, "dim": cfg.dim,
                     "attention_impl": cfg.attention_impl,
                     "remat_policy": cfg.remat_policy if cfg.remat
                     else None, **PIPELINE}
    out["full_rel_tol"] = PIPELINE_FULL_REL_TOL
    out["checks"] = checks
    if cuda:
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 25
    return out


def _pipe_post_mortem(run: dict, name: str) -> dict:
    """``doctor --post-mortem --json`` through the CLI against the live
    cluster, after the surviving processes' flight recorders flushed: the
    gang-death finding of ``name``'s gang, beside ``run``."""
    from ray_tpu_torch.core.runtime import get_core_worker

    time.sleep(1.5)  # the recorders' background flush
    rc, stdout, stderr, secs = _cli(get_core_worker().controller_addr,
                                    "doctor", "--post-mortem", "--json")
    pm = {"exit": rc, "seconds": secs, "first_dying": None, "stage": None}
    try:
        findings = json.loads(stdout)
    except ValueError:
        findings, pm["stderr"] = [], stderr[-2000:]
    pm["signatures"] = sorted({f["signature"] for f in findings})
    for f in findings:
        if (f["signature"] == "gang-death"
                and f["source"] == f"group:{name}-gang"):
            pm.update(first_dying=f["evidence"]["first_dying"],
                      stage=f["evidence"]["stage"], summary=f["summary"])
    run["post_mortem"] = pm
    return run


def _pipe_virtual_slice(fn, device):
    """``fn()`` under ``rt.init()`` with the node advertising a virtual
    slice of two one-chip hosts (set before init, as the gang phase sets
    its slice off the card)."""
    import ray_tpu_torch as rt

    saved = os.environ.get("RAY_TPU_VIRTUAL_SLICE")
    os.environ["RAY_TPU_VIRTUAL_SLICE"] = "1x2/1"
    try:
        _runtime_init(device)
        try:
            return fn()
        finally:
            rt.shutdown()
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_VIRTUAL_SLICE", None)
        else:
            os.environ["RAY_TPU_VIRTUAL_SLICE"] = saved


# ------------------------------------------------------- launcher_mesh

# The cluster YAML the phase launches (fake_multinode: the head and every
# node the autoscaler adds live in the ``up`` process): a CPU head, and
# one ``gpu`` node type of 4 CPUs and the card, launched on demand and
# torn down when idle for 6 s. Written as JSON, which is YAML too.
LAUNCH_YAML = dict(
    cluster_name="smoke-launch", provider={"type": "fake_multinode"},
    min_workers=0, max_workers=1, idle_timeout_minutes=0.1,
    head={"resources": {"CPU": 8}},
    worker={"resources": {"CPU": 4, "GPU": 1}, "labels": {"pool": "gpu"}})
LAUNCH_TIMEOUT_S = 600.0


def _descendants(pid: int) -> list:
    """Every live process below ``pid`` (read from ``/proc``)."""
    parents = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            parents.setdefault(int(fields[1]), []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        kids = parents.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


class _UpProcess:
    """``python -m ray_tpu_torch up <yaml>`` from this checkout, its output
    read on a thread (kept whole, so the pipe never fills)."""

    def __init__(self, path: str):
        root = os.path.dirname(os.path.abspath(__file__))
        pypath = [root] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]
        self.lines: list = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "up", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=root, env={**os.environ,
                           "PYTHONPATH": os.pathsep.join(pypath)})
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, marker: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.lines):
                if marker in line:
                    return line
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise RuntimeError(f"{marker!r} not printed by up; its output "
                           f"ends: {self.lines[-20:]}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._reader.join(10)


def phase_launcher_mesh(cfg, want: dict, device="cuda") -> dict:
    """The launcher and autopilot family, and the mesh replica through its
    spawn path, driven as an operator drives them: ``up`` on a
    fake_multinode YAML, a ``(1, 1)`` mesh deployment of the 7B whose
    demand makes the autoscaler launch the ``gpu`` node, the serve cell's
    requests through the HTTP proxy, the trace demo, ``autopilot``, then
    ``serve.delete`` and ``down``. See the module docstring."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="launcher_mesh_")
    path = os.path.join(tmp, "cluster.yaml")
    with open(path, "w") as f:
        json.dump(LAUNCH_YAML, f, indent=2)
    t = time.perf_counter()
    up = _UpProcess(path)
    try:
        return _launcher_mesh(cfg, want, device, path, up, t)
    finally:
        if rt.is_initialized():  # a failure before the phase's teardown
            rt.shutdown()
        up.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _launcher_mesh(cfg, want, device, path, up, t_up) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.trace_demo import run_demo

    out, checks = {}, {}
    line = up.wait_for("cluster up; controller at", LAUNCH_TIMEOUT_S)
    host, _, port = line.split()[-1].rpartition(":")
    addr = (host, int(port))
    up.wait_for("autoscaling", LAUNCH_TIMEOUT_S)
    out["up_s"] = time.perf_counter() - t_up
    out["up_actions"] = [ln.strip() for ln in up.lines
                         if ln.startswith("  ")]
    rt.init(address=addr)

    def gpu_nodes():
        return [n for n in rt.nodes()
                if n["alive"] and n["resources"].get("GPU")]

    checks["no_gpu_node_before_demand"] = not gpu_nodes()
    # The mesh replica's GPU demand: its sub-slice reservation is refused
    # until the autoscaler's gpu node registers with its one-card slice.
    geo = dict(config=cfg, slots=4, capacity=2048, seed=0)
    t = time.perf_counter()
    serve.run(serve.deployment(_replica_cls(), mesh_shape=(1, 1)).options(
        ray_actor_options={"num_gpus": 1}, max_concurrency=8).bind(
            **geo, device=device), name="llm_mesh", ready_timeout_s=900.0)
    nodes = _poll_until(gpu_nodes, bool, LAUNCH_TIMEOUT_S)
    out["gpu_node_s"] = time.perf_counter() - t
    # Ingress on every node (the new one too) while the replica starts.
    t_http = time.perf_counter()
    addr_http = serve.start_http()
    out["start_http_s"] = time.perf_counter() - t_http
    out["gpu_node"] = [{"node_id": n["node_id"][:8],
                        "resources": n["resources"],
                        "labels": n["labels"]} for n in nodes]
    checks["autoscaler_launched_gpu_node"] = (
        len(nodes) == 1
        and nodes[0]["labels"].get("provider_node_id", "").startswith(
            "fake-")
        and nodes[0]["labels"].get("pool") == "gpu")
    _poll_until(lambda: serve.status()["llm_mesh"]["replicas"],
                lambda v: v == 1, LAUNCH_TIMEOUT_S)
    h = serve.get_deployment_handle("llm_mesh")
    window = h.options(method_name="flash_window", timeout_s=900.0)
    w0 = window.remote(True).result(timeout=900)
    out["replica_start_s"] = time.perf_counter() - t
    tree = _descendants(up.proc.pid)
    gpu_pids = [p for p in tree if _nvidia_fds(p)]
    out["up_gpu_pids"] = gpu_pids
    out["replica"] = {k: w0[k] for k in ("device", "pid", "cuda_visible",
                                         "card")}
    kind = torch.device(device).type
    checks["replica_on_the_launched_node_and_card"] = (
        w0["pid"] in tree and w0["device"].startswith(kind)
        and w0["cuda_visible"] != ""
        and (kind != "cuda"
             or (bool(w0["card"]) and gpu_pids == [w0["pid"]])))
    plan = _serve_plan(cfg)
    got, ttft = {}, {}
    for i, name in enumerate(plan):
        toks, n, _ = plan[name]
        t_req = time.perf_counter()
        got[name], ttft[name], _ = _http_stream(
            addr_http, "llm_mesh", {"tokens": toks, "max_new_tokens": n},
            REQUEST_TIMEOUT_S)
        if i == 0:  # serve.run to the first streamed token
            out["scale_up_to_first_token_s"] = t_req - t + ttft[name]
    out["client_ttft_s"] = ttft
    mismatch = {name: _first_difference({name: got[name]},
                                        {name: want[name]})[name]
                for name in plan if got[name] != want[name]}
    out["mismatch"] = mismatch
    checks["streams_equal_serve_runtime"] = not mismatch
    w1 = window.remote(False).result(timeout=60)
    launches = w1["launches"]
    waves = w1["prefill_waves"] - w0["prefill_waves"]
    by_kernel = {k: n - w0["by_kernel"].get(k, 0)
                 for k, n in w1["by_kernel"].items()}
    out.update({"launches": {"flash_fwd": launches},
                "flash_fwd_by_kernel": by_kernel,
                "replica_full_prefill_waves": waves})
    checks["flash_launches_32_per_full_wave"] = (
        waves > 0 and launches == cfg.n_layers * waves)
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel, launches, device)
    st = serve.status()["llm_mesh"]
    topo = (st.get("replica_topology") or [{}])[0]
    out["status"] = {"replicas": st["replicas"],
                     "chips_in_use": st["chips_in_use"], "topology": topo}
    checks["mesh_status"] = (
        st["replicas"] == 1 and topo.get("chips") == 1
        and topo.get("mesh_shape") == [1, 1]
        and (topo.get("sub_slice") or {}).get("shape") == [1, 1]
        and str(topo.get("slice_id", "")).startswith("gpu-"))

    # The autopilot (CLI processes) beside the trace demo (this process):
    # one dry-run pass, its plan printed and nothing applied, then its
    # status.
    pilot = {}

    def autopilot():
        t = time.perf_counter()
        pilot["dry_run"] = _cli(addr, "autopilot", "--dry-run",
                                "--interval", "1.0")
        pilot["status"] = _cli(addr, "autopilot", "--status")
        pilot["seconds"] = time.perf_counter() - t

    pilot_thread = threading.Thread(target=autopilot)
    pilot_thread.start()
    # The trace demo against the same cluster, its debug replicas on CPU
    # workers.
    t = time.perf_counter()
    try:
        report = run_demo(init=False, replicas=2, requests=3,
                          device="cpu")
    finally:
        pilot_thread.join()
    out["demo_s"] = time.perf_counter() - t
    out["trace"] = {k: report[k] for k in ("events", "spans",
                                           "engine_slices")}
    out["trace"]["span_processes"] = len(report["span_pids"])
    out["trace"]["cross_process_links"] = len(
        report["cross_process_links"])
    checks["trace_validated"] = (len(report["span_pids"]) >= 3
                                 and bool(report["cross_process_links"])
                                 and report["engine_slices"] >= 1)

    rc, stdout, stderr, _s = pilot["dry_run"]
    plan_records = json.loads(stdout) if rc == 0 else None
    rc2, stdout2, stderr2, _s2 = pilot["status"]
    status = json.loads(stdout2) if rc2 == 0 else None
    out["autopilot_s"] = pilot["seconds"]
    out["autopilot_plan"] = plan_records
    out["autopilot_status"] = status
    if rc or rc2:
        out["autopilot_stderr"] = (stderr or stderr2)[-2000:]
    checks["autopilot_dry_run_zero_actions"] = (
        isinstance(plan_records, list)
        and not any(r.get("outcome") == "applied" for r in plan_records))
    checks["autopilot_status"] = (
        isinstance(status, dict) and status.get("enabled") is False
        and status.get("audit") == [])
    checks["replica_untouched_by_autopilot"] = (
        serve.status()["llm_mesh"]["replicas"] == 1)

    # Delete: the idle gpu node goes; then down stops the up process.
    t = time.perf_counter()
    serve.delete("llm_mesh")
    left = _poll_until(gpu_nodes, lambda v: not v, LAUNCH_TIMEOUT_S)
    out["gpu_node_terminated_s"] = time.perf_counter() - t
    checks["idle_gpu_node_terminated"] = not left
    serve.shutdown()
    rt.shutdown()
    t = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    down = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "down", path],
        capture_output=True, text=True, timeout=120, cwd=root,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])})
    up_rc = up.proc.wait(timeout=60)
    out["down_s"] = time.perf_counter() - t
    out["down"] = {"rc": down.returncode, "stdout": down.stdout.strip(),
                   "up_rc": up_rc}
    checks["down_stopped_up"] = (
        down.returncode == 0 and up_rc == 0
        and f"terminated up process {up.proc.pid}" in down.stdout)
    # The up process's children while it served (the node's forkserver
    # and workers) are gone with it.
    out["processes_left"] = _poll_until(
        lambda: [p for p in tree if _alive(p)], lambda v: not v, 15.0)
    checks["teardown_clean"] = not out["processes_left"]
    out["checks"] = checks
    if kind == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 14
    return out


# ------------------------------------------------------------------- dag

# Llama-2-7B at full width (CUT_LAYERS layers) through a compiled DAG
# of two stage actors that share the card (each holds half of the GPU
# lease, as the pipeline phase's two stages do), half the layers a stage.
# Two warm-up items,
# then the window: microbatches of (1, 512) tokens, whose 4 MiB bf16
# hidden state fits the channel's 8 MiB slot, and of (2, 1024), whose
# 16 MiB take the RPC push. The phase runs on the card only; the CPU
# tests (``tests/test_torch_dag.py``) cover both paths at small shapes.
DAG = dict(n_stages=2, max_in_flight=4, warmup=2, n_small=6, n_big=2,
           seed=0, data_seed=22)
DAG_SHAPES = {"small": (1, 512), "big": (2, 1024)}
# The pipelined logits against ``llama.forward`` in this process on the
# same weights: max |difference| over max |value|. Both run the same bf16
# layers in the same order; the stage cut hands a bf16 hidden state
# across unchanged, so they differ only where the whole model's forward
# and the stage chain launch other kernels for the same sum (2^-7 is one
# bf16 rounding of the largest logit). The chained stage functions in
# this process must equal the pipelined logits to the last bit.
DAG_FORWARD_REL_TOL = 2.0 ** -7
# (b)'s workflow and (c)'s collectives.
DAG_COLLECTIVE_BYTES = 1 << 20
DAG_WORKERS = 4


def _dag_stage(cfg, index: int, n_stages: int, seed: int, device: str):
    """Stage ``index`` of the dag phase's pipeline, as its stage actor
    hosts it. At its first call it draws the whole model from ``seed`` on
    its card (13.5 GB at the 7B's peak), keeps its stage's layers
    (cloned, so the rest is freed) and wraps them in
    ``make_stage_worker``: its weights never travel in the stage's
    function blob. Takes the tokens (stage 0) or the previous stage's
    ``(tensor, meta)``; returns ``(its output, meta)`` with this call's
    window (monotonic clock, card-synced), flash launches (the wrapper's
    and the C entry's by kernel), thread and process."""
    state = {}

    def stage(x):
        import os
        import threading

        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops.flash_attention import flash_attention
        from ray_tpu_torch.ops.optim import tree_map
        from ray_tpu_torch.parallel.pipeline import (make_stage_worker,
                                                     split_llama_stages)

        meta = {}
        if index > 0:
            x, meta = x
        first = "call" not in state
        setup = time.monotonic()
        if first:
            full = llama.init_params(cfg, device=device, seed=seed)
            part, _fn = split_llama_stages(full, cfg, n_stages)[index]
            part = tree_map(lambda t: t.clone(), part)
            del full, _fn
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            state["call"] = make_stage_worker(cfg, index, n_stages, part,
                                              device=device)
        _sync(device)
        n0, k0 = flash_attention.launches, fwd_kernel_counts(device)
        t0 = time.monotonic()
        out = state["call"](x)
        _sync(device)
        t1 = time.monotonic()
        meta = {**meta, f"s{index}": {
            "window": (t0, t1), "first": first, "setup_s": t0 - setup,
            "launches": flash_attention.launches - n0,
            "by_kernel": fwd_kernels_since(k0, device),
            "thread": threading.get_ident(), "pid": os.getpid(),
            "grad": out.requires_grad, "device": str(out.device)}}
        return out, meta

    return stage


def _dag_tokens(cfg, shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape))


def _dag_reference(cfg, items, device) -> dict:
    """This process's reference on the card, before the stages start:
    the two stage functions chained (``split_llama_stages`` +
    ``make_stage_worker``, as the stages build them) and ``llama.forward``
    on the same weights, logits kept on the host; and the frame bytes of
    each item the first stage hands on (``build_frame``, the rule
    ``_PipeStage`` applies against the slot). The weights are freed
    after."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.pipeline import (make_stage_worker,
                                                 split_llama_stages)

    params = llama.init_params(cfg, device=device, seed=DAG["seed"])
    workers = [make_stage_worker(cfg, i, DAG["n_stages"], p, device=device)
               for i, (p, _fn) in enumerate(split_llama_stages(
                   params, cfg, DAG["n_stages"]))]
    chain, forward, frames = [], [], []
    with torch.no_grad():
        for seq, tokens in enumerate(items):
            h = workers[0](tokens)
            chain.append(workers[1](h).cpu())
            forward.append(llama.forward(
                params, torch.as_tensor(tokens, device=device), cfg).cpu())
            frames.append(serialization.build_frame(
                (seq, (h.cpu(), {})))[0])
    del params, workers, h
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"chain": chain, "forward": forward, "frames": frames}


def _dag_interleaved(metas) -> list:
    """For each consecutive pair: did stage 0 start item i+1 before stage
    1 finished item i? That is the ordering half of
    ``tests/test_dag.py``'s structural proof; its other half (stage 1
    started item i before stage 0 finished item i+1) asks the two windows
    to run at once, which two processes time-sliced on one card do not
    (their card-synced windows abut). Items one at a time never
    interleave: stage 0 gets item i+1 after item i's result is back."""
    return [b["s0"]["window"][0] < a["s1"]["window"][1]
            for a, b in zip(metas, metas[1:])]


def phase_dag(cfg) -> dict:
    """(a) Llama-2-7B through a compiled DAG of two stages sharing the
    card, (b) a workflow on CPU workers, (c) ActorPool, Queue and the
    host collectives, under one ``rt.init()``. See the module
    docstring."""
    import ray_tpu_torch as rt

    device = "cuda"
    gc.collect()
    torch.cuda.empty_cache()
    _runtime_init(device)
    try:
        return _dag(cfg, device)
    finally:
        if rt.is_initialized():  # a failure before the phase's teardown
            rt.shutdown()


def _dag(cfg, device) -> dict:
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker

    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    out, checks = {}, {}
    a, a_checks = _dag_pipeline(cfg, device)
    out["a"] = a
    checks.update({f"a_{k}": v for k, v in a_checks.items()})
    with tempfile.TemporaryDirectory(prefix="rtt_smoke_wf_") as tmp:
        b, b_checks = _dag_workflow(tmp)
    out["b"] = b
    checks.update({f"b_{k}": v for k, v in b_checks.items()})
    c, c_checks = _dag_util()
    out["c"] = c
    checks.update({f"c_{k}": v for k, v in c_checks.items()})
    out["launches"] = a.pop("launches")
    out["flash_fwd_by_kernel"] = a.pop("flash_fwd_by_kernel")
    chan_dir = os.path.join(config.object_store_fallback_dir,
                            "ray_tpu_torch", "channels")
    rt.shutdown()
    out["store_file_left"] = os.path.exists(store)
    out["processes_left"] = _poll_until(lambda: _live_node_pids(node_hex),
                                        lambda v: not v, 15.0)
    out["channel_files_left"] = sorted(
        f for f in (os.listdir(chan_dir) if os.path.isdir(chan_dir) else [])
        if f.startswith(a["run_id"]))
    checks["teardown_clean"] = (not out["store_file_left"]
                                and not out["processes_left"]
                                and not out["channel_files_left"])
    out["config"] = {"n_layers": cfg.n_layers, "dim": cfg.dim,
                     "attention_impl": cfg.attention_impl, **DAG}
    out["checks"] = checks
    out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 22
    return out


def _dag_pipeline(cfg, device):
    """(a): the reference in this process, then the DAG: compile, the
    warm-up items, the pipelined window, the same items one at a time,
    the channel's own count of the items it carried, ``teardown()``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import dag
    from ray_tpu_torch.core.channel import MutableChannel
    from ray_tpu_torch.core.config import config

    shapes = DAG_SHAPES
    n_small, n_big, n_warm = DAG["n_small"], DAG["n_big"], DAG["warmup"]
    warm = [_dag_tokens(cfg, shapes["small"], DAG["data_seed"] + i)
            for i in range(n_warm)]
    # The window interleaves the kinds: small, small, small, big, ...
    kinds = ["small"] * (n_small // 2) + ["big"] + \
        ["small"] * (n_small - n_small // 2) + ["big"] * (n_big - 1)
    window = [_dag_tokens(cfg, shapes[k], DAG["data_seed"] + 100 + i)
              for i, k in enumerate(kinds)]
    t = time.perf_counter()
    ref = _dag_reference(cfg, window, device)
    res = {"reference_s": time.perf_counter() - t, "kinds": kinds,
           "shapes": {k: list(v) for k, v in shapes.items()}}
    capacity = config.dag_channel_capacity_bytes
    res["slot_bytes"] = capacity
    res["frame_bytes"] = ref["frames"]
    fits = [f <= capacity for f in ref["frames"]]
    res["bytes_by_path"] = {
        "channel": sum(f for f, ok in zip(ref["frames"], fits) if ok),
        "rpc": sum(f for f, ok in zip(ref["frames"], fits) if not ok)}
    stage_fns = [rt.remote(_dag_stage(
        cfg, i, DAG["n_stages"], DAG["seed"], device)).options(**PIPE_SHARE)
        for i in range(DAG["n_stages"])]
    reset_counts()
    driver0 = fwd_kernel_counts(device)
    t_compile = time.perf_counter()
    with dag.InputNode() as inp:
        node = inp
        for fn in stage_fns:
            node = fn.bind(node)
    pipe = node.experimental_compile(max_in_flight=DAG["max_in_flight"])
    res["compile_s"] = time.perf_counter() - t_compile
    res["run_id"] = os.path.basename(pipe._channel_paths[0]).split("-e")[0] \
        if pipe._channel_paths else ""
    try:
        futs = [pipe.execute(x) for x in warm]
        warm_out = [futs[0].result(timeout=600)]
        res["compile_to_first_result_s"] = time.perf_counter() - t_compile
        warm_out += [f.result(timeout=600) for f in futs[1:]]
        # The window, pipelined: every item in flight at once.
        t = time.perf_counter()
        futs = [pipe.execute(x) for x in window]
        piped = [f.result(timeout=600) for f in futs]
        res["pipelined_s"] = time.perf_counter() - t
        driver_launches = launch_counts()
        driver_kernels = fwd_kernels_since(driver0, device)
        # The same items, one at a time through the same DAG.
        t = time.perf_counter()
        serial = [pipe.execute(x).result(timeout=600) for x in window]
        res["serial_s"] = time.perf_counter() - t
        chan = MutableChannel(pipe._channel_paths[0])
        res["channel_items"] = chan.write_seq
        chan.close()
        paths = list(pipe._channel_paths)
    finally:
        pipe.teardown()
    res["channel_files_left"] = [p for p in paths if os.path.exists(p)]
    n = len(window)
    res["items_per_s"] = {"pipelined": n / res["pipelined_s"],
                          "one_at_a_time": n / res["serial_s"]}
    res["speedup"] = res["serial_s"] / res["pipelined_s"]
    metas = [m for _o, m in piped]
    stages = [f"s{i}" for i in range(DAG["n_stages"])]
    res["stage_ms"] = {s: [1e3 * (m[s]["window"][1] - m[s]["window"][0])
                           for m in metas] for s in stages}
    res["first_call_s"] = {s: [(m[s]["setup_s"],
                                m[s]["window"][1] - m[s]["window"][0])
                               for _o, m in warm_out if m[s]["first"]]
                           for s in stages}
    res["interleaved"] = {"pipelined": _dag_interleaved(metas),
                          "one_at_a_time": _dag_interleaved(
                              [m for _o, m in serial])}
    t_first = min(m["s0"]["window"][0] for m in metas)
    res["windows_ms"] = {s: [[round(1e3 * (w - t_first), 3)
                              for w in m[s]["window"]] for m in metas]
                         for s in stages}
    all_metas = [m for _o, m in warm_out + piped + serial]
    res["threads"] = {s: len({m[s]["thread"] for m in all_metas})
                      for s in stages}
    res["pids"] = {s: sorted({m[s]["pid"] for m in all_metas})
                   for s in stages}
    per_item = [[m[s]["launches"] for s in stages] for m in metas]
    by_kernel = {}
    for m in metas:
        for s in stages:
            for k, v in m[s]["by_kernel"].items():
                by_kernel[k] = by_kernel.get(k, 0) + v
    flash = sum(sum(x) for x in per_item)
    res["launches"] = {**{k: 0 for k in KERNELS}, "flash_fwd": flash}
    res["flash_fwd_by_kernel"] = by_kernel
    res["driver_launches"] = driver_launches
    # Compared after the one-at-a-time run: the window's results must
    # outlive their objects while later items take the store's bytes.
    logits = [o for o, _m in piped]
    res["forward_max_rel"] = [_max_rel(g.float(), w.float()) for g, w in
                              zip(logits, ref["forward"])]
    layers = cfg.n_layers // DAG["n_stages"]
    checks = {
        "equal_to_chain": all(torch.equal(g, w) for g, w in
                              zip(logits, ref["chain"])),
        "one_at_a_time_equal": all(torch.equal(g, w) for (g, _m), w in
                                   zip(serial, ref["chain"])),
        "within_forward": all(e <= DAG_FORWARD_REL_TOL
                              for e in res["forward_max_rel"]),
        "finite_shapes": all(
            bool(torch.isfinite(o).all()) and tuple(o.shape)
            == tuple(shapes[k]) + (cfg.vocab_size,)
            for o, k in zip(logits, kinds)),
        "flash_per_stage_item": all(x == [layers] * DAG["n_stages"]
                                    for x in per_item),
        "flash_on_wgmma": all_on_wgmma(by_kernel, flash, device),
        "no_kernel_in_driver": (not any(driver_launches.values())
                                and not any(driver_kernels.values())),
        "stages_own_processes": (
            all(len(p) == 1 for p in res["pids"].values())
            and len({p[0] for p in res["pids"].values()})
            == DAG["n_stages"]
            and os.getpid() not in {p[0] for p in res["pids"].values()}),
        "stages_on_device": all(
            m[s]["device"].startswith(torch.device(device).type)
            and not m[s]["grad"] for m in all_metas for s in stages),
        "drain_thread_runs_every_call": res["threads"]["s1"] == 1,
        "windows_interleave": (any(res["interleaved"]["pipelined"])
                               and not any(
                                   res["interleaved"]["one_at_a_time"])),
        "both_paths_carry_items": (
            any(fits) and not all(fits)
            and all(f == (k == "small") for f, k in zip(fits, kinds))),
        "channel_counted_its_items": res["channel_items"]
        == n_warm + 2 * sum(fits),
        "no_channel_file_left": not res["channel_files_left"],
    }
    return res, checks


def _wf_count(marks: str, name: str) -> int:
    """One more run of step ``name``, counted in a marker file."""
    path = os.path.join(marks, name)
    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))
    return n + 1


def _wf_load(n, marks):
    _wf_count(marks, "load")
    return list(range(n))


def _wf_square(xs, marks):
    _wf_count(marks, "square")
    return [x * x for x in xs]


def _wf_total(xs, marks, fail_once):
    """Fails on its first run when ``fail_once`` (the marker file guards
    it), as a crash mid-workflow."""
    if _wf_count(marks, "total") == 1 and fail_once:
        raise RuntimeError("interrupted")
    return sum(xs)


def _wf_plan(total, marks):
    """A dynamic step: the rest of the workflow is a continuation."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    _wf_count(marks, "plan")
    return workflow.continuation(rt.remote(_wf_label).bind(total, marks))


def _wf_label(total, marks):
    _wf_count(marks, "label")
    return {"total": total}


def _dag_workflow(tmp: str):
    """(b): three steps and a continuation, stored under ``tmp``. The
    third step raises on its first run; ``resume`` finishes the workflow.
    The same workflow uninterrupted gives the reference result."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    def build(marks, fail_once):
        os.makedirs(marks)
        step = rt.remote(max_retries=0)
        with InputNode() as inp:
            xs = step(_wf_load).bind(inp, marks)
            sq = step(_wf_square).bind(xs, marks)
            tot = step(_wf_total).bind(sq, marks, fail_once)
            return step(_wf_plan).bind(tot, marks)

    def runs(marks):
        return {n: int(open(os.path.join(marks, n)).read())
                for n in sorted(os.listdir(marks))}

    res = {}
    storage, marks = os.path.join(tmp, "store"), os.path.join(tmp, "marks")
    wf = build(marks, fail_once=True)
    t = time.perf_counter()
    try:
        workflow.run(wf, workflow_id="smoke", storage=storage, args=100)
        res["interrupted"] = False
    except Exception as e:  # noqa: BLE001 - the interruption is the point
        res["interrupted"] = "interrupted" in str(e)
    res["run_s"] = time.perf_counter() - t
    res["status_after_failure"] = workflow.get_status("smoke",
                                                      storage=storage)
    res["runs_after_failure"] = runs(marks)
    t = time.perf_counter()
    res["result"] = workflow.resume("smoke", storage=storage)
    res["resume_s"] = time.perf_counter() - t
    res["status"] = workflow.get_status("smoke", storage=storage)
    res["again"] = workflow.resume("smoke", storage=storage)
    res["runs"] = runs(marks)
    ref_marks = os.path.join(tmp, "ref_marks")
    t = time.perf_counter()
    res["uninterrupted"] = workflow.run(
        build(ref_marks, fail_once=False), workflow_id="smoke-ref",
        storage=os.path.join(tmp, "ref_store"), args=100)
    res["uninterrupted_s"] = time.perf_counter() - t
    want = {"total": sum(x * x for x in range(100))}
    checks = {
        "interrupted_then_failed": (res["interrupted"] is True
                                    and res["status_after_failure"]
                                    == "FAILED"),
        "resumed_equals_uninterrupted": (res["result"] == res["again"]
                                         == res["uninterrupted"] == want
                                         and res["status"] == "SUCCEEDED"),
        # The failed step ran again; no finished step did.
        "no_finished_step_rerun": (
            res["runs_after_failure"] == {"load": 1, "square": 1,
                                          "total": 1}
            and res["runs"] == {"label": 1, "load": 1, "plan": 1,
                                "square": 1, "total": 2}),
    }
    return res, checks


class _DagSquarer:
    def square(self, x):
        time.sleep(0.002 * (x % 3))  # finish out of order
        return x * x


class _DagMember:
    """One rank of (c)'s host collective group."""

    def __init__(self, name: str, world: int, rank: int):
        from ray_tpu_torch.util import collective

        self.group = collective.init_collective_group(name, world, rank)
        self.rank = rank

    def run(self, nbytes: int) -> dict:
        g = self.group
        x = np.full(nbytes // 4, self.rank + 1, np.float32)
        g.barrier()  # every member up before the timed ops
        out, times = {}, {}
        for op, fn in (
                ("allreduce", lambda: g.allreduce(x, "sum")),
                ("allgather", lambda: g.allgather(x)),
                ("broadcast", lambda: g.broadcast(
                    x * 10 if self.rank == 0 else None, src_rank=0)),
                ("barrier", g.barrier)):
            t = time.perf_counter()
            val = fn()
            times[op] = time.perf_counter() - t
            if op == "allreduce":
                out[op] = bool((val == sum(range(1, g.world_size + 1))).all())
            elif op == "allgather":
                out[op] = [float(v[0]) for v in val] == [
                    float(r + 1) for r in range(g.world_size)] and all(
                    v.nbytes == nbytes for v in val)
            elif op == "broadcast":
                out[op] = bool((val == 10.0).all())
        return {"ok": out, "s": times}


def _dag_produce(q, n: int) -> int:
    for i in range(n):
        q.put(i, timeout=60)
    return n


def _dag_consume(q, n: int) -> list:
    return [q.get(timeout=60) for _ in range(n)]


def _dag_util():
    """(c): ``ActorPool`` over 4 CPU actors, a ``Queue(maxsize=4)``
    between a producer task and a consumer task, and the host collectives
    over 4 CPU actors on a 1 MiB array."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import ActorPool, Queue, collective

    res, checks = {}, {}
    n = DAG_WORKERS
    actors = [rt.remote(_DagSquarer).options(num_cpus=0).remote()
              for _ in range(n)]
    rt.get([a.square.remote(0) for a in actors], timeout=120)  # started
    pool = ActorPool(actors)
    t = time.perf_counter()
    got = list(pool.map(lambda a, v: a.square.remote(v), range(32)))
    res["map_s"] = time.perf_counter() - t
    checks["pool_map_in_order"] = got == [v * v for v in range(32)]
    t = time.perf_counter()
    unordered, pending = [], list(range(32))
    while pending or pool.has_next():
        while pending and pool.has_free():
            pool.submit(lambda a, v: a.square.remote(v), pending.pop(0))
        unordered.append(pool.get_next_unordered(timeout=60))
    res["unordered_s"] = time.perf_counter() - t
    res["unordered_in_order"] = unordered == [v * v for v in range(32)]
    checks["pool_unordered_complete"] = sorted(unordered) == \
        [v * v for v in range(32)]
    for a in actors:
        rt.kill(a)

    q = Queue(maxsize=4)
    t = time.perf_counter()
    # Two tasks of one resource shape share a worker lease, so the second
    # would wait for the first to end: the consumer takes another shape.
    prod = rt.remote(_dag_produce).remote(q, 64)
    cons = rt.remote(_dag_consume).options(num_cpus=2).remote(q, 64)
    got = rt.get(cons, timeout=120)
    res["queue_s"] = time.perf_counter() - t
    checks["queue_fifo_between_tasks"] = (got == list(range(64))
                                          and rt.get(prod, timeout=60) == 64)

    collective.create_collective_group("smoke", n)
    members = [rt.remote(_DagMember).options(num_cpus=0).remote(
        "smoke", n, r) for r in range(n)]
    t = time.perf_counter()
    outs = rt.get([m.run.remote(DAG_COLLECTIVE_BYTES) for m in members],
                  timeout=300)
    res["collectives_s"] = time.perf_counter() - t
    res["collective_op_s"] = {op: max(o["s"][op] for o in outs)
                              for op in outs[0]["s"]}
    checks["collectives_correct"] = all(all(o["ok"].values())
                                        and len(o["ok"]) == 3 for o in outs)
    for m in members:
        rt.kill(m)
    return res, checks


def _poll_until(fn, done, timeout_s: float = 20.0):
    """``fn()`` once ``done`` holds for it, or its last value at the
    deadline."""
    deadline = time.monotonic() + timeout_s
    val = fn()
    while not done(val) and time.monotonic() < deadline:
        time.sleep(0.25)
        val = fn()
    return val


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def count_gpu_processes() -> list:
    """Record every GPU worker process the runtime starts from here on:
    each worker handle a node's ``_fork_worker`` returns with ``gpu`` set
    (the node's own mark of a fresh interpreter spawned with its leased
    cards visible) adds its pid to the returned list. Nodes live in this
    process (``rt.init()`` and ``cluster_utils.Cluster``), so every GPU
    lease of every phase passes here."""
    from ray_tpu_torch.core.node import Node

    started: list = []
    fork = Node._fork_worker

    def counted(self, *args, **kwargs):
        handle = fork(self, *args, **kwargs)
        if handle.gpu:
            started.append(handle.proc.pid)
        return handle

    Node._fork_worker = counted
    return started


# ----------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lint = LintRun()
    try:
        return _run_phases(lint)
    finally:
        lint.close()


def _run_phases(lint: LintRun) -> int:
    from ray_tpu_torch.models import llama, vit

    record: dict = {}
    results: dict = {}
    paths: dict = {}
    by_kernel: dict = {}
    bwd_by_kernel: dict = {}
    started = count_gpu_processes()
    gpu_by_phase: dict = {}
    serve_cfg = replace(llama.PRESETS["7b"], attention_impl="flash")
    # The later serve and runtime phases' 7B: its first CUT_LAYERS layers.
    cut_cfg = replace(serve_cfg, n_layers=CUT_LAYERS)
    train_cfg = replace(llama.PRESETS["1b"], attention_impl="flash",
                        remat=True, remat_policy="full", loss_chunk=512)
    for name, fn in (("env", phase_env), ("build", phase_build),
                     ("lint", lambda: phase_lint(lint)),
                     ("kernels", lambda: phase_kernels(record)),
                     ("splash", lambda: phase_splash(record)),
                     ("serve", lambda: phase_serve(serve_cfg)),
                     ("serve_paged", lambda: phase_serve_paged(cut_cfg)),
                     ("serve_spec", lambda: phase_serve_spec(cut_cfg)),
                     ("serve_disagg",
                      lambda: phase_serve_disagg(cut_cfg)),
                     ("serve_runtime",
                      lambda: phase_serve_runtime(cut_cfg)),
                     ("serve_mesh", lambda: phase_serve_mesh(cut_cfg)),
                     ("train", lambda: phase_train(train_cfg)),
                     ("train_runtime",
                      lambda: phase_train_runtime(train_cfg)),
                     ("vit", lambda: phase_vit(vit.PRESETS["vit_b16"])),
                     ("data_train", lambda: phase_data_train(
                         train_cfg, results["train"],
                         vit.PRESETS["vit_b16"],
                         results["vit"].get("images_per_s"))),
                     ("rl", phase_rl),
                     ("mesh", lambda: phase_mesh(train_cfg)),
                     ("rl_dist", phase_rl_dist),
                     ("gang", lambda: phase_gang(
                         cut_cfg,
                         results["serve_runtime"]["handle_streams"])),
                     ("cluster", lambda: phase_cluster(
                         cut_cfg,
                         results["serve_runtime"]["handle_streams"])),
                     ("pipeline", lambda: phase_pipeline(train_cfg)),
                     ("dag", lambda: phase_dag(cut_cfg)),
                     ("launcher_mesh", lambda: phase_launcher_mesh(
                         cut_cfg,
                         results["serve_runtime"]["handle_streams"]))):
        t0 = time.perf_counter()
        n_started = len(started)
        try:
            res = fn()
        except Exception:
            emit({"phase": name, "ok": False,
                  "error": traceback.format_exc()})
            return 1
        # GPU workers of a cluster whose nodes live in another process
        # (launcher_mesh's ``up``), found by the card files they hold.
        started.extend(res.get("up_gpu_pids", []))
        gpu_by_phase[name] = len(started) - n_started
        res = {"phase": name, "ok": res.pop("ok", True),
               "seconds": time.perf_counter() - t0,
               "gpu_processes_started": gpu_by_phase[name], **res}
        emit(res)
        if not res["ok"]:
            return 1
        results[name] = res
        if name in PATH_KERNELS:
            paths[name] = res["launches"]
            for k, n in res.get("flash_fwd_by_kernel", {}).items():
                by_kernel[k] = by_kernel.get(k, 0) + n
            for k, n in res.get("flash_bwd_by_kernel", {}).items():
                bwd_by_kernel[k] = bwd_by_kernel.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
    # Each main path's counts were zeroed right before it and read right
    # after it; a kernel counts the launches of every path.
    launches = {k: sum(p.get(k, 0) for p in paths.values()) for k in KERNELS}
    missing = [k for k in KERNELS if launches[k] < 1]
    missing += [f"{k} on the {p} path" for p, want in PATH_KERNELS.items()
                for k in want if paths[p].get(k, 0) < 1]
    if missing:
        emit({"phase": "launches", "ok": False, "not_launched": missing})
        return 1
    # The forward's launches on the serve and train paths by the kernel
    # its C entry launched (every one bf16, so all on wgmma).
    record["flash_fwd"]["launches_by_kernel"] = by_kernel
    # The backward's launches on the train path by the kernel its C entries
    # launched (every one bf16, so all on wgmma).
    for name, prefix in (("flash_bwd_dkv", "dkv_"), ("flash_bwd_dq", "dq_")):
        record[name]["launches_by_kernel"] = {
            k: n for k, n in bwd_by_kernel.items() if k.startswith(prefix)}
    emit({"gpu_processes": {"by_phase": gpu_by_phase,
                            "total": len(started)}})
    emit({"kernels": [
        {"name": k, **KERNELS[k], "launches": launches[k], **record[k]}
        for k in KERNELS]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
