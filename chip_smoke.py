"""End-to-end proof that the PyTorch/CUDA port (``ray_tpu_torch``)
builds, serves and trains on one NVIDIA GPU (written for an H100,
sm_90a).

    python3 chip_smoke.py [--seed N] [--out results.json] [--only 4j|4k]

Run from the root of a checkout; it needs one CUDA device, ``nvcc``
and nothing else of the repo than ``ray_tpu_torch``. Phases, each of
which raises on failure, run in the order 1, 3, 4, 4b, 4c, 4d, 4e, 4f, 4g,
4h, 4j, 4k, 4i, 8, 2, 5, 6, 6b, 7, 7b, 7c, then 4d's profile (``--only 4j``
or ``--only 4k``: phase 1's build, then that phase alone, and no result
lines): the host-timed
serving phases come before any torch.profiler session, since a process
that has run one launches kernels at a higher host cost for the rest of
its life.

1. Device report: name, count, and ``nvidia-smi``'s name and power
   limit. Builds the port's CUDA sources (K1 and K2, each with its
   tensor-core split pass for bf16 q, the scalar fp32 K3-K5 and the
   tensor-core bf16 K3-K5 with their delta pass) with nvcc, one process
   per source, all started together, checks that ptxas reported every
   tensor-core kernel at D 64 and 128 (K1's and K2's at each split size
   they take), and prints their registers, spills and ptxas's
   performance warnings.
2. Every kernel against its plain PyTorch version on the card: K1
   (``paged_decode_attention``) in fp32 over head_dim 64/128 and GQA
   groups 1/4/8 (tolerance 1e-4), with pos 0, a full window and
   null-page slots; the same cases in bf16 (4e-3 + one bf16 ulp,
   2^-7, of the value: both round an fp32 result to bf16 once, and
   the tensor-core pass also rounds P to bf16); in fp32 and bf16 at
   the TinyLlama-1.1B decode shape with positions on each side of the
   split-K boundaries; then at that shape in bf16 on random positions.
   torch.profiler's kernel names show every bf16 K1 call on the
   tensor-core pass (``split_sm90`` over bf16 pages) and every fp32 one
   on the scalar template. Then K2 (int8 pages with per-page scales:
   pages from integers(-127, 128), scales from uniform(0.1, 2.0)) in
   the same cases, fp32 q at 1e-4 on the scalar template and bf16 q at
   4e-3 + 2^-7·|ref| on the tensor-core pass over int8 pages. No call
   launches a merge kernel: the splits merge inside the one launch.
   Then 2 decode steps on phase 4's pool run the tensor-core pass over
   bf16 pages in every layer, and 2 on phase 4b's the one over int8
   pages. Times each kernel, its
   plain version and one library call (SDPA over the window gathered
   beforehand — for K2 gathered and dequantized to bf16 — a yardstick
   the port never calls) with CUDA events, L2 flushed before each
   launch, and computes each kernel's bound from this run's inputs.
3. Engine on the card against the engine on the CPU: one reduced fp32
   model with the same weights on both, 4 prompts on and off page
   boundaries, 16 greedy tokens each — the streams must be identical.
   Then the same with ``kv_dtype="int8", prefix_cache=True`` (K2 on
   the card) over three waves: the 4 prompts, the 16-token prompt
   again (fully cached and page-aligned: the copy-on-write path), and
   a prompt sharing the 45-token prompt's first page — identical
   streams, 2 hit admissions, both engines leak-free (allocator
   occupancy equals the cache's pages, tree invariants hold). Then the
   engine's loops and lanes, card vs CPU, on the fp and on the int8
   pool: the 4 prompts and a repetitive one (an 8-token block x 4), 24
   greedy tokens, an eos that the lockstep stream of the first prompt
   first emits mid-stream, for ``overlap`` False and True x
   ``spec_len`` 0 and 4 (``spec_ngram`` 1): on the fp pool identical
   streams in every mode, also equal to the lockstep streams without
   speculation; on the int8 pool identical, or parting at a near-tie
   (at the first differing token both devices' tokens within 0.1 of
   the top logit, teacher-forced on the CPU over a fresh int8 pool: the
   two pools' bytes differ by one int8 step here and there, since a
   last-bit difference of an fp32 K or V value flips ``round``); the
   verify run on the card in both pools. Then the overlapped loop's
   stale path on the card: each decode dispatch queued behind a ~50 ms
   spin kernel (the card behind the host, as in a device-bound step;
   decode chunk 2), spec_len 0 and 4: ``fetchq_depth`` reaches 2 (at most 2 with
   speculation) and the streams equal the CPU's lockstep ones. And
   ``capture_logprobs=True``: the same streams, logprobs within 1e-4
   and as many as tokens. Then the same ``FaultInjector`` plans on both
   devices: a fault at the prefill, the decode and the spec (spec_len
   4) dispatch, a readback fault, 2 rounds of allocator exhaustion, a
   plan that exhausts ``max_retries``, a lone slot a donor pin starves,
   and batch rollouts an online burst preempts (fp and int8 pools):
   the same failed requests and error types, the same survivor streams
   (int8: or a near-tie parting), the same ``lifecycle_stats()``, both
   engines quiesced (``check_quiesced``). Then, with every readback
   taken in the round the CPU takes it (the readiness probe answers
   True, so the card blocks on each copy), a pool of two engines whose
   requests are all routed before the first round and whose replica 0
   a ``kill_replica`` plan takes down at its round 6: the same routes,
   the same requests resubmitted or failed typed ``EngineShutdown``,
   the same streams and pool events; and one engine with a contained
   decode fault and ``flight_dir``: the same event log (kinds,
   requests, slots, data but times), ``sched_trace`` and flight-bundle
   culprit. Then a disaggregated pool of one prefill and one decode
   engine (16-token pages, the prefix cache), every first leg submitted
   before any stream is read: the same streams, pool events, 8
   handoffs, and a pull of each prompt's full pages. Then, routed as in
   the kill case, a ``hang`` at replica 0's step in its round 6 under a
   ``PoolWatchdog`` (stall deadline 1 s): the same suspect -> wedged ->
   death sequence, the streamed requests failed typed, the others
   resubmitted with the same streams, the released zombie committing
   nothing (a suspect -> recovered false alarm of the survivor, which
   a resubmit can wake from idle, is allowed on either device). Then the
   same model and prompts through the static-cache loops: greedy
   ``generate`` (16 new tokens) identical on the card and on the CPU,
   and ``generate_stream`` (chunk 8) identical to ``generate``.
4. The main path at full width: ``LlamaDeployment`` with the
   TinyLlama-1.1B config (bf16, random weights from ``--seed``),
   16 slots, 64-token pages. After one warm-up request it answers 16
   requests (prompts of 16-1536 tokens, 64 new tokens each; 4 through
   ``stream``, 12 through ``generate_batch``) and checks every request
   got 64 tokens, that K1 was launched once per layer on every decode
   step and K2 never, and, teacher-forced through the T > 1 gather
   path, that each generated token of 2 requests is the top logit or
   within 0.05 of it, both in bf16 and with the same bf16 weights
   evaluated in fp32.
   Prints output tok/s, TTFT p50, time
   per output token p50 (the streamed requests) and ms per decode step
   beside the card's name and power limit.
4b. The int8 KV + prefix-cache main path at full width:
   ``LlamaDeployment(tinyllama_1_1b(), kv_dtype="int8",
   prefix_cache=True)``, 16 slots, 64-token pages, 513 pages (full
   residency), bf16 random weights from ``--seed``, one warm-up
   request. Two waves of 8 requests, 64 new tokens each, the second
   submitted after the first finished: 4 prompts behind one shared
   1024-token system prompt (own 16-512-token tails), page-aligned
   prompts of 512 and 1024 tokens, 2 random 16-1536-token prompts;
   then 4 more behind the system prompt, exact repeats of the two
   page-aligned prompts (the COW path) and 2 random ones; 4 of wave 1
   through ``stream``. Checks every request got 64 tokens, K2 launched
   once per layer on every decode step and K1 never, wave 2's hit
   tokens equal to the count computed from the prompts (4 x 1024 +
   511 + 1023 = 5630) over 6 hit admissions, the pool leak-free at
   quiescence, and, teacher-forced, that each generated token of 2
   wave-2 requests (a prefix hit and a COW repeat) is within 0.1 of
   the top logit, both for the bf16 weights evaluated in fp32 over an
   fp pool and for the bf16 model over a fresh int8 pool. Prints
   output tok/s, TTFT p50 of each wave, ms per decode step on the int8
   pool, the pool's page and total bytes against an fp pool's, and the
   hit tokens.
4c. The non-engine serving path at full width:
   ``LlamaDeployment(tinyllama_1_1b(), use_engine=False)``, bf16 random
   weights from ``--seed``, 64 new tokens, one warm-up request:
   ``__call__`` on a 512-token prompt, ``stream`` on the same prompt
   (its tokens must equal ``__call__``'s), ``generate_batch`` on 4
   prompts of 512 tokens and 2 of 300 (two buckets). Teacher-forced,
   as phase 4, each generated token of 3 requests (one per bucket and
   the ``__call__``) within 0.05 of the top logit, in bf16 and with the
   bf16 weights in fp32. Prints the batch's tok/s and ms per streamed
   token beside the card's name and power limit.
4d. The engine's default loop at full width: TinyLlama-1.1B bf16
   (random weights from ``--seed``) through ``LlamaDeployment``, 16
   slots, 64-token pages, 64 new tokens; one wave of 16 requests, each
   streamed by its own thread: 8 repetitive prompts (a 64-256-token
   block repeated to 512-1536 tokens, as in code-edit and extraction
   traffic) and 8 random ones of 16-1536 tokens. The eos is the token
   of a warm-up run of the wave without one that the most streams hold
   (then the most often). The wave runs three ways: ``overlap=False``,
   ``overlap=True``, and ``overlap=True, spec_len=4``. Checks: every
   stream ends at its first eos or at 64 tokens, at least 4 end early;
   K1 launched once per layer on every decode-lane step and K2 never;
   ``fetchq_depth`` (``load_report``'s, read right after each decode
   dispatch) at most 2, its maximum recorded (the card finishes each
   dispatch before the host plans the next round here, so the
   overlapped arm holds one; phase 3 shows it holding two when the
   card lags); the speculative arm verified and accepted drafts; teacher-forced through the gather
   path, every token of the 2 longest speculative repetitive streams
   within 0.05 of the top logit, in bf16 and with the bf16 weights in
   fp32. Prints output tok/s, TTFT p50, time per output token p50,
   decode-lane and verify dispatches, and for the speculative arm
   ``accept_rate`` and ``tokens_per_dispatch``, beside the card's name
   and power limit. Then 4 requests (2 repetitive, 2 random, the eos
   on) through ``LLMEngine(capture_logprobs=True)``: as many logprobs
   as tokens, each within 0.05 of the teacher-forced fp32
   ``log_softmax`` of the served bf16 model (and the distance to the
   same weights in fp32 printed). After phase 7b (no profiler session
   may precede a timed phase), torch.profiler's device time of one
   verify dispatch (16 rows x 5 tokens) against one decode step, on a
   fresh model and pool of this shape.
4e. Cross-replica KV pull and the hot weight swap at full width (phases
   4e-4h run TinyLlama-1.1B's widths at 6 of its 22 layers,
   ``EARLIER_POOL_LAYERS``, as 4i (b)-(d) and 8, so that the script
   keeps inside its time limit on a slow host): one TinyLlama-1.1B bf16 model
   (random weights from ``--seed``) shared by two ``LLMEngine``s on the
   card, each with 16 slots, 64-token pages, 513 pages and the prefix
   cache, once with an fp pool and once with an int8 pool. The donor
   serves phase 4b's first wave (its 1024-token
   system prompt behind 4 of the 8). A fresh requester (warmed by one
   request) gets a request over that system prompt with a pull hint
   (its 16 ``path_hashes``) beside 4 background requests of 300-1200
   tokens, and once the pulled request's first token is out, 7 more
   over the system prompt with distinct tails (hints too); its
   ``kv_fetcher`` is ``pull_prefix`` over ``loopback_call(KVDonor)``,
   the JSON + base64 wire. Checks: 16 pages land, the requester's
   re-export of them equals the donor's export byte for byte, one pull
   with no abort or fallback, the 7 hit >= 7 x 1024 tokens locally with
   no second pull, K1 (fp) or K2 (int8) launched once per layer on
   every decode step of the requester and the other never, every
   stream complete, the pulled request's tokens teacher-forced within
   0.05 of the top logit in bf16 (over a pool of its dtype) and with
   the bf16 weights in fp32 (int8: 0.1, as phase 4b). Then the pulled
   request alone on fresh requesters: with the default chunks, in 4
   chunks (``max_chunk_bytes`` of 4 pages), and one page a chunk
   through ``FaultyTransport(drop_p=0.15, dup_p=0.3)`` seeded with
   ``--seed`` + 0..3 (drops and duplicates must both strike), each of
   which lands the donor's bytes or falls back, counted; the donor ends with
   no open transfer and no pinned page. Prints, beside the card's name
   and power limit, the pull's host ms split into export, encode and
   decode (re-timed on the pull's bytes as one chunk), the rest of the
   wire and landing, the wire bytes and MB/s, the pulled request's
   TTFT against the same prompt cold on a fresh requester, beside the
   same background and alone, the background's TTFTs in both, and the
   export of the 16 pages on an idle card one synchronous copy per page
   column against the engine's one batched copy (the bytes equal). On
   the fp requester, a preempt-mode swap to the same tensors staged
   from the host under a new ``weights_id`` in the middle of 4 streams
   of 512 tokens: streams complete, ``weight_generation`` 1, >= 16
   pages evicted, every stream's bf16 tokens teacher-forced within
   0.05; the same 4 streams run unswapped on a fresh requester, teacher-
   forced too. Prints the staging ms, the flip's pause (engine lock
   held), peak device memory, both runs' gaps per stream and where
   each swapped stream first parts from its unswapped twin. Last, at phase 3's reduced fp32 width: a pull's streams
   equal a cold recompute on the card and on the CPU (int8: or part at
   a near-tie, as phase 3), a preempt swap of the same tensors leaves
   the streams unchanged, and after a drain swap to other weights the
   request in flight ends on the old weights and the next equals a
   fresh engine on the new ones.
4f. The engine's fault containment, lanes and wedge handling at full
   width: TinyLlama-1.1B bf16 (random weights from ``--seed``), 16
   slots, 64-token pages, 513 pages, one warm-up request each engine.
   (a) fp pool, default loop: phase 4's 16 prompts, 64 new tokens,
   unfaulted, then with a prefill fault on slot 8, a decode fault on
   slot 5, a readback fault on slot 11, 2 rounds of allocator
   exhaustion, a slow step that blows slot 0's 1 s deadline mid-decode
   and a client cancel of slot 1 mid-decode (both at round boundaries,
   on the scheduler thread). Checks: exactly those 5 fail, each typed;
   the 11 others get 64 tokens; retries >= 1; 2 requeued streams
   teacher-forced within 0.05 (bf16, and the weights in fp32); K1 22 x
   the decode steps, K2 never; quiesced. Prints where each survivor
   first parts from its unfaulted twin, tok/s and survivor TTFT p50 of
   both waves, each faulted round's wall against the median round, and
   ``lifecycle_stats()``. Then a ``kill_replica`` plan: every request
   fails with ``ReplicaKilled``, the engine stops, leak-free. (b) int8
   pool + prefix cache: 8 online requests (16-1024 tokens, 64 new)
   alone, then on a cold cache 24 rollouts (``submit_rollout_batch``,
   512-token prompts, 128 new) and the same 8 once 16 rollouts stream.
   Checks: batch preemptions, every request complete, no rollout
   admitted between the burst and an online request's admission, 2
   preempted rollouts teacher-forced within 0.1 (bf16 over an int8
   pool, and fp32), K2 22 x the decode steps, K1 never, quiesced.
   Prints online TTFT p50 with the backlog and idle, batch tok/s,
   ``batch_tokens``, batch preemptions. (c) A ``hang`` at the decode
   dispatch of (b)'s engine with 4 streams reading: ``load_report``
   within 50 ms with a growing ``heartbeat_age_s``, a submit shed
   (``admit_timeout_s`` 0.2) in < 0.5 s, ``force_kill`` unblocking
   every reader with ``EngineShutdown`` in < 1 s, the released zombie
   committing no token and leaving the prefix cache as it was, and a
   second ``shutdown()`` leak-free; prints those times.
4g. The event log and the engine pool at full width: TinyLlama-1.1B
   bf16 (random weights from ``--seed``), 16 slots, 64-token pages, 513
   pages per engine, one warm-up request each. (a) 8 of phase 4's
   prompts x 64 new tokens through one engine with ``events=True``,
   ``events=False`` and ``events=True`` again: tok/s and TTFT p50 of
   each arm and ``EventLog.append``'s host ns per event; every request's
   events run submit -> admit -> first_token -> retire, its
   ``request_phases`` TTFT equals the handle's within 1 ms, the Chrome
   trace loads as JSON, ``serve_phase_inter_token_s`` counts one
   observation per emit event but each request's first; then a decode
   fault with ``flight_dir``: the bundle is written and names the
   culprit. (b) ``LlamaDeployment(num_engine_replicas=2,
   prefix_cache=True)``: 8 sessions (own 512-token system prompts) x 3
   turns (a 32-token message, 32 new tokens), a thread per request in
   session order, against one engine on the same trace: tok/s, TTFT
   p50, 16 affinity hits and the hit tokens ``_expected_hits`` computes,
   routes per replica. Then 4 more messages per session, with replica
   1 holding its rounds until the wave is routed and a
   ``kill_replica`` armed at the first round boundary at which part of
   its wave has streamed: those fail typed ``EngineShutdown``, the rest
   resubmit to replica 0 and complete (teacher-forced within 0.05), no
   other request fails, replica 1 is rebuilt with generation + 1,
   ``check_pool_quiesced``; K1 22 x the decode steps, K2 never. Then the
   int8 pool with ``share_prefixes``: a session placed on the cold
   replica pulls its 8 prefix pages from the warm one (the landed bytes
   equal the donor's), K2 22 x the decode steps, K1 never; after
   ``swap_replica_weights`` to another ``weights_id`` the donor, holding
   a fresh prefix, is refused as a pull source (``_pull_hint`` None).
4h. The pool's control plane at full width: TinyLlama-1.1B bf16
   (random weights from ``--seed``), 16 slots, 64-token pages, 513
   pages per engine, the fp pool and the prefix cache. (a) 16 requests
   with their own prompts of 512-1024 tokens, 64 greedy new tokens,
   arriving 50 ms apart, one thread each, through
   ``LlamaDeployment(disaggregate=True, prefill_replicas=1,
   decode_replicas=1)`` against ``num_engine_replicas=2`` (unified),
   one warm-up request per engine: 16 handoffs, 16 pulls landing
   sum(len // 64) pages, one pull's landed bytes equal to the donor's,
   each split stream equal to its unified twin or teacher-forced within
   0.05, no decode step on the prefill replica and K1 22 x the decode
   replica's steps, both pools quiesced; prints each arm's tok/s, TTFT
   p50 and p99, TPOT p50, and the split arm's handoff latency p50 and
   p99 (the ``handoff`` -> ``handoff_first_token`` events), pull host
   ms per page and wire MB. (b) 8 more requests on the split pool with
   the decode replica killed at its first round boundary at which part
   of its leg 2s has streamed: the unstreamed ones decode in place on
   the prefill replica (teacher-forced within 0.05), only streamed ones
   fail, typed, none is lost, the decode replica is rebuilt with its
   generation + 1. (c) ``num_engine_replicas=2,
   engine_stall_deadline_s=2.0``, 8 of phase 4's prompts, a ``hang``
   armed at replica 1's decode dispatch once part of its requests have
   streamed: suspect then wedged within the deadline + 2 polls, the
   flight bundle names replica 1, the streamed requests fail typed,
   the others resubmit and complete, the released zombie commits
   nothing, replica 1 is rebuilt; prints the detect latency. (d)
   ``num_engine_replicas=1, autoscale=True, autoscale_max_replicas=2``
   (no cooldowns, 2 s of idle): 24 requests of 512-1024 tokens, 16 at
   once and 8 150 ms apart: 1 -> 2 replicas, then back to 1 by drain,
   none lost, the retired engine's pages free; prints the decisions,
   the timeline, the time from the burst to the new replica's first
   route, the engine's build time and TTFT p50 before and after.
4j. The fleet control plane at TinyLlama-1.1B's widths, 6 layers
   (``EARLIER_POOL_LAYERS``), bf16 random weights from ``--seed``, 16
   slots, 64-token pages, 513 pages per engine, the prefix cache. (a)
   ``LlamaDeployment(fleet=2)`` in this process (a loopback directory,
   two agents, the router): 4g's warm-up (with ``echo_replica``: r0 or
   r1 at generation 0) and the first turn of its 8 sessions; both
   members served, ``serve_stats()`` counts 2 replicas, K1 6 x the
   members' decode steps and K2 never. (b) a replicated directory, a
   primary process (``--data-dir``, ``--standby``) and a hot standby
   process (``--role standby --peer``, promoting after 3 s of silence;
   its own ``--data-dir``), both with 5 s leases, the primary's port
   reserved first and the standby started before it, and two agent
   processes (``python -m ray_tpu_torch.serve.fleet.agent --model
   tinyllama --layers 6 --seed S``, both directories in their
   ``--directory`` list), each started with ``subprocess.Popen`` from this
   script's directory (never forked: this process holds a CUDA context),
   its output into a file, ``READY <port>`` read from it within 180 s;
   the agents load the libraries phase 1 built. Free card memory
   falls by at least both agents' weights once they are ``READY``; the
   warm-up prompt gives each agent the greedy tokens of an engine this
   process builds from the same seed. A ``FleetRouter`` here (sockets,
   a 20 ms poll, a ``FailoverDirectoryClient`` over both directories)
   serves 4g's 8 sessions x 3 turns (every request its 32
   tokens), then 4g's kill wave at 128 new tokens a request (so that a
   poll seldom carries a whole stream) with a SIGKILL of one agent
   process at the first poll answer that carries tokens of a request the
   agent is still decoding, once half or fewer of its wave have none
   delivered: the zero-delivery requests resubmit once and complete on
   the survivor, at least one partly delivered request (the one whose
   answer fired the kill) fails typed ``EngineShutdown``, as every
   partly delivered one must unless the tokens in hand at the kill
   finish it, the survivor admits each of its routes once, the directory
   confirms the death. (c) A ``FleetCapacityProvider`` over both
   directories (``--model tinyllama --layers 6 --seed S``, 180 s to
   ``READY``) starts one agent process; the router adopts its ticket
   (``add_replica_for_ticket``) and routes 8 fresh requests of 4g's
   prompt shape (512 + 32 tokens), 32 new tokens each, over it and the
   survivor: it serves at least one, its warm-up tokens equal this
   process's engine's, free card memory fell by its weights, every
   request completes. (d) The primary directory's SIGKILL once the
   router holds tokens of a fresh wave of 8 x 128 new tokens over the
   two agents: the standby becomes primary at the epoch above, every
   fence it issues after the promotion exceeds the primary's last
   counter (its events and snapshot), every request ends (its 128
   tokens, or a typed error of the serving taxonomy; none without an
   outcome 120 s after the kill) and none is admitted twice, a canary of
   the warm-up prompt through the promoted directory gives this
   process's engine's tokens, both live agents are members there, and
   ``DirectoryWAL`` reads back from the killed primary's data directory
   every live registration it acknowledged and its fence counter; then
   ``scale_down`` retires the provider's agent and ``release`` reaps it.
   Every child is reaped (terminate, wait, kill; the provider's
   ``stop_all``) in a ``finally`` before the phase returns, and free card
   memory comes back within 0.5 GB of its value before the spawn. Prints
   each agent's seconds to ``READY``, (b)'s tok/s and TTFT p50 beside 4g
   (b)'s pool and one engine, routes and affinity hits, resubmissions
   and the seconds from the kill to the confirmed death; the provider's
   agent's seconds to ``READY`` and ``eta_s`` before and after; the
   seconds from the directory's kill to the promotion and to each
   agent's next renewal with the new primary, self-fences, the wave's
   outcomes and the failover client's counters. (e) A
   ``TelemetryCollector`` on (b)'s router (0.25 s scrapes, attached
   before (b)'s trace, stopped after (d)): it scraped every member (the
   router, both directories, both agents, the provider's agent), ingested
   no event twice within one incarnation, wrote a cluster bundle for
   (b)'s confirmed death (its manifest names the victim and the death)
   and one for (d)'s scraped promotion, both read back with
   ``load_cluster_bundle``, and reads one of (b)'s resubmitted requests
   (trace ids ``4j-kill-<i>``) as one timeline: spans on the router, the
   victim and the survivor, in that order on its timebase. Prints each
   directory's seconds to ``READY`` (no torch in a directory process)
   and, per member, the scrape's ms (p50, max), the clock offset and its
   RTT/2 bound, events per second, ``dropped``, and each bundle's write
   ms. No check bounds a latency.
4k. The seeded fleet campaign (``tools/torch_chaos_serve.py``'s
   ``run_fleet_chaos``, seed ``--seed``, a 20 s schedule, 2 s leases, a
   5 s partition, promotion after 6 s of silence): two agent processes
   of TinyLlama-1.1B's widths at 6 layers, bf16, each running K1
   (8 slots, 64-token pages, 64 pages), behind a primary and a standby
   directory process, a ``FleetRouter`` and a ``TelemetryCollector``
   here, a supervisor that restarts killed agents, and a
   ``FleetCapacityProvider``; 3 client threads send 8 prompts behind a
   shared 8-token prefix, 10 greedy tokens each. All six kinds fire (an
   agent's SIGKILL, a partition longer than the lease, a primary crash
   and restart from its WAL, a torn WAL tail, the primary's permanent
   kill, autoscaler churn) and every gate of the tool holds: none lost,
   none differing from this process's lone engine but at a near-tie
   (teacher-forced, 0.1 of the top logit; counted apart and printed), a
   completion through a resubmission, fences monotonic across the
   failover, every fault explained by a flight and a cluster bundle, the
   live agents quiesced, every child reaped. Here: free card memory fell
   by the agents' weights, every live agent's engine ran decode steps.
   Prints each fault's seconds from injection to recovery (confirmed
   death, self-fence, ``READY`` again, promotion, the churned agent's
   ``READY`` and retirement), the attainment and the request counts.
4i. Durable weights, the staged rollout and the batch tier at full
   width: TinyLlama-1.1B bf16, payload A random from ``--seed`` and B
   from ``--seed`` + 1, 16 slots, 64-token pages, 513 pages per engine;
   (a) at full depth, (b)-(d) on the payloads' first 6 layers
   (``EARLIER_POOL_LAYERS``, as 4e-4h), each under its own payload id.
   Prints the temporary directory's free bytes. (a) ``publish_weights``
   A and B (bytes; host seconds of the staging write, hash + fsync, the
   manifest, the rename and the payload id), ``load_weights`` of B with
   its deep verify (timed; the tensors equal B's), A republished into a
   second directory with the same ``weights_id``; a third copy with its
   tensor file truncated is refused ``InvalidCheckpointError`` and
   ``fleet_weights()`` is unchanged. Then 4 parity probes of 8 tokens
   from a lone engine serving the loaded B: seeded candidates (one
   token repeated) whose every expected token leads the runner-up by
   >= 0.5 logits, teacher-forced. (b) ``LlamaDeployment(num_engine_replicas=3,
   prefix_cache=True)`` on A, ``WeightRolloutController(
   canary_fraction=0.34, swap_mode="preempt")``: 24 requests of
   512-token prompts, 64 new, 50 ms apart, once with no rollout and once
   (fresh prompts of the same length) with the rollout A -> B started at
   the 4th arrival: completed, transitions strictly increasing per
   replica, 3 swaps (``canary_fraction`` 0.34 of 3: 2 canaries, then a
   wave of 1), ``weights_mixed`` false, no failed request, and 4
   requests sent after convergence (plus any of the trace whose first
   token came after it) equal to the lone B engine's streams or parting
   at a near-tie (0.1, teacher-forced); prints the rollout's wall time
   and transitions, each replica's staging and pause ms, and each run's
   tok/s, TTFT p50 and p99 and TPOT p50. (c) A rollout B -> C (layer 0's
   ``wo`` negated): rolled back for parity, the fleet back on B, each
   canary's generation up by 2, the other replica unswapped,
   ``serve_weight_rollback_total`` and ``route_stats["weight_rollbacks"]``
   1, a ``weight-rollback`` bundle naming the canary; prints the time
   from the canary's swap to convergence; K1 22 x the pool's decode
   steps over (b)-(c), K2 never. (d) The batch tier on one int8 engine
   with the prefix cache: 64 seeded rows of 128-512 tokens, 64 new,
   ``max_in_flight`` 32, under ``engine_kwargs_for_profile("latency")``
   and ``("throughput")`` (each after a warm-up job; tok/s of each; rows
   equal or parting at a near-tie, 0.1 over an int8 pool), then the
   throughput arm again with ``checkpoint_every`` 8 through a target
   whose ``submit`` raises after 40 calls (its streams in flight then
   cancelled, as a dropped connection would), resumed from its manifest:
   ``rows_resumed`` the committed rows, only the others submitted, no
   row duplicated or missing, each equal to the uninterrupted arm's or
   parting at a near-tie; prints each checkpoint write's ms; K2 22 x the
   decode steps, K1 never.
5. The flash-attention kernels against their plain versions on the
   card, each on the same inputs as its plain version: K3 (forward),
   K4 (dQ) and K5 (dK, dV) in fp32 (the scalar kernels) at T
   128/256/512 (one and several kv tiles), head_dim 16 (zero-padded to
   64, as ``flash_attention`` pads it), 64 and 128, causal and not
   (1e-4 abs and rel); in bf16 (K3, K4 and K5 on the tensor cores,
   which torch.profiler's kernel names show for every case) at T
   128/192/512 (192: a trailing 64-row tile), D 64 and 128, causal and
   not, at Tq 128 / Tk 384 non-causal, and on the strided column views
   of a fused qkv projection (output 4e-3 + 2^-7·|ref|, lse 1e-4,
   gradients 1e-2 + 2^-6·|ref|); at the GPT-2-124M shape (B 24, T
   1024, H 12, D 64, causal) in fp32 (1e-4) and bf16 (the same bf16
   limits), and at the TinyLlama-1.1B training shape (B 8, T 1024, H
   32, D 64, causal, K and V of 4 kv heads repeated per head) in bf16;
   at each, K4 and K5 on one shared delta must equal K4 and K5 called
   alone.
   Times each kernel (K4 and K5 on a delta formed beforehand), the
   delta pass, one whole backward (delta pass + K4 + K5), each plain
   version and the library yardstick (SDPA forward, backward and
   forward+backward, never called by the port) with CUDA events, L2
   flushed before each launch, and computes each bound from this run's
   inputs.
6. The train step on the card against the train step on the CPU: a
   reduced fp32 GPT-2 (2 layers, C 128, H 4, vocab 1024, T 128, batch
   4) with flash attention, the same weights and batch on both sides,
   3 AdamW steps: losses and grad norms within 1e-4 relative.
6b. The same for a reduced fp32 Llama (2 layers, dim 256, 4 q / 2 kv
   heads, vocab 1024, T 128, batch 4) with remat and flash attention,
   trained with ``build_train_model`` and bench's cross-entropy: 3
   AdamW steps card vs CPU within 1e-4 relative, and step 1's loss
   identical with remat off on each device.
7. The training main path at full width: GPT-2-124M (vocab 50304, 12
   layers, C 768, H 12, T 1024), bf16 compute on fp32 params, random
   weights from ``--seed``, batch 24 of ``RandomState(0)`` token ids,
   ``adamw(3e-4, weight_decay=0.1)``, as ``bench.py`` drives the JAX
   package: 1 warm-up step, then 10 timed steps on the fixed batch.
   Checks that K3, K4, K5 and the delta pass were each launched 12 x 11
   times (one delta pass per backward), that
   every loss is finite and the last below the first, and that step
   1's loss and grad norm agree with the same step computed on the
   card with dense fp32-score attention (1e-2 and 2 %). Prints train
   tokens/s, ms per step, MFU (against 989 TFLOP/s bf16) and peak
   device memory beside the card's name and power limit.
7b. The Llama training main path at full width, ``bench.py --model
   llama-1.1b``: ``tinyllama_1_1b(max_seq_len=1024, remat=True)``, bf16
   compute on fp32 params (``build_train_model``), random weights from
   ``--seed``, batch 8 of ``RandomState(0)`` ids, the mean
   cross-entropy of the fp32 logits, ``adamw(3e-4, weight_decay=0.1)``:
   1 warm-up step, then 10 timed steps. Checks that K3 was launched 2 x
   22 x 11 times (remat runs each block's forward again in the
   backward) and K4, K5 and the delta pass 22 x 11 times each, that
   every loss is finite and the last below the first, and step 1's
   loss and grad norm against the same step with dense fp32-score
   attention (also under remat; 1e-2 and 2 %). Prints train tokens/s,
   ms per step, MFU (``llama_flops_per_token(cfg, 1024)`` against 989
   TFLOP/s) and peak device memory beside the card's name and power
   limit.
7c. Phase 7's GPT-2-124M train step for 10 steps with
   ``CheckpointManager(root, keep_last_k=2).save_async`` of the model's
   and the AdamW optimizer's state dicts at step 5 (snapshot copied to
   the host on the train thread, written while steps 6-10 run): prints
   the step ms of steps 2-5, of steps 6-10 with the writer busy, and
   phase 7's, the snapshot ms, the write's seconds and bytes. After
   ``wait()``, ``latest_complete()`` restored into a fresh model and
   optimizer must equal a copy taken on the card at step 5 bit for bit,
   and its steps 6-7 must give the uninterrupted run's losses exactly
   (every kernel of the step, K4 and K5 included, is deterministic).
8. The RLHF loop (``ray_tpu_torch.rl``) at TinyLlama-1.1B's widths
   and 6 of its layers (``EARLIER_POOL_LAYERS``), bf16 on fp32 masters
   (random weights from ``--seed``), after 4i: first, at ``llama_tiny``
   fp32, two ``RolloutLearner`` updates on one fixed batch of length
   128 card (fp32 flash kernels) vs CPU, loss, pg_loss and entropy
   within 1e-4 relative. Then one ``LLMEngine`` (16 slots, 64-token
   pages, ``capture_logprobs=True``, temperature 1, no eos) feeding a
   ``RolloutLearner`` (ppo, Adam 1e-5) through ``RLHFLoop``: 16 prompts
   of 96 tokens a round, 32 new tokens (L = 128, so the learner's
   attention takes flash), staleness bound 1, overlapped,
   ``keep_last_k=1``: (1) 2 rounds; (2) 2 rounds with the learner
   killed before round 1's commit, then attempt 2's resume, whose
   generator is killed mid round 1. Checks: every ledger holds each
   round once, staleness <= 1, one generator restart, the resume at
   round 1 with ``resync_weights_id == recovered_weights_id``, the
   engine's final payload the one that sampled the last batch (the last
   round's publish is never synced: no round follows it), every loss
   finite, overlap observed, and in (1) K1 once per layer on every
   decode step (K2 never) and K3, K4, K5 and the delta pass once per
   layer per update. Prints per round the generation and learner walls,
   the generator's weight sync, publish and commit seconds, and each
   learner update's seconds, ``generator_utilization``,
   ``overlap_observed``, the launch counts, and the resume's restore
   seconds.
9. The ``{"kernels": [...]}`` line (K1, K2, K3, K4, K5; K1's
   ``launches`` are phase 4's, ``launches_default_loop`` phase 4d's
   three arms, ``launches_kv_pull`` phase 4e's fp requester,
   ``launches_faults`` phase 4f (a)'s two waves, ``launches_pool``
   phase 4g (b)'s fp pool, ``launches_disagg`` phase 4h (a)'s split
   arm, all on its decode replica, ``launches_fleet`` phase 4j (a)'s
   loopback fleet, ``launches_rollout`` phase 4i
   (b)-(c)'s pool, ``launches_rl`` phase 8 (1)'s engine; K2's ``launches``
   phase 4b's, ``launches_kv_pull`` phase 4e's int8 requester,
   ``launches_lanes`` phase 4f (b)'s backlog wave,
   ``launches_pool_int8`` phase 4g (b)'s int8 pool, ``launches_batch``
   phase 4i (d)'s batch engines; the flash rows
   at the GPT-2 shape with phase 7's launches and ``launches_rl``
   phase 8 (1)'s learner's, and under ``"llama_1_1b"`` at the TinyLlama
   shape with phase 7b's), then the
   ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, same source
K1_FP32_TOL = 1e-4
K1_BF16_ATOL, K1_BF16_RTOL = 4e-3, 2.0 ** -7
SDPA_TOL = 2e-2                    # the yardstick rounds P to bf16
LOGIT_SLACK = 0.05
LOGPROB_CARD_TOL = 1e-4            # fp32 logprobs, card vs CPU
INT8_LOGIT_SLACK = 0.1             # + one int8 step (s/254) per element
FLASH_FP32_TOL = 1e-4
FLASH_BF16_O = (4e-3, 2.0 ** -7)   # one rounding of an fp32 result
FLASH_BF16_GRAD = (1e-2, 2.0 ** -6)  # P and dS also rounded to bf16
TRAIN_RTOL = 1e-4
SPIN_CYCLES = 4_000_000            # ~2 ms at the H100's 1.6-2 GHz SM clock
EARLIER_POOL_LAYERS = 6            # 4e-4h, 4i (b)-(d) and 8: depth (of 22)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events,
    with L2 (50 MB) evicted before each run: in a real decode step
    every layer's pages are cold. A ~2 ms spin kernel after each flush
    keeps the device behind the host, so the start event does not fire
    while the host is still inside the wrapper (a decode wrapper call
    can cost the host longer than the flush and the kernel take the
    device): the events time the device's work, not the host's
    launch."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    fn()
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def _decode_case(seed, B, H, KH, D, Pg, max_pages, n_pages, dtype,
                 positions=None, null_rows=(), int8=False):
    """Decode-kernel inputs from ``seed`` on the card: (q, pages_k,
    pages_v, page_table, positions), pages in ``dtype`` from a standard
    normal; with ``int8``, int8 pages from integers(-127, 128) and
    their per-page scales from uniform(0.1, 2.0) appended."""
    g = np.random.default_rng(seed)
    shape, sshape = (KH, n_pages, Pg, D), (KH, n_pages, 1)
    if int8:
        pk, pv = (g.integers(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        scales = [g.uniform(0.1, 2.0, sshape).astype(np.float32)
                  for _ in range(2)]
    else:
        pk, pv = (g.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        scales = []
    pt = (g.permutation(n_pages - 1)[:B * max_pages] + 1).reshape(
        B, max_pages).astype(np.int32)
    for b in null_rows:
        pt[b] = 0
    if positions is None:
        positions = g.integers(0, max_pages * Pg, size=B)
    q = g.standard_normal((B, H, D)).astype(np.float32)
    dev = torch.device("cuda")
    page_dtype = torch.int8 if int8 else dtype
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(pk).to(dev, page_dtype),
            torch.from_numpy(pv).to(dev, page_dtype),
            torch.from_numpy(pt).to(dev),
            torch.from_numpy(np.asarray(positions, np.int32)).to(dev),
            *(torch.from_numpy(a).to(dev) for a in scales))


def _max_err(out, ref, atol, rtol=None) -> float:
    rtol = atol if rtol is None else rtol
    err = (out.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max abs err "
            f"{err.max().item()} at tolerance {atol} + {rtol} * |ref|")
    return err.max().item()


def _split_passes(names) -> dict:
    """How many of the device-kernel ``names`` are each decode split
    pass: the tensor-core ``split_sm90`` over bf16 pages (bf16 K1) and
    over int8 pages (bf16-q K2), and the scalar ``split_kernel`` over
    bf16 pages (no longer built), fp32 pages (fp32 K1) and int8 pages
    (fp32-q K2); and the merge kernels, of which there are none."""
    return {
        "sm90": sum("::split_sm90<__nv_bfloat16" in n for n in names),
        "sm90_int8": sum("::split_sm90<signed char" in n for n in names),
        "merge": sum("merge_kernel" in n for n in names),
        "scalar_bf16": sum("::split_kernel<__nv_bfloat16, __nv_bfloat16"
                           in n for n in names),
        "scalar_fp32": sum("::split_kernel<float, float" in n
                           for n in names),
        "scalar_int8": sum("::split_kernel<" in n and "signed char" in n
                           for n in names)}


def _check_split_route(names, want: dict, where: str) -> dict:
    """The split passes among ``names`` are exactly ``want`` (absent
    keys: 0)."""
    count = _split_passes(names)
    want = {k: want.get(k, 0) for k in count}
    if count != want:
        raise AssertionError(f"{where}: decode split passes {count}, want "
                             f"{want}; device kernels "
                             f"{sorted(set(names))}")
    return count


def phase_kernels(pa, seed: int, int8: bool = False) -> dict:
    """K1 (fp pages), or K2 with ``int8`` (int8 pages with per-page
    scales), against its plain version: fp32 and bf16 cases, the
    TinyLlama decode shape across the split-K boundaries in fp32, then
    that shape with bf16 q, with times, the SDPA yardstick and the
    bound. The profiler's kernel names show which split pass each call
    ran: bf16 q the tensor-core pass (over bf16 or int8 pages), fp32 q
    the scalar one."""
    name = "K2" if int8 else "K1"
    # K1 keeps the inputs of earlier runs; K2 draws its own
    seeds = (seed + 7, seed + 8, seed + 9) if int8 else (seed, seed + 1,
                                                         seed)
    B, H, KH, D, Pg, max_pages = 16, 32, 4, 64, 64, 32
    calls = {torch.float32: 0, torch.bfloat16: 0}
    res = {}

    def check(args, atol, rtol=None):
        calls[args[0].dtype] += 1
        out = pa.paged_decode_attention(*args)
        return out, _max_err(out, pa.paged_decode_attention_reference(
            *args), atol, rtol)

    def cases():
        bf16_err = 0.0
        for rep in (1, 4, 8):
            for d in (64, 128):
                args = _decode_case(seeds[0] + rep * 10 + d, 3, 2 * rep,
                                    2, d, 16, 4, 40, torch.float32,
                                    int8=int8)
                check(args, K1_FP32_TOL)
                # the same inputs with bf16 q (and, for K1, pages)
                args = [a.to(torch.bfloat16) if i < 3
                        and a.dtype == torch.float32 else a
                        for i, a in enumerate(args)]
                bf16_err = max(bf16_err, check(args, K1_BF16_ATOL,
                                               K1_BF16_RTOL)[1])
        for dtype, tol in ((torch.float32, (K1_FP32_TOL,)),
                           (torch.bfloat16, (K1_BF16_ATOL, K1_BF16_RTOL))):
            args = _decode_case(seeds[0], 4, 8, 2, 64, 8, 3, 32, dtype,
                                positions=[0, 3 * 8 - 1, 5, 12],
                                null_rows=(2,), int8=int8)
            check(args, *tol)
        print(f"phase 2: {name} fp32 cases (rep 1/4/8, D 64/128, pos 0, "
              f"full window, null page) agree within {K1_FP32_TOL}; the "
              f"same in bf16 within {K1_BF16_ATOL} + {K1_BF16_RTOL} * "
              f"|ref| (max abs err {bf16_err})")

        # the main-path shape in fp32: windows that end on each side of
        # the split-K boundaries (pa._SPLIT_KEYS keys per split, and
        # pa._SPLIT_KEYS_BF16 = 2 * split for bf16 q) and of a page
        split = pa._SPLIT_KEYS
        edges = [0, split - 2, split - 1, split, split + 1, 2 * split - 1,
                 2 * split, Pg - 1, Pg, 7 * split - 1, 7 * split,
                 max_pages * Pg - 1]
        rng = np.random.default_rng(seeds[1])
        positions = edges + rng.integers(0, max_pages * Pg,
                                         B - len(edges)).tolist()
        args = _decode_case(seeds[1], B, H, KH, D, Pg, max_pages,
                            B * max_pages + 1, torch.float32,
                            positions=positions, int8=int8)
        res["err32"] = check(args, K1_FP32_TOL)[1]
        print(f"phase 2: {name} fp32 at B={B} H={H} KH={KH} D={D} Pg={Pg} "
              f"max_pages={max_pages}, positions {sorted(positions)}: max "
              f"abs err {res['err32']} (tol {K1_FP32_TOL})")
        # the same windows at that shape in bf16
        args = _decode_case(seeds[1], B, H, KH, D, Pg, max_pages,
                            B * max_pages + 1, torch.bfloat16,
                            positions=positions, int8=int8)
        check(args, K1_BF16_ATOL, K1_BF16_RTOL)

        args = _decode_case(seeds[2], B, H, KH, D, Pg, max_pages,
                            B * max_pages + 1, torch.bfloat16, int8=int8)
        res["args"] = args
        res["out"], res["err"] = check(args, K1_BF16_ATOL, K1_BF16_RTOL)

    def warm():   # one fp32 and one bf16 call, not counted
        for dtype in (torch.float32, torch.bfloat16):
            pa.paged_decode_attention(*_decode_case(
                seeds[0], 2, 8, 2, 64, 8, 3, 32, dtype, int8=int8))

    names = _device_kernels(cases, warm)
    n32, n16 = calls[torch.float32], calls[torch.bfloat16]
    route = _check_split_route(
        names, {"scalar_int8": n32, "sm90_int8": n16} if int8 else
        {"scalar_fp32": n32, "sm90": n16}, f"phase 2 {name}")
    print(f"phase 2: {name} ran the split passes {route} for {n32} fp32 "
          f"and {n16} bf16 calls")
    args, err, err32 = res["args"], res["err"], res["err32"]
    q, pk, pv, pt, pos = args[:5]
    scales = args[5:] or (None, None)
    ref = pa.paged_decode_attention_reference(*args)

    # library yardstick: SDPA over the window gathered beforehand — for
    # int8 pages gathered and dequantized to bf16 (neither step timed);
    # the port never calls it
    L = max_pages * Pg
    ptl = pt.long()

    def window(pages, s):
        w = pages[:, ptl]
        if s is not None:
            w = (w.float() * (s[:, ptl] / 127.0)[..., None]).to(
                torch.bfloat16)
        return w.reshape(KH, B, L, D).transpose(0, 1).contiguous()

    kg, vg = window(pk, scales[0]), window(pv, scales[1])
    mask = (torch.arange(L, device=q.device)[None]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True)

    torch.testing.assert_close(sdpa()[:, :, 0].float(), ref.float(),
                               rtol=SDPA_TOL, atol=SDPA_TOL)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=q.device)
    ms = _time_ms(lambda: pa.paged_decode_attention(*args), 50, flush)
    plain_ms = _time_ms(
        lambda: pa.paged_decode_attention_reference(*args), 20, flush)
    library_ms = _time_ms(sdpa, 50, flush)

    # least work: each visible key and value read once (int8: 1 byte,
    # plus each visible page's two fp32 scales per kv head), q read
    # once, out written once, the page-table entries walked, the
    # positions
    keys = int((pos.long() + 1).clamp(max=L).sum().item())
    pages = int(((pos.long() // Pg) + 1).clamp(max=max_pages).sum().item())
    nbytes = (2 * keys * KH * D * (1 if int8 else 2)
              + (2 * 4 * KH * pages if int8 else 0)
              + 2 * B * H * D * 2 + 4 * pages + 4 * B)
    flops = 4 * keys * (H // KH) * KH * D        # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    pages_desc = "int8 pages, bf16 q" if int8 else "bf16"
    print(f"phase 2: {name} {pages_desc} B={B} H={H} KH={KH} D={D} "
          f"Pg={Pg} max_pages={max_pages}: max abs err {err} (tol "
          f"{K1_BF16_ATOL} + {K1_BF16_RTOL} * |ref|); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA on the gathered"
          f"{' bf16' if int8 else ''} window {library_ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes} bytes at 3.35 TB/s)")
    # the bf16 row's kernel: the tensor-core pass over K2's int8 or K1's
    # bf16 pages
    source = pa._SOURCE_SM90
    design = ("mma.sync m16n8k16 (Q as register A operand, K and V through "
              "ldmatrix), the whole split staged by cp.async (K then V "
              "group)" + (", each lane widening the int8 rows it copied "
                          "to bf16 exactly, the page scales folded into S "
                          "and P in fp32" if int8 else "")
              + ", softmax in the warp; the splits merged by the block "
              "that ends last, one launch per call")
    return {"name": "paged_decode_attention" + ("_int8" if int8 else ""),
            "route": "cuda", "source": f"ray_tpu_torch/ops/csrc/{source}",
            "replaces": "ray_tpu/ops/paged_attention.py:"
                        + ("301" if int8 else "291"),
            "design": design, "split_passes": route,
            "launches": None, "max_abs_err": err,
            "max_abs_err_fp32": err32, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": {
                "B": B, "H": H, "KH": KH, "D": D, "page_size": Pg,
                "max_pages": max_pages, "keys": keys, "bytes": nbytes,
                "dtype": "int8 pages, bfloat16 q" if int8 else "bfloat16"}}


def _serve(model, waves, n, device, logprobs=None, **kw):
    """Each wave of prompts submitted after the previous one finished;
    the streams per wave, and the engine (checked leak-free: every page
    free or held by the prefix cache). With ``capture_logprobs`` each
    request's logprobs are appended to the list ``logprobs``."""
    from ray_tpu_torch.serve.engine import LLMEngine
    eng = LLMEngine(model, max_slots=4, page_size=16, n_pages=64,
                    chunk=4, device=device, **kw)
    out = []
    for wave in waves:
        hs = [eng.submit(p, max_new_tokens=n) for p in wave]
        while eng.step():
            pass
        out.append([h.result() for h in hs])
        if logprobs is not None:
            logprobs += [h.logprobs for h in hs]
    cached = 0
    if eng.prefix_cache is not None:
        eng.prefix_cache.check_invariants()
        cached = eng.prefix_cache.cached_pages
    if eng.alloc.occupancy() != cached:
        raise AssertionError(f"engine on {device} leaked pages")
    return out, eng


def phase_engine_parity(tl, seed: int) -> None:
    """The same fp32 weights through the engine on the card (K1) and on
    the CPU (plain version): identical greedy streams."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, cfg.vocab_size, n).tolist()
               for n in (1, 16, 17, 45)]
    cpu, _ = _serve(tl.build_model(cfg, sd, "cpu"), [prompts], 16, "cpu")
    gpu, _ = _serve(tl.build_model(cfg, sd, "cuda"), [prompts], 16, "cuda")
    if cpu != gpu:
        raise AssertionError(f"card and CPU streams differ:\n{gpu}\n{cpu}")
    print("phase 3: engine on the card == engine on the CPU (fp32, dim "
          "512, 8 q / 2 kv heads, 2 layers; prompts of 1/16/17/45 "
          "tokens, 16 greedy tokens each)")
    # the int8 pool with the prefix cache (K2 on the card): the same
    # wave, then a fully cached page-aligned repeat (the COW copy),
    # then a prompt sharing its first page
    waves = [prompts, [prompts[1]],
             [prompts[3][:16] + g.integers(0, cfg.vocab_size, 8).tolist()]]
    runs = {}
    for device in ("cpu", "cuda"):
        streams, eng = _serve(tl.build_model(cfg, sd, device), waves, 16,
                              device, kv_dtype="int8", prefix_cache=True)
        hits = (eng.stats["cache_hit_admissions"],
                eng.stats["cache_hit_tokens"])
        if hits != (2, 15 + 16):
            raise AssertionError(f"{device}: hit admissions and tokens "
                                 f"{hits}, want (2, 31)")
        runs[device] = streams
    if runs["cpu"] != runs["cuda"]:
        raise AssertionError(f"int8 + prefix cache: card and CPU streams "
                             f"differ:\n{runs['cuda']}\n{runs['cpu']}")
    print("phase 3: int8 KV + prefix cache, engine on the card (K2) == "
          "engine on the CPU over 3 waves (the same 4 prompts; the "
          "16-token prompt again, fully cached: COW copy; a prompt "
          "sharing the 45-token prompt's first page); 2 hit admissions, "
          "31 hit tokens; both leak-free")


def phase_engine_modes(tl, seed: int) -> dict:
    """Phase 3's model and prompts (plus a repetitive one) through the
    engine's loops and lanes on the card and on the CPU: for each pool,
    ``overlap`` off and on x ``spec_len`` 0 and 4 (``spec_ngram`` 1:
    phase 3's random model rarely repeats a longer suffix), with an eos
    that the lockstep stream of the shortest prompt first emits
    mid-stream. On the fp pool card == CPU for every mode, and every
    mode gives the lockstep streams without speculation (fp32
    speculation is exact). On the int8 pool card == CPU, or a stream
    parts at a near-tie: both tokens within ``INT8_LOGIT_SLACK`` of the
    top logit (``_int8_parting_gaps``: int8 bytes cannot match across
    devices). The verify ran on the card in both pools. Then logprob
    capture: the same streams, logprobs within ``LOGPROB_CARD_TOL``."""
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, cfg.vocab_size, n).tolist()
               for n in (1, 16, 17, 45)]
    prompts.append(g.integers(0, cfg.vocab_size, 8).tolist() * 4)
    models = {d: tl.build_model(cfg, sd, d) for d in ("cpu", "cuda")}
    n = 24
    res = {}
    for kv_dtype in ("fp", "int8"):
        base, _ = _serve(models["cpu"], [prompts], n, "cpu",
                         kv_dtype=kv_dtype, overlap=False)
        first = base[0][0]
        eos = next(t for i, t in enumerate(first)
                   if i >= n // 3 and t not in first[:i])
        want = [s[:s.index(eos) + 1] if eos in s else s for s in base[0]]
        rounds, parted = {}, {}
        for overlap in (False, True):
            for spec in (0, 4):
                runs = {}
                for device in ("cpu", "cuda"):
                    runs[device], eng = _serve(
                        models[device], [prompts], n, device,
                        kv_dtype=kv_dtype, eos_id=eos, overlap=overlap,
                        spec_len=spec, spec_ngram=1)
                    if spec:
                        rounds[(device, overlap)] = \
                            eng.spec_stats()["rounds"]
                mode = (f"{kv_dtype} pool, overlap={overlap}, "
                        f"spec_len={spec}, eos {eos}")
                gaps = ([] if kv_dtype == "fp" else _int8_parting_gaps(
                    models["cpu"], prompts, runs["cpu"][0],
                    runs["cuda"][0]))
                parted[mode] = gaps
                if ((kv_dtype == "fp" and runs["cpu"] != runs["cuda"])
                        or any(x > INT8_LOGIT_SLACK for x in gaps)):
                    raise AssertionError(
                        f"{mode}: card and CPU streams differ (int8: "
                        f"parting gaps {gaps}, allowed "
                        f"{INT8_LOGIT_SLACK}):\n{runs['cuda']}\n"
                        f"{runs['cpu']}")
                if kv_dtype == "fp" and runs["cuda"][0] != want:
                    raise AssertionError(
                        f"{mode}: streams differ from the lockstep "
                        f"loop's without speculation:\n{runs['cuda'][0]}"
                        f"\n{want}")
        if not all(rounds.values()):
            raise AssertionError(f"{kv_dtype} pool: a spec run verified "
                                 f"nothing: {rounds}")
        res[kv_dtype] = {"eos": eos, "spec_rounds": {
            f"{d} overlap={o}": r for (d, o), r in rounds.items()},
            "parting_gaps": parted}
        n_parted = sum(map(len, parted.values()))
        print(f"phase 3: {kv_dtype} pool, overlap off/on x spec_len 0/4 "
              f"(spec_ngram 1) with eos {eos}: "
              + ("card == CPU in every mode, and == the lockstep stream "
                 "without speculation" if kv_dtype == "fp" else
                 f"card == CPU but for {n_parted} of "
                 f"{4 * len(prompts)} streams, each parting at a "
                 f"near-tie (max gap "
                 f"{max((x for v in parted.values() for x in v), default=0):.4f}"
                 f", allowed {INT8_LOGIT_SLACK})")
              + f"; verify rounds {res[kv_dtype]['spec_rounds']}")
    # The overlapped loop's stale path on the card. At these sizes (and
    # at phase 4d's) the host is the bottleneck: each dispatch is done
    # before the next round is planned, so the pipeline never holds two.
    # Queued behind a ~50 ms spin, each decode dispatch finishes after
    # the next round is planned from a stale frontier, as in a
    # device-bound step: two dispatches in flight, the eos revealed a
    # round late, the streams those of the CPU's lockstep loop.
    from ray_tpu_torch.serve.engine import LLMEngine
    eos = res["fp"]["eos"]
    want, _ = _serve(models["cpu"], [prompts], n, "cpu", eos_id=eos,
                     overlap=False)
    lagged = {}
    for spec in (0, 4):
        # decode chunk 2: dispatches of at most 4 steps (~600 kernels);
        # one of more kernels than CUDA's launch queue holds would block
        # the host behind the spin until the card catches up
        eng = LLMEngine(models["cuda"], max_slots=4, page_size=16,
                        n_pages=64, chunk=2, device="cuda", eos_id=eos,
                        overlap=True, spec_len=spec, spec_ngram=1)
        depths = _probe_depth(eng, lag_cycles=25 * SPIN_CYCLES)
        hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
        while eng.step():
            pass
        got = [h.result() for h in hs]
        del eng._dispatch_chunk_locked
        if got != want[0] or eng.alloc.occupancy():
            raise AssertionError(f"device-lagged overlapped loop, spec_len"
                                 f" {spec}: streams differ from the CPU's "
                                 f"lockstep ones, or pages leaked:\n{got}"
                                 f"\n{want[0]}")
        lagged[spec] = max(depths, default=0)
    if lagged[0] != 2 or lagged[4] > 2:
        raise AssertionError(f"device-lagged overlapped loop: fetchq_depth "
                             f"reached {lagged}, want 2 without "
                             f"speculation and at most 2 with it")
    res["lagged_fetchq_depth_max"] = lagged
    print(f"phase 3: overlapped loop on the card with each decode "
          f"dispatch queued behind a ~50 ms spin (the card behind the "
          f"host): fetchq_depth reached {lagged[0]} (spec_len 4: "
          f"{lagged[4]}), streams == the CPU's lockstep ones, eos {eos}")
    lps, toks = {}, {}
    for device in ("cpu", "cuda"):
        lps[device] = []
        toks[device], _ = _serve(models[device], [prompts], n, device,
                                 logprobs=lps[device],
                                 capture_logprobs=True)
    if toks["cpu"] != toks["cuda"]:
        raise AssertionError("logprob capture: card and CPU streams differ")
    err = max(abs(a - b) for x, y in zip(lps["cpu"], lps["cuda"])
              for a, b in zip(x, y))
    if (any(len(x) != len(t) for x, t in zip(lps["cuda"], toks["cuda"][0]))
            or err > LOGPROB_CARD_TOL):
        raise AssertionError(f"logprob capture: card vs CPU max error "
                             f"{err} (allowed {LOGPROB_CARD_TOL}), or "
                             f"lengths differ from the tokens")
    res["logprob_max_abs_err"] = err
    print(f"phase 3: logprob capture, card vs CPU: the same streams, "
          f"logprobs within {err:.2e} (allowed {LOGPROB_CARD_TOL})")
    return res


def phase_generate_parity(tl, seed: int) -> None:
    """Phase 3's model through the static-cache loops: greedy
    ``generate`` on the card equal to the CPU's for each of its 4
    prompts, and ``generate_stream`` (chunk 8) equal to ``generate``."""
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, cfg.vocab_size, n).tolist()
               for n in (1, 16, 17, 45)]
    gens = {}
    for device in ("cpu", "cuda"):
        model = tl.build_model(cfg, sd, device)
        gens[device] = [tl.generate(model, [p], 16)[0, len(p):].tolist()
                        for p in prompts]
    streams = [[int(t[0]) for t in tl.generate_stream(model, [p], 16,
                                                      chunk_size=8)]
               for p in prompts]
    if gens["cpu"] != gens["cuda"]:
        raise AssertionError(f"generate: card and CPU tokens differ:\n"
                             f"{gens['cuda']}\n{gens['cpu']}")
    if streams != gens["cuda"]:
        raise AssertionError(f"generate_stream differs from generate:\n"
                             f"{streams}\n{gens['cuda']}")
    print("phase 3: generate (static KV cache) on the card == on the CPU, "
          "and generate_stream (chunk 8) == generate, on the same 4 "
          "prompts, 16 greedy tokens each")


def _outcome(h) -> tuple:
    """A handle's end: ("ok", tokens) or ("err", type name, message)."""
    try:
        return ("ok", h.result())
    except Exception as e:  # noqa: BLE001 - the record names the type
        return ("err", type(e).__name__, str(e))


def _fault_case(model, device, name, prompts, n) -> dict:
    """One of phase 3's fault cases on ``model`` (on ``device``): the
    named ``FaultInjector`` plan, the requests, ``step()`` driven to
    quiescence. Returns every handle's outcome, ``lifecycle_stats()``
    and the lane counters, after ``check_quiesced``."""
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.faults import FaultInjector, check_quiesced
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    inj = FaultInjector()
    kw = dict(max_slots=4, page_size=16, n_pages=64, chunk=4,
              retry_backoff_s=0.005)
    if name == "dispatch_prefill":
        inj.inject("dispatch_prefill", sid=1, round=1,
                   exc=ValueError("prefill fault"))
    elif name == "dispatch_decode":
        inj.inject("dispatch_decode", sid=2, round=2,
                   exc=RuntimeError("decode fault"))
    elif name == "dispatch_spec":
        inj.inject("dispatch_spec", sid=1, round=4)
        kw.update(spec_len=4, spec_ngram=1, overlap=False)
    elif name == "readback":
        inj.inject("readback", sid=3, exc=OSError("readback fault"))
    elif name == "exhaust_alloc":
        inj.exhaust_alloc(round=2, times=2)
    elif name == "max_retries":
        inj.inject("dispatch_decode", sid=1, round=2)
        kw.update(max_retries=0)
    elif name == "lone_slot":
        kw.update(max_slots=2, n_pages=9, prefix_cache=True)
    elif name.startswith("lanes"):
        kw.update(kv_dtype=name.split("_")[1], prefix_cache=True)
    eng = LLMEngine(model, device=device, fault_injector=inj, **kw)
    pinned = []
    if name == "lone_slot":
        # a donor pin on a cached 4-page prefix leaves 4 of 8 pages; a
        # 112-token request cannot grow past them and has no victim
        prefix = prompts[3][:32] * 2
        eng.submit(prefix, max_new_tokens=1)
        while eng.step():
            pass
        pinned = eng.kv_pin_prefix(path_hashes(prefix, 16))
        hs = [eng.submit(prompts[4], max_new_tokens=80),
              eng.submit(prompts[1][:3], max_new_tokens=2)]
    elif name.startswith("lanes"):
        # rollouts fill every slot, then an online burst preempts them
        hs = eng.submit_rollout_batch(prompts[:4], max_new_tokens=3 * n)
        eng.step()       # prefilled, and decoding
        hs += [eng.submit(p, max_new_tokens=n) for p in prompts[3:]]
    else:
        hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
    while eng.step():
        pass
    if name in ("lone_slot", "max_retries"):
        hs.append(eng.submit(prompts[2], max_new_tokens=n))  # still serves
        while eng.step():
            pass
    if pinned:
        eng.kv_release_pages(pinned)
    if inj.plans and not inj.log:
        raise AssertionError(f"{device} {name}: the plan never fired")
    check_quiesced(eng)
    return {"out": [_outcome(h) for h in hs],
            "lifecycle": eng.lifecycle_stats(),
            "lanes": {k: eng.stats[k] for k in (
                "preemptions", "batch_preemptions", "batch_tokens")},
            "stopped": eng.load_report()["stopped"]}


def phase_engine_faults(tl, seed: int, card_device: str = "cuda") -> dict:
    """Phase 3's reduced fp32 model through the same ``FaultInjector``
    plans on the card and on the CPU: a fault at each dispatch site
    (prefill, decode, spec with spec_len 4), a readback fault, 2 rounds
    of allocator exhaustion, a plan that exhausts ``max_retries``, the
    lone slot a donor pin starves, and batch rollouts preempted by an
    online burst on the fp and the int8 pool (with the prefix cache).
    The same streams (int8: or a parting at a near-tie), failed requests,
    error types and ``lifecycle_stats()`` on both; both quiesced.
    (``card_device="cpu"`` rehearses the phase without a card.)"""
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, cfg.vocab_size, n).tolist()
               for n in (1, 16, 17, 45)]
    prompts.append(g.integers(0, cfg.vocab_size, 8).tolist() * 4)
    models = {d: tl.build_model(cfg, sd, d) for d in ("cpu", card_device)}
    # per case: the requests that fail and their error types, and the
    # faults contained
    want = {
        "dispatch_prefill": ({1: "ValueError"}, 1),
        "dispatch_decode": ({2: "RuntimeError"}, 1),
        "dispatch_spec": ({1: "RuntimeError"}, 1),
        "readback": ({3: "OSError"}, 1),
        "exhaust_alloc": ({}, 0),
        "max_retries": ({0: "RequestError", 1: "RuntimeError",
                         2: "RequestError", 3: "RequestError"}, 1),
        "lone_slot": ({0: "RequestError"}, 1),
        "lanes_fp": ({}, 0), "lanes_int8": ({}, 0)}
    res = {}
    for name, (want_failed, want_contained) in want.items():
        cpu = _fault_case(models["cpu"], "cpu", name, prompts, 16)
        card = _fault_case(models[card_device], card_device, name,
                           prompts, 16)
        failed = {i: o[1] for i, o in enumerate(card["out"])
                  if o[0] == "err"}
        gaps = []
        if name == "lanes_int8":
            # int8 bytes differ across devices by one step here and
            # there: a stream may part at a near-tie (as above)
            gaps = _int8_parting_gaps(
                models["cpu"], prompts[:4] + prompts[3:],
                [o[1] for o in cpu["out"]], [o[1] for o in card["out"]])
            same = (all(o[0] == "ok" for o in cpu["out"] + card["out"])
                    and all(x <= INT8_LOGIT_SLACK for x in gaps)
                    and {k: v for k, v in cpu.items() if k != "out"}
                    == {k: v for k, v in card.items() if k != "out"})
        else:
            same = cpu == card
        if not same:
            raise AssertionError(f"phase 3 {name}: card and CPU differ:\n"
                                 f"{card}\n{cpu}")
        lanes = card["lanes"]
        if (failed != want_failed or card["stopped"]
                or card["lifecycle"]["contained_faults"] != want_contained
                or (name.startswith("lanes")
                    and not lanes["preemptions"]
                    == lanes["batch_preemptions"] >= 1)):
            raise AssertionError(f"phase 3 {name}: failed {failed}, "
                                 f"{card['lifecycle']}, {lanes}")
        res[name] = {"failed": failed, "lifecycle": card["lifecycle"],
                     "lanes": card["lanes"], "int8_parting_gaps": gaps}
    print(f"phase 3: fault plans card == CPU (fp32, phase 3's model): "
          f"{', '.join(f'{k} failed {v['failed']}' for k, v in res.items())}"
          f"; every survivor's stream, error type and lifecycle_stats() "
          f"equal, both engines quiesced; lanes: batch preemptions "
          f"{res['lanes_fp']['lanes']['batch_preemptions']} (fp) / "
          f"{res['lanes_int8']['lanes']['batch_preemptions']} (int8, "
          f"{len(res['lanes_int8']['int8_parting_gaps'])} streams parted "
          f"at near-ties)")
    return res


class _ReadyReadbacks:
    """Within the block, the engine's readback readiness probe answers
    True on every device: a drain then takes each readback in the round
    the CPU does (blocking on the card until its copy is done), so the
    rounds in which tokens are emitted — and so the event log and who
    had streamed when a replica dies — are the same on the card and on
    the CPU. Restored on exit."""

    def __enter__(self):
        from ray_tpu_torch.serve import engine
        self._cls = engine._Readback
        self._ready = self._cls.ready
        self._cls.ready = lambda rb: True
        return self

    def __exit__(self, *exc):
        self._cls.ready = self._ready


def _gated_engine():
    """An ``LLMEngine`` whose scheduler thread starts at ``go()``, not at
    the pool's ``start()``: a wave is queued whole before its first
    round, so every replica's rounds are the same on every device."""
    from ray_tpu_torch.serve.engine import LLMEngine

    class _Gated(LLMEngine):
        def start(self):
            return self

        def go(self):
            return LLMEngine.start(self)

    return _Gated


class _FakeClock:
    """A clock that moves only by ``advance``."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _clocked_engine(cls, clock):
    """``cls`` (an ``LLMEngine`` class) whose ``load_report`` ages the
    heartbeat on ``clock``: each stamp of ``_hb`` also reads ``clock``,
    and ``heartbeat_age_s`` is ``clock()`` less that reading. On a
    ``_FakeClock`` the engine looks stalled only as far as the clock is
    advanced, however slow the host's rounds."""

    class _Clocked(cls):
        @property
        def _hb(self):
            return self._hb_wall

        @_hb.setter
        def _hb(self, t):
            self._hb_wall = t
            self._hb_clock = clock()

        def _report_locked(self, digest: bool = True):
            rpt = super()._report_locked(digest)
            rpt["heartbeat_age_s"] = clock() - self._hb_clock
            return rpt

    return _Clocked


def _await_hang(victim, plan, timeout_s: float = 120.0) -> None:
    """Wait until ``plan`` (a hang) holds ``victim``'s scheduler with
    work queued."""
    end = time.monotonic() + timeout_s
    while not (plan.fired and victim.load_report()["has_work"]):
        if time.monotonic() > end:
            raise AssertionError("the hang never engaged")
        time.sleep(0.01)


def _tick_wedge(wd, clock, victim, plan) -> None:
    """Drive ``wd`` through a wedge of ``victim``, whose heartbeat ages
    on ``clock`` (a ``_FakeClock``; the other replicas' on clocks that
    never move, so that a resubmit landing on an idle survivor finds it
    HEALTHY): once ``plan`` (a hang) holds the victim's scheduler with
    work queued, advance the clock to the suspect age and tick, then to
    the stall deadline and tick."""
    _await_hang(victim, plan)
    clock.advance(wd.suspect_after_s)
    wd.tick()
    clock.advance(wd.stall_deadline_s - wd.suspect_after_s)
    wd.tick()


def _pool_kill_case(model, device: str, prompts, n: int) -> dict:
    """Phase 3's pool case on ``device``: a pool of two engines (fp32,
    4 slots, the lockstep loop), every prompt routed before any round,
    then a ``kill_replica`` plan takes replica 0 down at its round 6.
    Returns the routes, each request's outcome, the pool's events
    (kind, replica) and its counters, after ``check_pool_quiesced``."""
    from ray_tpu_torch.serve.engine_pool import EnginePool
    from ray_tpu_torch.serve.faults import (FaultInjector,
                                            check_pool_quiesced)
    gated = _gated_engine()
    inj = FaultInjector()
    inj.kill_replica(round=6)

    def factory(idx):
        return gated(model, max_slots=4, page_size=16, n_pages=64, chunk=2,
                     prefill_chunk=16, seed=idx, overlap=False,
                     fault_injector=inj if idx == 0 else None,
                     device=device)

    pool = EnginePool(factory, 2)
    with _ReadyReadbacks():
        hs = [pool.submit(p, max_new_tokens=n) for p in prompts]
        routes = [h.replica_idx for h in hs]
        for eng in pool.engines():
            eng.go()
        outs = [_outcome(h) for h in hs]
        served = [h.replica_idx for h in hs]
    if not inj.log:
        raise AssertionError(f"{device}: the kill never fired")
    pool.shutdown()
    check_pool_quiesced(pool)
    st = pool.pool_stats()
    return {"routes": routes, "served_by": served, "out": outs,
            "events": [(e[2], e[4]) for e in pool.events.snapshot()],
            "counters": {k: st.get(k, 0) for k in (
                "routed", "requeues", "replica_deaths", "route_p2c")}}


def _event_case(model, device: str, prompts, n: int, flight_dir: str
                ) -> dict:
    """Phase 3's event case on ``device``: one engine (fp32, the
    lockstep loop, driven by ``step()``), a decode fault on slot 1 at
    round 2 with ``flight_dir``. Returns the outcomes, the event log
    without its times, ``sched_trace`` and the bundle's culprit."""
    from ray_tpu_torch.serve import obs
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.faults import FaultInjector, check_quiesced
    inj = FaultInjector()
    inj.inject("dispatch_decode", sid=1, round=2,
               exc=RuntimeError("decode fault"))
    eng = LLMEngine(model, max_slots=4, page_size=16, n_pages=64, chunk=4,
                    overlap=False, fault_injector=inj,
                    flight_dir=flight_dir, device=device)
    with _ReadyReadbacks():
        hs = [eng.submit(p, max_new_tokens=n) for p in prompts[:4]]
        while eng.step():
            pass
    if not inj.log:
        raise AssertionError(f"{device}: the decode fault never fired")
    check_quiesced(eng)
    (bdir,) = [os.path.join(flight_dir, d) for d in os.listdir(flight_dir)]
    bundle = obs.load_flight_bundle(bdir)
    fault = [ev for ev in bundle["engine"]["events"]
             if ev["type"] == "fault"][-1]
    return {"out": [_outcome(h) for h in hs],
            "events": [(e[obs.ETYPE], e[obs.RID], e[obs.SID],
                        {k: v for k, v in e[obs.DATA].items()
                         if not k.endswith("_s")}
                        if isinstance(e[obs.DATA], dict) else e[obs.DATA])
                       for e in eng.events.snapshot()],
            "sched_trace": list(eng.sched_trace),
            "culprit": (bundle["reason"], fault["rid"], fault["sid"])}


def phase_pool_events(tl, seed: int, card_device: str = "cuda") -> dict:
    """Phase 3's pool and event cases, card vs CPU, on phase 3's reduced
    fp32 model: (1) a pool of two engines under a ``kill_replica`` plan
    on replica 0 — the same routes, the same requests resubmitted or
    failed typed, every stream equal, the same pool events; (2) one
    engine with a contained decode fault and ``flight_dir`` — the same
    event log (kinds, requests, slots, data but times), ``sched_trace``
    and the bundle's culprit. (``card_device="cpu"`` rehearses it.)"""
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed + 13)
    prompts = [g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (5, 16, 17, 30, 45, 9, 23, 40)]
    models = {d: tl.build_model(cfg, sd, d) for d in ("cpu", card_device)}
    res = {}
    pool = {d: _pool_kill_case(models[d], d, prompts, 16)
            for d in ("cpu", card_device)}
    card = pool[card_device]
    kinds = {o[1] if o[0] == "err" else "ok" for o in card["out"]}
    checks = {
        "card == CPU": pool["cpu"] == card,
        "requests resubmitted": card["counters"]["requeues"] >= 1,
        "a partial stream failed typed": any(
            o == ("err", "EngineShutdown", o[2]) for o in card["out"]
            if o[0] == "err"),
        "only typed failures": kinds <= {"ok", "EngineShutdown"},
        "one replica death": card["counters"]["replica_deaths"] == 1,
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3 pool kill: {checks}\ncard {card}\n"
                             f"cpu {pool['cpu']}")
    res["pool_kill"] = {
        "routes": card["routes"], "counters": card["counters"],
        "failed_typed": sum(1 for o in card["out"] if o[0] == "err"),
        "pool_events": [k for k, _r in card["events"]]}
    ev = {}
    for d in ("cpu", card_device):
        with tempfile.TemporaryDirectory() as tmp:
            ev[d] = _event_case(models[d], d, prompts, 16, tmp)
    if ev["cpu"] != ev[card_device] or ev["cpu"]["culprit"][0] != \
            "engine-fault":
        raise AssertionError(f"phase 3 events: card and CPU differ:\n"
                             f"{ev[card_device]}\n{ev['cpu']}")
    res["events"] = {"n_events": len(ev["cpu"]["events"]),
                     "culprit": ev["cpu"]["culprit"],
                     "failed": [i for i, o in enumerate(ev["cpu"]["out"])
                                if o[0] == "err"]}
    print(f"phase 3: pool of 2 under kill_replica, card == CPU: routes "
          f"{card['routes']}, {card['counters']['requeues']} resubmitted, "
          f"{res['pool_kill']['failed_typed']} partial streams failed "
          f"typed, pool events {res['pool_kill']['pool_events']}; one "
          f"engine with a decode fault: {res['events']['n_events']} "
          f"events equal card vs CPU (kinds, rids, slots, data), flight "
          f"bundle culprit {res['events']['culprit']}")
    return res


def _disagg_case(model, device: str, prompts, n: int) -> dict:
    """Phase 3's disaggregated case on ``device``: a pool of one prefill
    and one decode engine (fp32, 4 slots, 16-token pages, the prefix
    cache), every prompt's first leg submitted, then each stream read
    in turn. Returns the streams, the pool's events (kind, replica),
    handoffs, fallbacks and the decode engine's pull counters, after
    ``check_pool_quiesced``."""
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.engine_pool import EnginePool
    from ray_tpu_torch.serve.faults import check_pool_quiesced

    def factory(idx):
        return LLMEngine(model, max_slots=4, page_size=16, n_pages=64,
                         chunk=2, prefill_chunk=16, seed=idx,
                         prefix_cache=True, device=device)

    pool = EnginePool(factory, 2, roles=["prefill", "decode"],
                      share_prefixes=True)
    hs = [pool.submit(p, max_new_tokens=n) for p in prompts]
    outs = [_outcome(h) for h in hs]
    for e in pool.engines():
        e.wait_idle(60)
    ps = pool.pool_stats()
    mig = pool.replica(1).engine.kv_migration_stats
    pool.shutdown()
    check_pool_quiesced(pool)
    return {"out": outs,
            "events": [(e[2], e[4]) for e in pool.events.snapshot()],
            "handoffs": ps.get("disagg_handoffs", 0),
            "fallbacks": ps.get("disagg_handoff_fallbacks", 0),
            "pulls": {k: mig[k] for k in ("pulls", "pulled_pages",
                                          "fallbacks")},
            "wire_bytes": mig["wire_bytes"]}


def _watchdog_case(model, device: str, prompts, n: int, flight_dir: str
                   ) -> dict:
    """Phase 3's watchdog case on ``device``: a pool of two engines
    (fp32, 4 slots, the lockstep loop, every readback taken in the CPU's
    round), every prompt routed before any round, a ``hang`` at replica
    0's step in its round 6 and a ``PoolWatchdog`` (stall deadline 1 s):
    on the card polling every 10 ms on the wall clock from the start of
    the rounds; on the CPU, whose rounds under a loaded host can take
    as long as the deadline, ticked on a ``_FakeClock`` that replica 0's
    heartbeat reads too (replica 1's a clock that never moves), advanced
    only once the hang holds replica 0 (``_tick_wedge``). Returns the
    routes, each
    request's outcome (error types only: their messages carry the
    measured stall), the pool's events up to the death and the rest
    counted, the watchdog's log of replica 0, and the counters, after
    releasing the zombie (it must commit nothing) and
    ``check_pool_quiesced``. The survivor's own suspect -> recovered
    false alarms are kept apart (``survivor_alarms``): one fires when a
    resubmit lands on it while it idles, before its scheduler wakes and
    touches the heartbeat, so whether it does depends on timing."""
    from ray_tpu_torch.serve.engine_pool import EnginePool
    from ray_tpu_torch.serve.faults import (FaultInjector,
                                            check_pool_quiesced)
    from ray_tpu_torch.serve.watchdog import PoolWatchdog
    clock = _FakeClock() if device == "cpu" else None
    gated = _gated_engine()
    classes = [gated, gated]
    if clock is not None:
        classes = [_clocked_engine(gated, clock),
                   _clocked_engine(gated, _FakeClock())]
    inj = FaultInjector()
    hang = inj.hang("step", round=6)

    def factory(idx):
        return classes[idx](model, max_slots=4, page_size=16, n_pages=64, chunk=2,
                     prefill_chunk=16, seed=idx, overlap=False,
                     fault_injector=inj if idx == 0 else None,
                     device=device)

    pool = EnginePool(factory, 2)
    wd = PoolWatchdog(pool, stall_deadline_s=1.0, poll_interval_s=0.01,
                      time_fn=clock or time.monotonic,
                      flight_dir=flight_dir)
    victim = pool.replica(0).engine
    try:
        with _ReadyReadbacks():
            hs = [pool.submit(p, max_new_tokens=n) for p in prompts]
            routes = [h.replica_idx for h in hs]
            for eng in pool.engines():
                eng.go()
            if clock is None:
                wd.run()
            outs = [None] * len(hs)

            def read(i):
                try:
                    outs[i] = ("ok", hs[i].result())
                except Exception as e:  # noqa: BLE001 - typed below
                    outs[i] = ("err", type(e).__name__,
                               len(hs[i]._generated))

            threads = [threading.Thread(target=read, args=(i,))
                       for i in range(len(hs))]
            for t in threads:
                t.start()
            if clock is not None:
                _tick_wedge(wd, clock, victim, hang)
            for t in threads:
                t.join(timeout=120)
        held = list(victim._wait) + [s.req for s in victim.slots
                                     if s is not None]
        committed = [len(r.generated) for r in held]
        inj.release_all()
        victim._thread.join(timeout=30)
        if victim._thread.is_alive():
            raise AssertionError(f"{device}: the released zombie lives")
        zombie_ok = committed == [len(r.generated) for r in held]
    finally:
        wd.stop()
        inj.release_all()
        pool.shutdown()
    check_pool_quiesced(pool)
    alarms = {("suspect", 1), ("suspect_cleared", 1)}
    kinds = [(e[2], e[4]) for e in pool.events.snapshot()
             if (e[2], e[4]) not in alarms]
    cut = kinds.index(("replica_death", 0)) + 1
    st = pool.route_stats
    return {"routes": routes, "out": outs, "events": kinds[:cut],
            "after": sorted(collections.Counter(kinds[cut:]).items()),
            "log": [(e["event"], e["replica"]) for e in wd.log
                    if e["replica"] == 0],
            "survivor_alarms": [e["event"] for e in wd.log
                                if e["replica"] == 1],
            "bundle": any(e["event"] == "wedged" and e.get("bundle")
                          for e in wd.log),
            "zombie_committed_nothing": zombie_ok,
            "counters": {k: st.get(k, 0) for k in (
                "requeues", "replica_deaths", "wedged")}}


def phase_pool_control(tl, seed: int, card_device: str = "cuda") -> dict:
    """Phase 3's disaggregated and watchdog cases, card vs CPU, on phase
    3's reduced fp32 model: (1) one prefill and one decode engine — the
    same streams, events, handoffs and pulls; (2) a ``hang`` wedged by
    the ``PoolWatchdog`` — the same suspect -> wedged sequence, the
    streamed requests failed typed, the others resubmitted and equal,
    the zombie fenced. (``card_device="cpu"`` rehearses it.)"""
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    g = np.random.default_rng(seed + 13)
    prompts = [g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (5, 16, 17, 30, 45, 9, 23, 40)]
    models = {d: tl.build_model(cfg, sd, d) for d in ("cpu", card_device)}
    dis = {d: _disagg_case(models[d], d, prompts, 16)
           for d in ("cpu", card_device)}
    card = dis[card_device]
    want_pages = sum(len(p) // 16 for p in prompts)
    checks = {
        "card == CPU": {k: v for k, v in card.items() if k != "wire_bytes"}
        == {k: v for k, v in dis["cpu"].items() if k != "wire_bytes"},
        "8 handoffs, no fallback": (card["handoffs"], card["fallbacks"])
        == (8, 0),
        "a pull per prompt with a full page": card["pulls"] == {
            "pulls": sum(len(p) >= 16 for p in prompts),
            "pulled_pages": want_pages, "fallbacks": 0},
        "every stream complete": all(o[0] == "ok" and len(o[1]) == 16
                                     for o in card["out"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3 disaggregated: {checks}\ncard "
                             f"{card}\ncpu {dis['cpu']}")
    res = {"disagg": {"handoffs": card["handoffs"], "pulls": card["pulls"],
                      "wire_bytes": card["wire_bytes"]}}
    wd = {}
    for d in ("cpu", card_device):
        with tempfile.TemporaryDirectory() as tmp:
            wd[d] = _watchdog_case(models[d], d, prompts, 16, tmp)
    card = wd[card_device]
    kinds = {o[1] if o[0] == "err" else "ok" for o in card["out"]}
    on0 = [i for i, r in enumerate(card["routes"]) if r == 0]
    alarms = {d: wd[d].pop("survivor_alarms") for d in wd}
    checks = {
        "card == CPU": wd["cpu"] == card,
        "the survivor's false alarms cleared": all(
            a == ["suspect", "recovered"] * (len(a) // 2)
            for a in alarms.values()),
        "suspect, then wedged": card["log"] == [("suspect", 0),
                                                ("wedged", 0)]
        and card["events"][-3:] == [("suspect", 0), ("wedged", 0),
                                    ("replica_death", 0)],
        "the bundle written": card["bundle"],
        "streamed ones failed typed, after tokens": all(
            o[1] == "EngineShutdown" and o[2] > 0
            for o in card["out"] if o[0] == "err"),
        "some failed, some resubmitted": kinds == {"ok", "EngineShutdown"}
        and card["counters"]["requeues"] >= 1,
        "replica 1's own requests complete": all(
            card["out"][i][0] == "ok" for i in range(len(prompts))
            if i not in on0),
        "the zombie committed nothing": card["zombie_committed_nothing"],
        "one wedge, one death": (card["counters"]["wedged"],
                                 card["counters"]["replica_deaths"])
        == (1, 1),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3 watchdog: {checks}\ncard {card}\n"
                             f"cpu {wd['cpu']}\nalarms {alarms}")
    res["watchdog"] = {"routes": card["routes"],
                       "counters": card["counters"],
                       "survivor_alarms": alarms[card_device],
                       "failed_typed": sum(1 for o in card["out"]
                                           if o[0] == "err")}
    print(f"phase 3: disaggregated pool (1 prefill + 1 decode), card == "
          f"CPU: 8 handoffs, pulls {res['disagg']['pulls']}, "
          f"{res['disagg']['wire_bytes']} wire bytes, streams equal; "
          f"hang at replica 0's round 6 under the PoolWatchdog, card == "
          f"CPU: suspect -> wedged -> death, "
          f"{res['watchdog']['failed_typed']} streamed failed typed, "
          f"{card['counters']['requeues']} resubmitted, the zombie "
          f"committed nothing")
    return res


def _teacher_forced_logits(model, prompt, completion,
                           kv_dtype: str = "fp",
                           device: str = "cuda") -> torch.Tensor:
    """fp32 logits [len(completion), vocab] that predict each completion
    token, from one T > 1 forward (gather path, no kernel) of ``model``
    (on ``device``) over prompt + completion in a fresh ``kv_dtype``
    pool."""
    from ray_tpu_torch.models.kv_cache import init_kv_pool, kv_layer_view
    ids = prompt + completion[:-1]
    Pg = 64
    n = -(-len(ids) // Pg)
    pool = init_kv_pool(model.cfg, n + 1, Pg, kv_dtype, device=device)
    pt = torch.arange(1, n + 1, dtype=torch.int32, device=device)[None]
    logits = model(torch.tensor([ids], device=device),
                   [kv_layer_view(layer, pt) for layer in pool],
                   torch.zeros(1, dtype=torch.int32, device=device))[0]
    return logits[len(prompt) - 1:]


def _probe_depth(eng, lag_cycles: int = 0) -> list:
    """Record ``load_report``'s ``fetchq_depth`` right after each decode
    dispatch of ``eng`` (the moment the pipeline is deepest; between
    steps the trailing drain has already taken the older dispatch) into
    the returned list. With ``lag_cycles`` each dispatch is queued
    behind a spin kernel of that many cycles, so the card runs behind
    the host as in a device-bound step."""
    depths = []
    dispatch = eng._dispatch_chunk_locked

    def probe(steps):
        if lag_cycles:
            torch.cuda._sleep(lag_cycles)
        dispatch(steps)
        depths.append(eng._report_locked()["fetchq_depth"])

    eng._dispatch_chunk_locked = probe     # ``del`` it to restore
    return depths


def _int8_parting_gaps(model, prompts, cpu, card) -> list:
    """Where a card stream parts from the CPU's over an int8 pool: at the
    first differing token, (top logit - logit) of the CPU's and of the
    card's token, teacher-forced on the CPU over a fresh int8 pool. The
    two pools cannot hold the same bytes: a last-bit difference of an
    fp32 K or V value flips ``round`` now and then, so one int8 element
    in a few thousand differs by one step (seen from the first round on,
    with and without speculation), and a near-tie can then go either
    way."""
    gaps = []
    for p, a, b in zip(prompts, cpu, card):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        row = _teacher_forced_logits(model, p, a[:i + 1], "int8",
                                     "cpu")[-1]
        gaps.append(max(float(row.max() - row[a[i]]),
                        float(row.max() - row[b[i]])))
    return gaps


def _teacher_forced_gaps(model, prompt, completion,
                         kv_dtype: str = "fp") -> list:
    """(top logit - logit of the generated token) at each completion
    position, teacher-forced (``_teacher_forced_logits``)."""
    rows = _teacher_forced_logits(model, prompt, completion, kv_dtype)
    tok = torch.tensor(completion, device="cuda")
    gap = rows.max(dim=-1).values - rows[torch.arange(len(completion)),
                                         tok]
    return gap.tolist()


def phase_main_path(tl, pa, seed: int, smi: str) -> dict:
    from ray_tpu_torch.models.kv_cache import kv_layer_view
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = tl.tinyllama_1_1b()
    n_new, n_req, n_stream = 64, 16, 4
    t0 = time.monotonic()
    params = tl.init_params(cfg, seed=seed, device="cuda")
    dep = LlamaDeployment(cfg, params, max_new_tokens=n_new, max_slots=16,
                          page_size=64, device="cuda")
    del params
    g = np.random.default_rng(seed)
    warm = dep(g.integers(0, cfg.vocab_size, 100).tolist())
    if len(warm) != 100 + n_new:
        raise AssertionError("warm-up request came back short")
    eng = dep.engine()
    torch.cuda.synchronize()
    t_setup = time.monotonic() - t0
    eng.reset_latency_stats()
    lengths = g.integers(16, 1537, size=n_req)
    prompts = [g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]

    streamed = [None] * n_stream
    stamps = [[] for _ in range(n_stream)]

    def stream(i):
        toks = []
        for t in dep.stream(prompts[i]):
            stamps[i].append(time.monotonic())
            toks.append(t)
        streamed[i] = toks

    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    steps0 = eng.stats["decode_steps"]
    t1 = time.monotonic()
    threads = [threading.Thread(target=stream, args=(i,))
               for i in range(n_stream)]
    for t in threads:
        t.start()
    batch = dep.generate_batch(prompts[n_stream:])
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t1
    launches = pa.paged_decode_attention.launches
    if pa.paged_decode_attention.launches_int8:
        raise AssertionError("the fp pool launched K2")
    steps = eng.stats["decode_steps"] - steps0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a streaming request did not finish")
    outs = streamed + batch
    if any(o is None or len(o) != n_new for o in outs):
        raise AssertionError(
            f"requests came back short: {[len(o or []) for o in outs]}")
    if steps <= 0 or launches != cfg.n_layers * steps:
        raise AssertionError(
            f"K1 launches {launches} != {cfg.n_layers} layers x {steps} "
            f"decode steps")

    # Teacher-forced check of 2 requests, at the same limit twice: the
    # same forward in bf16 (two bf16 paths, each with its own rounding),
    # and the same bf16 weights evaluated in fp32 (exact upcast), whose
    # gap measures the engine's own bf16 rounding.
    checked = (0, n_stream)
    gaps_bf16 = [g for i in checked
                 for g in _teacher_forced_gaps(dep.model, prompts[i],
                                               outs[i])]
    ref32 = tl.build_model(
        dataclasses.replace(cfg, dtype=torch.float32),
        {k: v.float() for k, v in dep.model.state_dict().items()}, "cuda")
    gaps = [g for i in checked
            for g in _teacher_forced_gaps(ref32, prompts[i], outs[i])]
    del ref32
    for kind, gs in (("bf16", gaps_bf16), ("fp32", gaps)):
        if max(gs) > LOGIT_SLACK:
            raise AssertionError(
                f"teacher-forced check: a generated token sits {max(gs)}"
                f" below the top {kind} logit (allowed {LOGIT_SLACK})")

    # ms per decode step at 16 slots: the engine's decode body (one
    # single-token forward + greedy pick) on the served pool, paced by
    # the host as in the engine, after the main path's counts are read
    pool_pages = eng.pages
    pt = torch.arange(1, 16 * 32 + 1, dtype=torch.int32,
                      device="cuda").reshape(16, 32)
    kv = [kv_layer_view(layer, pt) for layer in pool_pages]
    pos = torch.tensor((lengths + n_new - 1).tolist(), dtype=torch.int32,
                       device="cuda")
    cur = torch.zeros(16, dtype=torch.int32, device="cuda")
    for _ in range(3):
        cur = tl._pick_token(dep.model(cur[:, None], kv, pos)[:, -1], 0.0)
    torch.cuda.synchronize()
    n_steps = 20
    ts = time.monotonic()
    for _ in range(n_steps):
        cur = tl._pick_token(dep.model(cur[:, None], kv, pos)[:, -1], 0.0)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - ts) / n_steps * 1e3

    # 2 more of those decode steps, for main() to profile once the timed
    # phases are over (the check of which split pass they run)
    def two_steps():
        step_cur = cur
        for _ in range(2):
            step_cur = tl._pick_token(
                dep.model(step_cur[:, None], kv, pos)[:, -1], 0.0)

    ttfts = sorted(eng.ttfts_s)
    # time per output token of each streamed request (first to last
    # token): tokens reach a stream in bursts, one per readback
    tpots = sorted((s[-1] - s[0]) / (len(s) - 1) for s in stamps)
    res = {
        "card": smi, "model": "tinyllama_1_1b bf16 (random weights, "
        f"seed {seed})", "requests": n_req, "new_tokens": n_new,
        "prompt_tokens": int(lengths.sum()), "wall_s": wall,
        "output_tok_s": n_req * n_new / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "tpot_p50_s": tpots[len(tpots) // 2],
        "decode_step_ms_16_slots": step_ms,
        "decode_steps": steps, "k1_launches": launches,
        "teacher_forced_max_gap_fp32": max(gaps),
        "teacher_forced_not_top_fp32": sum(g > 0 for g in gaps),
        "teacher_forced_max_gap_bf16": max(gaps_bf16),
        "teacher_forced_not_top_bf16": sum(g > 0 for g in gaps_bf16),
        "teacher_forced_positions": len(gaps), "setup_s": t_setup,
        "stats": dict(eng.stats)}
    print(f"phase 4: TinyLlama-1.1B bf16 via LlamaDeployment, {n_req} "
          f"requests x {n_new} tokens (prompts {int(lengths.min())}-"
          f"{int(lengths.max())}) on {smi}: output {res['output_tok_s']:.1f}"
          f" tok/s, TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms, time per "
          f"output token p50 {res['tpot_p50_s'] * 1e3:.2f} ms (streams), "
          f"decode step (16 slots) "
          f"{step_ms:.2f} ms; K1 launched {launches} times = "
          f"{cfg.n_layers} layers x {steps} decode steps; teacher-forced "
          f"over {len(gaps)} tokens: max gap to the top logit "
          f"{max(gaps):.4f} in fp32 ({res['teacher_forced_not_top_fp32']}"
          f" not top), {max(gaps_bf16):.4f} in bf16 "
          f"({res['teacher_forced_not_top_bf16']} not top)")
    dep.shutdown()
    return res, two_steps


def _expected_hits(cached_prompts, prompt, Pg: int) -> int:
    """Prompt tokens a prefix-cache admission skips: the longest run of
    full pages ``prompt`` shares with a retired prompt (whose full
    pages the cache holds), one token less when that is the whole
    prompt (its last token is re-prefilled into a COW copy)."""
    best = 0
    for c in cached_prompts:
        n = 0
        while (n + 1) * Pg <= min(len(c), len(prompt)) and \
                c[n * Pg:(n + 1) * Pg] == prompt[n * Pg:(n + 1) * Pg]:
            n += 1
        best = max(best, n * Pg)
    return best - 1 if best == len(prompt) else best


def _chat_traffic(vocab: int, seed: int) -> tuple:
    """Phase 4b's chat traffic, from ``default_rng(seed + 1)``: a
    100-token warm-up prompt; one 1024-token system prompt; two
    page-aligned prompts (512, 1024 tokens); wave 1: 4 prompts behind
    the system prompt (own 16-512-token tails), the page-aligned two, 2
    random of 16-1536 tokens; wave 2: 4 more behind the system prompt,
    exact repeats of the page-aligned two (fully cached: the COW path),
    2 random."""
    g = np.random.default_rng(seed + 1)

    def rand(n):
        return g.integers(0, vocab, int(n)).tolist()

    warm = rand(100)
    system = rand(1024)
    aligned = [rand(512), rand(1024)]
    wave1 = ([system + rand(n) for n in g.integers(16, 513, 4)] + aligned
             + [rand(n) for n in g.integers(16, 1537, 2)])
    wave2 = ([system + rand(n) for n in g.integers(16, 513, 4)] + aligned
             + [rand(n) for n in g.integers(16, 1537, 2)])
    return warm, system, aligned, wave1, wave2


def phase_int8_prefix_path(tl, pa, seed: int, smi: str) -> dict:
    """The int8 KV + prefix-cache main path at full width: two waves of
    chat traffic behind one TinyLlama-1.1B replica."""
    from ray_tpu_torch.models.kv_cache import (kv_layer_view,
                                               kv_pool_page_bytes)
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = tl.tinyllama_1_1b()
    n_new, Pg = 64, 64
    t0 = time.monotonic()
    params = tl.init_params(cfg, seed=seed, device="cuda")
    dep = LlamaDeployment(cfg, params, max_new_tokens=n_new, max_slots=16,
                          page_size=Pg, kv_dtype="int8", prefix_cache=True,
                          device="cuda")
    del params
    warm_prompt, system, aligned, wave1, wave2 = _chat_traffic(
        cfg.vocab_size, seed)
    if len(dep(warm_prompt)) != 100 + n_new:
        raise AssertionError("warm-up request came back short")
    eng = dep.engine()
    if eng.kv_dtype != "int8" or eng.alloc.n_pages != 513:
        raise AssertionError(f"pool {eng.kv_dtype} x {eng.alloc.n_pages}")
    torch.cuda.synchronize()
    t_setup = time.monotonic() - t0
    eng.reset_latency_stats()

    want_hits = [_expected_hits([warm_prompt] + wave1, p, Pg)
                 for p in wave2]
    if sum(want_hits) != 4 * 1024 + 511 + 1023:
        raise AssertionError(f"expected hits {want_hits}")

    n_stream = 4
    streamed = [None] * n_stream

    def stream(i):
        streamed[i] = list(dep.stream(wave1[i]))

    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    steps0 = eng.stats["decode_steps"]
    t1 = time.monotonic()
    threads = [threading.Thread(target=stream, args=(i,))
               for i in range(n_stream)]
    for t in threads:
        t.start()
    batch1 = dep.generate_batch(wave1[n_stream:])
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a streaming request did not finish")
    if not eng.wait_idle(timeout_s=60):
        raise AssertionError("engine not idle after wave 1")
    wall1 = time.monotonic() - t1
    n_ttft1 = len(eng.ttfts_s)
    hits0 = (eng.stats["cache_hit_tokens"],
             eng.stats["cache_hit_admissions"])
    t2 = time.monotonic()
    batch2 = dep.generate_batch(wave2)
    if not eng.wait_idle(timeout_s=60):
        raise AssertionError("engine not idle after wave 2")
    wall = wall1 + time.monotonic() - t2
    launches = (pa.paged_decode_attention.launches,
                pa.paged_decode_attention.launches_int8)
    steps = eng.stats["decode_steps"] - steps0
    hits = (eng.stats["cache_hit_tokens"] - hits0[0],
            eng.stats["cache_hit_admissions"] - hits0[1])

    outs = streamed + batch1 + batch2
    if any(o is None or len(o) != n_new for o in outs):
        raise AssertionError(
            f"requests came back short: {[len(o or []) for o in outs]}")
    if steps <= 0 or launches != (0, cfg.n_layers * steps):
        raise AssertionError(
            f"(K1, K2) launches {launches} != (0, {cfg.n_layers} layers x "
            f"{steps} decode steps)")
    if hits != (sum(want_hits), 6):
        raise AssertionError(f"wave 2 hit tokens and admissions {hits}, "
                             f"want ({sum(want_hits)}, 6)")
    if eng.alloc.occupancy() != eng.prefix_cache.cached_pages:
        raise AssertionError(
            f"pool occupancy {eng.alloc.occupancy()} != cached pages "
            f"{eng.prefix_cache.cached_pages}")
    eng.prefix_cache.check_invariants()

    # Teacher-forced check of 2 wave-2 requests, a prefix hit and a COW
    # repeat: the same bf16 weights evaluated in fp32 over an fp pool,
    # and the bf16 model over a fresh int8 pool (T > 1 gather path)
    checked = [(wave2[0], batch2[0]), (wave2[4], batch2[4])]
    gaps_int8 = [x for p, o in checked
                 for x in _teacher_forced_gaps(dep.model, p, o, "int8")]
    ref32 = tl.build_model(
        dataclasses.replace(cfg, dtype=torch.float32),
        {k: v.float() for k, v in dep.model.state_dict().items()}, "cuda")
    gaps = [x for p, o in checked
            for x in _teacher_forced_gaps(ref32, p, o)]
    del ref32
    for kind, gs in (("fp32, fp pool", gaps), ("bf16, int8 pool",
                                               gaps_int8)):
        if max(gs) > INT8_LOGIT_SLACK:
            raise AssertionError(
                f"teacher-forced check: a generated token sits {max(gs)}"
                f" below the top logit ({kind}; allowed "
                f"{INT8_LOGIT_SLACK})")

    report = eng.load_report()
    fp_page_bytes = kv_pool_page_bytes(cfg, Pg, "fp")
    if report["kv_page_bytes"] != kv_pool_page_bytes(cfg, Pg, "int8"):
        raise AssertionError(f"kv_page_bytes {report['kv_page_bytes']}")

    # ms per decode step at 16 slots on the int8 pool (the engine's
    # decode body, host-paced), after the phase's counts are read
    pt = torch.arange(1, 16 * 32 + 1, dtype=torch.int32,
                      device="cuda").reshape(16, 32)
    kv = [kv_layer_view(layer, pt) for layer in eng.pages]
    pos = torch.tensor([len(p) + n_new - 1 for p in wave1 + wave2],
                       dtype=torch.int32, device="cuda").clamp(max=2047)
    cur = torch.zeros(16, dtype=torch.int32, device="cuda")
    for _ in range(3):
        cur = tl._pick_token(dep.model(cur[:, None], kv, pos)[:, -1], 0.0)
    torch.cuda.synchronize()
    n_steps = 20
    ts = time.monotonic()
    for _ in range(n_steps):
        cur = tl._pick_token(dep.model(cur[:, None], kv, pos)[:, -1], 0.0)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - ts) / n_steps * 1e3

    # 2 more of those decode steps, for main() to profile later
    def two_steps():
        step_cur = cur
        for _ in range(2):
            step_cur = tl._pick_token(
                dep.model(step_cur[:, None], kv, pos)[:, -1], 0.0)

    ttfts = list(eng.ttfts_s)
    p50 = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    res = {
        "card": smi, "model": "tinyllama_1_1b bf16 (random weights, "
        f"seed {seed}), int8 KV pool + prefix cache",
        "requests": len(outs), "new_tokens": n_new,
        "prompt_tokens": sum(len(p) for p in wave1 + wave2),
        "wall_s": wall, "output_tok_s": len(outs) * n_new / wall,
        "ttft_p50_s_wave1": p50(ttfts[:n_ttft1]),
        "ttft_p50_s_wave2": p50(ttfts[n_ttft1:]),
        "decode_step_ms_16_slots_int8": step_ms,
        "decode_steps": steps, "k1_launches": launches[0],
        "k2_launches": launches[1], "wave2_hit_tokens": hits[0],
        "wave2_hit_admissions": hits[1], "wave2_hit_tokens_per_request":
        want_hits, "kv_page_bytes": report["kv_page_bytes"],
        "kv_bytes_total": report["kv_bytes_total"],
        "fp_kv_page_bytes": fp_page_bytes,
        "fp_kv_bytes_total": eng.alloc.n_pages * fp_page_bytes,
        "prefix_stats": eng.prefix_cache.stats(),
        "teacher_forced_max_gap_fp32": max(gaps),
        "teacher_forced_max_gap_bf16_int8": max(gaps_int8),
        "teacher_forced_positions": len(gaps), "setup_s": t_setup,
        "stats": dict(eng.stats)}
    print(f"phase 4b: TinyLlama-1.1B bf16, int8 KV + prefix cache, "
          f"{len(outs)} requests x {n_new} tokens in 2 waves on {smi}: "
          f"output {res['output_tok_s']:.1f} tok/s, TTFT p50 wave 1 "
          f"{res['ttft_p50_s_wave1'] * 1e3:.1f} ms, wave 2 "
          f"{res['ttft_p50_s_wave2'] * 1e3:.1f} ms; decode step (16 "
          f"slots, int8 pool) {step_ms:.2f} ms; wave 2 hit "
          f"{hits[0]} tokens over {hits[1]} admissions; kv_page_bytes "
          f"{report['kv_page_bytes']} (fp {fp_page_bytes}), "
          f"kv_bytes_total {report['kv_bytes_total']} (fp "
          f"{res['fp_kv_bytes_total']}); K2 launched {launches[1]} times "
          f"= {cfg.n_layers} layers x {steps} decode steps, K1 "
          f"{launches[0]}; teacher-forced over {len(gaps)} tokens: max "
          f"gap {max(gaps):.4f} in fp32 (fp pool), {max(gaps_int8):.4f} "
          f"in bf16 (int8 pool)")
    dep.shutdown()
    return res, two_steps


def phase_static_path(tl, seed: int, smi: str) -> dict:
    """The non-engine serving path at full width: ``LlamaDeployment(
    tinyllama_1_1b(), use_engine=False)``, each request through the
    static-cache ``generate``/``generate_stream`` loops."""
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = tl.tinyllama_1_1b()
    n_new = 64
    params = tl.init_params(cfg, seed=seed, device="cuda")
    dep = LlamaDeployment(cfg, params, max_new_tokens=n_new,
                          use_engine=False, device="cuda")
    del params
    g = np.random.default_rng(seed + 2)

    def rand(n):
        return g.integers(0, cfg.vocab_size, n).tolist()

    if len(dep(rand(100))) != 100 + n_new:
        raise AssertionError("warm-up request came back short")
    prompt = rand(512)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = dep(prompt)
    call_s = time.monotonic() - t0
    stamps, streamed = [], []
    t0 = time.monotonic()
    for tok in dep.stream(prompt):
        stamps.append(time.monotonic())
        streamed.append(tok)
    if out[:512] != prompt or streamed != out[512:]:
        raise AssertionError("stream's tokens differ from __call__'s")
    # two buckets: 4 prompts of 512 tokens, 2 of 300
    prompts = [rand(512), rand(300), rand(512), rand(512), rand(300),
               rand(512)]
    t1 = time.monotonic()
    batch = dep.generate_batch(prompts)
    batch_s = time.monotonic() - t1
    if [len(b) for b in batch] != [n_new] * len(prompts):
        raise AssertionError(f"batch came back short: "
                             f"{[len(b) for b in batch]}")

    # teacher-forced through the paged T > 1 gather path, as phase 4:
    # the __call__ request and one request of each bucket, in bf16 and
    # with the same bf16 weights evaluated in fp32
    checked = [(prompt, out[512:]), (prompts[0], batch[0]),
               (prompts[1], batch[1])]
    gaps_bf16 = [x for p, o in checked
                 for x in _teacher_forced_gaps(dep.model, p, o)]
    ref32 = tl.build_model(
        dataclasses.replace(cfg, dtype=torch.float32),
        {k: v.float() for k, v in dep.model.state_dict().items()}, "cuda")
    gaps = [x for p, o in checked for x in _teacher_forced_gaps(ref32, p, o)]
    del ref32, dep
    for kind, gs in (("bf16", gaps_bf16), ("fp32", gaps)):
        if max(gs) > LOGIT_SLACK:
            raise AssertionError(
                f"teacher-forced check: a generated token sits {max(gs)}"
                f" below the top {kind} logit (allowed {LOGIT_SLACK})")
    res = {"card": smi, "model": "tinyllama_1_1b bf16 (random weights, "
           f"seed {seed}), LlamaDeployment(use_engine=False)",
           "new_tokens": n_new, "call_s": call_s,
           "stream_ttft_s": stamps[0] - t0,
           "stream_ms_per_token": (stamps[-1] - stamps[0])
           / (len(stamps) - 1) * 1e3,
           "batch_prompt_lengths": [len(p) for p in prompts],
           "batch_s": batch_s,
           "batch_tok_s": len(prompts) * n_new / batch_s,
           "teacher_forced_max_gap_fp32": max(gaps),
           "teacher_forced_max_gap_bf16": max(gaps_bf16),
           "teacher_forced_positions": len(gaps)}
    print(f"phase 4c: TinyLlama-1.1B bf16 via LlamaDeployment(use_engine="
          f"False) on {smi}: __call__ 512 + {n_new} tokens in "
          f"{call_s * 1e3:.1f} ms; stream == __call__, first token after "
          f"{res['stream_ttft_s'] * 1e3:.1f} ms, then "
          f"{res['stream_ms_per_token']:.2f} ms per token; generate_batch "
          f"(4 x 512 + 2 x 300 tokens, 2 buckets) {res['batch_tok_s']:.1f}"
          f" tok/s; teacher-forced over {len(gaps)} tokens: max gap "
          f"{max(gaps):.4f} in fp32, {max(gaps_bf16):.4f} in bf16")
    return res


def _default_loop_wave(tl, seed: int, vocab: int) -> list:
    """Phase 4d's 16 prompts: 8 repetitive — two blocks of 64-256
    tokens (two documents), each repeated whole to four lengths in
    512-1536, as in code-edit and extraction traffic over one document
    — and 8 random of 16-1536 tokens."""
    g = np.random.default_rng(seed + 4)
    prompts = []
    for _ in range(2):
        block = g.integers(0, vocab, int(g.integers(64, 257))).tolist()
        reps = np.arange(-(-512 // len(block)), 1536 // len(block) + 1)
        for k in g.choice(reps, 4, replace=len(reps) < 4):
            prompts.append(block * int(k))
    prompts += [g.integers(0, vocab, int(n)).tolist()
                for n in g.integers(16, 1537, 8)]
    return prompts


def _run_wave(dep, prompts, gaps=None, hooks=None) -> tuple:
    """Every prompt (token ids or a dict payload) streamed by its own
    thread, thread i started ``gaps[i]`` seconds after thread i - 1 (no
    ``gaps``: all at once), ``hooks[i]()`` called right after thread i
    started: (streams, token stamps, wall seconds, each thread's
    start)."""
    outs = [None] * len(prompts)
    stamps = [[] for _ in prompts]
    starts = [None] * len(prompts)

    def stream(i):
        starts[i] = time.monotonic()
        toks = []
        for t in dep.stream(prompts[i]):
            stamps[i].append(time.monotonic())
            toks.append(t)
        outs[i] = toks

    t0 = time.monotonic()
    threads = [threading.Thread(target=stream, args=(i,))
               for i in range(len(prompts))]
    for i, (t, gap) in enumerate(zip(threads,
                                     gaps or [0.0] * len(threads))):
        if gap:
            time.sleep(gap)
        t.start()
        if hooks and i in hooks:
            hooks[i]()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a streaming request did not finish")
    return outs, stamps, time.monotonic() - t0, starts


def phase_default_loop_path(tl, pa, seed: int, smi: str) -> tuple:
    """Phase 4d: the engine's default loop at full width — the lockstep
    loop, the overlapped loop, and the overlapped loop with n-gram
    speculation — over one wave with an eos, then logprob capture."""
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = tl.tinyllama_1_1b()
    n_new, Pg = 64, 64
    params = tl.init_params(cfg, seed=seed, device="cuda")
    prompts = _default_loop_wave(tl, seed, cfg.vocab_size)
    p50 = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731

    def deployment(**kw):
        # the deployments share ``params`` (build_model does not copy)
        return LlamaDeployment(cfg, params, max_new_tokens=n_new,
                               max_slots=16, page_size=Pg, device="cuda",
                               **kw)

    # the eos: of the wave served without one, the token that the most
    # streams first emit mid-stream (at their 5th token or later), then
    # the most frequent — an eos that ends several requests early
    # after some decoding, not one stream's repeated token
    dep = deployment()
    warm = dep.generate_batch(prompts)
    dep.shutdown()
    del dep
    counts = collections.Counter(t for o in warm for t in o)
    streams = collections.Counter(t for o in warm for t in set(o)
                                  if o.index(t) >= 4)
    eos = max(streams, key=lambda t: (streams[t], counts[t]))
    print(f"phase 4d: warm-up wave without an eos: eos {eos}, first "
          f"emitted mid-stream by {streams[eos]} of {len(warm)} streams, "
          f"{counts[eos]} times in all")

    arms = (("lockstep", dict(overlap=False, spec_len=0)),
            ("overlap", dict(overlap=True, spec_len=0)),
            ("overlap+spec", dict(overlap=True, spec_len=4)))
    res = {"card": smi, "model": "tinyllama_1_1b bf16 (random weights, "
           f"seed {seed})", "requests": len(prompts), "new_tokens": n_new,
           "prompt_tokens": sum(map(len, prompts)), "eos_id": eos,
           "eos_count_in_warm_wave": counts[eos],
           "eos_mid_stream_in_warm_wave": streams[eos], "arms": {}}
    for name, kw in arms:
        dep = deployment(eos_id=eos, **kw)
        eng = dep.engine()
        dep(prompts[0][:100])           # the verify and the decode warm
        eng.reset_latency_stats()
        depths = _probe_depth(eng)
        stats0 = dict(eng.stats)
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention.launches_int8 = 0
        outs, stamps, wall, _ = _run_wave(dep, prompts)
        launches = (pa.paged_decode_attention.launches,
                    pa.paged_decode_attention.launches_int8)
        del eng._dispatch_chunk_locked      # the probe's reference cycle
        delta = {k: eng.stats[k] - stats0.get(k, 0)
                 for k in ("decode_steps", "chunks", "spec_rounds",
                           "spec_riders", "spec_proposed", "spec_accepted",
                           "spec_tokens")}
        bad = [i for i, o in enumerate(outs)
               if not (o and (o.index(eos) == len(o) - 1 if eos in o
                              else len(o) == n_new))]
        if bad:
            raise AssertionError(f"{name}: streams {bad} do not end at "
                                 f"their first eos {eos} or at {n_new}")
        early = sum(len(o) < n_new for o in outs)
        if early < 4:
            raise AssertionError(f"{name}: only {early} requests ended "
                                 f"early at the eos {eos}")
        if launches != (cfg.n_layers * delta["decode_steps"], 0):
            raise AssertionError(
                f"{name}: (K1, K2) launches {launches} != "
                f"({cfg.n_layers} layers x {delta['decode_steps']} "
                f"decode-lane steps, 0)")
        if max(depths, default=0) > 2:
            raise AssertionError(f"{name}: fetchq_depth reached "
                                 f"{max(depths)} (at most 2)")
        n_out = sum(map(len, outs))
        tpots = [(s[-1] - s[0]) / (len(s) - 1) for s in stamps
                 if len(s) > 1]
        arm = {"output_tok_s": n_out / wall, "output_tokens": n_out,
               "wall_s": wall, "ttft_p50_s": p50(list(eng.ttfts_s)),
               "tpot_p50_s": p50(tpots), "ended_at_eos": early,
               "decode_lane_steps": delta["decode_steps"],
               "decode_lane_dispatches": delta["chunks"],
               "verify_dispatches": delta["spec_rounds"],
               "k1_launches": launches[0],
               "fetchq_depth_max": max(depths, default=0)}
        if kw["spec_len"]:
            # spec_stats() over this wave only (the warm-up excluded)
            spec = {"rounds": delta["spec_rounds"],
                    "proposed_tokens": delta["spec_proposed"],
                    "accepted_tokens": delta["spec_accepted"],
                    "accept_rate": delta["spec_accepted"]
                    / max(1, delta["spec_proposed"]),
                    "tokens_per_dispatch": delta["spec_tokens"]
                    / max(1, delta["spec_riders"])}
            if spec["rounds"] <= 0 or spec["accepted_tokens"] <= 0:
                raise AssertionError(f"{name}: speculation did not engage:"
                                     f" {spec}")
            arm["spec_stats"] = spec
            spec_dep, spec_outs = dep, outs
        else:
            dep.shutdown()
        res["arms"][name] = arm
        print(f"phase 4d: {name}: {len(prompts)} requests, eos {eos}, on "
              f"{smi}: output {arm['output_tok_s']:.1f} tok/s ({n_out} "
              f"tokens, {early} ended at the eos), TTFT p50 "
              f"{arm['ttft_p50_s'] * 1e3:.1f} ms, time per output token "
              f"p50 {arm['tpot_p50_s'] * 1e3:.2f} ms; {delta['chunks']} "
              f"decode-lane dispatches ({delta['decode_steps']} steps, K1 "
              f"{launches[0]} = {cfg.n_layers} x {delta['decode_steps']}),"
              f" {delta['spec_rounds']} verify dispatches; fetchq_depth "
              f"max {arm['fetchq_depth_max']}"
              + (f"; accept_rate {spec['accept_rate']:.4f}, "
                 f"tokens_per_dispatch {spec['tokens_per_dispatch']:.4f}"
                 if kw["spec_len"] else ""))

    # teacher-forced, through the gather path: every token of the 2
    # longest speculative streams of repetitive prompts, in bf16 and
    # with the same bf16 weights evaluated in fp32
    checked = sorted(range(8), key=lambda i: -len(spec_outs[i]))[:2]
    ref32 = tl.build_model(dataclasses.replace(cfg, dtype=torch.float32),
                           {k: v.float() for k, v in params.items()},
                           "cuda")
    gaps = {kind: [x for i in checked
                   for x in _teacher_forced_gaps(m, prompts[i],
                                                 spec_outs[i])]
            for kind, m in (("bf16", spec_dep.model), ("fp32", ref32))}
    for kind, gs in gaps.items():
        if max(gs) > LOGIT_SLACK:
            raise AssertionError(
                f"phase 4d teacher-forced: a speculative token sits "
                f"{max(gs)} below the top {kind} logit (allowed "
                f"{LOGIT_SLACK})")
    res["teacher_forced_max_gap"] = {k: max(v) for k, v in gaps.items()}
    res["teacher_forced_positions"] = len(gaps["bf16"])
    print(f"phase 4d: teacher-forced over {len(gaps['bf16'])} tokens of 2 "
          f"speculative requests: max gap to the top logit "
          f"{max(gaps['bf16']):.4f} in bf16, {max(gaps['fp32']):.4f} in "
          f"fp32")

    spec_dep.shutdown()
    # logprob capture: 4 requests (2 repetitive, 2 random), the eos on
    lp_eng = LLMEngine(spec_dep.model, max_slots=16, page_size=Pg,
                       n_pages=16 * 32 + 1, chunk=8, eos_id=eos,
                       capture_logprobs=True, device="cuda")
    picked = [prompts[0], prompts[1], prompts[8], prompts[9]]
    hs = [lp_eng.submit(p, max_new_tokens=n_new) for p in picked]
    while lp_eng.step():
        pass
    errs = {"bf16": [], "fp32": []}
    for p, h in zip(picked, hs):
        toks, lps = h.result(), h.logprobs
        if len(lps) != len(toks):
            raise AssertionError(f"{len(lps)} logprobs for {len(toks)} "
                                 f"tokens")
        for kind, m in (("bf16", spec_dep.model), ("fp32", ref32)):
            want = torch.log_softmax(
                _teacher_forced_logits(m, p, toks).float(), dim=-1)[
                torch.arange(len(toks)), torch.tensor(toks)].tolist()
            errs[kind] += [abs(a - b) for a, b in zip(lps, want)]
    del ref32
    res["logprob_max_abs_err"] = {k: max(v) for k, v in errs.items()}
    res["logprob_tokens"] = len(errs["bf16"])
    if max(errs["bf16"]) > LOGIT_SLACK:
        raise AssertionError(
            f"captured logprobs {max(errs['bf16'])} from the "
            f"teacher-forced fp32 log_softmax (allowed {LOGIT_SLACK})")
    print(f"phase 4d: logprob capture at full width, 4 requests, "
          f"{len(errs['bf16'])} tokens: captured vs teacher-forced fp32 "
          f"log_softmax of the bf16 model max error "
          f"{max(errs['bf16']):.4f} (allowed {LOGIT_SLACK}); of the same "
          f"weights in fp32 {max(errs['fp32']):.4f}")
    return res


def phase_verify_device_time(tl, seed: int, smi: str) -> dict:
    """Device time (torch.profiler, kernels and copies summed) of one
    speculative verify dispatch (the engine's ``_verify_step``: 16 rows
    x 5 tokens through the gather path, argmax read back) against one
    decode step (``_decode_step``), on phase 4d's model and pool shape
    at the wave's positions + 32. Runs last: no profiler session comes
    before a timed phase."""
    from ray_tpu_torch.serve.engine import LLMEngine
    cfg = tl.tinyllama_1_1b()
    model = tl.build_model(cfg, tl.init_params(cfg, seed=seed,
                                               device="cuda"), "cuda")
    eng = LLMEngine(model, max_slots=16, page_size=64, n_pages=16 * 32 + 1,
                    spec_len=4, device="cuda")
    S, T = 16, eng.spec_len + 1
    pt = np.arange(1, S * 32 + 1, dtype=np.int32).reshape(S, 32)
    start = np.asarray([min(len(p) + 32, cfg.max_seq_len - T)
                        for p in _default_loop_wave(tl, seed,
                                                    cfg.vocab_size)],
                       np.int32)
    rows = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (S, T)).astype(np.int32)

    def verify():
        eng._verify_step(rows, start, pt)

    def decode_step():
        eng._dev_pos.copy_(torch.from_numpy(start).cuda())
        eng._decode_step(pt, 1, list(range(S)))

    res = {}
    for key, fn in (("verify_dispatch", verify),
                    ("decode_step", decode_step)):
        events = _device_events(fn)
        res[f"{key}_device_ms"] = sum(
            e.time_range.end - e.time_range.start for e in events) / 1e3
        res[f"{key}_device_events"] = len(events)
    print(f"phase 4d: device time of one verify dispatch (16 rows x {T} "
          f"tokens) {res['verify_dispatch_device_ms']:.3f} ms "
          f"({res['verify_dispatch_device_events']} device events) "
          f"against one decode step {res['decode_step_device_ms']:.3f} ms "
          f"({res['decode_step_device_events']}), on {smi}")
    return res


# --------------------------------------------------------------------
# Training: flash attention (K3, K4, K5) and the GPT-2 train step
# --------------------------------------------------------------------

def _timed(obj, name: str, log: list) -> None:
    """Shadow method ``name`` of ``obj`` with a wrapper that appends each
    call's host seconds to ``log`` (``del obj.<name>`` restores it)."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            log.append(time.perf_counter() - t)

    setattr(obj, name, wrapped)


def _pinned_pages(eng, hashes) -> list:
    """``eng``'s bytes of the pages over ``hashes``, pinned around the
    export."""
    pages = eng.kv_pin_prefix(hashes)
    try:
        return eng.kv_export_pages(pages)
    finally:
        eng.kv_release_pages(pages)


def _pull_run(make, donor, hashes, prompt, n_new, call=None,
              background=(), followers=()):
    """A fresh requester from ``make``, warmed by one 100-token request,
    serves ``prompt`` with a pull hint over ``hashes`` while the
    ``background`` prompts (no hint) run beside it; the ``followers``
    (each with the same hint) are submitted once the pulled request's
    first token is out. ``call`` is the pull's call seam (default: the
    JSON + base64 loopback over ``donor``). Returns the requester, the
    streams (pulled, background, followers), the host seconds of the
    fetch, export and landing, the payload and the K1/K2 launches and
    decode steps of the served traffic."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.serve import kv_migration as km
    req = make().start()
    if len(req.submit(list(range(1, 101)), 8).result()) != 8:
        raise AssertionError("warm-up request came back short")
    req.reset_latency_stats()
    call = call or km.loopback_call(donor)
    got = {"export": [], "land": []}
    _timed(donor._engine, "kv_export_pages", got["export"])
    _timed(req, "_land_pulled_pages_locked", got["land"])

    def fetcher(pull):
        t = time.perf_counter()
        payload = km.pull_prefix(call, pull["hashes"],
                                 stats=req.kv_migration_stats)
        got["fetch_s"], got["payload"] = time.perf_counter() - t, payload
        return payload

    req.kv_fetcher = fetcher
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    steps0 = req.stats["decode_steps"]
    h = req.submit(prompt, n_new, pull={"hashes": hashes})
    bg = [req.submit(p, n_new) for p in background]
    it = h.stream()
    first = next(it)
    hits0 = req.stats["cache_hit_tokens"]
    fol = [req.submit(p, n_new, pull={"hashes": hashes})
           for p in followers]
    streams = ([first] + list(it), [b.result() for b in bg],
               [f.result() for f in fol])
    if not req.wait_idle(timeout_s=60):
        raise AssertionError("requester not idle after the pull")
    del donor._engine.kv_export_pages, req._land_pulled_pages_locked
    got.update(
        req=req, streams=streams, ttft_s=h.ttft_s,
        bg_ttft_s=[b.ttft_s for b in bg],
        follower_hit_tokens=req.stats["cache_hit_tokens"] - hits0,
        launches=(pa.paged_decode_attention.launches,
                  pa.paged_decode_attention.launches_int8),
        decode_steps=req.stats["decode_steps"] - steps0)
    return got


def _export_ab(eng, hashes) -> list:
    """Host ms of exporting ``hashes``' pages of ``eng`` (idle) one
    synchronous copy per page column (``export_page_bytes``) and in one
    batched copy (the engine's ``export_pages_bytes``), in the order
    per-page, batched, batched, per-page; the bytes must agree."""
    from ray_tpu_torch.models.kv_cache import (export_page_bytes,
                                               export_pages_bytes)
    pages = eng.kv_pin_prefix(hashes)
    try:
        out, got = [], []
        for batched in (False, True, True, False):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got.append(export_pages_bytes(eng.pages, pages) if batched
                       else [export_page_bytes(eng.pages, p)
                             for p in pages])
            out.append((time.perf_counter() - t) * 1e3)
        if any(g != got[0] for g in got):
            raise AssertionError("batched and per-page exports differ")
        return out
    finally:
        eng.kv_release_pages(pages)


def _cold_run(make, prompt, n_new, background=()):
    """The same prompt with no hint on a fresh, warmed requester, beside
    the same background: its stream and TTFT, and the background's."""
    eng = make().start()
    eng.submit(list(range(1, 101)), 8).result()
    eng.reset_latency_stats()
    h = eng.submit(prompt, n_new)
    bg = [eng.submit(p, n_new) for p in background]
    for b in bg:
        b.result()
    out = (h.result(), h.ttft_s, [b.ttft_s for b in bg])
    eng.shutdown()
    return out


def _wire_pieces_ms(payload) -> tuple:
    """The pull's encode and decode, timed again on its own bytes as one
    chunk: base64 plus the response envelope's JSON encode (the donor's
    side) and the JSON decode plus base64 (the requester's)."""
    import base64
    from ray_tpu_torch.serve.fleet import wire
    t0 = time.perf_counter()
    body = wire.encode(wire.ok({"chunk_idx": 0, "pages": [
        [[base64.b64encode(b).decode("ascii") for b in layer]
         for layer in page] for page in payload["pages"]]}))
    t1 = time.perf_counter()
    rsp = wire.decode(body)
    _ = [[[base64.b64decode(c) for c in layer] for layer in page]
         for page in rsp["result"]["pages"]]
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _swap_fp32_reduced(tl, seed: int) -> dict:
    """Phase 4e's fp32 checks at phase 3's reduced width (TF32 off): a
    pull on the card, fp and int8 pools, against a cold recompute on
    the card and the CPU engine; a preempt swap of the same tensors
    against an unswapped run; a drain swap to other weights."""
    from ray_tpu_torch.serve import kv_migration as km
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tl.LlamaConfig(vocab_size=32000, max_seq_len=256, dim=512,
                         n_layers=2, n_heads=8, n_kv_heads=2,
                         hidden_dim=1024, dtype=torch.float32)
    sd = tl.init_params(cfg, seed=seed, device="cpu")
    models = {d: tl.build_model(cfg, sd, d) for d in ("cpu", "cuda")}
    g = np.random.default_rng(seed + 5)
    prefix = g.integers(0, cfg.vocab_size, 64).tolist()     # 4 pages
    prompts = [prefix + g.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17)]
    hashes = path_hashes(prefix, 16)

    def make(device, model=None, **kw):
        return LLMEngine(model or models[device], max_slots=4,
                         page_size=16, n_pages=64, chunk=4, device=device,
                         **kw)

    def serve(eng, ps, n=16, **kw):
        hs = [eng.submit(p, max_new_tokens=n, **kw) for p in ps]
        while eng.step():
            pass
        return [h.result() for h in hs]

    res = {}
    for kv_dtype in ("fp", "int8"):
        donor_eng = make("cuda", kv_dtype=kv_dtype, prefix_cache=True)
        serve(donor_eng, [prefix + [7, 7]])
        donor = km.KVDonor(donor_eng)
        req = make("cuda", kv_dtype=kv_dtype, prefix_cache=True)
        req.kv_fetcher = lambda pull, req=req, donor=donor: km.pull_prefix(
            km.loopback_call(donor), pull["hashes"],
            stats=req.kv_migration_stats)
        pulled = serve(req, prompts[:1], pull={"hashes": hashes})
        pulled += serve(req, prompts[1:])
        cold = {d: make(d, kv_dtype=kv_dtype) for d in ("cuda", "cpu")}
        card, cpu = ([serve(e, [p])[0] for p in prompts]
                     for e in cold.values())
        if _pinned_pages(req, hashes) != _pinned_pages(donor_eng, hashes):
            raise AssertionError(f"{kv_dtype}: landed bytes differ from "
                                 f"the donor's")
        if (req.kv_migration_stats["pulled_pages"], req.stats[
                "cache_hit_tokens"]) != (4, 2 * 64):
            raise AssertionError(f"{kv_dtype}: pull stats "
                                 f"{req.kv_migration_stats} {req.stats}")
        # fp: identical; int8: identical or parting at a near-tie, as
        # phase 3 holds an int8 pool (one int8 step here and there)
        partings = {}
        for name, ref in (("card", card), ("cpu", cpu)):
            if kv_dtype == "fp" and pulled != ref:
                raise AssertionError(f"fp: pulled streams differ from a "
                                     f"cold recompute on the {name}")
            gaps = _int8_parting_gaps(models["cpu"], prompts, ref, pulled)
            if max(gaps, default=0.0) > INT8_LOGIT_SLACK:
                raise AssertionError(f"int8: pulled streams part from the "
                                     f"{name}'s beyond a near-tie ({gaps})")
            partings[name] = len(gaps)
        res[f"pull_{kv_dtype}"] = {"near_tie_partings": partings}
    # preempt swap of the same tensors (staged from the host) mid-wave
    wave = prompts + [g.integers(0, cfg.vocab_size, 30).tolist()]
    want = serve(make("cuda"), wave)
    eng = make("cuda", prefix_cache=True)
    hs = [eng.submit(p, max_new_tokens=16) for p in wave]
    eng.step()
    if not any(s is not None for s in eng.slots):
        raise AssertionError("no slot occupied at the swap")
    eng.swap_weights(sd, weights_id="same-v2")
    while eng.step():
        pass
    if [h.result() for h in hs] != want:
        raise AssertionError("fp32 preempt swap of the same tensors "
                             "changed the streams")
    # drain swap to other weights: the request in flight finishes on the
    # old ones; one submitted while the swap is pending runs on the new
    sd2 = tl.init_params(cfg, seed=seed + 1, device="cpu")
    eng = make("cuda")
    h = eng.submit(wave[0], max_new_tokens=16)
    eng.step()
    eng.swap_weights(sd2, weights_id="other", mode="drain", wait=False)
    h2 = eng.submit(wave[1], max_new_tokens=16)
    while eng.step():
        pass
    fresh = serve(make("cuda", model=tl.build_model(cfg, sd2, "cuda")),
                  [wave[1]])[0]
    if (h.result(), h2.result()) != (want[0], fresh):
        raise AssertionError("fp32 drain swap: the in-flight request left "
                             "the old weights or the next one missed the "
                             "new ones")
    if eng.load_report()["weight_generation"] != 1:
        raise AssertionError("drain swap did not advance the fence")
    res["swap_preempt_identical"] = res["swap_drain_identical"] = True
    return res


def phase_kv_pull_swap(tl, pa, seed: int, smi: str, cfg=None) -> dict:
    """Phase 4e: cross-replica KV pull between two TinyLlama-1.1B
    engines on the card (fp and int8 pools; ``cfg`` for another depth),
    then the hot weight swap on the requester, then the fp32 checks at
    a reduced width."""
    from ray_tpu_torch.serve import kv_migration as km
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.fleet import transport as fleet_transport
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    cfg = cfg or tl.tinyllama_1_1b()
    n_new, Pg = 64, 64
    params = tl.init_params(cfg, seed=seed, device="cuda")
    model = tl.build_model(cfg, params, "cuda")
    del params
    warm, system, _aligned, wave1, _wave2 = _chat_traffic(cfg.vocab_size,
                                                          seed)
    g = np.random.default_rng(seed + 6)
    prompts = [system + g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in g.integers(16, 513, 8)]
    background = [g.integers(0, cfg.vocab_size, n).tolist()
                  for n in (300, 600, 900, 1200)]
    hashes = path_hashes(system, Pg)
    res = {"card": smi}
    for kv_dtype in ("fp", "int8"):
        def make(kv_dtype=kv_dtype):
            return LLMEngine(model, max_slots=16, page_size=Pg,
                             n_pages=513, chunk=8, prefix_cache=True,
                             kv_dtype=kv_dtype, device="cuda")

        donor_eng = make().start()
        donor_eng.submit(warm, n_new).result()
        for h in [donor_eng.submit(p, n_new) for p in wave1]:
            if len(h.result()) != n_new:
                raise AssertionError("donor request came back short")
        donor = km.KVDonor(donor_eng)
        donor_bytes = _pinned_pages(donor_eng, hashes)
        if len(donor_bytes) != len(hashes):
            raise AssertionError(f"donor holds {len(donor_bytes)} of the "
                                 f"system prompt's {len(hashes)} pages")
        # the clean pull, with background traffic and 7 followers
        run = _pull_run(make, donor, hashes, prompts[0], n_new,
                        background=background, followers=prompts[1:])
        req = run["req"]
        pulled, bg_out, fol_out = run["streams"]
        st = dict(req.kv_migration_stats)
        launches = run["launches"]
        k = 0 if kv_dtype == "fp" else 1
        want_launches = [0, 0]
        want_launches[k] = cfg.n_layers * run["decode_steps"]
        checks = {
            "16 pages landed": st["pulled_pages"] == 16
            and req.stats["kv_pull_landed"] == 1,
            "landed bytes == donor's": _pinned_pages(req, hashes)
            == donor_bytes,
            "no abort, fallback or second pull": (st["pulls"], st[
                "aborts"], st["fallbacks"]) == (1, 0, 0),
            "followers hit locally": run["follower_hit_tokens"]
            >= 7 * 1024,
            "every stream complete": all(len(o) == n_new for o in
                                         [pulled] + bg_out + fol_out),
            f"K{k + 1} once per layer per decode step": run[
                "decode_steps"] > 0 and list(launches) == want_launches,
        }
        bad = [c for c, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"phase 4e {kv_dtype}: failed {bad}; "
                                 f"stats {st}, launches {launches}, "
                                 f"steps {run['decode_steps']}")
        # the pulled request's tokens, teacher-forced: the bf16 model
        # over a fresh pool of this dtype, and the bf16 weights in fp32
        # over an fp pool (int8: + one int8 step, as phase 4b)
        gaps16 = _teacher_forced_gaps(model, prompts[0], pulled, kv_dtype)
        ref32 = tl.build_model(
            dataclasses.replace(cfg, dtype=torch.float32),
            {n: v.float() for n, v in model.state_dict().items()}, "cuda")
        gaps32 = _teacher_forced_gaps(ref32, prompts[0], pulled)
        del ref32
        lim32 = LOGIT_SLACK if kv_dtype == "fp" else INT8_LOGIT_SLACK
        if max(gaps16) > LOGIT_SLACK or max(gaps32) > lim32:
            raise AssertionError(f"phase 4e {kv_dtype} teacher-forced: max "
                                 f"gaps {max(gaps16)} bf16, {max(gaps32)} "
                                 f"fp32")
        cold, cold_ttft, cold_bg_ttft = _cold_run(make, prompts[0], n_new,
                                                  background)
        _, cold_alone_ttft, _ = _cold_run(make, prompts[0], 16)
        enc_ms, dec_ms = _wire_pieces_ms(run["payload"])
        fetch_ms = run["fetch_s"] * 1e3
        export_ms = sum(run["export"]) * 1e3
        arm = {
            "pull_ms": fetch_ms + sum(run["land"]) * 1e3,
            "fetch_ms": fetch_ms, "export_ms": export_ms,
            "encode_ms": enc_ms, "decode_ms": dec_ms,
            "wire_rest_ms": fetch_ms - export_ms - enc_ms - dec_ms,
            "landing_ms": sum(run["land"]) * 1e3,
            "wire_bytes": st["wire_bytes"],
            "wire_MB_s": st["wire_bytes"] / run["fetch_s"] / 1e6,
            "page_bytes": req.page_bytes,
            "ttft_pulled_ms": run["ttft_s"] * 1e3,
            "ttft_cold_ms": cold_ttft * 1e3,
            "ttft_cold_alone_ms": cold_alone_ttft * 1e3,
            "bg_ttft_ms_during_pull": [t * 1e3 for t in run["bg_ttft_s"]],
            "bg_ttft_ms_during_cold": [t * 1e3 for t in cold_bg_ttft],
            "follower_hit_tokens": run["follower_hit_tokens"],
            "decode_steps": run["decode_steps"],
            "k1_launches": launches[0], "k2_launches": launches[1],
            "teacher_forced_max_gap_bf16": max(gaps16),
            "teacher_forced_max_gap_fp32": max(gaps32),
            "pulled_equals_cold": pulled == cold, "stats": st}
        print(f"phase 4e: {kv_dtype} pool, TinyLlama-1.1B bf16, 16-page "
              f"(1024-token) prefix pulled over the loopback wire on {smi}:"
              f" pull {arm['pull_ms']:.1f} ms = export {export_ms:.1f} + "
              f"encode {enc_ms:.1f} + decode {dec_ms:.1f} + rest of the "
              f"wire {arm['wire_rest_ms']:.1f} + landing "
              f"{arm['landing_ms']:.1f}; {st['wire_bytes']} wire bytes, "
              f"{arm['wire_MB_s']:.1f} MB/s; TTFT pulled "
              f"{arm['ttft_pulled_ms']:.1f} ms vs cold "
              f"{arm['ttft_cold_ms']:.1f} ms (4 background requests "
              f"each); background TTFT during the pull "
              f"{[round(t, 1) for t in arm['bg_ttft_ms_during_pull']]} "
              f"ms, during the cold prefill "
              f"{[round(t, 1) for t in arm['bg_ttft_ms_during_cold']]} "
              f"ms; 7 followers hit {run['follower_hit_tokens']} tokens; "
              f"K{k + 1} {launches[k]} = {cfg.n_layers} x "
              f"{run['decode_steps']} steps; teacher-forced max gap "
              f"{max(gaps16):.4f} bf16, {max(gaps32):.4f} fp32")
        if kv_dtype == "fp":
            arm["swap"] = _swap_bf16(tl, make, req, model, cfg, g)
        req.shutdown()
        # the pulled request alone on fresh requesters: with the default
        # chunks, in 4 chunks, then one page a chunk through a faulty
        # transport under 4 seeds (18+ calls each: a dropped begin falls
        # back, dropped and duplicated chunks must land the same bytes)
        arms = [("alone", {}, None),
                ("4_chunks", {"max_chunk_bytes": 4 * donor_eng.page_bytes},
                 None)] + [
            (f"faulty_seed{seed + k}", {
                "max_chunk_bytes": donor_eng.page_bytes,
                "time_fn": lambda: 0.0}, seed + k) for k in range(4)]
        faults = collections.Counter()
        for name, kw, fault_seed in arms:
            arm_donor = km.KVDonor(donor_eng, **kw)
            calls = collections.Counter()
            lb = fleet_transport.LoopbackTransport(
                lambda m, a, _t, d=arm_donor: d.handle(m, a))
            inner = (lb if fault_seed is None else
                     fleet_transport.FaultyTransport(
                         lb, seed=fault_seed, drop_p=0.15, dup_p=0.3))

            def call(m, a, inner=inner, calls=calls):
                calls[m] += 1
                return inner.call(m, a)

            r = _pull_run(make, arm_donor, hashes, prompts[0], 16,
                          call=call)
            rst = r["req"].kv_migration_stats
            landed = rst["pulled_pages"] == 16 and _pinned_pages(
                r["req"], hashes) == donor_bytes
            fell_back = (rst["fallbacks"] == 1
                         and r["req"].stats["kv_pull_fallbacks"] == 1)
            want_chunks = {"alone": -(-16 // (
                (fleet_transport.max_frame_bytes() // 2)
                // donor_eng.page_bytes)), "4_chunks": 4}.get(name)
            if want_chunks and not (landed and calls["kv_pull_chunk"]
                                    == want_chunks and rst["fallbacks"] == 0):
                raise AssertionError(f"{name} pull: {dict(calls)} {rst}")
            if fault_seed is not None and landed == fell_back:
                raise AssertionError(f"{name} pull neither landed the "
                                     f"donor's bytes nor fell back: {rst}")
            if len(r["streams"][0]) != 16:
                raise AssertionError(f"{name} pull: the stream came back "
                                     f"short")
            if fault_seed is not None:
                faults.update(inner.stats)
                # a duplicated begin leaves a transfer the requester never
                # ends: the pin deadline's GC reclaims it
                arm_donor._time = lambda: float("inf")
            if arm_donor.open_transfers():
                raise AssertionError(f"{name}: transfers left open")
            arm[f"pull_{name}"] = {
                "calls": dict(calls), "landed": landed,
                "fell_back": fell_back, "fetch_ms": r["fetch_s"] * 1e3,
                "export_ms": sum(r["export"]) * 1e3,
                "landing_ms": sum(r["land"]) * 1e3,
                "ttft_ms": r["ttft_s"] * 1e3, "stats": dict(rst),
                **({"faults": dict(inner.stats)} if fault_seed is not None
                   else {})}
            r["req"].shutdown()
            print(f"phase 4e: {kv_dtype} pull {name}: calls {dict(calls)}"
                  f", {'landed the donor bytes' if landed else 'fell back'}"
                  f", fetch {r['fetch_s'] * 1e3:.1f} ms (export "
                  f"{sum(r['export']) * 1e3:.1f}), landing "
                  f"{sum(r['land']) * 1e3:.1f} ms, TTFT "
                  f"{r['ttft_s'] * 1e3:.1f} ms (cold alone "
                  f"{cold_alone_ttft * 1e3:.1f} ms)" + (
                      f"; faults {dict(inner.stats)}"
                      if fault_seed is not None else ""))
        if not (faults["dropped"] and faults["duplicated"]):
            raise AssertionError(f"the faulty pulls saw no drop or no "
                                 f"duplicate: {dict(faults)}")
        arm["export_ab_ms"] = _export_ab(donor_eng, hashes)
        print(f"phase 4e: {kv_dtype} export of the 16 pages on an idle "
              f"card, per page column vs batched (p/b/b/p, ms): "
              f"{[round(t, 2) for t in arm['export_ab_ms']]}")
        if donor.open_transfers() or donor_eng.prefix_cache.evictable_pages() \
                != donor_eng.prefix_cache.cached_pages or \
                donor_eng.alloc.occupancy() != \
                donor_eng.prefix_cache.cached_pages:
            raise AssertionError("the donor kept a transfer or a pin")
        donor_eng.shutdown()
        res[kv_dtype] = arm
        torch.cuda.empty_cache()
    res["fp32_reduced"] = _swap_fp32_reduced(tl, seed)
    print("phase 4e: fp32 at phase 3's width: pulled streams == a cold "
          "recompute on the card and on the CPU (fp pool; int8 pool near-"
          "tie partings (card, CPU): "
          f"{res['fp32_reduced']['pull_int8']['near_tie_partings']}); a "
          "preempt swap of the same tensors leaves the streams as they "
          "were; after a drain swap the request in flight ends on the old "
          "weights and the next runs on the new")
    return res


def _swap_bf16(tl, make, req, model, cfg, g) -> dict:
    """A preempt-mode swap on phase 4e's fp requester, in the middle of
    4 streams, to the same tensors staged from the host under a new
    ``weights_id``: staging and flip timed, peak device memory read.
    The same 4 streams run unswapped on a fresh requester from
    ``make``; every stream of both runs is teacher-forced, and where
    each swapped stream first parts from its unswapped twin is
    recorded."""
    n_swap = 512                      # long enough to straddle the flip
    prompts = [g.integers(0, cfg.vocab_size, n).tolist()
               for n in (200, 400, 800, 1000)]
    host_sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    plain_eng = make().start()
    plain = [h.result() for h in [plain_eng.submit(p, n_swap)
                                  for p in prompts]]
    plain_eng.shutdown()
    stage, flip = [], []
    _timed(req, "_stage_weights", stage)
    _timed(req, "_apply_swap_locked", flip)
    hs = [req.submit(p, n_swap) for p in prompts]
    its = [h.stream() for h in hs]
    heads = [[next(it)] for it in its]          # every stream is live
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = req.swap_weights(host_sd, weights_id="same-bytes-v2")
    peak = torch.cuda.max_memory_allocated()
    outs = [head + list(it) for head, it in zip(heads, its)]
    del req._stage_weights, req._apply_swap_locked
    ev = [e[5] for e in req.events.snapshot() if e[2] == "weight_swap"]
    rpt = req.load_report()
    gaps = [max(_teacher_forced_gaps(req.model, p, o))
            for p, o in zip(prompts, outs)]
    gaps_plain = [max(_teacher_forced_gaps(model, p, o))
                  for p, o in zip(prompts, plain)]
    parted = [next((i for i, (a, b) in enumerate(zip(o, q)) if a != b),
                   None) for o, q in zip(outs, plain)]
    if (gen, rpt["weight_generation"], rpt["weights_id"]) != (
            1, 1, "same-bytes-v2") or any(len(o) != n_swap for o in outs) \
            or ev[-1]["prefix_pages_evicted"] < 16 or ev[-1]["preempted"] \
            < 1 or max(gaps) > LOGIT_SLACK:
        raise AssertionError(f"phase 4e swap: gen {gen}, report "
                             f"{rpt['weight_generation']}, event {ev}, "
                             f"lengths {[len(o) for o in outs]}, max gaps "
                             f"{gaps} swapped, {gaps_plain} unswapped, "
                             f"parted at {parted}")
    res = {"staging_ms": stage[0] * 1e3, "flip_pause_ms": flip[0] * 1e3,
           "device_memory_before_gb": mem0 / 1e9,
           "peak_device_memory_gb": peak / 1e9, "event": ev[-1],
           "new_tokens": n_swap,
           "teacher_forced_max_gap_bf16": max(gaps),
           "teacher_forced_max_gaps_swapped": gaps,
           "teacher_forced_max_gaps_unswapped": gaps_plain,
           "parted_from_unswapped_at": parted}
    print(f"phase 4e: preempt swap of TinyLlama-1.1B's weights (the same "
          f"tensors from the host, new weights_id) mid 4 streams of "
          f"{n_swap} tokens: staging {res['staging_ms']:.1f} ms, flip pause "
          f"{res['flip_pause_ms']:.2f} ms (engine lock held), device "
          f"memory {mem0 / 1e9:.2f} GB before, peak {peak / 1e9:.2f} GB; "
          f"preempted {ev[-1]['preempted']}, evicted "
          f"{ev[-1]['prefix_pages_evicted']} pages; streams complete, "
          f"teacher-forced max gap per stream "
          f"{[round(x, 4) for x in gaps]} swapped, "
          f"{[round(x, 4) for x in gaps_plain]} unswapped (a fresh "
          f"requester); swapped streams part from the unswapped at "
          f"{parted}")
    return res


def _gaps(model, prompt, completion, kv_dtype: str, device: str) -> list:
    """``_teacher_forced_gaps`` on ``device``."""
    rows = _teacher_forced_logits(model, prompt, completion, kv_dtype,
                                  device)
    tok = torch.tensor(completion, device=device)
    return (rows.max(dim=-1).values
            - rows[torch.arange(len(completion)), tok]).tolist()


def _fp32_copy(tl, model, device):
    """The same (bf16) weights evaluated in fp32."""
    return tl.build_model(
        dataclasses.replace(model.cfg, dtype=torch.float32),
        {k: v.float() for k, v in model.state_dict().items()}, device)


def _timed_rounds(eng, before=None) -> list:
    """Record ``(round, t_start, t_end, seated rids)`` after every
    ``step()`` of ``eng``'s scheduler thread, and call ``before()`` on
    that thread ahead of each (a client acting at a round boundary: a
    thread of its own would race the scheduler for the engine lock,
    which Python does not hand over in order). ``del eng.step``
    restores it."""
    rounds = []
    step = eng.step

    def timed():
        if before is not None:
            before()
        t0 = time.monotonic()
        busy = step()
        rounds.append((eng._round, t0, time.monotonic(),
                       {s.req.rid for s in eng.slots if s is not None}))
        return busy

    eng.step = timed
    return rounds


def _wait_done(hs, timeout_s: float) -> None:
    """Wait until every handle is done."""
    deadline = time.monotonic() + timeout_s
    while not all(h.done for h in hs):
        if time.monotonic() > deadline:
            raise AssertionError("a request did not finish in time")
        time.sleep(0.005)


def _containment_wave(tl, pa, model, prompts, device: str) -> dict:
    """Phase 4f (a): the 16 prompts twice through one engine on the fp
    pool under the default overlapped loop, unfaulted and then under
    faults on three slots, allocator exhaustion, a deadline blown by a
    slow step and a cancel; then a replica kill."""
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.errors import EngineShutdown
    from ray_tpu_torch.serve.faults import FaultInjector, check_quiesced
    n_new = 64
    inj = FaultInjector()
    eng = LLMEngine(model, max_slots=16, page_size=64, n_pages=513, chunk=8,
                    fault_injector=inj, device=device).start()
    eng.submit(prompts[0][:100], n_new).result()        # warm-up
    eng.reset_latency_stats()
    # slot k serves order[k]: the deadline (slot 0) and the cancel (slot
    # 1) take the two shortest prompts, prefilled before the others
    by_len = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    order = by_len[:2] + [i for i in range(len(prompts))
                          if i not in by_len[:2]]
    state = {"hs": [], "slow": None, "cancel": True}

    def before():
        # once slot 0 streams, the next round sleeps past its 1 s
        # deadline; once slot 1 streams, its client cancels
        hs = state["hs"]
        if state["slow"] is not None and hs[0]._req.generated:
            state["slow"].round = 0
            state["slow"] = None
        if not state["cancel"] and hs[1]._req.generated:
            hs[1].cancel()
            state["cancel"] = True

    rounds = _timed_rounds(eng, before)
    waves = {}
    for faulted in (False, True):
        r0 = eng._round
        if faulted:
            inj.inject("dispatch_prefill", sid=8,
                       exc=ValueError("prefill fault"))
            inj.inject("dispatch_decode", sid=5,
                       exc=RuntimeError("decode fault"))
            inj.inject("readback", sid=11, exc=OSError("readback fault"))
            inj.exhaust_alloc(round=r0 + 3, times=2)
            # dormant until ``before`` wakes it
            slow = inj.slow("step", 1.2, round=1 << 40)
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention.launches_int8 = 0
        steps0 = eng.stats["decode_steps"]
        t0 = time.monotonic()
        hs = []
        state.update(hs=hs, slow=slow if faulted else None,
                     cancel=not faulted)
        for k, i in enumerate(order):
            hs.append(eng.submit(prompts[i], n_new, deadline_s=(
                1.0 if faulted and k == 0 else None)))
        _wait_done(hs, 600)
        wall = time.monotonic() - t0
        if not eng.wait_idle(60):
            raise AssertionError("phase 4f (a): the engine did not settle")
        launches = (pa.paged_decode_attention.launches,
                    pa.paged_decode_attention.launches_int8)
        steps = eng.stats["decode_steps"] - steps0
        check_quiesced(eng)
        waves[faulted] = {
            "hs": hs, "wall": wall, "launches": launches, "steps": steps,
            "rounds": [r for r in rounds if r[0] > r0],
            "tokens": sum(len(h._req.generated) for h in hs)}
    del eng.step
    life = eng.lifecycle_stats()
    clean, bad = waves[False], waves[True]
    outs = [_outcome(h) for h in bad["hs"]]
    failed = {k: o[1] for k, o in enumerate(outs) if o[0] == "err"}
    survivors = [k for k, o in enumerate(outs) if o[0] == "ok"]
    want_types = {"DeadlineExceeded", "RequestCancelled", "RuntimeError",
                  "ValueError", "OSError"}
    n_layers = model.cfg.n_layers
    checks = {
        "unfaulted wave complete": all(
            o[0] == "ok" and len(o[1]) == n_new
            for o in map(_outcome, clean["hs"])),
        "5 requests failed, one of each type":
            sorted(failed.values()) == sorted(want_types),
        "the deadline blew mid-decode": failed.get(0) == "DeadlineExceeded"
            and 0 < len(bad["hs"][0]._req.generated) < n_new,
        "the cancel landed mid-decode": failed.get(1) == "RequestCancelled"
            and 0 < len(bad["hs"][1]._req.generated) < n_new,
        "11 survivors with 64 tokens": len(survivors) == 11 and all(
            len(outs[k][1]) == n_new for k in survivors),
        "retries >= 1": life["retries"] >= 1,
        "3 faults contained": life["contained_faults"] == 3,
        "the allocator ran dry twice": sum(
            1 for e in inj.log if e[0] == "alloc") == 2,
    }
    if device == "cuda":
        checks["K1 22 x decode steps, K2 never"] = all(
            w["steps"] > 0 and w["launches"] == (n_layers * w["steps"], 0)
            for w in waves.values())
    if not all(checks.values()):
        raise AssertionError(f"phase 4f (a): {checks}; failed {failed}, "
                             f"{life}")
    # teacher-forced: 2 survivors that requeued (recomputed), in bf16
    # and with the bf16 weights in fp32
    requeued = sorted((k for k in survivors
                       if bad["hs"][k]._req.attempts),
                      key=lambda k: -bad["hs"][k]._req.attempts)[:2]
    if len(requeued) < 2:
        raise AssertionError(f"phase 4f (a): {len(requeued)} requeued "
                             f"survivors, want 2")
    checked = [(prompts[order[k]], outs[k][1]) for k in requeued]
    gaps_bf16 = [x for p, o in checked
                 for x in _gaps(model, p, o, "fp", device)]
    ref32 = _fp32_copy(tl, model, device)
    gaps32 = [x for p, o in checked
              for x in _gaps(ref32, p, o, "fp", device)]
    del ref32
    if max(gaps_bf16 + gaps32) > LOGIT_SLACK:
        raise AssertionError(f"phase 4f (a): a requeued token sits "
                             f"{max(gaps_bf16)} (bf16) / {max(gaps32)} "
                             f"(fp32) below the top logit")
    # where each survivor first parts from its unfaulted twin (a
    # recompute runs the gather path: a bf16 near-tie may part them)
    parts = {}
    for k in survivors:
        a, b = outs[k][1], clean["hs"][k].result()
        parts[order[k]] = next((j for j, (x, y) in enumerate(zip(a, b))
                                if x != y), None)
    # each faulted round's wall against the median round of the wave
    walls = {r: t1 - t0 for r, t0, t1, _seated in bad["rounds"]}
    median = float(np.median(list(walls.values())))
    fault_rounds = {}
    for site, rnd, sid, kind in inj.log:
        fault_rounds.setdefault(rnd, []).append(f"{site}:{kind}")

    def ttft_p50(w, ks):
        return float(np.median([w["hs"][k].ttft_s for k in ks]))

    res = {
        "failed": {int(order[k]): t for k, t in failed.items()},
        "lifecycle": life, "tok_s_faulted": bad["tokens"] / bad["wall"],
        "tok_s_unfaulted": clean["tokens"] / clean["wall"],
        "survivor_ttft_p50_s_faulted": ttft_p50(bad, survivors),
        "survivor_ttft_p50_s_unfaulted": ttft_p50(clean, survivors),
        "median_round_s": median,
        "fault_rounds": {int(r): {"kinds": v, "wall_s": walls.get(r)}
                         for r, v in fault_rounds.items()},
        "rounds_faulted": len(walls),
        "k1_launches": bad["launches"][0] + clean["launches"][0],
        "decode_steps": bad["steps"] + clean["steps"],
        "requeued_checked": [int(order[k]) for k in requeued],
        "teacher_forced_max_gap_bf16": max(gaps_bf16),
        "teacher_forced_max_gap_fp32": max(gaps32),
        "survivor_parts_from_unfaulted_at": parts}
    # a replica kill: every request fails with ReplicaKilled and the
    # engine stops, leak-free
    inj.kill_replica(round=eng._round + 2)
    hs = [eng.submit(prompts[i], n_new) for i in order[2:6]]
    _wait_done(hs, 120)
    eng._thread.join(timeout=30)
    killed = [_outcome(h)[1] for h in hs]
    if (killed != ["ReplicaKilled"] * 4 or not eng.load_report()["stopped"]
            or eng.stats["failed_all"] != 1):
        raise AssertionError(f"phase 4f (a): replica kill: {killed}")
    check_quiesced(eng)
    try:
        eng.submit(prompts[0], 4)
        raise AssertionError("a killed engine admitted a request")
    except EngineShutdown:
        pass
    res["kill_replica"] = killed
    return res


def _lanes_wave(tl, pa, model, rollouts, online, device: str) -> tuple:
    """Phase 4f (b): 24 rollouts through ``submit_rollout_batch`` on the
    int8 pool with the prefix cache, an online burst of 8 once they
    decode; the same 8 first alone on the idle engine. Returns the
    results and the engine (for (c))."""
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.faults import FaultInjector, check_quiesced
    inj = FaultInjector()
    eng = LLMEngine(model, max_slots=16, page_size=64, n_pages=513, chunk=8,
                    kv_dtype="int8", prefix_cache=True, fault_injector=inj,
                    device=device).start()
    eng.submit(online[0][:100], 64).result()             # warm-up
    # the 8 online requests alone on the idle engine, then a cold cache
    hs = [eng.submit(p, 64) for p in online]
    _wait_done(hs, 300)
    idle_ttft = float(np.median([h.ttft_s for h in hs]))
    eng.wait_idle(60)
    with eng._lock:
        eng.prefix_cache.clear()
    eng.reset_latency_stats()
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    steps0 = eng.stats["decode_steps"]
    pre0 = eng.stats["batch_preemptions"]
    tok0 = eng.stats["batch_tokens"]
    rb, ho = [], []
    burst = {}

    def before():
        # the online burst, at the round boundary after the 16th rollout
        # streams: every slot busy, batch still waiting
        if not ho and sum(1 for h in rb if h._req.generated) >= 16:
            burst["t"] = time.monotonic()
            ho.extend(eng.submit(p, 64) for p in online)

    rounds = _timed_rounds(eng, before)
    t0 = time.monotonic()
    rb.extend(eng.submit_rollout_batch(rollouts, max_new_tokens=128,
                                       trace_id="4f"))
    _wait_done(rb, 600)
    _wait_done(ho, 600)
    t_online = burst["t"]
    wall = time.monotonic() - t0
    eng.wait_idle(60)
    del eng.step
    launches = (pa.paged_decode_attention.launches,
                pa.paged_decode_attention.launches_int8)
    steps = eng.stats["decode_steps"] - steps0
    check_quiesced(eng)
    # no online request waited behind a batch admission: no rollout was
    # seated in a round that started after the burst and before that
    # online request's own admission
    online_rids = {h._req.rid for h in ho}
    seated, admitted = set(), []
    for _r, ts, _te, now in rounds:
        admitted.append((ts, now - seated))
        seated = now
    behind = 0
    for h in ho:
        first = next(i for i, (_ts, new) in enumerate(admitted)
                     if h._req.rid in new)
        behind += sum(1 for ts, new in admitted[:first]
                      if ts > t_online and new - online_rids)
    outs = [_outcome(h) for h in rb + ho]
    preempted = [i for i, h in enumerate(rb) if h._req.preemptions]
    checks = {
        "batch_preempted >= 1":
            eng.stats["batch_preemptions"] - pre0 >= 1,
        "every request complete": all(
            o[0] == "ok" and len(o[1]) == (128 if i < len(rb) else 64)
            for i, o in enumerate(outs)),
        "no online request behind a batch admission": behind == 0,
        "2 preempted rollouts": len(preempted) >= 2,
    }
    if device == "cuda":
        checks["K2 22 x decode steps, K1 never"] = (
            steps > 0 and launches == (0, model.cfg.n_layers * steps))
    if not all(checks.values()):
        raise AssertionError(f"phase 4f (b): {checks}")
    checked = [(rollouts[i], outs[i][1]) for i in preempted[:2]]
    gaps_int8 = [x for p, o in checked
                 for x in _gaps(model, p, o, "int8", device)]
    ref32 = _fp32_copy(tl, model, device)
    gaps32 = [x for p, o in checked
              for x in _gaps(ref32, p, o, "fp", device)]
    del ref32
    if max(gaps_int8 + gaps32) > INT8_LOGIT_SLACK:
        raise AssertionError(f"phase 4f (b): a preempted rollout's token "
                             f"sits {max(gaps_int8)} (bf16, int8 pool) / "
                             f"{max(gaps32)} (fp32) below the top logit")
    batch_tokens = eng.stats["batch_tokens"] - tok0
    res = {
        "online_ttft_p50_s_backlog": float(np.median(
            [h.ttft_s for h in ho])),
        "online_ttft_p50_s_idle": idle_ttft,
        "batch_tok_s": batch_tokens / wall, "batch_tokens": batch_tokens,
        "batch_preempted": eng.stats["batch_preemptions"] - pre0,
        "k2_launches": launches[1], "decode_steps": steps,
        "teacher_forced_max_gap_int8": max(gaps_int8),
        "teacher_forced_max_gap_fp32": max(gaps32),
        "wall_s": wall}
    return res, eng, inj


def _wedge(eng, inj, prompts) -> dict:
    """Phase 4f (c): a decode dispatch wedged (a hang plan) on a live
    engine holding a prefix cache: the report, a shed, force_kill, the
    released zombie, and a second shutdown()."""
    from ray_tpu_torch.serve.errors import EngineOverloaded, EngineShutdown
    from ray_tpu_torch.serve.faults import check_quiesced
    cached = eng.prefix_cache.cached_pages
    eng.admit_timeout_s = 0.2
    inj.hang("dispatch_decode")
    hs = [eng.submit(p, 64) for p in prompts]
    errs = [None] * len(hs)

    def read(i):
        try:
            for _ in hs[i].stream():
                pass
        except EngineShutdown as e:
            errs[i] = e

    readers = [threading.Thread(target=read, args=(i,))
               for i in range(len(hs))]
    for t in readers:
        t.start()
    deadline = time.monotonic() + 120
    while not any(e[0] == "dispatch_decode" for e in inj.log):
        if time.monotonic() > deadline:
            raise AssertionError("phase 4f (c): the hang never engaged")
        time.sleep(0.001)
    time.sleep(0.05)
    t0 = time.monotonic()
    r1 = eng.load_report()
    report_s = time.monotonic() - t0
    time.sleep(0.1)
    r2 = eng.load_report()
    t0 = time.monotonic()
    try:
        eng.submit(prompts[0], 8)
        shed = None
    except EngineOverloaded as e:
        shed = e
    shed_s = time.monotonic() - t0
    t0 = time.monotonic()
    eng.force_kill()
    for t in readers:
        t.join(timeout=5)
    unblock_s = time.monotonic() - t0
    eng.shutdown()         # the thread is still wedged: cleanup deferred
    emitted = [len(h._req.generated) for h in hs]
    inj.release_all()
    eng._thread.join(timeout=30)
    zombie_alive = eng._thread.is_alive()
    committed = [len(h._req.generated) for h in hs]
    cached_after = eng.prefix_cache.cached_pages
    eng.shutdown()         # the second: the deferred cleanup
    check_quiesced(eng, expect_cached_pages=cached)
    checks = {
        "load_report within 50 ms": report_s < 0.05,
        "heartbeat_age_s growing": r2["heartbeat_age_s"]
            > r1["heartbeat_age_s"] > 0,
        "submit shed EngineOverloaded in < 0.5 s": shed is not None
            and shed_s < 0.5,
        "force_kill unblocked every reader in < 1 s": unblock_s < 1.0
            and all(isinstance(e, EngineShutdown) for e in errs)
            and not any(t.is_alive() for t in readers),
        "the zombie exited and committed no token": not zombie_alive
            and committed == emitted,
        "the prefix cache as it was": cached_after == cached,
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 4f (c): {checks}")
    return {"load_report_ms": report_s * 1e3,
            "heartbeat_age_s": [r1["heartbeat_age_s"],
                                r2["heartbeat_age_s"]],
            "shed_ms": shed_s * 1e3, "unblock_ms": unblock_s * 1e3,
            "readers": len(hs), "cached_pages": cached}


def phase_faults_lanes_path(tl, pa, seed: int, smi: str, cfg=None,
                            device: str = "cuda") -> dict:
    """Phase 4f: the engine's fault containment, priority lanes and
    wedge handling at full width (TinyLlama-1.1B bf16 unless ``cfg``;
    ``device="cpu"`` with a small ``cfg`` rehearses it without a card)."""
    cfg = cfg or tl.tinyllama_1_1b()
    params = tl.init_params(cfg, seed=seed, device=device)
    model = tl.build_model(cfg, params, device)
    del params
    # phase 4's 16 prompts (the same draws after its warm-up prompt)
    g = np.random.default_rng(seed)
    g.integers(0, cfg.vocab_size, 100)
    prompts = [g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in g.integers(16, 1537, size=16)]
    g = np.random.default_rng(seed + 7)
    rollouts = [g.integers(0, cfg.vocab_size, 512).tolist()
                for _ in range(24)]
    online = [g.integers(0, cfg.vocab_size, int(n)).tolist()
              for n in g.integers(16, 1025, size=8)]
    res = {"card": smi}
    res["containment"] = _containment_wave(tl, pa, model, prompts, device)
    a = res["containment"]
    print(f"phase 4f (a): TinyLlama-1.1B bf16, fp pool, 16 requests x 64 "
          f"on {smi}: failed {a['failed']} (prompt index: type), "
          f"lifecycle_stats {a['lifecycle']}; tok/s faulted "
          f"{a['tok_s_faulted']:.1f} / unfaulted {a['tok_s_unfaulted']:.1f};"
          f" survivor TTFT p50 faulted "
          f"{a['survivor_ttft_p50_s_faulted'] * 1e3:.1f} ms / unfaulted "
          f"{a['survivor_ttft_p50_s_unfaulted'] * 1e3:.1f} ms; median round "
          f"{a['median_round_s'] * 1e3:.2f} ms, faulted rounds "
          + ", ".join(f"{r}: {v['kinds']} "
                      + (f"{v['wall_s'] * 1e3:.2f} ms"
                         if v["wall_s"] is not None else "")
                      for r, v in sorted(a["fault_rounds"].items()))
          + f"; K1 {a['k1_launches']} = {cfg.n_layers} x "
          f"{a['decode_steps']} decode steps; requeued {a['requeued_checked']}"
          f" teacher-forced max gap {a['teacher_forced_max_gap_bf16']:.4f}"
          f" (bf16) / {a['teacher_forced_max_gap_fp32']:.4f} (fp32); "
          f"survivors part from the unfaulted run at "
          f"{a['survivor_parts_from_unfaulted_at']}; replica kill: "
          f"{len(a['kill_replica'])} x ReplicaKilled, engine stopped")
    if device == "cuda":
        torch.cuda.empty_cache()
    lanes, eng, inj = _lanes_wave(tl, pa, model, rollouts, online, device)
    res["lanes"] = lanes
    print(f"phase 4f (b): int8 pool + prefix cache, 24 rollouts x 128 "
          f"(512-token prompts) then 8 online x 64 on {smi}: online TTFT "
          f"p50 {lanes['online_ttft_p50_s_backlog'] * 1e3:.1f} ms with the "
          f"batch backlog / {lanes['online_ttft_p50_s_idle'] * 1e3:.1f} ms "
          f"idle; batch {lanes['batch_tok_s']:.1f} tok/s, batch_tokens "
          f"{lanes['batch_tokens']}, batch_preempted "
          f"{lanes['batch_preempted']}; K2 {lanes['k2_launches']} = "
          f"{cfg.n_layers} x {lanes['decode_steps']} decode steps; "
          f"preempted rollouts teacher-forced max gap "
          f"{lanes['teacher_forced_max_gap_int8']:.4f} (bf16, int8 pool) / "
          f"{lanes['teacher_forced_max_gap_fp32']:.4f} (fp32)")
    res["wedge"] = _wedge(eng, inj, online[:4])
    w = res["wedge"]
    print(f"phase 4f (c): hang at dispatch_decode on {smi}: load_report "
          f"{w['load_report_ms']:.2f} ms, heartbeat_age_s "
          f"{w['heartbeat_age_s'][0]:.3f} -> {w['heartbeat_age_s'][1]:.3f};"
          f" submit shed in {w['shed_ms']:.1f} ms; force_kill unblocked "
          f"{w['readers']} readers in {w['unblock_ms']:.2f} ms; the "
          f"released zombie committed nothing, {w['cached_pages']} cached "
          f"pages as before; second shutdown leak-free")
    return res


def _append_cost_ns(obs) -> dict:
    """``EventLog.append`` on the decode hot path's shape, per event,
    with the log on and off (host ns, 200 000 appends each)."""
    out = {}
    for enabled in (True, False):
        log = obs.EventLog(8192, enabled=enabled)
        t0 = time.perf_counter()
        for _ in range(200_000):
            log.append("decode", sid=0, data=8)
        out["on" if enabled else "off"] = \
            (time.perf_counter() - t0) / 200_000 * 1e9
    return out


def _obs_wave(model, prompts, device: str, events: bool,
              flight_dir=None) -> tuple:
    """Phase 4g (a)'s arm: one engine (16 slots, 64-token pages, 513
    pages, the default loop), one warm-up request, then ``prompts`` x
    64 new tokens. Returns the arm's numbers and the engine (running)."""
    from ray_tpu_torch.serve import obs
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.faults import FaultInjector
    from ray_tpu_torch.util import metrics
    inj = FaultInjector()
    eng = LLMEngine(model, max_slots=16, page_size=64, n_pages=513, chunk=8,
                    events=events, flight_dir=flight_dir,
                    fault_injector=inj, device=device).start()
    eng.submit(prompts[0][:100], 64).result()
    if not eng.wait_idle(60):
        raise AssertionError("phase 4g (a): warm-up did not settle")
    eng.reset_latency_stats()
    eng.events.clear()
    metrics.clear_registry()          # fresh serve_phase_* histograms
    t0 = time.monotonic()
    hs = [eng.submit(p, 64) for p in prompts]
    _wait_done(hs, 600)
    wall = time.monotonic() - t0
    if not eng.wait_idle(60):
        raise AssertionError("phase 4g (a): the engine did not settle")
    pm = obs.phase_metrics()
    counts = {k: sum(v["count"] for _t, v in pm[k]._samples())
              for k in pm}
    tokens = sum(len(h.result()) for h in hs)
    return {"hs": hs, "tok_s": tokens / wall, "tokens": tokens,
            "ttft_p50_s": float(np.median([h.ttft_s for h in hs])),
            "phase_counts": counts, "events": eng.events.snapshot(),
            "inj": inj}, eng


def _check_obs_arm(obs, arm: dict) -> dict:
    """Phase 4g (a)'s checks on an ``events=True`` arm: every request's
    submit -> admit -> first_token -> retire in order,
    ``request_phases`` TTFT equal to the handle's within 1 ms, the
    Chrome trace a loadable JSON, and the ``inter_token`` histogram
    observed once per emit but each request's first."""
    evs = arm["events"]
    by_rid = {}
    for e in evs:
        if isinstance(e[obs.RID], int):
            by_rid.setdefault(e[obs.RID], []).append(e[obs.ETYPE])
    ph = obs.request_phases(evs)
    order_ok, ttft_err, emits = True, 0.0, 0
    for h in arm["hs"]:
        rid = h._req.rid
        kinds = by_rid.get(rid, [])
        marks = [k for k in kinds
                 if k in ("submit", "admit", "first_token", "retire")]
        order_ok &= marks == ["submit", "admit", "first_token", "retire"]
        ttft_err = max(ttft_err, abs(ph[rid]["ttft_s"] - h.ttft_s))
        emits += kinds.count("emit")
    trace = json.loads(json.dumps(obs.chrome_trace({"engine": evs})))
    spans = sum(1 for e in trace if e.get("ph") == "X")
    checks = {
        "submit -> admit -> first_token -> retire": order_ok,
        "request_phases TTFT within 1 ms": ttft_err < 1e-3,
        "chrome_trace loads": spans >= 4 * len(arm["hs"]),
        "inter_token = emits - 1 per request":
            arm["phase_counts"]["inter_token"] == emits - len(arm["hs"]),
        "ttft observed per request":
            arm["phase_counts"]["ttft"] == len(arm["hs"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 4g (a): {checks}")
    return {"events": len(evs), "ttft_max_err_s": ttft_err,
            "emits": emits, "chrome_spans": spans}


def _session_traffic(vocab: int, seed: int, system: int = 512,
                     turn: int = 32) -> tuple:
    """Phase 4g (b)'s traffic, from ``default_rng(seed + 11)``: a
    100-token warm-up prompt; 8 sessions, each with its own ``system``
    (512) token system prompt; 3 turns of a ``turn`` (32) token user
    message; then a second wave of 4 more messages per session."""
    g = np.random.default_rng(seed + 11)

    def rand(n):
        return g.integers(0, vocab, int(n)).tolist()

    systems = [rand(system) for _ in range(8)]
    turns = [[rand(turn) for _ in range(8)] for _ in range(3)]
    wave2 = [[rand(turn) for _ in range(4)] for _ in range(8)]
    return rand(100), systems, turns, wave2


def _run_sessions(dep, systems, turns, n_new: int) -> dict:
    """The 3 turns of every session through ``dep.stream``, a thread
    per request, sessions in cyclic order each turn; each turn's prompt
    is the session's history (system prompt, earlier messages and
    replies) plus its new message."""
    history = [list(s) for s in systems]
    ttfts, prompts, tokens = [], [], 0
    t0 = time.monotonic()
    for msgs in turns:
        wave = [history[s] + msgs[s] for s in range(len(history))]
        outs = [None] * len(wave)

        def run(s):
            t = time.monotonic()
            got = []
            for tok in dep.stream({"prompt_ids": wave[s],
                                   "session_id": f"s{s}",
                                   "max_new_tokens": n_new}):
                if not got:
                    ttfts.append(time.monotonic() - t)
                got.append(tok)
            outs[s] = got

        threads = [threading.Thread(target=run, args=(s,))
                   for s in range(len(wave))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(o is None or len(o) != n_new for o in outs):
            raise AssertionError("phase 4g (b): a session turn came back "
                                 "short")
        prompts.append(wave)
        tokens += sum(len(o) for o in outs)
        history = [w + o for w, o in zip(wave, outs)]
    wall = time.monotonic() - t0
    return {"tok_s": tokens / wall, "ttft_p50_s": float(np.median(ttfts)),
            "prompts": prompts, "history": history, "tokens": tokens}


def _decode_steps(engines) -> int:
    return sum(e.stats["decode_steps"] for e in engines)


def _hold_then_arm(eng, arm) -> dict:
    """Shadow ``eng.step`` so the scheduler holds its rounds (outside
    the engine lock) until ``state["queued"]`` is set, and calls
    ``arm()`` at the first round boundary at which part of the work
    there has streamed and part has not, recording both sets of request
    ids. ``del eng.step`` restores it."""
    state = {"queued": False, "armed": False, "streamed": set(),
             "fresh": set()}
    step = eng.step

    def wrapped():
        while not state["queued"]:
            time.sleep(0.0005)
        if not state["armed"]:
            reqs = ([s.req for s in eng.slots if s is not None]
                    + list(eng._wait))
            done = {r.rid for r in reqs if r.generated}
            fresh = {r.rid for r in reqs if not r.generated}
            if done and fresh:
                state.update(armed=True, streamed=done, fresh=fresh)
                arm()
        return step()

    eng.step = wrapped
    return state


def _pool_kill_wave(model, pool, history, wave2, n_new: int,
                    device: str) -> dict:
    """Phase 4g (b)'s second wave: 4 requests per session (its history
    plus a new message), sticky to the session's replica: 4 or more
    prefills of ~96 uncached tokens outrun one round's 256-token budget,
    so they finish in different rounds. On replica 1's scheduler thread,
    the first round boundary at which some of the wave there has
    streamed and some has not arms a ``kill_replica``; replica 1 holds
    its rounds until the whole wave is routed. The requests that
    had streamed must fail typed ``EngineShutdown``, the others
    resubmit to replica 0 and complete, replica 1 is rebuilt with its
    generation + 1, and the pool quiesces."""
    from ray_tpu_torch.serve.errors import EngineShutdown
    from ray_tpu_torch.serve.faults import (FaultInjector,
                                            check_pool_quiesced)
    victim = pool.replica(1)
    eng = victim.engine
    inj = FaultInjector()
    eng._injector = inj
    # the kill fires at the top of the step that arms it
    state = _hold_then_arm(eng, inj.kill_replica)
    reqs = [(s, history[s] + wave2[s][k]) for k in range(4)
            for s in range(8)]
    hs, first = [], []
    for s, p in reqs:
        h = pool.submit(p, max_new_tokens=n_new, session_id=f"s{s}")
        hs.append(h)
        first.append((h.replica_idx, h._inner._req.rid))
    state["queued"] = True            # the whole wave is routed
    outs = [None] * len(hs)

    def consume(i):
        outs[i] = _outcome(hs[i])

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(hs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if not state["armed"]:
        raise AssertionError(
            f"phase 4g (b): the wave on replica 1 never stood part "
            f"streamed, part not ({sum(r == 1 for r, _ in first)} "
            f"requests there)")
    deadline = time.monotonic() + 60
    while pool.replica(1).generation != victim.generation + 1:
        if time.monotonic() > deadline:
            raise AssertionError("phase 4g (b): replica 1 not rebuilt")
        time.sleep(0.01)
    for e in pool.engines():
        e.wait_idle(60)
    check_pool_quiesced(pool)
    failed = [i for i, o in enumerate(outs) if o[0] == "err"]
    resub = [i for i, (rep, rid) in enumerate(first)
             if rep == 1 and rid in state["fresh"]]
    checks = {
        "the kill fired mid-wave": state["armed"] and bool(inj.log),
        "the streamed requests failed typed": sorted(failed) == sorted(
            i for i, (rep, rid) in enumerate(first)
            if rep == 1 and rid in state["streamed"])
            and all(outs[i][1] == "EngineShutdown" for i in failed),
        "unstreamed ones resubmitted and complete": bool(resub) and all(
            outs[i][0] == "ok" and len(outs[i][1]) == n_new
            and hs[i].resubmits == 1 and hs[i].replica_idx == 0
            for i in resub),
        "no other request failed": all(
            outs[i][0] == "ok" for i in range(len(hs))
            if first[i][0] == 0),
        "one replica death": pool.route_stats["replica_deaths"] == 1,
        "replica 1 rebuilt, generation + 1":
            pool.replica(1).state == "healthy"
            and pool.replica(1).generation == victim.generation + 1,
    }
    del eng.step
    if not all(checks.values()):
        raise AssertionError(f"phase 4g (b) kill: {checks}; outs "
                             f"{[o[:2] if o[0] == 'err' else 'ok' for o in outs]}")
    # resubmitted bf16 streams: teacher-forced, as phases 4d and 4f
    checked = resub[:2]
    gaps = [x for i in checked
            for x in _gaps(model, reqs[i][1], outs[i][1], "fp", device)]
    if max(gaps) > LOGIT_SLACK:
        raise AssertionError(f"phase 4g (b): a resubmitted token sits "
                             f"{max(gaps)} below the top logit")
    return {"streamed_failed": len(failed), "resubmitted": len(resub),
            "requests": len(hs),
            "on_replica_1": sum(1 for rep, _ in first if rep == 1),
            "generation_after": pool.replica(1).generation,
            "teacher_forced_max_gap_bf16": max(gaps),
            "killed_engine": eng}


def phase_obs_pool_path(tl, pa, seed: int, smi: str, cfg=None,
                        device: str = "cuda") -> dict:
    """Phase 4g: the event log and the engine pool at full width
    (TinyLlama-1.1B bf16 unless ``cfg``; ``device="cpu"`` with a small
    ``cfg`` rehearses it without a card)."""
    from ray_tpu_torch.serve import obs
    from ray_tpu_torch.models.kv_cache import export_pages_bytes
    from ray_tpu_torch.serve.llm import LlamaDeployment
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    cfg = cfg or tl.tinyllama_1_1b()
    n_layers = cfg.n_layers
    cuda = device == "cuda"
    params = tl.init_params(cfg, seed=seed, device=device)
    model = tl.build_model(cfg, params, device)
    # phase 4's prompts (the same draws after its warm-up prompt)
    g = np.random.default_rng(seed)
    g.integers(0, cfg.vocab_size, 100)
    prompts = [g.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in g.integers(16, 1537, size=16)][:8]
    res = {"card": smi}
    # (a) the event log on, off, on
    arms = {}
    for name, events in (("on", True), ("off", False), ("on_again", True)):
        flight = tempfile.mkdtemp() if name == "on_again" else None
        arm, eng = _obs_wave(model, prompts, device, events, flight)
        if events:
            arm["checked"] = _check_obs_arm(obs, arm)
        elif (eng.events.total or any(arm["phase_counts"].values())
              or list(eng.sched_trace)):
            raise AssertionError("phase 4g (a): events=False recorded")
        if name == "on_again":
            # a contained decode fault writes a flight bundle naming it
            inj = arm["inj"]
            inj.inject("dispatch_decode", sid=2, round=eng._round + 3,
                       exc=RuntimeError("decode fault"))
            hs = [eng.submit(p, 64) for p in prompts[:4]]
            _wait_done(hs, 600)
            outs = [_outcome(h) for h in hs]
            culprits = [h._req.rid for h, o in zip(hs, outs)
                        if o[0] == "err"]
            dirs = [os.path.join(flight, d) for d in os.listdir(flight)]
            bundle = obs.load_flight_bundle(dirs[0]) if dirs else {}
            fault = [ev for ev in bundle.get("engine", {}).get(
                "events", []) if ev["type"] == "fault"]
            if (len(dirs) != 1 or len(culprits) != 1 or not fault
                    or fault[-1]["rid"] != culprits[0]):
                raise AssertionError(f"phase 4g (a): bundle {dirs}, "
                                     f"culprits {culprits}, {fault}")
            arm["bundle"] = {"reason": bundle["reason"],
                             "culprit_rid": culprits[0],
                             "events_in_bundle": len(
                                 bundle["engine"]["events"])}
        eng.shutdown()
        if flight is not None:
            shutil.rmtree(flight, ignore_errors=True)
        del arm["hs"], arm["events"], arm["inj"]
        arms[name] = arm
        del eng
        if cuda:
            torch.cuda.empty_cache()
    res["obs"] = {"arms": arms, "append_ns": _append_cost_ns(obs)}
    a = res["obs"]
    print(f"phase 4g (a): TinyLlama-1.1B bf16, 8 requests x 64 on {smi}: "
          + "; ".join(f"events {k}: {v['tok_s']:.1f} tok/s, TTFT p50 "
                      f"{v['ttft_p50_s'] * 1e3:.1f} ms"
                      for k, v in arms.items())
          + f"; append {a['append_ns']['on']:.0f} ns/event on, "
          f"{a['append_ns']['off']:.0f} off; "
          f"{arms['on']['checked']['events']} events, every request "
          f"submit -> admit -> first_token -> retire, TTFT vs handle "
          f"{arms['on']['checked']['ttft_max_err_s'] * 1e6:.1f} us, "
          f"inter_token = emits - 8; fault bundle "
          f"{arms['on_again']['bundle']}")
    del model
    # (b) the pool against one engine on the same session trace
    n_new = 32
    warm, systems, turns, wave2 = _session_traffic(cfg.vocab_size, seed)
    kw = dict(max_slots=16, page_size=64, n_pages=513,
              max_new_tokens=n_new, prefix_cache=True, device=device)
    one = LlamaDeployment(cfg, params, **kw)
    one(warm)
    one_run = _run_sessions(one, systems, turns, n_new)
    one.shutdown()
    del one
    if cuda:
        torch.cuda.empty_cache()
    dep = LlamaDeployment(cfg, params, num_engine_replicas=2, **kw)
    dep(warm)
    pool = dep.engine()
    for e in pool.engines():
        e.wait_idle(60)
    engines = list(pool.engines())
    steps0 = _decode_steps(engines)
    hits0 = pool.stats["cache_hit_tokens"]
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    run = _run_sessions(dep, systems, turns, n_new)
    placed = {s: pool._sticky.get(f"s{s}") for s in range(8)}
    expected = 0
    for turn in range(1, 3):
        for s in range(8):
            cached = [run["prompts"][t][s2] for t in range(turn)
                      for s2 in range(8) if placed[s2] == placed[s]]
            expected += _expected_hits(cached, run["prompts"][turn][s], 64)
    hits = pool.stats["cache_hit_tokens"] - hits0
    ps = pool.pool_stats()
    routes = collections.Counter(e[obs.SID] for e in pool.events.snapshot()
                                 if e[obs.ETYPE] == "route")
    kill = _pool_kill_wave(dep.model, pool, run["history"], wave2, n_new,
                           device)
    engines.append(kill.pop("killed_engine"))
    engines = list({id(e): e for e in engines + pool.engines()}.values())
    steps = _decode_steps(engines) - steps0
    k_launch = (pa.paged_decode_attention.launches,
                pa.paged_decode_attention.launches_int8)
    checks = {
        "affinity hits: 2 later turns x 8 sessions":
            ps["affinity_hits"] == 16,
        "cache hit tokens as expected": hits == expected,
        "both replicas served": len(routes) == 2,
    }
    if cuda:
        checks["K1 22 x decode steps, K2 never"] = \
            steps > 0 and k_launch == (n_layers * steps, 0)
    if not all(checks.values()):
        raise AssertionError(f"phase 4g (b): {checks}; hits {hits} vs "
                             f"{expected}, {ps['affinity_hits']}, "
                             f"launches {k_launch} steps {steps}")
    res["pool"] = {
        "tok_s": run["tok_s"], "ttft_p50_s": run["ttft_p50_s"],
        "one_engine_tok_s": one_run["tok_s"],
        "one_engine_ttft_p50_s": one_run["ttft_p50_s"],
        "affinity_hits": ps["affinity_hits"], "cache_hit_tokens": hits,
        "expected_hit_tokens": expected,
        "routes_per_replica": {int(k): v for k, v in sorted(routes.items())},
        "kill": kill, "k1_launches": k_launch[0], "decode_steps": steps}
    dep.shutdown()
    del dep, pool, engines
    if cuda:
        torch.cuda.empty_cache()
    p = res["pool"]
    print(f"phase 4g (b): LlamaDeployment(num_engine_replicas=2, "
          f"prefix_cache=True) on {smi}, 8 sessions x 3 turns (512-token "
          f"system prompts, 32-token turns, 32 new): pool "
          f"{p['tok_s']:.1f} tok/s, TTFT p50 {p['ttft_p50_s'] * 1e3:.1f} ms"
          f" / one engine {p['one_engine_tok_s']:.1f} tok/s, TTFT p50 "
          f"{p['one_engine_ttft_p50_s'] * 1e3:.1f} ms; affinity hits "
          f"{p['affinity_hits']} (16 expected), hit tokens "
          f"{p['cache_hit_tokens']} = {p['expected_hit_tokens']} expected; "
          f"routes per replica {p['routes_per_replica']}; kill of replica 1"
          f": {p['kill']['streamed_failed']} streamed failed typed, "
          f"{p['kill']['resubmitted']} resubmitted and complete of "
          f"{p['kill']['on_replica_1']} there, generation "
          f"{p['kill']['generation_after']}, resubmitted teacher-forced max "
          f"gap {p['kill']['teacher_forced_max_gap_bf16']:.4f}; K1 "
          f"{p['k1_launches']} = {n_layers} x {p['decode_steps']} decode "
          f"steps")
    # the int8 arm: a cold route pulls a session's prefix, and a weight
    # swap fences the pull
    dep = LlamaDeployment(cfg, params, num_engine_replicas=2,
                          kv_dtype="int8", **kw)
    dep(warm)
    pool = dep.engine()
    for e in pool.engines():
        e.wait_idle(60)
    engines = list(pool.engines())
    steps0 = _decode_steps(engines)
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    sa = systems[0] + turns[0][0]
    h = pool.submit(sa, max_new_tokens=n_new, session_id="a")
    h.result()
    warm_idx = h.replica_idx
    cold_idx = 1 - warm_idx
    donor, req = pool.replica(warm_idx).engine, pool.replica(cold_idx).engine
    donor.wait_idle(60)
    with pool._lock:                 # the session lives on the other one
        pool._sticky["b"] = cold_idx
    sb = systems[0] + turns[1][0]
    hb = pool.submit(sb, max_new_tokens=n_new, session_id="b")
    out_b = hb.result()
    req.wait_idle(60)
    hashes = path_hashes(systems[0], 64)
    landed = {}
    for name, e in (("donor", donor), ("requester", req)):
        pinned = e.kv_pin_prefix(hashes)
        landed[name] = (len(pinned), export_pages_bytes(e.pages, pinned))
        e.kv_release_pages(pinned)
    mig = pool.kv_migration_stats()
    steps = _decode_steps(engines) - steps0
    k_launch = (pa.paged_decode_attention.launches,
                pa.paged_decode_attention.launches_int8)
    # the fence: the donor swaps to another payload and caches session
    # c's prompt under it; the requester may not pull that
    pool.swap_replica_weights(warm_idx, params, weights_id="g-other")
    sc = systems[1] + turns[0][1]
    donor.submit(sc, max_new_tokens=2).result()
    donor.wait_idle(60)
    reports = {i: pool.replica(i).engine.load_report() for i in (0, 1)}
    chain = path_hashes(sc, 64)
    covered = all(x in reports[warm_idx]["prefix_digest"]
                  for x in chain[:8])
    hint = pool._pull_hint(sc, pool.replica(cold_idx), reports)
    checks = {
        "the cold route pulled": hb.replica_idx == cold_idx
            and mig["pulls"] >= 1 and mig["pulled_pages"] == 8
            and mig["fallbacks"] == 0,
        "landed bytes equal the donor's": landed["donor"][0] == 8
            and landed["requester"] == landed["donor"],
        "stream complete": len(out_b) == n_new,
        "the fenced pull refused": covered and hint is None,
    }
    if cuda:
        checks["K2 22 x decode steps, K1 never"] = \
            steps > 0 and k_launch == (0, n_layers * steps)
    if not all(checks.values()):
        raise AssertionError(f"phase 4g int8: {checks}; {mig}, launches "
                             f"{k_launch} steps {steps}")
    res["int8"] = {"pulled_pages": mig["pulled_pages"],
                   "wire_bytes": mig.get("wire_bytes"),
                   "k2_launches": k_launch[1], "decode_steps": steps,
                   "fenced_hint": hint}
    dep.shutdown()
    del dep, pool, engines, donor, req
    if cuda:
        torch.cuda.empty_cache()
    print(f"phase 4g (b) int8: a cold route pulled session a's 8 prefix "
          f"pages ({res['int8']['wire_bytes']} wire bytes), landed bytes "
          f"equal the donor's; after a swap to weights_id g-other the "
          f"donor's covering digest is refused (hint None); K2 "
          f"{res['int8']['k2_launches']} = {n_layers} x "
          f"{res['int8']['decode_steps']} decode steps")
    return res


def _arrivals(dep, prompts, n_new: int, gaps, hooks=None) -> dict:
    """``_run_wave`` of the prompts (trace ids ``r<i>``, ``n_new`` tokens
    each): the streams, each request's start and TTFT, TTFT p50 and p99,
    time per output token p50 and tok/s over the wave."""
    outs, stamps, wall, start = _run_wave(
        dep, [{"prompt_ids": p, "max_new_tokens": n_new, "trace_id": f"r{i}"}
              for i, p in enumerate(prompts)], gaps, hooks)
    if any(o is None or len(o) != n_new for o in outs):
        raise AssertionError(f"a request came back short or failed: "
                             f"{[None if o is None else len(o) for o in outs]}")
    ttft = [st[0] - t for st, t in zip(stamps, start)]
    tpot = [(st[-1] - st[0]) / (len(st) - 1) for st in stamps]
    return {"outs": outs, "start": start, "ttft": ttft,
            "tok_s": len(prompts) * n_new / wall, "wall_s": wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "tpot_p50_s": float(np.median(tpot))}


def _handoff_latencies(pool) -> list:
    """Seconds from each ``handoff`` event to its stream's
    ``handoff_first_token``, by trace id (the waves' ``r<i>`` ids)."""
    from ray_tpu_torch.serve import obs
    marks = collections.defaultdict(dict)
    for e in pool.events.snapshot():
        if e[obs.ETYPE] in ("handoff", "handoff_first_token"):
            tid = (e[obs.DATA] or {}).get("trace_id")
            if tid and tid.startswith("r"):
                marks[tid][e[obs.ETYPE]] = e[obs.T]
    return [m["handoff_first_token"] - m["handoff"] for m in marks.values()
            if len(m) == 2]


def _wait_transfers(pool, timeout_s: float = 60.0) -> None:
    """Until no donor of ``pool`` holds an open transfer (a pull that a
    requester's death abandoned still runs to its end)."""
    deadline = time.monotonic() + timeout_s
    while any(d.open_transfers() for d in list(pool._kv_donors.values())):
        if time.monotonic() > deadline:
            raise AssertionError("a KV transfer stayed open")
        time.sleep(0.01)


def phase_pool_control_path(tl, pa, seed: int, smi: str, cfg=None,
                            device: str = "cuda") -> dict:
    """Phase 4h: the pool's disaggregated roles, watchdog and autoscaler
    at full width (TinyLlama-1.1B bf16 unless ``cfg``; ``device="cpu"``
    with a small ``cfg`` rehearses it without a card)."""
    from ray_tpu_torch.models.kv_cache import export_pages_bytes
    from ray_tpu_torch.serve import obs
    from ray_tpu_torch.serve.faults import (FaultInjector, check_pool_quiesced,
                                            check_quiesced)
    from ray_tpu_torch.serve.llm import LlamaDeployment
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    cfg = cfg or tl.tinyllama_1_1b()
    n_layers, cuda = cfg.n_layers, device == "cuda"
    params = tl.init_params(cfg, seed=seed, device=device)
    n_new, Pg = 64, 64
    kw = dict(max_slots=16, page_size=Pg, n_pages=513, max_new_tokens=n_new,
              prefix_cache=True, device=device)
    g = np.random.default_rng(seed + 17)

    def rand(n):
        return g.integers(0, cfg.vocab_size, int(n)).tolist()

    warm = rand(100)
    wave = [rand(n) for n in g.integers(512, 1025, size=16)]
    res = {"card": smi}

    def free():
        if cuda:
            torch.cuda.empty_cache()

    # (a) disaggregated against unified on one arrival trace
    arms = {}
    for name, extra in (("unified", dict(num_engine_replicas=2)),
                        ("disaggregated", dict(disaggregate=True,
                                               prefill_replicas=1,
                                               decode_replicas=1))):
        dep = LlamaDeployment(cfg, params, **kw, **extra)
        pool = dep.engine()
        if name == "unified":
            for e in pool.engines():
                e.submit(warm, 8).result()
        else:
            dep(warm)                 # leg 1, the handoff, leg 2
        for e in pool.engines():
            e.wait_idle(60)
            e.reset_latency_stats()
        engines = pool.engines()
        steps0 = [e.stats["decode_steps"] for e in engines]
        mig0 = dict(pool.replica(1).engine.kv_migration_stats)
        hand0 = pool.route_stats["disagg_handoffs"]
        fetch = []
        _timed(pool, "_kv_fetch", fetch)
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention.launches_int8 = 0
        run = _arrivals(dep, wave, n_new, [0.0] + [0.05] * 15)
        k_launch = (pa.paged_decode_attention.launches,
                    pa.paged_decode_attention.launches_int8)
        for e in engines:
            e.wait_idle(60)
        del pool._kv_fetch
        steps = [e.stats["decode_steps"] - s0
                 for e, s0 in zip(engines, steps0)]
        arm = {k: run[k] for k in ("tok_s", "wall_s", "ttft_p50_s",
                                   "ttft_p99_s", "tpot_p50_s")}
        arm.update(decode_steps=steps, k1_launches=k_launch[0],
                   k2_launches=k_launch[1], outs=run["outs"])
        if name == "disaggregated":
            mig = pool.replica(1).engine.kv_migration_stats
            pulls = {k: mig[k] - mig0[k] for k in mig0}
            lat = _handoff_latencies(pool)
            hashes = path_hashes(wave[0], Pg)[:len(wave[0]) // Pg]
            landed = {}
            for side, e in (("donor", pool.replica(0).engine),
                            ("requester", pool.replica(1).engine)):
                pinned = e.kv_pin_prefix(hashes)
                landed[side] = (len(pinned),
                                export_pages_bytes(e.pages, pinned))
                e.kv_release_pages(pinned)
            arm.update(
                handoffs=pool.route_stats["disagg_handoffs"] - hand0,
                fallbacks=pool.route_stats["disagg_handoff_fallbacks"],
                pulls=pulls,
                handoff_p50_s=float(np.percentile(lat, 50)),
                handoff_p99_s=float(np.percentile(lat, 99)),
                n_handoff_latencies=len(lat),
                pull_host_ms_per_page=1e3 * sum(fetch)
                / max(1, pulls["pulled_pages"]),
                wire_mb=pulls["wire_bytes"] / 1e6,
                landed_pages=landed["donor"][0],
                landed_equal=landed["donor"] == landed["requester"])
            want_pages = sum(len(p) // Pg for p in wave)
            checks = {
                "16 handoffs, no fallback": (arm["handoffs"],
                                             arm["fallbacks"]) == (16, 0),
                "16 pulls of sum(len // 64) pages": pulls["pulls"] == 16
                and pulls["pulled_pages"] == want_pages
                and pulls["fallbacks"] == 0,
                "a pull's landed bytes equal the donor's":
                    arm["landed_equal"]
                    and arm["landed_pages"] == len(wave[0]) // Pg,
                "16 handoff latencies": len(lat) == 16,
                "no decode step on the prefill replica": steps[0] == 0,
            }
            if cuda:
                checks["K1 22 x the decode replica's steps, K2 never"] = \
                    steps[1] > 0 and k_launch == (n_layers * steps[1], 0)
            if not all(checks.values()):
                raise AssertionError(f"phase 4h (a): {checks}; {arm}")
            # each stream equals its unified twin or parts from it at a
            # near-tie: at the first differing token both tokens sit
            # within LOGIT_SLACK of the top logit, teacher-forced on the
            # split stream's prefix
            parting, whole = [], []
            for i in range(16):
                mine, twin = arm["outs"][i], arms["unified"]["outs"][i]
                if mine == twin:
                    continue
                j = next(k for k, (x, y) in enumerate(zip(mine, twin))
                         if x != y)
                rows = _teacher_forced_logits(dep.model, wave[i], mine,
                                              "fp", device)
                top = rows.max(dim=-1).values
                parting.append(max(float(top[j] - rows[j, mine[j]]),
                                   float(top[j] - rows[j, twin[j]])))
                tok = torch.tensor(mine, device=device)
                whole.append(float((top - rows[torch.arange(len(mine)),
                                               tok]).max()))
            arm.update(parted=len(parting),
                       parting_gaps=[round(x, 4) for x in parting],
                       parting_max_gap=max(parting, default=0.0),
                       parted_stream_max_gap=max(whole, default=0.0))
            if parting and max(parting) > LOGIT_SLACK:
                raise AssertionError(f"phase 4h (a): a split stream parts "
                                     f"from its unified twin {max(parting)}"
                                     f" below the top logit")
        check_pool_quiesced(pool)
        arms[name] = arm
        if name == "unified":
            dep.shutdown()
            del dep, pool, engines
            free()
    res["disagg_ab"] = {k: {kk: vv for kk, vv in v.items() if kk != "outs"}
                        for k, v in arms.items()}
    for name, a in res["disagg_ab"].items():
        print(f"phase 4h (a) {name}: TinyLlama-1.1B bf16 on {smi}, 16 "
              f"requests (512-1024-token prompts, 64 new) 50 ms apart: "
              f"{a['tok_s']:.1f} tok/s, TTFT p50 {a['ttft_p50_s'] * 1e3:.1f}"
              f" ms p99 {a['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{a['tpot_p50_s'] * 1e3:.2f} ms, decode steps "
              f"{a['decode_steps']}, K1 {a['k1_launches']}"
              + (f"; handoffs {a['handoffs']}, handoff p50 "
                 f"{a['handoff_p50_s'] * 1e3:.1f} ms p99 "
                 f"{a['handoff_p99_s'] * 1e3:.1f} ms, pulls "
                 f"{a['pulls']['pulls']} of {a['pulls']['pulled_pages']} "
                 f"pages, {a['pull_host_ms_per_page']:.2f} host ms per page,"
                 f" {a['wire_mb']:.1f} wire MB, landed bytes equal the "
                 f"donor's, {a['parted']} streams part from the unified "
                 f"twin, each at a near-tie (teacher-forced gap at the "
                 f"parting <= {a['parting_max_gap']:.4f}; the parted "
                 f"streams' tokens <= {a['parted_stream_max_gap']:.4f})"
                 if name == "disaggregated" else ""))
    # (b) the decode replica dies while leg 2s are being submitted
    victim = pool.replica(1)
    inj = FaultInjector()
    victim.engine._injector = inj
    state = _hold_then_arm(victim.engine, inj.kill_replica)
    prompts = [rand(n) for n in g.integers(512, 1025, size=8)]
    fb0 = pool.route_stats["disagg_handoff_fallbacks"]
    hs = [pool.submit(p, max_new_tokens=n_new) for p in prompts]
    state["queued"] = True
    outs = [None] * len(hs)

    def consume(i):
        outs[i] = _outcome(hs[i])

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(hs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    del victim.engine.step
    deadline = time.monotonic() + 60
    while pool.replica(1).generation != victim.generation + 1:
        if time.monotonic() > deadline:
            raise AssertionError("phase 4h (b): decode replica not rebuilt")
        time.sleep(0.01)
    for e in pool.engines():
        e.wait_idle(60)
    _wait_transfers(pool)
    check_pool_quiesced(pool)
    check_quiesced(victim.engine)
    fallbacks = pool.route_stats["disagg_handoff_fallbacks"] - fb0
    in_place = [i for i, h in enumerate(hs)
                if outs[i][0] == "ok" and h.replica_idx == 0]
    failed = [i for i, o in enumerate(outs) if o[0] == "err"]
    checks = {
        "the kill fired with leg 2s streaming and pending":
            state["armed"] and bool(inj.log),
        "handoffs fell back": fallbacks >= 1 and bool(in_place),
        "no request lost": all(o is not None for o in outs),
        "only streamed leg 2s failed, typed": all(
            outs[i][1] == "EngineShutdown" and len(hs[i]._generated) > 1
            for i in failed),
        "the rest complete": all(len(o[1]) == n_new for o in outs
                                 if o[0] == "ok"),
        "decode replica rebuilt, generation + 1":
            pool.replica(1).state == "healthy"
            and pool.replica(1).generation == victim.generation + 1,
    }
    gaps = [x for i in in_place
            for x in _gaps(dep.model, prompts[i], outs[i][1], "fp", device)]
    checks["fallback streams teacher-forced"] = bool(gaps) and \
        max(gaps) <= LOGIT_SLACK
    if not all(checks.values()):
        raise AssertionError(f"phase 4h (b): {checks}; outs "
                             f"{[o[:2] if o[0] == 'err' else 'ok' for o in outs]}")
    res["decode_death"] = {"fallbacks": fallbacks,
                           "decoded_in_place": len(in_place),
                           "streamed_failed": len(failed),
                           "teacher_forced_max_gap": max(gaps),
                           "generation_after": pool.replica(1).generation}
    print(f"phase 4h (b): decode replica killed mid-handoff: "
          f"{fallbacks} handoffs fell back, {len(in_place)} decoded in "
          f"place on the prefill replica (teacher-forced max gap "
          f"{max(gaps):.4f}), {len(failed)} streamed failed typed, none "
          f"lost, decode replica rebuilt at generation "
          f"{pool.replica(1).generation}")
    dep.shutdown()
    del dep, pool, victim, hs, engines
    free()
    # (c) the watchdog wedges a hung replica
    g4 = np.random.default_rng(seed)
    g4.integers(0, cfg.vocab_size, 100)
    prompts = [g4.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in g4.integers(16, 1537, size=16)][:8]
    stall = 2.0
    dep = LlamaDeployment(cfg, params, num_engine_replicas=2,
                          engine_stall_deadline_s=stall, **kw)
    pool = dep.engine()
    wd = dep.watchdog()
    flight = tempfile.mkdtemp()
    wd.flight_dir = flight
    for e in pool.engines():
        e.submit(warm, 8).result()
        e.wait_idle(60)
    victim = pool.replica(1)
    inj = FaultInjector()
    victim.engine._injector = inj
    state = _hold_then_arm(victim.engine,
                           lambda: inj.hang("dispatch_decode"))
    hs = [pool.submit(p, max_new_tokens=n_new) for p in prompts]
    first = [h.replica_idx for h in hs]
    state["queued"] = True
    outs = [None] * len(hs)
    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(hs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wedge = [e for e in wd.log if e["event"] == "wedged"]
    held = list(victim.engine._wait) + [
        s.req for s in victim.engine.slots if s is not None]
    committed = [len(r.generated) for r in held]
    inj.release_all()
    del victim.engine.step
    victim.engine._thread.join(timeout=30)
    zombie_ok = (not victim.engine._thread.is_alive()
                 and committed == [len(r.generated) for r in held])
    victim.engine.shutdown()         # the cleanup deferred by the wedge
    check_quiesced(victim.engine)
    deadline = time.monotonic() + 60
    while pool.replica(1).generation != victim.generation + 1:
        if time.monotonic() > deadline:
            raise AssertionError("phase 4h (c): replica 1 not rebuilt")
        time.sleep(0.01)
    for e in pool.engines():
        e.wait_idle(60)
    check_pool_quiesced(pool)
    bundle = (obs.load_flight_bundle(wedge[0]["bundle"])
              if wedge and wedge[0].get("bundle") else {})
    on1 = [i for i, r in enumerate(first) if r == 1]
    failed = [i for i in on1 if outs[i][0] == "err"]
    resub = [i for i in on1 if outs[i][0] == "ok"]
    poll = wd.poll_interval_s
    checks = {
        "the hang fired mid-wave": state["armed"] and bool(inj.log),
        "suspect, then wedged": [(e["event"], e["replica"])
                                 for e in wd.log][:2]
        == [("suspect", 1), ("wedged", 1)],
        "wedged within the deadline + 2 polls": bool(wedge)
        and wedge[0]["heartbeat_age_s"] <= stall + 2 * poll,
        "the bundle names replica 1": bundle.get("reason") == "wedged-r1"
        and bundle.get("extra", {}).get("replica") == 1,
        "streamed ones failed typed": bool(failed) and all(
            outs[i][1] == "EngineShutdown" and hs[i]._generated
            for i in failed),
        "unstreamed ones resubmitted to a survivor and complete":
            bool(resub) and all(
                len(outs[i][1]) == n_new and hs[i].resubmits == 1
                and hs[i].replica_tag != f"1:{victim.generation}"
                for i in resub),
        "replica 0's own complete": all(outs[i][0] == "ok"
                                        for i in range(8) if i not in on1),
        "the zombie committed nothing": zombie_ok,
        "replica 1 rebuilt": pool.replica(1).state == "healthy",
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 4h (c): {checks}; log {wd.log}; outs "
                             f"{[o[:2] if o[0] == 'err' else 'ok' for o in outs]}")
    res["watchdog"] = {"detect_latency_s": wedge[0]["heartbeat_age_s"],
                       "poll_interval_s": poll, "streamed_failed":
                       len(failed), "resubmitted": len(resub),
                       "resubmitted_to": [hs[i].replica_tag for i in resub],
                       "stats": wd.stats()}
    print(f"phase 4h (c): hang at replica 1's decode dispatch, watchdog "
          f"(stall {stall} s, poll {poll} s): suspect -> wedged, detect "
          f"latency (serve_pool_wedge_detect_latency_s) "
          f"{wedge[0]['heartbeat_age_s']:.3f} s, bundle {bundle['reason']},"
          f" {len(failed)} streamed failed typed, {len(resub)} resubmitted "
          f"and complete (on {res['watchdog']['resubmitted_to']}), the "
          f"zombie committed nothing, replica 1 rebuilt")
    dep.shutdown()
    shutil.rmtree(flight, ignore_errors=True)
    del dep, pool, victim, hs, held
    free()
    # (d) the autoscaler: 1 -> 2 under a burst, back to 1 when idle
    dep = LlamaDeployment(
        cfg, params, num_engine_replicas=1, autoscale=True,
        autoscale_max_replicas=2, autoscale_interval_s=0.1,
        autoscale_policy={"cooldown_up_s": 0.0, "cooldown_down_s": 0.0,
                          "idle_stable_s": 2.0}, **kw)
    dep(warm)
    pool = dep.engine()
    scaler = dep.autoscaler()
    builds = []
    _timed(pool, "add_replica", builds)
    pool.replica(0).engine.reset_latency_stats()
    burst = [rand(n) for n in g.integers(512, 1025, size=24)]
    n_ev = pool.events.total
    t_burst = time.monotonic()
    run = _arrivals(dep, burst, n_new, [0.0] * 16 + [0.15] * 8)
    ev = pool.events.snapshot()
    ev = ev[len(ev) - (pool.events.total - n_ev):]
    routes = [e for e in ev if e[obs.ETYPE] == "route"]
    first1 = next((e[obs.T] for e in routes if e[obs.SID] == 1), None)
    by_tid = {e[obs.DATA]["trace_id"]: e[obs.SID] for e in routes}
    deadline = time.monotonic() + 60
    while pool.active_count() != 1:
        if time.monotonic() > deadline:
            raise AssertionError("phase 4h (d): the pool never shrank")
        time.sleep(0.05)
    for e in pool.engines():
        e.wait_idle(60)
    check_pool_quiesced(pool)        # the retired engine's too
    retired = [r.engine for r in pool._replicas if r.state == "retired"]
    st = scaler.stats()
    moves = [(round(t - t_burst, 3), a, tg) for (t, a, tg), prev
             in zip(scaler.timeline, [None] + scaler.timeline[:-1])
             if prev is None or (a, tg) != prev[1:]]
    before = [run["ttft"][i] for i in range(24)
              if by_tid.get(f"r{i}") == 0
              and (first1 is None or run["start"][i] < first1)]
    after = [run["ttft"][i] for i in range(24)
             if first1 is not None and run["start"][i] >= first1]
    checks = {
        "scaled 1 -> 2 -> 1": st["scale_ups"] >= 1
        and st["scale_downs"] >= 1 and st["replicas_added"] >= 1
        and pool.active_count() == 1,
        "the second replica served": first1 is not None and bool(after),
        "no request lost": len(run["outs"]) == 24,
        "the retired engine's pages freed": len(retired) == 1 and all(
            e.alloc.occupancy() == e.prefix_cache.cached_pages
            and not any(e.slots) for e in retired),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 4h (d): {checks}; {st}; {moves}")
    res["autoscale"] = {
        "stats": st, "timeline": moves,
        "burst_to_second_route_s": first1 - t_burst,
        "build_s": builds, "ttft_p50_before_s": float(np.median(before)),
        "ttft_p50_after_s": float(np.median(after)),
        "tok_s": run["tok_s"]}
    a = res["autoscale"]
    print(f"phase 4h (d): autoscale 1..2 on {smi}: decisions "
          f"{st['scale_ups']} up / {st['scale_downs']} down, timeline "
          f"(s, active, target) {moves}; burst -> replica 1's first route "
          f"{a['burst_to_second_route_s']:.3f} s, engine build "
          f"{[round(b, 3) for b in builds]} s; TTFT p50 before "
          f"{a['ttft_p50_before_s'] * 1e3:.1f} ms, after "
          f"{a['ttft_p50_after_s'] * 1e3:.1f} ms; 24 of 24 complete, "
          f"the retired engine's pages freed")
    dep.shutdown()
    del dep, pool, scaler
    free()
    return res


FLEET_READY_S = 180.0              # a cold agent: torch, CUDA, weights, warm-up
FLEET_LEASE_TTL_S = 5.0            # 4j's directory: wide for a busy host
FLEET_MEM_SLACK = 0.5e9            # card memory back within this, reaped
FLEET_POLL_S = 0.02                # the router's poll period per stream
FLEET_PROMOTE_AFTER_S = 3.0        # 4j's standby promotes after this silence
FLEET_HANG_S = 120.0               # 4j (d): no outcome this long after the
                                   # kill is a hang (no latency bound)


class _FleetProcs:
    """Phase 4j's child processes. Each is started with
    ``subprocess.Popen([python, "-m", module, ...])`` from the directory
    holding this script (never forked: this process holds a CUDA
    context, which a forked child cannot use), its stdout and stderr
    into one file under ``tmp`` (a pipe nobody drains blocks the child
    at 64 KB, and the children must never write to this script's
    output); ``ready`` reads ``READY <port>`` from that file. ``reap``
    terminates, waits, then kills every child, whether or not it has
    exited already."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.procs = {}
        self.ready_s = {}        # name -> seconds from its start to READY

    def start(self, name: str, module: str, args) -> None:
        log = os.path.join(self.tmp, f"{name}.log")
        with open(log, "wb") as out:
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m", module, *map(str, args)],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdin=subprocess.DEVNULL, stdout=out,
                stderr=subprocess.STDOUT)
        self.procs[name] = (proc, log, time.monotonic())
        self.ready_s.pop(name, None)

    def ready(self, name: str, timeout_s: float = FLEET_READY_S) -> tuple:
        """(port, seconds from the start to ``READY``)."""
        proc, log, t0 = self.procs[name]
        while True:
            with open(log, "rb") as f:
                m = re.search(rb"^READY (\d+)\s*$", f.read(), re.M)
            if m:
                took = self.ready_s.setdefault(name, time.monotonic() - t0)
                return int(m.group(1)), took
            if proc.poll() is not None:
                raise RuntimeError(f"{name} exited with {proc.returncode} "
                                   f"before READY")
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"{name}: no READY in {timeout_s:.0f} s")
            time.sleep(0.05)

    def kill(self, name: str) -> None:
        """SIGKILL ``name`` and reap it."""
        proc = self.procs[name][0]
        proc.kill()
        proc.wait(timeout=60)

    def alive(self) -> list:
        return [n for n, (p, _, _) in self.procs.items() if p.poll() is None]

    def tails(self, n: int = 30) -> str:
        out = []
        for name, (proc, log, _) in self.procs.items():
            with open(log, "rb") as f:
                lines = f.read().decode(errors="replace").splitlines()
            out.append(f"--- {name} (exit {proc.poll()}), last {n} lines:")
            out.extend(lines[-n:])
        return "\n".join(out)

    def reap(self) -> None:
        for proc, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc, _, _ in self.procs.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)


def _free_port() -> int:
    """A port free now (the kernel's pick for a socket bound to port 0),
    for a process whose peer must know it before it starts."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_directory_pair(procs, tmp: str) -> tuple:
    """Phase 4j's replicated directory: a primary (``--data-dir
    tmp/d1``, replicating to the standby) and its hot standby
    (``--data-dir tmp/d2``, promoting after ``FLEET_PROMOTE_AFTER_S`` of
    the primary's silence), both with ``FLEET_LEASE_TTL_S`` leases. Each
    needs the other's port: the primary's is reserved first, the standby
    starts on port 0 watching it, then the primary binds the reserved
    port and replicates to the standby's ``READY`` port. A lost race for
    the reserved port (the primary exits before ``READY``) restarts both
    once with a fresh reservation. Returns (primary port, standby
    port)."""
    module = "ray_tpu_torch.serve.fleet.directory"
    for attempt in (1, 2):
        port = _free_port()
        procs.start("standby", module,
                    ["--lease-ttl-s", FLEET_LEASE_TTL_S, "--role", "standby",
                     "--peer", f"127.0.0.1:{port}",
                     "--promote-after-s", FLEET_PROMOTE_AFTER_S,
                     "--data-dir", os.path.join(tmp, "d2")])
        sport, _ = procs.ready("standby")
        procs.start("directory", module,
                    ["--lease-ttl-s", FLEET_LEASE_TTL_S, "--port", port,
                     "--data-dir", os.path.join(tmp, "d1"),
                     "--standby", f"127.0.0.1:{sport}"])
        try:
            return procs.ready("directory")[0], sport
        except RuntimeError:
            if attempt == 2:
                raise
            procs.kill("standby")


def _fresh_prompts(vocab: int, seed: int, n: int, length: int) -> list:
    g = np.random.default_rng(seed)
    return [g.integers(0, vocab, length).tolist() for _ in range(n)]


def _fleet_wave(router, prompts, n_new: int) -> dict:
    """``prompts`` through the router at once, each streamed to its end
    on a thread of its own: ``outs[i]`` becomes ``("ok", tokens)`` or
    ``("err", the error)``."""
    hs = [router.submit(p, max_new_tokens=n_new) for p in prompts]
    outs = [None] * len(hs)

    def consume(i):
        try:
            for _tok in hs[i].stream():
                pass
            outs[i] = ("ok", list(hs[i]._generated))
        except Exception as e:  # noqa: BLE001 - the record keeps it
            outs[i] = ("err", e)

    threads = [threading.Thread(target=consume, args=(i,), daemon=True)
               for i in range(len(hs))]
    for t in threads:
        t.start()
    return {"hs": hs, "outs": outs, "threads": threads}


def _join_all(threads, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


def _outcome_line(out):
    """A wave's outcome for a failure message: None (no outcome), the
    count of tokens, or the error."""
    if out is None:
        return None
    return len(out[1]) if out[0] == "ok" else repr(out[1])


def _route_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


class _RouterStreams:
    """``LlamaDeployment.stream``'s surface over a ``FleetRouter``, what
    ``_run_sessions`` drives."""

    def __init__(self, router):
        self.router = router

    def stream(self, payload):
        h = self.router.submit(payload["prompt_ids"],
                               max_new_tokens=payload["max_new_tokens"],
                               session_id=payload.get("session_id"))
        yield from h.stream()


def _agent_client(port: int):
    from ray_tpu_torch.serve.fleet.agent import AgentClient
    from ray_tpu_torch.serve.fleet.transport import SocketTransport
    return AgentClient(SocketTransport(("127.0.0.1", port)), timeout_s=60.0)


def _agent_tokens(port: int, prompt, n_new: int, key: str) -> list:
    """One greedy request straight to the agent on ``port``."""
    c = _agent_client(port)
    rid = c.submit(key, prompt, n_new)["rid"]
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        r = c.poll(rid)
        if r["error"] is not None:
            raise AssertionError(f"phase 4j: the agent on {port}: "
                                 f"{r['error']}")
        if r["done"]:
            return r["tokens"]
        time.sleep(0.01)
    raise AssertionError(f"phase 4j: the agent on {port} never finished")


def _routes(router) -> dict:
    from ray_tpu_torch.serve import obs
    return dict(collections.Counter(
        e[obs.SID] for e in router.events.snapshot()
        if e[obs.ETYPE] == "route"))


def _fleet_kill_wave(router, procs, victim: str, history, wave2,
                     n_new: int) -> dict:
    """Phase 4g (b)'s second wave through the router: 4 requests per
    session of ``n_new`` tokens each, sticky to the session's agent, the
    victim's sessions submitted first. Each request is streamed on a
    thread of its own from its submission on (a wave streamed only after
    its last submit found most of the victim's requests already done on a
    loaded host). The router's client of the victim is watched, and once
    the victim's last request is submitted its process is SIGKILLed
    before the router reads (a) the first poll answer that carries tokens
    of a victim request still being decoded (not done), once just half or
    fewer of the victim's requests have had none delivered, or (b) the
    first tokens of the victim's last request with none delivered, while
    another is being decoded. Every answer with tokens that the router
    had not read at the kill is lost with the victim: its reader polls
    again and meets the dead agent. So the requests being decoded hold
    fewer than ``n_new`` tokens and fail typed, and those with none
    delivered resubmit. With no session pinned to the victim the kill
    waits for the whole wave to be submitted. Request ``i`` carries the
    trace id ``4j-kill-<i>``. Returns the handles and their outcomes."""
    from ray_tpu_torch.serve import obs
    reqs = [(s, history[s] + wave2[s][k]) for k in range(4)
            for s in range(8)]
    pinned = [i for i, (s, _) in enumerate(reqs)
              if router._sticky.get(f"s{s}") == victim]
    order = pinned + [i for i in range(len(reqs)) if i not in pinned]
    hs, outs, threads = [None] * len(reqs), [None] * len(reqs), []
    kill = {"t": None, "armed": False}
    lock = threading.Lock()
    rids, delivered, finished = {}, set(), set()
    poll = None

    def kill_if_due(j, resp) -> bool:
        """Under ``lock``: book ``resp`` for victim request ``j``, kill the
        victim when it is due; True when ``resp`` is to be lost."""
        if kill["t"] is not None:
            return bool(resp["tokens"])
        if not resp["tokens"] or resp.get("error") is not None:
            return False
        first = j not in delivered
        delivered.add(j)
        if resp["done"]:
            finished.add(j)
        zero = len(rids) - len(delivered)
        if not kill["armed"]:
            return False
        if not resp["done"] and 0 < 2 * zero <= len(rids):
            kill["t"] = time.monotonic()
            procs.kill(victim)
            return False
        if first and zero == 0 and delivered - finished - {j}:
            delivered.discard(j)
            kill["t"] = time.monotonic()
            procs.kill(victim)
            return True
        return False

    def watched_poll(rid, cursor=0, trace_id=None, timeout_s=None):
        resp = poll(rid, cursor=cursor, trace_id=trace_id,
                    timeout_s=timeout_s)
        with lock:
            j = rids.get(rid)
            lost = j is not None and kill_if_due(j, resp)
        if lost:
            return poll(rid, cursor=cursor, trace_id=trace_id,
                        timeout_s=timeout_s)
        return resp

    def consume(i):
        try:
            for _tok in hs[i].stream():
                pass
            outs[i] = ("ok", list(hs[i]._generated))
        except Exception as e:  # noqa: BLE001 - the record names the type
            outs[i] = ("err", type(e).__name__, str(e))

    for n, i in enumerate(order):
        if n == len(pinned):
            with lock:
                kill["armed"] = bool(pinned)
        s, p = reqs[i]
        h = hs[i] = router.submit(p, max_new_tokens=n_new,
                                  session_id=f"s{s}",
                                  trace_id=f"4j-kill-{i}")
        if h.replica_idx == victim:
            if poll is None:
                client = router._agent(h._member)
                poll = client.poll
                client.poll = watched_poll
            with lock:
                rids[h._rid] = i
        threads.append(threading.Thread(target=consume, args=(i,)))
        threads[-1].start()
    with lock:
        kill["armed"] = True
    for t in threads:
        t.join(timeout=600)
    mine = sorted(rids.values())
    if not mine or len(mine) == len(hs):
        raise AssertionError(f"phase 4j (b): {len(mine)} of the wave's "
                             f"{len(hs)} requests on {victim}")
    if kill["t"] is None or any(o is None for o in outs):
        raise AssertionError(f"phase 4j (b): the kill never stood mid-wave "
                             f"or a request never ended (kill at "
                             f"{kill['t']}, {sum(o is None for o in outs)} "
                             f"open)")
    dead = [e for e in router.events.snapshot()
            if e[obs.ETYPE] == "member_dead" and e[obs.SID] == victim]
    return {"hs": hs, "outs": outs, "mine": mine,
            "confirm_s": dead[0][obs.T] - kill["t"] if dead else None}


def _timed_collector(router, cluster_dir: str):
    """A ``TelemetryCollector`` on ``router`` (0.25 s scrapes, cluster
    bundles into ``cluster_dir``), attached, whose every member scrape
    (the RPC and the ingest) and every bundle write is timed into
    ``timers["scrape"][member]`` and ``timers["bundle"]``."""
    from ray_tpu_torch.serve.fleet.telemetry import TelemetryCollector
    col = TelemetryCollector(router, interval_s=0.25,
                             cluster_dir=cluster_dir).attach()
    timers = {"scrape": collections.defaultdict(list), "bundle": []}
    scrape, dump = col._scrape_remote, col.dump_cluster_bundle

    def timed_scrape(st, fetch):
        t0 = time.perf_counter()
        out = scrape(st, fetch)
        timers["scrape"][st.name].append(time.perf_counter() - t0)
        return out

    def timed_dump(reason, trigger=None):
        t0 = time.perf_counter()
        out = dump(reason, trigger=trigger)
        timers["bundle"].append((reason, time.perf_counter() - t0))
        return out

    col._scrape_remote = timed_scrape
    col.dump_cluster_bundle = timed_dump
    col.timers = timers
    return col


def _await_bundle(col, prefix: str, timeout_s: float = 30.0):
    """The first cluster bundle of ``col`` whose reason starts with
    ``prefix``, waited for up to ``timeout_s``; None if none came."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = [b for b in list(col.bundles)
               if str(b["reason"]).startswith(prefix)]
        if got or time.monotonic() > deadline:
            return got[0] if got else None
        time.sleep(0.05)


def _collector_report(col, names, victim: str, survivor: str,
                      resub_traces, t_run: float) -> dict:
    """Phase 4j's checks of the telemetry collector (stopped, after one
    last scrape): every member of ``names`` scraped, no event ingested
    twice, the victim's confirmed death and the standby's promotion each
    explained by a cluster bundle that reads back, and a resubmitted
    request of ``resub_traces`` one timeline over the router, the victim
    and the survivor. Returns the checks and, per member, the scrapes'
    ms (p50, max), the clock offset and its RTT/2 bound, events per
    second and the ``dropped`` count, and the bundles' write ms."""
    from ray_tpu_torch.serve.fleet.telemetry import load_cluster_bundle
    members = col.members()
    merged = col.merged_events()
    incarnation = [(e["member"], e["pid"], e["generation"], e["seq"])
                   for e in merged]
    # a directory's promotion changes its incarnation key (role and
    # epoch), so its new cursor starts at 0 and the events it logged
    # as a standby are ingested once more under the new key
    process = collections.Counter((e["member"], e["pid"], e["seq"])
                                  for e in merged)
    dead = _await_bundle(col, f"agent-dead-{victim}", 0.0)
    dead_cb = load_cluster_bundle(dead["path"]) if dead else {}
    promote = _await_bundle(col, "promote-", 0.0)
    promote_cb = load_cluster_bundle(promote["path"]) if promote else {}
    phases = col.request_phases()
    timelines = {}
    for tid in resub_traces:
        spans = phases.get(tid, {}).get("spans", [])
        timelines[tid] = [sp["replica_id"] for sp in spans]
    ordered = [tid for tid, order in timelines.items()
               if order[:3] == ["router", victim, survivor]]
    checks = {
        "the collector scraped every member: " + ", ".join(names):
            all(members.get(n, {}).get("scrapes", 0) >= 1 for n in names),
        "no event ingested twice in one incarnation":
            len(incarnation) == len(set(incarnation)),
        f"the SIGKILL of {victim} wrote a cluster bundle naming its "
        "confirmed death, and it reads back": bool(dead_cb)
            and dead_cb["reason"] == f"agent-dead-{victim}"
            and (dead_cb["trigger"] or {}).get("kind") == "confirmed_death"
            and (dead_cb["trigger"] or {}).get("replica_id") == victim,
        "the standby's scraped promote event wrote a cluster bundle, and "
        "it reads back": bool(promote_cb)
            and (promote_cb["trigger"] or {}).get("kind") == "promote",
        "a resubmitted request reads as one timeline: router, victim, "
        "survivor, in order": bool(ordered),
    }
    per = {}
    for name, m in sorted(members.items()):
        ms = sorted(1e3 * x for x in col.timers["scrape"].get(name, []))
        per[name] = {
            "scrapes": m["scrapes"],
            "scrape_ms_p50": ms[len(ms) // 2] if ms else None,
            "scrape_ms_max": ms[-1] if ms else None,
            "offset_s": m["offset_s"], "uncertainty_s": m["uncertainty_s"],
            "events_per_s": sum(1 for e in merged if e["member"] == name)
            / t_run,
            "dropped": m["dropped"], "incarnations": m["incarnations"]}
    return {"checks": checks, "members": per,
            "reingested_after_promotion": sum(
                n - 1 for n in process.values() if n > 1),
            "bundle_ms": [(r, 1e3 * t) for r, t in col.timers["bundle"]],
            "timeline": {tid: timelines[tid] for tid in ordered[:1]},
            "dead_bundle": dead and dead["path"],
            "promote_bundle": promote and promote["path"]}


def phase_fleet_path(tl, pa, seed: int, smi: str, pool_4g: dict, cfg=None,
                     device: str = "cuda", agent_model: str = "tinyllama",
                     sizes=None) -> dict:
    """Phase 4j: the fleet control plane. (a) the loopback knob in this
    process; (b) a primary and a standby directory process and two agent
    processes under 4g's session trace and its kill wave, through a
    ``FleetRouter`` here; (c) an agent process that a
    ``FleetCapacityProvider`` starts; (d) the primary directory's
    SIGKILL under a wave, the standby's promotion, the killed primary's
    WAL read back; (e) the telemetry collector's view of (b)-(d).
    ``pool_4g`` holds 4g (b)'s figures, printed beside (b)'s (None: 4g
    did not run). On the
    card TinyLlama-1.1B's widths at ``cfg``'s depth (default
    ``EARLIER_POOL_LAYERS``), agents of ``--model tinyllama``;
    ``device="cpu"`` with ``cfg`` llama_tiny fp32, ``agent_model="tiny"``
    and small ``sizes`` rehearses it."""
    import gc

    from ray_tpu_torch.serve import obs
    from ray_tpu_torch.serve.errors import EngineShutdown, RequestError
    from ray_tpu_torch.serve.fleet.agent import model_engine_factory
    from ray_tpu_torch.serve.fleet.directory import (FENCE_EPOCH_STRIDE,
                                                     DirectoryClient)
    from ray_tpu_torch.serve.fleet.provider import FleetCapacityProvider
    from ray_tpu_torch.serve.fleet.replication import (
        FailoverDirectoryClient)
    from ray_tpu_torch.serve.fleet.router import FleetRouter
    from ray_tpu_torch.serve.fleet.transport import SocketTransport
    from ray_tpu_torch.serve.fleet.wal import DirectoryWAL
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = cfg or tl.tinyllama_1_1b(n_layers=EARLIER_POOL_LAYERS)
    cuda = device == "cuda"
    z = dict(system=512, turn=32, n_new=32, kill_new=128, max_slots=16,
             page_size=64, n_pages=513, chunk=8)
    z.update(sizes or {})
    n_new, kill_new = z["n_new"], z["kill_new"]
    knobs = dict(max_slots=z["max_slots"], page_size=z["page_size"],
                 n_pages=z["n_pages"])
    engine_kw = dict(knobs, chunk=z["chunk"], seed=seed, device=device,
                     layers=cfg.n_layers)
    warm, systems, turns, wave2 = _session_traffic(
        cfg.vocab_size, seed, z["system"], z["turn"])
    res = {"card": smi}
    t_phase = time.monotonic()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # (a) the loopback knob in this process
    t0 = time.monotonic()
    params = tl.init_params(cfg, seed=seed, device=device)
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    dep = LlamaDeployment(cfg, params, fleet=2, prefix_cache=True,
                          max_new_tokens=n_new, device=device, **knobs)
    echo = dep({"prompt_ids": warm, "echo_replica": True})
    router = dep.engine()
    agents = list(dep._fleet_agents.values())
    steps0 = sum(a.engine.stats["decode_steps"] for a in agents)
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    turn1 = _run_sessions(dep, systems, turns[:1], n_new)
    k_launch = (pa.paged_decode_attention.launches,
                pa.paged_decode_attention.launches_int8)
    steps = sum(a.engine.stats["decode_steps"] for a in agents) - steps0
    routes = _routes(router)
    replicas = dep.serve_stats()["engine"]["replicas"]
    checks = {
        "both members served": sorted(routes) == ["r0", "r1"],
        "echo_replica names r0 or r1 at generation 0":
            echo["replica"] in ("r0:0", "r1:0")
            and len(echo["ids"]) == len(warm) + n_new,
        "serve_stats: 2 replicas": replicas == 2,
    }
    if cuda:
        checks[f"K1 {cfg.n_layers} x decode steps, K2 never"] = \
            steps > 0 and k_launch == (cfg.n_layers * steps, 0)
    dep.shutdown()
    del dep, router, agents, params
    free()
    if not all(checks.values()):
        raise AssertionError(f"phase 4j (a): {checks}; routes {routes}, "
                             f"launches {k_launch}, steps {steps}")
    res["loopback"] = {"routes": routes, "echo": echo["replica"],
                       "tok_s": turn1["tok_s"],
                       "ttft_p50_s": turn1["ttft_p50_s"],
                       "k1_launches": k_launch[0], "decode_steps": steps,
                       "s": time.monotonic() - t0}
    lb = res["loopback"]
    print(f"phase 4j (a): LlamaDeployment(fleet=2, prefix_cache=True) on "
          f"{smi}, 4g's warm-up and the first turn of its 8 sessions: "
          f"routes {routes}, echo_replica {lb['echo']}, "
          f"{lb['tok_s']:.1f} tok/s, TTFT p50 {lb['ttft_p50_s'] * 1e3:.1f} "
          f"ms; K1 {lb['k1_launches']} = {cfg.n_layers} x {steps} decode "
          f"steps, K2 0; {lb['s']:.1f} s")

    # (b) the reference tokens from an engine of this process, built as
    # the agents build theirs; it stays allocated until the end, so the
    # card's free memory moves only with the children
    ref_eng = model_engine_factory(agent_model, **engine_kw)(0)
    want = ref_eng.submit(warm, max_new_tokens=n_new).result()
    ref_eng.shutdown()
    free()
    mem0 = torch.cuda.mem_get_info()[0] if cuda else None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4j_")
    procs = _FleetProcs(tmp)
    router = provider = col = None
    prov_err = None
    try:
        t0 = time.monotonic()
        engine_args = ["--layers", cfg.n_layers, "--seed", seed,
                       "--max-slots", z["max_slots"],
                       "--page-size", z["page_size"],
                       "--n-pages", z["n_pages"], "--chunk", z["chunk"],
                       "--device", device]
        dport, sport = _start_directory_pair(procs, tmp)
        endpoints = [("127.0.0.1", dport), ("127.0.0.1", sport)]
        names = ("a0", "a1")
        for name in names:
            procs.start(name, "ray_tpu_torch.serve.fleet.agent",
                        ["--replica-id", name, "--model", agent_model,
                         "--directory", f"127.0.0.1:{dport}",
                         "--directory", f"127.0.0.1:{sport}"]
                        + engine_args)
        ports, ready_s = {}, {}
        for name in names:
            ports[name], ready_s[name] = procs.ready(name)
        mem1 = torch.cuda.mem_get_info()[0] if cuda else None
        got = {name: _agent_tokens(ports[name], warm, n_new, f"warm-{name}")
               for name in names}
        t_up = time.monotonic() - t0
        dc = FailoverDirectoryClient(
            [SocketTransport(ep) for ep in endpoints], timeout_s=30.0)
        router = FleetRouter(
            dc, lambda addr: SocketTransport((addr[1], int(addr[2]))),
            seed=seed, call_timeout_s=30.0,
            transport_patience_s=12 * FLEET_LEASE_TTL_S,
            poll_interval_s=FLEET_POLL_S)
        # the telemetry plane over (b)-(d): every member scraped, each
        # fault a cluster bundle
        col = _timed_collector(router, os.path.join(tmp, "cluster")).run()
        t_col = time.monotonic()
        t0 = time.monotonic()
        run = _run_sessions(_RouterStreams(router), systems, turns, n_new)
        t_trace = time.monotonic() - t0
        trace_routes = _routes(router)
        hits = sum(1 for e in router.events.snapshot()
                   if e[obs.ETYPE] == "route" and e[obs.DATA]["pages"] > 0)
        victim = "a1" if trace_routes.get("a1") else "a0"
        survivor = "a0" if victim == "a1" else "a1"
        t0 = time.monotonic()
        kill = _fleet_kill_wave(router, procs, victim, run["history"],
                                wave2, kill_new)
        t_kill = time.monotonic() - t0
        outs, hs, mine = kill["outs"], kill["hs"], set(kill["mine"])
        resub = [i for i in mine if outs[i][0] == "ok"
                 and hs[i].resubmits == 1]
        failed = [i for i in mine if outs[i][0] == "err"]
        survivor_counters = _agent_client(ports[survivor]).stats()[
            "counters"]
        dstats = dc.stats()
        members = {m["replica_id"] for m in dc.snapshot()["members"]}
        routes = _routes(router)
        checks = {
            "the agents ran on the card: free memory fell by their "
            "weights": not cuda or mem0 - mem1 >= 2 * weight_bytes,
            "each agent's warm-up tokens equal this process's engine's":
                all(got[n] == want for n in names),
            "every trace request completed with its tokens":
                run["tokens"] == 3 * 8 * n_new,
            "the kill landed mid-wave: part of the victim's wave had "
            "delivered tokens and failed, part had none and resubmitted":
                bool(resub) and bool(failed),
            "zero-delivery requests resubmitted once, complete on the "
            "survivor": all(
                hs[i].replica_idx == survivor
                and len(outs[i][1]) == kill_new for i in resub),
            "partly delivered requests failed typed EngineShutdown": all(
                outs[i][1] == EngineShutdown.__name__
                and 0 < len(hs[i]._generated) < kill_new for i in failed),
            "the victim's other requests completed before the kill": all(
                outs[i][0] == "ok" and hs[i].resubmits == 0
                and len(outs[i][1]) == kill_new
                for i in mine - set(resub) - set(failed)),
            "the survivor's requests completed": all(
                outs[i][0] == "ok" and len(outs[i][1]) == kill_new
                and hs[i].resubmits == 0
                for i in range(len(hs)) if i not in mine),
            "none served twice: the survivor admitted each route once":
                survivor_counters["submits"] == routes.get(survivor, 0) + 1,
            "the directory confirmed the death":
                dstats["counters"]["confirmed_dead"] == 1
                and victim not in members and survivor in members
                and kill["confirm_s"] is not None,
        }
        if not all(checks.values()):
            raise AssertionError(
                f"phase 4j (b): {checks}; outs "
                f"{[o[:2] if o[0] == 'err' else 'ok' for o in outs]}, "
                f"routes {routes}, survivor {survivor_counters}, "
                f"directory {dstats['counters']}")

        # (c) capacity from the provider: an agent process that the
        # autoscaler's provider starts joins the survivor
        mem_c0 = torch.cuda.mem_get_info()[0] if cuda else None
        provider = FleetCapacityProvider(
            endpoints, model=agent_model, spawn_timeout_s=FLEET_READY_S,
            extra_args=engine_args)
        t0 = time.monotonic()
        ticket = provider.request()
        prov_err = provider.stderr_path(ticket)
        eta_before = provider.eta_s(ticket)
        while not provider.ready(ticket):   # raises if it died before READY
            if time.monotonic() - t0 > FLEET_READY_S:
                raise TimeoutError(f"phase 4j (c): {ticket} not READY in "
                                   f"{FLEET_READY_S:.0f} s")
            time.sleep(0.05)
        ready_c = time.monotonic() - t0
        eta_after = provider.eta_s(ticket)
        mem_c1 = torch.cuda.mem_get_info()[0] if cuda else None
        got_c = _agent_tokens(provider.agent_port(ticket), warm, n_new,
                              f"warm-{ticket}")
        idx = router.add_replica_for_ticket(ticket)
        live = (survivor, ticket)
        clients = {n: _agent_client(ports[survivor] if n == survivor
                                    else provider.agent_port(ticket))
                   for n in live}
        vocab = cfg.vocab_size
        t0 = time.monotonic()
        routes0 = _routes(router)
        wave_c = _fleet_wave(router, _fresh_prompts(
            vocab, seed + 13, 8, z["system"] + z["turn"]), n_new)
        _join_all(wave_c["threads"], 600)
        t_wave_c = time.monotonic() - t0
        routes_c = _route_delta(routes0, _routes(router))
        checks = {
            "the spawned agent served a request of the wave":
                routes_c.get(ticket, 0) >= 1,
            "its warm-up tokens equal this process's engine's": got_c == want,
            "it ran on the card: free memory fell by its weights":
                not cuda or mem_c0 - mem_c1 >= weight_bytes,
            "every request of the wave completed with its tokens": all(
                o is not None and o[0] == "ok" and len(o[1]) == n_new
                for o in wave_c["outs"]),
        }
        if not all(checks.values()):
            raise AssertionError(
                f"phase 4j (c): {checks}; routes {routes_c}, outs "
                f"{[_outcome_line(o) for o in wave_c['outs']]}")
        res_c = {"ready_s": ready_c, "eta_before_s": eta_before,
                 "eta_after_s": eta_after, "eta_ewma_s": provider._eta_ewma,
                 "routes": routes_c, "wave_s": t_wave_c,
                 "mem_agent_gb": (mem_c0 - mem_c1) / 1e9 if cuda else None}

        # (d) the primary directory's death under load
        pc = DirectoryClient(SocketTransport(endpoints[0]), timeout_s=30.0)
        sc = DirectoryClient(SocketTransport(endpoints[1]), timeout_s=30.0)
        acked = {m["replica_id"]: (m["generation"], m["fence"])
                 for m in pc.snapshot()["members"]}
        role0 = pc.role()
        fence0 = pc.stats()["fence_counter"]
        submits0 = {n: c.stats()["counters"]["submits"]
                    for n, c in clients.items()}
        routes0 = _routes(router)
        wave_d = _fleet_wave(router, _fresh_prompts(
            vocab, seed + 17, 8, z["system"] + z["turn"]), kill_new)
        deadline = time.monotonic() + 300
        while not any(h._generated for h in wave_d["hs"]):
            if time.monotonic() > deadline:
                raise AssertionError("phase 4j (d): no token in 300 s")
            time.sleep(0.005)
        t_dkill = time.monotonic()
        procs.kill("directory")
        promoted_s = None
        while time.monotonic() - t_dkill < FLEET_HANG_S:
            try:
                if sc.role()["role"] == "primary":
                    promoted_s = time.monotonic() - t_dkill
                    break
            except Exception:   # noqa: BLE001 - not yet answering
                pass
            time.sleep(0.05)
        # each agent's next renewal with the new primary: the first of
        # its snapshots that carries a load report (replication carries
        # none, a renewal repaints it)
        renewed = {}
        while (promoted_s is not None and len(renewed) < len(live)
               and time.monotonic() - t_dkill < FLEET_HANG_S):
            for m in sc.snapshot()["members"]:
                if m["load"] and m["replica_id"] not in renewed:
                    renewed[m["replica_id"]] = time.monotonic() - t_dkill
            time.sleep(0.05)
        _join_all(wave_d["threads"],
                  t_dkill + FLEET_HANG_S - time.monotonic())
        t_wave_d = time.monotonic() - t_dkill
        canary, tries = None, 0
        while promoted_s is not None and canary is None:
            tries += 1
            try:
                canary = router.submit(warm, max_new_tokens=n_new).result()
            except RequestError:
                # right after the promotion an agent may still be
                # fenced, its lease lapsed while no primary answered
                if time.monotonic() - t_dkill > FLEET_HANG_S:
                    raise
                time.sleep(0.5)
        submits1 = {n: c.stats()["counters"]["submits"]
                    for n, c in clients.items()}
        routes_d = _route_delta(routes0, _routes(router))
        role1 = sc.role()
        events = sc.events()["events"]
        promote_at = next((i for i, e in enumerate(events)
                           if e["kind"] == "promote"), len(events))
        fences_after = [e["fence"] for e in events[promote_at:]
                        if e["kind"] == "fence_issued"]
        snap1 = sc.snapshot()
        members1 = {m["replica_id"]: (m["generation"], m["fence"])
                    for m in snap1["members"]}
        wal_snap, wal_recs = DirectoryWAL(os.path.join(tmp, "d1")).load()
        rows = list((wal_snap or {}).get("members", ())) + [
            r for r in wal_recs if r.get("op") == "member"]
        in_wal = {(r["replica_id"], r["generation"], r["fence"])
                  for r in rows}
        wal_fence = max([int((wal_snap or {}).get("fence_counter", 0))]
                        + [r["fence"] for r in rows]
                        + [r["fence_counter"] for r in wal_recs
                           if r.get("op") == "promote"])
        outs_d = wave_d["outs"]
        done = [o for o in outs_d if o is not None and o[0] == "ok"]
        typed = [o for o in outs_d if o is not None and o[0] == "err"
                 and isinstance(o[1], RequestError)]
        fences_held = [h._member.fence for h in wave_d["hs"]]
        checks = {
            "the standby became primary, its epoch raised by 1":
                promoted_s is not None and role1["role"] == "primary"
                and role1["epoch"] == role0["epoch"] + 1,
            "every fence issued after the promotion exceeds the primary's "
            "last counter": all(f > fence0 for f in fences_after)
                and snap1["fence_counter"] >= fence0 + FENCE_EPOCH_STRIDE,
            f"every request of the wave ended within {FLEET_HANG_S:.0f} s "
            "of the kill": all(o is not None for o in outs_d),
            "each completed its tokens or failed typed":
                len(done) + len(typed) == len(outs_d)
                and all(len(o[1]) == kill_new for o in done),
            "none served twice: each live agent admitted each route once":
                all(submits1[n] - submits0[n] == routes_d.get(n, 0)
                    for n in live),
            "a canary through the promoted directory gives the reference "
            "tokens": canary == want,
            "both live agents are members of the promoted directory":
                set(live) <= set(members1),
            "the killed primary's WAL holds every live registration it "
            "acknowledged and its fence counter": all(
                (rid, *acked.get(rid, (None, None))) in in_wal
                for rid in live)
                and wal_fence >= fence0,
        }
        if not all(checks.values()):
            raise AssertionError(
                f"phase 4j (d): {checks}; promoted in {promoted_s}, role "
                f"{role1}, fence {fence0} -> {snap1['fence_counter']}, "
                f"fences after {fences_after}, held {fences_held}, outs "
                f"{[_outcome_line(o) for o in outs_d]}, "
                f"submits {submits0} -> {submits1}, routes {routes_d}, "
                f"members {members1}, acked {acked}, WAL {sorted(in_wal)} "
                f"fence {wal_fence}")
        agents_d = {n: c.stats()["counters"] for n, c in clients.items()}
        # (e) the telemetry collector's view of (b)-(d)
        _await_bundle(col, "promote-", FLEET_HANG_S)
        col.stop()
        col.scrape_once()
        tel = _collector_report(
            col, ["router", "directory-0", "directory-1", *names, ticket],
            victim, survivor, [f"4j-kill-{i}" for i in resub],
            time.monotonic() - t_col)
        if not all(tel["checks"].values()):
            raise AssertionError(
                f"phase 4j (e): {tel['checks']}; members "
                f"{sorted(col.members())}, bundles "
                f"{[b['reason'] for b in col.bundles]}, timelines of the "
                f"resubmitted {tel['timeline']}")
        res_d = {"promoted_s": promoted_s, "renewed_s": renewed,
                 "wave_s": t_wave_d, "completed": len(done),
                 "failed_typed": len(typed),
                 "resubmitted": sum(h.resubmits for h in wave_d["hs"]),
                 "self_fences": {n: a["self_fences"]
                                 for n, a in agents_d.items()},
                 "canary_tries": tries, "fence_before": fence0,
                 "fence_after": snap1["fence_counter"],
                 "router_failover": dict(dc.counters),
                 "stale_snapshots": router.counters["stale_snapshots"]}
        retired = router.scale_down(1, rids=[ticket])
        provider.release(ticket)
        if retired != [idx] or provider.live_count():
            raise AssertionError(f"phase 4j (d): scale_down retired "
                                 f"{retired}, {provider.live_count()} "
                                 f"provider agents left")
    except BaseException:
        print(f"phase 4j: the children's output:\n{procs.tails()}",
              file=sys.stderr)
        if prov_err is not None and os.path.exists(prov_err):
            with open(prov_err, "rb") as f:
                tail = f.read().decode(errors="replace").splitlines()[-30:]
            print("--- the provider's agent, stderr:\n" + "\n".join(tail),
                  file=sys.stderr)
        raise
    finally:
        if col is not None:
            col.stop()
        if router is not None:
            router.shutdown()
        if provider is not None:
            provider.stop_all()
        procs.reap()
        shutil.rmtree(tmp, ignore_errors=True)
    left = procs.alive()
    mem2 = None
    if cuda:
        deadline = time.monotonic() + 60
        while True:
            free()
            mem2 = torch.cuda.mem_get_info()[0]
            if mem2 >= mem0 - FLEET_MEM_SLACK or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    if left or (cuda and mem2 < mem0 - FLEET_MEM_SLACK):
        raise AssertionError(f"phase 4j (b)-(d): children alive {left}; free "
                             f"card memory {mem0} before the spawn, {mem2} "
                             f"after the reaping")
    del ref_eng
    free()
    res["processes"] = {
        "ready_s": ready_s, "up_s": t_up, "tok_s": run["tok_s"],
        "ttft_p50_s": run["ttft_p50_s"], "trace_s": t_trace,
        "routes": trace_routes, "affinity_hits": hits,
        "kill_wave_s": t_kill, "victim": victim, "on_victim": len(mine),
        "resubmitted": len(resub), "streamed_failed": len(failed),
        "done_before_kill": len(mine) - len(resub) - len(failed),
        "requeues": router.counters["requeues"],
        "confirm_dead_s": kill["confirm_s"],
        "mem_agents_gb": (mem0 - mem1) / 1e9 if cuda else None,
        "mem_returned_gb": (mem2 - mem0) / 1e9 if cuda else None,
        "weight_bytes": weight_bytes, "pool_4g": pool_4g}
    res["provider"] = res_c
    res["failover"] = res_d
    res["telemetry"] = tel
    res["directory_ready_s"] = {"standby": procs.ready_s["standby"],
                                "primary": procs.ready_s["directory"]}
    res["s"] = time.monotonic() - t_phase
    p = res["processes"]
    mem = (f"; card memory: the agents took {p['mem_agents_gb']:.2f} GB "
           f"(weights 2 x {weight_bytes / 1e9:.2f}), "
           f"{p['mem_returned_gb']:+.2f} GB after the reaping"
           if cuda else "")
    beside = ("4g (b) not run" if pool_4g is None else
              f"4g (b)'s in-process pool {pool_4g['tok_s']:.1f} tok/s, "
              f"{pool_4g['ttft_p50_s'] * 1e3:.1f} ms / one engine "
              f"{pool_4g['one_engine_tok_s']:.1f} tok/s, "
              f"{pool_4g['one_engine_ttft_p50_s'] * 1e3:.1f} ms")
    print(f"phase 4j (b): a primary and a standby directory process and 2 "
          f"agent processes on {smi}, READY in "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in ready_s.items())}; "
          f"8 sessions x 3 turns through a FleetRouter (poll "
          f"{FLEET_POLL_S * 1e3:.0f} ms): {p['tok_s']:.1f} tok/s, TTFT p50 "
          f"{p['ttft_p50_s'] * 1e3:.1f} ms / {beside}; routes {p['routes']}, "
          f"affinity hits {hits}; SIGKILL of {victim} mid-wave "
          f"({kill_new} new tokens a request): "
          f"{p['streamed_failed']} streamed failed typed, "
          f"{p['done_before_kill']} done before it, "
          f"{p['resubmitted']} resubmitted and complete of "
          f"{p['on_victim']} there ({p['requeues']} resubmissions), the "
          f"death confirmed {p['confirm_dead_s']:.2f} s after the kill"
          f"{mem}; up {t_up:.1f} s, trace {t_trace:.1f} s, kill wave "
          f"{t_kill:.1f} s")
    c = res["provider"]
    print(f"phase 4j (c): FleetCapacityProvider started {ticket} READY in "
          f"{c['ready_s']:.1f} s (eta_s {c['eta_before_s']:.2f} s at the "
          f"request, {c['eta_after_s']:.2f} s once ready, its estimate now "
          f"{c['eta_ewma_s']:.2f} s)"
          + (f", {c['mem_agent_gb']:.2f} GB of card memory" if cuda else "")
          + f"; 8 fresh requests x {n_new} tokens routed {c['routes']} in "
          f"{c['wave_s']:.1f} s")
    d = res["failover"]
    renewed = {k: round(v, 2) for k, v in d["renewed_s"].items()}
    print(f"phase 4j (d): SIGKILL of the primary directory under 8 x "
          f"{kill_new} tokens: the standby promoted {d['promoted_s']:.2f} s "
          f"after the kill, fence counter {d['fence_before']} -> "
          f"{d['fence_after']}; the agents next renewed with it at "
          f"{renewed} s; self-fences "
          f"{d['self_fences']}; {d['completed']} completed, "
          f"{d['failed_typed']} failed typed, {d['resubmitted']} "
          f"resubmitted; the wave ended {d['wave_s']:.1f} s after the "
          f"kill; canary in {d['canary_tries']} tries; the router's "
          f"FailoverDirectoryClient {d['router_failover']}, "
          f"{d['stale_snapshots']} stale snapshots served; phase "
          f"{res['s']:.1f} s")
    rd = res["directory_ready_s"]
    print(f"phase 4j: the directory processes (no torch) printed READY "
          f"{rd['standby']:.2f} s (standby) and {rd['primary']:.2f} s "
          f"(primary) after their start")
    for name, m in tel["members"].items():
        p50, top = m["scrape_ms_p50"], m["scrape_ms_max"]
        print(f"phase 4j (e): telemetry of {name}: {m['scrapes']} scrapes, "
              + (f"{p50:.2f} ms p50 / {top:.2f} ms max, " if p50 is not None
                 else "")
              + f"clock offset {m['offset_s']} s +- {m['uncertainty_s']} s "
              f"(RTT/2), {m['events_per_s']:.1f} events/s, dropped "
              f"{m['dropped']}, {m['incarnations']} incarnations")
    print(f"phase 4j (e): cluster bundles written in "
          f"{', '.join(f'{r} {ms:.1f} ms' for r, ms in tel['bundle_ms'])}; "
          f"the resubmitted request {tel['timeline']}; "
          f"{tel['reingested_after_promotion']} events of the promoted "
          f"standby ingested again under its new incarnation")
    return res


FLEET_CHAOS_LEASE_TTL_S = 2.0      # 4k: partition 5 s, promotion after 6 s
FLEET_CHAOS_DURATION_S = 20.0      # 4k: the six faults land in 2-16 s


def phase_fleet_chaos(seed: int, smi: str, device: str = "cuda",
                      model: str = "tinyllama") -> dict:
    """Phase 4k: the seeded fleet campaign
    (``tools/torch_chaos_serve.run_fleet_chaos``) against two agent
    processes of ``model`` (on the card TinyLlama-1.1B's widths at
    ``EARLIER_POOL_LAYERS`` layers, bf16, each running K1) behind a
    primary and a standby directory process: all six kinds of
    ``serve/chaos.make_fleet_schedule`` fire and every gate of the tool
    holds (it raises otherwise). Checks here that the agents took card
    memory for their weights and that each live agent's engine ran
    decode steps; prints each fault's seconds from injection to
    recovery, the attainment and the request counts. ``device="cpu"``
    with ``model="tiny"`` rehearses it."""
    from tools.torch_chaos_serve import run_fleet_chaos
    agents, layers = 2, EARLIER_POOL_LAYERS
    lease_ttl_s, duration_s = FLEET_CHAOS_LEASE_TTL_S, FLEET_CHAOS_DURATION_S
    t0 = time.monotonic()
    flight = tempfile.mkdtemp(prefix="chip_smoke_4k_")
    try:
        art = run_fleet_chaos(
            seed=seed, agents=agents, duration_s=duration_s, clients=3,
            lease_ttl_s=lease_ttl_s, model=model, layers=layers,
            device=device, poll_interval_s=FLEET_POLL_S, flight_dir=flight)
    finally:
        shutil.rmtree(flight, ignore_errors=True)
    req, rec = art["requests"], art["recovery"]
    steps = {rid: (a["engine"] or {}).get("decode_steps", 0)
             for rid, a in art["fleet"]["agents"].items()}
    mem = art["card_memory"]
    checks = {
        "every live agent's engine ran decode steps":
            len(steps) == agents and all(n > 0 for n in steps.values()),
        "no request lost or mismatched":
            req["lost"] == 0 and req["mismatched"] == 0,
    }
    if mem is not None:
        checks["the agents ran on the card: free memory fell by their "
               "weights"] = (mem["free_before_agents"]
                             - mem["free_after_boot"]
                             >= agents * mem["weight_bytes"])
    if not all(checks.values()):
        raise AssertionError(f"phase 4k: {checks}; decode steps {steps}, "
                             f"memory {mem}")
    res = {"card": smi, "injected": art["injected"], "requests": req,
           "attainment": art["attainment"], "recovery": rec,
           "near_ties": art["near_ties"], "decode_steps": steps,
           "card_memory": mem, "topology": art["topology"],
           "schedule": art["schedule"], "wall_s": art["wall_s"],
           "cluster_bundles": art["cluster_flight_recorder"]["reasons"],
           "collector": art["cluster_flight_recorder"]["collector"],
           "s": time.monotonic() - t0}
    topo = art["topology"]
    print(f"phase 4k: the seeded fleet campaign (seed {seed}, "
          f"{duration_s:.0f} s schedule, lease {lease_ttl_s} s, promotion "
          f"after {topo['promote_after_s']} s) on {smi}: {agents} agent "
          f"processes of {model}"
          + (f" ({layers} layers)" if model == "tinyllama" else "")
          + f", injected {art['injected']}")
    print(f"phase 4k: seconds from injection to recovery: SIGKILL -> "
          f"confirmed dead {rec['kill_agent_confirmed_dead_s']}; partition "
          f"-> self-fence {rec['partition_self_fence_s']}; directory "
          f"restart -> READY {rec['directory_restart_ready_s']}; torn WAL "
          f"-> READY {rec['torn_wal_restart_ready_s']}; primary kill -> "
          f"promoted {rec['primary_kill_promoted_s']} (canary served "
          f"{rec['post_failover_canary_s']}); churn -> READY "
          f"{rec['churn_ready_s']}, retired in {rec['churn_retire_s']}; "
          f"directories READY {rec['directory_ready_s']}; agents booted "
          f"in {rec['agents_boot_s']}")
    print(f"phase 4k: attainment {art['attainment']}; {req['completed']} "
          f"completed ({req['resubmitted_ok']} through a resubmission), "
          f"{req['failed_typed']} failed typed, {req['shed']} shed, "
          f"{req['near_tie']} near-tie partings "
          f"{[round(n['gap'], 4) for n in art['near_ties']]}, "
          f"{req['mismatched']} mismatched, {req['lost']} lost; decode "
          f"steps {steps}"
          + (f"; the agents took "
             f"{(mem['free_before_agents'] - mem['free_after_boot']) / 1e9:.2f}"
             f" GB of card memory (weights {agents} x "
             f"{mem['weight_bytes'] / 1e9:.2f} GB)" if mem else "")
          + f"; campaign {art['wall_s']} s, phase {res['s']:.1f} s")
    return res


class _ModuleTimers:
    """Shadow functions of modules (``{module: names}``) with wrappers
    that add each call's host seconds to ``self.s[name]``; ``take()``
    returns and zeroes them, ``restore()`` puts the functions back."""

    def __init__(self, funcs: dict):
        self.orig = [(mod, n, getattr(mod, n))
                     for mod, names in funcs.items() for n in names]
        self.s = {n: 0.0 for _m, n, _f in self.orig}
        for mod, n, fn in self.orig:
            setattr(mod, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s[name] += time.perf_counter() - t
        return wrapped

    def take(self) -> dict:
        out, self.s = self.s, dict.fromkeys(self.s, 0.0)
        return out

    def restore(self) -> None:
        for mod, n, fn in self.orig:
            setattr(mod, n, fn)


def _publish_timed(wr, ck, timers, params, path, name: str) -> dict:
    """``publish_weights`` of ``params`` (release tag ``name``) with its
    host seconds by part: the staging write (``meta.pkl`` and the tensor
    file), hash + fsync of every file, the manifest, the rename, and the
    payload id's hash."""
    timers.take()
    t = time.perf_counter()
    out, wid = wr.publish_weights(params, path, step=1,
                                  extra={"release": name})
    total = time.perf_counter() - t
    s = timers.take()
    hashing = s["_sha256"] + s["_fsync_file"]
    part = {"staging_write_s": s["_write_payload"],
            "hash_fsync_s": hashing,
            "manifest_s": s["write_manifest"] - hashing,
            "rename_s": s["_commit_dir"],
            "weights_id_s": s["weights_id_from_payload"],
            "total_s": total,
            "bytes": sum(r["bytes"] for r in
                         ck.load_manifest(out)["files"].values())}
    return {"path": out, "weights_id": wid, **part}


def _probe_margins(model, prompt, toks, device) -> float:
    """The smallest lead of the expected token over the runner-up along
    ``toks``, teacher-forced (``_teacher_forced_logits``) — or 0 when a
    teacher-forced top-1 is not the expected token."""
    rows = _teacher_forced_logits(model, prompt, toks, "fp", device)
    top = rows.topk(2, dim=-1)
    want = torch.tensor(toks, device=rows.device)
    if not bool((top.indices[:, 0] == want).all()):
        return 0.0
    return float((top.values[:, 0] - top.values[:, 1]).min())


def _pick_probes(lone, model, vocab: int, g, device, n_probe: int = 4,
                 n_tok: int = 8, min_margin: float = 0.5) -> dict:
    """``n_probe`` parity probes for the rollout controller: (prompt,
    the ``n_tok`` tokens the lone engine serving the payload gives it),
    taken from seeded candidates — one token repeated 32 to 128 times:
    a random model's logits lead by ~0.13 at the median there, by ~0.03
    after random ids (TinyLlama-1.1B, H100) — whose every expected token
    leads the runner-up by ``min_margin`` teacher-forced, so that a
    loaded canary's batch cannot flip one at a near-tie. Up to 8 rounds
    of 32 candidates."""
    chosen, margins = [], []
    for _ in range(8):
        cands = [[int(g.integers(0, vocab))] * int(g.integers(32, 129))
                 for _j in range(32)]
        hs = [lone.submit(p, n_tok) for p in cands]
        for p, h in zip(cands, hs):
            toks = h.result()
            margins.append(_probe_margins(model, p, toks, device))
            if margins[-1] >= min_margin and len(chosen) < n_probe:
                chosen.append((p, toks, margins[-1]))
        if len(chosen) == n_probe:
            break
    if len(chosen) < n_probe:
        raise AssertionError(
            f"phase 4i: {len(chosen)} of {len(margins)} candidate probes "
            f"lead by >= {min_margin} at every token; the best "
            f"{sorted(margins)[-8:]}")
    return {"probes": [(p, t) for p, t, _m in chosen],
            "margins": [m for _p, _t, m in chosen],
            "candidates": len(margins),
            "passing": sum(m >= min_margin for m in margins),
            "median_margin": float(np.median(margins))}


def _near_tie_parting(model, prompt, mine, twin, kv_dtype: str,
                      device) -> tuple:
    """Where ``mine`` parts from ``twin``: (index or None, the larger
    teacher-forced gap to the top logit of the two tokens there)."""
    if mine == twin:
        return None, 0.0
    j = next((k for k, (x, y) in enumerate(zip(mine, twin)) if x != y),
             min(len(mine), len(twin)))
    if j >= min(len(mine), len(twin)):
        return j, float("inf")
    row = _teacher_forced_logits(model, prompt, mine[:j + 1], kv_dtype,
                                 device)[-1]
    return j, max(float(row.max() - row[mine[j]]),
                  float(row.max() - row[twin[j]]))


def _replica_swap_timers(pool) -> dict:
    """Per replica: its engine's staging and flip calls, timed."""
    logs = {}
    for i, eng in enumerate(pool.engines()):
        logs[i] = {"stage": [], "flip": []}
        _timed(eng, "_stage_weights", logs[i]["stage"])
        _timed(eng, "_apply_swap_locked", logs[i]["flip"])
    return logs


def _rounded(per_replica: dict, nd: int) -> dict:
    return {i: [round(x, nd) for x in v] for i, v in per_replica.items()}


def _rollout_thread(ctl, kw: dict) -> tuple:
    """``ctl.rollout(**kw)`` on its own thread: (thread, its record)."""
    rec = {}

    def run():
        rec["t0"] = time.monotonic()
        try:
            rec["report"] = ctl.rollout(**kw)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            rec["error"] = e
        rec["t1"] = time.monotonic()

    t = threading.Thread(target=run, name="rollout")
    return t, rec


def _first_layers(sd, n: int) -> dict:
    """The state dict of a Llama cut to its first ``n`` layers."""
    return {k: v for k, v in sd.items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}


def phase_rollout_batch_path(tl, pa, seed: int, smi: str, cfg=None,
                             device: str = "cuda",
                             probe_margin: float = 0.5) -> dict:
    """Phase 4i: durable weight payloads, the staged rollout over a pool
    and the batch tier, at full width (TinyLlama-1.1B bf16 unless
    ``cfg``; ``device="cpu"`` with a small fp32 ``cfg`` and
    ``probe_margin=0`` rehearses it without a card: a narrow model's
    logits rarely lead by 0.5, and fp32 on the CPU has no near-ties to
    guard against). (a) publishes and loads payloads of ``cfg``'s
    depth; (b)-(d) serve their first ``EARLIER_POOL_LAYERS`` layers
    (all of a model no deeper)."""
    from ray_tpu_torch.air import checkpoint as ck
    from ray_tpu_torch.serve import batch_tier as bt
    from ray_tpu_torch.serve import engine as seng
    from ray_tpu_torch.serve import obs
    from ray_tpu_torch.serve import weight_rollout as wr
    from ray_tpu_torch.serve.faults import check_pool_quiesced, check_quiesced
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = cfg or tl.tinyllama_1_1b()
    cuda = device == "cuda"
    n_new, Pg = 64, 64
    knobs = dict(max_slots=16, page_size=Pg, n_pages=513, device=device)
    g = np.random.default_rng(seed + 19)
    root = tempfile.mkdtemp(prefix="chip_smoke_4i_")
    free_bytes = shutil.disk_usage(root).free
    print(f"phase 4i: {free_bytes / 1e9:.1f} GB free under {root}")
    res = {"card": smi, "tmp_free_bytes": free_bytes}

    def free():
        if cuda:
            torch.cuda.empty_cache()

    def rand(n):
        return g.integers(0, cfg.vocab_size, int(n)).tolist()

    def rollbacks():
        return sum(v for _k, v in
                   seng._metrics()["weight_rollbacks"]._samples())

    # (a) publish A and B, load B, republish A, a torn third copy
    params_a = tl.init_params(cfg, seed=seed, device=device)
    params_b = tl.init_params(cfg, seed=seed + 1, device=device)
    timers = _ModuleTimers({
        ck: ("_write_payload", "_sha256", "_fsync_file", "write_manifest",
             "_commit_dir"),
        wr: ("weights_id_from_payload",)})
    try:
        pub = {name: _publish_timed(wr, ck, timers, p,
                                    os.path.join(root, name), name)
               for name, p in (("A", params_a), ("B", params_b))}
        t = time.perf_counter()
        loaded_b, wid_b = wr.load_weights(pub["B"]["path"])
        load_s = time.perf_counter() - t
        load_parts = timers.take()
        again = _publish_timed(wr, ck, timers, params_a,
                               os.path.join(root, "A2"), "A")
    finally:
        timers.restore()
    wid_a = pub["A"]["weights_id"]
    same_b = all(torch.equal(loaded_b[k].to(device), v)
                 for k, v in params_b.items())
    checks = {"the loaded payload is B's id": wid_b == pub["B"]["weights_id"],
              "the loaded tensors equal B's": same_b
              and list(loaded_b) == list(params_b),
              "A and B differ": wid_a != wid_b,
              "A republished keeps its id": again["weights_id"] == wid_a}
    if not all(checks.values()):
        raise AssertionError(f"phase 4i (a): {checks}")
    res["publish"] = {k: {kk: vv for kk, vv in v.items() if kk != "path"}
                      for k, v in {**pub, "A_again": again}.items()}
    res["load"] = {"total_s": load_s,
                   "deep_verify_s": load_parts["_sha256"],
                   "weights_id_s": load_parts["weights_id_from_payload"]}
    for name, p in res["publish"].items():
        print(f"phase 4i (a): publish {name} ({p['bytes']} bytes, id "
              f"{p['weights_id']}): staging write {p['staging_write_s']:.3f}"
              f" s, hash + fsync {p['hash_fsync_s']:.3f} s, manifest "
              f"{p['manifest_s']:.4f} s, rename {p['rename_s']:.4f} s, "
              f"payload id {p['weights_id_s']:.3f} s, total "
              f"{p['total_s']:.3f} s")
    print(f"phase 4i (a): load_weights(B) {load_s:.3f} s (deep verify "
          f"{res['load']['deep_verify_s']:.3f} s, payload id "
          f"{res['load']['weights_id_s']:.3f} s); the tensors equal B's; "
          f"A republished keeps id {wid_a}")
    shutil.rmtree(pub["A"]["path"], ignore_errors=True)
    shutil.rmtree(pub["B"]["path"], ignore_errors=True)
    del params_b
    # (b)-(d) at a cut depth: A and B cut to their first layers, each
    # under the id publish_weights would give the cut payload
    n_layers = min(cfg.n_layers, EARLIER_POOL_LAYERS)
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params_a = _first_layers(params_a, n_layers)
    loaded_b = _first_layers(loaded_b, n_layers)
    wid_a, wid_b = (wr.weights_id_from_payload({"params": p})
                    for p in (params_a, loaded_b))
    res["cut_layers"] = n_layers
    print(f"phase 4i (b)-(d): the payloads' first {n_layers} layers")
    free()

    # the lone B engine: the probes' expected tokens
    model_b = tl.build_model(cfg, loaded_b, device)
    lone = seng.LLMEngine(model_b, prefix_cache=True, **knobs).start()
    lone.submit(rand(100), 8).result()
    picked = _pick_probes(lone, model_b, cfg.vocab_size, g, device,
                          min_margin=probe_margin)
    probes = picked["probes"]
    res["probes"] = {k: v for k, v in picked.items() if k != "probes"}
    res["probes"]["prompt_lens"] = [len(p) for p, _t in probes]
    print(f"phase 4i: 4 probes of 8 tokens from the lone B engine, "
          f"teacher-forced leads over the runner-up "
          f"{[round(m, 3) for m in picked['margins']]} (>= {probe_margin}; "
          f"{picked['passing']} of {picked['candidates']} candidates pass, "
          f"median lead {picked['median_margin']:.4f})")

    # (b) a green rollout A -> B under a chat front end's arrivals
    dep = LlamaDeployment(cfg, params_a, num_engine_replicas=3,
                          prefix_cache=True, max_new_tokens=n_new, **knobs)
    pool = dep.engine()
    for e in pool.engines():
        e.submit(rand(100), 8).result()
        e.wait_idle(60)
        e.reset_latency_stats()
    flight = os.path.join(root, "flight")
    ctl = wr.WeightRolloutController(pool, canary_fraction=0.34,
                                     probes=probes, swap_mode="preempt",
                                     flight_dir=flight)
    # the torn third copy is refused before any replica is touched
    fleet0 = ctl.fleet_weights()
    full = os.path.join(again["path"], "arrays", "tensors.pt")
    os.truncate(full, os.path.getsize(full) - 4096)
    try:
        wr.load_weights(again["path"])
        raise AssertionError("phase 4i (a): a truncated payload loaded")
    except ck.InvalidCheckpointError as e:
        torn_reason = e.reason
    if ctl.fleet_weights() != fleet0 or "manifest says" not in torn_reason:
        raise AssertionError(f"phase 4i (a): torn copy: {torn_reason}; "
                             f"fleet {fleet0} -> {ctl.fleet_weights()}")
    shutil.rmtree(again["path"], ignore_errors=True)
    res["torn_copy_refused"] = torn_reason
    print(f"phase 4i (a): a truncated third copy refused typed "
          f"(InvalidCheckpointError: {torn_reason}), fleet unchanged "
          f"{fleet0}")

    engines = pool.engines()
    steps0 = _decode_steps(engines)
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    gaps = [0.0] + [0.05] * 23
    traces = [[rand(512) for _ in range(24)] for _run in range(2)]
    plain = _arrivals(dep, traces[0], n_new, gaps)
    swap_logs = _replica_swap_timers(pool)
    thread, rec = _rollout_thread(ctl, dict(
        new_params=loaded_b, weights_id=wid_b, baseline_params=params_a,
        baseline_weights_id=wid_a))
    roll = _arrivals(dep, traces[1], n_new, gaps, hooks={3: thread.start})
    thread.join(timeout=600)
    for e in engines:
        e.wait_idle(60)
        del e._stage_weights, e._apply_swap_locked
    if "error" in rec or thread.is_alive():
        raise AssertionError(f"phase 4i (b): the rollout raised "
                             f"{rec.get('error')!r}")
    report = rec["report"]
    t_done = rec["t1"]
    late = [i for i in range(24)
            if roll["start"][i] + roll["ttft"][i] > t_done]
    post = traces[1][:4]
    post_outs = _run_wave(dep, [{"prompt_ids": p, "max_new_tokens": n_new}
                                for p in post])[0]
    agg = pool.load_report()
    per_rep = {}
    for tr in report["transitions"]:
        per_rep.setdefault(tr["idx"], []).append(tr["to"])
    checks = {
        "completed": report["status"] == "completed",
        "transitions strictly increasing per replica": all(
            b > a for v in per_rep.values() for a, b in zip(v, v[1:]))
        and all(tr["to"] > tr["from"] for tr in report["transitions"]),
        "3 swaps": pool.route_stats["weight_swaps"] == 3,
        "weights not mixed": agg["weights_mixed"] is False,
        "the fleet on B": {w for _g, w in ctl.fleet_weights().values()}
        == {wid_b},
        "no failed request": all(len(o) == n_new for o in
                                 plain["outs"] + roll["outs"] + post_outs),
        "a weight-rollout-done bundle": any(
            b.startswith("weight-rollout-done") for b in os.listdir(flight)),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 4i (b): {checks}; {report}")
    res["green"] = {
        "wall_s": t_done - rec["t0"], "canary": report["canary"],
        "waves": report["waves"], "transitions": report["transitions"],
        "generation": report["generation"],
        "staging_ms": {i: [x * 1e3 for x in v["stage"]]
                       for i, v in swap_logs.items()},
        "pause_ms": {i: [x * 1e3 for x in v["flip"]]
                     for i, v in swap_logs.items()},
        "weight_swaps": pool.route_stats["weight_swaps"],
        "late_requests": late,
        "arms": {name: {k: run[k] for k in ("tok_s", "wall_s", "ttft_p50_s",
                                             "ttft_p99_s", "tpot_p50_s")}
                 for name, run in (("no_rollout", plain),
                                   ("rollout", roll))}}

    # (c) a red rollout B -> C: C negates layer 0's attention output
    bad = dict(loaded_b)
    key = "layers.0.attention.wo.weight"
    bad[key] = -loaded_b[key]
    wid_c = wr.weights_id_from_payload({"release": "C", "params": bad})
    gens0 = {i: pool.replica(i).engine.weight_generation for i in range(3)}
    swaps0 = {i: pool.replica(i).engine.stats["weight_swaps"]
              for i in range(3)}
    n_ev, rb0 = pool.events.total, rollbacks()
    red = ctl.rollout(bad, weights_id=wid_c, baseline_params=loaded_b,
                      baseline_weights_id=wid_b)
    ev = pool.events.snapshot()
    ev = ev[len(ev) - (pool.events.total - n_ev):]
    k_launch = (pa.paged_decode_attention.launches,
                pa.paged_decode_attention.launches_int8)
    steps = _decode_steps(engines) - steps0
    t_swap = next((e[obs.T] for e in ev if e[obs.ETYPE] == "weight_swap"
                   and e[obs.DATA]["weights_id"] == wid_c), None)
    t_conv = next((e[obs.T] for e in ev
                   if e[obs.ETYPE] == "weight_source"), None)
    bundles = [os.path.join(flight, b) for b in sorted(os.listdir(flight))
               if b.startswith("weight-rollback")]
    bundle = obs.load_flight_bundle(bundles[0]) if bundles else {}
    touched = set(red["canary"])
    checks = {
        "rolled back for parity": red["status"] == "rolled_back"
        and "parity" in red["rollback_reason"]
        and None not in (t_swap, t_conv),
        "the fleet converged on B": red["rollback"]["converged"] and {
            w for _g, w in ctl.fleet_weights().values()} == {wid_b},
        "each canary's generation advanced twice": all(
            pool.replica(i).engine.weight_generation == gens0[i] + 2
            for i in touched),
        "untouched replicas did not swap": all(
            pool.replica(i).engine.stats["weight_swaps"] == swaps0[i]
            for i in range(3) if i not in touched),
        "serve_weight_rollback_total 1": rollbacks() - rb0 == 1,
        "route_stats weight_rollbacks 1":
            pool.route_stats["weight_rollbacks"] == 1,
        "a weight-rollback bundle names the canary": len(bundles) == 1
        and f"canary replica {red['canary'][0]}"
        in bundle.get("extra", {}).get("reason", ""),
    }
    if cuda:
        checks["K1 22 x the pool's decode steps, K2 never"] = \
            steps > 0 and k_launch == (n_layers * steps, 0)
    if not all(checks.values()):
        raise AssertionError(f"phase 4i (c): {checks}; {red}")
    res["red"] = {"canary": red["canary"], "reason": red["rollback_reason"],
                  "probe_failures": len(red["probe_failures"]),
                  "canary_swap_to_convergence_s": t_conv - t_swap,
                  "transitions": red["transitions"]}
    res["k1_launches"], res["k2_launches"] = k_launch
    res["pool_decode_steps"] = steps
    # the requests admitted after convergence against the lone B engine
    lone_outs = [h.result() for h in [lone.submit(p, n_new) for p in
                                      post + [traces[1][i] for i in late]]]
    partings = []
    for p, mine, twin in zip(post + [traces[1][i] for i in late],
                             post_outs + [roll["outs"][i] for i in late],
                             lone_outs):
        j, gap = _near_tie_parting(model_b, p, mine, twin, "fp", device)
        if j is not None:
            partings.append((j, gap))
    if any(gap > INT8_LOGIT_SLACK for _j, gap in partings):
        raise AssertionError(f"phase 4i (b): a request served after "
                             f"convergence parts from the lone B engine "
                             f"{partings}")
    res["green"]["after_convergence"] = {
        "compared": len(lone_outs), "parted": len(partings),
        "parting_gaps": [round(gap, 4) for _j, gap in partings]}
    for e in engines:
        e.wait_idle(60)
    check_pool_quiesced(pool)
    dep.shutdown()
    for name, a in res["green"]["arms"].items():
        print(f"phase 4i (b) {name}: TinyLlama-1.1B bf16 on {smi}, 3 "
              f"replicas, 24 requests (512-token prompts, 64 new) 50 ms "
              f"apart: {a['tok_s']:.1f} tok/s, TTFT p50 "
              f"{a['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{a['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{a['tpot_p50_s'] * 1e3:.2f} ms")
    gr = res["green"]
    print(f"phase 4i (b): rollout A -> B from the 4th arrival: "
          f"{gr['wall_s']:.3f} s, canary {gr['canary']}, waves "
          f"{gr['waves']}, transitions "
          f"{[(t['idx'], t['from'], t['to']) for t in gr['transitions']]}, "
          f"staging ms {_rounded(gr['staging_ms'], 1)}, pause ms "
          f"{_rounded(gr['pause_ms'], 2)}, "
          f"weight_swaps {gr['weight_swaps']}, weights_mixed False, no "
          f"failed request; after convergence "
          f"{gr['after_convergence']['compared']} requests against the "
          f"lone B engine: {gr['after_convergence']['parted']} part, at "
          f"near-ties {gr['after_convergence']['parting_gaps']}")
    print(f"phase 4i (c): rollout B -> C (layer 0's wo negated): rolled "
          f"back ({res['red']['reason']}), the fleet on B, canary swap -> "
          f"convergence {res['red']['canary_swap_to_convergence_s']:.3f} s,"
          f" serve_weight_rollback_total +1, a weight-rollback bundle; K1 "
          f"{k_launch[0]} = {n_layers} x {steps} decode steps over (b)-(c)")
    lone.shutdown()
    del dep, pool, engines, ctl, lone, bad, params_a
    free()

    # (d) the batch tier on one int8 engine with the prefix cache
    corpus = [rand(n) for n in g.integers(128, 513, size=64)]
    warm_rows = [rand(n) for n in g.integers(128, 513, size=4)]
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.launches_int8 = 0
    arms, batch_engines = {}, []
    for name in ("latency", "throughput"):
        eng = seng.LLMEngine(model_b, kv_dtype="int8", prefix_cache=True,
                             **knobs, **bt.engine_kwargs_for_profile(name))
        eng.start()
        batch_engines.append(eng)
        bt.run_batch_job(eng, warm_rows, max_new_tokens=8,
                         job_id=f"warm-{name}")
        job = bt.BatchInferenceJob(eng, corpus, max_new_tokens=n_new,
                                   max_in_flight=32, job_id=name)
        t = time.monotonic()
        outs = job.run()
        wall = time.monotonic() - t
        arms[name] = {"outs": outs, "tok_s": len(corpus) * n_new / wall,
                      "wall_s": wall, "stats": dict(job.stats)}
    thr = batch_engines[1]
    partings = []
    for p, a, b in zip(corpus, arms["latency"]["outs"],
                       arms["throughput"]["outs"]):
        j, gap = _near_tie_parting(model_b, p, a, b, "int8", device)
        if j is not None:
            partings.append((j, gap))
    ckdir = os.path.join(root, "batch-ck")
    writes = []
    crash = _CrashingTarget(thr, 40)
    job = bt.BatchInferenceJob(crash, corpus, max_new_tokens=n_new,
                               max_in_flight=32, checkpoint_dir=ckdir,
                               checkpoint_every=8, job_id="resume")
    _timed(job, "_write_checkpoint", writes)
    try:
        job.run()
        raise AssertionError("phase 4i (d): the crashing target never "
                             "crashed")
    except RuntimeError as e:
        if "simulated" not in str(e):
            raise
    for h in crash.handles:        # the dead driver's streams drop
        h.cancel()
    thr.wait_idle(120)
    committed = ck.Checkpoint.from_directory(ckdir).to_dict()["completed"]
    counting = _CountingTarget(thr)
    job = bt.BatchInferenceJob(counting, corpus, max_new_tokens=n_new,
                               max_in_flight=32, checkpoint_dir=ckdir,
                               checkpoint_every=8, job_id="resume")
    _timed(job, "_write_checkpoint", writes)
    resumed = job.run()
    for eng in batch_engines:
        eng.wait_idle(60)
    k_batch = (pa.paged_decode_attention.launches,
               pa.paged_decode_attention.launches_int8)
    steps = _decode_steps(batch_engines)
    rest = [i for i in range(len(corpus)) if i not in committed]
    resume_partings = []
    for i, (p, a, b) in enumerate(zip(corpus, resumed,
                                      arms["throughput"]["outs"])):
        j, gap = _near_tie_parting(model_b, p, a, b, "int8", device)
        if j is not None:
            resume_partings.append((i, j, gap))
    checks = {
        "every row complete in both arms": all(
            len(o) == n_new for a in arms.values() for o in a["outs"]),
        "the arms agree or part at near-ties": all(
            gap <= INT8_LOGIT_SLACK for _j, gap in partings),
        "rows committed before the crash": 0 < len(committed) < len(corpus),
        "rows_resumed == the committed rows":
            job.stats["rows_resumed"] == len(committed),
        "the resumed run submits only the others": sorted(
            map(tuple, counting.submitted)) == sorted(
            tuple(corpus[i]) for i in rest),
        "no row duplicated or missing": len(resumed) == len(corpus)
        and len(counting.submitted) == len(rest),
        "resumed rows equal the uninterrupted arm's or part at near-ties":
            all(gap <= INT8_LOGIT_SLACK for _i, _j, gap in resume_partings),
    }
    if cuda:
        checks["K2 22 x the decode steps, K1 never"] = \
            steps > 0 and k_batch == (0, n_layers * steps)
    for eng in batch_engines:
        eng.shutdown()
        check_quiesced(eng)
    if not all(checks.values()):
        raise AssertionError(f"phase 4i (d): {checks}; partings "
                             f"{partings}, {resume_partings}")
    res["batch"] = {
        "arms": {k: {kk: vv for kk, vv in v.items() if kk != "outs"}
                 for k, v in arms.items()},
        "profile_partings": [round(gap, 4) for _j, gap in partings],
        "committed": len(committed), "resubmitted": len(rest),
        "resume_partings": [(i, round(gap, 4))
                            for i, _j, gap in resume_partings],
        "checkpoint_write_ms": [x * 1e3 for x in writes],
        "decode_steps": steps}
    res["k2_launches_batch"] = k_batch[1]
    b = res["batch"]
    print(f"phase 4i (d): batch tier on one int8 engine + prefix cache, 64 "
          f"rows of 128-512 tokens, 64 new, max_in_flight 32, on {smi}: "
          f"latency profile {b['arms']['latency']['tok_s']:.1f} tok/s, "
          f"throughput profile {b['arms']['throughput']['tok_s']:.1f} "
          f"tok/s; {len(partings)} rows part between the profiles, at "
          f"near-ties {b['profile_partings']}; crash after 40 submits: "
          f"{b['committed']} rows committed, the resume submitted the "
          f"{b['resubmitted']} others, none duplicated or missing, "
          f"{len(resume_partings)} part from the uninterrupted arm at "
          f"near-ties; checkpoint writes "
          f"{[round(x, 2) for x in b['checkpoint_write_ms']]} ms; K2 "
          f"{k_batch[1]} = {n_layers} x {steps} decode steps")
    shutil.rmtree(root, ignore_errors=True)
    del model_b, loaded_b, batch_engines, thr
    free()
    return res


class _CrashingTarget:
    """An engine whose ``submit`` raises after ``crash_after`` calls: a
    batch driver's crash with rows committed and rows in flight (kept in
    ``handles``, so that the crash can cancel them as a dropped
    connection would)."""

    def __init__(self, eng, crash_after: int):
        self._eng, self._left, self.handles = eng, crash_after, []

    def submit(self, *a, **kw):
        if self._left <= 0:
            raise RuntimeError("simulated driver crash")
        self._left -= 1
        self.handles.append(self._eng.submit(*a, **kw))
        return self.handles[-1]


class _CountingTarget:
    """An engine that records every prompt submitted through it."""

    def __init__(self, eng):
        self._eng, self.submitted = eng, []

    def submit(self, prompt, **kw):
        self.submitted.append(list(prompt))
        return self._eng.submit(prompt, **kw)


def _flash_inputs(seed, B, T, H, D, dtype, pad_to=None, Tk=None):
    g = np.random.default_rng(seed)
    out = []
    for i in range(4):
        rows = Tk if Tk and i in (1, 2) else T
        x = torch.from_numpy(g.standard_normal((B, rows, H, D)).astype(
            np.float32)).to("cuda", dtype)
        if pad_to:
            x = torch.nn.functional.pad(x, (0, pad_to - D))
        out.append(x)
    return out


def _qkv_views(seed, B, T, H, D):
    """bf16 q, k, v as the column views of one fused [B, T, 3 H D]
    projection (GPT-2's c_attn layout, row stride 3 H D), and dO."""
    g = np.random.default_rng(seed)
    qkv = torch.from_numpy(g.standard_normal((B, T, 3 * H * D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    do = torch.from_numpy(g.standard_normal((B, T, H, D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    return q, k, v, do


def _flash_errors(fa, q, k, v, do, causal, scale, limits):
    """Each of K3, K4, K5 against its plain version on the same inputs
    (the backward kernels get the plain forward's o and lse); raises
    past ``limits`` = {"o": (atol, rtol), "grad": (atol, rtol)}."""
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal, scale)
    dq = fa.flash_bwd_dq(q, k, v, ro, do, rlse, causal, scale)
    rdq = fa.flash_bwd_dq_reference(q, k, v, ro, do, rlse, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, ro, do, rlse, causal, scale)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, ro, do, rlse, causal,
                                          scale)
    torch.cuda.synchronize()
    refs = {"o": ro, "dq": rdq, "dk": rdk, "dv": rdv}
    if not all(bool(r.abs().max() > 0) for r in refs.values()):
        raise AssertionError("a plain version gave all zeros")
    return {"o": _max_err(o, ro, *limits["o"]),
            "lse": _max_err(lse, rlse, FLASH_FP32_TOL),
            "dq": _max_err(dq, rdq, *limits["grad"]),
            "dk": _max_err(dk, rdk, *limits["grad"]),
            "dv": _max_err(dv, rdv, *limits["grad"]),
            "max_abs_ref": max(r.abs().max().item() for r in refs.values())}


def _device_kernels(fn, warm=None) -> list:
    """Names of the kernels ``fn`` ran on the card (``_device_events``)."""
    return [e.name for e in _device_events(fn, warm)]


def _device_events(fn, warm=None) -> list:
    """The device events (kernels, copies) of ``fn`` on the card, from
    torch.profiler (names demangled, e.g. ``void (anonymous
    namespace)::dq_sm90<64>(...)``).
    A session can miss a kernel of its first calls (the first bf16
    flash forward of phase 5, on the H100, once the sessions of phases 2
    and 4 had run in the process, though the kernel had run before the
    session and the session opened with a pause), so each session first
    runs ``warm`` (by default ``fn`` itself), then three spin kernels as
    a marker, then ``fn``; only the kernels that start after the last
    marker ends are returned."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (warm or fn)()
        torch.cuda.synchronize()
        for _ in range(3):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        raise AssertionError("the profiler recorded no marker kernel")
    return [e for e in events if e.time_range.start >= max(marks)]


def _check_tensor_core_route(names, calls: int, where: str) -> dict:
    """Every bf16 K3, K4 and K5 call of ``calls`` ran its tensor-core
    kernel (and its delta pass) and none a scalar flash kernel."""
    count = {k: sum(f"::{k}<" in n for n in names)
             for k in ("fwd_sm90", "delta_kernel", "dq_sm90", "dkv_sm90",
                       "fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel")}
    want = {"fwd_sm90": calls, "delta_kernel": 2 * calls,
            "dq_sm90": calls, "dkv_sm90": calls, "fwd_kernel": 0,
            "bwd_dq_kernel": 0, "bwd_dkv_kernel": 0}
    if count != want:
        order = [k for n in names for k in count if f"::{k}<" in n]
        raise AssertionError(f"{where}: device kernels {count}, want "
                             f"{want}; flash kernels in order {order}")
    return count


def phase_flash_kernels(fa, seed: int) -> tuple:
    """K3, K4, K5 against their plain versions (fp32 small cases, the
    GPT-2-124M shape in fp32 and bf16, the TinyLlama-1.1B training
    shape in bf16), with times and bounds; the kernel rows and the
    whole backward's times at each shape."""
    fp32 = {"o": (FLASH_FP32_TOL,), "grad": (FLASH_FP32_TOL,)}
    worst = 0.0
    for T in (128, 256, 512):
        for D in (16, 64, 128):
            for causal in (True, False):
                pad = 64 if D == 16 else None
                q, k, v, do = _flash_inputs(seed + T + D, 2, T, 3, D,
                                            torch.float32, pad)
                errs = _flash_errors(fa, q, k, v, do, causal, D ** -0.5,
                                     fp32)
                errs.pop("max_abs_ref")
                worst = max(worst, *errs.values())
    print(f"phase 5: K3/K4/K5 fp32 at T 128/256/512, D 16 (padded to 64)/"
          f"64/128, causal and not: max abs err {worst} (tol "
          f"{FLASH_FP32_TOL})")

    bf16 = {"o": FLASH_BF16_O, "grad": FLASH_BF16_GRAD}
    cases = [(_flash_inputs(seed + T + D, 2, T, 3, D, torch.bfloat16),
              causal, D) for T in (128, 192, 512) for D in (64, 128)
             for causal in (True, False)]
    cases.append((_flash_inputs(seed + 5, 1, 128, 2, 64, torch.bfloat16,
                                Tk=384), False, 64))
    cases.append((_qkv_views(seed + 6, 2, 256, 3, 64), True, 64))
    worst16 = {}

    def bf16_cases():
        for args, causal, D in cases:
            errs = _flash_errors(fa, *args, causal, D ** -0.5, bf16)
            errs.pop("max_abs_ref")
            for key, err in errs.items():
                worst16[key] = max(worst16.get(key, 0.0), err)

    route = _check_tensor_core_route(_device_kernels(bf16_cases),
                                     len(cases), "bf16 cases")
    print(f"phase 5: K3/K4/K5 bf16 on the tensor cores at T 128/192/512, "
          f"D 64/128, causal and not, Tq 128 / Tk 384, and strided qkv "
          f"views ({len(cases)} cases; device kernels {route}): max abs "
          f"err {worst16} (tol o {FLASH_BF16_O[0]} + {FLASH_BF16_O[1]} * "
          f"|ref|, lse {FLASH_FP32_TOL}, grads {FLASH_BF16_GRAD[0]} + "
          f"{FLASH_BF16_GRAD[1]} * |ref|)")
    del cases

    B, T, H, D = 24, 1024, 12, 64
    args = _flash_inputs(seed + 1, B, T, H, D, torch.float32)
    err32 = _flash_errors(fa, *args, True, D ** -0.5, fp32)
    print(f"phase 5: K3/K4/K5 fp32 at B={B} T={T} H={H} D={D} causal: "
          f"max abs err {err32} (tol {FLASH_FP32_TOL})")
    del args
    gpt2 = _flash_shape(fa, *_flash_inputs(seed, B, T, H, D, torch.bfloat16),
                        "GPT-2-124M")
    # the TinyLlama-1.1B training shape: 32 heads over K and V of 4 kv
    # heads repeated per head, as the cache-free Llama forward gives them
    q, k, v, do = _flash_inputs(seed + 2, 8, 1024, 32, 64, torch.bfloat16)
    k, v = (x[:, :, :4].repeat_interleave(8, dim=2) for x in (k, v))
    llama = _flash_shape(fa, q, k, v, do, "TinyLlama-1.1B")
    del q, k, v, do

    rows = []
    tensor = ("wgmma, bf16 in, fp32 accumulators; TMA ring of 2 "
              "swizzled stages; 1 consumer warpgroup + 1 producer warp "
              "per 64-row tile; CTAs grouped by (batch, head); ")
    for key, name, body, lib_key, errs, design in (
            ("fwd", "flash_fwd", 91, "fwd", ("o",),
             tensor + "Q and P as register A operands"),
            ("dq", "flash_bwd_dq", 204, "bwd", ("dq",),
             tensor + "Q and dO as register A operands of S and dP, dS of "
             "dQ += dS K; delta from the shared pass"),
            ("dkv", "flash_bwd_dkv", 259, "bwd", ("dk", "dv"),
             tensor + "P^T and dS^T as register A operands; delta from "
             "the shared pass")):
        row = {"name": name, "route": "cuda",
               "source": f"ray_tpu_torch/ops/csrc/{fa._SOURCE_SM90}",
               "replaces": f"ray_tpu/ops/flash_attention.py:{body}",
               "design": design, "launches": None,
               "max_abs_err_fp32": max(err32[e] for e in errs)}
        for res, into in ((gpt2, row), (llama, {})):
            nbytes, flops = res["spec"][key]
            into.update({
                "max_abs_err": max(res["err"][e] for e in errs),
                "ms": res["ms"][key], "plain_ms": res["plain"][key],
                "bound_ms": res["bound"][key][0],
                "bound_by": res["bound"][key][1],
                "library_ms": res["lib"][lib_key],
                "shape": dict(res["shape"], bytes=nbytes, flops=flops)})
            if res is llama:
                row["llama_1_1b"] = into
        rows.append(row)
    backward_ms = {where: {
        "delta_ms": res["ms"]["delta"], "delta_bound_ms":
        res["bound"]["delta"][0], "backward_ms": res["ms"]["bwd"],
        "backward_bound_ms": res["bound"]["bwd"][0],
        "sdpa_forward_ms": res["lib"]["fwd"],
        "sdpa_backward_ms": res["lib"]["bwd"],
        "sdpa_fwd_bwd_ms": res["lib"]["fwd_bwd"]}
        for where, res in (("gpt2_124m", gpt2), ("llama_1_1b", llama))}
    return rows, backward_ms


def _flash_shape(fa, q, k, v, do, where: str) -> dict:
    """bf16 K3, K4 and K5 (causal) at one training shape: each against
    its plain version at the bf16 limits, on the tensor cores by the
    profiler's kernel names; K4 and K5 on one shared delta equal to K4
    and K5 called alone; then the times (CUDA events, L2 flushed) of
    each kernel (K4 and K5 on a delta formed beforehand), the delta
    pass, one whole backward, the plain versions and SDPA, and each
    bound from these inputs."""
    B, T, H, D = q.shape
    scale = D ** -0.5
    bf16 = {"o": FLASH_BF16_O, "grad": FLASH_BF16_GRAD}
    err = {}

    def case():
        err.update(_flash_errors(fa, q, k, v, do, True, scale, bf16))

    _check_tensor_core_route(_device_kernels(case), 1, f"{where} shape")
    print(f"phase 5: K3/K4/K5 bf16 on the tensor cores at the {where} "
          f"shape (B={B} T={T} H={H} D={D} causal): max abs err {err} (tol "
          f"o {FLASH_BF16_O[0]} + {FLASH_BF16_O[1]} * |ref|, grads "
          f"{FLASH_BF16_GRAD[0]} + {FLASH_BF16_GRAD[1]} * |ref|)")

    ro, rlse = fa.flash_fwd_reference(q, k, v, True, scale)
    # K4 and K5 on one delta give what each gives alone
    delta = fa.flash_bwd_delta(ro, do)
    _max_err(delta, fa.flash_bwd_delta_reference(ro, do), FLASH_FP32_TOL)
    shared = (fa.flash_bwd_dq(q, k, v, ro, do, rlse, True, scale, delta),
              *fa.flash_bwd_dkv(q, k, v, ro, do, rlse, True, scale, delta))
    alone = (fa.flash_bwd_dq(q, k, v, ro, do, rlse, True, scale),
             *fa.flash_bwd_dkv(q, k, v, ro, do, rlse, True, scale))
    if not all(torch.equal(a, b) for a, b in zip(shared, alone)):
        raise AssertionError("K4/K5 on a shared delta differ from K4/K5 "
                             "called alone")
    del shared, alone

    # library yardstick, on its own [B, H, T, D] layout
    sq, sk, sv, sdo = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    torch.testing.assert_close(sdpa(sq, sk, sv, is_causal=True).transpose(
        1, 2).float(), ro.float(), rtol=SDPA_TOL, atol=SDPA_TOL)
    gq, gk, gv = (t.clone().requires_grad_() for t in (sq, sk, sv))
    out = sdpa(gq, gk, gv, is_causal=True)

    def sdpa_fwd_bwd():
        o = sdpa(gq, gk, gv, is_causal=True)
        torch.autograd.grad(o, (gq, gk, gv), sdo)

    def backward():
        d = fa.flash_bwd_delta(ro, do)
        fa.flash_bwd_dq(q, k, v, ro, do, rlse, True, scale, d)
        fa.flash_bwd_dkv(q, k, v, ro, do, rlse, True, scale, d)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    ms = {
        "fwd": _time_ms(lambda: fa.flash_fwd(q, k, v, True, scale), 20,
                        flush),
        "delta": _time_ms(lambda: fa.flash_bwd_delta(ro, do), 20, flush),
        "dq": _time_ms(lambda: fa.flash_bwd_dq(q, k, v, ro, do, rlse, True,
                                               scale, delta), 20, flush),
        "dkv": _time_ms(lambda: fa.flash_bwd_dkv(q, k, v, ro, do, rlse,
                                                 True, scale, delta), 20,
                        flush),
        "bwd": _time_ms(backward, 20, flush)}
    plain = {
        "fwd": _time_ms(lambda: fa.flash_fwd_reference(q, k, v, True,
                                                       scale), 5, flush),
        "dq": _time_ms(lambda: fa.flash_bwd_dq_reference(
            q, k, v, ro, do, rlse, True, scale, delta), 5, flush),
        "dkv": _time_ms(lambda: fa.flash_bwd_dkv_reference(
            q, k, v, ro, do, rlse, True, scale, delta), 5, flush)}
    lib = {"fwd": _time_ms(lambda: sdpa(sq, sk, sv, is_causal=True), 20,
                           flush),
           "bwd": _time_ms(lambda: torch.autograd.grad(
               out, (gq, gk, gv), sdo, retain_graph=True), 20, flush),
           "fwd_bwd": _time_ms(sdpa_fwd_bwd, 20, flush)}

    # least work: every input read once, every output written once (K4
    # and K5 read lse and the delta formed beforehand, the whole
    # backward reads o instead of delta); flops over the visible (query,
    # key) pairs of this causal run
    x = q.numel() * q.element_size()
    vec = rlse.numel() * 4
    pairs = B * H * T * (T + 1) // 2
    spec = {"fwd": (4 * x + vec, 4 * pairs * D),
            "delta": (2 * x + vec, 2 * B * T * H * D),
            "dq": (5 * x + 2 * vec, 6 * pairs * D),
            "dkv": (6 * x + 2 * vec, 8 * pairs * D),
            "bwd": (8 * x + vec, 14 * pairs * D)}
    bound = {}
    for key, (nbytes, flops) in spec.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        bound[key] = (max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations")
    for key, name in (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"),
                      ("dkv", "flash_bwd_dkv")):
        print(f"phase 5: {where} {name} bf16: kernel {ms[key]:.4f} ms "
              f"({spec[key][1] / ms[key] / 1e9:.1f} TFLOP/s), plain "
              f"{plain[key]:.4f} ms, bound {bound[key][0]:.4f} ms "
              f"({spec[key][0]} bytes, {spec[key][1]} flops)")
    print(f"phase 5: {where} delta pass {ms['delta']:.4f} ms (bound "
          f"{bound['delta'][0]:.4f} ms); one backward, delta pass + K4 + "
          f"K5, {ms['bwd']:.4f} ms ({spec['bwd'][1] / ms['bwd'] / 1e9:.1f}"
          f" TFLOP/s, bound {bound['bwd'][0]:.4f} ms) beside SDPA's "
          f"backward (dq, dk, dv) {lib['bwd']:.4f} ms: "
          f"{ms['bwd'] / lib['bwd']:.3f}x")
    print(f"phase 5: {where} SDPA (is_causal) yardstick: forward "
          f"{lib['fwd']:.4f} ms, backward {lib['bwd']:.4f} ms, "
          f"forward+backward {lib['fwd_bwd']:.4f} ms")
    return {"err": err, "ms": ms, "plain": plain, "lib": lib,
            "spec": spec, "bound": bound,
            "shape": {"B": B, "T": T, "H": H, "D": D, "causal": True,
                      "dtype": "bfloat16"}}


def _gpt2_loss(model, b):
    from ray_tpu_torch.models.gpt2 import linear_cross_entropy
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    return linear_cross_entropy(model(x, return_features=True), model.wte,
                                y)


def _llama_loss(model, b):
    """bench.py's Llama loss: the mean softmax cross-entropy of the fp32
    logits of ids[:, :-1] against ids[:, 1:]."""
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    logits = model(x)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())


def _trainer(cfg, sd, batch, device, lr, llama: bool = False):
    """(state, step, batch on the device) of the GPT-2 train step, or
    with ``llama`` the Llama one (fp32 masters from
    ``build_train_model``)."""
    from ray_tpu_torch.models import gpt2, llama as tl
    from ray_tpu_torch.train import spmd
    build = tl.build_train_model if llama else gpt2.build_model
    opt = spmd.adamw(lr, weight_decay=0.1)
    state = spmd.TrainState.create(build(cfg, sd, device), opt)
    return state, spmd.make_train_step(
        _llama_loss if llama else _gpt2_loss, opt), spmd.put_batch(
        batch, device)


def phase_train_parity(seed: int) -> None:
    """The same fp32 GPT-2 and batch trained 3 steps on the card
    (kernels) and on the CPU (plain versions)."""
    from ray_tpu_torch.models.gpt2 import gpt2_124m, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_124m(n_layer=2, n_embd=128, n_head=4, vocab_size=1024,
                    n_ctx=128, dtype=torch.float32, attention_impl="flash")
    sd = init_params(cfg, seed, device="cpu")
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(4, 129)).astype(np.int32)}
    runs = {}
    for device in ("cpu", "cuda"):
        state, step, b = _trainer(cfg, sd, batch, device, 3e-4)
        runs[device] = []
        for _ in range(3):
            state, m = step(state, b)
            runs[device].append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=TRAIN_RTOL)
    print(f"phase 6: GPT-2 fp32 train step (2 layers, C 128, H 4, vocab "
          f"1024, T 128, batch 4), 3 AdamW steps: (loss, grad norm) card "
          f"{runs['cuda']} == CPU {runs['cpu']} within {TRAIN_RTOL} rel")


def phase_llama_train_parity(tl, seed: int) -> None:
    """A reduced fp32 Llama (GQA, remat, flash) and one batch trained 3
    steps on the card (kernels) and on the CPU (plain versions); step
    1's loss also without remat on each device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tl.LlamaConfig(vocab_size=1024, max_seq_len=128, dim=256,
                         n_layers=2, n_heads=4, n_kv_heads=2,
                         hidden_dim=512, dtype=torch.float32, remat=True,
                         attention_impl="flash")
    sd = tl.init_params(cfg, seed, device="cpu")
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(4, 129)).astype(np.int32)}
    runs = {}
    for device in ("cpu", "cuda"):
        state, step, b = _trainer(
            dataclasses.replace(cfg, remat=False), sd, batch, device, 3e-4,
            llama=True)
        no_remat = step(state, b)[1]["loss"].item()
        state, step, b = _trainer(cfg, sd, batch, device, 3e-4, llama=True)
        runs[device] = []
        for _ in range(3):
            state, m = step(state, b)
            runs[device].append((m["loss"].item(), m["grad_norm"].item()))
        if runs[device][0][0] != no_remat:
            raise AssertionError(f"{device}: step 1's loss {runs[device][0]}"
                                 f" with remat, {no_remat} without")
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=TRAIN_RTOL)
    print(f"phase 6b: Llama fp32 train step (2 layers, dim 256, 4 q / 2 kv "
          f"heads, vocab 1024, T 128, batch 4, remat, flash), 3 AdamW "
          f"steps: (loss, grad norm) card {runs['cuda']} == CPU "
          f"{runs['cpu']} within {TRAIN_RTOL} rel; step 1's loss the same "
          f"without remat on each device")


def phase_train_main_path(fa, seed: int, smi: str) -> dict:
    """GPT-2-124M at batch 24, T 1024: 1 warm-up + 10 timed steps."""
    from ray_tpu_torch.models.gpt2 import (flops_per_token, gpt2_124m,
                                           init_params)
    cfg = gpt2_124m()
    B, T, n_steps = 24, 1024, 10
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T + 1), dtype=np.int32)}
    t0 = time.monotonic()
    sd = init_params(cfg, seed, device="cuda")

    # step 1 with dense fp32-score attention: what the kernels' step 1
    # is held to
    state, step, b = _trainer(
        dataclasses.replace(cfg, attention_impl="dense_fp32"), sd, batch,
        "cuda", 3e-4)
    state, m = step(state, b)
    ref_loss, ref_norm = m["loss"].item(), m["grad_norm"].item()
    del state, step, m
    torch.cuda.empty_cache()

    state, step, b = _trainer(cfg, sd, batch, "cuda", 3e-4)
    del sd
    torch.cuda.synchronize()
    t_setup = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
               fa.flash_bwd_dkv)
    for kern in kernels:
        kern.launches = 0
    state, m = step(state, b)                    # warm-up: step 1
    losses = [m["loss"]]
    first_norm = m["grad_norm"].item()
    ts = time.monotonic()
    for _ in range(n_steps):
        state, m = step(state, b)
        losses.append(m["loss"])
    last = m["loss"].item()                      # waits for the device
    dt = time.monotonic() - ts
    launches = [kern.launches for kern in kernels]
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    want = cfg.n_layer * (n_steps + 1)
    if launches != [want] * 4:
        raise AssertionError(f"K3/delta/K4/K5 launches {launches} != "
                             f"{cfg.n_layer} layers x {n_steps + 1} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if abs(losses[0] - ref_loss) > 1e-2 or \
            abs(first_norm - ref_norm) > 0.02 * ref_norm:
        raise AssertionError(
            f"step 1 (loss {losses[0]}, grad norm {first_norm}) vs dense "
            f"fp32 attention (loss {ref_loss}, grad norm {ref_norm})")
    tok_s = B * T * n_steps / dt
    res = {"card": smi, "model": f"gpt2_124m bf16 on fp32 params (random "
           f"weights, seed {seed})", "batch": B, "seq": T,
           "timed_steps": n_steps, "train_tok_s": tok_s,
           "step_ms": dt / n_steps * 1e3,
           "mfu": tok_s * flops_per_token(cfg, T) / BF16_FLOPS,
           "peak_mem_gb": peak / 1e9, "losses": losses,
           "step1_loss": losses[0], "step1_loss_dense_fp32": ref_loss,
           "step1_grad_norm": first_norm,
           "step1_grad_norm_dense_fp32": ref_norm,
           "launches": dict(zip(("flash_fwd", "flash_bwd_delta",
                                 "flash_bwd_dq", "flash_bwd_dkv"),
                                launches)),
           "setup_s": t_setup}
    print(f"phase 7: GPT-2-124M train, batch {B} x T {T}, bf16 on fp32 "
          f"params, on {smi}: {tok_s:.1f} tokens/s, {res['step_ms']:.2f} "
          f"ms/step, MFU {res['mfu']:.4f} (989 TFLOP/s bf16), peak memory "
          f"{res['peak_mem_gb']:.2f} GB; loss {losses[0]:.4f} -> "
          f"{last:.4f} over {n_steps + 1} steps; step 1 vs dense fp32 "
          f"attention: loss {losses[0]:.5f} / {ref_loss:.5f}, grad norm "
          f"{first_norm:.5f} / {ref_norm:.5f}; K3/delta/K4/K5 launched "
          f"{launches} = {cfg.n_layer} layers x {n_steps + 1} steps")
    return res


def phase_llama_train_main_path(tl, fa, seed: int, smi: str) -> dict:
    """bench.py's llama-1.1b: TinyLlama-1.1B widths with remat, bf16 on
    fp32 params, batch 8 x T 1024: 1 warm-up + 10 timed steps."""
    cfg = tl.tinyllama_1_1b(max_seq_len=1024, remat=True)
    B, T, n_steps = 8, 1024, 10
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T + 1), dtype=np.int32)}
    t0 = time.monotonic()
    # fp32 draws for the fp32 masters
    sd = tl.init_params(dataclasses.replace(cfg, dtype=cfg.param_dtype),
                        seed, device="cuda")

    # step 1 with dense fp32-score attention (remat too: its scores are
    # 1.07 GB a layer): what the kernels' step 1 is held to
    state, step, b = _trainer(
        dataclasses.replace(cfg, attention_impl="dense_fp32"), sd, batch,
        "cuda", 3e-4, llama=True)
    state, m = step(state, b)
    ref_loss, ref_norm = m["loss"].item(), m["grad_norm"].item()
    del state, step, m
    torch.cuda.empty_cache()

    state, step, b = _trainer(cfg, sd, batch, "cuda", 3e-4, llama=True)
    del sd
    torch.cuda.synchronize()
    t_setup = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
               fa.flash_bwd_dkv)
    for kern in kernels:
        kern.launches = 0
    state, m = step(state, b)                    # warm-up: step 1
    losses = [m["loss"]]
    first_norm = m["grad_norm"].item()
    ts = time.monotonic()
    for _ in range(n_steps):
        state, m = step(state, b)
        losses.append(m["loss"])
    last = m["loss"].item()                      # waits for the device
    dt = time.monotonic() - ts
    launches = [kern.launches for kern in kernels]
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    per_step = cfg.n_layers * (n_steps + 1)
    # remat runs each block's forward again in the backward: K3 twice
    if launches != [2 * per_step] + [per_step] * 3:
        raise AssertionError(
            f"K3/delta/K4/K5 launches {launches} != [2, 1, 1, 1] x "
            f"{cfg.n_layers} layers x {n_steps + 1} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if abs(losses[0] - ref_loss) > 1e-2 or \
            abs(first_norm - ref_norm) > 0.02 * ref_norm:
        raise AssertionError(
            f"step 1 (loss {losses[0]}, grad norm {first_norm}) vs dense "
            f"fp32 attention (loss {ref_loss}, grad norm {ref_norm})")
    tok_s = B * T * n_steps / dt
    res = {"card": smi, "model": f"tinyllama_1_1b remat, bf16 on fp32 "
           f"params (random weights, seed {seed})", "batch": B, "seq": T,
           "timed_steps": n_steps, "train_tok_s": tok_s,
           "step_ms": dt / n_steps * 1e3,
           "flops_per_token": tl.llama_flops_per_token(cfg, T),
           "mfu": tok_s * tl.llama_flops_per_token(cfg, T) / BF16_FLOPS,
           "peak_mem_gb": peak / 1e9, "losses": losses,
           "step1_loss": losses[0], "step1_loss_dense_fp32": ref_loss,
           "step1_grad_norm": first_norm,
           "step1_grad_norm_dense_fp32": ref_norm,
           "launches": dict(zip(("flash_fwd", "flash_bwd_delta",
                                 "flash_bwd_dq", "flash_bwd_dkv"),
                                launches)),
           "setup_s": t_setup}
    print(f"phase 7b: TinyLlama-1.1B train (remat), batch {B} x T {T}, bf16 "
          f"on fp32 params, on {smi}: {tok_s:.1f} tokens/s, "
          f"{res['step_ms']:.2f} ms/step, MFU {res['mfu']:.4f} (989 "
          f"TFLOP/s bf16), peak memory {res['peak_mem_gb']:.2f} GB; loss "
          f"{losses[0]:.4f} -> {last:.4f} over {n_steps + 1} steps; step 1 "
          f"vs dense fp32 attention: loss {losses[0]:.5f} / "
          f"{ref_loss:.5f}, grad norm {first_norm:.5f} / {ref_norm:.5f}; "
          f"K3/delta/K4/K5 launched {launches}")
    return res


def phase_train_checkpoint(fa, seed: int, smi: str, step_ms_phase7: float,
                           cfg=None, B: int = 24, T: int = 1024,
                           device: str = "cuda") -> dict:
    """Phase 7c: phase 7's GPT-2-124M train step for 10 steps, with an
    asynchronous checkpoint of the model's and the AdamW optimizer's
    state dicts taken at step 5 and written while steps 6-10 run; then a
    restore into a fresh model and optimizer, held bit for bit to a copy
    taken on the card at step 5, whose steps 6-7 must give the
    uninterrupted run's losses (``cfg``, ``B``, ``T`` and
    ``device="cpu"`` rehearse it without a card)."""
    from ray_tpu_torch.air import checkpoint as ck
    from ray_tpu_torch.air.checkpoint_manager import CheckpointManager
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import spmd
    cfg = cfg or gpt2.gpt2_124m()
    cuda = device == "cuda"
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T + 1), dtype=np.int32)}
    state, step, b = _trainer(cfg, gpt2.init_params(cfg, seed, device),
                              batch, device, 3e-4)
    root = tempfile.mkdtemp(prefix="chip_smoke_7c_")
    mgr = CheckpointManager(root, keep_last_k=2)
    losses = []

    def window(n):
        nonlocal state
        t = time.perf_counter()
        ms = []
        for _ in range(n):
            state, m = step(state, b)
            ms.append(m["loss"])
        losses.extend(float(x) for x in ms)      # waits for the device
        return (time.perf_counter() - t) / n * 1e3

    window(1)                                    # step 1: warm
    before_ms = window(4)                        # steps 2-5
    ref_model = {k: v.detach().clone()
                 for k, v in state.params.state_dict().items()}
    ref_opt = {i: {k: v.clone() for k, v in s.items()} for i, s in
               state.opt_state.state_dict()["state"].items()}
    done_at = []
    t_save = time.perf_counter()
    handle = mgr.save_async({"model": state.params.state_dict(),
                             "optimizer": state.opt_state.state_dict(),
                             "step": 5}, 5)
    snapshot_ms = (time.perf_counter() - t_save) * 1e3
    stamp = threading.Thread(target=lambda: (
        handle.wait(), done_at.append(time.perf_counter())))
    stamp.start()
    busy_ms = window(5)                          # steps 6-10, writer busy
    busy_to_the_end = not handle.done()
    mgr.wait(600)
    stamp.join(60)
    write_s = done_at[0] - t_save
    manifest = ck.load_manifest(handle.path)
    payload_bytes = sum(r["bytes"] for r in manifest["files"].values())
    del state
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    data = mgr.latest_complete().to_dict()
    model = gpt2.build_model(cfg, gpt2.init_params(cfg, seed + 7, device),
                             device)
    model.load_state_dict(data["model"])
    opt = spmd.adamw(3e-4, weight_decay=0.1)(model.parameters())
    opt.load_state_dict(data["optimizer"])
    restore_s = time.perf_counter() - t
    mgr.close()
    got_opt = opt.state_dict()["state"]
    mismatched = [k for k, v in model.state_dict().items()
                  if not torch.equal(v, ref_model[k])]
    mismatched += [f"opt {i} {k}" for i, s in ref_opt.items()
                   for k, v in s.items()
                   if not torch.equal(got_opt[i][k].to(v.device), v)]
    restored = spmd.TrainState(params=model, opt_state=opt, step=5)
    after = []
    for _ in range(2):
        restored, m = step(restored, b)
        after.append(float(m["loss"]))
    checks = {
        "every tensor equals the card copy of step 5": not mismatched
        and len(ref_model) == len(model.state_dict())
        and len(ref_opt) == len(got_opt),
        "steps 6-7 from the restore give the uninterrupted losses":
            after == losses[5:7],
        "losses finite": all(np.isfinite(losses + after)),
        "step 5 committed": manifest["step"] == 5 and data["step"] == 5,
    }
    shutil.rmtree(root, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"phase 7c: {checks}; mismatched "
                             f"{mismatched[:8]}; losses {losses} restored "
                             f"{after}")
    res = {"card": smi, "step_ms_before": before_ms,
           "step_ms_writer_busy": busy_ms, "step_ms_phase7": step_ms_phase7,
           "writer_busy_through_step_10": busy_to_the_end,
           "snapshot_ms": snapshot_ms, "write_s": write_s,
           "payload_bytes": payload_bytes, "restore_s": restore_s,
           "losses": losses, "restored_losses": after}
    print(f"phase 7c: GPT-2-124M train, batch {B} x T {T}, on {smi}: "
          f"save_async of the model + AdamW state at step 5 "
          f"({payload_bytes} bytes): snapshot {snapshot_ms:.1f} ms on the "
          f"train thread, committed {write_s:.2f} s later (writer busy "
          f"through step 10: {busy_to_the_end}); step ms {before_ms:.2f} "
          f"(steps 2-5), {busy_ms:.2f} with the writer busy (steps 6-10), "
          f"phase 7 {step_ms_phase7:.2f}; restore {restore_s:.2f} s, every "
          f"tensor equals the card copy of step 5, steps 6-7 from the "
          f"restore {after} == uninterrupted {losses[5:7]}")
    return res


RL_LEARNER_RTOL = 1e-4             # fp32 learner stats, card vs CPU
RL_ROUNDS = 2                      # phase 8 (1): one overlapped pair of
                                   # rounds, one 3.96 GB commit fewer than 3


def _rl_learner_parity(tl, seed: int, card: str) -> list:
    """Two updates of one ``RolloutLearner`` (``llama_tiny`` fp32, ppo,
    entropy 0.01) on one fixed batch whose length is 128 (flash on the
    card: its fp32 kernels), on ``card`` and on the CPU: loss, pg_loss
    and entropy within ``RL_LEARNER_RTOL`` relative."""
    from ray_tpu_torch.rl import RolloutBatch, RolloutLearner
    cfg = tl.llama_tiny(dtype=torch.float32)
    sd = tl.init_params(cfg, seed, device="cpu")
    # behavior logprobs near a policy's: normal around -log(vocab)
    g = np.random.default_rng(seed + 29)
    V, B, plen, n_new = cfg.vocab_size, 4, 96, 32
    batch = RolloutBatch(
        batch_id="round-0", round_idx=0,
        prompts=g.integers(0, V, (B, plen)).tolist(),
        completions=g.integers(0, V, (B, n_new)).tolist(),
        logprobs=g.normal(-np.log(V), 0.3, (B, n_new)).tolist(),
        weights_id="w0", generation=0, rewards=g.normal(0.5, 1.0, B).tolist())
    runs = {}
    for d in ("cpu", card):
        learner = RolloutLearner(cfg, sd, algo="ppo", lr=1e-3,
                                 entropy_coef=0.01, device=d)
        runs[d] = [[s[k] for k in ("loss", "pg_loss", "entropy")]
                   for s in (learner.update(batch), learner.update(batch))]
    np.testing.assert_allclose(runs[card], runs["cpu"], rtol=RL_LEARNER_RTOL,
                               atol=1e-6)
    return runs[card]


def _rl_round_lines(stats: dict) -> list:
    """Per round: generation and learner walls, the generator's weight
    sync, publish and commit seconds."""
    out = []
    for e in stats["timeline"]:
        out.append({"round": e["round"],
                    "gen_s": e.get("gen_end", 0.0) - e.get("gen_start", 0.0),
                    "learn_s": e.get("learn_end", 0.0)
                    - e.get("learn_start", 0.0),
                    "sync_s": e.get("sync_s"), "publish_s": e.get("publish_s"),
                    "commit_s": e.get("commit_s")})
    return out


def phase_rl_loop(tl, pa, fa, seed: int, smi: str, cfg=None,
                  device: str = "cuda", B: int = 16) -> dict:
    """Phase 8: the RLHF loop (``ray_tpu_torch.rl``) at TinyLlama-1.1B's
    widths and ``EARLIER_POOL_LAYERS`` layers (``cfg``, ``device="cpu"``
    and smaller ``B`` rehearse it without a card), bf16 on fp32 masters,
    random weights from ``seed``. One ``LLMEngine`` (16 slots, 64-token
    pages, ``capture_logprobs``, temperature 1, no eos) and a
    ``RolloutLearner`` (ppo, Adam 1e-5); ``B`` prompts of 96 tokens a
    round, 32 new tokens, so L = 128 and the learner's attention takes
    flash. (1) ``RL_ROUNDS`` (2) rounds, staleness bound 1,
    overlapped, ``keep_last_k=1``; (2) a loop of 2 rounds whose learner
    dies before round 1's commit, then its resume (attempt 2), whose
    generator dies mid round 1 and is restarted there. Checks
    every ledger holds each round once, staleness <= 1, the restart,
    the resume round and ``resync_weights_id == recovered_weights_id``,
    the engine's final payload the last batch's, finite losses, and on
    the card K1 per layer on every decode step and K3, K4, K5 and the
    delta pass once per layer per update in (1). First, at
    ``llama_tiny`` fp32, the learner's first two updates card vs CPU."""
    from ray_tpu_torch.rl import (GeneratorKilled, RLHFLoop,
                                  RolloutGenerator, RolloutLearner)
    from ray_tpu_torch.serve.engine import LLMEngine
    cuda = device == "cuda"
    rounds, plen, n_new = RL_ROUNDS, 96, 32
    res = {"card": smi}
    if cuda:
        res["learner_card_vs_cpu"] = _rl_learner_parity(tl, seed, device)
        print(f"phase 8: RolloutLearner llama_tiny fp32, L 128 (fp32 flash "
              f"on the card), 2 updates: (loss, pg_loss, entropy) card "
              f"{res['learner_card_vs_cpu']} == CPU within "
              f"{RL_LEARNER_RTOL} rel")
    cfg = cfg or tl.tinyllama_1_1b(n_layers=EARLIER_POOL_LAYERS)
    if plen + n_new > cfg.max_seq_len:
        raise ValueError("prompt + completion exceed the model's context")
    t0 = time.monotonic()
    # fp32 draws for the fp32 masters; the engine serves them in bf16
    sd = tl.init_params(dataclasses.replace(cfg, dtype=cfg.param_dtype),
                        seed, device=device)
    eng = LLMEngine(tl.build_model(cfg, sd, device), max_slots=16,
                    page_size=64, n_pages=64, temperature=1.0, eos_id=-1,
                    seed=seed, capture_logprobs=True, device=device).start()
    eng.submit(list(range(1, plen + 1)), max_new_tokens=8).result()
    gen = RolloutGenerator(eng, max_new_tokens=n_new)
    root = tempfile.mkdtemp(prefix="chip_smoke_8_")
    half = cfg.vocab_size // 2

    def prompts_fn(r):
        g = np.random.default_rng(seed + 1000 + r)
        return g.integers(0, cfg.vocab_size, (B, plen)).tolist()

    def reward_fn(_prompt, completion):
        # a rule a policy can learn: the share of low-id tokens
        return sum(1 for t in completion if t < half) / max(len(completion),
                                                            1)

    updates = []

    def learner():
        lrn = RolloutLearner(cfg, sd, algo="ppo", lr=1e-5, device=device)
        update = lrn.update

        def timed(batch):
            t = time.monotonic()
            out = update(batch)          # .item() waits for the card
            updates.append(dict(out, update_s=time.monotonic() - t))
            return out

        lrn.update = timed
        return lrn

    def loop(name, n_rounds, lrn, **kw):
        d = os.path.join(root, name)
        return RLHFLoop(gen, lrn, reward_fn, prompts_fn, rounds=n_rounds,
                        staleness_bound=1, overlap=True,
                        ckpt_dir=os.path.join(d, "ckpt"),
                        publish_dir=os.path.join(d, "pub"), keep_last_k=1,
                        **kw)

    def audit(stats, n_rounds, where):
        want = [f"round-{i}" for i in range(n_rounds)]
        checks = {
            "each round once": sorted(stats["ledger"]) == want,
            "staleness <= 1": stats["max_staleness"] <= 1,
            "the engine ends on the last batch's payload":
            stats["final_weights_id"]
            == stats["batch_log"][-1]["weights_id"],
        }
        if not all(checks.values()):
            raise AssertionError(f"phase 8 {where}: {checks}\n{stats}")

    kernels = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
               fa.flash_bwd_dkv)
    try:
        res["setup_s"] = time.monotonic() - t0
        # (1) the overlapped loop
        lrn = learner()
        steps0 = eng.stats["decode_steps"]
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention.launches_int8 = 0
        for kern in kernels:
            kern.launches = 0
        stats = loop("main", rounds, lrn).run()
        launches = {"paged_decode_attention":
                    pa.paged_decode_attention.launches,
                    "paged_decode_attention_int8":
                    pa.paged_decode_attention.launches_int8}
        launches.update({k.__name__: k.launches for k in kernels})
        steps = eng.stats["decode_steps"] - steps0
        audit(stats, rounds, "(1)")
        losses = [u["loss"] for u in updates]
        per_update = cfg.n_layers * rounds
        checks = {"losses finite": len(losses) == rounds
                  and all(np.isfinite(losses)),
                  "overlap observed": stats["overlap_observed"]}
        if cuda:
            checks.update({
                "K1 per layer on every decode step, K2 never":
                steps > 0 and launches["paged_decode_attention"]
                == cfg.n_layers * steps
                and launches["paged_decode_attention_int8"] == 0,
                "K3, K4, K5 and the delta pass per layer per update": [
                    launches[k.__name__] for k in kernels]
                == [per_update] * 4})
        if not all(checks.values()):
            raise AssertionError(f"phase 8 (1): {checks}\nlaunches "
                                 f"{launches}, {steps} decode steps")
        res["main"] = {
            "rounds": _rl_round_lines(stats), "wall_s": stats["wall_s"],
            "generator_utilization": stats["generator_utilization"],
            "overlap_observed": stats["overlap_observed"],
            "max_staleness": stats["max_staleness"],
            "reward_curve": stats["reward_curve"], "losses": losses,
            "update_s": [u["update_s"] for u in updates],
            "launches": launches, "decode_steps": steps,
            "tokens_per_round": B * n_new,
            "final_weights_id": stats["final_weights_id"]}
        for line in res["main"]["rounds"]:
            print(f"phase 8 (1) round {line['round']}: generation "
                  f"{line['gen_s']:.3f} s, learner {line['learn_s']:.3f} s, "
                  f"weight sync {line['sync_s']:.3f} s, publish "
                  f"{line['publish_s']:.3f} s, commit {line['commit_s']:.3f}"
                  f" s")
        print(f"phase 8 (1): {rounds} rounds of {B} x ({plen} + {n_new}) "
              f"tokens on {smi}: wall {stats['wall_s']:.3f} s, "
              f"generator_utilization "
              f"{stats['generator_utilization']:.4f}, overlap_observed "
              f"{stats['overlap_observed']}, max staleness "
              f"{stats['max_staleness']}, losses {losses}, learner "
              f"updates {[round(u['update_s'], 4) for u in updates]} s, "
              f"rewards "
              f"{stats['reward_curve']}; launches {launches} over {steps} "
              f"decode steps ({cfg.n_layers} layers)")
        shutil.rmtree(os.path.join(root, "main"), ignore_errors=True)

        # (2) the learner dies before round 1's commit; attempt 2 resumes
        # at round 1, and its generator dies mid round 1 and is restarted
        # there (one loop for both kills: each round more costs a 3.96 GB
        # commit)
        ctl = os.path.join(root, "ctl")

        def kill(step):
            if step == 1:
                raise RuntimeError("chaos: learner killed pre-commit")

        killed = []

        def mid_round(r):
            if not killed:
                killed.append(r)
                raise GeneratorKilled(f"chaos: died mid round {r}")

        try:
            loop("learner_kill", 2, learner(), control_dir=ctl, attempt=1,
                 learner_kill_hook=kill).run()
            raise AssertionError("phase 8 (2): the killed loop completed")
        except RuntimeError as e:
            if "pre-commit" not in str(e):
                raise
        lrn2 = learner()
        stats = loop("learner_kill", 2, lrn2, control_dir=ctl, attempt=2,
                     generator_mid_round_hook=mid_round).run()
        audit(stats, 2, "(2)")
        checks = {"resumed at round 1": stats["resumed"]
                  and stats["start_round"] == 1,
                  "re-synced to the recovered payload":
                  stats["recovered_weights_id"]
                  == stats["resync_weights_id"],
                  "2 updates": lrn2.update_count == 2,
                  "the generator killed mid round 1, restarted once":
                  killed == [1] and stats["generator_restarts"] == 1}
        if not all(checks.values()):
            raise AssertionError(f"phase 8 (2): {checks}\n{stats}")
        res["learner_kill"] = {"rounds": _rl_round_lines(stats),
                               "restore_s": stats["restore_s"],
                               "recovered_weights_id":
                               stats["recovered_weights_id"]}
        res["generator_kill"] = {"killed_round": killed[0],
                                 "generator_restarts":
                                 stats["generator_restarts"],
                                 "wall_s": stats["wall_s"]}
        print(f"phase 8 (2): the learner killed before round 1's commit; "
              f"attempt 2 resumed at round 1 in {stats['restore_s']:.3f} s "
              f"(find, load and set the learner state), re-synced to the "
              f"recovered payload {stats['recovered_weights_id']}; its "
              f"generator killed mid round 1 and restarted once; ledger "
              f"{stats['ledger']}, wall {stats['wall_s']:.3f} s")
    finally:
        eng.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    if not all(np.isfinite([u["loss"] for u in updates])):
        raise AssertionError(f"phase 8: a loss is not finite: {updates}")
    res["total_s"] = time.monotonic() - t0
    print(f"phase 8: {res['total_s']:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    ap.add_argument("--only", choices=("4j", "4k"), default=None,
                    help="build the kernels, run this phase alone and "
                         "print no result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    t0 = time.monotonic()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    print(f"phase 1: {name} x {count}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    print(smi)
    tb = time.monotonic()
    sources = [pa._SOURCE, pa._SOURCE_INT8, fa._SOURCE, fa._SOURCE_SM90]
    _build.compile_all(sources)
    pa.load_kernel()
    pa.load_kernel(int8=True)
    fa.load_kernel()
    fa.load_kernel(sm90=True)
    print(f"phase 1: built {', '.join(sources)} for sm_90a in "
          f"{time.monotonic() - tb:.1f} s")
    report = _build.ptxas_report(fa._SOURCE_SM90)
    ptxas = _build.ptxas_summary(report, fa._SM90_KERNELS)
    missing = [f"{k}<{d}>" for k in fa._SM90_KERNELS for d in (64, 128)
               if f"{k}<{d}>" not in ptxas]
    if missing:
        raise AssertionError(f"ptxas reported no {missing} for "
                             f"{fa._SOURCE_SM90}")
    for kernel, info in ptxas.items():
        print(f"phase 1: ptxas, {fa._SOURCE_SM90} {kernel}: "
              f"{info.get('registers')} registers, spill stores/loads "
              f"{info.get('spill_stores')}/{info.get('spill_loads')} bytes")
    for line in report.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            print(f"phase 1: ptxas: {line.strip()}")
    # the tensor-core split pass of bf16 K1 (bf16 pages) and bf16-q K2
    # (int8 pages): one instance per head_dim and split in each library
    ptxas_decode = {}
    for source, page in ((pa._SOURCE, "__nv_bfloat16"),
                         (pa._SOURCE_INT8, "int8_t")):
        found = _build.ptxas_summary(_build.ptxas_report(source),
                                     ("split_sm90",))
        want = [f"split_sm90<{page}, {d}, {split // 4}>" for d in (64, 128)
                for split in pa._BF16_SPLITS]
        if sorted(found) != sorted(want):
            raise AssertionError(f"ptxas reported {sorted(found)} for "
                                 f"{source}, want {want}")
        for kernel, info in found.items():
            print(f"phase 1: ptxas, {source} {kernel}: "
                  f"{info.get('registers')} registers, spill stores/loads "
                  f"{info.get('spill_stores')}/{info.get('spill_loads')} "
                  f"bytes" + (f", warnings {info['warnings']}"
                              if info["warnings"] else ""))
        ptxas_decode[source] = found

    # The host-timed phases (4, 4b) run before any torch.profiler
    # session: after one, the process launches kernels at a higher host
    # cost for the rest of its life.
    if args.only is not None:
        if args.only == "4j":
            out = {"fleet_path": phase_fleet_path(tl, pa, args.seed, smi,
                                                  None)}
        else:
            out = {"fleet_chaos": phase_fleet_chaos(args.seed, smi)}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(out, card=smi,
                               total_s=time.monotonic() - t0), f, indent=1)
        print(f"total {time.monotonic() - t0:.1f} s")
        return 0
    phase_engine_parity(tl, args.seed)
    engine_modes = phase_engine_modes(tl, args.seed)
    engine_faults = phase_engine_faults(tl, args.seed)
    pool_events = phase_pool_events(tl, args.seed)
    pool_control = phase_pool_control(tl, args.seed)
    phase_generate_parity(tl, args.seed)
    print(f"phase 3 done at {time.monotonic() - t0:.1f} s")
    main_path, steps_fp = phase_main_path(tl, pa, args.seed, smi)
    print(f"phase 4 done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    int8_path, steps_int8 = phase_int8_prefix_path(tl, pa, args.seed, smi)
    print(f"phase 4b done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    static_path = phase_static_path(tl, args.seed, smi)
    print(f"phase 4c done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    default_loop = phase_default_loop_path(tl, pa, args.seed, smi)
    print(f"phase 4d done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phases 4e-4h, 4i (b)-(d) and 8 run TinyLlama-1.1B's widths at a
    # cut depth, so that the script keeps inside its time limit on a
    # slow host too
    shallow = tl.tinyllama_1_1b(n_layers=EARLIER_POOL_LAYERS)
    print(f"phases 4e-4h: TinyLlama-1.1B widths at {shallow.n_layers} of "
          f"its {tl.tinyllama_1_1b().n_layers} layers")
    kv_pull = phase_kv_pull_swap(tl, pa, args.seed, smi, cfg=shallow)
    print(f"phase 4e done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    faults_lanes = phase_faults_lanes_path(tl, pa, args.seed, smi, cfg=shallow)
    print(f"phase 4f done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    obs_pool = phase_obs_pool_path(tl, pa, args.seed, smi, cfg=shallow)
    print(f"phase 4g done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    control = phase_pool_control_path(tl, pa, args.seed, smi, cfg=shallow)
    print(f"phase 4h done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    fleet = phase_fleet_path(tl, pa, args.seed, smi, obs_pool["pool"],
                             cfg=shallow)
    print(f"phase 4j done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    fleet_chaos = phase_fleet_chaos(args.seed, smi)
    print(f"phase 4k done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    rollout = phase_rollout_batch_path(tl, pa, args.seed, smi)
    print(f"phase 4i done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    rl = phase_rl_loop(tl, pa, fa, args.seed, smi, cfg=shallow)
    print(f"phase 8 done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    k1 = phase_kernels(pa, args.seed)
    k2 = phase_kernels(pa, args.seed, int8=True)
    k1["launches"] = main_path["k1_launches"]
    k1["launches_default_loop"] = sum(
        arm["k1_launches"] for arm in default_loop["arms"].values())
    k2["launches"] = int8_path["k2_launches"]
    k1["launches_kv_pull"] = kv_pull["fp"]["k1_launches"]
    k2["launches_kv_pull"] = kv_pull["int8"]["k2_launches"]
    k1["launches_faults"] = faults_lanes["containment"]["k1_launches"]
    k2["launches_lanes"] = faults_lanes["lanes"]["k2_launches"]
    k1["launches_pool"] = obs_pool["pool"]["k1_launches"]
    k2["launches_pool_int8"] = obs_pool["int8"]["k2_launches"]
    k1["launches_disagg"] = \
        control["disagg_ab"]["disaggregated"]["k1_launches"]
    k1["launches_fleet"] = fleet["loopback"]["k1_launches"]
    k1["launches_rollout"] = rollout["k1_launches"]
    k2["launches_batch"] = rollout["k2_launches_batch"]
    k1["launches_rl"] = rl["main"]["launches"]["paged_decode_attention"]
    # which split pass the served pools' decode steps run: the
    # tensor-core pass over bf16 pages on the fp pool (K1) and over int8
    # pages on the int8 pool (K2), in every layer
    n_layers = tl.tinyllama_1_1b().n_layers
    for res, steps, want, where in (
            (main_path, steps_fp, {"sm90": 2 * n_layers}, "phase 4"),
            (int8_path, steps_int8, {"sm90_int8": 2 * n_layers},
             "phase 4b")):
        res["decode_split_passes_2_steps"] = _check_split_route(
            _device_kernels(steps), want, f"{where} decode steps")
        print(f"phase 2: 2 decode steps of {where}'s pool ran the split "
              f"passes {res['decode_split_passes_2_steps']}")
    # the probes hold phase 4's and 4b's models and pools: free them
    # before training, whose peak memory phase 7 reports
    del steps_fp, steps_int8, steps
    torch.cuda.empty_cache()
    print(f"phase 2 done at {time.monotonic() - t0:.1f} s")
    flash, backward_ms = phase_flash_kernels(fa, args.seed)
    print(f"phase 5 done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase_train_parity(args.seed)
    phase_llama_train_parity(tl, args.seed)
    print(f"phase 6 done at {time.monotonic() - t0:.1f} s")
    train = phase_train_main_path(fa, args.seed, smi)
    print(f"phase 7 done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    llama_train = phase_llama_train_main_path(tl, fa, args.seed, smi)
    print(f"phase 7b done at {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()
    train_ckpt = phase_train_checkpoint(fa, args.seed, smi, train["step_ms"])
    print(f"phase 7c done at {time.monotonic() - t0:.1f} s")
    default_loop.update(phase_verify_device_time(tl, args.seed, smi))
    for row in flash:
        row["launches"] = train["launches"][row["name"]]
        row["llama_1_1b"]["launches"] = \
            llama_train["launches"][row["name"]]
        row["launches_rl"] = rl["main"]["launches"][row["name"]]
    kernels = {"kernels": [k1, k2] + flash}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kernels": kernels["kernels"],
                       "ptxas_sm90": ptxas, "ptxas_decode_sm90": ptxas_decode,
                       "flash_backward": backward_ms,
                       "main_path": main_path,
                       "int8_prefix_path": int8_path,
                       "static_path": static_path,
                       "engine_modes": engine_modes,
                       "default_loop_path": default_loop,
                       "kv_pull_swap": kv_pull,
                       "engine_faults": engine_faults,
                       "faults_lanes_path": faults_lanes,
                       "pool_events": pool_events,
                       "obs_pool_path": obs_pool,
                       "pool_control": pool_control,
                       "pool_control_path": control,
                       "fleet_path": fleet,
                       "fleet_chaos": fleet_chaos,
                       "rollout_batch_path": rollout,
                       "rl_loop": rl,
                       "train_checkpoint": train_ckpt,
                       "train_main_path": train,
                       "llama_train_main_path": llama_train,
                       "total_s": time.monotonic() - t0}, f, indent=1)
    print(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
