#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nbdistributed_tpu_torch``) on one
NVIDIA GPU: builds the hand-written CUDA kernels from the checkout,
holds each against its plain PyTorch version, drives the serving and
training slices at the full width of SmolLM2-135M and of Mixtral-8x7B
(2 of its 32 layers), and times each kernel.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):

1. build the kernels (one ``nvcc`` per source, in parallel); the card's
   name and power limit;
2. K1, the flash-attention forward, called through its wrappers,
   against its plain version in bf16 (and fp32 cases): one 64 x 64
   tile, group 1, the serving shapes, the training path's (B=4,
   S=2048, without and with the training batch's packed-document
   segments) and Mixtral's attention (S=2048, H=32, Hkv=8, D=128);
3. K4, flash-decode, called through its wrapper, against its plain
   version: per-row positions over [0, T-1], a window, int8 caches
   with scales, fp32, T=1000 (ragged against the 128-key chunk), rows
   whose window lies past every valid key (o = 0, lse = NEG_INF),
   groups 1 and 8, D=32 and 128, one chunk (nsplit = 1), the lse, the
   serving path's own shape and positions and its full context, a
   paged step's dense view (large finite values past every position),
   the Mixtral server's shape (Hkv=8, group 4, D=128, T=1024) in
   bf16, int8 and fp32, and the mesh phase's shard shapes (B=4 of 8
   slots, T=512 and the path's 128; Mixtral's Hkv=4 of 8 on tp) at
   positions shifted by the slice's offset: negative, inside and past
   the slice, and a window wholly past it;
4. K2/K3, the flash-attention backward (dQ, dK/dV), called through the
   wrapper the path calls, against the plain backward in bf16 (one
   tile, group 1, causal S=2048 with group 3 at D=64 and D=128,
   non-causal Sq != Sk, a window, segments, offsets, D=32, the
   training path's shape with its batch's segments, Mixtral's
   attention) and fp32 cases; the K1 forward that feeds each case is
   held to the plain forward first;
5. the serving path, with every launch count set to 0 just before and
   read just after: full-width ``forward`` (bf16, B=1, S=512) and a
   bf16 ``DecodeServer`` answering 12 staggered requests; K1 must have
   launched once per layer, K4 once per layer per decode step.  The
   kernel-path logits are then held against the plain path's, and the
   same requests are served in fp32 and held against solo ``generate``
   under the near-tie rule (``near_tie_check``: a stream may leave its
   reference only where the reference's top-2 logit gap is below 1e-4;
   every fp32 check below uses it);
6. a profile of bf16 decode steps: device time per step against the
   host's wall time, and the kernels that take it;

Phases 7-10 run SmolLM2-135M at full width and 10 of its 30 layers
(``SBD_LAYERS``, the script's time budget), held to their own dense
bf16 server and solo fp32 ``generate`` at that depth, computed first;
every K4 count is per layer.

7. paged KV (``serve_paged``): 16 blocks of 64 tokens (1/8 of the dense
   pool) serving phase 5's requests, token for token the dense bf16
   server's, with admissions that waited for blocks and every block
   back at the end; on 8 of them int8 KV paged against int8 KV dense
   and fp32 paged against solo ``generate``; the gather's and scatter's
   device time; a profile of paged steps;
8. speculative decoding (``serve_speculative``, gamma 4, draft = the
   target's first 2 layers): fp32 against solo ``generate``; an fp32
   self-draft accepting every proposal but at near-ties; bf16 tokens
   per round, ms per round and tokens/s; K4 (gamma + 1) x 2 times a
   round and none in the verify; a profile of rounds;
9. prefix caching and chunked prefill (``serve_prefix_chunked``): a
   384-token cached prefix against a server without it, with the
   prefill positions each fed; interleaved prefill in chunks of 128 of
   600-1500-token prompts against solo ``generate``; in bf16, the
   slowest decode step while a long prompt streams in beside one
   unchunked admission step;
10. int8 and int4 weights (``serve_quantized``): weight bytes, decode
   ms per step and the forward's relative L2 in bf16 (12 requests),
   fp32 against solo ``generate`` on the same quantized tree (4
   requests), and the lm_head product's time in each form;
11. the training path, counts reset just before and read just after:
   8 bf16 AdamW steps with remat on one fixed batch of B=4 x S=2048
   packed documents, fed through ``batch_iterator`` and
   ``prefetch_to_device``; per step K1 must launch 60 times (forward
   and remat recompute), K2 and K3 30 times each; every loss finite
   and the last below the first.  Then a profile of one step, the
   fp32 loss and every gradient through the kernels against the plain
   path (B=1, S=2048), and three bf16 LoRA steps (base untouched, loss
   falls);
12. the Mixtral MoE family (``mixtral_8x7b_config(n_layers=2)``, full
   width, seed 0), each path's run with the counts reset just before
   and read just after: ``moe_forward`` (fp32, B=1, S=512, capacity
   factor 4: lossless) in the dense, sparse and dropless modes, logits
   within 1e-5 relative L2, aux within 1e-6, K1 once per layer per
   forward, dropless's host reads one per layer;
13. fp32 MoE serving on 8 of 12 requests made as phase 5's are (in
   Mixtral's vocabulary) against solo ``generate``, an fp32 self-draft (gamma 4) accepting every proposal
   but at near-ties with K4 (gamma + 1) x 2 per round, and an int8
   (``quantize_moe_params``) tree against solo ``generate`` on it;
14. bf16 MoE serving (capacity factor 1.25, dense dispatch) of the 12
   requests: tokens/s, ms per step, weight bytes, K4 once per layer per
   step, a profile of decode steps with the MoE block's device share,
   the paged server (blocks of 64) token for token the dense one, and
   the int8 tree's weight bytes and ms per step;
15. bf16 MoE training: ``moe_loss_fn`` and AdamW, 4 steps on B=1 x
   S=2048 packed documents, per step K1, K2 and K3 once per layer,
   losses finite and falling, peak memory, a profiled step; three LoRA
   steps on the attention projections;
16. timing of each kernel at the main paths' shapes (K1 at the serving,
   training and Mixtral shapes, K4 at the serving shape, at full
   context, at the Mixtral server's shape and at the mesh's sp shard), beside its plain
   version, one PyTorch library call and the card's bound; K4 and its
   yardsticks on the device by CUDA-graph replay (a K4 call is shorter
   than the host's launch of it);
17. (run right after phase 6) the worker cluster: one worker spawned by
   the port's ``ProcessManager`` (``backend="gpu"``) and driven over
   its control plane: the NCCL process group (``dist.all_reduce`` and
   the functional ``all_reduce`` on the card, a 64 MB all-reduce
   timed), phase 5's path run in the worker with its counts reset just
   before and read just after there (K1 once per layer, K4 once per
   layer per decode step; tokens equal to the in-process bf16 server's;
   no kernel rebuilt in the worker), a serve_open / serve_step /
   serve_close round, an interrupt of a cell looping GPU matmuls, the
   spawn-to-ready time and the median round trip of a trivial cell.
   Then HF interop: SmolLM2 and Mixtral (2 layers) laid out as
   ``transformers`` state dicts and converted back onto the GPU, bit
   for bit, and ``load_hf_pretrained`` where ``transformers`` imports.

18. (run after phase 15) serving on a mesh: four ranks of one gloo
   process group spawned by this script on the one card (each on
   ``cuda:0``; NCCL refuses two ranks on one device), loading the
   kernels this process built.  In fp32 they serve phase 5's 12 requests
   with SmolLM2-135M (30 layers) on ``{"dp": 2, "sp": 2}`` and the 8 of
   phase 13 with Mixtral (2 layers, full width, capacity factor 4) on
   ``{"ep": 4}`` (dense and dropless dispatch) and on ``{"tp": 2,
   "sp": 2}``, at ``max_len`` 256 (both sp slices hold keys); each rank
   builds its shard of the model from seed 0, leaf by leaf.  Each run's
   counts are reset just before and read just after on every rank: K4
   once per layer per decode step, every rank's tokens equal, and the
   tokens held to solo ``generate`` under the near-tie rule.  Rows: ms
   per step, collectives per step and each rank's peak memory; the
   ranks time-share the card and every collective crosses the host, so
   no number is a link speed.

19. (run after phase 18) training on a mesh: phase 18's ranks train,
   each from seed 0 and guarded, SmolLM2-135M (4 of its 30 layers,
   fp32, remat)
   with Megatron rules on ``{"dp": 2, "tp": 2}`` (attention on every
   head on every tp rank: 9 and 3 heads do not divide 2) and with HSDP
   rules on the same mesh (2 AdamW steps, B=4 x S=512 packed
   documents), ZeRO-2 on ``{"dp": 4}`` (accum_steps 2, B=8 x S=512, 3
   steps and a NaN batch between steps 2 and 3 that must be skipped
   bitwise), and Mixtral (1 layer, full width, fp32, capacity factor
   4, dropless) with ``moe_loss_fn`` on ``{"ep": 4}`` (2 steps, B=1 x
   S=512).  Each is held to the single-process step on the whole tree
   and batch, run first in this process: every rank's losses equal, the
   losses within 1e-5 and each step's gradient norm within 1e-4
   relative, every leaf gathered from the shards within 1e-4 relative
   L2; per rank per step K1/K2/K3 20/10/10 for SmolLM2 (x2 with
   accumulation) and 2/2/2 for Mixtral, counts reset just before and
   read just after; the ZeRO moments a quarter of each leaf.  Rows: ms
   per step, collectives per step and peak memory per rank, host-bound
   gloo times.

20. (run after phase 19) sequence-parallel training.  First K1, K2
   and K3 at ring-hop geometry for Mistral-7B's attention (H 32, Hkv 8,
   D 128, chunks of 1024), bf16 and fp32, against their plain versions:
   the diagonal hop, a fully visible and a fully masked one, window 1536
   at its edge and past it, zigzag half-pairs, key-side segments unlike
   the query side's (rows no key reaches must be the same rows on both
   sides; K2/K3 from a whole-sequence lse and delta; a fully masked
   hop's gradients exactly zero).  Then phase 18's ranks, each job from
   seed 0 in fp32 and held to the single-process run here as phase 19
   holds its jobs: SmolLM2-135M (4 layers, remat, packed documents,
   B=2 x S=2048 on ``{"sp": 4}`` and B=4 on ``{"dp": 2, "sp": 2}``,
   the ring, 2 AdamW steps), Mistral-7B (``mistral_7b_config``, 1 of 32
   layers, window 4096, B=1 x S=8192 on sp4, 1 step: the pruned plan of
   3 hops and one jump home), TinyLlama-1.1B (2 of 22 layers, Ulysses on
   ``{"sp": 2, "tp": 2}`` with Megatron rules), Mixtral (1 layer,
   dropless, capacity factor 4, ring on ``{"sp": 2, "ep": 2}``, one
   forward and backward without an optimizer), and Mistral's attention
   alone as the zigzag ring on sp4 (S=8192, bf16 and fp32, full and
   window 1024) against ``flash_attention`` on the whole sequence.
   K1/K2/K3 per rank per step: hops x layers (K1 twice with remat).
   Rows: ms per step, collectives per step (ring hops are
   ``batch_isend_irecv`` calls), peak GB per rank, the phase's seconds;
   host-bound gloo times.

21. (run after phase 20) pipeline-parallel training.  First
   ``remat_policy="dots"`` on phase 11's shape (bf16, B=4 x S=2048,
   one step, this process) against full remat and none: the loss within
   1e-6 of full remat's, K1 60 (attention recomputed), K2 and K3 30;
   peak GB and ms of each.  Then phase 18's ranks, each job from seed 0
   in fp32, AdamW lr 1e-4, held to the single-process step as phase 19
   holds its jobs (each step's gradient norm from an AdamW that records
   it): Mistral-7B (``mistral_7b_config``, 4 of 32 layers, one a stage,
   B=16 x S=512, 16 microbatches, 1 step) on ``{"pp": 4}`` by GPipe
   (``make_pp_train_step``) and by 1F1B (``make_pp_1f1b_train_step``,
   its losses within 1e-5 of GPipe's), and SmolLM2-135M (4 layers, 2 a
   stage) by 1F1B on ``{"dp": 2, "pp": 2}`` (``batch_axis="dp"``, B=8,
   4 microbatches, 2 steps).  K1/K2/K3 per rank per step: the stage's
   layers per microbatch, K1 twice under 1F1B but on the last stage.  And
   ``allgather_matmul`` against ``all_gather`` and one product at a
   Megatron shape on ``{"tp": 4}`` (bf16, x 2048 x 4096 a rank, w
   4096 x 3584): C4's overlap, reported.  Rows: ms per step per rank,
   collectives per step, peak GB per rank, the phase's seconds.

22. (run after phase 21) the training guard and per-rank checkpoints,
   SmolLM2-135M at full width, 4 of its 30 layers, bf16, remat, B=4
   x S=2048, AdamW, from seed 0.  (1) Phase 18's ranks, each training on a mesh
   of its own (``make_mesh({"dp": 1}, ranks=[rank])``) with the same
   batches under ``TrainGuard(audit_every=2, snapshot_every=2)``, 6
   steps, fault-free and then with one bit of rank 1's ``wq`` flipped
   at step 3 by the process fault plan: every fault-free audit ``ok``,
   the step-4 audit names minority (1,) and root 0 with one repair, and
   every rank's final params and moments bitwise the fault-free run's;
   K1/K2/K3 20/10/10 a rank a step.  (2) In this process, an inf scaled
   into four lm_head weights at step 3: steps 3-5 skipped with the
   params, moments and AdamW's step bitwise unchanged, the blown skip
   budget rolling back to the step-2 snapshot bitwise, steps 6-9
   finite.  (3) ``save_async`` after two steps, step 3 run at once in
   place; the save restored into a fresh tree and optimizer is the
   step-2 state bitwise and steps 3-4 from it repeat the uninterrupted
   run's losses and fingerprints; a byte flipped on disk is refused
   with its leaf named.  (4) A worker: the ``checkpoint`` request (save,
   background save, status, restores into the live tensors) and the
   ``guard`` request (status, audit, off, on) on CUDA tensors, and the
   ``tg`` field on its pings.  Rows, reported: the fingerprint's ms
   beside its bound, a snapshot's ms, the guarded step beside the
   unguarded one, the save's and restore's GB/s, ``save_async``'s
   synchronous ms, peak GB a rank.

23. (run after phase 22) the notebook surface: the magics' bodies
   (``magics.magic.DistributedMagics``; the card's machine has no
   IPython) called cell by cell against a stand-in shell:
   ``%dist_init -n 1 --backend gpu`` (spawn to ready timed),
   ``%dist_status`` (``cuda:r``, the card's name, NCCL), a plain cell
   distributed by the input transformer that serves phase 17's 12
   requests on SmolLM2-135M (bf16, seed 0) with the counts reset in the
   cell (K4 once per layer per decode step, read through
   ``%dist_pull``, as are the streams: equal to phase 17's in-process
   ones), a cell with phase 11's first training step (K1/K2/K3
   60/30/30; the loss equal to phase 11's to the last bit) and a timed
   second step, ``%dist_checkpoint`` / zeroed params /
   ``%dist_restore`` bitwise, then ``--background`` polled with
   ``--status`` until every rank has said done once, ``%%rank [0]``,
   ``%sync``, ``%dist_mode`` off and on, an error reported per rank,
   the median round trip of 20 trivial ``%%distributed`` cells, and
   ``%dist_shutdown`` leaving no worker pid.  Each cell's text and
   output go to ``chiprun_out/notebook_cells_n<ranks>.json``.

24. (run after phase 23) cell vetting and the async window, through
   the same magics and stand-in shell, a fresh ``%dist_init -n 1
   --backend gpu`` (redelivery on, ``NBD_RETRY_TIMEOUT_S=2``):
   ``%dist_lint warn`` and phase 17's 12 requests served in a cell (K4
   once per layer per decode step, the streams equal to phase 17's);
   under ``%dist_lint strict`` a cell with ``dist.all_reduce`` under
   ``if rank == 0`` refused before dispatch (no execute frame sent, no
   cell run on any rank, the group then all-reducing as before),
   ``%%distributed --strict`` running a clean cell and ``%dist_lint
   status`` counting the finding; phase 11's step 4 times as
   synchronous cells and 4 times as ``--async`` cells with a
   proven-free cell streamed beside each (the window deeper than one
   while a training cell holds the collective stream, no edge between
   them in ``%dist_lint deps``; the losses equal to the synchronous
   ones to the last bit, K1/K2/K3 60/30/30 a step read through
   ``%dist_pull``); an errored ``--async`` cell surfacing once at
   ``%dist_wait``; ``NBD_ASYNC_WINDOW=4`` with a ``--sync`` cell
   draining the window first; ``%dist_profile`` around one training
   cell (the kernel events of ``rank<r>/trace.json`` equal the launch
   counters); ``%dist_trace`` (one Chrome trace with spans from the
   coordinator and every rank); ``%dist_metrics``, ``%dist_lat``,
   ``%dist_top`` (each rank's card memory); ``%dist_chaos on --drop
   0.1`` with every cell run once; and 20 trivial cells synchronous
   against ``--async`` plus ``%dist_wait``.  Cells go to
   ``chiprun_out/notebook_async_cells_n<ranks>.json``.

25. (run after phase 24) supervision and diagnosis, through the same
   magics and stand-in shell, a fresh ``%dist_init -n 1 --backend
   gpu`` with short watchdog thresholds (``NBD_HANG_POLL_S=0.25``,
   ``_SKEW_S=3``, ``_STALL_S=5``, ``_GRACE_S=2``) and
   ``NBD_METRICS_PORT`` on a free port: ``/metrics``, ``/healthz`` and
   ``/latency.json`` scraped while phase 11's step runs as a
   ``--repeat 8`` cell (the device-memory gauges equal rank 0's
   heartbeat telemetry, its first loss phase 11's); a cell launching
   K1 in an endless Python loop caught as a ``stall`` (``%dist_status``
   showing the rank stalled first), its stacks dumped (the loop's line
   in ``stacks-rank0.*.txt``) and interrupted (a KeyboardInterrupt
   reply, the worker alive, ``%dist_doctor`` naming verdict, busy age,
   stack and flight events, the next step's loss phase 11's, K1/K2/K3
   60/30/30); ``%%distributed --repeat 20 --deadline 3`` giving a
   ``deadline`` verdict with losses equal to the same cell's without
   it; two steps, ``%dist_checkpoint`` of params and optimizer, the
   uninterrupted steps 3-4, a restore, ``%dist_supervise on`` and rank
   0 SIGKILLed on step 3's cell (``%dist_chaos --kill-rank 0 --kill-at
   1``): the postmortem bundle (manifest naming rank 0, its ring ending
   with the dispatch of that cell, its last memory numbers,
   ``%dist_postmortem --last``), the auto-heal (respawn, restore,
   alive → dead → healing → alive, one restart of the budget), the
   step cell run again and steps 3-4 equal to the uninterrupted ones
   to the last bit (K1/K2/K3 120/60/60), free card memory before the
   kill and after the heal, phase 17's requests served on the healed
   world (streams equal, K4 once per layer per decode step);
   ``%dist_guard status`` and ``audit`` on phase 22's guarded step;
   the step's time with the watchdog armed against a world spawned
   with ``NBD_HANG=0``.  Cells go to
   ``chiprun_out/supervision_cells_n<ranks>.json``;
26. (run after phase 25) the gateway's tenant plane: ``%dist_pool
   start -n 1 --backend gpu --mesh-slots 1 --queue-depth 2
   --tenant-inflight 2 --max-tenants 3`` spawns a gateway daemon and
   its GPU rank; tenant alice (``%dist_attach --tenant alice``, the
   magics) runs phase 11's step as two ``%%distributed`` cells, losses
   equal to phase 11's to the last bit, K1/K2/K3 60/30/30 a step;
   tenant bob (a raw ``TenantClient``) serves phase 17's requests in
   his namespace, streams equal, K4 once per layer per decode step,
   alice's names not in his namespace; admission: a fourth tenant's
   hello refused, carol's cells queued at positions 1 and 2 while bob
   holds the mesh (``%dist_pool status`` naming rank 0 busy for bob),
   her third rejected at her in-flight cap, alice's ``--priority 0``
   cell shed with its visible verdict; alice's connection dropped
   mid-cell, her result parked and delivered exactly once at
   ``%dist_attach --tenant alice`` (epoch 2), a third connection
   fencing the second; a single-kernel session in a child process
   (``%dist_init -n 1``, a CUDA tensor, a running cell) SIGKILLed and
   adopted by ``%dist_attach``: the tensor's checksum unchanged, the
   cell's output delivered once, ``%dist_gc --dry-run`` keeping the
   live pool's run dir.  Then the serving plane (items 8-12, after
   alice, bob and carol have left): tenant srvadmin runs ``%dist_serve
   start --spec SPEC`` (SmolLM2-135M, full width and depth, bf16, seed
   0, ``--max-batch 8 --max-len 1024``) and phase 17's 12 requests (one
   by ``%dist_serve submit --wait``), all completed with 32 tokens,
   ``dup_dropped`` 0, K4 a positive multiple of 30 and at least 30 x 31
   (counts reset and read by srvadmin's cells on the rank; prefill is
   the plain cached attention, so K1's count is reported), the streams'
   equality with phase 17's, tokens/s, TTFT/TPOT and ``%dist_serve
   lat`` reported; the loadgen (3 rps for 10 s, Poisson, seed 0,
   prompts of 16-200 tokens, 32 new) through ``tools/nbd_torch_serve.py``,
   its report valid and nothing hung; a plane at ``--max-batch 1
   --queue-depth 2 --inflight 2`` rejecting at the tenant's cap and
   delivering a shed, and the serving tenant's cell refused naming
   ``%dist_serve``; an fp32 plane stopped while a stream is mid-decode
   and restarted, every request of its journal re-admitted and every
   stream within the near-tie rule of solo ``generate``; and a tenant
   moved with ``%dist_pool migrate`` to a second one-rank pool while
   its streams are unfinished, whose plane adopts the journal and
   finishes them (near-tie), the tenant reattached there with its token
   and an epoch no lower, the first pool no longer knowing it.
   ``%dist_pool stop``: both daemons and every rank gone, free card
   memory back within 1 GB.  Cells go to ``chiprun_out/pool_cells_n1.json``
   and ``pool_serve_cells_n1.json``.
27. (run after phase 26) multi-host launch: a host agent daemon
   (``tools/nbd_torch_agent.py --bind 127.0.1.12 --token-env
   NBD_AGENT_TOKEN``, its own run dir; ``127.0.1.10`` and
   ``127.0.1.12`` must bind, or the phase fails) stands in for a
   second machine; ``%dist_init --hosts 127.0.1.12 --agents
   127.0.1.12=127.0.1.12:PORT --coordinator-addr 127.0.1.10 --backend
   gpu`` spawns the rank through it, the control plane bound on all
   interfaces with a minted token (the host label is the agent's
   address: rank 0 hosts the TCPStore at its host's name).  The
   agent's rank all-reduces on NCCL, runs phase 17's cell (the
   full-width forward, K1 once a layer, and the 12 requests, K4 once a
   layer a decode step, streams equal, no kernel rebuilt) and phase
   11's first two steps (losses equal to the last bit, K1/K2/K3
   60/30/30 a step); SIGKILLed under the agent, its death arrives as
   the agent's pushed exit (the link up, no reconnect), and
   ``%dist_heal`` rebuilds the world through the agent, where the first
   step is redone to the last bit; ``%dist_shutdown`` leaves no child
   under the agent.  The agent's seconds to ready, spawn-to-ready
   through it beside phase 17's local one, a trivial cell's median
   round trip and the seconds from the kill to the pushed exit, to the
   world ready and to the step redone are printed.  Cells go to
   ``chiprun_out/multihost_cells_n1.json``.
28. (run after phase 27) the self-lint, the self-test and the
   quickstart: ``python3 tools/nbd_torch_lint.py --self --format json``
   (started before the kernels' build, collected here) must report all
   ten passes clean; ``python3 -m nbdistributed_tpu_torch.selftest``
   with ``NBD_SELFTEST_FAULTS=1 NBD_SELFTEST_OBS=1`` (one card, so one
   NCCL rank) must exit 0 with "N/N checks passed", N >= 15, its
   model-stack check launching K1 once (fp32, error printed); beside
   it, every code cell of ``examples/00_torch_quickstart.ipynb``, read
   with ``json``, runs in order through ``NotebookSession`` with
   ``%dist_init -n 1 --backend gpu`` (the HF cell is named and skipped
   only where ``transformers`` does not import), the counts reset just
   before each cell and read through ``%dist_pull`` just after: K1, K2
   and K3 once a layer a training step, K1 once a layer an eval, K4
   once a layer a decode step, nothing elsewhere; before its
   ``%dist_shutdown`` the same world serves phase 17's 12 requests
   (streams equal, K4 30 a decode step) and runs ``%dist_lint self``,
   clean.  Cells go to ``chiprun_out/00_torch_quickstart_cells_n1.json``,
   the self-test's report to ``chiprun_out/selftest_n1.txt``.
29. (beside phases 27 and 28, in a process of its own) the fine-tune
   notebook: every cell of ``examples/02_torch_finetune.ipynb`` with
   ``%dist_init -n 1 --backend gpu`` at SmolLM2-135M's full width and
   30 layers: the checkpoint built with ``transformers`` and
   ``save_pretrained`` in the kernel, loaded fp32 on the rank, four DDP
   steps over the README / PARITY / SURVEY rows (K1, K2, K3 30 a
   step), the chunked loss against the full one (K1 60, "match:
   True"), 16 greedy tokens on rank 0 (K4 30 a decode step),
   ``%dist_checkpoint``; then rank 0's
   losses within 1e-4 relative of the same steps on the plain path in
   that process, its batches bitwise those draws, and the continuation
   to plain ``generate`` from the pulled tuned params by the near-tie
   rule.  Cells go to ``chiprun_out/02_torch_finetune_cells_n1.json``,
   the process's output to ``chiprun_out/finetune_n1.txt``.

Phases 7-10 and 13-14 run each server with the launch counts reset
just before and K4's read just after, held to one per layer per decode
step (per round: the draft's launches), and their K4 launches join
phase 5's in the kernels line (``launches_by_path``), as do the
worker's K1 and K4 launches (``cluster_serve``), as the MoE
forward's and MoE training's K1/K2/K3 launches join the SmolLM2
paths', the mesh runs' K4 launches on rank 0 (``mesh_*``) and the
mesh training runs' K1/K2/K3 launches on rank 0 (``train_mesh_*``,
``train_sp_*``, ``grad_sp_*``, ``train_pp_*``), the dots step's
(``train_remat_dots``) and phase 22's (``train_guard_*``,
``train_checkpoint``, ``cluster_guard``), phase 23's
(``notebook_serve``, ``notebook_train``), phase 24's
(``notebook_async_serve``, ``notebook_async_train``), phase 25's
(``supervision_*``), phase 26's (``pool_train``, ``pool_serve``, and
K4's ``serve_plane``, ``serve_plane_loadgen``, ``serve_plane_recovered``
and ``serve_plane_migrated``) and phase 27's (``multihost_serve``,
``multihost_train``, ``multihost_healed_train``) and phase 28's
(``selftest_k1``, ``quickstart_train``, ``quickstart_generate``,
``quickstart_serve``, ``quickstart_smol_serve``) and phase 29's
(``finetune_train``, ``finetune_ce``, ``finetune_generate``).

``python3 chip_smoke.py --mesh-nccl`` runs phases 18, 19, 20 and 21's
ranks, phase 22's guarded replicas, phases 23 and 24
(``%dist_init -n 4``, their references computed first on card 0) and
phase 25's hung collective (``if rank != 3: dist.all_reduce(t)`` then
``t.item()``, ``%dist_lint off``, ladder warn,dump,heal: a ``skew``
verdict naming the ranks stuck inside the all-reduce and rank 3 that
finished, their stacks at the ``.item()`` line, the world healed well
inside the 120 s NCCL timeout and all-reducing 4.0) and phase 26's
resized pool (2 NCCL ranks resized to 4 and back: a tenant's
all-reduce summed after each flip, an all-reduce queued across the
first flip delivered as a stale verdict, a ``%dist_pool template`` replayed on each new fleet, a
resize to 5 refused with the pool still answering; then an fp32
serving plane on both ranks, decode rank 1 SIGKILLed while it holds
requests, the failover to rank 0 and the journal replay, a resize to
4 while requests are in flight, every stream within the near-tie rule
of solo ``generate`` and ``dup_dropped`` 0) and phase 27's two-host
world (``--hosts local:2,hostB:2``, hostB's agent started with
``CUDA_VISIBLE_DEVICES=2,3``: a 4-rank NCCL all-reduce on four
distinct cards summing 10; a seeded control-plane partition of hostB
for 12 s mid-cell under ``%dist_supervise on`` with a 60 s partition
grace: hostB suspected, no heal, the far ranks reattached, the
in-flight result drained exactly once; a SIGKILL under hostB's agent
healed through it by the supervisor) and phase 28's self-test (``-n
2`` with all three gates on cards 0 and 1: its serving smoke's decode
rank SIGKILLed on NCCL) and phase 29's notebooks (the fine-tune with
``-n 2`` on cards 0 and 1, rank 0's losses within 1e-5 of an
in-process emulation of both ranks through the kernels; every cell of
``examples/01_torch_parallelism.ipynb`` on four ranks, each self-check
held, K1 launched in the zigzag cell only and K4 in the sp-sharded
decode cell only, on every rank) alone on four cards, one NCCL
rank per card (what one card cannot show: NCCL, its
``reduce_scatter_tensor``, its point-to-point ring and pipeline hops
overlapping compute, ``all_to_all_single``, and the links between
cards).

Then one JSON line listing the kernels (each with its design, bf16 /
fp32, and ptxas's registers, spills and static shared memory per
instantiation), and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
when there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak, data sheet

N_LAYERS_SMOL = 30


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch
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


def graph_ms(fn, calls=30, reps=10):
    """Device time of one call of ``fn`` in ms: ``calls`` calls captured
    in a CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's launch overhead stays out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def tol_ratio(got, want, atol, rtol):
    """Worst |got - want| / (atol + rtol * |want|) over the elements:
    within tolerance when it is at most 1 (``torch.allclose``'s test)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# The plain side computes in fp32 and rounds once to the output dtype,
# so a bf16 element may differ by one bf16 ulp (at most 2^-7 = 7.8e-3 of
# its magnitude) where two fp32 results straddle a rounding boundary.
# K1 sums its keys in another order (tile by tile, rescaled) and in bf16
# rounds P to bf16 before P.V, as attention_reference does, so it gets
# more room than K4; the lse is fp32 on both sides.  fp32 K4 sums its
# keys in another order (chunks, warps) than the plain version's one
# pass.  Measured errors are in PERF.md beside each limit.
K1_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-5, 1e-5)}
K4_TOL = {"bfloat16": (1e-3, 8e-3), "float32": (1e-5, 1e-5)}
LSE_TOL = 1e-4
# K2/K3 sum up to S * group terms per element (dK/dV over every row of
# the group that sees a key), in tiles, where the plain version sums in
# one GEMM: bf16 keeps K1's room (K3 feeds P and dS to the tensor cores
# as bf16 hi + lo pairs: one rounding alone goes past it); fp32 allows
# the longer sums' reassociation (~1e-6 of the sum of |terms|, ~10-100).
K23_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-4, 1e-4)}
# fp32 loss and gradients through the kernels against the plain path
# (autograd of attention_reference), relative L2 per leaf: 30 layers of
# fp32 sums in different orders, each ~1e-6 relative.
TRAIN_FP32_TOL = 1e-4


# ----------------------------------------------------------------------
# phase 2: K1 against its plain version

def k1_inputs(B, S, H, Hkv, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def case_segments(kind, B, S):
    """Segment ids (B, S), int32 on the card: None; ``"cuts"``, the same
    documents in every row, cut at 300, 301 and 700; or ``"train"``, the
    training path's own batch (``packed_batch``, documents of 64-1536
    tokens packed by ``pack_tokens``)."""
    import torch
    if kind is None:
        return None
    if kind == "train":
        from nbdistributed_tpu_torch.models import smol_135m_config
        seg = packed_batch(smol_135m_config(), B, S,
                           seed=TRAIN_BATCH_SEED)["segments"]
        return seg.to(torch.int32).contiguous()
    cuts = torch.tensor([0, 300, 301, 700, S])
    seg = torch.bucketize(torch.arange(S), cuts[1:-1], right=True)
    return seg[None].expand(B, S).to("cuda", torch.int32).contiguous()


def check_k1(name, out, lse, ref, ref_lse, dtype):
    """Hold K1's (out, lse) to the plain version's; returns the output's
    max abs error."""
    import torch
    atol, rtol = K1_TOL[str(dtype).split(".")[-1]]
    e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
    ratio = tol_ratio(out, ref, atol, rtol)
    say("k1_vs_plain", case=name, max_abs_err=e_out, tol_ratio=ratio,
        atol=atol, rtol=rtol, lse_err=e_lse, lse_tol=LSE_TOL)
    check(torch.isfinite(out.float()).all().item(),
          f"K1 {name}: non-finite output")
    check(ratio <= 1 and e_lse <= LSE_TOL,
          f"K1 {name}: error {e_out} (ratio {ratio}) / lse {e_lse} "
          f"over tolerance")
    return e_out


def phase_k1():
    """K1 through the wrappers the path calls — ``flash_attention`` for
    the output, ``_flash_forward`` (the JAX counterpart's entry, which
    returns the lse) — against ``_flash_forward_plain``: one 64 x 64
    tile (the tensor-core layout alone), group 1, the serving shapes,
    the training path's (B=4, S=2048, without and with its batch's
    segments) and Mixtral's attention (H=32, Hkv=8, D=128) in bf16 and
    fp32."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    bf16, fp32 = torch.bfloat16, torch.float32
    # name, B, S, H, Hkv, D, dtype, window, segments
    cases = [("one_tile_S64", 1, 64, 1, 1, 64, bf16, None, None),
             ("group1_S1024", 2, 1024, 4, 4, 64, bf16, None, None),
             ("causal_S1024", 2, 1024, 9, 3, 64, bf16, None, None),
             ("causal_ragged_S1000", 2, 1000, 9, 3, 64, bf16, None, None),
             ("window256_S1024", 2, 1024, 9, 3, 64, bf16, 256, None),
             ("segments_S1024", 2, 1024, 9, 3, 64, bf16, None, "cuts"),
             ("forward_shape_S512", 1, 512, 9, 3, 64, bf16, None, None),
             ("train_shape_S2048", TRAIN_B, 2048, 9, 3, 64, bf16, None,
              None),
             ("train_shape_S2048_segments", TRAIN_B, 2048, 9, 3, 64, bf16,
              None, "train"),
             ("fp32_ragged_S1000", 2, 1000, 9, 3, 64, fp32, None, None),
             ("mixtral_S2048_g4_D128", 1, 2048, 32, 8, 128, bf16, None,
              None),
             ("fp32_mixtral_S2048_g4_D128", 1, 2048, 32, 8, 128, fp32, None,
              None)]
    worst = 0.0
    for name, B, S, H, Hkv, D, dtype, window, segs in cases:
        q, k, v = k1_inputs(B, S, H, Hkv, D, dtype, seed=len(name))
        seg = case_segments(segs, B, S)
        scale = 1.0 / D ** 0.5
        out = A.flash_attention(q, k, v, causal=True, scale=scale,
                                window=window, segment_ids=seg)
        out2, lse = A._flash_forward(q, k, v, causal=True, scale=scale,
                                     window=window, segment_ids=seg)
        torch.cuda.synchronize()
        ref, ref_lse = A._flash_forward_plain(
            q, k, v, causal=True, scale=scale, window=window,
            segment_ids=seg, kv_segment_ids=seg)
        e_out = check_k1(name, out, lse, ref, ref_lse, dtype)
        check(torch.equal(out, out2), f"K1 {name}: flash_attention and "
              f"_flash_forward disagree")
        if dtype == torch.bfloat16:
            worst = max(worst, e_out)
    return worst


# ----------------------------------------------------------------------
# phase 3: K4 against its plain version

def serving_pos(B):
    """Decode positions as the main path's 16..232-token streams give
    them (prompts of 16-200 tokens plus up to 32 new ones)."""
    import torch
    g = torch.Generator().manual_seed(3)
    return torch.randint(16, 233, (B,), generator=g).to("cuda", torch.int32)


def k4_inputs(B, Hkv, group, D, T, cache, seed, pos=None,
              qdtype=None):
    """Decode inputs on the card: q (B, H, D) in ``qdtype`` (bf16, or
    fp32 for an fp32 cache); a (B, Hkv, T, D) cache, ``cache`` one of
    "bf16", "fp32" or "int8" (with (B, Hkv, T, 1) fp32 scales); pos, by
    default spread over [0, T-1]."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    fp32 = cache == "fp32"
    qdtype = qdtype or (torch.float32 if fp32 else torch.bfloat16)
    q = torch.randn(B, Hkv * group, D, generator=g, device="cuda").to(qdtype)
    ks = vs = None
    if cache == "int8":
        kc = torch.randint(-127, 128, (B, Hkv, T, D), generator=g,
                           device="cuda").to(torch.int8)
        vc = torch.randint(-127, 128, (B, Hkv, T, D), generator=g,
                           device="cuda").to(torch.int8)
        ks = torch.rand(B, Hkv, T, 1, generator=g, device="cuda") * 0.02
        vs = torch.rand(B, Hkv, T, 1, generator=g, device="cuda") * 0.02
    else:
        cdt = torch.float32 if fp32 else torch.bfloat16
        kc = torch.randn(B, Hkv, T, D, generator=g, device="cuda").to(cdt)
        vc = torch.randn(B, Hkv, T, D, generator=g, device="cuda").to(cdt)
    if pos is None:
        pos = torch.linspace(0, T - 1, B).round().to("cuda", torch.int32)
    return q, kc, vc, ks, vs, pos


def past_valid_pos(B, T):
    """Positions over [0, T-1] with the last two rows past the cache
    (the sequence-parallel caller's case): with window 256, row B-1
    (pos T+300) attends nothing (lo >= valid_k) and row B-2 (pos T+100)
    the cache's last 155 keys."""
    import torch
    pos = torch.linspace(0, T - 1, B).round().to(torch.int32)
    pos[-1], pos[-2] = T + 300, T + 100
    return pos.to("cuda")


def shard_pos(values):
    import torch
    return torch.tensor(values, dtype=torch.int32, device="cuda")


def phase_k4():
    """K4 through ``flash_decode_attention``, the wrapper the path
    calls, against ``decode_reference``: per-row positions over [0, T-1]
    at T=2048 with a window and int8 variants, fp32 caches, T=1000
    (ragged against the 128-key chunk), rows whose window lies past
    every valid key, groups 1 and 8, D=32 and 128 in each cache type
    (every key-tile geometry of the kernel), one chunk (B*Hkv=576:
    nsplit = 1, no combine), and the main path's own shape (B=8 slots,
    T=max_len=1024, serving positions), its full context (T=2048, every
    slot at 2047), a paged step's gathered view (±3e4 past every row's
    position) and the Mixtral serving shape (Hkv=8, group 4, D=128,
    T=1024) in bf16, int8 and fp32; and the mesh phase's shard shapes
    (SmolLM2's dp x sp rank: B=4, Hkv=3, T=512 and the path's T=128;
    Mixtral's tp x sp rank: Hkv=4, group 4, D=128) at shifted positions,
    negative and past the slice, and with a window wholly past it.
    Returns the worst bf16 output error."""
    import torch
    from nbdistributed_tpu_torch.ops import decode as K
    from nbdistributed_tpu_torch.ops._common import NEG_INF

    fp32 = torch.float32
    # name, B, Hkv, group, D, T, window, cache, positions, q dtype
    cases = [("pos_spread", 8, 3, 3, 64, 2048, None, "bf16", None, None),
             ("window256", 8, 3, 3, 64, 2048, 256, "bf16", None, None),
             ("int8_scales", 8, 3, 3, 64, 2048, None, "int8", None, None),
             ("int8_window256", 8, 3, 3, 64, 2048, 256, "int8", None, None),
             ("fp32_pos_spread", 8, 3, 3, 64, 2048, None, "fp32", None,
              None),
             ("ragged_T1000", 8, 3, 3, 64, 1000, None, "bf16", None, None),
             ("window_past_valid_T1000", 8, 3, 3, 64, 1000, 256, "bf16",
              "past", None),
             ("fp32_window_past_valid_T1000", 8, 3, 3, 64, 1000, 256,
              "fp32", "past", None),
             ("group1_T1000", 8, 9, 1, 64, 1000, None, "bf16", None, None),
             ("group8_T1000", 8, 1, 8, 64, 1000, 256, "bf16", "past", None),
             ("D32_T1000", 8, 3, 3, 32, 1000, None, "bf16", None, None),
             ("D128_T1000", 8, 3, 3, 128, 1000, None, "bf16", None, None),
             ("fp32_D32_T1000", 8, 3, 3, 32, 1000, None, "fp32", None, None),
             ("fp32_D128_T1000", 8, 3, 3, 128, 1000, None, "fp32", None,
              None),
             ("int8_D32_T1000", 8, 3, 3, 32, 1000, None, "int8", None, None),
             ("int8_D128_T1000", 8, 3, 3, 128, 1000, None, "int8", None,
              None),
             ("int8_fp32q_T1000", 8, 3, 3, 64, 1000, 256, "int8", "past",
              fp32),
             ("one_chunk_B64_T1000", 64, 9, 1, 64, 1000, 256, "bf16",
              "past", None),
             ("serving_shape_T1024", 8, 3, 3, 64, 1024, None, "bf16",
              "serving", None),
             ("paged_view_garbage_T1024", 8, 3, 3, 64, 1024, None, "bf16",
              "garbage", None),
             ("full_context_T2048", 8, 3, 3, 64, 2048, None, "bf16", "full",
              None),
             ("mixtral_g4_D128_T1024", 8, 8, 4, 128, 1024, None, "bf16",
              "serving", None),
             ("int8_mixtral_g4_D128_T1024", 8, 8, 4, 128, 1024, None,
              "int8", "serving", None),
             ("fp32_mixtral_g4_D128_T1024", 8, 8, 4, 128, 1024, None,
              "fp32", "serving", None),
             # The mesh phase's shard shapes: a dp x sp rank's (B=4 of 8
             # slots, T/2 of the cache) and Mixtral's tp x sp rank's
             # (Hkv=4 of 8), at positions shifted by the slice's offset:
             # negative (the slice holds none of the row's keys), inside,
             # and past it (all of them); a window wholly past the slice.
             ("shard_T512_shifted", 4, 3, 3, 64, 512, None, "bf16",
              "shard", None),
             ("fp32_shard_T512_shifted", 4, 3, 3, 64, 512, None, "fp32",
              "shard", None),
             ("shard_T512_window_past_slice", 4, 3, 3, 64, 512, 256,
              "bf16", "shard_window", None),
             ("fp32_shard_T512_window_past_slice", 4, 3, 3, 64, 512, 256,
              "fp32", "shard_window", None),
             ("shard_mixtral_g4_D128_T512", 8, 4, 4, 128, 512, None, "bf16",
              "shard_shifted", None),
             ("fp32_shard_mixtral_g4_D128_T512", 8, 4, 4, 128, 512, None,
              "fp32", "shard_shifted", None),
             ("fp32_shard_path_T128", 4, 3, 3, 64, MESH_MAX_LEN // 2, None,
              "fp32", "shard_shifted", None),
             ("fp32_shard_mixtral_path_g4_D128_T128", 8, 4, 4, 128,
              MESH_MAX_LEN // 2, None, "fp32", "shard_shifted", None)]
    worst = 0.0
    for name, B, Hkv, group, D, T, window, cache, kind, qdt in cases:
        pos = {None: None, "past": past_valid_pos(B, T),
               "serving": serving_pos(B), "garbage": serving_pos(B),
               "full": torch.full((B,), T - 1, dtype=torch.int32,
                                  device="cuda"),
               "shard": shard_pos([-300, -1, T // 2, T + 300]),
               "shard_window": shard_pos([-5, T // 4, T + 88, T + 300]),
               "shard_shifted": serving_pos(B) - 128}[kind]
        q, kc, vc, ks, vs, pos = k4_inputs(B, Hkv, group, D, T, cache,
                                           seed=len(name), pos=pos,
                                           qdtype=qdt)
        if kind == "garbage":
            # A paged step's dense view: whatever the trash and unwritten
            # blocks hold (finite) lies past each row's position and
            # must reach no output.
            past = (torch.arange(T, device="cuda")[None, :]
                    > pos.long()[:, None])[:, None, :, None]
            kc.masked_fill_(past, 3e4)
            vc.masked_fill_(past, -3e4)
        out, lse = K.flash_decode_attention(q, kc, vc, pos, scale=0.125,
                                            window=window, k_s=ks, v_s=vs,
                                            return_lse=True)
        out_nolse = K.flash_decode_attention(q, kc, vc, pos, scale=0.125,
                                             window=window, k_s=ks, v_s=vs)
        torch.cuda.synchronize()
        ref, ref_lse = K.decode_reference(q, kc, vc, pos, scale=0.125,
                                          window=window, k_s=ks, v_s=vs)
        atol, rtol = K4_TOL[str(q.dtype).split(".")[-1]]
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        ratio = tol_ratio(out, ref, atol, rtol)
        same = torch.equal(out, out_nolse)
        # Rows that attend nothing: exactly o = 0 and lse = NEG_INF.
        valid = pos.long() + 1
        lo = valid - window if window else torch.zeros_like(valid)
        empty = torch.clamp(lo, min=0) >= torch.clamp(valid, min=0, max=T)
        n_empty = int(empty.sum())
        empty_ok = bool((out[empty] == 0).all()
                        and (lse[empty] == NEG_INF).all())
        say("k4_vs_plain", case=name, dtype=str(q.dtype), cache=cache,
            nsplit_chunk=K._decode_splits(B * Hkv, T), max_abs_err=e_out,
            tol_ratio=ratio, atol=atol, rtol=rtol, lse_err=e_lse,
            lse_tol=LSE_TOL, lse_off_identical=same,
            rows_attending_nothing=n_empty, those_rows_exact=empty_ok)
        check(torch.isfinite(out.float()).all().item(), f"K4 {name}: "
              f"non-finite output")
        check(ratio <= 1 and e_lse <= LSE_TOL and same and empty_ok,
              f"K4 {name}: error {e_out} (ratio {ratio}) / lse {e_lse} "
              f"over tolerance, or a row that attends nothing is not "
              f"o = 0, lse = NEG_INF")
        want_empty = {"past": n_empty > 0, "shard": n_empty == 2,
                      "shard_window": n_empty == 2,
                      "shard_shifted": 0 < n_empty < B}.get(kind,
                                                            n_empty == 0)
        check(want_empty, f"K4 {name}: {n_empty} rows attend nothing")
        if q.dtype == torch.bfloat16:
            worst = max(worst, e_out)
    return worst


# ----------------------------------------------------------------------
# phase 4: K2/K3 against the plain backward

def check_k23(name, got, want, dtype):
    """Hold K2/K3's (dq, dk, dv) to the plain backward's; returns
    ``{grad: {max_abs_err, tol_ratio}}``."""
    import torch
    atol, rtol = K23_TOL[str(dtype).split(".")[-1]]
    row = {}
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"K2/K3 {name}: {gname} is {a.dtype} {tuple(a.shape)}")
        check(torch.isfinite(a.float()).all().item(),
              f"K2/K3 {name}: non-finite {gname}")
        row[gname] = dict(max_abs_err=max_err(a, b),
                          tol_ratio=tol_ratio(a, b, atol, rtol))
    say("k23_vs_plain", case=name, atol=atol, rtol=rtol, **row)
    for gname, r in row.items():
        check(r["tol_ratio"] <= 1, f"K2/K3 {name}: {gname} error "
              f"{r['max_abs_err']} (ratio {r['tol_ratio']}) over tolerance")
    return row


def phase_k23():
    """K2/K3 through ``_flash_backward`` — the wrapper the autograd
    backward calls, which launches K2 then K3 — against
    ``_flash_backward_plain`` on the same inputs, with the forward's
    (out, lse) from K1, held first to the plain forward's; Mixtral's
    attention (S=2048, H=32, Hkv=8, D=128) in bf16 and fp32 among the
    cases.  Returns the worst bf16 errors of K2, K3 and those K1
    forwards."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    bf16, fp32 = torch.bfloat16, torch.float32
    # name, B, Sq, Sk, H, Hkv, D, dtype, causal, window, segments, offsets
    cases = [
        ("one_tile_S64", 1, 64, 64, 1, 1, 64, bf16, True, None, None,
         (0, 0)),
        ("group1_S1024", 2, 1024, 1024, 4, 4, 64, bf16, True, None, None,
         (0, 0)),
        ("causal_S2048_g3_D64", 2, 2048, 2048, 9, 3, 64, bf16, True, None,
         None, (0, 0)),
        ("causal_S2048_g3_D128", 1, 2048, 2048, 6, 2, 128, bf16, True,
         None, None, (0, 0)),
        ("noncausal_Sq1000_Sk1500", 2, 1000, 1500, 9, 3, 64, bf16, False,
         None, None, (0, 0)),
        ("window256_S1024", 2, 1024, 1024, 9, 3, 64, bf16, True, 256,
         None, (0, 0)),
        ("segments_S1024", 2, 1024, 1024, 9, 3, 64, bf16, True, None,
         "cuts", (0, 0)),
        ("offsets_q512_Sq512_Sk1024", 2, 512, 1024, 9, 3, 64, bf16, True,
         None, None, (512, 0)),
        ("D32_causal_S1000", 2, 1000, 1000, 4, 2, 32, bf16, True, None,
         None, (0, 0)),
        ("train_shape_S2048_segments", TRAIN_B, 2048, 2048, 9, 3, 64, bf16,
         True, None, "train", (0, 0)),
        ("fp32_causal_ragged_S1000", 2, 1000, 1000, 9, 3, 64, fp32, True,
         None, None, (0, 0)),
        ("mixtral_S2048_g4_D128", 1, 2048, 2048, 32, 8, 128, bf16, True,
         None, None, (0, 0)),
        ("fp32_mixtral_S2048_g4_D128", 1, 2048, 2048, 32, 8, 128, fp32,
         True, None, None, (0, 0)),
    ]
    worst = {"dq": 0.0, "dkv": 0.0, "k1": 0.0}
    for (name, B, Sq, Sk, H, Hkv, D, dtype, causal, window, segs,
         offsets) in cases:
        g = torch.Generator(device="cuda").manual_seed(len(name))
        q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        seg = case_segments(segs, B, Sq)
        args = dict(causal=causal, scale=1.0 / D ** 0.5, offsets=offsets,
                    window=window, segment_ids=seg, kv_segment_ids=seg)
        out, lse = A._flash_forward(q, k, v, **args)
        got = A._flash_backward(q, k, v, out, lse, do, **args)
        torch.cuda.synchronize()
        e_k1 = check_k1(f"{name} (K2/K3 input)", out, lse,
                        *A._flash_forward_plain(q, k, v, **args), dtype)
        want = A._flash_backward_plain(q, k, v, out, lse, do, **args)
        row = check_k23(name, got, want, dtype)
        if dtype == bf16:
            worst["k1"] = max(worst["k1"], e_k1)
            worst["dq"] = max(worst["dq"], row["dq"]["max_abs_err"])
            worst["dkv"] = max(worst["dkv"], row["dk"]["max_abs_err"],
                               row["dv"]["max_abs_err"])
    return worst


# ----------------------------------------------------------------------
# phase 5: the serving path

def make_requests(cfg, n=12, seed=11):
    import torch
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 201, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (L,), generator=g).tolist()
            for L in lens]


def serve(params, cfg, prompts, max_new=32, **server_kw):
    """Serve ``prompts`` staggered (waves of 5, 4 and the rest, three
    steps apart) on ``DecodeServer(max_batch=8, max_len=1024,
    **server_kw)``; returns (outputs, decode steps, wall seconds,
    per-step seconds, run): ``run`` holds the server and ``waited``, the
    requests that were pending at a moment a slot was free (a paged
    pool's admissions that waited for blocks)."""
    import torch
    from nbdistributed_tpu_torch.models import DecodeServer

    srv = DecodeServer(params, cfg, **{**dict(max_batch=8, max_len=1024),
                                       **server_kw})
    waves = [prompts[:5], prompts[5:9], prompts[9:]]
    rids, steps, step_s, waited = [], 0, [], set()

    def note_waiting():
        if srv._free:
            waited.update(r for r, _, _ in srv._pending)

    def one_step():
        nonlocal steps
        ts = time.perf_counter()
        if srv.step():
            steps += 1
            step_s.append(time.perf_counter() - ts)
        note_waiting()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        rids += [srv.submit(p, max_new) for p in wave]
        note_waiting()
        for _ in range(3):
            one_step()
    while not srv.done():
        one_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([srv.outputs[r] for r in rids], steps, wall, step_s,
            dict(server=srv, waited=len(waited)))


def phase_main_path(seed=0):
    """Counts reset, full-width forward + bf16 serving, counts read."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, init_params,
                                                smol_135m_config)
    from nbdistributed_tpu_torch.ops import (flash_attention,
                                             flash_decode_attention)

    cfg = smol_135m_config()
    params = init_params(cfg, seed)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    prompts = make_requests(cfg)

    reset_launch_counts()
    logits = forward(params, tokens, cfg)
    outputs, steps, wall, step_s, _ = serve(params, cfg, prompts)
    k1 = flash_attention.launches
    k4 = flash_decode_attention.launches
    say("main_path_counts", k1_launches=k1, k4_launches=k4,
        decode_steps=steps, want_k1=N_LAYERS_SMOL,
        want_k4=N_LAYERS_SMOL * steps)
    check(k1 == N_LAYERS_SMOL, f"K1 launched {k1} times, want 30")
    check(steps > 0 and k4 == N_LAYERS_SMOL * steps,
          f"K4 launched {k4} times over {steps} decode steps")

    n_tok = sum(len(o) for o in outputs)
    check(all(len(o) == 32 for o in outputs), "a request fell short")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
          "token out of vocabulary")
    step_s = sorted(step_s)
    say("serve_bf16", requests=len(outputs), tokens=n_tok,
        decode_steps=steps, wall_s=wall, tokens_per_s=n_tok / wall,
        ms_per_step_mean=1e3 * sum(step_s) / len(step_s),
        ms_per_step_median=1e3 * step_s[len(step_s) // 2])

    # The kernel path's logits against the plain path's (both bf16):
    # every layer rounds its attention output to bf16 in a different
    # place, so hold the relative L2 error to 5e-2.
    plain = forward(params, tokens, dataclasses.replace(cfg,
                                                        use_flash=False))
    check(torch.isfinite(logits).all().item() and logits.shape ==
          (1, 512, cfg.vocab_size), "forward: bad logits")
    rel = float((logits - plain).norm() / plain.norm())
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    say("forward_bf16", rel_l2_err=rel, tol=5e-2, argmax_agree=agree,
        max_abs_err=max_err(logits, plain))
    check(rel <= 5e-2, f"forward bf16: relative error {rel}")
    dense = dict(outputs=outputs, tokens_per_s=n_tok / wall,
                 ms_per_step_median=1e3 * step_s[len(step_s) // 2])
    return {"k1": k1, "k4": k4, "steps": steps}, prompts, params, dense


def profile_steps(step, n_steps):
    """``torch.profiler`` over ``n_steps`` calls of ``step``: device
    kernel time per step against the host's wall time, kernels per step
    and the kernels that take the most time.  Kernel times are summed,
    so work that overlaps counts twice: the device's idle share is the
    benchmark's (``benchmark/metrics/idle_share.py``, from the union of
    device intervals), not read here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    kernels = []
    for e in prof.key_averages():
        # A user annotation (``Optimizer.step#AdamW.step``) spans kernels
        # already counted: it is a range, not device work.
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3 / n_steps, e.count / n_steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return dict(wall_ms_per_step=wall_ms,
                device_ms_per_step=busy if kernels else "not measured",
                kernels_per_step=sum(k[1] for k in kernels),
                top=[dict(name=k[2][:80], ms_per_step=k[0],
                          calls_per_step=k[1]) for k in kernels[:8]])


def phase_profile(params, n_steps=8, name="profile_decode_step", cfg=None,
                  **server_kw):
    """Where a bf16 decode step's time goes: a profile of ``n_steps``
    steps of a full 8-slot server (128-token prompts) of ``cfg``
    (SmolLM2-135M by default), built with ``server_kw`` (a paged or a
    speculative server)."""
    import torch
    from nbdistributed_tpu_torch.models import (DecodeServer,
                                                smol_135m_config)

    cfg = cfg or smol_135m_config()
    srv = DecodeServer(params, cfg, max_batch=8, max_len=1024, **server_kw)
    g = torch.Generator().manual_seed(13)
    for _ in range(8):
        srv.submit(torch.randint(0, cfg.vocab_size, (128,),
                                 generator=g).tolist(), 8 * n_steps + 16)
    srv.step()
    srv.step()
    row = profile_steps(srv.step, n_steps)
    say(name, **row)
    return row


# A served fp32 stream may leave its reference only where the
# reference's top-2 logits are this close: the two runs sum in other
# orders (batch shapes, the verify's S = gamma + 1, a chunk's or a
# suffix's prefill), ~1e-6 apart at SmolLM2's width.
NEAR_TIE = 1e-4


def near_tie_check(name, params, cfg, prompts, got, want):
    """Hold served fp32 streams ``got`` to their references ``want``
    (solo ``generate`` or another server), token for token, except at a
    near-tie: where stream i first differs at step j, the reference's
    top-2 logit gap after ``prompts[i] + want[i][:j]`` (one fresh
    prefill) must be below NEAR_TIE.  Prints and returns the gaps."""
    import torch
    from nbdistributed_tpu_torch.models import (forward_with_cache,
                                                init_kv_cache)

    gaps = []
    for prompt, g, w in zip(prompts, got, want):
        check(len(g) == len(w), f"{name}: {len(g)} tokens, reference "
              f"{len(w)}")
        j = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None:
            continue
        cache = init_kv_cache(cfg, 1, len(prompt) + j, device="cuda")
        logits, _ = forward_with_cache(params, [prompt + w[:j]], cache, 0,
                                       cfg, last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        gaps.append(gap)
        check(gap < NEAR_TIE, f"{name}: diverged from its reference at "
              f"step {j} where the reference's top-2 gap is {gap}")
    say(name, requests=len(got), divergences_at_near_ties=len(gaps),
        gaps=gaps, near_tie=NEAR_TIE)
    return gaps


def solo_outputs(params, cfg, prompts, max_new=32):
    """Each prompt's ``max_new`` tokens from a solo ``generate``."""
    from nbdistributed_tpu_torch.models import generate
    return [generate(params, [p], cfg, max_new)[0, len(p):].tolist()
            for p in prompts]


def phase_fp32(prompts, seed=0):
    """fp32 forward kernel vs plain, and fp32 serving vs solo generate
    under the near-tie rule.  Returns the fp32 parameters and the solo
    outputs, which the later serving paths reuse as references."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, init_params,
                                                smol_135m_config)

    cfg = smol_135m_config(dtype=torch.float32)
    params = init_params(cfg, seed)
    g = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    a = forward(params, tokens, cfg)
    b = forward(params, tokens, smol_135m_config(dtype=torch.float32,
                                                 use_flash=False))
    rel = float((a - b).norm() / b.norm())
    say("forward_fp32", rel_l2_err=rel, tol=1e-4, max_abs_err=max_err(a, b))
    check(rel <= 1e-4, f"forward fp32: relative error {rel}")

    outputs, steps, _, _, _ = serve(params, cfg, prompts)
    solo = solo_outputs(params, cfg, prompts)
    near_tie_check("serve_fp32_vs_solo", params, cfg, prompts, outputs, solo)
    say("serve_fp32", requests=len(prompts), decode_steps=steps)
    return params, solo


# ----------------------------------------------------------------------
# phases 7-10: serving beyond the dense pool.  Every server run below
# has its counts reset just before and K4's read just after, held to
# what the run must launch; a path's launches are its own servers'
# runs, not those of the dense or unprefixed servers it is held to.

PAGED = dict(kv_block_tokens=64, kv_blocks=16)   # 1/8 of the dense pool
GAMMA = 4
# SmolLM2's depth in phases 7-10 (10 of its 30 layers, full width), held
# to a dense bf16 server and solo fp32 generate at that depth: the
# script's time budget (PERF.md §4).  Every check holds per layer.
SBD_LAYERS = 10


def sbd_cfg(**kw):
    from nbdistributed_tpu_torch.models import smol_135m_config
    return smol_135m_config(n_layers=SBD_LAYERS, **kw)


def k4_launches():
    from nbdistributed_tpu_torch.ops import flash_decode_attention
    return flash_decode_attention.launches


def counted_serve(path, want_per_step, params, cfg, prompts, **kw):
    """``serve`` as one run of ``path``: counts reset just before, K4's
    read just after, which must be ``want_per_step`` per decode step
    (per round on a speculative server).  Returns serve's result and
    the run's K4 launches."""
    reset_launch_counts()
    out = serve(params, cfg, prompts, **kw)
    k4, steps = k4_launches(), out[1]
    check(steps > 0 and k4 == want_per_step * steps,
          f"{path}: K4 launched {k4} times over {steps} steps, want "
          f"{want_per_step} per step")
    return out, k4


def gather_costs(cfg):
    """Device time (CUDA-graph replay: each is a handful of launches
    that take the host longer to launch than the card to run) of the paged
    step's gather (every slot's 16 blocks into the dense (L, 8, Hkv,
    1024, D) view, K and V) and of its one-block-per-slot scatter, bf16,
    at the serving shape."""
    import torch
    from nbdistributed_tpu_torch.models import paged_kv

    pool = paged_kv.make_paged_pool(cfg, 8 * 16, 64, device="cuda")
    table = torch.arange(8 * 16, dtype=torch.int32,
                         device="cuda").reshape(8, 16)
    dense = paged_kv.gather_dense(pool, table)
    pos = serving_pos(8)
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    gather = graph_ms(lambda: paged_kv.gather_dense(pool, table), 10, 5)
    scatter = graph_ms(lambda: paged_kv.scatter_step(
        pool, dense, table, pos, active, 8 * 16, 64), 10, 5)
    nbytes = 2 * sum(t.numel() * t.element_size() for t in dense.values())
    return dict(gather_ms=gather, scatter_ms=scatter, gather_bytes=nbytes,
                gather_bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def phase_serve_paged(params, prompts, dense, params32, solo32):
    """The paged server (bf16, 16 blocks of 64 tokens: 1/8 of the dense
    pool's 128) on phase 5's requests: token for token the dense bf16
    server's, with admissions that waited for blocks while a slot was
    free and every block back at the end; then, on 8 of them, int8 KV
    paged against int8 KV dense and fp32 paged against solo generate
    (near-tie rule)."""
    cfg = sbd_cfg()
    L = SBD_LAYERS
    (outs, steps, wall, step_s, run), k4 = counted_serve(
        "serve_paged", L, params, cfg, prompts, **PAGED)
    snap = run["server"].kv_snapshot()
    step_s = sorted(step_s)
    n_tok = sum(len(o) for o in outs)
    say("serve_paged_bf16", requests=len(outs), decode_steps=steps,
        k4_launches=k4, want_k4=L * steps, waited_for_blocks=run["waited"],
        kv_snapshot_end=snap, equal_to_dense=outs == dense["outputs"],
        tokens_per_s=n_tok / wall, dense_tokens_per_s=dense["tokens_per_s"],
        ms_per_step_median=1e3 * step_s[len(step_s) // 2],
        dense_ms_per_step_median=dense["ms_per_step_median"])
    check(outs == dense["outputs"], "paged bf16 serving differs from the "
          "dense bf16 server")
    check(run["waited"] > 0, "no admission waited for blocks")
    check(snap["used"] == 0 and snap["owners"] == {},
          f"blocks still held at the end: {snap}")
    total = k4

    (int8_dense, *_), _ = counted_serve("serve_paged", L, params, cfg,
                                        prompts[:8], kv_quantized=True)
    (int8_paged, *_), k4 = counted_serve("serve_paged", L, params, cfg,
                                         prompts[:8], kv_quantized=True,
                                         **PAGED)
    total += k4
    say("serve_paged_int8_kv", equal_to_dense_int8_kv=int8_paged ==
        int8_dense)
    check(int8_paged == int8_dense, "paged int8-KV serving differs from "
          "the dense int8-KV server")

    cfg32 = sbd_cfg(dtype=params32["embed"].dtype)
    (outs32, *_), k4 = counted_serve("serve_paged", L, params32, cfg32,
                                     prompts[:8], **PAGED)
    total += k4
    near_tie_check("serve_paged_fp32_vs_solo", params32, cfg32, prompts[:8],
                   outs32, solo32[:8])
    costs = gather_costs(cfg)
    say("paged_gather_cost", **costs)
    profile = phase_profile(params, 4, name="profile_paged_step", cfg=cfg,
                            kv_block_tokens=64)
    return dict(k4=total, steps=steps, costs=costs, profile=profile,
                waited=run["waited"], tokens_per_s=n_tok / wall)


def truncated_draft(params, n_layers=2):
    """The target's first ``n_layers`` layers with its embed, final norm
    and lm_head (views, no copy)."""
    return dict(params, layers={k: v[:n_layers]
                                for k, v in params["layers"].items()})


def self_draft_rounds(params, cfg, prompts, max_new=32):
    """fp32 self-draft (draft = target): serve ``prompts``, and for each
    round in which a stream accepted fewer than GAMMA proposals though
    its budget allowed more, the target's top-2 gap at the first
    rejection (a fresh prefill of the stream up to the position the
    target corrected).  Returns (rounds, those gaps, outputs, K4)."""
    import torch
    from nbdistributed_tpu_torch.models import (DecodeServer,
                                                forward_with_cache,
                                                init_kv_cache)

    srv = DecodeServer(params, cfg, max_batch=8, max_len=1024,
                       draft_params=params, draft_cfg=cfg, gamma=GAMMA)
    reset_launch_counts()
    rids = [srv.submit(p, max_new) for p in prompts]
    rounds, short = 0, []
    while not srv.done():
        before = {r: len(srv.outputs[r]) for r in rids}
        emitted = srv.step()
        rounds += bool(emitted)
        for rid, toks in emitted.items():
            if len(toks) < min(GAMMA + 1, max_new - before[rid]):
                short.append((rid, before[rid] + len(toks) - 1))
    k4 = k4_launches()
    gaps = []
    for rid, j in short:
        ctx = srv.prompts[rid] + srv.outputs[rid][:j]
        cache = init_kv_cache(cfg, 1, len(ctx), device="cuda")
        logits, _ = forward_with_cache(params, [ctx], cache, 0, cfg,
                                       last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        gaps.append(float(top2[0] - top2[1]))
    return rounds, gaps, [srv.outputs[r] for r in rids], k4


def phase_serve_speculative(params, prompts, dense, params32, solo32):
    """Speculative serving, gamma 4, draft = the target's first 2
    layers: fp32 on 8 requests against solo generate (near-tie rule);
    fp32 self-draft, every round accepting all 4 but at near-ties; bf16
    on the 12 requests: tokens per round, ms per round, tokens/s.  Each
    round launches K4 (gamma + 1) x 2 times (the draft's 4 proposals and
    its extra write); the target's verify (S = 5) launches none."""
    from nbdistributed_tpu_torch.models import smol_135m_config

    cfg32 = sbd_cfg(dtype=params32["embed"].dtype)
    want_per_round = (GAMMA + 1) * 2
    spec32 = dict(draft_params=truncated_draft(params32),
                  draft_cfg=smol_135m_config(dtype=cfg32.dtype, n_layers=2),
                  gamma=GAMMA)
    (outs32, rounds32, *_), total = counted_serve(
        "serve_speculative", want_per_round, params32, cfg32, prompts[:8],
        **spec32)
    near_tie_check("serve_speculative_fp32_vs_solo", params32, cfg32,
                   prompts[:8], outs32, solo32[:8])

    rounds, gaps, outs_self, k4 = self_draft_rounds(params32, cfg32,
                                                    prompts[:8])
    total += k4
    say("serve_speculative_fp32_self_draft", rounds=rounds,
        short_rounds=len(gaps), gaps_at_first_rejection=gaps,
        near_tie=NEAR_TIE, k4_launches=k4,
        want_k4=rounds * (GAMMA + 1) * SBD_LAYERS)
    check(k4 == rounds * (GAMMA + 1) * SBD_LAYERS,
          f"self-draft: K4 launched {k4} times over {rounds} rounds")
    check(all(g < NEAR_TIE for g in gaps), f"self-draft rejected a "
          f"proposal away from a near-tie: gaps {gaps}")
    near_tie_check("serve_speculative_fp32_self_draft_vs_solo", params32,
                   cfg32, prompts[:8], outs_self, solo32[:8])

    cfg = sbd_cfg()
    spec = dict(draft_params=truncated_draft(params),
                draft_cfg=smol_135m_config(n_layers=2), gamma=GAMMA)
    (outs, rounds, wall, step_s, _), k4 = counted_serve(
        "serve_speculative", want_per_round, params, cfg, prompts, **spec)
    total += k4
    step_s = sorted(step_s)
    n_tok = sum(len(o) for o in outs)
    row = dict(requests=len(outs), rounds=rounds, k4_launches=k4,
               want_k4=rounds * want_per_round,
               tokens_per_round_all_slots=(n_tok - len(outs)) / rounds,
               ms_per_round_median=1e3 * step_s[len(step_s) // 2],
               tokens_per_s=n_tok / wall,
               dense_tokens_per_s=dense["tokens_per_s"])
    say("serve_speculative_bf16", **row)
    check(all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), "speculative bf16: a stream fell short or "
          "left the vocabulary")
    profile = phase_profile(params, 4, name="profile_speculative_round",
                            cfg=cfg, **spec)
    return dict(k4=total, bf16=row, profile=profile,
                self_draft_short_rounds=len(gaps))


def random_prompts(cfg, lens, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def phase_serve_prefix_chunked(params, params32):
    """Prefix caching (fp32): a 384-token prefix through
    ``cache_prefix``, 8 requests of prefix + a 16-64-token suffix, equal
    to a server without the prefix (near-tie rule), with the prefill
    positions each fed.  Chunked, interleaved prefill (``prefill_chunk
    =128``, ``max_len=2048``): 4 prompts of 600-1500 tokens and 4 short
    ones, fp32 equal to solo generate (near-tie rule); bf16, the
    slowest decode step while a long prompt streams in beside one
    unchunked admission step."""
    import torch
    from nbdistributed_tpu_torch.models import DecodeServer

    L = SBD_LAYERS
    cfg32 = sbd_cfg(dtype=params32["embed"].dtype)
    g = torch.Generator().manual_seed(17)
    prefix = random_prompts(cfg32, [384], 17)[0]
    suffixes = random_prompts(
        cfg32, torch.randint(16, 65, (8,), generator=g).tolist(), 18)
    prompts = [prefix + s for s in suffixes]
    fed, runs, total = {}, {}, 0
    for key in ("with", "without"):
        srv = DecodeServer(params32, cfg32, max_batch=8, max_len=1024)
        if key == "with":
            srv.cache_prefix(prefix)
        fed[key] = 0

        # Count the positions each admission feeds through the prefill
        # forward (the prefix's own prefill above is not counted).
        def counting(p, cache, prompt, slot, start, length,
                     orig=srv._prefill_fn, key=key):
            fed[key] += prompt.shape[1]
            return orig(p, cache, prompt, slot, start, length)

        srv._prefill_fn = counting
        reset_launch_counts()
        rids = [srv.submit(p, 32) for p in prompts]
        steps = 0
        while not srv.done():
            steps += bool(srv.step())
        k4 = k4_launches()
        check(k4 == L * steps, f"prefix run: K4 launched {k4} times over "
              f"{steps} steps")
        total += k4 if key == "with" else 0
        runs[key] = [srv.outputs[r] for r in rids]
    near_tie_check("serve_prefix_fp32_vs_no_prefix", params32, cfg32,
                   prompts, runs["with"], runs["without"])
    say("serve_prefix_positions", prefix_tokens=len(prefix),
        suffix_tokens=[len(s) for s in suffixes],
        prefill_positions_with_prefix=fed["with"],
        prefill_positions_without=fed["without"])
    check(fed["with"] < fed["without"], "the prefix saved no prefill")

    lens = torch.randint(600, 1501, (4,), generator=g).tolist()
    short = torch.randint(16, 129, (4,), generator=g).tolist()  # one chunk
    chunked_prompts = random_prompts(cfg32, short + lens, 19)
    chunk = dict(prefill_chunk=128, interleave_prefill=True, max_len=2048)
    (outs32, *_), k4 = counted_serve("serve_prefix_chunked", L, params32,
                                     cfg32, chunked_prompts, **chunk)
    total += k4
    near_tie_check("serve_chunked_fp32_vs_solo", params32, cfg32,
                   chunked_prompts, outs32,
                   solo_outputs(params32, cfg32, chunked_prompts))

    # bf16: 4 short streams decode while one long prompt streams in,
    # chunk by chunk; against one unchunked admission of it.
    cfg = sbd_cfg()

    def stream_in(**kw):
        reset_launch_counts()
        srv = DecodeServer(params, cfg, **{**dict(max_batch=8,
                                                  max_len=2048), **kw})
        for p in chunked_prompts[:4]:
            srv.submit(p, 64)
        steps = sum(bool(srv.step()) for _ in range(3))
        times = []
        torch.cuda.synchronize()
        ts = time.perf_counter()
        srv.submit(chunked_prompts[-1], 8)
        while srv.prefill_progress() or not times:
            steps += bool(srv.step())
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - ts))
            ts = time.perf_counter()
        k4 = k4_launches()
        check(k4 == L * steps, f"stream-in run: K4 launched {k4} times "
              f"over {steps} steps")
        return times, k4

    chunked_ms, k4 = stream_in(**chunk)
    total += k4
    mono_ms, _ = stream_in()
    row = dict(long_prompt=len(chunked_prompts[-1]), prefill_chunk=128,
               chunked_step_ms=chunked_ms, slowest_chunked_step_ms=max(
                   chunked_ms), unchunked_admission_step_ms=mono_ms[0])
    say("serve_chunked_bf16_stream_in", **row)
    return dict(k4=total, prefill_positions=dict(fed), stream_in=row)


def weight_bytes(tree):
    """Bytes of every tensor of a (possibly quantized) parameter tree."""
    import torch
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return sum(weight_bytes(v) for v in tree.values())


def dequant_costs(params):
    """Device time (CUDA-graph replay) of the lm_head product at the
    decode shape (8 rows): bf16 against int8 and int4 leaves, each of
    which casts its weight to bf16 (int4: unpacks it through int32) on
    every call."""
    import torch
    from nbdistributed_tpu_torch.models import (qlinear, quantize_weight,
                                                quantize_weight4)

    w = params["lm_head"]
    x = torch.randn(8, 1, w.shape[0], device="cuda").to(w.dtype)
    leaves = {"bf16": w, "int8": quantize_weight(w),
              "int4": quantize_weight4(w, group=64)}
    return {k: dict(ms=graph_ms(lambda v=v: qlinear(x, v), 10, 5),
                    weight_bytes=weight_bytes({"w": v}))
            for k, v in leaves.items()}


def phase_serve_quantized(params, prompts, params32):
    """int8 (``quantize_params``) and int4 (``quantize_params4``, group
    64) weights of the bf16 model serving the 12 requests: weight bytes,
    decode ms per step, the forward's relative L2 against the
    unquantized forward; in fp32, 4 requests on each quantized tree
    against solo generate on the same tree (near-tie rule; the int4
    tree's solo runs are the slowest of the script)."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, quantize_params,
                                                quantize_params4)

    L = SBD_LAYERS
    cfg = sbd_cfg()
    cfg32 = sbd_cfg(dtype=params32["embed"].dtype)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    ref = forward(params, tokens, cfg)
    kinds = {"int8": quantize_params, "int4": quantize_params4}
    rows, total = {"bf16": dict(weight_bytes=weight_bytes(params))}, 0
    for name, quantize in kinds.items():
        qp = quantize(params)
        logits = forward(qp, tokens, cfg)
        rel = float((logits - ref).norm() / ref.norm())
        (outs, steps, wall, step_s, _), k4 = counted_serve(
            "serve_quantized", L, qp, cfg, prompts)
        total += k4
        check(torch.isfinite(logits).all().item() and all(
            len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
            for o in outs), f"{name}: bad logits or streams")
        step_s = sorted(step_s)
        rows[name] = dict(weight_bytes=weight_bytes(qp), decode_steps=steps,
                          ms_per_step_median=1e3 * step_s[len(step_s) // 2],
                          tokens_per_s=sum(map(len, outs)) / wall,
                          forward_rel_l2_vs_bf16=rel)
        say("serve_quantized_bf16", kind=name, **rows[name])
        del qp
        qp32 = quantize(params32)
        (outs32, *_), k4 = counted_serve("serve_quantized", L, qp32, cfg32,
                                         prompts[:4])
        total += k4
        near_tie_check(f"serve_quantized_{name}_fp32_vs_solo", qp32, cfg32,
                       prompts[:4], outs32,
                       solo_outputs(qp32, cfg32, prompts[:4]))
    rows["lm_head_product"] = dequant_costs(params)
    say("quantized_product_cost", **rows["lm_head_product"])
    return dict(k4=total, rows=rows)


def serving_beyond_dense(prompts, seed=0):
    """Phases 7-10 in order on phase 5's requests, at ``SBD_LAYERS``:
    first their references at that depth (bf16 parameters and the dense
    server's streams, as phase 5's; fp32 parameters and solo generate,
    as phase 6's); returns ({path: result}, {path: seconds})."""
    import torch
    from nbdistributed_tpu_torch.models import init_params

    ts = time.perf_counter()
    cfg = sbd_cfg()
    params = init_params(cfg, seed)
    outputs, steps, wall, step_s, _ = serve(params, cfg, prompts)
    step_s = sorted(step_s)
    dense = dict(outputs=outputs,
                 tokens_per_s=sum(map(len, outputs)) / wall,
                 ms_per_step_median=1e3 * step_s[len(step_s) // 2])
    cfg32 = sbd_cfg(dtype=torch.float32)
    params32 = init_params(cfg32, seed)
    solo32 = solo_outputs(params32, cfg32, prompts)
    beyond, seconds = {}, {"references": time.perf_counter() - ts}
    for name, phase, args in (
            ("serve_paged", phase_serve_paged,
             (params, prompts, dense, params32, solo32)),
            ("serve_speculative", phase_serve_speculative,
             (params, prompts, dense, params32, solo32)),
            ("serve_prefix_chunked", phase_serve_prefix_chunked,
             (params, params32)),
            ("serve_quantized", phase_serve_quantized,
             (params, prompts, params32))):
        ts = time.perf_counter()
        beyond[name] = phase(*args)
        seconds[name] = time.perf_counter() - ts
        torch.cuda.empty_cache()
    say("serving_beyond_dense_seconds", **seconds)
    return beyond, seconds


# ----------------------------------------------------------------------
# phase 11: the training path

TRAIN_B, TRAIN_STEPS, TRAIN_BATCH_SEED = 4, 8, 7


def packed_batch(cfg, B, S, seed):
    """One (B, S) batch of random documents of 64-1536 tokens, packed by
    ``pack_tokens`` (eos-separated, segments on) and fed through
    ``batch_iterator`` and ``prefetch_to_device`` as a trainer feeds
    them."""
    import numpy as np
    from nbdistributed_tpu_torch.utils.data import (batch_iterator,
                                                    pack_tokens,
                                                    prefetch_to_device)

    rng = np.random.default_rng(seed)
    docs, total = [], 0
    while total < (B + 1) * S:
        n = int(rng.integers(64, 1537))
        docs.append(rng.integers(1, cfg.vocab_size, n))
        total += n + 1
    windows, segs = pack_tokens(docs, S, eos_id=0, return_segments=True)
    it = batch_iterator({"tokens": windows, "segments": segs},
                        batch_size=B, rank=0, world_size=1, seed=seed)
    return next(prefetch_to_device(it, device="cuda"))


def launch_counts():
    from nbdistributed_tpu_torch.ops import attention as A
    return {"k1": A.flash_attention.launches,
            "k2": A.flash_attention_bwd_dq.launches,
            "k3": A.flash_attention_bwd_dkv.launches}


def reset_launch_counts():
    from nbdistributed_tpu_torch.ops import attention as A
    from nbdistributed_tpu_torch.ops import decode as K
    A.flash_attention.launches = 0
    A.flash_attention_bwd_dq.launches = 0
    A.flash_attention_bwd_dkv.launches = 0
    K.flash_decode_attention.launches = 0


def phase_train(seed=0):
    """The training path at full width: counts reset, ``TRAIN_STEPS``
    bf16 AdamW steps with remat on one fixed packed batch, counts read.
    Then one profiled step."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                num_tokens_per_step,
                                                param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config(remat=True)
    params = init_params(cfg, seed)
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
    want = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
            "k3": N_LAYERS_SMOL}

    reset_launch_counts()
    losses, secs, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    counts = launch_counts()

    n_tok = num_tokens_per_step(batch["tokens"].shape)
    steady = sorted(secs[2:])
    ms = 1e3 * steady[len(steady) // 2]
    say("train_bf16", steps=TRAIN_STEPS, losses=losses,
        launches=counts, launches_per_step=per_step[0],
        want_per_step=want, tokens_per_step=n_tok,
        ms_per_step_median_3_8=ms, tokens_per_s=n_tok / (ms / 1e3),
        ms_per_step=[1e3 * t for t in secs],
        segments=int(batch["segments"].max() - batch["segments"].min() + 1),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for i, c in enumerate(per_step):
        check(c == want, f"train step {i + 1} launched {c}, want {want}")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")

    row = profile_steps(lambda: step(params, batch), 1)
    say("profile_train_step", **row)
    return ({"k1": counts["k1"], "k2": counts["k2"], "k3": counts["k3"],
             "steps": TRAIN_STEPS, "ms_per_step": ms,
             "tokens_per_s": n_tok / (ms / 1e3), "losses": losses}, row)


def phase_train_fp32_vs_plain(seed=0):
    """fp32 loss and every gradient leaf through the kernels
    (``use_flash=True``: K1 forward, K2/K3 backward) against the plain
    path (``use_flash=False``: autograd of ``attention_reference``) at
    full width, B=1, S=2048, packed documents, remat on."""
    import torch
    from nbdistributed_tpu_torch.models import (init_params, loss_fn,
                                                named_param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config(dtype=torch.float32, remat=True)
    params = init_params(cfg, seed)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    batch = packed_batch(cfg, 1, cfg.max_seq_len, seed=8)

    def value_and_grad(c):
        loss = loss_fn(params, batch, c)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    lk, gk = value_and_grad(cfg)
    lp, gp = value_and_grad(dataclasses.replace(cfg, use_flash=False))
    rel = {name: float((a - b).norm() / b.norm())
           for (name, _), a, b in zip(named, gk, gp)}
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(rel, key=rel.get)
    say("train_fp32_kernels_vs_plain", loss_kernels=lk, loss_plain=lp,
        loss_rel_err=loss_rel, grad_rel_l2=rel, worst_leaf=worst,
        tol=TRAIN_FP32_TOL)
    check(all(torch.isfinite(g).all().item() for g in gk),
          "non-finite kernel-path gradient")
    check(loss_rel <= TRAIN_FP32_TOL and rel[worst] <= TRAIN_FP32_TOL,
          f"fp32 train: loss {loss_rel}, {worst} {rel[worst]} over "
          f"{TRAIN_FP32_TOL}")
    return {"loss_rel_err": loss_rel, "worst_leaf": worst,
            "worst_rel_l2": rel[worst]}


def phase_lora(seed=0, steps=3):
    """Three bf16 LoRA steps at full width on the training batch: the
    base parameters stay bit-identical and the loss falls."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                lora_init, lora_num_params,
                                                make_lora_train_step,
                                                param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config(remat=True)
    base = init_params(cfg, seed)
    before = [t.clone() for t in param_leaves(base)]
    lora = lora_init(1, cfg, rank=8)
    step = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=5e-3))
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    losses = [float(step(base, lora, batch)) for _ in range(steps)]
    same = all(torch.equal(a, b) for a, b in zip(before, param_leaves(base)))
    say("lora_bf16", steps=steps, losses=losses, base_identical=same,
        adapter_params=lora_num_params(lora))
    check(same, "LoRA steps changed the base parameters")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"non-finite LoRA loss: {losses}")
    check(losses[-1] < losses[0], f"LoRA loss did not fall: {losses}")
    return losses


# ----------------------------------------------------------------------
# phases 12-15: the Mixtral MoE family.  mixtral_8x7b_config at full
# width with n_layers 32 -> 2 (93 GB of bf16 weights > the card's 80 GB;
# chip time), random weights from seed 0.  Every path's run has its
# counts reset just before and read just after.

N_LAYERS_MOE = 2
# capacity_factor >= n_experts / top_k: no expert can overflow at any
# token count, so the three dispatch modes, the server and solo
# generate route every token alike.
MOE_LOSSLESS = 4.0
MOE_TRAIN_STEPS = 4


def mixtral_cfg(**kw):
    from nbdistributed_tpu_torch.models import mixtral_8x7b_config
    return mixtral_8x7b_config(n_layers=N_LAYERS_MOE, **kw)


def moe_host_reads():
    from nbdistributed_tpu_torch.parallel import expert
    return expert._dropless_ffn.host_reads


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_moe_modes(seed=0):
    """fp32, lossless capacity: ``moe_forward`` on B=1, S=512 in the
    dense, sparse and dropless modes.  Logits within 1e-5 relative L2 of
    the dense mode's, aux within 1e-6; K1 once per layer per forward;
    dropless reads its expert group sizes on the host once per layer.
    Returns (params, cfg, row)."""
    import torch
    from nbdistributed_tpu_torch.models import init_moe_model, moe_forward

    cfg = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS)
    params = init_moe_model(cfg, seed)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    modes = {m: dataclasses.replace(cfg, moe_dispatch=m)
             for m in ("dense", "sparse", "dropless")}
    L = cfg.n_layers

    reset_launch_counts()
    reads = moe_host_reads()
    out = {m: moe_forward(params, tokens, c) for m, c in modes.items()}
    torch.cuda.synchronize()
    k1, reads = launch_counts()["k1"], moe_host_reads() - reads

    ref, ref_aux = out["dense"]
    rel = {m: rel_l2(out[m][0], ref) for m in ("sparse", "dropless")}
    aux = {m: float(a) for m, (_, a) in out.items()}
    ms = {m: cuda_ms(lambda c=c: moe_forward(params, tokens, c), 3, 1)
          for m, c in modes.items()}
    row = dict(k1_launches=k1, want_k1=len(modes) * L,
               dropless_host_reads=reads, want_host_reads=L,
               logits_rel_l2_vs_dense=rel, tol=1e-5, aux=aux, aux_tol=1e-6,
               ms_per_forward=ms, capacity_factor=MOE_LOSSLESS)
    say("moe_modes_fp32", **row)
    check(torch.isfinite(ref).all().item()
          and ref.shape == (1, 512, cfg.vocab_size), "moe_forward: bad logits")
    check(k1 == len(modes) * L, f"moe_forward: K1 launched {k1} times")
    check(reads == L, f"dropless: {reads} host reads over {L} layers")
    check(all(r <= 1e-5 for r in rel.values()), f"modes disagree: {rel}")
    check(all(abs(a - aux["dense"]) <= 1e-6 for a in aux.values()),
          f"aux losses disagree: {aux}")
    return params, cfg, row


def phase_moe_fp32(params, cfg, prompts):
    """fp32 at lossless capacity on 8 of the requests: the server against
    solo ``generate``; a self-draft speculative server (gamma 4)
    accepting every proposal but at near-ties, K4 (gamma + 1) x layers
    a round; a ``quantize_moe_params`` tree's server against solo
    ``generate`` on the same tree (4 requests).  Near-tie rule
    throughout."""
    from nbdistributed_tpu_torch.models import quantize_moe_params

    L = cfg.n_layers
    (outs, steps, *_), k4 = counted_serve("serve_moe", L, params, cfg,
                                          prompts[:8])
    solo = solo_outputs(params, cfg, prompts[:8])
    near_tie_check("serve_moe_fp32_vs_solo", params, cfg, prompts[:8], outs,
                   solo)
    rounds, gaps, outs_self, k4_spec = self_draft_rounds(params, cfg,
                                                         prompts[:8])
    say("serve_moe_fp32_self_draft", rounds=rounds, short_rounds=len(gaps),
        gaps_at_first_rejection=gaps, near_tie=NEAR_TIE,
        k4_launches=k4_spec, want_k4=rounds * (GAMMA + 1) * L)
    check(k4_spec == rounds * (GAMMA + 1) * L,
          f"MoE self-draft: K4 launched {k4_spec} times over {rounds} rounds")
    check(all(g < NEAR_TIE for g in gaps), f"MoE self-draft rejected a "
          f"proposal away from a near-tie: gaps {gaps}")
    near_tie_check("serve_moe_fp32_self_draft_vs_solo", params, cfg,
                   prompts[:8], outs_self, solo)
    qp = quantize_moe_params(params)
    (outs_q, *_), k4_int8 = counted_serve("serve_moe_int8", L, qp, cfg,
                                          prompts[:4])
    near_tie_check("serve_moe_int8_fp32_vs_solo", qp, cfg, prompts[:4],
                   outs_q, solo_outputs(qp, cfg, prompts[:4]))
    return dict(k4_serve=k4, steps=steps, k4_speculative=k4_spec,
                self_draft_rounds=rounds, self_draft_short_rounds=len(gaps),
                k4_int8=k4_int8, solo=solo)


def moe_layer_ms(params, cfg):
    """Device time (CUDA-graph replay) of one MoE block at the decode
    step's shape: 8 rows, all live."""
    import torch
    from nbdistributed_tpu_torch.models.moe import _moe_mlp_block
    from nbdistributed_tpu_torch.models.transformer import layer_params

    layer = layer_params(params, 0)
    x = torch.randn(8, 1, cfg.d_model, device="cuda").to(cfg.dtype)
    mask = torch.ones(8, 1, dtype=torch.bool, device="cuda")
    return graph_ms(lambda: _moe_mlp_block(x, layer, cfg, token_mask=mask),
                    10, 5)


def served_row(outs, steps, wall, step_s, cfg):
    check(all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), "a stream fell short or left the vocabulary")
    step_s = sorted(step_s)
    n_tok = sum(len(o) for o in outs)
    return dict(requests=len(outs), tokens=n_tok, decode_steps=steps,
                wall_s=wall, tokens_per_s=n_tok / wall,
                ms_per_step_median=1e3 * step_s[len(step_s) // 2])


def phase_serve_moe(prompts, seed=0):
    """bf16, capacity factor 1.25, dense dispatch: the 12 requests on
    ``DecodeServer(max_batch=8, max_len=1024)``, K4 once per layer per
    step; a profile of decode steps with the MoE block's device time
    (graph replay) beside it; the paged server (blocks of 64 tokens)
    token for token the dense one; a ``quantize_moe_params`` tree
    serving the same requests.  Returns (params, cfg, row)."""
    import torch
    from nbdistributed_tpu_torch.models import (init_moe_model, moe_forward,
                                                quantize_moe_params)

    cfg = mixtral_cfg()
    params = init_moe_model(cfg, seed)
    L = cfg.n_layers
    (outs, steps, wall, step_s, _), k4 = counted_serve("serve_moe", L,
                                                       params, cfg, prompts)
    # What a decode step must read: every weight but the embedding,
    # whose 8 gathered rows are noise (the dense mode runs all 8
    # experts).
    step_bytes = weight_bytes(params) - weight_bytes({"e": params["embed"]})
    row = dict(served_row(outs, steps, wall, step_s, cfg), k4_launches=k4,
               want_k4=L * steps, weight_bytes=weight_bytes(params),
               step_weight_bytes=step_bytes,
               step_weight_bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S)
    say("serve_moe_bf16", **row)
    profile = phase_profile(params, 4, name="profile_moe_decode_step",
                            cfg=cfg)
    layer_ms = moe_layer_ms(params, cfg)
    device = profile["device_ms_per_step"]
    row["profile"] = dict(profile, moe_block_ms=layer_ms,
                          moe_share_of_device=L * layer_ms / device
                          if isinstance(device, float) else "not measured")
    say("profile_moe_decode_step_moe_share", moe_block_ms=layer_ms,
        moe_blocks_per_step=L,
        moe_share_of_device=row["profile"]["moe_share_of_device"])

    (outs_p, steps_p, *_), k4_paged = counted_serve(
        "serve_moe_paged", L, params, cfg, prompts, kv_block_tokens=64)
    say("serve_moe_paged_bf16", equal_to_dense=outs_p == outs,
        decode_steps=steps_p, k4_launches=k4_paged)
    check(outs_p == outs, "paged bf16 MoE serving differs from the dense "
          "bf16 MoE server")

    qp = quantize_moe_params(params)
    (outs_q, steps_q, wall_q, step_s_q, _), k4_int8 = counted_serve(
        "serve_moe_int8", L, qp, cfg, prompts)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 128), generator=g)
    ref = moe_forward(params, tokens, cfg)[0]
    int8 = dict(served_row(outs_q, steps_q, wall_q, step_s_q, cfg),
                weight_bytes=weight_bytes(qp),
                forward_rel_l2_vs_bf16=rel_l2(moe_forward(qp, tokens, cfg)[0],
                                              ref))
    say("serve_moe_int8_bf16", **int8)
    del qp
    row.update(k4_paged=k4_paged, k4_int8=k4_int8, int8=int8)
    return params, cfg, row


def phase_train_moe(params, cfg):
    """bf16 training at full width: ``moe_loss_fn`` and the port's AdamW,
    ``MOE_TRAIN_STEPS`` steps on one B=1 x S=2048 batch of packed
    documents, counts reset just before and read just after (per step
    K1, K2 and K3 once per layer: no remat); losses finite and falling;
    then one profiled step, and three LoRA steps (rank 8, attention
    targets) leaving the base untouched with finite losses."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, lora_init,
                                                make_lora_train_step,
                                                moe_loss_fn,
                                                num_tokens_per_step,
                                                param_leaves)

    L = cfg.n_layers
    batch = packed_batch(cfg, 1, 2048, TRAIN_BATCH_SEED)
    leaves = [p.requires_grad_() for p in param_leaves(params)]
    opt = AdamW(leaves, lr=1e-3)

    def step():
        for p in leaves:
            p.grad = None
        loss = moe_loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    want = {"k1": L, "k2": L, "k3": L}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs, per_step = [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_tok = num_tokens_per_step(batch["tokens"].shape)
    ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
    row = dict(steps=MOE_TRAIN_STEPS, losses=losses, launches=counts,
               launches_per_step=per_step, want_per_step=want,
               tokens_per_step=n_tok, ms_per_step=[1e3 * t for t in secs],
               ms_per_step_median_after_first=ms,
               tokens_per_s=n_tok / (ms / 1e3), peak_mem_gb=peak)
    say("train_moe_bf16", **row)
    for i, c in enumerate(per_step):
        check(c == want, f"MoE train step {i + 1} launched {c}, want {want}")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"non-finite MoE train loss: {losses}")
    check(losses[-1] < losses[0], f"MoE train loss did not fall: {losses}")
    profile = profile_steps(step, 1)
    say("profile_train_moe_step", **profile)

    opt.state.clear()
    del opt
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    torch.cuda.empty_cache()
    base = [t.clone() for t in leaves]
    lora = lora_init(1, cfg, rank=8)
    lstep = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=5e-3))
    lora_losses = [float(lstep(params, lora, batch)) for _ in range(3)]
    same = all(torch.equal(a, b) for a, b in zip(base, leaves))
    say("lora_moe_bf16", steps=3, losses=lora_losses, base_identical=same)
    check(same, "MoE LoRA steps changed the base parameters")
    check(all(map(lambda x: x == x and abs(x) != float("inf"),
                  lora_losses)), f"non-finite MoE LoRA loss: {lora_losses}")
    return dict(row, k1=counts["k1"], k2=counts["k2"], k3=counts["k3"],
                profile=profile, lora_losses=lora_losses)


def phase_moe(seed=0):
    """Phases 12-15 in order; each model is freed before the next is
    built.  Returns {phase: result}."""
    import torch

    ts = time.perf_counter()
    params32, cfg32, modes = phase_moe_modes(seed)
    prompts = make_requests(cfg32)
    fp32 = phase_moe_fp32(params32, cfg32, prompts)
    del params32
    torch.cuda.empty_cache()
    params, cfg, serve_row = phase_serve_moe(prompts, seed)
    train = phase_train_moe(params, cfg)
    del params
    torch.cuda.empty_cache()
    say("moe_seconds", seconds=time.perf_counter() - ts)
    return dict(modes=modes, fp32=fp32, serve=serve_row, train=train)


# ----------------------------------------------------------------------
# phase 17: the worker cluster and HF interop

CLUSTER_READY_S = 300      # torch import + CUDA + the NCCL rendezvous
CLUSTER_RT_CELLS = 20
NCCL_BYTES = 64 << 20

# Runs in the worker: phase 5's path (full-width forward, then the 12
# requests on a bf16 server) with the counts reset just before and read
# just after, and the kernels loaded from the parent's build.
CLUSTER_SERVE_CELL = """
import chip_smoke as cs
from nbdistributed_tpu_torch.models import (forward, init_params,
                                            smol_135m_config)
from nbdistributed_tpu_torch.ops import (_build, flash_attention,
                                         flash_decode_attention)
torch.backends.cuda.matmul.allow_tf32 = False
rebuilt = _build.build_all()
cfg = smol_135m_config()
params = init_params(cfg, 0, device=device)
tokens = torch.randint(0, cfg.vocab_size, (1, 512),
                       generator=torch.Generator().manual_seed(5))
prompts = cs.make_requests(cfg)
cs.reset_launch_counts()
logits = forward(params, tokens, cfg)
outputs, steps, wall, _, _ = cs.serve(params, cfg, prompts)
served = {"k1": flash_attention.launches,
          "k4": flash_decode_attention.launches, "steps": steps,
          "wall_s": wall, "outputs": outputs, "rebuilt": sorted(rebuilt),
          "logits_finite": bool(torch.isfinite(logits).all()),
          "logits_shape": list(logits.shape)}
"""

CLUSTER_NCCL_CELL = """
t = torch.full((4,), float(rank + 2), device=device)
f = all_reduce(t)
u = t.clone()
dist.all_reduce(u)
x = torch.ones(NCCL_BYTES // 4, device=device)
for _ in range(3):
    dist.all_reduce(x)
torch.cuda.synchronize()
e0 = torch.cuda.Event(enable_timing=True)
e1 = torch.cuda.Event(enable_timing=True)
e0.record()
for _ in range(20):
    dist.all_reduce(x)
e1.record()
torch.cuda.synchronize()
nccl = {"device": str(device), "backend": dist.get_backend(),
        "world": dist.get_world_size(), "functional": f.tolist(),
        "functional_device": str(f.device), "input_after": t.tolist(),
        "in_place": u.tolist(), "all_reduce_ms": e0.elapsed_time(e1) / 20,
        "quantized": all_reduce_quantized(torch.arange(1000., device=device)
                                          ).sub(torch.arange(1000.,
                                          device=device)).abs().max().item()}
"""

CLUSTER_SPIN_CELL = """
import time
a = torch.randn(4096, 4096, device=device, dtype=torch.bfloat16)
print("spinning", flush=True)
t0 = time.monotonic()
while time.monotonic() - t0 < 120:
    c = a @ a
"""


# The self-lint's blocking-under-lock exemption for this script
# (nbdistributed_tpu_torch/analysis/concur.py), as the port's async
# window exempts its own admission wait.
_LINT_BLOCKING_OK = {
    "_Streams.wait_for:wait":
        "Condition.wait RELEASES the condition's lock while it "
        "blocks: waiting for a pushed text under the condition that "
        "its notify_all signals is the designed pattern, not IO "
        "under a held lock",
}


class _Streams:
    """The coordinator's output callback: collects pushes, and
    ``wait_for`` polls for a text under a deadline."""

    def __init__(self):
        import threading
        self.cond = threading.Condition()
        self.texts = []

    def __call__(self, rank, data):
        with self.cond:
            self.texts.append(data.get("text", ""))
            self.cond.notify_all()

    def wait_for(self, text, timeout):
        deadline = time.monotonic() + timeout
        with self.cond:
            while not any(text in t for t in self.texts):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)
            return True


def cell(comm, code, timeout=300):
    """Run ``code`` on the one worker; its reply data (errors raise)."""
    data = comm.send_to_rank(0, "execute", code, timeout=timeout).data
    check("error" not in data, f"worker cell failed: {data.get('error')}"
          f"\n{data.get('traceback', '')}")
    return data


def fetch(comm, name):
    data = comm.send_to_rank(0, "get_var", name, timeout=60).data
    check(not data.get("error") and not data.get("array"),
          f"get_var {name}: {data}")
    return data["value"]


def phase_cluster(prompts, dense):
    """One NCCL worker spawned by the port's process manager and driven
    over its control plane: the process group and the collectives on
    the card, phase 5's serving path inside the worker (tokens equal to
    the in-process server's, K1 and K4 counted in the worker), a
    serve_open/serve_step/serve_close round, an interrupt of a cell
    looping GPU matmuls, and the control plane's costs."""
    import statistics
    import threading

    from nbdistributed_tpu_torch.manager import (ProcessManager,
                                                 wait_until_ready)
    from nbdistributed_tpu_torch.messaging.coordinator import \
        CommunicationManager

    ts = time.perf_counter()
    comm = CommunicationManager(1, timeout=300)
    streams = _Streams()
    comm.set_output_callback(streams)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        t0 = time.perf_counter()
        pm.start_workers(1, comm.port, backend="gpu")
        wait_until_ready(comm, pm, CLUSTER_READY_S, poll_s=0.5)
        ready_s = time.perf_counter() - t0
        check(pm.gpus == {0: 0}, f"GPU assignment {pm.gpus}")

        cell(comm, f"NCCL_BYTES = {NCCL_BYTES}\n" + CLUSTER_NCCL_CELL)
        nccl = fetch(comm, "nccl")
        say("cluster_process_group", spawn_to_ready_s=ready_s, **nccl)
        check(nccl["device"] == "cuda:0" and nccl["backend"] == "nccl"
              and nccl["world"] == 1, f"process group: {nccl}")
        check(nccl["functional"] == [2.0] * 4
              and nccl["in_place"] == [2.0] * 4
              and nccl["input_after"] == [2.0] * 4
              and nccl["functional_device"] == "cuda:0",
              f"all_reduce on the card: {nccl}")
        check(nccl["quantized"] <= 1000 / 254, f"all_reduce_quantized: "
              f"{nccl['quantized']}")

        rt = []
        for _ in range(CLUSTER_RT_CELLS):
            tr = time.perf_counter()
            cell(comm, "1")
            rt.append(time.perf_counter() - tr)

        cell(comm, CLUSTER_SERVE_CELL, timeout=600)
        served = fetch(comm, "served")
        steps = served["steps"]
        n_tok = sum(len(o) for o in served["outputs"])
        row = dict(k1_launches=served["k1"], k4_launches=served["k4"],
                   decode_steps=steps, want_k1=N_LAYERS_SMOL,
                   want_k4=N_LAYERS_SMOL * steps,
                   rebuilt_in_worker=served["rebuilt"],
                   tokens=n_tok, wall_s=served["wall_s"],
                   tokens_per_s=n_tok / served["wall_s"],
                   in_process_tokens_per_s=dense["tokens_per_s"])
        say("cluster_serve", **row)
        check(served["rebuilt"] == [], "the worker rebuilt kernels: "
              f"{served['rebuilt']}")
        check(served["logits_finite"] and served["logits_shape"]
              == [1, 512, 49152], "worker forward: bad logits")
        check(served["k1"] == N_LAYERS_SMOL, f"worker K1 launched "
              f"{served['k1']} times, want {N_LAYERS_SMOL}")
        check(steps > 0 and served["k4"] == N_LAYERS_SMOL * steps,
              f"worker K4 launched {served['k4']} times over {steps} "
              "decode steps")
        check(served["outputs"] == dense["outputs"], "the worker's bf16 "
              "tokens differ from the in-process server's")

        # The serving protocol on the same model: the first wave of
        # phase 5's requests admitted in one tick.
        r = comm.send_to_rank(0, "serve_open", {
            "max_batch": 8, "max_len": 1024, "pad_to": 64}).data
        check(r == {"status": "open", "slots": 8}, f"serve_open: {r}")
        wave = prompts[:5]
        got = {f"r{i}": [] for i in range(len(wave))}
        done, ticks = set(), 0
        tw = time.perf_counter()
        while len(done) < len(wave):
            ticks += 1
            check(ticks <= 100, "serve_step did not finish the wave")
            r = comm.send_to_rank(0, "serve_step", {
                "admit": [{"rid": f"r{i}", "prompt": p, "max_new": 32}
                          for i, p in enumerate(wave)] if ticks == 1
                else [], "steps": 8}, timeout=300).data
            check(r.get("status") == "ok" and not r["errors"],
                  f"serve_step: {r}")
            for rid, e in r["emitted"].items():
                check(e["o"] == len(got[rid]), "serve_step offsets")
                got[rid] += e["t"]
            done |= set(r["finished"])
        wave_s = time.perf_counter() - tw
        r = comm.send_to_rank(0, "serve_close", {}).data
        check(r == {"status": "ok", "existed": True}, f"serve_close: {r}")
        same = [got[f"r{i}"] for i in range(len(wave))] \
            == dense["outputs"][:len(wave)]
        say("cluster_serve_protocol", requests=len(wave), ticks=ticks,
            seconds=wave_s, tokens_equal_in_process=same)
        check(same, "serve_step tokens differ from the in-process server's")

        # An interrupt while the cell keeps the GPU busy.
        result = {}
        th = threading.Thread(target=lambda: result.update(
            comm.send_to_all("execute", CLUSTER_SPIN_CELL, timeout=300)),
            daemon=True)
        th.start()
        check(streams.wait_for("spinning", 120), "spin cell never started")
        ti = time.perf_counter()
        check(pm.interrupt() == [0], "interrupt: worker not signalled")
        th.join(timeout=120)
        interrupt_s = time.perf_counter() - ti
        check(not th.is_alive(), "the interrupt did not end the cell")
        err = result[0].data.get("error", "")
        check("KeyboardInterrupt" in err, f"interrupted cell: {err}")
        after = cell(comm, "torch.cuda.synchronize()\n"
                           "float((a[:4, :4] * 0).sum()) + 1")
        check(after["output"] == "1.0", f"cell after interrupt: {after}")
        say("cluster_interrupt", reply_after_signal_s=interrupt_s,
            error=err.splitlines()[0], next_cell=after["output"])
        comm.post([0], "shutdown")
    finally:
        pm.shutdown()
        comm.shutdown()
    out = dict(spawn_to_ready_s=ready_s,
               trivial_cell_ms_median=1e3 * statistics.median(rt),
               trivial_cell_ms=[1e3 * x for x in rt],
               nccl_all_reduce_64mb_ms=nccl["all_reduce_ms"],
               nccl_all_reduce_64mb_world=1, serve=row,
               serve_protocol_ticks=ticks, interrupt_s=interrupt_s,
               seconds=time.perf_counter() - ts)
    say("cluster", **{k: v for k, v in out.items() if k != "serve"})
    return out


# ----------------------------------------------------------------------
# phase 18: serving on a mesh.  Four ranks of one gloo process group,
# spawned by this script, all on the one card (NCCL refuses two ranks on
# one device; gloo runs all_reduce, all_gather and broadcast on CUDA
# tensors through host staging).  The ranks time-share the card, and
# every collective crosses the host, so no number here is a link speed.

MESH_WORLD = 4
MESH_MAX_LEN = 256      # prompts of 16-200 tokens + 32 new: both sp
#                         slices of 128 tokens hold keys
MESH_READY_S = 300      # spawn, torch import, CUDA and the rendezvous
MESH_RUN_S = 900
MESH_NOTE = {"gloo": "4 ranks time-share one GPU over gloo's host "
                     "staging: no number is a link speed",
             "nccl": "4 ranks, one GPU each, NCCL over the host's links"}


def seeded_moe_shard(cfg, seed, mesh, rules):
    """``init_moe_model(cfg, seed)``'s tree on this rank's card, drawn
    leaf by leaf in that function's order from the same generator, each
    leaf cut to this rank's shard by ``rules`` as soon as it is drawn:
    a rank never holds the whole 2-layer fp32 Mixtral (12.6 GB)."""
    import math

    import torch
    from nbdistributed_tpu_torch.parallel import apply_shardings
    from nbdistributed_tpu_torch.utils import fan_in_normal

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    D, H, Hkv, Dh, L, E, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.n_layers, cfg.n_experts,
                              cfg.d_ff)
    lay = rules["layers"]

    def cut(x, spec):
        return apply_shardings(x, mesh, spec)

    def normal(shape, fan_in):
        return fan_in_normal(gen, shape, fan_in, cfg.dtype)

    # init_moe_params' draws, layer by layer: (name, shape, fan_in); the
    # router is N(0, 1) * 0.02 in fp32, the experts fan-in normal.
    draws = (("router", (D, E), None), ("w_gate", (E, D, F), D),
             ("w_up", (E, D, F), D), ("w_down", (E, F, D), F))
    moe = {}
    for i in range(L):
        for name, shape, fan_in in draws:
            spec = lay["moe"][name]
            dtype = torch.float32 if fan_in is None else cfg.dtype
            if all(e is None for e in spec) and dtype == torch.float32:
                # A whole fp32 leaf is drawn straight into its layer's
                # slot: the same normal_ on the same generator, the same
                # division, no transient copy.
                if name not in moe:
                    moe[name] = torch.empty((L,) + shape, device="cuda")
                out = torch.randn(shape, generator=gen, device="cuda",
                                  out=moe[name][i])
                out.mul_(0.02) if fan_in is None else \
                    out.div_(math.sqrt(fan_in))
                continue
            x = (torch.randn(shape, generator=gen, device="cuda") * 0.02
                 if fan_in is None else normal(shape, fan_in))
            part = cut(x[None], spec)
            del x
            if name not in moe:
                moe[name] = torch.empty((L,) + part.shape[1:],
                                        dtype=part.dtype, device="cuda")
            moe[name][i] = part[0]
            del part
    ones = lambda *shape: torch.ones(shape, device="cuda")  # noqa: E731
    tree = {"embed": cut(normal((cfg.vocab_size, D), 1.0), rules["embed"])}
    tree["layers"] = {
        "attn_norm": ones(L, D),
        "wq": cut(normal((L, D, H * Dh), D), lay["wq"]),
        "wk": cut(normal((L, D, Hkv * Dh), D), lay["wk"]),
        "wv": cut(normal((L, D, Hkv * Dh), D), lay["wv"]),
        "wo": cut(normal((L, H * Dh, D), H * Dh), lay["wo"]),
        "mlp_norm": ones(L, D), "moe": moe}
    tree["final_norm"] = ones(D)
    tree["lm_head"] = cut(normal((D, cfg.vocab_size), D), rules["lm_head"])
    return tree


def _count_collectives():
    """Wrap torch.distributed's all_reduce, all_gather, broadcast,
    reduce_scatter_tensor, batch_isend_irecv (one ring ppermute) and
    all_to_all_single with call counters (the mesh layer looks them up
    at each call)."""
    import torch.distributed as dist
    counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
              "reduce_scatter_tensor": 0, "batch_isend_irecv": 0,
              "all_to_all_single": 0}
    for name in counts:
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(dist, name, counted)
    return counts


def mesh_job(job, counts):
    """One mesh serving run on this rank: the model built from the seed
    and cut to this rank's shard, then the requests served with the
    launch and collective counts reset just before and read just after."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (init_params,
                                                moe_model_shardings,
                                                param_shardings,
                                                smol_135m_config)
    from nbdistributed_tpu_torch.parallel import apply_shardings, make_mesh

    mesh = make_mesh(job["mesh"])
    if job["model"] == "smol":
        cfg = smol_135m_config(dtype=torch.float32)
        params = init_params(cfg, 0)
        if "tp" in mesh.shape:
            params = apply_shardings(params, mesh, param_shardings(cfg))
    else:
        cfg = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS,
                          moe_dispatch=job["dispatch"])
        rules = moe_model_shardings(
            cfg, ep_axis="ep" if "ep" in mesh.shape else None,
            tp_axis="tp" if "tp" in mesh.shape else None)
        params = seeded_moe_shard(cfg, 0, mesh, rules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    outs, steps, wall, step_s, run = serve(params, cfg, job["prompts"],
                                           max_len=MESH_MAX_LEN, mesh=mesh)
    k4, k1 = k4_launches(), launch_counts()["k1"]
    del run                     # the server: its pool and the tree
    n_coll = dict(counts)
    step_s = sorted(step_s)
    row = dict(outputs=outs, steps=steps, k4=k4, k1=k1, wall_s=wall,
               ms_per_step_median=1e3 * step_s[len(step_s) // 2],
               collectives=n_coll,
               collectives_per_step=sum(n_coll.values()) / max(steps, 1),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               weight_gb=weight_bytes(params) / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mesh_rank(rank, port, jobs, q, backend, done):
    """A rank of the mesh phase (spawned): joins the 4-rank group — gloo,
    every rank on ``cuda:0``; or NCCL, rank r on ``cuda:r`` — loads the
    kernels the parent built, runs ``jobs`` in order and puts ``(rank,
    {job: row})`` (or the error) on ``q``; then waits for ``done``, so
    that the shared-memory tensors it sent stay reachable until the
    parent has taken every item."""
    import datetime
    import os
    import traceback
    t_start = time.time()
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import torch
        import torch.distributed as dist
        dev = rank if backend == "nccl" else 0
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=MESH_WORLD, rank=rank,
            timeout=datetime.timedelta(seconds=MESH_READY_S),
            **({"device_id": torch.device("cuda", dev)}
               if backend == "nccl" else {}))
        from nbdistributed_tpu_torch.ops import _build
        out = {"rebuilt": sorted(_build.build_all())}
        out["clock"] = {"start": t_start, "ready": time.time()}
        counts = _count_collectives()
        for job in jobs:
            send = lambda item: q.put((rank, item))  # noqa: E731
            out[job["name"]] = (
                guard_job(job, counts, send) if job.get("guard")
                else train_pp_job(job, counts, send) if job.get("train_pp")
                else overlap_job(job, counts, send) if job.get("overlap")
                else train_sp_job(job, counts, send) if job.get("train_sp")
                else train_mesh_job(job, counts, send) if job.get("train")
                else mesh_job(job, counts))
        dist.barrier()
        out["clock"]["done"] = time.time()
        q.put((rank, out))
        done.wait(MESH_RUN_S)
        dist.destroy_process_group()
    except BaseException:
        err = traceback.format_exc()
        try:                     # what held the card's memory, if CUDA ran
            import gc
            import torch
            live = sorted(((t.numel() * t.element_size(), tuple(t.shape))
                           for t in gc.get_objects()
                           if torch.is_tensor(t) and t.is_cuda),
                          reverse=True)[:12]
            err += (f"\nallocated {torch.cuda.memory_allocated() / 2**30:.2f}"
                    f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                    f" GiB; largest live tensors {live}")
        except Exception:
            pass
        q.put((rank, {"error": err}))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh_ranks(jobs, backend, on_item=None):
    """Spawn the 4 ranks, run ``jobs`` on them, stop them all; returns
    {rank: {job: row}} (a rank's error raises).  A rank's tuple items
    before its result go to ``on_item(rank, item)``."""
    import multiprocessing as mp
    import queue

    import os

    ctx = mp.get_context("spawn")
    q, done = ctx.Queue(), ctx.Event()
    port = _free_port()
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, port, jobs, q, backend, done), daemon=True)
             for r in range(MESH_WORLD)]
    out = {}
    # The ranks' allocators grow segments in place: a job's freed blocks
    # must not strand the next, larger job's memory on a shared card.
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
        deadline = time.monotonic() + MESH_READY_S + MESH_RUN_S * (
            2 if any(j.get("train") or j.get("train_sp") or j.get("train_pp")
                     or j.get("guard") for j in jobs)
            else 1)
        while len(out) < MESH_WORLD:
            try:
                rank, res = q.get(timeout=5.0)
            except queue.Empty:
                # A rank that died without a result (it could not even
                # start) fails the phase now, not at the deadline.
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None}
                check(not dead, f"mesh ranks exited without a result: "
                      f"{dead}")
                check(time.monotonic() < deadline, "mesh ranks "
                      f"{sorted(set(range(MESH_WORLD)) - set(out))} did "
                      f"not finish in time")
                continue
            if isinstance(res, tuple):
                on_item(rank, res)
                continue
            check("error" not in res, f"mesh rank {rank} failed:\n"
                  f"{res.get('error')}")
            out[rank] = res
        done.set()
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return out


def near_tie_or_equal(name, make_params, cfg, prompts, got, want):
    """``got == want``, or the near-tie rule with the reference's
    parameters built (by ``make_params``) only when a stream differs."""
    if got == want:
        say(name, requests=len(got), divergences_at_near_ties=0,
            near_tie=NEAR_TIE)
        return []
    return near_tie_check(name, make_params(), cfg, prompts, got, want)


def phase_mesh(smol_prompts, smol_solo, moe_solo, backend="gloo"):
    """Phase 18: four ranks (gloo on the one card; NCCL on four cards
    with ``--mesh-nccl``) serve, in fp32, SmolLM2-135M (30 layers) on
    dp x sp and Mixtral (2 layers, full width, capacity factor 4) on
    tp x sp and on ep (dense and dropless dispatch), each held to solo
    ``generate`` under the near-tie rule; every rank's tokens equal and
    its K4 launches layers x decode steps."""
    import torch
    from nbdistributed_tpu_torch.models import init_moe_model, init_params

    ts = time.perf_counter()
    torch.cuda.empty_cache()     # the ranks need what this process cached
    moe_prompts = make_requests(mixtral_cfg())[:8]
    # Largest first: every rank of tp x sp holds all 8 experts (11.3 GB).
    jobs = [dict(name="mesh_mixtral_tp2_sp2", model="mixtral",
                 mesh={"tp": 2, "sp": 2}, dispatch="dense",
                 prompts=moe_prompts),
            dict(name="mesh_mixtral_ep4_dense", model="mixtral",
                 mesh={"ep": 4}, dispatch="dense", prompts=moe_prompts),
            dict(name="mesh_mixtral_ep4_dropless", model="mixtral",
                 mesh={"ep": 4}, dispatch="dropless", prompts=moe_prompts),
            dict(name="mesh_smol_dp2_sp2", model="smol",
                 mesh={"dp": 2, "sp": 2}, prompts=smol_prompts)]
    ranks = run_mesh_ranks(jobs, backend)
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: {[r['rebuilt'] for r in ranks.values()]}")
    smol = smol_135m_config_fp32()
    mix = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS)
    rows = {}
    for job in jobs:
        name = job["name"]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        L = smol.n_layers if job["model"] == "smol" else mix.n_layers
        check(all(p["outputs"] == first["outputs"] for p in per),
              f"{name}: the ranks' tokens differ")
        check(all(p["steps"] == first["steps"] and p["steps"] > 0
                  and p["k4"] == L * p["steps"] for p in per),
              f"{name}: K4 launches {[p['k4'] for p in per]} over "
              f"{[p['steps'] for p in per]} steps, want {L} per step")
        if job["model"] == "smol":
            near_tie_or_equal(f"{name}_vs_solo",
                              lambda: init_params(smol, 0), smol,
                              job["prompts"], first["outputs"], smol_solo)
        else:
            near_tie_or_equal(f"{name}_vs_solo",
                              lambda: init_moe_model(mix, 0), mix,
                              job["prompts"], first["outputs"], moe_solo)
        rows[name] = dict(
            mesh=job["mesh"], layers=L, requests=len(first["outputs"]),
            decode_steps=first["steps"], k4_launches_rank0=first["k4"],
            k4_launches_per_rank=[p["k4"] for p in per],
            want_k4=L * first["steps"], k1_launches_rank0=first["k1"],
            ms_per_step_median_rank0=first["ms_per_step_median"],
            ms_per_step_median_per_rank=[p["ms_per_step_median"]
                                         for p in per],
            wall_s_rank0=first["wall_s"],
            collectives_rank0=first["collectives"],
            collectives_per_step_rank0=first["collectives_per_step"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            weight_gb_per_rank=[p["weight_gb"] for p in per],
            backend=backend, note=MESH_NOTE[backend])
        say(name, **rows[name])
    rows["seconds"] = time.perf_counter() - ts
    say("mesh_seconds", seconds=rows["seconds"])
    return rows


# ----------------------------------------------------------------------
# phase 19: training on a mesh.  Phase 18's four ranks (gloo on the one
# card; NCCL, one card each, with --mesh-nccl) train each job below from
# seed 0, held to the single-process step on the whole tree and batch,
# which this process runs first and keeps on the host.  Every job runs
# guarded, so each step's gradient norm is held to the reference's too
# (AdamW alone would not see a gradient off by a constant factor).

TRAIN_MESH_LR = 1e-4
TRAIN_MESH_S = 512
TRAIN_MESH_LOSS_RTOL = 1e-5
TRAIN_MESH_LEAF_RTOL = 1e-4
TRAIN_MESH_BATCH_SEED = 9
TRAIN_MESH_MOE_LAYERS = 1
# SmolLM2's depth in phases 19-22 (4 of its 30 layers): the
# script's time budget (PERF.md §4).  Every check holds per layer.
MESH_SMOL_LAYERS = 4
# Largest first: the Mixtral ranks need the card that the SmolLM2 jobs
# leave cached.  The ZeRO-2 batch is 8 rows without segments, so that
# each dp4 rank has one row per microbatch and the mean over the two
# microbatches is the whole batch's mean (packed documents would weigh
# the microbatches by their kept targets).
TRAIN_MESH_JOBS = (
    dict(name="train_mesh_moe_ep4", model="mixtral", mesh={"ep": 4},
         rules="moe", B=1, segments=True, steps=2),
    dict(name="train_mesh_megatron_dp2_tp2", model="smol",
         mesh={"dp": 2, "tp": 2}, rules="megatron", B=4, segments=True,
         steps=2),
    dict(name="train_mesh_hsdp_dp2_tp2", model="smol",
         mesh={"dp": 2, "tp": 2}, rules="hsdp", B=4, segments=True, steps=2),
    dict(name="train_mesh_zero2_dp4", model="smol", mesh={"dp": 4},
         rules=None, zero=True, accum=2, B=8, segments=False, steps=3,
         nan_after=2),
)


def train_mesh_cfg(job):
    import torch
    from nbdistributed_tpu_torch.models import smol_135m_config
    if job["model"] == "smol":
        return smol_135m_config(dtype=torch.float32, remat=True,
                                n_layers=MESH_SMOL_LAYERS)
    # One of Mixtral's layers: the script's time budget (PERF.md §4).
    from nbdistributed_tpu_torch.models import mixtral_8x7b_config
    return mixtral_8x7b_config(n_layers=TRAIN_MESH_MOE_LAYERS,
                               dtype=torch.float32,
                               capacity_factor=MOE_LOSSLESS,
                               moe_dispatch="dropless")


def train_mesh_batch(job, cfg):
    """The job's whole batch on the card (every rank makes the same one
    and takes its rows); ``scale`` (ones) is what the NaN step poisons."""
    import torch
    batch = dict(packed_batch(cfg, job["B"], TRAIN_MESH_S,
                              TRAIN_MESH_BATCH_SEED))
    if not job["segments"]:
        del batch["segments"]
    batch["scale"] = torch.ones(job["B"], device="cuda")
    return batch


def train_mesh_reference(job):
    """The single-process step (the port's ``loss_fn`` or ``moe_loss_fn``
    and AdamW) on the whole tree and batch: each step's loss and
    gradient norm, and the final leaves on the host."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_moe_model,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                named_param_leaves)

    cfg = train_mesh_cfg(job)
    smol = job["model"] == "smol"
    params = init_params(cfg, 0) if smol else init_moe_model(cfg, 0)
    batch = train_mesh_batch(job, cfg)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    opt = AdamW(leaves, lr=TRAIN_MESH_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms = [], []
    for _ in range(job["steps"]):
        for p in leaves:
            p.grad = None
        loss = (loss_fn if smol else moe_loss_fn)(params, batch, cfg)
        loss.backward()
        gnorms.append(float(torch.stack([p.grad.float().pow(2).sum()
                                         for p in leaves]).sum().sqrt()))
        opt.step()
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = {path: t.detach().cpu() for path, t in named}
    del params, named, leaves, opt, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, peak_gb=peak), final


def send_shards(name, named, rules, mesh, send):
    """Send ``(path, tensor)`` shards of a tree cut by ``rules`` to the
    parent, each from the first rank that holds it (every other axis at
    coordinate 0), with its (shards, index) per dimension; returns the
    count sent."""
    import torch
    from nbdistributed_tpu_torch.parallel.mesh import spec_split
    sent = 0
    for path, t in named:
        node = rules
        for key in path.split("/"):
            node = node.get(key) if isinstance(node, dict) else None
        spec = tuple(node or ())
        used = {a for e in spec for a in
                ((e,) if isinstance(e, str) else (e or ()))}
        if any(mesh.index(a) for a in mesh.shape if a not in used):
            continue                 # another rank holds this slice too
        split = [spec_split(mesh, spec[d] if d < len(spec) else None)
                 for d in range(t.ndim)]
        # Into shared memory: the queue then passes a handle, not bytes.
        host = torch.empty(t.shape, dtype=t.dtype).share_memory_()
        host.copy_(t.detach())
        send(("leaf", name, path, split, host))
        sent += 1
    return sent


def train_mesh_job(job, counts, send):
    """One training job on this rank: the model built from the seed and
    cut to this rank's shard, the guarded step (ZeRO-2: with the NaN
    step), counts reset just before the steps and read per step; then
    each leaf shard this rank is the first holder of goes to the parent
    (``send``) to be held to the reference."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, fsdp_param_shardings,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                moe_model_shardings,
                                                named_param_leaves,
                                                param_leaves,
                                                param_shardings)
    from nbdistributed_tpu_torch.parallel import (apply_shardings, make_mesh,
                                                  make_tp_train_step,
                                                  make_zero2_train_step,
                                                  shard_batch)

    t_start = time.perf_counter()
    mesh = make_mesh(job["mesh"])
    cfg = train_mesh_cfg(job)
    torch.cuda.reset_peak_memory_stats()
    if job["model"] == "smol":
        rules = {"megatron": param_shardings(cfg),
                 "hsdp": fsdp_param_shardings(cfg, tp_axis="tp"),
                 None: None}[job["rules"]]
        params = init_params(cfg, 0)
        if rules is not None:
            params = apply_shardings(params, mesh, rules)

        def loss(p, b):
            return loss_fn(p, b, cfg, mesh=mesh, rules=rules) * \
                b["scale"].mean()
    else:
        rules = moe_model_shardings(cfg, tp_axis=None)
        params = seeded_moe_shard(cfg, 0, mesh, rules)

        def loss(p, b):
            return moe_loss_fn(p, b, cfg, mesh=mesh, rules=rules)
    opt = AdamW(param_leaves(params), lr=TRAIN_MESH_LR)
    batch = train_mesh_batch(job, cfg)
    if "dp" in mesh.shape:
        batch = shard_batch(batch, mesh)
    zero = None
    if job.get("zero"):
        step, init = make_zero2_train_step(loss, opt, mesh, rules, params,
                                           accum_steps=job["accum"],
                                           guard=True)
        zero = init(params)
    else:
        step = make_tp_train_step(loss, opt, mesh, rules, guard=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    losses, vs, secs, per_step, coll = [], [], [], [], []
    row = {}
    t_steps = time.perf_counter()

    def one(b):
        before, c0 = launch_counts(), dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lval, aux = step(params, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        coll.append(sum(counts[k] - c0[k] for k in counts))
        return float(lval), aux["v"].tolist()

    for i in range(job["steps"]):
        if i == job.get("nan_after"):
            bad = dict(batch, scale=batch["scale"].clone())
            if mesh.index("dp") == 0:
                bad["scale"][0] = float("nan")
            state = [zero.moments(t) for t in param_leaves(params)]
            snap = ([t.clone() for t in param_leaves(params)],
                    [{k: (v.clone() if torch.is_tensor(v) else v)
                      for k, v in st.items()} for st in state])
            _, v_bad = one(bad)
            same = all(torch.equal(a, b) for a, b in
                       zip(snap[0], param_leaves(params))) and all(
                all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                    else a[k] == b[k] for k in a)
                for a, b in zip(snap[1], state))
            row.update(nan_step_v=v_bad, nan_step_skipped_bitwise=same)
            del snap
        lval, v = one(batch)
        losses.append(lval)
        vs.append(v)
    if zero is not None:
        row["moment_fraction"] = sorted({
            zero.moments(t)["mu"].numel() / t.numel()
            for t in param_leaves(params)})
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_send = time.perf_counter()
    sent = send_shards(job["name"], named_param_leaves(params), rules, mesh,
                       send)
    steady = sorted(secs[1:]) or secs
    t_end = time.perf_counter()
    row.update(seconds=dict(setup=t_steps - t_start, steps=t_send - t_steps,
                            send=t_end - t_send),
               losses=losses, v=vs, launches_per_step=per_step,
               ms_per_step=[1e3 * x for x in secs],
               ms_per_step_median=1e3 * steady[len(steady) // 2],
               collectives_per_step=coll, collectives=dict(counts),
               peak_gb=peak, leaves_sent=sent,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               k3=sum(c["k3"] for c in per_step))
    del params, opt, step, batch, zero
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train_mesh(backend="gloo"):
    """Phase 19: the references here, then the four ranks train every
    job; every rank's losses equal, the losses within 1e-5 and each
    step's gradient norm within 1e-4 relative of the reference's, every
    leaf (gathered from the shards) within 1e-4 relative L2 of the
    reference's final leaf, K1/K2/K3 launches per rank per step as the
    model and accumulation give them, the ZeRO moments a quarter of each
    leaf and the NaN step skipped bitwise; no kernel rebuilt."""
    import torch

    ts = time.perf_counter()
    refs, finals, key_of = {}, {}, {}
    for job in TRAIN_MESH_JOBS:
        key = (job["model"], job["B"], job["segments"], job["steps"])
        key_of[job["name"]] = key
        if key not in refs:
            t0 = time.perf_counter()
            refs[key], finals[key] = train_mesh_reference(job)
            refs[key]["seconds"] = time.perf_counter() - t0
            say("train_mesh_reference", job=job["name"], **refs[key])
    acc, compare_s = {}, [0.0]

    def on_item(rank, item):
        t0 = time.perf_counter()
        _, name, path, split, arr = item
        ref = finals[key_of[name]][path]
        for d, (n, idx) in enumerate(split):
            if n > 1:
                w = ref.shape[d] // n
                ref = ref.narrow(d, idx * w, w)
        got = arr
        check(got.shape == ref.shape, f"{name} {path}: shard "
              f"{tuple(got.shape)} against {tuple(ref.shape)}")
        e = acc.setdefault(name, {}).setdefault(path, [0.0, 0.0, 0])
        e[0] += float(torch.linalg.vector_norm(got - ref)) ** 2
        e[1] += float(torch.linalg.vector_norm(ref)) ** 2
        e[2] += got.numel()
        compare_s[0] += time.perf_counter() - t0

    torch.cuda.empty_cache()
    t_ranks, t_wall = time.perf_counter(), time.time()
    ranks = run_mesh_ranks([dict(j, train=True) for j in TRAIN_MESH_JOBS],
                           backend, on_item)
    t_ranks = time.perf_counter() - t_ranks
    c0 = ranks[0]["clock"]
    clock = {"spawn_to_ready_s": c0["ready"] - t_wall,
             "ready_to_done_s": c0["done"] - c0["ready"],
             "done_to_joined_s": t_wall + t_ranks - c0["done"]}
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    rows = {}
    for job in TRAIN_MESH_JOBS:
        name, ref = job["name"], refs[key_of[job["name"]]]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        cfg = train_mesh_cfg(job)
        L = cfg.n_layers
        micro = job.get("accum", 1)
        want = ({"k1": 2 * L * micro, "k2": L * micro, "k3": L * micro}
                if job["model"] == "smol" else {"k1": L, "k2": L, "k3": L})
        check(all(p["losses"] == first["losses"] for p in per),
              f"{name}: the ranks' losses differ: "
              f"{[p['losses'] for p in per]}")
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(first["losses"], ref["losses"])]
        gnorm_rel = [abs(v[2] - g) / g for v, g in zip(first["v"],
                                                      ref["gnorms"])]
        leaf = {path: (e[0] / e[1]) ** 0.5 if e[1] else e[0] ** 0.5
                for path, e in acc.get(name, {}).items()}
        covered = {path: e[2] for path, e in acc.get(name, {}).items()}
        whole = {path: t.numel()
                 for path, t in finals[key_of[name]].items()}
        worst = max(leaf, key=leaf.get) if leaf else None
        launches_ok = all(c == want for p in per
                          for c in p["launches_per_step"])
        rows[name] = dict(
            mesh=job["mesh"], rules=job["rules"], layers=L, batch=job["B"],
            seq=TRAIN_MESH_S, steps=job["steps"], lr=TRAIN_MESH_LR,
            losses=first["losses"], reference_losses=ref["losses"],
            loss_rel_err=loss_rel, gnorm=[v[2] for v in first["v"]],
            reference_gnorm=ref["gnorms"], gnorm_rel_err=gnorm_rel,
            worst_leaf=worst, worst_leaf_rel_l2=leaf.get(worst),
            leaves=len(leaf), launches_per_step_rank0=first[
                "launches_per_step"], want_per_step=want,
            k1_launches_rank0=first["k1"], k2_launches_rank0=first["k2"],
            k3_launches_rank0=first["k3"],
            ms_per_step_median_per_rank=[p["ms_per_step_median"]
                                         for p in per],
            ms_per_step_rank0=first["ms_per_step"],
            collectives_per_step_rank0=first["collectives_per_step"],
            collectives_rank0=first["collectives"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            reference_peak_gb=ref["peak_gb"], seconds_rank0=first["seconds"],
            backend=backend,
            note=MESH_NOTE[backend],
            **{k: first[k] for k in ("nan_step_v", "nan_step_skipped_bitwise",
                                     "moment_fraction") if k in first})
        say(name, **rows[name])
        check(all(v[0] == 1.0 for p in per for v in p["v"]),
              f"{name}: a good step was skipped")
        check(max(loss_rel) <= TRAIN_MESH_LOSS_RTOL,
              f"{name}: losses {first['losses']} against {ref['losses']}")
        check(max(gnorm_rel) <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: gradient norms {rows[name]['gnorm']} against "
              f"{ref['gnorms']}")
        check(covered == whole, f"{name}: leaves not covered by the "
              f"shards: {sorted(set(whole) - set(covered))}")
        check(leaf[worst] <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: leaf {worst} {leaf[worst]} over "
              f"{TRAIN_MESH_LEAF_RTOL}")
        check(launches_ok, f"{name}: launches per step "
              f"{[p['launches_per_step'] for p in per]}, want {want}")
        if job.get("zero"):
            check(all(p["moment_fraction"] == [0.25] for p in per),
                  f"{name}: moment shards {first['moment_fraction']}")
            check(all(p["nan_step_v"][0] == 0.0
                      and p["nan_step_skipped_bitwise"] for p in per),
                  f"{name}: the NaN step was not skipped bitwise")
    rows["seconds"] = time.perf_counter() - ts
    say("train_mesh_seconds", seconds=rows["seconds"], ranks_s=t_ranks,
        rank0_clock=clock, compare_s=compare_s[0],
        references_s=sum(r["seconds"] for r in refs.values()))
    return rows


# ----------------------------------------------------------------------
# phase 20: sequence-parallel training.  K1, K2 and K3 first at a ring
# hop's geometry, here; then phase 18's four ranks (gloo on the one
# card; NCCL, one card each, with --mesh-nccl) train each job below from
# seed 0 with attention as the ring (or Ulysses) over sp, held to the
# single-process step on the whole tree and batch, run first here, as
# phase 19 holds its jobs.  Every ring hop is one K1 launch at the hop's
# global offsets, and one K2 and one K3 in the backward.

TRAIN_SP_S = 2048
ZIGZAG_S = 8192
ZIGZAG_WINDOW = 1024
ZIGZAG_SEED = 13
# The zigzag ring against one launch on the whole sequence: in fp32
# element by element at K1's and K2/K3's fp32 limits; in bf16 each hop's
# output (and dQ/dK/dV) is rounded to bf16 before the fp32 fold, as the
# JAX ring folds them, so a result carries up to one rounding a hop
# where one launch carries one: relative L2 per tensor, 2.5 bf16 ulps.
ZIGZAG_BF16_REL_L2 = 1e-2
# Largest first, as in phase 19.  K1/K2/K3 per rank per step: the
# plan's hops times the layers, K1 twice with remat (the MoE family runs
# without it); the zigzag job's four half-pair launches a hop, per run.
TRAIN_SP_JOBS = (
    dict(name="train_sp_ring_window_mistral_sp4", model="mistral",
         mesh={"sp": 4}, method="ring", B=1, S=8192, segments=False,
         steps=1),
    dict(name="grad_sp_moe_mixtral_sp2_ep2", model="mixtral",
         mesh={"sp": 2, "ep": 2}, method="ring", B=1, S=1024,
         segments=False, steps=1, grad_only=True),
    dict(name="train_sp_ulysses_tinyllama_sp2_tp2", model="tinyllama",
         mesh={"sp": 2, "tp": 2}, method="ulysses", rules="megatron", B=2,
         S=TRAIN_SP_S, segments=True, steps=2),
    dict(name="train_sp_ring_smol_sp4", model="smol", mesh={"sp": 4},
         method="ring", B=2, S=TRAIN_SP_S, segments=True, steps=2),
    dict(name="train_sp_ring_smol_dp2_sp2", model="smol",
         mesh={"dp": 2, "sp": 2}, method="ring", B=4, S=TRAIN_SP_S,
         segments=True, steps=2),
    dict(name="train_sp_zigzag_mistral_sp4", model="attention",
         mesh={"sp": 4}, B=1, S=ZIGZAG_S),
)
# Depth cut to fit four ranks of fp32 weights, gradients and AdamW
# moments on one card beside the reference (PERF.md, phase 20); Mistral
# at 1 layer, TinyLlama at 2 and SmolLM2 at 4 for the script's time
# budget (PERF.md §4).
SP_LAYERS = {"mistral": 1, "tinyllama": 2, "mixtral": 1,
             "smol": MESH_SMOL_LAYERS}


def phase_hop_kernels():
    """K1, K2 and K3 at the geometry of ring hops of Mistral-7B's
    attention (H 32, Hkv 8, D 128, chunks of 1024, zigzag halves of
    512), bf16 and fp32, each through the wrapper the ring calls against
    its plain version: the diagonal hop, a fully visible and a fully
    masked one, window 1536 at its edge and past it, zigzag half-pairs
    and key-side segments unlike the query side's.  Rows no key reaches
    are undefined on both sides (K1: lse ~ -6.9e29, the plain version
    -1e30 + log Sk): they must agree on which rows those are, and only
    the others are compared.  K2/K3 run from a whole-sequence lse and
    delta (this hop folded with the diagonal one), as the ring runs
    them; a fully masked hop's dK/dV must be exactly zero.  Returns the
    worst bf16 errors of K1, K2 and K3."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    H, Hkv, D, C, Z = 32, 8, 128, 1024, 512
    # name, chunk length, (q_off, k_off), window, key-side segments
    cases = [
        ("hop_diagonal", C, (C, C), None, False),
        ("hop_fully_visible", C, (2 * C, 0), None, False),
        ("hop_fully_masked", C, (0, C), None, False),
        ("hop_window1536_edge", C, (2 * C, C), 1536, False),
        ("hop_window1536_rows_past", C, (3 * C, C), 1536, False),
        ("zigzag_half_diagonal", Z, (Z, Z), None, False),
        ("zigzag_half_masked", Z, (Z, 5 * Z), None, False),
        ("zigzag_half_visible", Z, (6 * Z, 2 * Z), None, False),
        ("zigzag_half_window768", Z, (6 * Z, 5 * Z), 768, False),
        ("hop_kv_segments_differ", C, (2 * C, C), None, True),
    ]
    worst = {"k1": 0.0, "dq": 0.0, "dkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for name, L, offs, window, segs in cases:
            g = torch.Generator(device="cuda").manual_seed(len(name))
            q, do = (torch.randn(1, L, H, D, generator=g, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v, kd, vd = (torch.randn(1, L, Hkv, D, generator=g,
                                        device="cuda").to(dtype)
                            for _ in range(4))
            qseg = kseg = None
            if segs:
                pos = torch.arange(L, device="cuda")
                qseg = (5 + torch.bucketize(pos, torch.tensor(
                    [200, 600], device="cuda"), right=True))[None]
                kseg = (4 + torch.bucketize(pos, torch.tensor(
                    [300, 900], device="cuda"), right=True))[None]
                qseg, kseg = (t.to(torch.int32).contiguous()
                              for t in (qseg, kseg))
            args = dict(causal=True, scale=D ** -0.5, offsets=offs,
                        window=window, segment_ids=qseg,
                        kv_segment_ids=kseg)
            label = f"{name}_{str(dtype).split('.')[-1]}"
            out, lse = A._flash_forward(q, k, v, **args)
            ref, ref_lse = A._flash_forward_plain(q, k, v, **args)
            undef = ref_lse <= -1e29                      # (B, H, Sq)
            check(torch.equal(lse <= -1e29, undef),
                  f"K1 {label}: rows without keys differ from the plain "
                  f"version's")
            rows = undef.transpose(1, 2)[..., None]       # (B, Sq, H, 1)
            e_k1 = check_k1(label, out.masked_fill(rows, 0),
                            lse.masked_fill(undef, 0),
                            ref.masked_fill(rows, 0),
                            ref_lse.masked_fill(undef, 0), dtype)
            # The whole sequence's lse: this hop folded with the
            # diagonal one (finite on every row: each query sees
            # itself), and delta from this hop's output.
            _, lse_d = A._flash_forward_plain(
                q, kd, vd, **dict(args, offsets=(offs[0], offs[0]),
                                  kv_segment_ids=qseg))
            L_all = torch.logaddexp(ref_lse, lse_d)
            delta = A._flash_bwd_prep(ref, do)
            got = A._flash_backward_hop(q, k, v, do, L_all, delta, **args)
            want = A._flash_backward_plain(q, k, v, None, L_all, do,
                                           delta=delta, **args)
            torch.cuda.synchronize()
            row = check_k23(label, got, want, dtype)
            if bool(undef.all()):
                check(all(bool((t == 0).all()) for t in got),
                      f"K2/K3 {label}: a hop no query sees must give "
                      f"zero gradients")
            say("hop_kernel_case", case=label, offsets=offs, window=window,
                undefined_rows=int(undef.sum()), rows=undef.numel())
            if dtype == torch.bfloat16:
                worst["k1"] = max(worst["k1"], e_k1)
                worst["dq"] = max(worst["dq"], row["dq"]["max_abs_err"])
                worst["dkv"] = max(worst["dkv"], row["dk"]["max_abs_err"],
                                   row["dv"]["max_abs_err"])
    return worst


def train_sp_cfg(job):
    import torch
    from nbdistributed_tpu_torch.models import (mistral_7b_config,
                                                mixtral_8x7b_config,
                                                smol_135m_config,
                                                tinyllama_1b_config)
    model = job["model"]
    if model == "mixtral":
        return mixtral_8x7b_config(
            dtype=torch.float32, n_layers=SP_LAYERS[model],
            capacity_factor=MOE_LOSSLESS, moe_dispatch="dropless")
    make = {"smol": smol_135m_config, "tinyllama": tinyllama_1b_config,
            "mistral": mistral_7b_config}[model]
    kw = {"n_layers": SP_LAYERS[model]} if model in SP_LAYERS else {}
    return make(dtype=torch.float32, remat=True, **kw)


def train_sp_want(job, cfg):
    """K1/K2/K3 per rank per step: one of each per hop per layer, K1
    again in the remat recompute."""
    from nbdistributed_tpu_torch.parallel import hop_plan
    n = job["mesh"]["sp"]
    C = job["S"] // n
    hops = (1 if job["method"] == "ulysses" else
            len(hop_plan(n, C, cfg.sliding_window)))
    L = cfg.n_layers
    return {"k1": hops * L * (2 if cfg.remat else 1), "k2": hops * L,
            "k3": hops * L}


def train_sp_batch(job, cfg):
    batch = dict(packed_batch(cfg, job["B"], job["S"],
                              TRAIN_MESH_BATCH_SEED))
    if not job["segments"]:
        del batch["segments"]
    return batch


def zigzag_inputs(dtype):
    """q, k, v and the output cotangent of Mistral-7B's attention over
    the whole sequence (B 1, S 8192, H 32, Hkv 8, D 128) from
    ``ZIGZAG_SEED``: the same numbers in the parent and in every rank."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(ZIGZAG_SEED)
    shapes = [(1, ZIGZAG_S, 32, 128), (1, ZIGZAG_S, 8, 128),
              (1, ZIGZAG_S, 8, 128), (1, ZIGZAG_S, 32, 128)]
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in shapes]


ZIGZAG_RUNS = tuple((d, w) for d in ("bfloat16", "float32")
                    for w in (None, ZIGZAG_WINDOW))


def train_sp_reference(job):
    """The single-process reference: for a training job the step
    (``loss_fn`` or ``moe_loss_fn`` and AdamW; for a gradient job the
    gradients alone) on the whole tree and batch, with each step's loss
    and gradient norm and the final leaves (or the gradients) on the
    host; for the zigzag job ``flash_attention`` on the whole sequence
    in natural order, its output and gradients on the host."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_moe_model,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                named_param_leaves)
    from nbdistributed_tpu_torch.ops import flash_attention

    torch.cuda.reset_peak_memory_stats()
    if job["model"] == "attention":
        final = {}
        for dname, window in ZIGZAG_RUNS:
            q, k, v, do = zigzag_inputs(getattr(torch, dname))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            out = flash_attention(q, k, v, True, None, window)
            out.backward(do)
            final[(dname, window)] = [t.detach().cpu() for t in
                                      (out, q.grad, k.grad, v.grad)]
            del q, k, v, do, out
        return dict(peak_gb=torch.cuda.max_memory_allocated() / 1e9), final
    cfg = train_sp_cfg(job)
    moe = job["model"] == "mixtral"
    params = init_moe_model(cfg, 0) if moe else init_params(cfg, 0)
    batch = train_sp_batch(job, cfg)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    opt = None if job.get("grad_only") else AdamW(leaves, lr=TRAIN_MESH_LR)
    losses, gnorms = [], []
    for _ in range(job["steps"]):
        for p in leaves:
            p.grad = None
        loss = (moe_loss_fn if moe else loss_fn)(params, batch, cfg)
        loss.backward()
        gnorms.append(float(torch.stack([p.grad.float().pow(2).sum()
                                         for p in leaves]).sum().sqrt()))
        if opt is not None:
            opt.step()
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = {path: (t.grad if opt is None else t).detach().cpu()
             for path, t in named}
    del params, named, leaves, opt, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, peak_gb=peak), final


class KeepGrads:
    """An optimizer for a gradient-only job: keeps the gradients the step
    gives it, by id of their leaf, and updates nothing."""

    def __init__(self, leaves):
        self.param_groups = [{"params": list(leaves)}]
        self.grads = {}

    def step(self):
        self.grads = {id(p): p.grad.detach().clone()
                      for p in self.param_groups[0]["params"]}


def zigzag_sp_job(job, counts, send, mesh):
    """The zigzag ring on this rank: each run of ``ZIGZAG_RUNS`` on its
    two half-chunks of the zigzag-ordered sequence, forward and
    backward, launches and collectives counted from just before to just
    after; rank 0 sends the gathered output and gradients."""
    import torch
    from nbdistributed_tpu_torch.parallel import (hop_plan, ring_attention,
                                                  zigzag_shard)
    from nbdistributed_tpu_torch.parallel.mesh import local_slice

    n, me = mesh.size("sp"), mesh.index("sp")
    row = {}
    for dname, window in ZIGZAG_RUNS:
        dtype = getattr(torch, dname)
        chunks = [local_slice(zigzag_shard(t, n), 1, n, me).contiguous()
                  for t in zigzag_inputs(dtype)]
        q, k, v = (t.requires_grad_() for t in chunks[:3])
        torch.cuda.synchronize()
        reset_launch_counts()
        c0 = dict(counts)
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, mesh, use_flash=True,
                             schedule="zigzag", window=window)
        out.backward(chunks[3])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hops = len(hop_plan(n, q.shape[1], window, "zigzag"))
        key = f"{dname}_window{window}"
        row[key] = dict(launches=launch_counts(), hops=hops,
                        want={k_: 4 * hops for k_ in ("k1", "k2", "k3")},
                        ms=1e3 * secs,
                        collectives=sum(counts[c] - c0[c] for c in counts))
        whole = [mesh.all_gather(t.detach().contiguous(), "sp", 1)
                 for t in (out, q.grad, k.grad, v.grad)]
        if me == 0:
            host = []
            for t in whole:
                h = torch.empty(t.shape, dtype=t.dtype).share_memory_()
                h.copy_(t)
                host.append(h)
            send(("zigzag", job["name"], (dname, window), host))
        del q, k, v, out, chunks, whole
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row


def train_sp_job(job, counts, send):
    """One sequence-parallel job on this rank: the model from the seed cut
    to this rank's shard, its rows of the batch (whole rows: the loss
    cuts its chunk), the guarded step over dp and sp (for a gradient
    job, gradients and no update), counts reset just before the steps
    and read per step; then each leaf (or gradient) shard this rank is
    the first holder of goes to the parent."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, SeqParallel,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                moe_model_shardings,
                                                named_param_leaves,
                                                param_leaves,
                                                param_shardings)
    from nbdistributed_tpu_torch.parallel import (apply_shardings, make_mesh,
                                                  make_tp_train_step,
                                                  shard_batch)

    t_start = time.perf_counter()
    mesh = make_mesh(job["mesh"])
    torch.cuda.reset_peak_memory_stats()
    if job["model"] == "attention":
        return zigzag_sp_job(job, counts, send, mesh)
    cfg = train_sp_cfg(job)
    sp = SeqParallel(mesh, method=job["method"])
    moe = job["model"] == "mixtral"
    if moe:
        rules = moe_model_shardings(cfg, tp_axis=None)
        params = seeded_moe_shard(cfg, 0, mesh, rules)
    else:
        rules = param_shardings(cfg) if job.get("rules") else None
        params = init_params(cfg, 0)
        if rules is not None:
            params = apply_shardings(params, mesh, rules)

    def loss(p, b):
        fn = moe_loss_fn if moe else loss_fn
        return fn(p, b, cfg, rules=rules, sp=sp)

    leaves = param_leaves(params)
    opt = (KeepGrads(leaves) if job.get("grad_only")
           else AdamW(leaves, lr=TRAIN_MESH_LR))
    batch = train_sp_batch(job, cfg)
    if "dp" in mesh.shape:
        batch = shard_batch(batch, mesh)
    step = make_tp_train_step(loss, opt, mesh, rules, guard=True,
                              sp_axis="sp")
    torch.cuda.synchronize()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    losses, vs, secs, per_step, coll = [], [], [], [], []
    t_steps = time.perf_counter()
    for _ in range(job["steps"]):
        before, c0 = launch_counts(), dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lval, aux = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        coll.append(sum(counts[k] - c0[k] for k in counts))
        losses.append(float(lval))
        vs.append(aux["v"].tolist())
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_send = time.perf_counter()
    named = named_param_leaves(params)
    if job.get("grad_only"):
        named = [(path, opt.grads[id(t)]) for path, t in named]
    sent = send_shards(job["name"], named, rules, mesh, send)
    t_end = time.perf_counter()
    row = dict(seconds=dict(setup=t_steps - t_start, steps=t_send - t_steps,
                            send=t_end - t_send),
               losses=losses, v=vs, launches_per_step=per_step,
               want_per_step=train_sp_want(job, cfg),
               ms_per_step=[1e3 * x for x in secs],
               collectives_per_step=coll, collectives=dict(counts),
               peak_gb=peak, leaves_sent=sent,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               k3=sum(c["k3"] for c in per_step))
    del params, opt, step, batch, named, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train_sp(backend="gloo"):
    """Phase 20: the references here, then the four ranks run every job;
    every rank's losses equal, the losses within 1e-5 and each step's
    gradient norm within 1e-4 relative of the reference's, every leaf
    (or gradient) within 1e-4 relative L2, K1/K2/K3 launches per rank per
    step the plan's; the zigzag ring's output and gradients within K1's
    and K2/K3's fp32 limits of ``flash_attention`` on the whole sequence
    (bf16: ``ZIGZAG_BF16_REL_L2``); no kernel rebuilt."""
    import torch
    from nbdistributed_tpu_torch.parallel import zigzag_unshard

    ts = time.perf_counter()
    refs, finals = {}, {}
    for job in TRAIN_SP_JOBS:
        t0 = time.perf_counter()
        refs[job["name"]], finals[job["name"]] = train_sp_reference(job)
        refs[job["name"]]["seconds"] = time.perf_counter() - t0
        say("train_sp_reference", job=job["name"], **refs[job["name"]])
    acc, zz, compare_s = {}, {}, [0.0]

    def on_item(rank, item):
        t0 = time.perf_counter()
        if item[0] == "zigzag":
            _, name, key, tensors = item
            n = MESH_WORLD
            dname = key[0]
            want = finals[name][key]
            tols = [K1_TOL[dname]] + [K23_TOL[dname]] * 3
            zz[key] = {}
            for label, got, w, (atol, rtol) in zip(
                    ("out", "dq", "dk", "dv"), tensors, want, tols):
                got = zigzag_unshard(got, n)
                r = dict(max_abs_err=max_err(got, w), rel_l2=rel_l2(got, w),
                         tol_ratio=tol_ratio(got, w, atol, rtol))
                r["ok"] = (r["rel_l2"] <= ZIGZAG_BF16_REL_L2
                           if dname == "bfloat16" else r["tol_ratio"] <= 1)
                zz[key][label] = r
        else:
            _, name, path, split, arr = item
            ref = finals[name][path]
            for d, (n, idx) in enumerate(split):
                if n > 1:
                    w = ref.shape[d] // n
                    ref = ref.narrow(d, idx * w, w)
            check(arr.shape == ref.shape, f"{name} {path}: shard "
                  f"{tuple(arr.shape)} against {tuple(ref.shape)}")
            e = acc.setdefault(name, {}).setdefault(path, [0.0, 0.0, 0])
            e[0] += float(torch.linalg.vector_norm(arr - ref)) ** 2
            e[1] += float(torch.linalg.vector_norm(ref)) ** 2
            e[2] += arr.numel()
        compare_s[0] += time.perf_counter() - t0

    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_mesh_ranks([dict(j, train_sp=True) for j in TRAIN_SP_JOBS],
                           backend, on_item)
    t_ranks = time.perf_counter() - t_ranks
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    rows = {}
    for job in TRAIN_SP_JOBS:
        name, ref = job["name"], refs[job["name"]]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        if job["model"] == "attention":
            runs = {f"{d}_window{w}": dict(first[f"{d}_window{w}"],
                                           errors=zz.get((d, w)))
                    for d, w in ZIGZAG_RUNS}
            rows[name] = dict(mesh=job["mesh"], seq=job["S"], runs=runs,
                              peak_gb_per_rank=[p["peak_gb"] for p in per],
                              reference_peak_gb=ref["peak_gb"],
                              k1_launches_rank0=sum(
                                  r["launches"]["k1"] for r in runs.values()),
                              k2_launches_rank0=sum(
                                  r["launches"]["k2"] for r in runs.values()),
                              k3_launches_rank0=sum(
                                  r["launches"]["k3"] for r in runs.values()),
                              backend=backend, note=MESH_NOTE[backend])
            say(name, **rows[name])
            for key, r in runs.items():
                check(all(p[key]["launches"] == r["want"] for p in per),
                      f"{name} {key}: launches "
                      f"{[p[key]['launches'] for p in per]}, want "
                      f"{r['want']}")
                check(r["errors"] is not None and all(
                    e["ok"] for e in r["errors"].values()),
                      f"{name} {key}: {r['errors']} over tolerance")
            continue
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(first["losses"], ref["losses"])]
        gnorm_rel = [abs(v[2] - g) / g for v, g in zip(first["v"],
                                                      ref["gnorms"])]
        leaf = {path: (e[0] / e[1]) ** 0.5 if e[1] else e[0] ** 0.5
                for path, e in acc.get(name, {}).items()}
        covered = {path: e[2] for path, e in acc.get(name, {}).items()}
        whole = {path: t.numel() for path, t in finals[name].items()}
        worst = max(leaf, key=leaf.get) if leaf else None
        want = first["want_per_step"]
        rows[name] = dict(
            mesh=job["mesh"], method=job["method"],
            rules=job.get("rules"), layers=train_sp_cfg(job).n_layers,
            batch=job["B"], seq=job["S"], steps=job["steps"],
            grad_only=bool(job.get("grad_only")),
            losses=first["losses"], reference_losses=ref["losses"],
            loss_rel_err=loss_rel, gnorm=[v[2] for v in first["v"]],
            reference_gnorm=ref["gnorms"], gnorm_rel_err=gnorm_rel,
            worst_leaf=worst, worst_leaf_rel_l2=leaf.get(worst),
            leaves=len(leaf),
            launches_per_step_rank0=first["launches_per_step"],
            want_per_step=want, k1_launches_rank0=first["k1"],
            k2_launches_rank0=first["k2"], k3_launches_rank0=first["k3"],
            ms_per_step_rank0=first["ms_per_step"],
            ms_per_step_per_rank=[p["ms_per_step"] for p in per],
            collectives_per_step_rank0=first["collectives_per_step"],
            collectives_rank0=first["collectives"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            reference_peak_gb=ref["peak_gb"], seconds_rank0=first["seconds"],
            backend=backend, note=MESH_NOTE[backend])
        say(name, **rows[name])
        check(all(p["losses"] == first["losses"] for p in per),
              f"{name}: the ranks' losses differ: "
              f"{[p['losses'] for p in per]}")
        check(all(v[0] == 1.0 for p in per for v in p["v"]),
              f"{name}: a good step was skipped")
        check(max(loss_rel) <= TRAIN_MESH_LOSS_RTOL,
              f"{name}: losses {first['losses']} against {ref['losses']}")
        check(max(gnorm_rel) <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: gradient norms {rows[name]['gnorm']} against "
              f"{ref['gnorms']}")
        check(covered == whole, f"{name}: leaves not covered by the "
              f"shards: {sorted(set(whole) - set(covered))}")
        check(leaf[worst] <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: leaf {worst} {leaf[worst]} over "
              f"{TRAIN_MESH_LEAF_RTOL}")
        check(all(c == want for p in per for c in p["launches_per_step"]),
              f"{name}: launches per step "
              f"{[p['launches_per_step'] for p in per]}, want {want}")
    rows["seconds"] = time.perf_counter() - ts
    say("train_sp_seconds", seconds=rows["seconds"], ranks_s=t_ranks,
        compare_s=compare_s[0],
        references_s=sum(r["seconds"] for r in refs.values()))
    return rows


# ----------------------------------------------------------------------
# phase 21: pipeline-parallel training.  First the remat "dots" policy
# on the training shape here (single process).  Then phase 18's four
# ranks (gloo on the one card; NCCL, one card each, with --mesh-nccl)
# train each job below from seed 0 with the layer stack pipelined over
# pp, held to the single-process step on the whole tree and batch, run
# first here, as phase 19 holds its jobs; and time the ring-decomposed
# all-gather matmul against an all-gather and one product.  Every stage
# runs its layers' K1 forward and K2 + K3 backward per microbatch.

TRAIN_PP_S = 512
TRAIN_PP_LR = 1e-4
# Depth cut 32 -> 4 (one layer a stage) so that four ranks' fp32
# weights, gradients and AdamW moments fit one card beside the rest
# (PERF.md, phase 21); widths are the published ones.  SmolLM2 at
# phases 19-20's depth (MESH_SMOL_LAYERS), half a stage, for the
# script's time budget (PERF.md §4).  Largest first, as in phase 19.
TRAIN_PP_JOBS = (
    dict(name="train_pp_gpipe_mistral_pp4", model="mistral",
         mesh={"pp": 4}, schedule="gpipe", B=16, M=16, steps=1),
    dict(name="train_pp_1f1b_mistral_pp4", model="mistral",
         mesh={"pp": 4}, schedule="1f1b", B=16, M=16, steps=1),
    dict(name="train_pp_1f1b_smol_dp2_pp2", model="smol",
         mesh={"dp": 2, "pp": 2}, schedule="1f1b", B=8, M=4, steps=2,
         batch_axis="dp"),
)
PP_LAYERS = {"mistral": 4}
# C4's yardstick: a Megatron column product of Mistral's MLP on tp4,
# each rank's 2048 rows of x (8192 in all) against its 14336/4 columns.
OVERLAP_JOB = dict(name="overlap_allgather_matmul_tp4", mesh={"tp": 4},
                   rows=2048, d_model=4096, cols=14336 // 4, iters=10)
DOTS_REL = 1e-6


def train_pp_cfg(job):
    import torch
    from nbdistributed_tpu_torch.models import (mistral_7b_config,
                                                smol_135m_config)
    if job["model"] == "mistral":
        return mistral_7b_config(dtype=torch.float32,
                                 n_layers=PP_LAYERS["mistral"])
    return smol_135m_config(dtype=torch.float32, n_layers=MESH_SMOL_LAYERS)


def train_pp_batch(job, cfg):
    """The job's tokens (the pipelined losses take no segments), the
    same in the parent and in every rank."""
    return {"tokens": packed_batch(cfg, job["B"], TRAIN_PP_S,
                                   TRAIN_MESH_BATCH_SEED)["tokens"]}


def train_pp_want(job, cfg, stage):
    """K1/K2/K3 a step on the rank of ``stage``: the stage's layers per
    microbatch; under 1F1B K1 twice (the forward sub-step and the
    backward's recompute) but on the last stage, whose forward and
    backward of a microbatch share one forward."""
    n = job["mesh"]["pp"]
    per = cfg.n_layers // n * job["M"]
    twice = job["schedule"] == "1f1b" and stage < n - 1
    return {"k1": per * (2 if twice else 1), "k2": per, "k3": per}


def train_pp_reference(job):
    """The single-process step (``loss_fn`` and AdamW) on the whole tree
    and batch: each step's loss and gradient norm, the final leaves on
    the host."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params, loss_fn,
                                                named_param_leaves)

    cfg = train_pp_cfg(job)
    params = init_params(cfg, 0)
    batch = train_pp_batch(job, cfg)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    opt = AdamW(leaves, lr=TRAIN_PP_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms = [], []
    for _ in range(job["steps"]):
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        gnorms.append(float(torch.stack([p.grad.float().pow(2).sum()
                                         for p in leaves]).sum().sqrt()))
        opt.step()
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = {path: t.detach().cpu() for path, t in named}
    del params, named, leaves, opt, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, peak_gb=peak), final


def train_pp_job(job, counts, send):
    """One pipelined job on this rank: the model from the seed, staged
    and cut to this rank's stage slice, the GPipe or 1F1B step through
    an AdamW that records each step's gradient norm (the stage leaves'
    squares summed over pp, the replicated leaves' once), counts reset
    just before the steps and read per step; then each leaf this rank is
    the first holder of goes to the parent, a stage slice as its rows of
    the ``(L, ...)`` stack."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_pp_1f1b_train_step,
                                                make_pp_train_step,
                                                named_param_leaves,
                                                param_leaves,
                                                pp_apply_shardings,
                                                pp_stage_params)
    from nbdistributed_tpu_torch.parallel import P, make_mesh

    t_start = time.perf_counter()
    mesh = make_mesh(job["mesh"])
    cfg = train_pp_cfg(job)
    n, stage = mesh.size("pp"), mesh.index("pp")
    params = pp_apply_shardings(pp_stage_params(init_params(cfg, 0), n),
                                mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    staged = {id(t) for path, t in named_param_leaves(params)
              if path.startswith("layers_pp/")}

    class NormAdamW(AdamW):
        def step(self):
            ps = [p for g in self.param_groups for p in g["params"]]
            sq = [torch.stack([p.grad.float().pow(2).sum() for p in ps
                               if (id(p) in staged) == s]).sum()
                  for s in (True, False)]
            self.gnorms.append(float((mesh.psum(sq[0], "pp")
                                      + sq[1]).sqrt()))
            return super().step()

    opt = NormAdamW(param_leaves(params), lr=TRAIN_PP_LR)
    opt.gnorms = []
    if job["schedule"] == "gpipe":
        step = make_pp_train_step(cfg, opt, mesh, n_microbatches=job["M"])
    else:
        step = make_pp_1f1b_train_step(cfg, opt, mesh,
                                       n_microbatches=job["M"],
                                       batch_axis=job.get("batch_axis"))
    batch = train_pp_batch(job, cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    losses, secs, per_step, coll = [], [], [], []
    t_steps = time.perf_counter()
    for _ in range(job["steps"]):
        before, c0 = launch_counts(), dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        coll.append(sum(counts[k] - c0[k] for k in counts))
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_send = time.perf_counter()
    named = []
    for path, t in named_param_leaves(params):
        if path.startswith("layers_pp/"):
            path, t = "layers/" + path[len("layers_pp/"):], t[0]
        named.append((path, t))
    rules = {"layers": {path[len("layers/"):]: P("pp") for path, _ in named
                        if path.startswith("layers/")}}
    sent = send_shards(job["name"], named, rules, mesh, send)
    t_end = time.perf_counter()
    row = dict(seconds=dict(setup=t_steps - t_start, steps=t_send - t_steps,
                            send=t_end - t_send),
               stage=stage, losses=losses, gnorms=opt.gnorms,
               launches_per_step=per_step,
               want_per_step=train_pp_want(job, cfg, stage),
               ms_per_step=[1e3 * x for x in secs],
               collectives_per_step=coll, collectives=dict(counts),
               peak_gb=peak, leaves_sent=sent,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               k3=sum(c["k3"] for c in per_step))
    del params, opt, step, batch, named
    gc.collect()
    torch.cuda.empty_cache()
    return row


def overlap_job(job, counts, send):
    """C4's yardstick on this rank: ``allgather_matmul`` (each hop posted
    before the product of the rows it carries on) against
    ``all_gather`` then one ``torch.matmul``, bf16, timed in the order
    ring, gather, gather, ring (``iters`` calls each, between barriers),
    and the two results' relative L2."""
    import torch
    from nbdistributed_tpu_torch.parallel import allgather_matmul, make_mesh

    mesh = make_mesh(job["mesh"])
    g = torch.Generator(device="cuda").manual_seed(17 + mesh.index("tp"))
    x = torch.randn(job["rows"], job["d_model"], generator=g, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn(job["d_model"], job["cols"], generator=g, device="cuda",
                    dtype=torch.bfloat16) / job["d_model"] ** 0.5
    fns = {"ring": lambda: allgather_matmul(x, w, mesh, "tp"),
           "gather_then_matmul": lambda: mesh.all_gather(x, "tp", 0) @ w}
    ms = {k: [] for k in fns}
    for name in ("ring", "gather_then_matmul", "gather_then_matmul",
                 "ring"):
        fns[name]()
        torch.cuda.synchronize()
        mesh.psum(torch.zeros(1, device="cuda"), "tp")
        t0 = time.perf_counter()
        for _ in range(job["iters"]):
            fns[name]()
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / job["iters"])
    a, b = fns["ring"]().float(), fns["gather_then_matmul"]().float()
    return dict(ms=ms, rel_l2=float((a - b).norm() / b.norm()),
                shape=dict(x=[job["rows"], job["d_model"]],
                           w=[job["d_model"], job["cols"]]))


def phase_remat_dots(seed=0):
    """``remat_policy="dots"`` on the SmolLM2 training shape (bf16, B=4 x
    S=2048 packed documents, one AdamW step, one process) against full
    remat and none: the loss within ``DOTS_REL`` of full remat's, K1 60
    (the forward and the recompute of attention), K2 and K3 30; peak GB
    and ms of the step for each."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves,
                                                smol_135m_config)

    rows = {}
    for name, kw in (("none", {}), ("full", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        cfg = smol_135m_config(**kw)
        params = init_params(cfg, seed)
        batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
        step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(step(params, batch))
        torch.cuda.synchronize()
        rows[name] = dict(loss=loss, ms=1e3 * (time.perf_counter() - t0),
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=launch_counts())
        del params, batch, step
    L = N_LAYERS_SMOL
    want = {"k1": 2 * L, "k2": L, "k3": L}
    rel = abs(rows["dots"]["loss"] - rows["full"]["loss"]) / abs(
        rows["full"]["loss"])
    say("train_remat_dots_bf16", **rows, loss_rel_dots_vs_full=rel,
        want_dots=want)
    check(rel <= DOTS_REL, f"dots loss {rows['dots']['loss']} against full "
          f"remat's {rows['full']['loss']}")
    check(rows["dots"]["launches"] == want, f"dots launched "
          f"{rows['dots']['launches']}, want {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows, loss_rel_dots_vs_full=rel)


def phase_train_pp(backend="gloo"):
    """Phase 21: the references here, then the four ranks run every job
    and the overlap yardstick; every rank's losses equal, the losses
    within 1e-5 and each step's gradient norm within 1e-4 relative of the
    reference's, every leaf (the stage slices as rows of the stack)
    within 1e-4 relative L2, the 1F1B losses within 1e-5 of GPipe's, and
    K1/K2/K3 launches per rank per step the schedule's; no kernel
    rebuilt."""
    import torch

    ts = time.perf_counter()
    refs, finals, key_of = {}, {}, {}
    for job in TRAIN_PP_JOBS:
        key = (job["model"], job["B"], job["steps"])
        key_of[job["name"]] = key
        if key not in refs:
            t0 = time.perf_counter()
            refs[key], finals[key] = train_pp_reference(job)
            refs[key]["seconds"] = time.perf_counter() - t0
            say("train_pp_reference", job=job["name"], **refs[key])
    acc, compare_s = {}, [0.0]

    def on_item(rank, item):
        t0 = time.perf_counter()
        _, name, path, split, arr = item
        ref = finals[key_of[name]][path]
        for d, (n, idx) in enumerate(split):
            if n > 1:
                w = ref.shape[d] // n
                ref = ref.narrow(d, idx * w, w)
        check(arr.shape == ref.shape, f"{name} {path}: shard "
              f"{tuple(arr.shape)} against {tuple(ref.shape)}")
        e = acc.setdefault(name, {}).setdefault(path, [0.0, 0.0, 0])
        e[0] += float(torch.linalg.vector_norm(arr - ref)) ** 2
        e[1] += float(torch.linalg.vector_norm(ref)) ** 2
        e[2] += arr.numel()
        compare_s[0] += time.perf_counter() - t0

    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    jobs = [dict(j, train_pp=True) for j in TRAIN_PP_JOBS]
    ranks = run_mesh_ranks(jobs + [dict(OVERLAP_JOB, overlap=True)],
                           backend, on_item)
    t_ranks = time.perf_counter() - t_ranks
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    rows = {}
    for job in TRAIN_PP_JOBS:
        name, ref = job["name"], refs[key_of[job["name"]]]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(first["losses"], ref["losses"])]
        gnorm_rel = [abs(a - b) / b
                     for a, b in zip(first["gnorms"], ref["gnorms"])]
        leaf = {path: (e[0] / e[1]) ** 0.5 if e[1] else e[0] ** 0.5
                for path, e in acc.get(name, {}).items()}
        covered = {path: e[2] for path, e in acc.get(name, {}).items()}
        whole = {path: t.numel()
                 for path, t in finals[key_of[name]].items()}
        worst = max(leaf, key=leaf.get) if leaf else None
        rows[name] = dict(
            mesh=job["mesh"], schedule=job["schedule"],
            layers=train_pp_cfg(job).n_layers, batch=job["B"],
            seq=TRAIN_PP_S, microbatches=job["M"], steps=job["steps"],
            lr=TRAIN_PP_LR, losses=first["losses"],
            reference_losses=ref["losses"], loss_rel_err=loss_rel,
            gnorm=first["gnorms"], reference_gnorm=ref["gnorms"],
            gnorm_rel_err=gnorm_rel, worst_leaf=worst,
            worst_leaf_rel_l2=leaf.get(worst), leaves=len(leaf),
            stage_per_rank=[p["stage"] for p in per],
            launches_per_step_per_rank=[p["launches_per_step"]
                                        for p in per],
            want_per_step_per_rank=[p["want_per_step"] for p in per],
            k1_launches_rank0=first["k1"], k2_launches_rank0=first["k2"],
            k3_launches_rank0=first["k3"],
            ms_per_step_per_rank=[p["ms_per_step"] for p in per],
            collectives_per_step_rank0=first["collectives_per_step"],
            collectives_rank0=first["collectives"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            reference_peak_gb=ref["peak_gb"], seconds_rank0=first["seconds"],
            backend=backend, note=MESH_NOTE[backend])
        say(name, **rows[name])
        check(all(p["losses"] == first["losses"] for p in per),
              f"{name}: the ranks' losses differ: "
              f"{[p['losses'] for p in per]}")
        check(all(p["gnorms"] == first["gnorms"] for p in per),
              f"{name}: the ranks' gradient norms differ")
        check(max(loss_rel) <= TRAIN_MESH_LOSS_RTOL,
              f"{name}: losses {first['losses']} against {ref['losses']}")
        check(max(gnorm_rel) <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: gradient norms {first['gnorms']} against "
              f"{ref['gnorms']}")
        check(covered == whole, f"{name}: leaves not covered by the "
              f"shards: {sorted(set(whole) - set(covered))}")
        check(leaf[worst] <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: leaf {worst} {leaf[worst]} over "
              f"{TRAIN_MESH_LEAF_RTOL}")
        check(all(c == p["want_per_step"] for p in per
                  for c in p["launches_per_step"]),
              f"{name}: launches per step "
              f"{[p['launches_per_step'] for p in per]}, want "
              f"{[p['want_per_step'] for p in per]}")
    g, f = (rows[n]["losses"] for n in ("train_pp_gpipe_mistral_pp4",
                                        "train_pp_1f1b_mistral_pp4"))
    gpipe_rel = max(abs(a - b) / abs(b) for a, b in zip(f, g))
    check(gpipe_rel <= TRAIN_MESH_LOSS_RTOL,
          f"1F1B losses {f} against GPipe's {g}")
    ov = {r: ranks[r][OVERLAP_JOB["name"]] for r in range(MESH_WORLD)}
    rows[OVERLAP_JOB["name"]] = dict(
        ms_per_rank={r: o["ms"] for r, o in ov.items()},
        rel_l2=max(o["rel_l2"] for o in ov.values()), shape=ov[0]["shape"],
        backend=backend, note=MESH_NOTE[backend])
    say(OVERLAP_JOB["name"], **rows[OVERLAP_JOB["name"]])
    rows["seconds"] = time.perf_counter() - ts
    say("train_pp_seconds", seconds=rows["seconds"], ranks_s=t_ranks,
        compare_s=compare_s[0], gpipe_vs_1f1b_loss_rel=gpipe_rel,
        references_s=sum(r["seconds"] for r in refs.values()))
    return rows


# ----------------------------------------------------------------------
# phase 22: the training guard and per-rank checkpoints.  SmolLM2-135M at
# full depth and width, bf16, remat, B=4 x S=2048 (phase 11's shape),
# AdamW, random init from seed 0.

GUARD_STEPS = 6
GUARD_LR = 1e-3
GUARD_BATCH_SEED = 21
# One bit of rank 1's attention query weights, at step 3: the audit at
# step 4 must name rank 1 and repair it from rank 0.  The leaf is named
# as ``jax.tree_util.keystr`` names it.
GUARD_CORRUPT = {"rank": 1, "step": 3, "name": "['layers']['wq']"}
GUARD_JOB = dict(name="train_guard_replicas_smol", guard=True)
# Job 2: an inf scaled into four lm_head weights at step 3 makes every
# later step non-finite until a blown skip budget (2) rolls back to the
# step-2 snapshot.
GUARD_POISON = {"rank": 0, "step": 3, "name": "['lm_head']",
                "mode": "scale", "scale": float("inf"), "count": 4}
GUARD_ROLLBACK_STEPS = 10
CKPT_DIR = ROOT / "build" / "guard_ckpt"


def guard_cfg():
    from nbdistributed_tpu_torch.models import smol_135m_config
    return smol_135m_config(remat=True, n_layers=MESH_SMOL_LAYERS)


def guard_batches(cfg, n):
    return [packed_batch(cfg, TRAIN_B, cfg.max_seq_len, GUARD_BATCH_SEED + i)
            for i in range(n)]


def guarded_step(cfg, opt):
    """The guarded DDP step (``make_ddp_step(guard=True)``) on a mesh of
    this rank alone."""
    from nbdistributed_tpu_torch.models import loss_fn
    from nbdistributed_tpu_torch.parallel import make_ddp_step, make_mesh
    from nbdistributed_tpu_torch.parallel.collectives import rank

    return make_ddp_step(lambda p, b: loss_fn(p, b, cfg), opt,
                         make_mesh({"dp": 1}, ranks=[rank()]), guard=True)


def state_bytes(params, opt):
    """Every byte of the params and of AdamW's ``mu`` and ``nu`` (uint8
    clones, so equality is bitwise, NaN and inf included) and the step
    counts."""
    import torch
    from nbdistributed_tpu_torch.models import param_leaves

    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8).clone()

    leaves = param_leaves(params)
    st = [opt.state.get(p, {}) for p in leaves]
    return ([raw(p) for p in leaves]
            + [raw(s[k]) for s in st for k in ("mu", "nu") if k in s],
            [s.get("step") for s in st])


def same_state(a, b) -> bool:
    import torch
    return (a[1] == b[1] and len(a[0]) == len(b[0])
            and all(torch.equal(x, y) for x, y in zip(a[0], b[0])))


def guard_run(cfg, batches, corrupt):
    """One guarded run on this rank: the model from seed 0, the guard
    auditing and snapshotting every 2 steps, ``corrupt`` on the process
    fault plan, counts reset just before the steps and read per step."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience import faults
    from nbdistributed_tpu_torch.resilience.trainguard import (
        TrainGuard, leaf_fingerprint, tree_fingerprint)

    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    g = TrainGuard(guarded_step(cfg, opt), params, opt,
                   audit_every=2, snapshot_every=2, skip_budget=10,
                   checkpoint_every=0)
    faults.set_process_plan(None if corrupt is None else
                            faults.FaultPlan(seed=7, corrupt=[corrupt]))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, secs, per_step = [], [], []
    try:
        for b in batches:
            before = launch_counts()
            t0 = time.perf_counter()
            losses.append(float(g.step(b)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            after = launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
        d = g.finish()
    finally:
        faults.set_process_plan(None)
    events = list(g._events)
    mm = [e for e in events if e["kind"] == "mismatch"]
    row = dict(fp=list(tree_fingerprint(params)),
               opt_fp=list(tree_fingerprint(opt)),
               leaf_fps=[leaf_fingerprint(p).tolist()
                         for p in param_leaves(params)],
               audits=[[e["step"], e["verdict"]] for e in events
                       if e["kind"] == "audit"],
               mismatches=d["mismatches"], repairs=d["repairs"],
               skips=d["skips"],
               minority=mm[0]["minority"] if mm else None,
               majority_rank=mm[0]["majority_rank"] if mm else None,
               corrupted=[e.get("leaf") for e in events
                          if e["kind"] == "corrupt"],
               kinds=sorted({e["kind"] for e in events}), losses=losses,
               launches_per_step=per_step,
               ms_per_step=[1e3 * x for x in secs])
    del g, opt, params
    return row


def guard_job(job, counts, send):
    """Job 1 on this rank: the fault-free guarded run, then the same run
    with ``GUARD_CORRUPT`` on the plan."""
    import gc

    import torch
    cfg = guard_cfg()
    batches = guard_batches(cfg, GUARD_STEPS)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, corrupt in (("ref", None), ("faulted", GUARD_CORRUPT)):
        t0 = time.perf_counter()
        out[name] = guard_run(cfg, batches, corrupt)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_guard_replicas(backend="gloo"):
    """Job 1: four ranks, each training SmolLM2 on a mesh of its own
    with the same seed and batches (independent replicas, voting over
    the world).  Held: every fault-free audit ``ok`` on every rank; the
    faulted run's audit at step 4 names minority (1,) and root 0 with
    one repair on every rank; every rank's final params and moments
    bitwise the fault-free run's; K1/K2/K3 2L/L/L a rank a step."""
    ts = time.perf_counter()
    ranks = run_mesh_ranks([GUARD_JOB], backend)
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a guard rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    per = [ranks[r][GUARD_JOB["name"]] for r in range(MESH_WORLD)]
    ref, got = per[0]["ref"], per[0]["faulted"]
    L = guard_cfg().n_layers
    want = {"k1": 2 * L, "k2": L, "k3": L}
    row = dict(
        steps=GUARD_STEPS, batch=TRAIN_B, seq=guard_cfg().max_seq_len,
        corrupt=GUARD_CORRUPT, audits_ref=[p["ref"]["audits"] for p in per],
        audits_faulted=[p["faulted"]["audits"] for p in per],
        minority=[p["faulted"]["minority"] for p in per],
        majority_rank=[p["faulted"]["majority_rank"] for p in per],
        repairs=[p["faulted"]["repairs"] for p in per],
        skips_faulted=[p["faulted"]["skips"] for p in per],
        corrupted=[p["faulted"]["corrupted"] for p in per],
        fp_ref=ref["fp"], fp_faulted=[p["faulted"]["fp"] for p in per],
        losses_ref=ref["losses"], losses_faulted_rank1=per[1]["faulted"][
            "losses"],
        launches_per_step_rank0=ref["launches_per_step"][0],
        want_per_step=want,
        k1_launches_rank0=sum(c["k1"] for c in ref["launches_per_step"]),
        k2_launches_rank0=sum(c["k2"] for c in ref["launches_per_step"]),
        k3_launches_rank0=sum(c["k3"] for c in ref["launches_per_step"]),
        k1_launches_faulted_rank0=sum(
            c["k1"] for c in got["launches_per_step"]),
        k2_launches_faulted_rank0=sum(
            c["k2"] for c in got["launches_per_step"]),
        k3_launches_faulted_rank0=sum(
            c["k3"] for c in got["launches_per_step"]),
        ms_per_step_per_rank=[p["faulted"]["ms_per_step"] for p in per],
        seconds_per_run_rank0=[ref["seconds"], got["seconds"]],
        peak_gb_per_rank=[p["peak_gb"] for p in per],
        backend=backend, note=MESH_NOTE[backend])
    say("train_guard_replicas", **row)
    differ = {r: [i for i, (a, b) in enumerate(zip(p["ref"]["leaf_fps"],
                                                   ref["leaf_fps"]))
                  if a != b] for r, p in enumerate(per)}
    check(all(not v for v in differ.values()),
          f"the fault-free replicas differ (leaf indices by rank): {differ}")
    for r, p in enumerate(per):
        check([v for _, v in p["ref"]["audits"]] == ["ok", "ok"],
              f"rank {r}: fault-free audits {p['ref']['audits']}")
        f = p["faulted"]
        check(f["audits"][1] == [4, "repair:1"] and f["minority"] == [1]
              and f["majority_rank"] == 0 and f["repairs"] == 1
              and f["mismatches"] == 1,
              f"rank {r}: faulted audits {f['audits']}, minority "
              f"{f['minority']}, root {f['majority_rank']}, repairs "
              f"{f['repairs']}")
        check(f["fp"] == ref["fp"] and f["opt_fp"] == ref["opt_fp"],
              f"rank {r}: final params {f['fp']} / moments {f['opt_fp']} "
              f"against the fault-free {ref['fp']} / {ref['opt_fp']}")
        check(all(c == want for run in ("ref", "faulted")
                  for c in p[run]["launches_per_step"]),
              f"rank {r}: launches per step "
              f"{p['ref']['launches_per_step']} / "
              f"{f['launches_per_step']}, want {want}")
    check(per[1]["faulted"]["corrupted"] == [GUARD_CORRUPT["name"]]
          and all(not per[r]["faulted"]["corrupted"] for r in (0, 2, 3)),
          f"the flip fired on {row['corrupted']}")
    row["seconds"] = time.perf_counter() - ts
    return row


def guard_rollback(cfg):
    """Job 2, this process: ``GUARD_POISON`` makes steps 3-5 non-finite;
    each is skipped with the params, ``mu``, ``nu`` and AdamW's step
    bitwise unchanged on the card, the third blows the skip budget and
    rolls back to the step-2 snapshot bitwise, and steps 6-9 train on
    with finite losses."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience import faults
    from nbdistributed_tpu_torch.resilience.trainguard import TrainGuard

    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    inner = guarded_step(cfg, opt)
    calls, kept = [], {}

    def step(p, b):
        i = len(calls)
        before = state_bytes(params, opt)
        if i in (2, 6):
            kept[i] = before
        c0 = launch_counts()
        loss, aux = inner(p, b)
        ok, lossf, gnorm = aux["v"].tolist()
        c1 = launch_counts()
        calls.append(dict(ok=bool(ok), loss=lossf, gnorm=gnorm,
                          unchanged=same_state(before,
                                               state_bytes(params, opt)),
                          launches={k: c1[k] - c0[k] for k in c1}))
        return loss, aux

    g = TrainGuard(step, params, opt, audit_every=1, snapshot_every=2,
                   skip_budget=2, checkpoint_every=0)
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    faults.set_process_plan(faults.FaultPlan(seed=5, corrupt=[GUARD_POISON]))
    reset_launch_counts()
    try:
        for _ in range(GUARD_ROLLBACK_STEPS):
            g.step(batch)
        d = g.finish()
    finally:
        faults.set_process_plan(None)
    launches = launch_counts()
    kinds = [e["kind"] for e in g._events]
    rolled = same_state(kept[2], kept[6])
    row = dict(steps=GUARD_ROLLBACK_STEPS, poison=GUARD_POISON,
               ok=[c["ok"] for c in calls], losses=[c["loss"] for c in calls],
               skipped_unchanged=[c["unchanged"] for c in calls
                                  if not c["ok"]],
               rollback_bitwise_to_step_2=rolled, skips=d["skips"],
               rollbacks=d["rollbacks"], snapshot_steps=d["snapshot_steps"],
               events=kinds, launches=launches,
               launches_per_step=calls[0]["launches"])
    say("train_guard_rollback", **row)
    want = [True] * 3 + [False] * 3 + [True] * (GUARD_ROLLBACK_STEPS - 6)
    check(row["ok"] == want, f"guarded verdicts {row['ok']}, want {want}")
    check(row["skipped_unchanged"] == [True] * 3,
          f"a skipped step changed the state: {row['skipped_unchanged']}")
    check(d["skips"] == 3 and d["rollbacks"] == 1
          and "snapshot_dropped" in kinds and "rollback" in kinds,
          f"skips {d['skips']}, rollbacks {d['rollbacks']}, events {kinds}")
    check(rolled, "the rollback did not restore the step-2 state bitwise")
    check(all(abs(c["loss"]) < float("inf") for c in calls[6:]),
          f"losses after the rollback {row['losses'][6:]}")
    want_k = {"k1": 2 * cfg.n_layers, "k2": cfg.n_layers,
              "k3": cfg.n_layers}
    check(all(c["launches"] == want_k for c in calls),
          f"launches per step {[c['launches'] for c in calls]}")
    del g, params, opt, inner, kept
    return row


def guard_costs(cfg):
    """Report, not held: ``tree_fingerprint`` of the bf16 params beside
    its bound, a snapshot (a guard's construction takes one), the guarded
    step beside the unguarded one."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience.trainguard import (
        TrainGuard, tree_fingerprint)

    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    nbytes = sum(p.numel() * p.element_size() for p in param_leaves(params))

    def wall_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    fp_ms = wall_ms(lambda: tree_fingerprint(params), 5)
    snap_ms = wall_ms(lambda: TrainGuard(
        guarded_step(cfg, opt), params, opt, audit_every=0,
        snapshot_every=1, checkpoint_every=0), 3)
    # The default cadences (50): no snapshot or audit in these steps.
    g = TrainGuard(guarded_step(cfg, opt), params, opt)
    plain = make_train_step(cfg, opt)
    fns = {"unguarded": lambda: float(plain(params, batch)),
           "guarded": lambda: float(g.step(batch))}
    for fn in fns.values():
        fn()
    step_ms = {k: [] for k in fns}
    for name in ("unguarded", "guarded", "guarded", "unguarded"):
        step_ms[name] += wall_ms(fns[name], 3)
    g.finish()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    row = dict(param_bytes=nbytes, fingerprint_ms=fp_ms,
               fingerprint_ms_median=med(fp_ms),
               fingerprint_bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
               snapshot_ms=snap_ms, snapshot_ms_median=med(snap_ms),
               step_order="unguarded, guarded, guarded, unguarded; 3 "
                          "steps each after one of each",
               step_ms=step_ms,
               unguarded_step_ms_median=med(step_ms["unguarded"]),
               guarded_step_ms_median=med(step_ms["guarded"]))
    say("train_guard_costs", **row)
    del g, params, opt, plain
    return row


def flip_npz_byte(path, key):
    """Flip the last data byte of ``key``'s entry in ``path`` in place
    (``np.savez`` stores entries uncompressed): bit rot on disk."""
    import struct
    import zipfile
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(key + ".npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        n, m = struct.unpack("<HH", f.read(4))
        pos = info.header_offset + 30 + n + m + info.compress_size - 1
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def guard_checkpoint(cfg):
    """Job 3, this process: two steps, ``save_async`` of the params and
    the optimizer, step 3 at once (in place, while the save drains) and
    step 4; the save restored into a fresh tree and optimizer equals the
    state after step 2 bitwise, and steps 3-4 from it give the
    uninterrupted run's losses and fingerprints exactly.  A byte flipped
    in ``arrays.npz`` is refused with its leaf named, nothing written.
    Rows: the save's and restore's GB/s, ``save_async``'s synchronous
    ms."""
    import shutil

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience.trainguard import \
        tree_fingerprint
    from nbdistributed_tpu_torch.runtime import checkpoint

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    path, again = str(CKPT_DIR / "async"), str(CKPT_DIR / "sync")
    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    step = make_train_step(cfg, opt)
    batches = guard_batches(cfg, 4)
    reset_launch_counts()
    losses = [float(step(params, b)) for b in batches[:2]]
    state2 = state_bytes(params, opt)
    ns = {"params": params, "opt": opt}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = checkpoint.save_async(path, ns, ["params", "opt"])
    async_ms = 1e3 * (time.perf_counter() - t0)
    losses += [float(step(params, b)) for b in batches[2:]]
    launches = launch_counts()
    fp4 = (tree_fingerprint(params), tree_fingerprint(opt))
    summary = h.wait(600)
    drained_s = time.perf_counter() - t0
    nbytes = sum(v["bytes"] for v in summary.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h2 = checkpoint.save_async(again, ns, ["params", "opt"])
    async2_ms = 1e3 * (time.perf_counter() - t0)
    h2.wait(600)
    t0 = time.perf_counter()
    checkpoint.save(again, ns, ["params", "opt"])
    save_s = time.perf_counter() - t0

    fresh = init_params(cfg, 1)
    fopt = AdamW(param_leaves(fresh), lr=GUARD_LR)
    fns = {"params": fresh, "opt": fopt}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore(path, fns)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    in_place = fns["params"] is fresh and fns["opt"] is fopt
    restored = same_state(state_bytes(fresh, fopt), state2)
    fstep = make_train_step(cfg, fopt)
    resumed = [float(fstep(fresh, b)) for b in batches[2:]]
    fp_resumed = (tree_fingerprint(fresh), tree_fingerprint(fopt))

    fp_before = tree_fingerprint(fresh)
    flip_npz_byte(f"{path}/rank_0/arrays.npz", "params.0")
    try:
        checkpoint.restore(path, fns)
        refused = ""
    except ValueError as e:
        refused = str(e)
    untouched = tree_fingerprint(fresh) == fp_before
    problems = checkpoint.verify_rank(path, 0)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    row = dict(losses=losses, resumed_losses=resumed,
               restored_bitwise=restored, restored_in_place=in_place,
               fingerprints=[list(x) for x in fp4],
               resumed_fingerprints=[list(x) for x in fp_resumed],
               checkpoint_bytes=nbytes, save_async_sync_ms=async_ms,
               save_async_sync_ms_second=async2_ms,
               save_async_drained_s=drained_s,
               save_gb_per_s=nbytes / save_s / 1e9, save_s=save_s,
               restore_gb_per_s=nbytes / restore_s / 1e9,
               restore_s=restore_s, refused=refused[:200],
               refusal_left_state=untouched, verify_rank=problems[:2],
               launches=launches)
    say("train_checkpoint", **row)
    check(in_place and restored, f"restore in place {in_place}, bitwise "
          f"the step-2 state {restored}")
    check(resumed == losses[2:] and fp_resumed == fp4,
          f"resumed losses {resumed} / {fp_resumed} against the "
          f"uninterrupted {losses[2:]} / {fp4}")
    check("params.0" in refused and "integrity" in refused and untouched,
          f"the flipped byte: {refused!r}, state left {untouched}")
    check(any("params.0" in p for p in problems), f"verify_rank: {problems}")
    del params, opt, fresh, fopt, step, fstep, state2
    return row


GUARD_WORKER_CELL = """
import chip_smoke as cs
from nbdistributed_tpu_torch.models import AdamW, init_params, param_leaves
from nbdistributed_tpu_torch.ops import _build
from nbdistributed_tpu_torch.resilience import trainguard
rebuilt = _build.build_all()
cfg = cs.guard_cfg()
params = init_params(cfg, 0, device=device)
opt = AdamW(param_leaves(params), lr=cs.GUARD_LR)
g = trainguard.TrainGuard(cs.guarded_step(cfg, opt), params, opt,
                          audit_every=0, snapshot_every=2)
batch = cs.packed_batch(cfg, 1, 512, 3)
cs.reset_launch_counts()
losses = [float(g.step(batch)) for _ in range(2)]
state = {"launched": cs.launch_counts(), "rebuilt": sorted(rebuilt),
         "losses": losses, "device": str(params["embed"].device),
         "fp": list(trainguard.tree_fingerprint(params)),
         "opt_fp": list(trainguard.tree_fingerprint(opt))}
"""


def phase_guard_worker():
    """Job 4: one GPU worker of the port's process manager, driven over
    its control plane: a guarded SmolLM2 run in a cell (CUDA tensors),
    the ``checkpoint`` request (save, a background save polled to done,
    restores written into the live tensors after a further step), the
    ``guard`` request (status, audit, off and on) and the ``tg`` field
    on its pings."""
    from nbdistributed_tpu_torch.manager import (ProcessManager,
                                                 wait_until_ready)
    from nbdistributed_tpu_torch.messaging.coordinator import \
        CommunicationManager

    ts = time.perf_counter()
    path, bg = str(CKPT_DIR / "worker"), str(CKPT_DIR / "worker_bg")
    comm = CommunicationManager(1, timeout=300)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        pm.start_workers(1, comm.port, backend="gpu")
        wait_until_ready(comm, pm, CLUSTER_READY_S, poll_s=0.5)
        cell(comm, GUARD_WORKER_CELL, timeout=600)
        state = fetch(comm, "state")
        names = {"names": ["params", "opt"]}
        saved = comm.send_to_rank(0, "checkpoint", {
            "action": "save", "path": path, **names}, timeout=300).data
        started = comm.send_to_rank(0, "checkpoint", {
            "action": "save", "path": bg, "background": True, **names},
            timeout=300).data
        polls, t0 = 0, time.perf_counter()
        while True:
            polled = comm.send_to_rank(0, "checkpoint",
                                       {"action": "status"}).data
            polls += 1
            if polled.get("status") != "pending":
                break
            check(time.perf_counter() - t0 < 300, "background save hangs")
            time.sleep(0.05)
        cell(comm, "g.step(batch); moved = list(trainguard.tree_fingerprint("
                   "params)) != state['fp']")
        restored = []
        for where in (path, bg):
            restored.append(comm.send_to_rank(0, "checkpoint", {
                "action": "restore", "path": where}, timeout=300).data)
            cell(comm, "back = [list(trainguard.tree_fingerprint(params)), "
                       "list(trainguard.tree_fingerprint(opt))]")
            restored[-1] = dict(restored[-1], back=fetch(comm, "back"))
        moved = fetch(comm, "moved")
        status = comm.send_to_rank(0, "guard", {"action": "status"}).data
        audit = comm.send_to_rank(0, "guard", {"action": "audit"}).data
        off = comm.send_to_rank(0, "guard", {"action": "off"}).data
        on = comm.send_to_rank(0, "guard", {"action": "on"}).data
        # A ping sent after the audit: its tg names the audit's step.
        t0 = time.perf_counter()
        while True:
            ping = comm.last_ping(0)
            if ping is not None and (ping[1] or {}).get("tg", {}).get(
                    "as") == status.get("step"):
                break
            check(time.perf_counter() - t0 < 60,
                  f"no ping carried the audit's tg: {ping}")
            time.sleep(0.1)
        comm.post([0], "shutdown")
    finally:
        pm.shutdown()
        comm.shutdown()
    L = guard_cfg().n_layers
    want = {"k1": 4 * L, "k2": 2 * L, "k3": 2 * L}
    row = dict(launched=state["launched"], want=want,
               rebuilt=state["rebuilt"], device=state["device"],
               losses=state["losses"], saved=saved.get("status"),
               saved_bytes={k: v["bytes"] for k, v in
                            saved.get("summary", {}).items()},
               background=started.get("status"),
               polled=polled.get("status"), polls=polls,
               restored=[r.get("status") for r in restored],
               restored_equal=[r["back"] == [state["fp"], state["opt_fp"]]
                               for r in restored], moved_after_step=moved,
               guard_status={k: status.get(k) for k in
                             ("enabled", "active", "step", "skips",
                              "snapshot_steps")},
               audit={k: audit.get(k) for k in ("status", "ok",
                                                "last_verdict")},
               off=off.get("enabled"), on=on.get("enabled"),
               tg=ping[1]["tg"], seconds=time.perf_counter() - ts)
    say("guard_worker", **row)
    check(state["rebuilt"] == [] and state["device"] == "cuda:0",
          f"worker: rebuilt {state['rebuilt']}, device {state['device']}")
    check(state["launched"] == want, f"worker launches {state['launched']}"
          f", want {want}")
    check(saved.get("status") == "save" and started.get("status")
          == "started" and polled.get("status") == "done",
          f"checkpoint requests: {saved}, {started}, {polled}")
    check(moved and all(r.get("status") == "restore" for r in restored)
          and all(row["restored_equal"]),
          f"restores: moved {moved}, {row['restored']}, "
          f"{row['restored_equal']}")
    check(status.get("active") and status.get("step") == 3
          and audit.get("status") == "audited" and audit.get("ok")
          and off.get("enabled") is False and on.get("enabled") is True,
          f"guard requests: {status}, {audit}, {off}, {on}")
    check(row["tg"].get("v") == "ok" and row["tg"].get("sk") == 0,
          f"ping tg {row['tg']}")
    return row


def phase_guard(backend="gloo"):
    """Phase 22: job 1 on four ranks, then (one card) jobs 2-4 and the
    costs in this process."""
    import torch

    ts = time.perf_counter()
    torch.cuda.empty_cache()
    rows = {"train_guard_replicas": phase_guard_replicas(backend)}
    if backend == "gloo":
        cfg = guard_cfg()
        torch.cuda.reset_peak_memory_stats()
        rows["train_guard_rollback"] = guard_rollback(cfg)
        torch.cuda.empty_cache()
        rows["train_guard_costs"] = guard_costs(cfg)
        torch.cuda.empty_cache()
        rows["train_checkpoint"] = guard_checkpoint(cfg)
        rows["peak_gb_in_process"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        rows["guard_worker"] = phase_guard_worker()
    rows["seconds"] = time.perf_counter() - ts
    say("guard_seconds", seconds=rows["seconds"],
        replicas_s=rows["train_guard_replicas"]["seconds"])
    return rows


# ----------------------------------------------------------------------
# phase 23: the notebook surface.  The magics' bodies are plain methods
# of ``magics.magic.DistributedMagics`` (the card's machine has no
# IPython to bind them to a shell): this phase calls them as a
# notebook's cells would, with each cell's line and text, against a
# stand-in shell that holds the kernel namespace and the input
# transformers.  Phase 17's 12 requests are served in a plain cell
# (distributed automatically) and phase 11's first step is trained in
# the next, with the counts reset in the cell and read through
# %dist_pull.

NOTEBOOK_RT_CELLS = 20
NOTEBOOK_CKPT = ROOT / "build" / "notebook_ckpt"

NOTEBOOK_SERVE_CELL = """\
import chip_smoke as cs
from nbdistributed_tpu_torch.models import init_params, smol_135m_config
from nbdistributed_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
rebuilt = sorted(_build.build_all())
cfg = smol_135m_config()
params = init_params(cfg, 0, device=device)
prompts = cs.make_requests(cfg)
cs.reset_launch_counts()
outputs, steps, wall, _, _ = cs.serve(params, cfg, prompts)
from nbdistributed_tpu_torch.ops import decode as _decode
served = {**cs.launch_counts(), "k4": _decode.flash_decode_attention.launches,
          "steps": steps, "wall_s": wall, "rebuilt": rebuilt,
          "device": str(params["embed"].device)}
"""

NOTEBOOK_TRAIN_CELL = """\
from nbdistributed_tpu_torch.models import (AdamW, make_train_step,
                                            param_leaves)
del params, outputs
torch.cuda.empty_cache()
tcfg = smol_135m_config(remat=True)
params = init_params(tcfg, 0, device=device)
batch = cs.packed_batch(tcfg, cs.TRAIN_B, tcfg.max_seq_len,
                        cs.TRAIN_BATCH_SEED)
step = make_train_step(tcfg, AdamW(param_leaves(params), lr=1e-3))
cs.reset_launch_counts()
loss = float(step(params, batch))
trained = {**cs.launch_counts(), "loss": loss}
"""

NOTEBOOK_STEP_CELL = """\
import time
torch.cuda.synchronize()
_t0 = time.perf_counter()
loss2 = float(step(params, batch))
step_ms = 1e3 * (time.perf_counter() - _t0)
"""

NOTEBOOK_SNAPSHOT_CELL = """\
from nbdistributed_tpu_torch.resilience.trainguard import tree_fingerprint
def _bits(t):
    return t.detach().contiguous().view(torch.uint8)
ck_ref = [_bits(t).clone() for t in param_leaves(params)]
ck_fp = list(tree_fingerprint(params))
"""

NOTEBOOK_ZERO_CELL = """\
with torch.no_grad():
    for _t in param_leaves(params):
        _t.zero_()
ck_zeroed = all(not bool(_t.any()) for _t in param_leaves(params))
"""

NOTEBOOK_CHECK_CELL = """\
ck_back = (all(torch.equal(_bits(t), r) for t, r in
               zip(param_leaves(params), ck_ref))
           and list(tree_fingerprint(params)) == ck_fp)
"""


class NotebookShell:
    """What the magics use of an IPython shell: the kernel namespace and
    the input transformers (``%dist_init`` adds the auto-distributing
    one)."""

    def __init__(self):
        self.user_ns = {}
        self.input_transformers_cleanup = []


class NotebookSession:
    """Runs cells as IPython would: ``%%name line`` and ``%name line``
    call the magic's method, a plain cell goes through the input
    transformers first, and a cell the transformers leave alone runs in
    the kernel namespace.  Each cell's printed text is kept; unless
    ``ok=False``, a cell that reports an error fails the run."""

    def __init__(self):
        from nbdistributed_tpu_torch.magics.magic import DistributedMagics
        self.shell = NotebookShell()
        DistributedMagics.reset_class_state()      # %load_ext's steps
        self.magics = DistributedMagics(self.shell)
        self.log = []

    def run(self, text, ok=True):
        import contextlib
        import io
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            lines = text.splitlines(keepends=True)
            for transform in self.shell.input_transformers_cleanup:
                lines = transform(lines)
            first, rest = lines[0].rstrip("\n"), "".join(lines[1:])
            if first.startswith("%%"):
                name, _, line = first[2:].partition(" ")
                getattr(self.magics, name)(line, rest)
            elif first.startswith("%") and not rest.strip():
                name, _, line = first[1:].partition(" ")
                getattr(self.magics, name)(line)
            else:
                exec(compile("".join(lines), "<cell>", "exec"),
                     self.shell.user_ns)
        out = buf.getvalue()
        self.log.append({"cell": text, "out": out,
                         "s": time.perf_counter() - t0})
        check(not ok or ("❌" not in out and "💀" not in out),
              f"cell {text.splitlines()[0]!r} failed:\n{out}")
        return out

    def pull(self, name):
        self.run(f"%dist_pull {name} --all --as _pulled")
        return self.shell.user_ns.pop("_pulled")


def notebook_refs():
    """Phase 23's references computed in this process on card 0, where
    phases 5 and 11 have not run (``--mesh-nccl``): the bf16 server's
    streams of phase 17's requests and phase 11's first-step loss."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config()
    outputs = serve(init_params(cfg, 0), cfg, make_requests(cfg))[0]
    tcfg = smol_135m_config(remat=True)
    params = init_params(tcfg, 0)
    batch = packed_batch(tcfg, TRAIN_B, tcfg.max_seq_len, TRAIN_BATCH_SEED)
    step = make_train_step(tcfg, AdamW(param_leaves(params), lr=1e-3))
    loss = float(step(params, batch))
    del params, batch, step
    torch.cuda.empty_cache()
    return outputs, loss


def phase_notebook(outputs_ref, loss_ref, n=1):
    """Phase 23: the notebook surface on the card, ``n`` NCCL ranks (one
    a card).  ``outputs_ref``: the in-process bf16 server's streams of
    phase 17's requests; ``loss_ref``: phase 11's first-step loss."""
    import shutil
    import statistics

    import torch
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    ts = time.perf_counter()
    shutil.rmtree(NOTEBOOK_CKPT, ignore_errors=True)
    nb = NotebookSession()
    ranks = list(range(n))
    try:
        t0 = time.perf_counter()
        out = nb.run(f"%dist_init -n {n} --backend gpu -t 600")
        ready_s = time.perf_counter() - t0
        check(f"{n} workers ready (backend=gpu" in out, f"%dist_init: {out}")
        pids = [p.pid for p in DistributedMagics._pm.processes.values()]

        out = nb.run("%dist_status")
        for r in ranks:
            want = (f"● running · cuda:{r} "
                    f"({torch.cuda.get_device_name(r)}) · ",
                    f" · {n} ranks on nccl · ")
            line = next((x for x in out.splitlines()
                         if x.startswith(f"├─ Rank {r}: pid")), "")
            check(all(w in line for w in want),
                  f"%dist_status rank {r}: want {want} in {out}")

        lines = nb.magics._auto_transformer(
            NOTEBOOK_SERVE_CELL.splitlines(keepends=True))
        check(lines[0] == "%%distributed\n", "a plain cell was not "
              "distributed automatically")
        t0 = time.perf_counter()
        nb.run(NOTEBOOK_SERVE_CELL)
        serve_cell_s = time.perf_counter() - t0
        served, outputs = nb.pull("served"), nb.pull("outputs")
        n_tok = sum(len(o) for o in outputs_ref)
        for r in ranks:
            s = served[r]
            check(s["rebuilt"] == [] and s["device"] == f"cuda:{r}",
                  f"rank {r}: rebuilt {s['rebuilt']}, on {s['device']}")
            check(s["steps"] > 0 and s["k4"] == N_LAYERS_SMOL * s["steps"],
                  f"rank {r}: K4 launched {s['k4']} times over "
                  f"{s['steps']} decode steps")
            check(outputs[r] == outputs_ref, f"rank {r}: the tokens "
                  "pulled through %dist_pull differ from the in-process "
                  "server's")
        serve_row = dict(k4_launches=served[0]["k4"],
                         k1_launches=served[0]["k1"],
                         decode_steps=served[0]["steps"],
                         want_k4=N_LAYERS_SMOL * served[0]["steps"],
                         tokens=n_tok, worker_wall_s=served[0]["wall_s"],
                         tokens_per_s=n_tok / served[0]["wall_s"],
                         cell_s=serve_cell_s, tokens_equal=True)
        say("notebook_serve", **serve_row)

        nb.run(NOTEBOOK_TRAIN_CELL)
        trained = nb.pull("trained")
        want = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
                "k3": N_LAYERS_SMOL}
        for r in ranks:
            got = {k: trained[r][k] for k in want}
            check(got == want, f"rank {r}: train step launched {got}, "
                  f"want {want}")
        check(trained[0]["loss"] == loss_ref, f"rank 0's loss "
              f"{trained[0]['loss']!r} != the in-process step's "
              f"{loss_ref!r}")
        t0 = time.perf_counter()
        nb.run("%%distributed\n" + NOTEBOOK_STEP_CELL)
        step_cell_ms = 1e3 * (time.perf_counter() - t0)
        step_ms = nb.pull("step_ms")
        train_row = dict(launches={k: trained[0][k] for k in want},
                         loss=trained[0]["loss"],
                         loss_in_process=loss_ref, loss_equal=True,
                         losses_by_rank=[trained[r]["loss"] for r in ranks],
                         step2_ms_in_worker=step_ms[0],
                         step2_cell_ms=step_cell_ms)
        say("notebook_train", **train_row)

        nb.run(NOTEBOOK_SNAPSHOT_CELL)
        path = str(NOTEBOOK_CKPT / "sync")
        t0 = time.perf_counter()
        out = nb.run(f"%dist_checkpoint {path} params")
        save_s = time.perf_counter() - t0
        check(f"✅ {n} ranks saved → {path}: params" in out,
              f"%dist_checkpoint: {out}")
        nb.run(NOTEBOOK_ZERO_CELL)
        zeroed = nb.pull("ck_zeroed")
        t0 = time.perf_counter()
        out = nb.run(f"%dist_restore {path}")
        restore_s = time.perf_counter() - t0
        check(f"✅ {n} ranks restored ← {path}: params" in out,
              f"%dist_restore: {out}")
        nb.run(NOTEBOOK_CHECK_CELL)
        back = nb.pull("ck_back")
        check(all(zeroed.values()) and all(back.values()),
              f"checkpoint round trip: zeroed {zeroed}, back {back}")
        bg = str(NOTEBOOK_CKPT / "background")
        out = nb.run(f"%dist_checkpoint {bg} params --background")
        check("background save started" in out, f"--background: {out}")
        polls, done, t0 = 0, {r: 0 for r in ranks}, time.perf_counter()
        while DistributedMagics._last_ckpt_path != bg:
            check(time.perf_counter() - t0 < 300, "background save hangs")
            out = nb.run("%dist_checkpoint --status")
            polls += 1
            for r in ranks:
                done[r] += out.count(f"Rank {r}: done")
            time.sleep(0.05)
        check(all(c == 1 for c in done.values()), f"done replies {done}")
        nb.run(f"%dist_restore {bg}")
        nb.run(NOTEBOOK_CHECK_CELL)
        check(all(nb.pull("ck_back").values()), "background checkpoint "
              "round trip")
        ckpt_row = dict(save_s=save_s, restore_s=restore_s,
                        background_polls=polls, bitwise=True)
        say("notebook_checkpoint", **ckpt_row)

        out = nb.run("%%rank [0]\nf'only rank {rank} on {device}'")
        check("only rank 0 on cuda:0" in out and "Rank 1" not in out,
              f"%%rank [0]: {out}")
        out = nb.run("%sync")
        check(f"✅ All {n} workers synchronized" in out, f"%sync: {out}")
        nb.run("%dist_mode -d")
        out = nb.run("local_cell = 'kernel'\nprint('ran locally')")
        check(out == "ran locally\n"
              and nb.shell.user_ns["local_cell"] == "kernel",
              f"local cell: {out}")
        nb.run("%dist_mode -e")
        out = nb.run("raise ValueError(f'boom on rank {rank}')", ok=False)
        for r in ranks:
            check(f"❌ Rank {r}: boom on rank {r}" in out,
                  f"error cell: {out}")

        rt = []
        for _ in range(NOTEBOOK_RT_CELLS):
            t0 = time.perf_counter()
            nb.run("%%distributed\n1")
            rt.append(time.perf_counter() - t0)

        out = nb.run("%dist_shutdown")
        check(f"✅ shut down {n} workers" in out, f"%dist_shutdown: {out}")
        left = [p for p in pids if pathlib.Path(f"/proc/{p}").exists()]
        check(not left, f"workers left after %dist_shutdown: {left}")
    finally:
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"notebook_cells_n{n}.json").write_text(
            json.dumps(nb.log, indent=1))
    row = dict(ranks=n, spawn_to_ready_s=ready_s,
               cell_ms_median=1e3 * statistics.median(rt),
               cell_ms=[1e3 * x for x in rt], serve=serve_row,
               train=train_row, checkpoint=ckpt_row,
               seconds=time.perf_counter() - ts)
    say("notebook", **{k: v for k, v in row.items()
                       if k not in ("serve", "train", "checkpoint")})
    return row


# Phase 24: cell vetting and the async window, through the same
# magics' bodies and stand-in shell as phase 23.  A fresh session
# serves phase 17's requests under %dist_lint warn, refuses a
# rank-conditional collective under strict before anything is sent,
# trains phase 11's step as synchronous cells and then as --async
# cells with proven-free cells streamed beside them, and drives the
# observability magics (profile, trace, metrics, latency, top, chaos).

NOTEBOOK_ASYNC_STEPS = 4
NOTEBOOK_CHAOS_CELLS = 6
NOTEBOOK_PROFILE_DIR = ROOT / "build" / "notebook_profile"
NOTEBOOK_TRACE = ROOT / "build" / "notebook_trace.json"
# Kernel-name fragments of each kernel's launches in a torch.profiler
# trace (the bf16 tensor-core and the fp32 scalar variants alike).
PROFILE_KERNELS = {"k1": "flash_fwd_", "k2": "flash_bwd_dq_",
                   "k3": "flash_bwd_dkv_", "k4": "decode_split_kernel"}

NOTEBOOK_ASYNC_SETUP_CELL = """\
import time
from nbdistributed_tpu_torch.models import (AdamW, make_train_step,
                                            param_leaves)
del params, outputs
torch.cuda.empty_cache()
tcfg = smol_135m_config(remat=True)
batch = cs.packed_batch(tcfg, cs.TRAIN_B, tcfg.max_seq_len,
                        cs.TRAIN_BATCH_SEED)
def fresh_step():
    p = init_params(tcfg, 0, device=device)
    return p, make_train_step(tcfg, AdamW(param_leaves(p), lr=1e-3))
params, step = fresh_step()
float(step(params, batch))    # warm-up: both timed runs start warm
params, step = fresh_step()
cs.reset_launch_counts()
"""

NOTEBOOK_TIMED_STEP_CELL = """\
torch.cuda.synchronize()
_t0 = time.perf_counter()
loss_{tag} = float(step(params, batch))
ms_{tag} = 1e3 * (time.perf_counter() - _t0)
"""


def _registry_count(prefix, *parts):
    """Sum of this process's metrics-registry counters whose key starts
    with ``prefix`` and holds every one of ``parts``."""
    from nbdistributed_tpu_torch.observability import metrics
    return sum(v for k, v in metrics.registry().to_json()["counters"]
               .items() if k.startswith(prefix)
               and all(x in k for x in parts))


def _worker_cells(comm):
    """Cells each rank has executed, from its ``nbd_cell_seconds``."""
    out = {}
    for r, m in comm.send_to_all("metrics", {"format": "json"},
                                 timeout=60).items():
        hists = m.data["metrics"].get("histograms", {})
        out[r] = sum(v.get("count", 0) for k, v in hists.items()
                     if k.startswith("nbd_cell_seconds"))
    return out


def profile_kernel_counts(path):
    """Kernel events of each flash kernel in a torch.profiler Chrome
    trace."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    names = [e.get("name", "") for e in events
             if e.get("cat") == "kernel"]
    return {k: sum(frag in n for n in names)
            for k, frag in PROFILE_KERNELS.items()}, len(names)


def phase_notebook_async(outputs_ref, loss_ref, n=1):
    """Phase 24: cell vetting, the async window and the observability
    magics on the card, ``n`` NCCL ranks (one a card).
    ``outputs_ref``: the in-process bf16 server's streams of phase 17's
    requests; ``loss_ref``: phase 11's first-step loss."""
    import os
    import re
    import shutil
    import statistics

    from nbdistributed_tpu_torch.analysis import preflight
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    ts = time.perf_counter()
    shutil.rmtree(NOTEBOOK_PROFILE_DIR, ignore_errors=True)
    ranks = list(range(n))
    # Redelivery on: a frame the chaos plan drops is resent, not waited
    # out (read when %dist_init builds the coordinator).
    saved_env = {k: os.environ.get(k) for k in ("NBD_RETRY_TIMEOUT_S",
                                                "NBD_ASYNC_WINDOW")}
    os.environ["NBD_RETRY_TIMEOUT_S"] = "2"
    nb = NotebookSession()
    rows = {}
    try:
        t0 = time.perf_counter()
        out = nb.run(f"%dist_init -n {n} --backend gpu -t 600")
        check(f"{n} workers ready (backend=gpu" in out, f"%dist_init: {out}")
        rows["spawn_to_ready_s"] = time.perf_counter() - t0
        pids = [p.pid for p in DistributedMagics._pm.processes.values()]
        comm = DistributedMagics._comm

        # 1. Serving under %dist_lint warn.
        out = nb.run("%dist_lint warn")
        check("cell vetting ON (annotate only)" in out, out)
        nb.run(NOTEBOOK_SERVE_CELL)
        served, outputs = nb.pull("served"), nb.pull("outputs")
        for r in ranks:
            s = served[r]
            check(s["rebuilt"] == [] and s["device"] == f"cuda:{r}",
                  f"rank {r}: rebuilt {s['rebuilt']}, on {s['device']}")
            check(s["steps"] > 0 and s["k4"] == N_LAYERS_SMOL * s["steps"],
                  f"rank {r}: K4 launched {s['k4']} times over "
                  f"{s['steps']} decode steps")
            check(outputs[r] == outputs_ref, f"rank {r}: the streams "
                  "pulled under %dist_lint warn differ from the "
                  "in-process server's")
        rows["serve"] = dict(k4_launches=served[0]["k4"],
                             decode_steps=served[0]["steps"],
                             tokens_equal=True)

        # 2. Strict vetting: refused before dispatch, group not hung.
        nb.run("nb_t = torch.ones(4, device=device)")
        nb.run("%dist_lint strict")
        sent0 = _registry_count("nbd_wire_messages_total", 'dir="tx"',
                                'type="execute"')
        cells0 = _worker_cells(comm)
        found0 = _registry_count("nbd_lint_findings_total",
                                 "rank-conditional-collective")
        out = nb.run("strict_marker = 1\nif rank == 0:\n"
                     "    dist.all_reduce(nb_t)")
        check("[rank-conditional-collective]" in out
              and "⛔ cell NOT dispatched" in out, f"strict: {out}")
        sent1 = _registry_count("nbd_wire_messages_total", 'dir="tx"',
                                'type="execute"')
        check(sent1 == sent0 and _worker_cells(comm) == cells0,
              f"strict sent {sent1 - sent0} execute frames")
        nb.run("%dist_lint warn")
        out = nb.run("%%distributed --strict\n"
                     "dist.all_reduce(nb_t)\nnb_sum = float(nb_t.sum())")
        check("NOT dispatched" not in out, f"--strict clean cell: {out}")
        sums = nb.pull("nb_sum")
        check(all(v == 4.0 * n for v in sums.values()),
              f"all_reduce after the refusal: {sums}")
        out = nb.run("%dist_lint status")
        found1 = _registry_count("nbd_lint_findings_total",
                                 "rank-conditional-collective")
        check(found1 == found0 + 1
              and f"· rank-conditional-collective: {found1:.0f}" in out,
              f"%dist_lint status: {out}")
        out = nb.run("%%distributed\n'strict_marker' in dir()")
        check(out.count("False") == n, f"the refused cell ran: {out}")
        rows["strict"] = dict(execute_frames_sent=sent1 - sent0,
                              worker_cells=cells0,
                              findings_counted=found1 - found0)

        # 3. The window: phase 11's step, synchronous then --async.
        nb.run(NOTEBOOK_ASYNC_SETUP_CELL)
        t0 = time.perf_counter()
        for k in range(NOTEBOOK_ASYNC_STEPS):
            nb.run("%%distributed\n" + NOTEBOOK_TIMED_STEP_CELL.format(
                tag=f"s{k}"))
        sync_wall = time.perf_counter() - t0
        nb.run("sync_counts = cs.launch_counts()\n"
               "params, step = fresh_step()\ncs.reset_launch_counts()")
        depth_held, holds = 0, []
        t0 = time.perf_counter()
        for k in range(NOTEBOOK_ASYNC_STEPS):
            out = nb.run(f"%%distributed --async\n"
                         f"loss_a{k} = float(step(params, batch))")
            holds.append("⧗ held:" in out)
            nb.run(f"%%distributed --async\nnb_free_{k} = "
                   f"torch.full((1024,), {k}.0, device=device)")
            snap = DistributedMagics._async_exec.snapshot()
            if snap["collective_holder"] is not None:
                depth_held = max(depth_held, snap["depth"])
        out = nb.run("%dist_wait")
        async_wall = time.perf_counter() - t0
        check("✅ drained" in out and "errored" not in out,
              f"%dist_wait: {out}")
        check(depth_held >= 2, "the window never held a free cell beside "
              f"a training cell (depth {depth_held})")
        deps = nb.run("%dist_lint deps")
        dag = preflight.deps_dag()
        mine = {e["seq"] for e in dag["nodes"]
                if any(w.startswith(("loss_a", "nb_free_"))
                       for w in e["writes"])}
        check(len(mine) == 2 * NOTEBOOK_ASYNC_STEPS, f"DAG nodes {mine}")
        edges = [e for e in dag["edges"] if {e["src"], e["dst"]} <= mine]
        check(not edges, f"%dist_lint deps drew {edges}:\n{deps}")
        steps = range(NOTEBOOK_ASYNC_STEPS)
        nb.run("losses_sync = [" + ", ".join(f"loss_s{k}" for k in steps)
               + "]\nlosses_async = ["
               + ", ".join(f"loss_a{k}" for k in steps)
               + "]\nasync_counts = cs.launch_counts()")
        l_sync, l_async = nb.pull("losses_sync"), nb.pull("losses_async")
        counts_s, counts_a = nb.pull("sync_counts"), nb.pull("async_counts")
        want = {"k1": 2 * N_LAYERS_SMOL * NOTEBOOK_ASYNC_STEPS,
                "k2": N_LAYERS_SMOL * NOTEBOOK_ASYNC_STEPS,
                "k3": N_LAYERS_SMOL * NOTEBOOK_ASYNC_STEPS}
        for r in ranks:
            check(l_async[r] == l_sync[r], f"rank {r}: async losses "
                  f"{l_async[r]} != synchronous {l_sync[r]}")
            for c in (counts_s[r], counts_a[r]):
                got = {k: c[k] for k in want}
                check(got == want, f"rank {r}: {got}, want {want}")
        check(l_sync[0][0] == loss_ref, f"first loss {l_sync[0][0]!r} != "
              f"phase 11's {loss_ref!r}")
        step_ms = nb.pull(f"ms_s{NOTEBOOK_ASYNC_STEPS - 1}")[0]
        rows["train"] = dict(
            losses=l_sync[0], losses_equal_bitwise=True,
            launches_async={k: counts_a[0][k] for k in want},
            launches_sync={k: counts_s[0][k] for k in want},
            sync_wall_ms=1e3 * sync_wall, async_wall_ms=1e3 * async_wall,
            max_depth_with_collective_holder=depth_held,
            training_cells_held=sum(holds))

        # An --async cell that raises surfaces at the drain, once.
        out = nb.run("%%distributed --async\ntime.sleep(0.5)\n"
                     "raise ValueError('async boom')")
        check("streamed to ranks" in out, f"--async error cell: {out}")
        out = nb.run("%dist_wait")
        check(out.count("✗ async cell") == 1 and "1 errored" in out
              and out.count("async boom") == n, f"%dist_wait: {out}")
        out = nb.run("%%distributed\nafter_error = 1")
        check("errored un-inspected" not in out, out)
        # NBD_ASYNC_WINDOW arms the window; a --sync cell drains it.
        os.environ["NBD_ASYNC_WINDOW"] = "4"
        out = nb.run("time.sleep(0.5)\nwin_a = 1")
        check("⧗ async cell" in out, f"NBD_ASYNC_WINDOW cell: {out}")
        out = nb.run("%%distributed --sync\nwin_b = 2")
        check(out.startswith("⧗ draining async window (1 in flight) — "
                             "synchronous cell"), f"--sync: {out}")
        del os.environ["NBD_ASYNC_WINDOW"]

        # 4. %dist_profile around one training cell.
        nb.run("cs.reset_launch_counts()")
        out = nb.run(f"%dist_profile start --log-dir "
                     f"{NOTEBOOK_PROFILE_DIR}")
        check("profiling started" in out, out)
        nb.run("%%distributed\n" + NOTEBOOK_TIMED_STEP_CELL.format(
            tag="prof") + "prof_counts = cs.launch_counts()")
        out = nb.run(f"%dist_profile stop --log-dir {NOTEBOOK_PROFILE_DIR}")
        check("profiling stopped" in out, out)
        prof_counts = nb.pull("prof_counts")
        prof_ms = nb.pull("ms_prof")[0]
        traced = {}
        for r in ranks:
            got, n_kernels = profile_kernel_counts(
                NOTEBOOK_PROFILE_DIR / f"rank{r}" / "trace.json")
            want_p = {k: prof_counts[r][k] for k in ("k1", "k2", "k3")}
            check({k: got[k] for k in want_p} == want_p and got["k4"] == 0,
                  f"rank {r}: trace kernels {got}, counters {want_p}")
            traced[r] = dict(got, kernel_events=n_kernels)
        rows["profile"] = dict(trace_kernels=traced[0],
                               launch_counters=prof_counts[0],
                               step_ms_profiled=prof_ms,
                               step_ms_unprofiled=step_ms,
                               overhead=prof_ms / step_ms)

        # 5. %dist_trace: one merged Chrome trace, every process in it.
        out = nb.run("%dist_trace start")
        check("tracing ON" in out, out)
        nb.run("%%distributed\ntraced = rank")
        out = nb.run(f"%dist_trace save {NOTEBOOK_TRACE}")
        check("load in ui.perfetto.dev" in out, out)
        nb.run("%dist_trace stop")
        merged = json.loads(NOTEBOOK_TRACE.read_text())["traceEvents"]
        procs = {e["pid"] for e in merged if e.get("ph") == "X"}
        check(procs == {-1, *ranks}, f"trace spans from {procs}")
        rows["trace"] = dict(events=len(merged), processes=sorted(procs))

        # 6. %dist_metrics, %dist_lat, %dist_top.
        out = nb.run("%dist_metrics")
        check("📊 coordinator: wire tx/rx" in out
              and all(f"🔹 rank {r}: cells" in out for r in ranks), out)
        out = nb.run("%dist_lat --last 1")
        check("latency observatory" in out and "execute" in out, out)
        out = nb.run("%dist_top")
        mem_rows = [ln for ln in out.splitlines()
                    if re.match(r"^\d+\s+● alive", ln)]
        check(len(mem_rows) == n and all(
            re.search(r"\d+\.\d\d/\d+\.\d\d", ln) for ln in mem_rows),
              f"%dist_top shows no card memory: {out}")
        rows["top"] = mem_rows

        # 7. %dist_chaos: 10 % of frames dropped, every cell once.
        nb.run("chaos_n = 0")
        out = nb.run("%dist_chaos on --drop 0.1 --seed 7")
        check("chaos ON (both)" in out and "no retry policy" not in out,
              out)
        t0 = time.perf_counter()
        for _ in range(NOTEBOOK_CHAOS_CELLS):
            out = nb.run("chaos_n += 1\nchaos_n")
            check("⏱️" not in out, f"chaos cell timed out: {out}")
        chaos_s = time.perf_counter() - t0
        status = nb.run("%dist_chaos status")
        nb.run("%dist_chaos off")
        got = nb.pull("chaos_n")
        check(all(v == NOTEBOOK_CHAOS_CELLS for v in got.values()),
              f"chaos cells ran {got} times")
        rows["chaos"] = dict(cells=NOTEBOOK_CHAOS_CELLS, seconds=chaos_s,
                             retries_sent=comm.retries_sent,
                             status=status.splitlines())

        # 8. 20 trivial cells synchronous, then through the window.
        rt = []
        for k in range(NOTEBOOK_RT_CELLS):
            t0 = time.perf_counter()
            nb.run(f"%%distributed\nnb_s{k} = {k}")
            rt.append(1e3 * (time.perf_counter() - t0))
        blocked = []
        t_all = time.perf_counter()
        for k in range(NOTEBOOK_RT_CELLS):
            t0 = time.perf_counter()
            nb.run(f"%%distributed --async\nnb_a{k} = {k}")
            blocked.append(1e3 * (time.perf_counter() - t0))
        nb.run("%dist_wait")
        async_total = 1e3 * (time.perf_counter() - t_all)
        got = nb.pull(f"nb_a{NOTEBOOK_RT_CELLS - 1}")
        check(all(v == NOTEBOOK_RT_CELLS - 1 for v in got.values()), got)
        rows["trivial"] = dict(
            sync_ms_median=statistics.median(rt), sync_ms_total=sum(rt),
            async_blocked_ms_median=statistics.median(blocked),
            async_blocked_ms_max=max(blocked),
            async_ms_total_with_wait=async_total)

        out = nb.run("%dist_shutdown")
        check(f"✅ shut down {n} workers" in out, f"%dist_shutdown: {out}")
        left = [p for p in pids if pathlib.Path(f"/proc/{p}").exists()]
        check(not left, f"workers left after %dist_shutdown: {left}")
    finally:
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"notebook_async_cells_n{n}.json").write_text(
            json.dumps(nb.log, indent=1))
    rows.update(ranks=n, seconds=time.perf_counter() - ts)
    say("notebook_async", **{k: v for k, v in rows.items()
                             if k not in ("top",)})
    return rows


# ----------------------------------------------------------------------
# Phase 25: supervision and diagnosis, through the same magics' bodies
# and stand-in shell.  Short watchdog thresholds (the ladder ends far
# inside the process group's 120 s NCCL timeout) and the scrape
# endpoint on a free port, set before %dist_init.  One card: the
# endpoint scraped during a training cell; a Python loop launching K1
# caught as a stall, dumped and interrupted (the worker survives); a
# --deadline verdict on a --repeat training cell; a rank killed during
# step 3 under %dist_supervise, its postmortem bundle, the auto-heal
# (respawn + restore) and steps 3-4 bitwise equal to an uninterrupted
# run's, phase 17's requests on the healed world; %dist_guard.  Four
# cards (--mesh-nccl): a rank-conditional dist.all_reduce named and
# healed.

SUP_ENV = {"NBD_HANG_POLL_S": "0.25", "NBD_HANG_SKEW_S": "3",
           "NBD_HANG_STALL_S": "5", "NBD_HANG_GRACE_S": "2"}
SUP_CKPT = ROOT / "build" / "supervision_ckpt"
SUP_SCRAPE_STEPS = 8
# The scrape cell's last step waits for this file, which the operator
# writes once its scrapes have answered: every scrape lands inside the
# cell however fast the steps run.
SUP_SCRAPE_DONE = ROOT / "build" / "supervision_scrapes_done"
SUP_SCRAPE_CELL = """\
scrape_losses.append(float(step(params, batch)))
if len(scrape_losses) == cs.SUP_SCRAPE_STEPS:
    cs.wait_for_scrapes()
"""
SUP_DEADLINE_STEPS = 20
SUP_TIMED_STEPS = 3

SUP_SETUP_CELL = """\
import time
import chip_smoke as cs
from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                            make_train_step, param_leaves,
                                            smol_135m_config)
from nbdistributed_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
rebuilt = sorted(_build.build_all())
tcfg = smol_135m_config(remat=True)
batch = cs.packed_batch(tcfg, cs.TRAIN_B, tcfg.max_seq_len,
                        cs.TRAIN_BATCH_SEED)
"""

SUP_INIT_CELL = """\
params = init_params(tcfg, 0, device=device)
opt = AdamW(param_leaves(params), lr=1e-3)
"""

# The cell that builds the step function, run again after a restore
# into a fresh namespace (where ``opt`` holds the optimizer's state).
SUP_STEP_FN_CELL = """\
if not isinstance(opt, torch.optim.Optimizer):
    _state, opt = opt, AdamW(param_leaves(params), lr=1e-3)
    opt.load_state_dict(_state)
step = make_train_step(tcfg, opt)
"""

SUP_STALL_CELL = """\
from nbdistributed_tpu_torch.ops.attention import flash_attention
_g = torch.Generator(device=device).manual_seed(0)
qs = [torch.randn(1, 512, n, 64, device=device, dtype=torch.bfloat16,
                  generator=_g) for n in (9, 3, 3)]
cs.reset_launch_counts()
while True:
    o = flash_attention(*qs, causal=True)   # the hung loop: K1, no collective
"""
SUP_STALL_LINE = 7

SUP_TIMED_CELL = """\
torch.cuda.synchronize()
step_ms = []
for _ in range({n}):
    _t0 = time.perf_counter()
    float(step(params, batch))
    step_ms.append(1e3 * (time.perf_counter() - _t0))
"""

SUP_HANG_CELL = """\
t = torch.ones(1, device=device)
if rank != {skip}:
    dist.all_reduce(t)
t.item()
"""
SUP_HANG_LINE = 4


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_scrapes(timeout=120.0):
    """On the rank: hold the scrape cell open until the operator has
    written :data:`SUP_SCRAPE_DONE` (or ``timeout`` has passed)."""
    t0 = time.monotonic()
    while (not SUP_SCRAPE_DONE.exists()
           and time.monotonic() - t0 < timeout):
        time.sleep(0.02)


def _poll(cond, what, timeout=120.0, every=0.05):
    t0 = time.monotonic()
    while True:
        got = cond()
        if got:
            return got
        check(time.monotonic() - t0 < timeout, f"timed out: {what}")
        time.sleep(every)


def _wd_events(event, kind=None):
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    return [e for e in DistributedMagics._watchdog.status()["events"]
            if e["event"] == event
            and (kind is None or e.get("kind") == kind
                 or e.get("step") == kind)]


def _stack_text(run_dir, rank):
    """The newest non-empty stack dump of ``rank`` (one file a worker
    pid; a respawned rank opens an empty one) and its mtime."""
    import os
    paths = [os.path.join(run_dir, n) for n in os.listdir(run_dir)
             if n.startswith(f"stacks-rank{rank}.") and n.endswith(".txt")]
    paths = [p for p in paths if os.path.getsize(p)]
    check(paths, f"no stack dump for rank {rank} in {run_dir}")
    path = max(paths, key=os.path.getmtime)
    return open(path).read(), os.path.getmtime(path)


def _cell_in_thread(nb, code, repeat=None):
    """Dispatch ``code`` on every rank as ``%%distributed`` does (vet,
    then send and stream) on a thread: the notebook is blocked in the
    cell while this thread's caller plays the operator.  Returns the
    thread and a dict that receives the replies and the return time."""
    import threading
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    box = {}
    ranks = list(range(DistributedMagics._world))

    def go():
        check(nb.magics._vet_cell(code, ranks), "vetting blocked the cell")
        box["t0"] = time.time()
        box["res"] = nb.magics._run_on_ranks(code, ranks, "distributed",
                                             repeat=repeat)
        box["t1"] = time.time()

    th = threading.Thread(target=go, daemon=True)
    th.start()
    return th, box


def phase_supervision(outputs_ref, loss_ref, n=1):
    """Phase 25, one card: items 1-5 and 7 (the rows) on ``n`` NCCL
    ranks.  ``outputs_ref``: phase 17's streams; ``loss_ref``: phase
    11's first-step loss."""
    import os
    import re
    import shutil
    import urllib.request

    import torch
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.observability import flightrec
    from nbdistributed_tpu_torch.observability import postmortem
    from nbdistributed_tpu_torch.observability.telemetry import hbm_totals

    ts = time.perf_counter()
    shutil.rmtree(SUP_CKPT, ignore_errors=True)
    ranks = list(range(n))
    port = _free_port()
    saved_env = {k: os.environ.get(k) for k in (*SUP_ENV, "NBD_HANG",
                                                "NBD_METRICS_PORT")}
    os.environ.update(SUP_ENV, NBD_METRICS_PORT=str(port))
    os.environ.pop("NBD_HANG", None)
    nb = NotebookSession()
    rows = {}
    try:
        out = nb.run(f"%dist_init -n {n} --backend gpu -t 600")
        check(f"{n} workers ready (backend=gpu" in out
              and f"📈 scrape endpoint: http://127.0.0.1:{port}/metrics"
              in out, f"%dist_init: {out}")
        check(DistributedMagics._watchdog is not None, "no watchdog armed")
        run_dir = flightrec.run_dir(create=False)
        comm = DistributedMagics._comm
        nb.run(SUP_SETUP_CELL)
        nb.run(SUP_INIT_CELL)
        nb.run(SUP_STEP_FN_CELL)

        # 1. The scrape endpoint while a training cell runs.
        base = f"http://127.0.0.1:{port}"
        nb.run("scrape_losses = []\ncs.reset_launch_counts()")
        SUP_SCRAPE_DONE.unlink(missing_ok=True)
        th, box = _cell_in_thread(nb, SUP_SCRAPE_CELL,
                                  repeat=SUP_SCRAPE_STEPS)
        scrapes = {}

        def busy_ping():
            # A ping that arrived after the cell was sent: the previous
            # cell's last busy ping can still be the latest for up to a
            # heartbeat after it ended.
            at, data = comm.last_ping(0) or (0, {})
            return (at >= box.get("t0", float("inf"))
                    and data.get("busy_s") is not None)

        try:
            _poll(lambda: busy_ping() and comm.last_telemetry(0),
                  "a busy ping")
            for path in ("/metrics", "/healthz", "/latency.json"):
                before = hbm_totals(comm.last_telemetry(0))
                t0 = time.perf_counter()
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    body = r.read().decode()
                ms = 1e3 * (time.perf_counter() - t0)
                busy = busy_ping() and "t1" not in box
                scrapes[path] = dict(ms=ms, busy_during=busy,
                                     body=body, hbm_before=before,
                                     hbm_after=hbm_totals(
                                         comm.last_telemetry(0)))
        finally:
            SUP_SCRAPE_DONE.parent.mkdir(parents=True, exist_ok=True)
            SUP_SCRAPE_DONE.touch()
            th.join(600)
            SUP_SCRAPE_DONE.unlink(missing_ok=True)
        check(box.get("res") and not any(
            m.data.get("error") for m in box["res"].values()),
            f"scrape cell: {box}")
        for path, s in scrapes.items():
            check(s["busy_during"], f"{path} answered after the cell")
        m = scrapes["/metrics"]
        for key in ("in_use", "peak", "limit"):
            got = re.search(rf'^nbd_worker_hbm_{key}_bytes\{{rank="0"\}} '
                            rf'(\S+)$', m["body"], re.M)
            check(got is not None, f"/metrics has no {key} gauge")
            want = {m["hbm_before"][key], m["hbm_after"][key]}
            check(float(got.group(1)) in want, f"/metrics {key} "
                  f"{got.group(1)} not rank 0's heartbeat {want}")
        health = json.loads(scrapes["/healthz"]["body"])
        check(health["alive"] == ranks and health["status"] == "ok",
              f"/healthz {health}")
        json.loads(scrapes["/latency.json"]["body"])
        nb.run("scrape_counts = cs.launch_counts()")
        sl, sc = nb.pull("scrape_losses"), nb.pull("scrape_counts")
        want = {"k1": 2 * N_LAYERS_SMOL * SUP_SCRAPE_STEPS,
                "k2": N_LAYERS_SMOL * SUP_SCRAPE_STEPS,
                "k3": N_LAYERS_SMOL * SUP_SCRAPE_STEPS}
        check(sl[0][0] == loss_ref, f"scrape cell's first loss "
              f"{sl[0][0]!r} != phase 11's {loss_ref!r}")
        check({k: sc[0][k] for k in want} == want, f"launches {sc[0]}")
        rows["scrape"] = dict(
            ms={p: s["ms"] for p, s in scrapes.items()},
            hbm_in_use_gb=m["hbm_before"]["in_use"] / 1e9,
            first_loss=sl[0][0], launches=sc[0])

        # 2. A Python loop launching K1: stall, dump, interrupt.
        out = nb.run("%dist_watchdog on --escalate warn,dump,interrupt")
        check("ladder warn→dump→interrupt (grace 2s)" in out, out)
        flagged = DistributedMagics._watchdog.cells_flagged
        th, box = _cell_in_thread(nb, SUP_STALL_CELL)
        try:
            _poll(lambda: DistributedMagics._watchdog.cells_flagged
                  > flagged and any(v["ranks"] == ranks for v in
                                    DistributedMagics._watchdog
                                    .last_verdicts), "a stall verdict")
            check(not [e for e in _wd_events("escalation", "interrupt")
                       if e["ts"] >= box["t0"]],
                  "interrupted before %dist_status")
            status = nb.run("%dist_status")
            # (An earlier slow cell may have had its own verdict and
            # dump: only this cell's count.)
            _poll(lambda: [e for e in _wd_events("stacks")
                           if e["ts"] >= box["t0"]], "the stack dump")
            t_dump = [e for e in _wd_events("escalation", "dump")
                      if e["ts"] >= box["t0"]][-1]["ts"]
            stacks, _ = _poll(
                lambda: (lambda s: s if f'File "<rank 0>", line '
                         f'{SUP_STALL_LINE}' in s[0] else None)(
                    _stack_text(run_dir, 0)), "the loop's line in the "
                "stack file", timeout=30, every=0.01)
            t_seen = time.time()
        finally:
            th.join(120)
        check(not th.is_alive(), "the interrupt did not end the cell")
        check(status.count("⚠ stalled") == n
              and "⚠ HUNG [stall]" in status, f"%dist_status: {status}")
        for r in ranks:
            err = box["res"][r].data.get("error") or ""
            check("KeyboardInterrupt" in err, f"rank {r}: {err}")
        verdict = [e for e in _wd_events("verdict", "stall")
                   if e["ts"] >= box["t0"]][0]
        t_int = _wd_events("escalation", "interrupt")[-1]["ts"]
        doctor = nb.run("%dist_doctor")
        check("stuck-cell doctor" in doctor and "HUNG [stall]" in doctor
              and f'line {SUP_STALL_LINE}' in doctor
              and "last flight events:" in doctor and "cell_start" in doctor,
              f"%dist_doctor: {doctor}")
        check(re.search(r"^0\s+execute \d+\.\ds", doctor, re.M),
              f"%dist_doctor shows no busy age: {doctor}")
        # The worker survived: it answers the next cells.
        nb.run("stall_k1 = cs.launch_counts()['k1']")
        stall_k1 = nb.pull("stall_k1")[0]
        check(stall_k1 > 0, "the loop launched no K1")
        nb.run("del qs, o\ntorch.cuda.synchronize()")
        nb.run(SUP_INIT_CELL)
        nb.run(SUP_STEP_FN_CELL)
        nb.run("cs.reset_launch_counts()\nafter_stall = float(step(params, "
               "batch))\nafter_counts = cs.launch_counts()")
        after = nb.pull("after_stall")[0]
        counts = nb.pull("after_counts")[0]
        check(after == loss_ref and counts == {"k1": 2 * N_LAYERS_SMOL,
                                               "k2": N_LAYERS_SMOL,
                                               "k3": N_LAYERS_SMOL},
              f"after the interrupt: loss {after!r}, launches {counts}")
        rows["stall"] = dict(
            verdict_s=verdict["ts"] - box["t0"],
            # A bound, not the write's time: when a 10 ms poll first
            # read the loop's line in the stack file.  (The file's
            # mtime ticks coarser than a dump of a few ms.)
            dump_to_stack_seen_s=t_seen - t_dump,
            interrupt_to_reply_ms=1e3 * (box["t1"] - t_int),
            loop_k1_launches=stall_k1, loss_after=after,
            detail=verdict["detail"])

        # 3. --deadline on a --repeat training cell, ladder warn.
        nb.run("%dist_watchdog on --escalate warn")
        deadline_losses = []
        for line in ("", " --deadline 3"):
            nb.run(SUP_INIT_CELL)
            nb.run(SUP_STEP_FN_CELL)
            nb.run("dl_losses = []")
            before = len(_wd_events("verdict", "deadline"))
            t0 = time.time()
            out = nb.run(f"%%distributed --repeat {SUP_DEADLINE_STEPS}"
                         f"{line}\ndl_losses.append(float(step(params, "
                         f"batch)))")
            cell_s = time.time() - t0
            deadline_losses.append(nb.pull("dl_losses")[0])
            got = _wd_events("verdict", "deadline")[before:]
            if line:
                check(len(got) == 1 and "hang watchdog [DEADLINE]" in out,
                      f"no deadline verdict: {out}")
                rows["deadline"] = dict(verdict_s=got[0]["ts"] - t0,
                                        cell_s=cell_s,
                                        detail=got[0]["detail"])
            else:
                check(not got, f"a verdict without --deadline: {got}")
        check(deadline_losses[0] == deadline_losses[1]
              and len(deadline_losses[0]) == SUP_DEADLINE_STEPS,
              f"losses with --deadline {deadline_losses[1]} != without "
              f"{deadline_losses[0]}")
        rows["deadline"]["losses_equal_bitwise"] = True

        # 4. Death during step 3: postmortem, auto-heal, restore.
        nb.run(SUP_INIT_CELL)
        nb.run(SUP_STEP_FN_CELL)
        nb.run("first2 = [float(step(params, batch)) for _ in range(2)]")
        ck = str(SUP_CKPT)
        out = nb.run(f"%dist_checkpoint {ck} params opt")
        check(f"✅ {n} ranks saved → {ck}: opt" in out, out)
        nb.run("ref34 = [float(step(params, batch)) for _ in range(2)]")
        ref34 = nb.pull("ref34")
        out = nb.run(f"%dist_restore {ck}")
        check(f"✅ {n} ranks restored" in out, out)
        out = nb.run("%dist_supervise on")
        check(f"✅ supervising {n} workers: auto-heal ON" in out, out)
        sup = DistributedMagics._supervisor
        old_pm = DistributedMagics._pm
        free_before = torch.cuda.mem_get_info(0)[0]
        out = nb.run("%dist_chaos on --kill-rank 0 --kill-at 1")
        check("kill rank 0 at msg 1" in out, out)
        out = nb.run("cs.reset_launch_counts()\nstep3 = float(step(params, "
                     "batch))", ok=False)
        check("💀" in out, f"rank 0 was not killed: {out}")
        t_ready = _poll(lambda: time.time() if (
            DistributedMagics._pm is not None
            and DistributedMagics._pm is not old_pm
            and DistributedMagics._comm is not None
            and len(DistributedMagics._comm.connected_ranks()) == n)
            else None, "the respawned world", every=0.02)
        _poll(lambda: sup.status()["heals_done"] == 1 and sup.healthy()
              and not DistributedMagics._healing, "the auto-heal")
        st = sup.status()
        moves = [(e["from"], e["to"], e["ts"]) for e in st["events"]
                 if e["rank"] == 0]
        check([m[:2] for m in moves] == [("alive", "dead"),
                                         ("dead", "healing"),
                                         ("healing", "alive")]
              and st["restarts_used"] == 1, f"supervisor: {st}")
        t_dead, t_restored = moves[0][2], moves[2][2]
        bundle = st["last_postmortem"]
        manifest = json.load(open(os.path.join(bundle, "manifest.json")))
        ring = json.load(open(os.path.join(bundle, "flight_rank0.json")))
        coord = json.load(open(os.path.join(bundle,
                                            "flight_coordinator.json")))
        tele = json.load(open(os.path.join(bundle, "telemetry.json")))
        died_on = [e for e in coord["events"] if e["t"] == "send"
                   and e.get("type") == "execute"
                   and e["ts"] <= t_dead][-1]
        last = ring["events"][-1]
        check(manifest["dead_ranks"] == [0], f"bundle {manifest}")
        check(last["t"] == "dispatch" and last["msg_id"]
              == died_on["msg_id"], f"rank 0's ring ends {last}, the "
              f"cell it died on {died_on}")
        mem0 = hbm_totals(tele["0"][-1])
        check(mem0 and mem0["in_use"] > 0, f"telemetry {tele['0'][-1:]}")
        out = nb.run("%dist_postmortem --last")
        check("dead    : ranks [0]" in out and "rank 0 [DEAD]" in out
              and "rank 0: hbm " in out, f"%dist_postmortem: {out}")
        status = nb.run("%dist_supervise status")
        check(f"restarts 1/3 in window · heals 1 ok" in status, status)
        nb.run(SUP_SETUP_CELL)
        check(nb.pull("rebuilt")[0] == [], "the heal rebuilt kernels")
        nb.run(SUP_STEP_FN_CELL)
        nb.run("cs.reset_launch_counts()\nheal34 = [float(step(params, "
               "batch)) for _ in range(2)]\nheal_counts = "
               "cs.launch_counts()")
        heal34, hc = nb.pull("heal34"), nb.pull("heal_counts")
        free_after = torch.cuda.mem_get_info(0)[0]
        want = {"k1": 4 * N_LAYERS_SMOL, "k2": 2 * N_LAYERS_SMOL,
                "k3": 2 * N_LAYERS_SMOL}
        for r in ranks:
            check(heal34[r] == ref34[r], f"rank {r}: steps 3-4 after the "
                  f"heal {heal34[r]} != uninterrupted {ref34[r]}")
            check({k: hc[r][k] for k in want} == want, f"rank {r}: {hc[r]}")
        nb.run(SUP_TIMED_CELL.format(n=SUP_TIMED_STEPS))
        armed_ms = nb.pull("step_ms")[0]
        rows["heal"] = dict(
            losses_34=heal34[0], losses_equal_bitwise=True,
            launches_2_steps={k: hc[0][k] for k in want},
            death_to_bundle_s=manifest["created_unix"] - t_dead,
            death_to_ready_s=t_ready - t_dead,
            death_to_restored_s=t_restored - t_dead,
            free_gb_before_kill=free_before / 1e9,
            free_gb_after_heal=free_after / 1e9,
            transitions=[m[:2] for m in moves],
            bundle_files=sorted(os.listdir(bundle)),
            rank0_last_hbm_gb=mem0["in_use"] / 1e9)
        # The healed world serves phase 17's requests.
        nb.run(NOTEBOOK_SERVE_CELL)
        served, outputs = nb.pull("served"), nb.pull("outputs")
        for r in ranks:
            s = served[r]
            check(s["rebuilt"] == [] and s["steps"] > 0
                  and s["k4"] == N_LAYERS_SMOL * s["steps"],
                  f"rank {r}: K4 {s['k4']} over {s['steps']} steps")
            check(outputs[r] == outputs_ref, f"rank {r}: the healed "
                  "world's streams differ from phase 17's")
        rows["heal"]["serve"] = dict(k4_launches=served[0]["k4"],
                                     decode_steps=served[0]["steps"],
                                     tokens_equal=True)
        nb.run("%dist_supervise off")

        # 5. %dist_guard on phase 22's guarded step.
        nb.run(GUARD_WORKER_CELL)
        out = nb.run("%dist_guard status")
        check(all(f"🔹 rank {r}: step 2 · skips 0" in out for r in ranks),
              f"%dist_guard status: {out}")
        audit = nb.run("%dist_guard audit")
        check(all(f"🔹 rank {r}: step 2 · skips 0" in audit
                  for r in ranks) and "audits 1 (last @2: ok)" in audit
              and "✅ audit fanned out to every rank" in audit,
              f"%dist_guard audit: {audit}")
        rows["guard"] = dict(status=out.strip(), audit=audit.strip())
        out = nb.run("%dist_shutdown")
        check(f"✅ shut down {n} workers" in out, out)

        # 7. A step with the watchdog off (NBD_HANG=0 at spawn).
        os.environ["NBD_HANG"] = "0"
        out = nb.run(f"%dist_init -n {n} --backend gpu -t 600")
        check(DistributedMagics._watchdog is None, "NBD_HANG=0 armed it")
        nb.run(SUP_SETUP_CELL)
        nb.run(SUP_INIT_CELL)
        nb.run(SUP_STEP_FN_CELL)
        nb.run(SUP_TIMED_CELL.format(n=SUP_TIMED_STEPS))
        off_ms = nb.pull("step_ms")[0]
        rows["watchdog_cost"] = dict(
            armed_ms=armed_ms, off_ms=off_ms,
            armed_median_ms=sorted(armed_ms)[len(armed_ms) // 2],
            off_median_ms=sorted(off_ms)[len(off_ms) // 2])
        out = nb.run("%dist_shutdown")
        check(f"✅ shut down {n} workers" in out, out)
    finally:
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"supervision_cells_n{n}.json").write_text(
            json.dumps(nb.log, indent=1))
    rows.update(ranks=n, seconds=time.perf_counter() - ts)
    say("supervision", **{k: v for k, v in rows.items() if k != "guard"})
    return rows


def phase_supervision_mesh(n=MESH_WORLD):
    """Phase 25, item 6, ``n`` NCCL ranks (one a card): ``if rank !=
    n - 1: dist.all_reduce(t)`` then ``t.item()``.  Ranks 0..n-2 block
    at ``.item()`` behind a collective rank n-1 never joins: the
    watchdog names it, dumps the stacks and heals the world well inside
    the 120 s NCCL timeout; the healed group all-reduces again."""
    import os

    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.observability import flightrec

    ts = time.perf_counter()
    skip = n - 1
    saved_env = {k: os.environ.get(k) for k in (*SUP_ENV, "NBD_HANG",
                                                "NBD_METRICS_PORT")}
    os.environ.update(SUP_ENV)
    os.environ.pop("NBD_HANG", None)
    os.environ.pop("NBD_METRICS_PORT", None)
    nb = NotebookSession()
    try:
        out = nb.run(f"%dist_init -n {n} --backend gpu -t 600")
        check(f"{n} workers ready (backend=gpu" in out, out)
        run_dir = flightrec.run_dir(create=False)
        # One all-reduce every rank joins first: the NCCL communicator
        # is up, so the hung cell's all_reduce returns at enqueue and
        # ranks 0..n-2 block at .item() (the first collective on the
        # group blocks inside all_reduce, in the communicator's set-up).
        nb.run("t = torch.ones(1, device=device)\ndist.all_reduce(t)\n"
               "warm = t.item()")
        warm = nb.pull("warm")
        check(warm == {r: float(n) for r in range(n)}, f"warm-up {warm}")
        nb.run("%dist_lint off")
        out = nb.run("%dist_watchdog on --escalate warn,dump,heal")
        check("ladder warn→dump→heal" in out, out)
        old_pm = DistributedMagics._pm
        wd = DistributedMagics._watchdog
        th, box = _cell_in_thread(nb, SUP_HANG_CELL.format(skip=skip))
        try:
            # Each rank crosses the skew window on its own pings: the
            # assessment names every stuck rank within a ping or two.
            full = _poll(lambda: next(
                (dict(v) for v in wd.last_verdicts
                 if v["ranks"] == list(range(skip))), None),
                "a verdict naming every stuck rank", timeout=60,
                every=0.02)
            t_full = time.time()
        finally:
            th.join(120)
        check(not th.is_alive(), "the hung cell never came back")
        t0, t_back = box["t0"], box["t1"]
        _poll(lambda: DistributedMagics._pm is not None
              and DistributedMagics._pm is not old_pm
              and DistributedMagics._comm is not None
              and len(DistributedMagics._comm.connected_ranks()) == n
              and not DistributedMagics._healing, "the healed world")
        t_healed = time.time()
        verdict = [e for e in _wd_events("verdict") if e["ts"] >= t0][0]
        dump = [e for e in _wd_events("escalation", "dump")
                if e["ts"] >= t0][-1]
        heal = [e for e in _wd_events("escalation", "heal")
                if e["ts"] >= t0][-1]
        check(verdict["kind"] == full["kind"] == "skew"
              and set(verdict["ranks"]) <= set(range(skip))
              and full["peers"] == [skip]
              and full["detail"].startswith(
                  f"ranks [{skip}] finished the cell but rank(s) "
                  f"{list(range(skip))} are stuck inside all_reduce #"),
              f"verdicts {verdict}, {full}")
        stuck_at = {}
        for r in range(skip):
            text, _ = _stack_text(run_dir, r)
            stuck_at[r] = text.count(f'File "<rank {r}>", line '
                                     f'{SUP_HANG_LINE}')
            check(f'File "<rank {r}>", line {SUP_HANG_LINE}' in text,
                  f"rank {r}'s stacks do not name the .item() line: "
                  f"{text[-1500:]}")
        check(t_healed - t0 < 60, f"healed {t_healed - t0:.1f} s after "
              "the hang began")
        out = nb.run("t = torch.ones(1, device=device)\ndist.all_reduce(t)"
                     "\nsummed = t.item()")
        sums = nb.pull("summed")
        check(sums == {r: float(n) for r in range(n)},
              f"all_reduce after the heal: {sums}")
        out = nb.run("%dist_shutdown")
        check(f"✅ shut down {n} workers" in out, out)
    finally:
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"supervision_mesh_cells_n{n}.json").write_text(
            json.dumps(nb.log, indent=1))
    row = dict(ranks=n, verdict_s=verdict["ts"] - t0,
               first_verdict_ranks=verdict["ranks"],
               dumps_at_the_item_line=stuck_at,
               all_stuck_ranks_named_s=t_full - t0,
               dump_s=dump["ts"] - t0,
               heal_started_s=heal["ts"] - t0,
               cell_returned_s=t_back - t0, healed_s=t_healed - t0,
               detail=full["detail"],
               seconds=time.perf_counter() - ts)
    say("supervision_mesh", **row)
    return row


# Phase 26: the gateway's tenant plane.  `%dist_pool start` spawns a
# gateway daemon owning one GPU rank; tenant alice (this script, through
# the magics) trains phase 11's step in her cells, tenant bob (a raw
# TenantClient) serves phase 17's requests in his; admission, a tenant
# kernel's crash and the stale-epoch fence are driven on the live pool;
# a single-kernel session is SIGKILLed and adopted by %dist_attach; and
# %dist_pool stop leaves nothing behind.  Item 7 (the resize, four
# cards) runs under --mesh-nccl.

POOL_RUNS = ROOT / "build" / "pool_runs"
POOL_TRAIN_STEPS = 2
POOL_RT_CELLS = 20
POOL_HOLD_S = 6.0

POOL_TRAIN_SETUP_CELL = """\
import chip_smoke as cs
from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                            make_train_step, param_leaves,
                                            smol_135m_config)
from nbdistributed_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
rebuilt = sorted(_build.build_all())
tcfg = smol_135m_config(remat=True)
params = init_params(tcfg, 0, device=device)
batch = cs.packed_batch(tcfg, cs.TRAIN_B, tcfg.max_seq_len,
                        cs.TRAIN_BATCH_SEED)
step = make_train_step(tcfg, AdamW(param_leaves(params), lr=1e-3))
alice = {"losses": [], "launches": [], "rebuilt": rebuilt,
         "device": str(params["embed"].device)}
"""

POOL_TRAIN_STEP_CELL = """\
cs.reset_launch_counts()
alice["losses"].append(float(step(params, batch)))
alice["launches"].append(cs.launch_counts())
repr(alice)
"""

POOL_SERVE_CELL = """\
import chip_smoke as cs
from nbdistributed_tpu_torch.models import init_params, smol_135m_config
from nbdistributed_tpu_torch.ops import decode as _decode
torch.backends.cuda.matmul.allow_tf32 = False
cfg = smol_135m_config()
params = init_params(cfg, 0, device=device)
prompts = cs.make_requests(cfg)
cs.reset_launch_counts()
outputs, steps, wall, _, _ = cs.serve(params, cfg, prompts)
served = {**cs.launch_counts(), "k4": _decode.flash_decode_attention.launches,
          "steps": steps, "wall_s": wall, "outputs": outputs,
          "names": sorted(n for n in dir() if not n.startswith("_"))}
del params
torch.cuda.empty_cache()
repr(served)
"""

# The single-kernel session the smoke SIGKILLs: a child Python process
# driving the magics (%dist_init -n 1 on the card), which leaves a CUDA
# tensor and a cell still running.  argv: run dir, checkout, status file.
POOL_KERNEL = r'''
import json, os, sys, time
os.environ["NBD_RUN_DIR"] = sys.argv[1]
sys.path.insert(0, sys.argv[2])
from nbdistributed_tpu_torch.magics.magic import DistributedMagics

class Shell:
    def __init__(self):
        self.user_ns = {}
        self.input_transformers_cleanup = []

m = DistributedMagics(Shell())
m.dist_init("-n 1 --backend gpu -t 600")
m.distributed("", """\
g = torch.Generator(device=device).manual_seed(5)
kept = torch.randn(1 << 24, device=device, generator=g)
def checksum(t):
    return int(t.view(torch.int32).to(torch.int64).sum())
hits = 0
ck = checksum(kept)
""")
m.dist_pull("ck")
comm = DistributedMagics._comm
mid = comm.post([0], "execute", {
    "code": "hits += 1\nimport time\ntime.sleep(4.0)\nhits",
    "target_ranks": [0]})
with open(sys.argv[3] + ".tmp", "w") as f:
    json.dump({"mid": mid, "checksum": int(m.shell.user_ns["ck"]),
               "pids": [p.pid for p in DistributedMagics._pm
                        .processes.values()]}, f)
os.replace(sys.argv[3] + ".tmp", sys.argv[3])
time.sleep(600)
'''


def _lit(results, rank="0"):
    """The literal a tenant cell's last expression printed on ``rank``."""
    import ast
    return ast.literal_eval(ast.literal_eval(results[rank]["output"]))


def pool_cell(nb, code, line=""):
    """``%%distributed`` in tenant mode on the stand-in shell: the
    printed text (logged as phase 23's cells are) and the per-rank
    results the magic returns."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = nb.magics.distributed(line, code)
    out = buf.getvalue()
    nb.log.append({"cell": f"%%distributed {line}\n{code}", "out": out})
    return out, res


def _proc_gone(pid):
    """Exited: no /proc entry, or a zombie its parent has not reaped."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def phase_pool(outputs_ref, losses_ref, solo32):
    """Phase 26, one card: items 1-5, the serving plane's items 8-12
    (``pool_serving_plane``), then item 6.  ``outputs_ref``: phase 17's
    in-process bf16 streams; ``losses_ref``: phase 11's step losses;
    ``solo32``: phase 5's fp32 solo ``generate`` streams."""
    import os
    import shutil
    import signal
    import statistics
    import threading

    import torch
    from nbdistributed_tpu_torch.gateway import daemon as gw
    from nbdistributed_tpu_torch.gateway.client import (CellSubmitError,
                                                        GatewayGone,
                                                        TenantClient,
                                                        TenantFenced)
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.resilience import session

    ts = time.perf_counter()
    saved_run_dir = os.environ.get("NBD_RUN_DIR")
    shutil.rmtree(POOL_RUNS, ignore_errors=True)
    run_dir = str(POOL_RUNS / "pool")
    single_dir = str(POOL_RUNS / "single")
    os.makedirs(single_dir)
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    nb = NotebookSession()
    clients, kernel, nb3 = [], None, None
    rows: dict = {}

    def attach(name, **kw):
        m = gw.read_gateway_manifest(run_dir)
        t0 = time.perf_counter()
        c = TenantClient(m["tenant_plane"]["host"],
                         m["tenant_plane"]["port"], name,
                         pool_token=m["pool_token"], **kw)
        clients.append(c)
        return c, 1e3 * (time.perf_counter() - t0)

    def outs(data):
        return {r: (d or {}).get("output")
                for r, d in (data.get("results") or {}).items()}

    try:
        # -- the pool -------------------------------------------------
        t0 = time.perf_counter()
        out = nb.run(f"%dist_pool start -n 1 --backend gpu --mesh-slots 1 "
                     f"--queue-depth 2 --tenant-inflight 2 --max-tenants 3 "
                     f"--run-dir {run_dir}")
        start_s = time.perf_counter() - t0
        check("✅ pool up" in out, f"%dist_pool start: {out}")
        manifest = gw.read_gateway_manifest(run_dir)
        daemon_pid = manifest["pid"]
        rank_pids = list(session.read_manifest(run_dir)["pids"].values())
        check(len(rank_pids) == 1, f"pool ranks {rank_pids}")

        # -- item 1: alice trains phase 11's step in her cells ---------
        t0 = time.perf_counter()
        out = nb.run(f"%dist_attach --tenant alice {run_dir}")
        alice_attach_ms = 1e3 * (time.perf_counter() - t0)
        check(f"🤝 attached to pool {run_dir} as tenant 'alice' (epoch 1, "
              "1 ranks" in out, f"%dist_attach --tenant: {out}")
        out, res = pool_cell(nb, POOL_TRAIN_SETUP_CELL)
        check(res is not None and "❌" not in out, f"setup cell: {out}")
        for _ in range(POOL_TRAIN_STEPS):
            out, res = pool_cell(nb, POOL_TRAIN_STEP_CELL)
            check(res is not None and "❌" not in out, f"step cell: {out}")
        alice = _lit(res)
        want = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
                "k3": N_LAYERS_SMOL}
        check(alice["rebuilt"] == [] and alice["device"] == "cuda:0",
              f"alice's rank rebuilt {alice['rebuilt']}, on "
              f"{alice['device']}")
        check(all(c == want for c in alice["launches"]),
              f"alice's steps launched {alice['launches']}, want {want}")
        check(alice["losses"] == losses_ref[:POOL_TRAIN_STEPS],
              f"alice's losses {alice['losses']} != phase 11's "
              f"{losses_ref[:POOL_TRAIN_STEPS]}")
        rows["alice"] = dict(losses=alice["losses"], launches=want,
                             steps=POOL_TRAIN_STEPS, losses_equal=True,
                             attach_ms=alice_attach_ms)
        say("pool_alice", **rows["alice"])

        # -- item 2: bob serves phase 17's requests in his namespace ---
        bob, hello_ms = attach("bob")
        t0 = time.perf_counter()
        res = bob.execute(POOL_SERVE_CELL)
        serve_cell_s = time.perf_counter() - t0
        check(res.get("status") == "ok", f"bob's serving cell: {res}")
        served = _lit(res["results"])
        check(served["outputs"] == outputs_ref, "bob's streams differ from "
              "the in-process server's")
        check(served["k4"] == N_LAYERS_SMOL * served["steps"]
              and served["steps"] > 0, f"bob's K4 launched {served['k4']} "
              f"times over {served['steps']} decode steps")
        check("alice" not in served["names"] and "step" not in
              served["names"] and "tcfg" not in served["names"],
              f"alice's names in bob's namespace: {served['names']}")
        check(outs(bob.execute("'params' in dir()")) == {"0": "False"},
              "bob's del did not hold")
        _, res = pool_cell(nb, "'prompts' in dir(), len(alice['losses'])")
        check(res["0"]["output"] == f"(False, {POOL_TRAIN_STEPS})",
              f"alice's namespace: {res}")
        n_tok = sum(len(o) for o in outputs_ref)
        rows["bob"] = dict(k4_launches=served["k4"],
                           k1_launches=served["k1"],
                           decode_steps=served["steps"],
                           want_k4=N_LAYERS_SMOL * served["steps"],
                           tokens=n_tok, worker_wall_s=served["wall_s"],
                           tokens_per_s=n_tok / served["wall_s"],
                           cell_s=serve_cell_s, tokens_equal=True,
                           hello_ms=hello_ms)
        say("pool_bob", **rows["bob"])

        # -- item 3: admission ----------------------------------------
        carol, _ = attach("carol")
        try:
            attach("dave")
            check(False, "a fourth tenant was admitted")
        except RuntimeError as e:
            check("max_tenants=3" in str(e), f"hello refusal: {e}")
        # Daemon threads here and below: a failed check must not keep
        # the process waiting for a client call still in flight.
        holder = threading.Thread(target=lambda: bob.execute(
            f"import time\ntime.sleep({POOL_HOLD_S})"), daemon=True)
        holder.start()
        _poll(lambda: bob.pool_status()["scheduler"]["active"] == 1,
              "bob's cell holding the mesh slot")

        # The pool's view while bob holds the mesh: both tenants, and
        # rank 0 busy for bob (off its 2 s heartbeats).
        def busy_bob():
            out = nb.run("%dist_pool status")
            return out if "rank 0: ⚙ execute" in out \
                and "· tenant bob" in out else None
        status = _poll(busy_bob, "rank 0 busy for tenant bob",
                       POOL_HOLD_S, 0.1)
        check("alice*" in status and "\nbob " in status
              and "\ncarol " in status, f"%dist_pool status: {status}")
        positions, results = [], []
        carols = []
        for i in range(2):
            t = threading.Thread(target=lambda i=i: results.append(
                carol.execute(f"{i} + 1", priority=1, on_queued=lambda n:
                              positions.append(n["position"]))))
            t.start()
            carols.append(t)
            _poll(lambda: len(positions) == i + 1, "carol's queued notice")
        try:
            carol.execute("3")
            check(False, "carol's third cell was admitted past her cap")
        except CellSubmitError as e:
            rejected = e.verdict
        out, res = pool_cell(nb, "never = 1", "--priority 0")
        check(res is None and "🪓 cell shed under overload" in out,
              f"alice's priority-0 cell under overload: {out}")
        holder.join(60)
        for t in carols:
            t.join(60)
        check(sorted(positions) == [1, 2]
              and rejected["status"] == "rejected"
              and rejected["reason"] == "tenant-inflight-cap"
              and sorted(outs(r)["0"] for r in results) == ["1", "2"],
              f"positions {positions}, rejected {rejected}, "
              f"results {results}")
        sched = bob.pool_status()["scheduler"]["tenants"]
        check(sched["alice"]["shed"] == 1, f"shed counts {sched}")
        rows["admission"] = dict(queued_positions=sorted(positions),
                                 rejected=rejected["reason"],
                                 shed_tenant="alice",
                                 refused_hello="max_tenants=3")
        say("pool_admission", **rows["admission"])
        carol.close(detach=True)

        # -- item 4: alice's kernel crashes mid-cell -------------------
        a1 = DistributedMagics._tenant
        lost = []

        def inflight():
            try:
                a1.execute("import time\ntime.sleep(2)\n'alice-parked'")
            except GatewayGone:
                lost.append(True)
        th = threading.Thread(target=inflight, daemon=True)
        th.start()
        _poll(lambda: bob.pool_status()["scheduler"]["active"] == 1,
              "alice's in-flight cell")
        a1._ch.close()                   # the kernel dies
        th.join(60)
        DistributedMagics._tenant = None  # ... and a new one starts
        DistributedMagics._pool_info = None
        _poll(lambda: bob.pool_status()["tenants"]["tenants"]["alice"][
            "parked"] == 1, "alice's parked result", 60)
        t0 = time.perf_counter()
        out = nb.run(f"%dist_attach --tenant alice {run_dir}")
        reattach_s = time.perf_counter() - t0
        check(f"🔗 reattached to pool {run_dir} as tenant 'alice' (epoch "
              "2" in out and out.count("finished while detached: "
                                       "'alice-parked'") == 1,
              f"reattach: {out}")
        a2 = DistributedMagics._tenant
        check(a2.drain() == {}, "a second drain found results")
        st = bob.pool_status()["tenants"]["tenants"]["alice"]
        check(st["parked"] == 0 and st["parked_total"] == 1
              and st["reattaches"] == 1 and lost == [True],
              f"alice's row {st}")
        # A third kernel resumes alice: the second's next request is
        # fenced.
        a3, _ = attach("alice", token=a2.token)
        try:
            a2.execute("1")
            check(False, "the stale connection's cell ran")
        except TenantFenced:
            pass
        out, res = pool_cell(nb, "1")
        check(res is None and "⛔" in out, f"fenced magic cell: {out}")
        check(outs(a3.execute("len(alice['losses'])")) == {
            "0": str(POOL_TRAIN_STEPS)}, "alice's namespace after the "
              "reattaches")
        rows["crash"] = dict(reattach_and_drain_s=reattach_s,
                             parked_total=1, epochs=[1, 2, 3],
                             fenced=True)
        say("pool_crash", **rows["crash"])

        # Round trips of a trivial tenant cell (raw client, no magics).
        rt = []
        for _ in range(POOL_RT_CELLS):
            t0 = time.perf_counter()
            a3.execute("1")
            rt.append(time.perf_counter() - t0)
        a3.execute("del params, batch, step\ntorch.cuda.empty_cache()")
        a3.close(detach=True)
        bob.close(detach=True)

        # -- item 5: a single-kernel session, SIGKILLed and adopted ----
        nb2 = NotebookSession()          # a fresh kernel: no tenant
        status_path = os.path.join(single_dir, "kernel.json")
        log = open(OUT_DIR / "pool_kernel_stdout.txt", "w")
        kernel = subprocess.Popen(
            [sys.executable, "-c", POOL_KERNEL, single_dir, str(ROOT),
             status_path], stdout=log, stderr=subprocess.STDOUT)
        _poll(lambda: os.path.exists(status_path)
              or kernel.poll() is not None, "the single-kernel session",
              300, 0.2)
        check(os.path.exists(status_path),
              "the single-kernel session died before its cell: "
              + (OUT_DIR / "pool_kernel_stdout.txt").read_text()[-2000:])
        info = json.load(open(status_path))
        time.sleep(0.5)                   # the cell is mid-flight
        os.kill(kernel.pid, signal.SIGKILL)
        kernel.wait(60)
        t0 = time.perf_counter()
        out = nb2.run(f"%dist_attach {single_dir}")
        adopt_s = time.perf_counter() - t0
        check(f"🔗 reattached to 1 workers (epoch 2, run {single_dir}"
              in out, f"%dist_attach: {out}")
        check(out.count(f"📬 rank 0 · interrupted cell {info['mid'][:8]}… "
                        "finished while orphaned: 1") == 1,
              f"the interrupted cell's output: {out}")
        nb2.run("%%distributed\nafter = checksum(kept)\n"
                "on = str(kept.device)")
        after, on = nb2.pull("after"), nb2.pull("on")
        check(after == {0: info["checksum"]} and on == {0: "cuda:0"},
              f"the adopted rank's tensor: {after} vs {info['checksum']} "
              f"on {on}")
        nb2.run("%%distributed\nhits_now = hits")
        check(nb2.pull("hits_now") == {0: 1}, "the interrupted cell ran "
              "twice")
        comm = DistributedMagics._comm
        check(all(not d for d in session.drain_mailboxes(comm).values()),
              "a second drain found results")
        out = nb2.run(f"%dist_gc --dry-run --root {POOL_RUNS}")
        check(f"= kept {run_dir} — live gateway daemon (pid {daemon_pid})"
              in out and f"= kept {single_dir} — current session's run dir"
              in out, f"%dist_gc --dry-run: {out}")
        out = nb2.run("%dist_shutdown")
        check("✅ shut down 1 workers" in out, f"%dist_shutdown: {out}")
        rows["single_kernel"] = dict(adopt_and_drain_s=adopt_s,
                                     checksum=after[0], bitwise=True,
                                     delivered_once=True)
        say("pool_single_kernel", **rows["single_kernel"])

        # -- items 8-12: the serving plane ----------------------------
        t0 = time.perf_counter()
        nb3 = NotebookSession()
        plane, b_pids = pool_serving_plane(nb3, run_dir, attach,
                                           outputs_ref, solo32)
        rows.update(plane, serve_plane_seconds=time.perf_counter() - t0)

        # -- item 6: teardown -----------------------------------------
        t0 = time.perf_counter()
        out = nb2.run(f"%dist_pool stop --run-dir {run_dir}")
        check(f"🛑 pool {run_dir}: stopping" in out, f"stop: {out}")
        _poll(lambda: all(_proc_gone(p) for p in [daemon_pid, *rank_pids,
                                                   *info["pids"],
                                                   *b_pids]),
              "the daemon's and every rank's exit", 60, 0.05)
        stop_s = time.perf_counter() - t0
        check(gw.read_gateway_manifest(run_dir) is None,
              "the gateway manifest outlived the pool")

        def memory_back():
            torch.cuda.synchronize()
            return free_before - torch.cuda.mem_get_info()[0] < 1e9
        _poll(memory_back, "the card's free memory", 30, 0.2)
        free_after = torch.cuda.mem_get_info()[0]
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        if kernel is not None and kernel.poll() is None:
            kernel.kill()
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        m = gw.read_gateway_manifest(run_dir)
        if m is not None and gw.gateway_alive(m):
            from nbdistributed_tpu_torch.gateway.client import \
                pool_shutdown
            try:
                pool_shutdown("127.0.0.1", m["tenant_plane"]["port"],
                              m["pool_token"])
            except Exception:
                pass
        DistributedMagics.reset_class_state()
        if saved_run_dir is None:
            os.environ.pop("NBD_RUN_DIR", None)
        else:
            os.environ["NBD_RUN_DIR"] = saved_run_dir
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "pool_cells_n1.json").write_text(
            json.dumps(nb.log, indent=1))
        if nb3 is not None:
            (OUT_DIR / "pool_serve_cells_n1.json").write_text(
                json.dumps(nb3.log, indent=1))
    rows.update(ranks=1, start_to_ready_s=start_s,
                tenant_cell_ms_median=1e3 * statistics.median(rt),
                tenant_cell_ms=[1e3 * x for x in rt], stop_s=stop_s,
                free_gb_before=free_before / 1e9,
                free_gb_after=free_after / 1e9,
                seconds=time.perf_counter() - ts)
    say("pool", **{k: v for k, v in rows.items()
                   if k in ("start_to_ready_s", "tenant_cell_ms_median",
                            "stop_s", "free_gb_before", "free_gb_after",
                            "seconds")})
    return rows


# The gateway's serving plane (phase 26, items 8-12): the model-spec
# cells that bind SmolLM2-135M (full width and depth, seed 0) in a
# serving tenant's namespace on every rank, and the cells another
# tenant runs on the same rank to reset and read the launch counts
# (the worker process's, which the serving tenant's DecodeServer bumps).
SERVE_SPEC = """\
import chip_smoke as cs
from nbdistributed_tpu_torch.models import init_params, smol_135m_config
torch.backends.cuda.matmul.allow_tf32 = False
cfg = smol_135m_config({dtype})
params = init_params(cfg, 0, device=device)
"""
SERVE_SPEC_BF16 = SERVE_SPEC.format(dtype="")
SERVE_SPEC_FP32 = SERVE_SPEC.format(dtype="dtype=torch.float32")
PLANE_RESET_CELL = "import chip_smoke as cs\ncs.reset_launch_counts()\n"
PLANE_COUNTS_CELL = """\
import chip_smoke as cs
from nbdistributed_tpu_torch.ops import decode as _decode
repr({**cs.launch_counts(), "k4": _decode.flash_decode_attention.launches})
"""
PLANE_NEW = 32
# The kernels line's paths of the serving plane (K4's: its prefill is
# the plain cached attention, so K1 is not on them).
PLANE_PATHS = ("serve_plane", "serve_plane_loadgen", "serve_plane_recovered",
               "serve_plane_migrated")
PLANE_LOADGEN = dict(rps=3.0, duration_s=10.0, arrival="poisson", seed=0,
                     prompt_len=(16, 200), max_new=(32, 32), vocab=49152)


def plane_counts(client, reset=False):
    """Reset (``reset=True``) or read the launch counts of ``client``'s
    rank 0 with a cell of that tenant."""
    res = client.execute(PLANE_RESET_CELL if reset else PLANE_COUNTS_CELL,
                         target_ranks=[0])
    check(res.get("status") == "ok" and not (
        res["results"]["0"] or {}).get("error"), f"count cell: {res}")
    return None if reset else _lit(res["results"])


def plane_results(client, rids, timeout=600.0):
    """Every rid's terminal ``serve_result``, polled."""
    got: dict = {}
    deadline = time.time() + timeout
    while len(got) < len(rids):
        check(time.time() < deadline, f"unfinished: "
              f"{sorted(set(rids) - set(got))}: {client.serve_status()}")
        for rid in rids:
            if rid not in got:
                r = client.serve_result(rid)
                if r.get("done"):
                    got[rid] = r
        time.sleep(0.02)
    return got


def plane_slo(st):
    """TTFT / TPOT p50 and p99 (ms) of a ``serve_status``."""
    slo = st.get("slo") or {}
    return {f"{k}_ms_{q}": (slo.get(f"{k}_ms") or {}).get(q)
            for k in ("ttft", "tpot") for q in ("p50", "p99")}


def journal_streams(run_dir, serving_tenant, rids):
    """The streams a serving plane journaled, by rid."""
    from nbdistributed_tpu_torch.gateway.serving import (ServeJournal,
                                                         journal_path)
    state = ServeJournal.load(journal_path(run_dir, serving_tenant))
    return [state[r]["tokens"] for r in rids]


def mid_decode(client, rids, timeout=300.0):
    """Wait until some stream of ``rids`` has started and not ended."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        for rid in rids:
            r = client.serve_result(rid)
            if r.get("tokens") and not r.get("done"):
                return rid, len(r["tokens"])
        time.sleep(0.005)
    check(False, f"no stream of {rids} seen mid-decode")


def pool_serving_plane(nb, run_dir, attach, outputs_ref, solo32):
    """Phase 26, items 8-12, on the pool of ``phase_pool`` after alice,
    bob and carol have left: the serving plane in bf16 (``%dist_serve``),
    the loadgen through the HTTP shim, overload verdicts, a plane
    stopped mid-decode and recovered from its journal in fp32, and a
    tenant migrated with its journal to a second pool.  Returns the
    rows and the second pool's pids."""
    import re
    import signal

    import torch
    from nbdistributed_tpu_torch.gateway import daemon as gw
    from nbdistributed_tpu_torch.gateway.client import (CellSubmitError,
                                                        TenantClient)
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.models import init_params, smol_135m_config
    from nbdistributed_tpu_torch.resilience import session
    from nbdistributed_tpu_torch.serving_fast import (LoadConfig, run_load,
                                                      validate_report)
    from nbdistributed_tpu_torch.serving_fast.loadgen import HTTPTransport

    cfg = smol_135m_config()
    prompts = make_requests(cfg)
    rows: dict = {}

    # -- item 8: the plane in bf16 ------------------------------------
    out = nb.run(f"%dist_attach --tenant srvadmin {run_dir}")
    admin = DistributedMagics._tenant
    nb.shell.user_ns["SPEC"] = SERVE_SPEC_BF16
    t0 = time.perf_counter()
    out = nb.run("%dist_serve start --spec SPEC --tenant serve-bf16 "
                 "--max-batch 8 --max-len 1024")
    start_s = time.perf_counter() - t0
    check("🍽️ serving as tenant 'serve-bf16': 8 KV slots · max_len 1024"
          in out, f"%dist_serve start: {out}")
    plane_counts(admin, reset=True)
    t0 = time.perf_counter()
    rids = [admin.serve_submit(p, PLANE_NEW)["rid"] for p in prompts[:-1]]
    out = nb.run(f"%dist_serve submit --prompt "
                 f"{','.join(map(str, prompts[-1]))} --max-new {PLANE_NEW} "
                 f"--wait")
    m = re.search(r"✅ accepted (r\d+)", out)
    check(m is not None and f"🧾 {m.group(1)} completed:" in out,
          f"%dist_serve submit --wait: {out}")
    rids.append(m.group(1))
    got = plane_results(admin, rids)
    wall = time.perf_counter() - t0
    counts = plane_counts(admin)
    st = admin.serve_status()
    streams = [got[r]["tokens"] for r in rids]
    check(all(got[r]["status"] == "completed" for r in rids)
          and all(len(x) == PLANE_NEW for x in streams),
          f"bf16 plane: {[(r, got[r]['status'], len(got[r]['tokens'])) for r in rids]}")
    check(st["dup_dropped"] == 0 and st["completed"] == len(rids),
          f"bf16 plane status: {st}")
    # K4 once per layer per decode step: a positive multiple of the
    # depth, and at least the longest stream's decode steps.  Prefill
    # is the plain cached attention (``models/generate.py``
    # ``_cached_attention``, as in the JAX package), so K1 is not on
    # this path: its count is reported.
    steps_min = N_LAYERS_SMOL * (PLANE_NEW - 1)
    check(counts["k4"] > 0 and counts["k4"] % N_LAYERS_SMOL == 0
          and counts["k4"] >= steps_min,
          f"bf16 plane's launches {counts}: K4 a positive multiple of "
          f"{N_LAYERS_SMOL} and at least {steps_min}")
    lat = nb.run("%dist_serve lat --last 2")
    check("⏱ serving stage decomposition (12 recorded" in lat,
          f"%dist_serve lat: {lat}")
    stat = nb.run("%dist_serve status")
    n_tok = PLANE_NEW * len(rids)
    rows["serve_plane"] = dict(
        requests=len(rids), k4_launches=counts["k4"],
        k1_launches=counts["k1"], k4_decode_steps=counts["k4"]
        // N_LAYERS_SMOL, streams_equal_phase17=sum(
            a == b for a, b in zip(streams, outputs_ref)),
        tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
        start_s=start_s, dup_dropped=st["dup_dropped"], **plane_slo(st),
        stage_table=lat, status=stat)
    say("pool_serve_plane", **{k: v for k, v in rows["serve_plane"].items()
                               if k not in ("stage_table", "status")})

    # -- item 9: the loadgen through the HTTP shim ---------------------
    shim = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "nbd_torch_serve.py"),
         "--run-dir", run_dir, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = shim.stdout.readline()
        check(line.startswith("NBD_SERVE_HTTP ready on 127.0.0.1:"),
              f"the HTTP shim: {line}")
        port = int(line.split()[3].rsplit(":", 1)[1])
        plane_counts(admin, reset=True)
        cfg_load = LoadConfig(**PLANE_LOADGEN, drain_s=120.0)
        rep = run_load(HTTPTransport(f"http://127.0.0.1:{port}"), cfg_load)
        counts9 = plane_counts(admin)
    finally:
        shim.send_signal(signal.SIGINT)
        shim_rc = shim.wait(30)
    validate_report(rep)
    check(rep["hung"] == 0 and rep["failed"] == 0 and shim_rc == 0,
          f"loadgen report: {rep}, shim exit {shim_rc}")
    check(counts9["k4"] > 0 and counts9["k4"] % N_LAYERS_SMOL == 0,
          f"loadgen run's launches {counts9}")
    client = rep["client"]
    rows["serve_plane_loadgen"] = dict(
        config=cfg_load.to_dict(), offered=rep["offered"],
        accepted=rep["accepted"], completed=rep["completed"],
        shed=rep["shed"], rejected=rep["rejected"], hung=rep["hung"],
        tokens_total=rep["tokens_total"],
        tokens_per_s=rep["tokens_per_s"], duration_s=rep["duration_s"],
        ttft_ms=client["ttft_ms"], tpot_ms=client["tpot_ms"],
        e2e_ms=client["e2e_ms"], k4_launches=counts9["k4"],
        k1_launches=counts9["k1"])
    say("pool_serve_plane_loadgen", **rows["serve_plane_loadgen"])
    out = nb.run("%dist_serve stop")
    check("🛑 serving stopped:" in out, f"%dist_serve stop: {out}")

    # -- item 10: overload verdicts, the serving tenant's cells -------
    hi, _ = attach("hi", priority=5)
    admin.serve_start(SERVE_SPEC_BF16, tenant="serve-over", max_batch=1,
                      max_len=1024, steps=1, queue_depth=2, inflight=2)
    v0 = admin.serve_submit(prompts[0], 30)
    v1 = admin.serve_submit(prompts[1], 30)
    check(v0["status"] == v1["status"] == "accepted" and v1["queued"],
          f"overload: {v0}, {v1}")
    try:
        admin.serve_submit(prompts[2], 30)
        check(False, "a submit past the tenant's in-flight cap was "
              "accepted")
    except CellSubmitError as e:
        rejected = e.verdict
    hi_rids = [hi.serve_submit(p, 8)["rid"] for p in prompts[3:5]]
    shed = _poll(lambda: (lambda r: r if r.get("status") == "shed"
                          else None)(admin.serve_result(v1["rid"])),
                 "the delivered shed verdict", 60)
    plane_results(hi, hi_rids)
    st = admin.serve_status()
    check(rejected["status"] == "rejected" and shed["done"]
          and st["shed"] >= 1 and st["rejected"] >= 1,
          f"overload verdicts: {rejected}, {shed}, {st}")
    hi.close(detach=True)
    srv_kernel, _ = attach("serve-over")
    try:
        srv_kernel.execute("x = 1")
        check(False, "the serving tenant's cell ran")
    except CellSubmitError as e:
        refused = e.verdict
    check(refused["status"] == "rejected"
          and refused["reason"] == "serving-tenant"
          and "%dist_serve" in refused["error"], f"refusal: {refused}")
    srv_kernel.close(detach=True)
    admin.serve_stop()
    rows["serve_plane_overload"] = dict(
        rejected=rejected["reason"], shed_delivered=True,
        cell_refused=refused["reason"])
    say("pool_serve_plane_overload", **rows["serve_plane_overload"])

    # -- item 11: fp32, stopped mid-decode, recovered -----------------
    cfg32 = smol_135m_config_fp32()
    params32 = init_params(cfg32, 0)
    kw32 = dict(tenant="serve-fp32", max_batch=8, max_len=1024, steps=4)
    admin.serve_start(SERVE_SPEC_FP32, **kw32)
    plane_counts(admin, reset=True)
    rids = [admin.serve_submit(p, PLANE_NEW)["rid"] for p in prompts[:8]]
    mid, n_mid = mid_decode(admin, rids)
    admin.serve_stop()
    t0 = time.perf_counter()
    admin.serve_start(SERVE_SPEC_FP32, **kw32)
    again = plane_results(admin, [r for r in rids
                                  if admin.serve_result(r).get("status")
                                  != "unknown"])
    recover_s = time.perf_counter() - t0
    counts11 = plane_counts(admin)
    st = admin.serve_status()
    streams = journal_streams(run_dir, "serve-fp32", rids)
    check(again and all(again[r]["tokens"] == streams[rids.index(r)]
                        for r in again),
          f"recovered: {sorted(again)} (mid-decode {mid})")
    check(st["replayed"] >= 1 and st["dup_dropped"] == 0
          and counts11["k4"] > 0 and counts11["k4"] % N_LAYERS_SMOL == 0,
          f"recovered plane: {st}, launches {counts11}")
    gaps = near_tie_check("serve_plane_recovered_vs_solo", params32, cfg32,
                          prompts[:8], streams, solo32[:8])
    admin.serve_stop()
    rows["serve_plane_recovered"] = dict(
        requests=len(rids), recovered=len(again), replayed=st["replayed"],
        mid_decode=dict(rid=mid, tokens=n_mid), recover_s=recover_s,
        dup_dropped=st["dup_dropped"], near_tie_gaps=gaps,
        k4_launches=counts11["k4"], k1_launches=counts11["k1"])
    say("pool_serve_plane_recovered", **rows["serve_plane_recovered"])

    # -- item 12: migration to a second pool -------------------------
    b_dir = str(POOL_RUNS / "pool-b")
    t0 = time.perf_counter()
    out = nb.run(f"%dist_pool start -n 1 --backend gpu --run-dir {b_dir}")
    b_start_s = time.perf_counter() - t0
    mb = gw.read_gateway_manifest(b_dir)
    b_pids = [mb["pid"]] + list(session.read_manifest(b_dir)["pids"]
                               .values())
    mover, _ = attach("mover")
    tok, epoch = mover.token, mover.epoch
    mover.serve_start(SERVE_SPEC_FP32, tenant="serve-mig", max_batch=8,
                      max_len=1024, steps=1)
    mrids = [mover.serve_submit(p, PLANE_NEW)["rid"] for p in prompts[8:]]
    mid_decode(mover, mrids)
    mover.serve_stop()                     # the streams are unfinished
    mover.close()
    t0 = time.perf_counter()
    out = nb.run(f"%dist_pool migrate --tenant mover --to {b_dir} --force")
    migrate_s = time.perf_counter() - t0
    check(f"✅ migrated to {b_dir} (epoch" in out
          and "serve journal: yes" in out, f"%dist_pool migrate: {out}")
    check("mover" not in admin.pool_status()["tenants"]["tenants"],
          "the source pool still knows the tenant")
    mbt = TenantClient(mb["tenant_plane"]["host"],
                       mb["tenant_plane"]["port"], "mover",
                       pool_token=mb["pool_token"], token=tok)
    try:
        check(mbt.token == tok and mbt.epoch >= epoch,
              f"reattached at B: epoch {mbt.epoch} (was {epoch})")
        plane_counts(mbt, reset=True)
        t0 = time.perf_counter()
        mbt.serve_start(SERVE_SPEC_FP32, tenant="serve-mig", max_batch=8,
                        max_len=1024)
        adopted = plane_results(mbt, [r for r in mrids
                                      if mbt.serve_result(r).get("status")
                                      != "unknown"])
        finish_s = time.perf_counter() - t0
        counts12 = plane_counts(mbt)
        st = mbt.serve_status()
        mstreams = journal_streams(b_dir, "serve-mig", mrids)
        check(adopted and st["replayed"] >= 1 and st["dup_dropped"] == 0
              and counts12["k4"] > 0
              and counts12["k4"] % N_LAYERS_SMOL == 0,
              f"the adopting plane: {st}, launches {counts12}")
        mgaps = near_tie_check("serve_plane_migrated_vs_solo", params32,
                               cfg32, prompts[8:], mstreams, solo32[8:])
        mbt.serve_stop()
    finally:
        mbt.close(detach=True)
    del params32
    torch.cuda.empty_cache()
    out = nb.run(f"%dist_pool stop --run-dir {b_dir}")
    check(f"🛑 pool {b_dir}: stopping" in out, f"stop B: {out}")
    _poll(lambda: all(_proc_gone(p) for p in b_pids),
          "pool B's daemon and rank", 60, 0.05)
    rows["serve_plane_migrated"] = dict(
        requests=len(mrids), adopted=len(adopted), replayed=st["replayed"],
        dup_dropped=st["dup_dropped"], near_tie_gaps=mgaps,
        b_start_s=b_start_s, migrate_s=migrate_s, finish_s=finish_s,
        epoch_before=epoch, epoch_after=mbt.epoch,
        k4_launches=counts12["k4"], k1_launches=counts12["k1"])
    say("pool_serve_plane_migrated", **rows["serve_plane_migrated"])
    admin.close(detach=True)
    DistributedMagics._tenant = None
    DistributedMagics._pool_info = None
    return rows, b_pids


POOL_SUM_CELL = """\
t = torch.full((4,), float(rank + 1), device=device)
dist.all_reduce(t)
float(t[0])
"""


def pool_mesh_serving(nb, client, run_dir, grow, solo32):
    """Phase 26, item 7's serving half, on the pool of 2 NCCL ranks: an
    fp32 plane decoding on both ranks, decode rank 1 SIGKILLed while it
    holds placed requests (failover to rank 0, re-open, journal
    replay), then a resize to ``grow`` while requests are in flight
    (``pause``, ``resume_after_resize`` and its re-seed); every stream
    held to solo ``generate`` under the near-tie rule."""
    import os
    import signal

    import torch
    from nbdistributed_tpu_torch.models import init_params
    from nbdistributed_tpu_torch.resilience import session

    cfg32 = smol_135m_config_fp32()
    prompts = make_requests(cfg32)
    client.serve_start(SERVE_SPEC_FP32, tenant="serve-mesh", max_batch=8,
                       max_len=1024, steps=1, decode_ranks=2)
    t0 = time.perf_counter()
    rids = [client.serve_submit(p, PLANE_NEW)["rid"] for p in prompts]
    _poll(lambda: ((client.serve_status()["ranks"].get("1") or {})
                   .get("placed", 0) > 0
                   and any(client.serve_result(r).get("tokens")
                           for r in rids)),
          "requests decoding on rank 1", 300, 0.01)
    placed = {r: v["placed"] for r, v in
              client.serve_status()["ranks"].items()}
    os.kill(int(session.read_manifest(run_dir)["pids"]["1"]),
            signal.SIGKILL)
    t_kill = time.perf_counter()
    _poll(lambda: client.serve_status()["failovers"] >= 1,
          "the plane's failover", 120, 0.01)
    failover_s = time.perf_counter() - t_kill
    pending = [r for r in rids if not client.serve_result(r).get("done")]
    check(pending, "every request finished before the resize")
    out = nb.run(f"%dist_pool resize -n {grow} --run-dir {run_dir}")
    check(f"✅ resized: {grow} ranks" in out and "TIMED OUT" not in out,
          f"resize under serving: {out}")
    flip = _resize_numbers(out)
    got = plane_results(client, rids)
    wall = time.perf_counter() - t0
    st = client.serve_status()
    streams = [got[r]["tokens"] for r in rids]
    check(all(got[r]["status"] == "completed" for r in rids)
          and st["failovers"] >= 1 and st["replayed"] >= 1
          and st["dup_dropped"] == 0,
          f"the mesh plane: {st}")
    params32 = init_params(cfg32, 0)
    if solo32 is None:
        solo32 = solo_outputs(params32, cfg32, prompts)
    gaps = near_tie_check("serve_plane_mesh_vs_solo", params32, cfg32,
                          prompts, streams, solo32)
    del params32
    torch.cuda.empty_cache()
    client.serve_stop()
    return dict(requests=len(rids), placed_at_kill=placed,
                failover_s=failover_s, pending_at_resize=len(pending),
                resize=flip, decode_ranks_after=st["decode_ranks"],
                failovers=st["failovers"], replayed=st["replayed"],
                dup_dropped=st["dup_dropped"], near_tie_gaps=gaps,
                wall_s=wall)


def phase_pool_mesh(n=2, grow=MESH_WORLD, solo32=None):
    """Phase 26, item 7, four cards: a pool of ``n`` NCCL ranks resized
    ``n`` → ``grow`` → ``n``, a tenant's all-reduce checked after each
    flip, an all-reduce queued across the first flip delivered as a
    stale verdict (run nowhere), a template replayed on each new fleet,
    and a resize past the cards refused with the pool still answering;
    then the serving plane's failover and resize (``pool_mesh_serving``;
    ``solo32``: phase 5's fp32 solo streams, computed here when
    None)."""
    import shutil
    import threading

    from nbdistributed_tpu_torch.gateway import daemon as gw
    from nbdistributed_tpu_torch.gateway.client import TenantClient
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    ts = time.perf_counter()
    run_dir = str(POOL_RUNS / "mesh")
    shutil.rmtree(run_dir, ignore_errors=True)
    nb = NotebookSession()
    tpl = ROOT / "build" / "pool_template.py"
    tpl.parent.mkdir(exist_ok=True)
    tpl.write_text("shared['warm'] = str(torch.ones(1, device=device)"
                   ".device)\n")
    client = None
    rows: dict = {}

    def summed(world):
        res = client.execute(POOL_SUM_CELL)
        got = {r: d.get("output") for r, d in res["results"].items()}
        want = {str(r): repr(float(world * (world + 1) // 2))
                for r in range(world)}
        check(got == want, f"all_reduce on {world} ranks: {got}")

    def warm(world):
        res = client.execute("shared.get('warm')")
        got = {r: d.get("output") for r, d in res["results"].items()}
        check(got == {str(r): repr(f"cuda:{r}") for r in range(world)},
              f"template on {world} ranks: {got}")

    try:
        t0 = time.perf_counter()
        out = nb.run(f"%dist_pool start -n {n} --backend gpu --mesh-slots 1 "
                     f"--run-dir {run_dir}")
        start_s = time.perf_counter() - t0
        check("✅ pool up" in out, out)
        m = gw.read_gateway_manifest(run_dir)
        client = TenantClient(m["tenant_plane"]["host"],
                              m["tenant_plane"]["port"], "mesh",
                              pool_token=m["pool_token"])
        summed(n)
        out = nb.run(f"%dist_pool template --file {tpl} --name warm "
                     f"--run-dir {run_dir}")
        check(f"✅ template 'warm' ran on ranks {list(range(n))}" in out,
              out)
        warm(n)
        box, positions = {}, []
        # Daemon threads: a failed check must not keep the process
        # waiting for a client call still in flight.
        slow = threading.Thread(target=lambda: box.update(
            slow=client.execute("import time\ntime.sleep(3)\n'slow'")),
            daemon=True)
        slow.start()
        _poll(lambda: client.pool_status()["scheduler"]["active"] == 1,
              "the slow cell")
        queued = threading.Thread(target=lambda: box.update(
            queued=client.execute("shared['queued'] = rank\n"
                                  + POOL_SUM_CELL, on_queued=lambda q:
                                  positions.append(q["position"]))),
            daemon=True)
        queued.start()
        _poll(lambda: positions, "the queued notice")
        flips = []
        for world, epoch in ((grow, 2), (n, 3)):
            out = nb.run(f"%dist_pool resize -n {world} --run-dir {run_dir}")
            check(f"✅ resized: {world} ranks · epoch {epoch} · generation "
                  f"{epoch} · drain" in out and "TIMED OUT" not in out,
                  f"resize to {world}: {out}")
            st = client.pool_status()
            flips.append(dict(to=world, epoch=epoch,
                              **{k: v for k, v in _resize_numbers(out)
                                 .items()}))
            if world == grow:
                slow.join(60)
                queued.join(120)
                # Stamped at submit with epoch 1, as in the JAX
                # package: ranks 0..n-1 of the new fleet refuse it as
                # stale, and nothing of it runs on part of the world.
                got = {r: (d.get("stale_epoch"),
                           d.get("error", "").startswith(
                               "stale coordinator epoch 1 "))
                       for r, d in box["queued"]["results"].items()}
                check(got == {str(r): (True, True) for r in range(n)},
                      f"the cell queued across the flip: {box}")
                res = client.execute("(shared.get('queued'),)")
                check({d.get("output") for d in res["results"].values()}
                      == {"(None,)"}, f"the stale cell ran: {res}")
            check(st["world_size"] == world and st["epoch"] == epoch,
                  f"pool status after the flip: {st['world_size']}, "
                  f"{st['epoch']}")
            summed(world)
            warm(world)
        out = nb.run(f"%dist_pool resize -n {grow + 1} --run-dir {run_dir}",
                     ok=False)
        check(f"❌ a gpu pool runs one rank a GPU and this host has {grow}: "
              f"{grow + 1} ranks refused" in out, f"resize past the cards: "
              f"{out}")
        summed(n)
        serving = pool_mesh_serving(nb, client, run_dir, grow, solo32)
        say("pool_mesh_serving", **serving)
        out = nb.run(f"%dist_pool stop --run-dir {run_dir}")
        check(f"🛑 pool {run_dir}: stopping" in out, out)
        _poll(lambda: gw.read_gateway_manifest(run_dir) is None,
              "the pool's stop", 60)
    finally:
        if client is not None:
            client.close()
        m = gw.read_gateway_manifest(run_dir)
        if m is not None and gw.gateway_alive(m):
            from nbdistributed_tpu_torch.gateway.client import \
                pool_shutdown
            try:
                pool_shutdown("127.0.0.1", m["tenant_plane"]["port"],
                              m["pool_token"])
            except Exception:
                pass
        DistributedMagics.reset_class_state()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"pool_mesh_cells_n{grow}.json").write_text(
            json.dumps(nb.log, indent=1))
    rows = dict(ranks=[n, grow, n, grow], start_to_ready_s=start_s,
                flips=flips, queued_across_flip="stale",
                template_replayed=True, refused=grow + 1, serving=serving,
                seconds=time.perf_counter() - ts)
    say("pool_mesh", **rows)
    return rows


# Phase 27: multi-host launch.  A host agent daemon
# (tools/nbd_torch_agent.py) bound to a second loopback address stands
# in for a second machine, with its own run dir and its own device mask;
# %dist_init --hosts/--agents/--coordinator-addr spawns ranks through it
# over the token-authenticated control plane.  On one card the agent's
# rank serves phase 17's requests and takes phase 11's first two
# training steps, is SIGKILLed under the agent and healed through it;
# on four cards (--mesh-nccl) a two-host NCCL world rides out a seeded
# control-plane partition of the far host and heals a SIGKILL under its
# agent.

MH_COORD = "127.0.1.10"
MH_AGENT = "127.0.1.12"
MH_RUNS = ROOT / "build" / "multihost_runs"
MH_RT_CELLS = 10
MH_TRAIN_STEPS = 2
MH_PARTITION_S = 12.0
MH_GRACE_S = "60"
# Both "hosts" are this machine: the process group's bootstrap sockets
# stay on the loopback (a real second host takes the backends' own
# interface choice, or NCCL_SOCKET_IFNAME).
MH_IFNAMES = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}

MH_ALL_REDUCE_CELL = """\
x = torch.tensor([rank + 1.0], device=device)
dist.all_reduce(x)
summed = [float(x), dist.get_backend(), str(device)]
"""

MH_INFLIGHT_CELL = ("import time as _t\n_t.sleep(6.0)\n"
                    "inflight = rank * 100 + 7\ninflight")


def multihost_refs():
    """Phase 27's references computed in this process on card 0, where
    phases 5 and 11 have not run: the bf16 server's streams of phase
    17's requests and phase 11's first two losses."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config()
    outputs = serve(init_params(cfg, 0), cfg, make_requests(cfg))[0]
    tcfg = smol_135m_config(remat=True)
    params = init_params(tcfg, 0)
    batch = packed_batch(tcfg, TRAIN_B, tcfg.max_seq_len, TRAIN_BATCH_SEED)
    step = make_train_step(tcfg, AdamW(param_leaves(params), lr=1e-3))
    losses = [float(step(params, batch)) for _ in range(MH_TRAIN_STEPS)]
    del params, batch, step
    torch.cuda.empty_cache()
    return outputs, losses


def _addr_bindable(addr):
    import socket
    try:
        with socket.socket() as s:
            s.bind((addr, 0))
        return True
    except OSError:
        return False


def start_agent(label, run_dir, token, mask=None):
    """Start ``tools/nbd_torch_agent.py`` on ``MH_AGENT`` as a daemon
    with its own run dir; returns (process, port, seconds to ready)."""
    import os
    import shutil
    shutil.rmtree(run_dir, ignore_errors=True)
    env = {**os.environ, **MH_IFNAMES, "NBD_AGENT_TOKEN": token}
    env.pop("NBD_RUN_DIR", None)
    if mask is not None:
        env["CUDA_VISIBLE_DEVICES"] = mask
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "nbd_torch_agent.py"),
         "--bind", MH_AGENT, "--token-env", "NBD_AGENT_TOKEN",
         "--host-label", label, "--run-dir", str(run_dir)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    ready_s = time.perf_counter() - t0
    if not line.startswith("NBD_AGENT_READY "):
        proc.kill()
        raise SmokeFailure(f"agent {label}: {line!r} {proc.stdout.read()}")
    ready = dict(kv.split("=", 1) for kv in line.split()[1:])
    check(ready["label"] == label and ready["run_dir"] == str(run_dir)
          and ready["host"] == MH_AGENT, f"agent ready line {line!r}")
    return proc, int(ready["port"]), ready_s


def stop_agent(proc):
    proc.terminate()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def live_children(pid):
    """Live (not zombie) processes whose parent is ``pid``."""
    import os
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            kids.append(int(entry))
    return kids


def agent_ping(port, token):
    from nbdistributed_tpu_torch.manager.hostagent import AgentClient
    client = AgentClient(MH_AGENT, port, auth_token=token)
    try:
        return client.request("ping", {}).data
    finally:
        client.close()


def _mh_env(extra):
    """Set ``extra`` (plus the loopback interfaces) in this process's
    env; returns what to restore."""
    import os
    keys = {**MH_IFNAMES, **extra}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    return saved


def _restore_env(saved):
    import os
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _trivial_cells(nb, n):
    import statistics
    rt = []
    for _ in range(n):
        t0 = time.perf_counter()
        nb.run("%%distributed\n1")
        rt.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(rt)


def phase_multihost(outputs_ref, losses_ref):
    """Phase 27, one card: a rank spawned by a host agent at
    ``MH_AGENT``, reached over a token-authenticated control plane bound
    on all interfaces and dialled at ``MH_COORD``.  ``outputs_ref``:
    phase 17's streams; ``losses_ref``: phase 11's losses (the first
    two are held).  Its host-clock rows are taken beside phase 29's
    process, so they are not set against phase 17's local spawn."""
    import os
    import secrets
    import signal

    import torch
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.manager.hostagent import _AgentWorker

    ts = time.perf_counter()
    check(_addr_bindable(MH_COORD) and _addr_bindable(MH_AGENT),
          f"cannot bind {MH_COORD} and {MH_AGENT}: phase 27 needs two "
          "loopback addresses")
    token = secrets.token_hex(16)
    saved = _mh_env({"NBD_AGENT_TOKEN": token})
    agent, port, agent_ready_s = start_agent(MH_AGENT, MH_RUNS / "agent",
                                             token)
    nb = NotebookSession()
    try:
        line = (f"--hosts {MH_AGENT} --agents {MH_AGENT}={MH_AGENT}:{port}"
                f" --coordinator-addr {MH_COORD} --backend gpu -t 600")
        t0 = time.perf_counter()
        out = nb.run(f"%dist_init {line}")
        ready_s = time.perf_counter() - t0
        check("1 workers ready (backend=gpu" in out
              and "NBD_AGENT_TOKEN is not set" not in out, out)
        pm, comm = DistributedMagics._pm, DistributedMagics._comm
        check(isinstance(pm.processes[0], _AgentWorker)
              and pm.hosts == {0: MH_AGENT} and pm.gpus == {0: 0}
              and comm.auth_token and comm._listener.host == "0.0.0.0",
              f"world: hosts {pm.hosts}, gpus {pm.gpus}, "
              f"bound {comm._listener.host}")
        client = pm._agents[MH_AGENT]
        pid0 = pm.processes[0].pid
        check(live_children(agent.pid) == [pid0],
              f"the rank is not the agent's child: "
              f"{live_children(agent.pid)} vs {pid0}")
        out = nb.run("%dist_status")
        check(f"· cuda:0 ({torch.cuda.get_device_name(0)}) · " in out
              and "· 1 ranks on nccl · " in out, f"%dist_status: {out}")

        nb.run(MH_ALL_REDUCE_CELL)
        summed = nb.pull("summed")
        check(summed == {0: [1.0, "nccl", "cuda:0"]},
              f"all_reduce on the agent's rank: {summed}")

        # Phase 17's cell: the full-width forward (K1 once a layer) and
        # the 12 requests (K4 once a layer a decode step).
        nb.run(CLUSTER_SERVE_CELL.lstrip("\n"))
        served = nb.pull("served")[0]
        steps = served["steps"]
        check(served["rebuilt"] == [], f"rebuilt {served['rebuilt']}")
        check(served["logits_finite"] and served["logits_shape"]
              == [1, 512, 49152], "the agent's rank's forward: bad logits")
        check(served["k1"] == N_LAYERS_SMOL and steps > 0
              and served["k4"] == N_LAYERS_SMOL * steps,
              f"K1 {served['k1']}, K4 {served['k4']} over {steps} decode "
              "steps")
        check(served["outputs"] == outputs_ref, "the agent's rank's "
              "streams differ from phase 17's")
        n_tok = sum(len(o) for o in outputs_ref)
        serve_row = dict(k1_launches=served["k1"],
                         k4_launches=served["k4"], decode_steps=steps,
                         tokens=n_tok, tokens_per_s=n_tok / served["wall_s"],
                         tokens_equal=True)

        nb.run("del params, logits\ntorch.cuda.empty_cache()")
        nb.run(POOL_TRAIN_SETUP_CELL)
        for _ in range(MH_TRAIN_STEPS):
            nb.run(POOL_TRAIN_STEP_CELL)
        trained = nb.pull("alice")[0]
        want = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
                "k3": N_LAYERS_SMOL}
        check(trained["rebuilt"] == []
              and trained["device"] == "cuda:0"
              and all({k: c[k] for k in want} == want
                      for c in trained["launches"]),
              f"train steps launched {trained['launches']}")
        check(trained["losses"] == list(losses_ref[:MH_TRAIN_STEPS]),
              f"losses {trained['losses']} != phase 11's "
              f"{losses_ref[:MH_TRAIN_STEPS]}")
        train_row = dict(losses=trained["losses"], bitwise=True,
                         launches_per_step={k: trained["launches"][0][k]
                                            for k in want})
        cell_ms = _trivial_cells(nb, MH_RT_CELLS)

        # SIGKILL under the agent: the death arrives as the agent's
        # pushed worker_exit (the link up, no poll sent).
        t_kill = time.perf_counter()
        os.kill(pid0, signal.SIGKILL)
        _poll(lambda: pm.processes[0].poll() is not None,
              "the pushed exit", timeout=30, every=0.005)
        exit_s = time.perf_counter() - t_kill
        check(pm.processes[0].poll() == -signal.SIGKILL
              and client.link_up and client.reconnects == 0,
              f"exit {pm.processes[0].poll()}, link up {client.link_up}, "
              f"reconnects {client.reconnects}")
        _poll(lambda: 0 in comm._dead, "rank 0 marked dead", timeout=30)
        out = nb.run("%dist_heal", ok=False)
        healed_s = time.perf_counter() - t_kill
        # A world of one whose rank died is "down" to %dist_heal.
        check("❌" not in out and "🩹 healing: dead ranks" in out
              and f"rebuilding with: %dist_init {line}" in out
              and "1 workers ready (backend=gpu" in out, out)
        pm2 = DistributedMagics._pm
        pid1 = pm2.processes[0].pid
        check(pm2 is not pm and isinstance(pm2.processes[0], _AgentWorker)
              and pid1 != pid0 and live_children(agent.pid) == [pid1],
              f"healed world: {pm2.processes}, agent children "
              f"{live_children(agent.pid)}")
        nb.run(POOL_TRAIN_SETUP_CELL)
        nb.run(POOL_TRAIN_STEP_CELL)
        redone = nb.pull("alice")[0]
        redone_s = time.perf_counter() - t_kill
        check(redone["losses"] == [losses_ref[0]]
              and {k: redone["launches"][0][k] for k in want} == want,
              f"the step redone after the heal: {redone}")
        train_row["redone_loss"] = redone["losses"][0]
        train_row["redone_launches"] = {k: redone["launches"][0][k]
                                        for k in want}

        out = nb.run("%dist_shutdown")
        check("✅ shut down 1 workers" in out, out)
        _poll(lambda: not live_children(agent.pid),
              "no child left under the agent", timeout=30)
        ping = agent_ping(port, token)
    finally:
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        stop_agent(agent)
        _restore_env(saved)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "multihost_cells_n1.json").write_text(
            json.dumps(nb.log, indent=1))
    row = dict(card=gpu_name_and_power(), agent_ready_s=agent_ready_s,
               spawn_to_ready_s=ready_s, beside="phase 29",
               cell_ms_median=cell_ms, serve=serve_row, train=train_row,
               kill_to_pushed_exit_s=exit_s, kill_to_world_ready_s=healed_s,
               kill_to_step_redone_s=redone_s,
               agent_children_after_shutdown=0,
               agent_ping_after_shutdown=ping,
               seconds=time.perf_counter() - ts)
    say("multihost", **row)
    return row


def phase_multihost_mesh(n_local=2, n_far=2):
    """Phase 27 on four cards: ``--hosts local:2,hostB:2``, hostB's
    agent owning cards 2 and 3 (``CUDA_VISIBLE_DEVICES=2,3``), the local
    ranks cards 0 and 1; a 4-rank NCCL all-reduce; a seeded
    control-plane partition of hostB for ``MH_PARTITION_S`` mid-cell
    under a supervisor whose grace is longer: hostB suspected and not
    healed, the far ranks reattach and the in-flight result is drained
    exactly once; then a SIGKILL under hostB's agent, healed through
    it by the supervisor."""
    import os
    import secrets
    import signal
    import threading

    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.manager.hostagent import _AgentWorker
    from nbdistributed_tpu_torch.resilience import session

    ts = time.perf_counter()
    world = n_local + n_far
    far = list(range(n_local, world))
    check(_addr_bindable(MH_COORD) and _addr_bindable(MH_AGENT),
          f"cannot bind {MH_COORD} and {MH_AGENT}")
    token = secrets.token_hex(16)
    saved = _mh_env({"NBD_AGENT_TOKEN": token,
                     "NBD_PARTITION_GRACE_S": MH_GRACE_S, "NBD_HANG": "0"})
    mask = ",".join(str(n_local + i) for i in range(n_far))
    agent, port, agent_ready_s = start_agent("hostB", MH_RUNS / "hostB",
                                             token, mask=mask)
    nb = NotebookSession()
    try:
        line = (f"--hosts local:{n_local},hostB:{n_far} --agents "
                f"hostB={MH_AGENT}:{port} --coordinator-addr {MH_COORD} "
                f"--backend gpu -t 600")
        t0 = time.perf_counter()
        out = nb.run(f"%dist_init {line}")
        ready_s = time.perf_counter() - t0
        check(f"{world} workers ready (backend=gpu" in out, out)
        pm, comm = DistributedMagics._pm, DistributedMagics._comm
        check(pm.hosts == {**{r: "local" for r in range(n_local)},
                           **{r: "hostB" for r in far}}
              and pm.gpus == {r: r % n_local if r < n_local
                              else r - n_local for r in range(world)},
              f"hosts {pm.hosts}, gpus {pm.gpus}")
        out = nb.run("%dist_status")
        heads = [l.split(" · ")[0] for l in out.splitlines()
                 if l.startswith("┌ host")]
        check(heads == ["┌ host hostB", "┌ host local"], out)
        nb.run(MH_ALL_REDUCE_CELL + "import torch as _torch\n"
               "card = str(_torch.cuda.get_device_properties(device)"
               ".uuid)\n")
        sums, cards = nb.pull("summed"), nb.pull("card")
        check({r: s[0] for r, s in sums.items()}
              == {r: float(world * (world + 1) // 2) for r in range(world)}
              and all(s[1] == "nccl" for s in sums.values())
              and len(set(cards.values())) == world,
              f"all_reduce {sums}, cards {cards}")

        out = nb.run("%dist_supervise on --degraded-after 3")
        sup = DistributedMagics._supervisor
        check(sup is not None and sup.status()["heals_done"] == 0, out)
        out = nb.run(f"%dist_chaos on --seed 7 --partition local,hostB "
                     f"--partition-after 2 --partition-for "
                     f"{MH_PARTITION_S:g}")
        box = {}

        def dispatch():
            try:
                comm.send_to_all("execute", MH_INFLIGHT_CELL, timeout=60)
            except Exception as e:
                box["err"] = e

        th = threading.Thread(target=dispatch, daemon=True)
        t_cell = time.perf_counter()
        th.start()
        th.join(90)
        check(not th.is_alive() and "err" in box,
              "the partition never aborted the in-flight cell")
        _poll(lambda: "hostB" in sup.status()["suspected_hosts"],
              "hostB suspected", timeout=30)
        suspected_s = time.perf_counter() - t_cell
        check(sup.status()["heals_done"] == 0, "healed in the grace")
        _poll(lambda: sorted(comm.connected_ranks()) == list(range(world)),
              "the far ranks to reattach", timeout=90)
        reattached_s = time.perf_counter() - t_cell
        _poll(lambda: not sup.status()["suspected_hosts"],
              "the suspicion to clear", timeout=30)
        check(sup.status()["heals_done"] == 0, "healed after the link")
        drained = session.drain_mailboxes(comm, timeout=30)
        got = {r: [v.get("output", "").strip() for v in d.values()]
               for r, d in drained.items() if d}
        check(got == {r: [str(r * 100 + 7)] for r in far},
              f"in-flight results drained: {drained}")
        again = session.drain_mailboxes(comm, timeout=30)
        check(not any(again.values()), f"drained twice: {again}")
        check(nb.pull("inflight") == {r: r * 100 + 7
                                      for r in range(world)},
              "the in-flight cell ran other than once")
        nb.run("%dist_chaos off")

        # SIGKILL under hostB's agent; the supervisor heals through it.
        victim = far[-1]
        old_pid = pm.processes[victim].pid
        check(old_pid in live_children(agent.pid), "victim not the agent's")
        t_kill = time.perf_counter()
        os.kill(old_pid, signal.SIGKILL)
        _poll(lambda: pm.processes[victim].poll() is not None,
              "the pushed exit", timeout=30, every=0.005)
        exit_s = time.perf_counter() - t_kill
        _poll(lambda: sup.status()["heals_done"] >= 1
              and DistributedMagics._pm is not pm
              and DistributedMagics._comm is not None
              and len(DistributedMagics._comm.connected_ranks()) == world
              and not DistributedMagics._healing,
              "the supervised heal", timeout=180)
        healed_s = time.perf_counter() - t_kill
        pm2 = DistributedMagics._pm
        check(isinstance(pm2.processes[victim], _AgentWorker)
              and pm2.processes[victim].pid != old_pid
              and sorted(live_children(agent.pid))
              == sorted(pm2.processes[r].pid for r in far),
              "the heal did not respawn through the agent")
        nb.run(MH_ALL_REDUCE_CELL)
        sums = nb.pull("summed")
        check({r: s[0] for r, s in sums.items()}
              == {r: float(world * (world + 1) // 2) for r in range(world)},
              f"all_reduce after the heal: {sums}")
        nb.run("%dist_supervise off")
        out = nb.run("%dist_shutdown")
        check(f"✅ shut down {world} workers" in out, out)
        _poll(lambda: not live_children(agent.pid),
              "no child left under the agent", timeout=30)
    finally:
        if DistributedMagics._pm is not None:
            DistributedMagics.shutdown_all()
        stop_agent(agent)
        _restore_env(saved)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"multihost_mesh_cells_n{world}.json").write_text(
            json.dumps(nb.log, indent=1))
    row = dict(card=gpu_name_and_power(), ranks=world,
               hosts={"local": n_local, "hostB": n_far},
               agent_ready_s=agent_ready_s, spawn_to_ready_s=ready_s,
               partition_s=MH_PARTITION_S, grace_s=float(MH_GRACE_S),
               suspected_s=suspected_s, reattached_s=reattached_s,
               heals_in_partition=0, drained_once=True,
               kill_to_pushed_exit_s=exit_s, kill_to_healed_s=healed_s,
               seconds=time.perf_counter() - ts)
    say("multihost_mesh", **row)
    return row


def _resize_numbers(out):
    """The drain and total seconds ``%dist_pool resize`` printed."""
    import re
    m = re.search(r"drain ([0-9.]+)s.* · total ([0-9.]+)s", out)
    check(m is not None, f"resize output: {out}")
    return dict(drain_s=float(m.group(1)), wall_s=float(m.group(2)))


def smol_135m_config_fp32():
    import torch
    from nbdistributed_tpu_torch.models import smol_135m_config
    return smol_135m_config(dtype=torch.float32)


def hf_layout(params, cfg):
    """The port's parameters as a ``transformers`` state dict (Llama or
    Mixtral naming; torch ``nn.Linear`` weights are (out, in), so every
    projection is the transpose) and a config stand-in."""
    from types import SimpleNamespace

    L = params["layers"]
    sd = {"model.embed_tokens.weight": params["embed"],
          "lm_head.weight": params["lm_head"].T,
          "model.norm.weight": params["final_norm"]}
    conf = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
                num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads,
                num_key_value_heads=cfg.n_kv_heads,
                intermediate_size=cfg.d_ff,
                max_position_embeddings=cfg.max_seq_len,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                sliding_window=cfg.sliding_window)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = L["attn_norm"][i]
        sd[p + "post_attention_layernorm.weight"] = L["mlp_norm"][i]
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            sd[p + f"self_attn.{theirs}.weight"] = L[ours][i].T
        if "moe" in L:
            moe = L["moe"]
            sd[p + "block_sparse_moe.gate.weight"] = moe["router"][i].T
            for e in range(cfg.n_experts):
                for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                                     ("w_down", "w2")):
                    sd[p + f"block_sparse_moe.experts.{e}.{theirs}"
                           ".weight"] = moe[ours][i, e].T
        else:
            for ours, theirs in (("w_gate", "gate_proj"),
                                 ("w_up", "up_proj"),
                                 ("w_down", "down_proj")):
                sd[p + f"mlp.{theirs}.weight"] = L[ours][i].T
    if "moe" in L:
        conf.update(num_local_experts=cfg.n_experts,
                    num_experts_per_tok=cfg.top_k,
                    router_aux_loss_coef=cfg.lb_coef)
    return SimpleNamespace(config=SimpleNamespace(**conf),
                           state_dict=lambda: sd)


def _trees_equal(a, b):
    import torch
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a, b)))


# ----------------------------------------------------------------------
# phase 28: the self-lint, the self-test and the quickstart notebook.
# The lint is host Python: main() starts it before the kernels' build
# and this phase collects it.  The self-test runs as a user runs it, on
# one card and so one NCCL rank, beside the quickstart (its own world,
# its own rank on the same card).  The quickstart's code cells run in
# order through NotebookSession, the launch counts reset on the ranks
# just before each cell and read through %dist_pull just after.

LINT_PASSES = ("env-knobs", "codec-headers", "thread-shared-state",
               "protocol-coverage", "lock-order", "blocking-under-lock",
               "callback-under-lock", "resource-leak",
               "bracket-discipline", "shutdown-completeness")
SELFTEST_MIN_CHECKS = 15
SELFTEST_TIMEOUT_S = 420
QUICKSTART = ROOT / "examples" / "00_torch_quickstart.ipynb"
QS_LAYERS = 2       # tiny_config()'s layers
QS_STEPS = 5        # the training cell's DDP steps
QS_NEW = 8          # generate's new tokens: the prefill's, then 7 steps
QS_SERVE_NEW = 6    # the serving cell's new tokens a request
# What a cell holding the marker must print (its asserts passed).
QS_OUTPUTS = (("eval after restore", "(exact)"),
              ("bit-identical to solo generate", "solo generate:"),
              ("%dist_checkpoint --status", ": done"),
              ("HF and converted tokens match", "tokens match:"))

QS_RESET_CELL = """\
%%distributed
import nbdistributed_tpu_torch.ops.attention as _qs_a
import nbdistributed_tpu_torch.ops.decode as _qs_d
_qs_a.flash_attention.launches = 0
_qs_a.flash_attention_bwd_dq.launches = 0
_qs_a.flash_attention_bwd_dkv.launches = 0
_qs_d.flash_decode_attention.launches = 0
"""

QS_READ_CELL = """\
%%distributed
_qs_counts = {"k1": _qs_a.flash_attention.launches,
              "k2": _qs_a.flash_attention_bwd_dq.launches,
              "k3": _qs_a.flash_attention_bwd_dkv.launches,
              "k4": _qs_d.flash_decode_attention.launches}
"""


def _stopped_at_exit(proc):
    """``proc``, killed when this script exits before collecting it."""
    import atexit

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    atexit.register(stop)
    return proc


def start_self_lint():
    """``tools/nbd_torch_lint.py --self --format json`` over this
    checkout, started in the background (phase 28 collects it):
    (process, start time)."""
    return _stopped_at_exit(subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "nbd_torch_lint.py"),
         "--self", "--format", "json", "--root", str(ROOT)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)), time.perf_counter()


def self_lint_row(lint):
    """Collect :func:`start_self_lint`: all ten passes clean."""
    proc, t0 = lint
    out, err = proc.communicate(timeout=600)
    doc = json.loads(out) if out.strip().startswith("{") else {}
    passes = doc.get("passes", {})
    row = dict(rc=proc.returncode, total=doc.get("total"),
               passes={k: len(v) for k, v in passes.items()},
               seconds_since_start=time.perf_counter() - t0)
    say("self_lint", **row)
    check(proc.returncode == 0 and doc.get("total") == 0
          and tuple(passes) == LINT_PASSES
          and not any(passes.values()),
          f"self-lint: rc {proc.returncode}, {out[-3000:]} {err[-2000:]}")
    return row


def start_selftest(n=None):
    """``python3 -m nbdistributed_tpu_torch.selftest`` from the checkout's
    root with ``NBD_SELFTEST_FAULTS=1 NBD_SELFTEST_OBS=1`` (and ``-n
    n``), started in the background: (process, start time, n)."""
    import os
    env = {**os.environ, "NBD_SELFTEST_FAULTS": "1",
           "NBD_SELFTEST_OBS": "1"}
    env.pop("NBD_RUN_DIR", None)
    argv = [sys.executable, "-m", "nbdistributed_tpu_torch.selftest"]
    if n is not None:
        argv += ["-n", str(n)]
        env["NBD_SELFTEST_SERVE"] = "1"
    return _stopped_at_exit(subprocess.Popen(
        argv, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)), time.perf_counter(), n


def selftest_row(run):
    """Collect :func:`start_selftest`: exit 0, "N/N checks passed" with
    N at least ``SELFTEST_MIN_CHECKS``, the model-stack check passed
    with K1 launched once on the card within the check's limit."""
    import re
    proc, t0, n = run
    try:
        out, _ = proc.communicate(timeout=SELFTEST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=60)
        raise SmokeFailure(f"self-test timed out:\n{out[-4000:]}")
    seconds = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"selftest_n{n or 1}.txt").write_text(out)
    m = re.search(r"(\d+)/(\d+) checks passed", out)
    k1 = re.search(r"K1 flash_attention fp32 \(1, 96, 4, 32\) on (\w+): "
                   r"max abs error (\S+) \(limit (\S+)\), launches (\d+)",
                   out)
    row = dict(rc=proc.returncode, passed=int(m.group(1)) if m else None,
               checks=int(m.group(2)) if m else None,
               k1_device=k1.group(1) if k1 else None,
               k1_max_abs_err=float(k1.group(2)) if k1 else None,
               k1_limit=float(k1.group(3)) if k1 else None,
               k1_launches=int(k1.group(4)) if k1 else None,
               seconds=seconds,
               banner=out.splitlines()[0] if out else "")
    say("selftest" if n is None else f"selftest_n{n}", **row)
    # With -n the serving smoke's gate is set too: one check more.
    least = SELFTEST_MIN_CHECKS + (n is not None)
    check(proc.returncode == 0 and m and m.group(1) == m.group(2)
          and int(m.group(2)) >= least,
          f"self-test failed:\n{out[-4000:]}")
    check("  ✅ model stack (flash kernel exact, int8 sampled decode)"
          in out and k1 and k1.group(1) == "cuda"
          and int(k1.group(4)) == 1 and float(k1.group(2)) < 2e-5,
          f"self-test K1 guard: {k1 and k1.group(0)}")
    return row


def quickstart_want(src):
    """The launches a quickstart cell makes on a CUDA rank (K1, K2, K3,
    K4) and the path they belong to: K1/K2/K3 once a layer a step
    (``tiny_config`` has no remat, so K1 once), K4 once a layer a
    decode step."""
    L = QS_LAYERS
    zero = dict(k1=0, k2=0, k3=0, k4=0)
    if src.startswith("for step in range(%d):" % QS_STEPS):
        return "quickstart_train", dict(zero, k1=QS_STEPS * L,
                                        k2=QS_STEPS * L, k3=QS_STEPS * L)
    if "trained a step during the save" in src:
        return "quickstart_train", dict(zero, k1=L, k2=L, k3=L)
    if "eval_loss = float(loss_fn(" in src \
            or "restored_loss = float(loss_fn(" in src:
        return "quickstart_train", dict(zero, k1=L)   # forward only
    if "out_tokens = generate(" in src:
        return "quickstart_generate", dict(zero, k4=(QS_NEW - 1) * L)
    if "q8, q4 = quantize_params(" in src:          # two trees
        return "quickstart_generate", dict(zero,
                                           k4=2 * (QS_NEW - 1) * L)
    if "srv.cache_prefix(" in src:
        # Each admission's prefill (the suffix padded to pad_to) is the
        # plain cached attention; the pair then decodes its other
        # QS_SERVE_NEW - 1 tokens in as many shared steps, and solo
        # generate takes QS_SERVE_NEW - 1 steps.
        return "quickstart_serve", dict(
            zero, k4=2 * (QS_SERVE_NEW - 1) * L)
    # The HF cell's model runs with use_flash=False: no kernel.
    return None, zero


def _expand(text, ns):
    """A line magic's ``{name}`` fields filled from the kernel
    namespace, as IPython expands them."""
    if text.startswith("%") and not text.startswith("%%"):
        return text.format(**ns)
    return text


def notebook_cells(path):
    """A notebook's code cells, in order, read with ``json``."""
    nb = json.loads(path.read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def run_counted_notebook(path, n, want_of, before=None):
    """Every code cell of the notebook at ``path`` through
    :class:`NotebookSession` (the caller sets its ``NBD_NOTEBOOK_*``
    knobs; its ``%dist_init`` must bring up ``n`` GPU ranks), each
    cell's K1-K4 launches reset before it and read after it on every
    rank and held to ``want_of(src) -> (path, counts)`` (zero on the
    ranks a ``%%rank [0]`` cell skips).  ``before(nb, src)`` runs before
    each cell.  Returns (cell, output) for every code cell and rank 0's
    launches summed by path."""
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    nb, outs, launches = None, [], {}
    try:
        for src in notebook_cells(path):
            first = src.splitlines()[0]
            if first == "%load_ext nbdistributed_tpu_torch":
                nb = NotebookSession()       # %load_ext's own steps
                outs.append((src, ""))
                continue
            if before is not None:
                before(nb, src)
            live = DistributedMagics._comm is not None
            if live and first != "%dist_shutdown":
                nb.run(QS_RESET_CELL)
            out = nb.run(_expand(src, nb.shell.user_ns))
            outs.append((src, out))
            if first.startswith("%dist_init"):
                check(f"✅ {n} workers ready (backend=gpu" in out,
                      f"{path.name} %dist_init: {out}")
            if not live or first == "%dist_shutdown":
                continue
            nb.run(QS_READ_CELL)
            got = nb.pull("_qs_counts")
            name, want = want_of(src)
            ranks = [0] if first.startswith("%%rank [0]") else range(n)
            for r in range(n):
                w = want if r in ranks else dict.fromkeys(want, 0)
                check(got[r] == w, f"{path.name} cell {first!r}: rank {r} "
                      f"launched {got[r]}, want {w}")
            if name is not None:
                acc = launches.setdefault(name, dict.fromkeys(want, 0))
                for k in acc:
                    acc[k] += got[0][k]
        check(DistributedMagics._comm is None, "the world outlived "
              "%dist_shutdown")
    finally:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"{path.stem}_cells_n{n}.json").write_text(json.dumps(
            nb.log if nb is not None else [], indent=1))
        if DistributedMagics._comm is not None:
            DistributedMagics.shutdown_all()
    return outs, launches


def phase_quickstart(outputs_ref, n=1):
    """Every code cell of the quickstart through :class:`NotebookSession`
    with ``%dist_init -n n --backend gpu``, the counts held per cell;
    before its ``%dist_shutdown`` the same world serves phase 17's
    requests and runs ``%dist_lint self``."""
    import os
    import shutil
    import tempfile

    env_before = {k: os.environ.get(k) for k in
                  ("NBD_NOTEBOOK_BACKEND", "NBD_NOTEBOOK_WORKERS")}
    os.environ.update(NBD_NOTEBOOK_BACKEND="gpu",
                      NBD_NOTEBOOK_WORKERS=str(n))
    ts = time.perf_counter()
    extras = {}

    def before(nb, src):
        if src == "%dist_shutdown":
            extras.update(quickstart_extras(nb, outputs_ref, n))

    try:
        outs, launches = run_counted_notebook(QUICKSTART, n,
                                              quickstart_want, before)
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # The notebook's checkpoints, under the temporary directory.
        ckpt = os.path.join(tempfile.gettempdir(), "nbd_torch_demo_ckpt")
        for d in (ckpt, ckpt + "_bg"):
            shutil.rmtree(d, ignore_errors=True)
    for src, out in outs:
        for marker, needle in QS_OUTPUTS:
            if marker in src:
                check(needle in out, f"quickstart cell "
                      f"{src.splitlines()[0]!r}: {needle!r} not in {out}")
    row = dict(cells=len(outs), launches=launches, **extras,
               seconds=time.perf_counter() - ts)
    say("quickstart", **row)
    return row


def quickstart_extras(nb, outputs_ref, n):
    """Before the quickstart's ``%dist_shutdown``: phase 17's full-width
    SmolLM2-135M serving cell (the 12 bf16 requests, K4 once a layer a
    decode step, streams equal to phase 17's) and ``%dist_lint self``,
    clean."""
    t0 = time.perf_counter()
    nb.run(NOTEBOOK_SERVE_CELL)
    served, outputs = nb.pull("served"), nb.pull("outputs")
    for r in range(n):
        s = served[r]
        check(s["rebuilt"] == [] and s["device"] == f"cuda:{r}",
              f"quickstart smol: rank {r}: rebuilt {s['rebuilt']}, on "
              f"{s['device']}")
        check(s["steps"] > 0 and s["k4"] == N_LAYERS_SMOL * s["steps"],
              f"quickstart smol: rank {r}: K4 launched {s['k4']} times "
              f"over {s['steps']} decode steps")
        check(outputs[r] == outputs_ref, f"quickstart smol: rank {r}'s "
              "streams differ from phase 17's")
    nb.run("%%distributed\ndel params, outputs, served\n"
           "torch.cuda.empty_cache()")
    smol_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = nb.run("%dist_lint self")
    lint_s = time.perf_counter() - t0
    check(all(f"   · {name}: clean" in out for name in LINT_PASSES)
          and "all passes clean ✅" in out, f"%dist_lint self: {out}")
    n_tok = sum(len(o) for o in outputs_ref)
    return dict(smol_serve=dict(k4_launches=served[0]["k4"],
                                k1_launches=served[0]["k1"],
                                decode_steps=served[0]["steps"],
                                want_k4=N_LAYERS_SMOL * served[0]["steps"],
                                tokens=n_tok,
                                tokens_per_s=n_tok / served[0]["wall_s"],
                                tokens_equal=True, cell_s=smol_s),
                dist_lint_self=dict(clean=True, seconds=lint_s))


def phase_selfcheck(lint, outputs_ref):
    """Phase 28: the self-lint collected, the self-test beside the
    quickstart's cells (both beside phase 29's process on one card)."""
    ts = time.perf_counter()
    run = start_selftest()
    try:
        quickstart = phase_quickstart(outputs_ref)
    except BaseException:
        run[0].kill()
        run[0].wait(timeout=60)
        raise
    rows = dict(self_lint=self_lint_row(lint), selftest=selftest_row(run),
                quickstart=quickstart, seconds=time.perf_counter() - ts,
                beside="phase 29")
    say("selfcheck_seconds", seconds=rows["seconds"])
    return rows


def phase_selftest_mesh():
    """``--mesh-nccl``'s part of phase 28: the self-test with ``-n 2
    --backend gpu`` and all three gates on cards 0 and 1, its serving
    smoke's rank SIGKILLed on NCCL."""
    from nbdistributed_tpu_torch.ops import _build
    _build.build_all()
    return selftest_row(start_selftest(n=2))


# ----------------------------------------------------------------------
# Phase 29: the parallelism and fine-tune notebooks.  One card: every
# cell of the fine-tune notebook at SmolLM2-135M's full width and depth
# on one NCCL rank, in a process of its own beside phases 27 and 28 (its
# world, then its references on the card); each cell's launches are reset
# before it and read after it on every rank.  Four cards
# (``--mesh-nccl``): the fine-tune on two ranks, held to an in-process
# emulation of them, and the parallelism tour on four.  The tour is not
# run on one card: there its ranks could only be gloo CPU ranks.

FINETUNE = ROOT / "examples" / "02_torch_finetune.ipynb"
PARALLELISM = ROOT / "examples" / "01_torch_parallelism.ipynb"
FT_RUNS = ROOT / "build" / "finetune_runs"
FT_STEPS = 4            # the training cell's DDP steps
FT_NEW = 16             # the generation cell's new tokens
FT_PROMPT = "The reference "
FT_B = 2                # the notebook's per-rank batch
FT_LR = 3e-4
FT_LOSS_RTOL = 1e-4     # section 2 of PERF.md: fp32 training, kernels vs plain
FT_MESH_LOSS_RTOL = 1e-5    # section 2 of PERF.md: training on a mesh
FT_TIMEOUT_S = 600
# Run on the ranks just before the training loop: the batches the loop
# draws, recorded as they are drawn.
FT_RECORD_CELL = """\
%%distributed
_ft_drawn = []
_ft_iterator = batch_iterator
def batch_iterator(*args, **kw):
    for b in _ft_iterator(*args, **kw):
        _ft_drawn.append(np.array(b["tokens"]))
        yield b
"""
FT_STACK_CELL = """\
%%distributed
_ft_drawn = np.stack(_ft_drawn)
_ft_losses = np.array(losses)
"""
PAR_ZIGZAG_K1 = MESH_WORLD * 4      # 4 ring hops, 4 half-pair launches a hop
PAR_DECODE_K4 = 7 * 2               # 7 decode steps, tiny_config's 2 layers


def parallelism_checks():
    """The tour's self-checks, as the CPU tests hold them: the
    ``failed_checks`` of ``examples/make_torch_parallelism_notebook.py``
    (each sentence, and the exact checks' errors under their bounds)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_parallelism_notebook",
        ROOT / "examples" / "make_torch_parallelism_notebook.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.failed_checks


def finetune_want(src, L):
    """The launches a fine-tune cell makes on a CUDA rank: K1, K2, K3
    once a layer a step (no remat), K1 once a layer per forward of the
    chunked-loss cell, K4 once a layer a decode step (the prefill is the
    plain cached attention)."""
    zero = dict(k1=0, k2=0, k3=0, k4=0)
    if src.startswith("import time\nit = batch_iterator("):
        return "finetune_train", dict(zero, k1=FT_STEPS * L,
                                      k2=FT_STEPS * L, k3=FT_STEPS * L)
    if "cfg_lean = dataclasses.replace(cfg, ce_chunk=" in src:
        return "finetune_ce", dict(zero, k1=2 * L)
    if f"generate(params, prompt, cfg, max_new_tokens={FT_NEW})" in src:
        return "finetune_generate", dict(zero, k4=(FT_NEW - 1) * L)
    return None, zero


def finetune_rows():
    """The notebook's rows: README, PARITY and SURVEY of this checkout,
    byte-tokenized into rows of 128."""
    import numpy as np
    corpus = ""
    for f in ("README.md", "PARITY.md", "SURVEY.md"):
        p = ROOT / f
        if p.exists():
            corpus += p.read_text(encoding="utf-8") + "\n\n"
    ids = np.frombuffer(corpus.encode("utf-8"), dtype=np.uint8)
    n_rows = len(ids) // 128
    return np.asarray(ids[:n_rows * 128], dtype=np.int32).reshape(n_rows,
                                                                  128)


def finetune_reference(ckpt_dir, n, use_flash):
    """The notebook's four DDP steps in this process on card 0, from its
    checkpoint: each of ``n`` emulated ranks' ``batch_iterator`` draws
    and gradients, averaged as ``all_reduce(g, "mean")`` averages them.
    Returns (rank 0's losses, each rank's draws (steps, B, 128))."""
    import numpy as np
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, load_hf_pretrained,
                                                loss_fn, param_leaves)
    from nbdistributed_tpu_torch.utils.data import batch_iterator

    params, cfg = load_hf_pretrained(ckpt_dir, dtype=torch.float32,
                                     device="cuda")
    cfg = dataclasses.replace(cfg, use_flash=use_flash)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = AdamW(leaves, lr=FT_LR)
    data = finetune_rows()
    its = [batch_iterator({"tokens": data}, batch_size=FT_B, rank=r,
                          world_size=n, seed=0, epochs=None)
           for r in range(n)]
    losses, drawn = [], [[] for _ in range(n)]
    for _ in range(FT_STEPS):
        grads = []
        for r, it in enumerate(its):
            tokens = next(it)["tokens"]
            drawn[r].append(tokens)
            for p in leaves:
                p.grad = None
            loss = loss_fn(params, {"tokens": torch.as_tensor(
                tokens, device="cuda")}, cfg)
            loss.backward()
            grads.append([p.grad for p in leaves])
            if r == 0:
                losses.append(float(loss.detach()))
        if n > 1:
            for p, *gs in zip(leaves, *grads):
                p.grad = sum(gs) / n
        opt.step()
    del params, leaves, opt, grads
    torch.cuda.empty_cache()
    return losses, [np.stack(d) for d in drawn]


def phase_finetune(n=1):
    """Phase 29's fine-tune: every cell of ``02_torch_finetune.ipynb``
    with ``%dist_init -n n --backend gpu`` at SmolLM2-135M's 30 layers,
    the launches held per cell, then rank 0's losses held to the steps
    in this process on card 0 (one rank: the plain path, within
    FT_LOSS_RTOL; two: an emulation of both ranks through the kernels,
    within FT_MESH_LOSS_RTOL), every rank's batches to the emulated
    draws bitwise, and the continuation to plain ``generate`` from the
    pulled tuned params by the near-tie rule."""
    import os
    import shutil

    import numpy as np
    import torch
    from nbdistributed_tpu_torch.models import config_from_hf, generate

    ts = time.perf_counter()
    run = FT_RUNS / f"n{n}"
    shutil.rmtree(run, ignore_errors=True)
    env = dict(NBD_NOTEBOOK_BACKEND="gpu", NBD_NOTEBOOK_WORKERS=str(n),
               NBD_NOTEBOOK_CKPT_DIR=str(run / "ckpt"),
               NBD_NOTEBOOK_CK_OUT=str(run / "ck_out"))
    saved = {k: os.environ.get(k) for k in (*env, "NBD_NOTEBOOK_LAYERS")}
    os.environ.update(env)
    os.environ.pop("NBD_NOTEBOOK_LAYERS", None)
    pulled = {}

    def before(nb, src):
        if src.startswith("import time\nit = batch_iterator("):
            nb.run(FT_RECORD_CELL)
        if src == "%dist_shutdown":
            nb.run(FT_STACK_CELL)
            pulled.update(losses=nb.pull("_ft_losses"),
                          drawn=nb.pull("_ft_drawn"))
            for name in ("toks", "params"):
                nb.run(f"%dist_pull {name} --rank 0 --as _ft_{name}")
                pulled[name] = nb.shell.user_ns.pop(f"_ft_{name}")

    try:
        L = N_LAYERS_SMOL
        outs, launches = run_counted_notebook(
            FINETUNE, n, lambda src: finetune_want(src, L), before)
        notebook_s = time.perf_counter() - ts
        text = "\n".join(out for _, out in outs)
        from transformers import AutoConfig
        cfg = config_from_hf(AutoConfig.from_pretrained(run / "ckpt"))
        # The checkpoint as both transformers versions write and read
        # it: SmolLM2-135M's shape and its rope_theta.
        check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.rope_theta)
              == (N_LAYERS_SMOL, 576, 49152, 1e5),
              f"fine-tune checkpoint: {cfg}")
        check("-param SmolLM2-135M-architecture checkpoint" in text,
              "fine-tune: no checkpoint built")
        for r in range(n):
            check(f"rank {r}: loaded 162.8M params, d_model=576, layers="
                  f"{N_LAYERS_SMOL}" in text, f"fine-tune: rank {r}'s "
                  "load line")
        check(text.count("(match: True)") == n, "fine-tune: the chunked "
              "loss differs from the full one")
        check(f"✅ {n} ranks saved" in text and "NOT improved" not in text,
              "fine-tune: no checkpoint saved, or the loss did not fall")
        want, drawn = finetune_reference(str(run / "ckpt"), n,
                                         use_flash=n > 1)
        got = [float(x) for x in np.asarray(pulled["losses"][0])]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        rtol = FT_MESH_LOSS_RTOL if n > 1 else FT_LOSS_RTOL
        check(len(got) == FT_STEPS and rel <= rtol, f"fine-tune: rank 0's "
              f"losses {got} against {want}: {rel} > {rtol}")
        for r in range(n):
            check(np.array_equal(np.asarray(pulled["drawn"][r]), drawn[r]),
                  f"fine-tune: rank {r}'s batches differ from the draws")
        # The continuation against plain generate from the tuned params.

        def on_card(t):
            if isinstance(t, dict):
                return {k: on_card(v) for k, v in t.items()}
            return torch.as_tensor(t).to("cuda")
        tuned = on_card(pulled.pop("params"))
        plain = dataclasses.replace(cfg, dtype=torch.float32,
                                    use_flash=False)
        prompt = list(FT_PROMPT.encode())
        ref = generate(tuned, [prompt], plain, FT_NEW)[0, len(prompt):]
        cont = torch.as_tensor(pulled["toks"])[0, len(prompt):]
        gaps = near_tie_check("finetune_continuation", tuned, plain,
                              [prompt], [cont.tolist()], [ref.tolist()])
        del tuned
        torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(run, ignore_errors=True)
    row = dict(ranks=n, cells=len(outs), launches=launches, losses=got,
               losses_ref=want, loss_max_rel_err=rel, loss_rtol=rtol,
               reference="emulated ranks, kernels" if n > 1 else "plain",
               batches_equal=True, continuation=cont.tolist(),
               continuation_gaps=gaps, notebook_s=notebook_s,
               seconds=time.perf_counter() - ts)
    say(f"finetune_n{n}", **row)
    return row


def finetune_child():
    """Phase 29's one-card run in a process of its own
    (:func:`start_finetune`): its row into ``chiprun_out``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    row = phase_finetune(1)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "finetune_n1.json").write_text(json.dumps(row, indent=1))


def start_finetune():
    """:func:`finetune_child` started in the background from the
    checkout's root, its output in ``chiprun_out/finetune_n1.txt``:
    (process, start time)."""
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "finetune_n1.json").unlink(missing_ok=True)
    with open(OUT_DIR / "finetune_n1.txt", "w") as log:
        proc = _stopped_at_exit(subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke as c; c.finetune_child()"],
            cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
    return proc, time.perf_counter()


def finetune_row(run):
    """Collect :func:`start_finetune`: exit 0 and its row."""
    proc, t0 = run
    try:
        proc.wait(timeout=FT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
    log = (OUT_DIR / "finetune_n1.txt").read_text()
    out = OUT_DIR / "finetune_n1.json"
    check(proc.returncode == 0 and out.exists(),
          f"phase 29 (fine-tune) failed, rc {proc.returncode}:\n"
          f"{log[-4000:]}")
    row = json.loads(out.read_text())
    row["seconds_since_start"] = time.perf_counter() - t0
    say("finetune", seconds_since_start=row["seconds_since_start"],
        launches=row["launches"])
    return row


def phase_finetune_main():
    """Phase 29 alone on one card: the kernels built, then the fine-tune
    in its own process."""
    from nbdistributed_tpu_torch.ops import _build
    _build.build_all()
    return finetune_row(start_finetune())


def parallelism_want(src):
    """The launches a tour cell makes on a CUDA rank: K1 in the zigzag
    cell (its ring's hops), K4 in the sp-sharded decode cell (a layer a
    decode step, the prefill plain); every other cell keeps the JAX
    cell's plain attention."""
    zero = dict(k1=0, k2=0, k3=0, k4=0)
    if 'schedule="zigzag"' in src:
        return "parallelism_zigzag", dict(zero, k1=PAR_ZIGZAG_K1)
    if "cfg_f = dataclasses.replace(cfg, use_flash=True)" in src:
        return "parallelism_sp_decode", dict(zero, k4=PAR_DECODE_K4)
    return None, zero


def phase_parallelism(n=MESH_WORLD):
    """Every cell of ``01_torch_parallelism.ipynb`` on ``n`` NCCL ranks,
    the launches held per cell on every rank, each cell's self-check
    sentence held."""
    import os
    ts = time.perf_counter()
    saved = {k: os.environ.get(k) for k in ("NBD_NOTEBOOK_BACKEND",
                                            "NBD_NOTEBOOK_WORKERS")}
    os.environ.update(NBD_NOTEBOOK_BACKEND="gpu",
                      NBD_NOTEBOOK_WORKERS=str(n))
    try:
        outs, launches = run_counted_notebook(PARALLELISM, n,
                                              parallelism_want)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    text = "\n".join(out for _, out in outs)
    failed = parallelism_checks()(text)
    check(not failed, f"parallelism tour: {failed}")
    errors = [ln.strip() for ln in text.splitlines()
              if "max |err|" in ln and "print(" not in ln]
    row = dict(ranks=n, cells=len(outs), launches=launches, errors=errors,
               seconds=time.perf_counter() - ts)
    say(f"parallelism_n{n}", **row)
    return row


def phase_notebooks_mesh():
    """``--mesh-nccl``'s part of phase 29: the fine-tune on cards 0 and
    1 (a real NCCL all-reduce), then the parallelism tour on four."""
    import torch
    from nbdistributed_tpu_torch.ops import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(finetune_n2=phase_finetune(2),
                parallelism=phase_parallelism(MESH_WORLD))


def phase_hf(params):
    """HF interop on the card: SmolLM2-135M (``params``, bf16) and
    Mixtral-8x7B at 2 layers laid out as ``transformers`` state dicts,
    converted back by ``params_from_hf`` / ``moe_params_from_hf`` onto
    the GPU; the trees and the bf16 logits must equal the originals bit
    for bit.  ``load_hf_pretrained`` runs on a saved tiny model only
    where ``transformers`` imports."""
    import dataclasses as dc

    import torch
    from nbdistributed_tpu_torch.models import (forward, init_moe_model,
                                                moe_forward,
                                                smol_135m_config)
    from nbdistributed_tpu_torch.models import hf

    ts = time.perf_counter()
    tokens = torch.randint(0, 32000, (1, 256),
                           generator=torch.Generator().manual_seed(8))
    cfg = smol_135m_config()
    conv, ccfg = hf.params_from_hf(hf_layout(params, cfg),
                                   dtype=torch.bfloat16, device="cuda")
    smol_equal = _trees_equal(conv, params)
    check(smol_equal and ccfg == cfg,
          "SmolLM2 HF round trip changed the parameters")
    smol_logits = torch.equal(forward(conv, tokens, ccfg),
                              forward(params, tokens, ccfg))
    check(smol_logits, "SmolLM2 HF round trip: logits differ")
    del conv

    mcfg = mixtral_cfg()
    mparams = init_moe_model(mcfg, 0)
    mconv, mccfg = hf.moe_params_from_hf(hf_layout(mparams, mcfg),
                                         dtype=torch.bfloat16,
                                         device="cuda")
    mix_equal = _trees_equal(mconv, mparams)
    check(mix_equal and mccfg.capacity_factor == mcfg.n_experts /
          mcfg.top_k and dc.replace(
              mccfg, capacity_factor=mcfg.capacity_factor) == mcfg,
          "Mixtral HF round trip changed the parameters")
    a, aux_a = moe_forward(mconv, tokens[:, :64], mccfg)
    b, aux_b = moe_forward(mparams, tokens[:, :64], mccfg)
    mix_logits = bool(torch.equal(a, b) and torch.equal(aux_a, aux_b))
    check(mix_logits, "Mixtral HF round trip: logits differ")
    del mparams, mconv, a, b
    torch.cuda.empty_cache()

    try:
        import transformers  # noqa: F401  (not installed on every card)
        loaded = "ran"
    except ImportError:
        loaded = "skipped: transformers does not import here"
    if loaded == "ran":
        loaded = _hf_load_pretrained_tiny()
    row = dict(smol_params_equal=smol_equal, smol_logits_equal=smol_logits,
               mixtral_params_equal=mix_equal,
               mixtral_logits_equal=mix_logits,
               load_hf_pretrained=loaded,
               seconds=time.perf_counter() - ts)
    say("hf_interop", **row)
    return row


def _hf_load_pretrained_tiny():
    """``load_hf_pretrained`` on a tiny random Llama saved to a
    temporary directory, against converting the model in memory."""
    import tempfile

    import torch
    from nbdistributed_tpu_torch.models import hf
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=True)).eval()
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        model.save_pretrained(d)
        got, _ = hf.load_hf_pretrained(d, dtype=torch.float32,
                                       device="cuda")
    want, _ = hf.params_from_hf(model, dtype=torch.float32, device="cuda")
    check(_trees_equal(got, want), "load_hf_pretrained: parameters differ")
    return "ran"


# ----------------------------------------------------------------------
# phase 16: timing

def sdpa(q, k, v, **kw):
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:                    # torch without enable_gqa
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), **kw)


def time_k1(q, k, v, iters=30):
    """K1 (causal, scale 1/sqrt(D)) through the launcher its wrapper
    calls, beside its plain version and ``scaled_dot_product_attention``."""
    from nbdistributed_tpu_torch.ops import attention as A

    B, S, H, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / D ** 0.5
    args = dict(causal=True, scale=scale, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda: A._flash_forward_cuda(q, k, v, **args), iters)
    plain = cuda_ms(lambda: A._flash_forward_plain(q, k, v, **args), iters)
    lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale),
                  iters)
    pairs = B * H * S * (S + 1) // 2               # causal (q, k) pairs
    flops = 4 * pairs * D
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D) + 4 * B * H * S
    t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=1e3 * max(t_f, t_b),
                bound_by="operations" if t_f >= t_b else "bytes",
                flops=flops, bytes=nbytes, causal_pairs=pairs,
                shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D))


def phase_timing():
    import torch

    rows = {}
    # Each kernel is timed through the launcher its wrapper calls, so
    # the wrapper's argument checks stay out of the kernel's time.
    # K1 at the forward's shape: B=1, S=512, H=9, Hkv=3, D=64, causal.
    rows["K1"] = time_k1(*k1_inputs(1, 512, 9, 3, 64, torch.bfloat16,
                                    seed=1))

    # K4 at the serving shape: B=8 slots, T=max_len=1024, positions as
    # the 16..232-token streams give them; and at the serving path's
    # full context: T=2048 (SmolLM2's max_seq_len), every slot at 2047.
    rows["K4"] = time_k4(serving_pos(8), 1024)
    rows["K4_full_context"] = time_k4(
        torch.full((8,), 2047, dtype=torch.int32, device="cuda"), 2048)
    # Mixtral's attention: K1 at S=2048 (the MoE train batch's length),
    # K4 at the MoE server's shape (8 slots, T=1024, Hkv=8, group 4).
    rows["K1_mixtral"] = time_k1(*k1_inputs(1, 2048, 32, 8, 128,
                                            torch.bfloat16, seed=4))
    rows["K4_mixtral"] = time_k4(serving_pos(8), 1024, Hkv=8, group=4,
                                 D=128)
    # K4 at the mesh phase's sp shard shape: a SmolLM2 dp x sp rank's 4
    # rows against its T/2 = 128-token slice, positions as the sp index
    # 0 rank sees them (its slice holds the first 128 of each row's).
    rows["K4_sp_shard"] = time_k4(serving_pos(4), MESH_MAX_LEN // 2, B=4)
    rows.update(time_train_shape())
    for name, row in rows.items():
        say("timing", kernel=name, **row)
    return rows


def time_k4(pos, T, B=8, Hkv=3, group=3, D=64):
    """K4 (bf16, no window) through the launcher its wrapper calls,
    beside its plain version and a masked ``scaled_dot_product_attention``,
    with one cache per layer so each launch finds its cache cold in L2,
    as a decode step does.  Each is timed on the device by CUDA-graph
    replay: a K4 call takes less device time than the host takes to
    issue it, so back-to-back launches time the host (``ms_eager``)."""
    import torch
    from nbdistributed_tpu_torch.ops import decode as K

    q, _, _, _, _, _ = k4_inputs(B, Hkv, group, D, 16, "bf16", seed=2)
    caches = [torch.randn(2, B, Hkv, T, D, device="cuda").to(torch.bfloat16)
              for _ in range(N_LAYERS_SMOL)]
    it = iter(range(10 ** 9))

    def kern():
        c = caches[next(it) % N_LAYERS_SMOL]
        return K._decode_cuda(q, c[0], c[1], pos, scale=0.125, window=None,
                              k_s=None, v_s=None, return_lse=False)[0]

    # What is timed is what phase 3 checked: hold one timed call's
    # output against the plain version too.
    ref, _ = K.decode_reference(q, caches[0][0], caches[0][1], pos,
                                scale=0.125)
    got = kern()
    err = max_err(got, ref)
    ratio = tol_ratio(got, ref, *K4_TOL["bfloat16"])
    check(ratio <= 1, f"K4 at the timing shape T={T}: tolerance ratio "
          f"{ratio}")

    def plain_fn():
        c = caches[next(it) % N_LAYERS_SMOL]
        K.decode_reference(q, c[0], c[1], pos, scale=0.125)

    valid = torch.arange(T, device="cuda")[None, :] <= pos.long()[:, None]
    mask = valid[:, None, None, :]                       # (B, 1, 1, T)
    q4 = q[:, :, None, :]                                # (B, H, 1, D)

    def lib_fn():
        c = caches[next(it) % N_LAYERS_SMOL]
        sdpa(q4, c[0], c[1], attn_mask=mask, scale=0.125)

    ms, plain, lib = graph_ms(kern), graph_ms(plain_fn), graph_ms(lib_fn)
    ms_eager = cuda_ms(kern, 90)
    n_valid = int(torch.clamp(pos.long() + 1, min=0, max=T).sum())
    nbytes = 2 * (2 * n_valid * Hkv * D + 2 * B * Hkv * group * D) + 4 * B
    flops = 4 * n_valid * Hkv * group * D
    t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=1e3 * max(t_f, t_b),
                bound_by="operations" if t_f >= t_b else "bytes",
                ms_eager=ms_eager, max_abs_err=err, flops=flops, bytes=nbytes,
                valid_tokens=n_valid,
                nsplit_chunk=K._decode_splits(B * Hkv, T),
                shape=dict(B=B, Hkv=Hkv, group=group, D=D, T=T))


def time_train_shape():
    """K1, K2 and K3 at the train shape (B=4, S=2048, H=9, Hkv=3, D=64,
    bf16, causal; the kernels mask segments inside their tiles and skip
    none, so the batch's segments do not change their time), each
    through the launcher its wrapper calls.  K1 as in ``time_k1``; K2
    and K3 beside the plain backward (one call computes dq, dk and dv)
    and one library yardstick for the pair: the backward of
    ``scaled_dot_product_attention(..., enable_gqa=True)`` on the same
    inputs, timed as ``torch.autograd.grad`` on a retained graph."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    B, S, H, Hkv, D = TRAIN_B, 2048, 9, 3, 64
    q, k, v = k1_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=21)
    g = torch.randn(B, S, H, D, device="cuda").to(torch.bfloat16)
    args = dict(causal=True, scale=0.125, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    # What is timed is what phases 2 and 4 checked: hold K1's (out, lse)
    # to the plain forward before K2/K3 use them, then K2/K3 to the
    # plain backward.
    out, lse = A._flash_forward_cuda(q, k, v, **args)
    k1_err = check_k1("timing_train_shape", out, lse,
                      *A._flash_forward_plain(q, k, v, **args),
                      torch.bfloat16)
    delta = A._flash_bwd_prep(out, g)
    dq_ms = cuda_ms(lambda: A.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                                     **args), 20)
    dkv_ms = cuda_ms(lambda: A.flash_attention_bwd_dkv(q, k, v, g, lse,
                                                       delta, **args), 20)
    want = A._flash_backward_plain(q, k, v, out, lse, g, **args)
    got = (A.flash_attention_bwd_dq(q, k, v, g, lse, delta, **args),
           *A.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **args))
    row = check_k23("timing_train_shape", got, want, torch.bfloat16)
    errs = {"K2": row["dq"]["max_abs_err"],
            "K3": max(row["dk"]["max_abs_err"], row["dv"]["max_abs_err"])}
    del want, got
    rows = {"K1_train": dict(time_k1(q, k, v, 20), max_abs_err=k1_err)}
    plain = cuda_ms(lambda: A._flash_backward_plain(q, k, v, out, lse, g,
                                                    **args), 5, 1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = sdpa(qt, kt, vt, is_causal=True, scale=0.125)
    go = g.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                              retain_graph=True), 20)

    pairs = B * H * S * (S + 1) // 2               # causal (q, k) pairs
    io_q = 2 * B * S * H * D                       # one bf16 (B, S, H, D)
    io_k = 2 * B * S * Hkv * D
    io_rows = 2 * 4 * B * H * S                    # lse + delta, fp32
    for name, ms, products, nbytes in (
            ("K2", dq_ms, 3, 3 * io_q + 2 * io_k + io_rows),
            ("K3", dkv_ms, 4, 2 * io_q + 4 * io_k + io_rows)):
        flops = products * 2 * D * pairs
        t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          max_abs_err=errs[name],
                          library="sdpa backward (K2+K3 pair)",
                          bound_ms=1e3 * max(t_f, t_b),
                          bound_by="operations" if t_f >= t_b else "bytes",
                          flops=flops, bytes=nbytes, causal_pairs=pairs,
                          shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D))
    return rows


# ----------------------------------------------------------------------

# The kernel functions of each source, as ptxas names them.
KERNEL_FUNCTIONS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                    "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel",
                    "decode_split_kernel", "decode_combine_kernel")


def ptxas_report(log):
    """Registers, spills and static shared memory of every instantiation
    of ``KERNEL_FUNCTIONS``, from nvcc's ``-Xptxas -v`` output, keyed by
    the kernel's name and its mangled template arguments, as
    ``flash_fwd_wgmma_kernel<Li64E>`` (D = 64) or
    ``decode_split_kernel<13__nv_bfloat16aLi64E>`` (bf16 query, int8
    cache)."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((n for n in KERNEL_FUNCTIONS
                         if re.search(rf"\d{n}I", mangled)), None)
            # ...<len><name>I<template arguments>Ev<parameters>: every
            # kernel is a template returning void.
            args = (re.search(rf"\d{name}I(\w*?)Ev", mangled)
                    if name else None)
            cur = f"{name}<{args[1]}>" if args else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out[cur]["static_smem_bytes"] = int(m[1])
    return out


def gpu_name_and_power():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main_mesh_nccl() -> int:
    """``--mesh-nccl``: phases 18, 19, 20 and 21's ranks, phase 22's
    guarded replicas, phases 23 and 24's notebook, phase 25's hung
    collective, phase 26's resized pool, phase 27's two-host world,
    phase 28's two-rank self-test and phase 29's notebooks (the
    fine-tune on two ranks, the parallelism tour on four), alone on
    four cards, one NCCL rank each, against the references they
    compute first on card 0."""
    import torch
    from nbdistributed_tpu_torch.models import init_moe_model, init_params
    from nbdistributed_tpu_torch.ops import _build

    check(torch.cuda.device_count() >= MESH_WORLD,
          f"--mesh-nccl needs {MESH_WORLD} GPUs, found "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60,
                           check=True).stdout.strip().splitlines()
    say("cards", cards=cards)
    smol = smol_135m_config_fp32()
    prompts = make_requests(smol)
    solo = solo_outputs(init_params(smol, 0), smol, prompts)
    mix = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS)
    msolo = solo_outputs(init_moe_model(mix, 0), mix,
                         make_requests(mix)[:8])
    mesh = phase_mesh(prompts, solo, msolo, backend="nccl")
    train_mesh = phase_train_mesh(backend="nccl")
    train_sp = phase_train_sp(backend="nccl")
    train_pp = phase_train_pp(backend="nccl")
    guard = phase_guard(backend="nccl")
    refs = notebook_refs()
    notebook = phase_notebook(*refs, n=MESH_WORLD)
    notebook_async = phase_notebook_async(*refs, n=MESH_WORLD)
    supervision_mesh = phase_supervision_mesh()
    pool_mesh = phase_pool_mesh(solo32=solo)
    multihost_mesh = phase_multihost_mesh()
    selftest_mesh = phase_selftest_mesh()
    notebooks_mesh = phase_notebooks_mesh()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_mesh_nccl.json").write_text(json.dumps(
        {"cards": cards, "mesh": mesh, "train_mesh": train_mesh,
         "train_sp": train_sp, "train_pp": train_pp, "guard": guard,
         "notebook": notebook, "notebook_async": notebook_async,
         "supervision_mesh": supervision_mesh, "pool_mesh": pool_mesh,
         "multihost_mesh": multihost_mesh,
         "selftest_mesh": selftest_mesh,
         "notebooks_mesh": notebooks_mesh}, indent=1))
    print(cards[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--mesh-nccl"]:
        return main_mesh_nccl()
    lint = start_self_lint()       # host Python, collected in phase 28
    from nbdistributed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    spent = _build.build_all()
    ptxas = {n: ptxas_report(_build.build_log(n)) for n in _build.KERNELS}
    card = gpu_name_and_power()
    say("build", seconds=time.perf_counter() - t0, per_kernel_s=spent,
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        ptxas=ptxas)

    # Each phase's seconds, for the time budget (PERF.md section 4).
    phase_s: dict = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[name] = time.perf_counter() - t

    k1_err = timed("k1", phase_k1)
    k4_err = timed("k4", phase_k4)
    k23_err = timed("k23", phase_k23)
    counts, prompts, params, dense = timed("main_path", phase_main_path)
    profile_row = timed("profile", phase_profile, params)
    cluster = timed("cluster", phase_cluster, prompts, dense)
    hf_row = timed("hf", phase_hf, params)
    params32, solo32 = timed("fp32", phase_fp32, prompts)
    beyond, seconds = timed("serving_beyond_dense", serving_beyond_dense,
                            prompts)
    del params, params32
    torch.cuda.empty_cache()
    train, train_profile = timed("train", phase_train)
    torch.cuda.empty_cache()
    train_fp32 = timed("train_fp32", phase_train_fp32_vs_plain)
    torch.cuda.empty_cache()
    lora_losses = timed("lora", phase_lora)
    torch.cuda.empty_cache()
    moe = timed("moe", phase_moe)
    torch.cuda.empty_cache()
    mesh = timed("mesh", phase_mesh, prompts, solo32, moe["fp32"]["solo"])
    train_mesh = timed("train_mesh", phase_train_mesh)
    hop_err = timed("hop_kernels", phase_hop_kernels)
    train_sp = timed("train_sp", phase_train_sp)
    remat_dots = timed("remat_dots", phase_remat_dots)
    train_pp = timed("train_pp", phase_train_pp)
    guard = timed("guard", phase_guard)
    torch.cuda.empty_cache()
    notebook = timed("notebook", phase_notebook, dense["outputs"],
                     train["losses"][0])
    notebook_async = timed("notebook_async", phase_notebook_async,
                           dense["outputs"], train["losses"][0])
    supervision = timed("supervision", phase_supervision, dense["outputs"],
                        train["losses"][0])
    pool = timed("pool", phase_pool, dense["outputs"], train["losses"],
                 solo32)
    # Phase 29's fine-tune runs in its own process beside phases 27
    # and 28 (their host-clock rows are taken under its load), and ends
    # before phase 16 times the kernels.
    finetune_run = start_finetune()
    multihost = timed("multihost", phase_multihost, dense["outputs"],
                      train["losses"])
    selfcheck = timed("selfcheck", phase_selfcheck, lint, dense["outputs"])
    finetune = timed("finetune", finetune_row, finetune_run)
    timing = timed("timing", phase_timing)
    say("phase_seconds", total=time.perf_counter() - t0, **phase_s)

    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def kernel(name, source, replaces, launches, err, key, design,
               functions, **extra):
        lib = source.removesuffix(".cu")
        return dict(name=name, route="cuda",
                    source=f"nbdistributed_tpu_torch/ops/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    **{k: timing[key][k] for k in timed}, design=design,
                    ptxas={f: r for f, r in ptxas[lib].items()
                           if f.split("<")[0] in functions}, **extra)

    # K1 runs on the serving, training and MoE paths: its launches are
    # the runs' sum, its times the serving shape's, with the train
    # shape's and Mixtral's beside them.
    # K4's launches are every serving path's sum, its times the serving
    # shape's, with full context's beside them.  Each error is the worst
    # bf16 one of every check of the kernel.
    k4_paths = {"serve": counts["k4"],
                "cluster_serve": cluster["serve"]["k4_launches"],
                **{name: row["k4"] for name, row in beyond.items()},
                "serve_moe": moe["serve"]["k4_launches"]
                + moe["fp32"]["k4_serve"],
                "serve_moe_paged": moe["serve"]["k4_paged"],
                "serve_moe_speculative": moe["fp32"]["k4_speculative"],
                "serve_moe_int8": moe["serve"]["k4_int8"]
                + moe["fp32"]["k4_int8"],
                **{name: row["k4_launches_rank0"]
                   for name, row in mesh.items() if name != "seconds"},
                "notebook_serve": notebook["serve"]["k4_launches"],
                "notebook_async_serve":
                    notebook_async["serve"]["k4_launches"],
                "supervision_healed_serve":
                    supervision["heal"]["serve"]["k4_launches"],
                "pool_serve": pool["bob"]["k4_launches"],
                **{path: pool[path]["k4_launches"] for path in PLANE_PATHS},
                "multihost_serve": multihost["serve"]["k4_launches"],
                # Phase 28: the quickstart's cells and, in its world,
                # phase 17's requests.
                **{path: row["k4"] for path, row in
                   selfcheck["quickstart"]["launches"].items()
                   if path != "quickstart_train"},
                "quickstart_smol_serve":
                    selfcheck["quickstart"]["smol_serve"]["k4_launches"]}
    k1_paths = {"serve": counts["k1"],
                "cluster_serve": cluster["serve"]["k1_launches"],
                "multihost_serve": multihost["serve"]["k1_launches"],
                "train": train["k1"],
                "moe_forward": moe["modes"]["k1_launches"],
                "train_moe": moe["train"]["k1"]}
    k2_paths = {"train": train["k2"], "train_moe": moe["train"]["k2"]}
    k3_paths = {"train": train["k3"], "train_moe": moe["train"]["k3"]}
    for k, paths in (("k1", k1_paths), ("k2", k2_paths), ("k3", k3_paths)):
        paths["train_remat_dots"] = remat_dots["dots"]["launches"][k]
    for name, row in {**train_mesh, **train_sp, **train_pp}.items():
        if name != "seconds" and not name.startswith("overlap"):
            k1_paths[name] = row["k1_launches_rank0"]
            k2_paths[name] = row["k2_launches_rank0"]
            k3_paths[name] = row["k3_launches_rank0"]
    # Phase 22: the guarded replicas' two runs (rank 0), the rollback
    # run, the checkpoint run and the worker's guarded steps.
    rep_row = guard["train_guard_replicas"]
    for k, paths in (("k1", k1_paths), ("k2", k2_paths), ("k3", k3_paths)):
        paths["train_guard_replicas"] = rep_row[f"{k}_launches_rank0"]
        paths["train_guard_replicas_faulted"] = \
            rep_row[f"{k}_launches_faulted_rank0"]
        paths["train_guard_rollback"] = \
            guard["train_guard_rollback"]["launches"][k]
        paths["train_checkpoint"] = guard["train_checkpoint"]["launches"][k]
        paths["cluster_guard"] = guard["guard_worker"]["launched"][k]
        # Phase 23: the notebook's training cell (rank 0).
        paths["notebook_train"] = notebook["train"]["launches"][k]
        # Phase 24: the training steps streamed through the window.
        paths["notebook_async_train"] = \
            notebook_async["train"]["launches_async"][k]
        # Phase 25: the steps scraped mid-cell, steps 3-4 after the
        # heal (rank 0).
        paths["supervision_scrape"] = supervision["scrape"]["launches"][k]
        paths["supervision_healed_train"] = \
            supervision["heal"]["launches_2_steps"][k]
        # Phase 26: tenant alice's steps on the pool's rank.
        paths["pool_train"] = \
            POOL_TRAIN_STEPS * pool["alice"]["launches"][k]
        # Phase 27: the agent-spawned rank's steps, and the step redone
        # after the heal through the agent.
        paths["multihost_train"] = \
            MH_TRAIN_STEPS * multihost["train"]["launches_per_step"][k]
        paths["multihost_healed_train"] = \
            multihost["train"]["redone_launches"][k]
        # Phase 28: the quickstart's training, eval and restore cells.
        paths["quickstart_train"] = \
            selfcheck["quickstart"]["launches"]["quickstart_train"][k]
        # Phase 29: the fine-tune notebook's four DDP steps.
        paths["finetune_train"] = finetune["launches"]["finetune_train"][k]
    # Phase 29: its chunked-loss cell's two forwards, its generation.
    k1_paths["finetune_ce"] = finetune["launches"]["finetune_ce"]["k1"]
    k4_paths["finetune_generate"] = \
        finetune["launches"]["finetune_generate"]["k4"]
    # Phase 25's stalled loop launched K1 until the interrupt.
    k1_paths["supervision_stall_loop"] = \
        supervision["stall"]["loop_k1_launches"]
    # Phase 28's self-test: its model-stack cell's one fp32 launch.
    k1_paths["selftest_k1"] = selfcheck["selftest"]["k1_launches"]
    tensor_cores = "wgmma bf16 / scalar fp32"
    split = "bf16 hi + lo operand"
    kernels = [
        kernel("flash_attention_fwd", "flash_attention.cu",
               "nbdistributed_tpu/ops/attention.py:405",
               sum(k1_paths.values()),
               max(k1_err, k23_err["k1"], hop_err["k1"],
                   timing["K1_train"]["max_abs_err"],
                   selfcheck["selftest"]["k1_max_abs_err"]),
               "K1", tensor_cores,
               ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
               launches_by_path=k1_paths,
               train_shape={k: timing["K1_train"][k] for k in timed},
               mixtral_shape={k: timing["K1_mixtral"][k] for k in timed}),
        kernel("flash_attention_bwd_dq", "flash_attention_bwd.cu",
               "nbdistributed_tpu/ops/attention.py:688",
               sum(k2_paths.values()),
               max(k23_err["dq"], hop_err["dq"], timing["K2"]["max_abs_err"]),
               "K2",
               f"{tensor_cores} (dS as a {split})",
               ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
               launches_by_path=k2_paths),
        kernel("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
               "nbdistributed_tpu/ops/attention.py:747",
               sum(k3_paths.values()),
               max(k23_err["dkv"], hop_err["dkv"],
                   timing["K3"]["max_abs_err"]), "K3",
               f"{tensor_cores} (P and dS each as a {split})",
               ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel"),
               launches_by_path=k3_paths),
        kernel("flash_decode", "flash_decode.cu",
               "nbdistributed_tpu/ops/decode.py:214", sum(k4_paths.values()),
               max(k4_err, timing["K4"]["max_abs_err"],
                   timing["K4_full_context"]["max_abs_err"],
                   timing["K4_mixtral"]["max_abs_err"],
                   timing["K4_sp_shard"]["max_abs_err"]),
               "K4", "split-T flash-decoding: (B*Hkv, nsplit) blocks, "
               "cp.async ring, warp-level dot products, lse combine kernel",
               ("decode_split_kernel", "decode_combine_kernel"),
               launches_by_path=k4_paths,
               full_context={k: timing["K4_full_context"][k]
                             for k in timed},
               mixtral_shape={k: timing["K4_mixtral"][k] for k in timed},
               sp_shard_shape={k: timing["K4_sp_shard"][k] for k in timed}),
    ]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "timing": timing,
         "counts": counts, "profile": profile_row, "train": train,
         "train_profile": train_profile, "train_fp32_vs_plain": train_fp32,
         "lora_losses": lora_losses, "ptxas": ptxas,
         "serving_beyond_dense": beyond,
         "serving_beyond_dense_seconds": seconds, "moe": moe,
         "cluster": cluster, "hf": hf_row, "mesh": mesh,
         "train_mesh": train_mesh, "hop_kernels": hop_err,
         "train_sp": train_sp, "remat_dots": remat_dots,
         "train_pp": train_pp, "guard": guard, "notebook": notebook,
         "notebook_async": notebook_async, "supervision": supervision,
         "pool": pool, "multihost": multihost, "selfcheck": selfcheck,
         "finetune": finetune, "phase_seconds": phase_s},
        indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
