#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_dist_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card visible::

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. build: compile every CUDA source under ``tpu_dist_torch/csrc/`` with
   ``nvcc``, and the input pipeline's ``pipeline.cpp`` with the host
   compiler (one process per source, all started together), into
   ``tpu_dist_torch/csrc/build/``; print each kernel instance's registers
   and spills (``-Xptxas -v``, on a fresh build) and its tensor-core
   instructions (``HMMA``/``HGMMA`` in ``cuobjdump -sass`` of the library,
   read every time); fail if a tensor-core instance of a flash kernel has
   none.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge cases (causal, ragged S, every head
   dim, bf16 in with f32 out), with the tolerance of each; f32 inputs take
   the f32-accurate kernels (the forward's 3xTF32, the backward's CUDA
   cores), bf16 inputs the bf16 tensor-core kernels; a misaligned bf16
   input must be refused. Device times of the kernel and of one library
   call computing the same function (a yardstick the port never calls),
   each with a head start (``obs/timing.py``: the device sleeps until the
   host has queued every timed call, so the events see device time only)
   and the host's enqueue time a call beside it; the plain version's
   period back to back.
3. kernels at the training shapes: the flash backward's dK/dV and dQ
   kernels against their plain versions at ViT-B/16's [BH, S, D] =
   [768, 196, 64] (batch 64 x 12 heads) in bf16 and f32, and at edge cases
   (causal, S = 5, 77, 196 and 300 with D = 16 to 128, bf16 in with f32
   gradients, a strided ``do``, each in both dtypes; phase 16 (c)'s f32
   [128, 64, 16], causal and not, in both phases); the forward at the
   training shape in bf16; times of each kernel, its plain version and a
   library call (the backward of ``F.scaled_dot_product_attention``), and
   of the forward kernel at the training shape. The fused SGD over
   ViT-B/16's 151 leaves: 3 steps bit for bit against its plain version;
   the kernel and ``torch.optim.SGD(fused=True).step()`` timed in turns
   (``obs/fused_sgd_bench.py``), the profiler's duration of the kernel
   within 15% + 3 us of its head-start time, no host-to-device copy
   in 10 profiled calls on unchanged leaves, and the host time of a plan
   cache miss (leaves that moved). Then its edge cases, each 3
   steps bit for bit: p and g 4, 8 and 12 bytes off 16-byte alignment
   with lengths that leave a scalar tail; 808 leaves (two launches a
   step); and one call captured in a ``torch.cuda.CUDAGraph`` over static
   buffers, replayed for 3 steps with new gradients and learning rates.
4. serve: ViT-B/16 at full width, random weights from a numpy seed carried
   in through the bridge, served by ``ServingEngine(max_batch=8)`` with
   ``attn_impl="flash"``: warmup, then 32 requests in alternating 3- and
   7-request bursts. Launch counts are set to 0 just before and read just
   after; every request must complete with finite logits, the flash kernel
   must have run 12 times per forward, all on the f32 route, and the
   logits must agree with the same engine run with ``attn_impl="xla"``.
   Then ViT-B/16 from a checkpoint: the same weights with ``ckpt.save``,
   beside the flat momentum a ZeRO-1 run at dp = 16 leaves (8 zeros of
   pad) under its ``elastic`` stamp, and a newer copy with one flipped
   byte. ``load_serving_state`` must quarantine the copy, remap the
   momentum (``zero1_flat``) and give the written parameters bit for bit.
   The 32 requests are served twice from them, in f32 and with
   ``quantize=True``, each with the default SLO rules, a history JSONL,
   an exporter on a free local port and a heartbeat file: 12 f32-route
   flash launches a forward in both runs, the f32 logits equal to the
   live module's bit for bit, the int8 engine's allocation on the card
   the int8 weights and scales only (no f32 copy), the heartbeat present
   while serving and gone after ``sweep_heartbeat``, one HTTP scrape with
   the ``serve_*`` gauges and histogram families, and ``python -m
   tpu_dist_torch.serve report`` on the history exiting 0. ``[serve]``
   lines: load ms and file bytes, weights bytes on the card in f32 and
   int8, requests/s and p50/p99 of each run, the dequantize's host us
   and device ms a forward, int8-vs-f32 logits (max |diff|, top-1
   agreement) and the SLO alerts that fired.
   The checkpoint directory stays for phase 8.
5. train: ViT-B/16 at full width, weights from numpy seed 0 through the
   bridge, through ``make_train_step``. (a) f32 parity, TF32 off: batch 8,
   3 steps of flash attention + fused SGD against plain attention + plain
   SGD from the same weights; losses per step and the parameters after
   step 3 must agree. (b) bf16 parity: the same at bf16 compute; the losses
   must agree per step. (c) the ``vit_b16_imagenet_flash`` configuration
   (bf16 compute, batch 64, SGD lr 0.1, momentum 0.9, weight decay 1e-4,
   fused): 2 warmup steps, then 10 timed steps with the launch counts set
   to 0 just before and read just after (12 forward, 12 dK/dV, 12 dQ and
   1 SGD launch per step; every forward, dK/dV and dQ launch on the
   tensor-core route) and a finite loss every step; step time,
   images/s, peak memory, each kernel's share of the step and the fused
   SGD's plan cache hits and misses over the 10 steps; then one
   ``make_eval_step`` over the batch.
6. train ResNet-18 (``resnet18_cifar100``): the fused SGD kernel at
   ResNet-18's 62 leaves (11,220,132 parameters), as at ViT-B/16's in
   phase 3 (bit for bit, times in turns with the library, profiler,
   no host-to-device copy), beside its bytes bound. Then
   over a 1-rank NCCL process group: (a) f32 parity, TF32 off, batch 32, 3
   steps of fused against plain SGD from the same bridged weights through
   the data-parallel step (SyncBN on), on cuDNN's deterministic
   algorithms with losses to 1e-4 relative, then on its default ones to
   1e-3 (their backward's summation order); (b) the
   main path, ``Trainer(cfg).fit()`` at full width (CIFAR stem, widths
   64-512, 100 classes): bf16 compute over f32 masters, global batch 256,
   SyncBN, fused SGD, synthetic 50,000 images, 2 epochs of 20 steps, an
   eval of the 10,000 test images after each. Counts are set to 0 just
   before ``fit`` and read just after: finite losses, 1 fused SGD launch
   and 1 gradient all-reduce (the port's own counter in
   ``comm/collectives.py``) per step, 10,000 real eval examples per eval;
   step times (each step ended by ``synchronize``), images/s, peak memory,
   the fused SGD's plan cache hits and misses after the 2 first steps,
   the eval top-1, and a profile of 2 more steps. (c) The real entry point
   as a subprocess: ``python -m tpu_dist_torch.cli.distributed_mp
   --dataset synthetic --synthetic_n 2560 --epochs 1 --steps_per_epoch 3
   --batch_size 256`` must exit 0 with one rank-0 epoch line; it runs
   beside (e), the two children on the card at once, after (d) and (f).
   (d) Checkpoint/resume of the main path, over the same NCCL group: the
   run of (b) with ``ckpt_dir`` (a temporary directory), ``save_every=1``
   and ``mid_epoch_save_every=10``, whose 30th step (epoch 1, its 10th)
   first sends this process SIGTERM: ``fit`` must raise ``PreemptedError``
   at that step boundary, leaving an emergency snapshot stamped
   ``mid_epoch_step=10`` whose arrays equal the live state bit for bit.
   A new ``Trainer(resume=True)`` must restore exactly the file's arrays
   and run the 10 remaining steps: 40 fused SGD launches and 40 gradient
   all-reduces over both runs, the first resumed loss equal to the same
   step taken from the interrupted run's live state and close to step 30
   of (b), and the fused SGD's plan cache hitting on at least 0.9 of the
   resumed steps after the first 2. The resumed run's newest checkpoint
   then loads through ``load_serving_state`` into a fresh module and
   serves 8 requests in one batch through ``ServingEngine`` (f32): the
   logits must equal an eval-mode forward of the resumed trainer's model
   bit for bit. Then the card's times of a synchronous save, of the blocking part of an async save and of a
   CRC-verified restore with its copy onto the card, and the file's bytes.
   (e) The real entry point once more, through the launcher:
   ``python -m tpu_dist_torch.cli.launch --nproc 1 -- python -m
   tpu_dist_torch.cli.train ... --ckpt_dir D --log_file D/h.jsonl``,
   sent SIGTERM after its first epoch line, must exit 75 with a checkpoint
   on disk, and the history must be JSONL with ``train_epoch`` records. It
   has ``--crash_dir``: ``python -m tpu_dist_torch.obs postmortem`` must
   give rank 0 ``preempted`` with the flight ring's last ``step`` record
   where the run stopped; and the host us of one ``FlightRecorder.step``
   (median of 1,000 calls). (Its rerun with ``--resume`` was cut to make
   room for phase 19: phase 11 (a) relaunches with ``--resume`` through the
   launcher, and phase 19 (b) reads a clean exit's ``clean`` verdict.)
   (f) The fused epoch (``bench.py:243``'s ``resnet18_cifar100_fused``),
   over the same NCCL group: ``Trainer(cfg with fused_epoch=True).fit()``,
   2 epochs of all 195 steps with a fused eval of the 10,000 test images
   after each, the dataset on the card and one step captured in a CUDA
   graph and replayed (``train/epoch.py``). Counts set to 0 just before
   ``fit`` and read just after: finite losses, 390 fused SGD launches and
   390 gradient (and metrics) all-reduces, 20,000 eval examples. Capture
   seconds, seconds per epoch, images/s, step ms (epoch time / 195), peak
   memory and the dataset's bytes on the card, beside (b)'s step median.
   Under torch.profiler over 25 replays: 1 ``fused_sgd_kernel`` a step on
   the device and the device's idle share; the NCCL all-reduce kernels
   a step (none at a world of one, where NCCL's in-place sum is no device
   work, so the 42 all-reduces a step are held to the profiler's
   host-side record of one eager step and to the capture's counts). Then
   graph replay against the eager ``make_train_step`` from the same bridged
   weights on the same batches, 5 steps that warm up, capture and replay
   and 5 that only replay: f32 (TF32 off, deterministic cuDNN) losses to
   1e-5 relative and parameters to 1e-5 of their update; bf16 losses to
   2e-3 relative. (Its run through the real entry point in a fresh
   process was cut to keep the smoke inside its bound with phase 18: (c)
   and (e) drive the entry point, (f) the fused path.)
7. optimizers: AdamW, LARS and LAMB, ``remat`` and the native input
   pipeline, after phase 6 and before the phases that start CUDA children
   of their own (but for (d), its last part). (a) ViT-B/16 at
   ``vit_b16_imagenet_flash``'s shapes (bf16, batch 64, flash) with AdamW
   as the trainer builds it (``trainer.make_optimizer``; lr 1e-3): 2
   warmup and 10 timed steps, the counts set to 0 just before and read
   just after: 12/12/12 flash launches a step on the tensor-core route, no
   fused SGD launch, finite losses, ``count`` 12; step ms, images/s, peak
   memory. (b) The same with ``remat=True``: 24 forward launches a step
   (the recomputation), losses equal to (a)'s within 2e-3 relative, peak
   memory and step ms beside (a)'s. AdamW's update alone at ViT-B/16's
   151 leaves: device ms with a head start, beside its bytes bound (28
   bytes a parameter) and ``torch.optim.AdamW(fused=True).step()`` as a
   yardstick. (c) f32 parity, TF32 off, batch 8, 3 steps: flash against
   plain attention with AdamW, then with LAMB, from the same bridged
   weights: losses per step to 1e-4 relative, and the parameters (but the
   key biases, whose exact gradient is 0) to 1e-3 of their update (norm).
   (e) The fused epoch with AdamW over a 1-rank NCCL group: one epoch of
   195 replays, a finite loss, ``count`` 195, no fused SGD launch; then
   graph replay against the eager step, f32, as in phase 6 (f). The host
   ms of one 256-image ``gather_augment``, native and numpy, side by side.
   (d) The real entry point: ``python -m tpu_dist_torch.cli.train
   --optimizer lars --lr_base_batch 256 --warmup_epochs 1`` at
   ``bench.py:240``'s ResNet-18 shapes (bf16, batch 256, SyncBN), one epoch
   of 20 steps with ``--remat``: it exits 0, its rank-0 start line says
   ``input=native``, and its history's ``data_stall_frac`` is printed. (A
   second child without ``--remat`` was cut to keep the run inside its
   bound; (a) and (b) run the step with and without remat in this
   process.)
8. supervise: the supervised replica, from phase 4's checkpoint
   directory, after every phase that reads torch.profiler (once a few
   CUDA processes of their own have come and gone on the card, this
   process's CUDA-only profiler sessions record nothing at random): the
   port's ``ReplicaSupervisor`` (wall clock; at most 3 restarts, a beat
   stale after 5 s, 10 ms backoff) spawns one child at a time, a
   ``python -c`` process that runs ``serve/replica.py``'s ``serve`` with
   ViT-B/16 (``attn_impl="flash"``, ``--max_batch 8``, 224x224x3 payloads)
   on phase 1's kernel library. Its first incarnation must be ``ready``;
   SIGKILLed, ``poll_once()`` must say ``crash`` with a ``postmortem``
   bundle whose rank 0 reads ``no-clean-exit``; the second incarnation
   must be ``ready`` with the same ``weights_digest``, and under SIGTERM
   write ``drained`` while ``poll_once()`` says ``exit``. A second
   supervisor's replica (``--serve_n 16 --wedge_after 16``) stops pumping
   and must read as ``wedge``, be terminated, bundled and relaunched. Each
   drained child's flash launches are 12 a forward, all f32. ``[replica]``
   lines: spawn -> ready seconds of each incarnation, the down time (crash
   or wedge verdict -> the next ``ready``), the seconds to detect the
   wedge, and requests/s and p50/p99 from the replica's own ``serve``
   records. Last, ``python -m tpu_dist_torch.serve drill`` on the card
   must exit 0.
9. forensics: the training forensics chain, after phase 8 because it
   also spawns CUDA children. (a) A healthy round: ``python -m
   tpu_dist_torch.cli.launch --nproc 1`` with ``--heartbeat_dir``,
   ``--metrics_dir``, ``--crash_dir`` and a 120 s ``--watchdog_timeout``
   over the trainer's CLI (``bench.py:240``'s ``resnet18_cifar100``
   shapes: full width, 100 classes, batch 256, bf16, fused SGD; 1 epoch of
   20 steps, ``--metrics_port`` a free port), the child printing its fused
   SGD launches at exit. It must exit 0 with 20 launches; the heartbeat
   file, read every 20 ms while it runs, must show one process whose
   counter only grows (``start``, then steps), and be gone after the clean
   exit; the metrics textfile must parse (``export.parse``) with 21 beats
   and 20 steps; one HTTP scrape of the rank-0 endpoint must answer during
   the run. ``[forensics]`` lines: the seconds of the round and the longest
   gap between two beats the watchdog sees, spawn counted as the first and
   the launcher's exit as the last (the last beat -> exit gap holds the
   epoch-end eval, printed apart).
   (b) The wedge: ``python -m tpu_dist_torch.obs.drill --device cuda`` at
   the same shapes with ``hang@epoch=0:step=5`` and a watchdog timeout of
   (a)'s longest gap plus the larger of 5 s and half of it. It must exit 0
   (the drill's own checks: found, dumped, killed, bundled), its bundle's
   ring must end at step 5 and its stuck frame be ``faults._hang``.
   ``[forensics]`` lines: the detection time (the last beat landed -> the
   wedge line), the dump's wait (SIGUSR1 -> the dump settled), SIGTERM ->
   exit, the bundle's verdict and stuck frame, and the phase's seconds.
10. elastic: ZeRO-1, the compressed gradient reduce and the elastic
   resume; (a)-(c) over a 1-rank NCCL group, with deterministic cuDNN in (a) and (b). (a)
   ``resnet18_cifar100`` at full width (bf16, batch 256, SyncBN, fused
   SGD; 20 steps on 5,120 synthetic images, no eval) through
   ``Trainer.fit``, plain and with ``shard_weight_update``, from the same
   weights: the same losses bit for bit (at one rank the shard is the
   whole raveled vector and its update the plain update), 1 fused SGD
   launch a step on the flat shard of 11,220,132 f32, one reduce-scatter
   and one all-gather a step and no gradient all-reduce; step ms and peak
   memory of both. (b) The same run on the ``bf16``, ``int8`` and
   ``int8_ef`` wires: losses against ``none`` within 5% relative at every
   step, step ms beside ``none``'s, non-zero residual norms; the reduce
   alone (``compressed_pmean`` of ResNet-18's 62 gradient leaves, device
   ms with a head start) against NCCL's all-reduce of the same 11.2 M f32;
   and the ``int8_ef`` run stopped by ``sigterm@epoch=0:step=9`` and
   resumed: its 10 + 10 losses are the uninterrupted run's bit for bit.
   (c) ``resnet18_cifar100_fused`` on the ``int8_ef`` wire: one epoch of
   195 steps (``state.step`` 195), 195 fused SGD launches, non-zero
   residuals; then graph replay against the eager step, f32, as phase 6
   (f). ((d), ``python -m tpu_dist_torch.elastic.drill --shrink_device
   cuda``, was cut to keep the run inside its bound with phase 21: phase
   11 (d)'s fleet drill shrinks onto the card and grows back through the
   same remap, and ``tests/test_torch_elastic_drill.py`` runs the drill on
   the CPU.) The fused SGD kernel at the flat shard's shape is timed in
   phase 6, before any CUDA child: 3 steps bit for bit, device ms in turns
   with ``torch.optim.SGD(fused=True)`` on the one leaf, the plain
   version's period and the bound (``*_zero1_flat`` in the kernels line).
11. elastic supervision: the launcher's elastic supervisor over the
   trainer's CLI, after phase 10 (every part starts CUDA children):
   ``python -m tpu_dist_torch.cli.launch --nproc 1 --elastic_min_procs 1``
   over ``bench.py:240``'s ``resnet18_cifar100`` shapes (full width, 100
   classes, batch 256, bf16, SyncBN, fused SGD; 20 steps on 5,120
   synthetic images, no eval), each child printing every step's loss, its
   restore's span, its fused SGD launches and its ``fleet.decision_id``
   gauge. (a) A golden run, then the supervised run with
   ``sigterm@epoch=0:step=9`` in its command and an allocation file
   ``1 decision=7 cause=goodput`` under a 0.5 s probe: round 0 exits 75
   after 10 steps, the supervisor relaunches it at world 1 with
   ``--resume`` and ``TPU_DIST_ELASTIC_RESTARTS=1`` (the clause does not
   fire again: the resumed epoch starts at step 10), and the launcher exits
   0; 10 + 10 fused SGD launches; the losses equal to the golden run's bit
   for bit (``--seed`` makes cuDNN deterministic); the decision in the
   resume record, the gauge and the flight ring's ``resume`` entry; both
   runs write a history and a textfile, and the relaunched child a
   heartbeat, which phase 12 (a) reads;
   ``[elastic-sup]`` lines split the seconds from round 0's exit to the
   relaunched child's first step into the backoff, the process start and
   the restore. ((b), a lost rank the launcher gives up on, and (c), the
   launcher's own SIGTERM, were cut to keep the run inside its bound with
   phase 21: each was a CUDA child of its own, and
   ``tests/test_torch_launch_elastic.py`` runs both on stub children.)
   (d) ``python -m tpu_dist_torch.fleet.drill --phase grow --device cpu
   --shrink_device cuda --devices 3``: golden and full-size rounds as 3
   gloo ranks, the shrunken round on the card, held at its epoch's last
   step until the probe's SIGTERM; it must exit 0 with ``PASS grow``, its
   two resume records both ``resharded`` (3 -> 1 -> 3) and each epoch's
   loss gap printed. The report repeats phase 11's result lines.
12. goodput, the hub and the tenancy day, after phase 11 (its parts start
   CUDA children). (a) Phase 11 (a)'s golden and supervised histories hold
   ``goodput`` records whose buckets sum to each window's and each
   segment's wall clock (1e-3: 10 terms rounded to 4 decimals); the
   supervised run's ledger over its two segments charges the relaunch gap
   to ``preempt_s``, and that gap, reduced to the span of phase 11's
   relaunch gap, agrees with it within 0.5 s; a ``TelemetryHub`` pass over
   the relaunched child's textfile and heartbeat, once its epoch's window
   has closed, renders a page with ``run="trainer"`` labels and its
   ``goodput_frac``. ``[goodput]`` lines. (b) ``python -m
   tpu_dist_torch.fleet.tenancy_drill --phase hub --device cpu
   --shrink_device cuda --devices 2 --shrink_to 1 --fused_optimizer
   --epochs 3 --steps_per_epoch 3 --kill_step 0``: the recorded day's
   policy replay, then the day against the trainer (``vit_tiny``, ZeRO-1,
   cut from the drill's 4 epochs of 8 steps to its CPU test's depth) with
   2 gloo ranks at full size and the shrunken round on the card; it must
   exit 0 with its PASS lines, the shrunken round's fused SGD launches
   (ZeRO-1's flat shard) one a step it ran, the preemption's latency (the
   allocation's shrink, the SIGTERM, exit 75) and the decision chain on
   ``[tenancy]`` lines. (Its ``--phase replica`` on the card, a supervised
   ViT-B/16 replica SIGKILLed and relaunched with the same digest, was cut
   to keep the smoke inside its bound with phase 18: phase 8 drives the
   same crash, bundle and relaunch of the supervised replica on the card.)
   The report repeats phase 12's result lines.
13. health and profiler, after phase 12 (it starts CUDA children, and
   reuses phase 11 (a)'s golden run). ``compute_device_stats`` on the card
   against f64 host arithmetic, with a NaN and an inf leaf counted. (a)
   Phase 11 (a)'s golden command (``resnet18_cifar100``, 20 steps, seeded)
   with ``--device_metrics --log_every 1 --anomaly_action warn
   --straggler_threshold 0.5 --profile_dir D --profile_steps 5:8
   --log_file H``: its 20 losses equal the golden run's bit for bit, 20
   fused SGD launches, the golden run's ``comm.*`` counts; 20
   ``device_stats`` records with finite, positive norms and ratio and no
   non-finite leaf; one ``straggler`` record (skew 1.0, rank 0); the
   ``profile`` start and stop at global steps 5 and 8; a
   ``profile_analysis`` record (the capture taken and read back inside
   the child) with busy seconds whose categories sum to it within 1e-6,
   and to the card's busy time read from the raw trace apart from xprof
   (each stream's kernel, memcpy and memset intervals merged) within
   1e-5 s; no ``profile.errors`` or ``xprof.analyze_errors``. (b) ``python -m
   tpu_dist_torch.obs xprof D --format json``: exit 0, the
   ``fused_sgd_kernel`` 3 times (one a captured step), cuDNN convolution
   kernels in ``matmul_conv``; ``python -m tpu_dist_torch.obs summarize
   H``: exit 0 with the capture attribution block. (c) Two poisoned runs
   of 8 steps side by side: ``--fault_plan nan_loss@epoch=0:step=4`` (the
   fault reports the NaN after step 4, before its fetch: device_stats of
   steps 0-3, no finding) and ``--lr inf`` (the first update writes inf
   and NaN into the weights: step 1's ``nonfinite_loss`` and
   ``nonfinite_grads`` findings are logged before the NaN guard raises);
   each exits 1 with the JAX trainer's message. ``[health]`` lines: the
   step p50 with and without ``--device_metrics`` and inside and outside
   the capture window, the peak memory with and without, the capture's
   bytes and split, the read-back's seconds. (a') The flag's work a step
   at ResNet-18's 62 leaves (the parameters' copy and the scalars), device
   ms with a head start and host us. (The golden command with
   ``--device_metrics`` alone, a CUDA child, was cut to keep the run inside
   its bound: (a) holds the flag's losses to the golden run's, and
   ``obs/health_cost.py`` measures its cost a step.)
14. the memory ledger, the cost model and the trace export, after phase 13
   (CUDA children; it reuses phase 11 (a)'s golden run). (a) The golden
   command with ``--memory_check warn --log_file H --trace_file T``: its 20
   losses equal the golden run's bit for bit, 20 fused SGD launches; one
   ``memory`` record whose reconciliation is the allocator's and exact
   (``attributed + unattributed == bytes_in_use``), whose static ledger
   holds at least the parameters' 44,880,528 bytes a device and whose
   ``xla`` section (the first step measured by the allocator) peaks at or
   above its entry; ``mem.headroom_frac`` in (0, 1); the epoch's ``mfu``
   in (0, 1), printed beside its prediction; ``device.flops_per_step``
   within 1% of 2.888e9 x 256; the chip table's HBM row equal to the
   card's ``total_memory``; T a Chrome trace with the trainer's host
   spans; ``python -m tpu_dist_torch.obs memory H`` and ``export-trace H``
   exit 0. (b) ``Trainer`` over the golden command with ``--memory_check
   refuse --hbm_budget_bytes <static - 1>`` (a's ledger), built in this
   process, raises ``InfeasibleMemoryError`` at construction with no
   kernel launched. (c) A child whose allocator the smoke caps
   (``torch.cuda.set_per_process_memory_fraction``, not a flag of the
   program) halfway between (a)'s first-step entry and peak: it dies of
   ``torch.OutOfMemoryError`` in the first step, ``crash_dir`` holds
   ``oom.json`` with a ledger snapshot and a parsed ``requested_bytes``,
   and ``obs postmortem`` gives the ``oom`` verdict. (d) One ViT-B/16 step
   (batch 8, bf16) through ``make_train_step`` with the flash kernels (12
   launches of each, 1 fused SGD) and one with the plain attention, each
   counted by ``step_cost``: their FLOPs agree within 0.1%; then the
   count's own cost, ResNet-18 steps plain and counted in turns.
   ``[memory]`` lines; the report repeats them.
15. sequence parallelism, in this process after phase 14. (a) The ring
   flash composition (``ops/flash_attention.py``, kernels #1-#3 around a
   K/V ring) at full width in a one-process lockstep ring of 4 virtual
   ranks: ViT-B/16 at 1,024 px's attention, batch 8 x 12 heads, S = 4,096
   (1,024 tokens a rank), D 64, in bf16 and f32, causal and not.
   ``ring_flash_lockstep`` drives the port's own rotation bodies for every
   rank, round by round, handing each rank's K/V (and dK/dV) blocks to the
   next in place of the P2P; launch counts are set to 0 just before and
   read just after: 16 of each of #1-#3 non-causal, 10 causal (a masked
   rotation launches nothing), on the tensor cores for bf16. The outputs
   and gradients against the same loop over the plain versions and against
   ``flash_fwd``/``flash_bwd`` on the gathered 4,096-token sequence (max
   error over max value, 2e-2 bf16, 1e-4 f32), and a pass's device ms. (b)
   The SP train step at full width with a seq group of one
   (``comm/mesh.py::seq_axis(1)``): ViT-B/16 at 1,024 px, batch 8, bf16,
   flash, fused SGD, through ``make_train_step`` without a seq group, with
   ``sp_mode`` ring and with ulysses, from the same weights and batches:
   3 steps whose losses are held (the ring's within 2e-3 relative of the
   plain step's, Ulysses' equal) and 8 steps at lr 0 timed by host laps:
   132 launches of each of #1-#3, all on the tensor cores, and 11 of #4
   each; peak memory. Then, in a fresh process, one step of each variant
   under ``torch.profiler``, whose device busy and flash kernels' time
   ``obs/xprof.py`` reads (every one of the step's 36 flash launches in
   the trace; not counted on the main path). (c), run before (b):
   #1-#3 and ``F.scaled_dot_product_attention`` (forward; the whole
   backward) at [96, 4096, 64] bf16, device ms with a head start and their
   bounds. ``[seq]`` lines; the report repeats them.
16. tensor and expert parallelism, in this process after phase 15. (b),
   run first: a lockstep TP group of 4 virtual ranks at ViT-B/16's full
   width (``nn/vit.py::tp_lockstep_forward``: 3 local heads a rank, each
   block running every shard and summing their partial outputs where
   ``reduce_from_tp`` would), batch 8, bf16 and f32 (TF32 off): one
   forward and backward and each rank's fused SGD update, counted: 48 of
   each of #1-#3 (at BH = 24, on the tensor cores for bf16) and 4 of #4;
   the gathered gradients against the unsharded model's (max error over
   max value a leaf: 5e-2 bf16, 1e-4 f32) and the loss (2e-3 bf16, 1e-5
   f32); each rank's updated shards and buffers against the plain SGD
   update of the same leaves and gradients, bit for bit; a pass's ms.
   Over a 1-rank NCCL group: (a) 3 bf16 steps of
   ViT-B/16 (flash, fused SGD) through ``make_train_step(tp_axis=)`` over
   a model group of one (``comm/mesh.py::tp_mesh(1)``) against the plain
   step, losses bit for bit; 36 of each of #1-#3 and 3 of #4. (c)
   ``vit_moe_tiny``, f32, flash at D = 16, fused SGD, at ``moe_top_k`` 1
   and 2: 3 steps of the EP step over an expert group of one against the
   dense step (losses within 1e-5 relative), 6 of each of #1-#3 and 3 of
   #4 each; then a lockstep expert group of 4 (``MoE.apply_ep_lockstep``,
   the exchange a permutation of the slot blocks) against ``apply_dense``
   on each rank's tokens (1e-5). (d) one TP step and the plain step, in
   turns, and one MoE step, device ms back to back, with the card's name
   and power limit. ``[mp]`` lines; the report repeats them.
17. pipeline parallelism, in this process after phase 16. (a) A lockstep
   pipe group of 4 virtual stages at ViT-B/16's full width
   (``nn/vit_pp.py::pipeline_lockstep_forward``: every stage in this
   process, the schedule handing each output to the next stage where the
   P2P would), batch 32, bf16 and f32 (TF32 off), GPipe with 3 blocks a
   stage and M = 8, and the interleaved schedule 4 x 3 (12 chunks of one
   block) with M = 4: one forward and backward and each stage's fused SGD
   update, counted: 12 x M of each of #1-#3 (no bubble tick launches; on
   the tensor cores for bf16) and 4 of #4; the gathered gradients and the
   updated weights against the unsharded model's (max error over max
   value a leaf: 5e-2 bf16, 1e-4 f32), the loss (2e-3 bf16, 1e-5 f32), each
   stage's update against the plain SGD update bit for bit, the bubble
   fraction and each stage's parameter bytes, a pass's ms. Over a 1-rank
   NCCL group: (b) 3 bf16 steps of ViT-B/16 (flash, fused SGD, batch 32)
   through ``make_train_step(pp_axis=)`` over a pipe group of one
   (``comm/mesh.py::pp_mesh(1)``) at M = 1 (losses the plain step's bit for
   bit; 36 of each of #1-#3) and M = 4 (within 2e-3; 144 each), 3 of #4
   each; then the plain step and both, in turns, device ms back to back
   and peak memory, with the card's name and power limit. ``[pp]`` lines;
   the report repeats them.
18. the sharded checkpoint format and FSDP, in this process after phase
   17, with no CUDA child. (a) ViT-B/16's state (86,566,120 f32 parameters
   and random momentum) over a 1-rank NCCL group: a plain save, a sync
   ``save_sharded``, an async one (its blocking snapshot timed apart from
   its drain), a deep ``verify_sharded`` and a ``restore_sharded`` into a
   state of other weights, which must equal the live state bit for bit;
   the async file's entries equal the sync one's, and the sharded file's
   pieces assemble to the plain file's arrays. ms and bytes of each. (b) A
   lockstep FSDP group of 4 virtual ranks at ViT-B/16's width, batch 32,
   f32 (TF32 off) and bf16: one step against the plain step from the same
   weights (the gathered parameters within 1e-5 and 2e-3 of each leaf's
   largest value), each virtual rank's parameter and momentum bytes beside
   a quarter of the whole, the ranks' pieces assembling to the plain
   checkpoint's arrays bit for bit, and no launch of #1-#4 (dense
   attention, plain SGD). (c) ``Trainer.fit`` under ``--fsdp
   --sharded_ckpt`` at ResNet-18's bench shapes over a 1-rank NCCL group,
   4 steps, a save, then ``Trainer(resume=True)``: finite losses, a
   manifest and one shard file, the resumed state the saved one bit for
   bit. ``[fsdp]`` lines; the report repeats them.
19. ZeRO-1 under the seq axis and the rest of the telemetry, in this
   process after phase 18, with no CUDA child. Over a 1-rank NCCL group:
   (a) ``vit_b16_1024px_flash``'s shapes (ViT-B/16 at 1,024 px, batch 8,
   bf16, flash, ring) through ``make_train_step(seq_axis=seq_axis(1),
   axis=data_axis(1), shard_weight_update=True)`` with the fused SGD, 3
   steps, against the same step without ZeRO-1 from the same weights and
   batches: losses bit for bit (one rank: the flat update is the per-leaf
   update of the same gradients); 12 of each of #1-#3 a step, all on the
   tensor cores, and 1 of #4 a step on the flat shard; the gradients
   meaned over the seq axis, reduce-scattered and the parameters
   all-gathered over the data axis once a step. The state through
   ``train_state_to_flat(dst=0)``, a plain save and restore, and a sync and
   an async ``save_sharded`` with ``restore_sharded``, each gathered over
   the data axis and restored into a fresh ZeRO-1 state bit for bit; ms
   and bytes of each. (b) ``Trainer.fit`` at ResNet-18's bench shapes
   with ``--shard_weight_update --fused_optimizer --debug_replica_check
   --tensorboard_dir --log_file --heartbeat_file --crash_dir``, 2 epochs of
   3 steps: the replica check passes at every epoch's end, ``obs
   postmortem`` gives rank 0 ``clean``, the event file decodes
   to the trainer's tags at their steps, ``obs tail --once`` and ``obs
   pod`` over the log and a second per-host copy exit 0, ``obs archive
   ingest`` appends nothing on a second ingest, ``obs trend
   --inject-regression`` and ``compare --against-archive`` of the log
   against its own band exit 0. The fit's last epoch record becomes two
   ``bench.py``-schema records (its images/s as ``value``, its step time
   as ``step_ms``, the card's name and power limit as ``hardware``, each
   its own capture, under a metric that names the smoke, not a benchmark
   cell): ``obs summarize --bench`` exits 0, ``compare --bench`` of the
   second capture against the first exits 0, against a copy with
   ``value`` halved 1, and a copy that re-emits the first's capture is
   STALE (exit 2: nothing compared). ``[zero1-sp]`` lines; the report
   repeats them.
20. analysis, in this process after phase 19, with no CUDA child, over a
   1-rank NCCL group (the CLI runs on the group it finds): (a) ``python -m
   tpu_dist_torch.analysis shard --inject-reshard`` over every family that
   fits one card (the 8 data-parallel ones, fsdp, serve_eval): exit 0,
   TD116/TD117 clean, each family's executed inventory by kind the one the
   CPU tests pin at one rank (``tests/test_torch_shardlint.py::WORLD1``),
   and the injected raw all-gather caught (TD117). (b) ``tune-overlap
   --inject-payload`` and ``plan --from-report --tune-report
   --inject-miscost`` from it: exit 0, every knob TD121-clean, the plan
   TD118-verified against a fresh run of its family, both probes caught.
   (c) ``Trainer.fit`` at ResNet-18's bench shapes, 3 steps under
   ``--seed``, with ``--auto_shard apply --tune_report`` (b)'s report (no
   ``--fused_optimizer``: a chosen ``fsdp`` refuses it, as a hand-written
   config would be refused), then
   the same fit with the chosen family's flags and the applied knobs set by
   hand: losses and final state bit for bit. Each part's seconds, the
   chosen family and its ``predicted_step_s``; the fused SGD's launches
   (one a proxy step of each SGD family on the card, and the fits') count
   into the kernels line. ``[analysis]`` lines; the report repeats them.
21. audit, in this process after phase 20, with no CUDA child, over a
   1-rank NCCL group: (a) the AST lint of ``tpu_dist_torch`` (TD001-TD008):
   0 new findings with the shipped (empty) baseline; its seconds and the
   findings its inline suppressions hold, by rule. (b) every audit case
   (``analysis/step_audit.py``: the 9 data-parallel steps and the 4 fused
   epochs of 2 steps) TD101-TD103 clean on the card and TD104 over them,
   with the fused SGD's launches of each traced call read off its trace:
   one a step (two in a fused epoch), and one NCCL c10d op a call (the
   executed side, as the CPU tests pin it on gloo); a fused epoch of 5 steps (3 eager, a
   capture, 2 replays) under a trace books 5 steps' collectives and 5
   launches, with no host read; a ``.cpu()`` planted in a step is caught
   (TD102). (c) every no-op probe (TD105-TD115, TD120, TD122-TD124) clean
   on the card, each timed; a planted leak (a fault plan that launches one
   extra fused SGD kernel inside the step) caught by TD105. (d) the
   default command (``python -m tpu_dist_torch.analysis``, lint and audit,
   in process on the group) exits 0. The fused SGD's launches of the
   phase count into the kernels line. ``[audit]`` lines; the report
   repeats them.
22. report: the card's name and power limit, one JSON line of every ported
   kernel (device ``ms`` and ``host_us`` of the kernel, and of the library
   call as ``library_ms`` and ``library_host_us``; phase 15's at S = 4,096
   as ``*_s4096``), and the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ast
import concurrent.futures
import dataclasses
import gzip
import json
import math
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dist_torch import bridge
from tpu_dist_torch import ckpt as ckpt_lib
from tpu_dist_torch.comm import mesh as mesh_lib
from tpu_dist_torch.config.config import TrainConfig
from tpu_dist_torch.data import native, transforms
from tpu_dist_torch.nn import resnet as resnet_lib
from tpu_dist_torch.nn import vit, vit_moe, vit_pp
from tpu_dist_torch.nn.vit import vit_b16
from tpu_dist_torch.obs import costmodel
from tpu_dist_torch.obs import counters as counters_lib
from tpu_dist_torch.obs import fused_sgd_bench, timing
from tpu_dist_torch.obs import memory as memory_lib
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import fused_sgd as fs
from tpu_dist_torch.parallel import fsdp as parallel_fsdp
from tpu_dist_torch.parallel import pipeline
from tpu_dist_torch.resilience.preemption import PREEMPTION_EXIT_CODE, PreemptedError
from tpu_dist_torch.comm import collectives
from tpu_dist_torch.comm.quantize import padded_len
from tpu_dist_torch.elastic import elastic_stamp
from tpu_dist_torch.metrics.history import MetricsHistory
from tpu_dist_torch.obs import export as export_lib
from tpu_dist_torch.obs import flight as flight_lib
from tpu_dist_torch.obs import goodput as goodput_lib
from tpu_dist_torch.serve.engine import ServingEngine, batch_buckets, load_serving_state
from tpu_dist_torch.train import epoch as epoch_lib
from tpu_dist_torch.train import optim, state as state_lib, step as step_lib
from tpu_dist_torch.train import trainer as trainer_lib
from tpu_dist_torch.cli import train as train_cli

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_F32_FLOPS = 67e12       # CUDA cores, f32 (the kernel's products)
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 inputs
PEAK_TF32_FLOPS = 495e12     # tensor cores, TF32 inputs (the f32 forward's 3xTF32)
PEAK_BYTES_PER_S = 3.35e12   # HBM3

DEVICE = "cuda"  # every tensor of the run lives on the card
SERVE_MAX_BATCH = 8
SERVE_REQUESTS = 32
SERVE_SEED = 0
IMAGE = (224, 224, 3)
VIT_B16_FWD_SHAPE = (SERVE_MAX_BATCH * 12, 196, 64)  # [BH, S, D] of one full batch

# (max |kernel - plain|) limits: err <= atol + rtol * |plain|.
# f32: both sum in f32 but in another order (64-key tiles with online
#   rescaling vs one softmax over the row; expf vs torch.exp), a few ulps.
# bf16 out: both round nearly the same f32 value to bf16, so they differ
#   by one bf16 step (at most 2^-7 relative) where the f32 values straddle
#   a rounding boundary; two steps are allowed, plus the f32 floor for
#   values near 0, where one f32 ulp of difference can flip several bf16
#   steps. m and l stay f32.
TOL = {
    "out_f32": (2e-5, 1e-5),
    "out_bf16": (2e-5, 2 ** -6),
    "m": (2e-5, 1e-5),
    "l": (0.0, 2e-5),
}
# The backward kernels against their plain versions, same rule. f32: both
# sum the same f32 products in another order (64-row tiles in registers vs
# one cuBLAS product over the whole row, expf vs torch.exp), and
# dS = P (dP - delta) subtracts two O(sqrt(D)) terms, so the gradients
# (|g| up to ~10) agree to a few ulps of that size. bf16 out: as above,
# two bf16 steps plus the f32 floor.
TOL_BWD = {"f32": (1e-4, 1e-4), "bf16": (1e-4, 2 ** -6)}
# The tensor-core route (bf16 inputs) against plain versions that round P
# (forward) and P, dS (dK/dV) to bf16 where the kernels do. Products of
# bf16 values are exact in f32 on both sides, so what differs is f32
# summation order and expf vs torch.exp, which can flip one bf16 step
# (2^-8 relative) of a P or dS element. The forward also rounds P against
# the running row max of its 64-key tiles, the plain version against the
# final max, so a row's early tiles round other values: up to one bf16
# step of each such P element. out is a convex combination of v rows
# (|v| <~ 5 here), so these steps, of random sign over ~100 keys, move it
# by ~1e-3: atol 4e-3 (one bf16 step of a unit value), plus two bf16 steps
# of the result for bf16 out or one for f32 out. m and l are f32 and keep
# TOL. dK/dV and dQ see only the flips (P and dS from the final m, l, and
# the plain versions round dS for dQ as for dK): each moves a gradient by
# 2^-8 |p do|, 2^-8 |ds q| or 2^-8 |ds k|, ~1e-4 apiece: atol 1e-3, plus
# the same steps of the result.
TOL_MMA = {"out_f32": (4e-3, 2 ** -8), "out_bf16": (4e-3, 2 ** -6)}
TOL_BWD_MMA = {"f32": (1e-3, 2 ** -8), "bf16": (1e-3, 2 ** -6)}
# ViT-B/16 logits, flash vs xla attention on the card: the attention
# outputs differ by f32 rounding (~1e-6) and 12 blocks carry that on.
LOGITS_TOL = (1e-3, 1e-3)

TRAIN_BATCH = 64               # vit_b16_imagenet_flash (bench.py): global batch 64
TRAIN_SHAPE = (TRAIN_BATCH * 12, 196, 64)  # [BH, S, D] of one training step
TRAIN_LR = 0.1
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
PARITY_BATCH, PARITY_STEPS = 8, 3
# f32 parity, flash + fused SGD vs xla + plain SGD from the same weights:
# the attention and its gradients differ by f32 rounding (~1e-6 relative,
# the kernels above), which 12 blocks and 3 steps carry into the loss at
# ~1e-6 relative and into the updates at ~1e-5 of their size; the fused and
# plain SGD are bit-identical. Limits: the loss to 1e-4 relative, and each
# parameter's difference to 1e-3 of that parameter's largest update over
# the 3 steps (plus 1e-6 for parameters that barely move).
PARITY_LOSS_RTOL = 1e-4
PARITY_PARAM_RTOL, PARITY_PARAM_ATOL = 1e-3, 1e-6
# bf16 parity, the same two paths at bf16 compute. Everything but the
# attention is the same code, so they differ only where the two attentions
# round: xla rounds the scores and the normalised probabilities to bf16,
# flash keeps f32 scores and rounds the unnormalised P. That is rounding
# placement, as between the JAX and the port's bf16 steps, whose one-step
# loss the CPU test holds to 2e-3 relative
# (tests/test_torch_train_step_variants.py::test_one_bf16_step_matches_jax_loosely);
# the same limit holds here for each of the 3 steps.
PARITY_BF16_LOSS_RTOL = 2e-3

KERNELS = {
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/flash_attention_fwd.cu",
        "replaces": "tpu_dist/ops/flash_attention.py:152",
    },
    "flash_attention_bwd_dkdv": {
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/flash_attention_bwd_dkdv.cu",
        "replaces": "tpu_dist/ops/flash_attention.py:350",
    },
    "flash_attention_bwd_dq": {
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/flash_attention_bwd_dq.cu",
        "replaces": "tpu_dist/ops/flash_attention.py:376",
    },
    "fused_sgd": {
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/fused_sgd.cu",
        "replaces": "tpu_dist/ops/fused_sgd.py:84",
    },
}
# each kernel's launch count, on its wrapper
WRAPPERS = {
    "flash_attention_fwd": fa.flash_fwd,
    "flash_attention_bwd_dkdv": fa.flash_bwd_dkdv,
    "flash_attention_bwd_dq": fa.flash_bwd_dq,
    "fused_sgd": fs.fused_sgd,
}
# the kernels with a tensor-core route for bf16 inputs (a second count,
# ``launches_mma``, on the wrapper); each library holds 8 instances of
# each route (2 output dtypes x 4 head dims), and the kernel functions
# named here must show tensor-core instructions in every instance: the
# bf16 route's, and the f32 forward's 3xTF32 kernel
MMA_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
MMA_INSTANCES = 8
TENSOR_CORE_FUNCTIONS = {
    "flash_attention_fwd": ("flash_fwd_mma_kernel", "flash_fwd_kernel"),
    "flash_attention_bwd_dkdv": ("dkdv_mma_kernel",),
    "flash_attention_bwd_dq": ("dq_mma_kernel",),
}
TENSOR_CORE_OPS = ("HMMA", "HGMMA")


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in MMA_KERNELS:
        WRAPPERS[name].launches_mma = 0


def read_mma_launches() -> dict:
    return {name: WRAPPERS[name].launches_mma for name in MMA_KERNELS}


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


PLAN_COUNTS = {}  # model: (hits, misses) of the fused SGD's plan cache on its main path


def reset_plan_counts() -> None:
    fs.PLANS.hits = fs.PLANS.misses = 0


def read_plan_counts(model: str, tag: str) -> None:
    """Hits (leaves unmoved since a validated call: the plan is reused) and
    misses (leaves validated and planned anew) of the fused SGD's plan cache
    since :func:`reset_plan_counts`."""
    hits, misses = PLAN_COUNTS[model] = fs.PLANS.hits, fs.PLANS.misses
    print(f"[{tag}] fused_sgd plan cache over these steps: {hits} hits, {misses} misses "
          f"(hit share {hits / max(hits + misses, 1):.3f})")


class SmokeError(AssertionError):
    """A phase of the smoke run failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, iters: int = 50, warmup: int = 5, head_start: bool = True):
    """(device ms, host us) a call of ``fn`` (``obs/timing.py::device_ms``;
    inputs stay L2-warm, as they are when the model produces them just
    before). With the head start (every kernel and library call) the device
    sleeps until the host has queued all ``iters`` calls, so the events read
    device time only; a late host's reading is taken again, and a host late
    in three readings fails the run. Without it (the plain versions: their hundreds of eager launches a
    call would fill the launch queue behind the sleep) the events read the
    period of back-to-back calls, the host's pace where that is slower."""
    return timing.device_ms(fn, iters, warmup, head_start)


def bound(nbytes: float, flops: float, peak_flops: float):
    """(least milliseconds, what bounds it): the larger of the bytes over
    the HBM rate and the operations over the peak for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _peak(dtype) -> float:
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS


def flash_bound(bh: int, s: int, d: int, dtype=torch.float32):
    """One non-causal flash forward: q, k, v read once, out (in their
    dtype), m, l (f32) written once; its two products, 4 * BH * S^2 * D
    operations."""
    item = torch.finfo(dtype).bits // 8
    return bound(item * 4 * bh * s * d + 4 * 2 * bh * s, 4 * bh * s * s * d, _peak(dtype))


def flash_bound_3xtf32(bh: int, s: int, d: int):
    """The f32 forward as its kernel runs it: the bytes of
    :func:`flash_bound`, and each of the two products as three TF32
    products on the tensor cores (3 * 4 * BH * S^2 * D operations)."""
    return bound(4 * 4 * bh * s * d + 4 * 2 * bh * s, 3 * 4 * bh * s * s * d, PEAK_TF32_FLOPS)


def _library_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches (torch.profiler),
    to show which backend served a library call; [] where the profiler
    records none."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if str(e.device_type).endswith("CUDA")})


def flash_bwd_bounds(bh: int, s: int, d: int, dtype):
    """The two non-causal backward passes: each reads q, k, v, do (in their
    dtype) and m, l, delta (f32) once; dK/dV writes two gradients and does
    four products (8 * BH * S^2 * D operations), dQ writes one and does
    three (6 * BH * S^2 * D)."""
    item = torch.finfo(dtype).bits // 8
    reads = item * 4 * bh * s * d + 4 * 3 * bh * s
    grad = item * bh * s * d
    return {
        "flash_attention_bwd_dkdv": bound(reads + 2 * grad, 8 * bh * s * s * d, _peak(dtype)),
        "flash_attention_bwd_dq": bound(reads + grad, 6 * bh * s * s * d, _peak(dtype)),
    }


def sgd_bound(n: int):
    """p, g, b read once and p, b written once (20 bytes a parameter); six
    f32 operations a parameter."""
    return bound(20 * n, 6 * n, PEAK_F32_FLOPS)


# -- phase 1 -----------------------------------------------------------------


def phase_build() -> None:
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    check(sorted(KERNELS) == names, f"csrc sources {names} vs kernels {sorted(KERNELS)}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        host = ex.submit(_build.build_host, native.NAME)  # the input pipeline's C++
        results = dict(zip(names, ex.map(_build.build, names)))
        host_path, host_s, host_log = host.result()
    print(f"[build] {native.NAME}.cpp ({_build.cxx()}): {host_s:.1f} s -> {host_path.name}"
          + (f"\n{host_log.strip()}" if host_log.strip() else ""))
    for name, (path, seconds, log) in results.items():
        print(f"[build] {name}: {seconds:.1f} s -> {path.name}")
        for fn, regs, spill in _ptxas_entries(log):
            print(f"[build]   {fn}: {regs} registers, {spill} bytes spilled")
    print(f"[build] all sources: {time.perf_counter() - t0:.1f} s wall")
    tool = _cuobjdump()
    for name, (path, _, _) in results.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                              check=True).stdout
        counts = _sass_tensor_core_counts(sass)
        for fn, ops in counts.items():
            print(f"[build]   {fn}: " + ", ".join(f"{n} {op}" for op, n in ops.items()))
        if name in MMA_KERNELS:
            _check_tensor_core_instances(name, counts)


def _demangle(names):
    """Kernel instance names as C++ (``c++filt``, where it exists), without
    ``void``, the parameter list and the anonymous namespace."""
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout.splitlines()
        if len(out) == len(names):
            return [re.sub(r"^void |\(.*\)$", "", n.replace("(anonymous namespace)::", ""))
                    for n in out]
    return list(names)


def _ptxas_entries(log: str):
    """(kernel instance, registers, spill-store bytes) from ``-Xptxas -v``,
    names demangled where ``c++filt`` exists."""
    entries = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entries.append([m.group(1), None, 0])
        elif entries and (m := re.search(r"(\d+) bytes spill stores", line)):
            entries[-1][2] = int(m.group(1))
        elif entries and (m := re.search(r"Used (\d+) registers", line)):
            entries[-1][1] = int(m.group(1))
    for e, name in zip(entries, _demangle([e[0] for e in entries])):
        e[0] = name
    return entries


def _cuobjdump() -> str:
    """``cuobjdump`` of the toolkit whose ``nvcc`` built the kernels."""
    path = shutil.which("cuobjdump", path=str(pathlib.Path(_build.nvcc()).parent))
    check(path is not None, f"no cuobjdump beside {_build.nvcc()}")
    return path


def _sass_tensor_core_counts(sass: str) -> dict:
    """{kernel instance: {"HMMA": n, "HGMMA": n}} from ``cuobjdump -sass``:
    the tensor-core instructions in each function's code (``HMMA`` from
    ``mma.sync``, ``HGMMA`` from ``wgmma``), names demangled."""
    counts = {}
    ops = None
    for line in sass.splitlines():
        if m := re.match(r"\s*Function\s*:\s*(\S+)", line):
            ops = counts.setdefault(m.group(1), dict.fromkeys(TENSOR_CORE_OPS, 0))
        elif ops is not None:
            for op in TENSOR_CORE_OPS:
                ops[op] += len(re.findall(rf"\b{op}\b", line))
    return dict(zip(_demangle(list(counts)), counts.values()))


def _check_tensor_core_instances(name: str, counts: dict) -> None:
    """The library of a kernel with a tensor-core route holds the 8
    instances of each route, and every instance of a function in
    ``TENSOR_CORE_FUNCTIONS[name]`` has tensor-core instructions."""
    funcs = TENSOR_CORE_FUNCTIONS[name]
    # the function's name ends at "<" (demangled) or "I" (mangled)
    mma = {fn: ops for fn, ops in counts.items()
           if any(re.search(rf"(?<![a-z_]){f}[<I]", fn) for f in funcs)}
    want = MMA_INSTANCES * len(funcs)
    check(len(mma) == want and len(counts) == 2 * MMA_INSTANCES,
          f"{name}: {len(mma)} tensor-core instances of {len(counts)}, expected "
          f"{want} of {2 * MMA_INSTANCES}: {sorted(counts)}")
    bare = [fn for fn, ops in mma.items() if sum(ops.values()) == 0]
    check(not bare, f"{name}: no tensor-core instruction in {bare}")


# -- phase 2 -----------------------------------------------------------------


def _err(a, b, atol, rtol):
    """(max |a - b|, ok) with ok iff |a - b| <= atol + rtol * |b| everywhere."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return diff.max().item(), bool((diff <= atol + rtol * b.abs()).all())


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    bh, s, d = VIT_B16_FWD_SHAPE
    cases = [
        # name, (BH, S, D), causal, input dtype, out_dtype
        ("vit_b16 f32", (bh, s, d), False, f32, None),
        ("vit_b16 f32 causal", (bh, s, d), True, f32, None),
        ("vit_b16 bf16", (bh, s, d), False, bf16, None),
        ("vit_b16 bf16 in, f32 out", (bh, s, d), False, bf16, f32),
        ("ragged S=77 D=32", (24, 77, 32), False, f32, None),
        ("ragged S=77 D=128 causal", (24, 77, 128), True, f32, None),
        ("ragged S=77 D=16 bf16 causal", (24, 77, 16), True, bf16, None),
        ("S=5 D=64 causal (one partial tile)", (4, 5, 64), True, f32, None),
        # the tensor-core route at every head dim, ragged and causal
        ("bf16 S=77 D=32", (24, 77, 32), False, bf16, None),
        ("bf16 S=77 D=64 causal, f32 out", (24, 77, 64), True, bf16, f32),
        ("bf16 S=77 D=128 causal", (24, 77, 128), True, bf16, None),
        ("bf16 S=196 D=128, f32 out", (24, 196, 128), False, bf16, f32),
        ("bf16 S=5 D=16 (one partial tile)", (4, 5, 16), False, bf16, None),
        ("bf16 S=5 D=64 causal", (4, 5, 64), True, bf16, None),
        ("bf16 S=300 D=64 causal (5 tiles)", (8, 300, 64), True, bf16, None),
        # the f32 route at phase 16 (c)'s shape (vit_moe_tiny)
        ("vit_moe_tiny f32 S=64 D=16", MP_MOE_SHAPE, False, f32, None),
        ("vit_moe_tiny f32 S=64 D=16 causal", MP_MOE_SHAPE, True, f32, None),
    ]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    main_err = None
    for name, shape, causal, dt, odt in cases:
        e_out = _fwd_case(name, shape, causal, dt, odt, gen)
        if main_err is None:
            main_err = e_out
    _check_misaligned_refused(gen)

    q, k, v = (torch.randn(VIT_B16_FWD_SHAPE, device=DEVICE, generator=gen) for _ in range(3))
    q4, k4, v4 = (t.view(SERVE_MAX_BATCH, 12, s, d) for t in (q, k, v))
    kernel_ms, host_us = cuda_ms(lambda: fa.flash_fwd(q, k, v))
    plain_ms, _ = cuda_ms(lambda: fa.flash_fwd_reference(q, k, v), head_start=False)
    library_ms, library_host_us = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    # the least time for this work: its products as the kernel runs them
    # (3xTF32 on the tensor cores); and as f32 on the CUDA cores
    bound_ms, bound_by = flash_bound_3xtf32(bh, s, d)
    cuda_core_ms, cuda_core_by = flash_bound(bh, s, d)
    print(f"[kernels] flash_attention_fwd at [BH, S, D] = {list(VIT_B16_FWD_SHAPE)} f32: "
          f"kernel {kernel_ms:.4f} ms (host {host_us:.1f} us a call), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms (host {library_host_us:.1f} us), "
          f"bound {bound_ms:.4f} ms "
          f"({bound_by}; 3xTF32) or {cuda_core_ms:.4f} ms ({cuda_core_by}; f32 CUDA cores)")
    print("[kernels] the f32 scaled_dot_product_attention call runs: "
          + ", ".join(_library_kernels(lambda: F.scaled_dot_product_attention(q4, k4, v4))))
    return {"flash_attention_fwd": {
        "max_abs_err": main_err, "ms": kernel_ms, "kernel_ms": kernel_ms, "host_us": host_us,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_f32_cuda_cores": cuda_core_ms, "library_ms": library_ms,
        "library_host_us": library_host_us,
    }}


def _fwd_case(name, shape, causal, dt, odt, gen) -> float:
    """The forward kernel against its plain version on one case, with the
    tolerance of its route; returns max |err| of out."""
    q, k, v = (torch.randn(shape, device=DEVICE, generator=gen).to(dt) for _ in range(3))
    before = fa.flash_fwd.launches_mma
    out, m, l = fa.flash_fwd(q, k, v, causal, odt)
    torch.cuda.synchronize()  # a fault in the kernel surfaces here
    mma = fa.flash_fwd.launches_mma > before
    check(mma == (dt == torch.bfloat16), f"{name}: {dt} took the wrong route")
    r_out, r_m, r_l = fa.flash_fwd_reference(q, k, v, causal, odt)
    check(out.dtype == r_out.dtype and out.shape == r_out.shape,
          f"{name}: out {out.dtype} {tuple(out.shape)} vs {r_out.dtype} {tuple(r_out.shape)}")
    out_key = "out_bf16" if out.dtype == torch.bfloat16 else "out_f32"
    e_out, ok_out = _err(out, r_out, *(TOL_MMA if mma else TOL)[out_key])
    e_m, ok_m = _err(m, r_m, *TOL["m"])
    e_l, ok_l = _err(l, r_l, *TOL["l"])
    print(f"[kernels] flash_attention_fwd {name} ({'tensor cores' if mma else 'f32'}): "
          f"max|err| out {e_out:.3g} m {e_m:.3g} l {e_l:.3g}")
    check(ok_out and ok_m and ok_l, f"flash_attention_fwd {name}: outside tolerance")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    return e_out


def _check_misaligned_refused(gen) -> None:
    """No fallback: a bf16 input whose data starts 2 bytes past a 16-byte
    boundary is refused by every tensor-core wrapper, before any launch."""
    shape = (4, 77, 64)
    n = math.prod(shape)
    flat = torch.randn(n + 8, device=DEVICE, generator=gen).to(torch.bfloat16)
    bad = flat[1:n + 1].view(shape)  # contiguous, one element off
    good = torch.randn(shape, device=DEVICE, generator=gen).to(torch.bfloat16)
    stats = torch.zeros(shape[:2], device=DEVICE)
    before = {name: WRAPPERS[name].launches for name in MMA_KERNELS}
    for name, call in (("flash_fwd", lambda: fa.flash_fwd(bad, good, good)),
                       ("flash_bwd_dkdv", lambda: fa.flash_bwd_dkdv(
                           good, good, good, bad, stats, stats, stats)),
                       ("flash_bwd_dq", lambda: fa.flash_bwd_dq(
                           good, bad, good, good, stats, stats, stats))):
        try:
            call()
        except ValueError as exc:
            check("aligned" in str(exc), f"{name}: {exc}")
        else:
            raise SmokeError(f"{name} took a misaligned bf16 input")
    check({name: WRAPPERS[name].launches for name in MMA_KERNELS} == before,
          "a misaligned input reached a kernel")
    print("[kernels] a bf16 input 2 bytes off 16-byte alignment: refused by flash_fwd, "
          "flash_bwd_dkdv and flash_bwd_dq, no launch")


# -- phase 3 -----------------------------------------------------------------


def _bwd_case(name, shape, causal, dt, grad_dtype, strided_do, gen):
    """Both backward kernels against their plain versions on one case, each
    on the route its input dtype selects; returns {kernel: max |err|}."""
    q, k, v, do = (torch.randn(shape, device=DEVICE, generator=gen).to(dt) for _ in range(4))
    out, m, l = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    before = {kernel: WRAPPERS[kernel].launches_mma
              for kernel in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
    if strided_do:  # same values, strided as autograd may hand them over
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
        dq, dk, dv = fa.flash_bwd(q, k, v, out, m, l, do, causal, grad_dtype=grad_dtype)
    else:
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, m, l, delta, causal, grad_dtype)
        dq = fa.flash_bwd_dq(q, k, v, do, m, l, delta, causal, grad_dtype)
    torch.cuda.synchronize()  # a fault in a kernel surfaces here
    mma = {kernel: WRAPPERS[kernel].launches_mma > n for kernel, n in before.items()}
    for kernel, on_mma in mma.items():
        check(on_mma == (dt == torch.bfloat16), f"{kernel} {name}: {dt} took the wrong route")
    do = do.contiguous()
    r_dk, r_dv = fa.flash_bwd_dkdv_reference(q, k, v, do, m, l, delta, causal, grad_dtype)
    r_dq = fa.flash_bwd_dq_reference(q, k, v, do, m, l, delta, causal, grad_dtype)
    errs = {}
    # each kernel's tolerance follows its route: bf16 inputs take the
    # tensor-core kernels, held to TOL_BWD_MMA against plain versions that
    # round P and dS where the kernels do (dQ's rounds dS); f32 inputs take
    # the CUDA-core kernels, held to TOL_BWD
    for kernel, pairs in (("flash_attention_bwd_dkdv", ((dk, r_dk), (dv, r_dv))),
                          ("flash_attention_bwd_dq", ((dq, r_dq),))):
        tol = TOL_BWD_MMA if mma[kernel] else TOL_BWD
        worst = 0.0
        for got, ref in pairs:
            check(got.dtype == ref.dtype and got.shape == ref.shape,
                  f"{kernel} {name}: {got.dtype} {tuple(got.shape)} vs {ref.dtype} {tuple(ref.shape)}")
            check(bool(torch.isfinite(got.float()).all()), f"{kernel} {name}: non-finite gradient")
            err, ok = _err(got, ref, *tol["bf16" if got.dtype == torch.bfloat16 else "f32"])
            check(ok, f"{kernel} {name}: max |err| {err:.3g} outside tolerance")
            worst = max(worst, err)
        errs[kernel] = worst
    route = "tensor cores" if mma["flash_attention_bwd_dkdv"] else "f32"
    print(f"[kernels] backward {name} (dK/dV and dQ on {route}): max|err| "
          f"dK/dV {errs['flash_attention_bwd_dkdv']:.3g} dQ {errs['flash_attention_bwd_dq']:.3g}")
    return errs


# the fused SGD's profiler duration against its head-start time: kernels
# queued back to back are timed across the gaps between them (~1-2 us each),
# the profiler's rows without them
SGD_PROFILER_TOL = (0.15, 0.003)  # relative, plus ms


def _sgd_steps(shapes, seed: int, steps: int = 3, lr=TRAIN_LR, offset: int = 0) -> float:
    """``steps`` fused SGD steps against the plain version from the same
    leaves, new gradients each step; returns max |kernel - plain| over p and
    b. With ``offset``, every p and g starts that many f32 elements into a
    larger buffer (misaligned for 16-byte loads unless it is a multiple of
    4)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def leaves():
        return [torch.randn(math.prod(s) + offset, device=DEVICE, generator=gen)[offset:]
                .view(s) for s in shapes]

    params = leaves()
    ref_params = [p.clone() for p in params]
    bufs, ref_bufs = [torch.zeros(s, device=DEVICE) for s in shapes], [
        torch.zeros(s, device=DEVICE) for s in shapes]
    err = 0.0
    for _ in range(steps):
        grads = leaves()
        fs.fused_sgd(params, grads, bufs, lr)
        fs.fused_sgd_reference(ref_params, grads, ref_bufs, lr)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        err = max(err, max(float((a - b).abs().max())
                           for a, b in zip(params + bufs, ref_params + ref_bufs)))
    return err


def _sgd_kernel(model: str, seed: int) -> dict:
    """The fused SGD at ``model``'s leaves: 3 steps bit for bit against its
    plain version, then the kernel and ``torch.optim.SGD(fused=True).step()``
    timed in turns (``obs/fused_sgd_bench.py::measure``: device ms with a
    head start, host us a call, the profiler's kernel duration and the
    host-to-device copies of 10 calls on unchanged leaves), the plain
    version's period, and the bytes bound. Keys carry ``_resnet18`` for
    ResNet-18."""
    shapes = fused_sgd_bench.leaf_shapes(model)
    n_params = sum(s.numel() for s in shapes)
    lr = torch.full((), TRAIN_LR, device=DEVICE)
    err = _sgd_steps(shapes, seed, lr=lr)
    check(err == 0.0, f"fused_sgd at {model}'s leaves differs from its plain version by {err}")
    m = fused_sgd_bench.measure(fs, shapes, seed=seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = [torch.randn(s, device=DEVICE, generator=gen) for s in shapes]
    grads = [torch.randn(s, device=DEVICE, generator=gen) for s in shapes]
    bufs = [torch.zeros_like(p) for p in params]
    plain_ms, _ = cuda_ms(lambda: fs.fused_sgd_reference(params, grads, bufs, lr), iters=10,
                          head_start=False)
    out = {"max_abs_err": err, "ms": statistics.fmean(m["ms"]),
           "host_us": statistics.fmean(m["host_us"]), "plain_ms": plain_ms,
           "library_ms": statistics.fmean(m["library_ms"]),
           "library_host_us": statistics.fmean(m["library_host_us"]),
           "profiler_ms": m["profiler_ms"], "profiler_sessions": m["profiler_sessions"],
           "miss_us": m["miss_us"]}
    out["bound_ms"], out["bound_by"] = sgd_bound(n_params)
    print(f"[kernels] fused_sgd at {model}'s {len(shapes)} leaves, {n_params} parameters: 3 "
          f"steps bit for bit with its plain version; in turns (kernel, library, library, "
          f"kernel): kernel {m['ms']} ms, host {[round(x, 1) for x in m['host_us']]} us a call; "
          f"torch.optim.SGD(fused=True).step() {m['library_ms']} ms, host "
          f"{[round(x, 1) for x in m['library_host_us']]} us; plain {plain_ms:.4f} ms; bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {20 * n_params / 1e6:.1f} MB); "
          f"{out['bound_ms'] / out['ms']:.1%} of it")
    print(f"[kernels] fused_sgd at {model}'s leaves under torch.profiler, 10 calls on unchanged "
          f"leaves ({m['profiler_sessions']} session(s)): {m['profiler_kernels']} "
          f"{m['profiler_ms']} ms a call; host-to-device copies: "
          f"{m['htod_copies']}; a plan cache miss (make_plan) {m['miss_us']:.1f} us of host "
          f"time")
    check(m["profiler_ms"] is not None, f"torch.profiler recorded no fused_sgd kernel in "
          f"{m['profiler_sessions']} sessions")
    tol_rel, tol_ms = SGD_PROFILER_TOL
    check(abs(m["profiler_ms"] - out["ms"]) <= tol_rel * out["ms"] + tol_ms,
          f"fused_sgd: profiler {m['profiler_ms']} ms vs head-start {out['ms']} ms")
    check(m["htod_copies"] == 0, f"fused_sgd copied to the device {m['htod_copies']} times "
          f"in 10 calls on unchanged leaves")
    if model == "vit_b16":
        return out
    return {f"{k}_{model}": v for k, v in out.items()}


def _sgd_flat_shard(seed: int) -> dict:
    """The fused SGD at ZeRO-1's shape (phase 10): one flat leaf of
    ResNet-18's 11,220,132 f32 parameters (a rank's shard of the padded
    raveled vector, all of it at a world of one): 3 steps bit for bit
    against its plain version, the kernel and ``torch.optim.SGD(fused=True)``
    on the one leaf in turns (device ms with a head start, no profiler
    session here), the plain version's period and the bound."""
    shapes = [torch.Size([RESNET_PARAMS])]
    lr = torch.full((), TRAIN_LR, device=DEVICE)
    err = _sgd_steps(shapes, seed, lr=lr)
    check(err == 0.0, f"fused_sgd on the flat shard differs from its plain version by {err}")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p, g = (torch.randn(RESNET_PARAMS, device=DEVICE, generator=gen) for _ in range(2))
    b = torch.zeros_like(p)
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = g
    lib = torch.optim.SGD([lib_p], lr=TRAIN_LR, momentum=0.9, weight_decay=1e-4, fused=True)
    times = {"kernel": [], "library": []}
    for which in ("kernel", "library", "library", "kernel"):
        fn = (lambda: fs.fused_sgd([p], [g], [b], lr)) if which == "kernel" else lib.step
        times[which].append(cuda_ms(fn))
    plain_ms, _ = cuda_ms(lambda: fs.fused_sgd_reference([p], [g], [b], lr), iters=10,
                          head_start=False)
    out = {"max_abs_err_zero1_flat": err,
           "ms_zero1_flat": statistics.fmean(ms for ms, _ in times["kernel"]),
           "host_us_zero1_flat": statistics.fmean(us for _, us in times["kernel"]),
           "plain_ms_zero1_flat": plain_ms,
           "library_ms_zero1_flat": statistics.fmean(ms for ms, _ in times["library"])}
    out["bound_ms_zero1_flat"], _ = sgd_bound(RESNET_PARAMS)
    print(f"[kernels] fused_sgd on ZeRO-1's flat shard, one leaf of {RESNET_PARAMS} f32: 3 "
          f"steps bit for bit with its plain version; in turns: kernel "
          f"{[round(ms, 4) for ms, _ in times['kernel']]} ms, library "
          f"(torch.optim.SGD(fused=True) on the one leaf) "
          f"{[round(ms, 4) for ms, _ in times['library']]} ms; plain {plain_ms:.4f} ms; bound "
          f"{out['bound_ms_zero1_flat']:.4f} ms (bytes); "
          f"{out['bound_ms_zero1_flat'] / out['ms_zero1_flat']:.1%} of it")
    return out


def _sgd_edge_cases() -> None:
    """The fused SGD off the main paths' shapes, each 3 steps bit for bit:
    misaligned p and g with lengths that leave a scalar tail; more leaves
    than one launch's table holds (two launches); then one call captured in
    a CUDA graph over static buffers and replayed for 3 steps."""
    shapes = [(fs.TILE + 3,), (5,), (3, 129), (2, fs.TILE), (64,)]
    for offset in (1, 2, 3):
        err = _sgd_steps(shapes, seed=4, offset=offset)
        print(f"[kernels] fused_sgd, p and g {4 * offset} bytes off 16-byte alignment, lengths "
              f"{[math.prod(s) for s in shapes]}: max |kernel - plain| {err}")
        check(err == 0.0, f"fused_sgd misaligned by {offset}: differs by {err}")
    before = fs.fused_sgd.launches
    many = [(1 + i % 37,) for i in range(fs.MAX_LEAVES + 40)]
    err = _sgd_steps(many, seed=5)
    check(fs.fused_sgd.launches - before == 2 * 3,
          f"{len(many)} leaves: {fs.fused_sgd.launches - before} launches in 3 steps")
    print(f"[kernels] fused_sgd over {len(many)} leaves: 2 launches a step, max |kernel - "
          f"plain| {err}")
    check(err == 0.0, f"fused_sgd over {len(many)} leaves differs by {err}")
    _sgd_graph()


def _sgd_graph() -> None:
    """One ``fs.fused_sgd`` call at ResNet-18's leaves captured in a
    ``torch.cuda.CUDAGraph`` over static p, g, b and lr, replayed for 3 steps
    with new gradients and learning rates copied in; bit for bit with the
    plain version."""
    shapes = fused_sgd_bench.leaf_shapes("resnet18")
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    params = [torch.randn(s, device=DEVICE, generator=gen) for s in shapes]
    grads = [torch.zeros(s, device=DEVICE) for s in shapes]
    bufs = [torch.zeros(s, device=DEVICE) for s in shapes]
    ref_params, ref_bufs = [p.clone() for p in params], [b.clone() for b in bufs]
    lr = torch.zeros((), device=DEVICE)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture: the plan is built here
        fs.fused_sgd(params, grads, bufs, lr)
        fs.fused_sgd_reference(ref_params, grads, ref_bufs, lr)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fs.fused_sgd(params, grads, bufs, lr)
    err = 0.0
    for step, step_lr in enumerate((0.1, 0.05, 0.02)):
        new = [torch.randn(s, device=DEVICE, generator=gen) for s in shapes]
        for g, n in zip(grads, new):
            g.copy_(n)
        lr.fill_(step_lr)
        graph.replay()
        fs.fused_sgd_reference(ref_params, new, ref_bufs, lr)
        torch.cuda.synchronize()
        err = max(err, max(float((a - b).abs().max())
                           for a, b in zip(params + bufs, ref_params + ref_bufs)))
    print(f"[kernels] fused_sgd captured in a CUDA graph at resnet18's leaves, 3 replays with "
          f"new gradients and lr: max |kernel - plain| {err}")
    check(err == 0.0, f"fused_sgd under CUDA-graph replay differs by {err}")


def phase_kernels_train() -> dict:
    f32, bf16 = torch.float32, torch.bfloat16
    bh, s, d = TRAIN_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    cases = [
        # name, (BH, S, D), causal, input dtype, grad_dtype, strided do
        ("vit_b16 train bf16", TRAIN_SHAPE, False, bf16, None, False),
        ("vit_b16 train f32", TRAIN_SHAPE, False, f32, None, False),
        ("S=196 D=64 f32 causal", (96, 196, 64), True, f32, None, False),
        ("bf16 in, f32 grads", (96, 196, 64), False, bf16, f32, False),
        ("strided do (flash_bwd)", (96, 196, 64), False, f32, None, True),
        ("ragged S=77 D=32", (24, 77, 32), False, f32, None, False),
        ("ragged S=77 D=128 causal", (24, 77, 128), True, f32, None, False),
        ("S=5 D=16 bf16 causal (one partial tile)", (4, 5, 16), True, bf16, None, False),
        # the tensor-core dK/dV route at every head dim, ragged and causal
        ("bf16 S=196 D=64 causal", (96, 196, 64), True, bf16, None, False),
        ("bf16 strided do (flash_bwd)", (96, 196, 64), False, bf16, None, True),
        ("bf16 S=77 D=32", (24, 77, 32), False, bf16, None, False),
        ("bf16 S=77 D=128 causal, f32 grads", (24, 77, 128), True, bf16, f32, False),
        ("bf16 S=196 D=128", (24, 196, 128), False, bf16, None, False),
        ("bf16 S=5 D=64", (4, 5, 64), False, bf16, None, False),
        ("bf16 S=300 D=64 causal (5 tiles)", (8, 300, 64), True, bf16, None, False),
        # the f32 route at phase 16 (c)'s shape (vit_moe_tiny)
        ("vit_moe_tiny f32 S=64 D=16", MP_MOE_SHAPE, False, f32, None, False),
        ("vit_moe_tiny f32 S=64 D=16 causal", MP_MOE_SHAPE, True, f32, None, False),
    ]
    errs = [_bwd_case(*case, gen=gen) for case in cases]
    main_err = errs[0]  # the main path's case: training shape, bf16
    fwd_err = _fwd_case("vit_b16 train bf16", TRAIN_SHAPE, False, bf16, None, gen)

    # times at the training shapes (bf16, as vit_b16_imagenet_flash runs them)
    q, k, v, do = (torch.randn(TRAIN_SHAPE, device=DEVICE, generator=gen).to(bf16)
                   for _ in range(4))
    out, m, l = fa.flash_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    bwd_args = (q, k, v, do, m, l, delta)
    q4, k4, v4, do4 = (t.view(TRAIN_BATCH, 12, s, d) for t in (q, k, v, do))
    q4, k4, v4 = (t.detach().requires_grad_() for t in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4)
    sdpa_bwd_ms, sdpa_bwd_us = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (q4, k4, v4), do4, retain_graph=True), iters=20)
    with torch.no_grad():
        fwd_ms, fwd_us = cuda_ms(lambda: fa.flash_fwd(q, k, v), iters=20)
        fwd_plain_ms, _ = cuda_ms(lambda: fa.flash_fwd_reference(q, k, v), iters=10,
                                  head_start=False)
        fwd_lib_ms, fwd_lib_us = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                                         iters=20)
    fwd_bound, fwd_by = flash_bound(bh, s, d, bf16)
    print(f"[kernels] flash_attention_fwd at [BH, S, D] = {list(TRAIN_SHAPE)} bf16: kernel "
          f"{fwd_ms:.4f} ms (host {fwd_us:.1f} us a call), plain {fwd_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {fwd_lib_ms:.4f} ms (host {fwd_lib_us:.1f} us), bound "
          f"{fwd_bound:.4f} ms ({fwd_by})")
    bounds = flash_bwd_bounds(bh, s, d, bf16)
    measured = {}
    for name, kernel, plain in (
        ("flash_attention_bwd_dkdv", fa.flash_bwd_dkdv, fa.flash_bwd_dkdv_reference),
        ("flash_attention_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
    ):
        kernel_ms, host_us = cuda_ms(lambda: kernel(*bwd_args), iters=20)
        plain_ms, _ = cuda_ms(lambda: plain(*bwd_args), iters=10, head_start=False)
        bound_ms, bound_by = bounds[name]
        measured[name] = {"max_abs_err": main_err[name], "ms": kernel_ms, "host_us": host_us,
                          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": sdpa_bwd_ms, "library_host_us": sdpa_bwd_us}
        print(f"[kernels] {name} at [BH, S, D] = {list(TRAIN_SHAPE)} bf16: kernel "
              f"{kernel_ms:.4f} ms (host {host_us:.1f} us a call), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); the whole scaled_dot_product_attention "
              f"backward {sdpa_bwd_ms:.4f} ms (host {sdpa_bwd_us:.1f} us)")

    measured["fused_sgd"] = _sgd_kernel("vit_b16", seed=2)
    _sgd_edge_cases()
    measured["flash_attention_fwd"] = {
        "max_abs_err_train_shape": fwd_err,
        "ms_train_shape": fwd_ms, "host_us_train_shape": fwd_us,
        "plain_ms_train_shape": fwd_plain_ms, "library_ms_train_shape": fwd_lib_ms,
        "library_host_us_train_shape": fwd_lib_us, "bound_ms_train_shape": fwd_bound,
    }
    return measured


# -- phase 4 -----------------------------------------------------------------


def _serve(model, payloads, **engine_kw):
    """Warm an engine up, then drive the bursty request stream through it.
    Returns (engine, completed requests, scalars of the measured window)."""
    engine = ServingEngine(model, max_batch=SERVE_MAX_BATCH, device=DEVICE, **engine_kw)
    engine.warmup(IMAGE)
    engine.record_window()  # the measured window opens after warmup
    done, submitted, burst_idx = [], 0, 0
    while submitted < len(payloads):
        # alternate 3- and 7-request bursts so several buckets are used
        burst = (3, 7)[burst_idx % 2]
        burst_idx += 1
        for _ in range(min(burst, len(payloads) - submitted)):
            engine.submit(payloads[submitted], id=submitted)
            submitted += 1
        done.extend(engine.pump())
    done.extend(engine.drain())
    return engine, done, engine.record_window()


def _forward_split(model, batch: np.ndarray) -> None:
    """One full-bucket forward, outside the engine: the host's time to
    enqueue it (from an idle card) against the card's time between
    back-to-back forwards (CUDA events; host-bound when they are close).
    In turns, so drift on the shared host shows."""
    x = torch.from_numpy(batch).to(DEVICE)
    for impl in ("flash", "xla", "xla", "flash"):
        model.attn_impl = impl
        with torch.inference_mode():
            period_ms, _ = cuda_ms(lambda: model(x), iters=20, warmup=3, head_start=False)
            enqueue = []
            for _ in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model(x)
                enqueue.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        print(f"[serve] {impl}: batch-{x.shape[0]} forward: host enqueue "
              f"{float(np.median(enqueue)):.3f} ms (median of 10), device period "
              f"{period_ms:.3f} ms (CUDA events, 20 back to back)")


def phase_serve(work: str) -> dict:
    t0 = time.perf_counter()
    model = vit_b16(attn_impl="flash", device=DEVICE)
    bridge.load_jax_vit(model, bridge.numpy_vit_params(model, seed=SERVE_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 86_566_120, f"vit_b16 has {n_params} parameters")
    payloads = np.random.default_rng(SERVE_SEED).standard_normal(
        (SERVE_REQUESTS,) + IMAGE, dtype=np.float32)
    print(f"[serve] vit_b16 ({n_params} parameters) built and bridged in "
          f"{time.perf_counter() - t0:.1f} s")

    # the main path: counts set to 0 just before, read just after
    counters_lib.reset()
    reset_launches()
    engine, done, scalars = _serve(model, payloads)
    served = read_launches()
    served_mma = read_mma_launches()
    launches = served["flash_attention_fwd"]
    forwards = counters_lib.get("serve.forwards")
    check(all(n == 0 for name, n in served.items() if name != "flash_attention_fwd"),
          f"serving launched a training kernel: {served}")

    check(len(done) == SERVE_REQUESTS and all(r.ok for r in done),
          f"{sum(r.ok for r in done)} of {SERVE_REQUESTS} requests completed")
    for r in done:
        check(r.result.shape == (1000,) and bool(np.isfinite(r.result).all()),
              f"request {r.id}: logits {r.result.shape}, finite {np.isfinite(r.result).all()}")
    check(forwards == len(engine.buckets) + engine.stats.batches,
          f"{forwards} forwards vs {len(engine.buckets)} warmup + {engine.stats.batches} batches")
    check(launches == model.depth * forwards,
          f"flash kernel launched {launches} times in {forwards} forwards "
          f"(expected {model.depth} per forward)")
    check(served_mma["flash_attention_fwd"] == 0,
          f"serving (f32) took the tensor-core route {served_mma} times")
    check(engine.stats.check_invariants() == [], str(engine.stats.check_invariants()))
    phase_sums = {p: h.sum * 1e3 for p, h in engine.stats.phases.items()}
    print(f"[serve] flash: {len(done)} requests in {engine.stats.batches} batches "
          f"(occupancy {scalars['serve.batch_occupancy']:.3f}), "
          f"{scalars['serve.requests_per_s']} requests/s, latency p50 <= "
          f"{scalars['serve.latency_p50_ms']} ms, p99 <= {scalars['serve.latency_p99_ms']} ms "
          f"(bucket upper bounds), mean {engine.stats.total.sum / len(done) * 1e3:.3f} ms")
    print("[serve] flash: phase sums over requests (ms): "
          + ", ".join(f"{p} {v:.3f}" for p, v in phase_sums.items()))
    print(f"[serve] flash: {launches} kernel launches in {forwards} forwards, "
          f"{launches - served_mma['flash_attention_fwd']} of them on the f32 route")

    flash_logits = {r.id: r.result for r in done}
    model.attn_impl = "xla"
    fa.flash_fwd.launches = 0
    _, done_xla, scalars_xla = _serve(model, payloads)
    check(fa.flash_fwd.launches == 0, "the xla run launched the flash kernel")
    check(len(done_xla) == SERVE_REQUESTS and all(r.ok for r in done_xla),
          "the xla run did not complete every request")
    worst = 0.0
    for r in done_xla:
        ref, got = r.result, flash_logits[r.id]
        worst = max(worst, float(np.abs(got - ref).max()))
        check(bool(np.all(np.abs(got - ref) <= LOGITS_TOL[0] + LOGITS_TOL[1] * np.abs(ref))),
              f"request {r.id}: flash vs xla logits differ by {np.abs(got - ref).max():.3g}")
    print(f"[serve] xla: {scalars_xla['serve.requests_per_s']} requests/s, latency p50 <= "
          f"{scalars_xla['serve.latency_p50_ms']} ms, p99 <= "
          f"{scalars_xla['serve.latency_p99_ms']} ms")
    print(f"[serve] logits flash vs xla: max |diff| {worst:.3g} "
          f"(tolerance {LOGITS_TOL[0]} + {LOGITS_TOL[1]} * |xla|)")

    _forward_split(model, payloads[:SERVE_MAX_BATCH])
    from_ckpt = _serve_from_checkpoint(model, payloads, flash_logits, work)
    return {name: served[name] + from_ckpt[name] for name in served}


def _serve_drill() -> None:
    """``python -m tpu_dist_torch.serve drill`` on the card must exit 0."""
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drill_") as d:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.serve", "drill",
                               "--workdir", d, "--device", DEVICE],
                              cwd=root, capture_output=True, text=True, timeout=300)
        ok = [ln for ln in proc.stdout.splitlines() if ln.startswith("serve-drill OK")]
        check(proc.returncode == 0 and ok,
              f"serve drill: rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        print(f"[drill] python -m tpu_dist_torch.serve drill --device {DEVICE}: rc 0 in "
              f"{time.perf_counter() - t0:.1f} s; {ok[0]}")


# -- phase 4, second half: serving ViT-B/16 from a checkpoint -------------------

# The ZeRO-1 layout a data-parallel run of 16 leaves: ViT-B/16's
# 86,566,120 parameters divide by 8 (a flat vector at dp = 8 has no pad,
# and the serving extent's length equals it: nothing to remap), not by 16,
# whose flat vector carries 8 zeros of pad that the remapper must crop.
SERVE_CKPT_DP = 16
# int8 against f32 logits of the same requests: reported (max |diff|, top-1
# agreement). The weights are random, so the top two of the 1000 logits of a
# request can lie closer than int8's error and swap: the limit is a sanity
# floor that a wrong dequantize (a transposed or misplaced leaf) fails.
INT8_TOP1_AGREEMENT = 0.5


def _flip_byte_in_largest_entry(path: str) -> None:
    """One byte flipped halfway through the data of the archive's largest
    entry (``np.savez`` stores entries uncompressed, one zip member each)."""
    import zipfile  # noqa: PLC0415

    with zipfile.ZipFile(path) as zf:
        info = max(zf.infolist(), key=lambda i: i.file_size)
    at = info.header_offset + 30 + len(info.filename) + info.file_size // 2
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def _serve_run(tag: str, model, payloads, d: str, **engine_kw):
    """One 32-request run with the SLO rules, a history, an exporter on a
    free local port and a heartbeat file; launch counts set to 0 just
    before and read just after. Returns (engine, {id: logits}, scalars,
    flash launches, history path)."""
    log = os.path.join(d, f"{tag}.jsonl")
    hb = os.path.join(d, f"{tag}.beat")
    history = MetricsHistory(log)
    exporter = export_lib.MetricsExporter(port=0, host="127.0.0.1")
    try:
        counters_lib.reset()
        reset_launches()
        engine, done, scalars = _serve(model, payloads, slo_rules="default", history=history,
                                       exporter=exporter, heartbeat_file=hb, **engine_kw)
        launches, mma = read_launches(), read_mma_launches()
        forwards = counters_lib.get("serve.forwards")
        check(len(done) == len(payloads) and all(r.ok for r in done),
              f"{tag}: {sum(r.ok for r in done)} of {len(payloads)} requests completed")
        check(all(bool(np.isfinite(r.result).all()) for r in done), f"{tag}: non-finite logits")
        check(launches["flash_attention_fwd"] == model.depth * forwards
              and mma["flash_attention_fwd"] == 0,
              f"{tag}: {launches['flash_attention_fwd']} flash launches "
              f"({mma['flash_attention_fwd']} tensor-core) in {forwards} forwards")
        check(all(n == 0 for k, n in launches.items() if k != "flash_attention_fwd"),
              f"{tag}: serving launched a training kernel: {launches}")
        check(os.path.exists(hb), f"{tag}: no heartbeat file while serving")
        engine.sweep_heartbeat()
        check(not os.path.exists(hb), f"{tag}: the heartbeat file outlived sweep_heartbeat")
        vals = export_lib.scrape(port=exporter.port)
        check(vals is not None
              and vals.get(export_lib.metric_name("serve.completed")) == len(payloads)
              and export_lib.metric_name("serve.latency_p99_ms") in vals
              and vals.get("tpu_dist_serve_latency_seconds_count") == len(payloads)
              and all(f"tpu_dist_serve_phase_{p}_seconds_count" in vals
                      for p in engine.stats.phases),
              f"{tag}: the scrape lacks the serve gauges or histograms: {sorted(vals or {})[:20]}")
    finally:
        exporter.close()
        history.close()
    phase_ms = {p: h.sum * 1e3 for p, h in engine.stats.phases.items()}
    print(f"[serve] {tag}: {scalars['serve.requests_per_s']} requests/s, latency p50 <= "
          f"{scalars['serve.latency_p50_ms']} ms, p99 <= {scalars['serve.latency_p99_ms']} ms; "
          f"phase sums over requests (ms): dispatch {phase_ms['dispatch']:.3f}, device "
          f"{phase_ms['device']:.3f}; {launches['flash_attention_fwd']} flash launches in "
          f"{forwards} forwards, all f32 route; scrape {len(vals)} samples; heartbeat beaten "
          f"and swept")
    return engine, {r.id: r.result for r in done}, scalars, launches, log


def _serve_from_checkpoint(live, payloads, live_logits: dict, d: str) -> dict:
    """ViT-B/16 served from a checkpoint written under ``d``, in f32 and in
    int8 (module docstring, phase 4). Returns the flash launches of both
    runs; the checkpoint directory ``d/ck`` stays for phase 8."""
    root = pathlib.Path(__file__).resolve().parent
    n_params = sum(p.numel() for p in live.parameters())
    ckdir = os.path.join(d, "ck")
    mom = torch.zeros(padded_len(n_params, SERVE_CKPT_DP), device=DEVICE)
    mom[:n_params] = torch.arange(1, n_params + 1, device=DEVICE) % 17 * 0.01
    state = state_lib.TrainState(params=live, bn_state={}, opt_state=mom, step=120)
    good = ckpt_lib.save(ckdir, state, 1, extra_meta={
        "elastic": elastic_stamp(SERVE_CKPT_DP, SERVE_CKPT_DP, n_params)})
    del mom, state
    newest = os.path.join(ckdir, "ckpt_2.npz")
    shutil.copy(good, newest)
    _flip_byte_in_largest_entry(newest)
    t0 = time.perf_counter()
    loaded = load_serving_state(ckdir, live)
    load_ms = (time.perf_counter() - t0) * 1e3
    check(loaded["path"] == good and os.path.exists(newest + ".corrupt")
          and not os.path.exists(newest),
          f"the corrupt newest file was not quarantined: served {loaded['path']}")
    check(loaded["remapped"] == [("['opt_state']", "zero1_flat")],
          f"remapped {loaded['remapped']}")
    written = bridge.keystr_flatten(bridge.numpy_vit_params(live, seed=SERVE_SEED))
    got = bridge.keystr_flatten(loaded["params"])
    check(list(got) == list(written) and all(np.array_equal(got[k], written[k]) for k in got),
          "the loaded parameters differ from the written ones")
    print(f"[serve] checkpoint: ViT-B/16 + a ZeRO-1 flat momentum at dp = {SERVE_CKPT_DP}, "
          f"{os.path.getsize(good)} bytes a file; load_serving_state {load_ms:.1f} ms "
          f"(quarantined the newer file with one flipped byte, remapped "
          f"{loaded['remapped']}, parameters equal to the written ones bit for bit)")

    f32_model = vit_b16(attn_impl="flash", device=DEVICE)
    bridge.load_jax_params(f32_model, loaded["params"], loaded["bn_state"])
    _, f32_logits, _, f32_launches, _ = _serve_run("f32", f32_model, payloads, d)
    check(all(np.array_equal(f32_logits[i], live_logits[i]) for i in live_logits),
          "f32 logits from the checkpoint differ from the live module's")
    del f32_model

    host_model = vit_b16(attn_impl="flash", device="cpu")
    bridge.load_jax_params(host_model, loaded["params"], loaded["bn_state"])
    del loaded
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = ServingEngine(host_model, max_batch=SERVE_MAX_BATCH, quantize=True,
                           device=DEVICE)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - before
    f32_bytes = 4 * n_params
    check(engine.int8.nbytes <= resident < 0.3 * f32_bytes,
          f"int8 engine: {resident} bytes on the card for {engine.int8.nbytes} of int8 "
          f"weights ({f32_bytes} in f32)")
    del engine
    int8_engine, int8_logits, _, int8_launches, log = _serve_run(
        "int8", host_model, payloads, d, quantize=True)
    deq_ms, deq_us = cuda_ms(int8_engine.int8.dequantize, iters=20, warmup=3)
    diff = max(float(np.abs(int8_logits[i] - f32_logits[i]).max()) for i in f32_logits)
    top1 = float(np.mean([int8_logits[i].argmax() == f32_logits[i].argmax()
                          for i in f32_logits]))
    print(f"[serve] weights on the card: f32 {f32_bytes} bytes, int8 {int8_engine.int8.nbytes} "
          f"bytes (q + scales; the int8 engine's allocation {resident}); dequantize a forward: "
          f"host {deq_us:.1f} us, device {deq_ms:.4f} ms (one launch)")
    print(f"[serve] int8 vs f32 logits over {len(f32_logits)} requests: max |diff| "
          f"{diff:.4g}, top-1 agreement {top1:.3f} (limit {INT8_TOP1_AGREEMENT})")
    check(top1 >= INT8_TOP1_AGREEMENT, f"int8 top-1 agreement {top1}")
    report = subprocess.run([sys.executable, "-m", "tpu_dist_torch.serve", "report", log],
                            cwd=root, capture_output=True, text=True, timeout=120)
    check(report.returncode == 0, f"serve report: rc {report.returncode}\n{report.stderr}")
    with open(log) as f:
        alerts = [json.loads(line) for line in f if '"kind": "alert"' in line]
    print(f"[serve] python -m tpu_dist_torch.serve report: rc 0, "
          f"{report.stdout.splitlines()[0]}; SLO alerts fired: "
          f"{[a['rule'] for a in alerts] or 'none'}")
    print(f"[serve] card: {_smi_line()}")
    return {name: f32_launches[name] + int8_launches[name] for name in f32_launches}


# -- phase 8, the supervised replica ---------------------------------------------

# What ReplicaSupervisor drives: one serving replica at a time, each a fresh
# process serving ViT-B/16 from the checkpoint directory through the port's
# replica function, and, after it returns, adding its flash-forward launches
# (and whether the kernel library existed, unchanged, before it started) to
# its status file. The library is phase 1's: a child loads it, never builds.
REPLICA_CHILD = """
import sys
from tpu_dist_torch.nn.vit import vit_b16
from tpu_dist_torch.obs import counters
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.serve import replica

args = replica.parse(sys.argv[1:])
lib = _build.library_path("flash_attention_fwd")
mtime = lambda: lib.stat().st_mtime_ns if lib.exists() else None
before = mtime()
rc = replica.serve(vit_b16(attn_impl="flash", device=args.device), (224, 224, 3), args)
replica._status(args.status_file, event="launches", flash=fa.flash_fwd.launches,
                flash_mma=fa.flash_fwd.launches_mma, forwards=counters.get("serve.forwards"),
                library_before=before, library_after=mtime())
sys.exit(rc)
"""
# stale_after_s stays above the heartbeat's 1 s write throttle
# (obs/heartbeat.py); the warmup grace (120 s) covers a child's start-up
REPLICA_POLICY = dict(max_restarts=3, stale_after_s=5.0, backoff_base_s=0.01)
REPLICA_BLOCKS = 12        # ViT-B/16's blocks: flash launches a forward
REPLICA_SERVE_S = 3.0      # how long an incarnation serves before the signal
REPLICA_WAIT_S = 240.0     # the longest wait for one status line
WEDGE_AFTER = 16           # --serve_n and --wedge_after of the wedge drill


class _Replicas:
    """The status file and the Popen factory of one supervised run."""

    def __init__(self, ckdir: str, work: str, extra=()):
        self.root = pathlib.Path(__file__).resolve().parent
        self.work, self.status = work, os.path.join(work, "replica_status.jsonl")
        self.argv = ["--ckpt", ckdir, "--workdir", work, "--status_file", self.status,
                     "--max_batch", str(SERVE_MAX_BATCH), "--device", DEVICE, *extra]
        os.makedirs(work, exist_ok=True)
        self.events = []  # (wall time, supervisor event)

    def spawn(self, incarnation: int):
        log = open(os.path.join(self.work, f"child{incarnation}.log"), "w")
        try:
            return subprocess.Popen([sys.executable, "-c", REPLICA_CHILD, *self.argv],
                                    cwd=self.root, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def on_event(self, ev: dict) -> None:
        self.events.append((time.time(), ev))

    def lines(self, pid: int, event: str) -> list:
        if not os.path.exists(self.status):
            return []
        with open(self.status) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        return [r for r in recs if r.get("pid") == pid and r.get("event") == event]

    def wait_line(self, sup, event: str) -> dict:
        """The current incarnation's first ``event`` status line, polling
        the supervisor meanwhile (a verdict there fails the run)."""
        pid, deadline = sup.proc.pid, time.monotonic() + REPLICA_WAIT_S
        while time.monotonic() < deadline:
            got = self.lines(pid, event)
            if got:
                return got[0]
            verdict = sup.poll_once()
            check(verdict is None, f"waiting for {event!r} of pid {pid}: supervisor says "
                                   f"{verdict}\n{self.log_tail(sup.incarnation)}")
            time.sleep(0.05)
        raise SmokeError(f"no {event!r} line from pid {pid} in {REPLICA_WAIT_S} s\n"
                         f"{self.log_tail(sup.incarnation)}")

    def log_tail(self, incarnation: int) -> str:
        path = os.path.join(self.work, f"child{incarnation}.log")
        with open(path) as f:
            return f.read()[-3000:]

    def event_time(self, kind: str, nth: int = 0) -> float:
        return [t for t, ev in self.events if ev["event"] == kind][nth]


def _check_bundle(reps: _Replicas, verdict: str) -> None:
    pms = [ev for _, ev in reps.events if ev["event"] in ("postmortem", "bundle_failed")]
    check(pms and pms[-1]["event"] == "postmortem",
          f"no postmortem bundle: {[ev for _, ev in reps.events]}")
    with open(pms[-1]["bundle"]) as f:
        bundle = json.load(f)
    got = {r["rank"]: r["verdict"] for r in bundle["ranks"]}
    check(got.get(0) == verdict, f"bundle {pms[-1]['bundle']}: verdicts {got}, want {verdict}")


def _replica_launches(reps: _Replicas, pid: int) -> int:
    """A drained incarnation's flash launches, held to 12 a forward, all
    on the f32 route, through phase 1's library."""
    got = reps.lines(pid, "launches")
    check(len(got) == 1, f"pid {pid}: launch lines {got}")
    n = got[0]
    check(n["library_before"] is not None and n["library_before"] == n["library_after"],
          f"pid {pid}: the kernel library was built or rebuilt by the child: {n}")
    check(n["forwards"] > len(batch_buckets(SERVE_MAX_BATCH))
          and n["flash"] == REPLICA_BLOCKS * n["forwards"] and n["flash_mma"] == 0,
          f"pid {pid}: {n['flash']} flash launches ({n['flash_mma']} tensor-core) in "
          f"{n['forwards']} forwards")
    return n["flash"]


def _serve_windows(reps: "_Replicas") -> str:
    """Requests/s and latency of the replicas of ``reps`` from their own
    ``serve`` history records: every request served over the time from
    each incarnation's ``ready`` line to its last window, and p50/p99 from
    the merged latency histogram of every incarnation (a window carries
    its incarnation's cumulative histogram; the records are told apart by
    the supervisor's spawn times)."""
    from tpu_dist_torch.serve.slo import LatencyHistogram  # noqa: PLC0415

    with open(os.path.join(reps.work, "replica.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    wins = [r for r in recs if r.get("kind") == "serve" and not r.get("event")]
    spawns = [(t, ev["pid"]) for t, ev in reps.events if ev["event"] == "spawn"]
    served, seconds, hist = 0, 0.0, LatencyHistogram()
    for k, (t, pid) in enumerate(spawns):
        end = spawns[k + 1][0] if k + 1 < len(spawns) else math.inf
        mine = [r for r in wins if t <= r["ts"] < end]
        ready = reps.lines(pid, "ready")
        if not mine or not ready:
            continue
        served += int(mine[-1]["completed"])
        seconds += mine[-1]["ts"] - ready[0]["ts"]
        hist.merge(LatencyHistogram.from_dict(mine[-1]["latency_hist"]))
    if not served or seconds <= 0:
        return "no request served"
    rates = [r["requests_per_s"] for r in wins if "requests_per_s" in r]
    return (f"{served} requests in {seconds:.3f} s from ready to the last window: "
            f"{served / seconds:.3f} requests/s (windows: min {min(rates)}, max {max(rates)}), "
            f"latency p50 <= {hist.quantile_bound(0.5) * 1e3:g} ms, "
            f"p99 <= {hist.quantile_bound(0.99) * 1e3:g} ms (merged histogram, bucket bounds)")


def phase_supervised(work: str) -> dict:
    """Phase 8: the supervised ViT-B/16 replica from phase 4's checkpoint
    directory, then the serving drill. It runs after every phase that reads
    torch.profiler: once a few CUDA processes of their own have come and
    gone on the card, this process's CUDA-only profiler sessions record
    nothing at random (``PERF.md`` §6). Returns the flash launches of
    the replicas that drained."""
    t0 = time.perf_counter()
    launches = _supervised_replica(os.path.join(work, "ck"), work)
    print(f"[replica] part: {time.perf_counter() - t0:.1f} s")
    _serve_drill()
    return launches


def _supervised_replica(ckdir: str, d: str) -> dict:
    """ViT-B/16 replicas under ``ReplicaSupervisor`` from the checkpoint
    directory (module docstring, phase 4). Returns the flash launches of
    the incarnations that drained."""
    from tpu_dist_torch.serve.supervisor import ReplicaPolicy, ReplicaSupervisor  # noqa: PLC0415

    launches = 0
    # 1-4: ready, SIGKILL -> crash -> bundle -> relaunch, same digest, SIGTERM
    reps = _Replicas(ckdir, os.path.join(d, "replica"))
    sup = ReplicaSupervisor(reps.spawn, heartbeat_file=os.path.join(reps.work, "hb.json"),
                            policy=ReplicaPolicy(**REPLICA_POLICY), postmortem_dirs=[reps.work],
                            on_event=reps.on_event)
    sup.start()
    first = reps.wait_line(sup, "ready")
    print(f"[replica] incarnation 1 (pid {sup.proc.pid}): spawn -> ready "
          f"{first['ts'] - reps.event_time('spawn', 0):.2f} s, weights_digest "
          f"{first['weights_digest']}, {first['warmup_compiles']} warmup buckets, "
          f"{os.path.basename(first['ckpt'])}")
    time.sleep(REPLICA_SERVE_S)
    pid = sup.proc.pid
    os.kill(pid, signal.SIGKILL)
    sup.proc.wait(timeout=60)
    verdict = sup.poll_once()
    check(verdict == "crash", f"after SIGKILL: poll_once() = {verdict}")
    _check_bundle(reps, "no-clean-exit")
    second = reps.wait_line(sup, "ready")
    crash_down = second["ts"] - reps.event_time("crash")
    check(second["weights_digest"] == first["weights_digest"],
          f"relaunch digest {second['weights_digest']} vs {first['weights_digest']}")
    print(f"[replica] SIGKILL -> poll_once() 'crash', bundle verdict no-clean-exit, "
          f"incarnation 2 (pid {sup.proc.pid}) spawn -> ready "
          f"{second['ts'] - reps.event_time('spawn', 1):.2f} s with the same digest; "
          f"down time crash verdict -> next ready {crash_down:.2f} s")
    time.sleep(REPLICA_SERVE_S)
    pid = sup.proc.pid
    sup.proc.terminate()
    check(sup.proc.wait(timeout=120) == 0, f"SIGTERM: rc {sup.proc.returncode}")
    drained = reps.lines(pid, "drained")
    verdict = sup.poll_once()
    check(drained and verdict == "exit", f"SIGTERM: drained {drained}, poll_once() {verdict}")
    launches += _replica_launches(reps, pid)
    print(f"[replica] SIGTERM -> drained ({drained[0]['served']} served, "
          f"{drained[0]['retraces']} retraces, {drained[0]['shed']} shed), poll_once() 'exit'")
    print(f"[replica] history of incarnations 1-2: "
          f"{_serve_windows(reps)}")

    # 5: a wedge: stale beat -> SIGTERM (grace) -> bundle -> relaunch
    reps = _Replicas(ckdir, os.path.join(d, "wedge"),
                     ("--serve_n", str(WEDGE_AFTER), "--wedge_after", str(WEDGE_AFTER)))
    sup = ReplicaSupervisor(reps.spawn, heartbeat_file=os.path.join(reps.work, "hb.json"),
                            policy=ReplicaPolicy(**REPLICA_POLICY), postmortem_dirs=[reps.work],
                            on_event=reps.on_event)
    sup.start()
    ready = reps.wait_line(sup, "ready")
    print(f"[replica] wedge run, incarnation 1 (pid {sup.proc.pid}): spawn -> ready "
          f"{ready['ts'] - reps.event_time('spawn', 0):.2f} s")
    pid = sup.proc.pid
    wedged_at = reps.wait_line(sup, "serving")["ts"]
    deadline = time.monotonic() + 60
    verdict = None
    while verdict is None and time.monotonic() < deadline:
        verdict = sup.poll_once()
        time.sleep(0.05)
    check(verdict == "wedge", f"wedged replica: poll_once() = {verdict}")
    kinds = [ev["event"] for _, ev in reps.events]
    check(kinds[-4:] == ["wedge", "postmortem", "relaunch", "spawn"], f"events {kinds}")
    _check_bundle(reps, "failed")  # the vacate closed the ring with exit, not clean
    launches += _replica_launches(reps, pid)
    ready = reps.wait_line(sup, "ready")
    wedge_down = ready["ts"] - reps.event_time("wedge")
    check(ready["weights_digest"] == first["weights_digest"], "wedge relaunch digest")
    print(f"[replica] wedge: no beat since the 'serving' line -> verdict "
          f"{reps.event_time('wedge') - wedged_at:.2f} s (stale_after_s "
          f"{REPLICA_POLICY['stale_after_s']}), SIGTERM -> exit {sup.last_rc}, bundled, "
          f"incarnation 2 (pid {sup.proc.pid}) spawn -> ready "
          f"{ready['ts'] - reps.event_time('spawn', 1):.2f} s; down time wedge verdict -> "
          f"next ready {wedge_down:.2f} s")
    pid = sup.proc.pid
    reps.wait_line(sup, "serving")
    sup.proc.terminate()
    check(sup.proc.wait(timeout=120) == 0, f"SIGTERM: rc {sup.proc.returncode}")
    check(sup.poll_once() == "exit", "the last incarnation did not exit cleanly")
    launches += _replica_launches(reps, pid)
    print(f"[replica] {launches} flash launches in the drained incarnations, "
          f"{REPLICA_BLOCKS} a forward, all on the f32 route; down time: crash "
          f"{crash_down:.2f} s, wedge {wedge_down:.2f} s; card: {_smi_line()}")
    return {name: launches if name == "flash_attention_fwd" else 0 for name in KERNELS}


# -- phase 5 -----------------------------------------------------------------

TRAIN_SEED = 0
PER_STEP = {"flash_attention_fwd": 12, "flash_attention_bwd_dkdv": 12,
            "flash_attention_bwd_dq": 12, "fused_sgd": 1}  # ViT-B/16: 12 blocks


def _bridged_vit_b16(attn_impl: str):
    model = vit_b16(attn_impl=attn_impl, device=DEVICE)
    return bridge.load_jax_vit(model, bridge.numpy_vit_params(model, seed=TRAIN_SEED))


def _sgd_for(impl: str):
    """flash + fused SGD, xla + plain SGD."""
    return optim.SGD(momentum=0.9, weight_decay=1e-4, fused=impl == "flash")


def _parity_runs(compute_dtype, make_opt=_sgd_for, lr=TRAIN_LR) -> dict:
    """{impl: (losses, initial params, final params)} of PARITY_STEPS steps of
    flash and xla attention, each with ``make_opt(impl)`` (by default flash +
    fused SGD and xla + plain SGD), from the same bridged weights and
    batches, at ``compute_dtype``."""
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.standard_normal(
        (PARITY_STEPS, PARITY_BATCH) + IMAGE, dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, (PARITY_STEPS, PARITY_BATCH))).to(DEVICE)
    runs = {}
    for impl in ("flash", "xla"):
        model = _bridged_vit_b16(impl)
        init = [p.detach().clone() for p in model.parameters()]
        opt = make_opt(impl)
        st = state_lib.TrainState.create(model, opt)
        train_step = step_lib.make_train_step(opt, compute_dtype=compute_dtype)
        losses = []
        for i in range(PARITY_STEPS):
            st, metrics = train_step(st, images[i], labels[i], lr)
            losses.append(metrics["loss"].item())
        runs[impl] = (losses, init, [p.detach() for p in model.parameters()])
    return runs


def _train_parity() -> None:
    """(a) f32, TF32 off: flash + fused SGD against xla + plain SGD."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[train] parity: f32, torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}; batch {PARITY_BATCH}, {PARITY_STEPS} steps, "
          f"lr {TRAIN_LR}")
    runs = _parity_runs(torch.float32)
    (flash_losses, init, flash_p), (xla_losses, _, xla_p) = runs["flash"], runs["xla"]
    for i, (a, b) in enumerate(zip(flash_losses, xla_losses)):
        check(math.isfinite(a) and abs(a - b) <= PARITY_LOSS_RTOL * abs(b),
              f"parity step {i}: loss flash {a!r} vs xla {b!r}")
    worst, worst_share = 0.0, 0.0
    for p0, a, b in zip(init, flash_p, xla_p):
        diff, moved = (a - b).abs().max().item(), (b - p0).abs().max().item()
        check(diff <= PARITY_PARAM_RTOL * moved + PARITY_PARAM_ATOL,
              f"parity: a parameter differs by {diff:.3g} after moving {moved:.3g}")
        worst = max(worst, diff)
        worst_share = max(worst_share, diff / max(moved, 1e-30))
    print(f"[train] parity losses flash {flash_losses} vs xla {xla_losses}")
    print(f"[train] parity after step {PARITY_STEPS}: largest parameter difference {worst:.3g}; "
          f"largest as a share of its parameter's update {worst_share:.3g} (limit "
          f"{PARITY_PARAM_RTOL} + {PARITY_PARAM_ATOL} absolute)")


def _train_parity_bf16() -> None:
    """(b) bf16 compute: flash (the tensor-core kernels) + fused SGD against
    xla + plain SGD, the losses per step."""
    before = read_mma_launches()
    runs = _parity_runs(torch.bfloat16)
    mma = read_mma_launches()
    check(all(mma[name] - before[name] == 12 * PARITY_STEPS for name in MMA_KERNELS),
          f"bf16 parity: tensor-core launches {mma} (from {before})")
    flash_losses, xla_losses = runs["flash"][0], runs["xla"][0]
    rel = [abs(a - b) / abs(b) for a, b in zip(flash_losses, xla_losses)]
    print(f"[train] bf16 parity: batch {PARITY_BATCH}, {PARITY_STEPS} steps, losses flash "
          f"{flash_losses} vs xla {xla_losses}; relative differences {rel} (limit "
          f"{PARITY_BF16_LOSS_RTOL})")
    for i, (a, r) in enumerate(zip(flash_losses, rel)):
        check(math.isfinite(a) and r <= PARITY_BF16_LOSS_RTOL,
              f"bf16 parity step {i}: loss flash {a!r} vs xla {xla_losses[i]!r}")


def _profile_steps(train_step, st, images, labels, lr=TRAIN_LR, tag="train") -> None:
    """Device time by kernel over 2 steps under torch.profiler; the device's
    busy share of that (profiled, so slowed) window. Prints what the
    profiler gives, under ``[tag]``; a profiler without device times is
    reported, not fatal."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                st, _ = train_step(st, images, labels, lr)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0)

        # the kernels themselves; an operator's row repeats its kernels' time
        events = sorted((e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                        key=dev_us, reverse=True)
        busy_us = sum(dev_us(e) for e in events)
        if busy_us <= 0:
            print(f"[{tag}] profiler: no device time recorded")
            return
        print(f"[{tag}] profiler, 2 steps: device busy {busy_us / 1e3:.3f} ms of "
              f"{wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.3f}; idle share "
              f"{1 - busy_us / wall_us:.3f}, under the profiler)")
        for e in events[:12]:
            if dev_us(e) > 0:
                print(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms  {dev_us(e) / busy_us:6.3f}  "
                      f"x{e.count}  {e.key[:90]}")
    except Exception as exc:  # noqa: BLE001 — an optional measurement
        print(f"[{tag}] profiler: not available ({type(exc).__name__}: {exc})")


def _train_config(kernel_ms: dict) -> dict:
    """(b) vit_b16_imagenet_flash: bf16 compute, batch 64, fused SGD."""
    model = _bridged_vit_b16("flash")
    opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    st = state_lib.TrainState.create(model, opt)
    train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(TRAIN_SEED)
    images = torch.from_numpy(
        rng.standard_normal((TRAIN_BATCH,) + IMAGE, dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH).astype(np.int32)).to(DEVICE)
    for _ in range(TRAIN_WARMUP):
        st, _ = train_step(st, images, labels, TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    reset_plan_counts()
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        st, metrics = train_step(st, images, labels, TRAIN_LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = read_launches()
    mma = read_mma_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    read_plan_counts("vit_b16", "train")

    for name, per_step in PER_STEP.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps "
              f"(expected {per_step} per step)")
    for name in MMA_KERNELS:
        check(mma[name] == launches[name],
              f"{name}: {mma[name]} of {launches[name]} launches on the tensor-core route")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(st.step == TRAIN_WARMUP + TRAIN_STEPS, f"state step {st.step}")
    mean_ms = float(np.mean(step_ms))
    print(f"[train] vit_b16_imagenet_flash: bf16 compute, batch {TRAIN_BATCH}, fused SGD, "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warmup: losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"[train] step ms (host clock, each step ended by synchronize): median "
          f"{float(np.median(step_ms)):.3f}, mean {mean_ms:.3f}, min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; {TRAIN_BATCH / mean_ms * 1e3:.1f} images/s; "
          f"max_memory_allocated {peak_bytes} bytes ({peak_bytes / 2 ** 30:.2f} GiB)")
    print(f"[train] launches in {TRAIN_STEPS} steps: {launches}; on the tensor-core route: "
          f"{mma}")
    print("[train] share of the mean step per kernel (launches per step x its time "
          "alone at this shape): " + ", ".join(
              f"{name} {PER_STEP[name] * kernel_ms[name] / mean_ms:.3f}" for name in PER_STEP))

    sums = step_lib.make_eval_step(compute_dtype=torch.bfloat16)(
        st, images, labels, torch.ones(TRAIN_BATCH, device=DEVICE))
    sums = {k: v.item() for k, v in sums.items()}
    check(sums["count"] == TRAIN_BATCH and math.isfinite(sums["loss"])
          and 0 <= sums["top1"] <= sums["top5"] <= TRAIN_BATCH, f"eval sums {sums}")
    print(f"[train] eval over the batch: loss {sums['loss'] / sums['count']:.4f}, top1 "
          f"{sums['top1']:.0f}, top5 {sums['top5']:.0f} of {sums['count']:.0f}")
    _profile_steps(train_step, st, images, labels)
    return launches, mma


def phase_train(kernel_ms: dict) -> dict:
    t0 = time.perf_counter()
    _train_parity()
    _train_parity_bf16()
    launches = _train_config(kernel_ms)
    print(f"[train] phase: {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 6 -----------------------------------------------------------------

RESNET_PARAMS = 11_220_132  # ResNet-18, 100 classes
RESNET_RUN = dict(  # bench.py's resnet18_cifar100, cut to 2 x 20 steps
    model="resnet18", num_classes=100, dataset="synthetic", synthetic_n=50_000,
    batch_size=256, bf16=True, sync_bn=True, fused_optimizer=True, lr=0.1,
    epochs=2, steps_per_epoch=20, eval_every=1, log_every=10, seed=1,
)
RESNET_WARMUP = 2  # first steps of the run, left out of the step times
RESNET_PARITY_BATCH, RESNET_PARITY_STEPS = 32, 3
# f32 parity, TF32 off, fused SGD vs plain SGD from the same weights: the
# two updates are bit-identical (the kernel phase checks that). cuDNN's
# default backward algorithms may sum in another order from one call to the
# next, which lr 0.1 carried to 1.4e-5-1.08e-4 relative in the third loss on
# an H100 (the largest over this limit), so the parity runs cuDNN's
# deterministic algorithms: the runs differ in the update alone. Limit 1e-4.
RESNET_PARITY_LOSS_RTOL = 1e-4
# The same parity once more on cuDNN's default algorithms, whose backward may
# sum in another order from one call to the next: 1.08e-4 relative is the
# largest a third loss has read there (an H100, lr 0.1); the limit is ten
# times the deterministic run's, room for that order's f32 rounding carried
# through three steps at lr 0.1, far below any difference in the update
RESNET_PARITY_DEFAULT_LOSS_RTOL = 1e-3


def _free_port() -> int:
    import socket  # noqa: PLC0415

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resnet_parity() -> None:
    """f32, TF32 off: fused SGD against plain SGD from the same bridged
    weights, through the data-parallel step over the 1-rank NCCL group, on
    cuDNN's deterministic algorithms, then on its default ones."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    try:
        for det, rtol in ((True, RESNET_PARITY_LOSS_RTOL),
                          (False, RESNET_PARITY_DEFAULT_LOSS_RTOL)):
            torch.backends.cudnn.deterministic = det
            _resnet_parity_runs(rtol, "deterministic" if det else "default")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _resnet_parity_runs(rtol: float, algos: str) -> None:
    params, bn_state = bridge.resnet_params_to_jax(resnet_lib.resnet18(device="cpu", seed=0))
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.standard_normal(
        (RESNET_PARITY_STEPS, RESNET_PARITY_BATCH, 32, 32, 3), dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 100, (RESNET_PARITY_STEPS, RESNET_PARITY_BATCH),
                                           dtype=np.int32)).to(DEVICE)
    runs = {}
    for fused in (True, False):
        model = bridge.load_jax_resnet(resnet_lib.resnet18(device=DEVICE), params, bn_state)
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=fused)
        st = state_lib.TrainState.create(model, opt)
        train_step = step_lib.make_train_step(opt, sync_bn=True)
        before = fs.fused_sgd.launches
        losses = []
        for i in range(RESNET_PARITY_STEPS):
            st, metrics = train_step(st, images[i], labels[i], RESNET_RUN["lr"])
            losses.append(metrics["loss"].item())
        check(fs.fused_sgd.launches - before == (RESNET_PARITY_STEPS if fused else 0),
              f"resnet parity (fused={fused}): {fs.fused_sgd.launches - before} kernel launches")
        runs[fused] = (losses, [p.detach() for p in model.parameters()])
    (f_losses, f_params), (p_losses, p_params) = runs[True], runs[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(f_losses, p_losses)]
    worst = max(float((a - b).abs().max()) for a, b in zip(f_params, p_params))
    print(f"[resnet] parity, f32 (TF32 off), cuDNN's {algos} algorithms, batch "
          f"{RESNET_PARITY_BATCH}, {RESNET_PARITY_STEPS} steps: losses fused {f_losses} vs plain "
          f"{p_losses}; relative differences {rel} (limit {rtol}); largest parameter difference "
          f"{worst:.3g}")
    for i, (a, r) in enumerate(zip(f_losses, rel)):
        check(math.isfinite(a) and r <= rtol,
              f"resnet parity step {i} ({algos} cuDNN): loss fused {a!r} vs plain "
              f"{p_losses[i]!r}")


def _resnet_fit() -> dict:
    """The main path: ``Trainer(cfg).fit()`` with the counts set to 0 just
    before and read just after; every step timed to its synchronize."""
    cfg = TrainConfig(**RESNET_RUN, device=DEVICE)
    trainer = trainer_lib.Trainer(cfg)
    try:
        n_params = sum(p.numel() for p in trainer.model.parameters())
        check(n_params == RESNET_PARAMS, f"resnet18 has {n_params} parameters")
        inner, step_ms, losses = trainer.train_step, [], []

        def timed_step(st, images, labels, lr):
            t0 = time.perf_counter()
            st, metrics = inner(st, images, labels, lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            if len(step_ms) == RESNET_WARMUP:  # peak memory and plans of the steady steps
                torch.cuda.reset_peak_memory_stats()
                reset_plan_counts()
            return st, metrics

        trainer.train_step = timed_step
        torch.cuda.synchronize()
        counters_lib.reset()
        reset_launches()
        t0 = time.perf_counter()
        last = trainer.fit()
        fit_s = time.perf_counter() - t0
        launches, counts = read_launches(), counters_lib.snapshot()
        peak_bytes = torch.cuda.max_memory_allocated()
        read_plan_counts("resnet18", "resnet")
        steps = cfg.epochs * cfg.steps_per_epoch
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{len(losses)} steps, losses {losses}")
        check(launches["fused_sgd"] == steps,
              f"fused_sgd: {launches['fused_sgd']} launches in {steps} steps (expected 1 a step)")
        check(all(n == 0 for name, n in launches.items() if name != "fused_sgd"),
              f"resnet18 launched a flash kernel: {launches}")
        check(counts.get("comm.all_reduce.grad") == steps,
              f"{counts.get('comm.all_reduce.grad')} gradient all-reduces in {steps} steps")
        n_test = RESNET_RUN["synthetic_n"] // 5
        check(counts.get("eval.examples") == cfg.epochs * n_test,
              f"eval counted {counts.get('eval.examples')} examples in {cfg.epochs} evals "
              f"of {n_test}")
        check(math.isfinite(last["val_loss"]) and 0.0 <= last["val_top1"] <= 100.0,
              f"eval: {last}")
        timed = step_ms[RESNET_WARMUP:]
        mean_ms = float(np.mean(timed))
        comm = {k.removeprefix("comm.all_reduce."): v for k, v in counts.items()
                if k.startswith("comm.all_reduce.")}
        print(f"[resnet] resnet18_cifar100 through Trainer.fit: {n_params} parameters, bf16 "
              f"compute, global batch {cfg.batch_size} on {trainer.n_devices} rank "
              f"({torch.distributed.get_backend()}), "
              f"SyncBN, fused SGD; {steps} steps in {cfg.epochs} epochs, an eval of {n_test} "
              f"after each; fit {fit_s:.1f} s")
        print(f"[resnet] losses {[round(x, 4) for x in losses]}")
        print(f"[resnet] step ms (host clock, each step ended by synchronize; {len(timed)} "
              f"steps after {RESNET_WARMUP}): median {float(np.median(timed)):.3f}, mean "
              f"{mean_ms:.3f}, min {min(timed):.3f}, max {max(timed):.3f}; "
              f"{cfg.batch_size / mean_ms * 1e3:.1f} images/s; max_memory_allocated "
              f"{peak_bytes} bytes ({peak_bytes / 2 ** 30:.2f} GiB)")
        print(f"[resnet] launches in {steps} steps: {launches}; all-reduces by kind: {comm}")
        print(f"[resnet] eval after epoch {cfg.epochs - 1}: top-1 {last['val_top1']:.3f}, "
              f"top-5 {last['val_top5']:.3f}, loss {last['val_loss']:.4f} over "
              f"{counts.get('eval.examples') / cfg.epochs:.0f} real examples")
        batches = iter(trainer.train_loader)
        images, labels = next(batches)
        batches.close()
        _profile_steps(inner, trainer.state, images, labels,
                       lr=torch.full((), RESNET_RUN["lr"], device=DEVICE), tag="resnet")
        return launches, losses, float(np.median(timed))
    finally:
        trainer.close()


def _resnet_cli() -> None:
    """The real entry point, as a user starts it: one spawned rank per
    visible card; it must exit 0 and print one rank-0 epoch line."""
    cmd = [sys.executable, "-m", "tpu_dist_torch.cli.distributed_mp", "--dataset", "synthetic",
           "--synthetic_n", "2560", "--epochs", "1", "--steps_per_epoch", "3",
           "--batch_size", "256", "--device", DEVICE, "--port", str(_free_port())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parent)
    lines = proc.stdout.splitlines()
    done = [line for line in lines if line.startswith("Epoch 0 done")]
    print(f"[resnet] {' '.join(cmd[1:])}: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; " + (done[0] if done else "no epoch line"))
    check(proc.returncode == 0, f"distributed_mp exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check(len(done) == 1, f"{len(done)} epoch lines from one rank-0 process:\n{proc.stdout}")


RESNET_STOP_CALL = 29  # the 30th step (epoch 1, its 10th) sends SIGTERM before it runs
RESNET_MID_SAVE = 10   # mid_epoch_save_every of the interrupted run
RESNET_STEADY = 2      # resumed steps before the plan cache's steady window
# The first resumed step against step 30 of (b)'s own run: the restored
# state is the interrupted run's bit for bit, but that run and (b) are two
# bf16 runs whose cuDNN backward may sum in another order from one run to
# the next (and cuDNN may pick other algorithms), so their weights part at
# f32 rounding after the first step and 30 SGD steps at lr 0.1 carry that
# into the loss; each bf16 rounding is 2^-8 (3.9e-3) relative. Limit 2e-2
# relative; the first 30 losses of the two runs, printed beside, show the
# spread of the two runs before any checkpoint is involved.
RESNET_RESUME_LOSS_RTOL = 2e-2
# The first resumed step against the same step taken from the interrupted
# run's live state: the same state bits, the same batch, the same learning
# rate, and a loss that comes from the forward alone, whose cuDNN
# algorithms are deterministic: exact is expected, 1e-6 relative allowed.
RESNET_NEXT_LOSS_RTOL = 1e-6
CKPT_TIMING_REPEATS = 3


def _flat_equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _ckpt_io_times(state, ckpt_dir: str) -> None:
    """The card's times of the checkpoint I/O of the ResNet-18 state
    (parameters, momentum, BN statistics): a synchronous ``save``, the
    blocking part of an ``AsyncCheckpointer.save`` (the device-to-host
    snapshot) and a CRC-verified ``restore`` with its copy into the live
    tensors on the card; medians of a few, and the file's bytes."""
    times = {"save": [], "async": [], "restore": []}
    for i in range(CKPT_TIMING_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt_lib.save(ckpt_dir, state, 100 + i)
        times["save"].append((time.perf_counter() - t0) * 1e3)
        writer = ckpt_lib.AsyncCheckpointer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer.save(ckpt_dir, state, 200 + i)
        times["async"].append((time.perf_counter() - t0) * 1e3)
        check(writer.close(), "async checkpoint write did not drain")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = bridge.load_train_state(state, ckpt_lib.restore(path, verify=True))
        torch.cuda.synchronize()
        times["restore"].append((time.perf_counter() - t0) * 1e3)
    flat = bridge.train_state_to_flat(state)
    arrays = sum(a.nbytes for a in flat.values())
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[ckpt] ResNet-18 state, {len(flat)} arrays, {arrays} bytes; file {os.path.getsize(path)} "
          f"bytes (a temporary directory of the machine); medians of {CKPT_TIMING_REPEATS} (ms): "
          f"save {med['save']:.1f}, async save blocking {med['async']:.1f}, restore "
          f"(CRC-verified) + copy onto the card {med['restore']:.1f}; all: {times}")
    print(f"[ckpt] card: {_smi_line()}")


def _resnet_resume(fit_losses: list) -> None:
    """(d): the main path interrupted by SIGTERM at its 30th step and
    resumed by a new trainer, with the launch and all-reduce counts over
    both runs."""
    steps = RESNET_RUN["epochs"] * RESNET_RUN["steps_per_epoch"]
    done = RESNET_STOP_CALL + 1
    mid_step = done - RESNET_RUN["steps_per_epoch"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        cfg = TrainConfig(**RESNET_RUN, device=DEVICE, ckpt_dir=ckpt_dir, save_every=1,
                          mid_epoch_save_every=RESNET_MID_SAVE)
        first = trainer_lib.Trainer(cfg)
        second = None
        try:
            inner, losses = first.train_step, []

            def stopping_step(st, images, labels, lr):
                if len(losses) == RESNET_STOP_CALL:
                    os.kill(os.getpid(), signal.SIGTERM)  # the flag only: this step runs
                st, metrics = inner(st, images, labels, lr)
                losses.append(metrics["loss"].item())
                return st, metrics

            first.train_step = stopping_step
            torch.cuda.synchronize()
            reset_launches()
            preempted = False
            try:
                first.fit()
            except PreemptedError:
                preempted = True
            counts1 = counters_lib.snapshot()
            check(preempted and len(losses) == done,
                  f"SIGTERM at step {done}: preempted={preempted} after {len(losses)} steps")
            path = os.path.join(ckpt_dir, "ckpt_1.npz")
            meta = ckpt_lib.read_meta(path)
            snapshot = ckpt_lib.restore(path, verify=True)
            check(meta.get("mid_epoch_step") == mid_step and meta.get("step") == done,
                  f"emergency snapshot meta {meta.get('mid_epoch_step')=} {meta.get('step')=}")
            check(_flat_equal(snapshot, bridge.train_state_to_flat(first.state)),
                  "the emergency snapshot differs from the live state")
            check(counts1.get("preemption.observed") == 1, f"counters {counts1}")

            second = trainer_lib.Trainer(dataclasses.replace(cfg, resume=True))
            check((second.start_epoch, second._resume_step) == (1, mid_step),
                  f"resumed at epoch {second.start_epoch} step {second._resume_step}")
            check(_flat_equal(bridge.train_state_to_flat(second.state), snapshot),
                  "the restored state differs from the file")
            inner2, rest = second.train_step, []

            def resumed_step(st, images, labels, lr):
                st, metrics = inner2(st, images, labels, lr)
                rest.append(metrics["loss"].item())
                if len(rest) == RESNET_STEADY:
                    reset_plan_counts()
                return st, metrics

            second.train_step = resumed_step
            t0 = time.perf_counter()
            last = second.fit()
            resume_s = time.perf_counter() - t0
            launches, counts2 = read_launches(), counters_lib.snapshot()
            read_plan_counts("resnet18_resumed", "resume")
            hits, misses = PLAN_COUNTS["resnet18_resumed"]
            check(len(rest) == steps - done and all(math.isfinite(x) for x in losses + rest),
                  f"resumed {len(rest)} steps, losses {rest}")
            check(launches["fused_sgd"] == steps,
                  f"fused_sgd: {launches['fused_sgd']} launches over both runs (expected {steps})")
            for kind in ("grad", "metrics"):
                n = counts1.get(f"comm.all_reduce.{kind}", 0) + counts2.get(
                    f"comm.all_reduce.{kind}", 0)
                check(n == steps, f"{n} {kind} all-reduces over both runs (expected {steps})")
            check(hits >= 0.9 * (hits + misses) and hits + misses == len(rest) - RESNET_STEADY,
                  f"plan cache over the resumed steady steps: {hits} hits, {misses} misses")
            check(math.isfinite(last["val_loss"]), f"eval after the resume: {last}")

            # the same step from the interrupted run's live state
            first.train_sampler.set_epoch(1)
            batches = first.train_loader.iter_from(mid_step)
            images, labels = next(batches)
            batches.close()
            _, metrics = inner(first.state, images, labels,
                               torch.full((), first._lr(1), device=DEVICE))
            next_loss = metrics["loss"].item()
            spread = max(_rel(a, b) for a, b in zip(losses, fit_losses))
            rel30 = _rel(rest[0], fit_losses[done])
            print(f"[resume] SIGTERM before step {done} of {steps}: PreemptedError at its boundary; "
                  f"emergency snapshot mid_epoch_step={mid_step} equal to the live state; resumed "
                  f"{len(rest)} steps + eval in {resume_s:.1f} s; fused_sgd launches over both "
                  f"runs {launches['fused_sgd']}; gradient all-reduces "
                  f"{counts1.get('comm.all_reduce.grad')} + {counts2.get('comm.all_reduce.grad')}")
            print(f"[resume] first resumed loss {rest[0]!r}: vs the same step from the live state "
                  f"{next_loss!r} (relative {_rel(rest[0], next_loss):.3g}, limit "
                  f"{RESNET_NEXT_LOSS_RTOL}); vs step {done} of (b) {fit_losses[done]!r} (relative "
                  f"{rel30:.3g}, limit {RESNET_RESUME_LOSS_RTOL}); the first {done} losses of the "
                  f"two runs differ by up to {spread:.3g} relative")
            check(_rel(rest[0], next_loss) <= RESNET_NEXT_LOSS_RTOL,
                  f"first resumed loss {rest[0]!r} vs the live state's next step {next_loss!r}")
            check(rel30 <= RESNET_RESUME_LOSS_RTOL,
                  f"first resumed loss {rest[0]!r} vs step {done} of (b) {fit_losses[done]!r}")
            _serve_resnet_checkpoint(ckpt_dir, second.state.params, cfg)
            _ckpt_io_times(second.state, ckpt_dir)
        finally:
            first.close()
            if second is not None:
                second.close()


RESNET_SERVE_REQUESTS = 8
RESNET_IMAGE = (32, 32, 3)


def _serve_resnet_checkpoint(ckpt_dir: str, trained, cfg) -> None:
    """(d), last: the newest checkpoint of the resumed run, loaded with
    ``load_serving_state`` into a fresh module and served (f32); its logits
    must equal an eval-mode forward of the resumed trainer's model."""
    t0 = time.perf_counter()
    loaded = load_serving_state(ckpt_dir, trained)
    load_ms = (time.perf_counter() - t0) * 1e3
    model = trainer_lib.build_model(cfg, DEVICE, seed=123)
    bridge.load_jax_params(model, loaded["params"], loaded["bn_state"])
    payloads = np.random.default_rng(SERVE_SEED).standard_normal(
        (RESNET_SERVE_REQUESTS,) + RESNET_IMAGE, dtype=np.float32)
    engine = ServingEngine(model, max_batch=RESNET_SERVE_REQUESTS, device=DEVICE)
    engine.warmup(RESNET_IMAGE)
    reset_launches()
    for i, x in enumerate(payloads):  # one full batch: the shape of the forward below
        engine.submit(x, id=i)
    t0 = time.perf_counter()
    done = engine.pump()
    serve_ms = (time.perf_counter() - t0) * 1e3
    check(sum(read_launches().values()) == 0, f"serving ResNet launched {read_launches()}")
    check(len(done) == RESNET_SERVE_REQUESTS and all(r.ok for r in done),
          "the ResNet engine did not complete every request")
    was_training = trained.training
    trained.eval()
    with torch.inference_mode():
        want = trained(torch.from_numpy(payloads).to(DEVICE)).cpu().numpy()
    trained.train(was_training)
    worst = max(float(np.abs(r.result - want[r.id]).max()) for r in done)
    print(f"[serve] ResNet-18 from {os.path.basename(loaded['path'])} (step {loaded['step']}, "
          f"remapped {loaded['remapped']}): load {load_ms:.1f} ms; {len(done)} requests in "
          f"one batch, {serve_ms:.2f} ms; logits vs the resumed trainer's "
          f"eval-mode forward: max |diff| {worst:.3g}")
    check(worst == 0.0, "served ResNet logits differ from the trainer's eval-mode forward")


def _smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# the main path's configuration through the CLI, cut to 3 steps an epoch
LAUNCH_TRAIN_ARGS = ["--dataset", "synthetic", "--synthetic_n", "2560", "--batch_size", "256",
                     "--steps_per_epoch", "3", "--bf16", "--fused_optimizer"]


_STOPPED_AT = re.compile(r"SIGTERM observed (?:at epoch (\d+) after step (\d+)|"
                         r"after epoch (\d+) completed)")


def _postmortem(root, crash: str, d: str) -> dict:
    """``python -m tpu_dist_torch.obs postmortem crash d``: rank 0's report
    of the bundle it writes."""
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs", "postmortem", crash, d],
                          cwd=root, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"obs postmortem: rc {proc.returncode}\n{proc.stderr[-2000:]}")
    with open(os.path.join(crash, "postmortem.json")) as f:
        ranks = json.load(f)["ranks"]
    check([r["rank"] for r in ranks] == [0], f"postmortem ranks {[r['rank'] for r in ranks]}")
    return ranks[0]


def _flight_step_us() -> float:
    """Host us of one ``FlightRecorder.step`` (the ring's pwrite and the
    counter delta), median over 1,000 calls, with the registry as the
    training runs left it."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flight_") as d:
        ring = flight_lib.FlightRecorder(os.path.join(d, flight_lib.RING_NAME))
        times = []
        for i in range(1000):
            counters_lib.inc("train.steps")
            t = time.perf_counter()
            ring.step(0, i)
            times.append(time.perf_counter() - t)
        ring.close()
        check(flight_lib.last_step(flight_lib.decode(ring.path))["step"] == 999,
              "the ring does not end at the last step record")
    return statistics.median(times) * 1e6


def _resnet_launch() -> None:
    """(e): the launcher's SIGTERM contract (exit 75), with the crash
    forensics of ``--crash_dir`` read after it. (The launcher's ``--resume``
    runs in phase 11 (a)'s relaunch, and a clean exit's postmortem verdict
    in phase 19 (b).)"""
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as d:
        log = os.path.join(d, "h.jsonl")
        crash = os.path.join(d, "crash")
        train = [sys.executable, "-m", "tpu_dist_torch.cli.train", *LAUNCH_TRAIN_ARGS,
                 "--device", DEVICE, "--ckpt_dir", d, "--log_file", log, "--crash_dir", crash]
        launch = [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", "1", "--"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(launch + train + ["--epochs", "1000"], cwd=root, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        guard = threading.Timer(300, proc.kill)  # a launcher that never prints an epoch
        guard.start()
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("Epoch 0 done"):
                    proc.send_signal(signal.SIGTERM)
                    break
            out, _ = proc.communicate(timeout=300)
        finally:
            guard.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out = "".join(lines) + out
        newest = ckpt_lib.latest_checkpoint(d)
        print(f"[launch] {' '.join(launch[1:])} ... --epochs 1000, SIGTERM after its first epoch "
              f"line: rc {proc.returncode} in {time.perf_counter() - t0:.1f} s; newest "
              f"checkpoint {newest}")
        check(proc.returncode == PREEMPTION_EXIT_CODE and newest is not None,
              f"launcher under SIGTERM: rc {proc.returncode}, checkpoint {newest}:\n{out[-3000:]}")
        path, epoch = newest
        check(ckpt_lib.verify_npz(path)["epoch"] == epoch, f"{path} does not verify")
        stop = _STOPPED_AT.search(out)
        check(stop is not None, f"no SIGTERM line in the launcher's output:\n{out[-3000:]}")
        at = ((int(stop[1]), int(stop[2])) if stop[1] is not None
              else (int(stop[3]), int(LAUNCH_TRAIN_ARGS[LAUNCH_TRAIN_ARGS.index(
                  "--steps_per_epoch") + 1]) - 1))
        pm = _postmortem(root, crash, d)
        last = pm["flight"]["last_step"]
        check(pm["verdict"] == "preempted" and (last["epoch"], last["step"]) == at,
              f"postmortem after SIGTERM: verdict {pm['verdict']}, ring's last step {last}, "
              f"the run stopped at {at}")
        print(f"[flight] obs postmortem after SIGTERM: rank 0 {pm['verdict']}, "
              f"{pm['flight']['n_records']} ring records, last step record epoch "
              f"{last['epoch']} step {last['step']} (the run stopped there)")
        with open(log) as f:
            kinds = [json.loads(line)["kind"] for line in f]
        print(f"[launch] history {log}: {len(kinds)} records, kinds {sorted(set(kinds))}")
        check("train_epoch" in kinds, f"history kinds {kinds}")


def phase_train_resnet() -> tuple:
    """ResNet-18 on CIFAR-100-shaped data through the port's trainer over a
    1-rank NCCL group, then its checkpoint/resume and the fused epoch.
    Returns (launches of the main paths, fused SGD's numbers at
    ResNet-18's leaves)."""
    t0 = time.perf_counter()
    sgd = _sgd_kernel("resnet18", seed=3)
    sgd.update(_sgd_flat_shard(seed=5))
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        _resnet_parity()
        launches, losses, step_median = _resnet_fit()
        t1 = time.perf_counter()
        _resnet_resume(losses)
        print(f"[resume] part (d): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        fused = _resnet_fused(step_median)
        launches = {name: launches[name] + fused[name] for name in launches}
        print(f"[fused] part (f): {time.perf_counter() - t1:.1f} s")
    finally:
        if created:
            torch.distributed.destroy_process_group()
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli = pool.submit(_resnet_cli)  # (c) beside (e): neither is timed
        _resnet_launch()
        cli.result()
    print(f"[launch] parts (c) and (e), side by side: {time.perf_counter() - t1:.1f} s")
    print(f"[flight] FlightRecorder.step: {_flight_step_us():.2f} us of host a call "
          f"(median of 1,000); card: {_smi_line()}")
    print(f"[resnet] phase: {time.perf_counter() - t0:.1f} s")
    return launches, sgd


# -- phase 6 (f): the fused epoch ----------------------------------------------

# bench.py:243's resnet18_cifar100_fused: the streaming run's configuration
# with every step of each epoch (50,000 // 256 = 195) in a captured graph
RESNET_FUSED_RUN = {**RESNET_RUN, "steps_per_epoch": None, "fused_epoch": True}
FUSED_STEPS = 195
NCCL_PER_STEP = 42         # 1 grad, 1 metrics, 20 bn, 20 bn_grad
FUSED_PROFILE_STEPS = 25   # graph replays under torch.profiler
FUSED_PARITY_STEPS = 5
FUSED_PARITY_MODEL = resnet_lib.resnet18
# Graph replay against the eager step, both on the card from the same state
# on the same batches (the same order and crops). f32, TF32 off and cuDNN's
# deterministic algorithms on both sides: the graph replays the kernels the
# eager step launches, so only a kernel whose result depends on its launch
# could part them: each loss to 1e-5 relative, and each parameter's
# difference to 1e-5 of that parameter's largest update over the 5 replays.
# bf16 (the main path's algorithms): a flip of one bf16 rounding where the
# f32 values straddle it, carried through 5 steps: the loss to 2e-3
# relative, the bf16 limit of the other parity checks.
FUSED_PARITY_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
FUSED_PARITY_PARAM_RTOL = 1e-5


def _fused_profile(trainer, images, labels, lr) -> None:
    """``FUSED_PROFILE_STEPS`` replays of the captured step under
    torch.profiler: the device's count of fused SGD and NCCL all-reduce
    kernels a step, and the device's busy share of the window. At a world
    of one NCCL's in-place sum is no device work (no kernel), so the 42
    collectives a step are held to the profiler's host-side record of one
    eager step instead, beside the counts the capture set aside."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    runner = trainer._fused_runner
    order, offsets = runner.draw(2, len(images), DEVICE)
    order, offsets = order[:FUSED_PROFILE_STEPS], offsets[:FUSED_PROFILE_STEPS]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(trainer.state, images, labels, lr, order, offsets)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
    counts = {e.key: e.count for e in rows}
    sgd = sum(n for k, n in counts.items() if "fused_sgd_kernel" in k)
    nccl = sum(n for k, n in counts.items() if "nccl" in k.lower() and "allreduce" in k.lower())
    print(f"[fused] profiler over {FUSED_PROFILE_STEPS} replays: fused_sgd_kernel {sgd}, NCCL "
          f"all-reduce kernels {nccl} ({sgd / FUSED_PROFILE_STEPS:g} and "
          f"{nccl / FUSED_PROFILE_STEPS:g} a step); device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall (idle share {1 - busy_us / wall_us:.3f}, under the "
          f"profiler); {sum(counts.values()) / FUSED_PROFILE_STEPS:.0f} kernels a step")
    for key, n in sorted(counts.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[fused]   x{n}  {key[:90]}")
    world = trainer.n_devices
    check(sgd == FUSED_PROFILE_STEPS, f"{sgd} fused_sgd kernels in {FUSED_PROFILE_STEPS} replays")
    check(nccl == (NCCL_PER_STEP * FUSED_PROFILE_STEPS if world > 1 else 0),
          f"{nccl} NCCL all-reduce kernels in {FUSED_PROFILE_STEPS} replays at world {world}")

    # the collectives one step issues: the profiler's record of an eager
    # step on the same batch, and the counts the capture set aside
    mean, std_inv = epoch_lib.normalizer(transforms.CIFAR100_MEAN, transforms.CIFAR100_STD,
                                         DEVICE)
    x = epoch_lib.augment(images, order[0], offsets[0], pad=4, mean=mean, std_inv=std_inv,
                          dtype=torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(trainer.state, x, labels.index_select(0, order[0]), lr)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()
             if "allreduce" in e.key.lower().replace("_", "")}
    captured = {k.removeprefix("comm.all_reduce."): v for k, v in runner._loop._counts.items()
                if k.startswith("comm.all_reduce.")}
    print(f"[fused] one eager step under torch.profiler, all-reduce ranges on the host: {calls}; "
          f"the capture's counts a replay: {captured}")
    check(calls.get("c10d::allreduce_") == NCCL_PER_STEP == sum(captured.values()),
          f"all-reduces a step: profiler {calls}, capture {captured} (expected {NCCL_PER_STEP})")


def _fused_parity(compute_dtype, images, labels, make_opt=None, tag="fused",
                  wire="none") -> None:
    """Graph replay against the port's eager step from the same bridged
    weights on the same batches: 5 steps that warm up, capture and replay,
    then 5 steps that only replay, each against ``make_train_step``.
    ``make_opt()`` makes each side's optimizer (the fused SGD by default);
    ``wire`` is both sides' ``grad_compression`` (under ``int8_ef`` each
    starts from zero residuals)."""
    make_opt = make_opt or (lambda: optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True))
    f32 = compute_dtype == torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = f32
    params, bn_state = bridge.resnet_params_to_jax(FUSED_PARITY_MODEL(device="cpu", seed=0))
    pairs = []
    for _ in range(2):
        model = bridge.load_jax_resnet(FUSED_PARITY_MODEL(device=DEVICE), params, bn_state)
        opt = make_opt()
        st = state_lib.TrainState.create(model, opt)
        if wire == "int8_ef":
            lay = step_lib.flat_layout(model)
            st = dataclasses.replace(st, ef=step_lib.init_ef_state(model, layout=lay), layout=lay)
        pairs.append((model, opt, st))
    (graph_model, graph_opt, graph_st), (eager_model, eager_opt, eager_st) = pairs
    batch = RESNET_RUN["batch_size"]
    runner = epoch_lib.make_fused_epoch(graph_opt, batch_per_device=batch,
                                        compute_dtype=compute_dtype, seed=7,
                                        grad_compression=wire)
    train_step = step_lib.make_train_step(eager_opt, sync_bn=True, compute_dtype=compute_dtype,
                                          grad_compression=wire)
    lr = torch.full((), RESNET_RUN["lr"], device=DEVICE)
    order, offsets = runner.draw(0, len(images), DEVICE)
    mean, std_inv = epoch_lib.normalizer(transforms.CIFAR100_MEAN, transforms.CIFAR100_STD,
                                         DEVICE)
    before_launches = fs.fused_sgd.launches
    graph_losses, eager_losses = [], []
    for lo in (0, FUSED_PARITY_STEPS):
        rows = slice(lo, lo + FUSED_PARITY_STEPS)
        before = [p.detach().clone() for p in graph_model.parameters()]
        graph_st, _ = runner.run(graph_st, images, labels, lr, order[rows], offsets[rows])
        graph_losses.append(runner.step_metrics[:, 0].tolist())
        losses = []
        for i in range(lo, lo + FUSED_PARITY_STEPS):
            x = epoch_lib.augment(images, order[i], offsets[i], pad=4, mean=mean,
                                  std_inv=std_inv, dtype=compute_dtype)
            eager_st, m = train_step(eager_st, x, labels.index_select(0, order[i]), lr)
            losses.append(m["loss"].item())
        eager_losses.append(losses)
    torch.backends.cudnn.deterministic = False
    check(runner._loop.graph is not None, "the fused runner captured no graph")
    launched = fs.fused_sgd.launches - before_launches
    per_step = 1 if getattr(graph_opt, "fused", False) else 0
    check(launched == 4 * FUSED_PARITY_STEPS * per_step,
          f"{launched} fused_sgd launches counted over 2 x {2 * FUSED_PARITY_STEPS} steps")
    tol = FUSED_PARITY_TOL[compute_dtype]
    rel = max(_rel(a, b) for g, e in zip(graph_losses, eager_losses) for a, b in zip(g, e))
    worst = max(
        float((a - b).abs().max()) / max(float((a - p0).abs().max()), 1e-30)
        for a, b, p0 in zip(graph_model.parameters(), eager_model.parameters(), before)
        for a, b in [(a.detach(), b.detach())])
    name = ("f32 (TF32 off, deterministic cuDNN)" if f32 else "bf16") + (
        f", grad_compression {wire}" if wire != "none" else "")
    print(f"[{tag}] parity {name}, batch {batch}: warmup + capture + replays, then "
          f"{FUSED_PARITY_STEPS} replays, against the eager step; losses graph "
          f"{graph_losses} vs eager {eager_losses}; largest relative loss difference {rel:.3g} "
          f"(limit {tol}); largest parameter difference over the replayed steps' update "
          f"{worst:.3g}" + (f" (limit {FUSED_PARITY_PARAM_RTOL})" if f32 else ""))
    check(all(math.isfinite(x) for g in graph_losses for x in g) and rel <= tol,
          f"graph replay vs eager step ({name}): loss differs by {rel:.3g} relative")
    if f32:
        check(worst <= FUSED_PARITY_PARAM_RTOL,
              f"graph replay vs eager step: parameters differ by {worst:.3g} of their update")


def _resnet_fused(step_median_ms: float) -> dict:
    """(f): ``Trainer(fused_epoch=True).fit()``, 2 epochs of 195 captured
    steps with a fused eval of the 10,000 test images after each, the
    counts set to 0 just before and read just after; then a profile of the
    replays and the graph-vs-eager parity. Returns the fit's launches."""
    cfg = TrainConfig(**RESNET_FUSED_RUN, device=DEVICE)
    trainer = trainer_lib.Trainer(cfg)
    try:
        epochs, inner = [], trainer.train_epoch

        def train_epoch(epoch, *a, **k):
            epochs.append(inner(epoch, *a, **k))
            return epochs[-1]

        trainer.train_epoch = train_epoch
        images, labels = trainer._fused_data
        test_images, test_labels = trainer._fused_test_data
        data_bytes = sum(t.numel() * t.element_size()
                         for t in (images, labels, test_images, test_labels))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters_lib.reset()
        reset_launches()
        t0 = time.perf_counter()
        last = trainer.fit()
        fit_s = time.perf_counter() - t0
        launches, counts = read_launches(), counters_lib.snapshot()
        peak_bytes = torch.cuda.max_memory_allocated()
        steps = cfg.epochs * FUSED_STEPS
        losses = [e["loss"] for e in epochs]
        comm = {k.removeprefix("comm.all_reduce."): v for k, v in counts.items()
                if k.startswith("comm.all_reduce.")}
        runner = trainer._fused_runner
        print(f"[fused] resnet18_cifar100_fused through Trainer(fused_epoch=True).fit: "
              f"{len(images)} train images ({images.numel()} bytes) and {len(test_images)} test "
              f"images on the card ({data_bytes} bytes with labels), {cfg.epochs} epochs of "
              f"{FUSED_STEPS} steps, a fused eval after each; fit {fit_s:.1f} s")
        captures = {"train": runner.capture_s, "eval": trainer._fused_eval.capture_s}
        print(f"[fused] capture (warmup {epoch_lib.WARMUP_STEPS} steps + capture), seconds: "
              f"{captures}")
        check(None not in captures.values(), f"a fused path captured no graph: {captures}")
        for e, rec in enumerate(epochs):
            print(f"[fused] epoch {e}: {rec['epoch_time']:.3f} s, {rec['images_per_sec']:.1f} "
                  f"images/s, step {rec['epoch_time'] / FUSED_STEPS * 1e3:.3f} ms (epoch time / "
                  f"{FUSED_STEPS}), loss {rec['loss']:.4f}, acc1 {rec['acc1']:.2f}")
        print(f"[fused] beside: the streaming resnet18_cifar100 step median {step_median_ms:.3f} "
              f"ms in this run; max_memory_allocated {peak_bytes} bytes "
              f"({peak_bytes / 2 ** 30:.2f} GiB)")
        print(f"[fused] launches in {steps} steps: {launches}; all-reduces by kind: {comm}; "
              f"eval examples {counts.get('eval.examples')}")
        check(len(losses) == cfg.epochs and all(math.isfinite(x) for x in losses),
              f"fused epoch losses {losses}")
        check(launches["fused_sgd"] == counts.get("comm.all_reduce.grad") == steps,
              f"fused_sgd {launches['fused_sgd']} launches and "
              f"{counts.get('comm.all_reduce.grad')} gradient all-reduces in {steps} steps")
        check(counts.get("comm.all_reduce.metrics") == steps,
              f"{counts.get('comm.all_reduce.metrics')} metrics all-reduces in {steps} steps")
        check(all(n == 0 for name, n in launches.items() if name != "fused_sgd"),
              f"resnet18 launched a flash kernel: {launches}")
        n_test = RESNET_RUN["synthetic_n"] // 5
        check(counts.get("eval.examples") == cfg.epochs * n_test,
              f"fused eval counted {counts.get('eval.examples')} examples in {cfg.epochs} "
              f"evals of {n_test}")
        check(math.isfinite(last["val_loss"]), f"fused eval: {last}")
        _fused_profile(trainer, images, labels, torch.full((), RESNET_RUN["lr"], device=DEVICE))
        for dtype in (torch.float32, torch.bfloat16):
            _fused_parity(dtype, images, labels)
        print(f"[fused] card: {_smi_line()}")
        return launches
    finally:
        trainer.close()


# -- phase 7: AdamW, LARS and LAMB, remat, the native input pipeline ----------

# vit_b16_imagenet_flash's shapes (bench.py:260-263) with AdamW as the trainer
# builds it (weight decay 1e-4, decay mask "auto", b1 0.9, b2 0.999, eps
# 1e-8) at the usual ViT AdamW learning rate (SGD's 0.1 would diverge)
OPTIM_LR = 1e-3
OPTIM_CFG = TrainConfig(optimizer="adamw")
# AdamW's update moves 7 f32 arrays of the parameters' size: p, g, mu and nu
# read once, p, mu and nu written once (28 bytes a parameter); ~16 f32
# operations a parameter (the moments 6, the bias-corrected direction 5, the
# decay and the step 4 on decayed leaves)
ADAMW_BYTES, ADAMW_FLOPS = 28, 16
# (b) remat against (a): the recomputed forward repeats the same kernels on
# the same inputs, so the losses should agree exactly; a cuBLAS heuristic
# that picked another algorithm under the recomputation's other memory
# state would move them by bf16 rounding: the 2e-3 relative of the other
# bf16 parity checks
REMAT_LOSS_RTOL = 2e-3
# (c) f32 parity, TF32 off, flash vs plain attention with AdamW or LAMB:
# the attention's gradients differ by f32 rounding (~1e-6 relative), which
# Adam's normalised step carries into the update at the same relative
# size, but for the key part of each qkv bias: its gradient is 0 in exact
# arithmetic (a shift of every key by one vector moves a query's scores by
# a constant, which the softmax ignores), so each side's is rounding noise,
# which Adam normalises into steps of ~lr of either sign. So the losses to
# 1e-4 relative, as with SGD; the parameters but those elements by the norm
# over all of them, |p_flash - p_xla| / |p_xla - p_0| <= 1e-3; the key
# biases finite, their difference printed
OPTIM_PARITY_PARAM_RTOL = 1e-3
# (d) the real entry point, ResNet-18 with LARS and the large-batch recipe
OPTIM_CLI_ARGS = ["--model", "resnet18", "--num_classes", "100", "--dataset", "synthetic",
                  "--synthetic_n", "50000", "--batch_size", "256", "--bf16",
                  "--optimizer", "lars", "--lr_base_batch", "256", "--warmup_epochs", "1",
                  "--epochs", "1", "--steps_per_epoch", "20", "--eval_every", "0"]
GATHER_REPEATS = 20
# (e) the fused epoch with AdamW: one epoch of all 195 steps
OPTIM_FUSED_RUN = {**RESNET_FUSED_RUN, "optimizer": "adamw", "fused_optimizer": False,
                   "lr": OPTIM_LR, "epochs": 1}


def adamw_bound(n: int):
    return bound(ADAMW_BYTES * n, ADAMW_FLOPS * n, PEAK_F32_FLOPS)


def _vit_adamw(remat: bool, images, labels) -> dict:
    """(a)/(b): the ViT-B/16 AdamW step, TRAIN_WARMUP + TRAIN_STEPS steps,
    the launch counts set to 0 just before the timed steps and read just
    after."""
    model = _bridged_vit_b16("flash")
    opt = trainer_lib.make_optimizer(OPTIM_CFG)
    st = state_lib.TrainState.create(model, opt)
    train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16, remat=remat)
    for _ in range(TRAIN_WARMUP):
        st, _ = train_step(st, images, labels, OPTIM_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        st, metrics = train_step(st, images, labels, OPTIM_LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches, mma = read_launches(), read_mma_launches()
    peak = torch.cuda.max_memory_allocated()
    fwd = 24 if remat else 12  # the recomputation runs each block's forward again
    want = {"flash_attention_fwd": fwd, "flash_attention_bwd_dkdv": 12,
            "flash_attention_bwd_dq": 12, "fused_sgd": 0}
    for name, per_step in want.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"adamw remat={remat}: {name} {launches[name]} launches in {TRAIN_STEPS} steps "
              f"(expected {per_step} a step)")
    for name in MMA_KERNELS:
        check(mma[name] == launches[name], f"adamw remat={remat}: {name} {mma[name]} of "
              f"{launches[name]} launches on the tensor-core route")
    check(all(math.isfinite(x) for x in losses), f"adamw remat={remat}: losses {losses}")
    check(int(st.opt_state["count"].item()) == TRAIN_WARMUP + TRAIN_STEPS,
          f"adamw count {st.opt_state['count'].item()}")
    mean_ms = float(np.mean(step_ms))
    print(f"[optim] ViT-B/16 AdamW (lr {OPTIM_LR}, bf16, batch {TRAIN_BATCH}, flash), remat="
          f"{remat}: {TRAIN_STEPS} steps after {TRAIN_WARMUP}: losses "
          f"{[round(x, 5) for x in losses]}; step ms median {float(np.median(step_ms)):.3f}, "
          f"mean {mean_ms:.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}; "
          f"{TRAIN_BATCH / mean_ms * 1e3:.1f} images/s; max_memory_allocated {peak} bytes "
          f"({peak / 2 ** 30:.2f} GiB); launches {launches}, tensor-core {mma}")
    return {"losses": losses, "ms": mean_ms, "median_ms": float(np.median(step_ms)),
            "peak": peak, "launches": launches, "mma": mma}


def _adamw_update_ms() -> None:
    """AdamW's update alone at ViT-B/16's 151 leaves: device ms with a head
    start and host us a call, beside its bytes bound and, as a yardstick
    the port never calls, ``torch.optim.AdamW(fused=True).step()``."""
    shapes = fused_sgd_bench.leaf_shapes("vit_b16")
    n = sum(s.numel() for s in shapes)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    params = [torch.randn(s, device=DEVICE, generator=gen) for s in shapes]
    grads = [torch.randn(s, device=DEVICE, generator=gen) * 1e-2 for s in shapes]
    opt = trainer_lib.make_optimizer(OPTIM_CFG)
    st = opt.init(params)
    lr = torch.full((), OPTIM_LR, device=DEVICE)
    # ~80 multi-tensor launches a call: 5 calls stay inside the launch queue
    # while the device sleeps through the head start (20 filled it)
    ms, host = cuda_ms(lambda: opt.update(grads, st, params, lr), iters=5, warmup=2)
    lib_params = [p.clone() for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=OPTIM_LR, weight_decay=1e-4, fused=True)
    lib_ms, lib_host = cuda_ms(lib.step, iters=20)
    bound_ms, by = adamw_bound(n)
    print(f"[optim] AdamW update at ViT-B/16's {len(shapes)} leaves, {n} parameters: "
          f"{ms:.4f} ms on the device, host {host:.1f} us a call; bound {bound_ms:.4f} ms "
          f"({by}: {ADAMW_BYTES * n / 1e9:.3f} GB), {bound_ms / ms:.1%} of it; yardstick "
          f"torch.optim.AdamW(fused=True).step() {lib_ms:.4f} ms, host {lib_host:.1f} us")


def _key_bias_masks() -> list:
    """Per ViT-B/16 parameter (in order), a bool mask of the elements whose
    gradient is 0 in exact arithmetic: the key part of each block's qkv
    bias (adding one vector to every key shifts each query's scores by a
    constant, which the softmax ignores), or None for a parameter without
    such elements."""
    model = vit_b16(device="meta")
    masks = []
    for name, p in model.named_parameters():
        if name.endswith("qkv.bias"):
            mask = torch.zeros(p.shape, dtype=torch.bool)
            heads = model.blocks[0].heads
            mask.view(heads, 3, -1)[:, 1, :] = True  # [heads, (q, k, v), head dim]
            masks.append(mask.to(DEVICE))
        else:
            masks.append(None)
    return masks


def _optim_parity(name: str, make_opt) -> None:
    """(c): f32, TF32 off, flash against plain attention with ``make_opt()``
    from the same bridged weights on the same batches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = _parity_runs(torch.float32, make_opt=lambda impl: make_opt(), lr=OPTIM_LR)
    (flash_losses, init, flash_p), (xla_losses, _, xla_p) = runs["flash"], runs["xla"]
    rel = [abs(a - b) / abs(b) for a, b in zip(flash_losses, xla_losses)]
    diff = moved = key_worst = 0.0
    n_key = 0
    for mask, p0, a, b in zip(_key_bias_masks(), init, flash_p, xla_p):
        d, m = (a - b).double(), (b - p0).double()
        if mask is not None:
            check(bool(torch.isfinite(a[mask]).all()), f"{name} parity: a key bias is not finite")
            key_worst = max(key_worst, float(d[mask].abs().max()))
            n_key += int(mask.sum())
            d, m = d[~mask], m[~mask]
        diff += float(d.square().sum())
        moved += float(m.square().sum())
    diff, moved = math.sqrt(diff), math.sqrt(moved)
    print(f"[optim] f32 parity (TF32 off), flash vs xla attention, {name}: batch "
          f"{PARITY_BATCH}, {PARITY_STEPS} steps; losses flash {flash_losses} vs xla "
          f"{xla_losses}, relative {rel} (limit {PARITY_LOSS_RTOL}); parameters but the "
          f"{n_key} key-bias elements: |diff| / |update| {diff / moved:.3g} (limit "
          f"{OPTIM_PARITY_PARAM_RTOL}); key biases (rounding noise normalised into steps of "
          f"~lr): largest difference {key_worst:.3g} ({key_worst / OPTIM_LR:.3g} lr)")
    for i, (a, r) in enumerate(zip(flash_losses, rel)):
        check(math.isfinite(a) and r <= PARITY_LOSS_RTOL,
              f"{name} parity step {i}: loss flash {a!r} vs xla {xla_losses[i]!r}")
    check(diff <= OPTIM_PARITY_PARAM_RTOL * moved,
          f"{name} parity: parameters differ by {diff:.3g} over an update of {moved:.3g}")


def _gather_ms() -> None:
    """The host ms of one 256-image train batch through the native library
    and through the numpy path, on CIFAR-shaped data (median of
    GATHER_REPEATS calls each, in turns)."""
    images = np.random.default_rng(0).integers(0, 256, (50_000, 32, 32, 3), dtype=np.uint8)
    sel = np.random.default_rng(1).permutation(len(images))[:RESNET_RUN["batch_size"]]
    times = {"native": [], "numpy": []}
    for i in range(GATHER_REPEATS):
        for name, fn in (("native", native.gather_augment),
                         ("numpy", transforms.gather_augment)):
            t0 = time.perf_counter()
            fn(images, sel, seed=i, train=True)
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[optim] gather_augment of {len(sel)} CIFAR images (train), host ms, median of "
          f"{GATHER_REPEATS}: native {med['native']:.3f} (min {min(times['native']):.3f}), "
          f"numpy {med['numpy']:.3f} (min {min(times['numpy']):.3f}); {os.cpu_count()} CPUs")


def _optim_cli(d: str) -> None:
    """(d): ResNet-18 with LARS and ``--remat`` through ``python -m
    tpu_dist_torch.cli.train``: exit 0, the native pipeline on the rank-0
    start line, ``data_stall_frac`` from the history. (One child: the run
    without ``--remat``, a second CUDA child, was cut to keep the smoke
    inside its bound; (a) and (b) run the step with and without remat in
    this process.)"""
    for remat in (True,):
        log = os.path.join(d, f"lars_remat{int(remat)}.jsonl")
        cmd = [sys.executable, "-m", "tpu_dist_torch.cli.train", *OPTIM_CLI_ARGS,
               "--log_file", log, "--device", DEVICE, "--port", str(_free_port())]
        if remat:
            cmd.append("--remat")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=pathlib.Path(__file__).resolve().parent)
        secs = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        start = [line for line in lines if line.startswith("tpu_dist_torch: model=")]
        check(proc.returncode == 0, f"cli.train --optimizer lars remat={remat} exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        check(len(start) == 1 and "optimizer=lars" in start[0] and f"remat={remat}" in start[0]
              and "input=native" in start[0], f"the rank-0 start line: {start}")
        with open(log) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        epoch = [r for r in recs if r.get("kind") == "train_epoch"]
        check(len(epoch) == 1 and epoch[0]["steps"] == 20 and math.isfinite(epoch[0]["loss"]),
              f"lars remat={remat}: train_epoch records {epoch}")
        e = epoch[0]
        print(f"[optim] cli.train LARS (lr 0.1 x 256/256, 1 warmup epoch), remat={remat}: rc "
              f"{proc.returncode} in {secs:.1f} s; {start[0]}")
        print(f"[optim]   20 steps: data_stall_frac {e['data_stall_frac']}, data_wait_s "
              f"{e['data_wait_s']}, epoch_time {e['epoch_time']:.3f} s, step p50 "
              f"{e.get('step_time_p50', float('nan')) * 1e3:.3f} ms, loss {e['loss']:.4f}, "
              f"{e['images_per_sec']:.1f} images/s")


def _optim_fused() -> int:
    """(e): ``Trainer(fused_epoch=True, optimizer="adamw").fit()``, one epoch
    of 195 replays, over the 1-rank NCCL group; then replay against the
    eager step, f32, as phase 6 (f). Returns the fused SGD launches (0)."""
    cfg = TrainConfig(**OPTIM_FUSED_RUN, device=DEVICE)
    trainer = trainer_lib.Trainer(cfg)
    try:
        epochs, inner = [], trainer.train_epoch

        def train_epoch(epoch, *a, **k):
            epochs.append(inner(epoch, *a, **k))
            return epochs[-1]

        trainer.train_epoch = train_epoch
        reset_launches()
        t0 = time.perf_counter()
        trainer.fit()
        fit_s = time.perf_counter() - t0
        launches = read_launches()["fused_sgd"]
        count = int(trainer.state.opt_state["count"].item())
        e, capture_s = epochs[0], trainer._fused_runner.capture_s
        # the epoch holds the eager warmup steps and the capture, then the replays
        replays = FUSED_STEPS - epoch_lib.WARMUP_STEPS
        replay_ms = ((e["epoch_time"] - capture_s) / replays * 1e3 if capture_s is not None
                     else float("nan"))
        print(f"[optim] resnet18_cifar100_fused with AdamW (lr {OPTIM_LR}): fit {fit_s:.1f} s, "
              f"epoch {e['epoch_time']:.3f} s of which warmup + capture {capture_s} s; the "
              f"replayed step {replay_ms:.3f} ms ({replays} replays); loss {e['loss']:.4f}, "
              f"count {count}, fused_sgd launches {launches}")
        check(math.isfinite(e["loss"]) and count == FUSED_STEPS and launches == 0,
              f"fused AdamW epoch: loss {e['loss']}, count {count}, fused_sgd {launches}")
        images, labels = trainer._fused_data
        _fused_parity(torch.float32, images, labels,
                      make_opt=lambda: trainer_lib.make_optimizer(OPTIM_CFG), tag="optim")
        return launches
    finally:
        trainer.close()


def phase_optim(work: str) -> dict:
    """Phase 7. Returns the flash kernels' launches of (a) and (b)."""
    t0 = time.perf_counter()
    check(native.available(), f"the native input pipeline: {native.describe()}")
    print(f"[optim] input pipeline: {native.describe()}")
    rng = np.random.default_rng(TRAIN_SEED)
    images = torch.from_numpy(
        rng.standard_normal((TRAIN_BATCH,) + IMAGE, dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH).astype(np.int32)).to(DEVICE)
    plain = _vit_adamw(False, images, labels)
    remat = _vit_adamw(True, images, labels)
    rel = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"], plain["losses"]))
    print(f"[optim] remat vs plain: losses differ by {rel:.3g} relative at most (limit "
          f"{REMAT_LOSS_RTOL}); peak memory {remat['peak']} vs {plain['peak']} bytes "
          f"({remat['peak'] / plain['peak']:.3f}); step ms median {remat['median_ms']:.3f} vs "
          f"{plain['median_ms']:.3f} ({remat['median_ms'] / plain['median_ms']:.3f})")
    check(rel <= REMAT_LOSS_RTOL, f"remat losses {remat['losses']} vs {plain['losses']}")
    _adamw_update_ms()
    _optim_parity("AdamW", lambda: trainer_lib.make_optimizer(OPTIM_CFG))
    _optim_parity("LAMB", lambda: optim.LAMB(weight_decay=1e-4))
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        fused_sgd = _optim_fused()
    finally:
        if created:
            torch.distributed.destroy_process_group()
    _gather_ms()
    _optim_cli(work)  # CUDA children last: they can empty this process's profiler
    print(f"[optim] card: {_smi_line()}")
    print(f"[optim] phase: {time.perf_counter() - t0:.1f} s")
    return {name: plain["launches"][name] + remat["launches"][name]
            + (fused_sgd if name == "fused_sgd" else 0) for name in KERNELS}


# -- phase 9: the training forensics chain -------------------------------------

# bench.py:240's resnet18_cifar100 shapes through the real entry points
# the drill's own flags, then the trainer's flags (after the drill's ``--``)
FORENSICS_SHAPE = ["--model", "resnet18", "--batch_size", "256"]
FORENSICS_FLAGS = ["--num_classes", "100", "--bf16", "--fused_optimizer"]
FORENSICS_STEPS = 20
FORENSICS_HANG_STEP = 5
# the healthy child: the trainer's CLI, then its fused SGD launch count
FORENSICS_CHILD = (
    "from tpu_dist_torch.cli import train\n"
    "from tpu_dist_torch.ops import fused_sgd\n"
    "try:\n"
    "    train.main()\n"
    "finally:\n"
    "    print(f'[child] fused_sgd launches {fused_sgd.fused_sgd.launches}', flush=True)\n"
)


def _watch_healthy(proc, hb: str, port: int) -> tuple:
    """While the launcher runs: every distinct beat of ``hb`` as ``(pid,
    counter, mono_s, phase, step)``, one HTTP scrape of the rank-0
    endpoint that returns samples (the trainer publishes after its first
    step), parsed, or None, and the clock when the launcher was seen to
    exit."""
    from tpu_dist_torch.obs import heartbeat as heartbeat_lib  # noqa: PLC0415

    beats, scraped = [], None
    while proc.poll() is None:
        rec = heartbeat_lib.read(hb)
        if rec is not None and (not beats or beats[-1][:2] != (rec["pid"], rec["counter"])):
            beats.append((rec["pid"], rec["counter"], rec["mono_s"], rec["phase"], rec["step"]))
        if scraped is None and beats:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    scraped = export_lib.parse(r.read().decode()) or None
            except OSError:  # not listening yet, or already closed
                pass
        time.sleep(0.02)
    return beats, scraped, time.monotonic()


def _healthy_round(root, d: str) -> tuple:
    """(a): the launcher with every forensic flag over a healthy ResNet-18
    trainer. Returns its fused SGD launches and the longest gap between two
    beats the watchdog saw, spawn counting as the first and the launcher's
    exit as the last (the last step's beat to the exit holds the epoch-end
    eval, the gap a run of more epochs has before its next beat)."""
    hb_dir, metrics_dir, crash = (os.path.join(d, k) for k in ("hb", "metrics", "crash"))
    port = _free_port()
    cmd = [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", "1",
           "--heartbeat_dir", hb_dir, "--metrics_dir", metrics_dir, "--crash_dir", crash,
           "--watchdog_timeout", "120", "--watchdog_dump_grace", "5", "--watchdog_grace", "5",
           "--", sys.executable, "-c", FORENSICS_CHILD, "--dataset", "synthetic",
           *FORENSICS_SHAPE, *FORENSICS_FLAGS, "--device", DEVICE, "--epochs", "1",
           "--steps_per_epoch", str(FORENSICS_STEPS), "--log_every", "10",
           "--metrics_port", str(port)]
    t_spawn = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=root, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    out: list = []
    reader = threading.Thread(target=lambda: out.extend(proc.stdout), daemon=True)
    reader.start()
    guard = threading.Timer(300, proc.kill)
    guard.start()
    try:
        beats, scraped, t_exit = _watch_healthy(proc, os.path.join(hb_dir, "hb.json"), port)
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        reader.join(timeout=10)
    took = time.monotonic() - t_spawn
    out = "".join(out)
    check(proc.returncode == 0, f"healthy launcher round: rc {proc.returncode}\n{out[-3000:]}")
    launched = re.search(r"\[child\] fused_sgd launches (\d+)", out)
    launches = int(launched[1]) if launched else -1
    check(launches == FORENSICS_STEPS, f"the healthy child launched fused_sgd {launches} times "
          f"in {FORENSICS_STEPS} steps")
    check(not os.path.exists(os.path.join(hb_dir, "hb.json")),
          "the clean exit left its heartbeat file")
    counters_seen = [b[1] for b in beats]
    check(beats and counters_seen == sorted(set(counters_seen))
          and len({b[0] for b in beats}) == 1 and beats[0][3] == "start",
          f"the heartbeat's records over the run: {beats}")
    with open(os.path.join(metrics_dir, "metrics.prom")) as f:
        expo = export_lib.parse(f.read())
    # one beat at the start and one a step, however many the 1 s throttle wrote
    check(expo.get("tpu_dist_heartbeat_beats") == 1 + FORENSICS_STEPS
          and expo.get("tpu_dist_train_steps") == FORENSICS_STEPS,
          f"the last exposition: beats {expo.get('tpu_dist_heartbeat_beats')}, steps "
          f"{expo.get('tpu_dist_train_steps')}")
    check(scraped is not None and "tpu_dist_loader_batches_consumed" in scraped,
          f"no HTTP scrape of the rank-0 endpoint during the run: {scraped}")
    scraped = scraped or {}
    times = [t_spawn] + [b[2] for b in beats] + [t_exit]
    names = ["spawn"] + [f"{b[3]} (beat {b[1]}, step {b[4]})" for b in beats] + ["exit"]
    gaps = [(b - a, f"{names[i]} -> {names[i + 1]}") for i, (a, b) in
            enumerate(zip(times, times[1:]))]
    longest, where = max(gaps)
    print(f"[forensics] healthy: launcher + {FORENSICS_STEPS} steps of "
          f"{' '.join(FORENSICS_SHAPE + FORENSICS_FLAGS)}: rc {proc.returncode} in {took:.1f} s; "
          f"{len(beats)} heartbeat "
          f"records seen (counters {counters_seen}); last exposition "
          f"{len(expo)} samples, heartbeat_beats {expo['tpu_dist_heartbeat_beats']:g}; one "
          f"HTTP scrape with {len(scraped)} samples; fused_sgd launches {launches}")
    print(f"[forensics] healthy: longest beat gap {longest:.3f} s ({where}); the last beat -> "
          f"exit (the epoch-end eval and the teardown) {gaps[-1][0]:.3f} s; gaps "
          f"{[round(g, 3) for g, _ in gaps]}")
    return launches, longest


def _wedge_drill(root, d: str, longest_gap: float) -> None:
    """(b): ``python -m tpu_dist_torch.obs.drill`` at the same shapes, wedged
    at step 5, with a watchdog timeout above (a)'s longest gap."""
    timeout = math.ceil(longest_gap + max(5.0, 0.5 * longest_gap))
    work = os.path.join(d, "drill")
    cmd = [sys.executable, "-m", "tpu_dist_torch.obs.drill", "--device", DEVICE,
           "--workdir", work, *FORENSICS_SHAPE, "--steps_per_epoch", str(FORENSICS_STEPS),
           "--hang_step", str(FORENSICS_HANG_STEP), "--watchdog_timeout", str(timeout),
           "--watchdog_dump_grace", "10", "--watchdog_grace", "2", "--round_timeout", "240",
           "--", *FORENSICS_FLAGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    check(proc.returncode == 0, f"the drill: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("postmortem-drill: timings ")), None)
    check(line is not None, f"the drill printed no timings:\n{proc.stdout[-3000:]}")
    timings = json.loads(line.removeprefix("postmortem-drill: timings "))
    with open(os.path.join(work, "postmortem.json")) as f:
        rank0 = next(r for r in json.load(f)["ranks"] if r["rank"] == 0)
    last = rank0["flight"]["last_step"]
    check((last["epoch"], last["step"]) == (0, FORENSICS_HANG_STEP)
          and "_hang" in rank0["stack"]["stuck_frame"],
          f"the bundle: ring ends at {last}, stuck frame {rank0['stack']['stuck_frame']}")
    wedge = next((ln for ln in proc.stderr.splitlines() if "wedged" in ln), "")
    print(f"[forensics] drill: {' '.join(FORENSICS_SHAPE + FORENSICS_FLAGS)} wedged by "
          f"hang@epoch=0:step={FORENSICS_HANG_STEP}, --watchdog_timeout {timeout} s: rc 0 in {took:.1f} s; {wedge.strip()}")
    print(f"[forensics] drill: detection {timings['detect_s']} s (the last beat landed -> the "
          f"wedge line; last beat {timings['last_beat'].get('phase')} step "
          f"{timings['last_beat'].get('step')}), dump wait {timings['dump_wait_s']} s (SIGUSR1 "
          f"-> the dump settled), SIGTERM -> exit {timings['sigterm_to_exit_s']} s")
    print(f"[forensics] drill: bundle verdict {rank0['verdict']}, stuck frame "
          f"{rank0['stack']['stuck_frame']}, ring ends at epoch {last['epoch']} step "
          f"{last['step']}")


def phase_forensics(work: str) -> dict:
    """Phase 9: the training forensics chain on the card (module docstring).
    Returns the fused SGD launches of the healthy child."""
    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    d = os.path.join(work, "forensics")
    os.makedirs(d)
    launches, longest = _healthy_round(root, d)
    _wedge_drill(root, d, longest)
    print(f"[forensics] phase: {time.perf_counter() - t0:.1f} s; card: {_smi_line()}")
    return {name: launches if name == "fused_sgd" else 0 for name in KERNELS}


# -- phase 10: ZeRO-1, the compressed reduce, the elastic resume ----------------

# bench.py:240's resnet18_cifar100 at full width, one epoch of 20 steps of
# 256 on 5,120 synthetic images (the data cut to what 20 steps read); no
# eval. Every run of (a) and (b) has deterministic cuDNN, so runs that
# should agree can be held to each other exactly; their step times are
# compared with one another only.
ELASTIC_RUN = {**RESNET_RUN, "synthetic_n": 5_120, "epochs": 1, "eval_every": 0}
ELASTIC_STEPS = 20
ELASTIC_WARMUP = 2
ELASTIC_STOP = "sigterm@epoch=0:step=9"  # the int8_ef run stopped after its 10th step
# The compressed wires against "none", per step: bf16 rounds each reduced
# gradient entry to 8 bits (2^-9 relative at most); int8 moves each by at
# most one quantisation step, 1/127 of its 256-entry chunk's largest entry:
# at most 5% of the chunk's RMS where the largest entry is 6 RMS,
# unbiased. The step's update, and so the loss of the next batch, moves by
# no more than that fraction: the limit is 5% relative at every step (a
# narrow ResNet on the CPU, 20 steps at lr 0.1, moved 1.2% under bf16 and
# 2.7% under int8).
COMPRESSED_LOSS_RTOL = {"bf16": 5e-2, "int8": 5e-2, "int8_ef": 5e-2}
REDUCE_ITERS = 5  # the quantized reduce is ~30 launches a call: 5 calls fit the head start


def _elastic_fit(tag: str, ckpt_dir=None, **kw) -> dict:
    """``Trainer.fit`` of ELASTIC_RUN with ``kw``: counts set to 0 just
    before and read just after, every step ended by ``synchronize``.
    Returns the losses, the step times after the warmup, the peak memory
    of those steps, the fused SGD launches, the collectives' counts, the
    state's flat parts, and ``preempted`` when a ``fault_plan`` stopped it."""
    cfg = TrainConfig(**{**ELASTIC_RUN, **kw}, device=DEVICE, ckpt_dir=ckpt_dir)
    trainer = trainer_lib.Trainer(cfg)
    try:
        inner, step_ms, losses = trainer.train_step, [], []

        def timed_step(st, images, labels, lr):
            t0 = time.perf_counter()
            st, metrics = inner(st, images, labels, lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            if len(step_ms) == ELASTIC_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            return st, metrics

        trainer.train_step = timed_step
        torch.cuda.synchronize()
        counters_lib.reset()
        reset_launches()
        preempted = False
        try:
            trainer.fit()
        except PreemptedError:
            preempted = True
        st = trainer.state
        ef = {k: float(v.norm()) for k, v in (st.ef or {}).items()}
        out = {"losses": losses, "step_ms": step_ms[ELASTIC_WARMUP:],
               "peak": torch.cuda.max_memory_allocated(), "launches": read_launches(),
               "counts": counters_lib.snapshot(), "ef_norms": ef, "preempted": preempted,
               "layout": st.layout, "start_epoch": trainer.start_epoch}
        med = float(np.median(out["step_ms"])) if out["step_ms"] else float("nan")
        print(f"[elastic] {tag}: {len(losses)} steps, losses {[round(x, 5) for x in losses]}; "
              f"step ms median {med:.3f} ({len(out['step_ms'])} after {ELASTIC_WARMUP}); "
              f"max_memory_allocated {out['peak']} bytes; fused_sgd launches "
              f"{out['launches']['fused_sgd']}; collectives "
              f"{ {k: v for k, v in out['counts'].items() if k.startswith('comm.')} }"
              + (f"; residual norms {ef}" if ef else ""))
        out["median_ms"] = med
        return out
    finally:
        trainer.close()


def _zero1_vs_plain() -> dict:
    """(a) ZeRO-1 against the plain DP step from the same weights."""
    plain = _elastic_fit("plain DP step")
    zero1 = _elastic_fit("ZeRO-1 (shard_weight_update)", shard_weight_update=True)
    n = zero1["layout"].chunk if zero1["layout"] else None
    print(f"[elastic] (a) ZeRO-1 vs plain at one rank: losses equal {zero1['losses'] == plain['losses']}; "
          f"the flat shard {n} f32; step ms median {zero1['median_ms']:.3f} vs "
          f"{plain['median_ms']:.3f} ({zero1['median_ms'] / plain['median_ms']:.3f}); peak "
          f"memory {zero1['peak']} vs {plain['peak']} bytes ({zero1['peak'] - plain['peak']:+d})")
    # at one rank the shard is the whole raveled vector and its update the
    # plain update's six roundings: the same losses, bit for bit
    check(zero1["losses"] == plain["losses"] and len(plain["losses"]) == ELASTIC_STEPS,
          f"ZeRO-1 losses {zero1['losses']} vs plain {plain['losses']}")
    check(n == RESNET_PARAMS, f"the flat shard has {n} elements")
    check(zero1["launches"]["fused_sgd"] == ELASTIC_STEPS,
          f"fused_sgd on the flat shard: {zero1['launches']['fused_sgd']} launches in "
          f"{ELASTIC_STEPS} steps")
    c = zero1["counts"]
    check(c.get("comm.reduce_scatter.grad") == c.get("comm.all_gather.params") == ELASTIC_STEPS
          and "comm.all_reduce.grad" not in c, f"ZeRO-1's collectives: {c}")
    return {"plain": plain, "zero1": zero1}


def _reduce_ms() -> None:
    """(b) The compressed reduce alone at ResNet-18's 62 gradient leaves
    (11.2 M f32) against NCCL's all-reduce of the same flat buffer, device
    ms with a head start, at one rank."""
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    grads = [torch.randn(s, device=DEVICE, generator=gen)
             for s in fused_sgd_bench.leaf_shapes("resnet18")]
    flat = torch.cat([g.reshape(-1) for g in grads])
    lay = step_lib.flat_layout(grads)
    ef = step_lib.init_ef_state(grads, layout=lay)
    nccl_ms, _ = cuda_ms(lambda: collectives.all_reduce_(flat, kind="timing"), iters=REDUCE_ITERS)
    times = {"none": cuda_ms(lambda: step_lib.compressed_pmean(grads, "none"),
                             iters=REDUCE_ITERS)[0]}
    key = step_lib.quant_key(0)
    for mode in ("bf16", "int8", "int8_ef"):
        times[mode] = cuda_ms(lambda: step_lib.compressed_pmean(
            grads, mode, key=key, ef=ef if mode == "int8_ef" else ()), iters=REDUCE_ITERS)[0]
    wire = {"none": 4, "bf16": 2, "int8": 1, "int8_ef": 1}
    print(f"[elastic] (b) the gradient reduce at ResNet-18's {len(grads)} leaves ({flat.numel()} "
          f"f32), device ms a call with a head start, one rank: NCCL all_reduce of the flat "
          f"buffer {nccl_ms:.4f}; compressed_pmean {{mode: ms}} "
          f"{ {k: round(v, 4) for k, v in times.items()} }; wire bytes an element {wire}")
    check(all(math.isfinite(v) for v in times.values()), f"reduce times {times}")


def _compressed(plain: dict) -> dict:
    """(b) Trainer.fit on each compressed wire against ``none``, and the
    int8_ef run stopped by SIGTERM after its 10th step and resumed: the
    resumed losses must be the uninterrupted run's, bit for bit."""
    runs = {}
    for mode in ("bf16", "int8", "int8_ef"):
        runs[mode] = r = _elastic_fit(f"grad_compression {mode}", grad_compression=mode)
        rel = max(_rel(a, b) for a, b in zip(r["losses"], plain["losses"]))
        print(f"[elastic] (b) {mode} vs none: losses within {rel:.3g} relative (limit "
              f"{COMPRESSED_LOSS_RTOL[mode]}); step ms median {r['median_ms']:.3f} vs "
              f"{plain['median_ms']:.3f} ({r['median_ms'] / plain['median_ms']:.3f})")
        check(len(r["losses"]) == ELASTIC_STEPS and rel <= COMPRESSED_LOSS_RTOL[mode],
              f"{mode}: losses {r['losses']} vs none {plain['losses']}")
    check(all(v > 0 for v in runs["int8_ef"]["ef_norms"].values())
          and set(runs["int8_ef"]["ef_norms"]) == {"r1", "r2"},
          f"int8_ef residual norms {runs['int8_ef']['ef_norms']}")
    c = runs["int8"]["counts"]
    check(c.get("comm.all_to_all.grad") == c.get("comm.all_gather.grad") == ELASTIC_STEPS,
          f"the int8 reduce's collectives: {c}")
    d = tempfile.mkdtemp(prefix="elastic_ckpt_")
    try:
        cut = _elastic_fit("int8_ef stopped by SIGTERM", ckpt_dir=d, grad_compression="int8_ef",
                           fault_plan=ELASTIC_STOP)
        rest = _elastic_fit("int8_ef resumed", ckpt_dir=d, grad_compression="int8_ef",
                            resume=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    whole = cut["losses"] + rest["losses"]
    print(f"[elastic] (b) int8_ef, SIGTERM after step 9 and resume: {len(cut['losses'])} + "
          f"{len(rest['losses'])} steps; equal to the uninterrupted run's losses: "
          f"{whole == runs['int8_ef']['losses']}")
    check(cut["preempted"] and len(cut["losses"]) == 10 and rest["start_epoch"] == 0,
          f"the stopped run: preempted {cut['preempted']}, {len(cut['losses'])} steps")
    check(whole == runs["int8_ef"]["losses"],
          f"resumed int8_ef losses {whole} vs {runs['int8_ef']['losses']}")
    return runs


def _fused_int8_ef() -> int:
    """(c) The fused epoch on the int8_ef wire: one epoch of 195 replays
    over the 1-rank NCCL group, then replay against the eager step (f32).
    Returns its fused SGD launches."""
    cfg = TrainConfig(**{**RESNET_FUSED_RUN, "epochs": 1, "eval_every": 0,
                         "grad_compression": "int8_ef"}, device=DEVICE)
    trainer = trainer_lib.Trainer(cfg)
    try:
        reset_launches()
        t0 = time.perf_counter()
        last = trainer.fit()
        fit_s = time.perf_counter() - t0
        launches = read_launches()["fused_sgd"]
        steps = trainer.state.step
        ef = {k: float(v.norm()) for k, v in trainer.state.ef.items()}
        print(f"[elastic] (c) resnet18_cifar100_fused on the int8_ef wire: fit {fit_s:.1f} s, "
              f"loss {last['loss']:.4f}, steps (state.step) {steps}, fused_sgd launches "
              f"{launches}, residual norms {ef}, capture {trainer._fused_runner.capture_s} s")
        check(math.isfinite(last["loss"]) and steps == FUSED_STEPS
              and launches == FUSED_STEPS and all(v > 0 for v in ef.values()),
              f"fused int8_ef epoch: loss {last['loss']}, steps {steps}, launches {launches}, "
              f"residuals {ef}")
        images, labels = trainer._fused_data
        _fused_parity(torch.float32, images, labels, tag="elastic", wire="int8_ef")
        return launches
    finally:
        trainer.close()


def phase_elastic(work: str) -> dict:
    """Phase 10 (module docstring). Returns the fused SGD launches of its
    main paths: the ZeRO-1 run's on the flat shard, and the fused epoch's."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        runs = _zero1_vs_plain()
        _reduce_ms()
        _compressed(runs["plain"])
        torch.backends.cudnn.deterministic = False
        fused = _fused_int8_ef()
    finally:
        torch.backends.cudnn.deterministic = False
        if created:
            torch.distributed.destroy_process_group()
    print(f"[elastic] phase: {time.perf_counter() - t0:.1f} s; card: {_smi_line()}")
    return {name: runs["zero1"]["launches"][name] + (fused if name == "fused_sgd" else 0)
            for name in KERNELS}


# -- phase 11: elastic supervision ------------------------------------------------

# bench.py:240's resnet18_cifar100 at full width through the trainer's CLI,
# one epoch of 20 steps on 5,120 synthetic images, no eval
SUP_TRAIN = ["--model", "resnet18", "--num_classes", "100", "--dataset", "synthetic",
             "--synthetic_n", "5120", "--batch_size", "256", "--bf16", "--fused_optimizer",
             "--lr", "0.1", "--epochs", "1", "--steps_per_epoch", "20", "--eval_every", "0",
             "--log_every", "10", "--seed", "1"]
SUP_STEPS = 20
SUP_STOP = "sigterm@epoch=0:step=9"   # round 0 stops after its 10th step
SUP_DECISION = (7, "goodput")         # the allocation file's tokens in (a)
SUP_BACKOFF = 0.5                     # --elastic_backoff: the first relaunch waits this
SUP_TIMEOUT = 240
# 3 -> 1 -> 3: vit_tiny's 107,978 parameters do not divide by 3, so both
# resumes re-lay the ZeRO-1 state (at 2 -> 1 -> 2 neither would)
FLEET_DRILL_ARGS = ["--phase", "grow", "--device", "cpu", "--shrink_device", "cuda",
                    "--devices", "3", "--batch_size", "48"]
FLEET_DRILL_TIMEOUT = 300
# the trainer's CLI with every step's loss, the restore's span and the
# clocks a relaunch is timed by; at exit its fused SGD launches and its
# fleet.decision_id gauge
SUP_CHILD = """
import os, sys, time
print(f"[child] start {time.time()!r} restarts={os.environ.get('TPU_DIST_ELASTIC_RESTARTS')} "
      f"resume={'--resume' in sys.argv} "
      f"decision={os.environ.get('TPU_DIST_FLEET_DECISION_ID')}", flush=True)
from tpu_dist_torch.cli import train
from tpu_dist_torch.obs import counters
from tpu_dist_torch.ops import fused_sgd
from tpu_dist_torch.train import trainer as trainer_lib
restore, fit = trainer_lib.Trainer._restore_latest, trainer_lib.Trainer.fit
def timed_restore(self):
    t = time.time()
    try:
        return restore(self)
    finally:
        print(f"[child] restore {t!r} {time.time()!r}", flush=True)
def logged_fit(self, *a, **k):
    inner = self.train_step
    def step(st, images, labels, lr):
        st, m = inner(st, images, labels, lr)
        print(f"[child] loss {m['loss'].item()!r} at {time.time()!r}", flush=True)
        return st, m
    self.train_step = step
    return fit(self, *a, **k)
trainer_lib.Trainer._restore_latest, trainer_lib.Trainer.fit = timed_restore, logged_fit
try:
    train.main()
finally:
    import torch
    print(f"[child] fused_sgd launches {fused_sgd.fused_sgd.launches}", flush=True)
    print(f"[child] gauge {counters.snapshot().get('fleet.decision_id')}", flush=True)
    if torch.cuda.is_available():
        print(f"[child] peak {torch.cuda.max_memory_allocated()}", flush=True)
    print(f"[child] exit {time.time()!r}", flush=True)
"""


def _children(out: str) -> list:
    """Each child's lines, parsed: its start line's fields, its losses and
    their clocks, its restore span, its launches, its gauge and its exit
    clock (None where it printed none: a SIGKILLed child)."""
    kids = []
    for line in out.splitlines():
        if not line.startswith("[child] "):
            continue
        word, *rest = line.removeprefix("[child] ").split()
        if word == "start":
            fields = dict(f.split("=", 1) for f in rest[1:])
            kids.append({"start": float(rest[0]), **fields, "losses": [], "loss_at": [],
                         "restore": None, "launches": None, "gauge": None, "peak": None,
                         "exit": None})
        elif word == "loss":
            kids[-1]["losses"].append(float(rest[0]))
            kids[-1]["loss_at"].append(float(rest[2]))
        elif word == "restore":
            kids[-1]["restore"] = (float(rest[0]), float(rest[1]))
        elif word == "fused_sgd":
            kids[-1]["launches"] = int(rest[1])
        elif word == "gauge":
            kids[-1]["gauge"] = None if rest[0] == "None" else float(rest[0])
        elif word == "peak":
            kids[-1]["peak"] = int(rest[0])
        elif word == "exit":
            kids[-1]["exit"] = float(rest[0])
    return kids


def _sup_launch(root, d: str, elastic: list, extra: list, on_line=None,
                child: str = SUP_CHILD) -> tuple:
    """``python -m tpu_dist_torch.cli.launch --nproc 1 <elastic> --`` over
    ``child`` (SUP_CHILD) with SUP_TRAIN and ``extra``. ``on_line(proc,
    line)`` sees every line of the children's output as it comes. Returns
    the exit code, the output, the launcher's stderr and the seconds it
    took."""
    cmd = [sys.executable, "-m", "tpu_dist_torch.cli.launch", "--nproc", "1", *elastic, "--",
           sys.executable, "-c", child, *SUP_TRAIN, "--device", DEVICE, *extra]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    err: list = []
    reader = threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)
    reader.start()
    guard = threading.Timer(SUP_TIMEOUT, proc.kill)
    guard.start()
    out: list = []
    try:
        for line in proc.stdout:
            out.append(line)
            if on_line is not None:
                on_line(proc, line)
        proc.wait()
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    return proc.returncode, "".join(out), "".join(err), time.perf_counter() - t0


#: phase 11's result lines, printed again by the report just before the
#: card's line, so they stay in the tail of a long log
SUP_SUMMARY: list = []


def _sup_say(msg: str, keep: bool = True) -> None:
    print(f"[elastic-sup] {msg}", flush=True)
    if keep:
        SUP_SUMMARY.append(msg)


#: what phase 12 (a) reads of phase 11 (a): the runs' histories and
#: textfiles, the children's clocks, and the hub's pass over the relaunched
#: child (``_watch_hub``)
GOODPUT_RUNS: dict = {}


def _watch_hub(metrics: str, beat: str) -> None:
    """In a thread, from the relaunched child's start: wait for its textfile
    to carry its closed epoch's goodput (the trainer publishes the totals of
    closed windows, at the epoch's end), then one ``TelemetryHub`` pass over
    the textfile and the heartbeat. The child beats until its clean exit
    sweeps the file, one checkpoint save after the epoch's window closes;
    a pass that comes after the sweep reads the run as not alive, and says
    so. The snapshot and page go to GOODPUT_RUNS."""
    from tpu_dist_torch.obs import hub as hub_lib  # noqa: PLC0415

    def watch():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            vals = export_lib.scrape(textfile=metrics) or {}
            if vals.get(export_lib.metric_name("goodput.goodput_frac"), 0) > 0:
                hub = hub_lib.TelemetryHub([hub_lib.RunSource(
                    "trainer", metrics_file=metrics, heartbeat_file=beat, kind="train")])
                snap = hub.collect()
                GOODPUT_RUNS["hub"] = (snap, hub.federated(snap))
                return
            time.sleep(0.005)

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    GOODPUT_RUNS["hub_thread"] = thread


def _sup_relaunch(root, d: str) -> int:
    """(a): a golden run, then the supervised run stopped by SUP_STOP in
    round 0 and relaunched at world 1 with --resume, each with a history
    and a textfile (read in phase 12 (a)). Returns the fused SGD launches
    of both runs."""
    runs = {name: {"log": os.path.join(d, f"{name}.jsonl"),
                   "metrics": os.path.join(d, f"{name}.prom")}
            for name in ("golden", "supervised")}
    GOODPUT_RUNS.update(runs)
    rc, out, err, took = _sup_launch(
        root, d, [], ["--ckpt_dir", os.path.join(d, "golden"), "--log_file",
                      runs["golden"]["log"], "--metrics_file", runs["golden"]["metrics"]])
    [golden] = _children(out)
    _sup_say(f"(a) golden: launcher --nproc 1 over {' '.join(SUP_TRAIN)}: rc {rc} "
             f"in {took:.1f} s; {len(golden['losses'])} losses, fused_sgd launches "
             f"{golden['launches']}")
    check(rc == 0 and len(golden["losses"]) == SUP_STEPS and golden["launches"] == SUP_STEPS,
          f"golden run: rc {rc}, {golden}\n{out[-2000:]}\n{err[-2000:]}")
    cap = os.path.join(d, "allocation")
    with open(cap, "w") as f:
        f.write(f"1 decision={SUP_DECISION[0]} cause={SUP_DECISION[1]}\n")
    log, crash = runs["supervised"]["log"], os.path.join(d, "crash")
    beat = os.path.join(d, "supervised.hb")

    def on_line(proc, line):
        # the relaunched child: the hub's watch begins
        if line.startswith("[child] start") and "restarts=1" in line:
            _watch_hub(runs["supervised"]["metrics"], beat)

    rc, out, err, took = _sup_launch(
        root, d, ["--elastic_min_procs", "1", "--elastic_backoff", str(SUP_BACKOFF),
                  "--elastic_probe_interval", "0.5", "--elastic_capacity_file", cap],
        ["--ckpt_dir", os.path.join(d, "elastic"), "--log_file", log, "--crash_dir", crash,
         "--fault_plan", SUP_STOP, "--metrics_file", runs["supervised"]["metrics"],
         "--heartbeat_file", beat], on_line)
    kids = _children(out)
    GOODPUT_RUNS.update(golden_kid=golden, kids=kids)
    _sup_say(f"(a) supervised, {SUP_STOP} in the command of every round: rc {rc} "
             f"in {took:.1f} s; rounds {[(k['restarts'], k['resume']) for k in kids]} "
             f"(TPU_DIST_ELASTIC_RESTARTS, --resume); launcher: "
             + " | ".join(ln.removeprefix("launch: ") for ln in err.splitlines()
                          if ln.startswith("launch:")))
    check(rc == 0 and len(kids) == 2, f"supervised run: rc {rc}, {len(kids)} rounds\n"
          f"{out[-2000:]}\n{err[-2000:]}")
    first, second = kids
    check((first["restarts"], first["resume"], second["restarts"], second["resume"])
          == ("0", "False", "1", "True")
          and first["decision"] == second["decision"] == str(SUP_DECISION[0]),
          f"the rounds' env and flags: {kids}")
    check(len(first["losses"]) == 10 and len(second["losses"]) == SUP_STEPS - 10
          and first["launches"] == 10 and second["launches"] == SUP_STEPS - 10,
          f"round 0: {len(first['losses'])} steps, {first['launches']} launches; round 1: "
          f"{len(second['losses'])} steps, {second['launches']} launches")
    both = first["losses"] + second["losses"]
    rel = max(_rel(a, b) for a, b in zip(both, golden["losses"]))
    _sup_say(f"(a) losses of 10 + 10 steps vs the golden run: equal bit for bit "
             f"{both == golden['losses']} (--seed makes cuDNN deterministic), max relative "
             f"gap {rel:.3g}; fused_sgd launches {first['launches']} + {second['launches']}")
    check(both == golden["losses"], f"resumed losses {both} vs golden {golden['losses']}")
    with open(log) as f:
        [resume] = [r for r in map(json.loads, f) if r.get("kind") == "resume"]
    ring = flight_lib.decode(os.path.join(crash, flight_lib.RING_NAME))
    slots = [r for r in ring["records"] if r.get("kind") == "resume"]
    _sup_say(f"(a) resume record: decision_id {resume.get('decision_id')}, "
             f"decision_cause {resume.get('decision_cause')}, restarts {resume.get('restarts')}, "
             f"mid_epoch_step {resume.get('mid_epoch_step')}; fleet.decision_id gauge "
             f"{second['gauge']}; flight ring resume entries {slots}")
    check((resume.get("decision_id"), resume.get("decision_cause"), resume.get("restarts"))
          == (SUP_DECISION[0], SUP_DECISION[1], 1) and second["gauge"] == SUP_DECISION[0]
          and any(r.get("decision_id") == SUP_DECISION[0] for r in slots),
          f"the decision's tokens: record {resume}, gauge {second['gauge']}, ring {slots}")
    # the relaunch gap: round 0's exit -> the relaunched child's first step
    gap = second["loss_at"][0] - first["exit"]
    begin, end = second["restore"]
    start = begin - first["exit"] - SUP_BACKOFF
    _sup_say(f"(a) relaunch: round 0's exit -> the relaunched child's first step "
             f"{gap:.3f} s = backoff {SUP_BACKOFF:.3f} + process start {start:.3f} (reaping, "
             f"spawn, interpreter, torch and CUDA, the process group, the model and data, up "
             f"to the restore) + restore {end - begin:.3f} + to the first step "
             f"{second['loss_at'][0] - end:.3f}; round 0's first step came "
             f"{first['loss_at'][0] - first['start']:.3f} s after its script started")
    return golden["launches"] + first["launches"] + second["launches"]


def _fleet_drill(root, d: str) -> None:
    """(d) ``python -m tpu_dist_torch.fleet.drill --phase grow --device cpu
    --shrink_device cuda``: golden and full-size rounds as 3 gloo ranks, the
    shrunken round on the card; both resumes re-lay the ZeRO-1 state."""
    cmd = [sys.executable, "-m", "tpu_dist_torch.fleet.drill", "--workdir", d,
           *FLEET_DRILL_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=FLEET_DRILL_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("fleet-drill:")]
    for ln in lines:
        if ("resume record" in ln or ln.startswith("fleet-drill: epoch") or "PASS" in ln
                or "FAIL" in ln or "round" in ln or "capacity" in ln):
            _sup_say(f"(d) {ln}", keep=not ("round" in ln or "capacity" in ln))
    _sup_say(f"(d) drill: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0 and any("PASS grow" in ln for ln in lines),
          f"the fleet drill failed (exit {proc.returncode}):\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    records = [json.loads(ln.split(": ", 2)[2]) for ln in lines
               if ln.startswith("fleet-drill: resume record (")]
    check([(r["prev_dp"], r["dp"], r["resharded"]) for r in records]
          == [(3, 1, True), (1, 3, True)],
          f"the drill's resume records: {records}")


def phase_supervision(work: str) -> dict:
    """Phase 11 (module docstring). Returns the fused SGD launches of its
    trainer children."""
    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    d = os.path.join(work, "supervision")
    os.makedirs(d)
    launches = _sup_relaunch(root, d)
    drill = os.path.join(d, "fleet_drill")
    os.makedirs(drill)
    _fleet_drill(root, drill)
    _sup_say(f"phase: {time.perf_counter() - t0:.1f} s, fused_sgd launches "
             f"{launches}; card: {_smi_line()}")
    return {name: launches if name == "fused_sgd" else 0 for name in KERNELS}


# -- phase 12: goodput, the hub and the tenancy day ------------------------------------

# the buckets of a record and its window (or elapsed time): each of the 10
# terms is rounded to 4 decimals, so their sum drifts by at most ~5e-4
GOODPUT_TOL = 1e-3
# the ledger's relaunch gap against phase 11 (a)'s, once each is reduced to
# the same span (two processes' clocks, the history's ts to the millisecond)
GOODPUT_GAP_TOL_S = 0.5
# the recorded diurnal day with JAX's trainer (vit_tiny, batch 32, ZeRO-1),
# the fused SGD on, 2 CPU ranks at full size and the shrunken round, 1 rank,
# on the card (one card holds one rank); cut to the CPU test's depth, 3
# epochs of 3 steps with the stop at step 0 of epoch 1
# (tests/test_torch_tenancy_drill.py), from the drill's 4 x 8
TENANCY_STEPS = 3  # the drill's --steps_per_epoch
TENANCY_ARGS = ["--phase", "hub", "--device", "cpu", "--shrink_device", "cuda",
                "--devices", "2", "--shrink_to", "1", "--fused_optimizer", "--epochs", "3",
                "--steps_per_epoch", str(TENANCY_STEPS), "--kill_step", "0"]
TENANCY_BATCH = 32
TENANCY_TIMEOUT = 300

#: phase 12's result lines, repeated by the report after phase 11's
GOODPUT_SUMMARY: list = []


def _p12_say(tag: str, msg: str, keep: bool = True) -> None:
    print(f"[{tag}] {msg}", flush=True)
    if keep:
        GOODPUT_SUMMARY.append(f"[{tag}] {msg}")


def _history(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _bucket_sum(rec: dict) -> float:
    return sum(rec.get(f"{b}_s", 0.0) for b in goodput_lib.ALL_BUCKETS)


def _goodput_on_card() -> None:
    """(a): the goodput records of phase 11 (a)'s golden and supervised
    runs, the supervised run's ledger over its two segments, its relaunch
    gap against phase 11's, and the hub's pass over the relaunched child."""
    for name in ("golden", "supervised"):
        recs = _history(GOODPUT_RUNS[name]["log"])
        gp = [r for r in recs if r.get("kind") == "goodput"]
        windows = [r for r in gp if not r.get("final")]
        finals = [r for r in gp if r.get("final")]
        check(windows and finals, f"{name}: no goodput records in its history")
        worst = max([abs(_bucket_sum(r) - r["window_s"]) for r in windows]
                    + [abs(_bucket_sum(r) - r["elapsed_s"]) for r in finals])
        check(worst < GOODPUT_TOL, f"{name}: buckets and wall clock differ by {worst} s")
        ledger = goodput_lib.run_ledger(recs)
        check(abs(_bucket_sum(ledger) - ledger["elapsed_s"]) < GOODPUT_TOL,
              f"{name}: the run ledger's buckets do not sum to its elapsed time: {ledger}")
        buckets = {b: ledger[f"{b}_s"] for b in goodput_lib.ALL_BUCKETS}
        _p12_say("goodput", f"(a) {name}: {len(windows)} window(s) in {len(finals)} "
                            f"segment(s), each summing to its wall clock (worst {worst:.2g} s); "
                            f"run ledger {json.dumps(buckets)}, elapsed {ledger['elapsed_s']} s, "
                            f"goodput_frac {ledger['goodput_frac']}")
    recs = _history(GOODPUT_RUNS["supervised"]["log"])
    ledger = goodput_lib.run_ledger(recs)
    check(ledger["n_segments"] == 2 and ledger["restart_gap_s"] > 0
          and ledger["preempt_s"] >= ledger["restart_gap_s"]
          and ledger["preempt_for_serve_s"] == ledger["recovery_s"] == 0.0,
          f"the relaunch gap is not charged to preempt_s: {ledger}")
    # the ledger's gap runs from the first segment's last record to the
    # relaunched Trainer's construction; phase 11's from round 0's exit to
    # the relaunched child's first step
    ids = [r["run_id"] for r in recs]
    second_id = ids[-1]
    first_last = max(r["ts"] for r in recs if r["run_id"] != second_id)
    opening = next(r for r in recs if r["run_id"] == second_id)
    construct = opening["ts"] - opening["rel_s"]
    first, second = GOODPUT_RUNS["kids"]
    sup_gap = second["loss_at"][0] - first["exit"]
    to_first_step = second["loss_at"][0] - construct
    exit_tail = first["exit"] - first_last
    same_span = sup_gap - to_first_step + exit_tail
    _p12_say("goodput", f"(a) the supervised run's relaunch gap in its ledger (preempt_s "
                        f"{ledger['preempt_s']} s, of which the gap {ledger['restart_gap_s']} s "
                        f"and the dying round's shutdown tail the rest) vs [elastic-sup]'s "
                        f"{sup_gap:.3f} s: they differ by {sup_gap - ledger['restart_gap_s']:.3f} "
                        f"s, because the ledger's gap ends at the relaunched Trainer's "
                        f"construction, and its {to_first_step:.3f} s to the first step (the "
                        "process group, model, data, restore and first step) are the second "
                        "segment's own buckets, while it begins at round 0's last record, "
                        f"{exit_tail:.3f} s before that process exited; on the same span the "
                        f"two read {same_span:.3f} and {ledger['restart_gap_s']} s")
    check(abs(same_span - ledger["restart_gap_s"]) < GOODPUT_GAP_TOL_S,
          f"the ledger's gap {ledger['restart_gap_s']} s vs {same_span:.3f} s on the same span")
    GOODPUT_RUNS["hub_thread"].join(timeout=60)
    check("hub" in GOODPUT_RUNS, "the hub's pass never saw the relaunched child's goodput")
    snap, page = GOODPUT_RUNS["hub"]
    sample = snap["runs"]["trainer"]
    frac_line = [ln for ln in page.splitlines()
                 if ln.startswith('tpu_dist_goodput_goodput_frac{run="trainer"}')]
    check(page.endswith("# EOF\n") and frac_line and 'tpu_dist_hub_run_up{run="trainer"}' in page
          and snap["rollup"]["runs_aggregated"] == 1,
          f"the hub's page lacks the trainer's labels or goodput:\n{page[-2000:]}")
    _p12_say("goodput", f"(a) TelemetryHub pass over the relaunched child's textfile and "
                        f"heartbeat (alive {sample['alive']}, beat age "
                        f"{sample['heartbeat_age_s']} s): {len(page.splitlines())} lines, "
                        f"{frac_line[0]}, pod goodput by kind "
                        f"{snap['rollup']['goodput_by_kind']}")


def _tenancy_drill(root, d: str, args: list) -> list:
    cmd = [sys.executable, "-m", "tpu_dist_torch.fleet.tenancy_drill", "--workdir", d, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=TENANCY_TIMEOUT)
    lines = [ln.removeprefix("tenancy-drill: ") for ln in proc.stdout.splitlines()
             if ln.startswith("tenancy-drill: ")]
    _p12_say("tenancy", f"{' '.join(args)}: exit {proc.returncode} in "
                        f"{time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0 and lines and lines[-1] == "PASS: all requested phases",
          f"the tenancy drill failed (exit {proc.returncode}):\n{proc.stdout[-4000:]}\n"
          f"{proc.stderr[-3000:]}")
    return lines


def _tenancy_day(root, d: str) -> int:
    """(b): the policy replay and the day against a real trainer whose
    shrunken round runs on the card. Returns that round's fused SGD
    launches."""
    lines = _tenancy_drill(root, d, TENANCY_ARGS)
    for ln in lines:
        if (ln.startswith(("PASS", "preemption latency", "resume record", "causal chain",
                           "goodput:", "launches:", "epoch ", "chip-seconds", "tick "))
                or "round" in ln):
            _p12_say("tenancy", ln, keep=not (ln.startswith("tick ") or "round" in ln
                                               and not ln.startswith("launches")))
    shrink = json.loads(next(ln for ln in lines if ln.startswith("resume record (shrink)"))
                        .split(": ", 1)[1])
    card = [re.match(r"launches: round (\d+): 1 rank\(s\) on cuda: fused_sgd (\d+), "
                     r"flash_attention_fwd (\d+)", ln) for ln in lines]
    card = [m for m in card if m]
    check(len(card) == 1, f"the card's round's launches: {card}")
    steps = TENANCY_STEPS - shrink["examples_offset"] // TENANCY_BATCH
    launches = int(card[0].group(2))
    check(launches == steps > 0 and shrink["decision_cause"] == "serve_breach",
          f"the shrunken round on the card: {launches} fused SGD launches in {steps} steps; "
          f"{shrink}")
    _p12_say("tenancy", f"(b) the shrunken round on the card: {steps} steps of epoch "
                        f"{shrink['epoch']}, {launches} fused SGD launches on ZeRO-1's flat "
                        "shard, one a step")
    return launches


def phase_tenancy(work: str) -> dict:
    """Phase 12 (module docstring). Returns the kernel launches of its
    children: the fused SGD's on the card in (b)."""
    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    d = os.path.join(work, "tenancy")
    os.makedirs(d)
    _goodput_on_card()
    sgd = _tenancy_day(root, os.path.join(d, "day"))
    _p12_say("tenancy", f"phase: {time.perf_counter() - t0:.1f} s, fused_sgd launches {sgd}; "
                        f"card: {_smi_line()}")
    return {name: sgd if name == "fused_sgd" else 0 for name in KERNELS}


# -- phase 13: the training-health chain and the triggered profiler --------------

# phase 11 (a)'s command with the health flags: the four device scalars
# every step (each step logged), the anomaly detector warning, the
# straggler check at a world of one (its skew, 1.0, is over 0.5, so its
# record is written) and a manual capture of global steps [5, 8)
HEALTH_FLAGS = ["--device_metrics", "--log_every", "1", "--anomaly_action", "warn",
                "--straggler_threshold", "0.5", "--profile_steps", "5:8"]
HEALTH_WINDOW = (5, 8)
HEALTH_DEVICE_STATS = ("grad_norm", "param_norm", "update_ratio")
# the capture's category seconds against its busy seconds: each of the 5
# categories is rounded to 1e-6 s and busy is their sum, so they agree to
# float addition (1e-6 is the bound asked of them)
HEALTH_CATEGORY_TOL = 1e-6
# the same categories against the device's busy time read from the raw
# trace apart from xprof (the union of each stream's kernel, memcpy and
# memset intervals, which xprof's exclusive times sum to): the 5
# roundings of 1e-6 s; a range counted as an op (a gpu_user_annotation
# over a step) would add the step's idle gaps, milliseconds, and kernels
# that overlap on a stream (cuDNN's do) counted twice or
# clipped would show too
HEALTH_UNION_TOL = 1e-5
# xprof's top ops by self time: the step's distinct kernels are ~100, so
# 200 holds the fused SGD kernel's row whatever its rank
HEALTH_TOP = 200
# (c): 8 steps, poisoned two ways: the nan_loss fault, which reports a NaN
# loss after step 4 (before any fetch of it, as the JAX trainer does), and
# --lr inf, whose first update writes inf and NaN into the weights
HEALTH_POISON = ["--device_metrics", "--log_every", "1", "--steps_per_epoch", "8"]
HEALTH_FAULT = "nan_loss@epoch=0:step=4"
HEALTH_GUARD = "; restore from ckpt_dir to recover"
# compute_device_stats on the card against f64 arithmetic on the host: f32
# sums of squares over 10^3-10^4 elements in another order, a few ulps
HEALTH_STATS_RTOL = 1e-5

#: phase 13's result lines, repeated by the report
HEALTH_SUMMARY: list = []


def _p13_say(msg: str, keep: bool = True) -> None:
    print(f"[health] {msg}", flush=True)
    if keep:
        HEALTH_SUMMARY.append(f"[health] {msg}")


def _device_stats_on_card() -> None:
    """``compute_device_stats`` on CUDA tensors: the norms against f64
    arithmetic on the host, and a NaN leaf and an inf leaf counted as two
    non-finite leaves (the inf-norm's NaN propagation on the card)."""
    from tpu_dist_torch.obs.device_stats import compute_device_stats, snapshot  # noqa: PLC0415

    rng = np.random.default_rng(0)
    shapes = ((3, 4), (1000,), (64, 9), (5, 5, 3, 3))
    g, p = ([rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2))
    n = [(x - 0.01 * y).astype(np.float32) for x, y in zip(p, g)]
    cuda = lambda xs: [torch.from_numpy(x).to(DEVICE) for x in xs]  # noqa: E731
    got = {k: v.item() for k, v in compute_device_stats(cuda(g), snapshot(cuda(p)),
                                                         cuda(n)).items()}
    sq = lambda xs: sum(float(np.sum(np.square(x.astype(np.float64)))) for x in xs)  # noqa: E731
    want = {"grad_norm": math.sqrt(sq(g)), "param_norm": math.sqrt(sq(p)),
            "update_ratio": math.sqrt(sq([b.astype(np.float64) - a for a, b in zip(p, n)]))
            / math.sqrt(sq(p))}
    worst = max(abs(got[k] - want[k]) / want[k] for k in want)
    g[1][17], g[2][3, 4] = np.nan, -np.inf
    bad = compute_device_stats(cuda(g), snapshot(cuda(p)), cuda(n))["nonfinite_grads"].item()
    _p13_say(f"compute_device_stats on the card: norms vs f64 within {worst:.2g} relative, "
             f"{bad:g} non-finite leaves of 2 poisoned")
    check(worst <= HEALTH_STATS_RTOL and got["nonfinite_grads"] == 0.0 and bad == 2.0,
          f"device stats on the card: {got} vs {want}; poisoned count {bad}")
    # what the flag adds to a step at ResNet-18's 62 leaves: the copy of
    # the parameters before the update and the scalars after it
    leaves = [torch.randn(s, device=DEVICE) for s in fused_sgd_bench.leaf_shapes("resnet18")]
    grads = [torch.randn_like(x) for x in leaves]

    def flag_work():
        return compute_device_stats(grads, snapshot(leaves), leaves)

    ms, host = cuda_ms(flag_work, iters=10)
    _p13_say(f"the flag's work a step at ResNet-18's {len(leaves)} leaves "
             f"({sum(x.numel() for x in leaves)} f32): device {ms:.4f} ms, host {host:.1f} us")


def _stream_busy_s(prof: str) -> tuple:
    """(busy seconds, summed durations) of the device in a capture, read
    from its trace files with the standard library alone: each stream's
    kernel, memcpy and memset intervals merged, summed over the streams;
    and their durations summed, whose excess over busy is the time
    kernels on one stream overlapped."""
    busy_us = total_us = 0.0
    for path in (os.path.join(r, f) for r, _, fs in os.walk(prof) for f in fs
                 if f.endswith(".trace.json.gz")):
        with gzip.open(path, "rt") as f:
            events = json.load(f)["traceEvents"]
        streams: dict = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                streams.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for ivs in streams.values():
            end = float("-inf")
            for a, b in sorted(ivs):
                busy_us += max(b - max(a, end), 0.0)
                total_us += b - a
                end = max(end, b)
    return busy_us * 1e-6, total_us * 1e-6


def _comm(records: list) -> dict:
    [last] = [r for r in records if r.get("kind") == "train_epoch"][-1:]
    return {k: v for k, v in last.get("counters", {}).items() if k.startswith("comm.")}


def _laps(kid: dict) -> list:
    """Each step's seconds, from its loss line to the next (step i's lap
    ends at its own loss line)."""
    at = kid["loss_at"]
    return [None] + [b - a for a, b in zip(at, at[1:])]


def _health_run(root, d: str) -> tuple:
    """(a): phase 11 (a)'s golden command with HEALTH_FLAGS. Returns the
    child, its history's path and the capture directory."""
    prof, log = os.path.join(d, "prof"), os.path.join(d, "health.jsonl")
    rc, out, err, took = _sup_launch(root, d, [], [*HEALTH_FLAGS, "--profile_dir", prof,
                                                   "--log_file", log])
    kids = _children(out)
    check(rc == 0 and len(kids) == 1, f"health run: rc {rc}\n{out[-2000:]}\n{err[-3000:]}")
    [kid] = kids
    golden = GOODPUT_RUNS["golden_kid"]
    recs, golden_recs = _history(log), _history(GOODPUT_RUNS["golden"]["log"])
    _p13_say(f"(a) {' '.join(HEALTH_FLAGS)} --profile_dir D over phase 11 (a)'s command: rc "
             f"{rc} in {took:.1f} s; losses equal to the golden run's bit for bit "
             f"{kid['losses'] == golden['losses']}; fused_sgd launches {kid['launches']}; "
             f"comm counts {_comm(recs)} (golden {_comm(golden_recs)})")
    check(kid["losses"] == golden["losses"],
          f"health losses {kid['losses']} vs golden {golden['losses']}")
    check(kid["launches"] == SUP_STEPS and _comm(recs) == _comm(golden_recs),
          f"launches {kid['launches']}, comm {_comm(recs)} vs {_comm(golden_recs)}")
    stats = [r for r in recs if r["kind"] == "device_stats"]
    check(len(stats) == SUP_STEPS and [r["step"] for r in stats] == list(range(SUP_STEPS))
          and all(math.isfinite(r[k]) and r[k] > 0 for r in stats for k in HEALTH_DEVICE_STATS)
          and all(r["nonfinite_grads"] == 0.0 for r in stats),
          f"device_stats records: {stats}")
    straggler = [r for r in recs if r["kind"] == "straggler"]
    check(len(straggler) == 1 and straggler[0]["skew"] == 1.0
          and straggler[0]["worst_rank"] == 0, f"straggler records: {straggler}")
    profs = [(r["event"], r.get("step", r.get("stop_step"))) for r in recs
             if r["kind"] == "profile"]
    check(profs == [("start", HEALTH_WINDOW[0]), ("stop", HEALTH_WINDOW[1])],
          f"profile records: {profs}")
    [pa] = [r for r in recs if r["kind"] == "profile_analysis"]
    cat_gap = abs(sum(pa["categories"].values()) - pa["device_busy_s"])
    stream_busy, summed = _stream_busy_s(prof)
    union_gap = abs(sum(pa["categories"].values()) - stream_busy)
    check(pa.get("error") is None and pa["device_busy_s"] > 0
          and cat_gap <= HEALTH_CATEGORY_TOL and union_gap <= HEALTH_UNION_TOL,
          f"profile_analysis: {pa}; the trace's merged stream busy {stream_busy:.6f} s")
    final = recs[-1].get("counters", {})
    check(not final.get("profile.errors") and not final.get("xprof.analyze_errors")
          and final.get("xprof.analyses") == 1, f"the run's profiler counters: {final}")
    anomalies = [r for r in recs if r["kind"] == "anomaly"]
    first, last = stats[0], stats[-1]
    _p13_say(f"(a) {len(stats)} device_stats records: grad_norm {first['grad_norm']:.4g} -> "
             f"{last['grad_norm']:.4g}, param_norm {first['param_norm']:.6g} -> "
             f"{last['param_norm']:.6g}, update_ratio {first['update_ratio']:.3g} -> "
             f"{last['update_ratio']:.3g}, nonfinite_grads 0; {len(anomalies)} anomaly "
             f"finding(s); straggler record skew {straggler[0]['skew']} worst_rank "
             f"{straggler[0]['worst_rank']}; profile start/stop at global steps {profs}")
    epoch = lambda rs: [r for r in rs if r["kind"] == "train_epoch"][-1]  # noqa: E731
    laps = _laps(kid)
    inside = [laps[i] for i in range(*HEALTH_WINDOW)]
    outside = [laps[i] for i in range(1, SUP_STEPS)
               if not HEALTH_WINDOW[0] <= i <= HEALTH_WINDOW[1]]
    golden_laps = [x for x in _laps(golden)[1:]]
    p50_out = statistics.median(outside)
    _p13_say("(a) laps (ms) before the capture "
             + ", ".join(f"{x * 1e3:.1f}" for x in laps[1:HEALTH_WINDOW[0]]) + "; after it "
             + ", ".join(f"{x * 1e3:.1f}" for x in laps[HEALTH_WINDOW[1] + 1:])
             + "; golden " + ", ".join(f"{x * 1e3:.1f}" for x in golden_laps), keep=False)
    _p13_say(f"(a) step p50 (the trainer's host laps, its first step out): with "
             f"--device_metrics {epoch(recs)['step_time_p50'] * 1e3:.3f} ms, phase 11 (a)'s "
             f"golden run without {epoch(golden_recs)['step_time_p50'] * 1e3:.3f} ms; from the "
             f"children's loss lines (a sync a step in both): with {p50_out * 1e3:.3f} ms "
             f"outside the capture window, without {statistics.median(golden_laps) * 1e3:.3f} "
             f"ms; inside the window (steps {HEALTH_WINDOW[0]}-{HEALTH_WINDOW[1] - 1}) "
             f"{statistics.median(inside) * 1e3:.3f} ms (laps "
             f"{', '.join(f'{x * 1e3:.3f}' for x in inside)}); step "
             f"{HEALTH_WINDOW[1]}'s lap {laps[HEALTH_WINDOW[1]] * 1e3:.1f} ms holds the "
             f"capture's stop, export and read-back")
    if kid["peak"] is not None and golden["peak"] is not None:
        _p13_say(f"(a) peak memory allocated on the card: with --device_metrics {kid['peak']} "
                 f"bytes, golden {golden['peak']} bytes: {kid['peak'] - golden['peak']:+d} "
                 f"(the flag's two flat buffers after the backward, the copy before the update "
                 f"and the parameters after it: {RESNET_PARAMS * 4} bytes each)")
    cats = pa["categories"]
    _p13_say(f"(a) capture analysis in the child: device busy {pa['device_busy_s']:.6f} s over "
             f"{pa['steps']} steps, categories {json.dumps(cats)} (sum - busy {cat_gap:.1g} s; sum - the "
             f"trace's merged stream busy {stream_busy:.6f} s {union_gap:.2g} s; kernels "
             f"overlapping on one stream {(summed - stream_busy) * 1e6:.3f} us), "
             f"collective_frac {pa['collective_frac']}, overlap_frac {pa['overlap_frac']}, "
             f"infeed stall {pa['infeed_stall_s']} s")
    return kid, log, prof


_CONV_TOKENS = ("fprop", "dgrad", "wgrad", "implicit", "winograd", "conv")


def _health_readback(root, log: str, prof: str) -> None:
    """(b): ``obs xprof`` over the capture and ``obs summarize`` over the
    history, each in a fresh process."""
    [trace] = [os.path.join(r, f) for r, _, fs in os.walk(prof) for f in fs
               if f.endswith(".trace.json.gz")]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs", "xprof", prof,
                           "--format", "json", "--top", str(HEALTH_TOP)], cwd=root,
                          capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    check(proc.returncode == 0, f"obs xprof: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout)
    sgd = [o for o in rep["top_ops"] if "fused_sgd_kernel" in o["name"]]
    convs = [o for o in rep["top_ops"] if o["category"] == "matmul_conv"
             and any(t in o["name"].lower() for t in _CONV_TOKENS)]
    rank = next((i for i, o in enumerate(rep["top_ops"]) if "fused_sgd_kernel" in o["name"]),
                None)
    steps = HEALTH_WINDOW[1] - HEALTH_WINDOW[0]
    _p13_say(f"(b) obs xprof --top {HEALTH_TOP}: exit 0 in {took:.2f} s over a "
             f"{os.path.getsize(trace)}-byte capture ({rep['traces'][0]['n_op_events']} device "
             f"events on {rep['traces'][0]['op_threads']} stream(s)); fused_sgd_kernel x"
             f"{sgd[0]['count'] if sgd else 0} ({sgd[0]['self_s'] * 1e3 if sgd else 0:.3f} ms, "
             f"top op #{rank}); {len(convs)} cuDNN conv kernels in matmul_conv, the largest "
             f"{convs[0]['name'][:60] if convs else None} x{convs[0]['count'] if convs else 0}")
    check(len(sgd) == 1 and sgd[0]["count"] == steps and sgd[0]["category"] == "fusion_other",
          f"fused_sgd_kernel in the capture: {sgd} (expected {steps}, one a captured step)")
    check(convs, f"no cuDNN convolution kernel in matmul_conv: {rep['top_ops'][:20]}")
    busy = rep["device_busy_s"]
    _p13_say("(b) the capture's split: " + ", ".join(
        f"{c} {v:.6f} s ({v / busy:.1%})" for c, v in rep["categories"].items())
        + f"; busy {busy:.6f} s, {busy / steps * 1e3:.3f} ms a step")
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs", "summarize", log],
                          cwd=root, capture_output=True, text=True, timeout=120)
    block = proc.stdout[proc.stdout.find("capture attribution"):].splitlines()[:3]
    _p13_say(f"(b) obs summarize: exit {proc.returncode}; " + " | ".join(block))
    check(proc.returncode == 0 and "capture attribution" in proc.stdout
          and "straggler: epoch 0 process 0" in proc.stdout,
          f"obs summarize: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")


def _health_poisoned(root, d: str) -> int:
    """(c): the two poisoned runs, side by side on the card. Returns their
    fused SGD launches."""
    runs = {"nan_loss": ["--fault_plan", HEALTH_FAULT], "lr_inf": ["--lr", "inf"]}

    def one(name):
        log = os.path.join(d, f"{name}.jsonl")
        return name, log, _sup_launch(root, d, [], [*HEALTH_POISON, *runs[name],
                                                    "--log_file", log])

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        done = list(pool.map(one, runs))
    launches = 0
    for name, log, (rc, out, err, took) in done:
        [kid] = _children(out)
        recs = _history(log)
        stats = [r["step"] for r in recs if r["kind"] == "device_stats"]
        found = [(r["step"], r["anomaly"]) for r in recs if r["kind"] == "anomaly"]
        # the traceback's last line (torch prefixes a rank's stderr lines
        # with "[rank0]: " under a process group)
        cls = "tpu_dist_torch.train.trainer.TrainingDivergedError: "
        raised = [ln.split(cls, 1)[1] for ln in err.splitlines() if cls in ln]
        _p13_say(f"(c) {' '.join(runs[name])}: exit {rc} in {took:.1f} s after "
                 f"{len(kid['losses'])} step(s); device_stats at steps {stats}; anomaly "
                 f"findings {found}; raised {raised}")
        if name == "nan_loss":
            # the fault reports the NaN after step 4, before its fetch: no
            # finding (the JAX trainer's order)
            want_raise = ("non-finite loss nan at epoch 0 step 4 (lr=0.1) [fault-injected]"
                          + HEALTH_GUARD)
            ok = stats == [0, 1, 2, 3] and found == [] and len(kid["losses"]) == 5
        else:
            want_raise = "non-finite loss nan at epoch 0 step 1 (lr=inf)" + HEALTH_GUARD
            ok = (stats == [0, 1] and found == [(1, "nonfinite_loss"), (1, "nonfinite_grads")]
                  and len(kid["losses"]) == 2)
        check(rc == 1 and raised == [want_raise] and ok,
              f"{name}: rc {rc}, raised {raised}, stats {stats}, findings {found}\n"
              f"{err[-3000:]}")
        check(kid["launches"] == len(kid["losses"]),
              f"{name}: {kid['launches']} launches in {len(kid['losses'])} steps")
        launches += kid["launches"]
    return launches


def phase_health(work: str) -> dict:
    """Phase 13 (module docstring). Returns the fused SGD launches of its
    trainer children."""
    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    d = os.path.join(work, "health")
    os.makedirs(d)
    _device_stats_on_card()
    kid, log, prof = _health_run(root, d)
    _health_readback(root, log, prof)
    launches = kid["launches"] + _health_poisoned(root, d)
    _p13_say(f"phase: {time.perf_counter() - t0:.1f} s, fused_sgd launches {launches}; card: "
             f"{_smi_line()}")
    return {name: launches if name == "fused_sgd" else 0 for name in KERNELS}


# -- phase 14: the memory ledger, the cost model and the trace export ---------------

# the port's FLOPs of one ResNet-18 image (CIFAR stem, 100 classes), forward
# and backward, convolutions over their valid taps: FlopCounterMode's count
# on the CPU (tests/test_torch_costmodel.py), 0.6% under XLA's 2.905e9
MEM_FLOPS_PER_IMAGE = 2.888e9
MEM_FLOPS_RTOL = 0.01
MEM_BATCH = 256
# MFU predicted before the first run: 2.888e9 x 256 FLOPs a step over a
# 19.0-19.5 ms device step (PERF.md section 5) at 989.4 TFLOP/s; lower when
# the host's step is longer
MEM_MFU_PREDICTED = (0.03, 0.04)
# (c): the child's allocator is capped halfway between what is allocated at
# the first step's entry (the parameters, the momentum, the batch) and that
# step's peak in (a): the state fits, the first step's activations do not
MEM_OOM_AT = 0.5
# (d): ViT-B/16 one step at batch 8, bf16, flash against the plain chain
MEM_VIT_BATCH = 8
MEM_VIT_FLOPS_RTOL = 1e-3

#: phase 14's result lines, repeated by the report
MEMORY_SUMMARY: list = []


def _p14_say(msg: str, keep: bool = True) -> None:
    print(f"[memory] {msg}", flush=True)
    if keep:
        MEMORY_SUMMARY.append(f"[memory] {msg}")


def _obs(root, *args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "tpu_dist_torch.obs", *args], cwd=root,
                          capture_output=True, text=True, timeout=120)


def _memory_run(root, d: str) -> tuple:
    """(a): phase 11 (a)'s golden command with ``--memory_check warn
    --log_file H --trace_file T``. Returns the child and its ledger."""
    log, trace = os.path.join(d, "memory.jsonl"), os.path.join(d, "trace.json")
    rc, out, err, took = _sup_launch(root, d, [], ["--memory_check", "warn", "--log_file", log,
                                                   "--trace_file", trace])
    kids = _children(out)
    check(rc == 0 and len(kids) == 1, f"memory run: rc {rc}\n{out[-2000:]}\n{err[-3000:]}")
    [kid] = kids
    golden = GOODPUT_RUNS["golden_kid"]
    check(kid["losses"] == golden["losses"] and kid["launches"] == SUP_STEPS,
          f"memory run: losses {kid['losses']} vs golden {golden['losses']}, "
          f"{kid['launches']} launches")
    recs = _history(log)
    ledgers = [r for r in recs if r["kind"] == "memory" and r.get("event") != "oom"]
    check(len(ledgers) == 1, f"{len(ledgers)} memory records")
    [mem] = ledgers
    rc_, static, xla = mem["reconciliation"], mem["static"], mem.get("xla") or {}
    identity = rc_["attributed_bytes"] + rc_["unattributed_bytes"] == rc_["bytes_in_use"]
    [epoch] = [r for r in recs if r["kind"] == "train_epoch"]
    cnt = epoch["counters"]
    flops = cnt.get("device.flops_per_step")
    want = MEM_FLOPS_PER_IMAGE * MEM_BATCH
    total = torch.cuda.get_device_properties(0).total_memory
    name = torch.cuda.get_device_name(0)
    _p14_say(f"(a) --memory_check warn --log_file H --trace_file T over phase 11 (a)'s "
             f"command: rc {rc} in {took:.1f} s; losses equal to the golden run's bit for bit "
             f"{kid['losses'] == golden['losses']}; fused_sgd launches {kid['launches']}")
    _p14_say("(a) " + memory_lib.summary_line(mem))
    _p14_say("(a) static sections (per device): " + ", ".join(
        f"{k} {v['bytes_per_device']} B in {v['n_leaves']} leaves"
        for k, v in static["sections"].items()) + f"; total {static['bytes_per_device']} B")
    _p14_say(f"(a) reconciliation ({rc_['source']}): attributed {rc_['attributed_bytes']} + "
             f"unattributed {rc_['unattributed_bytes']} = {rc_['bytes_in_use']} bytes in use "
             f"({identity}); census {mem['census']['n_arrays']} storages; the first step's "
             f"waterfall: entry {xla.get('argument_bytes')}, temp {xla.get('temp_bytes')}, "
             f"left {xla.get('output_bytes')}, peak {xla.get('peak_bytes')} bytes "
             f"({xla.get('source')})")
    check(rc_["source"] == "allocator" and identity,
          f"reconciliation {rc_} (expected the allocator's, exact)")
    check(static["bytes_per_device"] >= RESNET_PARAMS * 4,
          f"static {static['bytes_per_device']} bytes < the parameters' {RESNET_PARAMS * 4}")
    check(xla.get("source") == "allocator" and xla["peak_bytes"] >= xla["argument_bytes"]
          and "generated_code_bytes" not in xla, f"the xla section {xla}")
    headroom = cnt.get("mem.headroom_frac")
    mfu = epoch.get("mfu")
    _p14_say(f"(a) MFU {mfu} (predicted {MEM_MFU_PREDICTED[0]}-{MEM_MFU_PREDICTED[1]}) from "
             f"{flops:.6g} FLOPs a step ({flops / MEM_BATCH:.6g} an image; expected "
             f"{want:.6g} within {MEM_FLOPS_RTOL:.0%}) over the step p50 "
             f"{epoch['step_time_p50'] * 1e3:.3f} ms; device.bytes_per_step "
             f"{cnt.get('device.bytes_per_step'):.6g}; mem.headroom_frac {headroom}; "
             f"mem.peak_bytes_in_use {cnt.get('mem.peak_bytes_in_use')}")
    check(isinstance(mfu, float) and math.isfinite(mfu) and 0 < mfu < 1, f"mfu {mfu}")
    check(isinstance(headroom, float) and 0 < headroom < 1, f"mem.headroom_frac {headroom}")
    check(flops is not None and abs(flops / want - 1) <= MEM_FLOPS_RTOL,
          f"device.flops_per_step {flops} vs {want}")
    _p14_say(f"(a) chip table: {name!r} peak {costmodel.CHIP_PEAK_FLOPS.get(name)} FLOP/s, "
             f"HBM row {costmodel.CHIP_HBM_BYTES.get(name)} bytes against total_memory "
             f"{total}")
    check(costmodel.CHIP_HBM_BYTES.get(name) == total,
          f"CHIP_HBM_BYTES[{name!r}] = {costmodel.CHIP_HBM_BYTES.get(name)}, the card has "
          f"{total}")
    first = cnt.get("compile.seconds")
    golden_recs = _history(GOODPUT_RUNS["golden"]["log"])
    golden_first = [r for r in golden_recs if r["kind"] == "train_epoch"][0]["counters"].get(
        "compile.seconds")
    _p14_say(f"(a) the first step (compile.seconds, the FLOP and byte count and the ledger "
             f"inside it): {first} s; the golden run's {golden_first} s; compile.events "
             f"{cnt.get('compile.events')}")
    with open(trace) as f:
        tr = json.load(f)
    names = {e["name"] for e in tr["traceEvents"]}
    spans_recs = [r for r in recs if r["kind"] == "spans"]
    _p14_say(f"(a) T: {len(tr['traceEvents'])} host spans, {sorted(names)}; {len(spans_recs)} "
             f"spans records in H")
    check({"train/dispatch", "train/compile+dispatch", "train/data_wait",
           "loader/produce"} <= names, f"trace event names {sorted(names)}")
    out_trace = os.path.join(d, "export.json")
    for cmd, args in (("memory", [log]), ("export-trace", [log, "-o", out_trace])):
        t0 = time.perf_counter()
        proc = _obs(root, cmd, *args)
        _p14_say(f"(a) obs {cmd}: exit {proc.returncode} in {time.perf_counter() - t0:.2f} s; "
                 + " | ".join(proc.stdout.strip().splitlines()[:2]))
        check(proc.returncode == 0, f"obs {cmd}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    return kid, mem


def _memory_refuse(static: int) -> None:
    """(b): ``Trainer`` over (a)'s command with ``--memory_check refuse
    --hbm_budget_bytes <static - 1>``, built in this process (no child):
    its pre-flight at construction raises ``InfeasibleMemoryError``, with
    the JAX package's message, before any step, so no kernel launches."""
    cfg = train_cli.parse([*SUP_TRAIN, "--device", DEVICE, "--memory_check", "refuse",
                           "--hbm_budget_bytes", str(static - 1)])
    reset_launches()
    try:
        trainer_lib.Trainer(cfg).close()
        raised = None
    except memory_lib.InfeasibleMemoryError as e:
        raised = str(e)
    launches = read_launches()
    _p14_say(f"(b) Trainer(--memory_check refuse --hbm_budget_bytes {static - 1}) in this "
             f"process: {raised[:160] if raised else None}; launches {launches}")
    check(raised is not None and raised.startswith("static HBM requirement"),
          f"refuse: {raised}")
    check(not any(launches.values()), f"refuse: launches {launches} before the refusal")


def _memory_oom(root, d: str, xla: dict) -> None:
    """(c): the command in a child whose allocator is capped between the
    first step's entry and its peak: it dies of ``torch.OutOfMemoryError``
    in that step, leaving ``oom.json`` with a ledger snapshot, and ``obs
    postmortem`` gives the ``oom`` verdict."""
    total = torch.cuda.get_device_properties(0).total_memory
    cap = xla["argument_bytes"] + MEM_OOM_AT * (xla["peak_bytes"] - xla["argument_bytes"])
    frac = cap / total
    child = ("import torch\n"
             f"torch.cuda.set_per_process_memory_fraction({frac!r})\n" + SUP_CHILD)
    crash = os.path.join(d, "oom_crash")
    rc, out, err, took = _sup_launch(root, d, [], ["--crash_dir", crash], child=child)
    [kid] = _children(out)
    died = any("torch.OutOfMemoryError" in ln or "CUDA out of memory" in ln
               for ln in err.splitlines())
    rep = memory_lib.read_oom_report(os.path.join(crash, memory_lib.OOM_NAME))
    snap = (rep or {}).get("ledger") or {}
    oom = (rep or {}).get("oom") or {}
    _p14_say(f"(c) the allocator capped at {cap:.0f} bytes (fraction {frac:.6f}): exit {rc} in "
             f"{took:.1f} s after {len(kid['losses'])} steps; OutOfMemoryError {died}; "
             f"oom.json requested {oom.get('requested_bytes')} bytes, used "
             f"{oom.get('used_bytes')} of {oom.get('limit_bytes')}; the snapshot's sections "
             f"{sorted(snap)} (static {((snap.get('static') or {}).get('bytes_per_device'))} "
             f"bytes a device)")
    check(rc != 0 and died and not kid["losses"], f"oom run: rc {rc}\n{err[-3000:]}")
    check(isinstance(oom.get("requested_bytes"), int) and oom["requested_bytes"] > 0
          and (snap.get("static") or {}).get("bytes_per_device"),
          f"oom.json: {json.dumps(rep)[:2000]}")
    pm = _postmortem(root, crash, d)
    _p14_say(f"(c) obs postmortem: verdict {pm.get('verdict')!r}")
    check(pm.get("verdict") == "oom", f"postmortem verdict {pm.get('verdict')}: {pm}")


def _memory_vit_flops() -> dict:
    """(d): one ViT-B/16 step at MEM_VIT_BATCH through ``make_train_step``
    with the flash kernels and one with the plain attention chain, each
    counted by ``step_cost``: their FLOPs agree. Then the count's own cost:
    ResNet-18 steps at batch 256, plain and counted, in turns. Returns the
    kernels' launches."""
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.standard_normal((MEM_VIT_BATCH,) + IMAGE,
                                                  dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, MEM_VIT_BATCH)).to(DEVICE)
    costs = {}
    reset_launches()
    for impl in ("flash", "xla"):
        model = _bridged_vit_b16(impl)
        opt = _sgd_for(impl)
        st = state_lib.TrainState.create(model, opt)
        train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16)
        (st, m), costs[impl] = costmodel.step_cost(train_step, st, images, labels, TRAIN_LR)
        check(math.isfinite(m["loss"].item()), f"ViT-B/16 {impl} loss {m['loss']}")
        del model, st
    launches = read_launches()
    gap = costs["flash"]["flops_per_step"] / costs["xla"]["flops_per_step"] - 1
    _p14_say(f"(d) ViT-B/16, batch {MEM_VIT_BATCH}, bf16: step_cost FLOPs flash "
             f"{costs['flash']['flops_per_step']:.6g} vs plain {costs['xla']['flops_per_step']:.6g}"
             f" ({gap:+.2e}); bytes flash {costs['flash']['bytes_per_step']:.6g} vs plain "
             f"{costs['xla']['bytes_per_step']:.6g}; launches {launches}")
    check(abs(gap) <= MEM_VIT_FLOPS_RTOL, f"ViT FLOPs flash {costs['flash']} vs {costs['xla']}")
    check(all(launches[k] == 12 for k in PER_STEP if k != "fused_sgd")
          and launches["fused_sgd"] == 1, f"launches of the flash step {launches}")
    # the count's cost: ResNet-18 steps, plain and counted in turns, each
    # ended by a sync (the dispatch modes see every op on the host)
    model = resnet_lib.resnet18(num_classes=100, device=DEVICE, seed=0)
    opt = optim.SGD(momentum=0.9, weight_decay=5e-4, fused=True)
    st = state_lib.TrainState.create(model, opt)
    train_step = step_lib.make_train_step(opt, sync_bn=False, compute_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((MEM_BATCH, 32, 32, 3),
                                             dtype=np.float32)).to(DEVICE)
    y = torch.from_numpy(rng.integers(0, 100, MEM_BATCH)).to(DEVICE)
    laps = {"plain": [], "counted": []}
    reset_launches()
    for i in range(8):
        for kind in ("plain", "counted") if i % 2 else ("counted", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "plain":
                st, _ = train_step(st, x, y, TRAIN_LR)
            else:
                (st, _), cost = costmodel.step_cost(train_step, st, x, y, TRAIN_LR)
            torch.cuda.synchronize()
            if i >= 2:
                laps[kind].append(time.perf_counter() - t0)
    steps = read_launches()["fused_sgd"]
    plain, counted = statistics.median(laps["plain"]), statistics.median(laps["counted"])
    _p14_say(f"(d) the count's cost on a ResNet-18 step (batch {MEM_BATCH}, bf16, fused SGD, "
             f"6 pairs after 2, each ended by a sync): plain {plain * 1e3:.3f} ms, counted "
             f"{counted * 1e3:.3f} ms (+{(counted - plain) * 1e3:.3f} ms); its count "
             f"{cost['flops_per_step']:.6g} FLOPs ({cost['flops_per_step'] / MEM_BATCH:.6g} an "
             f"image), {cost['bytes_per_step']:.6g} bytes")
    check(steps == 16, f"{steps} fused_sgd launches in 16 ResNet-18 steps")
    return {k: launches[k] + (steps if k == "fused_sgd" else 0) for k in KERNELS}


def phase_memory(work: str) -> dict:
    """Phase 14 (module docstring). Returns the kernels' launches of its
    trainer children and of (d)."""
    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    d = os.path.join(work, "memory")
    os.makedirs(d)
    kid, mem = _memory_run(root, d)
    _memory_refuse(mem["static"]["bytes_per_device"])
    _memory_oom(root, d, mem["xla"])
    launches = _memory_vit_flops()
    launches["fused_sgd"] += kid["launches"]
    _p14_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: "
             f"{_smi_line()}")
    return launches


# -- phase 15 ----------------------------------------------------------------

SEQ_RING = 4                 # the lockstep ring's virtual ranks
SEQ_IMAGE_SIZE = 1024        # vit_b16_1024px_flash (bench.py): 64 x 64 patches
SEQ_BATCH = 8                # its global batch
SEQ_SHAPE = (SEQ_BATCH * 12, (SEQ_IMAGE_SIZE // 16) ** 2, 64)  # [BH, S, D] = [96, 4096, 64]
SEQ_STEPS = 3
SEQ_LR = 0.1
# (b) after the checked steps: steps at lr 0 (the weights hold, the work is
# the same) timed by host laps, each ended by a sync
SEQ_TIMED = 8
# the capture's ops by self time: one step's distinct kernels are well under
# this, so every flash kernel is in the list (checked by their count)
SEQ_TOP = 1000
# the flash kernels' functions (csrc/flash_attention_*.cu), by xprof.kernel_base
SEQ_FLASH_FUNCTIONS = ("flash_fwd_kernel", "flash_fwd_mma_kernel", "dkdv_kernel",
                       "dkdv_mma_kernel", "dq_kernel", "dq_mma_kernel")
SEQ_CAPTURE_TIMEOUT_S = 300
# (b)'s captures, in a fresh process: once a few CUDA processes have come
# and gone on the card, this process's profiler sessions drop kernels at
# random (phase 8's docstring; a capture here once held 34 of a step's 36
# flash launches). For each variant: one step at lr 0 (the first call's
# one-off work), then one under torch.profiler, read by obs/xprof.py; prints
# one JSON line of each capture's device busy, flash kernels' time and count,
# distinct ops, and the captured step's launches by the wrappers' counts.
# The library is phase 1's: the child loads it, never builds.
SEQ_CAPTURE_CHILD = """
import json, os, sys
import numpy as np
import torch
from tpu_dist_torch.comm import mesh
from tpu_dist_torch.nn.vit import vit_b16
from tpu_dist_torch.obs import profile, xprof
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.train import optim, state, step

work, port, size, batch, top = sys.argv[1], *map(int, sys.argv[2:6])
functions = sys.argv[6].split(",")
wrappers = {"flash_attention_fwd": fa.flash_fwd, "flash_attention_bwd_dkdv": fa.flash_bwd_dkdv,
            "flash_attention_bwd_dq": fa.flash_bwd_dq}
mesh.initialize_distributed("cuda", world_size=1, rank=0, master_addr="127.0.0.1",
                            master_port=port)
rng = np.random.default_rng(15)
images = torch.from_numpy(rng.standard_normal((batch, size, size, 3), dtype=np.float32)).cuda()
labels = torch.from_numpy(rng.integers(0, 1000, batch)).cuda()
seq = mesh.seq_axis(1)
out = {}
for mode in ("none", "ring", "ulysses"):
    model = vit_b16(num_classes=1000, image_size=size, attn_impl="flash", device="cuda", seed=0)
    opt = optim.SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    st = state.TrainState.create(model, opt)
    kw = {} if mode == "none" else dict(seq_axis=seq, sp_mode=mode)
    train_step = step.make_train_step(opt, compute_dtype=torch.bfloat16, **kw)
    st, m = train_step(st, images, labels, 0.0)
    m["loss"].item()
    before = {k: w.launches for k, w in wrappers.items()}
    capture = os.path.join(work, mode)
    with profile.trace(capture, device="cuda"):
        st, m = train_step(st, images, labels, 0.0)
        m["loss"].item()
    rep = xprof.analyze_capture(capture, top_k=top)
    flash = [o for o in rep["top_ops"] if xprof.kernel_base(o["name"]) in functions]
    out[mode] = {"busy_ms": rep["device_busy_s"] * 1e3,
                 "flash_ms": sum(o["self_s"] for o in flash) * 1e3,
                 "flash_count": sum(o["count"] for o in flash), "n_ops": len(rep["top_ops"]),
                 "launches": {k: w.launches - before[k] for k, w in wrappers.items()}}
    del model, st, opt, train_step
    torch.cuda.empty_cache()
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""
# the rotations a lockstep pass computes, of each kernel (non-causal: all
# n * n; causal: rank p its p + 1, the rest masked and launching nothing)
SEQ_LAUNCHES = {False: SEQ_RING * SEQ_RING, True: SEQ_RING * (SEQ_RING + 1) // 2}
# (a) max |got - want| over max |want|, a tensor at a time. f32: the
# kernels' f32-accurate routes against the plain versions' f32 products
# (TF32 off), summed in another order over 4 merged partials of 1,024 keys
# each: a few ulps of the largest value. bf16: P and dS enter the kernels'
# products rounded against each 64-key tile's running max, in the plain
# versions against the block's final max, and q, k, v, out and the
# gradients are bf16 (2^-8 relative a value): a few bf16 steps of the
# largest value. The same bounds hold against flash_attention on the
# gathered sequence, which rounds P over the whole row at once.
SEQ_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (b) with a seq group of one the ring's merge multiplies the f32 partial
# by l and divides by it again, and its gradients come back through f32
# before their bf16 cast, where the plain step rounds once: bf16 rounding
# placement, the limit of the bf16 parity of phase 5 (PARITY_BF16_LOSS_RTOL)
# for each of the 3 losses. Ulysses over one rank is the plain step.
SEQ_STEP_LOSS_RTOL = 2e-3

#: phase 15's result lines, repeated by the report
SEQ_SUMMARY: list = []


def _p15_say(msg: str, keep: bool = True) -> None:
    print(f"[seq] {msg}", flush=True)
    if keep:
        SEQ_SUMMARY.append(f"[seq] {msg}")


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (f32)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _seq_composition(dt, causal: bool, gen) -> tuple:
    """(a) one dtype and mask: the lockstep ring over the kernels, counted;
    then against its plain version and against the flash kernels on the
    gathered sequence (neither counted). Returns (launches of each kernel,
    the largest error, the pass's device ms)."""
    bh, s, d = SEQ_SHAPE
    whole = [torch.randn(SEQ_SHAPE, device=DEVICE, generator=gen).to(dt) for _ in range(4)]
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(SEQ_RING, dim=1)] for t in whole)
    reset_launches()
    got = fa.ring_flash_lockstep(qs, ks, vs, dos, causal)
    torch.cuda.synchronize()
    launches, mma = read_launches(), read_mma_launches()
    want = SEQ_LAUNCHES[causal]
    tag = f"{str(dt).removeprefix('torch.')} {'causal' if causal else 'full'}"
    check(all(launches[k] == want for k in MMA_KERNELS) and launches["fused_sgd"] == 0,
          f"(a) {tag}: launches {launches}, want {want} of each flash kernel")
    check(all(mma[k] == (want if dt == torch.bfloat16 else 0) for k in MMA_KERNELS),
          f"(a) {tag}: tensor-core launches {mma}")
    plain = fa.ring_flash_lockstep(qs, ks, vs, dos, causal, fa.PLAIN_OPS)
    out, m, l = fa.flash_fwd(*whole[:3], causal)
    dq, dk, dv = fa.flash_bwd(*whole[:3], out, m, l, whole[3], causal)
    gathered = {"out": out, "dq": dq, "dk": dk, "dv": dv}
    errs = {}
    for key in ("out", "dq", "dk", "dv"):
        ring = torch.cat(got[key], dim=1)
        errs[f"{key} vs plain"] = _rel_err(ring, torch.cat(plain[key], dim=1))
        errs[f"{key} vs gathered"] = _rel_err(ring, gathered[key])
    worst = max(errs.values())
    pass_ms, _ = cuda_ms(lambda: fa.ring_flash_lockstep(qs, ks, vs, dos, causal), iters=3,
                         warmup=1, head_start=False)
    _p15_say(f"(a) lockstep ring of {SEQ_RING} over [BH, S, D] = {list(SEQ_SHAPE)} {tag}: "
             f"{want} launches of each of #1-#3 (mma {mma['flash_attention_fwd']}); a pass "
             f"(forward + backward of the {SEQ_RING} ranks) every {pass_ms:.3f} ms back to back; "
             f"max error / max "
             + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(worst <= SEQ_TOL[dt], f"(a) {tag}: errors {errs} over {SEQ_TOL[dt]}")
    del got, plain, gathered, whole
    return launches, mma, worst, pass_ms


def _seq_steps(seq, sp_mode, images, labels, init) -> dict:
    """(b) SEQ_STEPS bf16 steps of ViT-B/16 at 1,024 px from ``init``, with
    the seq axis ``seq`` of one rank (``sp_mode``) or without (None); then
    SEQ_TIMED steps at lr 0, each a host lap ended by a sync. Returns the
    losses, the laps (ms), the peak bytes, the launches and the tensor-core
    launches."""
    model = vit_b16(num_classes=1000, image_size=SEQ_IMAGE_SIZE, attn_impl="flash",
                    device=DEVICE)
    model.load_state_dict(init)
    opt = _sgd_for("flash")
    st = state_lib.TrainState.create(model, opt)
    kw = dict(seq_axis=seq, sp_mode=sp_mode) if sp_mode else {}
    train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, laps = [], []
    for i in range(SEQ_STEPS):
        st, metrics = train_step(st, images[i], labels[i], SEQ_LR)
        losses.append(metrics["loss"].item())
    for i in range(SEQ_TIMED):
        t0 = time.perf_counter()
        st, metrics = train_step(st, images[i % SEQ_STEPS], labels[i % SEQ_STEPS], 0.0)
        metrics["loss"].item()  # ends in a sync
        laps.append((time.perf_counter() - t0) * 1e3)
    launches, mma = read_launches(), read_mma_launches()
    peak = torch.cuda.max_memory_allocated()
    del model, st, opt, train_step
    return {"losses": losses, "laps": laps, "peak": peak, "launches": launches, "mma": mma}


def _seq_captures(work: str) -> dict:
    """(b)'s captures in a fresh process (:data:`SEQ_CAPTURE_CHILD`), each
    checked: every flash launch of the step in its trace. Not counted on
    the main path: they measure it."""
    root = pathlib.Path(__file__).resolve().parent
    d = os.path.join(work, "seq_capture")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SEQ_CAPTURE_CHILD, d, str(_free_port()), str(SEQ_IMAGE_SIZE),
         str(SEQ_BATCH), str(SEQ_TOP), ",".join(SEQ_FLASH_FUNCTIONS)],
        cwd=root, capture_output=True, text=True, timeout=SEQ_CAPTURE_TIMEOUT_S)
    check(proc.returncode == 0, f"(b) the capture child: exit {proc.returncode}\n"
                                f"{proc.stderr[-3000:]}")
    caps = json.loads(proc.stdout.strip().splitlines()[-1])
    flash_per_step = sum(PER_STEP[k] for k in MMA_KERNELS)
    for mode, c in caps.items():
        check(c["launches"] == {k: PER_STEP[k] for k in MMA_KERNELS}
              and c["flash_count"] == flash_per_step and c["n_ops"] < SEQ_TOP,
              f"(b) {mode}: the capture holds {c['flash_count']} flash launches of "
              f"{flash_per_step} (the wrappers counted {c['launches']}), {c['n_ops']} ops")
    _p15_say(f"(b) captures in a fresh process: {time.perf_counter() - t0:.1f} s")
    return {None if m == "none" else m: c for m, c in caps.items()}


def _seq_times() -> dict:
    """(c) #1-#3 and ``F.scaled_dot_product_attention`` at [96, 4096, 64]
    bf16, each call's device ms with a head start (not counted: these
    compare, they are not the main path)."""
    bh, s, d = SEQ_SHAPE
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    q, k, v, do = (torch.randn(SEQ_SHAPE, device=DEVICE, generator=gen).to(bf16)
                   for _ in range(4))
    out, m, l = fa.flash_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, m, l, delta)
    q4, k4, v4, do4 = (t.view(SEQ_BATCH, 12, s, d) for t in (q, k, v, do))
    q4, k4, v4 = (t.detach().requires_grad_() for t in (q4, k4, v4))
    with torch.no_grad():
        fwd = cuda_ms(lambda: fa.flash_fwd(q, k, v), iters=10, warmup=2)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), iters=10, warmup=2)
        dkdv = cuda_ms(lambda: fa.flash_bwd_dkdv(*args), iters=10, warmup=2)
        dq = cuda_ms(lambda: fa.flash_bwd_dq(*args), iters=10, warmup=2)
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4,
                                                  retain_graph=True), iters=10, warmup=2)
    bounds = {"flash_attention_fwd": flash_bound(bh, s, d, bf16),
              **flash_bwd_bounds(bh, s, d, bf16)}
    times = {"flash_attention_fwd": (fwd, lib_fwd), "flash_attention_bwd_dkdv": (dkdv, lib_bwd),
             "flash_attention_bwd_dq": (dq, lib_bwd)}
    out = {}
    for name, ((ms, us), (lib_ms, lib_us)) in times.items():
        bound_ms, bound_by = bounds[name]
        out[name] = {"ms_s4096": ms, "host_us_s4096": us, "library_ms_s4096": lib_ms,
                     "library_host_us_s4096": lib_us, "bound_ms_s4096": bound_ms,
                     "bound_by_s4096": bound_by}
        _p15_say(f"(c) {name} at [BH, S, D] = {list(SEQ_SHAPE)} bf16: kernel {ms:.4f} ms "
                 f"(host {us:.1f} us), bound {bound_ms:.4f} ms ({bound_by}), "
                 + ("scaled_dot_product_attention" if name == "flash_attention_fwd"
                    else "the whole scaled_dot_product_attention backward")
                 + f" {lib_ms:.4f} ms (host {lib_us:.1f} us)")
    _p15_say(f"(c) #2 + #3 {dkdv[0] + dq[0]:.4f} ms against the SDPA backward's "
             f"{lib_bwd[0]:.4f} ms; #1 {fwd[0] / lib_fwd[0]:.2f}x SDPA's forward")
    return out


def phase_seq(work: str) -> tuple:
    """Phase 15 (module docstring). Returns (the kernels' launches of (a) and
    (b), their tensor-core launches, the numbers for the kernels line)."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    launches = dict.fromkeys(KERNELS, 0)
    mma = dict.fromkeys(MMA_KERNELS, 0)
    composition = {}
    for dt in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            got, got_mma, worst, pass_ms = _seq_composition(dt, causal, gen)
            for k in KERNELS:
                launches[k] += got[k]
            for k in MMA_KERNELS:
                mma[k] += got_mma[k]
            composition[f"ring_{str(dt).removeprefix('torch.')}_"
                        f"{'causal' if causal else 'full'}"] = (worst, pass_ms)

    numbers = _seq_times()
    torch.cuda.empty_cache()

    # a 1-rank NCCL group: the seq group is a real NCCL group of one, so the
    # step's reduces, the pooled sum and Ulysses' exchanges run
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        steps, step_launches, step_mma = _seq_step_runs(mesh_lib.seq_axis(1), work)
    finally:
        if created:
            torch.distributed.destroy_process_group()
    for k in KERNELS:
        launches[k] += step_launches[k]
    for k in MMA_KERNELS:
        mma[k] += step_mma[k]
    gaps = [abs(a / b - 1) for a, b in zip(steps["ring"], steps[None])]
    _p15_say(f"(b) ring vs no seq group: loss gaps {[f'{g:.2e}' for g in gaps]} (limit "
             f"{SEQ_STEP_LOSS_RTOL}); ulysses "
             f"{'equal' if steps['ulysses'] == steps[None] else 'NOT equal'}")
    check(max(gaps) <= SEQ_STEP_LOSS_RTOL, f"(b) ring losses {steps['ring']} vs {steps[None]}")
    check(steps["ulysses"] == steps[None],
          f"(b) ulysses losses {steps['ulysses']} vs {steps[None]}")
    torch.cuda.empty_cache()

    for name in MMA_KERNELS:
        worst = max(w for w, _ in composition.values())
        numbers[name]["max_abs_err_ring"] = worst
    numbers["flash_attention_fwd"].update(
        {f"{k}_pass_ms": ms for k, (_, ms) in composition.items()})
    _p15_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: "
             f"{_smi_line()}")
    return launches, mma, numbers


def _seq_step_runs(seq, work: str) -> tuple:
    """(b): the three step runs from the same weights and batches, then the
    captures; returns ({sp_mode: losses}, their launches together, their
    tensor-core launches together)."""
    rng = np.random.default_rng(15)
    images = torch.from_numpy(rng.standard_normal(
        (SEQ_STEPS, SEQ_BATCH, SEQ_IMAGE_SIZE, SEQ_IMAGE_SIZE, 3), dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, (SEQ_STEPS, SEQ_BATCH))).to(DEVICE)
    init = {k: v.detach().clone() for k, v in vit_b16(
        num_classes=1000, image_size=SEQ_IMAGE_SIZE, device=DEVICE, seed=TRAIN_SEED
    ).state_dict().items()}
    runs, launches = {}, dict.fromkeys(KERNELS, 0)
    mma = dict.fromkeys(MMA_KERNELS, 0)
    want = {k: (SEQ_STEPS + SEQ_TIMED) * PER_STEP[k] for k in KERNELS}
    for sp_mode in (None, "ring", "ulysses"):
        tag = sp_mode or "no seq group"
        r = runs[sp_mode] = _seq_steps(seq, sp_mode, images, labels, init)
        laps = r["laps"]
        _p15_say(f"(b) ViT-B/16 at {SEQ_IMAGE_SIZE} px (S = {SEQ_SHAPE[1]}), batch {SEQ_BATCH}, "
                 f"bf16, flash, {tag}: losses {r['losses']}; {SEQ_TIMED} host laps at lr 0 "
                 f"median {statistics.median(laps):.2f} ms (min {min(laps):.2f}, max "
                 f"{max(laps):.2f}); peak {r['peak'] / 2**30:.2f} GiB; launches "
                 f"{r['launches']} (mma {r['mma']})")
        check(r["launches"] == want, f"(b) {tag}: launches {r['launches']}, want {want}")
        # bf16 compute: every flash launch on the tensor cores, as phase 7
        check(all(r["mma"][k] == r["launches"][k] for k in MMA_KERNELS),
              f"(b) {tag}: tensor-core launches {r['mma']} of {r['launches']}")
        check(all(math.isfinite(x) for x in r["losses"]), f"(b) {tag}: losses {r['losses']}")
        for k in KERNELS:
            launches[k] += r["launches"][k]
        for k in MMA_KERNELS:
            mma[k] += r["mma"][k]
    torch.cuda.empty_cache()
    caps = _seq_captures(work)
    for sp_mode, c in caps.items():
        _p15_say(f"(b) the traced step, {sp_mode or 'no seq group'}: device busy "
                 f"{c['busy_ms']:.2f} ms, of which the flash kernels {c['flash_ms']:.2f} ms "
                 f"({c['flash_ms'] / c['busy_ms']:.1%}, {c['flash_count']} launches, "
                 f"{c['n_ops']} distinct ops)")
    base, cap0 = runs[None], caps[None]
    for sp_mode in ("ring", "ulysses"):
        r, c = runs[sp_mode], caps[sp_mode]
        _p15_say(f"(b) {sp_mode} against no seq group: median lap "
                 f"{statistics.median(r['laps']) / statistics.median(base['laps']) - 1:+.2%}, "
                 f"device busy {c['busy_ms'] / cap0['busy_ms'] - 1:+.2%}, flash kernels "
                 f"{c['flash_ms'] / cap0['flash_ms'] - 1:+.2%}, the rest "
                 f"{(c['busy_ms'] - c['flash_ms']) - (cap0['busy_ms'] - cap0['flash_ms']):+.2f} ms")
    return {m: r["losses"] for m, r in runs.items()}, launches, mma


# -- phase 16: tensor and expert parallelism --------------------------------------

MP_TP = 4          # the lockstep TP group's virtual ranks: 3 of ViT-B/16's 12 heads each
MP_BATCH = 8       # ViT-B/16 at 224 px
MP_STEPS = 3
MP_LR = 0.1
MP_TIMED = 5       # (d): step calls timed back to back
# (b) the lockstep group against the unsharded forward and backward, max
# |got - want| over max |want| a leaf. f32 (TF32 off): the four shards'
# partial products summed in rank order where the full matmul sums them in
# one, a few ulps of the largest value through 12 blocks. bf16: each
# shard's proj and mlp2 partial output is rounded to bf16 before the sum
# where the full matmul rounds once, and the 12 blocks compound it: a few
# bf16 steps (2^-8 relative) of the largest value; the loss within the
# bf16 parity's 2e-3 (PARITY_BF16_LOSS_RTOL).
MP_LOCKSTEP_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
MP_LOCKSTEP_LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: PARITY_BF16_LOSS_RTOL}
MP_MOE_BATCH = 32  # vit_moe_tiny at 32 px: 64 tokens an image, 2,048 a step
MP_MOE_SHAPE = (4 * MP_MOE_BATCH, 64, 16)  # its [BH, S, D]: 4 heads of 16
# (c) the EP step over an expert group of one against the dense step, f32
# (TF32 off): the expert einsums run with an extra group dimension (another
# cuBLAS batching, another summation order), a few f32 ulps a step carried
# through 3 steps
MP_MOE_LOSS_RTOL = 1e-5
# (c) the lockstep expert group of 4 against apply_dense on each rank's
# tokens, f32: the same products, batched otherwise
MP_MOE_TOL = 1e-5

#: phase 16's result lines, repeated by the report
MP_SUMMARY: list = []


def _p16_say(msg: str, keep: bool = True) -> None:
    print(f"[mp] {msg}", flush=True)
    if keep:
        MP_SUMMARY.append(f"[mp] {msg}")


def _add(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def _mp_tp_steps(tmesh, images, labels) -> tuple:
    """(a) MP_STEPS bf16 steps of ViT-B/16 (flash, fused SGD) through the TP
    step over a model group of one, and the plain step from the same
    weights (not counted). Returns (the TP step's launches and tensor-core
    launches, {"tp", "plain": (step, state)} for (d))."""
    runs = {}
    for tag in ("plain", "tp"):
        shard = {"tp": tmesh[mesh_lib.MODEL_AXIS]} if tag == "tp" else {}
        model = vit_b16(attn_impl="flash", device=DEVICE, seed=TRAIN_SEED, **shard)
        opt = _sgd_for("flash")
        st = state_lib.TrainState.create(model, opt)
        kw = (dict(tp_axis=tmesh[mesh_lib.MODEL_AXIS], axis=tmesh[mesh_lib.DATA_AXIS])
              if tag == "tp" else {})
        train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        reset_launches()
        losses = []
        for i in range(MP_STEPS):
            st, m = train_step(st, images[i], labels[i], MP_LR)
            losses.append(m["loss"].item())
        runs[tag] = (losses, read_launches(), read_mma_launches(), train_step, st)
    (plain, _, _, plain_step, plain_st), (tp, launches, mma, tp_step, tp_st) = (runs["plain"],
                                                                             runs["tp"])
    gaps = [abs(a / b - 1) for a, b in zip(tp, plain)]
    _p16_say(f"(a) ViT-B/16 224 px, batch {MP_BATCH}, bf16, flash, fused SGD: TP step over a "
             f"model group of one, losses {tp}; the plain step's {plain}: "
             f"{'equal bit for bit' if tp == plain else 'NOT equal'} (gaps "
             f"{[f'{g:.1e}' for g in gaps]}); launches {launches} (mma {mma})")
    want = {k: MP_STEPS * PER_STEP[k] for k in KERNELS}
    check(tp == plain, f"(a) the TP step's losses {tp} vs the plain step's {plain}")
    check(launches == want and all(mma[k] == launches[k] for k in MMA_KERNELS),
          f"(a) launches {launches} (mma {mma}), want {want}")
    return launches, mma, {"tp": (tp_step, tp_st), "plain": (plain_step, plain_st)}


def _gathered_grads(shards) -> dict:
    """The lockstep group's gradients at full width: the sharded leaves
    joined along their dimension in rank order, the replicated leaves the
    first shard's (the others take none: their copies are not used)."""
    specs = shards[0].param_specs()
    named = [dict(s.named_parameters()) for s in shards]
    out = {}
    for name, p in named[0].items():
        if name in specs:
            out[name] = torch.cat([n[name].grad for n in named], dim=specs[name][1])
        else:
            out[name] = p.grad
    return out


def _mp_models() -> tuple:
    """(b)'s unsharded ViT-B/16 and its MP_TP shards, each drawn from
    TRAIN_SEED, with copies of their initial weights (each dtype's pass
    starts from them)."""
    full = vit_b16(attn_impl="flash", device=DEVICE, seed=TRAIN_SEED)
    shards = [vit_b16(attn_impl="flash", device=DEVICE, seed=TRAIN_SEED,
                      tp=mesh_lib.AxisGroup(mesh_lib.MODEL_AXIS, MP_TP, r))
              for r in range(MP_TP)]
    init = [{k: v.detach().clone() for k, v in m.state_dict().items()}
            for m in [full, *shards]]
    return full, shards, init


def _mp_lockstep(dt, images, labels, models) -> tuple:
    """(b) one dtype: the lockstep TP group of MP_TP virtual ranks at full
    width, forward and backward (counted), then each rank's fused SGD
    update over its own leaves (counted); against the unsharded model's
    forward and backward from the same weights (not counted). Returns
    (launches, tensor-core launches, the worst error, the pass's ms)."""
    full, shards, init = models
    for m, sd in zip([full, *shards], init):
        m.load_state_dict(sd)
        m.zero_grad(set_to_none=True)
    heads = shards[0].blocks[0].qkv.out_features // (3 * 64)
    check(heads == 12 // MP_TP, f"(b) {heads} local heads")
    opts = [_sgd_for("flash") for _ in shards]
    states = [state_lib.TrainState.create(s, o) for s, o in zip(shards, opts)]
    x, y = images.to(dt), labels

    def lockstep_pass(lr=MP_LR, plain=None):
        for s in shards:
            s.zero_grad(set_to_none=True)
        loss = F.cross_entropy(vit.tp_lockstep_forward(shards, x).float(), y)
        loss.backward()
        lead = dict(shards[0].named_parameters())
        for s, o, st in zip(shards, opts, states):
            named = list(s.named_parameters())
            grads = [p.grad if p.grad is not None else lead[n].grad for n, p in named]
            params = [p for _, p in named]
            if plain is not None:
                # the plain update from the same leaves, gradients and buffers
                ref = [t.detach().clone() for t in params + list(st.opt_state)]
                fs.fused_sgd_reference(ref[:len(params)], grads, ref[len(params):], lr,
                                       momentum=o.momentum, weight_decay=o.weight_decay)
            o.update(grads, st.opt_state, params, lr)
            if plain is not None:
                plain.append(max(float((a.detach() - b).abs().max())
                                 for a, b in zip(params + list(st.opt_state), ref)))
        return loss

    torch.cuda.synchronize()
    reset_launches()
    update_errs: list = []
    loss = lockstep_pass(plain=update_errs)
    torch.cuda.synchronize()
    launches, mma = read_launches(), read_mma_launches()
    update_err = max(update_errs)
    grads = _gathered_grads(shards)
    ref = F.cross_entropy(full(x).float(), y)
    ref.backward()
    errs = {n: _rel_err(grads[n], p.grad) for n, p in full.named_parameters()}
    worst = max(errs.values())
    tag = str(dt).removeprefix("torch.")
    want = {**{k: 12 * MP_TP for k in MMA_KERNELS}, "fused_sgd": MP_TP}
    pass_ms, _ = cuda_ms(lambda: lockstep_pass(0.0), iters=3, warmup=1, head_start=False)
    worst_name = max(errs, key=errs.get)
    _p16_say(f"(b) lockstep TP group of {MP_TP} at ViT-B/16's full width, {tag}, batch "
             f"{MP_BATCH}: {heads} local heads a rank ([BH, S, D] = [{heads * MP_BATCH}, 196, 64] "
             f"a launch), loss {loss.item()!r} vs the unsharded {ref.item()!r}; gathered "
             f"gradients max error / max {worst:.2e} ({worst_name}; limit {MP_LOCKSTEP_TOL[dt]}); "
             f"launches {launches} (mma {mma}); each rank's fused SGD update of its shards "
             f"against the plain update of the same leaves and gradients: max |diff| "
             f"{update_err!r} over the {MP_TP} ranks (bit for bit wanted); a pass (forward, "
             f"backward, {MP_TP} updates) {pass_ms:.3f} ms back to back")
    check(launches == want, f"(b) {tag}: launches {launches}, want {want}")
    check(len(update_errs) == MP_TP and update_err == 0.0,
          f"(b) {tag}: the shards' fused SGD updates differ from the plain ones by {update_errs}")
    check(all(mma[k] == (launches[k] if dt == torch.bfloat16 else 0) for k in MMA_KERNELS),
          f"(b) {tag}: tensor-core launches {mma}")
    check(abs(loss.item() / ref.item() - 1) <= MP_LOCKSTEP_LOSS_RTOL[dt],
          f"(b) {tag}: loss {loss.item()} vs {ref.item()}")
    check(worst <= MP_LOCKSTEP_TOL[dt], f"(b) {tag}: gradient errors {errs}")
    del states, opts, grads
    return launches, mma, worst, update_err, pass_ms


def _mp_moe(emesh) -> tuple:
    """(c) vit_moe_tiny, f32 (TF32 off), flash at D = 16, fused SGD, at
    ``moe_top_k`` 1 and 2: MP_STEPS steps of the EP step over an expert group
    of one (counted) against the dense step (not counted); then the
    lockstep expert group of 4 against apply_dense on each rank's tokens.
    Returns (launches, tensor-core launches, the EP step and its state for
    (d), the worst lockstep error)."""
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.standard_normal((MP_STEPS, MP_MOE_BATCH, 32, 32, 3),
                                                  dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 10, (MP_STEPS, MP_MOE_BATCH))).to(DEVICE)
    launches, mma, worst_lock = dict.fromkeys(KERNELS, 0), dict.fromkeys(MMA_KERNELS, 0), 0.0
    ep_step = ep_st = None
    for k in (1, 2):
        runs = {}
        for tag in ("dense", "ep"):
            shard = {"ep": emesh[mesh_lib.EXPERT_AXIS]} if tag == "ep" else {}
            model = vit_moe.vit_moe_tiny(attn_impl="flash", device=DEVICE, seed=TRAIN_SEED,
                                         top_k=k, **shard)
            opt = _sgd_for("flash")
            st = state_lib.TrainState.create(model, opt)
            kw = (dict(ep_axis=emesh[mesh_lib.EXPERT_AXIS], axis=emesh[mesh_lib.DATA_AXIS])
                  if tag == "ep" else {})
            train_step = step_lib.make_train_step(opt, **kw)
            torch.cuda.synchronize()
            reset_launches()
            losses = []
            for i in range(MP_STEPS):
                st, m = train_step(st, images[i], labels[i], MP_LR)
                losses.append(m["loss"].item())
            runs[tag] = (losses, read_launches(), read_mma_launches())
            if tag == "ep" and k == 2:
                ep_step, ep_st = train_step, st
        (dense, _, _), (ep, got, got_mma) = runs["dense"], runs["ep"]
        want = {"flash_attention_fwd": 2 * MP_STEPS, "flash_attention_bwd_dkdv": 2 * MP_STEPS,
                "flash_attention_bwd_dq": 2 * MP_STEPS, "fused_sgd": MP_STEPS}
        gaps = [abs(a / b - 1) for a, b in zip(ep, dense)]
        _p16_say(f"(c) vit_moe_tiny, moe_top_k {k}, f32, flash at [BH, S, D] = "
                 f"[{4 * MP_MOE_BATCH}, 64, 16]: EP step over an expert group of one, losses "
                 f"{ep}; the dense step's {dense}: gaps {[f'{g:.1e}' for g in gaps]} (limit "
                 f"{MP_MOE_LOSS_RTOL}); launches {got}")
        check(max(gaps) <= MP_MOE_LOSS_RTOL, f"(c) k={k}: losses {ep} vs {dense}")
        check(got == want and all(v == 0 for v in got_mma.values()),
              f"(c) k={k}: launches {got} (mma {got_mma}), want {want}")
        _add(launches, got)
        _add(mma, got_mma)
        # the lockstep expert group: 4 ranks' tokens through the exchange
        moe_model = vit_moe.vit_moe_tiny(device=DEVICE, seed=TRAIN_SEED, top_k=k)
        p = moe_model.blocks[0].moe.params()
        moe = moe_model.moe
        xs = [torch.randn(16 * 64, 64, device=DEVICE) for _ in range(4)]
        with torch.no_grad():
            ys = moe.apply_ep_lockstep(p["router"], p["w_in"], p["w_out"], xs)
            err = max(_rel_err(yl, moe.apply_dense(p, xi)) for yl, xi in zip(ys, xs))
        worst_lock = max(worst_lock, err)
        _p16_say(f"(c) lockstep expert group of 4 (2 experts a rank, 1,024 tokens a rank, "
                 f"capacity {moe._capacity(16 * 64)}), moe_top_k {k}: max error / max against "
                 f"apply_dense on each rank's tokens {err:.2e} (limit {MP_MOE_TOL})")
        check(err <= MP_MOE_TOL, f"(c) lockstep k={k}: error {err}")
    return launches, mma, ep_step, ep_st, images, labels, worst_lock


def phase_mp(work: str) -> tuple:
    """Phase 16 (module docstring). Returns (the kernels' launches on its
    main paths, their tensor-core launches, the numbers for the kernels
    line)."""
    del work
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.standard_normal(
        (MP_STEPS, MP_BATCH) + IMAGE, dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, (MP_STEPS, MP_BATCH))).to(DEVICE)
    launches, mma = dict.fromkeys(KERNELS, 0), dict.fromkeys(MMA_KERNELS, 0)
    lockstep = {}
    models = _mp_models()
    for dt in (torch.bfloat16, torch.float32):
        got, got_mma, worst, update_err, pass_ms = _mp_lockstep(dt, images[0], labels[0],
                                                                models)
        _add(launches, got)
        _add(mma, got_mma)
        lockstep[str(dt).removeprefix("torch.")] = (worst, update_err, pass_ms)
    del models
    torch.cuda.empty_cache()
    # a 1-rank NCCL group: the model and expert groups are real NCCL groups
    # of one, so the conjugate pair's all-reduces and the MoE exchange run
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        got, got_mma, steps = _mp_tp_steps(mesh_lib.tp_mesh(1), images, labels)
        _add(launches, got)
        _add(mma, got_mma)
        # in turns, plain first: the same step but for the conjugate pair
        times = {tag: [] for tag in ("plain", "tp")}
        for _ in range(2):
            for tag, (fn, st) in steps.items():
                times[tag].append(cuda_ms(lambda: fn(st, images[0], labels[0], 0.0),
                                          iters=MP_TIMED, warmup=1, head_start=False))
        (tp_ms, tp_us), (plain_ms, plain_us) = (min(times[t]) for t in ("tp", "plain"))
        del steps
        torch.cuda.empty_cache()
        got, got_mma, ep_step, ep_st, moe_images, moe_labels, worst_moe = _mp_moe(
            mesh_lib.ep_mesh(1))
        _add(launches, got)
        _add(mma, got_mma)
        ep_ms, ep_us = cuda_ms(lambda: ep_step(ep_st, moe_images[0], moe_labels[0], 0.0),
                               iters=MP_TIMED, warmup=1, head_start=False)
    finally:
        if created:
            torch.distributed.destroy_process_group()
    smi = _smi_line()
    _p16_say(f"(d) one TP step (ViT-B/16, batch {MP_BATCH}, bf16, model group of one) "
             f"{tp_ms:.3f} ms back to back (host {tp_us:.0f} us a call), the plain step "
             f"{plain_ms:.3f} ms (host {plain_us:.0f} us; the better of 2 turns each); one MoE step "
             f"(vit_moe_tiny, moe_top_k 2, batch {MP_MOE_BATCH}, f32, expert group of one) "
             f"{ep_ms:.3f} ms (host {ep_us:.0f} us); card: {smi}")
    # the lockstep gradients' error (max |diff| over max |want| of the worst
    # leaf) reads the attention kernels; the update's (max |diff|) fused_sgd
    numbers = {name: {f"tp_lockstep_grad_err_over_max_{t}": w
                      for t, (w, _, _) in lockstep.items()} for name in MMA_KERNELS}
    numbers["fused_sgd"] = {f"max_abs_err_tp_lockstep_update_{t}": u
                            for t, (_, u, _) in lockstep.items()}
    numbers["flash_attention_fwd"].update({f"tp_lockstep_{t}_pass_ms": ms
                                           for t, (_, _, ms) in lockstep.items()})
    numbers["flash_attention_fwd"].update({"tp_step_ms": tp_ms, "tp_plain_step_ms": plain_ms,
                                           "moe_step_ms": ep_ms,
                                           "moe_lockstep_err_over_max": worst_moe})
    _p16_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: {smi}")
    return launches, mma, numbers


# -- phase 17: pipeline parallelism -------------------------------------------

PP_STAGES = 4      # the lockstep pipe group's virtual stages: 3 of ViT-B/16's 12 blocks each
PP_BATCH = 32      # ViT-B/16 at 224 px
# (a): schedule -> (chunks a stage, microbatches): GPipe with M = 8 (4 examples
# a microbatch); the interleaved 4 x 3 (12 chunks of one block) with M = 4
PP_SCHEDULES = {"gpipe": (1, 8), "interleaved": (3, 4)}
PP_STEPS = 3
PP_LR = 0.1
PP_TIMED = 5       # (b): step calls timed back to back, a turn
# (a) the lockstep pipeline against the unsharded model from the same
# weights: the same products on the microbatches' rows as on the whole
# batch's, which cuBLAS may tile otherwise (another summation order), and
# the weight gradients summed over M microbatches in another order; in bf16
# each microbatch's product rounds once where the whole batch's does, and 12
# blocks compound it: a few bf16 steps (2^-8 relative) of the largest value,
# as phase 16's TP group (MP_LOCKSTEP_TOL); the loss as MP_LOCKSTEP_LOSS_RTOL
PP_LOCKSTEP_TOL = MP_LOCKSTEP_TOL
PP_LOCKSTEP_LOSS_RTOL = MP_LOCKSTEP_LOSS_RTOL
# (b) the step at M = 4 against the plain step, bf16: the microbatches'
# products and weight-gradient sums rounded otherwise, as the bf16 parity's
PP_STEP_LOSS_RTOL = PARITY_BF16_LOSS_RTOL

#: phase 17's result lines, repeated by the report
PP_SUMMARY: list = []


def _p17_say(msg: str, keep: bool = True) -> None:
    print(f"[pp] {msg}", flush=True)
    if keep:
        PP_SUMMARY.append(f"[pp] {msg}")


def _pp_vit(**kw):
    """ViT-B/16's widths as a pipelined ViT drawn from TRAIN_SEED (flash)."""
    return vit_pp.ViTPipeline(224, 16, 768, 12, 12, num_classes=1000, attn_impl="flash",
                              device=DEVICE, seed=TRAIN_SEED, **kw)


def _pp_logical(stages, v: int, value) -> dict:
    """A lockstep pipe group's leaves by the unsharded model's names (blocks
    in logical order): ``value(parameter)`` of each stage's block rows, and
    of the first stage's replicated leaves (the others take no gradient)."""
    perm = vit_pp.storage_perm(12, v, PP_STAGES if v > 1 else 0)
    per = 12 // PP_STAGES
    out = {n: value(p) for n, p in stages[0].named_parameters() if not n.startswith("blocks.")}
    for d, s in enumerate(stages):
        for i, blk in enumerate(s.blocks):
            j = d * per + i if perm is None else int(perm[d * per + i])
            for leaf, p in blk.named_parameters():
                out[f"blocks.{j}.{leaf}"] = value(p)
    return out


def _pp_lockstep(dt, schedule: str, images, labels, full, stages, inits) -> tuple:
    """(a) one schedule and dtype: the lockstep pipe group of PP_STAGES
    virtual stages at full width, forward and backward through
    ``vit_pp.pipeline_lockstep_forward`` (counted), then each stage's fused
    SGD update over its own leaves (counted); against the unsharded model's
    forward, backward and fused SGD update from the same weights (not
    counted). Returns (launches, tensor-core launches, the worst gradient
    and weight errors, the update's worst |diff| against the plain update,
    the pass's ms)."""
    v, m = PP_SCHEDULES[schedule]
    for mod, sd in zip([full, *stages], inits):
        mod.load_state_dict(sd)
        mod.zero_grad(set_to_none=True)
    opts = [_sgd_for("flash") for _ in stages]
    states = [state_lib.TrainState.create(s, o) for s, o in zip(stages, opts)]
    x, y = images.to(dt), labels

    def lockstep_pass(lr=PP_LR, plain=None):
        for s in stages:
            s.zero_grad(set_to_none=True)
        loss = F.cross_entropy(vit_pp.pipeline_lockstep_forward(stages, x, m).float(), y)
        loss.backward()
        lead = dict(stages[0].named_parameters())
        for s, o, st in zip(stages, opts, states):
            named = list(s.named_parameters())
            grads = [p.grad if p.grad is not None else lead[n].grad for n, p in named]
            params = [p for _, p in named]
            if plain is not None:
                ref = [t.detach().clone() for t in params + list(st.opt_state)]
                fs.fused_sgd_reference(ref[:len(params)], grads, ref[len(params):], lr,
                                       momentum=o.momentum, weight_decay=o.weight_decay)
            o.update(grads, st.opt_state, params, lr)
            if plain is not None:
                plain.append(max(float((a.detach() - b).abs().max())
                                 for a, b in zip(params + list(st.opt_state), ref)))
        return loss

    torch.cuda.synchronize()
    reset_launches()
    update_errs: list = []
    loss = lockstep_pass(plain=update_errs)
    torch.cuda.synchronize()
    launches, mma = read_launches(), read_mma_launches()
    grads = _pp_logical(stages, v, lambda p: p.grad)
    weights = _pp_logical(stages, v, lambda p: p.detach())
    ref = F.cross_entropy(full(x).float(), y)
    ref.backward()
    full_opt = _sgd_for("flash")
    full_st = state_lib.TrainState.create(full, full_opt)
    named = list(full.named_parameters())
    full_opt.update([p.grad for _, p in named], full_st.opt_state, [p for _, p in named], PP_LR)
    errs = {n: _rel_err(grads[n], p.grad) for n, p in named}
    w_errs = {n: _rel_err(weights[n], p.detach()) for n, p in named}
    worst, w_worst = max(errs.values()), max(w_errs.values())
    tag = str(dt).removeprefix("torch.")
    want = {**{k: 12 * m for k in MMA_KERNELS}, "fused_sgd": PP_STAGES}
    pass_ms, _ = cuda_ms(lambda: lockstep_pass(0.0), iters=3, warmup=1, head_start=False)
    _p17_say(f"(a) lockstep {schedule} of {PP_STAGES} stages x {v} chunk(s) at ViT-B/16's full "
             f"width, {tag}, batch {PP_BATCH} in {m} microbatches ([BH, S, D] = "
             f"[{12 * PP_BATCH // m}, 197, 64] a launch), bubble fraction "
             f"{pipeline.bubble_fraction(PP_STAGES, m, v):.3f}: loss {loss.item()!r} vs the "
             f"unsharded {ref.item()!r}; gathered gradients max error / max {worst:.2e} "
             f"({max(errs, key=errs.get)}), updated weights {w_worst:.2e} "
             f"({max(w_errs, key=w_errs.get)}; limit {PP_LOCKSTEP_TOL[dt]}); launches "
             f"{launches} (mma {mma}); each stage's fused SGD update against the plain update "
             f"of the same leaves and gradients: max |diff| {max(update_errs)!r} (bit for bit "
             f"wanted); a pass (forward, backward, {PP_STAGES} updates) {pass_ms:.3f} ms "
             f"back to back")
    check(launches == want, f"(a) {schedule} {tag}: launches {launches}, want {want}")
    check(len(update_errs) == PP_STAGES and max(update_errs) == 0.0,
          f"(a) {schedule} {tag}: the stages' fused SGD updates differ by {update_errs}")
    check(all(mma[k] == (launches[k] if dt == torch.bfloat16 else 0) for k in MMA_KERNELS),
          f"(a) {schedule} {tag}: tensor-core launches {mma}")
    check(abs(loss.item() / ref.item() - 1) <= PP_LOCKSTEP_LOSS_RTOL[dt],
          f"(a) {schedule} {tag}: loss {loss.item()} vs {ref.item()}")
    check(worst <= PP_LOCKSTEP_TOL[dt], f"(a) {schedule} {tag}: gradient errors {errs}")
    check(w_worst <= PP_LOCKSTEP_TOL[dt], f"(a) {schedule} {tag}: weight errors {w_errs}")
    return launches, mma, worst, w_worst, max(update_errs), pass_ms


def _pp_steps(pm, images, labels) -> tuple:
    """(b) PP_STEPS bf16 steps of ViT-B/16 (flash, fused SGD) through the
    step over a pipe group of one at M = 1 and M = 4, and the plain step
    from the same weights (not counted). Returns (the pipelined steps'
    launches and tensor-core launches, {tag: (step, state)} for the
    timing)."""
    plain_model = vit_b16(attn_impl="flash", device=DEVICE, seed=TRAIN_SEED)
    pp_model = _pp_vit(pipe=pm[mesh_lib.PIPE_AXIS])
    init = {k: v.detach().clone() for k, v in pp_model.state_dict().items()}
    runs, launches, mma = {}, dict.fromkeys(KERNELS, 0), dict.fromkeys(MMA_KERNELS, 0)
    for tag, model, m in (("plain", plain_model, None), ("pp_m1", pp_model, 1),
                          ("pp_m4", pp_model, 4)):
        if m is not None:
            model.load_state_dict(init)
        opt = _sgd_for("flash")
        st = state_lib.TrainState.create(model, opt)
        kw = (dict(pp_axis=pm[mesh_lib.PIPE_AXIS], axis=pm[mesh_lib.DATA_AXIS],
                   model_kwargs={"n_microbatches": m}) if m is not None else {})
        train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        reset_launches()
        losses = []
        for i in range(PP_STEPS):
            st, out = train_step(st, images[i], labels[i], PP_LR)
            losses.append(out["loss"].item())
        got, got_mma = read_launches(), read_mma_launches()
        runs[tag] = (losses, train_step, st)
        if m is not None:
            want = {**{k: PP_STEPS * 12 * m for k in MMA_KERNELS}, "fused_sgd": PP_STEPS}
            check(got == want and all(got_mma[k] == got[k] for k in MMA_KERNELS),
                  f"(b) M={m}: launches {got} (mma {got_mma}), want {want}")
            _add(launches, got)
            _add(mma, got_mma)
    plain, m1, m4 = (runs[t][0] for t in ("plain", "pp_m1", "pp_m4"))
    gaps = [abs(a / b - 1) for a, b in zip(m4, plain)]
    _p17_say(f"(b) ViT-B/16 224 px, batch {PP_BATCH}, bf16, flash, fused SGD, pipe group of "
             f"one: M = 1 losses {m1}, the plain step's {plain}: "
             f"{'equal bit for bit' if m1 == plain else 'NOT equal'}; M = 4 losses {m4}: gaps "
             f"{[f'{g:.1e}' for g in gaps]} (limit {PP_STEP_LOSS_RTOL}); launches {launches} "
             f"(mma {mma})")
    check(m1 == plain, f"(b) M=1 losses {m1} vs the plain step's {plain}")
    check(max(gaps) <= PP_STEP_LOSS_RTOL, f"(b) M=4 losses {m4} vs {plain}")
    return launches, mma, {t: (fn, st) for t, (_, fn, st) in runs.items()}


def phase_pp(work: str) -> tuple:
    """Phase 17 (module docstring). Returns (the kernels' launches on its
    main paths, their tensor-core launches, the numbers for the kernels
    line)."""
    del work
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(17)
    images = torch.from_numpy(rng.standard_normal(
        (PP_STEPS, PP_BATCH) + IMAGE, dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, (PP_STEPS, PP_BATCH))).to(DEVICE)
    launches, mma = dict.fromkeys(KERNELS, 0), dict.fromkeys(MMA_KERNELS, 0)
    lockstep = {}
    full = _pp_vit()
    full_init = {k: t.detach().clone() for k, t in full.state_dict().items()}
    for schedule, (v, m) in PP_SCHEDULES.items():
        stages = [_pp_vit(interleave=v, pp_stages=PP_STAGES if v > 1 else 0,
                          pipe=mesh_lib.AxisGroup(mesh_lib.PIPE_AXIS, PP_STAGES, d))
                  for d in range(PP_STAGES)]
        # each pass starts from the seed's weights (the unsharded model's
        # reference update changes them)
        inits = [full_init] + [{k: t.detach().clone() for k, t in mod.state_dict().items()}
                               for mod in stages]
        stage_bytes = [sum(p.numel() * p.element_size() for p in s.parameters()) for s in stages]
        _p17_say(f"(a) {schedule}: {PP_STAGES} stages x {v} chunk(s) of {12 // (PP_STAGES * v)} "
                 f"block(s), M = {m}, bubble fraction "
                 f"{pipeline.bubble_fraction(PP_STAGES, m, v):.3f}; each stage's parameter bytes "
                 f"(its blocks and the replicated embedding and head) {stage_bytes}, the whole "
                 f"model's {sum(p.numel() * p.element_size() for p in full.parameters())}")
        for dt in (torch.bfloat16, torch.float32):
            got, got_mma, worst, w_worst, update_err, pass_ms = _pp_lockstep(
                dt, schedule, images[0], labels[0], full, stages, inits)
            _add(launches, got)
            _add(mma, got_mma)
            lockstep[f"{schedule}_{str(dt).removeprefix('torch.')}"] = (worst, w_worst,
                                                                        update_err, pass_ms)
        del stages, inits
        torch.cuda.empty_cache()
    del full, full_init
    torch.cuda.empty_cache()
    # a 1-rank NCCL group: the pipe and data groups are real NCCL groups of
    # one (the step's reduces run; a pipe of one stage exchanges nothing)
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        got, got_mma, steps = _pp_steps(mesh_lib.pp_mesh(1), images, labels)
        _add(launches, got)
        _add(mma, got_mma)
        # in turns, plain first; each turn's peak memory over its timed calls
        times = {tag: [] for tag in steps}
        peaks = {tag: 0 for tag in steps}
        for _ in range(2):
            for tag, (fn, st) in steps.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times[tag].append(cuda_ms(lambda: fn(st, images[0], labels[0], 0.0),
                                          iters=PP_TIMED, warmup=1, head_start=False))
                peaks[tag] = max(peaks[tag], torch.cuda.max_memory_allocated())
        best = {tag: min(t) for tag, t in times.items()}
        del steps
        torch.cuda.empty_cache()
    finally:
        if created:
            torch.distributed.destroy_process_group()
    smi = _smi_line()
    _p17_say("(b) one step (ViT-B/16, batch " + str(PP_BATCH) + ", bf16, pipe group of one), "
             "back to back, 2 turns (plain, M = 1, M = 4 in each): " + ", ".join(
                 f"{tag} " + " / ".join(f"{ms:.3f}" for ms, _ in times[tag]) + " ms (host "
                 + " / ".join(f"{us:.0f}" for _, us in times[tag]) + " us a call), peak "
                 f"{peaks[tag] / 2**30:.3f} GiB" for tag in times) + f"; card: {smi}")
    numbers = {name: {f"pp_lockstep_grad_err_over_max_{t}": w
                      for t, (w, _, _, _) in lockstep.items()} for name in MMA_KERNELS}
    numbers["fused_sgd"] = {f"max_abs_err_pp_lockstep_update_{t}": u
                            for t, (_, _, u, _) in lockstep.items()}
    numbers["fused_sgd"].update({f"pp_lockstep_weight_err_over_max_{t}": w
                                 for t, (_, w, _, _) in lockstep.items()})
    numbers["flash_attention_fwd"].update({f"pp_lockstep_{t}_pass_ms": ms
                                           for t, (_, _, _, ms) in lockstep.items()})
    numbers["flash_attention_fwd"].update({f"pp_step_{t}_ms": best[t][0] for t in best})
    numbers["flash_attention_fwd"].update({f"pp_step_{t}_peak_bytes": peaks[t] for t in peaks})
    _p17_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: {smi}")
    return launches, mma, numbers


# -- phase 18: the sharded checkpoint format and FSDP --------------------------

FSDP_RANKS = 4          # (b): the lockstep group's virtual ranks
FSDP_BATCH = 32         # (b): the global batch, 8 a virtual rank
FSDP_LR = 0.1
# (b): the FSDP step against the plain step from the same weights, the
# gathered parameters' largest difference over the leaf's largest value.
# One process runs both on the same batch, so the products are the same;
# the FSDP step's gradient mean and global norm add in another order (the
# lockstep reduce-scatter cuts one gradient, the norms sum shard squares):
# f32 rounding, TF32 off; bf16 compute as the bf16 parity of phase 5
FSDP_PARAM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
FSDP_RESNET_RUN = dict(  # bench.py:240's resnet18_cifar100 shapes, 1 epoch of 4 steps
    model="resnet18", num_classes=100, dataset="synthetic", synthetic_n=1_280,
    batch_size=256, bf16=True, sync_bn=True, lr=0.1, epochs=1, steps_per_epoch=4,
    eval_every=1, log_every=2, seed=1, fsdp=True, sharded_ckpt=True, save_every=1,
)

#: phase 18's result lines, repeated by the report
FSDP_SUMMARY: list = []


def _p18_say(msg: str, keep: bool = True) -> None:
    print(f"[fsdp] {msg}", flush=True)
    if keep:
        FSDP_SUMMARY.append(f"[fsdp] {msg}")


def _dir_bytes(d: str, pred) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d) if pred(n))


def _timed(fn) -> tuple:
    """(fn's result, wall ms), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _assemble_pieces(pieces: dict, shapes: dict) -> dict:
    """{key: global array} from ``{(key, origin): piece}``: each piece laid
    at its origin; fails unless the pieces cover every element once."""
    out = {}
    for key, shape in shapes.items():
        buf, seen = None, 0
        for (k, origin), arr in pieces.items():
            if k != key:
                continue
            if buf is None:
                buf = np.zeros(shape, arr.dtype)
            buf[tuple(slice(o, o + e) for o, e in zip(origin, arr.shape))] = arr
            seen += arr.size
        check(buf is not None and seen == int(np.prod(shape)),
              f"the pieces of {key} cover {seen} of {int(np.prod(shape))} elements")
        out[key] = buf
    return out


def _fsdp_format(d: str) -> dict:
    """(a): ViT-B/16's train state (parameters and random momentum) through
    both formats over the 1-rank NCCL group; returns the numbers."""
    model = _bridged_vit_b16("xla")
    opt = optim.SGD(momentum=0.9, weight_decay=1e-4)
    st = state_lib.TrainState.create(model, opt)
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    with torch.no_grad():
        for b in st.opt_state:
            b.copy_(torch.randn(b.shape, generator=gen, device=DEVICE))
    st = dataclasses.replace(st, step=7)
    n = sum(p.numel() for p in model.parameters())
    check(n == 86_566_120, f"ViT-B/16 has {n} parameters")
    live = bridge.train_state_to_flat(st)
    nums = {}
    plain_dir, sync_dir, async_dir = (os.path.join(d, x) for x in ("plain", "sync", "async"))
    _, nums["plain_save_ms"] = _timed(lambda: ckpt_lib.save(plain_dir, st, 0))
    _, nums["sharded_save_ms"] = _timed(lambda: ckpt_lib.save_sharded(sync_dir, st, 0))
    writer = ckpt_lib.AsyncShardedCheckpointer()
    try:
        _, nums["async_blocking_ms"] = _timed(lambda: writer.save(async_dir, st, 0))
        _, nums["async_drain_ms"] = _timed(writer.wait)
    finally:
        writer.close()
    nums["plain_bytes"] = _dir_bytes(plain_dir, lambda x: x.endswith(".npz"))
    nums["sharded_bytes"] = _dir_bytes(sync_dir, lambda x: ".shard" in x or "manifest" in x)
    mpath = os.path.join(sync_dir, "ckpt_0.manifest.json")
    _, nums["verify_deep_ms"] = _timed(lambda: ckpt_lib.verify_sharded(mpath, deep=True))
    # the two sharded writes hold the same entries, bit for bit
    for a, b in ((sync_dir, async_dir),):
        with np.load(os.path.join(a, "ckpt_0.shard0of1.npz")) as za, \
                np.load(os.path.join(b, "ckpt_0.shard0of1.npz")) as zb:
            check(za.files == zb.files and bytes(za["__crc__"]) == bytes(zb["__crc__"]),
                  "the async sharded file's entries differ from the sync one's")
    # restore into a state of other weights and momentum
    other = bridge.load_jax_vit(vit_b16(attn_impl="xla", device=DEVICE),
                                bridge.numpy_vit_params(model, seed=TRAIN_SEED + 1))
    target = state_lib.TrainState.create(other, opt)
    target, nums["sharded_restore_ms"] = _timed(lambda: ckpt_lib.restore_sharded(mpath, target))
    back = bridge.train_state_to_flat(target)
    check(back.keys() == live.keys() and all(np.array_equal(back[k], live[k]) for k in live),
          "the sharded restore differs from the live state")
    check(target.step == 7, f"restored step {target.step}")
    plain, nums["plain_restore_ms"] = _timed(
        lambda: ckpt_lib.restore(os.path.join(plain_dir, "ckpt_0.npz")))
    with np.load(os.path.join(sync_dir, "ckpt_0.shard0of1.npz")) as z:
        pieces = {ckpt_lib.checkpoint._parse_shard_key(k)[:2]: z[k] for k in z.files
                  if k != "__crc__"}
    with open(mpath) as f:
        shapes = {k: tuple(v) for k, v in json.load(f)["shapes"].items()}
    from_shards = _assemble_pieces(pieces, shapes)
    check(from_shards.keys() == plain.keys()
          and all(np.array_equal(from_shards[k], plain[k]) for k in plain),
          "the sharded file's arrays differ from the plain file's")
    smi = _smi_line()
    _p18_say(f"(a) ViT-B/16's state ({n:,} f32 parameters + momentum, {len(live)} leaves) over a "
             f"1-rank NCCL group: plain save {nums['plain_save_ms']:.1f} ms, "
             f"{nums['plain_bytes']:,} bytes; sharded save {nums['sharded_save_ms']:.1f} ms, "
             f"{nums['sharded_bytes']:,} bytes (one shard file + manifest); async sharded save "
             f"blocks {nums['async_blocking_ms']:.1f} ms (the snapshot), drains "
             f"{nums['async_drain_ms']:.1f} ms; deep verify {nums['verify_deep_ms']:.1f} ms; "
             f"sharded restore {nums['sharded_restore_ms']:.1f} ms, plain restore "
             f"{nums['plain_restore_ms']:.1f} ms (warm page cache); restored state bit for bit, "
             f"async file = sync file, the sharded file's arrays = the plain file's; card: {smi}")
    del model, other, st, target, live, back, plain, from_shards, pieces
    torch.cuda.empty_cache()
    return nums


def _fsdp_lockstep(d: str, images, labels) -> dict:
    """(b): one FSDP step of a lockstep group of FSDP_RANKS virtual ranks
    against the plain step, f32 (TF32 off) and bf16; returns the numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nums = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).removeprefix("torch.")
        opt = optim.SGD(momentum=0.9, weight_decay=1e-4)
        plain = state_lib.TrainState.create(_bridged_vit_b16("xla"), opt)
        sharded = parallel_fsdp.shard_state(
            state_lib.TrainState.create(_bridged_vit_b16("xla"), opt),
            lockstep=FSDP_RANKS, optimizer=opt)
        fs_ = sharded.fsdp
        plain_step = step_lib.make_train_step(opt, compute_dtype=dt)
        fsdp_step = parallel_fsdp.make_fsdp_train_step(opt, compute_dtype=dt)
        plain, pm = plain_step(plain, images, labels, FSDP_LR)
        counters_lib.reset()
        reset_launches()
        sharded, sm = fsdp_step(sharded, images, labels, FSDP_LR)
        got = read_launches()
        check(all(v == 0 for v in got.values()), f"(b) {tag}: kernel launches {got} (want none)")
        comm = counters_lib.snapshot()
        worst = 0.0
        with fs_.gathered():
            for a, b in zip(plain.params.parameters(), sharded.params.parameters()):
                a, b = a.detach(), b.detach()
                worst = max(worst, float((a - b).abs().max() / a.abs().max().clamp_min(1e-30)))
        check(worst <= FSDP_PARAM_TOL[dt],
              f"(b) {tag}: gathered parameters {worst:.3g} of the leaf's largest value off the "
              f"plain step's (limit {FSDP_PARAM_TOL[dt]})")
        lp, ls = pm["loss"].item(), sm["loss"].item()
        check(math.isfinite(ls) and abs(lp - ls) <= FSDP_PARAM_TOL[dt] * abs(lp),
              f"(b) {tag}: loss {ls!r} vs the plain step's {lp!r}")
        total = sum(p.numel() * 4 for p in plain.params.parameters()) * 2  # params + momentum
        # a virtual rank's momentum mirrors its parameter shards
        per_rank = [2 * fs_.shard_bytes(k) for k in range(FSDP_RANKS)]
        repl = sum(leaf[0].numel() * 4 * 2 for leaf in fs_.shards if len(leaf) == 1)
        check(all(b == (total - repl) // FSDP_RANKS + repl for b in per_rank),
              f"(b) {tag}: per-rank bytes {per_rank}, whole {total}, replicated {repl}")
        # the virtual ranks' pieces assemble to the plain file's arrays
        pieces, shapes = bridge.shard_pieces(sharded)
        ckpt_lib.save(os.path.join(d, f"plain_{tag}"), sharded, 0)
        plain_file = ckpt_lib.restore(os.path.join(d, f"plain_{tag}", "ckpt_0.npz"))
        assembled = _assemble_pieces(pieces, shapes)
        check(assembled.keys() == plain_file.keys()
              and all(np.array_equal(assembled[k], plain_file[k]) for k in plain_file),
              f"(b) {tag}: the ranks' pieces differ from the plain file's arrays")
        n_pieces = sum(1 for (k, _) in pieces if k.startswith("['params']"))
        # a second call of each, warm (the first carried the library's set-up)
        (plain, _), plain_ms = _timed(lambda: plain_step(plain, images, labels, FSDP_LR))
        (sharded, _), fsdp_ms = _timed(lambda: fsdp_step(sharded, images, labels, FSDP_LR))
        nums[f"{tag}_param_err_over_max"] = worst
        nums[f"{tag}_fsdp_step_ms"] = fsdp_ms
        nums[f"{tag}_plain_step_ms"] = plain_ms
        nums["rank_bytes"] = per_rank[0]
        nums["whole_bytes"] = total
        _p18_say(f"(b) {tag}: lockstep FSDP group of {FSDP_RANKS} virtual ranks, ViT-B/16, batch "
                 f"{FSDP_BATCH}: one step against the plain step, gathered parameters "
                 f"{worst:.3g} of the leaf's largest value apart (limit {FSDP_PARAM_TOL[dt]}), "
                 f"loss {ls:.6f} vs {lp:.6f}; {sum(fs_.sharded(i) for i in range(len(fs_.dims)))} "
                 f"of {len(fs_.dims)} leaves sharded; each virtual rank's parameter + momentum "
                 f"bytes {per_rank[0]:,} beside a quarter of the whole {total // FSDP_RANKS:,} "
                 f"(replicated small leaves {repl:,}); {n_pieces} parameter pieces assemble to "
                 f"the plain file bit for bit; collectives {comm.get('comm.all_gather.fsdp_params', 0)}"
                 f" all-gathers, {comm.get('comm.reduce_scatter.fsdp_grad', 0)} reduce-scatters; "
                 f"kernel launches {got}; the second step {fsdp_ms:.1f} ms, the plain step's "
                 f"{plain_ms:.1f} ms (wall, synchronized); card: {_smi_line()}")
        del plain, sharded, pieces, assembled, plain_file
        torch.cuda.empty_cache()
    return nums


def _fsdp_trainer(d: str) -> dict:
    """(c): ``Trainer.fit`` under ``--fsdp --sharded_ckpt`` at ResNet-18's
    bench shapes over a 1-rank NCCL group, then ``Trainer(resume=True)``."""
    cfg = TrainConfig(**FSDP_RESNET_RUN, ckpt_dir=d, device=DEVICE, port=_free_port())
    counters_lib.reset()
    reset_launches()
    t = trainer_lib.Trainer(cfg)
    try:
        losses = []
        inner = t.train_step

        def step(st, images, labels, lr):
            st, m = inner(st, images, labels, lr)
            losses.append(m["loss"])
            return st, m

        t.train_step = step
        (_, fit_ms) = _timed(t.fit)
        saved = bridge.train_state_to_flat(t.state)
    finally:
        t.close()
    got = read_launches()
    losses = [float(x) for x in losses]
    check(len(losses) == FSDP_RESNET_RUN["steps_per_epoch"] and all(map(math.isfinite, losses)),
          f"(c) losses {losses}")
    names = sorted(os.listdir(d))
    check("ckpt_0.manifest.json" in names and "ckpt_0.shard0of1.npz" in names
          and not any(n.endswith(".npz") and ".shard" not in n for n in names),
          f"(c) the checkpoint directory holds {names}")
    t2 = trainer_lib.Trainer(dataclasses.replace(cfg, resume=True, epochs=2, port=_free_port()))
    try:
        check(t2.start_epoch == 1, f"(c) resumed at epoch {t2.start_epoch}")
        back = bridge.train_state_to_flat(t2.state)
    finally:
        t2.close()
    check(back.keys() == saved.keys() and all(np.array_equal(back[k], saved[k]) for k in saved),
          "(c) the resumed state differs from the saved one")
    _p18_say(f"(c) Trainer.fit --fsdp --sharded_ckpt, ResNet-18 (bench shapes: batch 256, 32 px, "
             f"100 classes, bf16), 1-rank NCCL group: {len(losses)} steps, losses "
             f"{[round(x, 4) for x in losses]}, fit {fit_ms:.0f} ms with its eval and save; "
             f"{names}; Trainer(resume=True) starts at epoch 1 with the saved state bit for bit; "
             f"kernel launches {got}; card: {_smi_line()}")
    return got


def phase_fsdp(work: str) -> tuple:
    """Phase 18 (module docstring). Returns the kernels' launches on its
    main paths (none: the FSDP step runs the dense attention and the plain
    SGD; its numbers are the ``[fsdp]`` lines')."""
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="fsdp_", dir=work)
    rng = np.random.default_rng(18)
    images = torch.from_numpy(rng.standard_normal((FSDP_BATCH,) + IMAGE,
                                                  dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, FSDP_BATCH)).to(DEVICE)
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        _fsdp_format(os.path.join(d, "a"))
    finally:
        if created:
            torch.distributed.destroy_process_group()
    _fsdp_lockstep(os.path.join(d, "b"), images, labels)
    launches = _fsdp_trainer(os.path.join(d, "c"))
    shutil.rmtree(d, ignore_errors=True)
    _p18_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: {_smi_line()}")
    return launches


# -- phase 19: ZeRO-1 under the seq axis and the rest of the telemetry ---------

ZSP_STEPS = 3
# (a): the ZeRO-1 x SP step's losses against the same step without ZeRO-1:
# at one rank the flat update is the per-leaf fused SGD over the same
# gradients (the seq mean and the data reduce-scatter of one rank are the
# identity), element for element the same arithmetic: bit for bit
ZSP_RESNET_RUN = dict(  # bench.py:240's resnet18_cifar100 shapes, 2 epochs of 3 steps
    model="resnet18", num_classes=100, dataset="synthetic", synthetic_n=1_280,
    batch_size=256, bf16=True, sync_bn=True, lr=0.1, epochs=2, steps_per_epoch=3,
    eval_every=1, log_every=1, seed=1, shard_weight_update=True, fused_optimizer=True,
    debug_replica_check=True,
)

#: phase 19's result lines, repeated by the report
ZSP_SUMMARY: list = []


def _p19_say(msg: str, keep: bool = True) -> None:
    print(f"[zero1-sp] {msg}", flush=True)
    if keep:
        ZSP_SUMMARY.append(f"[zero1-sp] {msg}")


def _zsp_state(init: dict, opt, data=None):
    """ViT-B/16 at 1,024 px (flash) from ``init``; with the data axis
    ``data``, ZeRO-1's flat optimizer state laid over it."""
    model = vit_b16(num_classes=1000, image_size=SEQ_IMAGE_SIZE, attn_impl="flash",
                    device=DEVICE)
    model.load_state_dict(init)
    st = state_lib.TrainState.create(model, opt)
    if data is not None:
        lay = step_lib.axis_layout(model, data)
        st = dataclasses.replace(st, layout=lay,
                                 opt_state=step_lib.init_sharded_opt_state(model, opt, layout=lay))
    return st


def _zsp_steps(init, images, labels, seq, data) -> dict:
    """(a) ZSP_STEPS bf16 steps through ``make_train_step`` with the seq
    axis (ring) and, with ``data``, ZeRO-1 over it; counted. Returns the
    losses, the launches, the tensor-core launches, the collectives, the
    final state and the step's ms (host laps ended by a sync)."""
    opt = _sgd_for("flash")
    st = _zsp_state(init, opt, data)
    kw = {"shard_weight_update": True, "axis": data} if data is not None else {}
    train_step = step_lib.make_train_step(opt, compute_dtype=torch.bfloat16, seq_axis=seq,
                                          sp_mode="ring", **kw)
    torch.cuda.synchronize()
    counters_lib.reset()
    reset_launches()
    losses, laps = [], []
    for i in range(ZSP_STEPS):
        t0 = time.perf_counter()
        st, metrics = train_step(st, images[i], labels[i], SEQ_LR)
        losses.append(metrics["loss"].item())  # ends in a sync
        laps.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "launches": read_launches(), "mma": read_mma_launches(),
            "comm": {k: v for k, v in counters_lib.snapshot().items() if k.startswith("comm.")},
            "state": st, "laps": laps}


def _zsp_formats(st, data, init, d: str) -> dict:
    """(a) the ZeRO-1 x SP state through both formats, gathered over the
    data axis; each restored into a fresh ZeRO-1 state bit for bit."""
    nums = {}
    # the first flatten of this model builds its JAX ravel order (cached)
    _, nums["flatten_first_ms"] = _timed(lambda: bridge.train_state_to_flat(st, dst=0))
    live, nums["flatten_ms"] = _timed(lambda: bridge.train_state_to_flat(st, dst=0))
    L = sum(p.numel() for p in st.params.parameters())
    flat_mom = live["['opt_state']"]
    check(flat_mom.shape == (padded_len(L, data.size),) and not flat_mom[L:].any(),
          f"(a) the gathered flat momentum has shape {flat_mom.shape}")
    meta = {"elastic": elastic_stamp(data.size, data.size, L)}
    plain_dir, sync_dir, async_dir = (os.path.join(d, x) for x in ("plain", "sync", "async"))
    _, nums["plain_save_ms"] = _timed(lambda: ckpt_lib.save(plain_dir, st, 0, extra_meta=meta))
    _, nums["sharded_save_ms"] = _timed(
        lambda: ckpt_lib.save_sharded(sync_dir, st, 0, extra_meta=meta))
    writer = ckpt_lib.AsyncShardedCheckpointer()
    try:
        _, nums["async_blocking_ms"] = _timed(
            lambda: writer.save(async_dir, st, 0, extra_meta=meta))
        _, nums["async_drain_ms"] = _timed(writer.wait)
    finally:
        writer.close()
    nums["plain_bytes"] = _dir_bytes(plain_dir, lambda x: x.endswith(".npz"))
    nums["sharded_bytes"] = _dir_bytes(sync_dir, lambda x: ".shard" in x or "manifest" in x)
    # one fresh ZeRO-1 state (the initial weights, zero momentum, step 0),
    # wiped again before each restore; built outside the timings
    target = _zsp_state(init, _sgd_for("flash"), data)

    def wipe():
        with torch.no_grad():
            for p in target.params.parameters():
                p.zero_()
            target.opt_state.zero_()
        return dataclasses.replace(target, step=0)

    def restore_plain(t):
        flat = ckpt_lib.restore(os.path.join(plain_dir, "ckpt_0.npz"), verify=True,
                                template=bridge.restore_template(t))
        return bridge.load_train_state(t, flat)

    for name, fn in (
            ("plain", restore_plain),
            ("sharded", lambda t: ckpt_lib.restore_sharded(
                os.path.join(sync_dir, "ckpt_0.manifest.json"), t)),
            ("async", lambda t: ckpt_lib.restore_sharded(
                os.path.join(async_dir, "ckpt_0.manifest.json"), t))):
        t = wipe()
        back, nums[f"{name}_restore_ms"] = _timed(lambda: fn(t))
        got = bridge.train_state_to_flat(back, dst=0)
        check(got.keys() == live.keys() and all(np.array_equal(got[k], live[k]) for k in live),
              f"(a) the {name} restore differs from the live ZeRO-1 x SP state")
        check(back.step == st.step, f"(a) {name}: restored step {back.step}")
        del back, got
    del target
    torch.cuda.empty_cache()
    return nums


def _zsp_step(work: str) -> tuple:
    """(a), over a 1-rank NCCL group; returns (launches, mma, numbers)."""
    rng = np.random.default_rng(19)
    images = torch.from_numpy(rng.standard_normal(
        (ZSP_STEPS, SEQ_BATCH, SEQ_IMAGE_SIZE, SEQ_IMAGE_SIZE, 3), dtype=np.float32)).to(DEVICE)
    labels = torch.from_numpy(rng.integers(0, 1000, (ZSP_STEPS, SEQ_BATCH))).to(DEVICE)
    init = {k: v.detach().clone() for k, v in vit_b16(
        num_classes=1000, image_size=SEQ_IMAGE_SIZE, device=DEVICE, seed=TRAIN_SEED
    ).state_dict().items()}
    seq, data = mesh_lib.seq_axis(1), mesh_lib.data_axis(1)
    base = _zsp_steps(init, images, labels, seq, None)
    del base["state"]
    torch.cuda.empty_cache()
    z = _zsp_steps(init, images, labels, seq, data)
    want = {k: ZSP_STEPS * PER_STEP[k] for k in KERNELS}
    check(z["launches"] == want, f"(a) launches {z['launches']}, want {want}")
    check(all(z["mma"][k] == z["launches"][k] for k in MMA_KERNELS),
          f"(a) tensor-core launches {z['mma']} of {z['launches']}")
    st = z["state"]
    lay = st.layout
    check(isinstance(st.opt_state, torch.Tensor) and st.opt_state.shape == (lay.chunk,)
          and (lay.world, lay.rank) == (data.size, data.index),
          f"(a) the flat shard: {tuple(st.opt_state.shape)} over {lay}")
    comm = z["comm"]
    check(comm.get("comm.all_reduce.grad_seq") == ZSP_STEPS
          and comm.get("comm.reduce_scatter.grad") == ZSP_STEPS
          and comm.get("comm.all_gather.params") == ZSP_STEPS
          and "comm.all_reduce.grad" not in comm,
          f"(a) collectives {comm}")
    check(all(math.isfinite(x) for x in z["losses"]), f"(a) losses {z['losses']}")
    check(z["losses"] == base["losses"],
          f"(a) ZeRO-1 x SP losses {z['losses']} vs {base['losses']} without ZeRO-1")
    smi = _smi_line()
    _p19_say(f"(a) ViT-B/16 at {SEQ_IMAGE_SIZE} px (S = {SEQ_SHAPE[1]}), batch {SEQ_BATCH}, bf16, "
             f"flash, ring over seq_axis(1), ZeRO-1 over data_axis(1), fused SGD: losses "
             f"{z['losses']}, bit for bit the same step's without ZeRO-1; launches "
             f"{z['launches']} (mma {z['mma']}); the flat shard {lay.chunk:,} f32 (L "
             f"{lay.L:,}); collectives {comm}; step host laps (sync) "
             f"{[round(x, 2) for x in z['laps']]} ms, without ZeRO-1 "
             f"{[round(x, 2) for x in base['laps']]} ms; card: {smi}")
    d = tempfile.mkdtemp(prefix="zsp_", dir=work)
    nums = _zsp_formats(st, data, init, d)
    shutil.rmtree(d, ignore_errors=True)
    _p19_say(f"(a) its state ({lay.L:,} parameters + the flat momentum) gathered over the data "
             f"axis: flatten {nums['flatten_first_ms']:.1f} ms (the first, with the ravel "
             f"order), then {nums['flatten_ms']:.1f} ms; plain save {nums['plain_save_ms']:.1f} "
             f"ms, {nums['plain_bytes']:,} bytes, restore {nums['plain_restore_ms']:.1f} ms; "
             f"sharded save {nums['sharded_save_ms']:.1f} ms, {nums['sharded_bytes']:,} bytes, "
             f"restore {nums['sharded_restore_ms']:.1f} ms; async sharded save blocks "
             f"{nums['async_blocking_ms']:.1f} ms, drains {nums['async_drain_ms']:.1f} ms, "
             f"restore {nums['async_restore_ms']:.1f} ms; every restore bit for bit (warm page "
             f"cache); card: {smi}")
    numbers = {"fused_sgd": {"zero1_sp_flat_shard": lay.chunk,
                             "zero1_sp_step_ms": statistics.median(z["laps"])}}
    launches, mma = z["launches"], z["mma"]
    del z, st
    torch.cuda.empty_cache()
    return launches, mma, numbers


def _zsp_obs(argv: list) -> tuple:
    """``python -m tpu_dist_torch.obs`` in this process: (exit code, stdout)."""
    import contextlib  # noqa: PLC0415
    import io  # noqa: PLC0415

    from tpu_dist_torch.obs.__main__ import main as obs_main  # noqa: PLC0415

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = obs_main(argv)
    return rc, out.getvalue() + err.getvalue()


# the metric of (b)'s bench records: one smoke fit, not a benchmark cell
ZSP_BENCH_METRIC = "chip_smoke_p19b_resnet18_fit_not_a_benchmark"


def _zsp_bench(d: str, log: str) -> dict:
    """(b): the fit's last epoch record as two ``bench.py``-schema records,
    each its own capture (two stamps of one measurement), and the bench
    gate over them: ``summarize --bench`` exits 0, the second capture
    against the first exits 0, a copy of the second with ``value`` halved
    exits 1, and a copy that re-emits the first's capture is STALE.
    Returns ``{command: (exit code, output)}``."""
    import socket  # noqa: PLC0415
    import uuid  # noqa: PLC0415

    with open(log) as f:
        last = [r for r in map(json.loads, f) if r["kind"] == "train_epoch"][-1]
    hardware = _smi_line()

    def record() -> dict:
        return {"metric": ZSP_BENCH_METRIC, "value": round(last["images_per_sec"], 1),
                "unit": "images/sec",
                "step_ms": round(1e3 * last["epoch_time"] / last["steps"], 2),
                "hardware": hardware, "note": "chip_smoke.py phase 19 (b): one 2-epoch fit",
                "capture": {"host": socket.gethostname(), "bench_run_id": uuid.uuid4().hex[:12],
                            "mono_s": round(time.monotonic(), 3)}}

    first, second = record(), record()
    paths = {}
    for name, rec in (("first", first), ("second", second),
                      ("halved", {**second, "value": round(second["value"] / 2, 1)}),
                      ("reemit", {**second, "capture": first["capture"]})):
        paths[name] = os.path.join(d, f"bench_{name}.jsonl")
        with open(paths[name], "w") as f:
            f.write(json.dumps(rec) + "\n")
    out = {}
    for name, argv, want in (
            ("summarize", ["summarize", paths["first"], "--bench"], 0),
            ("compare", ["compare", paths["first"], paths["second"], "--bench"], 0),
            ("halved", ["compare", paths["first"], paths["halved"], "--bench"], 1),
            ("reemit", ["compare", paths["first"], paths["reemit"], "--bench"], 2)):
        out[name] = _zsp_obs(argv)
        check(out[name][0] == want,
              f"(b) obs {argv[0]} --bench ({name}): exit {out[name][0]}, want {want}\n"
              f"{out[name][1][-2000:]}")
    check(f"{ZSP_BENCH_METRIC}.value" in out["halved"][1] and "REGRESSED" in out["halved"][1],
          f"(b) the halved value was not flagged: {out['halved'][1][-2000:]}")
    check("STALE" in out["reemit"][1] and "same capture" in out["reemit"][1],
          f"(b) the re-emitted capture was not flagged STALE: {out['reemit'][1][-2000:]}")
    return out


def _zsp_telemetry(d: str) -> dict:
    """(b): one telemetry-armed ``Trainer.fit`` and the offline tools over
    its files; returns the kernels' launches."""
    from tpu_dist_torch.metrics import tensorboard  # noqa: PLC0415

    os.makedirs(d, exist_ok=True)
    log, hb, tb, crash = (os.path.join(d, x) for x in ("run.jsonl", "hb.json", "tb", "crash"))
    cfg = TrainConfig(**ZSP_RESNET_RUN, log_file=log, heartbeat_file=hb, tensorboard_dir=tb,
                      crash_dir=crash, device=DEVICE, port=_free_port())
    counters_lib.reset()
    reset_launches()
    t = trainer_lib.Trainer(cfg)
    try:
        (_, fit_ms) = _timed(t.fit)
        nb = len(t.train_loader)
    finally:
        t.close()
    got = read_launches()
    steps = ZSP_RESNET_RUN["epochs"] * ZSP_RESNET_RUN["steps_per_epoch"]
    check(got["fused_sgd"] == steps and all(got[k] == 0 for k in MMA_KERNELS),
          f"(b) launches {got}: want {steps} of #4 (the flat shard), none of #1-#3")
    (events,) = os.listdir(tb)
    scalars = tensorboard.read_scalars(os.path.join(tb, events))
    tags = [(tag, s) for tag, s, _ in scalars]
    want_steps = [e * nb + s for e in range(ZSP_RESNET_RUN["epochs"])
                  for s in range(ZSP_RESNET_RUN["steps_per_epoch"])]
    check([s for tag, s in tags if tag == "step/loss"] == want_steps
          and all((f"train/{k}", e) in tags for k in ("loss", "acc1", "lr") for e in range(2))
          and all((f"eval/{k}", e) in tags for k in ("top1", "top5", "loss") for e in range(2))
          and all(math.isfinite(v) for _, _, v in scalars),
          f"(b) the event file holds {tags}")
    shutil.copy(log, log + ".h1")
    checks = {}
    for name, argv in (
            ("postmortem", ["postmortem", crash, d]),
            ("tail", ["tail", log, "--once", "--heartbeat", hb]),
            ("pod", ["pod", log, log + ".h1", "--trace-out", os.path.join(d, "pod.json")]),
            ("ingest", ["archive", "ingest", log, "--archive", os.path.join(d, "a.jsonl")]),
            ("ingest again", ["archive", "ingest", log, "--archive", os.path.join(d, "a.jsonl")]),
            ("trend", ["trend", os.path.join(d, "a.jsonl"), "--inject-regression"]),
            ("gate", ["compare", log, "--against-archive", os.path.join(d, "a.jsonl")])):
        rc, text = _zsp_obs(argv)
        checks[name] = (rc, text)
        check(rc == 0, f"(b) obs {name}: exit {rc}\n{text[-2000:]}")
    with open(os.path.join(crash, "postmortem.json")) as f:
        pm = {r["rank"]: r["verdict"] for r in json.load(f)["ranks"]}
    check(pm == {0: "clean"}, f"(b) obs postmortem after a clean exit: {pm}")
    check("run: clean exit" in checks["tail"][1], "(b) obs tail: the run did not end clean")
    check("pod report — 2 host(s)" in checks["pod"][1], "(b) obs pod: no 2-host report")
    check(" 1 appended" in checks["ingest"][1] and " 0 appended" in checks["ingest again"][1],
          f"(b) ingest: {checks['ingest'][1]!r}, then {checks['ingest again'][1]!r}")
    t_bench = time.perf_counter()
    bench = _zsp_bench(d, log)
    bench_s = time.perf_counter() - t_bench
    with open(log) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    _p19_say(f"(b) Trainer.fit --shard_weight_update --fused_optimizer --debug_replica_check "
             f"--tensorboard_dir --log_file --heartbeat_file --crash_dir, ResNet-18 (bench "
             f"shapes: batch "
             f"256, bf16), 1-rank NCCL group, 2 epochs of 3 steps: fit {fit_ms:.0f} ms, the "
             f"replica check passed at both epoch ends (one rank: one copy); launches {got}; "
             f"postmortem rank 0 clean; {len(scalars)} scalars in the event file ({len({t for t, _ in tags})} tags, "
             f"step/loss at {want_steps}); history kinds {sorted(set(kinds))}; obs tail "
             f"--once, pod (2 hosts), archive ingest (1 then 0 appended), trend "
             f"--inject-regression and compare --against-archive all exit 0; card: "
             f"{_smi_line()}")
    _p19_say(f"(b) the bench gate over two captures of the fit's last epoch as bench.py "
             f"records ({ZSP_BENCH_METRIC}): summarize --bench exit {bench['summarize'][0]}, "
             f"compare --bench of the second capture against the first exit "
             f"{bench['compare'][0]}, with value halved exit {bench['halved'][0]}, a copy "
             f"re-emitting the first's capture exit {bench['reemit'][0]} with STALE found "
             f"{'STALE' in bench['reemit'][1]}; {bench_s:.2f} s; card: {_smi_line()}")
    return got


def phase_zero1_sp(work: str) -> tuple:
    """Phase 19 (module docstring). Returns (the kernels' launches of (a)
    and (b), their tensor-core launches, the numbers for the kernels
    line)."""
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="zero1_sp_", dir=work)
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        launches, mma, numbers = _zsp_step(d)
    finally:
        if created:
            torch.distributed.destroy_process_group()
    got = _zsp_telemetry(os.path.join(d, "b"))
    launches = {k: launches.get(k, 0) + got[k] for k in KERNELS}
    shutil.rmtree(d, ignore_errors=True)
    _p19_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: {_smi_line()}")
    return launches, mma, numbers


# -- phase 20: the analysis layer ---------------------------------------------------

# (a): the families one card runs, and their executed inventory at one rank:
# (ops, elements, ring-model bytes) by kind and the payload bytes, the
# numbers tests/test_torch_shardlint.py::WORLD1 pins on the CPU's group of
# one (the data-parallel wrappers issue at a group of one; FSDP shards
# nothing at one rank, so only its metrics all-reduce is left)
ANALYSIS_WORLD1 = {
    "dp_sgd": ({"all-reduce": (2, 483, 3864)}, 3840),
    "dp_sgd_accum4": ({"all-reduce": (2, 483, 3864)}, 3840),
    "dp_bf16": ({"all-reduce": (2, 483, 3864)}, 3840),
    "dp_wire_bf16": ({"all-reduce": (2, 483, 1944)}, 1920),
    "dp_int8": ({"all-to-all": (2, 482, 488), "all-gather": (2, 482, 488),
                 "all-reduce": (1, 3, 24)}, 960),
    "dp_int8_ef": ({"all-to-all": (2, 482, 488), "all-gather": (2, 482, 488),
                    "all-reduce": (1, 3, 24)}, 960),
    "zero1_sgd": ({"reduce-scatter": (1, 480, 1920), "all-gather": (1, 480, 1920),
                   "all-reduce": (1, 3, 24)}, 3840),
    "zero1_int8": ({"all-to-all": (2, 482, 488), "all-gather": (1, 480, 1920),
                    "all-reduce": (1, 3, 24)}, 2400),
    "fsdp": ({"all-reduce": (1, 4, 32)}, 0),
    "serve_eval": ({"all-reduce": (1, 4, 32)}, 0),
}
ANALYSIS_RESNET_RUN = dict(  # bench.py:240's resnet18_cifar100 shapes, 1 epoch of 3 steps
    model="resnet18", num_classes=100, dataset="synthetic", synthetic_n=1_280,
    batch_size=256, bf16=True, sync_bn=True, lr=0.1, epochs=1, steps_per_epoch=3,
    eval_every=1, log_every=1, seed=1,
)

#: phase 20's result lines, repeated by the report
ANALYSIS_SUMMARY: list = []


def _p20_say(msg: str, keep: bool = True) -> None:
    print(f"[analysis] {msg}", flush=True)
    if keep:
        ANALYSIS_SUMMARY.append(f"[analysis] {msg}")


def _analysis_cli(argv: list) -> int:
    from tpu_dist_torch.analysis import __main__ as analysis_cli  # noqa: PLC0415

    return analysis_cli.main([*argv, "--device", DEVICE, "--nprocs", "1"])


def _analysis_reports(d: str) -> tuple:
    """(a) and (b) over the process group of one; returns the tune report's
    path and the plan."""
    from tpu_dist_torch.analysis import overlap, planner, shardlint  # noqa: PLC0415

    shard, tune, plan_path = (os.path.join(d, f"{n}.json") for n in ("shard", "tune", "plan"))
    t0 = time.perf_counter()
    rc = _analysis_cli(["shard", *(a for f in sorted(ANALYSIS_WORLD1) for a in ("--family", f)),
                        "--inject-reshard", "--out", shard])
    shard_s = time.perf_counter() - t0
    check(rc == 0, f"(a) shard exited {rc}")
    report = shardlint.load_shard_report(shard)
    got = {name: ({k: (v["ops"], v["elems"], v["bytes"]) for k, v in e["hlo"]["by_kind"].items()},
                  e["hlo"]["wire"]["payload_bytes"]) for name, e in report["families"].items()}
    check(got == ANALYSIS_WORLD1, f"(a) the executed inventory at one rank: {got}")
    check(all(e["verdict"]["agree"] and not e["violations"]
              for e in report["families"].values()), "(a) TD116/TD117 fired")
    check(report["injected_reshard_probe"]["caught"]
          and any(v["rule"] == "TD117" for v in report["injected_reshard_probe"]["violations"]),
          "(a) the injected raw all-gather was not caught")
    _p20_say(f"(a) shard over {len(got)} families on the card's 1-rank NCCL group "
             f"({report['device_kind']}): exit 0, TD116/TD117 clean, every inventory the CPU "
             f"tests' one-rank pin, the injected raw all-gather caught "
             f"({len(report['injected_reshard_probe']['violations'])} violation(s)); "
             f"{shard_s:.1f} s")
    t0 = time.perf_counter()
    rc = _analysis_cli(["tune-overlap", "--inject-payload", "--out", tune])
    check(rc == 0, f"(b) tune-overlap exited {rc}")
    rc = _analysis_cli(["plan", "--from-report", shard, "--tune-report", tune,
                        "--inject-miscost", "--out", plan_path])
    check(rc == 0, f"(b) plan exited {rc}")
    plan_s = time.perf_counter() - t0
    tuned, plan = overlap.load_tune_report(tune), planner.load_plan_report(plan_path)
    check(tuned["counts"]["violations"] == 0 and tuned["injected_payload_probe"]["caught"],
          f"(b) tune: {tuned['counts']}")
    check(plan["verification"]["verified"] and plan["injected_miscost_probe"]["caught"],
          "(b) TD118: the plan did not verify, or the miscost was not caught")
    chosen = plan["chosen"]
    _p20_say(f"(b) tune-overlap ({tuned['objective']}): "
             + ", ".join(f"{f} {json.dumps(e['chosen']['knobs'], sort_keys=True)}"
                         for f, e in sorted(tuned["families"].items()))
             + f", the payload probe caught; plan: {plan['counts']['candidates']} candidates "
             f"[{plan['gauge_source']}], chosen {chosen['family']} predicted_step_s "
             f"{chosen['predicted_step_s']}, TD118 verified, the miscost probe caught; "
             f"{plan_s:.1f} s")
    return tune, plan


def _analysis_fit(cfg: TrainConfig) -> tuple:
    """``Trainer.fit`` of ``cfg``; returns (losses, the final state as a
    checkpoint holds it, the trainer's plan and tune records, the config
    trained, seconds)."""
    counters_lib.reset()
    t0 = time.perf_counter()
    t = trainer_lib.Trainer(cfg)
    try:
        losses = []
        inner = t.train_step

        def step(st, images, labels, lr):
            st, m = inner(st, images, labels, lr)
            losses.append(m["loss"])
            return st, m

        t.train_step = step
        t.fit()
        saved = bridge.train_state_to_flat(t.state)
    finally:
        t.close()
    return ([float(x) for x in losses], saved, t._plan, t._tune, t.cfg,
            time.perf_counter() - t0)


def phase_analysis(work: str) -> dict:
    """Phase 20 (module docstring). Returns the kernels' launches on its
    main paths (#4 in the SGD families' proxy steps and in the fits)."""
    from tpu_dist_torch.analysis import planner  # noqa: PLC0415

    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="analysis_", dir=work)
    reset_launches()
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        tune, _ = _analysis_reports(d)
    finally:
        if created:
            torch.distributed.destroy_process_group()
    auto = TrainConfig(**ANALYSIS_RESNET_RUN, auto_shard="apply", tune_report=tune,
                       device=DEVICE, port=_free_port())
    losses, saved, plan, tuned, cfg, auto_s = _analysis_fit(auto)
    family = plan["family"]
    flags = {**planner.family_train_overrides(family), **tuned["applied"]}
    check(plan["applied"] and all(getattr(cfg, k) == v for k, v in flags.items()),
          f"(c) the applied config {plan} {flags}")
    by_hand = TrainConfig(**ANALYSIS_RESNET_RUN, **flags, device=DEVICE, port=_free_port())
    losses2, saved2, _, _, _, hand_s = _analysis_fit(by_hand)
    check(len(losses) == ANALYSIS_RESNET_RUN["steps_per_epoch"]
          and all(map(math.isfinite, losses)), f"(c) losses {losses}")
    check(losses == losses2, f"(c) --auto_shard apply {losses} vs by hand {losses2}")
    check(saved.keys() == saved2.keys()
          and all(np.array_equal(saved[k], saved2[k]) for k in saved),
          "(c) the final states differ")
    launches = read_launches()
    check(launches["fused_sgd"] > 0 and all(launches[k] == 0 for k in MMA_KERNELS),
          f"(c) launches {launches}: want #4's, none of #1-#3")
    _p20_say(f"(c) Trainer.fit --auto_shard apply --tune_report, ResNet-18 (bench shapes: "
             f"batch 256, bf16, --seed 1), 1-rank NCCL group: plan "
             f"{family} (predicted_step_s {plan['predicted_step_s']}, {plan['gauge_source']}, "
             f"{plan['n_candidates']} candidates), flags {flags}, knobs applied "
             f"{tuned['applied']} ({tuned['family']}); losses "
             f"{[round(x, 4) for x in losses]} bit for bit with the flags set by hand, the "
             f"final state too; {auto_s:.1f} s with the plan, {hand_s:.1f} s by hand")
    shutil.rmtree(d, ignore_errors=True)
    _p20_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: {_smi_line()}")
    return launches


# -- phase 21: the lint, the audit cases and the no-op probes ---------------------------

#: phase 21's result lines, repeated by the report
AUDIT_SUMMARY: list = []
AUDIT_FUSED_STEPS = 5  # > train/epoch.py's WARMUP_STEPS: 3 eager steps, a capture, 2 replays


def _p21_say(msg: str) -> None:
    print(f"[audit] {msg}", flush=True)
    AUDIT_SUMMARY.append(f"[audit] {msg}")


def _audit_lint() -> None:
    """(a) The lint of the package, its suppressed findings by rule."""
    import collections  # noqa: PLC0415

    from tpu_dist_torch.analysis import baseline as baseline_lib  # noqa: PLC0415
    from tpu_dist_torch.analysis import lint as lint_lib  # noqa: PLC0415

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    found = lint_lib.lint_paths([os.path.join(root, "tpu_dist_torch")], root=root)
    new, stale = baseline_lib.apply(found, baseline_lib.load(baseline_lib.DEFAULT_BASELINE))
    lint_s = time.perf_counter() - t0
    check(not new and not stale, f"(a) lint: {[v.format_text() for v in new]}, stale {stale}")
    held: collections.Counter = collections.Counter()
    files = 0
    for path in pathlib.Path(root, "tpu_dist_torch").rglob("*.py"):
        files += 1
        src = path.read_text()
        one = lint_lib._FileLint(ast.parse(src), src.splitlines(), os.path.relpath(path, root))
        held.update(v.rule for v in one.run() if one.suppressed(v))
    _p21_say(f"(a) lint of tpu_dist_torch ({files} files): 0 new findings, 0 baseline entries, "
             f"{lint_s:.2f} s; inline suppressions hold {sum(held.values())} findings: "
             f"{dict(sorted(held.items()))}")


def _audit_cases() -> None:
    """(b) Every case on the card, the captured epoch, the planted host read."""
    from tpu_dist_torch.analysis import step_audit  # noqa: PLC0415
    from tpu_dist_torch.train.epoch import make_fused_epoch  # noqa: PLC0415
    from tpu_dist_torch.train.optim import SGD  # noqa: PLC0415
    from tpu_dist_torch.train.state import TrainState  # noqa: PLC0415

    t0 = time.perf_counter()
    report, vs = {}, []
    for name in step_audit.registered_cases():
        counts, case_vs = step_audit.audit_case(name, DEVICE)
        report[name] = counts
        vs.extend(case_vs)
        want = 2 if name.startswith("fused_") else 1  # a step's one, 2 steps an epoch
        check(counts["launches"] == {"fused_sgd.launches": want},
              f"(b) {name}: launches {counts['launches']}, want {want} of #4")
        # the executed side on NCCL: one c10d op a call, as on gloo (the tests' pin)
        check(sum(counts["executed"].values()) == sum(counts["collectives"].values()),
              f"(b) {name}: executed {counts['executed']} for calls {counts['collectives']}")
    vs.extend(step_audit.wire_ratio_violations(report))
    check(not vs, f"(b) {[v.format_text() for v in vs]}")
    cases_s = time.perf_counter() - t0
    pay = {n: report[n]["wire"]["payload_bytes"] for n in ("dp_sgd", "dp_wire_bf16", "dp_int8")}

    # a fused epoch long enough to capture: its replays are booked per replay
    model = step_audit._AuditMLP(DEVICE)
    opt = SGD(momentum=0.9, weight_decay=1e-4, fused=True)
    state = TrainState.create(model, opt)
    epoch = make_fused_epoch(opt, batch_per_device=4, sync_bn=False, compute_dtype=torch.float32,
                             grad_compression="none")
    n = 4 * AUDIT_FUSED_STEPS
    images = torch.randint(0, 256, (n, 2, 2, 3), dtype=torch.uint8, device=DEVICE)
    labels = torch.randint(0, 16, (n,), device=DEVICE)
    epoch.prepare(state, images, labels)  # the static buffers, as the cases' setup
    _, trace = step_audit.traced(epoch, state, images, labels, 0.1, 0)
    counts = step_audit._counts(trace)
    check(epoch._loop.graph is not None, "(b) the 5-step fused epoch captured no graph")
    check(counts["collectives"] == {"psum": 2 * AUDIT_FUSED_STEPS}
          and counts["launches"] == {"fused_sgd.launches": AUDIT_FUSED_STEPS}
          and counts["transfers"] == 0,
          f"(b) the captured epoch under a trace: {counts}")

    fn, args, budget = step_audit.case_budget("dp_sgd", DEVICE)

    def host_read(*a):
        out = fn(*a)
        out[1]["loss"].cpu()  # a planted device-to-host copy inside the step
        return out

    _, trace = step_audit.traced(host_read, *args)
    planted = step_audit._compare("dp_sgd", step_audit._counts(trace), budget)
    check([v.rule for v in planted] == ["TD102"], f"(b) the planted .cpu(): {planted}")
    _p21_say(f"(b) {len(report)} audit cases on the card: TD101-TD104 clean, #4 launched once a "
             f"step (twice a fused epoch) in every case, one NCCL c10d op a call (dp_int8: "
             f"{report['dp_int8']['executed']}); payload bytes a step dp_sgd "
             f"{pay['dp_sgd']}, dp_wire_bf16 {pay['dp_wire_bf16']}, dp_int8 {pay['dp_int8']}; "
             f"{cases_s:.2f} s; a {AUDIT_FUSED_STEPS}-step fused epoch (3 eager, capture, 2 "
             f"replays) booked {counts['collectives']} and {counts['launches']}, 0 host reads; "
             f"a planted .cpu() caught ({planted[0].rule})")


def _audit_probes() -> None:
    """(c) Every probe on the card, and a planted leak caught."""
    from tpu_dist_torch.analysis import noop_probes, step_audit  # noqa: PLC0415
    from tpu_dist_torch.resilience import faults  # noqa: PLC0415

    times = {}
    for name, probe in noop_probes.PROBES:
        t0 = time.perf_counter()
        vs = probe(DEVICE)
        times[name] = round(time.perf_counter() - t0, 2)
        check(not vs, f"(c) {name}: {[v.format_text() for v in vs]}")

    real_setup = step_audit._dp_setup

    def leaky_setup(device=None, **kw):
        fn, args = real_setup(device, **kw)
        leaf = [torch.zeros(8, device=DEVICE) for _ in range(3)]

        def step(*a):
            out = fn(*a)
            if faults.active() is not None:  # an injection point inside the step
                fs.fused_sgd([leaf[0]], [leaf[1]], [leaf[2]], 0.1)
            return out

        return step, args

    noop_probes._dp_setup = leaky_setup
    try:
        leak = noop_probes.fault_noop_violations(DEVICE)
    finally:
        noop_probes._dp_setup = real_setup
    check([v.rule for v in leak] == ["TD105"], f"(c) the planted leak: {leak}")
    _p21_say(f"(c) {len(times)} no-op probes on the card, clean; seconds {times}; a fault plan "
             f"that launches one extra fused SGD kernel inside the step caught "
             f"({leak[0].rule}, through the kernel's launch count)")


def phase_audit(work: str) -> dict:
    """Phase 21 (module docstring). Returns the kernels' launches on its
    main paths (#4 in every traced step)."""
    from tpu_dist_torch.analysis import __main__ as analysis_cli  # noqa: PLC0415

    del work
    t0 = time.perf_counter()
    reset_launches()
    _, created = mesh_lib.initialize_distributed(
        DEVICE, world_size=1, rank=0, master_addr="127.0.0.1", master_port=_free_port())
    try:
        _audit_lint()
        _audit_cases()
        _audit_probes()
        t1 = time.perf_counter()
        rc = analysis_cli.main(["--device", DEVICE, "--nprocs", "1"])
        check(rc == 0, f"(d) python -m tpu_dist_torch.analysis exited {rc}")
        _p21_say(f"(d) python -m tpu_dist_torch.analysis (lint and audit, in process on the "
                 f"group): exit 0, {time.perf_counter() - t1:.1f} s")
    finally:
        if created:
            torch.distributed.destroy_process_group()
    launches = read_launches()
    check(launches["fused_sgd"] > 0 and all(launches[k] == 0 for k in MMA_KERNELS),
          f"launches {launches}: want #4's, none of #1-#3")
    _p21_say(f"phase: {time.perf_counter() - t0:.1f} s, launches {launches}; card: {_smi_line()}")
    return launches


# -- main --------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke run needs one "
              "card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _phases(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phases(work: str) -> int:
    phase_build()
    measured = phase_kernels()
    for name, numbers in phase_kernels_train().items():
        measured.setdefault(name, {}).update(numbers)
    served = phase_serve(work)
    trained, trained_mma = phase_train({
        "flash_attention_fwd": measured["flash_attention_fwd"]["ms_train_shape"],
        **{name: measured[name]["ms"] for name in PER_STEP if name != "flash_attention_fwd"},
    })
    resnet_launches, resnet_sgd = phase_train_resnet()
    optim_launches = phase_optim(work)
    replicas = phase_supervised(work)
    forensics = phase_forensics(work)
    elastic = phase_elastic(work)
    supervision = phase_supervision(work)
    tenancy = phase_tenancy(work)
    health = phase_health(work)
    memory = phase_memory(work)
    seq, seq_mma, seq_numbers = phase_seq(work)
    for name, numbers in seq_numbers.items():
        measured[name].update(numbers)
    mp, mp_mma, mp_numbers = phase_mp(work)
    for name, numbers in mp_numbers.items():
        measured[name].update(numbers)
    pp, pp_mma, pp_numbers = phase_pp(work)
    for name, numbers in pp_numbers.items():
        measured[name].update(numbers)
    fsdp = phase_fsdp(work)
    zsp, zsp_mma, zsp_numbers = phase_zero1_sp(work)
    for name, numbers in zsp_numbers.items():
        measured[name].update(numbers)
    analysis = phase_analysis(work)
    audit = phase_audit(work)
    measured["fused_sgd"].update(resnet_sgd)
    for model, (hits, misses) in PLAN_COUNTS.items():
        measured["fused_sgd"].update({f"plan_hits_{model}": hits, f"plan_misses_{model}": misses})
    launches = {name: served[name] + trained[name] + resnet_launches[name]
                + optim_launches[name] + replicas[name] + forensics[name] + elastic[name]
                + supervision[name] + tenancy[name] + health[name] + memory[name] + seq[name]
                + mp[name] + pp[name] + fsdp[name] + zsp[name] + analysis[name] + audit[name]
                for name in KERNELS}
    for name in MMA_KERNELS:  # serving's are all f32 (checked there); phase 7's bf16
        measured[name]["launches_tensor_core"] = (trained_mma[name] + optim_launches[name]
                                                  + seq_mma[name] + mp_mma[name] + pp_mma[name]
                                                  + zsp_mma[name])
    print("[summary] phase 11, elastic supervision, again:")
    for msg in SUP_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 12, goodput, the hub and the tenancy day, again:")
    for msg in GOODPUT_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 13, the health chain and the profiler, again:")
    for msg in HEALTH_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 14, the memory ledger, the cost model and the trace, again:")
    for msg in MEMORY_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 15, sequence parallelism, again:")
    for msg in SEQ_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 16, tensor and expert parallelism, again:")
    for msg in MP_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 17, pipeline parallelism, again:")
    for msg in PP_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 18, the sharded checkpoint format and FSDP, again:")
    for msg in FSDP_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 19, ZeRO-1 under the seq axis and the telemetry, again:")
    for msg in ZSP_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 20, the analysis layer, again:")
    for msg in ANALYSIS_SUMMARY:
        print(f"[summary] {msg}")
    print("[summary] phase 21, the lint, the audit cases and the no-op probes, again:")
    for msg in AUDIT_SUMMARY:
        print(f"[summary] {msg}")
    print(_smi_line())
    kernels = [
        {"name": name, **KERNELS[name], "launches": launches[name], **measured[name]}
        for name in KERNELS
    ]
    for k in kernels:
        check(all(isinstance(k[key], (int, float)) and math.isfinite(k[key])
                  for key in ("max_abs_err", "ms", "host_us", "plain_ms", "bound_ms",
                              "library_ms", "library_host_us")),
              f"{k['name']}: a measurement is missing")
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
